"""Multi-process mosaic worker (spawned by test_multiprocess.py).

Each process owns 2 virtual CPU devices of a 2-process x 2-device global
mesh, encodes the SAME deterministic raster through MosaicEncoder (tiles
sharded over all 4 devices, payload bytes crossing the process boundary
via process_allgather), and process 0 writes the container bytes.

Usage: python mp_worker.py <coordinator_port> <num_procs> <proc_id> <outfile>
"""
import os
import sys

port, num_procs, pid, outfile = (sys.argv[1], int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])

os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# gloo collectives make the CPU backend form a true multi-process cluster,
# 2 local devices per process
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.config.update("jax_num_cpu_devices", 2)
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}",
    num_processes=num_procs,
    process_id=pid,
)

import numpy as np  # noqa: E402

from lerc_tpu.parallel.sharding import MosaicEncoder, make_mesh  # noqa: E402

assert jax.process_count() == num_procs, jax.process_count()
assert len(jax.devices()) == 2 * num_procs, len(jax.devices())

# deterministic raster, identical in every process
h = w = 96
x, y = np.meshgrid(np.linspace(0, 9, w), np.linspace(0, 7, h))
rng = np.random.default_rng(11)
data = (np.sin(x) * np.cos(y) * 400 + 0.5 * rng.standard_normal((h, w))
        ).astype(np.float32)[:, :, None]
mask = np.ones((h, w), bool)
mask[10:30, 20:70] = False

mesh = make_mesh()  # all 4 global devices
enc = MosaicEncoder(mesh, 32, 32, np.float32, n_depth=1)
blob = enc.encode(data, mask, 0.001)

if jax.process_index() == 0:
    with open(outfile, "wb") as f:
        f.write(blob)
jax.distributed.shutdown()
