"""True multi-process distributed mosaic test.

Everything else in the suite is one process with 8 virtual devices, where
every shard is addressable and process_allgather is a no-op -- the
cross-process branch of sharding._encode_band_blobs never runs. Here two
REAL processes (2 virtual CPU devices each) form a 4-device global mesh
via jax.distributed.initialize on localhost, encode a mosaic whose tile
payloads live on both processes, and the container must be byte-identical
to a single-process encode of the same data.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _single_process_container() -> bytes:
    """The same encode as mp_worker.py, on this process's own mesh."""
    from lerc_tpu.parallel.sharding import MosaicEncoder, make_mesh

    h = w = 96
    x, y = np.meshgrid(np.linspace(0, 9, w), np.linspace(0, 7, h))
    rng = np.random.default_rng(11)
    data = (np.sin(x) * np.cos(y) * 400 + 0.5 * rng.standard_normal((h, w))
            ).astype(np.float32)[:, :, None]
    mask = np.ones((h, w), bool)
    mask[10:30, 20:70] = False
    enc = MosaicEncoder(make_mesh(4), 32, 32, np.float32, n_depth=1)
    return enc.encode(data, mask, 0.001)


def test_two_process_mosaic_byte_identical(tmp_path):
    want = _single_process_container()

    port = _free_port()
    out = tmp_path / "mp_container.bin"
    # the workers stay on the CPU through their environment, so a GPU host
    # never has two processes opening the card
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "mp_worker.py"),
             str(port), "2", str(i), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=540)
        logs.append(stdout.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i]}"
    got = out.read_bytes()
    assert got == want, (
        f"multi-process container differs: {len(got)} vs {len(want)} bytes"
    )
