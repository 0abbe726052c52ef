"""Randomized differential soak: device decode vs the reference library.

Random (shape, dtype, depth, mask, maxZError, texture) configs are
reference-encoded and decoded three ways -- reference C++, host codec,
device codec -- and any valid-pixel disagreement stops the run with the
blob saved to /tmp/soak_bad.npy. This harness found two real bugs in
round 3: softfloat add(0,0) emitting the min-normal, and the masked
depth>1 Huffman live grid missing its group padding.

  python tools/soak_differential.py [seed] [seconds]
"""
import sys, time
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")  # oracle soak: CPU unless asked
import numpy as np
from tests import oracle
from lerc_tpu.codec import device_codec
from lerc_tpu.codec.orchestrator import decode_blob

rng = np.random.default_rng(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
DTYPES = [np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32, np.float32, np.float64]
t_end = time.time() + float(sys.argv[2]) if len(sys.argv) > 2 else time.time() + 1200
n_cases = 0
while time.time() < t_end:
    h = int(rng.integers(16, 200)); w = int(rng.integers(16, 200))
    d = int(rng.choice([1, 1, 1, 2, 3, 5]))
    dt = DTYPES[int(rng.integers(0, 8))]
    kind = int(rng.integers(0, 4))
    x, y = np.meshgrid(np.linspace(0, rng.uniform(1, 12), w), np.linspace(0, rng.uniform(1, 9), h))
    base = np.sin(x)[:, :, None] * np.cos(y)[:, :, None] * rng.uniform(1, 500) + rng.uniform(-100, 100)
    if kind == 0:
        data = base + rng.normal(0, rng.uniform(0, 2), (h, w, 1))
    elif kind == 1:
        data = np.cumsum(rng.integers(-2, 3, (h, w, 1)), axis=1).astype(np.float64)
    elif kind == 2:
        data = np.floor(base * 4) / 4
    else:
        data = rng.normal(0, 50, (h, w, 1))
    data = np.broadcast_to(data, (h, w, d)) + np.arange(d) * rng.uniform(0, 5)
    if np.issubdtype(dt, np.integer):
        info = np.iinfo(dt)
        data = np.clip(np.round(data), info.min, info.max).astype(dt)
        mze = float(rng.choice([0.0, 0.5, 1.0, 2.0]))
    else:
        data = data.astype(dt)
        mze = float(rng.choice([0.0, 0.001, 0.01, 0.5]))
    mask = None
    if rng.random() < 0.5:
        mask = (rng.random((h, w)) > rng.uniform(0.02, 0.6)).astype(np.uint8)
        if mask.sum() == 0: mask[0, 0] = 1
        data = (data * mask[:, :, None].astype(dt)).astype(dt)
    data = np.ascontiguousarray(data)
    try:
        blob = oracle.encode(data, d, w, h, 1, mask, mze)
    except RuntimeError:
        continue
    n_cases += 1
    if n_cases % 40 == 0:
        jax.clear_caches()
    ref, refm, _, _ = oracle.decode(blob)
    host = decode_blob(blob)
    m = refm[0].astype(bool) if refm is not None else np.ones((h, w), bool)
    assert np.array_equal(host.data[0][m], ref[0][m]), ("HOST-MISMATCH", h, w, d, dt, mze, kind)
    try:
        dev = device_codec.decode_band_device(np.frombuffer(blob, np.uint8))
    except Exception as e:
        print("DEVICE-RAISED", h, w, d, dt.__name__, mze, kind, repr(e), flush=True)
        np.save("/tmp/soak_bad.npy", np.frombuffer(blob, np.uint8)); raise
    if dev is None:
        continue
    got = np.asarray(dev.data)
    # r4: every device decode path is bit-exact vs the reference (the f32
    # lossy dequant runs the double ScaleBack through softfloat), so the
    # old float 1-ulp tolerance is gone
    okv = np.array_equal(got[m], ref[0][m])
    if not okv:
        print("DEVICE-MISMATCH", h, w, d, dt.__name__, mze, kind, flush=True)
        np.save("/tmp/soak_bad.npy", np.frombuffer(blob, np.uint8))
        raise SystemExit(1)
print(f"soak clean: {n_cases} randomized configs device==reference")
