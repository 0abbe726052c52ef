"""Randomized encode-direction soak: OUR device encoder vs the reference.

Random configs encode through encode_band_device and must (a) be
ACCEPTED by the reference C++ decoder (checksum + integrity bits), (b)
reproduce the exact mask, (c) respect the effective maxZError bound, and
(d) decode identically through our host decoder. Any failure saves the
blob to /tmp/soak_enc_bad.npy and stops.

  python tools/soak_encode.py [seed] [seconds]
"""
import sys, time, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")  # oracle soak: CPU unless asked
import numpy as np
from tests import oracle
from lerc_tpu.codec import device_codec
from lerc_tpu.codec.orchestrator import decode_blob

rng = np.random.default_rng(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
DTYPES = [np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32, np.float32, np.float64]
t_end = time.time() + (float(sys.argv[2]) if len(sys.argv) > 2 else 1200)
n_cases = 0
while time.time() < t_end:
    h = int(rng.integers(9, 180)); w = int(rng.integers(9, 180))
    d = int(rng.choice([1, 1, 1, 2, 3, 4]))
    dt = DTYPES[int(rng.integers(0, 8))]
    kind = int(rng.integers(0, 5))
    x, y = np.meshgrid(np.linspace(0, rng.uniform(1, 12), w), np.linspace(0, rng.uniform(1, 9), h))
    base = np.sin(x)[:, :, None] * np.cos(y)[:, :, None] * rng.uniform(1, 500) + rng.uniform(-100, 100)
    if kind == 0:
        data = base + rng.normal(0, rng.uniform(0, 2), (h, w, 1))
    elif kind == 1:
        data = np.cumsum(rng.integers(-2, 3, (h, w, 1)), axis=1).astype(np.float64)
    elif kind == 2:
        data = np.floor(base * 4) / 4
    elif kind == 3:
        data = rng.normal(0, 50, (h, w, 1))
    else:
        data = np.round(base / 50) * 50  # few distinct values -> LUT blocks
    data = np.broadcast_to(data, (h, w, d)).copy() + np.arange(d) * rng.uniform(0, 5)
    if np.issubdtype(dt, np.integer):
        info = np.iinfo(dt)
        data = np.clip(np.round(data), info.min, info.max).astype(dt)
        mze = float(rng.choice([0.0, 0.5, 1.0, 2.0]))
    else:
        data = data.astype(dt)
        mze = float(rng.choice([0.0, 0.001, 0.01, 0.5]))
    mask = None
    if rng.random() < 0.5:
        mask = rng.random((h, w)) > rng.uniform(0.02, 0.6)
        if mask.sum() == 0: mask[0, 0] = True
        data = (data * mask[:, :, None].astype(dt)).astype(dt)
    data = np.ascontiguousarray(data)
    try:
        blob = device_codec.encode_band_device(data, mask, mze)
    except Exception as e:
        print("ENCODE-RAISED", h, w, d, dt.__name__, mze, kind, repr(e), flush=True)
        raise
    n_cases += 1
    if n_cases % 40 == 0:
        jax.clear_caches()
    m = mask if mask is not None else np.ones((h, w), bool)
    eff = mze if not np.issubdtype(dt, np.integer) else max(0.5, np.floor(mze))
    tol = 0 if (np.issubdtype(dt, np.integer) and eff <= 0.5) else eff * 1.1
    try:
        ref, refm, _, _ = oracle.decode(blob)
    except Exception as e:
        print("REFERENCE-REJECTED", h, w, d, dt.__name__, mze, kind, repr(e), flush=True)
        np.save("/tmp/soak_enc_bad.npy", np.frombuffer(blob, np.uint8)); raise
    if refm is not None:
        got_m = refm[0].astype(bool)
        if not np.array_equal(got_m, m):
            print("MASK-MISMATCH", h, w, d, dt.__name__, mze, kind, flush=True)
            np.save("/tmp/soak_enc_bad.npy", np.frombuffer(blob, np.uint8)); raise SystemExit(1)
    err = np.abs(ref[0].astype(np.float64) - data.astype(np.float64))[m].max() if m.any() else 0.0
    if err > tol:
        print("ERROR-BOUND", h, w, d, dt.__name__, mze, kind, "err", err, flush=True)
        np.save("/tmp/soak_enc_bad.npy", np.frombuffer(blob, np.uint8)); raise SystemExit(1)
    # our host decoder agrees with the reference on our own wire
    host = decode_blob(blob)
    if not np.array_equal(host.data[0][m], ref[0][m]):
        print("HOST-REF-DISAGREE", h, w, d, dt.__name__, mze, kind, flush=True)
        np.save("/tmp/soak_enc_bad.npy", np.frombuffer(blob, np.uint8)); raise SystemExit(1)
print(f"encode soak clean: {n_cases} randomized configs accepted by the reference")
