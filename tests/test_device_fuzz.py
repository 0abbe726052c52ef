"""Device-encoder fuzz matrix: every blob the device encoder can produce
must decode bit-exactly (lossless) or within maxZError*1.1 (lossy, the
reference's own ENCODE_VERIFY tolerance) through BOTH our host decoder and
the reference C++ library. The Fletcher32 checksum plus per-block
integrity bits make reference acceptance a strong wire check."""
import numpy as np
import pytest

from lerc_tpu.codec.device_codec import encode_band_device, supports_encode
from lerc_tpu.codec.orchestrator import decode_blob
from lerc_tpu.constants import NUMPY_TO_DT

from . import oracle

RNG = np.random.default_rng(1234)

DTYPES = [np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32, np.float32]


def _data(dtype, h, w, d, style):
    if style == "smooth":
        x = np.linspace(0, 6, w)[None, :, None]
        y = np.linspace(0, 4, h)[:, None, None]
        z = 120 * np.sin(x) * np.cos(y) + 130 + RNG.normal(0, 0.5, (h, w, d))
    elif style == "noise":
        z = RNG.normal(100, 60, (h, w, d))
    elif style == "segmented":
        classes = np.array([3, 40, 90, 200, 250])
        patch = RNG.integers(0, 5, (h // 10 + 1, w // 10 + 1))
        z = classes[np.repeat(np.repeat(patch, 10, 0), 10, 1)][:h, :w, None]
        z = np.broadcast_to(z, (h, w, d)).copy()
    else:  # const
        z = np.full((h, w, d), 42.0)
    if np.dtype(dtype).kind in "iu":
        info = np.iinfo(dtype)
        return np.clip(np.round(z), info.min, min(info.max, 250)).astype(dtype)
    return z.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("style", ["smooth", "noise", "segmented", "const"])
@pytest.mark.parametrize("mze,masked", [(0.0, False), (0.01, False), (1.0, True)])
def test_device_encoder_fuzz(dtype, style, mze, masked):
    h, w, d = 72, 56, 1
    dt = NUMPY_TO_DT[np.dtype(dtype)]
    mask = None
    if masked:
        mask = RNG.random((h, w)) > 0.3
    all_valid = mask is None
    if not supports_encode(dt, mze, d, all_valid=all_valid):
        pytest.skip("config routes to host encoder")
    data = _data(dtype, h, w, d, style)
    blob = encode_band_device(data, mask, mze)

    eff_mze = mze
    if np.dtype(dtype).kind in "iu":
        eff_mze = max(0.5, np.floor(mze))
        lossless = eff_mze == 0.5
    else:
        lossless = mze == 0.0
    limit = 0 if lossless else eff_mze * 1.1

    res = decode_blob(blob)
    m = mask if mask is not None else np.ones((h, w), bool)
    np.testing.assert_array_equal(res.masks[0], m)
    err = np.abs(res.data[0, :, :, 0].astype(np.float64)
                 - data[:, :, 0].astype(np.float64))[m].max() if m.any() else 0
    assert err <= limit, (err, limit)

    if oracle.available():
        ref = oracle.decode(blob)[0].reshape(h, w)
        np.testing.assert_array_equal(ref[m], res.data[0, :, :, 0][m])


@pytest.mark.parametrize("dims", [(8, 8), (8, 16), (48, 8), (71, 73), (9, 257)])
def test_device_encoder_odd_shapes(dims):
    h, w = dims
    data = _data(np.float32, h, w, 1, "smooth")
    blob = encode_band_device(data, None, 0.005)
    res = decode_blob(blob)
    err = np.abs(res.data[0, :, :, 0].astype(np.float64) - data[:, :, 0]).max()
    assert err <= 0.005 * 1.1
    if oracle.available():
        ref = oracle.decode(blob)[0].reshape(h, w)
        np.testing.assert_array_equal(ref, res.data[0, :, :, 0])


@pytest.mark.parametrize("d", [2, 5])
def test_device_encoder_depth(d):
    data = _data(np.float32, 40, 48, d, "smooth")
    blob = encode_band_device(data, None, 0.01)
    res = decode_blob(blob)
    err = np.abs(res.data[0].astype(np.float64) - data.astype(np.float64)).max()
    assert err <= 0.011
    if oracle.available():
        ref = oracle.decode(blob)[0].reshape(40, 48, d)
        np.testing.assert_array_equal(ref, res.data[0])


def test_device_encode_verify_flag():
    data = _data(np.float32, 48, 56, 1, "smooth")
    blob = encode_band_device(data, None, 0.01, verify=True)
    assert len(blob) > 0


@pytest.mark.parametrize("kind", ["truncate", "flip_payload", "flip_header",
                                  "short_header", "empty"])
def test_device_decode_hardened_against_corruption(kind):
    """decode_band_device / decode_blob must reject corrupt blobs with
    ValueError (or route to host which rejects) -- never crash or return
    silently wrong pixels (checksum + bounds checks, like the reference's
    hardened decoder, Lerc_c_api.h:77-87)."""
    from lerc_tpu.codec.device_codec import decode_band_device

    data = _data(np.float32, 64, 64, 1, "smooth")
    blob = bytearray(encode_band_device(data, None, 0.01))
    if kind == "truncate":
        bad = bytes(blob[: len(blob) // 2])
    elif kind == "flip_payload":
        blob[-20] ^= 0xFF
        bad = bytes(blob)
    elif kind == "flip_header":
        blob[30] ^= 0x55
        bad = bytes(blob)
    elif kind == "short_header":
        bad = bytes(blob[:40])
    else:
        bad = b""
    with pytest.raises(ValueError):
        out = decode_band_device(bad)
        if out is None:  # device routing declined: host must reject too
            decode_blob(bad)


def test_differential_soak_short():
    """A bounded slice of tools/soak_differential.py (the randomized
    device-vs-reference harness that caught the softfloat 0+0 and masked
    depth-Huffman group-padding bugs): ~60 s of random configs."""
    import pathlib
    import subprocess
    import sys

    if not oracle.available():
        pytest.skip("needs the reference library (ref_build/libLerc.so)")
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "tools" / "soak_differential.py"), "7", "60"],
        capture_output=True, text=True, timeout=600, cwd=root,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, (out.stdout[-1500:], out.stderr[-1500:])
    assert "soak clean" in out.stdout


def test_diff_flag_mutation_differential():
    """Decoder-only surface: no compliant encoder emits depth-diff for
    FLOAT/DOUBLE (Lerc2.cpp:1495 gates bTryDiffEnc on int lossless), but
    the reference DECODER accepts it for every dtype (ReadTile's bDiff
    branches). Force it: set comprFlag bit 2 (the diff bit) on early
    stream bytes of nDepth=3 float32/float64 blobs, re-fix the Fletcher32,
    and require the reference, host, and device decoders to agree
    BIT-FOR-BIT on every mutant all three accept -- this walks the f32
    softfloat diff scan and the r4 f64 diff scan with real wire bytes."""
    from lerc_tpu.codec import fletcher32, header as hdr
    from lerc_tpu.codec.device_codec import decode_band_device
    from lerc_tpu.codec.orchestrator import decode_blob
    from lerc_tpu import native

    if not oracle.available():
        pytest.skip("reference lib not built")

    rng = np.random.default_rng(21)
    h, w, d = 32, 40, 3
    base = (400 * np.sin(np.linspace(0, 6, w))[None, :, None]
            * np.cos(np.linspace(0, 4, h))[:, None, None])
    data = np.ascontiguousarray(
        base + np.cumsum(rng.standard_normal((h, w, d)), axis=2))

    nbv, nbh = h // 8, w // 8
    cnts = np.full(nbv * nbh, 64, np.int32)
    j0s = ((np.arange(nbv * nbh) % nbh) * 8).astype(np.int32)
    checked = agreed = diff_hits = 0
    for dt in (np.float32, np.float64):
        blob = oracle.encode(data.astype(dt), d, w, h, 1, None, 0.01)
        head, pos = hdr.read_header(memoryview(blob))
        skip = hdr.checksum_skip(head.version)
        # stream area: mask-length word + ranges + the one-sweep byte
        body0 = pos + 4 + 2 * d * np.dtype(dt).itemsize + 1
        for p in range(body0, min(body0 + 400, len(blob))):
            if blob[p] & 4:
                continue
            buf = bytearray(blob)
            buf[p] |= 4
            cs = fletcher32.fletcher32(bytes(buf[skip:head.blob_size]))
            buf[10:14] = int(cs).to_bytes(4, "little")
            mut = bytes(buf)
            try:
                ref = oracle.decode(mut)
            except Exception:
                continue  # reference rejects this mutant: nothing to compare
            checked += 1
            stream = np.frombuffer(mut, np.uint8)[body0:]
            recs, _ = native.tile_scan(stream, cnts, j0s, nbv * nbh, d,
                                       int(head.dt), head.version)
            if (recs["mode"] >= 8).any():
                diff_hits += 1
            host = decode_blob(mut)
            np.testing.assert_array_equal(
                host.data[0], ref[0].reshape(h, w, d),
                err_msg=f"host != reference at byte {p} ({dt.__name__})")
            dev = decode_band_device(np.frombuffer(mut, np.uint8))
            if dev is not None:
                np.testing.assert_array_equal(
                    dev.data, ref[0].reshape(h, w, d),
                    err_msg=f"device != reference at byte {p} ({dt.__name__})")
                agreed += 1
    # the test must actually exercise reference-ACCEPTED diff records
    # through the device softfloat diff scans (f32 narrow + f64 pairs)
    assert diff_hits >= 2 and agreed >= diff_hits, (checked, agreed, diff_hits)
