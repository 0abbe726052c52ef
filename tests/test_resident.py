"""Device-resident codec tests: blobs live in HBM end to end.

Covers the fused single-jit encode (device-built header + Fletcher32), both
decode paths (scan-free via the record-offset index, and the pointer-
doubling device scan), and wire compatibility: the materialized blob must
decode bit-identically through our host decoder and the reference C++
library.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from lerc_tpu.codec.resident import FusedResidentCodec, ResidentCodec
from lerc_tpu.codec.orchestrator import decode_blob

from . import oracle


def _dem(h, w, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 8, w)[None, :, None]
    y = np.linspace(0, 5, h)[:, None, None]
    z = 900 * np.exp(-((x - 4) ** 2 + (y - 2) ** 2) / 9) + 40 * np.sin(x + y)
    z = z + 0.3 * rng.standard_normal((h, w, d))
    if np.dtype(dtype).kind in "iu":
        return np.clip(np.round(z), 0, 250).astype(dtype)
    return z.astype(dtype)


@pytest.mark.parametrize("dtype,mze", [(np.float32, 0.001), (np.uint8, 0.5),
                                       (np.int16, 0.5), (np.int32, 2.0)])
def test_fused_roundtrip_with_index(dtype, mze):
    h = w = 64
    codec = FusedResidentCodec(h, w, 1, dtype, mze)
    data = _dem(h, w, 1, dtype)
    header, stream, meta, starts = codec.encode_fast(jnp.asarray(
        data.astype(np.int32 if np.dtype(dtype).kind in "iu" else np.float32)))
    img, ok = codec.decode_fast(header, stream, starts)
    assert bool(ok), "device checksum verification failed"
    out = np.asarray(img)[:, :, 0].astype(np.float64)
    err = np.abs(out - data[:, :, 0].astype(np.float64)).max()
    if np.dtype(dtype).kind in "iu" and mze == 0.5:
        limit = 0.0
    else:
        # the reference's own bound: quantization error (<= mze) plus the
        # final (T)z cast's rounding, half an ulp at the data's magnitude
        limit = mze * 1.01 + float(np.spacing(
            np.abs(data).max().astype(np.float32))) / 2
    assert err <= limit, f"error {err} > {limit}"


def test_fused_decode_without_index_matches():
    h = w = 64
    codec = FusedResidentCodec(h, w, 1, np.float32, 0.01)
    data = _dem(h, w, 1, np.float32, seed=3)
    header, stream, meta, starts = codec.encode_fast(jnp.asarray(data))
    img_fast, ok1 = codec.decode_fast(header, stream, starts)
    img_scan, ok2 = codec.decode_fast(header, stream)
    assert bool(ok1) and bool(ok2)
    # both paths run the exact softfloat ScaleBack: bit-identical
    np.testing.assert_array_equal(np.asarray(img_fast), np.asarray(img_scan))


def test_fused_blob_is_wire_compatible():
    h = w = 72  # not a power of two; still multiple of 8
    codec = FusedResidentCodec(h, w, 1, np.float32, 0.005)
    data = _dem(h, w, 1, np.float32, seed=5)
    header, stream, meta, starts = codec.encode_fast(jnp.asarray(data))
    blob = codec.blob_to_bytes(header, stream, meta)
    res = decode_blob(blob)  # host decoder verifies Fletcher32 itself
    host = res.data[0, :, :, 0].astype(np.float64)
    dev = np.asarray(codec.decode_fast(header, stream, starts)[0])[:, :, 0]
    # device runs the same f64 ScaleBack as the host decoder: bit-exact
    np.testing.assert_array_equal(host.astype(np.float32), dev)
    assert np.abs(host - data[:, :, 0]).max() <= 0.005 * 1.01 + float(
        np.spacing(np.abs(data).max().astype(np.float32))) / 2

    if oracle.available():
        decoded = oracle.decode(blob)[0]
        np.testing.assert_array_equal(
            decoded.reshape(h, w), res.data[0, :, :, 0]
        )


def test_fused_depth3():
    h = w = 32
    codec = FusedResidentCodec(h, w, 3, np.float32, 0.01)
    data = _dem(h, w, 3, np.float32, seed=7)
    header, stream, meta, starts = codec.encode_fast(jnp.asarray(data))
    img, ok = codec.decode_fast(header, stream, starts)
    assert bool(ok)
    err = np.abs(np.asarray(img).astype(np.float64) - data).max()
    assert err <= 0.0101

    blob = codec.blob_to_bytes(header, stream, meta)
    res = decode_blob(blob)
    np.testing.assert_allclose(
        res.data[0].astype(np.float64), np.asarray(img).astype(np.float64), atol=1e-4
    )


def test_resident_unfused_roundtrip():
    h = w = 64
    codec = ResidentCodec(h, w, 1, np.float32, 0.002)
    data = _dem(h, w, 1, np.float32, seed=9)
    blob = codec.encode(jnp.asarray(data))
    img = codec.decode(blob)
    err = np.abs(np.asarray(img)[:, :, 0].astype(np.float64) - data[:, :, 0]).max()
    assert err <= 0.002 * 1.01
    # wire: host decoder accepts the materialized bytes
    res = decode_blob(blob.to_bytes())
    np.testing.assert_allclose(
        res.data[0, :, :, 0].astype(np.float64),
        np.asarray(img)[:, :, 0].astype(np.float64), atol=1e-4,
    )


def test_tampered_index_detected():
    """The record-offset acceleration index is untrusted metadata: a
    corrupted index must fail loudly, never return wrong pixels."""
    h = w = 64
    codec = FusedResidentCodec(h, w, 1, np.float32, 0.01)
    data = _dem(h, w, 1, np.float32, seed=11)
    header, stream, meta, starts = codec.encode_fast(jnp.asarray(data))
    bad = np.asarray(starts).copy()
    bad[3] += 2  # shift one record start
    img, ok = codec.decode_fast(header, stream, jnp.asarray(bad))
    assert not bool(ok), "tampered index not detected"
    # unfused path raises
    blob = codec.encode(jnp.asarray(data))
    blob.starts = jnp.asarray(bad)
    import pytest

    with pytest.raises(ValueError, match="index"):
        codec.decode(blob)


def test_nb_cap_grouped_matches_full():
    """nb_cap=16 selects the byte-aligned grouped pack/extract kernels;
    when every block fits, the wire bytes and the acceleration index must
    be identical to the uncapped kernels, and decode must agree."""
    h = w = 64
    data = _dem(h, w, 1, np.float32, seed=11)
    # 0.01 keeps every block's packed width <= 16 bits on this DEM
    full = FusedResidentCodec(h, w, 1, np.float32, 0.01)
    capped = FusedResidentCodec(h, w, 1, np.float32, 0.01, nb_cap=16)
    h0, s0, m0, st0 = full.encode_fast(jnp.asarray(data))
    h1, s1, m1, st1 = capped.encode_fast(jnp.asarray(data))
    assert int(np.asarray(m1)[2]) == 1  # fits
    np.testing.assert_array_equal(np.asarray(h0), np.asarray(h1))
    # capacities differ (the capped codec sizes its buffer for capped
    # records); the wire bytes up to the blob length must be identical
    # (streams are u32 words: compare serialized LE bytes)
    total = int(np.asarray(m0)[0])
    assert int(np.asarray(m1)[0]) == total
    assert (np.asarray(s0).tobytes()[:total]
            == np.asarray(s1).tobytes()[:total])
    np.testing.assert_array_equal(np.asarray(st0), np.asarray(st1))
    img0, ok0 = full.decode_fast(h0, s0, st0)
    img1, ok1 = capped.decode_fast(h1, s1, st1)
    assert bool(ok0) and bool(ok1)
    # the two variants extract identical uint32 values but XLA may fuse
    # the dequant multiply-add differently (FMA contraction) per graph:
    # allow 1 ulp; the wire bytes above are compared exactly
    np.testing.assert_allclose(np.asarray(img0), np.asarray(img1), rtol=2e-7)


def test_nb_cap_unfit_flags_and_fallback():
    """Blocks needing > 16 packed bits: the fused capped codec reports
    unfit (meta[2] == 0, decode ok False), and the unfused ResidentCodec
    transparently re-encodes with the full kernels."""
    h = w = 64
    rng = np.random.default_rng(5)
    # block range ~900 at maxZError 0.001 -> ~19 packed bits, not raw
    data = rng.normal(0, 150, (h, w, 1)).astype(np.float32)
    capped = FusedResidentCodec(h, w, 1, np.float32, 0.001, nb_cap=16)
    hh, ss, mm, st = capped.encode_fast(jnp.asarray(data))
    assert int(np.asarray(mm)[2]) == 0  # does not fit
    codec = ResidentCodec(h, w, 1, np.float32, 0.001, nb_cap=16)
    blob = codec.encode(jnp.asarray(data))
    out = np.asarray(codec.decode(blob))
    assert np.abs(out - data).max() <= 0.001 * 1.1
    res = decode_blob(blob.to_bytes())
    assert np.abs(res.data[0] - data).max() <= 0.001 * 1.1
    if oracle.available():
        ref = oracle.decode(blob.to_bytes())[0].reshape(h, w, 1)
        assert np.abs(ref - data).max() <= 0.001 * 1.1


def test_masked_resident_roundtrip():
    """Masked fast path: masked rasters stay on
    device end to end; wire blob carries the RLE mask and is accepted by
    the host decoder with the exact mask."""
    from lerc_tpu.codec.orchestrator import decode_blob

    h = w = 64
    rng = np.random.default_rng(21)
    data = _dem(h, w, 1, np.float32, seed=13)
    mask = np.ones((h, w), bool)
    mask[5:20, 10:50] = False
    mask[rng.random((h, w)) > 0.9] = False
    for nb_cap in (16, 0):
        codec = FusedResidentCodec(h, w, 1, np.float32, 0.01, nb_cap=nb_cap,
                                   mask=mask)
        hh, ss, mm, st = codec.encode_fast(jnp.asarray(data))
        if not int(np.asarray(mm)[2]):
            continue
        img, ok = codec.decode_fast(hh, ss, st)
        assert bool(np.asarray(ok))
        got = np.asarray(img)[:, :, 0]
        err = np.abs(got.astype(np.float64) - data[:, :, 0])[mask].max()
        assert err <= 0.011
        assert np.all(got[~mask] == 0)
        res = decode_blob(codec.blob_to_bytes(hh, ss, mm))
        np.testing.assert_array_equal(res.masks[0], mask)
        herr = np.abs(res.data[0][:, :, 0].astype(np.float64)
                      - data[:, :, 0])[mask].max()
        assert herr <= 0.011


def test_masked_resident_wrong_mask_detected():
    """A decode mask inconsistent with the stream fails the index check
    instead of producing silently wrong pixels."""
    h = w = 64
    data = _dem(h, w, 1, np.float32, seed=14)
    mask = np.ones((h, w), bool)
    mask[8:24, 8:40] = False
    enc = FusedResidentCodec(h, w, 1, np.float32, 0.01, nb_cap=16, mask=mask)
    hh, ss, mm, st = enc.encode_fast(jnp.asarray(data))
    wrong = mask.copy()
    wrong[32:40, :] = ~wrong[32:40, :]
    dec = FusedResidentCodec(h, w, 1, np.float32, 0.01, nb_cap=16, mask=wrong)
    try:
        _img, ok = dec.decode_fast(hh, ss, st)
    except ValueError:
        return  # differing mask RLE length rejected up front
    assert not bool(np.asarray(ok))


def test_masked_resident_int_lossless():
    from lerc_tpu.codec.orchestrator import decode_blob

    h = w = 64
    rng = np.random.default_rng(22)
    data = rng.integers(0, 500, (h, w, 1)).astype(np.int32)
    mask = rng.random((h, w)) > 0.25
    codec = FusedResidentCodec(h, w, 1, np.int32, 0.5, nb_cap=16, mask=mask)
    hh, ss, mm, st = codec.encode_fast(jnp.asarray(data.astype(np.int32)))
    if int(np.asarray(mm)[2]):
        img, ok = codec.decode_fast(hh, ss, st)
        assert bool(np.asarray(ok))
        got = np.asarray(img)[:, :, 0]
        np.testing.assert_array_equal(got[mask], data[:, :, 0][mask])
        res = decode_blob(codec.blob_to_bytes(hh, ss, mm))
        np.testing.assert_array_equal(res.data[0][:, :, 0][mask],
                                      data[:, :, 0][mask])


def test_masked_resident_decode_without_index():
    """A masked resident blob WITHOUT the
    record-offset index falls back to the native host scan (one stream
    download) instead of raising, and matches the indexed decode."""
    import dataclasses

    h = w = 64
    rng = np.random.default_rng(31)
    data = _dem(h, w, 1, np.float32, seed=17)
    mask = np.ones((h, w), bool)
    mask[10:30, 4:40] = False
    mask[rng.random((h, w)) > 0.85] = False
    codec = ResidentCodec(h, w, 1, np.float32, 0.004, mask=mask)
    blob = codec.encode(jnp.asarray(data))
    want = np.asarray(codec.decode(blob))
    noidx = dataclasses.replace(blob, starts=None)
    got = np.asarray(codec.decode(noidx))
    np.testing.assert_array_equal(got[mask], want[mask])
    err = np.abs(got[:, :, 0].astype(np.float64) - data[:, :, 0])[mask].max()
    assert err <= 0.004 * 1.01
