"""Exact softfloat f64 (ops/device_softf64) and the lossy-f64 tiling
device decode built on it.

The softfloat runs pure u32 integer ops, so bitwise agreement with numpy
float64 on the CPU backend carries to the GPU unchanged. The decode route
must be bit-exact vs the reference library (Lerc2.h ScaleBack: separately
rounded mul + add, then std::min clamp)."""
import numpy as np
import pytest
import jax.numpy as jnp

from lerc_tpu.ops import device_softf64 as sf
from lerc_tpu.codec.encode_orchestrator import encode_blob
from lerc_tpu.codec.device_codec import decode_band_device

from . import oracle

_DBL_MIN = 2.2250738585072014e-308


def _split(x):
    b = np.asarray(x, np.float64).view(np.uint64)
    return (b >> 32).astype(np.uint32), (b & 0xFFFFFFFF).astype(np.uint32)


def _join(h, l):
    return ((np.asarray(h, np.uint64) << 32) | np.asarray(l, np.uint64)).view(np.float64)


def test_softf64_mul_bitexact():
    rng = np.random.default_rng(0)
    for _ in range(25):
        s = float(np.abs(rng.normal()) * 10.0 ** rng.integers(-8, 8)) or 1e-3
        dec = sf.decompose_scalar(s)
        assert dec is not None
        limbs, bexp = dec
        q = np.concatenate([
            rng.integers(0, 1 << 32, 2000, dtype=np.uint32),
            np.array([0, 1, 2, 3, (1 << 31) - 1, 1 << 31, (1 << 32) - 1],
                     dtype=np.uint32)])
        ph, pl = sf.mul_u32_scalar(jnp.asarray(q), limbs, bexp)
        got = _join(np.asarray(ph), np.asarray(pl))
        want = q.astype(np.float64) * s
        np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def test_softf64_decompose_rejects_unusable():
    for bad in (0.0, -1.0, np.inf, np.nan, 5e-324, 1e-320, 8e308):
        assert sf.decompose_scalar(float(bad)) is None


def test_softf64_add_bitexact():
    rng = np.random.default_rng(1)
    n = 20000
    a = rng.normal(size=n) * 10.0 ** rng.integers(-300, 300, n)
    c = rng.normal(size=n) * 10.0 ** rng.integers(-10, 10, n)
    g = rng.normal(size=n)
    h2 = -g.copy()
    h2[::7] = 0.0
    h2[::11] = -0.0
    A = np.concatenate([a, c, g])
    B = np.concatenate([rng.normal(size=n) * 10.0 ** rng.integers(-300, 300, n),
                        -c * (1 + rng.normal(size=n) * 1e-16), h2])
    sel = (np.isfinite(A) & np.isfinite(B)
           & ((A == 0) | (np.abs(A) >= _DBL_MIN))
           & ((B == 0) | (np.abs(B) >= _DBL_MIN)))
    A, B = A[sel], B[sel]
    ah, al = _split(A)
    bh, bl = _split(B)
    rh, rl, ok = sf.add_f64(jnp.asarray(ah), jnp.asarray(al),
                            jnp.asarray(bh), jnp.asarray(bl))
    got = _join(np.asarray(rh), np.asarray(rl))
    want = A + B
    okn = np.asarray(ok)
    want_ok = np.isfinite(want) & ((want == 0) | (np.abs(want) >= _DBL_MIN))
    # where flagged ok the bits must match; a cleared flag must mean the
    # exact result really left the normal range
    np.testing.assert_array_equal(got.view(np.uint64)[okn],
                                  want.view(np.uint64)[okn])
    assert not (~okn & want_ok).any()


def test_softf64_min_matches_std_min():
    rng = np.random.default_rng(2)
    n = 30000
    z = rng.normal(size=n) * 10.0 ** rng.integers(-300, 300, n)
    m = z * (1 + rng.normal(size=n) * 1e-16)
    m[::5] = z[::5]
    m[::9] = 0.0
    z[::13] = -0.0
    zh, zl = _split(z)
    mh, ml = _split(m)
    oh, ol = sf.min_f64(jnp.asarray(zh), jnp.asarray(zl),
                        jnp.asarray(mh), jnp.asarray(ml))
    got = _join(np.asarray(oh), np.asarray(ol))
    want = np.where(m < z, m, z)  # std::min(z, zmax) bit behavior
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def _f64_cases():
    rng = np.random.default_rng(3)
    h = w = 96
    dem = np.cumsum(rng.normal(0, 2, (h, w)), axis=1).astype(np.float64)
    msk = np.ones((h, w), bool)
    msk[20:40, 10:80] = False
    msk[rng.random((h, w)) > 0.95] = False
    lut = np.repeat(np.repeat(
        rng.integers(0, 30, (12, 12)).astype(np.float64) * 7.77, 8, 0), 8, 1)
    mixed = dem.copy()
    mixed[8:16, 8:16] += rng.normal(0, 1e9, (8, 8))   # raw records inline
    dd = np.stack([dem, dem * 2 + 1], axis=-1)
    return [
        ("dem", dem, None, 0.001),
        ("coarse", dem, None, 0.5),
        ("big", dem * 1e12 + 3.14159e10, None, 1e4),
        ("tiny", dem * 1e-200, None, 1e-204),
        ("masked", dem, msk, 0.01),
        ("lut", lut, None, 0.001),
        ("mixed-raw", mixed, None, 1e-7),
        ("depth2", dd, None, 0.01),
        ("masked-depth2", dd, msk, 0.001),
    ]


@pytest.mark.parametrize("name,data,mask,mze",
                         _f64_cases(), ids=[c[0] for c in _f64_cases()])
def test_f64_tiling_device_decode_bitexact(name, data, mask, mze):
    """Lossy f64 blobs decode on the device route bit-for-bit equal to the
    reference decoder. Ref dequant: Lerc2.h:381-399."""
    if not oracle.available():
        pytest.skip("reference oracle not built")
    d4 = data[None, :, :, None] if data.ndim == 2 else data[None]
    masks = None if mask is None else mask[None]
    blob = encode_blob(d4, masks, mze)
    res = decode_band_device(blob)
    assert res is not None, "f64 tiling blob unexpectedly fell back to host"
    h, w, dep = d4.shape[1], d4.shape[2], d4.shape[3]
    ref = oracle.decode(bytes(blob))[0].reshape(h, w, dep)
    got = np.asarray(res.data).reshape(h, w, dep)
    eq = got.view(np.uint64) == ref.view(np.uint64)
    if mask is not None:
        eq = eq | ~np.broadcast_to(mask[:, :, None], eq.shape)
    assert eq.all(), f"{(~eq).sum()} bitwise mismatches vs reference"


def test_f64_extreme_invscale_falls_back():
    """maxZError outside the softfloat contract routes to the host path
    (decode_band_device returns None) and the public decode still works."""
    rng = np.random.default_rng(4)
    data = np.cumsum(rng.normal(0, 1, (32, 32)), axis=1).astype(np.float64)
    tiny = data * 1e-300
    blob = encode_blob(tiny[None, :, :, None], None, 2e-310)  # subnormal inv
    assert decode_band_device(blob) is None
    from lerc_tpu.codec.orchestrator import decode_blob
    out = decode_blob(blob)  # host path must still decode within tolerance
    assert np.abs(out.data[0, :, :, 0] - tiny).max() <= 2e-310 * 1.01


def test_add_both_zero_inputs():
    """0+0 regression (randomized differential soak): the implicit
    mantissa bit made add_f64(+-0, +-0) emit the min-normal 0x0010..0
    instead of zero. IEEE: +0 when signs differ, the common sign else."""
    import jax.numpy as jnp
    from lerc_tpu.ops import device_softf64 as sf

    def pair(x):
        lo, hi = np.frombuffer(np.float64(x).tobytes(), np.uint32)
        return jnp.asarray([np.uint32(hi)]), jnp.asarray([np.uint32(lo)])

    def val(h, l):
        return np.frombuffer(
            np.array([int(l[0]), int(h[0])], np.uint32).tobytes(), np.float64)[0]

    for a, b in [(0.0, 0.0), (-0.0, 0.0), (0.0, -0.0), (-0.0, -0.0)]:
        ah, al = pair(a)
        bh, bl = pair(b)
        oh, ol, ok = sf.add_f64(ah, al, bh, bl)
        exp = np.float64(a) + np.float64(b)
        assert bool(ok[0])
        assert np.float64(val(oh, ol)).view(np.uint64) == exp.view(np.uint64), (a, b)
