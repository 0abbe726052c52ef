"""Device (JAX/XLA) codec tests on the virtual CPU backend, cross-checked
against the reference library and the host codec. Shapes stay small to keep
XLA compile times reasonable."""
import numpy as np
import pytest

from lerc_tpu.codec.device_codec import (
    decode_band_device,
    encode_band_device,
    supports_encode,
)
from lerc_tpu.codec.lerc2_encode import BandEncoder
from lerc_tpu.codec.orchestrator import decode_blob
from lerc_tpu import native

from . import oracle

pytestmark = pytest.mark.skipif(not oracle.available(), reason="reference lib not built")

H, W = 48, 41  # includes partial edge blocks


def make(dtype, d=1, scale=100.0):
    x, y = np.meshgrid(np.linspace(0, 10, W), np.linspace(0, 8, H))
    base = np.stack([np.sin(x + i) * np.cos(y) * scale + x * y for i in range(d)], -1)
    if np.issubdtype(dtype, np.integer):
        return np.round(base).astype(dtype)
    return base.astype(dtype)


MASK = np.random.default_rng(0).random((H, W)) > 0.3


@pytest.mark.parametrize("masked", [False, True])
def test_f32_lossy(masked):
    data = make(np.float32)
    mask = MASK if masked else None
    blob = encode_band_device(data, mask, 0.001)
    ref, refm, _, _ = oracle.decode(blob)
    sel = MASK if masked else np.ones((H, W), bool)
    err = np.abs(ref[0, :, :, 0].astype(np.float64) - data[:, :, 0])[sel].max()
    assert err <= 0.001 * 1.1
    if masked:
        assert np.array_equal(refm[0].astype(bool), MASK)
    # host decoder agrees with reference
    res = decode_blob(blob)
    assert np.array_equal(res.data[0], ref[0])
    # device decoder within bound
    db = decode_band_device(blob)
    assert db is not None
    derr = np.abs(db.data[:, :, 0].astype(np.float64) - data[:, :, 0])[sel].max()
    assert derr <= 0.001 * 1.1


@pytest.mark.parametrize("dtype", [np.int16, np.uint16, np.int32, np.uint8])
def test_int_lossless_bit_exact(dtype):
    data = make(dtype)
    mze = 1.0 if dtype == np.uint8 else 0.0  # u8 lossless would route to Huffman/host
    if not supports_encode(
        __import__("lerc_tpu").constants.NUMPY_TO_DT[np.dtype(dtype)], mze, 1
    ):
        pytest.skip("host-routed config")
    blob = encode_band_device(data, MASK, mze)
    ref, _, _, _ = oracle.decode(blob)
    if mze == 0.0:
        assert np.array_equal(ref[0, :, :, 0][MASK], data[:, :, 0][MASK])
    db = decode_band_device(blob)
    assert np.array_equal(db.data, ref[0])  # integer decode is exact arithmetic


def test_depth3():
    data = make(np.float32, d=3)
    blob = encode_band_device(data, MASK, 0.01)
    ref, _, _, _ = oracle.decode(blob)
    err = np.abs(ref[0].astype(np.float64) - data)[MASK].max()
    assert err <= 0.011
    db = decode_band_device(blob)
    derr = np.abs(db.data.astype(np.float64) - ref[0].astype(np.float64))[MASK].max()
    assert derr <= 2e-4  # f32 vs f64 reconstruction slop only


def test_device_decodes_host_blobs_with_lut():
    x, y = np.meshgrid(np.linspace(0, 10, W), np.linspace(0, 8, H))
    seg = ((np.floor(x * 2) + np.floor(y * 3)) * 10).astype(np.float32)[:, :, None]
    host_blob = BandEncoder(seg, None, 0.5).encode()
    db = decode_band_device(host_blob)
    assert db is not None
    ref, _, _, _ = oracle.decode(host_blob)
    assert np.array_equal(db.data, ref[0])


def test_host_decodes_device_blobs_everywhere():
    data = make(np.float32)
    for mask in (None, MASK):
        blob = encode_band_device(data, mask, 0.05)
        res = decode_blob(blob)
        ref, _, _, _ = oracle.decode(blob)
        assert np.array_equal(res.data[0], ref[0])


def test_fallback_routing():
    # configs the device encoder refuses
    from lerc_tpu.constants import DataType

    assert supports_encode(DataType.DOUBLE, 0.1, 1)  # lossy f64 (double-single)
    assert supports_encode(DataType.DOUBLE, 0.0, 1)  # lossless f64 (fpl limb pairs)
    assert supports_encode(DataType.BYTE, 0.0, 1)  # device Huffman
    assert supports_encode(DataType.BYTE, 0.0, 1, all_valid=False)  # masked too
    assert supports_encode(DataType.FLOAT, 0.0, 1)  # device fpl lossless
    assert supports_encode(DataType.FLOAT, 0.001, 1)
    # one-sweep blobs bail to host; fpl blobs (foreign incl.) decode on
    # device via the native lengths-only scan
    noisy = np.random.default_rng(1).normal(0, 50, (H, W, 1)).astype(np.float32)
    host_blob = BandEncoder(noisy, None, 0.0).encode()
    res = decode_band_device(host_blob)
    if res is not None:  # fpl was selected: must be bit-exact
        np.testing.assert_array_equal(np.asarray(res.data)[:, :, 0], noisy[:, :, 0])


def test_device_huffman_8bit_lossless():
    """Device whole-image Huffman (8-bit lossless): blob must decode
    bit-exactly through our host decoder and the reference library, and
    actually select a Huffman mode on low-entropy data."""
    rng = np.random.default_rng(42)
    h, w = 96, 120
    # smooth image -> delta-Huffman strongly favored
    base = (128 + 60 * np.sin(np.linspace(0, 6, h))[:, None]
            * np.cos(np.linspace(0, 4, w))[None, :])
    data = np.clip(base + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8)
    data3 = data[:, :, None]

    blob = encode_band_device(data3, None, 0)
    res = decode_blob(blob)
    np.testing.assert_array_equal(res.data[0, :, :, 0], data)
    # must beat the tiling size on this data (i.e. Huffman mode chosen)
    from lerc_tpu.codec import header as hdr_mod
    hd, pos = hdr_mod.read_header(memoryview(blob))
    pos += 4  # mask section length (all valid)
    pos += 2 * hd.n_depth  # uint8 ranges
    assert blob[pos] == 0  # not one-sweep
    assert blob[pos + 1] in (1, 2), f"expected Huffman mode, got {blob[pos + 1]}"

    if oracle.available():
        ref = oracle.decode(blob)[0].reshape(h, w)
        np.testing.assert_array_equal(ref, data)

    # host encoder on the same data: sizes comparable (same mode family)
    host_blob = BandEncoder(data3, None, 0.0).encode()
    assert abs(len(host_blob) - len(blob)) < 64, (len(blob), len(host_blob))


@pytest.mark.parametrize("dtype", [np.uint8, np.int8])
def test_device_huffman_dtypes_random(dtype):
    rng = np.random.default_rng(7)
    h, w = 64, 72
    lo, hi = (0, 200) if dtype == np.uint8 else (-100, 100)
    data = rng.integers(lo, hi, (h, w, 1)).astype(dtype)
    # skewed distribution so Huffman wins over tiling
    data[data % 3 != 0] //= 2
    blob = encode_band_device(data, None, 0)
    res = decode_blob(blob)
    np.testing.assert_array_equal(res.data[0], data)
    if oracle.available():
        ref = oracle.decode(blob)[0].reshape(h, w)
        np.testing.assert_array_equal(ref, data.reshape(h, w))


def test_device_fpl_float_lossless():
    """Device fpl lossless float (v6): bit-exact through our host decoder
    and the reference library; fpl mode must actually win on smooth data."""
    rng = np.random.default_rng(5)
    h, w = 80, 96
    x = np.linspace(0, 4, w)[None, :]
    y = np.linspace(0, 3, h)[:, None]
    data = (1000 + 200 * np.sin(x) * np.cos(y)).astype(np.float32)[:, :, None]

    blob = encode_band_device(data, None, 0.0)
    res = decode_blob(blob)
    np.testing.assert_array_equal(res.data[0, :, :, 0], data[:, :, 0])

    from lerc_tpu.codec import header as hdr_mod
    hd, pos = hdr_mod.read_header(memoryview(blob))
    pos += 4 + 2 * 4 * hd.n_depth  # mask len + f32 ranges
    assert blob[pos] == 0  # not one-sweep
    assert blob[pos + 1] == 3, f"expected fpl mode 3, got {blob[pos + 1]}"

    if oracle.available():
        ref = oracle.decode(blob)[0].reshape(h, w)
        np.testing.assert_array_equal(ref, data[:, :, 0])

    # noisy data: fpl should still round-trip exactly (may pick one-sweep)
    noisy = rng.normal(0, 1, (h, w, 1)).astype(np.float32)
    blob2 = encode_band_device(noisy, None, 0.0)
    res2 = decode_blob(blob2)
    np.testing.assert_array_equal(res2.data[0, :, :, 0], noisy[:, :, 0])
    if oracle.available():
        ref2 = oracle.decode(blob2)[0].reshape(h, w)
        np.testing.assert_array_equal(ref2, noisy[:, :, 0])


def test_device_fpl_depth3():
    rng = np.random.default_rng(6)
    h, w, d = 48, 56, 3
    base = (500 + 100 * np.sin(np.linspace(0, 5, h * w * d))).astype(np.float32)
    data = (base + rng.normal(0, 0.5, h * w * d)).astype(np.float32).reshape(h, w, d)
    blob = encode_band_device(data, None, 0.0)
    res = decode_blob(blob)
    np.testing.assert_array_equal(res.data[0], data)
    if oracle.available():
        ref = oracle.decode(blob)[0].reshape(h, w, d)
        np.testing.assert_array_equal(ref, data)


def test_device_lut_blocks():
    """Device LUT block mode: segmented data (few distinct values per
    block) must select LUT blocks, decode bit-exactly everywhere, and
    compress comparably to the host encoder."""
    rng = np.random.default_rng(9)
    h, w = 96, 96
    # land-cover-like: large constant patches with a few classes
    classes = np.array([100, 2000, 35000, 41000, 52000], np.int32)
    patch = rng.integers(0, 5, (h // 12, w // 12))
    data = classes[np.repeat(np.repeat(patch, 12, 0), 12, 1)].astype(np.int32)
    data = (data + rng.integers(0, 3, (h, w))).astype(np.int32)[:, :, None]

    blob = encode_band_device(data, None, 0.5)
    res = decode_blob(blob)
    np.testing.assert_array_equal(res.data[0, :, :, 0], data[:, :, 0])
    if oracle.available():
        ref = oracle.decode(blob)[0].reshape(h, w)
        np.testing.assert_array_equal(ref, data[:, :, 0])

    host_blob = BandEncoder(data, None, 0.5).encode()
    assert len(blob) <= len(host_blob) * 1.1, (len(blob), len(host_blob))
    # verify LUT blocks were actually emitted (bit5 of a stuffer header)
    from lerc_tpu.codec import bitstuffer, header as hdr_mod
    import lerc_tpu.codec.lerc2_decode as l2d
    band = l2d.decode_band(memoryview(blob))
    # decode succeeded; now scan flags for a LUT record via the native scanner
    from lerc_tpu import native
    if native.available():
        hd, pos = hdr_mod.read_header(memoryview(blob))
        pos += 4 + 2 * 4 * hd.n_depth + 1  # mask len + i32 ranges + one-sweep flag
        stream = np.frombuffer(memoryview(blob)[pos:hd.blob_size], np.uint8)
        n_blocks = (h // 8) * (w // 8)
        cnts = np.full(n_blocks, 64, np.int32)
        j0s = ((np.arange(n_blocks) % (w // 8)) * 8).astype(np.int32)
        recs, _ = native.tile_scan(stream, cnts, j0s, n_blocks, 1, int(hd.dt), hd.version)
        assert (recs["mode"] == 4).any(), "no LUT blocks emitted"


def test_device_16x16_retrial():
    """Low-bitrate data must trigger the 16x16 micro-block retrial
    (Lerc2.cpp:333-357), halving per-block header overhead; the blob must
    decode bit-exactly through host and reference decoders and match the
    host encoder's size class."""
    rng = np.random.default_rng(3)
    h, w = 128, 192
    # binary noise (1 bit/block payload) over 2/3, constant over 1/3:
    # tiling lands under the 1.5 bpp gate and 16x16 halves block headers
    base = np.full((h, w), 100.0)
    base[:, : 2 * w // 3] += 0.6 * rng.integers(0, 2, (h, 2 * w // 3))
    data = base.astype(np.float32)[:, :, None]
    mze = 0.3

    blob = encode_band_device(data, None, mze)
    from lerc_tpu.codec import header as hdr_mod
    hd, _ = hdr_mod.read_header(memoryview(blob))
    assert hd.micro_block_size == 16, hd.micro_block_size

    res = decode_blob(blob)
    err = np.abs(res.data[0, :, :, 0].astype(np.float64) - base).max()
    assert err <= mze * 1.1
    if oracle.available():
        ref = oracle.decode(blob)[0].reshape(h, w)
        np.testing.assert_array_equal(ref, res.data[0, :, :, 0])

    host_blob = BandEncoder(data, None, mze).encode()
    hd2, _ = hdr_mod.read_header(memoryview(host_blob))
    assert hd2.micro_block_size == 16  # host picks 16 here too
    assert len(blob) <= len(host_blob) * 1.15, (len(blob), len(host_blob))


def test_device_16x16_with_mask_and_depth():
    rng = np.random.default_rng(21)
    h, w, d = 96, 112, 2
    base = (np.arange(h)[:, None, None] // 24 * 8
            + np.arange(w)[None, :, None] // 28 * 8).astype(np.float32)
    data = np.broadcast_to(base, (h, w, d)).copy()
    data[:, :, 1] += 3
    mask = rng.random((h, w)) > 0.1
    blob = encode_band_device(data, mask, 0.5)
    res = decode_blob(blob)
    err = np.abs(res.data[0].astype(np.float64) - data)[mask].max()
    assert err <= 0.55
    if oracle.available():
        ref = oracle.decode(blob)[0].reshape(h, w, d)
        np.testing.assert_array_equal(ref[mask], res.data[0][mask])


def test_device_max_z_error_auto_raise():
    """Pre-truncated float data (multiples of 0.1) must auto-raise the
    encoder's maxZError (Lerc2.cpp:1233-1339) like the host/reference do,
    while keeping the decoded values within the USER's bound."""
    rng = np.random.default_rng(31)
    h, w = 96, 104
    data = (np.round(rng.normal(50, 20, (h, w)) * 10) / 10).astype(np.float32)[:, :, None]
    blob = encode_band_device(data, None, 0.0004)
    blob_host = BandEncoder(data, None, 0.0004).encode()
    from lerc_tpu.codec import header as hdr_mod
    hd, _ = hdr_mod.read_header(memoryview(blob))
    hd2, _ = hdr_mod.read_header(memoryview(blob_host))
    assert hd.max_z_error == hd2.max_z_error > 0.0004  # raised identically
    res = decode_blob(blob)
    err = np.abs(res.data[0, :, :, 0].astype(np.float64) - data[:, :, 0]).max()
    assert err <= 0.05 * 1.1  # raised bound 0.05 (zErr 0.1 / 2)
    if oracle.available():
        ref = oracle.decode(blob)[0].reshape(h, w)
        np.testing.assert_array_equal(ref, res.data[0, :, :, 0])


def test_device_bit_plane_cut():
    """Negative maxZError / the 777 cheat code cut noisy low bit planes of
    integer data (Lerc2.cpp:1071-1229), matching the host's choice."""
    rng = np.random.default_rng(33)
    h, w = 128, 128
    signal = (np.arange(h)[:, None] * 16 + np.arange(w)[None, :] * 8)
    data = (signal + rng.integers(0, 4, (h, w))).astype(np.int32)[:, :, None]
    blob = encode_band_device(data, None, 777)
    blob_host = BandEncoder(data, None, 777).encode()
    from lerc_tpu.codec import header as hdr_mod
    hd, _ = hdr_mod.read_header(memoryview(blob))
    hd2, _ = hdr_mod.read_header(memoryview(blob_host))
    assert hd.max_z_error == hd2.max_z_error >= 0.5
    res = decode_blob(blob)
    err = np.abs(res.data[0, :, :, 0].astype(np.float64) - data[:, :, 0]).max()
    assert err <= 2 * hd.max_z_error
    if oracle.available():
        ref = oracle.decode(blob)[0].reshape(h, w)
        np.testing.assert_array_equal(ref, res.data[0, :, :, 0])


def test_device_huffman_masked():
    """Masked 8-bit lossless images now take the device Huffman path:
    compacted symbol streams with gap skipping must match the reference's
    wire semantics (bit-exact through both decoders)."""
    rng = np.random.default_rng(41)
    h, w = 96, 120
    base = (128 + 60 * np.sin(np.linspace(0, 6, h))[:, None]
            * np.cos(np.linspace(0, 4, w))[None, :])
    data = np.clip(base + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8)[:, :, None]
    mask = rng.random((h, w)) > 0.25
    blob = encode_band_device(data, mask, 0)
    res = decode_blob(blob)
    np.testing.assert_array_equal(res.masks[0], mask)
    np.testing.assert_array_equal(res.data[0, :, :, 0][mask], data[:, :, 0][mask])
    if oracle.available():
        ref = oracle.decode(blob)[0].reshape(h, w)
        np.testing.assert_array_equal(ref[mask], data[:, :, 0][mask])
    # size comparable to the host encoder on the same data
    host_blob = BandEncoder(data, mask, 0.0).encode()
    assert abs(len(blob) - len(host_blob)) < 96, (len(blob), len(host_blob))


def test_device_huffman_masked_depth2():
    rng = np.random.default_rng(43)
    h, w, d = 64, 72, 2
    data = rng.integers(100, 140, (h, w, d)).astype(np.uint8)
    mask = rng.random((h, w)) > 0.4
    blob = encode_band_device(data, mask, 0)
    res = decode_blob(blob)
    np.testing.assert_array_equal(res.data[0][mask], data[mask])
    if oracle.available():
        ref = oracle.decode(blob)[0].reshape(h, w, d)
        np.testing.assert_array_equal(ref[mask], data[mask])


@pytest.mark.parametrize("mze", [0.001, 0.5])
def test_device_f64_lossy(mze):
    """float64 lossy tiling on device (double-single arithmetic): error
    bound holds and blobs decode bit-exactly through host and reference
    decoders; sizes match the reference byte-for-byte on this data."""
    rng = np.random.default_rng(50)
    h, w = 96, 112
    x = np.linspace(0, 6, w)[None, :]
    y = np.linspace(0, 4, h)[:, None]
    data = (1e6 + 1234.5678 * np.sin(x) * np.cos(y)
            + 0.3 * rng.standard_normal((h, w))).astype(np.float64)[:, :, None]
    blob = encode_band_device(data, None, mze, verify=True)
    res = decode_blob(blob)
    err = np.abs(res.data[0, :, :, 0] - data[:, :, 0]).max()
    assert err <= mze * 1.01
    if oracle.available():
        ref = oracle.decode(blob)[0].reshape(h, w)
        np.testing.assert_array_equal(ref, res.data[0, :, :, 0])
        rblob = oracle.encode(data[:, :, 0], 1, w, h, 1, None, mze)
        assert abs(len(blob) - len(rblob)) < 64


def test_device_f64_masked_depth():
    rng = np.random.default_rng(51)
    data = (500 + 80 * rng.standard_normal((64, 72, 2))).astype(np.float64)
    mask = rng.random((64, 72)) > 0.3
    blob = encode_band_device(data, mask, 0.01)
    res = decode_blob(blob)
    np.testing.assert_array_equal(res.masks[0], mask)
    assert np.abs(res.data[0] - data)[mask].max() <= 0.0101
    if oracle.available():
        ref = oracle.decode(blob)[0].reshape(64, 72, 2)
        np.testing.assert_array_equal(ref[mask], res.data[0][mask])


def test_device_f64_lossless_fpl():
    """f64 lossless encodes on device via the fpl limb-pair pipeline:
    bit-exact through the host decoder and the reference library."""
    rng = np.random.default_rng(91)
    data = (make(np.float64, d=1) * np.pi + 1e-9 * rng.standard_normal((H, W, 1)))
    blob = encode_band_device(data.copy(), None, 0.0, verify=True)
    res = decode_blob(blob)
    np.testing.assert_array_equal(res.data[0], data)
    ref = oracle.decode(blob)[0].reshape(H, W, 1)
    np.testing.assert_array_equal(ref, data)
    # masked + depth
    d2 = np.concatenate([data, data * 0.5], axis=2)
    blob2 = encode_band_device(d2.copy(), MASK, 0.0, verify=True)
    res2 = decode_blob(blob2)
    np.testing.assert_array_equal(res2.data[0][MASK], d2[MASK])


def test_device_depth_diff_int_lossless():
    """nDepth>1 int lossless: correlated depth slices must select the
    depth-diff encoding (flag bit2) on device, shrink the blob, and decode
    bit-exactly through host and reference decoders."""
    rng = np.random.default_rng(61)
    h, w, d = 96, 112, 4
    base = rng.integers(0, 20000, (h, w, 1)).astype(np.int16)
    # strongly correlated slices: tiny per-depth deltas
    data = (base + np.cumsum(rng.integers(-2, 3, (h, w, d)), axis=2)).astype(np.int16)
    blob = encode_band_device(data, None, 0)
    res = decode_blob(blob)
    np.testing.assert_array_equal(res.data[0], data)
    if oracle.available():
        ref = oracle.decode(blob)[0].reshape(h, w, d)
        np.testing.assert_array_equal(ref, data)
    # must beat the no-diff encoding decisively on this data
    from lerc_tpu.ops import device_encode
    import jax.numpy as jnp
    from lerc_tpu.constants import DataType
    s5, t5, _, _, _, _ = device_encode.encode_tiles(
        jnp.asarray(data.astype(np.int32)), jnp.ones((h, w), bool),
        jnp.float32(0.5), h, w, d, DataType.SHORT, True, 4,  # v4: no diff
        1 << 19,
    )
    assert len(blob) < int(t5) * 0.8, (len(blob), int(t5))
    # host encoder size parity
    host_blob = BandEncoder(data, None, 0.0).encode()
    assert len(blob) <= len(host_blob) * 1.05, (len(blob), len(host_blob))


def test_device_depth_diff_masked():
    rng = np.random.default_rng(63)
    h, w, d = 64, 80, 3
    base = rng.integers(0, 250, (h, w, 1)).astype(np.uint16)
    data = np.clip(base + np.cumsum(rng.integers(0, 2, (h, w, d)), axis=2), 0, 60000).astype(np.uint16)
    mask = rng.random((h, w)) > 0.3
    blob = encode_band_device(data, mask, 0)
    res = decode_blob(blob)
    np.testing.assert_array_equal(res.data[0][mask], data[mask])
    if oracle.available():
        ref = oracle.decode(blob)[0].reshape(h, w, d)
        np.testing.assert_array_equal(ref[mask], data[mask])


def test_device_huffman_decode_sidecar():
    """Device-parallel Huffman DECODE via the encoder's per-group
    bit-offset sidecar: bit-exact, tamper-detected, host fallback for
    foreign (sidecar-less) blobs."""
    rng = np.random.default_rng(77)
    h, w = 96, 96
    # smooth-ish 8-bit image so delta-Huffman wins decisively
    img = (np.cumsum(rng.integers(-2, 3, (h, w)), axis=1) % 200).astype(np.uint8)
    blob, index = encode_band_device(img[:, :, None].copy(), None, 0.5,
                                     return_index=True)
    assert index is not None and "huffman_sbits" in index
    out = decode_band_device(blob, index=index)
    assert out is not None, "device Huffman decode fell back"
    np.testing.assert_array_equal(out.data[:, :, 0], img)
    # reference library agrees on the same wire bytes
    ref = oracle.decode(blob)[0].reshape(h, w)
    np.testing.assert_array_equal(ref, img)
    # foreign blob (no sidecar): native lengths-only scan rebuilds the
    # group offsets and the device path still decodes bit-exact
    out2 = decode_band_device(blob)
    assert out2 is not None, "foreign-blob device Huffman decode fell back"
    np.testing.assert_array_equal(out2.data[:, :, 0], img)
    # tampered sidecar fails loudly, never silently wrong pixels
    bad = dict(index)
    bs = index["huffman_sbits"].copy()
    bs[2] += 8
    bad["huffman_sbits"] = bs
    with pytest.raises(ValueError):
        decode_band_device(blob, index=bad)


def test_device_huffman_decode_direct_mode_char():
    """Direct (non-delta) Huffman + int8 symbols through the device
    decoder."""
    rng = np.random.default_rng(78)
    h, w = 64, 72
    # high-frequency noise: direct histogram beats delta
    img = rng.choice(np.arange(-5, 6, dtype=np.int8), size=(h, w),
                     p=np.r_[np.full(5, 0.02), 0.8, np.full(5, 0.02)]).astype(np.int8)
    blob, index = encode_band_device(img[:, :, None].copy(), None, 0.5,
                                     return_index=True)
    if index is None:
        pytest.skip("Huffman not selected for this data")
    out = decode_band_device(blob, index=index)
    assert out is not None
    np.testing.assert_array_equal(out.data[:, :, 0], img)
    ref = oracle.decode(blob)[0].reshape(h, w)
    np.testing.assert_array_equal(ref, img)


def test_device_huffman_decode_depth3():
    rng = np.random.default_rng(79)
    h, w, d = 56, 48, 3
    img = (np.cumsum(rng.integers(-1, 2, (h, w, d)), axis=1) % 150).astype(np.uint8)
    blob, index = encode_band_device(img.copy(), None, 0.5, return_index=True)
    if index is None:
        pytest.skip("Huffman not selected for this data")
    out = decode_band_device(blob, index=index)
    assert out is not None
    np.testing.assert_array_equal(out.data, img)
    ref = oracle.decode(blob)[0].reshape(h, w, d)
    np.testing.assert_array_equal(ref, img)


def test_device_huffman_masked_decode():
    """Masked whole-image Huffman DECODE on device:
    truncated-sidecar group decode + rank-space un-delta (segment pointer
    doubling over use_above links) + stride-window expansion. Bit-exact
    vs the host decoder and the reference library."""
    rng = np.random.default_rng(81)
    h, w = 96, 120
    base = (128 + 60 * np.sin(np.linspace(0, 6, h))[:, None]
            * np.cos(np.linspace(0, 4, w))[None, :])
    img = np.clip(base + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8)
    mask = rng.random((h, w)) > 0.25
    mask[10:30, 40:80] = False      # hole: prev-valid chains span rows
    mask[50, :] = False             # fully-invalid row
    mask[:, 0] = False              # invalid column 0: many use_above links
    blob, index = encode_band_device(img[:, :, None].copy(), mask, 0,
                                     return_index=True)
    if index is None or "huffman_sbits" not in index:
        pytest.skip("Huffman not selected for this data")
    out = decode_band_device(blob, index=index)
    assert out is not None, "masked device Huffman decode fell back"
    np.testing.assert_array_equal(out.data[:, :, 0][mask], img[mask])
    assert (out.data[:, :, 0][~mask] == 0).all()
    ref = oracle.decode(blob)[0].reshape(h, w)
    np.testing.assert_array_equal(ref[mask], img[mask])
    # tampered sidecar fails loudly
    bad = dict(index)
    bs = index["huffman_sbits"].copy()
    bs[1] += 8
    bad["huffman_sbits"] = bs
    with pytest.raises(ValueError):
        decode_band_device(blob, index=bad)


def test_device_huffman_masked_decode_direct_char():
    """Direct-mode masked Huffman decode, int8 symbols (offset 128)."""
    rng = np.random.default_rng(82)
    h, w = 64, 72
    img = rng.choice(np.arange(-5, 6, dtype=np.int8), size=(h, w),
                     p=np.r_[np.full(5, 0.02), 0.8, np.full(5, 0.02)]).astype(np.int8)
    mask = rng.random((h, w)) > 0.35
    blob, index = encode_band_device(img[:, :, None].copy(), mask, 0,
                                     return_index=True)
    if index is None or "huffman_sbits" not in index:
        pytest.skip("Huffman not selected for this data")
    out = decode_band_device(blob, index=index)
    assert out is not None
    np.testing.assert_array_equal(out.data[:, :, 0][mask], img[mask])
    ref = oracle.decode(blob)[0].reshape(h, w)
    np.testing.assert_array_equal(ref[mask], img[mask])


def test_device_huffman_masked_decode_depth2():
    """Masked delta-Huffman with nDepth 2: per-plane gap runs hit the
    live-gated group decode (mid-stream zero-bit positions)."""
    rng = np.random.default_rng(83)
    h, w, d = 64, 72, 2
    img = (np.cumsum(rng.integers(-1, 2, (h, w, d)), axis=1) % 150).astype(np.uint8)
    mask = rng.random((h, w)) > 0.4
    blob, index = encode_band_device(img.copy(), mask, 0, return_index=True)
    if index is None or "huffman_sbits" not in index:
        pytest.skip("Huffman not selected for this data")
    out = decode_band_device(blob, index=index)
    assert out is not None
    np.testing.assert_array_equal(out.data[mask], img[mask])
    ref = oracle.decode(blob)[0].reshape(h, w, d)
    np.testing.assert_array_equal(ref[mask], img[mask])


def test_device_huffman_masked_decode_sparse_and_stripes():
    """Stress the segment machinery: vertical stripes (use_above on every
    row for many columns) and a very sparse mask."""
    rng = np.random.default_rng(84)
    h, w = 80, 96
    img = (np.cumsum(rng.integers(-2, 3, (h, w)), axis=0) % 220).astype(np.uint8)
    stripes = np.zeros((h, w), bool)
    stripes[:, ::3] = True          # every valid pixel's left neighbor invalid
    sparse = rng.random((h, w)) < 0.06
    sparse[0, 0] = True
    for mask in (stripes, sparse):
        blob, index = encode_band_device(img[:, :, None].copy(), mask, 0,
                                         return_index=True)
        if index is None or "huffman_sbits" not in index:
            continue
        out = decode_band_device(blob, index=index)
        assert out is not None
        np.testing.assert_array_equal(out.data[:, :, 0][mask], img[mask])
        ref = oracle.decode(blob)[0].reshape(h, w)
        np.testing.assert_array_equal(ref[mask], img[mask])


def test_device_fpl_decode_sidecar():
    """Device fpl f32 DECODE via the per-plane Huffman group sidecar:
    bit-exact, tamper-detected, host fallback without the sidecar."""
    rng = np.random.default_rng(92)
    x, y = np.meshgrid(np.linspace(0, 3, 104), np.linspace(0, 2, 96))
    f = (1000 * np.exp(-((x - 1.5) ** 2 + (y - 1) ** 2))
         + 1e-3 * rng.standard_normal((96, 104))).astype(np.float32)
    blob, idx = encode_band_device(f[:, :, None].copy(), None, 0.0,
                                   return_index=True)
    if idx is None or "fpl_sbits" not in idx:
        pytest.skip("fpl not selected for this data")
    out = decode_band_device(blob, index=idx)
    assert out is not None, "device fpl decode fell back"
    np.testing.assert_array_equal(out.data[:, :, 0], f)
    # foreign blob: per-plane offsets rebuilt by the native scan
    out_f = decode_band_device(blob)
    assert out_f is not None, "foreign fpl device decode fell back"
    np.testing.assert_array_equal(out_f.data[:, :, 0], f)
    # tampered sidecar fails loudly
    bad = {"fpl_sbits": {k: v.copy() for k, v in idx["fpl_sbits"].items()}}
    k0 = next(iter(bad["fpl_sbits"]))
    if bad["fpl_sbits"][k0].shape[0] > 3:
        bad["fpl_sbits"][k0][2] += 4
        with pytest.raises(ValueError):
            decode_band_device(blob, index=bad)


def test_device_fpl_f64_decode_sidecar():
    """Device fpl f64 DECODE via the per-plane sidecar: limb-pair restore
    cumsums (52-bit mantissa mod arithmetic), bit-exact; tampering raises;
    f64 tiling blobs keep the host path."""
    rng = np.random.default_rng(93)
    x, y = np.meshgrid(np.linspace(0, 3, 104), np.linspace(0, 2, 96))
    f = (1000 * np.exp(-((x - 1.5) ** 2 + (y - 1) ** 2)) * np.pi
         + 1e-6 * rng.standard_normal((96, 104))).astype(np.float64)
    blob, idx = encode_band_device(f[:, :, None].copy(), None, 0.0,
                                   return_index=True)
    if idx is None or "fpl_sbits" not in idx:
        pytest.skip("fpl not selected")
    out = decode_band_device(blob, index=idx)
    assert out is not None, "device f64 fpl decode fell back"
    np.testing.assert_array_equal(out.data[:, :, 0], f)
    ref = oracle.decode(blob)[0].reshape(96, 104)
    np.testing.assert_array_equal(ref, f)
    bad = {"fpl_sbits": {k: v.copy() for k, v in idx["fpl_sbits"].items()}}
    k0 = next(iter(bad["fpl_sbits"]))
    if bad["fpl_sbits"][k0].shape[0] > 3:
        bad["fpl_sbits"][k0][2] += 4
        with pytest.raises(ValueError):
            decode_band_device(blob, index=bad)
    # lossy f64 tiling: device softfloat dequant, bit-exact vs reference
    b3 = encode_band_device(f[:, :, None].copy(), None, 0.01)
    out3 = decode_band_device(b3)
    ref3 = oracle.decode(b3)[0].reshape(96, 104)
    if out3 is not None:
        np.testing.assert_array_equal(np.asarray(out3.data)[:, :, 0], ref3)


@pytest.mark.parametrize("d,masked", [(1, False), (1, True), (3, False), (3, True)])
def test_device_huffman_foreign_blob_decode(d, masked):
    """Device-parallel decode of FOREIGN 8-bit Huffman
    blobs (reference-encoded, no sidecar). The native lengths-only scan
    (lerc_native.cpp lerc_huffman_group_offsets) rebuilds the per-group
    bit offsets, then the normal device group decode runs. Bit-exact vs
    the reference for plain/masked x depth-1/3 layouts.
    Ref: Huffman.h:144-214 (serial canonical decode this parallelizes)."""
    rng = np.random.default_rng(1000 + d + 2 * masked)
    h, w = 149, 93  # h*w*d not a 64-multiple: the live grid must pad
    img = (np.cumsum(rng.integers(-2, 3, size=h * w * d)).astype(np.int64)
           % 200).astype(np.uint8).reshape(h, w, d)
    mask = None
    if masked:
        mask = (rng.random((h, w)) > 0.3).astype(np.uint8)
        img[mask == 0] = 0
    blob = oracle.encode(img, d, w, h, 1, mask, 0.0)
    # must actually be a whole-image Huffman blob, else the test is vacuous
    res = decode_band_device(np.frombuffer(blob, np.uint8))
    assert res is not None, "foreign Huffman blob fell back to host"
    arr = np.asarray(res.data).reshape(h, w, d)
    if masked:
        m = mask.astype(bool)
        np.testing.assert_array_equal(arr[m], img[m])
    else:
        np.testing.assert_array_equal(arr, img)


def test_native_huffman_group_offsets_matches_sidecar():
    """The native lengths-only scan reproduces the encoder's own sidecar
    offsets exactly on an unmasked stream."""
    if not native.available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(55)
    h, w = 96, 128
    img = (np.cumsum(rng.integers(-2, 3, (h, w)), axis=1) % 180).astype(np.uint8)
    blob, index = encode_band_device(img[:, :, None].copy(), None, 0.5,
                                     return_index=True)
    if index is None or "huffman_sbits" not in index:
        pytest.skip("Huffman not selected")
    out = decode_band_device(blob)  # foreign-style: no index passed
    assert out is not None
    np.testing.assert_array_equal(out.data[:, :, 0], img)


def test_native_huffman_spec_scan_matches_serial(monkeypatch):
    """The speculative chunk-parallel scan (multicore path, forced via
    LERC_SPEC_THREADS) agrees bit-for-bit with the serial multi-LUT walk."""
    if not native.available():
        pytest.skip("native lib unavailable")
    from lerc_tpu.codec import huffman as hh
    rng = np.random.default_rng(9)
    n = 1 << 20
    syms = ((rng.standard_normal(n) * 6).astype(np.int64) % 256).astype(np.uint8)
    hist = np.bincount(syms, minlength=256).astype(np.int64)
    lengths = hh.compute_code_lengths(hist)
    codes = hh.canonical_codes(lengths)
    stream = hh.encode_symbols(syms, lengths, codes)
    buf = np.frombuffer(stream, np.uint8)
    cap = -(-max(buf.size, 512) // 512) * 512
    sp = np.zeros(cap, np.uint8)
    sp[: buf.size] = buf
    n_groups = -(-n // 64)
    counts = np.full(n_groups, 64, np.int32)
    counts[-1] = n - (n_groups - 1) * 64
    monkeypatch.setenv("LERC_SPEC_THREADS", "0")
    serial = native.huffman_group_offsets(sp, lengths, codes, counts)
    monkeypatch.setenv("LERC_SPEC_THREADS", "4")
    spec = native.huffman_group_offsets(sp, lengths, codes, counts)
    np.testing.assert_array_equal(serial, spec)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_device_fpl_foreign_blob_decode(dtype):
    """Foreign (reference-encoded) lossless float
    blobs decode on device -- each Huffman plane's group offsets come from
    the native lengths-only scan; restore cumsums / predictor undo /
    float-transform undo stay device-parallel. Bit-exact.
    Ref: fpl_Lerc2Ext.cpp:738-866 (the serial decode this parallelizes)."""
    rng = np.random.default_rng(200)
    h, w = 104, 96
    x, y = np.meshgrid(np.linspace(0, 4, w), np.linspace(0, 3, h))
    f = (1000 * np.exp(-((x - 2) ** 2 + (y - 1.5) ** 2))
         + 1e-5 * rng.standard_normal((h, w))).astype(dtype)
    blob = oracle.encode(f[:, :, None], 1, w, h, 1, None, 0.0)
    res = decode_band_device(np.frombuffer(blob, np.uint8))
    assert res is not None, "foreign fpl blob fell back to host"
    np.testing.assert_array_equal(np.asarray(res.data)[:, :, 0], f)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_device_fpl_masked_foreign_decode(dtype):
    """Masked fpl blobs decode on device: fpl is mask-oblivious (the
    reference hands it the full raster, Lerc2.cpp:305-311), so the same
    pipeline serves masked wires; valid pixels bit-exact vs the reference
    and the decoded mask matches."""
    rng = np.random.default_rng(230)
    h, w = 120, 104
    x, y = np.meshgrid(np.linspace(0, 4, w), np.linspace(0, 3, h))
    f = (900 * np.exp(-((x - 2) ** 2 + (y - 1.5) ** 2))).astype(dtype)
    mask = np.ones((h, w), np.uint8)
    mask[rng.random((h, w)) > 0.98] = 0
    blob = oracle.encode(f * mask, 1, w, h, 1, mask, 0.0)
    res = decode_band_device(np.frombuffer(blob, np.uint8))
    if res is None:
        pytest.skip("reference did not choose fpl for this raster")
    m = mask.astype(bool)
    ref = oracle.decode(blob)[0].reshape(h, w)
    dev = np.asarray(res.data)[:, :, 0]
    np.testing.assert_array_equal(dev[m], ref[m])
    np.testing.assert_array_equal(res.mask, m)


@pytest.mark.parametrize("dtype,masked", [(np.int32, False), (np.int32, True),
                                          (np.uint16, False), (np.int16, True)])
def test_device_depth_diff_decode(dtype, masked):
    """Depth-diff records (v5+, comprFlag bit 2) on the device general
    path: slice d reconstructs from slice d-1 via a lax.scan over the
    depth axis (Lerc2.cpp:2026-2230 bDiff semantics). The reference's
    encoder picks diff on strongly depth-correlated ints; asserted so the
    test can't pass vacuously. Bit-exact vs the reference."""
    rng = np.random.default_rng(310 + masked)
    h, w, d = 96, 112, 4
    base = np.round(np.cumsum(rng.integers(-2, 3, (h, w)), axis=1) * 10)
    img = np.stack([base + k * 3 + rng.integers(0, 2, (h, w))
                    for k in range(d)], -1).astype(dtype)
    mask = None
    if masked:
        mask = (rng.random((h, w)) > 0.25).astype(np.uint8)
        img = img * mask[:, :, None]
    blob = oracle.encode(np.ascontiguousarray(img), d, w, h, 1, mask, 0.0)
    res = decode_band_device(np.frombuffer(blob, np.uint8))
    assert res is not None, "depth-diff blob fell back to host"
    ref = oracle.decode(blob)[0].reshape(h, w, d)
    m = mask.astype(bool) if masked else np.ones((h, w), bool)
    np.testing.assert_array_equal(np.asarray(res.data)[m], ref[m])
    # the wire must actually contain diff records
    from lerc_tpu.codec import header as hdr_mod, rle
    from lerc_tpu.codec.bitmask import bits_to_bool, mask_size_bytes
    from lerc_tpu.constants import DT_SIZE
    src = memoryview(blob)
    head, pos = hdr_mod.read_header(src)
    nbm = int.from_bytes(src[pos:pos + 4], "little", signed=True)
    pos += 4
    mk = np.ones((h, w), bool)
    if nbm > 0:
        mk = bits_to_bool(rle.decompress(src[pos:pos + nbm],
                                         mask_size_bytes(w, h)), w, h)
        pos += nbm
    pos += 2 * d * DT_SIZE[head.dt] + 1
    nbv, nbh = -(-h // 8), -(-w // 8)
    nb = nbv * nbh
    padded = np.zeros((nbv * 8, nbh * 8), bool)
    padded[:h, :w] = mk
    vb = padded.reshape(nbv, 8, nbh, 8).transpose(0, 2, 1, 3).reshape(nb, 64)
    recs, _ = native.tile_scan(
        np.frombuffer(src[pos:head.blob_size], np.uint8),
        vb.sum(1).astype(np.int32),
        ((np.arange(nb) % nbh) * 8).astype(np.int32), nb, d,
        int(head.dt), head.version)
    assert (recs["mode"] >= 8).any(), "no diff records: vacuous test data"
