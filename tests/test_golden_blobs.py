"""Golden tests: the three blobs shipped with the reference decode
bit-exact against the reference's own decode (tests/golden.py)."""
import numpy as np
import pytest

from lerc_tpu.codec.orchestrator import decode_blob, get_lerc_info

from . import golden, oracle


@pytest.mark.parametrize(
    "name", ["california_400_400_1_float.lerc2", "bluemarble_256_256_3_byte.lerc2", "world.lerc1"]
)
def test_golden_decode_bit_exact(name):
    blob = golden.blob(name)
    res = decode_blob(blob)
    ref_data, ref_masks, exp = golden.expected(name)
    valid = (np.ones(ref_data.shape[:3], bool) if ref_masks is None
             else np.broadcast_to(ref_masks, ref_data.shape[:3]))
    assert res.data.dtype == ref_data.dtype
    assert np.array_equal(res.data[valid], ref_data[valid])
    if ref_masks is not None:
        assert np.array_equal(res.masks[: ref_masks.shape[0]], ref_masks)
    info = get_lerc_info(blob)
    assert info.n_bands == exp["bands"]
    assert info.n_cols == exp["width"]
    assert info.n_rows == exp["height"]
    assert int(info.dt) == exp["dtype"]
    assert info.num_valid_pixel == int(valid[0].sum())
    if not info.is_lerc1:
        assert info.z_min == ref_data[valid].min()
        assert info.z_max == ref_data[valid].max()


@pytest.mark.parametrize(
    "name", ["california_400_400_1_float.lerc2", "bluemarble_256_256_3_byte.lerc2"]
)
def test_golden_reencode_roundtrip(name):
    """BASELINE config: decode golden blob, re-encode lossless with our encoder,
    decode with the REFERENCE library, require bit-exact pixels + masks."""
    from lerc_tpu.codec.encode_orchestrator import encode_blob

    if not oracle.available():
        pytest.skip("needs the reference library (ref_build/libLerc.so)")
    blob = golden.blob(name)
    res = decode_blob(blob)
    masks = res.masks.astype(np.uint8)
    if np.all(masks == masks[0:1]):
        masks = masks[0:1]
    our_blob = encode_blob(res.data, masks, 0.0)
    ref_data, ref_masks, _, _ = oracle.decode(our_blob)
    assert np.array_equal(ref_data, res.data)
    if ref_masks is not None:
        assert np.array_equal(ref_masks.astype(bool)[0], res.masks[0])
    # and our own decoder agrees
    res2 = decode_blob(our_blob)
    assert np.array_equal(res2.data, res.data)
    assert np.array_equal(res2.masks, res.masks)


def test_golden_blobs_reencode_device():
    """Decode the shipped golden blobs and re-encode through the DEVICE
    encoder; the reference library must accept the new blob and decode it
    bit-exactly (lossless)."""
    from lerc_tpu.codec.device_codec import encode_band_device

    if not oracle.available():
        pytest.skip("needs the reference library (ref_build/libLerc.so)")

    # bluemarble: 3-band uint8 -> device whole-image Huffman per band
    blob = golden.blob("bluemarble_256_256_3_byte.lerc2")
    res = decode_blob(blob)
    for band in range(res.data.shape[0]):
        b2 = encode_band_device(res.data[band], None, 0)
        ref = oracle.decode(b2)[0].reshape(256, 256)
        np.testing.assert_array_equal(ref, res.data[band, :, :, 0])

    # california: float32 -> device fpl lossless re-encode of the decoded DEM
    blob = golden.blob("california_400_400_1_float.lerc2")
    res = decode_blob(blob)
    data = res.data[0].copy()
    data[~res.masks[0]] = 0  # device encoder is all-valid; mask region zeroed
    b2 = encode_band_device(np.ascontiguousarray(data), None, 0.0)
    ref = oracle.decode(b2)[0].reshape(400, 400)
    np.testing.assert_array_equal(ref, data[:, :, 0])
