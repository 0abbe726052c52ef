"""Public API tests, modeled on the reference binding's built-in test()
(_lerc.py:799-1045): 3D float nDepth=3, 3-band float with mask, 4D with
noData/mixed case via both _4D and _ma entry points."""
import numpy as np
import pytest

import lerc_tpu as lerc

from . import oracle


def test_roundtrip_3d_ndepth():
    # test case 1 of _lerc.py: 2D float with nDepth 3
    w, h, n_dep = 100, 80, 3
    x = np.linspace(0, 5, w)[None, :, None]
    y = np.linspace(0, 4, h)[:, None, None]
    d = np.arange(n_dep)[None, None, :]
    data = (np.sin(x + d) * np.cos(y) * 50 + x * y).astype(np.float64)
    result, n_bytes, blob = lerc.encode_4D(data, n_dep, None, 0.001, data.nbytes)
    assert result == 0 and n_bytes == len(blob)
    (result, version, dt, nvpp, n_cols, n_rows, n_bands, n_valid, blob_size,
     n_masks, z_min, z_max, mze_used, n_uses_nd) = lerc.getLercBlobInfo_4D(blob)
    assert result == 0
    assert (n_cols, n_rows, n_bands, nvpp) == (w, h, 1, n_dep)
    assert blob_size == len(blob)
    result, arr, mask, nd = lerc.decode_4D(blob)
    assert result == 0
    assert arr.shape == (h, w, n_dep)
    assert lerc.findMaxZError_4D(data, arr, mask, 1) <= 0.001 * 1.1
    # data ranges without decode
    result, mins, maxs = lerc.getLercDataRanges(blob, n_dep, 1)
    assert result == 0
    for k in range(n_dep):
        assert mins[0, k] <= data[:, :, k].min() <= maxs[0, k]


def test_roundtrip_masked_multiband():
    rng = np.random.default_rng(3)
    n_bands, h, w = 3, 60, 70
    data = rng.normal(100, 30, (n_bands, h, w)).astype(np.float32)
    mask = rng.random((h, w)) > 0.2
    result, n_bytes, blob = lerc.encode(data, 1, True, mask, 0.01, data.nbytes * 2)
    assert result == 0
    result, arr, dec_mask = lerc.decode(blob)
    assert result == 0
    assert arr.shape == (n_bands, h, w)
    assert np.array_equal(dec_mask, mask)
    assert lerc.findMaxZError_4D(data, arr, dec_mask, n_bands) <= 0.011


def test_masked_array_roundtrip_with_nodata():
    # 4D mixed-case: some values valid, others noData at same pixel
    rng = np.random.default_rng(5)
    n_bands, h, w, n_dep = 2, 30, 40, 2
    data = rng.normal(50, 10, (n_bands, h, w, n_dep))
    amask = rng.random(data.shape) < 0.15  # masked values
    npma = np.ma.array(data, mask=amask)
    nodata = np.ma.array([-9999.0, -9999.0], mask=[False, False])
    result, n_bytes, blob = lerc.encode_ma(npma, n_dep, 0.001, int(data.nbytes * 2), nodata)
    assert result == 0
    result, npma_dec, nvpp, nd_dec = lerc.decode_ma(blob)
    assert result == 0
    assert nvpp == n_dep
    # masked values must still be masked, valid values within tolerance
    err = lerc.findMaxZError_ma(npma, npma_dec)
    assert err <= 0.001 * 1.1
    assert np.array_equal(np.ma.getmaskarray(npma_dec), amask)


def test_mixed_case_without_nodata_fails():
    rng = np.random.default_rng(6)
    data = rng.normal(0, 1, (20, 20, 3))
    amask = np.zeros(data.shape, bool)
    amask[5, 5, 1] = True  # mixed case at one pixel
    npma = np.ma.array(data, mask=amask)
    rv = lerc.encode_ma(npma, 3, 0.0, int(data.nbytes * 2), None)
    assert rv[0] == int(lerc.ErrCode.HAS_NO_DATA)


def test_interop_with_reference_binding_blobs():
    if not oracle.available():
        pytest.skip("reference lib not built")
    rng = np.random.default_rng(8)
    data = (rng.random((50, 60)) * 1000).astype(np.float32)
    # our api encode -> reference decode
    result, n, blob = lerc.encode(data, 1, False, None, 0.1, data.nbytes * 2)
    assert result == 0
    ref_dec, _, _, _ = oracle.decode(blob)
    r2, arr, _ = lerc.decode(blob)
    assert np.array_equal(ref_dec[0, :, :, 0], arr)


def test_compress_decompress_pythonic():
    rng = np.random.default_rng(9)
    data = (rng.random((3, 40, 50)) * 100).astype(np.float32)
    blob = lerc.compress(data, 0.001)
    out, mask = lerc.decompress(blob)
    assert out.shape == data.shape
    assert np.abs(out - data).max() <= 0.0011
    assert mask.all()


def test_blob_info_errors():
    rv = lerc.getLercBlobInfo(b"garbage not a lerc blob")
    assert rv[0] == int(lerc.ErrCode.FAILED)


def test_data_ranges_match_reference_no_decode():
    """getLercDataRanges must agree with the reference's lerc_getDataRanges
    on a reference-encoded multi-band nDepth>1 blob (header+ranges reads
    only -- mirrors Lerc2::GetRanges, Lerc2.cpp:514-573)."""
    from . import oracle

    if not oracle.available():
        import pytest

        pytest.skip("reference lib not built")
    rng = np.random.default_rng(11)
    n_bands, h, w, n_dep = 2, 40, 50, 3
    data = rng.normal(500, 80, (n_bands, h, w, n_dep)).astype(np.float32)
    blob = oracle.encode(data, n_dep, w, h, n_bands, None, 0.001)
    ref_mins, ref_maxs = oracle.data_ranges(blob, n_dep, n_bands)
    result, mins, maxs = lerc.getLercDataRanges(blob, n_dep, n_bands)
    assert result == 0
    np.testing.assert_array_equal(mins.ravel(), np.asarray(ref_mins).ravel())
    np.testing.assert_array_equal(maxs.ravel(), np.asarray(ref_maxs).ravel())


def test_accelerated_encode_routing():
    """With acceleration forced on, big clean bands route to the device
    encoder; the blob stays wire-exact (reference-decodable) and within
    the ENCODE_VERIFY error tolerance."""
    from lerc_tpu.codec import encode_orchestrator as eo
    from . import oracle

    rng = np.random.default_rng(13)
    h, w = 520, 560  # >= the acceleration pixel threshold
    data = (300 + 50 * np.sin(np.linspace(0, 8, h))[:, None]
            * np.cos(np.linspace(0, 5, w))[None, :]
            + rng.normal(0, 1, (h, w))).astype(np.float32)
    eo.set_acceleration(True)
    try:
        r, n, blob = lerc.encode(data, 1, False, None, 0.01, data.nbytes * 2)
        assert r == 0
        r2, out, m = lerc.decode(bytes(blob[:n]))
        assert r2 == 0
        err = np.abs(np.asarray(out).reshape(h, w).astype(np.float64) - data).max()
        assert err <= 0.01 * 1.1
        if oracle.available():
            ref = oracle.decode(bytes(blob[:n]))[0].reshape(h, w)
            assert np.abs(ref.astype(np.float64) - data).max() <= 0.011
    finally:
        eo.set_acceleration(None)


def test_accelerated_decode_routing():
    """With acceleration forced on, big-band decodes route through the
    device decoder and agree with the host decoder BIT-EXACTLY (the f32
    lossy dequant runs the double ScaleBack through softfloat)."""
    from lerc_tpu.codec import encode_orchestrator as eo

    rng = np.random.default_rng(17)
    h, w = 520, 560
    data = (300 + 50 * np.sin(np.linspace(0, 8, h))[:, None]
            * np.cos(np.linspace(0, 5, w))[None, :]
            + rng.normal(0, 1, (h, w))).astype(np.float32)
    r, n, blob = lerc.encode(data, 1, False, None, 0.02, data.nbytes * 2)
    assert r == 0
    blob = bytes(blob[:n])
    r2, host_out, _ = lerc.decode(blob)
    eo.set_acceleration(True)
    try:
        r3, dev_out, _ = lerc.decode(blob)
    finally:
        eo.set_acceleration(None)
    assert r2 == 0 and r3 == 0
    np.testing.assert_array_equal(np.asarray(dev_out), np.asarray(host_out))
    # int lossless must be bit-exact through either path
    idata = rng.integers(0, 30000, (h, w)).astype(np.int16)
    r, n, blob = lerc.encode(idata, 1, False, None, 0, idata.nbytes * 2 + 65536)
    blob = bytes(blob[:n])
    eo.set_acceleration(True)
    try:
        r4, dev_i, _ = lerc.decode(blob)
    finally:
        eo.set_acceleration(None)
    np.testing.assert_array_equal(np.asarray(dev_i).reshape(h, w), idata)


def test_compute_compressed_size_matches_encode():
    """lerc_computeCompressedSize analog:
    exact blob size without producing the blob, across dtypes and masks."""
    import lerc_tpu

    rng = np.random.default_rng(41)
    for dtype, mze in ((np.float32, 0.001), (np.uint8, 0.0), (np.int16, 0.0),
                       (np.float64, 0.0)):
        data = (np.cumsum(rng.normal(0, 3, (40, 56)), axis=1)).astype(dtype)
        for mask in (None, rng.random((40, 56)) > 0.2):
            r1 = lerc_tpu.computeCompressedSize(
                data, 1, mask is not None, mask, mze)
            assert r1[0] == 0
            r2 = lerc_tpu.encode(data, 1, mask is not None, mask, mze,
                                 4 * data.nbytes)
            assert r2[0] == 0
            assert r1[1] == r2[1] == len(r2[2]), (dtype, mask is None)
            if oracle.available():
                # cross-check against the reference's own dry-run sizing
                # contract: our size equals our blob, byte-exact (the
                # reference size differs where encoder choices differ,
                # which the wire permits)
                pass


def test_decode_to_double():
    """lerc_decodeToDouble analog: any stored
    dtype decodes to float64, values exactly equal to the native decode."""
    import lerc_tpu

    rng = np.random.default_rng(42)
    for dtype in (np.uint8, np.int16, np.int32, np.float32, np.float64):
        data = (np.cumsum(rng.normal(0, 3, (33, 29)), axis=1)).astype(dtype)
        r = lerc_tpu.encode(data, 1, False, None, 0.0, 4 * data.nbytes)
        assert r[0] == 0
        blob = bytes(r[2])
        rd = lerc_tpu.decodeToDouble(blob)
        assert rd[0] == 0
        assert rd[1].dtype == np.float64
        rn = lerc_tpu.decode(blob)
        np.testing.assert_array_equal(rd[1], rn[1].astype(np.float64))
    # 4D variant
    d4 = rng.integers(0, 200, (2, 16, 24, 3)).astype(np.uint8)
    r = lerc_tpu.encode_4D(d4, 3, None, 0.0, 4 * d4.nbytes)
    rd = lerc_tpu.decodeToDouble_4D(bytes(r[2]))
    assert rd[0] == 0 and rd[1].dtype == np.float64
    np.testing.assert_array_equal(rd[1], d4.astype(np.float64))


def test_lerc1_decode_to_dtype():
    """Lerc1 output-dtype conversion with the
    reference's floor(z + 0.5) semantics (Lerc.cpp:794-842)."""
    import numpy as np
    from lerc_tpu import api

    from . import golden

    blob = golden.blob("world.lerc1")
    rv = api.decode(blob)
    assert rv[0] == 0
    f32, mask = rv[1], rv[2]
    m = np.ones(f32.shape, bool) if mask is None else np.asarray(mask, bool)
    rv16 = api.decode_to_dtype(blob, np.int16)
    assert rv16[0] == 0
    got = rv16[1]
    assert got.dtype == np.int16
    exp = np.floor(f32.astype(np.float64) + 0.5).astype(np.int16)
    np.testing.assert_array_equal(got[m], exp[m])
    assert np.all(got[~m] == 0)
    # float target: plain cast
    rv64 = api.decode_to_dtype(blob, np.float64)
    np.testing.assert_array_equal(rv64[1][m], f32.astype(np.float64)[m])
    # Lerc2 blobs demand the stored dtype
    l2 = golden.blob("california_400_400_1_float.lerc2")
    assert api.decode_to_dtype(l2, np.float32)[0] == 0
    assert api.decode_to_dtype(l2, np.int16) == 2  # WRONG_PARAM


def test_encode_for_version():
    """lerc_encodeForVersion / lerc_computeCompressedSizeForVersion
    (Lerc_c_api.h:139-176): the blob targets the requested codec version
    and the reference decodes it; sizes match exactly."""
    rng = np.random.default_rng(23)
    h, w = 120, 140
    data = (40 * np.sin(np.linspace(0, 7, h))[:, None]
            * np.cos(np.linspace(0, 5, w))[None, :]
            + rng.normal(0, 1, (h, w))).astype(np.float32)
    from lerc_tpu.codec import header as hdr

    for v in (2, 3, 4, 5, 6, -1):
        r, n, blob = lerc.encodeForVersion(data, v, 1, False, None, 0.01,
                                           data.nbytes * 2)
        assert r == 0
        blob = bytes(blob[:n])
        head, _ = hdr.read_header(memoryview(blob))
        assert head.version == (v if v != -1 else 6)
        r2, nsz = lerc.computeCompressedSizeForVersion(data, v, 1, False,
                                                       None, 0.01)
        assert r2 == 0 and nsz == n
        rd, img, _m = lerc.decode(blob)
        assert rd == 0
        assert np.abs(np.asarray(img) - data).max() <= 0.01 * 1.001
        if oracle.available():
            ref = oracle.decode(blob)[0].reshape(h, w)
            np.testing.assert_array_equal(ref, np.asarray(img))
