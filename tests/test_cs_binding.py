"""C#-binding conformance: runs the statement-exact Python simulation of
bindings/csharp/LercDecode.cs (bindings/csharp/cs_sim.py) over the same
vector matrix as the JS binding tests, comparing every C-API-shaped call
(lerc_getBlobInfo / lerc_getDataRanges / lerc_decode_4D /
lerc_decodeToDouble) field-for-field and bit-for-bit against the C++
reference library. A logic error in the C# decoder's algorithms fails
here (this environment has no .NET runtime; the simulation is the
executable twin)."""
import pathlib
import sys

import numpy as np
import pytest

from . import golden, oracle

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "bindings" / "csharp"))
import cs_sim  # noqa: E402

# Sim-drift tripwire: an edit to LercDecode.cs without
# a matching cs_sim.py edit must fail here, at collection, BEFORE any
# decode runs -- otherwise the "statement-exact twin" premise silently rots.
cs_sim.check_binding_in_sync()

pytestmark = pytest.mark.skipif(not oracle.available(), reason="reference lib not built")

H, W = 67, 83
RNG = np.random.default_rng(42)
X, Y = np.meshgrid(np.linspace(0, 9, W), np.linspace(0, 7, H))
DEM = (np.sin(X) * np.cos(Y) * 500 + X * Y).astype(np.float64)
MASK = (RNG.random((H, W)) > 0.3).astype(np.uint8)

DT_NUMPY = [np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32,
            np.float32, np.float64]


def check(blob):
    """Mirror the oracle's exact C-API call sequence through cs_sim and
    compare every output."""
    ref_info = oracle.blob_info(blob)

    info_arr = np.zeros(11, np.int64)
    ranges_arr = np.zeros(3, np.float64)
    rc = cs_sim.lerc_getBlobInfo(blob, len(blob), info_arr, ranges_arr, 11, 3)
    assert rc == 0
    keys = ["version", "dataType", "nDim", "nCols", "nRows", "nBands",
            "nValidPixels", "blobSize", "nMasks", "nDepth", "nUsesNoDataValue"]
    for i, k in enumerate(keys):
        assert info_arr[i] == ref_info[k], (k, info_arr[i], ref_info[k])
    assert ranges_arr[0] == ref_info["zMin"]
    assert ranges_arr[1] == ref_info["zMax"]
    assert ranges_arr[2] == ref_info["maxZErrUsed"]

    n_depth, n_cols, n_rows = ref_info["nDepth"], ref_info["nCols"], ref_info["nRows"]
    n_bands, n_masks, dt = ref_info["nBands"], ref_info["nMasks"], ref_info["dataType"]

    ref_data, ref_masks, ref_uses_nd, ref_nd = oracle.decode(blob, ref_info)

    data = np.zeros(n_bands * n_rows * n_cols * n_depth, DT_NUMPY[dt])
    masks = np.zeros(max(n_masks, 1) * n_rows * n_cols, np.uint8)
    uses_nd = np.zeros(n_bands, np.uint8)
    nd = np.zeros(n_bands, np.float64)
    rc = cs_sim.lerc_decode_4D(blob, len(blob), n_masks,
                               masks if n_masks > 0 else None,
                               n_depth, n_cols, n_rows, n_bands, dt, data,
                               uses_nd, nd)
    assert rc == 0
    got = data.reshape(n_bands, n_rows, n_cols, n_depth)
    if n_masks > 0:
        got_masks = masks.reshape(n_masks, n_rows, n_cols)
        np.testing.assert_array_equal(got_masks, ref_masks)
    np.testing.assert_array_equal(uses_nd, ref_uses_nd)
    np.testing.assert_array_equal(nd, ref_nd)
    for b in range(n_bands):
        if n_masks > 0:
            m = ref_masks[min(b, n_masks - 1)].astype(bool)
            np.testing.assert_array_equal(got[b][m], ref_data[b][m])
        else:
            np.testing.assert_array_equal(got[b], ref_data[b])

    # decodeToDouble: exact widen of the typed decode
    ddata = np.zeros(n_bands * n_rows * n_cols * n_depth, np.float64)
    dmasks = np.zeros(max(n_masks, 1) * n_rows * n_cols, np.uint8)
    rc = cs_sim.lerc_decodeToDouble_4D(blob, len(blob), n_masks,
                                       dmasks if n_masks > 0 else None,
                                       n_depth, n_cols, n_rows, n_bands, ddata,
                                       uses_nd, nd)
    assert rc == 0
    dgot = ddata.reshape(n_bands, n_rows, n_cols, n_depth)
    for b in range(n_bands):
        if n_masks > 0:
            m = ref_masks[min(b, n_masks - 1)].astype(bool)
            np.testing.assert_array_equal(dgot[b][m],
                                          ref_data[b][m].astype(np.float64))
        else:
            np.testing.assert_array_equal(dgot[b], ref_data[b].astype(np.float64))

    # lerc_getDataRanges (reference rejects it for Lerc1 and noData blobs)
    if ref_info["version"] > 0 and not ref_info["nUsesNoDataValue"]:
        ref_mins, ref_maxs = oracle.data_ranges(blob, n_depth, n_bands)
        mins = np.zeros(n_depth * n_bands, np.float64)
        maxs = np.zeros(n_depth * n_bands, np.float64)
        rc = cs_sim.lerc_getDataRanges(blob, len(blob), n_depth, n_bands, mins, maxs)
        assert rc == 0
        np.testing.assert_array_equal(mins, ref_mins)
        np.testing.assert_array_equal(maxs, ref_maxs)


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "uint16",
                                   "int32", "uint32", "float32", "float64"])
@pytest.mark.parametrize("masked", [False, True])
def test_cs_tiling(dtype, masked):
    arr = {
        "int8": np.round(DEM / 8).astype(np.int8),
        "uint8": np.clip(np.round(DEM / 4) + 128, 0, 255).astype(np.uint8),
        "int16": np.round(DEM * 30).astype(np.int16),
        "uint16": np.clip(np.round(DEM * 30) + 20000, 0, 65535).astype(np.uint16),
        "int32": np.round(DEM * 1000).astype(np.int32),
        "uint32": (np.round(DEM * 1000) + 600000).astype(np.uint32),
        "float32": DEM.astype(np.float32),
        "float64": DEM,
    }[dtype]
    mze = 1.0 if arr.dtype.kind in "iu" and arr.dtype.itemsize == 1 else (
        0.0 if arr.dtype.kind in "iu" else 0.01)
    m = MASK if masked else None
    data = arr * MASK.astype(arr.dtype) if masked else arr
    check(oracle.encode(data, 1, W, H, 1, m, mze))


@pytest.mark.parametrize("version", [2, 3, 4, 5, 6])
def test_cs_versions(version):
    check(oracle.encode(DEM.astype(np.float32), 1, W, H, 1, None, 0.01,
                        version=version))


def test_cs_lut():
    seg = ((np.floor(X * 2) + np.floor(Y * 3)) * 10).astype(np.float32)
    check(oracle.encode(seg, 1, W, H, 1, None, 0.5))


@pytest.mark.parametrize("masked", [False, True])
def test_cs_huffman_delta(masked):
    smooth = (np.cumsum(RNG.integers(-2, 3, size=H * W)).astype(np.int64) % 200
              ).astype(np.uint8).reshape(H, W)
    m = MASK if masked else None
    check(oracle.encode(smooth * MASK if masked else smooth, 1, W, H, 1, m, 0.0))


def test_cs_huffman_direct_s8():
    noisy = RNG.choice(np.arange(-5, 6, dtype=np.int8), size=(H, W),
                       p=np.r_[np.full(5, 0.02), 0.8, np.full(5, 0.02)])
    check(oracle.encode(noisy, 1, W, H, 1, None, 0.0))


@pytest.mark.parametrize("masked", [False, True])
def test_cs_huffman_depth3(masked):
    d3 = (np.cumsum(RNG.integers(-1, 2, (H, W, 3)), axis=1) % 150).astype(np.uint8)
    m = MASK if masked else None
    check(oracle.encode(d3 * MASK[:, :, None] if masked else d3, 3, W, H, 1, m, 0.0))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cs_fpl(dtype):
    check(oracle.encode((DEM * np.pi).astype(dtype), 1, W, H, 1, None, 0.0))


def test_cs_fpl_depth3():
    f32 = DEM.astype(np.float32)
    f3 = np.ascontiguousarray(np.stack([f32, f32 * 0.5 + 3, f32 * -0.25], -1))
    check(oracle.encode(f3, 3, W, H, 1, None, 0.0))


def test_cs_tiling_depth3():
    f32 = DEM.astype(np.float32)
    f3 = np.ascontiguousarray(np.stack([f32, f32 * 0.5 + 3, f32 * -0.25], -1))
    check(oracle.encode(f3, 3, W, H, 1, None, 0.01))


def test_cs_const_and_all_invalid():
    check(oracle.encode(np.full((H, W), 7.25, np.float32), 1, W, H, 1, None, 0.01))
    check(oracle.encode(np.zeros((H, W), np.float32), 1, W, H, 1,
                        np.zeros((H, W), np.uint8), 0.01))


def test_cs_multiband():
    f32 = DEM.astype(np.float32)
    b3 = np.ascontiguousarray(np.stack([f32, f32 * 2 + 5, f32 * -1], 0))
    check(oracle.encode(b3, 1, W, H, 3, None, 0.01))
    masks3 = np.stack([MASK, (RNG.random((H, W)) > 0.5).astype(np.uint8),
                       np.ones((H, W), np.uint8)], 0)
    check(oracle.encode(b3 * masks3.astype(np.float32), 1, W, H, 3, masks3, 0.01))


def test_cs_nodata():
    nd = DEM.astype(np.float32)
    nd[::7, ::5] = -9999.0
    check(oracle.encode(nd, 1, W, H, 1, None, 0.01,
                        uses_nodata=np.array([1], np.uint8),
                        nodata=np.array([-9999.0], np.float64)))


def test_cs_golden_blobs():
    check(golden.blob("california_400_400_1_float.lerc2"))
    check(golden.blob("bluemarble_256_256_3_byte.lerc2"))
    check(golden.blob("world.lerc1"))


def test_cs_error_codes():
    """WrongParam / Failed / HasNoData semantics of the C API."""
    blob = golden.blob("california_400_400_1_float.lerc2")
    info = oracle.blob_info(blob)
    n = info["nDepth"] * info["nCols"] * info["nRows"] * info["nBands"]
    data = np.zeros(n, np.float32)
    masks = np.zeros(info["nCols"] * info["nRows"], np.uint8)
    # bad params
    assert cs_sim.lerc_getBlobInfo(None, 1, np.zeros(11, np.int64), None, 11, 0) == cs_sim.WRONG_PARAM
    assert cs_sim.lerc_getBlobInfo(blob, len(blob), None, None, 0, 0) == cs_sim.WRONG_PARAM
    assert cs_sim.lerc_decode(blob, len(blob), 2, masks, info["nDepth"],
                              info["nCols"], info["nRows"], 1, 6, data) == cs_sim.WRONG_PARAM
    # nMasks smaller than the blob's mask count
    if info["nMasks"] > 0:
        assert cs_sim.lerc_decode(blob, len(blob), 0, None, info["nDepth"],
                                  info["nCols"], info["nRows"], 1, 6, data) == cs_sim.WRONG_PARAM
    # more bands than present
    assert cs_sim.lerc_decode(blob, len(blob), info["nMasks"], masks, info["nDepth"],
                              info["nCols"], info["nRows"], 5, 6,
                              np.zeros(n * 5, np.float32)) == cs_sim.WRONG_PARAM
    # wrong dtype for the blob
    assert cs_sim.lerc_decode(blob, len(blob), info["nMasks"], masks, info["nDepth"],
                              info["nCols"], info["nRows"], 1, 4,
                              np.zeros(n, np.int32)) == cs_sim.FAILED
    # undersized output
    assert cs_sim.lerc_decode(blob, len(blob), info["nMasks"], masks, info["nDepth"],
                              info["nCols"], info["nRows"], 1, 6,
                              np.zeros(10, np.float32)) == cs_sim.BUFFER_TOO_SMALL
    # hostile blobs fail cleanly
    for bad in [blob[:40], b"garbage" * 5,
                blob[:200] + bytes([blob[200] ^ 0xFF]) + blob[201:]]:
        assert cs_sim.lerc_decode(bad, len(bad), 1, masks, info["nDepth"],
                                  info["nCols"], info["nRows"], 1, 6, data) == cs_sim.FAILED
    assert cs_sim.lerc_getBlobInfo(b"", 0, np.zeros(11, np.int64), None, 11, 0) == cs_sim.WRONG_PARAM


@pytest.mark.parametrize("masked", [False, True])
def test_cs_huffman_delta_s8(masked):
    """int8 DELTA mode exercises the (val - 128) offset inside the chain
    (Lerc2.cpp:2500 `delta = (T)(val - offset)`); caught by the bindings
    soak -- the fixed matrix only ran delta with uint8 (offset 0)."""
    smooth = ((np.cumsum(RNG.integers(-2, 3, size=H * W)) % 200) - 100
              ).astype(np.int8).reshape(H, W)
    m = MASK if masked else None
    check(oracle.encode(smooth * MASK.astype(np.int8) if masked else smooth,
                        1, W, H, 1, m, 0.0))


def test_cs_huffman_delta_s8_depth3():
    d3 = (((np.cumsum(RNG.integers(-1, 2, (H, W, 3)), axis=1)) % 150) - 75
          ).astype(np.int8)
    check(oracle.encode(d3, 3, W, H, 1, None, 0.0))


# ---------------------------------------------------------------------------
# C# ENCODER (LercEncode.cs via its statement-exact twin cs_sim.encode):
# every blob the twin produces must decode through BOTH the reference C++
# oracle and our own managed-decoder twin
# ---------------------------------------------------------------------------

def test_cs_encode_twin_pin():
    cs_sim.check_encode_in_sync()


def _twin_roundtrip(arr, nd, nb, mt, pm, mze):
    h, w = (arr.shape[1], arr.shape[2]) if arr.ndim == 4 else (arr.shape[0], arr.shape[1])
    flat = np.ascontiguousarray(arr).reshape(-1)
    blob = cs_sim.encode(flat, nd, w, h, nb, mt,
                         mze, None if pm is None else pm.reshape(-1))
    dec = oracle.decode(blob)
    got = dec[0].astype(np.float64).reshape(nb, h, w, nd)
    src = flat.astype(np.float64).reshape(nb, h, w, nd)
    # per-band validity matrix [nb, h, w] regardless of maskType
    if pm is None:
        bm = np.ones((nb, h, w), bool)
    elif mt == cs_sim.MASK_UNIQUE_PER_BAND:
        bm = pm.reshape(nb, h, w).astype(bool)
    else:
        bm = np.broadcast_to(pm.reshape(h, w).astype(bool), (nb, h, w))
    if pm is not None:
        assert dec[1] is not None
        gm = np.asarray(dec[1]).reshape(-1, h, w).astype(bool)
        assert all(np.array_equal(gm[min(b, gm.shape[0] - 1)], bm[b])
                   for b in range(nb))
    if arr.dtype.kind == "f":
        tol = 0.0 if mze == 0 else mze * 1.01
    else:
        tol = 0.0 if mze <= 0.5 else np.floor(mze)
    err = max((np.abs(got[b][bm[b]] - src[b][bm[b]]).max()
               for b in range(nb) if bm[b].any()), default=0.0)
    assert err <= tol, (err, tol)
    # the managed-decoder twin agrees with the oracle on our own bytes
    n_masks = 0 if mt == cs_sim.MASK_ALL_VALID else (1 if mt == cs_sim.MASK_SAME_FOR_ALL_BANDS else nb)
    data_out = np.zeros(nb * h * w * nd, np.float64)
    valid = np.zeros(max(1, n_masks) * h * w, np.uint8)
    rc = cs_sim.lerc_decodeToDouble(blob, len(blob), n_masks, valid,
                                    nd, w, h, nb, data_out)
    assert rc == cs_sim.OK
    got2 = data_out.reshape(nb, h, w, nd)
    for b in range(nb):
        assert np.array_equal(got2[b][bm[b]], got[b][bm[b]])
    return blob


@pytest.mark.parametrize("np_dt,mze", [
    (np.uint8, 0.0), (np.uint8, 1.0), (np.int8, 0.0), (np.int16, 2.0),
    (np.uint16, 0.0), (np.int32, 4.0), (np.uint32, 0.0),
    (np.float32, 0.001), (np.float32, 0.0), (np.float64, 0.001),
])
@pytest.mark.parametrize("masked", [False, True])
def test_cs_encode_matrix(np_dt, mze, masked):
    h, w = 37, 53
    if np.dtype(np_dt).kind == "f":
        arr = (RNG.random((1, h, w, 1)) * 500 - 100).astype(np_dt)
    else:
        info = np.iinfo(np_dt)
        arr = RNG.integers(max(info.min, -1000), min(info.max, 4000),
                           (1, h, w, 1)).astype(np_dt)
    pm = None
    mt = cs_sim.MASK_ALL_VALID
    if masked:
        pm = (RNG.random((h, w)) > 0.15).astype(np.uint8)
        mt = cs_sim.MASK_SAME_FOR_ALL_BANDS
    _twin_roundtrip(arr, 1, 1, mt, pm, mze)


def test_cs_encode_multiband_depth():
    arr = RNG.integers(-500, 3000, (3, 24, 40, 2)).astype(np.int16)
    _twin_roundtrip(arr, 2, 3, cs_sim.MASK_ALL_VALID, None, 0.0)
    pm = np.stack([(RNG.random((24, 40)) > 0.2).astype(np.uint8)
                   for _ in range(3)])
    _twin_roundtrip(arr, 2, 3, cs_sim.MASK_UNIQUE_PER_BAND, pm, 2.0)


def test_cs_encode_huffman_and_onesweep():
    h, w = 67, 83
    smooth = (np.cumsum(RNG.integers(-2, 3, size=h * w)) % 200
              ).astype(np.uint8).reshape(1, h, w, 1)
    blob = _twin_roundtrip(smooth, 1, 1, cs_sim.MASK_ALL_VALID, None, 0.0)
    assert len(blob) < h * w  # Huffman actually engaged
    noisy = RNG.integers(0, 2**31 - 1, (1, 16, 16, 1)).astype(np.int32)
    _twin_roundtrip(noisy, 1, 1, cs_sim.MASK_ALL_VALID, None, 0.0)  # one-sweep/raw


def test_cs_encode_const_and_empty():
    arr = np.full((1, 20, 30, 1), 7.25, np.float32)
    _twin_roundtrip(arr, 1, 1, cs_sim.MASK_ALL_VALID, None, 0.01)
    pm = np.zeros((20, 30), np.uint8)
    flat = arr.reshape(-1)
    blob = cs_sim.encode(flat, 1, 30, 20, 1, cs_sim.MASK_SAME_FOR_ALL_BANDS,
                         0.01, pm.reshape(-1))
    dec = oracle.decode(blob)  # all-invalid must still be a valid blob
    assert not np.asarray(dec[1]).any()


def test_cs_encode_vectors_match_generator():
    """The shipped encode vectors (CI's byte-compare source for the real
    CLR) stay decodable by the oracle and honest to their inputs."""
    import base64
    import json

    vec_path = pathlib.Path(__file__).resolve().parents[1] / "bindings" / "js" / "test" / "encode_vectors.json"
    if not vec_path.exists():
        pytest.skip("encode vectors not generated")
    for vec in json.loads(vec_path.read_text()):
        blob = base64.b64decode(vec["expected_blob"])
        dec = oracle.decode(blob)
        np_dt = [np.int8, np.uint8, np.int16, np.uint16, np.int32,
                 np.uint32, np.float32, np.float64][vec["dtype"]]
        flat = np.frombuffer(base64.b64decode(vec["raster"]), np_dt)
        nb, h, w, nd = (vec["nBands"], vec["nRows"], vec["nCols"], vec["nDepth"])
        src = flat.astype(np.float64).reshape(nb, h, w, nd)
        got = dec[0].astype(np.float64).reshape(nb, h, w, nd)
        m = (np.ones((h, w), bool) if vec["masks"] is None else
             np.frombuffer(base64.b64decode(vec["masks"]), np.uint8)[:h * w]
             .reshape(h, w).astype(bool))
        mze = vec["maxZErr"]
        tol = (0.0 if mze <= 0.5 else np.floor(mze)) if vec["dtype"] <= 5 else mze * 1.01
        assert np.abs(got[:, m] - src[:, m]).max() <= tol, vec["name"]
