"""JS-binding conformance: runs the operator-exact Python simulation of
bindings/js/lerc.js (bindings/js/js_sim.py) over the same vector matrix the
browser harness uses, cross-checked against the reference C++ library. A
logic error in the JS decoder's algorithms fails here; the one-click
harness (bindings/js/test/harness.html) covers real-JS execution."""
import pathlib
import sys

import numpy as np
import pytest

from . import golden, oracle

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "bindings" / "js"))
import js_sim  # noqa: E402

# Sim-drift tripwire: an edit to lerc.js without a
# matching js_sim.py edit must fail here, at collection, BEFORE any decode
# runs -- otherwise the "statement-exact twin" premise silently rots.
js_sim.check_binding_in_sync()

pytestmark = pytest.mark.skipif(not oracle.available(), reason="reference lib not built")

H, W = 67, 83
RNG = np.random.default_rng(42)
X, Y = np.meshgrid(np.linspace(0, 9, W), np.linspace(0, 7, H))
DEM = (np.sin(X) * np.cos(Y) * 500 + X * Y).astype(np.float64)
MASK = (RNG.random((H, W)) > 0.3).astype(np.uint8)


def check(blob):
    info = oracle.blob_info(blob)
    data, masks, _, _ = oracle.decode(blob, info)
    got = js_sim.decode(blob, {"returnInterleaved": True})
    if info["nDepth"] > 1:
        # default layout is band-sequential (reference Lerc.ts:416-441):
        # cross-check the BSQ reorder against the interleaved wire order
        bsq = js_sim.decode(blob)
        npx = info["nCols"] * info["nRows"]
        for b in range(info["nBands"]):
            bip = np.asarray(got["pixels"][b]).reshape(npx, info["nDepth"])
            np.testing.assert_array_equal(
                np.asarray(bsq["pixels"][b]).reshape(info["nDepth"], npx),
                bip.T)
    assert got["width"] == info["nCols"] and got["height"] == info["nRows"]
    assert len(got["pixels"]) == info["nBands"]
    n_masks = info["nMasks"]
    for b in range(info["nBands"]):
        exp = np.ascontiguousarray(data[b]).reshape(-1)
        gp = np.asarray(got["pixels"][b])
        assert gp.dtype == exp.dtype, (gp.dtype, exp.dtype)
        if n_masks > 0:
            m = masks[min(b, n_masks - 1)].reshape(-1).astype(bool)
            md = np.repeat(m, info["nDepth"])
            np.testing.assert_array_equal(gp[md], exp[md])
            gm = (got["bandMasks"][b] if got["bandMasks"] is not None
                  else got["mask"])
            assert gm is not None
            np.testing.assert_array_equal(np.asarray(gm).astype(bool), m)
        else:
            np.testing.assert_array_equal(gp, exp)


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "uint16",
                                   "int32", "uint32", "float32", "float64"])
@pytest.mark.parametrize("masked", [False, True])
def test_js_tiling(dtype, masked):
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
def test_js_versions(version):
    check(oracle.encode(DEM.astype(np.float32), 1, W, H, 1, None, 0.01,
                        version=version))


def test_js_lut():
    seg = ((np.floor(X * 2) + np.floor(Y * 3)) * 10).astype(np.float32)
    check(oracle.encode(seg, 1, W, H, 1, None, 0.5))


@pytest.mark.parametrize("masked", [False, True])
def test_js_huffman_delta(masked):
    smooth = (np.cumsum(RNG.integers(-2, 3, size=H * W)).astype(np.int64) % 200
              ).astype(np.uint8).reshape(H, W)
    m = MASK if masked else None
    check(oracle.encode(smooth * MASK if masked else smooth, 1, W, H, 1, m, 0.0))


def test_js_huffman_direct_s8():
    noisy = RNG.choice(np.arange(-5, 6, dtype=np.int8), size=(H, W),
                       p=np.r_[np.full(5, 0.02), 0.8, np.full(5, 0.02)])
    check(oracle.encode(noisy, 1, W, H, 1, None, 0.0))


@pytest.mark.parametrize("masked", [False, True])
def test_js_huffman_depth3(masked):
    d3 = (np.cumsum(RNG.integers(-1, 2, (H, W, 3)), axis=1) % 150).astype(np.uint8)
    m = MASK if masked else None
    check(oracle.encode(d3 * MASK[:, :, None] if masked else d3, 3, W, H, 1, m, 0.0))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_js_fpl(dtype):
    check(oracle.encode((DEM * np.pi).astype(dtype), 1, W, H, 1, None, 0.0))


def test_js_fpl_depth3():
    f32 = DEM.astype(np.float32)
    f3 = np.ascontiguousarray(np.stack([f32, f32 * 0.5 + 3, f32 * -0.25], -1))
    check(oracle.encode(f3, 3, W, H, 1, None, 0.0))


def test_js_tiling_depth3():
    f32 = DEM.astype(np.float32)
    f3 = np.ascontiguousarray(np.stack([f32, f32 * 0.5 + 3, f32 * -0.25], -1))
    check(oracle.encode(f3, 3, W, H, 1, None, 0.01))


def test_js_const_and_all_invalid():
    check(oracle.encode(np.full((H, W), 7.25, np.float32), 1, W, H, 1, None, 0.01))
    check(oracle.encode(np.zeros((H, W), np.float32), 1, W, H, 1,
                        np.zeros((H, W), np.uint8), 0.01))


def test_js_multiband():
    f32 = DEM.astype(np.float32)
    b3 = np.ascontiguousarray(np.stack([f32, f32 * 2 + 5, f32 * -1], 0))
    check(oracle.encode(b3, 1, W, H, 3, None, 0.01))
    masks3 = np.stack([MASK, (RNG.random((H, W)) > 0.5).astype(np.uint8),
                       np.ones((H, W), np.uint8)], 0)
    check(oracle.encode(b3 * masks3.astype(np.float32), 1, W, H, 3, masks3, 0.01))


def test_js_nodata():
    nd = DEM.astype(np.float32)
    nd[::7, ::5] = -9999.0
    check(oracle.encode(nd, 1, W, H, 1, None, 0.01,
                        uses_nodata=np.array([1], np.uint8),
                        nodata=np.array([-9999.0], np.float64)))


def test_js_golden_blobs():
    check(golden.blob("california_400_400_1_float.lerc2"))
    check(golden.blob("bluemarble_256_256_3_byte.lerc2"))
    check(golden.blob("world.lerc1"))


def test_js_hostile():
    blob = golden.blob("california_400_400_1_float.lerc2")
    for bad in [blob[:40], b"garbage" * 5, b"",
                blob[:200] + bytes([blob[200] ^ 0xFF]) + blob[201:]]:
        with pytest.raises(js_sim.LercError):
            js_sim.decode(bad)


def test_js_nodata_fill_option():
    """options.noDataValue fills invalid pixels (reference Lerc.ts:509-529)."""
    f32 = DEM.astype(np.float32) * MASK
    blob = oracle.encode(f32, 1, W, H, 1, MASK, 0.01)
    got = js_sim.decode(blob, {"noDataValue": -1.5})
    px = np.asarray(got["pixels"][0]).reshape(H, W)
    m = MASK.astype(bool)
    assert np.all(px[~m] == np.float32(-1.5))


def test_js_get_blob_info_statistics():
    """getBlobInfo's per-band statistics come from the ranges sections
    (the lerc_getDataRanges analog), cross-checked against the reference's
    lerc_getDataRanges on a 3-band, depth-3 blob."""
    f32 = DEM.astype(np.float32)
    f3 = np.ascontiguousarray(np.stack([f32, f32 * 0.5 + 3, f32 * -0.25], -1))
    b3 = np.ascontiguousarray(np.stack([f3, f3 * 2 + 5, f3 * -1], 0))
    blob = oracle.encode(b3, 3, W, H, 3, None, 0.01)
    info = js_sim.get_blob_info(blob)
    mins, maxs = oracle.data_ranges(blob, 3, 3)
    mins = mins.reshape(3, 3)
    maxs = maxs.reshape(3, 3)
    assert info["bandCount"] == 3
    for b in range(3):
        st = info["statistics"][b]
        np.testing.assert_allclose(st["depthStats"]["minValues"], mins[b], rtol=0)
        np.testing.assert_allclose(st["depthStats"]["maxValues"], maxs[b], rtol=0)
        assert st["minValue"] == mins[b].min() and st["maxValue"] == maxs[b].max()


@pytest.mark.parametrize("masked", [False, True])
def test_js_huffman_delta_s8(masked):
    """int8 DELTA mode exercises the (val - 128) offset inside the chain
    (Lerc2.cpp:2500 `delta = (T)(val - offset)`); caught by the bindings
    soak -- the fixed matrix only ran delta with uint8 (offset 0)."""
    smooth = ((np.cumsum(RNG.integers(-2, 3, size=H * W)) % 200) - 100
              ).astype(np.int8).reshape(H, W)
    m = MASK if masked else None
    check(oracle.encode(smooth * MASK.astype(np.int8) if masked else smooth,
                        1, W, H, 1, m, 0.0))


def test_js_huffman_delta_s8_depth3():
    d3 = (((np.cumsum(RNG.integers(-1, 2, (H, W, 3)), axis=1)) % 150) - 75
          ).astype(np.int8)
    check(oracle.encode(d3, 3, W, H, 1, None, 0.0))


def test_bindings_soak_short():
    """A bounded slice of tools/soak_bindings.py (the randomized binding
    differential soak that caught the s8 delta-offset bug); deeper runs
    are manual with a larger seconds budget."""
    import pathlib
    import subprocess
    import sys as _sys

    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [_sys.executable, str(root / "tools" / "soak_bindings.py"), "11", "40"],
        capture_output=True, text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "soak PASS" in out.stdout


def test_bindings_decode_our_blobs():
    """The JS and C# binding decoders must accept blobs produced by OUR
    device encoder (its wire choices -- Huffman tables, LUT tie-breaks,
    predictor picks -- differ from the reference's); cross-checked against
    the reference decoder on the same blobs."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "bindings" / "csharp"))
    import cs_sim

    from lerc_tpu.codec.device_codec import encode_band_device

    rng = np.random.default_rng(5)
    x, y = np.meshgrid(np.linspace(0, 5, 56), np.linspace(0, 4, 48))
    f = (np.sin(x) * np.cos(y) * 100 + rng.normal(0, 1, (48, 56))).astype(np.float32)
    m = rng.random((48, 56)) > 0.3
    seg = (np.floor(x * 2) + np.floor(y * 3)).astype(np.float32) * 10
    u8img = (np.cumsum(rng.integers(-2, 3, (48, 56)), axis=1) % 200).astype(np.uint8)
    s8img = ((np.cumsum(rng.integers(-2, 3, (48, 56)), axis=1) % 200) - 100
             ).astype(np.int8)
    blobs = [
        encode_band_device(f[:, :, None].copy(), None, 0.01),       # tiling
        encode_band_device(f[:, :, None].copy(), m, 0.01),          # masked
        encode_band_device(seg[:, :, None].copy(), None, 0.5),      # LUT-ish
        encode_band_device(u8img[:, :, None].copy(), None, 0.5),    # huffman
        encode_band_device((u8img * m)[:, :, None].copy(), m, 0.5), # masked huffman
        encode_band_device(s8img[:, :, None].copy(), None, 0.5),    # s8 delta
        encode_band_device(f[:, :, None].copy(), None, 0.0),        # fpl f32
        encode_band_device(f.astype(np.float64)[:, :, None].copy(), None, 0.0),  # fpl f64
    ]
    for i, blob in enumerate(blobs):
        info = oracle.blob_info(blob)
        ref, masks, _, _ = oracle.decode(blob, info)
        n_masks, d = info["nMasks"], info["nDepth"]
        got = js_sim.decode(blob, {"returnInterleaved": True})
        data = np.zeros(info["nRows"] * info["nCols"] * d,
                        [np.int8, np.uint8, np.int16, np.uint16, np.int32,
                         np.uint32, np.float32, np.float64][info["dataType"]])
        pv = np.zeros(max(n_masks, 1) * info["nRows"] * info["nCols"], np.uint8)
        rc = cs_sim.lerc_decode(blob, len(blob), n_masks,
                                pv if n_masks else None, d, info["nCols"],
                                info["nRows"], 1, info["dataType"], data)
        assert rc == 0, (i, rc)
        exp = np.ascontiguousarray(ref[0]).reshape(-1)
        gp = np.asarray(got["pixels"][0])
        gc = data
        if n_masks:
            mm = np.repeat(masks[0].reshape(-1).astype(bool), d)
            np.testing.assert_array_equal(gp[mm], exp[mm], err_msg=f"js blob {i}")
            np.testing.assert_array_equal(gc[mm], exp[mm], err_msg=f"cs blob {i}")
        else:
            np.testing.assert_array_equal(gp, exp, err_msg=f"js blob {i}")
            np.testing.assert_array_equal(gc, exp, err_msg=f"cs blob {i}")
