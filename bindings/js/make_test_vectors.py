"""Generate the JS-decoder conformance vectors (run from the repo root).

Each vector is a LERC blob (reference-encoded via tests/oracle.py, our own
encoder, and the golden files) with the expected decode result, serialized
base64 into test/vectors.js for the browser harness (test/harness.html).
Expected pixels/masks come from the reference C++ library, so the JS decoder
is held to the same oracle as the Python host and device paths."""
import base64
import json
import os
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from tests import oracle  # noqa: E402
from lerc_tpu import api  # noqa: E402


def b64(x) -> str:
    return base64.b64encode(bytes(x)).decode()


def expected_from_oracle(blob: bytes):
    info = oracle.blob_info(blob)
    data, masks, uses, nodata = oracle.decode(blob, info)
    n_bands, n_masks = info["nBands"], info["nMasks"]
    exp = {
        "width": info["nCols"], "height": info["nRows"],
        "depth": info["nDepth"], "bands": n_bands, "dtype": info["dataType"],
        "pixels": [b64(np.ascontiguousarray(data[b]).tobytes()) for b in range(n_bands)],
        "masks": None,
    }
    if n_masks > 0:
        exp["masks"] = [b64(masks[min(b, n_masks - 1)].astype(np.uint8).tobytes())
                        for b in range(n_bands)]
    return exp


def main():
    rng = np.random.default_rng(42)
    vectors = []

    def add(name, blob):
        vectors.append({"name": name, "blob": b64(blob),
                        "expected": expected_from_oracle(blob)})

    h, w = 67, 83  # partial edge blocks
    x, y = np.meshgrid(np.linspace(0, 9, w), np.linspace(0, 7, h))
    dem = (np.sin(x) * np.cos(y) * 500 + x * y).astype(np.float64)
    mask = (rng.random((h, w)) > 0.3).astype(np.uint8)

    # tiling across dtypes, lossy + lossless, masked + unmasked
    for arr in [
        np.round(dem / 8).astype(np.int8),
        np.clip(np.round(dem / 4) + 128, 0, 255).astype(np.uint8),
        np.round(dem * 30).astype(np.int16),
        np.clip(np.round(dem * 30) + 20000, 0, 65535).astype(np.uint16),
        np.round(dem * 1000).astype(np.int32),
        (np.round(dem * 1000) + 600000).astype(np.uint32),
        dem.astype(np.float32),
        dem,
    ]:
        mze = 1.0 if arr.dtype.kind in "iu" and arr.dtype.itemsize == 1 else (
            0.0 if arr.dtype.kind in "iu" else 0.01)
        add(f"tiling-{arr.dtype.name}", oracle.encode(arr, 1, w, h, 1, None, mze))
        add(f"tiling-{arr.dtype.name}-masked",
            oracle.encode(arr * mask.astype(arr.dtype), 1, w, h, 1, mask, mze))

    # versions 2..6 (f32 lossy)
    f32 = dem.astype(np.float32)
    for v in (2, 3, 4, 5, 6):
        add(f"tiling-f32-v{v}", oracle.encode(f32, 1, w, h, 1, None, 0.01, version=v))

    # LUT-friendly segmented image
    seg = ((np.floor(x * 2) + np.floor(y * 3)) * 10).astype(np.float32)
    add("lut-f32", oracle.encode(seg, 1, w, h, 1, None, 0.5))

    # whole-image Huffman: delta + direct, masked + unmasked, depth 3
    smooth = (np.cumsum(rng.integers(-2, 3, size=h * w)).astype(np.int64) % 200
              ).astype(np.uint8).reshape(h, w)
    add("huffman-delta-u8", oracle.encode(smooth, 1, w, h, 1, None, 0.0))
    add("huffman-delta-u8-masked",
        oracle.encode(smooth * mask, 1, w, h, 1, mask, 0.0))
    noisy8 = rng.choice(np.arange(-5, 6, dtype=np.int8), size=(h, w),
                        p=np.r_[np.full(5, 0.02), 0.8, np.full(5, 0.02)])
    add("huffman-direct-s8", oracle.encode(noisy8, 1, w, h, 1, None, 0.0))
    # int8 DELTA mode: the chain subtracts the 128 offset per step
    # (Lerc2.cpp delta = (T)(val - offset)); regression for the soak find
    smooth_s8 = ((np.cumsum(rng.integers(-2, 3, size=h * w)) % 200) - 100
                 ).astype(np.int8).reshape(h, w)
    add("huffman-delta-s8", oracle.encode(smooth_s8, 1, w, h, 1, None, 0.0))
    add("huffman-delta-s8-masked",
        oracle.encode(smooth_s8 * mask.astype(np.int8), 1, w, h, 1, mask, 0.0))
    d3 = (np.cumsum(rng.integers(-1, 2, (h, w, 3)), axis=1) % 150).astype(np.uint8)
    add("huffman-u8-depth3", oracle.encode(d3, 3, w, h, 1, None, 0.0))
    add("huffman-u8-depth3-masked",
        oracle.encode(d3 * mask[:, :, None], 3, w, h, 1, mask, 0.0))

    # fpl lossless float/double, depth 1 + 3
    add("fpl-f32", oracle.encode(f32, 1, w, h, 1, None, 0.0))
    add("fpl-f64", oracle.encode(dem * np.pi, 1, w, h, 1, None, 0.0))
    f3 = np.stack([f32, f32 * 0.5 + 3, f32 * -0.25], axis=-1)
    add("fpl-f32-depth3", oracle.encode(np.ascontiguousarray(f3), 3, w, h, 1, None, 0.0))

    # depth 3 lossy tiling (zMin/zMax vectors + depth loop)
    add("tiling-f32-depth3", oracle.encode(np.ascontiguousarray(f3), 3, w, h, 1, None, 0.01))

    # const image + all-invalid mask
    add("const-f32", oracle.encode(np.full((h, w), 7.25, np.float32), 1, w, h, 1, None, 0.01))
    add("all-invalid", oracle.encode(np.zeros((h, w), np.float32), 1, w, h, 1,
                                     np.zeros((h, w), np.uint8), 0.01))

    # multiband (3 bands, shared + per-band masks)
    b3 = np.ascontiguousarray(np.stack([f32, f32 * 2 + 5, f32 * -1], axis=0))
    add("bands3-f32", oracle.encode(b3, 1, w, h, 3, None, 0.01))
    masks3 = np.stack([mask, (rng.random((h, w)) > 0.5).astype(np.uint8),
                       np.ones((h, w), np.uint8)], axis=0)
    add("bands3-f32-masks",
        oracle.encode(b3 * masks3.astype(np.float32), 1, w, h, 3, masks3, 0.01))

    # noData pass-through (v6)
    nd = f32.copy()
    nd[::7, ::5] = -9999.0
    add("nodata-f32", oracle.encode(nd, 1, w, h, 1, None, 0.01,
                                    uses_nodata=np.array([1], np.uint8),
                                    nodata=np.array([-9999.0], np.float64)))

    # our own encoder's wire (device/host paths), decoded by the reference
    rv = api.encode(f32, 1, False, None, 0.01, 0)
    assert rv[0] == 0
    rv = api.encode(f32, 1, False, None, 0.01, rv[1])
    add("ours-f32", bytes(rv[2]))
    rv = api.encode(smooth, 1, True, mask.astype(bool), 0.0, 1 << 20)
    assert rv[0] == 0
    add("ours-huffman-masked", bytes(rv[2]))

    # golden blobs (reference checkout location overridable for CI)
    td = pathlib.Path(os.environ.get("LERC_REFERENCE_DIR",
                                     "/root/reference")) / "testData"
    add("golden-california", (td / "california_400_400_1_float.lerc2").read_bytes())
    add("golden-bluemarble", (td / "bluemarble_256_256_3_byte.lerc2").read_bytes())
    add("golden-world-lerc1", (td / "world.lerc1").read_bytes())

    # generated Lerc1 corpus (tests/lerc1_writer.py, oracle-certified wire):
    # widens the real-runtime Lerc1 coverage beyond the one golden blob
    # -- masked RLE cnt, tiled cnt, multi-band
    from tests.lerc1_writer import encode_lerc1
    l1 = dem.astype(np.float32)
    add("lerc1-gen-f32", encode_lerc1(l1, None, 0.01, seed=1))
    add("lerc1-gen-masked", encode_lerc1(l1, mask.astype(bool), 0.1,
                                         cnt_style="rle", seed=2))
    add("lerc1-gen-tiledcnt", encode_lerc1(l1, mask.astype(bool), 0.5,
                                           cnt_style="tiled", grid=(9, 11), seed=3))
    add("lerc1-gen-bands3", encode_lerc1([l1, l1 * 0.5 + 3, l1 * -2],
                                         mask.astype(bool), 0.01, seed=4))
    add("lerc1-gen-lossless", encode_lerc1(l1, None, 0.0, grid=(4, 4), seed=5))

    payload = json.dumps(vectors)
    outdir = pathlib.Path(__file__).parent / "test"
    outdir.mkdir(exist_ok=True)
    out = outdir / "vectors.js"
    out.write_text("window.VECTORS = " + payload + ";\n")
    # plain JSON twin: consumed by the node runner (run_node.mjs) and the
    # C# TestRunner -- same vectors, no browser wrapper
    (outdir / "vectors.json").write_text(payload + "\n")
    n_enc = write_encode_vectors(outdir, rng)
    print(f"wrote {len(vectors)} vectors to {out} ({out.stat().st_size} bytes)"
          f" + vectors.json + {n_enc} encode vectors")


def write_encode_vectors(outdir: pathlib.Path, rng) -> int:
    """C# ENCODER conformance vectors (encode_vectors.json): inputs plus
    the blob the statement-exact twin (bindings/csharp/cs_sim.py) produces.
    The dotnet TestRunner re-encodes each input with LercEncode.cs and
    byte-compares -- any C#/twin divergence fails CI -- then decodes its
    own blob with LercDecode.cs; tests/test_cs_binding.py separately
    round-trips the SAME twin blobs through the reference C++ oracle, so
    byte equality transitively certifies the real C# output as
    reference-decodable."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "csharp"))
    import cs_sim

    h, w = 43, 57
    x, y = np.meshgrid(np.linspace(0, 9, w), np.linspace(0, 7, h))
    dem = np.sin(x) * np.cos(y) * 500 + x * y
    mask = (rng.random((h, w)) > 0.2).astype(np.uint8)
    smooth = (np.cumsum(rng.integers(-2, 3, size=h * w)) % 200).astype(np.uint8).reshape(h, w)

    cases = [
        ("enc-f32-lossy", dem.astype(np.float32), 1, 1, cs_sim.MASK_ALL_VALID, None, 0.01),
        ("enc-f32-masked", dem.astype(np.float32), 1, 1,
         cs_sim.MASK_SAME_FOR_ALL_BANDS, mask, 0.01),
        ("enc-u8-huffman", smooth, 1, 1, cs_sim.MASK_ALL_VALID, None, 0.0),
        ("enc-s16-lossless", np.round(dem * 30).astype(np.int16), 1, 1,
         cs_sim.MASK_ALL_VALID, None, 0.0),
        ("enc-f64-lossy", dem, 1, 1, cs_sim.MASK_SAME_FOR_ALL_BANDS, mask, 0.001),
        ("enc-i32-bands2", np.stack([np.round(dem * 100).astype(np.int32),
                                     np.round(dem * -50).astype(np.int32)]),
         1, 2, cs_sim.MASK_ALL_VALID, None, 2.0),
    ]
    out = []
    for name, arr, nd, nb, mt, pm, mze in cases:
        flat = np.ascontiguousarray(arr).reshape(-1)
        pm_flat = None if pm is None else pm.reshape(-1)
        blob = cs_sim.encode(flat, nd, w, h, nb, mt, mze, pm_flat)
        out.append({
            "name": name, "dtype": int(cs_sim._enc_dt_of(flat.dtype)),
            "nDepth": nd, "nCols": w, "nRows": h, "nBands": nb,
            "maskType": mt, "maxZErr": mze,
            "raster": b64(flat.tobytes()),
            "masks": None if pm_flat is None else b64(pm_flat.tobytes()),
            "expected_blob": b64(blob),
        })
    (outdir / "encode_vectors.json").write_text(json.dumps(out) + "\n")
    return len(out)


if __name__ == "__main__":
    main()
