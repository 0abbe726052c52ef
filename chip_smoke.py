#!/usr/bin/env python
"""Bring-up check: the LERC codec's device path on a GPU, at real sizes.

    python chip_smoke.py          # one GPU: phases 1-7
    python chip_smoke.py --four   # four GPUs: the mesh mosaic and its references
    JAX_PLATFORMS=cpu python chip_smoke.py --rehearse   # CPU rehearsal, reduced sizes

Phases (one GPU):
  1. device: platform, kind, count; the card's name and power limit
  2. compile: FusedResidentCodec at tile size for both kernel families
     (nb_cap 0 and 16), all-valid and masked; compile seconds and
     memory_analysis() of every encode and decode executable
  3. served path: api.encode -> api.decode of an f32 DEM (all-valid, ~8%
     masked, NaN inside the mask) on the device route, against the host codec
  4. resident path: FusedResidentCodec tiles built on the device; the wire
     blob decoded by the host codec equals the device decode
  5. every other device kernel family once: 8-bit Huffman, fpl f32/f64,
     f64 lossy, u16 nDepth 8 (depth-diff), LUT and 16x16 records
  6. blobs from other writers: bindings/js/test/vectors.json
  7. first timings (a bring-up reading, not a benchmark)

The reference for every comparison is the repo's exact-f64 host codec
(set_acceleration(False)). Every phase prints one line with its result, its
tolerance and its compile seconds; any failure exits non-zero without the
final line, which is exactly
  {"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}
A run that finds no GPU fails unless --rehearse was given with
JAX_PLATFORMS=cpu; every line of a rehearsal names platform cpu.
"""
from __future__ import annotations

import argparse
import base64
import contextlib
import dataclasses
import hashlib
import json
import os
import sys
import time
import traceback

import numpy as np

import chip_env

MZE = 0.001  # the BASELINE elevation config's maxZError


@dataclasses.dataclass(frozen=True)
class Sizes:
    dem: int        # served-path DEM side (phase 3)
    tile: int       # resident tile side (phases 2, 4)
    kernel: int     # kernel-family side (phase 5)
    n_tiles: int    # resident tiles (phase 4)
    mosaic: int     # mosaic side (--four)
    mosaic_tile: int


REAL = Sizes(dem=4096, tile=2048, kernel=2048, n_tiles=4, mosaic=16384, mosaic_tile=2048)
# 512^2 is the smallest band the API routes to the device (1 << 18 pixels)
REHEARSAL = Sizes(dem=512, tile=128, kernel=512, n_tiles=2, mosaic=256, mosaic_tile=64)


# ---------------------------------------------------------------------------
# data (seeded; host numpy unless a phase says otherwise)
# ---------------------------------------------------------------------------

def make_dem(n: int, seed: int = 0) -> np.ndarray:
    """Synthetic f32 elevation: a smooth massif, ridges and +-0.5 noise."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 20, n, dtype=np.float32)[None, :]
    y = np.linspace(0, 15, n, dtype=np.float32)[:, None]
    dem = 1500 * np.exp(-((x - 10) ** 2 + (y - 7) ** 2) / 20)
    dem += 50 * np.sin(x) * np.cos(y)
    dem += rng.random((n, n), dtype=np.float32) - 0.5
    return dem.astype(np.float32)


def make_mask(n: int, seed: int = 1, speckle: float = 0.02) -> np.ndarray:
    """A rectangular nodata hole (6%) plus `speckle` scattered invalid
    pixels: ~8% invalid by default."""
    rng = np.random.default_rng(seed)
    mask = np.ones((n, n), bool)
    mask[n * 300 // 2048 : n * 800 // 2048, n * 500 // 2048 : n * 1000 // 2048] = False
    mask[rng.random((n, n)) < speckle] = False
    return mask


def make_device_tiles(n: int, count: int):
    """[count, n, n, 1] f32 DEM tiles generated on the device, at the pixel
    pitch of a 2048^2 tile whatever n is (so per-block statistics, and with
    them the kernel family that fits, do not depend on n)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def gen():
        x = (jnp.arange(n, dtype=jnp.float32) * (20 / 2048))[None, :]
        y = (jnp.arange(n, dtype=jnp.float32) * (15 / 2048))[:, None]

        def one(seed):
            i = (jnp.arange(n * n, dtype=jnp.uint32).reshape(n, n)
                 + jnp.uint32((seed * 0x9E3779B9) & 0xFFFFFFFF))
            i = (i ^ (i >> 16)) * jnp.uint32(0x45D9F3B)
            i = (i ^ (i >> 16)) * jnp.uint32(0x45D9F3B)
            i = i ^ (i >> 16)
            noise = i.astype(jnp.float32) * jnp.float32(2**-32) - 0.5
            dem = (1500 * jnp.exp(-((x - 10) ** 2 + (y - 7) ** 2) / 20)
                   + 50 * jnp.sin(x + seed) * jnp.cos(y) + noise)
            return dem.astype(jnp.float32)[:, :, None]

        return jnp.stack([one(s) for s in range(count)])

    return gen()


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def lossy_tol(orig, valid, mze: float) -> float:
    """maxZError plus two units in the last place of the largest valid
    magnitude in the stored type. The reference reconstructs within mze in
    double and then narrows to the stored type; the device encoder also
    quantizes in f32 with a +-1 fix-up, which adds up to ~2 ulp."""
    o = np.asarray(orig)
    top = np.abs(o[valid]).max() if valid.any() else 0
    return mze + 2 * float(np.spacing(o.dtype.type(top)))


def max_err(dec, orig, valid) -> float:
    """Largest |dec - orig| over the valid pixels, in f64."""
    if not valid.any():
        return 0.0
    d = np.asarray(dec)[valid].astype(np.float64)
    return float(np.abs(d - np.asarray(orig)[valid].astype(np.float64)).max())


def check_lossy(name, dec, orig, valid, mze) -> str:
    err, tol = max_err(dec, orig, valid), lossy_tol(orig, valid, mze)
    if not err <= tol:
        raise AssertionError(f"{name}: error {err!r} > {tol!r}")
    return f"err {err:.6g} <= {tol:.6g}"


def assert_bits_equal(a, b, what: str) -> None:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    if a.tobytes() != b.tobytes():
        n = int((a.reshape(-1).view(np.uint8) != b.reshape(-1).view(np.uint8)).sum())
        raise AssertionError(f"{what}: not bit-identical ({n} bytes differ)")


@contextlib.contextmanager
def acceleration(enabled: bool):
    """Force the API's device route on (True) or the host codec (False)."""
    from lerc_tpu.codec import encode_orchestrator as eo

    eo.set_acceleration(enabled)
    try:
        yield
    finally:
        eo.set_acceleration(None)


def routes() -> dict:
    from lerc_tpu.codec.encode_orchestrator import ROUTES

    return {f"{d}_{r}": n for (d, r), n in sorted(ROUTES.items())}


def api_roundtrip(data, n_values, mask, mze, expect_device_bands: int,
                  decode_on_device: bool = True):
    """Encode and decode through lerc_tpu.api on the device route; decode
    the same blob with the host codec. Returns (blob, dev_decode,
    host_decode), each decode being api.decode's (arr, mask)."""
    from lerc_tpu import api
    from lerc_tpu.codec.encode_orchestrator import reset_routes

    reset_routes()
    with acceleration(True):
        rc, nbytes, blob = api.encode(data, n_values, mask is not None, mask,
                                      mze, data.nbytes * 2 + (1 << 20))
        if rc != 0:
            raise AssertionError(f"api.encode returned {rc}")
        dev = api.decode(blob)
    want = {"decode_device" if decode_on_device else "decode_host": expect_device_bands,
            "encode_device": expect_device_bands}
    got = routes()
    if got != want:
        raise AssertionError(f"routing {got}, expected {want}")
    with acceleration(False):
        host = api.decode(blob)
    for out in (dev, host):
        if isinstance(out, int) or out[0] != 0:
            raise AssertionError(f"api.decode failed: {out}")
    assert_bits_equal(dev[1], host[1], "device vs host decode")
    if (dev[2] is None) != (host[2] is None) or (
            dev[2] is not None and not np.array_equal(dev[2], host[2])):
        raise AssertionError("device and host decoded masks differ")
    return blob, dev[1:], host[1:]


class CompileClock:
    """Sums JAX's trace, lowering and backend compile durations."""

    _EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
               "/jax/core/compile/jaxpr_to_mlir_module_duration",
               "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, name, secs, **_kw):
        if name in self._EVENTS:
            self.total += secs


# ---------------------------------------------------------------------------
# phases; each returns the detail of its one-line report
# ---------------------------------------------------------------------------

def phase_compile(n: int, mze: float = MZE) -> str:
    import jax
    import jax.numpy as jnp

    from lerc_tpu.codec.resident import FusedResidentCodec

    spec = jax.ShapeDtypeStruct((n, n, 1), jnp.float32)
    parts = []
    for nb_cap in (0, 16):
        for masked in (False, True):
            codec = FusedResidentCodec(n, n, 1, np.float32, mze, nb_cap=nb_cap,
                                       mask=make_mask(n) if masked else None)
            t0 = time.perf_counter()
            enc = codec._encode_fused.lower(spec).compile()
            t1 = time.perf_counter()
            hdr_s, stream_s, _meta, starts_s = jax.eval_shape(codec._encode_fused, spec)
            dec = codec._decode_fused_fast.lower(hdr_s, stream_s, starts_s).compile()
            t2 = time.perf_counter()
            for what, exe, secs in (("encode", enc, t1 - t0), ("decode", dec, t2 - t1)):
                m = exe.memory_analysis()
                line = (f"    nb_cap={nb_cap:<2} {'masked' if masked else 'valid '} "
                        f"{what}: compile {secs:.1f}s, args {m.argument_size_in_bytes}, "
                        f"out {m.output_size_in_bytes}, temp {m.temp_size_in_bytes}, "
                        f"code {m.generated_code_size_in_bytes} bytes")
                print(line, flush=True)
                parts.append(f"{nb_cap}/{'m' if masked else 'v'}/{what[0]} {secs:.1f}s")
    return "compiled " + ", ".join(parts)


def phase_served(n: int, mze: float = MZE) -> str:
    from lerc_tpu import api

    dem = make_dem(n)
    mask = make_mask(n)
    nan_dem = dem.copy()
    nan_sel = mask & (np.random.default_rng(2).random((n, n)) < 0.01)
    nan_dem[nan_sel] = np.nan
    variants = (("all-valid", dem, None, np.ones((n, n), bool)),
                ("masked", dem, mask, mask),
                ("nan-in-mask", nan_dem, mask, mask & ~nan_sel))
    report = []
    for name, data, mask_in, valid in variants:
        blob, (arr, m_out), _host = api_roundtrip(data, 1, mask_in, mze, 1)
        got_valid = np.ones((n, n), bool) if m_out is None else np.asarray(m_out, bool)
        if not np.array_equal(got_valid, valid):
            raise AssertionError(f"{name}: mask did not round-trip")
        # the same encode again in this process must give the same bytes
        with acceleration(True):
            again = api.encode(data, 1, mask_in is not None, mask_in, mze,
                               data.nbytes * 2 + (1 << 20))[2]
        if again != blob:
            raise AssertionError(f"{name}: a second device encode of the same input "
                                 f"gave other bytes ({len(again)} vs {len(blob)} B)")
        report.append(f"{name} {len(blob)} B (input {digest(data)}, blob {digest(blob)}) "
                      f"{check_lossy(name, arr, dem, valid, mze)}")
    return ("device route 1/1 band each way, masks exact, device==host decode "
            "bit-identical, a second encode byte-identical; " + "; ".join(report)
            + " (tol: maxZError + 2 ulp)")


def digest(x) -> str:
    """Short SHA-256 of an array's or a blob's bytes, to compare runs."""
    return hashlib.sha256(np.ascontiguousarray(x).tobytes() if isinstance(x, np.ndarray)
                          else bytes(x)).hexdigest()[:12]


def phase_resident(n: int, n_tiles: int, mze: float = MZE) -> str:
    from lerc_tpu.codec.orchestrator import decode_blob
    from lerc_tpu.codec.resident import FusedResidentCodec

    tiles = make_device_tiles(n, n_tiles)
    tiles_h = np.asarray(tiles)
    mask = make_mask(n)
    cases = [(0, None), (16, None), (0, mask)]
    checked = 0
    for nb_cap, m in cases:
        codec = FusedResidentCodec(n, n, 1, np.float32, mze, nb_cap=nb_cap, mask=m)
        valid = np.ones((n, n), bool) if m is None else m
        for i in range(n_tiles if m is None else 1):
            header, stream, meta, starts = codec.encode_fast(tiles[i])
            total, _cs, fits = (int(v) for v in np.asarray(meta))
            if not fits:
                raise AssertionError(f"nb_cap={nb_cap}: tile {i} needs wider records")
            img, ok = codec.decode_fast(header, stream, starts)
            if not bool(ok):
                raise AssertionError(f"nb_cap={nb_cap}: device checksum/index check failed")
            blob = codec.blob_to_bytes(header, stream, meta)
            with acceleration(False):
                host = decode_blob(blob)  # verifies Fletcher32 on the host
            if not np.array_equal(host.masks[0], valid):
                raise AssertionError("resident mask did not round-trip")
            assert_bits_equal(np.asarray(img), host.data[0], "resident device vs host decode")
            err = check_lossy("resident", host.data[0][:, :, 0], tiles_h[i][:, :, 0],
                              valid, mze)
            checked += 1
    return (f"{checked} tiles ({n}^2; nb_cap 0 and 16, one masked): Fletcher32 "
            "verified on device and host, host decode of to_bytes() == device "
            f"decode bit-identical; last {err} (tol: maxZError + 2 ulp)")


def _kernel_cases(n: int):
    """(name, data, n_values_per_pixel, mask, maxZError, lossless,
    same_blob) per device kernel family, at tile width n."""
    rng = np.random.default_rng(5)
    x = np.linspace(0, 6, n)[None, :]
    y = np.linspace(0, 4, n)[:, None]
    smooth = 128 + 60 * np.sin(x) * np.cos(y)
    bands = np.stack([np.clip(smooth * (1 - 0.1 * b) + rng.normal(0, 2, (n, n)), 0, 255)
                      for b in range(3)]).astype(np.uint8)
    # imagery nodata is a collar or a few holes, not dense speckle: the
    # device's masked delta-Huffman decode takes <= 65536 row segments
    band_masks = np.stack([make_mask(n, seed=10 + b, speckle=0.0005) for b in range(3)])
    f32 = (1000 + 200 * np.sin(x) * np.cos(y)).astype(np.float32)
    f64 = (1e4 + 500 * np.sin(x) * np.cos(y) + rng.normal(0, 1e-3, (n, n)))
    depth = np.stack([np.round(3000 + 800 * np.sin(x + 0.01 * k) * np.cos(y)
                               + rng.integers(0, 3, (n, n))) for k in range(8)], -1)
    classes = np.array([100, 2000, 35000, 41000, 52000], np.int32)
    patch = rng.integers(0, 5, (n // 16, n // 16))
    lut = (classes[np.repeat(np.repeat(patch, 16, 0), 16, 1)]
           + rng.integers(0, 3, (n, n))).astype(np.int32)
    low_rate = np.full((n, n), 100.0)
    low_rate[:, : 2 * n // 3] += 0.6 * rng.integers(0, 2, (n, 2 * n // 3))
    # the last field: the device blob must equal the host encoder's byte for
    # byte (deterministic families whose choices match the host's)
    return [
        ("huffman-u8x3-masked", bands, 1, band_masks, 0.0, True, True),
        ("fpl-f32", f32, 1, None, 0.0, True, True),
        ("fpl-f64", f64, 1, None, 0.0, True, False),
        ("f64-lossy", f64, 1, None, MZE, False, False),
        ("u16-depth8", depth.astype(np.uint16), 8, None, 0.0, True, False),
        ("lut-i32", lut, 1, None, 0.5, True, True),
        ("16x16-f32", low_rate.astype(np.float32), 1, None, 0.3, False, False),
    ]


def _check_16x16_device_decode(data: np.ndarray, mze: float) -> None:
    """The API decodes 16x16 blobs on the host; the mosaic decoder runs
    them on the device. One-tile mosaic: the tile must choose 16x16 and
    decode on the device bit-identically to the host codec."""
    from lerc_tpu.codec.orchestrator import decode_blob
    from lerc_tpu.parallel import sharding

    n = data.shape[0]
    blob = sharding.MosaicEncoder(sharding.make_mesh(1), n, n, np.float32).encode(
        data[:, :, None], None, mze)
    info, views = sharding.read_mosaic(blob)
    layouts = sharding._tile_band_layouts(views, 1)
    if layouts[0][0][1].micro_block_size != 16:
        raise AssertionError("mosaic tile did not choose 16x16 micro-blocks")
    dev = sharding._decode_tiles_device_batched(info, views, layouts, [0])
    if (0, 0) not in dev:
        raise AssertionError("16x16 tile was not decoded on the device")
    with acceleration(False):
        host = decode_blob(views[0])
    assert_bits_equal(dev[(0, 0)], host.data[0], "16x16 device vs host decode")


def phase_kernels(n: int) -> str:
    from lerc_tpu import api
    from lerc_tpu.codec.orchestrator import get_lerc_info

    report = []
    for name, data, nv, mask, mze, lossless, same_blob in _kernel_cases(n):
        n_bands = data.shape[0] if data.ndim == 3 and nv == 1 else 1
        mb16 = name.startswith("16x16")
        blob, (arr, m_out), _host = api_roundtrip(data, nv, mask, mze, n_bands,
                                                  decode_on_device=not mb16)
        if mb16:
            _check_16x16_device_decode(data, mze)
        valid = (np.ones(data.shape[:3] if n_bands > 1 else data.shape[:2], bool)
                 if mask is None else mask)
        sel = valid[..., None] if nv > 1 else valid
        sel = np.broadcast_to(sel, data.shape)
        if lossless:
            if not np.array_equal(np.asarray(arr)[sel], data[sel]):
                raise AssertionError(f"{name}: lossless round trip differs")
            err = "exact"
        else:
            err = check_lossy(name, arr, data, sel, mze)
        with acceleration(False):
            _rc, _n, host_blob = api.encode(data, nv, mask is not None, mask, mze,
                                            data.nbytes * 2 + (1 << 20))
        if same_blob and host_blob != blob:
            raise AssertionError(f"{name}: device blob differs from the host encoder's")
        same = "blob==host" if host_blob == blob else f"blob {len(blob)} B vs host {len(host_blob)} B"
        info = get_lerc_info(blob)
        report.append(f"{name} mb{_micro_block(blob)} {err} {same} v{info.version}")
    return ("device encode for every family, device==host decode bit-identical "
            "(16x16 via the mosaic decoder); " + "; ".join(report)
            + " (tol: exact, or maxZError + 2 ulp)")


def _micro_block(blob: bytes) -> int:
    from lerc_tpu.codec import header as hdr

    return hdr.read_header(memoryview(blob))[0].micro_block_size


def phase_foreign(vectors_path: str) -> str:
    from lerc_tpu.codec import lerc2_decode
    from lerc_tpu.codec.device_codec import decode_band_device
    from lerc_tpu.codec.orchestrator import _remap_no_data
    from lerc_tpu.constants import DT_TO_NUMPY, DataType

    with open(vectors_path) as f:
        vectors = json.load(f)
    n_blobs = n_dev = n_host = 0
    for v in vectors:
        blob = base64.b64decode(v["blob"])
        if not blob.startswith(b"Lerc2 "):
            continue
        exp = v["expected"]
        dt = DT_TO_NUMPY[DataType(exp["dtype"])]
        shape = (exp["height"], exp["width"], exp["depth"])
        pos, prev_mask = 0, None
        for b in range(exp["bands"]):
            band = decode_band_device(blob[pos:], prev_mask)
            if band is None:
                n_host += 1
                band = lerc2_decode.decode_band(memoryview(blob)[pos:], prev_mask)
            else:
                n_dev += 1
            data = np.array(band.data, copy=True)
            if band.hd.b_pass_no_data_values:
                _remap_no_data(data, band.mask, band.hd)
            want = np.frombuffer(base64.b64decode(exp["pixels"][b]), dt).reshape(shape)
            valid = np.ones(shape[:2], bool)
            if exp["masks"] is not None:
                valid = np.frombuffer(base64.b64decode(exp["masks"][b]), np.uint8
                                      ).reshape(shape[:2]).astype(bool)
            if not np.array_equal(band.mask, valid):
                raise AssertionError(f"{v['name']} band {b}: mask differs")
            assert_bits_equal(data[valid], want[valid], f"{v['name']} band {b}")
            prev_mask, pos = band.mask, pos + band.hd.blob_size
        n_blobs += 1
    return (f"{n_blobs} reference-written Lerc2 blobs bit-identical to the "
            f"reference's decode ({n_dev} bands on the device, {n_host} "
            "declined to the host codec: one-sweep or pre-fpl layouts)")


def _best(fn, reps: int = 3) -> float:
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def phase_timing(s: Sizes, platform: str) -> str:
    import jax

    from lerc_tpu import api
    from lerc_tpu.codec.resident import FusedResidentCodec

    lines = []
    dem = make_dem(s.dem)
    mb = dem.nbytes / 1e6
    for name, mask in (("all-valid", None), ("masked", make_mask(s.dem))):
        with acceleration(True):
            out = {}

            def enc():
                out["blob"] = api.encode(dem, 1, mask is not None, mask, MZE,
                                         dem.nbytes * 2)[2]

            t_enc = _best(enc)
            t_dec = _best(lambda: api.decode(out["blob"]))
        lines.append(f"served {name} {s.dem}^2: encode {mb / t_enc:.1f} MB/s, "
                     f"decode {mb / t_dec:.1f} MB/s")
    tiles = make_device_tiles(s.tile, s.n_tiles)
    tmb = s.tile * s.tile * 4 * s.n_tiles / 1e6
    for nb_cap, exact in ((0, True), (16, True), (0, False), (16, False)):
        codec = FusedResidentCodec(s.tile, s.tile, 1, np.float32, MZE,
                                   nb_cap=nb_cap, exact_f32=exact)
        outs = [codec.encode_fast(tiles[i]) for i in range(s.n_tiles)]
        decs = [codec.decode_fast(h, st, sr) for h, st, _m, sr in outs]
        jax.block_until_ready((outs, decs))
        t_enc = _best(lambda: jax.block_until_ready(
            [codec.encode_fast(tiles[i]) for i in range(s.n_tiles)]))
        t_dec = _best(lambda: jax.block_until_ready(
            [codec.decode_fast(h, st, sr) for h, st, _m, sr in outs]))
        lines.append(f"resident nb_cap={nb_cap} exact_f32={exact}: encode "
                     f"{tmb / t_enc:.1f} MB/s, decode {tmb / t_dec:.1f} MB/s")
    for line in lines:
        print(f"    [{platform}] {line}", flush=True)
    return (f"bring-up reading on {platform}, best of 3 after warm-up, "
            "block_until_ready; not a benchmark")


def phase_mosaic(n: int, tile: int, n_dev: int, mze: float = MZE) -> str:
    """A mosaic over an n_dev-device mesh against three references: the
    container encoded over a one-device mesh (byte-identical), the host
    decode (bit-identical to the mesh decode) and the error bound."""
    import jax

    from lerc_tpu.codec.encode_orchestrator import ROUTES, reset_routes
    from lerc_tpu.parallel.sharding import (MosaicEncoder, decode_mosaic,
                                            decode_mosaic_device, make_mesh)

    if len(jax.devices()) < n_dev:
        raise AssertionError(f"needs {n_dev} devices, found {len(jax.devices())}")
    dem = make_dem(n, seed=3)
    mask = make_mask(n, seed=4)
    rows = -(-n // tile)

    def encode(mesh):
        enc = MosaicEncoder(mesh, tile, tile, np.float32, n_depth=1)
        blob = enc.encode_streamed(
            lambda i: dem[i * tile : (i + 1) * tile, :, None], n, n, mze,
            mask_provider=lambda i: mask[i * tile : (i + 1) * tile])
        return blob, enc.tiles_per_device

    mesh = make_mesh(n_dev)
    t0 = time.perf_counter()
    blob, placed = encode(mesh)
    t_enc = time.perf_counter() - t0
    if len(placed) != n_dev or min(placed.values()) == 0:
        raise AssertionError(f"tiles not placed on all {n_dev} devices: {placed}")
    print(f"    tiles per device (per tile-row band, {rows} bands): "
          + ", ".join(f"{d}: {c}" for d, c in placed.items()), flush=True)
    blob1, placed1 = encode(make_mesh(1))
    if blob1 != blob:
        raise AssertionError(f"{n_dev}-device container differs from the one-device "
                             f"container ({len(blob)} vs {len(blob1)} bytes)")
    reset_routes()
    t0 = time.perf_counter()
    dev = decode_mosaic_device(blob, mesh=mesh)
    t_dec = time.perf_counter() - t0
    dec_routes = dict(ROUTES)
    on_dev = {r: c for (k, r), c in sorted(dec_routes.items()) if k == "mosaic_units"}
    n_host = dec_routes.get(("decode", "host"), 0)
    n_unfit = dec_routes.get(("mosaic_unfit", "units"), 0)
    print("    tiles decoded per device: "
          + ", ".join(f"{d}: {c}" for d, c in on_dev.items())
          + f"; device {dec_routes.get(('decode', 'device'), 0)}, host {n_host}, "
          f"constant fill {dec_routes.get(('decode', 'const'), 0)}, "
          f"unfit for the batched kernel {n_unfit}", flush=True)
    if len(on_dev) != n_dev or min(on_dev.values()) == 0:
        raise AssertionError(f"mesh decode did not use all {n_dev} devices: {on_dev}")
    if n_host > n_unfit:
        raise AssertionError(f"{n_host} tiles decoded on the host, only {n_unfit} "
                             "of them unfit for the device kernel")
    with acceleration(False):
        host = decode_mosaic(blob)
    assert_bits_equal(dev, host, "mesh decode vs host decode")
    err = check_lossy("mosaic", host[:, :, 0], dem, mask, mze)
    return (f"{n}^2 f32 mosaic ({dem.nbytes / 2**30:.2f} GiB, {tile}^2 tiles, "
            f"mask {1 - mask.mean():.1%} invalid) -> {len(blob)} B over {n_dev} "
            f"devices in {t_enc:.1f}s; container byte-identical to the "
            f"one-device mesh ({', '.join(f'{d}: {c}' for d, c in placed1.items())}); "
            f"mesh decode in {t_dec:.1f}s ({n_host} tiles on the host) bit-identical "
            f"to the host decode; {err} (tol: maxZError + 2 ulp)")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device mesh mosaic phase")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at reduced sizes (needs JAX_PLATFORMS=cpu)")
    args = ap.parse_args(argv)
    n_dev = 4 if args.four else 1
    if args.rehearse and chip_env.rehearsal_allowed(True) and args.four:
        # virtual devices must be requested before the backend starts
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=4").strip()

    card = chip_env.card_line()  # a child process, before JAX opens the card

    import jax

    dev = chip_env.device_summary(jax)
    if dev["platform"] != "gpu" and not chip_env.rehearsal_allowed(args.rehearse):
        print(f"chip_smoke: found platform {dev['platform']!r}, not a GPU; a CPU "
              "rehearsal needs --rehearse and JAX_PLATFORMS=cpu", file=sys.stderr)
        return 2
    if dev["count"] < n_dev:
        print(f"chip_smoke: needs {n_dev} devices, found {dev['count']}", file=sys.stderr)
        return 2
    sizes = REAL if dev["platform"] == "gpu" else REHEARSAL
    # the CPU rehearsal compiles small shapes and keeps no cache
    cache_dir = chip_env.setup_compile_cache(jax) if dev["platform"] == "gpu" else "off"
    plat = dev["platform"]
    clock = CompileClock()

    phases = []
    if args.four:
        phases.append(("mosaic", lambda: phase_mosaic(sizes.mosaic, sizes.mosaic_tile, n_dev)))
    else:
        vectors = os.path.join(chip_env.REPO, "bindings", "js", "test", "vectors.json")
        phases += [
            ("compile", lambda: phase_compile(sizes.tile)),
            ("served", lambda: phase_served(sizes.dem)),
            ("resident", lambda: phase_resident(sizes.tile, sizes.n_tiles)),
            ("kernels", lambda: phase_kernels(sizes.kernel)),
            ("foreign", lambda: phase_foreign(vectors)),
            ("timing", lambda: phase_timing(sizes, plat)),
        ]

    from lerc_tpu import native

    print(f"[1] device [{plat}]: platform {plat}, kind {dev['kind']!r}, "
          f"count {dev['count']}; native host runtime "
          f"{'built' if native.available() else 'MISSING'}; compile cache {cache_dir}",
          flush=True)
    failed = []
    for i, (name, fn) in enumerate(phases, start=2):
        c0, t0 = clock.total, time.perf_counter()
        try:
            detail = fn()
            status = "PASS"
        except Exception as e:  # report every phase; any failure fails the run
            traceback.print_exc()
            detail, status = f"{type(e).__name__}: {e}", "FAIL"
            failed.append(name)
        print(f"[{i}] {name} [{plat}]: {status} {detail} "
              f"(compile {clock.total - c0:.1f}s, wall {time.perf_counter() - t0:.1f}s)",
              flush=True)
    print(f"card [{plat}]: {card}", flush=True)
    if failed:
        print(f"chip_smoke: FAILED phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
