#!/usr/bin/env python
"""Headline benchmark: encode+decode MB/s of the device-resident codec.

Encodes and decodes a synthetic 4096x4096 float32 DEM (the BASELINE.json
elevation config, maxZError 0.001) as four 2048^2 tiles through
FusedResidentCodec: the raster is generated on the device, the blob payload
stays on the device, headers and Fletcher32 checksums are built there, and
decode is scan-free via the encoder's record-offset index. Each phase is
timed with block_until_ready after a warm-up call; compilation is set-up and
is not timed. A masked pass (~8% invalid pixels) runs over the same tiles.

Prints ONE JSON line: {"metric", "value", "unit": "MB/s", "vs_baseline",
"encode_MBps", "decode_MBps", ..., "device": {...}, "card": "..."}.
vs_baseline compares with the reference C++ library (single core,
ref_build/) on the same data when it is built, else with its published
~133 MB/s figure (reference README.md:99).

Needs a GPU. A CPU rehearsal, at chip_smoke.py's reduced tile size, is run
only when asked for explicitly, as for chip_smoke.py:
JAX_PLATFORMS=cpu python bench.py --rehearse
"""
import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import chip_env  # noqa: E402
import chip_smoke  # noqa: E402

TILE = chip_smoke.REAL.tile  # a CPU rehearsal sets chip_smoke.REHEARSAL.tile
GRID = 2  # 2x2 tiles = 4096x4096 total
N_TILES = GRID * GRID
MAX_Z_ERROR = 0.001
PUBLISHED_BASELINE_MBS = 133.0
ROUNDS = 5


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def time_phases(jax, codec, tiles):
    """Best encode and decode seconds for all tiles over ROUNDS, each
    phase ended by block_until_ready. Returns (enc_s, dec_s, outs, decs)."""
    best_enc = best_dec = np.inf
    outs = decs = None
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        outs = jax.block_until_ready(
            [codec.encode_fast(tiles[i]) for i in range(tiles.shape[0])])
        t1 = time.perf_counter()
        decs = jax.block_until_ready(
            [codec.decode_fast(h, s, st) for (h, s, _m, st) in outs])
        t2 = time.perf_counter()
        best_enc = min(best_enc, t1 - t0)
        best_dec = min(best_dec, t2 - t1)
    return best_enc, best_dec, outs, decs


def bench_ours(jax, tiles, nb_cap, mask=None):
    """Returns (enc_s, dec_s, blob_bytes) for the tiles, or None when
    nb_cap doesn't cover the data."""
    from lerc_tpu.codec.resident import FusedResidentCodec

    codec = FusedResidentCodec(TILE, TILE, 1, np.float32, MAX_Z_ERROR,
                               nb_cap=nb_cap, mask=mask)
    t0 = time.perf_counter()
    out0 = jax.block_until_ready(codec.encode_fast(tiles[0]))
    jax.block_until_ready(codec.decode_fast(out0[0], out0[1], out0[3]))
    log(f"nb_cap={nb_cap} masked={mask is not None}: compiled + first call "
        f"in {time.perf_counter() - t0:.1f}s")
    if nb_cap and not bool(np.asarray(out0[2])[2]):
        log(f"nb_cap={nb_cap} insufficient for this data")
        return None
    enc, dec, outs, decs = time_phases(jax, codec, tiles)
    metas = np.stack([np.asarray(o[2]) for o in outs])
    oks = np.stack([np.asarray(d[1]) for d in decs])
    if not oks.all():
        raise RuntimeError("checksum/index verification failed")
    valid = np.ones((TILE, TILE), bool) if mask is None else mask
    err = max(float(np.abs(np.asarray(d[0]) - np.asarray(tiles[i]))[valid].max())
              for i, d in enumerate(decs))
    if err > MAX_Z_ERROR * 1.1:
        raise RuntimeError(f"error bound violated: {err}")
    blob_bytes = int(metas[:, 0].sum()) + codec._hdr_len * tiles.shape[0]
    return enc, dec, blob_bytes


def bench_reference(tiles):
    """Times the built reference library on one tile, scaled to the full
    DEM: (enc_s, dec_s, ref_blob), or None when ref_build/ is absent."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import oracle

    if not oracle.available():
        return None
    tile = np.asarray(tiles)[0, :, :, 0]
    enc_t, dec_t = [], []
    blob = None
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        blob = oracle.encode(tile, 1, TILE, TILE, 1, None, MAX_Z_ERROR)
        t1 = time.perf_counter()
        oracle.decode(blob)
        t2 = time.perf_counter()
        enc_t.append(t1 - t0)
        dec_t.append(t2 - t1)
    return min(enc_t) * N_TILES, min(dec_t) * N_TILES, blob


def main(argv=None):
    global TILE
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at reduced size (needs JAX_PLATFORMS=cpu)")
    args = ap.parse_args(argv)
    card = chip_env.card_line()  # a child process, before JAX opens the card

    import jax

    dev = chip_env.device_summary(jax)
    rehearsal = dev["platform"] != "gpu"
    if rehearsal and not chip_env.rehearsal_allowed(args.rehearse):
        log(f"found platform {dev['platform']!r}, not a GPU; a CPU rehearsal "
            "needs --rehearse and JAX_PLATFORMS=cpu")
        return 2
    if rehearsal:
        TILE = chip_smoke.REHEARSAL.tile
    else:
        chip_env.setup_compile_cache(jax)
    total_mb = TILE * TILE * N_TILES * 4 / 1e6
    tiles = jax.block_until_ready(chip_smoke.make_device_tiles(TILE, N_TILES))

    enc, dec, blob_bytes = bench_ours(jax, tiles, 0)
    log(f"uncapped: enc {total_mb / enc:.1f} MB/s, dec {total_mb / dec:.1f} MB/s")
    up = bench_ours(jax, tiles, 16)
    if up is not None:
        enc, dec, blob_bytes = up
        log(f"nb16: enc {total_mb / enc:.1f} MB/s, dec {total_mb / dec:.1f} MB/s")

    mask = chip_smoke.make_mask(TILE)
    masked = bench_ours(jax, tiles, 16, mask) or bench_ours(jax, tiles, 0, mask)

    ref = bench_reference(tiles)
    ours_mbs = total_mb / (enc + dec)
    extra = {}
    baseline = PUBLISHED_BASELINE_MBS
    if ref is not None:
        baseline = total_mb / (ref[0] + ref[1])
        extra = {
            "ref_encode_MBps": round(total_mb / ref[0], 1),
            "ref_decode_MBps": round(total_mb / ref[1], 1),
            "ref_MBps": round(baseline, 1),
            # <1 means smaller blobs than the reference
            "ratio_vs_ref": round(blob_bytes / (len(ref[2]) * N_TILES), 3),
        }
    extra["masked_encode_MBps"] = round(total_mb / masked[0], 1)
    extra["masked_decode_MBps"] = round(total_mb / masked[1], 1)

    what = (f"encode+decode MB/s (float32 {TILE * GRID}x{TILE * GRID} DEM as "
            f"{TILE}^2 tiles, maxZError=0.001)")
    if rehearsal:
        what = f"CPU rehearsal, not a device measurement: {what}"
    print(json.dumps({
        "metric": what,
        "value": round(ours_mbs, 1),
        "unit": "MB/s",
        "vs_baseline": round(ours_mbs / baseline, 2),
        "encode_MBps": round(total_mb / enc, 1),
        "decode_MBps": round(total_mb / dec, 1),
        "compression_ratio": round(total_mb * 1e6 / blob_bytes, 2),
        **extra,
        "device": dev,
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
