"""Test-only Lerc1 (CntZImage) WRITER -- corpus generator for the three
Lerc1 decoders (lerc_tpu.codec.lerc1, bindings/js/lerc.js,
bindings/csharp/LercDecode.cs).

The reference library is decode-only for Lerc1 (as are we), so no encoder
exists anywhere to produce fresh Lerc1 blobs: before this writer the only
corpus was the single golden `world.lerc1` plus mutations.
This writer emits the wire per
lerc/src/LercLib/Lerc1Decode/CntZImage.cpp:73-243 +
BitStuffer.cpp:32-115 and is validated by decoding its output with the
reference C++ library (tests/oracle.py), which makes it a trustworthy
fuzz source for all of our decoders.

Wire covered: const / RLE-bitmask / TILED cnt sections (tile flags
0 raw, 1 stuffed, 2 const-0, 3 const-(-1), 4 const-1), z tile flags
0 raw / 1 legacy-bit-stuffed / 2 const-0 / 3 const-offset with 1/2/4-byte
offsets, multi-band z-only parts, arbitrary tile grids.
"""
from __future__ import annotations

import struct

import numpy as np

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from lerc_tpu.codec.bitstuffer import bit_pack_legacy  # noqa: E402
from lerc_tpu.codec.bitmask import bool_to_bits  # noqa: E402
from lerc_tpu.codec import rle  # noqa: E402

_HDR_KEY = b"CntZImage "
_VERSION = 11
_TYPE_CNT_Z = 8


def _tile_ranges(total: int, num_tiles: int):
    t = total // num_tiles
    for k in range(num_tiles + 1):
        size = t if k < num_tiles else total % num_tiles
        if size:
            yield k * t, k * t + size


def _write_flt(out: bytearray, v: float) -> int:
    """Write the offset in the narrowest exact width; returns bits67."""
    if v == int(v) and -128 <= v <= 127:
        out += struct.pack("<b", int(v))
        return 2  # n = 1
    if v == int(v) and -32768 <= v <= 32767:
        out += struct.pack("<h", int(v))
        return 1  # n = 2
    out += struct.pack("<f", np.float32(v))
    return 0  # n = 4


def _write_stuffed(out: bytearray, vals: np.ndarray, num_bits: int) -> None:
    """Legacy BitStuffer::write: numBitsByte carries the element-count
    width in bits 6-7 (n = 4 if 0 else 3 - bits67), numBits in bits 0-5."""
    n_elem = int(vals.size)
    w = 1 if n_elem < 256 else (2 if n_elem < 65536 else 4)
    bits67 = 0 if w == 4 else 3 - w
    out.append((num_bits & 63) | (bits67 << 6))
    out += int(n_elem).to_bytes(w, "little")
    out += bit_pack_legacy(vals.astype(np.uint32), num_bits)


def _z_tile(out: bytearray, zt: np.ndarray, vt: np.ndarray, mze: float,
            ignore_mask: bool, rng: np.random.Generator) -> None:
    vals = zt.reshape(-1) if ignore_mask else zt[vt]
    if vals.size == 0:
        out.append(2)  # const 0 over an all-invalid tile
        return
    zmin = float(vals.min())
    zmax = float(vals.max())
    if zmin == 0.0 and zmax == 0.0:
        out.append(2)
        return
    if zmin == zmax and float(np.float32(zmin)) == zmin:
        # const offset: every valid pixel reconstructs to exactly `offset`
        head = len(out)
        out.append(3)
        bits67 = _write_flt(out, zmin)
        out[head] = 3 | (bits67 << 6)
        return
    if mze <= 0 or rng.random() < 0.15:  # raw float tile
        out.append(0)
        out += vals.astype("<f4").tobytes()
        return
    scale = 1.0 / (2 * mze)
    # offset must round-trip its narrowed width exactly, or the quant
    # error bound breaks: quantize against the value the DECODER will use
    off = zmin if zmin == int(zmin) and -32768 <= zmin <= 32767 else float(np.float32(zmin))
    if off > zmin:  # f32 rounding up would make q negative
        off = float(np.float32(np.nextafter(np.float32(zmin), -np.inf)))
    q = np.floor((vals.astype(np.float64) - off) * scale + 0.5).astype(np.int64)
    num_bits = int(q.max()).bit_length()
    if num_bits >= 32:
        out.append(0)
        out += vals.astype("<f4").tobytes()
        return
    if num_bits == 0:
        # every value quantizes to the offset: numBits==0 stuffed tiles are
        # OUTSIDE the reference wire contract (its legacy BitStuffer reads
        # garbage for them; the reference encoder emits const-offset here)
        head = len(out)
        out.append(3)
        bits67 = _write_flt(out, off)
        out[head] = 3 | (bits67 << 6)
        return
    head = len(out)
    out.append(1)
    bits67 = _write_flt(out, off)
    out[head] = 1 | (bits67 << 6)
    _write_stuffed(out, q.astype(np.uint32), num_bits)


def _cnt_section(out: bytearray, mask: np.ndarray, style: str,
                 grid: tuple[int, int], rng: np.random.Generator) -> bool:
    """Append the cnt section; returns ignore_mask (z tiles read all pixels)."""
    h, w = mask.shape
    all_valid = bool(mask.all())
    if style == "const" and all_valid:
        out += struct.pack("<3if", 0, 0, 0, 1.0)
        return True
    if style == "rle" or (style == "const" and not all_valid):
        payload = rle.compress(bool_to_bits(mask))
        out += struct.pack("<3if", 0, 0, len(payload), 1.0)
        out += payload
        return False
    # tiled cnt: per-tile const-0 / const-1 / stuffed 0-1 floats
    ntv, nth = grid
    body = bytearray()
    for i0, i1 in _tile_ranges(h, ntv):
        for j0, j1 in _tile_ranges(w, nth):
            sub = mask[i0:i1, j0:j1]
            if not sub.any():
                body.append(2)  # const 0
            elif sub.all():
                body.append(4)  # const 1
            elif rng.random() < 0.5:  # raw floats
                body.append(0)
                body += sub.astype("<f4").tobytes()
            else:  # offset 0 + 1-bit stuffed
                head = len(body)
                body.append(1)
                bits67 = _write_flt(body, 0.0)
                body[head] = 1 | (bits67 << 6)
                _write_stuffed(body, sub.reshape(-1).astype(np.uint32), 1)
    out += struct.pack("<3if", ntv, nth, len(body), 1.0)
    out += body
    return False


def encode_lerc1(bands, mask: np.ndarray | None, max_z_error: float,
                 cnt_style: str = "auto",
                 grid: tuple[int, int] | None = None,
                 seed: int = 0) -> bytes:
    """bands: [H, W] float32 or a list of them (multi-band z parts share
    one mask, like the reference). cnt_style: const | rle | tiled | auto.
    grid: (numTilesVert, numTilesHori) for the z sections (and tiled cnt);
    defaults to ~8x8-pixel tiles like CntZImage::findTiling's candidates."""
    if isinstance(bands, np.ndarray):
        bands = [bands]
    bands = [np.asarray(b, np.float32) for b in bands]
    h, w = bands[0].shape
    mask = np.ones((h, w), bool) if mask is None else np.asarray(mask, bool)
    rng = np.random.default_rng(seed)
    if grid is None:
        grid = (max(1, h // 8), max(1, w // 8))
    ntv, nth = grid
    assert 1 <= ntv <= h and 1 <= nth <= w, "bad tile grid"
    if cnt_style == "auto":
        cnt_style = "const" if mask.all() else "rle"

    out = bytearray()
    for bi, z in enumerate(bands):
        out += _HDR_KEY
        out += struct.pack("<4i", _VERSION, _TYPE_CNT_Z, h, w)
        out += struct.pack("<d", max_z_error)
        if bi == 0:
            ignore_mask = _cnt_section(out, mask, cnt_style, grid, rng)
        # z section: tile body first (need numBytes), then the header
        zq = np.where(mask, z, 0.0).astype(np.float32)
        zmax_img = float(z[mask].max()) if mask.any() else 0.0
        body = bytearray()
        for i0, i1 in _tile_ranges(h, ntv):
            for j0, j1 in _tile_ranges(w, nth):
                _z_tile(body, zq[i0:i1, j0:j1], mask[i0:i1, j0:j1],
                        max_z_error, bi == 0 and ignore_mask, rng)
        out += struct.pack("<3if", ntv, nth, len(body), np.float32(zmax_img))
        out += body
    return bytes(out)
