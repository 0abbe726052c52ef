"""Lossless floating-point ("fpl") path of codec v6, vectorized.

Wire format (matches lerc/src/LercLib/fpl_Lerc2Ext.cpp:405-430,
fpl_EsriHuffman.cpp, fpl_UnitTypes.cpp):

  1 byte predictor code {0 none, 1 delta1-rows, 2 cross rows+cols}
  per byte plane (sizeof(T) planes):
    u8 byte_index, u8 best_level (<= 5), u32 compressed_size, payload
  payload method byte: 0 Huffman (lerc2Version=5 tables), 1 RLE-const
  (value + u32 count), 2 stored raw, 3 PackBits.

The float transform rearranges IEEE-754 fields to (exp<<24 | sign<<23 |
mantissa) so byte planes decorrelate; predictors use "split-field" add/sub
that deltas mantissa and exponent+sign independently with wraparound --
all implemented here as vectorized numpy over uint32/uint64 lanes.

nDepth > 1 slices are reshaped to (nCols*nRows, nDepth) and treated as an
image with nDepth columns (fpl_Lerc2Ext.cpp:432-454, 725-736).
"""
from __future__ import annotations

import struct

import numpy as np

from ..constants import DataType
from . import huffman

MAX_DELTA = 5
PRIME_MULT = 7

_F32_MANT = np.uint32(0x007FFFFF)
_F64_MANT_LO = np.uint64((1 << 26) - 1)  # mantissa low 26 bits
_F64_MANT = np.uint64((1 << 52) - 1)

# method bytes (fpl_EsriHuffman.cpp:243)
_M_HUFFMAN = 0
_M_RLE = 1
_M_RAW = 2
_M_PACKBITS = 3


# ---------------------------------------------------------------------------
# float transform (fpl_UnitTypes.cpp:39-81)
# ---------------------------------------------------------------------------

def float_transform(u: np.ndarray) -> np.ndarray:
    mant = u & _F32_MANT
    ae = (u >> np.uint32(23)) & np.uint32(0xFF)
    sign = u >> np.uint32(31)
    return mant | (ae << np.uint32(24)) | (sign << np.uint32(23))


def undo_float_transform(u: np.ndarray) -> np.ndarray:
    mant = u & _F32_MANT
    ae = (u >> np.uint32(24)) & np.uint32(0xFF)
    sign = (u >> np.uint32(23)) & np.uint32(1)
    return mant | (ae << np.uint32(23)) | (sign << np.uint32(31))


# ---------------------------------------------------------------------------
# split-field modular arithmetic, vectorized cumsum/diff along an axis
# ---------------------------------------------------------------------------

def _split_f32(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return a & _F32_MANT, a >> np.uint32(23)  # mantissa 23b, exp+sign 9b


def _join_f32(mant: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return (mant & _F32_MANT) | ((hi & np.uint32(0x1FF)) << np.uint32(23))


def split_sub_f32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    am, ah = _split_f32(a)
    bm, bh = _split_f32(b)
    return _join_f32(am - bm, ah - bh)


def split_cumsum_f32(a: np.ndarray, axis: int) -> np.ndarray:
    mant = (a & _F32_MANT).astype(np.uint64)
    hi = (a >> np.uint32(23)).astype(np.uint64)
    cm = np.cumsum(mant, axis=axis, dtype=np.uint64)
    ch = np.cumsum(hi, axis=axis, dtype=np.uint64)
    return _join_f32(cm.astype(np.uint32), ch.astype(np.uint32))


def split_sub_f64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    am, bm = a & _F64_MANT, b & _F64_MANT
    ah, bh = a >> np.uint64(52), b >> np.uint64(52)
    return ((am - bm) & _F64_MANT) | (((ah - bh) & np.uint64(0xFFF)) << np.uint64(52))


def split_cumsum_f64(a: np.ndarray, axis: int) -> np.ndarray:
    mant = a & _F64_MANT
    lo = (mant & _F64_MANT_LO).astype(np.uint64)
    hi26 = (mant >> np.uint64(26)).astype(np.uint64)
    ehi = (a >> np.uint64(52)).astype(np.uint64)
    clo = np.cumsum(lo, axis=axis, dtype=np.uint64)
    chi = np.cumsum(hi26, axis=axis, dtype=np.uint64)
    ce = np.cumsum(ehi, axis=axis, dtype=np.uint64)
    mant_sum = (clo + ((chi & _F64_MANT_LO) << np.uint64(26))) & _F64_MANT
    return mant_sum | ((ce & np.uint64(0xFFF)) << np.uint64(52))


def _sub(a, b, is_double):
    return split_sub_f64(a, b) if is_double else split_sub_f32(a, b)


def _cumsum(a, axis, is_double):
    return split_cumsum_f64(a, axis) if is_double else split_cumsum_f32(a, axis)


# predictors over a [rows, cols] word image ------------------------------------

def apply_predictor(img: np.ndarray, pred: int, is_double: bool) -> np.ndarray:
    if pred == 0:
        return img
    if pred == 1:  # delta along rows
        out = img.copy()
        out[:, 1:] = _sub(img[:, 1:], img[:, :-1], is_double)
        return out
    if pred == 2:  # cross: rows then columns
        tmp = img.copy()
        tmp[:, 1:] = _sub(img[:, 1:], img[:, :-1], is_double)
        out = tmp.copy()
        out[1:, :] = _sub(tmp[1:, :], tmp[:-1, :], is_double)
        return out
    raise ValueError("bad predictor")


def undo_predictor(img: np.ndarray, pred: int, is_double: bool) -> np.ndarray:
    if pred == 0:
        return img
    if pred == 1:  # restoreBlockSequence, delta 1: row cumsum
        return _cumsum(img, 1, is_double)
    if pred == 2:  # restoreCrossBytes, delta 2: column cumsum then row cumsum
        return _cumsum(_cumsum(img, 0, is_double), 1, is_double)
    raise ValueError("bad predictor")


# byte-plane extra delta (setDerivative / restoreSequence) ---------------------

def set_derivative(plane: np.ndarray, level: int) -> np.ndarray:
    out = plane.copy()
    for lev in range(1, level + 1):
        prev = out[lev - 1 : -1].copy()
        out[lev:] -= prev
    return out


def restore_sequence(plane: np.ndarray, level: int) -> np.ndarray:
    out = plane.copy()
    for lev in range(level, 0, -1):
        out[lev - 1 :] = np.cumsum(out[lev - 1 :], dtype=np.uint8)
    return out


# ---------------------------------------------------------------------------
# per-plane general compressor (fpl_EsriHuffman)
# ---------------------------------------------------------------------------

def encode_packbits(data: np.ndarray) -> bytes:
    """TIFF-style PackBits (fpl_EsriHuffman.cpp:83-165)."""
    n = data.size
    out = bytearray()
    # maximal equal runs
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(data[1:], data[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    lengths = np.diff(np.append(starts, n))

    lit_start = -1  # start of pending literal bytes
    lit_len = 0

    def flush_literals(end):
        nonlocal lit_start, lit_len
        while lit_len > 0:
            take = min(lit_len, 128)
            s = end - lit_len
            out.append(take - 1)
            out.extend(data[s : s + take].tobytes())
            lit_len -= take
        lit_start = -1

    for s, ln in zip(starts, lengths):
        s, ln = int(s), int(ln)
        pos = s
        rem = ln
        while rem >= 2:
            chunk = min(rem, 129)
            if chunk == 1:
                break
            if lit_len:
                flush_literals(pos)
            out.append(127 + chunk - 1)
            out.append(int(data[pos]))
            pos += chunk
            rem -= chunk
        if rem == 1:
            if lit_len == 0:
                lit_start = pos
            lit_len += 1
    if lit_len:
        flush_literals(n)
    return bytes(out)


def decode_packbits(buf: memoryview, expected: int) -> np.ndarray:
    out = np.zeros(expected, dtype=np.uint8)
    curr = 0
    i = 0
    size = len(buf)
    while i < size:
        b = buf[i]
        i += 1
        if b <= 127:
            ln = b + 1
            if curr + ln > expected or i + ln > size:
                raise ValueError("corrupt PackBits stream")
            out[curr : curr + ln] = np.frombuffer(buf[i : i + ln], dtype=np.uint8)
            curr += ln
            i += ln
        else:
            ln = b - 126
            if curr + ln > expected or i >= size:
                raise ValueError("corrupt PackBits stream")
            out[curr : curr + ln] = buf[i]
            curr += ln
            i += 1
    if curr != expected:
        raise ValueError("PackBits output size mismatch")
    return out


def compress_plane(plane: np.ndarray) -> bytes:
    """min(Huffman, PackBits, raw) with RLE-const shortcut (EncodeHuffman)."""
    n = plane.size
    histo = np.bincount(plane, minlength=256).astype(np.int64)
    if np.count_nonzero(histo) < 2:
        return bytes([_M_RLE, int(plane[0])]) + struct.pack("<I", n)
    lengths = huffman.compute_code_lengths(histo)
    huff_bytes = -1
    if lengths is not None:
        huff_bytes = huffman.compute_compressed_size(histo, lengths)
    if huff_bytes <= 0:
        huff_bytes = 1 << 60
    pb = encode_packbits(plane)
    if len(pb) < huff_bytes and len(pb) < n:
        return bytes([_M_PACKBITS]) + pb
    if huff_bytes >= n:
        return bytes([_M_RAW]) + plane.tobytes()
    codes = huffman.canonical_codes(lengths)
    table = huffman.write_code_table(lengths, codes, 5)
    stream = huffman.encode_symbols(plane.astype(np.int64), lengths, codes)
    return bytes([_M_HUFFMAN]) + table + stream


def extract_plane(buf: memoryview, expected: int) -> np.ndarray:
    if len(buf) < 1:
        raise ValueError("empty fpl plane payload")
    method = buf[0]
    if method == _M_RLE:
        if len(buf) < 6:
            raise ValueError("truncated RLE-const plane")
        val = buf[1]
        (count,) = struct.unpack_from("<I", buf, 2)
        if count != expected:
            raise ValueError("RLE-const size mismatch")
        return np.full(expected, val, dtype=np.uint8)
    if method == _M_RAW:
        if len(buf) - 1 < expected:
            raise ValueError("truncated raw plane")
        return np.frombuffer(buf[1 : 1 + expected], dtype=np.uint8).copy()
    if method == _M_PACKBITS:
        return decode_packbits(buf[1:], expected)
    if method != _M_HUFFMAN:
        raise ValueError("unknown fpl plane method")
    lengths, codes, used = huffman.read_code_table(buf[1:], 5)
    syms, _ = huffman.decode_symbols(buf[1 + used :], lengths, codes, expected)
    return syms.astype(np.uint8)


# ---------------------------------------------------------------------------
# entropy estimate (fpl_Compression::getEntropySize, stride-7 sampling)
# ---------------------------------------------------------------------------

def entropy_size(plane: np.ndarray) -> float:
    sample = plane[::PRIME_MULT]
    counts = np.bincount(sample, minlength=256)
    total = sample.size
    nz = counts[counts > 0]
    bits = float((nz * np.log2(total / nz)).sum())
    return (bits + 7) / 8


# ---------------------------------------------------------------------------
# slice encode / decode
# ---------------------------------------------------------------------------

def _slice_geometry(n_cols: int, n_rows: int, n_depth: int) -> tuple[int, int]:
    if n_depth == 1:
        return n_cols, n_rows
    return n_depth, n_cols * n_rows


def encode_slice(words: np.ndarray, is_double: bool) -> bytes:
    """words: [rows, cols] uint32/uint64 image (already float-transformed for f32)."""
    unit_size = 8 if is_double else 4
    rows, cols = words.shape

    # pick predictor by sampled entropy over byte planes of each candidate
    cands = []
    for pred in (0, 1, 2):
        t = apply_predictor(words, pred, is_double)
        planes = t.reshape(-1).view(np.uint8).reshape(-1, unit_size)
        est = 0.0
        for b in range(unit_size):
            p = np.ascontiguousarray(planes[:, b])
            est += min(entropy_size(p), entropy_size(set_derivative(p, 1)))
        cands.append(est)
    pred = int(np.argmin(cands))

    transformed = apply_predictor(words, pred, is_double)
    planes = transformed.reshape(-1).view(np.uint8).reshape(-1, unit_size)
    max_delta = MAX_DELTA - (0 if pred == 0 else (1 if pred == 1 else 2))

    out = bytearray([pred])
    for b in range(unit_size):
        plane = np.ascontiguousarray(planes[:, b])
        # pick best extra delta level by entropy estimate with early stop
        best_level, best_est = 0, entropy_size(plane)
        for lev in range(1, max_delta + 1):
            est = entropy_size(set_derivative(plane, lev))
            if est < best_est:
                best_est, best_level = est, lev
            else:
                break
        payload = compress_plane(set_derivative(plane, best_level))
        out.append(b)
        out.append(best_level)
        out += struct.pack("<I", len(payload))
        out += payload
    return bytes(out)


def decode_slice(src: memoryview, w: int, h: int, is_double: bool) -> np.ndarray:
    """Returns [h, w] uint32/uint64 words (float transform already undone)."""
    unit_size = 8 if is_double else 4
    expected = w * h
    if len(src) < 1:
        raise ValueError("truncated fpl section")
    pred = src[0]
    if pred > 2:
        raise ValueError("bad fpl predictor code")
    pos = 1
    planes = np.zeros((expected, unit_size), dtype=np.uint8)
    for _ in range(unit_size):
        if len(src) - pos < 6:
            raise ValueError("truncated fpl plane header")
        byte_index = src[pos]
        best_level = src[pos + 1]
        if byte_index >= unit_size or best_level > MAX_DELTA:
            raise ValueError("corrupt fpl plane header")
        (csize,) = struct.unpack_from("<I", src, pos + 2)
        pos += 6
        if csize < 1 or len(src) - pos < csize:
            raise ValueError("truncated fpl plane payload")
        plane = extract_plane(src[pos : pos + csize], expected)
        pos += csize
        planes[:, byte_index] = restore_sequence(plane, best_level)

    words = planes.reshape(-1).view(np.uint64 if is_double else np.uint32).reshape(h, w)
    words = undo_predictor(words, pred, is_double)
    if not is_double:
        words = undo_float_transform(words)
    return words, pos


# ---------------------------------------------------------------------------
# entry points used by lerc2 encode / decode
# ---------------------------------------------------------------------------

def encode_flt(data: np.ndarray, n_cols: int, n_rows: int, n_depth: int) -> bytes:
    """data: [nRows, nCols, nDepth] float32/float64, all pixels."""
    is_double = data.dtype == np.float64
    w, h = _slice_geometry(n_cols, n_rows, n_depth)
    words = data.reshape(-1).view(np.uint64 if is_double else np.uint32)
    if not is_double:
        words = float_transform(words)
    return encode_slice(words.reshape(h, w), is_double)


def decode_flt(src: memoryview, pos: int, out) -> None:
    hd = out.hd
    is_double = hd.dt == DataType.DOUBLE
    w, h = _slice_geometry(hd.n_cols, hd.n_rows, hd.n_depth)
    words, _ = decode_slice(src[pos:], w, h, is_double)
    flat = words.reshape(-1).view(np.float64 if is_double else np.float32)
    out.data[:] = flat.reshape(hd.n_rows, hd.n_cols, hd.n_depth)
