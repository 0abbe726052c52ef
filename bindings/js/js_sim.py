"""Operator-exact Python simulation of bindings/js/lerc.js.

No JavaScript engine exists in this build environment (and egress is zero),
so this module transliterates lerc.js statement-for-statement with JS
operator semantics emulated exactly (32-bit `<<`/`>>`/`>>>`/`&`/`|`,
Math.fround, Number arithmetic), and tests/test_js_binding.py runs it
against the reference oracle on the same conformance vectors the browser
harness uses (test/harness.html). A logic bug in lerc.js shows up here;
what this cannot catch is a pure JS syntax typo -- that is what the
one-click browser harness is for.

Keep this file structurally in sync with lerc.js: same function names,
same statement order.
"""
from __future__ import annotations

import functools
import math
import struct

import numpy as np

# ---- sim-drift tripwire: the "statement-exact twin"
# premise silently rots if lerc.js is edited without a matching sim edit.
# Pin the binding's content hash; conformance tests verify it BEFORE any
# decode runs. After editing BOTH files, refresh with:
#   sha256sum bindings/js/lerc.js
PINNED_BINDING_SHA256 = "d7b8a76aaac79ea207f7e487129acb2d53a35f1cbc2ee091042ba6c7e1678429"


def check_binding_in_sync():
    """Raise if lerc.js changed since this sim was last synchronized."""
    import hashlib
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lerc.js")
    actual = hashlib.sha256(open(path, "rb").read()).hexdigest()
    if actual != PINNED_BINDING_SHA256:
        raise AssertionError(
            f"bindings/js/lerc.js hash {actual} != pinned "
            f"{PINNED_BINDING_SHA256}: lerc.js was edited without updating "
            "js_sim.py. Port the change to the sim (statement-for-statement), "
            "then refresh PINNED_BINDING_SHA256."
        )

FILE_KEY_LERC2 = b"Lerc2 "
FILE_KEY_LERC1 = b"CntZImage "

DT_SIZE = [1, 1, 2, 2, 4, 4, 4, 8]
DT_NP = [np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32, np.float32, np.float64]
PIXEL_TYPE = ["S8", "U8", "S16", "U16", "S32", "U32", "F32", "F64"]


class LercError(Exception):
    pass


def err(msg):
    raise LercError("Lerc: " + msg)


# ---- JS operator emulation --------------------------------------------------

def i32(x):
    x = int(x) & 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def u32(x):
    return int(x) & 0xFFFFFFFF


def shl(a, b):
    return i32(i32(a) << (b & 31))


def shr_u(a, b):  # JS >>>
    return u32(a) >> (b & 31)


def shr_s(a, b):  # JS >>
    return i32(a) >> (b & 31)


def band(a, b):
    return i32(i32(a) & i32(b))


def bor(a, b):
    return i32(i32(a) | i32(b))


def fround(x):
    return float(np.float32(x))


# typed-array store coercions
def store(arr, idx, v):
    dt = arr.dtype
    if dt == np.float32:
        arr[idx] = np.float32(v)
    elif dt == np.float64:
        arr[idx] = v
    else:
        arr[idx] = np.array(int(v), dtype=np.int64).astype(dt)


# ---- DataView ---------------------------------------------------------------

class DV:
    """DataView twin; out-of-bounds reads raise like the JS RangeError."""

    def __init__(self, u8):
        self.u8 = u8

    def _get(self, fmt, p):
        try:
            return struct.unpack_from(fmt, self.u8, p)[0]
        except struct.error:
            err("read out of bounds")  # JS DataView throws RangeError

    def getInt8(self, p):
        return self._get("<b", p)

    def getUint8(self, p):
        # DataView.getUint8 throws RangeError out of bounds; lerc.js
        # converts that to the Lerc error contract at the API boundary
        return self._get("<B", p)

    def getInt16(self, p):
        return self._get("<h", p)

    def getUint16(self, p):
        return self._get("<H", p)

    def getInt32(self, p):
        return self._get("<i", p)

    def getUint32(self, p):
        return self._get("<I", p)

    def getFloat32(self, p):
        return self._get("<f", p)

    def getFloat64(self, p):
        return self._get("<d", p)


def key_at(u8, pos, key: bytes):
    return bytes(u8[pos:pos + len(key)]) == key


# Fletcher32, mirroring lerc.js fletcher32 exactly (Number arithmetic)
def fletcher32(u8, start, end):
    s1, s2 = 0xFFFF, 0xFFFF
    i = start
    n = end
    while i < n - 1:
        t = min(1 << 20, (n - i) >> 1)
        while t:
            s1 += int(u8[i]) * 256 + int(u8[i + 1])
            s2 += s1
            i += 2
            t -= 1
        s1 %= 65535
        s2 %= 65535
    if i < n:
        s1 = (s1 + int(u8[i]) * 256) % 65535
        s2 = (s2 + s1) % 65535
    if s1 == 0:
        s1 = 65535
    if s2 == 0:
        s2 = 65535
    return s2 * 65536 + s1


# ---- header -----------------------------------------------------------------

def read_header(u8):
    if not key_at(u8, 0, FILE_KEY_LERC2):
        err("not a Lerc2 blob")
    view = DV(u8)
    pos = len(FILE_KEY_LERC2)
    version = view.getInt32(pos); pos += 4
    if version < 0 or version > 6:
        err("unsupported codec version " + str(version))
    checksum = 0
    if version >= 3:
        checksum = view.getUint32(pos); pos += 4
    h = {"version": version, "checksum": checksum}
    h["nRows"] = view.getInt32(pos); pos += 4
    h["nCols"] = view.getInt32(pos); pos += 4
    h["nDepth"] = 1
    if version >= 4:
        h["nDepth"] = view.getInt32(pos); pos += 4
    h["numValidPixel"] = view.getInt32(pos); pos += 4
    h["microBlockSize"] = view.getInt32(pos); pos += 4
    h["blobSize"] = view.getInt32(pos); pos += 4
    h["dt"] = view.getInt32(pos); pos += 4
    h["nBlobsMore"] = 0
    h["bPassNoDataValues"] = 0
    h["bIsInt"] = 0
    if version >= 6:
        h["nBlobsMore"] = view.getInt32(pos); pos += 4
        h["bPassNoDataValues"] = u8[pos]
        h["bIsInt"] = u8[pos + 1]
        pos += 4
    h["maxZError"] = view.getFloat64(pos); pos += 8
    h["zMin"] = view.getFloat64(pos); pos += 8
    h["zMax"] = view.getFloat64(pos); pos += 8
    h["noDataVal"] = 0.0
    h["noDataValOrig"] = 0.0
    if version >= 6:
        h["noDataVal"] = view.getFloat64(pos); pos += 8
        h["noDataValOrig"] = view.getFloat64(pos); pos += 8
    if (h["nRows"] <= 0 or h["nCols"] <= 0 or h["nDepth"] <= 0
            or h["numValidPixel"] < 0 or h["microBlockSize"] <= 0
            or h["microBlockSize"] > 32 or h["blobSize"] <= 0
            or h["dt"] < 0 or h["dt"] > 7):
        err("malformed Lerc2 header")
    num_pixel = h["nRows"] * h["nCols"]
    if (num_pixel > 0x7FFFFFFF or h["numValidPixel"] > num_pixel
            or DT_SIZE[h["dt"]] * h["nDepth"] * num_pixel > 0x7FFFFFFF):
        err("dimensions too large")
    h["headerSize"] = pos
    return h


def try_huffman_int(h):
    return h["version"] >= 2 and h["dt"] in (0, 1) and h["maxZError"] == 0.5


def try_huffman_flt(h):
    return h["version"] >= 6 and h["dt"] in (6, 7) and h["maxZError"] == 0


# ---- RLE + mask -------------------------------------------------------------

def rle_decompress(u8, pos, end, expected):
    out = np.zeros(expected, np.uint8)
    view = DV(u8)
    o = 0
    while True:
        if pos + 2 > end:
            err("truncated RLE stream")
        cnt = view.getInt16(pos); pos += 2
        if cnt == -32768:
            break
        if cnt > 0:
            if pos + cnt > end or o + cnt > expected:
                err("corrupt RLE stream")
            out[o:o + cnt] = u8[pos:pos + cnt]
            o += cnt; pos += cnt
        else:
            n = -cnt
            if pos + 1 > end or o + n > expected:
                err("corrupt RLE stream")
            out[o:o + n] = u8[pos]
            o += n; pos += 1
    if o != expected:
        err("RLE output size mismatch")
    return out


def bits_to_mask(bits, n_pixels):
    mask = np.zeros(n_pixels, np.uint8)
    for i in range(n_pixels):
        mask[i] = (bits[i >> 3] >> (7 - (i & 7))) & 1
    return mask


# ---- bitstuffer -------------------------------------------------------------

POW2 = [float(2 ** i) for i in range(33)]


def bit_unpack(u8, pos, n, num_bits, out):
    if num_bits == 0:
        out[:n] = 0
        return 0
    nbytes = (n * num_bits + 7) >> 3
    if pos + nbytes > len(u8):
        err("truncated bit-stuffed payload")
    bit_pos = 0
    for i in range(n):
        v = 0
        for b in range(num_bits):
            v += ((int(u8[pos + (bit_pos >> 3)]) >> (bit_pos & 7)) & 1) * POW2[b]
            bit_pos += 1
        store(out, i, v)
    return nbytes


def bit_unpack_legacy(u8, pos, n, num_bits, out):
    if num_bits == 0:
        out[:n] = 0
        return 0
    nbytes = (n * num_bits + 7) >> 3
    num_uints = (n * num_bits + 31) >> 5
    words = np.zeros(num_uints, np.uint32)
    for w in range(num_uints):
        b0 = pos + 4 * w
        v = 0
        for k in range(4):
            v = bor(v, shl(u8[b0 + k] if b0 + k < pos + nbytes else 0, 8 * k))
        store(words, w, shr_u(v, 0))
    num_bits_tail = (n * num_bits) & 31
    num_bytes_tail = (num_bits_tail + 7) >> 3
    ntbnn = 4 - num_bytes_tail if num_bytes_tail > 0 else 0
    if ntbnn:
        store(words, num_uints - 1, shr_u(shl(int(words[num_uints - 1]), 8 * ntbnn), 0))
    bit_pos = 0
    for i in range(n):
        v = 0
        for b in range(num_bits):
            bit = (int(words[bit_pos >> 5]) >> (31 - (bit_pos & 31))) & 1
            v = v * 2 + bit
            bit_pos += 1
        store(out, i, v)
    return nbytes


def unpack_for_version(u8, pos, n, num_bits, version, out):
    if version >= 3:
        return bit_unpack(u8, pos, n, num_bits, out)
    return bit_unpack_legacy(u8, pos, n, num_bits, out)


def stuffed_decode(u8, pos, max_element_count, version):
    header = int(u8[pos]); p = pos + 1
    bits67 = header >> 6
    w = 4 if bits67 == 0 else 3 - bits67
    do_lut = (header & 32) != 0
    num_bits = header & 31
    n = 0
    for k in range(w):
        n = bor(n, shl(u8[p + k], 8 * k))
    n = shr_u(n, 0); p += w
    if n > max_element_count:
        err("stuffed element count exceeds limit")
    if not do_lut:
        vals = np.zeros(n, np.uint32)
        p += unpack_for_version(u8, p, n, num_bits, version, vals)
        return vals, p
    if num_bits == 0:
        err("corrupt LUT block")
    n_lut = int(u8[p]) - 1; p += 1
    lut = np.zeros(n_lut, np.uint32)
    p += unpack_for_version(u8, p, n_lut, num_bits, version, lut)
    nbits_lut = 0
    t = n_lut
    while t:
        nbits_lut += 1
        t >>= 1
    if nbits_lut == 0:
        err("corrupt LUT block")
    idx = np.zeros(n, np.uint32)
    p += unpack_for_version(u8, p, n, nbits_lut, version, idx)
    vals = np.zeros(n, np.uint32)
    for i in range(n):
        j = int(idx[i])
        if j > n_lut:
            err("LUT index out of range")
        vals[i] = 0 if j == 0 else lut[j - 1]
    return vals, p


# ---- Huffman ----------------------------------------------------------------

class BitReaderMSB:
    def __init__(self, u8, pos):
        self.u8 = u8
        self.base = pos
        self.bitPos = 0

    def read(self, n_bits):
        v = 0
        for k in range(n_bits):
            bp = self.bitPos + k
            byte_idx = self.base + ((bp >> 5) << 2) + (3 - ((bp >> 3) & 3))
            bit = (self.u8[byte_idx] >> (7 - (bp & 7))) & 1
            v = v * 2 + bit
        self.bitPos += n_bits
        return v


def read_code_table(u8, pos, version):
    view = DV(u8)
    hf_version = view.getInt32(pos)
    size = view.getInt32(pos + 4)
    i0 = view.getInt32(pos + 8)
    i1 = view.getInt32(pos + 12)
    p = pos + 16
    if hf_version < 2:
        err("unsupported huffman version")
    if i0 >= i1 or i0 < 0 or size < 0 or size > (1 << 15):
        err("corrupt huffman code table")
    vals, p = stuffed_decode(u8, p, i1 - i0, version)
    lengths = np.zeros(size, np.int32)
    for k in range(i0, i1):
        lengths[k % size] = vals[k - i0]
    total_bits = 0
    max_len = 0
    for k in range(i0, i1):
        L = int(lengths[k % size])
        if L > 32:
            err("corrupt huffman code lengths")
        total_bits += L
        if L > max_len:
            max_len = L
    num_words = (total_bits + 31) >> 5
    codes = np.zeros(size, np.uint32)
    br = BitReaderMSB(u8, p)
    for k in range(i0, i1):
        L = int(lengths[k % size])
        if L > 0:
            codes[k % size] = shr_u(br.read(L), 0)
    p += 4 * num_words
    return lengths, codes, max_len, p


def build_decode_tables(lengths, codes, max_len):
    first = [-1] * (max_len + 1)
    syms_by_len = [None] + [[] for _ in range(max_len)]
    for s in range(len(lengths)):
        L = int(lengths[s])
        if L > 0:
            syms_by_len[L].append(s)
    for L in range(1, max_len + 1):
        syms_by_len[L].sort(key=lambda a: codes[a])
        if syms_by_len[L]:
            first[L] = int(codes[syms_by_len[L][0]])
    return first, syms_by_len


def decode_symbols(u8, pos, lengths, codes, max_len, n_symbols, out):
    first, syms_by_len = build_decode_tables(lengths, codes, max_len)
    br = BitReaderMSB(u8, pos)
    total_bits = (len(u8) - pos) * 8
    for i in range(n_symbols):
        c = 0
        L = 0
        sym = -1
        while L < max_len:
            if br.bitPos >= total_bits:
                err("truncated huffman stream")
            c = c * 2 + br.read(1)
            L += 1
            f = first[L]
            if f >= 0 and c >= f and c - f < len(syms_by_len[L]):
                sym = syms_by_len[L][c - f]
                break
        if sym < 0:
            err("corrupt huffman stream")
        out[i] = sym
    return pos + (((br.bitPos + 31) >> 5) << 2) + 4


def data8(data, idx, signed):
    return int(data[idx]) & 255 if signed else int(data[idx])


def decode_huffman_image(u8, pos, h, mode, mask, data):
    H, W, D = h["nRows"], h["nCols"], h["nDepth"]
    signed = h["dt"] == 0
    lengths, codes, max_len, p = read_code_table(u8, pos, h["version"])
    if max_len == 0:
        err("empty huffman code table")
    n_valid = 0
    for i in range(H * W):
        n_valid += (int(mask[i]) if mask is not None else 1)
    n_symbols = n_valid * D
    syms = np.zeros(n_symbols, np.int32)
    decode_symbols(u8, p, lengths, codes, max_len, n_symbols, syms)
    off = 128 if signed else 0

    if mode == 2:
        t = 0
        for i in range(H * W):
            if mask is not None and not mask[i]:
                continue
            for d in range(D):
                store(data, i * D + d, int(syms[t]) - off)
                t += 1
        return

    all_valid = n_valid == H * W
    for d in range(D):
        prev = 0
        t = d * n_valid
        if all_valid:
            for i in range(H):
                for j in range(W):
                    if j == 0 and i > 0:
                        v = (data8(data, (i - 1) * W * D + d, signed)
                             + int(syms[d * H * W + i * W]) - off) & 255
                    else:
                        v = (prev + int(syms[d * H * W + i * W + j]) - off) & 255
                    store(data, (i * W + j) * D + d,
                          shr_s(shl(v & 255, 24), 24) if signed else v & 255)
                    prev = v & 255
        else:
            for i in range(H):
                for j in range(W):
                    if not mask[i * W + j]:
                        continue
                    left_ok = j > 0 and mask[i * W + j - 1]
                    above_ok = i > 0 and mask[(i - 1) * W + j]
                    if not left_ok and above_ok:
                        base = data8(data, ((i - 1) * W + j) * D + d, signed)
                    else:
                        base = prev
                    v = (base + int(syms[t]) - off) & 255
                    t += 1
                    store(data, (i * W + j) * D + d,
                          shr_s(shl(v & 255, 24), 24) if signed else v & 255)
                    prev = v
    return


# ---- tiling -----------------------------------------------------------------

def data_type_used(dt, tc):
    if dt in (2, 4):
        return dt - tc
    if dt in (3, 5):
        return dt - 2 * tc
    if dt == 6:
        return dt if tc == 0 else (2 if tc == 1 else 1)
    if dt == 7:
        return dt if tc == 0 else dt - 2 * tc + 1
    return dt


def read_variable_value(view, pos, dt_used):
    if dt_used == 0:
        return view.getInt8(pos), 1
    if dt_used == 1:
        return view.getUint8(pos), 1
    if dt_used == 2:
        return view.getInt16(pos), 2
    if dt_used == 3:
        return view.getUint16(pos), 2
    if dt_used == 4:
        return view.getInt32(pos), 4
    if dt_used == 5:
        return view.getUint32(pos), 4
    if dt_used == 6:
        return view.getFloat32(pos), 4
    return view.getFloat64(pos), 8


def cast_dt(v, dt):
    if dt == 0:
        return shr_s(shl(i32(int(v)), 24), 24)
    if dt == 1:
        return band(int(v), 255)
    if dt == 2:
        return shr_s(shl(i32(int(v)), 16), 16)
    if dt == 3:
        return band(int(v), 65535)
    if dt == 4:
        return i32(int(v))
    if dt == 5:
        return shr_u(int(v), 0)
    if dt == 6:
        return fround(v)
    return v


def _js_trunc(v):
    # JS `v | 0` on a Number: truncate toward zero, wrap to int32
    return i32(int(math.trunc(v)))


def read_tiles(u8, pos, h, mask, data, z_max_vec):
    H, W, D, mb = h["nRows"], h["nCols"], h["nDepth"], h["microBlockSize"]
    view = DV(u8)
    dt_is_int = h["dt"] < 6
    inv_scale = 2 * h["maxZError"]
    ntv = -(-H // mb)
    nth = -(-W // mb)
    for it in range(ntv):
        i0 = it * mb
        i1 = min(i0 + mb, H)
        for jt in range(nth):
            j0 = jt * mb
            j1 = min(j0 + mb, W)
            n_valid = 0
            for i in range(i0, i1):
                for j in range(j0, j1):
                    n_valid += (int(mask[i * W + j]) if mask is not None else 1)
            for d in range(D):
                if pos >= len(u8):
                    err("truncated tile stream")
                compr_flag = int(u8[pos]); pos += 1
                b_diff = h["version"] >= 5 and (compr_flag & 4) != 0
                pattern = 14 if h["version"] >= 5 else 15
                if ((compr_flag >> 2) & pattern) != ((j0 >> 3) & pattern):
                    err("micro-block integrity check failed")
                if b_diff and d == 0:
                    err("diff encoding on depth slice 0")
                bits67 = compr_flag >> 6
                code = compr_flag & 3
                z_max = z_max_vec[d] if (h["version"] >= 4 and D > 1) else h["zMax"]

                if code == 2:
                    if b_diff:
                        for i in range(i0, i1):
                            for j in range(j0, j1):
                                if mask is None or mask[i * W + j]:
                                    data[(i * W + j) * D + d] = data[(i * W + j) * D + d - 1]
                    continue
                if code == 0:
                    if b_diff:
                        err("raw block cannot be diff encoded")
                    for i in range(i0, i1):
                        for j in range(j0, j1):
                            if mask is not None and not mask[i * W + j]:
                                continue
                            v, n = read_variable_value(view, pos, h["dt"])
                            store(data, (i * W + j) * D + d, v)
                            pos += n
                    continue
                base_dt = 4 if (b_diff and dt_is_int) else h["dt"]
                v, n = read_variable_value(view, pos, data_type_used(base_dt, bits67))
                pos += n
                offset = v
                if code == 3:
                    for i in range(i0, i1):
                        for j in range(j0, j1):
                            if mask is not None and not mask[i * W + j]:
                                continue
                            k = (i * W + j) * D + d
                            if b_diff:
                                store(data, k, cast_dt(min(offset + float(data[k - 1]), z_max), h["dt"]))
                            else:
                                store(data, k, cast_dt(offset, h["dt"]))
                    continue
                max_elem = (i1 - i0) * (j1 - j0)
                vals, pos = stuffed_decode(u8, pos, max_elem, h["version"])
                dense = len(vals) == max_elem
                if not dense and len(vals) < n_valid:
                    err("not enough stuffed values")
                t = 0
                for i in range(i0, i1):
                    for j in range(j0, j1):
                        valid = mask is None or mask[i * W + j]
                        if dense:
                            q = float(vals[(i - i0) * (j1 - j0) + (j - j0)])
                        else:
                            if not valid:
                                continue
                            q = float(vals[t]); t += 1
                        if not valid:
                            continue
                        k = (i * W + j) * D + d
                        z = offset + q * inv_scale
                        if b_diff:
                            z += float(data[k - 1])
                        store(data, k, cast_dt(min(z, z_max), h["dt"]))
    return pos


# ---- fpl --------------------------------------------------------------------

def decode_packbits(u8, pos, end, expected, out):
    o = 0
    i = pos
    while i < end:
        b = int(u8[i]); i += 1
        if b <= 127:
            n = b + 1
            if o + n > expected or i + n > end:
                err("corrupt PackBits stream")
            out[o:o + n] = u8[i:i + n]
            o += n; i += n
        else:
            n = b - 126
            if o + n > expected or i >= end:
                err("corrupt PackBits stream")
            out[o:o + n] = u8[i]
            o += n; i += 1
    if o != expected:
        err("PackBits output size mismatch")


def extract_plane(u8, pos, end, expected, version):
    method = u8[pos]
    out = np.zeros(expected, np.uint8)
    if method == 1:
        if end - pos < 6:
            err("truncated RLE-const plane")
        cnt = DV(u8).getUint32(pos + 2)
        if cnt != expected:
            err("RLE-const size mismatch")
        out[:] = u8[pos + 1]
        return out
    if method == 2:
        if end - pos - 1 < expected:
            err("truncated raw plane")
        out[:] = u8[pos + 1:pos + 1 + expected]
        return out
    if method == 3:
        decode_packbits(u8, pos + 1, end, expected, out)
        return out
    if method != 0:
        err("unknown fpl plane method")
    lengths, codes, max_len, p = read_code_table(u8, pos + 1, 5)
    syms = np.zeros(expected, np.int32)
    decode_symbols(u8, p, lengths, codes, max_len, expected, syms)
    for i in range(expected):
        out[i] = band(int(syms[i]), 255)
    return out


def restore_sequence(plane, level):
    for lev in range(level, 0, -1):
        acc = int(plane[lev - 1])
        for i in range(lev, len(plane)):
            acc = (acc + int(plane[i])) & 255
            plane[i] = acc


def cumsum_split_f32(words, rows, cols, axis):
    M = 0x7FFFFF
    if axis == 1:
        for r in range(rows):
            m = 0
            hi = 0
            for c in range(cols):
                k = r * cols + c
                w = int(words[k])
                m = (m + (w & M)) & M
                hi = (hi + shr_u(w, 23)) & 0x1FF
                words[k] = shr_u(bor(shl(hi, 23), m), 0)
    else:
        for c in range(cols):
            m = 0
            hi = 0
            for r in range(rows):
                k = r * cols + c
                w = int(words[k])
                m = (m + (w & M)) & M
                hi = (hi + shr_u(w, 23)) & 0x1FF
                words[k] = shr_u(bor(shl(hi, 23), m), 0)


def cumsum_split_f64(lo, hi, rows, cols, axis):
    P32 = 4294967296
    M52 = 2 ** 52
    step = 1 if axis == 1 else cols
    outer = rows if axis == 1 else cols
    inner = cols if axis == 1 else rows
    for o in range(outer):
        m_acc = 0
        e_acc = 0
        k = o * cols if axis == 1 else o
        for _ in range(inner):
            m = (int(hi[k]) & 0xFFFFF) * P32 + int(lo[k])
            e = shr_u(int(hi[k]), 20)
            m_acc = (m_acc + m) % M52
            e_acc = (e_acc + e) & 0xFFF
            lo[k] = m_acc % P32
            hi[k] = shr_u(bor(_js_trunc(m_acc / P32), shl(e_acc, 20)), 0)
            k += step


def undo_float_transform(words):
    M = 0x7FFFFF
    for i in range(len(words)):
        u = int(words[i])
        mant = u & M
        ae = shr_u(u, 24) & 0xFF
        sign = shr_u(u, 23) & 1
        words[i] = shr_u(bor(bor(shl(sign, 31), shl(ae, 23)), mant), 0)


def decode_fpl(u8, pos, h, data):
    H, W, D = h["nRows"], h["nCols"], h["nDepth"]
    is_double = h["dt"] == 7
    unit_size = 8 if is_double else 4
    cols = W if D == 1 else D
    rows = H if D == 1 else W * H
    expected = rows * cols
    view = DV(u8)
    pred = u8[pos]; pos += 1
    if pred > 2:
        err("bad fpl predictor code")
    planes = [None] * unit_size
    for _ in range(unit_size):
        if len(u8) - pos < 6:
            err("truncated fpl plane header")
        byte_index = u8[pos]
        best_level = u8[pos + 1]
        if byte_index >= unit_size or best_level > 5:
            err("corrupt fpl plane header")
        csize = view.getUint32(pos + 2)
        pos += 6
        if csize < 1 or len(u8) - pos < csize:
            err("truncated fpl plane payload")
        plane = extract_plane(u8, pos, pos + csize, expected, h["version"])
        pos += csize
        restore_sequence(plane, best_level)
        planes[byte_index] = plane
    if not is_double:
        words = np.zeros(expected, np.uint32)
        for i in range(expected):
            words[i] = shr_u(bor(bor(int(planes[0][i]), shl(int(planes[1][i]), 8)),
                                 bor(shl(int(planes[2][i]), 16), shl(int(planes[3][i]), 24))), 0)
        if pred == 2:
            cumsum_split_f32(words, rows, cols, 0)
        if pred >= 1:
            cumsum_split_f32(words, rows, cols, 1)
        undo_float_transform(words)
        f = words.view(np.float32)
        for i in range(expected):
            data[i] = f[i]
    else:
        lo = np.zeros(expected, np.uint32)
        hi = np.zeros(expected, np.uint32)
        for i in range(expected):
            lo[i] = shr_u(bor(bor(int(planes[0][i]), shl(int(planes[1][i]), 8)),
                              bor(shl(int(planes[2][i]), 16), shl(int(planes[3][i]), 24))), 0)
            hi[i] = shr_u(bor(bor(int(planes[4][i]), shl(int(planes[5][i]), 8)),
                              bor(shl(int(planes[6][i]), 16), shl(int(planes[7][i]), 24))), 0)
        if pred == 2:
            cumsum_split_f64(lo, hi, rows, cols, 0)
        if pred >= 1:
            cumsum_split_f64(lo, hi, rows, cols, 1)
        for i in range(expected):
            word = (int(hi[i]) << 32) | int(lo[i])
            data[i] = struct.unpack("<d", struct.pack("<Q", word))[0]


# ---- band decode ------------------------------------------------------------

def decode_band(u8, prev_mask, verify_checksum):
    h = read_header(u8)
    if len(u8) < h["blobSize"]:
        err("buffer shorter than blobSize")
    if h["version"] >= 3 and verify_checksum:
        skip = len(FILE_KEY_LERC2) + 4 + 4
        if fletcher32(u8, skip, h["blobSize"]) != h["checksum"]:
            err("checksum mismatch")
    H, W, D = h["nRows"], h["nCols"], h["nDepth"]
    view = DV(u8)
    pos = h["headerSize"]

    num_bytes_mask = view.getInt32(pos); pos += 4
    if num_bytes_mask < 0 or num_bytes_mask > len(u8) - pos:
        err("bad mask section size")
    num_total = H * W
    mask = None
    if h["numValidPixel"] == 0:
        mask = np.zeros(num_total, np.uint8)
    elif h["numValidPixel"] != num_total:
        if num_bytes_mask > 0:
            bits = rle_decompress(u8, pos, pos + num_bytes_mask, (num_total + 7) >> 3)
            mask = bits_to_mask(bits, num_total)
            pos += num_bytes_mask
        else:
            if prev_mask is None:
                err("mask reuse requested but no previous mask")
            mask = prev_mask
    elif num_bytes_mask != 0:
        err("unexpected mask bytes")

    data = np.zeros(num_total * D, DT_NP[h["dt"]])
    band = {"h": h, "mask": mask, "data": data, "zMinVec": None, "zMaxVec": None}
    if h["numValidPixel"] == 0:
        return band

    def fill_const():
        for i in range(num_total):
            if mask is not None and not mask[i]:
                continue
            for d in range(D):
                store(data, i * D + d,
                      cast_dt(h["zMin"] if (D == 1 or h["zMin"] == h["zMax"])
                              else band["zMinVec"][d], h["dt"]))

    if h["zMin"] == h["zMax"]:
        fill_const()
        return band

    z_max_vec = None
    if h["version"] >= 4:
        z_mins = np.zeros(D, np.float64)
        z_maxs = np.zeros(D, np.float64)
        for d in range(D):
            v, n = read_variable_value(view, pos, h["dt"])
            z_mins[d] = v; pos += n
        for d in range(D):
            v, n = read_variable_value(view, pos, h["dt"])
            z_maxs[d] = v; pos += n
        band["zMinVec"] = z_mins
        band["zMaxVec"] = z_maxs
        z_max_vec = z_maxs
        all_eq = True
        for d in range(D):
            if z_mins[d] != z_maxs[d]:
                all_eq = False
        if all_eq:
            fill_const()
            return band

    if pos >= len(u8):
        err("truncated blob: missing flag bytes")
    one_sweep = u8[pos]; pos += 1
    if one_sweep:
        for i in range(num_total):
            if mask is not None and not mask[i]:
                continue
            for d in range(D):
                v, n = read_variable_value(view, pos, h["dt"])
                store(data, i * D + d, v)
                pos += n
        return band

    if try_huffman_int(h) or try_huffman_flt(h):
        if pos >= len(u8):
            err("truncated blob: missing image-mode byte")
        flag = u8[pos]; pos += 1
        if flag > 3 or (flag > 2 and h["version"] < 6) or (flag > 1 and h["version"] < 4):
            err("bad image encode mode flag")
        if flag != 0:
            if try_huffman_int(h) and (flag == 1 or (h["version"] >= 4 and flag == 2)):
                decode_huffman_image(u8, pos, h, flag, mask, data)
                return band
            if try_huffman_flt(h) and flag == 3:
                decode_fpl(u8, pos, h, data)
                return band
            err("bad image encode mode")
    read_tiles(u8, pos, h, mask, data, z_max_vec)
    return band


# ---- Lerc1 ------------------------------------------------------------------

def lerc1_read_stuffed(u8, pos):
    num_bits_byte = int(u8[pos]); pos += 1
    bits67 = num_bits_byte >> 6
    n = 4 if bits67 == 0 else 3 - bits67
    num_bits = num_bits_byte & 63
    num_elements = 0
    for k in range(n):
        num_elements = bor(num_elements, shl(u8[pos + k], 8 * k))
    num_elements = shr_u(num_elements, 0)
    pos += n
    if num_bits >= 32:
        err("corrupt legacy bitstuffer block")
    vals = np.zeros(num_elements, np.uint32)
    pos += bit_unpack_legacy(u8, pos, num_elements, num_bits, vals)
    return vals, pos


def lerc1_read_flt(view, pos, n):
    if n == 1:
        return view.getInt8(pos), pos + 1
    if n == 2:
        return view.getInt16(pos), pos + 2
    if n == 4:
        return view.getFloat32(pos), pos + 4
    err("bad float width")


def lerc1_tile_ranges(total, num_tiles):
    t = total // num_tiles
    out = []
    for k in range(num_tiles + 1):
        size = t if k < num_tiles else total % num_tiles
        if size:
            out.append((k * t, k * t + size))
    return out


def lerc1_decode(u8):
    if not key_at(u8, 0, FILE_KEY_LERC1):
        err("not a Lerc1 blob")
    view = DV(u8)
    version = view.getInt32(10)
    typ = view.getInt32(14)
    H = view.getInt32(18)
    W = view.getInt32(22)
    max_z_error = view.getFloat64(26)
    if version != 11 or typ != 8:
        err("unsupported Lerc1 version/type")
    if H < 0 or W < 0 or H > 40000 or W > 40000:
        err("Lerc1 dimensions out of range")
    HDR = 10 + 16 + 8
    pos = HDR
    cnt = np.zeros(H * W, np.float32)
    z = np.zeros(H * W, np.float32)
    bands = []
    only_z = False
    ignore_mask = False

    def read_cnt_tile(p, i0, i1, j0, j1):
        flag = int(u8[p]); p += 1
        if flag == 2:
            for i in range(i0, i1):
                cnt[i * W + j0:i * W + j1] = 0
            return p
        if flag in (3, 4):
            v = -1 if flag == 3 else 1
            for i in range(i0, i1):
                cnt[i * W + j0:i * W + j1] = v
            return p
        if (flag & 63) > 4:
            err("bad Lerc1 cnt tile flag")
        if flag == 0:
            for i in range(i0, i1):
                for j in range(j0, j1):
                    cnt[i * W + j] = view.getFloat32(p)
                    p += 4
            return p
        bits67 = flag >> 6
        n = 4 if bits67 == 0 else 3 - bits67
        v, p = lerc1_read_flt(view, p, n)
        vals, p = lerc1_read_stuffed(u8, p)
        t = 0
        for i in range(i0, i1):
            for j in range(j0, j1):
                cnt[i * W + j] = fround(v + float(vals[t]))
                t += 1
        return p

    def read_z_tile(p, i0, i1, j0, j1, max_z_img):
        flag = int(u8[p]); p += 1
        bits67 = flag >> 6
        flag &= 63
        if flag == 2:
            for i in range(i0, i1):
                for j in range(j0, j1):
                    if cnt[i * W + j] > 0:
                        z[i * W + j] = 0
            return p
        if flag > 3:
            err("bad Lerc1 z tile flag")
        if flag == 0:
            for i in range(i0, i1):
                for j in range(j0, j1):
                    if cnt[i * W + j] > 0:
                        z[i * W + j] = view.getFloat32(p)
                        p += 4
            return p
        n = 4 if bits67 == 0 else 3 - bits67
        v, p = lerc1_read_flt(view, p, n)
        if flag == 3:
            for i in range(i0, i1):
                for j in range(j0, j1):
                    if cnt[i * W + j] > 0:
                        z[i * W + j] = fround(v)
            return p
        vals, p = lerc1_read_stuffed(u8, p)
        inv_scale = 2 * max_z_error
        t = 0
        for i in range(i0, i1):
            for j in range(j0, j1):
                if ignore_mask:
                    z[i * W + j] = fround(min(v + float(vals[t]) * inv_scale, max_z_img))
                    t += 1
                elif cnt[i * W + j] > 0:
                    z[i * W + j] = fround(min(v + float(vals[t]) * inv_scale, max_z_img))
                    t += 1
        return p

    hdr_next_band = HDR + 12 + 4 + 1
    while pos + (hdr_next_band if only_z else 0) < len(u8):
        if only_z:
            if not key_at(u8, pos, FILE_KEY_LERC1):
                break
            h2 = view.getInt32(pos + 18)
            w2 = view.getInt32(pos + 22)
            if h2 != H or w2 != W:
                err("inconsistent Lerc1 band header")
            max_z_error = view.getFloat64(pos + 26)
            pos += HDR
        for part in range(2):
            z_part = part == 1
            if not z_part and only_z:
                continue
            ntv = view.getInt32(pos)
            nth = view.getInt32(pos + 4)
            num_bytes = view.getInt32(pos + 8)
            max_val = view.getFloat32(pos + 12)
            pos += 16
            payload_end = pos + num_bytes
            if num_bytes < 0 or payload_end > len(u8):
                err("truncated Lerc1 section")
            if not z_part and ntv == 0 and nth == 0:
                if num_bytes == 0:
                    cnt[:] = max_val
                    if max_val > 0:
                        ignore_mask = True
                else:
                    bits = rle_decompress(u8, pos, payload_end, (W * H + 7) >> 3)
                    for i in range(H * W):
                        cnt[i] = (bits[i >> 3] >> (7 - (i & 7))) & 1
            else:
                if ntv <= 0 or nth <= 0 or ntv > H or nth > W:
                    err("bad Lerc1 tile counts")
                p = pos
                for (i0, i1) in lerc1_tile_ranges(H, ntv):
                    for (j0, j1) in lerc1_tile_ranges(W, nth):
                        p = (read_z_tile(p, i0, i1, j0, j1, max_val) if z_part
                             else read_cnt_tile(p, i0, i1, j0, j1))
            pos = payload_end
        bands.append({"cnt": cnt.copy(), "z": z.copy()})
        only_z = True
        if pos >= len(u8):
            break
    if not bands:
        err("no Lerc1 bands decoded")
    return {"bands": bands, "H": H, "W": W, "maxZError": max_z_error}


# ---- public API -------------------------------------------------------------

def walk_bands(u8):
    first = read_header(u8)
    offsets = [0]
    n_uses_no_data = 1 if first["bPassNoDataValues"] else 0
    blob_size = first["blobSize"]
    n_masks = 1 if (DV(u8).getInt32(first["headerSize"]) > 0
                    or first["numValidPixel"] == 0) else 0
    masks_differ = False
    z_min, z_max, mze = first["zMin"], first["zMax"], first["maxZError"]
    try_next = first["version"] <= 5 or first["nBlobsMore"] > 0
    while try_next and blob_size < len(u8):
        try:
            h2 = read_header(u8[blob_size:])
        except LercError:
            break
        if (h2["nDepth"] != first["nDepth"] or h2["nCols"] != first["nCols"]
                or h2["nRows"] != first["nRows"] or h2["dt"] != first["dt"]):
            err("inconsistent band headers")
        try_next = h2["version"] <= 5 or h2["nBlobsMore"] > 0
        if h2["bPassNoDataValues"]:
            n_uses_no_data += 1
        nb_mask2 = DV(u8).getInt32(blob_size + h2["headerSize"])
        if nb_mask2 > 0 or h2["numValidPixel"] != first["numValidPixel"]:
            masks_differ = True
        if blob_size + h2["blobSize"] > len(u8):
            err("truncated blob")
        z_min = min(z_min, h2["zMin"])
        z_max = max(z_max, h2["zMax"])
        mze = max(mze, h2["maxZError"])
        offsets.append(blob_size)
        blob_size += h2["blobSize"]
    n_bands = len(offsets)
    return {
        "first": first, "offsets": offsets, "blobSize": blob_size,
        "zMin": z_min, "zMax": z_max, "maxZError": mze,
        "nMasks": n_bands if masks_differ else n_masks,
        "nUsesNoData": n_bands if n_uses_no_data > 0 else 0,
    }


def decode(u8, options=None):
    options = options or {}
    u8 = np.frombuffer(bytes(u8), np.uint8)
    if key_at(u8, 0, FILE_KEY_LERC1):
        r = lerc1_decode(u8)
        pixels = []
        band_masks = []
        any_masked = False
        combined = np.ones(r["W"] * r["H"], np.uint8)
        for b in r["bands"]:
            m = np.zeros(r["W"] * r["H"], np.uint8)
            for i in range(len(m)):
                m[i] = 1 if b["cnt"][i] > 0 else 0
                if not m[i]:
                    combined[i] = 0
                    any_masked = True
            px = np.zeros(r["W"] * r["H"], np.float32)
            for i in range(len(px)):
                px[i] = b["z"][i] if m[i] else 0
            pixels.append(px)
            band_masks.append(m)
        return {
            "width": r["W"], "height": r["H"], "pixelType": "F32",
            "pixels": pixels,
            "mask": combined if any_masked else None,
            "bandMasks": band_masks if len(r["bands"]) > 1 and any_masked else None,
            "dimCount": 1, "depthCount": 1,
        }

    walk = walk_bands(u8)
    first = walk["first"]
    H, W, D = first["nRows"], first["nCols"], first["nDepth"]
    verify = options.get("verifyChecksum", True)
    pixels = []
    band_masks = []
    prev_mask = None
    for off in walk["offsets"]:
        band = decode_band(u8[off:], prev_mask, verify)
        prev_mask = band["mask"]
        if band["h"]["bPassNoDataValues"]:
            old_v = cast_dt(band["h"]["noDataVal"], band["h"]["dt"])
            new_v = cast_dt(band["h"]["noDataValOrig"], band["h"]["dt"])
            if old_v != new_v:
                data = band["data"]
                mask = band["mask"]
                for i in range(H * W):
                    if mask is not None and not mask[i]:
                        continue
                    for d in range(D):
                        if data[i * D + d] == old_v:
                            store(data, i * D + d, new_v)
        pixels.append(band["data"])
        band_masks.append(band["mask"])
    mask = None
    masks_differ = False
    for m in band_masks:
        if m is not None:
            if mask is None:
                mask = m.copy()
            else:
                mask &= m
    if mask is not None:
        for m in band_masks:
            for i in range(len(mask)):
                if (m[i] if m is not None else 1) != mask[i]:
                    masks_differ = True
                    break
            if masks_differ:
                break
    interleaved = options.get("returnInterleaved",
                              options.get("returnPixelInterleavedDims"))
    out_pixels = pixels
    if D > 1 and not interleaved:
        out_pixels = []
        num_pixels = H * W
        for band in pixels:
            bsq = np.zeros_like(band)
            j = 0
            for i in range(num_pixels):
                t = i
                for d in range(D):
                    bsq[t] = band[j]
                    j += 1
                    t += num_pixels
            out_pixels.append(bsq)
    ndv = options.get("noDataValue")
    if ndv is not None and mask is not None:
        num_pixels = H * W
        for b in range(len(out_pixels)):
            bm = band_masks[b] if (masks_differ and band_masks[b] is not None) else mask
            band = out_pixels[b]
            for i in range(num_pixels):
                if bm[i]:
                    continue
                for d in range(D):
                    k = d * num_pixels + i if (D > 1 and not interleaved) else i * D + d
                    store(band, k, ndv)
    return {
        "width": W, "height": H, "pixelType": PIXEL_TYPE[first["dt"]],
        "pixels": out_pixels, "mask": mask,
        "bandMasks": ([m if m is not None else np.ones(H * W, np.uint8)
                       for m in band_masks] if masks_differ else None),
        "dimCount": D, "depthCount": D,
    }


def get_blob_info(u8):
    """Sim of lerc.js getBlobInfo: per-band statistics from the
    header/ranges sections alone (no pixel decode)."""
    u8 = np.frombuffer(bytes(u8), np.uint8)
    if key_at(u8, 0, FILE_KEY_LERC1):
        r = lerc1_decode(u8)
        b = r["bands"][0]
        valid = 0
        mn, mx = float("inf"), float("-inf")
        for i in range(r["W"] * r["H"]):
            if b["cnt"][i] > 0:
                valid += 1
                z = float(b["z"][i])
                mn = min(mn, z)
                mx = max(mx, z)
        return {"version": 0, "width": r["W"], "height": r["H"],
                "bandCount": len(r["bands"]), "validPixelCount": valid,
                "minValue": mn, "maxValue": mx, "statistics": []}
    walk = walk_bands(u8)
    h = walk["first"]
    statistics = []
    view2 = DV(u8)
    for off in walk["offsets"]:
        bh = read_header(u8[off:])
        p = off + bh["headerSize"]
        nbm = view2.getInt32(p)
        p += 4 + max(nbm, 0)
        if bh["numValidPixel"] == 0:
            statistics.append({"minValue": 0, "maxValue": 0})
        elif bh["version"] < 4 or bh["zMin"] == bh["zMax"] or bh["nDepth"] == 1:
            statistics.append({"minValue": bh["zMin"], "maxValue": bh["zMax"]})
        else:
            mins, maxs = [], []
            for _ in range(bh["nDepth"]):
                v, n = read_variable_value(view2, p, bh["dt"])
                mins.append(v)
                p += n
            for _ in range(bh["nDepth"]):
                v, n = read_variable_value(view2, p, bh["dt"])
                maxs.append(v)
                p += n
            statistics.append({"minValue": min(mins), "maxValue": max(maxs),
                               "depthStats": {"minValues": mins, "maxValues": maxs}})
    return {"version": h["version"], "width": h["nCols"], "height": h["nRows"],
            "bandCount": len(walk["offsets"]),
            "validPixelCount": h["numValidPixel"],
            "minValue": walk["zMin"], "maxValue": walk["zMax"],
            "statistics": statistics}
