"""Executable simulation of bindings/csharp/LercDecode.cs.

Transliterates the C# decoder statement-for-statement with exact C#
semantics -- fixed-width wraps are explicit masks in BOTH files, (float)
casts become np.float32, C# Math.Min/Max NaN propagation and truncated
fmod are modeled by helpers -- so a logic error in the C# algorithms
fails the CI conformance matrix (tests/test_cs_binding.py) against the
C++ reference oracle. This build environment has no .NET runtime; this
file is the executable twin (same approach as bindings/js/js_sim.py for
lerc.js, which additionally has a browser harness).

Function names and control flow intentionally mirror LercDecode.cs.
"""
import math
import struct

import numpy as np

# ---- sim-drift tripwire: the "statement-exact twin"
# premise silently rots if LercDecode.cs is edited without a matching sim
# edit. Pin the binding's content hash; conformance tests verify it BEFORE
# any decode runs. After editing BOTH files, refresh with:
#   sha256sum bindings/csharp/LercDecode.cs
PINNED_BINDING_SHA256 = "235b6b95c23ed4be10b92e131153c8af1c078bdcaa43b0a404660006d01258c0"


def check_binding_in_sync():
    """Raise if LercDecode.cs changed since this sim was last synchronized."""
    import hashlib
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "LercDecode.cs")
    actual = hashlib.sha256(open(path, "rb").read()).hexdigest()
    if actual != PINNED_BINDING_SHA256:
        raise AssertionError(
            f"bindings/csharp/LercDecode.cs hash {actual} != pinned "
            f"{PINNED_BINDING_SHA256}: LercDecode.cs was edited without "
            "updating cs_sim.py. Port the change to the sim "
            "(statement-for-statement), then refresh PINNED_BINDING_SHA256."
        )

OK = 0
FAILED = 1
WRONG_PARAM = 2
BUFFER_TOO_SMALL = 3
NAN_ERR = 4
HAS_NO_DATA = 5

DT_CHAR, DT_BYTE, DT_SHORT, DT_USHORT, DT_INT, DT_UINT, DT_FLOAT, DT_DOUBLE = range(8)
DT_SIZE = [1, 1, 2, 2, 4, 4, 4, 8]
FILE_KEY_LERC2 = b"Lerc2 "
FILE_KEY_LERC1 = b"CntZImage "
NP_DT = [np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32,
         np.float32, np.float64]


class LercError(Exception):
    pass


def err(msg):
    raise LercError("Lerc: " + msg)


# ------------------------------------------------------------ bytes

def need(u8, pos, n):
    if pos < 0 or n < 0 or pos + n > len(u8):
        err("read past end of blob")


def u8_(u8, pos):
    need(u8, pos, 1)
    return u8[pos]


def i8_(u8, pos):
    need(u8, pos, 1)
    v = u8[pos]
    return v - 256 if v >= 128 else v


def u16_(u8, pos):
    need(u8, pos, 2)
    return u8[pos] | (u8[pos + 1] << 8)


def i16_(u8, pos):
    v = u16_(u8, pos)
    return v - 65536 if v >= 32768 else v


def u32_(u8, pos):
    need(u8, pos, 4)
    return u8[pos] | (u8[pos + 1] << 8) | (u8[pos + 2] << 16) | (u8[pos + 3] << 24)


def i32_(u8, pos):
    v = u32_(u8, pos)
    return v - 4294967296 if v >= 2147483648 else v


def f32_(u8, pos):
    need(u8, pos, 4)
    # C# BitConverter.Int32BitsToSingle then implicit widen to double
    return float(struct.unpack_from("<f", u8, pos)[0])


def f64_(u8, pos):
    need(u8, pos, 8)
    return struct.unpack_from("<d", u8, pos)[0]


def key_at(u8, pos, key):
    return bytes(u8[pos : pos + len(key)]) == key


def csfloat(v):
    """C# (float) cast: round double to float32, back to double."""
    return float(np.float32(v))


def min_d(a, b):
    """C# Math.Min(double, double): NaN if either operand is NaN."""
    if math.isnan(a) or math.isnan(b):
        return math.nan
    return a if a < b else b


def max_d(a, b):
    if math.isnan(a) or math.isnan(b):
        return math.nan
    return a if a > b else b


def trunc_mod32(v):
    """C# TruncMod32: truncate toward zero, reduce mod 2^32 into [0, 2^32)."""
    if math.isnan(v) or math.isinf(v):
        return 0
    t = math.fmod(float(np.trunc(v)), 4294967296.0)  # fmod on doubles is exact
    w = int(t)
    return w & 0xFFFFFFFF


def cast_dt(v, dt):
    if dt == DT_CHAR:
        s = trunc_mod32(v) & 0xFF
        return float(s - 256 if s >= 128 else s)
    if dt == DT_BYTE:
        return float(trunc_mod32(v) & 0xFF)
    if dt == DT_SHORT:
        s = trunc_mod32(v) & 0xFFFF
        return float(s - 65536 if s >= 32768 else s)
    if dt == DT_USHORT:
        return float(trunc_mod32(v) & 0xFFFF)
    if dt == DT_INT:
        s = trunc_mod32(v)
        return float(s - 4294967296 if s >= 2147483648 else s)
    if dt == DT_UINT:
        return float(trunc_mod32(v))
    if dt == DT_FLOAT:
        return csfloat(v)
    return v


def fletcher32(u8, start, end):
    s1, s2 = 0xFFFF, 0xFFFF
    i = start
    while i < end - 1:
        t = min(1 << 20, (end - i) >> 1)
        while t > 0:
            t -= 1
            s1 += u8[i] * 256 + u8[i + 1]
            s2 += s1
            i += 2
        s1 %= 65535
        s2 %= 65535
    if i < end:
        s1 = (s1 + u8[i] * 256) % 65535
        s2 = (s2 + s1) % 65535
    if s1 == 0:
        s1 = 65535
    if s2 == 0:
        s2 = 65535
    return s2 * 65536 + s1


# ------------------------------------------------------------ header

class Header:
    pass


def read_header(u8, off):
    if not key_at(u8, off, FILE_KEY_LERC2):
        err("not a Lerc2 blob")
    pos = off + len(FILE_KEY_LERC2)
    h = Header()
    h.version = i32_(u8, pos); pos += 4
    if h.version < 0 or h.version > 6:
        err("unsupported codec version")
    h.checksum = 0
    if h.version >= 3:
        h.checksum = u32_(u8, pos); pos += 4
    h.nRows = i32_(u8, pos); pos += 4
    h.nCols = i32_(u8, pos); pos += 4
    h.nDepth = 1
    if h.version >= 4:
        h.nDepth = i32_(u8, pos); pos += 4
    h.numValidPixel = i32_(u8, pos); pos += 4
    h.microBlockSize = i32_(u8, pos); pos += 4
    h.blobSize = i32_(u8, pos); pos += 4
    h.dt = i32_(u8, pos); pos += 4
    h.nBlobsMore = 0; h.bPassNoDataValues = 0; h.bIsInt = 0
    if h.version >= 6:
        h.nBlobsMore = i32_(u8, pos); pos += 4
        h.bPassNoDataValues = u8_(u8, pos); h.bIsInt = u8_(u8, pos + 1); pos += 4
    h.maxZError = f64_(u8, pos); pos += 8
    h.zMin = f64_(u8, pos); pos += 8
    h.zMax = f64_(u8, pos); pos += 8
    h.noDataVal = 0.0; h.noDataValOrig = 0.0
    if h.version >= 6:
        h.noDataVal = f64_(u8, pos); pos += 8
        h.noDataValOrig = f64_(u8, pos); pos += 8
    if (h.nRows <= 0 or h.nCols <= 0 or h.nDepth <= 0 or h.numValidPixel < 0
            or h.microBlockSize <= 0 or h.microBlockSize > 32 or h.blobSize <= 0
            or h.dt < 0 or h.dt > 7):
        err("malformed Lerc2 header")
    numPixel = h.nRows * h.nCols
    if (numPixel > 0x7FFFFFFF or h.numValidPixel > numPixel
            or DT_SIZE[h.dt] * h.nDepth * numPixel > 0x7FFFFFFF):
        err("dimensions too large")
    h.headerSize = pos - off
    return h


def try_huffman_int(h):
    return h.version >= 2 and h.dt in (DT_BYTE, DT_CHAR) and h.maxZError == 0.5


def try_huffman_flt(h):
    return h.version >= 6 and h.dt in (DT_FLOAT, DT_DOUBLE) and h.maxZError == 0


# ------------------------------------------------------------ RLE + mask

def rle_decompress(u8, pos, end, expected):
    out = bytearray(expected)
    o = 0
    while True:
        if pos + 2 > end:
            err("truncated RLE stream")
        cnt = i16_(u8, pos); pos += 2
        if cnt == -32768:
            break
        if cnt > 0:
            if pos + cnt > end or o + cnt > expected:
                err("corrupt RLE stream")
            out[o : o + cnt] = u8[pos : pos + cnt]
            o += cnt; pos += cnt
        else:
            n = -cnt
            if pos + 1 > end or o + n > expected:
                err("corrupt RLE stream")
            out[o : o + n] = bytes([u8[pos]]) * n
            o += n; pos += 1
    if o != expected:
        err("RLE output size mismatch")
    return bytes(out)


def bits_to_mask(bits, n_pixels):
    mask = bytearray(n_pixels)
    for i in range(n_pixels):
        mask[i] = (bits[i >> 3] >> (7 - (i & 7))) & 1
    return mask


# ------------------------------------------------------------ bitstuffer

def bit_unpack(u8, pos, n, num_bits, out):
    if num_bits == 0:
        for i in range(n):
            out[i] = 0
        return 0
    nbytes = (n * num_bits + 7) >> 3
    need(u8, pos, nbytes)
    bit_pos = 0
    for i in range(n):
        v = 0
        for b in range(num_bits):
            v |= ((u8[pos + (bit_pos >> 3)] >> (bit_pos & 7)) & 1) << b
            bit_pos += 1
        out[i] = v
    return nbytes


def bit_unpack_legacy(u8, pos, n, num_bits, out):
    if num_bits == 0:
        for i in range(n):
            out[i] = 0
        return 0
    nbytes = (n * num_bits + 7) >> 3
    num_uints = (n * num_bits + 31) >> 5
    need(u8, pos, nbytes)
    words = [0] * num_uints
    for w in range(num_uints):
        b0 = pos + 4 * w
        v = 0
        for k in range(4):
            v |= (u8[b0 + k] if b0 + k < pos + nbytes else 0) << (8 * k)
        words[w] = v
    num_bits_tail = (n * num_bits) & 31
    num_bytes_tail = (num_bits_tail + 7) >> 3
    ntbnn = 4 - num_bytes_tail if num_bytes_tail > 0 else 0
    if ntbnn != 0:
        words[num_uints - 1] = (words[num_uints - 1] << (8 * ntbnn)) & 0xFFFFFFFF
    bit_pos = 0
    for i in range(n):
        v = 0
        for b in range(num_bits):
            bit = (words[bit_pos >> 5] >> (31 - (bit_pos & 31))) & 1
            v = v * 2 + bit
            bit_pos += 1
        out[i] = v
    return nbytes


def unpack_for_version(u8, pos, n, num_bits, version, out):
    if version >= 3:
        return bit_unpack(u8, pos, n, num_bits, out)
    return bit_unpack_legacy(u8, pos, n, num_bits, out)


def stuffed_decode(u8, pos, max_element_count, version):
    """Returns (vals, new_pos) -- the C# ref-int is a return here."""
    header = u8_(u8, pos); p = pos + 1
    bits67 = header >> 6
    w = 4 if bits67 == 0 else 3 - bits67
    do_lut = (header & 32) != 0
    num_bits = header & 31
    n = 0
    for k in range(w):
        n |= u8_(u8, p + k) << (8 * k)
    p += w
    if n > max_element_count:
        err("stuffed element count exceeds limit")
    if not do_lut:
        vals = [0] * n
        p += unpack_for_version(u8, p, n, num_bits, version, vals)
        return vals, p
    if num_bits == 0:
        err("corrupt LUT block")
    n_lut = u8_(u8, p) - 1; p += 1
    if n_lut < 0:
        err("corrupt LUT block")
    lut = [0] * n_lut
    p += unpack_for_version(u8, p, n_lut, num_bits, version, lut)
    nbits_lut = 0
    t = n_lut
    while t != 0:
        nbits_lut += 1
        t >>= 1
    if nbits_lut == 0:
        err("corrupt LUT block")
    idx = [0] * n
    p += unpack_for_version(u8, p, n, nbits_lut, version, idx)
    out = [0] * n
    for i in range(n):
        j = idx[i]
        if j > n_lut:
            err("LUT index out of range")
        out[i] = 0 if j == 0 else lut[j - 1]
    return out, p

# ------------------------------------------------------------ Huffman

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
            bit = (u8_(self.u8, byte_idx) >> (7 - (bp & 7))) & 1
            v = v * 2 + bit
        self.bitPos += n_bits
        return v


class CodeTable:
    pass


def read_code_table(u8, pos, version):
    hf_version = i32_(u8, pos)
    size = i32_(u8, pos + 4)
    i0 = i32_(u8, pos + 8)
    i1 = i32_(u8, pos + 12)
    p = pos + 16
    if hf_version < 2:
        err("unsupported huffman version")
    if i0 >= i1 or i0 < 0 or size <= 0 or size > (1 << 15):
        err("corrupt huffman code table")
    vals, p = stuffed_decode(u8, p, i1 - i0, version)
    if len(vals) < i1 - i0:
        err("corrupt huffman code table")
    lengths = [0] * size
    for k in range(i0, i1):
        lengths[k % size] = vals[k - i0]
    total_bits = 0
    max_len = 0
    for k in range(i0, i1):
        L = lengths[k % size]
        if L > 32:
            err("corrupt huffman code lengths")
        total_bits += L
        if L > max_len:
            max_len = L
    num_words = (total_bits + 31) >> 5
    codes = [0] * size
    br = BitReaderMSB(u8, p)
    for k in range(i0, i1):
        L = lengths[k % size]
        if L > 0:
            codes[k % size] = br.read(L)
    p += 4 * num_words
    tbl = CodeTable()
    tbl.lengths = lengths
    tbl.codes = codes
    tbl.maxLen = max_len
    tbl.pos = p
    return tbl


def build_decode_tables(lengths, codes, max_len):
    first = [-1] * (max_len + 1)
    syms_by_len = [[] for _ in range(max_len + 1)]
    for s in range(len(lengths)):
        L = lengths[s]
        if L > 0:
            syms_by_len[L].append(s)
    for L in range(1, max_len + 1):
        syms_by_len[L].sort(key=lambda a: codes[a])
        if syms_by_len[L]:
            first[L] = codes[syms_by_len[L][0]]
    return first, syms_by_len


def decode_symbols(u8, pos, tbl, n_symbols, out):
    first, syms_by_len = build_decode_tables(tbl.lengths, tbl.codes, tbl.maxLen)
    br = BitReaderMSB(u8, pos)
    total_bits = (len(u8) - pos) * 8
    for i in range(n_symbols):
        c = 0
        L = 0
        sym = -1
        while L < tbl.maxLen:
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
    if signed:
        return float(trunc_mod32(data[idx]) & 255)
    return float(data[idx])


def decode_huffman_image(u8, pos, h, mode, mask, data):
    H, W, D = h.nRows, h.nCols, h.nDepth
    signed = h.dt == DT_CHAR
    tbl = read_code_table(u8, pos, h.version)
    if tbl.maxLen == 0:
        err("empty huffman code table")
    n_valid = 0
    for i in range(H * W):
        n_valid += mask[i] if mask is not None else 1
    n_symbols = n_valid * D
    syms = [0] * n_symbols
    decode_symbols(u8, tbl.pos, tbl, n_symbols, syms)
    off = 128 if signed else 0

    if mode == 2:  # direct: pixel-major, D values per valid pixel
        t = 0
        for i in range(H * W):
            if mask is not None and mask[i] == 0:
                continue
            for d in range(D):
                data[i * D + d] = float(syms[t] - off)
                t += 1
        return
    # delta (mode 1): depth-major, row-scan delta chain in mod-256 space
    all_valid = n_valid == H * W
    for d in range(D):
        prev = 0
        t = d * n_valid
        if all_valid:
            for i in range(H):
                for j in range(W):
                    if j == 0 and i > 0:
                        v = (int(data8(data, ((i - 1) * W) * D + d, signed))
                             + syms[d * H * W + i * W] - off) & 255
                    else:
                        v = (prev + syms[d * H * W + i * W + j] - off) & 255
                    s = v & 255
                    data[(i * W + j) * D + d] = float(s - 256 if signed and s >= 128 else s)
                    prev = v & 255
        else:
            for i in range(H):
                for j in range(W):
                    if mask[i * W + j] == 0:
                        continue
                    left_ok = j > 0 and mask[i * W + j - 1] != 0
                    above_ok = i > 0 and mask[(i - 1) * W + j] != 0
                    if not left_ok and above_ok:
                        base_v = int(data8(data, ((i - 1) * W + j) * D + d, signed))
                    else:
                        base_v = prev
                    v = (base_v + syms[t] - off) & 255
                    t += 1
                    s = v & 255
                    data[(i * W + j) * D + d] = float(s - 256 if signed and s >= 128 else s)
                    prev = v


# ------------------------------------------------------------ tiling

def data_type_used(dt, tc):
    if dt in (DT_SHORT, DT_INT):
        return dt - tc
    if dt in (DT_USHORT, DT_UINT):
        return dt - 2 * tc
    if dt == DT_FLOAT:
        return dt if tc == 0 else (DT_SHORT if tc == 1 else DT_BYTE)
    if dt == DT_DOUBLE:
        return dt if tc == 0 else dt - 2 * tc + 1
    return dt


def read_variable_value(u8, pos, dt_used):
    """Returns (v, new_pos) -- the C# ref-int is a return here."""
    if dt_used == DT_CHAR:
        return float(i8_(u8, pos)), pos + 1
    if dt_used == DT_BYTE:
        return float(u8_(u8, pos)), pos + 1
    if dt_used == DT_SHORT:
        return float(i16_(u8, pos)), pos + 2
    if dt_used == DT_USHORT:
        return float(u16_(u8, pos)), pos + 2
    if dt_used == DT_INT:
        return float(i32_(u8, pos)), pos + 4
    if dt_used == DT_UINT:
        return float(u32_(u8, pos)), pos + 4
    if dt_used == DT_FLOAT:
        return f32_(u8, pos), pos + 4
    return f64_(u8, pos), pos + 8


def read_tiles(u8, pos, h, mask, data, z_max_vec):
    H, W, D, mb = h.nRows, h.nCols, h.nDepth, h.microBlockSize
    dt_is_int = h.dt < DT_FLOAT
    inv_scale = 2 * h.maxZError
    ntv = (H + mb - 1) // mb
    nth = (W + mb - 1) // mb
    for it in range(ntv):
        i0 = it * mb
        i1 = min(i0 + mb, H)
        for jt in range(nth):
            j0 = jt * mb
            j1 = min(j0 + mb, W)
            n_valid = 0
            for i in range(i0, i1):
                for j in range(j0, j1):
                    n_valid += mask[i * W + j] if mask is not None else 1
            for d in range(D):
                compr_flag = u8_(u8, pos); pos += 1
                b_diff = h.version >= 5 and (compr_flag & 4) != 0
                pattern = 14 if h.version >= 5 else 15
                if ((compr_flag >> 2) & pattern) != ((j0 >> 3) & pattern):
                    err("micro-block integrity check failed")
                if b_diff and d == 0:
                    err("diff encoding on depth slice 0")
                bits67 = compr_flag >> 6
                code = compr_flag & 3
                z_max = z_max_vec[d] if (h.version >= 4 and D > 1) else h.zMax

                if code == 2:  # const 0 / diff-equal
                    if b_diff:
                        for i in range(i0, i1):
                            for j in range(j0, j1):
                                if mask is None or mask[i * W + j] != 0:
                                    data[(i * W + j) * D + d] = data[(i * W + j) * D + d - 1]
                    continue
                if code == 0:  # raw
                    if b_diff:
                        err("raw block cannot be diff encoded")
                    for i in range(i0, i1):
                        for j in range(j0, j1):
                            if mask is not None and mask[i * W + j] == 0:
                                continue
                            data[(i * W + j) * D + d], pos = read_variable_value(u8, pos, h.dt)
                    continue
                # code 1 / 3: offset (+ stuffed values for code 1)
                base_dt = DT_INT if b_diff and dt_is_int else h.dt
                offset, pos = read_variable_value(u8, pos, data_type_used(base_dt, bits67))
                if code == 3:  # const offset
                    for i in range(i0, i1):
                        for j in range(j0, j1):
                            if mask is not None and mask[i * W + j] == 0:
                                continue
                            k = (i * W + j) * D + d
                            if b_diff:
                                data[k] = cast_dt(min_d(offset + data[k - 1], z_max), h.dt)
                            else:
                                data[k] = cast_dt(offset, h.dt)
                    continue
                # code 1: bit-stuffed quantized values
                max_elem = (i1 - i0) * (j1 - j0)
                vals, pos = stuffed_decode(u8, pos, max_elem, h.version)
                dense = len(vals) == max_elem
                if not dense and len(vals) < n_valid:
                    err("not enough stuffed values")
                t = 0
                for i in range(i0, i1):
                    for j in range(j0, j1):
                        valid = mask is None or mask[i * W + j] != 0
                        if dense:
                            q = vals[(i - i0) * (j1 - j0) + (j - j0)]
                        else:
                            if not valid:
                                continue
                            q = vals[t]
                            t += 1
                        if not valid:
                            continue
                        k = (i * W + j) * D + d
                        z = offset + q * inv_scale
                        if b_diff:
                            z += data[k - 1]
                        data[k] = cast_dt(min_d(z, z_max), h.dt)
    return pos

# ------------------------------------------------------------ fpl

def decode_packbits(u8, pos, end, expected, out):
    o = 0
    i = pos
    while i < end:
        b = u8[i]; i += 1
        if b <= 127:
            n = b + 1
            if o + n > expected or i + n > end:
                err("corrupt PackBits stream")
            out[o : o + n] = u8[i : i + n]
            o += n; i += n
        else:
            n = b - 126
            if o + n > expected or i >= end:
                err("corrupt PackBits stream")
            out[o : o + n] = bytes([u8[i]]) * n
            o += n; i += 1
    if o != expected:
        err("PackBits output size mismatch")


def extract_plane(u8, pos, end, expected, version):
    method = u8_(u8, pos)
    out = bytearray(expected)
    if method == 1:  # RLE-const
        if end - pos < 6:
            err("truncated RLE-const plane")
        cnt = u32_(u8, pos + 2)
        if cnt != expected:
            err("RLE-const size mismatch")
        out[:] = bytes([u8[pos + 1]]) * expected
        return out
    if method == 2:  # raw
        if end - pos - 1 < expected:
            err("truncated raw plane")
        out[:] = u8[pos + 1 : pos + 1 + expected]
        return out
    if method == 3:  # PackBits
        decode_packbits(u8, pos + 1, end, expected, out)
        return out
    if method != 0:
        err("unknown fpl plane method")
    tbl = read_code_table(u8, pos + 1, 5)
    syms = [0] * expected
    decode_symbols(u8, tbl.pos, tbl, expected, syms)
    for i in range(expected):
        out[i] = syms[i] & 255
    return out


def restore_sequence(plane, level):
    for lev in range(level, 0, -1):
        acc = plane[lev - 1]
        for i in range(lev, len(plane)):
            acc = (acc + plane[i]) & 255
            plane[i] = acc


def cumsum_split_f32(words, rows, cols, axis):
    M = 0x7FFFFF
    outer = rows if axis == 1 else cols
    inner = cols if axis == 1 else rows
    step = 1 if axis == 1 else cols
    for o in range(outer):
        m = 0
        hi = 0
        k = o * cols if axis == 1 else o
        for _ in range(inner):
            w = words[k]
            m = (m + (w & M)) & M
            hi = (hi + (w >> 23)) & 0x1FF
            words[k] = (hi << 23) | m
            k += step


def cumsum_split_f64(lo, hi, rows, cols, axis):
    P32 = 4294967296
    M52 = 1 << 52
    outer = rows if axis == 1 else cols
    inner = cols if axis == 1 else rows
    step = 1 if axis == 1 else cols
    for o in range(outer):
        m_acc = 0
        e_acc = 0
        k = o * cols if axis == 1 else o
        for _ in range(inner):
            m = (hi[k] & 0xFFFFF) * P32 + lo[k]
            e = hi[k] >> 20
            m_acc = (m_acc + m) % M52
            e_acc = (e_acc + e) & 0xFFF
            lo[k] = m_acc % P32
            hi[k] = (m_acc // P32) | (e_acc << 20)
            k += step


def undo_float_transform(words):
    M = 0x7FFFFF
    for i in range(len(words)):
        u = words[i]
        mant = u & M
        ae = (u >> 24) & 0xFF
        sign = (u >> 23) & 1
        words[i] = (sign << 31) | (ae << 23) | mant


def decode_fpl(u8, pos, h, data):
    H, W, D = h.nRows, h.nCols, h.nDepth
    is_double = h.dt == DT_DOUBLE
    unit_size = 8 if is_double else 4
    cols = W if D == 1 else D
    rows = H if D == 1 else W * H
    expected = rows * cols
    pred = u8_(u8, pos); pos += 1
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
        csize = u32_(u8, pos + 2)
        pos += 6
        if csize < 1 or len(u8) - pos < csize:
            err("truncated fpl plane payload")
        plane = extract_plane(u8, pos, pos + csize, expected, h.version)
        pos += csize
        restore_sequence(plane, best_level)
        planes[byte_index] = plane
    for s in range(unit_size):
        if planes[s] is None:
            err("missing fpl plane")
    if not is_double:
        words = [0] * expected
        for i in range(expected):
            words[i] = (planes[0][i] | (planes[1][i] << 8)
                        | (planes[2][i] << 16) | (planes[3][i] << 24))
        if pred == 2:
            cumsum_split_f32(words, rows, cols, 0)
        if pred >= 1:
            cumsum_split_f32(words, rows, cols, 1)
        undo_float_transform(words)
        for i in range(expected):
            data[i] = float(struct.unpack("<f", struct.pack("<I", words[i]))[0])
    else:
        lo = [0] * expected
        hi = [0] * expected
        for i in range(expected):
            lo[i] = (planes[0][i] | (planes[1][i] << 8)
                     | (planes[2][i] << 16) | (planes[3][i] << 24))
            hi[i] = (planes[4][i] | (planes[5][i] << 8)
                     | (planes[6][i] << 16) | (planes[7][i] << 24))
        if pred == 2:
            cumsum_split_f64(lo, hi, rows, cols, 0)
        if pred >= 1:
            cumsum_split_f64(lo, hi, rows, cols, 1)
        for i in range(expected):
            data[i] = struct.unpack("<d", struct.pack("<Q", lo[i] | (hi[i] << 32)))[0]


# ------------------------------------------------------------ band decode

class Band:
    pass


def decode_band(u8, off, prev_mask, verify_checksum):
    h = read_header(u8, off)
    if len(u8) - off < h.blobSize:
        err("buffer shorter than blobSize")
    if h.version >= 3 and verify_checksum:
        skip = off + len(FILE_KEY_LERC2) + 4 + 4
        if fletcher32(u8, skip, off + h.blobSize) != h.checksum:
            err("checksum mismatch")
    H, W, D = h.nRows, h.nCols, h.nDepth
    pos = off + h.headerSize

    num_bytes_mask = i32_(u8, pos); pos += 4
    if num_bytes_mask < 0 or num_bytes_mask > len(u8) - pos:
        err("bad mask section size")
    num_total = H * W
    mask = None  # None = all valid
    if h.numValidPixel == 0:
        mask = bytearray(num_total)  # all invalid
    elif h.numValidPixel != num_total:
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

    data = [0.0] * (num_total * D)
    band = Band()
    band.h = h
    band.mask = mask
    band.data = data
    band.zMinVec = None
    band.zMaxVec = None
    if h.numValidPixel == 0:
        return band

    if h.zMin == h.zMax:  # constant image: no ranges section on the wire
        for i in range(num_total):
            if mask is not None and mask[i] == 0:
                continue
            for d in range(D):
                data[i * D + d] = cast_dt(h.zMin, h.dt)
        return band

    z_max_vec = None
    if h.version >= 4:
        z_mins = [0.0] * D
        z_maxs = [0.0] * D
        for d in range(D):
            z_mins[d], pos = read_variable_value(u8, pos, h.dt)
        for d in range(D):
            z_maxs[d], pos = read_variable_value(u8, pos, h.dt)
        band.zMinVec = z_mins
        band.zMaxVec = z_maxs
        z_max_vec = z_maxs
        all_eq = True
        for d in range(D):
            if z_mins[d] != z_maxs[d]:
                all_eq = False
        if all_eq:  # per-depth constant image
            for i in range(num_total):
                if mask is not None and mask[i] == 0:
                    continue
                for d in range(D):
                    data[i * D + d] = cast_dt(h.zMin if D == 1 else z_mins[d], h.dt)
            return band

    one_sweep = u8_(u8, pos); pos += 1
    if one_sweep != 0:
        for i in range(num_total):
            if mask is not None and mask[i] == 0:
                continue
            for d in range(D):
                data[i * D + d], pos = read_variable_value(u8, pos, h.dt)
        return band

    if try_huffman_int(h) or try_huffman_flt(h):
        flag = u8_(u8, pos); pos += 1
        if flag > 3 or (flag > 2 and h.version < 6) or (flag > 1 and h.version < 4):
            err("bad image encode mode flag")
        if flag != 0:
            if try_huffman_int(h) and (flag == 1 or (h.version >= 4 and flag == 2)):
                decode_huffman_image(u8, pos, h, flag, mask, data)
                return band
            if try_huffman_flt(h) and flag == 3:
                decode_fpl(u8, pos, h, data)
                return band
            err("bad image encode mode")
    read_tiles(u8, pos, h, mask, data, z_max_vec)
    return band

# ------------------------------------------------------------ Lerc1

class Lerc1Result:
    def __init__(self):
        self.cnts = []
        self.zs = []
        self.endPos = 0


def lerc1_read_stuffed(u8, pos):
    num_bits_byte = u8_(u8, pos); pos += 1
    bits67 = num_bits_byte >> 6
    n = 4 if bits67 == 0 else 3 - bits67
    num_bits = num_bits_byte & 63
    num_elements = 0
    for k in range(n):
        num_elements |= u8_(u8, pos + k) << (8 * k)
    pos += n
    if num_bits >= 32:
        err("corrupt legacy bitstuffer block")
    if num_elements > 1600000000:
        err("corrupt legacy element count")
    vals = [0] * num_elements
    pos += bit_unpack_legacy(u8, pos, num_elements, num_bits, vals)
    return vals, pos


def lerc1_read_flt(u8, pos, n):
    if n == 1:
        return float(i8_(u8, pos)), pos + 1
    if n == 2:
        return float(i16_(u8, pos)), pos + 2
    if n == 4:
        return f32_(u8, pos), pos + 4
    err("bad float width")


def lerc1_tile_ranges(total, num_tiles):
    t = total // num_tiles
    out = []
    for k in range(num_tiles + 1):
        size = t if k < num_tiles else total % num_tiles
        if size > 0:
            out.append((k * t, k * t + size))
    return out


def lerc1_decode(u8):
    if not key_at(u8, 0, FILE_KEY_LERC1):
        err("not a Lerc1 blob")
    version = i32_(u8, 10)
    typ = i32_(u8, 14)
    H = i32_(u8, 18)
    W = i32_(u8, 22)
    max_z_error = f64_(u8, 26)
    if version != 11 or typ != 8:
        err("unsupported Lerc1 version/type")
    if H < 0 or W < 0 or H > 40000 or W > 40000:
        err("Lerc1 dimensions out of range")
    HDR = 10 + 16 + 8
    pos = HDR
    # float[] semantics: every store rounds to float32 (np.float32 array)
    cnt = np.zeros(H * W, np.float32)
    z = np.zeros(H * W, np.float32)
    res = Lerc1Result()
    res.H = H
    res.W = W
    res.maxZError = max_z_error
    only_z = False
    state = {"ignore_mask": False}

    def read_cnt_tile(p, ri0, ri1, rj0, rj1):
        flag = u8_(u8, p); p += 1
        if flag == 2:
            for i in range(ri0, ri1):
                cnt[i * W + rj0 : i * W + rj1] = 0
            return p
        if flag in (3, 4):
            v = -1.0 if flag == 3 else 1.0
            for i in range(ri0, ri1):
                cnt[i * W + rj0 : i * W + rj1] = v
            return p
        if (flag & 63) > 4:
            err("bad Lerc1 cnt tile flag")
        if flag == 0:
            for i in range(ri0, ri1):
                for j in range(rj0, rj1):
                    cnt[i * W + j] = f32_(u8, p)
                    p += 4
            return p
        bits67 = flag >> 6
        n = 4 if bits67 == 0 else 3 - bits67
        base_v, p = lerc1_read_flt(u8, p, n)
        vals, p = lerc1_read_stuffed(u8, p)
        t = 0
        for i in range(ri0, ri1):
            for j in range(rj0, rj1):
                cnt[i * W + j] = np.float32(base_v + vals[t])
                t += 1
        return p

    def read_z_tile(p, ri0, ri1, rj0, rj1, max_z_img):
        flag = u8_(u8, p); p += 1
        bits67 = flag >> 6
        flag &= 63
        if flag == 2:
            for i in range(ri0, ri1):
                for j in range(rj0, rj1):
                    if cnt[i * W + j] > 0:
                        z[i * W + j] = 0
            return p
        if flag > 3:
            err("bad Lerc1 z tile flag")
        if flag == 0:
            for i in range(ri0, ri1):
                for j in range(rj0, rj1):
                    if cnt[i * W + j] > 0:
                        z[i * W + j] = f32_(u8, p)
                        p += 4
            return p
        n = 4 if bits67 == 0 else 3 - bits67
        base_v, p = lerc1_read_flt(u8, p, n)
        if flag == 3:
            for i in range(ri0, ri1):
                for j in range(rj0, rj1):
                    if cnt[i * W + j] > 0:
                        z[i * W + j] = np.float32(base_v)
            return p
        vals, p = lerc1_read_stuffed(u8, p)
        inv_scale = 2 * max_z_error
        t = 0
        for i in range(ri0, ri1):
            for j in range(rj0, rj1):
                if state["ignore_mask"]:
                    z[i * W + j] = np.float32(min_d(base_v + vals[t] * inv_scale, max_z_img))
                    t += 1
                elif cnt[i * W + j] > 0:
                    z[i * W + j] = np.float32(min_d(base_v + vals[t] * inv_scale, max_z_img))
                    t += 1
        return p

    hdr_next_band = HDR + 12 + 4 + 1
    while pos + (hdr_next_band if only_z else 0) < len(u8):
        if only_z:
            if not key_at(u8, pos, FILE_KEY_LERC1):
                break
            h2 = i32_(u8, pos + 18)
            w2 = i32_(u8, pos + 22)
            if h2 != H or w2 != W:
                err("inconsistent Lerc1 band header")
            max_z_error = f64_(u8, pos + 26)
            pos += HDR
        for part in range(2):
            z_part = part == 1
            if not z_part and only_z:
                continue
            ntv = i32_(u8, pos)
            nth = i32_(u8, pos + 4)
            num_bytes = i32_(u8, pos + 8)
            max_val = f32_(u8, pos + 12)
            pos += 16
            payload_end = pos + num_bytes
            if num_bytes < 0 or payload_end > len(u8):
                err("truncated Lerc1 section")
            if not z_part and ntv == 0 and nth == 0:
                if num_bytes == 0:
                    cnt[:] = np.float32(max_val)
                    if max_val > 0:
                        state["ignore_mask"] = True
                else:
                    bits = rle_decompress(u8, pos, payload_end, (W * H + 7) >> 3)
                    for i in range(H * W):
                        cnt[i] = (bits[i >> 3] >> (7 - (i & 7))) & 1
            else:
                if ntv <= 0 or nth <= 0 or ntv > H or nth > W:
                    err("bad Lerc1 tile counts")
                p = pos
                for ir in lerc1_tile_ranges(H, ntv):
                    for jr in lerc1_tile_ranges(W, nth):
                        if z_part:
                            p = read_z_tile(p, ir[0], ir[1], jr[0], jr[1], max_val)
                        else:
                            p = read_cnt_tile(p, ir[0], ir[1], jr[0], jr[1])
            pos = payload_end
        res.cnts.append(cnt.copy())
        res.zs.append(z.copy())
        only_z = True
        res.endPos = pos
        if pos >= len(u8):
            break
    if not res.cnts:
        err("no Lerc1 bands decoded")
    return res

# ------------------------------------------------------------ blob walk / info

class LercInfo:
    pass


def get_info(u8):
    info = LercInfo()
    info.isLerc1 = False
    info.lerc1 = None
    info.offsets = []
    info.lerc1Mins = []
    info.lerc1Maxs = []
    info.nUsesNoDataValue = 0
    if key_at(u8, 0, FILE_KEY_LERC1):
        r = lerc1_decode(u8)
        info.isLerc1 = True
        info.lerc1 = r
        info.version = 0
        info.dt = DT_FLOAT
        info.nDepth = 1
        info.nCols = r.W
        info.nRows = r.H
        info.nBands = len(r.cnts)
        info.maxZError = r.maxZError
        info.blobSize = r.endPos
        info.zMin = 1.7976931348623157e308
        info.zMax = -1.7976931348623157e308
        info.numValidPixel = 0
        info.nMasks = 0
        for b in range(len(r.cnts)):
            cnt = r.cnts[b]
            z = r.zs[b]
            n_valid = 0
            z_min = np.float32(3.4028234663852886e38)
            z_max = np.float32(-3.4028234663852886e38)
            for i in range(r.H * r.W):
                if cnt[i] > 0:
                    n_valid += 1
                    if z[i] < z_min:
                        z_min = z[i]
                    if z[i] > z_max:
                        z_max = z[i]
            info.numValidPixel = n_valid
            info.zMin = min_d(info.zMin, float(z_min))
            info.zMax = max_d(info.zMax, float(z_max))
            info.nMasks = 1 if n_valid < r.W * r.H else 0
            info.lerc1Mins.append(float(z_min))
            info.lerc1Maxs.append(float(z_max))
        return info

    first = read_header(u8, 0)
    info.version = first.version
    info.dt = first.dt
    info.nDepth = first.nDepth
    info.nCols = first.nCols
    info.nRows = first.nRows
    info.numValidPixel = first.numValidPixel
    info.blobSize = first.blobSize
    info.zMin = first.zMin
    info.zMax = first.zMax
    info.maxZError = first.maxZError
    info.nUsesNoDataValue = 1 if first.bPassNoDataValues != 0 else 0
    info.offsets.append(0)
    info.nBands = 1
    if info.blobSize > len(u8):
        err("truncated blob")
    nb_mask0 = i32_(u8, first.headerSize)
    n_masks = 1 if (nb_mask0 > 0 or first.numValidPixel == 0) else 0
    try_next = first.version <= 5 or first.nBlobsMore > 0
    while try_next and info.blobSize < len(u8):
        try:
            h2 = read_header(u8, info.blobSize)
        except LercError:
            break
        if (h2.nDepth != first.nDepth or h2.nCols != first.nCols
                or h2.nRows != first.nRows or h2.dt != first.dt):
            err("inconsistent band headers")
        try_next = h2.version <= 5 or h2.nBlobsMore > 0
        if h2.bPassNoDataValues != 0:
            info.nUsesNoDataValue += 1
        nb_mask2 = i32_(u8, info.blobSize + h2.headerSize)
        if nb_mask2 > 0 or h2.numValidPixel != first.numValidPixel:
            n_masks = 2
        if info.blobSize + h2.blobSize > len(u8):
            err("truncated blob")
        info.zMin = min_d(info.zMin, h2.zMin)
        info.zMax = max_d(info.zMax, h2.zMax)
        info.maxZError = max_d(info.maxZError, h2.maxZError)
        info.offsets.append(info.blobSize)
        info.blobSize += h2.blobSize
        info.nBands += 1
    info.nMasks = info.nBands if n_masks > 1 else n_masks
    if info.nUsesNoDataValue > 0:
        info.nUsesNoDataValue = info.nBands
    return info


def read_band_ranges(u8, off, h, mins, maxs, at):
    D = h.nDepth
    if h.numValidPixel == 0:
        for d in range(D):
            mins[at + d] = 0
            maxs[at + d] = 0
        return
    if h.version < 4 or h.zMin == h.zMax or D == 1:
        for d in range(D):
            mins[at + d] = h.zMin
            maxs[at + d] = h.zMax
        return
    pos = off + h.headerSize
    num_bytes_mask = i32_(u8, pos); pos += 4
    if num_bytes_mask < 0 or num_bytes_mask > len(u8) - pos:
        err("bad mask section size")
    pos += num_bytes_mask
    for d in range(D):
        mins[at + d], pos = read_variable_value(u8, pos, h.dt)
    for d in range(D):
        maxs[at + d], pos = read_variable_value(u8, pos, h.dt)


def slice_(blob, blob_size):
    n = min(blob_size, len(blob))
    return blob[:n] if n != len(blob) else blob


# ------------------------------------------------------------ public C-API surface

def lerc_getBlobInfo(pLercBlob, blobSize, infoArray, dataRangeArray,
                     infoArraySize, dataRangeArraySize):
    if (pLercBlob is None or blobSize == 0
            or (infoArray is None and dataRangeArray is None)
            or (infoArraySize <= 0 and dataRangeArraySize <= 0)):
        return WRONG_PARAM
    u8 = slice_(pLercBlob, blobSize)
    try:
        info = get_info(u8)
    except LercError:
        return FAILED
    if infoArray is not None:
        ias = min(infoArraySize, len(infoArray))
        for k in range(ias):
            infoArray[k] = 0
        vals = [info.version, info.dt, info.nDepth, info.nCols, info.nRows,
                info.nBands, info.numValidPixel, info.blobSize, info.nMasks,
                info.nDepth, info.nUsesNoDataValue]
        for k in range(min(len(vals), ias)):
            infoArray[k] = vals[k]
    if dataRangeArray is not None:
        dras = min(dataRangeArraySize, len(dataRangeArray))
        for k in range(dras):
            dataRangeArray[k] = 0
        b_uses_no_data = info.nDepth > 1 and info.nUsesNoDataValue > 0
        vals = [info.zMin if not b_uses_no_data else -1,
                info.zMax if not b_uses_no_data else -1, info.maxZError]
        for k in range(min(len(vals), dras)):
            dataRangeArray[k] = vals[k]
    return OK


def lerc_getDataRanges(pLercBlob, blobSize, nDepth, nBands, mins, maxs):
    if (pLercBlob is None or blobSize == 0 or mins is None or maxs is None
            or nDepth <= 0 or nBands <= 0):
        return WRONG_PARAM
    n_elem = nDepth * nBands
    if len(mins) < n_elem or len(maxs) < n_elem:
        return WRONG_PARAM
    u8 = slice_(pLercBlob, blobSize)
    try:
        info = get_info(u8)
    except LercError:
        return FAILED
    if info.isLerc1:
        for b in range(info.nBands):
            if b + 1 > n_elem:
                return BUFFER_TOO_SMALL
            mins[b] = info.lerc1Mins[b]
            maxs[b] = info.lerc1Maxs[b]
        return OK
    try:
        for b in range(info.nBands):
            h = read_header(u8, info.offsets[b])
            if (b + 1) * h.nDepth > n_elem:
                return BUFFER_TOO_SMALL
            if h.bPassNoDataValues != 0 and h.nDepth > 1:
                return HAS_NO_DATA
            read_band_ranges(u8, info.offsets[b], h, mins, maxs, b * h.nDepth)
    except LercError:
        return FAILED
    return OK


def _decode_core(pLercBlob, blobSize, nMasks, pValidBytes, nDepth, nCols, nRows,
                 nBands, dataType, dataLen, store, pUsesNoData, noDataValues):
    if (pLercBlob is None or blobSize == 0 or dataType < 0 or dataType > 7
            or nDepth <= 0 or nCols <= 0 or nRows <= 0 or nBands <= 0):
        return WRONG_PARAM
    if (not (nMasks == 0 or nMasks == 1 or nMasks == nBands)
            or (nMasks > 0 and pValidBytes is None)):
        return WRONG_PARAM
    n_values = nDepth * nCols * nRows * nBands
    if dataLen < n_values:
        return BUFFER_TOO_SMALL
    if nMasks > 0 and len(pValidBytes) < nMasks * nCols * nRows:
        return BUFFER_TOO_SMALL
    u8 = slice_(pLercBlob, blobSize)

    if key_at(u8, 0, FILE_KEY_LERC1):
        try:
            r = lerc1_decode(u8)
        except LercError:
            return FAILED
        if r.W != nCols or r.H != nRows or nDepth != 1:
            return FAILED
        if nBands > len(r.cnts):
            return FAILED
        flt_pnt = dataType in (DT_FLOAT, DT_DOUBLE)
        for i_band in range(nBands):
            cnt = r.cnts[i_band]
            z = r.zs[i_band]
            n_pix = i_band * nRows * nCols
            for k in range(nRows * nCols):
                if cnt[k] > 0:
                    if flt_pnt:
                        store(n_pix + k, cast_dt(float(z[k]), dataType))
                    else:
                        store(n_pix + k, cast_dt(float(np.floor(float(z[k]) + 0.5)), dataType))
                if i_band < nMasks:
                    pValidBytes[n_pix + k] = 1 if cnt[k] > 0 else 0
        return OK

    try:
        info = get_info(u8)
    except LercError:
        return FAILED
    if nMasks < info.nMasks:
        return WRONG_PARAM
    if nBands > info.nBands:
        return WRONG_PARAM
    want_no_data = info.nUsesNoDataValue != 0 and nDepth > 1
    if want_no_data:
        if pUsesNoData is None or noDataValues is None:
            return HAS_NO_DATA
        if len(pUsesNoData) < nBands or len(noDataValues) < nBands:
            return BUFFER_TOO_SMALL
        for b in range(nBands):
            pUsesNoData[b] = 0
            noDataValues[b] = 0
    prev_mask = None
    try:
        for i_band in range(nBands):
            band = decode_band(u8, info.offsets[i_band], prev_mask, True)
            if (band.h.nDepth != nDepth or band.h.nCols != nCols
                    or band.h.nRows != nRows or band.h.dt != dataType):
                return FAILED
            prev_mask = band.mask
            n_pix = i_band * nRows * nCols
            if want_no_data:
                pUsesNoData[i_band] = 1 if band.h.bPassNoDataValues != 0 else 0
                noDataValues[i_band] = band.h.noDataValOrig
            if band.h.bPassNoDataValues != 0:
                old_v = cast_dt(band.h.noDataVal, band.h.dt)
                new_v = cast_dt(band.h.noDataValOrig, band.h.dt)
                if old_v != new_v:
                    for i in range(nRows * nCols):
                        if band.mask is not None and band.mask[i] == 0:
                            continue
                        for d in range(nDepth):
                            if band.data[i * nDepth + d] == old_v:
                                band.data[i * nDepth + d] = new_v
            n_band_values = nRows * nCols * nDepth
            for k in range(n_band_values):
                store(n_pix * nDepth + k, band.data[k])
            if i_band < nMasks:
                for k in range(nRows * nCols):
                    pValidBytes[n_pix + k] = 1 if band.mask is None else band.mask[k]
    except LercError:
        return FAILED
    return OK


def lerc_decode(pLercBlob, blobSize, nMasks, pValidBytes, nDepth, nCols, nRows,
                nBands, dataType, pData):
    return lerc_decode_4D(pLercBlob, blobSize, nMasks, pValidBytes, nDepth,
                          nCols, nRows, nBands, dataType, pData, None, None)


def lerc_decode_4D(pLercBlob, blobSize, nMasks, pValidBytes, nDepth, nCols,
                   nRows, nBands, dataType, pData, pUsesNoData, noDataValues):
    """pData: 1-D numpy array of the matching dtype (the typed-overload
    analog; numpy assignment coerces exactly like the C# casts since
    cast_dt already wrapped the value into range)."""
    if pData is None:
        return WRONG_PARAM

    def store(i, v):
        pData[i] = v

    return _decode_core(pLercBlob, blobSize, nMasks, pValidBytes, nDepth, nCols,
                        nRows, nBands, dataType, len(pData), store,
                        pUsesNoData, noDataValues)


def lerc_decodeToDouble(pLercBlob, blobSize, nMasks, pValidBytes, nDepth,
                        nCols, nRows, nBands, pData):
    return lerc_decodeToDouble_4D(pLercBlob, blobSize, nMasks, pValidBytes,
                                  nDepth, nCols, nRows, nBands, pData, None, None)


def lerc_decodeToDouble_4D(pLercBlob, blobSize, nMasks, pValidBytes, nDepth,
                           nCols, nRows, nBands, pData, pUsesNoData, noDataValues):
    if (pLercBlob is None or blobSize == 0 or pData is None
            or nDepth <= 0 or nCols <= 0 or nRows <= 0 or nBands <= 0):
        return WRONG_PARAM
    if (not (nMasks == 0 or nMasks == 1 or nMasks == nBands)
            or (nMasks > 0 and pValidBytes is None)):
        return WRONG_PARAM
    try:
        info = get_info(slice_(pLercBlob, blobSize))
    except LercError:
        return FAILED
    if (info.nDepth != nDepth or info.nCols != nCols or info.nRows != nRows
            or info.nBands != nBands):
        return FAILED

    def store(i, v):
        pData[i] = v

    return _decode_core(pLercBlob, blobSize, nMasks, pValidBytes, nDepth, nCols,
                        nRows, nBands, info.dt, len(pData), store,
                        pUsesNoData, noDataValues)


# ===========================================================================
# LercEncodeSim: statement-exact twin of bindings/csharp/LercEncode.cs
# (the pure-managed ENCODER; same sync rules as the decoder twin above --
# edit both files together, then refresh PINNED_ENCODE_SHA256).
# C# semantics modeled exactly: checked-range narrowing casts are explicit
# masks, double->long truncates toward zero, (sbyte)/(byte) wraparound.
# ===========================================================================

PINNED_ENCODE_SHA256 = "a740a4d3f2b80a80dd2229918c5dab96772bf0902d953193f1b256fdaaa0e70d"

MASK_ALL_VALID = 0
MASK_SAME_FOR_ALL_BANDS = 1
MASK_UNIQUE_PER_BAND = 2

_ENC_CURRENT_VERSION = 6
_ENC_DT_SIZE = [1, 1, 2, 2, 4, 4, 4, 8]


def check_encode_in_sync():
    """Raise if LercEncode.cs changed since this twin was synchronized."""
    import hashlib
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "LercEncode.cs")
    actual = hashlib.sha256(open(path, "rb").read()).hexdigest()
    if actual != PINNED_ENCODE_SHA256:
        raise AssertionError(
            f"bindings/csharp/LercEncode.cs hash {actual} != pinned "
            f"{PINNED_ENCODE_SHA256}: LercEncode.cs was edited without "
            "updating cs_sim.py. Port the change (statement-for-statement), "
            "then refresh PINNED_ENCODE_SHA256."
        )


def _enc_dt_of(np_dtype):
    m = {np.int8: DT_CHAR, np.uint8: DT_BYTE, np.int16: DT_SHORT,
         np.uint16: DT_USHORT, np.int32: DT_INT, np.uint32: DT_UINT,
         np.float32: DT_FLOAT, np.float64: DT_DOUBLE}
    return m[np.dtype(np_dtype).type]


def encode(raster, nDepth, nCols, nRows, nBands, maskType=MASK_ALL_VALID,
           maxZErr=0.0, pixelMasks=None):
    """Twin of LercEncode.Encode<T>: raster is a flat numpy array in
    band-major [band][row][col][depth] order. Returns bytes."""
    raster = np.asarray(raster).reshape(-1)
    dt = _enc_dt_of(raster.dtype)
    nPix = nRows * nCols
    if nDepth < 1 or nCols < 1 or nRows < 1 or nBands < 1:
        raise ValueError("bad raster geometry")
    if raster.size < nPix * nDepth * nBands:
        raise ValueError("rasterData too small")
    if dt >= DT_FLOAT and maxZErr < 0:
        raise ValueError("negative maxZError not allowed for float types")
    mze = maxZErr
    if dt < DT_FLOAT:
        mze = max(0.5, math.floor(mze))

    nMasks = (0 if maskType == MASK_ALL_VALID
              else 1 if maskType == MASK_SAME_FOR_ALL_BANDS else nBands)
    if nMasks > 0 and (pixelMasks is None or len(pixelMasks) < nMasks * nPix):
        raise ValueError("pixelMasks too small")

    output = bytearray()
    for b in range(nBands):
        off = b * nPix * nDepth
        vals = raster[off : off + nPix * nDepth].astype(np.float64)
        if nMasks == 0:
            mask = np.ones(nPix, bool)
        else:
            moff = 0 if nMasks == 1 else b * nPix
            mask = np.asarray(pixelMasks).reshape(-1)[moff : moff + nPix] != 0
        _encode_band(output, vals, mask, nRows, nCols, nDepth, dt, mze,
                     nBands - 1 - b)
    return bytes(output)


def compute_encoded_size(raster, nDepth, nCols, nRows, nBands,
                         maskType=MASK_ALL_VALID, maxZErr=0.0, pixelMasks=None):
    return len(encode(raster, nDepth, nCols, nRows, nBands, maskType, maxZErr,
                      pixelMasks))


def _encode_band(output, vals, mask, nRows, nCols, nDepth, dt, mze, nBlobsMore):
    nPix = nRows * nCols
    numValid = int(mask.sum())

    maskSection = _build_mask_section(mask, nRows, nCols, numValid)

    zMin = zMax = 0.0
    zMinVec = np.zeros(nDepth)
    zMaxVec = np.zeros(nDepth)
    if numValid > 0:
        v2 = vals.reshape(nPix, nDepth)[mask]
        zMinVec = v2.min(axis=0)
        zMaxVec = v2.max(axis=0)
        zMin = float(zMinVec.min())
        zMax = float(zMaxVec.max())

    if numValid == 0 or zMin == zMax:
        _assemble(output, nRows, nCols, nDepth, numValid, 8, dt, mze, zMin,
                  zMax, nBlobsMore, maskSection,
                  _ranges_section(zMinVec, zMaxVec, dt, numValid, zMin, zMax, nDepth),
                  b"")
        return

    ranges = _ranges_section(zMinVec, zMaxVec, dt, numValid, zMin, zMax, nDepth)
    if bool((zMinVec == zMaxVec).all()):
        _assemble(output, nRows, nCols, nDepth, numValid, 8, dt, mze, zMin,
                  zMax, nBlobsMore, maskSection, ranges, b"")
        return

    tiling = _write_tiles(vals, mask, nRows, nCols, nDepth, dt, mze)
    payload = tiling
    imageMode = 0
    tryHuffman = dt <= DT_BYTE and mze == 0.5

    if tryHuffman:
        hm, hMode = _encode_huffman_int(vals, mask, nRows, nCols, nDepth, dt)
        if hm is not None and len(hm) < len(tiling):
            payload = hm
            imageMode = hMode

    nOneSweep = _ENC_DT_SIZE[dt] * nDepth * numValid
    if nOneSweep <= len(payload) + (1 if tryHuffman else 0):
        sweep = bytearray([1])
        v2 = vals.reshape(nPix, nDepth)
        for i in range(nPix):
            if mask[i]:
                for d in range(nDepth):
                    _write_native(sweep, v2[i, d], dt)
        body = bytes(sweep)
    else:
        bl = bytearray([0])
        if tryHuffman:
            bl.append(imageMode)
        bl += payload
        body = bytes(bl)
    _assemble(output, nRows, nCols, nDepth, numValid, 8, dt, mze, zMin, zMax,
              nBlobsMore, maskSection, ranges, body)


def _ranges_section(zMinVec, zMaxVec, dt, numValid, zMin, zMax, nDepth):
    if numValid == 0 or zMin == zMax:
        return b""
    outp = bytearray()
    for d in range(nDepth):
        _write_native(outp, float(zMinVec[d]), dt)
    for d in range(nDepth):
        _write_native(outp, float(zMaxVec[d]), dt)
    return bytes(outp)


def _build_mask_section(mask, nRows, nCols, numValid):
    outp = bytearray()
    nPix = nRows * nCols
    if 0 < numValid < nPix:
        nBytes = (nPix + 7) >> 3
        bits = bytearray(nBytes)
        for i in range(nPix):
            if mask[i]:
                bits[i >> 3] |= 0x80 >> (i & 7)
        pad = nBytes * 8 - nPix
        if pad > 0:
            bits[nBytes - 1] |= (1 << pad) - 1
        rle = _rle_compress(bytes(bits))
        outp += struct.pack("<i", len(rle))
        outp += rle
    else:
        outp += struct.pack("<i", 0)
    return bytes(outp)


def _write_tiles(vals, mask, nRows, nCols, nDepth, dt, mze):
    MB = 8
    nbv = (nRows + MB - 1) // MB
    nbh = (nCols + MB - 1) // MB
    scale = 1.0 / (2 * mze) if mze > 0 else 0.0
    maxValQuant = (1 << 15) - 1 if dt <= DT_USHORT else (1 << 30) - 1
    outp = bytearray()
    v2 = vals.reshape(nRows * nCols, nDepth)

    for bi in range(nbv):
        for bj in range(nbh):
            i0, j0 = bi * MB, bj * MB
            h = min(MB, nRows - i0)
            w = min(MB, nCols - j0)
            flag = (((j0 >> 3) & 15) << 2) & 0b111000

            for d in range(nDepth):
                blk = []
                for i in range(h):
                    for j in range(w):
                        p = (i0 + i) * nCols + (j0 + j)
                        if mask[p]:
                            blk.append(v2[p, d])
                cnt = len(blk)
                if cnt == 0:
                    outp.append(flag | 2)
                    continue
                bmn = min(blk)
                bmx = max(blk)
                if bmn == 0 and bmx == 0:
                    outp.append(flag | 2)
                    continue
                maxVal = (bmx - bmn) * scale if mze > 0 else 0.0
                forceRaw = (mze == 0 and bmx > bmn) or (mze > 0 and maxVal > maxValQuant)
                nBytesRaw = 1 + cnt * _ENC_DT_SIZE[dt]
                if forceRaw:
                    outp.append(flag)
                    for v in blk:
                        _write_native(outp, v, dt)
                    continue
                maxElem = int(math.floor(maxVal + 0.5))
                quant = []
                qMax = 0
                for v in blk:
                    q = int(math.floor((v - bmn) * scale + 0.5)) & 0xFFFFFFFF
                    quant.append(q)
                    if q > qMax:
                        qMax = q
                tc, dtReduced = _reduce_data_type(bmn, dt)
                nBytes = 1 + _ENC_DT_SIZE[dtReduced]
                if maxElem > 0:
                    nBytes += _compute_bytes_simple(cnt, maxElem)
                if nBytes >= nBytesRaw:
                    outp.append(flag)
                    for v in blk:
                        _write_native(outp, v, dt)
                    continue
                modeBits = (3 if maxElem == 0 else 1) | (tc << 6)
                outp.append(flag | modeBits)
                _write_native(outp, bmn, dtReduced)
                if maxElem > 0:
                    _stuff_simple(outp, quant, cnt, qMax)
    return bytes(outp)


def _reduce_data_type(z, dt):
    isByte = 0 <= z <= 255 and z == math.floor(z)
    isShort = -32768 <= z <= 32767 and z == math.floor(z)
    isChar = -128 <= z <= 127 and z == math.floor(z)
    isUShort = 0 <= z <= 65535 and z == math.floor(z)
    if dt == DT_SHORT:
        tc = 2 if isChar else 1 if isByte else 0
        return tc, dt - tc
    if dt == DT_USHORT:
        tc = 1 if isByte else 0
        return tc, dt - 2 * tc
    if dt == DT_INT:
        tc = 3 if isByte else 2 if isShort else 1 if isUShort else 0
        return tc, dt - tc
    if dt == DT_UINT:
        tc = 2 if isByte else 1 if isUShort else 0
        return tc, dt - 2 * tc
    if dt == DT_FLOAT:
        tc = 2 if isByte else 1 if isShort else 0
        return tc, dt if tc == 0 else (DT_SHORT if tc == 1 else DT_BYTE)
    if dt == DT_DOUBLE:
        isInt32 = -2147483648.0 <= z <= 2147483647.0 and z == math.floor(z)
        isF32 = float(np.float32(z)) == z
        tc = 3 if isShort else 2 if isInt32 else 1 if isF32 else 0
        return tc, dt if tc == 0 else dt - 2 * tc + 1
    return 0, dt


def _num_bits_needed(maxElem):
    nb = 0
    while maxElem > 0:
        nb += 1
        maxElem >>= 1
    return nb


def _compute_bytes_simple(numElements, maxElem):
    nb = _num_bits_needed(maxElem)
    w = 1 if numElements < 256 else 2 if numElements < 65536 else 4
    return 1 + w + ((numElements * nb + 7) >> 3)


def _stuff_simple(outp, values, n, qMax):
    nb = _num_bits_needed(qMax)
    w = 1 if n < 256 else 2 if n < 65536 else 4
    outp.append(nb | ((0 if w == 4 else 3 - w) << 6))
    for k in range(w):
        outp.append((n >> (8 * k)) & 0xFF)
    if nb == 0:
        return
    acc = 0
    accBits = 0
    for k in range(n):
        acc |= values[k] << accBits
        accBits += nb
        while accBits >= 8:
            outp.append(acc & 0xFF)
            acc >>= 8
            accBits -= 8
    if accBits > 0:
        outp.append(acc & 0xFF)


def _encode_huffman_int(vals, mask, nRows, nCols, nDepth, dt):
    offset = 128 if dt == DT_CHAR else 0
    nPix = nRows * nCols
    v2 = vals.reshape(nPix, nDepth)

    direct = []
    for i in range(nPix):
        if mask[i]:
            for d in range(nDepth):
                direct.append((int(v2[i, d]) + offset) & 0xFF)

    delta = []
    for d in range(nDepth):
        prev = 0
        first = True
        for i in range(nPix):
            if not mask[i]:
                continue
            row, col = divmod(i, nCols)
            v = int(v2[i, d])
            leftOk = col > 0 and mask[i - 1]
            aboveOk = row > 0 and mask[i - nCols]
            p = (int(v2[i - nCols, d]) if (not leftOk and aboveOk)
                 else 0 if first else prev)
            if dt == DT_CHAR:
                dv = ((v - p + 128) & 0xFF) - 128  # (sbyte)(v - p)
            else:
                dv = (v - p) & 0xFF  # (byte)(v - p)
            delta.append((dv + offset) & 0xFF)
            prev = v
            first = False

    enc0 = _huffman_encode_stream(direct)
    enc1 = _huffman_encode_stream(delta)
    if enc0 is None and enc1 is None:
        return None, 0
    if enc0 is not None and (enc1 is None or len(enc0) <= len(enc1)):
        return enc0, 2  # HUFFMAN
    return enc1, 1  # DELTA_HUFFMAN


def _huffman_encode_stream(symbols):
    histo = [0] * 256
    for s in symbols:
        histo[s] += 1
    lengths = _huffman_code_lengths(histo)
    if lengths is None:
        return None
    codes = _canonical_codes(lengths)
    outp = bytearray()
    if not _write_code_table(outp, lengths, codes):
        return None
    bw = _BitWriterMSB(outp)
    for s in symbols:
        bw.write(codes[s], lengths[s])
    bw.flush(pad_uints=1)
    return bytes(outp)


def _huffman_code_lengths(histo):
    weight, left, right, leafSym = [], [], [], []
    heap = []
    for i in range(256):
        if histo[i] > 0:
            weight.append(histo[i])
            left.append(-1)
            right.append(-1)
            leafSym.append(i)
            heap.append(len(weight) - 1)
    if len(heap) < 2:
        return None
    heap.sort(key=lambda a: (weight[a], a))
    # ordered linked-list merge (twin of the C# LinkedList walk)
    lst = list(heap)
    while len(lst) > 1:
        n0 = lst.pop(0)
        n1 = lst.pop(0)
        weight.append(weight[n0] + weight[n1])
        left.append(n0)
        right.append(n1)
        leafSym.append(-1)
        node = len(weight) - 1
        k = 0
        while k < len(lst) and (weight[lst[k]], lst[k]) < (weight[node], node):
            k += 1
        lst.insert(k, node)
    lengths = [0] * 256
    stack = [(lst[0], 0)]
    while stack:
        node, depth = stack.pop()
        if leafSym[node] >= 0:
            if depth > 32:
                return None
            lengths[leafSym[node]] = max(depth, 0)
        else:
            stack.append((left[node], depth + 1))
            stack.append((right[node], depth + 1))
    return lengths


def _canonical_codes(lengths):
    size = len(lengths)
    order = [i for i in range(size) if lengths[i] > 0]
    order.sort(key=lambda a: (-lengths[a], a))
    codes = [0] * size
    if not order:
        return codes
    codeLen = lengths[order[0]]
    code = 0
    for idx in order:
        dl = codeLen - lengths[idx]
        code >>= dl
        codeLen -= dl
        codes[idx] = code
        code += 1
    return codes


def _write_code_table(outp, lengths, codes):
    size = len(lengths)
    i0 = i1 = -1
    for i in range(size):
        if lengths[i] > 0:
            if i0 < 0:
                i0 = i
            i1 = i + 1
    if i0 < 0:
        return False
    bestK0 = bestLen = 0
    j = 0
    while j < size:
        while j < size and lengths[j] > 0:
            j += 1
        k0 = j
        while j < size and lengths[j] == 0:
            j += 1
        if j - k0 > bestLen:
            bestK0, bestLen = k0, j - k0
    if size - bestLen < i1 - i0:
        i0 = bestK0 + bestLen
        i1 = bestK0 + size
    maxLen = 0
    for i in range(i0, i1):
        if lengths[i % size] > maxLen:
            maxLen = lengths[i % size]
    if maxLen <= 0 or maxLen > 32:
        return False

    outp += struct.pack("<4i", 3, size, i0, i1)
    lens = [lengths[i % size] for i in range(i0, i1)]
    _stuff_simple(outp, lens, len(lens), max(lens))
    bw = _BitWriterMSB(outp)
    for i in range(i0, i1):
        k = i % size
        if lengths[k] > 0:
            bw.write(codes[k], lengths[k])
    bw.flush(pad_uints=0)
    return True


class _BitWriterMSB:
    def __init__(self, outp):
        self.outp = outp
        self.word = 0
        self.bitPos = 0

    def write(self, code, length):
        while length > 0:
            take = min(length, 32 - self.bitPos)
            piece = (code >> (length - take)) & (0xFFFFFFFF if take == 32 else (1 << take) - 1)
            self.word |= (piece << (32 - self.bitPos - take)) & 0xFFFFFFFF
            self.bitPos += take
            length -= take
            if self.bitPos == 32:
                self._emit()
                self.word = 0
                self.bitPos = 0

    def flush(self, pad_uints):
        if self.bitPos > 0:
            self._emit()
            self.word = 0
            self.bitPos = 0
        for _ in range(pad_uints):
            self._emit()

    def _emit(self):
        self.outp += struct.pack("<I", self.word)


def _rle_compress(arr):
    MIN_NUM_EVEN, CAP = 5, 32767
    n = len(arr)
    outp = bytearray()
    lit = bytearray()

    def flush_literal():
        pos = 0
        while pos < len(lit):
            c = min(CAP, len(lit) - pos)
            outp.append(c & 0xFF)
            outp.append((c >> 8) & 0xFF)
            outp.extend(lit[pos : pos + c])
            pos += c
        lit.clear()

    i = 0
    while i < n:
        runLen = 1
        while i + runLen < n and arr[i + runLen] == arr[i]:
            runLen += 1
        if runLen >= MIN_NUM_EVEN and i + MIN_NUM_EVEN < n:
            flush_literal()
            remaining = runLen
            while remaining > CAP:
                outp += struct.pack("<h", -CAP)
                outp.append(arr[i])
                remaining -= CAP
            outp += struct.pack("<h", -remaining)
            outp.append(arr[i])
        else:
            lit += arr[i : i + runLen]
        i += runLen
    flush_literal()
    outp += struct.pack("<h", -32768)
    return bytes(outp)


def _assemble(output, nRows, nCols, nDepth, numValid, microBlock, dt, mze,
              zMin, zMax, nBlobsMore, maskSection, ranges, body):
    HEADER_SIZE = 90
    blobSize = HEADER_SIZE + len(maskSection) + len(ranges) + len(body)
    blob = bytearray()
    blob += b"Lerc2 "
    blob += struct.pack("<i", _ENC_CURRENT_VERSION)
    blob += struct.pack("<i", 0)  # checksum placeholder
    blob += struct.pack("<9i", nRows, nCols, nDepth, numValid, microBlock,
                        blobSize, dt, nBlobsMore, 0)
    # the 9th int packs the 4 flag bytes (all zero)
    blob += struct.pack("<5d", mze, zMin, zMax, 0.0, 0.0)
    blob += maskSection
    blob += ranges
    blob += body
    checksum = _enc_fletcher32(blob, 14, len(blob))
    struct.pack_into("<I", blob, 10, checksum)
    output += blob


def _enc_fletcher32(u8, start, end):
    sum1 = 0xFFFF
    sum2 = 0xFFFF
    length = end - start
    pos = start
    words = length // 2
    while words > 0:
        block = min(words, 359)
        words -= block
        for _ in range(block):
            sum1 += u8[pos] << 8
            pos += 1
            sum1 += u8[pos]
            sum2 += sum1
            pos += 1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if length & 1:
        sum1 += u8[pos] << 8
        sum2 += sum1
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return ((sum2 << 16) | sum1) & 0xFFFFFFFF


def _write_native(o, v, dt):
    if dt == DT_CHAR:
        o.append(int(v) & 0xFF)
    elif dt == DT_BYTE:
        o.append(int(v) & 0xFF)
    elif dt in (DT_SHORT, DT_USHORT):
        o += struct.pack("<H", int(v) & 0xFFFF)
    elif dt in (DT_INT, DT_UINT):
        o += struct.pack("<I", int(v) & 0xFFFFFFFF)
    elif dt == DT_FLOAT:
        o += struct.pack("<f", np.float32(v))
    else:
        o += struct.pack("<d", v)
