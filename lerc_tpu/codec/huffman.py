"""Canonical Huffman coding for 8-bit LERC data (codec v2+).

Wire format (matches lerc/src/LercLib/Huffman.{h,cpp}):

  code table:
    int32 huffmanVersion (4), int32 size (256), int32 i0, int32 i1
    BitStuffer2-simple packed code lengths for bins [i0, i1) (index mod size)
    codes bit-packed MSB-first into little-endian uint32 words
  symbol stream:
    codes pushed MSB-first into little-endian uint32 words
    (Huffman.h:218-255); the stream is padded with one extra uint32 so the
    12-bit decode LUT may read ahead (Lerc2.cpp:2464).

The bin range [i0, i1) may wrap around (i >= size -> i - size) to skip the
longest stretch of empty bins (Huffman.cpp:383-438).

Code *lengths* come from a deterministic min-heap Huffman tree; canonical
code assignment then matches Huffman.cpp:541-572 (sort by
length*size - index descending). Tie-breaks in the tree build may differ
from the C++ std::priority_queue, which can change blob bytes but never
decodability; decoded output is always exact.
"""
from __future__ import annotations

import heapq
import struct

import numpy as np

from . import bitstuffer

MAX_NUM_BITS_LUT = 12
HUFFMAN_VERSION = 4


# ---------------------------------------------------------------------------
# code construction
# ---------------------------------------------------------------------------

def compute_code_lengths(histo: np.ndarray) -> np.ndarray | None:
    """Huffman code length per symbol; None if < 2 nonempty bins or len > 32."""
    size = histo.size
    heap: list[tuple[int, int, object]] = []
    serial = 0
    for i in range(size):
        if histo[i] > 0:
            heap.append((int(histo[i]), serial, ("leaf", i)))
            serial += 1
    if len(heap) < 2:
        return None
    heapq.heapify(heap)
    while len(heap) > 1:
        w0, _, n0 = heapq.heappop(heap)
        w1, _, n1 = heapq.heappop(heap)
        heapq.heappush(heap, (w0 + w1, serial, ("node", n0, n1)))
        serial += 1
    lengths = np.zeros(size, dtype=np.int32)

    stack = [(heap[0][2], 0)]
    while stack:
        node, depth = stack.pop()
        if node[0] == "leaf":
            lengths[node[1]] = max(depth, 0)
            if depth > 32:
                return None
        else:
            stack.append((node[1], depth + 1))
            stack.append((node[2], depth + 1))
    return lengths


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Assign canonical codes given lengths (Huffman.cpp:541-572)."""
    size = lengths.size
    codes = np.zeros(size, dtype=np.uint32)
    keys = np.where(lengths > 0, lengths.astype(np.int64) * size - np.arange(size), 0)
    order = np.argsort(-keys, kind="stable")
    order = order[keys[order] > 0]
    if order.size == 0:
        return codes
    code_len = int(lengths[order[0]])
    code = 0
    for idx in order:
        delta = code_len - int(lengths[idx])
        code >>= delta
        code_len -= delta
        codes[idx] = code
        code += 1
    return codes


def compute_compressed_size(histo: np.ndarray, lengths: np.ndarray) -> int:
    """Total bytes for code table + coded stream (Huffman.cpp:85-111)."""
    table = compute_code_table_size(lengths)
    if table is None:
        return -1
    num_bits = int((histo * lengths).sum())
    num_elem = int(histo.sum())
    if num_elem == 0:
        return -1
    num_uints = ((((num_bits + 7) >> 3) + 3) >> 2) + 1  # +1 read-ahead pad
    return table + 4 * num_uints


def get_range(lengths: np.ndarray) -> tuple[int, int, int]:
    """(i0, i1, maxLen) with optional wrap-around (Huffman.cpp:383-438)."""
    size = lengths.size
    nz = np.flatnonzero(lengths > 0)
    if nz.size == 0:
        raise ValueError("empty code table")
    i0, i1 = int(nz[0]), int(nz[-1]) + 1
    # largest stretch of zero bins anywhere
    best_k0, best_len = 0, 0
    j = 0
    while j < size:
        while j < size and lengths[j] > 0:
            j += 1
        k0 = j
        while j < size and lengths[j] == 0:
            j += 1
        if j - k0 > best_len:
            best_k0, best_len = k0, j - k0
    if size - best_len < i1 - i0:
        i0 = best_k0 + best_len
        i1 = best_k0 + size  # wrap around
    max_len = int(max(lengths[np.mod(np.arange(i0, i1), size)]))
    if max_len <= 0 or max_len > 32:
        raise ValueError("bad code lengths")
    return i0, i1, max_len


def compute_code_table_size(lengths: np.ndarray) -> int | None:
    try:
        i0, i1, max_len = get_range(lengths)
    except ValueError:
        return None
    size = lengths.size
    idx = np.mod(np.arange(i0, i1), size)
    total_code_bits = int(lengths[idx].sum())
    n = 4 * 4
    n += bitstuffer.compute_bytes_simple(i1 - i0, max_len)
    n += 4 * (((total_code_bits + 7) >> 3) + 3 >> 2)
    return n


# ---------------------------------------------------------------------------
# MSB-first bit writer / reader over little-endian uint32 words
# ---------------------------------------------------------------------------

def pack_codes_msb(values: np.ndarray, lengths: np.ndarray, pad_uints: int = 0) -> bytes:
    """Concatenate (value, length) pairs MSB-first into LE uint32 words.

    Matches Huffman::PushValue. The stream is padded to a whole uint32; the
    caller may ask for extra pad words (decode-LUT read-ahead).
    """
    total_bits = int(lengths.sum())
    if total_bits == 0:
        return b"\0" * (4 * pad_uints)
    # build the MSB-first bit stream
    n = values.size
    max_len = int(lengths.max())
    shifts = np.arange(max_len - 1, -1, -1, dtype=np.uint32)
    allbits = ((values[:, None].astype(np.uint32) >> shifts[None, :]) & np.uint32(1)).astype(np.uint8)
    # select per element the last `length` bits
    keep = shifts[None, :] < lengths[:, None].astype(np.uint32)
    bits = allbits[keep]  # row-major: per element, its bits MSB-first
    num_uints = (total_bits + 31) // 32
    padded = np.zeros(num_uints * 32, dtype=np.uint8)
    padded[:total_bits] = bits
    words = np.frombuffer(np.packbits(padded, bitorder="big").tobytes(), dtype=">u4")
    out = words.astype("<u4").tobytes()
    return out + b"\0" * (4 * pad_uints)


def unpack_bits_msb(buf: memoryview | bytes, num_words: int) -> np.ndarray:
    """Expand `num_words` LE uint32 words to an MSB-first bit array (uint8)."""
    words = np.frombuffer(memoryview(buf)[: 4 * num_words], dtype="<u4")
    return np.unpackbits(np.frombuffer(words.astype(">u4").tobytes(), dtype=np.uint8), bitorder="big")


# ---------------------------------------------------------------------------
# code table wire I/O
# ---------------------------------------------------------------------------

def write_code_table(lengths: np.ndarray, codes: np.ndarray, lerc2_version: int) -> bytes:
    i0, i1, _ = get_range(lengths)
    size = lengths.size
    idx = np.mod(np.arange(i0, i1), size)
    out = bytearray(struct.pack("<4i", HUFFMAN_VERSION, size, i0, i1))
    out += bitstuffer.encode_simple(lengths[idx].astype(np.uint32), lerc2_version)
    sel = idx[lengths[idx] > 0]
    out += pack_codes_msb(codes[sel], lengths[sel])
    return bytes(out)


def read_code_table(buf: memoryview | bytes, lerc2_version: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Returns (lengths, codes, bytes consumed)."""
    src = memoryview(buf)
    version, size, i0, i1 = struct.unpack_from("<4i", src, 0)
    pos = 16
    if version < 2:
        raise ValueError("unsupported huffman version")
    if i0 >= i1 or i0 < 0 or size < 0 or size > (1 << 15):
        raise ValueError("corrupt huffman code table")
    if (i0 % size if i0 >= size else i0) >= size or ((i1 - 1) % size if i1 - 1 >= size else i1 - 1) >= size:
        raise ValueError("corrupt huffman code table")
    lens_packed, used = bitstuffer.decode(src[pos:], i1 - i0, lerc2_version)
    pos += used
    lengths = np.zeros(size, dtype=np.int32)
    idx = np.mod(np.arange(i0, i1), size)
    lengths[idx] = lens_packed.astype(np.int32)
    if int(lengths.max(initial=0)) > 32:
        raise ValueError("corrupt huffman code lengths")
    # read the packed codes
    sel = idx[lengths[idx] > 0]
    total_bits = int(lengths[sel].sum())
    num_words = (total_bits + 31) // 32
    if len(src) - pos < 4 * num_words:
        raise ValueError("truncated huffman code table")
    bits = unpack_bits_msb(src[pos:], num_words)
    codes = np.zeros(size, dtype=np.uint32)
    off = 0
    for k in sel:
        ln = int(lengths[k])
        v = 0
        for b in bits[off : off + ln]:
            v = (v << 1) | int(b)
        codes[k] = v
        off += ln
    pos += 4 * num_words
    return lengths, codes, pos


# ---------------------------------------------------------------------------
# symbol stream encode / decode
# ---------------------------------------------------------------------------

def encode_symbols(symbols: np.ndarray, lengths: np.ndarray, codes: np.ndarray) -> bytes:
    """Symbols -> MSB-first bitstream + 1 read-ahead pad uint32 (Lerc2.cpp:2464)."""
    lens = lengths[symbols]
    if np.any(lens <= 0):
        raise ValueError("symbol without code")
    return pack_codes_msb(codes[symbols], lens, pad_uints=1)


def _canonical_order(lengths: np.ndarray) -> np.ndarray:
    """Symbols in canonical code-assignment order (len desc, index asc)."""
    size = lengths.size
    sel = np.flatnonzero(lengths > 0)
    keys = lengths[sel].astype(np.int64) * size - sel
    return sel[np.argsort(-keys, kind="stable")]


def decode_symbols(
    buf: memoryview | bytes, lengths: np.ndarray, codes: np.ndarray, n_symbols: int
) -> tuple[np.ndarray, int]:
    """Decode `n_symbols` canonical-Huffman symbols.

    Returns (symbols, bytes consumed incl. the read-ahead pad uint32).

    Routes to the native LUT decoder when built (131 Msym/s); the numpy
    fallback speculatively decodes a (symbol, length) pair at EVERY bit
    position via a max-code-length window gather, then resolves the
    serial chain of start positions with pointer doubling -- O(N log N)
    gathers instead of a serial walk, but with a large constant.
    """
    max_len = int(lengths.max(initial=0))
    if max_len == 0:
        raise ValueError("empty code table")
    from .. import native

    if native.available():
        arr = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
        return native.huffman_decode(arr, lengths, codes, n_symbols)
    sym_order = _canonical_order(lengths)
    lens_order = lengths[sym_order]
    codes_order = codes[sym_order]

    num_words = len(buf) // 4
    bits = unpack_bits_msb(buf, num_words)
    total_bits = bits.size
    pad = max_len + 32
    bits_p = np.concatenate([bits, np.zeros(pad, dtype=np.uint8)])

    # window value (max_len bits, MSB-first) at every bit position
    win = np.lib.stride_tricks.sliding_window_view(bits_p, max_len)[:total_bits]
    powers = (np.uint64(1) << np.arange(max_len - 1, -1, -1, dtype=np.uint64))
    W = win.astype(np.uint64) @ powers  # [total_bits]

    # speculative (length, symbol) at every position
    spec_len = np.zeros(total_bits, dtype=np.int32)
    spec_sym = np.zeros(total_bits, dtype=np.int32)
    # iterate lengths short..long; shorter codes win (prefix-free so at most one matches)
    pos = 0
    groups = []  # (len, first_code, first_pos, count)
    while pos < sym_order.size:
        ln = int(lens_order[pos])
        end = pos
        while end < sym_order.size and lens_order[end] == ln:
            end += 1
        groups.append((ln, int(codes_order[pos]), pos, end - pos))
        pos = end
    for ln, first, p0, cnt in groups:
        prefix = (W >> np.uint64(max_len - ln)).astype(np.int64)
        hit = (prefix >= first) & (prefix < first + cnt) & (spec_len == 0)
        spec_sym[hit] = sym_order[p0 + (prefix[hit] - first)]
        spec_len[hit] = ln
    # positions with no valid code: force progress, flag invalid
    invalid = spec_len == 0
    spec_len[invalid] = 1

    # jump table and pointer doubling over symbol-start positions
    jump = np.arange(total_bits + pad, dtype=np.int64)
    jump[:total_bits] += spec_len
    np.minimum(jump, total_bits + pad - 1, out=jump)
    positions = np.zeros(n_symbols, dtype=np.int64)
    filled = 1
    J = jump
    while filled < n_symbols:
        take = min(filled, n_symbols - filled)
        positions[filled : filled + take] = J[positions[:take]]
        filled += take
        if filled < n_symbols:
            J = J[J]

    if int(positions[-1]) >= total_bits or bool(invalid[positions].any()):
        raise ValueError("corrupt huffman stream")
    out = spec_sym[positions]
    end_bitpos = int(positions[-1]) + int(spec_len[positions[-1]])
    used = ((end_bitpos + 31) // 32) * 4 + 4  # + read-ahead pad uint32
    return out.astype(np.int32), used
