"""Device-side record-offset scan via speculative sizing + pointer doubling.

The Lerc2 tile stream is a serial chain: each record's length depends on its
header bytes. Instead of a host scan, compute a speculative record size at
EVERY byte position (pure gathers), build the jump array J[p] = p + size(p),
and resolve the chain with log2(nRec) pointer-doubling steps -- the same
scheme as the vectorized Huffman decoder. Only positions actually reachable
from 0 carry meaning; garbage jumps elsewhere are never followed.

Limitation: raw-mode records (code 0) have no in-stream length, so their
size needs the block's valid count. This scan supports the uniform-count
case (all-valid images, cnt == 64 for interior blocks); blobs from masked
images with raw blocks route to the native host scanner instead. Edge
blocks (image not a multiple of 8) also carry non-uniform counts -> caller
checks the geometry.

Used by the device-resident decode path (blob stays in HBM end to end).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import DataType


def _gather(stream_u32, idx):
    return stream_u32[jnp.clip(idx, 0, stream_u32.shape[0] - 1)]


@functools.partial(jax.jit, static_argnames=("n_rec", "dt", "version", "cnt_uniform"))
def scan_records_device(
    stream,  # [S] uint8 tile stream (record 0 starts at byte 0)
    n_rec: int,
    dt: DataType,
    version: int,
    cnt_uniform: int = 64,
):
    """Returns per-record (positions, mode, offset_f32/int32, num_bits,
    num_elements, payload_pos, lut_pos, n_lut, nbits_lut), all on device."""
    s = stream.shape[0]
    u = stream.astype(jnp.uint32)
    is_int = dt < DataType.FLOAT
    size_t = {DataType.CHAR: 1, DataType.BYTE: 1, DataType.SHORT: 2, DataType.USHORT: 2,
              DataType.INT: 4, DataType.UINT: 4, DataType.FLOAT: 4}[dt]

    p = jnp.arange(s, dtype=jnp.int32)
    flag = u  # stream byte at p
    code = (flag & 3).astype(jnp.int32)
    bits67 = (flag >> 6).astype(jnp.int32)

    # offset width per reduced dtype (float: tc2->1, tc1->2, tc0->4;
    # int dtypes per Lerc2.h:457-492)
    if not is_int:
        off_w = jnp.where(bits67 == 2, 1, jnp.where(bits67 == 1, 2, 4))
    elif dt in (DataType.CHAR, DataType.BYTE):
        off_w = jnp.ones_like(bits67)
    elif dt == DataType.SHORT:
        off_w = jnp.where(bits67 > 0, 1, 2)
    elif dt == DataType.USHORT:
        off_w = jnp.where(bits67 > 0, 1, 2)
    elif dt == DataType.INT:
        off_w = jnp.where(bits67 == 3, 1, jnp.where(bits67 > 0, 2, 4))
    else:  # UINT
        off_w = jnp.where(bits67 == 2, 1, jnp.where(bits67 == 1, 2, 4))

    # speculative bit-stuffer header at p + 1 + off_w
    nbb_pos = p + 1 + off_w
    nbb = _gather(u, nbb_pos)
    cw_code = (nbb >> 6).astype(jnp.int32)
    cw = jnp.where(cw_code == 0, 4, 3 - cw_code)
    is_lut = (nbb & 32) > 0
    nb = (nbb & 31).astype(jnp.int32)
    ne = jnp.zeros(s, jnp.int32)
    for i in range(4):
        ne = ne | jnp.where(i < cw, _gather(u, nbb_pos + 1 + i) << (8 * i), 0).astype(jnp.int32)
    ne = jnp.clip(ne, 0, 64 * 64)

    stuff_bytes = (ne * nb + 7) >> 3
    # LUT extras: 1 byte nLut+1, LUT table, indices at bitlen(nLut) bits
    nlut_byte = _gather(u, nbb_pos + 1 + cw).astype(jnp.int32)
    n_lut = nlut_byte - 1
    nbits_lut = jnp.zeros(s, jnp.int32)
    for i in range(8):
        nbits_lut = nbits_lut + (n_lut >> i > 0).astype(jnp.int32)
    lut_table_bytes = (n_lut * nb + 7) >> 3
    lut_idx_bytes = (ne * nbits_lut + 7) >> 3

    sz_simple = 1 + off_w + 1 + cw + stuff_bytes
    sz_lut = 1 + off_w + 1 + cw + 1 + lut_table_bytes + lut_idx_bytes
    sz_stuff = jnp.where(is_lut, sz_lut, sz_simple)
    size = jnp.where(
        code == 2, 1,
        jnp.where(code == 3, 1 + off_w,
                  jnp.where(code == 0, 1 + cnt_uniform * size_t, sz_stuff)),
    )
    size = jnp.clip(size, 1, s)

    # pointer doubling over the jump chain
    jump = jnp.minimum(p + size, s)
    positions = jnp.zeros(n_rec, jnp.int32)
    filled = 1
    J = jnp.append(jump, s).astype(jnp.int32)  # sentinel at index s
    while filled < n_rec:
        take = min(filled, n_rec - filled)
        positions = positions.at[filled : filled + take].set(
            J[positions[:take]]
        )
        filled += take
        if filled < n_rec:
            J = J[jnp.minimum(J, s)]

    # per-record descriptor extraction at the resolved positions
    rp = positions
    rflag = _gather(u, rp)
    rcode = (rflag & 3).astype(jnp.int32)
    rb67 = (rflag >> 6).astype(jnp.int32)
    r_off_w = off_w[jnp.clip(rp, 0, s - 1)]
    r_nbb_pos = rp + 1 + r_off_w
    r_nbb = _gather(u, r_nbb_pos)
    r_cw_code = (r_nbb >> 6).astype(jnp.int32)
    r_cw = jnp.where(r_cw_code == 0, 4, 3 - r_cw_code)
    r_is_lut = (r_nbb & 32) > 0
    r_nb = (r_nbb & 31).astype(jnp.int32)
    r_ne = jnp.zeros(n_rec, jnp.int32)
    for i in range(4):
        r_ne = r_ne | jnp.where(i < r_cw, _gather(u, r_nbb_pos + 1 + i) << (8 * i), 0).astype(jnp.int32)
    r_nlut = (_gather(u, r_nbb_pos + 1 + r_cw).astype(jnp.int32) - 1)
    r_nbits_lut = jnp.zeros(n_rec, jnp.int32)
    for i in range(8):
        r_nbits_lut = r_nbits_lut + (r_nlut >> i > 0).astype(jnp.int32)
    lut_pos = r_nbb_pos + 1 + r_cw + 1
    payload_pos = jnp.where(
        rcode == 0, rp + 1,
        jnp.where(
            r_is_lut, lut_pos + ((r_nlut * r_nb + 7) >> 3), r_nbb_pos + 1 + r_cw
        ),
    )
    mode = jnp.where(rcode == 1, jnp.where(r_is_lut, 4, 1), rcode)

    # offset value (zMin) in the reduced dtype
    ob = rp + 1
    acc = jnp.zeros(n_rec, jnp.uint32)
    for i in range(4):
        acc = acc | jnp.where(i < r_off_w, _gather(u, ob + i) << jnp.uint32(8 * i), 0)
    if not is_int:
        # tc2: byte; tc1: int16; tc0: f32 bit pattern
        off_f32 = jax.lax.bitcast_convert_type(acc, jnp.float32)
        i16 = ((acc & 0xFFFF) << 16).astype(jnp.int32) >> 16
        offset = jnp.where(
            rb67 == 2, (acc & 0xFF).astype(jnp.float32),
            jnp.where(rb67 == 1, i16.astype(jnp.float32), off_f32),
        )
    else:
        # sign-extend per reduced width; unsigned reduced types zero-extend
        w8 = (r_off_w == 1)
        w16 = (r_off_w == 2)
        # which reduced dtype is signed depends on dt and tc; for widths that
        # came from DT reduction: byte (unsigned) and char (signed) both 1B.
        if dt == DataType.SHORT:
            signed8 = rb67 == 2
        else:
            signed8 = jnp.zeros(n_rec, bool)
        s8 = jnp.where(signed8, ((acc & 0xFF) << 24).astype(jnp.int32) >> 24,
                       (acc & 0xFF).astype(jnp.int32))
        if dt == DataType.INT:
            signed16 = rb67 == 2  # reduced to short
        elif dt == DataType.SHORT:
            signed16 = rb67 == 0  # full-width short offset
        else:
            signed16 = jnp.zeros(n_rec, bool)
        s16 = jnp.where(signed16, ((acc & 0xFFFF) << 16).astype(jnp.int32) >> 16,
                        (acc & 0xFFFF).astype(jnp.int32))
        if dt in (DataType.CHAR,):
            s8 = ((acc & 0xFF) << 24).astype(jnp.int32) >> 24
        offset = jnp.where(w8, s8, jnp.where(w16, s16, acc.astype(jnp.int32)))

    return (rp, mode, offset, r_nb, r_ne, payload_pos, lut_pos, r_nlut, r_nbits_lut)


def _fold65535(x):
    """x mod 65535 for uint32 x, division-free (2^16 == 1 mod 65535)."""
    x = (x & 0xFFFF) + (x >> 16)
    x = (x & 0xFFFF) + (x >> 16)
    return jnp.where(x >= 65535, x - 65535, x)


def _sum65535(x):
    """Hierarchical exact sum mod 65535 of uint32 entries (< 65535 each),
    division-free: fold -> 64-way tree sums stay below 2^22. Reduction
    runs along the MAJOR axis (reshape (64, -1), sum axis 0) so lanes stay
    fully populated; reducing 64-wide minor rows pads every row to the
    128-lane tile and relayouts at each tree level."""
    while x.size > 64:
        pad = (-x.size) % 64
        if pad:
            x = jnp.concatenate([x, jnp.zeros(pad, jnp.uint32)])
        x = _fold65535(x.reshape(64, -1).sum(axis=0))
    return _fold65535(x.sum())


def _words_sums(words, idx, live, M):
    """(sum w, sum (M - idx) * w) mod 65535 over live entries.

    words < 2^16, idx message-word indices, M total word count (traced
    scalar). Division-free: 2^16 == 1 mod 65535 shift-add folds; products
    stay < 2^32 so u32 arithmetic is exact."""
    wlive = jnp.where(live, words, 0)
    wgt = jnp.where(live, _fold65535(M - idx.astype(jnp.uint32)), 0)
    prod = _fold65535(wlive * wgt)
    return _sum65535(wlive), _sum65535(prod)


@functools.partial(jax.jit, static_argnames=())
def fletcher32_device(prefix, stream, total):
    """Device Fletcher32 (Lerc2 flavor) over prefix || stream[:total].

    prefix: small uint8 array (the host-built header tail after the checksum
    field); stream: fixed-capacity device byte array, ZEROED past `total`,
    with capacity a multiple of 4. Matches the reference's serial
    fold-every-359-words loop (Lerc2.cpp:1037-1064) via the closed form
    s1 = 0xFFFF + sum(w_i), s2 = 0xFFFF*(M+1) + sum((M-i)*w_i) mod 65535
    with the always-positive representative (0 -> 0xffff).

    The stream is consumed as aligned uint32 lanes (big-endian u16 word
    pairs extracted with shifts) instead of strided byte slices, which
    XLA lowers to relayouts. When the static prefix
    length is odd, the stream is funnel-shifted one byte so lanes stay
    aligned, and the straddling word is patched in scalar code.
    """
    P = prefix.shape[0]
    n = P + total
    m_words = (n + 1) // 2  # word count incl. the odd-tail word; trailing
    # zero bytes of the capacity buffer make the tail word b<<8 for free
    M = m_words.astype(jnp.uint32)

    # u32-native streams skip the u8->u32 bitcast, a minor-dim-4 relayout
    if stream.dtype == jnp.uint32:
        u32v0 = stream
    else:
        u32v0 = jax.lax.bitcast_convert_type(stream.reshape(-1, 4), jnp.uint32)

    # ---- prefix words (tiny, static length)
    pu = prefix.astype(jnp.uint32)
    if P % 2 == 0:
        pw = (pu[0:P:2] << 8) | pu[1:P:2]
        stream_first_widx = P // 2
        x = u32v0
        straddle_w = jnp.zeros((0,), jnp.uint32)
        straddle_i = jnp.zeros((0,), jnp.int32)
    else:
        pw = (pu[0 : P - 1 : 2] << 8) | pu[1 : P - 1 : 2]
        # straddle word: last prefix byte | first stream byte
        straddle_w = ((pu[P - 1] << 8) | (u32v0[0] & 0xFF))[None]
        straddle_i = jnp.asarray([(P - 1) // 2], jnp.int32)
        stream_first_widx = (P + 1) // 2
        # shift stream down one byte so u32 lanes align with message words
        nxt = jnp.concatenate([u32v0[1:], jnp.zeros(1, jnp.uint32)])
        x = (u32v0 >> 8) | (nxt << 24)
    we = ((x & 0xFF) << 8) | ((x >> 8) & 0xFF)        # bytes (4k, 4k+1)
    wo = (((x >> 16) & 0xFF) << 8) | (x >> 24)        # bytes (4k+2, 4k+3)
    k = jnp.arange(x.shape[0], dtype=jnp.int32)
    ie = stream_first_widx + 2 * k
    io = ie + 1

    s1p, s2p = _words_sums(
        jnp.concatenate([pw, straddle_w]),
        jnp.concatenate([jnp.arange(pw.shape[0], dtype=jnp.int32), straddle_i]),
        jnp.ones(pw.shape[0] + straddle_w.shape[0], bool), M,
    )
    s1e, s2e = _words_sums(we, ie, ie < m_words, M)
    s1o, s2o = _words_sums(wo, io, io < m_words, M)

    s_w = _fold65535(s1p + s1e + s1o)
    s_wsum = _fold65535(s2p + s2e + s2o)
    s1 = _fold65535(jnp.uint32(0xFFFF) + s_w)
    s2 = _fold65535(_fold65535(jnp.uint32(0xFFFF) * _fold65535(M + 1)) + s_wsum)
    r1 = jnp.where(s1 == 0, 65535, s1)
    r2 = jnp.where(s2 == 0, 65535, s2)
    return (r2.astype(jnp.uint32) << 16) | r1.astype(jnp.uint32)


def fletcher32_partials(data: bytes, word_base: int):
    """Host-side Fletcher32 partial sums of a STATIC message segment:
    (A, B) = (sum w_j, sum i_j * w_j) mod 65535 over the segment's
    big-endian 16-bit words, i_j the GLOBAL message-word index starting
    at `word_base`. The segment must start at an even message-byte
    offset and have even length (callers split an odd tail byte off into
    the adjacent dynamic piece). Fletcher32's closed form is linear in
    these sums, so a byte region that never changes between calls -- the
    fused codec's RLE'd mask section, ~290 KB for a speckled 2048^2 mask
    -- contributes two CONSTANTS instead of 290 KB of per-call u8
    slicing/updating."""
    arr = np.frombuffer(data, np.uint8)
    assert arr.size % 2 == 0
    words = (arr[0::2].astype(np.int64) << 8) | arr[1::2]
    idx = word_base + np.arange(words.size, dtype=np.int64)
    return int(words.sum() % 65535), int((idx * words).sum() % 65535)


@functools.partial(jax.jit, static_argnames=("static_ab",))
def fletcher32_device_parts(pre, static_ab, tail, stream, total):
    """Device Fletcher32 over pre || STATIC || tail || stream[:total].

    Same closed form as fletcher32_device, but the message is four
    pieces: `pre` (u8, even length, message word 0 -- the header bytes
    after the checksum field), a STATIC middle whose precomputed partial
    sums arrive as compile-time constants static_ab = (A, B, n_bytes
    even; from fletcher32_partials with word_base = len(pre)//2), `tail`
    (u8, any length, even start) and the stream. Σ(M-i)w over the static
    piece folds to M*A - B, so its cost is O(1) regardless of size."""
    A, B, nS = static_ab
    P0 = pre.shape[0]
    T = tail.shape[0]
    assert P0 % 2 == 0 and nS % 2 == 0
    P_all = P0 + nS + T
    n = P_all + total
    m_words = (n + 1) // 2
    M = m_words.astype(jnp.uint32)

    if stream.dtype == jnp.uint32:
        u32v0 = stream
    else:
        u32v0 = jax.lax.bitcast_convert_type(stream.reshape(-1, 4), jnp.uint32)

    pu = pre.astype(jnp.uint32)
    pw = (pu[0:P0:2] << 8) | pu[1:P0:2]
    pi = jnp.arange(P0 // 2, dtype=jnp.int32)

    tu = tail.astype(jnp.uint32)
    t_base = (P0 + nS) // 2
    if T % 2 == 0:
        tw = (tu[0:T:2] << 8) | tu[1:T:2]
        ti = t_base + jnp.arange(T // 2, dtype=jnp.int32)
        straddle_w = jnp.zeros((0,), jnp.uint32)
        straddle_i = jnp.zeros((0,), jnp.int32)
        x = u32v0
        stream_first_widx = P_all // 2
    else:
        tw = (tu[0 : T - 1 : 2] << 8) | tu[1 : T - 1 : 2]
        ti = t_base + jnp.arange((T - 1) // 2, dtype=jnp.int32)
        # straddle word: last tail byte | first stream byte
        straddle_w = ((tu[T - 1] << 8) | (u32v0[0] & 0xFF))[None]
        straddle_i = jnp.asarray([(P_all - 1) // 2], jnp.int32)
        stream_first_widx = (P_all + 1) // 2
        nxt = jnp.concatenate([u32v0[1:], jnp.zeros(1, jnp.uint32)])
        x = (u32v0 >> 8) | (nxt << 24)

    we = ((x & 0xFF) << 8) | ((x >> 8) & 0xFF)
    wo = (((x >> 16) & 0xFF) << 8) | (x >> 24)
    k = jnp.arange(x.shape[0], dtype=jnp.int32)
    ie = stream_first_widx + 2 * k
    io = ie + 1

    s1p, s2p = _words_sums(
        jnp.concatenate([pw, tw, straddle_w]),
        jnp.concatenate([pi, ti, straddle_i]),
        jnp.ones(pw.shape[0] + tw.shape[0] + straddle_w.shape[0], bool), M,
    )
    s1e, s2e = _words_sums(we, ie, ie < m_words, M)
    s1o, s2o = _words_sums(wo, io, io < m_words, M)

    # static middle: Σ w = A; Σ (M - i) w = M*A - B (mod 65535)
    s1s = jnp.uint32(A)
    s2s = _fold65535(_fold65535(_fold65535(M) * jnp.uint32(A))
                     + jnp.uint32(65535 - B))

    s_w = _fold65535(_fold65535(s1p + s1e + s1o) + s1s)
    s_wsum = _fold65535(_fold65535(s2p + s2e + s2o) + s2s)
    s1 = _fold65535(jnp.uint32(0xFFFF) + s_w)
    s2 = _fold65535(_fold65535(jnp.uint32(0xFFFF) * _fold65535(M + 1)) + s_wsum)
    r1 = jnp.where(s1 == 0, 65535, s1)
    r2 = jnp.where(s2 == 0, 65535, s2)
    return (r2.astype(jnp.uint32) << 16) | r1.astype(jnp.uint32)


def f32_to_f64_bits(x):
    """IEEE-754 f32 -> f64 bit pattern as (lo32, hi32) uint32 lanes.

    Needed to write the header's double fields on a device without native
    f64. Subnormal f32 inputs map to 0 (never produced by the range
    computations); inf/nan map correctly.
    """
    b = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    s = b >> 31
    e = (b >> 23) & 0xFF
    m = b & 0x7FFFFF
    e64 = jnp.where(e == 0, 0, jnp.where(e == 255, 2047, e + (1023 - 127))).astype(jnp.uint32)
    m_keep = jnp.where(e == 0, 0, m)
    hi = (s << 31) | (e64 << 20) | (m_keep >> 3)
    lo = (m_keep & 7) << 29
    return lo.astype(jnp.uint32), hi.astype(jnp.uint32)
