"""Device-side whole-image Huffman encoding for 8-bit types.

The reference encodes Byte/Char images losslessly with a 256-symbol
canonical Huffman code, direct or delta-vs-neighbor symbols
(Lerc2.cpp:2311-2468). Data-parallel re-design:

  - symbol streams (direct pixel-major, delta depth-major) are elementwise
    shifts -- no scan-order loop
  - the 256-bin histogram is an exact nibble-factored bf16 matmul:
    histo[16h+l] = sum_i [hi_i==h][lo_i==l] = onehot_hi^T @ onehot_lo,
    in place of an XLA bincount scatter
  - code/length lookup is the same nibble trick: one [N,16]x[16,16*lanes]
    matmul + a one-hot row reduce, in place of a 256-table gather
  - the MSB-first variable-length bitstream is packed per 64-symbol group
    with the one-hot matmul router (bit offsets = per-group exclusive cumsum
    of code lengths), then groups are funnel-shifted to their stream bit
    offset and row-scatter-added -- the same ragged-assembly machinery as
    ops/device_encode.py, one level down at bit granularity

Only the tree build (256 symbols, package-merge on host, ~50 us) leaves
the device, as a 256-int histogram fetch. The canonical code table bytes
are written by the host wrapper (codec/device_codec.py).

DECODE runs on device too when the encoder's per-group bit-offset sidecar
is available (decode_stream_device): groups decode in parallel, the 64
symbols within a group serially -- each step resolves the code length
with a static canonical compare chain (c_L in [first_L, first_L+count_L)
over MSB-aligned prefixes; constants per length, pure elementwise), then
advances a 2-word bit buffer with per-lane dynamic shifts and at most one
window-word shift (L <= 32 crosses at most one word boundary). Symbol
VALUES resolve once at the end with a single nibble-factored exact
lookup over the canonical-order symbol table. Foreign blobs (no sidecar)
fall back to the native host runtime (lerc_native.cpp, 131 Msym/s): a
foreign bitstream has no record boundaries to parallelize over.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import DataType

GROUP = 64  # symbols per packing group


@functools.partial(jax.jit, static_argnames=("h", "w", "d", "dt"))
def symbol_streams_device(data, h: int, w: int, d: int, dt: DataType):
    """All-valid (direct, delta) uint8 symbol streams (Lerc2.cpp:2311-2380).

    direct: pixel-major (depth inner), kBin = offset + val.
    delta:  depth-major; prev = left neighbor in scan order, or the pixel
    above at column 0; (0,0) deltas against 0.
    """
    offset = 128 if dt == DataType.CHAR else 0
    x = data.astype(jnp.int32)  # [H, W, D]
    direct = ((x + offset) & 0xFF).astype(jnp.uint8).reshape(h * w * d)

    left = jnp.concatenate([jnp.zeros((h, 1, d), jnp.int32), x[:, :-1, :]], axis=1)
    above = jnp.concatenate([jnp.zeros((1, w, d), jnp.int32), x[:-1, :, :]], axis=0)
    col = jnp.arange(w, dtype=jnp.int32)[None, :, None]
    row = jnp.arange(h, dtype=jnp.int32)[:, None, None]
    prev = jnp.where(col > 0, left, jnp.where(row > 0, above, 0))
    delta = (((x - prev) + offset) & 0xFF).astype(jnp.uint8)
    delta = delta.transpose(2, 0, 1).reshape(d * h * w)  # depth-major
    return direct, delta


@functools.partial(jax.jit, static_argnames=("h", "w", "d", "dt"))
def symbol_streams_masked_device(data, mask, h: int, w: int, d: int, dt: DataType):
    """Masked (direct, delta) symbol streams, COMPACTED to the valid pixels
    (zero-padded past n_valid * d). Returns (direct, delta, n_valid).

    direct: valid pixels row-major, depth inner. delta: depth-major; prev =
    previous valid pixel in scan order, or the pixel above when the left
    neighbor is invalid but the one above is valid (Lerc2.cpp:2311-2380)."""
    offset = 128 if dt == DataType.CHAR else 0
    x = data.astype(jnp.int32)  # [H, W, D]
    n = h * w
    m = mask.reshape(n)
    n_valid = m.sum().astype(jnp.int32)
    idx = jnp.arange(n, dtype=jnp.int32)
    rank = jnp.cumsum(m).astype(jnp.int32) - 1

    # direct: depth-inner over valid pixels
    dsym = ((x + offset) & 0xFF).astype(jnp.uint8).reshape(n, d)
    direct = jnp.zeros((n, d), jnp.uint8)
    tgt = jnp.where(m, rank, n)
    direct = direct.at[tgt].set(dsym, mode="drop").reshape(n * d)

    # delta: prev = last valid in scan order (cummax fill + gather), or above
    last_valid_idx = jax.lax.cummax(jnp.where(m, idx, -1))
    prev_idx = jnp.concatenate([jnp.full(1, -1, jnp.int32), last_valid_idx[:-1]])
    m2 = mask
    left_ok = jnp.concatenate(
        [jnp.zeros((h, 1), bool), m2[:, 1:] & m2[:, :-1]], axis=1
    ).reshape(n)
    above_ok = jnp.concatenate(
        [jnp.zeros((1, w), bool), m2[1:, :] & m2[:-1, :]], axis=0
    ).reshape(n)
    use_above = (~left_ok) & above_ok & m
    above_idx = idx - w
    src = jnp.where(use_above, above_idx, prev_idx)
    xs = x.reshape(n, d)
    prev_vals = jnp.where(
        (src >= 0)[:, None], xs[jnp.clip(src, 0, n - 1)], 0
    )
    delt = (((xs - prev_vals) + offset) & 0xFF).astype(jnp.uint8)
    delta = jnp.zeros((n, d), jnp.uint8)
    delta = delta.at[tgt].set(delt, mode="drop")  # [rank, depth]
    delta = delta.T.reshape(d * n)  # depth-major over compacted ranks
    return direct, delta, n_valid


@jax.jit
def histogram256(sym):
    """Exact 256-bin histogram of a uint8 array via nibble-factored
    bf16 matmuls (f32 accumulation; chunked so counts stay < 2^24)."""
    n = sym.shape[0]
    n_chunks = max(1, -(-n // (1 << 22)))
    pad = (-n) % n_chunks
    symp = jnp.concatenate([sym, jnp.zeros(pad, jnp.uint8)]) if pad else sym
    live = (jnp.arange(symp.shape[0], dtype=jnp.int32) < n).reshape(n_chunks, -1)
    chunks = symp.reshape(n_chunks, -1)
    i16 = jnp.arange(16, dtype=jnp.int32)
    out = jnp.zeros((16, 16), jnp.uint32)
    for i in range(n_chunks):
        sc = chunks[i]
        a = jnp.where(
            live[i][:, None], (sc >> 4).astype(jnp.int32)[:, None] == i16[None, :], False
        ).astype(jnp.bfloat16)
        b = ((sc & 15).astype(jnp.int32)[:, None] == i16[None, :]).astype(jnp.bfloat16)
        out = out + jax.lax.dot_general(
            a, b, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32
        ).astype(jnp.uint32)
    return out.reshape(256)


def _map256(sym, table_lanes):
    """Per-symbol lookup in a [256] table split into <=255-valued lanes.

    table_lanes: [16, 16, L] f32 (hi, lo, lane). Returns [N, L] f32, exact
    (each entry selected by a one-hot product)."""
    i16 = jnp.arange(16, dtype=jnp.int32)
    hi = (sym >> 4).astype(jnp.int32)
    b = ((sym & 15).astype(jnp.int32)[:, None] == i16[None, :]).astype(jnp.bfloat16)
    L = table_lanes.shape[2]
    # contract over lo: C[lo, (hi, L)]
    C = table_lanes.transpose(1, 0, 2).reshape(16, 16 * L).astype(jnp.bfloat16)
    t = jax.lax.dot_general(  # t[i, 16*? ] = sum_lo b[i,lo] * C[lo, hi*L]
        b, C, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32
    ).reshape(-1, 16, L)
    a = (hi[:, None] == i16[None, :]).astype(jnp.float32)
    return (t * a[:, :, None]).sum(axis=1)


@functools.partial(jax.jit, static_argnames=("cap", "pwh"))
def encode_stream_device(sym, lens_codes, cap: int, pwh: int, live=None):
    """Pack symbols into the reference's MSB-first Huffman bitstream.

    sym: [N] uint8; lens_codes: [256, 5] f32 (len, 4 code byte lanes).
    cap: output byte capacity (multiple of 1024). pwh: packed words per
    64-symbol group (>= ceil(64*maxLen/32)+1, <= 128). live (optional
    [N] bool): positions marked False emit zero bits (gap skipping for
    masked images -- the ragged packer concatenates only live symbols).
    Returns (stream u8 [cap], total_bits i32). Stream words are MSB-first
    bit containers stored little-endian (reference Huffman.h:218-255)."""
    n = sym.shape[0]
    g = -(-n // GROUP)
    padn = g * GROUP - n
    if padn:
        sym = jnp.concatenate([sym, jnp.zeros(padn, jnp.uint8)])
    lk = _map256(sym, lens_codes.reshape(16, 16, 5))
    lens = lk[:, 0].astype(jnp.int32)
    if live is not None:  # gap positions contribute zero bits
        livep = jnp.concatenate([live, jnp.zeros(padn, bool)]) if padn else live
        lens = jnp.where(livep, lens, 0)
    code = jnp.zeros(sym.shape, jnp.uint32)
    for b in range(4):
        code = code | (lk[:, 1 + b].astype(jnp.uint32) << (8 * b))
    if padn:
        lens = jnp.where(jnp.arange(sym.shape[0], dtype=jnp.int32) < n, lens, 0)

    lens2 = lens.reshape(g, GROUP)
    code2 = code.reshape(g, GROUP)
    cum = jnp.cumsum(lens2, axis=1)
    bp = cum - lens2                       # exclusive: bit offset in group
    group_bits = cum[:, -1]

    # MSB-space contributions: top-aligned code split across 2 words
    lv = lens2.astype(jnp.uint32)
    top = jnp.where(lv > 0, code2 << (jnp.uint32(32) - lv), 0)
    s = (bp & 31).astype(jnp.uint32)
    w_idx = bp >> 5
    lo = top >> s
    hiw = jnp.where(s > 0, top << (jnp.uint32(32) - s), 0)

    wr = jnp.arange(pwh, dtype=jnp.int32)
    oh = (w_idx[:, :, None] == wr[None, None, :]).astype(jnp.bfloat16)
    lanes = jnp.stack(
        [((lo >> (8 * b)) & 0xFF).astype(jnp.bfloat16) for b in range(4)]
        + [((hiw >> (8 * b)) & 0xFF).astype(jnp.bfloat16) for b in range(4)],
        axis=2,
    )
    sacc = jax.lax.dot_general(
        oh, lanes, (((1,), (1,)), ((0,), (0,))), preferred_element_type=jnp.float32
    ).astype(jnp.uint32)  # [g, pwh, 8]
    gw = jnp.zeros((g, pwh), jnp.uint32)
    sp = jnp.zeros((g, pwh), jnp.uint32)
    for b in range(4):
        gw = gw + (sacc[:, :, b] << (8 * b))
        sp = sp + (sacc[:, :, 4 + b] << (8 * b))
    gw = gw + jnp.concatenate([jnp.zeros((g, 1), jnp.uint32), sp[:, :-1]], axis=1)

    # ---- assembly: group start bit -> funnel shift + lane roll + row add
    sbits = (jnp.cumsum(group_bits) - group_bits).astype(jnp.int32)
    total_bits = sbits[-1] + group_bits[-1]

    gwp = jnp.concatenate([gw, jnp.zeros((g, 1), jnp.uint32)], axis=1)
    sh5 = (sbits & 31)[:, None]
    for b in range(5):  # MSB-space right shift by sbits & 31
        k = 1 << b
        prev = jnp.concatenate([jnp.zeros((g, 1), jnp.uint32), gwp[:, :-1]], axis=1)
        gwp = jnp.where((sh5 >> b) & 1 == 1, (gwp >> k) | (prev << (32 - k)), gwp)

    wo = sbits >> 5
    lane = (wo & 127)[:, None]
    assert pwh + 1 + 127 <= 256
    rec256 = jnp.concatenate([gwp, jnp.zeros((g, 256 - pwh - 1), jnp.uint32)], axis=1)
    for b in range(7):
        rec256 = jnp.where((lane >> b) & 1 == 1, jnp.roll(rec256, 1 << b, axis=1), rec256)

    cap_w = cap // 4
    rows_idx = (wo >> 7)[:, None] + jnp.arange(2, dtype=jnp.int32)[None, :]
    out2 = jnp.zeros((cap_w // 128, 128), jnp.uint32)
    out2 = out2.at[rows_idx].add(rec256.reshape(g, 2, 128), mode="drop")
    # u32 words out: consumers serialize on host (tobytes, same LE wire)
    # or decode u32-native; the u32->u8 bitcast is a relayout
    stream = out2.reshape(cap_w)
    # sbits doubles as the decode-side acceleration sidecar (per-group bit
    # offsets; HBM metadata, wire unchanged)
    return stream, total_bits, sbits


def canonical_decode_consts(lengths: np.ndarray, codes: np.ndarray):
    """Host-side canonical decode constants from a code table.

    Returns (consts [33, 3] int32 rows (first, first+count, base),
    sorted_syms [256] uint8): canonical codes of one length are
    consecutive integers, so symbol index = base_L + (prefix - first_L)
    into the (length, code)-sorted symbol array (Huffman.cpp:541-572
    canonical property).
    """
    # int32 rows require max code length <= 30: a length-31/32 code's
    # first+count reaches 2^31/2^32 (callers route such tables to the
    # host decoder instead)
    assert int(lengths.max(initial=0)) <= 30
    consts = np.zeros((33, 3), np.int32)
    sorted_syms = np.zeros(256, np.uint8)
    base = 0
    for L in range(1, 33):
        sel = np.nonzero(lengths == L)[0]
        if sel.size == 0:
            consts[L] = (0, 0, 0)  # first == first+count: level never matches
            continue
        cs = codes[sel].astype(np.int64)
        order = np.argsort(cs)
        sorted_syms[base : base + sel.size] = sel[order]
        first = int(cs.min())
        consts[L] = (first, first + sel.size, base)
        base += sel.size
    return consts, sorted_syms


@functools.partial(jax.jit, static_argnames=("n", "max_len"))
def decode_stream_device(stream, sbits, consts, sorted_syms_lanes,
                         n: int, max_len: int, live=None):
    """Decode an MSB-first canonical-Huffman bitstream into [n] uint8
    symbols using the encoder's per-group bit-offset sidecar.

    stream: [cap] u8 (cap % 512 == 0); sbits: [g] i32 group start bits
    (g = ceil(n / GROUP), monotone); consts: [33, 3] i32 canonical rows
    (first, first+count, base) per code length; sorted_syms_lanes:
    [16, 16, 1] f32 canonical-order symbol table for the exact
    nibble-factored lookup. max_len: max code length (static; bounds the
    compare chain and the window size). live (optional [g * GROUP] bool):
    positions marked False consumed ZERO bits at encode time (masked
    images compact symbols per depth plane, leaving gap runs at plane
    tails, Lerc2.cpp:2472-2606) -- the step skips them without advancing
    the bit buffer and their output symbols are unspecified.

    Groups decode in parallel; the GROUP symbols within each group decode
    serially against a 2-word MSB bit buffer: per-lane dynamic bit shifts
    are native, and a step consumes <= 32 bits so the window slides at
    most one word per step (a conditional full-window word shift).
    """
    g = sbits.shape[0]
    assert g == -(-n // GROUP)
    win_w = min((GROUP * max_len + 31) // 32 + 2, 66)
    sw = 64 if win_w + 63 <= 128 else 32
    swb = sw.bit_length() - 1

    if stream.dtype == jnp.uint32:  # u32-native: no minor-dim-4 relayout
        u32 = stream
    else:
        u32 = jax.lax.bitcast_convert_type(stream.reshape(-1, 4), jnp.uint32)
    nq = u32.shape[0] // sw
    wq = u32.reshape(nq, sw)
    n_k = 128 // sw
    wqp = jnp.concatenate([wq, jnp.zeros((n_k - 1, sw), jnp.uint32)], axis=0)
    v = jnp.concatenate([wqp[k : nq + k] for k in range(n_k)], axis=1)
    qw = sbits >> 5
    winr = v.at[jnp.clip(qw >> swb, 0, nq - 1)].get(indices_are_sorted=True)
    lane = (qw & (sw - 1))[:, None]
    for b in range(swb):
        winr = jnp.where((lane >> b) & 1 == 1, jnp.roll(winr, -(1 << b), axis=1), winr)
    win = winr[:, : win_w + 1]
    # bit-align (MSB space): shift the window left by sbits & 31
    s0 = (sbits.astype(jnp.uint32) & 31)[:, None]
    nxt = jnp.concatenate([win[:, 1:], jnp.zeros((g, 1), jnp.uint32)], axis=1)
    win = jnp.where(s0 > 0, (win << s0) | (nxt >> (jnp.uint32(32) - s0)), win)
    win = win[:, :win_w]

    first = consts[:, 0]
    limit = consts[:, 1]
    basec = consts[:, 2]
    gi = jnp.arange(g, dtype=jnp.int32) * GROUP
    lv = jnp.arange(1, max_len + 1, dtype=jnp.int32)
    # stacked per-length canonical rows for the inner scan
    lconst = jnp.stack([lv, first[1 : max_len + 1], limit[1 : max_len + 1],
                        basec[1 : max_len + 1]], axis=1)

    if live is not None:
        live_cols = live.reshape(g, GROUP).T  # [GROUP, g] scan xs
    else:
        live_cols = jnp.ones((GROUP, 1), bool)  # broadcast: all live

    def step_fn(carry, xs):
        step, live_col = xs
        win, o, used, bad = carry
        live_step = (gi + step < n) & live_col
        peek = jnp.where(
            o > 0, (win[:, 0] << o) | (win[:, 1] >> (jnp.uint32(32) - o)), win[:, 0]
        )

        def len_fn(acc, row):
            found, length, idx = acc
            L, f, lim, b = row[0], row[1], row[2], row[3]
            c = (peek >> (jnp.uint32(32) - L.astype(jnp.uint32))).astype(jnp.int32)
            ok = (~found) & (c >= f) & (c < lim)
            return (found | ok, jnp.where(ok, L, length), jnp.where(ok, b + c - f, idx)), None

        (found, length, idx), _ = jax.lax.scan(
            len_fn,
            (jnp.zeros(g, bool), jnp.zeros(g, jnp.int32), jnp.zeros(g, jnp.int32)),
            lconst,
        )
        bad = bad | (live_step & ~found)  # live prefix matching no code: corrupt
        length = jnp.where(live_step, length, 0)
        used = used + length
        o2 = o + length.astype(jnp.uint32)
        shift_word = o2 >= 32
        win = jnp.where(
            shift_word[:, None],
            jnp.concatenate([win[:, 1:], jnp.zeros((g, 1), jnp.uint32)], axis=1),
            win,
        )
        return (win, o2 & 31, used, bad), idx

    (_, _, used, bad), idx_steps = jax.lax.scan(
        step_fn,
        (win, jnp.zeros(g, jnp.uint32), jnp.zeros(g, jnp.int32), jnp.zeros(g, bool)),
        (jnp.arange(GROUP, dtype=jnp.int32), live_cols),
    )
    idxs = idx_steps.T.reshape(g * GROUP)  # [GROUP, g] -> canonical indices
    syms = _map256(idxs.astype(jnp.uint8), sorted_syms_lanes)[:, 0].astype(jnp.uint8)
    # sidecar consistency: each group's consumed bits must equal the next
    # group's start offset delta (the sidecar is untrusted HBM metadata)
    deltas = jnp.concatenate([sbits[1:], sbits[:1]]) - sbits
    is_last = jnp.arange(g, dtype=jnp.int32) == g - 1
    ok_index = (jnp.all((deltas == used) | is_last) & ~jnp.any(bad)
                & (sbits[0] == 0))  # reject a uniformly shifted sidecar
    return syms[:n], used, ok_index


@functools.partial(jax.jit, static_argnames=("n",))
def expand_compacted_device(compact, mask_flat, n: int):
    """Expand rank-compacted values back to image positions: valid
    position p (row-major) gets compact[rank[p]]; invalid positions get 0.

    compact: [cap_r] u32 rank-ordered values, cap_r % 64 == 0, zero-padded
    past the valid count. mask_flat: [n] bool row-major validity.
    Returns [n] u32.

    The values a 64-pixel group needs are a CONTIGUOUS compact window
    [base_g, base_g + cnt_g) (ranks are a prefix sum), so the expansion is
    the same stride-window machinery as the record decode: materialize
    overlapping 128-lane rows of the compact array, ONE sorted row gather
    per group, a dynamic lane roll (6 static roll+selects), then a 64-step
    local select chain -- no element gathers.
    """
    ng = -(-n // GROUP)
    padn = ng * GROUP - n
    m = jnp.concatenate([mask_flat, jnp.zeros(padn, bool)]) if padn else mask_flat
    m2 = m.reshape(ng, GROUP)
    cnt = m2.sum(axis=1).astype(jnp.int32)
    base = jnp.cumsum(cnt) - cnt  # exclusive: first rank of each group

    nq = compact.shape[0] // GROUP
    wq = compact.reshape(nq, GROUP)
    wqp = jnp.concatenate([wq, jnp.zeros((1, GROUP), jnp.uint32)], axis=0)
    v = jnp.concatenate([wqp[0:nq], wqp[1 : nq + 1]], axis=1)  # [nq, 128]
    win = v.at[jnp.clip(base >> 6, 0, nq - 1)].get(indices_are_sorted=True)
    lane = (base & 63)[:, None]
    for b in range(6):  # left roll by base & 63: win[:, r] = compact[base+r]
        win = jnp.where((lane >> b) & 1 == 1, jnp.roll(win, -(1 << b), axis=1), win)

    local_rank = jnp.cumsum(m2, axis=1).astype(jnp.int32) - 1
    local_rank = jnp.where(m2, local_rank, -1)
    vex = jnp.zeros((ng, GROUP), jnp.uint32)
    for s in range(GROUP):
        vex = jnp.where(local_rank == s, win[:, s : s + 1], vex)
    # fence: without it XLA fuses the 64-step chain into each downstream
    # consumer and recomputes it (same pathology as decode_tiles_fast)
    vex = jax.lax.optimization_barrier(vex)
    return vex.reshape(ng * GROUP)[:n]


@functools.partial(jax.jit, static_argnames=("nv", "d", "m_cap"))
def undelta_masked_device(deltas, seg_b, seg_t, seg_par, nv: int, d: int,
                          m_cap: int):
    """Undo the masked delta transform in rank space (Lerc2.cpp:2472-2606).

    Each valid pixel's encoded delta is vs. the PREVIOUS VALID pixel in
    scan order -- except `use_above` pixels (left neighbor invalid, pixel
    above valid) which delta vs. the pixel above. In rank space that is a
    plain prefix sum broken into segments at the use_above pixels, where
    segment k's base chains to an arbitrary EARLIER rank t_k. The segment
    graph is a forest over m << nv nodes, solved with pointer doubling;
    everything else is cumsums + one sorted scatter.

    deltas: [d, nv] i32 (symbol - offset; same tree for every depth
    plane). seg_b: [m_cap] i32 start rank of segment k (seg 0 is the rank-0
    root segment with b=0; pads hold nv). seg_t: [m_cap] i32 rank of the
    above-pixel target (pads 0). seg_par: [m_cap] i32 segment index of
    t_k (pads 0; host-computed from the wire mask). Returns [d, nv] i32
    values in [0, 256).

    int32 cumsum overflow is harmless: 256 | 2^32, so wraparound preserves
    values mod 256.
    """
    s = jnp.cumsum(deltas, axis=1)  # [d, nv] inclusive prefix sums
    real = jnp.arange(m_cap, dtype=jnp.int32) >= 1
    real = real & (seg_b < nv)
    # c_k = s[t_k] - s[b_k - 1]  (B_k = B_par(k) + c_k; B_0 = 0)
    sb = jnp.take(s, jnp.clip(seg_b - 1, 0, nv - 1), axis=1)  # [d, m_cap]
    st = jnp.take(s, jnp.clip(seg_t, 0, nv - 1), axis=1)
    c = jnp.where(real[None, :], st - sb, 0)
    par = jnp.where(real, seg_par, 0)
    steps = max(1, (m_cap - 1).bit_length())
    for _ in range(steps):  # pointer doubling: c becomes B (root-path sum)
        c = c + jnp.take(c, par, axis=1)
        par = par[par]
    # per-rank segment base via sorted scatter of successive B diffs
    prev_c = jnp.concatenate([jnp.zeros((d, 1), jnp.int32), c[:, :-1]], axis=1)
    diffs = jnp.where(real[None, :], c - prev_c, 0)
    tgt = jnp.where(real, seg_b, nv)
    b_rank = jnp.zeros((d, nv), jnp.int32).at[:, tgt].add(
        diffs, mode="drop", indices_are_sorted=True)
    b_rank = jnp.cumsum(b_rank, axis=1)
    return (b_rank + s) & 0xFF


@functools.partial(jax.jit, static_argnames=("h", "w", "d", "dt", "delta"))
def symbols_to_image(sym, h: int, w: int, d: int, dt: DataType, delta: bool):
    """Invert the symbol transform of symbol_streams_device -> [H, W, D].

    direct: pixel-major val = sym - offset. delta: depth-major; the
    scan-order un-delta (prev = left, or above at column 0,
    Lerc2.cpp:2472-2606) factorizes into one vertical mod-256 cumsum down
    column 0 and one horizontal mod-256 cumsum along each row.
    """
    offset = 128 if dt == DataType.CHAR else 0
    if not delta:
        u = (sym.astype(jnp.int32) - offset) & 0xFF
        img = u.reshape(h, w, d)
    else:
        e = (sym.astype(jnp.int32).reshape(d, h, w) - offset)
        col0 = jnp.cumsum(e[:, :, 0], axis=1) & 0xFF           # [D, H]
        rowsrc = jnp.concatenate([col0[:, :, None], e[:, :, 1:]], axis=2)
        img = (jnp.cumsum(rowsrc, axis=2) & 0xFF).transpose(1, 2, 0)
    if dt == DataType.CHAR:
        return (img.astype(jnp.uint8)).astype(jnp.int8)
    return img.astype(jnp.uint8)
