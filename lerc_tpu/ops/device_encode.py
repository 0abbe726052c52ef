"""Device-side (JAX/XLA) Lerc2 tile encoding.

A data-parallel re-design of the reference's serial byte-cursor
WriteTiles (Lerc2.cpp:1475-1668): micro-blocks become the vector axis, the
two-pass "count then write" becomes stats -> quantize -> per-record sizes
-> exclusive scan -> word-level scatter assembly, all fixed-shape and
jit-compiled.

The design avoids element gathers on the hot path (a choice made for an
accelerator whose gathers were slow; not re-measured on the H100):
  - records are composed as uint32 WORDS (not bytes) from a small set of
    static layout variants (payload byte offset is 4, 5 or 7 depending on
    the reduced offset width), selected elementwise -- no byte matrix, no
    take_along_axis
  - the only data-dependent memory op is one scatter-add of the shifted
    record words at starts[r]>>2 (adjacent records share boundary words;
    byte lanes never collide because every record is tail-masked to its
    exact length)
  - the bit-pack is a scatter-add over non-overlapping bit ranges at word
    granularity

Differences from the host encoder (both produce valid wire format):
  - quantization runs in f32 with a +/-1 candidate fixup against the f32
    reconstruction instead of exact f64; the error bound holds to maxZError
    within a float cast (about 2 ulp of the value), the same order as the
    reference's own ENCODE_VERIFY tolerance (Lerc.cpp:1081-1211 uses
    maxZErr * 1.1)
  - otherwise the tiling features are complete: LUT blocks and the 16x16
    micro-block retrial (mb static arg) are supported

The host wrapper (lerc_tpu.codec.device_codec) adds header/mask/ranges and
the Fletcher32 checksum. `encode_tiles` also returns the per-record start
offsets -- the decode-side acceleration index (SURVEY.md §7) that lets the
device decoder skip the serial record scan for blobs we produced.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import DataType
from .pack_tables import MAX_BITS

MB = 8
BS = MB * MB  # 64 values per block


def _bit_len(x):
    """ceil(log2(x+1)) for uint32 x, exact integer arithmetic."""
    n = jnp.zeros(x.shape, jnp.int32)
    for i in range(MAX_BITS + 1):
        n = n + (x >> i > 0).astype(jnp.int32)
    return n


def _blockize(img, h, w, mb: int = MB):
    """[H, W] -> [nB, mb*mb] padded; returns (blocks, nbv, nbh)."""
    nbv, nbh = -(-h // mb), -(-w // mb)
    padded = jnp.zeros((nbv * mb, nbh * mb), img.dtype).at[:h, :w].set(img)
    blocks = padded.reshape(nbv, mb, nbh, mb).transpose(0, 2, 1, 3).reshape(nbv * nbh, mb * mb)
    return blocks, nbv, nbh


def _reduce_offset_float(zmin):
    """(tc, width) for a float32 block offset (Lerc2.h:493-499)."""
    is_int = (zmin == jnp.round(zmin)) & (jnp.abs(zmin) < 2.0**31)
    tc = jnp.where(
        is_int & (zmin >= 0) & (zmin <= 255), 2,
        jnp.where(is_int & (zmin >= -32768) & (zmin <= 32767), 1, 0),
    ).astype(jnp.int32)
    width = jnp.where(tc == 2, 1, jnp.where(tc == 1, 2, 4)).astype(jnp.int32)
    return tc, width


def _reduce_offset_int(zmin, dt: DataType):
    """(tc, width) for integer dtypes (Lerc2.h:457-492)."""
    z = zmin.astype(jnp.int32)
    fits_byte = (z >= 0) & (z <= 255)
    fits_char = (z >= -128) & (z <= 127)
    fits_short = (z >= -32768) & (z <= 32767)
    fits_ushort = (z >= 0) & (z <= 65535)
    if dt in (DataType.CHAR, DataType.BYTE):
        tc = jnp.zeros(z.shape, jnp.int32)
        width = jnp.ones(z.shape, jnp.int32)
    elif dt == DataType.SHORT:
        tc = jnp.where(fits_char, 2, jnp.where(fits_byte, 1, 0)).astype(jnp.int32)
        width = jnp.where(tc > 0, 1, 2).astype(jnp.int32)
    elif dt == DataType.USHORT:
        tc = jnp.where(fits_byte, 1, 0).astype(jnp.int32)
        width = jnp.where(tc > 0, 1, 2).astype(jnp.int32)
    elif dt == DataType.INT:
        tc = jnp.where(fits_byte, 3, jnp.where(fits_short, 2, jnp.where(fits_ushort, 1, 0))).astype(jnp.int32)
        width = jnp.where(tc == 3, 1, jnp.where(tc > 0, 2, 4)).astype(jnp.int32)
    elif dt == DataType.UINT:
        tc = jnp.where(fits_byte, 2, jnp.where(fits_ushort, 1, 0)).astype(jnp.int32)
        width = jnp.where(tc == 2, 1, jnp.where(tc == 1, 2, 4)).astype(jnp.int32)
    else:
        raise ValueError(dt)
    return tc, width


def _offset_word_float(zmin, tc):
    """Offset value as a LE uint32 word under its reduced dtype (unused
    high bytes zero)."""
    as_u32 = jax.lax.bitcast_convert_type(zmin, jnp.uint32)
    as_i = jnp.round(zmin).astype(jnp.int32)
    u_byte = (as_i & 0xFF).astype(jnp.uint32)
    u_short = (as_i & 0xFFFF).astype(jnp.uint32)
    return jnp.where(tc == 2, u_byte, jnp.where(tc == 1, u_short, as_u32))


def _offset_word_int(zmin, off_w):
    """LE word of an int offset, masked to off_w bytes (two's complement)."""
    word = zmin.astype(jnp.int32).astype(jnp.uint32)
    return jnp.where(
        off_w == 1, word & 0xFF, jnp.where(off_w == 2, word & 0xFFFF, word)
    )


def _pack_words(cq, nb, n_blocks, pw: int):
    """Bit-stuff [nB, 64] quantized values at nb bits each into [nB, pw]
    uint32 words (LSB-first stream) via one-hot matmuls.

    Value v contributes (cq << sh) to word v*nb >> 5 and its spill to the
    next word; contributions never overlap bits. Routing each contribution
    is a per-record permutation -- expressed as a batched one-hot matmul
    over the 4 byte lanes instead of an XLA scatter-add. Byte lanes stay
    <= 255 and <= 3 contributions per word, so bf16 x bf16 -> f32
    accumulation is exact (both operands are bf16: an f32 operand could
    run as TF32 on a GPU)."""
    bs = cq.shape[1]
    bitpos = jnp.arange(bs, dtype=jnp.int32)[None, :] * nb[:, None]
    w_idx = bitpos >> 5
    sh = (bitpos & 31).astype(jnp.uint32)
    lo = cq << sh
    spill = jnp.where(sh > 0, cq >> (jnp.uint32(32) - sh), 0)
    wr = jnp.arange(pw, dtype=jnp.int32)
    oh = (w_idx[:, :, None] == wr[None, None, :]).astype(jnp.bfloat16)
    # one batched [pw, 64] @ [64, 8] matmul: 4 lo byte lanes + 4 spill
    # lanes (spill targets word w_idx + 1 == a one-word shift of the
    # same one-hot, applied to the result instead)
    lanes = jnp.stack(
        [((lo >> (8 * b)) & 0xFF).astype(jnp.bfloat16) for b in range(4)]
        + [((spill >> (8 * b)) & 0xFF).astype(jnp.bfloat16) for b in range(4)],
        axis=2,
    )  # [nB, 64, 8]
    s = jax.lax.dot_general(
        oh, lanes, dimension_numbers=(((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    ).astype(jnp.uint32)  # [nB, pw, 8]
    out = jnp.zeros((n_blocks, pw), jnp.uint32)
    for b in range(4):
        out = out + (s[:, :, b] << (8 * b))
    sp = jnp.zeros((n_blocks, pw), jnp.uint32)
    for b in range(4):
        sp = sp + (s[:, :, 4 + b] << (8 * b))
    # spill lands one word later
    return out + jnp.concatenate(
        [jnp.zeros((n_blocks, 1), jnp.uint32), sp[:, :-1]], axis=1
    )


def _pack_words_grouped(cq, nb, n_blocks, pw: int):
    """Bit-stuff [nB, bs] values at nb <= 16 bits each into [nB, pw] u32
    words (LSB-first stream), exploiting byte alignment of value groups.

    Key identity: 8 values at nb bits occupy exactly nb BYTES, so every
    8-value group starts byte-aligned in the stream. Values merge into
    128-bit group containers with elementwise log-steps (pair -> quad ->
    oct; all shifts < 32 stay in u32 lanes, wider ones split across two
    words), and only the bs/8 containers go through the one-hot matmul
    routing -- 8x fewer one-hot rows than routing every value, which cuts
    the dominant HBM traffic of the pack ~6x. Exact for nb <= 16; callers
    gate on that (records with nb > 16 take _pack_words)."""
    bs = cq.shape[1]
    ng = bs // 8
    nbu = nb.astype(jnp.uint32)[:, None]

    # pairs: value stride 2*nb <= 32 bits, one u32 lane each
    p = cq[:, 0::2] | (cq[:, 1::2] << nbu)  # [nB, bs/2]

    # quads: stride 4*nb <= 64 bits -> two u32 words (lo, hi)
    s2 = 2 * nbu
    p0, p1 = p[:, 0::2], p[:, 1::2]
    qlo = p0 | jnp.where(s2 < 32, p1 << s2, 0)
    qhi = jnp.where(s2 < 32, jnp.where(s2 > 0, p1 >> (32 - s2), 0), p1)

    # octs: stride 8*nb <= 128 bits -> four u32 words per group container
    e0, e1 = qlo[:, 0::2], qhi[:, 0::2]
    o0, o1 = qlo[:, 1::2], qhi[:, 1::2]
    t = 4 * nbu  # shift of the odd quad, in [0, 64]
    r = t & 31
    a_ = t >> 5  # whole-word part: 0, 1, or 2 (t == 64)
    s0 = o0 << r
    s1 = jnp.where(r > 0, (o1 << r) | (o0 >> (32 - r)), o1)
    s2_ = jnp.where(r > 0, o1 >> (32 - r), 0)
    c0 = e0 | jnp.where(a_ == 0, s0, 0)
    c1 = e1 | jnp.where(a_ == 0, s1, jnp.where(a_ == 1, s0, 0))
    c2 = jnp.where(a_ == 0, s2_, jnp.where(a_ == 1, s1, s0))
    c3 = jnp.where(a_ == 1, s2_, jnp.where(a_ == 2, s1, 0))
    c = jnp.stack([c0, c1, c2, c3], axis=-1)  # [nB, ng, 4], nb bytes used

    # group g starts at byte g*nb: pre-shift by the byte phase -> 5 words
    g = jnp.arange(ng, dtype=jnp.int32)[None, :]
    byte_off = g * nb[:, None]  # [nB, ng]
    ph = byte_off & 3
    w0i = byte_off >> 2
    z1 = jnp.zeros_like(c[..., :1])

    def bsh(k):
        if k == 0:
            return jnp.concatenate([c, z1], axis=-1)
        s_ = jnp.uint32(8 * k)
        cp = jnp.concatenate([z1, c], axis=-1)
        cn = jnp.concatenate([c, z1], axis=-1)
        return (cp >> (jnp.uint32(32) - s_)) | (cn << s_)

    sh5 = bsh(0)
    for k in (1, 2, 3):
        sh5 = jnp.where((ph == k)[..., None], bsh(k), sh5)  # [nB, ng, 5]

    # route containers to their word slots: one-hot bf16 matmul over
    # 20 byte lanes (5 words x 4 bytes). Groups occupy disjoint byte
    # ranges, so every (word, lane) slot gets at most one nonzero
    # contribution -- bf16 x {0,1} accumulation is exact.
    wr = jnp.arange(pw, dtype=jnp.int32)
    oh = (w0i[:, :, None] == wr[None, None, :]).astype(jnp.bfloat16)
    lanes = jnp.stack(
        [((sh5[..., k] >> (8 * b)) & 0xFF).astype(jnp.bfloat16)
         for k in range(5) for b in range(4)],
        axis=2,
    )  # [nB, ng, 20]
    s = jax.lax.dot_general(
        oh, lanes, dimension_numbers=(((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    ).astype(jnp.uint32)  # [nB, pw, 20]
    out = jnp.zeros((n_blocks, pw), jnp.uint32)
    for k in range(5):
        wk = jnp.zeros((n_blocks, pw), jnp.uint32)
        for b in range(4):
            wk = wk | (s[:, :, 4 * k + b] << (8 * b))
        if k:
            wk = jnp.concatenate(
                [jnp.zeros((n_blocks, k), jnp.uint32), wk[:, :-k]], axis=1
            )
        out = out | wk
    return out


def _pack_words_static(cq, nb, n_blocks, pw: int, max_nb: int):
    """Bit-stuff [nB, bs] values at nb bits into [nB, pw] u32 words via a
    static-per-nb select chain.

    nb takes at most max_nb distinct small values; for a FIXED nb every
    value's target word and shift are compile-time constants, so packing
    one nb variant is pure shifts/ors over static column slices. The
    <= max_nb variants fuse into one elementwise pass selected by the
    record's nb: no bf16 conversion traffic and no [nB, pw, lanes]
    intermediates (speed against the one-hot routing not measured on the
    H100)."""
    bs = cq.shape[1]
    out = jnp.zeros((n_blocks, pw), jnp.uint32)
    for nbv in range(1, max_nb + 1):
        words = []
        for wi in range(min(pw, (bs * nbv + 31) // 32)):
            acc = None
            j_lo = (wi * 32) // nbv  # first value overlapping word wi
            for j in range(max(0, j_lo - 1), bs):
                lo_bit = j * nbv
                if lo_bit >= (wi + 1) * 32:
                    break
                if lo_bit + nbv <= wi * 32:
                    continue
                bit = lo_bit - wi * 32
                t = cq[:, j] << jnp.uint32(bit) if bit >= 0 else cq[:, j] >> jnp.uint32(-bit)
                acc = t if acc is None else (acc | t)
            words.append(acc)
        cand = jnp.stack(words, axis=1)
        if cand.shape[1] < pw:
            cand = jnp.concatenate(
                [cand, jnp.zeros((n_blocks, pw - cand.shape[1]), jnp.uint32)], axis=1
            )
        out = jnp.where(nb[:, None] == nbv, cand[:, :pw], out)
    return out


def _shift_words_1b(w, k: int):
    """Shift a [N, W] LE word array right by k BYTES in the byte stream
    (i.e. bytes move to higher positions), returning [N, W+1]."""
    if k == 0:
        return jnp.concatenate([w, jnp.zeros((w.shape[0], 1), jnp.uint32)], axis=1)
    z = jnp.zeros((w.shape[0], 1), jnp.uint32)
    wp = jnp.concatenate([z, w], axis=1)          # wp[j] = w[j-1]
    wn = jnp.concatenate([w, z], axis=1)          # wn[j] = w[j]
    s = jnp.uint32(8 * k)
    return (wp >> (jnp.uint32(32) - s)) | (wn << s)


def make_compactor(valid):
    """Stable left-compaction router for [nR, bs] lanes: valid positions
    to their rank slots, invalid slots zeroed.

    LOG-SHIFT routing (round 4): each valid lane moves left by
    d_i = i - rank_i; d is non-decreasing along the row, so routing
    distance bit j (low to high, log2(bs) rounds of one static roll +
    selects) is collision-free -- a lane keeping its element (bit j of
    its residual 0) and receiving one from i+2^j (bit j set) would need
    the invalid-gap count d'-d >= orig'-orig between two valid lanes,
    impossible (the gap is at most orig'-orig-1). It replaces a batched
    one-hot bf16 dot and take_along_axis element gathers (the speed of
    each is not measured on the H100).

    The routing masks depend only on `valid`: build once, compact many
    arrays. Returns compact(*arrs) -> [out, ...]."""
    bs = valid.shape[1]
    nround = max(1, (bs - 1).bit_length())
    lanes_i = jnp.arange(bs, dtype=jnp.int32)[None, :]
    rank = jnp.cumsum(valid, axis=1).astype(jnp.int32) - 1
    dist = jnp.where(valid, lanes_i - rank, 0)
    takes = []
    vcur = valid
    for j in range(nround):
        k = 1 << j
        sd = jnp.roll(dist, -k, axis=1)
        sva = jnp.roll(vcur, -k, axis=1) & (lanes_i + k < bs)
        take = sva & (((sd >> j) & 1) == 1)
        stay = vcur & (((dist >> j) & 1) == 0)
        takes.append(take)
        dist = jnp.where(take, sd, dist)
        vcur = take | stay
    # barrier: the routing masks are shared by every compacted array --
    # without it XLA re-fuses the cumsum/roll mask derivation into each
    # consumer (same recompute pathology as the decode expand chain)
    *takes, vcur = jax.lax.optimization_barrier((*takes, vcur))

    def compact(*arrs):
        outs = []
        for a in arrs:
            v = a
            for j, t in enumerate(takes):
                v = jnp.where(t, jnp.roll(v, -(1 << j), axis=1), v)
            outs.append(jnp.where(vcur, v, jnp.zeros((), a.dtype)))
        # barrier: compacted arrays feed several consumers (packing, the
        # LUT-candidate sort, bit-width max); keep the 12-op roll chain
        # computed ONCE
        outs = list(jax.lax.optimization_barrier(tuple(outs)))
        return outs

    return compact


def make_expander(valid):
    """Inverse of make_compactor: route compacted values (rank slots,
    lanes 0..cnt-1) back to their valid positions. The compaction network
    is a sequence of collision-free (take | stay) rounds, so its exact
    inverse is the SAME take masks applied in reverse order, rolled to
    the receiving lane: forward round j moved the element at i+2^j to i
    when take_j[i], so the inverse sets v[i+2^j] = v[i] there. 6 static
    rolls + selects for 64-lane blocks, replacing the decoder's 64-step
    rank select chain (~10x fewer per-element ops). Returns
    expand(*arrs) -> [out, ...] with invalid lanes zeroed."""
    bs = valid.shape[1]
    nround = max(1, (bs - 1).bit_length())
    lanes_i = jnp.arange(bs, dtype=jnp.int32)[None, :]
    rank = jnp.cumsum(valid, axis=1).astype(jnp.int32) - 1
    dist = jnp.where(valid, lanes_i - rank, 0)
    recvs = []
    vcur = valid
    for j in range(nround):
        k = 1 << j
        sd = jnp.roll(dist, -k, axis=1)
        sva = jnp.roll(vcur, -k, axis=1) & (lanes_i + k < bs)
        take = sva & (((sd >> j) & 1) == 1)
        stay = vcur & (((dist >> j) & 1) == 0)
        recvs.append(jnp.roll(take, k, axis=1))
        dist = jnp.where(take, sd, dist)
        vcur = take | stay
    # barrier: the routing masks are shared by every expanded array
    # (same recompute pathology as the compactor's)
    *recvs, valid_b = jax.lax.optimization_barrier((*recvs, valid))

    def expand(*arrs):
        outs = []
        for a in arrs:
            v = a
            for j in reversed(range(len(recvs))):
                v = jnp.where(recvs[j], jnp.roll(v, 1 << j, axis=1), v)
            outs.append(jnp.where(valid_b, v, jnp.zeros((), a.dtype)))
        outs = list(jax.lax.optimization_barrier(tuple(outs)))
        return outs

    return expand


def _compact_by_rank(vals, rank, valid, width: int):
    """vals[r, p] placed at slot rank[r, p] where valid (rank must be the
    stable cumsum rank of `valid`). Returns [nR, width] u32."""
    assert width == vals.shape[1]
    return make_compactor(valid)(vals)[0]


def _lut_candidate_pre(vals, nb, n_blocks, pw: int, pack=_pack_words):
    """Per-block LUT-mode candidate, SORT side (BitStuffer2::EncodeLut
    semantics, BitStuffer2.cpp:79-153): sorted distinct nonzero values
    bit-stuffed at nb bits.

    Everything here is MULTISET-invariant to valid-compaction: `vals`
    may be the compacted stream (cq) or the position-space blocks with
    invalid lanes zeroed (q) -- both hold the same per-block multiset
    (valid values + zeros), so srt/occ/n_lut/lut_vals come out identical.
    Feeding q keeps the sort, the distinct-value machinery, and the
    lut_vals compactor (a whole second make_compactor) OFF the main
    valid-compaction barrier so XLA overlaps them with the roll chain
    (round-5 masked-encode fix). The le-matrix/index side stays in
    compacted space (part 2) -- routing idx through the compactor was
    measured slower on an earlier accelerator (not measured on the H100).
    Returns (n_lut, nbits_lut, lutpk, lut_bytes, srt, occ, zero_present)."""
    srt = jnp.sort(vals, axis=1)
    prev = jnp.concatenate(
        [jnp.full((n_blocks, 1), 0xFFFFFFFF, jnp.uint32), srt[:, :-1]], axis=1
    )
    occ = srt != prev
    occ_nz = occ & (srt > 0)
    zero_present = (srt[:, 0] == 0).astype(jnp.int32)
    n_lut = occ_nz.sum(axis=1).astype(jnp.int32)
    nbits_lut = _bit_len(n_lut.astype(jnp.uint32))

    rank_nz = jnp.cumsum(occ_nz, axis=1).astype(jnp.int32) - 1
    lut_vals = _compact_by_rank(srt, rank_nz, occ_nz, vals.shape[1])
    lutpk = pack(lut_vals, nb, n_blocks, pw)
    lut_bytes = (n_lut * nb + 7) // 8
    return n_lut, nbits_lut, lutpk, lut_bytes, srt, occ, zero_present


def _lut_candidate_post(srt, occ, zero_present, cvals, cnt, n_lut, nbits_lut,
                        lutpk, lut_bytes, n_blocks, pw: int, pack=_pack_words):
    """LUT candidate, INDEX side: per-lane index of each compacted value
    (#distinct <= v, minus 1 iff 0 is in the set; index 0 denotes value
    0), packed at bitlen(nLut) bits, then the [nLut+1][lut stream][idx
    stream] payload composed at word level. `cvals` is the compacted
    value stream (the merged compaction output: == cq on every block
    that can select LUT mode). Returns payload words."""
    bs = cvals.shape[1]
    le = (srt[:, None, :] <= cvals[:, :, None]) & occ[:, None, :]
    idx = le.sum(axis=2).astype(jnp.int32) - zero_present[:, None]
    pos = jnp.broadcast_to(jnp.arange(bs, dtype=jnp.int32), (n_blocks, bs))
    idx = jnp.where(pos < cnt[:, None], jnp.maximum(idx, 0), 0).astype(jnp.uint32)
    # nbits_lut <= bitlen(n_lut) <= 8 for 16x16 blocks (n_lut < 255), 6 for 8x8
    pw_idx = (bs * (8 if bs > 64 else 6) + 31) // 32 + 1
    idxpk = pack(idx, nbits_lut, n_blocks, pw_idx)

    # payload: [nLut+1][lut stream][idx stream]; compose at word level
    lw = _shift_words_1b(lutpk, 1)  # lut stream at byte 1
    lw = jnp.concatenate(
        [(lw[:, 0] | (n_lut + 1).astype(jnp.uint32))[:, None], lw[:, 1:]], axis=1
    )
    width = 128 if pw + 2 <= 128 else 256
    lwp = jnp.concatenate(
        [lw, jnp.zeros((n_blocks, width - lw.shape[1]), jnp.uint32)], axis=1
    )
    # idx stream at dynamic byte offset 1 + lut_bytes
    ib = 1 + lut_bytes
    sh = ib & 3
    idx_sh = _shift_words_1b(idxpk, 0)
    for k in (1, 2, 3):
        idx_sh = jnp.where((sh == k)[:, None], _shift_words_1b(idxpk, k), idx_sh)
    idxp = jnp.concatenate(
        [idx_sh, jnp.zeros((n_blocks, width - idx_sh.shape[1]), jnp.uint32)], axis=1
    )
    lane = (ib >> 2)[:, None]
    for b in range(width.bit_length() - 1):  # word-level roll to the lut end
        idxp = jnp.where((lane >> b) & 1 == 1, jnp.roll(idxp, 1 << b, axis=1), idxp)
    return lwp | idxp


@functools.partial(
    jax.jit,
    static_argnames=("h", "w", "d", "dt", "all_valid", "version", "cap",
                     "enable_lut", "mb", "nb_cap", "out_u32"),
)
def encode_tiles(
    data,  # [H, W, D] float32 or int32
    mask,  # [H, W] bool (ignored when all_valid)
    max_z_error,  # f32 scalar; 0.5 for int lossless
    h: int,
    w: int,
    d: int,
    dt: DataType,
    all_valid: bool,
    version: int,
    cap: int,
    enable_lut: bool = False,
    mb: int = 8,
    nb_cap: int = 0,
    out_u32: bool = False,
):
    """Returns (out_bytes [cap] u8, total_len, z_min_vec [D], z_max_vec [D],
    starts [nRec] i32, fits bool) -- starts is the record-offset
    acceleration index.

    nb_cap > 0 statically caps the per-block packed bit width the kernel
    is sized for; with nb_cap <= 16 the much cheaper byte-aligned grouped
    pack is used (and for 8/16-bit dtypes it always is). If any selected
    block needs more bits than the cap, the stream is invalid and `fits`
    is False -- callers re-encode with nb_cap=0 (see device_codec /
    FusedResidentCodec). fits is always True when the cap covers the
    dtype's max width."""
    is_int = dt < DataType.FLOAT
    size_t = {DataType.CHAR: 1, DataType.BYTE: 1, DataType.SHORT: 2, DataType.USHORT: 2,
              DataType.INT: 4, DataType.UINT: 4, DataType.FLOAT: 4}[dt]
    maxq_cap = float((1 << 15) - 1 if size_t <= 2 else (1 << 30) - 1)
    bs = mb * mb  # values per micro block (64, or 256 for the 16x16 retrial)
    # max numBits for this dtype bounds the packed-word count
    max_nb = {1: 8, 2: 16, 4: 31}[size_t]
    eff_cap = max_nb if nb_cap <= 0 else min(nb_cap, max_nb)
    grouped = eff_cap <= 16
    always_fits = eff_cap >= max_nb
    pw = (bs * eff_cap + 31) // 32 + 1  # +1 spill slack
    if grouped:
        assert (bs // 8 * eff_cap + 2) // 4 + 1 <= pw

    # 8x8 blocks under an EXPLICIT narrow cap pack via the static-per-nb
    # select chain; the default/uncapped variants keep the one-hot kernels
    # -- the chain's <= 16 variants compile much more slowly, so only the
    # resident codec and the bench opt in via nb_cap
    use_static_pack = bs == 64 and 0 < nb_cap <= 16

    def pack(vals, nbits, nblk, pw_):
        if use_static_pack:
            return _pack_words_static(vals, nbits, nblk, pw_, eff_cap)
        if grouped:
            return _pack_words_grouped(vals, nbits, nblk, pw_)
        return _pack_words(vals, nbits, nblk, pw_)
    raw_w = (1 + bs * size_t + 3) // 4  # raw record word count
    stuff_w = max((8 + 4 * (pw - 1) + 3) // 4, pw + 3) + 1
    # under a bit-width cap, raw records may exceed the stuff-sized record
    # window; they flip `fits` (like over-cap nb) instead of widening every
    # record's roll/scatter window to raw size
    raw_ok = always_fits or raw_w <= stuff_w
    rec_w = max(raw_w, stuff_w) if raw_ok else stuff_w
    cap_w = cap // 4
    assert cap % 4 == 0

    mze = max_z_error.astype(jnp.float32)
    scale = jnp.where(mze > 0, 1.0 / (2.0 * mze), 0.0).astype(jnp.float32)
    inv_scale = (2.0 * mze).astype(jnp.float32)
    int_lossless = is_int & (mze == 0.5)

    vb, nbv, nbh = _blockize(
        jnp.ones((h, w), bool) if all_valid else mask, h, w, mb
    )
    n_blocks = nbv * nbh
    cnt = vb.sum(axis=1).astype(jnp.int32)  # [nB] <= bs
    cw = jnp.where(cnt < 256, 1, 2)  # count byte width (2 only for full 16x16)

    # compaction: valid positions first, stable. Even in the all-valid
    # case edge blocks need compaction (padding positions are interleaved
    # row-major when H or W is not a multiple of 8). Log-shift routing
    # (make_compactor); the routing masks depend only on the mask, so they
    # are built once and reused across depths and arrays.
    aligned_all_valid = all_valid and h % mb == 0 and w % mb == 0
    if not aligned_all_valid:
        _compact_u32 = make_compactor(vb)

    # per-block j0 for the integrity bits
    j0 = (jnp.arange(n_blocks, dtype=jnp.int32) % nbh) * mb
    integ = ((j0 >> 3) & 15) << 2
    if version >= 5:
        integ = integ & 0b111000

    per_depth = []
    z_min_out = []
    z_max_out = []

    for di in range(d):
        xb, _, _ = _blockize(data[:, :, di], h, w, mb)  # native dtype blocks
        fb = xb.astype(jnp.float32)
        big = jnp.where(vb, fb, jnp.inf)
        small = jnp.where(vb, fb, -jnp.inf)
        zmin = jnp.where(cnt > 0, big.min(axis=1), 0.0)
        zmax = jnp.where(cnt > 0, small.max(axis=1), 0.0)
        # per-depth image range for the ranges section (exact dtype arithmetic)
        if is_int:
            xi32 = xb.astype(jnp.int32)
            z_min_out.append(jnp.where(vb, xi32, 2**31 - 1).min())  # int32, exact
            z_max_out.append(jnp.where(vb, xi32, -(2**31)).max())
        else:
            z_min_out.append(jnp.where(cnt > 0, big.min(axis=1), jnp.inf).min())
            z_max_out.append(jnp.where(cnt > 0, small.max(axis=1), -jnp.inf).max())

        # ---- quantize with fixup
        if is_int:
            xi = xb.astype(jnp.int32)
            zmin_i = jnp.where(cnt > 0, jnp.where(vb, xi, 2**31 - 1).min(axis=1), 0)
            q_ll = (xi - zmin_i[:, None]).astype(jnp.int32)
            # lossy int: f32 + fixup against integer reconstruction
            q0 = jnp.round((xi - zmin_i[:, None]).astype(jnp.float32) * scale).astype(jnp.int32)
            inv_i = jnp.round(inv_scale).astype(jnp.int32)
            # sign-directed fixup: err(q) is V-shaped, so the only possibly
            # better candidate is one step toward the residual's sign
            resid = xi - (zmin_i[:, None] + q0 * inv_i)
            qc = jnp.maximum(q0 + jnp.sign(resid), 0)
            errc = jnp.abs(xi - (zmin_i[:, None] + qc * inv_i))
            best = jnp.where(errc < jnp.abs(resid), qc, q0)
            q = jnp.where(int_lossless, q_ll, best).astype(jnp.uint32)
            zmin = zmin_i.astype(jnp.float32)  # only used for mode heuristics
            zmin_store = zmin_i
        else:
            dx = fb - zmin[:, None]
            q0 = jnp.round(dx * scale)
            # sign-directed fixup: err(q) is V-shaped, so the only possibly
            # better candidate is one step toward the residual's sign
            resid = fb - (zmin[:, None] + q0 * inv_scale)
            qc = jnp.maximum(q0 + jnp.sign(resid), 0.0)
            errc = jnp.abs(fb - (zmin[:, None] + qc * inv_scale))
            best = jnp.where(errc < jnp.abs(resid), qc, q0)
            q = jnp.clip(best, 0.0, 2.0**31).astype(jnp.uint32)
            zmin_store = zmin

        q = jnp.where(vb, q, 0)
        if is_int:
            xu = xb.astype(jnp.int32).astype(jnp.uint32)
        else:
            xu = jax.lax.bitcast_convert_type(xb.astype(jnp.float32), jnp.uint32)
        xu_z = xu if aligned_all_valid else jnp.where(vb, xu, 0)

        # Mode selection runs in POSITION space: max/bit-width/lengths and
        # the LUT sort side are multiset-invariant to compaction (invalid
        # lanes are zero either way), so the mode of every block is known
        # BEFORE compaction and only ONE merged array -- native words for
        # raw-mode blocks, the selected quantized stream otherwise --
        # rides the compaction roll chain (round 5: r4 compacted q AND xu,
        # and the int depth-diff path a third array, plus the whole LUT
        # candidate sat behind the compaction barrier).
        max_q = q.max(axis=1)
        nb = _bit_len(max_q)

        # ---- mode selection (NumBytesTile semantics, no LUT)
        max_val = (zmax - zmin) * scale
        is_const0 = (cnt == 0) | ((zmin == 0) & (zmax == 0))
        force_raw = ((mze == 0) & (zmax > zmin)) | ((mze > 0) & (max_val > maxq_cap))

        if is_int:
            tc, off_w = _reduce_offset_int(zmin_store, dt)
            off_word = _offset_word_int(zmin_store, off_w)
        else:
            tc, off_w = _reduce_offset_float(zmin)
            off_word = _offset_word_float(zmin, tc)

        stuff_bytes = (cnt * nb + 7) // 8
        stuff_len = 1 + off_w + jnp.where(max_q > 0, 1 + cw + stuff_bytes, 0)
        raw_len = 1 + cnt * size_t

        if enable_lut:
            (n_lut, nbits_lut, lutpk, lut_bytes, srt, occ,
             zero_present) = _lut_candidate_pre(q, nb, n_blocks, pw, pack)
            idx_bytes = (cnt * nbits_lut + 7) // 8
            lut_len = 2 + cw + off_w + 1 + lut_bytes + idx_bytes
            use_lut = ((max_q > 0) & (n_lut >= 1) & (n_lut < 255)
                       & (lut_len < stuff_len))
            stuff_len = jnp.where(use_lut, lut_len, stuff_len)
        else:
            use_lut = jnp.zeros(n_blocks, bool)

        # ---- depth-diff candidate (v5+, int lossless, nDepth > 1): encode
        # slice di vs di-1 when strictly smaller (Lerc2.cpp:1803-1945; flag
        # bit2 marks the diff). int32 arithmetic is exact for <= 16-bit
        # dtypes; INT/UINT diffs can overflow and keep absolute encoding.
        try_diff = is_int and d > 1 and version >= 5 and size_t <= 2
        stuff_val = q
        if try_diff and di > 0:
            diffv = xi - prev_xi
            zmin_df = jnp.where(cnt > 0, jnp.where(vb, diffv, 2**30).min(axis=1), 0)
            zmax_df = jnp.where(cnt > 0, jnp.where(vb, diffv, -(2**30)).max(axis=1), 0)
            qd = jnp.where(vb, (diffv - zmin_df[:, None]).astype(jnp.uint32), 0)
            max_qd = qd.max(axis=1)
            nbd = _bit_len(max_qd)
            tc_d, off_w_d = _reduce_offset_int(zmin_df, DataType.INT)
            off_word_d = _offset_word_int(zmin_df, off_w_d)
            stuff_bytes_d = (cnt * nbd + 7) // 8
            stuff_len_d = 1 + off_w_d + jnp.where(max_qd > 0, 1 + cw + stuff_bytes_d, 0)
            use_lut_d = jnp.zeros(n_blocks, bool)
            if enable_lut:
                (n_lut_d, nbits_lut_d, lutpk_d, lut_bytes_d, srt_d, occ_d,
                 zp_d) = _lut_candidate_pre(qd, nbd, n_blocks, pw, pack)
                idx_bytes_d = (cnt * nbits_lut_d + 7) // 8
                lut_len_d = 2 + cw + off_w_d + 1 + lut_bytes_d + idx_bytes_d
                use_lut_d = ((max_qd > 0) & (n_lut_d >= 1) & (n_lut_d < 255)
                             & (lut_len_d < stuff_len_d))
                stuff_len_d = jnp.where(use_lut_d, lut_len_d, stuff_len_d)
            const0_d = (zmin_df == 0) & (zmax_df == 0)
            diff_len = jnp.where(const0_d, 1, stuff_len_d)
            use_diff = (int_lossless & (cnt > 0) & (~is_const0)
                        & (diff_len < stuff_len) & (diff_len < raw_len))
            is_const0 = is_const0 | (use_diff & const0_d)
            stuff_len = jnp.where(use_diff, stuff_len_d, stuff_len)
            nb = jnp.where(use_diff, nbd, nb)
            max_q = jnp.where(use_diff, max_qd, max_q)
            tc = jnp.where(use_diff, tc_d, tc)
            off_w = jnp.where(use_diff, off_w_d, off_w)
            off_word = jnp.where(use_diff, off_word_d, off_word)
            use_lut = jnp.where(use_diff, use_lut_d, use_lut)
            stuff_val = jnp.where(use_diff[:, None], qd, q)
            if enable_lut:
                n_lut = jnp.where(use_diff, n_lut_d, n_lut)
                nbits_lut = jnp.where(use_diff, nbits_lut_d, nbits_lut)
                lutpk = jnp.where(use_diff[:, None], lutpk_d, lutpk)
                lut_bytes = jnp.where(use_diff, lut_bytes_d, lut_bytes)
                srt = jnp.where(use_diff[:, None], srt_d, srt)
                occ = jnp.where(use_diff[:, None], occ_d, occ)
                zero_present = jnp.where(use_diff, zp_d, zero_present)
            diff_bit = use_diff.astype(jnp.uint32)
        else:
            diff_bit = jnp.zeros(n_blocks, jnp.uint32)
        if is_int:
            prev_xi = xi

        use_stuff = (~force_raw) & (stuff_len < raw_len)
        mode = jnp.where(
            is_const0, 2,
            jnp.where(use_stuff, jnp.where(max_q > 0, 1, 3), 0),
        ).astype(jnp.int32)
        length = jnp.where(
            mode == 2, 1, jnp.where(mode == 0, raw_len, stuff_len)
        ).astype(jnp.int32)

        # ---- ONE merged compaction; raw-mode blocks carry native words,
        # every other mode the selected quantized stream (packed bits
        # bleeding block-locally past nb for raw blocks are discarded by
        # the record select below)
        merged = jnp.where((mode == 0)[:, None], xu_z, stuff_val)
        if aligned_all_valid:
            c_merged = merged
        else:
            (c_merged,) = _compact_u32(merged)

        # ---- packed payload words [nB, pw]
        pk = pack(c_merged, nb, n_blocks, pw)
        if enable_lut:
            lut_payload = _lut_candidate_post(
                srt, occ, zero_present, c_merged, cnt, n_lut, nbits_lut,
                lutpk, lut_bytes, n_blocks, pw, pack)
            pk = jnp.where(use_lut[:, None], lut_payload[:, :pw], pk)

        flag = (integ | (diff_bit << 2)
                | jnp.where(mode == 0, 0, jnp.where(mode == 2, 2, jnp.where(max_q > 0, 1, 3)))
                | jnp.where(mode == 2, 0, jnp.where(mode == 0, 0, tc << 6))).astype(jnp.uint32)
        pkp = jnp.concatenate([jnp.zeros((n_blocks, 2), jnp.uint32), pk], axis=1)
        # pad to rec_w + 1 so static slices below stay in range
        if pkp.shape[1] < rec_w + 2:
            pkp = jnp.concatenate(
                [pkp, jnp.zeros((n_blocks, rec_w + 2 - pkp.shape[1]), jnp.uint32)], axis=1
            )

        # count-width code: 3 - cw (cw=1 -> 2, cw=2 -> 1)
        nbb = (nb.astype(jnp.uint32) | (use_lut.astype(jnp.uint32) << 5)
               | ((3 - cw).astype(jnp.uint32) << 6))  # numBits byte
        cnt_u = cnt.astype(jnp.uint32)
        c0 = cnt_u & 0xFF
        c1 = (cnt_u >> 8) & 0xFF

        # ---- record words [nB, rec_w], gather-free composition.
        # Stuff layouts by (off_w, cw); payload byte offset p = 2+off_w+cw:
        #   (1,1) p=4: [flag off0 nbb c0 | payload...]
        #   (1,2) p=5: [flag off0 nbb c0 | c1 payload...]
        #   (2,1) p=5: [flag off0 off1 nbb | c0 payload...]
        #   (2,2) p=6: [flag off0 off1 nbb | c0 c1 payload...]
        #   (4,1) p=7: [flag off0..off2 | off3 nbb c0 payload...]
        #   (4,2) p=8: [flag off0..off2 | off3 nbb c0 c1 | payload...]
        ob0 = off_word & 0xFF
        ob1 = (off_word >> 8) & 0xFF
        ob2 = (off_word >> 16) & 0xFF
        ob3 = (off_word >> 24) & 0xFF
        pay_pos = 2 + off_w + cw

        w0 = jnp.where(
            off_w == 1, flag | (ob0 << 8) | (nbb << 16) | (c0 << 24),
            jnp.where(off_w == 2, flag | (ob0 << 8) | (ob1 << 16) | (nbb << 24),
                      flag | (ob0 << 8) | (ob1 << 16) | (ob2 << 24)),
        )
        pk0 = pkp[:, 2]
        w1_11 = pk0
        w1_12 = c1 | (pk0 << 8)
        w1_21 = c0 | (pk0 << 8)
        w1_22 = c0 | (c1 << 8) | (pk0 << 16)
        w1_41 = ob3 | (nbb << 8) | (c0 << 16) | ((pk0 & 0xFF) << 24)
        w1_42 = ob3 | (nbb << 8) | (c0 << 16) | (c1 << 24)
        w1 = jnp.where(
            off_w == 1, jnp.where(cw == 1, w1_11, w1_12),
            jnp.where(off_w == 2, jnp.where(cw == 1, w1_21, w1_22),
                      jnp.where(cw == 1, w1_41, w1_42)),
        )

        # words j >= 2 by payload offset p (static byte shifts of pk; note
        # pkp[:, j] == pk[j-2])
        a = pkp[:, 2 : 2 + rec_w - 2]
        b_ = pkp[:, 3 : 3 + rec_w - 2]
        pp = pay_pos[:, None]
        body = jnp.where(
            pp == 4, b_,
            jnp.where(pp == 5, (a >> 24) | (b_ << 8),
                      jnp.where(pp == 6, (a >> 16) | (b_ << 16),
                                jnp.where(pp == 7, (a >> 8) | (b_ << 24), a))),
        )
        stuff_words = jnp.concatenate([w0[:, None], w1[:, None], body], axis=1)
        # mode 3 (const-offset): flag + offset bytes only -- same head layout
        # with payload absent; the tail mask below truncates to 1 + off_w.
        # mode 2 (const-0): flag only; tail mask truncates to 1 byte.
        # But w0_1/w0_2 embed nbb/cnt in bytes <= off_w; rebuild head for
        # mode 3 so those bytes are offset bytes, not stuffer header:
        w0_c = flag | (ob0 << 8) | (ob1 << 16) | (ob2 << 24)
        w1_c = ob3
        const_head = jnp.concatenate(
            [w0_c[:, None], w1_c[:, None], jnp.zeros((n_blocks, rec_w - 2), jnp.uint32)],
            axis=1,
        )

        # ---- raw payload words (compacted native u32 values, LE at byte 1;
        # c_merged holds the compacted native words on raw-mode blocks)
        if size_t == 4:
            rw = c_merged
        elif size_t == 2:
            u = c_merged & 0xFFFF
            rw = u[:, 0::2] | (u[:, 1::2] << 16)
        else:
            u = c_merged & 0xFF
            rw = u[:, 0::4] | (u[:, 1::4] << 8) | (u[:, 2::4] << 16) | (u[:, 3::4] << 24)
        nrw = rw.shape[1]
        rwp = jnp.concatenate(
            [jnp.zeros((n_blocks, 1), jnp.uint32), rw,
             jnp.zeros((n_blocks, max(0, rec_w - nrw)), jnp.uint32)], axis=1
        )[:, : rec_w + 1]
        raw_words = (rwp[:, :rec_w] >> 24) | (rwp[:, 1 : rec_w + 1] << 8)
        raw_words = jnp.concatenate(
            [(raw_words[:, 0] | flag)[:, None], raw_words[:, 1:]], axis=1
        )

        m2 = mode[:, None]
        rec = jnp.where(
            m2 == 0, raw_words,
            jnp.where(m2 == 1, stuff_words,
                      jnp.where(m2 == 3, const_head,
                                jnp.concatenate([flag[:, None], jnp.zeros((n_blocks, rec_w - 1), jnp.uint32)], axis=1))),
        )

        # ---- tail mask: zero bytes at positions >= length (required so the
        # assembly scatter-ADD can merge boundary words of adjacent records)
        jb = jnp.arange(rec_w, dtype=jnp.int32)[None, :] * 4
        keep = jnp.clip(length[:, None] - jb, 0, 4)
        bmask = jnp.where(
            keep >= 4, jnp.uint32(0xFFFFFFFF),
            (jnp.uint32(1) << (jnp.uint32(8) * keep.astype(jnp.uint32))) - jnp.uint32(1),
        )
        rec = rec & bmask

        if always_fits:
            fits_d = jnp.bool_(True)
        else:
            # bit-stuffed payloads over the cap use the pack; raw records
            # need raw_w words, excluded from the capped record window
            bad = (mode == 1) & (nb > eff_cap)
            if not raw_ok:
                bad = bad | (mode == 0)
            fits_d = ~jnp.any(bad)
        per_depth.append((rec, length, fits_d))

    # ---- interleave records block-major, depth inner: r = b*D + d
    if d == 1:
        rec, length, fits = per_depth[0]
    else:
        rec = jnp.stack([p[0] for p in per_depth], axis=1).reshape(n_blocks * d, rec_w)
        length = jnp.stack([p[1] for p in per_depth], axis=1).reshape(n_blocks * d)
        fits = functools.reduce(jnp.logical_and, [p[2] for p in per_depth])
    n_rec = n_blocks * d

    # ---- assembly: exclusive scan of lengths -> shift each record by
    # (starts & 3) bytes -> roll to its lane offset -> row-level scatter-add
    # of [2, 128]-word rows. Full-row scatter updates move 512 B per index
    # instead of one element; adjacent records share boundary words and
    # merge by addition (tails are zero-masked).
    starts = (jnp.cumsum(length) - length).astype(jnp.int32)
    total = starts[-1] + length[-1]

    sh = starts & 3
    shifted = _shift_words_1b(rec, 0)
    for k in (1, 2, 3):
        shifted = jnp.where((sh == k)[:, None], _shift_words_1b(rec, k), shifted)

    q = starts >> 2  # word offset of each record
    span = rec_w + 1
    assert cap_w % 128 == 0
    if span + 63 <= 128:
        stride = 64
    elif span + 31 <= 128:
        stride = 32
    else:
        stride = 0  # wide records (16x16 retrial): legacy 2-span scatter
    if stride:
        # stride-S window scatter: record r lands in window row j = q // S
        # at lane q % S (fits: lane + span <= 128), so the lane roll is
        # log2(S) steps over 128 lanes and the scatter is ONE sorted
        # row-add; out[S*j + t] = sum_k V[j-k, t + k*S] recombines the
        # overlapping windows elementwise (the scatter-side mirror of the
        # decode-side overlapping-stride window trick)
        lane = (q & (stride - 1))[:, None]
        rec128 = jnp.concatenate(
            [shifted, jnp.zeros((n_rec, 128 - span), jnp.uint32)], axis=1
        )
        for b in range(stride.bit_length() - 1):
            rec128 = jnp.where((lane >> b) & 1 == 1, jnp.roll(rec128, 1 << b, axis=1), rec128)
        n_j = cap_w // stride
        n_k = 128 // stride
        v = jnp.zeros((n_j + n_k, 128), jnp.uint32)
        v = v.at[q >> (stride.bit_length() - 1)].add(
            rec128, mode="drop", indices_are_sorted=True
        )
        out2 = v[:n_j, :stride]
        for k in range(1, n_k):
            out2 = out2 + jnp.concatenate(
                [jnp.zeros((k, stride), jnp.uint32),
                 v[: n_j - k, k * stride : (k + 1) * stride]], axis=0
            )
    else:
        lane = (q & 127)[:, None]
        w_roll = 256 if span + 127 <= 256 else 512
        assert span + 127 <= w_roll
        rec256 = jnp.concatenate(
            [shifted, jnp.zeros((n_rec, w_roll - rec_w - 1), jnp.uint32)], axis=1
        )
        for b in range(7):  # dynamic lane roll composed from static rolls
            rec256 = jnp.where((lane >> b) & 1 == 1, jnp.roll(rec256, 1 << b, axis=1), rec256)
        n_row = cap_w // 128
        n_span = w_roll // 128
        # one scatter per 128-word span, each with sorted row indices
        r_row = q >> 7
        spans = rec256.reshape(n_rec, n_span, 128)
        out2 = jnp.zeros((n_row, 128), jnp.uint32)
        for k in range(n_span):
            out2 = out2.at[r_row + k].add(
                spans[:, k], mode="drop", indices_are_sorted=True
            )

    if out_u32:
        # u32 lanes end-to-end: the u32->u8 bitcast is a minor-dim-4
        # relayout and consumers (fletcher, decode windows) bitcast BACK;
        # resident pipelines keep the stream as words and materialize
        # bytes on host (same LE bytes)
        stream = out2.reshape(cap_w)
    else:
        stream = jax.lax.bitcast_convert_type(out2.reshape(cap_w), jnp.uint8).reshape(cap)
    return stream, total, jnp.stack(z_min_out), jnp.stack(z_max_out), starts, fits
