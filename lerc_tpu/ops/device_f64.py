"""Device-side Lerc2 tile encoding for float64 via double-single arithmetic.

Written for an accelerator without fast f64: f64 values travel as NORMALIZED two-float pairs
(hi = f32(x), lo = f32(x - hi), split exactly on host) plus their raw bit
patterns (2 x u32) for the wire. Quantization runs in double-single
(~2^-45 relative accuracy: Knuth TwoSum / Veltkamp-split Dekker products),
refined by a residual Newton step and the sign-directed fixup, so the
reconstruction error stays within maxZError to double-single accuracy --
well inside the maxZError*1.1 ENCODE_VERIFY tolerance the reference itself
uses (Lerc.cpp:1081-1211).

Wire simplifications (all decodable by any LERC reader; the host encoder
keeps the reference-exact choices): block offsets always use the full
8-byte double (no reduced offset dtypes), micro block is 8x8, no LUT mode.
Records: [flag][offset f64][numBits|cw][cnt][bit-stuffed payload] with
payload at byte offset 11 -- word offset 2, byte shift 3.

Only encode: float64 DECODE stays on the exact host path (reconstruction
must be f64-exact there).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .device_encode import _bit_len, _blockize, _pack_words, _shift_words_1b

MB = 8
BS = 64
_SPLIT = jnp.float32(4097.0)  # Veltkamp split constant for f32 (2^12 + 1)


def split_f64_host(x: np.ndarray):
    """Exact host-side split of f64 into normalized (hi, lo) f32 pairs and
    the raw little-endian u32 bit pattern [..., 2]."""
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    bits = x.view(np.uint64)
    b = np.stack([(bits & 0xFFFFFFFF).astype(np.uint32),
                  (bits >> 32).astype(np.uint32)], axis=-1)
    return hi, lo, b


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):  # requires |a| >= |b|
    s = a + b
    return s, b - (s - a)


def _ds_norm(hi, lo):
    return _quick_two_sum(hi, lo)


def ds_add(ah, al, bh, bl):
    s, e = _two_sum(ah, bh)
    e = e + al + bl
    return _ds_norm(s, e)


def ds_neg(ah, al):
    return -ah, -al


def _split32(a):  # Veltkamp split: a == a_hi + a_lo, each ~12 bits
    t = _SPLIT * a
    a_hi = t - (t - a)
    return a_hi, a - a_hi

def _two_prod(a, b):  # Dekker product without fma
    p = a * b
    ah, al = _split32(a)
    bh, bl = _split32(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def ds_mul(ah, al, bh, bl):
    p, e = _two_prod(ah, bh)
    e = e + ah * bl + al * bh
    return _ds_norm(p, e)


@functools.partial(
    jax.jit, static_argnames=("h", "w", "d", "all_valid", "version", "cap")
)
def encode_tiles_f64(
    data_hi,   # [H, W, D] f32 (normalized high parts)
    data_lo,   # [H, W, D] f32 (low parts)
    data_bits,  # [H, W, D, 2] u32 little-endian f64 bit pattern
    mask,      # [H, W] bool
    mze_hi, mze_lo,  # double-single maxZError (> 0)
    h: int, w: int, d: int, all_valid: bool, version: int, cap: int,
):
    """Lossy float64 tile encode. Returns (stream u8 [cap], total, starts)."""
    max_nb = 31
    pw = (BS * max_nb + 31) // 32 + 1
    raw_w = (1 + BS * 8 + 3) // 4
    rec_w = max(raw_w, (11 + 4 * (pw - 1) + 3) // 4, pw + 4) + 1
    cap_w = cap // 4
    assert cap % 4 == 0 and rec_w + 1 + 127 <= 512

    # double-single scale = 1 / (2 * mze): compute via Newton on device
    twoe_h, twoe_l = ds_add(mze_hi, mze_lo, mze_hi, mze_lo)
    s0 = 1.0 / twoe_h
    # one Newton step: s = s0 * (2 - twoe * s0), in double-single
    p_h, p_l = ds_mul(twoe_h, twoe_l, s0, jnp.float32(0))
    r_h, r_l = ds_add(jnp.float32(2), jnp.float32(0), -p_h, -p_l)
    scale_h, scale_l = ds_mul(s0, jnp.float32(0), r_h, r_l)

    vb, nbv, nbh = _blockize(jnp.ones((h, w), bool) if all_valid else mask, h, w)
    n_blocks = nbv * nbh
    cnt = vb.sum(axis=1).astype(jnp.int32)
    aligned_all_valid = all_valid and h % MB == 0 and w % MB == 0
    if not aligned_all_valid:
        # log-shift compaction (valid positions -> rank slots); routing
        # masks built once from the mask and reused across depths and
        # value arrays (see device_encode.make_compactor)
        from .device_encode import make_compactor

        _compact_u32 = make_compactor(vb)

    j0 = (jnp.arange(n_blocks, dtype=jnp.int32) % nbh) * MB
    integ = ((j0 >> 3) & 15) << 2
    if version >= 5:
        integ = integ & 0b111000

    per_depth = []
    for di in range(d):
        xh, _, _ = _blockize(data_hi[:, :, di], h, w)
        xl, _, _ = _blockize(data_lo[:, :, di], h, w)
        bl_, _, _ = _blockize(data_bits[:, :, di, 0], h, w)
        bh_, _, _ = _blockize(data_bits[:, :, di, 1], h, w)

        # per-block min/max on the compound (hi, lo) key
        big_h = jnp.where(vb, xh, jnp.inf)
        big_l = jnp.where(vb, xl, 0.0)
        m_h = big_h.min(axis=1)
        is_min_h = big_h == m_h[:, None]
        m_l = jnp.where(is_min_h, big_l, jnp.inf).min(axis=1)
        zmin_h = jnp.where(cnt > 0, m_h, 0.0)
        zmin_l = jnp.where(cnt > 0, m_l, 0.0)
        sml_h = jnp.where(vb, xh, -jnp.inf)
        x_h = sml_h.max(axis=1)
        is_max_h = sml_h == x_h[:, None]
        x_l = jnp.where(is_max_h, jnp.where(vb, xl, -jnp.inf), -jnp.inf).max(axis=1)

        # exact f64 bits of the block min (first element matching the key)
        is_min = vb & is_min_h & (xl == m_l[:, None])
        first = is_min & (jnp.cumsum(is_min, axis=1) == 1)
        off_bits_lo = jnp.where(first, bl_, 0).sum(axis=1).astype(jnp.uint32)
        off_bits_hi = jnp.where(first, bh_, 0).sum(axis=1).astype(jnp.uint32)

        # ---- quantize: q = round((x - zmin) * scale), double-single +
        # one residual refinement + sign-directed fixup
        dx_h, dx_l = ds_add(xh, xl, -zmin_h[:, None], -zmin_l[:, None])
        qp_h, qp_l = ds_mul(dx_h, dx_l, scale_h, scale_l)
        q0 = jnp.round(qp_h)  # f32; may be off near halves for big q
        q0 = q0 + jnp.round(qp_h - q0 + qp_l)  # fold the ds tail
        # clip BEFORE the int32 cast: 2^31 does not fit int32 and XLA's
        # f32->i32 conversion of out-of-range values is unspecified; the
        # refinement below re-clips to the 2^30 quantization cap anyway
        q0 = jnp.clip(q0, 0.0, 2.0**30)
        qi = q0.astype(jnp.int32)

        def resid(qi_):
            # err = dx - q * 2e, in double-single (q exact via 16-bit halves)
            q_hi16 = (qi_ >> 15).astype(jnp.float32) * jnp.float32(1 << 15)
            q_lo16 = (qi_ & 0x7FFF).astype(jnp.float32)
            p1h, p1l = ds_mul(q_hi16, jnp.zeros_like(q_hi16), twoe_h, twoe_l)
            p2h, p2l = ds_mul(q_lo16, jnp.zeros_like(q_lo16), twoe_h, twoe_l)
            s_h, s_l = ds_add(p1h, p1l, p2h, p2l)
            return ds_add(dx_h, dx_l, -s_h, -s_l)

        r_h0, r_l0 = resid(qi)
        # refinement: shift q by the residual in quanta
        adj_h, _ = ds_mul(r_h0, r_l0, scale_h, scale_l)
        qi = jnp.clip(qi + jnp.round(adj_h).astype(jnp.int32), 0, 2**30)
        r_h1, r_l1 = resid(qi)
        step = jnp.sign(r_h1).astype(jnp.int32)
        qc = jnp.clip(qi + step, 0, 2**30)
        rc_h, rc_l = resid(qc)
        better = jnp.abs(rc_h) < jnp.abs(r_h1)
        qi = jnp.where(better, qc, qi)

        q = jnp.where(vb, qi, 0).astype(jnp.uint32)
        if aligned_all_valid:
            cq = q
            craw_lo, craw_hi = bl_, bh_
        else:
            cq, craw_lo, craw_hi = _compact_u32(
                q, jnp.where(vb, bl_, 0), jnp.where(vb, bh_, 0))

        max_q = cq.max(axis=1)
        nb = _bit_len(max_q)

        # mode selection: const0 / stuff / const-offset / raw
        is_const0 = (cnt == 0) | ((zmin_h == 0) & (zmin_l == 0) & (x_h == 0) & (x_l == 0))
        # force raw when the quantized range exceeds the 2^30-1 cap; the
        # range test runs in double-single so blocks just over the cap do
        # not slip through on hi-part-only rounding and clip their quanta
        rng_h, rng_l = ds_add(x_h, x_l, -zmin_h, -zmin_l)
        rq_h, _rq_l = ds_mul(rng_h, rng_l, scale_h, scale_l)
        force_raw = rq_h > float((1 << 30) - 1)

        stuff_bytes = (cnt * nb + 7) // 8
        stuff_len = 1 + 8 + jnp.where(max_q > 0, 2 + stuff_bytes, 0)
        raw_len = 1 + cnt * 8
        use_stuff = (~force_raw) & (stuff_len < raw_len)
        mode = jnp.where(
            is_const0, 2, jnp.where(use_stuff, jnp.where(max_q > 0, 1, 3), 0)
        ).astype(jnp.int32)
        length = jnp.where(mode == 2, 1, jnp.where(mode == 0, raw_len, stuff_len)).astype(jnp.int32)
        # flag: bits67 = 0 (full double offset)
        flag = (integ | jnp.where(mode == 0, 0, jnp.where(mode == 2, 2, jnp.where(max_q > 0, 1, 3)))).astype(jnp.uint32)

        pk = _pack_words(cq, nb, n_blocks, pw)
        pkp = jnp.concatenate([jnp.zeros((n_blocks, 3), jnp.uint32), pk], axis=1)
        if pkp.shape[1] < rec_w + 3:
            pkp = jnp.concatenate(
                [pkp, jnp.zeros((n_blocks, rec_w + 3 - pkp.shape[1]), jnp.uint32)], axis=1
            )
        nbb = nb.astype(jnp.uint32) | jnp.uint32(2 << 6)  # cw == 1 (cnt <= 64)
        cnt_u = cnt.astype(jnp.uint32)

        # stuff layout: [flag][off f64 8B][nbb][cnt][payload] -> payload at 11
        ob = [(off_bits_lo >> (8 * i)) & 0xFF for i in range(4)] + \
             [(off_bits_hi >> (8 * i)) & 0xFF for i in range(4)]
        w0 = flag | (ob[0] << 8) | (ob[1] << 16) | (ob[2] << 24)
        w1 = ob[3] | (ob[4] << 8) | (ob[5] << 16) | (ob[6] << 24)
        w2 = ob[7] | (nbb << 8) | (cnt_u << 16) | ((pkp[:, 3] & 0xFF) << 24)
        # words j >= 3: payload bytes [4j-11, 4j-7) -> pk words j-3, j-2, shift 1
        a = pkp[:, 3 : 3 + rec_w - 3]
        b_ = pkp[:, 4 : 4 + rec_w - 3]
        body = (a >> 8) | (b_ << 24)
        stuff_words = jnp.concatenate(
            [w0[:, None], w1[:, None], w2[:, None], body], axis=1
        )
        const_head = jnp.concatenate(
            [w0[:, None], w1[:, None], (ob[7])[:, None],
             jnp.zeros((n_blocks, rec_w - 3), jnp.uint32)], axis=1
        )
        # raw: [flag][f64 values...] -> 2 words per value at byte 1
        rw = jnp.stack([craw_lo, craw_hi], axis=2).reshape(n_blocks, 2 * BS)
        rwp = jnp.concatenate(
            [jnp.zeros((n_blocks, 1), jnp.uint32), rw,
             jnp.zeros((n_blocks, max(0, rec_w - 2 * BS)), jnp.uint32)], axis=1
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
                                jnp.concatenate([flag[:, None],
                                                 jnp.zeros((n_blocks, rec_w - 1), jnp.uint32)], axis=1))),
        )
        jb = jnp.arange(rec_w, dtype=jnp.int32)[None, :] * 4
        keep = jnp.clip(length[:, None] - jb, 0, 4)
        bmask = jnp.where(
            keep >= 4, jnp.uint32(0xFFFFFFFF),
            (jnp.uint32(1) << (jnp.uint32(8) * keep.astype(jnp.uint32))) - jnp.uint32(1),
        )
        per_depth.append((rec & bmask, length))

    if d == 1:
        rec, length = per_depth[0]
    else:
        rec = jnp.stack([p[0] for p in per_depth], axis=1).reshape(n_blocks * d, rec_w)
        length = jnp.stack([p[1] for p in per_depth], axis=1).reshape(n_blocks * d)
    n_rec = n_blocks * d

    starts = (jnp.cumsum(length) - length).astype(jnp.int32)
    total = starts[-1] + length[-1]
    sh = starts & 3
    shifted = _shift_words_1b(rec, 0)
    for k in (1, 2, 3):
        shifted = jnp.where((sh == k)[:, None], _shift_words_1b(rec, k), shifted)
    q_ = starts >> 2
    w_roll = 256 if rec_w + 1 + 127 <= 256 else 512
    lane = (q_ & 127)[:, None]
    rec256 = jnp.concatenate(
        [shifted, jnp.zeros((n_rec, w_roll - rec_w - 1), jnp.uint32)], axis=1
    )
    for b in range(7):
        rec256 = jnp.where((lane >> b) & 1 == 1, jnp.roll(rec256, 1 << b, axis=1), rec256)
    n_span = w_roll // 128
    r_row = q_ >> 7
    spans = rec256.reshape(n_rec, n_span, 128)
    out2 = jnp.zeros((cap_w // 128, 128), jnp.uint32)
    for k in range(n_span):  # sorted per-span scatters (starts monotone)
        out2 = out2.at[r_row + k].add(
            spans[:, k], mode="drop", indices_are_sorted=True
        )
    stream = jax.lax.bitcast_convert_type(out2.reshape(cap_w), jnp.uint8).reshape(cap)
    return stream, total, starts
