"""Exact softfloat float64 arithmetic on u32 bit-pattern pairs.

Written for an accelerator without native f64; double-single (2xf32,
~49-bit) arithmetic cannot reproduce the reference decoder bit-for-bit.
(The H100 has native f64; whether native x64 replaces this is an open
design question.) The lossy-f64 tiling
dequantization is only three operations per pixel --

    z = zMin + quant * invScale        (Lerc2.h ScaleBack, one rounding
    z = min(z, zMaxClamp)               per multiply and add, no FMA)

-- so this module implements exactly those as IEEE-754 round-to-nearest-
even integer algorithms over (hi, lo) uint32 limb pairs. Every op is pure
u32 arithmetic, so results are identical on the CPU and GPU backends and
the CPU test suite's bitwise checks against numpy float64 carry over to
the device.

Scope (callers precheck and fall back to the host decoder otherwise):
  * invScale is a positive normal double (decompose_scalar returns None
    for zero/subnormal/inf/nan),
  * offsets are zero or normal finite doubles (no subnormals),
  * an add result that leaves the normal range (overflow, or underflow
    to a nonzero subnormal) sets the per-element `ok` flag False; callers
    AND-reduce it and re-decode on host when it trips (rare: needs
    near-total cancellation of zMin against quant*invScale).

mul_u32_scalar computes the exact 85-bit integer product q * mantissa in
16-bit limbs and rounds once; add_f64 is a textbook guard/round/sticky
adder (Sterbenz cancellation exact, sticky-borrow on effective subtract);
min_f64 mirrors std::min(z, zMax) = (zMax < z) ? zMax : z including its
NaN and +-0 behavior on bit patterns.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_U32 = jnp.uint32
_ONE = jnp.uint32(1)
_ZERO = jnp.uint32(0)


# ---------------------------------------------------------------------------
# host-side decomposition of the scalar multiplier
# ---------------------------------------------------------------------------

def decompose_scalar(x: float):
    """Split a positive normal double into (four 16-bit mantissa limbs
    [s0..s3] with the implicit bit included, base biased exponent) such
    that x == m * 2**(e_unbiased - 52) and, for quant values q < 2**32,
    the rounded product q * x is always a normal double. Returns None when
    x is unusable (zero, subnormal, inf, nan, negative) or when any
    reachable product exponent would leave the normal range."""
    if not np.isfinite(x) or x <= 0.0:
        return None
    bits = np.float64(x).view(np.uint64)
    bexp = int(bits >> 52) & 0x7FF
    if bexp == 0 or bexp == 0x7FF:
        return None  # subnormal / inf / nan
    m = int(bits & ((1 << 52) - 1)) | (1 << 52)  # 53-bit mantissa
    limbs = tuple((m >> (16 * i)) & 0xFFFF for i in range(4))
    # product = (q * m) * 2**(bexp - 1023 - 52); after normalizing the
    # 53..85-bit integer q*m to 53 bits with shift in [0, 32], the biased
    # result exponent is bexp + shift (+1 on a rounding carry)
    if not (1 <= bexp and bexp + 33 <= 2046):
        return None
    return limbs, bexp


# ---------------------------------------------------------------------------
# pair/limb helpers (all elementwise u32)
# ---------------------------------------------------------------------------

def _bit_length_u32(x):
    """Per-element bit length of a uint32 (0 for 0), via binary descent."""
    x = x.astype(_U32)
    n = jnp.zeros(x.shape, jnp.int32)
    for k in (16, 8, 4, 2, 1):
        big = x >= (_ONE << jnp.uint32(k))
        n = n + jnp.where(big, k, 0)
        x = jnp.where(big, x >> jnp.uint32(k), x)
    return n + (x > 0).astype(jnp.int32)


def _shr_pair_sticky(h, l, n):
    """(h, l) >> n for 0 <= n <= 63, returning (h', l', sticky) where
    sticky is True iff any shifted-out bit was set. n >= 64 is clamped to
    'everything shifted out'."""
    n = jnp.clip(n, 0, 64).astype(jnp.uint32)
    big = n >= 32          # whole low word (and more) shifted out
    all_out = n >= 64
    ns = jnp.where(big, n - 32, n)          # effective small shift < 32
    # masks of bits that fall off (guarding undefined shifts by 32)
    mask_s = jnp.where(ns > 0, (_ONE << ns) - _ONE, _ZERO)
    lost_small_l = l & mask_s                # n < 32: low bits of l
    lost_big_h = h & mask_s                  # n >= 32: low bits of h
    sticky = jnp.where(
        all_out, (h | l) != 0,
        jnp.where(big, (lost_big_h | l) != 0, lost_small_l != 0),
    )
    # funnel shift
    hi_into_lo = jnp.where(ns > 0, h << (jnp.uint32(32) - ns), _ZERO)
    l_small = (l >> ns) | hi_into_lo
    h_small = h >> ns
    l_new = jnp.where(all_out, _ZERO, jnp.where(big, h >> ns, l_small))
    h_new = jnp.where(big, _ZERO, h_small)
    return h_new, l_new, sticky


def _shl_pair(h, l, n):
    """(h, l) << n for 0 <= n <= 63 (bits shifted past bit 63 are lost)."""
    n = jnp.clip(n, 0, 63).astype(jnp.uint32)
    big = n >= 32
    ns = jnp.where(big, n - 32, n)
    lo_into_hi = jnp.where(ns > 0, l >> (jnp.uint32(32) - ns), _ZERO)
    h_small = (h << ns) | lo_into_hi
    l_small = l << ns
    h_new = jnp.where(big, l << ns, h_small)
    l_new = jnp.where(big, _ZERO, l_small)
    return h_new, l_new


# ---------------------------------------------------------------------------
# q (u32) * scalar -> f64 bits, round-to-nearest-even
# ---------------------------------------------------------------------------

def mul_u32_scalar(q, limbs, base_bexp: int, max_q_bits: int = 32):
    """Exact product of a uint32 quant array with the decomposed positive
    normal scalar (from decompose_scalar), rounded once to f64 RNE.
    Returns (hi, lo) uint32 bit-pattern arrays; q == 0 gives +0.0.

    max_q_bits: static bound on q's bit width. <= 16 (always true under
    the nb_cap=16 kernels) halves the partial products and collapses the
    normalization to single-word shifts (product <= 69 bits: shift <= 16,
    guard/sticky all in w0) -- measured on the r4 bench decode path."""
    q = q.astype(_U32)
    narrow = max_q_bits <= 16
    q0 = q & jnp.uint32(0xFFFF)
    q_rows = (q0,) if narrow else (q0, q >> jnp.uint32(16))
    # 85-bit product in six 16-bit columns; each partial is an exact
    # 16x16->32 multiply, halves accumulate without overflow (<= 2^19)
    n_cols = 6 if narrow else 7
    cols = [jnp.zeros(q.shape, _U32) for _ in range(n_cols)]
    for i, qi in enumerate(q_rows):
        for j, sj in enumerate(limbs):
            if sj == 0:
                continue
            p = qi * jnp.uint32(sj)
            cols[i + j] = cols[i + j] + (p & jnp.uint32(0xFFFF))
            cols[i + j + 1] = cols[i + j + 1] + (p >> jnp.uint32(16))
    carry = _ZERO
    out_limbs = []
    for c in cols:
        v = c + carry
        out_limbs.append(v & jnp.uint32(0xFFFF))
        carry = v >> jnp.uint32(16)
    # product words W0..W2 (<= 85 bits < 96; <= 69 bits when narrow)
    w0 = out_limbs[0] | (out_limbs[1] << jnp.uint32(16))
    w1 = out_limbs[2] | (out_limbs[3] << jnp.uint32(16))
    w2 = (out_limbs[4] | (out_limbs[5] << jnp.uint32(16))) if not narrow \
        else out_limbs[4]

    # normalize: total bit length in [53, 85] for q >= 1
    nb2 = _bit_length_u32(w2)
    nb1 = _bit_length_u32(w1)
    nb0 = _bit_length_u32(w0)
    nbits = jnp.where(w2 > 0, 64 + nb2, jnp.where(w1 > 0, 32 + nb1, nb0))
    shift = jnp.maximum(nbits - 53, 0)  # in [0, 32] (narrow: [0, 16])

    # mantissa = product >> shift (shift <= 32: result fits two words)
    sh = shift.astype(_U32)
    if narrow:  # sh <= 16 < 32: single-word funnels, no w2-only case
        hi_sh = jnp.where(sh > 0, (w1 >> sh) | (w2 << (jnp.uint32(32) - sh)), w1)
        lo_sh = jnp.where(sh > 0, (w0 >> sh) | (w1 << (jnp.uint32(32) - sh)), w0)
        g_pos = sh - _ONE
        guard = jnp.where(
            sh == 0, _ZERO, (w0 >> jnp.where(sh == 0, _ZERO, g_pos)) & _ONE)
        below_mask = jnp.where(
            g_pos.astype(jnp.int32) > 0, (_ONE << (g_pos & jnp.uint32(31))) - _ONE,
            _ZERO)
        sticky = jnp.where(sh <= 1, jnp.bool_(False), (w0 & below_mask) != 0)
    else:
        big = sh >= 32  # shift == 32 exactly
        hi_sh = jnp.where(big, w2, jnp.where(
            sh > 0, (w1 >> sh) | (w2 << (jnp.uint32(32) - sh)), w1))
        lo_sh = jnp.where(big, w1, jnp.where(
            sh > 0, (w0 >> sh) | (w1 << (jnp.uint32(32) - sh)), w0))
        # guard + sticky from the shifted-out low `shift` bits (in w0/w1)
        g_pos = sh - _ONE
        guard = jnp.where(
            sh == 0, _ZERO,
            jnp.where(g_pos >= 32, (w1 >> (g_pos - jnp.uint32(32))) & _ONE,
                      (w0 >> jnp.where(sh == 0, _ZERO, g_pos)) & _ONE))
        below_mask = jnp.where(g_pos > 0, jnp.where(
            g_pos >= 32, jnp.uint32(0xFFFFFFFF), (_ONE << g_pos) - _ONE), _ZERO)
        below_hi = jnp.where(g_pos > jnp.uint32(32), (_ONE << (g_pos - jnp.uint32(32))) - _ONE, _ZERO)
        sticky = jnp.where(sh <= 1, jnp.bool_(False),
                           ((w0 & below_mask) | (w1 & below_hi)) != 0)
    lsb = lo_sh & _ONE
    round_up = (guard == 1) & (sticky | (lsb == 1))
    lo_r = lo_sh + round_up.astype(_U32)
    carry_r = (lo_r == 0) & round_up
    hi_r = hi_sh + carry_r.astype(_U32)
    # rounding carry to 2^53 (carry out of +1 on an all-ones mantissa:
    # the mantissa is exactly 1<<53, all low bits zero) -> exp += 1
    carried = hi_r >= jnp.uint32(1 << 21)
    hi_r = jnp.where(carried, jnp.uint32(1 << 20), hi_r)
    lo_r = jnp.where(carried, _ZERO, lo_r)
    bexp = jnp.uint32(base_bexp) + sh + carried.astype(_U32)

    out_hi = (bexp << jnp.uint32(20)) | (hi_r & jnp.uint32(0xFFFFF))
    out_lo = lo_r
    zero = q == 0
    return jnp.where(zero, _ZERO, out_hi), jnp.where(zero, _ZERO, out_lo)


# ---------------------------------------------------------------------------
# f64 + f64 (both zero-or-normal finite), round-to-nearest-even
# ---------------------------------------------------------------------------

def add_f64(ah, al, bh, bl):
    """IEEE-754 double add on bit-pattern pairs. Inputs must each be +-0
    or a normal finite double (callers precheck). Returns (hi, lo, ok);
    ok is False where the exact result overflows or underflows to a
    nonzero subnormal (callers fall back to the host path)."""
    ah, al, bh, bl = (x.astype(_U32) for x in (ah, al, bh, bl))
    ea = (ah >> jnp.uint32(20)) & jnp.uint32(0x7FF)
    eb = (bh >> jnp.uint32(20)) & jnp.uint32(0x7FF)
    sa = ah >> jnp.uint32(31)
    sb = bh >> jnp.uint32(31)
    a_zero = (ea == 0) & ((ah & jnp.uint32(0xFFFFF)) == 0) & (al == 0)
    b_zero = (eb == 0) & ((bh & jnp.uint32(0xFFFFF)) == 0) & (bl == 0)

    mah = (ah & jnp.uint32(0xFFFFF)) | jnp.uint32(0x100000)
    mbh = (bh & jnp.uint32(0xFFFFF)) | jnp.uint32(0x100000)
    # 56-bit working mantissas (<< 3 for guard/round/sticky space)
    Mah, Mal = _shl_pair(mah, al, jnp.full(ah.shape, 3, jnp.int32))
    Mbh, Mbl = _shl_pair(mbh, bl, jnp.full(bh.shape, 3, jnp.int32))

    # order by magnitude: x = larger, y = smaller
    b_bigger = (eb > ea) | ((eb == ea) & ((mbh > mah) | ((mbh == mah) & (bl > al))))
    ex = jnp.where(b_bigger, eb, ea).astype(jnp.int32)
    ey = jnp.where(b_bigger, ea, eb).astype(jnp.int32)
    sx = jnp.where(b_bigger, sb, sa)
    sy = jnp.where(b_bigger, sa, sb)
    Mxh = jnp.where(b_bigger, Mbh, Mah)
    Mxl = jnp.where(b_bigger, Mbl, Mal)
    Myh = jnp.where(b_bigger, Mah, Mbh)
    Myl = jnp.where(b_bigger, Mal, Mbl)

    ed = ex - ey
    Myh_s, Myl_s, sticky = _shr_pair_sticky(Myh, Myl, ed)

    same = sx == sy
    st32 = sticky.astype(_U32)
    # same sign: magnitudes add (max 57 bits)
    add_l = Mxl + Myl_s
    add_c = (add_l < Mxl).astype(_U32)
    add_h = Mxh + Myh_s + add_c
    # opposite: subtract (x >= y by construction); a set sticky borrows
    # one ulp from the truncated y (y_true = y_trunc + 0.fraction, so
    # x - y_true = x - y_trunc - 1 + (1 - fraction): sticky stays set)
    sub_l = Mxl - Myl_s - st32
    sub_b = ((Mxl < Myl_s) | ((Mxl == Myl_s) & (st32 == 1))).astype(_U32)
    sub_h = Mxh - Myh_s - sub_b
    rh = jnp.where(same, add_h, sub_h)
    rl = jnp.where(same, add_l, sub_l)

    # normalize MSB to bit 55 (so bits [55:3] are the 53-bit mantissa)
    nbits = jnp.where(rh > 0, 32 + _bit_length_u32(rh), _bit_length_u32(rl))
    is_zero = nbits == 0  # exact cancellation -> +0 (RNE)
    shift = 56 - nbits  # in [-1, 56]
    # right shift by 1 when nbits == 57 (same-sign carry)
    r1h, r1l, st1 = _shr_pair_sticky(rh, rl, jnp.ones_like(nbits))
    slh, sll = _shl_pair(rh, rl, jnp.maximum(shift, 0))
    nh = jnp.where(shift < 0, r1h, slh)
    nl = jnp.where(shift < 0, r1l, sll)
    sticky = sticky | (st1 & (shift < 0))
    e_res = ex + (nbits - 56)

    # RNE round: mantissa53 = n >> 3, GRS = n & 7 (+ sticky)
    g = (nl >> jnp.uint32(2)) & _ONE
    r_ = (nl >> jnp.uint32(1)) & _ONE
    s_ = ((nl & _ONE) != 0) | sticky
    m53h = nh >> jnp.uint32(3)
    m53l = (nl >> jnp.uint32(3)) | (nh << jnp.uint32(29))
    lsb = m53l & _ONE
    round_up = (g == 1) & ((r_ == 1) | s_ | (lsb == 1))
    m53l_r = m53l + round_up.astype(_U32)
    carry_r = (m53l_r == 0) & round_up
    m53h_r = m53h + carry_r.astype(_U32)
    carried = m53h_r >= jnp.uint32(1 << 21)
    m53h_r = jnp.where(carried, m53h_r >> _ONE, m53h_r)
    m53l_r = jnp.where(carried, m53l_r >> _ONE, m53l_r)
    e_res = e_res + carried.astype(jnp.int32)

    ok = is_zero | ((e_res >= 1) & (e_res <= 2046))
    out_h = (sx << jnp.uint32(31)) | (e_res.astype(_U32) << jnp.uint32(20)) | (m53h_r & jnp.uint32(0xFFFFF))
    out_l = m53l_r
    # exact-cancellation zero: +0 (RNE default); both-zero inputs: +0 when
    # signs differ, the common sign otherwise. The both-zero case never
    # reaches is_zero (the implicit mantissa bit is set unconditionally
    # above, so 0+0 added to a nonzero working mantissa and emitted the
    # min-normal 0x0010..0 -- caught by the randomized differential soak)
    both_zero = a_zero & b_zero
    zero_sign = jnp.where(both_zero & (sa == sb), sa, _ZERO)
    zero_out = is_zero | both_zero
    out_h = jnp.where(zero_out, zero_sign << jnp.uint32(31), out_h)
    out_l = jnp.where(zero_out, _ZERO, out_l)
    # identity cases
    out_h = jnp.where(a_zero & ~b_zero, bh, jnp.where(b_zero & ~a_zero, ah, out_h))
    out_l = jnp.where(a_zero & ~b_zero, bl, jnp.where(b_zero & ~a_zero, al, out_l))
    ok = ok | a_zero | b_zero
    return out_h, out_l, ok


# ---------------------------------------------------------------------------
# std::min(z, zmax) on bit patterns
# ---------------------------------------------------------------------------

def min_f64(zh, zl, mh, ml):
    """(mh,ml) < (zh,zl) ? m : z -- exactly std::min(z, zMax)'s result
    bits for finite inputs, including +-0 (IEEE equal: keeps z)."""
    def key(h, l):
        neg = (h >> jnp.uint32(31)) == 1
        # flip negatives entirely, set the sign bit on positives: total order
        kh = jnp.where(neg, ~h, h | jnp.uint32(0x80000000))
        kl = jnp.where(neg, ~l, l)
        # -0 compares equal to +0 in IEEE: normalize its key to +0's
        is_nzero = (h == jnp.uint32(0x80000000)) & (l == 0)
        kh = jnp.where(is_nzero, jnp.uint32(0x80000000), kh)
        kl = jnp.where(is_nzero, _ZERO, kl)
        return kh, kl

    kzh, kzl = key(zh, zl)
    kmh, kml = key(mh, ml)
    m_less = (kmh < kzh) | ((kmh == kzh) & (kml < kzl))
    return jnp.where(m_less, mh, zh), jnp.where(m_less, ml, zl)


# ---------------------------------------------------------------------------
# f32 <-> f64 bit-pattern conversions (for exact f32 ScaleBack: the
# reference dequantizes FLOAT blobs in double then casts to float --
# Lerc2.h:381-399 `double z = zMin + quant*invScale; dataBuf[i] = (T)z`)
# ---------------------------------------------------------------------------

def f32_to_f64_bits(bits):
    """Exact widening of IEEE f32 bit patterns to (hi, lo) f64 pairs.
    Handles zero, subnormal (renormalized -- any finite f32 is zero or
    NORMAL as f64), inf and NaN (quiet bit preserved via mantissa shift)."""
    bits = bits.astype(_U32)
    sign = bits & jnp.uint32(0x80000000)
    e8 = ((bits >> jnp.uint32(23)) & jnp.uint32(0xFF)).astype(jnp.int32)
    m23 = bits & jnp.uint32(0x7FFFFF)

    # normal f32: e11 = e8 - 127 + 1023
    e11 = e8 + 896
    hi_n = sign | (e11.astype(_U32) << jnp.uint32(20)) | (m23 >> jnp.uint32(3))
    lo_n = m23 << jnp.uint32(29)

    # subnormal f32: value = m23 * 2^-149; normalize the <=23-bit mantissa
    nb = _bit_length_u32(m23)                      # leading bit position
    sh = (24 - nb).astype(_U32)                    # left shift to bit 23
    m_norm = jnp.where(nb > 0, m23 << sh, _ZERO) & jnp.uint32(0x7FFFFF)
    e11_s = (nb + 873).astype(_U32)                # e11 = (nb-150) + 1023
    hi_s = sign | (e11_s << jnp.uint32(20)) | (m_norm >> jnp.uint32(3))
    lo_s = m_norm << jnp.uint32(29)

    hi_inf = sign | jnp.uint32(0x7FF00000) | (m23 >> jnp.uint32(3))
    lo_inf = m23 << jnp.uint32(29)

    is_zero = (e8 == 0) & (m23 == 0)
    hi = jnp.where(e8 == 255, hi_inf,
                   jnp.where(e8 == 0, jnp.where(is_zero, sign, hi_s), hi_n))
    lo = jnp.where(e8 == 255, lo_inf,
                   jnp.where(e8 == 0, jnp.where(is_zero, _ZERO, lo_s), lo_n))
    return hi, lo


def f64_to_f32_rne(hi, lo):
    """IEEE f64 (hi, lo) bit pairs -> f32 bit patterns, round to nearest
    even -- the C cast `(float)z` with default rounding. Handles overflow
    to inf, underflow through f32 subnormals to zero, inf and NaN
    (quieted to 0x7FC00000 | sign, matching x86/ARM double->float casts
    of the NaNs this codec can produce)."""
    hi = hi.astype(_U32)
    lo = lo.astype(_U32)
    sign = hi & jnp.uint32(0x80000000)
    e = ((hi >> jnp.uint32(20)) & jnp.uint32(0x7FF)).astype(jnp.int32)
    m_hi = hi & jnp.uint32(0xFFFFF)
    sig_hi = m_hi | jnp.uint32(0x100000)           # 53-bit sig in (sig_hi, lo)

    e32 = e - 896                                  # biased f32 exp if normal
    # shift so the kept part lands in 24 bits (normal) or fewer (subnormal)
    d = jnp.where(e32 >= 1, 29, 30 - e32)
    d = jnp.clip(d, 29, 63)
    h1, l1, st = _shr_pair_sticky(sig_hi, lo, d - 1)
    keep0 = l1 >> _ONE                             # h1 == 0: >= 21 bits gone
    rb = l1 & _ONE
    keep = keep0 + (rb & (st.astype(_U32) | (keep0 & _ONE)))

    # normal: keep in [2^23, 2^24]; ((e32-1)<<23)+keep self-carries the
    # rounding overflow (keep=2^24 bumps the exponent, rolling into inf at
    # e32=254 exactly). subnormal: keep <= 2^23 IS the encoding (keep=2^23
    # rolls into the min normal, which is the correct rounding there).
    body_n = ((e32 - 1).astype(_U32) << jnp.uint32(23)) + keep
    body = jnp.where(e32 >= 1, body_n, keep)
    body = jnp.where(e32 >= 255, jnp.uint32(0x7F800000), body)
    is_nan = (e == 0x7FF) & ((m_hi | lo) != 0)
    body = jnp.where(e == 0x7FF,
                     jnp.where(is_nan, jnp.uint32(0x7FC00000),
                               jnp.uint32(0x7F800000)), body)
    body = jnp.where(e == 0, _ZERO, body)          # f64 subnormal << f32 range
    return sign | body
