"""Device-side (JAX/XLA) Lerc2 tile decoding.

The host-side native scanner (lerc_tpu.native.tile_scan) resolves the serial
record-offset chain; everything else -- bit-unpack, LUT lookup, dequantize,
clamp, scatter back to the image -- is data-parallel and runs here as one
jit-compiled gather pipeline over [nRecords, 64] lanes.

Supported record modes: raw, bit-stuffed (simple + LUT), const-0,
const-offset, and (decode_tiles only) depth-diff chains resolved by a
lax.scan over the depth axis. The f32 lossy dequant is BIT-EXACT against
the reference's double ScaleBack when callers pass the decomposed
invScale (softfloat mul/add/min + RNE narrow); decode_tiles_fast flags
depth-diff records unfit instead (the encoder feeding it never emits
them).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import DataType

MB = 8
BS = MB * MB


def _exact_f32_scale_back(qv, offset_f32, zmax_f32_r, inv_limbs, inv_bexp,
                          max_q_bits: int = 32):
    """Bit-exact f32 ScaleBack (Lerc2.h:381-399): the reference dequantizes
    FLOAT blobs in double -- z = zMin + q*invScale (one rounding per op),
    z = min(z, zMaxClamp), then the C cast (float)z -- so f32 arithmetic
    is ~1 ulp off. Runs the same three ops through the softfloat f64
    kernels and narrows with RNE, making device f32 lossy decode
    bit-for-bit the host/reference decoder.

    qv: [N, B] u32 quants; offset_f32: [N] f32; zmax_f32_r: [N, 1] f32.
    Returns (z [N, B] f32, (pre-clamp hi, lo) for depth-diff chains,
    ok [N]). ok[i] False = a sum of record i left the normal-f64 range
    (callers fall back)."""
    from . import device_softf64 as sf

    ph, pl = sf.mul_u32_scalar(qv.astype(jnp.uint32), inv_limbs, inv_bexp,
                               max_q_bits=max_q_bits)
    oh, ol = sf.f32_to_f64_bits(
        jax.lax.bitcast_convert_type(offset_f32, jnp.uint32))
    zh, zl, ok = sf.add_f64(
        jnp.broadcast_to(oh[:, None], ph.shape),
        jnp.broadcast_to(ol[:, None], pl.shape), ph, pl)
    z32 = jax.lax.bitcast_convert_type(sf.f64_to_f32_rne(zh, zl), jnp.float32)
    # clamp AFTER narrowing: zMax is an exact f32 wire value and RNE is
    # monotone, so (float)min(z, zMax) == min((float)z, zMax) bit-for-bit;
    # the where keeps std::min's exact tie/NaN pick (z on ties, z if NaN)
    z = jnp.where(zmax_f32_r < z32, zmax_f32_r, z32)
    return z, (zh, zl), jnp.all(ok, axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("h", "w", "d", "dt", "version", "nb_cap", "mb",
                     "n_tiles", "enable_lut", "inv_limbs", "inv_bexp"),
)
def decode_tiles_fast(
    stream,       # [S] uint8 tile-stream bytes, S % 512 == 0
    starts,       # [nTiles * nRec] i32 record-offset index (absolute bytes)
    max_z_error,  # f32 scalar
    z_max_vec,    # [D] (or [nTiles, D]) clamp values (f32 or i32 per dtype)
    h: int, w: int, d: int, dt: DataType, version: int, nb_cap: int = 0,
    mask=None,    # optional [H, W] (or [nTiles, H, W]) bool validity mask
    mb: int = 8,       # micro-block size of the records (8 or 16)
    n_tiles: int = 1,  # tiles batched into one record axis (one dispatch)
    enable_lut: bool = False,  # build the LUT-record decode graph
    inv_limbs: tuple | None = None,  # decompose_scalar(2*maxZError): when
    inv_bexp: int = 0,               # set, f32 dequant is bit-exact f64
):
    """Aligned fast decode. One sorted row gather per record (over
    overlapping stride-S window rows) brings each record's bytes into a
    dense window; header parse, payload alignment and value extraction
    are then elementwise (dynamic lane roll composed from static rolls,
    static-per-nb extraction chain). Returns (img [H, W, D] native
    dtype -- [nTiles, H, W, D] when n_tiles > 1 -- index_ok, fits), fits
    being one flag per tile ([nTiles]) when n_tiles > 1, so that a caller
    can send only the unfit tiles elsewhere. Requires H, W multiples of mb.

    With `mask`, records hold values compacted to the valid positions;
    after extraction a batched one-hot expand routes value rank[p] back
    to position p (invalid positions decode to 0, matching the
    reference's zeroed output, Lerc2.cpp:961-1008). The mask also feeds
    the per-record count used by the index consistency check, so a mask
    that disagrees with the stream fails loudly.

    With n_tiles > 1 the per-tile streams are concatenated in `stream`
    and `starts` holds absolute offsets (caller adds each tile's base);
    all tiles share (h, w, d, dt, mze) and the per-TILE last record is
    exempt from the index delta check (streams are padded between tiles).

    With enable_lut (BitStuffer2.cpp:79-153 wire), LUT records resolve in
    two chained one-hot extractions over the same window: pass 1 pulls
    each position's LUT index (nbits(nLut) each, at lutBytes*8 + i*nbl),
    pass 2 re-extracts at the DATA-DEPENDENT bit offset idx*nb inside the
    LUT table. Oversized LUT tables (window overflow) flip `fits`.

    nb_cap > 0 statically caps the bit width the kernel is sized for.
    Records wider than the cap (or 4-byte raw records under a <32 cap, or
    LUT records under the static-chain path, or 16x16 records wider than
    the 128-lane window allows) make `fits` False -- the image is then
    invalid and callers fall back (uncapped variant / host path)."""
    bs = mb * mb
    assert h % mb == 0 and w % mb == 0
    is_int = dt < DataType.FLOAT
    np_out = {DataType.CHAR: jnp.int8, DataType.BYTE: jnp.uint8,
              DataType.SHORT: jnp.int16, DataType.USHORT: jnp.uint16,
              DataType.INT: jnp.int32, DataType.UINT: jnp.uint32,
              DataType.FLOAT: jnp.float32}[dt]
    size_t = np.dtype(np_out).itemsize
    max_nb = {1: 8, 2: 16, 4: 32}[size_t]
    eff_cap = max_nb if nb_cap <= 0 else min(nb_cap, max_nb)
    if mb == 16:
        # a 16x16 record must still fit the 128-lane window rows:
        # pw + 4 + 31 <= 128 (sw=32) caps the packed width at 11 bits;
        # wider records flip `fits` (host fallback). 16x16 is only chosen
        # at low bitrates (Lerc2.cpp:333-357) so this is the common case.
        eff_cap = min(eff_cap, 11)
    always_fits = eff_cap >= max_nb
    pw = (bs * eff_cap + 31) // 32 + 1

    nbv, nbh = h // mb, w // mb
    n_blocks = nbv * nbh
    rec_per_tile = n_blocks * d
    n_rec = n_tiles * rec_per_tile
    inv_scale = (2.0 * max_z_error).astype(jnp.float32)

    if mask is not None:
        mask3 = mask.reshape(n_tiles, h, w)
        vb = (mask3.reshape(n_tiles, nbv, mb, nbh, mb)
              .transpose(0, 1, 3, 2, 4)
              .reshape(n_tiles * n_blocks, bs))
        vb_r = jnp.repeat(vb, d, axis=0) if d > 1 else vb
        cnt_r = vb_r.sum(axis=1).astype(jnp.int32)

    # ---- per-record window via overlapping stride-S rows.
    # A naive [2, 128]-row gather per record reads 1 KB for a ~100 B
    # record (9x amplification).
    # Instead materialize V[j] = words[S*j : S*j+128] (128/S x the stream,
    # one sequential write), so every record's span fits ONE gathered row
    # (sorted indices) and the lane roll is log2(S) static steps over 128
    # lanes. The largest stride whose window still covers a record span
    # minimizes the materialization traffic.
    sw = 64 if pw + 4 + 63 <= 128 else 32
    assert pw + 4 + (sw - 1) <= 128  # record span must fit a 128-word row
    swb = sw.bit_length() - 1
    if stream.dtype == jnp.uint32:  # u32-native stream: no relayout
        u32 = stream
    else:
        u32 = jax.lax.bitcast_convert_type(stream.reshape(-1, 4), jnp.uint32)
    nq = u32.shape[0] // sw
    wq = u32.reshape(nq, sw)
    n_k = 128 // sw
    wqp = jnp.concatenate([wq, jnp.zeros((n_k - 1, sw), jnp.uint32)], axis=0)
    v = jnp.concatenate([wqp[k : nq + k] for k in range(n_k)], axis=1)  # [nq, 128]
    q = starts >> 2
    winr = v.at[jnp.clip(q >> swb, 0, nq - 1)].get(indices_are_sorted=True)
    lane = (q & (sw - 1))[:, None]
    for b in range(swb):  # left roll by lane, composed from static rolls
        winr = jnp.where((lane >> b) & 1 == 1, jnp.roll(winr, -(1 << b), axis=1), winr)
    # winr[:, j] = stream word at word offset (starts >> 2) + j
    sb = (starts & 3).astype(jnp.int32)  # byte offset of the record in word 0

    def rd_u8(byte_off):  # record byte at dynamic offset <= 15 (elementwise)
        wsel = jnp.where((byte_off >> 2) == 0, winr[:, 0],
                         jnp.where((byte_off >> 2) == 1, winr[:, 1],
                                   jnp.where((byte_off >> 2) == 2, winr[:, 2],
                                             winr[:, 3])))
        return (wsel >> ((byte_off & 3).astype(jnp.uint32) * 8)) & 0xFF

    def rd_u32(byte_off):  # unaligned LE u32 at dynamic small offset
        w0 = jnp.where((byte_off >> 2) == 0, winr[:, 0],
                       jnp.where((byte_off >> 2) == 1, winr[:, 1], winr[:, 2]))
        w1 = jnp.where((byte_off >> 2) == 0, winr[:, 1],
                       jnp.where((byte_off >> 2) == 1, winr[:, 2], winr[:, 3]))
        s8 = ((byte_off & 3).astype(jnp.uint32)) * 8
        return jnp.where(s8 > 0, (w0 >> s8) | (w1 << (jnp.uint32(32) - s8)), w0)

    # ---- header parse (Lerc2 WriteTile layout, Lerc2.cpp:1950-2021)
    flag = rd_u8(sb)
    mode = (flag & 3).astype(jnp.int32)
    bits67 = (flag >> 6).astype(jnp.int32)

    if not is_int:
        off_w = jnp.where(bits67 == 2, 1, jnp.where(bits67 == 1, 2, 4))
    elif dt in (DataType.CHAR, DataType.BYTE):
        off_w = jnp.ones_like(bits67)
    elif dt in (DataType.SHORT, DataType.USHORT):
        off_w = jnp.where(bits67 > 0, 1, 2)
    elif dt == DataType.INT:
        off_w = jnp.where(bits67 == 3, 1, jnp.where(bits67 > 0, 2, 4))
    else:  # UINT
        off_w = jnp.where(bits67 == 2, 1, jnp.where(bits67 == 1, 2, 4))

    acc = rd_u32(sb + 1)
    acc = jnp.where(off_w == 1, acc & 0xFF, jnp.where(off_w == 2, acc & 0xFFFF, acc))
    if not is_int:
        off_f32 = jax.lax.bitcast_convert_type(acc, jnp.float32)
        i16 = ((acc & 0xFFFF) << 16).astype(jnp.int32) >> 16
        offset = jnp.where(
            bits67 == 2, (acc & 0xFF).astype(jnp.float32),
            jnp.where(bits67 == 1, i16.astype(jnp.float32), off_f32),
        )
    else:
        if dt == DataType.SHORT:
            signed8 = bits67 == 2
        elif dt == DataType.CHAR:
            signed8 = jnp.ones(n_rec, bool)
        else:
            signed8 = jnp.zeros(n_rec, bool)
        s8v = jnp.where(signed8, ((acc & 0xFF) << 24).astype(jnp.int32) >> 24,
                        (acc & 0xFF).astype(jnp.int32))
        if dt == DataType.INT:
            signed16 = bits67 == 2
        elif dt == DataType.SHORT:
            signed16 = bits67 == 0
        else:
            signed16 = jnp.zeros(n_rec, bool)
        s16v = jnp.where(signed16, ((acc & 0xFFFF) << 16).astype(jnp.int32) >> 16,
                         (acc & 0xFFFF).astype(jnp.int32))
        offset = jnp.where(off_w == 1, s8v, jnp.where(off_w == 2, s16v, acc.astype(jnp.int32)))

    nbb = rd_u8(sb + 1 + off_w)
    cw_code = (nbb >> 6).astype(jnp.int32)
    cw = jnp.where(cw_code == 0, 4, 3 - cw_code)
    nb = (nbb & 31).astype(jnp.int32)
    is_lut = ((nbb & 32) > 0) & (mode == 1)
    if enable_lut:
        # LUT record layout (BitStuffer2.cpp:79-153): header, count,
        # (nLut + 1) byte, packed LUT values (nLut * nb bits, byte-
        # aligned as a unit), packed indices (nbits(nLut) bits each).
        n_lut = (rd_u8(sb + 1 + off_w + 1 + cw) - 1).astype(jnp.int32)
        n_lut = jnp.where(is_lut, n_lut, 0)
        nbits_lut = jnp.zeros_like(n_lut)
        for k in range(8):  # bit_length(n_lut), n_lut <= 254
            nbits_lut = nbits_lut + (n_lut >= (1 << k)).astype(jnp.int32)
        lut_bytes = (n_lut * nb + 7) >> 3
    # payload byte offset within the window: raw -> data, stuff ->
    # packed values, LUT -> the LUT table (indices follow it)
    pb = jnp.where(mode == 0, sb + 1, sb + 1 + off_w + 1 + cw)
    if enable_lut:
        pb = pb + jnp.where(is_lut, 1, 0)  # skip the (nLut + 1) byte

    # ---- payload window words: word-align (pb>>2 in {0..2}) + byte funnel
    pwoff = pb >> 2  # <= 3 (sb<=3, off_w<=4, cw<=4)
    base = winr[:, 0:pw + 1]
    for s in (1, 2, 3):
        base = jnp.where(pwoff[:, None] == s, winr[:, s : s + pw + 1], base)
    wsh = ((pb & 3) * 8).astype(jnp.uint32)[:, None]
    win = jnp.where(
        wsh > 0, (base[:, :pw] >> wsh) | (base[:, 1:] << (jnp.uint32(32) - wsh)),
        base[:, :pw],
    )  # [nRec, pw] payload words, LSB-first bitstream

    # unified bit extraction: stuff uses nb bits/value, raw uses the native
    # width; const modes are patched afterwards. Extraction is a
    # static-per-nb select chain: eff_nb has <= eff_cap distinct values,
    # and for a FIXED nb every value's word index and shift are
    # compile-time constants, so each variant is elementwise slices +
    # shifts and the variants fuse into one pass over the windows, with no
    # bf16 conversion traffic (speed against the one-hot dot not measured
    # on the H100).
    eff_nb = jnp.where(mode == 0, 8 * size_t, nb)
    lut_unfit = jnp.zeros(n_rec, bool)  # per record
    if 0 < nb_cap <= 16:
        # explicit narrow cap (production hot path): static chain; see the
        # encode-side note on the compile-time tradeoff. LUT records need
        # dynamic (lut_bytes * 8)-bit base offsets the static chain cannot
        # express: flag them unfit (callers rerun on the uncapped variant).
        lut_unfit = is_lut
        winx = jnp.concatenate([win, jnp.zeros((n_rec, 1), jnp.uint32)], axis=1)
        val = jnp.zeros((n_rec, bs), jnp.uint32)
        for nbx in range(1, eff_cap + 1):
            maskv = jnp.uint32((1 << nbx) - 1)
            vals = []
            for j in range(bs):
                c = (j * nbx) >> 5
                s_ = (j * nbx) & 31
                t = winx[:, c] >> jnp.uint32(s_)
                if s_ and s_ + nbx > 32:
                    t = t | (winx[:, c + 1] << jnp.uint32(32 - s_))
                vals.append(t & maskv)
            cand = jnp.stack(vals, axis=1)
            val = jnp.where(eff_nb[:, None] == nbx, cand, val)
    else:
        # wide fallback (nb up to 31 + 4-byte raw): one-hot matmul routing --
        # a 31-variant static chain blows up compile time
        win_n = jnp.concatenate(  # win shifted one word (the m_idx+1 selection)
            [win[:, 1:], jnp.zeros((n_rec, 1), jnp.uint32)], axis=1
        )
        wl = jnp.stack(
            [((win >> (8 * b)) & 0xFF).astype(jnp.bfloat16) for b in range(4)]
            + [((win_n >> (8 * b)) & 0xFF).astype(jnp.bfloat16) for b in range(4)],
            axis=2,
        )  # [nRec, pw, 8]
        wr = jnp.arange(pw, dtype=jnp.int32)

        def extract(bitpos, width):
            """Per-position values at arbitrary per-record bit offsets:
            one-hot word routing over the window + dual-word funnel."""
            w_u = width[:, None].astype(jnp.uint32)
            mask_bits = jnp.where(
                w_u >= 32, jnp.uint32(0xFFFFFFFF),
                (jnp.uint32(1) << w_u) - jnp.uint32(1),
            )
            m_idx = bitpos >> 5
            sh = (bitpos & 31).astype(jnp.uint32)
            oh = (m_idx[:, :, None] == wr[None, None, :]).astype(jnp.bfloat16)
            s = jax.lax.dot_general(
                oh, wl, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32,
            ).astype(jnp.uint32)  # [nRec, bs, 8]
            lo = jnp.zeros((n_rec, bs), jnp.uint32)
            hi = jnp.zeros((n_rec, bs), jnp.uint32)
            for b in range(4):
                lo = lo | (s[:, :, b] << (8 * b))
                hi = hi | (s[:, :, 4 + b] << (8 * b))
            return ((lo >> sh) | jnp.where(sh > 0, hi << (jnp.uint32(32) - sh), 0)) & mask_bits

        if enable_lut:
            # pass 1: values (simple/raw) or LUT indices (LUT records)
            nb1 = jnp.where(is_lut, nbits_lut, eff_nb)
            base_bits = jnp.where(is_lut, lut_bytes * 8, 0)
            bitpos = base_bits[:, None] + jnp.arange(bs, dtype=jnp.int32)[None, :] * nb1[:, None]
            val = extract(bitpos, nb1)
            # pass 2: LUT table lookup AS a second extraction at the
            # data-dependent offset (idx - 1) * nb; idx 0 means value 0
            # (the implicit block-min entry, BitStuffer2.cpp:134)
            idx = val.astype(jnp.int32)
            bitpos2 = jnp.clip(idx - 1, 0, None) * nb[:, None]
            val2 = extract(bitpos2, nb)
            val2 = jnp.where(idx == 0, 0, val2)
            val = jnp.where(is_lut[:, None], val2, val)
            # a LUT area + indices overflowing the window means wrong bits
            need_w = (lut_bytes * 8 + bs * nbits_lut + 31) >> 5
            lut_unfit = is_lut & (need_w > pw - 1)
        else:
            bitpos = jnp.arange(bs, dtype=jnp.int32)[None, :] * eff_nb[:, None]
            val = extract(bitpos, eff_nb)

    if mask is not None:
        # expand compacted values back to block positions via the log-shift
        # network: the compaction routing inverted, 6 static rolls +
        # selects -- ~10x fewer per-element ops than a 64-step rank select
        # chain. make_expander barriers its outputs so XLA does not fuse
        # (and recompute) the expansion into each dequant consumer.
        from .device_encode import make_expander

        (val,) = make_expander(vb_r)(val)

    # per-record clamp vector: tile t's [D] ranges repeat over its blocks
    zmax_t = z_max_vec.reshape(n_tiles, 1, d) if n_tiles > 1 else z_max_vec.reshape(1, 1, d)
    m2 = mode[:, None]
    sf_ok = jnp.ones(n_rec, bool)  # per record
    if not is_int:
        raw_f = jax.lax.bitcast_convert_type(val, jnp.float32)
        off2 = offset[:, None]
        zmax_r = jnp.broadcast_to(
            zmax_t.astype(jnp.float32), (n_tiles, n_blocks, d)
        ).reshape(n_rec)[:, None]
        if inv_limbs is not None:
            # bit-exact double ScaleBack; gate raw/const records' quants
            # AND offsets out of the softfloat lanes (raw records carry
            # f32 bit patterns as quants and unset offsets -- garbage
            # there would spuriously trip the ok flag or violate add_f64's
            # zero-or-normal input contract)
            stuffish = (mode == 1) | (mode == 4)
            qv_gated = jnp.where(stuffish[:, None], val, 0)
            off_gated = jnp.where(stuffish, offset, jnp.float32(0))
            z_stuff, _, sf_ok = _exact_f32_scale_back(
                qv_gated, off_gated, zmax_r, inv_limbs, inv_bexp,
                max_q_bits=eff_cap)
        else:
            z_stuff = jnp.minimum(off2 + val.astype(jnp.float32) * inv_scale, zmax_r)
        z = jnp.where(
            m2 == 0, raw_f,
            jnp.where(m2 == 2, 0.0, jnp.where(m2 == 3, off2, z_stuff)),
        )
        if mask is not None:
            z = jnp.where(vb_r, z, 0.0)
        z = z.astype(np_out)
    else:
        if np_out in (jnp.int8, jnp.int16, jnp.int32):
            shift = 32 - 8 * size_t
            raw_i = (val << shift).astype(jnp.int32) >> shift if shift else val.astype(jnp.int32)
        else:
            raw_i = val.astype(jnp.int32)
        off_i = offset.astype(jnp.int32)[:, None]
        inv_i = jnp.round(inv_scale).astype(jnp.int32)
        zmax_i = jnp.broadcast_to(
            zmax_t.astype(jnp.int32), (n_tiles, n_blocks, d)
        ).reshape(n_rec)[:, None]
        z_stuff = jnp.minimum(off_i + val.astype(jnp.int32) * inv_i, zmax_i)
        z = jnp.where(
            m2 == 0, raw_i,
            jnp.where(m2 == 2, 0, jnp.where(m2 == 3, off_i, z_stuff)),
        )
        if mask is not None:
            z = jnp.where(vb_r, z, 0)
        z = z.astype(np_out)

    blocks = z.reshape(n_tiles * n_blocks, d, bs).transpose(0, 2, 1)  # [T*nB, bs, D]
    img = (
        blocks.reshape(n_tiles, nbv, nbh, mb, mb, d)
        .transpose(0, 1, 3, 2, 4, 5)
        .reshape(n_tiles, nbv * mb, nbh * mb, d)
    )
    if n_tiles == 1:
        img = img[0]

    # acceleration-index consistency: the index is untrusted HBM-side
    # metadata (the Fletcher32 covers only wire bytes), so recompute each
    # record's length from its parsed header and require it to match the
    # next index entry -- a stale/tampered index fails loudly, not with
    # silently wrong pixels
    cnt_b0 = rd_u8(sb + 2 + off_w)
    cnt_b1 = rd_u8(sb + 3 + off_w)
    ne_i = (cnt_b0 | jnp.where(cw == 2, cnt_b1 << 8, 0)).astype(jnp.int32)
    stuff_bytes = (ne_i * nb + 7) >> 3
    exp_cnt = cnt_r if mask is not None else bs
    length = jnp.where(
        mode == 2, 1,
        jnp.where(mode == 3, 1 + off_w,
                  jnp.where(mode == 0, 1 + exp_cnt * size_t,
                            1 + off_w + 1 + cw + stuff_bytes)),
    )
    if enable_lut:
        lut_len = (1 + off_w + 1 + cw + 1 + lut_bytes
                   + ((ne_i * nbits_lut + 7) >> 3))
        length = jnp.where(is_lut, lut_len, length)
    # a stuffed count disagreeing with the (mask-derived) valid count
    # means the mask and stream are inconsistent
    cnt_ok = jnp.all((mode != 1) | (ne_i == exp_cnt))
    nxt = jnp.concatenate([starts[1:], starts[:1]])
    deltas = nxt - starts
    # each tile's final record is exempt from the delta check (no
    # successor within its stream; batched streams are padded apart);
    # every other mismatch -- including backward jumps -- fails
    is_last = (jnp.arange(n_rec, dtype=jnp.int32) % rec_per_tile) == rec_per_tile - 1
    ok_rec = (deltas == length) | is_last
    index_ok = ok_rec.all() & cnt_ok
    if not enable_lut:
        # Without LUT support a parsed LUT bit is a hard failure: the
        # feeding encoders never emit LUT records, so it means the index
        # points at bytes that are not the records it claims (or the
        # stream was tampered with).
        index_ok = index_ok & ~is_lut.any()
    rec_fits = ~lut_unfit & sf_ok
    if not always_fits:
        rec_fits = rec_fits & ~(((mode == 0) | (mode == 1)) & (eff_nb > eff_cap))
    fits = rec_fits.reshape(n_tiles, rec_per_tile).all(axis=1)
    if n_tiles == 1:
        fits = fits[0]
    return img, index_ok, fits


def _unpack_records(stream, payload_pos, num_bits, max_vals: int):
    """Gather-decode bit-stuffed values: [nRec] descriptors -> [nRec, max_vals].

    stream: [S] uint32 (byte values), payload_pos: absolute byte offsets.
    Value v's bits [v*nb, v*nb+nb) span at most 5 bytes; assemble them with
    five flat gathers and word-level shifts (keeps shapes 2D; no
    bit-granular tensors).
    """
    nb_u = num_bits[:, None].astype(jnp.uint32)
    bitpos = jnp.arange(max_vals, dtype=jnp.int32)[None, :] * num_bits[:, None]
    byte0 = payload_pos[:, None] + (bitpos >> 3)
    sh = (bitpos & 7).astype(jnp.uint32)
    smax = stream.shape[0] - 1
    acc = jnp.zeros(byte0.shape, jnp.uint32)
    for i in range(4):
        acc = acc | stream[jnp.clip(byte0 + i, 0, smax)] << jnp.uint32(8 * i)
    b4 = stream[jnp.clip(byte0 + 4, 0, smax)]
    lo = acc >> sh
    hi = jnp.where(sh > 0, b4 << (jnp.uint32(32) - sh), 0)
    mask_bits = jnp.where(
        nb_u >= 32, jnp.uint32(0xFFFFFFFF), (jnp.uint32(1) << nb_u) - jnp.uint32(1)
    )
    return (lo | hi) & mask_bits


@functools.partial(
    jax.jit, static_argnames=("h", "w", "d", "dt", "all_valid", "has_lut",
                              "inv_limbs", "inv_bexp")
)
def decode_tiles(
    stream,        # [S] uint8 tile-stream bytes (absolute offsets match scanner)
    mode,          # [nRec] int32 (0 raw, 1 stuff, 2 const0, 3 const-offset, 4 LUT)
    payload_pos,   # [nRec] int64/int32 absolute byte offset
    offset,        # [nRec] float32 block offset (zMin)
    num_bits,      # [nRec] int32
    num_elements,  # [nRec] int32
    lut_pos,       # [nRec] absolute LUT byte offset (mode 4)
    n_lut,         # [nRec] int32
    nbits_lut,     # [nRec] int32
    mask,          # [H, W] bool
    max_z_error,   # f32 scalar
    z_max_vec,     # [D] f32 clamp values
    h: int, w: int, d: int, dt: DataType, all_valid: bool, has_lut: bool,
    inv_limbs: tuple | None = None,  # decompose_scalar(2*maxZError): when
    inv_bexp: int = 0,               # set, f32 dequant is bit-exact f64
):
    """Returns (data [H, W, D] in the native dtype, ok). ok is False only
    when the exact-f32 softfloat path saw a sum leave the normal-f64
    range (callers fall back to the host decoder); always True
    otherwise."""
    is_int = dt < DataType.FLOAT
    np_out = {DataType.CHAR: jnp.int8, DataType.BYTE: jnp.uint8,
              DataType.SHORT: jnp.int16, DataType.USHORT: jnp.uint16,
              DataType.INT: jnp.int32, DataType.UINT: jnp.uint32,
              DataType.FLOAT: jnp.float32}[dt]

    nbv, nbh = -(-h // MB), -(-w // MB)
    n_blocks = nbv * nbh
    n_rec = n_blocks * d
    inv_scale = (2.0 * max_z_error).astype(jnp.float32)

    stream_u32 = stream.astype(jnp.uint32)
    payload_pos = payload_pos.astype(jnp.int32)

    # effective validity per block position: real-image area and mask
    vmask_full = jnp.ones((h, w), bool) if all_valid else mask
    padded = jnp.zeros((nbv * MB, nbh * MB), bool).at[:h, :w].set(vmask_full)
    vb = padded.reshape(nbv, MB, nbh, MB).transpose(0, 2, 1, 3).reshape(n_blocks, BS)
    in_img = (
        jnp.zeros((nbv * MB, nbh * MB), bool).at[:h, :w].set(True)
        .reshape(nbv, MB, nbh, MB).transpose(0, 2, 1, 3).reshape(n_blocks, BS)
    )
    area = in_img.sum(axis=1).astype(jnp.int32)  # real pixels per block

    # per-record "use all real positions" flag (stuffed count == block area)
    area_r = jnp.repeat(area, d)
    fill_all = (mode % 8 == 1) | (mode % 8 == 4)
    use_all = fill_all & (num_elements == area_r)

    # value rank per position: over mask-valid (normal) or all real positions
    vb_r = jnp.repeat(vb, d, axis=0) if d > 1 else vb
    in_img_r = jnp.repeat(in_img, d, axis=0) if d > 1 else in_img
    eff_valid = jnp.where(use_all[:, None], in_img_r, vb_r & in_img_r)
    rank = jnp.cumsum(eff_valid, axis=1).astype(jnp.int32) - 1
    rank = jnp.clip(rank, 0, BS - 1)

    # ---- bit-stuffed values
    q = _unpack_records(stream_u32, payload_pos, num_bits, BS)
    if has_lut:
        idx = _unpack_records(stream_u32, payload_pos, nbits_lut, BS)
        lut_vals = _unpack_records(stream_u32, lut_pos.astype(jnp.int32), num_bits, 256)
        # full LUT = [0] + lut_vals
        lut_full = jnp.concatenate(
            [jnp.zeros((n_rec, 1), jnp.uint32), lut_vals[:, :255]], axis=1
        )
        q_lut = jnp.take_along_axis(lut_full, jnp.clip(idx, 0, 255).astype(jnp.int32), axis=1)
        q = jnp.where((mode[:, None] % 8) == 4, q_lut, q)

    qv = jnp.take_along_axis(q, rank, axis=1)  # value per position

    # ---- raw values + mode combine
    m8 = (mode % 8)[:, None]
    sf_ok = jnp.bool_(True)
    sf_pair = None
    if not is_int:
        b0 = payload_pos[:, None] + rank * 4
        word = (
            stream_u32[jnp.clip(b0, 0, stream.shape[0] - 1)]
            | stream_u32[jnp.clip(b0 + 1, 0, stream.shape[0] - 1)] << 8
            | stream_u32[jnp.clip(b0 + 2, 0, stream.shape[0] - 1)] << 16
            | stream_u32[jnp.clip(b0 + 3, 0, stream.shape[0] - 1)] << 24
        )
        raw_vals = jax.lax.bitcast_convert_type(word.astype(jnp.uint32), jnp.float32)
        off2 = offset[:, None]
        zmax_r = jnp.tile(z_max_vec.astype(jnp.float32), n_blocks)[:, None]
        if inv_limbs is not None:
            # gate raw/const records' quants and offsets out of the
            # softfloat lanes (see decode_tiles_fast)
            stuffish = (mode % 8 == 1) | (mode % 8 == 4)
            z_stuff, sf_pair, sf_ok = _exact_f32_scale_back(
                jnp.where(stuffish[:, None], qv, 0),
                jnp.where(stuffish, offset, jnp.float32(0)), zmax_r,
                inv_limbs, inv_bexp)
            sf_ok = jnp.all(sf_ok)
        else:
            z_stuff = jnp.minimum(off2 + qv.astype(jnp.float32) * inv_scale, zmax_r)
        z = jnp.where(
            m8 == 0, raw_vals,
            jnp.where(m8 == 2, 0.0, jnp.where(m8 == 3, off2, z_stuff)),
        )
        write = jnp.where((m8 == 3) | (m8 == 0), vb_r & in_img_r, eff_valid)
        # depth-diff delta before adding the previous slice (mode >= 8):
        # stuff/const-offset contribute offset(+q*invScale), const-2 copies
        a_diff = jnp.where(m8 == 2, 0.0, jnp.where(m8 == 3, off2,
                                                   off2 + qv.astype(jnp.float32) * inv_scale))
        out_vals, zmax_rr = jnp.where(write, z, 0.0), zmax_r
    else:
        # exact integer arithmetic (invScale and offsets are integral for ints)
        nbytes = np.dtype(np_out).itemsize
        b0 = payload_pos[:, None] + rank * nbytes
        word = jnp.zeros(b0.shape, jnp.uint32)
        for i in range(nbytes):
            word = word | stream_u32[jnp.clip(b0 + i, 0, stream.shape[0] - 1)] << (8 * i)
        if np_out in (jnp.int8, jnp.int16, jnp.int32):
            shift = 32 - 8 * nbytes
            raw_i = (word << shift).astype(jnp.int32) >> shift if shift else word.astype(jnp.int32)
        else:
            raw_i = word.astype(jnp.int32)
        off_i = offset.astype(jnp.int32)[:, None]  # caller passes exact int32 offsets
        inv_i = jnp.round(inv_scale).astype(jnp.int32)
        zmax_i = z_max_vec.astype(jnp.int32)
        zmax_i = jnp.tile(zmax_i, n_blocks)[:, None]
        z_stuff = jnp.minimum(off_i + qv.astype(jnp.int32) * inv_i, zmax_i)
        z = jnp.where(
            m8 == 0, raw_i,
            jnp.where(m8 == 2, 0, jnp.where(m8 == 3, off_i, z_stuff)),
        )
        write = jnp.where((m8 == 3) | (m8 == 0), vb_r & in_img_r, eff_valid)
        a_diff = jnp.where(m8 == 2, 0, jnp.where(m8 == 3, off_i,
                                                 off_i + qv.astype(jnp.int32) * inv_i))
        out_vals, zmax_rr = jnp.where(write, z, 0), zmax_i

    # ---- depth-diff records (v5+, mode bit 3): slice d = f(slice d-1).
    # Sequential in depth by construction (Lerc2.cpp:2026-2230 ReadTile's
    # bDiff branches), so a lax.scan over the (tiny) depth axis resolves
    # the chain; everything per-slice stays vectorized over records.
    if d > 1 and (is_int or sf_pair is None):
        is_diff = (mode >= 8)[:, None]
        sh = (n_blocks, d, BS)
        xs = (
            out_vals.reshape(sh).transpose(1, 0, 2),
            a_diff.reshape(sh).transpose(1, 0, 2),
            is_diff.reshape(n_blocks, d, 1).transpose(1, 0, 2),
            (m8 == 2).reshape(n_blocks, d, 1).transpose(1, 0, 2),
            write.reshape(sh).transpose(1, 0, 2),
            zmax_rr.reshape(n_blocks, d, 1).transpose(1, 0, 2),
        )

        def step(prev, x):
            z_nd, a_d, dif, is_c2, wr, zm = x
            z_df = jnp.where(is_c2, prev, jnp.minimum(a_d + prev, zm))
            out = jnp.where(dif, jnp.where(wr, z_df, 0), z_nd)
            return out, out

        zero = jnp.zeros((n_blocks, BS), out_vals.dtype)
        _, slices = jax.lax.scan(step, zero, xs)
        out_vals = slices.transpose(1, 0, 2).reshape(n_rec, BS)
    elif d > 1:
        # exact f32 diff chain: z = (float)min(a_diff_f64 + (double)prev,
        # zMax) with prev the previous slice's decoded FLOAT, exactly the
        # reference's evaluation order (ScaleBack's left-to-right sum).
        from . import device_softf64 as sf

        is_diff = (mode >= 8)[:, None]
        # a_diff as f64 pairs: pre-clamp stuff sum for stuff/LUT (and raw,
        # matching the f32 branch's formula choice), widened offset for
        # const-offset; const-2 bypasses via is_c2 in the step
        offh, offl = sf.f32_to_f64_bits(
            jax.lax.bitcast_convert_type(offset, jnp.uint32))
        a_h = jnp.where(m8 == 3, jnp.broadcast_to(offh[:, None], sf_pair[0].shape),
                        sf_pair[0])
        a_l = jnp.where(m8 == 3, jnp.broadcast_to(offl[:, None], sf_pair[1].shape),
                        sf_pair[1])
        sh = (n_blocks, d, BS)
        sh1 = (n_blocks, d, 1)
        xs = (
            out_vals.reshape(sh).transpose(1, 0, 2),
            a_h.reshape(sh).transpose(1, 0, 2),
            a_l.reshape(sh).transpose(1, 0, 2),
            is_diff.reshape(sh1).transpose(1, 0, 2),
            (m8 == 2).reshape(sh1).transpose(1, 0, 2),
            write.reshape(sh).transpose(1, 0, 2),
            zmax_rr.reshape(sh1).transpose(1, 0, 2),
        )

        def step(carry, x):
            prev, okc = carry
            z_nd, ah, al, dif, is_c2, wr, zm_ = x
            ph, pl = sf.f32_to_f64_bits(
                jax.lax.bitcast_convert_type(prev, jnp.uint32))
            th, tl, ok_a = sf.add_f64(ah, al, ph, pl)
            t32 = jax.lax.bitcast_convert_type(
                sf.f64_to_f32_rne(th, tl), jnp.float32)
            # clamp after narrowing (see _exact_f32_scale_back: zMax is an
            # exact f32, RNE is monotone, ties keep the z operand)
            z_df = jnp.where(zm_ < t32, jnp.broadcast_to(zm_, t32.shape), t32)
            z_df = jnp.where(is_c2, prev, z_df)
            out = jnp.where(dif, jnp.where(wr, z_df, 0), z_nd)
            # only diff records' adds can trip ok (others are discarded)
            okc = okc & jnp.all(ok_a | ~dif)
            return (out, okc), out

        zero = jnp.zeros((n_blocks, BS), out_vals.dtype)
        (_, sf_ok_d), slices = jax.lax.scan(step, (zero, jnp.bool_(True)), xs)
        sf_ok = sf_ok & sf_ok_d
        out_vals = slices.transpose(1, 0, 2).reshape(n_rec, BS)
    out_vals = out_vals.astype(np_out)

    # ---- scatter back: records [nB*d, 64] -> [H, W, D]
    blocks = out_vals.reshape(n_blocks, d, BS).transpose(0, 2, 1)  # [nB, 64, D]
    img = (
        blocks.reshape(nbv, nbh, MB, MB, d)
        .transpose(0, 2, 1, 3, 4)
        .reshape(nbv * MB, nbh * MB, d)[:h, :w, :]
    )
    return img, sf_ok


@functools.partial(
    jax.jit,
    static_argnames=("inv_limbs", "inv_bexp", "h", "w", "d", "all_valid",
                     "has_lut"),
)
def decode_tiles_f64(
    stream,        # [S] uint8 tile-stream bytes (absolute offsets match scanner)
    mode,          # [nRec] int32 (0 raw, 1 stuff, 2 const0, 3 const-offset, 4 LUT)
    payload_pos,   # [nRec] int32 absolute byte offset
    offset_hi,     # [nRec] uint32 block-offset f64 bit patterns (high word)
    offset_lo,     # [nRec] uint32 (low word)
    num_bits,      # [nRec] int32
    num_elements,  # [nRec] int32
    lut_pos,       # [nRec] absolute LUT byte offset (mode 4)
    nbits_lut,     # [nRec] int32
    mask,          # [H, W] bool
    zmax_hi,       # [D] uint32 clamp f64 bit patterns (high word)
    zmax_lo,       # [D] uint32 (low word)
    inv_limbs: tuple, inv_bexp: int,  # decompose_scalar(2 * maxZError)
    h: int, w: int, d: int, all_valid: bool, has_lut: bool,
):
    """Lossy float64 tiling decode, BIT-EXACT vs the reference's f64
    arithmetic (Lerc2.h ScaleBack: z = zMin + q * invScale, separately
    rounded mul and add, then std::min(z, zMax)) via the softfloat
    kernels in device_softf64 -- pure u32 ops, identical on every backend.

    Returns (data_hi [H, W, D] u32, data_lo, ok). ok False means some
    dequantized sum left the normal-f64 range (host fallback); callers
    must precheck that offsets and zmax are zero-or-normal finite and
    that decompose_scalar accepted invScale."""
    from . import device_softf64 as sf

    nbv, nbh = -(-h // MB), -(-w // MB)
    n_blocks = nbv * nbh
    n_rec = n_blocks * d

    stream_u32 = stream.astype(jnp.uint32)
    payload_pos = payload_pos.astype(jnp.int32)

    vmask_full = jnp.ones((h, w), bool) if all_valid else mask
    padded = jnp.zeros((nbv * MB, nbh * MB), bool).at[:h, :w].set(vmask_full)
    vb = padded.reshape(nbv, MB, nbh, MB).transpose(0, 2, 1, 3).reshape(n_blocks, BS)
    in_img = (
        jnp.zeros((nbv * MB, nbh * MB), bool).at[:h, :w].set(True)
        .reshape(nbv, MB, nbh, MB).transpose(0, 2, 1, 3).reshape(n_blocks, BS)
    )
    area = in_img.sum(axis=1).astype(jnp.int32)
    area_r = jnp.repeat(area, d)
    fill_all = (mode % 8 == 1) | (mode % 8 == 4)
    use_all = fill_all & (num_elements == area_r)

    vb_r = jnp.repeat(vb, d, axis=0) if d > 1 else vb
    in_img_r = jnp.repeat(in_img, d, axis=0) if d > 1 else in_img
    eff_valid = jnp.where(use_all[:, None], in_img_r, vb_r & in_img_r)
    rank = jnp.cumsum(eff_valid, axis=1).astype(jnp.int32) - 1
    rank = jnp.clip(rank, 0, BS - 1)

    # ---- bit-stuffed quants (u32, nb <= 32)
    q = _unpack_records(stream_u32, payload_pos, num_bits, BS)
    if has_lut:
        idx = _unpack_records(stream_u32, payload_pos, nbits_lut, BS)
        lut_vals = _unpack_records(stream_u32, lut_pos.astype(jnp.int32), num_bits, 256)
        lut_full = jnp.concatenate(
            [jnp.zeros((n_rec, 1), jnp.uint32), lut_vals[:, :255]], axis=1
        )
        q_lut = jnp.take_along_axis(lut_full, jnp.clip(idx, 0, 255).astype(jnp.int32), axis=1)
        q = jnp.where(mode[:, None] % 8 == 4, q_lut, q)
    qv = jnp.take_along_axis(q, rank, axis=1)

    # ---- softfloat dequant: z = min(offset + qv * invScale, zmax)
    ph, pl = sf.mul_u32_scalar(qv, inv_limbs, inv_bexp)
    oh2 = offset_hi[:, None]
    ol2 = offset_lo[:, None]
    zh, zl, addok = sf.add_f64(
        jnp.broadcast_to(oh2, ph.shape), jnp.broadcast_to(ol2, ph.shape), ph, pl
    )
    zmh = jnp.tile(zmax_hi, n_blocks)[:, None]
    zml = jnp.tile(zmax_lo, n_blocks)[:, None]
    pre_h, pre_l = zh, zl  # pre-clamp sum: the depth-diff chain adds prev
    zh, zl = sf.min_f64(zh, zl, jnp.broadcast_to(zmh, zh.shape),
                        jnp.broadcast_to(zml, zl.shape))

    # ---- raw f64 values: 8 bytes at payload_pos + rank * 8
    b0 = payload_pos[:, None] + rank * 8
    smax = stream.shape[0] - 1
    raw_lo = jnp.zeros(b0.shape, jnp.uint32)
    raw_hi = jnp.zeros(b0.shape, jnp.uint32)
    for i in range(4):
        raw_lo = raw_lo | stream_u32[jnp.clip(b0 + i, 0, smax)] << jnp.uint32(8 * i)
        raw_hi = raw_hi | stream_u32[jnp.clip(b0 + 4 + i, 0, smax)] << jnp.uint32(8 * i)

    m8 = mode[:, None] % 8
    stuffed = (m8 == 1) | (m8 == 4)
    out_hi = jnp.where(
        m8 == 0, raw_hi,
        jnp.where(m8 == 2, 0, jnp.where(m8 == 3, oh2, zh)),
    )
    out_lo = jnp.where(
        m8 == 0, raw_lo,
        jnp.where(m8 == 2, 0, jnp.where(m8 == 3, ol2, zl)),
    )
    write = jnp.where((m8 == 3) | (m8 == 0), vb_r & in_img_r, eff_valid)
    out_hi = jnp.where(write, out_hi, 0)
    out_lo = jnp.where(write, out_lo, 0)
    ok = jnp.all(addok | ~(stuffed & write))

    # ---- depth-diff records (v5+, mode bit 3): slice d = f(slice d-1),
    # resolved by a lax.scan exactly like the f32 branch of decode_tiles
    # but with no narrowing -- z = a + prev (one f64 rounding) then
    # min(z, zMax), matching ReadTile's double loops (Lerc2.cpp:2150-2199).
    # Raw records can't be diff (the reference rejects comprFlag==0 with
    # bDiff); flag them not-ok so callers route to the host decoder.
    if d > 1:
        is_diff = (mode >= 8)[:, None]
        ok = ok & ~jnp.any(is_diff & (m8 == 0))
        a_h = jnp.where(m8 == 3, jnp.broadcast_to(oh2, zh.shape), pre_h)
        a_l = jnp.where(m8 == 3, jnp.broadcast_to(ol2, zl.shape), pre_l)
        a_h = jnp.where(stuffed | (m8 == 3), a_h, 0)  # zero-pair elsewhere
        a_l = jnp.where(stuffed | (m8 == 3), a_l, 0)
        zmh2 = jnp.tile(zmax_hi, n_blocks)[:, None]
        zml2 = jnp.tile(zmax_lo, n_blocks)[:, None]
        shp = (n_blocks, d, BS)
        sh1 = (n_blocks, d, 1)
        xs = (
            out_hi.reshape(shp).transpose(1, 0, 2),
            out_lo.reshape(shp).transpose(1, 0, 2),
            a_h.reshape(shp).transpose(1, 0, 2),
            a_l.reshape(shp).transpose(1, 0, 2),
            is_diff.reshape(sh1).transpose(1, 0, 2),
            (m8 == 2).reshape(sh1).transpose(1, 0, 2),
            write.reshape(shp).transpose(1, 0, 2),
            zmh2.reshape(sh1).transpose(1, 0, 2),
            zml2.reshape(sh1).transpose(1, 0, 2),
        )

        def step(carry, x):
            ph_, pl_, okc = carry
            z_h, z_l, ah_, al_, dif, is_c2, wr, zmh_, zml_ = x
            th, tl, ok_a = sf.add_f64(ah_, al_, ph_, pl_)
            ch, cl = sf.min_f64(th, tl, jnp.broadcast_to(zmh_, th.shape),
                                jnp.broadcast_to(zml_, tl.shape))
            dh = jnp.where(is_c2, ph_, ch)
            dl = jnp.where(is_c2, pl_, cl)
            o_h = jnp.where(dif, jnp.where(wr, dh, 0), z_h)
            o_l = jnp.where(dif, jnp.where(wr, dl, 0), z_l)
            # a raw previous slice can hold subnormal/inf/NaN doubles,
            # outside add_f64's zero-or-normal contract: flag, host path
            pe = (ph_ >> jnp.uint32(20)) & jnp.uint32(0x7FF)
            p_bad = ((pe == 0) & (((ph_ & jnp.uint32(0xFFFFF)) | pl_) != 0)
                     ) | (pe == 0x7FF)
            okc = okc & jnp.all((ok_a & ~p_bad) | ~(dif & ~is_c2))
            return (o_h, o_l, okc), (o_h, o_l)

        zero = jnp.zeros((n_blocks, BS), jnp.uint32)
        (_, _, ok_d), (hs, ls) = jax.lax.scan(
            step, (zero, zero, jnp.bool_(True)), xs)
        ok = ok & ok_d
        out_hi = hs.transpose(1, 0, 2).reshape(n_rec, BS)
        out_lo = ls.transpose(1, 0, 2).reshape(n_rec, BS)

    def assemble(vals):
        blocks = vals.reshape(n_blocks, d, BS).transpose(0, 2, 1)
        return (
            blocks.reshape(nbv, nbh, MB, MB, d)
            .transpose(0, 2, 1, 3, 4)
            .reshape(nbv * MB, nbh * MB, d)[:h, :w, :]
        )

    return assemble(out_hi), assemble(out_lo), ok
