"""Device-accelerated band codec: JAX/XLA kernels for the tiling path,
native scanner for the serial record chain, host assembly for the tiny
header/mask/ranges sections.

Encode coverage: every dtype and encode family runs on device -- tiling
with LUT blocks and the 16x16 micro-block retrial, 8-bit whole-image
Huffman (all-valid and masked), float32 AND float64 lossless fpl (u32
limb pairs), float64 lossy tiling (double-single); the maxZError
analyses (auto-raise, bit-plane cut) run host-side in exact f64.

Decode coverage: the scan-free tiling fast path (all-valid and masked,
LUT and 16x16 records included), whole-image Huffman (masked included)
and fpl f32/f64 via per-group bit-offset sidecars -- rebuilt by the
native lengths-only scan for FOREIGN blobs, so reference-encoded 8-bit
and lossless-float blobs decode device-parallel too -- lossy f64 tiling
via exact softfloat dequant, lossy f32 tiling BIT-EXACT via the same
softfloat kernels (double ScaleBack + RNE narrow, Lerc2.h:381-399), and
depth-diff records for EVERY dtype (lax.scan over depth; f64 chains run
entirely in softfloat pairs); fpl is mask-oblivious so masked blobs take
the same pipeline. Remaining host corners: pre-v6 lossless f64 and
one-sweep (both plain memcpy shapes).
"""
from __future__ import annotations

import struct

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import DataType, DT_SIZE, DT_TO_NUMPY, NUMPY_TO_DT, ImageEncodeMode, dt_is_int
from ..ops import (device_decode, device_encode, device_f64, device_fpl,
                   device_huffman, device_softf64 as softf64)
from .. import native
from . import fletcher32, header as hdr, huffman, rle
from .. import profiling
from .bitmask import bits_to_bool, bool_to_bits, mask_size_bytes
from .lerc2_decode import DecodedBand


class DeviceUnsupported(ValueError):
    """The device encoder does not handle this band (configuration or
    capacity); the caller encodes it with the host codec instead."""


def _round_cap(n: int) -> int:
    """Round capacity up (pow2) to limit recompilation across sizes."""
    cap = 1 << max(12, (n - 1).bit_length())
    return cap


def supports_encode(dt: DataType, max_z_error: float, n_depth: int,
                    all_valid: bool = True) -> bool:
    # every dtype/mode has a device path: lossy f64 via double-single
    # tiling, lossless f64 via the fpl limb-pair pipeline
    return True


@profiling.profiled("device.encode_band")
def encode_band_device(
    data,  # [H, W, D] numpy or jax array
    mask: np.ndarray | None,
    max_z_error: float,
    version: int = 6,
    encode_mask: bool = True,
    n_blobs_more: int = 0,
    verify: bool = False,
    return_index: bool = False,
) -> bytes:
    np_dtype = np.dtype(data.dtype)
    dt = NUMPY_TO_DT[np_dtype]
    h, w, d = data.shape

    all_valid = mask is None or bool(np.asarray(mask).all())
    if not supports_encode(dt, max_z_error, d, all_valid):
        raise DeviceUnsupported("configuration not supported by the device encoder")
    if all_valid:
        num_valid = h * w
        mask_np = np.ones((h, w), dtype=bool)
    else:
        mask_np = np.asarray(mask, dtype=bool)
        num_valid = int(mask_np.sum())

    # maxZError analyses (host numpy, exact f64; the encode itself is on
    # device): bit-plane noise cut for negative mze / 777, float auto-raise
    from . import lerc2_encode as l2e

    mze = float(max_z_error)
    if mze == 777:  # cheat code (Lerc2.cpp:210-218)
        mze = -0.01
    if dt_is_int(dt):
        if mze < 0:
            ok, new_mze = l2e.try_bit_plane_compression(
                np.asarray(data), mask_np, dt, d, num_valid, -mze
            )
            mze = new_mze if ok else 0
        mze = max(0.5, np.floor(mze))
    else:
        if mze < 0:
            raise ValueError("negative maxZError not allowed for float types")
        if mze > 0:
            ok, new_mze = l2e.try_raise_max_z_error(np.asarray(data), mask_np, mze)
            if ok:
                mze = new_mze

    dev_dtype = jnp.int32 if dt_is_int(dt) else jnp.float32
    mask_dev = jnp.asarray(mask_np)

    n_rec = (-(-h // 8)) * (-(-w // 8)) * d
    cap = _round_cap(num_valid * DT_SIZE[dt] * d + n_rec * 12 + 4096)

    f64_lossless = dt == DataType.DOUBLE and mze == 0
    if dt == DataType.DOUBLE:
        data_np = np.ascontiguousarray(np.asarray(data), dtype=np.float64)
        data_dev = None
        if f64_lossless:
            # no device tiling candidate for lossless doubles (mze==0
            # forces every block raw anyway, always bigger than one-sweep);
            # the fpl limb-pair path below carries the payload
            stream, total = None, 1 << 60
        else:
            d_hi, d_lo, d_bits = device_f64.split_f64_host(data_np)
            mh = np.float32(mze)
            ml = np.float32(np.float64(mze) - np.float64(mh))
            stream, total, _starts = device_f64.encode_tiles_f64(
                jnp.asarray(d_hi), jnp.asarray(d_lo), jnp.asarray(d_bits),
                mask_dev, jnp.float32(mh), jnp.float32(ml),
                h, w, d, all_valid, version, cap,
            )
        # exact f64 ranges on host
        zmin_vec = np.array([data_np[:, :, k][mask_np].min() if num_valid else 0.0
                             for k in range(d)])
        zmax_vec = np.array([data_np[:, :, k][mask_np].max() if num_valid else 0.0
                             for k in range(d)])
    else:
        data_dev = jnp.asarray(np.asarray(data), dtype=dev_dtype) if not isinstance(data, jax.Array) else data.astype(dev_dtype)
        stream, total, zmin_vec, zmax_vec, _starts, _fits = device_encode.encode_tiles(
            data_dev, mask_dev, jnp.float32(mze), h, w, d, dt, all_valid, version, cap,
            enable_lut=True,
        )
        zmin_vec = np.asarray(zmin_vec, dtype=np.float64)
        zmax_vec = np.asarray(zmax_vec, dtype=np.float64)
    total = int(total)
    if stream is not None and total > cap:
        raise DeviceUnsupported("device encode capacity exceeded")

    head = hdr.HeaderInfo(
        version=version, n_rows=h, n_cols=w, n_depth=d, num_valid_pixel=num_valid,
        micro_block_size=8, dt=dt, max_z_error=mze,
        n_blobs_more=n_blobs_more if version >= 6 else 0,
    )

    # mask section
    need_mask = 0 < num_valid < h * w
    if need_mask and encode_mask:
        bits = bool_to_bits(mask_np)
        mask_rle = native.rle_compress(bits) if native.available() else rle.compress(bits)
        mask_section = struct.pack("<i", len(mask_rle)) + mask_rle
    else:
        mask_section = struct.pack("<i", 0)

    np_dt = DT_TO_NUMPY[dt]

    def assemble(ranges: bytes, body: bytes) -> bytes:
        head.blob_size = hdr.header_size(version) + len(mask_section) + len(ranges) + len(body)
        blob = bytearray(hdr.write_header(head))
        blob += mask_section
        blob += ranges
        blob += body
        if version >= 3:
            skip = hdr.checksum_skip(version)
            checksum = fletcher32.fletcher32(bytes(blob[skip:]))
            struct.pack_into("<I", blob, skip - 4, checksum)
        return bytes(blob)

    def done(blob: bytes):
        # trivial blobs (empty / constant) carry no acceleration index
        return (blob, None) if return_index else blob

    if num_valid == 0:
        return done(assemble(b"", b""))

    head.z_min = float(zmin_vec.min())
    head.z_max = float(zmax_vec.max())
    if head.z_min == head.z_max:
        return done(assemble(b"", b""))

    ranges = b""
    if version >= 4:
        ranges = zmin_vec.astype(np_dt).tobytes() + zmax_vec.astype(np_dt).tobytes()
        if np.array_equal(zmin_vec, zmax_vec):
            return done(assemble(ranges, b""))

    if f64_lossless:
        payload, f64_fpl_sidecar = _encode_fpl_device_f64(
            data_np, h, w, d, want_sidecar=True)
        n_bytes_data = len(payload)
        n_bytes_tiling = 1 << 60  # suppresses the 16x16 retrial gates
        image_mode = ImageEncodeMode.DELTA_DELTA_HUFFMAN
        n_bytes_huffman = n_bytes_data
    else:
        payload = np.asarray(stream)[:total].tobytes()  # fixed-shape transfer
        n_bytes_data = total
        n_bytes_tiling = total
        n_bytes_huffman = 0
        image_mode = ImageEncodeMode.TILING
    try_huffman = head.try_huffman_int() or head.try_huffman_flt()

    # whole-image Huffman candidate (8-bit types, lossless): device
    # histogram + symbol packing, host tree build (256 symbols)
    huffman_sbits = None
    if head.try_huffman_int():
        hm = _encode_huffman_device(
            data_dev, h, w, d, dt, version,
            None if all_valid else mask_dev, num_valid,
        )
        if hm is not None:
            n_bytes_huffman = len(hm[1])
            if n_bytes_huffman < n_bytes_data:
                image_mode, hbytes, huffman_sbits = hm
                payload = hbytes
                n_bytes_data = n_bytes_huffman
    fpl_sidecar = f64_fpl_sidecar if f64_lossless else None
    if head.try_huffman_flt() and dt == DataType.FLOAT:
        # fpl lossless float (v6): accepted only when >= 10% smaller than
        # tiling (Lerc2.cpp:322)
        fbytes, fside = _encode_fpl_device(data_dev, h, w, d, want_sidecar=True)
        if fbytes is not None:
            # mirror the host encoder (lerc2_encode.py:229): the candidate
            # size feeds the 16x16 retrial gate even when fpl loses
            n_bytes_huffman = len(fbytes)
            if n_bytes_huffman < n_bytes_data * 0.9:
                image_mode = ImageEncodeMode.DELTA_DELTA_HUFFMAN
                payload = fbytes
                n_bytes_data = n_bytes_huffman
                fpl_sidecar = fside

    # 16x16 micro-block retrial at low bit rates (Lerc2.cpp:333-357): half
    # the per-block header overhead when blocks compress below ~1.5 bpp
    n_one_sweep = DT_SIZE[dt] * d * num_valid
    if (
        n_bytes_tiling * 8 < h * w * d * 1.5
        and n_bytes_tiling < 4 * n_one_sweep
        and (n_bytes_huffman == 0 or n_bytes_tiling < 2 * n_bytes_huffman)
        and (h > 8 or w > 8)
        and dt != DataType.DOUBLE
    ):
        s16, t16, _zm, _zx, _st16, _f16 = device_encode.encode_tiles(
            data_dev, mask_dev, jnp.float32(mze), h, w, d, dt, all_valid,
            version, cap, enable_lut=True, mb=16,
        )
        t16 = int(t16)
        if t16 <= n_bytes_data:
            head.micro_block_size = 16
            image_mode = ImageEncodeMode.TILING
            payload = np.asarray(s16)[:t16].tobytes()
            n_bytes_data = t16

    if n_one_sweep <= n_bytes_data + (1 if try_huffman else 0):
        body = b"\x01" + np.asarray(data)[mask_np].astype(np_dt).tobytes()
        image_mode = ImageEncodeMode.TILING
        huffman_sbits = None
        fpl_sidecar = None
    else:
        body = b"\x00"
        if try_huffman:
            body += bytes([int(image_mode)])
        body += payload
    blob = assemble(ranges, body)
    if verify:
        _verify_device_encode(blob, np.asarray(data), mask_np, mze, dt)
    if return_index:
        index = None
        if (image_mode in (ImageEncodeMode.HUFFMAN, ImageEncodeMode.DELTA_HUFFMAN)
                and huffman_sbits is not None):
            index = {"huffman_sbits": np.asarray(huffman_sbits).astype(np.int32)}
        elif (image_mode == ImageEncodeMode.DELTA_DELTA_HUFFMAN
                and fpl_sidecar is not None):
            index = {"fpl_sbits": {int(k): np.asarray(v).astype(np.int32)
                                   for k, v in fpl_sidecar.items()}}
        return blob, index
    return blob


def _verify_device_encode(blob, data, mask_np, mze, dt):
    """ENCODE_VERIFY semantics for the device path (reference
    Lerc.cpp:1081-1211): decode the fresh blob and compare to the input at
    valid pixels with maxZError * 1.1 tolerance; masks must round trip."""
    from .orchestrator import decode_blob

    res = decode_blob(blob)
    if not np.array_equal(res.masks[0], mask_np):
        raise ValueError("ENCODE_VERIFY: mask mismatch")
    got = res.data[0].astype(np.float64)
    want = data.astype(np.float64)
    lossless = mze == 0 or (dt_is_int(dt) and mze == 0.5)
    if mask_np.any():
        err = np.abs(got - want)[mask_np].max()
        limit = 0 if lossless else mze * 1.1
        if err > limit:
            raise ValueError(f"ENCODE_VERIFY: error {err} exceeds {limit}")


def _fpl_assemble(pred, levels, histos, planes, pb_sizes, n, unit_size):
    """Shared host assembly of the fpl wire section from device outputs:
    per-plane method choice (min of Huffman/PackBits/raw with the
    RLE-const shortcut, fpl_EsriHuffman.cpp:319-451), tree builds, and the
    batched device Huffman pack. Returns (bytes, sidecar) where sidecar
    maps plane index -> per-group bit offsets for Huffman planes (the
    device-decode acceleration index)."""
    lens_codes = np.zeros((unit_size, 256, 5), np.float32)
    metas: list[tuple] = []
    max_len_all = 1
    total_bits = [0] * unit_size
    for b in range(unit_size):
        hst = histos[b]
        if np.count_nonzero(hst) < 2:
            metas.append(("rle", None, None))
            continue
        lengths = huffman.compute_code_lengths(hst)
        hb = huffman.compute_compressed_size(hst, lengths) if lengths is not None else -1
        if lengths is None or hb <= 0:
            hb = 1 << 60
        pb = int(pb_sizes[b])
        if pb < hb and pb < n:  # PackBits wins: exact encode on host
            metas.append(("packbits", None, None))
            continue
        if hb >= n:
            metas.append(("raw", None, None))
            continue
        codes = huffman.canonical_codes(lengths)
        lens_codes[b, :, 0] = lengths
        for i in range(4):
            lens_codes[b, :, 1 + i] = (codes >> (8 * i)) & 0xFF
        metas.append(("huff", lengths, codes))
        total_bits[b] = int((hst * lengths.astype(np.int64)).sum())
        max_len_all = max(max_len_all, int(lengths.max()))

    streams = sbits_all = None
    if any(m[0] == "huff" for m in metas):
        pwh = next(p for p in (18, 34, 66)
                   if p >= (device_huffman.GROUP * max_len_all + 31) // 32 + 1)
        need = max(4 * (-(-tb // 32) + 1) for tb in total_bits)
        cap = 1 << max(12, (need + 511).bit_length())
        streams, _tbs, sbits_all = device_fpl.fpl_pack_planes_device(
            planes, jnp.asarray(lens_codes), cap, pwh
        )
        streams = np.asarray(streams)
        sbits_all = np.asarray(sbits_all)

    planes_h = None
    sidecar: dict[int, np.ndarray] = {}
    out = bytearray([pred])
    for b in range(unit_size):
        kind, lengths, codes = metas[b]
        if kind == "rle":
            v = int(np.argmax(histos[b]))
            payload = bytes([1, v]) + struct.pack("<I", n)
        elif kind == "packbits":
            from . import fpl_impl

            if planes_h is None:
                planes_h = np.asarray(planes)
            payload = b"\x03" + fpl_impl.encode_packbits(planes_h[b])
        elif kind == "raw":
            if planes_h is None:
                planes_h = np.asarray(planes)
            payload = b"\x02" + planes_h[b].tobytes()
        else:
            table = huffman.write_code_table(lengths, codes, 5)
            sbytes = 4 * (-(-total_bits[b] // 32) + 1)
            payload = b"\x00" + table + streams[b].tobytes()[:sbytes]
            sidecar[b] = sbits_all[b]
        out += bytes([b, int(levels[b])])
        out += struct.pack("<I", len(payload))
        out += payload
    return bytes(out), sidecar


def _encode_fpl_device(data_dev, h, w, d, want_sidecar=False):
    """Device fpl lossless float encode: analysis + plane packing on
    device, per-plane 256-symbol tree builds and section assembly on host.
    Mirrors fpl_Lerc2Ext::EncodeHuffmanFlt's wire format
    (fpl_Lerc2Ext.cpp:405-430); predictor / delta-level / method choices
    may differ from the reference's sampling (any choice is decodable)."""
    n = h * w * d
    pred, levels_dev = device_fpl.fpl_choose_device(data_dev, h, w, d)
    pred = int(pred)  # static for the finalize variant (3 compiles max)
    histos, planes, pb_sizes = device_fpl.fpl_finalize_device(
        data_dev, levels_dev, h, w, d, pred
    )
    out, sidecar = _fpl_assemble(
        pred, np.asarray(levels_dev), np.asarray(histos).astype(np.int64),
        planes, np.asarray(pb_sizes), n, 4,
    )
    return (out, sidecar) if want_sidecar else out


def _encode_fpl_device_f64(data_np, h, w, d, want_sidecar=False):
    """Device fpl lossless DOUBLE encode: the u64 words run as (lo, hi)
    u32 limb pairs (split-field predictor with a borrow across the limb
    boundary, fpl_UnitTypes.cpp:119-155 semantics); 8 byte planes through
    the same analysis/pack machinery as f32."""
    n = h * w * d
    bits = np.ascontiguousarray(data_np, dtype=np.float64).reshape(-1).view(np.uint64)
    lo = jnp.asarray((bits & 0xFFFFFFFF).astype(np.uint32))
    hi = jnp.asarray((bits >> 32).astype(np.uint32))
    pred, levels_dev = device_fpl.fpl_choose_device_f64(lo, hi, h, w, d)
    pred = int(pred)
    histos, planes, pb_sizes = device_fpl.fpl_finalize_device_f64(
        lo, hi, levels_dev, h, w, d, pred
    )
    out, sidecar = _fpl_assemble(
        pred, np.asarray(levels_dev), np.asarray(histos).astype(np.int64),
        planes, np.asarray(pb_sizes), n, 8,
    )
    return (out, sidecar) if want_sidecar else out


def _decode_fpl_band_device(src, pos, head, sidecar):
    """Device fpl f32 decode via the encoder's per-plane Huffman group
    sidecar: Huffman planes decode with decode_stream_device (validated
    against the decoded code lengths), RLE-const/raw planes materialize
    directly, PackBits planes decode on host (serial byte protocol,
    bytes-cheap); restore cumsums, plane reassembly, split-field
    predictor undo and the float-transform undo all run on device
    (fpl_Lerc2Ext.cpp:738-866 semantics). Returns [H, W, D] f32 or None
    when the section needs the host path."""
    from . import fpl_impl

    h, w, d = head.n_rows, head.n_cols, head.n_depth
    n = h * w * d
    if n > (1 << 25):
        # the device restore cumsums split into 6-bit limbs that stay
        # exact only up to 2^25 elements per axis; larger rasters take
        # the host path instead of tripping the assert mid-decode
        return None
    unit_size = 8 if head.dt == DataType.DOUBLE else 4
    pred = src[pos]
    if pred > 2:
        raise ValueError("bad fpl predictor code")
    pos += 1
    planes = [None] * unit_size
    levels = [0] * unit_size
    for _ in range(unit_size):
        if head.blob_size - pos < 6:
            raise ValueError("truncated fpl plane header")
        byte_index = src[pos]
        best_level = src[pos + 1]
        if byte_index >= unit_size or best_level > 5:
            raise ValueError("corrupt fpl plane header")
        (csize,) = struct.unpack_from("<I", src, pos + 2)
        pos += 6
        if csize < 1 or head.blob_size - pos < csize:
            raise ValueError("truncated fpl plane payload")
        payload = src[pos : pos + csize]
        pos += csize
        levels[byte_index] = int(best_level)
        method = payload[0]
        if method == 1:  # RLE-const
            if csize < 6:  # mirror fpl_impl.extract_plane's length check
                raise ValueError("truncated RLE-const plane")
            if struct.unpack_from("<I", payload, 2)[0] != n:
                raise ValueError("RLE-const size mismatch")
            planes[byte_index] = jnp.full(n, payload[1], jnp.uint8)
        elif method == 2:  # raw
            planes[byte_index] = jnp.asarray(
                np.frombuffer(payload[1 : 1 + n], np.uint8))
        elif method == 3:  # PackBits: host decode
            planes[byte_index] = jnp.asarray(
                fpl_impl.decode_packbits(payload[1:], n))
        elif method == 0:  # Huffman via the group sidecar
            lengths, codes, used = huffman.read_code_table(payload[1:], 5)
            max_len = int(lengths.max(initial=0))
            # max_len > 30 overflows the int32 canonical consts: host path
            if max_len == 0 or max_len > 30:
                return None
            stream_np = np.frombuffer(payload[1 + used :], np.uint8)
            cap = -(-max(stream_np.size, 512) // 512) * 512
            sp = np.zeros(cap, np.uint8)
            sp[: stream_np.size] = stream_np
            sb = sidecar.get(int(byte_index)) if sidecar else None
            n_groups = -(-n // device_huffman.GROUP)
            if sb is None:
                # foreign blob: rebuild the plane's group offsets with the
                # native lengths-only scan (fpl planes are always full-n
                # unmasked symbol runs; masked fpl routes to host upstream)
                if not native.available():
                    return None
                counts = np.full(n_groups, device_huffman.GROUP, np.int32)
                counts[-1] = n - (n_groups - 1) * device_huffman.GROUP
                try:
                    sb = native.huffman_group_offsets(sp, lengths, codes,
                                                      counts)
                except ValueError:
                    return None  # corrupt stream: host raises its own error
            if np.asarray(sb).shape[0] != n_groups:
                return None
            consts, sorted_syms = device_huffman.canonical_decode_consts(
                lengths, codes)
            lanes = np.zeros((16, 16, 1), np.float32)
            lanes[:, :, 0] = sorted_syms.reshape(16, 16)
            syms, _used_bits, ok = device_huffman.decode_stream_device(
                jnp.asarray(sp.view(np.uint32)),
                jnp.asarray(np.asarray(sb, np.int32)),
                jnp.asarray(consts), jnp.asarray(lanes), n, max_len,
            )
            if not bool(ok):
                raise ValueError("fpl Huffman sidecar inconsistent with stream")
            planes[byte_index] = syms
        else:
            raise ValueError("unknown fpl plane method")
    if head.dt == DataType.DOUBLE:
        lo, hi = device_fpl.fpl_restore_device_f64(
            jnp.stack(planes), h, w, d, int(pred), tuple(levels)
        )
        bits = (np.asarray(lo).astype(np.uint64)
                | (np.asarray(hi).astype(np.uint64) << 32))
        return bits.view(np.float64).reshape(h, w, d)
    return device_fpl.fpl_restore_device(
        jnp.stack(planes), h, w, d, int(pred), tuple(levels)
    )


def _encode_huffman_device(data_dev, h, w, d, dt, version, mask_dev=None,
                           num_valid=None):
    """Device Huffman encode: returns (ImageEncodeMode, table + MSB-first
    stream bytes) or None. Mirrors the host BandEncoder._encode_huffman_int
    selection (Lerc2.cpp:2384-2468). With mask_dev, symbol streams are
    compacted to valid pixels (gaps emit zero bits in the packer)."""
    if mask_dev is None:
        direct, delta = device_huffman.symbol_streams_device(data_dev, h, w, d, dt)
        live_direct = live_delta = None
        gaps = 0
    else:
        direct, delta, _nv = device_huffman.symbol_streams_masked_device(
            data_dev, mask_dev, h, w, d, dt
        )
        n = h * w
        gaps = (n - num_valid) * d
        live_direct = jnp.asarray(np.arange(n * d) < num_valid * d)
        live_delta = jnp.asarray((np.arange(d * n) % n) < num_valid)
    histo = np.asarray(device_huffman.histogram256(direct)).astype(np.int64)
    dhisto = np.asarray(device_huffman.histogram256(delta)).astype(np.int64)
    if gaps:  # compacted gap positions hold symbol 0
        histo[0] -= gaps
        dhisto[0] -= gaps
        assert histo[0] >= 0 and dhisto[0] >= 0

    def size_of(hst):
        lengths = huffman.compute_code_lengths(hst)
        if lengths is None:
            return None, None
        nb = huffman.compute_compressed_size(hst, lengths)
        return (nb if nb > 0 else None), lengths

    nb0, len0 = size_of(histo) if version >= 4 else (None, None)
    nb1, len1 = size_of(dhisto)
    if nb0 is None and nb1 is None:
        return None
    if nb0 is not None and (nb1 is None or nb0 <= nb1):
        mode, lengths, syms, hst = ImageEncodeMode.HUFFMAN, len0, direct, histo
        live = live_direct
    else:
        mode, lengths, syms, hst = ImageEncodeMode.DELTA_HUFFMAN, len1, delta, dhisto
        live = live_delta
    codes = huffman.canonical_codes(lengths)
    table = huffman.write_code_table(lengths, codes, version)

    lens_codes = np.zeros((256, 5), np.float32)
    lens_codes[:, 0] = lengths
    for b in range(4):
        lens_codes[:, 1 + b] = (codes >> (8 * b)) & 0xFF
    total_bits = int((hst * lengths.astype(np.int64)).sum())
    stream_bytes = 4 * (-(-total_bits // 32) + 1)  # +1 read-ahead pad uint32
    max_len = int(lengths.max())
    pwh = next(p for p in (18, 34, 66) if p >= (device_huffman.GROUP * max_len + 31) // 32 + 1)
    cap = 1 << max(12, (stream_bytes + 512 - 1).bit_length())
    stream, tb, sbits = device_huffman.encode_stream_device(
        syms, jnp.asarray(lens_codes), cap, pwh, live=live
    )
    assert int(tb) == total_bits
    return mode, table + np.asarray(stream).tobytes()[:stream_bytes], sbits


def _scan_huffman_offsets(sp, lengths, codes, head, mode, mask, n, n_groups):
    """Per-group bit offsets of a FOREIGN Huffman stream via the native
    lengths-only scan. Returns an encoder-sidecar-shaped int32 array
    (n_groups entries; for masked layouts the groups past the live prefix
    keep the final offset) or None when the scan is unavailable/fails."""
    if not native.available():
        return None
    G = device_huffman.GROUP
    if mask is None:
        counts = np.full(n_groups, G, np.int32)
        counts[-1] = n - (n_groups - 1) * G
    else:
        h, w, d = head.n_rows, head.n_cols, head.n_depth
        npx = h * w
        # valid count from the DECODED mask, not the header: the host and
        # reference decoders size the symbol stream off the mask bits, and
        # a (corrupt) wire may disagree with numValidPixel -- trusting the
        # header here made the device path silently diverge on such blobs
        nv = int(np.count_nonzero(mask))
        if mode == ImageEncodeMode.DELTA_HUFFMAN and d > 1:
            # depth-major planes of npx rank slots, the first nv live
            p = np.arange(n_groups * G)
            live = ((p % npx) < nv) & (p < n)
            counts = live.reshape(n_groups, G).sum(axis=1).astype(np.int32)
        else:
            # one compacted run: nv*d (direct) or nv (delta, d == 1)
            n_eff = nv * d if mode != ImageEncodeMode.DELTA_HUFFMAN else nv
            g_eff = -(-n_eff // G)
            counts = np.zeros(n_groups, np.int32)
            counts[:g_eff] = G
            counts[g_eff - 1] = n_eff - (g_eff - 1) * G
    try:
        return native.huffman_group_offsets(sp, lengths, codes, counts)
    except ValueError:
        return None  # corrupt stream: the host path raises its own error


def _decode_huffman_band_device(src, pos, head, mode, sbits, mask=None):
    """Device-parallel whole-image Huffman decode (8-bit) via a per-group
    bit-offset sidecar. The code table is parsed from the WIRE (never
    trusted from the sidecar); the sidecar offsets are cross-checked on
    device against the decoded code lengths. Returns [H, W, D] or None
    when the table is unusable.

    sbits=None (FOREIGN blob, no encoder sidecar): the offsets are built
    by the native lengths-only scan (lerc_huffman_group_offsets, a
    multi-symbol-LUT pointer chase several times faster than full host
    decode) and the heavy symbol/un-delta work still runs device-parallel
    -- so plain decode() of a foreign 8-bit blob uses the device.

    With `mask` (numpy bool [H, W], from the wire mask section), symbols
    are rank-compacted (direct: one run; delta: per depth plane), so the
    live prefix decodes with a truncated sidecar (gap groups carry zero
    bits), un-delta runs in rank space (segment pointer doubling over the
    use_above links, Lerc2.cpp:2472-2606), and a stride-window expansion
    scatters ranks back to pixels."""
    from . import huffman as huff

    lengths, codes, used = huff.read_code_table(src[pos:], head.version)
    pos += used
    h, w, d = head.n_rows, head.n_cols, head.n_depth
    n = h * w * d
    max_len = int(lengths.max(initial=0))
    G = device_huffman.GROUP
    n_groups = -(-n // G)
    # max_len > 30 overflows the int32 canonical consts: host path
    if max_len == 0 or max_len > 30:
        return None
    stream_np = np.frombuffer(src[pos : head.blob_size], dtype=np.uint8)
    cap = -(-max(stream_np.size, 512) // 512) * 512
    sp = np.zeros(cap, np.uint8)
    sp[: stream_np.size] = stream_np
    if sbits is None:
        sbits = _scan_huffman_offsets(sp, lengths, codes, head, mode, mask,
                                      n, n_groups)
        if sbits is None:
            return None
    sbits = np.asarray(sbits, dtype=np.int32)
    if sbits.shape[0] != n_groups:
        return None
    consts, sorted_syms = device_huffman.canonical_decode_consts(lengths, codes)
    lanes = np.zeros((16, 16, 1), np.float32)
    lanes[:, :, 0] = sorted_syms.reshape(16, 16)
    stream_dev = jnp.asarray(sp.view(np.uint32))
    delta = mode == ImageEncodeMode.DELTA_HUFFMAN

    if mask is None:
        syms, _used_bits, ok = device_huffman.decode_stream_device(
            stream_dev, jnp.asarray(sbits),
            jnp.asarray(consts), jnp.asarray(lanes), n, max_len,
        )
        if not bool(ok):
            raise ValueError("Huffman sidecar inconsistent with stream")
        return device_huffman.symbols_to_image(syms, h, w, d, head.dt, delta=delta)

    # ---- masked route
    npx = h * w
    mflat = mask.reshape(npx)
    nv = int(np.count_nonzero(mask))  # mask-derived, as the host/reference
    G = device_huffman.GROUP
    if delta:
        # delta symbols are depth-major, nv live + (npx - nv) gaps per plane
        if d == 1:
            n_eff = nv
            g_eff = -(-n_eff // G)
            live = None
            sb_dec = sbits[:g_eff]
        else:
            n_eff = n
            # pad to the 64-symbol group grid (pad slots dead), matching
            # the scan's layout -- d*npx is rarely a GROUP multiple
            p = np.arange(-(-n // G) * G)
            live = jnp.asarray(((p % npx) < nv) & (p < n))
            sb_dec = sbits
    else:
        # direct symbols: one compacted run, depth inner
        n_eff = nv * d
        g_eff = -(-n_eff // G)
        live = None
        sb_dec = sbits[:g_eff]
    syms, _used_bits, ok = device_huffman.decode_stream_device(
        stream_dev, jnp.asarray(sb_dec),
        jnp.asarray(consts), jnp.asarray(lanes), n_eff, max_len, live=live,
    )
    if not bool(ok):
        raise ValueError("Huffman sidecar inconsistent with stream")

    offset = 128 if head.dt == DataType.CHAR else 0
    cap_r = -(-max(nv, 1) // device_huffman.GROUP) * device_huffman.GROUP
    mask_dev = jnp.asarray(mflat)
    if delta:
        # [d, nv] per-plane deltas (gap tails dropped by the static slice)
        if d == 1:
            deltas = (syms[:nv].astype(jnp.int32) - offset)[None, :]
        else:
            deltas = syms.reshape(d, npx)[:, :nv].astype(jnp.int32) - offset
        seg_b, seg_t, seg_par = _masked_delta_segments(mask)
        if seg_b.shape[0] > (1 << 16):
            return None  # pathological mask (checkerboard-like): host path
        m_cap = 1 << max(4, (seg_b.shape[0] - 1).bit_length())
        pad = m_cap - seg_b.shape[0]
        seg_b = np.concatenate([seg_b, np.full(pad, nv, np.int32)])
        seg_t = np.concatenate([seg_t, np.zeros(pad, np.int32)])
        seg_par = np.concatenate([seg_par, np.zeros(pad, np.int32)])
        vals = device_huffman.undelta_masked_device(
            deltas, jnp.asarray(seg_b), jnp.asarray(seg_t),
            jnp.asarray(seg_par), nv, d, m_cap,
        )  # [d, nv] in [0, 256)
        planes = []
        for k in range(d):
            comp = jnp.zeros(cap_r, jnp.uint32).at[:nv].set(
                vals[k].astype(jnp.uint32))
            planes.append(device_huffman.expand_compacted_device(
                comp, mask_dev, npx))
        img = jnp.stack(planes, axis=1).reshape(h, w, d)
    else:
        vals = syms.reshape(nv, d)
        planes = []
        for k in range(d):
            vk = ((vals[:, k].astype(jnp.int32) - offset) & 0xFF).astype(jnp.uint32)
            comp = jnp.zeros(cap_r, jnp.uint32).at[:nv].set(vk)
            planes.append(device_huffman.expand_compacted_device(
                comp, mask_dev, npx))
        img = jnp.stack(planes, axis=1).reshape(h, w, d)
    if head.dt == DataType.CHAR:
        return img.astype(jnp.uint8).astype(jnp.int8)
    return img.astype(jnp.uint8)


def _masked_delta_segments(mask: np.ndarray):
    """Host-side segment structure of the masked delta tree (numpy, from
    the wire mask): returns (seg_b, seg_t, seg_par) int32 arrays of length
    m + 1 where entry 0 is the rank-0 root segment and entry k >= 1 is the
    k-th use_above pixel in scan order -- seg_b its rank, seg_t the rank
    of the pixel above it, seg_par the segment containing that target."""
    h, w = mask.shape
    n = h * w
    m = mask.reshape(n)
    rank = np.cumsum(m).astype(np.int32) - 1  # rank of each valid pixel
    left_ok = np.zeros((h, w), bool)
    left_ok[:, 1:] = mask[:, 1:] & mask[:, :-1]
    above_ok = np.zeros((h, w), bool)
    above_ok[1:, :] = mask[1:, :] & mask[:-1, :]
    use_above = (~left_ok.reshape(n)) & above_ok.reshape(n) & m
    idx = np.nonzero(use_above)[0]
    seg_b = np.concatenate([[0], rank[idx]]).astype(np.int32)
    seg_t = np.concatenate([[0], rank[idx - w]]).astype(np.int32)
    # segment id of every rank: 0 before the first use_above pixel
    seg_of_rank = np.zeros(max(int(m.sum()), 1), np.int32)
    seg_of_rank[rank[idx]] = 1
    seg_of_rank = np.cumsum(seg_of_rank).astype(np.int32)
    seg_par = np.concatenate([[0], seg_of_rank[seg_t[1:]]]).astype(np.int32)
    return seg_b, seg_t, seg_par


_DBL_MIN = 2.2250738585072014e-308


def _decode_f64_tiles_device(stream_np, recs, mask, head, zmax_src,
                             has_lut, h, w, d):
    """Lossy float64 tiling decode via the exact softfloat dequant
    (device_softf64: z = zMin + q * invScale then std::min(z, zMax),
    bit-for-bit the reference's Lerc2.h ScaleBack). Returns the [H, W, D]
    float64 image, or None when the inputs leave the softfloat's
    normal-range contract (subnormal/inf/nan offsets or clamps, extreme
    invScale, or a dequantized sum that underflows) -- the caller then
    takes the exact host path."""
    from ..ops import device_softf64 as sf

    dec = sf.decompose_scalar(2.0 * head.max_z_error)
    if dec is None:
        return None
    inv_limbs, inv_bexp = dec
    offs = recs["offset"]
    used = np.isin(recs["mode"] % 8, (1, 3, 4))
    offs_used = offs[used]
    if not (np.isfinite(offs_used).all()
            and ((offs_used == 0) | (np.abs(offs_used) >= _DBL_MIN)).all()):
        return None
    zmax = np.asarray(zmax_src, np.float64)
    if not np.isfinite(zmax).all():
        return None
    off_bits = offs.view(np.uint64)
    zmax_bits = zmax.view(np.uint64)

    img_hi, img_lo, ok = device_decode.decode_tiles_f64(
        jnp.asarray(stream_np),
        jnp.asarray(recs["mode"]),
        jnp.asarray(recs["payload_pos"].astype(np.int32)),
        jnp.asarray((off_bits >> 32).astype(np.uint32)),
        jnp.asarray((off_bits & 0xFFFFFFFF).astype(np.uint32)),
        jnp.asarray(recs["num_bits"]),
        jnp.asarray(recs["num_elements"]),
        jnp.asarray(recs["lut_pos"].astype(np.int32)),
        jnp.asarray(recs["nbits_lut"]),
        jnp.asarray(mask),
        jnp.asarray((zmax_bits >> 32).astype(np.uint32)),
        jnp.asarray((zmax_bits & 0xFFFFFFFF).astype(np.uint32)),
        inv_limbs, inv_bexp,
        h, w, d, bool(mask.all()), has_lut,
    )
    if not bool(np.asarray(ok)):
        return None
    bits = (np.asarray(img_hi).astype(np.uint64) << 32) | np.asarray(img_lo)
    return bits.view(np.float64)


@profiling.profiled("device.decode_band")
def decode_band_device(
    buf: bytes | memoryview,
    prev_mask: np.ndarray | None = None,
    verify_checksum: bool = True,
    index: dict | None = None,
    return_device: bool = False,
):
    """Decode a single band using the native scanner + device kernels.
    Returns DecodedBand or None if this blob needs the host path.

    index: optional acceleration metadata from encode_band_device
    (return_index=True). "huffman_sbits" (per-64-symbol-group bit
    offsets) enables device-parallel Huffman decode of 8-bit whole-image
    blobs; the sidecar is validated against the decoded code lengths, so
    a stale/tampered index raises instead of decoding garbage. Foreign
    blobs (no sidecar) rebuild the offsets with the native lengths-only
    scan, for whole-image Huffman and for fpl planes alike.

    return_device: leave ``out.data`` as the device array instead of
    fetching it to host numpy (const-fill / empty-mask blobs still return
    host arrays). Lets callers overlap or skip the raster egress, and
    lets the benchmark report a device-only throughput separate from the
    host-transfer-bound end-to-end figure."""
    if not native.available():
        return None
    src = memoryview(buf)
    try:
        head, pos = hdr.read_header(src)
    except ValueError:
        return None
    if head.micro_block_size != 8:
        return None
    if head.version < 3:
        # v2 bit-stuffs with the pre-v3 tail layout, which the device
        # extraction does not implement: host path
        return None
    if (head.dt == DataType.DOUBLE and head.max_z_error == 0
            and not head.try_huffman_flt()):
        # lossless f64 on a pre-fpl wire version: host path. (v6 fpl blobs
        # proceed: the per-plane offsets come from the encoder sidecar or,
        # for foreign blobs, the native lengths-only scan. Lossy f64
        # tiling takes the exact softfloat dequant route below.)
        return None
    h, w, d = head.n_rows, head.n_cols, head.n_depth
    np_dt = DT_TO_NUMPY[head.dt]

    if head.version >= 3 and verify_checksum:
        skip = hdr.checksum_skip(head.version)
        if fletcher32.fletcher32(src[skip : head.blob_size]) != head.checksum:
            raise ValueError("Lerc2 checksum mismatch")

    num_bytes_mask = int.from_bytes(src[pos : pos + 4], "little", signed=True)
    pos += 4
    num_total = h * w
    if head.num_valid_pixel == 0:
        mask = np.zeros((h, w), dtype=bool)
    elif head.num_valid_pixel == num_total:
        mask = np.ones((h, w), dtype=bool)
    elif num_bytes_mask > 0:
        nb = mask_size_bytes(w, h)
        bits = native.rle_decompress(
            np.frombuffer(src[pos : pos + num_bytes_mask], np.uint8), nb
        )
        mask = bits_to_bool(bits, w, h)
        pos += num_bytes_mask
    else:
        if prev_mask is None:
            return None
        mask = prev_mask.copy()

    out = DecodedBand(head, mask, np.zeros((h, w, d), dtype=np_dt), None, None, head.blob_size)
    if head.num_valid_pixel == 0:
        return out
    if head.z_min == head.z_max:
        from .lerc2_decode import _fill_const

        _fill_const(out)
        return out
    if head.version >= 4:
        nb = d * DT_SIZE[head.dt]
        out.z_min_vec = np.frombuffer(src[pos : pos + nb], dtype=np_dt).astype(np.float64)
        pos += nb
        out.z_max_vec = np.frombuffer(src[pos : pos + nb], dtype=np_dt).astype(np.float64)
        pos += nb
        if np.array_equal(out.z_min_vec, out.z_max_vec):
            from .lerc2_decode import _fill_const

            _fill_const(out)
            return out

    one_sweep = src[pos]
    pos += 1
    if one_sweep:
        return None  # host path handles
    if head.try_huffman_int() or head.try_huffman_flt():
        flag = src[pos]
        pos += 1
        if flag != 0:
            if head.try_huffman_int() and flag in (1, 2):
                # encoder sidecar when present; foreign blobs get their
                # offsets from the native lengths-only scan (sbits=None)
                sbits = index.get("huffman_sbits") if index is not None else None
                img = _decode_huffman_band_device(
                    src, pos, head, ImageEncodeMode(flag), sbits,
                    mask=None if head.num_valid_pixel == h * w else mask,
                )
                if img is not None:
                    out.data = img if return_device else np.asarray(img)
                    return out
            if head.try_huffman_flt() and flag == 3:
                # encoder sidecar when present; foreign blobs rebuild the
                # per-plane offsets via the native lengths-only scan. fpl is
                # mask-oblivious (the reference passes the full raster,
                # Lerc2.cpp:305-311): all pixels ride the wire, so masked
                # blobs take the identical pipeline
                fpl_sb = index.get("fpl_sbits") if index is not None else None
                img = _decode_fpl_band_device(src, pos, head, fpl_sb)
                if img is not None:
                    out.data = img if return_device else np.asarray(img)
                    return out
            return None  # huffman / fpl / masked-huffman -> host path

    # native record scan over the tile stream
    nbv, nbh = -(-h // 8), -(-w // 8)
    n_blocks = nbv * nbh
    padded = np.zeros((nbv * 8, nbh * 8), dtype=bool)
    padded[:h, :w] = mask
    vb = padded.reshape(nbv, 8, nbh, 8).transpose(0, 2, 1, 3).reshape(n_blocks, 64)
    cnts = vb.sum(axis=1).astype(np.int32)
    j0s = ((np.arange(n_blocks, dtype=np.int32) % nbh) * 8).astype(np.int32)
    stream_np = np.frombuffer(src[pos : head.blob_size], dtype=np.uint8)
    recs, used = native.tile_scan(stream_np, cnts, j0s, n_blocks, d, int(head.dt), head.version)
    has_diff = bool((recs["mode"] >= 8).any())
    has_lut = bool((recs["mode"] % 8 == 4).any())

    zmax_src = out.z_max_vec if out.z_max_vec is not None else np.full(d, head.z_max)
    if head.dt == DataType.DOUBLE:
        # depth-diff included (r4): the f64 tile decoder resolves the
        # slice chain with softfloat adds in a lax.scan
        img = _decode_f64_tiles_device(stream_np, recs, mask, head, zmax_src,
                                       has_lut, h, w, d)
        if img is None:
            return None  # outside the softfloat's normal-range contract
        out.data = img
        return out
    inv_limbs, inv_bexp = None, 0
    if dt_is_int(head.dt):
        z_max_vec = np.round(zmax_src).astype(np.int32)
        offsets = recs["offset"].astype(np.int32)  # exact: int offsets fit f64
    else:
        z_max_vec = zmax_src.astype(np.float32)
        offsets = recs["offset"].astype(np.float32)
        # Bit-exact f32 ScaleBack (Lerc2.h:381-399 runs in double): decompose
        # invScale for the softfloat kernels. mze == 0 stays on the plain f32
        # path (invScale 0 makes it exact already); a nonzero invScale the
        # decomposition rejects (subnormal/inf/nan -- hostile headers only)
        # or non-finite offsets/clamps (add_f64's precondition) -> host path.
        if head.max_z_error != 0:
            dec = softf64.decompose_scalar(2.0 * head.max_z_error)
            if dec is None:
                return None
            inv_limbs, inv_bexp = dec
            m8_np = recs["mode"] % 8
            # stuff/LUT offsets feed add_f64 directly; const-offset ones
            # feed the depth-diff chain's adds -- all must be finite
            # (raw records carry unset offsets and are gated out)
            uses_off = (m8_np == 1) | (m8_np == 4) | (m8_np == 3)
            if not (np.isfinite(offsets[uses_off]).all()
                    and np.isfinite(z_max_vec).all()):
                return None

    img, sf_ok = device_decode.decode_tiles(
        jnp.asarray(stream_np),
        jnp.asarray(recs["mode"]),
        jnp.asarray(recs["payload_pos"].astype(np.int32)),
        jnp.asarray(offsets),
        jnp.asarray(recs["num_bits"]),
        jnp.asarray(recs["num_elements"]),
        jnp.asarray(recs["lut_pos"].astype(np.int32)),
        jnp.asarray(recs["n_lut"]),
        jnp.asarray(recs["nbits_lut"]),
        jnp.asarray(mask),
        jnp.float32(head.max_z_error),
        jnp.asarray(z_max_vec),
        h, w, d, head.dt, bool(mask.all()), has_lut,
        inv_limbs=inv_limbs, inv_bexp=inv_bexp,
    )
    if inv_limbs is not None and not bool(np.asarray(sf_ok)):
        return None  # sum left the normal-f64 range: host decoder
    out.data = img if return_device else np.asarray(img)
    return out
