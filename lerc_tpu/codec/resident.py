"""Device-resident codec: blobs live in HBM end to end.

For production accelerator pipelines the raster usually originates on device (model
output, ingest shard) and the blob is consumed on device or streamed out
asynchronously. This wrapper keeps everything resident: encode produces
(header bytes ~100B on host, payload stream in HBM, checksum computed on
device); decode parses the tiny header on host and runs the pointer-doubling
record scan + unpack pipeline entirely on device.

Currently covers the hot bench configuration: all-valid rasters, micro
block 8, modes raw/const/stuff (the device encoder's output), float32 and
int dtypes. Masked/Huffman/fpl blobs route through the standard paths.
"""
from __future__ import annotations

import dataclasses
import struct

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import DataType, DT_SIZE, DT_TO_NUMPY, NUMPY_TO_DT, dt_is_int
from ..ops import device_decode, device_encode, device_scan
from . import header as hdr


@dataclasses.dataclass
class ResidentBlob:
    header: bytes          # header + mask + ranges + flag bytes (host)
    stream: jax.Array      # [cap/4] u32 payload words in HBM (zero past total)
    total: int
    checksum: int
    hd: hdr.HeaderInfo
    starts: jax.Array | None = None  # [nRec] record-offset index (HBM)

    def to_bytes(self) -> bytes:
        """Materialize the standard Lerc2 blob on host (the stream may be
        u8 bytes or u32 words; both serialize to the same LE bytes)."""
        return self.header + np.asarray(self.stream).tobytes()[: self.total]


class ResidentCodec:
    def __init__(self, h: int, w: int, d: int = 1, dtype=np.float32,
                 max_z_error: float = 0.001, version: int = 6,
                 nb_cap: int = 0, mask: np.ndarray | None = None,
                 exact_f32: bool = True):
        self.h, self.w, self.d = h, w, d
        # nb_cap <= 16 selects the cheaper byte-aligned grouped kernels,
        # sized for packed widths <= nb_cap; blocks needing more trigger a
        # transparent re-encode/decode on the uncapped variant (the `fits`
        # flag from the device kernels).
        self.nb_cap = int(nb_cap)
        self.dt = NUMPY_TO_DT[np.dtype(dtype)]
        self.np_dtype = np.dtype(dtype)
        self.version = version
        self.mze = float(max_z_error)
        if dt_is_int(self.dt):
            self.mze = max(0.5, np.floor(self.mze))
        if h % 8 or w % 8:
            raise ValueError("resident codec requires H, W multiples of 8")
        n_rec = (h // 8) * (w // 8) * d
        self.n_rec = n_rec
        raw = h * w * DT_SIZE[self.dt] * d + n_rec * 12 + 4096
        self.cap = -(-raw // 1024) * 1024  # exact bound; all per-byte work is O(cap)
        self.cap_full = self.cap  # uncapped-fallback capacity
        if self.nb_cap:
            # under a bit-width cap raw records are impossible (they flip
            # the fits flag), so the worst record is the capped stuff
            # record: flag + 4B offset + numBits + count + bs*nb_cap/8
            # payload. A tight capacity halves every O(cap) pass
            # (fletcher32, window materialization, assembly combine).
            per_rec = 1 + 4 + 1 + 2 + (64 * min(self.nb_cap, 8 * DT_SIZE[self.dt]) + 7) // 8
            tight = n_rec * per_rec + 4096
            self.cap = min(self.cap, -(-tight // 1024) * 1024)
        self._ones = jnp.ones((h, w), bool)
        if mask is not None:
            self.mask_np = np.ascontiguousarray(mask, dtype=bool)
            if self.mask_np.shape != (h, w):
                raise ValueError("mask shape mismatch")
            self.num_valid = int(self.mask_np.sum())
            if not 0 < self.num_valid:
                raise ValueError("resident codec requires >= 1 valid pixel")
            self._mask_dev = jnp.asarray(self.mask_np)
            if self.num_valid < h * w:
                from .. import native
                from . import rle
                from .bitmask import bool_to_bits

                bits = bool_to_bits(self.mask_np)
                mask_rle = (native.rle_compress(bits) if native.available()
                            else rle.compress(bits))
                self._mask_section = struct.pack("<i", len(mask_rle)) + mask_rle
            else:  # fully-valid mask: same wire as no mask
                self._mask_dev = None
                self.mask_np = None
                self._mask_section = struct.pack("<i", 0)
        else:
            self.mask_np = None
            self._mask_dev = None
            self.num_valid = h * w
            self._mask_section = struct.pack("<i", 0)
        self._try_huffman = hdr.HeaderInfo(
            version=version, dt=self.dt, max_z_error=self.mze
        ).try_huffman_int() or hdr.HeaderInfo(
            version=version, dt=self.dt, max_z_error=self.mze
        ).try_huffman_flt()
        # Bit-exact f32 dequant (double ScaleBack via softfloat): decompose
        # invScale once. None (mze 0, or a non-normal 2*mze, or the
        # exact_f32=False speed opt-out -- worth ~10% of decode throughput,
        # <= 1 ulp deviation, still within the maxZError bound) keeps the
        # plain f32 dequant.
        self._inv_dec = None
        if exact_f32 and not dt_is_int(self.dt) and self.mze != 0:
            from ..ops import device_softf64 as _sf

            self._inv_dec = _sf.decompose_scalar(2.0 * self.mze)

    def _exact_kw(self, dt: DataType) -> dict:
        """kwargs enabling the bit-exact f32 softfloat dequant in the
        device decode kernels ({} when inapplicable)."""
        if self._inv_dec is None or dt != DataType.FLOAT:
            return {}
        return {"inv_limbs": self._inv_dec[0], "inv_bexp": self._inv_dec[1]}

    # ---- encode -----------------------------------------------------------

    def encode(self, data_dev: jax.Array) -> ResidentBlob:
        all_valid = self._mask_dev is None
        mask_arg = self._ones if all_valid else self._mask_dev
        stream, total, zmin_vec, zmax_vec, starts, fits = device_encode.encode_tiles(
            data_dev, mask_arg, jnp.float32(self.mze),
            self.h, self.w, self.d, self.dt, all_valid, self.version, self.cap,
            nb_cap=self.nb_cap, out_u32=True,
        )
        if self.nb_cap and not bool(fits):
            stream, total, zmin_vec, zmax_vec, starts, fits = device_encode.encode_tiles(
                data_dev, mask_arg, jnp.float32(self.mze),
                self.h, self.w, self.d, self.dt, all_valid, self.version,
                self.cap_full, out_u32=True,
            )
        total_i = int(total)
        zmin_vec = np.asarray(zmin_vec, dtype=np.float64)
        zmax_vec = np.asarray(zmax_vec, dtype=np.float64)
        head = hdr.HeaderInfo(
            version=self.version, n_rows=self.h, n_cols=self.w, n_depth=self.d,
            num_valid_pixel=self.num_valid, micro_block_size=8, dt=self.dt,
            max_z_error=self.mze, z_min=float(zmin_vec.min()), z_max=float(zmax_vec.max()),
        )
        np_dt = DT_TO_NUMPY[self.dt]
        mask_section = self._mask_section
        ranges = b""
        flags = b""
        if head.z_min != head.z_max:
            if self.version >= 4:
                ranges = zmin_vec.astype(np_dt).tobytes() + zmax_vec.astype(np_dt).tobytes()
            flags = b"\x00" + (b"\x00" if self._try_huffman else b"")
        else:
            total_i = 0  # const image: no payload section
        head.blob_size = (
            hdr.header_size(self.version) + len(mask_section) + len(ranges)
            + len(flags) + total_i
        )
        header_bytes = bytearray(hdr.write_header(head))
        header_bytes += mask_section + ranges + flags
        skip = hdr.checksum_skip(self.version)
        prefix = np.frombuffer(bytes(header_bytes[skip:]), dtype=np.uint8)
        checksum = int(device_scan.fletcher32_device(
            jnp.asarray(prefix), stream, jnp.int32(total_i)
        ))
        struct.pack_into("<I", header_bytes, skip - 4, checksum)
        head.checksum = checksum
        return ResidentBlob(bytes(header_bytes), stream, total_i, checksum, head, starts)

    # ---- decode -----------------------------------------------------------

    def decode(self, blob: ResidentBlob, verify_checksum: bool = True) -> jax.Array:
        """Device-resident decode. Returns [H, W, D] in the native dtype."""
        head, pos = hdr.read_header(blob.header)
        if verify_checksum:
            skip = hdr.checksum_skip(head.version)
            prefix = np.frombuffer(blob.header[skip:], dtype=np.uint8)
            computed = int(device_scan.fletcher32_device(
                jnp.asarray(prefix), blob.stream, jnp.int32(blob.total)
            ))
            if computed != head.checksum:
                raise ValueError("Lerc2 checksum mismatch")
        # parse the tiny host sections
        mlen = struct.unpack_from("<i", blob.header, pos)[0]
        pos += 4 + max(mlen, 0)  # mask section (0: all valid / reuse)
        np_dt = DT_TO_NUMPY[head.dt]
        d = head.n_depth
        if head.z_min == head.z_max:
            return jnp.full((head.n_rows, head.n_cols, d), np_dt(head.z_min))
        z_max_vec = np.full(d, head.z_max)
        if head.version >= 4:
            nb = d * DT_SIZE[head.dt]
            pos += nb
            z_max_vec = np.frombuffer(blob.header[pos : pos + nb], dtype=np_dt).astype(np.float64)
            pos += nb

        if dt_is_int(head.dt):
            zmax_arg = jnp.asarray(np.round(z_max_vec).astype(np.int32))
        else:
            zmax_arg = jnp.asarray(z_max_vec.astype(np.float32))
        if blob.starts is None and self._mask_dev is not None:
            # no index: masked record sizes are non-uniform, so the device
            # exclusive-scan cannot resolve them. Fall back to the native
            # host scanner (one stream download), then decode on device --
            # same wiring as decode_band_device for foreign masked blobs.
            return self._decode_masked_scan(blob, zmax_arg)
        if blob.starts is not None:
            # scan-free path: the encoder's record-offset index. nb_cap
            # sizes the extraction for narrow packed widths (pw 33 vs 65);
            # unfit records fall back to the full-width kernel.
            inv_kw = self._exact_kw(head.dt)
            img, index_ok, fits = device_decode.decode_tiles_fast(
                blob.stream, blob.starts, jnp.float32(head.max_z_error),
                zmax_arg, head.n_rows, head.n_cols, d, head.dt, head.version,
                nb_cap=self.nb_cap, mask=self._mask_dev, **inv_kw,
            )
            if self.nb_cap and not bool(fits):
                # nb_cap too narrow: retry uncapped (still exact)
                img, index_ok, fits = device_decode.decode_tiles_fast(
                    blob.stream, blob.starts, jnp.float32(head.max_z_error),
                    zmax_arg, head.n_rows, head.n_cols, d, head.dt, head.version,
                    mask=self._mask_dev, **inv_kw,
                )
            if inv_kw and not bool(fits):
                # (rare) a softfloat sum left the normal-f64 range: f32
                # dequant fallback (still within the maxZError spec)
                img, index_ok, fits = device_decode.decode_tiles_fast(
                    blob.stream, blob.starts, jnp.float32(head.max_z_error),
                    zmax_arg, head.n_rows, head.n_cols, d, head.dt, head.version,
                    mask=self._mask_dev,
                )
            if not bool(index_ok):
                raise ValueError("record-offset index inconsistent with stream")
            return img
        stream8 = blob.stream
        if stream8.dtype == jnp.uint32:  # scan path works on bytes
            stream8 = jax.lax.bitcast_convert_type(
                stream8[:, None], jnp.uint8).reshape(-1)
        (rp, mode, offset, r_nb, r_ne, payload_pos, lut_pos, r_nlut, r_nbits_lut) = (
            device_scan.scan_records_device(
                stream8, self.n_rec, head.dt, head.version, 64
            )
        )
        all_valid = self._mask_dev is None
        img, sf_ok = device_decode.decode_tiles(
            stream8, mode, payload_pos, offset, r_nb, r_ne,
            lut_pos, r_nlut, r_nbits_lut,
            self._ones if all_valid else self._mask_dev,
            jnp.float32(head.max_z_error), zmax_arg,
            head.n_rows, head.n_cols, d, head.dt, all_valid, False,
            **self._exact_kw(head.dt),
        )
        if not bool(sf_ok):  # rare softfloat range trip: f32 dequant
            img, _ = device_decode.decode_tiles(
                stream8, mode, payload_pos, offset, r_nb, r_ne,
                lut_pos, r_nlut, r_nbits_lut,
                self._ones if all_valid else self._mask_dev,
                jnp.float32(head.max_z_error), zmax_arg,
                head.n_rows, head.n_cols, d, head.dt, all_valid, False,
            )
        return img

    def _decode_masked_scan(self, blob: ResidentBlob, zmax_arg) -> jax.Array:
        """Masked decode without the record-offset index: native host scan
        of the tile stream (per-record sizes depend on per-block valid
        counts), then the standard device tile decode."""
        from .. import native

        if not native.available():
            raise ValueError(
                "masked resident decode needs the record-offset index or "
                "the native scanner"
            )
        head = blob.hd
        d = head.n_depth
        stream_np = np.asarray(blob.stream).view(np.uint8)[: blob.total]
        nbv, nbh = self.h // 8, self.w // 8
        n_blocks = nbv * nbh
        vb = self.mask_np.reshape(nbv, 8, nbh, 8).transpose(0, 2, 1, 3)
        cnts = vb.reshape(n_blocks, 64).sum(axis=1).astype(np.int32)
        j0s = ((np.arange(n_blocks, dtype=np.int32) % nbh) * 8).astype(np.int32)
        recs, _ = native.tile_scan(
            stream_np, cnts, j0s, n_blocks, d, int(head.dt), head.version
        )
        if (recs["mode"] >= 8).any():
            raise ValueError("depth-diff records: host decode required")
        if dt_is_int(head.dt):
            offsets = recs["offset"].astype(np.int32)
        else:
            offsets = recs["offset"].astype(np.float32)
        args = (
            jnp.asarray(stream_np),
            jnp.asarray(recs["mode"]),
            jnp.asarray(recs["payload_pos"].astype(np.int32)),
            jnp.asarray(offsets),
            jnp.asarray(recs["num_bits"]),
            jnp.asarray(recs["num_elements"]),
            jnp.asarray(recs["lut_pos"].astype(np.int32)),
            jnp.asarray(recs["n_lut"]),
            jnp.asarray(recs["nbits_lut"]),
            self._mask_dev,
            jnp.float32(head.max_z_error), zmax_arg,
            head.n_rows, head.n_cols, d, head.dt, False,
            bool((recs["mode"] == 4).any()),
        )
        img, sf_ok = device_decode.decode_tiles(*args, **self._exact_kw(head.dt))
        if not bool(sf_ok):  # rare softfloat range trip: f32 dequant
            img, _ = device_decode.decode_tiles(*args)
        return img


# ---------------------------------------------------------------------------
# Fully-fused resident pipeline: one jitted call per phase, zero per-round
# host transfers.
# The blob header is built ON DEVICE, including the f64 header fields
# (f32->f64 bit composition) and the Fletcher32 checksum.
# ---------------------------------------------------------------------------


class FusedResidentCodec(ResidentCodec):
    """ResidentCodec whose encode/decode are single jitted calls returning
    device arrays only. Header layout is v6, all-valid, d depth slices."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.version < 4:
            raise ValueError("fused resident codec requires version >= 4")
        # static header template with dynamic fields zeroed
        head = hdr.HeaderInfo(
            version=self.version, n_rows=self.h, n_cols=self.w, n_depth=self.d,
            num_valid_pixel=self.num_valid, micro_block_size=8, dt=self.dt,
            max_z_error=self.mze,
        )
        head_bytes = hdr.write_header(head)
        head_len = len(head_bytes)  # 90 for v6 (always even)
        # The RLE'd mask section is STATIC per codec and can be huge (a
        # speckled 2048^2 mask RLEs to ~290 KB); carrying it through the
        # per-call jit as a u8 template costs byte-granular
        # dynamic_update_slice copies and fletcher byte slicing.
        # Split it out: the device program only builds the SMALL dynamic
        # header (fixed head + ranges + flags, ~100 B), the mask section's
        # Fletcher32 contribution folds in algebraically as two constants
        # (device_scan.fletcher32_partials), and blob_to_bytes splices the
        # section back for the wire. An odd trailing mask byte moves into
        # the dynamic tail so the static piece stays word-aligned.
        mask_sec = bytes(self._mask_section)
        odd = len(mask_sec) % 2
        static_even = mask_sec[: len(mask_sec) - odd]
        carry = mask_sec[len(mask_sec) - odd:]
        self._static_mid = static_even
        self._static_ab = device_scan.fletcher32_partials(
            static_even, (head_len - hdr.checksum_skip(self.version)) // 2)
        self._static_len = len(static_even)

        template = bytearray(head_bytes)
        template += carry
        self._ranges_off = len(template)
        np_dt = DT_TO_NUMPY[self.dt]
        template += b"\x00" * (2 * self.d * DT_SIZE[self.dt])  # ranges
        template += b"\x00"  # one-sweep flag
        if self._try_huffman:
            template += b"\x00"  # image encode mode: tiling
        self._template = np.frombuffer(bytes(template), dtype=np.uint8)
        self._hdr_small_len = len(template)
        self._head_len = head_len
        # full on-wire header length (blobSize arithmetic / bench sizes)
        self._hdr_len = len(template) + len(static_even)
        self._blob_size_off = len(hdr.FILE_KEY_LERC2) + 4 + 4 + 5 * 4
        self._zmin_off = len(hdr.FILE_KEY_LERC2) + 4 + 4 + 8 * 4 + 4 + 8
        self._skip = hdr.checksum_skip(self.version)

        h_, w_, d_, cap, dt_, ver, mze = (
            self.h, self.w, self.d, self.cap, self.dt, self.version, self.mze
        )
        hdr_len, skip = self._hdr_len, self._skip
        head_len = self._head_len
        static_ab = (self._static_ab[0], self._static_ab[1], self._static_len)
        tmpl = jnp.asarray(self._template)
        ranges_off, zmin_off, bs_off = self._ranges_off, self._zmin_off, self._blob_size_off
        n_rec = self.n_rec
        ones = self._ones
        mask_dev = self._mask_dev
        all_valid = mask_dev is None
        mask_arr = ones if all_valid else mask_dev
        is_int = dt_is_int(dt_)

        def _u32_bytes(word):
            return jnp.stack([(word >> jnp.uint32(8 * i)) & 0xFF for i in range(4)]).astype(jnp.uint8)

        nb_cap = self.nb_cap

        @jax.jit
        def encode_fused(data_dev):
            stream, total, zminv, zmaxv, starts, fits = device_encode.encode_tiles(
                data_dev, mask_arr, jnp.float32(mze), h_, w_, d_, dt_, all_valid,
                ver, cap, nb_cap=nb_cap, out_u32=True,
            )
            header = tmpl
            # blobSize
            blob_size = (hdr_len + total).astype(jnp.uint32)
            header = jax.lax.dynamic_update_slice(header, _u32_bytes(blob_size), (bs_off,))
            # zMin/zMax f64 fields
            zmin_f = zminv.astype(jnp.float32).min()
            zmax_f = zmaxv.astype(jnp.float32).max()
            lo1, hi1 = device_scan.f32_to_f64_bits(zmin_f)
            lo2, hi2 = device_scan.f32_to_f64_bits(zmax_f)
            header = jax.lax.dynamic_update_slice(header, _u32_bytes(lo1), (zmin_off,))
            header = jax.lax.dynamic_update_slice(header, _u32_bytes(hi1), (zmin_off + 4,))
            header = jax.lax.dynamic_update_slice(header, _u32_bytes(lo2), (zmin_off + 8,))
            header = jax.lax.dynamic_update_slice(header, _u32_bytes(hi2), (zmin_off + 12,))
            # ranges section (native dtype lanes)
            if is_int:
                rvals = jnp.concatenate([zminv, zmaxv]).astype(jnp.int32)
            else:
                rvals = jnp.concatenate([zminv, zmaxv]).astype(jnp.float32)
            rbytes = jax.lax.bitcast_convert_type(
                rvals, jnp.uint8
            ).reshape(-1) if DT_SIZE[dt_] == 4 else None
            if DT_SIZE[dt_] == 4:
                header = jax.lax.dynamic_update_slice(header, rbytes, (ranges_off,))
            else:  # 1/2-byte int dtypes: pack low lanes
                width = DT_SIZE[dt_]
                lanes = [((rvals.astype(jnp.int32).astype(jnp.uint32) >> jnp.uint32(8 * i)) & 0xFF).astype(jnp.uint8) for i in range(width)]
                rbytes = jnp.stack(lanes, axis=1).reshape(-1)
                header = jax.lax.dynamic_update_slice(header, rbytes, (ranges_off,))
            # checksum over head[skip:] || STATIC mask section (folded
            # partials) || tail (carry+ranges+flags) || stream[:total]
            checksum = device_scan.fletcher32_device_parts(
                header[skip:head_len], static_ab, header[head_len:],
                stream, total)
            header = jax.lax.dynamic_update_slice(
                header, _u32_bytes(checksum), (skip - 4,)
            )
            meta = jnp.stack([total.astype(jnp.int32), checksum.astype(jnp.int32),
                              fits.astype(jnp.int32)])
            return header, stream, meta, starts

        @jax.jit
        def decode_fused_fast(header, stream, starts):
            """Scan-free decode via the record-offset index; verifies the
            Fletcher32 checksum of the wire bytes on device."""
            def rd_u32(off):
                b = header[off : off + 4].astype(jnp.uint32)
                return b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24

            total = (rd_u32(bs_off) - hdr_len).astype(jnp.int32)
            stored_cs = rd_u32(skip - 4)
            computed = device_scan.fletcher32_device_parts(
                header[skip:head_len], static_ab, header[head_len:],
                stream, total)
            ok = computed == stored_cs
            nbytes = d_ * DT_SIZE[dt_]
            zmax_b = header[ranges_off + nbytes : ranges_off + 2 * nbytes]
            if DT_SIZE[dt_] == 4:
                zmax_words = jax.lax.bitcast_convert_type(zmax_b.reshape(d_, 4), jnp.uint32).reshape(d_)
                if is_int:
                    zmax_vec = zmax_words.astype(jnp.int32)
                else:
                    zmax_vec = jax.lax.bitcast_convert_type(zmax_words, jnp.float32)
            else:
                width = DT_SIZE[dt_]
                acc = jnp.zeros(d_, jnp.uint32)
                zb = zmax_b.reshape(d_, width).astype(jnp.uint32)
                for i in range(width):
                    acc = acc | zb[:, i] << jnp.uint32(8 * i)
                shift = 32 - 8 * width
                if dt_ in (DataType.CHAR, DataType.SHORT):
                    zmax_vec = (acc << shift).astype(jnp.int32) >> shift
                else:
                    zmax_vec = acc.astype(jnp.int32)
            # nb_cap-sized extraction; unfit records fold into the ok flag
            # -- callers rebuild on the uncapped variant (encode-side fits
            # in meta already flags the same condition)
            img, index_ok, fits = device_decode.decode_tiles_fast(
                stream, starts, jnp.float32(mze), zmax_vec, h_, w_, d_, dt_, ver,
                nb_cap=nb_cap, mask=mask_dev, **self._exact_kw(dt_),
            )
            return img, ok & index_ok & fits

        @jax.jit
        def decode_fused(header, stream):
            # parse dynamic fields on device
            def rd_u32(off):
                b = header[off : off + 4].astype(jnp.uint32)
                return b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24

            total = (rd_u32(bs_off) - hdr_len).astype(jnp.int32)
            stored_cs = rd_u32(skip - 4)
            computed = device_scan.fletcher32_device_parts(
                header[skip:head_len], static_ab, header[head_len:],
                stream, total)
            ok = computed == stored_cs
            # zmax per depth from the ranges section
            nbytes = d_ * DT_SIZE[dt_]
            zmax_b = header[ranges_off + nbytes : ranges_off + 2 * nbytes]
            if DT_SIZE[dt_] == 4:
                zmax_words = jax.lax.bitcast_convert_type(zmax_b.reshape(d_, 4), jnp.uint32).reshape(d_)
                if is_int:
                    zmax_vec = zmax_words.astype(jnp.int32)
                else:
                    zmax_vec = jax.lax.bitcast_convert_type(zmax_words, jnp.float32)
            else:
                width = DT_SIZE[dt_]
                acc = jnp.zeros(d_, jnp.uint32)
                zb = zmax_b.reshape(d_, width).astype(jnp.uint32)
                for i in range(width):
                    acc = acc | zb[:, i] << jnp.uint32(8 * i)
                shift = 32 - 8 * width
                if dt_ in (DataType.CHAR, DataType.SHORT):
                    zmax_vec = (acc << shift).astype(jnp.int32) >> shift
                else:
                    zmax_vec = acc.astype(jnp.int32)
            stream8 = stream
            if stream8.dtype == jnp.uint32:  # scan path works on bytes
                stream8 = jax.lax.bitcast_convert_type(
                    stream8[:, None], jnp.uint8).reshape(-1)
            (rp, mode, offset, r_nb, r_ne, payload_pos, lut_pos, r_nlut, r_nbits_lut) = (
                device_scan.scan_records_device(stream8, n_rec, dt_, ver, 64)
            )
            img, sf_ok = device_decode.decode_tiles(
                stream8, mode, payload_pos, offset, r_nb, r_ne,
                lut_pos, r_nlut, r_nbits_lut,
                ones, jnp.float32(mze), zmax_vec,
                h_, w_, d_, dt_, True, False, **self._exact_kw(dt_),
            )
            return img, ok & sf_ok

        self._encode_fused = encode_fused
        self._decode_fused = decode_fused
        self._decode_fused_fast = decode_fused_fast

    def encode_fast(self, data_dev):
        """-> (header_dev [hdrLen] u8, stream_dev [cap] u8, meta [2] i32,
        starts [nRec] i32 record-offset index)."""
        return self._encode_fused(data_dev)

    def decode_fast(self, header_dev, stream_dev, starts_dev=None):
        """-> (img [H, W, D] device, checksum_ok scalar bool device).
        With starts_dev (the encode-side index) the serial record scan is
        skipped entirely; without it the blob is scanned on device."""
        if header_dev.shape[0] != self._hdr_small_len:
            raise ValueError(
                "header length does not match this codec's configuration "
                "(different mask/shape/dtype?)"
            )
        if starts_dev is not None:
            return self._decode_fused_fast(header_dev, stream_dev, starts_dev)
        if self._mask_dev is not None:
            raise ValueError(
                "masked resident decode requires the record-offset index"
            )
        return self._decode_fused(header_dev, stream_dev)

    def blob_to_bytes(self, header_dev, stream_dev, meta) -> bytes:
        total = int(np.asarray(meta)[0])
        hb = np.asarray(header_dev).tobytes()
        # the device header carries only the dynamic bytes; the static
        # RLE'd mask section splices back between the fixed head and the
        # (carry + ranges + flags) tail
        return (hb[: self._head_len] + self._static_mid
                + hb[self._head_len:]
                + np.asarray(stream_dev).tobytes()[:total])
