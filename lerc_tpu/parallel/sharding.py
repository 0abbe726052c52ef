"""Distributed tile-grid encoding over a JAX device mesh.

The reference library scales by *external tiling*: one LERC blob per tile,
concatenated by the caller (Lerc_c_api.h:73-87 frames LERC as a tile
compression format; micro-blocks never cross tile bounds so tiling is
halo-free). Here that becomes a first-class SPMD pipeline:

  - the raster is a [nTiles, tileH, tileW] stack sharded over a 1-D mesh
    axis "tiles" (pure data parallelism; no halos, no cross-tile traffic)
  - each device runs the jitted tile encoder (stats -> quantize -> pack ->
    assemble) on its local tiles
  - global per-depth ranges come from jax.lax.pmin/pmax over the mesh --
    the distributed analog of lerc_getDataRanges (Lerc.cpp:1014-1042)
  - per-tile blob sizes are all-gathered so host 0 can lay out the mosaic
    index (sizes -> exclusive scan -> offsets), the "ragged all-gather"
    assembly step

Communication rides XLA collectives (NVLink between the GPUs of a host,
the network across hosts); there is no custom transport.
"""
from __future__ import annotations

import functools
import struct

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..constants import DataType, NUMPY_TO_DT, DT_SIZE, DT_TO_NUMPY
from ..ops import (device_decode, device_encode, device_f64,
                   device_softf64 as softf64)
from ..codec import fletcher32, header as hdr

MOSAIC_MAGIC = b"LercTpuMosaic1"
MOSAIC_MAGIC2 = b"LercTpuMosaic2"  # adds the record-offset index section
MOSAIC_MAGIC3 = b"LercTpuMosaic3"  # adds multi-band tiles (nBands field)


def make_mesh(n_devices: int | None = None, axis: str = "tiles") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "tile_h", "tile_w", "d", "dt", "version", "cap",
                     "try_16"),
)
def _encode_tiles_sharded(
    tiles,      # [T, tileH, tileW, D] sharded over "tiles"
    masks,      # [T, tileH, tileW] bool sharded over "tiles"
    max_z_error,
    mesh: Mesh,
    tile_h: int,
    tile_w: int,
    d: int,
    dt: DataType,
    version: int,
    cap: int,
    try_16: bool = True,
):
    """Returns (streams [T, cap] u8, totals [T], mbs [T] micro-block size,
    starts [T, nRec8], z_mins/z_maxs [T, D] sharded, global_min/max [D] and
    all_sizes/all_mbs/all_zmins/all_zmaxs [T, ...] replicated).

    Full-strength per-tile encode: LUT block mode on,
    and the 16x16 micro-block retrial evaluated per tile with the
    reference's gates (Lerc2.cpp:333-357) -- both variants are encoded
    and the smaller stream selected elementwise (no data-dependent
    branching under jit). Whole-image Huffman/fpl candidates need a host
    tree build and remain single-device features (documented in
    PARITY.md). Metadata travels by all-gather so ANY process can lay out
    the container; payload bytes are read from addressable shards only."""

    def encode_one(tile, mask):
        stream, total, zmin, zmax, starts, _fits = device_encode.encode_tiles(
            tile, mask, max_z_error, tile_h, tile_w, d, dt, False, version, cap,
            enable_lut=True,
        )
        n_valid = mask.sum().astype(jnp.int32)
        if try_16 and (tile_h > 8 or tile_w > 8):
            # _f16 is statically True here: the UNCAPPED encoder sizes its
            # 16x16 pack for nb <= 31 (always_fits; the 11-bit limit is the
            # DECODE window's -- wider chosen tiles host-decode, wire valid)
            s16, t16, _z1, _z2, st16, _f16 = device_encode.encode_tiles(
                tile, mask, max_z_error, tile_h, tile_w, d, dt, False, version,
                cap, enable_lut=True, mb=16,
            )
            n_one_sweep = DT_SIZE[dt] * d * n_valid
            use16 = (
                (total * 16 < 3 * tile_h * tile_w * d)  # bitrate < ~1.5 bpp
                & (total < 4 * n_one_sweep)
                & (t16 <= total)
            )
            stream = jnp.where(use16, s16, stream)
            total = jnp.where(use16, t16, total)
            mbs = jnp.where(use16, 16, 8).astype(jnp.int32)
            # 16x16 tiles ship their 16x16 record index in the same row,
            # padded to the 8x8 length (the decoder slices by n_rec16)
            st16p = jnp.concatenate([
                st16, jnp.full(starts.shape[0] - st16.shape[0], -1, jnp.int32)
            ])
            starts = jnp.where(use16, st16p, starts)
        else:
            mbs = jnp.full((), 8, jnp.int32)
        return (stream, total, mbs,
                zmin.astype(jnp.float32), zmax.astype(jnp.float32), starts)

    def local_step(tiles_l, masks_l):
        streams, totals, mbs, zmins, zmaxs, starts = jax.vmap(encode_one)(
            tiles_l, masks_l)
        gmin = jax.lax.pmin(zmins.min(axis=0), "tiles")
        gmax = jax.lax.pmax(zmaxs.max(axis=0), "tiles")
        # metadata travels by all-gather so every process can build the
        # container index without touching non-addressable payload shards
        all_sizes = jax.lax.all_gather(totals, "tiles", tiled=True)
        all_mbs = jax.lax.all_gather(mbs, "tiles", tiled=True)
        all_zmins = jax.lax.all_gather(zmins, "tiles", tiled=True)
        all_zmaxs = jax.lax.all_gather(zmaxs, "tiles", tiled=True)
        return (streams, totals, mbs, zmins, zmaxs, gmin, gmax,
                all_sizes, all_mbs, all_zmins, all_zmaxs, starts)

    return jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("tiles"), P("tiles")),
        out_specs=(P("tiles"), P("tiles"), P("tiles"), P("tiles"), P("tiles"),
                   P(), P(), P(), P(), P(), P(), P("tiles")),
        check_vma=False,
    )(tiles, masks)


def _encode_tiles_f64_sharded(hi, lo, bits, masks, mze_h, mze_l, mesh: Mesh,
                              tile_h: int, tile_w: int, d: int,
                              version: int, cap: int):
    """Lossy float64 tile-grid encode over the mesh: per-tile double-single
    kernels (device_f64.encode_tiles_f64 -- no LUT/16x16 by that wire's
    design), sizes all-gathered so any process can lay out the container.
    z ranges are computed host-side in exact f64 by the caller (the
    double-single pmin/pmax would round through f32). Returns
    (streams [T, cap] sharded, all_sizes [T] replicated, starts sharded)."""

    def encode_one(th_, tl_, tb_, m_):
        stream, total, starts = device_f64.encode_tiles_f64(
            th_, tl_, tb_, m_, mze_h, mze_l, tile_h, tile_w, d, False,
            version, cap)
        return stream, total.astype(jnp.int32), starts

    def local_step(h_l, l_l, b_l, m_l):
        streams, totals, starts = jax.vmap(encode_one)(h_l, l_l, b_l, m_l)
        all_sizes = jax.lax.all_gather(totals, "tiles", tiled=True)
        return streams, all_sizes, starts

    return jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P("tiles"), P("tiles"), P("tiles"), P("tiles")),
        out_specs=(P("tiles"), P(), P("tiles")),
        check_vma=False,
    )(hi, lo, bits, masks)


def _addressable_tile_rows(arr) -> dict[int, np.ndarray]:
    """{global_tile_index: row} from this process's ADDRESSABLE shards.

    The multi-host-correct way to read a tile-sharded array: never
    np.asarray the global array (it fails or implies a hidden transfer
    when shards live on other hosts' devices); walk addressable shards
    and map their global slice offsets."""
    parts: dict[int, np.ndarray] = {}
    for sh in arr.addressable_shards:
        sl = sh.index[0]
        start = 0 if sl.start is None else int(sl.start)
        a = np.asarray(sh.data)
        for i in range(a.shape[0]):
            parts[start + i] = a[i]
    return parts


def split_into_tiles(data: np.ndarray, mask: np.ndarray | None, tile_h: int, tile_w: int):
    """[H, W, D] -> padded tile stack [T, tileH, tileW, D] + tile masks + grid."""
    h, w, d = data.shape
    ty, tx = -(-h // tile_h), -(-w // tile_w)
    tiles = np.zeros((ty * tx, tile_h, tile_w, d), dtype=data.dtype)
    masks = np.zeros((ty * tx, tile_h, tile_w), dtype=bool)
    full_mask = np.ones((h, w), bool) if mask is None else mask.astype(bool)
    for i in range(ty):
        for j in range(tx):
            hs = min(tile_h, h - i * tile_h)
            ws = min(tile_w, w - j * tile_w)
            t = i * tx + j
            tiles[t, :hs, :ws] = data[i * tile_h : i * tile_h + hs, j * tile_w : j * tile_w + ws]
            masks[t, :hs, :ws] = full_mask[i * tile_h : i * tile_h + hs, j * tile_w : j * tile_w + ws]
    return tiles, masks, (ty, tx)


class MosaicEncoder:
    """Distributed tile-grid encoder over a device mesh.

    Produces a mosaic container: magic, grid geometry, per-tile offsets,
    then one standard Lerc2 blob per tile (each independently decodable by
    any LERC reader, including the reference library).
    """

    def __init__(self, mesh: Mesh, tile_h: int, tile_w: int, dtype, n_depth: int = 1,
                 version: int = 6, try_16: bool = True):
        self.mesh = mesh
        self.try_16 = try_16  # 16x16 retrial: better low-bitrate
        # compression; chosen tiles ship their 16x16 record index and
        # decode on the device fast path like 8x8 tiles
        self.tile_h, self.tile_w = tile_h, tile_w
        self.dt = NUMPY_TO_DT[np.dtype(dtype)]
        self.np_dtype = np.dtype(dtype)
        self.d = n_depth
        self.version = version
        self.tiles_per_device: dict[str, int] = {}
        n_rec = (-(-tile_h // 8)) * (-(-tile_w // 8)) * n_depth
        raw = tile_h * tile_w * DT_SIZE[self.dt] * n_depth + n_rec * 12 + 4096
        self.cap = 1 << (raw - 1).bit_length()

    def encode(self, data: np.ndarray, mask: np.ndarray | None, max_z_error: float) -> bytes:
        """Encode [H, W, D] (single band) or [nBands, H, W, D]. mask may be
        None, [H, W] (shared by all bands), or [nBands, H, W] per band.

        Multi-band tiles follow the reference's band-concat + mask-dedup
        wire (Lerc.cpp:130-176,717-741): each tile's blob is the bands'
        Lerc2 blobs back to back, and a band whose mask equals the
        previous band's writes numBytesMask == 0 (mask-reuse flag) -- so
        every tile blob is a standard multi-band LERC blob any reader
        (including the reference library) decodes directly."""
        if data.ndim == 3:
            data = data[None]
        n_bands, h, w, d = data.shape
        if mask is None:
            band_masks = [None] * n_bands
        elif mask.ndim == 2:
            band_masks = [mask] * n_bands
        else:
            band_masks = [mask[b] for b in range(n_bands)]
        mze = self._adjust_mze(max_z_error)

        per_band = []
        prev_tile_masks = None
        gmn = gmx = None
        grid = None
        for b in range(n_bands):
            blobs, offs, starts, b_mn, b_mx, grid, tile_masks = (
                self._encode_band_blobs(data[b], band_masks[b], mze,
                                        prev_tile_masks=prev_tile_masks,
                                        n_blobs_more=n_bands - 1 - b)
            )
            per_band.append((blobs, offs, starts))
            prev_tile_masks = tile_masks
            gmn = b_mn if gmn is None else np.minimum(gmn, b_mn)
            gmx = b_mx if gmx is None else np.maximum(gmx, b_mx)
        ty, tx = grid

        # per tile: concatenate the bands' blobs; flatten the index rows
        # in (tile, band) order with stream offsets absolute in the tile
        tile_blobs, stream_offs, starts_rows = [], [], []
        for t in range(ty * tx):
            parts, base = [], 0
            for b in range(n_bands):
                blobs, offs, starts = per_band[b]
                # stream_offs are absolute within the tile blob; starts
                # rows stay relative to the band's stream start
                stream_offs.append(base + offs[t] if offs[t] >= 0 else -1)
                starts_rows.append(starts[t])
                parts.append(blobs[t])
                base += len(blobs[t])
            tile_blobs.append(b"".join(parts))
        return self._assemble_container(
            tile_blobs, stream_offs, starts_rows, gmn, gmx, ty, tx, h, w,
            n_bands=n_bands,
        )

    def encode_streamed(self, row_provider, h: int, w: int,
                        max_z_error: float, mask_provider=None) -> bytes:
        """Bounded-memory mosaic encode: the raster arrives one tile-row
        band at a time (row_provider(i) -> [bandH, W, D] numpy; the last
        band may be shorter), each band shards and encodes over the mesh,
        and per-tile blobs accumulate progressively -- peak host memory is
        one band plus the (compressed) blobs, so rasters larger than host
        or HBM memory stream through."""
        ty = -(-h // self.tile_h)
        mze = self._adjust_mze(max_z_error)
        blobs, stream_offs, starts_rows = [], [], []
        gmn = gmx = None
        tx = None
        for i in range(ty):
            hs = min(self.tile_h, h - i * self.tile_h)
            band = np.ascontiguousarray(row_provider(i))
            if band.shape[0] != hs or band.shape[1] != w:
                raise ValueError(f"band {i}: expected [{hs}, {w}, D]")
            bmask = mask_provider(i) if mask_provider is not None else None
            b_blobs, b_offs, b_starts, b_mn, b_mx, (bty, btx), _tm = (
                self._encode_band_blobs(band, bmask, mze)
            )
            assert bty == 1
            tx = btx
            blobs += b_blobs
            stream_offs += b_offs
            starts_rows += b_starts
            gmn = b_mn if gmn is None else np.minimum(gmn, b_mn)
            gmx = b_mx if gmx is None else np.maximum(gmx, b_mx)
        return self._assemble_container(
            blobs, stream_offs, starts_rows, gmn, gmx, ty, tx, h, w
        )

    def _adjust_mze(self, max_z_error: float) -> float:
        mze = max_z_error
        if self.dt < DataType.FLOAT:
            mze = max(0.5, np.floor(mze))
        return mze

    def _encode_band_blobs(self, data: np.ndarray, mask: np.ndarray | None,
                           mze: float, prev_tile_masks: np.ndarray | None = None,
                           n_blobs_more: int = 0):
        """Shard + encode one raster (or band) -> per-tile wrapped blobs.
        prev_tile_masks ([T, th, tw] from the previous band) enables the
        mask-reuse flag (numBytesMask == 0) on tiles whose mask is
        unchanged. Returns (blobs, stream_offs, starts_rows, gmin, gmax,
        (ty, tx), tile_masks)."""
        h, w, d = data.shape
        tiles, masks, (ty, tx) = split_into_tiles(data, mask, self.tile_h, self.tile_w)
        n_dev = self.mesh.devices.size
        t_total = tiles.shape[0]
        t_pad = -(-t_total // n_dev) * n_dev
        if t_pad != t_total:  # pad with empty tiles to a multiple of the mesh
            tiles = np.concatenate([tiles, np.zeros((t_pad - t_total,) + tiles.shape[1:], tiles.dtype)])
            masks = np.concatenate([masks, np.zeros((t_pad - t_total,) + masks.shape[1:], bool)])

        sharding = NamedSharding(self.mesh, P("tiles"))
        if self.dt == DataType.DOUBLE:
            # lossy f64 rides the double-single kernels; hi/lo/bit-pattern
            # split is exact on host (device_f64.split_f64_host), z ranges
            # stay host-side exact f64 (device pmin/pmax would round f32)
            t64 = tiles.astype(np.float64)
            d_hi, d_lo, d_bits = device_f64.split_f64_host(t64)
            hi_d = jax.device_put(jnp.asarray(d_hi), sharding)
            lo_d = jax.device_put(jnp.asarray(d_lo), sharding)
            bits_d = jax.device_put(jnp.asarray(d_bits), sharding)
            masks_d = jax.device_put(jnp.asarray(masks), sharding)
            mh = np.float32(mze)
            ml = np.float32(np.float64(mze) - np.float64(mh))
            streams, all_sizes, starts = _encode_tiles_f64_sharded(
                hi_d, lo_d, bits_d, masks_d, jnp.float32(mh), jnp.float32(ml),
                self.mesh, self.tile_h, self.tile_w, self.d, self.version,
                self.cap)
            sizes_np = np.asarray(all_sizes)
            mbs_np = np.full(t_pad, 8, np.int32)  # device_f64 wire is 8x8
            m4 = masks[:, :, :, None]
            zmins_np = np.where(m4, t64, np.inf).min(axis=(1, 2))
            zmaxs_np = np.where(m4, t64, -np.inf).max(axis=(1, 2))
            empty = ~masks.any(axis=(1, 2))
            zmins_np[empty] = 0.0
            zmaxs_np[empty] = 0.0
            gmin = (zmins_np[~empty].min(axis=0) if (~empty).any()
                    else np.zeros(self.d))
            gmax = (zmaxs_np[~empty].max(axis=0) if (~empty).any()
                    else np.zeros(self.d))
        else:
            dev_dtype = jnp.int32 if self.dt < DataType.FLOAT else jnp.float32
            tiles_d = jax.device_put(jnp.asarray(tiles, dtype=dev_dtype), sharding)
            masks_d = jax.device_put(jnp.asarray(masks), sharding)

            (streams, totals, mbs, zmins, zmaxs, gmin, gmax,
             all_sizes, all_mbs, all_zmins, all_zmaxs, starts) = (
                _encode_tiles_sharded(
                    tiles_d, masks_d, jnp.float32(mze), self.mesh,
                    self.tile_h, self.tile_w, self.d, self.dt, self.version, self.cap,
                    try_16=self.try_16,
                )
            )
            # replicated metadata: addressable on every process by definition
            sizes_np = np.asarray(all_sizes)
            mbs_np = np.asarray(all_mbs)
            zmins_np = np.asarray(all_zmins, dtype=np.float64)
            zmaxs_np = np.asarray(all_zmaxs, dtype=np.float64)
        # where this band's tiles ran: {device: tiles}, for callers that
        # check the mesh really spread the work
        self.tiles_per_device = {
            str(sh.device): int(sh.data.shape[0]) for sh in streams.addressable_shards}
        # payload bytes: read ONLY this process's addressable shards; with
        # multiple processes, one ragged gather across hosts assembles the rest
        # (Lerc.cpp:130-176 band-ordered concat semantics, distributed)
        stream_parts = _addressable_tile_rows(streams)
        starts_parts = _addressable_tile_rows(starts)
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            # each process contributes its shard rows; the 1-D mesh
            # enumerates devices in process order, so axis-0 concatenation
            # (tiled=True -- the default would STACK a process axis and
            # renumber tiles per process, caught by tests/mp_worker.py)
            # restores global tile order
            local_idx = sorted(stream_parts)
            g_streams = multihost_utils.process_allgather(
                np.stack([stream_parts[t] for t in local_idx]), tiled=True)
            g_starts = multihost_utils.process_allgather(
                np.stack([starts_parts[t] for t in local_idx]), tiled=True)
            stream_parts = dict(enumerate(g_streams))
            starts_parts = dict(enumerate(g_starts))

        blobs, stream_offs, starts_rows = [], [], []
        for t in range(t_total):
            reuse = (prev_tile_masks is not None
                     and np.array_equal(masks[t], prev_tile_masks[t]))
            blob, soff = self._wrap_tile(
                stream_parts[t], int(sizes_np[t]), zmins_np[t], zmaxs_np[t],
                masks[t], mze, int(mbs_np[t]), reuse_mask=reuse,
                n_blobs_more=n_blobs_more,
            )
            blobs.append(blob)
            stream_offs.append(soff)
            starts_rows.append(np.asarray(starts_parts[t], np.int32))
        return (blobs, stream_offs, starts_rows,
                np.asarray(gmin, np.float64), np.asarray(gmax, np.float64),
                (ty, tx), masks[:t_total])

    def _assemble_container(self, blobs, stream_offs, starts_rows,
                            gmin, gmax, ty, tx, h, w, n_bands: int = 1) -> bytes:
        t_total = ty * tx
        if n_bands == 1:
            index = struct.pack("<14s4i", MOSAIC_MAGIC2, ty, tx, h, w)
        else:
            index = struct.pack("<14s5i", MOSAIC_MAGIC3, ty, tx, h, w, n_bands)
        index += struct.pack("<2i", self.tile_h, self.tile_w)
        index += struct.pack(f"<{t_total}q", *np.cumsum([0] + [len(b) for b in blobs[:-1]]).tolist())
        index += struct.pack("<2d", float(np.asarray(gmin).min()), float(np.asarray(gmax).max()))
        # record-offset acceleration index (decode-side scan skip): per
        # (tile, band) the byte offset of the band's tile stream within the
        # tile blob (-1: no stream, const/empty tile) and the record start
        # offsets relative to that stream
        n_rec = starts_rows[0].shape[0] if starts_rows else 0
        index += struct.pack("<2i", n_rec, 0)
        index += np.asarray(stream_offs, np.int32).tobytes()
        index += np.stack(starts_rows).astype(np.int32).tobytes()
        return index + b"".join(blobs)

    def _wrap_tile(self, stream, total, zmin_vec, zmax_vec, tile_mask, mze,
                   micro_block_size: int = 8, reuse_mask: bool = False,
                   n_blobs_more: int = 0):
        """-> (blob bytes, stream byte offset within the blob or -1).
        reuse_mask writes numBytesMask == 0 for a masked tile (wire flag:
        same mask as the previous band); n_blobs_more is the v6 header's
        count of band blobs that follow, which drives the reference's
        multi-band walk (Lerc.cpp:118,136-176)."""
        num_valid = int(tile_mask.sum())
        head = hdr.HeaderInfo(
            version=self.version, n_rows=self.tile_h, n_cols=self.tile_w, n_depth=self.d,
            num_valid_pixel=num_valid, micro_block_size=micro_block_size,
            dt=self.dt, max_z_error=mze, n_blobs_more=n_blobs_more,
        )
        need_mask = 0 < num_valid < self.tile_h * self.tile_w and not reuse_mask
        if need_mask:  # masked tiles carry their mask inline (RLE'd bitmask)
            from .. import native
            from ..codec import rle
            from ..codec.bitmask import bool_to_bits

            bits = bool_to_bits(tile_mask)
            mask_rle = native.rle_compress(bits) if native.available() else rle.compress(bits)
            mask_section = struct.pack("<i", len(mask_rle)) + mask_rle
        else:
            mask_section = struct.pack("<i", 0)
        body = b""
        ranges = b""
        stream_off = -1
        np_dt = DT_TO_NUMPY[self.dt]
        if num_valid > 0:
            head.z_min = float(zmin_vec.min())
            head.z_max = float(zmax_vec.max())
            if head.z_min != head.z_max:
                if self.version >= 4:
                    ranges = zmin_vec.astype(np_dt).tobytes() + zmax_vec.astype(np_dt).tobytes()
                flags = b"\x00" + (
                    b"\x00" if head.try_huffman_int() or head.try_huffman_flt() else b""
                )
                stream_off = (hdr.header_size(self.version) + len(mask_section)
                              + len(ranges) + len(flags))
                body = flags + stream[:total].tobytes()
        head.blob_size = hdr.header_size(self.version) + len(mask_section) + len(ranges) + len(body)
        blob = bytearray(hdr.write_header(head))
        blob += mask_section
        blob += ranges
        blob += body
        if self.version >= 3:
            skip = hdr.checksum_skip(self.version)
            struct.pack_into("<I", blob, skip - 4, fletcher32.fletcher32(bytes(blob[skip:])))
        return bytes(blob), stream_off


def read_mosaic(buf: bytes):
    """Parse a mosaic container -> (grid info, list of per-tile blob views).
    Handles v1 (no index), v2 (record-offset acceleration index) and v3
    (multi-band tiles; stream_offs/starts are in (tile, band) order)."""
    magic, ty, tx, h, w = struct.unpack_from("<14s4i", buf, 0)
    if magic not in (MOSAIC_MAGIC, MOSAIC_MAGIC2, MOSAIC_MAGIC3):
        raise ValueError("not a lerc_tpu mosaic")
    pos = 14 + 16
    n_bands = 1
    if magic == MOSAIC_MAGIC3:
        (n_bands,) = struct.unpack_from("<i", buf, pos)
        pos += 4
    tile_h, tile_w = struct.unpack_from("<2i", buf, pos)
    pos += 8
    t_total = ty * tx
    offsets = struct.unpack_from(f"<{t_total}q", buf, pos)
    pos += 8 * t_total
    gmin, gmax = struct.unpack_from("<2d", buf, pos)
    pos += 16
    info = {"grid": (ty, tx), "shape": (h, w), "tile": (tile_h, tile_w),
            "z_min": gmin, "z_max": gmax, "n_bands": n_bands,
            "stream_offs": None, "starts": None}
    if magic in (MOSAIC_MAGIC2, MOSAIC_MAGIC3):
        n_rec, _rsv = struct.unpack_from("<2i", buf, pos)
        pos += 8
        n_units = t_total * n_bands
        info["stream_offs"] = np.frombuffer(buf, np.int32, n_units, pos).copy()
        pos += 4 * n_units
        info["starts"] = np.frombuffer(
            buf, np.int32, n_units * n_rec, pos
        ).reshape(n_units, n_rec).copy()
        pos += 4 * n_units * n_rec
    base = pos
    views = []
    for t in range(t_total):
        start = base + offsets[t]
        end = base + offsets[t + 1] if t + 1 < t_total else len(buf)
        views.append(memoryview(buf)[start:end])
    return info, views


def _tile_band_layouts(views, n_bands):
    """Per tile, the [(byte offset, HeaderInfo), ...] of its band blobs
    (multi-band tile blobs are the bands' Lerc2 blobs back to back)."""
    from ..codec import header as hdr_mod

    layouts = []
    for view in views:
        bands = []
        base = 0
        for _ in range(n_bands):
            hd, _ = hdr_mod.read_header(view[base:])
            bands.append((base, hd))
            base += hd.blob_size
        layouts.append(bands)
    return layouts


def _decode_tiles_device_batched(info, views, layouts, wanted, mesh=None):
    """Decode the `wanted` mosaic tiles on device, BATCHED: every
    (tile, band) unit flattens into one record axis per micro-block group
    so a 256-tile mosaic issues O(1) dispatches instead of a Python loop
    with a fetch per tile. Unit counts pad to
    powers of two (last unit replicated) to bound XLA recompiles across
    mosaics.

    Returns {(tile, band): np.ndarray [tileH, tileW, D]}; units that need
    the host path are simply absent. Raises on checksum or index
    inconsistency (never silently wrong pixels)."""
    from ..codec import header as hdr_mod
    from ..codec.bitmask import bits_to_bool, mask_size_bytes
    from ..codec.lerc2_decode import read_band_ranges
    from ..constants import dt_is_int
    from .. import native
    from ..codec import rle

    tile_h, tile_w = info["tile"]
    n_bands = info["n_bands"]
    starts_all = info["starts"]
    stream_offs = info["stream_offs"]
    if starts_all is None or not wanted:
        return {}

    def band_mask(t, b):
        """Resolved validity mask of unit (t, b): None = fully valid,
        False = needs the host path (reuse chain broken)."""
        base, hd = layouts[t][b]
        if hd.num_valid_pixel == tile_h * tile_w:
            return None
        if hd.num_valid_pixel == 0:
            return False
        pos = base + hdr_mod.header_size(hd.version)
        num_bytes_mask = int.from_bytes(views[t][pos : pos + 4], "little", signed=True)
        pos += 4
        if num_bytes_mask <= 0:
            # mask-reuse flag: same mask as the previous band; an all-valid
            # previous band contradicts 0 < nvp < total here -> host path
            prev = band_mask(t, b - 1) if b > 0 else False
            return False if prev is None else prev
        nb = mask_size_bytes(tile_w, tile_h)
        raw = np.frombuffer(views[t][pos : pos + num_bytes_mask], np.uint8)
        bits = (native.rle_decompress(raw, nb) if native.available()
                else np.frombuffer(rle.decompress(raw, nb), np.uint8))
        return bits_to_bool(bits, tile_w, tile_h)

    units = [(t, b) for t in wanted for b in range(n_bands)]
    hd0 = layouts[units[0][0]][units[0][1]][1]
    dev_ok, masks = [], {}
    for t, b in units:
        base, hd = layouts[t][b]
        u = t * n_bands + b
        if not (stream_offs[u] >= 0 and hd.num_valid_pixel > 0
                # f64 records carry 8-byte double offsets the batched
                # device header parse doesn't decode; DOUBLE units take
                # the per-tile softfloat path (_decode_tile_blob)
                and hd.dt != DataType.DOUBLE
                and hd.micro_block_size in (8, 16)
                and tile_h % hd.micro_block_size == 0
                and tile_w % hd.micro_block_size == 0
                # the batch requires uniform codec parameters (always true
                # for MosaicEncoder output; hand-built containers may vary)
                and hd.dt == hd0.dt and hd.n_depth == hd0.n_depth
                and hd.version == hd0.version
                and hd.max_z_error == hd0.max_z_error):
            continue
        msk = band_mask(t, b)
        if msk is False:
            continue  # unresolvable mask: host path
        masks[(t, b)] = msk
        dev_ok.append((t, b))
    if not dev_ok:
        return {}
    # the host fallback (decode_blob) verifies each blob's Fletcher32; the
    # device fast path must too, or a payload bit flip that preserves
    # record lengths decodes to silently wrong pixels from file input
    for t, b in dev_ok:
        base, hd = layouts[t][b]
        if hd.version >= 3:
            skip = hdr_mod.checksum_skip(hd.version)
            if fletcher32.fletcher32(
                    views[t][base + skip : base + hd.blob_size]) != hd.checksum:
                raise ValueError(f"mosaic tile {t} band {b}: Lerc2 checksum mismatch")
    d = hd0.n_depth

    out: dict[tuple, np.ndarray] = {}
    for mb in (8, 16):
        group = [u for u in dev_ok if layouts[u[0]][u[1]][1].micro_block_size == mb]
        if not group:
            continue
        n_rec = (tile_h // mb) * (tile_w // mb) * d
        # concatenate unit streams at 512-aligned bases; absolute starts
        parts, starts_abs, zmaxs, gmasks = [], [], [], []
        off = 0
        for t, b in group:
            base, hd = layouts[t][b]
            u = t * n_bands + b
            s = np.frombuffer(
                views[t][int(stream_offs[u]) : base + hd.blob_size], np.uint8)
            pad = -(-max(s.size, 1) // 512) * 512
            sp = np.zeros(pad, np.uint8)
            sp[: s.size] = s
            parts.append(sp)
            starts_abs.append(starts_all[u][:n_rec].astype(np.int32) + off)
            off += pad
            _hd2, (_zmn, zmx) = read_band_ranges(views[t][base:])
            zmaxs.append(np.asarray(zmx))
            gmasks.append(masks[(t, b)])
        # pad the unit count to a power of two so XLA compiles O(log T)
        # variants across mosaics; replicated pad units POINT AT the last
        # real unit's stream bytes (the index check is per unit and
        # self-consistent) and their outputs are dropped
        n_real = len(group)
        n_pad = 1 << (n_real - 1).bit_length() if n_real > 1 else 1
        if mesh is not None:
            # sharded decode: whole units per device shard, so the padded
            # count must be a multiple of the mesh size
            n_pad = -(-n_pad // mesh.size) * mesh.size
        starts_abs += [starts_abs[n_real - 1]] * (n_pad - n_real)
        zmaxs += [zmaxs[-1]] * (n_pad - n_real)
        gmasks += [gmasks[-1]] * (n_pad - n_real)
        big = np.concatenate(parts)
        stream_np32 = big.view(np.uint32)
        sa_np = np.concatenate(starts_abs).astype(np.int32)
        hd = layouts[group[0][0]][group[0][1]][1]
        if dt_is_int(hd.dt):
            zmax_np = np.round(np.stack(zmaxs)).astype(np.int32)
        else:
            zmax_np = np.stack(zmaxs).astype(np.float32)
        any_masked = any(m is not None for m in gmasks)
        mask_np = (np.stack([np.ones((tile_h, tile_w), bool) if m is None else m
                             for m in gmasks]) if any_masked else None)
        if mesh is not None and mesh.size > 1:
            # GSPMD-sharded decode over the unit axis: the stream is
            # replicated (records address it absolutely), every per-unit
            # array shards along "tiles" at whole-unit boundaries (n_pad is
            # a mesh-size multiple), so each device decodes its tile slice
            # and XLA keeps the heavy gather/extract work fully local
            repl = NamedSharding(mesh, P())
            by_unit = NamedSharding(mesh, P("tiles"))
            stream_dev = jax.device_put(stream_np32, repl)
            sa = jax.device_put(sa_np, by_unit)  # flat, unit-major
            zmax_arg = jax.device_put(zmax_np, by_unit)
            mask_arg = (jax.device_put(mask_np, by_unit)
                        if mask_np is not None else None)
        else:
            stream_dev = jnp.asarray(stream_np32)
            sa = jnp.asarray(sa_np)
            zmax_arg = jnp.asarray(zmax_np)
            mask_arg = jnp.asarray(mask_np) if mask_np is not None else None
        inv_kw = {}
        if hd.dt == DataType.FLOAT and hd.max_z_error != 0:
            # bit-exact f32 dequant (double ScaleBack via softfloat); a
            # rejected decomposition keeps the f32 path (<= 1 ulp)
            dec = softf64.decompose_scalar(2.0 * hd.max_z_error)
            if dec is not None and np.isfinite(zmax_np).all():
                inv_kw = {"inv_limbs": dec[0], "inv_bexp": dec[1]}
        imgs, idx_ok, fits = device_decode.decode_tiles_fast(
            stream_dev, sa, jnp.float32(hd.max_z_error), zmax_arg,
            tile_h, tile_w, d, hd.dt, hd.version,
            mask=mask_arg, mb=mb, n_tiles=n_pad, enable_lut=True, **inv_kw,
        )
        if not bool(np.asarray(idx_ok)):
            raise ValueError(
                "mosaic: record-offset index inconsistent with stream "
                f"(micro-block {mb} group)"
            )
        # per-unit fits: a unit holding a record wider than the kernel's
        # window (16x16 records above 11 bits) or a softfloat range trip
        # is left out and takes the per-tile path; the others keep theirs
        fits_h = np.asarray(fits).reshape(-1)
        imgs_h = np.asarray(imgs)  # ONE fetch per group
        if n_pad == 1:  # decode_tiles_fast drops the tile axis for one tile
            imgs_h = imgs_h[None]
        for i, u in enumerate(group):
            if fits_h[i]:
                out[u] = imgs_h[i]
        _count_placement(imgs, fits_h[:n_real], n_pad)
    return out


def _count_placement(imgs, fits_real: np.ndarray, n_pad: int) -> None:
    """Add the units a batched decode kept to ROUTES: ("decode", "device")
    in all, ("mosaic_units", <device>) for the device that holds each
    unit's decoded pixels, and ("mosaic_unfit", "units") for those left to
    the per-tile path."""
    from ..codec.encode_orchestrator import ROUTES

    def add(key, n):
        if n:
            ROUTES[key] += int(n)

    n_real = fits_real.size
    add(("decode", "device"), fits_real.sum())
    add(("mosaic_unfit", "units"), n_real - fits_real.sum())
    if n_pad == 1:  # no tile axis: one unit on one device
        add(("mosaic_units", str(next(iter(imgs.devices())))), fits_real.sum())
        return
    for sh in imgs.addressable_shards:
        sl = sh.index[0]
        lo = 0 if sl.start is None else int(sl.start)
        hi = n_pad if sl.stop is None else int(sl.stop)
        add(("mosaic_units", str(sh.device)), fits_real[lo:min(hi, n_real)].sum())


def _decode_tile_blob(view, n_bands: int) -> np.ndarray:
    """Per-tile fallback decode -> [nBands, H, W, D]. Single-band tiles
    try the device path first (decode_band_device: native record scan +
    device kernels incl. the exact-softfloat f64 dequant -- how DOUBLE
    mosaic tiles stay on device), then the host decoder."""
    from ..codec.encode_orchestrator import ROUTES
    from ..codec.orchestrator import decode_blob

    if n_bands == 1:
        from ..codec.device_codec import decode_band_device

        try:
            out = decode_band_device(view)
        except ValueError:
            out = None  # corrupt tile: the host decoder raises its own error
        if out is not None:
            ROUTES["decode", "device"] += 1
            return np.asarray(out.data)[None]
    return decode_blob(view).data  # counts its bands' routes itself


def _unit_pixels(decoded, host_tiles, views, layouts, t, b, n_bands, tile_h, tile_w):
    """Pixels of unit (t, b): the batched device decode's, else a constant
    fill (counted as ("decode", "const") in ROUTES), else the per-tile
    path's, decoded once per tile into `host_tiles`."""
    from ..codec.encode_orchestrator import ROUTES

    img = decoded.get((t, b))
    if img is None:
        img = _const_unit_fill(views[t], layouts[t], b, tile_h, tile_w)
        if img is not None:
            ROUTES["decode", "const"] += 1
    if img is None:
        if t not in host_tiles:
            host_tiles[t] = _decode_tile_blob(views[t], n_bands)
        img = host_tiles[t][b]
    return img


def _const_unit_fill(view, layout, b, tile_h, tile_w):
    """Cheap host fill for units with no tile stream: fully-invalid bands
    (zeros) and fully-valid const bands (z_min everywhere, the reference's
    _fill_const semantics). Returns None when the unit needs a real
    decode (masked const tiles included -- rare, host path)."""
    from ..codec.lerc2_decode import read_band_ranges

    base, hd = layout[b]
    d = hd.n_depth
    np_dt = DT_TO_NUMPY[hd.dt]
    if hd.num_valid_pixel == 0:
        return np.zeros((tile_h, tile_w, d), np_dt)
    if hd.num_valid_pixel != tile_h * tile_w:
        return None
    if hd.z_min == hd.z_max:
        return np.full((tile_h, tile_w, d), np_dt(hd.z_min))
    if hd.version >= 4:
        _hd2, (zmn, zmx) = read_band_ranges(view[base:])
        if zmn is not None and np.array_equal(zmn, zmx):
            vals = (np.full(d, np_dt(hd.z_min)) if d == 1
                    else np.asarray(zmn).astype(np_dt))
            return np.broadcast_to(vals, (tile_h, tile_w, d)).copy()
    return None


def decode_mosaic_device(buf: bytes, mesh: Mesh | None = None) -> np.ndarray:
    """Device-parallel mosaic decode: scan-free batched decodes (record
    offsets from the container's acceleration index; tiles flattened into
    one record axis, one dispatch + one fetch per micro-block group).
    Masked and edge-padded tiles stay on device via the masked fast path
    (their RLE masks parse on host, ~bytes); 16x16 and LUT tiles decode
    on device too. Only tiles without an index entry (const/empty, or v1
    containers) and tiles unfit for the batched kernel (a 16x16 record over
    11 bits) take the per-tile path; ROUTES counts where each unit went."""
    info, views = read_mosaic(buf)
    ty, tx = info["grid"]
    h, w = info["shape"]
    tile_h, tile_w = info["tile"]
    n_bands = info["n_bands"]
    if info["starts"] is None:
        return decode_mosaic(buf)
    layouts = _tile_band_layouts(views, n_bands)
    decoded = _decode_tiles_device_batched(info, views, layouts,
                                           list(range(ty * tx)), mesh=mesh)

    hd0 = layouts[0][0][1]
    d = hd0.n_depth
    np_dt = DT_TO_NUMPY[hd0.dt]
    out = np.zeros((n_bands, h, w, d), dtype=np_dt)
    host_tiles: dict[int, np.ndarray] = {}
    for t in range(ty * tx):
        ti, tj = divmod(t, tx)
        hs = min(tile_h, h - ti * tile_h)
        ws = min(tile_w, w - tj * tile_w)
        for b in range(n_bands):
            img = _unit_pixels(decoded, host_tiles, views, layouts, t, b,
                               n_bands, tile_h, tile_w)
            out[b, ti * tile_h : ti * tile_h + hs,
                tj * tile_w : tj * tile_w + ws] = img[:hs, :ws]
    return out if n_bands > 1 else out[0]


def decode_mosaic_region(buf: bytes, row0: int, row1: int, col0: int, col1: int,
                         device: bool = True) -> np.ndarray:
    """Random access: decode ONLY the tiles intersecting the half-open
    pixel window [row0:row1, col0:col1] and return that region.

    The reference frames LERC as a tile compression format precisely so
    consumers can fetch sub-regions without decoding the world
    (Lerc_c_api.h:73-76); the mosaic container's per-tile offsets make
    the blob seekable, so cost scales with the window, not the raster.
    With device=True (default) indexed tiles decode through the batched
    device fast path; pass device=False to force the host decoder.
    Single-band mosaics return [rh, rw, D]; multi-band [nBands, rh, rw, D]."""
    info, views = read_mosaic(buf)
    ty, tx = info["grid"]
    h, w = info["shape"]
    tile_h, tile_w = info["tile"]
    n_bands = info["n_bands"]
    row0c, row1c = max(0, row0), min(h, row1)
    col0c, col1c = max(0, col0), min(w, col1)
    if row0c >= row1c or col0c >= col1c:
        raise ValueError("empty region")
    t_i0, t_i1 = row0c // tile_h, (row1c - 1) // tile_h
    t_j0, t_j1 = col0c // tile_w, (col1c - 1) // tile_w
    wanted = [ti * tx + tj
              for ti in range(t_i0, t_i1 + 1) for tj in range(t_j0, t_j1 + 1)]
    layouts = _tile_band_layouts(views, n_bands)
    decoded = {}
    if device and info["starts"] is not None:
        decoded = _decode_tiles_device_batched(info, views, layouts, wanted)
    out = None
    host_tiles: dict[int, np.ndarray] = {}
    for t in wanted:
        ti, tj = divmod(t, tx)
        for b in range(n_bands):
            img = _unit_pixels(decoded, host_tiles, views, layouts, t, b,
                               n_bands, tile_h, tile_w)
            if out is None:
                out = np.zeros((n_bands, row1c - row0c, col1c - col0c,
                                img.shape[2]), dtype=img.dtype)
            # tile-local <-> region coordinates
            ys, xs = ti * tile_h, tj * tile_w
            ry0, ry1 = max(row0c, ys), min(row1c, ys + tile_h)
            rx0, rx1 = max(col0c, xs), min(col1c, xs + tile_w)
            out[b, ry0 - row0c : ry1 - row0c, rx0 - col0c : rx1 - col0c] = (
                img[ry0 - ys : ry1 - ys, rx0 - xs : rx1 - xs]
            )
    return out if n_bands > 1 else out[0]


def decode_mosaic(buf: bytes) -> np.ndarray:
    """Decode a mosaic back to the full raster (host path per tile)."""
    from ..codec.orchestrator import decode_blob

    info, views = read_mosaic(buf)
    ty, tx = info["grid"]
    h, w = info["shape"]
    tile_h, tile_w = info["tile"]
    n_bands = info["n_bands"]
    out = None
    for t, view in enumerate(views):
        res = decode_blob(view)
        d = res.data.shape[3]
        if out is None:
            out = np.zeros((n_bands, h, w, d), dtype=res.data.dtype)
        i, j = divmod(t, tx)
        hs = min(tile_h, h - i * tile_h)
        ws = min(tile_w, w - j * tile_w)
        out[:, i * tile_h : i * tile_h + hs, j * tile_w : j * tile_w + ws] = (
            res.data[:, :hs, :ws]
        )
    return out if n_bands > 1 else out[0]
