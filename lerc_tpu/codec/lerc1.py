"""Legacy Lerc1 decoder (decode-only, float-only), wire format "CntZImage ".

Mirrors lerc/src/LercLib/Lerc1Decode/CntZImage.cpp and
BitStuffer.cpp. A blob is:

  "CntZImage "  int32 version(11)  int32 type(8=CNT_Z)
  int32 height  int32 width  double maxZErrorInFile
  then two sections (cnt = validity, z = values), each:
    int32 numTilesVert, int32 numTilesHori, int32 numBytes, float maxValInImg
    payload (numBytes):
      cnt, no tiling: const (numBytes==0, cnt=maxValInImg) or RLE bitmask
      tiled: per-tile comprFlag + payload (legacy BitStuffer packing)
  multi-band blobs repeat the z section only.
"""
from __future__ import annotations

import struct

import numpy as np

from ..constants import DataType, FILE_KEY_LERC1
from . import rle
from .bitmask import bits_to_bool, mask_size_bytes
from .bitstuffer import bit_unpack_legacy


_TYPE_CNT_Z = 8
_HDR = 10 + 4 * 4 + 8


def _read_flt(src: memoryview, pos: int, nbytes: int) -> tuple[float, int]:
    if nbytes == 1:
        return float(struct.unpack_from("<b", src, pos)[0]), pos + 1
    if nbytes == 2:
        return float(struct.unpack_from("<h", src, pos)[0]), pos + 2
    if nbytes == 4:
        return float(struct.unpack_from("<f", src, pos)[0]), pos + 4
    raise ValueError("bad float width")


def _read_legacy_stuffed(src: memoryview, pos: int) -> tuple[np.ndarray, int]:
    """Legacy BitStuffer::read (BitStuffer.cpp:32-115)."""
    num_bits_byte = src[pos]
    pos += 1
    bits67 = num_bits_byte >> 6
    n = 4 if bits67 == 0 else 3 - bits67
    num_bits = num_bits_byte & 63
    num_elements = int.from_bytes(src[pos : pos + n], "little")
    pos += n
    if num_bits >= 32:
        raise ValueError("corrupt legacy bitstuffer block")
    vals, used = bit_unpack_legacy(src[pos:], num_elements, num_bits)
    return vals, pos + used


def read_header(src: memoryview) -> tuple[int, int, float]:
    if bytes(src[:10]) != FILE_KEY_LERC1:
        raise ValueError("not a Lerc1 blob")
    version, typ, height, width = struct.unpack_from("<4i", src, 10)
    (max_z_error,) = struct.unpack_from("<d", src, 26)
    if version != 11 or typ != _TYPE_CNT_Z:
        raise ValueError("unsupported Lerc1 version/type")
    if height < 0 or width < 0 or height > 40000 or width > 40000:
        raise ValueError("Lerc1 dimensions out of range")
    return height, width, max_z_error


def _decode_band(
    src: memoryview,
    pos: int,
    height: int,
    width: int,
    max_z_error: float,
    only_z: bool,
    cnt: np.ndarray,
    z: np.ndarray,
) -> tuple[int, bool]:
    """Decode one band (cnt+z, or z only). Returns (pos, decoder_can_ignore_mask)."""
    ignore_mask = False
    for part in range(2):
        z_part = part == 1
        if not z_part and only_z:
            continue
        ntv, nth, num_bytes = struct.unpack_from("<3i", src, pos)
        (max_val,) = struct.unpack_from("<f", src, pos + 12)
        pos += 16
        payload_end = pos + num_bytes
        if num_bytes < 0 or payload_end > len(src):
            raise ValueError("truncated Lerc1 section")

        if not z_part and ntv == 0 and nth == 0:  # cnt part not tiled
            if num_bytes == 0:
                cnt[:] = max_val
                if max_val > 0:
                    ignore_mask = True
            else:
                bits = rle.decompress(src[pos:payload_end], mask_size_bytes(width, height))
                cnt[:] = bits_to_bool(bits, width, height).astype(np.float32)
        else:
            _read_tiles(src, pos, z_part, max_z_error, ntv, nth, max_val, cnt, z, ignore_mask)
        pos = payload_end
    return pos, ignore_mask


def _tile_ranges(total: int, num_tiles: int):
    t = total // num_tiles
    for k in range(num_tiles + 1):
        size = t if k < num_tiles else total % num_tiles
        if size:
            yield k * t, k * t + size


def _read_tiles(src, pos, z_part, max_z_error, ntv, nth, max_val, cnt, z, ignore_mask):
    height, width = cnt.shape
    if ntv <= 0 or nth <= 0 or ntv > height or nth > width:
        raise ValueError("bad Lerc1 tile counts")
    for i0, i1 in _tile_ranges(height, ntv):
        for j0, j1 in _tile_ranges(width, nth):
            if z_part:
                pos = _read_z_tile(src, pos, i0, i1, j0, j1, max_z_error, max_val, cnt, z, ignore_mask)
            else:
                pos = _read_cnt_tile(src, pos, i0, i1, j0, j1, cnt)
    return pos


def _read_cnt_tile(src, pos, i0, i1, j0, j1, cnt):
    flag = src[pos]
    pos += 1
    if flag == 2:  # const 0 (relies on zero init)
        return pos
    if flag in (3, 4):
        cnt[i0:i1, j0:j1] = -1.0 if flag == 3 else 1.0
        return pos
    if (flag & 63) > 4:
        raise ValueError("bad Lerc1 cnt tile flag")
    n_pix = (i1 - i0) * (j1 - j0)
    if flag == 0:  # raw floats
        vals = np.frombuffer(src[pos : pos + 4 * n_pix], dtype="<f4")
        cnt[i0:i1, j0:j1] = vals.reshape(i1 - i0, j1 - j0)
        return pos + 4 * n_pix
    bits67 = flag >> 6
    n = 4 if bits67 == 0 else 3 - bits67
    offset, pos = _read_flt(src, pos, n)
    vals, pos = _read_legacy_stuffed(src, pos)
    if vals.size < n_pix:
        raise ValueError("not enough cnt values")
    cnt[i0:i1, j0:j1] = (offset + vals[:n_pix].astype(np.float32)).reshape(i1 - i0, j1 - j0)
    return pos


def _read_z_tile(src, pos, i0, i1, j0, j1, max_z_error, max_z_img, cnt, z, ignore_mask):
    flag = src[pos]
    pos += 1
    bits67 = flag >> 6
    flag &= 63
    sub_cnt = cnt[i0:i1, j0:j1]
    valid = sub_cnt > 0
    if flag == 2:  # const 0
        z[i0:i1, j0:j1][valid] = 0.0
        return pos
    if flag > 3:
        raise ValueError("bad Lerc1 z tile flag")
    if flag == 0:  # raw floats at valid pixels
        n_valid = int(np.count_nonzero(valid))
        vals = np.frombuffer(src[pos : pos + 4 * n_valid], dtype="<f4")
        z[i0:i1, j0:j1][valid] = vals
        return pos + 4 * n_valid
    n = 4 if bits67 == 0 else 3 - bits67
    offset, pos = _read_flt(src, pos, n)
    if flag == 3:  # const offset
        z[i0:i1, j0:j1][valid] = np.float32(offset)
        return pos
    vals, pos = _read_legacy_stuffed(src, pos)
    inv_scale = 2.0 * max_z_error
    if ignore_mask:
        n_pix = (i1 - i0) * (j1 - j0)
        if vals.size < n_pix:
            raise ValueError("not enough z values")
        zz = (offset + vals[:n_pix].astype(np.float64) * inv_scale).astype(np.float32)
        z[i0:i1, j0:j1] = np.minimum(zz, max_z_img).reshape(i1 - i0, j1 - j0)
    else:
        n_valid = int(np.count_nonzero(valid))
        if vals.size < n_valid:
            raise ValueError("not enough z values")
        zz = (offset + vals[:n_valid].astype(np.float64) * inv_scale).astype(np.float32)
        z[i0:i1, j0:j1][valid] = np.minimum(zz, max_z_img)
    return pos


def decode_all_bands(src: memoryview):
    """Returns (list of (cnt, z) float32 arrays, height, width, maxZError).
    Truncated wires surface as ValueError, never struct.error/IndexError
    (graceful-rejection contract, as the reference bails with false from
    CntZImage::read on short buffers)."""
    try:
        return _decode_all_bands(src)
    except (struct.error, IndexError) as e:
        raise ValueError(f"truncated Lerc1 blob: {e}") from e


def _decode_all_bands(src: memoryview):
    height, width, max_z_error = read_header(src)
    pos = 10 + 4 * 4 + 8
    bands = []
    cnt = np.zeros((height, width), dtype=np.float32)
    z = np.zeros((height, width), dtype=np.float32)
    only_z = False
    # header size for a z-only band, as in computeNumBytesNeededToReadHeader(true)
    hdr_next_band = _HDR + 3 * 4 + 4 + 1
    while pos + (hdr_next_band if only_z else 0) < len(src):
        if only_z:
            # re-read the blob header for each subsequent band
            if bytes(src[pos : pos + 10]) != FILE_KEY_LERC1:
                break
            h2, w2, mze2 = read_header(src[pos:])
            if h2 != height or w2 != width:
                raise ValueError("inconsistent Lerc1 band header")
            pos += _HDR
            max_z_error = mze2
        pos, _ = _decode_band(src, pos, height, width, max_z_error, only_z, cnt, z)
        bands.append((cnt.copy(), z.copy()))
        only_z = True
        if pos >= len(src):
            break
    if not bands:
        raise ValueError("no Lerc1 bands decoded")
    return bands, height, width, max_z_error


def get_info(src: memoryview):
    from .orchestrator import LercInfo

    bands, height, width, max_z_error = decode_all_bands(src)
    info = LercInfo(
        version=0, dt=DataType.FLOAT, n_depth=1, n_cols=width, n_rows=height,
        n_bands=len(bands), is_lerc1=True, max_z_error=max_z_error,
        blob_size=len(src),
    )
    z_min, z_max = np.inf, -np.inf
    for cnt, z in bands:
        valid = cnt > 0
        nv = int(np.count_nonzero(valid))
        info.num_valid_pixel = nv
        if nv:
            z_min = min(z_min, float(z[valid].min()))
            z_max = max(z_max, float(z[valid].max()))
        info.n_masks = 1 if nv < height * width else 0
    info.z_min, info.z_max = z_min, z_max
    return info


def decode_blob(src: memoryview):
    from .orchestrator import DecodeResult

    bands, height, width, _ = decode_all_bands(src)
    info = get_info(src)
    n_bands = len(bands)
    data = np.zeros((n_bands, height, width, 1), dtype=np.float32)
    masks = np.zeros((n_bands, height, width), dtype=bool)
    for i, (cnt, z) in enumerate(bands):
        masks[i] = cnt > 0
        data[i, :, :, 0] = np.where(masks[i], z, 0.0)
    return DecodeResult(
        info, data, masks,
        np.zeros(n_bands, dtype=bool), np.zeros(n_bands, dtype=np.float64),
    )


def convert(data: np.ndarray, mask: np.ndarray, np_dtype) -> np.ndarray:
    """Convert decoded Lerc1 float32 pixels to the caller's dtype with the
    reference's semantics (Lerc.cpp:794-842 Convert): float targets cast,
    integer targets use floor(z + 0.5) round-half-up; invalid pixels stay
    zero. This is the lerc_decode(dataType != float) analog the C API
    offers for Lerc1 blobs."""
    np_dtype = np.dtype(np_dtype)
    if np_dtype == np.float32:
        return data.copy()
    if np_dtype.kind == "f":
        out = data.astype(np_dtype)
    else:
        out = np.floor(data.astype(np.float64) + 0.5).astype(np_dtype)
    out[~mask] = 0
    return out
