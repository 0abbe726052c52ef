"""Multi-band blob orchestration: info walk, decode loop, noData remap.

Mirrors the semantics of the reference orchestrator class Lerc
(lerc/src/LercLib/Lerc.cpp): GetLercInfo (Lerc.cpp:92-271),
DecodeTempl (Lerc.cpp:397-521), RemapNoData (Lerc.cpp:1047-1076).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import DataType, DT_TO_NUMPY, FILE_KEY_LERC2, FILE_KEY_LERC1
from . import header as hdr
from . import lerc2_decode
from .. import profiling


@dataclasses.dataclass
class LercInfo:
    version: int = 0
    dt: DataType = DataType.FLOAT
    n_depth: int = 1
    n_cols: int = 0
    n_rows: int = 0
    n_bands: int = 0
    num_valid_pixel: int = 0
    blob_size: int = 0
    n_masks: int = 0
    n_uses_no_data: int = 0
    z_min: float = 0.0
    z_max: float = 0.0
    max_z_error: float = 0.0
    is_lerc1: bool = False
    band_offsets: list[int] = dataclasses.field(default_factory=list)


def get_lerc_info(blob: bytes | memoryview) -> LercInfo:
    """Walk all band headers (fast, header reads only). Lerc.cpp:92-182."""
    src = memoryview(blob)
    if bytes(src[: len(FILE_KEY_LERC2)]) == FILE_KEY_LERC2:
        return _get_lerc2_info(src)
    if bytes(src[: len(FILE_KEY_LERC1)]) == FILE_KEY_LERC1:
        from . import lerc1

        return lerc1.get_info(src)
    raise ValueError("not a LERC blob")


def _get_lerc2_info(src: memoryview) -> LercInfo:
    hd, pos = hdr.read_header(src)
    num_bytes_mask = int.from_bytes(src[pos : pos + 4], "little", signed=True)
    if num_bytes_mask < 0:
        raise ValueError("negative mask size")
    b_has_mask = num_bytes_mask > 0

    info = LercInfo(
        version=hd.version, dt=hd.dt, n_depth=hd.n_depth, n_cols=hd.n_cols,
        n_rows=hd.n_rows, num_valid_pixel=hd.num_valid_pixel, blob_size=hd.blob_size,
        z_min=hd.z_min, z_max=hd.z_max, max_z_error=hd.max_z_error,
        n_uses_no_data=1 if hd.b_pass_no_data_values else 0,
        n_bands=1, band_offsets=[0],
    )
    n_masks = 1 if (b_has_mask or hd.num_valid_pixel == 0) else 0
    try_next = hd.version <= 5 or hd.n_blobs_more > 0
    if info.blob_size > len(src):
        raise ValueError("truncated blob")

    while try_next and info.blob_size < len(src):
        try:
            hd2, pos2 = hdr.read_header(src[info.blob_size :])
        except ValueError:
            break
        if (
            hd2.n_depth != info.n_depth or hd2.n_cols != info.n_cols
            or hd2.n_rows != info.n_rows or hd2.dt != info.dt
        ):
            raise ValueError("inconsistent band headers")
        try_next = hd2.version <= 5 or hd2.n_blobs_more > 0
        if hd2.b_pass_no_data_values:
            info.n_uses_no_data += 1
        nb_mask2 = int.from_bytes(
            src[info.blob_size + pos2 : info.blob_size + pos2 + 4], "little", signed=True
        )
        if nb_mask2 > 0 or hd2.num_valid_pixel != info.num_valid_pixel:
            n_masks = 2
        if info.blob_size + hd2.blob_size > len(src):
            raise ValueError("truncated blob")
        info.z_min = min(info.z_min, hd2.z_min)
        info.z_max = max(info.z_max, hd2.z_max)
        info.max_z_error = max(info.max_z_error, hd2.max_z_error)
        info.band_offsets.append(info.blob_size)
        info.blob_size += hd2.blob_size
        info.n_bands += 1

    info.n_masks = info.n_bands if n_masks > 1 else n_masks
    if info.n_uses_no_data > 0:
        info.n_uses_no_data = info.n_bands
    return info


@dataclasses.dataclass
class DecodeResult:
    info: LercInfo
    data: np.ndarray  # [nBands, nRows, nCols, nDepth]
    masks: np.ndarray  # [nBands, nRows, nCols] bool (per-band valid masks)
    uses_no_data: np.ndarray  # [nBands] bool
    no_data_values: np.ndarray  # [nBands] float64 (original noData per band)


@profiling.profiled("decode_blob")
def decode_blob(blob: bytes | memoryview, verify_checksum: bool = True) -> DecodeResult:
    src = memoryview(blob)
    if bytes(src[: len(FILE_KEY_LERC1)]) == FILE_KEY_LERC1:
        from . import lerc1

        return lerc1.decode_blob(src)

    info = get_lerc_info(src)
    n_bands = info.n_bands
    np_dt = DT_TO_NUMPY[info.dt]
    data = np.zeros((n_bands, info.n_rows, info.n_cols, info.n_depth), dtype=np_dt)
    masks = np.zeros((n_bands, info.n_rows, info.n_cols), dtype=bool)
    uses_no_data = np.zeros(n_bands, dtype=bool)
    no_data_values = np.zeros(n_bands, dtype=np.float64)

    # device-decoder routing for big bands on an accelerator backend (the
    # native scanner + XLA kernels). decode_band_device returns None for a
    # layout it does not handle and raises ValueError for a corrupt blob,
    # which the host decoder then reports the same way; any other error
    # from the device path propagates.
    from .encode_orchestrator import _ACCEL_MIN_PIXELS, ROUTES, _accel_enabled

    use_device = (
        _accel_enabled() and info.n_rows * info.n_cols >= _ACCEL_MIN_PIXELS
    )
    if use_device:
        from . import device_codec

    pos = 0
    prev_mask = None
    for i_band in range(n_bands):
        band = None
        if use_device:
            try:
                band = device_codec.decode_band_device(
                    src[pos:], prev_mask, verify_checksum
                )
            except ValueError:
                band = None
        ROUTES["decode", "host" if band is None else "device"] += 1
        if band is None:
            band = lerc2_decode.decode_band(src[pos:], prev_mask, verify_checksum)
        data[i_band] = band.data
        masks[i_band] = band.mask
        prev_mask = band.mask
        hd = band.hd
        if hd.b_pass_no_data_values:
            uses_no_data[i_band] = True
            no_data_values[i_band] = hd.no_data_val_orig
            _remap_no_data(data[i_band], band.mask, hd)
        pos += hd.blob_size
    return DecodeResult(info, data, masks, uses_no_data, no_data_values)


def _remap_no_data(band_data: np.ndarray, mask: np.ndarray, hd: hdr.HeaderInfo) -> None:
    """Map the internal noData value back to the original (Lerc.cpp:1047-1076)."""
    np_dt = band_data.dtype.type
    no_data_old = np_dt(hd.no_data_val)
    no_data_new = np_dt(hd.no_data_val_orig)
    if no_data_old == no_data_new:
        return
    sel = mask[:, :, None] & (band_data == no_data_old)
    band_data[sel] = no_data_new
