"""ctypes binding to the reference C++ LERC library, used as a cross-
implementation oracle in tests (built from an Esri/lerc checkout into ref_build/).

API shapes follow lerc/src/LercLib/include/Lerc_c_api.h.
"""
from __future__ import annotations

import ctypes as ct
import functools
import os

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "ref_build", "libLerc.so")

DT_NUMPY = {
    0: np.int8, 1: np.uint8, 2: np.int16, 3: np.uint16,
    4: np.int32, 5: np.uint32, 6: np.float32, 7: np.float64,
}
NUMPY_DT = {np.dtype(v): k for k, v in DT_NUMPY.items()}


@functools.lru_cache(maxsize=1)
def lib():
    return ct.CDLL(os.path.abspath(_LIB_PATH))


def available() -> bool:
    try:
        lib()
        return True
    except OSError:
        return False


def _as_mask_ptr(masks: np.ndarray | None):
    if masks is None:
        return None
    return masks.astype(np.uint8).ctypes.data_as(ct.POINTER(ct.c_ubyte))


def encode(
    data: np.ndarray,
    n_depth: int,
    n_cols: int,
    n_rows: int,
    n_bands: int,
    masks: np.ndarray | None,
    max_z_err: float,
    version: int = -1,
    uses_nodata: np.ndarray | None = None,
    nodata: np.ndarray | None = None,
) -> bytes:
    data = np.ascontiguousarray(data)
    n_masks = 0 if masks is None else (1 if masks.ndim == 2 or masks.shape[0] == 1 else masks.shape[0])
    if masks is not None:
        masks = np.ascontiguousarray(masks, dtype=np.uint8)
    dt = NUMPY_DT[data.dtype]
    buf_size = data.nbytes * 2 + (1 << 20)
    out = (ct.c_ubyte * buf_size)()
    nwritten = ct.c_uint(0)
    use_4d = uses_nodata is not None
    if use_4d:
        un = np.ascontiguousarray(uses_nodata, dtype=np.uint8)
        nd = np.ascontiguousarray(nodata, dtype=np.float64)
        rv = lib().lerc_encode_4D(
            data.ctypes.data_as(ct.c_void_p), ct.c_uint(dt), n_depth, n_cols, n_rows,
            n_bands, n_masks, _as_mask_ptr(masks), ct.c_double(max_z_err),
            out, ct.c_uint(buf_size), ct.byref(nwritten),
            un.ctypes.data_as(ct.POINTER(ct.c_ubyte)), nd.ctypes.data_as(ct.POINTER(ct.c_double)),
        )
    elif version != -1:
        rv = lib().lerc_encodeForVersion(
            data.ctypes.data_as(ct.c_void_p), ct.c_int(version), ct.c_uint(dt), n_depth,
            n_cols, n_rows, n_bands, n_masks, _as_mask_ptr(masks), ct.c_double(max_z_err),
            out, ct.c_uint(buf_size), ct.byref(nwritten),
        )
    else:
        rv = lib().lerc_encode(
            data.ctypes.data_as(ct.c_void_p), ct.c_uint(dt), n_depth, n_cols, n_rows,
            n_bands, n_masks, _as_mask_ptr(masks), ct.c_double(max_z_err),
            out, ct.c_uint(buf_size), ct.byref(nwritten),
        )
    if rv != 0:
        raise RuntimeError(f"reference lerc_encode failed with ErrCode {rv}")
    return bytes(out[: nwritten.value])


def blob_info(blob: bytes) -> dict:
    info = (ct.c_uint * 11)()
    ranges = (ct.c_double * 3)()
    rv = lib().lerc_getBlobInfo(
        ct.cast(blob, ct.POINTER(ct.c_ubyte)), ct.c_uint(len(blob)), info, ranges, 11, 3
    )
    if rv != 0:
        raise RuntimeError(f"reference lerc_getBlobInfo failed with ErrCode {rv}")
    keys = [
        "version", "dataType", "nDim", "nCols", "nRows", "nBands", "nValidPixels",
        "blobSize", "nMasks", "nDepth", "nUsesNoDataValue",
    ]
    d = {k: int(info[i]) for i, k in enumerate(keys)}
    d["zMin"], d["zMax"], d["maxZErrUsed"] = ranges[0], ranges[1], ranges[2]
    return d


def data_ranges(blob: bytes, n_depth: int, n_bands: int) -> tuple[np.ndarray, np.ndarray]:
    mins = np.zeros(n_depth * n_bands, dtype=np.float64)
    maxs = np.zeros(n_depth * n_bands, dtype=np.float64)
    rv = lib().lerc_getDataRanges(
        ct.cast(blob, ct.POINTER(ct.c_ubyte)), ct.c_uint(len(blob)), n_depth, n_bands,
        mins.ctypes.data_as(ct.POINTER(ct.c_double)), maxs.ctypes.data_as(ct.POINTER(ct.c_double)),
    )
    if rv != 0:
        raise RuntimeError(f"reference lerc_getDataRanges failed with ErrCode {rv}")
    return mins, maxs


def decode(blob: bytes, info: dict | None = None):
    """Returns (data [nBands, nRows, nCols, nDepth], masks [nMasks, nRows, nCols] or None,
    uses_nodata, nodata)."""
    if info is None:
        info = blob_info(blob)
    n_depth, n_cols, n_rows = info["nDepth"], info["nCols"], info["nRows"]
    n_bands, n_masks = info["nBands"], info["nMasks"]
    dt = info["dataType"]
    data = np.zeros((n_bands, n_rows, n_cols, n_depth), dtype=DT_NUMPY[dt])
    masks = np.zeros((max(n_masks, 1), n_rows, n_cols), dtype=np.uint8)
    uses_nodata = np.zeros(n_bands, dtype=np.uint8)
    nodata = np.zeros(n_bands, dtype=np.float64)
    rv = lib().lerc_decode_4D(
        ct.cast(blob, ct.POINTER(ct.c_ubyte)), ct.c_uint(len(blob)), n_masks,
        masks.ctypes.data_as(ct.POINTER(ct.c_ubyte)), n_depth, n_cols, n_rows, n_bands,
        ct.c_uint(dt), data.ctypes.data_as(ct.c_void_p),
        uses_nodata.ctypes.data_as(ct.POINTER(ct.c_ubyte)),
        nodata.ctypes.data_as(ct.POINTER(ct.c_double)),
    )
    if rv != 0:
        raise RuntimeError(f"reference lerc_decode_4D failed with ErrCode {rv}")
    return data, (masks if n_masks > 0 else None), uses_nodata, nodata


def compute_compressed_size(
    data: np.ndarray, n_depth: int, n_cols: int, n_rows: int, n_bands: int,
    masks: np.ndarray | None, max_z_err: float,
) -> int:
    data = np.ascontiguousarray(data)
    n_masks = 0 if masks is None else (1 if masks.ndim == 2 or masks.shape[0] == 1 else masks.shape[0])
    if masks is not None:
        masks = np.ascontiguousarray(masks, dtype=np.uint8)
    nbytes = ct.c_uint(0)
    rv = lib().lerc_computeCompressedSize(
        data.ctypes.data_as(ct.c_void_p), ct.c_uint(NUMPY_DT[data.dtype]), n_depth,
        n_cols, n_rows, n_bands, n_masks, _as_mask_ptr(masks), ct.c_double(max_z_err),
        ct.byref(nbytes),
    )
    if rv != 0:
        raise RuntimeError(f"reference lerc_computeCompressedSize failed with ErrCode {rv}")
    return nbytes.value
