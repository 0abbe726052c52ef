"""Core constants of the LERC wire format, re-derived for the JAX engine.

Wire-format semantics follow the reference implementation (Esri/lerc):
  - data types:        lerc/src/LercLib/Lerc2.h:100
  - file keys:         lerc/src/LercLib/Lerc2.h:162,
                       lerc/src/LercLib/Lerc1Decode/CntZImage.cpp:73
  - size limits:       lerc/src/LercLib/Lerc2.cpp:897-911
  - quantize caps:     lerc/src/LercLib/Lerc2.h:686-703
"""
from __future__ import annotations

import enum

import numpy as np

CURRENT_VERSION = 6
FILE_KEY_LERC2 = b"Lerc2 "
FILE_KEY_LERC1 = b"CntZImage "

MICRO_BLOCK_SIZE = 8  # doubled to 16 when the bitrate is low; decoder accepts <= 32
MAX_MICRO_BLOCK_SIZE = 32

# Per-band input data limit (2 GB) and blob limits (2 GB / band, 4 GB total).
MAX_BYTES_PER_BAND = 0x7FFFFFFF
MAX_BLOB_BYTES_TOTAL = 0xFFFFFFFF


class DataType(enum.IntEnum):
    """Pixel data types, wire codes 0..7 (Lerc2.h:100)."""

    CHAR = 0
    BYTE = 1
    SHORT = 2
    USHORT = 3
    INT = 4
    UINT = 5
    FLOAT = 6
    DOUBLE = 7


DT_TO_NUMPY = {
    DataType.CHAR: np.int8,
    DataType.BYTE: np.uint8,
    DataType.SHORT: np.int16,
    DataType.USHORT: np.uint16,
    DataType.INT: np.int32,
    DataType.UINT: np.uint32,
    DataType.FLOAT: np.float32,
    DataType.DOUBLE: np.float64,
}

NUMPY_TO_DT = {np.dtype(v): DataType(k) for k, v in DT_TO_NUMPY.items()}

DT_SIZE = {
    DataType.CHAR: 1,
    DataType.BYTE: 1,
    DataType.SHORT: 2,
    DataType.USHORT: 2,
    DataType.INT: 4,
    DataType.UINT: 4,
    DataType.FLOAT: 4,
    DataType.DOUBLE: 8,
}


def dt_is_int(dt: DataType) -> bool:
    return dt < DataType.FLOAT


def max_val_to_quantize(dt: DataType) -> int:
    """Quantized values above this cap force raw block encoding (Lerc2.h:686-703)."""
    if dt in (DataType.CHAR, DataType.BYTE, DataType.SHORT, DataType.USHORT):
        return (1 << 15) - 1
    return (1 << 30) - 1


class ErrCode(enum.IntEnum):
    """Error codes of the public API (Lerc_types.h:11-20)."""

    OK = 0
    FAILED = 1
    WRONG_PARAM = 2
    BUFFER_TOO_SMALL = 3
    NAN = 4
    HAS_NO_DATA = 5
    DIMENSIONS_TOO_LARGE = 6


class ImageEncodeMode(enum.IntEnum):
    """Whole-image encode modes (Lerc2.h:143)."""

    TILING = 0
    DELTA_HUFFMAN = 1
    HUFFMAN = 2
    DELTA_DELTA_HUFFMAN = 3  # v6 lossless float path


class BlockEncodeMode(enum.IntEnum):
    """Per-micro-block encode modes (Lerc2.h:144)."""

    RAW_BINARY = 0
    BITSTUFF_SIMPLE = 1
    BITSTUFF_LUT = 2
