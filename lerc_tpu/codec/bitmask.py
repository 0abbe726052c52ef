"""Validity bit-mask helpers: 1 bit per pixel, MSB-first within each byte.

Bit layout matches lerc/src/LercLib/BitMask.h:67
(`bit(k) = 0x80 >> (k & 7)`), which is numpy's default "big" bitorder.
"""
from __future__ import annotations

import numpy as np


def mask_size_bytes(n_cols: int, n_rows: int) -> int:
    return (n_cols * n_rows + 7) >> 3


def bool_to_bits(mask: np.ndarray) -> np.ndarray:
    """[nRows, nCols] or flat bool array -> packed uint8 bit array (MSB-first).

    Trailing pad bits in the last byte are set to 1, matching the reference
    encoder's SetAllValid-then-clear construction (BitMask.cpp:54-62) so the
    RLE'd mask section is byte-identical.
    """
    flat = mask.ravel().astype(bool)
    bits = np.packbits(flat)
    pad = (-flat.size) % 8
    if pad:
        bits = bits.copy()
        bits[-1] |= (1 << pad) - 1
    return bits


def bits_to_bool(bits: np.ndarray | bytes, n_cols: int, n_rows: int) -> np.ndarray:
    """Packed uint8 bit array -> [nRows, nCols] bool array."""
    arr = np.frombuffer(memoryview(bits), dtype=np.uint8) if not isinstance(bits, np.ndarray) else bits
    flat = np.unpackbits(arr, count=n_cols * n_rows).astype(bool)
    return flat.reshape(n_rows, n_cols)


def count_valid(mask: np.ndarray) -> int:
    return int(np.count_nonzero(mask))
