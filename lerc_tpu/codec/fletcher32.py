"""Fletcher-32 checksum over byte blobs, vectorized.

Matches the modified-Fletcher used by the reference codec
(lerc/src/LercLib/Lerc2.cpp:1037-1064): bytes are paired
big-endian into 16-bit words, sums start at 0xffff, and an odd trailing
byte is treated as (byte << 8).

Instead of the serial fold-every-359-words loop we compute the two sums
with 64-bit chunked reductions, reducing mod 65535 between chunks. The
true (unfolded) sums are always > 0, so the reference's double-fold
representative of x is 65535 when x % 65535 == 0 and x % 65535 otherwise.
"""
from __future__ import annotations

import numpy as np

_CHUNK = 1 << 20  # words per chunk; keeps the weighted sum < 2^52


def _rep(x_mod: int) -> int:
    return 65535 if x_mod == 0 else x_mod


def fletcher32(data: bytes | bytearray | memoryview | np.ndarray) -> int:
    try:
        from .. import native

        if native.available():
            return native.fletcher32(data)
    except Exception:
        pass
    return _fletcher32_numpy(data)


def _fletcher32_numpy(data: bytes | bytearray | memoryview | np.ndarray) -> int:
    buf = np.frombuffer(memoryview(data), dtype=np.uint8)
    n = buf.size
    nwords = n // 2
    hi = buf[0 : 2 * nwords : 2].astype(np.uint64)
    lo = buf[1 : 2 * nwords : 2].astype(np.uint64)
    words = (hi << np.uint64(8)) | lo
    if n & 1:
        words = np.concatenate([words, np.array([int(buf[-1]) << 8], dtype=np.uint64)])
    m = words.size

    s1 = 0xFFFF % 65535  # == 0
    s2 = 0xFFFF % 65535
    for start in range(0, m, _CHUNK):
        chunk = words[start : start + _CHUNK]
        b = chunk.size
        w = np.arange(b, 0, -1, dtype=np.uint64)
        csum = int(chunk.sum())
        cwsum = int(np.multiply(w, chunk, dtype=np.uint64).sum())
        s2 = (s2 + b * s1 + cwsum) % 65535
        s1 = (s1 + csum) % 65535
    return (_rep(s2) << 16 | _rep(s1)) & 0xFFFFFFFF
