"""The reference library's three golden blobs and its own decode of them.

Both come from bindings/js/test/vectors.json (written by
bindings/js/make_test_vectors.py with the reference C++ library), so tests
that need the golden files or the reference's decoded output run from the
repository alone.
"""
from __future__ import annotations

import base64
import functools
import json
import pathlib

import numpy as np

VECTORS = pathlib.Path(__file__).resolve().parents[1] / "bindings" / "js" / "test" / "vectors.json"

# reference testData file name -> vector name
_NAMES = {
    "california_400_400_1_float.lerc2": "golden-california",
    "bluemarble_256_256_3_byte.lerc2": "golden-bluemarble",
    "world.lerc1": "golden-world-lerc1",
}

_DT_NUMPY = [np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32,
             np.float32, np.float64]


@functools.cache
def _vectors() -> dict:
    with open(VECTORS) as f:
        return {v["name"]: v for v in json.load(f)}


def blob(name: str) -> bytes:
    """The golden blob by its reference testData file name."""
    return base64.b64decode(_vectors()[_NAMES[name]]["blob"])


def expected(name: str):
    """The reference's decode of a golden blob: (data [nBands, H, W, D] in
    the stored dtype, masks [nBands, H, W] bool or None, expected dict)."""
    exp = _vectors()[_NAMES[name]]["expected"]
    shape = (exp["height"], exp["width"], exp["depth"])
    dt = _DT_NUMPY[exp["dtype"]]
    data = np.stack([np.frombuffer(base64.b64decode(p), dt).reshape(shape)
                     for p in exp["pixels"]])
    masks = None
    if exp["masks"] is not None:
        masks = np.stack([np.frombuffer(base64.b64decode(m), np.uint8)
                          .reshape(shape[:2]).astype(bool) for m in exp["masks"]])
    return data, masks, exp
