"""Randomized Lerc1 corpus matrix: the test-only
writer (tests/lerc1_writer.py) generates fresh CntZImage blobs across cnt
styles, tile grids, masks and bands; every blob must decode identically
through the reference C++ library, our host decoder, and both binding
twins -- plus survive hostile mutations. Before this, Lerc1 coverage was
one golden blob (world.lerc1) and no encoder existed anywhere to widen it."""
import pathlib
import sys

import numpy as np
import pytest

from . import oracle
from .lerc1_writer import encode_lerc1
from lerc_tpu.codec import lerc1 as our_l1

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "bindings" / "js"))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "bindings" / "csharp"))
import js_sim  # noqa: E402
import cs_sim  # noqa: E402

pytestmark = pytest.mark.skipif(not oracle.available(), reason="reference lib not built")

RNG = np.random.default_rng(11)


def _case(trial: int):
    h = int(RNG.integers(9, 80))
    w = int(RNG.integers(9, 80))
    mze = float(RNG.choice([0.0, 0.01, 0.5, 2.0]))
    nb = int(RNG.integers(1, 4))
    x, y = np.meshgrid(np.linspace(0, 6, w), np.linspace(0, 5, h))
    bands = [(np.sin(x * (b + 1)) * 300 + y * 40
              + RNG.normal(0, 5, (h, w))).astype(np.float32) for b in range(nb)]
    if trial % 6 == 0:  # const bands: const-offset / const-0 tiles
        bands = [np.full((h, w), np.float32(RNG.normal()), np.float32)
                 for _ in range(nb)]
    style = ["const", "rle", "tiled", "auto"][trial % 4]
    mask = None
    if style != "const" and trial % 3 != 0:
        mask = RNG.random((h, w)) > 0.25
        if not mask.any():
            mask[0, 0] = True
    grid = (int(RNG.integers(1, h + 1)), int(RNG.integers(1, w + 1)))
    blob = encode_lerc1(bands, mask, mze, cnt_style=style, grid=grid, seed=trial)
    m = np.ones((h, w), bool) if mask is None else mask
    tol = mze * 1.01 if mze else 1e-6
    return blob, bands, m, tol, (h, w, nb)


@pytest.mark.parametrize("trial", range(12))
def test_lerc1_writer_three_decoders(trial):
    blob, bands, m, tol, (h, w, nb) = _case(trial)

    # reference oracle: the ground truth that certifies the writer's wire
    ref = oracle.decode(blob)
    got = ref[0].reshape(nb, h, w)
    gm = (np.ones((h, w), bool) if ref[1] is None
          else np.asarray(ref[1]).reshape(-1, h, w)[0].astype(bool))
    assert np.array_equal(gm, m)
    for b in range(nb):
        assert np.abs(got[b][m] - bands[b][m]).max() <= tol

    # our host decoder agrees bit-for-bit with the reference
    r = our_l1.decode_blob(memoryview(blob))
    for b in range(nb):
        assert np.array_equal(r.masks[b], m)
        assert np.array_equal(r.data[b, :, :, 0][m], got[b][m])

    # JS twin
    js = js_sim.decode(blob)
    assert js["width"] == w and js["height"] == h and len(js["pixels"]) == nb
    for b in range(nb):
        band = np.asarray(js["pixels"][b], np.float32).reshape(h, w)
        assert np.array_equal(band[m], got[b][m])

    # C# twin through the C-API surface
    data = np.zeros(nb * h * w, np.float32)
    masks = np.zeros(h * w, np.uint8)
    n_masks = 0 if m.all() else 1
    rc = cs_sim.lerc_decode(blob, len(blob), n_masks,
                            masks if n_masks else None, 1, w, h, nb, 6, data)
    assert rc == cs_sim.OK
    cgot = data.reshape(nb, h, w)
    if n_masks:
        assert np.array_equal(masks.reshape(h, w).astype(bool), m)
    for b in range(nb):
        assert np.array_equal(cgot[b][m], got[b][m])


def test_lerc1_writer_convert_dtypes():
    """decode_to_dtype's Lerc1 conversion (floor(z+0.5) for ints) on
    writer-generated data with negative values."""
    from lerc_tpu import api

    h, w = 31, 47
    z = (RNG.random((h, w)) * 200 - 100).astype(np.float32)
    blob = encode_lerc1(z, None, 0.01, seed=5)
    for np_dt in (np.int16, np.int32, np.float64):
        code, data, _mask = api.decode_to_dtype(blob, np_dt)
        assert code == 0
        ref = our_l1.decode_blob(memoryview(blob))
        want = our_l1.convert(ref.data[0, :, :, 0], ref.masks[0], np_dt)
        assert np.array_equal(np.asarray(data).reshape(h, w), want)


@pytest.mark.parametrize("kind", ["trunc", "flip", "header"])
def test_lerc1_writer_hostile(kind):
    """Mutated writer blobs must never escape as a non-ValueError from the
    host decoder; the binding twins must error cleanly or decode."""
    blob, *_ = _case(1)
    muts = []
    if kind == "trunc":
        muts = [blob[:k] for k in (11, 26, 40, len(blob) // 2, len(blob) - 3)]
    elif kind == "flip":
        idx = RNG.integers(30, len(blob), 12)
        muts = [blob[:i] + bytes([blob[i] ^ 0xFF]) + blob[i + 1:] for i in idx]
    else:
        muts = [b"CntZImage " + blob[10:30], blob[:10] + b"\xff" * 24 + blob[34:]]
    for bad in muts:
        try:
            our_l1.decode_blob(memoryview(bad))
        except ValueError:
            pass  # graceful rejection
        try:
            js_sim.decode(bad)
        except js_sim.LercError:
            pass
        data = np.zeros(4096 * 8, np.float32)
        rc = cs_sim.lerc_decode(bad, len(bad), 0, None, 1, 64, 64, 1, 6, data)
        assert rc in (cs_sim.OK, cs_sim.FAILED, cs_sim.WRONG_PARAM,
                      cs_sim.BUFFER_TOO_SMALL)
