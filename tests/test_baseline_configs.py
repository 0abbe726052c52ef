"""Scaled-down versions of the BASELINE.json validation configs that are
too large for CI (the full sizes run on real hardware via bench.py and the
mosaic path):

  3. synthetic float32 DEM with NaN + noData mask, maxZError sweep
  4. 4D raster [4 bands, H, W, nDepth=8] via the *_4D API with mixed
     valid/invalid per-pixel arrays (noData values)
"""
import numpy as np
import pytest

import lerc_tpu as lerc

from . import oracle


@pytest.mark.parametrize("mze", [0.0, 0.001, 0.1])
def test_config3_dem_nan_mask_sweep(mze):
    rng = np.random.default_rng(77)
    h, w = 512, 512  # scaled from 4096^2
    x = np.linspace(0, 20, w)[None, :]
    y = np.linspace(0, 15, h)[:, None]
    dem = (1500 * np.exp(-((x - 10) ** 2 + (y - 7) ** 2) / 20)
           + 50 * np.sin(x) * np.cos(y)
           + 0.5 * rng.standard_normal((h, w))).astype(np.float32)
    mask = rng.random((h, w)) > 0.1
    dem_nan = dem.copy()
    nan_sel = (~mask) | (rng.random((h, w)) < 0.02)  # NaNs also inside mask
    dem_nan[nan_sel] = np.nan

    r, n, blob = lerc.encode(dem_nan, 1, True, mask, mze, dem.nbytes * 2)
    assert r == 0
    blob = bytes(blob[:n])
    r2, out, m2 = lerc.decode(blob)
    assert r2 == 0
    m2 = np.asarray(m2, bool).reshape(h, w)
    eff = mask & ~nan_sel  # NaNs inside the mask get masked out
    np.testing.assert_array_equal(m2, eff)
    err = np.abs(np.asarray(out).reshape(h, w)[eff].astype(np.float64)
                 - dem[eff]).max()
    limit = 0 if mze == 0 else mze * 1.1
    assert err <= limit, (err, limit)
    if oracle.available():
        ref = oracle.decode(blob)[0].reshape(h, w)
        np.testing.assert_array_equal(ref[eff], np.asarray(out).reshape(h, w)[eff])


def test_config4_4d_mixed_nodata():
    rng = np.random.default_rng(79)
    n_bands, h, w, nd = 4, 128, 160, 8  # scaled from [4, 2048, 2048, 8]
    data = rng.normal(100, 30, (n_bands, h, w, nd)).astype(np.float32)
    # mixed valid/invalid per-pixel arrays: some depth entries hold noData
    no_data = np.ma.masked_array([-9999.0, -9999.0, -9999.0, -9999.0],
                                 [False, False, True, True])
    mixed = rng.random((n_bands, h, w, nd)) < 0.05
    mixed[2:] = False  # bands without a noData value stay clean
    data[mixed] = -9999.0

    r, n, blob = lerc.encode_4D(data, nd, None, 0.001, data.nbytes * 2, no_data)
    assert r == 0
    blob = bytes(blob[:n])
    out = lerc.decode_4D(blob)
    r2, arr, masks, nd_out = out[0], out[1], out[2], out[3]
    assert r2 == 0
    arr = np.asarray(arr).reshape(n_bands, h, w, nd)
    # noData entries round-trip exactly; the rest within the bound
    np.testing.assert_array_equal(arr[mixed], np.full(mixed.sum(), -9999.0, np.float32))
    clean = ~mixed
    err = np.abs(arr[clean].astype(np.float64) - data[clean]).max()
    assert err <= 0.001 * 1.1
    if oracle.available():
        dec = oracle.decode(blob)[0].reshape(n_bands, h, w, nd)
        np.testing.assert_array_equal(dec, arr)


def test_bench_script_smoke(tmp_path):
    """bench.py end-to-end as an explicit CPU rehearsal (tiny tiles): one
    parseable JSON line that names the CPU and says it is no device
    measurement."""
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "bench.py", "--rehearse"], capture_output=True, text=True,
        timeout=900, env=env, cwd=os.path.dirname(os.path.dirname(__file__)),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    line = out.stdout.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["unit"] == "MB/s" and rec["value"] > 0
    assert "vs_baseline" in rec and "encode_MBps" in rec
    assert rec["device"]["platform"] == "cpu"
    assert rec["metric"].startswith("CPU rehearsal")


def test_bench_script_refuses_cpu_without_rehearsal():
    """Without --rehearse the CPU is no rehearsal, even with JAX pinned to
    it: bench.py must fail and print no result."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "bench.py"], capture_output=True, text=True,
        timeout=300, env=env, cwd=os.path.dirname(os.path.dirname(__file__)),
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""
