"""chip_smoke.py and the launch environment it checks.

* Phases 3-6 of chip_smoke.py rehearsed on the CPU at reduced sizes (the
  same check functions run at real sizes on a GPU under the `gpu` marker).
* The API's device route: a device-path error propagates, an unsupported
  configuration (DeviceUnsupported / None) routes to the host, and the
  routing counter says which route each band took.
* The launch helpers: compile cache, device check, dryrun_multichip.
* No float32 operand reaches a dot_general in the device kernels (on a GPU
  an f32 dot may run as TF32, which would break the exact one-hot routing).
"""
import functools
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_env
import chip_smoke
from lerc_tpu import api
from lerc_tpu.codec import device_codec, encode_orchestrator as eo

REPO = pathlib.Path(__file__).resolve().parents[1]
VECTORS = REPO / "bindings" / "js" / "test" / "vectors.json"


@pytest.fixture
def small_bands(monkeypatch):
    """Let rehearsal-sized bands take the API's device route."""
    monkeypatch.setattr(eo, "_ACCEL_MIN_PIXELS", 0)


# ---------------------------------------------------------------------------
# chip_smoke phases 3-6: CPU rehearsal and the GPU tier
# ---------------------------------------------------------------------------

REHEARSE = {
    "served": lambda: chip_smoke.phase_served(128),
    "resident": lambda: chip_smoke.phase_resident(64, 2),
    "kernels": lambda: chip_smoke.phase_kernels(128),
    "foreign": lambda: chip_smoke.phase_foreign(str(VECTORS)),
}

REAL = chip_smoke.REAL
ON_GPU = {
    "compile": lambda: chip_smoke.phase_compile(REAL.tile),
    "served": lambda: chip_smoke.phase_served(REAL.dem),
    "resident": lambda: chip_smoke.phase_resident(REAL.tile, REAL.n_tiles),
    "kernels": lambda: chip_smoke.phase_kernels(REAL.kernel),
    "foreign": lambda: chip_smoke.phase_foreign(str(VECTORS)),
}


@pytest.mark.parametrize("phase", sorted(REHEARSE))
def test_chip_smoke_phase_rehearsal(phase, small_bands):
    assert REHEARSE[phase]()


@pytest.mark.gpu
@pytest.mark.parametrize("phase", sorted(ON_GPU))
def test_chip_smoke_phase_on_gpu(phase, gpu):
    assert ON_GPU[phase]()


def test_lossy_tolerance_is_two_ulp_of_the_largest_value():
    orig = np.array([1500.0, -3.0], np.float32)
    valid = np.ones(2, bool)
    assert chip_smoke.lossy_tol(orig, valid, 0.001) == 0.001 + 2 * float(
        np.spacing(np.float32(1500.0)))
    assert chip_smoke.lossy_tol(orig.astype(np.float64), valid, 0.5) == 0.5 + 2 * float(
        np.spacing(1500.0))
    with pytest.raises(AssertionError):
        chip_smoke.check_lossy("x", orig + np.float32(0.0015), orig, valid, 0.001)


def _run(args, env, cwd=REPO, timeout=300):
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=cwd)


def test_chip_smoke_refuses_the_cpu_without_rehearse():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = _run(["chip_smoke.py"], env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_needs_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = _run(["chip_smoke.py", "--rehearse"], env, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_four_rehearsal_contract_line():
    """--four alone: the mesh phase and its references, last line the
    contract JSON with count 4, every line naming the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = _run(["chip_smoke.py", "--rehearse", "--four"], env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": 4}}
    assert any(line.startswith("[2] mosaic [cpu]: PASS") for line in lines)
    assert lines[-2].startswith("card [cpu]: ")
    assert all("[cpu]" in line for line in lines[:-1] if line.startswith("["))


# ---------------------------------------------------------------------------
# device route of the API: no fallback hides a device error
# ---------------------------------------------------------------------------

def _raster(n=64):
    x = np.linspace(0, 5, n)
    return (100 * np.sin(x)[:, None] * np.cos(x)[None, :]).astype(np.float32)


def _boom(*_a, **_k):
    raise RuntimeError("device failure")


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_device_error_propagates_from_api(direction, small_bands, monkeypatch):
    data = _raster()
    blob = api.encode(data, 1, False, None, 0.01, data.nbytes * 2)[2]
    target = "encode_band_device" if direction == "encode" else "decode_band_device"
    monkeypatch.setattr(device_codec, target, _boom)
    with chip_smoke.acceleration(True), pytest.raises(RuntimeError, match="device failure"):
        if direction == "encode":
            api.encode(data, 1, False, None, 0.01, data.nbytes * 2)
        else:
            api.decode(blob)


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_unsupported_configuration_routes_to_host(direction, small_bands, monkeypatch):
    data = _raster()
    blob = api.encode(data, 1, False, None, 0.01, data.nbytes * 2)[2]
    if direction == "encode":
        def unsupported(*_a, **_k):
            raise device_codec.DeviceUnsupported("configuration not supported")
        monkeypatch.setattr(device_codec, "encode_band_device", unsupported)
    else:
        monkeypatch.setattr(device_codec, "decode_band_device", lambda *_a, **_k: None)
    eo.reset_routes()
    with chip_smoke.acceleration(True):
        rc, _n, blob2 = api.encode(data, 1, False, None, 0.01, data.nbytes * 2)
        rd, out, _m = api.decode(blob)
    assert rc == 0 and rd == 0
    assert eo.ROUTES[direction, "host"] == 1
    assert eo.ROUTES[direction, "device"] == 0
    assert np.abs(out - data).max() <= 0.01 * 1.1
    if direction == "encode":
        assert blob2 == blob  # the host encoder's blob


def test_value_error_from_device_encode_propagates(small_bands, monkeypatch):
    """Only DeviceUnsupported routes a band to the host encoder; a plain
    ValueError (a shape or broadcast bug on the device path) is an error."""
    def shape_bug(*_a, **_k):
        raise ValueError("operands could not be broadcast together")

    data = _raster()
    monkeypatch.setattr(device_codec, "encode_band_device", shape_bug)
    eo.reset_routes()
    with chip_smoke.acceleration(True):
        with pytest.raises(ValueError, match="broadcast"):
            eo.encode_blob(data[None, :, :, None], None, 0.01)
        assert api.encode(data, 1, False, None, 0.01, data.nbytes * 2)[0] != 0
    assert eo.ROUTES["encode", "host"] == 0


def test_routing_counter(small_bands):
    data = np.stack([_raster(), _raster() + 7])
    eo.reset_routes()
    with chip_smoke.acceleration(True):
        blob = api.encode(data, 1, False, None, 0.01, data.nbytes * 2)[2]
        api.decode(blob)
    assert dict(eo.ROUTES) == {("encode", "device"): 2, ("decode", "device"): 2}
    eo.reset_routes()
    with chip_smoke.acceleration(False):
        api.decode(blob)
    assert dict(eo.ROUTES) == {("decode", "host"): 2}


def test_pre_v3_blobs_decode_on_the_host():
    """v2 bit-stuffing has a different tail layout: the device decoder
    declines it instead of decoding wrong pixels."""
    vecs = {v["name"]: v for v in json.loads(VECTORS.read_text())}
    import base64

    blob = base64.b64decode(vecs["tiling-f32-v2"]["blob"])
    assert device_codec.decode_band_device(blob) is None
    blob3 = base64.b64decode(vecs["tiling-f32-v3"]["blob"])
    assert device_codec.decode_band_device(blob3) is not None


def test_one_tile_mosaic_device_decode_matches_host():
    """A micro-block group of one unit comes back without its tile axis;
    the batched mosaic decoder must not broadcast it over the tile."""
    from lerc_tpu.codec.orchestrator import decode_blob
    from lerc_tpu.parallel import sharding

    data = _raster(64)
    blob = sharding.MosaicEncoder(sharding.make_mesh(1), 64, 64, np.float32).encode(
        data[:, :, None], None, 0.01)
    info, views = sharding.read_mosaic(blob)
    layouts = sharding._tile_band_layouts(views, 1)
    dev = sharding._decode_tiles_device_batched(info, views, layouts, [0])
    np.testing.assert_array_equal(dev[(0, 0)], decode_blob(views[0]).data[0])


def _wide_16x16_tile(n=64):
    """A mostly-invalid tile that picks 16x16 micro-blocks at a low bitrate
    with records wider than the device window (11 bits)."""
    rng = np.random.default_rng(0)
    data = (900 + 10 * rng.random((n, n))).astype(np.float32)
    mask = np.zeros((n, n), bool)
    mask[:, -6:] = True
    return data, mask


def test_only_the_unfit_mosaic_tile_leaves_the_device():
    """fits is per tile: in a group holding one unfit 16x16 tile, the
    other tiles of the group still decode on the device, and the routing
    counter says where every tile went."""
    from lerc_tpu.parallel import sharding

    wide, wide_mask = _wide_16x16_tile()
    low = np.full((64, 64), 100.0, np.float32)  # 1-bit records on half the tile
    low[:, :32] += np.float32(0.002) * np.random.default_rng(1).integers(0, 2, (64, 32))
    data = np.concatenate([wide, low, low + 1])[:, :, None]
    mask = np.concatenate([wide_mask, np.ones((128, 64), bool)])
    blob = sharding.MosaicEncoder(sharding.make_mesh(1), 64, 64, np.float32).encode(
        data, mask, 0.001)
    info, views = sharding.read_mosaic(blob)
    layouts = sharding._tile_band_layouts(views, 1)
    assert [layouts[t][0][1].micro_block_size for t in range(3)] == [16, 16, 16]
    eo.reset_routes()
    dev = sharding._decode_tiles_device_batched(info, views, layouts, [0, 1, 2])
    assert sorted(dev) == [(1, 0), (2, 0)]
    assert eo.ROUTES["mosaic_unfit", "units"] == 1
    assert eo.ROUTES["decode", "device"] == 2
    assert sum(c for (k, _d), c in eo.ROUTES.items() if k == "mosaic_units") == 2
    eo.reset_routes()
    with chip_smoke.acceleration(False):
        out = sharding.decode_mosaic_device(blob)
        host = sharding.decode_mosaic(blob)
    assert eo.ROUTES["decode", "host"] == 1 + 3  # the unfit tile, then the reference
    chip_smoke.assert_bits_equal(out, host, "mosaic decode")


def test_wide_16x16_mosaic_tile_decodes_on_the_host():
    """A mostly-invalid tile picks 16x16 micro-blocks at a low bitrate, but
    its records are wider than the device window (11 bits): the batched
    decoder must hand it to the host codec, not return the overflowed
    window's pixels."""
    from lerc_tpu.parallel import sharding

    data, mask = _wide_16x16_tile()
    blob = sharding.MosaicEncoder(sharding.make_mesh(1), 64, 64, np.float32).encode(
        data[:, :, None], mask, 0.001)
    info, views = sharding.read_mosaic(blob)
    layouts = sharding._tile_band_layouts(views, 1)
    assert layouts[0][0][1].micro_block_size == 16
    assert sharding._decode_tiles_device_batched(info, views, layouts, [0]) == {}
    dev = sharding.decode_mosaic_device(blob)
    with chip_smoke.acceleration(False):
        host = sharding.decode_mosaic(blob)
    chip_smoke.assert_bits_equal(dev, host, "mosaic decode")


# ---------------------------------------------------------------------------
# launch helpers
# ---------------------------------------------------------------------------

class _Config:
    def __init__(self):
        self.updates = {}

    def update(self, key, value):
        self.updates[key] = value


class _FakeJax:
    def __init__(self):
        self.config = _Config()


@pytest.mark.parametrize("env_dir", [None, "/some/cache"])
def test_compile_cache_dir(env_dir, monkeypatch):
    fake = _FakeJax()
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert chip_env.setup_compile_cache(fake) == chip_env.DEFAULT_CACHE_DIR
        assert fake.config.updates == {"jax_compilation_cache_dir": chip_env.DEFAULT_CACHE_DIR}
        assert chip_env.DEFAULT_CACHE_DIR == str(REPO / ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert chip_env.setup_compile_cache(fake) == env_dir
        assert fake.config.updates == {}  # JAX reads the variable itself


@pytest.mark.parametrize("asked,platforms,allowed", [
    (True, "cpu", True), (False, "cpu", False), (True, None, False), (True, "cuda", False)])
def test_rehearsal_needs_both_the_option_and_the_cpu(asked, platforms, allowed, monkeypatch):
    if platforms is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", platforms)
    assert chip_env.rehearsal_allowed(asked) is allowed


def test_device_summary_names_platform_kind_count():
    dev = chip_env.device_summary(jax)
    assert dev == {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind, "count": len(jax.devices())}


def test_dryrun_multichip_raises_when_devices_are_short():
    import __graft_entry__

    with pytest.raises(RuntimeError, match="needs"):
        __graft_entry__.dryrun_multichip(len(jax.devices()) + 1)


# ---------------------------------------------------------------------------
# no float32 operand reaches a dot
# ---------------------------------------------------------------------------

def _dot_operand_dtypes(jaxpr) -> list:
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(tuple(str(v.aval.dtype) for v in eqn.invars))
        for p in eqn.params.values():
            for sub in p if isinstance(p, (tuple, list)) else (p,):
                if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):  # ClosedJaxpr
                    out += _dot_operand_dtypes(sub.jaxpr)
                elif hasattr(sub, "eqns"):  # Jaxpr
                    out += _dot_operand_dtypes(sub)
    return out


def _kernel_traces():
    """(name, closed jaxpr) of every device kernel family with a dot."""
    from lerc_tpu.constants import DataType
    from lerc_tpu.ops import (device_decode, device_encode, device_f64,
                              device_fpl, device_huffman)

    h = w = 32
    f32 = jnp.asarray(_raster(32)[:, :, None])
    mask = jnp.asarray(np.random.default_rng(0).random((h, w)) > 0.2)
    mze = jnp.float32(0.01)
    out = []
    for nb_cap, mb, all_valid in ((0, 8, True), (16, 8, True), (0, 16, True), (0, 8, False)):
        enc = functools.partial(device_encode.encode_tiles, h=h, w=w, d=1, dt=DataType.FLOAT,
                                all_valid=all_valid, version=6, cap=1 << 14,
                                enable_lut=True, mb=mb, nb_cap=nb_cap)
        out.append((f"encode_tiles nb_cap={nb_cap} mb={mb} valid={all_valid}",
                    jax.make_jaxpr(enc)(f32, mask, mze)))
        stream, _t, _zn, zmax, starts, _f = enc(f32, mask, mze)
        dec = functools.partial(device_decode.decode_tiles_fast, h=h, w=w, d=1,
                                dt=DataType.FLOAT, version=6, nb_cap=nb_cap, mb=mb,
                                enable_lut=True)
        dmask = None if all_valid else mask
        out.append((f"decode_tiles_fast nb_cap={nb_cap} mb={mb} valid={all_valid}",
                    jax.make_jaxpr(lambda s, st, z: dec(s, st, mze, z, mask=dmask))(
                        stream, starts, zmax)))
    n_rec = (h // 8) * (w // 8)
    i32 = jnp.zeros(n_rec, jnp.int32)
    dt_args = (jnp.zeros(1 << 14, jnp.uint8), i32, i32, jnp.zeros(n_rec, jnp.float32),
               i32, i32, i32, i32, i32, mask, mze, jnp.zeros(1, jnp.float32))
    out.append(("decode_tiles", jax.make_jaxpr(functools.partial(
        device_decode.decode_tiles, h=h, w=w, d=1, dt=DataType.FLOAT, all_valid=False,
        has_lut=True))(*dt_args)))
    bits = jnp.zeros((h, w, 1, 2), jnp.uint32)
    out.append(("encode_tiles_f64", jax.make_jaxpr(functools.partial(
        device_f64.encode_tiles_f64, h=h, w=w, d=1, all_valid=False, version=6,
        cap=1 << 15))(f32, f32, bits, mask, mze, mze)))
    sym = jnp.asarray(np.arange(h * w) % 251, jnp.uint8)
    lens_codes = jnp.zeros((256, 5), jnp.float32)
    out.append(("histogram256", jax.make_jaxpr(device_huffman.histogram256)(sym)))
    out.append(("encode_stream_device", jax.make_jaxpr(functools.partial(
        device_huffman.encode_stream_device, cap=1 << 14, pwh=18))(sym, lens_codes)))
    lengths = np.full(256, 8, np.int32)
    consts, sorted_syms = device_huffman.canonical_decode_consts(
        lengths, np.arange(256, dtype=np.uint32))
    lanes = jnp.asarray(sorted_syms.reshape(16, 16, 1).astype(np.float32))
    n_groups = -(-h * w // device_huffman.GROUP)
    out.append(("decode_stream_device", jax.make_jaxpr(functools.partial(
        device_huffman.decode_stream_device, n=h * w, max_len=8))(
            jnp.zeros(512, jnp.uint32), jnp.zeros(n_groups, jnp.int32),
            jnp.asarray(consts), lanes)))
    out.append(("fpl_choose_device", jax.make_jaxpr(functools.partial(
        device_fpl.fpl_choose_device, h=h, w=w, d=1))(f32)))
    out.append(("fpl_pack_planes_device", jax.make_jaxpr(functools.partial(
        device_fpl.fpl_pack_planes_device, cap=1 << 14, pwh=18))(
            jnp.zeros((4, h * w), jnp.uint8), jnp.zeros((4, 256, 5), jnp.float32))))
    return out


def test_no_float32_operand_reaches_a_dot():
    seen = 0
    for name, closed in _kernel_traces():
        for dtypes in _dot_operand_dtypes(closed.jaxpr):
            seen += 1
            assert "float32" not in dtypes and "float64" not in dtypes, (name, dtypes)
    assert seen > 0
