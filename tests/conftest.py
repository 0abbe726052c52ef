import os

# The suite defaults to the CPU with 8 virtual devices for the mesh tests;
# `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` runs the card tier.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is an NVIDIA GPU. Decided here, at
    run time, never at import: xdist workers collect modules separately."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules: a full single-process
    suite run accumulates ~400 XLA:CPU executables and the 387th test's
    compile then segfaults inside backend_compile_and_load (deterministic,
    test passes in isolation, stack-limit independent -- an XLA:CPU
    compiler-state issue, jaxlib 0.9.0). Clearing per module keeps the
    compiler healthy at the cost of recompiling shared kernels per file."""
    yield
    jax.clear_caches()


# ---------------------------------------------------------------------------
# smoke tier: `pytest -m smoke` covers every wire path
# once in < 5 min -- host codec suites wholesale (no jit, fast) plus one
# representative device-jit case per kernel family. The full suite stays
# the default (`pytest tests/`).
# ---------------------------------------------------------------------------

_SMOKE_MODULES = {
    "test_format_core.py",   # header/bitstuffer/huffman/rle/bitmask units
    "test_golden_blobs.py",  # the 3 reference golden blobs, bit-exact
    "test_decode.py",        # host decoder vs oracle across modes
    "test_api.py",           # C-API surface semantics
    "test_cs_binding.py",    # C# twin conformance incl. managed encoder
    "test_lerc1_matrix.py",  # generated Lerc1 corpus, 3 decoders
}

# one device-jit representative per kernel family (~30-60 s each on the
# virtual CPU mesh; names matched as node-id substrings)
_SMOKE_TESTS = (
    "test_device_codec.py::test_f32_lossy",            # tiling enc+dec, masked too
    "test_device_codec.py::test_device_huffman_8bit_lossless",
    "test_device_codec.py::test_device_fpl_float_lossless",
    "test_device_codec.py::test_device_f64_lossy",
    "test_resident.py::test_fused_blob_is_wire_compatible",
    "test_sharding.py::test_mosaic_roundtrip",
)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "smoke: fast tier covering every wire path once (< 5 min)")
    config.addinivalue_line(
        "markers", "gpu: runs only on an NVIDIA GPU (skips elsewhere)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = os.path.basename(str(item.fspath))
        node = f"{base}::{item.name}"
        if base in _SMOKE_MODULES or any(node.startswith(s.split("::")[0])
                                         and item.name.startswith(s.split("::")[1])
                                         for s in _SMOKE_TESTS):
            item.add_marker(pytest.mark.smoke)
