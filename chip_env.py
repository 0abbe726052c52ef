"""Launch environment shared by chip_smoke.py and bench.py.

Three things every run on the card needs and the library itself never
does: the persistent compile cache, the card's name and power limit (read
by a child process that stays off JAX), and the refusal to measure on
anything but a GPU unless a CPU rehearsal was asked for explicitly.
"""
from __future__ import annotations

import os
import shutil
import subprocess

REPO = os.path.dirname(os.path.abspath(__file__))
DEFAULT_CACHE_DIR = os.path.join(REPO, ".jax_cache")


def setup_compile_cache(jax) -> str:
    """Point JAX's persistent compile cache at JAX_COMPILATION_CACHE_DIR when
    that is set (JAX reads it itself; nothing is overridden), else at the
    fixed `<repo>/.jax_cache`. Returns the directory in use."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def card_line() -> str:
    """`name, power.limit` of every visible NVIDIA card, one per line, as
    nvidia-smi prints them; a note when nvidia-smi is absent or fails.
    Call it before JAX opens the card."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi: not found"
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: failed ({e})"
    return out.stdout.strip()


def device_summary(jax) -> dict:
    """The device as JAX reports it: platform, kind and count."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def rehearsal_allowed(asked: bool) -> bool:
    """A CPU run is a rehearsal only when the caller asked for one AND pinned
    JAX to the CPU explicitly; anything else must find a GPU."""
    return asked and os.environ.get("JAX_PLATFORMS") == "cpu"
