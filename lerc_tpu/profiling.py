"""User-facing profiling hooks: per-phase wall time + byte counters.

The reference ships no profiler (green-field per SURVEY.md §5). These are
host wall-clock spans per PHASE, not per-op device times -- how long
encode/decode/scan/assembly passes take and how many
bytes they move -- so this is a lightweight span recorder the hot paths
call through, at zero cost when disabled (one module-global bool test).

Usage:
    from lerc_tpu import profiling
    profiling.enable()
    ... encode / decode ...
    profiling.print_stats()          # or stats() for the raw dict

    with profiling.span("my-phase", bytes=n):   # user code can add spans
        ...

Environment: LERC_TPU_PROFILE=1 enables collection at import time.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

_enabled = os.environ.get("LERC_TPU_PROFILE", "0") == "1"
_records: dict[str, list] = defaultdict(list)  # name -> [(seconds, bytes)]


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    _records.clear()


def enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def span(name: str, nbytes: int = 0):
    """Time a phase. No-op (a single bool test) when profiling is off."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _records[name].append((time.perf_counter() - t0, nbytes))


def record(name: str, seconds: float, nbytes: int = 0) -> None:
    """Record an externally-timed phase (e.g. a device fetch fence)."""
    if _enabled:
        _records[name].append((seconds, nbytes))


def stats() -> dict:
    """Aggregated {name: {calls, total_s, mean_s, min_s, bytes, MBps}}."""
    out = {}
    for name, recs in _records.items():
        secs = [r[0] for r in recs]
        nb = sum(r[1] for r in recs)
        total = sum(secs)
        out[name] = {
            "calls": len(recs),
            "total_s": round(total, 6),
            "mean_s": round(total / len(recs), 6),
            "min_s": round(min(secs), 6),
            "bytes": nb,
            "MBps": round(nb / 1e6 / total, 1) if total > 0 and nb else None,
        }
    return out


def print_stats(file=None) -> None:
    import sys

    f = file or sys.stderr
    rows = sorted(stats().items(), key=lambda kv: -kv[1]["total_s"])
    if not rows:
        print("lerc_tpu profiling: no spans recorded", file=f)
        return
    print(f"{'phase':<32}{'calls':>7}{'total_s':>10}{'mean_s':>10}"
          f"{'min_s':>10}{'MB/s':>9}", file=f)
    for name, s in rows:
        mbps = f"{s['MBps']:.0f}" if s["MBps"] else "-"
        print(f"{name:<32}{s['calls']:>7}{s['total_s']:>10.4f}"
              f"{s['mean_s']:>10.4f}{s['min_s']:>10.4f}{mbps:>9}", file=f)


def profiled(name: str):
    """Decorator: record a span per call; byte counts are best-effort from
    a bytes / (bytes, index) / DecodedBand-like result."""
    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _enabled:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            rv = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            nb = 0
            probe = rv[0] if isinstance(rv, tuple) and rv else rv
            if isinstance(probe, (bytes, bytearray)):
                nb = len(probe)
            else:
                data = getattr(probe, "data", None)
                if data is not None and hasattr(data, "nbytes"):
                    nb = int(data.nbytes)
            _records[name].append((dt, nb))
            return rv
        return wrapper
    return deco
