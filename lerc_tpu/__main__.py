"""lerc_tpu command line: file round trips and blob inspection.

Mirrors the workflows of the reference's LercTest app plus the Python
binding's conveniences (reference: src/LercTest/main.cpp,
OtherLanguages/Python/lerc/_lerc.py):

  python -m lerc_tpu info FILE.lerc2            # header/metadata walk
  python -m lerc_tpu decode FILE.lerc2 -o out.npy [--mask out_mask.npy]
  python -m lerc_tpu encode in.npy -o out.lerc2 --max-z-error 0.01
  python -m lerc_tpu roundtrip in.npy --max-z-error 0.01   # self check
  python -m lerc_tpu selftest                    # golden-blob smoke test
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

def _load_array(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    raise SystemExit(f"unsupported input {path!r}: expected .npy")


def cmd_info(args) -> int:
    from . import getLercBlobInfo_4D, getLercDataRanges

    blob = open(args.file, "rb").read()
    out = getLercBlobInfo_4D(blob)
    (result, version, dt, n_depth, n_cols, n_rows, n_bands, n_valid,
     blob_size, n_masks, z_min, z_max, max_z_err, *rest) = out
    if result != 0:
        print(f"error: not a LERC blob (code {result})", file=sys.stderr)
        return 1
    n_uses_nodata = rest[0] if rest else 0
    print(f"codec version : {version}")
    print(f"data type     : {dt}")
    print(f"shape         : bands={n_bands} rows={n_rows} cols={n_cols} depth={n_depth}")
    print(f"valid pixels  : {n_valid} / {n_rows * n_cols}")
    print(f"masks         : {n_masks}   usesNoData: {n_uses_nodata}")
    print(f"blob size     : {blob_size} bytes ({len(blob)} in file)")
    print(f"z range       : [{z_min}, {z_max}]   maxZError: {max_z_err}")
    if args.ranges and n_depth >= 1:
        r, mins, maxs = getLercDataRanges(blob, n_depth, n_bands)
        if r == 0:
            for b in range(n_bands):
                print(f"band {b} ranges : min={mins[b]} max={maxs[b]}")
    return 0


def cmd_decode(args) -> int:
    from . import decode

    blob = open(args.file, "rb").read()
    t0 = time.perf_counter()
    out = decode(blob)
    if isinstance(out, int) or out[0] != 0:
        code = out if isinstance(out, int) else out[0]
        print(f"decode failed (code {code})", file=sys.stderr)
        return 1
    _, data, mask = out
    dt = time.perf_counter() - t0
    np.save(args.output, np.asarray(data))
    print(f"decoded {args.file}: shape {np.asarray(data).shape} "
          f"{np.asarray(data).dtype} in {dt*1e3:.1f} ms -> {args.output}")
    if args.mask is not None and mask is not None:
        np.save(args.mask, np.asarray(mask, dtype=bool))
        print(f"mask -> {args.mask}")
    return 0


def cmd_encode(args) -> int:
    from . import encode

    data = _load_array(args.file)
    mask = np.load(args.maskfile) if args.maskfile else None
    t0 = time.perf_counter()
    result, n_bytes, blob = encode(
        data, args.depth, mask is not None, mask, args.max_z_error,
        data.nbytes * 2 + (1 << 16),
    )
    dt = time.perf_counter() - t0
    if result != 0:
        print(f"encode failed (code {result})", file=sys.stderr)
        return 1
    open(args.output, "wb").write(bytes(blob[:n_bytes]))
    ratio = data.nbytes / n_bytes
    print(f"encoded {args.file}: {data.nbytes} -> {n_bytes} bytes "
          f"({ratio:.2f}x) in {dt*1e3:.1f} ms -> {args.output}")
    return 0


def cmd_roundtrip(args) -> int:
    from . import decode, encode

    data = _load_array(args.file)
    result, n_bytes, blob = encode(
        data, args.depth, False, None, args.max_z_error,
        data.nbytes * 2 + (1 << 16),
    )
    if result != 0:
        print(f"encode failed (code {result})", file=sys.stderr)
        return 1
    out = decode(bytes(blob[:n_bytes]))
    if isinstance(out, int) or out[0] != 0:
        print("decode failed", file=sys.stderr)
        return 1
    dec = np.asarray(out[1], dtype=np.float64).reshape(-1)
    err = np.abs(dec - data.astype(np.float64).reshape(-1)).max()
    limit = max(args.max_z_error * 1.1, 0 if args.max_z_error else 0)
    ok = err <= limit or (args.max_z_error == 0 and err == 0)
    print(f"roundtrip: {data.nbytes} -> {n_bytes} bytes "
          f"({data.nbytes / n_bytes:.2f}x), max|err| = {err:g} "
          f"(maxZError {args.max_z_error}) {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


def cmd_selftest(args) -> int:
    import base64
    import json

    from . import decode, encode

    fails = 0
    # the reference library's golden blobs, when run from a source checkout
    vectors = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "bindings", "js", "test", "vectors.json")
    if os.path.isfile(vectors):
        with open(vectors) as f:
            golden = [v for v in json.load(f) if v["name"].startswith("golden-")]
        for v in golden:
            out = decode(base64.b64decode(v["blob"]))
            ok = not isinstance(out, int) and out[0] == 0
            print(f"decode {v['name']}: {'OK' if ok else 'FAIL'}")
            fails += 0 if ok else 1
    rng = np.random.default_rng(0)
    for dtype, mze in [(np.float32, 0.01), (np.uint8, 0), (np.int16, 0)]:
        arr = (rng.normal(100, 30, (123, 87))).astype(dtype)
        r, n, blob = encode(arr, 1, False, None, mze, arr.nbytes * 2 + 65536)
        out = decode(bytes(blob[:n]))
        dec = np.asarray(out[1], np.float64).reshape(arr.shape)
        err = np.abs(dec - arr.astype(np.float64)).max()
        lim = mze * 1.1 if mze else 0
        ok = r == 0 and out[0] == 0 and err <= lim
        print(f"roundtrip {np.dtype(dtype).name} mze={mze}: err={err:g} "
              f"{'OK' if ok else 'FAIL'}")
        fails += 0 if ok else 1
    print("selftest:", "PASS" if fails == 0 else f"{fails} FAILURES")
    return 0 if fails == 0 else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m lerc_tpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("info", help="print blob metadata (header walk only)")
    pi.add_argument("file")
    pi.add_argument("--ranges", action="store_true", help="also print per-band ranges")
    pi.set_defaults(fn=cmd_info)

    pd = sub.add_parser("decode", help="decode a LERC blob to .npy")
    pd.add_argument("file")
    pd.add_argument("-o", "--output", required=True)
    pd.add_argument("--mask", help="write validity mask to this .npy")
    pd.set_defaults(fn=cmd_decode)

    pe = sub.add_parser("encode", help="encode a .npy array to LERC")
    pe.add_argument("file")
    pe.add_argument("-o", "--output", required=True)
    pe.add_argument("--max-z-error", type=float, default=0.0)
    pe.add_argument("--depth", type=int, default=1)
    pe.add_argument("--maskfile", help=".npy bool mask (True = valid)")
    pe.set_defaults(fn=cmd_encode)

    pr = sub.add_parser("roundtrip", help="encode+decode a .npy and check error")
    pr.add_argument("file")
    pr.add_argument("--max-z-error", type=float, default=0.0)
    pr.add_argument("--depth", type=int, default=1)
    pr.set_defaults(fn=cmd_roundtrip)

    ps = sub.add_parser("selftest", help="golden blobs + synthetic round trips")
    ps.set_defaults(fn=cmd_selftest)

    p.add_argument("--profile", action="store_true",
                   help="print per-phase timing/throughput to stderr on exit")
    args = p.parse_args(argv)
    if args.profile:
        from . import profiling

        profiling.enable()
        try:
            return args.fn(args)
        finally:
            profiling.print_stats()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
