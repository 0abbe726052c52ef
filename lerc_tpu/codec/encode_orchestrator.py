"""Multi-band encode orchestration: NaN/noData filtering, mask dedup, band loop.

Mirrors Lerc::EncodeInternal / EncodeInternal_v5 and the filter functions
(lerc/src/LercLib/Lerc.cpp:527-789, 1242-1618).
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from .. import profiling

from ..constants import NUMPY_TO_DT, ErrCode
from .lerc2_encode import BandEncoder


class LercEncodeError(ValueError):
    def __init__(self, code: ErrCode, msg: str):
        super().__init__(f"{code.name}: {msg}")
        self.code = code


def _type_range(dtype: np.dtype) -> tuple[float, float]:
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return float(info.min), float(info.max)
    info = np.finfo(dtype)
    return float(-info.max), float(info.max)


def _is_int_vals(x: np.ndarray) -> np.ndarray:
    return x == np.floor(x + 0.5)


@dataclasses.dataclass
class FilterResult:
    max_z_error: float
    no_data_val: float
    modified_mask: bool
    need_no_data: bool
    all_int: bool
    min_val: float
    max_val: float


def filter_no_data_int(
    data: np.ndarray, mask: np.ndarray, max_z_error: float, no_data_val: float
) -> FilterResult:
    """Integer-type noData filter (Lerc.cpp:1242-1374). Mutates data/mask."""
    lo, hi = _type_range(data.dtype)
    if not (lo <= no_data_val <= hi):
        raise LercEncodeError(ErrCode.WRONG_PARAM, "noData value out of type range")
    orig = data.dtype.type(no_data_val)
    n_depth = data.shape[2]

    valid3 = mask[:, :, None]
    is_nd = (data == orig) & valid3
    cnt = is_nd.sum(axis=2)
    all_nd = mask & (cnt == n_depth)
    modified = bool(all_nd.any())
    mask &= ~all_nd
    need_nd = bool((mask & (cnt > 0)).any())

    sel = mask[:, :, None] & ~is_nd
    if not sel.any():
        return FilterResult(0.5, no_data_val, modified, False, False, 0.0, 0.0)
    vals = data[sel].astype(np.float64)
    min_val, max_val = float(vals.min()), float(vals.max())

    mze_l = max(0.5, np.floor(max_z_error))
    dist = np.floor(mze_l)
    if min_val - dist <= float(orig) <= max_val + dist:
        return FilterResult(0.5, no_data_val, modified, need_nd, False, min_val, max_val)

    out_nd = no_data_val
    if need_nd:
        min_dist = np.floor(mze_l) + 1
        remap = min_val - min_dist
        new_nd = float(orig)
        if remap >= lo:
            new_nd = float(data.dtype.type(remap))
        else:
            mze_l = 0.5
            remap = min_val - 1
            if remap >= lo:
                new_nd = float(data.dtype.type(remap))
            else:
                remap = max_val + 1
                if remap <= hi and remap < float(orig):
                    new_nd = float(data.dtype.type(remap))
        if new_nd != float(orig):
            data[(data == orig) & mask[:, :, None]] = data.dtype.type(new_nd)
            out_nd = new_nd
    return FilterResult(float(mze_l), out_nd, modified, need_nd, False, min_val, max_val)


def filter_no_data_and_nan(
    data: np.ndarray, mask: np.ndarray, max_z_error: float,
    pass_no_data: bool, no_data_val: float,
) -> FilterResult:
    """Float-type NaN + noData filter (Lerc.cpp:1379-1552). Mutates data/mask."""
    is_f32 = data.dtype == np.float32
    lo, hi = _type_range(data.dtype)
    n_depth = data.shape[2]
    if pass_no_data:
        if is_f32 and not (lo <= no_data_val <= hi):
            raise LercEncodeError(ErrCode.WRONG_PARAM, "noData value out of float range")
        orig = data.dtype.type(no_data_val)
    else:
        orig = data.dtype.type(lo)

    int_lim = float(1 << 23) if is_f32 else float(1 << 53)

    valid3 = mask[:, :, None]
    nan3 = np.isnan(data) & valid3
    has_nan = bool(nan3.any())
    invalid3 = nan3 | (valid3 & (data == orig) if pass_no_data else np.zeros_like(nan3))
    if has_nan:
        if pass_no_data and n_depth > 1:
            data[nan3] = orig
        elif n_depth == 1:
            data[nan3] = data.dtype.type(0)

    cnt = invalid3.sum(axis=2)
    all_inv = mask & (cnt == n_depth)
    modified = bool(all_inv.any())
    mask &= ~all_inv
    has_nd_left = bool((mask & (cnt > 0) & (cnt < n_depth)).any())

    sel = mask[:, :, None] & ~invalid3
    if not sel.any():
        return FilterResult(0.0, no_data_val, modified, has_nd_left, False, 0.0, 0.0)
    vals = data[sel].astype(np.float64)
    min_val, max_val = float(vals.min()), float(vals.max())

    if has_nan and n_depth > 1 and has_nd_left and not pass_no_data:
        raise LercEncodeError(ErrCode.NAN, "mixed NaN/valid values per pixel need a noData value")

    all_int = bool(_is_int_vals(vals).all())
    if all_int:
        all_int = -int_lim <= min_val <= int_lim and -int_lim <= max_val <= int_lim
        if has_nd_left:
            all_int = all_int and float(orig) == np.floor(float(orig) + 0.5) and -int_lim <= float(orig) <= int_lim

    mze_l = max_z_error
    if all_int:
        mze_l = max(0.5, np.floor(max_z_error))

    if mze_l == 0:
        return FilterResult(0.0, no_data_val, modified, has_nd_left, all_int, min_val, max_val)

    if pass_no_data:
        dist = np.floor(mze_l) if all_int else 2 * mze_l
        if min_val - dist <= float(orig) <= max_val + dist:
            return FilterResult(
                0.5 if all_int else 0.0, no_data_val, modified, has_nd_left, all_int, min_val, max_val
            )

    out_nd = no_data_val
    if has_nd_left:
        new_nd = _find_no_data_below_min(min_val, mze_l, all_int, -int_lim, data.dtype)
        if new_nd is not None:
            if new_nd != float(orig):
                data[(data == orig) & mask[:, :, None]] = data.dtype.type(new_nd)
                out_nd = new_nd
        elif float(orig) >= min_val:
            mze_l = 0.5 if all_int else 0.0
    return FilterResult(float(mze_l), out_nd, modified, has_nd_left, all_int, min_val, max_val)


def _find_no_data_below_min(min_val, mze, all_int, low_int_limit, dtype) -> float | None:
    """FindNewNoDataBelowValidMin (Lerc.cpp:1557-1618)."""
    T = dtype.type
    if all_int:
        dists = [4 * mze, 1, 10, 100, 1000, 10000]
        cands = [float(T(min_val - d)) for d in dists]
        cands.append(float(T(np.floor(min_val / 2) if min_val > 0 else min_val * 2)))
        cands.sort(reverse=True)
        for c in cands:
            if c > float(T(low_int_limit)) and c < float(T(min_val - 2 * mze)) and c == np.floor(c + 0.5):
                return c
    else:
        dists = [4 * mze, 0.0001, 0.001, 0.01, 0.1, 1, 10, 100, 1000, 10000]
        cands = [float(T(min_val - d)) for d in dists]
        cands.append(float(T(min_val / 2 if min_val > 0 else min_val * 2)))
        cands.sort(reverse=True)
        lowest = _type_range(dtype)[0]
        for c in cands:
            if c > lowest and c < float(T(min_val - 2 * mze)):
                return c
    return None


def replace_nan_v5(data: np.ndarray, mask: np.ndarray) -> bool:
    """ReplaceNaNValues for the legacy v2..v5 encode path (Lerc.cpp:901-939)."""
    nd_val = data.dtype.type(_type_range(data.dtype)[0])
    n_depth = data.shape[2]
    nan3 = np.isnan(data) & mask[:, :, None]
    if not nan3.any():
        return False
    data[nan3] = nd_val
    all_nan = mask & (nan3.sum(axis=2) == n_depth)
    mask &= ~all_nan
    return True


_ACCELERATION: bool | None = None  # None: auto (on when a device backend exists)
# Host/device crossover in pixels per band. Set for an earlier accelerator's
# dispatch cost; not measured on the H100.
_ACCEL_MIN_PIXELS = 1 << 18

# Bands routed per (direction, route), e.g. ("encode", "device"): lets a
# caller see whether its bands really ran on the accelerator.
ROUTES: collections.Counter = collections.Counter()


def reset_routes() -> None:
    ROUTES.clear()


def set_acceleration(enabled: bool | None) -> None:
    """Route large band encodes through the device encoder.

    None (default) = auto: on when jax's default backend is not cpu.
    The device encoder quantizes in f32 with a sign-directed fixup, so the
    lossy error bound holds to maxZError within a float cast (the same
    tolerance the reference's own ENCODE_VERIFY uses) instead of the host
    path's exact f64; all outputs remain wire-exact LERC."""
    global _ACCELERATION
    _ACCELERATION = enabled


def _accel_enabled() -> bool:
    if _ACCELERATION is not None:
        return _ACCELERATION
    try:
        import jax

        return jax.default_backend() != "cpu"
    except Exception:
        return False


@profiling.profiled("encode_blob")
def encode_blob(
    data: np.ndarray,
    masks: np.ndarray | None = None,
    max_z_error: float = 0.0,
    version: int = -1,
    uses_no_data: np.ndarray | None = None,
    no_data_values: np.ndarray | None = None,
    verify: bool = False,
) -> bytes:
    """Encode [nBands, nRows, nCols, nDepth] data into a multi-band LERC blob.

    masks: None (all valid), [1, nRows, nCols] shared, or [nBands, ...] per band.
    verify: decode-and-compare self check after encoding, the ENCODE_VERIFY
    belt-and-braces of the reference (Lerc.cpp:1081-1211): decoded pixels must
    match the input within maxZError * 1.1 at valid pixels, masks must round
    trip, and noData values must survive.
    """
    if data.ndim != 4:
        raise LercEncodeError(ErrCode.WRONG_PARAM, "data must be [nBands, nRows, nCols, nDepth]")
    n_bands, n_rows, n_cols, n_depth = data.shape
    if data.dtype not in NUMPY_TO_DT:
        raise LercEncodeError(ErrCode.WRONG_PARAM, f"unsupported dtype {data.dtype}")
    if max_z_error < 0:
        raise LercEncodeError(ErrCode.WRONG_PARAM, "maxZError must be >= 0 (use 777 for bit-plane mode)")
    eff_version = 6 if version == -1 else version
    if eff_version < 2 or eff_version > 6:
        raise LercEncodeError(ErrCode.WRONG_PARAM, f"bad codec version {version}")
    nbpp = data.dtype.itemsize
    if n_rows * n_cols > 0x7FFFFFFF or nbpp * n_depth * n_rows * n_cols > 0x7FFFFFFF:
        raise LercEncodeError(ErrCode.DIMENSIONS_TOO_LARGE, "band exceeds 2 GB limit")

    is_flt = data.dtype in (np.float32, np.float64)
    legacy = eff_version <= 5

    if legacy and uses_no_data is not None and np.any(uses_no_data):
        raise LercEncodeError(ErrCode.WRONG_PARAM, "noData values need codec v6")

    out = bytearray()
    prev_mask: np.ndarray | None = None
    any_mask_modified = False
    n_masks = 0 if masks is None else masks.shape[0]

    for i_band in range(n_bands):
        band = np.array(data[i_band], copy=True)
        if masks is None:
            mask = np.ones((n_rows, n_cols), dtype=bool)
        else:
            mask = masks[i_band if n_masks > 1 else 0].astype(bool).copy()

        enc_msk = i_band == 0
        pass_nd = bool(uses_no_data is not None and uses_no_data[i_band])
        nd_orig = float(no_data_values[i_band]) if pass_nd else 0.0

        if legacy:
            if is_flt:
                replace_nan_v5(band, mask)
            fr = None
        elif is_flt:
            fr = filter_no_data_and_nan(band, mask, max_z_error, pass_nd, nd_orig)
        elif pass_nd:
            fr = filter_no_data_int(band, mask, max_z_error, nd_orig)
        else:
            fr = None

        mze_l = fr.max_z_error if fr is not None else max_z_error
        if fr is not None:
            any_mask_modified |= fr.modified_mask

        # mask dedup: re-encode only when this band's mask differs from the
        # previous band's (legacy always compares; v6 only when masks can differ)
        compare = legacy or (n_masks > 1) or any_mask_modified
        if i_band > 0 and compare and not np.array_equal(mask, prev_mask):
            enc_msk = True
        prev_mask = mask

        min_max = None
        if fr is not None and n_depth == 1 and fr.max_val >= fr.min_val:
            min_max = (fr.min_val, fr.max_val)

        # device-encoder routing: big clean bands on an accelerator backend
        # (no noData header fields, no all-int float hints, no 777 cheat)
        encoded = None
        if (
            _accel_enabled()
            and eff_version == 6
            and n_rows * n_cols >= _ACCEL_MIN_PIXELS
            and (fr is None or not (fr.need_no_data or fr.all_int))
            and mze_l != 777
        ):
            from . import device_codec

            if device_codec.supports_encode(
                NUMPY_TO_DT[band.dtype], mze_l, n_depth, all_valid=bool(mask.all())
            ):
                # DeviceUnsupported is the device codec's "not for me"
                # signal; any other error (compile, memory, runtime, a
                # shape bug) propagates instead of hiding behind the host
                try:
                    encoded = device_codec.encode_band_device(
                        band, mask, mze_l, eff_version, enc_msk,
                        n_blobs_more=(n_bands - 1 - i_band),
                    )
                except device_codec.DeviceUnsupported:
                    encoded = None
        ROUTES["encode", "host" if encoded is None else "device"] += 1
        if encoded is None:
            enc = BandEncoder(
                band, mask, mze_l, version=eff_version, encode_mask=enc_msk,
                n_blobs_more=(n_bands - 1 - i_band),
                b_pass_no_data=(fr.need_no_data if fr is not None else False),
                no_data_val=(fr.no_data_val if fr is not None else 0.0),
                no_data_val_orig=nd_orig,
                b_is_all_int=(fr.all_int if fr is not None else False),
                min_max=min_max,
            )
            encoded = enc.encode()
        out += encoded
    if len(out) > 0xFFFFFFFF:
        raise LercEncodeError(ErrCode.DIMENSIONS_TOO_LARGE, "total blob exceeds 4 GB limit")
    blob = bytes(out)
    if verify:
        _verify_encode(blob, data, masks, max_z_error, uses_no_data, no_data_values)
    return blob


def _verify_encode(blob, data, masks, max_z_error, uses_no_data, no_data_values):
    """Decode-own-encode self check (reference ENCODE_VERIFY semantics)."""
    from .orchestrator import decode_blob

    res = decode_blob(blob)
    n_bands = data.shape[0]
    is_flt = data.dtype in (np.float32, np.float64)
    eff = max_z_error
    if not is_flt:
        eff = max(0.5, np.floor(max_z_error)) if max_z_error != 777 else None
    for i in range(n_bands):
        dec = res.data[i].astype(np.float64)
        orig = data[i].astype(np.float64)
        valid = np.broadcast_to(res.masks[i][:, :, None], orig.shape).copy()
        valid &= ~np.isnan(data[i].astype(np.float64))
        if uses_no_data is not None and uses_no_data[i]:
            nd_sel = valid & (orig == no_data_values[i])
            if not np.array_equal(dec[nd_sel], orig[nd_sel]):
                raise LercEncodeError(ErrCode.FAILED, "encode verify: noData values lost")
            valid &= ~nd_sel
        if eff is not None and valid.any():
            err = np.abs(dec[valid] - orig[valid]).max()
            if err > eff * 1.1 + 1e-12:
                raise LercEncodeError(
                    ErrCode.FAILED, f"encode verify: error {err} > {eff} * 1.1"
                )
