"""Hostile-blob hardening fuzz.

The reference bounds-checks every read (Lerc2.cpp:897-911 et passim) so a
tampered or truncated blob fails gracefully. Here: random byte mutations
and truncations over real blobs into decode_blob must raise ValueError or
decode to some output -- never segfault, hang, or raise a non-ValueError
exception. Mutations are applied in two modes: as-is (the Fletcher32
catches most) and with the checksum RE-COMPUTED after mutation, which
drives the corruption past the checksum into every parsing layer.
"""
import struct

import numpy as np
import pytest

from lerc_tpu.codec import fletcher32, header as hdr
from lerc_tpu.codec.orchestrator import decode_blob

from . import golden


def _seed_blobs():
    from lerc_tpu.codec.device_codec import encode_band_device

    rng = np.random.default_rng(99)
    blobs = []
    # float tiling
    x, y = np.meshgrid(np.linspace(0, 5, 56), np.linspace(0, 4, 48))
    f = (np.sin(x) * np.cos(y) * 100 + rng.normal(0, 1, (48, 56))).astype(np.float32)
    blobs.append(encode_band_device(f[:, :, None].copy(), None, 0.01))
    # masked
    mask = rng.random((48, 56)) > 0.3
    blobs.append(encode_band_device(f[:, :, None].copy(), mask, 0.01))
    # 8-bit Huffman
    u8 = (np.cumsum(rng.integers(-2, 3, (48, 56)), axis=1) % 200).astype(np.uint8)
    blobs.append(encode_band_device(u8[:, :, None].copy(), None, 0.5))
    # fpl float lossless
    blobs.append(encode_band_device(f[:, :, None].copy(), None, 0.0))
    # real reference blob
    blobs.append(golden.blob("california_400_400_1_float.lerc2"))
    return blobs


def _refix_checksum(buf: bytearray) -> bool:
    """Recompute the Fletcher32 so corruption survives the checksum gate."""
    try:
        head, _ = hdr.read_header(bytes(buf))
    except ValueError:
        return False
    if head.version < 3 or head.blob_size > len(buf):
        return False
    skip = hdr.checksum_skip(head.version)
    cs = fletcher32.fletcher32(bytes(buf[skip : head.blob_size]))
    struct.pack_into("<I", buf, skip - 4, cs)
    return True


def _must_not_crash(blob: bytes):
    try:
        decode_blob(blob)
    except ValueError:
        pass  # graceful rejection
    # any other exception type propagates and fails the test


@pytest.mark.parametrize("refix", [False, True])
def test_random_mutations(refix):
    rng = np.random.default_rng(7 if refix else 8)
    for blob in _seed_blobs():
        for _ in range(40):
            buf = bytearray(blob)
            for _ in range(int(rng.integers(1, 4))):
                pos = int(rng.integers(0, len(buf)))
                buf[pos] = int(rng.integers(0, 256))
            if refix and not _refix_checksum(buf):
                continue
            _must_not_crash(bytes(buf))


def test_truncations():
    for blob in _seed_blobs():
        n = len(blob)
        cuts = {0, 1, 2, 10, n // 4, n // 2, n - 2, n - 1}
        for cut in sorted(c for c in cuts if 0 <= c < n):
            _must_not_crash(blob[:cut])


def test_truncation_with_refixed_checksum():
    """Truncated payload with a consistent header/blob_size and a valid
    checksum over the remaining bytes: the section parsers must still
    bounds-check."""
    for blob in _seed_blobs():
        n = len(blob)
        for cut in (n - 1, n - 8, int(n * 0.75), int(n * 0.5)):
            if cut < 80:
                continue
            buf = bytearray(blob[:cut])
            try:
                head, _ = hdr.read_header(bytes(buf))
            except ValueError:
                continue
            # shrink the recorded blob size to the cut and refix
            bs_off = len(hdr.FILE_KEY_LERC2) + 4 + 4 + 5 * 4
            if head.version >= 3:
                struct.pack_into("<i", buf, bs_off, cut)
                if _refix_checksum(buf):
                    _must_not_crash(bytes(buf))


def test_header_field_fuzz():
    """Directed fuzz of each header field (dims, counts, micro-block,
    sizes) with a refixed checksum."""
    rng = np.random.default_rng(13)
    blob = _seed_blobs()[0]
    key = len(hdr.FILE_KEY_LERC2)
    for off in range(key, key + 4 + 4 + 8 * 4):
        for val in (0, 1, 0x7F, 0xFF):
            buf = bytearray(blob)
            buf[off] = val
            if not _refix_checksum(buf):
                continue
            _must_not_crash(bytes(buf))
    # random header dword blasts
    for _ in range(60):
        buf = bytearray(blob)
        off = key + int(rng.integers(0, 40))
        struct.pack_into("<I", buf, off, int(rng.integers(0, 1 << 32)))
        if _refix_checksum(buf):
            _must_not_crash(bytes(buf))


def test_lerc1_legacy_fuzz():
    """Lerc1 blobs have NO checksum: mutations reach the legacy parser
    directly. Must reject or decode, never crash."""
    blob = golden.blob("world.lerc1")
    rng = np.random.default_rng(1)
    for _ in range(120):
        buf = bytearray(blob)
        for _ in range(int(rng.integers(1, 5))):
            buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
        _must_not_crash(bytes(buf))
    for cut in range(0, len(blob), 4993):
        _must_not_crash(blob[:cut])


def test_native_scan_differential_fuzz():
    """Foreign-blob device decode under mutation: the native lengths-only
    Huffman scan (lerc_huffman_group_offsets) parses UNTRUSTED bytes, so
    checksum-refixed corruption must never crash it -- decode_band_device
    either raises ValueError, falls back (None), or decodes; and when both
    the device path and the host decoder accept a mutated blob, their
    pixels must agree (same wire semantics, no silent divergence)."""
    from lerc_tpu import native
    from lerc_tpu.codec.device_codec import decode_band_device, encode_band_device

    if not native.available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(17)
    h, w = 64, 72
    seeds = []
    smooth = (np.cumsum(rng.integers(-2, 3, size=h * w)).astype(np.int64)
              % 200).astype(np.uint8).reshape(h, w)
    seeds.append(encode_band_device(smooth[:, :, None].copy(), None, 0.5))
    mask = rng.random((h, w)) > 0.3
    seeds.append(encode_band_device((smooth * mask).astype(np.uint8)[:, :, None].copy(),
                                    mask, 0.5))
    x, y = np.meshgrid(np.linspace(0, 4, w), np.linspace(0, 3, h))
    f = (500 * np.sin(x) * np.cos(y)).astype(np.float32)
    seeds.append(encode_band_device(f[:, :, None].copy(), None, 0.0))  # fpl

    for blob in seeds:
        head, hdr_end = hdr.read_header(memoryview(blob))
        for _ in range(60):
            buf = bytearray(blob)
            # bias mutations into the payload (table + stream), where the
            # scanner walks
            for _ in range(int(rng.integers(1, 4))):
                pos = int(rng.integers(hdr_end, len(buf)))
                buf[pos] = int(rng.integers(0, 256))
            if not _refix_checksum(buf):
                continue
            mutated = bytes(buf)
            try:
                dev = decode_band_device(mutated)
            except ValueError:
                continue  # graceful rejection; host may reject or accept
            if dev is None:
                continue
            try:
                host = decode_blob(mutated)
            except ValueError:
                continue  # device stricter/looser acceptance is fine
            m = host.masks[0]  # same wire -> same mask; invalid pixels are
            np.testing.assert_array_equal(  # unspecified on both paths
                np.asarray(dev.data)[m], host.data[0][m],
                err_msg="device and host decoded the same bytes differently")


def test_bindings_hostile_mutations():
    """The JS/C# binding decoders (via their executable sims) must fail
    gracefully on checksum-refixed mutations: LercError / nonzero rc, or
    a clean decode -- never IndexError/struct.error/KeyError (which would
    be an unchecked read in the real JS/C#)."""
    import pathlib
    import sys as _sys

    root = pathlib.Path(__file__).resolve().parents[1]
    _sys.path.insert(0, str(root / "bindings" / "js"))
    _sys.path.insert(0, str(root / "bindings" / "csharp"))
    import cs_sim
    import js_sim

    rng = np.random.default_rng(3)
    blobs = [b for b in _seed_blobs() if len(b) < 30000]  # small: sims are slow
    from lerc_tpu.codec.orchestrator import get_lerc_info

    for blob in blobs:
        # our header walk sizes the buffers (test_golden_blobs holds it to
        # the reference's blob info)
        try:
            li = get_lerc_info(blob)
        except ValueError:
            continue
        info = {"nMasks": li.n_masks}
        args = (li.n_depth, li.n_cols, li.n_rows, li.n_bands, int(li.dt))
        n = args[0] * args[1] * args[2] * args[3]
        for trial in range(12):
            buf = bytearray(blob)
            for _ in range(int(rng.integers(1, 4))):
                buf[int(rng.integers(0, len(buf)))] ^= int(rng.integers(1, 256))
            if not _refix_checksum(buf):
                continue
            mutated = bytes(buf)
            try:
                js_sim.decode(mutated)
            except js_sim.LercError:
                pass  # graceful
            data = np.zeros(n, [np.int8, np.uint8, np.int16, np.uint16,
                                np.int32, np.uint32, np.float32,
                                np.float64][args[4]])
            pv = np.zeros(args[1] * args[2] * max(info["nMasks"], 1), np.uint8)
            rc = cs_sim.lerc_decode(mutated, len(mutated), info["nMasks"],
                                    pv if info["nMasks"] else None,
                                    *args, data)
            assert rc in (0, 1, 2, 3, 5), rc
        # truncations
        for cut in (10, len(blob) // 3, len(blob) - 3):
            t = blob[:cut]
            try:
                js_sim.decode(t)
            except js_sim.LercError:
                pass
            data = np.zeros(n, np.float64)
            rc = cs_sim.lerc_decodeToDouble(t, len(t), 0, None, *args[:4], data)
            assert rc in (0, 1, 2, 3, 5), rc
