"""M0 tests: Fletcher32, RLE, BitStuffer2, header parsing vs the shipped
reference blobs and the reference library oracle."""
import numpy as np
import pytest

from lerc_tpu.codec import bitstuffer, rle
from lerc_tpu.codec.fletcher32 import fletcher32
from lerc_tpu.codec.header import read_header, checksum_skip

from . import oracle
from .golden import blob as load


@pytest.mark.parametrize("name", ["california_400_400_1_float.lerc2", "bluemarble_256_256_3_byte.lerc2"])
def test_header_and_checksum_on_reference_blobs(name):
    blob = load(name)
    hd, consumed = read_header(blob)
    assert hd.version >= 3
    # the stored checksum covers the blob after the checksum field
    computed = fletcher32(blob[checksum_skip(hd.version) : hd.blob_size])
    assert computed == hd.checksum


def test_header_fields_match_oracle():
    if not oracle.available():
        pytest.skip("reference library not built")
    for name in ["california_400_400_1_float.lerc2", "bluemarble_256_256_3_byte.lerc2"]:
        blob = load(name)
        hd, _ = read_header(blob)
        info = oracle.blob_info(blob)
        assert hd.version == info["version"]
        assert int(hd.dt) == info["dataType"]
        assert hd.n_cols == info["nCols"]
        assert hd.n_rows == info["nRows"]
        assert hd.n_depth == info["nDepth"]
        assert hd.num_valid_pixel == info["nValidPixels"]


def test_fletcher32_small_vectors():
    # compare against a straightforward big-int simulation of the C loop
    def c_like(data):
        s1, s2 = 0xFFFF, 0xFFFF
        words = len(data) // 2
        k = 0
        while words:
            tlen = min(359, words)
            words -= tlen
            for _ in range(tlen):
                s1 += data[k] << 8
                k += 1
                s1 += data[k]
                k += 1
                s2 += s1
            s1 = (s1 & 0xFFFF) + (s1 >> 16)
            s2 = (s2 & 0xFFFF) + (s2 >> 16)
        if len(data) & 1:
            s1 += data[-1] << 8
            s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
        return (s2 << 16 | s1) & 0xFFFFFFFF

    rng = np.random.default_rng(0)
    for n in [0, 1, 2, 3, 7, 358 * 2, 359 * 2, 359 * 2 + 1, 10000]:
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert fletcher32(data) == c_like(data), n
    assert fletcher32(b"\x00\x00") == c_like(b"\x00\x00")
    assert fletcher32(b"\xff\xff" * 400) == c_like(b"\xff\xff" * 400)


def test_rle_roundtrip():
    rng = np.random.default_rng(1)
    cases = [
        np.array([7], dtype=np.uint8),
        np.zeros(100, dtype=np.uint8),
        np.full(5, 3, dtype=np.uint8),
        np.full(6, 3, dtype=np.uint8),
        rng.integers(0, 256, 1000, dtype=np.uint8),
        rng.integers(0, 2, 5000, dtype=np.uint8),  # lots of short runs
        np.concatenate([np.zeros(40000, np.uint8), rng.integers(0, 256, 100, np.uint8)]),
        np.concatenate([np.full(4, 1, np.uint8), np.full(5, 2, np.uint8), np.array([9], np.uint8)]),
    ]
    for arr in cases:
        blob = rle.compress(arr)
        out = rle.decompress(blob, arr.size)
        assert np.array_equal(np.frombuffer(out, np.uint8), arr)
        assert rle.decompressed_length(blob) == len(blob)


def test_bitstuffer_roundtrip_both_versions():
    rng = np.random.default_rng(2)
    for version in (2, 3, 6):
        for num_bits in [1, 3, 7, 8, 13, 24, 31]:
            for n in [1, 5, 64, 100, 256]:
                vals = rng.integers(0, 1 << num_bits, n, dtype=np.uint32)
                vals[rng.integers(0, n)] = (1 << num_bits) - 1  # force max bits
                packed = bitstuffer.pack_for_version(vals, num_bits, version)
                assert len(packed) == (n * num_bits + 7) // 8
                out, used = bitstuffer.unpack_for_version(packed, n, num_bits, version)
                assert used == len(packed)
                assert np.array_equal(out, vals)


def test_bitstuffer_encode_simple_roundtrip():
    rng = np.random.default_rng(3)
    for version in (2, 6):
        vals = rng.integers(0, 1000, 64, dtype=np.uint32)
        blob = bitstuffer.encode_simple(vals, version)
        out, used = bitstuffer.decode(blob, 64, version)
        assert used == len(blob)
        assert np.array_equal(out, vals)
        assert len(blob) == bitstuffer.compute_bytes_simple(64, int(vals.max()))


def test_bitstuffer_encode_lut_roundtrip():
    rng = np.random.default_rng(4)
    for version in (2, 6):
        distinct = np.array([0, 5, 17, 200, 3000], dtype=np.uint32)
        vals = distinct[rng.integers(0, 5, 64)]
        vals[0] = 0
        blob = bitstuffer.encode_lut(vals, version)
        out, used = bitstuffer.decode(blob, 64, version)
        assert used == len(blob)
        assert np.array_equal(out, vals)
        nbytes, use_lut = bitstuffer.compute_bytes_lut(np.sort(vals), vals.size)
        assert use_lut
        assert len(blob) == nbytes
