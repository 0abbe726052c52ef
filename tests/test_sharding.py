"""Distributed tile-grid tests on the virtual 8-device CPU mesh:
shard_map mosaic encode, ranges collectives, host and device decode paths,
per-tile wire compatibility with the reference library."""
import numpy as np
import pytest

from lerc_tpu.parallel.sharding import (
    MosaicEncoder, decode_mosaic, decode_mosaic_device, make_mesh, read_mosaic,
)

from . import oracle


def _raster(h, w, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 9, w)[None, :, None]
    y = np.linspace(0, 7, h)[:, None, None]
    return (800 * np.exp(-((x - 5) ** 2 + (y - 3) ** 2) / 6)
            + 30 * np.sin(x + y) + 0.2 * rng.standard_normal((h, w, 1))
            ).astype(np.float32)


def test_mosaic_roundtrip_device_decode():
    mesh = make_mesh(8)
    h = w = 128
    data = _raster(h, w)
    enc = MosaicEncoder(mesh, 32, 32, np.float32, n_depth=1)
    blob = enc.encode(data, None, 0.005)

    info, views = read_mosaic(blob)
    assert info["grid"] == (4, 4) and info["starts"] is not None

    out_host = decode_mosaic(blob)
    err = np.abs(out_host.astype(np.float64) - data[:, :, 0][:, :, None]).max()
    assert err <= 0.005 * 1.01

    out_dev = decode_mosaic_device(blob)
    # device and host decodes agree bit-exactly (softfloat ScaleBack)
    np.testing.assert_array_equal(out_dev, out_host)

    # every tile is a standard Lerc2 blob the reference accepts
    if oracle.available():
        t = 5
        ref = oracle.decode(bytes(views[t]))[0].reshape(32, 32)
        np.testing.assert_array_equal(ref, out_host[32:64, 32:64, 0])


def test_mosaic_masked_and_ragged_edges(monkeypatch):
    mesh = make_mesh(4)
    h, w = 100, 90  # not multiples of the tile -> padded, masked edge tiles
    data = _raster(h, w, seed=2)
    mask = np.ones((h, w), bool)
    mask[10:20, 15:40] = False
    # try_16 off: the 16x16 retrial trades device decodability for size
    # (chosen tiles host-decode); this test pins the all-device path
    enc = MosaicEncoder(mesh, 32, 32, np.float32, n_depth=1, try_16=False)
    blob = enc.encode(data, mask, 0.01)

    out = decode_mosaic(blob)
    err = np.abs(out[:, :, 0].astype(np.float64) - data[:, :, 0])[mask].max()
    assert err <= 0.01 * 1.01

    # masked and edge-padded tiles stay on the device fast path: zero
    # host-decoded tiles
    import lerc_tpu.codec.orchestrator as orch

    host_calls = []
    real_decode_blob = orch.decode_blob
    monkeypatch.setattr(
        orch, "decode_blob",
        lambda *a, **k: (host_calls.append(1), real_decode_blob(*a, **k))[1],
    )
    out_dev = decode_mosaic_device(blob)
    assert not host_calls, f"{len(host_calls)} tiles fell back to the host decoder"
    err2 = np.abs(out_dev[:, :, 0].astype(np.float64) - data[:, :, 0])[mask].max()
    assert err2 <= 0.011
    assert np.all(out_dev[:, :, 0][~mask] == 0)


def test_mosaic_global_ranges():
    mesh = make_mesh(8)
    data = _raster(64, 64, seed=3)
    enc = MosaicEncoder(mesh, 32, 32, np.float32, n_depth=1)
    blob = enc.encode(data, None, 0.001)
    info, _ = read_mosaic(blob)
    assert info["z_min"] <= float(data.min()) + 1e-3
    assert info["z_max"] >= float(data.max()) - 1e-3


def test_sharded_tiles_match_single_device_sizes():
    """Full-strength sharded encode: per-tile blob
    payloads match the single-device encoder (LUT on, 16x16 retrial) on
    the same tiles."""
    import jax.numpy as jnp
    from lerc_tpu.constants import DataType
    from lerc_tpu.ops import device_encode
    from lerc_tpu.parallel.sharding import split_into_tiles

    mesh = make_mesh(4)
    h = w = 64
    data = _raster(h, w, seed=5)
    enc = MosaicEncoder(mesh, 32, 32, np.float32, n_depth=1)
    blob = enc.encode(data, None, 0.05)  # coarse: low bitrate, 16x16 eligible
    info, views = read_mosaic(blob)

    tiles, masks, _ = split_into_tiles(data, None, 32, 32)
    from lerc_tpu.codec import header as hdrm

    for t, view in enumerate(views):
        hd, _ = hdrm.read_header(view)
        best = None
        for mb in (8, 16):
            _s, total, _a, _b, _c, _d2 = device_encode.encode_tiles(
                jnp.asarray(tiles[t]), jnp.asarray(masks[t]), jnp.float32(0.05),
                32, 32, 1, DataType.FLOAT, True, 6, enc.cap,
                enable_lut=True, mb=mb,
            )
            total = int(total)
            if mb == 8:
                t8 = total
                best = total
            else:
                gate = (t8 * 16 < 3 * 32 * 32) and (t8 < 4 * 4 * 32 * 32)
                if gate and total <= t8:
                    best = total
        # payload length = blob minus fixed sections (header, empty mask
        # length, 2x f32 ranges, the one-sweep flag; no image-mode byte for
        # lossy float)
        got = len(bytes(view)) - (hdrm.header_size(6) + 4 + 8 + 1)
        assert got == best, (t, got, best)


def test_mosaic_16x16_tiles_device_decode(monkeypatch):
    """Tiles that pick the 16x16 retrial carry micro_block_size=16, ship
    their 16x16 record index, and decode on the DEVICE fast path -- zero
    host fallbacks."""
    mesh = make_mesh(4)
    h = w = 64
    # constant raster with binary-noise quads: noise blocks stuff at 1 bpp
    # where the per-block header dominates, so 16x16 (quarter the headers)
    # wins and the low-bitrate gates pass deterministically
    rng = np.random.default_rng(3)
    data = np.full((h, w, 1), 100.0, np.float32)
    # one quad per 32x32 tile: a fully-constant tile encodes header-only
    # (no record index) and would legitimately take the host path
    for r0, c0 in ((0, 0), (0, 32), (32, 0), (32, 32)):
        data[r0:r0 + 16, c0:c0 + 16, 0] += rng.integers(
            0, 2, (16, 16)).astype(np.float32)
    enc = MosaicEncoder(mesh, 32, 32, np.float32, n_depth=1)
    blob = enc.encode(data, None, 0.5)
    from lerc_tpu.codec import header as hdrm

    info, views = read_mosaic(blob)
    any16 = any(hdrm.read_header(v)[0].micro_block_size == 16 for v in views)
    assert any16, "test data failed to trigger the 16x16 retrial"
    import lerc_tpu.codec.orchestrator as orch

    host_calls = []
    real_decode_blob = orch.decode_blob
    monkeypatch.setattr(
        orch, "decode_blob",
        lambda *a, **k: (host_calls.append(1), real_decode_blob(*a, **k))[1],
    )
    out = decode_mosaic_device(blob)
    assert not host_calls, f"{len(host_calls)} tiles fell back to the host decoder"
    err = np.abs(out[:, :, 0].astype(np.float64) - data[:, :, 0]).max()
    assert err <= 0.5 * 1.01
    if oracle.available():
        for t, v in enumerate(views):
            ref = oracle.decode(bytes(v))[0].reshape(32, 32)
            i, j = divmod(t, info["grid"][1])
            np.testing.assert_array_equal(
                ref, out[i * 32:(i + 1) * 32, j * 32:(j + 1) * 32, 0])


def test_mosaic_lut_tiles_device_decode(monkeypatch):
    """Blocky few-valued rasters produce LUT records; the batched device
    fast path decodes them via the chained one-hot extraction."""
    rng = np.random.default_rng(11)
    h = w = 64
    base = rng.integers(0, 40, (8, 8)).astype(np.float32) * 500
    data = np.repeat(np.repeat(base, 8, 0), 8, 1)[:, :, None]
    data += rng.choice([0, 200.0, 450.0], (h, w, 1), p=[0.8, 0.1, 0.1])
    mesh = make_mesh(4)
    enc = MosaicEncoder(mesh, 32, 32, np.float32, n_depth=1, try_16=False)
    blob = enc.encode(data, None, 0.001)
    import lerc_tpu.codec.orchestrator as orch

    host_calls = []
    real_decode_blob = orch.decode_blob
    monkeypatch.setattr(
        orch, "decode_blob",
        lambda *a, **k: (host_calls.append(1), real_decode_blob(*a, **k))[1],
    )
    out = decode_mosaic_device(blob)
    assert not host_calls, f"{len(host_calls)} tiles fell back to the host decoder"
    err = np.abs(out[:, :, 0].astype(np.float64) - data[:, :, 0]).max()
    assert err <= 0.0011
    # the data must actually contain LUT records for this test to bite
    from lerc_tpu.parallel.sharding import read_mosaic as rm
    _info, views = rm(blob)
    if oracle.available():
        ref = oracle.decode(bytes(views[0]))[0].reshape(32, 32)
        np.testing.assert_array_equal(ref, out[:32, :32, 0])


def test_mosaic_region_decode(monkeypatch):
    """Random access: decode only the tiles covering a pixel window --
    on the batched device path by default, matching the host path."""
    mesh = make_mesh(4)
    h, w = 96, 96
    data = _raster(h, w, seed=9)
    enc = MosaicEncoder(mesh, 32, 32, np.float32, n_depth=1)
    blob = enc.encode(data, None, 0.01)
    from lerc_tpu.parallel.sharding import decode_mosaic_region

    region_host = decode_mosaic_region(blob, 10, 70, 40, 90, device=False)
    import lerc_tpu.codec.orchestrator as orch

    host_calls = []
    real_decode_blob = orch.decode_blob
    monkeypatch.setattr(
        orch, "decode_blob",
        lambda *a, **k: (host_calls.append(1), real_decode_blob(*a, **k))[1],
    )
    region = decode_mosaic_region(blob, 10, 70, 40, 90)
    assert not host_calls, "region decode fell back to the host decoder"
    assert region.shape == (60, 50, 1)
    err = np.abs(region[:, :, 0].astype(np.float64)
                 - data[10:70, 40:90, 0]).max()
    assert err <= 0.0101
    np.testing.assert_array_equal(region, region_host)


def test_mosaic_streamed_encode_matches():
    """Bounded-memory band-streamed encode produces the same container
    as the whole-raster encode."""
    mesh = make_mesh(4)
    h, w = 80, 96  # ragged last band (80 = 2*32 + 16)
    data = _raster(h, w, seed=10)
    mask = np.ones((h, w), bool)
    mask[5:20, 40:70] = False
    enc = MosaicEncoder(mesh, 32, 32, np.float32, n_depth=1)
    whole = enc.encode(data, mask, 0.01)

    def rows(i):
        return data[i * 32 : min((i + 1) * 32, h)]

    def mrows(i):
        return mask[i * 32 : min((i + 1) * 32, h)]

    streamed = enc.encode_streamed(rows, h, w, 0.01, mask_provider=mrows)
    assert streamed == whole
    out = decode_mosaic_device(streamed)
    err = np.abs(out[:, :, 0].astype(np.float64) - data[:, :, 0])[mask].max()
    assert err <= 0.0101


def test_mosaic_multiband_device_decode(monkeypatch):
    """Multi-band mosaic: per-tile blobs are standard
    multi-band LERC blobs (band concat + mask-reuse flag, Lerc.cpp:
    130-176,717-741) the reference decodes with correct per-band masks;
    the batched device path decodes every (tile, band) unit."""
    mesh = make_mesh(4)
    h = w = 64
    rng = np.random.default_rng(21)
    bands = np.stack([
        _raster(h, w, seed=1)[:, :, 0],
        _raster(h, w, seed=2)[:, :, 0] * 3 + 100,
        rng.normal(0, 10, (h, w)).astype(np.float32).cumsum(axis=1),
    ])[..., None]  # [3, H, W, 1]
    mask = np.ones((h, w), bool)
    mask[5:20, 30:60] = False
    enc = MosaicEncoder(mesh, 32, 32, np.float32, n_depth=1)
    blob = enc.encode(bands, mask, 0.01)

    info, views = read_mosaic(blob)
    assert info["n_bands"] == 3

    import lerc_tpu.codec.orchestrator as orch

    host_calls = []
    real_decode_blob = orch.decode_blob
    monkeypatch.setattr(
        orch, "decode_blob",
        lambda *a, **k: (host_calls.append(1), real_decode_blob(*a, **k))[1],
    )
    out = decode_mosaic_device(blob)
    assert not host_calls, f"{len(host_calls)} tiles fell back to the host decoder"
    assert out.shape == (3, h, w, 1)
    for b in range(3):
        err = np.abs(out[b, :, :, 0].astype(np.float64)
                     - bands[b, :, :, 0])[mask].max()
        assert err <= 0.01 * 1.01, (b, err)

    # shared mask -> bands 1, 2 reuse band 0's mask section (dedup) and
    # the reference library decodes each tile blob with per-band masks
    if oracle.available():
        for t, v in enumerate(views):
            data_r, mask_r, *_ = oracle.decode(bytes(v))
            assert data_r.shape[0] == 3
            ref = np.asarray(data_r).reshape(3, 32, 32)
            i, j = divmod(t, info["grid"][1])
            sl = np.s_[i * 32:(i + 1) * 32, j * 32:(j + 1) * 32]
            tm = mask[sl]
            for b in range(3):
                # device decode is bit-exact vs the reference (r4)
                np.testing.assert_array_equal(ref[b][tm], out[b][sl + (0,)][tm])
    # per-band Lerc2 blobs share one inline mask per tile (reuse flag)
    from lerc_tpu.parallel.sharding import _tile_band_layouts
    from lerc_tpu.codec import header as hdrm
    layouts = _tile_band_layouts(views, 3)
    masked_tiles = 0
    for t, lay in enumerate(layouts):
        inline = []
        for b in range(3):
            base, hd = lay[b]
            pos = base + hdrm.header_size(hd.version)
            nbm = int.from_bytes(views[t][pos:pos + 4], "little", signed=True)
            inline.append(nbm)
        if 0 < lay[0][1].num_valid_pixel < 32 * 32:
            masked_tiles += 1
            assert inline[0] > 0 and inline[1] == 0 and inline[2] == 0, inline
    assert masked_tiles > 0


def test_mosaic_multiband_region_and_host_agree():
    mesh = make_mesh(4)
    h = w = 96
    bands = np.stack([_raster(h, w, seed=4)[:, :, 0],
                      _raster(h, w, seed=5)[:, :, 0] * 2])[..., None]
    enc = MosaicEncoder(mesh, 32, 32, np.float32, n_depth=1)
    blob = enc.encode(bands, None, 0.01)
    from lerc_tpu.parallel.sharding import decode_mosaic_region

    full = decode_mosaic_device(blob)
    host = decode_mosaic(blob)
    assert full.shape == host.shape == (2, h, w, 1)
    np.testing.assert_array_equal(full, host)
    reg = decode_mosaic_region(blob, 15, 80, 20, 90)
    assert reg.shape == (2, 65, 70, 1)
    np.testing.assert_array_equal(reg, full[:, 15:80, 20:90])


def test_mosaic_multiband_per_band_masks():
    """Distinct per-band masks: no dedup, each band carries its own."""
    mesh = make_mesh(4)
    h = w = 64
    bands = np.stack([_raster(h, w, seed=6)[:, :, 0],
                      _raster(h, w, seed=7)[:, :, 0]])[..., None]
    masks = np.ones((2, h, w), bool)
    masks[0, :10, :30] = False
    masks[1, 40:, 20:50] = False
    enc = MosaicEncoder(mesh, 32, 32, np.float32, n_depth=1)
    blob = enc.encode(bands, masks, 0.005)
    out = decode_mosaic_device(blob)
    for b in range(2):
        err = np.abs(out[b, :, :, 0].astype(np.float64)
                     - bands[b, :, :, 0])[masks[b]].max()
        assert err <= 0.005 * 1.01
    if oracle.available():
        info, views = read_mosaic(blob)
        saw_two = False
        for t, v in enumerate(views):
            data_r, mask_r, *_ = oracle.decode(bytes(v))
            i, j = divmod(t, info["grid"][1])
            sl = np.s_[i * 32:(i + 1) * 32, j * 32:(j + 1) * 32]
            if mask_r is None:  # fully-valid tile in both bands
                assert masks[0][sl].all() and masks[1][sl].all()
                continue
            got_masks = np.asarray(mask_r).reshape(-1, 32, 32).astype(bool)
            assert got_masks.shape[0] == 2  # distinct masks: no dedup
            saw_two = True
            for b in range(2):
                np.testing.assert_array_equal(got_masks[b], masks[b][sl])
        assert saw_two


def test_mosaic_sharded_decode_matches_single_device():
    """Sharded mosaic decode: decode_mosaic_device(mesh=...) places the
    per-unit batch arrays with NamedSharding over the tile axis (whole
    units per shard; the stream replicates), so each device decodes its
    tile slice. Must be bit-identical to the single-device batched decode
    and within tolerance of the input, masked tiles included."""
    mesh = make_mesh(8)
    h = w = 128
    data = _raster(h, w, seed=11)
    mask = np.ones((h, w), bool)
    mask[10:40, 20:90] = False
    enc = MosaicEncoder(mesh, 32, 32, np.float32, n_depth=1)
    blob = enc.encode(data, mask, 0.004)

    out_single = decode_mosaic_device(blob)
    out_sharded = decode_mosaic_device(blob, mesh=mesh)
    np.testing.assert_array_equal(out_sharded, out_single)
    err = np.abs(out_sharded.astype(np.float64)
                 - data.astype(np.float64))[mask].max()
    assert err <= 0.004 * 1.4  # f32 reconstruction tolerance


def test_mosaic_f64_softfloat():
    """Lossy float64 mosaic (round 5): sharded double-single encode
    (device_f64 kernels under shard_map, host-exact hi/lo split + z
    ranges) and device-first decode (decode_band_device softfloat
    dequant). Every tile blob must be reference-decodable; host and
    device mosaic decodes agree within the bound; a masked variant too."""
    mesh = make_mesh(4)
    rng = np.random.default_rng(21)
    h = w = 96
    data = rng.normal(1e7, 1e3, (h, w, 1))
    enc = MosaicEncoder(mesh, 32, 32, np.float64, n_depth=1)
    blob = enc.encode(data, None, 0.25)
    out = decode_mosaic_device(blob)
    assert out.dtype == np.float64
    assert np.abs(out - data).max() <= 0.25 * 1.01

    out_host = decode_mosaic(blob)
    assert np.abs(out_host - data).max() <= 0.25 * 1.01

    if oracle.available():
        info, views = read_mosaic(blob)
        for t, v in enumerate(views):
            ref = oracle.decode(bytes(v))
            ti, tj = divmod(t, info["grid"][1])
            tile = data[ti * 32:(ti + 1) * 32, tj * 32:(tj + 1) * 32, 0]
            assert np.abs(ref[0].reshape(32, 32) - tile).max() <= 0.25 * 1.01

    # masked f64 mosaic + region decode
    from lerc_tpu.parallel.sharding import decode_mosaic_region
    mask = rng.random((h, w)) > 0.2
    blob_m = enc.encode(data, mask, 0.25)
    out_m = decode_mosaic_device(blob_m)
    assert np.abs(out_m - data)[mask].max() <= 0.25 * 1.01
    reg = decode_mosaic_region(blob_m, 10, 70, 5, 90)
    assert np.abs(reg - data[10:70, 5:90])[mask[10:70, 5:90]].max() <= 0.25 * 1.01
