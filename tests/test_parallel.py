"""Sharding correctness on the virtual 8-device CPU mesh: the
multi-chip paths must produce bit-identical streams/pixels to the
single-chip path (and therefore to the reference)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ako_tpu.core import geometry
from ako_tpu.core.settings import Settings, Wavelet, Wrap, Color
from ako_tpu.encode import encode_tiles_device, checked_settings
from ako_tpu.ops.colorspace import to_planar_yuv
from ako_tpu.ops.lifting import forward_tile, inverse_tile
from ako_tpu.ops.quantization import level_qg
from ako_tpu.parallel import make_mesh, forward_tile_sharded, inverse_tile_sharded
from ako_tpu.parallel.tiles import encode_tiles_sharded

needs_8dev = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


@needs_8dev
class TestHaloShardedLift:
    @pytest.mark.parametrize("wavelet", [Wavelet.DD137, Wavelet.CDF53, Wavelet.HAAR])
    @pytest.mark.parametrize("wrap", [Wrap.CLAMP, Wrap.REPEAT, Wrap.ZERO, Wrap.MIRROR])
    def test_forward_matches_single_chip(self, rng, wavelet, wrap):
        mesh = make_mesh((8,), ("rows",))
        w = h = 128  # 8 shards x 16 rows; 2 sharded levels then replicated
        s = Settings(wavelet=wavelet, wrap=wrap, quantization=16)
        planes = rng.integers(-512, 512, size=(3, h, w)).astype(np.int16)
        schedule = geometry.lift_schedule(w, h)
        qg = level_qg(schedule, 3, s.quantization, s.gate, s.chroma_loss)

        ref = np.asarray(
            jax.jit(lambda p: forward_tile(p, schedule, wavelet, wrap, qg))(
                jnp.asarray(planes)
            )
        )
        sharded = np.asarray(
            jax.jit(
                lambda p: forward_tile_sharded(
                    p, schedule, wavelet, wrap, qg, mesh
                )
            )(jnp.asarray(planes))
        )
        np.testing.assert_array_equal(sharded, ref)

    @pytest.mark.parametrize(
        "wavelet", [Wavelet.DD137, Wavelet.CDF53, Wavelet.HAAR]
    )
    def test_inverse_matches_single_chip(self, rng, wavelet):
        mesh = make_mesh((8,), ("rows",))
        w = h = 128
        s = Settings(wavelet=wavelet, quantization=16)
        planes = rng.integers(-512, 512, size=(2, h, w)).astype(np.int16)
        schedule = geometry.lift_schedule(w, h)
        qg = level_qg(schedule, 2, s.quantization, s.gate, s.chroma_loss)
        coeffs = jax.jit(
            lambda p: forward_tile(p, schedule, wavelet, s.wrap, qg)
        )(jnp.asarray(planes))

        ref = np.asarray(
            jax.jit(lambda c: inverse_tile(c, schedule, wavelet, s.wrap, 2))(coeffs)
        )
        sharded = np.asarray(
            jax.jit(
                lambda c: inverse_tile_sharded(c, schedule, wavelet, s.wrap, 2, mesh)
            )(coeffs)
        )
        np.testing.assert_array_equal(sharded, ref)

    @pytest.mark.parametrize(
        "w,h,wavelet,wrap,min_sharded",
        [
            # odd dims: fake-row materialization + pad-crafted levels
            (127, 127, Wavelet.DD137, Wrap.CLAMP, 2),
            (96, 100, Wavelet.DD137, Wrap.CLAMP, 2),
            (96, 100, Wavelet.DD137, Wrap.ZERO, 2),
            (96, 100, Wavelet.CDF53, Wrap.CLAMP, 2),
            (96, 100, Wavelet.CDF53, Wrap.ZERO, 2),
            (77, 93, Wavelet.DD137, Wrap.CLAMP, 1),
            # Haar reads no neighbors: pads work under every wrap
            (96, 100, Wavelet.HAAR, Wrap.MIRROR, 2),
            # MIRROR/REPEAT + remainder: pad+fix path (the edge
            # substitutions read position-varying rows; the sharded
            # stencil's contaminated boundary outputs are overwritten
            # with the true-boundary formulas)
            (96, 100, Wavelet.DD137, Wrap.MIRROR, 2),
            (96, 100, Wavelet.DD137, Wrap.REPEAT, 2),
            (96, 100, Wavelet.CDF53, Wrap.MIRROR, 2),
            (96, 100, Wavelet.CDF53, Wrap.REPEAT, 2),
            (77, 93, Wavelet.DD137, Wrap.MIRROR, 1),
            (77, 93, Wavelet.DD137, Wrap.REPEAT, 1),
            (127, 127, Wavelet.CDF53, Wrap.REPEAT, 2),
        ],
    )
    def test_odd_dims_pad_sharded(self, rng, w, h, wavelet, wrap, min_sharded):
        from ako_tpu.parallel.halo import plan_levels

        mesh = make_mesh((8,), ("rows",))
        schedule = geometry.lift_schedule(w, h)
        n_sharded = sum(plan_levels(schedule, 8, wavelet, wrap))
        assert n_sharded >= min_sharded
        planes = rng.integers(-512, 512, size=(2, h, w)).astype(np.int16)
        qg = level_qg(schedule, 2, 16, 0, 1)
        ref = np.asarray(
            jax.jit(lambda p: forward_tile(p, schedule, wavelet, wrap, qg))(
                jnp.asarray(planes)
            )
        )
        got = np.asarray(
            jax.jit(
                lambda p: forward_tile_sharded(p, schedule, wavelet, wrap, qg, mesh)
            )(jnp.asarray(planes))
        )
        np.testing.assert_array_equal(got, ref)
        rec_ref = np.asarray(
            jax.jit(lambda c: inverse_tile(c, schedule, wavelet, wrap, 2))(
                jnp.asarray(ref)
            )
        )
        rec = np.asarray(
            jax.jit(
                lambda c: inverse_tile_sharded(c, schedule, wavelet, wrap, 2, mesh)
            )(jnp.asarray(got))
        )
        np.testing.assert_array_equal(rec, rec_ref)

    @pytest.mark.parametrize(
        "wrap", [Wrap.CLAMP, Wrap.ZERO, Wrap.MIRROR, Wrap.REPEAT]
    )
    def test_sharded_level_count_north_star(self, wrap):
        """Guard against the planner silently replicating everything
        (bit-exactness tests cannot catch that): the north-star
        single-tile shapes must shard at least this many pyramid
        levels on the 8-device mesh — under EVERY wrap mode (the r4
        planner sharded ragged levels for CLAMP/ZERO only; the pad+fix
        path closed the MIRROR/REPEAT gap)."""
        from ako_tpu.parallel.halo import plan_levels

        cafe = geometry.lift_schedule(1024, 1280)
        assert sum(plan_levels(cafe, 8, Wavelet.DD137, wrap)) >= 5
        tractor = geometry.lift_schedule(1632, 2464)
        # pre-pad planning sharded only 2 tractor levels (616 % 16 != 0)
        assert sum(plan_levels(tractor, 8, Wavelet.DD137, wrap)) >= 6
        # the wrap axis must not change the plan at all now
        for sched in (cafe, tractor):
            for wv in (Wavelet.DD137, Wavelet.CDF53, Wavelet.HAAR):
                assert plan_levels(sched, 8, wv, wrap) == plan_levels(
                    sched, 8, wv, Wrap.CLAMP
                )

    def test_lossless_roundtrip_sharded(self, rng):
        mesh = make_mesh((8,), ("rows",))
        w = h = 64
        wavelet, wrap = Wavelet.CDF53, Wrap.CLAMP
        planes = rng.integers(-255, 256, size=(1, h, w)).astype(np.int16)
        schedule = geometry.lift_schedule(w, h)
        qg = level_qg(schedule, 1, 0, 0, 1)
        coeffs = jax.jit(
            lambda p: forward_tile_sharded(p, schedule, wavelet, wrap, qg, mesh)
        )(jnp.asarray(planes))
        back = jax.jit(
            lambda c: inverse_tile_sharded(c, schedule, wavelet, wrap, 1, mesh)
        )(coeffs)
        np.testing.assert_array_equal(np.asarray(back), planes)


@needs_8dev
class TestTileParallel:
    def test_sharded_streams_match_single_chip(self, rng):
        mesh = make_mesh((8,), ("tiles",))
        img = rng.integers(0, 256, size=(96, 128, 3), dtype=np.uint8)
        s = checked_settings(Settings(quantization=16, tiles_dimension=32))
        ref = encode_tiles_device(img, s)
        got = encode_tiles_sharded(img, s, mesh)
        assert len(ref) == len(got)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)

    def test_ragged_grid(self, rng):
        # 3x2 grid of 32-tiles + border tiles: batch not divisible by 8
        mesh = make_mesh((8,), ("tiles",))
        img = rng.integers(0, 256, size=(80, 72, 3), dtype=np.uint8)
        s = checked_settings(Settings(quantization=16, tiles_dimension=32))
        ref = encode_tiles_device(img, s)
        got = encode_tiles_sharded(img, s, mesh)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)


@needs_8dev
class TestBitstreamGather:
    def test_sharded_encode_blob_identical(self, rng):
        """Full multi-device encode (tile shards + bitstream all-gather)
        must produce the byte-identical container."""
        import ako_tpu
        from ako_tpu.parallel.tiles import encode_image_sharded

        mesh = make_mesh((8,), ("tiles",))
        img = rng.integers(0, 256, size=(96, 128, 3), dtype=np.uint8)
        s = Settings(quantization=16, tiles_dimension=32)
        ref = ako_tpu.encode(img, s, device_entropy=True)
        got = encode_image_sharded(img, s, mesh)
        assert got == ref


@needs_8dev
class TestStreamingDecode:
    def test_tiles_iter(self, rng):
        import ako_tpu
        from ako_tpu.decode import decode_tiles_iter

        img = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
        s = Settings(quantization=16, tiles_dimension=32)
        blob = ako_tpu.encode(img, s)
        full, _, _ = ako_tpu.decode(blob)
        out = np.zeros_like(full)
        count = 0
        for t, pixels in decode_tiles_iter(blob):
            out[t.y : t.y + t.h, t.x : t.x + t.w, :] = pixels
            count += 1
        assert count == 4
        np.testing.assert_array_equal(out, full)

    def test_truncated_yields_then_raises(self, rng):
        import ako_tpu
        from ako_tpu.decode import decode_tiles_iter

        img = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
        s = Settings(quantization=16, tiles_dimension=32)
        blob = ako_tpu.encode(img, s)
        it = decode_tiles_iter(blob[: len(blob) // 2])
        got = 0
        with pytest.raises(ako_tpu.AkoError):
            for _t, _p in it:
                got += 1
        assert got >= 1  # early tiles stream out before the break


@needs_8dev
class TestShardedDecode:
    @pytest.mark.parametrize("device_entropy", [False, True])
    def test_decode_image_sharded(self, rng, device_entropy):
        import ako_tpu
        from ako_tpu.parallel.tiles import decode_image_sharded

        mesh = make_mesh((8,), ("tiles",))
        img = rng.integers(0, 256, size=(96, 128, 3), dtype=np.uint8)
        s = Settings(quantization=16, tiles_dimension=32)
        blob = ako_tpu.encode(img, s)
        ref, _, _ = ako_tpu.decode(blob)
        got, s2, ch = decode_image_sharded(blob, mesh, device_entropy=device_entropy)
        assert ch == 3
        np.testing.assert_array_equal(got, ref)

    def test_decode_image_sharded_device_entropy_ragged(self, rng):
        # border tiles (two shape groups) + batch not divisible by the
        # mesh: exercises the pad-row repeat and per-shape dispatch
        import ako_tpu
        from ako_tpu.parallel.tiles import decode_image_sharded

        mesh = make_mesh((8,), ("tiles",))
        img = rng.integers(0, 256, size=(80, 72, 4), dtype=np.uint8)
        s = Settings(quantization=16, tiles_dimension=32)
        blob = ako_tpu.encode(img, s)
        ref, _, _ = ako_tpu.decode(blob)
        got, _s2, _ch = decode_image_sharded(blob, mesh, device_entropy=True)
        np.testing.assert_array_equal(got, ref)

    def test_device_entropy_quirk_tiles_fall_back_to_host(self, rng, monkeypatch):
        # oversized-code streams (max_code_bits > 31, the
        # zigzag(-32768) quirk) must route through the exact host
        # decoder and still land in the sharded unlift; force the
        # routing by making the sync scan report oversized codes
        import ako_tpu
        from ako_tpu.runtime import kagari as rk
        from ako_tpu.parallel import tiles as ptiles

        mesh = make_mesh((8,), ("tiles",))
        img = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
        s = Settings(quantization=16, tiles_dimension=32)
        blob = ako_tpu.encode(img, s)
        ref, _, _ = ako_tpu.decode(blob)

        real_sync = rk.kagari_sync
        hits = [0]

        def oversized_first(*a, **k):
            res = real_sync(*a, **k)
            if res is not None and hits[0] == 0:
                hits[0] += 1
                return res[:5] + (32,)
            return res

        monkeypatch.setattr(rk, "kagari_sync", oversized_first)
        got, _s2, _ch = ptiles.decode_image_sharded(blob, mesh, device_entropy=True)
        assert hits[0] == 1
        np.testing.assert_array_equal(got, ref)
