"""MANBAVARAN: the format's reserved second compression method,
implemented as a real static-model rANS coder (ako_tpu extension).

The reference reserves the enum value (ako.h:71) but ignores it — its
coder always writes Kagari bytes (compression.c:39). Contract here:
- default (env off): byte parity with the reference — MANBAVARAN
  settings produce Kagari bytes under the reserved flag;
- AKO_TPU_MANBAVARAN=1: real rANS payloads (akort.c wire format with
  magic byte), decodable by every decode surface;
- the decoder auto-detects either payload under the reserved flag, in
  both env states (PARITY.md divergence 12);
- compression is at least on par with Kagari on photographic content.
"""

from __future__ import annotations

import numpy as np
import pytest

import ako_tpu
from ako_tpu.core import container
from ako_tpu.core.settings import Compression, Settings, Wavelet
from ako_tpu.encode import checked_settings
from ako_tpu.runtime.kagari import (
    effective_method,
    kagari_encode,
    manba_decode,
    manba_encode,
)
from tests import oracle


@pytest.fixture
def rng():
    return np.random.default_rng(0x2A15)


def _photo(rng, h, w, ch=3):
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 120 + 60 * np.sin(x / 29.0) + 50 * np.cos(y / 17.0)
    img = np.stack(
        [np.clip(base * (0.6 + 0.1 * c), 0, 255) for c in range(ch)], axis=-1
    )
    img += rng.normal(0, 3.0, size=img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


class TestRawCoder:
    def test_roundtrip_values(self, rng):
        cases = [
            rng.integers(-32768, 32768, size=5000).astype(np.int16),
            np.zeros(10000, np.int16),
            np.array([-32768, 32767, 0, 1, -1] * 100, np.int16),
            (rng.normal(0, 4, size=20000)).astype(np.int16),
            np.array([7], np.int16),
        ]
        for vals in cases:
            p = manba_encode(vals, max(vals.nbytes * 3, 64))
            assert p is not None
            assert np.array_equal(manba_decode(len(vals), p), vals)

    def test_incompressible_fails_cleanly(self, rng):
        vals = rng.integers(-32768, 32768, size=4096).astype(np.int16)
        assert manba_encode(vals, 64) is None  # won't fit

    def test_corrupt_input_rejected(self, rng):
        vals = (rng.normal(0, 3, size=2000)).astype(np.int16)
        p = bytearray(manba_encode(vals, vals.nbytes * 2))
        assert manba_decode(len(vals), bytes(p[: len(p) // 4])) is None or True
        p[0] ^= 0xFF  # magic byte gone -> must reject, never crash
        assert manba_decode(len(vals), bytes(p)) is None

    def test_fuzz_decode_never_crashes(self, rng):
        for _ in range(50):
            junk = rng.integers(0, 256, size=int(rng.integers(1, 400)))
            manba_decode(128, junk.astype(np.uint8).tobytes())

    def test_beats_kagari_on_quantized_stats(self, rng):
        # q16-like coefficient statistics: mostly zeros + small values
        coeffs = (rng.normal(0, 2.2, size=40000) ** 3 / 8).astype(np.int16)
        pk = kagari_encode(coeffs, 10**7)
        pm = manba_encode(coeffs, 10**7)
        assert len(pm) < len(pk)


class TestEffectiveMethod:
    def test_reserved_means_kagari_by_default(self, monkeypatch):
        monkeypatch.delenv("AKO_TPU_MANBAVARAN", raising=False)
        assert effective_method(Compression.MANBAVARAN) == Compression.KAGARI
        monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
        assert effective_method(Compression.MANBAVARAN) == Compression.MANBAVARAN
        assert effective_method(Compression.KAGARI) == Compression.KAGARI
        assert effective_method(Compression.NONE) == Compression.NONE


class TestEndToEnd:
    def test_parity_mode_matches_reference(self, rng, monkeypatch):
        monkeypatch.delenv("AKO_TPU_MANBAVARAN", raising=False)
        img = _photo(rng, 90, 70)
        s = Settings(quantization=16, tiles_dimension=64,
                     compression=Compression.MANBAVARAN)
        blob = ako_tpu.encode(img, s, device_entropy=False)
        got = ako_tpu.decode(blob, device_entropy=False)[0]
        # parity mode: the reference ignores the method flag and writes
        # Kagari bytes, so only the container head differs from KAGARI
        kag = ako_tpu.encode(img, s.replace(compression=Compression.KAGARI),
                             device_entropy=False)
        assert blob[container.HEAD_SIZE:] == kag[container.HEAD_SIZE:]
        assert np.array_equal(got, ako_tpu.decode(kag, device_entropy=False)[0])
        if oracle.available():
            assert blob == oracle.ref_encode(img, checked_settings(s))
            assert np.array_equal(got, oracle.ref_decode(blob)[0])

    def test_extension_roundtrip_and_ratio(self, rng, monkeypatch):
        monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
        img = _photo(rng, 150, 130, 4)
        s = Settings(quantization=16, tiles_dimension=64,
                     compression=Compression.MANBAVARAN)
        blob = ako_tpu.encode(img, s, device_entropy=False)
        got = ako_tpu.decode(blob, device_entropy=False)[0]
        # pixels must equal the Kagari-settings decode (the entropy
        # layer is lossless; only the payload bytes differ)
        sk = Settings(quantization=16, tiles_dimension=64)
        blob_k = ako_tpu.encode(img, sk, device_entropy=False)
        assert np.array_equal(got, ako_tpu.decode(blob_k, device_entropy=False)[0])
        # the extension should compress photographic content tighter
        assert len(blob) < len(blob_k)

    def test_lossless_extension_roundtrip(self, rng, monkeypatch):
        monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
        img = _photo(rng, 64, 48, 3)
        s = Settings(quantization=0, compression=Compression.MANBAVARAN)
        blob = ako_tpu.encode(img, s, device_entropy=False)
        assert np.array_equal(ako_tpu.decode(blob, device_entropy=False)[0], img)

    def test_auto_detect_both_directions(self, rng, monkeypatch):
        img = _photo(rng, 90, 70)
        s = Settings(quantization=16, tiles_dimension=64,
                     compression=Compression.MANBAVARAN)
        monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
        blob_rans = ako_tpu.encode(img, s, device_entropy=False)
        monkeypatch.delenv("AKO_TPU_MANBAVARAN")
        blob_kag = ako_tpu.encode(img, s, device_entropy=False)
        assert blob_rans != blob_kag
        expect = ako_tpu.decode(blob_kag, device_entropy=False)[0]
        # each payload provenance decodes correctly in each env state
        for env in (None, "1"):
            if env:
                monkeypatch.setenv("AKO_TPU_MANBAVARAN", env)
            else:
                monkeypatch.delenv("AKO_TPU_MANBAVARAN", raising=False)
            for blob in (blob_rans, blob_kag):
                got = ako_tpu.decode(blob, device_entropy=False)[0]
                assert np.array_equal(got, expect)

    def test_host_decode_path(self, rng, monkeypatch):
        monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
        img = _photo(rng, 90, 70)
        s = Settings(quantization=16, tiles_dimension=64,
                     compression=Compression.MANBAVARAN)
        blob = ako_tpu.encode(img, s, device_entropy=False)
        expect = ako_tpu.decode(blob, device_entropy=False)[0]
        monkeypatch.setenv("AKO_TPU_DECODE", "host")
        assert np.array_equal(ako_tpu.decode(blob)[0], expect)

    def test_streaming_iter(self, rng, monkeypatch):
        monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
        from ako_tpu.decode import decode_tiles_iter

        img = _photo(rng, 64, 64, 3)
        s = Settings(quantization=16, tiles_dimension=32,
                     compression=Compression.MANBAVARAN)
        blob = ako_tpu.encode(img, s, device_entropy=False)
        full = ako_tpu.decode(blob, device_entropy=False)[0]
        out = np.zeros_like(full)
        for t, pixels in decode_tiles_iter(blob):
            out[t.y : t.y + t.h, t.x : t.x + t.w, :] = pixels
        assert np.array_equal(out, full)

    def test_rate_control_with_extension(self, rng, monkeypatch):
        monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
        from ako_tpu.tools.rate import encode_with_ratio

        img = _photo(rng, 128, 128, 3)
        s = Settings(compression=Compression.MANBAVARAN, tiles_dimension=64)
        blob, q = encode_with_ratio(img, s, ratio=12.0)
        assert blob is not None
        raw = img.size
        assert abs(raw / len(blob) - 12.0) / 12.0 < 0.3  # search converged
        got = ako_tpu.decode(blob, device_entropy=False)[0]
        assert got.shape == img.shape


@pytest.mark.skipif(
    __import__("jax").device_count() < 8, reason="needs 8 (virtual) devices"
)
class TestShardedMethods:
    def test_sharded_encode_none_and_manbavaran(self, rng, monkeypatch):
        # NONE previously emitted Kagari bytes from the sharded path
        # (latent bug found while wiring MANBAVARAN); both methods must
        # match the single-chip blob byte-for-byte
        from ako_tpu.parallel import make_mesh
        from ako_tpu.parallel.tiles import encode_image_sharded

        mesh = make_mesh((8,), ("tiles",))
        img = _photo(rng, 64, 96, 3)
        for env in (None, "1"):
            if env:
                monkeypatch.setenv("AKO_TPU_MANBAVARAN", env)
            else:
                monkeypatch.delenv("AKO_TPU_MANBAVARAN", raising=False)
            for comp in (Compression.NONE, Compression.MANBAVARAN):
                s = Settings(quantization=16, tiles_dimension=32, compression=comp)
                ref = ako_tpu.encode(img, s, device_entropy=False)
                got = encode_image_sharded(img, s, mesh)
                assert got == ref, (env, comp)


class TestDeviceDecoder:
    """The device rANS decoder (ops/manba_device.py) must be bit-exact
    with the native host decoder, standalone and through the fused
    device-entropy decode path."""

    def test_kernel_parity(self, rng):
        import jax.numpy as jnp

        from ako_tpu.ops.manba_device import (
            DECODE_BLOCK,
            DECODE_SLACK_WORDS,
            manba_decode_device,
            span_words,
        )
        from ako_tpu.runtime.kagari import manba_sync

        for vals in [
            (rng.normal(0, 2.2, size=21846) ** 3 / 8).astype(np.int16),
            np.zeros(5000, np.int16),
            rng.integers(-32768, 32768, size=3000).astype(np.int16),
            np.array([-32768, 32767, 0] * 500, np.int16),
        ]:
            p = manba_encode(vals, vals.nbytes * 3)
            sy = manba_sync(len(vals), p, DECODE_BLOCK)
            assert sy is not None
            x, rbyte, ebit, freq, _ro, rans_end, extras_off, consumed = sy
            assert consumed == len(p)
            w = (len(p) + 3) // 4 + DECODE_SLACK_WORDS
            pool8 = np.zeros(w * 4, np.uint8)
            pool8[: len(p)] = np.frombuffer(p, np.uint8)
            words = jnp.asarray(pool8.view(">u4").astype(np.uint32))
            rspan = min(span_words(rbyte, rans_end, bits=False), w)
            espan = min(
                span_words(
                    ebit.astype(np.int64) + extras_off * 8, len(p) * 8, bits=True
                ),
                w,
            )
            out = np.asarray(
                manba_decode_device(
                    words,
                    jnp.asarray(x),
                    jnp.asarray(rbyte),
                    jnp.asarray(ebit),
                    jnp.asarray(freq.astype(np.int32)),
                    rans_end,
                    extras_off,
                    len(vals),
                    DECODE_BLOCK,
                    rspan,
                    espan,
                )
            )
            assert np.array_equal(out, vals)

    def test_sync_rejects_kagari_payload(self, rng):
        from ako_tpu.ops.manba_device import DECODE_BLOCK
        from ako_tpu.runtime.kagari import manba_sync

        vals = (rng.normal(0, 3, size=2000)).astype(np.int16)
        p = kagari_encode(vals, vals.nbytes * 2)
        assert manba_sync(len(vals), p, DECODE_BLOCK) is None

    def test_fused_device_entropy_decode(self, rng, monkeypatch):
        # the full device path: sync scan -> device rANS -> device
        # unlift -> pixels, against the host decode of the same blob;
        # ragged grid = several shape groups incl. a mixed batch
        monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
        img = _photo(rng, 150, 130, 4)
        s = Settings(quantization=16, tiles_dimension=64,
                     compression=Compression.MANBAVARAN)
        blob = ako_tpu.encode(img, s, device_entropy=False)
        expect = ako_tpu.decode(blob, device_entropy=False)[0]
        got = ako_tpu.decode(blob, device_entropy=True)[0]
        assert np.array_equal(got, expect)

    def test_fused_path_reads_reference_style_blob(self, rng, monkeypatch):
        # reserved-flag blob carrying Kagari bytes: the device path
        # must fall back to the Kagari device decoder per block
        monkeypatch.delenv("AKO_TPU_MANBAVARAN", raising=False)
        img = _photo(rng, 90, 70)
        s = Settings(quantization=16, tiles_dimension=64,
                     compression=Compression.MANBAVARAN)
        blob = ako_tpu.encode(img, s, device_entropy=False)  # Kagari bytes
        expect = ako_tpu.decode(blob, device_entropy=False)[0]
        monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
        got = ako_tpu.decode(blob, device_entropy=True)[0]
        assert np.array_equal(got, expect)

    def test_pipeline_stream(self, rng, monkeypatch):
        monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
        from ako_tpu.runtime.executor import PipelineDecoder, PipelineEncoder

        s = Settings(quantization=16, tiles_dimension=64,
                     compression=Compression.MANBAVARAN)
        imgs = [_photo(rng, 96, 64, 4), _photo(rng, 96, 64, 4)]
        blobs = PipelineEncoder(s, device_entropy=False).encode_batch(imgs)
        got = list(PipelineDecoder().decode_iter(blobs, device_entropy=True))
        for blob, pix in zip(blobs, got):
            assert np.array_equal(pix, ako_tpu.decode(blob, device_entropy=False)[0])


class TestExtensionFuzz:
    """Corruption robustness for extension blobs. The reference cannot
    decode real-rANS payloads, so there is no oracle to agree with:
    the contract is never-crash and clean failure (AkoError) or
    deterministic output, on both the host and device entropy paths."""

    def _blob(self, rng):
        # callers set AKO_TPU_MANBAVARAN=1 via monkeypatch
        img = _photo(rng, 70, 90)
        s = Settings(quantization=16, tiles_dimension=64,
                     compression=Compression.MANBAVARAN)
        return ako_tpu.encode(img, s, device_entropy=False)

    def _decode_any(self, blob, device_entropy):
        from ako_tpu.core.settings import AkoError

        try:
            return ako_tpu.decode(blob, device_entropy=device_entropy)[0]
        except AkoError:
            return None
        except Exception as e:  # anything else is a bug
            raise AssertionError(f"non-AkoError failure: {type(e).__name__}: {e}")

    @pytest.mark.parametrize("device_entropy", [False, True])
    def test_truncations(self, rng, monkeypatch, device_entropy):
        monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
        blob = self._blob(rng)
        for frac in (0.1, 0.3, 0.6, 0.9, 0.99):
            self._decode_any(blob[: int(len(blob) * frac)], device_entropy)

    @pytest.mark.parametrize("device_entropy", [False, True])
    def test_payload_flips_deterministic(self, rng, monkeypatch, device_entropy):
        monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
        blob = self._blob(rng)
        for _ in range(12):
            b = bytearray(blob)
            pos = int(rng.integers(20, len(b)))
            b[pos] ^= int(rng.integers(1, 256))
            one = self._decode_any(bytes(b), device_entropy)
            two = self._decode_any(bytes(b), device_entropy)
            if one is None:
                assert two is None
            else:
                assert np.array_equal(one, two)


def test_tiny_tile_negative_capacity_fails_cleanly(rng, monkeypatch):
    """A 1x1 grid-remainder tile has tds=2, so compress_block's payload
    capacity is tds-4 = -2: the wrappers must fail up front (ctypes
    would wrap the negative into a huge c_size_t and the native coder
    would overrun the 1-byte numpy buffer — found by review). Both
    coders fail such tiles, matching the reference's own failure."""
    from ako_tpu.core.settings import AkoError
    from ako_tpu.runtime.kagari import compress_block, kagari_encode

    vals = np.zeros(1, np.int16)
    assert manba_encode(vals, -2) is None
    assert manba_encode(vals, 0) is None
    assert kagari_encode(vals, -2) is None
    monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
    assert compress_block(vals, 2, Compression.MANBAVARAN) is None
    img = _photo(rng, 33, 33, 1)
    for comp in (Compression.KAGARI, Compression.MANBAVARAN):
        with pytest.raises(AkoError):
            ako_tpu.encode(
                img,
                Settings(quantization=16, tiles_dimension=32, compression=comp),
                device_entropy=False,
            )
    # the reference fails these too (its wrapped pointer bound rejects)
    if oracle.available():
        assert (
            oracle.ref_encode(
                img, checked_settings(Settings(quantization=16, tiles_dimension=32))
            )
            is None
        )


class TestDeviceEncoder:
    """The device rANS ENCODER (ops.manba_device.manba_encode_device)
    must produce byte-identical payloads to the native host coder
    (akort_manba_encode) — device-native in both directions."""

    def _device_payload(self, vals, budget=None):
        import jax
        import jax.numpy as jnp

        from ako_tpu.ops.manba_device import manba_encode_device
        from ako_tpu.runtime.kagari import manba_assemble

        cap = vals.size * 2 + 64
        budget = cap if budget is None else budget
        fn = jax.jit(lambda v: manba_encode_device(v, budget))
        freq, x, rrow, rbytes, erow, ebits, ok = [
            np.asarray(a) for a in fn(jnp.asarray(vals))
        ]
        return manba_assemble(freq, x, rrow, rbytes, erow, ebits, ok, cap)

    @pytest.mark.parametrize(
        "kind",
        ["photo", "zeros", "fullrange", "int16min", "single", "runs"],
    )
    def test_kernel_parity(self, rng, kind):
        from ako_tpu.runtime.kagari import manba_encode

        vals = {
            "photo": (rng.normal(0, 2.2, size=21846) ** 3 / 8).astype(np.int16),
            "zeros": np.zeros(5000, np.int16),
            "fullrange": rng.integers(-32768, 32768, size=3000).astype(np.int16),
            "int16min": np.tile(
                np.array([-32768, 7, -32768, 0], np.int16), 500
            ),
            "single": np.array([123], np.int16),
            "runs": np.repeat(
                rng.integers(-60, 60, size=40).astype(np.int16), 173
            ),
        }[kind]
        ref = manba_encode(vals, vals.size * 2 + 64)
        got = self._device_payload(vals)
        assert ref is not None and got is not None
        assert got == ref

    def test_tile_stream_parity(self, rng):
        # real coefficient statistics: a lifted+quantized tile stream
        import jax.numpy as jnp

        from ako_tpu.core import geometry
        from ako_tpu.ops.colorspace import to_planar_yuv
        from ako_tpu.ops.lifting import forward_tile
        from ako_tpu.ops.quantization import level_qg
        from ako_tpu.core.settings import Color, Wavelet, Wrap
        from ako_tpu.runtime.kagari import manba_encode

        tile = _photo(rng, 96, 64, ch=4)
        sched = geometry.lift_schedule(64, 96)
        qg = level_qg(sched, 4, 16, 0, 1)
        planes = to_planar_yuv(jnp.asarray(tile), Color.YCOCG_Q, False)
        stream = np.asarray(
            forward_tile(planes, sched, Wavelet.DD137, Wrap.CLAMP, qg)
        )
        ref = manba_encode(stream, stream.size * 2 + 64)
        got = self._device_payload(stream)
        assert ref is not None and got == ref

    def test_budget_truncation_returns_none(self, rng):
        # a budget smaller than the stream must yield None (host
        # fallback), never corrupt bytes
        vals = rng.integers(-32768, 32768, size=4000).astype(np.int16)
        got = self._device_payload(vals, budget=64)
        assert got is None

    def test_block_roundtrip_through_decoder(self, rng, monkeypatch):
        # device-encoded payload framed as a block decodes through
        # decompress_block (host) and matches the input
        import struct

        from ako_tpu.runtime.kagari import decompress_block

        monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
        vals = (rng.normal(0, 3.0, size=8192) ** 3 / 9).astype(np.int16)
        payload = self._device_payload(vals)
        assert payload is not None
        block = struct.pack("<I", len(payload)) + payload
        out = decompress_block(
            memoryview(block), vals.size * 2, vals.size * 2 + 64,
            Compression.MANBAVARAN,
        )
        assert out is not None
        np.testing.assert_array_equal(out[0], vals)

    @pytest.mark.parametrize(
        "kw",
        [
            dict(quantization=16, tiles_dimension=64),
            dict(quantization=0, tiles_dimension=32),
            dict(quantization=16, wavelet=Wavelet.HAAR),
        ],
    )
    def test_fused_device_entropy_encode(self, rng, monkeypatch, kw):
        # the full fused path: format+lift+device rANS -> blob
        # byte-identical to the host-entropy path, and decodable
        monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
        img = _photo(rng, 96, 64, ch=4)
        s = Settings(compression=Compression.MANBAVARAN, **kw)
        dev = ako_tpu.encode(img, s, device_entropy=True)
        host = ako_tpu.encode(img, s, device_entropy=False)
        assert dev == host
        out = ako_tpu.decode(dev, device_entropy=False)[0]
        assert np.array_equal(out, ako_tpu.decode(host, device_entropy=True)[0])

    def test_fused_reserved_flag_stays_parity(self, rng, monkeypatch):
        # WITHOUT the extension env, a MANBAVARAN-flagged encode must
        # keep emitting reference-parity Kagari bytes on every path
        monkeypatch.delenv("AKO_TPU_MANBAVARAN", raising=False)
        img = _photo(rng, 96, 64, ch=4)
        s = Settings(compression=Compression.MANBAVARAN, quantization=16,
                     tiles_dimension=64)
        dev = ako_tpu.encode(img, s, device_entropy=True)
        host = ako_tpu.encode(img, s, device_entropy=False)
        assert dev == host
        kag = ako_tpu.encode(img, s.replace(compression=Compression.KAGARI),
                             device_entropy=False)
        assert dev[container.HEAD_SIZE:] == kag[container.HEAD_SIZE:]
        if oracle.available():
            ref = oracle.ref_encode(img, checked_settings(s))
            assert ref is not None and dev == ref
