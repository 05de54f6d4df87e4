"""Transport-compressed pixel download (runtime/transport.py): the
device-entropy decode path must produce bit-identical pixels with
AKO_TPU_TRANSPORT=1, including the raw-fetch fallback for
q0-incompressible content. No reference counterpart (the reference
never moves pixels over a link); exactness is vs our own raw path,
which is oracle-tested elsewhere."""

import numpy as np
import pytest

import ako_tpu
from ako_tpu.core.settings import Settings, Wavelet
from ako_tpu.runtime import transport


def _photo(rng, h, w, ch):
    """Smooth structure + mild noise: q0-compressible like a photo."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 120 + 60 * np.sin(x / 37.0) + 50 * np.cos(y / 23.0)
    img = np.stack([np.clip(base * (0.6 + 0.15 * c), 0, 255) for c in range(ch)], axis=-1)
    img += rng.normal(0, 2.0, size=img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _transport_roundtrip(img, s, monkeypatch):
    blob = ako_tpu.encode(img, s)
    ref = ako_tpu.decode(blob, device_entropy=True)[0]
    monkeypatch.setenv("AKO_TPU_TRANSPORT", "1")
    assert transport.enabled()
    got = ako_tpu.decode(blob, device_entropy=True)[0]
    assert np.array_equal(got, ref)
    return blob


class TestTransportDecode:
    @pytest.mark.parametrize("ch", [1, 2, 3, 4])
    def test_bit_exact_per_channel_count(self, rng, ch, monkeypatch):
        img = _photo(rng, 96, 80, ch)
        s = Settings(quantization=16, tiles_dimension=64)
        _transport_roundtrip(img, s, monkeypatch)

    @pytest.mark.parametrize("q", [0, 16])
    def test_quantization_modes(self, rng, q, monkeypatch):
        img = _photo(rng, 64, 64, 3)
        _transport_roundtrip(img, Settings(quantization=q), monkeypatch)

    def test_outer_wavelet_independent(self, rng, monkeypatch):
        # transport always re-encodes CDF53 regardless of blob wavelet
        img = _photo(rng, 64, 64, 4)
        s = Settings(quantization=16, wavelet=Wavelet.HAAR)
        _transport_roundtrip(img, s, monkeypatch)

    def test_incompressible_fallback(self, rng, monkeypatch):
        # pure noise: q0 re-encode exceeds the pack budget for some
        # tiles, so fetch_pixels must take the raw-band fallback
        img = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
        s = Settings(quantization=16, tiles_dimension=64)
        blob = ako_tpu.encode(img, s)
        ref = ako_tpu.decode(blob, device_entropy=True)[0]
        monkeypatch.setenv("AKO_TPU_TRANSPORT", "1")
        got = ako_tpu.decode(blob, device_entropy=True)[0]
        assert np.array_equal(got, ref)

    def test_dispatch_produces_transport_records(self, rng, monkeypatch):
        from ako_tpu.core import container, geometry
        from ako_tpu.decode import dispatch_tiles_device_entropy

        img = _photo(rng, 96, 80, 4)
        s = Settings(quantization=16, tiles_dimension=64)
        blob = ako_tpu.encode(img, s)
        monkeypatch.setenv("AKO_TPU_TRANSPORT", "1")
        view = memoryview(blob)
        channels, w, h, hs = container.head_read(view)
        grid = geometry.tile_grid(w, h, hs.tiles_dimension)
        disp = dispatch_tiles_device_entropy(
            view, container.HEAD_SIZE, grid, hs, channels
        )
        assert disp and all(
            isinstance(rec[3], transport.TransportOut) for rec in disp
        )

    def test_border_tiles(self, rng, monkeypatch):
        # ragged grid: 96x80 at 32 -> full tiles + border columns/rows,
        # several distinct shape groups through the transport path
        img = _photo(rng, 80, 96, 4)
        s = Settings(quantization=16, tiles_dimension=32)
        _transport_roundtrip(img, s, monkeypatch)

    def test_pipeline_decoder(self, rng, monkeypatch):
        from ako_tpu.runtime.executor import PipelineDecoder, PipelineEncoder

        imgs = [_photo(rng, 96, 96, 4) for _ in range(3)]
        s = Settings(quantization=16, tiles_dimension=64)
        blobs = PipelineEncoder(s, workers=2).encode_batch(imgs)
        refs = [ako_tpu.decode(b)[0] for b in blobs]
        monkeypatch.setenv("AKO_TPU_TRANSPORT", "1")
        dec = PipelineDecoder(workers=2)
        # force the device-entropy path despite the CPU test backend
        outs = []
        import concurrent.futures as cf

        with cf.ThreadPoolExecutor(2) as pool:
            for b in blobs:
                disp, shape = dec._dispatch_blob(b, pool, device_entropy=True)
                outs.append(dec._collect(disp, shape))
        assert all(np.array_equal(a, b) for a, b in zip(outs, refs))

    def test_disabled_without_env(self, rng):
        assert not transport.enabled()


class TestTransportEncode:
    """Encode-side transport (pixel UPLOAD as q0 bitstreams,
    reconstructed on device): blobs must equal the raw-path blobs
    byte-for-byte for every content/settings class."""

    def _blob_pair(self, img, s, monkeypatch):
        ref = ako_tpu.encode(img, s, device_entropy=True)
        monkeypatch.setenv("AKO_TPU_TRANSPORT_ENC", "1")
        assert transport.enc_enabled()
        got = ako_tpu.encode(img, s, device_entropy=True)
        assert got == ref
        return ref

    @pytest.mark.parametrize("ch", [1, 2, 3, 4])
    def test_blob_identical_per_channel_count(self, rng, ch, monkeypatch):
        img = _photo(rng, 96, 80, ch)
        self._blob_pair(img, Settings(quantization=16, tiles_dimension=64), monkeypatch)

    @pytest.mark.parametrize("q", [0, 16])
    def test_quantization_modes(self, rng, q, monkeypatch):
        img = _photo(rng, 64, 64, 3)
        self._blob_pair(img, Settings(quantization=q), monkeypatch)

    def test_outer_wavelet_independent(self, rng, monkeypatch):
        img = _photo(rng, 64, 64, 4)
        self._blob_pair(
            img, Settings(quantization=16, wavelet=Wavelet.HAAR), monkeypatch
        )

    def test_border_tiles(self, rng, monkeypatch):
        img = _photo(rng, 80, 96, 4)
        self._blob_pair(img, Settings(quantization=16, tiles_dimension=32), monkeypatch)

    def test_noise_blob_identical(self, rng, monkeypatch):
        # pure noise at q0 still fits the host pack's tds cap (measured
        # ~20/24.6 kB for a 64px tile), so transport stays active;
        # blob equality is the contract either way
        img = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
        self._blob_pair(img, Settings(quantization=16), monkeypatch)

    def test_incompressible_raw_fallback(self, rng, monkeypatch):
        # a q0-incompressible tile (coder -> None) must signal the raw
        # upload; u8 pixels can barely reach the tds cap, so simulate
        # the coder failure at its source module — for both upload
        # codecs (Kagari default, rANS opt-in)
        from ako_tpu.runtime import kagari as kagari_mod

        img = _photo(rng, 64, 64, 3)
        monkeypatch.setenv("AKO_TPU_TRANSPORT_ENC_CODEC", "rans")
        monkeypatch.setattr(kagari_mod, "manba_encode", lambda v, cap: None)
        assert transport.upload_tiles_packed(img[None]) is None
        monkeypatch.setenv("AKO_TPU_TRANSPORT_ENC_CODEC", "kagari")
        monkeypatch.setattr(kagari_mod, "kagari_encode", lambda v, cap: None)
        assert transport.upload_tiles_packed(img[None]) is None

    def test_oversized_code_raw_fallback(self, rng, monkeypatch):
        # Kagari-codec upload: streams the device decoder cannot take
        # (max code bits > 31, the zigzag(-32768) quirk) must signal
        # the raw upload
        from ako_tpu.runtime import kagari as kagari_mod

        monkeypatch.setenv("AKO_TPU_TRANSPORT_ENC_CODEC", "kagari")
        real_sync = kagari_mod.kagari_sync

        def fake_sync(count, blob, cap, block):
            res = real_sync(count, blob, cap, block)
            return None if res is None else res[:5] + (40,)

        monkeypatch.setattr(kagari_mod, "kagari_sync", fake_sync)
        img = _photo(rng, 64, 64, 3)
        assert transport.upload_tiles_packed(img[None]) is None

    def test_rans_codec_pin(self, rng, monkeypatch):
        # the opt-in rANS upload codec stays bit-neutral
        monkeypatch.setenv("AKO_TPU_TRANSPORT_ENC_CODEC", "rans")
        img = _photo(rng, 96, 64, 3)
        self._blob_pair(img, Settings(quantization=16, tiles_dimension=64), monkeypatch)

    def test_constant_alpha_elision_composes(self, rng, monkeypatch):
        # constant alpha: transport packs channels-1 planes and the
        # device broadcasts the constant (fill_last) after reconstruction
        img = _photo(rng, 96, 96, 4)
        img[..., 3] = 255
        self._blob_pair(img, Settings(quantization=16, tiles_dimension=64), monkeypatch)

    def test_direction_overrides(self, monkeypatch):
        monkeypatch.setenv("AKO_TPU_TRANSPORT", "1")
        assert transport.enabled() and transport.enc_enabled()
        monkeypatch.setenv("AKO_TPU_TRANSPORT_ENC", "0")
        assert transport.enabled() and not transport.enc_enabled()
        monkeypatch.setenv("AKO_TPU_TRANSPORT_DEC", "0")
        assert not transport.enabled()

    def test_roundtrip_both_directions(self, rng, monkeypatch):
        img = _photo(rng, 96, 96, 4)
        s = Settings(quantization=16, tiles_dimension=64)
        blob_ref = ako_tpu.encode(img, s, device_entropy=True)
        pix_ref = ako_tpu.decode(blob_ref, device_entropy=True)[0]
        monkeypatch.setenv("AKO_TPU_TRANSPORT", "1")
        blob = ako_tpu.encode(img, s, device_entropy=True)
        assert blob == blob_ref
        pix = ako_tpu.decode(blob, device_entropy=True)[0]
        assert np.array_equal(pix, pix_ref)
