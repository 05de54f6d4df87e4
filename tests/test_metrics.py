"""Fallback observability (utils/metrics.py).

The device entropy paths fall back to the exact host coder in two
places — near-capacity tiles on encode (encode._prepare_collect) and
quirk streams (gamma codes > 31 bits) on decode. Both are bit-exact,
so only these counters can catch a regression that silently routes
tiles onto the slow host path (the 77/80-tile budget regression class
recorded at encode.pack_budget). bench.py embeds the summary in its
JSON line as `fallbacks`.
"""

from __future__ import annotations

import numpy as np
import pytest

import ako_tpu
from ako_tpu.core.settings import Settings
from ako_tpu.utils import metrics
from tests import oracle


@pytest.fixture
def rng():
    return np.random.default_rng(0x3E7)


def _photo(rng, h, w, ch=4):
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 120 + 60 * np.sin(x / 29.0) + 50 * np.cos(y / 17.0)
    img = np.stack(
        [np.clip(base * (0.6 + 0.1 * c), 0, 255) for c in range(ch)], axis=-1
    )
    img += rng.normal(0, 3.0, size=img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _assert_exact(img, s, blob, pix=None):
    """The device-entropy outputs equal the per-tile host-entropy path
    (device lift + native coder), and the reference library where its
    sources are present."""
    from ako_tpu.encode import checked_settings

    assert blob == ako_tpu.encode(img, s, device_entropy=False)
    if pix is not None:
        assert np.array_equal(pix, ako_tpu.decode(blob, device_entropy=False)[0])
    if oracle.available():
        assert blob == oracle.ref_encode(img, checked_settings(s))
        if pix is not None:
            assert np.array_equal(pix, oracle.ref_decode(blob)[0])


def test_counter_api():
    metrics.reset()
    assert metrics.counters() == {}
    metrics.bump("x", 3)
    metrics.bump("x")
    metrics.bump("x", 0)  # no-op
    assert metrics.counters() == {"x": 4}
    summary = metrics.fallback_summary()
    assert set(summary) == {
        metrics.ENC_DEVICE,
        metrics.ENC_HOST_FALLBACK,
        metrics.DEC_DEVICE,
        metrics.DEC_HOST_FALLBACK,
    }
    assert all(v == 0 for v in summary.values())
    metrics.reset()


def test_no_fallbacks_on_clean_workload(rng):
    """The north-star-shaped workload (photographic content, q16,
    128-px tiles) must keep every tile on the device paths — the
    assertion that would have caught the silent 77/80 regression."""
    metrics.reset()
    s = Settings(quantization=16, tiles_dimension=128)
    img = _photo(rng, 256, 256)  # 4 tiles of 128x128
    blob = ako_tpu.encode(img, s, device_entropy=True)
    pix = ako_tpu.decode(blob, device_entropy=True)[0]
    c = metrics.fallback_summary()
    assert c[metrics.ENC_HOST_FALLBACK] == 0
    assert c[metrics.ENC_DEVICE] == 4
    assert c[metrics.DEC_HOST_FALLBACK] == 0
    assert c[metrics.DEC_DEVICE] == 4
    _assert_exact(img, s, blob, pix)


def test_encode_budget_fallback_counted(rng):
    """A full-range noise tile at q16 exceeds the device pack budget
    (capacity/2): the host fallback must be counted AND stay exact."""
    metrics.reset()
    s = Settings(quantization=16, tiles_dimension=64)
    img = _photo(rng, 64, 128)
    img[:, 64:, :] = rng.integers(0, 256, size=(64, 64, 4), dtype=np.uint8)
    blob = ako_tpu.encode(img, s, device_entropy=True)
    c = metrics.fallback_summary()
    if c[metrics.ENC_HOST_FALLBACK] == 0:
        pytest.skip("noise tile unexpectedly fit the device budget")
    assert c[metrics.ENC_HOST_FALLBACK] + c[metrics.ENC_DEVICE] == 2
    _assert_exact(img, s, blob)


def test_decode_quirk_fallback_counted(rng, monkeypatch):
    """Streams the sync scanner flags as quirk (max_bits > 31) must be
    decoded on the host, counted, and stay exact. Organic >31-bit
    streams are rejected by host and sync consistently
    (test_kagari_device_decode.py::test_oversized_code_is_flagged), so
    the flag is forced here to pin the routing + counting."""
    from ako_tpu.runtime import kagari as kagari_mod

    orig = kagari_mod.kagari_sync

    def flagged(*a, **k):
        r = orig(*a, **k)
        if r is None:
            return None
        bit_off, prev, consec, run, consumed, _max_bits = r
        return bit_off, prev, consec, run, consumed, 33

    monkeypatch.setattr(kagari_mod, "kagari_sync", flagged)
    metrics.reset()
    s = Settings(quantization=16, tiles_dimension=64)
    img = _photo(rng, 64, 128)  # 2 tiles
    blob = ako_tpu.encode(img, s, device_entropy=True)
    pix = ako_tpu.decode(blob, device_entropy=True)[0]
    c = metrics.fallback_summary()
    assert c[metrics.DEC_HOST_FALLBACK] == 2
    assert c[metrics.DEC_DEVICE] == 0
    _assert_exact(img, s, blob, pix)
