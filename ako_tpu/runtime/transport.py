"""Lossless transport-compression of the pixel transfers.

Two independent directions, both opt-in and both byte-neutral for
blobs and pixels:

- decode side (AKO_TPU_TRANSPORT[_DEC]=1): the pixel DOWNLOAD leaves
  the device as a q0 re-encode, unpacked on the host (below).
- encode side (AKO_TPU_TRANSPORT[_ENC]=1): the pixel UPLOAD travels as
  host-packed q0 bitstreams, reconstructed on device by the parallel
  entropy decoder + unlift (upload_tiles_packed). In the overlapped
  round-trip stream the upload is the heavier direction, so this
  balances the two.

Raw decoded pixels are ~3.9 MB per 1024x1280 RGB image. With
transport compression the device re-encodes decoded tiles losslessly
(CDF53, q=0 -- the fused encoder programs of `ako_tpu.encode` reused
verbatim) and the host fetches ~1.7x fewer bytes (2.34 MB for a
q16-decoded bench image; DD137 2.21 MB, Haar 2.92 MB), unpacking them
with the native entropy decoder plus unlift. The encode-side pack
sends 2.13 MB instead of 3.93. Bit-exactness follows from the codec's
own lossless contract (q=0 round-trips exactly; asserted per decode in
tests/test_transport.py).

Opt-in via AKO_TPU_TRANSPORT=1: it trades host work for transfer
bytes, which pays only when the host<->device link, not the host,
bounds the stream. It was built for a slow link before the GPU port;
whether it wins anything over PCIe is ROADMAP C1. The raw band fetch
stays the default.

No reference counterpart: the reference is single-address-space C
(library/decode.c) and never moves pixels between devices.
"""

from __future__ import annotations

import os

import numpy as np

from ako_tpu.core import geometry
from ako_tpu.core.settings import AkoError, Color, Status, Wavelet, Wrap

#: transport codec settings: CDF53 was the measured sweet spot between
#: transferred bytes and host unpack cost; q=0/gate=0 make it lossless;
#: YCoCg stays exactly reversible at q=0 (checked_settings only
#: switches to the x2 variant when lossy).
_WAVELET, _WRAP, _COLOR = Wavelet.CDF53, Wrap.CLAMP, Color.YCOCG


def _dir_enabled(dir_var: str) -> bool:
    """Per-direction opt-in: AKO_TPU_TRANSPORT=1 enables both
    directions; AKO_TPU_TRANSPORT_DEC / AKO_TPU_TRANSPORT_ENC=0|1
    override one direction each."""
    v = os.environ.get(dir_var)
    if v in ("0", "1"):
        return v == "1"
    return os.environ.get("AKO_TPU_TRANSPORT") == "1"


def enabled() -> bool:
    """Decode-side transport (pixel DOWNLOAD packed on device, unpacked
    on host). The unpack is fully native (runtime/hostcodec.py) so no
    host CPU-XLA backend is required."""
    return _dir_enabled("AKO_TPU_TRANSPORT_DEC")


def enc_enabled() -> bool:
    """Encode-side transport (pixel UPLOAD packed on host, unpacked on
    device). The pack is fully native (runtime/hostcodec.py) so no
    host CPU-XLA backend is required."""
    return _dir_enabled("AKO_TPU_TRANSPORT_ENC")


class TransportOut:
    """Decoder-output record for one tile-shape group whose pixels
    travel as a lossless q=0 bitstream instead of raw bands. Understood
    by decode.pixels_ready / place_pixels / assemble_pixels alongside
    PixOut. Holds the interleaved u8 device tensor too: the raw-fetch
    fallback for q0-incompressible (non-photographic) content."""

    __slots__ = ("ileaved", "prep_fut", "tw", "th", "channels")

    def __init__(self, ileaved, prep_fut, tw: int, th: int, channels: int):
        self.ileaved = ileaved
        self.prep_fut = prep_fut
        self.tw = tw
        self.th = th
        self.channels = channels

    def ready(self) -> None:
        """First sync point: the totals fetch completes only after the
        whole decode+re-encode device chain ran."""
        self.prep_fut.result()


def pack_pixels(ileaved_dev, tw: int, th: int, channels: int) -> TransportOut:
    """Chain the q=0 fused encoder onto a decoded (T, th, tw, channels)
    u8 device tensor and start the totals fetch + bucketed byte-fetch
    prep on a worker (same choreography as the encode dispatch)."""
    from ako_tpu.encode import _fetch_pool, _prepare_collect, _tile_encoder_fused

    fwd, pack, capacity, budget = _tile_encoder_fused(
        tw, th, channels, _WAVELET, _WRAP, _COLOR, False, 0, 0, 1, None
    )
    comp_bytes, totals_dev = pack(fwd(ileaved_dev))
    prep_fut = _fetch_pool().submit(
        _prepare_collect, totals_dev, comp_bytes, capacity, budget
    )
    return TransportOut(ileaved_dev, prep_fut, tw, th, channels)


def fetch_pixels(out: TransportOut) -> np.ndarray:
    """Fetch one shape group's transport bitstream and unpack it on the
    host CPU; returns (T, th, tw, channels) u8. Falls back to the raw
    band fetch when any tile was q0-incompressible (prep marked it for
    the encoder's host-coder fallback -- for transport the right
    fallback is simply the raw pixels we already hold on device)."""
    from ako_tpu.encode import _fetch_pool
    from ako_tpu.runtime.transfer import band_split, device_get_parallel, fetch_bands

    totals, fallback, groups, rows = out.prep_fut.result()
    if fallback:
        return fetch_bands(band_split(out.ileaved))
    payloads: list = [None] * int(totals.shape[0])
    for group, host_bytes in zip(
        groups, _fetch_pool().map(device_get_parallel, rows)
    ):
        for j, i in enumerate(group):
            payloads[i] = host_bytes[j, : int(totals[i])].tobytes()
    return _unpack_host(payloads, out.tw, out.th, out.channels)


def _unpack_host(payloads, tw: int, th: int, channels: int) -> np.ndarray:
    """Entropy-decode + unlift + format the per-tile q0 payloads
    entirely with the native coder (runtime/hostcodec.py): independent
    tiles, ctypes releases the GIL, so they fan out on the shared
    worker pool (several times faster than a CPU-XLA unlift program,
    which also made DD137's tighter packing uneconomical)."""
    from ako_tpu.encode import _fetch_pool
    from ako_tpu.runtime.hostcodec import tile_decode_pixels
    from ako_tpu.runtime.kagari import kagari_decode

    tds = geometry.tile_data_size(tw, th) * channels
    spacing = geometry.planes_spacing(tw, th)

    def one(p):
        res = kagari_decode(tds // 2, p, tds + spacing)
        if res is None:  # impossible for our own coder's output
            raise AkoError(Status.ERROR, "transport unpack failed")
        return tile_decode_pixels(
            res[0], tw, th, channels, _WAVELET, _WRAP, _COLOR
        )

    return np.stack(list(_fetch_pool().map(one, payloads)), axis=0)


def upload_tiles_packed(batch: np.ndarray):
    """Encode-side mirror of the decode transport: move a (T, th, tw,
    channels) u8 tile batch host->device as per-tile lossless q0
    bitstreams instead of raw pixels, reconstructing the exact tiles on
    device with the parallel entropy decoder + unlift (the same
    programs the device-entropy decode path runs,
    ops/kagari_device.kagari_decode_device). In the overlapped
    round-trip stream the upload is the heavier direction (raw pixels
    up + compressed word pool up vs compressed blob down + transported
    pixels down), so packing the pixel upload balances the two.

    The pack runs on the host: a CPU-pinned q0 forward program over the
    batch, then the native Kagari coder + sync scanner per tile (leaf
    tasks on the shared worker pool; ctypes releases the GIL). Returns
    a (T, th, tw, channels) u8 DEVICE tensor, or None when any tile
    must fall back to the raw upload (q0-incompressible content, or an
    oversized-code stream the device decoder cannot take —
    runtime/kagari.py:kagari_sync).

    No reference counterpart (single address space); the q0 round-trip
    exactness this relies on is the codec's own lossless contract,
    asserted blob-for-blob in tests/test_transport.py."""
    from ako_tpu.core import geometry as _geo
    from ako_tpu.decode import (
        _bucket_span,
        _entropy_decode_fn,
        _entropy_decode_fn_manba,
        _pack_entropy_upload,
        _pack_manba_upload,
        _tile_decoder,
    )
    from ako_tpu.encode import _fetch_pool
    from ako_tpu.ops.kagari_device import DECODE_BLOCK, decode_span_words
    from ako_tpu.ops.quantization import level_qg
    from ako_tpu.runtime.hostcodec import tile_encode_stream
    from ako_tpu.runtime.kagari import (
        kagari_encode,
        kagari_sync,
        manba_encode,
        manba_sync,
    )
    from ako_tpu.runtime.transfer import device_put_parallel

    T, th, tw, channels = batch.shape
    tds = geometry.tile_data_size(tw, th) * channels
    spacing = geometry.planes_spacing(tw, th)
    qg = level_qg(_geo.lift_schedule(tw, th), channels, 0, 0, 1)
    # transport is our own layer (no wire-format compat constraint), so
    # the upload codec could be the tighter rANS (13% fewer q0 bytes).
    # End to end before the GPU port rANS lost: the device rANS
    # decoder's extra scan work outweighed the saved upload. Kagari
    # stays the default; =rans opts in.
    use_rans = os.environ.get("AKO_TPU_TRANSPORT_ENC_CODEC", "kagari") == "rans"

    def pack_one(tile_u8):
        # all native (format + lift + entropy + sync scan; faster than
        # a CPU-XLA forward program), GIL released throughout -> clean
        # pool fan-out
        v = tile_encode_stream(tile_u8, _WAVELET, _WRAP, _COLOR, qg)
        if use_rans:
            p = manba_encode(v, tds)
            if p is None:  # q0-incompressible (non-photographic content)
                return None
            sy = manba_sync(tds // 2, p, DECODE_BLOCK)
            if sy is None:
                return None
            return p, sy
        p = kagari_encode(v, tds)
        if p is None:
            return None
        sy = kagari_sync(tds // 2, p, tds + spacing, DECODE_BLOCK)
        if sy is None or sy[5] > 31:  # zigzag(-32768) misalignment quirk
            return None
        return p, sy

    packed = list(_fetch_pool().map(pack_one, batch))
    if any(p is None for p in packed):
        return None

    if use_rans:
        items = [(None, p, ("manba", sy)) for p, sy in packed]
        buf, pool_words, tcount, bcount, rspan, espan = _pack_manba_upload(items)
        efn = _entropy_decode_fn_manba(
            tds // 2,
            DECODE_BLOCK,
            min(rspan, pool_words),
            min(espan, pool_words),
            pool_words,
            tcount,
            bcount,
        )
    else:
        items = [(None, p, sy) for p, sy in packed]
        buf, pool_words, tcount, bcount = _pack_entropy_upload(items)
        span = _bucket_span(
            max(decode_span_words(sy[0], len(p) * 8) for p, sy in packed)
        )
        efn = _entropy_decode_fn(
            tds // 2, DECODE_BLOCK, pool_words, min(span, pool_words), tcount, bcount
        )
    streams_dev = efn(device_put_parallel(buf))
    dfn = _tile_decoder(tw, th, channels, _WAVELET, _WRAP, _COLOR, out="ileaved")
    return dfn(streams_dev)
