"""Decode orchestrator: .ako blob -> image.

Mirror of the encode split (reference: library/decode.c:38-250): host
parses the container and entropy-decodes per-tile blocks into int16
coefficient streams; the device stage (unlift + inverse color +
interleave) runs as one jitted program per tile shape, batched over
same-shaped tiles. Decoded pixels are bit-identical to the reference
decoder's output.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ako_tpu.core import container, geometry
from ako_tpu.core.events import Event, EventsCallback
from ako_tpu.core.settings import (
    AkoError,
    Color,
    Compression,
    Settings,
    Status,
    Wavelet,
    Wrap,
)
from typing import NamedTuple

from ako_tpu.ops.colorspace import to_interleaved_u8
from ako_tpu.ops.lifting import inverse_tile
from ako_tpu.utils.tracing import traced


class PixOut(NamedTuple):
    """Decoder output for images with a trailing alpha-like channel:
    the last channel travels as its own band tuple plus a tiny per-tile
    (min, max) table, so collectors can skip fetching it entirely when
    it is constant (the common alpha=255 case — 25% of the pixel bytes
    device->host)."""

    color: tuple  # band_split of (T, th, tw, channels-1) u8
    alpha: tuple  # band_split of (T, th, tw) u8 — fetched lazily
    amm: jnp.ndarray  # (T, 2) u8 per-tile (min, max) of the last channel


def _pix_out(ileaved, channels: int):
    """Wrap an interleaved (T, th, tw, C) u8 device tensor as the
    fetch-friendly output pytree: PixOut when a trailing channel can be
    elided, else plain leading-axis bands."""
    from ako_tpu.runtime.transfer import band_split

    if channels not in (2, 4):
        return band_split(ileaved)
    last = ileaved[..., -1]
    amm = jnp.stack(
        [last.min(axis=(1, 2)), last.max(axis=(1, 2))], axis=-1
    )
    return PixOut(band_split(ileaved[..., :-1]), band_split(last), amm)


def pixels_ready(out) -> None:
    """Wait for a decoder output (PixOut, bands, or TransportOut) to be
    computed. Waits on ONE leaf only: every leaf comes from the same
    device program, so one wait covers them all."""
    from ako_tpu.runtime.transport import TransportOut

    if isinstance(out, TransportOut):
        out.ready()
    elif isinstance(out, PixOut):
        out.amm.block_until_ready()
    else:
        out[0].block_until_ready()


def _fetch_pix_out(out: PixOut):
    """Fetch choreography shared by every PixOut collector: fetch the
    tiny (min, max) probe concurrently with the color-band fetch, then fetch the
    trailing channel only if some tile's probe says non-constant.
    Returns (pix (T, th, tw, C-1), amm (T, 2), alpha (T, th, tw)|None)."""
    from ako_tpu.runtime.transfer import _get_pool, fetch_bands

    amm_fut = _get_pool().submit(np.asarray, out.amm)
    pix = fetch_bands(out.color)
    amm = amm_fut.result()
    alpha = None if (amm[:, 0] == amm[:, 1]).all() else fetch_bands(out.alpha)
    return pix, amm, alpha


def place_pixels(image: np.ndarray, tiles, th: int, tw: int, out) -> None:
    """Fetch a decoder output and write each tile into `image` at its
    placement. For PixOut, the trailing channel is fetched only
    when some tile's (min, max) probe says it is non-constant; for
    TransportOut the pixels arrive as a lossless q0 bitstream unpacked
    on the host CPU (runtime/transport.py)."""
    from ako_tpu.runtime.transfer import fetch_bands
    from ako_tpu.runtime.transport import TransportOut, fetch_pixels

    if isinstance(out, TransportOut):
        pix = fetch_pixels(out)
        for i, t in enumerate(tiles):
            image[t.y : t.y + th, t.x : t.x + tw, :] = pix[i]
        return
    if not isinstance(out, PixOut):
        pix = fetch_bands(out)
        for i, t in enumerate(tiles):
            image[t.y : t.y + th, t.x : t.x + tw, :] = pix[i]
        return
    pix, amm, alpha = _fetch_pix_out(out)
    for i, t in enumerate(tiles):
        sl = image[t.y : t.y + th, t.x : t.x + tw]
        sl[..., :-1] = pix[i]
        sl[..., -1] = amm[i, 0] if alpha is None else alpha[i]


def assemble_pixels(out) -> np.ndarray:
    """Fetch a decoder output as one (T, th, tw, C) u8 array (the
    streaming-iterator surface, which yields per-tile arrays)."""
    from ako_tpu.runtime.transfer import fetch_bands
    from ako_tpu.runtime.transport import TransportOut, fetch_pixels

    if isinstance(out, TransportOut):
        return fetch_pixels(out)
    if not isinstance(out, PixOut):
        return fetch_bands(out)
    pix, amm, alpha = _fetch_pix_out(out)
    full = np.empty(pix.shape[:-1] + (pix.shape[-1] + 1,), np.uint8)
    full[..., :-1] = pix
    full[..., -1] = amm[:, 0][:, None, None] if alpha is None else alpha
    return full


@functools.lru_cache(maxsize=256)
def _tile_decoder(
    tile_w: int,
    tile_h: int,
    channels: int,
    wavelet: Wavelet,
    wrap: Wrap,
    color: Color,
    out: str = "bands",
):
    """Jitted device program: (T, coeff_count) int16 -> PixOut (or
    plain leading-axis bands) of (T, tile_h, tile_w, channels) u8
    tiles (band_split: fetch-friendly distinct outputs). out="ileaved"
    returns the raw interleaved tensor instead -- the transport path
    chains the q0 re-encode onto it (runtime/transport.py)."""
    schedule = geometry.lift_schedule(tile_w, tile_h)

    def fn(coeffs):
        if wavelet == Wavelet.NONE:
            planes = coeffs.reshape(coeffs.shape[:-1] + (channels, tile_h, tile_w))
        else:
            planes = inverse_tile(coeffs, schedule, wavelet, wrap, channels)
        ileaved = to_interleaved_u8(planes, color, channels)
        return ileaved if out == "ileaved" else _pix_out(ileaved, channels)

    return jax.jit(fn)


def _tail_layout(schedule, channels: int, n_levels: int = 2):
    """Serialized-stream layout of the largest `n_levels` levels (the
    stream's tail): (split_offset, [(head_count, body_len) per level]).
    Level chunks are [q-head][C][B][D] per channel (ops/lifting.py)."""
    n_levels = min(n_levels, len(schedule.levels))
    total = schedule.coeff_count(channels)
    tail_levels = schedule.levels[:n_levels]  # encode order: largest first
    tail_size = sum(
        channels * (1 + 3 * lvl.target_w * lvl.target_h) for lvl in tail_levels
    )
    # stream order within the tail: smallest of the pair first
    stream_order = list(reversed(tail_levels))
    return total - tail_size, stream_order


@functools.lru_cache(maxsize=256)
def _tile_decoder_split(
    tile_w: int,
    tile_h: int,
    channels: int,
    wavelet: Wavelet,
    wrap: Wrap,
    color: Color,
    out: str = "bands",
):
    """Upload-lean decoder: the largest levels' highpass bodies arrive
    as int8 (they are small after quantization), q-heads and the rest
    as int16 — roughly halving the dominant host->device transfer.
    Exactness is unaffected: the host checks |body| <= 127 first and
    falls back to the int16 program otherwise (decode())."""
    schedule = geometry.lift_schedule(tile_w, tile_h)
    split, stream_order = _tail_layout(schedule, channels)

    def fn(head16, bodies8, heads16):
        parts = [head16]
        off8 = 0
        hidx = 0
        for lvl in stream_order:
            body_len = 3 * lvl.target_w * lvl.target_h
            for _c in range(channels):
                parts.append(heads16[..., hidx : hidx + 1])
                hidx += 1
                parts.append(
                    bodies8[..., off8 : off8 + body_len].astype(jnp.int16)
                )
                off8 += body_len
        coeffs = jnp.concatenate(parts, axis=-1)
        planes = inverse_tile(coeffs, schedule, wavelet, wrap, channels)
        ileaved = to_interleaved_u8(planes, color, channels)
        return ileaved if out == "ileaved" else _pix_out(ileaved, channels)

    return jax.jit(fn), split, stream_order


def split_streams_for_upload(streams_batch: np.ndarray, schedule, channels: int):
    """Host-side split of a (T, n) int16 stream batch into
    (head16, bodies8, heads16) for _tile_decoder_split, or None when
    any tail body value exceeds int8 range (caller falls back)."""
    split, stream_order = _tail_layout(schedule, channels)
    head16 = streams_batch[:, :split]
    tail = streams_batch[:, split:]
    bodies = []
    heads = []
    off = 0
    for lvl in stream_order:
        body_len = 3 * lvl.target_w * lvl.target_h
        for _c in range(channels):
            heads.append(tail[:, off : off + 1])
            off += 1
            bodies.append(tail[:, off : off + body_len])
            off += body_len
    bodies_cat = np.concatenate(bodies, axis=1)
    # upcast before abs: np.abs(int16 -32768) wraps to -32768 and would
    # slip past the range check, then corrupt to 0 in the int8 cast
    if bodies_cat.size and np.abs(bodies_cat.astype(np.int32)).max() > 127:
        return None
    return (
        head16,
        bodies_cat.astype(np.int8),
        np.concatenate(heads, axis=1),
    )


def _run_tile_decoder(streams_batch: np.ndarray, tw, th, channels, s, out="bands"):
    """Pick the upload-lean split program when the tail fits int8,
    else the plain int16 program; returns the device array (async).
    Bulk uploads ride the chunked-parallel transfer path."""
    from ako_tpu.runtime.transfer import device_put_parallel

    schedule = geometry.lift_schedule(tw, th)
    if s.wavelet != Wavelet.NONE and len(schedule.levels) >= 2:
        parts = split_streams_for_upload(streams_batch, schedule, channels)
        if parts is not None:
            fn, _, _ = _tile_decoder_split(
                tw, th, channels, s.wavelet, s.wrap, s.color, out
            )
            return fn(
                device_put_parallel(parts[0]),
                device_put_parallel(parts[1]),
                jnp.asarray(parts[2]),
            )
    fn = _tile_decoder(tw, th, channels, s.wavelet, s.wrap, s.color, out)
    return fn(device_put_parallel(streams_batch))


#: Upper bound on decoded image bytes (w*h*channels). The reference
#: relies on malloc failing for absurd headers (status
#: NO_ENOUGH_MEMORY, encode.c:94-98); a compiled-program pipeline must
#: reject them before attempting allocation/compilation. Override via
#: ako_tpu.decode.MAX_IMAGE_BYTES for genuinely huge images.
MAX_IMAGE_BYTES = 1 << 31


def _check_decode_budget(image_w: int, image_h: int, channels: int) -> None:
    if image_w * image_h * channels > MAX_IMAGE_BYTES:
        raise AkoError(Status.NO_ENOUGH_MEMORY, "image exceeds MAX_IMAGE_BYTES")


def _fire(events, tile_no, total, event, user):
    if events is not None:
        events(tile_no, total, event, user)


class HostDecodeSpanPlan(NamedTuple):
    """Per-(geometry, wavelet) arrays for the batched native span
    decoder (akort_tile_decode_spans) — the decode twin of
    encode._host_span_plan. All in wire order, read-only."""

    rects: np.ndarray  # (n, 4) i32: x, y, w, h
    counts: np.ndarray  # (n,) i64 coefficient counts per tile
    caps: np.ndarray  # (n,) i64 output capacity bytes (tds + spacing)


@functools.lru_cache(maxsize=64)
def _host_decode_plan(
    image_w: int,
    image_h: int,
    channels: int,
    tiles_dimension: int,
    wavelet: Wavelet,
) -> HostDecodeSpanPlan:
    grid = geometry.tile_grid(image_w, image_h, tiles_dimension)
    n = len(grid)
    rects = np.empty((n, 4), np.int32)
    counts = np.empty(n, np.int64)
    caps = np.empty(n, np.int64)
    for i, t in enumerate(grid):
        rects[i] = (t.x, t.y, t.w, t.h)
        tds, spacing = _block_sizes(t.w, t.h, channels, wavelet)
        counts[i] = tds // 2
        caps[i] = tds + spacing
    for a in (rects, counts, caps):
        a.setflags(write=False)
    return HostDecodeSpanPlan(rects, counts, caps)


def _block_sizes(w: int, h: int, channels: int, wavelet: Wavelet):
    """(tile_data_size bytes, planes_spacing elements) for one tile
    geometry — the single source of the decode-side size contract
    (reference decode.c:133-142)."""
    if wavelet != Wavelet.NONE:
        return (
            geometry.tile_data_size(w, h) * channels,
            geometry.planes_spacing(w, h),
        )
    return w * h * channels * 2, 0


def tile_block_sizes(t, s: Settings, channels: int):
    """(tile_data_size bytes, planes_spacing elements) for one tile."""
    return _block_sizes(t.w, t.h, channels, s.wavelet)


def read_tile_stream(view, cursor: int, t, s: Settings, channels: int):
    """Entropy-decode (or raw-copy) one tile block from `view` at
    `cursor`; returns (int16 values, new_cursor). Raises
    AkoError(BROKEN_INPUT) on truncation/corruption. Single source of
    truth for the per-tile block walk — used by every decode surface."""
    tds, spacing = tile_block_sizes(t, s, channels)
    if s.compression != Compression.NONE:
        from ako_tpu.runtime.kagari import decompress_block

        res = decompress_block(view[cursor:], tds, tds + spacing, s.compression)
        if res is None:
            raise AkoError(Status.BROKEN_INPUT)
        values, consumed = res
        return values, cursor + consumed
    if cursor + tds > len(view):
        raise AkoError(Status.BROKEN_INPUT)
    values = np.frombuffer(view[cursor : cursor + tds], dtype=np.int16).copy()
    return values, cursor + tds


def host_decode_mode() -> bool:
    """AKO_TPU_DECODE=host routes decode's compute (entropy + unlift +
    format) through the native host path (runtime/hostcodec.py) with no
    device traffic: the blob the host already holds fully determines
    the pixels, while fetching them from the device moves ~3.9 MB per
    1024x1280 RGBA image. bench.py races this mode against the device
    paths; the default is the device path."""
    import os

    return os.environ.get("AKO_TPU_DECODE") == "host"


def _read_tile_block(view, cursor: int, t, s: Settings, channels: int):
    """Slice one tile's block payload out of the container without
    decoding it (the boundary walk is inherently sequential; the decode
    itself is not). Returns (payload view | raw values, new_cursor)."""
    from ako_tpu.runtime.kagari import BLOCK_HEAD

    tds, _spacing = tile_block_sizes(t, s, channels)
    if s.compression != Compression.NONE:
        if cursor + BLOCK_HEAD.size > len(view):
            raise AkoError(Status.BROKEN_INPUT)
        (bs,) = BLOCK_HEAD.unpack_from(view, cursor)
        payload = view[cursor + BLOCK_HEAD.size : cursor + BLOCK_HEAD.size + bs]
        if len(payload) < bs:
            raise AkoError(Status.BROKEN_INPUT)
        return payload, cursor + BLOCK_HEAD.size + bs
    if cursor + tds > len(view):
        raise AkoError(Status.BROKEN_INPUT)
    return view[cursor : cursor + tds], cursor + tds


def _entropy_one(payload, t, s: Settings, channels: int) -> np.ndarray:
    """Entropy-decode one tile's sliced payload (or reinterpret the raw
    block when compression is NONE). MANBAVARAN-flagged payloads try
    the real rANS coder first and fall back to Kagari (reference-made
    reserved-flag blobs carry Kagari bytes — runtime/kagari.py)."""
    from ako_tpu.runtime.kagari import kagari_decode, manba_decode

    tds, spacing = tile_block_sizes(t, s, channels)
    if s.compression == Compression.NONE:
        return np.frombuffer(payload, dtype=np.int16).copy()
    if s.compression == Compression.MANBAVARAN:
        values = manba_decode(tds // 2, payload)
        if values is not None:
            return values
    res = kagari_decode(tds // 2, payload, tds + spacing)
    if res is None or res[1] != len(payload):
        raise AkoError(Status.BROKEN_INPUT)
    return res[0]


def _bucket_span(m: int) -> int:
    """Power-of-two bucketed decode window span: keeps the number of
    compiled entropy-decode programs logarithmic in content variety."""
    return geometry.pow2_bucket(m, 8)


@functools.lru_cache(maxsize=256)
def _entropy_decode_fn(
    n_outputs: int, block: int, pool_words: int, span: int, tiles: int, blocks: int
):
    """Jitted batched device entropy decode over ONE combined u32
    upload (see _pack_entropy_upload's layout) -> (T, n_outputs) int16
    coefficient streams. A single buffer instead of six arrays: one
    host->device copy per shape group. `span` is the bucketed
    per-block word-window width (see kagari_device.decode_span_words)."""
    from ako_tpu.ops.kagari_device import kagari_decode_device

    T, B = tiles, blocks

    def fn(buf):
        bases = jax.lax.bitcast_convert_type(buf[:T], jnp.int32)
        off = T
        bit_off = buf[off : off + T * B].reshape(T, B)
        off += T * B
        prev = jax.lax.bitcast_convert_type(
            buf[off : off + T * B], jnp.int32
        ).reshape(T, B)
        off += T * B
        cr = buf[off : off + T * B].reshape(T, B)
        off += T * B
        consec = (cr >> 16).astype(jnp.int32)
        run = (cr & jnp.uint32(0xFFFF)).astype(jnp.int32)
        pool = buf[off:]
        return jax.vmap(
            lambda bb, b, p, c, r: kagari_decode_device(
                pool, b, p, c, r, n_outputs, block, span, base=bb
            )
        )(bases, bit_off, prev, consec, run)

    return jax.jit(fn)


@functools.lru_cache(maxsize=256)
def _entropy_decode_fn_manba(
    n_outputs: int,
    block: int,
    rspan: int,
    espan: int,
    pool_words: int,
    tiles: int,
    blocks: int,
):
    """Jitted batched device Manbavaran (rANS) decode over ONE combined
    u32 upload -> (T, n_outputs) int16 streams. Layout (see
    _pack_manba_upload): [bases (T) | rans_end (T) | extras_off (T) |
    x (T*B) | rbyte (T*B) | ebit (T*B) | freq (T*17) | dense pool]."""
    from ako_tpu.ops.manba_device import manba_decode_device

    T, B = tiles, blocks

    def fn(buf):
        bases = jax.lax.bitcast_convert_type(buf[:T], jnp.int32)
        rans_end = buf[T : 2 * T]
        extras_off = buf[2 * T : 3 * T]
        off = 3 * T
        x = buf[off : off + T * B].reshape(T, B)
        off += T * B
        rbyte = buf[off : off + T * B].reshape(T, B)
        off += T * B
        ebit = buf[off : off + T * B].reshape(T, B)
        off += T * B
        freq = jax.lax.bitcast_convert_type(
            buf[off : off + T * 17], jnp.int32
        ).reshape(T, 17)
        off += T * 17
        pool = buf[off:]
        return jax.vmap(
            lambda bb, re, eo, xx, rb, eb, fr: manba_decode_device(
                pool, xx, rb, eb, fr, re, eo, n_outputs, block,
                rspan, espan, base=bb,
            )
        )(bases, rans_end, extras_off, x, rbyte, ebit, freq)

    return jax.jit(fn)


def _pack_manba_upload(items) -> tuple:
    """Pack one shape group's Manbavaran decode input as a single u32
    buffer (layout in _entropy_decode_fn_manba). items: (tile, payload,
    ("manba", sync)) records. Returns (buf, pool_words, T, B, rspan,
    espan)."""
    from ako_tpu.ops.kagari_device import DECODE_SLACK_WORDS
    from ako_tpu.ops.manba_device import span_words

    payloads = [p for _, p, _ in items]
    bases, w = [], 0
    for p in payloads:
        bases.append(w)
        w += (len(p) + 3) // 4
    pool_words = -(-(w + DECODE_SLACK_WORDS) // _POOL_ROUND_WORDS) * _POOL_ROUND_WORDS
    pool8 = np.zeros(pool_words * 4, np.uint8)
    for p, b in zip(payloads, bases):
        pool8[b * 4 : b * 4 + len(p)] = np.frombuffer(p, np.uint8)

    syncs = [sy for _, _, (_, sy) in items]
    x = np.stack([sy[0] for sy in syncs])
    rbyte = np.stack([sy[1] for sy in syncs])
    ebit = np.stack([sy[2] for sy in syncs])
    freq = np.stack([sy[3].astype(np.int32) for sy in syncs])
    rans_end = np.asarray([sy[5] for sy in syncs], np.uint32)
    extras_off = np.asarray([sy[6] for sy in syncs], np.uint32)
    T, B = x.shape

    rspan = _bucket_span(
        max(
            span_words(sy[1], sy[5], bits=False)
            for sy in syncs
        )
    )
    espan = _bucket_span(
        max(
            span_words(
                sy[2].astype(np.int64) + sy[6] * 8, len(p) * 8, bits=True
            )
            for (_, p, _), sy in zip(items, syncs)
        )
    )

    buf = np.empty(3 * T + 3 * T * B + T * 17 + pool_words, np.uint32)
    buf[:T] = np.asarray(bases, np.int32).view(np.uint32)
    buf[T : 2 * T] = rans_end
    buf[2 * T : 3 * T] = extras_off
    off = 3 * T
    buf[off : off + T * B] = x.ravel()
    off += T * B
    buf[off : off + T * B] = rbyte.ravel()
    off += T * B
    buf[off : off + T * B] = ebit.ravel()
    off += T * B
    buf[off : off + T * 17] = freq.astype(np.int32).view(np.uint32).ravel()
    off += T * 17
    buf[off:] = pool8.view(">u4").astype(np.uint32)
    return buf, pool_words, T, B, rspan, espan


#: dense-pool length granularity (words): bounds compiled-program
#: variants while wasting at most 64 KiB of upload per shape group
_POOL_ROUND_WORDS = 16384


def _pack_entropy_upload(items) -> tuple:
    """Pack one shape group's ENTIRE entropy-decode input as a single
    u32 buffer: [bases (T) | bit_off (T*B) | prev (T*B, two's
    complement) | consec<<16|run (T*B) | dense word pool]. The pool
    concatenates per-tile compressed payloads word-aligned (only actual
    compressed bytes, word-rounded, are copied) and is
    _POOL_ROUND_WORDS-rounded so compiled-program variants stay
    bounded. Returns (buf u32 (L,), pool_words, T, B)."""
    from ako_tpu.ops.kagari_device import DECODE_SLACK_WORDS

    payloads = [p for _, p, _ in items]
    bases = []
    w = 0
    for p in payloads:
        bases.append(w)
        w += (len(p) + 3) // 4
    pool_words = -(-(w + DECODE_SLACK_WORDS) // _POOL_ROUND_WORDS) * _POOL_ROUND_WORDS
    pool8 = np.zeros(pool_words * 4, np.uint8)
    for p, b in zip(payloads, bases):
        pool8[b * 4 : b * 4 + len(p)] = np.frombuffer(p, np.uint8)

    bit_off = np.stack([sy[0] for _, _, sy in items])
    prev = np.stack([sy[1] for _, _, sy in items])
    consec = np.stack([sy[2] for _, _, sy in items])
    run = np.stack([sy[3] for _, _, sy in items])
    T, B = bit_off.shape

    buf = np.empty(T + 3 * T * B + pool_words, np.uint32)
    buf[:T] = np.asarray(bases, np.int32).view(np.uint32)
    off = T
    buf[off : off + T * B] = bit_off.astype(np.uint32).ravel()
    off += T * B
    buf[off : off + T * B] = prev.astype(np.int32).view(np.uint32).ravel()
    off += T * B
    buf[off : off + T * B] = (
        (consec.astype(np.uint32) << 16) | run.astype(np.uint16).astype(np.uint32)
    ).ravel()
    off += T * B
    buf[off:] = pool8.view(">u4").astype(np.uint32)
    return buf, pool_words, T, B


@functools.lru_cache(maxsize=256)
def _entropy_decode_fn_resident(
    n_outputs: int,
    block: int,
    rows: int,
    row_bytes: int,
    up_words: int,
    span: int,
    tiles: int,
    blocks: int,
):
    """Variant of _entropy_decode_fn for the paired round-trip stream:
    the bulk word pool is the ENCODER'S device-resident compressed-byte
    rows ((rows, row_bytes) u8 — byte-for-byte the payloads framed into
    the blob, encode.collect_tiles_blocks `residue=`), so only the tiny
    sync tables plus any host-coder-fallback payloads are uploaded.
    The rows are re-packed to the
    decoder's big-endian word order on device (the inverse of the byte
    split at ops/kagari_device.pack_bits) and the uploaded tail pool is
    appended behind them; bases in `buf` address both regions."""
    from ako_tpu.ops.kagari_device import kagari_decode_device

    T, B = tiles, blocks
    w4 = (row_bytes + 3) // 4

    def fn(buf, rows_u8):
        if w4 * 4 != row_bytes:
            rows_u8 = jnp.pad(rows_u8, ((0, 0), (0, w4 * 4 - row_bytes)))
        q = rows_u8.reshape(rows, w4, 4).astype(jnp.uint32)
        words = (q[..., 0] << 24) | (q[..., 1] << 16) | (q[..., 2] << 8) | q[..., 3]
        bases = jax.lax.bitcast_convert_type(buf[:T], jnp.int32)
        off = T
        bit_off = buf[off : off + T * B].reshape(T, B)
        off += T * B
        prev = jax.lax.bitcast_convert_type(
            buf[off : off + T * B], jnp.int32
        ).reshape(T, B)
        off += T * B
        cr = buf[off : off + T * B].reshape(T, B)
        off += T * B
        consec = (cr >> 16).astype(jnp.int32)
        run = (cr & jnp.uint32(0xFFFF)).astype(jnp.int32)
        pool = jnp.concatenate([words.reshape(-1), buf[off:]])
        return jax.vmap(
            lambda bb, b, p, c, r: kagari_decode_device(
                pool, b, p, c, r, n_outputs, block, span, base=bb
            )
        )(bases, bit_off, prev, consec, run)

    return jax.jit(fn)


def _pack_entropy_upload_resident(items, res_rows, row_words: int, rows: int):
    """Sync-only upload for _entropy_decode_fn_resident: [bases (T) |
    bit_off (T*B) | prev (T*B) | consec<<16|run (T*B) | fallback pool].
    Resident tiles' bases address the device rows (row * row_words);
    uploaded (encode-fallback) tiles' bases index past the resident
    region. Returns (buf u32, up_words, T, B)."""
    from ako_tpu.ops.kagari_device import DECODE_SLACK_WORDS

    bases, up, w = [], [], 0
    for (_, p, _), row in zip(items, res_rows):
        if row is None:
            bases.append(rows * row_words + w)
            up.append(p)
            w += (len(p) + 3) // 4
        else:
            bases.append(row * row_words)
    up_words = geometry.pow2_bucket(w + DECODE_SLACK_WORDS, 1024)
    pool8 = np.zeros(up_words * 4, np.uint8)
    o = 0
    for p in up:
        pool8[o * 4 : o * 4 + len(p)] = np.frombuffer(p, np.uint8)
        o += (len(p) + 3) // 4

    bit_off = np.stack([sy[0] for _, _, sy in items])
    prev = np.stack([sy[1] for _, _, sy in items])
    consec = np.stack([sy[2] for _, _, sy in items])
    run = np.stack([sy[3] for _, _, sy in items])
    T, B = bit_off.shape

    buf = np.empty(T + 3 * T * B + up_words, np.uint32)
    buf[:T] = np.asarray(bases, np.int32).view(np.uint32)
    off = T
    buf[off : off + T * B] = bit_off.astype(np.uint32).ravel()
    off += T * B
    buf[off : off + T * B] = prev.astype(np.int32).view(np.uint32).ravel()
    off += T * B
    buf[off : off + T * B] = (
        (consec.astype(np.uint32) << 16) | run.astype(np.uint16).astype(np.uint32)
    ).ravel()
    off += T * B
    buf[off:] = pool8.view(">u4").astype(np.uint32)
    return buf, up_words, T, B


def _resident_rows(items, res_group):
    """Map decode items onto a residue group's device rows: returns a
    per-item row index (None = upload: the encoder's host-coder
    fallback), or None for the whole group when the blob does not match
    the residue (defensive: wrong pairing disables reuse, never
    corrupts). Matching is by payload length AND the CRC the encoder
    recorded while framing the blob (encode.collect_tiles_blocks), so
    coinciding sizes cannot slip a mispaired residue through."""
    import zlib

    rowmap = {
        t.index: j
        for j, t in enumerate(res_group["tiles"])
        if j not in res_group["fallback"]
    }
    crcs = res_group.get("crc")
    out = []
    for t, p, _sy in items:
        j = rowmap.get(t.index)
        if j is not None:
            if int(res_group["totals"][j]) != len(p):
                return None
            if crcs is None or crcs[j] != zlib.crc32(p):
                return None
        out.append(j)
    return out


def dispatch_tiles_device_entropy(view, cursor: int, grid, s: Settings, channels: int,
                                  pool=None, residue=None,
                                  events=None, events_user=None):
    """Device-entropy decode phase 1: scan every tile's Kagari block on
    host (sync records only — no value decode), upload compressed words
    + sync, and dispatch the fused entropy-decode + unlift + format
    program per shape group. Returns dispatch records; tiles with
    oversized codes (the zigzag(-32768) misalignment quirk,
    runtime/kagari.py:kagari_sync) decode on host instead.

    Only the compressed bytes (bucket-padded) and tiny sync tables
    are copied to the device, not ~5.6 MB/image of int16/int8 planes
    (reference decode loop: library/kagari.c:301-366)."""
    from ako_tpu.ops.kagari_device import DECODE_BLOCK
    from ako_tpu.runtime.kagari import BLOCK_HEAD, kagari_sync
    from ako_tpu.runtime.transfer import device_put_parallel

    total = len(grid)
    # sequential boundary walk (block sizes live in each head) ...
    _fire(events, 0, total, Event.COMPRESSION_START, events_user)
    blocks = []
    for t in grid:
        tds, spacing = tile_block_sizes(t, s, channels)
        if cursor + BLOCK_HEAD.size > len(view):
            raise AkoError(Status.BROKEN_INPUT)
        (bs,) = BLOCK_HEAD.unpack_from(view, cursor)
        payload = view[cursor + BLOCK_HEAD.size : cursor + BLOCK_HEAD.size + bs]
        if len(payload) < bs:
            raise AkoError(Status.BROKEN_INPUT)
        blocks.append((t, payload, tds, spacing, bs))
        cursor += BLOCK_HEAD.size + bs

    # ... then independent sync scans, optionally on the worker pool
    # (the native scanner releases the GIL). MANBAVARAN-flagged blocks
    # try the rANS scanner first; reference-style reserved-flag blocks
    # fail its magic check and scan as Kagari (runtime/kagari.py).
    from ako_tpu.runtime.kagari import manba_sync

    def scan(args):
        t, payload, tds, spacing, bs = args
        if s.compression == Compression.MANBAVARAN:
            ms = manba_sync(tds // 2, payload, DECODE_BLOCK)
            if ms is not None:
                return ("manba", ms)
        return ("kagari", kagari_sync(tds // 2, payload, tds + spacing, DECODE_BLOCK))

    syncs = list(pool.map(scan, blocks)) if pool is not None else [
        scan(b) for b in blocks
    ]
    # the shared walk+scan closes here; per-shape-group COMPRESSION
    # pairs below cover each group's pack + upload + entropy dispatch
    # (PARITY.md divergence 10: group granularity, not per tile)
    _fire(events, 0, total, Event.COMPRESSION_END, events_user)

    per_shape: dict = {}
    per_shape_manba: dict = {}
    host_tiles: list = []
    for (t, payload, tds, spacing, bs), (kind, sync) in zip(blocks, syncs):
        if kind == "manba":
            if sync[7] != bs:
                raise AkoError(Status.BROKEN_INPUT)
            per_shape_manba.setdefault((t.w, t.h), []).append(
                (t, payload, (kind, sync))
            )
            continue
        if sync is None or sync[4] != bs:
            raise AkoError(Status.BROKEN_INPUT)
        if sync[5] > 31:
            host_tiles.append((t, payload, tds // 2))
        else:
            per_shape.setdefault((t.w, t.h), []).append((t, payload, sync))

    # fallback observability (utils/metrics.py; bench JSON `fallbacks`)
    from ako_tpu.utils import metrics
    from ako_tpu.utils.debug import dev_printf

    metrics.bump(
        metrics.DEC_DEVICE,
        sum(len(v) for v in per_shape.values())
        + sum(len(v) for v in per_shape_manba.values()),
    )
    if host_tiles:
        metrics.bump(metrics.DEC_HOST_FALLBACK, len(host_tiles))
        dev_printf(
            "dec: %d/%d quirk streams (gamma codes > 31 bits) decoded on host",
            len(host_tiles),
            total,
        )

    from ako_tpu.ops.kagari_device import decode_span_words
    from ako_tpu.runtime import transport

    # Transport mode (AKO_TPU_TRANSPORT=1): pixels leave the device as
    # a lossless q0 re-encode instead of raw bands -- ~1.7x fewer
    # device->host bytes for an overlappable host unpack.
    use_transport = transport.enabled()
    out_mode = "ileaved" if use_transport else "bands"

    # Paired round-trip reuse: when the caller passes the encoder's
    # residue for this very blob (executor.roundtrip_iter), the bulk
    # word pool is already on device as the encode output rows.
    res_by_shape = {}
    if residue:
        for g in residue:
            if g["tiles"]:
                res_by_shape[(g["tiles"][0].w, g["tiles"][0].h)] = g

    dispatched = []
    for (tw, th), items in per_shape.items():
        _fire(events, items[0][0].index, total, Event.COMPRESSION_START, events_user)
        count = tile_block_sizes(items[0][0], s, channels)[0] // 2
        span = _bucket_span(
            max(
                decode_span_words(sy[0], len(p) * 8)
                for _, p, sy in items
            )
        )
        res_group = res_by_shape.get((tw, th))
        res_rows = _resident_rows(items, res_group) if res_group else None
        if res_rows is not None and any(j is not None for j in res_rows):
            comp = res_group["comp"]
            rows, row_bytes = int(comp.shape[0]), int(comp.shape[1])
            buf, up_words, tcount, bcount = _pack_entropy_upload_resident(
                items, res_rows, (row_bytes + 3) // 4, rows
            )
            # clamp to the combined pool (resident rows + uploaded
            # tail), mirroring the non-resident branch — the decoder's
            # inner min(span, wcap) would also catch this, but the
            # call-site clamp keeps that inner clamp non-load-bearing
            pool_total = rows * ((row_bytes + 3) // 4) + up_words
            efn = _entropy_decode_fn_resident(
                count,
                DECODE_BLOCK,
                rows,
                row_bytes,
                up_words,
                min(span, pool_total),
                tcount,
                bcount,
            )
            streams_dev = efn(device_put_parallel(buf), comp)
        else:
            buf, pool_words, tcount, bcount = _pack_entropy_upload(items)
            efn = _entropy_decode_fn(
                count, DECODE_BLOCK, pool_words, min(span, pool_words), tcount, bcount
            )
            streams_dev = efn(device_put_parallel(buf))
        dfn = _tile_decoder(tw, th, channels, s.wavelet, s.wrap, s.color, out_mode)
        pixels_dev = dfn(streams_dev)
        if use_transport:
            pixels_dev = transport.pack_pixels(pixels_dev, tw, th, channels)
        _fire(events, items[0][0].index, total, Event.COMPRESSION_END, events_user)
        dispatched.append(([t for t, _, _ in items], th, tw, pixels_dev))

    # Manbavaran (rANS extension) groups: the device rANS decoder
    # (ops/manba_device.py) from the host sync records, chained into
    # the same unlift+format program
    for (tw, th), items in per_shape_manba.items():
        _fire(events, items[0][0].index, total, Event.COMPRESSION_START, events_user)
        count = tile_block_sizes(items[0][0], s, channels)[0] // 2
        buf, pool_words, tcount, bcount, rspan, espan = _pack_manba_upload(items)
        efn = _entropy_decode_fn_manba(
            count,
            DECODE_BLOCK,
            min(rspan, pool_words),
            min(espan, pool_words),
            pool_words,
            tcount,
            bcount,
        )
        streams_dev = efn(device_put_parallel(buf))
        dfn = _tile_decoder(tw, th, channels, s.wavelet, s.wrap, s.color, out_mode)
        pixels_dev = dfn(streams_dev)
        if use_transport:
            pixels_dev = transport.pack_pixels(pixels_dev, tw, th, channels)
        _fire(events, items[0][0].index, total, Event.COMPRESSION_END, events_user)
        dispatched.append(([t for t, _, _ in items], th, tw, pixels_dev))

    # quirk tiles: exact host decode, standard device unlift
    by_shape_host: dict = {}
    for t, payload, count in host_tiles:
        from ako_tpu.runtime.kagari import kagari_decode

        tds_h, spacing_h = tile_block_sizes(t, s, channels)
        res = kagari_decode(count, payload, tds_h + spacing_h)
        if res is None:
            raise AkoError(Status.BROKEN_INPUT)
        by_shape_host.setdefault((t.w, t.h), []).append((t, res[0]))
    for (tw, th), items in by_shape_host.items():
        _fire(events, items[0][0].index, total, Event.COMPRESSION_START, events_user)
        batch = np.stack([v for _, v in items], axis=0)
        pixels_dev = _run_tile_decoder(batch, tw, th, channels, s, out_mode)
        if use_transport:
            pixels_dev = transport.pack_pixels(pixels_dev, tw, th, channels)
        _fire(events, items[0][0].index, total, Event.COMPRESSION_END, events_user)
        dispatched.append(([t for t, _ in items], th, tw, pixels_dev))
    return dispatched


@traced
def decode(
    blob: bytes,
    events: Optional[EventsCallback] = None,
    events_user=None,
    device_entropy: Optional[bool] = None,
) -> Tuple[np.ndarray, Settings, int]:
    """Decode an .ako blob. Returns (image uint8 (h, w, channels),
    settings-from-header, channels); raises AkoError on failure."""
    if blob is None:
        raise AkoError(Status.INVALID_INPUT)
    view = memoryview(blob)
    channels, image_w, image_h, s = container.head_read(view)
    _check_decode_budget(image_w, image_h, channels)
    cursor = container.HEAD_SIZE

    if host_decode_mode():
        grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
        total = len(grid)
        image = np.empty((image_h, image_w, channels), dtype=np.uint8)
        from ako_tpu.runtime.hostcodec import planes_to_u8, tile_unlift

        # per-tile native decode keeps the reference's per-tile event
        # granularity (ako.h:75-84): COMPRESSION around the entropy
        # decode, WAVELET around the unlift, FORMAT around the color
        # conversion + placement
        cursor2 = cursor
        for t in grid:
            payload, cursor2 = _read_tile_block(view, cursor2, t, s, channels)
            _fire(events, t.index, total, Event.COMPRESSION_START, events_user)
            values = _entropy_one(payload, t, s, channels)
            _fire(events, t.index, total, Event.COMPRESSION_END, events_user)
            _fire(events, t.index, total, Event.WAVELET_START, events_user)
            planes = tile_unlift(values, t.w, t.h, channels, s.wavelet, s.wrap)
            _fire(events, t.index, total, Event.WAVELET_END, events_user)
            _fire(events, t.index, total, Event.FORMAT_START, events_user)
            image[t.y : t.y + t.h, t.x : t.x + t.w] = planes_to_u8(
                planes, s.color
            )
            _fire(events, t.index, total, Event.FORMAT_END, events_user)
        return image, s, channels

    from ako_tpu.encode import tile_events_mode
    from ako_tpu.runtime.device import resolve_device_entropy

    device_entropy = resolve_device_entropy(device_entropy)

    if (
        device_entropy
        and s.compression == Compression.KAGARI
        and tile_events_mode(events)
    ):
        return _decode_tile_events(
            view, cursor, image_w, image_h, channels, s, events, events_user
        )
    if device_entropy and s.compression in (
        Compression.KAGARI,
        Compression.MANBAVARAN,
    ):
        grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
        total = len(grid)
        # fused-path event granularity: per SHAPE GROUP (PARITY.md
        # divergence 10; AKO_TPU_EVENTS=tile above restores the
        # reference's per-tile pairs at tracing-mode cost):
        # COMPRESSION covers the host sync scan + upload + dispatch
        # (fired inside dispatch_tiles_device_entropy),
        # WAVELET the device wait, FORMAT the pixel drain
        from ako_tpu.runtime.transfer import _get_pool

        dispatched = dispatch_tiles_device_entropy(
            view, cursor, grid, s, channels, _get_pool(),
            events=events, events_user=events_user,
        )
        image = np.empty((image_h, image_w, channels), dtype=np.uint8)
        for tiles, _th, _tw, pixels_dev in dispatched:
            _fire(events, tiles[0].index, total, Event.WAVELET_START, events_user)
            pixels_ready(pixels_dev)
            _fire(events, tiles[0].index, total, Event.WAVELET_END, events_user)
        for tiles, th, tw, pixels_dev in dispatched:
            _fire(events, tiles[0].index, total, Event.FORMAT_START, events_user)
            place_pixels(image, tiles, th, tw, pixels_dev)
            _fire(events, tiles[0].index, total, Event.FORMAT_END, events_user)
        return image, s, channels

    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    total = len(grid)

    # Host: entropy-decode every tile block into its coefficient stream
    streams: list[np.ndarray] = []
    for t in grid:
        _fire(events, t.index, total, Event.COMPRESSION_START, events_user)
        values, cursor = read_tile_stream(view, cursor, t, s, channels)
        _fire(events, t.index, total, Event.COMPRESSION_END, events_user)
        streams.append(values)

    # Device: batched unlift + format per tile shape
    image = np.empty((image_h, image_w, channels), dtype=np.uint8)
    by_shape: dict[tuple[int, int], list[geometry.TilePlacement]] = {}
    for t in grid:
        by_shape.setdefault((t.w, t.h), []).append(t)

    for (tw, th), tiles in by_shape.items():
        t0 = tiles[0].index
        _fire(events, t0, total, Event.WAVELET_START, events_user)
        batch = np.stack([streams[t.index] for t in tiles], axis=0)
        out = _run_tile_decoder(batch, tw, th, channels, s)
        pixels_ready(out)
        _fire(events, t0, total, Event.WAVELET_END, events_user)
        _fire(events, t0, total, Event.FORMAT_START, events_user)
        place_pixels(image, tiles, th, tw, out)
        _fire(events, t0, total, Event.FORMAT_END, events_user)

    return image, s, channels


def _decode_tile_events(
    view, cursor: int, image_w: int, image_h: int, channels: int, s: Settings,
    events, events_user,
):
    """Tracing-exact fused decode (AKO_TPU_EVENTS=tile + an events
    callback): one device dispatch per tile with the reference's
    per-tile event pairs (ako.h:75-84) — COMPRESSION = sync scan +
    word upload + device entropy decode (quirk streams decode on the
    host exactly, like the batched path), WAVELET = the unlift+color
    program, FORMAT = the pixel drain + placement. Pixels bit-identical
    to every other path; a tracing mode, tile dispatches serialize."""
    from ako_tpu.ops.kagari_device import DECODE_BLOCK, decode_span_words
    from ako_tpu.runtime.kagari import kagari_sync
    from ako_tpu.runtime.transfer import device_put_parallel
    from ako_tpu.utils import metrics

    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    total = len(grid)
    image = np.empty((image_h, image_w, channels), dtype=np.uint8)
    for t in grid:
        payload, cursor = _read_tile_block(view, cursor, t, s, channels)
        tds, spacing = tile_block_sizes(t, s, channels)
        count = tds // 2
        _fire(events, t.index, total, Event.COMPRESSION_START, events_user)
        sync = kagari_sync(count, payload, tds + spacing, DECODE_BLOCK)
        if sync is None or sync[4] != len(payload):
            raise AkoError(Status.BROKEN_INPUT)
        if sync[5] > 31:  # oversized-code quirk: exact host decode
            metrics.bump(metrics.DEC_HOST_FALLBACK)
            streams = _entropy_one(payload, t, s, channels)[None]
            streams_dev = jnp.asarray(streams)
        else:
            metrics.bump(metrics.DEC_DEVICE)
            span = _bucket_span(decode_span_words(sync[0], len(payload) * 8))
            buf, pool_words, tcount, bcount = _pack_entropy_upload(
                [(t, payload, sync)]
            )
            efn = _entropy_decode_fn(
                count, DECODE_BLOCK, pool_words, min(span, pool_words),
                tcount, bcount,
            )
            streams_dev = efn(device_put_parallel(buf))
        np.asarray(streams_dev[:1, :1])  # bound the entropy stage
        _fire(events, t.index, total, Event.COMPRESSION_END, events_user)
        _fire(events, t.index, total, Event.WAVELET_START, events_user)
        dfn = _tile_decoder(t.w, t.h, channels, s.wavelet, s.wrap, s.color)
        out = dfn(streams_dev)
        pixels_ready(out)
        _fire(events, t.index, total, Event.WAVELET_END, events_user)
        _fire(events, t.index, total, Event.FORMAT_START, events_user)
        place_pixels(image, [t], t.h, t.w, out)
        _fire(events, t.index, total, Event.FORMAT_END, events_user)
    return image, s, channels


def decode_tiles_iter(blob: bytes, max_batch: int = 32):
    """Streaming decode: yield (tile_placement, pixels uint8 (th, tw,
    channels)) as tile blocks are consumed, in tile row-major order.

    The format is tile-streamable — every tile block is independently
    decodable once the 16-byte header is read (the reference documents
    this property; SURVEY.md §5 checkpoint/resume analog). A truncated
    blob yields the tiles that fit and then raises AkoError.

    Consecutive same-shaped tiles (typically whole grid rows) are
    dispatched as one batched device program with parallel transfers,
    bounded by `max_batch` — an order of magnitude faster than the
    round-1 one-tile-at-a-time dispatch while keeping bounded lookahead
    and the exact yield order/truncation semantics."""
    view = memoryview(blob)
    channels, image_w, image_h, s = container.head_read(view)
    _check_decode_budget(image_w, image_h, channels)
    cursor = container.HEAD_SIZE
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)

    pending: list = []

    def flush():
        if not pending:
            return
        tw, th = pending[0][0].w, pending[0][0].h
        batch = np.stack([v for _, v in pending], axis=0)
        pixels = assemble_pixels(_run_tile_decoder(batch, tw, th, channels, s))
        for (t, _), px in zip(pending, pixels):
            yield t, px
        pending.clear()

    for t in grid:
        try:
            values, cursor = read_tile_stream(view, cursor, t, s, channels)
        except AkoError:
            # truncated/corrupt: everything parsed so far still decodes
            yield from flush()
            raise
        if pending and (
            (pending[0][0].w, pending[0][0].h) != (t.w, t.h)
            or len(pending) >= max_batch
        ):
            yield from flush()
        pending.append((t, values))
    yield from flush()
