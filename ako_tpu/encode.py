"""Encode orchestrator: image -> .ako blob.

Pipeline split (reference: library/encode.c:38-232, rebuilt for an
accelerator):
the per-tile compute (format + lift + fused quantization) runs on
device as one jitted program per distinct tile shape, batched over all
same-shaped tiles; the entropy stage (Kagari) and container assembly
run on host over the serialized coefficient streams. Blob bytes are
identical to the reference encoder's for every settings combination.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

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
    default_settings,
)
from ako_tpu.ops.colorspace import to_planar_yuv
from ako_tpu.ops.kagari_device import kagari_encode_device
from ako_tpu.ops.lifting import forward_tile
from ako_tpu.ops.quantization import level_qg
from ako_tpu.runtime.kagari import BLOCK_HEAD, compress_block
from ako_tpu.utils.tracing import traced

#: device-entropy fallback margin: within this many bytes of capacity,
#: defer to the host coder so the exact failure semantics of the
#: reference's bounds checks (kagari.c:66-78,95-110) decide
_CAPACITY_MARGIN = 16


def pack_budget(capacity: int, quantization: int) -> int:
    """Device Kagari packer byte budget. Capacity/2 for lossy: measured
    per-tile ratios on photographic content at 128-px tiles are ~3.4:1,
    so capacity/4 pushes most tiles into the (slow, exact) host
    fallback — it regressed the end-to-end benchmark three times before
    a direct count confirmed 77/80 tiles falling back."""
    budget = capacity // 2 if quantization > 0 else capacity * 7 // 8
    return max(budget, 4096)

def _fetch_pool():
    """The shared TASK pool (runtime.transfer.io_pool) — used here for
    totals/prepare futures and per-bucket compressed-byte fetches.
    These tasks call device_get_parallel, which fans chunk fetches out
    on the separate leaf chunk pool, so they must not share it."""
    from ako_tpu.runtime.transfer import io_pool

    return io_pool()


def host_encode_mode() -> bool:
    """AKO_TPU_ENCODE=host routes encode's compute (format + lift +
    entropy) through the native host path (runtime/hostcodec.py +
    akort.c) with no device traffic — the symmetric twin of
    decode.host_decode_mode. bench.py races this mode against the
    device paths; the default is the device path."""
    return os.environ.get("AKO_TPU_ENCODE") == "host"


@functools.lru_cache(maxsize=256)
def _host_qg(
    tile_w: int,
    tile_h: int,
    channels: int,
    quantization: int,
    gate: int,
    chroma_loss: int,
):
    """Per-tile-shape quantization/gate table for the native lift
    (hostcodec.tile_lift signature), cached like the device programs."""
    schedule = geometry.lift_schedule(tile_w, tile_h)
    return level_qg(schedule, channels, quantization, gate, chroma_loss)


class HostSpanPlan(NamedTuple):
    """Per-(geometry, settings) arrays for the batched native span
    encoder (akort_tile_encode_spans): everything the C side needs per
    tile, precomputed once and cached, so the per-image Python cost of
    the host-native pipeline is one buffer allocation + a slice join.
    All arrays are in wire (tile-index) order and read-only."""

    rects: np.ndarray  # (n, 4) i32: x, y, w, h
    qg_off: np.ndarray  # (n,) i64 offsets into qs/gs
    qs: np.ndarray  # i32 concatenated per-tile quantization steps
    gs: np.ndarray  # i32 concatenated per-tile gate thresholds
    counts: np.ndarray  # (n,) i64 stream elements per tile
    caps: np.ndarray  # (n,) i64 payload capacity bytes per tile
    out_off: np.ndarray  # (n,) i64 block-region starts in the out buffer
    total_bytes: int  # out buffer size: sum(caps + BLOCK_HEAD.size)


@functools.lru_cache(maxsize=64)
def _host_span_plan(
    image_w: int,
    image_h: int,
    channels: int,
    tiles_dimension: int,
    wavelet: Wavelet,
    quantization: int,
    gate: int,
    chroma_loss: int,
) -> HostSpanPlan:
    grid = geometry.tile_grid(image_w, image_h, tiles_dimension)
    n = len(grid)
    rects = np.empty((n, 4), np.int32)
    qg_off = np.empty(n, np.int64)
    counts = np.empty(n, np.int64)
    caps = np.empty(n, np.int64)
    qs_parts: list = []
    gs_parts: list = []
    by_shape: dict = {}
    off = 0
    for i, t in enumerate(grid):
        rects[i] = (t.x, t.y, t.w, t.h)
        if wavelet == Wavelet.NONE:
            tds = t.w * t.h * channels * 2
            counts[i] = t.w * t.h * channels
            q_arr = g_arr = np.empty(0, np.int32)
        else:
            tds = geometry.tile_data_size(t.w, t.h) * channels
            counts[i] = tds // 2
            key = (t.w, t.h)
            if key not in by_shape:
                qg = _host_qg(t.w, t.h, channels, quantization, gate, chroma_loss)
                by_shape[key] = (
                    np.ascontiguousarray(
                        [q for lq, _ in qg for q in lq], dtype=np.int32
                    ),
                    np.ascontiguousarray(
                        [g for _, lg in qg for g in lg], dtype=np.int32
                    ),
                )
            q_arr, g_arr = by_shape[key]
        qg_off[i] = off
        off += q_arr.size
        qs_parts.append(q_arr)
        gs_parts.append(g_arr)
        # region = 4-byte block head + payload capacity (the
        # incompressible bound, encode_tile_block_host's contract)
        caps[i] = max(0, tds - BLOCK_HEAD.size)
    qs = np.concatenate(qs_parts) if off else np.empty(0, np.int32)
    gs = np.concatenate(gs_parts) if off else np.empty(0, np.int32)
    regions = caps + BLOCK_HEAD.size
    out_off = np.concatenate(([0], np.cumsum(regions[:-1]))).astype(np.int64)
    for a in (rects, qg_off, qs, gs, counts, caps, out_off):
        a.setflags(write=False)
    return HostSpanPlan(
        rects, qg_off, qs, gs, counts, caps, out_off, int(regions.sum())
    )


def encode_tile_block_host(
    image: np.ndarray, t, s: Settings, channels: int
) -> bytes:
    """One tile's container block, computed entirely on the host CPU
    (native format + lift + entropy; akort.c). Byte-identical to the
    device path's output — both are oracle-gated. Tiles are independent
    and the native calls release the GIL, so callers fan these out on
    a worker pool (runtime/executor.PipelineEncoder host mode).

    Kagari-effective blocks run as ONE native call
    (hostcodec.tile_encode_block): every Python<->C crossing holds the
    GIL, so fusing format+lift+entropy into a single crossing is a
    direct pool-parallelism win."""
    from ako_tpu.runtime import hostcodec
    from ako_tpu.runtime.kagari import effective_method

    tile = image[t.y : t.y + t.h, t.x : t.x + t.w, :]
    if s.wavelet == Wavelet.NONE:
        tds = t.w * t.h * channels * 2
        qg = ()
    else:
        tds = geometry.tile_data_size(t.w, t.h) * channels
        qg = _host_qg(t.w, t.h, channels, s.quantization, s.gate, s.chroma_loss)
    if effective_method(s.compression) == Compression.KAGARI:
        payload = hostcodec.tile_encode_block(
            tile, s.wavelet, s.wrap, s.color, qg, tds - BLOCK_HEAD.size,
            bool(s.discard_non_visible),
        )
        if payload is None:
            raise AkoError(Status.ERROR, "incompressible tile")
        return BLOCK_HEAD.pack(len(payload)) + payload
    planes = hostcodec.u8_to_planes(tile, s.color, bool(s.discard_non_visible))
    if s.wavelet == Wavelet.NONE:
        stream = np.ascontiguousarray(planes).reshape(-1)
    else:
        stream = hostcodec.tile_lift(planes, s.wavelet, s.wrap, qg)
    if s.compression == Compression.NONE:
        return stream.tobytes()
    block = compress_block(stream, tds, s.compression)
    if block is None:
        raise AkoError(Status.ERROR, "incompressible tile")
    return block


def checked_settings(s: Optional[Settings]) -> Settings:
    """YCoCg auto-switches to the x2-premultiplied variant when lossy
    (encode.c:60-64)."""
    s = default_settings() if s is None else s
    if s.color == Color.YCOCG and (s.quantization > 0 or s.gate > 0):
        s = s.replace(color=Color.YCOCG_Q)
    elif s.color == Color.YCOCG_Q and (s.quantization <= 0 and s.gate <= 0):
        s = s.replace(color=Color.YCOCG)
    return s


@functools.lru_cache(maxsize=256)
def _tile_encoder(
    tile_w: int,
    tile_h: int,
    channels: int,
    wavelet: Wavelet,
    wrap: Wrap,
    color: Color,
    discard_non_visible: bool,
    quantization: int,
    gate: int,
    chroma_loss: int,
):
    """Jitted device program: (T, tile_h, tile_w, channels) u8 tiles ->
    (T, coeff_count) int16 serialized streams."""
    schedule = geometry.lift_schedule(tile_w, tile_h)
    qg = level_qg(schedule, channels, quantization, gate, chroma_loss)

    def fn(tiles_u8):
        planes = to_planar_yuv(tiles_u8, color, discard_non_visible)
        if wavelet == Wavelet.NONE:
            return planes.reshape(planes.shape[:-3] + (-1,))
        return forward_tile(planes, schedule, wavelet, wrap, qg)

    return jax.jit(fn)


@functools.lru_cache(maxsize=256)
def _tile_encoder_fused_raw(
    tile_w: int,
    tile_h: int,
    channels: int,
    wavelet: Wavelet,
    wrap: Wrap,
    color: Color,
    discard_non_visible: bool,
    quantization: int,
    gate: int,
    chroma_loss: int,
    fill_last: Optional[int] = None,
):
    """Fully fused device program (unjitted): (T, tile_h, tile_w,
    channels) u8 tiles -> (compressed bytes (T, budget) u8, total_bytes
    (T,) i32). The Kagari block is produced ON DEVICE
    (ops/kagari_device.py), so only compressed bytes are copied to the
    host. Returned raw so callers can jit with sharding annotations
    (parallel/tiles.py).

    With `fill_last` (a u8 constant), fwd takes (T, tile_h, tile_w,
    channels-1) u8 tiles and broadcasts the constant as the trailing
    channel on device — callers that detect a constant alpha plane
    upload 25% fewer pixel bytes for the byte-identical blob. The
    value is baked into the program (it is 255 in practice, so this
    costs one compile, not one per image) rather than uploaded, which
    saves a tiny per-image host->device copy."""
    schedule = geometry.lift_schedule(tile_w, tile_h)
    qg = level_qg(schedule, channels, quantization, gate, chroma_loss)
    if wavelet != Wavelet.NONE:
        tds = geometry.tile_data_size(tile_w, tile_h) * channels
    else:
        tds = tile_w * tile_h * channels * 2
    capacity = tds - BLOCK_HEAD.size
    budget = pack_budget(capacity, quantization)

    def _fwd_full(tiles_u8):
        planes = to_planar_yuv(tiles_u8, color, discard_non_visible)
        if wavelet == Wavelet.NONE:
            return planes.reshape(planes.shape[:-3] + (-1,))
        return forward_tile(planes, schedule, wavelet, wrap, qg)

    if fill_last is not None:

        def fwd(tiles_u8):
            last = jnp.full(
                tiles_u8.shape[:-1] + (1,), fill_last, dtype=jnp.uint8
            )
            return _fwd_full(jnp.concatenate([tiles_u8, last], axis=-1))

    else:
        fwd = _fwd_full

    def pack(stream):
        return jax.vmap(lambda v: kagari_encode_device(v, capacity, budget))(stream)

    def fn(*args):
        return pack(fwd(*args))

    fn.fwd = fwd
    fn.pack = pack
    return fn, capacity, budget


@functools.lru_cache(maxsize=256)
def _tile_encoder_fused(*args):
    """Two chained jitted programs (forward, then entropy pack) rather
    than one: the single fused graph makes the XLA compile blow up from
    ~25s to 10+ minutes, while the intermediate coefficient stream
    stays on device either way. Returned separately so callers can keep
    the coefficient stream for the near-capacity host-coder fallback
    (no tile is ever lifted twice)."""
    raw, capacity, budget = _tile_encoder_fused_raw(*args)
    return jax.jit(raw.fwd), jax.jit(raw.pack), capacity, budget


def _fire(events, tile_no, total, event, user):
    if events is not None:
        events(tile_no, total, event, user)


def encode_tiles_device(
    image: np.ndarray,
    s: Settings,
    events: Optional[EventsCallback] = None,
    events_user=None,
):
    """Run the device stage for every tile; returns a list of int16
    numpy coefficient streams in tile (row-major) order."""
    image_h, image_w, channels = image.shape
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    total = len(grid)

    by_shape: dict[tuple[int, int], list[geometry.TilePlacement]] = {}
    for t in grid:
        by_shape.setdefault((t.w, t.h), []).append(t)

    out: list[Optional[np.ndarray]] = [None] * len(grid)
    for (tw, th), tiles in by_shape.items():
        fn = _tile_encoder(
            tw,
            th,
            channels,
            s.wavelet,
            s.wrap,
            s.color,
            bool(s.discard_non_visible),
            s.quantization,
            s.gate,
            s.chroma_loss,
        )
        t0 = tiles[0].index
        _fire(events, t0, total, Event.FORMAT_START, events_user)
        batch = np.stack(
            [image[t.y : t.y + th, t.x : t.x + tw, :] for t in tiles], axis=0
        )
        batch_dev = jnp.asarray(batch)
        _fire(events, t0, total, Event.FORMAT_END, events_user)
        _fire(events, t0, total, Event.WAVELET_START, events_user)
        coeffs = np.asarray(fn(batch_dev))
        _fire(events, t0, total, Event.WAVELET_END, events_user)
        for i, t in enumerate(tiles):
            out[t.index] = coeffs[i]
    return out


def dispatch_tiles_fused(
    image: np.ndarray, s: Settings, events=None, events_user=None
):
    """Phase 1 of device-entropy encode: enqueue the fused
    format+lift+Kagari program for every tile-shape group. Returns an
    opaque list of dispatch records; JAX dispatch is asynchronous, so
    the device starts immediately while the host moves on.

    Events fire per shape group (tile_no = the group's first tile
    index): FORMAT covers host staging + upload, WAVELET the program
    dispatch. Shape groups are the fused path's dispatch unit, so this
    is the finest granularity that doesn't serialize the pipeline
    (PARITY.md divergence 10; reference fires per tile, ako.h:75-84)."""
    image_h, image_w, channels = image.shape
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    total = len(grid)

    # Constant trailing channel (the alpha=255 norm for RGBA photos):
    # upload channels-1 planes and broadcast the constant on device —
    # same tile tensor, byte-identical blob, 25% fewer upload bytes.
    fill_val = image_fill_val(image)

    # Encode-side transport (AKO_TPU_TRANSPORT[_ENC]=1): the pixel
    # upload travels as per-tile lossless q0 bitstreams and is
    # reconstructed bit-exactly on device (runtime/transport.py).
    from ako_tpu.runtime import transport

    use_enc_transport = transport.enc_enabled()

    dispatched = []
    for (tw, th), tiles in _group_by_shape(grid).items():
        fwd, pack, capacity, budget = _tile_encoder_fused(
            tw,
            th,
            channels,
            s.wavelet,
            s.wrap,
            s.color,
            bool(s.discard_non_visible),
            s.quantization,
            s.gate,
            s.chroma_loss,
            fill_val,
        )
        t0 = tiles[0].index
        _fire(events, t0, total, Event.FORMAT_START, events_user)
        up_ch = channels - 1 if fill_val is not None else channels
        batch = np.stack(
            [image[t.y : t.y + th, t.x : t.x + tw, :up_ch] for t in tiles], axis=0
        )
        from ako_tpu.runtime.transfer import device_put_parallel

        tiles_dev = (
            transport.upload_tiles_packed(batch) if use_enc_transport else None
        )
        if tiles_dev is None:  # raw upload (default, or transport fallback)
            tiles_dev = device_put_parallel(batch)
        _fire(events, t0, total, Event.FORMAT_END, events_user)
        # keep the coefficient stream handle: near-capacity tiles fall
        # back to the host coder on it instead of re-running the lift
        stream_dev = fwd(tiles_dev)
        comp_bytes, totals_dev = pack(stream_dev)
        # start the (tiny) totals fetch now, on a worker; the same task
        # then immediately enqueues the bucketed slice/gather programs
        # for the byte fetch, so those device ops
        # land ahead of the NEXT image's compute in the FIFO device
        # stream instead of behind it (collect-time enqueue serialized
        # the pipeline by up to a full image of device work)
        prep_fut = _fetch_pool().submit(
            _prepare_collect, totals_dev, comp_bytes, capacity, budget
        )
        dispatched.append((tiles, stream_dev, comp_bytes, prep_fut, capacity, budget))
    return grid, channels, dispatched


def _prepare_collect(totals_dev, comp_bytes, capacity: int, budget: int):
    """Worker task submitted at dispatch time: fetch per-tile
    compressed sizes, split near-capacity tiles out as host-coder
    fallbacks, and enqueue the bucketed byte-fetch programs.

    Bucketed fetch: tiles sorted by compressed size and split into a
    few contiguous groups, each sliced at its own max width, so fetched
    bytes track actual compressed size instead of the global per-image
    max. Widths round up to 4 KiB so the device slice shapes (and their
    compiled programs) recur across images."""
    totals = np.asarray(totals_dev)
    fallback = [
        i
        for i, n in enumerate(totals)
        if int(n) > budget or int(n) >= capacity - _CAPACITY_MARGIN
    ]
    ok = [i for i in range(totals.shape[0]) if i not in set(fallback)]
    # fallback observability: the host fallback is bit-exact, so only
    # these counters (bench JSON `fallbacks`, AKO_TPU_DEV logging) can
    # catch a budget regression that silently routes tiles onto the
    # slow host path (utils/metrics.py)
    from ako_tpu.utils import metrics
    from ako_tpu.utils.debug import dev_printf

    metrics.bump(metrics.ENC_DEVICE, len(ok))
    if fallback:
        metrics.bump(metrics.ENC_HOST_FALLBACK, len(fallback))
        dev_printf(
            "enc: %d/%d tiles near capacity, deferred to the host coder",
            len(fallback),
            totals.shape[0],
        )
    groups, rows = [], []
    if ok:
        # more groups = tighter size tracking but more concurrent
        # fetches (read per call)
        groups_n = max(1, int(os.environ.get("AKO_FETCH_GROUPS", "4")))
        order = sorted(ok, key=lambda i: int(totals[i]))
        for group in np.array_split(np.asarray(order), min(groups_n, len(order))):
            if not len(group):
                continue
            m = int(totals[group[-1]])
            m = min(-(-max(m, 1) // 4096) * 4096, comp_bytes.shape[1])
            groups.append(group)
            rows.append(comp_bytes[jnp.asarray(group)][:, :m])
    return totals, fallback, groups, rows


def collect_tiles_blocks(
    s: Settings, channels: int, grid, dispatched, residue=None,
    events=None, events_user=None,
):
    """Phase 2: fetch compressed bytes (one bulk transfer per shape
    group) and frame the per-tile blocks; near-capacity tiles fall back
    to the host coder so the reference's exact bounds checks decide.
    The fallback reuses the already-computed device coefficient stream
    (one extra fetch, zero recompute).

    With `residue` (a list), appends one record per shape group holding
    the DEVICE-resident compressed-byte rows the blob was framed from:
    a paired decode of this very blob can then reuse them as its word
    pool instead of re-uploading ~2 MB/image of compressed words
    (decode.dispatch_tiles_device_entropy `residue=`; only valid for
    the blob this call returned — runtime/executor.roundtrip_iter)."""
    import zlib

    out: list[Optional[bytes]] = [None] * len(grid)
    total = len(grid)
    for tiles, stream_dev, comp_bytes, prep_fut, capacity, budget in dispatched:
        # the totals future resolves when the group's device program
        # (format+lift+pack, dispatched asynchronously) has run: that
        # wait is the wavelet stage's observable cost on this path
        _fire(events, tiles[0].index, total, Event.WAVELET_START, events_user)
        totals, fallback, groups, rows = prep_fut.result()
        _fire(events, tiles[0].index, total, Event.WAVELET_END, events_user)
        _fire(events, tiles[0].index, total, Event.COMPRESSION_START, events_user)
        rec = None
        if residue is not None:
            rec = {
                "tiles": tiles,
                "comp": comp_bytes,
                "totals": totals,
                "fallback": set(fallback),
                # per-tile payload CRCs, filled during the byte fetch
                # below: a paired decode verifies its payload bytes
                # against these before reusing the device rows, so a
                # mispaired residue with coinciding sizes can never
                # silently decode wrong pixels (decode._resident_rows)
                "crc": [None] * len(tiles),
            }
            residue.append(rec)
        if groups:
            from ako_tpu.runtime.transfer import device_get_parallel

            for group, host_bytes in zip(
                groups, _fetch_pool().map(device_get_parallel, rows)
            ):
                for j, i in enumerate(group):
                    n = int(totals[i])
                    payload = host_bytes[j, :n].tobytes()
                    if rec is not None:
                        rec["crc"][i] = zlib.crc32(payload)
                    out[tiles[i].index] = BLOCK_HEAD.pack(n) + payload
        if fallback:
            from ako_tpu.runtime.transfer import device_get_parallel

            streams = device_get_parallel(stream_dev[jnp.asarray(fallback)])
            for j, i in enumerate(fallback):
                block = compress_block(streams[j], capacity + BLOCK_HEAD.size)
                if block is None:
                    raise AkoError(Status.ERROR, "incompressible tile")
                out[tiles[i].index] = block
        _fire(events, tiles[0].index, total, Event.COMPRESSION_END, events_user)
    return out


def dispatch_images_fused(metas, s: Settings):
    """Phase 1 of the COALESCED device-entropy encode: one fused
    dispatch per tile shape covering EVERY tile of `metas`' images, so
    the per-image transfer chain — pixel upload, totals fetch, the
    bucketed byte fetches — is paid once per image GROUP instead of
    once per image.

    metas: list of (image, head, grid, channels, fill_val) sharing
    channels and fill_val (the executor groups by geometry signature so
    the fused programs' batch shapes recur across groups). Returns
    opaque records for collect_images_blobs."""
    from ako_tpu.runtime import transport
    from ako_tpu.runtime.transfer import device_put_parallel

    channels = metas[0][3]
    fill_val = metas[0][4]
    use_enc_transport = transport.enc_enabled()
    up_ch = channels - 1 if fill_val is not None else channels

    shape_tiles: dict[tuple[int, int], list] = {}
    for i, (_image, _head, grid, _ch, _fv) in enumerate(metas):
        for t in grid:
            shape_tiles.setdefault((t.w, t.h), []).append((i, t))

    recs = []
    for (tw, th), lst in shape_tiles.items():
        fwd, pack, capacity, budget = _tile_encoder_fused(
            tw,
            th,
            channels,
            s.wavelet,
            s.wrap,
            s.color,
            bool(s.discard_non_visible),
            s.quantization,
            s.gate,
            s.chroma_loss,
            fill_val,
        )
        batch = np.stack(
            [
                metas[i][0][t.y : t.y + th, t.x : t.x + tw, :up_ch]
                for i, t in lst
            ],
            axis=0,
        )
        tiles_dev = (
            transport.upload_tiles_packed(batch) if use_enc_transport else None
        )
        if tiles_dev is None:
            tiles_dev = device_put_parallel(batch)
        stream_dev = fwd(tiles_dev)
        comp_bytes, totals_dev = pack(stream_dev)
        prep_fut = _fetch_pool().submit(
            _prepare_collect, totals_dev, comp_bytes, capacity, budget
        )
        recs.append((lst, stream_dev, comp_bytes, prep_fut, capacity, budget))
    return recs


def collect_images_blobs(metas, recs) -> list[bytes]:
    """Phase 2 of the coalesced encode: drain the group's fetches and
    frame every image's blob. Block bytes are identical to the
    per-image path's (same fused programs, same per-tile framing, same
    near-capacity host-coder fallback), so blobs stay byte-identical to
    the reference whatever the grouping."""
    blocks: list[list] = [
        [None] * len(grid) for (_img, _head, grid, _ch, _fv) in metas
    ]
    for lst, stream_dev, _comp_bytes, prep_fut, capacity, budget in recs:
        totals, fallback, groups, rows = prep_fut.result()
        if groups:
            from ako_tpu.runtime.transfer import device_get_parallel

            for group, host_bytes in zip(
                groups, _fetch_pool().map(device_get_parallel, rows)
            ):
                for j, gi in enumerate(group):
                    img_i, t = lst[gi]
                    n = int(totals[gi])
                    blocks[img_i][t.index] = (
                        BLOCK_HEAD.pack(n) + host_bytes[j, :n].tobytes()
                    )
        if fallback:
            from ako_tpu.runtime.transfer import device_get_parallel

            streams = device_get_parallel(stream_dev[jnp.asarray(fallback)])
            for j, gi in enumerate(fallback):
                img_i, t = lst[gi]
                block = compress_block(streams[j], capacity + BLOCK_HEAD.size)
                if block is None:
                    raise AkoError(Status.ERROR, "incompressible tile")
                blocks[img_i][t.index] = block
    return [
        head + b"".join(bl)
        for (_img, head, _grid, _ch, _fv), bl in zip(metas, blocks)
    ]


def encode_tiles_blocks_tile_events(
    image: np.ndarray, s: Settings, events, events_user
) -> list:
    """Tracing-exact fused encode (AKO_TPU_EVENTS=tile + an events
    callback): ONE device dispatch per tile, with the reference's
    per-tile event pairs (ako.h:75-84) bounding each stage — FORMAT =
    staging + upload, WAVELET = the fused format+lift program (forced
    complete by a tiny fetch), COMPRESSION = the device pack + byte
    drain + framing. Restores the contract the batched fused path
    trades away (PARITY.md divergence 10) at a tracing-mode cost: tile
    dispatches serialize, and each stage boundary waits for the device.
    Blobs stay byte-identical to every other path."""
    image_h, image_w, channels = image.shape
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    total = len(grid)
    from ako_tpu.utils import metrics

    out = []
    for t in grid:
        fwd, pack, capacity, budget = _tile_encoder_fused(
            t.w,
            t.h,
            channels,
            s.wavelet,
            s.wrap,
            s.color,
            bool(s.discard_non_visible),
            s.quantization,
            s.gate,
            s.chroma_loss,
            None,
        )
        _fire(events, t.index, total, Event.FORMAT_START, events_user)
        batch = np.ascontiguousarray(
            image[t.y : t.y + t.h, t.x : t.x + t.w, :]
        )[None]
        tiles_dev = jnp.asarray(batch)
        np.asarray(tiles_dev[:1, :1, :1, :1])  # settle the upload
        _fire(events, t.index, total, Event.FORMAT_END, events_user)
        _fire(events, t.index, total, Event.WAVELET_START, events_user)
        stream_dev = fwd(tiles_dev)
        np.asarray(stream_dev[:1, :1])  # bound the lift stage
        _fire(events, t.index, total, Event.WAVELET_END, events_user)
        _fire(events, t.index, total, Event.COMPRESSION_START, events_user)
        comp, totals_dev = pack(stream_dev)
        n = int(np.asarray(totals_dev)[0])
        if n > budget or n >= capacity - _CAPACITY_MARGIN:
            metrics.bump(metrics.ENC_HOST_FALLBACK)
            block = compress_block(
                np.asarray(stream_dev)[0], capacity + BLOCK_HEAD.size
            )
            if block is None:
                raise AkoError(Status.ERROR, "incompressible tile")
        else:
            metrics.bump(metrics.ENC_DEVICE)
            block = BLOCK_HEAD.pack(n) + np.asarray(comp[0, :n]).tobytes()
        out.append(block)
        _fire(events, t.index, total, Event.COMPRESSION_END, events_user)
    return out


def tile_events_mode(events) -> bool:
    """True when the caller asked for reference-granularity per-tile
    events on the fused device paths (AKO_TPU_EVENTS=tile and an
    events callback present)."""
    return events is not None and os.environ.get("AKO_TPU_EVENTS") == "tile"


def image_fill_val(image: np.ndarray) -> Optional[int]:
    """Constant trailing channel detection (the alpha=255 norm): when
    every sample of the last channel is equal, the fused encoders
    broadcast it on device and the upload drops that plane."""
    channels = image.shape[-1]
    if channels in (2, 4):
        a = image[..., -1]
        if a.size and (a == a.flat[0]).all():
            return int(a.flat[0])
    return None


@functools.lru_cache(maxsize=64)
def _tile_encoder_manba(
    tile_w: int,
    tile_h: int,
    channels: int,
    wavelet: Wavelet,
    wrap: Wrap,
    color: Color,
    discard_non_visible: bool,
    quantization: int,
    gate: int,
    chroma_loss: int,
):
    """Fused device program for the MANBAVARAN extension: format + lift
    + the device rANS encoder (ops.manba_device.manba_encode_device),
    vmapped over same-shaped tiles. Returns (jitted fn, capacity):
    fn(tiles_u8) -> the encoder's 7-part tuple, batched."""
    from ako_tpu.ops.manba_device import manba_encode_device

    schedule = geometry.lift_schedule(tile_w, tile_h)
    qg = level_qg(schedule, channels, quantization, gate, chroma_loss)
    if wavelet != Wavelet.NONE:
        tds = geometry.tile_data_size(tile_w, tile_h) * channels
    else:
        tds = tile_w * tile_h * channels * 2
    capacity = tds - BLOCK_HEAD.size

    def fn(tiles_u8):
        planes = to_planar_yuv(tiles_u8, color, discard_non_visible)
        if wavelet == Wavelet.NONE:
            stream = planes.reshape(planes.shape[:-3] + (-1,))
        else:
            stream = forward_tile(planes, schedule, wavelet, wrap, qg)
        return jax.vmap(lambda v: manba_encode_device(v, capacity))(stream)

    return jax.jit(fn), capacity


def encode_tiles_blocks_manba(
    image: np.ndarray, s: Settings, events=None, events_user=None
):
    """Device-entropy encode for the MANBAVARAN extension: fused
    format + lift + device rANS per shape group; the host assembles
    head+rans+extras per tile (runtime.kagari.manba_assemble) and
    falls back to the native coder whenever the device result is
    inconclusive (model failure / budget truncation) — the host
    accept/reject boundary stays the ground truth. Blobs are
    byte-identical to the host path's."""
    from ako_tpu.runtime.kagari import manba_assemble
    from ako_tpu.utils import metrics

    image_h, image_w, channels = image.shape
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    total = len(grid)
    out: list[Optional[bytes]] = [None] * len(grid)
    for (tw, th), tiles in _group_by_shape(grid).items():
        fn, capacity = _tile_encoder_manba(
            tw,
            th,
            channels,
            s.wavelet,
            s.wrap,
            s.color,
            bool(s.discard_non_visible),
            s.quantization,
            s.gate,
            s.chroma_loss,
        )
        t0 = tiles[0].index
        _fire(events, t0, total, Event.FORMAT_START, events_user)
        batch = np.stack(
            [image[t.y : t.y + th, t.x : t.x + tw, :] for t in tiles], axis=0
        )
        batch_dev = jnp.asarray(batch)
        _fire(events, t0, total, Event.FORMAT_END, events_user)
        _fire(events, t0, total, Event.WAVELET_START, events_user)
        parts = [np.asarray(a) for a in fn(batch_dev)]
        _fire(events, t0, total, Event.WAVELET_END, events_user)
        _fire(events, t0, total, Event.COMPRESSION_START, events_user)
        freq, x, rrow, rbytes, erow, ebits, ok = parts
        fell_back = 0
        for i, t in enumerate(tiles):
            payload = manba_assemble(
                freq[i], x[i], rrow[i], rbytes[i], erow[i], ebits[i],
                ok[i], capacity,
            )
            if payload is None:
                fell_back += 1
                block = compress_block(
                    _host_stream_for_tile(image, t, s, channels),
                    capacity + BLOCK_HEAD.size,
                    s.compression,
                )
                if block is None:
                    raise AkoError(Status.ERROR, "incompressible tile")
                out[t.index] = block
            else:
                out[t.index] = BLOCK_HEAD.pack(len(payload)) + payload
        metrics.bump(metrics.ENC_DEVICE, len(tiles) - fell_back)
        metrics.bump(metrics.ENC_HOST_FALLBACK, fell_back)
        _fire(events, t0, total, Event.COMPRESSION_END, events_user)
    return out


def _host_stream_for_tile(image, t, s: Settings, channels: int) -> np.ndarray:
    """Native host forward (format+lift) of one tile — the fallback
    stream source when a device entropy result is inconclusive."""
    from ako_tpu.runtime import hostcodec

    tile = image[t.y : t.y + t.h, t.x : t.x + t.w, :]
    planes = hostcodec.u8_to_planes(tile, s.color, bool(s.discard_non_visible))
    if s.wavelet == Wavelet.NONE:
        return np.ascontiguousarray(planes).reshape(-1)
    qg = _host_qg(t.w, t.h, channels, s.quantization, s.gate, s.chroma_loss)
    return hostcodec.tile_lift(planes, s.wavelet, s.wrap, qg)


def _group_by_shape(grid):
    by_shape: dict[tuple[int, int], list[geometry.TilePlacement]] = {}
    for t in grid:
        by_shape.setdefault((t.w, t.h), []).append(t)
    return by_shape


def encode_tiles_blocks(
    image: np.ndarray,
    s: Settings,
    events: Optional[EventsCallback] = None,
    events_user=None,
):
    """Device-entropy encode: fused format+lift+Kagari on device,
    returning framed per-tile blocks in tile order. Only compressed
    bytes are copied device->host."""
    # Event granularity note (PARITY.md divergence 10): the fused path
    # runs tiles in batched async programs, so events fire per SHAPE
    # GROUP (tile_no = the group's first tile index) rather than per
    # tile — FORMAT covers host staging + upload, WAVELET the program
    # dispatch, COMPRESSION the compressed-byte drain + framing.
    grid, channels, dispatched = dispatch_tiles_fused(image, s, events, events_user)
    return collect_tiles_blocks(
        s, channels, grid, dispatched, events=events, events_user=events_user
    )


@traced
def encode(
    image: np.ndarray,
    settings: Optional[Settings] = None,
    events: Optional[EventsCallback] = None,
    events_user=None,
    device_entropy: Optional[bool] = None,
) -> bytes:
    """Encode an interleaved uint8 image of shape (h, w, channels) or
    (h, w). Returns the .ako blob; raises AkoError on failure.

    `events` is the per-stage tracing hook (core.events.Event pairs,
    reference library/ako.h:75-84)."""
    if image is None:
        raise AkoError(Status.INVALID_INPUT)
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[:, :, None]
    if image.ndim != 3 or image.dtype != np.uint8:
        raise AkoError(Status.INVALID_INPUT, "expected uint8 (h, w, ch)")

    s = checked_settings(settings)
    image_h, image_w, channels = image.shape

    head = container.head_write(channels, image_w, image_h, s)

    if host_encode_mode():
        from ako_tpu.runtime import hostcodec

        grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
        total = len(grid)
        blocks = [head]
        # per-tile native encode keeps the reference's per-tile event
        # granularity (ako.h:75-84): FORMAT around the color transform,
        # WAVELET around the lift, COMPRESSION around the entropy coder
        for t in grid:
            tile = image[t.y : t.y + t.h, t.x : t.x + t.w, :]
            _fire(events, t.index, total, Event.FORMAT_START, events_user)
            planes = hostcodec.u8_to_planes(
                tile, s.color, bool(s.discard_non_visible)
            )
            _fire(events, t.index, total, Event.FORMAT_END, events_user)
            _fire(events, t.index, total, Event.WAVELET_START, events_user)
            if s.wavelet == Wavelet.NONE:
                stream = np.ascontiguousarray(planes).reshape(-1)
                tds = t.w * t.h * channels * 2
            else:
                qg = _host_qg(
                    t.w, t.h, channels, s.quantization, s.gate, s.chroma_loss
                )
                stream = hostcodec.tile_lift(planes, s.wavelet, s.wrap, qg)
                tds = geometry.tile_data_size(t.w, t.h) * channels
            _fire(events, t.index, total, Event.WAVELET_END, events_user)
            _fire(events, t.index, total, Event.COMPRESSION_START, events_user)
            if s.compression == Compression.NONE:
                blocks.append(stream.tobytes())
            else:
                block = compress_block(stream, tds, s.compression)
                if block is None:
                    raise AkoError(Status.ERROR, "incompressible tile")
                blocks.append(block)
            _fire(events, t.index, total, Event.COMPRESSION_END, events_user)
        return b"".join(blocks)

    from ako_tpu.runtime.device import resolve_device_entropy
    from ako_tpu.runtime.kagari import effective_method

    device_entropy = resolve_device_entropy(device_entropy)

    eff = effective_method(s.compression)
    if device_entropy and eff == Compression.MANBAVARAN:
        # the extension's device rANS encoder (fused format+lift+pack)
        tile_blocks = encode_tiles_blocks_manba(image, s, events, events_user)
        return head + b"".join(tile_blocks)
    if device_entropy and eff == Compression.KAGARI:
        # covers KAGARI and reserved-flag MANBAVARAN without the
        # extension (the reference's method-ignoring parity bytes)
        if tile_events_mode(events):
            tile_blocks = encode_tiles_blocks_tile_events(
                image, s, events, events_user
            )
        else:
            tile_blocks = encode_tiles_blocks(image, s, events, events_user)
        return head + b"".join(tile_blocks)

    streams = encode_tiles_device(image, s, events, events_user)

    blocks: list[bytes] = [head]
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    total = len(grid)
    for t, values in zip(grid, streams):
        if s.wavelet != Wavelet.NONE:
            tds = geometry.tile_data_size(t.w, t.h) * channels
        else:
            tds = t.w * t.h * channels * 2
        _fire(events, t.index, total, Event.COMPRESSION_START, events_user)
        if s.compression != Compression.NONE:
            block = compress_block(values, tds, s.compression)
            if block is None:
                raise AkoError(Status.ERROR, "incompressible tile")
            blocks.append(block)
        else:
            blocks.append(values.tobytes())
        _fire(events, t.index, total, Event.COMPRESSION_END, events_user)

    return b"".join(blocks)
