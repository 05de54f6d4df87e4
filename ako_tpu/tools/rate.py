"""Rate control: search quantization to hit a target compression ratio.

Same search semantics as the reference's EncodePass
(tools/akoenc.cpp:112-216): target = (w*h*ch)/ratio bytes with a 4%
error margin; one q=0 ceiling pass, exponential x4 descent to find a
floor, then bisection while the bracket is wider than the margin and
|floor_q - ceil_q| > 1; finally whichever endpoint lands closer.

Optimization the reference lacks (flagged in SURVEY.md §3.3): each
probe in the reference is a full re-encode. Here the wavelet pyramid is
computed once per color variant — quantization applies only to the
highpass write, so probes re-run just the (cheap, elementwise) fused
quantize/gate + entropy stage on the cached unquantized pyramid.
Probe sizes are therefore exact, and the chosen q produces a blob
byte-identical to a direct encode at that q."""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ako_tpu.core import container, geometry
from ako_tpu.core.settings import AkoError, Color, Compression, Settings, Status, Wavelet
from ako_tpu.encode import checked_settings, pack_budget
from ako_tpu.ops.colorspace import to_planar_yuv
from ako_tpu.ops.lifting import _quantize_gate
from ako_tpu.ops.quantization import level_qg
from ako_tpu.ops.wavelets import effective_wavelet, lift2d
from ako_tpu.runtime.kagari import compress_block


@functools.lru_cache(maxsize=32)
def _pyramid_fn(tile_w, tile_h, channels, wavelet, wrap, color, discard):
    """Jitted: u8 tiles -> (lp, [unquantized (c, b, d) per level])."""
    schedule = geometry.lift_schedule(tile_w, tile_h)

    def fn(tiles_u8):
        planes = to_planar_yuv(tiles_u8, color, discard)
        quads = []
        cur = planes
        for lvl in schedule.levels:
            weff = effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
            ll, b, c, d = lift2d(weff, wrap, cur, lvl)
            quads.append((c, b, d))
            cur = ll
        return cur, quads

    return jax.jit(fn)


def _serialize_raw(schedule, channels):
    """(lp, quads, q-array, g-array) -> serialized stream (traceable).
    q/g are runtime inputs so one compiled program serves every probe."""

    def fn(lp, quads, qs, gs):
        batch = lp.shape[:-3]
        chunks = []
        for i, lvl in enumerate(schedule.levels):
            c, b, d = quads[i]
            q = qs[i].reshape(channels, 1, 1).astype(jnp.int32)
            g = gs[i].reshape(channels, 1, 1).astype(jnp.int32)
            cq = _quantize_gate(c, q, g).reshape(batch + (channels, -1))
            bq = _quantize_gate(b, q, g).reshape(batch + (channels, -1))
            dq = _quantize_gate(d, q, g).reshape(batch + (channels, -1))
            head = jnp.broadcast_to(
                qs[i].astype(jnp.int16).reshape((1,) * len(batch) + (channels, 1)),
                batch + (channels, 1),
            )
            chunk = jnp.concatenate([head, cq, bq, dq], axis=-1)
            chunks.append(chunk.reshape(batch + (-1,)))
        lp_flat = lp.reshape(batch + (-1,))
        return jnp.concatenate([lp_flat] + chunks[::-1], axis=-1)

    return fn


@functools.lru_cache(maxsize=32)
def _serialize_fn(tile_w, tile_h, channels, n_levels):
    schedule = geometry.lift_schedule(tile_w, tile_h)
    return jax.jit(_serialize_raw(schedule, channels))


@functools.lru_cache(maxsize=32)
def _rate_pack_fn(n_values: int, capacity: int, budget: int):
    """Jitted vmapped device Kagari pack over (T, n_values) serialized
    streams (same coder as the production fused encoder)."""
    from ako_tpu.ops.kagari_device import kagari_encode_device

    return jax.jit(
        lambda streams: jax.vmap(
            lambda v: kagari_encode_device(v, capacity, budget)
        )(streams)
    )


@functools.lru_cache(maxsize=32)
def _probe_sizes_fn(tile_w, tile_h, channels, n_levels):
    """Jitted fused probe: (lp, quads, qs, gs) -> (T,) int32 exact
    compressed payload sizes. Serializes and tokenizes on device — the
    coefficient streams never leave the device (fetching them cost
    ~10 MB of int16 per probe just to measure sizes)."""
    from ako_tpu.ops.kagari_device import kagari_size_device

    schedule = geometry.lift_schedule(tile_w, tile_h)
    ser = _serialize_raw(schedule, channels)

    def fn(lp, quads, qs, gs):
        streams = ser(lp, quads, qs, gs)
        return jax.vmap(kagari_size_device)(streams)

    return jax.jit(fn)


class _CachedEncoder:
    """Encodes the same image at many quantization factors, computing
    the wavelet pyramid at most once per color variant."""

    def __init__(self, image: np.ndarray, base: Settings):
        self.image = image
        self.base = base
        self.h, self.w, self.channels = image.shape
        self._pyramids: Dict[Color, list] = {}

    def _settings_at(self, q: int) -> Settings:
        # The reference's EncodePass keeps the user's gate for EVERY
        # probe, including the q=0 ceiling pass (akoenc.cpp:139-143) —
        # only the ratio==1 path zeroes it. The gate also feeds the
        # YCoCg->YCoCg_Q auto-switch, so zeroing it here would change
        # both probe sizes and, at chosen q==0, the final blob.
        return checked_settings(self.base.replace(quantization=q))

    def _tile_pyramids(self, s: Settings):
        """Shape-grouped batched pyramids: one device program per
        distinct tile shape over all same-shaped tiles (round 1 ran
        per-tile batch=1 dispatches, serializing transfers)."""
        key = s.color
        if key in self._pyramids:
            return self._pyramids[key]
        grid = geometry.tile_grid(self.w, self.h, s.tiles_dimension)
        by_shape: Dict[tuple, list] = {}
        for t in grid:
            by_shape.setdefault((t.w, t.h), []).append(t)
        out = []
        for (tw, th), tiles in by_shape.items():
            fn = _pyramid_fn(
                tw, th, self.channels, s.wavelet, s.wrap, s.color,
                bool(s.discard_non_visible),
            )
            batch = np.stack(
                [self.image[t.y : t.y + th, t.x : t.x + tw, :] for t in tiles],
                axis=0,
            )
            lp, quads = fn(jnp.asarray(batch))
            out.append((tiles, lp, quads))
        self._pyramids[key] = out
        return out

    def encode_at(self, q: int) -> Optional[bytes]:
        """Full blob at quantization q (None if an incompressible tile
        fails, like the reference's error path). On a device backend
        the entropy stage rides the device Kagari packer with the same
        budget/fallback split and bucketed byte fetch as the production
        encoder (encode.collect_tiles_blocks); on CPU the host coder is
        used directly."""
        from ako_tpu.runtime.kagari import effective_method

        s = self._settings_at(q)
        head = container.head_write(self.channels, self.w, self.h, s)
        grid = geometry.tile_grid(self.w, self.h, s.tiles_dimension)
        # the device packer emits Kagari blocks; the real-rANS
        # extension (effective MANBAVARAN) must host-code
        from ako_tpu.runtime.device import device_entropy_default

        device_entropy = (
            device_entropy_default()
            and effective_method(s.compression) != Compression.MANBAVARAN
        )
        blocks: list = [None] * len(grid)
        dispatched = []
        for tiles, lp, quads in self._tile_pyramids(s):
            tw, th = tiles[0].w, tiles[0].h
            schedule = geometry.lift_schedule(tw, th)
            qg = level_qg(schedule, self.channels, s.quantization, s.gate, s.chroma_loss)
            qs = jnp.asarray([list(lv[0]) for lv in qg], dtype=jnp.int16)
            gs = jnp.asarray([list(lv[1]) for lv in qg], dtype=jnp.int16)
            ser = _serialize_fn(tw, th, self.channels, len(schedule.levels))
            streams_dev = ser(lp, quads, qs, gs)  # (T, n) on device
            tds = geometry.tile_data_size(tw, th) * self.channels
            if device_entropy:
                from ako_tpu.encode import _fetch_pool, _prepare_collect
                from ako_tpu.runtime.kagari import BLOCK_HEAD

                capacity = tds - BLOCK_HEAD.size
                budget = pack_budget(capacity, s.quantization)
                comp_bytes, totals_dev = _rate_pack_fn(
                    streams_dev.shape[-1], capacity, budget
                )(streams_dev)
                prep = _fetch_pool().submit(
                    _prepare_collect, totals_dev, comp_bytes, capacity, budget
                )
                dispatched.append(
                    (tiles, streams_dev, comp_bytes, prep, capacity, budget)
                )
                continue
            streams = np.asarray(streams_dev)
            for i, t in enumerate(tiles):
                block = compress_block(streams[i], tds, s.compression)
                if block is None:
                    return None
                blocks[t.index] = block
        if dispatched:
            from ako_tpu.encode import collect_tiles_blocks

            try:
                for t, block in zip(
                    grid, collect_tiles_blocks(s, self.channels, grid, dispatched)
                ):
                    if block is not None:
                        blocks[t.index] = block
            except AkoError:
                return None
        return head + b"".join(blocks)

    def size_at(self, q: int) -> int:
        """Exact blob size at quantization q WITHOUT materializing the
        blob: a fused device program serializes and tokenizes the
        cached pyramid and returns one int32 per tile (the round-2
        probe loop fetched the full ~10 MB coefficient streams per
        probe and host-coded them just to measure sizes). Tiles inside
        the host coder's near-capacity margin are re-coded on host so
        the reference's exact bounds checks decide success, mirroring
        encode.collect_tiles_blocks."""
        from ako_tpu.encode import _CAPACITY_MARGIN
        from ako_tpu.runtime.kagari import BLOCK_HEAD, effective_method

        s = self._settings_at(q)
        if effective_method(s.compression) == Compression.MANBAVARAN:
            # rANS payload sizes are not the device tokenizer's Kagari
            # sizes: size the real blob (still cached-pyramid cheap)
            blob = self.encode_at(q)
            if blob is None:
                raise AkoError(Status.ERROR, "incompressible tile")
            self._last = q
            return len(blob)
        total = container.HEAD_SIZE
        for tiles, lp, quads in self._tile_pyramids(s):
            tw, th = tiles[0].w, tiles[0].h
            schedule = geometry.lift_schedule(tw, th)
            qg = level_qg(schedule, self.channels, s.quantization, s.gate, s.chroma_loss)
            qs = jnp.asarray([list(lv[0]) for lv in qg], dtype=jnp.int16)
            gs = jnp.asarray([list(lv[1]) for lv in qg], dtype=jnp.int16)
            sizes = np.asarray(
                _probe_sizes_fn(tw, th, self.channels, len(schedule.levels))(
                    lp, quads, qs, gs
                )
            ).astype(np.int64)
            tds = geometry.tile_data_size(tw, th) * self.channels
            capacity = tds - BLOCK_HEAD.size
            risky = [
                i for i, n in enumerate(sizes) if int(n) >= capacity - _CAPACITY_MARGIN
            ]
            if risky:
                ser = _serialize_fn(tw, th, self.channels, len(schedule.levels))
                streams = np.asarray(
                    ser(lp, quads, qs, gs)[jnp.asarray(risky)]
                )
                for j, i in enumerate(risky):
                    block = compress_block(streams[j], tds, s.compression)
                    if block is None:
                        raise AkoError(Status.ERROR, "incompressible tile")
                    sizes[i] = len(block) - BLOCK_HEAD.size
            total += int(sizes.sum()) + BLOCK_HEAD.size * len(tiles)
        self._last = q
        return total


def encode_with_ratio(
    image: np.ndarray,
    settings: Settings,
    ratio: int,
    verbose: bool = False,
) -> Tuple[bytes, int]:
    """Returns (blob, chosen_quantization). Search identical to the
    reference's EncodePass; probes reuse the cached pyramid."""
    s = checked_settings(settings)
    if ratio == 0 or s.wavelet == Wavelet.NONE or s.compression == Compression.NONE:
        from ako_tpu.encode import encode

        return encode(image, s), s.quantization
    if ratio == 1:
        from ako_tpu.encode import encode

        s0 = s.replace(quantization=0, gate=0)
        return encode(image, s0), 0

    h, w, ch = image.shape
    target_size = (w * h * ch) // ratio
    error_margin = (target_size * 4) // 100
    if verbose:
        print(f"Target: {target_size / 1000:.2f} kB, error: {error_margin / 1000:.2f} kB...")

    enc = _CachedEncoder(image, settings)

    ceil_size = enc.size_at(0)
    q = 1
    floor_size, floor_q, ceil_q = ceil_size, 0, 0
    while True:
        q *= 4
        ceil_size, ceil_q = floor_size, floor_q
        floor_size, floor_q = enc.size_at(q), q
        if verbose:
            print(f" - Q: {ceil_q}|{floor_q}, {ceil_size/1000:.1f}|{floor_size/1000:.1f} kB")
        if floor_size <= target_size:
            break

    last_size = floor_size
    while (
        max(floor_size, ceil_size) - min(floor_size, ceil_size) > error_margin
        and abs(floor_q - ceil_q) > 1
    ):
        q = (ceil_q + floor_q) // 2
        last_size = enc.size_at(q)
        if last_size > target_size:
            ceil_size, ceil_q = last_size, q
        else:
            floor_size, floor_q = last_size, q
        if verbose:
            print(f" - Q: {ceil_q}|{floor_q}, {ceil_size/1000:.1f}|{floor_size/1000:.1f} kB")

    if (max(floor_size, target_size) - min(floor_size, target_size)) < (
        max(ceil_size, target_size) - min(ceil_size, target_size)
    ):
        chosen, chosen_size = floor_q, floor_size
    else:
        chosen, chosen_size = ceil_q, ceil_size
    if verbose:
        print(f" - Q: {chosen}")

    # Reference reuse quirk (akoenc.cpp:193-212): the LAST probe's blob
    # is emitted whenever its size numerically equals the chosen
    # endpoint's size — even on a size plateau where that probe ran at
    # a DIFFERENT q than `chosen`. Probes no longer materialize blobs,
    # so re-encode at the last probe's q — the codec is deterministic,
    # so the bytes equal the blob the reference would have reused.
    last_q = getattr(enc, "_last", None)
    emit_q = last_q if (last_q is not None and last_size == chosen_size) else chosen
    blob = enc.encode_at(emit_q)
    if blob is None:
        raise AkoError(Status.ERROR, "incompressible tile")
    return blob, chosen
