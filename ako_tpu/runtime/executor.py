"""Streaming batch pipeline: overlap device compute with host entropy
coding across a stream of images.

The reference processes one image per process invocation, strictly
sequentially (library/encode.c:115). Here, encode of image i+1's tiles
runs on the device while image i's Kagari blocks are being written on the
host: JAX dispatch is asynchronous, so the device program is enqueued
and the host thread pool (ctypes releases the GIL during the native
coder calls) drains the previous image's streams concurrently. Within
one image, per-tile entropy blocks are independent and coded in
parallel; container order is restored on collection (the bitstream
gather of SURVEY.md §2.4.3).
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from collections import deque
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ako_tpu.core import container, geometry
from ako_tpu.core.settings import (
    AkoError,
    Compression,
    Settings,
    Status,
    Wavelet,
)
from ako_tpu.encode import (
    checked_settings,
    collect_tiles_blocks,
    dispatch_tiles_fused,
    encode_tiles_device,
)
from ako_tpu.runtime.device import resolve_device_entropy
from ako_tpu.runtime.kagari import compress_block


def _entropy_encode_image(
    streams: List[np.ndarray],
    grid,
    channels: int,
    s: Settings,
    head: bytes,
    pool: Optional[cf.ThreadPoolExecutor],
) -> bytes:
    def one(t, values):
        if s.wavelet != Wavelet.NONE:
            tds = geometry.tile_data_size(t.w, t.h) * channels
        else:
            tds = t.w * t.h * channels * 2
        if s.compression != Compression.NONE:
            block = compress_block(values, tds, s.compression)
            if block is None:
                raise AkoError(Status.ERROR, "incompressible tile")
            return block
        return values.tobytes()

    if pool is None or len(grid) < 2:
        blocks = [one(t, v) for t, v in zip(grid, streams)]
    else:
        blocks = list(pool.map(one, grid, streams))
    return head + b"".join(blocks)


class PipelineEncoder:
    """Encode a stream of images with device/host overlap.

    >>> enc = PipelineEncoder(settings, workers=4)
    >>> for blob in enc.encode_iter(images):
    ...     sink(blob)
    """

    def __init__(
        self,
        settings: Optional[Settings] = None,
        workers: int = 4,
        device_entropy: Optional[bool] = None,
    ):
        self.settings = checked_settings(settings)
        self.workers = max(1, workers)
        self.device_entropy = device_entropy

    def _device_entropy(self) -> bool:
        return resolve_device_entropy(self.device_entropy)

    def encode_iter(
        self, images: Iterable[np.ndarray], keep_residue: bool = False
    ) -> Iterator[bytes]:
        """With `keep_residue`, yields (blob, residue) pairs instead:
        residue is the device-resident compressed-row record a PAIRED
        decode of that same blob can reuse as its word pool
        (decode.dispatch_tiles_device_entropy), or None off the fused
        path. Used by roundtrip_iter."""
        s = self.settings
        from ako_tpu.encode import host_encode_mode

        if host_encode_mode():
            yield from self._encode_iter_host(images, keep_residue)
            return
        if s.compression == Compression.KAGARI and self._device_entropy():
            yield from self._encode_iter_device_entropy(images, keep_residue)
            return
        if keep_residue:
            yield from ((b, None) for b in self.encode_iter(images))
            return
        with cf.ThreadPoolExecutor(max_workers=self.workers) as pool:
            pending: Optional[Tuple[list, list, int, bytes]] = None
            for image in images:
                image = np.asarray(image)
                if image.ndim == 2:
                    image = image[:, :, None]
                h, w, channels = image.shape
                head = container.head_write(channels, w, h, s)
                grid = geometry.tile_grid(w, h, s.tiles_dimension)
                # Device stage for this image (async dispatch under the
                # hood); host stage for the previous image runs below
                # while the device works.
                streams = encode_tiles_device(image, s)
                if pending is not None:
                    yield _entropy_encode_image(*pending, pool)
                pending = (streams, grid, channels, s, head)
            if pending is not None:
                yield _entropy_encode_image(*pending, pool)

    def _encode_iter_host(
        self, images: Iterable[np.ndarray], keep_residue: bool = False
    ) -> Iterator[bytes]:
        """Host-native encode (AKO_TPU_ENCODE=host): Kagari-effective
        blobs encode via BATCHED native span calls — each worker task
        is ONE Python<->C crossing covering ~1/(2*workers) of the
        image's tiles (akort_tile_encode_spans gathers rects, lifts,
        entropy-codes and frames the blocks itself), so per-tile Python
        glue (slicing, qg lookup, struct packing — all GIL-bound)
        disappears from the parallel section. Up to AKO_ENC_INFLIGHT
        images stay in flight so the pool never drains at image
        boundaries. No device traffic; blobs byte-identical to
        the device paths'. Non-Kagari compressions keep the per-tile
        path (rare, and MANBAVARAN needs its own assembler)."""
        import os

        from ako_tpu.encode import _host_span_plan, encode_tile_block_host
        from ako_tpu.runtime import hostcodec
        from ako_tpu.runtime.kagari import BLOCK_HEAD, effective_method

        s = self.settings
        spans_ok = effective_method(s.compression) == Compression.KAGARI
        depth = max(1, int(os.environ.get("AKO_ENC_INFLIGHT", "3")))
        with cf.ThreadPoolExecutor(max_workers=self.workers) as pool:
            pending: deque = deque()

            def encode_span(image, span, channels):
                return [
                    encode_tile_block_host(image, t, s, channels)
                    for t in span
                ]

            def drain():
                head, futs, spanned = pending.popleft()
                if not spanned:
                    blob = head + b"".join(
                        blk for f in futs for blk in f.result()
                    )
                    return (blob, None) if keep_residue else blob
                out, out_off, sizes = spanned
                for f in futs:
                    f.result()
                if not sizes.all():
                    raise AkoError(Status.ERROR, "incompressible tile")
                mv = memoryview(out)
                hs = BLOCK_HEAD.size
                blob = head + b"".join(
                    mv[o : o + hs + sz]
                    for o, sz in zip(out_off.tolist(), sizes.tolist())
                )
                return (blob, None) if keep_residue else blob

            for image in images:
                # dtype coercion matches the per-tile path's
                # ascontiguousarray(tile, dtype=uint8): the C side
                # reads raw u8 through the image pointer
                image = np.ascontiguousarray(np.asarray(image), dtype=np.uint8)
                if image.ndim == 2:
                    image = image[:, :, None]
                h, w, channels = image.shape
                head = container.head_write(channels, w, h, s)
                grid = geometry.tile_grid(w, h, s.tiles_dimension)
                # ~2 tasks per worker per image: coarse enough that
                # submit/result overhead is negligible, fine enough to
                # load-balance edge-tile size variance across the pool
                k = max(1, -(-len(grid) // (2 * self.workers)))
                if spans_ok:
                    plan = _host_span_plan(
                        w, h, channels, s.tiles_dimension, s.wavelet,
                        s.quantization, s.gate, s.chroma_loss,
                    )
                    out = np.empty(plan.total_bytes, np.uint8)
                    sizes = np.zeros(len(grid), np.int64)
                    futs = [
                        pool.submit(
                            hostcodec.tile_encode_spans,
                            image,
                            plan.rects[i : i + k],
                            plan.qg_off[i : i + k],
                            plan.qs,
                            plan.gs,
                            plan.counts[i : i + k],
                            plan.caps[i : i + k],
                            out,
                            plan.out_off[i : i + k],
                            sizes[i : i + k],
                            s.wavelet,
                            s.wrap,
                            s.color,
                            bool(s.discard_non_visible),
                        )
                        for i in range(0, len(grid), k)
                    ]
                    pending.append((head, futs, (out, plan.out_off, sizes)))
                else:
                    pending.append(
                        (
                            head,
                            [
                                pool.submit(
                                    encode_span, image, grid[i : i + k], channels
                                )
                                for i in range(0, len(grid), k)
                            ],
                            None,
                        )
                    )
                if len(pending) >= depth:
                    yield drain()
            while pending:
                yield drain()

    def _encode_iter_device_entropy(
        self, images: Iterable[np.ndarray], keep_residue: bool = False
    ) -> Iterator[bytes]:
        """Fused device path: compressed-byte fetches for up to
        AKO_ENC_INFLIGHT (default 5) images run on IO threads while the
        main thread uploads and dispatches the next — uploads,
        downloads, device compute and the collect fetches all overlap.
        The depth was sized for a high-latency host<->device link
        before the GPU port; re-deriving it from a GPU trace is ROADMAP
        A2.

        Same-geometry images can additionally COALESCE into groups of
        AKO_ENC_COALESCE: one pixel upload, one fused program pair, one
        totals fetch and one bucketed byte fetch per GROUP
        (encode.dispatch_images_fused), dividing the per-image transfer
        latency by the group size. Default 1 (per-image): grouping did
        not win before the GPU port, and it trades away pipeline
        granularity (ramp-in/tail are a whole group instead of an
        image). keep_residue pins the per-image shape (the
        paired-decode residue records are per-image)."""
        import os

        s = self.settings
        depth = max(1, int(os.environ.get("AKO_ENC_INFLIGHT", "5")))
        coalesce = max(1, int(os.environ.get("AKO_ENC_COALESCE", "1")))

        if keep_residue or coalesce == 1:
            yield from self._encode_iter_device_entropy_per_image(
                images, keep_residue, depth
            )
            return

        from ako_tpu.encode import (
            collect_images_blobs,
            dispatch_images_fused,
            image_fill_val,
        )

        with cf.ThreadPoolExecutor(max_workers=depth) as io:
            futs: deque = deque()
            buf: list = []
            sig = None

            def flush():
                nonlocal sig
                if not buf:
                    return
                metas, buf[:] = buf[:], []
                sig = None
                recs = dispatch_images_fused(metas, s)
                futs.append(io.submit(collect_images_blobs, metas, recs))

            for image in images:
                image = np.asarray(image)
                if image.ndim == 2:
                    image = image[:, :, None]
                h, w, channels = image.shape
                fv = image_fill_val(image)
                this_sig = (h, w, channels, fv)
                if sig is not None and this_sig != sig:
                    flush()
                sig = this_sig
                head = container.head_write(channels, w, h, s)
                grid = geometry.tile_grid(w, h, s.tiles_dimension)
                buf.append((image, head, grid, channels, fv))
                if len(buf) >= coalesce:
                    flush()
                while len(futs) >= depth:
                    yield from futs.popleft().result()
            flush()
            while futs:
                yield from futs.popleft().result()

    def _encode_iter_device_entropy_per_image(
        self, images: Iterable[np.ndarray], keep_residue: bool, depth: int
    ) -> Iterator[bytes]:
        s = self.settings

        def collect(args):
            p_head, p_s, p_ch, p_grid, p_disp = args
            residue: Optional[list] = [] if keep_residue else None
            blob = p_head + b"".join(
                collect_tiles_blocks(p_s, p_ch, p_grid, p_disp, residue)
            )
            return (blob, residue) if keep_residue else blob

        with cf.ThreadPoolExecutor(max_workers=depth) as io:
            futs: deque = deque()
            for image in images:
                image = np.asarray(image)
                if image.ndim == 2:
                    image = image[:, :, None]
                h, w, channels = image.shape
                head = container.head_write(channels, w, h, s)
                grid, channels, dispatched = dispatch_tiles_fused(image, s)
                futs.append(io.submit(collect, (head, s, channels, grid, dispatched)))
                if len(futs) >= depth:
                    yield futs.popleft().result()
            while futs:
                yield futs.popleft().result()

    def encode_batch(self, images: Iterable[np.ndarray]) -> List[bytes]:
        return list(self.encode_iter(images))


class PipelineDecoder:
    """Decode a stream of blobs with cross-image overlap: while image
    i's pixels drain over the link, image i+1's blocks are entropy
    decoded on the host pool (independent tiles, ctypes releases the
    GIL) and its device program is dispatched."""

    def __init__(self, workers: int = 4):
        self.workers = max(1, workers)

    def _entropy_stage(self, blob: bytes, pool):
        from ako_tpu.decode import _check_decode_budget, read_tile_stream, tile_block_sizes

        view = memoryview(blob)
        channels, w, h, s = container.head_read(view)
        _check_decode_budget(w, h, channels)
        grid = geometry.tile_grid(w, h, s.tiles_dimension)

        # Sequential scan to find block boundaries (sizes are in each
        # block head), then parallel entropy decode of the independent
        # blocks via the shared per-tile walk.
        offsets = []
        cursor = container.HEAD_SIZE
        for t in grid:
            tds, _spacing = tile_block_sizes(t, s, channels)
            if s.compression != Compression.NONE:
                if cursor + 4 > len(blob):
                    raise AkoError(Status.BROKEN_INPUT)
                bs = int.from_bytes(view[cursor : cursor + 4], "little")
                offsets.append((t, cursor))
                cursor += 4 + bs
            else:
                offsets.append((t, cursor))
                cursor += tds

        def one(args):
            t, off = args
            values, _ = read_tile_stream(view, off, t, s, channels)
            return values

        streams = list(pool.map(one, offsets))
        return streams, grid, channels, s, (h, w)

    def _dispatch_device(self, streams, grid, channels, s):
        from ako_tpu.decode import _run_tile_decoder

        by_shape: dict = {}
        for t in grid:
            by_shape.setdefault((t.w, t.h), []).append(t)
        dispatched = []
        for (tw, th), tiles in by_shape.items():
            batch = np.stack([streams[t.index] for t in tiles], axis=0)
            pixels_dev = _run_tile_decoder(batch, tw, th, channels, s)
            dispatched.append((tiles, th, tw, pixels_dev))
        return dispatched

    @staticmethod
    def _collect(dispatched, shape):
        from ako_tpu.decode import place_pixels

        h, w, channels = shape
        if isinstance(dispatched, tuple) and dispatched[0] == "hostspan":
            _, futs, image = dispatched
            for fut in futs:  # C wrote pixels in place; just propagate
                fut.result()  # any span's BROKEN_INPUT
            return image
        image = np.empty((h, w, channels), dtype=np.uint8)
        if isinstance(dispatched, tuple) and dispatched[0] == "host":
            for fut in dispatched[1]:
                for t, pix in fut.result():
                    image[t.y : t.y + t.h, t.x : t.x + t.w] = pix
            return image
        for tiles, th, tw, pixels_dev in dispatched:
            place_pixels(image, tiles, th, tw, pixels_dev)
        return image

    def _dispatch_blob(self, blob: bytes, pool, device_entropy: bool, residue=None):
        """One blob -> dispatch records + image shape, via the fused
        device-entropy decoder (sync scan only on host) when available,
        else the host entropy stage. `residue` is the paired encoder's
        device-resident compressed rows for THIS blob (roundtrip_iter):
        the decoder then uploads only sync tables, not the word pool.

        With AKO_TPU_DECODE=host the blob never touches the device:
        each tile's entropy decode + native unlift rides the worker
        pool as its own future (runtime/hostcodec.py), and _collect
        drains them on the IO thread — the decode stream moves no
        bytes to or from the device."""
        from ako_tpu.decode import (
            _check_decode_budget,
            _entropy_one,
            _read_tile_block,
            dispatch_tiles_device_entropy,
            host_decode_mode,
        )

        view = memoryview(blob)
        channels, w, h, s = container.head_read(view)
        _check_decode_budget(w, h, channels)
        if host_decode_mode():
            from ako_tpu.decode import _host_decode_plan
            from ako_tpu.runtime.hostcodec import (
                tile_decode_pixels,
                tile_decode_spans,
            )

            grid = geometry.tile_grid(w, h, s.tiles_dimension)
            # plain-Kagari blobs decode via BATCHED native span calls:
            # one Python<->C crossing per ~1/(2*workers) of the tiles,
            # pixels written by C straight into the shared image buffer
            # at each rect (disjoint regions). MANBAVARAN payloads need
            # the auto-detect walk, NONE the raw reinterpret — they
            # keep the per-tile path.
            if s.compression == Compression.KAGARI:
                plan = _host_decode_plan(w, h, channels, s.tiles_dimension, s.wavelet)
                n = len(grid)
                pay_off = np.empty(n, np.int64)
                pay_size = np.empty(n, np.int64)
                cursor = container.HEAD_SIZE
                for i, t in enumerate(grid):
                    payload, cursor = _read_tile_block(view, cursor, t, s, channels)
                    pay_size[i] = len(payload)
                    pay_off[i] = cursor - len(payload)
                blob_arr = np.frombuffer(blob, dtype=np.uint8)
                image = np.empty((h, w, channels), dtype=np.uint8)
                k = max(1, -(-n // (2 * self.workers)))

                def span_call(lo, hi):
                    rc = tile_decode_spans(
                        blob_arr,
                        pay_off[lo:hi],
                        pay_size[lo:hi],
                        plan.counts[lo:hi],
                        plan.caps[lo:hi],
                        plan.rects[lo:hi],
                        image,
                        s.wavelet,
                        s.wrap,
                        s.color,
                    )
                    if rc != 0:
                        raise AkoError(Status.BROKEN_INPUT)

                futs = [
                    pool.submit(span_call, lo, min(lo + k, n))
                    for lo in range(0, n, k)
                ]
                return ("hostspan", futs, image), (h, w, channels)

            cursor = container.HEAD_SIZE
            blocks = []
            for t in grid:
                payload, cursor = _read_tile_block(view, cursor, t, s, channels)
                blocks.append((t, payload))

            def one(args):
                t, payload = args
                values = _entropy_one(payload, t, s, channels)
                return t, tile_decode_pixels(
                    values, t.w, t.h, channels, s.wavelet, s.wrap, s.color
                )

            def span(items):  # submit overhead runs under the GIL:
                return [one(b) for b in items]  # a few tiles per task

            k = max(1, len(blocks) // (4 * self.workers))
            futs = [
                pool.submit(span, blocks[i : i + k])
                for i in range(0, len(blocks), k)
            ]
            return ("host", futs), (h, w, channels)
        if device_entropy and s.compression in (
            Compression.KAGARI,
            Compression.MANBAVARAN,
        ):
            grid = geometry.tile_grid(w, h, s.tiles_dimension)
            disp = dispatch_tiles_device_entropy(
                view, container.HEAD_SIZE, grid, s, channels, pool, residue
            )
            return disp, (h, w, channels)
        streams, grid, channels, s, (h, w) = self._entropy_stage(blob, pool)
        return self._dispatch_device(streams, grid, channels, s), (h, w, channels)

    def decode_iter(
        self, blobs: Iterable, paired: bool = False, device_entropy: Optional[bool] = None
    ) -> Iterator[np.ndarray]:
        """With `paired`, items are (blob, residue) pairs from
        PipelineEncoder.encode_iter(keep_residue=True)."""
        device_entropy = resolve_device_entropy(device_entropy)
        with cf.ThreadPoolExecutor(max_workers=self.workers) as pool, \
                cf.ThreadPoolExecutor(max_workers=1) as io:
            fut = None
            for item in blobs:
                blob, residue = item if paired else (item, None)
                disp, shape = self._dispatch_blob(blob, pool, device_entropy, residue)
                if fut is not None:
                    yield fut.result()
                # pixel drain of this image rides the IO thread while
                # the next blob's entropy decode + upload proceed
                fut = io.submit(self._collect, disp, shape)
            if fut is not None:
                yield fut.result()


_STREAM_DONE = object()


def roundtrip_iter(
    images: Iterable[np.ndarray],
    settings: Optional[Settings] = None,
    workers: int = 4,
    depth: int = 3,
    device_entropy: Optional[bool] = None,
) -> Iterator[Tuple[bytes, np.ndarray]]:
    """Full encode->decode round-trip as ONE overlapped stream,
    yielding (blob, decoded_pixels) per image in order.

    The encoder runs on its own thread feeding a bounded queue, so the
    encode stream's upload (raw pixels host->device) runs concurrently
    with the decode stream's download (pixels device->host) — the two
    heavy transfer directions of the codec are complementary. A
    `depth`-image buffer
    keeps the decoder fed across the encoder's per-image latency jitter
    without unbounded memory growth.
    """
    import os

    from ako_tpu.decode import host_decode_mode
    from ako_tpu.encode import host_encode_mode

    enc = PipelineEncoder(settings, workers=workers, device_entropy=device_entropy)
    dec = PipelineDecoder(workers=workers)
    # Paired residue reuse (default on, AKO_TPU_RESIDENT=0 to A/B):
    # the decode of blob i reads its word pool from the encoder's
    # still-device-resident compressed rows — ~2 MB/image less upload.
    # Pointless under host decode (the blob never goes back up) and
    # impossible under host encode (no device rows exist).
    keep_residue = (
        os.environ.get("AKO_TPU_RESIDENT", "1") != "0"
        and not host_decode_mode()
        and not host_encode_mode()
    )
    # the queue must absorb a full coalesced group's burst (the
    # device-entropy encoder yields AKO_ENC_COALESCE blobs at once;
    # a smaller bound blocks the producer mid-burst and stalls the
    # next group's dispatch behind the decoder)
    burst = max(1, int(os.environ.get("AKO_ENC_COALESCE", "1")))
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth, burst + 1))
    stop = threading.Event()

    def feed() -> Iterator[np.ndarray]:
        # stop-aware input wrapper: on early consumer exit the producer
        # finishes only the in-flight images, not the whole stream
        for image in images:
            if stop.is_set():
                return
            yield image

    def produce():
        try:
            for item in enc.encode_iter(feed(), keep_residue=keep_residue):
                q.put(item if keep_residue else (item, None))
                if stop.is_set():
                    return
            q.put(_STREAM_DONE)
        except BaseException as e:  # surface encoder failures in-order
            q.put(e)

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()

    # consumed-but-not-yet-yielded blobs only (the decoder's pipeline
    # holds at most a couple) — popped on yield so a long stream does
    # not accumulate every blob
    blobs: "deque[bytes]" = deque()

    def blob_stream() -> Iterator[tuple]:
        while True:
            item = q.get()
            if item is _STREAM_DONE:
                return
            if isinstance(item, BaseException):
                raise item
            blobs.append(item[0])
            yield item

    try:
        for pixels in dec.decode_iter(
            blob_stream(), paired=True, device_entropy=device_entropy
        ):
            yield blobs.popleft(), pixels
    finally:
        # if the consumer bailed early the producer may be blocked on a
        # full queue; signal stop and drain until it finishes
        stop.set()
        while producer.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                producer.join(timeout=0.1)
