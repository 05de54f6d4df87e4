"""Chunked-parallel host<->device transfers.

The chunk counts were tuned for a high-latency host<->device link
before the GPU port; both sides are env-tunable (AKO_XFER_UP_CHUNKS /
AKO_XFER_DOWN_CHUNKS). Whether chunking wins anything over PCIe is
ROADMAP C1. Downloads go via per-chunk fetches of leading-axis slices;
chunked uploads via jax.device_put per chunk then a device-side
concatenate (cheap).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import threading
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

#: transfers below this size aren't worth the thread fan-out
_MIN_PARALLEL_BYTES = 1 << 20


def _up_chunks() -> int:
    """Read per call, not at import, so a caller can re-tune the
    env vars at runtime."""
    return int(os.environ.get("AKO_XFER_UP_CHUNKS", "1"))


def _down_chunks() -> int:
    return int(os.environ.get("AKO_XFER_DOWN_CHUNKS", "8"))


#: import-time snapshot for band_split only: the band count is baked
#: into compiled programs (a tuple of outputs), so it cannot follow
#: runtime re-tuning without recompiles
_DOWN_CHUNKS = _down_chunks()

_pool: Optional[cf.ThreadPoolExecutor] = None
_io_pool: Optional[cf.ThreadPoolExecutor] = None
_pool_lock = threading.Lock()


def _get_pool() -> cf.ThreadPoolExecutor:
    """The process-wide CHUNK pool. Invariant: only LEAF work is
    submitted here (single jax.device_put / np.asarray / native scan
    calls that never wait on other futures). Tasks that themselves call
    device_put_parallel/device_get_parallel/fetch_bands must run on
    io_pool() instead — a task waiting on this pool while occupying one
    of its workers deadlocks once the pool saturates."""
    global _pool
    if _pool is None:
        with _pool_lock:
            if _pool is None:
                _pool = cf.ThreadPoolExecutor(
                    max_workers=max(_up_chunks(), _down_chunks(), 16),
                    thread_name_prefix="ako-xfer",
                )
    return _pool


def io_pool() -> cf.ThreadPoolExecutor:
    """The process-wide TASK pool for work that may itself block on
    chunked transfers (collect-time group fetches, dispatch-time
    prepare tasks). Separate from the chunk pool so nested
    submit-and-wait cannot starve the leaf transfers."""
    global _io_pool
    if _io_pool is None:
        with _pool_lock:
            if _io_pool is None:
                _io_pool = cf.ThreadPoolExecutor(
                    max_workers=8, thread_name_prefix="ako-io"
                )
    return _io_pool


def device_put_parallel(arr: np.ndarray, chunks: Optional[int] = None):
    """Upload a host array, chunked along axis 0 across threads;
    returns a single device array."""
    if chunks is None:
        chunks = _up_chunks()
    arr = np.ascontiguousarray(arr)
    if chunks <= 1 or arr.nbytes < _MIN_PARALLEL_BYTES or arr.shape[0] < chunks:
        return jnp.asarray(arr)
    parts = np.array_split(arr, chunks, axis=0)
    futs = [_get_pool().submit(jax.device_put, p) for p in parts]
    return jnp.concatenate([f.result() for f in futs], axis=0)


def device_get_parallel(dev, chunks: Optional[int] = None) -> np.ndarray:
    """Fetch a device array, chunked along axis 0 across threads."""
    if chunks is None:
        chunks = _down_chunks()
    shape = dev.shape
    nbytes = dev.dtype.itemsize * int(np.prod(shape))
    if nbytes < _MIN_PARALLEL_BYTES or (shape and shape[0] < chunks):
        return np.asarray(dev)
    bounds = np.array_split(np.arange(shape[0]), chunks)
    slices = [slice(int(b[0]), int(b[-1]) + 1) for b in bounds if len(b)]
    futs = [_get_pool().submit(lambda s=s: np.asarray(dev[s])) for s in slices]
    return np.concatenate([f.result() for f in futs], axis=0)


def band_split(x, bands: int = _DOWN_CHUNKS):
    """Trace-time leading-axis split (call INSIDE a jitted program).

    Returning a tuple of row-band outputs instead of one array means
    collect-time fetches are plain buffer DMAs: a `dev[s]` slice at
    fetch time is a device program that enqueues BEHIND the next
    image's already-dispatched compute, serializing the pipeline (the
    device stream is FIFO); distinct program outputs have no such
    dependency. Small outputs stay whole."""
    n = int(x.shape[0])
    nbytes = x.dtype.itemsize * int(np.prod(x.shape))
    if bands <= 1 or n < bands or nbytes < _MIN_PARALLEL_BYTES:
        return (x,)
    edges = np.linspace(0, n, bands + 1).astype(int)
    return tuple(x[int(a) : int(b)] for a, b in zip(edges[:-1], edges[1:]))


def fetch_bands(bands) -> np.ndarray:
    """Fetch a band_split tuple (or a single array) back to host,
    bands in parallel across the transfer pool."""
    if not isinstance(bands, (tuple, list)):
        return device_get_parallel(bands)
    if len(bands) == 1:
        return np.asarray(bands[0])
    futs = [_get_pool().submit(np.asarray, b) for b in bands]
    return np.concatenate([f.result() for f in futs], axis=0)


def bands_ready(bands) -> None:
    """block_until_ready across a band tuple or single array."""
    if isinstance(bands, (tuple, list)):
        for b in bands:
            b.block_until_ready()
    else:
        bands.block_until_ready()
