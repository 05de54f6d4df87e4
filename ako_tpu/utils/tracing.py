"""Profiler tracing, env-gated.

The reference exposes per-stage wall-clock through the event callbacks
(library/ako.h:75-84; tools/benchmark.hpp) — mirrored by
`core/events.py`. The equivalent for *device* visibility is
a jax profiler trace (SURVEY.md §5): set `AKO_TPU_TRACE_DIR=/some/dir`
and every top-level `ako_tpu.encode` / `ako_tpu.decode` call writes a
TensorBoard-loadable trace (XLA ops, transfers, host activity) there.

Kept off the hot path: without the env var the wrapper adds one dict
lookup. Traces do not nest — nested calls inside an active trace run
untraced.
"""

from __future__ import annotations

import functools
import os
import threading

_ENV = "AKO_TPU_TRACE_DIR"
# jax allows one profiler session per PROCESS, so the guard is a
# process-wide try-lock: concurrent/nested calls run untraced instead
# of crashing the second trace
_trace_lock = threading.Lock()


def traced(fn):
    """Wrap a top-level codec entry point in a jax profiler trace when
    AKO_TPU_TRACE_DIR is set."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        trace_dir = os.environ.get(_ENV)
        if not trace_dir or not _trace_lock.acquire(blocking=False):
            return fn(*args, **kwargs)
        import jax

        try:
            with jax.profiler.trace(trace_dir):
                return fn(*args, **kwargs)
        finally:
            _trace_lock.release()

    return wrapper
