"""Multi-host batch pipeline (DCN tier).

The scaling tiers of the multi-device design (SURVEY.md §2.4,
BASELINE configs[4]):

  device — tiles of one image batched over the device's SPMD program
  host   — tile grid sharded over the host's devices ("tiles" mesh
           axis, collectives for the bitstream gather)
  pod   — *images* sharded over hosts: each host encodes its images
          end-to-end (tiles stay host-local so no bitstream bytes
          cross DCN), only the finished blobs are exchanged

Images are fully independent, so host-level parallelism needs no
communication at all beyond work distribution — the efficient-by-
construction layout (the ≥0.9 scaling-efficiency target). This module
provides the SPMD-process plumbing: `initialize()` wraps
jax.distributed, `global_mesh()` builds the pod-wide mesh, and
`HostShardedPipeline` runs the per-host streaming encoder over this
process's shard of the image stream.

Single-process environments degrade gracefully (process_count == 1):
everything runs locally, which is how the test suite exercises the
code path.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import jax
import numpy as np

from ako_tpu.core.settings import Settings
from ako_tpu.runtime.executor import PipelineDecoder, PipelineEncoder


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """jax.distributed bring-up for a multi-host pod slice. No-op when
    the arguments are absent and no cluster environment is detected."""
    if coordinator_address is None and num_processes is None:
        return  # single host
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def process_info() -> Tuple[int, int]:
    """(process_index, process_count)."""
    return jax.process_index(), jax.process_count()


def global_mesh(axis_names: Sequence[str] = ("hosts", "tiles")):
    """Pod-wide mesh: leading axis over hosts (DCN), trailing axis over
    each host's local devices."""
    n_proc = jax.process_count()
    devs = np.asarray(jax.devices()).reshape(n_proc, -1)
    from jax.sharding import Mesh

    return Mesh(devs, axis_names=tuple(axis_names))


def shard_stream(items: List, process_id: int, process_count: int) -> List:
    """Round-robin assignment of a work list to this process."""
    return items[process_id::process_count]


class HostShardedPipeline:
    """Encode/decode a globally-indexed image stream across hosts:
    every host runs the streaming pipeline on its round-robin shard;
    results carry their global index so the caller can re-order (or
    write to per-index destinations, avoiding any gather)."""

    def __init__(self, settings: Optional[Settings] = None, workers: int = 4):
        self.settings = settings
        self.workers = workers

    def encode_shard(
        self, images: List[np.ndarray]
    ) -> Iterator[Tuple[int, bytes]]:
        pid, pcount = process_info()
        mine = [(i, img) for i, img in enumerate(images)][pid::pcount]
        enc = PipelineEncoder(self.settings, workers=self.workers)
        for (gidx, _), blob in zip(mine, enc.encode_iter(img for _, img in mine)):
            yield gidx, blob

    def decode_shard(self, blobs: List[bytes]) -> Iterator[Tuple[int, np.ndarray]]:
        pid, pcount = process_info()
        mine = [(i, b) for i, b in enumerate(blobs)][pid::pcount]
        dec = PipelineDecoder(workers=self.workers)
        for (gidx, _), img in zip(mine, dec.decode_iter(b for _, b in mine)):
            yield gidx, img
