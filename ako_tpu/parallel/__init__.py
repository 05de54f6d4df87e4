"""Multi-chip parallelism for the codec pipeline.

The reference is strictly single-threaded (reference library/encode.c:115
sequential tile loop); these modules are the multi-device scaling
design it has no counterpart for (SURVEY.md §2.4):

- `tiles`: tile-data-parallelism — the independent-tile grid batched
  and sharded over a device mesh (the codec's DP axis).
- `halo`: sharded-single-tile lifting — one huge tile's rows sharded
  over the mesh, lift stencils exchanging boundary rows via ppermute
  between devices (the codec's SP/context-parallel axis).
"""

from ako_tpu.parallel.mesh import make_mesh
from ako_tpu.parallel.halo import forward_tile_sharded, inverse_tile_sharded

__all__ = ["make_mesh", "forward_tile_sharded", "inverse_tile_sharded"]
