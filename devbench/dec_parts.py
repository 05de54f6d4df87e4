"""Decode leg timing: combined entropy upload, entropy program,
unlift program — each forced separately on resident inputs."""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp
from bench import synth_images, TILES
import ako_tpu
from ako_tpu.core import container, geometry
from ako_tpu.decode import (
    _bucket_span, _entropy_decode_fn, _pack_entropy_upload, _tile_decoder,
    pixels_ready, tile_block_sizes,
)
from ako_tpu.ops.kagari_device import DECODE_BLOCK, decode_span_words
from ako_tpu.runtime.kagari import BLOCK_HEAD, kagari_sync

rng = np.random.default_rng(42)
img = synth_images(rng, 1)[0]
s0 = ako_tpu.Settings(quantization=16, tiles_dimension=TILES)
blob = ako_tpu.encode(img, s0)
view = memoryview(blob)
channels, w, h, s = container.head_read(view)
grid = geometry.tile_grid(w, h, s.tiles_dimension)

items = []
cursor = container.HEAD_SIZE
for t in grid:
    tds, spacing = tile_block_sizes(t, s, channels)
    (bs,) = BLOCK_HEAD.unpack_from(view, cursor)
    payload = view[cursor + 4 : cursor + 4 + bs]
    sync = kagari_sync(tds // 2, payload, tds + spacing, DECODE_BLOCK)
    items.append((t, payload, sync))
    cursor += 4 + bs

count = tile_block_sizes(items[0][0], s, channels)[0] // 2
buf, pool_words, T, B = _pack_entropy_upload(items)
span = _bucket_span(max(decode_span_words(sy[0], len(p) * 8) for _, p, sy in items))
efn = _entropy_decode_fn(count, DECODE_BLOCK, pool_words, min(span, pool_words), T, B)
dfn = _tile_decoder(TILES, TILES, channels, s.wavelet, s.wrap, s.color)
print(f"combined upload {buf.nbytes/1e6:.2f} MB (pool {pool_words*4/1e6:.2f}), span {span}")

def force(x):
    jax.block_until_ready(x)

for r in range(3):
    t0 = time.perf_counter()
    buf_d = jnp.asarray(buf); force(buf_d)
    t1 = time.perf_counter()
    streams = efn(buf_d); force(streams)
    t2 = time.perf_counter()
    px = dfn(streams); pixels_ready(px)
    t3 = time.perf_counter()
    print(f"run {r}: upload {1e3*(t1-t0):.0f} ms, entropy {1e3*(t2-t1):.0f} ms, "
          f"unlift(single-leaf wait) {1e3*(t3-t2):.0f} ms")
