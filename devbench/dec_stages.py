"""Decode stage profile on the GPU: sync scan, upload, device compute,
pixel fetch (device waits end in block_until_ready)."""
import os, sys, time
import numpy as np
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from bench import synth_images, TILES
import ako_tpu
from ako_tpu.runtime.device import enable_compile_cache

enable_compile_cache()
from ako_tpu.core import container, geometry
from ako_tpu.decode import dispatch_tiles_device_entropy, pixels_ready, place_pixels
import concurrent.futures as cf

rng = np.random.default_rng(42)
img = synth_images(rng, 1)[0]
settings = ako_tpu.Settings(quantization=16, tiles_dimension=TILES)
blob = ako_tpu.encode(img, settings)
print("blob MB:", len(blob)/1e6)

view = memoryview(blob)
channels, w, h, s = container.head_read(view)
grid = geometry.tile_grid(w, h, s.tiles_dimension)

pool = cf.ThreadPoolExecutor(max_workers=4)

# warm (compile)
disp = dispatch_tiles_device_entropy(view, container.HEAD_SIZE, grid, s, channels, pool)
image = np.empty((h, w, channels), np.uint8)
for tiles, th, tw, px in disp:
    place_pixels(image, tiles, th, tw, px)

import ako_tpu.runtime.kagari as rk
from ako_tpu.ops.kagari_device import DECODE_BLOCK

def sync_only():
    t0 = time.perf_counter()
    cursor = container.HEAD_SIZE
    for t in grid:
        tds = geometry.tile_data_size(t.w, t.h) * channels
        bs = int.from_bytes(view[cursor:cursor+4], "little")
        payload = view[cursor+4:cursor+4+bs]
        r = rk.kagari_sync(tds // 2, payload, tds + geometry.planes_spacing(t.w, t.h), DECODE_BLOCK)
        assert r is not None
        cursor += 4 + bs
    return time.perf_counter() - t0

print(f"host sync scan (serial): {sync_only()*1e3:.0f} ms")

for r in range(3):
    t0 = time.perf_counter()
    disp = dispatch_tiles_device_entropy(view, container.HEAD_SIZE, grid, s, channels, pool)
    t_disp = time.perf_counter() - t0
    t0 = time.perf_counter()
    for tiles, th, tw, px in disp:
        pixels_ready(px)  # device wait (band outputs ready)
    t_wait = time.perf_counter() - t0
    t0 = time.perf_counter()
    image = np.empty((h, w, channels), np.uint8)
    for tiles, th, tw, px in disp:
        place_pixels(image, tiles, th, tw, px)
    t_fetch = time.perf_counter() - t0
    print(f"run {r}: dispatch(sync+upload) {t_disp*1e3:.0f} ms, device wait {t_wait*1e3:.0f} ms, pixel fetch {t_fetch*1e3:.0f} ms")
