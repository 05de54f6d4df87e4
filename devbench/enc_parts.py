"""Encode leg timing on the GPU: staging, upload, device compute, byte
fetch."""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from bench import synth_images, TILES
import ako_tpu
from ako_tpu.encode import checked_settings, collect_tiles_blocks, dispatch_tiles_fused


rng = np.random.default_rng(42)
img = synth_images(rng, 1)[0]
s = checked_settings(ako_tpu.Settings(quantization=16, tiles_dimension=TILES))

grid, channels, disp = dispatch_tiles_fused(img, s)
_ = collect_tiles_blocks(s, channels, grid, disp)  # warm

for r in range(3):
    t0 = time.perf_counter()
    grid, channels, disp = dispatch_tiles_fused(img, s)
    t1 = time.perf_counter()
    for rec in disp:
        rec[3].result()  # totals future: upload + compute + totals fetch
    t2 = time.perf_counter()
    out = collect_tiles_blocks(s, channels, grid, disp)
    t3 = time.perf_counter()
    print(f"run {r}: dispatch(stage+enqueue) {1e3*(t1-t0):.0f} ms, "
          f"upload+compute+totals {1e3*(t2-t1):.0f} ms, byte fetch+frame {1e3*(t3-t2):.0f} ms")
