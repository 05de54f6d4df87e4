"""Stage profile of the roundtrip+hostdec pipeline (device encode,
host-native decode): times each stage of one image's encode
dispatch/collect plus the host decode, and the steady-state stream, to
locate the serialization point (upload, device compute wait, byte
fetch, framing, host decode)."""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["AKO_TPU_DECODE"] = "host"

import numpy as np
from bench import synth_images
import ako_tpu
from ako_tpu.runtime.device import enable_compile_cache

enable_compile_cache()
from ako_tpu.encode import dispatch_tiles_fused, collect_tiles_blocks, checked_settings
from ako_tpu.core import container
from ako_tpu.runtime.executor import roundtrip_iter

imgs = synth_images(np.random.default_rng(42), 6)
s = checked_settings(ako_tpu.Settings(quantization=16, tiles_dimension=128))

# warm
list(roundtrip_iter(imgs[:2], s, workers=4))

# per-stage, sequential (no overlap): upper bounds per stage
img = imgs[0]
for rep in range(3):
    t0 = time.perf_counter()
    grid, ch, disp = dispatch_tiles_fused(img, s)
    t_dispatch = time.perf_counter() - t0
    t0 = time.perf_counter()
    disp[0][3].result()
    t_totals = time.perf_counter() - t0
    t0 = time.perf_counter()
    head = container.head_write(ch, img.shape[1], img.shape[0], s)
    blob = head + b"".join(collect_tiles_blocks(s, ch, grid, disp))
    t_collect = time.perf_counter() - t0
    t0 = time.perf_counter()
    import concurrent.futures as cf
    from ako_tpu.decode import _entropy_one, _read_tile_block
    from ako_tpu.runtime.hostcodec import tile_decode_pixels
    view = memoryview(blob)
    chh, w, h, ss = container.head_read(view)
    from ako_tpu.core import geometry
    g2 = geometry.tile_grid(w, h, ss.tiles_dimension)
    cur = container.HEAD_SIZE
    blocks = []
    for t in g2:
        p, cur = _read_tile_block(view, cur, t, ss, chh)
        blocks.append((t, p))
    with cf.ThreadPoolExecutor(max_workers=4) as pool:
        def one(a):
            t, p = a
            v = _entropy_one(p, t, ss, chh)
            return tile_decode_pixels(v, t.w, t.h, chh, ss.wavelet, ss.wrap, ss.color)
        list(pool.map(one, blocks))
    t_hostdec = time.perf_counter() - t0
    print(f"rep{rep}: dispatch(upload+enqueue)={t_dispatch*1e3:.0f}ms totals_wait={t_totals*1e3:.0f}ms collect(bytes+frame)={t_collect*1e3:.0f}ms hostdec={t_hostdec*1e3:.0f}ms")

# steady-state stream
for rep in range(2):
    t0 = time.perf_counter()
    out = list(roundtrip_iter(imgs, s, workers=4))
    dt = time.perf_counter() - t0
    print(f"stream: {dt/len(imgs)*1e3:.0f} ms/img ({len(imgs)*img.shape[0]*img.shape[1]/1e6/dt:.2f} MP/s)")
