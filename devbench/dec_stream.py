"""Decode-stream-only timing, many runs, for pool-vs-bucket A/B."""
import os, sys, time
import numpy as np
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from bench import synth_images, TILES, STREAM_N
import ako_tpu
from ako_tpu.runtime.device import enable_compile_cache

enable_compile_cache()
from ako_tpu.runtime.executor import PipelineDecoder, PipelineEncoder

rng = np.random.default_rng(42)
images = synth_images(rng, STREAM_N)
settings = ako_tpu.Settings(quantization=16, tiles_dimension=TILES)
enc = PipelineEncoder(settings, workers=4)
dec = PipelineDecoder(workers=4)
blobs = enc.encode_batch(images)
outs = list(dec.decode_iter(blobs))  # warm/compile

ts = []
for r in range(6):
    t0 = time.perf_counter()
    outs = list(dec.decode_iter(blobs))
    t = time.perf_counter() - t0
    ts.append(t / STREAM_N * 1e3)
    print(f"run {r}: dec {ts[-1]:.0f} ms/img")
print(f"median dec: {sorted(ts)[len(ts)//2]:.0f} ms/img")
