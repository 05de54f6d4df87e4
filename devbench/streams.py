"""Per-stream timing: encode stream vs decode stream, multiple runs."""
import os, sys, time
import numpy as np
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from bench import synth_images, TILES, STREAM_N, MEGAPIXELS
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
outs = list(dec.decode_iter(blobs))

for r in range(4):
    t0 = time.perf_counter()
    blobs = enc.encode_batch(images)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = list(dec.decode_iter(blobs))
    t_dec = time.perf_counter() - t0
    print(f"run {r}: enc {t_enc/STREAM_N*1e3:.0f} ms/img, dec {t_dec/STREAM_N*1e3:.0f} ms/img, "
          f"e2e {STREAM_N*MEGAPIXELS/(t_enc+t_dec):.2f} MP/s")
