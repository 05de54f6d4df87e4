"""Isolated device-decode timing: Kagari vs Manbavaran block-parallel
decoders on the same 80-tile q0 pixel-pack workload (the transport
upload shape). Separates the entropy-decode program cost from
pack/upload. Each call ends in block_until_ready."""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
import numpy as np
from bench import synth_images
from ako_tpu.core import geometry
from ako_tpu.decode import (_bucket_span, _entropy_decode_fn,
                            _entropy_decode_fn_manba, _pack_entropy_upload,
                            _pack_manba_upload)
from ako_tpu.ops.kagari_device import DECODE_BLOCK, decode_span_words
from ako_tpu.ops.quantization import level_qg
from ako_tpu.runtime.hostcodec import tile_encode_stream
from ako_tpu.runtime.kagari import kagari_encode, kagari_sync, manba_encode, manba_sync
from ako_tpu.runtime.transfer import device_put_parallel
from ako_tpu.runtime.transport import _WAVELET, _WRAP, _COLOR
from ako_tpu.runtime.device import enable_compile_cache, require_gpu

enable_compile_cache()
require_gpu()

img = synth_images(np.random.default_rng(42), 1)[0]
tiles = np.stack([img[y:y+128, x:x+128, :3]
                  for y in range(0, 1280, 128) for x in range(0, 1024, 128)])
tds = geometry.tile_data_size(128, 128) * 3
spacing = geometry.planes_spacing(128, 128)
qg = level_qg(geometry.lift_schedule(128, 128), 3, 0, 0, 1)
streams = [tile_encode_stream(t, _WAVELET, _WRAP, _COLOR, qg) for t in tiles]

k_items = []
m_items = []
for v in streams:
    pk = kagari_encode(v, tds)
    k_items.append((None, pk, kagari_sync(tds//2, pk, tds+spacing, DECODE_BLOCK)))
    pm = manba_encode(v, tds)
    m_items.append((None, pm, ("manba", manba_sync(tds//2, pm, DECODE_BLOCK))))

bufk, pwk, Tk, Bk = _pack_entropy_upload(k_items)
spank = _bucket_span(max(decode_span_words(sy[0], len(p)*8) for _, p, sy in k_items))
efnk = _entropy_decode_fn(tds//2, DECODE_BLOCK, pwk, min(spank, pwk), Tk, Bk)
bufm, pwm, Tm, Bm, rs, es = _pack_manba_upload(m_items)
efnm = _entropy_decode_fn_manba(tds//2, DECODE_BLOCK, min(rs,pwm), min(es,pwm), pwm, Tm, Bm)

dk = jax.block_until_ready(device_put_parallel(bufk))
dm = jax.block_until_ready(device_put_parallel(bufm))
jax.block_until_ready((efnk(dk), efnm(dm)))  # warm

def med(fn, d):
    ts = []
    for _ in range(5):
        t0 = time.perf_counter(); jax.block_until_ready(fn(d)); ts.append(time.perf_counter()-t0)
    return sorted(ts)[2]

# interleave
tk = med(efnk, dk); tm = med(efnm, dm); tk2 = med(efnk, dk); tm2 = med(efnm, dm)
print(f"kagari device decode: {min(tk,tk2)*1e3:.1f} ms;  manba: {min(tm,tm2)*1e3:.1f} ms (80 tiles)")
# exactness
outk = np.asarray(efnk(dk)); outm = np.asarray(efnm(dm))
print("exact:", all(np.array_equal(outm[i], s) for i, s in enumerate(streams)))
