"""Per-stage device-compute profile of the fused encode path on the
GPU: forward (format+lift) vs entropy pack, on the north-star 80-tile
batch. Each program call ends in block_until_ready; the median of REPS
host-clock samples is reported.

Sweeps AKO_PACK_CHUNK (the place-packer chunk width) in subprocesses —
the constant is baked at import — and writes
chiprun_out/device_stages.json.

Usage: python devbench/device_stages.py          # sweep + record
       python devbench/device_stages.py --one    # this env only
"""
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "chiprun_out", "device_stages.json")

REPS = 7


def measure_one() -> dict:
    import jax
    import numpy as np

    from bench import synth_images, TILES
    import ako_tpu
    from ako_tpu.encode import _tile_encoder_fused, checked_settings
    from ako_tpu.core import geometry
    from ako_tpu.runtime.device import enable_compile_cache, require_gpu

    enable_compile_cache()
    require_gpu()
    rng = np.random.default_rng(42)
    img = synth_images(rng, 1)[0]
    s = checked_settings(ako_tpu.Settings(quantization=16, tiles_dimension=TILES))
    h, w, channels = img.shape
    grid = geometry.tile_grid(w, h, s.tiles_dimension)
    tiles = [t for t in grid if (t.w, t.h) == (TILES, TILES)]
    batch = np.stack(
        [img[t.y : t.y + TILES, t.x : t.x + TILES, :] for t in tiles]
    )
    fwd, pack, capacity, budget = _tile_encoder_fused(
        TILES, TILES, channels, s.wavelet, s.wrap, s.color,
        bool(s.discard_non_visible), s.quantization, s.gate, s.chroma_loss,
        None,
    )
    tiles_dev = jax.block_until_ready(jax.device_put(batch))
    stream = jax.block_until_ready(fwd(tiles_dev))
    jax.block_until_ready(pack(stream))  # warm both compiles

    def timed(fn):
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        return 1e3 * statistics.median(ts)

    return {
        "chunk": int(os.environ.get("AKO_PACK_CHUNK", "32")),
        "tiles": len(tiles),
        "budget_bytes": budget,
        "fwd_ms": timed(lambda: fwd(tiles_dev)),
        "pack_ms": timed(lambda: pack(stream)),
        "fwd_plus_pack_ms": timed(lambda: pack(fwd(tiles_dev))),
    }


def main() -> int:
    if "--one" in sys.argv:
        print(json.dumps(measure_one()))
        return 0
    results = []
    for chunk in ("32", "64", "128"):
        env = dict(os.environ, AKO_PACK_CHUNK=chunk)
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one"],
            env=env, capture_output=True, text=True, cwd=REPO, timeout=1200,
        )
        if r.returncode != 0:
            print(r.stderr[-2000:], file=sys.stderr)
            return 1
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        print(f"chunk {chunk}: {rec}")
        results.append(rec)
    best = min(results, key=lambda r: r["pack_ms"])
    record = {
        "metric": "device encode stages, ms per 80-tile 1024x1280 image (median of %d, block_until_ready)" % REPS,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "sweep": results,
        "best_chunk": best["chunk"],
    }
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    main()
