"""Sweep AKO_DECODE_BLOCK (outputs per device decode block) on the GPU:
the block size trades parallelism against sync-record overhead. Each
size runs in a subprocess (the constant is baked at import) through
bench.measure_device_compute (block_until_ready timings).

Usage: python devbench/dec_block_sweep.py [sizes...]
"""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)


def measure_one() -> dict:
    import numpy as np

    from bench import TILES, measure_device_compute, synth_images
    import ako_tpu
    from ako_tpu.runtime.device import enable_compile_cache

    enable_compile_cache()
    rng = np.random.default_rng(42)
    img = synth_images(rng, 1)[0]
    settings = ako_tpu.Settings(quantization=16, tiles_dimension=TILES)
    rec = measure_device_compute(img, settings, reps=7)
    rec["decode_block"] = int(os.environ.get("AKO_DECODE_BLOCK", "128"))
    return rec


def main() -> int:
    if "--one" in sys.argv:
        print(json.dumps(measure_one()))
        return 0
    sizes = [a for a in sys.argv[1:] if a.isdigit()] or ["64", "128", "256"]
    for size in sizes:
        env = dict(os.environ, AKO_DECODE_BLOCK=size)
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one"],
            env=env, capture_output=True, text=True, cwd=REPO, timeout=1800,
        )
        if r.returncode != 0:
            print(r.stderr[-2000:], file=sys.stderr)
            return 1
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        print(
            f"block {size}: dec_entropy={rec['dec_entropy_ms']}ms "
            f"dec_unlift={rec['dec_unlift_ms']}ms "
            f"enc_pack={rec['enc_pack_ms']}ms total={rec['total_device_ms']}ms "
            f"({rec['device_mps']} MP/s/chip)",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    main()
