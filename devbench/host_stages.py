"""Per-stage timing of the HOST-native codec path (AKO_TPU_ENCODE=host,
AKO_TPU_DECODE=host; no device involved): native ms/tile per stage
(best-of-N of devbench/time_tile.c on a real bench tile) plus the
4-worker pipeline ms/image, written to chiprun_out/host_stages.json
with all raw samples (compare only within one run).

Usage: python devbench/host_stages.py
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["AKO_TPU_ENCODE"] = "host"
os.environ["AKO_TPU_DECODE"] = "host"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from bench import synth_images  # noqa: E402

REPS_NATIVE = 400
ROUNDS = 6
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def dump_tile():
    import ako_tpu
    from ako_tpu.core import geometry
    from ako_tpu.encode import _host_qg, checked_settings

    imgs = synth_images(np.random.default_rng(42), 1)
    img = imgs[0]
    s = checked_settings(ako_tpu.Settings(quantization=16, tiles_dimension=128))
    grid = geometry.tile_grid(img.shape[1], img.shape[0], s.tiles_dimension)
    t = grid[len(grid) // 2]
    tile = np.ascontiguousarray(img[t.y : t.y + t.h, t.x : t.x + t.w, :])
    qg = _host_qg(t.w, t.h, 4, s.quantization, s.gate, s.chroma_loss)
    np.ascontiguousarray(
        [q for lq, _ in qg for q in lq], dtype=np.int32
    ).tofile("/tmp/prof_qs.bin")
    np.ascontiguousarray(
        [g for _, lg in qg for g in lg], dtype=np.int32
    ).tofile("/tmp/prof_gs.bin")
    tile.tofile("/tmp/prof_tile.bin")


def native_stages():
    exe = "/tmp/host_stages_time_tile"
    subprocess.run(
        [
            os.environ.get("CC", "cc"), "-O3", "-march=native", "-o", exe,
            os.path.join(HERE, "time_tile.c"),
            os.path.join(ROOT, "ako_tpu", "runtime", "native", "akort.c"),
            "-lm",
        ],
        check=True,
    )
    samples: dict = {}
    for _ in range(ROUNDS):
        out = subprocess.run(
            [exe, str(REPS_NATIVE)], check=True, capture_output=True, text=True
        ).stdout
        for line in out.splitlines():
            parts = line.split()
            if len(parts) >= 3 and parts[2] == "ms/tile":
                samples.setdefault(parts[0], []).append(float(parts[1]))
    return {
        k: {"best_ms_per_tile": min(v), "samples": v} for k, v in samples.items()
    }


def pipeline():
    import ako_tpu
    from ako_tpu.runtime.executor import PipelineDecoder, PipelineEncoder

    imgs = synth_images(np.random.default_rng(42), 12)
    s = ako_tpu.Settings(quantization=16, tiles_dimension=128)
    enc = PipelineEncoder(s, workers=4)
    dec = PipelineDecoder(workers=4)
    blobs = enc.encode_batch(imgs)
    list(dec.decode_iter(blobs))
    rows = []
    for _ in range(5):
        t0 = time.perf_counter()
        b2 = enc.encode_batch(imgs)
        te = time.perf_counter() - t0
        t0 = time.perf_counter()
        list(dec.decode_iter(b2))
        td = time.perf_counter() - t0
        rows.append(
            {
                "enc_ms_img": round(te * 1000 / 12, 2),
                "dec_ms_img": round(td * 1000 / 12, 2),
            }
        )
    best = min(rows, key=lambda r: r["enc_ms_img"] + r["dec_ms_img"])
    total = best["enc_ms_img"] + best["dec_ms_img"]
    return {
        "runs": rows,
        "best_total_ms_img": round(total, 2),
        "mps_at_best": round(1.024 * 1.28 * 1000 / total, 1),
    }


def main():
    dump_tile()
    out = {
        "date": time.strftime("%Y-%m-%d"),
        "workload": "1024x1280 RGBA q16 t128 (bench corpus), 128x128x4 tile",
        "native_ms_per_tile": native_stages(),
        "pipeline_4workers": pipeline(),
    }
    path = os.path.join(ROOT, "chiprun_out", "host_stages.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["pipeline_4workers"], indent=1))
    print("wrote", path)


if __name__ == "__main__":
    main()
