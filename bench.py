"""Benchmark: steady-state encode+decode throughput on the north-star
workload (1024x1280 RGBA, q=16), bit-exact vs the reference, with the
reference C library on the same stream as the baseline.

The production regime is a pipelined stream of images (device
compute, host entropy and host<->device copies overlapping), so the
metric is aggregate megapixels/s over an N-image stream:
MP/s = N * W*H/1e6 / (t_encode_stream + t_decode_stream).

Requires a GPU (it fails otherwise) and the reference sources for the
baseline. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "MP/s", "vs_baseline": N,
   "device": {"platform", "kind", "count", "card"}, ...}
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

W, H, CH = 1024, 1280, 4
MEGAPIXELS = W * H / 1e6
# steady-state stream length (AKO_BENCH_N overrides)
STREAM_N = int(os.environ.get("AKO_BENCH_N", "12"))
# 128x128 tiles: one compiled program per tile shape, tiles batched,
# independent entropy blocks. The same settings go to the reference,
# so blobs stay byte-comparable.
TILES = 128


def synth_images(rng, n: int) -> list:
    """Photograph-like content (smooth structure + noise) so quantized
    coefficient statistics and Kagari run lengths are realistic; each
    image in the stream is a distinct crop/phase.

    BASELINE.md anchors on the reference README's cafe/tractor
    showcases; those PNGs are not present in the reference checkout
    and the environment has no network, so this synthesizes content at
    cafe's exact dimensions (1024x1280 RGBA) with matched compressed
    statistics (~5-6:1 at q=16 vs cafe's 12:1 at its showcase q).

    The DEFAULT corpus is the higher-fidelity procedural one
    (ako_tpu/utils/corpus.py: fractal value noise, piecewise regions,
    edges, correlated chroma — the closest wavelet statistics to real
    photographs this offline environment can produce; checksums pinned
    in tests/test_corpus.py). AKO_BENCH_CORPUS=sine restores the
    round-1..4 tuned sine+noise corpus for continuity; the JSON line
    records which corpus ran."""
    if os.environ.get("AKO_BENCH_CORPUS", "fbm") == "fbm":
        from ako_tpu.utils.corpus import corpus

        return corpus(42, n, H, W, CH)
    out = []
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    for k in range(n):
        p = 1.0 + 0.13 * k
        base = (
            110
            + 70 * np.sin(x / (97.0 * p))
            + 60 * np.cos(y / (61.0 / p))
            + 40 * np.sin((x + y) / 151.0)
        )
        img = np.zeros((H, W, CH), np.float32)
        img[..., 0] = base
        img[..., 1] = base * 0.8 + 30 * np.cos(x / 41.0 + k)
        img[..., 2] = base * 0.6 + 50 * np.sin(y / 83.0 - k)
        img[..., 3] = 255.0
        # photographic grain level: sigma 2.5 lands the q16 compressed
        # ratio near real photographs' (cafe's showcase statistics);
        # sigma 6 was closer to sensor noise than to a photo
        img += rng.normal(0, 2.5, size=img.shape).astype(np.float32)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def bench_ours(images, settings, warm=True):
    from ako_tpu.runtime.executor import PipelineDecoder, PipelineEncoder

    enc = PipelineEncoder(settings, workers=4)
    dec = PipelineDecoder(workers=4)

    if warm:  # compile + caches; skipped inside the timed-runs loop
        blobs = enc.encode_batch(images)
        list(dec.decode_iter(blobs))

    t0 = time.perf_counter()
    blobs = enc.encode_batch(images)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = list(dec.decode_iter(blobs))
    t_dec = time.perf_counter() - t0
    return t_enc + t_dec, blobs, outs


def bench_ours_roundtrip(images, settings, warm=True):
    """Same workload as bench_ours, but encode and decode run as ONE
    overlapped stream (runtime.executor.roundtrip_iter): the encode
    upload and decode download run in opposite directions at once, so
    the wall time can approach max(enc, dec) instead of their sum."""
    from ako_tpu.runtime.executor import roundtrip_iter

    if warm:  # compile + caches; skipped inside the timed-runs loop
        list(roundtrip_iter(images, settings, workers=4))
    t0 = time.perf_counter()
    pairs = list(roundtrip_iter(images, settings, workers=4))
    t = time.perf_counter() - t0
    return t, [b for b, _ in pairs], [p for _, p in pairs]


def bench_ref(images, settings, warm=True):
    from tests import oracle
    from ako_tpu.encode import checked_settings

    s = checked_settings(settings)
    if warm:
        [oracle.ref_encode(img, s) for img in images]
    t0 = time.perf_counter()
    blobs = [oracle.ref_encode(img, s) for img in images]
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = [oracle.ref_decode(b)[0] for b in blobs]
    t_dec = time.perf_counter() - t0
    return t_enc + t_dec, blobs, outs


def measure_device_compute(img: np.ndarray, settings, reps: int = 7) -> dict:
    """Per-program device time on one image's full-size tile batch, for
    BOTH directions:

      encode: fwd (format+lift, encode.c:131-144 analog) and pack
              (device Kagari, kagari.c:228 analog)
      decode: entropy (device gamma decode, kagari.c:301 analog) and
              unlift (inverse lift + color + interleave,
              decode.c:182-204 analog)

    Each program runs once to compile, then `reps` times on
    device-resident inputs, each call ending in block_until_ready; the
    median host-clock time is reported. Host-side staging (upload,
    sync scan) is excluded: it overlaps across images in the pipeline
    and is not device compute."""
    import statistics

    import jax

    from ako_tpu.core import container, geometry
    from ako_tpu.decode import (
        _bucket_span,
        _entropy_decode_fn,
        _pack_entropy_upload,
        _tile_decoder,
        tile_block_sizes,
    )
    from ako_tpu.encode import _tile_encoder_fused, checked_settings
    from ako_tpu.ops.kagari_device import DECODE_BLOCK, decode_span_words
    from ako_tpu.runtime.kagari import BLOCK_HEAD, kagari_sync
    import ako_tpu

    s = checked_settings(settings)
    h, w, channels = img.shape
    tsz = s.tiles_dimension
    grid = geometry.tile_grid(w, h, tsz)
    tiles = [t for t in grid if (t.w, t.h) == (tsz, tsz)]
    batch = np.stack([img[t.y : t.y + tsz, t.x : t.x + tsz, :] for t in tiles])

    fwd, pack, _cap, _budget = _tile_encoder_fused(
        tsz, tsz, channels, s.wavelet, s.wrap, s.color,
        bool(s.discard_non_visible), s.quantization, s.gate, s.chroma_loss,
        None,
    )
    tiles_dev = jax.block_until_ready(jax.device_put(batch))
    stream_dev = jax.block_until_ready(fwd(tiles_dev))

    # decode-side programs, driven from this image's real blob
    blob = ako_tpu.encode(img, s, device_entropy=True)
    view = memoryview(blob)
    _ch, _w, _h, s2 = container.head_read(view)
    cursor = container.HEAD_SIZE
    items = []
    for t in grid:
        tds, spacing = tile_block_sizes(t, s2, channels)
        (bs,) = BLOCK_HEAD.unpack_from(view, cursor)
        payload = view[cursor + BLOCK_HEAD.size : cursor + BLOCK_HEAD.size + bs]
        cursor += BLOCK_HEAD.size + bs
        if (t.w, t.h) == (tsz, tsz):
            sync = kagari_sync(tds // 2, payload, tds + spacing, DECODE_BLOCK)
            if sync is None or sync[5] > 31:
                continue  # quirk stream: host-decode tile, skip here
            items.append((t, payload, sync))
    count = tile_block_sizes(items[0][0], s2, channels)[0] // 2
    span = _bucket_span(
        max(decode_span_words(sy[0], len(p) * 8) for _, p, sy in items)
    )
    buf, pool_words, tcount, bcount = _pack_entropy_upload(items)
    efn = _entropy_decode_fn(
        count, DECODE_BLOCK, pool_words, min(span, pool_words), tcount, bcount
    )
    buf_dev = jax.block_until_ready(jax.device_put(buf))
    streams_dev = jax.block_until_ready(efn(buf_dev))
    dfn = _tile_decoder(tsz, tsz, channels, s.wavelet, s.wrap, s.color)

    def timed(fn, arg):
        jax.block_until_ready(fn(arg))  # compile + warm
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(arg))
            ts.append(time.perf_counter() - t0)
        return 1e3 * statistics.median(ts)

    stages = {
        "enc_fwd_ms": timed(fwd, tiles_dev),
        "enc_pack_ms": timed(pack, stream_dev),
        "dec_entropy_ms": timed(efn, buf_dev),
        "dec_unlift_ms": timed(dfn, streams_dev),
    }
    total_ms = sum(stages.values())
    return {
        "tiles": len(tiles),
        "tile_px": tsz,
        "reps": reps,
        **stages,
        "total_device_ms": total_ms,
        "device_mps": (h * w / 1e6) / (total_ms / 1e3),
    }


def _pctl(xs, q: float) -> float:
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(round(q * (len(ys) - 1))))]


def measure_latency(images, settings, samples: int = 8) -> dict:
    """Per-image p50/p95 latency (ms) under the CURRENT env config:
    single-image encode, decode, and round-trip, each a fresh pipeline
    call — the interactive-use metric the throughput capture hides
    (the pipelining depth that wins throughput can lose latency)."""
    from ako_tpu.runtime.executor import (
        PipelineDecoder,
        PipelineEncoder,
        roundtrip_iter,
    )

    enc = PipelineEncoder(settings, workers=4)
    dec = PipelineDecoder(workers=4)
    blob0 = enc.encode_batch([images[0]])[0]
    list(dec.decode_iter([blob0]))  # warm this config's single-image path
    e, d, r = [], [], []
    for i in range(samples):
        img = images[i % len(images)]
        t0 = time.perf_counter()
        blob = enc.encode_batch([img])[0]
        e.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        list(dec.decode_iter([blob]))
        d.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        list(roundtrip_iter([img], settings, workers=4))
        r.append(time.perf_counter() - t0)
    out = {}
    for name, xs in (("encode", e), ("decode", d), ("roundtrip", r)):
        out[name + "_p50_ms"] = round(1e3 * _pctl(xs, 0.5), 1)
        out[name + "_p95_ms"] = round(1e3 * _pctl(xs, 0.95), 1)
    return out


#: the reported value is the median of this many timed passes (7: one
#: outlier run cannot drag the median the way it could with 5)
RUNS = 7

#: interleaved probe rounds per candidate configuration during
#: auto-selection (configs compare only via interleaved medians)
PROBE_ROUNDS = 3


def _candidates():
    """Benchmark configurations to race: (name, pass_fn, env overrides).

    Axes: sequential vs overlapped round-trip stream; transfer
    compression (AKO_TPU_TRANSPORT); host-native decode
    (AKO_TPU_DECODE=host) and encode (AKO_TPU_ENCODE=host), which move
    no pixels to the device at all. AKO_BENCH_MODE (seq|roundtrip),
    AKO_TPU_TRANSPORT (0|1), AKO_TPU_DECODE and AKO_TPU_ENCODE
    (device|host) pin their axes; unset axes are probed."""
    mode_pin = os.environ.get("AKO_BENCH_MODE", "auto")
    transport_pin = os.environ.get("AKO_TPU_TRANSPORT")
    decode_pin = os.environ.get("AKO_TPU_DECODE", "auto")
    encode_pin = os.environ.get("AKO_TPU_ENCODE", "auto")
    modes = {
        "seq": [("seq", bench_ours)],
        "roundtrip": [("roundtrip", bench_ours_roundtrip)],
    }.get(mode_pin, [("seq", bench_ours), ("roundtrip", bench_ours_roundtrip)])
    transports = (
        [transport_pin == "1"] if transport_pin in ("0", "1") else [False, True]
    )

    cands = []
    if encode_pin in ("auto", "device") and decode_pin in ("auto", "device"):
        for tr in transports:
            for mname, fn in modes:
                # seq+transport has never won a capture; keep the race
                # tight unless transport is explicitly pinned on
                if tr and mname == "seq" and transport_pin != "1":
                    continue
                cands.append(
                    (
                        f"{mname}+{'transport' if tr else 'raw'}",
                        fn,
                        {
                            "AKO_TPU_TRANSPORT": "1" if tr else "0",
                            "AKO_TPU_TRANSPORT_ENC": "",
                            "AKO_TPU_DECODE": "device",
                            "AKO_TPU_ENCODE": "device",
                        },
                    )
                )
    if encode_pin in ("auto", "device") and decode_pin in ("auto", "host"):
        enctrs = (
            [transport_pin == "1"]
            if transport_pin in ("0", "1")
            else [False, True]
        )
        for enctr in enctrs:
            for mname, fn in modes:
                if enctr and mname == "seq" and transport_pin != "1":
                    continue
                cands.append(
                    (
                        f"{mname}+hostdec{'+enctr' if enctr else ''}",
                        fn,
                        {
                            "AKO_TPU_TRANSPORT": "0",
                            "AKO_TPU_TRANSPORT_ENC": "1" if enctr else "0",
                            "AKO_TPU_DECODE": "host",
                            "AKO_TPU_ENCODE": "device",
                        },
                    )
                )
    if encode_pin in ("auto", "host"):
        # the native encode pairs with host decode for the zero-link
        # config; only an explicit decode=device pin mixes it with the
        # device decoder (that combination has never won unpinned)
        hdec = "host" if decode_pin in ("auto", "host") else "device"
        suffix = "+hostenc+hostdec" if hdec == "host" else "+hostenc"
        for mname, fn in modes:
            cands.append(
                (
                    f"{mname}{suffix}",
                    fn,
                    {
                        "AKO_TPU_TRANSPORT": "0",
                        "AKO_TPU_TRANSPORT_ENC": "0",
                        "AKO_TPU_DECODE": hdec,
                        "AKO_TPU_ENCODE": "host",
                    },
                )
            )
    return cands


def _run_candidate(fn, env: dict, images, settings):
    for k, v in env.items():
        if v == "":
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return fn(images, settings, warm=False)


def _select_config(cands, images, settings):
    """Warm every distinct program set once, then race the candidates
    with up to PROBE_ROUNDS interleaved passes each; returns
    (median-best candidate, probe medians dict). With a single
    candidate (all axes pinned) this is just the warmup. Probe rounds
    stop once AKO_BENCH_PROBE_S is spent, so the race stays bounded."""
    # device-path program warmup: transport=1 compiles the superset
    # (enc+dec transport programs); host decode adds no device programs
    # of its own, but its +enctr candidate uses the encode-transport
    # programs, so map AKO_TPU_TRANSPORT_ENC=1 onto the "1" warm pass.
    # Full-host candidates (hostenc+hostdec) touch no device program at
    # all, so a race of only those skips the device warmup entirely.
    on_device = [
        env
        for _, _, env in cands
        if env.get("AKO_TPU_ENCODE") != "host" or env.get("AKO_TPU_DECODE") != "host"
    ]
    warm_transports = sorted(
        {env.get("AKO_TPU_TRANSPORT", "0") for env in on_device}
        | {"1" for env in on_device if env.get("AKO_TPU_TRANSPORT_ENC") == "1"}
    )
    # Device warmup is the only unbounded stage (compiles + full
    # streams). Past the budget, drop the device candidates and race
    # the host-native configs only.
    warm_budget = float(os.environ.get("AKO_BENCH_WARMUP_S", "900"))
    t_warm = time.perf_counter()
    warm_aborted = False
    for tr in warm_transports:
        _run_candidate(
            bench_ours,
            {
                "AKO_TPU_TRANSPORT": tr,
                "AKO_TPU_TRANSPORT_ENC": "",
                "AKO_TPU_DECODE": "device",
                "AKO_TPU_ENCODE": "device",
            },
            images,
            settings,
        )
        if time.perf_counter() - t_warm > warm_budget:
            warm_aborted = True
            break
    if warm_aborted:
        host_only_cands = [
            c
            for c in cands
            if c[2].get("AKO_TPU_ENCODE") == "host"
            and c[2].get("AKO_TPU_DECODE") == "host"
        ]
        if host_only_cands:
            print(
                f"bench: device warmup exceeded {warm_budget:.0f}s; "
                "racing zero-link host configs only",
                file=sys.stderr,
            )
            cands = host_only_cands
    if len(cands) == 1:
        if not on_device:  # full-host pin: warm its own path (native
            # lib load, qg caches) since no device pass ran above
            _run_candidate(cands[0][1], cands[0][2], images, settings)
        return cands[0], {}
    budget = float(os.environ.get("AKO_BENCH_PROBE_S", "240"))
    probes = {name: [] for name, _, _ in cands}
    t_start = time.perf_counter()
    for r in range(PROBE_ROUNDS):
        for name, fn, env in cands:
            t, _, _ = _run_candidate(fn, env, images, settings)
            probes[name].append(t)
        # warm timings include compile, so the budget is enforced on
        # the probes themselves: always one full interleaved round,
        # more only while they fit
        if time.perf_counter() - t_start > budget:
            break
    med = {name: sorted(ts)[len(ts) // 2] for name, ts in probes.items()}
    best = min(med, key=med.get)
    print(
        "bench: probe medians "
        + ", ".join(f"{n}={med[n]:.2f}s" for n in med)
        + f" -> {best}",
        file=sys.stderr,
    )
    return next(c for c in cands if c[0] == best), {
        n: round(t, 3) for n, t in med.items()
    }


def main() -> int:
    import jax

    from ako_tpu.runtime.device import card_line, enable_compile_cache, require_gpu

    enable_compile_cache()
    require_gpu()  # a run without a GPU fails; it never measures the CPU
    import ako_tpu

    devices = jax.devices()
    device = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "card": card_line(),  # nvidia-smi name, power limit
    }

    rng = np.random.default_rng(42)
    images = synth_images(rng, STREAM_N)
    settings = ako_tpu.Settings(quantization=16, tiles_dimension=TILES)

    # snapshot the candidate set BEFORE any _run_candidate exports a
    # config's env (the pins in _candidates() read the environment, so
    # a later re-call would see the winner's env as user pins)
    all_cands = _candidates()
    (config, ours_fn, env), probe_medians = _select_config(
        all_cands, images, settings
    )
    from ako_tpu.utils import metrics

    def _rel_iqr(ts):
        s = sorted(ts)
        return (s[(3 * len(s)) // 4] - s[len(s) // 4]) / s[len(s) // 2]

    metrics.reset()  # count fallbacks over the timed passes only
    times_ours = []
    for i in range(RUNS):
        # selection already warmed compiles + caches; every run here is
        # a clean timed pass
        t, blobs_ours, outs_ours = _run_candidate(ours_fn, env, images, settings)
        times_ours.append(t)
    # adaptive extension: the VM scheduler's multi-second stalls can
    # inflate several of the 7 runs in a bad window; when the relative
    # IQR is wide, buy up to 6 more samples before taking the median
    while _rel_iqr(times_ours) > 0.25 and len(times_ours) < RUNS + 6:
        t, blobs_ours, outs_ours = _run_candidate(ours_fn, env, images, settings)
        times_ours.append(t)
    t_ours = sorted(times_ours)[len(times_ours) // 2]
    mps = STREAM_N * MEGAPIXELS / t_ours
    fallbacks = metrics.fallback_summary()

    # The oracle is a hard requirement: a broken oracle build must fail
    # the benchmark loudly, not quietly report vs_baseline 0.
    times_ref = []
    for i in range(RUNS):
        t, blobs_ref, outs_ref = bench_ref(images, settings, warm=(i == 0))
        times_ref.append(t)
    while _rel_iqr(times_ref) > 0.25 and len(times_ref) < RUNS + 6:
        t, blobs_ref, outs_ref = bench_ref(images, settings, warm=False)
        times_ref.append(t)
    t_ref = sorted(times_ref)[len(times_ref) // 2]

    # --- single-device program stages (block_until_ready timings)
    device_compute = measure_device_compute(images[0], settings)

    # --- per-image latency for the winning config and (when distinct)
    # the best device-involved config
    def _is_device(env_):
        return (
            env_.get("AKO_TPU_ENCODE") != "host"
            or env_.get("AKO_TPU_DECODE") != "host"
        )

    _run_candidate(lambda *a, **k: (0, [], []), env, [], settings)
    latency = {config: measure_latency(images, settings)}
    if not _is_device(env) and probe_medians:
        dev_cands = [
            c for c in all_cands if _is_device(c[2]) and c[0] in probe_medians
        ]
        if dev_cands:
            best_dev = min(dev_cands, key=lambda c: probe_medians[c[0]])
            _run_candidate(lambda *a, **k: (0, [], []), best_dev[2], [], settings)
            latency[best_dev[0]] = measure_latency(images, settings)
            _run_candidate(lambda *a, **k: (0, [], []), env, [], settings)

    exact = all(a == b for a, b in zip(blobs_ours, blobs_ref)) and all(
        np.array_equal(a, b) for a, b in zip(outs_ours, outs_ref)
    )
    if not exact:
        print(
            json.dumps(
                {
                    "metric": "pipelined encode+decode MP/s (1024x1280 RGBA q16)",
                    "value": 0.0,
                    "unit": "MP/s",
                    "vs_baseline": 0.0,
                    "error": "NOT bit-exact vs reference",
                }
            )
        )
        return 1
    vs_baseline = t_ref / t_ours

    print(
        json.dumps(
            {
                "metric": "pipelined encode+decode MP/s (1024x1280 RGBA q16, bit-exact, median of %d)" % len(times_ours),
                "value": round(mps, 3),
                "unit": "MP/s",
                "vs_baseline": round(vs_baseline, 3),
                "config": config,
                # the raced configs' interleaved probe medians (s) and
                # per-run times
                "probe_medians_s": probe_medians,
                "runs_s": [round(t, 3) for t in times_ours],
                "ref_runs_s": [round(t, 3) for t in times_ref],
                # silent-path observability (utils/metrics.py): tiles
                # that ran on the exact-but-slow host fallbacks during
                # the timed passes; zero on the north-star workload,
                # and identically zero for the full-host configs
                "fallbacks": fallbacks,
                # per-program device ms on one image (block_until_ready)
                "device_compute": device_compute,
                # per-image p50/p95 (ms) per config: interactive use
                "latency_ms": latency,
                "corpus": os.environ.get("AKO_BENCH_CORPUS", "fbm"),
                "device": device,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
