"""Smoke run of the codec's device path on one GPU.

    python chip_smoke.py           # one GPU: every phase below
    python chip_smoke.py --four    # four GPUs: the multi-device path only

Drives the normal entry points (`ako_tpu.encode` / `decode`,
`PipelineEncoder` / `PipelineDecoder`, `roundtrip_iter`, the CLIs) at
the north-star width and checks every output against a reference that
lives in this repository: the golden files in `tests/golden/` and the
native C coder (`runtime/native/akort.c`), called directly through its
span entry points. The codec is all-integer, so the tolerance is zero:
blobs byte-equal, pixels bit-equal. Each phase raises on the first
mismatch and the process exits non-zero.

Phases (one GPU):
  golden   the three golden vectors through the default encode/decode
  stream   6 x 1024x1280 RGBA (q16, DD137, 128-px tiles) plus one
           1632x2464 RGBA image through the pipeline and through
           encode/decode; both host-fallback counters must read 0
  matrix   wavelets x wraps x q, odd and ragged shapes, border tiles
           that never lift, entropy stress, MANBAVARAN, resident word
           pool and transfer compression
  tools    akodec (and akoenc where Pillow imports) on a real image

Timings are printed on earlier lines as a smoke reading, not a
benchmark. The last line of standard output is one JSON object naming
the device JAX ran on. Without a GPU the script fails before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import struct
import sys
import tempfile
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np

import ako_tpu
from ako_tpu import Settings
from ako_tpu.core import container, geometry
from ako_tpu.core.settings import Compression, Wavelet, Wrap
from ako_tpu.decode import _host_decode_plan, _read_tile_block
from ako_tpu.encode import (
    _CAPACITY_MARGIN,
    _host_span_plan,
    checked_settings,
    pack_budget,
)
from ako_tpu.ops.lifting import forward_tile, inverse_tile
from ako_tpu.ops.quantization import level_qg
from ako_tpu.parallel import forward_tile_sharded, inverse_tile_sharded, make_mesh
from ako_tpu.parallel.tiles import (
    _sharded_tile_encoder_fused,
    decode_image_sharded,
    encode_image_sharded,
)
from ako_tpu.runtime import hostcodec
from ako_tpu.runtime.device import (
    card_line,
    enable_compile_cache,
    require_gpu,
    resolve_device_entropy,
)
from ako_tpu.runtime.executor import PipelineDecoder, PipelineEncoder, roundtrip_iter
from ako_tpu.runtime.kagari import BLOCK_HEAD, kagari_encode, kagari_sync
from ako_tpu.tools import akodec, akoenc
from ako_tpu.tools.pngout import write_png
from ako_tpu.utils import metrics
from ako_tpu.utils.corpus import corpus
from bench import measure_device_compute
from tests import oracle

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")

#: settings of the golden vectors (tests/test_golden.py)
GOLDEN_SETTINGS = {
    "q16": dict(quantization=16),
    "lossless": dict(quantization=0, gate=0),
    "tiled_q16": dict(quantization=16, tiles_dimension=16),
}

#: north-star stream: BASELINE.json's 1024x1280 RGBA q16 cell (DD137 is
#: the default wavelet) plus the 1632x2464 image of its tiled config,
#: whose ragged border tiles compile their own programs
STREAM = dict(n=6, h=1280, w=1024, big_h=2464, big_w=1632, tiles=128)


class SmokeFailure(RuntimeError):
    """A device output differs from its reference."""


def check(ok, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


@contextlib.contextmanager
def _env(**kv):
    """Set environment options for the duration of one case."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------
# The plain reference: the native C coder, called directly


def native_encode(image: np.ndarray, settings) -> bytes:
    """Whole-image encode by one native span call (format + lift +
    Kagari entropy in akort.c). Kagari-coded settings only."""
    s = checked_settings(settings)
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, ch = image.shape
    n = len(geometry.tile_grid(w, h, s.tiles_dimension))
    plan = _host_span_plan(
        w, h, ch, s.tiles_dimension, s.wavelet, s.quantization, s.gate,
        s.chroma_loss,
    )
    out = np.empty(plan.total_bytes, np.uint8)
    sizes = np.zeros(n, np.int64)
    hostcodec.tile_encode_spans(
        image, plan.rects, plan.qg_off, plan.qs, plan.gs, plan.counts,
        plan.caps, out, plan.out_off, sizes, s.wavelet, s.wrap, s.color,
        bool(s.discard_non_visible),
    )
    check(sizes.all(), "native coder: incompressible tile")
    head = container.head_write(ch, w, h, s)
    return head + b"".join(
        out[o : o + BLOCK_HEAD.size + z].tobytes()
        for o, z in zip(plan.out_off.tolist(), sizes.tolist())
    )


def native_decode(blob: bytes) -> np.ndarray:
    """Whole-image decode by one native span call (entropy + unlift +
    inverse color in akort.c)."""
    view = memoryview(blob)
    ch, w, h, s = container.head_read(view)
    grid = geometry.tile_grid(w, h, s.tiles_dimension)
    plan = _host_decode_plan(w, h, ch, s.tiles_dimension, s.wavelet)
    pay_off = np.empty(len(grid), np.int64)
    pay_size = np.empty(len(grid), np.int64)
    cursor = container.HEAD_SIZE
    for i, t in enumerate(grid):
        payload, cursor = _read_tile_block(view, cursor, t, s, ch)
        pay_size[i] = len(payload)
        pay_off[i] = cursor - len(payload)
    image = np.empty((h, w, ch), np.uint8)
    rc = hostcodec.tile_decode_spans(
        np.frombuffer(blob, np.uint8), pay_off, pay_size, plan.counts,
        plan.caps, plan.rects, image, s.wavelet, s.wrap, s.color,
    )
    check(rc == 0, f"native decoder rejected tile {rc}")
    return image


def _photo(rng, h: int, w: int, ch: int, period=(19.0, 13.0)) -> np.ndarray:
    """Smooth structure plus grain: small matrix images."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 120 + 60 * np.sin(x / period[0]) + 50 * np.cos(y / period[1])
    img = np.stack(
        [np.clip(base * (0.6 + 0.15 * c), 0, 255) for c in range(ch)], axis=-1
    )
    img += rng.normal(0, 2.0, size=img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _assert_vs_native(img, s, dev, what: str) -> bytes:
    """encode/decode through the public entry points == native coder."""
    blob = ako_tpu.encode(img, s, device_entropy=dev)
    check(blob == native_encode(img, s), f"{what}: blob differs from the native coder")
    pix = ako_tpu.decode(blob, device_entropy=dev)[0]
    check(np.array_equal(pix, native_decode(blob)), f"{what}: pixels differ from the native coder")
    return blob


# ---------------------------------------------------------------------
# Phases


def phase_golden(dev=None) -> None:
    """Golden vectors (made by the reference) through encode/decode."""
    image = np.load(os.path.join(GOLDEN, "image_40x48_rgb.npy"))
    for name, kw in GOLDEN_SETTINGS.items():
        with open(os.path.join(GOLDEN, f"{name}.ako"), "rb") as f:
            golden = f.read()
        blob = ako_tpu.encode(image, Settings(**kw), device_entropy=dev)
        check(blob == golden, f"golden {name}: blob differs")
        pix = ako_tpu.decode(golden, device_entropy=dev)[0]
        want = np.load(os.path.join(GOLDEN, f"{name}_decoded.npy"))
        check(np.array_equal(pix, want), f"golden {name}: pixels differ")


class _CompileTimer:
    """Sums JAX's trace, lowering and backend-compile durations."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_kw):
        if event in self.EVENTS:
            self.seconds += duration


def stream_images(n, h, w, big_h, big_w, **_):
    return corpus(42, n, h, w, 4) + corpus(43, 1, big_h, big_w, 4)


def phase_stream(dev=None, workers: int = 4, timings: bool = True, **shape) -> dict:
    """North-star stream through the pipeline and the one-shot entry
    points, byte/bit-equal to the native coder, no host fallbacks."""
    shape = {**STREAM, **shape}
    check(resolve_device_entropy(dev), "device-entropy choice resolved to the host coder")
    s = Settings(quantization=16, tiles_dimension=shape["tiles"])
    images = stream_images(**shape)
    ref_blobs = [native_encode(img, s) for img in images]
    ref_pix = [native_decode(b) for b in ref_blobs]

    enc = PipelineEncoder(s, workers=workers, device_entropy=dev)
    dec = PipelineDecoder(workers=workers)
    timer = _CompileTimer() if timings else None
    metrics.reset()
    t0 = time.perf_counter()
    blobs = enc.encode_batch(images)
    pixels = list(dec.decode_iter(blobs, device_entropy=dev))
    cold_s = time.perf_counter() - t0
    compile_s = timer.seconds if timings else None
    counts = metrics.fallback_summary()
    n_tiles = sum(
        len(geometry.tile_grid(im.shape[1], im.shape[0], shape["tiles"]))
        for im in images
    )
    for i, (b, p) in enumerate(zip(blobs, pixels)):
        check(b == ref_blobs[i], f"stream image {i}: pipeline blob differs from the native coder")
        check(np.array_equal(p, ref_pix[i]), f"stream image {i}: pipeline pixels differ")
    check(counts[metrics.ENC_HOST_FALLBACK] == 0, f"encode host fallbacks: {counts}")
    check(counts[metrics.DEC_HOST_FALLBACK] == 0, f"decode host fallbacks: {counts}")
    check(counts[metrics.ENC_DEVICE] == n_tiles, f"device packer missed tiles: {counts}")
    check(counts[metrics.DEC_DEVICE] == n_tiles, f"device decoder missed tiles: {counts}")

    for i, img in enumerate(images):
        check(ako_tpu.encode(img, s, device_entropy=dev) == ref_blobs[i],
              f"stream image {i}: encode() blob differs")
        check(np.array_equal(ako_tpu.decode(ref_blobs[i], device_entropy=dev)[0], ref_pix[i]),
              f"stream image {i}: decode() pixels differ")

    out = {"images": len(images), "tiles": n_tiles}
    if not timings:
        return out
    t0 = time.perf_counter()
    blobs2 = enc.encode_batch(images)
    pixels2 = list(dec.decode_iter(blobs2, device_entropy=dev))
    warm_s = time.perf_counter() - t0
    check(blobs2 == blobs and all(np.array_equal(a, b) for a, b in zip(pixels2, pixels)),
          "second stream pass differs from the first")
    mp = sum(im.shape[0] * im.shape[1] for im in images) / 1e6
    out.update(
        cold_pass_s=cold_s,
        compile_s=compile_s,
        warm_pass_s=warm_s,
        stream_mps=mp / warm_s,
    )
    return out


def _case_e2e(dev, wavelet, wrap, q):
    s = Settings(quantization=q, wavelet=Wavelet[wavelet], wrap=Wrap[wrap], tiles_dimension=0)
    _assert_vs_native(_photo(np.random.default_rng(1234), 48, 40, 4), s, dev, f"{wavelet}/{wrap}/q{q}")


def _case_odd_shape(dev):
    s = Settings(quantization=16, tiles_dimension=0)
    _assert_vs_native(_photo(np.random.default_rng(1), 47, 33, 3), s, dev, "47x33x3")


def _case_ragged_grid(dev):
    # four shape groups (32x32, 8x32, 32x18, 8x18)
    s = Settings(quantization=16, tiles_dimension=32)
    _assert_vs_native(_photo(np.random.default_rng(2), 50, 72, 4), s, dev, "50x72 tiles 32")


def _case_no_lift_border(dev):
    # width-1 remainder tiles never lift (PARITY.md divergence 11):
    # deterministic encode, equal to the host-entropy path, and the
    # native decoder reproduces the device decoder's pixels

    s = Settings(quantization=16, tiles_dimension=32)
    img = _photo(np.random.default_rng(3), 50, 65, 4)
    blob = ako_tpu.encode(img, s, device_entropy=dev)
    check(blob == ako_tpu.encode(img, s, device_entropy=dev), "border tiles: encode not deterministic")
    check(blob == ako_tpu.encode(img, s, device_entropy=False), "border tiles: differs from host entropy")
    pix = ako_tpu.decode(blob, device_entropy=dev)[0]
    check(np.array_equal(pix, native_decode(blob)), "border tiles: pixels differ from the native coder")


def _case_roundtrip_iter(dev):
    s = Settings(quantization=16, tiles_dimension=32)
    rng = np.random.default_rng(4)
    imgs = [_photo(rng, 64, 64, 4), _photo(rng, 64, 64, 4)]
    for img, (blob, pix) in zip(imgs, roundtrip_iter(iter(imgs), s, device_entropy=dev)):
        check(blob == native_encode(img, s), "roundtrip_iter: blob differs")
        check(np.array_equal(pix, native_decode(blob)), "roundtrip_iter: pixels differ")


def _expected_enc_fallbacks(blob: bytes, quantization: int):
    """(host fallbacks, device tiles) the packer must report, from the
    payload sizes in a blob: a tile falls back iff its compressed size
    passes the pack budget or comes within the margin of capacity."""
    view = memoryview(blob)
    ch, w, h, s = container.head_read(view)
    grid = geometry.tile_grid(w, h, s.tiles_dimension)
    cursor, n_fb = container.HEAD_SIZE, 0
    for t in grid:
        capacity = geometry.tile_data_size(t.w, t.h) * ch - BLOCK_HEAD.size
        (bs,) = BLOCK_HEAD.unpack_from(view, cursor)
        cursor += BLOCK_HEAD.size + bs
        if bs > pack_budget(capacity, quantization) or bs >= capacity - _CAPACITY_MARGIN:
            n_fb += 1
    return n_fb, len(grid) - n_fb


def _case_near_capacity(dev):
    # noise tiles at q=1 pass the pack budget (host fallback), smooth
    # tiles stay on the device; counters equal the blob's own sizes

    rng = np.random.default_rng(1234)
    img = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
    y, x = np.mgrid[0:64, 0:64].astype(np.float32)
    smooth = np.clip(120 + 60 * np.sin(x / 9.0) + 50 * np.cos(y / 7.0), 0, 255)
    img[:, :32, :] = smooth.astype(np.uint8)[:, :32, None]
    s = Settings(quantization=1, tiles_dimension=32)
    ref = native_encode(img, s)
    exp_fb, exp_dev = _expected_enc_fallbacks(ref, 1)
    check(exp_fb >= 1 and exp_dev >= 1, "near-capacity construction lost a tile kind")
    metrics.reset()
    blob = ako_tpu.encode(img, s, device_entropy=dev)
    c = metrics.counters()
    check(blob == ref, "near capacity: blob differs")
    check(c.get(metrics.ENC_HOST_FALLBACK, 0) == exp_fb, f"near capacity: encode counters {c}")
    check(c.get(metrics.ENC_DEVICE, 0) == exp_dev, f"near capacity: encode counters {c}")
    metrics.reset()
    pix = ako_tpu.decode(blob, device_entropy=dev)[0]
    c = metrics.counters()
    check(np.array_equal(pix, native_decode(ref)), "near capacity: pixels differ")
    check(c.get(metrics.DEC_DEVICE, 0) == exp_fb + exp_dev, f"near capacity: decode counters {c}")
    check(c.get(metrics.DEC_HOST_FALLBACK, 0) == 0, f"near capacity: decode counters {c}")


def _case_forced_flush(dev):
    # one constant 256x256 RGBA tile: the zero run passes 65534 and
    # forces the RLE counter flush inside the device scan coder

    img = np.full((256, 256, 4), 137, np.uint8)
    s = Settings(quantization=16, tiles_dimension=0)
    metrics.reset()
    _assert_vs_native(img, s, dev, "65534 flush")
    check(metrics.counters().get(metrics.ENC_HOST_FALLBACK, 0) == 0, "65534 flush fell back")


def _quirk_blob() -> bytes:
    """Two-tile container: tile 0 carries zigzag(-32768) quirk codes
    merged with 31-bit literals (past the device decoder's 31-bit
    window, so the sync scan routes it to the host), tile 1 is clean."""
    s = checked_settings(Settings(quantization=16, tiles_dimension=32))
    head = container.head_write(1, 32, 64, s)
    count = geometry.tile_data_size(32, 32) // 2
    qrng = np.random.default_rng(2)
    vq = qrng.integers(-40, 40, size=count).astype(np.int16)
    idx = qrng.integers(0, count - 1, size=30)
    vq[idx] = -32768
    vq[idx + 1] = qrng.choice(np.array([30000, -30000, 25000], np.int16), size=30)
    vc = (np.arange(count) % 7 - 3).astype(np.int16)
    blocks = []
    for v in (vq, vc):
        payload = kagari_encode(v, v.nbytes * 8 + 4096)
        check(payload is not None, "quirk construction: native encode failed")
        blocks.append(BLOCK_HEAD.pack(len(payload)) + payload)
    cap = geometry.tile_data_size(32, 32) + geometry.planes_spacing(32, 32)
    sq = kagari_sync(count, blocks[0][BLOCK_HEAD.size :], cap, 256)
    sc = kagari_sync(count, blocks[1][BLOCK_HEAD.size :], cap, 256)
    check(sq is not None and sq[5] > 31, "quirk construction: tile 0 not oversized")
    check(sc is not None and sc[5] <= 31, "quirk construction: tile 1 oversized")
    return head + b"".join(blocks)


def _case_oversized_code(dev):
    blob = _quirk_blob()
    metrics.reset()
    pix = ako_tpu.decode(blob, device_entropy=dev)[0]
    c = metrics.counters()
    check(np.array_equal(pix, native_decode(blob)), "oversized code: pixels differ")
    check(c.get(metrics.DEC_HOST_FALLBACK, 0) == 1, f"oversized code: counters {c}")
    check(c.get(metrics.DEC_DEVICE, 0) == 1, f"oversized code: counters {c}")


def _case_manbavaran(dev):
    # the rANS extension: device encode and decode equal the host coder

    s = Settings(quantization=16, tiles_dimension=32, compression=Compression.MANBAVARAN)
    img = _photo(np.random.default_rng(5), 96, 64, 4)
    with _env(AKO_TPU_MANBAVARAN="1"):
        host_blob = ako_tpu.encode(img, s, device_entropy=False)
        want = ako_tpu.decode(host_blob, device_entropy=False)[0]
        check(ako_tpu.encode(img, s, device_entropy=dev) == host_blob,
              "MANBAVARAN: device encode differs from the native coder")
        check(np.array_equal(ako_tpu.decode(host_blob, device_entropy=dev)[0], want),
              "MANBAVARAN: device decode differs from the native coder")


def _case_resident(dev):
    # roundtrip_iter's decode reads its word pool from the encoder's
    # device-resident compressed rows

    s = Settings(quantization=16, tiles_dimension=128)
    rng = np.random.default_rng(6)
    imgs = [_photo(rng, 256, 200, 4, (37.0, 23.0)) for _ in range(2)]
    for img, (blob, pix) in zip(imgs, roundtrip_iter(iter(imgs), s, device_entropy=dev)):
        check(blob == native_encode(img, s), "resident pool: blob differs")
        check(np.array_equal(pix, native_decode(blob)), "resident pool: pixels differ")


def _case_transport(dev):
    # lossless q0 transfer compression in both directions, alone and
    # with the resident pool

    s = Settings(quantization=16, tiles_dimension=128)
    img = _photo(np.random.default_rng(7), 256, 256, 4, (37.0, 23.0))
    with _env(AKO_TPU_TRANSPORT="1"):
        _assert_vs_native(img, s, dev, "transport")
        ((blob, pix),) = list(roundtrip_iter([img], s, device_entropy=dev))
    check(blob == native_encode(img, s), "transport + resident: blob differs")
    check(np.array_equal(pix, native_decode(blob)), "transport + resident: pixels differ")


MATRIX = {
    **{
        f"e2e_{wv}_{wr}_q{q}": (lambda dev, wv=wv, wr=wr, q=q: _case_e2e(dev, wv, wr, q))
        for wv in ("DD137", "CDF53", "HAAR")
        for wr in ("CLAMP", "MIRROR")
        for q in (0, 16)
    },
    "odd_shape": _case_odd_shape,
    "ragged_grid": _case_ragged_grid,
    "no_lift_border_tiles": _case_no_lift_border,
    "roundtrip_iter": _case_roundtrip_iter,
    "near_capacity": _case_near_capacity,
    "forced_flush_65534": _case_forced_flush,
    "oversized_code": _case_oversized_code,
    "manbavaran": _case_manbavaran,
    "resident_pool": _case_resident,
    "transport": _case_transport,
}


def phase_matrix(dev=None, log=None) -> int:
    for name, case in MATRIX.items():
        t0 = time.perf_counter()
        case(dev)
        if log is not None:
            log(f"matrix {name}: {time.perf_counter() - t0:.1f} s")
    return len(MATRIX)


def read_png_stored(path: str) -> np.ndarray:
    """Pixels of an unfiltered 8-bit PNG (what akodec -e 1 writes)."""
    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "akodec: not a PNG")
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
    w, h, depth, ctype = ihdr[:4]
    ch = {0: 1, 4: 2, 2: 3, 6: 4}[ctype]
    check(depth == 8, "akodec: PNG depth")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    check(not rows[:, 0].any(), "akodec -e 1: filtered rows")
    return rows[:, 1:].reshape(h, w, ch)


def phase_tools(image: np.ndarray, s_kw: dict) -> dict:
    """akodec always; akoenc where Pillow (its PNG reader) imports."""
    s = Settings(**s_kw)
    blob = native_encode(image, s)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        ako = os.path.join(d, "in.ako")
        with open(ako, "wb") as f:
            f.write(blob)
        png = os.path.join(d, "out.png")
        check(akodec.main(["-i", ako, "-o", png, "-e", "1", "-quiet"]) == 0, "akodec failed")
        check(np.array_equal(read_png_stored(png), native_decode(blob)), "akodec: pixels differ")
        if importlib.util.find_spec("PIL") is None:  # akoenc's PNG reader
            out["akoenc"] = "not run (Pillow absent)"
            return out
        src = os.path.join(d, "in.png")
        write_png(src, image, effort=1)
        enc_out = os.path.join(d, "out.ako")
        argv = ["-i", src, "-o", enc_out, "-q", str(s.quantization),
                "-t", str(s.tiles_dimension), "-quiet"]
        check(akoenc.main(argv) == 0, "akoenc failed")
        with open(enc_out, "rb") as f:
            check(f.read() == blob, "akoenc: blob differs")
        out["akoenc"] = "ran"
    return out


def phase_oracle(dev=None, n: int = 2) -> str:
    """Extra check against the reference library, where its sources
    are present (tests/oracle.py builds it)."""
    if not oracle.available():
        return "skipped (reference sources absent)"

    s = Settings(quantization=16, tiles_dimension=STREAM["tiles"])
    for img in stream_images(**STREAM)[:n]:
        blob = ako_tpu.encode(img, s, device_entropy=dev)
        check(blob == oracle.ref_encode(img, checked_settings(s)), "reference library: blob differs")
        check(np.array_equal(ako_tpu.decode(blob, device_entropy=dev)[0],
                             oracle.ref_decode(blob)[0]), "reference library: pixels differ")
    return "ran"


def _sharded_span(arr, n: int) -> None:
    check(len(arr.sharding.device_set) == n,
          f"output spans {len(arr.sharding.device_set)} devices, not {n}")


def phase_four(n: int = 4, h: int = 1280, w: int = 1024, tiles: int = 128,
               plane: int = 2048) -> None:
    """Multi-device paths against their single-device twins: tile data
    parallelism over a 1-D "tiles" mesh and row-sharded halo lifting
    over a "rows" mesh."""
    check(len(jax.devices()) >= n, f"need {n} devices, found {len(jax.devices())}")
    tmesh = make_mesh((n,), ("tiles",))
    s = checked_settings(Settings(quantization=16, tiles_dimension=tiles))
    img = corpus(42, 1, h, w, 4)[0]
    ref_blob = ako_tpu.encode(img, s, device_entropy=True)
    check(ref_blob == native_encode(img, s), "four: single-device blob differs from the native coder")
    with tmesh:
        blob = encode_image_sharded(img, s, tmesh, "tiles")
        pix = decode_image_sharded(blob, tmesh, "tiles", device_entropy=True)[0]
    check(blob == ref_blob, "four: sharded encode differs from single-device encode")
    check(np.array_equal(pix, ako_tpu.decode(ref_blob, device_entropy=True)[0]),
          "four: sharded decode differs from single-device decode")
    fwd, pack, _, _ = _sharded_tile_encoder_fused(
        tmesh, "tiles", tiles, tiles, 4, s.wavelet, s.wrap, s.color,
        bool(s.discard_non_visible), s.quantization, s.gate, s.chroma_loss,
    )
    full = [img[t.y : t.y + tiles, t.x : t.x + tiles]
            for t in geometry.tile_grid(w, h, tiles) if (t.w, t.h) == (tiles, tiles)]
    stream = fwd(jnp.asarray(np.stack(full[: len(full) // n * n])))
    comp, _totals = pack(stream)
    for arr in (stream, comp):
        _sharded_span(arr, n)
        check(not arr.sharding.is_fully_replicated, "four: tile batch is not sharded")

    rmesh = make_mesh((n,), ("rows",))
    rng = np.random.default_rng(11)
    cases = [
        (plane, plane, Wavelet.DD137, Wrap.CLAMP),
        (plane, plane - 2, Wavelet.DD137, Wrap.MIRROR),  # ragged: _fix_fwd/_fix_inv
        (plane, plane, Wavelet.CDF53, Wrap.CLAMP),
    ]
    for pw, ph, wavelet, wrap in cases:
        schedule = geometry.lift_schedule(pw, ph)
        qg = level_qg(schedule, 3, s.quantization, s.gate, s.chroma_loss)
        planes = rng.integers(-512, 512, size=(3, ph, pw)).astype(np.int16)
        want = jax.jit(lambda p: forward_tile(p, schedule, wavelet, wrap, qg))(planes)
        want_back = jax.jit(lambda c: inverse_tile(c, schedule, wavelet, wrap, 3))(want)
        with rmesh:
            got = jax.jit(lambda p: forward_tile_sharded(
                p, schedule, wavelet, wrap, qg, rmesh, "rows"))(planes)
            back = jax.jit(lambda c: inverse_tile_sharded(
                c, schedule, wavelet, wrap, 3, rmesh, "rows"))(got)
        name = f"{wavelet.name}/{wrap.name} {pw}x{ph}"
        for arr in (got, back):
            _sharded_span(arr, n)
        check(np.array_equal(np.asarray(got), np.asarray(want)), f"four: halo lift {name} differs")
        check(np.array_equal(np.asarray(back), np.asarray(want_back)), f"four: halo unlift {name} differs")


# ---------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU path and its comparison")
    args = ap.parse_args(argv)

    enable_compile_cache()
    require_gpu()
    devices = jax.devices()
    card = card_line()
    print(f"device: {devices[0].device_kind} x{len(devices)}; card: {card}", flush=True)
    label = f"[smoke, not benchmark; {card}]"

    if args.four:
        t0 = time.perf_counter()
        phase_four()
        print(f"four: sharded blobs and pixels equal single-device output "
              f"({time.perf_counter() - t0:.1f} s) {label}", flush=True)
        count = 4
    else:
        t0 = time.perf_counter()
        phase_golden()
        print(f"golden: 3 encodes + 3 decodes exact ({time.perf_counter() - t0:.1f} s)", flush=True)
        st = phase_stream()
        print(f"stream: {st['images']} images, {st['tiles']} tiles exact, 0 fallbacks; "
              f"{st['stream_mps']:.3f} MP/s warm, cold pass {st['cold_pass_s']:.2f} s, "
              f"compile {st['compile_s']:.2f} s {label}", flush=True)

        s = Settings(quantization=16, tiles_dimension=STREAM["tiles"])
        img = stream_images(**STREAM)[0]
        dc = measure_device_compute(img, s)
        print("device ms per 1024x1280 image (80 tiles, block_until_ready, median of "
              f"{dc['reps']}): " + ", ".join(
                  f"{k} {dc[k]:.3f}" for k in
                  ("enc_fwd_ms", "enc_pack_ms", "dec_entropy_ms", "dec_unlift_ms"))
              + f" {label}", flush=True)
        n = phase_matrix(log=lambda m: print(m, file=sys.stderr, flush=True))
        print(f"matrix: {n} cases exact", flush=True)
        tools = phase_tools(img, dict(quantization=16, tiles_dimension=STREAM["tiles"]))
        print(f"tools: akodec ran; akoenc {tools['akoenc']}", flush=True)
        print(f"reference library check: {phase_oracle()}", flush=True)
        peak = devices[0].memory_stats()["peak_bytes_in_use"]
        print(f"peak_bytes_in_use: {peak} {label}", flush=True)
        count = len(devices)
    print(json.dumps({
        "ok": True,
        "device": {"platform": devices[0].platform, "kind": devices[0].device_kind,
                   "count": count},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
