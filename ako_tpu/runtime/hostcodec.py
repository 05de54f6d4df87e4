"""Host-native decode compute: the inverse DWT + pixel format on CPU.

The device is the codec's compute engine, but the blob the host
already holds (~2.1 MB for a 1024x1280 RGBA image at q16) fully
determines the pixels, while fetching decoded pixels from the device
moves ~3.9 MB. These wrappers expose akort.c's native tile unlift +
inverse color (semantics of ops/lifting.py:inverse_tile and
ops/colorspace.py:to_interleaved_u8, reference library/lifting.c:295 /
format.c:244) so a decode can run entirely on the host CPU with no
device traffic:

- the host-decode pipeline path (decode.decode / runtime.executor with
  AKO_TPU_DECODE=host), raced by bench.py against the device paths;
- the transport unpack (runtime/transport.py), which would otherwise
  run a CPU-XLA unlift program.
- the plain reference that chip_smoke.py compares the device paths
  with (the native span entries).

Tiles are independent, and ctypes releases the GIL during the native
calls, so callers fan tiles out on the shared worker pool.
Bit-exactness is asserted against the Python/XLA ops (which are
oracle-tested against the reference) in tests/test_hostcodec.py.
"""

from __future__ import annotations

import numpy as np

from ako_tpu.core.settings import AkoError, Color, Status, Wavelet, Wrap
from ako_tpu.runtime.build import load


def tile_unlift(
    values: np.ndarray,
    tile_w: int,
    tile_h: int,
    channels: int,
    wavelet: Wavelet,
    wrap: Wrap,
) -> np.ndarray:
    """Serialized int16 coefficient stream -> planar int16
    (channels, tile_h, tile_w). Raises AkoError on a size mismatch
    (the stream length is fully determined by the tile geometry)."""
    lib = load()
    values = np.ascontiguousarray(values, dtype=np.int16)
    out = np.empty((channels, tile_h, tile_w), dtype=np.int16)
    rc = lib.akort_tile_unlift(
        values.ctypes.data,
        values.size,
        tile_w,
        tile_h,
        channels,
        int(wavelet),
        int(wrap),
        out.ctypes.data,
    )
    if rc != 0:
        raise AkoError(Status.ERROR, f"native tile unlift failed (rc={rc})")
    return out


def planes_to_u8(planes: np.ndarray, color: Color) -> np.ndarray:
    """Planar int16 (channels, h, w) -> interleaved u8 (h, w, channels)
    with the inverse color transform + saturation."""
    lib = load()
    planes = np.ascontiguousarray(planes, dtype=np.int16)
    channels, h, w = planes.shape
    out = np.empty((h, w, channels), dtype=np.uint8)
    lib.akort_planes_to_u8(
        planes.ctypes.data, w, h, channels, int(color), out.ctypes.data
    )
    return out


def tile_decode_pixels(
    values: np.ndarray,
    tile_w: int,
    tile_h: int,
    channels: int,
    wavelet: Wavelet,
    wrap: Wrap,
    color: Color,
) -> np.ndarray:
    """Coefficient stream -> interleaved u8 tile, all native."""
    return planes_to_u8(
        tile_unlift(values, tile_w, tile_h, channels, wavelet, wrap), color
    )


def u8_to_planes(
    tile_u8: np.ndarray, color: Color, discard_non_visible: bool
) -> np.ndarray:
    """Interleaved u8 (h, w, channels) -> planar int16 with the forward
    color transform (semantics of ops/colorspace.py:to_planar_yuv)."""
    lib = load()
    tile_u8 = np.ascontiguousarray(tile_u8, dtype=np.uint8)
    h, w, channels = tile_u8.shape
    out = np.empty((channels, h, w), dtype=np.int16)
    lib.akort_u8_to_planes(
        tile_u8.ctypes.data,
        w,
        h,
        channels,
        int(color),
        1 if discard_non_visible else 0,
        out.ctypes.data,
    )
    return out


def tile_lift(
    planes: np.ndarray,
    wavelet: Wavelet,
    wrap: Wrap,
    qg,
) -> np.ndarray:
    """Planar int16 (channels, th, tw) -> serialized coefficient
    stream, the forward twin of tile_unlift. `qg` is level_qg's output
    (per encode-order level: (per-channel qs, per-channel gs))."""
    from ako_tpu.core import geometry

    lib = load()
    planes = np.ascontiguousarray(planes, dtype=np.int16)
    channels, th, tw = planes.shape
    count = geometry.tile_data_size(tw, th) * channels // 2
    out = np.empty(count, dtype=np.int16)
    qs = np.ascontiguousarray(
        [q for level_qs, _ in qg for q in level_qs], dtype=np.int32
    )
    gs = np.ascontiguousarray(
        [g for _, level_gs in qg for g in level_gs], dtype=np.int32
    )
    rc = lib.akort_tile_lift(
        planes.ctypes.data,
        tw,
        th,
        channels,
        int(wavelet),
        int(wrap),
        qs.ctypes.data if qs.size else None,
        gs.ctypes.data if gs.size else None,
        out.ctypes.data,
        out.size,
    )
    if rc != 0:
        raise AkoError(Status.ERROR, f"native tile lift failed (rc={rc})")
    return out


def tile_encode_stream(
    tile_u8: np.ndarray,
    wavelet: Wavelet,
    wrap: Wrap,
    color: Color,
    qg,
    discard_non_visible: bool = False,
) -> np.ndarray:
    """Interleaved u8 tile -> serialized coefficient stream, all
    native (format + lift). The transport packer's fast path."""
    return tile_lift(
        u8_to_planes(tile_u8, color, discard_non_visible), wavelet, wrap, qg
    )


def tile_encode_block(
    tile_u8: np.ndarray,
    wavelet: Wavelet,
    wrap: Wrap,
    color: Color,
    qg,
    output_capacity: int,
    discard_non_visible: bool = False,
) -> bytes | None:
    """Interleaved u8 tile -> Kagari payload (no frame head) in ONE
    native call (format + lift + entropy; akort_tile_encode_block).
    None when incompressible. Every Python<->C crossing runs under the
    GIL, so the pipeline's per-tile call count is a direct serial cost
    — this fuses three crossings into one."""
    from ako_tpu.core import geometry

    if output_capacity <= 0:
        return None
    lib = load()
    tile_u8 = np.ascontiguousarray(tile_u8, dtype=np.uint8)
    h, w, channels = tile_u8.shape
    if wavelet == Wavelet.NONE:
        count = w * h * channels
    else:
        count = geometry.tile_data_size(w, h) * channels // 2
    out = np.empty(max(output_capacity, 1), dtype=np.uint8)
    qs = np.ascontiguousarray(
        [q for level_qs, _ in qg for q in level_qs], dtype=np.int32
    )
    gs = np.ascontiguousarray(
        [g for _, level_gs in qg for g in level_gs], dtype=np.int32
    )
    rc = np.zeros(1, dtype=np.int32)
    n = lib.akort_tile_encode_block(
        tile_u8.ctypes.data,
        w,
        h,
        channels,
        int(wavelet),
        int(wrap),
        int(color),
        1 if discard_non_visible else 0,
        qs.ctypes.data if qs.size else None,
        gs.ctypes.data if gs.size else None,
        count,
        out.ctypes.data,
        output_capacity,
        rc.ctypes.data,
    )
    if n == 0:
        if int(rc[0]) not in (0, 1):
            raise AkoError(Status.ERROR, f"native tile encode rc={int(rc[0])}")
        return None
    return out[:n].tobytes()


def tile_decode_block(
    payload,
    count: int,
    output_capacity_bytes: int,
    tile_w: int,
    tile_h: int,
    channels: int,
    wavelet: Wavelet,
    wrap: Wrap,
    color: Color,
) -> np.ndarray | None:
    """Kagari payload -> interleaved u8 pixels in ONE native call
    (entropy + unlift + inverse color; akort_tile_decode_block). None
    on broken input (decode failure or trailing bytes — the
    decompress_block contract)."""
    lib = load()
    src = np.frombuffer(payload, dtype=np.uint8)
    out = np.empty((tile_h, tile_w, channels), dtype=np.uint8)
    rc = lib.akort_tile_decode_block(
        src.ctypes.data if src.size else None,
        src.nbytes,
        count,
        output_capacity_bytes,
        tile_w,
        tile_h,
        channels,
        int(wavelet),
        int(wrap),
        int(color),
        out.ctypes.data,
    )
    if rc == 1:
        return None
    if rc != 0:
        raise AkoError(Status.ERROR, f"native tile decode rc={rc}")
    return out


def tile_encode_spans(
    image: np.ndarray,
    rects: np.ndarray,
    qg_off: np.ndarray,
    qs: np.ndarray,
    gs: np.ndarray,
    counts: np.ndarray,
    caps: np.ndarray,
    out: np.ndarray,
    out_off: np.ndarray,
    sizes: np.ndarray,
    wavelet: Wavelet,
    wrap: Wrap,
    color: Color,
    discard_non_visible: bool = False,
) -> None:
    """Encode a SPAN of tiles in one native call
    (akort_tile_encode_spans): the C side gathers each rect out of the
    interleaved u8 image, runs format + lift + entropy, and writes the
    framed block (4-byte head + payload) at out[out_off[i]], recording
    payload bytes in sizes[i] (0 = incompressible). All per-tile arrays
    come from encode._host_span_plan (cached per geometry/settings);
    callers pass row-slices of them to split one image across the
    worker pool. Byte-identical to per-tile tile_encode_block calls."""
    lib = load()
    n = rects.shape[0]
    rc = lib.akort_tile_encode_spans(
        image.ctypes.data,
        image.strides[0],
        image.shape[2],
        int(wavelet),
        int(wrap),
        int(color),
        1 if discard_non_visible else 0,
        n,
        rects.ctypes.data,
        qg_off.ctypes.data,
        qs.ctypes.data if qs.size else None,
        gs.ctypes.data if gs.size else None,
        counts.ctypes.data,
        caps.ctypes.data,
        out.ctypes.data,
        out_off.ctypes.data,
        sizes.ctypes.data,
    )
    if rc != 0:
        raise AkoError(Status.ERROR, f"native span encode rc={rc}")


def tile_decode_spans(
    blob: np.ndarray,
    pay_off: np.ndarray,
    pay_size: np.ndarray,
    counts: np.ndarray,
    caps: np.ndarray,
    rects: np.ndarray,
    image_out: np.ndarray,
    wavelet: Wavelet,
    wrap: Wrap,
    color: Color,
) -> int:
    """Decode a SPAN of tiles in one native call
    (akort_tile_decode_spans): each payload at blob[pay_off[i]] is
    entropy-decoded + unlifted + color-inverted straight into the
    interleaved u8 image at its rect (spans over disjoint rects run
    concurrently against the same buffer). Returns 0 on success, the
    1-based index of the first broken tile in THIS span, or raises on
    allocation failure."""
    lib = load()
    n = rects.shape[0]
    rc = lib.akort_tile_decode_spans(
        blob.ctypes.data,
        pay_off.ctypes.data,
        pay_size.ctypes.data,
        counts.ctypes.data,
        caps.ctypes.data,
        n,
        rects.ctypes.data,
        image_out.strides[0],
        image_out.shape[2],
        int(wavelet),
        int(wrap),
        int(color),
        image_out.ctypes.data,
    )
    if rc == -2:
        raise AkoError(Status.ERROR, "native span decode: allocation failure")
    return rc
