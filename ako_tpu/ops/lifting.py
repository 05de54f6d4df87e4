"""Whole-tile dyadic lift/unlift pipelines (jittable, batched).

The reference's per-tile / per-level / per-channel scalar recursion
(library/lifting.c:171-304) becomes: a Python loop over the *static*
level schedule (one compiled XLA program per tile shape), with every
level processing all channels — and, via leading batch dims, all
same-shaped tiles — at once. Quantization + noise gate are fused into
the highpass write (library/lifting.c:154-168), and the output is the
serialized coefficient stream in exact wire order
(library/misc.c:229-288): LP planes per channel, then per level
small->large, per channel: [int16 q head][HP-C][HP-B][HP-D].
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax.numpy as jnp

from ako_tpu.core.geometry import LiftSchedule
from ako_tpu.core.settings import Wavelet, Wrap
from ako_tpu.ops.intmath import divt, i16, i32
from ako_tpu.ops.wavelets import effective_wavelet, lift2d, unlift2d


def _quantize_gate(x, q, g):
    """Fused dead-zone gate + truncating quantization on an int16
    quadrant; q/g broadcastable int32 (library/lifting.c:154-168)."""
    x32 = i32(x)
    keep = (x32 < -g) | (x32 > g)
    qb = jnp.broadcast_to(jnp.maximum(q, 1), x32.shape)  # lax.div needs equal ranks
    return i16(jnp.where(keep, divt(x32, qb), 0))


def forward_tile(
    planes,
    schedule: LiftSchedule,
    wavelet: Wavelet,
    wrap: Wrap,
    qg: Sequence[Tuple[Tuple[int, ...], Tuple[int, ...]]],
):
    """planes: (..., channels, tile_h, tile_w) int16 -> serialized
    coefficient stream (..., coeff_count) int16."""
    channels = planes.shape[-3]
    batch = planes.shape[:-3]

    level_chunks: List[jnp.ndarray] = []
    cur = planes
    for lvl, (qs, gs) in zip(schedule.levels, qg):
        weff = effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
        ll, b, c, d = lift2d(weff, wrap, cur, lvl)

        q = jnp.asarray(qs, dtype=jnp.int32).reshape(channels, 1, 1)
        g = jnp.asarray(gs, dtype=jnp.int32).reshape(channels, 1, 1)
        cq = _quantize_gate(c, q, g).reshape(batch + (channels, -1))
        bq = _quantize_gate(b, q, g).reshape(batch + (channels, -1))
        dq = _quantize_gate(d, q, g).reshape(batch + (channels, -1))

        head = jnp.broadcast_to(
            jnp.asarray(qs, dtype=jnp.int16).reshape(
                (1,) * len(batch) + (channels, 1)
            ),
            batch + (channels, 1),
        )
        chunk = jnp.concatenate([head, cq, bq, dq], axis=-1)
        level_chunks.append(chunk.reshape(batch + (-1,)))
        cur = ll

    lp_flat = cur.reshape(batch + (-1,))
    # wire order: LP planes first, then levels smallest -> largest
    return jnp.concatenate([lp_flat] + level_chunks[::-1], axis=-1)


def inverse_tile(
    coeffs,
    schedule: LiftSchedule,
    wavelet: Wavelet,
    wrap: Wrap,
    channels: int,
):
    """Serialized stream (..., coeff_count) int16 -> planes
    (..., channels, tile_h, tile_w) int16.

    Quantization heads are runtime data from the stream; inverse
    quantization is the int16-wrapping multiply of
    library/lifting.c:30-40, skipped for q <= 1."""
    batch = coeffs.shape[:-1]

    lp_n = channels * schedule.lp_h * schedule.lp_w
    cur = coeffs[..., :lp_n].reshape(batch + (channels, schedule.lp_h, schedule.lp_w))
    off = lp_n

    for lvl in reversed(schedule.levels):
        hw, hh = lvl.target_w, lvl.target_h
        n = channels * (1 + 3 * hh * hw)
        chunk = coeffs[..., off : off + n].reshape(batch + (channels, 1 + 3 * hh * hw))
        off += n

        q = i32(chunk[..., 0]).reshape(batch + (channels, 1, 1, 1))
        quads = chunk[..., 1:].reshape(batch + (channels, 3, hh, hw))
        dequant = jnp.where(q > 1, i16(i32(quads) * q), quads)
        c = dequant[..., 0, :, :]
        b = dequant[..., 1, :, :]
        d = dequant[..., 2, :, :]

        weff = effective_wavelet(wavelet, hw, hh)
        cur = unlift2d(weff, wrap, cur, b, c, d, lvl)

    return cur
