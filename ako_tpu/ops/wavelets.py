"""Separable integer lifting kernels as vectorized XLA programs.

Each 1-D pass operates on a whole 2-D (or batched N-D) plane at once:
the scalar row/column loops of the reference
(library/wavelet-{cdf53,dd137,haar}.c) become static strided slices +
fused elementwise VPU ops, with the wrap-mode boundary handling
expressed as per-edge substitutions. Arithmetic is int32 with an int16
cast at every point where the reference stores to a coefficient array,
so results are bit-exact including int16 wraparound.

Lift formulas (Adams 2002 lifting forms, as used by the reference):
  CDF 5/3 : hp = odd - (even + even+1)/2 ; lp = even + (hp-1 + hp)/4
  DD 13/7 : hp = odd + (even-1 + even+2 - 9(even + even+1))/16
            lp = even + (-hp-2 - hp+1 + 9(hp-1 + hp))/32
  Haar    : lp = even ; hp = odd - even
with all divisions truncating toward zero.

H passes run along the last axis (lanes), V passes along the
second-to-last (sublanes) — no transposes anywhere.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ako_tpu.core.settings import Wavelet, Wrap
from ako_tpu.ops.intmath import div2, div4, div16, div32, i16, i32

# Axis conventions: the lifted axis is passed as -1 (H) or -2 (V).
#
# Every boundary-substituting shift optionally takes `axis_name`: when
# set (inside shard_map, the lifted axis sharded over that mesh axis)
# the edge values come from the neighboring shard via a cyclic
# lax.ppermute — the halo exchange between devices — and the wrap
# substitution applies only on the true global edge (first/last shard).
# A cyclic permute hands shard 0 the *last* shard's edge, which is
# exactly the REPEAT wrap value, so that mode needs no correction.


def _sl(x, lo, hi, axis):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(lo, hi)
    return x[tuple(idx)]


def _stride2(x, start, axis):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, None, 2)
    return x[tuple(idx)]


def _zeros_like_edge(x, axis, n=1):
    return jnp.zeros_like(_sl(x, 0, n, axis))


def _ppermute_to_next(x, axis_name):
    """Cyclic shift: every shard receives its *previous* shard's x."""
    n = lax.psum(1, axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    return lax.ppermute(x, axis_name, perm)


def _ppermute_to_prev(x, axis_name):
    """Cyclic shift: every shard receives its *next* shard's x."""
    n = lax.psum(1, axis_name)
    perm = [(i, (i - 1) % n) for i in range(n)]
    return lax.ppermute(x, axis_name, perm)


def _is_first(axis_name):
    return lax.axis_index(axis_name) == 0


def _is_last(axis_name):
    return lax.axis_index(axis_name) == lax.psum(1, axis_name) - 1


def _edge_select(on_edge, edge_val, halo_val):
    return jnp.where(on_edge, edge_val, halo_val)


def _shift_prev(x, axis, wrap, axis_name=None):
    """y[i] = x[i-1]; y[0] per wrap: CLAMP/MIRROR -> x[0], REPEAT -> x[-1],
    ZERO -> 0. (The reference uses the same first-tap substitution for
    CLAMP and MIRROR on +-1 neighbors.)"""
    if axis_name is not None:
        halo = _ppermute_to_next(_sl(x, -1, None, axis), axis_name)
        if wrap == Wrap.REPEAT:
            head = halo  # cyclic permute == global wrap-around
        elif wrap == Wrap.ZERO:
            head = _edge_select(_is_first(axis_name), _zeros_like_edge(x, axis), halo)
        else:  # CLAMP, MIRROR
            head = _edge_select(_is_first(axis_name), _sl(x, 0, 1, axis), halo)
    elif wrap == Wrap.REPEAT:
        head = _sl(x, -1, None, axis)
    elif wrap == Wrap.ZERO:
        head = _zeros_like_edge(x, axis)
    else:  # CLAMP, MIRROR
        head = _sl(x, 0, 1, axis)
    return jnp.concatenate([head, _sl(x, 0, -1, axis)], axis=axis)


def _shift_next(x, axis, wrap, axis_name=None):
    """y[i] = x[i+1]; y[-1] per wrap: CLAMP/MIRROR -> x[-1],
    REPEAT -> x[0], ZERO -> 0."""
    if axis_name is not None:
        halo = _ppermute_to_prev(_sl(x, 0, 1, axis), axis_name)
        if wrap == Wrap.REPEAT:
            tail = halo
        elif wrap == Wrap.ZERO:
            tail = _edge_select(_is_last(axis_name), _zeros_like_edge(x, axis), halo)
        else:
            tail = _edge_select(_is_last(axis_name), _sl(x, -1, None, axis), halo)
    elif wrap == Wrap.REPEAT:
        tail = _sl(x, 0, 1, axis)
    elif wrap == Wrap.ZERO:
        tail = _zeros_like_edge(x, axis)
    else:
        tail = _sl(x, -1, None, axis)
    return jnp.concatenate([_sl(x, 1, None, axis), tail], axis=axis)


def _shift_prev2(x, axis, wrap, axis_name=None):
    """y[i] = x[i-2]; first two per the reference's second-tap rules:
    CLAMP -> x[0], x[0]; MIRROR -> x[1], x[2]; REPEAT -> x[-2], x[-1];
    ZERO -> 0 (wavelet-dd137.c first-values cases)."""
    if axis_name is not None:
        halo = _ppermute_to_next(_sl(x, -2, None, axis), axis_name)
        if wrap == Wrap.REPEAT:
            head = halo
        else:
            if wrap == Wrap.CLAMP:
                edge = jnp.concatenate([_sl(x, 0, 1, axis)] * 2, axis=axis)
            elif wrap == Wrap.MIRROR:
                edge = _sl(x, 1, 3, axis)
            else:
                edge = _zeros_like_edge(x, axis, 2)
            head = _edge_select(_is_first(axis_name), edge, halo)
    elif wrap == Wrap.CLAMP:
        head = jnp.concatenate([_sl(x, 0, 1, axis)] * 2, axis=axis)
    elif wrap == Wrap.MIRROR:
        head = _sl(x, 1, 3, axis)
    elif wrap == Wrap.REPEAT:
        head = _sl(x, -2, None, axis)
    else:
        head = _zeros_like_edge(x, axis, 2)
    return jnp.concatenate([head, _sl(x, 0, -2, axis)], axis=axis)


def _shift_next2(x, axis, wrap, axis_name=None):
    """y[i] = x[i+2]; last two per the reference's second-tap rules:
    CLAMP -> x[-1], x[-1]; MIRROR -> x[-3], x[-2]; REPEAT -> x[0], x[1];
    ZERO -> 0."""
    if axis_name is not None:
        halo = _ppermute_to_prev(_sl(x, 0, 2, axis), axis_name)
        if wrap == Wrap.REPEAT:
            tail = halo
        else:
            if wrap == Wrap.CLAMP:
                edge = jnp.concatenate([_sl(x, -1, None, axis)] * 2, axis=axis)
            elif wrap == Wrap.MIRROR:
                edge = _sl(x, -3, -1, axis)
            else:
                edge = _zeros_like_edge(x, axis, 2)
            tail = _edge_select(_is_last(axis_name), edge, halo)
    elif wrap == Wrap.CLAMP:
        tail = jnp.concatenate([_sl(x, -1, None, axis)] * 2, axis=axis)
    elif wrap == Wrap.MIRROR:
        tail = _sl(x, -3, -1, axis)
    elif wrap == Wrap.REPEAT:
        tail = _sl(x, 0, 2, axis)
    else:
        tail = _zeros_like_edge(x, axis, 2)
    return jnp.concatenate([_sl(x, 2, None, axis), tail], axis=axis)


def _interleave(ev, od, axis):
    """Merge even/odd slots along `axis`; od may be one element shorter
    (the dropped fake slot)."""
    ax = axis % ev.ndim
    n_ev = ev.shape[ax]
    n_od = od.shape[ax]
    if n_ev == n_od:
        stacked = jnp.stack([ev, od], axis=ax + 1)
        new_shape = ev.shape[:ax] + (2 * n_ev,) + ev.shape[ax + 1 :]
        return stacked.reshape(new_shape)
    # odd output length: interleave the first n_od pairs, append last even
    body = _interleave(_sl(ev, 0, n_od, axis), od, axis)
    return jnp.concatenate([body, _sl(ev, -1, None, axis)], axis=axis)


# ---------------------------------------------------------------------
# Forward lifting


def lift_core(wavelet: Wavelet, wrap: Wrap, ev, od, axis: int,
              axis_name: str | None = None):
    """Forward lift formulas on pre-split even/odd streams (int32),
    shifts along `axis`; returns (lp, hp) int16."""
    if wavelet == Wavelet.HAAR:
        return i16(ev), i16(od - ev)

    if wavelet == Wavelet.CDF53:
        ev_p1 = _shift_next(ev, axis, wrap, axis_name)
        hp = i16(od - div2(ev + ev_p1))
        hp32 = i32(hp)
        hp_l1 = _shift_prev(hp32, axis, wrap, axis_name)
        lp = i16(ev + div4(hp_l1 + hp32))
        return lp, hp

    # DD 13/7
    ev_l1 = _shift_prev(ev, axis, wrap, axis_name)
    ev_p1 = _shift_next(ev, axis, wrap, axis_name)
    ev_p2 = _shift_next2(ev, axis, wrap, axis_name)
    hp = i16(od + div16(ev_l1 + ev_p2 - 9 * (ev + ev_p1)))
    hp32 = i32(hp)
    hp_l1 = _shift_prev(hp32, axis, wrap, axis_name)
    hp_p1 = _shift_next(hp32, axis, wrap, axis_name)
    hp_l2 = _shift_prev2(hp32, axis, wrap, axis_name)
    lp = i16(ev + div32(-hp_l2 - hp_p1 + 9 * (hp_l1 + hp32)))
    return lp, hp


def lift1d(wavelet: Wavelet, wrap: Wrap, x, fake_last: int, axis: int,
           axis_name: str | None = None):
    """One forward lift along `axis`. x is int16 of even-or-odd length
    2t - fake_last; returns (lp, hp), each int16 of length t.

    A fake trailing odd sample equal to the last even is fabricated when
    the source length is odd (library/lifting.c:46-47). With `axis_name`
    the lifted axis is sharded over that mesh axis and edge taps ride a
    ppermute halo exchange (fake_last must be 0 then)."""
    assert not (axis_name and fake_last), "sharded lift requires even length"
    ev = i32(_stride2(x, 0, axis))
    od = i32(_stride2(x, 1, axis))
    if fake_last:
        od = jnp.concatenate([od, _sl(ev, -1, None, axis)], axis=axis)
    return lift_core(wavelet, wrap, ev, od, axis, axis_name)


def lift2d(wavelet_eff: Wavelet, wrap: Wrap, x, level):
    """One full 2-D lift step on plane(s) x of shape (..., current_h,
    current_w) int16. Returns quadrants (ll, b, c, d), each
    (..., target_h, target_w) int16: b/c/d are the horizontal-detail,
    vertical-detail and diagonal quadrants in the reference's naming
    (library/lifting.c:250-263).

    Matches sLift2d (library/lifting.c:43-76): H pass first (with a
    duplicated last row when current_h is odd), then V pass."""
    if level.fake_last_row:
        x = jnp.concatenate([x, _sl(x, -1, None, -2)], axis=-2)
    lp_h, hp_h = lift1d(wavelet_eff, wrap, x, level.fake_last_col, axis=-1)
    ll, c = lift1d(wavelet_eff, wrap, _restripe(lp_h), 0, axis=-2)
    b, d = lift1d(wavelet_eff, wrap, _restripe(hp_h), 0, axis=-2)
    return ll, b, c, d


def _restripe(x):
    # hook for layout experiments; identity for now
    return x


# ---------------------------------------------------------------------
# Inverse lifting


def unlift1d_pair(wavelet: Wavelet, wrap: Wrap, lp, hp, axis: int,
                  axis_name: str | None = None):
    """Inverse lift along `axis`: returns (evens, odds), each the same
    length as lp/hp, int16. Interleaving/truncation is the caller's
    concern (the V pass keeps them separate, the H pass merges)."""
    lp32 = i32(lp)
    hp32 = i32(hp)

    if wavelet == Wavelet.HAAR:
        return i16(lp32), i16(lp32 + hp32)

    if wavelet == Wavelet.CDF53:
        hp_l1 = _shift_prev(hp32, axis, wrap, axis_name)
        ev = i16(lp32 - div4(hp_l1 + hp32))
        ev32 = i32(ev)
        ev_p1 = _shift_next(ev32, axis, wrap, axis_name)
        od = i16(hp32 + div2(ev32 + ev_p1))
        return ev, od

    hp_l1 = _shift_prev(hp32, axis, wrap, axis_name)
    hp_p1 = _shift_next(hp32, axis, wrap, axis_name)
    hp_l2 = _shift_prev2(hp32, axis, wrap, axis_name)
    ev = i16(lp32 - div32(-hp_l2 - hp_p1 + 9 * (hp_l1 + hp32)))
    ev32 = i32(ev)
    ev_l1 = _shift_prev(ev32, axis, wrap, axis_name)
    ev_p1 = _shift_next(ev32, axis, wrap, axis_name)
    ev_p2 = _shift_next2(ev32, axis, wrap, axis_name)
    od = i16(hp32 - div16(ev_l1 + ev_p2 - 9 * (ev32 + ev_p1)))
    return ev, od


def unlift2d(wavelet_eff: Wavelet, wrap: Wrap, ll, b, c, d, level):
    """Inverse of lift2d: quadrants (..., hp_h, hp_w) -> plane
    (..., current_h, current_w) int16.

    Mirrors s2dUnliftHp (library/lifting.c:104-148): two V unlifts
    (left half from ll/c, right half from b/d), then H unlifts for the
    even and odd row streams, dropping the fake last column/row."""
    ignore_col = level.fake_last_col
    ignore_row = level.fake_last_row

    ev_l, od_l = unlift1d_pair(wavelet_eff, wrap, ll, c, axis=-2)
    ev_r, od_r = unlift1d_pair(wavelet_eff, wrap, b, d, axis=-2)

    rows_even = _unlift_h_merge(wavelet_eff, wrap, ev_l, ev_r, ignore_col)
    if ignore_row:
        od_l = _sl(od_l, 0, -1, -2)
        od_r = _sl(od_r, 0, -1, -2)
    rows_odd = _unlift_h_merge(wavelet_eff, wrap, od_l, od_r, ignore_col)

    return _interleave(rows_even, rows_odd, axis=-2)


def _unlift_h_merge(wavelet_eff, wrap, lp, hp, ignore_last):
    ev, od = unlift1d_pair(wavelet_eff, wrap, lp, hp, axis=-1)
    if ignore_last:
        od = _sl(od, 0, -1, -1)
    return _interleave(ev, od, axis=-1)


def effective_wavelet(wavelet: Wavelet, target_w: int, target_h: int) -> Wavelet:
    """Levels smaller than 8x8 always use CDF 5/3 in DD137 mode
    (library/lifting.c:58,126). Haar never falls back."""
    if wavelet == Wavelet.DD137 and (target_w < 8 or target_h < 8):
        return Wavelet.CDF53
    return wavelet
