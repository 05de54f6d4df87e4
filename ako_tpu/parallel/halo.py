"""Sharded-single-tile lifting: halo exchange over the mesh.

One tile's planes are sharded by *rows* over a 1-D mesh axis; each
dyadic lift level runs as shard_map programs in which the H pass is
purely local and the V pass's boundary taps arrive from the
neighboring shard via a cyclic `lax.ppermute` (1 row each way for
CDF 5/3, 2 rows for DD 13/7 — see ops/wavelets.py). Results are
bit-exact with the single-chip path: the halo rows are precisely the
values the wrap-mode substitutions would have read, and a cyclic
permute delivers the REPEAT wrap value for free on the edge shards.

Levels whose row count is not divisible by the shard count (odd
plus-one-rule dims, ragged pyramids) are handled by PAD + CRAFT: the
V-pass input is padded to equal per-shard blocks and the pad rows are
*constructed* so that the generic sharded stencil reads exactly the
values the wrap-mode substitutions would have produced at the TRUE
boundary — including the nonlinear (truncating-division) hp chain,
whose first pad value is synthesized from the last valid rows so the
int16 modular arithmetic cancels (`_pad_*` below). This covers CLAMP
and ZERO wraps (and Haar under every wrap: its lifting reads no
neighbors). MIRROR/REPEAT levels with a remainder shard by PAD + FIX:
their edge substitutions read *position-varying* rows (x[1],x[2] /
x[-3],x[-2] / x[0],x[1]) that no value-only pad can express, so the
sharded stencil runs over zero pads and the handful of boundary
outputs it contaminates — the last 1-3 valid rows, plus the first 0-3
under REPEAT, whose cyclic-permute head halo reads the pad garbage —
are overwritten with the true-boundary formulas computed globally from
edge-row slices (`_fix_fwd`/`_fix_inv`; O(w) work vs the level's
O(h·w)). A fake plus-one-rule row is materialized before padding, so
odd-height levels shard too.

The residual small levels (a few KB) run replicated — the classic
coarse-level gather of parallel wavelet transforms. `plan_levels`
reports statically how many levels shard for a given schedule/mesh;
tests assert the count so a planner regression can never silently
replicate everything (tests/test_parallel.py). This is the
multi-device design the reference has no counterpart for (SURVEY.md §2.4.2;
reference tiles are independent, library/encode.c:115)."""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ako_tpu.core.geometry import LiftLevel, LiftSchedule
from ako_tpu.core.settings import Wavelet, Wrap
from ako_tpu.ops.intmath import div2, div4, div16, div32, i16, i32
from ako_tpu.ops.lifting import _quantize_gate
from ako_tpu.ops.wavelets import (
    _interleave,
    _sl,
    effective_wavelet,
    lift1d,
    unlift1d_pair,
)

# Minimum evens a shard must keep for the DD137 V-stencil's MIRROR /
# second-tap substitutions and ppermute halo slices to stay local.
_MIN_LOCAL_EVENS = 4


class _Plan(NamedTuple):
    m: int  # evens per shard (local rows = 2m)
    pad_pairs: int  # (even, odd) pad pairs appended after the valid 2T rows


def _shard_plan(lvl: LiftLevel, n: int) -> Optional[_Plan]:
    """Wrap- and wavelet-independent since r5: every ragged level
    shards (CLAMP/ZERO via crafted pads, MIRROR/REPEAT via pad+fix,
    Haar trivially); only the minimum-local-evens bound replicates."""
    T = lvl.target_h
    m = -(-T // n)
    if m < _MIN_LOCAL_EVENS:
        return None
    return _Plan(m, m * n - T)


def _needs_fix(pad_pairs: int, wrap: Wrap, weff: Wavelet) -> bool:
    """Ragged MIRROR/REPEAT levels take the pad+fix path (module
    docstring); CLAMP/ZERO take crafted pads, Haar reads no neighbors."""
    return (
        pad_pairs > 0
        and weff != Wavelet.HAAR
        and wrap in (Wrap.MIRROR, Wrap.REPEAT)
    )


def plan_levels(
    schedule: LiftSchedule, n_shards: int, wavelet: Wavelet, wrap: Wrap
) -> List[bool]:
    """Static per-level shard decision for a schedule on an
    `n_shards`-way row mesh — True where the level's V pass runs
    sharded. Mirrors forward_tile_sharded's planning exactly (the
    forward stays sharded monotonically; once a level replicates, the
    smaller remainder stays replicated)."""
    out = []
    sharded = True
    for lvl in schedule.levels:
        weff = effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
        sharded = sharded and _shard_plan(lvl, n_shards) is not None
        out.append(sharded)
    return out


def _rows(x, lo, hi):
    return _sl(x, lo, hi, -2)


def _pad_fwd(arr, T: int, pad_pairs: int, wrap: Wrap, weff: Wavelet):
    """Append 2*pad_pairs crafted rows to the (..., 2T, w) V-input so
    the generic sharded stencil reproduces the true-edge wrap
    substitutions bit-exactly (module docstring). Derivations:

    CLAMP  — even taps past the edge read e_{T-1}: pad evens with it.
      DD137's lp additionally reads hp_{T+j}; the stencil computes
      hp_pad_j = o_pad_j + div16(-16·e_{T-1}) = o_pad_j − e_{T-1}
      (exact: a multiple of 16), so o_pad = hp_{T-1} + e_{T-1} makes
      every pad hp equal hp_{T-1}, the CLAMP substitution value; the
      int16 store of the sum wraps, and the later subtraction of
      e_{T-1} wraps it back.
    ZERO   — even taps read 0: zero pad evens. DD137 pad 0's hp sees
      ev_l1 = e_{T-1}, rest 0, so o_pad0 = −div16(e_{T-1}) cancels it;
      later pads see only zeros.
    HAAR   — no neighbor taps at all; pad values are never read by
      valid outputs."""
    if pad_pairs == 0:
        return arr
    last_e = _rows(arr, 2 * T - 2, 2 * T - 1)
    zero = jnp.zeros_like(last_e)
    if weff == Wavelet.HAAR:
        rows = [zero] * (2 * pad_pairs)
    elif wrap == Wrap.CLAMP:
        if weff == Wavelet.DD137:
            o_last = i32(_rows(arr, 2 * T - 1, 2 * T))
            e_last = i32(last_e)
            e_prev = i32(_rows(arr, 2 * T - 4, 2 * T - 3))
            hp_last = i16(o_last + div16(e_prev - 17 * e_last))
            po = i16(i32(hp_last) + e_last)
        else:  # CDF53: lp never reads forward hp taps
            po = last_e
        rows = [last_e, po] * pad_pairs
    else:  # ZERO
        if weff == Wavelet.DD137:
            po0 = i16(-div16(i32(last_e)))
        else:
            po0 = zero
        rows = [zero, po0] + [zero, zero] * (pad_pairs - 1)
    return jnp.concatenate([arr] + rows, axis=-2)


def _pad_inv(ll, c, T: int, pad_pairs: int, wrap: Wrap, weff: Wavelet):
    """Pad one (lp-quadrant, hp-quadrant) pair of the inverse V pass
    from T to T+pad_pairs rows. hp pads are read directly (CLAMP →
    copies of hp_{T-1}, ZERO/HAAR → zeros); lp pads are crafted so the
    *computed* pad evens equal the even-tap substitution values
    (ev_{T-1} for CLAMP, 0 for ZERO), with the same truncating-division
    cancellation as the forward (derivations in the forward's twin;
    the DD137/ZERO case needs a distinct second pad: pad 1's hp_l2 tap
    still reaches the last valid hp row)."""
    if pad_pairs == 0:
        return ll, c
    hp1 = _rows(c, T - 1, T)  # hp_{T-1}
    zero = jnp.zeros_like(hp1)
    if weff == Wavelet.HAAR:
        lp_pads = [zero] * pad_pairs
        hp_pads = [zero] * pad_pairs
    elif wrap == Wrap.CLAMP:
        hp_pads = [hp1] * pad_pairs
        lp1 = i32(_rows(ll, T - 1, T))
        h1 = i32(hp1)
        h2 = i32(_rows(c, T - 2, T - 1))
        if weff == Wavelet.DD137:
            h3 = i32(_rows(c, T - 3, T - 2))
            ev_last = i32(i16(lp1 - div32(8 * h1 + 9 * h2 - h3)))
            # pad j >= 1 sees hp taps (-h1 - h1 + 9(h1 + h1)) = 16*h1;
            # keep the exact truncating div32, NOT h1/2 algebra
            lp_pads = [i16(ev_last + div32(17 * h1 - h2))] + [
                i16(ev_last + div32(16 * h1))
            ] * (pad_pairs - 1)
        else:  # CDF53
            ev_last = i32(i16(lp1 - div4(h2 + h1)))
            lp_pads = [i16(ev_last + div4(2 * h1))] * pad_pairs
    else:  # ZERO
        hp_pads = [zero] * pad_pairs
        h1 = i32(hp1)
        h2 = i32(_rows(c, T - 2, T - 1))
        if weff == Wavelet.DD137:
            lp_pads = [i16(div32(9 * h1 - h2))]
            if pad_pairs > 1:
                lp_pads.append(i16(div32(-h1)))
            lp_pads += [zero] * (pad_pairs - 2)
        else:  # CDF53
            lp_pads = [i16(div4(h1))] + [zero] * (pad_pairs - 1)
    ll_p = jnp.concatenate([ll] + lp_pads[:pad_pairs], axis=-2)
    c_p = jnp.concatenate([c] + hp_pads[:pad_pairs], axis=-2)
    return ll_p, c_p


def _row32(x, j: int):
    return i32(_rows(x, j, j + 1))


def _splice(arr, fixes):
    """Overwrite rows of arr (..., T, w) per {index: new_row} with
    static concatenation (indices known at trace time)."""
    T = arr.shape[-2]
    idxs = sorted(fixes)
    parts, lo = [], 0
    for j in idxs:
        if j > lo:
            parts.append(_rows(arr, lo, j))
        parts.append(i16(fixes[j]))
        lo = j + 1
    if lo < T:
        parts.append(_rows(arr, lo, T))
    return jnp.concatenate(parts, axis=-2)


def _fix_fwd(weff: Wavelet, wrap: Wrap, x, lp, hp, T: int):
    """True-boundary overwrite for the forward V pass of a ragged
    MIRROR/REPEAT level. x: the V-pass input (first 2T rows = the true
    domain, evens at 2j, odds at 2j+1); lp/hp: the sharded outputs
    sliced to T rows, contaminated only at the tail (taps past row
    2T-1 read pads instead of the wrap substitutions) and, for REPEAT,
    the head (the cyclic ppermute delivers the last shard's pad rows
    where the true wrap reads rows T-1/T-2). Substitution rows per
    wrap follow the reference's second-tap rules
    (/root/reference/library/wavelet-dd137.c:74-126)."""
    ev = lambda j: _row32(x, 2 * j)
    od = lambda j: _row32(x, 2 * j + 1)
    h = lambda j: _row32(hp, j)
    rep = wrap == Wrap.REPEAT

    if weff == Wavelet.CDF53:
        s1 = ev(0) if rep else ev(T - 1)
        hp_t1 = i32(i16(od(T - 1) - div2(ev(T - 1) + s1)))
        lp_t1 = ev(T - 1) + div4(h(T - 2) + hp_t1)
        hp_fix = {T - 1: hp_t1}
        lp_fix = {T - 1: lp_t1}
        if rep:
            lp_fix[0] = ev(0) + div4(hp_t1 + h(0))
        return _splice(lp, lp_fix), _splice(hp, hp_fix)

    # DD137
    s1 = ev(0) if rep else ev(T - 1)
    s2a = ev(0) if rep else ev(T - 3)  # +2 tap at row T-2
    s2b = ev(1) if rep else ev(T - 2)  # +2 tap at row T-1
    hp_t2 = i32(i16(od(T - 2) + div16(ev(T - 3) + s2a - 9 * (ev(T - 2) + ev(T - 1)))))
    hp_t1 = i32(i16(od(T - 1) + div16(ev(T - 2) + s2b - 9 * (ev(T - 1) + s1))))
    if rep:  # REPEAT's head hp is itself contaminated (prev tap rides
        # the cyclic permute into the pads) and feeds lp_t1's +1 tap
        hp_0 = i32(i16(od(0) + div16(ev(T - 1) + ev(2) - 9 * (ev(0) + ev(1)))))
        hs1 = hp_0  # +1 hp tap at row T-1 wraps to row 0
    else:
        hs1 = hp_t1  # MIRROR's +-1 tap clamps to the last row
    lp_t3 = ev(T - 3) + div32(-h(T - 5) - hp_t2 + 9 * (h(T - 4) + h(T - 3)))
    lp_t2 = ev(T - 2) + div32(-h(T - 4) - hp_t1 + 9 * (h(T - 3) + hp_t2))
    lp_t1 = ev(T - 1) + div32(-h(T - 3) - hs1 + 9 * (hp_t2 + hp_t1))
    hp_fix = {T - 2: hp_t2, T - 1: hp_t1}
    lp_fix = {T - 3: lp_t3, T - 2: lp_t2, T - 1: lp_t1}
    if rep:
        hp_fix[0] = hp_0
        lp_fix[0] = ev(0) + div32(-hp_t2 - h(1) + 9 * (hp_t1 + hp_0))
        lp_fix[1] = ev(1) + div32(-hp_t1 - h(2) + 9 * (hp_0 + h(1)))
        lp_fix[2] = ev(2) + div32(-hp_0 - h(3) + 9 * (h(1) + h(2)))
    return _splice(lp, lp_fix), _splice(hp, hp_fix)


def _fix_inv(weff: Wavelet, wrap: Wrap, lp, hp, ev, od, T: int):
    """Inverse twin of _fix_fwd: lp/hp are one dequantized quadrant
    pair (T rows each, the sharded V-unlift's true-domain inputs);
    ev/od its outputs sliced to T rows. Returns the corrected
    (ev, od)."""
    L = lambda j: _row32(lp, j)
    H = lambda j: _row32(hp, j)
    rep = wrap == Wrap.REPEAT

    if weff == Wavelet.CDF53:
        ev_fix = {}
        if rep:
            ev_fix[0] = L(0) - div4(H(T - 1) + H(0))
        evf = _splice(ev, ev_fix) if ev_fix else ev
        E = lambda j: _row32(evf, j)
        s1 = E(0) if rep else E(T - 1)
        od_fix = {T - 1: H(T - 1) + div2(E(T - 1) + s1)}
        if rep:
            od_fix[0] = H(0) + div2(E(0) + E(1))
        return evf, _splice(od, od_fix)

    # DD137
    hs1 = H(0) if rep else H(T - 1)
    ev_fix = {
        T - 1: L(T - 1) - div32(-H(T - 3) - hs1 + 9 * (H(T - 2) + H(T - 1)))
    }
    if rep:
        ev_fix[0] = L(0) - div32(-H(T - 2) - H(1) + 9 * (H(T - 1) + H(0)))
        ev_fix[1] = L(1) - div32(-H(T - 1) - H(2) + 9 * (H(0) + H(1)))
    evf = _splice(ev, ev_fix)
    E = lambda j: _row32(evf, j)
    s1 = E(0) if rep else E(T - 1)
    s2a = E(0) if rep else E(T - 3)
    s2b = E(1) if rep else E(T - 2)
    od_fix = {
        T - 3: H(T - 3) - div16(E(T - 4) + E(T - 1) - 9 * (E(T - 3) + E(T - 2))),
        T - 2: H(T - 2) - div16(E(T - 3) + s2a - 9 * (E(T - 2) + E(T - 1))),
        T - 1: H(T - 1) - div16(E(T - 2) + s2b - 9 * (E(T - 1) + s1)),
    }
    if rep:
        od_fix[0] = H(0) - div16(E(T - 1) + E(2) - 9 * (E(0) + E(1)))
        od_fix[1] = H(1) - div16(E(0) + E(3) - 9 * (E(1) + E(2)))
        od_fix[2] = H(2) - div16(E(1) + E(4) - 9 * (E(2) + E(3)))
    return evf, _splice(od, od_fix)


def _v_lift_local(weff: Wavelet, wrap: Wrap, axis_name: str, x):
    return lift1d(weff, wrap, x, 0, axis=-2, axis_name=axis_name)


def _v_unlift_local(
    weff: Wavelet,
    wrap: Wrap,
    axis_name: str,
    ignore_col: bool,
    ll,
    b,
    c,
    d,
):
    """shard_map body for the inverse level: V unlifts with halo
    exchange, then the row-local H merges and the even/odd interleave
    (pairs stay shard-local: every shard holds an even row count)."""
    ev_l, od_l = unlift1d_pair(weff, wrap, ll, c, axis=-2, axis_name=axis_name)
    ev_r, od_r = unlift1d_pair(weff, wrap, b, d, axis=-2, axis_name=axis_name)

    def merge(lp, hp):
        ev, od = unlift1d_pair(weff, wrap, lp, hp, axis=-1)
        if ignore_col:
            od = _sl(od, 0, -1, -1)
        return _interleave(ev, od, axis=-1)

    return _interleave(merge(ev_l, ev_r), merge(od_l, od_r), axis=-2)


def forward_tile_sharded(
    planes,
    schedule: LiftSchedule,
    wavelet: Wavelet,
    wrap: Wrap,
    qg: Sequence[Tuple[Tuple[int, ...], Tuple[int, ...]]],
    mesh: Mesh,
    axis_name: str = "rows",
):
    """Row-sharded forward_tile: planes (channels, tile_h, tile_w)
    int16 -> serialized stream (coeff_count,) int16, identical to
    ops.lifting.forward_tile's output."""
    n = mesh.shape[axis_name]
    channels = planes.shape[-3]
    row_spec = P(None, axis_name, None)
    row_sh = NamedSharding(mesh, row_spec)
    replicated = NamedSharding(mesh, P())

    level_chunks: List[jnp.ndarray] = []
    cur = planes
    sharded = True

    for lvl, (qs, gs) in zip(schedule.levels, qg):
        weff = effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
        plan = _shard_plan(lvl, n) if sharded else None
        if plan is not None:
            T = lvl.target_h
            x = cur
            if lvl.fake_last_row:
                x = jnp.concatenate([x, _rows(x, -1, None)], axis=-2)
            if plan.pad_pairs:
                z = jnp.zeros(
                    x.shape[:-2] + (2 * plan.pad_pairs, x.shape[-1]), x.dtype
                )
                x = jnp.concatenate([x, z], axis=-2)
            x = jax.lax.with_sharding_constraint(x, row_sh)
            h_lift = shard_map(
                lambda a: lift1d(weff, wrap, a, lvl.fake_last_col, axis=-1),
                mesh=mesh,
                in_specs=(row_spec,),
                out_specs=(row_spec,) * 2,
            )
            lp_h, hp_h = h_lift(x)
            fix = _needs_fix(plan.pad_pairs, wrap, weff)
            if plan.pad_pairs and not fix:
                # replace the garbage pad rows with the crafted values
                lp_h = _pad_fwd(_rows(lp_h, 0, 2 * T), T, plan.pad_pairs, wrap, weff)
                hp_h = _pad_fwd(_rows(hp_h, 0, 2 * T), T, plan.pad_pairs, wrap, weff)
                lp_h = jax.lax.with_sharding_constraint(lp_h, row_sh)
                hp_h = jax.lax.with_sharding_constraint(hp_h, row_sh)
            v_lift = shard_map(
                functools.partial(_v_lift_local, weff, wrap, axis_name),
                mesh=mesh,
                in_specs=(row_spec,),
                out_specs=(row_spec,) * 2,
            )
            ll, c = v_lift(lp_h)
            b, d = v_lift(hp_h)
            if plan.pad_pairs:
                ll, b = _rows(ll, 0, T), _rows(b, 0, T)
                c, d = _rows(c, 0, T), _rows(d, 0, T)
                if fix:  # MIRROR/REPEAT: zero pads + boundary overwrite
                    ll, c = _fix_fwd(weff, wrap, _rows(lp_h, 0, 2 * T), ll, c, T)
                    b, d = _fix_fwd(weff, wrap, _rows(hp_h, 0, 2 * T), b, d, T)
        else:
            if sharded:
                cur = jax.lax.with_sharding_constraint(cur, replicated)
                sharded = False
            from ako_tpu.ops.wavelets import lift2d

            ll, b, c, d = lift2d(weff, wrap, cur, lvl)

        q = jnp.asarray(qs, dtype=jnp.int32).reshape(channels, 1, 1)
        g = jnp.asarray(gs, dtype=jnp.int32).reshape(channels, 1, 1)
        cq = _quantize_gate(c, q, g).reshape(channels, -1)
        bq = _quantize_gate(b, q, g).reshape(channels, -1)
        dq = _quantize_gate(d, q, g).reshape(channels, -1)
        head = jnp.asarray(qs, dtype=jnp.int16).reshape(channels, 1)
        chunk = jnp.concatenate([head, cq, bq, dq], axis=-1)
        level_chunks.append(chunk.reshape(-1))
        cur = ll

    lp_flat = cur.reshape(-1)
    out = jnp.concatenate([lp_flat] + level_chunks[::-1], axis=-1)
    return jax.lax.with_sharding_constraint(out, replicated)


def inverse_tile_sharded(
    coeffs,
    schedule: LiftSchedule,
    wavelet: Wavelet,
    wrap: Wrap,
    channels: int,
    mesh: Mesh,
    axis_name: str = "rows",
):
    """Row-sharded inverse_tile: serialized stream -> planes
    (channels, tile_h, tile_w) int16, identical to
    ops.lifting.inverse_tile's output."""
    from ako_tpu.ops.intmath import i16 as _i16, i32 as _i32

    n = mesh.shape[axis_name]
    row_spec = P(None, axis_name, None)
    row_sh = NamedSharding(mesh, row_spec)

    lp_n = channels * schedule.lp_h * schedule.lp_w
    cur = coeffs[:lp_n].reshape(channels, schedule.lp_h, schedule.lp_w)
    off = lp_n

    for lvl in reversed(schedule.levels):
        hw, hh = lvl.target_w, lvl.target_h
        nvals = channels * (1 + 3 * hh * hw)
        chunk = coeffs[off : off + nvals].reshape(channels, 1 + 3 * hh * hw)
        off += nvals

        q = _i32(chunk[..., 0]).reshape(channels, 1, 1, 1)
        quads = chunk[..., 1:].reshape(channels, 3, hh, hw)
        dequant = jnp.where(q > 1, _i16(_i32(quads) * q), quads)
        c = dequant[..., 0, :, :]
        b = dequant[..., 1, :, :]
        d = dequant[..., 2, :, :]

        weff = effective_wavelet(wavelet, hw, hh)
        plan = _shard_plan(lvl, n)
        if plan is not None and _needs_fix(plan.pad_pairs, wrap, weff):
            # MIRROR/REPEAT ragged level: sharded V unlift over zero
            # pads, global boundary fix, then the row-local H merge
            def zpad(a):
                z = jnp.zeros(
                    a.shape[:-2] + (plan.pad_pairs, a.shape[-1]), a.dtype
                )
                return jax.lax.with_sharding_constraint(
                    jnp.concatenate([a, z], axis=-2), row_sh
                )

            v_unlift = shard_map(
                lambda lp, hp: unlift1d_pair(
                    weff, wrap, lp, hp, axis=-2, axis_name=axis_name
                ),
                mesh=mesh,
                in_specs=(row_spec,) * 2,
                out_specs=(row_spec,) * 2,
            )
            ev_l, od_l = v_unlift(zpad(cur), zpad(c))
            ev_r, od_r = v_unlift(zpad(b), zpad(d))
            ev_l, od_l = _rows(ev_l, 0, hh), _rows(od_l, 0, hh)
            ev_r, od_r = _rows(ev_r, 0, hh), _rows(od_r, 0, hh)
            ev_l, od_l = _fix_inv(weff, wrap, cur, c, ev_l, od_l, hh)
            ev_r, od_r = _fix_inv(weff, wrap, b, d, ev_r, od_r, hh)

            def merge(lp, hp):
                ev, od = unlift1d_pair(weff, wrap, lp, hp, axis=-1)
                if lvl.fake_last_col:
                    od = _sl(od, 0, -1, -1)
                return _interleave(ev, od, axis=-1)

            out = _interleave(merge(ev_l, ev_r), merge(od_l, od_r), axis=-2)
            cur = _rows(out, 0, lvl.current_h)
        elif plan is not None:
            if plan.pad_pairs:
                cur, c = _pad_inv(cur, c, hh, plan.pad_pairs, wrap, weff)
                b, d = _pad_inv(b, d, hh, plan.pad_pairs, wrap, weff)
            args = [
                jax.lax.with_sharding_constraint(a, row_sh)
                for a in (cur, b, c, d)
            ]
            f = shard_map(
                functools.partial(
                    _v_unlift_local,
                    weff,
                    wrap,
                    axis_name,
                    bool(lvl.fake_last_col),
                ),
                mesh=mesh,
                in_specs=(row_spec,) * 4,
                out_specs=row_spec,
            )
            out = f(*args)
            # drop pad rows and (when the height is odd) the fake odd
            # row in one slice
            cur = _rows(out, 0, lvl.current_h)
        else:
            from ako_tpu.ops.wavelets import unlift2d

            cur = unlift2d(weff, wrap, cur, b, c, d, lvl)

    return jax.lax.with_sharding_constraint(cur, NamedSharding(mesh, P()))
