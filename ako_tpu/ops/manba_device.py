"""Device-side parallel Manbavaran (rANS) decoder.

The device mirror of akort.c:akort_manba_decode: every DECODE_BLOCK
outputs decode independently from a host sync record
(runtime.kagari.manba_sync -> akort_manba_sync), so the sequential
rANS state chain parallelizes over B lanes with a block-step scan —
the same architecture as the device Kagari decoder
(ops/kagari_device.py), with two windows per lane instead of one: the
rANS renormalization bytes and the extras bitstream both slice out of
the ONE dense uploaded word pool (payload bytes, big-endian words).

Per step each lane:
- resolves the symbol from the 12-bit slot against the tile's 17-entry
  cumulative table (unrolled compare-sum — no gathers in the loop),
- advances the rANS state and conditionally refills <= 2 bytes from
  the rans window (8-bit renorm with 12-bit probabilities never needs
  more),
- reads `sym` extras bits from the extras window and rebuilds the
  value exactly like the host decoder (code - 1 wraps 65536 -> the
  zigzag(-32768) case).

No reference counterpart: the reference reserves MANBAVARAN but never
implemented it (compression.c:39). Bit-exact with akort_manba_decode
(tests/test_manbavaran.py::TestDeviceDecoder).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ako_tpu.ops.kagari_device import DECODE_BLOCK, DECODE_SLACK_WORDS

__all__ = [
    "DECODE_BLOCK",
    "DECODE_SLACK_WORDS",  # shared pool-slack contract with the Kagari decoder
    "manba_decode_device",
    "span_words",
]

_PROB_BITS = 12
_PROB_MASK = (1 << _PROB_BITS) - 1
_STATE_LO = jnp.uint32(1 << 23)


def _win_init(words, bitpos, span):
    """Slice a (B, span) window starting at each lane's word, returning
    (hi, lo, rest, cur): the same one-gather window the Kagari decoder
    carries (kagari_device.kagari_decode_device)."""
    wcap = words.shape[0]
    word0 = (bitpos >> jnp.uint32(5)).astype(jnp.int32)
    cur = bitpos & jnp.uint32(31)
    idx = jnp.clip(
        word0[:, None] + jnp.arange(span, dtype=jnp.int32)[None, :], 0, wcap - 1
    )
    win = words[idx]
    return win[:, 0], win[:, 1], win[:, 2:], cur


def _win_refill(hi, lo, rest, cur):
    need = cur >= 32
    hi2 = jnp.where(need, lo, hi)
    lo2 = jnp.where(need, rest[:, 0], lo)
    rest2 = jnp.where(
        need[:, None],
        jnp.concatenate([rest[:, 1:], rest[:, :1] * 0], axis=1),
        rest,
    )
    return hi2, lo2, rest2, jnp.where(need, cur - 32, cur)


def _top32(hi, lo, cur):
    return jnp.where(
        cur == 0,
        hi,
        (hi << cur) | (lo >> jnp.minimum(jnp.uint32(32) - cur, jnp.uint32(31))),
    )


def span_words(byte_or_bit_offsets, end, bits: bool, slack: int = 3) -> int:
    """Max words any block's window touches, from consecutive sync
    offsets (byte offsets when bits=False). Mirror of
    kagari_device.decode_span_words for the two manba windows."""
    off = np.asarray(byte_or_bit_offsets, np.int64)
    if not bits:
        off = off * 8
        end = end * 8
    if off.size == 0:
        return slack
    ends = np.concatenate([off[1:], np.asarray([max(int(end), 1)], np.int64)])
    spans = (np.maximum(ends, off + 1) - 1) // 32 - off // 32 + 1
    return int(spans.max()) + slack


def manba_decode_device(
    words,
    x0,
    rbyte,
    ebit,
    freq,
    rans_end,
    extras_off,
    n_outputs: int,
    block: int = DECODE_BLOCK,
    rspan: int | None = None,
    espan: int | None = None,
    base=0,
):
    """Decode one tile's Manbavaran payload on device.

    words: (W,) uint32 dense big-endian word pool (payload bytes,
    word-aligned at `base`). x0/rbyte/ebit: (B,) sync records (byte/bit
    positions RELATIVE to the payload start / extras region start).
    freq: (17,) int32 symbol frequencies; rans_end / extras_off: scalar
    byte offsets relative to the payload start. Returns (n_outputs,)
    int16."""
    wcap = words.shape[0]
    rspan = max(3, min(rspan if rspan is not None else wcap, wcap))
    espan = max(3, min(espan if espan is not None else wcap, wcap))
    B = x0.shape[0]

    freq = freq.astype(jnp.uint32)
    cum = jnp.concatenate(
        [jnp.zeros((1,), jnp.uint32), jnp.cumsum(freq).astype(jnp.uint32)]
    )  # (18,)

    # rans_end / extras_off / base may be traced per-tile scalars
    base_u = jnp.asarray(base).astype(jnp.uint32)
    rans_end_u = jnp.asarray(rans_end).astype(jnp.uint32)
    extras_off_u = jnp.asarray(extras_off).astype(jnp.uint32)
    base_bits = base_u * jnp.uint32(32)
    rbits = base_bits + rbyte.astype(jnp.uint32) * jnp.uint32(8)
    ebits = base_bits + extras_off_u * jnp.uint32(8) + ebit.astype(jnp.uint32)
    rhi, rlo, rrest, rcur = _win_init(words, rbits, rspan)
    ehi, elo, erest, ecur = _win_init(words, ebits, espan)
    # remaining rans bytes readable per lane
    rrem = (rans_end_u - rbyte.astype(jnp.uint32)).astype(jnp.int32)
    x = x0.astype(jnp.uint32)

    def step(state, _):
        x, rhi, rlo, rrest, rcur, rrem, ehi, elo, erest, ecur = state
        slot = x & jnp.uint32(_PROB_MASK)
        sym = jnp.zeros(B, jnp.int32)
        f = jnp.zeros(B, jnp.uint32)
        c = jnp.zeros(B, jnp.uint32)
        for s in range(17):
            here = (slot >= cum[s]) & (slot < cum[s + 1])
            sym = jnp.where(here, s, sym)
            f = jnp.where(here, freq[s], f)
            c = jnp.where(here, cum[s], c)
        x = f * (x >> jnp.uint32(_PROB_BITS)) + slot - c

        for _i in range(2):
            need = (x < _STATE_LO) & (rrem > 0)
            b = _top32(rhi, rlo, rcur) >> jnp.uint32(24)
            x = jnp.where(need, (x << jnp.uint32(8)) | b, x)
            rcur = rcur + jnp.where(need, jnp.uint32(8), jnp.uint32(0))
            rrem = rrem - need.astype(jnp.int32)
            rhi, rlo, rrest, rcur = _win_refill(rhi, rlo, rrest, rcur)

        symu = sym.astype(jnp.uint32)
        top = _top32(ehi, elo, ecur)
        extra = jnp.where(
            sym > 0, top >> ((jnp.uint32(32) - symu) & jnp.uint32(31)), 0
        ).astype(jnp.uint32)
        ecur = ecur + symu
        ehi, elo, erest, ecur = _win_refill(ehi, elo, erest, ecur)

        code = (jnp.uint32(1) << symu) + extra  # 1..65536
        q = (code - jnp.uint32(1)) & jnp.uint32(0xFFFF)
        mask = (q & 1) * jnp.uint32(0xFFFF)
        v = (((q >> 1) ^ mask) & jnp.uint32(0xFFFF)).astype(jnp.int32)
        v = v - ((v & 0x8000) << 1)
        return (
            x, rhi, rlo, rrest, rcur, rrem, ehi, elo, erest, ecur,
        ), v.astype(jnp.int16)

    state0 = (x, rhi, rlo, rrest, rcur, rrem, ehi, elo, erest, ecur)
    _, ys = jax.lax.scan(step, state0, None, length=block)  # (block, B)
    return ys.T.reshape(-1)[:n_outputs]


# ---------------------------------------------------------------------
# Device-side rANS ENCODER — the forward twin of manba_decode_device,
# byte-identical to akort.c:akort_manba_encode.


def _sym_extra(values):
    """int16 stream -> (sym 0..16, extra, code) int32/uint32 arrays:
    the zigzag+1 code (1..65536, with the u16 wrap mapping -32768 to
    65536) split into bit_length-1 symbol and low-bits extra
    (akort.c:manba_sym)."""
    v = values.astype(jnp.int32)
    z = ((v << 1) ^ (v >> 15)) & 0xFFFF
    m = (z + 1) & 0xFFFF
    code = jnp.where(m == 0, jnp.int32(65536), m)
    sym = jnp.zeros_like(code)
    for k in range(1, 17):
        sym = sym + (code >= (1 << k)).astype(jnp.int32)
    extra = (code - (jnp.int32(1) << sym)).astype(jnp.uint32)
    return sym, extra, code


def _udiv_shift12(num_u32, den_u32):
    """floor((num << 12) / den) for uint32 vectors, exact for every
    num/den (the intermediate is 44-bit: restoring long division over
    the shifted numerator — 17 lanes x 44 steps, negligible). The
    model quantization's hist*PROB_SCALE overflows uint32 for tiles
    beyond 2^20 coefficients, so no single-word shortcut is safe."""
    num = num_u32.astype(jnp.uint32)
    den = jnp.maximum(den_u32.astype(jnp.uint32), 1)
    rem = jnp.zeros_like(num)
    q = jnp.zeros_like(num)
    for k in range(43, -1, -1):
        if k >= 12:
            bit = (num >> jnp.uint32(k - 12)) & jnp.uint32(1)
        else:
            bit = jnp.zeros_like(num)
        rem = (rem << 1) | bit
        ge = rem >= den
        rem = jnp.where(ge, rem - den, rem)
        q = (q << 1) | ge.astype(jnp.uint32)
    return q


def manba_model_device(sym, n: int):
    """The 12-bit static model of akort.c:manba_model, on device:
    returns (freq (17,) uint32, ok bool scalar). freq floors to
    PROB_SCALE-weighted histogram shares, bumps present-but-zero
    symbols to 1, and settles the rounding drift on the first most
    frequent symbol (ties resolve to the lowest index, like the
    reference's strict-greater scan)."""
    ar = jnp.arange(17, dtype=jnp.int32)
    hist = jnp.sum(
        (sym[:, None] == ar[None, :]).astype(jnp.uint32), axis=0
    )
    total = jnp.uint32(n)
    f = _udiv_shift12(hist, total)
    f = jnp.where((hist > 0) & (f == 0), jnp.uint32(1), f)
    s = jnp.sum(f, dtype=jnp.uint32)
    maxi = jnp.argmax(f).astype(jnp.int32)
    drift = jnp.int32(1 << _PROB_BITS) - s.astype(jnp.int32)
    fixed = f[maxi].astype(jnp.int32) + drift
    ok = fixed >= 1
    f = jnp.where(ar == maxi, jnp.maximum(fixed, 1).astype(jnp.uint32), f)
    return f, ok


def manba_encode_device(values, budget_bytes: int):
    """Device-side Manbavaran encode of one int16 stream: all three
    passes of akort_manba_encode (symbolization+model, back-to-front
    rANS with 8-bit renorm, extras bit pack) as XLA programs. The
    sequential rANS state chain runs as a lax.scan over the reversed
    symbol stream (parallel across the caller's vmap lanes — one lane
    per tile); the emitted renorm bytes land via the same scatter-free
    dense placement as the Kagari packer (pack_bits with 8-bit codes
    on the flipped emission sequence — stream order is the exact
    reverse of emission order, akort.c's scratch-and-reverse).

    Returns (freq (17,) u32, x_final u32, rans_row u8 (budget,),
    rans_bytes i32, extras_row u8 (budget,), extras_bits i32, ok bool).
    The caller assembles head+rans+extras (runtime.manba_assemble) and
    MUST fall back to the host coder when ok is False or the total
    exceeds the block capacity — identical failure semantics."""
    from ako_tpu.ops.kagari_device import pack_bits

    n = values.shape[0]
    sym, extra, _ = _sym_extra(values)
    freq, ok = manba_model_device(sym, n)
    cum = jnp.concatenate(
        [jnp.zeros((1,), jnp.uint32), jnp.cumsum(freq, dtype=jnp.uint32)]
    )

    # per-symbol (f, cum) resolved OUTSIDE the scan: 17-wide one-hot
    # contraction, so the sequential loop body has no gathers at all
    ar = jnp.arange(17, dtype=jnp.int32)
    oh = (sym[:, None] == ar[None, :]).astype(jnp.uint32)
    f_all = jnp.sum(oh * freq[None, :], axis=1)
    c_all = jnp.sum(oh * cum[None, :17], axis=1)

    def step(x, fc):
        f, cm = fc
        x_max = f << jnp.uint32(19)  # (STATE_LO >> 12) << 8 == 2^19
        e0 = x >= x_max
        b0 = x & jnp.uint32(0xFF)
        x = jnp.where(e0, x >> 8, x)
        e1 = x >= x_max
        b1 = x & jnp.uint32(0xFF)
        x = jnp.where(e1, x >> 8, x)
        x = ((x // jnp.maximum(f, 1)) << jnp.uint32(_PROB_BITS)) + (
            x % jnp.maximum(f, 1)
        ) + cm
        return x, (e0, b0, e1, b1)

    x_final, (e0, b0, e1, b1) = jax.lax.scan(
        step, _STATE_LO, (f_all[::-1], c_all[::-1])
    )

    # stream order = reverse of emission order (b0 before b1 within a
    # step): interleave emission slots then flip the whole sequence
    em_vals = jnp.stack([b0, b1], axis=-1).reshape(2 * n)[::-1]
    em_bits = (
        jnp.stack([e0, e1], axis=-1).reshape(2 * n)[::-1].astype(jnp.int32) * 8
    )
    rans_row, rans_bits = pack_bits(em_vals, em_bits, budget_bytes)

    ex_row, ex_bits = pack_bits(extra, sym, budget_bytes)
    return (
        freq,
        x_final,
        rans_row,
        rans_bits >> 3,
        ex_row,
        ex_bits,
        ok,
    )
