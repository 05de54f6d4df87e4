"""Device-side Kagari entropy encoder: the scan-based formulation.

The reference coder is a sequential 64-bit bit-accumulator loop
(reference library/kagari.c:59-297). On the device it becomes data-parallel
passes over the whole coefficient stream:

  1. zigzag + RLE tokenization — run structure recovered with a
     cumulative-max "distance to last mismatch", the run-length escape
     rules (trigger 2, forced flush at counter 65534) evaluated
     pointwise from that distance;
  2. per-token Elias-gamma bit lengths (compare ladder) + exclusive
     cumsum for bit offsets;
  3. bit packing without any scatter: every token's value contributes
     a 64-bit-window aligned pair of 32-bit words (codes are <= 31
     bits so windows never carry); per-word sums are recovered from a
     cumulative sum sampled at word boundaries via searchsorted —
     token word-indices are monotonically sorted, so segment sums are
     just differences of the cumsum (no scatter: on the accelerator
     this was first written for, scatter compiled pathologically
     slowly; whether a scatter form wins on the GPU is open, ROADMAP
     A2).

The emitted bytes equal the reference's byte stream exactly: the
accumulator's flush pattern is plain MSB-first bit concatenation with
zero padding of the final byte; only its *failure* conditions differ,
so callers must fall back to the host coder when the result lands
within a few bytes of the capacity (see runtime/kagari.py).

The decoder (kagari_decode_device) parallelizes the prefix-sequential
gamma stream over fixed-size output blocks: a host scanner
(runtime.kagari.kagari_sync) finds each block's bit offset and carry
state, then every block decodes independently on device as one lane of
a `block`-step scan whose word accesses are gather-free (per-block
word windows carried through the scan).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

RLE_TRIGGER = 2
VALUE_MAX = 65535
FLUSH_COUNTER = VALUE_MAX - 1  # run counter value that forces a token

#: word-assembly implementation in pack_bits: "place" (direct dense
#: placement — the fast path) or "rank" (rank + cumsum sampling,
#: kept for A/B; its rank variant is chosen by _RANK_IMPL)
_PACK_IMPL = "place"

#: rank implementation when _PACK_IMPL == "rank": "dense2"
#: (roll + coarse matmul), "dense" (one-hot matmul + lane-shift fold),
#: "sort" (round-1 merge-sort rank), "chunked" (binary-search +
#: row-gather; loses at realistic budgets)
_RANK_IMPL = "dense2"


def _exclusive_cumsum(x):
    return jnp.cumsum(x) - x


#: chunk width for the triangular-matmul cumsum; 256 keeps single-limb
#: in-chunk sums (values <= 255) within bf16/fp32 exact-integer range
_CS_CHUNK = 256

#: below this length the log-shift jnp.cumsum wins over staging the
#: triangular matmul
_CS_MXU_MIN = 4096


def _tri_cumsum_rows(rows_bf16):
    """(R, C) bf16 -> (R, C) fp32 inclusive in-chunk cumsum via one
    upper-triangular bf16 matmul (f32 accumulation). Exact while in-chunk sums stay below
    2^24 (callers bound entries accordingly)."""
    C = rows_bf16.shape[-1]
    tri = jnp.triu(jnp.ones((C, C), jnp.bfloat16))
    return jnp.matmul(rows_bf16, tri, preferred_element_type=jnp.float32)


def _cumsum_mxu_u32(x):
    """Inclusive cumsum mod 2^32 of a uint32 vector, via chunked
    triangular bf16 matmuls: one HBM pass + a tiny chunk-total cumsum,
    instead of the log(n) full-array shift passes XLA emitted for
    jnp.cumsum on the first target (on the GPU the choice is open,
    ROADMAP A2).

    Exactness: each 8-bit limb's in-chunk sums are <= 255*256 < 2^24
    (exact in fp32), and the limb recombination / chunk-total addition
    happen in wrapping uint32 — congruent mod 2^32 with the sequential
    sum."""
    m = x.shape[0]
    if m < _CS_MXU_MIN:
        return jnp.cumsum(x, dtype=jnp.uint32)
    C = _CS_CHUNK
    pad = (-m) % C
    rows = jnp.pad(x, (0, pad)).reshape(-1, C)
    local = jnp.zeros(rows.shape, jnp.uint32)
    for k in range(4):
        limb = ((rows >> (8 * k)) & jnp.uint32(0xFF)).astype(jnp.bfloat16)
        cs = _tri_cumsum_rows(limb).astype(jnp.uint32)
        local = local + (cs << (8 * k))
    totals = local[:, -1]
    base = jnp.cumsum(totals) - totals
    return (local + base[:, None]).reshape(-1)[:m]


def _excl_cumsum_mxu_small(x):
    """Exclusive cumsum of an int32 vector with entries in [0, 255]
    (gamma code lengths are <= 31): single-limb chunked triangular
    bf16 matmul. Exact: in-chunk sums <= 255*256 < 2^24, totals < 2^31."""
    m = x.shape[0]
    if m < _CS_MXU_MIN:
        return _exclusive_cumsum(x)
    C = _CS_CHUNK
    pad = (-m) % C
    rows = jnp.pad(x, (0, pad)).reshape(-1, C)
    cs = _tri_cumsum_rows(rows.astype(jnp.bfloat16)).astype(jnp.int32)
    totals = cs[:, -1]
    base = jnp.cumsum(totals) - totals
    return (cs + base[:, None]).reshape(-1)[:m] - x


def tokenize(values):
    """values: (n,) int16 serialized stream -> per-position token pair
    arrays, flattened to shape (2n,): even slots are the (optional)
    literal at that position, odd slots the (optional) RLE token
    emitted right after it.

    Returns (vals, nbits): uint32 token values (gamma argument) and
    int32 code lengths, 0 where no token is emitted."""
    n = values.shape[0]
    v = values.astype(jnp.int32)

    # zigzag + 1, with the uint16 wrap for -32768 (kagari.c:169-175
    # behavior through the uint16 argument truncation)
    z = ((v << 1) ^ (v >> 15)) & 0xFFFF
    u = (z + 1) & 0xFFFF

    idx = jnp.arange(n, dtype=jnp.int32)
    same = jnp.concatenate(
        [jnp.zeros((1,), jnp.bool_), values[1:] == values[:-1]]
    )
    # distance to the last mismatch == the reference's run counter,
    # except it keeps growing past the forced flush
    last_mismatch = jax.lax.cummax(jnp.where(same, jnp.int32(-1), idx))
    d = idx - last_mismatch
    # counter value after the forced-flush reset cycle
    rc = jnp.where(d > 0, ((d - 1) % FLUSH_COUNTER) + 1, 0)

    lit_mask = (d == 0) | (rc <= RLE_TRIGGER)
    flush_mask = rc == FLUSH_COUNTER
    run_end = same & jnp.concatenate(
        [~same[1:], jnp.ones((1,), jnp.bool_)]
    )
    end_mask = run_end & (rc >= RLE_TRIGGER) & (rc != FLUSH_COUNTER)

    tok_mask = flush_mask | end_mask
    # run token value: counter - trigger + 1 (kagari.c:199-204)
    tok_val = jnp.where(
        flush_mask, jnp.int32(FLUSH_COUNTER - RLE_TRIGGER + 1), rc - RLE_TRIGGER + 1
    )

    vals = jnp.stack(
        [jnp.where(lit_mask, u, 0), jnp.where(tok_mask, tok_val, 0)], axis=-1
    ).reshape(2 * n)
    nbits = _gamma_bits(vals) * (
        jnp.stack([lit_mask, tok_mask], axis=-1).reshape(2 * n)
    )
    return vals.astype(jnp.uint32), nbits.astype(jnp.int32)


def _gamma_bits(u):
    """Elias-gamma code length: 2*floor(log2(u)) + 1 for u >= 1, and 1
    for the u == 0 wrap value (matches gamma_bits' while-loop)."""
    b = jnp.zeros_like(u)
    for k in range(1, 16):
        b = b + (u >= (1 << k)).astype(u.dtype)
    return (2 * b + 1).astype(jnp.int32)


_RANK_CHUNK = 128

#: dense-inverse rank chunk width; also bounds each chunk's word span
#: (bit offsets advance <= 31 bits/token, so a chunk of C tokens spans
#: <= C-1 word indices). 128 beat 256 and 512 in a sweep before the
#: GPU port; not yet re-swept on the GPU
_DENSE_CHUNK = 128

#: chunk width for the "place" packer (_place_words_u32). Its vector
#: cost (the per-chunk local-word compare/select/sum) is LINEAR in this
#: width while the coarse matmuls stay negligible, and any power of
#: two is exact (codes <= 31 bits keep every chunk's word span < C even
#: at 32). 32 won a sweep of 32/64/128 before the GPU port; re-sweep
#: on the GPU with devbench/device_stages.py.
_PLACE_CHUNK = int(os.environ.get("AKO_PACK_CHUNK", "32"))

#: sentinel larger than any reachable word index (streams are < 2^28
#: bits) but safe against base+r overflow in int32
_WORD_PAD = 1 << 28


def _rank_dense2(word, n_queries: int):
    """upper[q] = #(word <= q) for q = arange(n_queries): dense-inverse
    rank, v2 placement.

    v1 (_rank_dense) placed chunk-local histograms with a one-hot
    matmul into a (C, Q+C) plane and summed its skew diagonals with a
    lane-shift fold — most of the rank's time on the first target
    (lane shifts forced full vector relayouts there). v2 decomposes each chunk's
    placement offset base_c = C*kc + rot_c and

      1. rolls the (C, nc) transposed histogram DOWN its sublane axis
         by rot_c per chunk (7 select+circular-shift passes over ~1 MB
         — sublane moves, no lane relayout);
      2. splits wrapped rows (r'' < rot: they belong to coarse block
         kc+1) with a mask, and places both parts with two tiny
         (C, nc) x (nc, ceil(Q/C)) bf16 matmuls against one-hot
         coarse-block matrices.

    Exactness: histogram entries <= C = 128 are exact in bf16, the
    matmul accumulates counts < 2^24 in fp32, and the roll/masks are
    pure data movement."""
    C = _DENSE_CHUNK
    assert C & (C - 1) == 0 and C <= 256
    m = word.shape[0]
    pad = (-m) % C
    wpad = jnp.pad(word, (0, pad), constant_values=_WORD_PAD)
    rows = wpad.reshape(-1, C)  # (nc, C)
    base = rows[:, 0]
    r = jnp.arange(C, dtype=jnp.int32)
    lh = jnp.sum(
        (rows[:, :, None] - base[:, None, None]) == r[None, None, :],
        axis=1,
        dtype=jnp.int32,
    )  # (nc, C)

    kc = base // C  # coarse block (padded chunks: beyond every one-hot)
    rot = base - C * kc  # fine shift in [0, C)
    n_blocks = -(-n_queries // C)

    # roll each chunk's histogram column down by rot_c (sublane axis)
    B = lh.T.astype(jnp.bfloat16)  # (C, nc)
    for k in range(C.bit_length() - 1):
        s = 1 << k
        rolled = jnp.concatenate([B[-s:], B[:-s]], axis=0)
        B = jnp.where((rot[None, :] & s) != 0, rolled, B)
    # rows r'' < rot wrapped around: they belong to block kc + 1
    wrapped = r[:, None] < rot[None, :]  # (C, nc)
    jq = jnp.arange(n_blocks, dtype=jnp.int32)
    oh_main = (kc[:, None] == jq[None, :]).astype(jnp.bfloat16)  # (nc, nb)
    oh_spill = ((kc + 1)[:, None] == jq[None, :]).astype(jnp.bfloat16)
    O = jnp.matmul(
        jnp.where(wrapped, jnp.bfloat16(0), B), oh_main,
        preferred_element_type=jnp.float32,
    ) + jnp.matmul(
        jnp.where(wrapped, B, jnp.bfloat16(0)), oh_spill,
        preferred_element_type=jnp.float32,
    )  # (C, n_blocks): h[C*j + r''] = O[r'', j]
    h = O.T.reshape(-1)[:n_queries].astype(jnp.int32)
    return jnp.cumsum(h)


def _place_words_u32(hi, lo, word, n_words: int):
    """out[q] = Σ hi over tokens with word == q  +  Σ lo over tokens
    with word == q-1 (wrapping uint32) — the word assembly of pack_bits
    as ONE dense placement, with no rank, no big cumsums and no
    gathers (on the first target, v1's rank and its cs[upper] gathers
    took most of the pack).

    Same chunk/roll/coarse-matmul scheme as _rank_dense2, vectorized
    over the hi channel (shift 0) and the lo channel (shift 1).
    Exactness: tokens sharing a word contribute DISJOINT bit ranges of
    that word (the gamma codes tile the stream), so every per-word sum
    is a bitwise OR: 8-bit limb partial sums stay < 256 (exact bf16
    inputs, exact fp32 accumulation) and the final limb
    recombination in wrapping uint32 is exact — at every chunk width
    (the disjointness is a stream property, not a chunk property)."""
    C = _PLACE_CHUNK
    assert C & (C - 1) == 0
    m = word.shape[0]
    pad = (-m) % C
    wpad = jnp.pad(word, (0, pad), constant_values=_WORD_PAD)
    rows = wpad.reshape(-1, C)  # (nc, C)
    base = rows[:, 0]
    r = jnp.arange(C, dtype=jnp.int32)
    eq = (rows[:, :, None] - base[:, None, None]) == r[None, None, :]
    vals = jnp.stack(
        [jnp.pad(hi, (0, pad)).reshape(-1, C), jnp.pad(lo, (0, pad)).reshape(-1, C)]
    )  # (2, nc, C)
    # (2, nc, C): per-chunk per-local-word partial sums (disjoint-bit ORs)
    lwh = jnp.sum(
        jnp.where(eq[None], vals[:, :, :, None], jnp.uint32(0)),
        axis=2,
        dtype=jnp.uint32,
    )
    n_blocks = -(-n_words // C)
    jq = jnp.arange(n_blocks, dtype=jnp.int32)
    out = jnp.zeros((C, n_blocks), jnp.uint32)
    for ch, shift in ((0, 0), (1, 1)):
        b = base + shift
        kc = b // C
        rot = b - C * kc
        B = lwh[ch].T  # (C, nc) u32
        for k in range(C.bit_length() - 1):
            s = 1 << k
            rolled = jnp.concatenate([B[-s:], B[:-s]], axis=0)
            B = jnp.where((rot[None, :] & s) != 0, rolled, B)
        wrapped = r[:, None] < rot[None, :]
        oh_main = (kc[:, None] == jq[None, :]).astype(jnp.bfloat16)
        oh_spill = ((kc + 1)[:, None] == jq[None, :]).astype(jnp.bfloat16)
        Bm = jnp.where(wrapped, jnp.uint32(0), B)
        Bs = jnp.where(wrapped, B, jnp.uint32(0))
        for limb in range(4):
            lm = ((Bm >> (8 * limb)) & jnp.uint32(0xFF)).astype(jnp.bfloat16)
            ls = ((Bs >> (8 * limb)) & jnp.uint32(0xFF)).astype(jnp.bfloat16)
            o = jnp.matmul(
                lm, oh_main, preferred_element_type=jnp.float32
            ) + jnp.matmul(ls, oh_spill, preferred_element_type=jnp.float32)
            out = out + (o.astype(jnp.uint32) << (8 * limb))
    return out.T.reshape(-1)[:n_words]


def _rank_dense(word, n_queries: int):
    """upper[q] = #(word <= q) for q = arange(n_queries), without
    per-query gathers, scatters, or a big sort.

    Requires `word` sorted non-decreasing with adjacent steps <= 1
    (true for gamma-code word indices: offsets advance < 32 bits per
    token). The queries being a dense arange turns rank into a
    histogram + cumsum; the histogram is assembled from chunk-local
    histograms (each chunk of _DENSE_CHUNK tokens spans < _DENSE_CHUNK
    word indices) placed at their base word via a one-hot matmul — a
    dense contraction instead of the merge sort that dominated the
    round-1 profile.

    Exactness: local-histogram entries are <= C <= 256, exactly
    representable in bf16 (8 mantissa bits), and the matmul accumulates in
    fp32 over < 2^18 tokens total, far below 2^24."""
    C = _DENSE_CHUNK
    # the fold below halves the row count each step; C must be a power
    # of two (and <= 256 for bf16 exactness of histogram entries)
    assert C & (C - 1) == 0 and C <= 256
    m = word.shape[0]
    pad = (-m) % C
    wpad = jnp.pad(word, (0, pad), constant_values=_WORD_PAD)
    rows = wpad.reshape(-1, C)  # (nc, C)
    base = rows[:, 0]
    # chunk-local histogram over local offsets r in [0, C)
    r = jnp.arange(C, dtype=jnp.int32)
    lh = jnp.sum(
        (rows[:, :, None] - base[:, None, None]) == r[None, None, :],
        axis=1,
        dtype=jnp.int32,
    )  # (nc, C)
    # place each local histogram at its base: PT[r, q'] = sum over
    # chunks with base == q' of lh[., r] — a bf16 contraction
    # against the one-hot base matrix. Padded chunks have base ==
    # _WORD_PAD and never match a query. Transposed layout so the
    # diagonal reduction below works on contiguous rows.
    q = jnp.arange(n_queries, dtype=jnp.int32)
    onehot_t = (base[:, None] == q[None, :]).astype(jnp.bfloat16)  # (nc, Q)
    PT = jnp.matmul(
        lh.T.astype(jnp.bfloat16), onehot_t, preferred_element_type=jnp.float32
    )  # (C, Q)
    # h[q] = sum_r PT[r, q - r]: a skew-diagonal sum, folded in log2(C)
    # steps — at each step the bottom half of the rows is shifted right
    # by the half-width (a static pad+slice, no relayout) and added to
    # the top half. A flat-reshape skew triggered a pathological lane
    # relayout on the first target.
    B = jnp.pad(PT, ((0, 0), (0, C)))  # (C, Q + C)
    width = n_queries + C
    k = C
    while k > 1:
        half = k // 2
        shifted = jnp.pad(B[half:k], ((0, 0), (half, 0)))[:, :width]
        B = B[:half] + shifted
        k = half
    h = B[0, :n_queries]
    return jnp.cumsum(h.astype(jnp.int32))


def _rank_chunked(word, queries):
    """upper[q] = #(word <= q) for a sorted `word` whose consecutive
    deltas are 0 or 1 (gamma codes are < 32 bits, so the word index
    advances at most one per token).

    A full sort/searchsorted over all tokens was the round-1 bottleneck;
    instead tokens are chunked _RANK_CHUNK-wide. Chunk bases (word of the
    chunk's first token) are a tiny sorted table: a chunk's tokens
    never precede its base and never exceed the next base, so
    upper[q] = CHUNK * j + #(chunk_j's words <= q) with j the last chunk
    whose base <= q. That needs only a log-size binary search over the
    base table, one _RANK_CHUNK-wide row gather per query, and a compare-sum —
    no large sort, no big gathers."""
    n = word.shape[0]
    pad = (-n) % _RANK_CHUNK
    wpad = jnp.pad(word, (0, pad), constant_values=jnp.iinfo(jnp.int32).max)
    rows = wpad.reshape(-1, _RANK_CHUNK)
    bases = rows[:, 0]
    n_chunks = rows.shape[0]

    # binary search for j(q)+1 = #(bases <= q) over the small table;
    # the interval [lo, hi] starts n_chunks+1 wide, so the step count
    # must cover log2 of that
    lo = jnp.zeros(queries.shape, jnp.int32)
    hi = jnp.full(queries.shape, n_chunks, jnp.int32)
    steps = max(1, (n_chunks + 1).bit_length())
    for _ in range(steps):
        mid = (lo + hi) >> 1
        # once lo == hi the loop keeps running fixed steps; the mid
        # index then equals hi and (clamped) out-of-bounds gathers
        # would corrupt the result — mask them out
        go_right = (mid < n_chunks) & (bases[jnp.minimum(mid, n_chunks - 1)] <= queries)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    j = lo - 1  # last chunk with base <= q; -1 when q < bases[0]

    chunk_words = rows[jnp.maximum(j, 0)]  # (Q, _RANK_CHUNK) row gather
    within = jnp.sum(
        (chunk_words <= queries[:, None]).astype(jnp.int32), axis=-1
    )
    return jnp.where(j < 0, 0, j * _RANK_CHUNK + within)


def pack_bits(vals, nbits, capacity_bytes: int):
    """Scatter the gamma codes MSB-first into a byte array.

    vals/nbits: (m,) token values and code lengths (0 = no token).
    Returns (bytes_u8 of shape (capacity_bytes,), total_bits scalar).
    Bytes beyond ceil(total_bits/8) are zero."""
    cap_words = (capacity_bytes + 3) // 4
    offs = _excl_cumsum_mxu_small(nbits)
    total_bits = offs[-1] + nbits[-1]

    word = (offs >> 5).astype(jnp.int32)
    shift = (offs & 31).astype(jnp.int32)
    # Conceptual 64-bit window [word, word+1): the value's MSB lands at
    # window bit `shift`. x64 is off (no native 64-bit ints), so split the
    # window into two uint32 halves directly: k1 bits into word, the
    # remaining k2 = nbits - k1 into word+1. Codes are <= 31 bits, so
    # each token touches exactly these two words and never carries —
    # the scatter-add below is equivalent to bitwise OR.
    v32 = vals.astype(jnp.uint32)
    k1 = jnp.clip(32 - shift, 0, None)
    k1 = jnp.minimum(k1, nbits)
    k2 = nbits - k1
    # shifts are clamped to < 32 and masked, so no UB-range shifts
    hi_part = v32 >> jnp.minimum(k2, 31).astype(jnp.uint32)
    hi = jnp.where(
        (nbits > 0) & (k1 > 0),
        hi_part << jnp.clip(32 - shift - k1, 0, 31).astype(jnp.uint32),
        jnp.uint32(0),
    )
    lo_mask = jnp.where(k2 > 0, (jnp.uint32(1) << jnp.minimum(k2, 31).astype(jnp.uint32)) - 1, 0)
    lo = jnp.where(
        k2 > 0,
        (v32 & lo_mask) << jnp.clip(32 - k2, 0, 31).astype(jnp.uint32),
        jnp.uint32(0),
    )

    # Segment-sum by sorted word index, scatter-free.
    # words[w] = sum(hi where word==w) + sum(lo where word+1==w).
    if _PACK_IMPL == "place":
        # direct dense placement: no rank, no stream-length cumsums,
        # no gathers (the fast path; see _place_words_u32)
        words = _place_words_u32(hi, lo, word, cap_words)
    else:
        # rank + cumsum-sampling formulation, kept for A/B: compute
        # upper[q] = #(word <= q), then read boundary differences of
        # the hi/lo running sums (wrapping cumsums are exact at word
        # boundaries because in-word bits are disjoint). One rank
        # serves both channels: #(word+1 <= q) == #(word <= q-1) is
        # the same rank shifted one query. Before the GPU port the rank
        # and the two cs[upper] gathers cost several times the "place"
        # pack.
        if _RANK_IMPL == "dense2":
            upper = _rank_dense2(word, cap_words)
        elif _RANK_IMPL == "dense":
            upper = _rank_dense(word, cap_words)
        elif _RANK_IMPL == "chunked":
            wq = jnp.arange(cap_words, dtype=jnp.int32)
            upper = _rank_chunked(word, wq)
        else:  # "sort"
            wq = jnp.arange(cap_words, dtype=jnp.int32)
            upper = jnp.searchsorted(word, wq, side="right", method="sort").astype(jnp.int32)
        zero = jnp.zeros((1,), jnp.uint32)

        cs_hi = jnp.concatenate([zero, _cumsum_mxu_u32(hi)])
        cs_lo = jnp.concatenate([zero, _cumsum_mxu_u32(lo)])
        ends_hi = cs_hi[upper]  # Σ hi over tokens with word <= q
        ends_lo = cs_lo[upper]
        prev_hi = jnp.concatenate([zero, ends_hi[:-1]])
        prev_lo = jnp.concatenate([zero, ends_lo[:-1]])
        prev2_lo = jnp.concatenate([zero, prev_lo[:-1]])
        # words[q] = Σ hi (word == q)  +  Σ lo (word == q-1)
        words = (ends_hi - prev_hi) + (prev_lo - prev2_lo)

    # words hold the stream big-endian (bit 0 of the stream is the MSB
    # of word 0): emit bytes MSB-first
    b0 = (words >> 24) & 0xFF
    b1 = (words >> 16) & 0xFF
    b2 = (words >> 8) & 0xFF
    b3 = words & 0xFF
    by = jnp.stack([b0, b1, b2, b3], axis=-1).reshape(-1)[:capacity_bytes]
    return by.astype(jnp.uint8), total_bits


#: sync-record consec sentinel: "first output of the stream pending"
#: (the reference writes the first literal without any run comparison,
#: kagari.c:322; akort_kagari_sync emits the same sentinel)
SYNC_FIRST = 0xFFFF

#: outputs decoded per device block; each block starts from a host
#: sync record (runtime.kagari.kagari_sync) and decodes independently.
#: Smaller blocks = more lane parallelism but more sync records (host
#: scan + upload); env-tunable for devbench sweeps (baked at import,
#: like AKO_PACK_CHUNK — bit-exactness is block-size-independent, the
#: records are just restart points)
DECODE_BLOCK = int(os.environ.get("AKO_DECODE_BLOCK", "128"))

#: word-buffer slack callers must pad beyond the compressed bytes so
#: the window init and per-step refills never read past the buffer
DECODE_SLACK_WORDS = 2


def _gamma_at(hi, lo, cur):
    """Decode one gamma code from the 64-bit window (hi, lo) at bit
    cursor `cur` (0..31): returns (value u32, length i32). Codes are
    <= 31 bits (callers fall back to the host for the zigzag(-32768)
    misalignment quirk, the only source of longer codes)."""
    top = jnp.where(
        cur == 0,
        hi,
        (hi << cur) | (lo >> jnp.minimum(jnp.uint32(32) - cur, jnp.uint32(31))),
    )
    z = jnp.zeros(top.shape, jnp.int32)
    for k in range(1, 16):
        z = z + (top < jnp.uint32(1 << (32 - k))).astype(jnp.int32)
    length = 2 * z + 1
    u = top >> (jnp.int32(32) - length).astype(jnp.uint32)
    return u, length


def _unzigzag(u):
    """Gamma value u -> int16-valued int32: (u-1) & 0xFFFF, zigzag
    decode, sign-extend (kagari.c:176-179 semantics)."""
    q = (u - jnp.uint32(1)) & jnp.uint32(0xFFFF)
    mask = (q & 1) * jnp.uint32(0xFFFF)
    x = (((q >> 1) ^ mask) & jnp.uint32(0xFFFF)).astype(jnp.int32)
    return x - ((x & 0x8000) << 1)


def decode_span_words(bit_offsets, total_bits: int, slack: int = 3) -> int:
    """Host-side exact window width for kagari_decode_device: the
    maximum number of 32-bit words any block's decode touches, from the
    sync records' bit offsets. `slack` covers the 2-word hi/lo prefetch
    beyond the last genuinely consumed word."""
    boff = np.asarray(bit_offsets, np.int64)
    if boff.size == 0:
        return slack
    ends = np.concatenate([boff[1:], np.asarray([max(total_bits, 1)], np.int64)])
    spans = (ends - 1) // 32 - boff // 32 + 1
    return int(spans.max()) + slack


def kagari_decode_device(words, bit_off, prev0, consec0, run0, n_outputs: int,
                         block: int = DECODE_BLOCK, span: int | None = None,
                         base=0):
    """Device-side parallel Kagari decode of one tile's stream.

    words: (W,) uint32 — the compressed bytes as big-endian-bit words,
    padded with >= 2 slack words. Sync arrays (B,) come from the host
    scanner (runtime.kagari.kagari_sync; reference decode semantics
    kagari.c:301-366): every block of `block` output values decodes
    independently from its record, so the sequential gamma stream
    parallelizes over B lanes with a `block`-step scan — each step
    emits exactly one value (a literal, or one repeat of the pending
    run) and consumes 0, 1 (literal) or 2 (literal + run token)
    codes. Returns (n_outputs,) int16, bit-exact with the host
    decoder for every stream whose codes are <= 31 bits.

    `span` is the per-block word-window width (>= every block's true
    word span + 2-word prefetch; compute via decode_span_words). Each
    lane's window is sliced out of `words` with ONE gather up front and
    then carried through the scan — a refill takes the window's front
    word and shifts it left, so the hot loop has no gathers at all
    (per-step `words[wptr]` gathers were several times slower on the
    first target). None = whole-stream windows (always
    safe; memory-proportionate only for small streams — tests).

    `base` (int32 scalar) offsets every word index: callers batching
    many tiles upload ONE dense concatenated word pool and pass each
    tile's start word here, instead of padding every tile to a common
    per-tile capacity (which copied ~2.5x the actual compressed bytes
    to the device)."""
    wcap = words.shape[0]
    if span is None:
        span = wcap
    span = max(3, min(span, wcap))
    prev = prev0.astype(jnp.int32)
    consec = consec0.astype(jnp.uint16).astype(jnp.int32)
    runrem = run0.astype(jnp.uint16).astype(jnp.int32)
    boff = bit_off.astype(jnp.uint32)
    word0 = (boff >> 5).astype(jnp.int32) + base
    cur = boff & jnp.uint32(31)
    idx = jnp.clip(
        word0[:, None] + jnp.arange(span, dtype=jnp.int32)[None, :], 0, wcap - 1
    )
    win = words[idx]  # (B, span): the one gather
    hi, lo, rest = win[:, 0], win[:, 1], win[:, 2:]

    def refill(hi, lo, cur, rest):
        need = cur >= 32
        hi2 = jnp.where(need, lo, hi)
        lo2 = jnp.where(need, rest[:, 0], lo)
        rest2 = jnp.where(
            need[:, None],
            jnp.concatenate([rest[:, 1:], rest[:, :1] * 0], axis=1),
            rest,
        )
        return hi2, lo2, jnp.where(need, cur - 32, cur), rest2

    def step(state, _):
        hi, lo, cur, rest, prev, consec, runrem = state
        in_run = runrem > 0
        u, ln = _gamma_at(hi, lo, cur)
        v = _unzigzag(u)
        cur = cur + jnp.where(in_run, 0, ln).astype(jnp.uint32)
        hi, lo, cur, rest = refill(hi, lo, cur, rest)

        first = consec == SYNC_FIRST
        eq = (~first) & (~in_run) & (v == prev)
        consec_lit = jnp.where(first, 0, jnp.where(eq, consec + 1, 0))
        trigger = (~in_run) & (consec_lit == RLE_TRIGGER)
        u2, ln2 = _gamma_at(hi, lo, cur)
        cur = cur + jnp.where(trigger, ln2, 0).astype(jnp.uint32)
        hi, lo, cur, rest = refill(hi, lo, cur, rest)
        rle_len = ((u2 - jnp.uint32(1)) & jnp.uint32(0xFFFF)).astype(jnp.int32)

        out = jnp.where(in_run, prev, v)
        prev_n = jnp.where(in_run | eq, prev, v)
        runrem_n = jnp.where(in_run, runrem - 1, jnp.where(trigger, rle_len, 0))
        consec_n = jnp.where(in_run, consec, jnp.where(trigger, 0, consec_lit))
        return (hi, lo, cur, rest, prev_n, consec_n, runrem_n), out.astype(jnp.int16)

    state0 = (hi, lo, cur, rest, prev, consec, runrem)
    _, ys = jax.lax.scan(step, state0, None, length=block)  # (block, B)
    return ys.T.reshape(-1)[:n_outputs]


def kagari_size_device(values):
    """Exact compressed payload size in bytes of one serialized int16
    stream — tokenize only, no rank/pack. total_bits is the sum of the
    per-token gamma lengths (pack_bits computes the same sum as the
    last exclusive-scan offset), so callers that need SIZES but not
    BYTES (rate-control probes, tools/rate.py) skip the packer's rank
    entirely and fetch one int32 per tile."""
    _, nbits = tokenize(values)
    return (jnp.sum(nbits) + 7) >> 3


def kagari_encode_device(values, capacity_bytes: int, budget_bytes: int | None = None):
    """Full device-side Kagari encode of one serialized int16 stream.
    Returns (bytes_u8 (budget_bytes,), total_bytes scalar int32).

    total_bytes == ceil(total_bits / 8) and is always exact. The byte
    buffer only covers `budget_bytes` (defaults to capacity_bytes) —
    the rank step's cost is linear in the buffer size, so callers pick
    a budget below the worst case and MUST fall back to the host coder
    whenever total_bytes > budget_bytes (see encode.encode_tiles_blocks)."""
    if budget_bytes is None:
        budget_bytes = capacity_bytes
    vals, nbits = tokenize(values)
    by, total_bits = pack_bits(vals, nbits, budget_bytes)
    return by, (total_bits + 7) >> 3
