"""Device Kagari packer internals: the dense-inverse ranks, the
matmul-chunked cumsums, and the direct word-placement formulation — each
must be exactly equal to its straightforward reference formulation.

(Split from test_kagari_device.py so pytest-xdist's per-file
distribution balances the suite's slowest programs over workers.)
"""

import numpy as np
import jax.numpy as jnp


class TestRankDense:
    """The dense-inverse rank (histogram + one-hot matmul, the pack
    fast path) must equal searchsorted for step-<=1 word sequences."""

    def test_matches_searchsorted(self, rng):
        from ako_tpu.ops.kagari_device import _rank_dense

        for _ in range(8):
            n = int(rng.integers(5, 9000))
            q_n = int(rng.integers(2, 4000))
            # realistic gamma-code bit lengths incl. long zero-bit runs
            nb = rng.integers(0, 32, size=n)
            nb[rng.random(n) < 0.4] = 0
            offs = np.cumsum(nb) - nb
            word = (offs >> 5).astype(np.int32)
            q = np.arange(q_n, dtype=np.int32)
            ref = np.searchsorted(word, q, side="right")
            got = np.asarray(_rank_dense(jnp.asarray(word), q_n))
            np.testing.assert_array_equal(got, ref)

    def test_all_tokens_one_word(self):
        from ako_tpu.ops.kagari_device import _rank_dense

        word = np.zeros(700, np.int32)  # many span-0 chunks, same base
        got = np.asarray(_rank_dense(jnp.asarray(word), 16))
        ref = np.searchsorted(word, np.arange(16), side="right")
        np.testing.assert_array_equal(got, ref)


class TestMxuCumsum:
    """Exactness of the chunked triangular-matmul cumsums that replace
    jnp.cumsum inside pack_bits (big-stream hot path)."""

    def test_u32_wraparound_exact(self):
        from ako_tpu.ops.kagari_device import _CS_MXU_MIN, _cumsum_mxu_u32

        rng = np.random.default_rng(7)
        for n in (
            1,
            5,
            _CS_MXU_MIN - 1,
            _CS_MXU_MIN,
            _CS_MXU_MIN + 1,
            _CS_MXU_MIN + 255,
            20000,
        ):
            # full-range uint32: the cumsum wraps mod 2^32 many times
            x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
            ref = np.cumsum(x, dtype=np.uint32)
            got = np.asarray(_cumsum_mxu_u32(jnp.asarray(x)))
            np.testing.assert_array_equal(got, ref)

    def test_small_exclusive_exact(self):
        from ako_tpu.ops.kagari_device import _CS_MXU_MIN, _excl_cumsum_mxu_small

        rng = np.random.default_rng(8)
        for n in (1, 3, _CS_MXU_MIN, _CS_MXU_MIN + 77, 30000):
            x = rng.integers(0, 32, size=n).astype(np.int32)  # gamma lengths
            ref = (np.cumsum(x) - x).astype(np.int32)
            got = np.asarray(_excl_cumsum_mxu_small(jnp.asarray(x)))
            np.testing.assert_array_equal(got, ref)


class TestRankDense2:
    def test_matches_searchsorted(self, rng=None):
        from ako_tpu.ops.kagari_device import _rank_dense2

        rng = np.random.default_rng(11)
        for _ in range(8):
            n = int(rng.integers(5, 9000))
            q_n = int(rng.integers(2, 4000))
            nb = rng.integers(0, 32, size=n)
            nb[rng.random(n) < 0.4] = 0
            offs = np.cumsum(nb) - nb
            word = (offs >> 5).astype(np.int32)
            q = np.arange(q_n, dtype=np.int32)
            ref = np.searchsorted(word, q, side="right")
            got = np.asarray(_rank_dense2(jnp.asarray(word), q_n))
            np.testing.assert_array_equal(got, ref)

    def test_all_tokens_one_word(self):
        from ako_tpu.ops.kagari_device import _rank_dense2

        word = np.zeros(700, np.int32)
        got = np.asarray(_rank_dense2(jnp.asarray(word), 16))
        ref = np.searchsorted(word, np.arange(16), side="right")
        np.testing.assert_array_equal(got, ref)


class TestPlaceWords:
    """The direct dense placement (_PACK_IMPL == 'place') must produce
    the same words as the rank+cumsum-sampling path for gamma-pack
    inputs (disjoint in-word bits)."""

    def _gamma_inputs(self, rng, n):
        from ako_tpu.ops.kagari_device import tokenize

        values = rng.integers(-800, 800, size=n).astype(np.int16)
        values[rng.random(n) < 0.5] = 0  # runs
        vals, nbits = tokenize(jnp.asarray(values))
        offs = np.cumsum(np.asarray(nbits)) - np.asarray(nbits)
        return np.asarray(vals), np.asarray(nbits), offs

    def test_words_match_reference_assembly(self):
        from ako_tpu.ops.kagari_device import _place_words_u32

        rng = np.random.default_rng(12)
        for n in (7, 100, 1500, 5000):
            vals, nbits, offs = self._gamma_inputs(rng, n)
            word = (offs >> 5).astype(np.int32)
            shift = (offs & 31).astype(np.int64)
            # host-reference 64-bit window assembly
            total_bits = int(offs[-1] + nbits[-1])
            n_words = (total_bits + 31) // 32 + 2
            acc = np.zeros(n_words + 1, np.uint64)
            for i in range(2 * n):
                nb = int(nbits[i])
                if nb == 0:
                    continue
                v = np.uint64(vals[i])
                w, s = int(word[i]), int(shift[i])
                win = (v << np.uint64(64 - s - nb)) & np.uint64(0xFFFFFFFFFFFFFFFF)
                acc[w] |= win >> np.uint64(32)
                acc[w + 1] |= win & np.uint64(0xFFFFFFFF)
            ref = acc[:n_words].astype(np.uint32)
            # device formulation inputs (hi/lo halves per token)
            v32 = vals.astype(np.uint32)
            k1 = np.minimum(np.clip(32 - (offs & 31), 0, None), nbits).astype(np.int64)
            k2 = nbits - k1
            hi = np.where((nbits > 0) & (k1 > 0),
                          (v32 >> np.minimum(k2, 31).astype(np.uint32))
                          << np.clip(32 - (offs & 31) - k1, 0, 31).astype(np.uint32),
                          0).astype(np.uint32)
            lo_mask = np.where(k2 > 0, (np.uint32(1) << np.minimum(k2, 31).astype(np.uint32)) - 1, 0).astype(np.uint32)
            lo = np.where(k2 > 0, (v32 & lo_mask) << np.clip(32 - k2, 0, 31).astype(np.uint32), 0).astype(np.uint32)
            got = np.asarray(_place_words_u32(
                jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(word), n_words))
            np.testing.assert_array_equal(got, ref)

    def test_pack_impls_agree(self, monkeypatch):
        import ako_tpu.ops.kagari_device as kd

        rng = np.random.default_rng(13)
        for n in (5, 333, 4096):
            values = rng.integers(-500, 500, size=n).astype(np.int16)
            values[rng.random(n) < 0.5] = 0
            cap = 4 * n + 64
            by_a, tot_a = kd.kagari_encode_device(jnp.asarray(values), cap)
            monkeypatch.setattr(kd, "_PACK_IMPL", "rank")
            by_b, tot_b = kd.kagari_encode_device(jnp.asarray(values), cap)
            monkeypatch.setattr(kd, "_PACK_IMPL", "place")
            assert int(tot_a) == int(tot_b)
            np.testing.assert_array_equal(np.asarray(by_a), np.asarray(by_b))
