"""Extended decoder-differential fuzz campaign: random valid blobs,
then truncations and bit flips, asserting tests/test_fuzz.py's
agreement contract at scale. Usage: fuzz_campaign.py START COUNT"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
os.environ["JAX_PLATFORMS"] = "cpu"
import jax; jax.config.update("jax_platforms", "cpu")
import numpy as np
import ako_tpu
from tests.test_differential import _random_case
from tests.test_fuzz import assert_agree

start, count = int(sys.argv[1]), int(sys.argv[2])
fails = 0
for seed in range(start, start + count):
    if seed % 20 == 0 and seed > start:
        jax.clear_caches()
    rng = np.random.default_rng(10_000_000 + seed)
    img, s = _random_case(rng)
    try:
        blob = ako_tpu.encode(img, s, device_entropy=False)
    except ako_tpu.AkoError:
        continue
    try:
        # a few random truncations
        for cut in sorted(rng.integers(1, len(blob), size=4).tolist()):
            assert_agree(blob[:cut], f"seed {seed} trunc {cut}", truncated=True)
        # a few random bit flips
        for _ in range(6):
            pos = int(rng.integers(0, len(blob)))
            bit = int(rng.integers(0, 8))
            b = bytearray(blob)
            b[pos] ^= 1 << bit
            assert_agree(bytes(b), f"seed {seed} flip {pos}.{bit}")
    except AssertionError as e:
        fails += 1
        print("FAIL", e, flush=True)
print(f"fuzz range {start}..{start + count}: {count - fails} ok, {fails} fail", flush=True)
sys.exit(1 if fails else 0)
