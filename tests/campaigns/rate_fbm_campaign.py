"""Rate-control campaign on the fbm (photographic) corpus at the
north-star scale: full 1024x1280 RGBA images x ratios {4,8,12,24,48},
asserting (a) byte-identical blobs vs the reference akoenc binary's
--dev-ratio search and (b) IDENTICAL probe trajectories — the
cached-pyramid cheap requantization (tools/rate.py) must not change
the search path the reference walks with full re-encodes
(/root/reference/tools/akoenc.cpp:130-216).

Trajectory comparison: both sides print the same verbose lines
("Target: ..." then one " - Q: ..." per probe, then the chosen
" - Q: n"); the reference's are filtered out of its -verbose output.

Usage: python tests/campaigns/rate_fbm_campaign.py [n_images] [--json OUT]
Writes the committed artifact (devbench/RATE_FBM_r05.json) with
--json; exits 1 on any divergence.
"""
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
from PIL import Image  # noqa: E402

import ako_tpu  # noqa: E402
from ako_tpu.tools.rate import encode_with_ratio  # noqa: E402
from ako_tpu.utils.corpus import corpus  # noqa: E402

AKOENC = os.path.join(REPO, ".refbuild", "akoenc")
RATIOS = (4, 8, 12, 24, 48)
_TRAJ = re.compile(r"^(Target: | - Q: )")


def _ref_pass(png: str, ratio: int):
    """Reference --dev-ratio encode: (blob, trajectory_lines)."""
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "r.ako")
        r = subprocess.run(
            [AKOENC, "-i", png, "-o", out, "-dev-r", str(ratio), "-verbose"],
            capture_output=True,
            text=True,
        )
        blob = open(out, "rb").read() if r.returncode == 0 else None
    traj = [ln for ln in r.stdout.splitlines() if _TRAJ.match(ln)]
    return blob, traj


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    json_out = None
    if "--json" in sys.argv:
        json_out = sys.argv[sys.argv.index("--json") + 1]
        args = [a for a in args if a != json_out]
    n_images = int(args[0]) if args else 4

    images = corpus(42, n_images, 1280, 1024, 4)
    fails = 0
    cases = []
    for i, img in enumerate(images):
        with tempfile.TemporaryDirectory() as td:
            png = os.path.join(td, "t.png")
            Image.fromarray(img, "RGBA").save(png)
            for ratio in RATIOS:
                t0 = time.perf_counter()
                ref_blob, ref_traj = _ref_pass(png, ratio)
                buf = io.StringIO()
                try:
                    with contextlib.redirect_stdout(buf):
                        ours, q = encode_with_ratio(
                            img, ako_tpu.Settings(), ratio, verbose=True
                        )
                except ako_tpu.AkoError:
                    ours, q = None, None
                our_traj = [
                    ln for ln in buf.getvalue().splitlines() if _TRAJ.match(ln)
                ]
                blob_ok = ours == ref_blob
                traj_ok = our_traj == ref_traj
                case = {
                    "image": i,
                    "ratio": ratio,
                    "blob_bytes": None if ref_blob is None else len(ref_blob),
                    "chosen_q": q,
                    "probes": max(0, len(ref_traj) - 2),
                    "blob_identical": blob_ok,
                    "trajectory_identical": traj_ok,
                    "secs": round(time.perf_counter() - t0, 1),
                }
                cases.append(case)
                status = "ok" if blob_ok and traj_ok else "FAIL"
                print(
                    f"img {i} ratio {ratio}: {status} "
                    f"({case['blob_bytes']} B, q={q}, "
                    f"{case['probes']} probes, {case['secs']}s)",
                    flush=True,
                )
                if not (blob_ok and traj_ok):
                    fails += 1
                    if not traj_ok:
                        print("  ref:  " + " / ".join(ref_traj))
                        print("  ours: " + " / ".join(our_traj))
        jax.clear_caches()

    if json_out:
        record = {
            "metric": (
                "rate-control parity campaign: fbm 1024x1280 RGBA x ratios "
                "%s — blob bytes AND probe trajectory vs reference "
                "akoenc --dev-ratio (tools/akoenc.cpp:130-216)" % (RATIOS,)
            ),
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "images": n_images,
            "cases": cases,
            "fails": fails,
            "all_blob_identical": all(c["blob_identical"] for c in cases),
            "all_trajectory_identical": all(
                c["trajectory_identical"] for c in cases
            ),
        }
        with open(json_out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
        print(f"wrote {json_out}")
    print(f"{len(cases) - fails} ok, {fails} fail", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
