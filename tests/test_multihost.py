"""Multi-process multihost execution (BASELINE configs[4] structure).

Spawns real jax.distributed CPU processes (2 processes x 2 virtual
devices) running HostShardedPipeline end-to-end and asserts:
- every process sees the pod-wide device set (global_mesh covers
  process_count * local_device_count devices),
- the union of per-process shards covers the image stream exactly once,
- every shard blob is byte-identical to a single-process encode.

The reference has no distributed counterpart (SURVEY.md §2.4); this is
the multi-host tier of the multi-device design, where images shard over hosts
and no codec bytes cross processes.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

import ako_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("nproc", [2, 4])
def test_multiprocess_pipeline(nproc, tmp_path):
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    outfiles = [str(tmp_path / f"out{pid}.pkl") for pid in range(nproc)]

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coord, str(nproc), str(pid), outfiles[pid]],
            env=env,
            cwd=REPO,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
        )
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=240)
            outs.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, stdout, stderr in outs:
        assert rc == 0, f"worker failed:\n{stderr.decode()[-2000:]}"

    results = [pickle.load(open(f, "rb")) for f in outfiles]

    # pod-wide mesh seen identically from every process
    for r in results:
        assert r["mesh_shape"] == {"hosts": nproc, "tiles": 2}
        assert r["pixels_ok"]

    # shard union covers the stream exactly once
    indices = sorted(i for r in results for i in r["blobs"])
    assert indices == list(range(5))

    # per-index byte parity with a single-process encode
    rng = np.random.default_rng(7)
    images = [
        (rng.integers(0, 256, size=(40, 48, 3)) // 4 * 4).astype(np.uint8)
        for _ in range(5)
    ]
    settings = ako_tpu.Settings(quantization=16)
    expected = [ako_tpu.encode(img, settings) for img in images]
    for r in results:
        for gidx, blob in r["blobs"].items():
            assert blob == expected[gidx], f"blob {gidx} diverges"
