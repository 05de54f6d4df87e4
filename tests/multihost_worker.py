"""Worker process for the multi-process multihost test.

Invoked by tests/test_multihost.py as:
    python tests/multihost_worker.py <coord> <nproc> <pid> <outfile>

Brings up jax.distributed over CPU, runs HostShardedPipeline on this
process's round-robin shard of a deterministic image stream, exercises
global_mesh(), and pickles {"blobs": {gidx: blob}, "pixels_ok": bool,
"mesh_shape": dict, "process": (pid, nproc)} to <outfile>.
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
).strip()

import jax

# pin the CPU backend in the config too, so an accelerator plugin that
# is installed is never initialized by the worker
jax.config.update("jax_platforms", "cpu")


def main() -> int:
    coord, nproc, pid, outfile = (
        sys.argv[1],
        int(sys.argv[2]),
        int(sys.argv[3]),
        sys.argv[4],
    )

    import numpy as np

    from ako_tpu.parallel import multihost

    multihost.initialize(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )
    assert multihost.process_info() == (pid, nproc)

    mesh = multihost.global_mesh()
    mesh_shape = dict(mesh.shape)

    # deterministic image stream, identical in every process
    rng = np.random.default_rng(7)
    images = [
        (rng.integers(0, 256, size=(40, 48, 3)) // 4 * 4).astype(np.uint8)
        for _ in range(5)
    ]

    import ako_tpu

    settings = ako_tpu.Settings(quantization=16)
    pipe = multihost.HostShardedPipeline(settings, workers=2)
    blobs = dict(pipe.encode_shard(images))

    # decode this shard back and verify against the source images
    all_blobs = [ako_tpu.encode(img, settings) for img in images]
    pixels_ok = True
    for gidx, img in pipe.decode_shard(all_blobs):
        dec = np.asarray(ako_tpu.decode(all_blobs[gidx])[0])
        pixels_ok = pixels_ok and np.array_equal(img, dec)

    with open(outfile, "wb") as f:
        pickle.dump(
            {
                "blobs": blobs,
                "pixels_ok": pixels_ok,
                "mesh_shape": mesh_shape,
                "process": (pid, nproc),
            },
            f,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
