"""Device placement decisions shared by every entry point.

One place answers the two questions the codec asks of its backend:
whether entropy coding runs on the device (the scan-based Kagari
packer and block-parallel decoder of ops/kagari_device.py) or on the
host's native coder, and whether an accelerator is present at all.
It also keeps the persistent compilation cache at one fixed path, so
separate processes of one checkout find each other's programs.
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional

import jax

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def device_entropy_default() -> bool:
    """Entropy coding runs on the device on any accelerator backend.
    On the CPU backend the native host coder is faster than XLA's CPU
    code for the same scan, so it stays on the host there."""
    return jax.default_backend() != "cpu"


def resolve_device_entropy(requested: Optional[bool]) -> bool:
    """A caller's explicit choice wins; None means the default above."""
    return device_entropy_default() if requested is None else bool(requested)


def require_gpu() -> None:
    """Raise unless JAX's first device is a GPU. Measurements and the
    chip smoke call this first, so they never report a CPU run."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform} ({dev.device_kind})"
        )


def card_line() -> str:
    """The GPUs' names and power limits as `nvidia-smi` reports them,
    one card per `;`-separated entry. Read by a child process that
    stays off JAX. A card may run below its maximum power, so every
    recorded GPU timing carries this line."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return "; ".join(line.strip() for line in r.stdout.strip().splitlines())


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    JAX_COMPILATION_CACHE_DIR when that is set, else at the fixed
    `<repo>/.jax_cache` (the path is part of the cache key, so a
    directory that moved with the working directory would never hit).
    Returns the directory in use."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO, ".jax_cache"
    )
    jax.config.update("jax_compilation_cache_dir", path)
    return path
