"""runtime/device.py: the one device-entropy decision, the GPU check
and the compile-cache location."""

from __future__ import annotations

import os

import jax
import pytest

from ako_tpu.runtime import device


def test_device_entropy_default_is_host_on_cpu():
    assert jax.default_backend() == "cpu"
    assert device.device_entropy_default() is False
    assert device.resolve_device_entropy(None) is False


def test_device_entropy_default_is_device_on_gpu(monkeypatch):
    monkeypatch.setattr(device.jax, "default_backend", lambda: "gpu")
    assert device.device_entropy_default() is True
    assert device.resolve_device_entropy(None) is True


@pytest.mark.parametrize("requested", [True, False])
def test_explicit_choice_wins(requested):
    assert device.resolve_device_entropy(requested) is requested


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_fixed_repo_path(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)  # the path must not follow the cwd
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert device.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
