"""runtime/build.py: the native library is keyed to its source, the
compiler flags and the host CPU, so a library built on another host
is never loaded."""

from __future__ import annotations

import os

from ako_tpu.runtime import build


def test_key_follows_host_and_flags(monkeypatch):
    monkeypatch.setattr(build, "_cpu_id", lambda: "host-a")
    a = build.build_key()
    assert build.build_key() == a
    monkeypatch.setattr(build, "_cpu_id", lambda: "host-b")
    b = build.build_key()
    assert b != a
    monkeypatch.setenv("AKO_CC_FLAGS", "-O1")
    assert build.build_key() not in (a, b)
    assert os.path.basename(build.library_path()).startswith("_akort-")


def test_library_from_another_host_is_rebuilt(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_OUT_DIR", str(tmp_path))
    monkeypatch.setenv("AKO_CC_FLAGS", "-O0")
    built = []
    real_compile = build._compile
    monkeypatch.setattr(
        build, "_compile", lambda path: (built.append(path), real_compile(path))
    )
    monkeypatch.setattr(build, "_cpu_id", lambda: "host-a")
    a = build.ensure_built()
    assert build.ensure_built() == a and built == [a]  # cached on its host
    monkeypatch.setattr(build, "_cpu_id", lambda: "host-b")
    b = build.ensure_built()
    assert b != a and built == [a, b]  # the other host's build is not reused
    assert os.path.getsize(b) > 0
