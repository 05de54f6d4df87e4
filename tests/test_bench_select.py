"""bench.py configuration auto-selection (no devices needed).

The benchmark races stream-shape x transport x decode-placement
candidates with interleaved probe medians (bench._select_config);
these tests pin the selection/pinning semantics with stub pass
functions so a regression cannot silently change what the driver's
round-end bench measures.
"""

from __future__ import annotations

import importlib.util
import os

import pytest

_spec = importlib.util.spec_from_file_location(
    "bench", os.path.join(os.path.dirname(os.path.dirname(__file__)), "bench.py")
)
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)


def _stub(t):
    def fn(images, settings, warm=True):
        return t, ["blob"], ["pix"]

    return fn


def _env(transport="0", enctr="", decode="device", encode="device"):
    return {
        "AKO_TPU_TRANSPORT": transport,
        "AKO_TPU_TRANSPORT_ENC": enctr,
        "AKO_TPU_DECODE": decode,
        "AKO_TPU_ENCODE": encode,
    }


@pytest.fixture(autouse=True)
def _clean_env():
    # explicit snapshot/restore rather than monkeypatch.delenv:
    # bench._run_candidate writes os.environ DIRECTLY during the test,
    # and monkeypatch does not track keys that were absent beforehand,
    # so those writes would leak into later tests in the same worker
    # (observed: a leaked AKO_TPU_DECODE=host flipped test_events onto
    # the host-decode path)
    keys = [
        "AKO_BENCH_MODE",
        "AKO_TPU_TRANSPORT",
        "AKO_TPU_TRANSPORT_ENC",
        "AKO_TPU_DECODE",
        "AKO_TPU_ENCODE",
    ]
    saved = {k: os.environ.pop(k, None) for k in keys}
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def test_candidates_unpinned_races_all_eight():
    names = [c[0] for c in bench._candidates()]
    assert names == [
        "seq+raw",
        "roundtrip+raw",
        "roundtrip+transport",
        "seq+hostdec",
        "roundtrip+hostdec",
        "roundtrip+hostdec+enctr",
        "seq+hostenc+hostdec",
        "roundtrip+hostenc+hostdec",
    ]


def test_candidates_pinning(monkeypatch):
    monkeypatch.setenv("AKO_BENCH_MODE", "roundtrip")
    assert [c[0] for c in bench._candidates()] == [
        "roundtrip+raw",
        "roundtrip+transport",
        "roundtrip+hostdec",
        "roundtrip+hostdec+enctr",
        "roundtrip+hostenc+hostdec",
    ]
    monkeypatch.setenv("AKO_TPU_TRANSPORT", "1")
    assert [c[0] for c in bench._candidates()] == [
        "roundtrip+transport",
        "roundtrip+hostdec+enctr",
        "roundtrip+hostenc+hostdec",
    ]
    monkeypatch.setenv("AKO_TPU_DECODE", "device")
    assert [c[0] for c in bench._candidates()] == [
        "roundtrip+transport",
        "roundtrip+hostenc",
    ]
    monkeypatch.setenv("AKO_TPU_ENCODE", "device")
    assert [c[0] for c in bench._candidates()] == ["roundtrip+transport"]
    monkeypatch.setenv("AKO_BENCH_MODE", "seq")
    monkeypatch.setenv("AKO_TPU_TRANSPORT", "0")
    assert [c[0] for c in bench._candidates()] == ["seq+raw"]
    monkeypatch.setenv("AKO_TPU_DECODE", "host")
    assert [c[0] for c in bench._candidates()] == ["seq+hostdec"]
    monkeypatch.setenv("AKO_TPU_ENCODE", "host")
    assert [c[0] for c in bench._candidates()] == ["seq+hostenc+hostdec"]


def test_candidates_host_env_values():
    by_name = {c[0]: c[2] for c in bench._candidates()}
    assert by_name["roundtrip+hostdec"]["AKO_TPU_DECODE"] == "host"
    assert by_name["roundtrip+hostdec"]["AKO_TPU_TRANSPORT_ENC"] == "0"
    assert by_name["roundtrip+hostdec"]["AKO_TPU_ENCODE"] == "device"
    assert by_name["roundtrip+hostdec+enctr"]["AKO_TPU_TRANSPORT_ENC"] == "1"
    assert by_name["roundtrip+transport"]["AKO_TPU_DECODE"] == "device"
    assert by_name["roundtrip+hostenc+hostdec"]["AKO_TPU_ENCODE"] == "host"
    assert by_name["roundtrip+hostenc+hostdec"]["AKO_TPU_DECODE"] == "host"
    assert by_name["roundtrip+hostenc+hostdec"]["AKO_TPU_TRANSPORT"] == "0"


def test_select_config_picks_fastest_median(monkeypatch):
    monkeypatch.setattr(bench, "bench_ours", _stub(9.0))
    cands = [
        ("seq+raw", _stub(9.0), _env()),
        ("roundtrip+raw", _stub(3.0), _env()),
        ("roundtrip+transport", _stub(4.0), _env("1")),
        ("roundtrip+hostdec", _stub(5.0), _env(decode="host")),
    ]
    (name, fn, env), medians = bench._select_config(cands, [], None)
    assert name == "roundtrip+raw" and env["AKO_TPU_DECODE"] == "device"
    assert medians["roundtrip+raw"] == 3.0 and len(medians) == 4


def test_select_config_sets_env(monkeypatch):
    seen = []

    def spy(images, settings, warm=True):
        seen.append(
            (
                os.environ.get("AKO_TPU_TRANSPORT"),
                os.environ.get("AKO_TPU_DECODE"),
            )
        )
        return 1.0, [], []

    monkeypatch.setattr(bench, "bench_ours", spy)
    cands = [
        ("seq+raw", spy, _env("0")),
        ("seq+hostdec", spy, _env("0", "0", "host")),
    ]
    bench._select_config(cands, [], None)
    # one device-path warm pass (single distinct transport value), then
    # 3 interleaved rounds over both candidates
    assert seen[0] == ("0", "device")
    assert seen[1:] == [("0", "device"), ("0", "host")] * bench.PROBE_ROUNDS


def test_select_config_single_candidate_warms_only(monkeypatch):
    calls = []

    def spy(images, settings, warm=True):
        calls.append(1)
        return 1.0, [], []

    monkeypatch.setattr(bench, "bench_ours", spy)
    (name, fn, env), medians = bench._select_config(
        [("seq+raw", spy, _env())], [], None
    )
    assert name == "seq+raw" and len(calls) == 1 and medians == {}


def test_main_refuses_cpu(capsys):
    # a run without a GPU fails before measuring anything
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main()
    assert capsys.readouterr().out == ""
