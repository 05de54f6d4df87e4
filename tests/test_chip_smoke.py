"""chip_smoke.py's phases at a tiny size on the CPU, with the device
entropy coder forced on (the GPU's default path). The GPU check lives
in chip_smoke.main only; here it must refuse the CPU backend."""

from __future__ import annotations

import os

import numpy as np
import pytest

import chip_smoke
from ako_tpu import Settings
from ako_tpu.utils.corpus import corpus

TINY = dict(n=2, h=128, w=96, big_h=200, big_w=136, tiles=32)


def test_main_refuses_cpu(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert capsys.readouterr().out == ""  # no result line without a GPU


def test_phase_golden():
    chip_smoke.phase_golden(dev=True)


def test_phase_stream_tiny():
    out = chip_smoke.phase_stream(dev=True, workers=2, **TINY)
    assert (out["images"], out["tiles"]) == (3, 12 + 12 + 35)
    assert out["warm_pass_s"] > 0 and out["compile_s"] > 0


def test_phase_stream_refuses_host_entropy():
    with pytest.raises(chip_smoke.SmokeFailure, match="host coder"):
        chip_smoke.phase_stream(dev=False, timings=False, **TINY)


@pytest.mark.parametrize("case", list(chip_smoke.MATRIX))
def test_matrix_case(case):
    chip_smoke.MATRIX[case](True)


@pytest.mark.parametrize("name", list(chip_smoke.GOLDEN_SETTINGS))
def test_native_reference_matches_golden(name):
    # the plain reference the smoke compares with reproduces the
    # reference-made golden files
    image = np.load(os.path.join(chip_smoke.GOLDEN, "image_40x48_rgb.npy"))
    s = Settings(**chip_smoke.GOLDEN_SETTINGS[name])
    with open(os.path.join(chip_smoke.GOLDEN, f"{name}.ako"), "rb") as f:
        golden = f.read()
    assert chip_smoke.native_encode(image, s) == golden
    want = np.load(os.path.join(chip_smoke.GOLDEN, f"{name}_decoded.npy"))
    assert np.array_equal(chip_smoke.native_decode(golden), want)


def test_phase_four_on_virtual_devices():
    chip_smoke.phase_four(n=4, h=128, w=96, tiles=32, plane=64)


def test_phase_tools():
    img = corpus(42, 1, 128, 96, 4)[0]
    out = chip_smoke.phase_tools(img, dict(quantization=16, tiles_dimension=32))
    assert out["akoenc"] in ("ran", "not run (Pillow absent)")
