"""Golden-file regression tests: committed blobs and decoded pixels
pin the wire format without needing the reference sources (the suites
in test_roundtrip.py etc. verify against the reference when present;
these catch format drift anywhere)."""

import os

import numpy as np
import pytest

import ako_tpu
from ako_tpu import Settings

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

SETTINGS = {
    "q16": Settings(quantization=16),
    "lossless": Settings(quantization=0, gate=0),
    "tiled_q16": Settings(quantization=16, tiles_dimension=16),
}


@pytest.fixture(scope="module")
def image():
    return np.load(os.path.join(GOLDEN, "image_40x48_rgb.npy"))


@pytest.mark.parametrize("name", list(SETTINGS))
def test_encode_matches_golden(image, name):
    blob = ako_tpu.encode(image, SETTINGS[name])
    golden = open(os.path.join(GOLDEN, f"{name}.ako"), "rb").read()
    assert blob == golden


@pytest.mark.parametrize("name", list(SETTINGS))
def test_decode_matches_golden(name):
    blob = open(os.path.join(GOLDEN, f"{name}.ako"), "rb").read()
    out, _, _ = ako_tpu.decode(blob)
    golden = np.load(os.path.join(GOLDEN, f"{name}_decoded.npy"))
    np.testing.assert_array_equal(out, golden)


@pytest.mark.parametrize("name", list(SETTINGS))
def test_encode_matches_golden_device_entropy(image, name):
    # the GPU's default path: device Kagari pack, forced on the CPU
    blob = ako_tpu.encode(image, SETTINGS[name], device_entropy=True)
    golden = open(os.path.join(GOLDEN, f"{name}.ako"), "rb").read()
    assert blob == golden


@pytest.mark.parametrize("name", list(SETTINGS))
def test_decode_matches_golden_device_entropy(name):
    # the GPU's default path: sync scan + device gamma decode
    blob = open(os.path.join(GOLDEN, f"{name}.ako"), "rb").read()
    out, _, _ = ako_tpu.decode(blob, device_entropy=True)
    golden = np.load(os.path.join(GOLDEN, f"{name}_decoded.npy"))
    np.testing.assert_array_equal(out, golden)


def test_lossless_golden_roundtrips(image):
    blob = open(os.path.join(GOLDEN, "lossless.ako"), "rb").read()
    out, _, _ = ako_tpu.decode(blob)
    np.testing.assert_array_equal(out, image)
