"""CLI tools: options registry behavior, Adler-32, akoenc/akodec
round-trip through PNG files, rate-control parity with a direct
encode at the chosen q."""

import os

import numpy as np
import pytest

import ako_tpu
from ako_tpu import Settings
from ako_tpu.tools.misc import adler32
from ako_tpu.tools.options import (
    BoolOption,
    IntOption,
    OptionError,
    OptionsManager,
    StringOption,
)


class TestOptions:
    def _om(self):
        om = OptionsManager("test")
        om.add_int("-q", 16, 0, 100, "cat", "")
        om.add_string("-w", "DD137", ["DD137", "CDF53"], "cat", "")
        om.add_bool("-b", "cat", "")
        return om

    def test_defaults(self):
        om = self._om()
        om.parse_arguments([])
        assert om["-q"].value == 16
        assert om["-w"].value == "DD137"
        assert om["-b"].value is False

    def test_parse(self):
        om = self._om()
        om.parse_arguments(["-q", "42", "-w", "cdf53", "-b"])
        assert om["-q"].value == 42
        assert om["-w"].index == 1  # index doubles as enum value
        assert om["-b"].value is True

    def test_errors(self):
        om = self._om()
        with pytest.raises(OptionError):
            om.parse_arguments(["-nope"])
        with pytest.raises(OptionError):
            om.parse_arguments(["-q", "101"])  # out of range
        with pytest.raises(OptionError):
            om.parse_arguments(["-q"])  # missing value
        with pytest.raises(OptionError):
            om.parse_arguments(["-w", "HAAR"])  # not in allowed set


class TestChecksum:
    def test_adler32_known(self):
        # Adler-32 of "Wikipedia" is the classic test vector
        assert adler32(b"Wikipedia") == 0x11E60398


class TestCli:
    def test_encode_decode_files(self, rng, tmp_path):
        from PIL import Image

        from ako_tpu.tools.akodec import main as dec_main
        from ako_tpu.tools.akoenc import main as enc_main

        img = rng.integers(0, 256, size=(40, 32, 3), dtype=np.uint8)
        png_in = str(tmp_path / "in.png")
        ako = str(tmp_path / "out.ako")
        png_out = str(tmp_path / "out.png")
        Image.fromarray(img).save(png_in)

        assert enc_main(["-i", png_in, "-o", ako, "-q", "0", "-quiet"]) == 0
        assert os.path.exists(ako)
        assert dec_main(["-i", ako, "-o", png_out, "-quiet"]) == 0
        out = np.asarray(Image.open(png_out))
        np.testing.assert_array_equal(out, img)  # q=0 is lossless

    def test_events_benchmark(self, rng):
        from ako_tpu.core.events import EventsData

        img = rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8)
        ev = EventsData()
        blob = ako_tpu.encode(img, Settings(quantization=16), events=ev.callback)
        assert ev.wavelet.total > 0
        assert ev.compression.total > 0
        ev2 = EventsData()
        ako_tpu.decode(blob, events=ev2.callback)
        assert ev2.wavelet.total > 0


class TestRateControl:
    def test_matches_direct_encode(self, rng):
        from ako_tpu.tools.rate import encode_with_ratio

        img = rng.integers(0, 200, size=(64, 64, 3), dtype=np.uint8)
        # smooth it so it compresses (pure noise can't hit high ratios)
        img = (img // 8 * 8).astype(np.uint8)
        blob, q = encode_with_ratio(img, Settings(), ratio=8)
        direct = ako_tpu.encode(img, Settings(quantization=q))
        assert blob == direct

    def test_ratio_one_is_lossless(self, rng):
        from ako_tpu.tools.rate import encode_with_ratio

        img = rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8)
        blob, q = encode_with_ratio(img, Settings(), ratio=1)
        assert q == 0
        out, _, _ = ako_tpu.decode(blob)
        np.testing.assert_array_equal(out, img)


class TestRateControlVsReferenceBinary:
    """encode_with_ratio must reproduce the reference akoenc's
    --dev-ratio output byte-for-byte (same search, same probes)."""

    # the gate>0 cases cover the probe-settings path: EncodePass keeps
    # the user's gate for every probe including the q=0 ceiling pass
    # (akoenc.cpp:139-143), and the gate feeds the YCoCg->YCoCg_Q switch
    @pytest.mark.parametrize("ratio,gate", [(4, 0), (8, 0), (8, 16), (4, 24)])
    def test_dev_ratio_parity(self, rng, tmp_path, ratio, gate):
        import os
        import subprocess

        akoenc = os.path.join(os.path.dirname(__file__), "..", ".refbuild", "akoenc")
        if not os.path.exists(akoenc):
            pytest.skip("reference akoenc binary not built")
        from PIL import Image

        from ako_tpu.tools.rate import encode_with_ratio

        # structured content so the ratio is reachable
        y, x = np.mgrid[0:64, 0:64].astype(np.float32)
        img = np.clip(
            np.stack(
                [120 + 90 * np.sin(x / 9), 120 + 80 * np.cos(y / 7), 128 + x - y],
                -1,
            ),
            0,
            255,
        ).astype(np.uint8)
        png = str(tmp_path / "in.png")
        out = str(tmp_path / "ref.ako")
        Image.fromarray(img).save(png)
        subprocess.run(
            [akoenc, "-i", png, "-o", out, "-dev-r", str(ratio), "-g", str(gate), "-quiet"],
            check=True,
            capture_output=True,
        )
        ref = open(out, "rb").read()
        ours, _q = encode_with_ratio(img, ako_tpu.Settings(gate=gate), ratio)
        assert ours == ref


class TestDeveloperDump:
    def test_pgm_clamps_like_reference(self, tmp_path):
        """developer.c:40 clamps to [0,255] (nested ternary), it does
        NOT truncate to the low byte."""
        from ako_tpu.utils.developer import save_pgm_i16

        plane = np.array([[-5, 0, 1, 254], [255, 256, 300, -32768]], np.int16)
        path = str(tmp_path / "p.pgm")
        save_pgm_i16(plane, path)
        data = open(path, "rb").read()
        assert data.startswith(b"P5\n4\n2\n255\n")
        pixels = np.frombuffer(data[len(b"P5\n4\n2\n255\n"):], np.uint8)
        np.testing.assert_array_equal(
            pixels, [0, 0, 1, 254, 255, 255, 255, 0]
        )


class TestProfilerTrace:
    def test_trace_dir_populated(self, rng, tmp_path, monkeypatch):
        """AKO_TPU_TRACE_DIR wraps encode/decode in a jax profiler
        trace (the device analog of the reference's -b per-stage
        stopwatches, SURVEY.md §5)."""
        trace_dir = str(tmp_path / "trace")
        monkeypatch.setenv("AKO_TPU_TRACE_DIR", trace_dir)
        img = rng.integers(0, 256, size=(24, 16, 3), dtype=np.uint8)
        blob = ako_tpu.encode(img, Settings(quantization=16))
        out, _, _ = ako_tpu.decode(blob)
        np.testing.assert_array_equal(out.shape, img.shape)
        import glob as _glob

        files = _glob.glob(os.path.join(trace_dir, "**", "*"), recursive=True)
        assert any(os.path.isfile(f) for f in files), files


class TestPngEffort:
    """The `-e` effort presets (reference tools/akodec.cpp:44-68):
    effort maps onto BOTH a zlib preset and a per-row filter strategy
    (stored+unfiltered at 1, MINSUM at 2..9, brute force at 10).
    Pixels never depend on effort; only the PNG file size does."""

    def test_roundtrip_all_channels_and_efforts(self, rng):
        from PIL import Image

        from ako_tpu.tools.pngout import write_png

        y, x = np.mgrid[0:60, 0:44].astype(np.float32)
        for ch in (1, 2, 3, 4):
            img = np.clip(
                120 + 70 * np.sin(x / 13)[..., None]
                + rng.normal(0, 6, (60, 44, ch)),
                0, 255,
            ).astype(np.uint8)
            for effort in (1, 2, 7, 10):
                path = f"/tmp/ako_pngout_{ch}_{effort}.png"
                write_png(path, img, effort)
                back = np.asarray(Image.open(path))
                if back.ndim == 2:
                    back = back[:, :, None]
                np.testing.assert_array_equal(back, img)

    def test_effort_changes_size_not_pixels(self, rng):
        import os as _os

        from ako_tpu.tools.pngout import write_png

        y, x = np.mgrid[0:80, 0:64].astype(np.float32)
        img = np.clip(
            120 + 60 * np.sin(x / 11) + 50 * np.cos(y / 7)
            + rng.normal(0, 4, (80, 64)),
            0, 255,
        ).astype(np.uint8)[..., None].repeat(3, axis=2)
        sizes = {}
        for effort in (1, 5, 9):
            path = f"/tmp/ako_pngout_sz_{effort}.png"
            write_png(path, img, effort)
            sizes[effort] = _os.path.getsize(path)
        # effort 1 stores rows raw over an uncompressed stream —
        # strictly larger than any compressed preset on smooth content
        assert sizes[1] > sizes[5] >= sizes[9]

    def test_cli_writes_effort_png(self, rng, tmp_path):
        from PIL import Image

        from ako_tpu.tools import akodec, akoenc

        img = rng.integers(0, 256, size=(24, 16, 3), dtype=np.uint8)
        src = tmp_path / "in.png"
        Image.fromarray(img).save(src)
        blob_path = tmp_path / "x.ako"
        out_path = tmp_path / "out.png"
        assert akoenc.main(["-i", str(src), "-o", str(blob_path), "-q", "16"]) == 0
        assert akodec.main(
            ["-i", str(blob_path), "-o", str(out_path), "-e", "9"]
        ) == 0
        blob = open(blob_path, "rb").read()
        np.testing.assert_array_equal(
            np.asarray(Image.open(out_path)), ako_tpu.decode(blob)[0]
        )
