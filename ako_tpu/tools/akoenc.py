"""akoenc: PNG (or any Pillow-readable image) -> .ako.

Behavioral rebuild of reference tools/akoenc.cpp:325-462 — same flag
surface (-q -g -w -c -wr -chroma-loss -d -b -ch -dev-r), same
compression-summary output, same rate-control semantics for
--dev-ratio (see rate.py). PNG decode via Pillow instead of the
vendored lodepng."""

from __future__ import annotations

import sys

import numpy as np

import ako_tpu
from ako_tpu import Color, Compression, Settings, Wavelet, Wrap
from ako_tpu.core.events import EventsData
from ako_tpu.tools.misc import adler32, write_blob
from ako_tpu.tools.options import OptionsManager, OptionError

WAVELETS = ["DD137", "CDF53", "HAAR", "NONE"]
COLORS = ["YCOCG", "SUBTRACT-G", "NONE"]
WRAPS = ["CLAMP", "MIRROR", "REPEAT", "ZERO"]
COMPRESSIONS = ["KAGARI", "MANBAVARAN", "NONE"]
COLOR_ENUM = [Color.YCOCG, Color.SUBTRACT_G, Color.NONE]


def build_options() -> OptionsManager:
    """Flag surface of the reference encoder (tools/akoenc.cpp:337-447),
    short and long spellings; -t (tiles dimension) is an extension the
    reference library supports but its CLI never exposed."""
    om = OptionsManager("akoenc", "Ako encoding tool (JAX)")
    om.add_string("-i", "", None, "Input/output", "input image filename", "--input")
    om.add_string("-o", "", None, "Input/output", "output .ako filename", "--output")
    om.add_int("-q", 16, 0, 65535, "Encoding", "quantization factor", "--quantization")
    om.add_int("-g", 0, 0, 65535, "Encoding", "noise gate factor", "--noise-gate")
    om.add_string("-w", "DD137", WAVELETS, "Encoding", "wavelet transformation", "--wavelet")
    om.add_string("-c", "YCOCG", COLORS, "Encoding", "color transformation", "--color")
    om.add_string("-wr", "CLAMP", WRAPS, "Encoding", "wrap mode", "--wrap")
    om.add_int("-t", 0, 0, 2**31, "Encoding", "tiles dimension (power of 2, or 0)", "--tiles")
    om.add_int("-chroma-loss", 1, 0, 65535, "Encoding", "extra chroma quantization", "--chroma-loss")
    om.add_bool("-d", "Encoding", "discard non-visible pixel data", "--discard-non-visible")
    om.add_bool("-b", "Extra", "benchmark (per-stage timings)", "--benchmark")
    om.add_bool("-ch", "Extra", "print input Adler32 checksum", "--checksum")
    om.add_bool("-verbose", "Extra", "print encode settings", "--verbose")
    om.add_bool("-quiet", "Extra", "no output except errors", "--quiet")
    om.add_bool("-v", "Extra", "print version and exit", "--version")
    om.add_bool("-h", "Extra", "print this help", "--help")
    om.add_int("-dev-r", 0, 0, 4096, "Developer", "rate control: target ratio N:1", "--dev-ratio")
    om.add_string(
        "-dev-compression", "KAGARI", COMPRESSIONS, "Developer", "compression method",
        "--dev-compression",
    )
    om.add_bool("-dev-no-write", "Developer", "encode but do not write output", "--dev-no-write")
    return om


def load_image(path: str) -> np.ndarray:
    from PIL import Image

    im = Image.open(path)
    if im.mode not in ("L", "LA", "RGB", "RGBA"):
        im = im.convert("RGBA")
    arr = np.asarray(im, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def main(argv=None) -> int:
    from ako_tpu.runtime.device import enable_compile_cache

    enable_compile_cache()
    om = build_options()
    try:
        om.parse_arguments(sys.argv[1:] if argv is None else argv)
    except OptionError as e:
        print(f"akoenc: {e}", file=sys.stderr)
        return 1

    if om["-h"].value:
        om.print_help()
        return 0
    if om["-v"].value:
        print(f"akoenc (ako_tpu) v{ako_tpu.__version__}")
        print(f"format version {ako_tpu.FORMAT_VERSION}")
        return 0

    quiet = om["-quiet"].value
    in_path = om["-i"].value
    out_path = om["-o"].value
    if not in_path:
        print("akoenc: no input filename (-i)", file=sys.stderr)
        return 1

    image = load_image(in_path)
    h, w, ch = image.shape

    s = Settings(
        wavelet=Wavelet(om["-w"].index),
        color=COLOR_ENUM[om["-c"].index],
        wrap=Wrap(om["-wr"].index),
        compression=Compression(om["-dev-compression"].index),
        tiles_dimension=om["-t"].value,
        quantization=om["-q"].value,
        gate=om["-g"].value,
        chroma_loss=om["-chroma-loss"].value,
        discard_non_visible=om["-d"].value,
    )

    if om["-verbose"].value and not quiet:
        print(f"input: {in_path} ({w}x{h} px, {ch} channels)")
        for field in (
            "wavelet", "color", "wrap", "compression", "tiles_dimension",
            "quantization", "gate", "chroma_loss", "discard_non_visible",
        ):
            print(f"  {field}: {getattr(s, field)}")

    if om["-ch"].value and not quiet:
        print(f"input checksum: 0x{adler32(image):08X}")

    events_data = EventsData() if om["-b"].value else None
    events = events_data.callback if events_data else None

    try:
        if om["-dev-r"].value > 0:
            from ako_tpu.tools.rate import encode_with_ratio

            blob, q_used = encode_with_ratio(
                image, s, om["-dev-r"].value,
                verbose=om["-verbose"].value and not quiet,
            )
            if not quiet:
                print(f"rate control: quantization {q_used}")
        else:
            blob = ako_tpu.encode(image, s, events=events)
    except ako_tpu.AkoError as e:
        print(f"akoenc: {e}", file=sys.stderr)
        return 1

    if events_data and not quiet:
        print(events_data.summary())

    raw = w * h * ch
    if not quiet:
        bpp = len(blob) * 8.0 / (w * h)
        print(
            f"{in_path}: {raw / 1000.0:.2f} kB -> {len(blob) / 1000.0:.2f} kB, "
            f"ratio: {raw / len(blob):.1f}:1, {bpp:.4f} bpp"
        )

    if out_path and not om["-dev-no-write"].value:
        write_blob(out_path, blob)
    return 0


if __name__ == "__main__":
    sys.exit(main())
