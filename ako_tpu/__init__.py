"""ako_tpu — an accelerator-native still-image codec framework in JAX.

A from-scratch rebuild of the capabilities of the Ako image codec
(reference: baAlex/Ako, an integer lifting-DWT codec in C11) designed
device-first: the per-tile compute pipeline (color transform, dyadic
integer wavelet lifting with fused quantization/noise-gate) runs as
XLA programs over batched planar int16 tile tensors, and the
bitstream layer (Elias-gamma + RLE entropy coding) runs on the device
as a scan-based coder, with the native C coder on the host as the
exact fallback and the CPU path; container framing runs on the host.

Bit-exactness contract: for every setting combination the produced
`.ako` blob is byte-identical to the reference encoder's output and
decoded pixels are bit-identical to the reference decoder's
(reference library/encode.c:38, library/decode.c:38 — the codec is
all-integer and deterministic).
"""

from ako_tpu.core.settings import (
    Settings,
    Wavelet,
    Color,
    Wrap,
    Compression,
    Status,
    AkoError,
    default_settings,
    status_string,
    MAX_CHANNELS,
    MIN_TILES_DIMENSION,
    MAX_TILES_DIMENSION,
    FORMAT_VERSION,
    VERSION_MAJOR,
    VERSION_MINOR,
    VERSION_PATCH,
)
from ako_tpu.encode import encode
from ako_tpu.decode import decode

__version__ = f"{VERSION_MAJOR}.{VERSION_MINOR}.{VERSION_PATCH}"

__all__ = [
    "Settings",
    "Wavelet",
    "Color",
    "Wrap",
    "Compression",
    "Status",
    "AkoError",
    "default_settings",
    "status_string",
    "encode",
    "decode",
    "MAX_CHANNELS",
    "MIN_TILES_DIMENSION",
    "MAX_TILES_DIMENSION",
    "FORMAT_VERSION",
]
