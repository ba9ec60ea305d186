"""Native I/O library parity tests: the pure-Python implementations in
imageio.py are the executable spec; native/stereo_io.cpp must produce
byte-identical output.  Builds the library with make if a compiler is
available; skips otherwise."""

import os
import shutil
import struct
import subprocess
import zlib

import numpy as np
import pytest

from stereomatching.utils import native
from stereomatching.utils.imageio import ImageType
from tests.util import synthetic_pair

NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
# 24x40 grayscale PNG whose rows cycle through all five PNG filter types.
FILTERS_PNG = os.path.join(os.path.dirname(__file__), "data", "filters.png")


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    subprocess.run(["make", "-C", NATIVE_DIR], check=True, capture_output=True)
    # Reset the cached load state so the fresh build is picked up.
    native._lib = None
    native._lib_checked = False
    if not native.available():
        pytest.skip("native lib failed to load")
    return native


def _python_ppm(data, imtype):
    """The pure-Python renderer, bypassing native dispatch."""
    import io

    if imtype == ImageType.BINARY:
        v = np.where(data == 1, 0, 255).astype(np.int64)
    else:
        mn, mx = int(data.min()), int(data.max())
        rng = mx - mn
        v = (
            np.zeros_like(data, dtype=np.int64)
            if rng == 0
            else (data.astype(np.int64) - mn) * 255 // rng
        )
    h, w = data.shape
    buf = io.StringIO()
    buf.write(f"P3\n{w} {h}\n255\n")
    buf.write("".join(f"{int(p)} {int(p)} {int(p)}\n" for p in v.ravel()))
    return buf.getvalue().encode("ascii")


def test_ppm_render_binary_parity(lib):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 2, size=(33, 47)).astype(np.int64)
    assert lib.ppm_render(data, "binary") == _python_ppm(data, ImageType.BINARY)


def test_ppm_render_gray_int_parity(lib):
    rng = np.random.default_rng(1)
    data = rng.integers(-17, 9000, size=(21, 64)).astype(np.int64)
    assert lib.ppm_render(data, "gray_int") == _python_ppm(data, ImageType.GRAY_INT)


def test_ppm_render_gray_float_parity(lib):
    """GRAY_FLOAT (reference src/image.c:46, trunc(v*255.0)) must match
    the Python spec byte for byte on in-range brightness planes."""
    import io

    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, size=(19, 37)).astype(np.float64) / 256.0

    v = (data * 255.0).astype(np.int64)
    h, w = data.shape
    buf = io.StringIO()
    buf.write(f"P3\n{w} {h}\n255\n")
    buf.write("".join(f"{int(p)} {int(p)} {int(p)}\n" for p in v.ravel()))
    want = buf.getvalue().encode("ascii")
    assert lib.ppm_render(data, "gray_float") == want


def test_ppm_render_gray_float_out_of_range(lib):
    """Out-of-range values print verbatim like the Python spec's %d.
    Small overflows still fit the standard buffer bound; planes that
    exceed it make the renderer decline (None -> Python fallback)."""
    import io

    data = np.array([[5000.0, 0.5], [-3.0, 0.25]])
    v = (data * 255.0).astype(np.int64)
    buf = io.StringIO()
    buf.write("P3\n2 2\n255\n")
    buf.write("".join(f"{int(p)} {int(p)} {int(p)}\n" for p in v.ravel()))
    assert lib.ppm_render(data, "gray_float") == buf.getvalue().encode()

    huge = np.full((8, 8), 1e13)
    assert lib.ppm_render(huge, "gray_float") is None

    from stereomatching.utils.imageio import ppm_bytes

    out = ppm_bytes(huge, ImageType.GRAY_FLOAT)
    assert out.startswith(b"P3\n8 8\n255\n2550000")


def test_ppm_render_constant_plane(lib):
    data = np.full((5, 7), 42, dtype=np.int64)
    assert lib.ppm_render(data, "gray_int") == _python_ppm(data, ImageType.GRAY_INT)


def test_png_roundtrip(lib):
    img, _ = synthetic_pair(h=40, w=56, seed=6)
    encoded = lib.png_write_gray(img)
    decoded = lib.png_read_gray(encoded)
    np.testing.assert_array_equal(decoded, img)


def test_png_write_matches_python_spec(lib, tmp_path):
    """Native encoder output must byte-match the Python encoder (both use
    filter-0 rows + zlib level 9)."""
    import io
    import struct
    import zlib

    img, _ = synthetic_pair(h=24, w=31, seed=8)
    pixels = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = pixels.shape

    def chunk(tag, payload):
        return (
            struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    raw = b"".join(b"\x00" + pixels[y].tobytes() for y in range(h))
    want = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 9))
        + chunk(b"IEND", b"")
    )
    assert lib.png_write_gray(pixels) == want


def _row_filter_types(data: bytes) -> set:
    """The filter-type byte of every scanline of a gray 8-bit PNG."""
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", payload[:8])
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + n
    raw = zlib.decompress(idat)
    return {raw[y * (w + 1)] for y in range(h)}


def test_png_read_reference_fixture(lib):
    """The native decoder must handle every PNG filter type (0-4) and
    agree with the pure-Python decoder."""
    from stereomatching.utils import imageio

    with open(FILTERS_PNG, "rb") as f:
        data = f.read()
    assert _row_filter_types(data) == {0, 1, 2, 3, 4}
    out = lib.png_read_gray(data)
    assert out.shape == (24, 40) and int(out.sum()) == 134617
    lib_state = (native._lib, native._lib_checked)
    try:
        native._lib, native._lib_checked = None, True  # force pure Python
        want = imageio.read_png_gray(FILTERS_PNG)
    finally:
        native._lib, native._lib_checked = lib_state
    np.testing.assert_array_equal(out, want)


def test_png_rejects_non_grayscale(lib):
    with pytest.raises(ValueError, match="grayscale|PNG"):
        lib.png_read_gray(b"\x89PNG\r\n\x1a\n" + b"\x00" * 40)
