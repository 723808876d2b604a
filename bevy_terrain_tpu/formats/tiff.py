"""Source imagery loading, twin of the reference's TiffLoader
(/root/reference/src/formats/tiff.rs:14-62 — all sample types cast to the
attachment's dtype). Normalizes to (H, W, C) float32 in [0, 1] with
0 == nodata.

PNG (8- and 16-bit gray, gray+alpha, RGB, RGBA; non-interlaced) is read
and written with numpy and ``zlib`` alone, and ``.npy`` arrays load
directly; 16-bit sources keep their precision. Every other format (TIFF,
JPEG, palette or interlaced PNG) goes through PIL, imported only then.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels (0 gray, 2 RGB, 4 gray+alpha, 6 RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class UnsupportedPNG(ValueError):
    """A PNG variant the numpy codec does not decode (palette, interlaced,
    sub-byte depths)."""


def _unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int) -> np.ndarray:
    """Reconstruct filtered PNG scanlines (PNG spec section 9) into a
    (rows, stride) uint8 array."""
    from bevy_terrain_tpu import native

    if native.available():
        return native.png_unfilter(raw, rows, stride, bpp)
    lines = raw.reshape(rows, stride + 1)
    out = np.zeros((rows, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(rows):
        ft = int(lines[y, 0])
        f = lines[y, 1:].astype(np.int32)
        if ft == 0:
            cur = f
        elif ft == 2:
            cur = (f + prev) & 0xFF
        elif ft == 1:
            # running sum along each of the bpp byte lanes
            cur = np.empty(stride, np.int32)
            for k in range(bpp):
                cur[k::bpp] = np.cumsum(f[k::bpp]) & 0xFF
        elif ft in (3, 4):
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(prev[x - bpp]) if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (int(f[x]) + pred) & 0xFF
        else:
            raise ValueError(f"PNG: unknown scanline filter type {ft}")
        out[y] = cur
        prev = cur
    return out


def read_png(path) -> np.ndarray:
    """Decode a PNG into (H, W) or (H, W, C) uint8 / uint16 samples.

    Raises :class:`UnsupportedPNG` for palette, interlaced or sub-byte
    images."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if color not in _PNG_CHANNELS or depth not in (8, 16) or interlace:
        raise UnsupportedPNG(
            f"{path}: color type {color}, bit depth {depth}, interlace "
            f"{interlace}"
        )
    channels = _PNG_CHANNELS[color]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    pixels = _unfilter(raw, height, stride, bpp)
    dtype = np.dtype(">u2") if depth == 16 else np.dtype(np.uint8)
    arr = pixels.view(dtype).reshape(height, width, channels)
    arr = arr.astype(np.uint16) if depth == 16 else arr
    return arr[..., 0] if channels == 1 else arr


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def write_png(path, arr: np.ndarray, level: int = 6) -> None:
    """Encode (H, W) or (H, W, C) uint8 / uint16 samples, C in 1..4, as a
    PNG. Rows use the "Up" filter (vectorized, and kind to smooth
    heightmaps)."""
    arr = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"write_png needs uint8 or uint16, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    height, width, channels = arr.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    depth = 8 * arr.dtype.itemsize
    rows = np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder(">")))
    rows = rows.view(np.uint8).reshape(height, -1)
    up = rows.copy()
    up[1:] -= rows[:-1]  # uint8 wraparound == filter "Up" mod 256
    lines = np.concatenate([np.full((height, 1), 2, np.uint8), up], axis=1)
    png = (
        _PNG_SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth,
                                      color, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(lines.tobytes(), level))
        + _chunk(b"IEND", b"")
    )
    Path(path).write_bytes(png)


def _read_with_pil(path) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(
            f"reading {path} needs Pillow (PIL); this installation has none. "
            "Convert the source to PNG (8/16-bit gray or RGB(A)) or .npy, "
            "which load without it."
        ) from exc
    Image.MAX_IMAGE_PIXELS = None  # reader.no_limits() (tiff.rs via tile_atlas.rs:130)
    return np.asarray(Image.open(path))


def read_image(path) -> np.ndarray:
    """Raw samples of a source image: PNG and .npy natively, else PIL."""
    suffix = Path(path).suffix.lower()
    if suffix == ".npy":
        return np.load(path)
    if suffix == ".png":
        try:
            return read_png(path)
        except UnsupportedPNG:
            pass
    return _read_with_pil(path)


def load_source_image(path: str, attachment_config) -> np.ndarray:
    arr = read_image(path)
    if arr.ndim == 2:
        arr = arr[..., None]
    channels = attachment_config.format.channels
    if arr.shape[-1] < channels:
        arr = np.repeat(arr[..., :1], channels, axis=-1)
    arr = arr[..., :channels]

    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    if arr.dtype == np.uint16:
        return arr.astype(np.float32) / 65535.0
    if arr.dtype in (np.float32, np.float64):
        return arr.astype(np.float32)
    if arr.dtype == np.int16:
        return np.clip(arr.astype(np.float32) / 32767.0, 0.0, 1.0)
    return arr.astype(np.float32) / float(np.iinfo(arr.dtype).max)


def array_to_source(arr: np.ndarray, path: str) -> None:
    """Write a float [0,1] array as a 16-bit PNG source image (grayscale
    for 2-D input or one channel; gray+alpha/RGB/RGBA for 2-4 channels)
    for tests / synthetic datasets."""
    data = np.clip(np.rint(np.asarray(arr) * 65535.0), 0, 65535).astype(np.uint16)
    if data.ndim == 3 and data.shape[-1] == 1:
        data = data[..., 0]
    write_png(path, data)
