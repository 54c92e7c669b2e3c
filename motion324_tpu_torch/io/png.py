"""PNG encoder and decoder in numpy, zlib and struct (no PIL).

The GLB writer stores a texture atlas as PNG through :func:`encode_png`, and
the GLB reader decodes it with :func:`decode_png`, so that a textured mesh
can be written and read where PIL is not installed. The JAX package leaves
this to PIL; this module adds no feature of its own.

:func:`encode_png` writes 8-bit greyscale, RGB or RGBA, non-interlaced, one
IDAT chunk. Each row takes the filter (None, Sub or Up) whose output has
the least sum of absolute values, the heuristic of the PNG specification
(section 12.8). :func:`decode_png` reads 8-bit greyscale, greyscale with
alpha, RGB and RGBA, non-interlaced, with filter types 0-4, and raises on
anything else (palette, 16-bit or fewer bits, Adam7 interlacing).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["encode_png", "decode_png", "ZLIB_LEVEL"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
# zlib level of encode_png: PERF.md gives the seconds and bytes of a 2 048^2
# atlas at each level on the card's host (chip_smoke.py png_encode_times)
ZLIB_LEVEL = 6


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(image: np.ndarray, level: int = ZLIB_LEVEL) -> bytes:
    """``uint8 (H, W)``, ``(H, W, 1|2|3|4)`` -> the bytes of a PNG file."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE or 0 in img.shape:
        raise ValueError(f"encode_png takes (H, W, 1|2|3|4), got {img.shape}")
    h, w, c = img.shape
    rows = img.reshape(h, w * c)
    wide = rows.astype(np.int16)
    # the candidate filters of every row, as bytes mod 256
    sub = rows.copy()
    sub[:, c:] = (wide[:, c:] - wide[:, :-c]).astype(np.uint8)
    up = rows.copy()
    up[1:] = (wide[1:] - wide[:-1]).astype(np.uint8)
    cands = np.stack([rows, sub, up])                  # (3, H, W*C)
    cost = np.stack([np.abs(f.view(np.int8).astype(np.int16)).sum(axis=1)
                     for f in cands])                  # (3, H)
    pick = cost.argmin(axis=0)
    out = np.empty((h, 1 + w * c), np.uint8)
    out[:, 0] = pick                                   # filter types 0, 1, 2
    out[:, 1:] = cands[pick, np.arange(h)]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(out.tobytes(), level))
            + _chunk(b"IEND", b""))


def _unfilter_rows(filt: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """Rows of filter types 0, 1 and 2 only: each row in one vector step."""
    h, n = filt.shape
    out = np.empty_like(filt)
    prev = np.zeros(n, np.uint8)
    for r in range(h):
        row = filt[r]
        if types[r] == 1:
            row = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif types[r] == 2:
            row = row + prev
        out[r] = row
        prev = out[r]
    return out


def _unfilter_wavefront(filt: np.ndarray, types: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Any filter types: a pixel depends on its left, upper and upper-left
    neighbours, so the pixels of one anti-diagonal (row + column constant)
    are reconstructed together, in H + W - 1 vector steps."""
    h, n = filt.shape
    w = n // bpp
    f = filt.reshape(h, w, bpp).astype(np.int32)
    x = np.zeros((h + 1, w + 1, bpp), np.int32)     # a zero row and column
    t = types.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        col = d - r
        a = x[r + 1, col]                           # left
        b = x[r, col + 1]                           # up
        c = x[r, col]                               # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        kind = t[r][:, None]
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        x[r + 1, col + 1] = (f[r, col] + pred) & 255
    return x[1:, 1:].reshape(h, n).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """The bytes of a PNG file -> ``uint8 (H, W, C)``, C the file's
    channels (1 grey, 2 grey + alpha, 3 RGB, 4 RGBA)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, comp, filt_method, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"PNG colour type {color} is not supported (3 is a "
                         f"palette)")
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} is not supported (8 only)")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    if comp or filt_method:
        raise ValueError(f"PNG compression/filter method {comp}/{filt_method}")
    bpp = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{h * (1 + w * bpp)}")
    raw = raw.reshape(h, 1 + w * bpp)
    types, filt = raw[:, 0], raw[:, 1:]
    if types.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {types.max()} is not one of 0-4")
    if types.max(initial=0) <= 2:
        pixels = _unfilter_rows(filt, types, bpp)
    else:
        pixels = _unfilter_wavefront(filt, types, bpp)
    return pixels.reshape(h, w, bpp)
