"""Seeded inputs: the clip, the textured mesh and its GLB file, the
conditioning images. Copies of the smoke run's generators (``textured_clip``,
``deformed_sphere``, ``synthetic_image``) with numpy's ``default_rng`` in
place of ``RandomState``, so that any whole seed works, and with UVs and a
texture added to the sphere. Plus a small PNG encoder and GLB writer, so
that the files the system reads are made here and not by the system."""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    return np.random.default_rng([abs(int(seed)), stream])


def textured_clip(seed: int, frames: int, size: int) -> np.ndarray:
    """A striped, lit disc circling over a dark, slightly noisy background,
    (frames, size, size, 3) uint8."""
    r = rng(seed, 1)
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    color = r.integers(120, 230, size=3).astype(np.float32)
    out = np.empty((frames, size, size, 3), np.uint8)
    for t in range(frames):
        ang = 2 * np.pi * t / frames
        cy = size / 2 + 0.1 * size * np.sin(ang)
        cx = size / 2 + 0.1 * size * np.cos(ang)
        d2 = ((yy - cy) ** 2 + (xx - cx) ** 2) / (0.2 * size) ** 2
        shade = (0.75 + 0.25 * np.sin((xx - cx) / 9.0 + ang)) * (1.1 - 0.4 * d2)
        frame = 20 + r.integers(0, 4, size=(size, size, 3)).astype(np.float32)
        disc = d2 < 1
        frame[disc] = (color * shade[..., None])[disc]
        out[t] = np.clip(frame, 0, 255)
    return out


def uv_sphere(faces: int, seed: int):
    """The paint benchmark's test mesh: a UV sphere of about ``faces``
    faces (2 (n - 1)^2 with n = floor(sqrt(faces / 2)) + 1), radially
    deformed by 1 + 0.15 sin(3x) and, per seed, a small random wobble;
    returns (vertices (V, 3) f32, faces (F, 3) i64, uv (V, 2) f32)."""
    n = max(8, int(np.sqrt(faces / 2)) + 1)
    r = rng(seed, 2)
    u, v = np.meshgrid(np.linspace(0, 2 * np.pi, n),
                       np.linspace(0.1, np.pi - 0.1, n))
    verts = np.stack([np.sin(v) * np.cos(u), np.sin(v) * np.sin(u),
                      np.cos(v)], -1).reshape(-1, 3).astype(np.float32)
    a, b = r.uniform(0.05, 0.15, size=2)
    verts *= (1 + a * np.sin(3 * verts[:, :1]) + b * np.cos(2 * verts[:, 2:]))
    q = (np.arange(n - 1)[:, None] * n + np.arange(n - 1)[None]).reshape(-1)
    tri = np.stack([np.stack([q, q + n, q + 1], 1),
                    np.stack([q + 1, q + n, q + n + 1], 1)], 1).reshape(-1, 3)
    uv = np.stack([u / (2 * np.pi), 1 - v / np.pi], -1).reshape(-1, 2)
    return verts.astype(np.float32), tri.astype(np.int64), uv.astype(np.float32)


def texture(seed: int, size: int) -> np.ndarray:
    """A painted-looking atlas: smooth colour bands and blobs with a little
    noise, (size, size, 3) uint8."""
    r = rng(seed, 3)
    yy, xx = np.mgrid[:size, :size].astype(np.float32) / size
    img = np.zeros((size, size, 3), np.float32)
    for c in range(3):
        fx, fy, ph = r.uniform(2, 12), r.uniform(2, 12), r.uniform(0, 6.3)
        img[..., c] = 0.5 + 0.35 * np.sin(fx * 6.283 * xx + ph) * np.cos(fy * 6.283 * yy)
    img += r.normal(0, 0.01, img.shape).astype(np.float32)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def synthetic_image(seed: int, size: int) -> np.ndarray:
    """A shaded ellipse over a white background with a little noise,
    (size, size, 3) float32 in [0, 1]."""
    r = rng(seed, 4)
    yy, xx = np.mgrid[:size, :size] / size - 0.5
    a, b = r.uniform(0.2, 0.35, size=2)
    inside = (xx / a) ** 2 + (yy / b) ** 2 < 1
    img = np.ones((size, size, 3), np.float32)
    shade = 0.5 + 0.5 * (xx - yy)[..., None]
    img[inside] = (r.uniform(0.2, 0.9, size=3) * shade)[inside]
    img += r.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


def encode_png(rgb: np.ndarray, level: int = 1) -> bytes:
    """An 8-bit RGB PNG, every row unfiltered."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb).reshape(h, w * 3)], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def write_textured_glb(path: str, vertices, faces, uv, rgb) -> int:
    """A GLB of one textured mesh (POSITION, TEXCOORD_0, uint32 indices, a
    PNG base colour texture); returns the bytes written."""
    parts, views, accessors = [], [], []

    def add(raw: bytes, accessor: dict | None = None):
        offset = sum(len(p) for p in parts)
        views.append({"buffer": 0, "byteOffset": offset, "byteLength": len(raw)})
        parts.append(raw + b"\0" * (-len(raw) % 4))
        if accessor is not None:
            accessors.append({"bufferView": len(views) - 1, **accessor})
    v = np.ascontiguousarray(vertices, np.float32)
    add(v.tobytes(), {"componentType": 5126, "count": len(v), "type": "VEC3",
                      "min": v.min(0).tolist(), "max": v.max(0).tolist()})
    add(np.ascontiguousarray(uv, np.float32).tobytes(),
        {"componentType": 5126, "count": len(uv), "type": "VEC2"})
    idx = np.ascontiguousarray(faces, np.uint32).reshape(-1)
    add(idx.tobytes(), {"componentType": 5125, "count": len(idx), "type": "SCALAR"})
    add(encode_png(rgb))
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                                    "indices": 2, "material": 0, "mode": 4}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}}],
        "textures": [{"source": 0}],
        "images": [{"bufferView": 3, "mimeType": "image/png"}],
        "buffers": [{"byteLength": sum(len(p) for p in parts)}],
        "bufferViews": views, "accessors": accessors,
    }
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    binary = b"".join(parts)
    data = (struct.pack("<III", 0x46546C67, 2, 28 + len(js) + len(binary))
            + struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(binary), 0x004E4942) + binary)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)
