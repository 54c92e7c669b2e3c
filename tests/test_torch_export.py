"""The port's exporters against the JAX package's, on the CPU: the FBX and
Alembic writers write the same bytes on the same seeded inputs, the readers
read the same values, the hashes behind the Alembic writer agree with the
golden vectors and with the JAX package's, the PIL-free PNG codec agrees
with PIL pixel for pixel, and the converter CLI writes the bytes of
``scripts/convert_fbx.py``."""

import io
import random
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from fbx_oracle import scene
from motion324_tpu import native as jax_native
from motion324_tpu.io import abc as jax_abc
from motion324_tpu.io import fbx as jax_fbx
from motion324_tpu.io.glb import load_glb as jax_load_glb
from motion324_tpu.io.mesh import load_mesh as jax_load_mesh
from motion324_tpu_torch import native
from motion324_tpu_torch.io import abc, fbx
from motion324_tpu_torch.io.glb import (export_animated_glb, export_glb,
                                        load_glb)
from motion324_tpu_torch.io.mesh import load_mesh
from motion324_tpu_torch.io.png import decode_png, encode_png
from test_hashes import _MM_VECTORS, _digest_bytes

ROOT = Path(__file__).resolve().parent.parent


def _mesh(seed: int = 0, n: int = 40):
    """A seeded random mesh: n vertices, 2n faces, per-vertex UVs."""
    rng = np.random.RandomState(seed)
    verts = rng.randn(n, 3).astype(np.float32)
    faces = rng.randint(0, n, (2 * n, 3)).astype(np.int64)
    uv = rng.rand(n, 2).astype(np.float32)
    return verts, faces, uv


def _frames(verts, t: int, seed: int = 1):
    rng = np.random.RandomState(seed)
    frames = verts[None] + 0.1 * rng.randn(t, *verts.shape).astype(np.float32)
    frames[0] = verts          # a rest frame: an empty delta
    return frames


# --------------------------------------------------------------------------- #
# FBX
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("t", [0, 5], ids=["static", "animated"])
@pytest.mark.parametrize("with_uv", [False, True], ids=["no_uv", "uv"])
def test_fbx_bytes_and_readers_match_jax(tmp_path, t, with_uv):
    verts, faces, uv = _mesh()
    frames = _frames(verts, t) if t else None
    kw = dict(frames=frames, fps=12.0, uv=uv if with_uv else None, name="blob")
    got, want = str(tmp_path / "port.fbx"), str(tmp_path / "jax.fbx")
    fbx.export_animated_fbx(got, verts, faces, **kw)
    jax_fbx.export_animated_fbx(want, verts, faces, **kw)
    assert Path(got).read_bytes() == Path(want).read_bytes()

    doc = scene(got)          # the strict, writer-independent parser
    np.testing.assert_allclose(doc["vertices"], verts, atol=1e-6)
    assert len(doc["shapes"]) == t

    mine, ref = fbx.load_fbx(got), jax_fbx.load_fbx(want)
    np.testing.assert_array_equal(mine["vertices"], ref["vertices"])
    np.testing.assert_array_equal(mine["faces"], ref["faces"])
    np.testing.assert_array_equal(mine["faces"], faces)
    if with_uv:
        np.testing.assert_array_equal(mine["uv"], ref["uv"])
    else:
        assert mine["uv"] is None and ref["uv"] is None
    assert len(mine["shapes"]) == len(ref["shapes"]) == t
    for (n1, i1, d1), (n2, i2, d2) in zip(mine["shapes"], ref["shapes"]):
        assert n1 == n2
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(d1, d2)

    m, r = load_mesh(got), jax_load_mesh(want)
    np.testing.assert_array_equal(m.vertices, r.vertices)
    np.testing.assert_array_equal(m.faces, r.faces)
    assert (m.uv is None) == (r.uv is None) == (not with_uv)
    if with_uv:
        np.testing.assert_array_equal(m.uv, r.uv)


def test_triangulate_fans_polygons_as_jax():
    pvi = np.array([0, 1, -3, 2, 3, 4, -6, 5, 6, 7, 8, -10], np.int64)
    np.testing.assert_array_equal(fbx._triangulate(pvi),
                                  jax_fbx._triangulate(pvi))


# --------------------------------------------------------------------------- #
# Alembic and its hashes
# --------------------------------------------------------------------------- #
def _same_tree(a, b, where="root"):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("t", [0, 5], ids=["static", "animated"])
def test_abc_bytes_and_reader_match_jax(tmp_path, t):
    verts, faces, _ = _mesh(2)
    frames = _frames(verts, t) if t else None
    got, want = str(tmp_path / "port.abc"), str(tmp_path / "jax.abc")
    abc.export_animated_abc(got, verts, faces, frames, fps=24.0, name="blob")
    jax_abc.export_animated_abc(want, verts, faces, frames, fps=24.0,
                                name="blob")
    assert Path(got).read_bytes() == Path(want).read_bytes()
    mine = abc.read_abc(got)
    _same_tree(mine, jax_abc.read_abc(want))
    p = mine["objects"]["blob"]["props"][".geom"]["children"]["P"]
    assert p["nsamples"] == max(t, 1)
    for i in range(t):
        np.testing.assert_array_equal(p["samples"][i].reshape(-1, 3), frames[i])


@pytest.mark.parametrize("impl", ["cpp", "numpy"])
def test_murmur3_golden_vectors(impl):
    fn = {"cpp": native.murmur3_x64_128,
          "numpy": native.murmur3_x64_128_numpy}[impl]
    for msg, seed, hexd in _MM_VECTORS:
        assert fn(msg, seed) == _digest_bytes(hexd), (msg[:24], seed)


@pytest.mark.parametrize("algo", ["murmur3", "spooky"])
def test_hashes_cpp_numpy_and_jax_agree_at_lengths_0_to_300(algo):
    """Every length from 0 to 300 covers each tail and remainder case and
    the 96-byte block path of SpookyHash."""
    rng = random.Random(0)
    if algo == "murmur3":
        fns = (native.murmur3_x64_128, native.murmur3_x64_128_numpy,
               jax_native.murmur3_x64_128)
        seeds = [(0,), (4,), (1234567,)]
    else:
        fns = (native.spooky_hash128, native.spooky_hash128_numpy,
               jax_native.spooky_hash128)
        seeds = [(0, 0), (1, 2), (0xDEADBEEF, 42)]
    for n in range(301):
        data = bytes(rng.randrange(256) for _ in range(n))
        for s in seeds:
            got = [fn(data, *s) for fn in fns]
            assert len(got[0]) == 16 and got[0] == got[1] == got[2], (n, s)


# --------------------------------------------------------------------------- #
# PNG
# --------------------------------------------------------------------------- #
SIZES = [(1, 1), (7, 13), (256, 256)]


def _image(h, w, c, seed=3):
    """Half noise, half smooth ramps, so that every filter wins some rows."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    smooth = np.stack([(3 * xx + 2 * yy + 40 * k) % 256 for k in range(c)], -1)
    noise = rng.randint(0, 256, (h, w, c))
    return np.where((yy < h // 2)[..., None], smooth, noise).astype(np.uint8)


@pytest.mark.parametrize("c", [3, 4], ids=["rgb", "rgba"])
@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_png_decodes_with_pil_exactly(hw, c):
    img = _image(*hw, c)
    data = encode_png(img)
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == ("RGB" if c == 3 else "RGBA")
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(decode_png(data), img)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_png_of_pil_pngs_equals_pil(hw, mode):
    img = _image(*hw, {"L": 1, "RGB": 3, "RGBA": 4}[mode])
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if mode == "L" else img, mode).save(buf, "PNG")
    with Image.open(io.BytesIO(buf.getvalue())) as im:
        want = np.asarray(im)
    got = decode_png(buf.getvalue())
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def _filter_row(row, prev, kind, bpp):
    """The PNG specification's filters, one byte at a time."""
    out = []
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if kind == 4:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        else:
            pred = [0, a, b, (a + b) // 2][kind]
        out.append((x - pred) % 256)
    return out


def _png(img, types, color=2, depth=8, interlace=0):
    h, w, c = img.shape
    prev, raw = [0] * (w * c), b""
    for r in range(h):
        row = [int(v) for v in img[r].reshape(-1)]
        raw += bytes([types[r]] + _filter_row(row, prev, types[r], c))
        prev = row
    chunk = lambda k, d: (struct.pack(">I", len(d)) + k + d
                          + struct.pack(">I", zlib.crc32(k + d)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                         interlace))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("types", [[0, 1, 2, 3, 4, 4, 3, 2, 1, 0, 4],
                                   [4] * 11, [3] * 11, [1, 2] * 5 + [1]],
                         ids=["mixed", "paeth", "average", "sub_up"])
def test_decode_png_reads_every_filter_type_as_pil(types):
    img = _image(11, 9, 3, seed=5)
    data = _png(img, types)
    with Image.open(io.BytesIO(data)) as im:
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(decode_png(data), img)


def test_decode_png_refuses_what_it_does_not_read():
    img = _image(4, 5, 3)
    pal = io.BytesIO()
    Image.fromarray(img).convert("P").save(pal, "PNG")
    deep = io.BytesIO()
    Image.fromarray(img[..., 0].astype(np.uint16) * 257).save(deep, "PNG")
    for data, match in ((pal.getvalue(), "colour type 3"),
                        (deep.getvalue(), "bit depth 16"),
                        (_png(img, [0] * 4, interlace=1), "Adam7"),
                        (b"GIF89a" + bytes(20), "signature")):
        with pytest.raises(ValueError, match=match):
            decode_png(data)
    with pytest.raises(ValueError, match="uint8"):
        encode_png(img.astype(np.float32))


@pytest.mark.parametrize("animated", [False, True], ids=["static", "animated"])
def test_textured_glb_round_trip_gives_the_texture_back(tmp_path, animated):
    """A uint8 atlas through the port's GLB writer comes back exactly from
    the port's reader (decode_png) and from the JAX package's (PIL)."""
    verts, faces, uv = _mesh(4)
    tex = _image(64, 48, 3, seed=6)
    path = str(tmp_path / "tex.glb")
    if animated:
        export_animated_glb(path, verts, faces, _frames(verts, 3), uv=uv,
                            texture=tex)
    else:
        export_glb(path, verts, faces, uv=uv, texture=tex)
    for got in (load_glb(path), jax_load_glb(path)):
        np.testing.assert_array_equal(np.rint(got["texture"] * 255), tex)
        np.testing.assert_array_equal(got["uv"], uv)
    # a float atlas is written as the JAX writer writes it
    export_glb(path, verts, faces, uv=uv, texture=tex / 255.0)
    back = np.rint(load_glb(path)["texture"] * 255)
    assert np.abs(back - tex).max() <= 1


# --------------------------------------------------------------------------- #
# the converter CLI
# --------------------------------------------------------------------------- #
@pytest.fixture
def jax_convert():
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import convert_fbx
        yield convert_fbx
    finally:
        sys.path.remove(str(ROOT / "scripts"))


@pytest.mark.parametrize("source", ["animated_glb", "static_glb", "obj"])
@pytest.mark.parametrize("ext", [".fbx", ".abc"])
def test_convert_cli_writes_the_bytes_of_the_jax_script(tmp_path, jax_convert,
                                                        source, ext):
    from motion324_tpu_torch import convert
    verts, faces, uv = _mesh(5)
    src = tmp_path / {"obj": "in.obj"}.get(source, "in.glb")
    if source == "animated_glb":
        export_animated_glb(str(src), verts, faces, _frames(verts, 4), fps=10,
                            uv=uv)
    elif source == "static_glb":
        export_glb(str(src), verts, faces, uv=uv)
    else:
        src.write_text("".join(f"v {x} {y} {z}\n" for x, y, z in verts)
                       + "".join(f"f {a + 1} {b + 1} {c + 1}\n"
                                 for a, b, c in faces))
    got, want = tmp_path / f"port{ext}", tmp_path / f"jax{ext}"
    assert convert.main([str(src), "-o", str(got)]) == 0
    jax_convert.main([str(src), "-o", str(want)])
    assert got.read_bytes() == want.read_bytes()
