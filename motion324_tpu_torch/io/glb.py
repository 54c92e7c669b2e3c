"""GLB (binary glTF 2.0) reader and writer, dependency-free (numpy + zlib).

Replaces two reference components with one host library:
- mesh loading (the reference uses trimesh/pygltflib —
  scripts/hy3dgen/texgen/custom_rasterizer/custom_rasterizer/io_glb.py:134 and
  scripts/inference_with_video_mesh.py:78-88);
- animated-mesh export (the reference drives Blender shape keys with CONSTANT
  interpolation and exports merged-mesh morph targets — utils/render.py:117-345).
  Here the same artefact — one mesh with T morph targets and a STEP-interpolated
  weights animation — is written directly as glTF, no Blender process needed.

A texture is always written as PNG by :func:`motion324_tpu_torch.io.png.
encode_png`, and a PNG texture (known by its signature) is read by its
``decode_png``; PIL is imported only to read a texture of another type
(JPEG). So a textured GLB is written
and read where PIL is absent. The files differ from the JAX package's only
in the image bytes: ``motion324_tpu/io/glb.py`` writes JPEG (quality 95) for
atlases of 1 MPix and more, and PNG through PIL below that.
"""

from __future__ import annotations

import io as _io
import json
import struct
from typing import Any

import numpy as np

from motion324_tpu_torch.io.png import decode_png, encode_png
from motion324_tpu_torch.utils.profiling import span

__all__ = ["load_glb", "export_glb", "export_animated_glb", "load_animated_glb"]

_MAGIC = 0x46546C67
_JSON_CHUNK = 0x4E4F534A
_BIN_CHUNK = 0x004E4942

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}


# --------------------------------------------------------------------------- #
# Reading
# --------------------------------------------------------------------------- #
def _read_chunks(data: bytes):
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != _MAGIC:
        raise ValueError("not a GLB file (bad magic)")
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    offset, gltf, binary = 12, None, b""
    while offset < len(data):
        clen, ctype = struct.unpack_from("<II", data, offset)
        chunk = data[offset + 8: offset + 8 + clen]
        if ctype == _JSON_CHUNK:
            gltf = json.loads(chunk.decode("utf-8"))
        elif ctype == _BIN_CHUNK:
            binary = chunk
        offset += 8 + clen  # chunkLength includes the 4-byte padding per spec
    if gltf is None:
        raise ValueError("GLB missing JSON chunk")
    return gltf, binary


def _accessor_data(gltf: dict, binary: bytes, idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    itemsize = np.dtype(dtype).itemsize * ncomp
    stride = view.get("byteStride", itemsize)
    if stride == itemsize:
        arr = np.frombuffer(binary, dtype=dtype, count=count * ncomp,
                            offset=start).reshape(count, ncomp)
    else:
        raw = np.frombuffer(binary, dtype=np.uint8,
                            count=stride * (count - 1) + itemsize, offset=start)
        rows = np.lib.stride_tricks.as_strided(
            raw, shape=(count, itemsize), strides=(stride, 1))
        arr = rows.view(dtype).reshape(count, ncomp)
    if acc.get("normalized") and dtype != np.float32:
        arr = arr.astype(np.float32) / np.iinfo(dtype).max
    return np.ascontiguousarray(arr)


def _node_transform(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    t = node.get("translation", [0, 0, 0])
    q = node.get("rotation", [0, 0, 0, 1])  # xyzw
    s = node.get("scale", [1, 1, 1])
    x, y, z, w = q
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float32)
    m[:3, :3] = rot * np.asarray(s, np.float32)
    m[:3, 3] = t
    return m


def _decode_image(gltf: dict, binary: bytes, image_idx: int):
    img = gltf["images"][image_idx]
    if "bufferView" in img:
        view = gltf["bufferViews"][img["bufferView"]]
        start = view.get("byteOffset", 0)
        raw = binary[start:start + view["byteLength"]]
    elif "uri" in img and img["uri"].startswith("data:"):
        import base64
        raw = base64.b64decode(img["uri"].split(",", 1)[1])
    else:
        return None
    if raw[:8] == b"\x89PNG\r\n\x1a\n":
        arr = decode_png(raw)
        if arr.shape[2] < 3:           # grey (+ alpha): grey to RGB
            arr = np.repeat(arr[..., :1], 3, axis=2)
    else:
        from PIL import Image
        pil = Image.open(_io.BytesIO(raw))
        if pil.mode not in ("RGB", "RGBA"):
            pil = pil.convert("RGB")
        arr = np.asarray(pil)
    return arr[..., :3].astype(np.float32) / 255.0


def load_glb(path: str):
    """Load a GLB into merged-mesh arrays (world-space, all primitives).

    Returns a dict: ``vertices (V,3) f32``, ``faces (F,3) i64``, and optionally
    ``uv (V,2)``, ``vertex_colors (V,3)``, ``normals (V,3)``, ``texture (H,W,3)``
    (first baseColorTexture found).
    """
    with open(path, "rb") as f:
        gltf, binary = _read_chunks(f.read())

    # world transforms via scene graph
    world: dict[int, np.ndarray] = {}

    def visit(node_idx: int, parent: np.ndarray):
        node = gltf["nodes"][node_idx]
        m = parent @ _node_transform(node)
        world[node_idx] = m
        for ch in node.get("children", []):
            visit(ch, m)

    scene = gltf.get("scenes", [{}])[gltf.get("scene", 0)]
    for root in scene.get("nodes", range(len(gltf.get("nodes", [])))):
        visit(root, np.eye(4, dtype=np.float32))

    verts, faces, uvs, cols, norms = [], [], [], [], []
    texture = None
    voffset = 0
    for node_idx, m in world.items():
        node = gltf["nodes"][node_idx]
        if "mesh" not in node:
            continue
        mesh = gltf["meshes"][node["mesh"]]
        for prim in mesh.get("primitives", []):
            mode = prim.get("mode", 4)
            if mode not in (4, 5, 6):  # TRIANGLES / STRIP / FAN
                continue
            attrs = prim["attributes"]
            pos = _accessor_data(gltf, binary, attrs["POSITION"]).astype(np.float32)
            pos_w = pos @ m[:3, :3].T + m[:3, 3]
            n = len(pos_w)
            if "indices" in prim:
                idx = _accessor_data(gltf, binary, prim["indices"]).reshape(-1)
            else:
                idx = np.arange(n, dtype=np.uint32)
            idx = idx.astype(np.int64)
            # strip/fan conversion mirrors the reference's loader
            # (reference: .../custom_rasterizer/custom_rasterizer/io_glb.py:
            # 134-230 handles non-TRIANGLES modes)
            if mode == 5:  # TRIANGLE_STRIP: flip winding on odd triangles
                a, b, c = idx[:-2], idx[1:-1], idx[2:]
                odd = np.arange(len(a)) % 2 == 1
                tri = np.stack([np.where(odd, b, a),
                                np.where(odd, a, b), c], axis=1)
            elif mode == 6:  # TRIANGLE_FAN: all triangles share vertex 0
                tri = np.stack([np.broadcast_to(idx[0], idx[2:].shape),
                                idx[1:-1], idx[2:]], axis=1)
            else:
                tri = idx[:len(idx) - len(idx) % 3].reshape(-1, 3)
            # drop degenerate triangles (strips commonly restart by
            # repeating an index)
            keep = ((tri[:, 0] != tri[:, 1]) & (tri[:, 1] != tri[:, 2])
                    & (tri[:, 0] != tri[:, 2]))
            tri = tri[keep] + voffset
            verts.append(pos_w)
            faces.append(tri)
            uvs.append(_accessor_data(gltf, binary, attrs["TEXCOORD_0"])[:, :2]
                       .astype(np.float32) if "TEXCOORD_0" in attrs
                       else np.zeros((n, 2), np.float32))
            if "COLOR_0" in attrs:
                c = _accessor_data(gltf, binary, attrs["COLOR_0"])
                if c.dtype != np.float32:
                    c = c.astype(np.float32) / np.iinfo(c.dtype).max
                cols.append(c[:, :3].astype(np.float32))
            else:
                cols.append(np.full((n, 3), np.nan, np.float32))
            if "NORMAL" in attrs:
                nm = _accessor_data(gltf, binary, attrs["NORMAL"]).astype(np.float32)
                inv = np.linalg.inv(m[:3, :3]).T
                norms.append(nm @ inv.T)
            else:
                norms.append(np.full((n, 3), np.nan, np.float32))
            if texture is None and "material" in prim:
                mat = gltf.get("materials", [])[prim["material"]]
                tex_info = mat.get("pbrMetallicRoughness", {}).get(
                    "baseColorTexture")
                if tex_info is not None:
                    src = gltf["textures"][tex_info["index"]].get("source")
                    if src is not None:
                        texture = _decode_image(gltf, binary, src)
            voffset += n

    if not verts:
        raise ValueError(f"no triangle meshes in {path}")
    out = {
        "vertices": np.concatenate(verts, axis=0),
        "faces": np.concatenate(faces, axis=0),
        "uv": np.concatenate(uvs, axis=0),
    }
    colors = np.concatenate(cols, axis=0)
    if not np.isnan(colors).all():
        out["vertex_colors"] = np.nan_to_num(colors, nan=0.5)
    normals = np.concatenate(norms, axis=0)
    if not np.isnan(normals).all():
        out["normals"] = np.nan_to_num(normals, nan=0.0)
    if texture is not None:
        out["texture"] = texture
    return out


def load_animated_glb(path: str):
    """Reconstruct per-frame vertices from a morph-target weights animation.

    Replaces the reference's Blender depsgraph frame extraction
    (reference: evaluation/evaluation_pcd.py:19-170). Returns
    ``(base_vertices (V,3), faces (F,3), frames (T,V,3), times (T,))`` for the
    first animated mesh node; each frame applies that keyframe's morph weights.
    """
    with open(path, "rb") as f:
        gltf, binary = _read_chunks(f.read())
    anims = gltf.get("animations", [])
    if not anims:
        raise ValueError(f"{path} has no animations")
    anim = anims[0]
    channel = next(c for c in anim["channels"]
                   if c["target"].get("path") == "weights")
    sampler = anim["samplers"][channel["sampler"]]
    times = _accessor_data(gltf, binary, sampler["input"]).reshape(-1)
    weights_flat = _accessor_data(gltf, binary, sampler["output"]).reshape(-1)

    node = gltf["nodes"][channel["target"]["node"]]
    mesh = gltf["meshes"][node["mesh"]]
    prim = mesh["primitives"][0]
    base = _accessor_data(gltf, binary, prim["attributes"]["POSITION"]).astype(np.float32)
    faces = _accessor_data(gltf, binary, prim["indices"]).reshape(-1, 3).astype(np.int64) \
        if "indices" in prim else np.arange(len(base)).reshape(-1, 3)
    targets = prim.get("targets", [])
    n_targets = len(targets)
    disps = np.stack([
        _accessor_data(gltf, binary, t["POSITION"]).astype(np.float32)
        for t in targets]) if n_targets else np.zeros((0, *base.shape), np.float32)

    weights = weights_flat.reshape(len(times), n_targets) if n_targets else \
        np.zeros((len(times), 0), np.float32)
    frames = base[None] + np.einsum("tk,kvd->tvd", weights, disps) \
        if n_targets else np.broadcast_to(base[None], (len(times), *base.shape))
    return base, faces, frames.astype(np.float32), times


# --------------------------------------------------------------------------- #
# Writing
# --------------------------------------------------------------------------- #
def _pad4(b: bytes, fill: bytes = b"\x00") -> bytes:
    return b + fill * (-len(b) % 4)


class _BinBuilder:
    """The binary chunk as a list of parts (bytes, or contiguous arrays
    written as they lie in memory), each 4-byte aligned, with their
    bufferViews and accessors."""

    def __init__(self):
        self.parts: list = []
        self.views: list[dict] = []
        self.accessors: list[dict] = []
        self.offset = 0

    def _view(self, offset: int, length: int, target: int | None) -> int:
        view = {"buffer": 0, "byteOffset": offset, "byteLength": length}
        if target is not None:
            view["target"] = target
        self.views.append(view)
        return len(self.views) - 1

    def add(self, arr: np.ndarray, gltf_type: str, component: int,
            target: int | None = None, minmax: bool = False) -> int:
        raw = _pad4(np.ascontiguousarray(arr).tobytes())
        view = self._view(self.offset, len(raw), target)
        self.parts.append(raw)
        self.offset += len(raw)
        acc: dict[str, Any] = {
            "bufferView": view,
            "componentType": component,
            "count": int(arr.shape[0]) if arr.ndim > 1 else int(arr.size),
            "type": gltf_type,
        }
        if minmax:
            a2 = arr.reshape(acc["count"], -1)
            acc["min"] = [float(x) for x in a2.min(axis=0)]
            acc["max"] = [float(x) for x in a2.max(axis=0)]
        self.accessors.append(acc)
        return len(self.accessors) - 1

    def add_vec3_rows(self, block: np.ndarray, target: int) -> list[int]:
        """One f32 VEC3 accessor (with its min and max) per row of a
        contiguous ``(T, N, 3)`` block, written as one part: row t's view
        starts ``t * N * 12`` bytes into it (4-aligned, so unpadded).
        Returns the T accessor indices."""
        rows, count = block.shape[0], block.shape[1]
        row_bytes = count * 12
        lo, hi = _row_extremes(block)
        out = []
        for t in range(rows):
            view = self._view(self.offset + t * row_bytes, row_bytes, target)
            self.accessors.append({
                "bufferView": view, "componentType": 5126, "count": count,
                "type": "VEC3", "min": [float(x) for x in lo[t]],
                "max": [float(x) for x in hi[t]]})
            out.append(len(self.accessors) - 1)
        self.parts.append(block)
        self.offset += rows * row_bytes
        return out

    def add_raw(self, raw: bytes) -> dict:
        raw_p = _pad4(raw)
        view = self.views[self._view(self.offset, len(raw), None)]
        self.parts.append(raw_p)
        self.offset += len(raw_p)
        return view


def _row_extremes(block: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each row's per-component min and max over N of a ``(T, N, 3)``
    block, ``(T, 3)`` each, as a row's own ``min(axis=0)`` / ``max(axis=0)``
    gives them, signed zeros included: those meet the values one after
    another, so a zero extreme takes the sign of the column's last zero.
    The reductions run over a component-major copy (contiguous, where the
    strided ones over the block are ten times slower)."""
    cols = np.ascontiguousarray(block.transpose(0, 2, 1))
    out = (cols.min(axis=2), cols.max(axis=2))
    for ext in out:
        for t, c in zip(*np.nonzero(ext == 0)):
            ext[t, c] = cols[t, c, np.flatnonzero(cols[t, c] == 0)[-1]]
    return out


def _write_glb(path: str, gltf: dict, parts: list) -> None:
    """Write the GLB from its JSON and the binary chunk's parts (each
    4-byte aligned), part by part."""
    gltf.setdefault("asset", {"version": "2.0", "generator": "motion324_tpu_torch"})
    json_bytes = _pad4(json.dumps(gltf, separators=(",", ":")).encode(), b" ")
    size = sum(memoryview(p).nbytes for p in parts)
    total = 12 + 8 + len(json_bytes) + 8 + size
    with open(path, "wb") as f:
        f.write(struct.pack("<III", _MAGIC, 2, total))
        f.write(struct.pack("<II", len(json_bytes), _JSON_CHUNK))
        f.write(json_bytes)
        f.write(struct.pack("<II", size, _BIN_CHUNK))
        for p in parts:
            f.write(p)


_TEX_ENCODE_CACHE: dict = {}


def _encode_texture(texture) -> tuple[bytes, str]:
    """PNG-encode a texture atlas (:func:`encode_png`), memoised on content.

    Repeated exports of the same atlas (the generated mesh and its
    animation, every clip of a batch) hit a small content-keyed cache: the
    key combines a strided pixel subsample with a full-array checksum, so
    any pixel change re-encodes.
    """
    t = np.asarray(texture)
    key = (t.shape, str(t.dtype), t[::109, ::113].tobytes(),
           float(t.sum(dtype=np.float64)))
    hit = _TEX_ENCODE_CACHE.get(key)
    if hit is not None:
        return hit
    pixels = (t if t.dtype == np.uint8
              else (np.clip(t, 0, 1) * 255).astype(np.uint8))
    if len(_TEX_ENCODE_CACHE) >= 4:
        _TEX_ENCODE_CACHE.pop(next(iter(_TEX_ENCODE_CACHE)))
    _TEX_ENCODE_CACHE[key] = (encode_png(pixels), "image/png")
    return _TEX_ENCODE_CACHE[key]


def _base_mesh_json(b: _BinBuilder, vertices, faces, uv=None, texture=None,
                    vertex_colors=None):
    pos_acc = b.add(vertices.astype(np.float32), "VEC3", 5126, target=34962,
                    minmax=True)
    idx_acc = b.add(faces.astype(np.uint32).reshape(-1), "SCALAR", 5125,
                    target=34963)
    attributes = {"POSITION": pos_acc}
    gltf: dict[str, Any] = {}
    prim: dict[str, Any] = {"attributes": attributes, "indices": idx_acc,
                            "mode": 4}
    if uv is not None:
        attributes["TEXCOORD_0"] = b.add(uv.astype(np.float32), "VEC2", 5126,
                                         target=34962)
    if vertex_colors is not None:
        attributes["COLOR_0"] = b.add(vertex_colors.astype(np.float32), "VEC3",
                                      5126, target=34962)
    if texture is not None and uv is not None:
        raw_tex, mime = _encode_texture(texture)
        b.add_raw(raw_tex)
        gltf["images"] = [{"bufferView": len(b.views) - 1,
                           "mimeType": mime}]
        gltf["samplers"] = [{"magFilter": 9729, "minFilter": 9729,
                             "wrapS": 10497, "wrapT": 10497}]
        gltf["textures"] = [{"sampler": 0, "source": 0}]
        gltf["materials"] = [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "metallicFactor": 0.0, "roughnessFactor": 1.0}}]
        prim["material"] = 0
    return gltf, prim


def export_glb(path: str, vertices, faces, uv=None, texture=None,
               vertex_colors=None) -> None:
    """Write a static mesh (optionally with UVs and a texture) as GLB."""
    b = _BinBuilder()
    gltf, prim = _base_mesh_json(b, np.asarray(vertices, np.float32),
                                 np.asarray(faces), uv, texture, vertex_colors)
    gltf.update({
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "name": "mesh"}],
        "meshes": [{"primitives": [prim]}],
        "buffers": [{"byteLength": b.offset}],
        "bufferViews": b.views,
        "accessors": b.accessors,
    })
    _write_glb(path, gltf, b.parts)


def export_animated_glb(path: str, vertices, faces, trajectories, fps: int = 12,
                        uv=None, texture=None, vertex_colors=None) -> None:
    """Write an animated GLB: T morph targets + STEP-interpolated weights.

    ``trajectories``: (T, N, 3) absolute per-frame vertex positions. Frame t's
    morph target stores ``trajectories[t] - vertices``; the T targets are one
    contiguous block of the binary chunk, each target's bufferView an offset
    into it (the file is the one a writer of T separate targets writes). The
    weights animation switches exactly one target on per frame with STEP
    interpolation —
    the same artefact the reference produces via Blender CONSTANT-keyframe
    shape keys (reference utils/render.py:117-200, 222-345).
    """
    trajectories = np.asarray(trajectories, np.float32)
    t_frames = trajectories.shape[0]
    b = _BinBuilder()
    # the base mesh's accessors and the texture (encoded, or a cache hit)
    with span("export.glb.texture"):
        gltf, prim = _base_mesh_json(b, vertices, faces, uv, texture,
                                     vertex_colors)

    with span("export.glb.targets"):
        disp = np.ascontiguousarray(
            trajectories - np.asarray(vertices, np.float32))
        prim["targets"] = [{"POSITION": acc}
                           for acc in b.add_vec3_rows(disp, target=34962)]

        times = (np.arange(t_frames, dtype=np.float32) / float(fps))
        time_acc = b.add(times, "SCALAR", 5126, minmax=True)
        weights = np.zeros((t_frames, t_frames), np.float32)
        np.fill_diagonal(weights, 1.0)
        weights_acc = b.add(weights.reshape(-1), "SCALAR", 5126)

    gltf.update({
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "name": "animated_mesh"}],
        "meshes": [{"primitives": [prim], "weights": [0.0] * t_frames}],
        "animations": [{
            "samplers": [{"input": time_acc, "output": weights_acc,
                          "interpolation": "STEP"}],
            "channels": [{"sampler": 0,
                          "target": {"node": 0, "path": "weights"}}],
        }],
        "buffers": [{"byteLength": b.offset}],
        "bufferViews": b.views,
        "accessors": b.accessors,
    })
    with span("export.glb.write"):
        _write_glb(path, gltf, b.parts)
