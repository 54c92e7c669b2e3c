"""Binary FBX 7.4 writer/reader: static mesh + UVs + animated blend shapes.

The port's copy of ``motion324_tpu/io/fbx.py``; it writes the same bytes
(the writer holds no clock). Host numpy only: no device work.
Closes the reference's FBX product path without Blender: the video-only
pipeline exports its animation as FBX (reference: utils/render.py:117-200
``drive_mesh_with_trajs_frames`` via bpy, utils/convert_fbx.py:95-180), and
meshes enter the pipeline as FBX (inference_with_video_only.py:56-180). This
module emits the standard Kaydara binary format (version 7400): Geometry with
per-polygon-vertex UVs, per-frame morph-target Shape nodes wired through a
BlendShape deformer, and stepped AnimationCurves driving each channel's
DeformPercent 0->100->0 — the same shape-key-per-frame scheme the reference
builds in Blender. The reader parses the node tree back for round-trip tests
and FBX mesh import.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["export_animated_fbx", "load_fbx"]

_HEADER = b"Kaydara FBX Binary  \x00\x1a\x00"
_VERSION = 7400
_FBX_TICKS_PER_SEC = 46186158000  # KTime ticks


# --------------------------------------------------------------------------- #
# low-level node encoding
# --------------------------------------------------------------------------- #
class _Node:
    def __init__(self, name: str, *props):
        self.name = name
        self.props = list(props)
        self.children: list[_Node] = []

    def add(self, name, *props):
        n = _Node(name, *props)
        self.children.append(n)
        return n


def _enc_prop(p) -> bytes:
    if isinstance(p, bool):
        return b"C" + struct.pack("<?", p)
    if isinstance(p, int):
        return b"L" + struct.pack("<q", p)
    if isinstance(p, float):
        return b"D" + struct.pack("<d", p)
    if isinstance(p, str):
        b = p.encode()
        return b"S" + struct.pack("<I", len(b)) + b
    if isinstance(p, bytes):
        return b"R" + struct.pack("<I", len(p)) + p
    if isinstance(p, np.ndarray):
        code = {np.dtype(np.float64): b"d", np.dtype(np.float32): b"f",
                np.dtype(np.int32): b"i", np.dtype(np.int64): b"l"}[p.dtype]
        raw = p.tobytes()
        comp = zlib.compress(raw)
        if len(comp) < len(raw):
            return (code + struct.pack("<III", p.size, 1, len(comp)) + comp)
        return code + struct.pack("<III", p.size, 0, len(raw)) + raw
    raise TypeError(f"unsupported FBX property {type(p)}")


def _enc_node(node: _Node, offset: int) -> bytes:
    props = b"".join(_enc_prop(p) for p in node.props)
    name = node.name.encode()
    body = b""
    if node.children:
        child_off = offset + 13 + len(name) + len(props)
        for c in node.children:
            cb = _enc_node(c, child_off)
            body += cb
            child_off += len(cb)
        body += b"\x00" * 13  # null terminator record
    end = offset + 13 + len(name) + len(props) + len(body)
    return (struct.pack("<III", end, len(node.props), len(props))
            + struct.pack("<B", len(name)) + name + props + body)


def _write_doc(path: str, roots: list[_Node]):
    out = bytearray(_HEADER + struct.pack("<I", _VERSION))
    for r in roots:
        out += _enc_node(r, len(out))
    out += b"\x00" * 13
    # standard footer: 16 magic-ish bytes + padding + version + 120 zeros + id
    out += bytes([0xfa, 0xbc, 0xab, 0x09, 0xd0, 0xc8, 0xd4, 0x66,
                  0xb1, 0x76, 0xfb, 0x83, 0x1c, 0xf7, 0x26, 0x7e])
    while len(out) % 16:
        out += b"\x00"
    out += b"\x00" * 4
    out += struct.pack("<I", _VERSION)
    out += b"\x00" * 120
    out += bytes([0xf8, 0x5a, 0x8c, 0x6a, 0xde, 0xf5, 0xd9, 0x7e,
                  0xec, 0xe9, 0x0c, 0xe3, 0x75, 0x8f, 0x29, 0x0b])
    with open(path, "wb") as f:
        f.write(bytes(out))


# --------------------------------------------------------------------------- #
# writer
# --------------------------------------------------------------------------- #
def export_animated_fbx(path: str, vertices: np.ndarray, faces: np.ndarray,
                        frames: np.ndarray | None = None, fps: float = 12.0,
                        uv: np.ndarray | None = None, name: str = "motion324"):
    """Write a binary FBX with optional per-frame morph-target animation.

    Args:
      vertices: (V, 3) base mesh positions.
      faces: (F, 3) int triangle indices.
      frames: optional (T, V, 3) per-frame vertex positions — each frame
        becomes a blend shape whose DeformPercent steps 0->100->0 (the
        reference's shape-key-per-frame scheme, utils/render.py:117-200).
      uv: optional (V, 2) per-vertex UVs.
    """
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    n_v = len(v)

    ids = iter(range(100000, 10**9, 7))
    geo_id, model_id = next(ids), next(ids)

    root_objects = _Node("Objects")

    # ---- Geometry ---------------------------------------------------------
    geo = root_objects.add("Geometry", geo_id, f"Geometry::{name}", "Mesh")
    geo.add("Vertices", v.reshape(-1))
    pvi = f.copy().reshape(-1, 3)
    pvi[:, 2] = -pvi[:, 2] - 1  # last index of each polygon is XOR'd
    geo.add("PolygonVertexIndex", pvi.reshape(-1).astype(np.int32))
    geo.add("GeometryVersion", 124)
    if uv is not None:
        uvl = geo.add("LayerElementUV", 0)
        uvl.add("Version", 101)
        uvl.add("Name", "UVMap")
        uvl.add("MappingInformationType", "ByPolygonVertexIndex")
        uvl.add("ReferenceInformationType", "IndexToDirect")
        uvl.add("UV", np.asarray(uv, np.float64).reshape(-1))
        uvl.add("UVIndex", f.reshape(-1).astype(np.int32))
        layer = geo.add("Layer", 0)
        layer.add("Version", 100)
        le = layer.add("LayerElement")
        le.add("Type", "LayerElementUV")
        le.add("TypedIndex", 0)

    # ---- Model ------------------------------------------------------------
    model = root_objects.add("Model", model_id, f"Model::{name}", "Mesh")
    model.add("Version", 232)
    p70 = model.add("Properties70")
    p70.add("P", "Lcl Translation", "Lcl Translation", "", "A",
            0.0, 0.0, 0.0)

    connections = _Node("Connections")
    connections.add("C", "OO", geo_id, model_id)
    connections.add("C", "OO", model_id, 0)

    n_frames = 0 if frames is None else len(frames)
    if n_frames:
        frames = np.asarray(frames, np.float64)
        deformer_id = next(ids)
        deform = root_objects.add("Deformer", deformer_id,
                                  f"Deformer::{name}_shapes", "BlendShape")
        deform.add("Version", 100)
        connections.add("C", "OO", deformer_id, geo_id)

        stack_id, layer_id = next(ids), next(ids)
        stack = root_objects.add("AnimationStack", stack_id,
                                 "AnimStack::anim", "")
        sp = stack.add("Properties70")
        stop = int(round(n_frames / fps * _FBX_TICKS_PER_SEC))
        sp.add("P", "LocalStop", "KTime", "Time", "", stop)
        sp.add("P", "ReferenceStop", "KTime", "Time", "", stop)
        alayer = root_objects.add("AnimationLayer", layer_id,
                                  "AnimLayer::base", "")
        del alayer
        connections.add("C", "OO", layer_id, stack_id)

        for t in range(n_frames):
            shape_id = next(ids)
            chan_id = next(ids)
            curve_id = next(ids)
            cnode_id = next(ids)

            delta = frames[t] - v
            nz = np.where(np.any(np.abs(delta) > 0, axis=1))[0]
            if len(nz) == 0:
                nz = np.array([0])
            shape = root_objects.add("Geometry", shape_id,
                                     f"Geometry::frame_{t:04d}", "Shape")
            shape.add("Version", 100)
            shape.add("Indexes", nz.astype(np.int32))
            shape.add("Vertices", delta[nz].reshape(-1))
            shape.add("Normals", np.zeros(len(nz) * 3, np.float64))

            chan = root_objects.add("Deformer", chan_id,
                                    f"SubDeformer::frame_{t:04d}",
                                    "BlendShapeChannel")
            chan.add("Version", 100)
            chan.add("DeformPercent", 0.0)
            chan.add("FullWeights", np.array([100.0], np.float64))

            connections.add("C", "OO", chan_id, deformer_id)
            connections.add("C", "OO", shape_id, chan_id)

            # stepped curve: 100 only on frame t (CONSTANT interpolation,
            # like the reference's shape-key keyframes)
            times = []
            values = []
            for k in (t - 1, t, t + 1):
                if 0 <= k < n_frames:
                    times.append(int(round(k / fps * _FBX_TICKS_PER_SEC)))
                    values.append(100.0 if k == t else 0.0)
            curve = root_objects.add("AnimationCurve", curve_id,
                                     "AnimCurve::", "")
            curve.add("Default", 0.0)
            curve.add("KeyVer", 4008)
            curve.add("KeyTime", np.asarray(times, np.int64))
            curve.add("KeyValueFloat", np.asarray(values, np.float32))
            # 2 = constant interpolation flag set per key
            curve.add("KeyAttrFlags", np.array([2], np.int32))
            curve.add("KeyAttrDataFloat", np.zeros(4, np.float32))
            curve.add("KeyAttrRefCount", np.array([len(times)], np.int32))

            cnode = root_objects.add("AnimationCurveNode", cnode_id,
                                     "AnimCurveNode::DeformPercent", "")
            cp = cnode.add("Properties70")
            cp.add("P", "d|DeformPercent", "Number", "", "A", 0.0)
            connections.add("C", "OO", cnode_id, layer_id)
            connections.add("C", "OP", cnode_id, chan_id,
                            "DeformPercent")
            connections.add("C", "OP", curve_id, cnode_id,
                            "d|DeformPercent")

    # ---- boilerplate ------------------------------------------------------
    header = _Node("FBXHeaderExtension")
    header.add("FBXHeaderVersion", 1003)
    header.add("FBXVersion", _VERSION)
    header.add("Creator", "motion324_tpu")
    gs = _Node("GlobalSettings")
    gs.add("Version", 1000)
    gp = gs.add("Properties70")
    gp.add("P", "UpAxis", "int", "Integer", "", 1)
    gp.add("P", "UnitScaleFactor", "double", "Number", "", 1.0)
    docs = _Node("Documents")
    docs.add("Count", 1)
    doc = docs.add("Document", next(ids), "", "Scene")
    doc.add("RootNode", 0)
    defs = _Node("Definitions")
    defs.add("Version", 100)
    defs.add("Count", 2 + 2 * n_frames)
    for ot, cnt in (("Model", 1), ("Geometry", 1 + n_frames),
                    ("Deformer", (1 + n_frames) if n_frames else 0),
                    ("AnimationStack", 1 if n_frames else 0),
                    ("AnimationLayer", 1 if n_frames else 0),
                    ("AnimationCurve", n_frames),
                    ("AnimationCurveNode", n_frames)):
        if cnt:
            o = defs.add("ObjectType", ot)
            o.add("Count", cnt)

    _write_doc(path, [header, gs, docs, _Node("References"), defs,
                      root_objects, connections,
                      _Node("Takes", )])
    return path


# --------------------------------------------------------------------------- #
# reader
# --------------------------------------------------------------------------- #
def _read_prop(buf, pos):
    code = buf[pos:pos + 1]
    pos += 1
    if code == b"C":
        return bool(buf[pos]), pos + 1
    if code == b"L":
        return struct.unpack_from("<q", buf, pos)[0], pos + 8
    if code == b"I":
        return struct.unpack_from("<i", buf, pos)[0], pos + 4
    if code == b"D":
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if code == b"F":
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    if code in (b"S", b"R"):
        n = struct.unpack_from("<I", buf, pos)[0]
        data = buf[pos + 4:pos + 4 + n]
        return (data.decode(errors="replace") if code == b"S" else data), \
            pos + 4 + n
    if code in (b"d", b"f", b"i", b"l"):
        n, enc, clen = struct.unpack_from("<III", buf, pos)
        pos += 12
        raw = buf[pos:pos + clen]
        pos += clen
        if enc:
            raw = zlib.decompress(raw)
        dt = {b"d": np.float64, b"f": np.float32,
              b"i": np.int32, b"l": np.int64}[code]
        return np.frombuffer(raw, dt, count=n), pos
    raise ValueError(f"unknown FBX property code {code!r}")


def _read_node(buf, pos):
    end, n_props, _plen = struct.unpack_from("<III", buf, pos)
    if end == 0:
        return None, pos + 13
    name_len = buf[pos + 12]
    name = buf[pos + 13:pos + 13 + name_len].decode()
    pos = pos + 13 + name_len
    props = []
    for _ in range(n_props):
        p, pos = _read_prop(buf, pos)
        props.append(p)
    node = _Node(name, *props)
    while pos < end:
        child, pos = _read_node(buf, pos)
        if child is None:
            break
        node.children.append(child)
    return node, end


def load_fbx(path: str):
    """Parse a binary FBX into ``{vertices, faces, uv, shapes}``.

    ``shapes``: list of (name, indexes (K,), deltas (K, 3)) blend shapes in
    file order. Triangulates polygons by fanning.
    """
    buf = open(path, "rb").read()
    if not buf.startswith(_HEADER[:21]):
        raise ValueError("not a binary FBX file")
    pos = len(_HEADER) + 4
    roots = []
    while pos < len(buf):
        node, pos = _read_node(buf, pos)
        if node is None:
            break
        roots.append(node)

    def find_all(name):
        out = []
        for r in roots:
            if r.name == "Objects":
                out += [c for c in r.children if c.name == name]
        return out

    verts = faces = uv = None
    shapes = []
    for g in find_all("Geometry"):
        kind = g.props[2] if len(g.props) > 2 else ""
        sub = {c.name: c for c in g.children}
        if kind == "Mesh" and "Vertices" in sub:
            verts = np.asarray(sub["Vertices"].props[0],
                               np.float64).reshape(-1, 3)
            pvi = np.asarray(sub["PolygonVertexIndex"].props[0], np.int64)
            faces = _triangulate(pvi)
            for c in g.children:
                if c.name == "LayerElementUV":
                    uvsub = {x.name: x for x in c.children}
                    uv_vals = np.asarray(uvsub["UV"].props[0],
                                         np.float64).reshape(-1, 2)
                    uv = uv_vals
        elif kind == "Shape":
            name = str(g.props[1]).split("::")[-1]
            idx = np.asarray(sub["Indexes"].props[0], np.int64)
            deltas = np.asarray(sub["Vertices"].props[0],
                                np.float64).reshape(-1, 3)
            shapes.append((name, idx, deltas))
    return {"vertices": verts, "faces": faces, "uv": uv, "shapes": shapes}


def _triangulate(pvi: np.ndarray) -> np.ndarray:
    faces = []
    poly = []
    for x in pvi:
        if x < 0:
            poly.append(-x - 1)
            for i in range(1, len(poly) - 1):
                faces.append([poly[0], poly[i], poly[i + 1]])
            poly = []
        else:
            poly.append(x)
    return np.asarray(faces, np.int64)
