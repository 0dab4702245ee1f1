"""Minimal binary-FBX geometry loader (the port's copy of the JAX
package's `halogen_tpu/scene/fbx.py`; pure numpy).

Reads just enough of the Kaydara binary FBX container (versions 7.1-7.5)
to extract triangle geometry: `Objects/Geometry` nodes' `Vertices`
(float64 array) and `PolygonVertexIndex` (int32 array, negative value =
XOR-complemented last index of a polygon). Polygons triangulate by fan.
Everything else (materials, animation, transforms) is ignored — the
reference's models (its `Assets/Models/*.fbx`, e.g. Dragon_8k.fbx used
by the Testing Scene's Dragon group) are single
static meshes whose placement the scene constructors set explicitly.
Version 7.5 files use 64-bit record headers (a 25-byte null record);
earlier ones 32-bit (13 bytes).

This is a clean-room reader of the publicly documented container layout
(header, node records, typed property records, zlib-deflated arrays);
the reference itself contains no importer — Unity's asset pipeline did
this job (`RayTracingMesh.cs:60-62` reads the already-imported mesh).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"Kaydara FBX Binary  \x00\x1a\x00"

_SCALAR_FMT = {
    b"Y": ("<h", 2),
    b"C": ("<b", 1),
    b"I": ("<i", 4),
    b"F": ("<f", 4),
    b"D": ("<d", 8),
    b"L": ("<q", 8),
}
_ARRAY_DTYPE = {
    b"f": np.dtype("<f4"),
    b"d": np.dtype("<f8"),
    b"l": np.dtype("<i8"),
    b"i": np.dtype("<i4"),
    b"b": np.dtype("<i1"),
}


class _Node:
    __slots__ = ("name", "props", "children")

    def __init__(self, name, props, children):
        self.name = name
        self.props = props
        self.children = children

    def find_all(self, name):
        return [c for c in self.children if c.name == name]

    def find(self, name):
        for c in self.children:
            if c.name == name:
                return c
        return None


def _read_property(buf, pos):
    code = buf[pos:pos + 1]
    pos += 1
    if code in _SCALAR_FMT:
        fmt, size = _SCALAR_FMT[code]
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if code in _ARRAY_DTYPE:
        n, enc, clen = struct.unpack_from("<III", buf, pos)
        pos += 12
        raw = buf[pos:pos + clen]
        pos += clen
        if enc == 1:
            raw = zlib.decompress(raw)
        return np.frombuffer(raw, dtype=_ARRAY_DTYPE[code], count=n), pos
    if code in (b"S", b"R"):
        n = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        return buf[pos:pos + n], pos + n
    raise ValueError(f"unknown FBX property type {code!r} at {pos - 1}")


def _read_node(buf, pos, big):
    """One node record; returns (node | None, next_pos). None = the
    null terminator record that closes a child list."""
    if big:  # FBX >= 7.5: 64-bit offsets
        end, nprops, _plen = struct.unpack_from("<QQQ", buf, pos)
        pos += 24
    else:
        end, nprops, _plen = struct.unpack_from("<III", buf, pos)
        pos += 12
    name_len = buf[pos]
    pos += 1
    name = buf[pos:pos + name_len].decode("ascii", "replace")
    pos += name_len
    if end == 0:
        return None, pos
    props = []
    for _ in range(nprops):
        val, pos = _read_property(buf, pos)
        props.append(val)
    children = []
    while pos < end:
        child, pos = _read_node(buf, pos, big)
        if child is None:  # null record terminates the child list
            break
        children.append(child)
    return _Node(name, props, children), end


def _parse(buf) -> _Node:
    if not buf.startswith(_MAGIC):
        raise ValueError("not a binary FBX file")
    version = struct.unpack_from("<I", buf, 23)[0]
    big = version >= 7500
    pos = 27
    roots = []
    while pos < len(buf):
        node, pos = _read_node(buf, pos, big)
        if node is None:
            break
        roots.append(node)
    return _Node("", [], roots), version


def _triangulate(poly_idx: np.ndarray) -> np.ndarray:
    """PolygonVertexIndex -> [M, 3] int32 fan triangulation. A negative
    entry v marks the final vertex of a polygon and encodes index ~v."""
    faces = []
    start = 0
    idx = poly_idx.astype(np.int64)
    ends = np.nonzero(idx < 0)[0]
    fixed = np.where(idx < 0, ~idx, idx)
    for e in ends:
        poly = fixed[start:e + 1]
        for i in range(1, len(poly) - 1):
            faces.append((poly[0], poly[i], poly[i + 1]))
        start = e + 1
    return np.asarray(faces, np.int32).reshape(-1, 3)


def load_fbx_geometry(path: str):
    """All Geometry meshes in `path`, merged: (verts [N,3] f32,
    faces [M,3] i32)."""
    with open(path, "rb") as f:
        buf = f.read()
    root, _version = _parse(buf)
    objects = root.find("Objects")
    if objects is None:
        raise ValueError(f"{path}: no Objects node")
    all_verts, all_faces, off = [], [], 0
    for geom in objects.find_all("Geometry"):
        vnode = geom.find("Vertices")
        inode = geom.find("PolygonVertexIndex")
        if vnode is None or inode is None:
            continue
        verts = np.asarray(vnode.props[0], np.float64).reshape(-1, 3)
        faces = _triangulate(np.asarray(inode.props[0]))
        all_verts.append(verts.astype(np.float32))
        all_faces.append(faces + off)
        off += len(verts)
    if not all_verts:
        raise ValueError(f"{path}: no polygon geometry found")
    return np.concatenate(all_verts), np.concatenate(all_faces)


def normalized(verts: np.ndarray, target_size: float = 1.0):
    """Center at the origin and uniformly scale so the largest AABB axis
    equals `target_size` (scene constructors then place explicitly)."""
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    center = (lo + hi) * 0.5
    scale = target_size / max(float((hi - lo).max()), 1e-9)
    return (verts - center) * scale
