"""The port's binary-FBX importer (`halogen_tpu_torch/scene/fbx.py`)
against the JAX package's (`halogen_tpu/scene/fbx.py`), bit for bit, on
files this test writes: FBX 7.4 (32-bit record headers, a 13-byte null
record) and 7.5 (64-bit, 25 bytes), raw and zlib-deflated arrays, quads
and triangles, two Geometry nodes among other nodes and property types.
The committed `dragon_8k_raw.npz` written as FBX and read back gives
`dragon_8k.npz` through `normalized`, and `meshes._real_mesh` parses the
FBX model where its fixture is missing, or raises naming both paths.

The JAX package has no writer, so the small one here is the test's own:
it follows the container layout the importers read (header, node
records with end offsets, typed properties, arrays with an encoding).
"""

import pathlib
import struct
import zlib

import numpy as np
import pytest

from halogen_tpu.scene import fbx as jfbx
from halogen_tpu_torch.scene import fbx as tfbx
from halogen_tpu_torch.scene import meshes

ASSETS = pathlib.Path(meshes.__file__).parent / "assets"
_ARRAY_CODE = {np.dtype("<f8"): b"d", np.dtype("<f4"): b"f",
               np.dtype("<i4"): b"i", np.dtype("<i8"): b"l",
               np.dtype("<i1"): b"b"}


def _prop(v, deflate: bool) -> bytes:
    if isinstance(v, np.ndarray):
        raw = v.tobytes()
        enc = 0
        if deflate:
            raw, enc = zlib.compress(raw), 1
        return (_ARRAY_CODE[v.dtype] + struct.pack("<III", v.size, enc,
                                                   len(raw)) + raw)
    if isinstance(v, bytes):
        return b"S" + struct.pack("<I", len(v)) + v
    if isinstance(v, float):
        return b"D" + struct.pack("<d", v)
    code, value = v  # an explicit (type code, value) scalar
    return code + struct.pack({b"Y": "<h", b"C": "<b", b"I": "<i",
                               b"F": "<f", b"L": "<q"}[code], value)


def _node(name: str, props, children, at: int, big: bool,
          deflate: bool) -> bytes:
    """One node record starting at byte `at` of the file."""
    head = 24 if big else 12
    body = b"".join(_prop(p, deflate) for p in props)
    pos = at + head + 1 + len(name) + len(body)
    kids = b""
    for child in children:
        kids += _node(*child, pos + len(kids), big, deflate)
    if children:
        kids += b"\0" * (head + 1)  # the null record closing the list
    end = pos + len(kids)
    fmt = "<QQQ" if big else "<III"
    return (struct.pack(fmt, end, len(props), len(body)) + bytes([len(name)])
            + name.encode() + body + kids)


def write_fbx(path, nodes, version: int, deflate: bool) -> None:
    """A binary FBX file of top-level `nodes`, each (name, props,
    children)."""
    big = version >= 7500
    buf = jfbx._MAGIC + struct.pack("<I", version)
    for node in nodes:
        buf += _node(*node, len(buf), big, deflate)
    buf += b"\0" * (25 if big else 13)
    pathlib.Path(path).write_bytes(buf)


def _geometry(gid: int, verts, poly, extra=()):
    children = [
        ("Vertices", [np.asarray(verts, "<f8").reshape(-1)], []),
        ("PolygonVertexIndex", [np.asarray(poly, "<i4")], []),
        *extra,
    ]
    return ("Geometry", [(b"L", gid), b"Geometry::mesh\x00\x01Geometry",
                         b"Mesh"], children)


def _scene_nodes():
    """Two meshes: a quad and a triangle, then a pentagon (its fan) and a
    triangle; a Geometry without polygons; other nodes and property
    types around them."""
    rng = np.random.default_rng(5)
    quad_tri = _geometry(1, rng.normal(size=(5, 3)),
                         [0, 1, 2, ~3, 1, 4, ~2],
                         extra=[("LayerElementNormal", [(b"I", 0)],
                                 [("Normals", [rng.normal(size=9)], []),
                                  ("Version", [(b"I", 101)], [])])])
    penta = _geometry(2, rng.normal(size=(7, 3)) * 3.0,
                      [0, 1, 2, 3, ~4, 4, 5, ~6])
    shape = ("Geometry", [(b"L", 3), b"Shape", b"Shape"],
             [("Indexes", [np.arange(4, dtype="<i4")], [])])
    header = ("FBXHeaderExtension", [],
              [("FBXVersion", [(b"I", 7400)], []),
               ("Creator", [b"halogen test writer"], []),
               ("Flags", [(b"Y", 3), (b"C", 1), (b"F", 0.5)], [])])
    objects = ("Objects", [], [quad_tri, shape, penta,
                               ("Model", [(b"L", 9), b"Model", b"Mesh"],
                                [("Scale", [1.0], [])])])
    return [header, ("GlobalSettings", [2.5, (b"L", -7)], []), objects]


@pytest.mark.parametrize("version", [7400, 7500])
@pytest.mark.parametrize("deflate", [False, True])
def test_fbx_matches_jax(tmp_path, version, deflate):
    path = tmp_path / "mesh.fbx"
    write_fbx(path, _scene_nodes(), version, deflate)
    v, f = tfbx.load_fbx_geometry(str(path))
    jv, jf = jfbx.load_fbx_geometry(str(path))
    assert v.dtype == jv.dtype == np.float32
    assert f.dtype == jf.dtype == np.int32
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    # the quad's and the pentagon's fans, the second mesh offset by 5
    np.testing.assert_array_equal(f, [[0, 1, 2], [0, 2, 3], [1, 4, 2],
                                      [5, 6, 7], [5, 7, 8], [5, 8, 9],
                                      [9, 10, 11]])
    assert v.shape == (12, 3)
    for size in (1.0, 2.0):
        np.testing.assert_array_equal(tfbx.normalized(v, size),
                                      jfbx.normalized(jv, size))
    root, got_version = tfbx._parse(path.read_bytes())
    assert got_version == version
    assert [n.name for n in root.children] == [
        "FBXHeaderExtension", "GlobalSettings", "Objects"]


def test_fbx_rejects_what_it_cannot_read(tmp_path):
    with pytest.raises(ValueError, match="not a binary FBX"):
        tfbx._parse(b"; FBX 7.4.0 project file\n")
    path = tmp_path / "empty.fbx"
    write_fbx(path, [("Objects", [], [("Model", [(b"L", 1)], [])])], 7400,
              False)
    with pytest.raises(ValueError, match="no polygon geometry"):
        tfbx.load_fbx_geometry(str(path))


def test_dragon_fixture_round_trips_through_fbx(tmp_path, monkeypatch):
    """dragon_8k_raw.npz (the Unity-local vertices) written as an FBX 7.5
    file with deflated arrays, read back and normalized, is
    dragon_8k.npz bit for bit; `_real_mesh` parses that file where the
    fixture it names is missing."""
    raw = np.load(ASSETS / "dragon_8k_raw.npz")
    poly = raw["faces"].astype(np.int64)
    poly[:, 2] = ~poly[:, 2]
    path = tmp_path / "Dragon_8k.fbx"
    write_fbx(path, [("Objects", [], [_geometry(7, raw["verts"],
                                                poly.reshape(-1))])],
              7500, True)
    want = np.load(ASSETS / "dragon_8k.npz")
    v, f = tfbx.load_fbx_geometry(str(path))
    np.testing.assert_array_equal(f, want["faces"])
    np.testing.assert_array_equal(tfbx.normalized(v, 2.0).astype(np.float32),
                                  want["verts"])
    monkeypatch.setattr(meshes, "REFERENCE_MODELS", tmp_path)
    mv, mf = meshes._real_mesh("no_such_fixture.npz", path.name)
    np.testing.assert_array_equal(mv, want["verts"])
    np.testing.assert_array_equal(mf, want["faces"])


def test_real_mesh_names_both_missing_paths(tmp_path, monkeypatch):
    monkeypatch.setattr(meshes, "REFERENCE_MODELS", tmp_path)
    with pytest.raises(FileNotFoundError) as err:
        meshes._real_mesh("no_such_fixture.npz", "No_Such_Model.fbx")
    assert "no_such_fixture.npz" in str(err.value)
    assert str(tmp_path / "No_Such_Model.fbx") in str(err.value)
    # with the fixture present, the fixture
    v, f = meshes.real_closet_mesh()
    assert f.shape == (540, 3) and v.dtype == np.float32
