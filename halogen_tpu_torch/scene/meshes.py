"""Mesh import + procedural dragon-class geometry (PyTorch port of
`halogen_tpu/scene/meshes.py`; numpy only, as there).

The reference's hero meshes (`Assets/Models/{Dragon_8k,Dragon_87k,
Suzanne Final,Closet_Solid}.fbx`) arrive through Unity's FBX importer; the
87k dragon and envmap EXR are missing large blobs even in the reference
(`.MISSING_LARGE_BLOBS:1-3`). This module provides the equivalent import
path — a dependency-free Wavefront OBJ loader — plus procedural
dragon-class meshes (torus knots, perturbed icospheres) at controllable
triangle counts so the BVH/benchmark ladder runs without binary assets.
"""

from __future__ import annotations

import pathlib

import numpy as np

from halogen_tpu_torch.scene.material import Material
from halogen_tpu_torch.scene.scene import Scene

_ASSETS = pathlib.Path(__file__).parent / "assets"
# where the reference keeps its FBX models (the JAX package's path), parsed
# where a fixture is absent
REFERENCE_MODELS = pathlib.Path("/root/reference/Assets/Models")


# ---------------------------------------------------------------------------
# Wavefront OBJ (the asset-import path; v / vn / f with n-gon fanning)
# ---------------------------------------------------------------------------

def load_obj(path: str):
    """Load an OBJ file -> (vertices [V,3], faces [F,3], normals [V,3] or
    None). Supports v/vn/f records, negative indices, and n-gon fans."""
    verts, normals, faces = [], [], []
    norm_idx = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif tag == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif tag == "f":
                idx = []
                nidx = []
                for tok in parts[1:]:
                    comps = tok.split("/")
                    vi = int(comps[0])
                    idx.append(vi - 1 if vi > 0 else len(verts) + vi)
                    if len(comps) >= 3 and comps[2]:
                        ni = int(comps[2])
                        nidx.append(ni - 1 if ni > 0 else len(normals) + ni)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
                    if nidx:
                        norm_idx.append([nidx[0], nidx[k], nidx[k + 1]])
    v = np.asarray(verts, np.float32)
    f_arr = np.asarray(faces, np.int32)
    vn = None
    if normals and norm_idx and len(norm_idx) == len(faces):
        # re-index per-vertex normals onto vertex indices when they align;
        # otherwise fall back to computed normals (Scene.add_mesh default)
        vn_src = np.asarray(normals, np.float32)
        vn = np.zeros_like(v)
        counts = np.zeros((v.shape[0], 1), np.float32)
        fi = f_arr.reshape(-1)
        ni = np.asarray(norm_idx, np.int32).reshape(-1)
        np.add.at(vn, fi, vn_src[ni])
        np.add.at(counts, fi, 1.0)
        vn = vn / np.maximum(counts, 1.0)
        lens = np.linalg.norm(vn, axis=1, keepdims=True)
        vn = (vn / np.maximum(lens, 1e-12)).astype(np.float32)
    return v, f_arr, vn


# ---------------------------------------------------------------------------
# Procedural dragon-class meshes
# ---------------------------------------------------------------------------

def torus_knot(p: int = 2, q: int = 3, segments: int = 256,
               tube_segments: int = 32, radius: float = 1.0,
               tube_radius: float = 0.25):
    """(p, q) torus-knot tube mesh -> (vertices [V,3], faces [F,3]).

    Triangle count = 2 * segments * tube_segments; dragon-class complexity
    (long, twisting, self-shadowing) at ~16k tris for the defaults.
    """
    t = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    r = radius * (2.0 + np.cos(q * t)) / 3.0
    center = np.stack(
        [r * np.cos(p * t), radius * np.sin(q * t) * 0.5, r * np.sin(p * t)],
        axis=1,
    )
    # Frenet-ish frame via finite differences
    nxt = np.roll(center, -1, axis=0)
    prv = np.roll(center, 1, axis=0)
    tangent = nxt - prv
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    ref = np.array([0.0, 1.0, 0.0])
    binorm = np.cross(tangent, ref)
    bad = np.linalg.norm(binorm, axis=1) < 1e-6
    binorm[bad] = np.array([1.0, 0.0, 0.0])
    binorm /= np.linalg.norm(binorm, axis=1, keepdims=True)
    normal = np.cross(binorm, tangent)

    phi = np.linspace(0.0, 2.0 * np.pi, tube_segments, endpoint=False)
    ring = (np.cos(phi)[:, None, None] * normal[None]
            + np.sin(phi)[:, None, None] * binorm[None])  # [TS, S, 3]
    pts = center[None] + tube_radius * ring
    verts = pts.transpose(1, 0, 2).reshape(-1, 3).astype(np.float32)

    faces = []
    for i in range(segments):
        for j in range(tube_segments):
            a = i * tube_segments + j
            b = i * tube_segments + (j + 1) % tube_segments
            c = ((i + 1) % segments) * tube_segments + j
            d = ((i + 1) % segments) * tube_segments + (j + 1) % tube_segments
            faces.append([a, c, b])
            faces.append([b, c, d])
    return verts, np.asarray(faces, np.int32)


def icosphere(subdivisions: int = 3, radius: float = 1.0):
    """Subdivided icosahedron -> (vertices, faces). 20*4^n triangles."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdivisions):
        edge_mid = {}
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                m /= np.linalg.norm(m)
                verts_list.append(m)
                edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)
    return (verts * radius).astype(np.float32), faces.astype(np.int32)


def dragon_mesh(subdivisions: int = 4, seed: int = 7):
    """Dragon-class stand-in: an icosphere displaced by low-frequency noise
    bands — lumpy, concave, self-shadowing (the BVH stressor role of the
    missing Dragon_87k.fbx). 20*4^n tris (n=4 -> 5120, n=5 -> 20480)."""
    verts, faces = icosphere(subdivisions)
    rng = np.random.default_rng(seed)
    disp = np.zeros(verts.shape[0])
    for freq, amp in ((1.5, 0.25), (3.0, 0.12), (7.0, 0.05)):
        phase = rng.uniform(0, 2 * np.pi, size=3)
        k = rng.normal(size=(3, 3))
        proj = verts @ (freq * k.T)
        disp += amp * np.sin(proj + phase).sum(axis=1) / 3.0
    out = verts * (1.0 + disp[:, None])
    out[:, 1] *= 0.75  # squash: reclining-dragon proportions
    return out.astype(np.float32), faces


def _scale_translate(s, t):
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = m[1, 1] = m[2, 2] = s
    m[:3, 3] = t
    return m


def real_dragon_mesh():
    """The reference's actual Dragon_8k.fbx geometry (8,712 triangles,
    used by the Testing Scene's Dragon group), from the port's copy of the
    committed npz fixture, else parsed from the reference's FBX file
    (`_real_mesh`). Returns (verts [N,3] f32 normalized to a 2-unit box,
    faces [M,3] i32)."""
    return _real_mesh("dragon_8k.npz", "Dragon_8k.fbx")


def glass_dragon_scene(tris: int | None = None) -> Scene:
    """BASELINE ladder config 4: glass dragon in a Cornell shell — nested
    dielectrics, Beer-Lambert absorption, per-type bounce limits, RR.

    Uses the reference's real Dragon_8k geometry by default; pass `tris`
    to substitute the procedural stand-in at a chosen triangle count
    (e.g. for BVH stress tests)."""
    from halogen_tpu_torch.scene.cornell import cornell_box

    s = cornell_box(with_spheres=False)
    if tris is None:
        verts, faces = real_dragon_mesh()
    else:
        sub = max(2, int(round(np.log(tris / 20.0) / np.log(4.0))))
        verts, faces = dragon_mesh(sub)
    glass = Material.glass(ior=1.5, subsurface=(0.85, 0.95, 1.0),
                           absorption=0.6, priority=1)
    s.add_mesh(verts, faces, glass,
               transform=_scale_translate(0.55, (0.0, -0.45, 0.0)))
    # air bubble inside the dragon: nested-dielectric exerciser
    s.add_sphere((0.0, -0.45, 0.0), 0.18, Material.glass(ior=1.0, priority=0))
    return s


def dragons_hero_scene(n: int = 3, tris: int | None = None) -> Scene:
    """BASELINE ladder config 5: several dragons, mixed materials, under a
    sky — the multi-host 4096spp hero scene."""
    s = Scene()
    floor = Material.diffuse((0.55, 0.55, 0.55))
    s.add_mesh(
        np.array([(-8, -1, -8), (8, -1, -8), (8, -1, 8), (-8, -1, 8)],
                 np.float32),
        np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        floor,
    )
    sub = None if tris is None else max(
        2, int(round(np.log(tris / 20.0) / np.log(4.0))))
    mats = [
        Material.metal((0.95, 0.64, 0.54), roughness=0.15),  # copper
        Material.glass(ior=1.5, subsurface=(0.9, 1.0, 0.95), absorption=0.4,
                       priority=1),
        Material.diffuse((0.2, 0.35, 0.7)),
        Material.metal((0.9, 0.9, 0.9), roughness=0.05),
        Material.emissive((1.0, 0.6, 0.3), 3.0),
    ]
    for i in range(n):
        if sub is None:
            # real Dragon_8k instances (per-mesh transforms differ, so
            # each instance still exercises its own BVH + normal matrix)
            verts, faces = real_dragon_mesh()
        else:
            verts, faces = dragon_mesh(sub, seed=11 + i)
        x = (i - (n - 1) / 2.0) * 1.6
        s.add_mesh(verts, faces, mats[i % len(mats)],
                   transform=_scale_translate(0.6, (x, -0.4, -i * 0.7)))
    return s


def _real_mesh(fixture_name: str, fbx_name: str):
    """A committed npz fixture of the package's assets, else the
    reference's FBX model `REFERENCE_MODELS / fbx_name` parsed by
    `scene/fbx.py` and normalized to a 2-unit box, as the JAX package's
    `_real_mesh` does. Raises FileNotFoundError naming both paths where
    neither exists."""
    fixture = _ASSETS / fixture_name
    if fixture.exists():
        data = np.load(fixture)
        return data["verts"], data["faces"]
    fbx_path = REFERENCE_MODELS / fbx_name
    if not fbx_path.exists():
        raise FileNotFoundError(
            f"neither the mesh fixture {fixture} nor the FBX model "
            f"{fbx_path} exists")
    from halogen_tpu_torch.scene.fbx import load_fbx_geometry, normalized

    v, f = load_fbx_geometry(str(fbx_path))
    return normalized(v, 2.0).astype(np.float32), f


def real_suzanne_mesh():
    """The reference's `Suzanne Final.fbx` (15,744 triangles, used by the
    Testing Scene's Suzanne group). Normalized to a 2-unit box."""
    return _real_mesh("suzanne.npz", "Suzanne Final.fbx")


def real_closet_mesh():
    """The reference's `Closet_Solid.fbx` (540 triangles, the Testing
    Scene's Closet interior). Normalized to a 2-unit box."""
    return _real_mesh("closet.npz", "Closet_Solid.fbx")


def suzanne_scene() -> Scene:
    """Testing Scene 'Suzanne' group equivalent (`Assets/Scenes/Testing
    Scene.unity`): the Suzanne mesh over a floor, one glossy + one
    diffuse companion sphere."""
    s = Scene()
    floor = Material.diffuse((0.55, 0.55, 0.55))
    s.add_mesh(
        np.array([(-6, -1, -6), (6, -1, -6), (6, -1, 6), (-6, -1, 6)],
                 np.float32),
        np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        floor,
    )
    verts, faces = real_suzanne_mesh()
    s.add_mesh(verts, faces, Material.diffuse((0.75, 0.55, 0.35)),
               transform=_scale_translate(0.8, (0.0, -0.2, 0.0)))
    s.add_sphere((1.6, -0.5, 0.6), 0.5,
                 Material.metal((0.9, 0.9, 0.92), roughness=0.1))
    s.add_sphere((-1.6, -0.5, 0.6), 0.5, Material.diffuse((0.2, 0.4, 0.7)))
    return s


def closet_scene() -> Scene:
    """Testing Scene 'Closet' group equivalent: the Closet_Solid interior
    with an emissive panel and a pair of demo spheres inside."""
    s = Scene()
    verts, faces = real_closet_mesh()
    s.add_mesh(verts, faces, Material.diffuse((0.7, 0.68, 0.62)),
               transform=_scale_translate(1.4, (0.0, 0.0, 0.0)))
    s.add_sphere((0.0, 0.9, 0.0), 0.12,
                 Material.emissive((1.0, 0.95, 0.9), 8.0))
    s.add_sphere((-0.35, -0.5, 0.1), 0.22,
                 Material.metal((0.95, 0.75, 0.4), roughness=0.25))
    s.add_sphere((0.35, -0.55, -0.1), 0.18,
                 Material.glass(ior=1.5, priority=0))
    return s


def outdoors_scene() -> Scene:
    """Testing Scene 'OutdoorsScene' group equivalent: ground plane +
    mixed-material spheres lit by the sky envmap (build with
    `envmap=...`; the group relies on the HDRI sky, reference settings
    `useHDRISky`, HalogenRenderFeature.cs:47-52)."""
    s = Scene()
    ground = Material.diffuse((0.45, 0.5, 0.35))
    s.add_mesh(
        np.array([(-30, -1, -30), (30, -1, -30), (30, -1, 30),
                  (-30, -1, 30)], np.float32),
        np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        ground,
    )
    mats = [
        Material.diffuse((0.8, 0.3, 0.25)),
        Material.metal((0.9, 0.9, 0.9), roughness=0.05),
        Material.glass(ior=1.5, priority=0),
        Material.metal((0.95, 0.7, 0.4), roughness=0.35),
        Material.diffuse((0.25, 0.35, 0.75)),
    ]
    for i, m in enumerate(mats):
        s.add_sphere((i * 1.4 - 2.8, -0.45, -(i % 2) * 1.2), 0.55, m)
    return s


def deep_strip_scene(n: int = 150, growth: float = 1.15) -> Scene:
    """A narrow mesh whose world BVH is deep: n triangles across the +x
    axis, triangle i at x = growth**i with half-size 0.5 * growth**i, so
    from the origin each fills the same ±26° cone, odd ones pointing up
    (+z) and even ones down. Built with `max_leaf=1`, the SAH tree peels
    the largest triangles off one by one, and a ray from the origin into
    the cone leaves 19 far children pending in its walk; a ray that
    passes beside triangle 0 and meets triangle 1 finds it in the 19th
    entry of its stack. Camera: `STRIP_CAM`."""
    s = Scene()
    scale = growth ** np.arange(n, dtype=np.float64)[:, None, None]
    up = np.array([(1.0, -0.5, -0.5), (1.0, 0.5, -0.5), (1.0, 0.0, 0.5)])
    down = up * np.array([1.0, 1.0, -1.0])
    corners = np.where((np.arange(n) % 2 == 1)[:, None, None], up, down)
    verts = (scale * corners).reshape(-1, 3)
    s.add_mesh(verts.astype(np.float32),
               np.arange(3 * n, dtype=np.int32).reshape(n, 3),
               Material.diffuse((0.7, 0.7, 0.7)))
    return s


STRIP_CAM = dict(position=(0.0, 0.0, 0.0), target=(1.0, 0.0, 0.0),
                 fov_deg=40.0)


def bvh_test_scene(tris: int = 4000) -> Scene:
    """Testing Scene 'BVH Test' group equivalent: dense high-poly
    geometry (torus knot) whose render exercises deep traversal — used
    with the tri/box-test debug heatmaps (HalgoenCompute.compute:841-855)."""
    s = Scene()
    floor = Material.diffuse((0.5, 0.5, 0.5))
    s.add_mesh(
        np.array([(-8, -1.2, -8), (8, -1.2, -8), (8, -1.2, 8),
                  (-8, -1.2, 8)], np.float32),
        np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        floor,
    )
    seg = max(16, int(np.sqrt(tris / 2)) * 2)
    verts, faces = torus_knot(segments=seg, tube_segments=max(8, seg // 8))
    s.add_mesh(verts, faces, Material.metal((0.8, 0.82, 0.85),
                                            roughness=0.2),
               transform=_scale_translate(0.8, (0.0, -0.1, 0.0)))
    return s
