"""The reference's full Testing-Scene composite fixture (PyTorch port of
`halogen_tpu/scene/testing_scene.py`, reading the port's copy of the
fixture).

Reconstructs `Assets/Scenes/Testing Scene.unity` (Kabinet0/
Halogen-Pathtracer; 9,685 lines, 31 `RayTracingSphere` + 31
`RayTracingMesh` objects in feature groups — Cornell Box, Material Demo,
Fresnel/Transparency/Roughness/Metallic Spheres, Scale Demo, Glow Orbs,
BVH Test, OutdoorsScene, Dragon/Suzanne/Closet meshes) from the
committed JSON fixture `assets/testing_scene.json`, parsed once from the
Unity YAML by `scripts/parse_unity_scene.py`: exact world transforms,
exact `HalogenMaterial` values (emissive intensities up to 10.09,
dielectric priorities 1-2 in use), exact active flags, and the main
camera (FOV 60, near 0.6, far 1000).

This is the reference's feature-matrix sandbox as ONE scene (SURVEY.md
§4.2) — the everything-at-once regression fixture: many materials, mixed
dielectric priorities, TLAS pressure from 62 objects.

Mesh sources: Unity builtin cube/plane/quad/sphere meshes are generated
procedurally with Unity's builtin dimensions; the FBX models load from
npz fixtures baked in Unity-local coordinates (`*_raw.npz`, converted by
`scene/fbx.py` from the reference FBX files — the closet's local AABB
matches the scene's embedded copy of the mesh to the last digit, which
pins the import scale at 1). `Dragon_87k.fbx` is a missing large blob in
the reference snapshot (`.MISSING_LARGE_BLOBS:1`); its one instance uses
the Dragon_8k geometry instead.

Coordinates are imported as-is (Unity left-handed Y-up). The renderer is
handedness-agnostic — the fixture is self-consistent and golden-tested;
images are mirrored relative to Unity screenshots.
"""

from __future__ import annotations

import functools
import json
import pathlib

import numpy as np

from halogen_tpu_torch.scene.material import Material
from halogen_tpu_torch.scene.scene import Scene

_ASSETS = pathlib.Path(__file__).parent / "assets"


def _unit_cube():
    """Unity builtin Cube: 1x1x1 centered at the origin."""
    v = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
                  for z in (-0.5, 0.5)], np.float32)
    f = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],   # x- x+
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],   # y- y+
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],   # z- z+
    ], np.int32)
    return v, f


def _unit_plane():
    """Unity builtin Plane: 10x10 units in XZ, +Y normal, centered."""
    v = np.array([[-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5]],
                 np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    return v, f


def _unit_quad():
    """Unity builtin Quad: 1x1 in XY, centered."""
    v = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0],
                  [-0.5, 0.5, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return v, f


def _unit_sphere_mesh(lat: int = 16, lon: int = 24):
    """Unity builtin Sphere mesh: radius 0.5 UV sphere."""
    vs, fs = [], []
    for i in range(lat + 1):
        th = np.pi * i / lat
        for j in range(lon):
            ph = 2 * np.pi * j / lon
            vs.append([0.5 * np.sin(th) * np.cos(ph), 0.5 * np.cos(th),
                       0.5 * np.sin(th) * np.sin(ph)])
    for i in range(lat):
        for j in range(lon):
            a = i * lon + j
            b = i * lon + (j + 1) % lon
            c = (i + 1) * lon + j
            d = (i + 1) * lon + (j + 1) % lon
            if i > 0:
                fs.append([a, b, c])
            if i < lat - 1:
                fs.append([b, d, c])
    return np.asarray(vs, np.float32), np.asarray(fs, np.int32)


@functools.lru_cache(maxsize=None)
def _mesh_source(kind: str, name: str):
    if kind == "builtin":
        return {
            "cube": _unit_cube, "plane": _unit_plane, "quad": _unit_quad,
            "sphere_mesh": _unit_sphere_mesh,
        }[name]()
    # asset fixtures in Unity-local coordinates
    fixture = {"dragon_8k": "dragon_8k_raw", "dragon_87k": "dragon_8k_raw",
               "suzanne": "suzanne_raw", "closet": "closet_raw"}[name]
    data = np.load(_ASSETS / f"{fixture}.npz")
    return np.asarray(data["verts"], np.float32), np.asarray(
        data["faces"], np.int32)


def _material(m: dict) -> Material:
    return Material(
        color=tuple(m["color"][:3]),
        opacity=float(m["color"][3]),
        roughness=m["roughness"],
        metallic=m["metallic"],
        specular_color=tuple(m["specular_color"]),
        subsurface_color=tuple(m["subsurface_color"]),
        index_of_refraction=m["ior"],
        absorption=m["absorption"],
        dielectric_priority=m["dielectric_priority"],
        emission_color=tuple(m["emission_color"]),
        emission_intensity=m["emission_intensity"],
    )


def load_fixture() -> dict:
    return json.loads((_ASSETS / "testing_scene.json").read_text())


def testing_scene(all_groups: bool = True) -> Scene:
    """Build the composite Testing Scene.

    all_groups=True (the regression fixture) includes every object; the
    reference keeps most groups disabled in the editor — pass False for
    the shipped active set (Cornell Box at root + the enabled
    OutdoorsScene closet)."""
    fix = load_fixture()
    s = Scene()
    for o in fix["objects"]:
        if not all_groups and not o["active"]:
            continue
        mat = _material(o["material"])
        world = np.asarray(o["world"], np.float32).reshape(4, 4)
        if o["type"] == "sphere":
            # RayTracingSphere: world center from the transform, radius
            # scaled by the transform's (uniform) scale, like the
            # component's lossyScale sync (RayTracingSphere.cs:14-17)
            center = world[:3, 3]
            scale = float(np.cbrt(abs(np.linalg.det(world[:3, :3]))))
            s.add_sphere(center, o["radius"] * scale, mat)
        else:
            v, f = _mesh_source(o["mesh"]["kind"],
                                o["mesh"].get("name", "cube"))
            s.add_mesh(v, f, mat, transform=world)
    return s


def testing_scene_camera(device="cuda"):
    """The scene's Main Camera: position/orientation from its world
    matrix (Unity forward = +Z column), FOV 60, near 0.6, far 1000, on
    `device` (the card unless the caller asks for the CPU)."""
    from halogen_tpu_torch.integrator.camera import make_camera

    fix = load_fixture()
    cam = fix["cameras"][0]
    m = np.asarray(cam["world"], np.float32).reshape(4, 4)
    pos = m[:3, 3]
    fwd = m[:3, 2]
    up = m[:3, 1]
    return make_camera(
        position=tuple(pos), target=tuple(pos + fwd), up=tuple(up),
        fov_deg=cam["fov_deg"], near=cam["near"], far=cam["far"],
        device=device)
