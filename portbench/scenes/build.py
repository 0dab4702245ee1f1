"""The benchmark's frozen scene inputs, read into plain arrays.

One builder hands the same arrays to the program under test and to the
plain reference: a scene is a list of objects, each a mesh (local
vertices [V, 3] float32, faces [F, 3] int32, a local-to-world [4, 4]
float32 matrix) or a sphere (world center, radius), with a material dict
of the upstream `HalogenMaterial`'s fields (`material`). The files
beside this one are copies, frozen here, of the upstream Testing Scene's
parse (`testing_scene.json`, with the mesh fixtures it needs in Unity-local
coordinates) and of the Cornell box description (`cornell_glossy.json`).
"""

from __future__ import annotations

import functools
import json
import pathlib

import numpy as np

HERE = pathlib.Path(__file__).parent

def _unit_cube():
    """Unity's builtin Cube: 1x1x1 about the origin."""
    v = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
                  for z in (-0.5, 0.5)], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def _unit_plane():
    """Unity's builtin Plane: 10x10 in XZ, +Y normal."""
    v = np.array([[-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5]],
                 np.float32)
    return v, np.array([[0, 2, 1], [0, 3, 2]], np.int32)


def _unit_quad():
    """Unity's builtin Quad: 1x1 in XY."""
    v = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0],
                  [-0.5, 0.5, 0]], np.float32)
    return v, np.array([[0, 1, 2], [0, 2, 3]], np.int32)


def _unit_sphere_mesh(lat: int = 16, lon: int = 24):
    """Unity's builtin Sphere mesh: a radius-0.5 UV sphere."""
    vs, fs = [], []
    for i in range(lat + 1):
        th = np.pi * i / lat
        for j in range(lon):
            ph = 2 * np.pi * j / lon
            vs.append([0.5 * np.sin(th) * np.cos(ph), 0.5 * np.cos(th),
                       0.5 * np.sin(th) * np.sin(ph)])
    for i in range(lat):
        for j in range(lon):
            a, b = i * lon + j, i * lon + (j + 1) % lon
            c, d = (i + 1) * lon + j, (i + 1) * lon + (j + 1) % lon
            if i > 0:
                fs.append([a, b, c])
            if i < lat - 1:
                fs.append([b, d, c])
    return np.asarray(vs, np.float32), np.asarray(fs, np.int32)


_BUILTIN = {"cube": _unit_cube, "plane": _unit_plane, "quad": _unit_quad,
            "sphere_mesh": _unit_sphere_mesh}
# Dragon_87k.fbx is a missing blob upstream; its instance takes Dragon_8k
_ASSET = {"dragon_8k": "dragon_8k_raw", "dragon_87k": "dragon_8k_raw",
          "suzanne": "suzanne_raw", "closet": "closet_raw"}


@functools.lru_cache(maxsize=None)
def _mesh(kind: str, name: str):
    if kind == "builtin":
        return _BUILTIN[name]()
    data = np.load(HERE / f"{_ASSET[name]}.npz")
    return (np.asarray(data["verts"], np.float32),
            np.asarray(data["faces"], np.int32))


def _unity_material(m: dict) -> dict:
    return {"color": list(m["color"][:3]), "opacity": float(m["color"][3]),
            "roughness": m["roughness"], "metallic": m["metallic"],
            "specular_color": list(m["specular_color"]),
            "subsurface_color": list(m["subsurface_color"]),
            "index_of_refraction": m["ior"], "absorption": m["absorption"],
            "dielectric_priority": m["dielectric_priority"],
            "emission_color": list(m["emission_color"]),
            "emission_intensity": m["emission_intensity"]}


def material(**fields) -> dict:
    """A material dict: the given fields over `HalogenMaterial`'s
    defaults."""
    out = {"color": [1.0, 1.0, 1.0], "opacity": 1.0, "roughness": 1.0,
           "metallic": 0.0, "specular_color": [1.0, 1.0, 1.0],
           "subsurface_color": [1.0, 1.0, 1.0], "index_of_refraction": 1.0,
           "absorption": 0.0, "dielectric_priority": 0,
           "emission_color": [0.0, 0.0, 0.0], "emission_intensity": 0.0}
    unknown = set(fields) - set(out)
    if unknown:
        raise ValueError(f"unknown material fields {sorted(unknown)}")
    out.update(fields)
    return out


def _testing_scene(active_only: bool) -> tuple:
    fix = json.loads((HERE / "testing_scene.json").read_text())
    objs = []
    for o in fix["objects"]:
        if active_only and not o["active"]:
            continue
        mat = _unity_material(o["material"])
        world = np.asarray(o["world"], np.float32).reshape(4, 4)
        if o["type"] == "sphere":
            # RayTracingSphere: the radius scaled by the transform's scale
            scale = float(np.cbrt(abs(np.linalg.det(world[:3, :3]))))
            objs.append({"kind": "sphere", "center": world[:3, 3].copy(),
                         "radius": float(o["radius"] * scale),
                         "material": mat})
        else:
            v, f = _mesh(o["mesh"]["kind"], o["mesh"].get("name", "cube"))
            objs.append({"kind": "mesh", "verts": v, "faces": f,
                         "transform": world, "material": mat})
    cam = fix["cameras"][0]
    m = np.asarray(cam["world"], np.float32).reshape(4, 4)
    camera = {"position": m[:3, 3].tolist(),
              "target": (m[:3, 3] + m[:3, 2]).tolist(),
              "up": m[:3, 1].tolist(), "fov_deg": cam["fov_deg"],
              "near": cam["near"], "far": cam["far"]}
    return objs, camera


def _json_scene(name: str) -> tuple:
    desc = json.loads((HERE / f"{name}.json").read_text())
    mats = {k: material(**v) for k, v in desc["materials"].items()}
    objs = []
    for q in desc.get("quads", []):
        objs.append({"kind": "mesh",
                     "verts": np.asarray(q["corners"], np.float32),
                     "faces": np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                     "transform": np.eye(4, dtype=np.float32),
                     "material": mats[q["material"]], "name": q["name"]})
    for s in desc.get("spheres", []):
        objs.append({"kind": "sphere",
                     "center": np.asarray(s["center"], np.float32),
                     "radius": float(s["radius"]),
                     "material": mats[s["material"]], "name": s["name"]})
    return objs, dict(desc["camera"])


def load(scene: str) -> tuple:
    """(objects, camera) of a frozen scene by name: `testing_scene_active`
    (the Testing Scene's shipped active set), `testing_scene_all`, or the
    name of a JSON description beside this file. The camera is a dict of
    position, target, up, fov_deg, near and far."""
    if scene.startswith("testing_scene_"):
        return _testing_scene(scene == "testing_scene_active")
    return _json_scene(scene)


def procedural_hdri(width: int, seed: int, device) -> "torch.Tensor":
    """[width / 2, width, 3] float32 equirectangular sky on `device`: a sun
    disc up to ~2000, a horizon glow, ground bounce and low-frequency
    cloud noise whose phases come from `seed` (the formula of the port's
    `hdr_io.procedural_hdri`, a stand-in for the upstream's missing 4k
    EXR), computed in float64 on the device."""
    import torch

    h = width // 2
    f64 = dict(dtype=torch.float64, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    phases = torch.rand((2, 2), generator=gen, **f64) * (2 * np.pi)
    v = torch.arange(h, **f64)[:, None] / h
    u = torch.arange(width, **f64)[None, :] / width
    theta, phi = v * np.pi, u * (2 * np.pi)
    theta, phi = torch.broadcast_tensors(theta, phi)
    st = torch.sin(theta)
    d = torch.stack([st * torch.cos(phi), torch.cos(theta),
                     st * torch.sin(phi)], -1)
    sun_dir = torch.tensor([0.45, 0.65, 0.61], **f64)
    sun_dir = sun_dir / torch.linalg.norm(sun_dir)
    cosang = (d @ sun_dir).clamp(-1, 1)[..., None]
    up = d[..., 1:2]
    sky_t = up * 0.5 + 0.5
    sky = (torch.tensor([0.35, 0.55, 0.95], **f64) * sky_t
           + torch.tensor([0.9, 0.75, 0.6], **f64) * (1 - sky_t))
    sun = 2000.0 * torch.exp((cosang - 1.0) * 4000.0) * torch.tensor(
        [1.0, 0.93, 0.85], **f64)
    halo = 6.0 * torch.exp((cosang - 1.0) * 40.0) * torch.tensor(
        [1.0, 0.9, 0.75], **f64)
    ground = torch.tensor([0.25, 0.22, 0.18], **f64) * 0.7
    img = torch.where(up > 0, sky + halo, ground) + sun
    for k, octv in enumerate((4, 9)):
        wave = (torch.cos(octv * phi + phases[k, 0])
                * torch.sin(octv * theta + phases[k, 1]))
        img = img * (1.0 + 0.12 * wave[..., None] * (up > 0))
    return img.clamp_min(0.0).to(torch.float32)
