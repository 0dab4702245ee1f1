"""The reference's own scene tables, built from the benchmark's frozen
inputs (`portbench/scenes/build.py`): the material table (deduplicated by
value, as the upstream's `PackMaterialToList`), world-space triangles with
area-weighted vertex normals, spheres, and a bounding-volume hierarchy of
its own over the triangles (`accel.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .accel import TriangleAccel

MATERIAL_KEYS = ("albedo", "specular", "metallic", "roughness", "emissive",
                 "ior", "absorption")


@dataclasses.dataclass
class RefScene:
    materials: dict  # name -> tensor: albedo [M, 4] ... priority [M] int32
    tri_normals: torch.Tensor  # [T, 3, 3] world, unnormalized
    tri_material: torch.Tensor  # [T] int64
    sphere_center: torch.Tensor  # [S, 3]
    sphere_radius: torch.Tensor  # [S]
    sphere_material: torch.Tensor  # [S] int64
    any_transmissive: bool
    accel: TriangleAccel | None
    env_mips: list  # [H, W, 3] mips, finest first; empty without a sky

    @property
    def num_spheres(self) -> int:
        return int(self.sphere_radius.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.tri_material.shape[0])

    def with_materials(self, materials: dict) -> "RefScene":
        return dataclasses.replace(self, materials=materials)


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    v0, v1, v2 = (vertices[faces[:, k]] for k in range(3))
    face_n = np.cross(v1 - v0, v2 - v0)
    normals = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(normals, faces[:, k], face_n)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    return (normals / np.maximum(lens, 1e-12)).astype(np.float32)


def material_table(mats: list, device) -> dict:
    """Pack material dicts (the fields of `scenes.build.material`) into
    the table the shading reads (the upstream's `PackHalogenMaterial`)."""
    k = max(len(mats), 1)
    t = {"albedo": np.zeros((k, 4), np.float32),
         "specular": np.ones((k, 3), np.float32),
         "metallic": np.zeros((k,), np.float32),
         "roughness": np.ones((k,), np.float32),
         "emissive": np.zeros((k, 4), np.float32),
         "ior": np.ones((k,), np.float32),
         "absorption": np.zeros((k, 3), np.float32),
         "priority": np.zeros((k,), np.int32)}
    for i, m in enumerate(mats):
        t["albedo"][i, :3] = m["color"]
        t["albedo"][i, 3] = m["opacity"]
        t["specular"][i] = m["specular_color"]
        t["metallic"][i] = m["metallic"]
        t["roughness"][i] = m["roughness"]
        t["emissive"][i, :3] = m["emission_color"]
        t["emissive"][i, 3] = m["emission_intensity"]
        t["ior"][i] = m["index_of_refraction"]
        ss = np.asarray(m["subsurface_color"], np.float32)
        t["absorption"][i] = (1.0 / np.maximum(ss, 1e-6)) * max(
            m["absorption"], 0.0)
        t["priority"][i] = m["dielectric_priority"]
    return {n: torch.from_numpy(a).to(device) for n, a in t.items()}


def build_scene(objects: list, device, env_image: torch.Tensor | None = None,
                num_mips: int = 6) -> RefScene:
    """Tables of `objects` on `device`; `env_image` [H, W, 3] is the sky."""
    from .sky import build_mips

    mats: list = []

    def index(m: dict) -> int:
        for i, e in enumerate(mats):
            if e == m:
                return i
        mats.append(m)
        return len(mats) - 1

    spheres = [o for o in objects if o["kind"] == "sphere"]
    meshes = [o for o in objects if o["kind"] == "mesh"]
    s_mat = [index(o["material"]) for o in spheres]
    verts, norms, tri_mat = [], [], []
    for o in meshes:
        v, f = o["verts"], o["faces"]
        l2w = np.asarray(o["transform"], np.float32)
        w2l = np.linalg.inv(l2w).astype(np.float32)
        tv = v[f]
        tn = vertex_normals(v, f)[f]
        verts.append((tv @ l2w[:3, :3].T + l2w[:3, 3]).astype(np.float32))
        norms.append((tn @ w2l[:3, :3]).astype(np.float32))
        tri_mat.append(np.full(len(f), index(o["material"]), np.int64))
    tv = np.concatenate(verts) if verts else np.zeros((0, 3, 3), np.float32)
    tn = np.concatenate(norms) if norms else np.zeros((0, 3, 3), np.float32)
    table = material_table(mats, device)
    t = lambda a, dt=None: torch.from_numpy(np.ascontiguousarray(a)).to(
        device, dt)
    mips = [] if env_image is None else build_mips(
        env_image.to(device, torch.float32), num_mips)
    return RefScene(
        materials=table, tri_normals=t(tn),
        tri_material=t(np.concatenate(tri_mat) if tri_mat
                       else np.zeros(0, np.int64)),
        sphere_center=t(np.asarray([o["center"] for o in spheres],
                                   np.float32).reshape(-1, 3)),
        sphere_radius=t(np.asarray([o["radius"] for o in spheres],
                                   np.float32)),
        sphere_material=t(np.asarray(s_mat, np.int64)),
        any_transmissive=bool(table["albedo"][:, 3].min().item() < 1.0),
        accel=TriangleAccel(tv, device) if len(tv) else None,
        env_mips=mips)
