"""Scene registry and tensor packing (PyTorch port of
`halogen_tpu/scene/scene.py`, without the BVH, the traversal packers,
the light table and the envmap).

`build()` flattens the registered spheres and meshes into a `SceneData`:
materials deduplicated by value (`PackMaterialToList`,
HalogenRenderPass.cs:524-537), triangles concatenated with per-mesh
offsets, and world-space triangle copies for the brute-force intersector.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from halogen_tpu_torch.core.types import MaterialTable, SceneData
from halogen_tpu_torch.scene.material import Material

# The JAX package's BVH construction keeps the given triangle order for a mesh
# of at most this many triangles (one leaf, `accel/bvh.py:32`). Larger
# meshes are reordered by the BVH build, which the port does not have yet.
MAX_LEAF_TRIS = 5


@dataclasses.dataclass
class MeshEntry:
    tri_verts: np.ndarray  # [T, 3, 3] local space
    tri_normals: np.ndarray  # [T, 3, 3] local space
    transform: np.ndarray  # [4, 4] local->world
    material: Material


@dataclasses.dataclass
class SphereEntry:
    center: np.ndarray
    radius: float
    material: Material


class Scene:
    """Mutable scene description; `build()` produces the tensors the
    integrator reads."""

    def __init__(self):
        self.meshes: List[MeshEntry] = []
        self.spheres: List[SphereEntry] = []

    def add_sphere(self, center, radius: float, material: Material) -> int:
        self.spheres.append(
            SphereEntry(np.asarray(center, np.float32), float(radius), material)
        )
        return len(self.spheres) - 1

    def add_mesh(
        self,
        vertices: np.ndarray,
        indices: np.ndarray,
        material: Material,
        normals: Optional[np.ndarray] = None,
        transform: Optional[np.ndarray] = None,
    ) -> int:
        """Register a triangle mesh: vertices [V, 3], indices [F, 3] (or
        flat [3F]), optional per-vertex normals [V, 3] (default:
        area-weighted vertex normals), optional [4, 4] local->world."""
        vertices = np.asarray(vertices, np.float32)
        indices = np.asarray(indices, np.int32).reshape(-1, 3)
        if normals is None:
            normals = _vertex_normals(vertices, indices)
        else:
            normals = np.asarray(normals, np.float32)
        if transform is None:
            transform = np.eye(4, dtype=np.float32)
        self.meshes.append(
            MeshEntry(vertices[indices], normals[indices],
                      np.asarray(transform, np.float32), material)
        )
        return len(self.meshes) - 1

    def build(self, envmap: Optional[object] = None,
              device="cpu") -> SceneData:
        if envmap is not None:
            raise NotImplementedError(
                "envmaps are not ported yet (ROADMAP A8)")
        materials: List[Material] = []

        def material_index(m: Material) -> int:
            # Dedup by value (HalogenRenderPass.cs:524-537)
            for i, existing in enumerate(materials):
                if existing == m:
                    return i
            materials.append(m)
            return len(materials) - 1

        s_center = np.zeros((len(self.spheres), 3), np.float32)
        s_radius = np.zeros((len(self.spheres),), np.float32)
        s_mat = np.zeros((len(self.spheres),), np.int32)
        for i, s in enumerate(self.spheres):
            s_center[i] = s.center
            s_radius[i] = s.radius
            s_mat[i] = material_index(s.material)

        tv_local, tn_local, tv_world, tn_world = [], [], [], []
        tri_mat, tri_mesh = [], []
        m_tri_off, m_mat, m_w2l, m_l2w = [], [], [], []
        tri_cursor = 0
        for mi, m in enumerate(self.meshes):
            t = m.tri_verts.shape[0]
            if t > MAX_LEAF_TRIS:
                raise NotImplementedError(
                    f"mesh {mi} has {t} triangles; meshes of more than "
                    f"{MAX_LEAF_TRIS} need the BVH build (ROADMAP A9)")
            verts, norms = m.tri_verts, m.tri_normals
            mat_idx = material_index(m.material)

            l2w = m.transform
            w2l = np.linalg.inv(l2w).astype(np.float32)
            # points by L2W, normals by inverse-transpose (rows of W2L),
            # unnormalized (normalized after barycentric interpolation,
            # HalgoenCompute.compute:463-467)
            vw = verts @ l2w[:3, :3].T + l2w[:3, 3]
            nw = norms @ w2l[:3, :3]

            tv_local.append(verts)
            tn_local.append(norms)
            tv_world.append(vw.astype(np.float32))
            tn_world.append(nw.astype(np.float32))
            tri_mat.append(np.full(t, mat_idx, np.int32))
            tri_mesh.append(np.full(t, mi, np.int32))
            m_tri_off.append(tri_cursor)
            m_mat.append(mat_idx)
            m_w2l.append(w2l)
            m_l2w.append(l2w)
            tri_cursor += t

        def cat(parts, empty_shape, dtype=np.float32):
            if parts:
                return np.concatenate(parts).astype(dtype)
            return np.zeros(empty_shape, dtype)

        def stack44(parts):
            return np.stack(parts) if parts else np.zeros((0, 4, 4), np.float32)

        mat_table = _pack_materials(materials, device)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return SceneData(
            tri_verts_world=t(cat(tv_world, (0, 3, 3))),
            tri_normals_world=t(cat(tn_world, (0, 3, 3))),
            tri_material=t(cat(tri_mat, (0,), np.int32)),
            tri_mesh=t(cat(tri_mesh, (0,), np.int32)),
            tri_verts_local=t(cat(tv_local, (0, 3, 3))),
            tri_normals_local=t(cat(tn_local, (0, 3, 3))),
            mesh_tri_offset=t(np.asarray(m_tri_off, np.int32)),
            mesh_material=t(np.asarray(m_mat, np.int32)),
            mesh_world_to_local=t(stack44(m_w2l)),
            mesh_local_to_world=t(stack44(m_l2w)),
            sphere_center=t(s_center),
            sphere_radius=t(s_radius),
            sphere_material=t(s_mat),
            materials=mat_table,
            # any material that can refract (transmission alpha < 1)?
            any_transmissive=bool(mat_table.albedo[:, 3].min().item() < 1.0),
        )


def _vertex_normals(vertices: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals for meshes without authored normals."""
    v0, v1, v2 = (vertices[indices[:, k]] for k in range(3))
    face_n = np.cross(v1 - v0, v2 - v0)
    normals = np.zeros_like(vertices)
    for k in range(3):
        np.add.at(normals, indices[:, k], face_n)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    return (normals / np.maximum(lens, 1e-12)).astype(np.float32)


def _pack_materials(materials: List[Material], device) -> MaterialTable:
    """Pack to the material table (PackHalogenMaterial,
    HalogenRenderPass.cs:425-446)."""
    k = max(len(materials), 1)
    albedo = np.zeros((k, 4), np.float32)
    specular = np.ones((k, 3), np.float32)
    metallic = np.zeros((k,), np.float32)
    roughness = np.ones((k,), np.float32)
    emissive = np.zeros((k, 4), np.float32)
    ior = np.ones((k,), np.float32)
    absorption = np.zeros((k, 3), np.float32)
    priority = np.zeros((k,), np.int32)
    for i, m in enumerate(materials):
        albedo[i, :3] = m.color
        albedo[i, 3] = m.opacity
        specular[i] = m.specular_color
        metallic[i] = m.metallic
        roughness[i] = m.roughness
        emissive[i, :3] = m.emission_color
        emissive[i, 3] = m.emission_intensity
        ior[i] = m.index_of_refraction
        absorption[i] = m.packed_absorption()
        priority[i] = m.dielectric_priority
    t = lambda a: torch.from_numpy(a).to(device)
    return MaterialTable(
        albedo=t(albedo), specular=t(specular), metallic=t(metallic),
        roughness=t(roughness), emissive=t(emissive), ior=t(ior),
        absorption=t(absorption), priority=t(priority),
    )
