"""Scene tensors (PyTorch port of `halogen_tpu/core/types.py`).

Dataclasses of tensors on one device, SoA and flat like the JAX pytrees
(the reference's packed ComputeBuffers, `HalogenRenderPass.cs:10-76`).
`.to(device)` returns a copy on another device. The BVH node arrays, the
light table and the envmap of the JAX `SceneData` are not part of the
port's brute-force slice and have no fields here.
"""

from __future__ import annotations

import dataclasses

import torch

NO_MEDIUM_ID = -1  # empty-medium materialID (HalgoenCompute.compute:84)
EMPTY_PRIORITY = 2**31 - 1  # empty-medium priority ~ +inf (compute:85)


def _to(obj, device):
    """Copy of a tensor dataclass with every tensor field on `device`."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor) or dataclasses.is_dataclass(v):
            v = v.to(device)
        kw[f.name] = v
    return type(obj)(**kw)


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """Deduplicated material buffer (PackedHalogenMaterial,
    HalogenRenderPass.cs:44-55,425-446). All fields [K, ...] float32/int32.
    `absorption` is pre-packed as (1/subsurfaceColor) * absorption;
    `emissive` stores rgb + intensity in w."""

    albedo: torch.Tensor  # [K, 4] rgb + transmission alpha
    specular: torch.Tensor  # [K, 3]
    metallic: torch.Tensor  # [K]
    roughness: torch.Tensor  # [K]
    emissive: torch.Tensor  # [K, 4] rgb + intensity
    ior: torch.Tensor  # [K]
    absorption: torch.Tensor  # [K, 3]
    priority: torch.Tensor  # [K] int32 (<0: no interface tracking)

    @property
    def count(self) -> int:
        return self.albedo.shape[0]

    def to(self, device) -> "MaterialTable":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Flattened render-ready scene: world-space triangle copies for the
    brute-force intersector, local-space copies and per-mesh transforms,
    spheres, materials. `any_transmissive` is a build-time fact: False
    means every material is opaque."""

    tri_verts_world: torch.Tensor  # [T, 3, 3]
    tri_normals_world: torch.Tensor  # [T, 3, 3] inverse-transpose, unnormalized
    tri_material: torch.Tensor  # [T] int32
    tri_mesh: torch.Tensor  # [T] int32 owning mesh id
    tri_verts_local: torch.Tensor  # [T, 3, 3]
    tri_normals_local: torch.Tensor  # [T, 3, 3]
    mesh_tri_offset: torch.Tensor  # [M] int32
    mesh_material: torch.Tensor  # [M] int32
    mesh_world_to_local: torch.Tensor  # [M, 4, 4]
    mesh_local_to_world: torch.Tensor  # [M, 4, 4]
    sphere_center: torch.Tensor  # [S, 3]
    sphere_radius: torch.Tensor  # [S]
    sphere_material: torch.Tensor  # [S] int32
    materials: MaterialTable
    any_transmissive: bool = True

    @property
    def num_triangles(self) -> int:
        return self.tri_verts_world.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sphere_center.shape[0]

    @property
    def num_meshes(self) -> int:
        return self.mesh_tri_offset.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_verts_world.device

    def to(self, device) -> "SceneData":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class HitRecord:
    """SoA batch of resolved closest hits (RayHit,
    HalgoenCompute.compute:156-164)."""

    t: torch.Tensor  # [N] distance, +inf on miss
    pos: torch.Tensor  # [N, 3]
    normal: torch.Tensor  # [N, 3] shading normal, flipped double-sided
    orientation: torch.Tensor  # [N] +1 front / -1 back
    material: torch.Tensor  # [N] int32 material index
    tri: torch.Tensor  # [N] global triangle index, -1 for sphere/miss
    sphere: torch.Tensor  # [N] sphere index, -1 for triangle/miss
