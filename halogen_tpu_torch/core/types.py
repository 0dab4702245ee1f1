"""Scene tensors (PyTorch port of `halogen_tpu/core/types.py`).

Dataclasses of tensors on one device, SoA and flat like the JAX pytrees
(the reference's packed ComputeBuffers, `HalogenRenderPass.cs:10-76`).
`.to(device)` returns a copy on another device. The light table of the
JAX `SceneData` is not ported yet (ROADMAP A8), and its TPU packings of
the world BVH (`wbvh`'s [R, 128] rows, the treelet, flatlet and raylet
tables) are replaced by one `WorldBVH` of the port's own layout.
"""

from __future__ import annotations

import dataclasses

import torch

NO_MEDIUM_ID = -1  # empty-medium materialID (HalgoenCompute.compute:84)
EMPTY_PRIORITY = 2**31 - 1  # empty-medium priority ~ +inf (compute:85)


def target_device(device) -> torch.device:
    """The device a public entry point builds on: the card unless the
    caller asks for the CPU. Raises rather than fall back to the CPU when
    the card is asked for and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points build on the card by "
            "default; pass device='cpu' to run the plain versions on the "
            "CPU")
    return device


def _to(obj, device):
    """Copy of a tensor dataclass with every tensor field on `device`."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, tuple) and not hasattr(v, "_fields"):
            v = tuple(t.to(device) for t in v)  # a tuple of tensors
        elif hasattr(v, "to"):  # a tensor, a tensor dataclass or NamedTuple
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
class WorldBVH:
    """One BVH over every world-space triangle of the scene, for the
    traversal kernels (`kernels/traverse.py`, the megakernel's BVH tier).
    Triangles sit in the tree's leaf order ("slots"); `tri_map` maps a
    slot to the scene's global triangle id. A node is 8 floats, two
    16-byte loads: lo.xyz, hi.xyz, index_a, count (ints as exact floats;
    count > 0 marks a leaf of triangles index_a.., else the children are
    nodes index_a and index_a + 1). Node 0 is the root."""

    nodes: torch.Tensor  # [Nn, 8] float32
    tris: torch.Tensor  # [T, 9] float32 in slot order: v0, e1, e2
    trin: torch.Tensor  # [T, 10] float32 in slot order: n0, n1-n0, n2-n0, mat
    tri_map: torch.Tensor  # [T] int32: slot -> global triangle id

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    def to(self, device) -> "WorldBVH":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Flattened render-ready scene: world-space triangle copies for the
    brute-force intersector, local-space copies and per-mesh transforms
    and BVHs for the lockstep traversal, the world BVH, spheres, materials
    and the envmap. `any_transmissive` is a build-time fact: False means
    every material is opaque."""

    tri_verts_world: torch.Tensor  # [T, 3, 3]
    tri_normals_world: torch.Tensor  # [T, 3, 3] inverse-transpose, unnormalized
    tri_material: torch.Tensor  # [T] int32
    tri_mesh: torch.Tensor  # [T] int32 owning mesh id
    tri_verts_local: torch.Tensor  # [T, 3, 3]
    tri_normals_local: torch.Tensor  # [T, 3, 3]
    # Per-mesh BVH nodes concatenated (indices local to the mesh)
    bvh_lo: torch.Tensor  # [B, 3]
    bvh_hi: torch.Tensor  # [B, 3]
    bvh_index_a: torch.Tensor  # [B] int32
    bvh_count: torch.Tensor  # [B] int32
    mesh_tri_offset: torch.Tensor  # [M] int32
    mesh_bvh_offset: torch.Tensor  # [M] int32
    mesh_material: torch.Tensor  # [M] int32
    mesh_world_to_local: torch.Tensor  # [M, 4, 4]
    mesh_local_to_world: torch.Tensor  # [M, 4, 4]
    sphere_center: torch.Tensor  # [S, 3]
    sphere_radius: torch.Tensor  # [S]
    sphere_material: torch.Tensor  # [S] int32
    materials: MaterialTable
    # Environment map mip pyramid (equirectangular, linear RGB), finest
    # first; the empty tuple is a black sky.
    env_mips: tuple = ()
    # Its luminance alias tables (scene/envmap.EnvCDF) for next-event
    # estimation, or None.
    env_cdf: object = None
    any_transmissive: bool = True
    # The world BVH (None for a scene without triangles)
    wbvh: WorldBVH | None = None

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
