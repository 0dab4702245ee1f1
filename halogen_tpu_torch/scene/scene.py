"""Scene registry and tensor packing (PyTorch port of
`halogen_tpu/scene/scene.py`).

`build()` flattens the registered spheres and meshes into a `SceneData`:
materials deduplicated by value (`PackMaterialToList`,
HalogenRenderPass.cs:524-537), a BVH per mesh (which reorders the mesh's
triangles), triangles and BVH nodes concatenated with per-mesh offsets,
world-space triangle copies for the brute-force intersector, the world
BVH over every world-space triangle for the traversal kernels, the light
table of the emitters (`scene/lights.py`, indexed by global triangle id,
the ids the kernels' hits report through `WorldBVH.tri_map`), and the
envmap's mips and alias tables. It builds on the card unless the caller
asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from halogen_tpu_torch.accel.bvh import MAX_DEPTH, MAX_LEAF_TRIS, build_bvh
from halogen_tpu_torch.core.types import (
    MaterialTable,
    SceneData,
    WorldBVH,
    target_device,
)
from halogen_tpu_torch.scene.envmap import Envmap, build_env_cdf
from halogen_tpu_torch.scene.lights import build_light_table
from halogen_tpu_torch.scene.material import Material

WALK_COUNT_BITS = 8  # csrc/bvh_traverse.cuh kCountBits


@dataclasses.dataclass
class MeshEntry:
    tri_verts: np.ndarray  # [T, 3, 3] local space
    tri_normals: np.ndarray  # [T, 3, 3] local space
    transform: np.ndarray  # [4, 4] local->world
    material: Material
    max_depth: int = MAX_DEPTH


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
        max_depth: int = MAX_DEPTH,
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
                      np.asarray(transform, np.float32), material, max_depth)
        )
        return len(self.meshes) - 1

    def build(self, envmap: Optional[Envmap] = None,
              max_leaf: int = MAX_LEAF_TRIS, device="cuda") -> SceneData:
        """Pack the scene on `device` (the card unless the caller asks
        for the CPU), with the world BVH of any scene that has
        triangles."""
        if envmap is not None and not isinstance(envmap, Envmap):
            raise TypeError(f"envmap must be an Envmap, not {type(envmap)}")
        device = target_device(device)
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

        # Meshes: build BVHs (reorders triangles), then concatenate
        tv_local, tn_local, tv_world, tn_world = [], [], [], []
        tri_mat, tri_mesh = [], []
        bvh_lo, bvh_hi, bvh_ia, bvh_ct = [], [], [], []
        m_tri_off, m_bvh_off, m_mat, m_w2l, m_l2w = [], [], [], [], []
        tri_cursor = node_cursor = 0
        for mi, m in enumerate(self.meshes):
            bvh = build_bvh(m.tri_verts.copy(), max_leaf=max_leaf,
                            max_depth=m.max_depth)
            verts = m.tri_verts[bvh.tri_order]
            norms = m.tri_normals[bvh.tri_order]
            mat_idx = material_index(m.material)

            l2w = m.transform
            w2l = np.linalg.inv(l2w).astype(np.float32)
            # points by L2W, normals by inverse-transpose (rows of W2L),
            # unnormalized (normalized after barycentric interpolation,
            # HalgoenCompute.compute:463-467)
            vw = verts @ l2w[:3, :3].T + l2w[:3, 3]
            nw = norms @ w2l[:3, :3]

            t = verts.shape[0]
            tv_local.append(verts)
            tn_local.append(norms)
            tv_world.append(vw.astype(np.float32))
            tn_world.append(nw.astype(np.float32))
            tri_mat.append(np.full(t, mat_idx, np.int32))
            tri_mesh.append(np.full(t, mi, np.int32))
            bvh_lo.append(bvh.lo)
            bvh_hi.append(bvh.hi)
            bvh_ia.append(bvh.index_a)
            bvh_ct.append(bvh.count)
            m_tri_off.append(tri_cursor)
            m_bvh_off.append(node_cursor)
            m_mat.append(mat_idx)
            m_w2l.append(w2l)
            m_l2w.append(l2w)
            tri_cursor += t
            node_cursor += bvh.num_nodes

        def cat(parts, empty_shape, dtype=np.float32):
            if parts:
                return np.concatenate(parts).astype(dtype)
            return np.zeros(empty_shape, dtype)

        def stack44(parts):
            return np.stack(parts) if parts else np.zeros((0, 4, 4), np.float32)

        tv_world_cat = cat(tv_world, (0, 3, 3))
        tn_world_cat = cat(tn_world, (0, 3, 3))
        tri_mat_cat = cat(tri_mat, (0,), np.int32)
        mat_table = _pack_materials(materials, device)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        env_mips, env_cdf = (), None
        if envmap is not None:
            env_mips = tuple(t(m) for m in envmap.mips)
            env_cdf = build_env_cdf(envmap.mips[0], device)
        wbvh = None
        if tv_world_cat.shape[0] > 0:
            wbvh = pack_world_bvh(tv_world_cat, tn_world_cat, tri_mat_cat,
                                  max_leaf, device)
        lights, tri_light_pdf, sphere_light_sel = build_light_table(
            tv_world_cat, tri_mat_cat, s_center, s_radius, s_mat,
            mat_table.emissive.cpu().numpy(), device)
        return SceneData(
            tri_verts_world=t(tv_world_cat),
            tri_normals_world=t(tn_world_cat),
            tri_material=t(tri_mat_cat),
            tri_mesh=t(cat(tri_mesh, (0,), np.int32)),
            tri_verts_local=t(cat(tv_local, (0, 3, 3))),
            tri_normals_local=t(cat(tn_local, (0, 3, 3))),
            bvh_lo=t(cat(bvh_lo, (0, 3))),
            bvh_hi=t(cat(bvh_hi, (0, 3))),
            bvh_index_a=t(cat(bvh_ia, (0,), np.int32)),
            bvh_count=t(cat(bvh_ct, (0,), np.int32)),
            mesh_tri_offset=t(np.asarray(m_tri_off, np.int32)),
            mesh_bvh_offset=t(np.asarray(m_bvh_off, np.int32)),
            mesh_material=t(np.asarray(m_mat, np.int32)),
            mesh_world_to_local=t(stack44(m_w2l)),
            mesh_local_to_world=t(stack44(m_l2w)),
            sphere_center=t(s_center),
            sphere_radius=t(s_radius),
            sphere_material=t(s_mat),
            materials=mat_table,
            env_mips=env_mips,
            env_cdf=env_cdf,
            # any material that can refract (transmission alpha < 1)?
            any_transmissive=bool(mat_table.albedo[:, 3].min().item() < 1.0),
            wbvh=wbvh,
            lights=lights,
            tri_light_pdf_area=tri_light_pdf,
            sphere_light_sel=sphere_light_sel,
        )


def pack_world_bvh(tri_verts_world: np.ndarray, tri_normals_world: np.ndarray,
                   tri_material: np.ndarray, max_leaf: int = MAX_LEAF_TRIS,
                   device="cuda") -> WorldBVH:
    """The world BVH over [T, 3, 3] world-space triangles, built by the
    same `build_bvh` call as the JAX package's `pack_world_bvh`
    (`kernels/bvh_pallas.py:96-111`), so its nodes, slots and `tri_map`
    equal the JAX package's; laid out for the port's kernels (see
    `WorldBVH`) instead of the TPU's [R, 128] rows. Raises ValueError
    where a node does not fit the walk's 32-bit stack entry
    (`_check_walk_packing`)."""
    tv = np.asarray(tri_verts_world, np.float32)
    bvh = build_bvh(tv.copy(), max_leaf=max_leaf, max_depth=MAX_DEPTH)
    _check_walk_packing(bvh.index_a, bvh.count)
    order = bvh.tri_order
    nodes = np.concatenate(
        [bvh.lo, bvh.hi, bvh.index_a[:, None].astype(np.float32),
         bvh.count[:, None].astype(np.float32)], axis=1)
    v = tv[order]
    n = np.asarray(tri_normals_world, np.float32)[order]
    # rows of 12 floats (three 16-byte loads in the walk): v0, e1, e2, 0
    tris = np.concatenate([v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0],
                           np.zeros((len(v), 3), np.float32)], axis=1)
    trin = np.concatenate(
        [n[:, 0], n[:, 1] - n[:, 0], n[:, 2] - n[:, 0],
         np.asarray(tri_material, np.float32)[order][:, None]], axis=1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return WorldBVH(nodes=t(nodes.astype(np.float32)),
                    tris=t(tris.astype(np.float32)),
                    trin=t(trin.astype(np.float32)),
                    tri_map=t(order.astype(np.int32)))


def _check_walk_packing(index_a: np.ndarray, count: np.ndarray) -> None:
    """The world-BVH walk (`csrc/bvh_traverse.cuh`) keeps a stack entry as
    one 32-bit word, index_a << WALK_COUNT_BITS | count: a leaf's triangle
    count must fit WALK_COUNT_BITS bits and every index_a the other bits."""
    max_count = (1 << WALK_COUNT_BITS) - 1
    max_index = (1 << (32 - WALK_COUNT_BITS)) - 1
    if count.size and int(count.max()) > max_count:
        raise ValueError(
            f"a leaf of the world BVH holds {int(count.max())} triangles; "
            f"the walk's stack entry packs at most {max_count} (a leaf this "
            "large is left only where the build's depth ran out)")
    if index_a.size and int(index_a.max()) > max_index:
        raise ValueError(
            f"a world-BVH index {int(index_a.max())} exceeds the walk's "
            f"stack entry, which packs at most {max_index}")


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
