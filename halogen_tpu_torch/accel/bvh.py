"""Host-side (numpy) per-mesh BVH builder (port of `halogen_tpu/accel/bvh.py`).

The reference's C# builder (`Assets/Scripts/BVHGenerator.cs:13-134`):
binary BVH, midpoint split on the longest AABB axis, breadth-first
construction, in-place partition of the triangle order, children stored
contiguously (childB = childA + 1), node = (aabb_lo, aabb_hi, index_a,
tri_count) with tri_count > 0 marking a leaf (`HalogenRenderPass.cs:68-76`).
Like the JAX package it bounds the leaves (a failed midpoint split falls
back to a median split) and vectorizes the build with numpy.

`build_bvh(method="auto")` is the native binned-SAH builder
(`accel/native_loader.py`), as in the JAX package; unlike it, the port's
"auto" never falls back to the midpoint builder when the native build
fails: the two give different triangle orders, so a silent fallback would
change every triangle id of the scene. It raises instead.
`method="midpoint"` is the numpy builder, for an explicit caller.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_LEAF_TRIS = 5  # BVHGenerator.cs:8 maxNodeTriangleCount
MAX_DEPTH = 32  # RayTracingMesh.cs:16 MaxHierarchyDepth default
AABB_EPS = 1e-5  # RayTracingMesh.cs:11 AABBEpsilon


@dataclasses.dataclass
class BVH:
    """Flat node arrays + the triangle permutation applied during build."""

    lo: np.ndarray  # [B, 3] float32
    hi: np.ndarray  # [B, 3] float32
    index_a: np.ndarray  # [B] int32: first tri (leaf) or first child (inner)
    count: np.ndarray  # [B] int32: leaf tri count, 0 for inner nodes
    tri_order: np.ndarray  # [T] int32 permutation old->new triangle order
    depth: int
    max_leaf: int

    @property
    def num_nodes(self) -> int:
        return self.lo.shape[0]


def _bounds(verts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """AABB of [K, 3, 3] triangles with the min-size epsilon for thin
    geometry (BVHGenerator.cs:180-183)."""
    pts = verts.reshape(-1, 3)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    if np.any(hi - lo < AABB_EPS):
        hi = hi + AABB_EPS
    return lo.astype(np.float32), hi.astype(np.float32)


def build_bvh(
    tri_verts: np.ndarray,
    max_leaf: int = MAX_LEAF_TRIS,
    max_depth: int = MAX_DEPTH,
    method: str = "auto",
) -> BVH:
    """Build a BVH over [T, 3, 3] local-space triangle vertices.

    Returns flat node arrays whose child/triangle indices are LOCAL to this
    mesh (the scene build concatenates meshes with offsets, mirroring
    `HalogenRenderPass.cs:475-494`).

    method: "auto" or "sah" (the native binned-SAH builder; raises if it
    cannot be built or loaded), or "midpoint" (numpy). Both produce the
    same node layout and invariants (leaves <= max_leaf unless depth runs
    out, contiguous children).
    """
    if method in ("auto", "sah"):
        from halogen_tpu_torch.accel import native_loader

        lo, hi, index_a, count, order, depth = native_loader.build_bvh_sah(
            np.asarray(tri_verts, np.float32), max_leaf, max_depth)
        return BVH(lo, hi, index_a, count, order, depth, max_leaf)
    if method != "midpoint":
        raise ValueError(f"unknown BVH build method {method!r}")
    tri_verts = np.asarray(tri_verts, dtype=np.float32)
    n_tris = tri_verts.shape[0]
    order = np.arange(n_tris, dtype=np.int32)

    if n_tris == 0:
        z = np.zeros((1, 3), np.float32)
        return BVH(z, z, np.zeros(1, np.int32), np.zeros(1, np.int32),
                   order, 0, max_leaf)

    centroids = tri_verts.mean(axis=1)  # [T, 3]

    lo0, hi0 = _bounds(tri_verts)
    nodes_lo = [lo0]
    nodes_hi = [hi0]
    nodes_index = [0]
    nodes_count = [n_tris]

    # Breadth-first frontier of (node_id, start, count), like the reference's
    # per-depth processing queues (BVHGenerator.cs:40-129).
    frontier = [(0, 0, n_tris)]
    depth_used = 0

    for _depth in range(1, max_depth + 1):
        if not frontier:
            break
        depth_used += 1
        next_frontier = []
        for node_id, start, count in frontier:
            if count <= max_leaf:
                continue  # stays a leaf
            seg = slice(start, start + count)
            seg_cent = centroids[seg]
            size = nodes_hi[node_id] - nodes_lo[node_id]
            axis = int(np.argmax(size))
            split = nodes_lo[node_id][axis] + size[axis] * 0.5

            left_mask = seg_cent[:, axis] < split
            n_left = int(left_mask.sum())
            if n_left == 0 or n_left == count:
                # Midpoint failed: median split (the reference gives up and
                # keeps an oversized leaf, BVHGenerator.cs:86-91).
                n_left = count // 2
                part = np.argpartition(seg_cent[:, axis], n_left - 1)
            else:
                part = np.argsort(~left_mask, kind="stable")

            # Apply the in-place partition to this segment's ordering
            perm = np.arange(count)[part]
            order[seg] = order[seg][perm]
            centroids[seg] = seg_cent[perm]
            tri_verts[seg] = tri_verts[seg][perm]

            # Children, contiguous so childB = childA + 1
            child_a = len(nodes_lo)
            la, ha = _bounds(tri_verts[start : start + n_left])
            nodes_lo.append(la)
            nodes_hi.append(ha)
            nodes_index.append(start)
            nodes_count.append(n_left)

            lb, hb = _bounds(tri_verts[start + n_left : start + count])
            nodes_lo.append(lb)
            nodes_hi.append(hb)
            nodes_index.append(start + n_left)
            nodes_count.append(count - n_left)

            # Promote current node to inner
            nodes_index[node_id] = child_a
            nodes_count[node_id] = 0

            if n_left > 2:  # reference skips splitting <=2-tri nodes
                next_frontier.append((child_a, start, n_left))
            if count - n_left > 2:
                next_frontier.append((child_a + 1, start + n_left, count - n_left))
        frontier = next_frontier

    return BVH(
        lo=np.stack(nodes_lo).astype(np.float32),
        hi=np.stack(nodes_hi).astype(np.float32),
        index_a=np.asarray(nodes_index, dtype=np.int32),
        count=np.asarray(nodes_count, dtype=np.int32),
        tri_order=order,
        depth=depth_used,
        max_leaf=max_leaf,
    )


def bvh_stats(bvh: BVH) -> dict:
    """Build statistics (the reference's LogBVHCreation,
    BVHGenerator.cs:131-133: split failures, depth, leaf occupancy)."""
    leaf = bvh.count > 0
    counts = bvh.count[leaf]
    return {
        "nodes": int(bvh.num_nodes),
        "leaves": int(leaf.sum()),
        "depth": int(bvh.depth),
        "min_leaf": int(counts.min()) if counts.size else 0,
        "max_leaf": int(counts.max()) if counts.size else 0,
        "mean_leaf": float(counts.mean()) if counts.size else 0.0,
        "oversized_leaves": int((counts > bvh.max_leaf).sum()),
    }


def validate_bvh(bvh: BVH, tri_verts: np.ndarray) -> list[str]:
    """Structural invariant checks (the build-stat/debug counterpart of
    `BVHGenerator.cs:131-133`): every triangle in exactly one leaf; child
    AABBs within parent (up to the thin-geometry epsilon); contiguous
    children. Returns a list of violation strings (empty = valid)."""
    errors = []
    covered = np.zeros(tri_verts.shape[0], dtype=np.int32)
    for i in range(bvh.num_nodes):
        if bvh.count[i] > 0:
            covered[bvh.index_a[i] : bvh.index_a[i] + bvh.count[i]] += 1
        else:
            a = bvh.index_a[i]
            for c in (a, a + 1):
                if c >= bvh.num_nodes:
                    errors.append(f"node {i}: child {c} out of range")
                    continue
                if np.any(bvh.lo[c] < bvh.lo[i] - AABB_EPS * 2) or np.any(
                    bvh.hi[c] > bvh.hi[i] + AABB_EPS * 2
                ):
                    errors.append(f"node {i}: child {c} AABB escapes parent")
    if tri_verts.shape[0] and not np.all(covered == 1):
        bad = np.nonzero(covered != 1)[0]
        errors.append(f"triangles covered != once: {bad[:8]}")
    return errors
