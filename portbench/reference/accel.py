"""The reference's closest-hit search over triangles: a bounding-volume
hierarchy of its own (median splits, built with numpy), searched
breadth-first over (ray, node) pairs on the device.

It returns what a brute-force scan of every triangle returns: the
smallest Möller-Trumbore t above HIT_EPS and below the ray's limit, the
lowest triangle index on a tie. The hierarchy only prunes: its boxes are
padded so that rounding in the slab test never drops a triangle, a box is
left only where it starts beyond the best t found so far, and every
candidate is decided by the same triangle test a scan would run.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import HIT_EPS, INF, triangle_intersect_soa

LEAF = 4
BRUTE_MAX = 64  # scenes up to this many triangles are scanned whole


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(d) < 1e-30, 1e-30, d)


def _slab(lo, hi, o, inv):
    """[P] entry distance (>= 0) of each ray into its box, +inf on a
    miss; rays touching a box count as hits."""
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    tmin = torch.minimum(t1, t2).amax(dim=1)
    tmax = torch.maximum(t1, t2).amin(dim=1)
    tmin = torch.clamp_min(tmin, 0.0)
    return torch.where(tmax >= tmin, tmin, INF)


class TriangleAccel:
    """Median-split hierarchy over [T, 3, 3] world triangles."""

    def __init__(self, tri_verts: np.ndarray, device):
        tv = np.asarray(tri_verts, np.float64)
        n = tv.shape[0]
        tlo, thi = tv.min(axis=1), tv.max(axis=1)
        cent = 0.5 * (tlo + thi)
        order = np.arange(n)
        cap = 2 * n + 1
        lo = np.zeros((cap, 3))
        hi = np.zeros((cap, 3))
        left = np.full(cap, -1, np.int64)
        start = np.zeros(cap, np.int64)
        count = np.zeros(cap, np.int64)
        used = 1
        work = [(0, 0, n)]
        while work:
            node, s, e = work.pop()
            idx = order[s:e]
            lo[node], hi[node] = tlo[idx].min(axis=0), thi[idx].max(axis=0)
            if e - s <= LEAF:
                start[node], count[node] = s, e - s
                continue
            c = cent[idx]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            mid = (e - s) // 2
            order[s:e] = idx[np.argpartition(c[:, axis], mid)]
            left[node] = used
            work += [(used, s, s + mid), (used + 1, s + mid, e)]
            used += 2
        # pad every box so rounding in the slab test cannot drop a hit
        pad = 1e-5 * (1.0 + np.abs(tv).max())
        t = lambda a, dt=torch.float32: torch.as_tensor(
            np.ascontiguousarray(a[:used]), dtype=dt, device=device)
        self.lo, self.hi = t(lo - pad), t(hi + pad)
        self.left, self.start, self.count = (t(left, torch.int64),
                                             t(start, torch.int64),
                                             t(count, torch.int64))
        self.order = torch.as_tensor(order, device=device)
        v0 = tv[:, 0].astype(np.float32)
        e1 = tri_verts[:, 1] - tri_verts[:, 0]
        e2 = tri_verts[:, 2] - tri_verts[:, 0]
        self.comps = torch.as_tensor(
            np.concatenate([v0, e1, e2], axis=1).astype(np.float32),
            device=device)  # [T, 9]: v0, e1, e2, as the scan reads them
        self.num_nodes = used

    def _test(self, o, d, ray, tri, limit):
        """Möller-Trumbore of (ray, triangle) pairs: t where it hits above
        HIT_EPS and below the ray's limit, else +inf."""
        c = self.comps[tri]
        oo, dd = o[ray], d[ray]
        t, _, _, _ = triangle_intersect_soa(
            (oo[:, 0], oo[:, 1], oo[:, 2]), (dd[:, 0], dd[:, 1], dd[:, 2]),
            (c[:, 0], c[:, 1], c[:, 2]), (c[:, 3], c[:, 4], c[:, 5]),
            (c[:, 6], c[:, 7], c[:, 8]))
        return torch.where((t > HIT_EPS) & (t < limit[ray]), t, INF)

    def _leaf_pairs(self, ray, node):
        """(ray, triangle) pairs of the leaves `node` [P]."""
        cnt = self.count[node]
        rep = torch.repeat_interleave(torch.arange(ray.shape[0],
                                                   device=ray.device), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        k = torch.arange(rep.shape[0], device=ray.device) - first[rep]
        return ray[rep], self.order[self.start[node][rep] + k]

    def closest(self, o, d, limit, chunk: int = 1 << 17):
        """(t [N], triangle [N]) of the closest hit below `limit` [N];
        t = +inf and triangle = -1 where there is none. A scene of a few
        triangles is scanned whole."""
        if self.comps.shape[0] <= BRUTE_MAX:
            return self._scan(o, d, limit)
        outs = [self._closest(o[s:s + chunk], d[s:s + chunk],
                              limit[s:s + chunk])
                for s in range(0, o.shape[0], chunk)]
        return (torch.cat([a for a, _ in outs]),
                torch.cat([b for _, b in outs]))

    def _scan(self, o, d, limit):
        c = self.comps.T[:, :, None]  # [9, T, 1]
        t, _, _, _ = triangle_intersect_soa(
            tuple(o[None, :, k] for k in range(3)),
            tuple(d[None, :, k] for k in range(3)),
            (c[0], c[1], c[2]), (c[3], c[4], c[5]), (c[6], c[7], c[8]))
        t = torch.where((t > HIT_EPS) & (t < limit[None, :]), t, INF)
        best, tri = torch.min(t, dim=0)  # the first minimum on a tie
        return best, torch.where(best < INF, tri, -1)

    def _closest(self, o, d, limit):
        n, dev = o.shape[0], o.device
        inv = _safe_inv(d)
        best = torch.full((n,), INF, device=dev)
        cand_ray, cand_t, cand_tri = [], [], []

        def record(ray, tri):
            t = self._test(o, d, ray, tri, limit)
            hit = t < INF
            ray, t, tri = ray[hit], t[hit], tri[hit]
            best.scatter_reduce_(0, ray, t, "amin")
            cand_ray.append(ray)
            cand_t.append(t)
            cand_tri.append(tri)

        # a first bound: each ray walks down to its nearest-entered leaf
        ray = torch.arange(n, device=dev)
        node = torch.zeros(n, dtype=torch.int64, device=dev)
        while ray.numel():
            inner = self.count[node] == 0
            leaf_ray, leaf_node = ray[~inner], node[~inner]
            record(*self._leaf_pairs(leaf_ray, leaf_node))
            ray, node = ray[inner], node[inner]
            a = self.left[node]
            ta = _slab(self.lo[a], self.hi[a], o[ray], inv[ray])
            tb = _slab(self.lo[a + 1], self.hi[a + 1], o[ray], inv[ray])
            go = torch.minimum(ta, tb) < INF
            ray, node = ray[go], torch.where(ta <= tb, a, a + 1)[go]
        # then every box that starts before the best hit so far
        ray = torch.arange(n, device=dev)
        node = torch.zeros(n, dtype=torch.int64, device=dev)
        while ray.numel():
            tmin = _slab(self.lo[node], self.hi[node], o[ray], inv[ray])
            keep = (tmin < INF) & (tmin <= torch.minimum(best, limit)[ray])
            ray, node = ray[keep], node[keep]
            inner = self.count[node] == 0
            record(*self._leaf_pairs(ray[~inner], node[~inner]))
            ray, node = ray[inner], self.left[node[inner]]
            ray, node = torch.cat([ray, ray]), torch.cat([node, node + 1])
        ray, t, tri = (torch.cat(cand_ray), torch.cat(cand_t),
                       torch.cat(cand_tri))
        at_best = t == best[ray]
        win = torch.full((n,), self.comps.shape[0], dtype=torch.int64,
                         device=dev)
        win.scatter_reduce_(0, ray[at_best], tri[at_best], "amin")
        return best, torch.where(best < INF, win, -1)
