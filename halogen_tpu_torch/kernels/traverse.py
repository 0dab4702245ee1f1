"""Seeded closest hit over the world BVH: one CUDA launch per ray batch
(port of `halogen_tpu/kernels/bvh_pallas.py`, B3, which also serves the
treelet, flatlet and raylet kernels B4-B6 of the same contract).

The kernel is hand-written CUDA C++ for Hopper (`csrc/traverse.cu`, the
walk in `csrc/bvh_traverse.cuh` that the megakernel's BVH tier shares),
built by `megakernel.load_library` with the other kernels. One thread per
ray walks the tree with its own stack ("while-while": inner nodes until
the lane holds a leaf, then the leaf; near child first; triangle rows of
`WorldBVH.tris` read as three 16-byte loads); the TPU's shared stack per
1024-ray block, its [R, 128] node rows, and the treelet, flatlet and
raylet layouts were answers to the TPU's vector unit and VMEM and have
no counterpart here.

Contract (`traverse_world_bvh_any`, `bvh_pallas.py:320-388, 421-465`):
rays [N, 3] and a best-t seed [N] in; (t, tri, u, v, sign, tri_tests,
box_tests) out. A hit needs HIT_EPS < t < seed, so a ray seeded below
HIT_EPS (seed < 0 marks a dead lane) hits nothing. `tri` is the global
triangle id (through `WorldBVH.tri_map`). A miss gives t = +inf, tri =
-1 and u = v = sign = 0 (the Pallas kernel returned slot 0's id, u = v =
0 and sign 1 there; every caller reads a miss by its t).

`traverse_world` takes rays on a CUDA device to the kernel and rays on
the CPU to the plain PyTorch version, `traverse_world_reference`: a
chunked brute force over the same triangles with the same seed rule,
independent of the tree (its counters are the brute force's: every
triangle tested, no box). The kernel's own counts have a plain version
too, `traverse_world_walk_reference`: the walk of `csrc/bvh_traverse.cuh`
step for step in PyTorch, on either device, which the debug views' CPU
route takes. A CUDA launch that fails raises; there is no fallback. `LAUNCHES` counts launches; every world-BVH `Intersector`
(PALLAS for B3, TREELET, FLATLET and RAYLET for the routes of B4-B6)
reaches this one kernel.
"""

from __future__ import annotations

import torch

from halogen_tpu_torch.core.math import HIT_EPS, INF, triangle_intersect_soa
from halogen_tpu_torch.core.types import WorldBVH
from halogen_tpu_torch.integrator.intersect import closest_tris
from halogen_tpu_torch.kernels import megakernel as mk

LAUNCHES = 0  # kernel launches since the count was last set to 0


def _check(wbvh: WorldBVH, origin, direction, seed, dev) -> int:
    n = origin.shape[0]
    if origin.shape != (n, 3) or direction.shape != (n, 3):
        raise ValueError("origin and direction must be [N, 3]")
    if seed.shape != (n,):
        raise ValueError("seed must be [N]")
    t = wbvh.tris.shape[0]
    if (wbvh.nodes.ndim != 2 or wbvh.nodes.shape[1] != 8
            or wbvh.tris.shape != (t, 12) or wbvh.tri_map.shape != (t,)):
        raise ValueError("the world BVH must be nodes [Nn, 8], tris [T, 12] "
                         "and tri_map [T]")
    for name, t in (("origin", origin), ("direction", direction),
                    ("seed", seed), ("nodes", wbvh.nodes),
                    ("tris", wbvh.tris)):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"{name} must be contiguous float32 on {dev}")
    if (wbvh.tri_map.dtype != torch.int32 or wbvh.tri_map.device != dev
            or not wbvh.tri_map.is_contiguous()):
        raise ValueError(f"tri_map must be contiguous int32 on {dev}")
    if wbvh.nodes.data_ptr() % 16 or wbvh.tris.data_ptr() % 16:
        raise ValueError("the BVH nodes and triangles must be 16-byte "
                         "aligned")
    return n


def _launch(wbvh: WorldBVH, origin, direction, seed):
    global LAUNCHES
    dev = origin.device
    n = _check(wbvh, origin, direction, seed, dev)
    f = lambda: torch.empty((n,), dtype=torch.float32, device=dev)
    i = lambda: torch.empty((n,), dtype=torch.int32, device=dev)
    t, tri, u, v, s, tt, bt = f(), i(), f(), f(), f(), i(), i()
    lib = mk.load_library("traverse")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.halogen_traverse_launch(
            origin.data_ptr(), direction.data_ptr(), seed.data_ptr(),
            wbvh.nodes.data_ptr(), wbvh.tris.data_ptr(),
            wbvh.tri_map.data_ptr(), t.data_ptr(), tri.data_ptr(),
            u.data_ptr(), v.data_ptr(), s.data_ptr(), tt.data_ptr(),
            bt.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"traversal launch failed: CUDA error {err}")
    LAUNCHES += 1
    return t, tri, u, v, s, tt, bt


def traverse_world_reference(wbvh: WorldBVH, origin: torch.Tensor,
                             direction: torch.Tensor, seed: torch.Tensor):
    """Plain PyTorch version of the kernel: the brute force over the world
    BVH's triangles (`integrator.intersect.closest_tris`, first minimum in
    slot order on ties; the 9 values of each 12-float row) with the
    kernel's seed rule and outputs."""
    n = origin.shape[0]
    t, slot, u, v, s = closest_tris(origin, direction, wbvh.tris[:, :9],
                                    seed)
    hit = t < INF
    tri = torch.where(hit, wbvh.tri_map[slot].to(torch.int32), -1)
    tests = torch.full((n,), wbvh.tris.shape[0], dtype=torch.int32,
                       device=origin.device)
    walked = seed > HIT_EPS  # the kernel walks only these rays
    return (t, tri, u, v, s, torch.where(walked, tests, 0),
            torch.zeros_like(tests))


_STACK = 64  # bvh_traverse.cuh kBvhStack


def _node_entry(lo, hi, o, inv_d, limit):
    """`node_entry`: the slab test's entry distance, or +inf where the ray
    misses the box or enters it at or past `limit` ([n] each; lo, hi,
    o, inv_d [n, 3])."""
    t1, t2 = (lo - o) * inv_d, (hi - o) * inv_d
    mn, mx = torch.minimum(t1, t2), torch.maximum(t1, t2)
    tmin = torch.maximum(torch.maximum(mn[:, 0], mn[:, 1]), mn[:, 2])
    tmax = torch.minimum(torch.minimum(mx[:, 0], mx[:, 1]), mx[:, 2])
    ok = (tmax > torch.clamp_min(tmin, 0.0)) & (tmin < limit)
    return torch.where(ok, tmin, INF)


def traverse_world_walk_reference(wbvh: WorldBVH, origin: torch.Tensor,
                                  direction: torch.Tensor,
                                  seed: torch.Tensor):
    """Plain PyTorch version of the kernel's walk (`bvh_walk<false, true>`
    of `csrc/bvh_traverse.cuh`), on the inputs' device, with the kernel's
    outputs: every ray with seed > HIT_EPS takes the kernel's steps in
    its order, so it makes the same triangle and box tests and keeps the
    same hit. A step takes each unfinished ray one node further (the
    while-while loop visits the nodes one at a time): at an inner node
    both children's boxes are tested against the best t so far (2 box
    tests), the near child that the ray enters is visited next and the
    far one, where it is entered too, pushed (a push past 64 entries is
    dropped); where neither is entered the stack is popped. At a leaf
    every triangle is tested in slot order (count triangle tests), a hit
    with HIT_EPS < t < best t replacing the best, then the stack is
    popped. The walk ends where the stack is empty. The float operations
    are the kernel's (`triangle_intersect_soa` is `triangle_hit`'s, the
    slab test `node_entry`'s), so on the card it gives the kernel's bits.
    """
    n = origin.shape[0]
    dev = origin.device
    nodes = wbvh.nodes
    lo, hi = nodes[:, 0:3], nodes[:, 3:6]
    node_ia, node_ct = nodes[:, 6].to(torch.int64), nodes[:, 7].to(
        torch.int64)
    tris = wbvh.tris
    inv_d = 1.0 / torch.where(torch.abs(direction) < 1e-30, 1e-30,
                              direction)
    best = seed.clone()
    slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    u, v, s = (torch.zeros((n,), device=dev) for _ in range(3))
    tri_tests = torch.zeros((n,), dtype=torch.int32, device=dev)
    box_tests = torch.zeros((n,), dtype=torch.int32, device=dev)
    stack = torch.zeros((n, _STACK), dtype=torch.int64, device=dev)
    sp = torch.zeros((n,), dtype=torch.int64, device=dev)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)  # the root
    live = torch.nonzero(seed > HIT_EPS)[:, 0]
    while live.numel():
        nd = node[live]
        leaf = node_ct[nd] > 0
        done = torch.zeros_like(leaf)
        # ---- inner nodes: children index_a and index_a + 1
        ri, ni = live[~leaf], nd[~leaf]
        if ri.numel():
            ca = node_ia[ni]
            o, idv, lim = origin[ri], inv_d[ri], best[ri]
            ea = _node_entry(lo[ca], hi[ca], o, idv, lim)
            eb = _node_entry(lo[ca + 1], hi[ca + 1], o, idv, lim)
            box_tests[ri] += 2
            a_first = ea <= eb
            e_near = torch.where(a_first, ea, eb)
            e_far = torch.where(a_first, eb, ea)
            near = torch.where(a_first, ca, ca + 1)
            far = torch.where(a_first, ca + 1, ca)
            spi = sp[ri]
            enter = e_near < INF
            push = enter & (e_far < INF) & (spi < _STACK)
            stack[ri[push], spi[push]] = far[push]
            spi = spi + push.to(torch.int64)
            pop = ~enter & (spi > 0)
            spi = spi - pop.to(torch.int64)
            popped = stack[ri, torch.clamp_min(spi, 0)]
            node[ri] = torch.where(enter, near, popped)
            sp[ri] = spi
            done[~leaf] = ~enter & ~pop
        # ---- leaves: triangles index_a .. index_a + count - 1
        rl, nl = live[leaf], nd[leaf]
        if rl.numel():
            ia, ct = node_ia[nl], node_ct[nl]
            tri_tests[rl] += ct.to(torch.int32)
            o, d = origin[rl], direction[rl]
            oc = (o[:, 0], o[:, 1], o[:, 2])
            dc = (d[:, 0], d[:, 1], d[:, 2])
            bt, bs = best[rl], slot[rl]
            bu, bv, bsg = u[rl], v[rl], s[rl]
            for k in range(int(ct.max())):
                do = k < ct
                row = tris[torch.where(do, ia + k, 0)]
                t, uk, vk, sg = triangle_intersect_soa(
                    oc, dc, (row[:, 0], row[:, 1], row[:, 2]),
                    (row[:, 3], row[:, 4], row[:, 5]),
                    (row[:, 6], row[:, 7], row[:, 8]))
                ok = do & (t > HIT_EPS) & (t < bt)
                bt = torch.where(ok, t, bt)
                bs = torch.where(ok, ia + k, bs)
                bu, bv = torch.where(ok, uk, bu), torch.where(ok, vk, bv)
                bsg = torch.where(ok, sg, bsg)
            best[rl], slot[rl], u[rl], v[rl], s[rl] = bt, bs, bu, bv, bsg
            spl = sp[rl]
            more = spl > 0
            spl = spl - more.to(torch.int64)
            node[rl] = torch.where(more, stack[rl, torch.clamp_min(spl, 0)],
                                   nl)
            sp[rl] = spl
            done[leaf] = ~more
        live = live[~done]
    hit = slot >= 0
    tri = torch.where(hit, wbvh.tri_map[torch.clamp_min(slot, 0)], -1)
    return (torch.where(hit, best, INF), tri.to(torch.int32),
            torch.where(hit, u, 0.0), torch.where(hit, v, 0.0),
            torch.where(hit, s, 0.0), tri_tests, box_tests)


def traverse_world(wbvh: WorldBVH, origin: torch.Tensor,
                   direction: torch.Tensor, seed: torch.Tensor):
    """(t, tri, u, v, sign, tri_tests, box_tests) of the closest hits with
    t < seed (see the module docstring): the kernel on a CUDA device, its
    plain version on the CPU."""
    if origin.device.type == "cuda":
        return _launch(wbvh, origin, direction, seed)
    if origin.device.type != "cpu":
        raise ValueError(f"no traversal kernel for device {origin.device}")
    return traverse_world_reference(wbvh, origin, direction, seed)
