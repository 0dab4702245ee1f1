"""Seeded closest hit over the world BVH: one CUDA launch per ray batch
(port of `halogen_tpu/kernels/bvh_pallas.py`, B3, which also serves the
treelet, flatlet and raylet kernels B4-B6 of the same contract).

The kernel is hand-written CUDA C++ for Hopper (`csrc/traverse.cu`, the
walk in `csrc/bvh_traverse.cuh` that the megakernel's BVH tier shares),
built by `megakernel.load_library` with the other kernels. One thread per
ray walks the tree with its own stack; the TPU's shared stack per
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
triangle tested, no box). A CUDA launch that fails raises; there is no
fallback. `LAUNCHES` counts launches; every world-BVH `Intersector`
(PALLAS for B3, TREELET, FLATLET and RAYLET for the routes of B4-B6)
reaches this one kernel.
"""

from __future__ import annotations

import torch

from halogen_tpu_torch.core.math import HIT_EPS, INF
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
            or wbvh.tris.shape != (t, 9) or wbvh.tri_map.shape != (t,)):
        raise ValueError("the world BVH must be nodes [Nn, 8], tris [T, 9] "
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
    if wbvh.nodes.data_ptr() % 16:
        raise ValueError("the BVH nodes must be 16-byte aligned")
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
    slot order on ties) with the kernel's seed rule and outputs."""
    n = origin.shape[0]
    t, slot, u, v, s = closest_tris(origin, direction, wbvh.tris, seed)
    hit = t < INF
    tri = torch.where(hit, wbvh.tri_map[slot].to(torch.int32), -1)
    tests = torch.full((n,), wbvh.tris.shape[0], dtype=torch.int32,
                       device=origin.device)
    walked = seed > HIT_EPS  # the kernel walks only these rays
    return (t, tri, u, v, s, torch.where(walked, tests, 0),
            torch.zeros_like(tests))


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
