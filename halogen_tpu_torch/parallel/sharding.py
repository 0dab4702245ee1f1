"""Rendering and fitting over several processes (PyTorch port of
`halogen_tpu/parallel/sharding.py`).

The JAX module is one controller over a device mesh (`shard_map`). Here
it is PyTorch's idiom: one process a card (or, on the CPU, a process
with the `gloo` backend), with collectives over `torch.distributed`
process groups. The mesh keeps the JAX axes, ("px", "spp"), the
renderer's two data axes:

- **pixel shards**: each rank renders a contiguous slab of the flat pixel
  array; the scene (triangles, BVH, materials, envmap) is replicated;
- **spp shards**: ranks render disjoint lanes of the sample index of the
  same pixels, and their images are averaged; valid because the sampler
  indexes samples as frame * spp + lane, so a sharding never changes a
  ray;
- **gradients**: each rank backpropagates its share of the MSE, and the
  parameter gradients are summed over the whole mesh.

Every sum over ranks is an `all_gather` followed by additions in rank
order on every rank, so every rank holds the same bits and a rerun
repeats them (the adjoint's fixed order of additions survives the
reduction). A collective that fails raises.

`init_distributed` forms the process group: from `torchrun`'s
environment where there is one, else a group of this process alone.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from halogen_tpu_torch.config import RenderSettings
from halogen_tpu_torch.core.types import SceneData
from halogen_tpu_torch.integrator.camera import Camera
from halogen_tpu_torch.integrator.trace import render_pixel_chunks


def init_distributed(backend: str | None = None, device="cuda",
                     **kwargs) -> bool:
    """Form the default process group (`torch.distributed.
    init_process_group(backend, **kwargs)`); True where this call formed
    it, False where it was already formed (the one benign case: every
    other error, a wrong address, a size or rank that does not fit, is
    raised, as the JAX `init_distributed` does).

    The backend is `nccl` for `device` "cuda" (the default) and `gloo` for
    "cpu", unless the caller names one. With neither an `init_method` nor
    `torchrun`'s environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
    the group is this process alone, over a free port of localhost. On
    the card each rank takes the card of its LOCAL_RANK (0 without
    torchrun)."""
    if dist.is_initialized():
        return False
    size, rank = kwargs.get("world_size", 1), kwargs.get("rank", 0)
    if not (isinstance(size, int) and isinstance(rank, int) and size >= 1
            and 0 <= rank < size):
        # torch's rendezvous would wait for ranks that never come
        raise ValueError(f"rank {rank} of a world of {size} processes")
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if "init_method" not in kwargs and "store" not in kwargs and not all(
            k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                      "MASTER_PORT")):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        kwargs = dict(init_method=f"tcp://localhost:{port}", world_size=1,
                      rank=0, **kwargs)
    dist.init_process_group(backend, **kwargs)
    return True


@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """A (px, spp) mesh over ranks `ranks` of the default group, rank
    ranks[px * n_spp + spp] at (px, spp) (the JAX mesh's reshape).
    `px_group` holds the ranks of this rank's spp lane (its pixel slabs
    are gathered over it), `spp_group` those of its pixel slab (its spp
    shards are averaged over it), `group` all of the mesh's; a group is
    None where it is the default group, and unused where its axis is 1.
    A rank outside `ranks` has px = spp = -1 and takes part in nothing."""

    n_px: int
    n_spp: int
    ranks: tuple
    px: int
    spp: int
    px_group: object
    spp_group: object
    group: object

    @property
    def shape(self) -> dict:
        return {"px": self.n_px, "spp": self.n_spp}

    @property
    def member(self) -> bool:
        return self.px >= 0


def make_render_mesh(n_pixel_shards: int | None = None,
                     n_spp_shards: int = 1,
                     ranks=None) -> RenderMesh:
    """The mesh over `ranks` (default: every rank of the default group),
    all of them on the pixel axis unless `n_spp_shards` says otherwise.
    Every rank of the default group must call it, with the same
    arguments: it forms the mesh's subgroups (`torch.distributed.
    new_group`)."""
    world = dist.get_world_size()
    ranks = tuple(range(world)) if ranks is None else tuple(ranks)
    n = len(ranks)
    if n_pixel_shards is None:
        n_pixel_shards = n // n_spp_shards
    if n_pixel_shards * n_spp_shards != n:
        raise ValueError(f"mesh {n_pixel_shards}x{n_spp_shards} != {n} ranks")
    grid = np.asarray(ranks).reshape(n_pixel_shards, n_spp_shards)
    me = dist.get_rank()
    whole = n == world

    def groups(rows):
        """One subgroup a row (each rank of the default group calls
        new_group for every row, in order); this rank's, or None."""
        mine = None
        for row in rows:
            row = [int(r) for r in row]
            g = dist.group.WORLD if len(row) == world else dist.new_group(row)
            if me in row:
                mine = None if g is dist.group.WORLD else g
        return mine

    px_group = groups(grid.T) if n_pixel_shards > 1 else None
    spp_group = groups(grid) if n_spp_shards > 1 else None
    group = None if whole else groups([grid.reshape(-1)])
    at = np.argwhere(grid == me)
    px, spp = (int(at[0][0]), int(at[0][1])) if len(at) else (-1, -1)
    return RenderMesh(n_pixel_shards, n_spp_shards, ranks, px, spp,
                      px_group, spp_group, group)


def _padded_pixels(settings: RenderSettings, n_px_shards: int) -> np.ndarray:
    """Flat pixel indices padded to a multiple of the pixel shards: pad
    lanes render pixel 0 and are dropped."""
    n_pixels = settings.num_pixels
    per = -(-n_pixels // n_px_shards)
    pix = np.arange(per * n_px_shards, dtype=np.int64)
    pix[n_pixels:] = 0
    return pix


def _gather(t: torch.Tensor, group) -> list:
    """`t` of every rank of `group`, in rank order (a collective)."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def _ordered_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over `group`, added in rank order on every rank."""
    parts = _gather(t, group)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


class _SppCombine(torch.autograd.Function):
    """The mean of the spp shards' colours over the spp subgroup. Its
    backward hands each shard its 1/n_spp share of the cotangent, with no
    collective: the parameter gradients are summed over the mesh later,
    and a collective in the backward would give every shard the whole
    cotangent, n_spp times too much (the JAX `spp_combine`,
    `sharding.py:211-228`)."""

    @staticmethod
    def forward(ctx, col, mesh):
        ctx.n_spp = mesh.n_spp
        return _ordered_sum(col, mesh.spp_group) / mesh.n_spp

    @staticmethod
    def backward(ctx, ct):
        return ct / ctx.n_spp, None


def _local_share(settings: RenderSettings, mesh: RenderMesh, device):
    """(this rank's pixels, its first spp lane, its lane count)."""
    spp = settings.samples_per_pixel
    if spp % mesh.n_spp:
        raise ValueError(f"spp {spp} not divisible by spp shards "
                         f"{mesh.n_spp}")
    pix = _padded_pixels(settings, mesh.n_px)
    per = pix.shape[0] // mesh.n_px
    local = torch.from_numpy(pix[mesh.px * per:(mesh.px + 1) * per])
    spp_local = spp // mesh.n_spp
    return local.to(device), mesh.spp * spp_local, spp_local


def render_frame_sharded(scene: SceneData, camera: Camera,
                         settings: RenderSettings, frame,
                         mesh: RenderMesh) -> torch.Tensor:
    """Pixel- and spp-sharded frame: [H, W, 3] on every rank of the mesh,
    `render_frame`'s image up to the order of the spp shards' sum (and,
    where a slab folds another number of lanes into a launch than
    `render_frame`'s chunks do, the order of the lanes' sum). Every rank
    of the mesh must call it. The JAX function returns one global array
    sharded over the devices; here each rank gathers the whole image."""
    if not mesh.member:
        raise ValueError("this rank is not in the mesh")
    pix, lane0, lanes = _local_share(settings, mesh, scene.device)
    col = render_pixel_chunks(scene, camera, settings, frame, pix,
                              spp_offset=lane0, spp_count=lanes)
    if mesh.n_spp > 1:
        col = _ordered_sum(col, mesh.spp_group) / mesh.n_spp
    if mesh.n_px > 1:
        col = torch.cat(_gather(col, mesh.px_group))
    return col[:settings.num_pixels].reshape(settings.height,
                                             settings.width, 3)


def _with_params(scene: SceneData, params: dict) -> SceneData:
    """The scene with the float material fields (and mips) of `params`:
    the flat material dict, or {"material_params": ..., "env_mips": ...}."""
    from halogen_tpu_torch.diff.grad import with_material_params

    mats = params.get("material_params", params)
    scene = dataclasses.replace(
        scene, materials=with_material_params(scene.materials, mats))
    if "env_mips" in params:
        scene = dataclasses.replace(scene,
                                    env_mips=tuple(params["env_mips"]))
    return scene


def _tree(params: dict):
    """(leaves, rebuild): the tensors of `params` in `diff.grad._leaves`'
    order and a function that puts a list of the same length back."""
    from halogen_tpu_torch.diff.grad import _leaves

    leaves = _leaves(params)

    def rebuild(values):
        it = iter(values)

        def put(tree):
            if isinstance(tree, dict):
                return {k: put(tree[k]) for k in sorted(tree)}
            if isinstance(tree, (list, tuple)):
                return type(tree)(put(x) for x in tree)
            return next(it)
        return put(params)

    return leaves, rebuild


def loss_and_grads_sharded(params: dict, scene: SceneData, camera: Camera,
                           settings: RenderSettings, target, frame,
                           mesh: RenderMesh):
    """(loss, grads) of the MSE of the whole frame against `target` [H,
    W, 3], sharded over `mesh`: each rank renders its pixel and spp share,
    the spp shards are averaged before the loss (the MSE of the full-spp
    estimate, as unsharded), each rank backpropagates its share, and the
    gradients are summed over the mesh in rank order (module docstring),
    then divided by 3 * num_pixels. `params` is the float material dict of
    `diff.grad.material_params`, or {"material_params": ..., "env_mips":
    ...} (the mips replicated); `grads` has its structure. Every rank of
    the mesh must call it, and gets the same loss and gradients."""
    if not mesh.member:
        raise ValueError("this rank is not in the mesh")
    dev = scene.device
    pix, lane0, lanes = _local_share(settings, mesh, dev)
    n_pix = settings.num_pixels
    per = pix.shape[0]
    tgt = torch.zeros((per * mesh.n_px, 3), device=dev)
    tgt[:n_pix] = torch.as_tensor(target, dtype=torch.float32,
                                  device=dev).reshape(-1, 3)
    tgt = tgt[mesh.px * per:(mesh.px + 1) * per]
    valid = (mesh.px * per + torch.arange(per, device=dev)) < n_pix

    leaves, rebuild = _tree(params)
    wrt = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        col = render_pixel_chunks(_with_params(scene, rebuild(wrt)), camera,
                                  settings, frame, pix, spp_offset=lane0,
                                  spp_count=lanes)
        if mesh.n_spp > 1:
            col = _SppCombine.apply(col, mesh)
        err = torch.where(valid[:, None], (col - tgt) ** 2, 0.0).sum()
        grads = torch.autograd.grad(err, wrt, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(wrt, grads)]
    flat = torch.cat([g.reshape(-1) for g in grads] + [err.detach()[None]])
    if len(mesh.ranks) > 1:
        flat = _ordered_sum(flat, mesh.group)
    denom = 3.0 * n_pix
    # the loss: every spp shard of a slab holds the same slab sum
    loss = flat[-1] / mesh.n_spp / denom
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].reshape(g.shape) / denom)
        at += g.numel()
    return loss, rebuild(out)


def train_step_sharded(materials, scene: SceneData, camera: Camera,
                       settings: RenderSettings, target, frame,
                       mesh: RenderMesh, lr: float = 1e-2):
    """One projected-SGD step of the float material fields, sharded over
    `mesh` (`loss_and_grads_sharded`, then `diff.grad`'s projection onto
    the physical ranges; the integer fields never move). Returns
    (new_materials, loss)."""
    from halogen_tpu_torch.diff.grad import (
        material_params,
        project_material_params,
        with_material_params,
    )

    params = material_params(materials)
    loss, grads = loss_and_grads_sharded(params, scene, camera, settings,
                                         target, frame, mesh)
    with torch.no_grad():
        params = {k: p - lr * grads[k] for k, p in params.items()}
    params = project_material_params(params)
    return with_material_params(materials, params), loss
