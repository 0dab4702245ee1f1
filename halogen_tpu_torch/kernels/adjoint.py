"""Fused path-replay adjoint: per-material cotangents of the traced color
in one CUDA launch (port of `halogen_tpu/kernels/adjoint.py`: its opaque
branch, B2, and its nested-dielectric branch, B2b).

The kernel is hand-written CUDA C++ for Hopper (`csrc/adjoint.cu`), built
with the megakernel's library step (`megakernel.load_library`). It replays
every path through the forward kernel's own bounce code
(`csrc/path_common.cuh`), records a transcript per bounce, sweeps the
bounces in reverse and sums the cotangents per material in a fixed order,
so two calls give the same bits. In glass scenes the replay carries the
medium stack, and d absorption goes to the material of the medium the
ray travelled through.

`trace_grad_fused_materials` takes rays on a CUDA device to the kernel and
rays on the CPU to the plain PyTorch version,
`trace_grad_fused_materials_reference`: autograd through the lockstep
integrator. A CUDA launch that fails raises; there is no fallback.
`LAUNCHES` counts kernel launches. `material_cotangents` maps the [K, 12]
result onto a `MaterialTable`.

The gradient is the detached-sampling estimator of the lockstep tracer:
emission, albedo and specular attenuation, Beer-Lambert absorption and
Russian roulette's 1/max(attenuation); roughness, metallic and IOR act
only through sampling decisions and get zero. Scope (`adjoint_supported`,
the JAX predicate): the megakernel's opaque and transmissive scenes of at
most MAX_TRIS triangles without an envmap in use, NEE or debug views;
envmap gradients come with ROADMAP A8, big scenes with A9.
"""

from __future__ import annotations

import dataclasses

import torch

from halogen_tpu_torch.config import RenderSettings
from halogen_tpu_torch.core.types import MaterialTable, SceneData
from halogen_tpu_torch.kernels import megakernel as mk

N_GRAD = 12  # d_e premultiplied rgb | d_albedo rgb | d_specular rgb | d_absorption rgb
N_RECORD = 7  # transcript rows per bounce: A_prev rgb, mat, code, t, Beer mat
THREADS = 128  # csrc/path_common.cuh kThreads

LAUNCHES = 0  # kernel launches since the count was last set to 0


def adjoint_supported(scene: SceneData, settings: RenderSettings) -> bool:
    """Static eligibility for the fused adjoint (the JAX `adjoint_supported`,
    `adjoint.py:66-77`): the megakernel's opaque or transmissive scenes
    (which have no area-light NEE or debug view) of at most MAX_TRIS
    triangles, without an envmap in use, and so without env NEE."""
    return (mk.fused_supported(scene, settings)
            and scene.num_triangles <= mk.MAX_TRIS
            and not (settings.use_envmap and bool(scene.env_mips)))


def _check_supported(scene: SceneData, settings: RenderSettings) -> None:
    if not adjoint_supported(scene, settings):
        raise NotImplementedError(
            "the fused adjoint covers the megakernel's scenes of at most "
            f"{mk.MAX_TRIS} triangles without an envmap in use (envmap "
            "gradients: ROADMAP A8; big scenes: A9)")


def _launch(scene, origin, direction, far, sample_idx, seed, ct,
            settings: RenderSettings, tables,
            replay_color: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the adjoint on the current stream; returns [K, 12].
    `replay_color`, an [N, 3] float32 buffer, receives the color of the
    replayed paths (a check that the replay took the forward's path)."""
    global LAUNCHES
    sidx, sd, far_t, tables, scalars = mk.kernel_inputs(
        scene, origin, direction, far, sample_idx, seed, settings, tables)
    _check_supported(scene, settings)
    n = origin.shape[0]
    dev = origin.device
    buffers = {"ct": ct, "replay_color": replay_color}
    for name, t in buffers.items():
        if t is not None and (t.shape != (n, 3) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous float32 [N, 3] "
                             f"on {dev}")
    k = scene.materials.count
    if n == 0:
        return torch.zeros((k, N_GRAD), dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    # scratch: the transcript, lane-major so a warp's stores coalesce, and
    # one partial [K, 12] table per block of 128 paths
    transcript = torch.empty((settings.max_bounces + 1, N_RECORD, n), **f32)
    partial = torch.empty((-(-n // THREADS), k * N_GRAD), **f32)
    out = torch.empty((k, N_GRAD), **f32)
    lib = mk.load_library("adjoint")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.halogen_adjoint_launch(
            origin.data_ptr(), direction.data_ptr(), far_t.data_ptr(),
            sidx.data_ptr(), sd.data_ptr(), ct.data_ptr(),
            *(t.data_ptr() for t in tables), transcript.data_ptr(),
            partial.data_ptr(), out.data_ptr(),
            None if replay_color is None else replay_color.data_ptr(),
            *scalars, stream)
    if err != 0:
        raise RuntimeError(f"adjoint launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def trace_grad_fused_materials_reference(scene: SceneData, origin,
                                         direction, far, sample_idx, seed,
                                         ct, settings: RenderSettings
                                         ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: autograd of (color * ct).sum()
    through the lockstep `trace_rays`, with respect to leaves for the
    premultiplied emission, albedo rgb, specular and absorption. The
    emission enters as `cat([premult, ones])`, so the table's rgb *
    intensity product is a multiplication by 1.0, which is exact."""
    from halogen_tpu_torch.integrator.trace import trace_rays

    mats = scene.materials
    n = origin.shape[0]
    with torch.enable_grad():
        em = mats.emissive.detach()
        leaves = [t.clone().requires_grad_(True) for t in (
            em[:, :3] * em[:, 3:4], mats.albedo[:, :3].detach(),
            mats.specular.detach(), mats.absorption.detach())]
        em_pre, albedo, specular, absorption = leaves
        table = MaterialTable(
            albedo=torch.cat([albedo, mats.albedo[:, 3:].detach()], dim=1),
            specular=specular,
            metallic=mats.metallic.detach(),
            roughness=mats.roughness.detach(),
            emissive=torch.cat([em_pre, torch.ones_like(em[:, 3:])], dim=1),
            ior=mats.ior.detach(),
            absorption=absorption,
            priority=mats.priority,
        )
        far_b = torch.as_tensor(far, dtype=torch.float32,
                                device=origin.device).reshape(-1)[0].expand(n)
        color = trace_rays(dataclasses.replace(scene, materials=table),
                           origin.detach(), direction.detach(), far_b,
                           sample_idx, seed, settings).color
        grads = torch.autograd.grad((color * ct).sum(), leaves,
                                    allow_unused=True)
    return torch.cat([torch.zeros_like(x) if g is None else g
                      for g, x in zip(grads, leaves)], dim=1)


def trace_grad_fused_materials(scene: SceneData, origin, direction, far,
                               sample_idx, seed, ct,
                               settings: RenderSettings,
                               tables=None) -> torch.Tensor:
    """Fused backward: [K, 12] per-material cotangents (d emission
    premultiplied rgb | d albedo rgb | d specular rgb | d absorption rgb)
    for the cotangent `ct` [N, 3] of the traced color. The kernel on a
    CUDA device, its plain version on the CPU. `tables` may carry
    `megakernel._scene_tables(scene)` computed once for many calls."""
    if origin.device.type == "cuda":
        return _launch(scene, origin, direction, far, sample_idx, seed, ct,
                       settings, tables)
    if origin.device.type != "cpu":
        raise ValueError(f"no adjoint kernel for device {origin.device}")
    _check_supported(scene, settings)
    return trace_grad_fused_materials_reference(
        scene, origin, direction, far, sample_idx, seed, ct, settings)


def material_cotangents(scene: SceneData, dmat12: torch.Tensor
                        ) -> MaterialTable:
    """Map the kernel's [K, 12] rows onto a `MaterialTable` of cotangents.
    Emission arrives with respect to the premultiplied rgb * intensity
    (`megakernel._scene_tables` col 9:12), so it is chained through the
    product to the table's rgb + intensity layout. Metallic, roughness,
    IOR and the alpha column get zeros, priority int32 zeros."""
    mats = scene.materials
    d_pre = dmat12[:, 0:3]
    zero = torch.zeros_like
    return MaterialTable(
        albedo=torch.cat([dmat12[:, 3:6], zero(mats.albedo[:, 3:])], dim=1),
        specular=dmat12[:, 6:9],
        metallic=zero(mats.metallic),
        roughness=zero(mats.roughness),
        emissive=torch.cat(
            [d_pre * mats.emissive[:, 3:4],
             (d_pre * mats.emissive[:, :3]).sum(dim=1, keepdim=True)],
            dim=1),
        ior=zero(mats.ior),
        absorption=dmat12[:, 9:12],
        priority=zero(mats.priority),
    )
