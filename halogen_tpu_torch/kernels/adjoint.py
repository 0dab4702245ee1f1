"""Fused path-replay adjoint: per-material cotangents of the traced color
in one CUDA launch (port of `halogen_tpu/kernels/adjoint.py`: its opaque
branch, B2, and its nested-dielectric branch, B2b; and of the JAX
package's lockstep vjp where the Pallas kernel stops: big scenes, B2+d and
B2b+d, and envmap scenes with and without env NEE).

The kernel is hand-written CUDA C++ for Hopper (`csrc/adjoint.cu`), built
with the megakernel's library step (`megakernel.load_library`). It replays
every path through the forward kernel's own bounce code
(`csrc/path_common.cuh`), records a transcript per bounce, sweeps the
bounces in reverse and sums the cotangents per material in a fixed order,
so two calls give the same bits. In glass scenes the replay carries the
medium stack, and d absorption goes to the material of the medium the
ray travelled through. On the BVH tier (scenes over MAX_TRIS triangles)
the replay walks the world BVH as B1d does. The transcript stays in the
block's shared memory where the block's tables fit `SMEM_BUDGET` (the
shared route; at most 17 bounces in the Cornell and glass boxes), else it
goes to a device buffer of the same layout (the global route); both give
the same bits.

With an envmap in use the kernel takes the cotangents of the path's
outputs (`trace_grad_outputs`): of its color, of its miss attenuation and
of its accumulated roughness, which the sky pass's backward kernel
(`kernels/sky.py`) gives; roughness then has a cotangent too (the 13th
column: the mip-bias level of the lookup grows with it). With env NEE
the replay also writes one record per (ray, bounce): the drawn texel and
its cotangent, which the sky's per-texel sum adds into the finest mip.
`trace_grad_fused` runs them on a CUDA device as a render's backward does,
by autograd through `megakernel.trace_color_fused_diff`.

The plain PyTorch versions, `trace_grad_outputs_reference` and
`trace_grad_fused_reference`, are autograd through the lockstep integrator
with `Intersector.AUTO` pinned to BRUTE, as the JAX lockstep backward
pins it (`megakernel.py:1962-1968`). Rays on a CUDA device go to the
kernels and rays on the CPU to the plain versions; a CUDA launch that
fails raises, there is no fallback. `LAUNCHES` counts kernel launches.
`material_cotangents` maps the [K, 12|13] result onto a `MaterialTable`.

The gradient is the detached-sampling estimator of the lockstep tracer:
emission, albedo and specular attenuation, Beer-Lambert absorption,
Russian roulette's 1/max(attenuation), the env-NEE term and the sky's
mip-bias level; metallic and IOR act only through sampling decisions
and get zero. Scope (`adjoint_covers`): every scene the megakernel
renders (`megakernel.fused_supported`) but with area-light NEE, whose
adjoint is ROADMAP B2+l.
"""

from __future__ import annotations

import dataclasses

import torch

from halogen_tpu_torch.config import Intersector, RenderSettings
from halogen_tpu_torch.core.types import MaterialTable, SceneData
from halogen_tpu_torch.integrator.trace import _use_light_nee, _use_nee
from halogen_tpu_torch.kernels import megakernel as mk
from halogen_tpu_torch.kernels import sky

N_GRAD = 12  # d_e premultiplied rgb | d_albedo rgb | d_specular rgb | d_absorption rgb
N_GRAD_SKY = 13  # ... | d_roughness, with an envmap in use
N_RECORD = 5  # transcript words per bounce: A_prev rgb, t, mats and masks
N_RECORD_NEE = 10  # ... | NEE radiance * weight rgb, its BRDF factors
THREADS = 128  # csrc/path_common.cuh kThreads
WARPS = THREADS // 32
# Dynamic shared memory a block of the adjoint may take (scene tables, the
# warps' [K, 12] sums and the transcript) on the shared route: 48 KB, so
# the 4 blocks a multiprocessor holds at B2b's 128 registers fit its
# 227 KB, and no launch needs the opt-in above 48 KB (the global route's
# block, tables and sums only, stays under 28 KB at the kernels' caps).
SMEM_BUDGET = 48 * 1024

LAUNCHES = 0  # kernel launches since the count was last set to 0


def env_mode(scene: SceneData, settings: RenderSettings) -> int:
    """The adjoint's sky variant: 0 none, 1 the sky at the miss, 2 the sky
    and env NEE."""
    if not sky.uses_sky(scene, settings):
        return 0
    return 2 if _use_nee(scene, settings) else 1


def n_grad(scene: SceneData, settings: RenderSettings) -> int:
    """Columns of the result: 12, or 13 with the sky (d roughness)."""
    return N_GRAD_SKY if env_mode(scene, settings) else N_GRAD


def smem_bytes(scene: SceneData, settings: RenderSettings) -> int:
    """A block's dynamic shared memory on the shared route: the scene
    tables (`path_common.cuh::scene_smem_floats`; the BVH tier keeps its
    triangles in device memory), the warps' sums and the transcript of
    max_bounces + 1 bounces."""
    tris = 0 if mk.uses_bvh(scene) else scene.num_triangles
    floats = (tris * 22 + scene.num_spheres * 5
              + scene.materials.count * 17
              + WARPS * scene.materials.count * n_grad(scene, settings))
    rec = N_RECORD_NEE if env_mode(scene, settings) == 2 else N_RECORD
    words = (settings.max_bounces + 1) * rec * THREADS
    return 4 * (floats + words)


def transcript_route(scene: SceneData, settings: RenderSettings) -> str:
    """'shared' where the block fits SMEM_BUDGET with its transcript, else
    'global'."""
    return ("shared" if smem_bytes(scene, settings) <= SMEM_BUDGET
            else "global")


def adjoint_covers(scene: SceneData, settings: RenderSettings) -> bool:
    """Whether the port differentiates `scene` through the fused route:
    every scene its megakernel renders (`megakernel.fused_supported`),
    brute and BVH tier, glass, sky and env NEE, but area-light NEE (with
    the flag and emitters, the JAX predicate), whose adjoint variant is
    ROADMAP B2+l."""
    return (mk.fused_supported(scene, settings)
            and not _use_light_nee(scene, settings))


def _check_covered(scene: SceneData, settings: RenderSettings) -> None:
    if _use_light_nee(scene, settings):
        raise NotImplementedError(
            "the fused adjoint has no area-light NEE variant yet (ROADMAP "
            "B2+l); on the CPU render_loss_grad differentiates it through "
            "the lockstep")
    if not adjoint_covers(scene, settings):
        raise NotImplementedError(
            "the fused adjoint covers the megakernel's scenes (no debug "
            "views, within its caps; ROADMAP A8)")


def _launch(scene, origin, direction, far, sample_idx, seed, ct,
            settings: RenderSettings, tables,
            replay_color: torch.Tensor | None = None,
            route: str | None = None, gsky: torch.Tensor | None = None,
            env_tab: torch.Tensor | None = None,
            records: tuple | None = None) -> torch.Tensor:
    """Launch the adjoint on the current stream; returns [K, 12], or
    [K, 13] with an envmap in use.

    `ct` [N, 3] is the cotangent of the path color; with an envmap in use
    `gsky` [N, 4] those of the miss attenuation and of the accumulated
    roughness (zeros if None). `replay_color`, an [N, 3] float32 buffer,
    receives the color of the replayed paths (a check that the replay took
    the forward's path). With env NEE `records`, a pair of buffers
    (keys [N, B + 1] int32, weights [N, B + 1, 3] float32), receives each
    (ray, bounce)'s drawn texel (-1: none) and its cotangent. `route`
    ('shared' or 'global') overrides `transcript_route`; the shared route
    raises where the block would exceed SMEM_BUDGET."""
    global LAUNCHES
    sidx, sd, far_t, tables, scalars = mk.kernel_inputs(
        scene, origin, direction, far, sample_idx, seed, settings, tables)
    _check_covered(scene, settings)
    route = route or transcript_route(scene, settings)
    if route not in ("shared", "global"):
        raise ValueError(f"unknown transcript route {route!r}")
    if route == "shared" and smem_bytes(scene, settings) > SMEM_BUDGET:
        raise ValueError("the transcript does not fit a block's shared "
                         "memory at this bounce count")
    n = origin.shape[0]
    dev = origin.device
    env = env_mode(scene, settings)
    f32 = dict(dtype=torch.float32, device=dev)
    if env and gsky is None:
        gsky = torch.zeros((n, 4), **f32)
    slots = settings.max_bounces + 1
    if env == 2 and records is None:
        records = (torch.empty((n, slots), dtype=torch.int32, device=dev),
                   torch.empty((n, slots, 3), **f32))
    buffers = {"ct": (ct, (n, 3), torch.float32),
               "replay_color": (replay_color, (n, 3), torch.float32),
               "gsky": (gsky if env else None, (n, 4), torch.float32)}
    if env == 2:
        buffers["record keys"] = (records[0], (n, slots), torch.int32)
        buffers["record weights"] = (records[1], (n, slots, 3),
                                     torch.float32)
    for name, (t, shape, dtype) in buffers.items():
        if t is not None and (t.shape != shape or t.dtype != dtype
                              or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous {dtype} "
                             f"{list(shape)} on {dev}")
    k = scene.materials.count
    cols = n_grad(scene, settings)
    if n == 0:
        return torch.zeros((k, cols), **f32)
    bvh = mk.uses_bvh(scene)
    nodes = scene.wbvh.nodes if bvh else None
    if bvh and (nodes.device != dev or nodes.dtype != torch.float32
                or not nodes.is_contiguous() or nodes.data_ptr() % 16
                or tables[0].shape != (scene.num_triangles, 12)
                or tables[0].data_ptr() % 16):
        raise ValueError("the world BVH's nodes and triangles must be "
                         "contiguous, 16-byte aligned float32 [Nn, 8] and "
                         f"[T, 12] tensors on {dev}")
    env_h = env_w = 0
    if env == 2:
        env_tab = env_tab if env_tab is not None else mk.env_table(scene)
        env_h, env_w = scene.env_cdf.pdf.shape
        if (env_tab.shape != (env_h * env_w, 16) or env_tab.device != dev
                or env_tab.dtype != torch.float32
                or not env_tab.is_contiguous() or env_tab.data_ptr() % 16):
            raise ValueError("the env draw table must be a contiguous, "
                             "16-byte aligned float32 "
                             f"[{env_h * env_w}, 16] on {dev}")
    blocks = -(-n // THREADS)
    # scratch: on the global route the transcript, [block, bounce, word,
    # thread] so a warp's stores coalesce; one partial table per block of
    # 128 paths
    transcript = None
    if route == "global":
        rec = N_RECORD_NEE if env == 2 else N_RECORD
        transcript = torch.empty((blocks, slots, rec, THREADS),
                                 dtype=torch.int32, device=dev)
    partial = torch.empty((blocks, k * cols), **f32)
    out = torch.empty((k, cols), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = mk.load_library("adjoint")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.halogen_adjoint_launch(
            origin.data_ptr(), direction.data_ptr(), far_t.data_ptr(),
            sidx.data_ptr(), sd.data_ptr(), ct.data_ptr(),
            *(t.data_ptr() for t in tables), ptr(transcript),
            partial.data_ptr(), out.data_ptr(), ptr(replay_color),
            ptr(nodes), ptr(gsky if env else None),
            ptr(env_tab if env == 2 else None),
            ptr(records[0] if env == 2 else None),
            ptr(records[1] if env == 2 else None),
            *scalars, int(bvh), env, env_h, env_w, stream)
    if err != 0:
        raise RuntimeError(f"adjoint launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def _backward_settings(settings: RenderSettings) -> RenderSettings:
    """The plain backward's settings: AUTO pinned to the dense BRUTE
    intersector, as the JAX lockstep backward pins it (the same radiance;
    elementwise, so reverse mode is exact; and free of the per-mesh walk's
    local-space ulps)."""
    if settings.intersector == Intersector.AUTO:
        return settings.replace(intersector=Intersector.BRUTE)
    return settings


def _reference_grads(scene: SceneData, origin, direction, far, sample_idx,
                     seed, settings: RenderSettings, loss_of, env_leaves):
    """Autograd of `loss_of(TraceOut)` through the lockstep `trace_rays`,
    with respect to leaves for the premultiplied emission, albedo rgb,
    specular, absorption and, with the sky, roughness; and, where
    `env_leaves` (a tuple of mip indices), those mips. The emission enters
    as `cat([premult, ones])`, so the table's rgb * intensity product is a
    multiplication by 1.0, which is exact. Returns ([K, 12|13], the mips'
    cotangents or None)."""
    from halogen_tpu_torch.integrator.trace import trace_rays

    mats = scene.materials
    n = origin.shape[0]
    with_sky = bool(env_mode(scene, settings))
    with torch.enable_grad():
        em = mats.emissive.detach()
        leaves = [t.clone().requires_grad_(True) for t in (
            em[:, :3] * em[:, 3:4], mats.albedo[:, :3].detach(),
            mats.specular.detach(), mats.absorption.detach())]
        rough = mats.roughness.detach().clone().requires_grad_(with_sky)
        em_pre, albedo, specular, absorption = leaves
        table = MaterialTable(
            albedo=torch.cat([albedo, mats.albedo[:, 3:].detach()], dim=1),
            specular=specular,
            metallic=mats.metallic.detach(),
            roughness=rough,
            emissive=torch.cat([em_pre, torch.ones_like(em[:, 3:])], dim=1),
            ior=mats.ior.detach(),
            absorption=absorption,
            priority=mats.priority,
        )
        mips = [m.detach() for m in scene.env_mips]
        env = []
        for l in env_leaves or ():
            mips[l] = mips[l].clone().requires_grad_(True)
            env.append(mips[l])
        far_b = torch.as_tensor(far, dtype=torch.float32,
                                device=origin.device).reshape(-1)[0].expand(n)
        traced = trace_rays(
            dataclasses.replace(scene, materials=table,
                                env_mips=tuple(mips)),
            origin.detach(), direction.detach(), far_b, sample_idx, seed,
            _backward_settings(settings))
        wrt = leaves + ([rough] if with_sky else []) + env
        grads = torch.autograd.grad(loss_of(traced), wrt, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, wrt)]
    cols = grads[:len(wrt) - len(env)]
    if with_sky:
        cols[-1] = cols[-1][:, None]
    d_env = tuple(grads[len(wrt) - len(env):]) if env_leaves else None
    return torch.cat(cols, dim=1), d_env


def trace_grad_outputs_reference(scene: SceneData, origin, direction, far,
                                 sample_idx, seed, d_out,
                                 settings: RenderSettings,
                                 want_env: bool = False):
    """Plain version of `trace_grad_outputs`: autograd of the path's
    outputs (color, miss attenuation, accumulated roughness: columns 0-6)
    against `d_out` [N, >= 7]. Returns ([K, 12|13], with `want_env` and
    env NEE the finest mip's cotangent, else None)."""
    env_leaves = (0,) if want_env and env_mode(scene, settings) == 2 else ()
    dmat, d_env = _reference_grads(
        scene, origin, direction, far, sample_idx, seed, settings,
        lambda tr: (tr.outputs[:, :7] * d_out[:, :7]).sum(), env_leaves)
    return dmat, (d_env[0] if d_env else None)


def trace_grad_outputs(scene: SceneData, origin, direction, far, sample_idx,
                       seed, d_out, settings: RenderSettings, tables=None,
                       env_tab=None, want_env: bool = False):
    """Backward of the megakernel's per-ray outputs: for their cotangent
    `d_out` [N, C] (the color's in columns 0-2; with an envmap the miss
    attenuation's in 3-5 and the accumulated roughness's in 6), ([K, 12|13]
    per-material cotangents, and with `want_env` and env NEE the finest
    mip's cotangent [H, W, 3], else None). The adjoint kernel (and, for the
    mip, the sky's per-texel sum) on a CUDA device, the plain version on
    the CPU."""
    if origin.device.type == "cpu":
        _check_covered(scene, settings)
        return trace_grad_outputs_reference(scene, origin, direction, far,
                                            sample_idx, seed, d_out,
                                            settings, want_env)
    if origin.device.type != "cuda":
        raise ValueError(f"no adjoint kernel for device {origin.device}")
    env = env_mode(scene, settings)
    ct = d_out[:, 0:3].contiguous()
    gsky = d_out[:, 3:7].contiguous() if env else None
    records = None
    n = origin.shape[0]
    if env == 2:
        slots = settings.max_bounces + 1
        records = (torch.empty((n, slots), dtype=torch.int32,
                               device=origin.device),
                   torch.empty((n, slots, 3), dtype=torch.float32,
                               device=origin.device))
    dmat = _launch(scene, origin, direction, far, sample_idx, seed, ct,
                   settings, tables, gsky=gsky, env_tab=env_tab,
                   records=records)
    d_env = None
    if want_env and env == 2:
        h, w = scene.env_cdf.pdf.shape
        d_env = sky.scatter_texels(records[0].reshape(-1),
                                   records[1].reshape(-1, 3),
                                   h * w).reshape(h, w, 3)
    return dmat, d_env


def trace_grad_fused_reference(scene: SceneData, origin, direction, far,
                               sample_idx, seed, ct,
                               settings: RenderSettings):
    """Plain version of `trace_grad_fused`: autograd of (color * ct).sum()
    through the lockstep `trace_rays`, the sky included. Returns
    ([K, 12|13], one cotangent per mip, or None without an envmap in
    use)."""
    env_leaves = (tuple(range(len(scene.env_mips)))
                  if env_mode(scene, settings) else ())
    return _reference_grads(scene, origin, direction, far, sample_idx, seed,
                            settings, lambda tr: (tr.color * ct).sum(),
                            env_leaves)


def trace_grad_fused_materials_reference(scene: SceneData, origin,
                                         direction, far, sample_idx, seed,
                                         ct, settings: RenderSettings
                                         ) -> torch.Tensor:
    """The [K, 12|13] of `trace_grad_fused_reference`."""
    return trace_grad_fused_reference(scene, origin, direction, far,
                                      sample_idx, seed, ct, settings)[0]


def _main_path_grads(scene: SceneData, origin, direction, far, sample_idx,
                     seed, ct, settings: RenderSettings, tables, env_tab):
    """([K, 13], one cotangent per mip) of (color * ct).sum() by autograd
    through `megakernel.trace_color_fused_diff`, the composition a render's
    backward runs (the forward kernel and the sky forward; then the sky
    backward, the adjoint and the per-texel sums), with the material table
    and the mips as leaves. On CPU tensors each piece takes its plain
    version."""
    mat_tab = tables[3].detach().requires_grad_(True)
    mips = [m.detach().requires_grad_(True) for m in scene.env_mips]
    with torch.enable_grad():
        color = mk.trace_color_fused_diff(
            dataclasses.replace(scene, env_mips=tuple(mips)), origin,
            direction, far, sample_idx, seed, settings,
            (*tables[:3], mat_tab), env_tab)
        d_tab, *d_env = torch.autograd.grad((color * ct).sum(),
                                            [mat_tab, *mips],
                                            allow_unused=True)
    d_env = tuple(torch.zeros_like(m) if g is None else g
                  for g, m in zip(d_env, mips))
    # _scene_tables' [K, 17] columns back onto the [K, 13] layout
    dmat = torch.cat([d_tab[:, 9:12], d_tab[:, 0:3], d_tab[:, 4:7],
                      d_tab[:, 13:16], d_tab[:, 8:9]], dim=1)
    return dmat, d_env


def trace_grad_fused(scene: SceneData, origin, direction, far, sample_idx,
                     seed, ct, settings: RenderSettings, tables=None,
                     env_tab=None):
    """Fused backward of the traced color (the sky included) for its
    cotangent `ct` [N, 3]: ([K, 12|13] per-material cotangents, one
    cotangent per mip or None without an envmap in use). On a CUDA device:
    without an envmap one adjoint launch; with one, autograd through the
    main path's Functions (`_main_path_grads`). On the CPU the plain
    version. `tables` and `env_tab` may carry
    `megakernel._scene_tables(scene)` and `megakernel.env_table(scene)`
    computed once for many calls."""
    if origin.device.type == "cpu":
        _check_covered(scene, settings)
        return trace_grad_fused_reference(scene, origin, direction, far,
                                          sample_idx, seed, ct, settings)
    if origin.device.type != "cuda":
        raise ValueError(f"no adjoint kernel for device {origin.device}")
    if not env_mode(scene, settings):
        return _launch(scene, origin, direction, far, sample_idx, seed, ct,
                       settings, tables), None
    tables = tables if tables is not None else mk._scene_tables(scene)
    if _use_nee(scene, settings) and env_tab is None:
        env_tab = mk.env_table(scene)
    return _main_path_grads(scene, origin, direction, far, sample_idx, seed,
                            ct, settings, tables, env_tab)


def trace_grad_fused_materials(scene: SceneData, origin, direction, far,
                               sample_idx, seed, ct,
                               settings: RenderSettings,
                               tables=None, env_tab=None) -> torch.Tensor:
    """The [K, 12|13] per-material cotangents of `trace_grad_fused` (d
    emission premultiplied rgb | d albedo rgb | d specular rgb | d
    absorption rgb | with the sky d roughness)."""
    return trace_grad_fused(scene, origin, direction, far, sample_idx, seed,
                            ct, settings, tables, env_tab)[0]


def material_cotangents(scene: SceneData, dmat12: torch.Tensor
                        ) -> MaterialTable:
    """Map the kernel's [K, 12|13] rows onto a `MaterialTable` of
    cotangents. Emission arrives with respect to the premultiplied rgb *
    intensity (`megakernel._scene_tables` col 9:12), so it is chained
    through the product to the table's rgb + intensity layout. Roughness
    gets the 13th column where there is one; metallic, IOR and the alpha
    column get zeros, priority int32 zeros."""
    mats = scene.materials
    d_pre = dmat12[:, 0:3]
    zero = torch.zeros_like
    return MaterialTable(
        albedo=torch.cat([dmat12[:, 3:6], zero(mats.albedo[:, 3:])], dim=1),
        specular=dmat12[:, 6:9],
        metallic=zero(mats.metallic),
        roughness=(dmat12[:, 12] if dmat12.shape[1] > N_GRAD
                   else zero(mats.roughness)),
        emissive=torch.cat(
            [d_pre * mats.emissive[:, 3:4],
             (d_pre * mats.emissive[:, :3]).sum(dim=1, keepdim=True)],
            dim=1),
        ior=zero(mats.ior),
        absorption=dmat12[:, 9:12],
        priority=zero(mats.priority),
    )
