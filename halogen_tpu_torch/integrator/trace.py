"""The path-tracing integrator and the per-frame renderer (PyTorch port of
`halogen_tpu/integrator/trace.py`).

`trace_rays` is the lockstep integrator: every ray of the pool advances
one bounce per step, with per-ray active masks, as a Python loop over
bounces. It is the port's CPU oracle and the plain version of the CUDA
megakernel (`kernels/megakernel.py`); autograd through it is the
detached-sampling gradient estimator. `render_frame` walks the pixels in
Morton order, in chunks, and folds the spp lanes pixel-major into the ray
axis; on a CUDA device the whole path loop runs in the megakernel, and
its backward in the adjoint kernel (`kernels/adjoint.py`).

Semantics preserved (trace_ray, HalgoenCompute.compute:876-950):
- per-ray-type bounce limits checked at loop top with `>` (compute:869-871)
- emission accumulated before BRDF evaluation (compute:901-902)
- Russian roulette with 1/p compensation after every hit (compute:923-936)
- miss -> sky lookup with the accumulated-roughness mip bias, including
  the float3->float truncation quirk of the roughness accumulator
  (compute:911 adds `roughness * lightAttenuation` to a scalar: .x wins)
- sampler dimensions advance by 5 per bounce (compute:921)

The port's slice is opaque scenes with no envmap, no next-event
estimation and no debug views; those settings raise NotImplementedError
naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from halogen_tpu_torch.config import DebugMode, Fused, RenderSettings, SamplerKind
from halogen_tpu_torch.core.types import SceneData
from halogen_tpu_torch.integrator.camera import Camera, generate_rays
from halogen_tpu_torch.integrator.intersect import intersect_scene
from halogen_tpu_torch.integrator.shade import (
    evaluate_material_hit,
    gather_materials,
)
from halogen_tpu_torch.sampler import sobol as sob


def _sampler_2d(settings: RenderSettings):
    if settings.sampler == SamplerKind.PRNG:
        return sob.prng_sample_2d
    return sob.ld_sample_2d


def _sampler_1d(settings: RenderSettings):
    if settings.sampler == SamplerKind.PRNG:
        return sob.prng_sample_1d
    return sob.ld_sample_1d


def check_slice(scene: SceneData, settings: RenderSettings) -> None:
    """Raise NotImplementedError for what the port does not have yet."""
    missing = []
    if scene.any_transmissive:
        missing.append("transmissive materials (ROADMAP A8)")
    if settings.use_envmap:
        missing.append("envmaps (ROADMAP A8)")
    if settings.env_importance_sampling or settings.light_importance_sampling:
        missing.append("next-event estimation (ROADMAP A8)")
    if settings.debug_mode != DebugMode.NONE:
        missing.append("debug views (ROADMAP A8)")
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing))


def sample_sky(scene: SceneData, direction: torch.Tensor, level,
               settings: RenderSettings) -> torch.Tensor:
    """Environment lookup (sample_sky, compute:196-204): black without an
    envmap, which is the only case the port has."""
    if settings.use_envmap:
        raise NotImplementedError("envmaps are not ported yet (ROADMAP A8)")
    return torch.zeros(direction.shape[:-1] + (3,), device=direction.device)


class Pool(NamedTuple):
    """Per-ray SoA state advanced by `_pool_bounce`."""

    origin: torch.Tensor  # [N, 3]
    direction: torch.Tensor  # [N, 3]
    attenuation: torch.Tensor  # [N, 3]
    color: torch.Tensor  # [N, 3]
    acc_roughness: torch.Tensor  # [N]
    counts: torch.Tensor  # [N, 3] bounce-type counts
    active: torch.Tensor  # [N] bool
    # Attenuation at the bounce where the ray missed (0 if it never did):
    # the deferred-sky record the megakernel also returns.
    miss_attenuation: torch.Tensor  # [N, 3]
    sample_idx: torch.Tensor  # [N] uint32 in int64
    seed: torch.Tensor  # [N] uint32 in int64
    far: torch.Tensor  # [N]


def _make_pool(origin, direction, far, sample_idx, seed) -> Pool:
    n = origin.shape[0]
    dev = origin.device
    return Pool(
        origin=origin,
        direction=direction,
        attenuation=torch.ones((n, 3), device=dev),
        color=torch.zeros((n, 3), device=dev),
        acc_roughness=torch.zeros((n,), device=dev),
        counts=torch.zeros((n, 3), dtype=torch.int32, device=dev),
        active=torch.ones((n,), dtype=torch.bool, device=dev),
        miss_attenuation=torch.zeros((n, 3), device=dev),
        sample_idx=sob._u32(sample_idx).to(dev).expand(n),
        seed=sob._u32(seed).to(dev).expand(n),
        far=torch.as_tensor(far, dtype=torch.float32, device=dev).expand(n),
    )


def _pool_bounce(scene: SceneData, settings: RenderSettings, carry: Pool,
                 k: int) -> Pool:
    """One bounce of every ray in `carry` (trace_ray compute:876-950), the
    opaque, no-NEE subset of the JAX `_pool_bounce`."""
    n = carry.origin.shape[0]
    s2 = _sampler_2d(settings)
    s1 = _sampler_1d(settings)
    sample_idx, seed, far = carry.sample_idx, carry.seed, carry.far

    # --- per-type termination check at loop top (compute:891-893)
    over = ((carry.counts[:, 0] > settings.max_diffuse_bounces)
            | (carry.counts[:, 1] > settings.max_glossy_bounces)
            | (carry.counts[:, 2] > settings.max_transmission_bounces))
    active = carry.active & (~over)

    # Dead lanes get far = 0; every consumer of their hit is masked.
    far_eff = torch.where(active, far, 0.0)
    hit = intersect_scene(scene, carry.origin, carry.direction, far_eff,
                          settings)
    is_hit = active & (hit.t < far)  # compute:898
    mat = gather_materials(scene.materials, hit.material)

    # --- emission (compute:901-902)
    emission = mat.emissive_rgb * mat.emissive_intensity[:, None]
    color = carry.color + torch.where(
        (active & is_hit)[:, None], emission * carry.attenuation, 0.0)

    # --- sampler dims for this bounce (base + 5*k, compute:921)
    stride = sob.BOUNCE_DIM_STRIDE * k
    refl_rand = s2(sample_idx, sob.DIM_ROUGH_REFLECTION + stride, seed)
    prop_rand = s2(sample_idx, sob.DIM_MATERIAL_BRDF + stride, seed)
    rr_rand = s1(sample_idx, sob.DIM_RUSSIAN_ROULETTE + stride, seed)

    shade_mask = active & is_hit
    shaded = evaluate_material_hit(
        carry.direction, hit, mat, shade_mask, refl_rand, prop_rand,
        any_transmissive=scene.any_transmissive)

    sm = shade_mask[:, None]
    new_origin = torch.where(sm, shaded.origin, carry.origin)
    new_dir = torch.where(sm, shaded.direction, carry.direction)
    atten = torch.where(sm, carry.attenuation * shaded.attenuation,
                        carry.attenuation)

    # Bounce-type counts (compute:796,807)
    onehot = (torch.arange(3, device=shade_mask.device)[None, :]
              == shaded.bounce_type[:, None])
    counts = carry.counts + (sm & onehot).to(torch.int32)

    # Roughness accumulator quirk: scalar += roughness * attenuation.x
    acc_roughness = carry.acc_roughness + torch.where(
        shade_mask, mat.roughness * atten[:, 0], 0.0)

    # --- Russian roulette (compute:923-936): 1/p only on survivors
    if settings.russian_roulette:
        contribution = torch.amax(atten, dim=1)
        killed = shade_mask & (rr_rand > contribution)
        survive = shade_mask & (~killed)
        safe_c = torch.where(survive, torch.clamp_min(contribution, 1e-20),
                             1.0)
        atten = torch.where(survive[:, None], atten / safe_c[:, None], atten)
    else:
        killed = torch.zeros_like(shade_mask)

    # --- miss: sky emission, ray dies (compute:938-946)
    miss = active & (~is_hit)
    if settings.mip_importance_bias:
        level = (settings.env_mip_level
                 + carry.acc_roughness * settings.mip_importance_range)
    else:
        level = torch.full((n,), float(settings.env_mip_level),
                           device=color.device)
    sky = sample_sky(scene, carry.direction, level, settings)
    color = color + torch.where(miss[:, None], sky * carry.attenuation, 0.0)
    miss_attenuation = torch.where(miss[:, None], carry.attenuation,
                                   carry.miss_attenuation)

    # Detached-sampling gradient estimator (trace.py:504-512 of the JAX
    # package): path geometry is fixed in the backward pass, so parameter
    # gradients flow only through throughput weights and emission. Without
    # it roughness would reach the image through the next direction, the
    # next hit's t and Beer-Lambert absorption on exiting hits.
    return carry._replace(
        origin=new_origin.detach(),
        direction=new_dir.detach(),
        attenuation=atten,
        color=color,
        acc_roughness=acc_roughness,
        counts=counts,
        active=active & is_hit & (~killed),
        miss_attenuation=miss_attenuation,
    )


class TraceOut(NamedTuple):
    color: torch.Tensor  # [N, 3]
    miss_attenuation: torch.Tensor  # [N, 3]
    acc_roughness: torch.Tensor  # [N]
    direction: torch.Tensor  # [N, 3] direction after the last bounce


def trace_rays(scene: SceneData, origin: torch.Tensor,
               direction: torch.Tensor, far, sample_idx, seed,
               settings: RenderSettings) -> TraceOut:
    """Lockstep scheduler: a loop over bounces on the full ray pool."""
    check_slice(scene, settings)
    pool = _make_pool(origin, direction, far, sample_idx, seed)
    for k in range(settings.max_bounces + 1):
        pool = _pool_bounce(scene, settings, pool, k)
    return TraceOut(pool.color, pool.miss_attenuation, pool.acc_roughness,
                    pool.direction)


def render_pixels(scene: SceneData, camera: Camera, settings: RenderSettings,
                  frame, pix: torch.Tensor, spp_offset: int = 0,
                  spp_count: int | None = None) -> torch.Tensor:
    """Render flat pixel indices `pix` [n] -> [n, 3] radiance, averaged
    over spp lanes [spp_offset, spp_offset + spp_count)."""
    from halogen_tpu_torch.kernels import megakernel as mk

    w, h = settings.width, settings.height
    n = pix.shape[0]
    spp = settings.samples_per_pixel if spp_count is None else spp_count
    camera = camera.to(pix.device)

    px = pix % w
    py = pix // w
    seed = sob.pixel_seed(pix)
    # The device decides the route: on a CUDA device AUTO and FORCE launch
    # the kernel, which raises for a scene outside its caps; on the CPU,
    # and under OFF, the lockstep integrator runs.
    use_kernel = pix.device.type == "cuda" and settings.fused != Fused.OFF
    if settings.wavefront and not (settings.fused != Fused.OFF
                                   and mk.fused_supported(scene, settings)):
        raise NotImplementedError(
            "the wavefront scheduler is not ported yet (ROADMAP A12)")
    tables = mk._scene_tables(scene) if use_kernel else None

    # Fold spp lanes into the ray axis, pixel-major (all lanes of a pixel
    # adjacent); per-ray results do not depend on the slot.
    max_block = max(1, settings.ray_chunk_size // max(n, 1))
    spp_block = 1
    for cand in range(min(spp, max_block), 0, -1):
        if spp % cand == 0:
            spp_block = cand
            break
    groups = spp // spp_block
    nb = n * spp_block
    pxb = torch.repeat_interleave(px, spp_block)
    pyb = torch.repeat_interleave(py, spp_block)
    seedb = torch.repeat_interleave(seed, spp_block)
    lane = torch.arange(spp_block, device=pix.device).repeat(n)
    farb = camera.far.expand(nb)

    acc = torch.zeros((n, 3), device=pix.device)
    for g in range(groups):
        lanes = (spp_offset + g * spp_block + lane) & sob.MASK32
        sidx = sob.sample_index(frame, lanes, settings.samples_per_pixel)
        o, d = generate_rays(camera, pxb, pyb, w, h, settings.filter_radius,
                             sidx, seedb, _sampler_2d(settings))
        if use_kernel:
            # megakernel forward, adjoint-kernel backward
            col = mk.trace_color_fused_diff(scene, o, d, camera.far, sidx,
                                            seedb, settings, tables=tables)
        else:
            col = trace_rays(scene, o, d, farb, sidx, seedb, settings).color
        acc = acc + col.reshape(n, spp_block, 3).sum(dim=1)
    return acc / spp


@functools.lru_cache(maxsize=8)
def _morton_pixel_order(w: int, h: int):
    """Static Z-order (Morton) permutation of the pixel grid and its
    inverse (numpy). Per-pixel results do not depend on the order."""
    gy, gx = np.mgrid[0:h, 0:w].astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x0000FFFF0000FFFF)
        x = (x | (x << 8)) & np.uint64(0x00FF00FF00FF00FF)
        x = (x | (x << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
        x = (x | (x << 2)) & np.uint64(0x3333333333333333)
        x = (x | (x << 1)) & np.uint64(0x5555555555555555)
        return x

    code = spread(gx) | (spread(gy) << np.uint64(1))
    perm = np.argsort(code.reshape(-1), kind="stable").astype(np.int32)
    inv = np.argsort(perm, kind="stable").astype(np.int32)
    return perm, inv


def render_frame(scene: SceneData, camera: Camera, settings: RenderSettings,
                 frame=0) -> torch.Tensor:
    """Render one frame: [H, W, 3] mean radiance over samples_per_pixel,
    on the scene's device.

    `frame` indexes the progressive-accumulation sample stream. Pixels are
    processed in ray_chunk_size chunks to bound live ray-state memory.
    """
    device = scene.device
    w, h = settings.width, settings.height
    n_pixels = w * h
    if not (isinstance(frame, torch.Tensor) and frame.device.type != "cpu"):
        frame = int(frame) & sob.MASK32

    chunk = min(settings.ray_chunk_size, n_pixels)
    n_chunks = -(-n_pixels // chunk)
    pix, inv = _pixel_order_on(w, h, n_chunks * chunk, device)

    chunks = [render_pixels(scene, camera, settings, frame,
                            pix[c * chunk:(c + 1) * chunk])
              for c in range(n_chunks)]
    img = torch.cat(chunks)[:n_pixels][inv]
    return img.reshape(h, w, 3)


@functools.lru_cache(maxsize=8)
def _pixel_order_on(w: int, h: int, padded: int, device: torch.device):
    """Morton pixel order padded to `padded` entries, and its inverse, as
    int64 tensors on `device` (copied once, not every frame)."""
    perm, inv = _morton_pixel_order(w, h)
    pix = np.concatenate([perm.astype(np.int64),
                          np.arange(w * h, padded, dtype=np.int64)])
    return (torch.from_numpy(pix).to(device),
            torch.from_numpy(inv.astype(np.int64)).to(device))
