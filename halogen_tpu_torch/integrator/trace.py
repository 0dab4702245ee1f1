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
- nested dielectrics through the per-ray medium stack (core/medium.py,
  integrator/shade.py)
- miss -> sky lookup with the accumulated-roughness mip bias, including
  the float3->float truncation quirk of the roughness accumulator
  (compute:911 adds `roughness * lightAttenuation` to a scalar: .x wins),
  shaded once per ray after the loop (`deferred_sky`), as the megakernel
  route does
- envmap next-event estimation with MIS, a capability beyond the
  reference (its MIS TODO, compute:19)
- sampler dimensions advance by 5 per bounce (compute:921)

Area-light next-event estimation and debug views raise
NotImplementedError naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from halogen_tpu_torch.config import DebugMode, Fused, RenderSettings, SamplerKind
from halogen_tpu_torch.core.math import dot, procedural_glossy_pdf, reflect
from halogen_tpu_torch.core.medium import MediumStack
from halogen_tpu_torch.core.types import SceneData
from halogen_tpu_torch.integrator.camera import Camera, generate_rays
from halogen_tpu_torch.integrator.intersect import intersect_scene
from halogen_tpu_torch.integrator.shade import (
    evaluate_material_hit,
    gather_materials,
)
from halogen_tpu_torch.sampler import sobol as sob
from halogen_tpu_torch.scene.envmap import (
    env_pdf,
    sample_env_draw,
    sample_env_packed,
)


def _sampler_2d(settings: RenderSettings):
    if settings.sampler == SamplerKind.PRNG:
        return sob.prng_sample_2d
    return sob.ld_sample_2d


def _sampler_1d(settings: RenderSettings):
    if settings.sampler == SamplerKind.PRNG:
        return sob.prng_sample_1d
    return sob.ld_sample_1d


def _use_nee(scene: SceneData, settings: RenderSettings) -> bool:
    """Envmap NEE is on only when the flag, the map and its alias tables
    are all present (JAX `trace.py:78-86`)."""
    return (settings.use_envmap and settings.env_importance_sampling
            and scene.env_cdf is not None and bool(scene.env_mips))


def check_slice(scene: SceneData, settings: RenderSettings) -> None:
    """Raise NotImplementedError for what the port does not have yet."""
    missing = []
    if settings.light_importance_sampling:
        missing.append("area-light next-event estimation (ROADMAP A8)")
    if settings.debug_mode != DebugMode.NONE:
        missing.append("debug views (ROADMAP A8)")
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing))


def sample_sky(scene: SceneData, direction: torch.Tensor, level,
               settings: RenderSettings) -> torch.Tensor:
    """Environment lookup (sample_sky, compute:196-204): black when no
    envmap is bound."""
    if not settings.use_envmap or not scene.env_mips:
        return torch.zeros(direction.shape[:-1] + (3,),
                           device=direction.device)
    return sample_env_packed(scene.env_mips, direction, level)


def deferred_sky(scene: SceneData, settings: RenderSettings,
                 outputs: torch.Tensor) -> torch.Tensor:
    """[N, 3] radiance from the per-ray outputs of a path (`TraceOut`'s
    and the megakernel's layout): the path's color plus the sky at the
    miss (trace_ray compute:938-946), looked up at the recorded direction
    with the accumulated-roughness mip bias and, with env NEE, weighted by
    the balance heuristic against the recorded continuation pdf.

    A ray misses at most once, at its death, so the sky is shaded once
    per ray after the loop: the same operations on the same values as the
    JAX lockstep's in-loop lookup (`trace.py:460-482`: direction, level,
    attenuation and weight at the miss; nothing is added to a dead
    ray)."""
    color = outputs[:, 0:3]
    if not settings.use_envmap or not scene.env_mips:
        return color
    matten, rough, m_dir = outputs[:, 3:6], outputs[:, 6], outputs[:, 7:10]
    if settings.mip_importance_bias:
        # float level -> trilinear inter-mip blend (compute:940-945)
        level = settings.env_mip_level + rough * settings.mip_importance_range
    else:
        level = torch.full_like(rough, float(settings.env_mip_level))
    sky = sample_sky(scene, m_dir, level, settings) * matten
    if _use_nee(scene, settings):
        sky = sky * env_mis_weight(scene, outputs)[:, None]
    return color + sky


def env_mis_weight(scene: SceneData, outputs: torch.Tensor) -> torch.Tensor:
    """[N] balance-heuristic weight of the sky at the miss, with env NEE:
    the recorded continuation pdf (output 10) against the env draw's pdf
    of the recorded direction, where the last scatter was a lobe that NEE
    covers (output 11), else 1."""
    m_pcos, m_nee = outputs[:, 10], outputs[:, 11]
    pe = env_pdf(scene.env_cdf, outputs[:, 7:10])
    return torch.where(m_nee > 0.5,
                       m_pcos / torch.clamp_min(m_pcos + pe, 1e-12), 1.0)


class Pool(NamedTuple):
    """Per-ray SoA state advanced by `_pool_bounce`."""

    origin: torch.Tensor  # [N, 3]
    direction: torch.Tensor  # [N, 3]
    attenuation: torch.Tensor  # [N, 3]
    color: torch.Tensor  # [N, 3] gathered along the path, sky excluded
    acc_roughness: torch.Tensor  # [N]
    counts: torch.Tensor  # [N, 3] bounce-type counts
    stack: MediumStack | None  # None in opaque scenes
    active: torch.Tensor  # [N] bool
    # MIS state for env NEE: was the previous scatter an NEE-covered lobe,
    # and its continuation pdf for the direction it took
    prev_nee: torch.Tensor  # [N] bool
    prev_pcos: torch.Tensor  # [N]
    # The miss record the megakernel also returns: the attenuation at
    # the bounce where the ray missed (0 if it never did), and with env
    # NEE the MIS state it carried there.
    miss_attenuation: torch.Tensor  # [N, 3]
    miss_pcos: torch.Tensor  # [N]
    miss_nee: torch.Tensor  # [N] bool
    sample_idx: torch.Tensor  # [N] uint32 in int64
    seed: torch.Tensor  # [N] uint32 in int64
    far: torch.Tensor  # [N]


def _make_pool(origin, direction, far, sample_idx, seed,
               any_transmissive: bool) -> Pool:
    n = origin.shape[0]
    dev = origin.device
    zeros = lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype,
                                                        device=dev)
    return Pool(
        origin=origin,
        direction=direction,
        attenuation=torch.ones((n, 3), device=dev),
        color=zeros(n, 3),
        acc_roughness=zeros(n),
        counts=zeros(n, 3, dtype=torch.int32),
        stack=MediumStack.create(n, device=dev) if any_transmissive else None,
        active=torch.ones((n,), dtype=torch.bool, device=dev),
        prev_nee=zeros(n, dtype=torch.bool),
        prev_pcos=zeros(n),
        miss_attenuation=zeros(n, 3),
        miss_pcos=zeros(n),
        miss_nee=zeros(n, dtype=torch.bool),
        sample_idx=sob._u32(sample_idx).to(dev).expand(n),
        seed=sob._u32(seed).to(dev).expand(n),
        far=torch.as_tensor(far, dtype=torch.float32, device=dev).expand(n),
    )


_INV_PI = float(np.float32(1.0 / np.pi))


def _pool_bounce(scene: SceneData, settings: RenderSettings, carry: Pool,
                 k: int) -> Pool:
    """One bounce of every ray in `carry` (trace_ray compute:876-950): the
    JAX `_pool_bounce` without area-light NEE and debug views, and with
    the sky deferred to `deferred_sky`."""
    s2 = _sampler_2d(settings)
    s1 = _sampler_1d(settings)
    use_nee = _use_nee(scene, settings)
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
        carry.direction, hit, mat, carry.stack, shade_mask, refl_rand,
        prop_rand, any_transmissive=scene.any_transmissive)

    sm = shade_mask[:, None]
    new_origin = torch.where(sm, shaded.origin, carry.origin)
    new_dir = torch.where(sm, shaded.direction, carry.direction)
    atten = torch.where(sm, carry.attenuation * shaded.attenuation,
                        carry.attenuation)

    # --- envmap next-event estimation + MIS (JAX trace.py:257-330) on
    # opaque lobes: the continuation's solid-angle density is
    # (1 - ps) cos / pi for the diffuse branch plus ps times the
    # procedural glossy lobe's pdf. Mirrors (roughness 0) are a delta:
    # no NEE, continuation weight 1. Pdfs and MIS weights are detached.
    prev_nee, prev_pcos = carry.prev_nee, carry.prev_pcos
    if use_nee:
        surf_lane = shade_mask & (mat.alpha >= 1.0)
        ps = shaded.spec_prob.detach()
        a2 = (mat.roughness * mat.roughness).detach()
        mirror = reflect(carry.direction, hit.normal).detach()

        def mix_pdf(wdir, cos_w):
            p_gl = procedural_glossy_pdf(wdir, mirror, a2, hit.normal)
            return ((1.0 - ps) * torch.clamp_min(cos_w, 0.0) * _INV_PI
                    + ps * p_gl).detach(), p_gl.detach()

        cos_nd = dot(hit.normal, new_dir)
        covered = (surf_lane & (cos_nd > 0.0) & (shaded.bounce_type != 2)
                   & ~((shaded.bounce_type == 1)
                       & (a2 <= float(np.float32(1e-6)))))
        prev_pcos = torch.where(covered, mix_pdf(new_dir, cos_nd)[0], 0.0)
        prev_nee = covered

        nu, nv = s2(sample_idx, sob.DIM_ENV_NEE_BASE + stride, seed)
        ldir, lpdf, radiance = sample_env_draw(
            scene.env_cdf, scene.env_mips[0], nu, nv)
        cos_l = dot(hit.normal, ldir)
        cand = surf_lane & (cos_l > 0.0) & (lpdf > float(np.float32(1e-12)))
        sh_origin = hit.pos + hit.normal * 1e-4
        sh_hit = intersect_scene(scene, sh_origin, ldir, far_eff, settings)
        visible = sh_hit.t >= far
        # the radiance is the exact texel the pdf tables describe
        # (trace.py:306-311), never a filtered mip
        p_mix_l, p_gl_l = mix_pdf(ldir, cos_l)
        f_cos = (mat.albedo * ((1.0 - ps) * cos_l * _INV_PI)[:, None]
                 + mat.specular * (ps * p_gl_l)[:, None])
        w_nee = lpdf / (lpdf + p_mix_l)
        contrib = (carry.attenuation * f_cos * radiance
                   * (w_nee / torch.clamp_min(lpdf, 1e-12))[:, None])
        color = color + torch.where((cand & visible)[:, None], contrib, 0.0)

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

    # --- miss: the ray dies; record what the sky pass needs
    miss = active & (~is_hit)
    miss_attenuation = torch.where(miss[:, None], carry.attenuation,
                                   carry.miss_attenuation)
    miss_pcos = torch.where(miss, carry.prev_pcos, carry.miss_pcos)
    miss_nee = torch.where(miss, carry.prev_nee, carry.miss_nee)

    # Detached-sampling gradient estimator (trace.py:504-512 of the JAX
    # package): path geometry is fixed in the backward pass, so parameter
    # gradients flow only through throughput weights and emission. Without
    # it roughness would reach the image through the next direction, the
    # next hit's t and Beer-Lambert absorption on exiting hits. The medium
    # stack is not detached: its absorption slots carry d absorption to
    # the medium's material.
    return carry._replace(
        origin=new_origin.detach(),
        direction=new_dir.detach(),
        attenuation=atten,
        color=color,
        acc_roughness=acc_roughness,
        counts=counts,
        stack=shaded.stack,
        active=active & is_hit & (~killed),
        prev_nee=prev_nee,
        prev_pcos=prev_pcos,
        miss_attenuation=miss_attenuation,
        miss_pcos=miss_pcos,
        miss_nee=miss_nee,
    )


class TraceOut(NamedTuple):
    color: torch.Tensor  # [N, 3] radiance, the sky included
    # [N, 10] per-ray outputs of the megakernel's layout: path color
    # before the sky | miss attenuation | accumulated roughness | final
    # direction; with env NEE [N, 12]: | miss continuation pdf | miss
    # NEE flag
    outputs: torch.Tensor

    @property
    def direction(self) -> torch.Tensor:  # [N, 3] after the last bounce
        return self.outputs[:, 7:10]


def trace_rays(scene: SceneData, origin: torch.Tensor,
               direction: torch.Tensor, far, sample_idx, seed,
               settings: RenderSettings) -> TraceOut:
    """Lockstep scheduler: a loop over bounces on the full ray pool, then
    the sky pass."""
    check_slice(scene, settings)
    pool = _make_pool(origin, direction, far, sample_idx, seed,
                      scene.any_transmissive)
    for k in range(settings.max_bounces + 1):
        pool = _pool_bounce(scene, settings, pool, k)
    cols = [pool.color, pool.miss_attenuation, pool.acc_roughness[:, None],
            pool.direction]
    if _use_nee(scene, settings):
        cols += [pool.miss_pcos[:, None],
                 pool.miss_nee.to(torch.float32)[:, None]]
    outputs = torch.cat(cols, dim=1)
    return TraceOut(deferred_sky(scene, settings, outputs), outputs)


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
    env_tab = (mk.env_table(scene) if use_kernel and _use_nee(scene, settings)
               else None)

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
                                            seedb, settings, tables=tables,
                                            env_tab=env_tab)
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
