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
- envmap and area-light next-event estimation with MIS, a capability
  beyond the reference (its MIS TODO, compute:19); both may run in one
  bounce, env first, as in the JAX package
- sampler dimensions advance by 5 per bounce (compute:921)

Debug views (albedo, normal, and the ray-triangle and ray-box tests as
heatmaps; trace_ray_debug*, compute:819-863,952-982) render through the
lockstep on every device, the CUDA megakernel never: on the card that is
PyTorch plus the world-BVH traversal kernel above `brute_force_max_tris`,
whose per-ray counts the views read.

Wherever the lockstep runs (the CPU, `Fused.OFF`, the debug views),
`settings.wavefront` selects the wavefront scheduler instead
(`trace_rays_wavefront`): before each bounce the live rays are compacted
to the front of the pool and only their blocks are bounced, for the same
bits; a trace that wants a gradient runs the lockstep instead
(`trace_rays_wavefront_diff`), which gives the same forward bits.
Where the megakernel renders, the flag is ignored.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from halogen_tpu_torch.config import DebugMode, Fused, RenderSettings, SamplerKind
from halogen_tpu_torch.core.math import (
    cross,
    dot,
    procedural_glossy_pdf,
    reflect,
    sqrt,
)
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
from halogen_tpu_torch.scene.lights import sample_light, sphere_cone_pdf
from halogen_tpu_torch.utils.profiling import annotate


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


def _use_light_nee(scene: SceneData, settings: RenderSettings) -> bool:
    """Area-light NEE is on only when the flag is set and the scene has
    emitters (JAX `trace.py:89-92`): with the flag and no emitter a scene
    renders as without the flag."""
    return settings.light_importance_sampling and scene.lights is not None


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
    # MIS state for NEE: was the previous scatter a lobe that env NEE
    # (prev_nee) or area-light NEE (prev_lnee) covers, and its
    # continuation pdf for the direction it took (shared: the same density)
    prev_nee: torch.Tensor  # [N] bool
    prev_lnee: torch.Tensor  # [N] bool
    prev_pcos: torch.Tensor  # [N]
    # The miss record the megakernel also returns: the attenuation at
    # the bounce where the ray missed (0 if it never did), and with env
    # NEE the MIS state it carried there.
    miss_attenuation: torch.Tensor  # [N, 3]
    miss_pcos: torch.Tensor  # [N]
    miss_nee: torch.Tensor  # [N] bool
    # The debug views' state: the intersection tests of every bounce
    # (None unless a debug view is on), and the first segment's hit
    tri_tests: torch.Tensor | None  # [N] int32
    box_tests: torch.Tensor | None  # [N] int32
    first_t: torch.Tensor  # [N]
    first_albedo: torch.Tensor  # [N, 3]
    first_normal: torch.Tensor  # [N, 3]
    sample_idx: torch.Tensor  # [N] uint32 in int64
    seed: torch.Tensor  # [N] uint32 in int64
    far: torch.Tensor  # [N]


def _make_pool(origin, direction, far, sample_idx, seed,
               any_transmissive: bool, counts: bool = False) -> Pool:
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
        prev_lnee=zeros(n, dtype=torch.bool),
        prev_pcos=zeros(n),
        miss_attenuation=zeros(n, 3),
        miss_pcos=zeros(n),
        miss_nee=zeros(n, dtype=torch.bool),
        tri_tests=zeros(n, dtype=torch.int32) if counts else None,
        box_tests=zeros(n, dtype=torch.int32) if counts else None,
        first_t=torch.full((n,), float("inf"), device=dev),
        first_albedo=zeros(n, 3),
        first_normal=zeros(n, 3),
        sample_idx=sob._u32(sample_idx).to(dev).expand(n),
        seed=sob._u32(seed).to(dev).expand(n),
        far=torch.as_tensor(far, dtype=torch.float32, device=dev).expand(n),
    )


_INV_PI = float(np.float32(1.0 / np.pi))
_TWO_PI = float(np.float32(2.0 * np.pi))
_VIS_SCALE = float(np.float32(1.0 - 1e-3))  # trace.py:402


def _pool_bounce(scene: SceneData, settings: RenderSettings, carry: Pool,
                 k: int, tape: list | None = None) -> Pool:
    """One bounce of every ray in `carry` (trace_ray compute:876-950): the
    JAX `_pool_bounce`, with the sky deferred to `deferred_sky`. With
    `tape` (a list) it also appends what the adjoint's transcript records
    of the bounce (`_tape_entry`)."""
    s2 = _sampler_2d(settings)
    s1 = _sampler_1d(settings)
    use_nee = _use_nee(scene, settings)
    use_lnee = _use_light_nee(scene, settings)
    sample_idx, seed, far = carry.sample_idx, carry.seed, carry.far

    # --- per-type termination check at loop top (compute:891-893)
    over = ((carry.counts[:, 0] > settings.max_diffuse_bounces)
            | (carry.counts[:, 1] > settings.max_glossy_bounces)
            | (carry.counts[:, 2] > settings.max_transmission_bounces))
    active = carry.active & (~over)

    # Dead lanes get far = 0; every consumer of their hit is masked.
    far_eff = torch.where(active, far, 0.0)
    tri_tests, box_tests = carry.tri_tests, carry.box_tests
    if tri_tests is None:
        hit = intersect_scene(scene, carry.origin, carry.direction, far_eff,
                              settings)
    else:  # a debug view: every bounce's tests (JAX trace.py:495-496)
        hit, tt, bt = intersect_scene(scene, carry.origin, carry.direction,
                                      far_eff, settings, counts=True)
        tri_tests = tri_tests + torch.where(active, tt, 0)
        box_tests = box_tests + torch.where(active, bt, 0)
    is_hit = active & (hit.t < far)  # compute:898
    mat = gather_materials(scene.materials, hit.material)
    first_t, first_albedo, first_normal = (carry.first_t, carry.first_albedo,
                                           carry.first_normal)
    if k == 0:  # the first segment's hit (JAX trace.py:196-198)
        first_t, first_albedo, first_normal = hit.t, mat.albedo, hit.normal

    # --- emission (compute:901-902). With area-light NEE, emission reached
    # by a continuation that light NEE covered is weighted by the balance
    # heuristic against the light table's solid-angle density at this hit
    # (JAX trace.py:200-229).
    emission = mat.emissive_rgb * mat.emissive_intensity[:, None]
    lit = emission * carry.attenuation
    if use_lnee:
        em_w = emission_weight(scene, carry, hit)
        lit = lit * em_w[:, None]
    color = carry.color + torch.where((active & is_hit)[:, None], lit, 0.0)

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

    # --- next-event estimation + MIS (JAX trace.py:257-432) on opaque
    # lobes: the continuation's solid-angle density is (1 - ps) cos / pi
    # for the diffuse branch plus ps times the procedural glossy lobe's
    # pdf. Mirrors (roughness 0) are a delta: no NEE, continuation weight
    # 1. Pdfs and MIS weights are detached.
    prev_nee, prev_pcos = carry.prev_nee, carry.prev_pcos
    prev_lnee = carry.prev_lnee
    if use_nee or use_lnee:
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

    if use_nee:
        prev_nee = covered
        nu, nv = s2(sample_idx, sob.DIM_ENV_NEE_BASE + stride, seed)
        ldir, lpdf, radiance, texel = sample_env_draw(
            scene.env_cdf, scene.env_mips[0], nu, nv, with_texel=True)
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
        w_fac = w_nee / torch.clamp_min(lpdf, 1e-12)
        contrib = carry.attenuation * f_cos * radiance * w_fac[:, None]
        color = color + torch.where((cand & visible)[:, None], contrib, 0.0)

    if use_lnee:
        prev_lnee = covered
        l_contrib, l_term = light_nee(scene, settings, carry, hit, mat,
                                      surf_lane, far_eff, mix_pdf, ps,
                                      stride)
        color = color + l_contrib

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
    if tape is not None:
        nee = None
        if use_nee:
            lit = cand & visible
            nee = (torch.where(lit, texel, -1), radiance, w_fac,
                   (1.0 - ps) * cos_l * _INV_PI, ps * p_gl_l)
        light = (*l_term, em_w) if use_lnee else None
        tape.append(_tape_entry(scene, carry, hit, shaded, shade_mask,
                                killed, miss, nee, light))
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
        prev_lnee=prev_lnee,
        prev_pcos=prev_pcos,
        miss_attenuation=miss_attenuation,
        miss_pcos=miss_pcos,
        miss_nee=miss_nee,
        tri_tests=tri_tests,
        box_tests=box_tests,
        first_t=first_t,
        first_albedo=first_albedo,
        first_normal=first_normal,
    )


def _tape_entry(scene: SceneData, carry: Pool, hit, shaded, shade_mask,
                killed, miss, nee, light=None) -> dict:
    """What the adjoint's transcript holds of one bounce, per ray
    (detached; `kernels/adjoint.py` `record_transcript_reference` packs
    it): whether it shaded and whether it missed; the attenuation before
    it, the hit distance, the hit material, the Beer material (that of the
    medium the ray came through; the hit's own, exiting it, in opaque
    scenes) and whether Beer-Lambert applied, the BRDF's lobe (spec: the
    drawn lobe was the specular one), whether the bounce refracted or
    passed through a false hit, whether the hit was a true one, whether
    Russian roulette let the path go on; with env NEE `nee` (the texel
    whose radiance reached the hit, -1 none; its radiance, its weight over
    the pdf, the BRDF's diffuse and glossy factors); with area-light NEE
    `light` (whether the light term was added, the light's material, its
    weight over the pdf f, the BRDF's diffuse and glossy factors, and the
    emission's balance weight at the hit)."""
    t_safe = torch.where(torch.isfinite(hit.t), hit.t, 0.0)
    if shaded.medium is None:  # opaque: Beer-Lambert exiting the hit
        absorbing = ~(hit.orientation > 0)
        ab_mat = hit.material
        true_hit = torch.ones_like(shade_mask)
    else:
        absorbing = shaded.medium != -1
        ab_mat = shaded.medium
        true_hit = shaded.true_hit
    entry = dict(shaded=shade_mask, missed=miss,
                 a_prev=carry.attenuation, t=t_safe, mat=hit.material,
                 ab_mat=ab_mat, absorbing=absorbing, spec=shaded.lobe == 1,
                 refr=shaded.bounce_type == 2, true_hit=true_hit,
                 survive=~killed, nee=nee, light=light)
    return {k: (tuple(x.detach() for x in v) if isinstance(v, tuple)
                else None if v is None else v.detach())
            for k, v in entry.items()}


def emission_weight(scene: SceneData, carry: Pool, hit) -> torch.Tensor:
    """[N] balance-heuristic weight of the emission at `hit` under
    area-light NEE (JAX `trace.py:206-228`): the previous continuation's
    pdf against the light table's solid-angle density of the emitter hit
    (a triangle's pdf_area * t^2 / |cos|; a sphere's cone pdf from the
    previous origin), where the previous scatter was a lobe that light NEE
    covers and that density is > 0; else 1."""
    pdf_area = torch.where(
        hit.tri >= 0, scene.tri_light_pdf_area[torch.clamp_min(hit.tri, 0)],
        0.0)
    cos_hit = torch.abs(dot(carry.direction, hit.normal))
    t_safe = torch.where(torch.isfinite(hit.t), hit.t, 0.0)
    pdf_sa = pdf_area * t_safe * t_safe / torch.clamp_min(cos_hit, 1e-6)
    if scene.num_spheres:
        sp = torch.clamp_min(hit.sphere, 0)
        sph_pdf = sphere_cone_pdf(scene.sphere_light_sel[sp],
                                  scene.sphere_center[sp],
                                  scene.sphere_radius[sp], carry.origin)
        pdf_sa = torch.where(hit.sphere >= 0, sph_pdf, pdf_sa)
    w_cont = carry.prev_pcos / torch.clamp_min(carry.prev_pcos + pdf_sa,
                                               1e-12)
    return torch.where(carry.prev_lnee & (pdf_sa > 0.0), w_cont, 1.0)


def light_nee(scene: SceneData, settings: RenderSettings, carry: Pool, hit,
              mat, surf_lane, far_eff, mix_pdf, ps, stride):
    """([N, 3] area-light NEE term of one bounce, its factors) (JAX
    `trace.py:332-431`): one emissive triangle or sphere chosen by the
    power CDF, a point on a triangle by area or a direction in a sphere's
    cone, a shadow ray whose closest hit must be the light itself or lie
    past 0.999 of its distance, and the balance heuristic against the
    continuation pdf. The term is a_prev * (albedo * dterm + specular *
    gterm) * emission(lmat) * f; the factors, detached, are (where it was
    added [N] bool, lmat [N], f = w_l / pdf, dterm, gterm), for the
    adjoint's transcript."""
    s1, s2 = _sampler_1d(settings), _sampler_2d(settings)
    u_sel = s1(carry.sample_idx, sob.DIM_LIGHT_NEE_SEL + stride, carry.seed)
    pu, pv = s2(carry.sample_idx, sob.DIM_LIGHT_NEE_POINT + stride,
                carry.seed)
    ls = sample_light(scene.lights, scene, u_sel, pu, pv)
    is_tri = ls["kind"] == 0

    # triangle branch: the direction to the sampled point
    wi_vec = ls["tri_point"] - hit.pos
    d2 = dot(wi_vec, wi_vec)
    dist_t = sqrt(torch.clamp_min(d2, 1e-12))
    wi_t = wi_vec / dist_t[:, None]
    gn_hat = ls["gn"] / torch.clamp_min(
        sqrt(dot(ls["gn"], ls["gn"])), 1e-12)[:, None]
    cos_l = torch.abs(dot(gn_hat, wi_t))
    pdf_sa_t = ls["pdf_area"] * d2 / torch.clamp_min(cos_l, 1e-6)
    ok_t = (cos_l > 1e-4) & (ls["pdf_area"] > 0.0) & (ls["idx"] != hit.tri)

    # sphere branch: a uniform direction in the subtended cone
    dvec = ls["center"] - hit.pos
    dc2 = dot(dvec, dvec)
    dc = sqrt(torch.clamp_min(dc2, 1e-12))
    dhat = dvec / dc[:, None]
    r = ls["radius"]
    sin2max = r * r / torch.clamp_min(dc2, 1e-12)
    outside = sin2max < 1.0
    cos_max = sqrt(torch.clamp(1.0 - sin2max, 0.0, 1.0))
    cos_th = 1.0 - pu * (1.0 - cos_max)
    sin_th = sqrt(torch.clamp(1.0 - cos_th * cos_th, 0.0, 1.0))
    phi = pv * _TWO_PI
    # orthonormal basis around dhat
    y_up = (torch.abs(dhat[:, 1:2]) < 0.9).to(dhat.dtype)
    up = torch.cat([1.0 - y_up, y_up, torch.zeros_like(y_up)], dim=1)
    tang = cross(up, dhat)
    tang = tang / torch.clamp_min(sqrt(dot(tang, tang)),
                                  1e-12)[:, None]
    bitan = cross(dhat, tang)
    wi_s = (dhat * cos_th[:, None] + tang * (sin_th * torch.cos(phi))[:, None]
            + bitan * (sin_th * torch.sin(phi))[:, None])
    solid = _TWO_PI * (1.0 - cos_max)
    pdf_sa_s = ls["sel"] / torch.clamp_min(solid, 1e-12)
    # distance to the sphere's surface along wi_s
    proj = dc * cos_th
    under = r * r - dc2 * sin_th * sin_th
    dist_s = proj - sqrt(torch.clamp_min(under, 0.0))
    ok_s = outside & (solid > 1e-12) & (ls["idx"] != hit.sphere)

    wi = torch.where(is_tri[:, None], wi_t, wi_s)
    dist = torch.where(is_tri, dist_t, dist_s)
    pdf_sa = torch.where(is_tri, pdf_sa_t, pdf_sa_s)
    ok = torch.where(is_tri, ok_t, ok_s)
    cos_s = dot(hit.normal, wi)
    cand = surf_lane & ok & (cos_s > 0.0)

    # shadow ray: visible iff nothing sits in front of the light, i.e. the
    # closest hit is the light itself or lies past the sampled point (a
    # grazing ray along a shared edge of a triangle light)
    sh_origin = hit.pos + hit.normal * 1e-4
    sh = intersect_scene(scene, sh_origin, wi, far_eff, settings)
    hit_self = torch.where(is_tri, sh.tri == ls["idx"],
                           sh.sphere == ls["idx"])
    visible = hit_self | (sh.t >= dist * _VIS_SCALE)

    lmat = torch.where(
        is_tri,
        scene.tri_material[torch.where(is_tri, ls["idx"], 0)]
        if scene.num_triangles else 0,
        scene.sphere_material[torch.where(is_tri, 0, ls["idx"])]
        if scene.num_spheres else 0).to(torch.int64)
    l_emissive = scene.materials.emissive[lmat]  # [N, 4]
    l_em = l_emissive[:, :3] * l_emissive[:, 3][:, None]
    p_mix, p_gl = mix_pdf(wi, cos_s)
    w_l = pdf_sa / torch.clamp_min(pdf_sa + p_mix, 1e-12)
    dterm = (1.0 - ps) * cos_s * _INV_PI
    gterm = ps * p_gl
    f_cos = mat.albedo * dterm[:, None] + mat.specular * gterm[:, None]
    f = w_l / torch.clamp_min(pdf_sa, 1e-12)
    contrib = carry.attenuation * f_cos * l_em * f[:, None]
    lit = cand & visible
    term = (lit, lmat, f, dterm, gterm)
    return (torch.where(lit[:, None], contrib, 0.0),
            tuple(x.detach() for x in term))


class TraceOut(NamedTuple):
    color: torch.Tensor  # [N, 3] radiance, the sky included
    # [N, 10] per-ray outputs of the megakernel's layout: path color
    # before the sky | miss attenuation | accumulated roughness | final
    # direction; with env NEE [N, 12]: | miss continuation pdf | miss
    # NEE flag
    outputs: torch.Tensor
    # The JAX TraceOut's debug fields. The counts sum the tests of every
    # bounce (the JAX comment says "first segment"; its code adds every
    # bounce's, as here; `first_interaction_only` limits them to the first
    # by setting max_bounces to 0); None unless a debug view is on.
    tri_tests: torch.Tensor | None  # [N] int32
    box_tests: torch.Tensor | None  # [N] int32
    first_hit_t: torch.Tensor  # [N], +inf on a miss
    first_hit_albedo: torch.Tensor  # [N, 3]
    first_hit_normal: torch.Tensor  # [N, 3]

    @property
    def direction(self) -> torch.Tensor:  # [N, 3] after the last bounce
        return self.outputs[:, 7:10]


def trace_rays(scene: SceneData, origin: torch.Tensor,
               direction: torch.Tensor, far, sample_idx, seed,
               settings: RenderSettings, tape: list | None = None
               ) -> TraceOut:
    """Lockstep scheduler: a loop over bounces on the full ray pool, then
    the sky pass. With `tape` (a list) each bounce appends what the
    adjoint's transcript records of it (`_tape_entry`). Under a debug
    view (`settings.debug_mode`) every bounce's intersection tests are
    counted, so every view takes the same intersection route (on the CPU
    a world-BVH intersector's is then the plain walk)."""
    pool = _make_pool(origin, direction, far, sample_idx, seed,
                      scene.any_transmissive,
                      counts=settings.debug_mode != DebugMode.NONE)
    for k in range(settings.max_bounces + 1):
        pool = _pool_bounce(scene, settings, pool, k, tape)
    return _trace_out(scene, settings, pool)


def _trace_out(scene: SceneData, settings: RenderSettings,
               pool: Pool) -> TraceOut:
    """The `TraceOut` of a pool after its last bounce."""
    cols = [pool.color, pool.miss_attenuation, pool.acc_roughness[:, None],
            pool.direction]
    if _use_nee(scene, settings):
        cols += [pool.miss_pcos[:, None],
                 pool.miss_nee.to(torch.float32)[:, None]]
    outputs = torch.cat(cols, dim=1)
    return TraceOut(deferred_sky(scene, settings, outputs), outputs,
                    pool.tri_tests, pool.box_tests, pool.first_t,
                    pool.first_albedo, pool.first_normal)


WAVEFRONT_SYNCS = 0  # the wavefront's host syncs since the count was set to 0


def _pool_rows(fn, *pools: Pool) -> Pool:
    """`fn` over the per-ray tensors of `pools` field by field (the medium
    stack's fields too): a Pool of the results; absent fields stay None."""
    def field(*vs):
        if vs[0] is None:
            return None
        if isinstance(vs[0], MediumStack):
            return MediumStack(*(fn(*(getattr(v, f.name) for v in vs))
                                 for f in dataclasses.fields(MediumStack)))
        return fn(*vs)
    return Pool(*(field(*vs) for vs in zip(*pools)))


def trace_rays_wavefront(scene: SceneData, origin: torch.Tensor,
                         direction: torch.Tensor, far, sample_idx, seed,
                         settings: RenderSettings) -> TraceOut:
    """Wavefront scheduler (the JAX `trace_rays_wavefront`,
    `trace.py:556-637`): before each bounce a stable compaction puts the
    active rays first, in their original order, and only the whole blocks
    of `settings.wavefront_block` rays that hold them are bounced, in one
    `_pool_bounce` call (so on the card one launch of each intersection
    kernel a bounce, on fewer rays); at the end every ray's results go
    back to its slot. The pool is padded to whole blocks with inactive
    lanes (far 0, zero sample index and seed), dropped at the end. Each
    ray sees the lockstep's operations in another slot, so `TraceOut`
    equals `trace_rays`' bit for bit. The number of live blocks is read
    on the host once a bounce (`WAVEFRONT_SYNCS`); a bounce with no live
    ray ends the loop. Forward only: `trace_rays_wavefront_diff` routes
    a trace that wants a gradient to `trace_rays`."""
    global WAVEFRONT_SYNCS
    n = origin.shape[0]
    dev = origin.device
    block = max(min(settings.wavefront_block, n), 1)
    pad = (-n) % block
    far = torch.as_tensor(far, dtype=torch.float32, device=dev).expand(n)
    sample_idx = sob._u32(sample_idx).to(dev).expand(n)
    seed = sob._u32(seed).to(dev).expand(n)
    if pad:
        origin = torch.cat([origin, origin.new_zeros((pad, 3))])
        direction = torch.cat([direction, direction.new_tensor(
            [[0.0, 0.0, 1.0]]).expand(pad, 3)])
        far = torch.cat([far, far.new_zeros(pad)])
        sample_idx = torch.cat([sample_idx, sample_idx.new_zeros(pad)])
        seed = torch.cat([seed, seed.new_zeros(pad)])
    total = n + pad
    pool = _make_pool(origin, direction, far, sample_idx, seed,
                      scene.any_transmissive,
                      counts=settings.debug_mode != DebugMode.NONE)
    slot = torch.arange(total, device=dev)  # the original slot of each ray
    pool = pool._replace(active=slot < n)
    for k in range(settings.max_bounces + 1):
        order = torch.argsort((~pool.active).to(torch.uint8), stable=True)
        pool = _pool_rows(lambda a: a[order], pool)
        slot = slot[order]
        live = -(-int(pool.active.sum()) // block) * block
        WAVEFRONT_SYNCS += 1
        if live == 0:
            break
        sub = _pool_bounce(scene, settings,
                           _pool_rows(lambda a: a[:live], pool), k)
        pool = sub if live == total else _pool_rows(
            lambda a, b: torch.cat([b, a[live:]]), pool, sub)
    back = torch.empty_like(slot)
    back[slot] = torch.arange(total, device=dev)
    return _trace_out(scene, settings,
                      _pool_rows(lambda a: a[back[:n]], pool))


def _requires_grad(obj) -> bool:
    """Whether a tensor of a scene's dataclasses, tuples and lists requires
    a gradient."""
    if isinstance(obj, torch.Tensor):
        return obj.requires_grad
    if dataclasses.is_dataclass(obj):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    return isinstance(obj, (tuple, list)) and any(map(_requires_grad, obj))


def trace_rays_wavefront_diff(scene: SceneData, origin: torch.Tensor,
                              direction: torch.Tensor, far, sample_idx,
                              seed, settings: RenderSettings) -> TraceOut:
    """Differentiable wavefront tracer (the JAX
    `trace_rays_wavefront_diff`, a wavefront forward with the lockstep's
    replay as its backward): `trace_rays_wavefront` where no gradient is
    wanted, else `trace_rays` under autograd. Both forwards give the same
    bits, so the loss is the wavefront's and the gradients the
    lockstep's, from one forward."""
    if torch.is_grad_enabled() and _requires_grad((scene, origin,
                                                   direction)):
        return trace_rays(scene, origin, direction, far, sample_idx, seed,
                          settings)
    return trace_rays_wavefront(scene, origin, direction, far, sample_idx,
                                seed, settings)


def debug_color(out: TraceOut, scene: SceneData, direction: torch.Tensor,
                far: torch.Tensor, settings: RenderSettings) -> torch.Tensor:
    """[N, 3] colour of a debug view (the JAX `_debug_color`,
    `trace.py:688-713`; trace_ray_debug*, compute:819-863,952-982): the
    first hit's albedo, or its normal mapped to [0, 1], or the tests as a
    red (triangles) and blue (boxes) heatmap over the display range,
    white past it. A primary ray that missed (`first_hit_t >= far`) shows
    the sky along `direction` at `env_mip_level`."""
    mode = settings.debug_mode
    hit_mask = (out.first_hit_t < far)[:, None]
    if mode in (DebugMode.ALBEDO, DebugMode.NORMAL):
        level = torch.full(direction.shape[:-1],
                           float(settings.env_mip_level),
                           device=direction.device)
        sky = sample_sky(scene, direction, level, settings)
        if mode == DebugMode.ALBEDO:
            return torch.where(hit_mask, out.first_hit_albedo, sky)
        return torch.where(hit_mask, (out.first_hit_normal + 1.0) * 0.5, sky)
    tri_range = settings.triangle_debug_display_range
    box_range = settings.box_debug_display_range
    tri_n = out.tri_tests.to(torch.float32) / tri_range
    box_n = out.box_tests.to(torch.float32) / box_range
    tri_over = out.tri_tests > tri_range
    box_over = out.box_tests > box_range
    zeros = torch.zeros_like(tri_n)
    if mode == DebugMode.RAY_TRIANGLE_TESTS:
        col, over = torch.stack([tri_n, zeros, zeros], dim=-1), tri_over
    elif mode == DebugMode.RAY_BOX_TESTS:
        col, over = torch.stack([box_n, zeros, zeros], dim=-1), box_over
    else:  # COMBINED
        col = torch.stack([tri_n, zeros, box_n], dim=-1)
        over = tri_over | box_over
    return torch.where(over[:, None], 1.0, col)


def group_rays(camera: Camera, settings: RenderSettings, frame,
               pix: torch.Tensor, lane0: int, spp_block: int):
    """The rays of one group of `render_pixels`: for flat pixel indices
    `pix` [n], lanes lane0 .. lane0 + spp_block - 1 of each pixel's sample
    stream at `frame`, pixel-major (all lanes of a pixel adjacent).
    Returns (origin [N, 3], direction [N, 3], sample_idx [N], seed [N]),
    N = n * spp_block, the integers as uint32 values held in int64.

    This is the plain version of the megakernel's ray prologue
    (`csrc/path_common.cuh` `camera_ray`): a launch from pixels makes the
    same rays in the kernel."""
    w = settings.width
    n = pix.shape[0]
    pixb = torch.repeat_interleave(pix, spp_block)
    lane = torch.arange(spp_block, device=pix.device).repeat(n)
    sidx = sob.sample_index(frame, (lane0 + lane) & sob.MASK32,
                            settings.samples_per_pixel)
    seed = sob.pixel_seed(pixb)
    o, d = generate_rays(camera, pixb % w, pixb // w, w, settings.height,
                         settings.filter_radius, sidx, seed,
                         _sampler_2d(settings))
    return o, d, sidx, seed


def render_pixels(scene: SceneData, camera: Camera, settings: RenderSettings,
                  frame, pix: torch.Tensor, spp_offset: int = 0,
                  spp_count: int | None = None,
                  record: str | None = None) -> torch.Tensor:
    """Render flat pixel indices `pix` [n] -> [n, 3] radiance, averaged
    over spp lanes [spp_offset, spp_offset + spp_count). On the kernel
    route `record` is the adjoint's route for the step this call belongs
    to (`megakernel.grad_route`): whether its launches record the
    adjoint's transcript ('recorded'), leave each group to be recorded
    again in its backward ('rerecord'), or write their rays; None plans
    this call's groups. There all the groups go through one call of the
    chunk node where `megakernel.chunk_serves` says so (no gradient, or
    the 'recorded' route without env NEE), else one node a group."""
    from halogen_tpu_torch.kernels import adjoint as adj
    from halogen_tpu_torch.kernels import megakernel as mk
    from halogen_tpu_torch.kernels import sky

    n = pix.shape[0]
    spp = settings.samples_per_pixel if spp_count is None else spp_count
    camera = camera.to(pix.device)

    # The device decides the route: on a CUDA device AUTO and FORCE launch
    # the kernel, which raises for a scene outside its caps; on the CPU,
    # and under OFF, the lockstep integrator runs. A debug view takes the
    # lockstep on every device, as in the JAX package (its
    # `fused_supported` refuses debug views).
    debug = settings.debug_mode != DebugMode.NONE
    use_kernel = _uses_kernel(pix.device, settings)
    # wherever the lockstep runs, the flag selects the wavefront scheduler
    tracer = trace_rays_wavefront_diff if settings.wavefront else trace_rays

    spp_block = _spp_block(n, spp, settings.ray_chunk_size)
    groups = spp // spp_block

    if use_kernel:
        # megakernel forward, adjoint-kernel backward; the kernel makes
        # each group's rays itself, so a group is one launch (and the sky
        # pass where there is an envmap)
        with annotate("halogen.wrap.prepare"):
            tables = mk._scene_tables(scene)
            env_tab = (mk.env_table(scene) if _use_nee(scene, settings)
                       else None)
            light_tab = (mk.light_table(scene)
                         if _use_light_nee(scene, settings) else None)
            view = mk.pixel_view(camera, settings, frame, pix)
            # the mips that the sky pass reads count too: a gradient of
            # the sky alone still takes a node a group ('rays')
            sky_mips = scene.env_mips if sky.uses_sky(scene, settings) else ()
            want_grad = torch.is_grad_enabled() and any(
                t.requires_grad for t in (*tables, *sky_mips))
            if not want_grad:
                record = None
            elif record is None:
                record = mk.grad_route(scene, settings, tables, pix.device,
                                       n * spp_block, groups)
        if mk.chunk_serves(record, want_grad, adj.env_mode(scene, settings)):
            with annotate("halogen.driver.pixels"):
                return mk.trace_color_chunk(
                    scene, view, spp_offset, spp_block, groups, spp,
                    settings, tables, env_tab, light_tab, record)
    else:
        farb = camera.far.expand(n * spp_block)

    with annotate("halogen.driver.pixels"):
        acc = torch.zeros((n, 3), device=pix.device)
        for g in range(groups):
            lane0 = spp_offset + g * spp_block
            if use_kernel:
                col = mk.trace_color_pixels_diff(
                    scene, view, lane0, spp_block, settings, tables, env_tab,
                    light_tab, record=record)
            else:
                o, d, sidx, seed = group_rays(camera, settings, frame, pix,
                                              lane0, spp_block)
                with annotate("halogen.wrap.lockstep"):
                    out = tracer(scene, o, d, farb, sidx, seed, settings)
                col = (debug_color(out, scene, d, farb, settings) if debug
                       else out.color)
            acc = acc + col.reshape(n, spp_block, 3).sum(dim=1)
        return acc / spp


def _uses_kernel(device: torch.device, settings: RenderSettings) -> bool:
    """Whether `render_pixels` launches the megakernel on `device`."""
    return (device.type == "cuda" and settings.fused != Fused.OFF
            and settings.debug_mode == DebugMode.NONE)


def _spp_block(n: int, spp: int, chunk_size: int) -> int:
    """The spp lanes a group folds into its ray axis, pixel-major (all
    lanes of a pixel adjacent; per-ray results do not depend on the
    slot): the largest divisor of `spp` whose group of `n` pixels fits
    `chunk_size` rays, at least 1."""
    max_block = max(1, chunk_size // max(n, 1))
    for cand in range(min(spp, max_block), 0, -1):
        if spp % cand == 0:
            return cand
    return 1


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
    img = render_pixel_chunks(scene, camera, settings, frame, pix)
    with annotate("halogen.driver.unpermute"):
        return img[:n_pixels][inv].reshape(h, w, 3)


def render_pixel_chunks(scene: SceneData, camera: Camera,
                        settings: RenderSettings, frame, pix: torch.Tensor,
                        spp_offset: int = 0,
                        spp_count: int | None = None) -> torch.Tensor:
    """`render_pixels` over flat pixel indices `pix` [n] in chunks of
    `ray_chunk_size` pixels, to bound live ray-state memory, with one
    adjoint route for all their launches, planned before the first:
    [n, 3]."""
    n = pix.shape[0]
    chunk = min(settings.ray_chunk_size, n)
    n_chunks = -(-n // chunk)
    record = None
    with annotate("halogen.driver.chunks"):
        if _uses_kernel(pix.device, settings):
            from halogen_tpu_torch.kernels import megakernel as mk

            spp = (settings.samples_per_pixel if spp_count is None
                   else spp_count)
            spp_block = _spp_block(chunk, spp, settings.ray_chunk_size)
            record = mk.grad_route(scene, settings, None, pix.device,
                                   chunk * spp_block,
                                   n_chunks * (spp // spp_block))
        return torch.cat([render_pixels(scene, camera, settings, frame,
                                        pix[c * chunk:(c + 1) * chunk],
                                        spp_offset, spp_count, record=record)
                          for c in range(n_chunks)])


@functools.lru_cache(maxsize=8)
def _pixel_order_on(w: int, h: int, padded: int, device: torch.device):
    """Morton pixel order padded to `padded` entries, and its inverse, as
    int64 tensors on `device` (copied once, not every frame)."""
    perm, inv = _morton_pixel_order(w, h)
    pix = np.concatenate([perm.astype(np.int64),
                          np.arange(w * h, padded, dtype=np.int64)])
    return (torch.from_numpy(pix).to(device),
            torch.from_numpy(inv.astype(np.int64)).to(device))
