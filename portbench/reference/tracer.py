"""The reference path tracer, in plain PyTorch (a frozen copy of the port's
plain lockstep integrator without next-event estimation; the upstream's
`trace_ray`, `HalgoenCompute.compute:876-950`): every ray of a pool
advances one bounce per step under masks; per-type bounce limits at the
loop top; emission before the BRDF; Russian roulette with 1/p on the
survivors; nested dielectrics through the medium stack; the sky at the
miss with the accumulated-roughness mip bias, shaded once per ray after
the loop. Autograd through it gives the detached-sampling gradient: path
geometry is fixed, gradients flow through the throughput weights.

`lowp=True` is the control: the same tracer with its per-ray state (rays,
throughput, radiance) rounded to bfloat16 at the camera and after every
bounce, the precision below the float32 the configurations state.
"""

from __future__ import annotations

import torch

from . import sampler as sob
from .camera import RefCamera, generate_rays
from .intersect import intersect
from .medium import MediumStack
from .scene import RefScene
from .shade import evaluate_material_hit, gather_materials
from .sky import sample_sky

# the upstream's shipped HalogenSettings (RenderSettings' defaults)
DEFAULTS = dict(width=256, height=256, samples_per_pixel=1, max_bounces=12,
                max_diffuse_bounces=4, max_glossy_bounces=4,
                max_transmission_bounces=12, filter_radius=1.0,
                use_envmap=False, env_mip_level=1, mip_importance_bias=True,
                mip_importance_range=8.0, russian_roulette=True)


def settings(overrides: dict) -> dict:
    st = dict(DEFAULTS)
    st.update({k: v for k, v in overrides.items() if k in DEFAULTS})
    return st


def _lowp(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class _Materials:
    """The material table as `gather_materials` reads it."""

    def __init__(self, table: dict):
        for k, v in table.items():
            setattr(self, k, v)


def trace(scene: RefScene, st: dict, origin, direction, far, sample_idx,
          seed, lowp: bool = False, stats: dict | None = None
          ) -> torch.Tensor:
    """[N, 3] radiance of each ray's path, the sky included. `stats`, a
    dict, gains the count of ray-bounce intersections ("isect"), shaded
    bounces ("shaded") and paths that ended at the sky ("sky")."""
    n, dev = origin.shape[0], origin.device
    mats = _Materials(scene.materials)
    if lowp:
        origin, direction = _lowp(origin), _lowp(direction)
    atten = torch.ones((n, 3), device=dev)
    color = torch.zeros((n, 3), device=dev)
    rough = torch.zeros((n,), device=dev)
    counts = torch.zeros((n, 3), dtype=torch.int32, device=dev)
    stack = (MediumStack.create(n, device=dev) if scene.any_transmissive
             else None)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    miss_atten = torch.zeros((n, 3), device=dev)
    for k in range(st["max_bounces"] + 1):
        over = ((counts[:, 0] > st["max_diffuse_bounces"])
                | (counts[:, 1] > st["max_glossy_bounces"])
                | (counts[:, 2] > st["max_transmission_bounces"]))
        active = active & ~over
        hit = intersect(scene, origin, direction,
                        torch.where(active, far, 0.0))
        is_hit = active & (hit.t < far)
        if stats is not None:
            stats["isect"] = stats.get("isect", 0) + active.sum()
            stats["shaded"] = stats.get("shaded", 0) + is_hit.sum()
        mat = gather_materials(mats, hit.material)
        lit = mat.emissive_rgb * mat.emissive_intensity[:, None] * atten
        color = color + torch.where(is_hit[:, None], lit, 0.0)
        stride = sob.BOUNCE_DIM_STRIDE * k
        refl = sob.ld_sample_2d(sample_idx, sob.DIM_ROUGH_REFLECTION + stride,
                                seed)
        prop = sob.ld_sample_2d(sample_idx, sob.DIM_MATERIAL_BRDF + stride,
                                seed)
        rr = sob.ld_sample_1d(sample_idx, sob.DIM_RUSSIAN_ROULETTE + stride,
                              seed)
        shaded = evaluate_material_hit(direction, hit, mat, stack, is_hit,
                                       refl, prop,
                                       any_transmissive=scene.any_transmissive)
        sm = is_hit[:, None]
        new_origin = torch.where(sm, shaded.origin, origin)
        new_dir = torch.where(sm, shaded.direction, direction)
        new_atten = torch.where(sm, atten * shaded.attenuation, atten)
        onehot = (torch.arange(3, device=dev)[None, :]
                  == shaded.bounce_type[:, None])
        counts = counts + (sm & onehot).to(torch.int32)
        # the upstream's scalar accumulator takes the .x of its float3
        rough = rough + torch.where(is_hit, mat.roughness * new_atten[:, 0],
                                    0.0)
        if st["russian_roulette"]:
            c = torch.amax(new_atten, dim=1)
            killed = is_hit & (rr > c)
            survive = is_hit & ~killed
            safe = torch.where(survive, torch.clamp_min(c, 1e-20), 1.0)
            new_atten = torch.where(survive[:, None],
                                    new_atten / safe[:, None], new_atten)
        else:
            killed = torch.zeros_like(is_hit)
        miss = active & ~is_hit
        miss_atten = torch.where(miss[:, None], atten, miss_atten)
        origin, direction = new_origin.detach(), new_dir.detach()
        atten, stack = new_atten, shaded.stack
        active = active & is_hit & ~killed
        if lowp:
            origin, direction = _lowp(origin), _lowp(direction)
            atten, color = _lowp(atten), _lowp(color)
    if not st["use_envmap"] or not scene.env_mips:
        return color
    if stats is not None:
        stats["sky"] = stats.get("sky", 0) + (miss_atten > 0).any(dim=1).sum()
    if st["mip_importance_bias"]:
        level = st["env_mip_level"] + rough * st["mip_importance_range"]
    else:
        level = torch.full_like(rough, float(st["env_mip_level"]))
    sky = sample_sky(scene.env_mips, direction, level) * miss_atten
    return color + (_lowp(sky) if lowp else sky)


def sample_colors(scene: RefScene, cam: RefCamera, st: dict,
                  pixels: torch.Tensor, frames: torch.Tensor,
                  lanes: torch.Tensor, lowp: bool = False,
                  chunk: int = 1 << 21, stats: dict | None = None
                  ) -> torch.Tensor:
    """[N, 3] radiance of the samples (pixel, frame, lane) [N] each: the
    sample index frame * spp + lane, the seed the hash of the flat pixel
    index y * width + x, y up."""
    w, h, spp = st["width"], st["height"], st["samples_per_pixel"]
    out = []
    for s in range(0, pixels.shape[0], chunk):
        pix = pixels[s:s + chunk]
        sidx = sob.sample_index(frames[s:s + chunk], lanes[s:s + chunk], spp)
        seed = sob.pixel_seed(pix)
        o, d = generate_rays(cam, pix % w, pix // w, w, h,
                             st["filter_radius"], sidx, seed)
        far = torch.full((pix.shape[0],), cam.far, device=pix.device)
        out.append(trace(scene, st, o, d, far, sidx, seed, lowp=lowp,
                         stats=stats))
    return torch.cat(out)


def lane_block(n_pixels: int, spp: int, chunk_rays: int) -> int:
    """Lanes of a pixel traced as one group (the largest divisor of spp
    whose group of the chunk's pixels fits `chunk_rays` rays): a frame's
    pixel value sums each group's lanes, then the groups in order."""
    max_block = max(1, chunk_rays // max(n_pixels, 1))
    for cand in range(min(spp, max_block), 0, -1):
        if spp % cand == 0:
            return cand
    return 1


def frame_values(colors: torch.Tensor, spp: int, block: int) -> torch.Tensor:
    """[P, spp, 3] per-lane radiance -> [P, 3] frame value: the sum of
    each block of lanes, the blocks added in order, over spp."""
    p = colors.shape[0]
    acc = torch.zeros((p, 3), device=colors.device)
    for g in range(spp // block):
        lanes = colors[:, g * block:(g + 1) * block].contiguous()
        acc = acc + lanes.sum(dim=1)
    return acc / spp


def accumulate(frames: torch.Tensor) -> torch.Tensor:
    """[F, P, 3] frame values in order -> [P, 3] progressive mean: each
    frame blended in with weight 1 / FrameCount (the upstream's
    `AccumulationShader.shader:27-34`)."""
    acc = torch.zeros(frames.shape[1:], device=frames.device)
    for i in range(frames.shape[0]):
        w = 1.0 / torch.tensor(i + 1, dtype=torch.int32).to(torch.float32)
        acc = acc * (1.0 - w) + frames[i] * w
    return acc


def render_image(scene: RefScene, cam: RefCamera, st: dict, frame: int,
                 block: int, lowp: bool = False,
                 group_rays: int = 1 << 21) -> torch.Tensor:
    """[H, W, 3] frame `frame`: every pixel's lanes summed in groups of
    `block`, the groups in order, over spp."""
    w, h, spp = st["width"], st["height"], st["samples_per_pixel"]
    dev = cam.cam_to_world.device
    n = w * h
    acc = torch.zeros((n, 3), device=dev)
    pix_all = torch.arange(n, device=dev)
    groups_per_call = max(1, group_rays // (n * block))
    g = 0
    while g < spp // block:
        gs = min(groups_per_call, spp // block - g)
        lanes = torch.arange(g * block, (g + gs) * block, device=dev)
        pix = pix_all.repeat_interleave(lanes.shape[0])
        col = sample_colors(scene, cam, st, pix, torch.full_like(pix, frame),
                            lanes.repeat(n), lowp=lowp)
        col = col.reshape(n, gs, block, 3)
        for j in range(gs):
            acc = acc + col[:, j].contiguous().sum(dim=1)
        g += gs
    return (acc / spp).reshape(h, w, 3)
