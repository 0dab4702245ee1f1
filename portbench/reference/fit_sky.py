"""The reference's inverse-rendering step over the materials and the sky:
`fit.py`'s MSE image loss, with the gradient taken with respect to the
float fields of the material table and to every mip of the sky, each mip
its own leaf, by autograd through `tracer.py` and `sky.sample_sky`; then
`fit.py`'s Adam over all of them, its projection of the materials, and
the mips clamped to >= 0 (the port's `fit_materials(optimize_env=True)`).

A parameter dict holds the material fields under `scene.MATERIAL_KEYS`
and the mips under `mip_keys` (`mip0` the finest). A run's check follows
the program's step with the cotangent of the program's image
(`follow_step_sky(..., image=)`), its loss with the reference's own.

Where it departs from the port, the arithmetic and not the result: the
port sums each texel's taps in a fixed order (its sky backward kernels),
the reference by autograd's scatter-add of the gathers, in any order; the
port's Adam is `torch.optim.Adam` (its multi-tensor form on the card),
the reference `fit.Adam`, its single-tensor form. Neither changes a
number past rounding.
"""

from __future__ import annotations

import dataclasses

import torch

from .camera import RefCamera
from .fit import Adam, project
from .scene import MATERIAL_KEYS, RefScene
from .tracer import render_image, sample_colors


def mip_keys(n: int) -> tuple:
    return tuple(f"mip{i}" for i in range(n))


def start_params(scene: RefScene) -> dict:
    """The scene's material fields and mips as one parameter dict."""
    p = {k: scene.materials[k].clone() for k in MATERIAL_KEYS}
    p.update({k: m.clone() for k, m in zip(mip_keys(len(scene.env_mips)),
                                           scene.env_mips)})
    return p


def with_params(scene: RefScene, params: dict) -> RefScene:
    """The scene with the parameters' material fields and mips in place of
    its own."""
    mats = {k: v for k, v in params.items() if k in MATERIAL_KEYS}
    mips = [params.get(k, m) for k, m in zip(mip_keys(len(scene.env_mips)),
                                             scene.env_mips)]
    return dataclasses.replace(scene, materials=dict(scene.materials, **mats),
                               env_mips=mips)


def loss_and_grads(scene: RefScene, cam: RefCamera, st: dict,
                   target: torch.Tensor, frame: int, block: int,
                   params: dict, lowp: bool = False,
                   group_rays: int = 1 << 20, rows=slice(None),
                   image: torch.Tensor | None = None):
    """(loss, {parameter: gradient}, image) of mean((image - target)^2)
    at `frame`, as `fit.loss_and_grads` takes it (the image once without
    a graph, then each group of lanes again under autograd with its
    pixels' share of the loss's gradient), over the material fields and
    mips of `params`. With `image` (a run's: the program's image of the
    step) the pixels' shares are taken at it in place of the reference's
    own image, so that both sides' gradients follow one cotangent: a path
    that parts between the two walks then moves its own taps alone, not
    every sample of its pixel (through a sun of radiance ~2,000, one
    such path moves a pixel by ~30). The loss is the reference's own."""
    with torch.no_grad():
        img = render_image(with_params(scene, params), cam, st, frame, block,
                           lowp=lowp)
        loss = torch.mean((img[rows] - target[rows]) ** 2)
        at = img if image is None else image
        g_img = torch.zeros_like(at)
        g_img[rows] = 2.0 * (at[rows] - target[rows]) / at[rows].numel()
        g_img = g_img.reshape(-1, 3)
    w, h, spp = st["width"], st["height"], st["samples_per_pixel"]
    n = w * h
    dev = target.device
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    sc = with_params(scene, leaves)
    lanes_per_call = max(block, group_rays // n // block * block)
    pix_all = torch.arange(n, device=dev)
    for l0 in range(0, spp, lanes_per_call):
        lanes = torch.arange(l0, min(spp, l0 + lanes_per_call), device=dev)
        pix = pix_all.repeat_interleave(lanes.shape[0])
        with torch.enable_grad():
            col = sample_colors(sc, cam, st, pix, torch.full_like(pix, frame),
                                lanes.repeat(n), lowp=lowp)
            g = (g_img / spp).repeat_interleave(lanes.shape[0], dim=0)
            got = torch.autograd.grad(col, list(leaves.values()), g,
                                      allow_unused=True)
        for k, gk in zip(leaves, got):
            if gk is not None:
                grads[k] += gk
    return float(loss), grads, img


def project_sky(params: dict) -> dict:
    """`fit.project` of the material fields; the mips clamped to >= 0."""
    out = project({k: v for k, v in params.items() if k in MATERIAL_KEYS})
    out.update({k: torch.clamp_min(v, 0.0) for k, v in params.items()
                if k not in MATERIAL_KEYS})
    return out


def adam_step(params: dict, adam: dict, grads: dict, lr: float) -> dict:
    """One projected Adam step from `params` with Adam's state `adam`
    ({m, v, t}) and the gradients `grads`: the parameters after it."""
    opt = Adam(params, lr)
    opt.m = {k: v.clone() for k, v in adam["m"].items()}
    opt.v = {k: v.clone() for k, v in adam["v"].items()}
    opt.t = int(adam["t"])
    return project_sky(opt.step(params, grads))


def fit_steps(scene: RefScene, cam: RefCamera, st: dict,
              target: torch.Tensor, block: int, steps: int, lr: float,
              lowp: bool = False) -> dict:
    """`steps` projected Adam steps from the scene's materials and mips,
    step i on frame i: each step's loss, the first step's gradients, the
    parameters after the last step and Adam's state then."""
    params = start_params(scene)
    opt = Adam(params, lr)
    losses, first = [], None
    for i in range(steps):
        loss, grads, _ = loss_and_grads(scene, cam, st, target, i, block,
                                        params, lowp=lowp)
        losses.append(loss)
        first = grads if first is None else first
        params = project_sky(opt.step(params, grads))
    return {"losses": losses, "grads": first, "params": params,
            "adam": {"m": opt.m, "v": opt.v, "t": opt.t}}


def follow_step_sky(scene: RefScene, cam: RefCamera, st: dict,
                    target: torch.Tensor, block: int, frame: int,
                    params: dict, adam: dict, lr: float, lowp: bool = False,
                    rows=slice(None), image: torch.Tensor | None = None
                    ) -> dict:
    """One projected Adam step at `frame` from the parameters `params`
    (material fields and mips) and Adam's state `adam` ({m, v, t}: its
    moments after t steps), as `fit_steps` takes it (`fit.follow_step`
    with the sky): its loss, gradients, the parameters after, and its
    image. `image`: the image whose loss's gradient to follow
    (`loss_and_grads`)."""
    params = {k: v.clone() for k, v in params.items()}
    loss, grads, img = loss_and_grads(scene, cam, st, target, frame, block,
                                      params, lowp=lowp, rows=rows,
                                      image=image)
    return {"losses": [loss], "grads": grads,
            "params": adam_step(params, adam, grads, lr), "image": img}
