"""The reference's inverse-rendering step: the MSE image loss of a frame
against a target, its gradient with respect to the float fields of the
material table by autograd through `tracer.py`, Adam (lr, betas 0.9 and
0.999, eps 1e-8, as `torch.optim.Adam` computes it) and the projection
onto the materials' physical ranges.
"""

from __future__ import annotations

import torch

from .camera import RefCamera
from .scene import MATERIAL_KEYS, RefScene
from .tracer import render_image, sample_colors

# the inspector ranges of HalogenMaterial (RayTracingManager.cs:7-38)
BOUNDS = {"albedo": (0.0, 1.0), "specular": (0.0, 1.0),
          "metallic": (0.0, 1.0), "roughness": (0.0, 1.0),
          "ior": (1.0, 8.0), "absorption": (0.0, None),
          "emissive": (0.0, None)}


def loss_and_grads(scene: RefScene, cam: RefCamera, st: dict,
                   target: torch.Tensor, frame: int, block: int,
                   params: dict, lowp: bool = False,
                   group_rays: int = 1 << 20, rows=slice(None)):
    """(loss, {field: gradient}) of mean((image - target)^2) at `frame`,
    the material fields `params` over the scene's table. The image is
    rendered once without a graph; then each group of lanes is traced
    again under autograd and given its pixels' share of the loss's
    gradient, so no graph outlives a group. `rows` takes the loss's mean
    over those image rows alone (a planted fault: part of the batch left
    out)."""
    table = dict(scene.materials, **params)
    with torch.no_grad():
        img = render_image(scene.with_materials(table), cam, st, frame,
                           block, lowp=lowp)
        loss = torch.mean((img[rows] - target[rows]) ** 2)
        g_img = torch.zeros_like(img)
        g_img[rows] = 2.0 * (img[rows] - target[rows]) / img[rows].numel()
        g_img = g_img.reshape(-1, 3)
    w, h, spp = st["width"], st["height"], st["samples_per_pixel"]
    n = w * h
    dev = target.device
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    sc = scene.with_materials(dict(scene.materials, **leaves))
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
    return float(loss), grads


class Adam:
    """torch.optim.Adam's arithmetic (its single-tensor form)."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: dict, grads: dict) -> dict:
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = 1 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k].lerp_(g, 1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / bc2 ** 0.5).add_(self.eps)
            out[k] = p.addcdiv(self.m[k], denom, value=-self.lr / bc1)
        return out


def project(params: dict) -> dict:
    return {k: (torch.clamp(v, *BOUNDS[k]) if k in BOUNDS else v)
            for k, v in params.items()}


def fit_steps(scene: RefScene, cam: RefCamera, st: dict,
              target: torch.Tensor, block: int, steps: int, lr: float,
              lowp: bool = False, rows=slice(None)) -> dict:
    """`steps` projected Adam steps from the scene's materials, step i on
    frame i: each step's loss, the first step's gradients, the
    parameters after the last step and Adam's state then."""
    params = {k: scene.materials[k].clone() for k in MATERIAL_KEYS}
    opt = Adam(params, lr)
    losses, first = [], None
    for i in range(steps):
        loss, grads = loss_and_grads(scene, cam, st, target, i, block,
                                     params, lowp=lowp, rows=rows)
        losses.append(loss)
        first = grads if first is None else first
        params = project(opt.step(params, grads))
    return {"losses": losses, "grads": first, "params": params,
            "adam": {"m": opt.m, "v": opt.v, "t": opt.t}}


def follow_step(scene: RefScene, cam: RefCamera, st: dict,
                target: torch.Tensor, block: int, frame: int, params: dict,
                adam: dict, lr: float, lowp: bool = False,
                rows=slice(None)) -> dict:
    """One projected Adam step at `frame` from the parameters `params`
    and Adam's state `adam` ({m, v, t}: its moments after t steps), as
    `fit_steps` takes it: its loss, gradients and the parameters after."""
    params = {k: v.clone() for k, v in params.items()}
    opt = Adam(params, lr)
    opt.m = {k: v.clone() for k, v in adam["m"].items()}
    opt.v = {k: v.clone() for k, v in adam["v"].items()}
    opt.t = int(adam["t"])
    loss, grads = loss_and_grads(scene, cam, st, target, frame, block,
                                 params, lowp=lowp, rows=rows)
    return {"losses": [loss], "grads": grads,
            "params": project(opt.step(params, grads))}
