"""Differentiable rendering (PyTorch port of `halogen_tpu/diff/grad.py`).

Autograd through the forward renderer gives the detached-sampling
path-gradient estimator: path geometry and discrete sampling decisions
(lobe choice, Russian-roulette survival, the deterministic Sobol stream)
are fixed (`integrator/trace.py::_pool_bounce` detaches origin and
direction), and gradients flow through the throughput product: emission,
albedo and specular attenuation and Beer-Lambert absorption. Metallic
and IOR act only through sampling decisions, so their gradients are
exactly zero; so are roughness's, but where the sky's lookup takes its
mip level from the accumulated roughness (`mip_importance_bias`).

On a CUDA device each ray group's backward is the adjoint kernel
(`kernels/adjoint.py`): where the step's records fit the record budget
the forward launch records each path's transcript and the backward
sweeps it; past the budget the backward replays the paths from their
rays. A step never keeps a graph of every bounce. On the CPU and under
`Fused.OFF` autograd runs through the lockstep integrator. With
area-light NEE, which no replay kernel covers, the card's backward is
the sweep (B2+l): the forward records the light term's factors beside the
transcript, and the sweep gives d emission of each drawn light's material
and d albedo and d specular of the shaded one. Past the budget such a
step records nothing forward, and each group's backward runs the
recording forward again on the same pixels, sweeps and drops the record
('rerecord', `adjoint.record_plan`): the record route's bits, one
launch's record alive. `adjoint.RECORD_BUDGET` forces a route: None (a
quarter of the card) records where the step fits, a budget of one
launch's record rerecords, 0 replays (light NEE then raises: not even
one launch's record fits).

Envmap texels are parameters too (`"env_mips"`, a tuple of [H, W, 3] mips,
finest first): they reach the image through the sky at the miss and, with
env NEE, through the radiance of the drawn texel. On a CUDA device their
cotangents come from the sky pass's backward kernel (`kernels/sky.py`),
which sums every ray's taps per texel in a fixed order.

A fit's state is saved in the JAX package's npz layout, so a fit started
there resumes here. A fit over a `parallel.sharding` mesh takes each
step's gradient from `loss_and_grads_sharded`, summed over the mesh's
ranks, with the same optimizer and projection.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from halogen_tpu_torch.config import RenderSettings
from halogen_tpu_torch.core.types import MaterialTable, SceneData
from halogen_tpu_torch.integrator.camera import Camera
from halogen_tpu_torch.integrator.trace import render_frame
from halogen_tpu_torch.utils.profiling import annotate

# Differentiable (float) fields of the material table; priority is a
# structural int32 and stays out of the optimization surface.
FLOAT_MATERIAL_FIELDS = (
    "albedo", "specular", "metallic", "roughness", "emissive", "ior",
    "absorption",
)

# Physical ranges (the inspector ranges of HalogenMaterial,
# RayTracingManager.cs:7-38); None is unbounded.
_BOUNDS = {
    "albedo": (0.0, 1.0),
    "specular": (0.0, 1.0),
    "metallic": (0.0, 1.0),
    "roughness": (0.0, 1.0),
    "ior": (1.0, 8.0),
    "absorption": (0.0, None),
    "emissive": (0.0, None),
}


def render_with_materials(materials: MaterialTable, scene: SceneData,
                          camera: Camera, settings: RenderSettings,
                          frame=0) -> torch.Tensor:
    """Forward render as a function of the differentiable material table."""
    scene = dataclasses.replace(scene, materials=materials)
    return render_frame(scene, camera, settings, frame)


def render_with_params(params: dict, scene: SceneData, camera: Camera,
                       settings: RenderSettings, frame=0) -> torch.Tensor:
    """Forward render over a param dict {"materials": MaterialTable,
    "env_mips": tuple of [H, W, 3] mips}, the full differentiable surface.
    The env-NEE alias tables (`scene.env_cdf`) stay as built; the draw's
    radiance is read from the given finest mip."""
    scene = dataclasses.replace(
        scene, env_mips=tuple(params.get("env_mips", scene.env_mips)))
    return render_with_materials(params.get("materials", scene.materials),
                                 scene, camera, settings, frame)


def render_loss(params: dict, scene: SceneData, camera: Camera,
                settings: RenderSettings, target, frame=0) -> torch.Tensor:
    """MSE image loss against a target render or photo."""
    img = render_with_params(params, scene, camera, settings, frame)
    target = torch.as_tensor(target, dtype=img.dtype, device=img.device)
    return torch.mean((img - target) ** 2)


def render_loss_grad(params: dict, scene: SceneData, camera: Camera,
                     settings: RenderSettings, target, frame=0):
    """(loss, grads) of `render_loss` with respect to params
    {"materials": MaterialTable} and, where given, {"env_mips": tuple}.
    grads["materials"] is a MaterialTable of float gradients, with int32
    zeros for priority (JAX's float0); grads["env_mips"] a tuple of one
    cotangent per mip."""
    mats = params.get("materials", scene.materials)
    leaves = {f: getattr(mats, f).detach().requires_grad_(True)
              for f in FLOAT_MATERIAL_FIELDS}
    env = ([m.detach().requires_grad_(True) for m in params["env_mips"]]
           if "env_mips" in params else None)
    with torch.enable_grad():
        p = {"materials": with_material_params(mats, leaves)}
        if env is not None:
            p["env_mips"] = tuple(env)
        loss = render_loss(p, scene, camera, settings, target, frame)
        wrt = list(leaves.values()) + (env or [])
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    grads = [torch.zeros_like(x) if gx is None else gx
             for x, gx in zip(wrt, grads)]
    g_mats = dataclasses.replace(mats, **dict(zip(leaves, grads)),
                                 priority=torch.zeros_like(mats.priority))
    out = {"materials": g_mats}
    if env is not None:
        out["env_mips"] = tuple(grads[len(leaves):])
    return loss.detach(), out


def material_params(materials: MaterialTable) -> dict:
    """Float-only param dict for optimizers."""
    return {f: getattr(materials, f) for f in FLOAT_MATERIAL_FIELDS}


def with_material_params(materials: MaterialTable,
                         params: dict) -> MaterialTable:
    return dataclasses.replace(materials, **params)


def project_material_params(params: dict) -> dict:
    """Clamp a float-material param dict to physical ranges. Keeps
    gradient descent inside the domain where the estimator is stable
    (negative albedo flips Russian-roulette weights into 1/p explosions).
    Returns new tensors; the inputs are not changed."""
    p = dict(params)
    with torch.no_grad():
        for f, (lo, hi) in _BOUNDS.items():
            if f in p:
                p[f] = torch.clamp(p[f], lo, hi)
    return p


def make_optimizer(lr: float = 5e-2):
    """Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8), as a
    factory: `make_optimizer(lr)(tensors)`."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8)


def _leaves(tree) -> list:
    """Tensors of nested dicts (in sorted-key order) and sequences, as
    `jax.tree.leaves` flattens dicts and tuples."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_fit_state(path: str, params, optimizer: torch.optim.Adam,
                   step: int) -> None:
    """Checkpoint a fit in the JAX package's npz layout: `step`, then
    `leaf_i` for the param tensors (sorted keys), Adam's step count
    (optax `count`, int32), `exp_avg` (optax `mu`) and `exp_avg_sq`
    (optax `nu`), each in the params' order."""
    leaves = _leaves(params)
    state = [optimizer.state.get(p, {}) for p in leaves]
    count = max((int(s["step"]) for s in state if "step" in s), default=0)
    moment = lambda s, p, key: _np(s[key]) if key in s else np.zeros(
        tuple(p.shape), np.float32)
    arrays = ([_np(p) for p in leaves] + [np.int32(count)]
              + [moment(s, p, "exp_avg") for s, p in zip(state, leaves)]
              + [moment(s, p, "exp_avg_sq") for s, p in zip(state, leaves)])
    np.savez(path, step=np.int64(step),
             **{f"leaf_{i}": a for i, a in enumerate(arrays)})


def load_fit_state(path: str, params, optimizer: torch.optim.Adam):
    """Restore (params, optimizer, step) from `save_fit_state`'s layout,
    the port's or the JAX package's: the values go into the given param
    tensors in place and into the optimizer's state for them."""
    data = np.load(path)
    leaves = _leaves(params)
    n = len(leaves)
    count = int(data[f"leaf_{n}"])
    with torch.no_grad():
        for i, p in enumerate(leaves):
            p.copy_(torch.from_numpy(data[f"leaf_{i}"]))
            optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": torch.from_numpy(
                    data[f"leaf_{n + 1 + i}"]).to(p),
                "exp_avg_sq": torch.from_numpy(
                    data[f"leaf_{2 * n + 1 + i}"]).to(p),
            }
    return params, optimizer, int(data["step"])


def fit_materials(scene: SceneData, camera: Camera,
                  settings: RenderSettings, target, steps: int = 100,
                  lr: float = 5e-2, optimize_env: bool = False,
                  callback=None, checkpoint_path: str | None = None,
                  checkpoint_every: int = 25, mesh=None):
    """Inverse-rendering loop: fit the float material parameters (and,
    with `optimize_env`, the envmap's mips) to a target image with Adam and
    projection onto physical ranges (texels onto >= 0). Returns
    ({"materials": MaterialTable[, "env_mips": tuple]}, losses). Each step
    renders another frame of the sample stream; env NEE draws by the alias
    tables as built and reads the radiance of the current finest mip. When
    `checkpoint_path` exists the run resumes from it; progress is saved
    every `checkpoint_every` steps. `mesh`: a (px, spp) mesh of
    `parallel.sharding` (every rank of it runs the fit): each step's
    gradient is `loss_and_grads_sharded`'s, the materials and mips
    replicated (the JAX `fit_materials`, `grad.py:204-215`)."""

    params = {"material_params": {
        f: t.detach().clone().requires_grad_(True)
        for f, t in material_params(scene.materials).items()}}
    if optimize_env:
        params["env_mips"] = [m.detach().clone().requires_grad_(True)
                              for m in scene.env_mips]
    opt = make_optimizer(lr)(_leaves(params))

    def to_render_params(p):
        out = {"materials": with_material_params(scene.materials,
                                                 p["material_params"])}
        if "env_mips" in p:
            out["env_mips"] = tuple(p["env_mips"])
        return out

    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        params, opt, start = load_fit_state(checkpoint_path, params, opt)

    losses = []
    for i in range(start, steps):
        with annotate("halogen.loop.step", i):
            opt.zero_grad(set_to_none=True)
            if mesh is None:
                with annotate("halogen.loop.forward"):
                    loss = render_loss(to_render_params(params), scene,
                                       camera, settings, target, i)
                with annotate("halogen.loop.backward"):
                    loss.backward()
            else:
                from halogen_tpu_torch.parallel.sharding import (
                    loss_and_grads_sharded,
                )

                loss, grads = loss_and_grads_sharded(
                    params, scene, camera, settings, target, i, mesh)
                for p, g in zip(_leaves(params), _leaves(grads)):
                    p.grad = g
            with annotate("halogen.loop.adam"):
                opt.step()
            # Projected gradient descent: stay inside the physical domain.
            mp = params["material_params"]
            with annotate("halogen.loop.project"), torch.no_grad():
                for f, v in project_material_params(mp).items():
                    mp[f].copy_(v)
                for m in params.get("env_mips", ()):
                    m.clamp_(min=0.0)
            with annotate("halogen.loop.sync"):
                losses.append(float(loss.detach()))
        if callback is not None:
            callback(i, params, losses[-1])
        if checkpoint_path and (i + 1) % checkpoint_every == 0:
            save_fit_state(checkpoint_path, params, opt, i + 1)
    if checkpoint_path and losses:
        save_fit_state(checkpoint_path, params, opt, steps)
    fitted = {"material_params": {
        f: t.detach() for f, t in params["material_params"].items()}}
    if optimize_env:
        fitted["env_mips"] = [m.detach() for m in params["env_mips"]]
    return to_render_params(fitted), losses
