"""Carry scenes and cameras across as numpy arrays.

`scene_to_numpy` reads the leaves of a `SceneData` by field name (from
this package, or any object with the same field names, such as the JAX
package's `SceneData`) into numpy; `scene_from_numpy` builds this
package's `SceneData` from them, on the card unless the caller asks for
the CPU. The per-mesh BVH arrays travel with the triangles; the world BVH
is derived data in another layout in each package (`WorldBVH` here, the
TPU's [R, 128] rows there), so `scene_from_numpy` builds it anew from the
world triangles with the JAX package's own `build_bvh` call, which gives
the same tree. The same pair exists for cameras, and
`material_table_to_numpy` reads material gradients. The tests feed one
scene to both packages, and compare their gradients, through these.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from halogen_tpu_torch.core.types import MaterialTable, SceneData, target_device
from halogen_tpu_torch.integrator.camera import Camera
from halogen_tpu_torch.scene.envmap import EnvCDF
from halogen_tpu_torch.scene.scene import pack_world_bvh

_MATERIAL_FIELDS = [f.name for f in dataclasses.fields(MaterialTable)]
# the tensor fields; the envmap's mips (a tuple) and alias tables (a
# NamedTuple, or None) are carried on their own, the world BVH is rebuilt
_SCENE_FIELDS = [f.name for f in dataclasses.fields(SceneData)
                 if f.name not in ("materials", "env_mips", "env_cdf",
                                   "any_transmissive", "wbvh")]
_CAMERA_FIELDS = [f.name for f in dataclasses.fields(Camera)]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x)


def material_table_to_numpy(table) -> dict:
    """MaterialTable leaves as numpy, by field name: a scene's materials,
    or the gradients `render_loss_grad` returns for them (either
    package's)."""
    return {name: _np(getattr(table, name)) for name in _MATERIAL_FIELDS}


def scene_to_numpy(scene) -> dict:
    """SceneData leaves as numpy: one entry per tensor field, `materials`
    as a dict of the material fields, `env_mips` as a tuple of arrays,
    `env_cdf` as a dict of the alias-table fields (or None), and
    `any_transmissive`."""
    out = {name: _np(getattr(scene, name)) for name in _SCENE_FIELDS}
    out["materials"] = material_table_to_numpy(scene.materials)
    out["env_mips"] = tuple(_np(m) for m in scene.env_mips)
    cdf = scene.env_cdf
    out["env_cdf"] = None if cdf is None else {
        name: _np(getattr(cdf, name)) for name in EnvCDF._fields}
    out["any_transmissive"] = bool(scene.any_transmissive)
    return out


def scene_from_numpy(arrays: dict, device="cuda") -> SceneData:
    """Build a `SceneData` on `device` from `scene_to_numpy`'s layout,
    with its world BVH (the default `max_leaf`)."""
    device = target_device(device)
    t = lambda a: torch.from_numpy(np.array(a, order="C")).to(device)
    mats = MaterialTable(**{name: t(arrays["materials"][name])
                            for name in _MATERIAL_FIELDS})
    cdf = arrays["env_cdf"]
    return SceneData(
        **{name: t(arrays[name]) for name in _SCENE_FIELDS},
        materials=mats,
        env_mips=tuple(t(m) for m in arrays["env_mips"]),
        env_cdf=None if cdf is None else EnvCDF(
            **{name: t(cdf[name]) for name in EnvCDF._fields}),
        any_transmissive=bool(arrays["any_transmissive"]),
        wbvh=pack_world_bvh(arrays["tri_verts_world"],
                            arrays["tri_normals_world"],
                            arrays["tri_material"], device=device)
        if len(arrays["tri_verts_world"]) else None,
    )


def camera_to_numpy(camera) -> dict:
    """Camera leaves as numpy, by field name."""
    return {name: _np(getattr(camera, name)) for name in _CAMERA_FIELDS}


def camera_from_numpy(arrays: dict, device="cuda") -> Camera:
    """Build a `Camera` on `device` from `camera_to_numpy`'s layout."""
    device = target_device(device)
    return Camera(**{
        name: torch.from_numpy(
            np.array(arrays[name], np.float32, order="C")).to(device)
        for name in _CAMERA_FIELDS
    })
