"""Carry scenes and cameras across as numpy arrays.

`scene_to_numpy` reads the leaves of a `SceneData` by field name (from
this package, or any object with the same field names, such as the JAX
package's `SceneData`) into numpy; `scene_from_numpy` builds this
package's `SceneData` from them. The same pair exists for cameras. The
tests feed one scene to both packages through these.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from halogen_tpu_torch.core.types import MaterialTable, SceneData
from halogen_tpu_torch.integrator.camera import Camera

_MATERIAL_FIELDS = [f.name for f in dataclasses.fields(MaterialTable)]
_SCENE_FIELDS = [f.name for f in dataclasses.fields(SceneData)
                 if f.name not in ("materials", "any_transmissive")]
_CAMERA_FIELDS = [f.name for f in dataclasses.fields(Camera)]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x)


def scene_to_numpy(scene) -> dict:
    """SceneData leaves as numpy: one entry per tensor field, `materials`
    as a dict of the material fields, and `any_transmissive`."""
    out = {name: _np(getattr(scene, name)) for name in _SCENE_FIELDS}
    out["materials"] = {name: _np(getattr(scene.materials, name))
                        for name in _MATERIAL_FIELDS}
    out["any_transmissive"] = bool(scene.any_transmissive)
    return out


def scene_from_numpy(arrays: dict, device="cpu") -> SceneData:
    """Build a `SceneData` on `device` from `scene_to_numpy`'s layout."""
    t = lambda a: torch.from_numpy(np.array(a, order="C")).to(device)
    mats = MaterialTable(**{name: t(arrays["materials"][name])
                            for name in _MATERIAL_FIELDS})
    return SceneData(
        **{name: t(arrays[name]) for name in _SCENE_FIELDS},
        materials=mats,
        any_transmissive=bool(arrays["any_transmissive"]),
    )


def camera_to_numpy(camera) -> dict:
    """Camera leaves as numpy, by field name."""
    return {name: _np(getattr(camera, name)) for name in _CAMERA_FIELDS}


def camera_from_numpy(arrays: dict, device="cpu") -> Camera:
    """Build a `Camera` on `device` from `camera_to_numpy`'s layout."""
    return Camera(**{
        name: torch.from_numpy(
            np.array(arrays[name], np.float32, order="C")).to(device)
        for name in _CAMERA_FIELDS
    })
