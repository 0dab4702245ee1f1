"""The program under test, built from the benchmark's plain inputs through
its public API: `halogen_tpu_torch`'s `Scene`, `make_camera` and
`RenderSettings`."""

from __future__ import annotations

import torch

import halogen_tpu_torch as ht
from halogen_tpu_torch.scene.envmap import Envmap
from halogen_tpu_torch.scene.material import Material
from halogen_tpu_torch.scene.scene import Scene


def material(m: dict) -> Material:
    return Material(
        color=tuple(m["color"]), opacity=m["opacity"],
        roughness=m["roughness"], metallic=m["metallic"],
        specular_color=tuple(m["specular_color"]),
        subsurface_color=tuple(m["subsurface_color"]),
        index_of_refraction=m["index_of_refraction"],
        absorption=m["absorption"],
        dielectric_priority=m["dielectric_priority"],
        emission_color=tuple(m["emission_color"]),
        emission_intensity=m["emission_intensity"])


def scene(objects: list, env_image: torch.Tensor | None, num_mips: int,
          device):
    s = Scene()
    for o in objects:
        if o["kind"] == "sphere":
            s.add_sphere(o["center"], o["radius"], material(o["material"]))
        else:
            s.add_mesh(o["verts"], o["faces"], material(o["material"]),
                       transform=o["transform"])
    env = None if env_image is None else Envmap.from_equirect(
        env_image.cpu().numpy(), num_mips=num_mips)
    return s.build(envmap=env, device=device)


def camera(spec: dict, aspect: float, device):
    return ht.make_camera(position=tuple(spec["position"]),
                          target=tuple(spec["target"]), up=tuple(spec["up"]),
                          fov_deg=spec["fov_deg"], aspect=aspect,
                          near=spec["near"], far=spec["far"], device=device)


def settings(fields: dict) -> ht.RenderSettings:
    return ht.RenderSettings(**fields)
