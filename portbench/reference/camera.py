"""Primary rays in plain PyTorch (a frozen copy of the port's plain camera;
the upstream's `get_ray_jitter`, `HalgoenCompute.compute:984-1013`): a
thin-lens camera through pixel centres, jittered by the Blackman-Harris
filter's inverse CDF.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import sampler as sob
from .geometry import normalize


@dataclasses.dataclass(frozen=True)
class RefCamera:
    cam_to_world: torch.Tensor  # [4, 4]
    half_w: float
    half_h: float
    near: float
    far: float
    focal_distance: float
    aperture_radius: float


def look_at(position, target, up) -> np.ndarray:
    """Camera-to-world matrix looking down +z in camera space."""
    position = np.asarray(position, np.float64)
    fwd = np.asarray(target, np.float64) - position
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2] = right, np.cross(right, fwd), fwd
    m[:3, 3] = position
    return m.astype(np.float32)


def make_camera(spec: dict, aspect: float, device) -> RefCamera:
    """`spec`: position, target, up, fov_deg, near, far (aperture 0)."""
    near = spec["near"]
    half_h = float(np.tan(np.deg2rad(spec["fov_deg"]) * 0.5) * near)
    focal = float(np.linalg.norm(np.asarray(spec["target"], np.float64)
                                 - np.asarray(spec["position"], np.float64)))
    f32 = lambda x: float(np.float32(x))
    return RefCamera(
        cam_to_world=torch.from_numpy(look_at(
            spec["position"], spec["target"], spec["up"])).to(device),
        half_w=f32(aspect * half_h), half_h=f32(half_h), near=f32(near),
        far=f32(spec["far"]), focal_distance=f32(max(focal, 1e-6)),
        aperture_radius=0.0)


def _rows(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[N, 3] @ m[:3, :3].T as products summed (x + y) + z."""
    return v[:, 0:1] * m[:3, 0] + v[:, 1:2] * m[:3, 1] + v[:, 2:3] * m[:3, 2]


def generate_rays(cam: RefCamera, px: torch.Tensor, py: torch.Tensor,
                  width: int, height: int, filter_radius: float,
                  sample_idx: torch.Tensor, seed: torch.Tensor):
    """(origin [N, 3], direction [N, 3]) of pixels (px, py), y up."""
    dev = px.device
    f = lambda x: torch.tensor(np.float32(x), device=dev)
    half_w, half_h, near = f(cam.half_w), f(cam.half_h), f(cam.near)
    ndc_x = ((px.to(torch.float32) + 0.5) / width) * 2.0 - 1.0
    ndc_y = ((py.to(torch.float32) + 0.5) / height) * 2.0 - 1.0
    px_w = 2.0 * half_w / width
    px_h = 2.0 * half_h / height
    ju, jv = sob.ld_sample_2d(sample_idx, sob.DIM_RAY_JITTER, seed)
    jx = sob.inverse_blackman_harris_cdf(ju) * 2.0 * filter_radius * px_w
    jy = sob.inverse_blackman_harris_cdf(jv) * 2.0 * filter_radius * px_h
    screen = torch.stack([ndc_x * half_w + jx, ndc_y * half_h + jy,
                          near.expand(ndc_x.shape)], dim=-1)
    au, av = sob.ld_sample_2d(sample_idx, sob.DIM_FOCAL_DISC, seed)
    ax, ay = sob.point_in_circle(f(cam.aperture_radius), au, av)
    aperture = torch.stack([ax, ay, torch.zeros_like(ax)], dim=-1)
    cam_dir = normalize(normalize(screen) * f(cam.focal_distance) - aperture)
    m = cam.cam_to_world
    origin = _rows(m, aperture) + m[:3, 3]
    return origin, normalize(_rows(m, cam_dir))
