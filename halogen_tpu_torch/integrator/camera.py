"""Thin-lens camera ray generation with Blackman-Harris pixel filtering
(PyTorch port of `halogen_tpu/integrator/camera.py`; reference `get_ray` /
`get_ray_jitter`, `HalgoenCompute.compute:984-1013`).

Rays target pixel centers and the filter jitter is centered, as in the
JAX package (its docstring lists this deliberate fix vs the reference).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from halogen_tpu_torch.core.math import normalize, transform_dir, transform_point
from halogen_tpu_torch.sampler.mappings import (
    inverse_blackman_harris_cdf,
    point_in_circle,
)
from halogen_tpu_torch.sampler.sobol import DIM_FOCAL_DISC, DIM_RAY_JITTER


@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera tensors: a [4, 4] camera-to-world matrix and float32
    scalars, all on one device."""

    cam_to_world: torch.Tensor  # [4, 4]
    half_w: torch.Tensor  # frustum half-width at the near plane
    half_h: torch.Tensor
    near: torch.Tensor
    far: torch.Tensor
    focal_distance: torch.Tensor
    aperture_radius: torch.Tensor  # tan(apertureAngle) * near

    def to(self, device) -> "Camera":
        if self.cam_to_world.device == torch.device(device):
            return self
        return Camera(**{f.name: getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self)})


def look_at_matrix(position, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Right-handed look-at: camera looks down +z in camera space."""
    position = np.asarray(position, np.float64)
    fwd = np.asarray(target, np.float64) - position
    fwd = fwd / np.linalg.norm(fwd)
    upv = np.asarray(up, np.float64)
    right = np.cross(fwd, upv)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = true_up
    m[:3, 2] = fwd
    m[:3, 3] = position
    return m.astype(np.float32)


def make_camera(
    position=(0.0, 0.0, 3.5),
    target=(0.0, 0.0, 0.0),
    up=(0.0, 1.0, 0.0),
    fov_deg: float = 60.0,
    aspect: float = 1.0,
    near: float = 0.1,
    far: float = 5000.0,
    focal_distance: float | None = None,
    aperture_deg: float = 0.0,
    device="cpu",
) -> Camera:
    """Build a Camera. Defaults mirror the shipped URP settings (fov 60,
    near 0.1, far 5000, aperture 0)."""
    half_h = float(np.tan(np.deg2rad(fov_deg) * 0.5) * near)
    half_w = aspect * half_h
    if focal_distance is None:
        focal_distance = float(
            np.linalg.norm(np.asarray(target, np.float64)
                           - np.asarray(position, np.float64))
        )
    aperture_deg = float(np.clip(aperture_deg, 0.0, 89.9))

    def f32(x):
        return torch.tensor(np.float32(x), device=device)

    return Camera(
        cam_to_world=torch.from_numpy(
            look_at_matrix(position, target, up)).to(device),
        half_w=f32(half_w),
        half_h=f32(half_h),
        near=f32(near),
        far=f32(far),
        focal_distance=f32(max(focal_distance, 1e-6)),
        aperture_radius=f32(np.tan(np.deg2rad(aperture_deg)) * near),
    )


def generate_rays(
    camera: Camera,
    pixel_x: torch.Tensor,
    pixel_y: torch.Tensor,
    width: int,
    height: int,
    filter_radius: float,
    sample_idx: torch.Tensor,
    seed: torch.Tensor,
    sample_2d,
):
    """Primary rays for flat pixel arrays.

    pixel_x/pixel_y: [N] integer pixel coordinates (x right, y up);
    sample_idx/seed: [N] uint32 values held in int64; sample_2d: the active
    sampler's 2D draw. Returns (origins [N,3], directions [N,3]).
    """
    ndc_x = ((pixel_x.to(torch.float32) + 0.5) / width) * 2.0 - 1.0
    ndc_y = ((pixel_y.to(torch.float32) + 0.5) / height) * 2.0 - 1.0

    px_w = 2.0 * camera.half_w / width
    px_h = 2.0 * camera.half_h / height
    ju, jv = sample_2d(sample_idx, DIM_RAY_JITTER, seed)
    jitter_x = inverse_blackman_harris_cdf(ju) * 2.0 * filter_radius * px_w
    jitter_y = inverse_blackman_harris_cdf(jv) * 2.0 * filter_radius * px_h

    screen = torch.stack([
        ndc_x * camera.half_w + jitter_x,
        ndc_y * camera.half_h + jitter_y,
        camera.near.expand(ndc_x.shape),
    ], dim=-1)  # camera-space point on the near plane (compute:1002-1003)

    # Thin lens: aperture point on the focal disc (compute:998-999)
    au, av = sample_2d(sample_idx, DIM_FOCAL_DISC, seed)
    ax, ay = point_in_circle(camera.aperture_radius, au, av)
    aperture = torch.stack([ax, ay, torch.zeros_like(ax)], dim=-1)

    # Direction through the focal plane (compute:1006-1007)
    focal_point = normalize(screen) * camera.focal_distance
    cam_dir = normalize(focal_point - aperture)

    origin = transform_point(camera.cam_to_world, aperture)
    direction = normalize(transform_dir(camera.cam_to_world, cam_dir))
    return origin, direction
