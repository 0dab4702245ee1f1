"""Emissive-geometry light table for area-light next-event estimation
(PyTorch port of `halogen_tpu/scene/lights.py`).

Emissive triangles and spheres are tabulated at scene build with one
power-proportional selection CDF (power ~ surface area * luminance of
E * intensity); the integrator samples one light per opaque bounce and
combines it with the continuation by the balance heuristic. This is a
capability beyond the reference, which finds its emitters by BRDF sampling
alone (hence the noise of its small-panel Cornell box and Glow Orbs).

Sampling measures: triangles by area (the pdf turned into solid angle by
d^2 / cos at the light), spheres by uniform solid angle over the cone they
subtend (pdf = sel / (2 pi (1 - cos theta_max))).

`build_light_table` is numpy, op for op the JAX package's, so both
packages' tables are equal bit for bit; `sphere_cone_pdf` and
`sample_light` are the plain PyTorch versions of what the megakernel's
light-NEE variant (B1e, `csrc/path_common.cuh`) computes per ray.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from halogen_tpu_torch.core.math import cross, dot, sqrt

_LUM = np.asarray([0.2126, 0.7152, 0.0722], np.float32)
_TWO_PI = float(np.float32(2.0 * np.pi))


class LightTable(NamedTuple):
    kind: torch.Tensor  # [L] int32: 0 = triangle, 1 = sphere
    idx: torch.Tensor  # [L] int32 index into the triangles / spheres
    cdf: torch.Tensor  # [L] selection CDF (power-proportional)
    sel: torch.Tensor  # [L] selection probability
    pdf_area: torch.Tensor  # [L] sel / area for triangles (0 for spheres)

    @property
    def count(self) -> int:
        return self.kind.shape[0]

    def to(self, device) -> "LightTable":
        return LightTable(*(t.to(device) for t in self))


def build_light_table(tri_verts_world, tri_material, sphere_center,
                      sphere_radius, sphere_material, emissive,
                      device="cpu"):
    """Returns (LightTable | None, tri_light_pdf_area [max(T, 1)],
    sphere_light_sel [max(S, 1)]) on `device`: the table of every emitter
    with positive power, None where there is none; and, per triangle and
    per sphere, the pdf_area and the selection probability of its light
    (0 for a non-emitter). `emissive` is the material table's [K, 4]."""
    tv = np.asarray(tri_verts_world, np.float32)
    n_tri = tv.shape[0]
    n_sph = np.asarray(sphere_radius).shape[0]
    dense_tri = np.zeros((max(n_tri, 1),), np.float32)
    dense_sph = np.zeros((max(n_sph, 1),), np.float32)

    em = np.asarray(emissive, np.float32)
    power_per_mat = (em[:, :3] @ _LUM) * em[:, 3]

    kinds, idxs, powers, areas = [], [], [], []
    if n_tri:
        e1 = tv[:, 1] - tv[:, 0]
        e2 = tv[:, 2] - tv[:, 0]
        tri_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
        tri_power = power_per_mat[np.asarray(tri_material)] * tri_area
        for i in np.nonzero(tri_power > 0)[0]:
            kinds.append(0)
            idxs.append(i)
            powers.append(tri_power[i])
            areas.append(tri_area[i])
    if n_sph:
        r = np.asarray(sphere_radius, np.float32)
        sph_area = 4.0 * np.pi * r * r
        sph_power = power_per_mat[np.asarray(sphere_material)] * sph_area
        for i in np.nonzero(sph_power > 0)[0]:
            kinds.append(1)
            idxs.append(i)
            powers.append(sph_power[i])
            areas.append(sph_area[i])

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if not kinds:
        return None, t(dense_tri), t(dense_sph)
    p = np.asarray(powers, np.float32)
    p = p / p.sum()
    pdf_area = np.where(
        np.asarray(kinds) == 0,
        p / np.maximum(np.asarray(areas, np.float32), 1e-12), 0.0
    ).astype(np.float32)
    for k, i, sel_p, pa in zip(kinds, idxs, p, pdf_area):
        if k == 0:
            dense_tri[i] = pa
        else:
            dense_sph[i] = sel_p
    table = LightTable(
        kind=t(np.asarray(kinds, np.int32)),
        idx=t(np.asarray(idxs, np.int32)),
        cdf=t(np.cumsum(p).astype(np.float32)),
        sel=t(p),
        pdf_area=t(pdf_area),
    )
    return table, t(dense_tri), t(dense_sph)


def sphere_cone_pdf(sel, center, radius, from_point) -> torch.Tensor:
    """Solid-angle pdf of cone-sampling sphere lights from `from_point`
    (0 where the point is inside the sphere: the caller's MIS weight is
    then 1)."""
    d = center - from_point
    d2 = dot(d, d)
    sin2 = radius * radius / torch.clamp_min(d2, 1e-12)
    outside = sin2 < 1.0
    cos_max = sqrt(torch.clamp(1.0 - sin2, 0.0, 1.0))
    solid = _TWO_PI * (1.0 - cos_max)
    return torch.where(outside & (solid > 1e-12),
                       sel / torch.clamp_min(solid, 1e-12), 0.0)


def select_light(lights: LightTable, u_sel: torch.Tensor) -> torch.Tensor:
    """[N] int64 row of the table chosen by the power CDF: the first row
    whose cdf is >= u (`jnp.searchsorted`'s side 'left'), clipped to the
    last."""
    li = torch.searchsorted(lights.cdf, u_sel.contiguous(), side="left")
    return torch.clamp(li, 0, lights.count - 1)


def sample_light(lights: LightTable, scene, u_sel, u1, u2) -> dict:
    """Pick a light by the power CDF and sample the point that defines its
    direction.

    Returns per ray: kind, idx, tri_point [., 3] (on a triangle light), gn
    (its unnormalized normal), pdf_area; center, radius and sel (of a
    sphere light). The caller computes the direction, distance and
    solid-angle pdf, which depend on the shading point."""
    li = select_light(lights, u_sel)
    kind = lights.kind[li]
    idx = lights.idx[li].to(torch.int64)
    n = u_sel.shape[0]
    dev = u_sel.device

    # --- triangle branch: uniform barycentric point
    tidx = torch.where(kind == 0, idx, 0)
    v = (scene.tri_verts_world[tidx] if scene.num_triangles
         else torch.zeros((n, 3, 3), device=dev))
    su = sqrt(torch.clamp(u1, 0.0, 1.0))
    b0 = 1.0 - su
    b1 = su * (1.0 - u2)
    b2 = su * u2
    tri_point = (v[:, 0] * b0[:, None] + v[:, 1] * b1[:, None]
                 + v[:, 2] * b2[:, None])
    gn = cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])

    # --- sphere branch: center and radius (the caller samples the cone)
    sidx = torch.where(kind == 1, idx, 0)
    if scene.num_spheres:
        center = scene.sphere_center[sidx]
        radius = scene.sphere_radius[sidx]
    else:
        center = torch.zeros((n, 3), device=dev)
        radius = torch.zeros((n,), device=dev)
    return dict(kind=kind, idx=idx, tri_point=tri_point, gn=gn,
                pdf_area=lights.pdf_area[li], center=center, radius=radius,
                sel=lights.sel[li])
