"""Material evaluation (PyTorch port of the opaque path of
`halogen_tpu/integrator/shade.py`; reference `HalgoenCompute.compute:672-817`).

`material_brdf` mirrors `material_BRDF` (diffuse lambert /
metallic-fresnel specular with roughness^2 blending / refraction with
TIR); `evaluate_material_hit` is the opaque specialization of the
interface-tracking wrapper. The nested-dielectric medium stack is not
ported yet (ROADMAP A8).

Bounce type encoding (compute:882-887): 0 diffuse, 1 specular/glossy,
2 transmissive.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from halogen_tpu_torch.core.math import (
    OFFSET_EPS,
    lambertian_scatter,
    lerp,
    normalize,
    reflect,
    refract,
    schlick_adjusted_specular,
)
from halogen_tpu_torch.core.types import HitRecord, MaterialTable
from halogen_tpu_torch.sampler.mappings import unit_vector_from_2d


class MaterialSample(NamedTuple):
    """Per-ray gathered material parameters."""

    albedo: torch.Tensor  # [N, 3]
    alpha: torch.Tensor  # [N] opacity
    specular: torch.Tensor  # [N, 3]
    metallic: torch.Tensor  # [N]
    roughness: torch.Tensor  # [N]
    emissive_rgb: torch.Tensor  # [N, 3]
    emissive_intensity: torch.Tensor  # [N]
    ior: torch.Tensor  # [N]
    absorption: torch.Tensor  # [N, 3]
    priority: torch.Tensor  # [N] int32
    material_id: torch.Tensor  # [N]


def gather_materials(materials: MaterialTable,
                     idx: torch.Tensor) -> MaterialSample:
    """Fetch per-ray material parameters: one row gather from the [K, 18]
    concatenation of the float fields."""
    table = torch.cat(
        [
            materials.albedo,                              # 0:4 rgb + alpha
            materials.specular,                            # 4:7
            materials.metallic[:, None],                   # 7
            materials.roughness[:, None],                  # 8
            materials.emissive,                            # 9:13 rgb + intensity
            materials.ior[:, None],                        # 13
            materials.absorption,                          # 14:17
            materials.priority.to(torch.float32)[:, None],  # 17
        ],
        dim=1,
    )
    row = table[idx]
    return MaterialSample(
        albedo=row[..., 0:3],
        alpha=row[..., 3],
        specular=row[..., 4:7],
        metallic=row[..., 7],
        roughness=row[..., 8],
        emissive_rgb=row[..., 9:12],
        emissive_intensity=row[..., 12],
        ior=row[..., 13],
        absorption=row[..., 14:17],
        priority=torch.round(row[..., 17]).to(torch.int32),
        material_id=idx,
    )


class ScatTuple(NamedTuple):
    origin: torch.Tensor  # [N, 3]
    direction: torch.Tensor  # [N, 3]
    attenuation: torch.Tensor  # [N, 3]
    bounce_type: torch.Tensor  # [N] (0 diffuse / 1 specular / 2 transmissive)
    spec_prob: torch.Tensor  # [N] lobe-selection probability


def material_brdf(ray_dir, hit: HitRecord, mat: MaterialSample,
                  current_ior, hit_ior, reflection_rand,
                  property_rand) -> ScatTuple:
    """Sample the scatter direction and attenuation (material_BRDF,
    compute:672-741). Both branches are evaluated; masks select."""
    rough_vec = unit_vector_from_2d(*reflection_rand)
    do_refraction = property_rand[0] > mat.alpha  # compute:683
    spec_rand = property_rand[1]
    normal = hit.normal
    r2 = (mat.roughness * mat.roughness)[:, None]

    diffuse_dir = lambertian_scatter(normal, rough_vec)

    # --- reflective branch (compute:686-710)
    spec_prob = torch.where(
        mat.metallic > 0.0,
        schlick_adjusted_specular(current_ior, hit_ior, normal, ray_dir,
                                  mat.metallic, 1.0),
        mat.metallic,
    )
    do_spec = spec_rand < spec_prob
    spec_dir = lerp(reflect(ray_dir, normal), diffuse_dir, r2)
    refl_dir = torch.where(do_spec[:, None], spec_dir, diffuse_dir)
    refl_atten = torch.where(do_spec[:, None], mat.specular, mat.albedo)
    refl_origin = hit.pos + normal * OFFSET_EPS

    # --- refractive branch (compute:711-734)
    refr_dir, tir = refract(ray_dir, normal, current_ior, hit_ior)
    diffuse_refr_dir = lambertian_scatter(
        torch.where(tir[:, None], normal, -normal), rough_vec)
    refr_dir = lerp(refr_dir, diffuse_refr_dir, r2)
    refr_origin = hit.pos - normal * OFFSET_EPS

    dm = do_refraction[:, None]
    direction = normalize(torch.where(dm, refr_dir, refl_dir), eps=1e-20)
    origin = torch.where(dm, refr_origin, refl_origin)
    attenuation = torch.where(dm, torch.ones_like(refl_atten), refl_atten)
    bounce_type = torch.where(do_refraction, 2, torch.where(do_spec, 1, 0))
    return ScatTuple(origin, direction, attenuation, bounce_type, spec_prob)


class ShadeResult(NamedTuple):
    origin: torch.Tensor
    direction: torch.Tensor
    attenuation: torch.Tensor  # [N, 3] including absorption
    bounce_type: torch.Tensor  # [N]
    spec_prob: torch.Tensor  # [N]


def evaluate_material_hit(ray_dir, hit: HitRecord, mat: MaterialSample,
                          active, reflection_rand, property_rand,
                          any_transmissive: bool = True) -> ShadeResult:
    """Interface tracking + BRDF dispatch (evaluate_material_hit,
    compute:743-817) for opaque scenes: the medium stack is provably
    always empty there, so cur/hit media reduce to (empty|internal) by
    hit orientation."""
    if any_transmissive:
        raise NotImplementedError(
            "transmissive materials need the nested-dielectric medium "
            "stack, which is not ported yet (ROADMAP A8)")
    entering = hit.orientation > 0
    cur_ior = torch.where(entering, 1.0, mat.ior)
    hit_ior = torch.where(entering, mat.ior, 1.0)

    scat = material_brdf(ray_dir, hit, mat, cur_ior, hit_ior,
                         reflection_rand, property_rand)

    # Beer-Lambert while travelling inside the material (exiting lanes)
    t_safe = torch.where(torch.isfinite(hit.t), hit.t, 0.0)
    absorb = torch.exp(-mat.absorption * t_safe[:, None])
    attenuation = torch.where(
        (active & (~entering))[:, None], scat.attenuation * absorb,
        scat.attenuation)
    return ShadeResult(scat.origin, scat.direction, attenuation,
                       scat.bounce_type, scat.spec_prob)
