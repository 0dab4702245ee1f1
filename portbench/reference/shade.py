"""Material evaluation in plain PyTorch (a frozen copy of the port's plain
shading; the upstream's `HalgoenCompute.compute:672-817`).

`material_brdf` mirrors `material_BRDF` (diffuse lambert /
metallic-fresnel specular with roughness^2 blending / refraction with
TIR); `evaluate_material_hit` mirrors the interface-tracking wrapper: the
priority-based true-hit decision, the medium stack's push/pop sequence
with the reflected-ray "bandaid" pop (compute:799-802), and Beer-Lambert
absorption through the current medium (compute:810-813). Opaque scenes
take a stack-free specialization with the same outputs.

Bounce type encoding (compute:882-887): 0 diffuse, 1 specular/glossy,
2 transmissive.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .geometry import (
    OFFSET_EPS,
    lambertian_scatter,
    lerp,
    normalize,
    reflect,
    refract,
    schlick_adjusted_specular,
)
from .medium import Medium, MediumStack
from .sampler import unit_vector_from_2d


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

    def internal_medium(self) -> Medium:
        """The medium inside the material (HalogenMaterial.internalMedium,
        compute:101-102)."""
        return Medium(ior=self.ior, absorption=self.absorption,
                      priority=self.priority,
                      material_id=self.material_id.to(torch.int32))


def gather_materials(materials,
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


def material_brdf(ray_dir, hit, mat: MaterialSample,
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
    stack: MediumStack | None  # None in opaque scenes
    spec_prob: torch.Tensor  # [N]


def _sel_medium(cond: torch.Tensor, a: Medium, b: Medium) -> Medium:
    return Medium(
        ior=torch.where(cond, a.ior, b.ior),
        absorption=torch.where(cond[:, None], a.absorption, b.absorption),
        priority=torch.where(cond, a.priority, b.priority),
        material_id=torch.where(cond, a.material_id, b.material_id),
    )


def evaluate_material_hit(ray_dir, hit, mat: MaterialSample,
                          stack: MediumStack | None, active, reflection_rand,
                          property_rand,
                          any_transmissive: bool = True) -> ShadeResult:
    """Interface tracking + BRDF dispatch (evaluate_material_hit,
    compute:743-817), with `active` masking every stack mutation.

    `any_transmissive=False` (a build-time fact of the scene) takes the
    opaque specialization: no lane ever refracts, every push is popped
    again within the bounce, so the stack stays empty and cur/hit media
    reduce to (empty | internal) by hit orientation; the outputs are the
    general path's and `stack` passes through."""
    if not any_transmissive:
        return _evaluate_material_hit_opaque(ray_dir, hit, mat, stack, active,
                                             reflection_rand, property_rand)
    internal = mat.internal_medium()
    uses_tracking = mat.priority >= 0  # compute:758
    entering = hit.orientation > 0

    top0 = stack.top()
    true_hit = torch.where(uses_tracking, stack.is_true_hit(mat.priority),
                           True)

    # current/hit media per the four cases (compute:752-789)
    # tracking & entering: cur = top, hitm = internal
    # tracking & exiting: cur = (empty stack ? internal : top); pop(id);
    #                     hitm = new top
    # plain & entering: cur = top, hitm = internal
    # plain & exiting: cur = internal, hitm = top
    empty0 = stack.size == 0
    track_exit = active & uses_tracking & (~entering)
    stack_after_pop = stack.pop_id(internal.material_id, track_exit)
    top_after_pop = stack_after_pop.top()
    cur = _sel_medium(
        entering, top0,
        _sel_medium(uses_tracking, _sel_medium(empty0, internal, top0),
                    internal))
    hitm = _sel_medium(entering, internal,
                       _sel_medium(uses_tracking, top_after_pop, top0))

    # tracked entry pushes the internal medium (compute:767)
    track_enter = active & uses_tracking & entering
    stack1 = stack_after_pop.push(internal, track_enter)

    scat = material_brdf(ray_dir, hit, mat, cur.ior, hitm.ior,
                         reflection_rand, property_rand)

    # False hit: pass through, origin behind the surface, counts as a
    # transmissive bounce (compute:803-808)
    is_true = active & true_hit
    it = is_true[:, None]
    origin = torch.where(it, scat.origin, hit.pos - hit.normal * OFFSET_EPS)
    direction = torch.where(it, scat.direction, ray_dir)
    attenuation = torch.where(it, scat.attenuation, 1.0)
    bounce_type = torch.where(is_true, scat.bounce_type, 2)

    # Bandaid pop (compute:799-802): entering rays that did not refract
    # leave the just-pushed medium again; true hits only.
    bandaid = is_true & entering & (bounce_type != 2)
    stack2 = stack1.pop_id(internal.material_id, bandaid)

    # Beer-Lambert through the current medium (compute:810-813); miss
    # lanes carry t = inf, pinned to 0 so no 0 * inf reaches them.
    absorbing = cur.material_id != -1
    t_safe = torch.where(torch.isfinite(hit.t), hit.t, 0.0)
    absorb = torch.exp(-cur.absorption * t_safe[:, None])
    attenuation = torch.where((active & absorbing)[:, None],
                              attenuation * absorb, attenuation)
    return ShadeResult(origin, direction, attenuation, bounce_type, stack2,
                       scat.spec_prob)


def _evaluate_material_hit_opaque(ray_dir, hit, mat, stack, active,
                                  reflection_rand,
                                  property_rand) -> ShadeResult:
    """Opaque-scene specialization (see evaluate_material_hit)."""
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
                       scat.bounce_type, stack, scat.spec_prob)
