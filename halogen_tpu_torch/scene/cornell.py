"""Procedural test scenes (PyTorch port of `halogen_tpu/scene/cornell.py`).

The reference's test content lives in `Assets/Scenes/Testing Scene.unity`
(Cornell Box active at root, plus Material Demo / Roughness / Metallic /
Fresnel / Transparency sphere groups, Scale Demo, BVH Test, Glow Orbs —
SURVEY.md §2 assets note). These constructors rebuild that feature-matrix
scene procedurally: the Cornell box is the golden-image fixture, the
sphere grids exercise each material axis, `glass_sphere_box` exercises
nested dielectrics + absorption, and `glow_orbs` (emissive spheres only)
area-light NEE's sphere branch.
"""

from __future__ import annotations

import numpy as np

from halogen_tpu_torch.scene.material import Material
from halogen_tpu_torch.scene.scene import Scene


def _quad(scene: Scene, corners, material: Material, flip: bool = False):
    """Two-triangle quad from 4 corners (counter-clockwise winding)."""
    c = np.asarray(corners, np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    if flip:
        idx = idx[:, ::-1]
    scene.add_mesh(c, idx, material)


def cornell_box(
    light_intensity: float = 10.0,
    with_spheres: bool = True,
    glossy: bool = False,
) -> Scene:
    """Classic Cornell box in y-up world space, interior side length 2,
    centered at origin, open toward +z (camera side).

    Matches the reference scene's material style: diffuse white walls, red
    left wall, green right wall, emissive ceiling panel; two spheres (one
    diffuse, one glossy when `glossy`).
    """
    s = Scene()
    white = Material.diffuse((0.73, 0.73, 0.73))
    red = Material.diffuse((0.65, 0.05, 0.05))
    green = Material.diffuse((0.12, 0.45, 0.15))
    light = Material.emissive((1.0, 0.9, 0.7), light_intensity)

    # Box interior: floor (+y normal), ceiling, back wall, left (red, +x
    # normal), right (green, -x normal)
    _quad(s, [(-1, -1, -1), (1, -1, -1), (1, -1, 1), (-1, -1, 1)], white)  # floor
    _quad(s, [(-1, 1, -1), (-1, 1, 1), (1, 1, 1), (1, 1, -1)], white)  # ceiling
    _quad(s, [(-1, -1, -1), (-1, 1, -1), (1, 1, -1), (1, -1, -1)], white)  # back
    _quad(s, [(-1, -1, -1), (-1, -1, 1), (-1, 1, 1), (-1, 1, -1)], red)  # left
    _quad(s, [(1, -1, -1), (1, 1, -1), (1, 1, 1), (1, -1, 1)], green)  # right

    # Ceiling light panel (slightly below the ceiling)
    _quad(
        s,
        [(-0.4, 0.995, -0.4), (-0.4, 0.995, 0.4), (0.4, 0.995, 0.4),
         (0.4, 0.995, -0.4)],
        light,
    )

    if with_spheres:
        s.add_sphere((-0.45, -0.6, -0.3), 0.4, white)
        if glossy:
            s.add_sphere(
                (0.45, -0.65, 0.2), 0.35,
                Material.metal((0.9, 0.9, 0.9), roughness=0.1),
            )
        else:
            s.add_sphere((0.45, -0.65, 0.2), 0.35,
                         Material.diffuse((0.73, 0.73, 0.73)))
    return s


def material_demo_spheres(rows: int = 3, cols: int = 5) -> Scene:
    """Roughness x metallic sphere grid (the reference's Roughness/Metallic
    Spheres groups)."""
    s = Scene()
    floor = Material.diffuse((0.5, 0.5, 0.5))
    _quad(s, [(-10, 0, -10), (10, 0, -10), (10, 0, 10), (-10, 0, 10)], floor)
    for r in range(rows):
        for c in range(cols):
            metallic = r / max(rows - 1, 1)
            rough = c / max(cols - 1, 1)
            mat = Material(color=(0.8, 0.3, 0.2), metallic=metallic,
                           roughness=rough, specular_color=(0.9, 0.6, 0.4))
            s.add_sphere((c * 1.2 - cols * 0.6, 0.5, -r * 1.2), 0.5, mat)
    return s


def glass_sphere_box(absorption: float = 1.0) -> Scene:
    """Cornell box with a nested glass-in-glass dielectric pair — exercises
    interface tracking priorities + Beer-Lambert absorption."""
    s = cornell_box(with_spheres=False)
    outer = Material.glass(ior=1.5, subsurface=(0.9, 0.95, 1.0),
                           absorption=absorption, priority=1)
    inner = Material.glass(ior=1.0, priority=0)  # air bubble, higher precedence
    s.add_sphere((0.0, -0.5, 0.0), 0.45, outer)
    s.add_sphere((0.0, -0.5, 0.0), 0.25, inner)
    return s


def fresnel_spheres(n: int = 5) -> Scene:
    """IOR sweep 1.0 -> 2.4 of clear glass spheres over a checker-ish
    floor (the Fresnel Spheres group)."""
    s = Scene()
    floor = Material.diffuse((0.6, 0.6, 0.6))
    _quad(s, [(-10, -1, -10), (10, -1, -10), (10, -1, 10), (-10, -1, 10)],
          floor)
    for i in range(n):
        ior = 1.0 + 1.4 * i / max(n - 1, 1)
        s.add_sphere((i * 1.2 - (n - 1) * 0.6, -0.5, 0.0), 0.5,
                     Material.glass(ior=ior, priority=0))
    return s


def scale_demo(scales=(0.25, 0.5, 1.0, 2.0)) -> Scene:
    """The same mesh instanced at different non-uniform scales: per-mesh
    transforms and the inverse-transpose normal path (the reference's
    Scale Demo group)."""
    from halogen_tpu_torch.scene.meshes import icosphere

    s = Scene()
    floor = Material.diffuse((0.55, 0.55, 0.55))
    _quad(s, [(-12, -1, -12), (12, -1, -12), (12, -1, 12), (-12, -1, 12)],
          floor)
    v, f = icosphere(2)
    mat = Material.diffuse((0.2, 0.5, 0.8))
    x = -3.0
    for sc in scales:
        m = np.eye(4, dtype=np.float32)
        m[0, 0] = sc
        m[1, 1] = sc * 0.6  # non-uniform: stresses the normal transform
        m[2, 2] = sc
        m[:3, 3] = (x + sc, sc * 0.6 - 1.0, 0.0)
        x += 2.2 * sc
        s.add_mesh(v, f, mat, transform=m)
    return s


def glow_orbs(n: int = 4) -> Scene:
    """Dark room lit only by emissive spheres (the Glow Orbs group)."""
    s = cornell_box(light_intensity=0.0, with_spheres=False)
    colors = [(1.0, 0.4, 0.1), (0.2, 0.8, 1.0), (0.9, 0.1, 0.8),
              (0.4, 1.0, 0.3)]
    rng = np.random.default_rng(3)
    for i in range(n):
        p = rng.uniform(-0.7, 0.7, size=3)
        s.add_sphere((float(p[0]), float(p[1]), float(p[2])), 0.12,
                     Material.emissive(colors[i % len(colors)], 12.0))
    return s


def transparency_spheres() -> Scene:
    """Row of spheres sweeping opacity 1 -> 0 (Transparency Spheres group)."""
    s = Scene()
    floor = Material.diffuse((0.6, 0.6, 0.6))
    _quad(s, [(-10, -1, -10), (10, -1, -10), (10, -1, 10), (-10, -1, 10)],
          floor)
    n = 5
    for i in range(n):
        opacity = 1.0 - i / (n - 1)
        mat = Material(color=(0.9, 0.9, 0.9), opacity=opacity,
                       roughness=0.0, index_of_refraction=1.5)
        s.add_sphere((i * 1.2 - (n - 1) * 0.6, -0.5, 0.0), 0.5, mat)
    return s
