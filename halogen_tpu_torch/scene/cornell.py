"""Procedural test scenes (PyTorch port of the scene constructors in
`halogen_tpu/scene/cornell.py` that need no BVH).

The reference's test content lives in `Assets/Scenes/Testing Scene.unity`
(Cornell Box active at root, plus Material Demo / Roughness / Metallic /
Fresnel / Transparency sphere groups, Scale Demo, BVH Test, Glow Orbs —
SURVEY.md §2 assets note). These constructors rebuild that feature-matrix
scene procedurally: the Cornell box is the golden-image fixture, the
sphere grids exercise each material axis, and `glass_sphere_box` exercises
nested dielectrics + absorption.
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
