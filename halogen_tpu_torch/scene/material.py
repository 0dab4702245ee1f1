"""User-facing material description.

Mirrors the reference's `HalogenMaterial` inspector struct
(`Assets/Scripts/RayTracingManager.cs:7-38`) field-for-field:
color (+ alpha = opacity: transmission probability is 1 - alpha,
`HalgoenCompute.compute:683`), roughness, metallic, specular color,
subsurface color + absorption strength (packed to Beer-Lambert coefficients
at build, `HalogenRenderPass.cs:436`), index of refraction, dielectric
priority (lower value = higher precedence; negative disables interface
tracking, `HalgoenCompute.compute:758`), and emission color + intensity.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

Color = Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class Material:
    color: Color = (1.0, 1.0, 1.0)
    opacity: float = 1.0  # albedo alpha; rays refract with prob (1 - opacity)
    roughness: float = 1.0
    metallic: float = 0.0
    specular_color: Color = (1.0, 1.0, 1.0)
    # Transmission
    subsurface_color: Color = (1.0, 1.0, 1.0)
    index_of_refraction: float = 1.0  # inspector range [1, 8]
    absorption: float = 0.0  # inspector range [0, 4]
    dielectric_priority: int = 0
    # Emission
    emission_color: Color = (0.0, 0.0, 0.0)
    emission_intensity: float = 0.0

    def packed_absorption(self) -> np.ndarray:
        """(1 / subsurfaceColor) * max(absorption, 0)
        (HalogenRenderPass.cs:435-436)."""
        ss = np.asarray(self.subsurface_color, dtype=np.float32)
        return (1.0 / np.maximum(ss, 1e-6)) * max(self.absorption, 0.0)

    # --- convenience constructors -------------------------------------
    @staticmethod
    def diffuse(color: Color, roughness: float = 1.0) -> "Material":
        return Material(color=color, roughness=roughness)

    @staticmethod
    def emissive(color: Color, intensity: float) -> "Material":
        return Material(color=(0, 0, 0), emission_color=color,
                        emission_intensity=intensity)

    @staticmethod
    def metal(color: Color, roughness: float = 0.0,
              specular: Color | None = None) -> "Material":
        return Material(color=color, metallic=1.0, roughness=roughness,
                        specular_color=specular or color)

    @staticmethod
    def glass(ior: float = 1.5, roughness: float = 0.0,
              subsurface: Color = (1, 1, 1), absorption: float = 0.0,
              priority: int = 0) -> "Material":
        return Material(color=(1, 1, 1), opacity=0.0, roughness=roughness,
                        index_of_refraction=ior, subsurface_color=subsurface,
                        absorption=absorption, dielectric_priority=priority)
