"""Halogen-TPU ported to PyTorch and CUDA for NVIDIA Hopper.

The JAX package `halogen_tpu` is the reference; this package mirrors its
module paths and public names. Plain tensor code is PyTorch; the fused
path-tracing kernel is hand-written CUDA C++ (`csrc/megakernel.cu`),
built with nvcc at first use. On the CPU every kernel's plain PyTorch
version runs instead.

The port so far covers the forward render of opaque scenes without
envmaps, next-event estimation or debug views (see ROADMAP.md).
"""

from halogen_tpu_torch.config import (
    DebugMode,
    Fused,
    Intersector,
    RenderSettings,
    SamplerKind,
)
from halogen_tpu_torch.scene.material import Material
from halogen_tpu_torch.scene.scene import Scene
from halogen_tpu_torch.integrator.camera import Camera, make_camera
from halogen_tpu_torch.integrator.trace import render_frame, render_pixels
from halogen_tpu_torch.render.accumulate import Renderer, RenderState

__version__ = "0.1.0"

__all__ = [
    "RenderSettings",
    "DebugMode",
    "Fused",
    "Intersector",
    "SamplerKind",
    "Material",
    "Scene",
    "Camera",
    "make_camera",
    "render_frame",
    "render_pixels",
    "Renderer",
    "RenderState",
]
