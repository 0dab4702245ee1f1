"""Halogen-TPU ported to PyTorch and CUDA for NVIDIA Hopper.

The JAX package `halogen_tpu` is the reference; this package mirrors its
module paths and public names. Plain tensor code is PyTorch; the fused
path-tracing kernel and its adjoint are hand-written CUDA C++
(`csrc/megakernel.cu`, `csrc/adjoint.cu`), built with nvcc at first use.
On the CPU every kernel's plain PyTorch version runs instead.

The port so far covers the forward render of opaque and nested-dielectric
(glass) scenes, with or without an environment map and its next-event
estimation, with or without area-light next-event estimation, up to
200,000 triangles (per-mesh and world BVHs, a world-BVH traversal kernel
and the megakernel's BVH tier); material and envmap gradients and the
fitting loop (`halogen_tpu_torch.diff`), on the card for every scene it
renders (with area-light NEE by recording alone: the forward records
the transcript, or, where a step's records pass the budget, each group's
backward records its launch again before it sweeps); debug views; envmaps
from HDR and EXR files (`scene.hdr_io`); rendering and fitting sharded
over processes (`parallel`); the wavefront scheduler
(`RenderSettings.wavefront`) wherever the lockstep integrator runs; the
binary-FBX importer (`scene.fbx`); the command line, `python -m
halogen_tpu_torch.cli`; and the JAX package's user-facing scripts,
`python -m halogen_tpu_torch.scripts.<name>`. The entry points build on
the card unless the caller passes `device="cpu"`.
"""

from halogen_tpu_torch.config import (
    DebugMode,
    Fused,
    Intersector,
    RenderSettings,
    SamplerKind,
)
from halogen_tpu_torch.scene.envmap import Envmap
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
    "Envmap",
    "Camera",
    "make_camera",
    "render_frame",
    "render_pixels",
    "Renderer",
    "RenderState",
]
