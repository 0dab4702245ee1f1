"""Fused-bounce megakernel: the whole path loop of every ray in one CUDA
launch (port of `halogen_tpu/kernels/megakernel.py`, brute-force opaque
tier).

The kernel is hand-written CUDA C++ for Hopper (`csrc/megakernel.cu`).
It is compiled with `nvcc` for sm_90a at first use, into `_build/` beside
this package, from the source in the repository (rebuilt when the
source's hash changes), and bound through ctypes.

`trace_color_fused` takes rays on a CUDA device to the kernel and rays on
the CPU to the plain PyTorch version, `trace_color_fused_reference`,
which runs the lockstep integrator. A CUDA launch that fails raises; there
is no fallback. `LAUNCHES` counts kernel launches.

Scope (`fused_supported`): opaque scenes without envmap, next-event
estimation or debug views, with at most MAX_TRIS triangles, MAX_SPHERES
spheres and MAX_MATERIALS materials.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

from halogen_tpu_torch.config import DebugMode, RenderSettings, SamplerKind
from halogen_tpu_torch.core.types import SceneData

# Caps of the brute tier: the scene tables live in shared memory.
MAX_TRIS = 128
MAX_SPHERES = 32
MAX_MATERIALS = 64

N_OUTPUTS = 10  # color rgb, miss attenuation rgb, acc roughness, dir xyz

LAUNCHES = 0  # kernel launches since the count was last set to 0

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "megakernel.cu")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lib = None
BUILD_SECONDS = None  # wall time of the nvcc build in this process
BUILD_LOG = ""  # nvcc's output (registers, shared memory, spills)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the megakernel needs the CUDA "
                           "toolkit to build")
    return path


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's shared library."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    if _lib is not None:
        return _lib
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"megakernel_{digest}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _SOURCE],
                              capture_output=True, text=True)
        BUILD_SECONDS = time.perf_counter() - t0
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {_SOURCE}:\n{BUILD_LOG}")
        os.replace(tmp, so_path)  # atomic: no half-written library
    lib = ctypes.CDLL(so_path)
    fn = lib.halogen_megakernel_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    _lib = lib
    return lib


def fused_supported(scene: SceneData, settings: RenderSettings) -> bool:
    """Static eligibility for the port's fused megakernel (the JAX
    `fused_supported` restricted to its brute, opaque, no-NEE tier)."""
    return (
        settings.debug_mode == DebugMode.NONE
        and not settings.use_envmap
        and not settings.env_importance_sampling
        and not settings.light_importance_sampling
        and not scene.any_transmissive
        and scene.num_triangles <= MAX_TRIS
        and scene.num_spheres <= MAX_SPHERES
        and scene.materials.count <= MAX_MATERIALS
        and (scene.num_triangles + scene.num_spheres) > 0
        and settings.sampler in (SamplerKind.SOBOL, SamplerKind.PRNG)
    )


def _scene_tables(scene: SceneData):
    """Pack the scene into the kernel's tables: tri [T, 9] (v0, e1, e2),
    trin [T, 10] (n0, n1 - n0, n2 - n0, material), sph [S, 5] (center,
    radius, material) and mat [K, 17], all float32 and contiguous."""
    mats = scene.materials
    f32 = torch.float32
    mat_tab = torch.cat(
        [
            mats.albedo,                                   # 0:3 rgb, 3 alpha
            mats.specular,                                 # 4:7
            mats.metallic[:, None],                        # 7
            mats.roughness[:, None],                       # 8
            mats.emissive[:, :3] * mats.emissive[:, 3:4],  # 9:12 premult
            mats.ior[:, None],                             # 12
            mats.absorption,                               # 13:16
            mats.priority.to(f32)[:, None],                # 16
        ],
        dim=1,
    ).to(f32).contiguous()
    tv = scene.tri_verts_world
    v0 = tv[:, 0]
    tri_tab = torch.cat([v0, tv[:, 1] - v0, tv[:, 2] - v0], dim=1).contiguous()
    tn = scene.tri_normals_world
    n0 = tn[:, 0]
    trin_tab = torch.cat([n0, tn[:, 1] - n0, tn[:, 2] - n0,
                          scene.tri_material.to(f32)[:, None]],
                         dim=1).contiguous()
    sph_tab = torch.cat([scene.sphere_center, scene.sphere_radius[:, None],
                         scene.sphere_material.to(f32)[:, None]],
                        dim=1).contiguous()
    return tri_tab, trin_tab, sph_tab, mat_tab


def _as_i32(u: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> their int32 bit pattern."""
    return (((u & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _launch(scene, origin, direction, far, sample_idx, seed,
            settings: RenderSettings, tables) -> torch.Tensor:
    """Launch the kernel on the current stream; returns [N, 10]."""
    global LAUNCHES
    if not fused_supported(scene, settings):
        raise NotImplementedError(
            "the CUDA megakernel covers opaque scenes without envmap, NEE "
            f"or debug views, with <= {MAX_TRIS} triangles, <= "
            f"{MAX_SPHERES} spheres and <= {MAX_MATERIALS} materials "
            "(wider tiers: ROADMAP A8, A9)")
    n = origin.shape[0]
    dev = origin.device
    if origin.shape != (n, 3) or direction.shape != (n, 3):
        raise ValueError("origin and direction must be [N, 3]")
    for name, t in (("origin", origin), ("direction", direction)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, rays on {dev}")
    tables = tables if tables is not None else _scene_tables(scene)
    for t in tables:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("scene tables must be contiguous float32 on "
                             f"{dev}")
    sidx = _as_i32(torch.as_tensor(sample_idx, device=dev).expand(n))
    sd = _as_i32(torch.as_tensor(seed, device=dev).expand(n))
    sidx, sd = sidx.contiguous(), sd.contiguous()
    far_t = torch.as_tensor(far, dtype=torch.float32,
                            device=dev).reshape(-1)[:1].contiguous()
    out = torch.empty((n, N_OUTPUTS), dtype=torch.float32, device=dev)
    tri_tab, trin_tab, sph_tab, mat_tab = tables

    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.halogen_megakernel_launch(
            origin.data_ptr(), direction.data_ptr(), far_t.data_ptr(),
            sidx.data_ptr(), sd.data_ptr(), tri_tab.data_ptr(),
            trin_tab.data_ptr(), sph_tab.data_ptr(), mat_tab.data_ptr(),
            out.data_ptr(), n, scene.num_triangles, scene.num_spheres,
            scene.materials.count, settings.max_bounces,
            settings.max_diffuse_bounces, settings.max_glossy_bounces,
            settings.max_transmission_bounces,
            int(settings.sampler == SamplerKind.SOBOL),
            int(settings.russian_roulette), stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def trace_color_fused_reference(scene: SceneData, origin, direction, far,
                                sample_idx, seed,
                                settings: RenderSettings) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same [N, 10] outputs from
    the lockstep integrator."""
    from halogen_tpu_torch.integrator.trace import trace_rays

    n = origin.shape[0]
    far_b = torch.as_tensor(far, dtype=torch.float32,
                            device=origin.device).reshape(-1)[0].expand(n)
    out = trace_rays(scene, origin, direction, far_b, sample_idx, seed,
                     settings)
    return torch.cat([out.color, out.miss_attenuation,
                      out.acc_roughness[:, None], out.direction], dim=1)


def trace_fused_outputs(scene: SceneData, origin, direction, far, sample_idx,
                        seed, settings: RenderSettings,
                        tables=None) -> torch.Tensor:
    """[N, 10] per-ray outputs: color rgb, miss attenuation rgb,
    accumulated roughness, final direction xyz. The kernel on a CUDA
    device, its plain version on the CPU."""
    if origin.device.type == "cuda":
        return _launch(scene, origin, direction, far, sample_idx, seed,
                       settings, tables)
    if origin.device.type != "cpu":
        raise ValueError(f"no megakernel for device {origin.device}")
    return trace_color_fused_reference(scene, origin, direction, far,
                                       sample_idx, seed, settings)


def trace_color_fused(scene: SceneData, origin, direction, far, sample_idx,
                      seed, settings: RenderSettings,
                      tables=None) -> torch.Tensor:
    """Fused megakernel forward: [N, 3] radiance. `tables` may carry
    `_scene_tables(scene)` computed once for many calls. Scenes with an
    envmap (whose deferred-miss sky pass would follow here) raise."""
    return trace_fused_outputs(scene, origin, direction, far, sample_idx,
                               seed, settings, tables)[:, :3]
