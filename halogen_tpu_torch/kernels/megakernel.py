"""Fused-bounce megakernel: the whole path loop of every ray in one CUDA
launch (port of `halogen_tpu/kernels/megakernel.py`: its brute-force tier
and its big-scene raylet tier).

The kernel is hand-written CUDA C++ for Hopper (`csrc/megakernel.cu`), in
compile-time variants of one bounce body (`csrc/path_common.cuh`):
opaque (B1a), nested dielectrics with a per-thread medium stack (B1b),
and envmap next-event estimation (B1c) alone or with the stack; each of
those in the brute tier (every triangle tested, tables in shared memory)
and in the BVH tier (B1d: the closest hit and the shadow ray walk the
scene's world BVH, `csrc/bvh_traverse.cuh`, in global memory).
It is compiled with `nvcc` for sm_90a at first use, into `_build/` beside
this package, from the sources in the repository (rebuilt when the hash
of any of them changes), and bound through ctypes. `load_library` builds
the adjoint kernel's library (`csrc/adjoint.cu`, `kernels/adjoint.py`)
and the world-BVH traversal kernel's (`csrc/traverse.cu`,
`kernels/traverse.py`) in the same step, one nvcc process per source.

`trace_fused_outputs` takes rays on a CUDA device to the kernel and rays
on the CPU to the plain PyTorch version, `trace_color_fused_reference`,
which runs the lockstep integrator; both give the same per-ray outputs.
A CUDA launch that fails raises; there is no fallback. `LAUNCHES` counts
kernel launches. `trace_color_fused` adds the sky from those outputs
(`integrator.trace.deferred_sky`: one lookup per ray, after the kernel,
as the Pallas wrapper does). `trace_color_fused_diff` is the
differentiable form: this kernel forward, the adjoint kernel backward
(envmap scenes and scenes over MAX_TRIS triangles have no backward on
this route yet, ROADMAP A8 and A9).

Scope (`fused_supported`, the JAX predicate): opaque and transmissive
scenes, with or without an envmap and its next-event estimation, without
area-light NEE or debug views, with at most MAX_SPHERES spheres and
MAX_MATERIALS materials; up to MAX_TRIS triangles on the brute tier, and
up to MAX_BVH_TRIS on the BVH tier, through the scene's world BVH.
MAX_BVH_TRIS is the JAX raylet tier's cap (`raylet.py:67`), which the
TPU's VMEM set (the whole triangle table resident in it); the BVH tier
keeps its tables in device memory and keeps the cap only to admit the
same scenes as the reference.
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
from halogen_tpu_torch.integrator.trace import _use_nee, deferred_sky
from halogen_tpu_torch.scene.envmap import env_draw_table

# Caps of the brute tier: the scene tables live in shared memory.
MAX_TRIS = 128
MAX_SPHERES = 32
MAX_MATERIALS = 64
# Triangle cap of the BVH tier (B1d): the JAX raylet tier's
MAX_BVH_TRIS = 200_000

# color rgb, miss attenuation rgb, acc roughness, dir xyz; with env NEE
# also the continuation pdf and NEE flag at the miss
N_OUTPUTS = 10
N_OUTPUTS_NEE = 12

LAUNCHES = 0  # kernel launches since the count was last set to 0

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# One shared library per kernel source, each with one C entry point:
# (function, pointer arguments, int arguments, then the stream). The
# megakernel and the adjoint include the bounce body in path_common.cuh;
# it and the traversal kernel include the walk in bvh_traverse.cuh.
LIBRARIES = {
    "megakernel": ("halogen_megakernel_launch", 12, 15),
    "adjoint": ("halogen_adjoint_launch", 14, 11),
    "traverse": ("halogen_traverse_launch", 13, 1),
}
_HEADERS = ("path_common.cuh", "geometry.cuh", "bvh_traverse.cuh")

_libs = {}
BUILD_SECONDS = None  # wall time of this process's nvcc builds (in parallel)
BUILD_LOG = ""  # nvcc's output (registers, shared memory, spills)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return path


def _digest() -> str:
    """Hash of every file the build reads, and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted([f"{lib}.cu" for lib in LIBRARIES] + list(_HEADERS)):
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def load_library(name: str = "megakernel") -> ctypes.CDLL:
    """Build (if needed) and load one kernel's shared library. A build
    compiles every library that is missing at once, one nvcc process per
    source, all started together."""
    global BUILD_SECONDS, BUILD_LOG
    if name in _libs:
        return _libs[name]
    digest = _digest()
    paths = {lib: os.path.join(_BUILD_DIR, f"{lib}_{digest}.so")
             for lib in LIBRARIES}
    todo = [lib for lib in LIBRARIES if not os.path.exists(paths[lib])]
    if todo:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        jobs = []
        for lib in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            src = os.path.join(_CSRC, f"{lib}.cu")
            jobs.append((lib, src, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for lib, src, tmp, proc in jobs:
            log = proc.communicate()[0]
            BUILD_LOG += f"[{lib}.cu]\n{log}"
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(src)
            else:
                os.replace(tmp, paths[lib])  # atomic: no half-written library
        BUILD_SECONDS = time.perf_counter() - t0
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD_LOG}")
    lib = ctypes.CDLL(paths[name])
    entry, n_ptr, n_int = LIBRARIES[name]
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    _libs[name] = lib
    return lib


def uses_bvh(scene: SceneData) -> bool:
    """Whether the kernel takes the BVH tier (B1d) for `scene`: over the
    brute tier's triangle cap, as the JAX wrapper picks its raylet tier
    (`megakernel.py:1708-1712`)."""
    return scene.num_triangles > MAX_TRIS


def fused_supported(scene: SceneData, settings: RenderSettings) -> bool:
    """Static eligibility for the port's fused megakernel: the JAX
    `fused_supported` (`megakernel.py:1608-1641`) on its brute and raylet
    tiers. Transmissive scenes, envmaps and env NEE are in; area-light
    NEE, debug views and scenes over the caps are out."""
    return (
        settings.debug_mode == DebugMode.NONE
        and not settings.light_importance_sampling
        and scene.num_triangles <= MAX_BVH_TRIS
        and scene.num_spheres <= MAX_SPHERES
        and scene.materials.count <= MAX_MATERIALS
        and (scene.num_triangles + scene.num_spheres) > 0
        and settings.sampler in (SamplerKind.SOBOL, SamplerKind.PRNG)
    )


def env_table(scene: SceneData) -> torch.Tensor | None:
    """The env-NEE draw table [H * W, 10] the kernel reads one row of per
    draw (`envmap.env_draw_table`), or None without alias tables."""
    if scene.env_cdf is None or not scene.env_mips:
        return None
    return env_draw_table(scene.env_cdf, scene.env_mips[0]).contiguous()


def _scene_tables(scene: SceneData):
    """Pack the scene into the kernel's tables: tri [T, 9] (v0, e1, e2),
    trin [T, 10] (n0, n1 - n0, n2 - n0, material), sph [S, 5] (center,
    radius, material) and mat [K, 17], all float32 and contiguous. On the
    BVH tier tri and trin are the world BVH's own, in its slot order."""
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
    if uses_bvh(scene):
        tri_tab, trin_tab = scene.wbvh.tris, scene.wbvh.trin
    else:
        tv = scene.tri_verts_world
        v0 = tv[:, 0]
        tri_tab = torch.cat([v0, tv[:, 1] - v0, tv[:, 2] - v0],
                            dim=1).contiguous()
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


def kernel_inputs(scene, origin, direction, far, sample_idx, seed,
                  settings: RenderSettings, tables):
    """Check rays and scene for a launch of the megakernel or its adjoint;
    returns (sample_idx, seed, far, tables, scalars) as the kernels take
    them: int32 bit views, a [1] far, contiguous float32 tables, and the
    int arguments both C entry points share (the megakernel's env-NEE
    ints follow them)."""
    if not fused_supported(scene, settings):
        raise NotImplementedError(
            "the CUDA megakernel covers scenes without area-light NEE or "
            f"debug views, with <= {MAX_SPHERES} spheres, <= "
            f"{MAX_MATERIALS} materials and <= {MAX_BVH_TRIS} triangles "
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
    far_t = torch.as_tensor(far, dtype=torch.float32,
                            device=dev).reshape(-1)[:1].contiguous()
    scalars = (n, scene.num_triangles, scene.num_spheres,
               scene.materials.count, settings.max_bounces,
               settings.max_diffuse_bounces, settings.max_glossy_bounces,
               settings.max_transmission_bounces,
               int(settings.sampler == SamplerKind.SOBOL),
               int(settings.russian_roulette), int(scene.any_transmissive))
    return sidx.contiguous(), sd.contiguous(), far_t, tables, scalars


def _launch(scene, origin, direction, far, sample_idx, seed,
            settings: RenderSettings, tables, env_tab=None) -> torch.Tensor:
    """Launch the kernel variant the scene and settings select, on the
    current stream; returns [N, 10], or [N, 12] with env NEE."""
    global LAUNCHES
    sidx, sd, far_t, tables, scalars = kernel_inputs(
        scene, origin, direction, far, sample_idx, seed, settings, tables)
    dev = origin.device
    bvh = uses_bvh(scene)
    nodes = scene.wbvh.nodes if bvh else None
    if bvh and (nodes.device != dev or nodes.dtype != torch.float32
                or not nodes.is_contiguous() or nodes.data_ptr() % 16
                or nodes.ndim != 2 or nodes.shape[1] != 8):
        raise ValueError("the world BVH's nodes must be a contiguous, "
                         f"16-byte aligned float32 [Nn, 8] tensor on {dev}")
    env_nee = _use_nee(scene, settings)
    env_h = env_w = 0
    if env_nee:
        env_tab = env_tab if env_tab is not None else env_table(scene)
        env_h, env_w = scene.env_cdf.pdf.shape
        if (env_tab.shape != (env_h * env_w, 10) or env_tab.device != dev
                or env_tab.dtype != torch.float32
                or not env_tab.is_contiguous()):
            raise ValueError("the env draw table must be a contiguous "
                             f"float32 [{env_h * env_w}, 10] on {dev}")
    out = torch.empty(
        (origin.shape[0], N_OUTPUTS_NEE if env_nee else N_OUTPUTS),
        dtype=torch.float32, device=dev)
    lib = load_library("megakernel")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.halogen_megakernel_launch(
            origin.data_ptr(), direction.data_ptr(), far_t.data_ptr(),
            sidx.data_ptr(), sd.data_ptr(),
            *(t.data_ptr() for t in tables),
            nodes.data_ptr() if bvh else None,
            env_tab.data_ptr() if env_nee else None, out.data_ptr(),
            *scalars, int(env_nee), env_h, env_w, int(bvh), stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def trace_color_fused_reference(scene: SceneData, origin, direction, far,
                                sample_idx, seed,
                                settings: RenderSettings) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same [N, 10] (or, with env
    NEE, [N, 12]) outputs from the lockstep integrator, its closest hits
    by brute force whatever the scene's size (independent of the BVH that
    the kernel's BVH tier walks)."""
    from halogen_tpu_torch.config import Intersector
    from halogen_tpu_torch.integrator.trace import trace_rays

    n = origin.shape[0]
    far_b = torch.as_tensor(far, dtype=torch.float32,
                            device=origin.device).reshape(-1)[0].expand(n)
    return trace_rays(scene, origin, direction, far_b, sample_idx, seed,
                      settings.replace(intersector=Intersector.BRUTE)
                      ).outputs


def trace_fused_outputs(scene: SceneData, origin, direction, far, sample_idx,
                        seed, settings: RenderSettings, tables=None,
                        env_tab=None) -> torch.Tensor:
    """[N, 10] per-ray outputs: color rgb gathered along the path (the sky
    excluded), miss attenuation rgb, accumulated roughness, final
    direction xyz; with env NEE [N, 12], adding the continuation pdf and
    NEE flag at the miss. The kernel on a CUDA device, its plain version
    on the CPU."""
    if origin.device.type == "cuda":
        return _launch(scene, origin, direction, far, sample_idx, seed,
                       settings, tables, env_tab)
    if origin.device.type != "cpu":
        raise ValueError(f"no megakernel for device {origin.device}")
    return trace_color_fused_reference(scene, origin, direction, far,
                                       sample_idx, seed, settings)


def trace_color_fused(scene: SceneData, origin, direction, far, sample_idx,
                      seed, settings: RenderSettings, tables=None,
                      env_tab=None) -> torch.Tensor:
    """Fused megakernel forward: [N, 3] radiance, the kernel's path color
    plus the deferred sky (JAX `megakernel.py:1868-1900`). `tables` and
    `env_tab` may carry `_scene_tables(scene)` and `env_table(scene)`
    computed once for many calls."""
    return deferred_sky(scene, settings, trace_fused_outputs(
        scene, origin, direction, far, sample_idx, seed, settings, tables,
        env_tab))


class _FusedDiff(torch.autograd.Function):
    """Megakernel forward, adjoint-kernel backward: the port of the JAX
    package's custom_vjp (`megakernel.py:1904-1978`) on its fused-adjoint
    route. Only the material table gets a cotangent; geometry, camera
    rays and far get none (use `Fused.OFF` to differentiate geometry).
    Scenes outside `adjoint_supported` (an envmap in use, or more than
    MAX_TRIS triangles) have no backward here yet: the JAX package replays
    them with the lockstep vjp (`megakernel.py:1953-1975`), which the port
    brings with the envmap gradients (ROADMAP A8) and the big-scene
    backward (ROADMAP A9)."""

    @staticmethod
    def forward(ctx, scene, settings, env_tab, tri_tab, trin_tab, sph_tab,
                mat_tab, origin, direction, far, sample_idx, seed):
        tables = (tri_tab, trin_tab, sph_tab, mat_tab)
        ctx.scene, ctx.settings = scene, settings
        # the rays of this launch, not a graph of its bounces
        ctx.save_for_backward(*tables, origin, direction, far, sample_idx,
                              seed)
        return trace_color_fused(scene, origin, direction, far, sample_idx,
                                 seed, settings, tables, env_tab)

    @staticmethod
    def backward(ctx, grad_color):
        from halogen_tpu_torch.kernels import adjoint as adj

        if not adj.adjoint_supported(ctx.scene, ctx.settings):
            if ctx.scene.num_triangles > MAX_TRIS:
                raise NotImplementedError(
                    "not ported yet: the backward of a scene over "
                    f"MAX_TRIS = {MAX_TRIS} triangles (ROADMAP A9)")
            raise NotImplementedError(
                "envmap gradients are not ported yet: the backward of an "
                "envmap scene (ROADMAP A8)")
        *tables, origin, direction, far, sample_idx, seed = ctx.saved_tensors
        mat_tab = tables[3]
        d_mat = None
        if ctx.needs_input_grad[6]:  # mat_tab
            # grad_color may be an expanded view (stride 0) of the
            # per-pixel cotangent: the kernel reads a dense [N, 3]
            dmat12 = adj.trace_grad_fused_materials(
                ctx.scene, origin, direction, far, sample_idx, seed,
                grad_color.contiguous(), ctx.settings, tables=tuple(tables))
            # [K, 12] columns onto _scene_tables' [K, 17] layout; autograd
            # chains col 9:12 through the rgb * intensity product
            d_mat = torch.zeros_like(mat_tab)
            d_mat[:, 9:12] = dmat12[:, 0:3]   # emission, premultiplied
            d_mat[:, 0:3] = dmat12[:, 3:6]    # albedo rgb
            d_mat[:, 4:7] = dmat12[:, 6:9]    # specular
            d_mat[:, 13:16] = dmat12[:, 9:12]  # absorption
        return (None, None, None, None, None, None, d_mat, None, None, None,
                None, None)


def trace_color_fused_diff(scene: SceneData, origin, direction, far,
                           sample_idx, seed, settings: RenderSettings,
                           tables=None, env_tab=None) -> torch.Tensor:
    """Differentiable fused tracer (port of the JAX
    `trace_color_fused_diff`, `megakernel.py:1981-1993`): [N, 3] radiance
    from `trace_color_fused`, whose backward is the adjoint kernel
    (`kernels/adjoint.py`), or its plain version on the CPU. Gradients
    reach the scene's material table through `_scene_tables(scene)`."""
    dev = origin.device
    tables = tables if tables is not None else _scene_tables(scene)
    far = torch.as_tensor(far, dtype=torch.float32, device=dev)
    sample_idx = torch.as_tensor(sample_idx, device=dev)
    seed = torch.as_tensor(seed, device=dev)
    return _FusedDiff.apply(scene, settings, env_tab, *tables, origin,
                            direction, far, sample_idx, seed)
