"""Fused-bounce megakernel: the whole path loop of every ray in one CUDA
launch (port of `halogen_tpu/kernels/megakernel.py`: its brute-force tier
and its big-scene raylet tier).

The kernel is hand-written CUDA C++ for Hopper (`csrc/megakernel.cu`), in
compile-time variants of one bounce body (`csrc/path_common.cuh`):
opaque (B1a), nested dielectrics with a per-thread medium stack (B1b),
and envmap next-event estimation (B1c) alone or with the stack; each of
those in the brute tier (every triangle tested, tables in shared memory)
and in the BVH tier (B1d: the closest hit and the shadow ray walk the
scene's world BVH, `csrc/bvh_traverse.cuh`, in global memory); and each
of those eight with area-light next-event estimation (B1e, the light
table of `light_table`), which the JAX package runs only in its lockstep;
on the brute tier its shadow ray skips the triangles whose plane its
segment cannot cross (`light_cull_reference` is that test's plain
version).
Where a gradient follows on the adjoint's record route
(`adjoint.record_plan`), the launch, on either tier, also records the
transcript the adjoint's sweep reads (`Record`, `empty_record`), so the
backward does not trace the paths again; with area-light NEE the record
also holds each hit's emission weight and the light term's factors and
material (its recording variants are B2+l's forward). Past the budget a
light-NEE launch from pixels records nothing, and its backward launches
the recording variant again on the same pixels (`grad_route`
'rerecord').
It is compiled with `nvcc` for sm_90a at first use, into `_build/` beside
this package, from the sources in the repository (rebuilt when the hash
of any of them changes), and bound through ctypes. `load_library` builds
the adjoint kernel's library (`csrc/adjoint.cu`, `kernels/adjoint.py`)
and the world-BVH traversal kernel's (`csrc/traverse.cu`,
`kernels/traverse.py`) and the sky pair's (`csrc/sky.cu`,
`kernels/sky.py`) in the same step, one nvcc process per source.

`trace_fused_outputs` takes rays on a CUDA device to the kernel and rays
on the CPU to the plain PyTorch version, `trace_color_fused_reference`,
which runs the lockstep integrator; both give the same per-ray outputs.
A CUDA launch that fails raises; there is no fallback. `LAUNCHES` counts
kernel launches. `trace_color_fused` adds the sky from those outputs
(`integrator.trace.deferred_sky`: one lookup per ray, after the kernel,
as the Pallas wrapper does; on a CUDA device the sky kernel,
`kernels/sky.py`). `trace_color_fused_diff` is the differentiable form:
this kernel forward, the adjoint kernel backward (`kernels/adjoint.py`),
on every scene the kernel renders; the sky pass's backward kernel gives
the envmap's cotangents and those the adjoint takes at the miss.
`trace_color_chunk` is the frame driver's form of it for a chunk of
pixels: one call, and under autograd one node (`_FusedChunk`), for all
the chunk's launch groups, where `chunk_serves` says so (no gradient, or
the record route without a sky pass); the C entry point loops over the
groups, and the lanes' sums run in a kernel of this library.

Scope (`fused_supported`, the JAX predicate without its refusal of
area-light NEE): opaque and transmissive scenes, with or without an
envmap and its next-event estimation and area-light NEE, without debug
views, with at most MAX_SPHERES spheres and
MAX_MATERIALS materials; up to MAX_TRIS triangles on the brute tier, and
up to MAX_BVH_TRIS on the BVH tier, through the scene's world BVH.
MAX_BVH_TRIS is the JAX raylet tier's cap (`raylet.py:67`), which the
TPU's VMEM set (the whole triangle table resident in it); the BVH tier
keeps its tables in device memory and keeps the cap only to admit the
same scenes as the reference.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
import weakref

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from halogen_tpu_torch.config import DebugMode, RenderSettings, SamplerKind
from halogen_tpu_torch.core.types import SceneData
from halogen_tpu_torch.integrator.camera import Camera
from halogen_tpu_torch.integrator.trace import (
    _use_light_nee,
    _use_nee,
    group_rays,
)
from halogen_tpu_torch.sampler import sobol as sob
from halogen_tpu_torch.scene.envmap import _texel_direction, env_draw_table
from halogen_tpu_torch.utils.profiling import annotate

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
RECORD_LAUNCHES = 0  # of them, launches that recorded the transcript
CHUNK_NODES = 0  # calls of the chunk node (`_FusedChunk`)
CHUNK_GROUPS = 0  # the launch groups those calls served
LANE_SUM_LAUNCHES = 0  # launches of `lane_sum`, one a group they served

# The light-NEE probe (`light_probe`; csrc/path_common.cuh `LightProbe`):
# the counters it keeps a ray, and its modes (which of the two shadow
# tests run, the closest-hit rule's and the kernel's own, and which
# decides), on either tier
PROBE_COUNTERS = ("shadow_rays", "blocked", "tri_tests_closest",
                  "box_tests_closest", "tri_tests_kernel",
                  "box_tests_kernel", "tris_culled", "decisions_differ",
                  "ties")
PROBE_WORDS = len(PROBE_COUNTERS)  # path_common.cuh kProbeWords
PROBE_MODES = {"closest": 0, "kernel": 1, "closest only": 2,
               "kernel only": 3, "no test": 4}
# the cull's margin factor (path_common.cuh kCullMargin): 32 u, u = 2^-24
CULL_MARGIN = 2.0 ** -19

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# One shared library per kernel source, with its C entry points:
# {function: (pointer arguments, int arguments, float arguments)}, then
# the stream. The megakernel and the adjoint include the bounce body in
# path_common.cuh; it and the traversal kernel include the walk in
# bvh_traverse.cuh.
LIBRARIES = {
    "megakernel": {"halogen_megakernel_launch": (26, 23, 0),
                   "halogen_megakernel_chunk": (22, 23, 0),
                   "halogen_lane_sum": (2, 3, 0)},
    "adjoint": {"halogen_adjoint_launch": (19, 15, 0),
                "halogen_adjoint_sweep": (14, 7, 0),
                "halogen_adjoint_sweep_chunk": (9, 7, 0)},
    "traverse": {"halogen_traverse_launch": (13, 1, 0)},
    "sky": {"halogen_sky_forward": (5, 6, 2),
            "halogen_sky_backward": (9, 8, 2),
            "halogen_sky_order": (8, 5, 0),
            "halogen_sky_sum": (8, 4, 0)},
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
    for entry, (n_ptr, n_int, n_float) in LIBRARIES[name].items():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
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
    tiers, but area-light NEE, which the port's kernel has (B1e) and the
    Pallas kernel has not. Transmissive scenes, envmaps, env NEE and
    light NEE are in; debug views and scenes over the caps are out."""
    return (
        settings.debug_mode == DebugMode.NONE
        and scene.num_triangles <= MAX_BVH_TRIS
        and scene.num_spheres <= MAX_SPHERES
        and scene.materials.count <= MAX_MATERIALS
        and (scene.num_triangles + scene.num_spheres) > 0
        and settings.sampler in (SamplerKind.SOBOL, SamplerKind.PRNG)
    )


def env_table(scene: SceneData) -> torch.Tensor | None:
    """The env-NEE draw table the kernel reads one row of per draw, or
    None without alias tables: [H * W, 16], a row four 16-byte loads:
    (alias_p, alias_j, pdf, alias pdf) | (texel radiance rgb, direction x)
    | (alias radiance rgb, alias direction x) | (direction yz, alias
    direction yz). The first ten values are `envmap.env_draw_table`'s; the
    directions are those `envmap.sample_env_draw` computes for the texel
    and for its alias, stored so that a draw needs no sine or cosine. The
    table is data for the kernels (detached): the radiance's cotangent
    reaches the finest mip through the adjoint's env-NEE records."""
    if scene.env_cdf is None or not scene.env_mips:
        return None
    cdf = scene.env_cdf
    h, w = cdf.pdf.shape
    draw = env_draw_table(cdf, scene.env_mips[0])
    own = _texel_direction(torch.arange(h * w, device=draw.device), h, w)
    alias = own[cdf.alias_j.to(torch.int64)]
    return torch.cat([draw[:, 0:7], own[:, 0:1], draw[:, 7:10],
                      alias[:, 0:1], own[:, 1:3], alias[:, 1:3]],
                     dim=1).detach().to(torch.float32).contiguous()


class LightRows(NamedTuple):
    """Area-light NEE's tables for the kernel (`light_table`)."""

    rows: torch.Tensor  # [L, 16] float32, a light a row
    dens: torch.Tensor  # [T + S] float32


def light_table(scene: SceneData) -> LightRows | None:
    """The light table as the kernel reads it, or None without emitters:
    rows [L, 16], a light four 16-byte loads: (cdf, sel, pdf_area, code) |
    (its material's emission rgb, premultiplied as `_scene_tables`' col
    9:12; p0.x) | (p0.yz, p1.xy) | (p1.z, p2.xyz), where code is the
    triangle's index in the kernel's triangle order (on the BVH tier its
    slot, through the inverse of `WorldBVH.tri_map`) or -1 - the sphere's,
    and p0-p2 are the triangle's world vertices or the sphere's (center,
    radius, 0, ...). dens [T + S]: each triangle's pdf_area in the same
    order, then each sphere's selection probability, for the emission's
    MIS weight at a hit. So the BVH tier needs no map from a global
    triangle id to a slot. Data for the kernel (detached)."""
    lt = scene.lights
    if lt is None:
        return None
    dev = lt.cdf.device
    n_t, n_s, n_l = scene.num_triangles, scene.num_spheres, lt.count
    is_tri = lt.kind == 0
    idx = lt.idx.to(torch.int64)
    tri = torch.where(is_tri, idx, 0)
    sph = torch.where(is_tri, 0, idx)
    tri_pdf = scene.tri_light_pdf_area[:n_t]
    code = tri
    if uses_bvh(scene):  # global id -> slot, and the pdfs in slot order
        tri_map = scene.wbvh.tri_map.to(torch.int64)
        slot = torch.empty_like(tri_map)
        slot[tri_map] = torch.arange(n_t, device=dev)
        code = slot[tri]
        tri_pdf = tri_pdf[tri_map]
    code = torch.where(is_tri, code, -1 - idx).to(torch.float32)
    zero = torch.zeros((n_l,), dtype=torch.int64, device=dev)
    mat = torch.where(
        is_tri, scene.tri_material[tri].to(torch.int64) if n_t else zero,
        scene.sphere_material[sph].to(torch.int64) if n_s else zero)
    em = scene.materials.emissive[mat]
    em = em[:, :3] * em[:, 3][:, None]
    geo_t = (scene.tri_verts_world[tri].reshape(n_l, 9) if n_t
             else torch.zeros((n_l, 9), device=dev))
    geo_s = (torch.cat([scene.sphere_center[sph],
                        scene.sphere_radius[sph][:, None],
                        torch.zeros((n_l, 5), device=dev)], dim=1) if n_s
             else torch.zeros((n_l, 9), device=dev))
    geo = torch.where(is_tri[:, None], geo_t, geo_s)
    rows = torch.cat([lt.cdf[:, None], lt.sel[:, None], lt.pdf_area[:, None],
                      code[:, None], em, geo], dim=1)
    dens = torch.cat([tri_pdf, scene.sphere_light_sel[:n_s]])
    f32 = torch.float32
    return LightRows(rows.detach().to(f32).contiguous(),
                     dens.detach().to(f32).contiguous())


class Record(NamedTuple):
    """The transcript a forward launch records for the adjoint's sweep
    (`csrc/path_common.cuh` `RecordView`), slot-major: slot k of ray i is
    row [k, i]. Slots at or past a ray's shaded count are never written.
    With area-light NEE the word also holds the light term's material
    (bits 21-26) and whether the term was added (bit 27)."""

    a: torch.Tensor  # [B + 1, N, 4] float32: attenuation before, t
    word: torch.Tensor  # [B + 1, N] int32: materials and masks
    end: torch.Tensor  # [N] int32: shaded bounces | missed << 31
    # with env NEE: the NEE radiance * weight rgb, dterm | gterm, weight |
    # the drawn texel (-1: none); else None
    nq: torch.Tensor | None  # [B + 1, N, 4] float32
    ngw: torch.Tensor | None  # [B + 1, N, 2] float32
    texel: torch.Tensor | None  # [B + 1, N] int32
    # with area-light NEE: the light term's f = w_l / pdf, dterm, gterm
    # (zeros where it was not added) and the emission's balance weight at
    # the hit; else None
    lq: torch.Tensor | None = None  # [B + 1, N, 4] float32

    @property
    def n(self) -> int:
        return self.end.shape[-1]


# Every record allocated and not yet freed: (a weak reference to the
# storage of its largest buffer, its device, its bytes). A record lives
# until the backward that reads it, or until its graph is dropped, so a
# plan (`adjoint.record_plan`) counts those of earlier forwards.
_LIVE_RECORDS: list = []


def record_words(env_nee: bool, light_nee: bool) -> int:
    """32-bit words a `Record` keeps a slot: a_prev rgb, t and the packed
    word; with env NEE 7 more (its radiance * weight rgb, dterm, gterm,
    weight, texel); with area-light NEE 4 more (f, dterm, gterm, the
    emission's weight)."""
    return 5 + (7 if env_nee else 0) + (4 if light_nee else 0)


def _record_shapes(n: int, settings: RenderSettings, env_nee: bool,
                   light_nee: bool, groups: int | None) -> tuple:
    """(shape, dtype) of each field of a `Record`, or None where the
    field is absent; with `groups`, a leading group axis on each."""
    slots = settings.max_bounces + 1
    lead = () if groups is None else (groups,)
    f32, i32 = torch.float32, torch.int32
    return (((*lead, slots, n, 4), f32), ((*lead, slots, n), i32),
            ((*lead, n), i32),
            ((*lead, slots, n, 4), f32) if env_nee else None,
            ((*lead, slots, n, 2), f32) if env_nee else None,
            ((*lead, slots, n), i32) if env_nee else None,
            ((*lead, slots, n, 4), f32) if light_nee else None)


def empty_record(n: int, settings: RenderSettings, env_nee: bool,
                 device, light_nee: bool = False,
                 groups: int | None = None) -> Record:
    """Buffers of a `Record` of n rays and max_bounces + 1 slots (4 bytes
    a ray, and `record_words` a slot: 20 bytes, 48 with env NEE, 16 more
    with area-light NEE), counted by `live_record_bytes` until they are
    freed. With `groups`, the records of that many launches of n rays in
    one: each buffer gets a leading group axis, so group g's record is
    `Record(*(t[g] for t in rec))`, each of its buffers contiguous."""
    rec = Record(*(None if w is None else torch.empty(w[0], dtype=w[1],
                                                      device=device)
                   for w in _record_shapes(n, settings, env_nee, light_nee,
                                           groups)))
    slots = settings.max_bounces + 1
    _LIVE_RECORDS.append((StorageWeakRef(rec.a.untyped_storage()),
                          rec.a.device,
                          4 * n * (1 + slots * record_words(env_nee,
                                                            light_nee))
                          * (1 if groups is None else groups)))
    return rec


def live_record_bytes(device) -> int:
    """Bytes of the records on `device` still alive (`empty_record`)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    _LIVE_RECORDS[:] = [r for r in _LIVE_RECORDS if not r[0].expired()]
    return sum(b for _, d, b in _LIVE_RECORDS if d == device)


def check_record(rec: Record, n: int, settings: RenderSettings,
                 env_nee: bool, dev, light_nee: bool = False,
                 groups: int | None = None) -> None:
    """Raise unless `rec` is a `Record` of n rays for these settings on
    `dev` (with `groups`, of that many launches): contiguous buffers of
    `empty_record`'s shapes and types."""
    want = _record_shapes(n, settings, env_nee, light_nee, groups)
    for name, t, w in zip(Record._fields, rec, want):
        if w is None:
            if t is not None:
                raise ValueError(
                    f"record {name}: only with "
                    f"{'area-light' if name == 'lq' else 'env'} NEE")
        elif (t is None or t.shape != w[0] or t.dtype != w[1]
              or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"record {name} must be a contiguous {w[1]} "
                             f"{list(w[0])} on {dev}")


def light_probe(scene: SceneData, origin, direction, far, sample_idx, seed,
                settings: RenderSettings, mode: str = "kernel", tables=None,
                light_tab=None) -> tuple[torch.Tensor, torch.Tensor]:
    """A measurement of B1e's light shadow rays, not a render's path: the
    probe variant of the kernel (CUDA only; either tier, with area-light
    NEE, without env NEE) on explicit rays. Each light shadow ray has two
    tests: the closest-hit rule's (B1e's rule before its redesign: on the
    BVH tier a closest-hit walk under the bound, on the brute tier
    Möller-Trumbore on every triangle) and the kernel's own (the any-hit
    walk; the culled scan, whose plain version is `light_cull_reference`).
    `mode` (PROBE_MODES): "closest" and "kernel" run both and let that one
    decide; "closest only", "kernel only" and "no test" (every draw
    visible) run one test or none, for their times. Returns ([N, 10]
    outputs, [N, PROBE_WORDS] int32 counters of each ray:
    PROBE_COUNTERS)."""
    if origin.device.type != "cuda":
        raise ValueError("the light-NEE probe runs on a CUDA device")
    counts = torch.empty((origin.shape[0], PROBE_WORDS), dtype=torch.int32,
                         device=origin.device)
    out = _launch(scene, origin, direction, far, sample_idx, seed, settings,
                  tables, light_tab=light_tab,
                  probe=(counts, PROBE_MODES[mode]))
    return out, counts


def light_cull_reference(tri_tab: torch.Tensor, origin: torch.Tensor,
                         direction: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """Plain version of the brute tier's light shadow cull
    (`csrc/path_common.cuh` `shadow_tris`, the same float32 ops in the same
    order): [N, T] bool, whether ray i's segment [o, o + d b_i] lies beyond
    the margin on one side of triangle j's plane, so that Möller-Trumbore
    is skipped. `tri_tab` [T, 12] is `_scene_tables`' brute-tier table
    (v0, e1, e2, the normal cross(e1, e2)); origin, direction [N, 3]; b
    [N]."""
    v0, e1, e2, n = (tri_tab[None, :, k:k + 3] for k in (0, 3, 6, 9))
    o, d = origin[:, None, :], direction[:, None, :]
    dot = lambda a, c: (a[..., 0] * c[..., 0] + a[..., 1] * c[..., 1]
                        + a[..., 2] * c[..., 2])
    l1 = lambda a: a[..., 0].abs() + a[..., 1].abs() + a[..., 2].abs()
    tvec = o - v0
    bd = b * l1(direction)
    s0 = dot(tvec, n)
    s1 = s0 + b[:, None] * dot(d, n)
    m = CULL_MARGIN * (l1(e1) * l1(e2)) * (l1(tvec) + bd[:, None])
    return ((s0 > m) & (s1 > m)) | ((s0 < -m) & (s1 < -m))


def _scene_tables(scene: SceneData):
    """Pack the scene into the kernel's tables: tri [T, 12] (v0, e1, e2
    and the geometric normal cross(e1, e2), which the light shadow test's
    cull reads: three 16-byte loads a row), trin [T, 10] (n0, n1 - n0,
    n2 - n0, material), sph [S, 5] (center, radius, material) and mat
    [K, 17], all float32 and contiguous. The normal is the cross product
    of the stored e1 and e2 in float64, rounded once to float32 (the
    cull's margin counts that rounding). On the BVH tier tri and trin are
    the world BVH's own, in its slot order, with zeros there; on the brute
    tier they are made once for the scene's triangles (`_tri_tables`)."""
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
        tri_tab, trin_tab = _tri_tables(scene)
    sph_tab = torch.cat([scene.sphere_center, scene.sphere_radius[:, None],
                         scene.sphere_material.to(f32)[:, None]],
                        dim=1).contiguous()
    return tri_tab, trin_tab, sph_tab, mat_tab


# The brute tier's triangle tables of each scene (`_tri_tables`), by the
# ids of the tensors they are made from: (weak references to those
# tensors, their versions, the tables)
_TRI_TABLES: dict = {}


def _tri_tables(scene: SceneData) -> tuple:
    """`_scene_tables`' brute-tier tri and trin. A frame and each step of
    a gradient ask for them again, so they are made once for the scene's
    triangle tensors and kept while those live, unchanged: a new tensor
    (a scene built or replaced anew) or one changed in place makes them
    anew. Made from tensors that require grad (the tables then join
    their graph) or from inference tensors (which keep no version), they
    are made on every call."""
    src = (scene.tri_verts_world, scene.tri_normals_world,
           scene.tri_material)
    key = tuple(id(t) for t in src)
    keep = not any(t.is_inference() or t.requires_grad for t in src)
    stamp = tuple(t._version for t in src) if keep else None
    kept = _TRI_TABLES.get(key)
    if (keep and kept is not None and kept[1] == stamp
            and all(r() is t for r, t in zip(kept[0], src))):
        return kept[2]
    f32 = torch.float32
    tv, tn, tm = src
    v0 = tv[:, 0]
    e1, e2 = tv[:, 1] - v0, tv[:, 2] - v0
    normal = torch.linalg.cross(e1.double(), e2.double()).to(f32)
    tri_tab = torch.cat([v0, e1, e2, normal], dim=1).contiguous()
    n0 = tn[:, 0]
    trin_tab = torch.cat([n0, tn[:, 1] - n0, tn[:, 2] - n0,
                          tm.to(f32)[:, None]], dim=1).contiguous()
    for k in [k for k, v in _TRI_TABLES.items()
              if any(r() is None for r in v[0])]:
        del _TRI_TABLES[k]
    if keep:
        _TRI_TABLES[key] = (tuple(weakref.ref(t) for t in src), stamp,
                            (tri_tab, trin_tab))
    return tri_tab, trin_tab


def _as_i32(u: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> their int32 bit pattern (an int32
    tensor already is one: the rays a pixel launch wrote)."""
    if u.dtype == torch.int32:
        return u
    return (((u & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


class PixelView(NamedTuple):
    """What a launch from pixels reads beside the scene: the camera block,
    the frame word and the chunk's pixels (`pixel_view`)."""

    camera: Camera
    block: torch.Tensor | None  # [24] float32 (`camera_block`); CUDA only
    frame_word: torch.Tensor | None  # [1] int32 bits of the frame
    frame: object  # int, or a device tensor
    pix: torch.Tensor  # [n] int64 flat pixel ids


def camera_block(camera: Camera, settings: RenderSettings) -> torch.Tensor:
    """The kernel's camera block, [24] float32 on the camera's device: the
    [4, 4] camera-to-world matrix row-major, half_w, half_h, near, focal
    distance, aperture radius, the filter radius and two unused (which
    repeat it)."""
    dev = camera.cam_to_world.device
    scalars = torch.stack([camera.half_w, camera.half_h, camera.near,
                           camera.focal_distance, camera.aperture_radius])
    # filled on the device: no copy from the host
    rest = torch.full((3,), settings.filter_radius, dtype=torch.float32,
                      device=dev)
    return torch.cat([camera.cam_to_world.reshape(16), scalars,
                      rest]).to(torch.float32).contiguous()


def pixel_view(camera: Camera, settings: RenderSettings, frame,
               pix: torch.Tensor) -> PixelView:
    """A `PixelView` for launches that render `pix` [n] at `frame` (an int,
    or a device tensor): made once for all groups of a chunk."""
    if pix.dtype != torch.int64 or pix.ndim != 1:
        raise ValueError("pix must be a flat int64 tensor")
    camera = camera.to(pix.device)
    if pix.device.type != "cuda":
        return PixelView(camera, None, None, frame, pix)
    if isinstance(frame, torch.Tensor):
        word = _as_i32(frame.to(pix.device, torch.int64).reshape(-1)[:1])
    else:  # the uint32's int32 bit pattern, filled on the device
        bits = int(frame) & 0xFFFFFFFF
        word = torch.full((1,), bits - ((bits & 0x80000000) << 1),
                          dtype=torch.int32, device=pix.device)
    return PixelView(camera, camera_block(camera, settings),
                     word.contiguous(), frame, pix.contiguous())


_NOT_COVERED = (
    f"the CUDA megakernel covers scenes with <= {MAX_SPHERES} spheres, <= "
    f"{MAX_MATERIALS} materials and <= {MAX_BVH_TRIS} triangles (the JAX "
    "package's fused tiers' caps), without a debug view: the lockstep "
    "integrator renders those")


def _scene_inputs(scene, settings: RenderSettings, tables, dev):
    """Check scene and tables for a launch on `dev`; returns (tables, the
    int arguments that follow the ray count in both C entry points)."""
    if not fused_supported(scene, settings):
        raise NotImplementedError(_NOT_COVERED)
    tables = tables if tables is not None else _scene_tables(scene)
    for t in tables:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("scene tables must be contiguous float32 on "
                             f"{dev}")
    ints = (scene.num_triangles, scene.num_spheres,
            scene.materials.count, settings.max_bounces,
            settings.max_diffuse_bounces, settings.max_glossy_bounces,
            settings.max_transmission_bounces,
            int(settings.sampler == SamplerKind.SOBOL),
            int(settings.russian_roulette), int(scene.any_transmissive))
    return tables, ints


def _far_word(far, dev) -> torch.Tensor:
    return torch.as_tensor(far, dtype=torch.float32,
                           device=dev).reshape(-1)[:1].contiguous()


def kernel_inputs(scene, origin, direction, far, sample_idx, seed,
                  settings: RenderSettings, tables):
    """Check rays and scene for a launch of the megakernel or its adjoint;
    returns (sample_idx, seed, far, tables, scalars) as the kernels take
    them: int32 bit views, a [1] far, contiguous float32 tables, and the
    int arguments both C entry points share (the megakernel's own follow
    them)."""
    n = origin.shape[0]
    dev = origin.device
    if origin.shape != (n, 3) or direction.shape != (n, 3):
        raise ValueError("origin and direction must be [N, 3]")
    for name, t in (("origin", origin), ("direction", direction)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, rays on {dev}")
    tables, ints = _scene_inputs(scene, settings, tables, dev)
    sidx = _as_i32(torch.as_tensor(sample_idx, device=dev)).expand(n)
    sd = _as_i32(torch.as_tensor(seed, device=dev)).expand(n)
    return (sidx.contiguous(), sd.contiguous(), _far_word(far, dev), tables,
            (n, *ints))


class _Variant(NamedTuple):
    """What selects and feeds the kernel variant beside the rays
    (`_variant`): the BVH tier's nodes, env NEE's draw table and
    area-light NEE's light table, each checked, or None where unused."""

    bvh: bool
    nodes: torch.Tensor | None
    env_nee: bool
    env_tab: torch.Tensor | None
    env_hw: tuple
    light_tab: LightRows | None

    def ints(self) -> tuple:
        """The int arguments of both C entry points that follow the
        scalars: env NEE, its map's height and width, the BVH tier."""
        return (int(self.env_nee), *self.env_hw, int(self.bvh))

    def light_ints(self) -> tuple:
        """Area-light NEE, and its light count."""
        if self.light_tab is None:
            return (0, 0)
        return (1, self.light_tab.rows.shape[0])

    def light_ptrs(self) -> tuple:
        if self.light_tab is None:
            return (None, None)
        return tuple(t.data_ptr() for t in self.light_tab)


def _variant(scene, settings: RenderSettings, tables, env_tab, light_tab,
             dev) -> _Variant:
    """Check the BVH tier's nodes and triangles, the env draw table and the
    light table the scene and settings select, on `dev` (the tables made
    where None is given)."""
    bvh = uses_bvh(scene)
    nodes = scene.wbvh.nodes if bvh else None
    if bvh and (nodes.device != dev or nodes.dtype != torch.float32
                or not nodes.is_contiguous() or nodes.data_ptr() % 16
                or nodes.ndim != 2 or nodes.shape[1] != 8
                or tables[0].shape != (scene.num_triangles, 12)
                or tables[0].data_ptr() % 16):
        raise ValueError("the world BVH's nodes and triangles must be "
                         "contiguous, 16-byte aligned float32 [Nn, 8] and "
                         f"[T, 12] tensors on {dev}")
    env_nee = _use_nee(scene, settings)
    env_hw = (0, 0)
    if env_nee:
        env_tab = env_tab if env_tab is not None else env_table(scene)
        env_hw = tuple(scene.env_cdf.pdf.shape)
        env_h, env_w = env_hw
        if (env_tab.shape != (env_h * env_w, 16) or env_tab.device != dev
                or env_tab.dtype != torch.float32
                or not env_tab.is_contiguous() or env_tab.data_ptr() % 16):
            raise ValueError("the env draw table must be a contiguous, "
                             "16-byte aligned float32 "
                             f"[{env_h * env_w}, 16] on {dev}")
    if _use_light_nee(scene, settings):
        light_tab = light_tab if light_tab is not None else light_table(scene)
        n_lights = light_tab.rows.shape[0]
        n_dens = scene.num_triangles + scene.num_spheres
        rows, dens = light_tab
        if (rows.shape != (n_lights, 16) or dens.shape != (n_dens,)
                or any(t.device != dev or t.dtype != torch.float32
                       or not t.is_contiguous() for t in light_tab)
                or rows.data_ptr() % 16):
            raise ValueError("the light table must be contiguous float32 "
                             f"[L, 16] (16-byte aligned) and [{n_dens}] on "
                             f"{dev}")
    else:
        light_tab = None
    return _Variant(bvh, nodes, env_nee, env_tab if env_nee else None,
                    env_hw, light_tab)


def _launch(scene, origin, direction, far, sample_idx, seed,
            settings: RenderSettings, tables, env_tab=None, *,
            view: PixelView | None = None, lane0: int = 0,
            spp_block: int = 1, write_rays: bool = False,
            refill: bool = True, light_tab: LightRows | None = None,
            record: Record | None = None,
            probe: tuple[torch.Tensor, int] | None = None):
    """Launch the kernel variant the scene and settings select, on the
    current stream; returns [N, 10], or [N, 12] with env NEE. With
    area-light NEE `light_tab` may carry `light_table(scene)`. With
    `record` (`empty_record`; either tier; with light NEE its `lq` too)
    the launch also writes the adjoint's transcript into it. `probe` (a
    measurement,
    `light_probe`): (counters, mode) for B1e's probe variant on either
    tier.

    With `view` the kernel makes its own rays, those of
    `group_rays(view.camera, settings, view.frame, view.pix, lane0,
    spp_block)` (origin, direction, far, sample_idx and seed are not
    read), and with `write_rays` it also writes them out: the result is
    then (out, origin, direction, sample_idx, seed), the integers as int32
    bit patterns.

    The kernel's warps are persistent and take new rays for their lanes as
    these fall free; `refill=False` runs ray i on thread i of the grid
    instead, which gives the same bits (kept for the comparison). The BVH
    tier's glass variants always run so: their walk measured faster on the
    coherent rays of neighbouring threads than in full warps."""
    global LAUNCHES, RECORD_LAUNCHES
    rays = (None,) * 4
    if view is None:
        sidx, sd, far_t, tables, scalars = kernel_inputs(
            scene, origin, direction, far, sample_idx, seed, settings, tables)
        dev = origin.device
        rays = (origin, direction, sidx, sd)
        cam_ptrs, cam_ints = (None, None, None), (0, 0, 0, 0, 0)
    else:
        dev = view.pix.device
        if view.block is None or dev.type != "cuda":
            raise ValueError("a launch from pixels needs a PixelView on a "
                             "CUDA device")
        n = view.pix.shape[0] * spp_block
        tables, ints = _scene_inputs(scene, settings, tables, dev)
        scalars = (n, *ints)
        far_t = _far_word(view.camera.far, dev)
        if write_rays:
            i32 = dict(dtype=torch.int32, device=dev)
            rays = (torch.empty((n, 3), dtype=torch.float32, device=dev),
                    torch.empty((n, 3), dtype=torch.float32, device=dev),
                    torch.empty((n,), **i32), torch.empty((n,), **i32))
        cam_ptrs = (view.block.data_ptr(), view.pix.data_ptr(),
                    view.frame_word.data_ptr())
        cam_ints = (settings.width, settings.height, spp_block, lane0,
                    settings.samples_per_pixel)
    v = _variant(scene, settings, tables, env_tab, light_tab, dev)
    light = v.light_tab is not None
    if record is not None:
        check_record(record, scalars[0], settings, v.env_nee, dev, light)
    if probe is not None:
        counts, mode = probe
        if (not light or v.env_nee or record is not None
                or counts.shape != (scalars[0], PROBE_WORDS)
                or counts.dtype != torch.int32 or counts.device != dev
                or not counts.is_contiguous()
                or mode not in PROBE_MODES.values()):
            raise ValueError("the light-NEE probe runs B1e without env "
                             f"NEE, counters int32 [{scalars[0]}, "
                             f"{PROBE_WORDS}], a mode of PROBE_MODES")
    out = torch.empty(
        (scalars[0], N_OUTPUTS_NEE if v.env_nee else N_OUTPUTS),
        dtype=torch.float32, device=dev)
    # the next ray to hand out, zeroed on the stream before the launch
    counter = (torch.zeros(1, dtype=torch.int32, device=dev)
               if refill and _refills(scene) else None)
    o, d, si, sd_ = rays
    lib = load_library("megakernel")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.halogen_megakernel_launch(
            _ptr(o), _ptr(d), far_t.data_ptr(), _ptr(si), _ptr(sd_),
            *(t.data_ptr() for t in tables), _ptr(v.nodes),
            _ptr(v.env_tab), out.data_ptr(), *cam_ptrs, _ptr(counter),
            *v.light_ptrs(), *_record_ptrs(record),
            probe[0].data_ptr() if probe is not None else None,
            *scalars, *v.ints(), *cam_ints, *v.light_ints(),
            probe[1] if probe is not None else 0, stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    if record is not None:
        RECORD_LAUNCHES += 1
    return (out, *rays) if view is not None and write_rays else out


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _record_ptrs(record: Record | None) -> tuple:
    """The C entry points' seven record pointers (`Record`'s fields in the
    order a, word, nq, ngw, texel, end, lq), None where absent."""
    if record is None:
        return (None,) * 7
    return tuple(_ptr(t) for t in (record.a, record.word, record.nq,
                                   record.ngw, record.texel, record.end,
                                   record.lq))


def _refills(scene: SceneData) -> bool:
    """Whether launches on `scene` run persistent warps that refill from a
    ray counter: all but the BVH tier's glass variants."""
    return not (uses_bvh(scene) and scene.any_transmissive)


def trace_color_fused_reference(scene: SceneData, origin, direction, far,
                                sample_idx, seed,
                                settings: RenderSettings) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same [N, 10] (or, with env
    NEE, [N, 12]) outputs from the lockstep integrator, its closest hits
    by brute force whatever the scene's size (independent of the BVH that
    the kernel's BVH tier walks). Like the kernel it refuses a debug
    view."""
    from halogen_tpu_torch.config import Intersector
    from halogen_tpu_torch.integrator.trace import trace_rays

    if settings.debug_mode != DebugMode.NONE:
        raise NotImplementedError(_NOT_COVERED)
    n = origin.shape[0]
    far_b = torch.as_tensor(far, dtype=torch.float32,
                            device=origin.device).reshape(-1)[0].expand(n)
    return trace_rays(scene, origin, direction, far_b, sample_idx, seed,
                      settings.replace(intersector=Intersector.BRUTE)
                      ).outputs


def trace_fused_outputs(scene: SceneData, origin, direction, far, sample_idx,
                        seed, settings: RenderSettings, tables=None,
                        env_tab=None, light_tab=None,
                        record: Record | None = None) -> torch.Tensor:
    """[N, 10] per-ray outputs: color rgb gathered along the path (the sky
    excluded), miss attenuation rgb, accumulated roughness, final
    direction xyz; with env NEE [N, 12], adding the continuation pdf and
    NEE flag at the miss. The kernel on a CUDA device (with `record`, also
    the adjoint's transcript), its plain version on the CPU."""
    if origin.device.type == "cuda":
        return _launch(scene, origin, direction, far, sample_idx, seed,
                       settings, tables, env_tab, light_tab=light_tab,
                       record=record)
    if origin.device.type != "cpu":
        raise ValueError(f"no megakernel for device {origin.device}")
    return trace_color_fused_reference(scene, origin, direction, far,
                                       sample_idx, seed, settings)


def trace_color_fused(scene: SceneData, origin, direction, far, sample_idx,
                      seed, settings: RenderSettings, tables=None,
                      env_tab=None, light_tab=None) -> torch.Tensor:
    """Fused megakernel forward: [N, 3] radiance, the kernel's path color
    plus the sky at the miss (JAX `megakernel.py:1868-1900`; the sky kernel
    on a CUDA device, `deferred_sky` on the CPU). `tables`, `env_tab` and
    `light_tab` may carry `_scene_tables(scene)`, `env_table(scene)` and
    `light_table(scene)` computed once for many calls."""
    from halogen_tpu_torch.kernels import sky

    return sky.sky_color(scene, settings, trace_fused_outputs(
        scene, origin, direction, far, sample_idx, seed, settings, tables,
        env_tab, light_tab))


def trace_pixels_outputs(scene: SceneData, view: PixelView, lane0: int,
                         spp_block: int, settings: RenderSettings,
                         tables=None, env_tab=None,
                         write_rays: bool = False, light_tab=None,
                         record: Record | None = None):
    """`trace_fused_outputs` on the rays of one group of pixels,
    `group_rays(view.camera, settings, view.frame, view.pix, lane0,
    spp_block)`: on a CUDA device the kernel makes them itself (one launch,
    no ray tensors); on the CPU they are made by `group_rays` and traced by
    the plain version. With `write_rays` the result is (outputs, origin,
    direction, sample_idx, seed); with `record` (CUDA only) the launch also
    writes the adjoint's transcript."""
    dev = view.pix.device
    if dev.type == "cuda":
        return _launch(scene, None, None, None, None, None, settings, tables,
                       env_tab, view=view, lane0=lane0, spp_block=spp_block,
                       write_rays=write_rays, light_tab=light_tab,
                       record=record)
    if dev.type != "cpu":
        raise ValueError(f"no megakernel for device {dev}")
    rays = group_rays(view.camera, settings, view.frame, view.pix, lane0,
                      spp_block)
    out = trace_color_fused_reference(scene, rays[0], rays[1],
                                      view.camera.far, rays[2], rays[3],
                                      settings)
    return (out, *rays) if write_rays else out


class _FusedDiff(torch.autograd.Function):
    """Megakernel forward, adjoint-kernel backward: the port of the JAX
    package's custom_vjp (`megakernel.py:1904-1978`), on every scene the
    kernel renders (the JAX package takes its Pallas adjoint where
    `adjoint_supported` holds and the lockstep vjp elsewhere). The result
    is the kernel's per-ray outputs, [N, 10] or [N, 12]; the sky pass
    (`kernels/sky.py`) makes the color from them, and its backward hands
    this one the cotangents of the color, the miss attenuation and the
    accumulated roughness. Only the material table and, with env NEE, the
    finest mip (the radiance of the drawn texels) get cotangents; geometry,
    camera rays and far get none (use `Fused.OFF` to differentiate
    geometry).

    `group` is None for explicit rays, or (view, lane0, spp_block,
    want_rays) for a launch from pixels: the kernel then makes the rays
    and, where a backward may follow (`want_rays`), writes them out for
    the adjoint's replay (on both tiers). `aux` is (env_tab, light_tab,
    route): the tables, either None, and the adjoint's route
    (`grad_route`). On 'recorded' the launch records the adjoint's
    transcript and the backward is the sweep alone; no rays are written.
    On 'rerecord' (area-light NEE past the record budget) a launch from
    pixels records and writes nothing: the group itself is kept, and its
    backward records the launch again, then sweeps
    (`adjoint.trace_grad_pixels`); explicit rays are kept as for the
    replay, whose light-NEE backward is the recording forward and the
    sweep."""

    @staticmethod
    def forward(ctx, *args):
        with annotate("halogen.wrap.forward"):
            return _FusedDiff._forward(ctx, *args)

    @staticmethod
    def backward(ctx, grad_out):
        with annotate("halogen.wrap.backward"):
            return _FusedDiff._backward(ctx, grad_out)

    @staticmethod
    def _forward(ctx, scene, settings, aux, group, tri_tab, trin_tab,
                 sph_tab, mat_tab, origin, direction, far, sample_idx, seed,
                 *env_mips):
        tables = (tri_tab, trin_tab, sph_tab, mat_tab)
        env_tab, light_tab, route = aux
        ctx.scene, ctx.settings, ctx.env_tab = scene, settings, env_tab
        ctx.light_tab = light_tab
        ctx.n_env = len(env_mips)
        ctx.group = None
        rec = None
        if route == "recorded":
            n = (origin.shape[0] if group is None
                 else group[0].pix.shape[0] * group[2])
            dev = mat_tab.device
            if dev.type != "cuda":
                raise ValueError("the record route records on a CUDA "
                                 "device; the plain versions record none")
            rec = empty_record(n, settings, _use_nee(scene, settings), dev,
                               _use_light_nee(scene, settings))
        if group is None:
            out = trace_fused_outputs(scene, origin, direction, far,
                                      sample_idx, seed, settings, tables,
                                      env_tab, light_tab, record=rec)
        else:
            view, lane0, spp_block, want_rays = group
            rerecord = want_rays and route == "rerecord"
            want_rays = want_rays and rec is None and not rerecord
            out = trace_pixels_outputs(scene, view, lane0, spp_block,
                                       settings, tables, env_tab,
                                       write_rays=want_rays,
                                       light_tab=light_tab, record=rec)
            if want_rays:
                out, origin, direction, sample_idx, seed = out
                far = view.camera.far
            if rerecord:
                ctx.group = (view, lane0, spp_block)
        # the transcript, the group, or the rays of this launch for the
        # replay; not a graph of its bounces
        ctx.record_fields = None
        if rec is not None:
            ctx.record_fields = tuple(t is not None for t in rec)
            ctx.save_for_backward(*tables, *(t for t in rec if t is not None))
        elif ctx.group is not None:
            ctx.save_for_backward(*tables)
        elif origin is not None:
            ctx.save_for_backward(*tables, origin, direction, far,
                                  sample_idx, seed)
        return out

    @staticmethod
    def _backward(ctx, grad_out):
        from halogen_tpu_torch.kernels import adjoint as adj

        tables, saved = ctx.saved_tensors[:4], ctx.saved_tensors[4:]
        rec, rays = None, saved
        if ctx.record_fields is not None:
            it = iter(saved)
            rec = Record(*(next(it) if f else None
                           for f in ctx.record_fields))
            rays = (None,) * 5
        mat_tab = tables[3]
        want_env = ctx.n_env > 0 and ctx.needs_input_grad[13]
        d_mat = d_env0 = None
        if ctx.needs_input_grad[7] or want_env:  # mat_tab, env_mips[0]
            # grad_out may be an expanded view (stride 0) of the per-pixel
            # cotangent: the kernel reads dense columns
            kw = dict(tables=tuple(tables), env_tab=ctx.env_tab,
                      want_env=want_env)
            if ctx.group is not None:
                dmat, d_env0 = adj.trace_grad_pixels(
                    ctx.scene, *ctx.group, grad_out.contiguous(),
                    ctx.settings, light_tab=ctx.light_tab, **kw)
            else:
                dmat, d_env0 = adj.trace_grad_outputs(
                    ctx.scene, *rays, grad_out.contiguous(), ctx.settings,
                    record=rec, **kw)
            d_mat = _table_cotangent(dmat, mat_tab)
        d_env = [d_env0] + [None] * (ctx.n_env - 1) if ctx.n_env else []
        return (None, None, None, None, None, None, None, d_mat, None, None,
                None, None, None, *d_env)


def _table_cotangent(dmat: torch.Tensor,
                     mat_tab: torch.Tensor) -> torch.Tensor:
    """The adjoint's [K, 12|13] columns onto `_scene_tables`' [K, 17]
    material table; autograd chains col 9:12 through the rgb * intensity
    product."""
    d_mat = torch.zeros_like(mat_tab)
    d_mat[:, 9:12] = dmat[:, 0:3]   # emission, premultiplied
    d_mat[:, 0:3] = dmat[:, 3:6]    # albedo rgb
    d_mat[:, 4:7] = dmat[:, 6:9]    # specular
    d_mat[:, 13:16] = dmat[:, 9:12]  # absorption
    if dmat.shape[1] > 12:
        d_mat[:, 8] = dmat[:, 12]   # roughness (the sky's level)
    return d_mat


def chunk_serves(route: str | None, want_grad: bool, sky: bool) -> bool:
    """Whether a chunk of pixels on the kernel route renders all its
    launch groups through one `_FusedChunk` call (True) or through one
    `_FusedDiff` a group (False), by the adjoint's route (`grad_route`),
    whether a gradient is wanted and whether a sky pass shades the
    outputs: every chunk that wants no gradient, and a gradient's chunk on
    the 'recorded' route without a sky. The replay routes and 'rerecord'
    bound memory past the record budget a group at a time, and the sky
    pass keeps each group's outputs for its backward: those keep a node a
    group."""
    return not want_grad or (route == "recorded" and not sky)


class _FusedChunk(torch.autograd.Function):
    """One node for all the launch groups of a chunk of pixels: what a
    `_FusedDiff` a group and the sums of `integrator.trace.render_pixels`
    give, [n, 3], each pixel's colour summed over the chunk's lanes and
    divided by spp, from one call into the kernel library
    (`halogen_megakernel_chunk`: each group's launch, then the lane sum,
    `lane_sum`, which adds its colours into the chunk's accumulator in the
    order of the plain sums). Where the sky pass shades the outputs (no
    gradient then: `chunk_serves`), the sky forward runs on each group's
    outputs between its launch and its lane sum.

    On the 'recorded' route the groups record into one `Record` with a
    leading group axis, and the backward is one call too
    (`adjoint.sweep_chunk`): the colour's cotangent is the same for every
    group, each group's sweep reads its record, and the groups' [K, 12]
    are summed last first, the order in which autograd adds those of one
    node a group. Scene, tables and view are checked once a chunk; one
    output buffer and, in the backward, one block-sums buffer serve all
    the groups in turn.

    `chunk` is (view, spp_offset, spp_block, groups, spp): group g renders
    lanes spp_offset + g * spp_block .. + spp_block of each pixel of
    `view`, and spp divides the sum. `aux` is (env_tab, light_tab, route),
    route 'recorded' where a gradient follows, else None."""

    @staticmethod
    def forward(ctx, *args):
        with annotate("halogen.wrap.forward"):
            return _FusedChunk._forward(ctx, *args)

    @staticmethod
    def backward(ctx, grad):
        with annotate("halogen.wrap.backward"):
            return _FusedChunk._backward(ctx, grad)

    @staticmethod
    def _forward(ctx, scene, settings, aux, chunk, *tables):
        global LAUNCHES, RECORD_LAUNCHES, CHUNK_NODES, CHUNK_GROUPS
        global LANE_SUM_LAUNCHES
        from halogen_tpu_torch.kernels import sky

        env_tab, light_tab, route = aux
        view, spp_offset, spp_block, groups, spp = chunk
        dev = view.pix.device
        if view.block is None or dev.type != "cuda":
            raise ValueError("the chunk node launches from pixels on a CUDA "
                             "device")
        with_sky = sky.uses_sky(scene, settings)
        if not chunk_serves(route, route is not None, with_sky):
            raise ValueError("the chunk node takes the 'recorded' route "
                             "without a sky, or no gradient "
                             f"(`chunk_serves`), not {route!r}")
        tables, ints = _scene_inputs(scene, settings, tables, dev)
        v = _variant(scene, settings, tables, env_tab, light_tab, dev)
        n_pix = view.pix.shape[0]
        n = n_pix * spp_block
        f32 = dict(dtype=torch.float32, device=dev)
        out = torch.empty((n, N_OUTPUTS_NEE if v.env_nee else N_OUTPUTS),
                          **f32)
        acc = torch.zeros((n_pix, 3), **f32)
        # each group's next ray to hand out, zeroed once
        counter = (torch.zeros((groups,), dtype=torch.int32, device=dev)
                   if _refills(scene) else None)
        rec = (empty_record(n, settings, v.env_nee, dev,
                            v.light_tab is not None, groups)
               if route else None)
        far_t = _far_word(view.camera.far, dev)
        lib = load_library("megakernel")
        stream = torch.cuda.current_stream(dev).cuda_stream

        def launch(g0: int, count: int, acc_ptr) -> None:
            err = lib.halogen_megakernel_chunk(
                far_t.data_ptr(), *(t.data_ptr() for t in tables),
                _ptr(v.nodes), _ptr(v.env_tab), out.data_ptr(),
                view.block.data_ptr(), view.pix.data_ptr(),
                view.frame_word.data_ptr(),
                None if counter is None else counter[g0:].data_ptr(),
                *v.light_ptrs(), *_record_ptrs(rec), acc_ptr, n, *ints,
                *v.ints(), settings.width, settings.height, spp_block,
                spp_offset + g0 * spp_block, settings.samples_per_pixel,
                *v.light_ints(), count, stream)
            if err != 0:
                raise RuntimeError(f"megakernel chunk launch failed: CUDA "
                                   f"error {err}")

        with torch.cuda.device(dev):
            if not with_sky:
                launch(0, groups, acc.data_ptr())
            else:
                sky_args = sky._kernel_args(scene, settings, out,
                                            scene.env_mips)
                for g in range(groups):
                    launch(g, 1, None)
                    color = sky.sky_forward(scene, settings, out, None,
                                            sky_args)
                    err = lib.halogen_lane_sum(color.data_ptr(),
                                               acc.data_ptr(), 3, n_pix,
                                               spp_block, stream)
                    if err != 0:
                        raise RuntimeError(f"lane sum launch failed: CUDA "
                                           f"error {err}")
        LAUNCHES += groups
        LANE_SUM_LAUNCHES += groups
        CHUNK_NODES += 1
        CHUNK_GROUPS += groups
        ctx.record_fields = None
        if rec is not None:
            RECORD_LAUNCHES += groups
            ctx.scene, ctx.settings = scene, settings
            ctx.chunk = (spp_block, groups, spp)
            ctx.record_fields = tuple(t is not None for t in rec)
            ctx.save_for_backward(tables[3],
                                  *(t for t in rec if t is not None))
        return acc / spp

    @staticmethod
    def _backward(ctx, grad):
        from halogen_tpu_torch.kernels import adjoint as adj

        if not ctx.needs_input_grad[7]:  # mat_tab
            return (None,) * 8
        mat_tab, *saved = ctx.saved_tensors
        it = iter(saved)
        rec = Record(*(next(it) if f else None for f in ctx.record_fields))
        spp_block, groups, spp = ctx.chunk
        # the cotangent of every lane's colour: that of the mean over spp
        # (as the plain division's backward gives it), the same for every
        # group, lanes pixel-major
        g = grad / spp
        ct = g[:, None, :].expand(g.shape[0], spp_block, 3).reshape(-1, 3)
        dmat = adj.sweep_chunk(ctx.scene, rec, ct, ctx.settings, mat_tab,
                               groups)
        return (None,) * 7 + (_table_cotangent(dmat, mat_tab),)


def _nee_mips(scene: SceneData, settings: RenderSettings) -> tuple:
    """The mips whose texels the forward kernel reads (the finest, through
    the env-NEE draw table), as inputs of `_FusedDiff`."""
    return scene.env_mips[:1] if _use_nee(scene, settings) else ()


def grad_route(scene: SceneData, settings: RenderSettings, tables, dev,
               n_rays: int, launches: int) -> str:
    """The plan of a step of `launches` differentiable launches of
    `n_rays` rays each, made once before the first: where a gradient may
    follow on a CUDA device, the adjoint's route (`adjoint.record_plan`):
    'recorded' (the launches record the transcript), 'rerecord' (area-light
    NEE past the budget: each group's backward records its launch again)
    or the replay's; else 'rays' (the plain versions or no backward)."""
    from halogen_tpu_torch.kernels import adjoint as adj

    tables = tables if tables is not None else _scene_tables(scene)
    if (torch.device(dev).type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (*tables,
                                              *_nee_mips(scene, settings)))):
        return adj.record_plan(scene, settings, n_rays, launches)
    return "rays"


def trace_color_fused_diff(scene: SceneData, origin, direction, far,
                           sample_idx, seed, settings: RenderSettings,
                           tables=None, env_tab=None, light_tab=None,
                           record: bool | None = None) -> torch.Tensor:
    """Differentiable fused tracer (port of the JAX
    `trace_color_fused_diff`, `megakernel.py:1981-1993`): [N, 3] radiance
    from the kernel and the sky pass, whose backwards are the adjoint
    kernel (`kernels/adjoint.py`) and the sky backward kernel
    (`kernels/sky.py`), or their plain versions on the CPU. Gradients
    reach the scene's material table through `_scene_tables(scene)` and
    its envmap's mips. `record`: the step's route (`grad_route`), or
    None to plan this launch alone."""
    from halogen_tpu_torch.kernels import sky

    dev = origin.device
    tables = tables if tables is not None else _scene_tables(scene)
    far = torch.as_tensor(far, dtype=torch.float32, device=dev)
    sample_idx = torch.as_tensor(sample_idx, device=dev)
    seed = torch.as_tensor(seed, device=dev)
    mips = _nee_mips(scene, settings)
    if record is None:
        record = grad_route(scene, settings, tables, dev, origin.shape[0], 1)
    out = _FusedDiff.apply(scene, settings, (env_tab, light_tab, record),
                           None, *tables, origin, direction, far, sample_idx,
                           seed, *mips)
    return sky.sky_color(scene, settings, out)


def trace_color_chunk(scene: SceneData, view: PixelView, spp_offset: int,
                      spp_block: int, groups: int, spp: int,
                      settings: RenderSettings, tables, env_tab, light_tab,
                      route: str | None) -> torch.Tensor:
    """[n, 3] radiance of the pixels of `view` (CUDA only): each pixel's
    colour summed over lanes spp_offset .. spp_offset + groups * spp_block
    and divided by spp, from `groups` launches of `spp_block` lanes a
    pixel, through one `_FusedChunk` (the sky pass included), as `groups`
    calls of `trace_color_pixels_diff` and their sums give it. `route` is
    the caller's resolved one: None where no gradient is wanted, else
    'recorded' on a scene without a sky pass (`chunk_serves`), whose
    launches record the adjoint's transcript for the backward's sweep."""
    return _FusedChunk.apply(scene, settings, (env_tab, light_tab, route),
                             (view, spp_offset, spp_block, groups, spp),
                             *tables)


def trace_color_pixels_diff(scene: SceneData, view: PixelView, lane0: int,
                            spp_block: int, settings: RenderSettings,
                            tables=None, env_tab=None, light_tab=None,
                            record: bool | None = None) -> torch.Tensor:
    """`trace_color_fused_diff` on the rays of one group of pixels (see
    `trace_pixels_outputs`): [N, 3] radiance from one kernel launch that
    makes its own rays, and the sky pass. Only where a gradient is wanted,
    by `record`, the step's route (`grad_route`; None: plan this launch
    alone), the launch records the adjoint's transcript ('recorded'),
    keeps only the group for a backward that records it again
    ('rerecord'), or else writes its rays out for the adjoint's replay. On
    the CPU 'rerecord' runs through the plain versions too; 'recorded'
    records on a CUDA device only."""
    from halogen_tpu_torch.kernels import sky

    tables = tables if tables is not None else _scene_tables(scene)
    mips = _nee_mips(scene, settings)
    want_rays = torch.is_grad_enabled() and any(
        t.requires_grad for t in (*tables, *mips))
    if not want_rays:
        record = None
    elif record is None:
        record = grad_route(scene, settings, tables, view.pix.device,
                            view.pix.shape[0] * spp_block, 1)
    out = _FusedDiff.apply(scene, settings, (env_tab, light_tab, record),
                           (view, lane0, spp_block, want_rays), *tables,
                           None, None, None, None, None, *mips)
    return sky.sky_color(scene, settings, out)
