"""Fused path-replay adjoint: per-material cotangents of the traced color
in one CUDA launch (port of `halogen_tpu/kernels/adjoint.py`: its opaque
branch, B2, and its nested-dielectric branch, B2b; and of the JAX
package's lockstep vjp where the Pallas kernel stops: big scenes, B2+d and
B2b+d, and envmap scenes with and without env NEE).

The kernels are hand-written CUDA C++ for Hopper (`csrc/adjoint.cu`),
built with the megakernel's library step (`megakernel.load_library`).
Each sweeps every path's shaded bounces in reverse from a transcript (per
bounce the attenuation before it, the hit distance, the materials and
masks) and sums the cotangents per material in a fixed order, so two
calls give the same bits. In glass scenes d absorption goes to the
material of the medium the ray travelled through. Three routes give the
sweep its transcript, and all three give the same bits:
  - 'shared': the kernel replays every path through the forward kernel's
    own bounce code (`csrc/path_common.cuh`; on the BVH tier, scenes over
    MAX_TRIS triangles, walking the world BVH as B1d does) and keeps the
    transcript in the block's shared memory, where the block's tables fit
    `SMEM_BUDGET` (at most 17 bounces in the Cornell and glass boxes);
  - 'global': the same replay with the transcript in a device buffer of
    the same layout, past that budget;
  - 'recorded': no replay. The forward launch recorded the transcript as
    it traced (`megakernel.Record`), and `adjoint_sweep` reads it. Both
    tiers take it where a step's records fit `RECORD_BUDGET`
    (`record_plan`, decided from sizes before any launch); steps past the
    budget, and callers that bring rays without a record, replay
    (`transcript_route`). The sweep puts ray i on thread i % 128, as the
    replay does on both tiers, so the two give the same bits.
With area-light NEE (B2+l) no replay kernel exists; the sweep is the
only backward: the forward's recording variant also records each hit's
emission weight and the light term's factors and material, and the sweep
adds the light's d emission under a third key (its material), beside d
albedo and d specular of the shaded one. Where the step's records pass
`RECORD_BUDGET` the route is 'rerecord' (`record_plan`): the forward
records nothing, and each group's backward runs the recording forward
again on the same rays (a launch from pixels makes them again;
`trace_grad_pixels`), sweeps its record and drops it, so a step keeps one
launch's record where the record route keeps all of them, and gets the
record route's bits. Only a launch whose own record passes the budget
raises, before any launch. A caller on a CUDA device that brings rays
without a record gets the recording forward on them, then the sweep. To
force a route on the card set `RECORD_BUDGET`: None (a quarter of the
card) or a large number records, a budget below the step's records but
above one launch's rerecords, 0 replays (or, under light NEE, raises).

With an envmap in use the kernel takes the cotangents of the path's
outputs (`trace_grad_outputs`): of its color, of its miss attenuation and
of its accumulated roughness, which the sky pass's backward kernel
(`kernels/sky.py`) gives; roughness then has a cotangent too (the 13th
column: the mip-bias level of the lookup grows with it). With env NEE
the replay also writes one record per (ray, bounce): the drawn texel and
its cotangent, which the sky's per-texel sum adds into the finest mip.
`trace_grad_fused` runs them on a CUDA device as a render's backward does,
by autograd through `megakernel.trace_color_fused_diff`.

The plain PyTorch versions, `trace_grad_outputs_reference` and
`trace_grad_fused_reference`, are autograd through the lockstep integrator
with `Intersector.AUTO` pinned to BRUTE, as the JAX lockstep backward
pins it (`megakernel.py:1962-1968`). The record route's two halves have
theirs: `record_transcript_reference` (the lockstep's transcript in the
kernel's layout) and `sweep_reference` (the sweep in torch, vectorised
over rays). Rays on a CUDA device go to the kernels and rays on the CPU
to the plain versions; a CUDA launch that fails raises, there is no
fallback. `LAUNCHES` counts the replay kernel's launches, `SWEEP_LAUNCHES`
the sweep's. `sweep_chunk` is the backward of the chunk node
(`megakernel._FusedChunk`): every group's sweep of a chunk in one call,
and one `sum_groups` launch (`GROUP_SUM_LAUNCHES`) to add them up.
`material_cotangents` maps the [K, 12|13] result onto a `MaterialTable`.

The gradient is the detached-sampling estimator of the lockstep tracer:
emission, albedo and specular attenuation, Beer-Lambert absorption,
Russian roulette's 1/max(attenuation), the env-NEE term and the sky's
mip-bias level; metallic and IOR act only through sampling decisions
and get zero; with area-light NEE the emission's balance weight and the
light term (whose light emission, pdfs and weights are detached). Scope
(`adjoint_covers`): every scene the megakernel renders
(`megakernel.fused_supported`).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from halogen_tpu_torch.config import Intersector, RenderSettings
from halogen_tpu_torch.core.types import MaterialTable, SceneData
from halogen_tpu_torch.integrator.trace import (
    _use_light_nee,
    _use_nee,
    group_rays,
)
from halogen_tpu_torch.kernels import megakernel as mk
from halogen_tpu_torch.kernels import sky

N_GRAD = 12  # d_e premultiplied rgb | d_albedo rgb | d_specular rgb | d_absorption rgb
N_GRAD_SKY = 13  # ... | d_roughness, with an envmap in use
N_RECORD = 5  # transcript words per bounce: A_prev rgb, t, mats and masks
N_RECORD_NEE = 10  # ... | NEE radiance * weight rgb, its BRDF factors
THREADS = 128  # csrc/path_common.cuh kThreads
WARPS = THREADS // 32
# Dynamic shared memory a block of the adjoint may take (scene tables, the
# warps' [K, 12] sums and the transcript) on the shared route: 48 KB, so
# the 4 blocks a multiprocessor holds at B2b's 128 registers fit its
# 227 KB, and no launch needs the opt-in above 48 KB (the global route's
# block, tables and sums only, stays under 28 KB at the kernels' caps).
SMEM_BUDGET = 48 * 1024

# Device memory the record route's transcripts of one step may take:
# bytes, or None for RECORD_SHARE of the card's memory. At 12 bounces a ray
# keeps 4 + 13 * 20 bytes (13 * 48 with env NEE): 69 MB a 262144-ray
# launch, 2.2 GB the glass dragon's 32-launch step, ~71 GB a 1024x1024
# step of 256 spp (which therefore replays). On the brute tier the Cornell
# 256x256, 256 spp step (6 bounces) keeps 2.4 GB, `envmap_1024`'s (4
# bounces, env NEE) 4.1 GB; a 1024x1024, 256 spp Cornell step ~38 GB
# replays, and with light NEE (68.7 GB) records each launch again in its
# backward ('rerecord').
RECORD_BUDGET = None
RECORD_SHARE = 0.25

LAUNCHES = 0  # replay-kernel launches since the count was last set to 0
SWEEP_LAUNCHES = 0  # sweep-kernel launches (the record route), likewise
GROUP_SUM_LAUNCHES = 0  # `sum_groups` launches, one a `sweep_chunk` call


def env_mode(scene: SceneData, settings: RenderSettings) -> int:
    """The adjoint's sky variant: 0 none, 1 the sky at the miss, 2 the sky
    and env NEE."""
    if not sky.uses_sky(scene, settings):
        return 0
    return 2 if _use_nee(scene, settings) else 1


def n_grad(scene: SceneData, settings: RenderSettings) -> int:
    """Columns of the result: 12, or 13 with the sky (d roughness)."""
    return N_GRAD_SKY if env_mode(scene, settings) else N_GRAD


def smem_bytes(scene: SceneData, settings: RenderSettings) -> int:
    """A block's dynamic shared memory on the shared route: the scene
    tables (`path_common.cuh::scene_smem_floats`; the BVH tier keeps its
    triangles in device memory), the warps' sums and the transcript of
    max_bounces + 1 bounces."""
    tris = 0 if mk.uses_bvh(scene) else scene.num_triangles
    floats = (tris * 22 + scene.num_spheres * 5
              + scene.materials.count * 17
              + WARPS * scene.materials.count * n_grad(scene, settings))
    rec = N_RECORD_NEE if env_mode(scene, settings) == 2 else N_RECORD
    words = (settings.max_bounces + 1) * rec * THREADS
    return 4 * (floats + words)


def transcript_route(scene: SceneData, settings: RenderSettings) -> str:
    """The replay's route: 'shared' where the block fits SMEM_BUDGET with
    its transcript, else 'global' (`record_plan` gives a step's route,
    which may be 'recorded')."""
    return ("shared" if smem_bytes(scene, settings) <= SMEM_BUDGET
            else "global")


def record_words(scene: SceneData, settings: RenderSettings) -> int:
    """32-bit words the forward records a shaded bounce: a_prev rgb, t and
    the packed word; with env NEE 7 more (its radiance * weight rgb,
    dterm, gterm, weight, texel); with area-light NEE 4 more (the light
    term's f, dterm, gterm and the emission's weight): 5, 12, 9 or 16."""
    return mk.record_words(env_mode(scene, settings) == 2,
                           _use_light_nee(scene, settings))


def record_bytes(scene: SceneData, settings: RenderSettings,
                 n_rays: int) -> int:
    """Bytes of one launch's `megakernel.Record`: max_bounces + 1 slots a
    ray and its end word."""
    slots = settings.max_bounces + 1
    return 4 * n_rays * (1 + slots * record_words(scene, settings))


def record_budget(device) -> int:
    """RECORD_BUDGET, or RECORD_SHARE of the memory of `device` (a CUDA
    device; 0 elsewhere: the plain versions run there)."""
    if RECORD_BUDGET is not None:
        return int(RECORD_BUDGET)
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    return int(RECORD_SHARE * _total_memory(device.index))


@functools.lru_cache(maxsize=None)
def _total_memory(index: int | None) -> int:
    return torch.cuda.get_device_properties(
        torch.cuda.current_device() if index is None else index).total_memory


def record_plan(scene: SceneData, settings: RenderSettings, n_rays: int,
                launches: int, budget: int | None = None) -> str:
    """The adjoint's route for a step of `launches` forward launches of
    `n_rays` rays each, from sizes alone, before any launch: 'recorded'
    on either tier where the step's records (`record_bytes` x launches,
    all alive until the backward) fit `budget` (default `record_budget`
    of the scene's device) beside the records of earlier forwards still
    alive there (`megakernel.live_record_bytes`: several frames before one
    backward); else the replay's route (`transcript_route`). Area-light
    NEE has no replay: past the budget its step takes 'rerecord' (each
    group's backward records its launch again, sweeps it and drops it),
    where one launch's record fits the budget beside those alive; where
    even that does not fit it raises NotImplementedError, naming that
    launch's bytes and the budget."""
    if adjoint_covers(scene, settings):
        budget = record_budget(scene.device) if budget is None else budget
        one = record_bytes(scene, settings, n_rays)
        live = mk.live_record_bytes(scene.device)
        if launches * one + live <= budget:
            return "recorded"
        if _use_light_nee(scene, settings):
            if one + live <= budget:
                return "rerecord"
            raise NotImplementedError(
                f"the area-light NEE adjoint (B2+l) records its transcript "
                f"and has no replay: one launch's record takes {one} bytes "
                f"({n_rays} rays; {live} bytes of earlier records alive), "
                f"past the record budget of {budget} bytes "
                f"(adjoint.RECORD_BUDGET); set a smaller ray_chunk_size")
    return transcript_route(scene, settings)


def adjoint_covers(scene: SceneData, settings: RenderSettings) -> bool:
    """Whether the port differentiates `scene` through the fused route:
    every scene its megakernel renders (`megakernel.fused_supported`),
    brute and BVH tier, glass, sky, env NEE and area-light NEE (B2+l,
    the record route only)."""
    return mk.fused_supported(scene, settings)


def _check_covered(scene: SceneData, settings: RenderSettings) -> None:
    if not adjoint_covers(scene, settings):
        raise NotImplementedError(
            "the fused adjoint covers the megakernel's scenes (within its "
            "caps, without a debug view)")


def _launch(scene, origin, direction, far, sample_idx, seed, ct,
            settings: RenderSettings, tables,
            replay_color: torch.Tensor | None = None,
            route: str | None = None, gsky: torch.Tensor | None = None,
            env_tab: torch.Tensor | None = None,
            records: tuple | None = None,
            record: "mk.Record | None" = None) -> torch.Tensor:
    """Launch the adjoint on the current stream; returns [K, 12], or
    [K, 13] with an envmap in use.

    With `record` (the transcript a forward launch on these rays recorded,
    `megakernel.Record`) the route is 'recorded': the sweep alone, which
    reads no rays (origin to seed may be None). With area-light NEE and
    no record (it has no replay) the recording forward runs on the rays
    first (`record_plan` of that one launch must fit the budget), then
    the sweep; `replay_color` then receives the forward's color.

    `ct` [N, 3] is the cotangent of the path color; with an envmap in use
    `gsky` [N, 4] those of the miss attenuation and of the accumulated
    roughness (zeros if None). `replay_color`, an [N, 3] float32 buffer,
    receives the color of the replayed paths (a check that the replay took
    the forward's path). With env NEE `records`, a pair of buffers
    (keys [N, B + 1] int32, weights [N, B + 1, 3] float32), receives each
    (ray, bounce)'s drawn texel (-1: none) and its cotangent. `route`
    ('shared' or 'global') overrides `transcript_route`; the shared route
    raises where the block would exceed SMEM_BUDGET."""
    global LAUNCHES
    if record is not None or route == "recorded":
        if record is None:
            raise ValueError("the recorded route needs the forward's record")
        return _sweep(scene, record, ct, settings, tables, gsky, records)
    if _use_light_nee(scene, settings):
        if route is not None:
            raise ValueError("area-light NEE has no replay kernel: its "
                             "adjoint records the transcript and sweeps it")
        record_plan(scene, settings, origin.shape[0], 1)  # raises past it
        record = mk.empty_record(origin.shape[0], settings,
                                 _use_nee(scene, settings), origin.device,
                                 True)
        out = mk._launch(scene, origin, direction, far, sample_idx, seed,
                         settings, tables, env_tab, record=record)
        if replay_color is not None:
            replay_color.copy_(out[:, 0:3])
        return _sweep(scene, record, ct, settings, tables, gsky, records)
    sidx, sd, far_t, tables, scalars = mk.kernel_inputs(
        scene, origin, direction, far, sample_idx, seed, settings, tables)
    _check_covered(scene, settings)
    route = route or transcript_route(scene, settings)
    if route not in ("shared", "global"):
        raise ValueError(f"unknown transcript route {route!r}")
    if route == "shared" and smem_bytes(scene, settings) > SMEM_BUDGET:
        raise ValueError("the transcript does not fit a block's shared "
                         "memory at this bounce count")
    n = origin.shape[0]
    dev = origin.device
    env = env_mode(scene, settings)
    f32 = dict(dtype=torch.float32, device=dev)
    if env and gsky is None:
        gsky = torch.zeros((n, 4), **f32)
    slots = settings.max_bounces + 1
    if env == 2 and records is None:
        records = (torch.empty((n, slots), dtype=torch.int32, device=dev),
                   torch.empty((n, slots, 3), **f32))
    buffers = {"ct": (ct, (n, 3), torch.float32),
               "replay_color": (replay_color, (n, 3), torch.float32),
               "gsky": (gsky if env else None, (n, 4), torch.float32)}
    if env == 2:
        buffers["record keys"] = (records[0], (n, slots), torch.int32)
        buffers["record weights"] = (records[1], (n, slots, 3),
                                     torch.float32)
    for name, (t, shape, dtype) in buffers.items():
        if t is not None and (t.shape != shape or t.dtype != dtype
                              or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous {dtype} "
                             f"{list(shape)} on {dev}")
    k = scene.materials.count
    cols = n_grad(scene, settings)
    if n == 0:
        return torch.zeros((k, cols), **f32)
    bvh = mk.uses_bvh(scene)
    nodes = scene.wbvh.nodes if bvh else None
    if bvh and (nodes.device != dev or nodes.dtype != torch.float32
                or not nodes.is_contiguous() or nodes.data_ptr() % 16
                or tables[0].shape != (scene.num_triangles, 12)
                or tables[0].data_ptr() % 16):
        raise ValueError("the world BVH's nodes and triangles must be "
                         "contiguous, 16-byte aligned float32 [Nn, 8] and "
                         f"[T, 12] tensors on {dev}")
    env_h = env_w = 0
    if env == 2:
        env_tab = env_tab if env_tab is not None else mk.env_table(scene)
        env_h, env_w = scene.env_cdf.pdf.shape
        if (env_tab.shape != (env_h * env_w, 16) or env_tab.device != dev
                or env_tab.dtype != torch.float32
                or not env_tab.is_contiguous() or env_tab.data_ptr() % 16):
            raise ValueError("the env draw table must be a contiguous, "
                             "16-byte aligned float32 "
                             f"[{env_h * env_w}, 16] on {dev}")
    blocks = -(-n // THREADS)
    # scratch: on the global route the transcript, [block, bounce, word,
    # thread] so a warp's stores coalesce; one partial table per block of
    # 128 paths
    transcript = None
    if route == "global":
        rec = N_RECORD_NEE if env == 2 else N_RECORD
        transcript = torch.empty((blocks, slots, rec, THREADS),
                                 dtype=torch.int32, device=dev)
    partial = torch.empty((blocks, k * cols), **f32)
    out = torch.empty((k, cols), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = mk.load_library("adjoint")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.halogen_adjoint_launch(
            origin.data_ptr(), direction.data_ptr(), far_t.data_ptr(),
            sidx.data_ptr(), sd.data_ptr(), ct.data_ptr(),
            *(t.data_ptr() for t in tables), ptr(transcript),
            partial.data_ptr(), out.data_ptr(), ptr(replay_color),
            ptr(nodes), ptr(gsky if env else None),
            ptr(env_tab if env == 2 else None),
            ptr(records[0] if env == 2 else None),
            ptr(records[1] if env == 2 else None),
            *scalars, int(bvh), env, env_h, env_w, stream)
    if err != 0:
        raise RuntimeError(f"adjoint launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def _sweep(scene, record, ct, settings: RenderSettings, tables, gsky,
           records) -> torch.Tensor:
    """The record route: `adjoint_sweep` over `record` on the current
    stream (see `_launch`)."""
    global SWEEP_LAUNCHES
    _check_covered(scene, settings)
    n, dev = record.n, record.end.device
    env = env_mode(scene, settings)
    light = _use_light_nee(scene, settings)
    mk.check_record(record, n, settings, env == 2, dev, light)
    tables = tables if tables is not None else mk._scene_tables(scene)
    mat_tab = tables[3]
    f32 = dict(dtype=torch.float32, device=dev)
    if env and gsky is None:
        gsky = torch.zeros((n, 4), **f32)
    slots = settings.max_bounces + 1
    if env == 2 and records is None:
        records = (torch.empty((n, slots), dtype=torch.int32, device=dev),
                   torch.empty((n, slots, 3), **f32))
    k = scene.materials.count
    cols = n_grad(scene, settings)
    buffers = {"ct": (ct, (n, 3), torch.float32),
               "gsky": (gsky if env else None, (n, 4), torch.float32),
               "material table": (mat_tab, (k, 17), torch.float32)}
    if env == 2:
        buffers["record keys"] = (records[0], (n, slots), torch.int32)
        buffers["record weights"] = (records[1], (n, slots, 3),
                                     torch.float32)
    for name, (t, shape, dtype) in buffers.items():
        if t is not None and (t.shape != shape or t.dtype != dtype
                              or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous {dtype} "
                             f"{list(shape)} on {dev}")
    if n == 0:
        return torch.zeros((k, cols), **f32)
    blocks = -(-n // THREADS)
    partial = torch.empty((blocks, k * cols), **f32)
    out = torch.empty((k, cols), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = mk.load_library("adjoint")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.halogen_adjoint_sweep(
            mat_tab.data_ptr(), ct.data_ptr(), ptr(gsky if env else None),
            *(ptr(t) for t in (record.a, record.word, record.nq, record.ngw,
                               record.texel, record.end, record.lq)),
            partial.data_ptr(), out.data_ptr(),
            ptr(records[0] if env == 2 else None),
            ptr(records[1] if env == 2 else None), n, k,
            settings.max_bounces, int(settings.russian_roulette),
            int(scene.any_transmissive), env, int(light), stream)
    if err != 0:
        raise RuntimeError(f"adjoint sweep launch failed: CUDA error {err}")
    SWEEP_LAUNCHES += 1
    return out


def sweep_chunk(scene, record, ct, settings: RenderSettings, mat_tab,
                groups: int) -> torch.Tensor:
    """The record route's backward of a chunk's `groups` launches
    (`megakernel._FusedChunk`), in one call: `adjoint_sweep` over each
    group's slice of `record` (`megakernel.empty_record(..., groups)`),
    all with the colour cotangent `ct` [N, 3], each group's block sums
    reduced into one [groups, K, 12] table (one block-sums buffer serving
    the groups in turn), then the groups summed last first (the order in
    which autograd adds the cotangents of one node a group): [K, 12]. No
    sky: a gradient through the sky pass takes a node a group."""
    global SWEEP_LAUNCHES, GROUP_SUM_LAUNCHES
    _check_covered(scene, settings)
    if env_mode(scene, settings):
        raise ValueError("the chunk's sweep takes no sky pass")
    n, dev = record.n, record.end.device
    light = _use_light_nee(scene, settings)
    mk.check_record(record, n, settings, False, dev, light, groups)
    k = scene.materials.count
    for name, t, shape in (("ct", ct, (n, 3)),
                           ("material table", mat_tab, (k, 17))):
        if (t.shape != shape or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{list(shape)} on {dev}")
    f32 = dict(dtype=torch.float32, device=dev)
    partial = torch.empty((-(-n // THREADS), k * N_GRAD), **f32)
    part = torch.empty((groups, k * N_GRAD), **f32)
    out = torch.empty((k, N_GRAD), **f32)
    lib = mk.load_library("adjoint")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.halogen_adjoint_sweep_chunk(
            mat_tab.data_ptr(), ct.data_ptr(), record.a.data_ptr(),
            record.word.data_ptr(), record.end.data_ptr(),
            None if record.lq is None else record.lq.data_ptr(),
            partial.data_ptr(), part.data_ptr(), out.data_ptr(), n, k,
            settings.max_bounces, int(settings.russian_roulette),
            int(scene.any_transmissive), int(light), groups, stream)
    if err != 0:
        raise RuntimeError(f"adjoint chunk sweep failed: CUDA error {err}")
    SWEEP_LAUNCHES += groups
    GROUP_SUM_LAUNCHES += 1
    return out


_SPEC, _ABSORBING, _SURVIVE, _TRUE_HIT, _REFR = (1 << b for b in
                                                  range(16, 21))
# with area-light NEE: the light term's material in bits 21-26, and
# whether the term was added (csrc/path_common.cuh `pack_light`)
_LIGHT_MAT_SHIFT, _LIT = 21, 1 << 27


def record_transcript_reference(scene: SceneData, origin, direction, far,
                                sample_idx, seed, settings: RenderSettings
                                ) -> "mk.Record":
    """Plain version of the forward's record: the lockstep `trace_rays`
    (closest hits by brute force) on the same rays, its transcript packed
    into the kernel's `megakernel.Record` layout (with area-light NEE the
    light term's words too). Slots at or past a ray's shaded count hold
    zeros (the kernel leaves them unwritten)."""
    from halogen_tpu_torch.integrator.trace import trace_rays

    n, dev = origin.shape[0], origin.device
    tape = []
    far_b = torch.as_tensor(far, dtype=torch.float32,
                            device=dev).reshape(-1)[0].expand(n)
    with torch.no_grad():
        trace_rays(scene, origin, direction, far_b, sample_idx, seed,
                   settings.replace(intersector=Intersector.BRUTE), tape)
    nee = env_mode(scene, settings) == 2
    light = _use_light_nee(scene, settings)
    rec = mk.empty_record(n, settings, nee, dev, light)
    n_shaded = torch.zeros((n,), dtype=torch.int64, device=dev)
    missed = torch.zeros((n,), dtype=torch.bool, device=dev)
    for k, e in enumerate(tape):
        sh = e["shaded"]
        n_shaded += sh.to(torch.int64)
        missed |= e["missed"]
        zero = lambda x: torch.where(sh.reshape(-1, *[1] * (x.dim() - 1)),
                                     x, torch.zeros_like(x))
        rec.a[k] = zero(torch.cat([e["a_prev"], e["t"][:, None]], dim=1))
        ab = e["absorbing"]
        word = (e["mat"].to(torch.int64)
                | torch.where(ab, e["ab_mat"].to(torch.int64) << 8, 0)
                | e["spec"].to(torch.int64) * _SPEC
                | ab.to(torch.int64) * _ABSORBING
                | e["survive"].to(torch.int64) * _SURVIVE
                | e["true_hit"].to(torch.int64) * _TRUE_HIT
                | e["refr"].to(torch.int64) * _REFR)
        if light:
            lit, lmat, f, dterm, gterm, em_w = e["light"]
            lit = sh & lit
            word = word | torch.where(
                lit, (lmat.to(torch.int64) << _LIGHT_MAT_SHIFT) | _LIT, 0)
            rec.lq[k] = zero(torch.stack(
                [torch.where(lit, x, 0.0) for x in (f, dterm, gterm)]
                + [em_w], dim=1))
        rec.word[k] = zero(word).to(torch.int32)
        if nee:
            texel, rad, wfac, dterm, gterm = e["nee"]
            lit = sh & (texel >= 0)
            z = torch.zeros_like(wfac)
            rec.nq[k] = torch.cat([torch.where(lit[:, None],
                                               rad * wfac[:, None], 0.0),
                                   torch.where(lit, dterm, z)[:, None]],
                                  dim=1)
            rec.ngw[k] = torch.stack([torch.where(lit, gterm, z),
                                      torch.where(lit, wfac, z)], dim=1)
            rec.texel[k] = torch.where(sh, texel, -1).to(torch.int32)
    rec.end.copy_(mk._as_i32(n_shaded | (missed.to(torch.int64) << 31)))
    return rec


def sweep_reference(scene: SceneData, settings: RenderSettings, record,
                    d_out: torch.Tensor):
    """Plain version of `adjoint_sweep`: the same reverse sweep over
    `record` (`megakernel.Record`), vectorised over rays, bounce by bounce
    from the last slot: Russian roulette's 1/max with its argmax ties
    split evenly and the 1e-20 gate, Beer-Lambert, with the sky its
    cotangents at the miss and the roughness column, with env NEE its
    term, with area-light NEE the emission's balance weight and the light
    term (d emission to the light's material, d albedo and d specular to
    the shaded one). `d_out` [N, >= 3]: the color's cotangent, with an
    envmap in use then those of the miss attenuation and the accumulated
    roughness (columns 3-6). The sums per material run in float64. Returns
    ([K, 12|13], with env NEE the records (keys [N, B + 1] int32, weights
    [N, B + 1, 3]; zeros where the key is -1), else None)."""
    env = env_mode(scene, settings)
    light = _use_light_nee(scene, settings)
    k_mat = scene.materials.count
    cols = n_grad(scene, settings)
    tab = mk._scene_tables(scene)[3].detach().to(record.a.device)
    n = record.n
    ct = d_out[:, 0:3].detach().to(torch.float32)
    end = record.end.to(torch.int64) & 0xFFFFFFFF
    n_shaded = end & 0xFFFF
    missed = (end >> 31) != 0
    zero3 = torch.zeros_like(ct)
    g_a = torch.where(missed[:, None], d_out[:, 3:6], zero3) if env else zero3
    g_rough = d_out[:, 6] if env else None
    acc = torch.zeros((k_mat, cols), dtype=torch.float64, device=ct.device)
    slots = settings.max_bounces + 1
    keys = weights = None
    if env == 2:
        keys = torch.full((n, slots), -1, dtype=torch.int32,
                          device=ct.device)
        weights = torch.zeros((n, slots, 3), device=ct.device)
    for k in reversed(range(slots)):
        live = n_shaded > k
        if not bool(live.any()):
            continue
        a_prev, t = record.a[k, :, 0:3], record.a[k, :, 3]
        word = record.word[k].to(torch.int64) & 0xFFFFFFFF
        mat = torch.where(live, word & 0xFF, 0)
        ab_mat = (word >> 8) & 0xFF
        spec = (word & _SPEC) != 0
        absorbing = live & ((word & _ABSORBING) != 0)
        survive = (word & _SURVIVE) != 0
        # a refraction or a false hit scatters with color 1
        surf = ((((word & _TRUE_HIT) != 0) & ((word & _REFR) == 0))
                if scene.any_transmissive else torch.ones_like(live))
        m = tab[mat]
        one = torch.ones_like(a_prev)
        base = torch.where(surf[:, None],
                           torch.where(spec[:, None], m[:, 4:7], m[:, 0:3]),
                           one)
        ab_row = tab[torch.where(absorbing, ab_mat, mat)]
        beer = torch.where(absorbing[:, None],
                           torch.exp(-ab_row[:, 13:16] * t[:, None]), one)
        scf = base * beer
        a_post = a_prev * scf
        gp = g_a
        if settings.russian_roulette:
            c = torch.amax(a_post, dim=1)
            inv_c = 1.0 / torch.clamp_min(c, 1e-20)
            tie = (a_post == c[:, None]).to(torch.float32)
            n_tie = torch.clamp_min(tie.sum(dim=1), 1.0)
            inv_tie = torch.where(n_tie == 1.0, 1.0,
                                  torch.where(n_tie == 2.0, 0.5, 1.0 / 3.0))
            gate = (c > 1e-20).to(torch.float32)
            dot_ga = ((g_a[:, 0] * a_post[:, 0] + g_a[:, 1] * a_post[:, 1])
                      + g_a[:, 2] * a_post[:, 2])
            split = (tie * inv_tie[:, None] * gate[:, None]
                     * dot_ga[:, None] * inv_c[:, None] * inv_c[:, None])
            gp = torch.where(survive[:, None],
                             g_a * inv_c[:, None] - split, g_a)
        g = torch.zeros((n, cols), device=ct.device)
        if env:
            gp = torch.cat([(gp[:, 0] + g_rough * m[:, 8])[:, None],
                            gp[:, 1:3]], dim=1)
            g[:, 12] = g_rough * a_post[:, 0]
        g_sc = gp * a_prev
        g_base = g_sc * beer
        g_beer = g_sc * base
        if light:  # the emission times its balance weight
            em_w = record.lq[k, :, 3:4]
            g_new = gp * scf + ct * m[:, 9:12] * em_w
            g[:, 0:3] = ct * a_prev * em_w
        else:
            g_new = gp * scf + ct * m[:, 9:12]
            g[:, 0:3] = ct * a_prev
        g[:, 3:6] = torch.where((surf & ~spec)[:, None], g_base, 0.0)
        g[:, 6:9] = torch.where((surf & spec)[:, None], g_base, 0.0)
        g[:, 9:12] = torch.where(absorbing[:, None], -t[:, None] * beer
                                 * g_beer, 0.0)
        if env == 2:
            q, dterm = record.nq[k, :, 0:3], record.nq[k, :, 3]
            gterm, wfac = record.ngw[k, :, 0], record.ngw[k, :, 1]
            cq = ct * q
            f = m[:, 0:3] * dterm[:, None] + m[:, 4:7] * gterm[:, None]
            g_new = g_new + cq * f
            ca = cq * a_prev
            g[:, 3:6] = g[:, 3:6] + ca * dterm[:, None]
            g[:, 6:9] = g[:, 6:9] + ca * gterm[:, None]
            texel = record.texel[k]
            lit = live & (texel >= 0)
            keys[:, k] = torch.where(live, texel, -1)
            weights[:, k] = torch.where(lit[:, None],
                                        ct * a_prev * f * wfac[:, None], 0.0)
        g_light = None
        if light:  # the light term, after env NEE's
            l_lit = live & ((word & _LIT) != 0)
            l_mat = torch.where(l_lit, (word >> _LIGHT_MAT_SHIFT) & 0x3F, 0)
            f_l, dterm, gterm = (record.lq[k, :, j:j + 1] for j in range(3))
            fr = m[:, 0:3] * dterm + m[:, 4:7] * gterm
            cf = ct * tab[l_mat, 9:12] * f_l
            g_new = g_new + cf * fr
            ca = cf * a_prev
            g[:, 3:6] = g[:, 3:6] + ca * dterm
            g[:, 6:9] = g[:, 6:9] + ca * gterm
            g_light = torch.where(l_lit[:, None], ct * a_prev * fr * f_l,
                                  0.0).to(torch.float64)
        g_a = torch.where(live[:, None], g_new, g_a)
        # absorption to the Beer material, the rest to the hit material;
        # the light's d emission to the light's material
        g = torch.where(live[:, None], g, 0.0).to(torch.float64)
        by_mat = torch.zeros_like(acc).index_add_(0, mat, g)
        by_mat[:, 9:12] = torch.zeros_like(acc[:, 9:12]).index_add_(
            0, torch.where(absorbing, ab_mat, 0), g[:, 9:12])
        if g_light is not None:
            by_mat[:, 0:3] += torch.zeros_like(acc[:, 0:3]).index_add_(
                0, l_mat, g_light)
        acc += by_mat
    return acc.to(torch.float32), (None if env != 2 else (keys, weights))


def _backward_settings(settings: RenderSettings) -> RenderSettings:
    """The plain backward's settings: AUTO pinned to the dense BRUTE
    intersector, as the JAX lockstep backward pins it (the same radiance;
    elementwise, so reverse mode is exact; and free of the per-mesh walk's
    local-space ulps)."""
    if settings.intersector == Intersector.AUTO:
        return settings.replace(intersector=Intersector.BRUTE)
    return settings


def _reference_grads(scene: SceneData, origin, direction, far, sample_idx,
                     seed, settings: RenderSettings, loss_of, env_leaves):
    """Autograd of `loss_of(TraceOut)` through the lockstep `trace_rays`,
    with respect to leaves for the premultiplied emission, albedo rgb,
    specular, absorption and, with the sky, roughness; and, where
    `env_leaves` (a tuple of mip indices), those mips. The emission enters
    as `cat([premult, ones])`, so the table's rgb * intensity product is a
    multiplication by 1.0, which is exact. Returns ([K, 12|13], the mips'
    cotangents or None)."""
    from halogen_tpu_torch.integrator.trace import trace_rays

    mats = scene.materials
    n = origin.shape[0]
    with_sky = bool(env_mode(scene, settings))
    with torch.enable_grad():
        em = mats.emissive.detach()
        leaves = [t.clone().requires_grad_(True) for t in (
            em[:, :3] * em[:, 3:4], mats.albedo[:, :3].detach(),
            mats.specular.detach(), mats.absorption.detach())]
        rough = mats.roughness.detach().clone().requires_grad_(with_sky)
        em_pre, albedo, specular, absorption = leaves
        table = MaterialTable(
            albedo=torch.cat([albedo, mats.albedo[:, 3:].detach()], dim=1),
            specular=specular,
            metallic=mats.metallic.detach(),
            roughness=rough,
            emissive=torch.cat([em_pre, torch.ones_like(em[:, 3:])], dim=1),
            ior=mats.ior.detach(),
            absorption=absorption,
            priority=mats.priority,
        )
        mips = [m.detach() for m in scene.env_mips]
        env = []
        for l in env_leaves or ():
            mips[l] = mips[l].clone().requires_grad_(True)
            env.append(mips[l])
        far_b = torch.as_tensor(far, dtype=torch.float32,
                                device=origin.device).reshape(-1)[0].expand(n)
        traced = trace_rays(
            dataclasses.replace(scene, materials=table,
                                env_mips=tuple(mips)),
            origin.detach(), direction.detach(), far_b, sample_idx, seed,
            _backward_settings(settings))
        wrt = leaves + ([rough] if with_sky else []) + env
        grads = torch.autograd.grad(loss_of(traced), wrt, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, wrt)]
    cols = grads[:len(wrt) - len(env)]
    if with_sky:
        cols[-1] = cols[-1][:, None]
    d_env = tuple(grads[len(wrt) - len(env):]) if env_leaves else None
    return torch.cat(cols, dim=1), d_env


def trace_grad_outputs_reference(scene: SceneData, origin, direction, far,
                                 sample_idx, seed, d_out,
                                 settings: RenderSettings,
                                 want_env: bool = False):
    """Plain version of `trace_grad_outputs`: autograd of the path's
    outputs (color, miss attenuation, accumulated roughness: columns 0-6)
    against `d_out` [N, >= 7]. Returns ([K, 12|13], with `want_env` and
    env NEE the finest mip's cotangent, else None)."""
    env_leaves = (0,) if want_env and env_mode(scene, settings) == 2 else ()
    dmat, d_env = _reference_grads(
        scene, origin, direction, far, sample_idx, seed, settings,
        lambda tr: (tr.outputs[:, :7] * d_out[:, :7]).sum(), env_leaves)
    return dmat, (d_env[0] if d_env else None)


def trace_grad_outputs(scene: SceneData, origin, direction, far, sample_idx,
                       seed, d_out, settings: RenderSettings, tables=None,
                       env_tab=None, want_env: bool = False,
                       record: "mk.Record | None" = None):
    """Backward of the megakernel's per-ray outputs: for their cotangent
    `d_out` [N, C] (the color's in columns 0-2; with an envmap the miss
    attenuation's in 3-5 and the accumulated roughness's in 6), ([K, 12|13]
    per-material cotangents, and with `want_env` and env NEE the finest
    mip's cotangent [H, W, 3], else None). The adjoint kernel (and, for the
    mip, the sky's per-texel sum) on a CUDA device, the plain version on
    the CPU. With `record` (a CUDA forward's transcript of these rays) the
    record route's sweep, which reads no rays (origin to seed may be
    None); without, the replay."""
    if record is not None:
        return _outputs_backward(scene, None, None, None, None, None, d_out,
                                 settings, tables, env_tab, want_env, record)
    if origin.device.type == "cpu":
        _check_covered(scene, settings)
        return trace_grad_outputs_reference(scene, origin, direction, far,
                                            sample_idx, seed, d_out,
                                            settings, want_env)
    if origin.device.type != "cuda":
        raise ValueError(f"no adjoint kernel for device {origin.device}")
    return _outputs_backward(scene, origin, direction, far, sample_idx, seed,
                             d_out, settings, tables, env_tab, want_env, None)


def _outputs_backward(scene, origin, direction, far, sample_idx, seed, d_out,
                      settings: RenderSettings, tables, env_tab, want_env,
                      record):
    """`trace_grad_outputs` on a CUDA device: the replay, or with `record`
    the sweep."""
    env = env_mode(scene, settings)
    ct = d_out[:, 0:3].contiguous()
    gsky = d_out[:, 3:7].contiguous() if env else None
    records = None
    n = d_out.shape[0]
    if env == 2:
        slots = settings.max_bounces + 1
        records = (torch.empty((n, slots), dtype=torch.int32,
                               device=d_out.device),
                   torch.empty((n, slots, 3), dtype=torch.float32,
                               device=d_out.device))
    dmat = _launch(scene, origin, direction, far, sample_idx, seed, ct,
                   settings, tables, gsky=gsky, env_tab=env_tab,
                   records=records, record=record)
    d_env = None
    if want_env and env == 2:
        h, w = scene.env_cdf.pdf.shape
        d_env = sky.scatter_texels(records[0].reshape(-1),
                                   records[1].reshape(-1, 3),
                                   h * w).reshape(h, w, 3)
    return dmat, d_env


def trace_grad_pixels(scene: SceneData, view: "mk.PixelView", lane0: int,
                      spp_block: int, d_out, settings: RenderSettings,
                      tables=None, env_tab=None, light_tab=None,
                      want_env: bool = False):
    """The 'rerecord' route's backward of one group of pixels (area-light
    NEE past the record budget, `record_plan`): `trace_grad_outputs` of
    the group's rays, `group_rays(view.camera, settings, view.frame,
    view.pix, lane0, spp_block)`, from a record made here and dropped on
    return. On a CUDA device the recording forward from pixels (the kernel
    makes the same rays, so it writes the transcript the record route's
    forward would have), then the sweep; on the CPU `group_rays`,
    `record_transcript_reference` and `sweep_reference`."""
    dev = view.pix.device
    if dev.type == "cpu":
        _check_covered(scene, settings)
        o, d, sidx, seed = group_rays(view.camera, settings, view.frame,
                                      view.pix, lane0, spp_block)
        rec = record_transcript_reference(scene, o, d, view.camera.far,
                                          sidx, seed, settings)
        dmat, records = sweep_reference(scene, settings, rec, d_out)
        d_env = None
        if want_env and records is not None:
            h, w = scene.env_cdf.pdf.shape
            d_env = sky.scatter_texels(records[0].reshape(-1),
                                       records[1].reshape(-1, 3),
                                       h * w).reshape(h, w, 3)
        return dmat, d_env
    if dev.type != "cuda":
        raise ValueError(f"no adjoint kernel for device {dev}")
    rec = mk.empty_record(view.pix.shape[0] * spp_block, settings,
                          _use_nee(scene, settings), dev,
                          _use_light_nee(scene, settings))
    mk.trace_pixels_outputs(scene, view, lane0, spp_block, settings, tables,
                            env_tab, light_tab=light_tab, record=rec)
    return _outputs_backward(scene, None, None, None, None, None, d_out,
                             settings, tables, env_tab, want_env, rec)


def trace_grad_fused_reference(scene: SceneData, origin, direction, far,
                               sample_idx, seed, ct,
                               settings: RenderSettings):
    """Plain version of `trace_grad_fused`: autograd of (color * ct).sum()
    through the lockstep `trace_rays`, the sky included. Returns
    ([K, 12|13], one cotangent per mip, or None without an envmap in
    use)."""
    env_leaves = (tuple(range(len(scene.env_mips)))
                  if env_mode(scene, settings) else ())
    return _reference_grads(scene, origin, direction, far, sample_idx, seed,
                            settings, lambda tr: (tr.color * ct).sum(),
                            env_leaves)


def trace_grad_fused_materials_reference(scene: SceneData, origin,
                                         direction, far, sample_idx, seed,
                                         ct, settings: RenderSettings
                                         ) -> torch.Tensor:
    """The [K, 12|13] of `trace_grad_fused_reference`."""
    return trace_grad_fused_reference(scene, origin, direction, far,
                                      sample_idx, seed, ct, settings)[0]


def _main_path_grads(scene: SceneData, origin, direction, far, sample_idx,
                     seed, ct, settings: RenderSettings, tables, env_tab):
    """([K, 13], one cotangent per mip) of (color * ct).sum() by autograd
    through `megakernel.trace_color_fused_diff`, the composition a render's
    backward runs (the forward kernel and the sky forward; then the sky
    backward, the adjoint and the per-texel sums), with the material table
    and the mips as leaves. On CPU tensors each piece takes its plain
    version."""
    mat_tab = tables[3].detach().requires_grad_(True)
    mips = [m.detach().requires_grad_(True) for m in scene.env_mips]
    with torch.enable_grad():
        color = mk.trace_color_fused_diff(
            dataclasses.replace(scene, env_mips=tuple(mips)), origin,
            direction, far, sample_idx, seed, settings,
            (*tables[:3], mat_tab), env_tab)
        d_tab, *d_env = torch.autograd.grad((color * ct).sum(),
                                            [mat_tab, *mips],
                                            allow_unused=True)
    d_env = tuple(torch.zeros_like(m) if g is None else g
                  for g, m in zip(d_env, mips))
    # _scene_tables' [K, 17] columns back onto the [K, 13] layout
    dmat = torch.cat([d_tab[:, 9:12], d_tab[:, 0:3], d_tab[:, 4:7],
                      d_tab[:, 13:16], d_tab[:, 8:9]], dim=1)
    return dmat, d_env


def trace_grad_fused(scene: SceneData, origin, direction, far, sample_idx,
                     seed, ct, settings: RenderSettings, tables=None,
                     env_tab=None):
    """Fused backward of the traced color (the sky included) for its
    cotangent `ct` [N, 3]: ([K, 12|13] per-material cotangents, one
    cotangent per mip or None without an envmap in use). On a CUDA device:
    without an envmap one adjoint launch; with one, autograd through the
    main path's Functions (`_main_path_grads`). On the CPU the plain
    version. `tables` and `env_tab` may carry
    `megakernel._scene_tables(scene)` and `megakernel.env_table(scene)`
    computed once for many calls."""
    if origin.device.type == "cpu":
        _check_covered(scene, settings)
        return trace_grad_fused_reference(scene, origin, direction, far,
                                          sample_idx, seed, ct, settings)
    if origin.device.type != "cuda":
        raise ValueError(f"no adjoint kernel for device {origin.device}")
    if not env_mode(scene, settings):
        return _launch(scene, origin, direction, far, sample_idx, seed, ct,
                       settings, tables), None
    tables = tables if tables is not None else mk._scene_tables(scene)
    if _use_nee(scene, settings) and env_tab is None:
        env_tab = mk.env_table(scene)
    return _main_path_grads(scene, origin, direction, far, sample_idx, seed,
                            ct, settings, tables, env_tab)


def trace_grad_fused_materials(scene: SceneData, origin, direction, far,
                               sample_idx, seed, ct,
                               settings: RenderSettings,
                               tables=None, env_tab=None) -> torch.Tensor:
    """The [K, 12|13] per-material cotangents of `trace_grad_fused` (d
    emission premultiplied rgb | d albedo rgb | d specular rgb | d
    absorption rgb | with the sky d roughness)."""
    return trace_grad_fused(scene, origin, direction, far, sample_idx, seed,
                            ct, settings, tables, env_tab)[0]


def material_cotangents(scene: SceneData, dmat12: torch.Tensor
                        ) -> MaterialTable:
    """Map the kernel's [K, 12|13] rows onto a `MaterialTable` of
    cotangents. Emission arrives with respect to the premultiplied rgb *
    intensity (`megakernel._scene_tables` col 9:12), so it is chained
    through the product to the table's rgb + intensity layout. Roughness
    gets the 13th column where there is one; metallic, IOR and the alpha
    column get zeros, priority int32 zeros."""
    mats = scene.materials
    d_pre = dmat12[:, 0:3]
    zero = torch.zeros_like
    return MaterialTable(
        albedo=torch.cat([dmat12[:, 3:6], zero(mats.albedo[:, 3:])], dim=1),
        specular=dmat12[:, 6:9],
        metallic=zero(mats.metallic),
        roughness=(dmat12[:, 12] if dmat12.shape[1] > N_GRAD
                   else zero(mats.roughness)),
        emissive=torch.cat(
            [d_pre * mats.emissive[:, 3:4],
             (d_pre * mats.emissive[:, :3]).sum(dim=1, keepdim=True)],
            dim=1),
        ior=zero(mats.ior),
        absorption=dmat12[:, 9:12],
        priority=zero(mats.priority),
    )
