"""The light-NEE adjoint past the record budget on the CPU: the route that
records each group again in its backward ('rerecord').

Area-light NEE has no replay kernel, so a gradient step whose records pass
`adjoint.RECORD_BUDGET` keeps no record in its forward: each group's
backward regenerates the group's rays, records their transcript, sweeps it
and drops it (`adjoint.trace_grad_pixels`). `adjoint.record_plan` picks
the route from sizes alone; only a launch whose own record passes the
budget raises. On the CPU the route's halves are the plain versions
(`group_rays`, `adjoint.record_transcript_reference`,
`adjoint.sweep_reference`); they are held here to autograd through the
port's lockstep (1e-5 * max |column| + 1e-7) and to `jax.grad` of the JAX
package's lockstep on the same rays, with the tolerance and forward
agreement of `tests/test_torch_adjoint_record.py`'s held cases: the rays
whose colors part past 1e-6 + 1e-6 |JAX| (XLA's contraction of the
sphere test's dot product, and the near-mirror lobes that grow it) get a
zero cotangent, and each column is held to atol 1e-6 + rtol 1e-5 * its
largest |entry|. The kernels take the same route on the card
(`tests/test_torch_adjoint_cuda.py`, `chip_smoke.py` phase 42).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax_native_sah import jax_native_sah  # noqa: F401  (autouse)
import torch

import halogen_tpu as jht
from halogen_tpu.config import Intersector as JIntersector
from halogen_tpu.integrator.trace import trace_rays as j_trace_rays
from halogen_tpu.scene import cornell as jcornell
from halogen_tpu.scene.envmap import Envmap as JEnvmap
from halogen_tpu_torch import interop
from halogen_tpu_torch.config import RenderSettings
from halogen_tpu_torch.diff.grad import (
    FLOAT_MATERIAL_FIELDS,
    with_material_params,
)
from halogen_tpu_torch.integrator.trace import group_rays
from halogen_tpu_torch.kernels import adjoint as adj
from halogen_tpu_torch.kernels import megakernel as mk

CPU = "cpu"
CAM = dict(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40)
W, SPP, BLOCK = 12, 4, 2  # two groups of 288 rays
ATOL, RTOL = 1e-6, 1e-5  # tests/test_torch_adjoint_record.py
NEE = dict(use_envmap=True, env_importance_sampling=True, env_mip_level=0)
# name: (JAX scene builder, sky, settings beyond the base)
CASES = {
    "cornell_glossy": (lambda env: jcornell.cornell_box(glossy=True).build(
        envmap=env), False, {}),
    "glow_orbs": (lambda env: jcornell.glow_orbs().build(envmap=env), False,
                  {}),
    "cornell_glossy_sky": (lambda env: jcornell.cornell_box(
        glossy=True).build(envmap=env), True, NEE),
}
# the share of an 80 GB card RECORD_SHARE gives
CARD_BUDGET = int(adj.RECORD_SHARE * 80e9)


def _counts():
    return (mk.LAUNCHES, mk.RECORD_LAUNCHES, adj.LAUNCHES,
            adj.SWEEP_LAUNCHES)


# the full-width light-NEE steps of chip_smoke.py phase 42: (scene,
# settings, launches of 262144 rays, GB of records on the record route)
STEPS = {
    "cornell_glossy_1024_256spp": ("cornell", dict(
        width=1024, height=1024, samples_per_pixel=256, max_bounces=6),
        1024, 68.7),
    "glass_dragon_1024_64spp": ("glass_dragon", dict(
        width=1024, height=1024, samples_per_pixel=64, max_bounces=12),
        256, 31.7),
}


@pytest.fixture(scope="module")
def step_scenes():
    from halogen_tpu_torch.scene import cornell, meshes

    return dict(cornell=cornell.cornell_box(glossy=True).build(device=CPU),
                glass_dragon=meshes.glass_dragon_scene(tris=1280).build(
                    device=CPU))


@pytest.mark.parametrize("step", sorted(STEPS))
def test_plan_has_three_outcomes_from_sizes_alone(step_scenes, step):
    """The plan of a full-width light-NEE step, from sizes alone and with
    no launch: 'recorded' where the step's records fit the budget beside
    those alive; 'rerecord' past it while one launch's record fits (an 80
    GB card's share holds neither step's records); a raise naming the
    launch's bytes and `ray_chunk_size` below that."""
    kind, kw, launches, gb = STEPS[step]
    sc = step_scenes[kind]
    st = RenderSettings(**kw, light_importance_sampling=True)
    assert sc.lights is not None and adj.adjoint_covers(sc, st)
    assert launches * 262144 == st.num_pixels * st.samples_per_pixel
    one = adj.record_bytes(sc, st, 262144)
    assert one == 4 * 262144 * (1 + (st.max_bounces + 1) * 9)
    assert abs(launches * one / 1e9 - gb) < 0.05
    live = mk.live_record_bytes(CPU)
    before = _counts()
    assert adj.record_plan(sc, st, 262144, launches,
                           launches * one + live) == "recorded"
    assert adj.record_plan(sc, st, 262144, launches, CARD_BUDGET) == (
        "rerecord")
    assert adj.record_plan(sc, st, 262144, launches, one + live) == (
        "rerecord")
    with pytest.raises(NotImplementedError, match="ray_chunk_size") as e:
        adj.record_plan(sc, st, 262144, launches, one + live - 1)
    assert str(one) in str(e.value)
    # without light NEE a step past the budget replays
    assert adj.record_plan(sc, st.replace(light_importance_sampling=False),
                           262144, launches, one + live) == (
        adj.transcript_route(sc, st))
    assert _counts() == before


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(name, JAX scene, its port, the port's camera, settings kwargs)."""
    build, sky, kw = CASES[request.param]
    js = build(JEnvmap.gradient_sky() if sky else None)
    scene = interop.scene_from_numpy(interop.scene_to_numpy(js), device=CPU)
    cam = interop.camera_from_numpy(
        interop.camera_to_numpy(jht.make_camera(**CAM)), device=CPU)
    kw = dict(width=W, height=W, samples_per_pixel=SPP, max_bounces=4,
              ray_chunk_size=W * W * BLOCK, light_importance_sampling=True,
              **kw)
    return request.param, js, scene, cam, kw


def _route_step(scene, cam, st, ct, route, env):
    """sum(color * ct) over the frame's two groups through
    `trace_color_pixels_diff` on `route`, and its gradients: the float
    material fields, with the sky every mip."""
    leaves = {f: getattr(scene.materials, f).detach().clone()
              .requires_grad_(True) for f in FLOAT_MATERIAL_FIELDS}
    mips = [m.detach().clone().requires_grad_(env) for m in scene.env_mips]
    sc = dataclasses.replace(
        scene, materials=with_material_params(scene.materials, leaves),
        env_mips=tuple(mips))
    view = mk.pixel_view(cam, st, 1, torch.arange(W * W))
    with torch.enable_grad():
        cols = [mk.trace_color_pixels_diff(sc, view, g * BLOCK, BLOCK, st,
                                           record=route)
                for g in range(SPP // BLOCK)]
        loss = sum((c * t).sum() for c, t in zip(cols, ct))
        wrt = list(leaves.values()) + (mips if env else [])
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(wrt, grads)]
    return (torch.cat([c.detach() for c in cols]),
            dict(zip(leaves, grads[:len(leaves)])), grads[len(leaves):])


def _jax_grads(js, kw, rays):
    """A function of ct, compiled once: (color, jax.grad of sum(color *
    ct) w.r.t. the materials) through the JAX lockstep on the given rays
    (brute-force hits, as the port's plain backward pins)."""
    st = jht.RenderSettings(**kw, intersector=JIntersector.BRUTE)
    o, d, sidx, seed, far = rays

    def loss(mats, ct):
        sc = dataclasses.replace(js, materials=mats)
        color = j_trace_rays(sc, jnp.asarray(o), jnp.asarray(d),
                             jnp.full((o.shape[0],), far),
                             jnp.asarray(sidx), jnp.asarray(seed), st).color
        return jnp.sum(color * ct), color

    grad = jax.jit(jax.grad(loss, has_aux=True, allow_int=True))

    def run(ct):
        g, color = grad(js.materials, jnp.asarray(ct))
        return np.asarray(color), interop.material_table_to_numpy(g)

    return run


def test_rerecord_route_matches_autograd_and_jax_grad(case):
    """The route's CPU counterpart on two groups of a 12x12, 4 spp frame
    (light NEE; Cornell glossy under the sky with env NEE too): its loss
    equals the plain forward's, its gradients equal autograd through the
    port's lockstep (the 'rays' route's backward on the CPU; with the sky
    every mip too) and `jax.grad` of the JAX lockstep on the same rays;
    no kernel launch is counted."""
    name, js, scene, cam, kw = case
    st = RenderSettings(**kw)
    env = bool(adj.env_mode(scene, st))
    n = W * W * BLOCK
    rng = np.random.default_rng(0)
    ct = rng.uniform(0.0, 1.0, (SPP // BLOCK, n, 3)).astype(np.float32)
    rays = [group_rays(cam, st, 1, torch.arange(W * W), g * BLOCK, BLOCK)
            for g in range(SPP // BLOCK)]
    rays = [np.concatenate([r[i].numpy() for r in rays]) for i in range(4)]
    rays[2:] = [r.astype(np.uint32) for r in rays[2:]]
    jax_grads = _jax_grads(js, kw, (*rays, np.float32(cam.far.numpy())))
    j_col, _ = jax_grads(ct.reshape(-1, 3))
    with torch.no_grad():
        view = mk.pixel_view(cam, st, 1, torch.arange(W * W))
        col = torch.cat([mk.trace_color_pixels_diff(
            scene, view, g * BLOCK, BLOCK, st, record="rerecord")
            for g in range(SPP // BLOCK)])
    agree = (np.abs(col.numpy() - j_col)
             <= 1e-6 + 1e-6 * np.abs(j_col)).all(axis=1)
    assert (~agree).sum() <= 0.05 * agree.shape[0], (~agree).sum()
    ct = ct * agree.reshape(SPP // BLOCK, n)[..., None]
    before = _counts()
    col_re, g_re, env_re = _route_step(scene, cam, st, torch.from_numpy(ct),
                                       "rerecord", env)
    assert _counts() == before and torch.equal(col_re, col)
    _, g_auto, env_auto = _route_step(scene, cam, st, torch.from_numpy(ct),
                                      "rays", env)
    for f in FLOAT_MATERIAL_FIELDS:
        got, ref = g_re[f], g_auto[f]
        bound = 1e-5 * ref.abs().amax(dim=0) + 1e-7
        assert torch.isfinite(got).all()
        assert ((got - ref).abs() <= bound).all(), (f, (got - ref).abs())
    for got, ref in zip(env_re, env_auto):
        assert float((got - ref).abs().max()) <= (
            1e-5 * float(ref.abs().max()) + 1e-7)
    if env:
        assert float(env_re[0].abs().max()) > 0
    _, ref = jax_grads(ct.reshape(-1, 3))
    got = interop.material_table_to_numpy(
        dataclasses.replace(scene.materials, **{f: g_re[f].detach()
                                                for f in g_re}))
    assert np.abs(ref["albedo"]).max() > 0 and np.abs(ref["emissive"]).max() > 0
    for f in FLOAT_MATERIAL_FIELDS:
        bound = ATOL + RTOL * np.abs(ref[f]).max(axis=0)
        assert (np.abs(got[f] - ref[f]) <= bound).all(), (
            f, (np.abs(got[f] - ref[f]) / bound).max())


def test_cpu_plans_no_record_and_refuses_one():
    """On the CPU a step plans no route of the card's ('rays': the plain
    versions, whose backward is autograd through the lockstep), takes
    'rerecord' when asked (above), and refuses 'recorded', whose record
    only a CUDA launch writes, before tracing."""
    from halogen_tpu_torch.scene import cornell

    scene = cornell.cornell_box().build(device=CPU)
    cam = interop.camera_from_numpy(
        interop.camera_to_numpy(jht.make_camera(**CAM)), device=CPU)
    st = RenderSettings(width=4, height=4, samples_per_pixel=2,
                        max_bounces=2, light_importance_sampling=True)
    leaf = scene.materials.albedo.detach().requires_grad_(True)
    sc = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials, albedo=leaf))
    with torch.enable_grad():
        tables = mk._scene_tables(sc)
        assert mk.grad_route(sc, st, tables, CPU, 32, 1) == "rays"
        view = mk.pixel_view(cam, st, 1, torch.arange(16))
        with pytest.raises(ValueError, match="CUDA device"):
            mk.trace_color_pixels_diff(sc, view, 0, 2, st, tables,
                                       record="recorded")
