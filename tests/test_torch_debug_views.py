"""PyTorch port vs JAX package: the debug views (albedo, normal, and the
ray-triangle and ray-box tests as heatmaps; `RenderSettings.debug_mode`).

Two routes: the brute force (Cornell glossy, 24x24) and the per-mesh BVH
walk (`Intersector.BVH`, a 1,280-triangle dragon under the Cornell
shell). Each scene goes through the JAX `trace_rays` once, on the rays
the port's `group_rays` makes for every pixel and lane of frame 1; the
JAX side of a view is its `render_pixels` lockstep branch on those rays,
`_debug_color` of that TraceOut (`trace.py:793-798`), averaged over the
lanes. The port renders each view through `render_frame`.

Tolerance: the first hit's albedo and normal, and the albedo and normal
views, at atol = rtol = 1e-5; the per-ray counts, and the heatmaps, equal;
each on every ray (pixel) but at most 1 in 256, the allowance of
`tests/test_torch_intersect.py` for XLA's FMAs on grazing rays, and every
normal within 1e-3. The first hit's normal per ray is allowed 1 ray in
128: XLA also contracts the sphere test's discriminant (b * b - 4 c) into
an FMA, and on Cornell glossy's spheres that moves t by ~1e-5 and the
normal by up to ~4e-5 on 6 of 1,152 rays.

The world BVH's plain walk (`traverse.traverse_world_walk_reference`,
the CPU route of a count view on PALLAS, TREELET, FLATLET and RAYLET)
finds the brute force's hits on every ray but at exact ties (ROADMAP §C,
"Ties"), with at most its triangle tests.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax_native_sah import jax_native_sah  # noqa: F401  (autouse)
import torch

import halogen_tpu as jht
from halogen_tpu.integrator import trace as jtrace
from halogen_tpu.scene import cornell as jcornell
from halogen_tpu.scene import meshes as jmeshes
from halogen_tpu.scene.envmap import Envmap as JEnvmap
from halogen_tpu.scene.material import Material as JMaterial
import halogen_tpu_torch as tht
from halogen_tpu_torch import interop
from halogen_tpu_torch.config import DebugMode, Intersector
from halogen_tpu_torch.integrator.trace import group_rays, trace_rays
from halogen_tpu_torch.kernels import traverse

CPU = "cpu"  # the port builds on the card unless asked for the CPU
CAM = dict(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40)
W = 24
SPP = 2
VIEWS = (DebugMode.ALBEDO, DebugMode.NORMAL, DebugMode.RAY_TRIANGLE_TESTS,
         DebugMode.RAY_BOX_TESTS, DebugMode.COMBINED)


def _dragon_box():
    """The Cornell shell around a 1,280-triangle dragon, under the sky
    (so a miss shows it)."""
    s = jcornell.cornell_box(with_spheres=False)
    verts, faces = jmeshes.dragon_mesh(3)
    s.add_mesh(verts, faces, JMaterial.metal((0.9, 0.6, 0.5), roughness=0.4),
               transform=jmeshes._scale_translate(0.55, (0.0, -0.45, 0.0)))
    return s.build(envmap=JEnvmap.gradient_sky(), world_bvh=False)


SCENES = {
    "cornell_brute": (lambda: jcornell.cornell_box(glossy=True).build(),
                      dict(max_bounces=3)),
    "dragon_bvh": (_dragon_box, dict(max_bounces=3, use_envmap=True,
                                     intersector=Intersector.BVH)),
}

_j_trace = jax.jit(jtrace.trace_rays, static_argnames=("settings",))


def _settings(pkg, kw, **extra):
    kw = {**kw, **extra}
    if pkg is jht and "intersector" in kw:
        kw["intersector"] = jht.Intersector(int(kw["intersector"]))
    if pkg is jht and "debug_mode" in kw:
        kw["debug_mode"] = jht.DebugMode(int(kw["debug_mode"]))
    return pkg.RenderSettings(width=W, height=W, samples_per_pixel=SPP,
                              ray_chunk_size=4096, **kw)


@pytest.fixture(scope="module", params=sorted(SCENES))
def traced(request):
    """Both packages' TraceOut on frame 1's rays (every pixel, SPP lanes
    pixel-major), and the port's scene and camera."""
    build, kw = SCENES[request.param]
    js = build()
    jc = jht.make_camera(**CAM)
    ts = interop.scene_from_numpy(interop.scene_to_numpy(js), device=CPU)
    tc = interop.camera_from_numpy(interop.camera_to_numpy(jc), device=CPU)
    out = {}
    for first_only in (False, True):
        tst = _settings(tht, kw, debug_mode=DebugMode.COMBINED,
                        first_interaction_only=first_only)
        pix = torch.arange(W * W)
        o, d, sidx, seed = group_rays(tc, tst, 1, pix, 0, SPP)
        far = tc.far.expand(o.shape[0])
        got = trace_rays(ts, o, d, far, sidx, seed, tst)
        jst = _settings(jht, kw, debug_mode=DebugMode.COMBINED,
                        first_interaction_only=first_only)
        ref = _j_trace(js, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                       jnp.asarray(far.numpy()),
                       jnp.asarray(sidx.numpy().astype(np.uint32)),
                       jnp.asarray(seed.numpy().astype(np.uint32)), jst)
        out[first_only] = (got, ref, jnp.asarray(d.numpy()),
                           jnp.asarray(far.numpy()))
    return request.param, kw, js, ts, tc, out


def _within(got, ref, tol=1e-5):
    return (np.abs(got - ref) <= tol + tol * np.abs(ref)).all(axis=-1)


@pytest.mark.parametrize("first_only", [False, True])
def test_trace_debug_fields_match_jax(traced, first_only):
    """Per ray: the counts of every bounce (of the first alone under
    `first_interaction_only`), the first hit's t, albedo and normal."""
    name, _, _, ts, _, out = traced
    got, ref, _, _ = out[first_only]
    n = got.tri_tests.shape[0]
    for key in ("tri_tests", "box_tests"):
        g, r = getattr(got, key).numpy(), np.asarray(getattr(ref, key))
        assert (g != r).sum() <= n // 256, (key, (g != r).sum())
    if name == "cornell_brute":  # every triangle a bounce, no box
        assert (got.box_tests == 0).all()
        walks = got.tri_tests // ts.num_triangles
        assert (got.tri_tests == ts.num_triangles * walks).all()
        assert walks.max() == (1 if first_only else 4) and walks.min() == 1
    else:
        assert got.box_tests.max() > 0
    if first_only:  # the first segment's tests are a part of every bounce's
        assert (got.tri_tests <= out[False][0].tri_tests).all()
        assert (got.box_tests <= out[False][0].box_tests).all()
    gt, rt = got.first_hit_t.numpy(), np.asarray(ref.first_hit_t)
    both_inf = np.isinf(gt) & np.isinf(rt)
    t_ok = both_inf | np.isclose(gt, rt, atol=1e-5, rtol=1e-5)
    assert (~t_ok).sum() <= n // 256
    hit = np.isfinite(gt) & t_ok
    assert hit.any()
    for key in ("first_hit_albedo", "first_hit_normal"):
        g = getattr(got, key).numpy()[hit]
        r = np.asarray(getattr(ref, key))[hit]
        assert (~_within(g, r)).sum() <= n // 128, key
        np.testing.assert_allclose(g, r, atol=1e-3, rtol=1e-3, err_msg=key)


@pytest.mark.parametrize("view", VIEWS, ids=[v.name for v in VIEWS])
def test_debug_view_frames_match_jax(traced, view):
    """`render_frame` under each view against the JAX lockstep's
    `_debug_color` of the same rays, averaged over the lanes."""
    name, kw, js, ts, tc, out = traced
    _, ref, jd, jfar = out[False]
    jst = _settings(jht, kw, debug_mode=view)
    col = np.asarray(jtrace._debug_color(ref, js, jd, jfar, jst))
    ref_img = (col.reshape(W * W, SPP, 3).sum(axis=1) / SPP).reshape(W, W, 3)
    got = tht.render_frame(ts, tc, _settings(tht, kw, debug_mode=view),
                           1).numpy()
    ok = _within(got, ref_img)
    assert (~ok).sum() <= W * W // 256, (
        f"{(~ok).sum()} pixels apart; max {np.abs(got - ref_img).max()}")
    assert np.isfinite(got).all()
    if name == "cornell_brute" and view == DebugMode.RAY_BOX_TESTS:
        assert (got == 0).all()  # the brute force tests no box
    else:
        assert got.max() > 0


@pytest.mark.parametrize("kind", [Intersector.PALLAS, Intersector.RAYLET])
def test_world_bvh_count_views_take_the_walk(kind):
    """A count view on a world-BVH intersector: on the CPU its counts are
    the plain walk's (boxes counted), not the brute force's, and its first
    hits the walk's too, equal to BRUTE's but at ties."""
    ts = interop.scene_from_numpy(interop.scene_to_numpy(_dragon_box()),
                                  device=CPU)
    tc = tht.make_camera(**CAM, device=CPU)
    kw = dict(max_bounces=2, use_envmap=True)
    st = _settings(tht, {**kw, "intersector": kind},
                   debug_mode=DebugMode.COMBINED)
    pix = torch.arange(W * W)
    o, d, sidx, seed = group_rays(tc, st, 1, pix, 0, 1)
    far = tc.far.expand(o.shape[0])
    out = trace_rays(ts, o, d, far, sidx, seed, st)
    assert out.box_tests.max() > 0 and out.box_tests.min() >= 0
    assert out.tri_tests.max() < ts.num_triangles
    brute = trace_rays(ts, o, d, far, sidx, seed, st.replace(
        intersector=Intersector.BRUTE))
    assert (brute.tri_tests >= ts.num_triangles).all()
    assert (brute.box_tests == 0).all()
    same = _within(out.first_hit_normal.numpy(),
                   brute.first_hit_normal.numpy())
    assert (~same).sum() <= o.shape[0] // 256


def test_walk_reference_matches_brute_force():
    """The plain walk's hits equal the brute-force plain version's on
    every ray but at exact ties, with at most its triangle tests; a seed
    at or below HIT_EPS walks nothing."""
    ts = interop.scene_from_numpy(interop.scene_to_numpy(
        jmeshes.dragons_hero_scene(2, tris=1280).build(world_bvh=False)),
        device=CPU)
    rng = np.random.default_rng(0)
    n = 2048
    tv = ts.tri_verts_world.numpy().reshape(-1, 3)
    lo, hi = tv.min(axis=0), tv.max(axis=0)
    mid, ext = (lo + hi) / 2, (hi - lo) / 2
    o = (mid + rng.uniform(-1.5, 1.5, (n, 3)) * ext).astype(np.float32)
    d = (mid + rng.uniform(-1.0, 1.0, (n, 3)) * ext - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    seed = rng.choice([np.inf, 2.0, 0.5, -1.0], n).astype(np.float32)
    args = (ts.wbvh, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(seed))
    walk = traverse.traverse_world_walk_reference(*args)
    brute = traverse.traverse_world_reference(*args)
    t_w, t_b = walk[0].numpy(), brute[0].numpy()
    np.testing.assert_array_equal(np.isinf(t_w), np.isinf(t_b))
    np.testing.assert_array_equal(t_w, t_b)  # the same float ops
    apart = walk[1].numpy() != brute[1].numpy()
    assert apart.sum() <= n // 256  # a tie at an edge two triangles share
    for k in (2, 3, 4):  # u, v, sign where the triangle is the same
        np.testing.assert_array_equal(walk[k].numpy()[~apart],
                                      brute[k].numpy()[~apart])
    tt, bt = walk[5].numpy(), walk[6].numpy()
    assert (tt <= brute[5].numpy()).all() and tt.sum() < brute[5].numpy().sum()
    dead = seed <= 1e-4
    assert (tt[dead] == 0).all() and (bt[dead] == 0).all()
    assert bt[~dead].min() >= 0 and bt.max() > 0
