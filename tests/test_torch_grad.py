"""The port's gradient API (`halogen_tpu_torch/diff/grad.py`) vs the JAX
package's (`halogen_tpu/diff/grad.py`), on the CPU.

Scenes come from the JAX package through `interop.scene_from_numpy`, so
both packages see the same tables; targets are drawn from a numpy seed.
Material gradients must agree per float field at atol 1e-6, rtol 1e-5:
the two integrators are bit-identical on these fixtures, and their
backward passes differ only in the order of a few float sums (measured
agreement ~1e-7 relative).
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import halogen_tpu as jht
from halogen_tpu.diff import grad as jgrad
from halogen_tpu.scene import cornell as jcornell
from halogen_tpu.scene.material import Material as JMaterial
from halogen_tpu.scene.scene import Scene as JScene
import halogen_tpu_torch as tht
from halogen_tpu_torch import interop
from halogen_tpu_torch.diff import grad as tgrad
from halogen_tpu_torch.kernels import adjoint as adj
from halogen_tpu_torch.kernels import megakernel as mk

CPU = "cpu"  # the port builds on the card unless asked for the CPU

CAM = dict(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40)
# tests/test_grad.py:20-26
ST = dict(width=16, height=16, samples_per_pixel=4, max_bounces=3,
          ray_chunk_size=256)
FIELDS = tgrad.FLOAT_MATERIAL_FIELDS
ATOL, RTOL = 1e-6, 1e-5


def _glossy_sphere_box():
    """test_grad.py:180-186: a Cornell box with one glossy sphere."""
    s = jcornell.cornell_box(with_spheres=False)
    s.add_sphere((-0.45, -0.6, 0.2), 0.35,
                 JMaterial(color=(0.8, 0.6, 0.3), roughness=0.3,
                           metallic=0.5, specular_color=(0.9, 0.9, 0.9)))
    return s


def _enclosed_sphere_scene():
    """Rays leave the inside of an opaque absorbing sphere (exiting hits)
    after glossy bounces off a rough metal sphere: roughness reaches the
    image through the next direction, the next hit's t and Beer-Lambert
    absorption, unless the path geometry is detached."""
    s = JScene()
    s.add_sphere((0, 0, 0), 6.0,
                 JMaterial(color=(0.8, 0.8, 0.8), absorption=0.3))
    s.add_sphere((0, 0, -1), 0.8, JMaterial.metal((0.9, 0.9, 0.9),
                                                  roughness=0.3))
    s.add_sphere((0, 2.5, -1), 0.7, JMaterial.emissive((1, 1, 1), 4.0))
    return s


SCENES = {
    "glass": (lambda: jcornell.glass_sphere_box(), CAM),
    "cornell": (lambda: jcornell.cornell_box(), CAM),
    "glossy_sphere": (_glossy_sphere_box, CAM),
    "enclosed": (_enclosed_sphere_scene,
                 dict(position=(0, 0, 3), target=(0, 0, -1), fov_deg=40)),
}


def _both(name):
    """(JAX scene, JAX camera, port scene, port camera)."""
    make, cam_kw = SCENES[name]
    js, jc = make().build(), jht.make_camera(**cam_kw)
    return (js, jc,
            interop.scene_from_numpy(interop.scene_to_numpy(js), device=CPU),
            interop.camera_from_numpy(interop.camera_to_numpy(jc),
                                      device=CPU))


def _target(seed=0):
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (ST["height"], ST["width"], 3)).astype(np.float32)


_j_loss_grad = jax.jit(jgrad.render_loss_grad.__wrapped__,
                       static_argnames=("settings",))


def _grads_both(name, **kw):
    js, jc, ts, tc = _both(name)
    target = _target()
    jl, jg = _j_loss_grad({"materials": js.materials}, js, jc,
                          jht.RenderSettings(**{**ST, **kw}),
                          jnp.asarray(target), 1)
    tl, tg = tgrad.render_loss_grad({"materials": ts.materials}, ts, tc,
                                    tht.RenderSettings(**{**ST, **kw}),
                                    target, 1)
    return (float(jl), interop.material_table_to_numpy(jg["materials"]),
            tl, tg["materials"])


@pytest.mark.parametrize("name,rr", [("cornell", True), ("cornell", False),
                                     ("glossy_sphere", True)])
def test_render_loss_grad_matches_jax(name, rr):
    jl, jg, tl, tg = _grads_both(name, russian_roulette=rr)
    assert tl.shape == () and not tl.requires_grad
    np.testing.assert_allclose(float(tl), jl, rtol=RTOL)
    assert tg.priority.dtype == torch.int32 and not tg.priority.any()
    got = interop.material_table_to_numpy(tg)
    assert np.abs(jg["albedo"]).max() > 0 and np.abs(jg["emissive"]).max() > 0
    for f in FIELDS:
        assert got[f].shape == jg[f].shape
        np.testing.assert_allclose(got[f], jg[f], atol=ATOL, rtol=RTOL,
                                   err_msg=f)


GLASS = dict(max_bounces=8, max_transmission_bounces=8)


@pytest.mark.parametrize("rr", [True, False])
def test_glass_render_loss_grad_matches_jax(rr):
    """The glass-in-glass box at 8 bounces: the medium stack in the
    forward and its absorption in the gradient, per float field."""
    jl, jg, tl, tg = _grads_both("glass", russian_roulette=rr, **GLASS)
    np.testing.assert_allclose(float(tl), jl, rtol=RTOL)
    got = interop.material_table_to_numpy(tg)
    assert np.abs(jg["absorption"]).max() > 0
    for f in FIELDS:
        np.testing.assert_allclose(got[f], jg[f], atol=ATOL, rtol=RTOL,
                                   err_msg=f)
    for f in ("roughness", "metallic", "ior"):
        assert not got[f].any(), f


def test_glass_absorption_routes_to_the_current_medium():
    """Beer-Lambert acts through the medium a segment travels in: the
    outer glass (material 0, absorbing) takes the segments inside it and
    outside the bubble, including those that end on the bubble; the air
    bubble (material 1, absorption 0, higher precedence) takes the
    segments inside it, where d exp(-0 * t) / d absorption = -t, so its
    gradient is not 0. Both rows equal JAX's."""
    _, jg, _, tg = _grads_both("glass", russian_roulette=False, **GLASS)
    got = interop.material_table_to_numpy(tg)
    mats = _both("glass")[2].materials
    assert mats.absorption[0].min() > 0 and not mats.absorption[1].any()
    assert int(mats.priority[1]) < int(mats.priority[0])
    for row in (0, 1):
        assert np.abs(got["absorption"][row]).max() > 0
        np.testing.assert_allclose(got["absorption"][row],
                                   jg["absorption"][row], atol=ATOL,
                                   rtol=RTOL)


def test_roughness_metallic_ior_grads_exactly_zero():
    """The detach of path geometry in `_pool_bounce` (trace.py:504-512 of
    the JAX package): on a scene where roughness would otherwise reach the
    image through Beer-Lambert absorption on exiting hits, roughness,
    metallic and IOR gradients are exactly 0.0, as
    `tests/test_grad.py:210` pins them for the JAX package, and the other
    fields equal JAX's."""
    jl, jg, tl, tg = _grads_both("enclosed", russian_roulette=False)
    got = interop.material_table_to_numpy(tg)
    np.testing.assert_allclose(float(tl), jl, rtol=RTOL)
    assert np.abs(got["absorption"]).max() > 0  # exiting hits do occur
    for f in ("roughness", "metallic", "ior"):
        assert not got[f].any(), (f, np.abs(got[f]).max())
        assert not jg[f].any(), f
    for f in FIELDS:
        np.testing.assert_allclose(got[f], jg[f], atol=ATOL, rtol=RTOL,
                                   err_msg=f)


def test_albedo_gradient_fd():
    """test_grad.py:70-73 on the port: central finite differences vs
    autograd on the two brightest albedo rows, Russian roulette off (its
    kill threshold depends on the perturbed parameter)."""
    _, _, scene, cam = _both("cornell")
    st = tht.RenderSettings(**ST, russian_roulette=False)
    target = _target(7)
    params = {"materials": scene.materials}
    loss, grads = tgrad.render_loss_grad(params, scene, cam, st, target, 1)
    assert np.isfinite(float(loss))
    g = grads["materials"].albedo.numpy()
    al = scene.materials.albedo.numpy()
    rows = [k for k in range(al.shape[0]) if al[k, :3].max() > 0.3][:2]
    assert len(rows) == 2
    h = 1e-3
    for r in rows:
        def loss_at(v):
            arr = scene.materials.albedo.clone()
            arr[r, 0] = v
            mats = dataclasses.replace(scene.materials, albedo=arr)
            return float(tgrad.render_loss({"materials": mats}, scene, cam,
                                           st, target, 1))
        v0 = float(al[r, 0])
        fd = (loss_at(v0 + h) - loss_at(v0 - h)) / (2 * h)
        assert np.isfinite(fd) and np.isfinite(g[r, 0])
        np.testing.assert_allclose(g[r, 0], fd, rtol=0.12, atol=2e-5)


def _random_params(seed=0, k=5):
    rng = np.random.default_rng(seed)
    shapes = dict(albedo=(k, 4), specular=(k, 3), metallic=(k,),
                  roughness=(k,), emissive=(k, 4), ior=(k,),
                  absorption=(k, 3))
    return {f: (rng.normal(size=s) * 3.0).astype(np.float32)
            for f, s in shapes.items()}


def test_project_material_params_matches_jax():
    p = _random_params()
    ref = jgrad.project_material_params({f: jnp.asarray(v)
                                         for f, v in p.items()})
    inputs = {f: torch.from_numpy(v) for f, v in p.items()}
    got = tgrad.project_material_params(inputs)
    assert set(got) == set(ref)
    for f in p:
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(ref[f]))
        np.testing.assert_array_equal(inputs[f].numpy(), p[f])  # unchanged


def test_adam_matches_optax():
    """make_optimizer's Adam follows optax.adam(lr) step for step, at rtol
    1e-6 and atol 2e-6: optax computes the bias correction 1 - 0.999**t in
    float32 (relative error 1.3e-5 at t = 1), torch in float64, which
    moves an update of size lr = 5e-2 by ~3e-7; p + update then rounds to
    a neighbouring float (one ulp is 9.5e-7 for |p| in [4, 8))."""
    lr = 5e-2
    p = _random_params(1)
    grads = [_random_params(2 + i) for i in range(3)]
    jp = {f: jnp.asarray(v) for f, v in p.items()}
    opt = optax.adam(lr)
    state = opt.init(jp)
    tp = {f: torch.from_numpy(v.copy()).requires_grad_(True)
          for f, v in p.items()}
    topt = tgrad.make_optimizer(lr)(list(tp.values()))
    for g in grads:
        upd, state = opt.update({f: jnp.asarray(v) for f, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        for f, v in g.items():
            tp[f].grad = torch.from_numpy(v)
        topt.step()
        for f in p:
            np.testing.assert_allclose(tp[f].detach().numpy(),
                                       np.asarray(jp[f]), rtol=1e-6,
                                       atol=2e-6, err_msg=f)


# --- fit_materials: test_grad.py:118-127's emissive sphere --------------

FIT_ST = dict(ST, max_bounces=0, samples_per_pixel=1)
FIT_LR = 8e-2


def _fit_fixture():
    s = JScene()
    s.add_sphere((0, 0, 0), 1.0, JMaterial.emissive((1, 1, 1), 1.0))
    js = s.build()
    jc = jht.make_camera(**CAM)
    target = np.asarray(jht.render_frame(js, jc, jht.RenderSettings(**FIT_ST),
                                         1)) * 2.0
    return (js, jc,
            interop.scene_from_numpy(interop.scene_to_numpy(js), device=CPU),
            interop.camera_from_numpy(interop.camera_to_numpy(jc),
                                      device=CPU), target)


@pytest.fixture(scope="module")
def fit():
    """The fixture, JAX's 3-step fit, and a JAX checkpoint after 2 steps."""
    js, jc, ts, tc, target = _fit_fixture()
    jparams, jlosses = jgrad.fit_materials(
        js, jc, jht.RenderSettings(**FIT_ST), jnp.asarray(target), steps=3,
        lr=FIT_LR)
    return dict(js=js, jc=jc, ts=ts, tc=tc, target=target,
                jmats=interop.material_table_to_numpy(jparams["materials"]),
                jlosses=jlosses)


def _assert_materials_close(table, ref, rtol=1e-4):
    got = interop.material_table_to_numpy(table)
    for f in FIELDS:
        np.testing.assert_allclose(got[f], ref[f], rtol=rtol, atol=1e-6,
                                   err_msg=f)


def test_fit_materials_matches_jax(fit):
    seen = []
    params, losses = tgrad.fit_materials(
        fit["ts"], fit["tc"], tht.RenderSettings(**FIT_ST), fit["target"],
        steps=3, lr=FIT_LR, callback=lambda i, p, l: seen.append((i, l)))
    assert [i for i, _ in seen] == [0, 1, 2]
    assert [l for _, l in seen] == losses
    np.testing.assert_allclose(losses, fit["jlosses"], rtol=1e-4)
    assert losses[-1] < losses[0]
    _assert_materials_close(params["materials"], fit["jmats"])
    assert not params["materials"].emissive.requires_grad


def test_fit_resumes_from_jax_checkpoint(fit, tmp_path):
    """A fit checkpointed by the JAX package after 2 of 3 steps resumes in
    the port and ends where JAX's uninterrupted 3-step fit ends."""
    path = str(tmp_path / "fit.npz")
    jgrad.fit_materials(fit["js"], fit["jc"], jht.RenderSettings(**FIT_ST),
                        jnp.asarray(fit["target"]), steps=2, lr=FIT_LR,
                        checkpoint_path=path)
    assert int(np.load(path)["step"]) == 2
    params, losses = tgrad.fit_materials(
        fit["ts"], fit["tc"], tht.RenderSettings(**FIT_ST), fit["target"],
        steps=3, lr=FIT_LR, checkpoint_path=path)
    assert len(losses) == 1
    np.testing.assert_allclose(losses[0], fit["jlosses"][2], rtol=1e-4)
    _assert_materials_close(params["materials"], fit["jmats"])
    assert int(np.load(path)["step"]) == 3


def test_fit_state_roundtrip(fit, tmp_path):
    """The port's save/load round-trips params, Adam's state and the step,
    in the JAX layout (7 params, count, 7 mu, 7 nu), and a resumed fit
    equals an uninterrupted one."""
    st = tht.RenderSettings(**FIT_ST)
    path = str(tmp_path / "port.npz")
    full, full_losses = tgrad.fit_materials(
        fit["ts"], fit["tc"], st, fit["target"], steps=3, lr=FIT_LR)
    tgrad.fit_materials(fit["ts"], fit["tc"], st, fit["target"], steps=2,
                        lr=FIT_LR, checkpoint_path=path)
    data = np.load(path)
    assert sorted(data.files) == sorted(
        ["step"] + [f"leaf_{i}" for i in range(22)])
    assert data["leaf_7"].dtype == np.int32 and int(data["leaf_7"]) == 2

    mats = fit["ts"].materials
    params = {"material_params": {
        f: torch.zeros_like(getattr(mats, f)).requires_grad_(True)
        for f in FIELDS}}
    opt = tgrad.make_optimizer(FIT_LR)(tgrad._leaves(params))
    params, opt, step = tgrad.load_fit_state(path, params, opt)
    assert step == 2
    again = str(tmp_path / "again.npz")
    tgrad.save_fit_state(again, params, opt, step)
    for name in data.files:
        np.testing.assert_array_equal(np.load(again)[name], data[name])

    resumed, losses = tgrad.fit_materials(
        fit["ts"], fit["tc"], st, fit["target"], steps=3, lr=FIT_LR,
        checkpoint_path=path)
    np.testing.assert_allclose(losses, full_losses[2:], rtol=1e-6)
    _assert_materials_close(resumed["materials"],
                            interop.material_table_to_numpy(full["materials"]),
                            rtol=1e-6)


def test_out_of_slice_raises():
    _, _, scene, cam = _both("cornell")
    st = tht.RenderSettings(**ST)
    target = _target()
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tgrad.render_loss_grad({"materials": scene.materials,
                                "env_mips": ()}, scene, cam, st, target)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tgrad.fit_materials(scene, cam, st, target, steps=1,
                            optimize_env=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        tgrad.fit_materials(scene, cam, st, target, steps=1, mesh=object())


def test_gradient_route_imports_no_jax():
    """The gradient modules and a CPU gradient step load neither JAX nor
    the JAX package."""
    code = (
        "import sys, halogen_tpu_torch as ht\n"
        "from halogen_tpu_torch.diff import render_loss_grad\n"
        "from halogen_tpu_torch.kernels import adjoint\n"
        "from halogen_tpu_torch.scene import cornell\n"
        "s = cornell.cornell_box().build(device='cpu')\n"
        "st = ht.RenderSettings(width=4, height=4, max_bounces=1)\n"
        "render_loss_grad({'materials': s.materials}, s,"
        " ht.make_camera(device='cpu'),"
        " st, [[[0.0] * 3] * 4] * 4)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'halogen_tpu', 'optax')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert mk.LAUNCHES == 0 and adj.LAUNCHES == 0
