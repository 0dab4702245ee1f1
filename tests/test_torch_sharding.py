"""The port's sharded rendering and gradients (`halogen_tpu_torch/parallel`)
in two real processes over `gloo`, against the JAX package's one-device
`render_frame` and `render_loss` gradients.

The workers re-execute this file (`python tests/test_torch_sharding.py
worker <rank> <port> <out>`), import only the port (no JAX, as on the
card's machine), form a group of two, and save what they compute; the
pytest side holds it to the JAX package, as `tests/test_multiprocess.py`
does for the JAX tier. Settings and tolerances are `tests/
test_sharding.py`'s: Cornell box, 24x24, 8 spp, 3 bounces, images at
atol 2e-5, rtol 1e-4 for meshes (2, 1) and (1, 2) and a 17x9 frame
that does not split evenly; a train step's material gradients at atol
1e-4, rtol 1e-3, and the envmap's at atol 1e-5, rtol 1e-3, with the loss
at rtol 1e-5 (the spp shards reorder the sums).
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
CAM = dict(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40)
ST = dict(width=24, height=24, samples_per_pixel=8, max_bounces=3,
          ray_chunk_size=256)
MESHES = ((2, 1), (1, 2))


def _worker(rank: int, port: int, out: str) -> None:
    import torch

    import halogen_tpu_torch as ht
    from halogen_tpu_torch.diff.grad import material_params
    from halogen_tpu_torch.parallel import scaling_bench
    from halogen_tpu_torch.parallel.sharding import (
        init_distributed,
        loss_and_grads_sharded,
        make_render_mesh,
        render_frame_sharded,
        train_step_sharded,
    )
    from halogen_tpu_torch.scene import cornell

    assert init_distributed(device="cpu", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    assert not init_distributed(device="cpu")  # already formed
    cam = ht.make_camera(**CAM, device="cpu")
    scene = cornell.cornell_box().build(device="cpu")
    sky = cornell.cornell_box().build(envmap=ht.Envmap.gradient_sky(),
                                      device="cpu")
    st = ht.RenderSettings(**ST)
    res = {}
    for px, spp in MESHES:
        mesh = make_render_mesh(px, spp)
        res[f"img_{px}x{spp}"] = render_frame_sharded(scene, cam, st, 1,
                                                      mesh).numpy()
        st_g = st.replace(samples_per_pixel=4, use_envmap=True)
        params = {"material_params": material_params(sky.materials),
                  "env_mips": sky.env_mips}
        target = torch.zeros((st.height, st.width, 3))
        for rep in range(2):  # a rerun repeats the bits
            loss, grads = loss_and_grads_sharded(params, sky, cam, st_g,
                                                 target, 1, mesh)
            res[f"loss_{px}x{spp}_{rep}"] = loss.numpy()
            for k, g in grads["material_params"].items():
                res[f"mat_{k}_{px}x{spp}_{rep}"] = g.numpy()
            for i, g in enumerate(grads["env_mips"]):
                res[f"mip{i}_{px}x{spp}_{rep}"] = g.numpy()
        new, loss = train_step_sharded(scene.materials, scene, cam,
                                       st.replace(samples_per_pixel=4),
                                       target, 1, mesh, lr=1e-1)
        res[f"step_emissive_{px}x{spp}"] = new.emissive.numpy()
        res[f"step_priority_{px}x{spp}"] = new.priority.numpy()
    odd = st.replace(width=17, height=9, ray_chunk_size=64)
    res["img_odd"] = render_frame_sharded(scene, cam, odd, 1,
                                          make_render_mesh(2, 1)).numpy()
    recs = scaling_bench.run_scaling_bench(width=8, spp=2, bounces=1,
                                           frames=1, device="cpu")
    res["scaling_devices"] = np.array([r["devices"] for r in recs])
    assert all(r["device"] == "cpu" and r["mrays_per_sec"] > 0
               for r in recs), recs
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    mods = [m for m in sys.modules if m.split(".")[0] in ("jax",
                                                          "halogen_tpu")]
    assert not mods, mods
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"worker {rank}: OK")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both workers' results (started first; the JAX side runs meanwhile
    in the tests)."""
    out = tmp_path_factory.mktemp("sharded")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__)), "worker", str(i),
         str(port), str(out)], env=env, cwd=str(REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]

    done = []

    def wait():
        if done:
            return done[0]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=300)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail("sharded worker timed out")
        for i, (p, o) in enumerate(zip(procs, outs)):
            assert p.returncode == 0 and f"worker {i}: OK" in o, o
        done.append([dict(np.load(out / f"rank{i}.npz")) for i in range(2)])
        return done[0]

    return wait


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's one-device frames and gradients."""
    import jax
    import jax.numpy as jnp

    import halogen_tpu as jht
    from halogen_tpu.diff.grad import material_params, render_loss
    from halogen_tpu.diff.grad import with_material_params
    from halogen_tpu.scene import cornell
    from halogen_tpu.scene.envmap import Envmap

    cam = jht.make_camera(**CAM)
    st = jht.RenderSettings(**ST)
    scene = cornell.cornell_box().build()
    refs = {"img": np.asarray(jht.render_frame(scene, cam, st, 1)),
            "img_odd": np.asarray(jht.render_frame(
                scene, cam, st.replace(width=17, height=9,
                                       ray_chunk_size=64), 1))}
    sky = cornell.cornell_box().build(envmap=Envmap.gradient_sky())
    st_g = st.replace(samples_per_pixel=4, use_envmap=True)
    params = {"material_params": material_params(sky.materials),
              "env_mips": sky.env_mips}

    def loss_fn(p):
        return render_loss({"materials": with_material_params(
            sky.materials, p["material_params"]),
            "env_mips": p["env_mips"]}, sky, cam, st_g,
            jnp.zeros((st.height, st.width, 3)), 1)

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(params)
    refs["loss"] = float(loss)
    refs["mat"] = {k: np.asarray(v)
                   for k, v in g["material_params"].items()}
    refs["mips"] = [np.asarray(m) for m in g["env_mips"]]
    refs["emissive"] = np.asarray(scene.materials.emissive)
    refs["priority"] = np.asarray(scene.materials.priority)
    return refs


@pytest.mark.parametrize("px,spp", MESHES)
def test_sharded_frames_match_jax(ranks, jax_refs, px, spp):
    """Every rank holds the whole image, `render_frame`'s up to the order
    of the sums; the ranks hold the same bits."""
    res = ranks()
    a, b = (r[f"img_{px}x{spp}"] for r in res)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, jax_refs["img"], atol=2e-5, rtol=1e-4)
    a, b = (r["img_odd"] for r in res)
    assert a.shape == (9, 17, 3)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, jax_refs["img_odd"], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("px,spp", MESHES)
def test_sharded_grads_match_jax(ranks, jax_refs, px, spp):
    """The summed gradients of materials and every mip against
    `jax.value_and_grad` of `render_loss`, on both ranks bit for bit and
    bitwise repeatable; the emission of a train step toward black falls,
    the integer fields stay."""
    res = ranks()
    tag = f"{px}x{spp}"
    for key in [k for k in res[0] if k.endswith(f"{tag}_0")]:
        for r in res:
            np.testing.assert_array_equal(r[key], r[key[:-1] + "1"],
                                          err_msg=key)
            np.testing.assert_array_equal(r[key], res[0][key], err_msg=key)
    got = res[0]
    np.testing.assert_allclose(got[f"loss_{tag}_0"], jax_refs["loss"],
                               rtol=1e-5)
    for k, ref in jax_refs["mat"].items():
        np.testing.assert_allclose(got[f"mat_{k}_{tag}_0"], ref, atol=1e-4,
                                   rtol=1e-3, err_msg=k)
    assert any(np.abs(m).sum() > 0 for m in jax_refs["mips"])
    for i, ref in enumerate(jax_refs["mips"]):
        np.testing.assert_allclose(got[f"mip{i}_{tag}_0"], ref, atol=1e-5,
                                   rtol=1e-3, err_msg=f"mip {i}")
    assert got[f"step_emissive_{tag}"].sum() < jax_refs["emissive"].sum()
    np.testing.assert_array_equal(got[f"step_priority_{tag}"],
                                  jax_refs["priority"])


def test_scaling_bench_over_subgroups(ranks):
    """The scaling bench measures meshes of 1 and 2 ranks."""
    for r in ranks():
        np.testing.assert_array_equal(r["scaling_devices"], [1, 2])


def test_init_distributed_raises_on_bad_config():
    """A configuration that cannot form a group raises at once, and
    leaves no group behind."""
    import torch.distributed as dist

    from halogen_tpu_torch.parallel.sharding import init_distributed

    with pytest.raises(ValueError):
        init_distributed(device="cpu", init_method="tcp://localhost:1",
                         world_size=-3, rank=7)
    with pytest.raises(RuntimeError):
        init_distributed(device="cpu", init_method="nonsense://x",
                         world_size=1, rank=0)
    assert not dist.is_initialized()


if __name__ == "__main__":
    if len(sys.argv) >= 5 and sys.argv[1] == "worker":
        sys.path.insert(0, str(REPO))
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
