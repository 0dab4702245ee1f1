"""The port's scripts (`halogen_tpu_torch/scripts/`, the JAX package's
`scripts/` ported): each `main` on the CPU at a tiny size, writing only
into a temporary directory. Each record has the JAX script's keys
(`scripts/hero_run.py:121-141`, `inverse_demo.py:71-74`,
`variance_bench.py:63-76`) and names the device; `hero_run --small`'s
image is `render_frame`'s at its settings bit for bit (one rank, one
frame); `gen_goldens` holds its frame to the JAX golden at
`tests/test_golden.py`'s bounds. No file of the checkout is written.
"""

import os
import pathlib

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
# where a script would write by default, and the JAX scripts' records
WATCHED = ("perf", "renders", "tests/golden", "tests/golden_torch")

JAX_KEYS = {
    "hero_run": {"key", "backend", "devices", "mesh", "width", "total_spp",
                 "frames", "bounces", "tris", "render_s", "mrays_per_s",
                 "mean_radiance", "finite", "grad_step_loss", "ts"},
    "inverse_demo": {"initial_loss", "final_loss", "steps", "out_dir"},
    "variance_bench": {"key", "width", "spp", "frames", "backend", "ts",
                       "mse_nee_on", "mse_nee_off", "variance_reduction_x"},
}


def _snapshot() -> dict:
    files = {}
    for top in WATCHED:
        for dirpath, _, names in os.walk(ROOT / top):
            for n in names:
                p = pathlib.Path(dirpath) / n
                files[str(p)] = p.stat().st_mtime_ns
    return files


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """Run from `tmp_path`; afterwards, no file of the checkout's output
    directories was written."""
    before = _snapshot()
    monkeypatch.chdir(tmp_path)
    yield tmp_path
    assert _snapshot() == before


def test_hero_run_small(in_tmp):
    import halogen_tpu_torch as ht
    from halogen_tpu_torch.scene.envmap import Envmap
    from halogen_tpu_torch.scene.meshes import dragons_hero_scene
    from halogen_tpu_torch.scripts import hero_run

    rec = hero_run.main(["--small", "--width", "8", "--spp-per-frame", "1",
                         "--frames", "1", "--out-dir", str(in_tmp / "o")])
    assert JAX_KEYS["hero_run"] <= rec.keys()
    assert rec["device"] == "cpu" and rec["key"] == "hero_small"
    assert rec["finite"] and rec["tris"] == 26138 and rec["total_spp"] == 1
    assert np.isfinite(rec["grad_step_loss"])
    assert (in_tmp / "o" / "hero_run.json").read_text().count("\n") == 1
    img = np.load(in_tmp / "o" / "hero.npz")["image"]
    scene = dragons_hero_scene().build(envmap=Envmap.gradient_sky(),
                                       device="cpu")
    cam = ht.make_camera(position=(0, 1.5, 5.0), target=(0, -0.3, 0),
                         fov_deg=45, device="cpu")
    st = ht.RenderSettings(width=8, height=8, samples_per_pixel=1,
                           max_bounces=8, use_envmap=True, ray_chunk_size=64)
    ref = ht.render_frame(scene, cam, st, 1).numpy()
    np.testing.assert_array_equal(img, ref)
    assert rec["mean_radiance"] == float(ref.mean())


def test_inverse_demo(in_tmp):
    from halogen_tpu_torch.scripts import inverse_demo

    out = in_tmp / "inv"
    rec = inverse_demo.main(["--cpu", "--width", "8", "--spp", "1",
                             "--steps", "2", "--out-dir", str(out)])
    assert JAX_KEYS["inverse_demo"] <= rec.keys() and rec["steps"] == 2
    assert rec["device"] == "cpu"
    assert np.isfinite([rec["initial_loss"], rec["final_loss"],
                        rec["held_out_loss_before"],
                        rec["held_out_loss_after"]]).all()
    for name in ("target", "before", "after"):
        assert any((out / f"{name}.png{s}").exists() for s in ("", ".npy"))
    assert (out / "fit.npz").exists()


def test_turntable(in_tmp):
    from halogen_tpu_torch.scripts import turntable

    rec = turntable.main(["--cpu", "--scene", "cornell", "--views", "2",
                          "--frames", "2", "--width", "8", "--spp", "1",
                          "--out", str(in_tmp / "tt")])
    assert rec["device"] == "cpu" and rec["finite"]
    assert len(rec["view_means"]) == 2 and rec["view_means"][0] > 0
    assert rec["written"] and all(os.path.exists(p) for p in rec["written"])


def test_variance_bench(in_tmp):
    from halogen_tpu_torch.scripts import variance_bench

    out = in_tmp / "var.jsonl"
    recs = variance_bench.main(["--cpu", "--width", "8", "--spp", "2",
                                "--frames", "2", "--ref-spp", "8",
                                "--out", str(out)])
    assert [r["key"] for r in recs] == ["cornell_glossy_lightnee",
                                        "material_demo_envnee"]
    for r in recs:
        assert JAX_KEYS["variance_bench"] <= r.keys()
        assert r["device"] == "cpu"
        assert r["mse_nee_on"] < r["mse_nee_off"]
    assert out.read_text().count("\n") == 2


def test_gen_goldens(in_tmp):
    from halogen_tpu_torch.scripts import gen_goldens

    recs = gen_goldens.main(["--cpu", "--only", "cornell_diffuse",
                             "--out-dir", str(in_tmp / "g")])
    assert [r["name"] for r in recs] == ["cornell_diffuse"]
    assert recs[0]["within"] and recs[0]["device"] == "cpu"
    img = np.load(in_tmp / "g" / "cornell_diffuse.npz")["image"]
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    assert sorted(gen_goldens.configs("cpu")) == sorted(
        p.stem for p in (ROOT / "tests" / "golden").glob("*.npz"))
