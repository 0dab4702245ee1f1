"""The port's CLI (`python -m halogen_tpu_torch.cli`) and observability
utilities, as `tests/test_cli_utils.py` checks the JAX package's, on the
CPU (`--device cpu`): the throughput meter and frame statistics, `render`
(with light NEE too) and `bench`, `debug-sobol`, a checkpoint resume and a
short `fit`, the images against the JAX CLI's on the same arguments, and
`render --sharded` and the `dragons_hero` preset over a group of one.

Images: the 8-bit PNGs of both CLIs may differ by one level where a
pixel's radiance rounds across a level boundary (the renders agree at
1e-5, see test_torch_render.py).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from halogen_tpu.cli.main import main as j_main
from halogen_tpu_torch.cli.main import main
from halogen_tpu_torch.utils import debug as tdebug
from halogen_tpu_torch.utils import profiling
from halogen_tpu_torch.utils.metrics import RaysMeter, RenderStats

RENDER = ["--scene", "cornell", "--width", "16", "--spp", "1", "--bounces",
          "1", "--frames", "1", "--chunk", "256"]
CPU = ["--device", "cpu"]


def _png(path):
    return np.asarray(Image.open(path), dtype=np.int16)


def test_rays_meter_window():
    now = [0.0]
    meter = RaysMeter(window_s=1.0, clock=lambda: now[0])
    for k in range(10):
        now[0] = k * 0.1
        meter.add(1_000_000)
    assert 8.0 < meter.mrays_per_sec < 13.0  # 10 Mrays over ~0.9 s
    now[0] = 5.0  # everything aged out
    assert meter.mrays_per_sec == 0.0


def test_render_stats_mrays():
    st = RenderStats(frame=1, width=100, height=100, spp=4, wall_s=0.004)
    assert st.rays == 40_000
    np.testing.assert_allclose(st.mrays_per_sec, 10.0)


@pytest.mark.parametrize("light_nee", [False, True])
def test_cli_render_and_bench_match_jax(tmp_path, capsys, light_nee):
    """`render` writes the JAX CLI's image on the same arguments (with
    `--light-nee` too: the Cornell panel's area-light NEE); `bench` prints
    one JSON line with the JAX CLI's keys."""
    extra = ["--light-nee"] if light_nee else []
    out, ref = str(tmp_path / "r.png"), str(tmp_path / "j.png")
    assert main(["render", *RENDER, *extra, *CPU, "--out", out]) == 0
    assert j_main(["render", *RENDER, *extra, "--out", ref]) == 0
    got, want = _png(out), _png(ref)
    assert got.shape == want.shape == (16, 16, 3) and got.max() > 0
    assert np.abs(got - want).max() <= 1

    assert main(["bench", *RENDER, *extra, *CPU, "--out", out]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")][-1]
    rec = json.loads(line)
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["value"] > 0 and rec["unit"] == "Mrays/s/cpu"
    assert rec["metric"] == "fwd_throughput_cornell"
    np.testing.assert_allclose(rec["vs_baseline"], rec["value"] / 100.0,
                               atol=1e-4)


def test_cli_debug_sobol_matches_jax(tmp_path):
    out, ref = str(tmp_path / "s.png"), str(tmp_path / "j.png")
    args = ["debug-sobol", "--width", "32", "--count", "5000"]
    assert main([*args, *CPU, "--out", out]) == 0
    assert j_main([*args, "--out", ref]) == 0
    got, want = _png(out), _png(ref)
    assert got.shape == want.shape == (32, 32, 3) and got.max() == 255
    assert np.abs(got - want).max() <= 1


def test_cli_checkpoint_resume(tmp_path):
    out = str(tmp_path / "r.png")
    ck = str(tmp_path / "state.npz")
    for _ in range(2):
        assert main(["render", *RENDER[:-4], "--frames", "2", "--chunk",
                     "256", *CPU, "--out", out, "--checkpoint", ck]) == 0
    data = np.load(ck)
    assert int(data["frame_count"]) >= 3  # resumed past the first run


def test_cli_fit_matches_jax(tmp_path, capsys):
    """The fit demo's losses equal the JAX CLI's (each step renders
    another frame of the sample stream, so they need not fall; the JAX
    package's demo does the same, ROADMAP §C)."""
    out = str(tmp_path / "f.png")
    args = ["fit", "--scene", "cornell", "--width", "8", "--spp", "1",
            "--bounces", "1", "--steps", "2", "--out", out]
    recs = []
    for run in (main, j_main):
        assert run([*args, *CPU] if run is main else args) == 0
        recs.append(json.loads([ln for ln in capsys.readouterr().out
                                .splitlines() if ln.startswith("{")][-1]))
    got, ref = recs
    assert set(got) == set(ref) == {"initial_loss", "final_loss"}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4)
    assert os.path.exists(out)


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """`--sharded` and the `dragons_hero` preset render (they raised
    before): over a group of this process alone, formed and ended by the
    command; the preset at a small size. Without a card the default
    device raises."""
    import torch.distributed as dist

    import importlib

    cli_main = importlib.import_module("halogen_tpu_torch.cli.main")

    out = str(tmp_path / "r.png")
    assert main(["render", *RENDER, "--sharded", *CPU, "--out", out]) == 0
    assert os.path.exists(out) or os.path.exists(out + ".npy")
    monkeypatch.setitem(cli_main.PRESETS, "dragons_hero", dict(
        cli_main.PRESETS["dragons_hero"], width=8, spp=1, bounces=1,
        frames=2))
    hero = str(tmp_path / "hero.png")
    assert main(["render", "--preset", "dragons_hero", *CPU, "--out",
                 hero]) == 0
    assert os.path.exists(hero) or os.path.exists(hero + ".npy")
    assert not dist.is_initialized()
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["render", *RENDER, "--out", out])


def test_debug_and_profiling_utilities(tmp_path):
    """assert_finite walks tensors, dataclasses and NamedTuples;
    check_replay_determinism holds a render bitwise; trace writes a Chrome
    trace; timed and annotate wrap a block."""
    import halogen_tpu_torch as ht
    from halogen_tpu_torch.scene import cornell

    scene = cornell.cornell_box().build(device="cpu")
    tdebug.assert_finite(scene, "scene")
    bad = scene.materials.albedo.clone()
    bad[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"scene\.materials\.albedo"):
        tdebug.assert_finite(dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials,
                                                 albedo=bad)), "scene")
    with pytest.raises(FloatingPointError, match="lights.cdf"):
        tdebug.assert_finite(scene.lights._replace(
            cdf=scene.lights.cdf / 0.0 * 0.0), "lights")
    cam = ht.make_camera(device="cpu")
    st = ht.RenderSettings(width=8, height=8, max_bounces=1,
                           light_importance_sampling=True)
    assert tdebug.check_replay_determinism(ht.render_frame, scene, cam, st, 1)
    with tdebug.nan_guard():
        x = torch.ones(2, requires_grad=True)
        (x * 2).sum().backward()
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("frame"), profiling.timed("frame", rays=64):
            ht.render_frame(scene, cam, st, 1)
    assert (tmp_path / "trace" / "trace.json").exists()
    assert any(r.key == "frame" for r in prof.key_averages())
