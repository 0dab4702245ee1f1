"""The harness itself: discovery by name, whole-window statistics, the
work count, the import rules, and a run's refusals."""

import hashlib
import json
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, work  # noqa: E402
from portbench.reference import scene as rs  # noqa: E402
from portbench.reference import tracer as rt  # noqa: E402
from portbench.scenes import build  # noqa: E402


def _copy(tmp_path) -> pathlib.Path:
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def _digests(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)):
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_config_cell_and_metric_are_found_by_name(tmp_path):
    root = _copy(tmp_path)
    before = _digests(root)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "cornell_glossy.json").read_text())
    cfg.update(name="cornell_dim", settings=dict(cfg["settings"],
                                                 max_bounces=3))
    (pb / "configs" / "cornell_dim.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "frames_tiny.json").write_text(json.dumps(
        {"entry": "frames", "settings": {"width": 8, "height": 8},
         "check": {"pixels": 4, "limits": {"pixel_gap_q90": 0.1}}}))
    (pb / "metrics" / "steps_seen.py").write_text(
        "def read(trace, variant):\n    return trace.get('steps')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cornell_dim", "source": "x",
                             "file": "portbench/configs/cornell_dim.json",
                             "reduced": ["max_bounces"], "why": "x"})
    bench["workloads"].append({"name": "cornell_dim_tiny",
                               "config": "cornell_dim",
                               "traffic": "frames_tiny", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "frame_mrays",
                               "workloads": ["cornell_dim_tiny"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"].startswith(("frame_", "device_idle.frame")):
            m["workloads"].append("cornell_dim_tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.find_cell(root, "cornell_dim_tiny")
    assert cell.config["settings"]["max_bounces"] == 3
    assert cell.traffic["settings"]["width"] == 8
    assert cell.entry().run.__module__.startswith("portbench_entry_frames")
    assert {m["name"] for m in cell.e2e} == {"frame_mrays", "frame_p95_ms",
                                            "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"device_idle.frame",
                                                  "steps_seen"}
    out = {"correct": True, "attempted": 3, "failed": 0, "checks": {},
           "device": {"platform": "gpu"},
           "trace": {"kind": "frame", "steps": 3, "busy_s": 0.5,
                     "wall_s": 1.0, "launches": 9, "breakdown": {}}}
    line = harness.result_line(cell, out, trace=True)
    assert line["metrics"]["steps_seen"] == {"value": 3, "unit": "steps"}
    assert line["metrics"]["device_idle.frame"]["value"] == 50.0
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items() if k !=
               "BENCHMARK.json")


def test_whole_window_rate_and_p95_see_a_stall():
    # 90 frames of 10 ms, then 10 frames stalled at 200 ms each
    spans, t = [], 0.0
    for i in range(100):
        dt = 0.010 if i < 90 else 0.200
        spans.append((t, t + dt))
        t += dt
    ws = harness.window_stats(spans, 0.0)
    assert ws["steps"] == 100
    assert ws["rate"] == pytest.approx(100 / 2.9)
    assert ws["p95_s"] == pytest.approx(0.2)
    # the median of ten-frame chunks' rates hides the stall
    chunks = sorted(10 / (spans[i + 9][1] - spans[i][0])
                    for i in range(0, 100, 10))
    assert chunks[len(chunks) // 2] == pytest.approx(100.0)
    assert ws["rate"] < 0.4 * chunks[len(chunks) // 2]


def _quad_scene(env: bool):
    quad = {"kind": "mesh",
            "verts": build.np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0],
                                     [-1, 1, 0]], build.np.float32),
            "faces": build.np.array([[0, 1, 2], [0, 2, 3]], build.np.int32),
            "transform": build.np.eye(4, dtype=build.np.float32),
            "material": build.material(color=[0.5, 0.5, 0.5])}
    image = torch.ones((8, 16, 3)) if env else None
    return rs.build_scene([quad], "cpu", image, 2)


def test_work_of_two_rays_by_hand():
    # one ray hits the quad head on, one passes beside it to the sky;
    # no bounce after the first: 2 intersections, 1 shaded, 1 sky
    sc = _quad_scene(env=True)
    st = rt.settings(dict(max_bounces=0, russian_roulette=False,
                          use_envmap=True))
    o = torch.tensor([[0.0, 0.0, 2.0], [3.0, 0.0, 2.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    stats = {}
    rt.trace(sc, st, o, d, torch.full((2,), 100.0),
             torch.zeros(2, dtype=torch.int64),
             torch.zeros(2, dtype=torch.int64), stats=stats)
    counts = {k: float(v) for k, v in stats.items()}
    assert counts == {"isect": 2.0, "shaded": 1.0, "sky": 1.0}
    counts["rays"] = 2.0
    w = work.stretch_work(counts, 2, 100.0, 24.0, glass=False,
                          backward=False, primitives=2)
    ray = 90 + 2 * (2 * 71 + 12)
    shade = 230 + 2 * (2 * 71 + 31)
    assert w["ops"] == 2 * ray + 2 * 55 + shade + 200
    assert w["full_scan_ops"] == 2 * ray + 2 * 2 * 55 + shade + 200
    assert w["bytes"] == 124.0
    assert w["least_s"] == pytest.approx(max(w["ops"] / work.PEAK_FLOPS,
                                             124.0 / work.PEAK_BYTES))
    # on the same rays and the same busy time, the least work's share is
    # at most the full scan's
    busy = 1e-6
    assert w["least_s"] / busy <= w["full_scan_s"] / busy


def test_least_share_is_below_the_full_scan_share_on_cornell_rays():
    objects, cam = build.load("cornell_glossy")
    sc = rs.build_scene(objects, "cpu")
    from portbench.reference import camera as rc

    rcam = rc.make_camera(cam, 1.0, "cpu")
    st = rt.settings(dict(width=16, height=16, max_bounces=6))
    pix = torch.arange(256)
    stats = {}
    rt.sample_colors(sc, rcam, st, pix, torch.ones_like(pix),
                     torch.zeros_like(pix), stats=stats)
    counts = {k: float(v) for k, v in stats.items()}
    counts.update(rays=256.0, sky=0.0)
    w = work.stretch_work(counts, 256, 1e3, 1e3, False, False,
                          sc.num_triangles + sc.num_spheres)
    assert counts["isect"] >= 256 and counts["shaded"] <= counts["isect"]
    assert w["least_s"] < w["full_scan_s"]


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", "import sys, json; sys.path.insert(0, %r)\n"
         % str(ROOT) + code + "\nprint(json.dumps(sorted(sys.modules)))"],
        capture_output=True, text=True, check=True, cwd=ROOT).stdout
    return {m.split(".")[0] for m in json.loads(out.splitlines()[-1])}


def test_harness_and_reference_import_no_jax():
    tops = _modules_after(
        "import portbench.harness, portbench.common, portbench.work\n"
        "import portbench.entries.frames, portbench.entries.fit\n"
        "import portbench.port, portbench.control")
    assert not tops & {"jax", "jaxlib", "flax", "halogen_tpu"}
    ref = _modules_after("import portbench.reference.fit, "
                         "portbench.reference.tracer, portbench.scenes.build")
    assert not ref & {"jax", "jaxlib", "flax", "halogen_tpu",
                      "halogen_tpu_torch"}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "halogen_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "halogen_tpu.scene", sys)
    assert harness.forbidden_modules() == ["halogen_tpu.scene"]


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    root = _copy(tmp_path)  # BENCHMARK.json and portbench/ alone
    for cwd in (ROOT, root):
        p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                            "cornell_frames", "--seed", "3000000000",
                            "--seconds", "1", "--trace", "0"], cwd=cwd,
                           capture_output=True, text=True)
        assert p.returncode != 0
        assert '"correct"' not in p.stdout


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "cornell_frames", "--seed", "2200000001",
                        "--seconds", "2", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.splitlines()[-1])["correct"] is True
