"""The port's spans and counters (`utils/profiling.py`): `annotate` is one
shared empty context while no profiler runs; under `torch.profiler` a
frame of `Renderer.step` and a step of `fit_materials` open their
`halogen.*` spans, nested as the calls are; `profiling.counts()` reads
every module-level launch and sync counter of the port. On the card
(marked `cuda`; imports no JAX) the kernel route opens the wrappers'
spans, the sky pass's where there is an HDRI, and the profiler makes no
device row of a span:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py -q
"""

import ast
import pathlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import halogen_tpu_torch as ht
from halogen_tpu_torch.diff import grad
from halogen_tpu_torch.scene import cornell
from halogen_tpu_torch.scene.envmap import Envmap
from halogen_tpu_torch.utils import profiling

PKG = pathlib.Path(ht.__file__).parent
ACTS = [torch.profiler.ProfilerActivity.CPU]
FIT_SPANS = ("halogen.loop.step", "halogen.loop.forward",
             "halogen.loop.backward", "halogen.loop.adam",
             "halogen.loop.project", "halogen.loop.sync")


class _Ops(TorchDispatchMode):
    """Names every operator dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _halogen_parents(evt) -> list:
    """The `halogen.*` spans enclosing `evt`, innermost first."""
    out, p = [], evt.cpu_parent
    while p is not None:
        if p.name.startswith("halogen."):
            out.append(p.name)
        p = p.cpu_parent
    return out


def _named(prof, name) -> list:
    return [e for e in prof.events() if e.name == name]


def _tiny(dev, **kw):
    scene = cornell.cornell_box().build(device=dev, **kw)
    cam = ht.make_camera(position=(0, 0, 3.2), target=(0, 0, 0),
                         fov_deg=40, device=dev)
    return scene, cam


def test_annotate_is_one_empty_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    with _Ops() as seen:
        a = profiling.annotate("halogen.driver.step", 3)
        b = profiling.annotate("halogen.loop.sync")
        with a, b:
            pass
    assert a is b
    assert seen.ops == []
    with torch.profiler.profile(activities=ACTS):
        assert profiling.annotate("halogen.driver.step") is not a


def test_renderer_step_opens_the_driver_spans():
    scene, cam = _tiny("cpu")
    st = ht.RenderSettings(width=8, height=8, samples_per_pixel=2,
                           max_bounces=1, max_accumulated_frames=4)
    r = ht.Renderer(scene, cam, st)
    r.step()
    with torch.profiler.profile(activities=ACTS, record_shapes=True) as prof:
        r.step()
        r.step()
    steps = _named(prof, "halogen.driver.step")
    assert [e.concrete_inputs for e in steps] == [[2], [3]]
    lock = _named(prof, "halogen.wrap.lockstep")
    assert len(lock) == 2
    for e in lock:
        assert _halogen_parents(e) == ["halogen.driver.pixels",
                                       "halogen.driver.chunks",
                                       "halogen.driver.step"]
    for name in ("halogen.driver.unpermute", "halogen.driver.blend",
                 "halogen.driver.readback"):
        got = _named(prof, name)
        assert len(got) == 2, name
        assert all(_halogen_parents(e)[-1] == "halogen.driver.step"
                   for e in got), name


def test_fit_step_opens_the_loop_spans(tmp_path, monkeypatch):
    scene, cam = _tiny("cpu")
    st = ht.RenderSettings(width=8, height=8, samples_per_pixel=1,
                           max_bounces=1)
    target = torch.full((8, 8, 3), 0.3)
    save = grad.save_fit_state

    def checkpoint(*args):
        with profiling.annotate("test.checkpoint"):
            save(*args)

    def callback(i, params, loss):
        with profiling.annotate("test.callback"):
            pass

    monkeypatch.setattr(grad, "save_fit_state", checkpoint)
    with torch.profiler.profile(activities=ACTS, record_shapes=True) as prof:
        grad.fit_materials(scene, cam, st, target, steps=2, callback=callback,
                           checkpoint_path=str(tmp_path / "fit.npz"),
                           checkpoint_every=1)
    steps = _named(prof, "halogen.loop.step")
    assert [e.concrete_inputs for e in steps] == [[0], [1]]
    for name in FIT_SPANS[1:]:
        got = _named(prof, name)
        assert len(got) == 2, name
        assert all(_halogen_parents(e) == ["halogen.loop.step"]
                   for e in got), name
    assert _halogen_parents(_named(prof, "halogen.wrap.lockstep")[0])[-1] \
        == "halogen.loop.step"
    for name, n in (("test.callback", 2), ("test.checkpoint", 3)):
        got = _named(prof, name)
        assert len(got) == n, name
        assert all(_halogen_parents(e) == [] for e in got), name


def _module_counters() -> set:
    """(module, global) of every module-level `*LAUNCHES`, `*SYNCS`,
    `*NODES`, `*GROUPS` and `*BUILDS` integer of the port's sources."""
    found = set()
    for path in PKG.rglob("*.py"):
        mod = ".".join(path.relative_to(PKG.parent).with_suffix("").parts)
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Constant) and \
                    isinstance(node.value.value, int):
                for t in node.targets:
                    if isinstance(t, ast.Name) and \
                            t.id.endswith(("LAUNCHES", "SYNCS", "NODES",
                                           "GROUPS", "BUILDS")):
                        found.add((mod, t.id))
    return found


def test_counts_names_every_counter():
    found = _module_counters()
    assert len(found) >= 10
    assert set(profiling.COUNTERS.values()) == found
    got = profiling.counts()
    assert set(got) == set(profiling.COUNTERS)
    assert all(isinstance(v, int) for v in got.values())


def _sky_outputs(n: int, dev) -> torch.Tensor:
    """[n, 10] megakernel outputs of paths that all reached the sky, their
    directions spread over the sphere, the roughness mid-range."""
    gen = torch.Generator().manual_seed(5)
    out = torch.zeros((n, 10))
    out[:, 0:3] = torch.rand((n, 3), generator=gen)
    out[:, 3:6] = 1.0
    out[:, 6] = 0.3
    d = torch.randn((n, 3), generator=gen)
    out[:, 7:10] = d / d.norm(dim=1, keepdim=True)
    return out.to(dev)


def test_the_atlas_span_nests_in_the_sky_pass():
    from halogen_tpu_torch.kernels import sky

    scene, _ = _tiny("cpu", envmap=Envmap.gradient_sky())
    st = ht.RenderSettings(use_envmap=True)
    out = _sky_outputs(64, "cpu")
    before = profiling.counts()["sky.atlas_builds"]
    with torch.profiler.profile(activities=ACTS) as prof:
        sky.SkyPass.apply(scene, st, out, *scene.env_mips)
    assert profiling.counts()["sky.atlas_builds"] - before == 1
    got = _named(prof, "halogen.wrap.sky_atlas")
    assert [_halogen_parents(e) for e in got] == [["halogen.wrap.sky"]]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("sky", [False, True, "env NEE"])
def test_kernel_route_opens_the_wrapper_spans(sky, cuda_device):
    """One fit step through the megakernel's record route, four launch
    groups: the wrappers' spans, a forward and a backward (on autograd's
    device thread) a node: without a sky, and under an HDRI at the miss
    (the sky pass inside the node's pair), one chunk node for the four
    groups; with env NEE a node a group and the sky pass's pair."""
    kw = dict(envmap=Envmap.gradient_sky()) if sky else {}
    scene, cam = _tiny(cuda_device, **kw)
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=4,
                           max_bounces=2, use_envmap=bool(sky),
                           env_importance_sampling=sky == "env NEE",
                           ray_chunk_size=1024)
    target = torch.full((32, 32, 3), 0.3, device=cuda_device)
    grad.fit_materials(scene, cam, st, target, steps=1)  # builds, warms
    before = profiling.counts()
    acts = ACTS + [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        grad.fit_materials(scene, cam, st, target, steps=1)
        torch.cuda.synchronize()
    after = profiling.counts()
    delta = {k: after[k] - before[k] for k in after}
    launches = delta["megakernel.launches"]
    assert launches == 4
    calls = delta["megakernel.chunk_nodes"]
    per_group = sky == "env NEE"
    assert (calls, delta["megakernel.chunk_groups"]) == ((0, 0) if per_group
                                                         else (1, 4))
    nodes = launches if per_group else calls
    assert len(_named(prof, "halogen.wrap.prepare")) > 0
    assert len(_named(prof, "halogen.wrap.forward")) == nodes
    back = _named(prof, "halogen.wrap.backward")
    assert len(back) == nodes
    assert {e.thread for e in back} != \
        {e.thread for e in _named(prof, "halogen.loop.step")}
    n_pass = launches if per_group else 0
    assert len(_named(prof, "halogen.wrap.sky")) == n_pass
    assert len(_named(prof, "halogen.wrap.sky_backward")) == n_pass
    for kind in ("forward", "backward"):
        name = f"sky.{kind}_launches"
        assert after[name] - before[name] == (launches if sky else 0)
    assert not any(e.name.startswith("halogen.") for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)


@pytest.mark.cuda
def test_atlas_builds_one_a_sky_pass_and_one_a_chunk(cuda_device):
    """On the card a `SkyPass` forward and backward copy the mips into one
    atlas (the forward's, kept for the backward); a frame under the sky
    one a chunk node (`_FusedChunk`), its span inside the node's forward;
    a fit step of the sky too, one a chunk node for its forward and
    backward, its span inside the node's forward."""
    from halogen_tpu_torch.kernels import sky

    scene, cam = _tiny(cuda_device, envmap=Envmap.gradient_sky())
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=4,
                           max_bounces=2, use_envmap=True,
                           ray_chunk_size=512)
    out = _sky_outputs(1024, cuda_device).requires_grad_(True)
    mips = [m.detach().clone().requires_grad_(True) for m in scene.env_mips]
    sky.SkyPass.apply(scene, st, out, *mips)  # builds, warms
    before = profiling.counts()
    sky.SkyPass.apply(scene, st, out, *mips).sum().backward()
    torch.cuda.synchronize()
    after = profiling.counts()
    assert after["sky.atlas_builds"] - before["sky.atlas_builds"] == 1
    assert after["sky.backward_launches"] \
        - before["sky.backward_launches"] == 1

    acts = ACTS + [torch.profiler.ProfilerActivity.CUDA]
    ht.render_frame(scene, cam, st, 0)
    before = profiling.counts()
    with torch.profiler.profile(activities=acts) as prof:
        ht.render_frame(scene, cam, st, 1)
        torch.cuda.synchronize()
    after = profiling.counts()
    delta = {k: after[k] - before[k] for k in after}
    assert delta["megakernel.chunk_nodes"] == 2  # 1,024 pixels, 512 a chunk
    assert delta["sky.atlas_builds"] == delta["megakernel.chunk_nodes"]
    got = _named(prof, "halogen.wrap.sky_atlas")
    assert len(got) == 2
    assert all(_halogen_parents(e)[0] == "halogen.wrap.forward" for e in got)

    target = torch.full((32, 32, 3), 0.3, device=cuda_device)
    before = profiling.counts()
    with torch.profiler.profile(activities=acts) as prof:
        grad.fit_materials(scene, cam, st, target, steps=1, optimize_env=True)
        torch.cuda.synchronize()
    after = profiling.counts()
    delta = {k: after[k] - before[k] for k in after}
    assert delta["megakernel.launches"] == 8  # 2 chunks of 4 groups
    assert delta["megakernel.chunk_nodes"] == 2
    assert delta["sky.atlas_builds"] == delta["megakernel.chunk_nodes"]
    assert delta["sky.backward_launches"] == delta["megakernel.launches"]
    got = _named(prof, "halogen.wrap.sky_atlas")
    assert len(got) == 2
    assert all(_halogen_parents(e)[0] == "halogen.wrap.forward" for e in got)
    assert not any(e.name.startswith("halogen.") for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
