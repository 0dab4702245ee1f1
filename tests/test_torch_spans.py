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
    `*NODES` and `*GROUPS` integer of the port's sources."""
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
                                           "GROUPS")):
                        found.add((mod, t.id))
    return found


def test_counts_names_every_counter():
    found = _module_counters()
    assert len(found) >= 10
    assert set(profiling.COUNTERS.values()) == found
    got = profiling.counts()
    assert set(got) == set(profiling.COUNTERS)
    assert all(isinstance(v, int) for v in got.values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("sky", [False, True])
def test_kernel_route_opens_the_wrapper_spans(sky, cuda_device):
    """One fit step through the megakernel's record route, four launch
    groups: the wrappers' spans, a forward and a backward (on autograd's
    device thread) a node: without a sky one chunk node for the four
    groups, under an HDRI a node a group and the sky pass's pair."""
    kw = dict(envmap=Envmap.gradient_sky()) if sky else {}
    scene, cam = _tiny(cuda_device, **kw)
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=4,
                           max_bounces=2, use_envmap=sky,
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
    assert (calls, delta["megakernel.chunk_groups"]) == ((0, 0) if sky
                                                         else (1, 4))
    nodes = launches if sky else calls
    assert len(_named(prof, "halogen.wrap.prepare")) > 0
    assert len(_named(prof, "halogen.wrap.forward")) == nodes
    back = _named(prof, "halogen.wrap.backward")
    assert len(back) == nodes
    assert {e.thread for e in back} != \
        {e.thread for e in _named(prof, "halogen.loop.step")}
    n_sky = 0 if not sky else launches
    assert len(_named(prof, "halogen.wrap.sky")) == n_sky
    assert len(_named(prof, "halogen.wrap.sky_backward")) == n_sky
    assert after["sky.forward_launches"] - before["sky.forward_launches"] \
        == n_sky
    assert not any(e.name.startswith("halogen.") for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
