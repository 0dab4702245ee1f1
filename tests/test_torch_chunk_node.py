"""The chunk node (`megakernel._FusedChunk`): one wrapper call, and under
autograd one node, for all the launch groups of a chunk of pixels.

On the CPU: the rule that picks the chunk node or a node a group
(`megakernel.chunk_serves`), its two counters in `profiling.counts()`, and
the layout of a chunk's record (a leading group axis, each group's slice
contiguous, counted once with every group's bytes). On the card (marked
`cuda`; imports no JAX): the chunk node's image equals that of a node a
group bit for bit, its 'recorded' material gradients match theirs at the
adjoint tests' tolerance, the replay and 'rerecord' routes and gradients
through the sky still take a node a group, the counters read the groups
a call of the benchmark's frames and fit, and a fit step's peak memory
does not rise:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_chunk_node.py -q
"""

import contextlib

import numpy as np
import pytest
import torch

import halogen_tpu_torch as ht
from halogen_tpu_torch.diff import render_loss_grad
from halogen_tpu_torch.diff.grad import FLOAT_MATERIAL_FIELDS
from halogen_tpu_torch.integrator.trace import _spp_block
from halogen_tpu_torch.kernels import adjoint as adj
from halogen_tpu_torch.kernels import megakernel as mk
from halogen_tpu_torch.scene import cornell
from halogen_tpu_torch.scene.envmap import Envmap
from halogen_tpu_torch.utils import profiling

CAM = dict(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40)

# (route, gradient wanted, sky pass) -> the chunk node serves
RULE = {
    (None, False, False): True,
    (None, False, True): True,
    ("rays", False, True): True,
    ("recorded", True, False): True,
    ("recorded", True, True): False,
    ("rerecord", True, False): False,
    ("shared", True, False): False,
    ("global", True, False): False,
    ("shared", True, True): False,
}


@pytest.mark.parametrize("case", sorted(RULE, key=str), ids=str)
def test_chunk_serves_by_route_grad_and_sky(case):
    """Every chunk that wants no gradient, and a gradient's chunk on the
    'recorded' route without a sky pass; the replay routes, 'rerecord' and
    gradients through the sky keep a node a group."""
    assert mk.chunk_serves(*case) is RULE[case]


# the chunk node's counters: name -> (module, global)
CHUNK_COUNTERS = {
    "megakernel.chunk_nodes": (mk.__name__, "CHUNK_NODES"),
    "megakernel.chunk_groups": (mk.__name__, "CHUNK_GROUPS"),
    "megakernel.lane_sums": (mk.__name__, "LANE_SUM_LAUNCHES"),
    "adjoint.group_sums": (adj.__name__, "GROUP_SUM_LAUNCHES"),
}


@pytest.mark.parametrize("name", sorted(CHUNK_COUNTERS))
def test_chunk_counters_are_in_counts(name):
    """Registered in `profiling.COUNTERS`, read by `counts()`, and out of
    `portbench/layers.py`'s sum of `*launches` and `*calls` counters (the
    passes they count are counted there already, or are small kernels
    beside a counted one)."""
    module, attr = CHUNK_COUNTERS[name]
    assert profiling.COUNTERS[name] == CHUNK_COUNTERS[name]
    got = profiling.counts()[name]
    assert isinstance(got, int)
    assert got == getattr(adj if module == adj.__name__ else mk, attr)
    assert not name.endswith(("launches", "calls"))


def test_cpu_render_leaves_the_chunk_counters():
    """On the CPU `render_pixels` runs the lockstep: no chunk node."""
    scene = cornell.cornell_box().build(device="cpu")
    cam = ht.make_camera(**CAM, device="cpu")
    st = ht.RenderSettings(width=8, height=8, samples_per_pixel=4,
                           max_bounces=1, ray_chunk_size=64)
    before = profiling.counts()
    ht.render_frame(scene, cam, st, 1)
    after = profiling.counts()
    for name in CHUNK_COUNTERS:
        assert after[name] == before[name]


@pytest.mark.parametrize("env_nee,light_nee", [(False, False), (True, False),
                                               (False, True)])
def test_chunk_record_layout(env_nee, light_nee):
    """A chunk's record: each buffer [groups, ...] of a launch's shapes, a
    group's slice a contiguous `Record` that `check_record` takes, counted
    once in `live_record_bytes` with every group's bytes, and freed with
    it."""
    st = ht.RenderSettings(max_bounces=3)
    n, groups = 40, 5
    live0 = mk.live_record_bytes("cpu")
    rec = mk.empty_record(n, st, env_nee, "cpu", light_nee, groups)
    mk.check_record(rec, n, st, env_nee, torch.device("cpu"), light_nee,
                    groups)
    assert rec.n == n
    one = 4 * n * (1 + 4 * mk.record_words(env_nee, light_nee))
    assert mk.live_record_bytes("cpu") - live0 == groups * one
    assert sum(t.numel() * 4 for t in rec if t is not None) == groups * one
    for g in range(groups):
        part = mk.Record(*(None if t is None else t[g] for t in rec))
        mk.check_record(part, n, st, env_nee, torch.device("cpu"), light_nee)
        assert part.a.data_ptr() == rec.a.data_ptr() + g * part.a.nbytes
    with pytest.raises(ValueError, match="record a"):
        mk.check_record(rec, n, st, env_nee, torch.device("cpu"), light_nee)
    del rec, part
    assert mk.live_record_bytes("cpu") == live0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def _a_node_a_group():
    """Route every chunk through a `_FusedDiff` a group, as before the
    chunk node."""
    saved = mk.chunk_serves
    mk.chunk_serves = lambda *args: False
    try:
        yield
    finally:
        mk.chunk_serves = saved


def _chunk_counts():
    c = profiling.counts()
    return c["megakernel.chunk_nodes"], c["megakernel.chunk_groups"]


def _delta(before):
    return tuple(a - b for a, b in zip(_chunk_counts(), before))


def _scene(name, dev):
    from halogen_tpu_torch.scene import meshes

    sky = Envmap.gradient_sky()
    if name == "cornell":
        return cornell.cornell_box(glossy=True).build(device=dev), CAM
    if name == "glass":
        return cornell.glass_sphere_box().build(device=dev), CAM
    if name == "cornell_sky":
        return cornell.cornell_box(glossy=True).build(envmap=sky,
                                                      device=dev), CAM
    if name == "cornell_box":  # the diffuse box: a triangle light
        return cornell.cornell_box().build(device=dev), CAM
    dcam = dict(position=(0, 1.5, 5.0), target=(0, -0.3, 0), fov_deg=45)
    return meshes.glass_dragon_scene().build(envmap=sky, device=dev), dcam


# name: (scene, settings beyond 32x32 and the chunk size): every case has
# chunks of 4 or more groups
FRAME_CASES = {
    "B1a, 4 lanes a group": ("cornell", dict(samples_per_pixel=16,
                                             max_bounces=4,
                                             ray_chunk_size=4096)),
    "B1a, 1 lane, 2 chunks": ("cornell", dict(samples_per_pixel=4,
                                              max_bounces=4,
                                              ray_chunk_size=512)),
    "B1a, 8 lanes a group": ("cornell", dict(samples_per_pixel=32,
                                             max_bounces=4,
                                             ray_chunk_size=8192)),
    "B1a, 6 spp": ("cornell", dict(samples_per_pixel=6, max_bounces=4,
                                   ray_chunk_size=1024)),
    "B1b": ("glass", dict(samples_per_pixel=8, max_bounces=8,
                          max_transmission_bounces=8, ray_chunk_size=2048)),
    "B1c sky": ("cornell_sky", dict(samples_per_pixel=8, max_bounces=4,
                                    use_envmap=True, ray_chunk_size=2048)),
    "B1c env NEE": ("cornell_sky", dict(samples_per_pixel=8, max_bounces=4,
                                        use_envmap=True,
                                        env_importance_sampling=True,
                                        ray_chunk_size=2048)),
    "B1e": ("cornell_box", dict(samples_per_pixel=8, max_bounces=4,
                                light_importance_sampling=True,
                                ray_chunk_size=2048)),
    "B1b+c+d": ("glass_dragon", dict(samples_per_pixel=4, max_bounces=12,
                                     use_envmap=True, ray_chunk_size=1024)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_chunk_frame_equals_a_node_a_group(case, cuda_device):
    """A frame through the chunk node equals the same frame through a node
    a group bit for bit, and the counters read its chunks and groups."""
    name, kw = FRAME_CASES[case]
    scene, cam_kw = _scene(name, cuda_device)
    cam = ht.make_camera(**cam_kw, device=cuda_device)
    st = ht.RenderSettings(width=32, height=32, **kw)
    n_pix = min(st.ray_chunk_size, st.num_pixels)
    chunks = -(-st.num_pixels // n_pix)
    groups = st.samples_per_pixel // _spp_block(n_pix, st.samples_per_pixel,
                                                st.ray_chunk_size)
    assert groups >= 4
    before = _chunk_counts()
    launches = mk.LAUNCHES
    img = ht.render_frame(scene, cam, st, 3)
    assert _delta(before) == (chunks, chunks * groups)
    assert mk.LAUNCHES - launches == chunks * groups
    with _a_node_a_group():
        before = _chunk_counts()
        ref = ht.render_frame(scene, cam, st, 3)
        assert _delta(before) == (0, 0)
    assert torch.equal(img, ref)
    assert float(img.sum()) > 0


def assert_columns_close(got, ref):
    """The adjoint tests' tolerance: per column of the [K, 12] table,
    |got - ref| <= 1e-3 * max |ref column| + 1e-6."""
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert np.isfinite(got).all()
    bound = 1e-3 * np.abs(ref).max(axis=0) + 1e-6
    assert (np.abs(got - ref) <= bound).all(), np.abs(got - ref).max(axis=0)


# name: (scene, settings beyond 32x32, 16 spp, 8 groups a chunk)
GRAD_CASES = {
    "B2": ("cornell", dict(max_bounces=4)),
    "B2b": ("glass", dict(max_bounces=8, max_transmission_bounces=8)),
    "B2+l": ("cornell_box", dict(max_bounces=4,
                                 light_importance_sampling=True)),
    "B2b+d": ("glass_dragon", dict(max_bounces=12)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_chunk_gradients_match_a_node_a_group(case, cuda_device):
    """On the 'recorded' route one chunk node serves the 8 groups (8
    recording launches and 8 sweeps, as a node a group takes): the loss
    equals a node a group's bit for bit and the material gradients match
    theirs at the adjoint tests' tolerance; the records are freed."""
    name, kw = GRAD_CASES[case]
    scene, cam_kw = _scene(name, cuda_device)
    cam = ht.make_camera(**cam_kw, device=cuda_device)
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=16,
                           ray_chunk_size=2048, **kw)
    target = torch.full((32, 32, 3), 0.25, device=cuda_device)
    params = {"materials": scene.materials}
    assert adj.record_plan(scene, st, 2048, 8) == "recorded"
    counts = lambda: (mk.RECORD_LAUNCHES, adj.SWEEP_LAUNCHES, adj.LAUNCHES)
    live0 = mk.live_record_bytes(cuda_device)
    before, c0 = counts(), _chunk_counts()
    loss, grads = render_loss_grad(params, scene, cam, st, target, 2)
    assert tuple(a - b for a, b in zip(counts(), before)) == (8, 8, 0)
    assert _delta(c0) == (1, 8)
    assert mk.live_record_bytes(cuda_device) == live0
    with _a_node_a_group():
        before = counts()
        loss_ref, grads_ref = render_loss_grad(params, scene, cam, st,
                                               target, 2)
        assert tuple(a - b for a, b in zip(counts(), before)) == (8, 8, 0)
    assert torch.equal(loss, loss_ref)
    for f in FLOAT_MATERIAL_FIELDS:
        g, ref = getattr(grads["materials"], f), getattr(
            grads_ref["materials"], f)
        assert torch.isfinite(g).all(), f
        assert_columns_close(g.reshape(g.shape[0], -1),
                             ref.reshape(ref.shape[0], -1))
    assert float(grads["materials"].albedo.abs().sum()) > 0


@pytest.mark.cuda
def test_other_routes_keep_a_node_a_group(cuda_device):
    """The replay (RECORD_BUDGET = 0), 'rerecord' (light NEE with one
    launch's record in the budget) and a gradient through the sky pass
    take a node a group: the chunk counters do not move."""
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=8,
                           max_bounces=4, ray_chunk_size=2048)
    target = torch.zeros((32, 32, 3), device=cuda_device)
    cam = ht.make_camera(**CAM, device=cuda_device)
    saved = adj.RECORD_BUDGET
    try:
        scene = cornell.cornell_box(glossy=True).build(device=cuda_device)
        adj.RECORD_BUDGET = 0
        before, rep = _chunk_counts(), adj.LAUNCHES
        render_loss_grad({"materials": scene.materials}, scene, cam, st,
                         target, 1)
        assert _delta(before) == (0, 0) and adj.LAUNCHES - rep == 4
        scene = cornell.cornell_box().build(device=cuda_device)
        st_l = st.replace(light_importance_sampling=True)
        adj.RECORD_BUDGET = (mk.live_record_bytes(cuda_device)
                             + adj.record_bytes(scene, st_l, 2048))
        assert adj.record_plan(scene, st_l, 2048, 4) == "rerecord"
        before, rec = _chunk_counts(), mk.RECORD_LAUNCHES
        render_loss_grad({"materials": scene.materials}, scene, cam, st_l,
                         target, 1)
        assert _delta(before) == (0, 0) and mk.RECORD_LAUNCHES - rec == 4
    finally:
        adj.RECORD_BUDGET = saved
    scene = cornell.cornell_box(glossy=True).build(
        envmap=Envmap.gradient_sky(), device=cuda_device)
    st_s = st.replace(use_envmap=True)
    before, sky_b = _chunk_counts(), profiling.counts()["sky.backward_launches"]
    render_loss_grad({"materials": scene.materials,
                      "env_mips": scene.env_mips}, scene, cam, st_s, target,
                     1)
    assert _delta(before) == (0, 0)
    assert profiling.counts()["sky.backward_launches"] - sky_b == 4


def _benchmark_step(dev, fit):
    """The Cornell cells' settings (portbench/configs/cornell_glossy.json):
    a 512², 32-spp frame, or a 256², 256-spp fit step."""
    scene = cornell.cornell_box(glossy=True).build(device=dev)
    cam = ht.make_camera(**CAM, device=dev)
    size, spp = (256, 256) if fit else (512, 32)
    st = ht.RenderSettings(width=size, height=size, samples_per_pixel=spp,
                           max_bounces=6, max_diffuse_bounces=4,
                           max_glossy_bounces=4, ray_chunk_size=262144)
    target = torch.full((size, size, 3), 0.25, device=dev)
    if fit:
        return lambda: render_loss_grad({"materials": scene.materials},
                                        scene, cam, st, target, 1)
    return lambda: ht.render_frame(scene, cam, st, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("fit,groups", [(False, 32), (True, 64)],
                         ids=["frame", "fit"])
def test_counters_read_the_groups_a_call(fit, groups, cuda_device):
    """A Cornell frame at the benchmark's size takes one chunk node of 32
    groups, a fit step one of 64, with a `lane_sum` a group and, in the
    fit, one `sum_groups`; a fit step's peak device memory is no higher
    than through a node a group."""
    step = _benchmark_step(cuda_device, fit)
    step()  # builds, warms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    before, c0 = _chunk_counts(), profiling.counts()
    step()
    torch.cuda.synchronize()
    assert _delta(before) == (1, groups)
    c1 = profiling.counts()
    assert (c1["megakernel.lane_sums"] - c0["megakernel.lane_sums"],
            c1["adjoint.group_sums"] - c0["adjoint.group_sums"]) == (
                groups, int(fit))
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    with _a_node_a_group():
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda_device)
        base = torch.cuda.memory_allocated(cuda_device)
        step()
        torch.cuda.synchronize()
        peak_ref = torch.cuda.max_memory_allocated(cuda_device) - base
    if fit:
        assert peak <= peak_ref, (peak, peak_ref)


@pytest.mark.cuda
def test_a_testing_frame_chunk_serves_one_group(cuda_device):
    """The Testing Scene's viewer (1 spp a frame, 262,144-ray chunks under
    the sky) has chunks of one group: a chunk node each."""
    scene, cam_kw = _scene("glass_dragon", cuda_device)
    cam = ht.make_camera(**cam_kw, device=cuda_device)
    st = ht.RenderSettings(width=64, height=64, samples_per_pixel=1,
                           max_bounces=12, use_envmap=True,
                           ray_chunk_size=1024)
    before = _chunk_counts()
    img = ht.render_frame(scene, cam, st, 5)
    assert _delta(before) == (4, 4)
    with _a_node_a_group():
        assert torch.equal(img, ht.render_frame(scene, cam, st, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [10, 12, 3])
@pytest.mark.parametrize("spp_block", [1, 4, 8])
def test_lane_sum_equals_the_plain_sum(stride, spp_block, cuda_device):
    """`lane_sum` (through `halogen_lane_sum`) adds each pixel's lanes of
    columns 0-2 of rows of `stride` floats into the accumulator bit for
    bit as `acc + col.reshape(n, spp_block, 3).sum(dim=1)` does: rows of
    the brute tier's outputs, env NEE's and the sky pass's colour."""
    gen = torch.Generator(device=cuda_device).manual_seed(
        10 * stride + spp_block)
    n_pix = 4099
    # magnitudes over many octaves, so that another order shows in the bits
    src = (torch.rand((n_pix * spp_block, stride), generator=gen,
                      device=cuda_device)
           * torch.exp(torch.randn((n_pix * spp_block, 1), generator=gen,
                                   device=cuda_device) * 4))
    acc = torch.rand((n_pix, 3), generator=gen, device=cuda_device)
    ref = acc + src[:, 0:3].reshape(n_pix, spp_block, 3).sum(dim=1)
    err = mk.load_library("megakernel").halogen_lane_sum(
        src.data_ptr(), acc.data_ptr(), stride, n_pix, spp_block,
        torch.cuda.current_stream(cuda_device).cuda_stream)
    assert err == 0
    assert torch.equal(acc, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["B2", "B2+l"])
def test_sweep_chunk_equals_each_groups_sweep(case, cuda_device):
    """`adjoint.sweep_chunk` over a chunk node's record (8 groups) equals
    each group's `_sweep` over its slice of the record, summed newest
    first as autograd adds them, bit for bit."""
    from halogen_tpu_torch.integrator.trace import _spp_block

    name, kw = GRAD_CASES[case]
    scene, cam_kw = _scene(name, cuda_device)
    cam = ht.make_camera(**cam_kw, device=cuda_device)
    st = ht.RenderSettings(width=32, height=32, samples_per_pixel=16,
                           ray_chunk_size=2048, **kw)
    pix = torch.arange(st.num_pixels, device=cuda_device)
    spp = st.samples_per_pixel
    sb = _spp_block(pix.shape[0], spp, st.ray_chunk_size)
    groups = spp // sb
    assert groups == 8
    tables = list(mk._scene_tables(scene))
    tables[3] = tables[3].detach().requires_grad_()
    img = mk.trace_color_chunk(scene, mk.pixel_view(cam, st, 2, pix), 0, sb,
                               groups, spp, st, tables, None, None,
                               "recorded")
    node = img.grad_fn  # the chunk node's context holds its record
    mat_tab, *saved = node.saved_tensors
    it = iter(saved)
    rec = mk.Record(*(next(it) if f else None for f in node.record_fields))
    mat_tab = mat_tab.detach()
    ct = torch.randn((rec.n, 3), generator=torch.Generator(
        device=cuda_device).manual_seed(7), device=cuda_device)
    got = adj.sweep_chunk(scene, rec, ct, st, mat_tab, groups)
    parts = [adj._sweep(scene, mk.Record(*(None if t is None else t[g]
                                           for t in rec)),
                        ct, st, (*tables[:3], mat_tab), None, None)
             for g in range(groups)]
    ref = parts[-1]
    for p in reversed(parts[:-1]):
        ref = ref + p
    assert torch.equal(got, ref)
    assert float(got.abs().sum()) > 0
