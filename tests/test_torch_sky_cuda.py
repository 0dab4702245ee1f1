"""The sky pair's CUDA kernels (`csrc/sky.cu`) vs their plain PyTorch
versions on the card: the forward against `deferred_sky`, the backward
against torch autograd of it, and the backward's bits across two calls;
the backward's ordering against `torch.sort(stable=True)` (the same
permutation, bit for bit) and its sums against `index_add_` in float64
and against `reduce_texels_model` (the same bits), at the gradient sky's
atlas (10,920 texels), a 512 x 1024 map's (698,880), a one-mip map's, and
with no tap or none that reached the sky; the sums' add mode bit for bit
the buffer + the fresh sums.

Needs an NVIDIA GPU with nvcc; skips without one. Imports no JAX:

    python -m pytest --noconftest tests/test_torch_sky_cuda.py -q

Tolerances: the color at atol = rtol = 1e-4 per ray with at most 0.1% of
rays outside (the kernel's atan2, acos and divisions may round an ulp
apart from torch's, and a texel edge may then fall the other way); the
cotangents of the miss attenuation and roughness at 1e-4 of their
column's largest + 1e-6; each mip's cotangent at 1e-4 of the mip's
largest + 1e-6 (the same taps summed in another order than autograd's
scatter).
"""

import dataclasses

import numpy as np
import pytest
import torch

import halogen_tpu_torch as ht
from halogen_tpu_torch.integrator.trace import deferred_sky, group_rays
from halogen_tpu_torch.kernels import megakernel as mk
from halogen_tpu_torch.kernels import sky
from halogen_tpu_torch.scene import cornell
from halogen_tpu_torch.scene.envmap import Envmap

CAM = dict(position=(0, 0, 3.2), target=(0, 0, 0), fov_deg=40)
CASES = {
    "bias": dict(),
    "no_bias": dict(mip_importance_bias=False),
    "nee": dict(env_importance_sampling=True, env_mip_level=0),
    "one_mip": dict(),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _case(name, dev):
    env = Envmap.gradient_sky()
    if name == "one_mip":
        env = Envmap(env.mips[:1])
    scene = cornell.cornell_box(glossy=True).build(envmap=env, device=dev)
    st = ht.RenderSettings(width=32, height=32, max_bounces=4,
                           use_envmap=True, **CASES[name])
    cam = ht.make_camera(**CAM, device=dev)
    o, d, s, e = group_rays(cam, st, 1, torch.arange(st.num_pixels,
                                                     device=dev), 0, 4)
    out = mk.trace_fused_outputs(scene, o, d, cam.far, s, e, st)
    ct = torch.rand((o.shape[0], 3),
                    generator=torch.Generator().manual_seed(0)).to(dev)
    return scene, st, out, ct


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_sky_forward_matches_deferred_sky(name, cuda_device):
    scene, st, out, _ = _case(name, cuda_device)
    before = sky.FORWARD_LAUNCHES
    got = sky.sky_forward(scene, st, out)
    ref = deferred_sky(scene, st, out)
    torch.cuda.synchronize()
    assert sky.FORWARD_LAUNCHES == before + 1
    bad = ((got - ref).abs() > 1e-4 + 1e-4 * ref.abs()).any(dim=1)
    assert torch.isfinite(got).all()
    assert int(bad.sum()) <= 1e-3 * out.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_sky_backward_matches_autograd_and_repeats(name, cuda_device):
    scene, st, out, ct = _case(name, cuda_device)
    d4, env = sky.sky_backward_full(scene, st, out, ct)
    d4b, env_b = sky.sky_backward_full(scene, st, out, ct)
    ref4, ref_env = sky.sky_backward_reference(scene, st, out, ct)
    torch.cuda.synchronize()
    assert torch.equal(d4, d4b)
    bound = 1e-4 * ref4.abs().max(dim=0).values + 1e-6
    assert ((d4 - ref4).abs() <= bound).float().mean() >= 0.999
    assert len(env) == len(ref_env) == len(scene.env_mips)
    # the taps kernel's first-pass counts give the standalone ordering's bits
    _, keys, wts = sky.sky_backward(scene, st, out, ct)
    direct = sky.split_mips(sky.scatter_texels(
        keys, wts, sum(m.numel() // 3 for m in scene.env_mips)),
        scene.env_mips)
    for g, g2, g3, r in zip(env, env_b, direct, ref_env):
        assert torch.equal(g, g2) and torch.equal(g, g3)
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max()) + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_sky_backward_without_taps_gives_the_same_d_out(name, cuda_device):
    """Where no mip wants a cotangent the backward kernel writes no taps;
    the cotangents of the miss attenuation and roughness keep their bits."""
    scene, st, out, ct = _case(name, cuda_device)
    d4, keys, wts = sky.sky_backward(scene, st, out, ct)
    d4_only, no_keys, no_wts = sky.sky_backward(scene, st, out, ct,
                                                taps=False)
    torch.cuda.synchronize()
    assert keys is not None and no_keys is None and no_wts is None
    assert torch.equal(d4, d4_only)


@pytest.mark.cuda
def test_scatter_texels_sums_in_a_fixed_order(cuda_device):
    """The per-texel sum kernel against index_add_ in float64, on many
    taps of few texels (the coarse mips' case), bitwise equal over two
    calls."""
    g = torch.Generator().manual_seed(5)
    keys = torch.randint(-1, 7, (200003,), generator=g, dtype=torch.int32)
    wts = torch.randn((200003, 3), generator=g)
    got = sky.scatter_texels(keys.to(cuda_device), wts.to(cuda_device), 7)
    again = sky.scatter_texels(keys.to(cuda_device), wts.to(cuda_device), 7)
    keep = keys >= 0
    ref = torch.zeros((7, 3), dtype=torch.float64).index_add_(
        0, keys[keep].long(), wts[keep].double())
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n_texels", [7, 10920, 698880])
def test_scatter_texels_adds_into_a_buffer(n_texels, cuda_device):
    """The sums' add mode (`scatter_texels(..., out=)`, the chunk node's
    groups summed into one gradient): into a non-zero buffer it gives the
    buffer + the fresh sums bit for bit, and leaves the texels without a
    tap as they were; twice in a row, the first result + the sums again."""
    g = torch.Generator().manual_seed(n_texels)
    m = 200003
    keys = torch.randint(-1, max(n_texels // 2, 2), (m,), generator=g,
                         dtype=torch.int32).to(cuda_device)
    wts = (torch.randn((m, 3), generator=g)
           * torch.exp(torch.randn((m, 1), generator=g) * 4)).to(cuda_device)
    buf = torch.randn((n_texels, 3), generator=g).to(cuda_device)
    fresh = sky.scatter_texels(keys, wts, n_texels)
    out = buf.clone()
    got = sky.scatter_texels(keys, wts, n_texels, out=out)
    torch.cuda.synchronize()
    assert got is out
    assert torch.equal(got, buf + fresh)
    hit = torch.zeros((n_texels,), dtype=torch.bool, device=cuda_device)
    hit[keys[keys >= 0].long()] = True
    assert (~hit).any() and torch.equal(got[~hit], buf[~hit])
    twice = sky.scatter_texels(keys, wts, n_texels, out=got.clone())
    assert torch.equal(twice, (buf + fresh) + fresh)


def _big_envmap():
    """`Envmap.from_equirect` of a seeded random 512 x 1024 image, 6 mips:
    698,880 texels, 20 key bits."""
    rng = np.random.default_rng(7)
    img = rng.uniform(0.0, 2.0, (512, 1024, 3)).astype(np.float32)
    return Envmap.from_equirect(img, num_mips=6)


def _atlas_taps(name, dev, n=65536):
    """(keys, weights, n_texels) of the sky backward's taps on n rays of
    random directions and mip levels (every 16th never reached the sky)
    under the gradient sky, the 512 x 1024 map, or the gradient sky's
    finest mip alone."""
    env = {"gradient": Envmap.gradient_sky(), "big": None,
           "one_mip": Envmap(Envmap.gradient_sky().mips[:1])}[name]
    env = _big_envmap() if env is None else env
    scene = cornell.cornell_box(glossy=True).build(envmap=env, device=dev)
    st = ht.RenderSettings(use_envmap=True, env_mip_level=0,
                           mip_importance_range=8.0)
    rng = np.random.default_rng(11)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    out = np.zeros((n, 10), np.float32)
    out[:, 3:6] = 1.0
    out[::16, 3:6] = 0.0
    out[:, 6] = rng.uniform(-0.1, 0.8, n)
    out[:, 7:10] = d / np.linalg.norm(d, axis=1, keepdims=True)
    out = torch.from_numpy(out).to(dev)
    ct = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    _, keys, wts = sky.sky_backward(scene, st, out, ct)
    n_texels = sum(int(m.shape[0] * m.shape[1]) for m in scene.env_mips)
    return keys, wts, n_texels, scene


def _check_scatter(keys, wts, n_texels, mips):
    """The ordering equals torch.sort's permutation on the keys >= 0; the
    sums equal index_add_ in float64 within 1e-4 of each mip's largest +
    1e-6, and reduce_texels_model on the ordering bit for bit; two calls
    give the same bits."""
    ordered, idx = sky.order_texels(keys, n_texels)
    ref_k, ref_perm = torch.sort(keys, stable=True)
    keep = ref_k >= 0
    assert torch.equal(ordered, ref_k[keep])
    assert torch.equal(idx.long(), ref_perm[keep])
    before = (sky.ORDER_LAUNCHES, sky.SCATTER_LAUNCHES)
    got = sky.scatter_texels(keys, wts, n_texels)
    again = sky.scatter_texels(keys, wts, n_texels)
    assert (sky.ORDER_LAUNCHES, sky.SCATTER_LAUNCHES) == (
        before[0] + (2 if keys.numel() else 0),
        before[1] + (2 if keys.numel() else 0))
    model = sky.reduce_texels_model(ordered, wts[idx.long()], n_texels)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, model)
    ref = torch.zeros((n_texels, 3), dtype=torch.float64,
                      device=keys.device).index_add_(
        0, keys[keys >= 0].long(), wts[keys >= 0].double())
    for g, r in zip(sky.split_mips(got, mips), sky.split_mips(ref, mips)):
        err = float((g.double() - r).abs().max())
        assert err <= 1e-4 * float(r.abs().max()) + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gradient", "big", "one_mip"])
def test_ordering_and_sums_at_the_atlases(name, cuda_device):
    keys, wts, n_texels, scene = _atlas_taps(name, cuda_device)
    if name == "one_mip":
        assert (keys.view(-1, sky.TAPS)[:, 4:] == -1).all()
    _check_scatter(keys, wts, n_texels, scene.env_mips)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["no_taps", "none_reached", "one_texel"])
def test_ordering_and_sums_edge_cases(case, cuda_device):
    """m = 0; every key -1 (no ray reached the sky); one texel that takes
    every tap of 300,007 (runs across hundreds of tiles and two carry
    levels)."""
    mips = Envmap.gradient_sky().mips
    n_texels = sum(m.shape[0] * m.shape[1] for m in mips)
    m = {"no_taps": 0, "none_reached": 100003, "one_texel": 300007}[case]
    g = torch.Generator().manual_seed(9)
    wts = torch.randn((m, 3), generator=g).to(cuda_device)
    keys = torch.full((m,), {"none_reached": -1}.get(case, 10919),
                      dtype=torch.int32, device=cuda_device)
    shapes = [torch.empty(mp.shape) for mp in mips]
    _check_scatter(keys, wts, n_texels, shapes)
    if case != "one_texel":
        assert not sky.scatter_texels(keys, wts, n_texels).any()
