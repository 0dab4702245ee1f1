"""The sky pair's CUDA kernels (`csrc/sky.cu`) vs their plain PyTorch
versions on the card: the forward against `deferred_sky`, the backward
against torch autograd of it, and the backward's bits across two calls.

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
    for g, g2, r in zip(env, env_b, ref_env):
        assert torch.equal(g, g2)
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
