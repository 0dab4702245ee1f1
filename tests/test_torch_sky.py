"""The sky pass's backward (`kernels/sky.py`) on the CPU: the plain version
of the backward kernel, tap for tap, against the JAX package's
`sample_env_packed` vjp, per mip; and the env-NEE draw's texel, whose
radiance's cotangent the adjoint records, against the JAX draw.

`sky_taps_reference` gives each ray's eight taps (texel of the atlas of
all mips, share of the cotangent) as the CUDA kernel computes them, and
`scatter_texels` sums them per texel; the sums must equal `jax.vjp` of
the trilinear lookup at rtol 1e-5 and an atol of 1e-5 of the sum of the
magnitudes of the texel's taps + 1e-6 of the mip's largest + 1e-6: the
same taps, of both signs, summed in another order (XLA's scatter-add,
torch's index_add), and where a direction's (u, v) lands an ulp from a
texel edge the other package's floor may give the tap's ~0 weight to
the neighbouring texel. The kernels themselves are held to these plain versions
on the card (`tests/test_torch_sky_cuda.py`, `chip_smoke.py`).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from halogen_tpu.scene import envmap as jenv
from halogen_tpu_torch.config import RenderSettings
from halogen_tpu_torch.kernels import sky
from halogen_tpu_torch.scene import envmap as tenv
from halogen_tpu_torch.scene import cornell
from halogen_tpu_torch.utils import profiling

ATOL, RTOL = 1e-6, 1e-5
N = 512


def _maps():
    """A gradient sky (6 mips, 64 x 128 finest) and a random map with odd
    mip sizes (5 mips, 24 x 40 finest), from numpy seeds."""
    rng = np.random.default_rng(3)
    rand = rng.uniform(0.0, 2.0, (24, 40, 3)).astype(np.float32)
    return {"gradient": jenv.Envmap.gradient_sky().mips,
            "random": jenv.Envmap.from_equirect(rand, num_mips=5).mips}


def _rays(seed, n_mips):
    """Directions over the sphere (some at the poles and the seam), levels
    over [-1, n_mips] (both clamps) and a cotangent."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[:8] = [[0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1], [1e-4, 1, 0],
             [0, -1, 1e-4], [1e-6, 0, 1], [-1e-6, 0, 1]]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    level = rng.uniform(-1.0, n_mips, N).astype(np.float32)
    ct = rng.normal(size=(N, 3)).astype(np.float32)
    return d, level, ct


def _outputs(d, level, rng):
    """[N, 10] outputs whose lookup is at (d, level): miss attenuation 1
    (0 on every 16th ray: it never reached the sky), roughness level / 8
    (the mip bias from level 0 at range 8), a path color."""
    n = d.shape[0]
    out = np.zeros((n, 10), np.float32)
    out[:, 0:3] = rng.uniform(0, 1, (n, 3))
    out[:, 3:6] = 1.0
    out[::16, 3:6] = 0.0
    out[:, 6] = level / 8.0
    out[:, 7:10] = d
    return torch.from_numpy(out)


def _scene(mips):
    return dataclasses.replace(
        cornell.cornell_box().build(device="cpu"),
        env_mips=tuple(torch.from_numpy(m) for m in mips))


def _assert_sums_close(got, ref, mag, msg):
    """Per texel |got - ref| <= 1e-5 * |ref| + 1e-5 * sum |taps| + 1e-6 *
    max |ref| + 1e-6."""
    bound = (RTOL * np.abs(ref) + 1e-5 * mag.numpy()
             + ATOL * np.abs(ref).max() + ATOL)
    diff = np.abs(got.numpy() - ref)
    assert (diff <= bound).all(), (msg, float((diff / bound).max()))


ST = RenderSettings(use_envmap=True, env_mip_level=0, mip_importance_range=8.0)


@pytest.mark.parametrize("name", ["gradient", "random"])
def test_plain_taps_match_jax_vjp_per_mip(name):
    """The plain backward's per-texel sums equal jax.vjp of
    sample_env_packed with respect to every mip, and its cotangent of the
    roughness equals the vjp's with respect to the level times the range
    (0 where the level is clamped)."""
    mips = _maps()[name]
    d, level, ct = _rays(0, len(mips))
    rng = np.random.default_rng(1)
    outputs = _outputs(d, level, rng)
    level_used = outputs[:, 6].numpy() * 8.0
    scene = _scene(mips)
    d4, keys, wts = sky.sky_taps_reference(scene, ST, outputs,
                                           torch.from_numpy(ct))
    n_texels = sum(m.shape[0] * m.shape[1] for m in mips)
    got = sky.split_mips(sky.scatter_texels(keys, wts, n_texels),
                         scene.env_mips)
    mags = sky.split_mips(sky.scatter_texels(keys, wts.abs(), n_texels),
                          scene.env_mips)

    reached = outputs[:, 3].numpy() != 0
    ct_r = ct * reached[:, None]
    _, vjp = jax.vjp(lambda m, lv: jenv.sample_env_packed(
        m, jnp.asarray(d), lv), tuple(jnp.asarray(m) for m in mips),
        jnp.asarray(level_used))
    ref_mips, ref_level = vjp(jnp.asarray(ct_r))
    assert len(got) == len(ref_mips)
    for lv, (g, r, mag) in enumerate(zip(got, ref_mips, mags)):
        _assert_sums_close(g, np.asarray(r), mag, f"mip {lv}")
    inside = (level_used >= 0) & (level_used <= len(mips) - 1)
    np.testing.assert_allclose(
        d4[:, 3].numpy(),
        np.where(inside, np.asarray(ref_level) * 8.0, 0.0) * reached,
        atol=1e-5, rtol=1e-4)
    # the miss attenuation's cotangent is ct * the sky
    look = jenv.sample_env_packed(tuple(jnp.asarray(m) for m in mips),
                                  jnp.asarray(d), jnp.asarray(level_used))
    np.testing.assert_allclose(d4[:, 0:3].numpy(), ct * np.asarray(look),
                               atol=ATOL, rtol=RTOL)
    # rays that never reached the sky have no taps
    assert (keys.reshape(N, sky.TAPS)[~torch.from_numpy(reached)] == -1).all()


def test_one_mip_has_four_taps():
    """A pyramid of one mip: the lookup is bilinear, the other four taps
    are -1 and the roughness gets no cotangent."""
    mip = _maps()["random"][0]
    d, level, ct = _rays(2, 1)
    outputs = _outputs(d, level, np.random.default_rng(2))
    scene = _scene([mip])
    d4, keys, wts = sky.sky_taps_reference(scene, ST, outputs,
                                           torch.from_numpy(ct))
    assert (keys.reshape(N, sky.TAPS)[:, 4:] == -1).all()
    assert not d4[:, 3].any()
    got = sky.scatter_texels(keys, wts, mip.shape[0] * mip.shape[1])
    mag = sky.scatter_texels(keys, wts.abs(), mip.shape[0] * mip.shape[1])
    reached = outputs[:, 3].numpy() != 0
    _, vjp = jax.vjp(lambda m: jenv.sample_env_packed(
        (m,), jnp.asarray(d), jnp.zeros((N,))), jnp.asarray(mip))
    (ref,) = vjp(jnp.asarray(ct * reached[:, None]))
    _assert_sums_close(got.reshape(mip.shape), np.asarray(ref),
                       mag.reshape(mip.shape), "mip 0")


def test_atlas_builds_count_each_copy_of_the_mips():
    """`sky.atlas_builds` counts one a copy of the mips into an atlas: the
    launch's checks (`_kernel_args`) make one, the plain taps another."""
    mips = _maps()["gradient"]
    d, level, ct = _rays(4, len(mips))
    outputs = _outputs(d, level, np.random.default_rng(4))
    scene = _scene(mips)
    before = profiling.counts()["sky.atlas_builds"]
    tex = sky._kernel_args(scene, ST, outputs, scene.env_mips)[0]
    after_args = profiling.counts()["sky.atlas_builds"]
    sky.sky_taps_reference(scene, ST, outputs, torch.from_numpy(ct))
    after_taps = profiling.counts()["sky.atlas_builds"]
    assert (after_args - before, after_taps - after_args) == (1, 1)
    assert tex.shape == (sum(m.shape[0] * m.shape[1] for m in mips), 3)


def test_scatter_skips_negative_keys_and_keeps_order():
    """`scatter_texels` on the CPU: keys < 0 add nothing; each texel gets
    the sum of its weights."""
    keys = torch.tensor([2, -1, 0, 2, 5, -1], dtype=torch.int32)
    wts = torch.arange(18, dtype=torch.float32).reshape(6, 3)
    got = sky.scatter_texels(keys, wts, 6)
    ref = torch.zeros((6, 3))
    for k, w in zip(keys.tolist(), wts):
        if k >= 0:
            ref[k] += w
    assert torch.equal(got, ref)


@pytest.mark.parametrize("branch", ["stay", "alias"])
def test_env_nee_draw_texel_matches_jax(branch):
    """The env-NEE draw's radiance is the texel the draw chose: the row's
    own texel where u2 < alias_p, else its alias (`flat[alias_j]`). The
    radiance's cotangent reaches env_mips[0] at that texel in both
    packages, and `alias_j` read back from the draw table's float column,
    as the kernel reads it, is that texel."""
    mip = _maps()["random"][0]
    h, w = mip.shape[:2]
    cdf_j = jenv.build_env_cdf(mip)
    cdf_t = tenv.build_env_cdf(mip, device="cpu")
    alias_p = cdf_t.alias_p.numpy()
    rows = np.nonzero(alias_p < 0.9)[0][:64]
    assert rows.size >= 16
    u1 = ((rows + 0.5) / (h * w)).astype(np.float32)
    u2 = (alias_p[rows] * 0.5 if branch == "stay"
          else 0.5 * (alias_p[rows] + 1.0)).astype(np.float32)
    ct = np.random.default_rng(4).normal(size=(rows.size, 3)).astype(
        np.float32)
    env0 = torch.from_numpy(mip).requires_grad_(True)
    _, _, rad = tenv.sample_env_draw(cdf_t, env0, torch.from_numpy(u1),
                                     torch.from_numpy(u2))
    (rad * torch.from_numpy(ct)).sum().backward()
    _, vjp = jax.vjp(lambda e: jenv.sample_env_draw(
        cdf_j, e, jnp.asarray(u1), jnp.asarray(u2))[2], jnp.asarray(mip))
    (ref,) = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(env0.grad.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    texel = (rows if branch == "stay"
             else cdf_t.draw_static[rows, 1].numpy().astype(np.int64))
    if branch == "alias":
        assert np.array_equal(texel, cdf_t.alias_j.numpy()[rows])
        assert (texel != rows).any()
    touched = np.nonzero(env0.grad.numpy().reshape(-1, 3).any(axis=1))[0]
    assert set(touched) <= set(texel.tolist())
