"""The port's envmap module (`halogen_tpu_torch/scene/envmap.py`) against
the JAX package's (`halogen_tpu/scene/envmap.py`), on the gradient sky, a
constant map and `tests/test_env_nee.py:22`'s spot sky.

The host side (mips, alias tables) must be equal. The lookups and draws
take seeded directions and uniforms from numpy and must agree at atol
1e-6, scaled by the map's peak radiance for radiance values: torch's and
XLA's atan2, acos, sin and cos may differ by an ulp, which moves a
bilinear weight by ~1e-7, and the spot sky's brightest texel is 60.
"""

import numpy as np
import jax.numpy as jnp
import pytest
from jax_native_sah import jax_native_sah  # noqa: F401  (autouse)
import torch

from halogen_tpu.scene import cornell as jcornell
from halogen_tpu.scene import envmap as jenv
from halogen_tpu_torch import interop
from halogen_tpu_torch.scene import cornell as tcornell
from halogen_tpu_torch.scene import envmap as tenv

CPU = "cpu"  # the port builds on the card unless asked for the CPU

ATOL = 1e-6
N = 4096


def _spot_sky(mod, height=32, strength=60.0):
    img = np.full((height, 2 * height, 3), 0.02, np.float32)
    img[height // 4, height // 2] = strength
    return mod.Envmap.from_equirect(img, num_mips=2)


MAPS = {
    "gradient_sky": lambda mod: mod.Envmap.gradient_sky(),
    "constant": lambda mod: mod.Envmap.constant((0.3, 0.6, 0.9)),
    "spot_sky": _spot_sky,
}


@pytest.fixture(scope="module", params=sorted(MAPS))
def maps(request):
    """(name, JAX envmap + cdf, port envmap + cdf)."""
    jm, tm = MAPS[request.param](jenv), MAPS[request.param](tenv)
    return (request.param, jm, jenv.build_env_cdf(jm.mips[0]), tm,
            tenv.build_env_cdf(tm.mips[0], "cpu"))


def _dirs(seed=0):
    d = np.random.default_rng(seed).normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # the poles and the seam, where the wrap and clamp rules bite
    d[:4] = [[0, 1, 0], [0, -1, 0], [0, 0, 1], [1e-7, 0, 1]]
    return d


def test_mips_and_tables_equal_jax(maps):
    _, jm, jcdf, tm, tcdf = maps
    assert len(jm.mips) == len(tm.mips)
    for a, b in zip(jm.mips, tm.mips):
        np.testing.assert_array_equal(a, b)
    for f in tenv.EnvCDF._fields:
        got, want = getattr(tcdf, f).numpy(), np.asarray(getattr(jcdf, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def test_lookups_match_jax(maps):
    """sample_env_packed (trilinear, float levels across and beyond the
    pyramid), sample_env, the nearest and bilinear single-mip lookups and
    env_pdf, for the same directions."""
    _, jm, jcdf, tm, tcdf = maps
    d = _dirs()
    level = np.random.default_rng(1).uniform(-0.5, 7.0, N).astype(np.float32)
    jmips = tuple(jnp.asarray(m) for m in jm.mips)
    tmips = tuple(torch.from_numpy(m) for m in tm.mips)
    td, tl = torch.from_numpy(d), torch.from_numpy(level)
    pairs = [
        (tenv.sample_env_packed(tmips, td, tl),
         jenv.sample_env_packed(jmips, jnp.asarray(d), jnp.asarray(level))),
        (tenv.sample_env(tmips, td, tl),
         jenv.sample_env(jmips, jnp.asarray(d), jnp.asarray(level))),
        (tenv.sample_env_mip(tmips[0], td),
         jenv.sample_env_mip(jmips[0], jnp.asarray(d))),
        (tenv.sample_env_mip_nearest(tmips[-1], td),
         jenv.sample_env_mip_nearest(jmips[-1], jnp.asarray(d))),
        (tenv.env_pdf(tcdf, td), jenv.env_pdf(jcdf, jnp.asarray(d))),
    ]
    peak = max(1.0, float(tm.mips[0].max()))
    for (got, want), scale in zip(pairs, (peak, peak, peak, peak, 1.0)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL * scale,
                                   rtol=0)
    # packed and tap-wise lookups are the same formulas
    torch.testing.assert_close(pairs[0][0], pairs[1][0], atol=0, rtol=0)


def test_draws_match_jax(maps):
    """sample_env_direction and sample_env_draw for the same uniforms,
    the ends of [0, 1) included."""
    _, jm, jcdf, tm, tcdf = maps
    u = np.random.default_rng(2).random((2, N)).astype(np.float32)
    u[:, :3] = [[0.0, 1.0 - 2**-24, 0.5], [0.0, 1.0 - 2**-24, 0.999]]
    tu1, tu2 = torch.from_numpy(u[0]), torch.from_numpy(u[1])
    ju1, ju2 = jnp.asarray(u[0]), jnp.asarray(u[1])
    td, tp = tenv.sample_env_direction(tcdf, tu1, tu2)
    jd, jp = jenv.sample_env_direction(jcdf, ju1, ju2)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    env0 = torch.from_numpy(tm.mips[0])
    got = tenv.sample_env_draw(tcdf, env0, tu1, tu2)
    want = jenv.sample_env_draw(jcdf, jnp.asarray(jm.mips[0]), ju1, ju2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)
    # the draw's pdf is the distribution's pdf at the drawn direction
    np.testing.assert_array_equal(got[1].numpy(), tp.numpy())
    # the rows the CUDA kernel reads: draw_static | texel | alias radiance
    tab = tenv.env_draw_table(tcdf, env0)
    flat = env0.reshape(-1, 3)
    assert tab.shape == (tcdf.pdf.numel(), 10)
    assert torch.equal(tab[:, :4], tcdf.draw_static)
    assert torch.equal(tab[:, 4:7], flat)
    assert torch.equal(tab[:, 7:10], flat[tcdf.alias_j.long()])
    assert torch.equal(tab[:, 1].long(), tcdf.alias_j.long())


def test_kernel_env_table_reproduces_the_draw():
    """`kernels/megakernel.env_table`, the rows of four 16-byte loads the
    CUDA kernel reads: `env_draw_table`'s ten values with the direction of
    the texel and of its alias, so that the kernel's alias step (a row,
    then a select) gives `sample_env_draw`'s direction, pdf and radiance
    bit for bit."""
    from halogen_tpu_torch.kernels import megakernel as mk

    scene = tcornell.cornell_box().build(envmap=tenv.Envmap.gradient_sky(),
                                         device=CPU)
    cdf, env0 = scene.env_cdf, scene.env_mips[0]
    tab = mk.env_table(scene)
    h, w = cdf.pdf.shape
    assert tab.shape == (h * w, 16) and tab.dtype == torch.float32
    draw = tenv.env_draw_table(cdf, env0)
    assert torch.equal(tab[:, [0, 1, 2, 3, 4, 5, 6, 8, 9, 10]], draw)
    u = np.random.default_rng(4).random((2, N)).astype(np.float32)
    u1, u2 = torch.from_numpy(u[0]), torch.from_numpy(u[1])
    want_d, want_pdf, want_rad = tenv.sample_env_draw(cdf, env0, u1, u2)
    # the kernel's step (csrc/path_common.cuh, the env NEE draw)
    n = h * w
    idx = torch.clamp((torch.clamp(u1, 0.0, float(np.float32(1.0 - 1e-7)))
                       * n).to(torch.int64), 0, n - 1)
    row = tab[idx]
    stay = u2 < row[:, 0]
    rx = torch.where(stay[:, None], row[:, 4:8], row[:, 8:12])
    yz = torch.where(stay[:, None], row[:, 12:14], row[:, 14:16])
    assert torch.equal(torch.where(stay, row[:, 2], row[:, 3]), want_pdf)
    assert torch.equal(rx[:, :3], want_rad)
    assert torch.equal(torch.cat([rx[:, 3:], yz], dim=1), want_d)
    assert mk.env_table(tcornell.cornell_box().build(device=CPU)) is None


def test_scene_build_carries_the_envmap():
    """`Scene.build(envmap=...)` fills env_mips and env_cdf as the JAX
    build does, `interop` carries both across, and `.to` moves them."""
    js = jcornell.cornell_box().build(envmap=jenv.Envmap.gradient_sky())
    ts = tcornell.cornell_box().build(envmap=tenv.Envmap.gradient_sky(), device=CPU)
    for a, b in zip(js.env_mips, ts.env_mips):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for f in tenv.EnvCDF._fields:
        np.testing.assert_array_equal(np.asarray(getattr(js.env_cdf, f)),
                                      getattr(ts.env_cdf, f).numpy())
    carried = interop.scene_from_numpy(interop.scene_to_numpy(js), device=CPU)
    assert len(carried.env_mips) == len(js.env_mips) == 6
    for f in tenv.EnvCDF._fields:
        assert torch.equal(getattr(carried.env_cdf, f),
                           getattr(ts.env_cdf, f))
    moved = carried.to("cpu")
    assert isinstance(moved.env_cdf, tenv.EnvCDF)
    assert isinstance(moved.env_mips, tuple)
    plain = interop.scene_from_numpy(interop.scene_to_numpy(
        jcornell.cornell_box().build()), device=CPU)
    assert plain.env_mips == () and plain.env_cdf is None


def test_procedural_glossy_pdf_matches_jax():
    """The continuation pdf env NEE weights against (`core/math.py`), on
    seeded directions, mirrors and normals, for roughness^2 from 0 (a
    delta: pdf 0) to 1 (the cosine lobe)."""
    from halogen_tpu.core.math import procedural_glossy_pdf as j_pdf
    from halogen_tpu_torch.core.math import procedural_glossy_pdf as t_pdf

    rng = np.random.default_rng(3)
    unit = lambda a: (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(
        np.float32)
    w, m, n = (unit(rng.normal(size=(N, 3))) for _ in range(3))
    a = rng.choice([0.0, 1e-7, 0.0625, 0.25, 0.49, 0.5, 0.75, 1.0],
                   N).astype(np.float32)
    got = t_pdf(*(torch.from_numpy(x) for x in (w, m, a, n))).numpy()
    want = np.asarray(j_pdf(*(jnp.asarray(x) for x in (w, m, a, n))))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got[a == 0.0] == 0.0).all() and got.max() > 0
