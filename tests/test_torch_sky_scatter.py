"""The sky backward's per-texel sums as the card computes them, on the CPU:
the plain model of the sum kernels (`sky.reduce_texels_model`: tiles,
in-tile segmented sums, carries added in tile order by the next level)
against `index_add_` in float64, the ordering's plan against a stable
sort, and `sky_backward_full` at a 698,880-texel atlas against the JAX
package's vjp of `sample_env_packed`, per mip.

The model's cases are hypothesis-driven with a fixed seed: runs that cross
many tiles, one texel that takes every tap, empty texels, every key -1, a
tap count that is not a multiple of the tile, no tap at all. Tiles of 64
taps make many tiles and carry levels at small sizes; the kernel's own
tile (512) is held at a larger size. Tolerance: 1e-5 of the texel's sum
of magnitudes + 1e-6 (float32 sums of the same taps in another order).
The kernels themselves are held to these models on the card
(`tests/test_torch_sky_cuda.py`, `chip_smoke.py` phase 29). The sums'
add mode (a chunk node's groups summed into one gradient) has its plain
version here, `index_add_` into the given buffer; the card's is held
bit for bit to the buffer + the fresh sums in `test_torch_sky_cuda.py`
(a file without JAX, as the card's machine has none).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, seed, settings, strategies as st

from halogen_tpu.scene import envmap as jenv
from halogen_tpu_torch.config import RenderSettings
from halogen_tpu_torch.kernels import sky
from halogen_tpu_torch.scene import envmap as tenv

from test_torch_sky import _assert_sums_close, _outputs, _rays, _scene


def _index_add(keys, wts, n_texels):
    keep = keys >= 0
    return torch.zeros((n_texels, 3), dtype=torch.float64).index_add_(
        0, keys[keep].long(), wts[keep].double())


def _model_route(keys, wts, n_texels, tile):
    """The card's two stages in plain form: the stable order by texel
    (`order_texels` on the CPU), then the model of the tiled sums."""
    ordered, idx = sky.order_texels(keys, n_texels)
    return sky.reduce_texels_model(ordered, wts[idx.long()], n_texels,
                                   tile=tile)


def _assert_close_to_index_add(got, keys, wts, n_texels):
    ref = _index_add(keys, wts, n_texels)
    mag = _index_add(keys, wts.abs(), n_texels)
    diff = (got.double() - ref).abs()
    assert (diff <= 1e-5 * mag + 1e-6).all(), float(diff.max())


@st.composite
def _taps(draw):
    """(keys, weights, n_texels): runs of random lengths (a long one
    crosses many 64-tap tiles), interleaved in random order with keys -1,
    over an atlas with empty texels."""
    n_texels = draw(st.integers(1, 300))
    lengths = draw(st.lists(st.integers(0, 700), min_size=0, max_size=12))
    n_neg = draw(st.integers(0, 200))
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 31)))
    texels = rng.integers(0, n_texels, len(lengths))
    keys = np.concatenate([np.full(c, t) for c, t in zip(lengths, texels)]
                          + [np.full(n_neg, -1)]).astype(np.int32)
    rng.shuffle(keys)
    wts = rng.normal(size=(keys.size, 3)).astype(np.float32)
    return torch.from_numpy(keys), torch.from_numpy(wts), n_texels


@seed(20261017)
@settings(max_examples=60, deadline=None, derandomize=True)
@given(_taps())
def test_tiled_model_matches_index_add(case):
    keys, wts, n_texels = case
    got = _model_route(keys, wts, n_texels, tile=64)
    _assert_close_to_index_add(got, keys, wts, n_texels)
    assert not got[_index_add(keys, torch.ones_like(wts), n_texels)[:, 0]
                   == 0].any(), "an empty texel got a sum"


@pytest.mark.parametrize("case", ["one_texel", "all_negative", "empty",
                                  "ragged", "many_runs"])
def test_tiled_model_cases(case):
    """The named cases at the kernel's tile: one texel takes all 100,003
    taps (hundreds of tiles, two carry levels); every key -1; m = 0; 1,537
    taps (three tiles, the last ragged) over 5 texels; 50,000 taps over
    20,000 texels (short runs, many per tile)."""
    rng = np.random.default_rng(5)
    m, n_texels = {"one_texel": (100003, 10920), "all_negative": (4099, 64),
                   "empty": (0, 64), "ragged": (1537, 5),
                   "many_runs": (50000, 20000)}[case]
    keys = {"one_texel": np.full(m, 10919),
            "all_negative": np.full(m, -1)}.get(
        case, rng.integers(-1, n_texels, m))
    keys = torch.from_numpy(np.asarray(keys, np.int32))
    wts = torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32))
    got = _model_route(keys, wts, n_texels, tile=sky.SUM_TILE)
    _assert_close_to_index_add(got, keys, wts, n_texels)
    if case in ("all_negative", "empty"):
        assert not got.any()


def test_model_carries_add_in_tile_order():
    """A run across three 64-tap tiles: each tile sums its part, and the
    carry level adds the three partials (and each tile's empty second
    slot, + 0) in tile order, (p0 + p1) + p2: lanes 0 and 1 meet in the
    lane scan, lane 2 walks its keys from their sum. (With this seed
    p0 + (p1 + p2) has other bits.)"""
    vals = torch.tensor(np.random.default_rng(0).normal(size=(192, 3)),
                        dtype=torch.float32)
    keys = torch.zeros(192, dtype=torch.int64)
    got = sky.reduce_texels_model(keys, vals, 1, tile=64)
    parts = [sky.reduce_texels_model(keys[:64], vals[i:i + 64], 1, tile=64)
             for i in (0, 64, 128)]
    assert torch.equal(got, (parts[0] + parts[1]) + parts[2])
    assert not torch.equal(got, parts[0] + (parts[1] + parts[2]))


@seed(7)
@settings(max_examples=40, deadline=None, derandomize=True)
@given(st.integers(1, 2 ** 24), st.integers(0, 3000),
       st.integers(0, 2 ** 31))
def test_order_plan_covers_the_atlas(n_texels, m, rng_seed):
    """An LSD sort over `order_plan`'s passes, each a stable sort by one
    digit, of the keys in [0, n_texels) gives torch.sort(stable=True)'s
    permutation: the passes cover every bit of the largest texel, and at
    most 24 bits for an atlas below 2^24 texels."""
    bits, passes, digit = sky.order_plan(n_texels)
    assert passes * digit >= bits and digit <= sky.MAX_DIGIT_BITS
    assert bits <= 24 and (n_texels - 1) >> bits == 0
    rng = np.random.default_rng(rng_seed)
    keys = torch.from_numpy(rng.integers(-1, n_texels, m).astype(np.int32))
    keep = torch.nonzero(keys >= 0).squeeze(1)
    k, idx = keys[keep].long(), keep
    for p in range(passes):
        order = torch.sort((k >> (p * digit)) & ((1 << digit) - 1),
                           stable=True).indices
        k, idx = k[order], idx[order]
    ordered, perm = sky.order_texels(keys, n_texels)
    assert torch.equal(ordered.long(), k) and torch.equal(perm.long(), idx)


@pytest.mark.parametrize("case", ["ragged", "one_texel", "no_tap"])
def test_scatter_adds_into_a_given_buffer(case):
    """`scatter_texels(..., out=)` on the CPU, the plain version of the
    card's add mode: `index_add_` into the given buffer, returned. It
    agrees with the buffer + the fresh sums (float32 sums of the same taps
    in another association: 1e-5 of the magnitudes + 1e-6), equals them
    where a texel takes one tap, and leaves the texels without a tap as
    they were, bit for bit."""
    rng = np.random.default_rng(23)
    m, n_texels = {"ragged": (1537, 900), "one_texel": (4099, 5),
                   "no_tap": (300, 64)}[case]
    keys = rng.integers(-1, n_texels, m)
    if case == "no_tap":
        keys[:] = -1
    keys = torch.from_numpy(keys.astype(np.int32))
    wts = torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32))
    buf = torch.from_numpy(rng.normal(size=(n_texels, 3)).astype(np.float32))
    out = buf.clone()
    got = sky.scatter_texels(keys, wts, n_texels, out=out)
    assert got is out
    ref = buf.double() + _index_add(keys, wts, n_texels)
    mag = buf.double().abs() + _index_add(keys, wts.abs(), n_texels)
    assert ((got.double() - ref).abs() <= 1e-5 * mag + 1e-6).all()
    taps = _index_add(keys, torch.ones_like(wts), n_texels)[:, 0]
    assert torch.equal(got[taps == 0], buf[taps == 0])
    one = taps == 1
    fresh = sky.scatter_texels(keys, wts, n_texels)
    assert torch.equal(got[one], (buf + fresh)[one])
    with pytest.raises(ValueError, match="out must be"):
        sky.scatter_texels(keys, wts, n_texels, out=buf[:-1])


def test_order_plan_of_the_two_atlases():
    assert sky.order_plan(10920) == (14, 2, 7)
    assert sky.order_plan(698880) == (20, 3, 7)


ST = RenderSettings(use_envmap=True, env_mip_level=0, mip_importance_range=8.0)


@pytest.mark.parametrize("route", ["index_add", "tiled_model"])
def test_backward_full_at_a_large_atlas_matches_jax(route, monkeypatch):
    """`sky_backward_full` on the CPU at `Envmap.from_equirect` of a seeded
    random 512 x 1024 image with 6 mips (698,880 texels, 20 key bits)
    against jax.vjp of sample_env_packed per mip, at
    `tests/test_torch_sky.py`'s tolerance; and the card's route in plain
    form (the stable order, then the tiled model) on the same taps.

    Both packages look up the same (u, v), the port's: XLA's acos and
    torch's differ by an ulp on about one ray in six, and 512 rows turn
    that ulp into 6e-5 of a tap's weight, a difference of the inputs that
    the sums' tolerance is not about (`test_uv_of_the_two_packages`)."""
    rng = np.random.default_rng(7)
    img = rng.uniform(0.0, 2.0, (512, 1024, 3)).astype(np.float32)
    mips = jenv.Envmap.from_equirect(img, num_mips=6).mips
    assert sum(m.shape[0] * m.shape[1] for m in mips) == 698880
    d, level, ct = _rays(3, len(mips))
    outputs = _outputs(d, level, np.random.default_rng(4))
    level_used = outputs[:, 6].numpy() * 8.0
    u, v = tenv.dir_to_equirect_uv(outputs[:, 7:10])
    monkeypatch.setattr(jenv, "dir_to_equirect_uv", lambda _: (
        jnp.asarray(u.numpy()), jnp.asarray(v.numpy())))
    scene = _scene(mips)
    if route == "index_add":
        d4, got = sky.sky_backward_full(scene, ST, outputs,
                                        torch.from_numpy(ct))
    else:
        d4, keys, wts = sky.sky_backward(scene, ST, outputs,
                                         torch.from_numpy(ct))
        got = sky.split_mips(_model_route(keys, wts, 698880, sky.SUM_TILE),
                             scene.env_mips)
    _, keys, wts = sky.sky_taps_reference(scene, ST, outputs,
                                          torch.from_numpy(ct))
    mags = sky.split_mips(sky.scatter_texels(keys, wts.abs(), 698880),
                          scene.env_mips)
    reached = outputs[:, 3].numpy() != 0
    _, vjp = jax.vjp(lambda m, lv: jenv.sample_env_packed(
        m, jnp.asarray(d), lv), tuple(jnp.asarray(m) for m in mips),
        jnp.asarray(level_used))
    ref_mips, _ = vjp(jnp.asarray(ct * reached[:, None]))
    assert len(got) == len(ref_mips) == 6
    for lv, (g, r, mag) in enumerate(zip(got, ref_mips, mags)):
        _assert_sums_close(g, np.asarray(r), mag, f"mip {lv}")
    assert d4.shape == (outputs.shape[0], 4)


def test_uv_of_the_two_packages():
    """The direction's (u, v): u bit for bit, v within an ulp of acos
    (XLA's and torch's round apart on some rays)."""
    d, _, _ = _rays(3, 6)
    u, v = tenv.dir_to_equirect_uv(torch.from_numpy(d))
    u_j, v_j = jenv.dir_to_equirect_uv(jnp.asarray(d))
    assert np.array_equal(u.numpy(), np.asarray(u_j))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=0,
                               atol=1.2e-7)
