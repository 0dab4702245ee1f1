"""PyTorch port vs JAX package: the uint32 sampler is bit-exact, the warps
agree to float32 rounding.

Inputs are made with numpy from a fixed seed and fed to both packages.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from halogen_tpu.sampler import mappings as jmap
from halogen_tpu.sampler import sobol as jsob
from halogen_tpu_torch.sampler import mappings as tmap
from halogen_tpu_torch.sampler import sobol as tsob

N = 4096


@pytest.fixture(scope="module")
def draws():
    rng = np.random.default_rng(1234)
    index = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    # the full uint32 range plus the small indices renders actually use
    index[:256] = np.arange(256, dtype=np.uint32)
    dim = rng.integers(0, 64, N, dtype=np.uint32)
    seed = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    return index, dim, seed


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


def _same_u32(jax_out, torch_out):
    np.testing.assert_array_equal(
        np.asarray(jax_out).astype(np.uint32),
        torch_out.numpy().astype(np.uint32))
    assert int(torch_out.min()) >= 0 and int(torch_out.max()) <= 0xFFFFFFFF


def _same_f32(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out, np.float32),
                                  torch_out.numpy())


@pytest.mark.parametrize("fn", ["u32_hash", "reverse_bits_u32", "pixel_seed"])
def test_unary_u32_bit_exact(fn, draws):
    index, _, _ = draws
    _same_u32(getattr(jsob, fn)(jnp.asarray(index)),
              getattr(tsob, fn)(_t(index)))


@pytest.mark.parametrize("fn", ["owen_scramble", "hash_combine"])
def test_binary_u32_bit_exact(fn, draws):
    index, _, seed = draws
    _same_u32(getattr(jsob, fn)(jnp.asarray(index), jnp.asarray(seed)),
              getattr(tsob, fn)(_t(index), _t(seed)))


@pytest.mark.parametrize("dim", [0, 1, 2, 3])
def test_sobol1d_bit_exact(dim, draws):
    index, _, _ = draws
    _same_u32(jsob.sobol1d(jnp.asarray(index), dim),
              tsob.sobol1d(_t(index), dim))


@pytest.mark.parametrize("indices", ["below_2_16", "random", "all_ones"])
def test_sobol_dim1_butterfly_bit_exact(indices, draws):
    """The kernels' five-step form of Sobol's dimension 1 against the
    table, the port's and the JAX package's, bit for bit."""
    index = {"below_2_16": np.arange(1 << 16, dtype=np.uint32),
             "random": draws[0],
             "all_ones": np.array([0xFFFFFFFF, 0x80000000, 1, 0],
                                  np.uint32)}[indices]
    got = tsob.sobol_dim1_reversed(_t(index))
    _same_u32(jsob.reverse_bits_u32(jsob.sobol1d(jnp.asarray(index), 1)),
              got)
    assert torch.equal(got, tsob.reverse_bits_u32(tsob.sobol1d(_t(index), 1)))


def test_kernel_sampler_composition_bit_exact(draws):
    """The kernels' draws, with the bit reversals that meet cancelled
    (`owen_core` is `owen_scramble` without its two reversals), against
    the sampler's u32 draws."""
    index, dim, seed = (_t(a) for a in draws)
    rev = tsob.reverse_bits_u32
    core = lambda x, s: rev(tsob.owen_scramble(rev(x), s))
    sd = seed ^ tsob.u32_hash(dim)
    shuffled = rev(core(rev(index), sd))
    a = rev(core(shuffled, tsob.hash_combine(sd, 0)))
    b = rev(core(tsob.sobol_dim1_reversed(shuffled),
                 tsob.hash_combine(sd, 1)))
    x, y = tsob.u32_owen_scrambled_sobol_2d(index, dim, seed)
    assert torch.equal(a, x) and torch.equal(b, y)
    one = rev(core(index, tsob.u32_hash(sd)))
    assert torch.equal(one, tsob.u32_owen_scrambled_sobol_1d(index, dim,
                                                             seed))


@pytest.mark.parametrize("fn", ["u32_owen_scrambled_sobol_1d",
                                "u32_owen_scrambled_sobol_2d",
                                "u32_owen_scrambled_sobol_4d"])
def test_scrambled_sobol_u32_bit_exact(fn, draws):
    index, dim, seed = draws
    j = getattr(jsob, fn)(jnp.asarray(index), jnp.asarray(dim),
                          jnp.asarray(seed))
    t = getattr(tsob, fn)(_t(index), _t(dim), _t(seed))
    for a, b in zip(j if isinstance(j, tuple) else (j,),
                    t if isinstance(t, tuple) else (t,)):
        _same_u32(a, b)


@pytest.mark.parametrize("fn", ["ld_sample_1d", "ld_sample_2d",
                                "ld_sample_4d", "prng_sample_1d",
                                "prng_sample_2d"])
def test_float_samples_bit_exact(fn, draws):
    """The uint32 -> float32 conversion rounds to nearest in both."""
    index, dim, seed = draws
    j = getattr(jsob, fn)(jnp.asarray(index), jnp.asarray(dim),
                          jnp.asarray(seed))
    t = getattr(tsob, fn)(_t(index), _t(dim), _t(seed))
    for a, b in zip(j if isinstance(j, tuple) else (j,),
                    t if isinstance(t, tuple) else (t,)):
        assert b.dtype == torch.float32
        _same_f32(a, b)


def test_scalar_dims_and_sample_index(draws):
    """Python-int dimensions broadcast like the JAX weak-typed scalars, and
    sample_index wraps frame * spp + lane at 2^32."""
    index, _, seed = draws
    for dim in (0, 7, 4 + 5 * 11):
        ja, jb = jsob.ld_sample_2d(jnp.asarray(index), dim, jnp.asarray(seed))
        ta, tb = tsob.ld_sample_2d(_t(index), dim, _t(seed))
        _same_f32(ja, ta)
        _same_f32(jb, tb)
    frames = np.array([0, 1, 7, 2**31, 2**32 - 1], np.uint32)
    for frame in frames:
        _same_u32(jsob.sample_index(jnp.uint32(frame), jnp.asarray(index), 32),
                  tsob.sample_index(int(frame), _t(index), 32))


def test_mappings_match():
    rng = np.random.default_rng(7)
    u = rng.random(N, dtype=np.float32)
    v = rng.random(N, dtype=np.float32)
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    np.testing.assert_allclose(
        np.asarray(jmap.unit_vector_from_2d(jnp.asarray(u), jnp.asarray(v))),
        tmap.unit_vector_from_2d(tu, tv).numpy(), atol=1e-6, rtol=0)
    jx, jy = jmap.point_in_circle(np.float32(0.3), jnp.asarray(u),
                                  jnp.asarray(v))
    tx, ty = tmap.point_in_circle(torch.tensor(0.3), tu, tv)
    np.testing.assert_allclose(np.asarray(jx), tx.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        np.asarray(jmap.inverse_blackman_harris_cdf(jnp.asarray(u))),
        tmap.inverse_blackman_harris_cdf(tu).numpy(), atol=1e-6, rtol=0)


def test_blackman_harris_filter_matches_jax():
    x = np.random.default_rng(3).uniform(0.0, 2.0, N).astype(np.float32)
    ref = np.asarray(jmap.blackman_harris_filter(jnp.asarray(x), 2.0))
    got = tmap.blackman_harris_filter(torch.from_numpy(x), 2.0).numpy()
    # the sum of three cosine terms cancels near the window's ends
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-7)


def test_sobol_debug_matches_jax():
    """The sampler visualizer's histogram and the discrepancy probe
    (`sampler/debug.py`) on the CPU against the JAX package's."""
    from halogen_tpu.sampler import debug as jdebug
    from halogen_tpu_torch.sampler import debug as tdebug

    for through in (True, False):
        ref = jdebug.sobol_filter_image(size=32, count=5000,
                                        through_filter=through)
        got = tdebug.sobol_filter_image(size=32, count=5000,
                                        through_filter=through, device="cpu")
        assert got.dtype == np.float32 and got.shape == (32, 32, 3)
        np.testing.assert_array_equal(got, ref)
    ref = jdebug.sobol_discrepancy_probe()
    got = tdebug.sobol_discrepancy_probe(device="cpu")
    assert sorted(got) == sorted(ref)
    for d in ref:
        np.testing.assert_allclose(got[d], ref[d], rtol=1e-6)
