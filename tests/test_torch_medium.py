"""The port's medium stack (`halogen_tpu_torch/core/medium.py`) against the
JAX package's (`halogen_tpu/core/medium.py`): the same push and pop
sequences, drawn from a numpy seed, must leave equal stacks, slot for slot
and bit for bit (the empty slots included)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from halogen_tpu.core.medium import Medium as JMedium
from halogen_tpu.core.medium import MediumStack as JStack
from halogen_tpu_torch.core.medium import STACK_DEPTH, Medium, MediumStack

FIELDS = ("ior", "absorption", "priority", "material_id", "size")


def _assert_equal(port: MediumStack, ref: JStack):
    for f in FIELDS:
        got = getattr(port, f).numpy()
        want = np.asarray(getattr(ref, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def _media(prio, mid, rng):
    """The same batch of media for both packages."""
    n = len(prio)
    ior = rng.uniform(1.0, 2.0, n).astype(np.float32)
    ab = rng.uniform(0.0, 3.0, (n, 3)).astype(np.float32)
    prio = np.asarray(prio, np.int32)
    mid = np.asarray(mid, np.int32)
    port = Medium(torch.from_numpy(ior), torch.from_numpy(ab),
                  torch.from_numpy(prio), torch.from_numpy(mid))
    ref = JMedium(jnp.asarray(ior), jnp.asarray(ab), jnp.asarray(prio),
                  jnp.asarray(mid))
    return port, ref


@pytest.mark.parametrize("seed", [42, 7])
def test_random_push_pop_matches_jax(seed):
    """`tests/test_medium.py:123`'s fuzz (pops of live ids 40% of the
    time, pushes of priorities 0-4 otherwise), run on 16 stacks at once:
    each step a random mask picks which stacks take the op, and pops of
    ids that are not on a stack must be no-ops."""
    rng = np.random.default_rng(seed)
    n = 16
    port, ref = MediumStack.create(n, device="cpu"), JStack.create(n)
    next_id = 0
    for _ in range(200):
        mask = rng.random(n) < 0.7
        if rng.random() < 0.4:
            ids = rng.integers(0, max(next_id, 1), n).astype(np.int32)
            port = port.pop_id(torch.from_numpy(ids), torch.from_numpy(mask))
            ref = ref.pop_id(jnp.asarray(ids), jnp.asarray(mask))
        else:
            prio = rng.integers(0, 5, n)
            mid = np.arange(next_id, next_id + n)
            next_id += n
            pm, rm = _media(prio, mid, rng)
            port = port.push(pm, torch.from_numpy(mask))
            ref = ref.push(rm, jnp.asarray(mask))
        _assert_equal(port, ref)
        probe = rng.integers(-1, 6, n).astype(np.int32)
        np.testing.assert_array_equal(
            port.is_true_hit(torch.from_numpy(probe)).numpy(),
            np.asarray(ref.is_true_hit(jnp.asarray(probe))))
    for f in ("ior", "absorption", "priority", "material_id"):
        np.testing.assert_array_equal(
            getattr(port.top(), f).numpy(), np.asarray(getattr(ref.top(), f)))
    assert int(port.size.max()) == STACK_DEPTH  # the fuzz fills stacks


def test_overflow_drops_the_push():
    rng = np.random.default_rng(0)
    port, ref = MediumStack.create(2, device="cpu"), JStack.create(2)
    for i in range(STACK_DEPTH + 3):
        pm, rm = _media([1, 3 - i % 4], [i, 100 + i], rng)
        port = port.push(pm, torch.tensor([True, True]))
        ref = ref.push(rm, jnp.asarray([True, True]))
        _assert_equal(port, ref)
    assert port.size.tolist() == [STACK_DEPTH, STACK_DEPTH]


def test_masked_ops_are_noops():
    rng = np.random.default_rng(1)
    port = MediumStack.create(3, device="cpu")
    pm, _ = _media([1, 1, 1], [7, 7, 7], rng)
    port = port.push(pm, torch.tensor([True, False, True]))
    assert port.size.tolist() == [1, 0, 1]
    before = port
    port = port.pop_id(torch.tensor([7, 7, 8], dtype=torch.int32),
                       torch.tensor([False, True, True]))
    # masked off; nothing to pop; a missing id
    for f in FIELDS:
        assert torch.equal(getattr(port, f), getattr(before, f)), f
    port = port.pop_id(torch.tensor([7, 7, 7], dtype=torch.int32),
                       torch.tensor([True, True, True]))
    assert port.size.tolist() == [0, 0, 0]
    top = port.top()
    assert top.material_id.tolist() == [-1, -1, -1]
    assert top.ior.tolist() == [1.0, 1.0, 1.0]


def test_priority_order_and_true_hits():
    """Lower priority value wins and the top is the highest-precedence
    medium; a push lands at the top when its priority <= the top's, else
    below every entry of a strictly greater value (so below its equals)."""
    rng = np.random.default_rng(2)
    s = MediumStack.create(1, device="cpu")
    for prio, mid in ((2, 0), (0, 1), (2, 2), (1, 3)):
        pm, _ = _media([prio], [mid], rng)
        s = s.push(pm, torch.tensor([True]))
    assert s.priority[0, :4].tolist() == [2, 2, 1, 0]
    assert s.material_id[0, :4].tolist() == [2, 0, 3, 1]
    assert int(s.top().material_id) == 1
    assert s.is_true_hit(torch.tensor([0], dtype=torch.int32)).item()
    assert not s.is_true_hit(torch.tensor([1], dtype=torch.int32)).item()
    s = s.pop_id(torch.tensor([2], dtype=torch.int32), torch.tensor([True]))
    assert s.material_id[0, :3].tolist() == [0, 3, 1]
