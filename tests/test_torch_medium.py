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


# --- the CUDA kernels' stack of ids (csrc/path_common.cuh `MediumStack`)

_ONES = 0x0101010101010101
_U64 = (1 << 64) - 1


class IdStack:
    """The kernels' medium stack, bit step for bit step: a medium is its
    material id (every field of a medium is a column of that material's
    row), slot k is byte k of a 64-bit word, a push inserts a byte and a
    pop deletes one. `prio_of` is the material table's priority column."""

    def __init__(self, prio_of):
        self.prio_of, self.ids, self.size = prio_of, np.uint64(0), 0

    def _prio(self, mid):
        return EMPTY if mid < 0 else int(self.prio_of[mid])

    def id_at(self, k):
        return int((int(self.ids) >> (8 * k)) & 0xFF)

    def top(self):
        return -1 if self.size == 0 else self.id_at(self.size - 1)

    def is_true_hit(self, p):
        return self.size == 0 or p <= self._prio(self.top())

    def push(self, mid, mask):
        prio = self._prio(mid)
        if not mask or self.size >= STACK_DEPTH:
            return
        idx = self.size
        if prio > self._prio(self.top()):
            idx = sum(self._prio(self.id_at(k)) > prio
                      for k in range(self.size))
        ids, low = int(self.ids), (1 << (8 * idx)) - 1
        self.ids = np.uint64(((ids & low) | (mid << (8 * idx))
                              | ((ids & ~low) << 8)) & _U64)
        self.size += 1

    def pop_id(self, mid, mask):
        ids = int(self.ids)
        x = ids ^ ((_ONES * mid) & _U64)
        flags = ((x - _ONES) & _U64) & (~x & _U64) & (_ONES << 7)
        if self.size < STACK_DEPTH:
            flags &= (1 << (8 * self.size)) - 1
        if not mask or flags == 0:
            return
        first = ((flags & -flags).bit_length() - 1) >> 3  # __ffsll - 1
        low = (1 << (8 * first)) - 1
        self.ids = np.uint64((ids & low) | ((ids >> 8) & ~low & _U64))
        self.size -= 1


EMPTY = 2**31 - 1


def _assert_model_equal(models, port: MediumStack, ref: JStack, prio_of):
    """Every slot under `size` (the kernels never read one above it)."""
    assert [m.size for m in models] == port.size.tolist()
    np.testing.assert_array_equal(port.size.numpy(), np.asarray(ref.size))
    for i, m in enumerate(models):
        ids = [m.id_at(k) for k in range(m.size)]
        assert ids == port.material_id[i, :m.size].tolist()
        assert ids == np.asarray(ref.material_id)[i, :m.size].tolist()
        assert [int(prio_of[j]) for j in ids] == (
            port.priority[i, :m.size].tolist())
    assert [m.top() for m in models] == port.top().material_id.tolist()


def _table_media(ids, table):
    """Media as the kernels' callers push them: a material's own row."""
    ids = np.asarray(ids, np.int32)
    ior, ab, prio = table
    port = Medium(torch.from_numpy(ior[ids]), torch.from_numpy(ab[ids]),
                  torch.from_numpy(prio[ids]), torch.from_numpy(ids))
    ref = JMedium(jnp.asarray(ior[ids]), jnp.asarray(ab[ids]),
                  jnp.asarray(prio[ids]), jnp.asarray(ids))
    return port, ref


def _material_table(rng, k=64):
    return (rng.uniform(1.0, 2.0, k).astype(np.float32),
            rng.uniform(0.0, 3.0, (k, 3)).astype(np.float32),
            rng.integers(0, 5, k).astype(np.int32))


@pytest.mark.parametrize("seed", [42, 7])
def test_id_stack_model_matches_port_and_jax(seed):
    """`test_random_push_pop_matches_jax`'s fuzz with media drawn from a
    64-row material table (ids repeat, as a ray may enter a material
    twice): the kernels' id stack, the port's stack and the JAX `_Stack`
    hold the same ids under `size`, the same top and the same true-hit
    answers after every op."""
    rng = np.random.default_rng(seed)
    n = 16
    table = _material_table(rng)
    models = [IdStack(table[2]) for _ in range(n)]
    port, ref = MediumStack.create(n, device="cpu"), JStack.create(n)
    for _ in range(200):
        mask = rng.random(n) < 0.7
        ids = rng.integers(0, 64, n).astype(np.int32)
        if rng.random() < 0.4:
            live = [m.id_at(int(rng.integers(0, m.size))) if m.size
                    and rng.random() < 0.7 else int(i)
                    for m, i in zip(models, ids)]
            ids = np.asarray(live, np.int32)
            port = port.pop_id(torch.from_numpy(ids), torch.from_numpy(mask))
            ref = ref.pop_id(jnp.asarray(ids), jnp.asarray(mask))
            for m, i, on in zip(models, ids, mask):
                m.pop_id(int(i), bool(on))
        else:
            pm, rm = _table_media(ids, table)
            port = port.push(pm, torch.from_numpy(mask))
            ref = ref.push(rm, jnp.asarray(mask))
            for m, i, on in zip(models, ids, mask):
                m.push(int(i), bool(on))
        _assert_model_equal(models, port, ref, table[2])
        probe = rng.integers(-1, 6, n).astype(np.int32)
        assert [m.is_true_hit(int(p)) for m, p in zip(models, probe)] == (
            port.is_true_hit(torch.from_numpy(probe)).tolist())
    assert max(m.size for m in models) == STACK_DEPTH  # the fuzz fills stacks


def test_id_stack_model_drops_the_push_on_a_full_stack():
    rng = np.random.default_rng(0)
    table = _material_table(rng)
    models = [IdStack(table[2]) for _ in range(2)]
    port, ref = MediumStack.create(2, device="cpu"), JStack.create(2)
    on = np.array([True, True])
    for i in range(STACK_DEPTH + 3):
        ids = np.array([i, 63 - i], np.int32)
        pm, rm = _table_media(ids, table)
        port, ref = port.push(pm, torch.from_numpy(on)), ref.push(
            rm, jnp.asarray(on))
        for m, j in zip(models, ids):
            m.push(int(j), True)
        _assert_model_equal(models, port, ref, table[2])
    assert [m.size for m in models] == [STACK_DEPTH, STACK_DEPTH]
    # a full stack still pops, from any slot
    for m in models:
        m.pop_id(m.id_at(0), True)
        m.pop_id(m.id_at(6), True)
    assert [m.size for m in models] == [STACK_DEPTH - 2] * 2


def test_id_stack_model_missing_id_and_mask_are_noops():
    table = _material_table(np.random.default_rng(1))
    m = IdStack(table[2])
    m.pop_id(0, True)  # id 0 against an empty word of zero bytes
    assert (m.size, int(m.ids)) == (0, 0)
    for mid in (7, 0, 7):
        m.push(mid, True)
    before = (m.size, int(m.ids))
    m.pop_id(9, True)   # not on the stack
    m.pop_id(7, False)  # masked off
    m.push(5, False)
    assert (m.size, int(m.ids)) == before
    low = min(k for k in range(3) if m.id_at(k) == 7)
    rest = [m.id_at(k) for k in range(3) if k != low]
    m.pop_id(7, True)   # the lowest slot that holds 7 goes
    assert [m.id_at(k) for k in range(m.size)] == rest
    # a stale byte above `size` that equals the id is not found
    m.pop_id(m.id_at(1), True)
    gone = (int(m.ids) >> 8) & 0xFF
    size = m.size
    m.pop_id(99, True)
    assert m.size == size and gone == ((int(m.ids) >> 8) & 0xFF)
