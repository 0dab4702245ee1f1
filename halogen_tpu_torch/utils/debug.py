"""Numerical debugging (PyTorch port of `halogen_tpu/utils/debug.py`): the
renderer is functionally pure, so the failure modes that matter are
NaN/Inf leaks and nondeterminism, checked directly."""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


@contextlib.contextmanager
def nan_guard():
    """Autograd's anomaly mode within the scope: a backward op that
    produces a NaN raises, with the traceback of the forward op that made
    it (the JAX package's `jax_debug_nans`). It checks the backward pass;
    `assert_finite` checks forward results."""
    with torch.autograd.detect_anomaly(check_nan=True):
        yield


def _leaves(tree, path: str = ""):
    """(path, leaf) of every tensor or array in tensors, dataclasses,
    NamedTuples, lists, tuples and dicts."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        yield path, tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")


def assert_finite(tree, name: str = "output"):
    """Raise FloatingPointError if any float tensor or array in `tree`
    holds a NaN or Inf (post-hoc render validation)."""
    for path, leaf in _leaves(tree):
        arr = leaf.detach() if isinstance(leaf, torch.Tensor) else leaf
        if isinstance(arr, torch.Tensor):
            if not arr.is_floating_point():
                continue
            bad = int((~torch.isfinite(arr)).sum())
        else:
            if not np.issubdtype(arr.dtype, np.floating):
                continue
            bad = int((~np.isfinite(arr)).sum())
        if bad:
            raise FloatingPointError(f"{name}{path}: {bad} non-finite values")


def check_replay_determinism(render_fn, *args, repeats: int = 2) -> bool:
    """Run `render_fn(*args)` `repeats` times and assert bitwise-identical
    results: the determinism that path-replay gradients rest on (the
    adjoint kernel replays the forward kernel's paths)."""
    ref = render_fn(*args)
    for _ in range(repeats - 1):
        out = render_fn(*args)
        if isinstance(ref, torch.Tensor):
            if not torch.equal(out, ref):
                raise AssertionError("render is not bitwise repeatable")
        else:
            np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    return True
