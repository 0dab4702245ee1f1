"""Nested-dielectric interface tracking as a data-parallel sorted stack,
in plain PyTorch (a frozen copy of the port's plain medium stack).

Each ray carries a fixed-depth stack of participating media
(`participatingMediumStack`, HalgoenCompute.compute:188-189,582-665) as
[N, D] tensors; push and pop are branch-free masked shifts, so a whole
ray pool updates at once. 

Semantics (the upstream renderer's):
- lower priority value = higher precedence; the stack is sorted in
  descending priority value from bottom to top, so the top (slot
  size - 1) is the highest-precedence medium (add_to_medium_stack,
  compute:582-622);
- a push lands at the top when its priority <= the top's, else just
  above the entries of strictly greater value;
- a hit is true iff the stack is empty or the hit material's priority
  <= top priority (determine_true_medium_hit, compute:656-665);
- pop removes the lowest slot whose material id matches; a missing id
  is a no-op (pop_from_medium_stack, compute:627-642);
- the empty medium has IOR 1, zero absorption, priority 2^31 - 1, id -1
  (get_empty_medium, compute:80-88);
- a push onto a full stack is dropped.

Absorption slots hold the pushed material's own values, so autograd
carries d absorption through the stack back to that material.
"""

from __future__ import annotations

import dataclasses

import torch

NO_MEDIUM_ID = -1  # empty-medium materialID (HalgoenCompute.compute:84)
EMPTY_PRIORITY = 2**31 - 1  # empty-medium priority (compute:85)

STACK_DEPTH = 8  # participatingMediumStack[8] (HalgoenCompute.compute:188)

_EMPTY_IOR = 1.0


@dataclasses.dataclass(frozen=True)
class Medium:
    """A batch of participating media ([N] fields, [N, 3] absorption)."""

    ior: torch.Tensor  # [N] float32
    absorption: torch.Tensor  # [N, 3] float32
    priority: torch.Tensor  # [N] int32
    material_id: torch.Tensor  # [N] int32

    @staticmethod
    def empty(n: int, device) -> "Medium":
        return Medium(
            ior=torch.full((n,), _EMPTY_IOR, device=device),
            absorption=torch.zeros((n, 3), device=device),
            priority=torch.full((n,), EMPTY_PRIORITY, dtype=torch.int32,
                                device=device),
            material_id=torch.full((n,), NO_MEDIUM_ID, dtype=torch.int32,
                                   device=device),
        )


def _expand(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask[..., None] if like.ndim == 3 else mask


@dataclasses.dataclass(frozen=True)
class MediumStack:
    """Per-ray medium stacks: [N, D] slots and an [N] size."""

    ior: torch.Tensor  # [N, D] float32
    absorption: torch.Tensor  # [N, D, 3] float32
    priority: torch.Tensor  # [N, D] int32
    material_id: torch.Tensor  # [N, D] int32
    size: torch.Tensor  # [N] int32

    @staticmethod
    def create(n: int, depth: int = STACK_DEPTH, *,
               device) -> "MediumStack":
        return MediumStack(
            ior=torch.full((n, depth), _EMPTY_IOR, device=device),
            absorption=torch.zeros((n, depth, 3), device=device),
            priority=torch.full((n, depth), EMPTY_PRIORITY,
                                dtype=torch.int32, device=device),
            material_id=torch.full((n, depth), NO_MEDIUM_ID,
                                   dtype=torch.int32, device=device),
            size=torch.zeros((n,), dtype=torch.int32, device=device),
        )

    @property
    def depth(self) -> int:
        return self.ior.shape[1]

    def _slots(self) -> torch.Tensor:
        return torch.arange(self.depth, dtype=torch.int32,
                            device=self.size.device)[None, :]  # [1, D]

    def top(self) -> Medium:
        """Highest-precedence medium, or the empty medium when the stack is
        empty (get_top_ray_medium, HalgoenCompute.compute:647-654)."""
        idx = torch.clamp_min(self.size - 1, 0)
        sel = self._slots() == idx[:, None]  # [N, D] one-hot
        nonempty = self.size > 0
        e = Medium.empty(self.size.shape[0], self.size.device)

        def pick(arr, empty_val):
            return torch.where(
                nonempty, torch.where(sel, arr, 0).sum(dim=1, dtype=arr.dtype),
                empty_val)

        absorb = torch.where(
            nonempty[:, None],
            torch.where(sel[..., None], self.absorption, 0.0).sum(dim=1),
            e.absorption)
        return Medium(ior=pick(self.ior, e.ior), absorption=absorb,
                      priority=pick(self.priority, e.priority),
                      material_id=pick(self.material_id, e.material_id))

    def is_true_hit(self, priority: torch.Tensor) -> torch.Tensor:
        """Priority rule (determine_true_medium_hit, compute:656-665)."""
        return (self.size == 0) | (priority <= self.top().priority)

    def push(self, medium: Medium, mask: torch.Tensor) -> "MediumStack":
        """Sorted insertion where `mask` (add_to_medium_stack,
        compute:582-622): at the top when its priority <= the top's
        (which covers the empty stack), else at the count of strictly
        greater entries. A full stack drops the push."""
        slots = self._slots()
        greater = (slots < self.size[:, None]) & (
            self.priority > medium.priority[:, None])
        idx_sorted = greater.sum(dim=1, dtype=torch.int32)
        at_top = medium.priority <= self.top().priority
        idx = torch.where(at_top, self.size, idx_sorted)
        can = mask & (self.size < self.depth)
        shift_up = (slots >= idx[:, None]) & can[:, None]
        write = (slots == idx[:, None]) & can[:, None]

        def place(arr, val):
            shifted = torch.where(_expand(shift_up, arr),
                                  torch.roll(arr, 1, dims=1), arr)
            val = val.to(arr.dtype)[:, None]
            return torch.where(_expand(write, arr), val, shifted)

        return MediumStack(
            ior=place(self.ior, medium.ior),
            absorption=place(self.absorption, medium.absorption),
            priority=place(self.priority, medium.priority),
            material_id=place(self.material_id, medium.material_id),
            size=self.size + can.to(torch.int32),
        )

    def pop_id(self, material_id: torch.Tensor,
               mask: torch.Tensor) -> "MediumStack":
        """Remove the lowest slot whose id is `material_id` where `mask`
        (pop_from_medium_stack, compute:627-642). A missing id is a
        no-op."""
        slots = self._slots()
        match = (slots < self.size[:, None]) & (
            self.material_id == material_id[:, None])
        found = match.any(dim=1)
        first = torch.argmax(match.to(torch.int32), dim=1).to(torch.int32)
        do = mask & found
        shift_down = (slots >= first[:, None]) & do[:, None]
        dead = (slots == (self.size - 1)[:, None]) & do[:, None]

        def remove(arr, fill):
            shifted = torch.where(_expand(shift_down, arr),
                                  torch.roll(arr, -1, dims=1), arr)
            return torch.where(_expand(dead, arr), fill, shifted)

        return MediumStack(
            ior=remove(self.ior, _EMPTY_IOR),
            absorption=remove(self.absorption, 0.0),
            priority=remove(self.priority, EMPTY_PRIORITY),
            material_id=remove(self.material_id, NO_MEDIUM_ID),
            size=self.size - do.to(torch.int32),
        )
