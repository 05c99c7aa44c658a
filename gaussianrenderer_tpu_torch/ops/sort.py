"""Sorting components (PyTorch port of ``ops/sort.py``): the packed-key
instance sort, the LSD radix composition and the harnesses' oracle.

* :func:`sort_packed` — the production path: the (tile, depth) key is one
  32-bit value ``(tile << depth_bits) | depth_q`` sorted with a stable
  ``torch.sort``, so instances tied on the key keep their emission order.
* :func:`radix_sort_u32` — an LSD radix composition: one stable sort on
  each ``digit_bits`` digit, lowest first. It is an independent
  implementation that the harnesses (``apps/radix_test``,
  ``apps/onesweep``) check the production sort against.
* :func:`sort_two_key` — the lexicographic (hi, lo) sort, the harnesses'
  oracle.

u32 values are carried in int64 tensors: torch has no unsigned shifts,
comparisons or sorts on uint32.
"""

from __future__ import annotations

from typing import Tuple

import torch

_U32 = 0xFFFFFFFF


def pack_key(
    tile_id: torch.Tensor, depth_q: torch.Tensor, depth_bits: int
) -> torch.Tensor:
    """``(tile << depth_bits) | depth`` as an int64 holding a u32 value."""
    return (tile_id.to(torch.int64) << depth_bits) | (
        depth_q.to(torch.int64) & ((1 << depth_bits) - 1)
    )


def unpack_key(key: torch.Tensor, depth_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(tile, depth)`` of a packed key: tile as int32, depth as int64
    holding the low ``depth_bits`` bits."""
    key = key.to(torch.int64)
    return (key >> depth_bits).to(torch.int32), key & ((1 << depth_bits) - 1)


def _permute(perm: torch.Tensor, tensors):
    return tuple(t[..., perm] for t in tensors)


def sort_packed(key: torch.Tensor, *payloads: torch.Tensor):
    """Stable single-key sort: returns ``(sorted_key, *payloads)`` with
    each payload's last axis permuted like the key."""
    key_sorted, perm = torch.sort(key, stable=True)
    return (key_sorted, *_permute(perm, payloads))


def sort_two_key(k_hi: torch.Tensor, k_lo: torch.Tensor, *payloads: torch.Tensor):
    """Lexicographic (hi, lo) sort — the oracle the harnesses compare to.
    Two stable passes (lo, then hi); returns ``(hi, lo, *payloads)``
    sorted, each in its own dtype."""
    _, perm = torch.sort(k_lo, stable=True)
    _, perm2 = torch.sort(k_hi[perm], stable=True)
    return _permute(perm[perm2], (k_hi, k_lo, *payloads))


def radix_sort_u32(
    keys: torch.Tensor,
    *payloads: torch.Tensor,
    total_bits: int = 32,
    digit_bits: int = 8,
):
    """LSD radix sort: ceil(total_bits/digit_bits) stable digit passes.

    Each pass is a stable sort on one digit alone, so the composition is
    sorted on the full key by the LSD invariant. The keys are taken as
    u32 (an int32 key wraps, as ``astype(uint32)`` does) and come back as
    int64; returns ``(keys, *payloads)``.
    """
    num_passes = -(-total_bits // digit_bits)
    mask = (1 << digit_bits) - 1
    ops = (keys.to(torch.int64) & _U32, *payloads)
    for p in range(num_passes):
        digit = (ops[0] >> (p * digit_bits)) & mask
        _, perm = torch.sort(digit, stable=True)
        ops = _permute(perm, ops)
    return ops


def is_nondecreasing(keys: torch.Tensor) -> torch.Tensor:
    """Monotonicity invariant check, as a 0-d bool tensor."""
    return torch.all(keys[1:] >= keys[:-1])
