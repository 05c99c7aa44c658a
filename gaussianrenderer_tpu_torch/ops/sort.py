"""Packed-key instance sort (PyTorch port of ``ops/sort.py``'s
production path).

The (tile, depth) key is one 32-bit value ``(tile << depth_bits) |
depth_q``, carried in an int64 tensor (torch has no unsigned shifts or
sorts on uint32), and sorted with a stable ``torch.sort`` so instances
tied on the key keep their emission order.
"""

from __future__ import annotations

import torch


def pack_key(
    tile_id: torch.Tensor, depth_q: torch.Tensor, depth_bits: int
) -> torch.Tensor:
    """``(tile << depth_bits) | depth`` as an int64 holding a u32 value."""
    return (tile_id.to(torch.int64) << depth_bits) | (
        depth_q.to(torch.int64) & ((1 << depth_bits) - 1)
    )


def sort_packed(key: torch.Tensor, *payloads: torch.Tensor):
    """Stable single-key sort: returns ``(sorted_key, *payloads)`` with
    each payload's last axis permuted like the key."""
    key_sorted, perm = torch.sort(key, stable=True)
    return (key_sorted, *(p[..., perm] for p in payloads))
