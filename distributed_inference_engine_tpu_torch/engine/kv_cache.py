"""Slotted dense KV cache with a free-list slot allocator (port of
``engine/kv_cache.py``).

The layout is slot-contiguous, ``[n_layers, max_slots, max_seq, n_kv_heads,
head_dim]``: each live sequence owns one slot row, recycled through a free
list. The JAX class swaps in the arrays a jitted step returns; here the
tensors are written in place (``write_prefill``), and ``swap`` adopts
tensors a caller built elsewhere. The caches come from
``models/base.py:dense_kv_cache``, so ``forward_decode`` and
``forward_window`` can drop their out-of-range writes into the spare row.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..models.base import ModelSpec, dense_kv_cache, kv_torch_dtype
from ..ops.attention import astype_kv, raw_view


class SlotKVCache:
    """Fixed-capacity slotted KV cache + free-list slot allocator."""

    def __init__(self, spec: ModelSpec, max_slots: int,
                 max_seq_len: Optional[int] = None,
                 dtype: Optional[str] = None, device="cuda") -> None:
        self.spec = spec
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len or spec.max_seq_len
        self.dtype = kv_torch_dtype(dtype) if dtype else spec.torch_dtype
        shape = (spec.n_layers, max_slots, self.max_seq_len,
                 spec.n_kv_heads, spec.head_dim)
        self.k = dense_kv_cache(shape, self.dtype, device)
        self.v = dense_kv_cache(shape, self.dtype, device)
        self._free: List[int] = list(range(max_slots))
        self._live: Dict[int, str] = {}          # slot -> request_id

    # -------------------------------------------------------------- slots

    def alloc(self, request_id: str) -> Optional[int]:
        """Claim a slot for a request; None when full (caller queues)."""
        if not self._free:
            return None
        slot = self._free.pop(0)
        self._live[slot] = request_id
        return slot

    def free(self, slot: int) -> None:
        if slot in self._live:
            del self._live[slot]
            self._free.append(slot)

    def reset(self) -> None:
        self._free = list(range(self.max_slots))
        self._live = {}

    @property
    def live_slots(self) -> Dict[int, str]:
        return dict(self._live)

    @property
    def n_free(self) -> int:
        return len(self._free)

    # ------------------------------------------------------------- device

    def write_prefill(self, ks: torch.Tensor, vs: torch.Tensor,
                      slots) -> None:
        """Write prefilled K/V ``[L, B, T, Hkv, Dh]`` into positions ``[0,
        T)`` of slot rows ``slots`` [B] (in place, the JAX cast)."""
        t = ks.shape[2]
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.k.device)
        for cache, fresh in ((self.k, ks), (self.v, vs)):
            raw_view(cache)[:, idx, :t] = raw_view(astype_kv(fresh,
                                                             self.dtype))

    def swap(self, new_k: torch.Tensor, new_v: torch.Tensor) -> None:
        """Adopt cache tensors built elsewhere (``dense_kv_cache``)."""
        self.k, self.v = new_k, new_v

    # -------------------------------------------------------------- stats

    def get_stats(self) -> Dict[str, float]:
        bytes_total = 2 * self.k.numel() * self.k.element_size()
        return {
            "max_slots": self.max_slots,
            "live_slots": len(self._live),
            "free_slots": len(self._free),
            "utilization": (len(self._live) / self.max_slots
                            if self.max_slots else 0.0),
            "hbm_bytes": bytes_total,
            "hbm_gib": bytes_total / (1 << 30),
            "max_seq_len": self.max_seq_len,
        }
