"""Paged KV cache: page pools on the device plus host page accounting
(port of ``engine/paged_kv.py``, without the host-RAM offload tier).

- Host: free list, per-slot page lists, refcounts and the prefix index
  of full prompt pages keyed by chain hash — the JAX logic, line for line.
- Device: pools ``[L, N, P, Hkv*Dh]`` in fp32, bf16, e4m3 or e5m2 (one byte an
  element: half bf16's, ``get_stats()["hbm_bytes"]``), written in place,
  each with one drop row after its last page (``k_rows``/``v_rows``, the
  target of masked writes: ``models/base.py:write_pages_device``), and one
  int32 ``page_table`` ``[max_slots, max_pages_per_seq]`` refreshed in
  place only when host accounting changes, so a CUDA graph that read it
  reads the current table on every replay.

``page_chain_hashes`` is byte-identical to the JAX function: the
coordinator's prefix-affinity key is built from it, so a mixed fleet of
JAX and PyTorch workers must agree on it.
"""

from __future__ import annotations

import collections
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.base import ModelSpec, kv_torch_dtype, pages_with_drop_row
from ..ops import _cuda


def page_chain_hashes(tokens, n_pages: int, page_size: int) -> List[bytes]:
    """Chain hashes for the first ``n_pages`` FULL pages of ``tokens``:
    hash_i commits to tokens[0 : (i+1)·P] (blake2b-128 over the previous
    hash and the page's int64 token bytes)."""
    out: List[bytes] = []
    h = b""
    for i in range(n_pages):
        chunk = np.asarray(tokens[i * page_size: (i + 1) * page_size],
                           np.int64).tobytes()
        h = hashlib.blake2b(h + chunk, digest_size=16).digest()
        out.append(h)
    return out


class PagedKVCache:
    """Host-side page allocator + device page pools for one model."""

    def __init__(self, spec: ModelSpec, max_slots: int, page_size: int = 128,
                 num_pages: int = 512, max_seq_len: Optional[int] = None,
                 dtype: Optional[str] = None, device="cuda") -> None:
        fused = spec.n_kv_heads * spec.head_dim
        if fused % 128:
            # the JAX cache's rule (its TPU lane width), kept so that both
            # engines take the same specs
            raise ValueError(
                f"n_kv_heads*head_dim = {fused} must be a multiple of 128 "
                "for the paged layout (TPU lane alignment)")
        self.spec = spec
        self.max_slots = max_slots
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_seq_len = max_seq_len or spec.max_seq_len
        self.max_pages_per_seq = -(-self.max_seq_len // page_size)
        self.dtype = kv_torch_dtype(dtype) if dtype else spec.torch_dtype
        self.device = torch.device(device)
        shape = (spec.n_layers, num_pages, page_size, fused)
        self.k_pages, self.k_rows = pages_with_drop_row(shape, self.dtype,
                                                        self.device)
        self.v_pages, self.v_rows = pages_with_drop_row(shape, self.dtype,
                                                        self.device)

        self._free: List[int] = list(range(num_pages))
        self._slot_pages: Dict[int, List[int]] = {}
        self._slot_len: Dict[int, int] = {}
        self._free_slots: List[int] = list(range(max_slots))
        self._table = np.zeros((max_slots, self.max_pages_per_seq), np.int32)
        self._table_dirty = True
        self._table_dev = torch.zeros(self._table.shape, dtype=torch.int32,
                                      device=self.device)
        self._peak_pages_used = 0

        # prefix cache: shared full pages keyed by their chain hash
        self._page_ref: Dict[int, int] = {}
        self._prefix_index: Dict[bytes, int] = {}
        self._page_key: Dict[int, bytes] = {}
        # registered pages with refcount 0: reusable on a hit, reclaimed
        # oldest first when the free list runs dry
        self._reclaimable: "collections.OrderedDict[int, None]" = (
            collections.OrderedDict())
        self._prefix_hits_pages = 0
        self._prefix_hits_tokens = 0
        self._prefix_queries = 0
        self._prefix_reclaimed = 0

    # ------------------------------------------------------- page sourcing

    @property
    def available_pages(self) -> int:
        return len(self._free) + len(self._reclaimable)

    def _take_free(self, n: int) -> Optional[List[int]]:
        """Source ``n`` writable pages (refcount 1 each): free list first,
        then the oldest cached-but-unreferenced prefix pages."""
        if n <= 0:
            return []
        if self.available_pages < n:
            return None
        out: List[int] = []
        while len(out) < n and self._free:
            out.append(self._free.pop(0))
        while len(out) < n:
            page, _ = self._reclaimable.popitem(last=False)
            key = self._page_key.pop(page)
            self._prefix_index.pop(key, None)
            self._prefix_reclaimed += 1
            out.append(page)
        for p in out:
            self._page_ref[p] = 1
        used = self.num_pages - len(self._free) - len(self._reclaimable)
        self._peak_pages_used = max(self._peak_pages_used, used)
        return out

    def _unref(self, page: int) -> None:
        self._page_ref[page] -= 1
        if self._page_ref[page] > 0:
            return
        del self._page_ref[page]
        if page in self._page_key:
            self._reclaimable[page] = None
            self._reclaimable.move_to_end(page)
        else:
            self._free.append(page)

    # ------------------------------------------------------------ slots

    def alloc_slot(self, n_tokens: int) -> Optional[int]:
        if not self._free_slots:
            return None
        pages = self._take_free(self._pages_for(n_tokens))
        if pages is None:
            return None
        return self._install_slot_pages(pages, n_tokens)

    def _install_slot_pages(self, pages: List[int], n_tokens: int) -> int:
        slot = self._free_slots.pop(0)
        self._slot_pages[slot] = pages
        self._slot_len[slot] = n_tokens
        self._table[slot, : len(pages)] = pages
        self._table[slot, len(pages):] = 0
        self._table_dirty = True
        return slot

    def reserve(self, slot: int, n_tokens: int) -> int:
        """Grow the slot by up to ``n_tokens`` tokens of capacity; returns
        the tokens granted (less at ``max_seq_len``, 0 when the pool can't
        cover it)."""
        if slot not in self._slot_pages:
            raise KeyError(f"slot {slot} not live")
        total = min(self._slot_len[slot] + n_tokens, self.max_seq_len)
        granted = total - self._slot_len[slot]
        if granted <= 0:
            return 0
        need = self._pages_for(total) - len(self._slot_pages[slot])
        if need <= 0:
            self._slot_len[slot] = total
            return granted
        pages = self._take_free(need)
        if pages is None:
            return 0
        cur = self._slot_pages[slot]
        self._table[slot, len(cur): len(cur) + len(pages)] = pages
        cur.extend(pages)
        self._slot_len[slot] = total
        self._table_dirty = True
        return granted

    def ensure_capacity(self, slot: int, total_tokens: int) -> int:
        """Best-effort growth toward ``total_tokens``; returns the slot's
        token capacity (clamped to ``max_seq_len``)."""
        if slot not in self._slot_pages:
            raise KeyError(f"slot {slot} not live")
        target = min(total_tokens, self.max_seq_len)
        pages = self._slot_pages[slot]
        need = self._pages_for(target) - len(pages)
        take = min(max(need, 0), self.available_pages)
        if take > 0:
            fresh = self._take_free(take)
            assert fresh is not None
            self._table[slot, len(pages): len(pages) + take] = fresh
            pages.extend(fresh)
            self._table_dirty = True
        cap = min(len(pages) * self.page_size, self.max_seq_len)
        self._slot_len[slot] = max(self._slot_len[slot], min(target, cap))
        return cap

    def ensure_backed(self, slot: int, n_tokens: int) -> None:
        """Assert the slot's first ``n_tokens`` positions have pages."""
        if slot not in self._slot_pages:
            raise KeyError(f"slot {slot} not live")
        backed = len(self._slot_pages[slot]) * self.page_size
        if backed < n_tokens:
            raise RuntimeError(
                f"slot {slot} backed for {backed} tokens but a write "
                f"reaches {n_tokens}")

    def free_slot(self, slot: int) -> None:
        pages = self._slot_pages.pop(slot, None)
        if pages is None:
            return
        for p in pages:
            self._unref(p)
        del self._slot_len[slot]
        self._free_slots.append(slot)
        self._table[slot, :] = 0
        self._table_dirty = True

    def _pages_for(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.page_size))

    # ----------------------------------------------------- prefix caching

    def _page_hashes(self, tokens, n_pages: int) -> List[bytes]:
        return page_chain_hashes(tokens, n_pages, self.page_size)

    def first_page_hash(self, tokens, registerable: bool = False
                        ) -> Optional[bytes]:
        """Chain hash of the prompt's first full page (None without one);
        ``registerable`` uses the register bound (``len // P``), the
        default the match bound (``(len - 1) // P``)."""
        n_full = (len(tokens) if registerable
                  else len(tokens) - 1) // self.page_size
        if n_full < 1:
            return None
        return self._page_hashes(tokens, 1)[0]

    def alloc_slot_prefix(self, tokens) -> Optional[Tuple[int, int]]:
        """Claim a slot reusing cached pages for the prompt's longest
        indexed full-page prefix -> (slot, n_cached_tokens), or None. At
        most ``len(tokens) - 1`` tokens come from cache."""
        if not self._free_slots:
            return None
        n_tokens = len(tokens)
        self._prefix_queries += 1
        matchable = (n_tokens - 1) // self.page_size
        shared: List[int] = []
        for h in self._page_hashes(tokens, matchable):
            page = self._prefix_index.get(h)
            if page is None:
                break
            shared.append(page)
        # pin the shared pages BEFORE sourcing fresh ones, or a reclaim
        # under pressure could hand one back as this slot's suffix page
        for p in shared:
            self._page_ref[p] = self._page_ref.get(p, 0) + 1
            self._reclaimable.pop(p, None)
        fresh = self._take_free(self._pages_for(n_tokens) - len(shared))
        if fresh is None:
            for p in shared:
                self._unref(p)
            return None
        slot = self._install_slot_pages(shared + fresh, n_tokens)
        n_cached = len(shared) * self.page_size
        self._prefix_hits_pages += len(shared)
        self._prefix_hits_tokens += n_cached
        return slot, n_cached

    def register_prefix(self, slot: int, tokens) -> int:
        """Index this slot's full prompt pages for reuse (after their KV
        is written); returns how many pages were newly registered."""
        pages = self._slot_pages.get(slot)
        if pages is None:
            raise KeyError(f"slot {slot} not live")
        n_full = len(tokens) // self.page_size
        fresh = 0
        for i, h in enumerate(self._page_hashes(tokens, n_full)):
            if h in self._prefix_index:
                continue
            page = pages[i]
            if page in self._page_key:
                continue
            self._prefix_index[h] = page
            self._page_key[page] = h
            fresh += 1
        return fresh

    # ----------------------------------------------------------- device

    @property
    def page_table(self) -> torch.Tensor:
        """The device table: one tensor for the cache's lifetime, refreshed
        in place (one host-to-device copy, queued behind the work before
        it) only after host changes."""
        if self._table_dirty:
            _cuda.upload_into(self._table_dev, self._table)
            self._table_dirty = False
        return self._table_dev

    # ------------------------------------------------------------ stats

    def slot_capacity(self, slot: int) -> int:
        return len(self._slot_pages[slot]) * self.page_size

    def get_stats(self) -> Dict[str, float]:
        bytes_total = 2 * self.k_pages.numel() * self.k_pages.element_size()
        used = self.num_pages - len(self._free) - len(self._reclaimable)
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "pages_used": used,
            "pages_free": len(self._free),
            "pages_cached": len(self._reclaimable),
            "peak_pages_used": self._peak_pages_used,
            "utilization": used / self.num_pages if self.num_pages else 0.0,
            "live_slots": len(self._slot_pages),
            "free_slots": len(self._free_slots),
            "prefix_queries": self._prefix_queries,
            "prefix_hit_pages": self._prefix_hits_pages,
            "prefix_hit_tokens": self._prefix_hits_tokens,
            "prefix_reclaimed": self._prefix_reclaimed,
            "prefix_indexed": len(self._prefix_index),
            "hbm_bytes": bytes_total,
            "hbm_gib": bytes_total / (1 << 30),
        }
