"""Paged KV cache for the serving engine.

Port of src/repro/runtime/kv_cache.py.  The paged layout carves the cache
into fixed-size pages held in one shared pool per layer group:

    cache = {"len":   (B,) int32                    tokens written per slot
             "pages": (B, P_max) int32              per-slot page table
             group:   {"k": (Lg, n_pages, ps, KVH, hd), "v": ...}}

Page table entry p of a slot names the pool page holding positions
[p*ps, (p+1)*ps).  Page 0 is a reserved *trash* page: it is never
allocated, freed slots point their whole table at it, and idle slots'
decode writes land there.  The table is shared across layers.
Allocation is host-side (PageAllocator); a decode tick never allocates.

Install and free update the cache in place and return it (the reference
returns a new cache); other slots' pages are never touched.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

Params = Dict[str, Any]

TRASH_PAGE = 0


def pages_per_slot(max_len: int, page_size: int) -> int:
    return math.ceil(max_len / page_size)


def default_num_pages(batch: int, max_len: int, page_size: int) -> int:
    """Enough pages for every slot at full length, plus the trash page."""
    return 1 + batch * pages_per_slot(max_len, page_size)


def init_paged_cache(model, batch: int, max_len: int, page_size: int,
                     dtype=torch.float32, *, num_pages: int = 0) -> Params:
    """The paged cache for `model` (attention groups only), on the model's
    device: model.init_cache's (Lg, B, Smax, KVH, hd) entries with the
    (B, Smax) plane replaced by (n_pages, ps)."""
    cfg = model.cfg
    dev = model.device
    n_pages = num_pages or default_num_pages(batch, max_len, page_size)
    p_max = pages_per_slot(max_len, page_size)
    cache: Params = {
        "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "pages": torch.full((batch, p_max), TRASH_PAGE, dtype=torch.int32,
                            device=dev),
    }
    for g in model.groups:
        if g.name == "enc":
            continue
        if g.kind == "ssm" or g.cross:
            raise NotImplementedError(
                "paged serving supports self-attention caches only "
                f"(group {g.name!r} is {g.kind}"
                f"{', cross' if g.cross else ''})")
        shape = (g.size, n_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
        cache[g.name] = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                         "v": torch.zeros(shape, dtype=dtype, device=dev)}
    return cache


class PageAllocator:
    """Host-side free list over pool pages 1..n_pages-1 (0 is trash)."""

    def __init__(self, n_pages: int):
        self.n_pages = int(n_pages)
        self._free: List[int] = list(range(self.n_pages - 1, 0, -1))

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"KV page pool exhausted: need {n} pages, "
                f"{len(self._free)} free of {self.n_pages - 1}")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: Sequence[int]):
        for p in pages:
            if not 0 < p < self.n_pages:
                raise ValueError(f"freeing invalid page id {p}")
        self._free.extend(pages)


def page_row(pages: Sequence[int], p_max: int) -> np.ndarray:
    """Pad an allocated page list to a full (P_max,) table row (trash-page
    padded), built host-side at admission."""
    row = np.full((p_max,), TRASH_PAGE, np.int32)
    row[:len(pages)] = np.asarray(pages, np.int32)
    return row


# -- slot install / free ------------------------------------------------------


def install_slot_paged(cache: Params, slot: int, temp: Params, row,
                       true_len: int) -> Params:
    """Scatter a prefilled temp cache (lead (1,), length `bucket`) into the
    paged cache at `slot`, in place.

    temp: model.init_cache((1,), bucket) after prefill, bucket % ps == 0.
    row: (P_max,) int32 page table row (`page_row`).  The first bucket//ps
    entries receive data; later entries keep whatever the pool holds.
    Positions in [true_len, bucket) carry prefill padding and are masked
    by cache_len = true_len."""
    row_t = torch.as_tensor(np.asarray(row, np.int32),
                            device=cache["pages"].device)
    for gname, gc in cache.items():
        if gname in ("len", "pages"):
            continue
        ps = gc["k"].shape[2]
        bucket = temp[gname]["k"].shape[2]
        if bucket % ps:
            raise ValueError(
                f"prefill bucket {bucket} not a multiple of page size {ps}")
        n_inst = bucket // ps
        pages = torch.clamp(row_t[:n_inst], 0, gc["k"].shape[1] - 1).long()
        for leaf in ("k", "v"):
            lg = gc[leaf].shape[0]
            kvh, hd = gc[leaf].shape[-2:]
            tk = temp[gname][leaf].reshape(lg, n_inst, ps, kvh, hd)
            gc[leaf][:, pages] = tk.to(gc[leaf].dtype)
    cache["pages"][slot] = row_t
    cache["len"][slot] = int(true_len)
    return cache


def install_slot_contiguous(cache: Params, slot: int, temp: Params,
                            true_len: int) -> Params:
    """Copy a prefilled temp cache (lead (1,), length `bucket`) into slot
    `slot` of a contiguous model.init_cache((B,), Smax) cache, in place."""
    for gname, gc in cache.items():
        if gname == "len":
            continue
        for leaf in ("k", "v"):
            src = temp[gname][leaf][:, 0]              # (Lg, bucket, KVH, hd)
            gc[leaf][:, slot, :src.shape[1]] = src.to(gc[leaf].dtype)
    cache["len"][slot] = int(true_len)
    return cache


def free_slot(cache: Params, slot: int) -> Params:
    """Release a slot in place: len -> 0, page table -> trash.  Pool pages
    are not wiped; the allocator recycles them and the next install
    overwrites them."""
    cache["len"][slot] = 0
    if "pages" in cache:
        cache["pages"][slot] = TRASH_PAGE
    return cache


def gather_contiguous(cache: Params) -> Params:
    """Materialize the paged cache as a contiguous view
    {"len", group: {"k": (Lg, B, P_max*ps, KVH, hd), ...}}: the parity
    bridge between the paged and contiguous decode paths (tests)."""
    out: Params = {"len": cache["len"]}
    pt = cache["pages"]
    for gname, gc in cache.items():
        if gname in ("len", "pages"):
            continue
        idx = torch.clamp(pt, 0, gc["k"].shape[1] - 1).long()   # (B, P_max)
        og = {}
        for leaf in ("k", "v"):
            lg, _, ps, kvh, hd = gc[leaf].shape
            g = gc[leaf][:, idx]                      # (Lg,B,Pm,ps,KVH,hd)
            og[leaf] = g.reshape(lg, idx.shape[0], idx.shape[1] * ps,
                                 kvh, hd)
        out[gname] = og
    return out
