"""Continuous-batching, multi-adapter serving engine.

Port of src/repro/runtime/serving.py.  Every client's fine-tuned adapter
is a separate model sharing all base weights; the engine holds the
stacked adapter pool (S-LoRA-style) and batches requests across adapters:

  * B fixed slots, each holding at most one in-flight request;
  * an admission queue: a request waits until a slot (and, in paged mode,
    enough KV pages) frees up;
  * per-request prefill into a small bucketed temp cache, installed into
    the slot;
  * one decode tick advances every occupied slot by one token; the
    per-slot adapter choice rides a (B,) ids tensor through the indexed
    LoRA kernel.

SSM and hybrid models (mamba2, zamba2) are served one level down, as
in the reference: ``serial_reference`` runs ``Model.prefill`` and
``Model.decode_step`` one request at a time, their conv windows and SSD
states in the model's cache, through the indexed pool.  The engine
refuses them, as the reference's engine cannot serve them: it installs
only k/v into a slot and pads each prompt to a bucket.  The audio family
(whisper) is served the same way, with each request's encoder frames in
its prefill batch (``Model.prefill``, then ``decode_step`` against the
cross cache); the engine refuses it too, since the reference's engine
passes only tokens to the prefill and has no cross cache in its slots
(``check_engine_serves``).

PyTorch runs eagerly, so the reference's retrace counters have no
counterpart here; the kernel wrappers' launch counters show which kernels
a run went through.  ``pool_from_state`` serves the per-client adapters
of a training state (a SplitFTSystem, or its checkpoint through
``launch/serve.py --ckpt``), ``pool_from_population`` those of chosen
pids of a population run's store.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import lora as lora_lib, split as split_lib
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import build_groups
from repro_torch.runtime import kv_cache

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Adapter pools


def attach_ids(pool: Params, ids) -> Params:
    """Augment the stacked pool {group:{target:{"A":(Lg,P,din,r),...}}}
    with a per-row adapter-id leaf (Lg, B), the layout lora_apply
    dispatches on."""
    out: Params = {}
    idt = None
    for gname, targets in pool.items():
        out[gname] = {}
        for tname, ad in targets.items():
            if idt is None:     # one host-to-device copy per call
                idt = torch.as_tensor(ids, dtype=torch.int32,
                                      device=ad["A"].device)
            lg = ad["A"].shape[0]
            out[gname][tname] = dict(ad, ids=idt[None].expand(
                (lg,) + tuple(idt.shape)))
    return out


def build_adapter_pool(model, generator: torch.Generator, num_adapters: int,
                       *, ranks=None, dtype=torch.float32) -> Params:
    """Random stacked pool: P distinct adapters at max rank, optionally
    rank-masked per adapter (ranks: (P,) ints, the heterogeneous-rank
    case as masked slots).  init_adapters starts B at zero; it is perturbed
    with 0.02 N(0, 1) so the P adapters give distinct outputs."""
    ad = lora_lib.init_adapters(model, generator, num_clients=num_adapters,
                                dtype=dtype)
    for targets in ad.values():
        for leaves in targets.values():
            leaves["B"] = (0.02 * torch.randn(leaves["B"].shape,
                                              generator=generator)
                           ).to(dtype).to(model.device)
    m = model.num_flat_layers
    if ranks is None:
        rank_arr = torch.full((num_adapters, m), model.arch.lora.r_others,
                              dtype=torch.int32)
    else:
        rank_arr = torch.as_tensor(ranks, dtype=torch.int32)[:, None] \
            .expand(num_adapters, m)
    return lora_lib.mask_adapters(model, ad, rank_arr)


def pool_from_state(model, state: Params) -> Params:
    """The per-client personalized adapters of a SplitFT training state
    as a serving pool (P = N clients): merge_adapters already gives the
    apply-ready client-axis tree, so the pool is the training layout."""
    with torch.no_grad():
        return split_lib.merge_adapters(
            model, state["client_adapters"], state["server_adapters"],
            state["cuts"], rank_cut=state.get("rank_cut"))


def pool_head(pool: Params, n: int) -> Params:
    """The pool's first n adapters."""
    return {g: {t: {k: v[:, :n] for k, v in ad.items()}
                for t, ad in targets.items()}
            for g, targets in pool.items()}


def pool_from_population(model, state: Params, store, pids: Sequence[int]
                         ) -> Params:
    """Serve chosen population members: gather their adapter rows from
    the PopulationStore's slots into the engine state's client axis, then
    build the pool for exactly those pids (row i serves pids[i])."""
    pids = [int(p) for p in pids]
    n = len(pids)
    if n > store.cohort:
        raise ValueError(
            f"{n} pids exceed the store's client axis ({store.cohort}); "
            "serve in groups of at most the training cohort size")
    padded = pids + [pids[-1]] * (store.cohort - n)
    return pool_head(pool_from_state(model, store.gather(state, padded)), n)


def num_pool_adapters(pool: Params) -> int:
    for targets in pool.values():
        for leaves in targets.values():
            return leaves["A"].shape[1]
    raise ValueError("empty adapter pool")


# ---------------------------------------------------------------------------
# Requests / config


@dataclasses.dataclass
class Request:
    rid: int
    adapter: int                 # pool row
    tokens: np.ndarray           # (prompt_len,) int32
    max_new: int
    arrival: float = 0.0         # seconds from run() start


@dataclasses.dataclass
class ServeConfig:
    num_slots: int = 4
    max_len: int = 128           # per-slot KV capacity (prompt + generated)
    page_size: int = 0           # 0 = contiguous per-slot cache
    prompt_buckets: Tuple[int, ...] = ()   # default: doubling up to max_len

    def buckets(self) -> Tuple[int, ...]:
        if self.prompt_buckets:
            return tuple(sorted(self.prompt_buckets))
        lo = self.page_size if self.page_size else 8
        # paged: buckets are whole pages, so the top one rounds max_len up
        # (prompts are still capacity-checked against max_len itself)
        top = (math.ceil(self.max_len / self.page_size) * self.page_size
               if self.page_size else self.max_len)
        out = []
        b = lo
        while b < top:
            out.append(b)
            b *= 2
        out.append(top)
        return tuple(out)


# ---------------------------------------------------------------------------
# Engine


def check_engine_serves(arch) -> None:
    """Raises NotImplementedError for the configs (ArchConfig)
    ServingEngine does not serve, as the reference's engine cannot: SSM
    and hybrid models (recurrent caches) and the audio family (encoder
    frames)."""
    if any(g.kind == "ssm" for g in build_groups(arch.model)):
        raise NotImplementedError(
            f"{arch.name}: ServingEngine serves attention caches "
            "only, as the reference's engine does: it installs only k/v "
            "into a slot and pads each prompt to a bucket, which would "
            "run the pad tokens through the SSM recurrence.  Serve SSM "
            "and hybrid models with serial_reference (Model.prefill and "
            "decode_step, one request at a time)")
    if arch.model.family == "audio":
        raise NotImplementedError(
            f"{arch.name}: ServingEngine serves decoder-only models, "
            "as the reference's engine does: its requests carry tokens "
            "only and its slots hold no cross-attention cache, so it has "
            "no encoder frames to prefill.  Serve the audio family with "
            "Model.prefill (a batch with \"frames\") and Model.decode_step")


class ServingEngine:
    """Slot scheduler + prefill/decode over a stacked adapter pool.

    All sampling is greedy (argmax): the parity contract with the serial
    single-adapter reference is exact-token equality.  `device` defaults
    to the card and must be the model's device."""

    def __init__(self, model, params: Params, pool: Params,
                 cfg: ServeConfig, dtype=torch.float32,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        mcfg = model.cfg
        check_engine_serves(model.arch)
        if mcfg.learned_pos and cfg.max_len > mcfg.max_position_embeddings:
            raise ValueError(
                f"max_len={cfg.max_len} exceeds the learned position table "
                f"({mcfg.max_position_embeddings} rows)")
        self.model = model
        self.params = params
        self.pool = pool
        self.cfg = cfg
        self.dtype = dtype
        self.num_adapters = num_pool_adapters(pool)
        if cfg.page_size:
            if any(b % cfg.page_size for b in cfg.buckets()):
                raise ValueError(
                    f"prompt buckets {cfg.buckets()} must be multiples of "
                    f"page_size={cfg.page_size}")
            self._n_pages = kv_cache.default_num_pages(
                cfg.num_slots, cfg.max_len, cfg.page_size)
            self.cache = kv_cache.init_paged_cache(
                model, cfg.num_slots, cfg.max_len, cfg.page_size, dtype,
                num_pages=self._n_pages)
            self.allocator = kv_cache.PageAllocator(self._n_pages)
            self._p_max = kv_cache.pages_per_slot(cfg.max_len,
                                                  cfg.page_size)
        else:
            self.cache = model.init_cache((cfg.num_slots,), cfg.max_len,
                                          dtype)
            self.allocator = None
        self.slots: List[Optional[Dict[str, Any]]] = [None] * cfg.num_slots
        self.queue: deque = deque()
        self.results: Dict[int, Dict[str, Any]] = {}
        self._clock: Optional[Callable[[], float]] = None

    def _stamp(self, now: float) -> float:
        """Time for t_first / t_done: the run clock read after the token
        is on the host, else the caller's `now`."""
        return self._clock() if self._clock is not None else now

    @torch.no_grad()
    def _decode(self, ids, toks, active):
        adapters = attach_ids(self.pool, ids)
        logits, cache = self.model.decode_step(self.params, adapters, toks,
                                               self.cache)
        nxt = torch.argmax(logits[:, -1, :], -1).to(torch.int32)
        # freed/idle slots must not accumulate length (their writes go to
        # position 0 / the trash page and are never read)
        cache["len"] = torch.where(active, cache["len"],
                                   torch.zeros_like(cache["len"]))
        self.cache = cache
        return nxt

    @torch.no_grad()
    def _prefill(self, aid: int, toks, plen: int):
        bucket = toks.shape[1]
        temp = self.model.init_cache((1,), bucket, self.dtype)
        x, _, temp = self.model.forward(
            self.params, attach_ids(self.pool, [aid]), {"tokens": toks},
            cache=temp, mode="prefill")
        # logits at the true last prompt position, not the bucket pad
        logits = self.model.head(self.params, x[:, plen - 1:plen])
        return int(torch.argmax(logits[0, -1], -1)), temp

    # -- admission -------------------------------------------------------

    def bucket_for(self, plen: int) -> int:
        for b in self.cfg.buckets():
            if b >= plen:
                return b
        raise ValueError(f"prompt length {plen} exceeds max bucket "
                         f"{self.cfg.buckets()[-1]}")

    def submit(self, req: Request, *, now: float = 0.0):
        """Enqueue a request.  Raises immediately if the request can never
        fit the per-slot cache (truncating would corrupt the generation)."""
        plen = int(np.asarray(req.tokens).shape[-1])
        total = plen + req.max_new
        if plen < 1 or req.max_new < 1:
            raise ValueError(f"request {req.rid}: empty prompt or "
                             "non-positive max_new")
        if total > self.cfg.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({plen}) + max_new "
                f"({req.max_new}) = {total} exceeds the per-slot KV "
                f"capacity max_len={self.cfg.max_len}; raise --max-len or "
                "shorten the request")
        if not 0 <= req.adapter < self.num_adapters:
            raise ValueError(f"request {req.rid}: adapter {req.adapter} "
                             f"outside pool of {self.num_adapters}")
        self.queue.append(req)
        self.results[req.rid] = {
            "rid": req.rid, "adapter": req.adapter, "prompt_len": plen,
            "max_new": req.max_new, "t_submit": now,
            "t_first": None, "t_done": None, "tokens": None}

    def _free_slot_ids(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def _admit(self, now: float) -> bool:
        admitted = False
        free = self._free_slot_ids()
        while self.queue and free:
            req = self.queue[0]
            plen = int(np.asarray(req.tokens).shape[-1])
            bucket = self.bucket_for(plen)
            pages: List[int] = []
            if self.allocator is not None:
                ps = self.cfg.page_size
                n_alloc = max(math.ceil((plen + req.max_new) / ps),
                              bucket // ps)
                if n_alloc > self.allocator.available:
                    break      # wait for completions to release pages
                pages = self.allocator.alloc(n_alloc)
            self.queue.popleft()
            slot = free.pop(0)
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :plen] = np.asarray(req.tokens, np.int32)
            tok0, temp = self._prefill(
                req.adapter, torch.as_tensor(toks, device=self.device), plen)
            if self.allocator is not None:
                kv_cache.install_slot_paged(
                    self.cache, slot, temp,
                    kv_cache.page_row(pages, self._p_max), plen)
            else:
                kv_cache.install_slot_contiguous(self.cache, slot, temp,
                                                 plen)
            self.results[req.rid]["t_first"] = self._stamp(now)
            state = {"rid": req.rid, "aid": req.adapter, "last": tok0,
                     "gen": [tok0], "remaining": req.max_new - 1,
                     "pages": pages}
            self.slots[slot] = state
            admitted = True
            if state["remaining"] == 0:
                self._finish(slot, now)
        return admitted

    # -- decode ----------------------------------------------------------

    def _finish(self, slot: int, now: float):
        state = self.slots[slot]
        res = self.results[state["rid"]]
        res["tokens"] = list(state["gen"])
        res["t_done"] = self._stamp(now)
        kv_cache.free_slot(self.cache, slot)
        if self.allocator is not None and state["pages"]:
            self.allocator.free(state["pages"])
        self.slots[slot] = None

    def step(self, now: float = 0.0) -> bool:
        """One engine iteration: admit what fits, then one decode tick
        over all occupied slots.  Returns whether anything ran."""
        admitted = self._admit(now)
        occupied = [i for i, s in enumerate(self.slots) if s is not None]
        if not occupied:
            return admitted
        b = self.cfg.num_slots
        toks = np.zeros((b, 1), np.int32)
        ids = np.zeros((b,), np.int32)
        active = np.zeros((b,), bool)
        for i in occupied:
            toks[i, 0] = self.slots[i]["last"]
            ids[i] = self.slots[i]["aid"]
            active[i] = True
        nxt = self._decode(torch.as_tensor(ids, device=self.device),
                           torch.as_tensor(toks, device=self.device),
                           torch.as_tensor(active, device=self.device))
        nxt = nxt.cpu().numpy()
        for i in occupied:
            s = self.slots[i]
            tok = int(nxt[i])
            s["gen"].append(tok)
            s["last"] = tok
            s["remaining"] -= 1
            if s["remaining"] <= 0:
                self._finish(i, now)
        return True

    # -- run loop --------------------------------------------------------

    def run(self, requests: Sequence[Request]) -> List[Dict[str, Any]]:
        """Serve a workload honoring per-request arrival offsets; returns
        per-request result dicts (tokens + timing) ordered by rid.

        t_first and t_done are read from the run clock once the token is
        on the host, so TTFT includes the prefill (the reference stamps
        the start of the engine step instead)."""
        reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
        t0 = time.perf_counter()
        self._clock = lambda: time.perf_counter() - t0
        try:
            i = 0
            while i < len(reqs) or self.has_work():
                now = time.perf_counter() - t0
                while i < len(reqs) and reqs[i].arrival <= now:
                    self.submit(reqs[i], now=now)
                    i += 1
                ran = self.step(now=time.perf_counter() - t0)
                if not ran and not self.has_work() and i < len(reqs):
                    wait = reqs[i].arrival - (time.perf_counter() - t0)
                    if wait > 0:
                        time.sleep(min(wait, 0.002))
        finally:
            self._clock = None
        return [self.results[r.rid]
                for r in sorted(requests, key=lambda r: r.rid)]


# ---------------------------------------------------------------------------
# Serial reference (the parity contract)


@torch.no_grad()
def serial_reference(model, params: Params, pool: Params,
                     requests: Sequence[Request], *, max_len: int,
                     dtype=torch.float32, return_logits: bool = False):
    """Greedy per-request generation, one request at a time in its own
    contiguous cache, same indexed pool with B = 1.  The batched engine
    must reproduce these tokens exactly.  SSM and hybrid models are
    served here (their caches are conv windows and SSD states; prompts
    are not padded).

    Returns {rid: tokens}; with return_logits, also {rid: (n_new, V)
    fp32 logits on the host}, the steps' logits that chose the tokens."""
    out: Dict[int, List[int]] = {}
    logs: Dict[int, torch.Tensor] = {}
    for req in requests:
        cache = model.init_cache((1,), max_len, dtype)
        adapters = attach_ids(pool, [req.adapter])
        toks = torch.as_tensor(np.asarray(req.tokens, np.int32)[None],
                               device=model.device)
        logits, cache = model.prefill(params, adapters, {"tokens": toks},
                                      cache)
        steps = [logits[0, -1]]
        tok = int(torch.argmax(logits[0, -1]))
        gen = [tok]
        for _ in range(req.max_new - 1):
            logits, cache = model.decode_step(
                params, adapters,
                torch.tensor([[tok]], dtype=torch.int32, device=model.device),
                cache)
            steps.append(logits[0, -1])
            tok = int(torch.argmax(logits[0, -1]))
            gen.append(tok)
        out[req.rid] = gen
        if return_logits:
            logs[req.rid] = torch.stack(steps).float().cpu()
    return (out, logs) if return_logits else out
