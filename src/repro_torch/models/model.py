"""Model factory: block groups composed into a decoder, for training and
serving.

Port of src/repro/models/model.py.  A model is a list of block groups
(homogeneous stacks with parameters stacked along a leading layer axis)
plus embedding and head; ``flat_runs`` gives the execution order.  Here
the layers run as a Python loop (the reference scans them).

Entry points (parameters and adapters are passed explicitly, as in the
reference, as nested dicts of tensors with the reference's names):

  init_params(generator, dtype)                   -> params
  loss(params, adapters, batch, remat, ce_chunk, per_client, boundary)
                                                  -> (loss, metrics)
  prefill(params, adapters, batch, cache, policy) -> (logits_last, cache)
  decode_step(params, adapters, tokens, cache, policy) -> (logits, cache)
  encode(params, adapters, frames, remat, boundary) -> encoder output
  init_cache(lead, max_len, dtype, policy)        -> cache

Training activations carry the client axis first ((N, B, S, d)); caches
are updated in place and returned.  The port has every family of the
reference, each in training, prefill and decode: the dense decoder
(learned positions or RoPE, per-layer sliding windows, GQA: gpt2-small,
opt-125m, gpt-neo-125m, llama3-8b, phi4-mini, qwen1.5-32b,
mistral-large), the MoE decoder (kimi-k2, llama4-maverick: the MLP is
``transformer.moe_apply``, whose router loss each layer returns and
``forward`` sums as ``aux``), the vlm decoder (internvl2: a batch's
"prefix" embeddings replace its first positions), the SSM kind
(mamba2-780m, ``models/ssm.py``), the hybrid of the two (zamba2-1.2b:
SSD layers with attention layers between them) and the audio
encoder-decoder (whisper-medium).  An SSM layer's cache is its conv
window and its fp32 state; the attention layers' k/v and the shared
"len" are the dense decoder's.

The audio family's flat layers are the encoder's ("enc", non-causal,
ids 0..Le-1) and then the decoder's ("dec", causal, with
cross-attention).  A batch's "frames" ([N,] B, S_enc, d), the stub
frontend's embeddings, go through ``encode`` (their own positions,
the encoder stack in train mode, its own final norm; a cut-layer
boundary inside it acts there, as in the reference), and the decoder
runs from flat id Le with the encoder's output as the cross-attention
memory.  A prefill encodes and writes each decoder layer's cross cache
(xk/xv, S_enc positions); a decode step reads it and runs no encoder.
On a MeshShard the cross cache is split over "model" as the KV cache
(``runtime.sharding.local_cache``: "xseq_lo"), and a decode step reads
its block (``transformer._cross_attention``).

Memory knobs of a train step, as in the reference:

  remat     "none" saves every activation for the backward; "full"
            recomputes each layer in the backward from its input
            (torch.utils.checkpoint, non-reentrant), saving nothing
            inside it (a stateful cut boundary's residual is one of the
            layer's outputs, so the recompute cannot write it twice);
            "dots" saves only the outputs of matrix products
            (aten mm, bmm, addmm, baddbmm: jax's checkpoint_dots) and
            recomputes the rest.  A hand-written kernel is no aten
            product, so it is recomputed, as a pallas_call is under
            checkpoint_dots; its output buffer is never saved.  The
            cut-layer boundary runs inside the recomputed layer.
  ce_chunk  the head and cross entropy over sequence chunks, each
            recomputed in the backward, so one chunk's logits are live
            at a time (when S > ce_chunk and S % ce_chunk == 0).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import roadmap
from repro_torch.config import ArchConfig, ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import common, ssm, transformer
from repro_torch.models.common import apply_norm
from repro_torch.runtime.sharding import local_cache

Params = Dict[str, Any]

REMATS = ("none", "dots", "full")
_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
             torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_products(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of matrix products, recompute
    every other op."""
    policy = ckpt.CheckpointPolicy
    return (policy.MUST_SAVE if op in _PRODUCTS
            else policy.PREFER_RECOMPUTE)


def _recomputed(fn, *args, remat: str):
    """fn(*args) with its activations recomputed in the backward.  The
    layers and the head draw no random numbers, so no RNG state is
    kept."""
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_products)
    return ckpt.checkpoint(fn, *args, use_reentrant=False,
                           preserve_rng_state=False, **kw)


def _ce_sums(logits, labels, mask, keep: int,
             policy: common.ShardingPolicy = common.NO_SHARDING,
             vocab_lo: Optional[int] = None):
    """(nll_sum, hit_sum, count) reduced over all but the first `keep`
    dims, in fp32; the same sums as the reference's ``_ce_sums``.  With
    vocab_lo, `logits` are this rank's block of the vocabulary, from
    vocab_lo on (``_vocab_parallel_ce``)."""
    if vocab_lo is not None:
        return _vocab_parallel_ce(logits, labels, mask, keep, policy,
                                  vocab_lo)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    correct = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = (lse - correct) * mask
    hits = (torch.argmax(lf, dim=-1) == labels.long()).float() * mask
    dims = tuple(range(keep, nll.dim()))
    return nll.sum(dims), hits.sum(dims), mask.sum(dims)


def _summed(sums, policy: common.ShardingPolicy, axis: str):
    """The CE sums (nll, hits, count) of this rank's part of each
    client's tokens summed over `axis`, in one collective; the gradient
    passes as it is (``ShardingPolicy.reduce_over``)."""
    got = policy.reduce_over(torch.stack(list(sums)), axis)
    return tuple(got.unbind(0))


def _vocab_parallel_ce(logits, labels, mask, keep: int,
                       policy: common.ShardingPolicy, lo: int):
    """The CE sums over logits split by vocabulary over the "model" ranks,
    no rank holding a full-vocabulary row: the row max (a MAX over the
    ranks, no gradient), the sum of the exponentials and the target's
    logit (each a SUM, reduce_from_tp), and the argmax as the lowest
    vocabulary index that holds the global max (a MAX of negated
    indices), torch.argmax's first occurrence."""
    lf = logits.float()
    lab = labels.long()
    vl = lf.shape[-1]
    m = policy.tp_max(lf.max(dim=-1).values)
    sumexp = policy.reduce_from_tp(torch.exp(lf - m[..., None]).sum(-1))
    lse = torch.log(sumexp) + m
    mine = (lab >= lo) & (lab < lo + vl)
    local = torch.gather(lf, -1, torch.where(mine, lab - lo, 0)[..., None])
    correct = policy.reduce_from_tp(
        torch.where(mine, local[..., 0], torch.zeros_like(local[..., 0])))
    nll = (lse - correct) * mask
    with torch.no_grad():
        lmax, larg = lf.max(dim=-1).values, torch.argmax(lf, dim=-1)
        none = torch.full_like(larg, -(2 ** 62))
        first = -policy.tp_max(torch.where(lmax == m, -(larg + lo), none))
        hits = (first == lab).float() * mask
    dims = tuple(range(keep, nll.dim()))
    return nll.sum(dims), hits.sum(dims), mask.sum(dims)


def _at_cut(boundary, x, bcarry, fid: int, policy: common.ShardingPolicy):
    """The cut-layer hook on layer `fid`'s output: (x, carry).  Where the
    stream is split (batch rows over "pod", the sequence over "model")
    and the hook acts at fid (``boundary.fids``, when it says), it runs
    on the whole message (``ShardingPolicy.whole_message``)."""
    if fid not in getattr(boundary, "fids", (fid,)):
        return x, bcarry
    if getattr(boundary, "stateful", False):
        return policy.whole_message(lambda t, c: boundary(t, c, fid), x,
                                    bcarry)
    return policy.whole_message(lambda t, c: (boundary(t, fid), c), x,
                                bcarry)


# ---------------------------------------------------------------------------
# Group structure


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    name: str                      # params/adapters key
    kind: str                      # attn_mlp | attn_moe | ssm | attn
    layer_ids: Tuple[int, ...]     # flat layer ids, ascending
    causal: bool = True
    cross: bool = False            # decoder cross-attention (whisper)
    scan: bool = True              # reference: lax.scan vs unrolled loop
    windows: Tuple[int, ...] = ()  # per-layer attention window (0=global)

    @property
    def size(self) -> int:
        return len(self.layer_ids)

    def window_of(self, local_idx: int) -> int:
        return self.windows[local_idx] if self.windows else 0


def build_groups(cfg: ModelConfig) -> Tuple[GroupSpec, ...]:
    L = cfg.num_layers
    if cfg.family in ("dense", "vlm", "moe"):
        kind = "attn_moe" if cfg.family == "moe" else "attn_mlp"
        windows: Tuple[int, ...] = ()
        scan = True
        if cfg.local_window:
            if cfg.local_every_other:
                windows = tuple(cfg.local_window if i % 2 else 0
                                for i in range(L))
                scan = False
            else:
                windows = (cfg.local_window,) * L
        return (GroupSpec("dec", kind, tuple(range(L)), scan=scan,
                          windows=windows),)
    if cfg.family == "ssm":
        return (GroupSpec("ssm", "ssm", tuple(range(L))),)
    if cfg.family == "hybrid":
        attn_ids = tuple(sorted(cfg.attn_layer_indices))
        ssm_ids = tuple(i for i in range(L) if i not in attn_ids)
        return (GroupSpec("ssm", "ssm", ssm_ids),
                GroupSpec("attn", "attn_mlp", attn_ids, scan=False))
    if cfg.family == "audio":
        le = cfg.num_encoder_layers
        return (GroupSpec("enc", "attn_mlp", tuple(range(le)), causal=False),
                GroupSpec("dec", "attn_mlp", tuple(range(le, le + L)),
                          cross=True))
    raise ValueError(cfg.family)


def flat_runs(groups: Sequence[GroupSpec]) -> List[Tuple[str, int, int]]:
    """Execution plan: maximal contiguous runs [(group_name, lo, hi)] in
    flat-layer order."""
    owner = {}
    for g in groups:
        for j, fid in enumerate(g.layer_ids):
            owner[fid] = (g.name, j)
    runs: List[Tuple[str, int, int]] = []
    for fid in sorted(owner):
        name, j = owner[fid]
        if runs and runs[-1][0] == name and runs[-1][2] == j:
            runs[-1] = (name, runs[-1][1], j + 1)
        else:
            runs.append((name, j, j + 1))
    return [tuple(r) for r in runs]


def _index_tree(t, i):
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _index_tree(v, i) for k, v in t.items()}
    return t[i]


def _to_device(t, device):
    if isinstance(t, dict):
        return {k: _to_device(v, device) for k, v in t.items()}
    return t.to(device)


def _rows_of_ids(adapters, lo: int, n: int):
    """A serving pool with each "ids" leaf ((Lg, B) or (B,)) narrowed to
    the batch rows [lo, lo + n)."""
    if isinstance(adapters, dict):
        return {k: (v.narrow(-1, lo, n) if k == "ids"
                    else _rows_of_ids(v, lo, n))
                for k, v in adapters.items()}
    return adapters


def _materialise(t, device):
    """Zeros of a meta tree's shapes and dtypes on `device`."""
    if isinstance(t, dict):
        return {k: _materialise(v, device) for k, v in t.items()}
    return torch.zeros(t.shape, dtype=t.dtype, device=device)


# ---------------------------------------------------------------------------
# The Model


class Model(nn.Module):
    """The decoder for one ArchConfig on one device.

    ``device`` defaults to the card; asking for it without a GPU raises
    (``repro_torch.device.resolve_device``).  ``forward`` is the
    reference's ``forward``: hidden states before the head."""

    def __init__(self, arch: ArchConfig, *, device: DeviceLike = None):
        super().__init__()
        self.arch = arch
        self.cfg = arch.model
        self.device = resolve_device(device)
        self.groups: Tuple[GroupSpec, ...] = build_groups(self.cfg)
        self.runs = flat_runs(self.groups)
        self.group_by_name = {g.name: g for g in self.groups}
        self.num_flat_layers = sum(g.size for g in self.groups)

    # -- parameter init ------------------------------------------------------

    def init_params(self, generator: torch.Generator,
                    dtype=torch.float32, place=None) -> Params:
        """Random weights from `generator`, moved to this model's device.
        A CPU generator draws the same weights for every device; a
        generator on the card draws the dense and MoE weights there (no
        host copy of a model too large to draw quickly on the CPU).

        place(name, leaf): the part of each leaf to keep (a MeshShard's
        block, ``runtime.sharding.leaf_block``), called as soon as the
        leaf is drawn whole (the draw is the unsharded one), so that no
        more than one full leaf is alive at a time beside the kept
        parts."""
        cfg = self.cfg
        if place is None:
            place = common.whole
        norm = functools.partial(common.init_norm, cfg.d_model,
                                 bias=cfg.norm == "layernorm", dtype=dtype,
                                 place=place)
        p: Params = {"embed": {"tok": place("tok", common.embed_init(
            generator, cfg.vocab_size, cfg.d_model, dtype))}}
        if cfg.learned_pos:
            p["embed"]["pos"] = place("pos", common.embed_init(
                generator, cfg.max_position_embeddings, cfg.d_model, dtype))
        if not cfg.tie_embeddings:
            p["embed"]["head"] = place("head", common.dense_init(
                generator, cfg.d_model, cfg.vocab_size, dtype))
        p["final_norm"] = norm()
        if cfg.family == "audio":
            p["embed"]["enc_pos"] = common.embed_init(
                generator, cfg.encoder_seq_len, cfg.d_model, dtype)
            p["enc_norm"] = norm()
        for g in self.groups:
            if g.kind == "ssm":
                p[g.name] = ssm.init_ssm(generator, cfg, g.size, dtype=dtype,
                                         place=place)
                continue
            p[g.name] = transformer.init_attention(
                generator, cfg, g.size, cross=g.cross, dtype=dtype,
                place=place)
            if g.kind == "attn_moe":
                p[g.name].update(transformer.init_moe(
                    generator, cfg, g.size, dtype=dtype, place=place))
            elif cfg.d_ff:
                p[g.name].update(transformer.init_mlp(
                    generator, cfg, g.size, dtype=dtype, place=place))
        return _to_device(p, self.device)

    # -- adapter spec (consumed by repro_torch.core.lora) ---------------------

    def adapter_spec(self) -> Dict[str, Dict[str, Tuple[int, int]]]:
        """{group: {target: (d_in, d_out)}} for every LoRA-targetable
        projection present in this architecture, filtered by lora.targets."""
        cfg = self.cfg
        want = set(self.arch.lora.targets)
        h, kvh, hd, d = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                         cfg.d_model)
        spec: Dict[str, Dict[str, Tuple[int, int]]] = {}
        for g in self.groups:
            t: Dict[str, Tuple[int, int]] = {}
            if g.kind == "ssm":
                if "ssm_in" in want:
                    t["ssm_in"] = (d, ssm.in_proj_dim(cfg))
                if "ssm_out" in want:
                    t["ssm_out"] = (cfg.d_inner, d)
            else:
                if "q" in want:
                    t["q"] = (d, h * hd)
                if "k" in want:
                    t["k"] = (d, kvh * hd)
                if "v" in want:
                    t["v"] = (d, kvh * hd)
                if "o" in want:
                    t["o"] = (h * hd, d)
                if g.kind == "attn_mlp" and cfg.d_ff:
                    if "mlp_in" in want:
                        t["mlp_in"] = (d, cfg.d_ff)
                    if "mlp_out" in want:
                        t["mlp_out"] = (cfg.d_ff, d)
                if g.cross and "xq" in want:
                    t["xq"] = (d, h * hd)
                    t["xo"] = (h * hd, d)
            if t:
                spec[g.name] = t
        return spec

    # -- embedding / head ------------------------------------------------------

    def embed(self, params: Params, tokens, *, positions=None, prefix=None,
              policy: common.ShardingPolicy = common.NO_SHARDING):
        """Token embeddings; a prefix ([N,] B, P, d) (the vlm frontend's
        patch embeddings) replaces the first P positions.  When `tok`
        holds a "model" block of the vocabulary, each rank looks up the
        tokens of its block (zero rows for the others) and the rows are
        summed over the ranks, exactly.  Under sequence parallelism
        (``policy.sp``) the result is the rank's sequence block: the sum
        over the ranks is reduce-scattered (a whole vocabulary looks up
        the block's tokens alone), and the prefix and the positions are
        the block's."""
        cfg = self.cfg
        tok = params["embed"]["tok"]
        if positions is None:
            positions = torch.arange(tokens.shape[-1], device=tokens.device)
        lo = policy.block(cfg.vocab_size, tok.shape[0])
        if lo is None:
            x = tok[policy.seq_block(tokens, -1).long()]
        else:
            ids = tokens.long() - lo
            mine = (ids >= 0) & (ids < tok.shape[0])
            x = tok[torch.where(mine, ids, 0)] * mine[..., None].to(
                tok.dtype)
            x = policy.leave(x, True)
        s0 = policy.seq_lo(tokens.shape[-1])
        if prefix is not None and s0 < prefix.shape[-2]:
            # the prefix's positions of this block (all of them unsplit)
            n = min(prefix.shape[-2] - s0, x.shape[-2])
            x = torch.cat([prefix[..., s0:s0 + n, :].to(x.dtype),
                           x[..., n:, :]], dim=-2)
        if cfg.learned_pos:
            pos_tab = params["embed"]["pos"]
            positions = torch.clamp(policy.seq_block(positions, -1), 0,
                                    pos_tab.shape[0] - 1)
            x = x + pos_tab[positions.long()].to(x.dtype)
        return x

    def head(self, params: Params, x,
             policy: common.ShardingPolicy = common.NO_SHARDING):
        """Logits; under a vocabulary split over "model", this rank's
        block of them (x enters through ``policy.enter``)."""
        if self._vocab_lo(params, policy) is not None:
            x = policy.enter(x, True)
        return self._logits(params, x)

    def _logits(self, params: Params, x):
        w = (params["embed"]["tok"].T if self.cfg.tie_embeddings
             else params["embed"]["head"])
        return x @ w

    def _vocab_lo(self, params: Params, policy: common.ShardingPolicy):
        """The first vocabulary index of this rank's logits, or None when
        the head is whole."""
        e = params["embed"]
        vl = (e["tok"].shape[0] if self.cfg.tie_embeddings
              else e["head"].shape[-1])
        return policy.block(self.cfg.vocab_size, vl)

    # -- block execution -------------------------------------------------------

    def run_blocks(self, params: Params, adapters: Optional[Params], x, *,
                   mode: str = "train", remat: str = "none",
                   cache: Optional[Params] = None, memory=None,
                   layer_lo: int = 0, layer_hi: Optional[int] = None,
                   boundary=None,
                   policy: common.ShardingPolicy = common.NO_SHARDING):
        """Run flat layers [layer_lo, layer_hi) over activations x
        ([N,] B, S, d).  memory: the encoder's output, which the
        cross-attention groups attend to (train and prefill).

        mode: "train" (full sequences, no cache), "prefill" (full
        sequences; fills `cache` if given) or "decode" (one token per slot
        against `cache`).  Returns (x, aux, new_cache): aux sums the MoE
        layers' router losses (0.0 without any), and the cache's k/v
        tensors are written in place.

        `boundary(x, flat_id) -> x` is applied to every layer output with
        its flat layer id: the round engine compresses the smashed
        activation there, where each client's cut sits.  A stateful
        boundary (`boundary.stateful`, the smashed error-feedback hook)
        threads a carry, `x, carry = boundary(x, carry, flat_id)`, from
        `boundary.init()`; run_blocks then returns (x, aux, new_cache,
        carry).
        `remat` (train mode, under autograd) recomputes each layer,
        boundary included, in the backward (see the module docstring).
        `policy`: each layer gathers its FSDP-split base weights first
        (so remat gathers them again in the backward instead of keeping
        them) and runs its TP blocks (models/common.ShardingPolicy)."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        if remat not in REMATS:
            raise ValueError(f"unknown remat {remat!r}; known: {REMATS}")
        remat = (remat if mode == "train" and torch.is_grad_enabled()
                 else "none")
        stateful = bool(getattr(boundary, "stateful", False))
        bcarry = boundary.init() if stateful else None
        hi_total = self.num_flat_layers if layer_hi is None else layer_hi
        cache_len = cache["len"] if cache is not None else None
        pages = cache.get("pages") if cache is not None else None
        # a decode step reads every slot's whole cross cache
        mem_len = (torch.full_like(cache_len, self.cfg.encoder_seq_len)
                   if mode == "decode" and self.cfg.family == "audio"
                   else None)
        rope = None
        if self.cfg.use_rope:
            # each slot's next position in decode, else 0..S-1 (a prefill
            # starts every request at 0)
            # (under SP the attention runs on the gathered sequence)
            positions = (cache_len[..., None] if mode == "decode"
                         else torch.arange(
                             x.shape[-2] * (policy.tp if policy.sp else 1),
                             device=x.device))
            rope = common.rope_angles(positions, self.cfg.head_dim,
                                      self.cfg.rope_theta)

        aux = 0.0
        flat_base = 0
        for name, lo, hi in self.runs:
            g = self.group_by_name[name]
            run_flat_lo = flat_base
            flat_base += hi - lo
            a = max(run_flat_lo, layer_lo)
            b = min(flat_base, hi_total)
            for i in range(lo + (a - run_flat_lo), lo + (b - run_flat_lo)):
                p_l = _index_tree(params[g.name], i)
                ad_l = _index_tree(adapters.get(g.name) if adapters else None,
                                   i)
                c_l = mem_l = None
                if cache is not None:
                    # views of layer i: the layer writes its cache there
                    c_l = _index_tree(cache[g.name], i)
                    if g.cross:
                        mem_l = {"k": c_l.pop("xk"), "v": c_l.pop("xv"),
                                 "len": mem_len}
                        if "xseq_lo" in cache:   # a rank's cross block
                            mem_l["seq_lo"] = cache["xseq_lo"]
                    if g.kind != "ssm":
                        c_l["len"] = cache_len
                        if pages is not None:
                            c_l["pages"] = pages
                        if "seq_lo" in cache:   # a rank's KV block
                            c_l["seq_lo"] = cache["seq_lo"]
                layer = functools.partial(
                    self._layer, g, i, p_l, ad_l, mode=mode, cache=c_l,
                    memory=memory if g.cross else None, mem_cache=mem_l,
                    rope=rope, boundary=boundary, fid=run_flat_lo + (i - lo),
                    policy=policy)
                x, bcarry, a = (layer(x, bcarry) if remat == "none"
                                else _recomputed(layer, x, bcarry,
                                                 remat=remat))
                aux = aux + a
        new_cache = None
        if cache is not None:
            new_cache = dict(cache)
            step = 1 if mode == "decode" else x.shape[-2]
            new_cache["len"] = cache_len + step
        if stateful:
            return x, aux, new_cache, bcarry
        return x, aux, new_cache

    def _layer(self, g: GroupSpec, i: int, p_l, ad_l, x, bcarry=None, *,
               mode: str, cache, memory, mem_cache, rope, boundary, fid: int,
               policy: common.ShardingPolicy = common.NO_SHARDING):
        """One layer of group g (local index i, whose attention window is
        the group's per-layer window) and the cut-layer hook: (x, the
        stateful hook's carry or None, the layer's router loss).  A cross
        group's layer also attends to `memory` or its cross cache
        `mem_cache`."""
        cfg = self.cfg
        aux = 0.0
        p_l = policy.gather(p_l, cfg.d_model)
        if g.kind == "ssm":
            out, new = ssm.ssm_apply(p_l, ad_l, x, cfg=cfg, mode=mode,
                                     cache=cache, policy=policy)
            if new is not None:
                for k in ("conv", "state"):
                    cache[k].copy_(new[k])
            x = x + out
        else:
            attn_out, _ = transformer.attention_apply(
                p_l, ad_l, x, cfg=cfg, mode=mode, causal=g.causal,
                window=g.window_of(i), rope=rope, cache=cache, memory=memory,
                mem_cache=mem_cache, policy=policy)
            x = x + attn_out
            if g.kind == "attn_moe":
                out, aux = transformer.moe_apply(p_l, ad_l, x, cfg=cfg,
                                                 policy=policy)
                x = x + out
            elif cfg.d_ff:
                x = x + transformer.mlp_apply(p_l, ad_l, x, cfg=cfg,
                                              policy=policy)
        if boundary is not None:
            x, bcarry = _at_cut(boundary, x, bcarry, fid, policy)
        return x, bcarry, aux

    # -- top-level entry points ------------------------------------------------

    def forward(self, params, adapters, batch, *, cache=None,
                mode: str = "train", remat: str = "none", boundary=None,
                return_boundary: bool = False,
                policy: common.ShardingPolicy = common.NO_SHARDING):
        """Full forward to hidden states (pre-head).

        batch: {"tokens": ([N,] B, S)[, "prefix": ([N,] B, P, d)]
        [, "frames": ([N,] B, S_enc, d)]}; the audio family encodes the
        frames (train and prefill; a decode step reads the cross cache)
        and runs its decoder from the encoder's last flat id.
        Returns (x, aux, new_cache); aux is the MoE layers' summed router
        loss, 0.0 for every other kind.  return_boundary=True appends a
        stateful boundary's last carry (the smashed error-feedback
        residual).  `policy`: the base weights are a MeshShard's blocks
        (runtime.sharding.leaf_block), the embedding's gathered over the
        FSDP axes (``loss`` and the serving entry points do it); see
        run_blocks.  In train mode and in a prefill under sequence
        parallelism the stream, and so the result, is the rank's
        sequence block (``ShardingPolicy.for_stream``); the
        decoder's cross-attention reads the whole encoder output, which
        enters through copy_to_tp once when its heads are split."""
        cfg = self.cfg
        tokens = batch["tokens"]
        memory, lo = None, 0
        if cfg.family == "audio":
            if mode != "decode":
                memory = self.encode(params, adapters, batch["frames"],
                                     remat=remat, boundary=boundary,
                                     policy=policy)
                xwq = params["dec"]["xwq"]
                if policy.block(cfg.num_heads * cfg.head_dim,
                                xwq.shape[-1]) is not None:
                    memory = policy.copy_to_tp(memory)
            lo = self.group_by_name["enc"].size
        if mode in ("train", "prefill"):
            policy = policy.for_stream(tokens.shape[-1])
        positions = (cache["len"][..., None] if mode == "decode"
                     else torch.arange(tokens.shape[-1],
                                       device=tokens.device))
        x = self.embed(params, tokens, positions=positions,
                       prefix=batch.get("prefix"), policy=policy)
        x, aux, new_cache, *bcarry = self.run_blocks(
            params, adapters, x, mode=mode, remat=remat, cache=cache,
            memory=memory, layer_lo=lo, boundary=boundary, policy=policy)
        x = apply_norm(params["final_norm"], x, kind=cfg.norm,
                       eps=cfg.norm_eps)
        if return_boundary:
            return (x, aux, new_cache, *bcarry)
        return x, aux, new_cache

    def loss(self, params, adapters, batch, *, remat: str = "none",
             ce_chunk: int = 0, per_client: bool = False, boundary=None,
             policy: common.ShardingPolicy = common.NO_SHARDING):
        """Next-token CE.  batch needs "tokens", "labels"[, "loss_mask"].

        per_client=True keeps the leading client axis un-reduced: returns
        ((N,) nll, metrics with (N,) entries), which the round engine
        weights and combines (paper formula 2).  `boundary` is the
        cut-layer hook (see run_blocks); a stateful (error-feedback)
        boundary's new residual comes back as metrics["smashed_ef"].
        `remat` and `ce_chunk` are the memory knobs of the module
        docstring.  `policy`: see forward; the embedding and head leaves
        are gathered over the FSDP axes once, for the embedding, the head
        and every CE chunk, and a vocabulary split over "model" takes the
        vocab-parallel CE (``_vocab_parallel_ce``).  Each client's batch
        rows are split over "pod" where "pod" divides them
        (``ShardingPolicy.split_rows``): the CE sums and token counts, and
        the router loss's mean, are then summed over "pod" before they
        are divided, so every rank sees the client's loss.  Under
        sequence parallelism the final hidden states are the rank's
        sequence block: a split vocabulary gathers them first; a whole
        one runs the head and the CE sums on the block and adds the sums
        over "model"."""
        params = dict(params, embed=policy.gather(params["embed"],
                                                  self.cfg.d_model))
        batch, policy = policy.split_rows(batch)
        stateful = bool(getattr(boundary, "stateful", False))
        x, aux, _, *bcarry = self.forward(
            params, adapters, batch, mode="train", remat=remat,
            boundary=boundary, return_boundary=stateful, policy=policy)
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        mask = (torch.ones(labels.shape, device=x.device) if mask is None
                else mask.float())
        keep = 1 if per_client else 0
        stream = policy.for_stream(labels.shape[-1])
        vlo = self._vocab_lo(params, policy)
        if vlo is not None:
            x = stream.enter(x, True)
        elif stream.sp:
            labels, mask = (stream.seq_block(t, -1) for t in (labels, mask))
        s = x.shape[-2]
        if ce_chunk and s > ce_chunk and s % ce_chunk == 0:
            sums = self._chunked_ce(params, x, labels, mask, ce_chunk, keep,
                                    policy, vlo)
        else:
            sums = _ce_sums(self._logits(params, x), labels, mask, keep,
                            policy, vlo)
        if vlo is None and stream.sp:
            sums = _summed(sums, stream, "model")
        if policy.rows:
            sums = _summed(sums, policy, "pod")
            if isinstance(aux, torch.Tensor):
                aux = policy.reduce_over(aux, "pod") / policy.pod
        nll_sum, hits, cnt = sums
        cnt = torch.clamp(cnt, min=1.0)
        nll, acc = nll_sum / cnt, hits / cnt
        aux = torch.zeros((), device=x.device) + aux
        metrics = {"ce": nll, "aux": aux, "accuracy": acc, "tokens": cnt}
        if stateful:
            metrics["smashed_ef"] = bcarry[0]
        return nll + aux, metrics

    def _chunked_ce(self, params, x, labels, mask, chunk: int, keep: int,
                    policy: common.ShardingPolicy = common.NO_SHARDING,
                    vocab_lo: Optional[int] = None):
        """The CE sums over sequence chunks, summed in chunk order from
        zero as the reference's scan; each chunk's head and sums are
        recomputed in the backward, so one chunk's logits are live (its
        collectives run again there, in the same order on every rank)."""
        def body(x_c, l_c, m_c):
            return _ce_sums(self._logits(params, x_c), l_c, m_c, keep,
                            policy, vocab_lo)

        zero = torch.zeros(x.shape[:keep], device=x.device)
        sums = (zero, zero, zero)
        for lo in range(0, x.shape[-2], chunk):
            part = (x[..., lo:lo + chunk, :], labels[..., lo:lo + chunk],
                    mask[..., lo:lo + chunk])
            got = (_recomputed(body, *part, remat="full")
                   if torch.is_grad_enabled() else body(*part))
            sums = tuple(a + b for a, b in zip(sums, got))
        return sums

    def encode(self, params, adapters, frames, *, remat: str = "none",
               boundary=None,
               policy: common.ShardingPolicy = common.NO_SHARDING):
        """frames ([N,] B, S_enc, d), the stub frontend's embeddings ->
        the encoder's output: the frames plus their positions through the
        encoder stack in train mode (no cache, also in a prefill) and its
        final norm.  `boundary` acts on the encoder's layers as on any
        other; a stateful one raises, as in the reference.  `policy`:
        the encoder's layers run their TP blocks, and under sequence
        parallelism its stream is split as the decoder's (the frames'
        sequence block on each rank), the output gathered whole (every
        rank's cross-attention reads all of it)."""
        if getattr(boundary, "stateful", False):
            raise NotImplementedError(
                "stateful (error-feedback) smashed boundaries are not "
                "supported across the encoder stack")
        cfg = self.cfg
        policy = policy.for_stream(frames.shape[-2])
        x = policy.seq_block(frames + params["embed"]["enc_pos"].to(
            frames.dtype))
        x, _, _ = self.run_blocks(params, adapters, x, mode="train",
                                  remat=remat, layer_lo=0,
                                  layer_hi=self.group_by_name["enc"].size,
                                  boundary=boundary, policy=policy)
        x = apply_norm(params["enc_norm"], x, kind=cfg.norm,
                       eps=cfg.norm_eps)
        return policy.tp_gather(x, -2) if policy.sp else x

    def prefill(self, params, adapters, batch, cache, *,
                policy: common.ShardingPolicy = common.NO_SHARDING):
        """(logits of the last position (B, 1, V), cache).  `policy`: the
        base weights are a MeshShard's blocks and the cache its blocks
        (``Model.init_cache(policy=)`` or ``runtime.sharding.
        local_cache``); see ``_serve``."""
        return self._serve(params, adapters, batch, cache, "prefill",
                           policy)

    def decode_step(self, params, adapters, tokens, cache, *,
                    policy: common.ShardingPolicy = common.NO_SHARDING):
        return self._serve(params, adapters, {"tokens": tokens}, cache,
                           "decode", policy)

    def _serve(self, params, adapters, batch, cache, mode: str,
               policy: common.ShardingPolicy):
        """A prefill or a decode step, on one card (every step below then
        leaves its input as it is) or under a MeshShard's policy, as the
        reference's serve cells place it: the batch's rows split over the
        FSDP axes where ``cache_specs`` splits the cache's batch
        (``ShardingPolicy.batch_block``: this rank runs its rows, its
        share of the adapters' ids and of "len", which stays whole), the
        embedding and head gathered over the FSDP axes, a prefill's
        stream over "model" under sequence parallelism (its last
        position is the whole sequence's), and the logits gathered over
        the vocabulary and the rows, so every rank returns the whole
        (B, S, V) logits and the whole "len".

        On one card the tokens may carry a client axis, (N, B, S), over a
        cache of lead (N, B) (``init_cache``): the logits are then (N, B,
        S, V), as the reference's."""
        if batch["tokens"].dim() == 3 and policy.shard is not None:
            raise NotImplementedError(
                "a served batch with a client axis runs on one card: a "
                f"MeshShard places a cache of lead (B,) "
                f"({roadmap.PARAM_SHARDING})")
        params = dict(params, embed=policy.gather(params["embed"],
                                                  self.cfg.d_model))
        axes, lo, n = policy.batch_block(batch["tokens"].shape[0])
        whole_len = cache["len"]
        if axes:
            batch = {k: v.narrow(0, lo, n) for k, v in batch.items()}
            adapters = _rows_of_ids(adapters, lo, n)
            cache = dict(cache, len=whole_len.narrow(0, lo, n))
        x, _, cache = self.forward(params, adapters, batch, cache=cache,
                                   mode=mode, policy=policy)
        step = 1
        if mode == "prefill":
            step = batch["tokens"].shape[-1]
            stream = policy.for_stream(step)
            x = x[..., -1:, :]
            if stream.sp:   # the last rank's block ends the sequence
                x = policy.fill([(x, -2)], ("model",))[0][..., -1:, :]
        logits = self._logits(params, x)
        if self._vocab_lo(params, policy) is not None:
            logits = policy.fill([(logits, -1)], ("model",))[0]
        cache = dict(cache, len=whole_len + step)
        return policy.gather_batch(logits, axes), cache

    def serving_blocks(self, params: Params, adapters: Optional[Params],
                       policy: common.ShardingPolicy = common.NO_SHARDING):
        """(the adapters, the policy to serve them with): the adapters
        (global rank-2 leaves or a stacked serving pool) narrowed once to
        the blocks of this rank's base weights (``ssm.adapter_blocks``,
        the layers' own map), as contiguous copies, which the indexed
        LoRA kernel takes, and the policy marked so that the layers apply
        them as they are (``adapters_at_blocks``).  Whole base weights
        (no "model" split) leave both as they are."""
        if adapters is None or policy.tp == 1:
            return adapters, policy
        out: Params = {}
        for gname, targets in adapters.items():
            blocks = ssm.adapter_blocks(self.cfg, params[gname], policy)
            out[gname] = {}
            for tname, ad in targets.items():
                ad = transformer.narrow_adapter(ad, blocks.get(tname))
                out[gname][tname] = {
                    k: v.contiguous() if isinstance(v, torch.Tensor) else v
                    for k, v in ad.items()}
        return out, policy._with(adapters_at_blocks=True)

    # -- caches ----------------------------------------------------------------

    def init_cache(self, lead: Tuple[int, ...], max_len: int,
                   dtype=torch.float32, *,
                   policy: common.ShardingPolicy = common.NO_SHARDING
                   ) -> Params:
        """lead = ([N,] B), as in the reference. One stacked entry per
        group, on this model's device: (Lg, *lead, max_len, KVH, hd) k
        and v for attention (and for a cross-attention group the cross
        cache xk/xv, (Lg, *lead, S_enc, KVH, hd); the encoder has none),
        and for SSM layers the conv window (Lg, *lead, W-1, C) in `dtype`
        and the state (Lg, *lead, H, P, N) in fp32; "len" (B,), shared
        over the clients N.  Under a MeshShard's policy (a lead of (B,)
        only), this rank's blocks of them as ``cache_specs`` places them
        (``runtime.sharding.local_cache``: the whole shapes are laid out
        on the meta device, only the blocks allocated), with "seq_lo"
        where the KV sequence is split and "xseq_lo" where the cross
        cache's is."""
        if policy.shard is None:
            return self._new_cache(lead, max_len, dtype, self.device)
        if len(lead) != 1:
            raise NotImplementedError(
                f"cache lead {tuple(lead)}: a MeshShard places a cache of "
                f"lead (B,); a client axis runs on one card "
                f"({roadmap.PARAM_SHARDING})")
        blocks = local_cache(self._new_cache(lead, max_len, dtype,
                                             torch.device("meta")),
                             policy.shard.mesh, policy.shard)
        return {k: (v if isinstance(v, int) else _materialise(
            v, self.device)) for k, v in blocks.items()}

    def _new_cache(self, lead, max_len: int, dtype, device) -> Params:
        cfg = self.cfg
        batch = lead[-1]
        cache: Params = {"len": torch.zeros((batch,), dtype=torch.int32,
                                            device=device)}
        kv = (cfg.num_kv_heads, cfg.head_dim)
        for g in self.groups:
            if g.name == "enc":
                continue
            if g.kind == "ssm":
                cache[g.name] = ssm.init_ssm_cache(
                    cfg, (g.size,) + tuple(lead), dtype, device=device)
                continue
            lens = {"k": max_len, "v": max_len}
            if g.cross:
                lens.update(xk=cfg.encoder_seq_len, xv=cfg.encoder_seq_len)
            cache[g.name] = {
                name: torch.zeros((g.size,) + tuple(lead) + (n,) + kv,
                                  dtype=dtype, device=device)
                for name, n in lens.items()}
        return cache


    # -- input shapes ------------------------------------------------------------

    def input_specs(self, kind, seq_len: Optional[int] = None,
                    global_batch: Optional[int] = None, *,
                    num_clients: int = 0, dtype=torch.float32
                    ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """{input: (shape, dtype)} of a "train", "prefill" or "decode"
        batch, as the reference's ``input_specs`` gives them.  `kind` is
        a ShapeConfig, as in the reference, or its kind with seq_len and
        global_batch beside it.  A train batch splits global_batch over
        num_clients when given.  The vlm family adds its "prefix" of
        frontend_prefix_len positions, the audio family its "frames" of
        encoder_seq_len positions (train and prefill)."""
        cfg = self.cfg
        if isinstance(kind, ShapeConfig):
            kind, seq_len, global_batch = (kind.kind, kind.seq_len,
                                           kind.global_batch)
        s, b = seq_len, global_batch

        def tok_shape(extra: Tuple[int, ...]):
            if num_clients:
                return (num_clients, b // num_clients) + extra
            return (b,) + extra

        specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
        if kind == "train":
            specs["tokens"] = (tok_shape((s,)), torch.int32)
            specs["labels"] = (tok_shape((s,)), torch.int32)
            specs["loss_mask"] = (tok_shape((s,)), torch.float32)
        elif kind == "prefill":
            specs["tokens"] = ((b, s), torch.int32)
        else:
            specs["tokens"] = ((b, 1), torch.int32)
        if cfg.family == "vlm" and cfg.frontend_prefix_len \
                and kind in ("train", "prefill"):
            p_d = (cfg.frontend_prefix_len, cfg.d_model)
            specs["prefix"] = (tok_shape(p_d) if kind == "train"
                               else (b,) + p_d, dtype)
        if cfg.family == "audio" and kind in ("train", "prefill"):
            e_d = (cfg.encoder_seq_len, cfg.d_model)
            specs["frames"] = (tok_shape(e_d) if kind == "train"
                               else (b,) + e_d, dtype)
        return specs


def build_model(arch: ArchConfig, *, device: DeviceLike = None) -> Model:
    return Model(arch, device=device)
