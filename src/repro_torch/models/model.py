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
  prefill(params, adapters, batch, cache)         -> (logits_last, cache)
  decode_step(params, adapters, tokens, cache)    -> (logits, cache)
  init_cache(lead, max_len, dtype)                -> cache

Training activations carry the client axis first ((N, B, S, d)); caches
are updated in place and returned.  The port has the dense decoder
(learned positions or RoPE, per-layer sliding windows, GQA: gpt2-small,
opt-125m, gpt-neo-125m, llama3-8b, phi4-mini, qwen1.5-32b,
mistral-large), the MoE decoder (kimi-k2, llama4-maverick: the MLP is
``transformer.moe_apply``, whose router loss each layer returns and
``forward`` sums as ``aux``), the vlm decoder (internvl2: a batch's
"prefix" embeddings replace its first positions), the SSM kind
(mamba2-780m, ``models/ssm.py``) and the hybrid of the two (zamba2-1.2b:
SSD layers with attention layers between them), each in training,
prefill and decode.  An SSM layer's cache is its conv window and its
fp32 state; the attention layers' k/v and the shared "len" are the dense
decoder's.  The encoder (whisper) raises NotImplementedError with a
pointer to ROADMAP.md.

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
from repro_torch.config import ArchConfig, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import common, ssm, transformer
from repro_torch.models.common import apply_norm

Params = Dict[str, Any]

_SERVING = roadmap.SERVING
_FAMILIES = roadmap.FAMILIES

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


def _ce_sums(logits, labels, mask, keep: int):
    """(nll_sum, hit_sum, count) reduced over all but the first `keep`
    dims, in fp32; the same sums as the reference's ``_ce_sums``."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    correct = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = (lse - correct) * mask
    hits = (torch.argmax(lf, dim=-1) == labels.long()).float() * mask
    dims = tuple(range(keep, nll.dim()))
    return nll.sum(dims), hits.sum(dims), mask.sum(dims)


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


def _unsupported(cfg: ModelConfig) -> Optional[str]:
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid"):
        return f"the {cfg.family} family"
    return None


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
        missing = _unsupported(self.cfg)
        if missing:
            raise NotImplementedError(
                f"{arch.name}: {missing} is not ported to repro_torch yet "
                f"({_FAMILIES})")
        self.device = resolve_device(device)
        self.groups: Tuple[GroupSpec, ...] = build_groups(self.cfg)
        self.runs = flat_runs(self.groups)
        self.group_by_name = {g.name: g for g in self.groups}
        self.num_flat_layers = sum(g.size for g in self.groups)

    # -- parameter init ------------------------------------------------------

    def init_params(self, generator: torch.Generator,
                    dtype=torch.float32) -> Params:
        """Random weights from `generator`, moved to this model's device.
        A CPU generator draws the same weights for every device; a
        generator on the card draws the dense and MoE weights there (no
        host copy of a model too large to draw quickly on the CPU)."""
        cfg = self.cfg
        p: Params = {"embed": {"tok": common.embed_init(
            generator, cfg.vocab_size, cfg.d_model, dtype)}}
        if cfg.learned_pos:
            p["embed"]["pos"] = common.embed_init(
                generator, cfg.max_position_embeddings, cfg.d_model, dtype)
        if not cfg.tie_embeddings:
            p["embed"]["head"] = common.dense_init(
                generator, cfg.d_model, cfg.vocab_size, dtype)
        p["final_norm"] = common.init_norm(
            cfg.d_model, bias=cfg.norm == "layernorm", dtype=dtype)
        for g in self.groups:
            if g.kind == "ssm":
                p[g.name] = ssm.init_ssm(generator, cfg, g.size, dtype=dtype)
                continue
            p[g.name] = transformer.init_attention(
                generator, cfg, g.size, cross=g.cross, dtype=dtype)
            if g.kind == "attn_moe":
                p[g.name].update(transformer.init_moe(
                    generator, cfg, g.size, dtype=dtype))
            elif cfg.d_ff:
                p[g.name].update(transformer.init_mlp(
                    generator, cfg, g.size, dtype=dtype))
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
            if t:
                spec[g.name] = t
        return spec

    # -- embedding / head ------------------------------------------------------

    def embed(self, params: Params, tokens, *, positions=None, prefix=None):
        """Token embeddings; a prefix ([N,] B, P, d) (the vlm frontend's
        patch embeddings) replaces the first P positions."""
        cfg = self.cfg
        x = params["embed"]["tok"][tokens.long()]
        if prefix is not None:
            plen = prefix.shape[-2]
            x = torch.cat([prefix.to(x.dtype), x[..., plen:, :]], dim=-2)
        if cfg.learned_pos:
            if positions is None:
                positions = torch.arange(tokens.shape[-1],
                                         device=tokens.device)
            pos_tab = params["embed"]["pos"]
            positions = torch.clamp(positions, 0, pos_tab.shape[0] - 1)
            x = x + pos_tab[positions.long()].to(x.dtype)
        return x

    def head(self, params: Params, x):
        if self.cfg.tie_embeddings:
            return x @ params["embed"]["tok"].T
        return x @ params["embed"]["head"]

    # -- block execution -------------------------------------------------------

    def run_blocks(self, params: Params, adapters: Optional[Params], x, *,
                   mode: str = "train", remat: str = "none",
                   cache: Optional[Params] = None, layer_lo: int = 0,
                   layer_hi: Optional[int] = None, boundary=None):
        """Run flat layers [layer_lo, layer_hi) over activations x
        ([N,] B, S, d).

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
        boundary included, in the backward (see the module docstring)."""
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
        rope = None
        if self.cfg.use_rope:
            # each slot's next position in decode, else 0..S-1 (a prefill
            # starts every request at 0)
            positions = (cache_len[..., None] if mode == "decode"
                         else torch.arange(x.shape[-2], device=x.device))
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
                c_l = None
                if cache is not None:
                    # views of layer i: the layer writes its cache there
                    c_l = _index_tree(cache[g.name], i)
                    if g.kind != "ssm":
                        c_l["len"] = cache_len
                        if pages is not None:
                            c_l["pages"] = pages
                layer = functools.partial(
                    self._layer, g, i, p_l, ad_l, mode=mode, cache=c_l,
                    rope=rope, boundary=boundary, fid=run_flat_lo + (i - lo))
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
               mode: str, cache, rope, boundary, fid: int):
        """One layer of group g (local index i, whose attention window is
        the group's per-layer window) and the cut-layer hook: (x, the
        stateful hook's carry or None, the layer's router loss)."""
        cfg = self.cfg
        aux = 0.0
        if g.kind == "ssm":
            out, new = ssm.ssm_apply(p_l, ad_l, x, cfg=cfg, mode=mode,
                                     cache=cache)
            if new is not None:
                for k in ("conv", "state"):
                    cache[k].copy_(new[k])
            x = x + out
        else:
            attn_out, _ = transformer.attention_apply(
                p_l, ad_l, x, cfg=cfg, mode=mode, causal=g.causal,
                window=g.window_of(i), rope=rope, cache=cache)
            x = x + attn_out
            if g.kind == "attn_moe":
                out, aux = transformer.moe_apply(p_l, ad_l, x, cfg=cfg)
                x = x + out
            elif cfg.d_ff:
                x = x + transformer.mlp_apply(p_l, ad_l, x, cfg=cfg)
        if getattr(boundary, "stateful", False):
            x, bcarry = boundary(x, bcarry, fid)
        elif boundary is not None:
            x = boundary(x, fid)
        return x, bcarry, aux

    # -- top-level entry points ------------------------------------------------

    def forward(self, params, adapters, batch, *, cache=None,
                mode: str = "train", remat: str = "none", boundary=None,
                return_boundary: bool = False):
        """Full forward to hidden states (pre-head).

        batch: {"tokens": ([N,] B, S)[, "prefix": ([N,] B, P, d)]}.
        Returns (x, aux, new_cache); aux is the MoE layers' summed router
        loss, 0.0 for every other kind.  return_boundary=True appends a
        stateful boundary's last carry (the smashed error-feedback
        residual)."""
        if "frames" in batch:
            raise NotImplementedError(
                "encoder frames (whisper) are not ported yet "
                f"({_FAMILIES})")
        cfg = self.cfg
        tokens = batch["tokens"]
        positions = (cache["len"][..., None] if mode == "decode"
                     else torch.arange(tokens.shape[-1],
                                       device=tokens.device))
        x = self.embed(params, tokens, positions=positions,
                       prefix=batch.get("prefix"))
        x, aux, new_cache, *bcarry = self.run_blocks(
            params, adapters, x, mode=mode, remat=remat, cache=cache,
            boundary=boundary)
        x = apply_norm(params["final_norm"], x, kind=cfg.norm,
                       eps=cfg.norm_eps)
        if return_boundary:
            return (x, aux, new_cache, *bcarry)
        return x, aux, new_cache

    def loss(self, params, adapters, batch, *, remat: str = "none",
             ce_chunk: int = 0, per_client: bool = False, boundary=None):
        """Next-token CE.  batch needs "tokens", "labels"[, "loss_mask"].

        per_client=True keeps the leading client axis un-reduced: returns
        ((N,) nll, metrics with (N,) entries), which the round engine
        weights and combines (paper formula 2).  `boundary` is the
        cut-layer hook (see run_blocks); a stateful (error-feedback)
        boundary's new residual comes back as metrics["smashed_ef"].
        `remat` and `ce_chunk` are the memory knobs of the module
        docstring."""
        stateful = bool(getattr(boundary, "stateful", False))
        x, aux, _, *bcarry = self.forward(
            params, adapters, batch, mode="train", remat=remat,
            boundary=boundary, return_boundary=stateful)
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        mask = (torch.ones(labels.shape, device=x.device) if mask is None
                else mask.float())
        keep = 1 if per_client else 0
        s = x.shape[-2]
        if ce_chunk and s > ce_chunk and s % ce_chunk == 0:
            sums = self._chunked_ce(params, x, labels, mask, ce_chunk, keep)
        else:
            sums = _ce_sums(self.head(params, x), labels, mask, keep)
        nll_sum, hits, cnt = sums
        cnt = torch.clamp(cnt, min=1.0)
        nll, acc = nll_sum / cnt, hits / cnt
        aux = torch.zeros((), device=x.device) + aux
        metrics = {"ce": nll, "aux": aux, "accuracy": acc, "tokens": cnt}
        if stateful:
            metrics["smashed_ef"] = bcarry[0]
        return nll + aux, metrics

    def _chunked_ce(self, params, x, labels, mask, chunk: int, keep: int):
        """The CE sums over sequence chunks, summed in chunk order from
        zero as the reference's scan; each chunk's head and sums are
        recomputed in the backward, so one chunk's logits are live."""
        def body(x_c, l_c, m_c):
            return _ce_sums(self.head(params, x_c), l_c, m_c, keep)

        zero = torch.zeros(x.shape[:keep], device=x.device)
        sums = (zero, zero, zero)
        for lo in range(0, x.shape[-2], chunk):
            part = (x[..., lo:lo + chunk, :], labels[..., lo:lo + chunk],
                    mask[..., lo:lo + chunk])
            got = (_recomputed(body, *part, remat="full")
                   if torch.is_grad_enabled() else body(*part))
            sums = tuple(a + b for a, b in zip(sums, got))
        return sums

    def encode(self, *args, **kwargs):
        raise NotImplementedError(
            f"Model.encode (whisper) is not ported yet ({_FAMILIES})")

    def prefill(self, params, adapters, batch, cache):
        x, _, cache = self.forward(params, adapters, batch, cache=cache,
                                   mode="prefill")
        return self.head(params, x[..., -1:, :]), cache

    def decode_step(self, params, adapters, tokens, cache):
        x, _, cache = self.forward(params, adapters, {"tokens": tokens},
                                   cache=cache, mode="decode")
        return self.head(params, x), cache

    # -- caches ----------------------------------------------------------------

    def init_cache(self, lead: Tuple[int, ...], max_len: int,
                   dtype=torch.float32) -> Params:
        """lead = (B,). One stacked entry per group, on this model's
        device: (Lg, B, max_len, KVH, hd) k and v for attention, and for
        SSM layers the conv window (Lg, B, W-1, C) in `dtype` and the
        state (Lg, B, H, P, N) in fp32."""
        cfg = self.cfg
        if len(lead) != 1:
            raise NotImplementedError(
                f"cache lead {lead}: caches with a client axis are not "
                f"ported yet ({_SERVING})")
        batch = lead[-1]
        cache: Params = {"len": torch.zeros((batch,), dtype=torch.int32,
                                            device=self.device)}
        for g in self.groups:
            if g.kind == "ssm":
                cache[g.name] = ssm.init_ssm_cache(
                    cfg, (g.size,) + tuple(lead), dtype, device=self.device)
                continue
            shape = (g.size,) + tuple(lead) + (max_len, cfg.num_kv_heads,
                                               cfg.head_dim)
            cache[g.name] = {
                "k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}
        return cache


    # -- input shapes ------------------------------------------------------------

    def input_specs(self, kind: str, seq_len: int, global_batch: int, *,
                    num_clients: int = 0, dtype=torch.float32
                    ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """{input: (shape, dtype)} of a "train", "prefill" or "decode"
        batch, as the reference's ``input_specs`` gives them (its
        ShapeConfig's seq_len, global_batch and kind); a train batch
        splits global_batch over num_clients when given.  The vlm family
        adds its "prefix" of frontend_prefix_len positions."""
        cfg = self.cfg
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
        return specs


def build_model(arch: ArchConfig, *, device: DeviceLike = None) -> Model:
    return Model(arch, device=device)
