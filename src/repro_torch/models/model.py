"""Model factory: block groups composed into a decoder, for training and
serving.

Port of src/repro/models/model.py.  A model is a list of block groups
(homogeneous stacks with parameters stacked along a leading layer axis)
plus embedding and head; ``flat_runs`` gives the execution order.  Here
the layers run as a Python loop (the reference scans them).

Entry points (parameters and adapters are passed explicitly, as in the
reference, as nested dicts of tensors with the reference's names):

  init_params(generator, dtype)                   -> params
  loss(params, adapters, batch, per_client, boundary) -> (loss, metrics)
  prefill(params, adapters, batch, cache)         -> (logits_last, cache)
  decode_step(params, adapters, tokens, cache)    -> (logits, cache)
  init_cache(lead, max_len, dtype)                -> cache

Training activations carry the client axis first ((N, B, S, d)); caches
are updated in place and returned.  This slice ports the dense decoder
with learned positions (gpt2-small) and, for training, the SSM kind
(mamba2-780m, ``models/ssm.py``).  ``remat`` other than "none", chunked
cross entropy (``ce_chunk``), stateful (error-feedback) cut boundaries,
the encoder, the MoE kind and SSM caches raise NotImplementedError with a
pointer to ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch import roadmap
from repro_torch.config import ArchConfig, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import common, ssm, transformer
from repro_torch.models.common import apply_norm

Params = Dict[str, Any]

_LATER = roadmap.ENGINE_OPTIONS
_FAMILIES = roadmap.FAMILIES


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
    if cfg.family not in ("dense", "ssm"):
        return f"the {cfg.family} family"
    if cfg.use_rope:
        return "RoPE"
    if cfg.local_window:
        return "sliding-window layers"
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
        """Random weights from `generator` (a CPU generator: the draw is
        the same for every device), moved to this model's device."""
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
            if cfg.d_ff:
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

    def embed(self, params: Params, tokens, *, positions=None):
        cfg = self.cfg
        x = params["embed"]["tok"][tokens.long()]
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
                   mode: str = "train", cache: Optional[Params] = None,
                   layer_lo: int = 0, layer_hi: Optional[int] = None,
                   boundary=None):
        """Run flat layers [layer_lo, layer_hi) over activations x
        ([N,] B, S, d).

        mode: "train" (full sequences, no cache), "prefill" (full
        sequences; fills `cache` if given) or "decode" (one token per slot
        against `cache`).  Returns (x, new_cache); the cache's k/v tensors
        are written in place.

        `boundary(x, flat_id) -> x` is applied to every layer output with
        its flat layer id: the round engine compresses the smashed
        activation there, where each client's cut sits."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        if getattr(boundary, "stateful", False):
            raise NotImplementedError(
                f"stateful (error-feedback) cut boundaries are not ported "
                f"yet ({_LATER})")
        cfg = self.cfg
        hi_total = self.num_flat_layers if layer_hi is None else layer_hi
        cache_len = cache["len"] if cache is not None else None
        pages = cache.get("pages") if cache is not None else None

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
                if g.kind == "ssm":
                    out, _ = ssm.ssm_apply(p_l, ad_l, x, cfg=cfg, mode=mode,
                                           cache=cache)
                    x = x + out
                else:
                    c_l = None
                    if cache is not None:
                        c_l = {"k": cache[g.name]["k"][i],
                               "v": cache[g.name]["v"][i], "len": cache_len}
                        if pages is not None:
                            c_l["pages"] = pages
                    attn_out, _ = transformer.attention_apply(
                        p_l, ad_l, x, cfg=cfg, mode=mode, causal=g.causal,
                        window=g.window_of(i), cache=c_l)
                    x = x + attn_out
                    if cfg.d_ff:
                        x = x + transformer.mlp_apply(p_l, ad_l, x, cfg=cfg)
                if boundary is not None:
                    x = boundary(x, run_flat_lo + (i - lo))
        new_cache = None
        if cache is not None:
            new_cache = dict(cache)
            step = 1 if mode == "decode" else x.shape[-2]
            new_cache["len"] = cache_len + step
        return x, new_cache

    # -- top-level entry points ------------------------------------------------

    def forward(self, params, adapters, batch, *, cache=None,
                mode: str = "train", boundary=None):
        """Full forward to hidden states (pre-head).

        batch: {"tokens": ([N,] B, S)}.  Returns (x, aux, new_cache); aux
        is the MoE router loss in the reference, 0 for the dense decoder."""
        if "prefix" in batch or "frames" in batch:
            raise NotImplementedError(
                "modality prefixes and encoder frames are not ported yet "
                f"({_FAMILIES})")
        cfg = self.cfg
        tokens = batch["tokens"]
        positions = (cache["len"][..., None] if mode == "decode"
                     else torch.arange(tokens.shape[-1],
                                       device=tokens.device))
        x = self.embed(params, tokens, positions=positions)
        x, new_cache = self.run_blocks(params, adapters, x, mode=mode,
                                       cache=cache, boundary=boundary)
        x = apply_norm(params["final_norm"], x, kind=cfg.norm,
                       eps=cfg.norm_eps)
        return x, 0.0, new_cache

    def loss(self, params, adapters, batch, *, remat: str = "none",
             ce_chunk: int = 0, per_client: bool = False, boundary=None):
        """Next-token CE.  batch needs "tokens", "labels"[, "loss_mask"].

        per_client=True keeps the leading client axis un-reduced: returns
        ((N,) nll, metrics with (N,) entries), which the round engine
        weights and combines (paper formula 2).  `boundary` is the
        cut-layer hook (see run_blocks)."""
        if remat != "none":
            raise NotImplementedError(
                f"remat={remat!r} is not ported yet ({_LATER}); the round "
                f"engine's default is 'none'")
        if ce_chunk:
            raise NotImplementedError(
                f"chunked cross entropy (ce_chunk={ce_chunk}) is not ported "
                f"yet ({_LATER})")
        x, aux, _ = self.forward(params, adapters, batch, mode="train",
                                 boundary=boundary)
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        mask = (torch.ones(labels.shape, device=x.device) if mask is None
                else mask.float())
        nll_sum, hits, cnt = _ce_sums(self.head(params, x), labels, mask,
                                      1 if per_client else 0)
        cnt = torch.clamp(cnt, min=1.0)
        nll, acc = nll_sum / cnt, hits / cnt
        aux = torch.zeros((), device=x.device) + aux
        metrics = {"ce": nll, "aux": aux, "accuracy": acc, "tokens": cnt}
        return nll + aux, metrics

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
        """lead = (B,). One stacked (Lg, B, max_len, KVH, hd) entry per
        group, on this model's device."""
        cfg = self.cfg
        if len(lead) != 1:
            raise NotImplementedError(
                f"cache lead {lead}: caches with a client axis are not "
                f"ported yet ({_LATER})")
        if any(g.kind == "ssm" for g in self.groups):
            raise NotImplementedError(f"{self.arch.name}: {ssm.SERVING_LATER}")
        batch = lead[-1]
        cache: Params = {"len": torch.zeros((batch,), dtype=torch.int32,
                                            device=self.device)}
        for g in self.groups:
            shape = (g.size,) + tuple(lead) + (max_len, cfg.num_kv_heads,
                                               cfg.head_dim)
            cache[g.name] = {
                "k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}
        return cache


def build_model(arch: ArchConfig, *, device: DeviceLike = None) -> Model:
    return Model(arch, device=device)
