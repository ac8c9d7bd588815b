"""Serving after a training round, on a MeshShard's blocks and unsharded:
the part of the parameter-sharding cases (tests/torch_param_sharding*_
cases.py) that their spawned ranks run after their rounds.

This module imports torch and the port only, so the ranks start without
JAX.  ``serve`` takes a case's trained system: ``serve_model`` (under a
MeshShard: the rank's base blocks, the adapters at their blocks and the
policy), a cache from ``Model.init_cache`` (the rank's blocks, as
``cache_specs`` places them), a prefill of PROMPT tokens (and the vlm
family's prefix, or the audio family's frames) for BATCH rows, then
STEPS greedy decode steps, each fed the argmax of the step before.  The capacity puts the prompt and
the decoded positions on both sides of a block edge of the KV sequence
on every "model" axis of 2 and 4 ranks (``crosses_a_block_edge``), and
BATCH rows divide over every "data" and "pod" axis the spawns use.

What it returns (numpy, picklable): the logits of every step (B, 1 +
STEPS, V) and the tokens (B, 1 + STEPS), the same on every rank; the
shape of each leaf of the rank's cache and its "seq_lo" and "xseq_lo"
(the cross cache's block); and, for the
JAX reference's run of the same steps, the served adapters (unsharded
runs only) and the inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.cells import served_adapters
from repro_torch.models.common import NO_SHARDING
from repro_torch.tree import tree_leaves_with_path, tree_map

BATCH = 4
STEPS = 5
# family -> (prompt length, cache capacity): the decode steps write
# positions [PROMPT, PROMPT + STEPS), across the block edge at 8 (2
# "model" ranks) and at 8 or 12 (4 ranks); the vlm prompt outruns its
# 8-position prefix
PROMPT = {"vlm": (10, 24)}
DEFAULT_PROMPT = (6, 16)
# the logits of a sharded run against the unsharded port's (fp32): the
# row-parallel products and the vocabulary's logits sum in another
# order, and the attention over a split cache merges by log-sum-exp
# (measured up to 4.5e-6 from the reference's weights; 4.2e-5 for
# gpt2_int8 from the port's own, whose trained adapters carry the int8
# codes' flips)
ATOL = 2e-4
# the unsharded port's logits against the JAX reference's, the same
# weights and adapters, the port's tokens fed to both: ~4x the largest
# gap measured (4.9e-6, zamba2_hybrid)
REF_ATOL = 2e-5


def prompt_of(cfg):
    return PROMPT.get(cfg.family, DEFAULT_PROMPT)


def inputs(cfg) -> dict:
    """The prompt (and the prefix or the frames) as numpy arrays, drawn
    from a seed."""
    s, _ = prompt_of(cfg)
    rng = np.random.default_rng(11)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, s)).astype(
        np.int32)}
    if cfg.family == "vlm":
        out["prefix"] = rng.standard_normal(
            (BATCH, cfg.frontend_prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (BATCH, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return out


def crosses_a_block_edge(cfg, blocks: int) -> bool:
    """Whether the decode steps write on both sides of an edge of one of
    `blocks` equal blocks of the capacity."""
    s, cap = prompt_of(cfg)
    n = cap // blocks
    return any(s < e < s + STEPS for e in range(n, cap, n))


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else np.asarray(t), tree)


def serve(system, device="cpu") -> dict:
    model = system.model
    cfg = model.cfg
    got = system.serve_model()
    base, eff = got[0], got[1]
    policy = got[2] if len(got) == 3 else NO_SHARDING
    _, cap = prompt_of(cfg)
    feed = inputs(cfg)
    batch = {k: torch.as_tensor(v, device=device) for k, v in feed.items()}
    cache = model.init_cache((BATCH,), cap, policy=policy)
    pool = served_adapters(eff, BATCH)
    steps = []
    with torch.no_grad():
        logits, cache = model.prefill(base, pool, batch, cache,
                                      policy=policy)
        steps.append(logits)
        for _ in range(STEPS):
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            logits, cache = model.decode_step(base, pool, tok, cache,
                                              policy=policy)
            steps.append(logits)
    logits = torch.cat(steps, 1)
    out = {"logits": logits.cpu().numpy(),
           "tokens": logits.argmax(-1).to(torch.int32).cpu().numpy(),
           "len": cache["len"].cpu().numpy(),
           "seq_lo": cache.get("seq_lo"),
           "xseq_lo": cache.get("xseq_lo"),
           "cache": {"/".join(k): tuple(v.shape) for k, v in
                     tree_leaves_with_path(cache)
                     if isinstance(v, torch.Tensor)},
           "inputs": feed}
    if policy is NO_SHARDING:
        out["adapters"] = _numpy(eff)
    return out


def held(got: dict, want: dict) -> float:
    """A sharded run's serving against the unsharded port's: the same
    tokens, logits within ATOL, the whole "len"; returns the largest
    |diff|."""
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["len"], want["len"])
    gap = float(np.abs(got["logits"] - want["logits"]).max())
    assert gap <= ATOL, gap
    return gap
