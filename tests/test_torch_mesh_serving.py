"""Serving on a mesh, part 1: the pieces in one process.

The partial decode: a cache cut into 2 and 4 blocks, each block through
``decode_attention_partial`` (its plain version) and the blocks merged
by ``merge_partials``, is ``decode_attention`` over the whole cache
within 1e-6 in fp32, for GQA 1:1 and 4:1, windows 0 and 5, rows of
length 0, blocks with no valid position, and a length on a block edge.

Cache placement: on the (1, 4) and (2, 2) meshes each rank's
``local_cache`` of every family's cache at full width (on the meta
device) holds the block ``cache_specs`` gives it, by shape and bytes:
the batch over "data", the KV sequence, the conv channels and the state
heads over "model"; a capacity or a channel count that "model" does not
divide stays whole, and "seq_lo" says where the rank's KV block starts
(absent where the sequence is whole).  At reduced width
``Model.init_cache(policy=)`` gives local_cache's shapes, and the blocks
put back by their mesh coordinates are the whole cache.

The serve cell: ``build_serve_cell(shard=)`` on 2 "model" ranks (as
threads of this process) gives each rank's prefill and decode cell the
logits of the same cell on one rank, in bf16, with the prefill under
SP, for llama and whisper.

The audio family on "model" ranks (threads): reduced whisper served on
the (1, 4) and (2, 2) meshes matches the unsharded port within ATOL,
each rank's cross cache its cache_specs block with "xseq_lo" its first
position, a decode step reading through the partial kernel twice a
decoder layer; 18 frames over 4 ranks keep the cross cache whole (the
whole-cache kernel reads it) while the self cache is split; and the
cross read without its lse merge moves the logits past ATOL.

``reference_logits`` runs the JAX reference's unsharded prefill and
decode steps on a served case's weights, adapters and inputs, the
port's tokens fed, for the spawned cases' tests
(tests/test_torch_param_sharding*.py: the serving after the rounds,
tests/torch_mesh_serving_cases.py).

Time: ~10 s alone.
"""

import dataclasses
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_serving_cases as ms  # noqa: E402
from repro_torch.config import reduced  # noqa: E402
from repro_torch.config import MeshConfig, ShapeConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dref  # noqa: E402
from repro_torch.launch import cells  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.common import (NO_SHARDING,  # noqa: E402
                                       ShardingPolicy)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import serving as t_serving  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

MESHES = {"1x4": make_mesh(1, 4), "2x2": make_mesh(2, 2)}


class _Rank:
    """As much of a MeshShard as local_cache reads."""

    def __init__(self, rank):
        self.rank = rank


# ---------------------------------------------------------------------------
# the partial decode, merged


def _decode_case(seed, h, kvh, lens, s, hd=16):
    gen = torch.Generator().manual_seed(seed)
    b = len(lens)
    q = torch.randn((b, h, hd), generator=gen)
    k = torch.randn((b, s, kvh, hd), generator=gen)
    v = torch.randn((b, s, kvh, hd), generator=gen)
    return q, k, v, torch.tensor(lens, dtype=torch.int32)


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("gqa", [(4, 4), (8, 2)], ids=["1to1", "4to1"])
def test_partial_blocks_merge_to_the_whole_cache(blocks, window, gqa):
    """Lengths 0, 1 (every later block empty), one short of, on and past
    a block edge, and the whole capacity."""
    h, kvh = gqa
    s = 24
    n = s // blocks
    lens = [0, 1, n - 1, n, n + 1, 2 * n + 3, s]
    q, k, v, clen = _decode_case(blocks + window + h, h, kvh, lens, s)
    parts = [dref.decode_attention_partial(q, k[:, lo:lo + n],
                                           v[:, lo:lo + n], clen, lo,
                                           window=window)
             for lo in range(0, s, n)]
    got = dref.merge_partials([o for o, _ in parts], [m for _, m in parts])
    want = dref.decode_attention(q, k, v, clen, window=window)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    # the row of length 1: every block after the first saw no position
    for o, m in parts[1:]:
        assert torch.equal(o[1], torch.zeros_like(o[1]))
        assert torch.isneginf(m[1]).all()


def test_partial_block_on_the_whole_cache_is_the_whole_decode():
    """One block that is the whole cache: decode_attention's output."""
    q, k, v, clen = _decode_case(3, 8, 2, [0, 3, 17, 24], 24)
    o, lse = dref.decode_attention_partial(q, k, v, clen, 0, window=5)
    torch.testing.assert_close(dref.merge_partials([o], [lse]),
                               dref.decode_attention(q, k, v, clen,
                                                     window=5),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# cache placement

FAMILIES = ("llama3-8b", "kimi-k2-1t-a32b", "mamba2-780m", "zamba2-1.2b",
            "internvl2-76b", "whisper-medium")
ORIGINS = tuple(sh.SEQ_ORIGINS)


def _meta_cache(model, b, cap):
    """The model's whole cache at full width, as meta tensors."""
    with FakeTensorMode():
        cache = model.init_cache((b,), cap, torch.bfloat16)
    return sh.tree_map_with_path(
        lambda _, x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
        cache)


def _want_shape(name, shape, m):
    sizes = sh.axis_sizes(m)
    spec = sh.cache_spec(name, shape, m) or (None,) * len(shape)
    out = []
    for n, entry in zip(shape, spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        out.append(n // int(np.prod([sizes[a] for a in axes])))
    return tuple(out)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("cap", [4096, 4095])
def test_local_cache_holds_the_cache_specs_blocks(name, mesh, cap):
    """Full width, on meta tensors, batch 8: each leaf's block by shape
    and bytes; a capacity of 4095 (no axis divides it) keeps the KV
    sequence whole and sets no seq_lo, while whisper's cross cache (1500
    positions, which 2 and 4 divide) is split all the same, its block's
    first position in xseq_lo."""
    m = MESHES[mesh]
    model = build_model(get_config(name), device="cpu")
    whole = _meta_cache(model, 8, cap)
    tp = sh.axis_sizes(m)["model"]
    for r in range(m.num_devices):
        local = sh.local_cache(whole, m, _Rank(r))
        got = dict(tree_leaves_with_path(
            {k: v for k, v in local.items() if k not in ORIGINS}))
        for keys, leaf in tree_leaves_with_path(whole):
            want = _want_shape(keys[-1], tuple(leaf.shape), m)
            assert tuple(got[keys].shape) == want, keys
            assert got[keys].numel() * got[keys].element_size() == (
                int(np.prod(want)) * leaf.element_size()), keys
        assert tuple(local["len"].shape) == (8,)
        names = {k[-1] for k, _ in tree_leaves_with_path(whole)}
        m_rank = sh.mesh_coords(m, r)["model"]
        for key, name, n in (("seq_lo", "k", cap),
                             ("xseq_lo", "xk", model.cfg.encoder_seq_len)):
            if name in names and n % tp == 0:
                assert local[key] == m_rank * (n // tp), key
            else:
                assert key not in local, key


@pytest.mark.parametrize("mesh", list(MESHES))
def test_init_cache_gives_local_cache_blocks_that_put_back_whole(mesh):
    """zamba2 at reduced width (SSM and attention layers; conv channels
    160 over 4 ranks): Model.init_cache(policy=) has local_cache's
    shapes and seq_lo, and the blocks of a whole cache put back by their
    mesh coordinates are the whole cache."""
    m = MESHES[mesh]
    arch = reduced(get_config("zamba2-1.2b"), layers=3, d_model=64)
    model = build_model(arch, device="cpu")
    gen = torch.Generator().manual_seed(0)
    whole = model.init_cache((4,), 16)
    whole = sh.tree_map_with_path(
        lambda _, t: torch.randn(t.shape, generator=gen).to(t.dtype)
        if t.is_floating_point() else t, whole)
    sizes = sh.axis_sizes(m)
    back = sh.tree_map_with_path(lambda _, t: torch.zeros_like(t), whole)
    for r in range(m.num_devices):
        policy = ShardingPolicy(types_shard(m, r))
        made = model.init_cache((4,), 16, policy=policy)
        local = sh.local_cache(whole, m, _Rank(r))
        assert made.get("seq_lo") == local.get("seq_lo")
        shapes = dict(tree_leaves_with_path(
            {k: v for k, v in local.items() if k not in ORIGINS}))
        for keys, t in tree_leaves_with_path(
                {k: v for k, v in made.items() if k not in ORIGINS}):
            assert t.shape == shapes[keys].shape, keys
        coords = sh.mesh_coords(m, r)
        for keys, blk in shapes.items():
            full = dict(tree_leaves_with_path(back))[keys]
            spec = sh.cache_spec(keys[-1], tuple(full.shape), m)
            view = full
            for dim, entry in enumerate(spec or ()):
                if entry is None:
                    continue
                axes = entry if isinstance(entry, tuple) else (entry,)
                idx = 0
                for a in axes:
                    idx = idx * sizes[a] + coords[a]
                n = blk.shape[dim]
                view = view.narrow(dim, idx * n, n)
            view.copy_(blk)
    for keys, t in tree_leaves_with_path(whole):
        assert torch.equal(dict(tree_leaves_with_path(back))[keys], t), keys


def types_shard(mesh, rank):
    """As much of a MeshShard as ShardingPolicy and init_cache read."""
    coords = sh.mesh_coords(mesh, rank)
    sizes = sh.axis_sizes(mesh)
    return types.SimpleNamespace(
        mesh=mesh, rank=rank, model_size=sizes["model"],
        model_rank=coords["model"], data_size=sizes["data"],
        data_rank=coords["data"])


def test_serve_prompts_cross_a_block_edge():
    """The spawned cases' decode steps write on both sides of a block
    edge on 2 and 4 "model" ranks, for the vlm family's longer prompt
    too."""
    for name in ("llama3-8b", "internvl2-76b"):
        cfg = get_config(name).model
        for tp in (2, 4):
            assert ms.crosses_a_block_edge(cfg, tp), (name, tp)


# ---------------------------------------------------------------------------
# the JAX reference's serving, for the spawned cases


def reference_logits(j_model, params_np, served) -> np.ndarray:
    """The JAX reference's unsharded prefill and STEPS decode steps on
    `params_np` and a served case's adapters and inputs (its plain run),
    each decode step fed the port's token: (B, 1 + STEPS, V)."""
    _, cap = ms.prompt_of(j_model.cfg)
    params = jax.tree.map(jnp.asarray, params_np)
    ad = jax.tree.map(jnp.asarray, served["adapters"])
    prefill = jax.jit(j_model.prefill)
    decode = jax.jit(j_model.decode_step)
    logits, cache = prefill(params, ad, jax.tree.map(jnp.asarray,
                                                     served["inputs"]),
                            j_model.init_cache((ms.BATCH,), cap))
    out = [np.asarray(logits)]
    for t in range(ms.STEPS):
        logits, cache = decode(params, ad,
                               jnp.asarray(served["tokens"][:, t:t + 1]),
                               cache)
        out.append(np.asarray(logits))
    return np.concatenate(out, 1)


def held_to_the_reference(j_model, params_np, served) -> float:
    """The unsharded port's serving logits against the reference's within
    REF_ATOL; returns the largest |diff|."""
    want = reference_logits(j_model, params_np, served)
    gap = float(np.abs(served["logits"] - want).max())
    assert gap <= ms.REF_ATOL, gap
    return gap


def cache_blocks_held(runs_by_rank, whole_shapes, mesh, cfg, cap=None):
    """Each rank's cache leaves have cache_specs' block shapes of the
    whole cache's, seq_lo starts its "model" block of the KV cache and
    xseq_lo its block of the cross cache (each where "model" divides the
    capacity, absent where it does not), and the decode steps cross a
    block edge."""
    sizes = sh.axis_sizes(mesh)
    tp = sizes["model"]
    cap = cap or ms.prompt_of(cfg)[1]
    names = {p.split("/")[-1] for p in whole_shapes}
    for r, got in enumerate(runs_by_rank):
        for path, shape in whole_shapes.items():
            want = _want_shape(path.split("/")[-1], shape, mesh)
            assert got["cache"][path] == want, (r, path)
        m = sh.mesh_coords(mesh, r)["model"]
        for key, name, n in (("seq_lo", "k", cap),
                             ("xseq_lo", "xk", cfg.encoder_seq_len)):
            split = name in names and tp > 1 and n % tp == 0
            assert got.get(key) == (m * (n // tp) if split else None), (
                r, key)
    if "k" in names and tp > 1 and cap % tp == 0:
        assert ms.crosses_a_block_edge(cfg, tp)


# ---------------------------------------------------------------------------
# the serve cell on "model" ranks (threads of this process)


class _ThreadShard:
    """A MeshShard's rank as a thread: an all-reduce waits for every
    rank's tensors and sums (or maxes) those of the ranks on its axes in
    rank order."""

    places_params = True
    seq_shard = None

    def __init__(self, hub, mesh, rank):
        self.hub, self.mesh, self.rank = hub, mesh, rank
        self.device = torch.device("cpu")
        sizes, coords = sh.axis_sizes(mesh), sh.mesh_coords(mesh, rank)
        self.model_size, self.model_rank = sizes["model"], coords["model"]
        self.data_size, self.data_rank = sizes["data"], coords["data"]

    def all_reduce(self, tensors, op, axis="data"):
        axes = [a for a in ((axis,) if isinstance(axis, str) else axis)
                if a in ("data", "model")]
        hub = self.hub
        hub["slots"][self.rank] = [t.detach().clone() for t in tensors]
        hub["barrier"].wait()
        line = next(r for r in sh.axis_ranks(self.mesh, axes)
                    if self.rank in r)
        out = []
        for i in range(len(tensors)):
            acc = hub["slots"][line[0]][i]
            for r in line[1:]:
                t = hub["slots"][r][i]
                acc = acc + t if op == "sum" else torch.maximum(acc, t)
            out.append(acc)
        hub["barrier"].wait()
        return out


def _on_ranks(mesh, fn):
    n = mesh.num_devices
    hub = {"slots": {}, "barrier": threading.Barrier(n)}
    got, errs = [None] * n, []

    def run(r):
        try:
            got[r] = fn(_ThreadShard(hub, mesh, r))
        except BaseException as e:   # noqa: BLE001 - re-raised below
            errs.append(e)
            hub["barrier"].abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return got


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", ["llama3-8b", "whisper-medium"])
def test_serve_cell_on_model_ranks_matches_one_rank(name, kind):
    """llama at reduced width (4 heads over 2 KV heads of 16) and whisper
    (4 heads of 16, 16 frames: each rank's cross cache holds 8), batch
    2, seq 8 (a decode step over a capacity of 8: each rank's cache
    holds 4 positions); the ranks' logits within bf16's tolerance of one
    rank's."""
    arch = reduced(get_config(name), layers=2, d_model=64, vocab=512)
    if name == "llama3-8b":
        arch = arch.replace(model=dataclasses.replace(
            arch.model, num_heads=4, num_kv_heads=2, head_dim=16))
    shape = ShapeConfig(kind, 8, 2, kind)

    def run(shard):
        cell = cells.build_serve_cell(arch, shape, shard=shard)
        logits, cache = cell.fn(*cell.args)
        return logits.float(), cache.get("seq_lo"), cache.get("xseq_lo")

    (want, lo1, xlo1), = _on_ranks(MeshConfig((1, 1), ("data", "model")),
                                   run)
    got = _on_ranks(MeshConfig((1, 2), ("data", "model")), run)
    assert lo1 is None and [g[1] for g in got] == [0, 4]
    assert xlo1 is None and [g[2] for g in got] == (
        [0, 8] if name == "whisper-medium" else [None, None])
    # whisper rounds to bf16 more often (an encoder, then the decoder and
    # its cross read): its ranks' prefill logits sit 1.6 bf16 steps from
    # one rank's at max|logit| 3.3 (1.1e-6 apart when the cell is fp32),
    # so its atol is bf16's scaled by max|logit|
    atol = 2e-2 * (1.0 if name == "llama3-8b" else float(want.abs().max()))
    for g, _, _ in got:
        torch.testing.assert_close(g, want, rtol=2e-2, atol=atol)


# ---------------------------------------------------------------------------
# the audio family on "model" ranks (threads of this process): the cross
# cache split over "model"

W_BATCH, W_CAP = 4, 16


def _whisper(enc_len: int, targets=None):
    """whisper-medium at reduced width: 2 + 2 layers, 4 heads of 16
    (MHA), vocabulary 512, `enc_len` frames; LoRA `targets` (None: the
    config's q, k, v, o)."""
    arch = reduced(get_config("whisper-medium"), layers=2, d_model=64,
                   vocab=512)
    arch = arch.replace(model=dataclasses.replace(arch.model,
                                                  encoder_seq_len=enc_len))
    if targets is None:
        return arch
    return arch.replace(lora=dataclasses.replace(arch.lora,
                                                 targets=targets))


def _serve_whisper(arch, shard):
    """The weights and a pool of one adapter drawn from seeds, placed on
    `shard`'s blocks (None: unsharded), a prefill of ms.DEFAULT_PROMPT's
    prompt with seeded frames for W_BATCH rows into a W_CAP cache, and
    ms.STEPS decode steps fed seeded tokens: (logits (B, 1 + STEPS, V),
    {cache leaf: shape}, seq_lo, xseq_lo)."""
    model = build_model(arch, device="cpu")
    cfg = model.cfg
    full = model.init_params(torch.Generator().manual_seed(0))
    pool = t_serving.build_adapter_pool(
        model, torch.Generator().manual_seed(1), 1)
    policy, params = NO_SHARDING, full
    if shard is not None:
        policy = ShardingPolicy.for_model(shard, arch)
        params = sh.local_params(full, shard.mesh, shard)
        pool, policy = model.serving_blocks(params, pool, policy)
    rng = np.random.default_rng(3)
    s, _ = ms.DEFAULT_PROMPT
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (W_BATCH, s)).astype(np.int32)),
        "frames": torch.from_numpy(rng.standard_normal(
            (W_BATCH, cfg.encoder_seq_len, cfg.d_model)).astype(
                np.float32))}
    fed = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (ms.STEPS, W_BATCH, 1)).astype(np.int32))
    ad = t_serving.attach_ids(pool, np.zeros(W_BATCH, np.int32))
    cache = model.init_cache((W_BATCH,), W_CAP, policy=policy)
    with torch.no_grad():
        out = [model.prefill(params, ad, batch, cache, policy=policy)[0]]
        for tok in fed:
            out.append(model.decode_step(params, ad, tok, cache,
                                         policy=policy)[0])
    return (torch.cat(out, 1).numpy(),
            {"/".join(k): tuple(v.shape)
             for k, v in tree_leaves_with_path(cache)
             if isinstance(v, torch.Tensor)},
            cache.get("seq_lo"), cache.get("xseq_lo"))


def _reads(monkeypatch):
    """Counts of the decode kernels' calls (every rank's together)."""
    from repro_torch.kernels.decode_attention import ops as dops
    calls = {"decode_attention": 0, "decode_attention_partial": 0}
    for name in calls:
        fn = getattr(dops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(dops, name, counted)
    return calls


def _whisper_held(arch, mesh, monkeypatch):
    """Every rank's served logits against the unsharded run's (ATOL, the
    tokens equal) and its cache blocks against cache_specs'; returns the
    decode kernels' calls per decode step and rank."""
    want, whole, _, _ = _serve_whisper(arch, None)
    calls = _reads(monkeypatch)
    got = _on_ranks(mesh, lambda shard: _serve_whisper(arch, shard))
    runs = [{"logits": g[0], "tokens": g[0].argmax(-1), "len": 0,
             "cache": g[1], "seq_lo": g[2], "xseq_lo": g[3]} for g in got]
    for run in runs:
        ms.held(run, {"logits": want, "tokens": want.argmax(-1), "len": 0})
    cache_blocks_held(runs, whole, mesh, arch.model, cap=W_CAP)
    n = mesh.num_devices * ms.STEPS
    return {k: c / n for k, c in calls.items()}


@pytest.mark.parametrize("targets", [None, ("q", "k", "v", "o", "xq")],
                         ids=["qkvo", "cross_targets"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_whisper_served_on_a_mesh_holds_the_cross_blocks(mesh, targets,
                                                         monkeypatch):
    """16 frames: each rank's cross cache is its block of 16 / tp
    positions (xseq_lo its first), its self cache 16 / tp slots; the
    logits within ATOL of the unsharded run's; a decode step calls the
    partial kernel twice a decoder layer (the self and the cross read)
    and the whole-cache kernel never.  With the cross projections as
    LoRA targets too ("xq": xq and xo), serving_blocks narrows their
    adapters to the rank's heads of xwq and rows of xwo."""
    arch = _whisper(16, targets)
    calls = _whisper_held(arch, MESHES[mesh], monkeypatch)
    assert calls == {"decode_attention": 0,
                     "decode_attention_partial": 2 * arch.model.num_layers}


def test_frames_model_does_not_divide_keep_the_cross_cache_whole(
        monkeypatch):
    """18 frames over 4 "model" ranks: the cross cache stays whole on
    every rank (no xseq_lo: fit_spec's rule) and its read is the
    whole-cache kernel, while the self cache is split and read by the
    partial kernel; the logits within ATOL of the unsharded run's."""
    arch = _whisper(18)
    calls = _whisper_held(arch, MESHES["1x4"], monkeypatch)
    assert calls == {"decode_attention": arch.model.num_layers,
                     "decode_attention_partial": arch.model.num_layers}


def test_dropping_the_cross_lse_merge_moves_the_logits(monkeypatch):
    """The cross read keeping this rank's partial output (no merge of the
    ranks' (o, lse)) moves the logits past ATOL: the check above sees
    the merge."""
    arch = _whisper(16)
    want, _, _, _ = _serve_whisper(arch, None)
    cross = transformer._cross_attention

    def unmerged(*a, policy, **kw):
        return cross(*a, policy=policy._with(
            merge_decode=lambda o, lse: o), **kw)

    monkeypatch.setattr(transformer, "_cross_attention", unmerged)
    got = _on_ranks(MESHES["1x4"], lambda shard: _serve_whisper(arch, shard))
    for g in got:
        assert np.abs(g[0] - want).max() > ms.ATOL
