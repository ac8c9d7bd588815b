"""Caches with a client axis: serving over a cache of lead (N, B).

The reference's ``Model.init_cache`` takes a lead of ([N,] B): k/v (Lg,
N, B, S, KVH, hd), the cross cache (Lg, N, B, S_enc, KVH, hd), the SSM
conv window and state (Lg, N, B, ...), and "len" (B,), shared over the
clients.  Its prefill and decode_step run over (N, B, S) tokens (and a
vlm prefix or audio frames with the same lead) and return (N, B, 1, V)
logits.  For one config of each family at reduced width (gpt2-small and
llama3-8b for the dense family's learned positions and RoPE with GQA,
kimi-k2, internvl2-76b, whisper-medium, mamba2-780m, zamba2-1.2b):

* the port's ``init_cache((N, B))`` has the reference's shapes and
  dtypes, leaf by leaf;
* a prefill of N x B seeded prompts and DECODE_STEPS decode steps over
  such a cache, from the reference's weights and adapters, match the
  reference's jitted prefill and decode_step within TOL, fed the same
  tokens (the prompt outruns the vlm prefix), with the adapters as a
  pool with one id per client (ids (N,): the indexed LoRA's rows are
  x's leading axis, the clients) and as per-client adapters (a pool of
  N without ids, the training layout); the caches' leaves agree too;
* the port's logits over the (N, B) cache equal those of the same N x B
  rows served over a (N B,) lead, each row its client's adapter, within
  1e-6 of max|logit|;
* where the reference raises, the port raises the same class: a pool's
  ids of (B,) (one per row of B, not per client) is a ValueError in both
  for every family.  A client axis under a MeshShard, which no caller of
  the reference reaches, raises NotImplementedError with the ROADMAP
  pointer.

Time: ~70 s alone (one jit of the reference's prefill and decode per
case).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.runtime import serving as j_serving  # noqa: E402
from repro_torch import bridge, roadmap  # noqa: E402
from repro_torch.config import reduced as t_reduced  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.common import ShardingPolicy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import serving as t_serving  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

FAMILIES = ("gpt2-small", "llama3-8b", "kimi-k2-1t-a32b", "internvl2-76b",
            "whisper-medium", "mamba2-780m", "zamba2-1.2b")
SMALL = dict(d_model=32, vocab=256, seq_len=16)
N, B, PROMPT, CAP, DECODE_STEPS = 3, 2, 10, 16, 3
POOL = 4
IDS = [0, 3, 1]          # one adapter per client
TOL = dict(rtol=2e-4, atol=2e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


_BUILT = {}


def _pair(name):
    """(reference model, its params, its pool), (port model, params,
    pool): the same weights and a pool of POOL adapters."""
    if name not in _BUILT:
        j_model = j_build_model(j_reduced(j_get_config(name), **SMALL))
        params = j_model.init_params(jax.random.PRNGKey(0))
        pool = j_serving.build_adapter_pool(j_model, jax.random.PRNGKey(1),
                                            POOL)
        t_model = build_model(t_reduced(t_get_config(name), **SMALL),
                              device="cpu")
        _BUILT[name] = ((j_model, params, pool),
                        (t_model, bridge.params_from_numpy(_np(params),
                                                           "cpu"),
                         bridge.pool_from_numpy(_np(pool), "cpu")))
    return _BUILT[name]


def _inputs(cfg, lead):
    """The prompt (and the frontend's input) for `lead`, numpy, seeded."""
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab_size, lead + (PROMPT,)
                                  ).astype(np.int32)}
    if cfg.family == "vlm":
        out["prefix"] = rng.standard_normal(
            lead + (cfg.frontend_prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            lead + (cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return out


def _steps(lead):
    rng = np.random.default_rng(8)
    return rng.integers(0, SMALL["vocab"], (DECODE_STEPS,) + lead + (1,)
                        ).astype(np.int32)


def _client_adapters(pool, kind, take=None):
    """The adapters of N clients: a pool with one id per client
    ("pool"), or the clients' own adapters, a pool of N without ids
    ("clients"), as a tree of `take`'s leaves (numpy or torch)."""
    if kind == "pool":
        return pool, np.asarray(IDS, np.int32)
    return take(pool, IDS), None


def _take_np(pool, idx):
    return jax.tree.map(lambda a: a[:, np.asarray(idx)], pool)


def _take_t(pool, idx):
    ix = torch.as_tensor(idx)
    return {g: {t: {k: v.index_select(1, ix) for k, v in ad.items()}
                for t, ad in targets.items()}
            for g, targets in pool.items()}


def _serve_port(model, params, adapters, feed, steps, lead):
    cache = model.init_cache(lead, CAP)
    out = []
    with torch.no_grad():
        logits, cache = model.prefill(
            params, adapters, {k: torch.from_numpy(v) for k, v in
                               feed.items()}, cache)
        out.append(logits)
        for tok in steps:
            logits, cache = model.decode_step(params, adapters,
                                              torch.from_numpy(tok), cache)
            out.append(logits)
    return torch.cat(out, -2).numpy(), cache


@pytest.mark.parametrize("name", FAMILIES)
def test_init_cache_has_the_reference_shapes_and_dtypes(name):
    (j_model, _, _), (t_model, _, _) = _pair(name)
    want = dict(tree_leaves_with_path(_np(j_model.init_cache((N, B), CAP))))
    got = dict(tree_leaves_with_path(t_model.init_cache((N, B), CAP)))
    assert set(got) == set(want)
    for keys, leaf in got.items():
        assert tuple(leaf.shape) == want[keys].shape, keys
        assert str(leaf.dtype).split(".")[-1] == str(want[keys].dtype), keys
    assert tuple(got[("len",)].shape) == (B,)


@pytest.mark.parametrize("kind", ["pool", "clients"])
@pytest.mark.parametrize("name", FAMILIES)
def test_client_axis_serving_matches_the_reference(name, kind):
    (j_model, j_params, j_pool), (t_model, t_params, t_pool) = _pair(name)
    lead = (N, B)
    feed, steps = _inputs(t_model.cfg, lead), _steps(lead)
    j_ad, ids = _client_adapters(j_pool, kind, _take_np)
    t_ad, _ = _client_adapters(t_pool, kind, _take_t)
    if ids is not None:
        j_ad = j_serving.attach_ids(j_ad, jnp.asarray(ids))
        t_ad = t_serving.attach_ids(t_ad, ids)

    prefill, decode = jax.jit(j_model.prefill), jax.jit(j_model.decode_step)
    logits, cache_j = prefill(j_params, j_ad,
                              jax.tree.map(jnp.asarray, feed),
                              j_model.init_cache(lead, CAP))
    want = [np.asarray(logits)]
    for tok in steps:
        logits, cache_j = decode(j_params, j_ad, jnp.asarray(tok), cache_j)
        want.append(np.asarray(logits))
    want = np.concatenate(want, -2)

    got, cache_t = _serve_port(t_model, t_params, t_ad, feed, steps, lead)
    assert got.shape == (N, B, 1 + DECODE_STEPS, t_model.cfg.vocab_size)
    np.testing.assert_allclose(got, want, **TOL)
    cj = dict(tree_leaves_with_path(_np(cache_j)))
    for keys, leaf in tree_leaves_with_path(cache_t):
        np.testing.assert_allclose(leaf.numpy(), cj[keys], err_msg=str(keys),
                                   **TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_client_axis_equals_the_same_rows_served_flat(name):
    """N x B rows over a (N, B) cache, each client's rows its adapter,
    against the same rows over a (N B,) cache with the ids repeated."""
    _, (model, params, pool) = _pair(name)
    feed, steps = _inputs(model.cfg, (N, B)), _steps((N, B))
    got, _ = _serve_port(model, params, t_serving.attach_ids(pool, IDS),
                         feed, steps, (N, B))
    flat = {k: v.reshape((N * B,) + v.shape[2:]) for k, v in feed.items()}
    want, _ = _serve_port(model, params,
                          t_serving.attach_ids(pool, np.repeat(IDS, B)),
                          flat, steps.reshape(DECODE_STEPS, N * B, 1),
                          (N * B,))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=0,
                               atol=1e-6 * scale)
    np.testing.assert_array_equal(got.reshape(want.shape).argmax(-1),
                                  want.argmax(-1))


@pytest.mark.parametrize("name", FAMILIES)
def test_row_ids_over_a_client_axis_raise_as_in_the_reference(name):
    """A pool's ids of (B,), one per row of B where the indexed LoRA
    takes one per client, raise ValueError in the reference's prefill
    and in the port's."""
    (j_model, j_params, j_pool), (t_model, t_params, t_pool) = _pair(name)
    feed = _inputs(t_model.cfg, (N, B))
    ids = np.arange(B, dtype=np.int32)
    with pytest.raises(ValueError):
        j_model.prefill(j_params, j_serving.attach_ids(j_pool,
                                                       jnp.asarray(ids)),
                        jax.tree.map(jnp.asarray, feed),
                        j_model.init_cache((N, B), CAP))
    with pytest.raises(ValueError):
        t_model.prefill(t_params, t_serving.attach_ids(t_pool, ids),
                        {k: torch.from_numpy(v) for k, v in feed.items()},
                        t_model.init_cache((N, B), CAP))


def test_a_client_axis_under_a_mesh_shard_raises():
    """No caller of the reference serves a client axis on a mesh: the
    port's MeshShard places a cache of lead (B,) and refuses (N, B), in
    init_cache and in a prefill of (N, B, S) tokens."""
    _, (model, params, _) = _pair("gpt2-small")
    mesh = make_mesh(1, 2)
    coords, sizes = sh.mesh_coords(mesh, 0), sh.axis_sizes(mesh)
    policy = ShardingPolicy(types.SimpleNamespace(
        mesh=mesh, rank=0, model_size=sizes["model"],
        model_rank=coords["model"], data_size=sizes["data"],
        data_rank=coords["data"]))
    with pytest.raises(NotImplementedError) as e:
        model.init_cache((N, B), CAP, policy=policy)
    assert roadmap.PARAM_SHARDING in str(e.value)
    with pytest.raises(NotImplementedError) as e:
        model.prefill(params, None, {"tokens": torch.zeros(
            (N, B, PROMPT), dtype=torch.int32)},
            model.init_cache((N, B), CAP), policy=policy)
    assert roadmap.PARAM_SHARDING in str(e.value)
