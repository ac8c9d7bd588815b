"""The vlm family of the port against the JAX package: internvl2-76b
reduced (d_model 64 over 4 heads, 2 kv heads, an 8-position frontend
prefix), whose batches carry "prefix" embeddings that replace the first
positions' token embeddings.

The reference builds the weights, the round-engine state and the prefix
embeddings; ``repro_torch.bridge`` hands the same numpy arrays to the
port.  Tolerances as tests/test_torch_dense_families.py: logits 2e-4;
per-client losses 1e-4; adapter gradients rtol 1e-4 with an absolute
floor of 1e-4 of the tree's largest gradient.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import SHAPES  # noqa: E402
from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import rounds as j_rounds  # noqa: E402
from repro.core import smashed as j_smashed  # noqa: E402
from repro.core import split as j_split  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import reduced as t_reduced  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import rounds as t_rounds  # noqa: E402
from repro_torch.core import smashed as t_smashed  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

VLM = "internvl2-76b"
SEQ = 24
TOL = dict(rtol=2e-4, atol=2e-4)
CUTS = [1, 2]
WEIGHTS = np.array([0.25, 0.75], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, params), (port model, params): the same weights, 3
    layers."""
    kw = dict(layers=3, seq_len=SEQ, vocab=256)
    model_j = j_build_model(j_reduced(j_get_config(VLM), **kw))
    params_j = model_j.init_params(jax.random.PRNGKey(0))
    model_t = build_model(t_reduced(t_get_config(VLM), **kw), device="cpu")
    return (model_j, params_j), (model_t,
                                 bridge.params_from_numpy(_np(params_j),
                                                          "cpu"))


def _batch(model, lead, seed):
    """Tokens, labels and a prefix of the config's frontend_prefix_len
    positions ([N,] B, P, d), as the reference's tests draw them."""
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, 256, size=lead + (SEQ + 1,)).astype(np.int32)
    prefix = (rng.normal(size=lead + (cfg.frontend_prefix_len, cfg.d_model))
              * 0.02).astype(np.float32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:],
            "prefix": prefix}


# ---------------------------------------------------------------------------
# Config and input shapes


@pytest.mark.parametrize("shrink", [False, True])
def test_config_copy_matches_reference(shrink):
    want, got = j_get_config(VLM), t_get_config(VLM)
    if shrink:
        want, got = j_reduced(want), t_reduced(got)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("shape,num_clients", [
    ("train_4k", 0), ("train_4k", 4), ("prefill_32k", 0), ("decode_32k", 0)])
def test_input_specs_match_reference(shape, num_clients):
    """The prefix entry (train and prefill, split over the clients in
    training) and the token entries of the reference's shape cells, at
    full size."""
    sc = SHAPES[shape]
    want = j_build_model(j_get_config(VLM)).input_specs(
        sc, num_clients=num_clients)
    got = build_model(t_get_config(VLM), device="cpu").input_specs(
        sc.kind, sc.seq_len, sc.global_batch, num_clients=num_clients)
    assert {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in want.items()} == {
        k: (shp, str(dt).replace("torch.", "")) for k, (shp, dt) in
        got.items()}
    assert ("prefix" in got) == (sc.kind != "decode")


# ---------------------------------------------------------------------------
# Logits


def test_logits_with_prefix_match_reference(pair):
    """The full forward and head over a prefix batch: the first P
    positions take the prefix, not their token embeddings."""
    (model_j, params_j), (model_t, params_t) = pair
    batch = _batch(model_t, (2,), 1)
    x_j, aux_j, _ = model_j.forward(
        params_j, None, {k: jnp.asarray(batch[k])
                         for k in ("tokens", "prefix")})
    want = model_j.head(params_j, x_j)
    with torch.no_grad():
        x_t, aux_t, _ = model_t.forward(
            params_t, None, {k: torch.from_numpy(batch[k])
                             for k in ("tokens", "prefix")})
        got = model_t.head(params_t, x_t)
        plain = model_t.head(params_t, model_t.forward(
            params_t, None, {"tokens": torch.from_numpy(batch["tokens"])})[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert aux_t == 0.0 and float(aux_j) == 0.0
    assert not np.allclose(got.numpy(), plain.numpy(), atol=1e-3)


def test_prefill_with_prefix_then_decode_matches_reference(pair):
    """Prefill of a prefix batch (SEQ - 2 positions), then two decode
    steps against the cache, logits against the reference's."""
    (model_j, params_j), (model_t, params_t) = pair
    batch = _batch(model_t, (2,), 2)
    toks, prefix = batch["tokens"], batch["prefix"]
    n = SEQ - 2
    cache_j = model_j.init_cache((2,), SEQ)
    lg_j, cache_j = model_j.prefill(
        params_j, None, {"tokens": jnp.asarray(toks[:, :n]),
                         "prefix": jnp.asarray(prefix)}, cache_j)
    want = [lg_j]
    for i in range(n, SEQ):
        lg_j, cache_j = model_j.decode_step(params_j, None,
                                            jnp.asarray(toks[:, i:i + 1]),
                                            cache_j)
        want.append(lg_j)
    with torch.no_grad():
        cache_t = model_t.init_cache((2,), SEQ)
        lg_t, cache_t = model_t.prefill(
            params_t, None, {"tokens": torch.from_numpy(toks[:, :n]),
                             "prefix": torch.from_numpy(prefix)}, cache_t)
        got = [lg_t]
        for i in range(n, SEQ):
            lg_t, cache_t = model_t.decode_step(
                params_t, None, torch.from_numpy(toks[:, i:i + 1]), cache_t)
            got.append(lg_t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# ---------------------------------------------------------------------------
# The sync round engine


def test_round_with_prefix_matches_reference(pair):
    """Per-client losses and the client and server adapters' gradients of
    one round (jax.grad against round_grads) over a prefix batch ((N, B,
    P, d)) at cuts [1, 2], uncompressed; then one SGD step of
    make_train_step under the config's int8 smashed compressor with
    microbatch 2, whose prefix is split with the tokens."""
    (model_j, params_j), (model_t, params_t) = pair
    state_j = j_rounds.init_state(model_j, jax.random.PRNGKey(1),
                                  num_clients=2)
    rng = np.random.default_rng(0)
    for side in ("client_adapters", "server_adapters"):
        state_j[side] = jax.tree.map(
            lambda v: jnp.asarray(rng.normal(size=v.shape) * 0.05,
                                  jnp.float32), state_j[side])
    state_j["cuts"] = jnp.asarray(CUTS, jnp.int32)
    state_np = _np(state_j)
    state_t = bridge.state_from_numpy(state_np, "cpu")
    batch = _batch(model_t, (2, 2), 3)
    batch_j = jax.tree.map(jnp.asarray, batch)
    wl = WEIGHTS / WEIGHTS.sum()
    b_j = j_smashed.make_boundary(j_smashed.make_compressor("none"),
                                  state_j["cuts"])
    b_t = t_smashed.make_boundary(t_smashed.make_compressor("none"),
                                  state_t["cuts"])

    def loss_j(cad, sad):
        eff = j_split.merge_adapters(model_j, cad, sad, state_j["cuts"])
        per, _ = model_j.loss(params_j, eff, batch_j, per_client=True,
                              boundary=b_j)
        return jnp.sum(wl * per), per

    (_, per_j), g_j = jax.value_and_grad(loss_j, argnums=(0, 1),
                                         has_aux=True)(
        state_j["client_adapters"], state_j["server_adapters"])
    _, met_t, gc_t, gs_t = t_rounds.round_grads(
        model_t, params_t, state_t, batch, WEIGHTS, boundary=b_t)
    np.testing.assert_allclose(met_t["ce"].numpy(), np.asarray(per_j),
                               rtol=1e-4, atol=1e-4)
    got = tree_leaves(gc_t) + tree_leaves(gs_t)
    want = jax.tree.leaves(g_j[0]) + jax.tree.leaves(g_j[1])
    floor = 1e-4 * max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=floor)

    sgd = lambda arch: arch.replace(train=dataclasses.replace(  # noqa: E731
        arch.train, optimizer="sgd"))
    comp = model_t.arch.split.smashed_compress
    assert comp == "int8"
    step_j = j_rounds.make_train_step(j_build_model(sgd(model_j.arch)),
                                      smashed_compress=comp, microbatch=2)
    step_t = t_rounds.make_train_step(
        build_model(sgd(model_t.arch), device="cpu"), smashed_compress=comp,
        microbatch=2)
    act = np.ones(2, np.float32)
    new_j, m_j = step_j(params_j, state_j, batch_j, jnp.asarray(WEIGHTS),
                        jnp.asarray(act), jnp.float32(1e-2),
                        jnp.float32(1e-2))
    new_t, m_t = step_t(params_t, bridge.state_from_numpy(state_np, "cpu"),
                        batch, WEIGHTS, act, 1e-2, 1e-2)
    for side in ("client_adapters", "server_adapters"):
        for g, w in zip(tree_leaves(new_t[side]),
                        jax.tree.leaves(new_j[side])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
    np.testing.assert_allclose(m_t["ce"].numpy(), np.asarray(m_j["ce"]),
                               rtol=1e-4, atol=1e-4)
