"""The port's round engine against the JAX package's, on reduced
gpt2-small: 4 layers, d_model 64, 4 heads, vocab 256, seq 32, batch 2,
3 clients with cuts [1, 2, 3], r_cut 4, r_others 8, fp32.

The reference builds the state (``repro.core.rounds.init_state``, then
random non-zero adapters so that every adapter has a gradient) and
``repro_torch.bridge`` hands the same numpy arrays to the port.

Tolerances (fp32, sums in another order):
  * losses, metrics and adapter gradients: rtol 1e-4, with an absolute
    floor of 1e-4 of the tree's largest gradient; under int8 smashed
    compression 1e-3 of it, because a cotangent element that lies within
    fp32 noise of an int8 rounding boundary takes the neighbouring code on
    one side, a step of one quantum (amax / 127 of its message);
  * two rounds under SGD (new adapters): 1e-5;
  * two rounds under AdamW: losses and the moments m, v at 1e-4, but the
    adapters only to lr / 50.  AdamW's first steps normalise each gradient
    element, m / sqrt(v) ~ g / |g|, so an element whose gradient is tiny
    next to the tree's largest (it has a large relative error in fp32)
    still moves by up to lr; that error is bounded by lr, not by the
    adapter's size.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import aggregation as j_aggregation  # noqa: E402
from repro.core import rounds as j_rounds  # noqa: E402
from repro.core import smashed as j_smashed  # noqa: E402
from repro.core import split as j_split  # noqa: E402
from repro.models import common as j_common  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import reduced as t_reduced  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import aggregation as t_aggregation  # noqa: E402
from repro_torch.core import rounds as t_rounds  # noqa: E402
from repro_torch.core import smashed as t_smashed  # noqa: E402
from repro_torch.core import split as t_split  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SMALL = dict(layers=4, d_model=64, vocab=256, seq_len=32, batch=2)
CUTS = [1, 2, 3]
# powers of two: the serving ranks (weighted mean ranks, truncated) are
# exact on both sides
WEIGHTS = np.array([0.25, 0.25, 0.5], np.float32)
ACTIVE = np.ones(3, np.float32)
LR = 1e-2


def _arch(reduced, get_config, optimizer="adamw"):
    arch = reduced(get_config("gpt2-small"), **SMALL)
    return arch.replace(
        lora=dataclasses.replace(arch.lora, r_others=8, r_cut=4),
        train=dataclasses.replace(arch.train, optimizer=optimizer))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    model_j = j_build_model(_arch(j_reduced, j_get_config))
    params_j = model_j.init_params(jax.random.PRNGKey(0))
    state_j = j_rounds.init_state(model_j, jax.random.PRNGKey(1),
                                  num_clients=3)
    rng = np.random.default_rng(0)
    for side in ("client_adapters", "server_adapters"):
        state_j[side] = jax.tree.map(
            lambda v: jnp.asarray(rng.normal(size=v.shape) * 0.05,
                                  jnp.float32), state_j[side])
    state_j["cuts"] = jnp.asarray(CUTS, jnp.int32)
    toks = rng.integers(3, 256, size=(3, 2, 33)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
             "loss_mask": (rng.random((3, 2, 32)) > 0.1).astype(np.float32)}
    model_t = build_model(_arch(t_reduced, t_get_config), device="cpu")
    params_t = bridge.params_from_numpy(_np(params_j), "cpu")
    return dict(model_j=model_j, params_j=params_j, state_np=_np(state_j),
                model_t=model_t, params_t=params_t, batch=batch)


def _states(setup):
    """A fresh copy of the start state for each side (the reference's
    step donates its state)."""
    return (jax.tree.map(jnp.asarray, setup["state_np"]),
            bridge.state_from_numpy(setup["state_np"], "cpu"))


def _close(got_t, want_j, **tol):
    np.testing.assert_allclose(np.asarray(got_t), np.asarray(want_j), **tol)


def test_state_crosses_the_bridge_both_ways(setup):
    _, state_t = _states(setup)
    assert state_t["cuts"].device.type == "cpu"
    assert state_t["cuts"].dtype == torch.int32
    back = bridge.to_numpy(state_t)
    want = setup["state_np"]
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got = dict((jax.tree_util.keystr(k), v) for k, v in
               jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(flat)
    for k, v in flat:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(k)], v)


def test_init_state_layout_matches_reference(setup):
    mine = t_rounds.init_state(setup["model_t"],
                               torch.Generator().manual_seed(0),
                               num_clients=3)
    shapes = lambda tree: {jax.tree_util.keystr(k): np.shape(v)  # noqa: E731
                           for k, v in
                           jax.tree_util.tree_flatten_with_path(tree)[0]}
    want = j_rounds.init_state(setup["model_j"], jax.random.PRNGKey(2),
                               num_clients=3)
    assert shapes(bridge.to_numpy(mine)) == shapes(_np(want))
    assert mine["cuts"].tolist() == [2, 2, 2]


def _loss_pair(setup, comp):
    state_j, state_t = _states(setup)
    model_j, model_t = setup["model_j"], setup["model_t"]
    b_j = j_smashed.make_boundary(j_smashed.make_compressor(comp),
                                  state_j["cuts"])
    b_t = t_smashed.make_boundary(t_smashed.make_compressor(comp),
                                  state_t["cuts"])
    batch_j = jax.tree.map(jnp.asarray, setup["batch"])
    batch_t = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    wl = WEIGHTS / WEIGHTS.sum()

    def loss_j(cad, sad):
        eff = j_split.merge_adapters(model_j, cad, sad, state_j["cuts"])
        per, met = model_j.loss(setup["params_j"], eff, batch_j,
                                per_client=True, boundary=b_j)
        return jnp.sum(wl * per), (per, met)

    def loss_t(cad, sad):
        eff = t_split.merge_adapters(model_t, cad, sad, state_t["cuts"])
        per, met = model_t.loss(setup["params_t"], eff, batch_t,
                                per_client=True, boundary=b_t)
        return (torch.from_numpy(wl) * per).sum(), (per, met)

    return state_j, state_t, loss_j, loss_t


@pytest.mark.parametrize("comp", ["none", "int8"])
def test_per_client_loss_matches_reference(setup, comp):
    state_j, state_t, loss_j, loss_t = _loss_pair(setup, comp)
    _, (per_j, met_j) = loss_j(state_j["client_adapters"],
                               state_j["server_adapters"])
    _, (per_t, met_t) = loss_t(state_t["client_adapters"],
                               state_t["server_adapters"])
    assert per_t.shape == (3,)
    _close(per_t.detach(), per_j, rtol=1e-4, atol=1e-4)
    for k in ("ce", "accuracy", "tokens"):
        _close(met_t[k].detach(), met_j[k], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("comp", ["none", "int8"])
def test_adapter_gradients_match_reference(setup, comp):
    """jax.grad of the weighted round loss vs the port's round_grads (the
    train step's f1-f5), for the client and the server adapters; the int8
    case compresses the cotangent at each client's cut too."""
    state_j, state_t, loss_j, loss_t = _loss_pair(setup, comp)
    g_j = jax.grad(lambda c, s: loss_j(c, s)[0], argnums=(0, 1))(
        state_j["client_adapters"], state_j["server_adapters"])
    b_t = t_smashed.make_boundary(t_smashed.make_compressor(comp),
                                  state_t["cuts"])
    _, _, gc_t, gs_t = t_rounds.round_grads(
        setup["model_t"], setup["params_t"], state_t, setup["batch"],
        WEIGHTS, boundary=b_t)
    g_t = tree_leaves(gc_t) + tree_leaves(gs_t)
    want = jax.tree.leaves(g_j[0]) + jax.tree.leaves(g_j[1])
    assert len(want) == len(g_t)
    scale = max(float(np.abs(w).max()) for w in want)
    floor = (1e-3 if comp == "int8" else 1e-4) * scale
    for got, w in zip(g_t, want):
        _close(got, w, rtol=1e-4, atol=floor)


def _run_rounds(setup, comp, optimizer, rounds=2):
    model_j = j_build_model(_arch(j_reduced, j_get_config, optimizer))
    model_t = build_model(_arch(t_reduced, t_get_config, optimizer),
                          device="cpu")
    state_j, state_t = _states(setup)
    step_j = j_rounds.make_train_step(model_j, smashed_compress=comp)
    step_t = t_rounds.make_train_step(model_t, smashed_compress=comp)
    batch_j = jax.tree.map(jnp.asarray, setup["batch"])
    out = []
    for _ in range(rounds):
        state_j, met_j = step_j(setup["params_j"], state_j, batch_j,
                                jnp.asarray(WEIGHTS), jnp.asarray(ACTIVE),
                                jnp.float32(LR), jnp.float32(LR))
        state_t, met_t = step_t(setup["params_t"], state_t, setup["batch"],
                                WEIGHTS, ACTIVE, LR, LR)
        out.append((_np(state_j), bridge.to_numpy(state_t), _np(met_j),
                    bridge.to_numpy(met_t)))
    return out, (model_j, state_j), (model_t, state_t)


def _assert_tree_close(got, want, **tol):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    mine = dict((jax.tree_util.keystr(k), v) for k, v in
                jax.tree_util.tree_flatten_with_path(got)[0])
    for k, v in flat:
        np.testing.assert_allclose(mine[jax.tree_util.keystr(k)], v,
                                   err_msg=jax.tree_util.keystr(k), **tol)


@pytest.mark.parametrize("comp", ["none", "int8"])
def test_two_sgd_rounds_match_reference(setup, comp):
    """FedAvg and the b3/b4 broadcast included: every client row, the
    server adapters and the metrics after each of two rounds."""
    out, _, _ = _run_rounds(setup, comp, "sgd")
    for s_j, s_t, m_j, m_t in out:
        for side in ("client_adapters", "server_adapters"):
            _assert_tree_close(s_t[side], s_j[side], rtol=1e-5, atol=1e-5)
        assert s_t["round"] == s_j["round"]
        np.testing.assert_array_equal(s_t["opt_c"]["count"],
                                      s_j["opt_c"]["count"])
        for k in ("total", "ce", "accuracy", "tokens"):
            _close(m_t[k], m_j[k], rtol=1e-4, atol=1e-4)


def test_two_adamw_rounds_and_eval_match_reference(setup):
    """Two AdamW rounds, then the eval step (global adapters through the
    fused LoRA plain path)."""
    out, (model_j, state_j), (model_t, state_t) = _run_rounds(
        setup, "none", "adamw")
    for s_j, s_t, m_j, m_t in out:
        for k in ("total", "ce", "accuracy"):
            _close(m_t[k], m_j[k], rtol=1e-4, atol=1e-4)
        for opt in ("opt_c", "opt_s"):
            for mom in ("m", "v"):
                scale = max(float(np.abs(v).max())
                            for v in jax.tree.leaves(s_j[opt][mom]))
                _assert_tree_close(s_t[opt][mom], s_j[opt][mom], rtol=1e-4,
                                   atol=1e-4 * scale)
        for side in ("client_adapters", "server_adapters"):
            _assert_tree_close(s_t[side], s_j[side], rtol=0, atol=LR / 50)
    eval_j = j_rounds.make_eval_step(model_j)
    eval_t = t_rounds.make_eval_step(model_t)
    batch_j = jax.tree.map(jnp.asarray, setup["batch"])
    per_j, met_j = eval_j(setup["params_j"], state_j, batch_j,
                          jnp.asarray(WEIGHTS))
    per_t, met_t = eval_t(setup["params_t"], state_t, setup["batch"],
                          WEIGHTS)
    _close(per_t, per_j, rtol=1e-4, atol=1e-4)
    _close(met_t["accuracy"], met_j["accuracy"], rtol=1e-4, atol=1e-4)


def test_eval_step_matches_reference_from_one_state(setup):
    """make_eval_step on the start state: serve_adapters' weighted global
    adapters and per-client loss and accuracy."""
    state_j, state_t = _states(setup)
    batch_j = jax.tree.map(jnp.asarray, setup["batch"])
    per_j, met_j = j_rounds.make_eval_step(setup["model_j"])(
        setup["params_j"], state_j, batch_j, jnp.asarray(WEIGHTS))
    per_t, met_t = t_rounds.make_eval_step(setup["model_t"])(
        setup["params_t"], state_t, setup["batch"], WEIGHTS)
    _close(per_t, per_j, rtol=1e-4, atol=1e-4)
    for k in ("ce", "accuracy", "tokens"):
        _close(met_t[k], met_j[k], rtol=1e-4, atol=1e-4)
    eff_j = j_split.serve_adapters(setup["model_j"],
                                   state_j["client_adapters"],
                                   state_j["server_adapters"],
                                   state_j["cuts"], jnp.asarray(WEIGHTS))
    eff_t = t_split.serve_adapters(setup["model_t"],
                                   state_t["client_adapters"],
                                   state_t["server_adapters"],
                                   state_t["cuts"], WEIGHTS)
    _assert_tree_close(bridge.to_numpy(eff_t), _np(eff_j), rtol=1e-6,
                       atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_helpers_match_reference(masked):
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32)
    logits[0, 0, 2] = logits[0, 0, 7] = 9.0          # an argmax tie
    labels = rng.integers(0, 11, size=(3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32) if masked else None
    tm = None if mask is None else torch.from_numpy(mask)
    for name in ("cross_entropy", "token_accuracy"):
        got = getattr(t_common, name)(torch.from_numpy(logits),
                                      torch.from_numpy(labels), tm)
        want = getattr(j_common, name)(jnp.asarray(logits),
                                       jnp.asarray(labels), mask)
        _close(got, want, rtol=1e-6, atol=1e-6)


def test_adapter_deltas_match_reference(setup):
    state_j, state_t = _states(setup)
    new_j = jax.tree.map(lambda v: v * 1.5 + 0.25, state_j["client_adapters"])
    new_t = bridge.params_from_numpy(_np(new_j), "cpu")
    d_j = j_aggregation.adapter_delta(new_j, state_j["client_adapters"])
    d_t = t_aggregation.adapter_delta(new_t, state_t["client_adapters"])
    _assert_tree_close(bridge.to_numpy(d_t), _np(d_j), rtol=0, atol=0)
    back = t_aggregation.apply_delta(state_t["client_adapters"], d_t)
    _assert_tree_close(bridge.to_numpy(back), _np(j_aggregation.apply_delta(
        state_j["client_adapters"], d_j)), rtol=0, atol=0)


# the options these lists used to refuse, now one SGD round each against
# the reference's engine (SGD: an AdamW first step moves nearly every
# element by lr, so adapter top-k would choose among ties); the bucket
# case gives clients 0 and 2 the int8 bucket
LIFTED = [dict(remat="dots"), dict(ce_chunk=16), dict(microbatch=2),
          dict(compressor_buckets=("none", "int8")),
          dict(agg_every=2), dict(compress="topk"),
          dict(max_local_steps=2), dict(async_buffer=True),
          dict(num_edges=2)]


def _prepared(state, prep, opt):
    """The state template an option needs, built by either package's
    round engine (`prep`)."""
    state = prep.prepare_state(
        state, max_local_steps=opt.get("max_local_steps", 1),
        async_buffer=opt.get("async_buffer", False),
        edge_groups=opt.get("num_edges", 1),
        smashed_choice=0 if "compressor_buckets" in opt else None)
    if opt.get("compress") == "topk":
        state = prep.with_error_feedback(state)
    return state


def _lifted_round(setup, opt, prepare=lambda s: s):
    """One SGD round of the option on both engines from one start state;
    `prepare` adjusts the numpy start state (budgets, choices)."""
    model_j = j_build_model(_arch(j_reduced, j_get_config, "sgd"))
    model_t = build_model(_arch(t_reduced, t_get_config, "sgd"),
                          device="cpu")
    state_j, _ = _states(setup)
    for side in ("opt_c", "opt_s"):        # SGD's optimizer state
        state_j[side] = {"count": state_j[side]["count"]}
    state_np = prepare(_np(_prepared(state_j, j_rounds, opt)))
    state_j = jax.tree.map(jnp.asarray, state_np)
    state_t = bridge.state_from_numpy(state_np, "cpu")
    batch = setup["batch"]
    if opt.get("max_local_steps", 1) > 1:
        k = opt["max_local_steps"]
        batch = {key: np.stack([np.roll(v, j, axis=-1) for j in range(k)])
                 for key, v in batch.items()}
    state_j, met_j = j_rounds.make_train_step(model_j, **opt)(
        setup["params_j"], state_j, jax.tree.map(jnp.asarray, batch),
        jnp.asarray(WEIGHTS), jnp.asarray(ACTIVE), jnp.float32(LR),
        jnp.float32(LR))
    state_t, met_t = t_rounds.make_train_step(model_t, **opt)(
        setup["params_t"], state_t, batch, WEIGHTS, ACTIVE, LR, LR)
    s_j, s_t = _np(state_j), bridge.to_numpy(state_t)
    assert sorted(s_t) == sorted(s_j)
    for side in ("client_adapters", "server_adapters"):
        _assert_tree_close(s_t[side], s_j[side], rtol=1e-5, atol=1e-5)
    for k in ("total", "ce", "accuracy", "tokens"):
        _close(met_t[k], _np(met_j)[k], rtol=1e-4, atol=1e-4)
    return s_j, s_t


@pytest.mark.parametrize("opt", LIFTED, ids=[next(iter(o)) for o in LIFTED])
def test_lifted_engine_options_match_reference(setup, opt):
    def prepare(state):
        if "compressor_buckets" in opt:
            state["smashed_choice"] = np.asarray([1, 0, 1], np.int32)
        return state

    s_j, s_t = _lifted_round(setup, opt, prepare)
    for leaf in ("ef", "step_budgets", "buffer_mask", "buffer_steps",
                 "adapter_version", "global_version", "edge_assign"):
        if leaf in s_j:
            _assert_tree_close(s_t[leaf], s_j[leaf], rtol=1e-5, atol=1e-7)


def test_step_budgets_leaf_runs_the_local_steps_engine(setup):
    """A state carrying heterogeneous step budgets (1, 3, 2) under K = 3:
    client 0 freezes after one inner step, client 1 runs all three."""
    def budgets(state):
        state["step_budgets"] = np.asarray([1, 3, 2], np.int32)
        return state

    s_j, s_t = _lifted_round(setup, dict(max_local_steps=3), budgets)
    np.testing.assert_array_equal(s_t["opt_c"]["count"], [1, 3, 2])
    np.testing.assert_array_equal(s_t["opt_c"]["count"],
                                  s_j["opt_c"]["count"])
