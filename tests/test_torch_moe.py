"""The MoE family of the port against the JAX package: kimi-k2 (384
experts top-8 with a shared expert, head dim 112) and llama4-maverick
(128 experts top-1 with a shared expert, head dim 128), reduced.

The reference builds the weights, the round-engine state and the adapter
pool; ``repro_torch.bridge`` hands the same numpy arrays to the port.
``moe_apply`` is held at the reduced config's dropless capacity and at
capacity factors 1.25 and 0.5, where (token, choice) pairs are dropped:
the top-k indices must be equal first, since a flipped choice would move
every later queue position of its expert.  Tolerances (fp32, sums in
another order; the port dispatches and combines by index where the
reference multiplies one-hot tensors):

  * config copies and parameter layouts: equal;
  * the block's output and its input gradient: 2e-4; the aux loss 1e-6;
  * logits: 2e-4, dropless and at capacity 1.25;
  * per-client losses 1e-4; adapter gradients rtol 1e-4 with an absolute
    floor of 1e-4 of the tree's largest gradient; one SGD round under
    microbatch 2 and one async tick 1e-5 (as
    tests/test_torch_dense_families.py), the async fleet objective 1e-5;
  * served tokens: equal to the JAX engine's at capacity 1.25 (prompts
    padded to their bucket, as both engines do), contiguous and paged.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import rounds as j_rounds  # noqa: E402
from repro.core import smashed as j_smashed  # noqa: E402
from repro.core import split as j_split  # noqa: E402
from repro.models import common as j_common  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.runtime import serving as j_serving  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import reduced as t_reduced  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import rounds as t_rounds  # noqa: E402
from repro_torch.core import smashed as t_smashed  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import serving as t_serving  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

KIMI, LLAMA4 = "kimi-k2-1t-a32b", "llama4-maverick-400b-a17b"
MOE = [KIMI, LLAMA4]
SEQ = 32
TOL = dict(rtol=2e-4, atol=2e-4)
CUTS = [1, 2, 2]
WEIGHTS = np.array([0.25, 0.25, 0.5], np.float32)
ACTIVE = np.ones(3, np.float32)
LR = 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arch(name, reduced, get_config, *, cf=None, layers=2, **kw):
    """A reduced MoE arch of either package (8 experts unless kw says
    otherwise); cf replaces the dropless capacity factor reduced()
    sets."""
    kw.setdefault("experts", 8)
    arch = reduced(get_config(name), layers=layers, seq_len=SEQ, vocab=256,
                   **kw)
    if cf is not None:
        arch = arch.replace(model=dataclasses.replace(
            arch.model, moe_capacity_factor=cf))
    return arch


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(name, **kw):
    """(JAX model, params), (port model, params): the same weights."""
    model_j = j_build_model(_arch(name, j_reduced, j_get_config, **kw))
    params_j = model_j.init_params(jax.random.PRNGKey(0))
    model_t = build_model(_arch(name, t_reduced, t_get_config, **kw),
                          device="cpu")
    return (model_j, params_j), (model_t,
                                 bridge.params_from_numpy(_np(params_j),
                                                          "cpu"))


def _shapes(tree):
    return {jax.tree_util.keystr(k): tuple(np.shape(v))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# Configs and parameters


@pytest.mark.parametrize("shrink", [False, True])
@pytest.mark.parametrize("name", MOE)
def test_config_copies_match_reference(name, shrink):
    want, got = j_get_config(name), t_get_config(name)
    if shrink:
        want, got = j_reduced(want), t_reduced(got)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", MOE)
def test_moe_param_layout_matches_reference(name):
    """router (Lg, d, E), we_in/we_gate (Lg, E, d, ff), we_out (Lg, E, ff,
    d), the shared expert's ws_* and norm2 without a bias, from the port's
    own init and through the bridge; no adapter on the experts."""
    (model_j, params_j), (model_t, params_t) = _pair(name)
    mine = model_t.init_params(torch.Generator().manual_seed(0))
    assert _shapes(bridge.to_numpy(mine)) == _shapes(_np(params_j))
    assert _shapes(bridge.to_numpy(params_t)) == _shapes(_np(params_j))
    dec = mine["dec"]
    m = model_t.cfg
    assert dec["we_in"].shape == (2, m.num_experts, m.d_model, m.moe_d_ff)
    assert dec["we_out"].shape == (2, m.num_experts, m.moe_d_ff, m.d_model)
    assert "bias" not in dec["norm2"]
    assert model_t.adapter_spec() == model_j.adapter_spec()
    assert set(model_t.adapter_spec()["dec"]) == {"q", "k", "v", "o"}


# ---------------------------------------------------------------------------
# The MoE block


def _j_topi(cfg, p, x, s_group):
    """The reference's routing choices (moe_apply's first lines)."""
    y = j_common.apply_norm(p["norm2"], x, kind=cfg.norm, eps=cfg.norm_eps)
    yg = y.reshape((-1, s_group, cfg.d_model))
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", yg, p["router"]), -1)
    return np.asarray(jax.lax.top_k(probs, cfg.moe_top_k)[1])


# (arch, capacity factor or None for reduced's dropless one, x's lead
# shape, sequence length): 3 clients x 2 sequences of 32; one sequence
# of 8192 cut into two routing groups of MOE_GROUP_TOKENS (at d_model 16
# over 4 experts, capacity 256 of a group's 8192 pairs)
BLOCK_CASES = [(KIMI, None, (3, 2), SEQ), (KIMI, 1.25, (3, 2), SEQ),
               (KIMI, 0.5, (3, 2), SEQ), (LLAMA4, None, (3, 2), SEQ),
               (LLAMA4, 1.25, (3, 2), SEQ), (KIMI, 0.125, (1,), 8192)]


@pytest.mark.parametrize("case", BLOCK_CASES,
                         ids=lambda c: f"{c[0][:5]}-cf{c[1]}-s{c[3]}")
def test_moe_apply_matches_reference(case):
    """Routing choices equal, then the block's output, aux loss and (for
    the sequences of 32) the gradient of a weighted sum of both w.r.t.
    the block's input (through the kept top-k values and the router
    probabilities), at layer 0."""
    name, cf, lead, s = case
    kw = dict(experts=4, d_model=16) if s > t_tf.MOE_GROUP_TOKENS else {}
    (model_j, params_j), (model_t, params_t) = _pair(name, cf=cf, **kw)
    cfg = model_t.cfg
    p_j = jax.tree.map(lambda v: v[0], params_j["dec"])
    p_t = {k: (v[0] if not isinstance(v, dict)
               else {kk: vv[0] for kk, vv in v.items()})
           for k, v in params_t["dec"].items()}
    rng = np.random.default_rng(3)
    x = rng.normal(size=lead + (s, cfg.d_model)).astype(np.float32)
    wt = rng.normal(size=x.shape).astype(np.float32)
    group = min(s, t_tf.MOE_GROUP_TOKENS)

    def f_j(xx):
        out, aux = j_tf.moe_apply(p_j, None, xx, cfg=model_j.cfg,
                                  policy=j_common.NO_SHARDING)
        return jnp.sum(out * wt) + 100.0 * aux, (out, aux)

    grad = s <= SEQ
    if grad:
        (_, (out_j, aux_j)), gx_j = jax.value_and_grad(f_j, has_aux=True)(
            jnp.asarray(x))
    else:
        _, (out_j, aux_j) = f_j(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(grad)
    out_t, aux_t = t_tf.moe_apply(p_t, None, xt, cfg=cfg)

    with torch.no_grad():
        yg = t_tf.apply_norm(p_t["norm2"], xt, kind=cfg.norm,
                             eps=cfg.norm_eps).reshape(-1, group,
                                                       cfg.d_model)
        _, _, topi, pos, cap = t_tf.moe_route(cfg, yg, p_t["router"])
    np.testing.assert_array_equal(topi.numpy(),
                                  _j_topi(cfg, p_j, jnp.asarray(x), group))
    dropped = int((pos >= cap).sum())
    assert (dropped > 0) == (cf is not None), (dropped, cap)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    np.testing.assert_allclose(float(aux_t.detach()), float(aux_j),
                               rtol=1e-6)
    if grad:
        (gx_t,) = torch.autograd.grad(
            (out_t * torch.from_numpy(wt)).sum() + 100.0 * aux_t, xt)
        np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), **TOL)


def test_moe_capacity_is_the_references():
    """cap = max(int(k s cf / E), 4 if s > 1 else k), at most s k: a
    decode token (s = 1) keeps its k choices."""
    cfg = t_get_config(KIMI).model
    assert t_tf.moe_capacity(cfg, 512) == int(8 * 512 * 1.25 / 384)
    assert t_tf.moe_capacity(cfg, 1) == 8
    assert t_tf.moe_capacity(cfg, 3) == 4
    small = dataclasses.replace(cfg, num_experts=48)
    assert t_tf.moe_capacity(small, 512) == 106


# ---------------------------------------------------------------------------
# Logits


LOGIT_CASES = [(KIMI, None, 448), (KIMI, 1.25, 448), (LLAMA4, None, 512),
               (LLAMA4, 1.25, 512)]


@pytest.mark.parametrize("case", LOGIT_CASES,
                         ids=lambda c: f"{c[0][:5]}-cf{c[1]}-d{c[2]}")
def test_logits_match_reference(case):
    """The full forward and head: kimi-k2 at d_model 448 over 4 heads of
    112 (2 kv heads), llama4 at 512 over 4 heads of 128 (RoPE theta
    500000); the forward's aux equals the reference's."""
    name, cf, d = case
    (model_j, params_j), (model_t, params_t) = _pair(name, cf=cf, d_model=d)
    assert model_t.cfg.head_dim == d // 4
    toks = np.random.default_rng(1).integers(0, 256, (2, SEQ)) \
        .astype(np.int32)
    x_j, aux_j, _ = model_j.forward(params_j, None,
                                    {"tokens": jnp.asarray(toks)})
    want = model_j.head(params_j, x_j)
    with torch.no_grad():
        x_t, aux_t, _ = model_t.forward(params_t, None,
                                        {"tokens": torch.from_numpy(toks)})
        got = model_t.head(params_t, x_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)


def test_remat_recomputes_the_same_routing():
    """Under remat "full" and "dots" each layer, router and top-k
    included, runs again in the backward: the loss and every adapter
    gradient equal the step without remat bit for bit."""
    _, (model_t, params_t) = _pair(KIMI, cf=1.25, layers=3)
    state = t_rounds.init_state(model_t, torch.Generator().manual_seed(1),
                                num_clients=3)
    state["cuts"] = torch.tensor(CUTS, dtype=torch.int32)
    rng = np.random.default_rng(0)
    for side in ("client_adapters", "server_adapters"):
        for leaves in state[side].values():
            for leaf in leaves.values():
                leaf["B"] = torch.from_numpy(
                    rng.normal(size=leaf["B"].shape).astype(np.float32)
                    * 0.05)
    toks = rng.integers(3, 256, size=(3, 2, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    outs = {}
    for remat in ("none", "full", "dots"):
        tot, met, gc, gs = t_rounds.round_grads(
            model_t, params_t, state, batch, WEIGHTS, remat=remat)
        outs[remat] = [tot, met["aux"]] + tree_leaves(gc) + tree_leaves(gs)
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b)
                   for a, b in zip(outs["none"], outs[remat])), remat
    assert float(outs["none"][1]) > 0


# ---------------------------------------------------------------------------
# The sync round engine


def _round_setup(cf=None):
    (model_j, params_j), (model_t, params_t) = _pair(KIMI, cf=cf, layers=3)
    state_j = j_rounds.init_state(model_j, jax.random.PRNGKey(1),
                                  num_clients=3)
    rng = np.random.default_rng(0)
    for side in ("client_adapters", "server_adapters"):
        state_j[side] = jax.tree.map(
            lambda v: jnp.asarray(rng.normal(size=v.shape) * 0.05,
                                  jnp.float32), state_j[side])
    state_j["cuts"] = jnp.asarray(CUTS, jnp.int32)
    toks = rng.integers(3, 256, size=(3, 2, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
             "loss_mask": (rng.random((3, 2, SEQ)) > 0.1)
             .astype(np.float32)}
    return dict(model_j=model_j, params_j=params_j, model_t=model_t,
                params_t=params_t, state_np=_np(state_j), batch=batch)


@pytest.fixture(scope="module")
def rounds_setup():
    """Reduced kimi-k2 at capacity 1.25: pairs are dropped in the round."""
    return _round_setup(1.25)


def test_round_losses_and_gradients_match_reference(rounds_setup):
    """Per-client losses, the aux loss (one scalar summed into every
    client's objective) and the client and server adapters' gradients of
    the weighted round loss (jax.grad against round_grads) at cuts [1, 2,
    2], uncompressed."""
    s = rounds_setup
    model_j, model_t = s["model_j"], s["model_t"]
    state_j = jax.tree.map(jnp.asarray, s["state_np"])
    state_t = bridge.state_from_numpy(s["state_np"], "cpu")
    b_j = j_smashed.make_boundary(j_smashed.make_compressor("none"),
                                  state_j["cuts"])
    b_t = t_smashed.make_boundary(t_smashed.make_compressor("none"),
                                  state_t["cuts"])
    batch_j = jax.tree.map(jnp.asarray, s["batch"])
    wl = WEIGHTS / WEIGHTS.sum()

    def loss_j(cad, sad):
        eff = j_split.merge_adapters(model_j, cad, sad, state_j["cuts"])
        per, met = model_j.loss(s["params_j"], eff, batch_j,
                                per_client=True, boundary=b_j)
        return jnp.sum(wl * per), (per, met)

    (_, (per_j, met_j)), g_j = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(
        state_j["client_adapters"], state_j["server_adapters"])
    _, met_t, gc_t, gs_t = t_rounds.round_grads(
        model_t, s["params_t"], state_t, s["batch"], WEIGHTS, boundary=b_t)
    np.testing.assert_allclose((met_t["ce"] + met_t["aux"]).numpy(),
                               np.asarray(per_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(met_t["aux"]), float(met_j["aux"]),
                               rtol=1e-5)
    assert float(met_t["aux"]) > 0
    got = tree_leaves(gc_t) + tree_leaves(gs_t)
    want = jax.tree.leaves(g_j[0]) + jax.tree.leaves(g_j[1])
    assert len(got) == len(want)
    floor = 1e-4 * max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=floor)


def test_sgd_round_under_microbatch_matches_reference(rounds_setup):
    """One round of make_train_step (SGD) with microbatch 2: the two
    slices' losses, aux and gradients summed and halved as the
    reference's scan does, then FedAvg and the broadcast."""
    s = rounds_setup
    sgd = lambda arch: arch.replace(train=dataclasses.replace(  # noqa: E731
        arch.train, optimizer="sgd"))
    model_j = j_build_model(sgd(s["model_j"].arch))
    model_t = build_model(sgd(s["model_t"].arch), device="cpu")
    step_j = j_rounds.make_train_step(model_j, microbatch=2)
    step_t = t_rounds.make_train_step(model_t, microbatch=2)
    state_j, met_j = step_j(s["params_j"],
                            jax.tree.map(jnp.asarray, s["state_np"]),
                            jax.tree.map(jnp.asarray, s["batch"]),
                            jnp.asarray(WEIGHTS), jnp.asarray(ACTIVE),
                            jnp.float32(LR), jnp.float32(LR))
    state_t, met_t = step_t(s["params_t"],
                            bridge.state_from_numpy(s["state_np"], "cpu"),
                            s["batch"], WEIGHTS, ACTIVE, LR, LR)
    got, want = bridge.to_numpy(state_t), _np(state_j)
    for side in ("client_adapters", "server_adapters"):
        mine = dict((jax.tree_util.keystr(k), v) for k, v in
                    jax.tree_util.tree_flatten_with_path(got[side])[0])
        for k, v in jax.tree_util.tree_flatten_with_path(want[side])[0]:
            np.testing.assert_allclose(mine[jax.tree_util.keystr(k)], v,
                                       rtol=1e-5, atol=1e-5)
    met_t = bridge.to_numpy(met_t)
    for k in ("total", "ce", "aux", "accuracy", "tokens"):
        np.testing.assert_allclose(met_t[k], np.asarray(met_j[k]),
                                   rtol=1e-4, atol=1e-6)


def test_async_tick_fleet_objective_matches_reference(rounds_setup):
    """One tick of the async engine (buffer 2, SGD; clients 0 and 1
    finish) on reduced kimi-k2: the fleet objective averages every
    client's loss, its nll plus the aux loss, as the reference's does;
    the finishers' adapters and the server's after the tick."""
    s = rounds_setup
    sgd = lambda arch: arch.replace(train=dataclasses.replace(  # noqa: E731
        arch.train, optimizer="sgd"))
    model_j = j_build_model(sgd(s["model_j"].arch))
    model_t = build_model(sgd(s["model_t"].arch), device="cpu")
    act = np.array([1, 1, 0], np.float32)
    # SGD's optimizer slots, the setup's adapters and cuts
    st = _np(j_rounds.init_state(model_j, jax.random.PRNGKey(1),
                                 num_clients=3))
    st.update({k: s["state_np"][k] for k in ("client_adapters",
                                             "server_adapters", "cuts")})
    state_j = j_rounds.prepare_state(jax.tree.map(jnp.asarray, st),
                                     async_buffer=True)
    state_t = t_rounds.prepare_state(bridge.state_from_numpy(st, "cpu"),
                                     async_buffer=True)
    new_j, met_j = j_rounds.make_train_step(
        model_j, async_buffer=True, buffer_size=2)(
        s["params_j"], state_j, jax.tree.map(jnp.asarray, s["batch"]),
        jnp.asarray(WEIGHTS), jnp.asarray(act), jnp.float32(LR),
        jnp.float32(LR))
    new_t, met_t = t_rounds.make_train_step(
        model_t, async_buffer=True, buffer_size=2)(
        s["params_t"], state_t, s["batch"], WEIGHTS, act, LR, LR)
    for k in ("fleet_total", "total"):
        np.testing.assert_allclose(float(met_t[k]), float(met_j[k]),
                                   rtol=1e-5)
    assert float(met_t["aux"]) > 0
    for side in ("client_adapters", "server_adapters"):
        for g, w in zip(tree_leaves(new_t[side]),
                        jax.tree.leaves(new_j[side])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# Serving


def _serving_pair(prompts=(5, 17, 9, 24), max_new=6):
    (model_j, params_j), (model_t, params_t) = _pair(KIMI, cf=1.25)
    pool_j = j_serving.build_adapter_pool(model_j, jax.random.PRNGKey(1), 3,
                                          ranks=[4, 2, 4])
    pool_t = bridge.pool_from_numpy(_np(pool_j), "cpu")
    rng = np.random.default_rng(7)
    reqs = [dict(rid=i, adapter=i % 3,
                 tokens=rng.integers(3, 250, size=plen), max_new=max_new)
            for i, plen in enumerate(prompts)]
    return (model_j, params_j, pool_j), (model_t, params_t, pool_t), reqs


@pytest.mark.parametrize("page_size", [0, 8])
def test_serving_tokens_equal_jax_engine(page_size):
    """The port's engine against the JAX engine at capacity 1.25: each
    prompt padded to its bucket (8, 16 or 32), whose length sets the
    prefill's capacity, as in the reference; decode tokens, one per
    slot, are groups of one that keep all k choices."""
    (model_j, params_j, pool_j), (model_t, params_t, pool_t), reqs = \
        _serving_pair()
    cfg = dict(num_slots=2, max_len=SEQ, page_size=page_size)
    want = j_serving.ServingEngine(
        model_j, params_j, pool_j, j_serving.ServeConfig(**cfg)).run(
        [j_serving.Request(**r) for r in reqs])
    got = t_serving.ServingEngine(
        model_t, params_t, pool_t, t_serving.ServeConfig(**cfg),
        device="cpu").run([t_serving.Request(**r) for r in reqs])
    assert [r["tokens"] for r in got] == [r["tokens"] for r in want]


def test_serial_reference_equals_jax():
    """serial_reference (prefill at the true prompt length, then one
    decode step per token) against the reference's at capacity 1.25."""
    (model_j, params_j, pool_j), (model_t, params_t, pool_t), reqs = \
        _serving_pair(prompts=(17,), max_new=3)
    want = j_serving.serial_reference(
        model_j, params_j, pool_j, [j_serving.Request(**r) for r in reqs],
        max_len=SEQ)
    got = t_serving.serial_reference(
        model_t, params_t, pool_t, [t_serving.Request(**r) for r in reqs],
        max_len=SEQ)
    assert got == want
