"""The round engine's remaining options and the async event loop of the
port against the JAX package's, on the CPU.

Size: gpt2-small reduced to 2 layers, d_model 64, vocab 512, seq 32,
batch 2; 3 clients; torch on one thread.  Engine checks start both
packages from the reference's weights and state (``repro_torch.bridge``);
the port's own pins (K = 1 local steps equal to the sync step, one edge
equal to flat, ...) hold bit for bit, as the reference's do.

Tolerances:
  * compression of equal inputs: bitwise (top-k on distinct magnitudes,
    int8 against the reference's jitted quantizer);
  * staleness weights: 1 ulp (an fp32 power on each side);
  * aggregation and one engine round: rtol 1e-5 and an absolute 1e-6 (fp32
    sums in another order; the two-tier sums telescope to flat within
    rtol 2e-5, as the reference pins);
  * system runs: everything on the simulated clock, comm bytes, budgets,
    buffer fills and staleness bitwise (numpy on both sides); losses
    within rtol 1e-4 in rounds 0-1 and 1e-3 after (AdamW, see
    tests/test_torch_system.py).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import aggregation as j_agg  # noqa: E402
from repro.core import rounds as j_rounds  # noqa: E402
from repro.core import system as j_system  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.optim import compression as j_comp  # noqa: E402
from repro.runtime import serving as j_serving  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import reduced as t_reduced  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import aggregation as t_agg  # noqa: E402
from repro_torch.core import rounds as t_rounds  # noqa: E402
from repro_torch.core import smashed as t_smashed  # noqa: E402
from repro_torch.core import split as t_split  # noqa: E402
from repro_torch.core import system as t_system  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import compression as t_comp  # noqa: E402
from repro_torch.runtime import serving as t_serving  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SMALL = dict(layers=2, d_model=64, vocab=512, seq_len=32, batch=2)
N = 3
DATA = dict(num_samples=150, eval_samples=32)
CONST = dict(speed_sigma=0.0, bw_sigma=0.0, jitter_sigma=0.0)
ZERO_WIRE = dict(bw_mean=float("inf"), bw_sigma=0.0)
LR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _arch(reduced, get_config, **train):
    arch = reduced(get_config("gpt2-small"), **SMALL)
    return arch.replace(train=dataclasses.replace(
        arch.train, **{"lr_client": 3e-3, "lr_server": 3e-3, **train}))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
    assert a.tobytes() == b.tobytes(), (a, b)


def same_tree(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def close_tree(got, want, rtol=1e-5, atol=1e-6):
    lw = jax.tree.leaves(want)
    lg = jax.tree.leaves(got)
    assert len(lw) == len(lg)
    for g, w in zip(lg, lw):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol)


def _tree(rng, shapes):
    return {k: rng.normal(size=s).astype(np.float32) * (i + 1)
            for i, (k, s) in enumerate(shapes.items())}


SHAPES = {"a": (2, 3, 40, 4), "b": (2, 3, 4, 40), "c": (7,)}


# ---------------------------------------------------------------------------
# optim/compression.py


@pytest.mark.parametrize("frac", [0.05, 0.3])
def test_topk_compression_matches_reference(frac):
    rng = np.random.default_rng(0)
    tree = _tree(rng, SHAPES)
    resid = _tree(rng, SHAPES)
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    rt = {k: torch.from_numpy(v) for k, v in resid.items()}
    dense_j, res_j, bytes_j = j_comp.ErrorFeedback.apply(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, resid),
        frac)
    dense_t, res_t, bytes_t = t_comp.ErrorFeedback.apply(tt, rt, frac)
    assert bytes_t == bytes_j
    for k in tree:
        same(dense_t[k].numpy(), np.asarray(dense_j[k]))
        same(res_t[k].numpy(), np.asarray(res_j[k]))
    comp = t_comp.topk_compress(tt, frac)
    back = t_comp.topk_decompress(comp, tt)
    for k in tree:
        same((back[k] + comp[k]["residual"]).numpy(), tree[k])


def test_int8_quantizer_matches_the_jitted_reference_bitwise():
    """The port's scale is amax * fp32(1/127), what XLA compiles the
    reference's amax / 127 to inside the jitted round step; the eager
    reference divides, and differs in the last bit for some leaves."""
    rng = np.random.default_rng(1)
    tree = {f"l{i}": (rng.normal(size=(3, 17)) * rng.uniform(1e-4, 10))
            .astype(np.float32) for i in range(64)}
    q_t = t_comp.int8_quantize({k: torch.from_numpy(v)
                                for k, v in tree.items()})
    q_j = jax.jit(j_comp.int8_quantize)(jax.tree.map(jnp.asarray, tree))
    q_e = j_comp.int8_quantize(jax.tree.map(jnp.asarray, tree))
    for k in tree:
        same(q_t[k]["q"].numpy(), np.asarray(q_j[k]["q"]))
        same(q_t[k]["scale"].numpy(), np.asarray(q_j[k]["scale"]))
    d_t = t_comp.int8_dequantize(q_t)
    d_j = j_comp.int8_dequantize(q_j)
    for k in tree:
        same(d_t[k].numpy(), np.asarray(d_j[k]))
    eager = sum(float(q_e[k]["scale"]) != float(q_j[k]["scale"])
                for k in tree)
    assert eager > 0, "the eager and jitted reference scales agree here"


# ---------------------------------------------------------------------------
# core/aggregation.py


def test_staleness_discount_within_one_ulp_of_reference():
    s = np.arange(0, 200, 0.5, dtype=np.float32)
    for power in (0.0, 0.5, 1.3):
        got = t_agg.staleness_discount(s, power=power).numpy()
        want = np.asarray(j_agg.staleness_discount(s, power=power))
        assert got.dtype == want.dtype == np.float32
        ulp = np.abs(got.view(np.int32) - want.view(np.int32))
        assert ulp.max() <= 1, (power, ulp.max())
        assert got[0] == 1.0 and (np.diff(got) <= 0).all()


@pytest.fixture(scope="module")
def models():
    mj = j_build_model(_arch(j_reduced, j_get_config))
    mt = build_model(_arch(t_reduced, t_get_config), device="cpu")
    state = j_rounds.init_state(mj, jax.random.PRNGKey(1), num_clients=4)
    rng = np.random.default_rng(3)
    cad = jax.tree.map(lambda v: rng.normal(size=v.shape).astype(np.float32),
                       _np(state["client_adapters"]))
    return mj, mt, cad


AGG = [dict(steps=[1.0, 2.0, 4.0, 1.0]),
       dict(staleness=[0.0, 3.0, 1.0, 7.0], staleness_power=0.5),
       dict(edge_assign=[0, 1, 0, 1], num_edges=2),
       dict(edge_assign=[0, 0, 1, 2], num_edges=3, steps=[1.0, 2.0, 1, 3],
            ranks=True)]


@pytest.mark.parametrize("kw", AGG, ids=["steps", "staleness", "two_tier",
                                         "two_tier_ranks"])
def test_fedavg_options_match_reference(models, kw):
    mj, mt, cad = models
    cuts = np.asarray([1, 2, 2, 1], np.int32)
    w = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    act = np.asarray([1.0, 1.0, 0.0, 1.0], np.float32)
    kw = dict(kw)
    if kw.pop("ranks", False):
        kw["ranks"] = np.asarray([[2, 8], [8, 8], [4, 8], [8, 2]], np.int32)
    want = j_agg.fedavg(mj, jax.tree.map(jnp.asarray, cad), cuts, w, act,
                        **{k: (jnp.asarray(v) if isinstance(v, list)
                               or isinstance(v, np.ndarray) else v)
                           for k, v in kw.items()})
    got = t_agg.fedavg(mt, bridge.params_from_numpy(cad, "cpu"),
                       torch.from_numpy(cuts), w, act,
                       **{k: (torch.as_tensor(v) if isinstance(v, list)
                              or isinstance(v, np.ndarray) else v)
                          for k, v in kw.items()})
    close_tree(bridge.to_numpy(got), _np(want), rtol=2e-5, atol=2e-6)


def test_one_edge_is_flat_and_edges_telescope(models):
    _, mt, cad = models
    cad = bridge.params_from_numpy(cad, "cpu")
    cuts = torch.tensor([2, 2, 1, 2], dtype=torch.int32)
    w = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    act = np.ones(4, np.float32)
    flat = t_agg.fedavg(mt, cad, cuts, w, act)
    one = t_agg.fedavg(mt, cad, cuts, w, act,
                       edge_assign=torch.zeros(4, dtype=torch.int32),
                       num_edges=1)
    same_tree(flat, one)
    two = t_agg.fedavg(mt, cad, cuts, w, act,
                       edge_assign=torch.tensor([0, 1, 0, 1]), num_edges=2)
    for a, b in zip(tree_leaves(flat), tree_leaves(two)):
        torch.testing.assert_close(b, a, rtol=2e-5, atol=2e-6)


def test_broadcast_reaches_only_the_buffered_clients(models):
    _, mt, cad = models
    cad = bridge.params_from_numpy(cad, "cpu")
    cuts = torch.tensor([2, 2, 1, 2], dtype=torch.int32)
    agg = t_agg.fedavg(mt, cad, cuts, np.full(4, 0.25, np.float32),
                       np.ones(4, np.float32))
    sad = {g: {t: {k: v[:, 0] * 0 + 7 for k, v in ad.items()}
               for t, ad in tg.items()} for g, tg in cad.items()}
    out = t_agg.broadcast_after_agg(mt, cad, agg, sad, cuts,
                                    recv_mask=[1.0, 0.0, 1.0, 0.0])
    full = t_agg.broadcast_after_agg(mt, cad, agg, sad, cuts)
    for o, f, c in zip(tree_leaves(out), tree_leaves(full),
                       tree_leaves(cad)):
        assert torch.equal(o[:, [0, 2]], f[:, [0, 2]])
        assert torch.equal(o[:, [1, 3]], c[:, [1, 3]])


# ---------------------------------------------------------------------------
# the engines on one model (the port's own pins, bit for bit)


@pytest.fixture(scope="module")
def engine():
    arch = t_reduced(t_get_config("gpt2-small"), layers=4, d_model=32,
                     vocab=128, seq_len=16, batch=2)
    arch = arch.replace(train=dataclasses.replace(arch.train,
                                                  grad_clip=0.0))
    model = build_model(arch, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(3, 128, size=(N, 2, 17)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    return model, params, batch


def _state(model, seed=1, **prep):
    state = t_rounds.init_state(model, torch.Generator().manual_seed(seed),
                                num_clients=N)
    for targets in state["client_adapters"].values():
        for leaf in targets.values():     # non-zero B: every grad flows
            leaf["B"] = torch.randn(leaf["B"].shape,
                                    generator=torch.Generator()
                                    .manual_seed(seed)) * 0.05
    return t_rounds.prepare_state(state, **prep)


def _stacked(batch, k):
    return {key: np.stack([v] * k) for key, v in batch.items()}


W = np.full(N, 1.0 / N, np.float32)
ACT = np.ones(N, np.float32)


@pytest.mark.parametrize("per_client", [False, True])
def test_local_steps_k1_is_the_sync_step_bitwise(engine, per_client):
    """K = 3 with every budget 1 is the sync step, 3 rounds, bit for bit
    (the reference's pin); with per-client Adam counts too."""
    model, params, batch = engine
    s_sync = _state(model)
    s_ls = t_rounds.with_step_budgets(_state(model))
    if per_client:
        s_ls = t_rounds.with_per_client_opt_steps(s_ls)
    sync = t_rounds.make_train_step(model)
    ls = t_rounds.make_train_step(model, max_local_steps=3)
    for _ in range(3):
        s_sync, m1 = sync(params, s_sync, batch, W, ACT, LR, LR)
        s_ls, mk = ls(params, s_ls, _stacked(batch, 3), W, ACT, LR, LR)
    assert torch.equal(m1["total"], mk["total"])
    for k in ("client_adapters", "server_adapters", "opt_s"):
        same_tree(s_sync[k], s_ls[k])
    for k in ("m", "v"):
        same_tree(s_sync["opt_c"][k], s_ls["opt_c"][k])


def test_local_steps_stop_early_as_all_inner_steps(engine):
    """Budgets (1, 2, 1) under K = 4: the loop stops after inner step 2;
    the reference's scan runs all 4, and its later steps change nothing,
    so running all 4 here gives the same state bit for bit."""
    model, params, batch = engine
    out = []
    for every in (False, True):
        st = _state(model, max_local_steps=4)
        st["step_budgets"] = torch.tensor([1, 2, 1], dtype=torch.int32)
        step = t_rounds.make_train_step(model, max_local_steps=4,
                                        all_inner_steps=every)
        st, met = step(params, st, _stacked(batch, 4), W, ACT, LR, LR)
        out.append((st, met))
    (a, ma), (b, mb) = out
    for k in ("client_adapters", "server_adapters", "opt_c", "opt_s"):
        same_tree(a[k], b[k])
    assert torch.equal(ma["total"], mb["total"])
    assert a["opt_c"]["count"].tolist() == [1, 2, 1]


def test_local_steps_budgets_freeze_exhausted_clients(engine):
    model, params, batch = engine

    def run(budgets):
        st = _state(model, max_local_steps=3)
        st["step_budgets"] = torch.tensor(budgets, dtype=torch.int32)
        step = t_rounds.make_train_step(model, max_local_steps=3,
                                        agg_every=100)
        return step(params, st, _stacked(batch, 3), W, ACT, LR, LR)[0]

    het, ones = run([1, 3, 1]), run([1, 1, 1])
    a_het = het["client_adapters"]["dec"]["q"]["A"]
    a_one = ones["client_adapters"]["dec"]["q"]["A"]
    assert torch.equal(a_het[:, 0], a_one[:, 0])
    assert (a_het[:, 1] - a_one[:, 1]).abs().max() > 0


def test_per_client_adam_count_fixes_bias_correction(engine):
    """The reference's pin: with per-client counts a budget-1 client
    evolves exactly as in a run where every budget is 1; with the shared
    count it does not.  lr_s = 0 and no grad clip decouple the clients."""
    model, params, batch = engine

    def run(budgets, per_client):
        st = t_rounds.with_step_budgets(_state(model))
        if per_client:
            st = t_rounds.with_per_client_opt_steps(st)
        st["step_budgets"] = torch.tensor(budgets, dtype=torch.int32)
        step = t_rounds.make_train_step(model, max_local_steps=3,
                                        agg_every=100)
        for _ in range(2):
            st, _ = step(params, st, _stacked(batch, 3), W, ACT, LR, 0.0)
        return st

    def client0(st):
        return st["client_adapters"]["dec"]["q"]["A"][:, 0]

    het, ones = run([1, 3, 3], True), run([1, 1, 1], True)
    assert torch.equal(client0(het), client0(ones))
    assert het["opt_c"]["count"].tolist() == [2, 6, 6]
    legacy = run([1, 3, 3], False)
    assert int(legacy["opt_c"]["count"]) == 6
    assert (client0(legacy) - client0(ones)).abs().max() > 0


def test_server_step_norm_is_a_bitwise_noop_at_k1(engine):
    model, params, batch = engine
    out = []
    for norm in (True, False):
        st = _state(model, max_local_steps=3)
        step = t_rounds.make_train_step(model, max_local_steps=3,
                                        server_step_norm=norm)
        out.append(step(params, st, _stacked(batch, 3), W, ACT, LR, LR)[0])
    same_tree(out[0]["server_adapters"], out[1]["server_adapters"])
    same_tree(out[0]["client_adapters"], out[1]["client_adapters"])
    x = torch.randn(2, 1, 3, 4)
    assert torch.equal(t_split._grad_scaled(x, torch.ones(N)),
                       x.expand(2, N, 3, 4))


@pytest.mark.parametrize("local_steps", [False, True])
def test_smashed_ef_frozen_for_inactive_clients(engine, local_steps):
    model, params, batch = engine
    st = t_rounds.with_smashed_ef(
        _state(model, max_local_steps=2 if local_steps else 1), model)
    step = t_rounds.make_train_step(model, smashed_compress="topk",
                                    max_local_steps=2 if local_steps else 1)
    b = _stacked(batch, 2) if local_steps else batch
    st, _ = step(params, st, b, W, np.asarray([1, 0, 1], np.float32),
                 LR, LR)
    ef = st["smashed_ef"]
    assert ef[0].abs().max() > 0 and ef[2].abs().max() > 0
    assert torch.equal(ef[1], torch.zeros_like(ef[1]))


def test_smashed_ef_under_remat_full_is_bitwise(engine):
    """The residual is a returned output of the recomputed layer: remat
    "full" and "dots" give the step without remat bit for bit, residual,
    gradients and adapters included."""
    model, params, batch = engine
    out = {}
    for remat in ("none", "full", "dots"):
        st = t_rounds.with_smashed_ef(_state(model), model)
        st["smashed_ef"] = torch.randn(st["smashed_ef"].shape,
                                       generator=torch.Generator()
                                       .manual_seed(5)) * 0.1
        step = t_rounds.make_train_step(model, smashed_compress="topk",
                                        remat=remat)
        for _ in range(2):
            st, met = step(params, st, batch, W, ACT, LR, LR)
        out[remat] = (st, met)
    for remat in ("full", "dots"):
        a, b = out["none"], out[remat]
        assert torch.equal(a[1]["total"], b[1]["total"])
        assert torch.equal(a[0]["smashed_ef"], b[0]["smashed_ef"])
        same_tree(a[0]["client_adapters"], b[0]["client_adapters"])
        same_tree(a[0]["server_adapters"], b[0]["server_adapters"])


def test_ef_boundary_loses_nothing_at_the_cut():
    """compress(x + r) + r' == x + r on the cut client's rows; the other
    rows and the residual there pass through."""
    comp = t_smashed.make_compressor("topk", topk_frac=0.25)
    x = torch.randn(3, 2, 5, 8)
    r = torch.randn(3, 2, 5, 8)
    hook = t_smashed.make_boundary(comp, [2, 1, 2], residual=r)
    assert hook.stateful
    y, r2 = hook(x, hook.init(), 0)
    assert torch.equal(y[[0, 2]], x[[0, 2]])
    assert torch.equal(r2[[0, 2]], torch.zeros_like(r2[[0, 2]]))
    torch.testing.assert_close(y[1] + r2[1], x[1] + r[1], rtol=0, atol=0)
    y, same_carry = hook(x, r2, 3)        # no client cuts at layer 3
    assert y is x and same_carry is r2


def test_agg_every_aggregates_on_the_round_boundary(engine):
    model, params, batch = engine
    st = _state(model)
    step = t_rounds.make_train_step(model, agg_every=2)
    st, _ = step(params, st, batch, W, ACT, LR, LR)      # round 0: local
    rows = st["client_adapters"]["dec"]["q"]["A"]
    assert (rows[0, 0] - rows[0, 1]).abs().max() > 0
    st, _ = step(params, st, batch, W, ACT, LR, LR)      # round 1: FedAvg
    rows = st["client_adapters"]["dec"]["q"]["A"]
    assert torch.equal(rows[0, 0], rows[0, 1])


def test_async_engine_validation_follows_the_reference(engine):
    model = engine[0]
    for kw, msg in ((dict(compress="topk"), "compress"),
                    (dict(max_local_steps=2), "compose"),
                    (dict(agg_every=2), "agg_every"),
                    (dict(buffer_size=0), "buffer_size")):
        with pytest.raises(ValueError, match=msg):
            t_rounds.make_train_step(model, async_buffer=True, **kw)
    st = _state(model, async_buffer=True)
    step = t_rounds.make_train_step(model, async_buffer=True, buffer_size=5)
    with pytest.raises(ValueError, match="never fill"):
        step(engine[1], st, engine[2], W, ACT, LR, LR)


# ---------------------------------------------------------------------------
# SplitFTSystem: the local-steps and async host loops


def _port(kw, seed=0):
    return t_system.SplitFTSystem(_arch(t_reduced, t_get_config),
                                  t_system.SystemConfig(**DATA, **kw),
                                  seed=seed, device="cpu")


def _pair(kw, seed=3):
    j = j_system.SplitFTSystem(_arch(j_reduced, j_get_config),
                               j_system.SystemConfig(**DATA, **kw),
                               seed=seed)
    t = _port(kw, seed)
    t.base_params = bridge.params_from_numpy(_np(j.base_params), "cpu")
    t.state = bridge.state_from_numpy(_np(j.state), "cpu")
    return j, t


def _digest(state):
    return [leaf.numpy().tobytes()
            for key in ("client_adapters", "server_adapters")
            for leaf in tree_leaves(state[key])]


SYSTEMS = {
    "local_steps": dict(scheduler="local_steps", max_local_steps=3,
                        straggler_sim=True, agg_every=2, compress="topk",
                        smashed_compress="topk"),
    "async": dict(scheduler="async", buffer_size=2, straggler_sim=True,
                  jitter_sigma=0.3, smashed_compress="int8",
                  overlap_comm=True),
    "edge_groups": dict(edge_groups=2, compress="int8",
                        smashed_compress="int8", straggler_sim=True,
                        server_ingest_bw=1e6),
}


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_system_matches_the_reference(name):
    """4 rounds from the reference's weights: the simulated clock, comm
    bytes, budgets, buffer fills, staleness and cuts bit for bit, the
    losses within rtol 1e-4 (rounds 0-1) and 1e-3."""
    j, t = _pair(SYSTEMS[name])
    hj, ht = j.run(4, log_every=0), t.run(4, log_every=0)
    assert len(ht) == 4
    for r, (a, b) in enumerate(zip(hj, ht)):
        assert set(a) == set(b)
        for k in set(a) - {"loss", "ce", "accuracy", "eval_ce",
                           "eval_accuracy", "weights"}:
            same(a[k], b[k])
        rtol = 1e-4 if r < 2 else 1e-3
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=rtol)
        np.testing.assert_allclose(b["eval_ce"], a["eval_ce"], rtol=1e-3)
    assert j.sim_clock == t.sim_clock
    if name == "async":
        assert j.scheduler.state_dict() == t.scheduler.state_dict()


def test_async_buffer_n_at_constant_speed_is_sync_bitwise():
    kw = dict(adaptive=False, **CONST)
    s_sync = _port(dict(kw, scheduler="sync", straggler_sim=True))
    h_sync = s_sync.run(4, log_every=0)
    s_async = _port(dict(kw, scheduler="async", buffer_size=N))
    h_async = s_async.run(4, log_every=0)
    for a, b in zip(h_sync, h_async):
        assert a["loss"] == b["loss"]
        assert a["sim_clock"] == b["sim_clock"]
        same(a["comm"], b["comm"])
        assert b["buffer_fill"] == float(N)
        same(b["staleness"], np.zeros(N))
    assert _digest(s_sync.state) == _digest(s_async.state)
    assert int(s_async.state["global_version"]) == 4


def test_async_overlap_zero_wire_is_serial_bitwise():
    runs = {}
    for ov in (False, True):
        s = _port(dict(scheduler="async", buffer_size=2, adaptive=False,
                       overlap_comm=ov, **ZERO_WIRE), seed=3)
        runs[ov] = (s, s.run(4, log_every=0))
    (s_ser, h_ser), (s_ov, h_ov) = runs[False], runs[True]
    for a, b in zip(h_ser, h_ov):
        for k in ("loss", "sim_clock", "sim_time"):
            assert a[k] == b[k]
        same(a["active"], b["active"])
        same(a["round_time_sim"], b["round_time_sim"])
    assert _digest(s_ser.state) == _digest(s_ov.state)


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["mid_buffer", "mid_pipeline"])
def test_async_checkpoint_round_trip(tmp_path, overlap):
    """Save with events in flight (and, serial, a partly filled buffer);
    a restored system replays the identical event stream: queue keys come
    back as tuples, clock floats bit for bit, and the next aggregations
    equal the straight run's."""
    cfg = dict(scheduler="async", buffer_size=N if not overlap else 2,
               adaptive=False, overlap_comm=overlap,
               checkpoint_dir=str(tmp_path))
    s1 = _port(cfg, seed=3)
    s1.run(2, log_every=0)
    lr = s1._lrs()
    if not overlap:
        while float(s1.state["buffer_mask"].sum()) == 0:
            assert s1._async_tick(2, *lr) is None
        assert 0 < float(s1.state["buffer_mask"].sum()) < N
    s1.save(42)
    meta = json.loads((tmp_path / "ckpt_00000042.npz.meta.json")
                      .read_text())["metadata"]
    assert meta["async_sim"]["queue"]["events"]
    s2 = _port(cfg, seed=3)
    assert s2.restore()
    q1, q2 = s1.scheduler.queue, s2.scheduler.queue
    assert q1.now == q2.now and q1._pending == q2._pending
    assert all(isinstance(k, tuple) for k in q2._pending)
    same(s1.scheduler.csched, s2.scheduler.csched)
    same(s1.state["buffer_mask"].numpy(), s2.state["buffer_mask"].numpy())
    h1, h2 = s1.run(2, log_every=0), s2.run(2, log_every=0)
    for a, b in zip(h1[-2:], h2[-2:]):
        assert a["loss"] == b["loss"] and a["sim_clock"] == b["sim_clock"]
        same(a["staleness"], b["staleness"])
    assert _digest(s1.state) == _digest(s2.state)


@pytest.mark.parametrize("overlap", [False, True])
def test_async_elastic_leave_and_rejoin(overlap):
    s = _port(dict(scheduler="async", buffer_size=2, adaptive=False,
                   overlap_comm=overlap, **CONST))
    s.run(2, log_every=0)
    sched = s.scheduler
    s.pool.leave(1)
    frozen = int(sched.launches[1])
    h = s.run(3, log_every=0)
    assert sched.queue.clients() == {0, 2}
    assert int(sched.launches[1]) == frozen
    assert all(rec["round_steps"][1] == 0 and rec["active"][1] == 0.0
               for rec in h[-3:])
    s.pool.join(1)
    h = s.run(3, log_every=0)
    assert sched.queue.clients() == {0, 1, 2}
    assert int(sched.launches[1]) > frozen
    assert any(rec["round_steps"][1] > 0 for rec in h[-3:])
    clocks = [rec["sim_clock"] for rec in s.history]
    assert all(b >= a for a, b in zip(clocks, clocks[1:]))
    s.pool.leave(0)
    s.pool.leave(2)
    with pytest.raises(RuntimeError, match="never fill"):
        s.run(1, log_every=0)


def test_server_step_norm_is_a_bitwise_noop_in_the_sync_system():
    on = _port(dict(server_step_norm=True))
    on.run(2, log_every=0)
    off = _port(dict(server_step_norm=False))
    off.run(2, log_every=0)
    assert _digest(on.state) == _digest(off.state)


# ---------------------------------------------------------------------------
# serving the trained adapters


def test_pool_from_state_matches_reference():
    j, t = _pair(dict(scheduler="local_steps", max_local_steps=2,
                      straggler_sim=True))
    j.run(1, log_every=0)
    t.state = bridge.state_from_numpy(_np(j.state), "cpu")
    want = j_serving.pool_from_state(j.model, j.state)
    got = t_serving.pool_from_state(t.model, t.state)
    close_tree(bridge.to_numpy(got), _np(want), rtol=0, atol=0)
    assert t_serving.num_pool_adapters(got) == N


def test_serve_cli_serves_a_trained_checkpoint(tmp_path, capsys):
    out = tmp_path / "run"
    assert t_train.main(["--reduced", "--rounds", "2", "--samples", "64",
                         "--scheduler", "local_steps", "--max-local-steps",
                         "2", "--straggler-sim", "--out", str(out),
                         "--device", "cpu"]) == 0
    cfg = t_serve.checkpoint_config(str(out / "ckpt"))
    assert cfg["scheduler"] == "local_steps"
    assert t_serve.main(["--reduced", "--adapters", "3", "--requests", "4",
                         "--num-slots", "2", "--prompt-len", "8", "--gen",
                         "4", "--ckpt", str(out / "ckpt"),
                         "--device", "cpu"]) == 0
    assert "served 4 requests" in capsys.readouterr().out
