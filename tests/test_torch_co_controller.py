"""The port's phase-time co-controller against the JAX package's: the
numpy controller (``adaptive.co_adjust``), the per-client compressor
boundary (``smashed.make_multi_boundary``), rank-aware FedAvg and merge,
the round engine over moving (cut, rank, compressor) assignments, and
``SplitFTSystem`` with ``controller="co"`` through 5 rounds and the CLI.

Sizes: the unit pieces at gpt2-small reduced to 4 layers, d_model 32,
vocab 128, seq 16, batch 2, 3 clients (the reference's
tests/test_adaptive.py ``small_model``); the system at its
``small_arch(6)`` (6 layers, d_model 64, vocab 512, seq 64, batch 4,
5 clients, 150 samples, 32 eval samples, lr 3e-3).  Both systems start
from the reference's weights and state (``repro_torch.bridge``).

Tolerances: the controller, the comm bytes and the simulated clock are
numpy on both sides and equal bit for bit, so decisions and predicted
times are compared exactly; the boundary's outputs and cotangents, the
merged and aggregated adapters and losses within 1e-6 relative (fp32
sums in another order; the compressors round identically); one SGD
step's adapters within 1e-5 (tests/test_torch_rounds.py).
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
from repro.core import adaptive as j_adaptive  # noqa: E402
from repro.core import aggregation as j_aggregation  # noqa: E402
from repro.core import lora as j_lora  # noqa: E402
from repro.core import rounds as j_rounds  # noqa: E402
from repro.core import smashed as j_smashed  # noqa: E402
from repro.core import split as j_split  # noqa: E402
from repro.core import system as j_system  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import reduced as t_reduced  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import adaptive as t_adaptive  # noqa: E402
from repro_torch.core import aggregation as t_aggregation  # noqa: E402
from repro_torch.core import lora as t_lora  # noqa: E402
from repro_torch.core import rounds as t_rounds  # noqa: E402
from repro_torch.core import smashed as t_smashed  # noqa: E402
from repro_torch.core import split as t_split  # noqa: E402
from repro_torch.core import system as t_system  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

BUCKETS = ("none", "int8", "fp8", "topk")
SYS = dict(num_samples=150, eval_samples=32)
CO = dict(controller="co", rank_buckets=(1, 2, 4),
          compressor_buckets=BUCKETS, continuous_topk=True,
          straggler_sim=True, jitter_sigma=0.0, smashed_ef=False)
POLICY = ("cuts", "rank_cut", "smashed_choice", "topk_frac",
          "predicted_time")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
    assert a.tobytes() == b.tobytes(), (a, b)


def _close_trees(got, want, rtol=1e-6, atol=1e-7):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(jax.tree.leaves(got)) == len(flat)
    for (path, w), g in zip(flat, jax.tree.leaves(got)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def small_arch(reduced, get_config, layers=4, **kw):
    return reduced(get_config("gpt2-small"), layers=layers,
                   **(kw or dict(d_model=32, vocab=128, seq_len=16,
                                 batch=2)))


def _sgd(arch):
    return arch.replace(train=dataclasses.replace(arch.train,
                                                  optimizer="sgd"))


@pytest.fixture(scope="module")
def models():
    model_j = j_build_model(_sgd(small_arch(j_reduced, j_get_config)))
    model_t = build_model(_sgd(small_arch(t_reduced, t_get_config)),
                          device="cpu")
    cad = _np(j_lora.init_adapters(model_j, jax.random.PRNGKey(0),
                                   num_clients=3))
    sad = _np(j_lora.init_adapters(model_j, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(0)
    for tree in (cad, sad):              # non-zero B: every column matters
        for targets in tree.values():
            for ad in targets.values():
                ad["B"] = (rng.normal(size=ad["B"].shape) * 0.05
                           ).astype(np.float32)
    return model_j, model_t, cad, sad


# ---------------------------------------------------------------------------
# the controller (numpy)


def _co_inputs(rng, n, split, layers, frac):
    buckets = np.asarray(split.buckets(layers))
    speeds = rng.uniform(0.2, 5.0, n)
    wire = rng.uniform(0.0, 3.0, (n, 4))

    def price(cuts, rank, comp, fr=None):
        t = (np.asarray(cuts, float) / speeds + 0.05 * np.asarray(rank)
             + wire[np.arange(n), np.asarray(comp)])
        return t if fr is None else t + 0.5 * np.asarray(fr)

    return dict(
        cuts=rng.choice(buckets, n), rank_cut=rng.choice([1, 2, 4, 8], n),
        comp_idx=rng.integers(0, 4, n),
        accs=rng.choice([0.2, 0.5, 0.5, 0.501, 0.8], n),
        price=price, active=(rng.random(n) > 0.2).astype(float),
        round_times=rng.uniform(0.5, 3.0, n),
        topk_frac=rng.uniform(0.01, 1.0, n) if frac else None)


@pytest.mark.parametrize("frac", [False, True])
def test_co_adjust_is_the_reference_bitwise(frac):
    split = small_arch(t_reduced, t_get_config, 6).split
    for seed in range(20):
        kw = _co_inputs(np.random.default_rng(seed), 7, split, 6, frac)
        cuts, rank, comp, accs = (kw.pop(k) for k in
                                  ("cuts", "rank_cut", "comp_idx", "accs"))
        common = dict(rank_buckets=(1, 2, 4, 8), num_compressors=4,
                      dead_band=0.002, min_gain=0.05, **kw)
        want = j_adaptive.co_adjust(cuts, rank, comp, accs, split, 6,
                                    **common)
        got = t_adaptive.co_adjust(cuts, rank, comp, accs, split, 6,
                                   **common)
        assert len(got) == len(want) == (5 if frac else 4)
        for g, w in zip(got, want):
            same(g, w)


# ---------------------------------------------------------------------------
# the per-client compressor boundary


@pytest.mark.parametrize("frac", [None, [0.1, 0.25, 0.5, 0.1]])
def test_multi_boundary_matches_reference(frac):
    """Forward at every flat layer and the straight-through cotangent, 4
    clients choosing none / int8 / fp8 / topk at cuts [1, 2, 2, 2]."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 2, 16, 64)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    cuts, choice = [1, 2, 2, 2], [1, 2, 3, 1]
    comps_j = tuple(j_smashed.make_compressor(c, topk_frac=0.1)
                    for c in BUCKETS)
    comps_t = tuple(t_smashed.make_compressor(c, topk_frac=0.1)
                    for c in BUCKETS)
    b_j = j_smashed.make_multi_boundary(
        comps_j, jnp.asarray(cuts), jnp.asarray(choice),
        topk_frac=None if frac is None else jnp.asarray(frac, jnp.float32))
    b_t = t_smashed.make_multi_boundary(
        comps_t, torch.tensor(cuts), torch.tensor(choice), topk_frac=frac)
    for fid in range(3):
        y_j, vjp = jax.vjp(lambda v: b_j(v, fid), jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        y_t = b_t(xt, fid)
        (gx_t,) = torch.autograd.grad(y_t, xt, torch.from_numpy(g))
        np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(gx_t.numpy(), np.asarray(vjp(g)[0]),
                                   rtol=1e-6, atol=1e-7)
        assert (fid < 2) == (not torch.equal(y_t, xt))


def test_uniform_fraction_is_the_static_topk_bitwise():
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 2, 16, 64)).astype(np.float32))
    comps = (None, t_smashed.make_compressor("topk", topk_frac=0.1))
    cuts, choice = torch.tensor([2, 2, 2]), torch.tensor([1, 1, 1])
    static = t_smashed.make_boundary(comps[1], cuts)(x, 1)
    dyn = t_smashed.make_multi_boundary(comps, cuts, choice,
                                        topk_frac=[0.1] * 3)(x, 1)
    assert torch.equal(static, dyn)


# ---------------------------------------------------------------------------
# rank-aware merge and FedAvg


def test_merge_and_serve_adapters_take_rank_cut(models):
    model_j, model_t, cad, sad = models
    cuts, rank_cut = [1, 2, 3], [1, 4, 2]
    w = np.array([0.5, 0.3, 0.2], np.float32)
    t_cad, t_sad = (bridge.params_from_numpy(t, "cpu") for t in (cad, sad))
    want = j_split.merge_adapters(model_j, cad, sad, jnp.asarray(cuts),
                                  rank_cut=jnp.asarray(rank_cut))
    got = t_split.merge_adapters(model_t, t_cad, t_sad, torch.tensor(cuts),
                                 rank_cut=torch.tensor(rank_cut))
    _close_trees(bridge.to_numpy(got), _np(want))
    want = j_split.serve_adapters(model_j, cad, sad, jnp.asarray(cuts),
                                  jnp.asarray(w),
                                  rank_cut=jnp.asarray(rank_cut))
    got = t_split.serve_adapters(model_t, t_cad, t_sad, torch.tensor(cuts),
                                 w, rank_cut=torch.tensor(rank_cut))
    _close_trees(bridge.to_numpy(got), _np(want))


def test_fedavg_uniform_rank_is_the_plain_rule_bitwise(models):
    _, model_t, cad, _ = models
    cuts = torch.tensor([2, 2, 2])
    ranks = t_lora.effective_ranks(model_t.num_flat_layers, cuts,
                                   model_t.arch.lora,
                                   r_cut=torch.tensor([2, 2, 2]))
    masked = t_lora.mask_adapters(model_t,
                                  bridge.params_from_numpy(cad, "cpu"),
                                  ranks)
    masked = {g: {t: {k: ad[k] for k in ("A", "B")}
                  for t, ad in targets.items()}
              for g, targets in masked.items()}
    w, act = torch.tensor([0.5, 0.3, 0.2]), torch.ones(3)
    plain = t_aggregation.fedavg(model_t, masked, cuts, w, act)
    hetero = t_aggregation.fedavg(model_t, masked, cuts, w, act,
                                  ranks=ranks)
    for a, b in zip(jax.tree.leaves(bridge.to_numpy(plain)),
                    jax.tree.leaves(bridge.to_numpy(hetero))):
        same(a, b)


def test_fedavg_hetero_ranks_match_reference(models):
    """Columns average their owners only; a column no client owns (>= 2
    at the cut layer) falls back to the layer average, not zero."""
    model_j, model_t, cad, _ = models
    cuts, rank_cut = [2, 2, 2], [1, 2, 2]
    w, act = np.array([0.5, 0.3, 0.2], np.float32), np.ones(3, np.float32)
    ranks_j = j_lora.effective_ranks(model_j.num_flat_layers,
                                     jnp.asarray(cuts), model_j.arch.lora,
                                     r_cut=jnp.asarray(rank_cut))
    ranks_t = t_lora.effective_ranks(model_t.num_flat_layers,
                                     torch.tensor(cuts), model_t.arch.lora,
                                     r_cut=torch.tensor(rank_cut))
    want = j_aggregation.fedavg(model_j, cad, jnp.asarray(cuts), w, act,
                                ranks=ranks_j)
    got = t_aggregation.fedavg(model_t, bridge.params_from_numpy(cad, "cpu"),
                               torch.tensor(cuts), w, act, ranks=ranks_t)
    _close_trees(bridge.to_numpy(got), _np(want))
    a = cad["dec"]["q"]["A"][1]                    # the cut layer
    hp = got["dec"]["q"]["A"][1].numpy()
    np.testing.assert_allclose(hp[:, 1], (w[1:, None] * a[1:, :, 1]).sum(0)
                               / w[1:].sum(), rtol=1e-6)
    assert np.any(hp[:, 2:] != 0)


# ---------------------------------------------------------------------------
# the round engine over moving assignments


ENGINE_BUCKETS = ("none", "int8", "topk")


@pytest.fixture(scope="module")
def engines(models):
    model_j, model_t, _, _ = models
    return (j_rounds.make_train_step(model_j,
                                     compressor_buckets=ENGINE_BUCKETS),
            t_rounds.make_train_step(model_t,
                                     compressor_buckets=ENGINE_BUCKETS))


@pytest.mark.parametrize("assign", [
    ([2, 2, 2], [2, 2, 2], [0, 0, 0]),
    ([1, 2, 3], [1, 4, 2], [1, 0, 2]),
    ([3, 1, 2], [4, 4, 1], [2, 2, 1])])
def test_train_step_over_assignments_matches_reference(models, engines,
                                                       assign):
    """The reference's three (cuts, rank_cut, smashed_choice)
    assignments over the buckets (none, int8, topk), one SGD step each
    from one state."""
    model_j, _, cad, sad = models
    params = _np(model_j.init_params(jax.random.PRNGKey(0)))
    state = _np(j_rounds.prepare_state(
        j_rounds.init_state(model_j, jax.random.PRNGKey(0), num_clients=3),
        rank_cut=2, smashed_choice=0))
    state.update(client_adapters=cad, server_adapters=sad,
                 **{k: np.asarray(v, np.int32) for k, v in
                    zip(("cuts", "rank_cut", "smashed_choice"), assign)})
    v = model_j.arch.model.vocab_size
    toks = np.random.default_rng(7).integers(3, v, (3, 2, 17))
    batch = {"tokens": toks[..., :-1].astype(np.int32),
             "labels": toks[..., 1:].astype(np.int32)}
    w, act, lr = np.ones(3, np.float32) / 3, np.ones(3, np.float32), 3e-3
    step_j, step_t = engines
    s_j, m_j = step_j(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
        jax.tree.map(jnp.asarray, batch), jnp.asarray(w), jnp.asarray(act),
        jnp.float32(lr), jnp.float32(lr))
    s_t, m_t = step_t(bridge.params_from_numpy(params, "cpu"),
                      bridge.state_from_numpy(state, "cpu"), batch, w, act,
                      lr, lr)
    s_j, s_t = _np(s_j), bridge.to_numpy(s_t)
    for side in ("client_adapters", "server_adapters"):
        _close_trees(s_t[side], s_j[side], rtol=1e-5, atol=1e-5)
    for k in ("rank_cut", "smashed_choice", "cuts"):
        same(s_t[k], s_j[k])
    np.testing.assert_allclose(float(m_t["total"]), float(m_j["total"]),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the system


def _system_arch(reduced, get_config):
    arch = small_arch(reduced, get_config, 6, d_model=64, vocab=512,
                      seq_len=64, batch=4)
    return arch.replace(train=dataclasses.replace(
        arch.train, lr_client=3e-3, lr_server=3e-3))


def _co_pair(**extra):
    kw = dict(SYS, **CO, **extra)
    j = j_system.SplitFTSystem(_system_arch(j_reduced, j_get_config),
                               j_system.SystemConfig(**kw), seed=0)
    t = t_system.SplitFTSystem(_system_arch(t_reduced, t_get_config),
                               t_system.SystemConfig(**kw), seed=0,
                               device="cpu")
    t.base_params = bridge.params_from_numpy(_np(j.base_params), "cpu")
    t.state = bridge.state_from_numpy(_np(j.state), "cpu")
    return j, t


@pytest.fixture(scope="module")
def co_runs():
    j, t = _co_pair()
    return j, t, j.run(5, log_every=0), t.run(5, log_every=0)


def test_co_system_decisions_are_the_reference(co_runs):
    """5 rounds: each round's policy and predicted time equal, the
    losses within 1e-6 relative, and each prediction equal to the next
    round's simulated time (jitter 0), as the reference pins it."""
    j, t, hj, ht = co_runs
    assert t.comp_buckets == j.comp_buckets
    moved = set()
    for a, b in zip(hj, ht):
        assert set(a) == set(b)
        for k in POLICY + ("comm", "round_time_sim", "sim_clock"):
            same(a[k], b[k])
        np.testing.assert_allclose(b["ce"], a["ce"], rtol=1e-6)
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-6)
        moved |= {k for k in POLICY[:4] if not np.array_equal(
            a[k], hj[0][k])}
    for prev, nxt in zip(ht[:-1], ht[1:]):
        same(prev["predicted_time"], nxt["round_time_sim"])
    assert moved, "the controller moved nothing in 5 rounds"


def test_co_system_stays_in_its_buckets(co_runs):
    _, t, _, ht = co_runs
    buckets = set(t.arch.split.buckets(6))
    for h in ht:
        assert set(h["cuts"].tolist()) <= buckets
        assert set(h["rank_cut"].tolist()) <= {1, 2, 4}
        assert set(h["smashed_choice"].tolist()) <= {0, 1, 2, 3}
        assert ((h["topk_frac"] >= 0.01) & (h["topk_frac"] <= 1.0)).all()


def test_co_checkpoint_keeps_the_policy_leaves(tmp_path):
    kw = dict(checkpoint_dir=str(tmp_path), checkpoint_every=2)
    _, first = _co_pair(**kw)
    first.run(2, log_every=0)
    _, resumed = _co_pair(**kw)
    assert resumed.restore()
    for k in ("rank_cut", "smashed_choice", "topk_frac", "cuts"):
        assert resumed.state[k].device.type == "cpu"
        same(resumed.state[k].numpy(), first.state[k].numpy())
    assert np.isfinite(resumed.run(1, log_every=0)[-1]["loss"])


def test_co_rejects_smashed_error_feedback():
    kw = dict(SYS, controller="co", smashed_compress="topk", smashed_ef=True)
    for pkg, reduced, get_config, dev in (
            (j_system, j_reduced, j_get_config, {}),
            (t_system, t_reduced, t_get_config, {"device": "cpu"})):
        with pytest.raises(ValueError, match="error feedback"):
            pkg.SplitFTSystem(_system_arch(reduced, get_config),
                              pkg.SystemConfig(**kw), seed=0, **dev)


def test_cli_controller_co_writes_the_reference_history(tmp_path):
    argv = ["--reduced", "--rounds", "2", "--samples", "64",
            "--controller", "co", "--rank-buckets", "2,4",
            "--compressor-buckets", "none,int8", "--straggler-sim",
            "--jitter-sigma", "0"]
    assert j_train.main(argv + ["--out", str(tmp_path / "j")]) == 0
    assert t_train.main(argv + ["--out", str(tmp_path / "t"),
                                "--device", "cpu"]) == 0
    rows = [[json.loads(line) for line in
             (tmp_path / d / "history.jsonl").read_text().splitlines()]
            for d in ("j", "t")]
    assert len(rows[1]) == 2
    for a, b in zip(*rows):
        assert set(a) == set(b) and "predicted_time" in b
        assert a["comm"] == b["comm"]
        assert a["rank_cut"] == b["rank_cut"]
