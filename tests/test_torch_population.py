"""Population mode of the port (cohort sampling, the per-pid
PopulationStore, the client-axis table, the cohort hooks of both host
loops, population checkpoints and serving) against the JAX package's, on
the CPU.

Size: the reference's population tests' (tests/test_population.py) —
gpt2-small reduced to 4 layers, d_model 64, vocab 512, seq 32, batch 2;
a cohort of C = 3 from a population of P = 12; 80 samples, 16 for eval;
torch on one thread.  System checks start both packages from the
reference's weights and state (``repro_torch.bridge``).

Tolerances: the sampler's pids, the store's slot rows, cursors, C3
weights and speed draws, the cohort of every round, everything on the
simulated clock and comm bytes are numpy or copies of equal inputs on
both sides and must be equal bit for bit; losses within rtol 1e-4 in
rounds 0-1 and 1e-3 after (AdamW, see tests/test_torch_system.py).
The reference's host-mesh sharding pin (tests/test_population.py:314)
fails under the installed jax and has no counterpart here.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import store as j_ckpt  # noqa: E402
from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import rounds as j_rounds  # noqa: E402
from repro.core import system as j_system  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.runtime import population as j_pop  # noqa: E402
from repro.runtime import serving as j_serving  # noqa: E402
from repro.runtime import sharding as j_sharding  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import store as t_ckpt  # noqa: E402
from repro_torch.config import reduced as t_reduced  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import system as t_system  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.runtime import population as t_pop  # noqa: E402
from repro_torch.runtime import serving as t_serving  # noqa: E402
from repro_torch.runtime import sharding as t_sharding  # noqa: E402
from repro_torch.runtime import straggler as t_straggler  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path  # noqa: E402

SMALL = dict(layers=4, d_model=64, vocab=512, seq_len=32, batch=2)
DATA = dict(num_samples=80, eval_samples=16)
P = 12
ROUNDS = 3


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


def same_tree(got, want):
    """A port tree (tensors or numpy) equal bit for bit to a reference
    tree, leaf for leaf in the same order."""
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        same(g.numpy() if isinstance(g, torch.Tensor) else g, w)


def _arch(reduced, get_config):
    return reduced(get_config("gpt2-small"), **SMALL)


def _store_pair(**prepare):
    """A reference store and the port's over the same prepared state."""
    model = j_build_model(_arch(j_reduced, j_get_config))
    state = j_rounds.prepare_state(
        j_rounds.init_state(model, jax.random.PRNGKey(0), num_clients=3),
        **prepare)
    t_state = bridge.state_from_numpy(_np(state), "cpu")
    return (state, j_pop.PopulationStore(10, state, seed=0),
            t_state, t_pop.PopulationStore(10, t_state, seed=0))


# ---------------------------------------------------------------------------
# the client-axis table


@pytest.mark.parametrize("prepare", [{}, dict(max_local_steps=2,
                                              async_buffer=True,
                                              edge_groups=2)],
                         ids=["sync", "local_steps,async,edges"])
def test_client_axis_table_follows_the_reference(prepare):
    """Every leaf path of the state in the reference's order, with the
    reference's client axis (opt_c/count: global as a scalar, axis 0 as
    the per-client (N,) count)."""
    state, _, t_state, _ = _store_pair(**prepare)
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    want = [(j_sharding._path_keys(p), j_sharding.state_client_axis(
        j_sharding._path_keys(p), np.ndim(x))) for p, x in flat]
    got = [(keys, t_sharding.state_client_axis(keys, leaf.dim()))
           for keys, leaf in tree_leaves_with_path(t_state)]
    assert got == want
    count = dict(got)[("opt_c", "count")]
    assert count == (0 if prepare else None)


# ---------------------------------------------------------------------------
# CohortSampler


@pytest.mark.parametrize("pop,cohort", [(5, 5), (10, 3), (12, 3),
                                        (1000, 5)],
                         ids=["P=C", "choice", "rejection-12",
                              "rejection-1000"])
def test_sampler_draws_the_reference_pids(pop, cohort):
    for seed in (0, 3):
        j = j_pop.CohortSampler(pop, cohort, seed=seed)
        t = t_pop.CohortSampler(pop, cohort, seed=seed)
        for _ in range(6):
            same(t.sample(), j.sample())
        assert t.state_dict() == j.state_dict()


def test_sampler_resumes_from_a_reference_state():
    j = j_pop.CohortSampler(100, 8, seed=3)
    for _ in range(3):
        j.sample()
    t = t_pop.CohortSampler(100, 8, seed=0)     # another seed: state wins
    t.load_state_dict(j.state_dict())
    for _ in range(4):
        same(t.sample(), j.sample())
    full = t_pop.CohortSampler(5, 5, seed=1)
    before = full.state_dict()
    same(full.sample(), np.arange(5))
    assert full.state_dict() == before          # no RNG consumed


def test_sampler_mismatch_raises():
    s = t_pop.CohortSampler(100, 8, seed=0)
    with pytest.raises(ValueError, match="population"):
        t_pop.CohortSampler(200, 8, seed=0).load_state_dict(s.state_dict())
    with pytest.raises(ValueError, match="cohort"):
        t_pop.CohortSampler(100, 4, seed=0).load_state_dict(s.state_dict())


# ---------------------------------------------------------------------------
# PopulationStore


def _bump(tree, how):
    return jax.tree.map(how, tree)


def test_store_follows_the_reference_bitwise():
    """The same gathers, scatters, cursors and C3 weights on both stores:
    every gathered state and the final state_tree equal bit for bit."""
    state, j, t_state, t = _store_pair()
    same_tree(t.gather(t_state, np.arange(3)), state)   # identity
    for pids, how, cur in (
            ([1, 4, 7], lambda x: x + (1 if np.issubdtype(
                np.asarray(x).dtype, np.integer) else 0.5), [3, 3, 3]),
            ([2, 3, 6], lambda x: x * 0 + 7, [5, 6, 7])):
        jg = _bump(_np(j.gather(state, pids)), how)
        tg = t.gather(t_state, pids)
        tg = bridge.state_from_numpy(_bump(bridge.to_numpy(tg), how), "cpu")
        same_tree(tg, jg)
        j.scatter(jg, pids, cursors=cur, c3_weights=[0.5, 1.0, 2.0])
        t.scatter(tg, pids, cursors=cur, c3_weights=[0.5, 1.0, 2.0])
    for pids in ([1, 4, 7], [0, 5, 9], [2, 3, 6]):
        same_tree(t.gather(t_state, pids), _np(j.gather(state, pids)))
        same(t.cursors(pids), j.cursors(pids))
        same(t.c3_weights(pids), j.c3_weights(pids))
        for a, b in zip(t.speed_draws(pids), j.speed_draws(pids)):
            same(a, b)
    assert len(t) == len(j) == 9
    same_tree(t.state_tree(), _np(j.state_tree()))


def test_scatter_keeps_out_of_cohort_slots_and_copies():
    _, _, state, store = _store_pair()
    outside = np.array([0, 5, 9])
    before = bridge.to_numpy(store.gather(state, outside))
    inside = np.array([2, 3, 6])
    st = store.gather(state, inside)
    st = bridge.state_from_numpy(
        _bump(bridge.to_numpy(st), lambda x: x * 0 + 7), "cpu")
    store.scatter(st, inside, cursors=[1, 1, 1])
    after = store.gather(state, outside)
    same_tree(after, before)
    # gather hands out fresh tensors and scatter keeps copies: in-place
    # updates of the engine's tensors reach no slot
    kept = jax.tree.map(np.array, store.state_tree())
    for leaf in tree_leaves(st) + tree_leaves(after):
        leaf.add_(1)
    same_tree(store.state_tree(), kept)
    same(store.cursors(inside), np.ones(3, np.int64))


def test_store_rejects_wrong_cohort_size():
    _, _, state, store = _store_pair()
    with pytest.raises(ValueError, match="client axis"):
        store.gather(state, np.arange(5))


def test_state_tree_round_trips_and_loads_the_reference(tmp_path):
    """load_state_tree restores the reference's tree (and one from before
    the jitter seeds); a fresh store, K = 0, is the donor template of a
    K-slot checkpoint."""
    state, j, t_state, _ = _store_pair()
    st = j.gather(state, [1, 4, 7])
    j.scatter(st, [1, 4, 7], cursors=[2, 2, 2])
    j.gather(state, [0, 8, 11])
    want = _np(j.state_tree())
    t = t_pop.PopulationStore(10, t_state, seed=0)
    t.load_state_tree(want)
    same_tree(t.state_tree(), want)
    old = {k: v for k, v in want.items() if k != "jseed"}
    t.load_state_tree(old)
    same(t.state_tree()["jseed"], want["jseed"])
    path = str(tmp_path / "pop.npz")
    t_ckpt.save_checkpoint(path, t.state_tree())
    empty = t_pop.PopulationStore(10, t_state, seed=0)
    assert len(empty) == 0
    tree, _ = t_ckpt.load_checkpoint(path, empty.state_tree())
    empty.load_state_tree(tree)
    same_tree(empty.state_tree(), want)


def test_pid_keyed_jitter_survives_cohort_shuffle():
    """Per-round jitter belongs to the pid, not to the slot it landed
    in: a shuffled cohort of the same pids charges each pid the same
    phase times, bit for bit, and the reference's."""
    from repro.runtime import straggler as j_straggler

    def phases(lib, pids, keyed=True):
        sm = lib.SpeedModel(num_clients=len(pids), seed=0)
        sp, bw, js = lib.population_speed_draws(pids, seed=0)
        sm.speed, sm.bandwidth = sp, bw
        if keyed:
            sm.jitter_seeds = np.asarray(js, np.int64)
        return sm.phase_times(cuts=[2] * len(pids), flops_per_layer=1e9,
                              smashed_bytes=1e6,
                              adapter_bytes=[1e5] * len(pids), round_idx=3)

    pids, perm = [5, 6, 7], [2, 0, 1]
    shuffled = [pids[j] for j in perm]
    a, b = phases(t_straggler, pids), phases(t_straggler, shuffled)
    same(a, phases(j_straggler, pids))
    for k in range(3):
        same(b[:, k], a[:, perm[k]])
    a_pos = phases(t_straggler, pids, keyed=False)
    b_pos = phases(t_straggler, shuffled, keyed=False)
    assert any(not np.array_equal(b_pos[:, k], a_pos[:, perm[k]])
               for k in range(3))


# ---------------------------------------------------------------------------
# SplitFTSystem in population mode against the reference


def _port(sys_kw, init=None):
    """The port's system; with `init` = (base params, initial state) of a
    reference system as numpy, starting from those."""
    t = t_system.SplitFTSystem(_arch(t_reduced, t_get_config),
                               t_system.SystemConfig(**DATA, **sys_kw),
                               seed=0, device="cpu")
    if init is not None:
        t.base_params = bridge.params_from_numpy(init[0], "cpu")
        t.state = bridge.state_from_numpy(init[1], "cpu")
        if t.store is not None:
            # fresh slots come from that initial state too
            t.store = t_pop.PopulationStore(
                t.population, t.state, seed=0,
                speed_sigma=t.store.speed_sigma, bw_mean=t.store.bw_mean,
                bw_sigma=t.store.bw_sigma)
    return t


def _reference(sys_kw):
    return j_system.SplitFTSystem(_arch(j_reduced, j_get_config),
                                  j_system.SystemConfig(**DATA, **sys_kw),
                                  seed=0)


def _run(system, rounds):
    """Run `rounds` rounds; returns the records and each round's cohort."""
    pids = []
    hist = system.run(rounds, log_every=0, callback=lambda rec: pids.append(
        system._cohort_pids.copy()))
    return hist[-rounds:], pids


POP_SYS = {
    "deadline": dict(population=P, straggler_sim=True),
    "async": dict(population=P, scheduler="async", buffer_size=2,
                  straggler_sim=True),
}


@pytest.fixture(scope="module", params=list(POP_SYS))
def pop_pair(request, tmp_path_factory):
    """The reference and the port over ROUNDS rounds from the reference's
    weights; the reference checkpoints after round 2."""
    ckpt = str(tmp_path_factory.mktemp("ref_ckpt"))
    kw = POP_SYS[request.param]
    j = _reference(dict(kw, checkpoint_dir=ckpt, checkpoint_every=2))
    init = (_np(j.base_params), _np(j.state))
    t = _port(kw, init)
    return request.param, kw, ckpt, init, (j,) + _run(j, ROUNDS), \
        (t,) + _run(t, ROUNDS)


def test_system_follows_the_reference(pop_pair):
    """Each round's cohort, the cursors, the simulated clock, comm bytes
    and the whole record (async: staleness, fills, the event simulation)
    bit for bit; losses within the file's tolerances; more slots than
    one cohort."""
    name, _, _, _, (j, hj, pj), (t, ht, pt) = pop_pair
    assert len(ht) == ROUNDS and len(pt) == ROUNDS
    for a, b in zip(pj, pt):
        same(b, a)
    assert len({tuple(p) for p in pt}) > 1
    for r, (a, b) in enumerate(zip(hj, ht)):
        assert set(a) == set(b)
        for k in set(a) - {"loss", "ce", "accuracy", "eval_ce",
                           "eval_accuracy", "weights"}:
            same(a[k], b[k])
        rtol = 1e-4 if r < 2 else 1e-3
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=rtol)
        np.testing.assert_allclose(b["eval_ce"], a["eval_ce"], rtol=1e-3)
    assert j.sim_clock == t.sim_clock
    assert len(t.store) == len(j.store) > 3
    pids = sorted(j.store._slots)
    same(t.store.cursors(pids), j.store.cursors(pids))
    if name == "async":
        assert j.scheduler.state_dict() == t.scheduler.state_dict()


def test_reference_population_checkpoint_restores_in_the_port(pop_pair):
    """The reference's checkpoint after round 2 (its msgpack sidecar
    rewritten as the port's JSON one) restores in the port: the store and
    the engine state bit for bit; the next round draws the reference's
    next cohort, and its record (clock, comm bytes; async: the restarted
    event pipeline) equals a restored reference's."""
    name, kw, ckpt, init, (j, hj, pj), _ = pop_pair
    mgr = j_ckpt.CheckpointManager(ckpt)
    step = mgr.steps()[-1]
    assert step == 2
    meta = mgr.metadata(step)
    with open(mgr._path(step) + t_ckpt.META_SUFFIX, "w") as f:
        json.dump({"metadata": meta}, f)
    kw = dict(kw, checkpoint_dir=ckpt)
    t = _port(kw, init)
    assert t.restore()
    like = {"engine": j.state, "pop": j.store.state_tree()}
    tree, _ = j_ckpt.load_checkpoint(mgr._path(step), _np(like))
    same_tree({"engine": t.state, "pop": t.store.state_tree()}, tree)
    j2 = _reference(kw)
    assert j2.restore()
    (a,), (want,) = _run(j2, 1)
    (b,), (pids,) = _run(t, 1)
    same(pids, want)
    same(pids, pj[2])
    for k in set(a) - {"loss", "ce", "accuracy", "eval_ce",
                       "eval_accuracy", "weights"}:
        same(a[k], b[k])
    np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-3)
    if name == "deadline":         # a barrier resume is the straight run
        same(b["sim_clock"], hj[2]["sim_clock"])


def test_pool_from_population_follows_the_reference(pop_pair):
    _, kw, _, init, (j, _, _), _ = pop_pair
    t = _port(kw, init)
    t.state = bridge.state_from_numpy(_np(j.state), "cpu")
    t.store.load_state_tree(_np(j.store.state_tree()))
    pids = sorted(j.store._slots)[:2]
    want = j_serving.pool_from_population(j.model, j.state, j.store, pids)
    got = t_serving.pool_from_population(t.model, t.state, t.store, pids)
    same_tree(got, want)
    assert t_serving.num_pool_adapters(got) == 2
    with pytest.raises(ValueError, match="client axis"):
        t_serving.pool_from_population(t.model, t.state, t.store,
                                       range(4))


# ---------------------------------------------------------------------------
# the port's own pins


def _digest(state):
    return [leaf.numpy().tobytes() for leaf in tree_leaves(state)]


def test_population_equal_to_cohort_is_fleet_mode_bitwise():
    fleet = _port({})
    h_fleet = fleet.run(ROUNDS, log_every=0)
    pop = _port(dict(population=fleet.arch.data.num_clients))
    h_pop = pop.run(ROUNDS, log_every=0)
    assert [r["loss"] for r in h_fleet] == [r["loss"] for r in h_pop]
    for a, b in zip(h_fleet, h_pop):
        same(a["cuts"], b["cuts"])
    assert _digest(fleet.state) == _digest(pop.state)


def test_population_resume_is_bitwise(tmp_path):
    kw = dict(population=P, straggler_sim=True)
    straight = _port(kw)
    h_all, p_all = _run(straight, 4)
    ckpt = dict(kw, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    _port(ckpt).run(2, log_every=0)
    resumed = _port(ckpt)
    assert resumed.restore()
    h, p = _run(resumed, 2)
    for a, b in zip(p_all[2:], p):
        same(a, b)
    for a, b in zip(h_all[2:], h):
        assert a["loss"] == b["loss"] and a["sim_clock"] == b["sim_clock"]
    assert _digest(straight.store.state_tree()["rows"]) == \
        _digest(resumed.store.state_tree()["rows"])
    same(straight.store.state_tree()["cursors"],
         resumed.store.state_tree()["cursors"])


def test_population_mismatch_raises_loudly(tmp_path):
    kw = dict(checkpoint_dir=str(tmp_path), checkpoint_every=2)
    _port(dict(kw, population=P)).run(2, log_every=0)
    with pytest.raises(ValueError, match="population"):
        _port(dict(kw, population=2 * P)).restore()
    with pytest.raises(ValueError, match="population"):
        _port(kw).restore()


def test_population_below_the_cohort_raises():
    with pytest.raises(ValueError, match="cohort"):
        _port(dict(population=2))


def test_cli_trains_and_serves_a_population(tmp_path, capsys):
    out = tmp_path / "run"
    assert t_train.main(["--reduced", "--rounds", "2", "--samples", "64",
                         "--population", "10", "--cohort-size", "2",
                         "--out", str(out), "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in
            (out / "history.jsonl").read_text().splitlines()]
    assert len(rows) == 2 and all(len(r["ce"]) == 2 for r in rows)
    cfg = t_serve.checkpoint_config(str(out / "ckpt"))
    assert (cfg["population"], cfg["cohort"]) == (10, 2)
    assert t_serve.main(["--reduced", "--adapters", "2", "--requests", "4",
                         "--num-slots", "2", "--prompt-len", "8", "--gen",
                         "4", "--ckpt", str(out / "ckpt"),
                         "--device", "cpu"]) == 0
    assert "served 4 requests x 4 tokens over 2 adapters" in \
        capsys.readouterr().out
    with pytest.raises(ValueError, match="client axis"):
        t_serve.main(["--reduced", "--adapters", "3", "--requests", "3",
                      "--ckpt", str(out / "ckpt"), "--device", "cpu"])
