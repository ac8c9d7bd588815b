"""The port's SplitFTSystem, train CLI and quickstart against the JAX
package's, on the CPU.

Size: the quickstart's (examples/quickstart.py) — gpt2-small reduced to
6 layers, d_model 64, vocab 2048, seq 64, batch 4; 5 clients on a
length-Dirichlet partition (alpha 0.9) of 400 samples, 64 eval samples;
AdamW at lr 3e-3.  Both systems start from the reference's weights and
round state (``repro_torch.bridge``), since a torch.Generator and a JAX
key draw different numbers from one seed.

Tolerances: the per-round loss within rtol 1e-4 in rounds 0-1 and 1e-3
after (AdamW's first steps normalise each gradient element, so an element
whose gradient is tiny next to the largest still moves by up to lr; the
adapters drift apart by up to lr / 50 a step, tests/test_torch_rounds.py),
the eval cross entropy within rtol 1e-3.  Comm bytes and everything on
the simulated clock are numpy on both sides and must be equal bit for
bit.  Eval accuracies come in quanta of 1/256 and the accuracy rule's
dead band is 0.002, so one argmax that flips between the packages moves a
cut: cuts are compared round by round only while every earlier round's
eval accuracies are equal.
"""

import dataclasses
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import system as j_system  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import reduced as t_reduced  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import system as t_system  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402

ROUNDS = 6
DATA = dict(num_samples=400, eval_samples=64)
CLOCK = dict(straggler_sim=True, trace_gen="diurnal:amp=0.8+markov",
             adaptive=False)
CLOCK_KEYS = ("active", "round_time_sim", "sim_time", "sim_clock",
              "phase_times")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU steps at this size are many small ops: torch's
    intra-op threads only add contention when the suite runs several
    workers at once, so this module runs them on one thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _arch(reduced, get_config, **split):
    arch = reduced(get_config("gpt2-small"), layers=6, d_model=64,
                   vocab=2048, seq_len=64, batch=4)
    return arch.replace(
        train=dataclasses.replace(arch.train, lr_client=3e-3,
                                  lr_server=3e-3),
        data=dataclasses.replace(arch.data, partition="dirichlet",
                                 alpha=0.9, num_clients=5),
        split=dataclasses.replace(arch.split, **split))


def _port(sys_kw=None, *, like=None, **split):
    """The port's system at the quickstart's size on the CPU; with
    `like`, starting from that reference system's weights and state (in
    population mode, its store's fresh slots too)."""
    t = t_system.SplitFTSystem(
        _arch(t_reduced, t_get_config, **split),
        t_system.SystemConfig(**DATA, **(sys_kw or {})), seed=0,
        device="cpu")
    if like is not None:
        t.base_params = bridge.params_from_numpy(
            jax.tree.map(np.asarray, like.base_params), "cpu")
        t.state = bridge.state_from_numpy(
            jax.tree.map(np.asarray, like.state), "cpu")
        if t.store is not None:
            t.store = type(t.store)(
                t.population, t.state, seed=0,
                speed_sigma=t.store.speed_sigma, bw_mean=t.store.bw_mean,
                bw_sigma=t.store.bw_sigma)
    return t


def _pair(sys_kw=None, **split):
    j = j_system.SplitFTSystem(
        _arch(j_reduced, j_get_config, **split),
        j_system.SystemConfig(**DATA, **(sys_kw or {})), seed=0)
    return j, _port(sys_kw, like=j, **split)


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
    assert a.tobytes() == b.tobytes(), (a, b)


def _losses_close(hj, ht):
    for r, (a, b) in enumerate(zip(hj, ht)):
        rtol = 1e-4 if r < 2 else 1e-3
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=rtol,
                                   err_msg=f"round {r} loss")
        np.testing.assert_allclose(b["ce"], a["ce"], rtol=rtol,
                                   err_msg=f"round {r} ce")
        if "eval_ce" in a:
            np.testing.assert_allclose(b["eval_ce"], a["eval_ce"],
                                       rtol=1e-3, err_msg=f"round {r}")


@pytest.fixture(scope="module")
def quickstart_pair():
    j, t = _pair()
    return j.run(ROUNDS, log_every=0), t.run(ROUNDS, log_every=0)


def test_system_losses_match_the_reference(quickstart_pair):
    hj, ht = quickstart_pair
    assert len(hj) == len(ht) == ROUNDS
    _losses_close(hj, ht)
    for rec in ht:
        assert all(not isinstance(v, torch.Tensor) for v in rec.values())
        assert set(rec) == set(hj[rec["round"]])


def test_system_comm_bytes_are_the_reference(quickstart_pair):
    for a, b in zip(*quickstart_pair):
        for k in ("comm", "comm_smashed", "smashed_ratio"):
            same(a[k], b[k])


def test_system_cut_trajectory_is_the_reference(quickstart_pair):
    hj, ht = quickstart_pair
    compared = moved = 0
    for r, (a, b) in enumerate(zip(hj, ht)):
        same(a["cuts"], b["cuts"])
        compared += 1
        if not np.array_equal(a["eval_accuracy"], b["eval_accuracy"]):
            break                  # the next round's cuts may differ
        same(a["weights"], b["weights"])
        moved += r + 1 < len(hj) and \
            not np.array_equal(a["cuts"], hj[r + 1]["cuts"])
    assert compared >= 3, compared
    assert moved, "no cut moved in the compared rounds"


def test_without_adaptive_cuts_stay_fixed():
    t = _port({"adaptive": False})
    hist = t.run(3, log_every=0)
    for rec in hist:
        same(rec["cuts"], np.full(5, 3, np.int32))
        assert "eval_accuracy" not in rec


def test_simulated_clock_is_the_reference_bitwise(tmp_path):
    kw = dict(CLOCK, time_source="measured")
    j, t = _pair(dict(kw, record_trace=str(tmp_path / "j.json")))
    t.sys.record_trace = str(tmp_path / "t.json")
    hj, ht = j.run(4, log_every=0), t.run(4, log_every=0)
    assert any(r["active"].min() == 0 for r in hj), "no client dropped"
    for a, b in zip(hj, ht):
        for k in CLOCK_KEYS:
            same(a[k], b[k])
    _losses_close(hj, ht)
    assert j.sim_clock == t.sim_clock
    assert j.pricer.state_dict() == t.pricer.state_dict()
    for cuts in ([1, 2, 3, 4, 5], [3] * 5):
        same(j.predict_round_times(4, cuts), t.predict_round_times(4, cuts))
    assert json.loads((tmp_path / "j.json").read_text()) == \
        json.loads((tmp_path / "t.json").read_text())


def test_elastic_leave_join():
    t = _port({"adaptive": False})
    t.run(1, log_every=0)
    t.pool.leave(1)
    h = t.run(1, log_every=0)
    assert h[-1]["active"].tolist() == [1.0, 0.0, 1.0, 1.0, 1.0]
    assert h[-1]["comm_smashed"][1] == 0.0
    t.pool.join(1)
    h = t.run(1, log_every=0)
    assert h[-1]["active"].tolist() == [1.0] * 5
    assert np.isfinite(h[-1]["loss"])


def _resume_cfg(d):
    return dict(CLOCK, adaptive=True, time_source="measured",
                checkpoint_dir=str(d), checkpoint_every=3)


def test_checkpoint_resume_is_bitwise(tmp_path):
    straight = _port(dict(CLOCK, adaptive=True, time_source="measured"))
    h_all = straight.run(ROUNDS, log_every=0)

    first = _port(_resume_cfg(tmp_path))
    first.run(3, log_every=0)
    resumed = _port(_resume_cfg(tmp_path))
    assert resumed.restore()
    assert int(resumed.state["round"]) == 3
    assert resumed.state["cuts"].dtype == torch.int32
    h = resumed.run(ROUNDS - 3, log_every=0)
    assert [r["round"] for r in h] == [3, 4, 5]
    for a, b in zip(h_all[3:], h):
        assert set(a) == set(b)
        for k in a:
            same(a[k], b[k])
    assert resumed.sim_clock == straight.sim_clock


def test_restore_refuses_a_changed_state_template(tmp_path):
    t = _port(_resume_cfg(tmp_path))
    assert not t.restore()                   # nothing saved yet
    state = dict(t.state, step_budgets=torch.ones(5, dtype=torch.int32))
    t.ckpt.save(3, state, metadata={"scheduler": t.scheduler.name,
                                    "state_keys": sorted(state)})
    with pytest.raises(ValueError, match="state template"):
        t.restore()


def test_restore_refuses_weights_drawn_elsewhere(tmp_path):
    """A checkpoint records the device type its base weights were drawn
    on (SplitFTSystem's draw_on_device); one seed gives other weights on
    another, so a run that draws them elsewhere refuses to restore it.
    On the CPU, draw_on_device draws the host's weights."""
    from repro_torch.tree import tree_leaves

    t = _port(_resume_cfg(tmp_path))
    t.save(1)
    meta = t.ckpt.metadata(1)
    assert meta["weights_drawn_on"] == "cpu"
    here = t_system.SplitFTSystem(t.arch, t.sys, seed=0, device="cpu",
                                  draw_on_device=True)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(t.base_params), tree_leaves(here.base_params)))
    assert here.restore()
    t.ckpt.save(2, t.state, metadata=dict(meta, weights_drawn_on="cuda"))
    with pytest.raises(ValueError, match="drawn on cuda"):
        here.restore()


def test_serve_model_gives_the_global_adapters():
    t = _port({"adaptive": False})
    t.run(1, log_every=0)
    params, eff = t.serve_model()
    assert params is t.base_params
    leaf = eff["dec"]["q"]["A"]
    assert leaf.shape[0] == 6 and torch.isfinite(leaf).all()


def test_entry_point_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_system.SplitFTSystem(_arch(t_reduced, t_get_config),
                               t_system.SystemConfig(**DATA))


# the options the port once refused: each now builds the reference's state
# template and runs two rounds from the reference's weights, with the
# reference's records (the clock, comm bytes and budgets bit for bit)
LIFTED = [{"compress": "topk"}, {"compress": "int8"}, {"agg_every": 2},
          {"smashed_compress": "topk"},
          {"smashed_ef": True, "smashed_compress": "topk"},
          {"edge_groups": 2}, {"max_local_steps": 2},
          {"scheduler": "local_steps"}, {"scheduler": "async"},
          {"population": 10}]


@pytest.mark.parametrize("kw", LIFTED, ids=[",".join(k) for k in LIFTED])
def test_lifted_options_follow_the_reference(kw):
    j, t = _pair(dict(kw, adaptive=False, straggler_sim=True))
    assert sorted(t.state) == sorted(j.state)
    assert t.scheduler.name == j.scheduler.name
    hj, ht = j.run(2, log_every=0), t.run(2, log_every=0)
    for a, b in zip(hj, ht):
        assert set(a) == set(b)
        for k in set(a) - {"loss", "ce", "accuracy"}:
            same(a[k], b[k])
    _losses_close(hj, ht)


# options this list used to refuse: each now does what the reference's
# does, a ValueError or a system of the same template
CO_OPTIONS = [{"controller": "co"}, {"continuous_topk": True},
              {"rank_buckets": (1, 2)},
              {"compressor_buckets": ("none", "int8")}]


@pytest.mark.parametrize("kw", CO_OPTIONS,
                         ids=[",".join(k) for k in CO_OPTIONS])
def test_co_options_follow_the_reference(kw):
    def build(pkg, reduced, get_config, **dev):
        return pkg.SplitFTSystem(_arch(reduced, get_config),
                                 pkg.SystemConfig(**DATA, **kw), **dev)

    try:
        j = build(j_system, j_reduced, j_get_config)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e)[:40])):
            build(t_system, t_reduced, t_get_config, device="cpu")
        return
    t = build(t_system, t_reduced, t_get_config, device="cpu")
    assert sorted(t.state) == sorted(j.state)
    assert (t.rank_buckets, t.comp_buckets) == (j.rank_buckets,
                                                j.comp_buckets)
    assert (t.speed is None) == (j.speed is None)


def test_supported_smashed_compressors_run():
    for comp in ("int8", "fp8", "topk"):
        kw = {"smashed_compress": comp, "adaptive": False}
        if comp == "topk":
            kw["smashed_ef"] = False
        hist = _port(kw).run(1, log_every=0)
        assert np.isfinite(hist[0]["loss"])
        assert hist[0]["smashed_ratio"].min() > 1.0


# ---------------------------------------------------------------------------
# the train CLI and the quickstart


def _option_strings(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_cli_has_every_reference_flag_and_device():
    ref = _option_strings(j_train.build_parser())
    port = _option_strings(t_train.build_parser())
    assert ref <= port
    assert port - ref == {"--device", "--remat", "--draw-on-device"}


def _history(path):
    return [json.loads(line) for line in
            (path / "history.jsonl").read_text().splitlines()]


def test_cli_writes_the_reference_history(tmp_path):
    argv = ["--reduced", "--rounds", "2", "--samples", "64"]
    assert j_train.main(argv + ["--out", str(tmp_path / "j")]) == 0
    assert t_train.main(argv + ["--out", str(tmp_path / "t"),
                                "--device", "cpu"]) == 0
    hj, ht = _history(tmp_path / "j"), _history(tmp_path / "t")
    assert len(ht) == 2
    assert [set(r) for r in ht] == [set(r) for r in hj]
    assert all(np.isfinite(r["loss"]) for r in ht)
    for a, b in zip(hj, ht):
        assert a["comm"] == b["comm"]
    final = json.loads((tmp_path / "t" / "final.json").read_text())
    assert set(final) == {"ce", "perplexity", "accuracy"}
    # a second call resumes from the checkpoint of the first
    assert t_train.main(argv + ["--out", str(tmp_path / "t"),
                                "--device", "cpu"]) == 0
    assert [r["round"] for r in _history(tmp_path / "t")] == [0, 1, 2, 3]


CLI_FLAGS = [["--compress", "topk"], ["--scheduler", "async"],
             ["--edge-groups", "2"], ["--population", "10"]]


@pytest.mark.parametrize("flags", CLI_FLAGS,
                         ids=[f[0][2:] for f in CLI_FLAGS])
def test_cli_unported_flags_raise(tmp_path, flags):
    """The flags the port once refused, population mode's included, run
    the CLI as the reference's does: the same history rows, keys and comm
    bytes."""
    argv = ["--reduced", "--rounds", "2", "--samples", "64"] + flags
    assert j_train.main(argv + ["--out", str(tmp_path / "j")]) == 0
    assert t_train.main(argv + ["--out", str(tmp_path / "t"),
                                "--device", "cpu"]) == 0
    hj, ht = _history(tmp_path / "j"), _history(tmp_path / "t")
    assert [set(r) for r in ht] == [set(r) for r in hj]
    for a, b in zip(hj, ht):
        assert a["comm"] == b["comm"]
        assert np.isfinite(b["loss"])


def test_quickstart_runs_on_the_cpu(capsys):
    assert quickstart.main(["--rounds", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "final: perplexity=" in out and "cut trajectory" in out
