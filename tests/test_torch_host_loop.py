"""Bitwise pins of the port's host-loop layers against the JAX package.

The port keeps numpy copies of the reference's straggler clock
(runtime/straggler.py), heterogeneity traces (runtime/traces.py), time
model (runtime/timemodel.py), elastic pool (runtime/elastic.py) and round
schedulers (core/scheduler.py), because it imports nothing of the JAX
package.  Each copy must give exactly the reference's numbers on seeded
inputs.  The checkpoint store is a port of its own (JSON metadata, no
msgpack); its .npz trees load across the two packages in both
directions, bit for bit.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as j_store  # noqa: E402
from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import rounds as j_rounds  # noqa: E402
from repro.core import scheduler as j_sched  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.runtime import elastic as j_elastic  # noqa: E402
from repro.runtime import straggler as j_strag  # noqa: E402
from repro.runtime import timemodel as j_tm  # noqa: E402
from repro.runtime import traces as j_traces  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import store as t_store  # noqa: E402
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.runtime import elastic as t_elastic  # noqa: E402
from repro_torch.runtime import straggler as t_strag  # noqa: E402
from repro_torch.runtime import timemodel as t_tm  # noqa: E402
from repro_torch.runtime import traces as t_traces  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
N = 6
FULL_SPEC = ("diurnal:amp=0.8,period=900+markov:p_down=0.05,p_up=0.3"
             "+cells:k=4+thermal:floor=0.5")


def same(a, b):
    """Bitwise equality of numpy values (NaN == NaN, dtype included)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), (a, b)


def _phase_kw(rng, r=0, t=0.0):
    cuts = rng.integers(1, 6, N)
    return dict(cuts=cuts, flops_per_layer=1e9,
                smashed_bytes=rng.uniform(1e5, 1e6, N),
                smashed_down_bytes=rng.uniform(1e5, 1e6, N),
                adapter_bytes=rng.uniform(1e3, 1e5, N), round_idx=r,
                server_layers=8 - cuts, start_time=t)


def _speed_models(trace, **kw):
    j = j_strag.SpeedModel(N, seed=3, **kw)
    t = t_strag.SpeedModel(N, seed=3, **kw)
    if trace:
        j.trace = j_traces.make_trace_gen(trace, seed=5)
        t.trace = t_traces.make_trace_gen(trace, seed=5)
    return j, t


@pytest.mark.parametrize("jitter", [True, False])
@pytest.mark.parametrize("trace", [None, FULL_SPEC])
def test_speed_model_bitwise(jitter, trace):
    j, t = _speed_models(trace, server_flops_per_s=2e13,
                         server_ingest_bw=5e7)
    same(j.speed, t.speed)
    same(j.bandwidth, t.bandwidth)
    rng = np.random.default_rng(0)
    for r, clock in enumerate([0.0, 95.5, 1234.0, 7200.25]):
        kw = _phase_kw(rng, r, clock)
        same(j.phase_times(jitter=jitter, **kw),
             t.phase_times(jitter=jitter, **kw))
        same(j.available_mask(clock), t.available_mask(clock))
        for i in range(N):
            assert j.next_available(i, clock) == t.next_available(i, clock)


def test_step_time_helpers_bitwise():
    rng = np.random.default_rng(1)
    for _ in range(5):
        ph = rng.uniform(0.01, 2.0, (5, N))
        act = (rng.random(N) > 0.3).astype(np.float64)
        steps = rng.integers(1, 5, N)
        same(j_strag.serial_step_times(ph), t_strag.serial_step_times(ph))
        same(j_strag.pipelined_makespan(ph, steps),
             t_strag.pipelined_makespan(ph, steps))
        same(j_strag.overlap_step_budgets(ph, max_steps=4, active=act),
             t_strag.overlap_step_budgets(ph, max_steps=4, active=act))
        times = j_strag.serial_step_times(ph)
        same(j_strag.local_step_budgets(times, max_steps=4, active=act),
             t_strag.local_step_budgets(times, max_steps=4, active=act))
        sj, dj = j_strag.deadline_survivors(times, deadline_frac=1.2,
                                            active=act)
        st, dt = t_strag.deadline_survivors(times, deadline_frac=1.2,
                                            active=act)
        same(sj, st)
        assert dj == dt


@pytest.mark.parametrize("spec", ["const", "const:speed=0.5,bw=2",
                                  "diurnal:amp=0.8+markov", FULL_SPEC])
def test_trace_gen_bitwise(spec):
    j = j_traces.make_trace_gen(spec, seed=11)
    t = t_traces.make_trace_gen(spec, seed=11)
    pids = np.arange(9)
    for clock in np.linspace(0.0, 20000.0, 23):
        for a, b in zip(j.sample(clock, pids), t.sample(clock, pids)):
            same(a, b)
        assert j.window(clock) == t.window(clock)
        for p in (0, 4, 8):
            assert j.next_available(clock, p) == t.next_available(clock, p)
    assert j.state_dict() == t.state_dict()
    fresh = t_traces.make_trace_gen(spec, seed=11)
    fresh.load_state_dict(json.loads(json.dumps(j.state_dict())))
    assert fresh.state_dict() == j.state_dict()
    for a, b in zip(fresh.sample(20000.0, pids), j.sample(20000.0, pids)):
        same(a, b)


def test_file_trace_round_trip(tmp_path):
    rng = np.random.default_rng(2)
    raw = {"step": 30.0, "t0": 5.0,
           "speed": rng.uniform(0.5, 2, (7, 4)).tolist(),
           "bandwidth": rng.uniform(0.5, 2, 7).tolist(),
           "available": (rng.random((7, 4)) > 0.3).astype(int).tolist()}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(raw))
    j, t = j_traces.load_trace(str(path)), t_traces.load_trace(str(path))
    for clock in np.linspace(0.0, 600.0, 41):
        for a, b in zip(j.sample(clock, np.arange(6)),
                        t.sample(clock, np.arange(6))):
            same(a, b)
        assert j.next_available(clock, 1) == t.next_available(clock, 1)
    assert j.state_dict() == t.state_dict()


@pytest.mark.parametrize("source", ["analytic", "trace", "measured"])
def test_pricers_bitwise(source):
    j_clock, t_clock = _speed_models("diurnal:amp=0.8+markov")
    j_mod = j_strag.SpeedModel(N, seed=9)
    t_mod = t_strag.SpeedModel(N, seed=9)
    j_mod.trace, t_mod.trace = j_clock.trace, t_clock.trace
    jp = j_tm.make_pricer(source, j_clock, j_mod, ewma_alpha=0.4)
    tp = t_tm.make_pricer(source, t_clock, t_mod, ewma_alpha=0.4)
    jr, tr = j_tm.TraceRecorder(j_clock), t_tm.TraceRecorder(t_clock)
    rng = np.random.default_rng(3)
    for r in range(6):
        kw = _phase_kw(rng, r, 300.0 * r)
        same(jp.predict(**kw), tp.predict(**kw))
        obs = jp.charge(**kw)
        same(obs, tp.charge(**kw))
        mask = rng.random(N) > 0.2
        jp.observe(obs, mask, jp.model_baseline(**kw))
        tp.observe(obs, mask, tp.model_baseline(**kw))
        jr.observe(obs, jp.clock_baseline(**kw), mask, kw["start_time"])
        tr.observe(obs, tp.clock_baseline(**kw), mask, kw["start_time"])
        same(jp.predict(**kw), tp.predict(**kw))
    assert jp.state_dict() == tp.state_dict()
    assert jr.to_trace_dict() == tr.to_trace_dict()
    again = t_tm.make_pricer(source, t_clock, t_mod, ewma_alpha=0.4)
    again.load_state_dict(json.loads(json.dumps(tp.state_dict())))
    kw = _phase_kw(rng, 7, 2100.0)
    same(again.predict(**kw), jp.predict(**kw))


def _plans_equal(a, b):
    for f in ("active", "step_budgets", "times", "phases", "staleness"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
        else:
            same(x, y)
    assert a.sim_time == b.sim_time
    assert a.deadline == b.deadline
    assert a.buffer_fill == b.buffer_fill


@pytest.mark.parametrize("name,kw", [
    ("sync", {}), ("deadline", {"deadline_frac": 1.1}),
    ("local_steps", {"max_local_steps": 4}),
    ("local_steps", {"max_local_steps": 3, "overlap_comm": True})])
def test_barrier_schedulers_bitwise(name, kw):
    js = j_sched.make_scheduler(name, **kw)
    ts = t_sched.make_scheduler(name, **kw)
    assert (js.name, js.max_steps, js.needs_speed) == \
        (ts.name, ts.max_steps, ts.needs_speed)
    rng = np.random.default_rng(4)
    for r in range(8):
        ph = rng.uniform(0.01, 2.0, (5, N))
        times = j_strag.serial_step_times(ph)
        active = (rng.random(N) > 0.2).astype(np.float64)
        avail = (None if r % 2 else
                 (rng.random(N) > 0.3).astype(np.float64))
        _plans_equal(js.plan(active=active, times=times, phases=ph,
                             round_idx=r, available=avail),
                     ts.plan(active=active, times=times, phases=ph,
                             round_idx=r, available=avail))


def test_event_queue_and_async_state_bitwise():
    rng = np.random.default_rng(5)
    jq, tq = j_sched.EventQueue(), t_sched.EventQueue()
    phases = list(j_strag.PHASES) + [j_sched.PHASE_STEP]
    for k in range(40):
        key = (int(rng.integers(0, N)), phases[k % len(phases)], k // 7)
        at = float(np.round(rng.uniform(0, 5), 1))   # ties on purpose
        jq.push(key, at)
        tq.push(key, at)
    while len(jq):
        assert jq.pop_next() == tq.pop_next()
    assert len(tq) == 0
    ja = j_sched.make_scheduler("async", buffer_size=3, overlap_comm=True)
    ta = t_sched.make_scheduler("async", buffer_size=3, overlap_comm=True)
    ja.start(N, clock=2.5)
    ta.start(N, clock=2.5)
    for s in (ja, ta):
        s.queue.push((1, "f2_uplink", 0), 3.0)
        s.queue.push((4, j_sched.PHASE_STEP, 2), 3.0)
    assert json.dumps(ja.state_dict(), sort_keys=True) == \
        json.dumps(ta.state_dict(), sort_keys=True)


def test_client_pool_bitwise():
    jp, tp = j_elastic.ClientPool(5), t_elastic.ClientPool(5)
    counts = [40, 10, 25, 5, 20]
    for op, arg in (("leave", 1), ("leave", 3), ("join", None),
                    ("leave", 0), ("join", 0), ("join", None)):
        assert getattr(jp, op)(arg) == getattr(tp, op)(arg)
        same(jp.active, tp.active)
        assert jp.generation == tp.generation
        same(jp.weights(counts), tp.weights(counts))
        same(jp.active_ids(), tp.active_ids())
    with pytest.raises(RuntimeError, match="pool full"):
        tp.join()


# ---------------------------------------------------------------------------
# checkpoint store


def test_checkpoint_atomic_keep_last_k(tmp_path):
    mgr = t_store.CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, {"x": torch.full((3,), float(s))}, metadata={"s": s})
    assert mgr.steps() == [3, 4]
    names = sorted(os.listdir(tmp_path))
    assert names == ["ckpt_00000003.npz", "ckpt_00000003.npz.meta.json",
                     "ckpt_00000004.npz", "ckpt_00000004.npz.meta.json"]
    tree, meta, step = mgr.restore_latest({"x": torch.zeros(3)})
    assert step == 4 and meta == {"s": 4}
    np.testing.assert_array_equal(tree["x"], np.full(3, 4.0, np.float32))


def test_checkpoint_corruption_fallback(tmp_path):
    mgr = t_store.CheckpointManager(str(tmp_path), keep=3)
    tree = {"x": torch.arange(4.0)}
    mgr.save(1, tree)
    mgr.save(2, {"x": tree["x"] + 1})
    (tmp_path / "ckpt_00000002.npz").write_bytes(b"garbage")
    restored, _, step = mgr.restore_latest(tree)
    assert step == 1
    np.testing.assert_array_equal(restored["x"], np.arange(4.0,
                                                           dtype=np.float32))
    # a structurally different template loads nothing
    assert mgr.restore_latest({"x": tree["x"], "y": tree["x"]}) is None


def _engine_state():
    arch = j_reduced(j_get_config("gpt2-small"), layers=3, d_model=32,
                     vocab=128, seq_len=16, batch=2)
    state = j_rounds.init_state(j_build_model(arch), jax.random.PRNGKey(4),
                                num_clients=3)
    rng = np.random.default_rng(6)
    # non-zero, distinct leaves, so that a mis-ordered leaf would show
    state = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, state)
    state["cuts"] = jnp.asarray([1, 2, 3], jnp.int32)
    state["round"] = jnp.asarray(7, jnp.int32)
    return state


def _assert_trees_bitwise(got, want):
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        same(np.asarray(g.cpu() if isinstance(g, torch.Tensor) else g),
             np.asarray(w))


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    j_state = _engine_state()
    path = str(tmp_path / "ref.npz")
    j_store.save_checkpoint(path, j_state, metadata={"round": 7})
    template = bridge.state_from_numpy(
        jax.tree.map(lambda a: np.zeros_like(np.asarray(a)), j_state), "cpu")
    tree, meta = t_store.load_checkpoint(path, template)
    assert meta == {}       # the reference's sidecar is msgpack: not read
    state = bridge.state_from_numpy(tree, "cpu")
    _assert_trees_bitwise(state, j_state)
    assert state["cuts"].dtype == torch.int32
    assert state["cuts"].device.type == "cpu"


def test_port_checkpoint_loads_into_the_reference(tmp_path):
    j_state = _engine_state()
    t_state = bridge.state_from_numpy(jax.tree.map(np.asarray, j_state),
                                      "cpu")
    path = str(tmp_path / "port.npz")
    t_store.save_checkpoint(path, t_state, metadata={"round": 7})
    like = jax.tree.map(jnp.zeros_like, j_state)
    tree, meta = j_store.load_checkpoint(path, like)
    assert meta == {}       # the port's sidecar is JSON: not read
    _assert_trees_bitwise(t_state, tree)
    _, t_meta = t_store.load_checkpoint(path, t_state)
    assert t_meta == {"round": 7}


# ---------------------------------------------------------------------------
# the package's hygiene


def test_port_imports_no_msgpack():
    bad = re.compile(r"^\s*(import msgpack|from msgpack)", re.MULTILINE)
    sources = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    assert not [p for p in sources if bad.search(p.read_text())]
    code = ("import sys, repro_torch.core.system, repro_torch.launch.train, "
            "repro_torch.launch.quickstart; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'msgpack')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_roadmap_pointers_name_queue_a_titles():
    from repro_torch import roadmap
    text = (REPO / "ROADMAP.md").read_text()
    queue_a = text.split("### Queue A", 1)[1].split("### Queue B", 1)[0]
    pointers = {k: v for k, v in vars(roadmap).items()
                if k.isupper() and isinstance(v, str)}
    assert pointers
    for name, ptr in pointers.items():
        title = re.fullmatch(r'ROADMAP\.md Queue A, "(.+)"', ptr).group(1)
        assert re.search(rf"^\d+\. \*\*{re.escape(title)}\.?\*\*", queue_a,
                         re.MULTILINE), (name, title)
    # every other mention goes through those constants: no item numbers
    stale = re.compile(r"Queue A|item \d")
    offenders = [str(p.relative_to(REPO))
                 for p in (REPO / "src" / "repro_torch").rglob("*.py")
                 if p.name != "roadmap.py" and stale.search(p.read_text())]
    assert not offenders, offenders
