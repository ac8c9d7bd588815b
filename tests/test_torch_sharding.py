"""The port's sharding rules against the reference's, and the rank layer
in one process.

Specs: for each of the 13 configs at full width, the parameter tree, the
adapters (client-stacked and not), a batch with and without its client
axis, a decode cache and a round state that carries every client-axis
leaf are built abstractly by each package (the reference with
``jax.eval_shape``, the port on fake tensors as launch/cells.py does),
and every spec table of ``runtime/sharding.py`` must equal the
reference's leaf for leaf on five meshes, each ``PartitionSpec`` read as
a tuple.  Nothing is computed and no collective runs.

Rank layer: ``shard_state`` slices exactly the leaves that
``state_specs`` puts on "data"; a mesh with a "model" or "pod" axis
raises; and at world size 1 (one gloo process, in this process) the
sharded system is the unsharded one bit for bit, in every engine case of
tests/test_torch_sharded_engine.py.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from hypothesis_compat import given, settings, st  # noqa: E402
import torch_sharded_cases as cases  # noqa: E402

from repro.config import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.core import lora as j_lora  # noqa: E402
from repro.core import rounds as j_rounds  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.runtime import sharding as j_sh  # noqa: E402
from repro_torch import roadmap  # noqa: E402
from repro_torch.config import SHAPES, MeshConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import lora as t_lora  # noqa: E402
from repro_torch.core import rounds as t_rounds  # noqa: E402
from repro_torch.launch import cells  # noqa: E402
from repro_torch.launch.mesh import (make_client_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.launch.sharded import process_group  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402
from repro_torch.tree import tree_leaves_with_path, tree_map  # noqa: E402

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 4, "model": 1}, {"data": 1, "model": 4},
          {"data": 2, "model": 2}]
N_CLIENTS = 16
CACHE_LEAD, CACHE_LEN = 32, 4096


class FakeMesh:
    """What the reference's rules read of a mesh: its axis sizes."""

    def __init__(self, shape):
        self.shape = shape


def _port_mesh(m) -> MeshConfig:
    return MeshConfig(shape=tuple(m.values()), axes=tuple(m))


def _ref_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(str(getattr(p, "key", getattr(p, "idx", "?")))
                  for p in path): tuple(spec) for path, spec in flat}


def _port_specs(tree):
    return dict(tree_leaves_with_path(tree))


def _ref_trees(name):
    arch = j_get_config(name)
    model = j_build_model(arch)
    key = jax.random.PRNGKey(0)

    def state(k):
        s = j_rounds.init_state(model, k, num_clients=N_CLIENTS)
        s = j_rounds.with_error_feedback(s)
        s = j_rounds.prepare_state(s, max_local_steps=2, async_buffer=True,
                                   rank_cut=4, smashed_choice=0,
                                   topk_frac=0.1, edge_groups=2)
        return j_rounds.with_smashed_ef(s, model)

    ev = jax.eval_shape
    return {
        "params": ev(model.init_params, key),
        "client_adapters": ev(lambda k: j_lora.init_adapters(
            model, k, num_clients=N_CLIENTS), key),
        "server_adapters": ev(lambda k: j_lora.init_adapters(model, k),
                              key),
        "batch_client": model.input_specs(J_SHAPES["train_4k"],
                                          num_clients=N_CLIENTS),
        "batch": model.input_specs(J_SHAPES["prefill_32k"]),
        "cache": ev(lambda: model.init_cache((CACHE_LEAD,), CACHE_LEN)),
        "state": ev(state, key),
    }


def _port_trees(name):
    arch = get_config(name)
    model = build_model(arch, device="cpu")
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    gen = torch.Generator().manual_seed(0)

    def fake(specs):
        return {k: torch.empty(s, dtype=d) for k, (s, d) in specs.items()}

    state = cells._train_state(mode, model, N_CLIENTS, 2, True)
    with mode:
        state = t_rounds.with_error_feedback(state)
        state = t_rounds.with_smashed_ef(state, model)
        return {
            "params": model.init_params(gen),
            "client_adapters": t_lora.init_adapters(
                model, gen, num_clients=N_CLIENTS),
            "server_adapters": t_lora.init_adapters(model, gen),
            "batch_client": fake(model.input_specs(
                SHAPES["train_4k"], num_clients=N_CLIENTS)),
            "batch": fake(model.input_specs(SHAPES["prefill_32k"])),
            "cache": model.init_cache((CACHE_LEAD,), CACHE_LEN),
            "state": t_rounds.prepare_state(
                state, rank_cut=4, smashed_choice=0, topk_frac=0.1,
                edge_groups=2),
        }


@functools.lru_cache(maxsize=1)
def _trees(name):
    return _ref_trees(name), _port_trees(name)


def _tables(rules, trees, mesh):
    return {
        "param_specs": rules.param_specs(trees["params"], mesh),
        "adapter_specs(client_stacked)": rules.adapter_specs(
            trees["client_adapters"], mesh, client_stacked=True),
        "adapter_specs": rules.adapter_specs(
            trees["server_adapters"], mesh, client_stacked=False),
        "batch_specs(client_dim)": rules.batch_specs(
            trees["batch_client"], mesh, client_dim=True),
        "batch_specs": rules.batch_specs(trees["batch"], mesh,
                                         client_dim=False),
        "cache_specs": rules.cache_specs(trees["cache"], mesh),
        "state_specs": rules.state_specs(trees["state"], mesh),
    }


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    f"{k}{v}" for k, v in m.items()))
@pytest.mark.parametrize("name", list_configs())
def test_spec_tables_equal_the_reference(name, mesh):
    ref_trees, port_trees = _trees(name)
    want = _tables(j_sh, ref_trees, FakeMesh(mesh))
    got = _tables(sh, port_trees, _port_mesh(mesh))
    for table in want:
        w, g = _ref_specs(want[table]), _port_specs(got[table])
        assert g == w, (name, table)
    # the cohort of 16 divides every mesh's "data" axis
    assert _port_specs(got["state_specs"])[("cuts",)] == ("data",)


# ---------------------------------------------------------------------------
# fit_spec


_AXES = ("pod", "data", "model")


def _draw_case(rng):
    sizes = {a: int(rng.choice([1, 2, 3, 4, 16]))
             for a in _AXES if rng.random() < 0.8}
    nd = int(rng.integers(0, 5))
    shape = tuple(int(rng.choice([1, 2, 3, 6, 8, 12, 32, 48, 1500]))
                  for _ in range(nd))
    spec = []
    for _ in range(int(rng.integers(0, nd + 2))):
        r = rng.random()
        if r < 0.3:
            spec.append(None)
        elif r < 0.7:
            spec.append(str(rng.choice(_AXES + ("absent",))))
        else:
            k = int(rng.integers(1, 4))
            spec.append(tuple(str(a) for a in rng.choice(
                _AXES + ("absent",), size=k, replace=False)))
    return shape, tuple(spec), sizes


def _fit_agrees(shape, spec, sizes):
    want = tuple(j_sh.fit_spec(shape, spec, FakeMesh(sizes)))
    assert sh.fit_spec(shape, spec, sizes) == want
    if sizes:
        assert sh.fit_spec(shape, spec, _port_mesh(sizes)) == want


@pytest.mark.parametrize("seed", range(4))
def test_fit_spec_equals_the_reference_on_seeded_draws(seed):
    rng = np.random.default_rng(seed)
    for _ in range(250):
        _fit_agrees(*_draw_case(rng))


@settings(max_examples=200, deadline=None)
@given(st.integers(0, 2 ** 32 - 1))
def test_fit_spec_equals_the_reference_property(seed):
    _fit_agrees(*_draw_case(np.random.default_rng(seed)))


# ---------------------------------------------------------------------------
# layouts and the rank layer


def test_client_mesh_layout():
    assert make_client_mesh(4) == MeshConfig((4, 1), ("data", "model"))
    assert make_client_mesh().shape == (1, 1)
    # the dry-run's layout does not move
    assert make_production_mesh(num_cards=4) == MeshConfig(
        (1, 4), ("data", "model"))
    with pytest.raises(ValueError):
        make_client_mesh(0)


@pytest.mark.parametrize("shape,axes", [((2, 2), ("data", "model")),
                                        ((2, 2, 1), ("pod", "data",
                                                     "model"))])
def test_param_sharding_meshes_raise(shape, axes):
    with pytest.raises(NotImplementedError) as e:
        sh.ClientShard(MeshConfig(shape, axes))
    assert roadmap.PARAM_SHARDING in str(e.value)


def test_mesh_shard_defaults_to_the_card(monkeypatch):
    """Without a device a MeshShard (and a ClientShard) takes the card, as
    every entry point of the port does: where there is none it raises,
    and the CPU runs only when named.  The mesh is checked first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for shard in (sh.MeshShard, sh.ClientShard):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            shard(MeshConfig((1, 1), ("data", "model")))
    with pytest.raises(NotImplementedError):
        sh.ClientShard(MeshConfig((2, 2), ("data", "model")))


class _Rank:
    """Rank 2 of 4, as much of a ClientShard as slicing reads."""
    mesh = make_client_mesh(4)
    rank, world = 2, 4


def _state(n):
    model = build_model(cases.small_arch(n), device="cpu")
    state = t_rounds.init_state(model, torch.Generator().manual_seed(0),
                                num_clients=n)
    state = t_rounds.with_error_feedback(state)
    return t_rounds.prepare_state(state, max_local_steps=2,
                                  async_buffer=True, rank_cut=4,
                                  smashed_choice=0, topk_frac=0.1,
                                  edge_groups=2)


@pytest.mark.parametrize("n", [8, 6])
def test_shard_state_slices_what_state_specs_puts_on_data(n):
    state = _state(n)
    cohort = sh.Cohort(_Rank(), n)
    assert cohort.split == (n % 4 == 0)
    got = dict(tree_leaves_with_path(sh.shard_state(state, cohort)))
    specs = dict(tree_leaves_with_path(sh.state_specs(state,
                                                      _Rank.mesh)))
    sliced = 0
    for keys, leaf in tree_leaves_with_path(state):
        if "data" in specs[keys]:
            ax = specs[keys].index("data")
            assert torch.equal(got[keys], leaf.narrow(ax, 4, 2)), keys
            sliced += 1
        else:
            assert got[keys] is leaf, keys
    assert sliced == (0 if n % 4 else
                      sum(sh.state_client_axis(k, x.dim()) is not None
                          for k, x in tree_leaves_with_path(state)))
    # idempotent: the engines call it on entry
    again = sh.shard_state(sh.shard_state(state, cohort), cohort)
    for keys, leaf in tree_leaves_with_path(again):
        assert torch.equal(leaf, got[keys])


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """This process as the one rank of a gloo group."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with process_group(0, 1, tmp_path_factory.mktemp("pg")):
        yield sh.ClientShard(make_client_mesh(1), device="cpu")
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", list(cases.CASES))
def test_world_size_one_is_the_unsharded_run_bit_for_bit(name, one_rank,
                                                         tmp_path):
    _, got = cases.run_case(name, one_rank, tmp_path)
    _, want = cases.run_case(name, None, tmp_path)
    cases.same_bits(got, want)


def test_collectives_at_world_size_one(one_rank):
    c = sh.cohort_of(one_rank, 3)
    assert c.active and not c.split and (c.lo, c.n_local) == (0, 3)
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    calls, nbytes = one_rank.collectives, one_rank.bytes_reduced
    assert torch.equal(c.sum(x), x) and torch.equal(c.max(x), x)
    # one collective per dtype, the tensors packed flat
    got = c.sum_many([x, x[0], x.to(torch.int32)])
    assert all(torch.equal(a, b) for a, b in zip(got, [x, x[0], x.int()]))
    assert one_rank.collectives - calls == 4
    # sum, max, then 15 + 5 floats and 15 int32s
    assert one_rank.bytes_reduced - nbytes == 4 * (15 + 15 + 20 + 15)
    assert torch.equal(c.gather_rows(x), x)
    # a dict of partial sums: one collective, the keys kept
    calls = one_rank.collectives
    got = c.sum_dict({"a": x, ("b", 1): x[0]})
    assert list(got) == ["a", ("b", 1)] and one_rank.collectives - calls == 1
    assert torch.equal(got["a"], x) and torch.equal(got["b", 1], x[0])
    assert sh.UNSHARDED.sum_dict({"a": x})["a"] is x
    one_rank.check_agree("a test", np.arange(3))


def test_agreement_outliers_by_leaf_path():
    """An `outliers` entry that names a leaf's path covers that leaf
    alone, and takes precedence over its top-level key's."""
    from repro_torch.runtime import agreement

    rng = np.random.default_rng(1)
    y = {"client_adapters": {"q": {"B": rng.standard_normal(1000)
                                   .astype(np.float32)},
                             "v": {"B": rng.standard_normal(1000)
                                   .astype(np.float32)}}}
    x = tree_map(np.copy, y)
    x["client_adapters"]["q"]["B"][3] += 0.5
    kw = dict(rtol=1e-5, atol_of_max=1e-6)
    agreement.check_state(x, y, **kw,
                          outliers={"client_adapters/q/B": 1e-3})
    with pytest.raises(agreement.Mismatch, match="client_adapters/q/B"):
        agreement.check_state(x, y, **kw,
                              outliers={"client_adapters/v/B": 1e-3})
    with pytest.raises(agreement.Mismatch, match="client_adapters/q/B"):
        agreement.check_state(x, y, **kw,
                              outliers={"client_adapters": 1e-3,
                                        "client_adapters/q/B": 0.0})
    x["client_adapters"]["v"]["B"][5] += 0.5
    with pytest.raises(agreement.Mismatch, match="1 leaves out of bounds: "
                       "client_adapters/v/B"):
        agreement.check_state(x, y, **kw,
                              outliers={"client_adapters/q/B": 1e-3})


def test_agreement_bounds_outliers_and_bits():
    """runtime.agreement, which the sharded tests and chip_smoke.py's
    phase 16 hold runs with: per-key bounds, a share of outlying
    elements, exact discrete leaves, and bit-for-bit results."""
    from repro_torch.runtime import agreement

    rng = np.random.default_rng(0)
    y = {"client_adapters": {"A": rng.standard_normal(1000)
                             .astype(np.float32)},
         "cuts": np.array([1, 2], np.int32)}
    x = tree_map(np.copy, y)
    x["client_adapters"]["A"][7] += 0.5              # one element off
    kw = dict(rtol=1e-5, atol_of_max=1e-6)
    with pytest.raises(agreement.Mismatch, match="1.000e-03 of its"):
        agreement.check_state(x, y, **kw)
    gaps = agreement.check_state(x, y, **kw,
                                 outliers={"client_adapters": 1e-3})
    share = 0.5 / np.abs(y["client_adapters"]["A"]).max()
    assert gaps == {"client_adapters": (pytest.approx(share, rel=1e-6),
                                        1e-3)}
    agreement.check_state(x, y, **kw, bounds={"client_adapters": 1.0})
    x["cuts"] = np.array([1, 3], np.int32)
    with pytest.raises(agreement.Mismatch, match="cuts differs"):
        agreement.check_state(x, y, **kw, bounds={"client_adapters": 1.0})
    agreement.same_bits({"s": [y], "h": [{"loss": 1.0}]},
                        {"s": [y], "h": [{"loss": 1.0}]})
    with pytest.raises(agreement.Mismatch, match="/h\\[0\\]/loss"):
        agreement.same_bits({"h": [{"loss": np.nextafter(1.0, 2.0)}]},
                            {"h": [{"loss": 1.0}]})
    hist = [{"round": 0, "loss": 2.0, "cuts": np.array([1])}]
    assert agreement.check_history(
        [dict(hist[0], loss=2.0 * (1 + 5e-7))], hist,
        loss_rtol=1e-6) == pytest.approx(5e-7)
    with pytest.raises(agreement.Mismatch, match="round 0 cuts"):
        agreement.check_history([dict(hist[0], cuts=np.array([2]))], hist,
                                loss_rtol=1e-6)
