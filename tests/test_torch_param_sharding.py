"""Parameter sharding of the dense family's training round: tensor
parallelism over "model" and FSDP over "data", in 4 gloo processes
against the unsharded port and the unsharded JAX reference.

Placement: ``runtime.sharding.local_params`` gives each rank the block of
every base leaf that ``param_specs`` says.  On the meta device, for every
leaf of each dense config at full width on the (1, 4) and (2, 2) meshes,
a rank's block has 1/model of each dim split over "model" and 1/data of
each dim split over "data", by bytes; at reduced width the ranks' blocks,
put back by their mesh coordinates, are the full leaf bit for bit.

Training: one spawn per mesh (the module fixture), (1, 4) and (2, 2), in
which 4 ranks run every case of tests/torch_param_sharding_cases.py for 2
rounds of ``SplitFTSystem.run`` under a ``MeshShard`` from the JAX
reference's weights (projection biases drawn non-zero), and the unsharded
port runs the same cases.  Each float leaf of the gathered state after
each round is held within rtol 1e-5 and atol 1e-5 x max|leaf| of the
unsharded run's, the per-round losses within rtol 1e-6, every discrete
leaf and record equal.  The atol is 10x the client axis's
(tests/test_torch_sharded_engine.py): the row-parallel products, the
vocab-parallel cross entropy and the adapters' gradients over "model"
sum in another order, and the attention backward's cancellation carries
that into the q and k adapters' gradients, measured up to 3.3e-6 x
max|leaf| (the B of q and k after each round).  Summing a replicated
gradient over "model", dropping a partial one's sum or adding a
row-parallel bias before its sum moves a leaf by a share of its max.
The sharded losses also match the JAX reference's, run unsharded
(its own host-mesh sharding fails under this jax), as
tests/test_torch_system.py holds the port's.

Engine options: on the (2, 2) mesh, llama_gqa's model under the async
engine, two-tier FedAvg, top-k and int8 adapter compression, microbatch
2, population mode and the co-controller is held to the unsharded port
as above, top-k's error-feedback residual within 1.3e-4 x max|leaf|
(4x its measured gap; cases.OPTION_BOUNDS says why); their agreement
with the reference is the unsharded port's own
(tests/test_torch_engine_options.py and the rest).  Checkpoints: the first
round checkpointed on the (2, 2) mesh and finished in one unsharded
process, and the other way round, hold the unsharded run's second round
as above.

Init: ``Model.init_params(place=leaf_block)`` narrows each leaf to the
rank's block as soon as it is drawn: no full leaf drawn before is alive
when the next is drawn, so a rank's init peak is its blocks plus one
full leaf, and the blocks are ``local_params`` of the full tree bit for
bit.

Serving: after their rounds llama_gqa and opt_bias serve on every rank
(``serve_model``, a cache of the rank's blocks, a prefill and 5 greedy
decode steps whose positions cross a block edge of the KV sequence;
tests/torch_mesh_serving_cases.py): the tokens equal the unsharded
port's, the logits within 2e-4 (measured 2.9e-6 and 2.8e-7), each
rank's cache holds ``cache_specs``' blocks, and the unsharded port's
logits match the JAX reference's unsharded prefill and decode steps on
the same weights and adapters within 2e-5 (measured 4.9e-6 at most).

Refusals: a head count that the "model" axis does not divide, and a
prefill or decode step with a client axis (a cache of lead (N, B) runs
on one card, as the reference's), raise in every rank and name the
ROADMAP item; the MoE, SSM,
hybrid, audio and vlm configs build under both meshes, each rank holding
its blocks (tests/test_torch_param_sharding_families.py and
tests/test_torch_param_sharding_sp.py train them).

Time: ~75 s alone: ~45 s for the two spawns, ~25 s for the JAX
reference's 5 cases.
"""

import dataclasses
import functools
import types
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

import torch_param_sharding_cases as cases  # noqa: E402
from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import rounds as j_rounds  # noqa: E402
from repro.core import system as j_system  # noqa: E402
from repro_torch import roadmap  # noqa: E402
from repro_torch.config import MeshConfig, reduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import (make_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.launch.sharded import run_ranks  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402
from test_torch_mesh_serving import (cache_blocks_held,  # noqa: E402
                                     held_to_the_reference)
from test_torch_system import _losses_close  # noqa: E402
import torch_mesh_serving_cases as mesh_serving  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402

DENSE = ("gpt2-small", "opt-125m", "gpt-neo-125m", "llama3-8b",
         "phi4-mini-3.8b", "qwen1.5-32b", "mistral-large-123b")
MESHES = {k: make_mesh(*v) for k, v in cases.MESHES.items()}


class _Rank:
    """As much of a MeshShard as local_params reads."""

    def __init__(self, rank):
        self.rank = rank


# ---------------------------------------------------------------------------
# placement


@functools.lru_cache(maxsize=None)
def _meta_params(name):
    model = build_model(get_config(name), device="cpu")
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = model.init_params(torch.Generator().manual_seed(0))
    return sh.tree_map_with_path(
        lambda _, x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
        params)


def _axes(entry):
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", DENSE)
def test_each_rank_holds_its_share_by_bytes(name, mesh):
    """Each leaf's block on each rank: 1/model of a dim that param_specs
    splits over "model", 1/data of one it splits over "data", the rest
    whole; on the meta device, at full width."""
    m = MESHES[mesh]
    sizes = sh.axis_sizes(m)
    full = _meta_params(name)
    specs = dict(tree_leaves_with_path(sh.param_specs(full, m)))
    total = {}
    for r in range(m.num_devices):
        local = dict(tree_leaves_with_path(sh.local_params(full, m,
                                                           _Rank(r))))
        for keys, leaf in tree_leaves_with_path(full):
            share = 1
            for dim, entry in enumerate(specs[keys]):
                for a in _axes(entry):
                    share *= sizes[a]
            want = [n // int(np.prod([sizes[a] for a in _axes(e)]))
                    for n, e in zip(leaf.shape, specs[keys])]
            got = local[keys]
            assert list(got.shape) == want, (keys, r)
            nbytes = got.numel() * got.element_size()
            assert nbytes * share == leaf.numel() * leaf.element_size()
            total[r] = total.get(r, 0) + nbytes
    # every rank holds the same bytes
    assert len(set(total.values())) == 1
    if name == "llama3-8b":
        # by name: wq, wo, w_in, w_gate, w_out, tok and head split over
        # both axes, wk and wv over "data" only, the norms whole
        layer = {k[-1]: v for k, v in tree_leaves_with_path(
            sh.local_params(full, m, _Rank(0)))}
        whole = {k[-1]: v for k, v in tree_leaves_with_path(full)}
        for leaf, share in (("wq", 4), ("wo", 4), ("w_in", 4),
                            ("w_gate", 4), ("w_out", 4), ("tok", 4),
                            ("head", 4), ("scale", 1),
                            ("wk", sizes["data"]), ("wv", sizes["data"])):
            assert layer[leaf].numel() * share == whole[leaf].numel(), leaf


@pytest.mark.parametrize("mesh", list(MESHES))
def test_blocks_put_back_are_the_full_leaves(mesh):
    """At reduced width, with values: every rank's blocks written back at
    their mesh coordinates rebuild each base leaf bit for bit, and a
    dim that an axis does not divide is whole on every rank."""
    m = MESHES[mesh]
    sizes = sh.axis_sizes(m)
    for name in DENSE:
        arch = reduced(get_config(name), layers=2, d_model=64, vocab=510)
        params = build_model(arch, device="cpu").init_params(
            torch.Generator().manual_seed(0))
        specs = dict(tree_leaves_with_path(sh.param_specs(params, m)))
        rebuilt = {k: torch.full_like(x, float("nan"))
                   for k, x in tree_leaves_with_path(params)}
        for r in range(m.num_devices):
            coords = sh.mesh_coords(m, r)
            local = sh.local_params(params, m, _Rank(r))
            for keys, x in tree_leaves_with_path(local):
                view = rebuilt[keys]
                for dim, entry in enumerate(specs[keys]):
                    idx = 0
                    for a in _axes(entry):
                        idx = idx * sizes[a] + coords[a]
                    view = view.narrow(dim, idx * x.shape[dim],
                                       x.shape[dim])
                view.copy_(x)
        for keys, x in tree_leaves_with_path(params):
            assert torch.equal(rebuilt[keys], x), (name, keys)
        # vocab 510: 4 does not divide it, 2 does
        tok = specs[("embed", "tok")][0]
        assert tok == (None if sizes["model"] == 4 else "model"), name


def test_mesh_coords_are_row_major():
    m = make_mesh(2, 2)
    assert [sh.mesh_coords(m, r) for r in range(4)] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 1}]
    assert sh.axis_ranks(m, "data") == [[0, 2], [1, 3]]
    assert sh.axis_ranks(m, "model") == [[0, 1], [2, 3]]
    assert make_mesh(1, 4) == MeshConfig((1, 4), ("data", "model"))
    # the dry-run's four-card layout is one a MeshShard executes
    assert make_production_mesh(num_cards=4) == MESHES["1x4"]
    with pytest.raises(ValueError):
        make_mesh(0, 2)


# ---------------------------------------------------------------------------
# training on 4 gloo ranks


def _reference(name):
    """The JAX reference's system for a case, unsharded, with the cases'
    projection biases."""
    step_kw, sys_kw = cases.CASES[name][-2:]
    ref = j_system.SplitFTSystem(
        cases.case_arch(name, j_reduced, j_get_config),
        j_system.SystemConfig(**cases.SYS, **sys_kw), seed=0)
    if step_kw:
        ref.train_step = j_rounds.make_train_step(
            ref.model, smashed_compress=ref.smashed_compress, **step_kw)
    raw = jax.tree.map(np.asarray, ref.base_params)
    ref.base_params = jax.tree.map(jnp.asarray, cases.with_biases(raw))
    return ref, raw


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("param_sharding")
    hist = {}
    for name in cases.CASES:
        ref, raw = _reference(name)
        torch.save((raw, jax.tree.map(np.asarray, ref.state)),
                   out / f"ref_{name}.pt")
        hist[name] = ref.run(cases.ROUNDS, log_every=0)
    for mesh_name, mesh in MESHES.items():
        run_ranks(cases.rank_main, mesh, out / f"group_{mesh_name}",
                  args=(str(out), mesh_name))
    return out, hist


def _load(out, name):
    return torch.load(out / f"{name}.pt", weights_only=False)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(cases.CASES))
def test_sharded_case_matches_unsharded_and_the_reference(runs, name,
                                                          mesh):
    out, ref_hist = runs
    got = _load(out, f"sharded_{mesh}_{name}")
    cases.held(got, _load(out, f"plain_{name}"))
    _losses_close(ref_hist[name], got["history"])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", cases.SERVE_CASES)
def test_sharded_serving_matches_unsharded(runs, name, mesh):
    out, _ = runs
    want = _load(out, f"plain_{name}")["serve"]
    got = [_load(out, f"serve_{mesh}_{name}_{r}")
           for r in range(MESHES[mesh].num_devices)]
    for g in got:
        mesh_serving.held(g, want)
    arch = cases.case_arch(name)
    cache_blocks_held(got, want["cache"], MESHES[mesh], arch.model)


@pytest.mark.parametrize("name", cases.SERVE_CASES)
def test_unsharded_serving_matches_the_reference(runs, name):
    out, _ = runs
    held_to_the_reference(
        j_build_model(cases.case_arch(name, j_reduced, j_get_config)),
        cases.with_biases(_load(out, f"ref_{name}")[0]),
        _load(out, f"plain_{name}")["serve"])


@pytest.mark.parametrize("name", list(cases.OPTIONS))
def test_engine_option_under_a_2x2_mesh_matches_unsharded(runs, name):
    out, _ = runs
    cases.held(_load(out, f"sharded_{cases.OPTIONS_MESH}_{name}"),
               _load(out, f"plain_{name}"),
               bounds=cases.OPTION_BOUNDS.get(name))


@pytest.mark.parametrize("ckpt", ["ckpt_2x2_to_plain", "ckpt_plain_to_2x2"])
def test_checkpoint_restores_across_meshes(runs, ckpt):
    """A checkpoint holds the gathered state and no base weights: saved
    under the (2, 2) mesh it restores unsharded, and the other way
    round, and the second round is the unsharded run's."""
    out, _ = runs
    got, want = _load(out, ckpt), _load(out, "plain_llama_gqa")
    cases.held({"states": [got["state"]], "history": got["history"],
                "sim_clock": got["sim_clock"]},
               {"states": want["states"][1:],
                "history": want["history"][1:],
                "sim_clock": want["sim_clock"]})


@pytest.mark.parametrize("mesh", list(MESHES))
def test_init_draws_one_full_leaf_at_a_time(mesh):
    """init_params(place=leaf_block) on every rank: when a leaf is drawn,
    no full leaf drawn before it is alive (so the init peak is the rank's
    blocks plus one full leaf, several times less than the full tree
    here: 3.0 MB, blocks 0.85 MB and 0.79 MB, the largest leaf 0.52 MB),
    and the kept blocks are local_params of the full tree bit for bit."""
    m = MESHES[mesh]
    arch = reduced(get_config("llama3-8b"), layers=2, d_model=128,
                   vocab=1024)
    model = build_model(arch, device="cpu")
    full = model.init_params(torch.Generator().manual_seed(0))
    full_bytes = sum(x.numel() * x.element_size()
                     for _, x in tree_leaves_with_path(full))
    for r in range(m.num_devices):
        drawn = []

        def place(name, leaf):
            assert all(ref() is None for ref in drawn), name
            drawn.append(weakref.ref(leaf))
            return sh.leaf_block(name, leaf, mesh=m, rank=r)

        got = dict(tree_leaves_with_path(model.init_params(
            torch.Generator().manual_seed(0), place=place)))
        want = list(tree_leaves_with_path(sh.local_params(full, m,
                                                          _Rank(r))))
        assert len(drawn) == len(want)
        for keys, x in want:
            assert torch.equal(got[keys], x), keys
        kept = sum(x.numel() * x.element_size() for x in got.values())
        largest = max(x.numel() * x.element_size()
                      for _, x in tree_leaves_with_path(full))
        # blocks a third of the tree or less; blocks plus one full leaf
        # under half of it
        assert 3 * kept < full_bytes and 2 * (kept + largest) < full_bytes



@pytest.mark.parametrize("mesh", list(MESHES))
def test_system_ranks_hold_their_blocks(runs, mesh):
    """The base weights SplitFTSystem keeps on each rank: the same bytes
    on every rank, 1/4 of the full tree's split leaves in all."""
    out, _ = runs
    m = MESHES[mesh]
    full = build_model(cases.case_arch("llama_gqa"), device="cpu"
                       ).init_params(torch.Generator().manual_seed(0))
    specs = dict(tree_leaves_with_path(sh.param_specs(full, m)))
    got = [_load(out, f"bytes_{mesh}_{r}") for r in range(m.num_devices)]
    for keys, leaf in tree_leaves_with_path(full):
        share = int(np.prod([sh.axis_sizes(m)[a] for e in specs[keys]
                             for a in _axes(e)]))
        want = leaf.numel() * leaf.element_size() // share
        assert {g["/".join(keys)] for g in got} == {want}, keys


@pytest.mark.parametrize("mesh", list(MESHES))
def test_unsupported_configs_raise_with_the_roadmap_pointer(runs, mesh):
    out, _ = runs
    raised = _load(out, f"raised_{mesh}")
    assert set(raised) == set(cases.REFUSED)
    for label, kind in cases.REFUSED.items():
        got_kind, msg = raised[label]
        assert got_kind == kind, (label, raised[label])
        assert roadmap.PARAM_SHARDING in msg, label


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", cases.PLACED)
def test_moe_ssm_and_hybrid_configs_are_placed(runs, name, mesh):
    """The MoE, SSM, hybrid, audio and vlm configs that the mesh once
    refused build under it, each rank holding param_specs' blocks by
    bytes (tests/test_torch_param_sharding_families.py and
    tests/test_torch_param_sharding_sp.py train them)."""
    out, _ = runs
    m = MESHES[mesh]
    full = build_model(cases.placed_arch(name), device="cpu"
                       ).init_params(torch.Generator().manual_seed(0))
    specs = dict(tree_leaves_with_path(sh.param_specs(full, m)))
    got = [_load(out, f"placed_{mesh}_{r}")[name]
           for r in range(m.num_devices)]
    for keys, leaf in tree_leaves_with_path(full):
        share = int(np.prod([sh.axis_sizes(m)[a] for e in specs[keys]
                             for a in _axes(e)]))
        want = leaf.numel() * leaf.element_size() // share
        assert {g["/".join(keys)] for g in got} == {want}, keys


def test_policy_is_a_no_op_without_a_mesh_shard():
    """No shard, or a ClientShard (base weights whole): NO_SHARDING, which
    calls no collective, so the unsharded path is unchanged."""
    from repro_torch.models.common import NO_SHARDING, ShardingPolicy

    arch = get_config("llama3-8b")
    assert ShardingPolicy.for_model(None, arch) is NO_SHARDING

    class _Client:
        places_params = False
    assert ShardingPolicy.for_model(_Client(), arch) is NO_SHARDING
    assert NO_SHARDING.tp == NO_SHARDING.fsdp == 1
    assert NO_SHARDING.block(128, 128) is None
    p = {"wq": torch.zeros(3, 4)}
    assert NO_SHARDING.gather(p, 3) is p
    x = torch.zeros(2, requires_grad=True)
    assert NO_SHARDING.copy_to_tp(x) is x
    assert NO_SHARDING.reduce_from_tp(x) is x


def _own_part(tp, rank):
    """A ShardingPolicy of "model" rank `rank` of `tp` whose sums return
    this rank's own part: the test sums the parts itself."""
    from repro_torch.models.common import ShardingPolicy

    policy = ShardingPolicy(types.SimpleNamespace(
        model_size=tp, model_rank=rank, data_size=1, data_rank=0))
    policy.tp_sum = torch.clone
    return policy


@pytest.mark.parametrize("heads,kv,tp", [(12, 3, 2), (8, 2, 4), (12, 4, 2),
                                         (4, 4, 4)])
def test_attention_blocks_sum_to_the_whole(heads, kv, tp):
    """In one process: each "model" rank's block of the heads (its wq
    columns, wo rows and the KV heads its query heads read, which under
    12 heads over 3 KV heads on 2 ranks are no uniform GQA block), its
    row-parallel partial outputs summed over the ranks, is the whole
    attention sub-block."""
    from repro_torch.models import transformer

    hd, d = 4, 48
    arch = reduced(get_config("llama3-8b"), layers=1, d_model=d)
    cfg = dataclasses.replace(arch.model, num_heads=heads, num_kv_heads=kv,
                              head_dim=hd)
    gen = torch.Generator().manual_seed(0)
    p = {k: v[0] for k, v in transformer.init_attention(
        gen, cfg, 1, cross=False, dtype=torch.float32).items()
        if not isinstance(v, dict)}
    p["norm1"] = {"scale": torch.ones(d)}
    x = torch.randn(2, 5, d, generator=gen)
    want, _ = transformer.attention_apply(p, None, x, cfg=cfg, mode="train",
                                          causal=True, window=0)
    hl = heads * hd // tp
    got = 0
    for r in range(tp):
        block = dict(p, wq=p["wq"][:, r * hl:(r + 1) * hl],
                     wo=p["wo"][r * hl:(r + 1) * hl])
        part, _ = transformer.attention_apply(
            block, None, x, cfg=cfg, mode="train", causal=True, window=0,
            policy=_own_part(tp, r))
        got = got + part
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
