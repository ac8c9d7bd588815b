"""Parameter sharding, part 3, of the training round: the audio and vlm
families under tensor parallelism, sequence parallelism (the reference's
``seq_shard``) and the "pod" axis, in 4 gloo processes against the
unsharded port and the unsharded JAX reference.

Placement: for whisper-medium and internvl2-76b at full width on the
meta device, and for gpt2-small and kimi-k2 on the ("pod", "data",
"model") meshes, a rank's block has 1/size of each dim for the axes
``param_specs`` splits it over; at reduced width the ranks' blocks, put
back at the index pod_index * data + data_index of the FSDP axes that
``fit_spec`` kept, are the full leaves bit for bit.

Training: two spawns of 4 ranks (the module fixture), each running the
cases of tests/torch_param_sharding_sp_cases.py for 2 rounds of
``SplitFTSystem.run`` under a ``MeshShard`` of each of its meshes from
the JAX reference's weights, and the unsharded port the same cases:
  * (1, 4) and (2, 2): whisper-medium (frames fed, cut in the encoder,
    a vocabulary that no axis divides) and internvl2-76b (a prefix) at
    the reference's default (SP on); a dense, an MoE, the audio, the vlm
    and a hybrid case (SP forced on) with ``seq_shard`` on and off on
    (1, 4), which agree (losses rtol 1e-6, state within the unsharded
    tolerance; measured bit for bit but whisper's losses, whose CE sums
    run on the sequence block); seq 30, which 4 does not divide;
  * (2, 1, 2) and (2, 2, 1): gpt2 with int8 at the cut at batch 2 and
    at batch 3 (which "pod" does not divide), and an MoE whose experts'
    ff dim only "pod" divides; on (2, 1, 2) also gpt2 with top-k and its
    error feedback at the cut (the residual whole on every rank).
Every run is held to the unsharded run, the cases the reference runs to
its losses too; every MoE layer's choices and drops (gathered over
"pod" and "data") to the unsharded run's; the sequence lengths the
attention blocks were handed show the stream split (SP) or whole.

Serving: after their rounds whisper (its frames fed; the cross cache
split over "model", 16 frames into blocks of 4 and 8), internvl2 (its
prefix fed; the prefill under SP where seq_shard is on) and gpt2_int8
(the batch rows over "pod") serve on every rank of their runs
(tests/torch_mesh_serving_cases.py): the tokens equal the unsharded
port's, the logits within 2e-4 (measured 4.5e-6; whisper 2.0e-6 and
2.1e-6 on (1, 4) and (2, 2); gpt2_int8 4.2e-5 from the port's own
weights, whose trained adapters carry the int8 codes' flips), each
rank's cache holds ``cache_specs``' blocks (with "xseq_lo", the cross
block's first position), and the unsharded port's logits match the JAX
reference's within 2e-5 (measured 4.9e-6 at most; whisper 2.6e-6).

Time: ~50-65 s alone: ~30 s for the two spawns, ~20 s for the JAX
reference's 4 cases, the rest the placement at full width on fake
tensors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_param_sharding_sp_cases as cases  # noqa: E402
from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import system as j_system  # noqa: E402
from repro_torch.config import MeshConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.sharded import run_ranks  # noqa: E402
from repro_torch.models.common import ShardingPolicy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402
from test_torch_mesh_serving import (cache_blocks_held,  # noqa: E402
                                     held_to_the_reference)
import torch_mesh_serving_cases as mesh_serving  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from test_torch_param_sharding import _axes, _meta_params, _Rank  # noqa: E402
from test_torch_system import _losses_close  # noqa: E402

MESHES = {name: MeshConfig(shape, axes)
          for group in cases.GROUPS.values()
          for name, (shape, axes, _) in group.items()}
RUNS = [(mesh, name, sp) for group in cases.GROUPS.values()
        for mesh, (_, _, runs) in group.items() for name, sp in runs]


def _run_id(run):
    mesh, name, sp = run
    return f"{mesh}-{name}-{cases.sp_tag(sp)}"


# ---------------------------------------------------------------------------
# placement


def _share_by_bytes(full, m):
    sizes = sh.axis_sizes(m)
    specs = dict(tree_leaves_with_path(sh.param_specs(full, m)))
    total = {}
    for r in range(m.num_devices):
        local = dict(tree_leaves_with_path(sh.local_params(full, m,
                                                           _Rank(r))))
        for keys, leaf in tree_leaves_with_path(full):
            share = int(np.prod([sizes[a] for e in specs[keys]
                                 for a in _axes(e)]))
            want = [n // int(np.prod([sizes[a] for a in _axes(e)]))
                    for n, e in zip(leaf.shape, specs[keys])]
            got = local[keys]
            assert list(got.shape) == want, (keys, r)
            nbytes = got.numel() * got.element_size()
            assert nbytes * share == leaf.numel() * leaf.element_size()
            total[r] = total.get(r, 0) + nbytes
    assert len(set(total.values())) == 1
    return specs


@pytest.mark.parametrize("mesh", ["1x4", "2x2", "2x1x2", "2x2x1"])
@pytest.mark.parametrize("name", ["whisper-medium", "internvl2-76b"])
def test_audio_and_vlm_ranks_hold_their_share_by_bytes(name, mesh):
    """At full width on the meta device: 1/size of each dim for the axes
    param_specs splits it over; whisper's vocabulary (51865) stays whole
    on "model", its frames' positions and the encoder's norm whole;
    internvl2's KV projections whole on "model"."""
    m = MESHES[mesh]
    specs = {"/".join(k): v for k, v in
             _share_by_bytes(_meta_params(name), m).items()}
    sizes = sh.axis_sizes(m)
    tp = ("model",) * (sizes["model"] > 1)

    def split(entry):
        return tuple(a for a in _axes(entry) if sizes[a] > 1)
    if name == "whisper-medium":
        assert split(specs["embed/tok"][0]) == ()
        assert specs["embed/enc_pos"] == (None, None)
        assert all(e is None for e in specs["enc_norm/scale"])
        assert split(specs["dec/xwq"][-1]) == tp
        assert specs["dec/xwk"][-1] is None
    else:
        assert specs["dec/wk"][-1] is None
        assert split(specs["embed/tok"][0]) == tp


@pytest.mark.parametrize("mesh", ["2x1x2", "2x2x1"])
@pytest.mark.parametrize("name", ["gpt2_int8", "kimi_pod"])
def test_blocks_on_a_pod_mesh_put_back_are_the_full_leaves(name, mesh):
    """Each rank's blocks, put back at their index on the axes fit_spec
    kept (pod_index * data + data_index where it keeps both; kimi_pod's
    ff dim of 130 over "pod" alone on (2, 2, 1)), are the full leaves."""
    m = MESHES[mesh]
    sizes = sh.axis_sizes(m)
    params = build_model(cases.case_arch(name), device="cpu").init_params(
        torch.Generator().manual_seed(0))
    specs = dict(tree_leaves_with_path(sh.param_specs(params, m)))
    if name == "kimi_pod" and mesh == "2x2x1":
        assert specs[("dec", "we_in")][-1] == "pod"
        assert specs[("dec", "wq")][-2] == ("pod", "data")
    rebuilt = {k: torch.full_like(x, float("nan"))
               for k, x in tree_leaves_with_path(params)}
    for r in range(m.num_devices):
        coords = sh.mesh_coords(m, r)
        for keys, x in tree_leaves_with_path(sh.local_params(params, m,
                                                             _Rank(r))):
            view = rebuilt[keys]
            for dim, entry in enumerate(specs[keys]):
                idx = 0
                for a in _axes(entry):
                    idx = idx * sizes[a] + coords[a]
                view = view.narrow(dim, idx * x.shape[dim], x.shape[dim])
            view.copy_(x)
    for keys, x in tree_leaves_with_path(params):
        assert torch.equal(rebuilt[keys], x), keys


def test_axis_ranks_join_the_fsdp_axes():
    """The rank groups of one axis and of ("pod", "data") joined, on a
    (2, 2, 2) mesh (ranks row-major)."""
    m = MeshConfig((2, 2, 2), ("pod", "data", "model"))
    assert sh.axis_ranks(m, "pod") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert sh.axis_ranks(m, "model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert sh.axis_ranks(m, sh.FSDP_AXES) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    # a mesh without "pod": the FSDP axes are "data"
    m2 = make_mesh(2, 2)
    assert sh.axis_ranks(m2, sh.FSDP_AXES) == sh.axis_ranks(m2, "data")


class _Shard:
    """As much of a MeshShard as the policy's sizes and ranks read."""

    def __init__(self, pod=1, data=1, model=1, pod_rank=0, seq_shard=None):
        self.pod_size, self.data_size, self.model_size = pod, data, model
        self.pod_rank, self.data_rank, self.model_rank = pod_rank, 0, 0
        self.places_params, self.world = True, pod * data * model
        self.seq_shard = seq_shard


@pytest.mark.parametrize("pod,data", [(2, 2), (2, 3), (4, 2), (3, 1)])
def test_fsdp_axes_are_those_fit_spec_keeps(pod, data):
    policy = ShardingPolicy(_Shard(pod, data))
    mesh = {"pod": pod, "data": data, "model": 1}
    for n in range(1, 200):
        (entry,) = sh.fit_spec((n,), (sh.FSDP_AXES,), mesh)
        want = tuple(a for a in _axes(entry) if mesh[a] > 1)
        assert policy.fsdp_axes(n) == want, n


def test_split_rows_keeps_the_pod_block_or_the_whole_batch():
    """A per-client batch that "pod" divides: this rank's rows of every
    leaf (tokens-like on the second to last dim, prefix and frames on
    the third to last); one it does not: the whole batch, no row split
    (no sum over "pod" follows)."""
    policy = ShardingPolicy(_Shard(pod=2, pod_rank=1))
    batch = {"tokens": torch.arange(3 * 4 * 5).reshape(3, 4, 5),
             "prefix": torch.arange(3 * 4 * 2 * 6).reshape(3, 4, 2, 6)}
    got, p = policy.split_rows(batch)
    assert p.rows and p is not policy
    assert torch.equal(got["tokens"], batch["tokens"][:, 2:])
    assert torch.equal(got["prefix"], batch["prefix"][:, 2:])
    odd = {k: v[:, :3] for k, v in batch.items()}
    got, p = policy.split_rows(odd)
    assert not p.rows and got is odd


@pytest.mark.parametrize("name", ["llama3-8b", "kimi-k2-1t-a32b",
                                  "whisper-medium", "internvl2-76b",
                                  "mamba2-780m", "zamba2-1.2b"])
def test_seq_shard_follows_the_reference_rule(name):
    """None: on unless the family is SSM or hybrid (the reference's
    train and prefill cells); the shard's setting, then the caller's,
    override it.  A stream whose length the "model" axis does not divide
    is not split."""
    arch = get_config(name)
    on = arch.model.family not in ("ssm", "hybrid")
    assert ShardingPolicy.for_model(_Shard(model=2), arch).seq_shard == on
    assert ShardingPolicy.for_model(_Shard(model=2, seq_shard=not on),
                                    arch).seq_shard == (not on)
    assert ShardingPolicy.for_model(_Shard(model=2, seq_shard=not on),
                                    arch, seq_shard=on).seq_shard == on
    policy = ShardingPolicy.for_model(_Shard(model=2), arch, seq_shard=True)
    assert policy.for_stream(512).sp and not policy.for_stream(511).sp
    assert not ShardingPolicy.for_model(_Shard(model=1), arch,
                                        seq_shard=True).for_stream(512).sp


# ---------------------------------------------------------------------------
# training on 4 gloo ranks


def _reference(name):
    arch = cases.case_arch(name, j_reduced, j_get_config)
    ref = cases.with_frontend(j_system.SplitFTSystem(
        arch, j_system.SystemConfig(**cases.SYS), seed=0), arch.model)
    return ref, jax.tree.map(np.asarray, ref.base_params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("param_sharding_sp")
    hist = {}
    for name in cases.REF_CASES:
        ref, raw = _reference(name)
        torch.save((raw, jax.tree.map(np.asarray, ref.state)),
                   out / f"ref_{name}.pt")
        hist[name] = ref.run(cases.ROUNDS, log_every=0)
    for group in cases.GROUPS:
        run_ranks(cases.rank_main, 4, out / f"group_{group}",
                  args=(str(out), group))
    return out, hist


def _load(out, name):
    return torch.load(out / f"{name}.pt", weights_only=False)


def _sharded(out, mesh, name, sp):
    return _load(out, f"sharded_{mesh}_{name}_{cases.sp_tag(sp)}")


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_sharded_case_matches_unsharded_and_the_reference(runs, run):
    out, ref_hist = runs
    mesh, name, sp = run
    got = _sharded(out, mesh, name, sp)
    cases.held(got, _load(out, f"plain_{name}"), name)
    if name in ref_hist:
        _losses_close(ref_hist[name], got["history"])


@pytest.mark.parametrize(
    "run", [r for r in RUNS if r[1] in cases.SERVE_CASES], ids=_run_id)
def test_sharded_serving_matches_unsharded(runs, run):
    out, _ = runs
    mesh, name, sp = run
    want = _load(out, f"plain_{name}")["serve"]
    tag = f"{mesh}_{name}_{cases.sp_tag(sp)}"
    got = [_load(out, f"serve_{tag}_{r}")
           for r in range(MESHES[mesh].num_devices)]
    for g in got:
        mesh_serving.held(g, want)
    cache_blocks_held(got, want["cache"], MESHES[mesh],
                      cases.case_arch(name).model)


@pytest.mark.parametrize("name", cases.SERVE_CASES)
def test_unsharded_serving_matches_the_reference(runs, name):
    out, _ = runs
    held_to_the_reference(
        j_build_model(cases.case_arch(name, j_reduced, j_get_config)),
        _load(out, f"ref_{name}")[0], _load(out, f"plain_{name}")["serve"])


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_the_stream_is_split_where_sp_and_the_length_allow(runs, run):
    """The residual stream's lengths that the attention blocks took: the
    rank's sequence block under SP where the "model" axis divides the
    length (whisper: the encoder's 16 frames and the decoder's 32
    tokens), the whole sequence otherwise."""
    out, _ = runs
    mesh, name, sp = run
    arch = cases.case_arch(name)
    tp = sh.axis_sizes(MESHES[mesh]).get("model", 1)
    on = ShardingPolicy.for_model(_Shard(model=tp), arch,
                                  seq_shard=sp).seq_shard
    lengths = [arch.train.seq_len] + (
        [arch.model.encoder_seq_len] if arch.model.family == "audio"
        else [])
    want = sorted({s // tp if on and s % tp == 0 else s for s in lengths})
    assert _sharded(out, mesh, name, sp)["seqs"] == want


@pytest.mark.parametrize("name", cases.SP_CASES)
def test_seq_shard_on_equals_off(runs, name):
    """On the (1, 4) mesh: the losses within rtol 1e-6 and the state
    within the unsharded tolerance (the hybrid's SP forced on); the MoE
    case's routing and drops equal."""
    out, _ = runs
    on = _sharded(out, "1x4", name, True)
    off = _sharded(out, "1x4", name, False)
    cases.held(on, off, name)
    if name in cases.MOE_CASES:
        assert cases.same_routing(on, off) > 0


@pytest.mark.parametrize("mesh", ["1x4", "2x1x2", "2x2x1"])
def test_moe_routing_and_drops_equal_the_unsharded_run(runs, mesh):
    """Every MoE layer call's top-k choices and drops, gathered over
    "pod" and "data": equal on every rank and to the unsharded run's,
    with pairs dropped at capacity 1.25 (kimi under SP on (1, 4);
    kimi_pod with its rows over "pod")."""
    out, _ = runs
    name = "kimi" if mesh == "1x4" else "kimi_pod"
    sp = True if mesh == "1x4" else None
    got = _sharded(out, mesh, name, sp)
    assert sum(len(r) for r in got["routes"]) == cases.ROUNDS * 2 * 4
    assert cases.same_routing(got, _load(out, f"plain_{name}")) > 0


@pytest.mark.parametrize("run", [r for r in RUNS if r[0].count("x") == 2],
                         ids=_run_id)
def test_pod_mesh_ranks_hold_their_blocks(runs, run):
    """The base weights SplitFTSystem keeps on each rank of a ("pod",
    "data", "model") mesh are param_specs' blocks, by bytes."""
    out, _ = runs
    mesh, name, _ = run
    m = MESHES[mesh]
    full = build_model(cases.case_arch(name), device="cpu"
                       ).init_params(torch.Generator().manual_seed(0))
    specs = dict(tree_leaves_with_path(sh.param_specs(full, m)))
    got = [_load(out, f"bytes_{mesh}_{name}_{r}")
           for r in range(m.num_devices)]
    for keys, leaf in tree_leaves_with_path(full):
        share = int(np.prod([sh.axis_sizes(m)[a] for e in specs[keys]
                             for a in _axes(e)]))
        want = leaf.numel() * leaf.element_size() // share
        assert {g["/".join(keys)] for g in got} == {want}, keys
