"""Parameter sharding of the MoE, SSM and hybrid families' training
round: expert parallelism over "model" (the experts' ff dim over
"data"), tensor parallelism over the SSM heads, in 4 gloo processes
against the unsharded port and the unsharded JAX reference.

Placement: for every leaf of kimi-k2, llama4-maverick, mamba2-780m and
zamba2-1.2b at full width on the meta device, on the (1, 4) and (2, 2)
meshes, a rank's block has 1/model of each dim split over "model" and
1/data of each dim split over "data", by bytes (the experts' ff dim
over "data"); at reduced width the ranks' blocks, put back by their
mesh coordinates, are the full leaf bit for bit; ``init_params(place=
leaf_block)`` draws each leaf whole and keeps the rank's block, one full
leaf alive at a time.

Training: one spawn per mesh (the module fixture), (1, 4) and (2, 2), in
which 4 ranks run the 4 cases of
tests/torch_param_sharding_family_cases.py (a kimi-like and a
llama4-like MoE at capacity 1.25, a mamba2-like SSM, a zamba2-like
hybrid) for 2 rounds of ``SplitFTSystem.run`` under a ``MeshShard`` from
the JAX reference's weights, and the unsharded port runs the same cases.
The gathered state after each round is held within
tests/test_torch_param_sharding.py's tolerances of the unsharded run's
(largest gap measured 2.0e-6 x max|leaf|), the losses also against the
JAX reference's (unsharded: its own host-mesh sharding fails under this
jax).  Every MoE layer's top-k choices and drops, gathered over "data",
agree on every rank (``check_agree``) and equal the unsharded run's,
with pairs dropped.  Mutations: an SSM case run with the gated norm's
"model" sum skipped moves the SSM adapters by a share of their max; the
shared expert's adapter gradients (added by hand: the configs give an
MoE group none) without their partial-target sum are a share of their
max away from the unsharded gradients, with it ~1e-6.

Serving: after their rounds kimi_moe, mamba2_ssm and zamba2_hybrid serve
on every rank (tests/torch_mesh_serving_cases.py: the rank's cache
blocks, a prefill and 5 greedy decode steps across a block edge of the
KV sequence; the SSM conv window's channel blocks gathered and written
back each step): the tokens equal the unsharded port's, the logits
within 2e-4 (measured 3.3e-6 at most), each rank's cache holds
``cache_specs``' blocks, and the unsharded port's logits match the JAX
reference's within 2e-5 (measured 4.9e-6 at most).
Refusals: SSM heads that the "model" axis does not divide, and a decode
step with a client axis, raise in every rank and name the ROADMAP
item.

Time: ~85 s alone, one torch thread: ~20 s for the two spawns, ~25 s
for the JAX reference's 4 cases, the rest the placement tests at full
width on fake tensors.
"""

import dataclasses
import threading
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_param_sharding_family_cases as cases  # noqa: E402
from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import system as j_system  # noqa: E402
from repro_torch import roadmap  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.sharded import run_ranks  # noqa: E402
from repro_torch.models import ssm, transformer  # noqa: E402
from repro_torch.models.common import ShardingPolicy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402
from test_torch_param_sharding import _axes, _meta_params, _Rank  # noqa: E402
from test_torch_mesh_serving import (cache_blocks_held,  # noqa: E402
                                     held_to_the_reference)
import torch_mesh_serving_cases as mesh_serving  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from test_torch_system import _losses_close  # noqa: E402

FAMILIES = ("kimi-k2-1t-a32b", "llama4-maverick-400b-a17b", "mamba2-780m",
            "zamba2-1.2b")
MESHES = {k: make_mesh(*v) for k, v in cases.MESHES.items()}


# ---------------------------------------------------------------------------
# placement


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", FAMILIES)
def test_each_rank_holds_its_share_by_bytes(name, mesh):
    """Each leaf's block on each rank, at full width on the meta device:
    1/model of a dim that param_specs splits over "model", 1/data of one
    it splits over "data", the rest whole; every rank the same bytes."""
    m = MESHES[mesh]
    sizes = sh.axis_sizes(m)
    full = _meta_params(name)
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
    layer = {k[-1]: v for k, v in tree_leaves_with_path(
        sh.local_params(full, m, _Rank(0)))}
    whole = {k[-1]: v for k, v in tree_leaves_with_path(full)}
    if name == "kimi-k2-1t-a32b":
        # the experts over "model" and their ff dim over "data"; the
        # router's experts over "model" and d_model over "data"
        for leaf in ("we_in", "we_gate", "we_out", "router", "ws_in",
                     "ws_out"):
            assert layer[leaf].numel() * 4 == whole[leaf].numel(), leaf
        assert layer["we_in"].shape[1] * sizes["model"] == 384
        assert layer["we_in"].shape[-1] * sizes["data"] == 2048
        assert layer["we_out"].shape[-2] * sizes["data"] == 2048
    if name == "mamba2-780m":
        # in_proj's 6448 columns and the conv's 3328 channels in blocks
        # that do not fall on the 64-wide heads
        assert layer["in_proj"].shape[-1] * sizes["model"] == 6448
        assert layer["conv_w"].shape[-1] * sizes["model"] == 3328
        assert (6448 // sizes["model"]) % 64 != 0
        for leaf in ("A_log", "D", "dt_bias"):
            assert layer[leaf].shape[-1] * sizes["model"] == 48, leaf


@pytest.mark.parametrize("mesh", list(MESHES))
def test_blocks_put_back_are_the_full_leaves(mesh):
    m = MESHES[mesh]
    sizes = sh.axis_sizes(m)
    for name in cases.CASES:
        params = build_model(cases.case_arch(name), device="cpu"
                             ).init_params(torch.Generator().manual_seed(0))
        specs = dict(tree_leaves_with_path(sh.param_specs(params, m)))
        rebuilt = {k: torch.full_like(x, float("nan"))
                   for k, x in tree_leaves_with_path(params)}
        for r in range(m.num_devices):
            coords = sh.mesh_coords(m, r)
            for keys, x in tree_leaves_with_path(
                    sh.local_params(params, m, _Rank(r))):
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


@pytest.mark.parametrize("name", ["kimi_moe", "zamba2_hybrid"])
def test_init_draws_one_full_leaf_at_a_time(name):
    """init_params(place=leaf_block) for the expert and SSM leaves: no
    full leaf drawn before is alive when the next is drawn, and the kept
    blocks are local_params of the full tree bit for bit (the draw is
    the unsharded one)."""
    m = MESHES["2x2"]
    model = build_model(cases.case_arch(name), device="cpu")
    full = model.init_params(torch.Generator().manual_seed(0))
    for r in range(m.num_devices):
        drawn = []

        def place(leaf_name, leaf):
            assert all(ref() is None for ref in drawn), leaf_name
            drawn.append(weakref.ref(leaf))
            return sh.leaf_block(leaf_name, leaf, mesh=m, rank=r)

        got = dict(tree_leaves_with_path(model.init_params(
            torch.Generator().manual_seed(0), place=place)))
        want = list(tree_leaves_with_path(sh.local_params(full, m,
                                                          _Rank(r))))
        assert len(drawn) == len(want)
        for keys, x in want:
            assert torch.equal(got[keys], x), keys


class _Recorder:
    """As much of a MeshShard as ShardingPolicy.gather reads; records
    what it all-reduces (each tensor as its own)."""

    def __init__(self):
        self.data_size, self.data_rank = 2, 0
        self.model_size, self.model_rank = 1, 0
        self.got = []

    def all_reduce(self, tensors, op, axis="data"):
        self.got += [(axis, tuple(t.shape)) for t in tensors]
        return [t.clone() for t in tensors]


def test_fsdp_gather_leaves_the_experts_where_they_are():
    """Over "data" the router and the shared expert gather their d_model
    dims; the experts (ff split) are never gathered: moe_apply moves
    their rows."""
    arch = cases.case_arch("kimi_moe")
    cfg = arch.model
    p = transformer.init_moe(torch.Generator().manual_seed(0), cfg, 1,
                             dtype=torch.float32)
    p = {k: v[0] for k, v in p.items() if not isinstance(v, dict)}
    local = {k: sh.leaf_block(k, v, mesh=MESHES["2x2"], rank=0)
             for k, v in p.items()}
    rec = _Recorder()
    out = ShardingPolicy(rec).gather(local, cfg.d_model)
    for k in ("we_in", "we_gate", "we_out"):
        assert out[k] is local[k]
    gathered = {shape for _, shape in rec.got}
    assert gathered == {tuple(p[k].shape[:-1]) + (local[k].shape[-1],)
                        for k in ("router", "ws_in", "ws_gate")} | {
        (local["ws_out"].shape[0], cfg.d_model)}


# ---------------------------------------------------------------------------
# the blocks in one process: the "model" ranks as threads


class _ThreadShard:
    """One of `tp` "model" ranks run as threads of this process: an
    all-reduce waits for every rank's tensors and sums them in rank
    order (the same sum on every rank)."""

    def __init__(self, hub, rank):
        self.hub, self.model_rank = hub, rank
        self.model_size, self.data_size, self.data_rank = hub["tp"], 1, 0

    def all_reduce(self, tensors, op, axis="data"):
        assert axis == "model" and op == "sum"
        hub = self.hub
        hub["slots"][self.model_rank] = [t.detach().clone()
                                         for t in tensors]
        hub["barrier"].wait()
        out = [sum(hub["slots"][r][i] for r in range(hub["tp"]))
               for i in range(len(tensors))]
        hub["barrier"].wait()
        return out


def _on_threads(tp, fn):
    hub = {"tp": tp, "slots": {}, "barrier": threading.Barrier(tp)}
    got, errs = [None] * tp, []

    def run(r):
        try:
            got[r] = fn(r, ShardingPolicy(_ThreadShard(hub, r)))
        except BaseException as e:   # noqa: BLE001 - re-raised below
            errs.append(e)
            hub["barrier"].abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return got


def _layer(params):
    return {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
                else v[0]) for k, v in params.items()}


def _grads(apply, p, adapters, x, w):
    leaves = {(t, m): adapters[t][m].clone().requires_grad_(True)
              for t in adapters for m in ("A", "B")}
    ad = {t: {"A": leaves[(t, "A")], "B": leaves[(t, "B")],
              "scale": adapters[t]["scale"]} for t in adapters}
    x = x.clone().requires_grad_(True)
    out, aux = apply(p, ad, x)
    g = torch.autograd.grad((out * w).sum() + aux, [x] + list(leaves.values()))
    return out.detach(), g


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["moe", "ssm"])
def test_blocks_on_model_ranks_sum_to_the_whole(kind, tp):
    """moe_apply (the router's gathered logits, each rank's experts and
    its block of the shared expert) and ssm_apply (each rank's heads,
    in_proj and the conv gathered, the gated norm's summed squares) on
    `tp` "model" ranks: the output and the input's gradient on every
    rank and the adapters' gradients summed over the ranks are the
    unsharded
    sub-block's (the input's on every rank)."""
    name = "kimi_moe" if kind == "moe" else "mamba2_ssm"
    cfg = cases.case_arch(name).model
    gen = torch.Generator().manual_seed(0)
    d = cfg.d_model
    if kind == "moe":
        p = _layer(transformer.init_moe(gen, cfg, 1, dtype=torch.float32))
        sf = cfg.moe_d_ff
        shapes = {"mlp_in": (d, sf), "mlp_gate": (d, sf),
                  "mlp_out": (sf, d)}

        def apply(p, ad, x, policy=ShardingPolicy()):
            return transformer.moe_apply(p, ad, x, cfg=cfg, policy=policy)
    else:
        p = _layer(ssm.init_ssm(gen, cfg, 1, dtype=torch.float32))
        for k, s in (("A_log", 0.3), ("dt_bias", 0.3), ("conv_b", 0.1)):
            p[k] = s * torch.randn(p[k].shape, generator=gen)
        p["gnorm"]["scale"] = 1 + 0.1 * torch.randn(d * 2, generator=gen)
        shapes = {"ssm_in": (d, ssm.in_proj_dim(cfg)),
                  "ssm_out": (cfg.d_inner, d)}

        def apply(p, ad, x, policy=ShardingPolicy()):
            out, _ = ssm.ssm_apply(p, ad, x, cfg=cfg, mode="train",
                                   policy=policy)
            return out, 0.0
    adapters = {t: {"A": 0.1 * torch.randn(i, 4, generator=gen),
                    "B": 0.1 * torch.randn(4, o, generator=gen),
                    "scale": torch.tensor(2.0)}
                for t, (i, o) in shapes.items()}
    x = torch.randn(4, 2, 32, d, generator=gen)
    w = torch.linspace(-1, 1, x.numel()).reshape(x.shape)
    want_out, want_g = _grads(apply, p, adapters, x, w)
    mesh = make_mesh(1, tp)

    def rank(r, policy):
        pl = {k: (v if isinstance(v, dict) else
                  sh.leaf_block(k, v, mesh=mesh, rank=r))
              for k, v in p.items()}
        return _grads(lambda p_, a_, x_: apply(p_, a_, x_, policy), pl,
                      adapters, x, w)

    def close(a, b):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))

    got = _on_threads(tp, rank)
    for out, g in got:
        close(out, want_out)
        # the input's gradient, summed over "model" by copy_to_tp
        close(g[0], want_g[0])
    # the adapters': each rank's part
    for i, want in enumerate(want_g[1:], 1):
        close(sum(g[i] for _, g in got), want)


# ---------------------------------------------------------------------------
# training on 4 gloo ranks


def _reference(name):
    ref = j_system.SplitFTSystem(
        cases.case_arch(name, j_reduced, j_get_config),
        j_system.SystemConfig(**cases.SYS), seed=0)
    return ref, jax.tree.map(np.asarray, ref.base_params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("param_sharding_families")
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
@pytest.mark.parametrize("name", cases.SERVE_CASES)
def test_sharded_serving_matches_unsharded(runs, name, mesh):
    out, _ = runs
    want = _load(out, f"plain_{name}")["serve"]
    got = [_load(out, f"serve_{mesh}_{name}_{r}")
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


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(cases.CASES))
def test_sharded_case_matches_unsharded_and_the_reference(runs, name,
                                                          mesh):
    out, ref_hist = runs
    got = _load(out, f"sharded_{mesh}_{name}")
    cases.held(got, _load(out, f"plain_{name}"))
    _losses_close(ref_hist[name], got["history"])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", cases.MOE_CASES)
def test_routing_and_drops_equal_the_unsharded_run(runs, name, mesh):
    """Every MoE layer call's top-k choices and drops (train and eval
    steps, both rounds), gathered over "data": equal on every rank (the
    ranks checked their digests) and to the unsharded run's, with pairs
    dropped at capacity 1.25."""
    out, _ = runs
    got = _load(out, f"sharded_{mesh}_{name}")
    calls = sum(len(r) for r in got["routes"])
    # the train and eval steps' forwards, once a layer each round
    assert calls == cases.ROUNDS * 2 * 4
    assert cases.same_routing(got, _load(out, f"plain_{name}")) > 0


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(cases.CASES))
def test_system_ranks_hold_their_blocks(runs, name, mesh):
    """The base weights SplitFTSystem keeps on each rank are
    param_specs' blocks, by bytes, on every rank."""
    out, _ = runs
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


@pytest.mark.parametrize("mesh", list(MESHES))
def test_skipping_the_gated_norm_sum_moves_the_ssm_adapters(runs, mesh):
    out, _ = runs
    with pytest.raises(AssertionError, match="ssm_in"):
        cases.held(_load(out, f"mutant_{mesh}_mamba2_ssm"),
                   _load(out, "plain_mamba2_ssm"))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shared_expert_adapters_are_partial_targets(runs, mesh):
    """The shared expert's adapter gradients: with the partial targets'
    "model" sum within 1e-5 x max of the unsharded gradients, without it
    a share of the max away."""
    out, _ = runs
    got = _load(out, f"shared_{mesh}")
    assert set(cases.SHARED_TARGETS) <= set(got["partial"])
    for k, want in got["plain"].items():
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got["summed"][k], want, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=k)
        gap = float(np.abs(got["unsummed"][k] - want).max()) / scale
        if k.split("/")[0] in cases.SHARED_TARGETS:
            assert gap > 0.1, k
        else:
            assert gap < 1e-5, k


@pytest.mark.parametrize("mesh", list(MESHES))
def test_unsupported_configs_raise_with_the_roadmap_pointer(runs, mesh):
    out, _ = runs
    raised = _load(out, f"raised_{mesh}")
    assert set(raised) == set(cases.REFUSED)
    for label, kind in cases.REFUSED.items():
        got_kind, msg = raised[label]
        assert got_kind == kind, (label, raised[label])
        assert roadmap.PARAM_SHARDING in msg, label


@pytest.mark.parametrize("name", FAMILIES + ("whisper-medium",
                                             "internvl2-76b"))
def test_for_model_places_the_families(name):
    """ShardingPolicy.for_model takes the MoE, SSM, hybrid, audio and vlm
    families on a mesh whose "model" axis divides their heads."""

    class _Shard:
        places_params, world, model_size = True, 4, 4

    policy = ShardingPolicy.for_model(_Shard(), get_config(name))
    assert policy.shard is not None


def test_ssm_tp_columns_follow_the_heads():
    """A rank's in_proj columns and conv channels: its heads' x, z and
    dt, and B and C, in the layouts' order; more than one B/C group
    raises."""
    cfg = get_config("mamba2-780m").model
    cols, chans = ssm._tp_columns(cfg, 24, 24, "cpu")
    di, n = cfg.d_inner, cfg.ssm_state
    assert cols.tolist() == (list(range(1536, 3072))
                             + list(range(di + 1536, di + 3072))
                             + list(range(2 * di, 2 * di + 2 * n))
                             + list(range(2 * di + 2 * n + 24,
                                          2 * di + 2 * n + 48)))
    assert chans.tolist() == (list(range(1536, 3072))
                              + list(range(di, di + 2 * n)))
    with pytest.raises(NotImplementedError, match=roadmap.PARAM_SHARDING):
        ssm._tp_columns(dataclasses.replace(cfg, ssm_groups=4), 24, 24,
                        "cpu")
