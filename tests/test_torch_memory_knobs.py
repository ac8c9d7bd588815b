"""The round engine's memory knobs in the port against the JAX package's:
layer recompute (``remat`` none / dots / full), chunked cross entropy
(``ce_chunk``) and gradient accumulation (``microbatch``).

Size: gpt2-small and mamba2-780m reduced to 2 layers, d_model 64, vocab
256, seq 32, batch 2 (mamba2: 4 SSD heads of P = 16, chunk 16, so the
state crosses a chunk), 2 clients with cuts [1, 2], r_cut 4, r_others 8,
fp32.  gpt2 compresses the smashed activation with int8, so the cut
boundary runs inside the recomputed layer; mamba2 keeps its config's
"none".  The reference builds weights and state (random non-zero
adapters); ``repro_torch.bridge`` hands the same numpy arrays to the port.

Tolerances: a recompute repeats the forward on the CPU, so remat must
give the "none" step's loss and gradients bit for bit.  Against the
reference (fp32 sums in another order) as in tests/test_torch_rounds.py:
losses rtol = atol = 1e-4, adapter gradients rtol 1e-4 with a floor of
1e-4 of the largest gradient (1e-3 under int8: a cotangent element near
an int8 rounding boundary takes the neighbouring code), one SGD round's
adapters 1e-5.
"""

import dataclasses
import math

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
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import reduced as t_reduced  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import rounds as t_rounds  # noqa: E402
from repro_torch.core import smashed as t_smashed  # noqa: E402
from repro_torch.core import split as t_split  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SMALL = dict(layers=2, d_model=64, vocab=256, seq_len=32, batch=2)
CUTS = [1, 2]
WEIGHTS = np.array([0.25, 0.75], np.float32)
ACTIVE = np.ones(2, np.float32)
LR = 1e-2
SMASHED = {"gpt2-small": "int8", "mamba2-780m": "none"}
ARCHS = tuple(SMASHED)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _arch(name, reduced, get_config, optimizer="sgd"):
    arch = reduced(get_config(name), **SMALL)
    return arch.replace(
        lora=dataclasses.replace(arch.lora, r_others=8, r_cut=4),
        train=dataclasses.replace(arch.train, optimizer=optimizer))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    name = request.param
    model_j = j_build_model(_arch(name, j_reduced, j_get_config))
    params_j = model_j.init_params(jax.random.PRNGKey(0))
    state_j = j_rounds.init_state(model_j, jax.random.PRNGKey(1),
                                  num_clients=2)
    rng = np.random.default_rng(0)
    for side in ("client_adapters", "server_adapters"):
        state_j[side] = jax.tree.map(
            lambda v: jnp.asarray(rng.normal(size=v.shape) * 0.05,
                                  jnp.float32), state_j[side])
    state_j["cuts"] = jnp.asarray(CUTS, jnp.int32)
    toks = rng.integers(3, 256, size=(2, 2, 33)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
             "loss_mask": (rng.random((2, 2, 32)) > 0.1).astype(np.float32)}
    return dict(comp=SMASHED[name], model_j=model_j,
                params_j=params_j, state_np=_np(state_j),
                model_t=build_model(_arch(name, t_reduced, t_get_config),
                                    device="cpu"),
                params_t=bridge.params_from_numpy(_np(params_j), "cpu"),
                batch=batch)


def _states(setup):
    return (jax.tree.map(jnp.asarray, setup["state_np"]),
            bridge.state_from_numpy(setup["state_np"], "cpu"))


def _port_grads(setup, **kw):
    _, state_t = _states(setup)
    boundary = t_smashed.make_boundary(
        t_smashed.make_compressor(setup["comp"]), state_t["cuts"])
    total, met, gc, gs = t_rounds.round_grads(
        setup["model_t"], setup["params_t"], state_t, setup["batch"],
        WEIGHTS, boundary=boundary, **kw)
    return total, met, tree_leaves(gc) + tree_leaves(gs)


def _reference_grads(setup, **kw):
    state_j, _ = _states(setup)
    model_j, cuts = setup["model_j"], state_j["cuts"]
    boundary = j_smashed.make_boundary(
        j_smashed.make_compressor(setup["comp"]), cuts)
    batch = jax.tree.map(jnp.asarray, setup["batch"])
    wl = WEIGHTS / WEIGHTS.sum()

    def loss(cad, sad):
        eff = j_split.merge_adapters(model_j, cad, sad, cuts)
        per, met = model_j.loss(setup["params_j"], eff, batch,
                                per_client=True, boundary=boundary, **kw)
        return jnp.sum(wl * per), met

    (total, met), g = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        state_j["client_adapters"], state_j["server_adapters"])
    return total, met, jax.tree.leaves(g[0]) + jax.tree.leaves(g[1])


def _assert_grads_close(setup, got, want):
    assert len(got) == len(want)
    scale = max(float(np.abs(w).max()) for w in want)
    floor = (1e-3 if setup["comp"] == "int8" else 1e-4) * scale
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=floor)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_repeats_the_step_bit_for_bit(setup, remat):
    t0, m0, g0 = _port_grads(setup)
    t1, m1, g1 = _port_grads(setup, remat=remat)
    assert torch.equal(t0, t1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_remat_step_matches_reference(setup, remat):
    total_t, met_t, g_t = _port_grads(setup, remat=remat)
    total_j, met_j, g_j = _reference_grads(setup, remat=remat)
    np.testing.assert_allclose(float(total_t), float(total_j), rtol=1e-4)
    for k in ("ce", "accuracy"):
        np.testing.assert_allclose(met_t[k].numpy(), np.asarray(met_j[k]),
                                   rtol=1e-4, atol=1e-4)
    _assert_grads_close(setup, g_t, g_j)


def test_chunked_cross_entropy_matches_reference(setup):
    """ce_chunk 8 over seq 32 (4 chunks) in a train step's gradients and
    in the eval step; ce_chunk 24 does not divide 32 and takes the
    unchunked path, as the reference's condition says."""
    total_t, met_t, g_t = _port_grads(setup, ce_chunk=8)
    total_j, met_j, g_j = _reference_grads(setup, ce_chunk=8)
    np.testing.assert_allclose(float(total_t), float(total_j), rtol=1e-4)
    np.testing.assert_allclose(met_t["tokens"].numpy(),
                               np.asarray(met_j["tokens"]), rtol=0)
    _assert_grads_close(setup, g_t, g_j)
    plain = _port_grads(setup)
    assert torch.equal(_port_grads(setup, ce_chunk=24)[0], plain[0])
    state_j, state_t = _states(setup)
    per_j, _ = j_rounds.make_eval_step(setup["model_j"], ce_chunk=8)(
        setup["params_j"], state_j, jax.tree.map(jnp.asarray,
                                                 setup["batch"]),
        jnp.asarray(WEIGHTS))
    per_t, _ = t_rounds.make_eval_step(setup["model_t"], ce_chunk=8)(
        setup["params_t"], state_t, setup["batch"], WEIGHTS)
    np.testing.assert_allclose(per_t.numpy(), np.asarray(per_j), rtol=1e-4,
                               atol=1e-4)


def test_microbatch_round_matches_reference(setup):
    """One SGD round at microbatch 2 (batch 2 -> two slices of 1): the
    accumulated, 1/A-scaled gradients, FedAvg and broadcast."""
    state_j, state_t = _states(setup)
    kw = dict(microbatch=2, smashed_compress=setup["comp"])
    state_j, met_j = j_rounds.make_train_step(setup["model_j"], **kw)(
        setup["params_j"], state_j, jax.tree.map(jnp.asarray,
                                                 setup["batch"]),
        jnp.asarray(WEIGHTS), jnp.asarray(ACTIVE), jnp.float32(LR),
        jnp.float32(LR))
    state_t, met_t = t_rounds.make_train_step(setup["model_t"], **kw)(
        setup["params_t"], state_t, setup["batch"], WEIGHTS, ACTIVE, LR, LR)
    s_j, s_t = _np(state_j), bridge.to_numpy(state_t)
    for side in ("client_adapters", "server_adapters"):
        for (path, want), got in zip(
                jax.tree_util.tree_flatten_with_path(s_j[side])[0],
                jax.tree.leaves(s_t[side])):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(path))
    for k in ("total", "ce", "accuracy", "tokens"):
        np.testing.assert_allclose(np.asarray(bridge.to_numpy(met_t)[k]),
                                   np.asarray(met_j[k]), rtol=1e-4,
                                   atol=1e-4)


def _saved_bytes(setup, remat, monkeypatch):
    """Bytes the forward of a train-mode loss keeps for its backward:
    what autograd saves outside the recomputed layers (under remat, each
    layer's input), plus the matrix-product outputs the "dots" policy
    stores inside them."""
    ckpt = torch.utils.checkpoint
    products = []
    policy = t_model._save_products

    def counting(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if decision == ckpt.CheckpointPolicy.MUST_SAVE \
                and not ctx.is_recompute:
            a, b = args[-2:]                  # mm/bmm, or addmm's m1, m2
            products.append(math.prod(a.shape[:-1]) * b.shape[-1]
                            * a.element_size())
        return decision

    monkeypatch.setattr(t_model, "_save_products", counting)
    _, state_t = _states(setup)
    leaves = {g: {t: {k: v.requires_grad_(True) for k, v in ad.items()}
                  for t, ad in targets.items()}
              for g, targets in state_t["client_adapters"].items()}
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    batch = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        eff = t_split.merge_adapters(setup["model_t"], leaves,
                                     state_t["server_adapters"],
                                     state_t["cuts"])
        setup["model_t"].loss(setup["params_t"], eff, batch,
                              per_client=True, remat=remat)
    return sum(saved) + sum(products), len(products)


def test_remat_saves_less(setup, monkeypatch):
    """"full" keeps only each layer's input, "dots" also the products'
    outputs, "none" everything."""
    none, n_none = _saved_bytes(setup, "none", monkeypatch)
    dots, n_dots = _saved_bytes(setup, "dots", monkeypatch)
    full, n_full = _saved_bytes(setup, "full", monkeypatch)
    assert (n_none, n_full) == (0, 0) and n_dots > 0
    assert full < dots < none, (full, dots, none)


def test_unknown_remat_raises(setup):
    with pytest.raises(ValueError, match="remat"):
        _port_grads(setup, remat="offload")
