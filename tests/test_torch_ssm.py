"""The port's Mamba2 (SSD) model and round engine against the JAX
package's, on reduced mamba2-780m: 4 layers, d_model 64 (d_inner 128,
8 SSD heads of P = 16, state N = 16, 1 group, chunk 16), vocab 256, seq 32
(two chunks, so the state carry runs) and 24 (padded to a chunk multiple),
batch 2, 3 clients with cuts [1, 2, 3], r_cut 4, r_others 8, fp32.

The reference builds the weights and the state (random non-zero adapters,
so that every adapter has a gradient); ``repro_torch.bridge`` hands the
same numpy arrays to the port.

Tolerances (fp32, sums in another order): the SSD block's output and the
losses rtol = atol = 1e-4; adapter gradients rtol 1e-4 with an absolute
floor of 1e-4 of the tree's largest gradient; one SGD round's adapters
1e-5; one AdamW round's losses and moments 1e-4 and its adapters lr / 50
(AdamW's first step moves an element whose gradient is tiny next to the
tree's largest by up to lr, as in tests/test_torch_rounds.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import rounds as j_rounds  # noqa: E402
from repro.core import split as j_split  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.models.common import NO_SHARDING  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import reduced as t_reduced  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import rounds as t_rounds  # noqa: E402
from repro_torch.core import split as t_split  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SMALL = dict(layers=4, d_model=64, vocab=256, seq_len=32, batch=2)
CUTS = [1, 2, 3]
WEIGHTS = np.array([0.25, 0.25, 0.5], np.float32)
ACTIVE = np.ones(3, np.float32)
LR = 1e-2
TOL = dict(rtol=1e-4, atol=1e-4)


def _arch(reduced, get_config, optimizer="adamw"):
    arch = reduced(get_config("mamba2-780m"), **SMALL)
    return arch.replace(
        lora=dataclasses.replace(arch.lora, r_others=8, r_cut=4),
        train=dataclasses.replace(arch.train, optimizer=optimizer))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(rng, seq):
    toks = rng.integers(3, 256, size=(3, 2, seq + 1)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:],
            "loss_mask": (rng.random((3, 2, seq)) > 0.1).astype(np.float32)}


@pytest.fixture(scope="module")
def setup():
    model_j = j_build_model(_arch(j_reduced, j_get_config))
    params_j = model_j.init_params(jax.random.PRNGKey(0))
    # non-trivial SSD parameters: per-head decay rates, dt biases and skips
    rng = np.random.default_rng(0)
    ssm_j = dict(params_j["ssm"])
    for k, lo, hi in (("A_log", -1.0, 1.0), ("dt_bias", -0.5, 1.0),
                      ("D", 0.5, 1.5)):
        ssm_j[k] = jnp.asarray(rng.uniform(lo, hi, ssm_j[k].shape),
                               jnp.float32)
    params_j = dict(params_j, ssm=ssm_j)
    state_j = j_rounds.init_state(model_j, jax.random.PRNGKey(1),
                                  num_clients=3)
    for side in ("client_adapters", "server_adapters"):
        state_j[side] = jax.tree.map(
            lambda v: jnp.asarray(rng.normal(size=v.shape) * 0.05,
                                  jnp.float32), state_j[side])
    state_j["cuts"] = jnp.asarray(CUTS, jnp.int32)
    model_t = build_model(_arch(t_reduced, t_get_config), device="cpu")
    return dict(model_j=model_j, params_j=params_j, state_np=_np(state_j),
                model_t=model_t,
                params_t=bridge.params_from_numpy(_np(params_j), "cpu"),
                batch=_batch(rng, 32))


def _states(setup):
    return (jax.tree.map(jnp.asarray, setup["state_np"]),
            bridge.state_from_numpy(setup["state_np"], "cpu"))


def _close(got_t, want_j, **tol):
    np.testing.assert_allclose(np.asarray(got_t), np.asarray(want_j),
                               **(tol or TOL))


def _assert_tree_close(got, want, **tol):
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    mine = dict((jax.tree_util.keystr(k), v) for k, v in
                jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(mine) == len(flat)
    for k, v in flat:
        np.testing.assert_allclose(mine[jax.tree_util.keystr(k)], v,
                                   err_msg=jax.tree_util.keystr(k), **tol)


# ---------------------------------------------------------------------------
# Config, layout


@pytest.mark.parametrize("shrink", [False, True])
def test_port_config_copy_matches_reference(shrink):
    want = j_get_config("mamba2-780m")
    got = t_get_config("mamba2_780m")
    if shrink:
        want, got = j_reduced(want, **SMALL), t_reduced(got, **SMALL)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_adapter_spec_and_param_layout_match_reference(setup):
    model_j, model_t = setup["model_j"], setup["model_t"]
    assert model_t.adapter_spec() == model_j.adapter_spec()
    assert model_t.adapter_spec() == {"ssm": {"ssm_in": (64, 296),
                                              "ssm_out": (128, 64)}}
    mine = model_t.init_params(torch.Generator().manual_seed(0))
    shapes = lambda tree: {jax.tree_util.keystr(k): tuple(np.shape(v))  # noqa: E731
                           for k, v in
                           jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(bridge.to_numpy(mine)) == shapes(_np(setup["params_j"]))
    assert model_t.runs == model_j.runs
    full = t_get_config("mamba2-780m").model
    assert (t_ssm.in_proj_dim(full), t_ssm.conv_channels(full),
            full.ssm_heads) == (6448, 3328, 48)


# ---------------------------------------------------------------------------
# The SSD block and the model loss


@pytest.mark.parametrize("seq", [32, 24])
def test_ssm_apply_matches_reference(setup, seq):
    """One SSD block with the merged per-client (rank-3) adapters of layer
    1; seq 24 pads to 32 with dt = 0."""
    rng = np.random.default_rng(seq)
    u = rng.normal(size=(3, 2, seq, 64)).astype(np.float32)
    state_j, state_t = _states(setup)
    cfg_j, cfg_t = setup["model_j"].cfg, setup["model_t"].cfg
    p_j = jax.tree.map(lambda v: v[1], setup["params_j"]["ssm"])
    p_t = jax.tree.map(lambda v: v[1], setup["params_t"]["ssm"])
    eff_j = j_split.merge_adapters(setup["model_j"],
                                   state_j["client_adapters"],
                                   state_j["server_adapters"],
                                   state_j["cuts"])
    eff_t = t_split.merge_adapters(setup["model_t"],
                                   state_t["client_adapters"],
                                   state_t["server_adapters"],
                                   state_t["cuts"])
    ad_j = jax.tree.map(lambda v: v[1], eff_j["ssm"])
    ad_t = jax.tree.map(lambda v: v[1], eff_t["ssm"])
    want, _ = j_ssm.ssm_apply(p_j, ad_j, jnp.asarray(u), cfg=cfg_j,
                              policy=NO_SHARDING, mode="train")
    got, cache = t_ssm.ssm_apply(p_t, ad_t, torch.from_numpy(u), cfg=cfg_t,
                                 mode="train")
    assert cache is None and got.shape == (3, 2, seq, 64)
    _close(got, want)


@pytest.mark.parametrize("seq", [32, 24])
def test_model_loss_per_client_matches_reference(setup, seq):
    state_j, state_t = _states(setup)
    batch = _batch(np.random.default_rng(seq + 1), seq)
    eff_j = j_split.merge_adapters(setup["model_j"],
                                   state_j["client_adapters"],
                                   state_j["server_adapters"],
                                   state_j["cuts"])
    eff_t = t_split.merge_adapters(setup["model_t"],
                                   state_t["client_adapters"],
                                   state_t["server_adapters"],
                                   state_t["cuts"])
    per_j, met_j = setup["model_j"].loss(
        setup["params_j"], eff_j, jax.tree.map(jnp.asarray, batch),
        per_client=True)
    per_t, met_t = setup["model_t"].loss(
        setup["params_t"], eff_t,
        {k: torch.from_numpy(v) for k, v in batch.items()}, per_client=True)
    assert per_t.shape == (3,)
    _close(per_t.detach(), per_j)
    for k in ("ce", "accuracy", "tokens"):
        _close(met_t[k].detach(), met_j[k])


# ---------------------------------------------------------------------------
# The round engine


def test_adapter_gradients_match_reference(setup):
    """jax.grad of the weighted round loss vs the port's round_grads."""
    state_j, state_t = _states(setup)
    model_j = setup["model_j"]
    batch_j = jax.tree.map(jnp.asarray, setup["batch"])
    wl = WEIGHTS / WEIGHTS.sum()

    def loss_j(cad, sad):
        eff = j_split.merge_adapters(model_j, cad, sad, state_j["cuts"])
        per, _ = model_j.loss(setup["params_j"], eff, batch_j,
                              per_client=True)
        return jnp.sum(wl * per)

    g_j = jax.grad(loss_j, argnums=(0, 1))(state_j["client_adapters"],
                                           state_j["server_adapters"])
    _, _, gc_t, gs_t = t_rounds.round_grads(
        setup["model_t"], setup["params_t"], state_t, setup["batch"],
        WEIGHTS)
    got = tree_leaves(gc_t) + tree_leaves(gs_t)
    want = jax.tree.leaves(g_j[0]) + jax.tree.leaves(g_j[1])
    assert len(got) == len(want)
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w, rtol=1e-4, atol=1e-4 * scale)


def _one_round(setup, optimizer):
    model_j = j_build_model(_arch(j_reduced, j_get_config, optimizer))
    model_t = build_model(_arch(t_reduced, t_get_config, optimizer),
                          device="cpu")
    state_j, state_t = _states(setup)
    state_j, met_j = j_rounds.make_train_step(model_j)(
        setup["params_j"], state_j, jax.tree.map(jnp.asarray, setup["batch"]),
        jnp.asarray(WEIGHTS), jnp.asarray(ACTIVE), jnp.float32(LR),
        jnp.float32(LR))
    state_t, met_t = t_rounds.make_train_step(model_t)(
        setup["params_t"], state_t, setup["batch"], WEIGHTS, ACTIVE, LR, LR)
    for k in ("total", "ce", "accuracy", "tokens"):
        _close(met_t[k], met_j[k])
    return (model_j, state_j), (model_t, state_t)


def test_sgd_round_matches_reference(setup):
    (_, state_j), (_, state_t) = _one_round(setup, "sgd")
    s_j, s_t = _np(state_j), bridge.to_numpy(state_t)
    for side in ("client_adapters", "server_adapters"):
        _assert_tree_close(s_t[side], s_j[side], rtol=1e-5, atol=1e-5)
    assert s_t["round"] == s_j["round"]


def test_adamw_round_and_eval_step_match_reference(setup):
    """One AdamW round, then the eval step: the global (rank-2) adapters
    through the fused LoRA plain path at ssm_in's ragged width 296."""
    (model_j, state_j), (model_t, state_t) = _one_round(setup, "adamw")
    s_j, s_t = _np(state_j), bridge.to_numpy(state_t)
    for opt in ("opt_c", "opt_s"):
        for mom in ("m", "v"):
            scale = max(float(np.abs(v).max())
                        for v in jax.tree.leaves(s_j[opt][mom]))
            _assert_tree_close(s_t[opt][mom], s_j[opt][mom], rtol=1e-4,
                               atol=1e-4 * scale)
    for side in ("client_adapters", "server_adapters"):
        _assert_tree_close(s_t[side], s_j[side], rtol=0, atol=LR / 50)
    per_j, met_j = j_rounds.make_eval_step(model_j)(
        setup["params_j"], state_j, jax.tree.map(jnp.asarray, setup["batch"]),
        jnp.asarray(WEIGHTS))
    per_t, met_t = t_rounds.make_eval_step(model_t)(
        setup["params_t"], state_t, setup["batch"], WEIGHTS)
    _close(per_t, per_j)
    _close(met_t["accuracy"], met_j["accuracy"])


def test_eval_step_matches_reference_from_one_state(setup):
    state_j, state_t = _states(setup)
    per_j, met_j = j_rounds.make_eval_step(setup["model_j"])(
        setup["params_j"], state_j, jax.tree.map(jnp.asarray, setup["batch"]),
        jnp.asarray(WEIGHTS))
    per_t, met_t = t_rounds.make_eval_step(setup["model_t"])(
        setup["params_t"], state_t, setup["batch"], WEIGHTS)
    _close(per_t, per_j)
    for k in ("ce", "accuracy", "tokens"):
        _close(met_t[k], met_j[k])


def test_ssm_serving_paths_raise(setup):
    """ServingEngine refuses SSM and hybrid models, contiguous and paged,
    as the reference's engine cannot serve them (it installs only k/v
    into a slot and pads prompts to buckets); serial_reference serves
    them (tests/test_torch_ssm_serving.py)."""
    from repro_torch.runtime import serving as t_serving
    for name in ("mamba2-780m", "zamba2-1.2b"):
        model = build_model(t_reduced(t_get_config(name), **SMALL),
                            device="cpu")
        params = model.init_params(torch.Generator().manual_seed(0))
        pool = t_serving.build_adapter_pool(
            model, torch.Generator().manual_seed(1), 2)
        for page_size in (0, 8):
            with pytest.raises(NotImplementedError,
                               match="installs only k/v"):
                t_serving.ServingEngine(
                    model, params, pool,
                    t_serving.ServeConfig(num_slots=2, max_len=32,
                                          page_size=page_size),
                    device="cpu")
