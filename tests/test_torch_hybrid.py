"""The hybrid family of the port against the JAX package: zamba2-1.2b
(SSD layers with attention layers between them; RoPE, GELU MLP, RMSNorm,
an untied head), its config copy and layout at full size, and reduced
(``config.reduced``: 3 layers, d_model 64; layers 0 and 2 SSD with 8
heads of P = 16, state N = 16, chunk 16; layer 1 attention over 4 heads
of 16 with a 256-wide MLP), vocab 256, seq 20 (padded to 32 in the SSD
scan), fp32.

The reference builds the weights and the round-engine state (random
non-zero adapters, so that every adapter has a gradient);
``repro_torch.bridge`` hands the same numpy arrays to the port.  Where
the reference reaches a Pallas kernel it runs as its own CPU tests run
it (its plain path), under ``jax.jit`` as its round step runs.
Tolerances (fp32, sums in another order), as
tests/test_torch_dense_families.py:

  * config copies: equal;
  * logits: 2e-4;
  * per-client losses 1e-4; adapter gradients rtol 1e-4 with an absolute
    floor of 1e-4 of the tree's largest gradient, without smashed
    compression, at cuts [1, 2, 2] and the config's rank at the cut, so
    that the cut layer is an SSD layer for one client and the attention
    layer for two; one SGD round under the config's fp8 smashed
    compressor: adapters 1e-5, metrics 1e-4.
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
from repro.core import smashed as j_smashed  # noqa: E402
from repro.core import split as j_split  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import reduced as t_reduced  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import rounds as t_rounds  # noqa: E402
from repro_torch.core import smashed as t_smashed  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

NAME = "zamba2-1.2b"
SMALL = dict(layers=3, d_model=64, vocab=256, seq_len=20)
SEQ = 20
CUTS = [1, 2, 2]
WEIGHTS = np.array([0.25, 0.25, 0.5], np.float32)
ACTIVE = np.ones(3, np.float32)
LR = 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _arch(reduced, get_config, optimizer="adamw"):
    arch = reduced(get_config(NAME), **SMALL)
    return arch.replace(train=dataclasses.replace(arch.train,
                                                  optimizer=optimizer))


@pytest.fixture(scope="module")
def setup():
    model_j = j_build_model(_arch(j_reduced, j_get_config))
    params_j = model_j.init_params(jax.random.PRNGKey(0))
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
    toks = rng.integers(3, 256, size=(3, 2, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
             "loss_mask": (rng.random((3, 2, SEQ)) > 0.1)
             .astype(np.float32)}
    return dict(model_j=model_j, params_j=params_j, state_np=_np(state_j),
                model_t=build_model(_arch(t_reduced, t_get_config),
                                    device="cpu"),
                params_t=bridge.params_from_numpy(_np(params_j), "cpu"),
                batch=batch)


# ---------------------------------------------------------------------------
# Config and layout


@pytest.mark.parametrize("shrink", [False, True])
def test_config_copy_matches_reference(shrink):
    want, got = j_get_config(NAME), t_get_config("zamba2_1.2b")
    if shrink:
        want, got = j_reduced(want, **SMALL), t_reduced(got, **SMALL)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if not shrink:
        m = got.model
        assert (m.num_layers, m.d_model, m.num_heads, m.num_kv_heads,
                m.head_dim, m.d_ff, m.ssm_state) == (38, 2048, 32, 32, 64,
                                                     8192, 64)
        assert m.attn_layer_indices == (5, 11, 17, 23, 29, 35)
        assert round(m.param_count() / 1e9, 2) == 1.25
        assert (got.lora.r_others, got.lora.r_cut, got.split.cut_layer,
                got.split.cut_buckets, got.split.smashed_compress) == (
                    16, 8, 4, (2, 4, 8, 12, 19), "fp8")


def test_param_layout_and_groups_match_reference(setup):
    """Both groups (the stacked SSD layers, the unrolled attention
    layers), every parameter leaf's layout, the adapter spec and the flat
    execution order; at full size ssm_in's 8384 and ssm_out's 4096."""
    model_j, model_t = setup["model_j"], setup["model_t"]
    assert [(g.name, g.kind, g.layer_ids, g.scan) for g in model_t.groups] \
        == [(g.name, g.kind, g.layer_ids, g.scan) for g in model_j.groups] \
        == [("ssm", "ssm", (0, 2), True), ("attn", "attn_mlp", (1,), False)]
    assert model_t.runs == model_j.runs
    assert model_t.adapter_spec() == model_j.adapter_spec()
    mine = model_t.init_params(torch.Generator().manual_seed(0))
    shapes = lambda tree: {  # noqa: E731
        jax.tree_util.keystr(k): tuple(np.shape(v))
        for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(bridge.to_numpy(mine)) == shapes(_np(setup["params_j"]))
    full = build_model(t_get_config(NAME), device="cpu")
    assert full.adapter_spec() == {
        "ssm": {"ssm_in": (2048, 8384), "ssm_out": (4096, 2048)},
        "attn": {"q": (2048, 2048), "k": (2048, 2048), "v": (2048, 2048),
                 "o": (2048, 2048)}}
    assert (t_ssm.conv_channels(full.cfg), full.cfg.ssm_heads) == (4224, 64)


# ---------------------------------------------------------------------------
# Logits


def test_logits_match_reference(setup):
    """The train-mode forward and untied head over SEQ tokens: SSD,
    attention with RoPE and the GELU MLP, SSD."""
    toks = np.random.default_rng(1).integers(0, 256, (2, SEQ)) \
        .astype(np.int32)
    model_j, params_j = setup["model_j"], setup["params_j"]
    want = jax.jit(lambda p, t: model_j.head(p, model_j.forward(
        p, None, {"tokens": t})[0]))(params_j, jnp.asarray(toks))
    with torch.no_grad():
        model_t, params_t = setup["model_t"], setup["params_t"]
        got = model_t.head(params_t, model_t.forward(
            params_t, None, {"tokens": torch.from_numpy(toks)})[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------------------------
# The sync round engine


def test_round_losses_and_gradients_match_reference(setup):
    """Per-client losses and the client and server adapters' gradients of
    the weighted round loss (jax.grad against round_grads) at cuts
    [1, 2, 2] with the rank at the cut, uncompressed."""
    model_j, model_t = setup["model_j"], setup["model_t"]
    state_j = jax.tree.map(jnp.asarray, setup["state_np"])
    state_t = bridge.state_from_numpy(setup["state_np"], "cpu")
    b_j = j_smashed.make_boundary(j_smashed.make_compressor("none"),
                                  state_j["cuts"])
    b_t = t_smashed.make_boundary(t_smashed.make_compressor("none"),
                                  state_t["cuts"])
    batch_j = jax.tree.map(jnp.asarray, setup["batch"])
    wl = WEIGHTS / WEIGHTS.sum()

    def loss_j(cad, sad):
        eff = j_split.merge_adapters(model_j, cad, sad, state_j["cuts"],
                                     rank_cut=state_j.get("rank_cut"))
        per, _ = model_j.loss(setup["params_j"], eff, batch_j,
                              per_client=True, boundary=b_j)
        return jnp.sum(wl * per), per

    (_, per_j), g_j = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1),
                                                 has_aux=True))(
        state_j["client_adapters"], state_j["server_adapters"])
    _, met_t, gc_t, gs_t = t_rounds.round_grads(
        model_t, setup["params_t"], state_t, setup["batch"], WEIGHTS,
        boundary=b_t)
    np.testing.assert_allclose(met_t["ce"].detach().numpy(),
                               np.asarray(per_j), rtol=1e-4, atol=1e-4)
    got = tree_leaves(gc_t) + tree_leaves(gs_t)
    want = jax.tree.leaves(g_j[0]) + jax.tree.leaves(g_j[1])
    assert len(got) == len(want)
    floor = 1e-4 * max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=floor)


def test_fp8_sgd_round_matches_reference(setup):
    """One round of make_train_step (SGD) under the config's fp8 smashed
    compressor: FedAvg, the broadcast, every client row and the server
    adapters, and the metrics."""
    model_j = j_build_model(_arch(j_reduced, j_get_config, "sgd"))
    model_t = build_model(_arch(t_reduced, t_get_config, "sgd"),
                          device="cpu")
    assert model_t.arch.split.smashed_compress == "fp8"
    step_j = j_rounds.make_train_step(model_j, smashed_compress="fp8")
    step_t = t_rounds.make_train_step(model_t, smashed_compress="fp8")
    state_j, met_j = step_j(setup["params_j"],
                            jax.tree.map(jnp.asarray, setup["state_np"]),
                            jax.tree.map(jnp.asarray, setup["batch"]),
                            jnp.asarray(WEIGHTS), jnp.asarray(ACTIVE),
                            jnp.float32(LR), jnp.float32(LR))
    state_t, met_t = step_t(setup["params_t"],
                            bridge.state_from_numpy(setup["state_np"], "cpu"),
                            setup["batch"], WEIGHTS, ACTIVE, LR, LR)
    got, want = bridge.to_numpy(state_t), _np(state_j)
    for side in ("client_adapters", "server_adapters"):
        flat = jax.tree_util.tree_flatten_with_path(want[side])[0]
        mine = dict((jax.tree_util.keystr(k), v) for k, v in
                    jax.tree_util.tree_flatten_with_path(got[side])[0])
        for k, v in flat:
            np.testing.assert_allclose(mine[jax.tree_util.keystr(k)], v,
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(k))
    met_t = bridge.to_numpy(met_t)
    for k in ("total", "ce", "accuracy", "tokens"):
        np.testing.assert_allclose(met_t[k], np.asarray(met_j[k]),
                                   rtol=1e-4, atol=1e-4)
