"""The dense family of the port against the JAX package: opt-125m,
gpt-neo-125m (a 32-wide window on its odd layers once reduced), llama3-8b,
phi4-mini-3.8b, qwen1.5-32b and mistral-large-123b, each reduced
(``config.reduced``: d_model 64 over 4 heads of 16), and llama3-8b also
at d_model 256 over 2 heads of 128 with one kv head (head dim 128, GQA
2:1).

The reference builds the weights, the round-engine state and the adapter
pool; ``repro_torch.bridge`` hands the same numpy arrays to the port.
Where the reference reaches a Pallas kernel it runs as its own CPU tests
run it (its plain path).  Tolerances (fp32, sums in another order):

  * config copies: equal;
  * RoPE's angles and rotated tensors: 1e-6;
  * logits: 2e-4;
  * per-client losses 1e-4; adapter gradients rtol 1e-4 with an absolute
    floor of 1e-4 of the tree's largest gradient, without smashed
    compression; one SGD round's adapters 1e-5, under the config's
    compressor (int8 for llama3-8b): as tests/test_torch_rounds.py.  The
    gradients are compared uncompressed because under int8 an element
    within fp32 noise of a rounding boundary takes the neighbouring code
    on one side only, and on this data that moves two of reduced
    llama3-8b's 1152 gradient elements of one adapter by 1.3 x the int8
    floor of tests/test_torch_rounds.py (1e-3 of the largest gradient);
    after an SGD step at lr 1e-2 that is 1.6e-6, inside 1e-5;
  * served tokens: equal, contiguous and paged.
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
from repro.models import common as j_common  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.runtime import serving as j_serving  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import reduced as t_reduced  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import rounds as t_rounds  # noqa: E402
from repro_torch.core import smashed as t_smashed  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import serving as t_serving  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

DENSE = ["opt-125m", "gpt-neo-125m", "llama3-8b", "phi4-mini-3.8b",
         "qwen1.5-32b", "mistral-large-123b"]
# llama3-8b at head dim 128: d_model 256 over 2 heads, 1 kv head
HD128 = "llama3-8b-hd128"
SEQ = 48                      # past gpt-neo's reduced window of 32
LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
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


def _arch(case, reduced, get_config, layers=2):
    """One reduced arch of either package; HD128 widens llama3-8b's heads
    to 128 (2 query heads over 1 kv head at d_model 256)."""
    name = "llama3-8b" if case == HD128 else case
    kw = dict(layers=layers, seq_len=SEQ, vocab=256)
    if case == HD128:
        kw["d_model"] = 256
    arch = reduced(get_config(name), **kw)
    if case == HD128:
        arch = arch.replace(model=dataclasses.replace(
            arch.model, num_heads=2, num_kv_heads=1, head_dim=128))
    return arch


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(case, layers=2):
    """(JAX model, params), (port model, params): the same weights."""
    model_j = j_build_model(_arch(case, j_reduced, j_get_config, layers))
    params_j = model_j.init_params(jax.random.PRNGKey(0))
    model_t = build_model(_arch(case, t_reduced, t_get_config, layers),
                          device="cpu")
    return (model_j, params_j), (model_t,
                                 bridge.params_from_numpy(_np(params_j),
                                                          "cpu"))


# ---------------------------------------------------------------------------
# Configs and parameters


@pytest.mark.parametrize("shrink", [False, True])
@pytest.mark.parametrize("name", DENSE)
def test_config_copies_match_reference(name, shrink):
    want, got = j_get_config(name), t_get_config(name)
    if shrink:
        want, got = j_reduced(want), t_reduced(got)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("case", DENSE + [HD128])
def test_init_params_layout_matches_reference(case):
    """Every leaf the reference has (embed.head and embed.pos where the
    config has them, bq/bk/bv/bo, b_in/b_out, w_gate) with its layout,
    the adapter spec and the per-layer windows."""
    (model_j, params_j), (model_t, params_t) = _pair(case)
    mine = model_t.init_params(torch.Generator().manual_seed(0))
    shapes = lambda tree: {  # noqa: E731
        jax.tree_util.keystr(k): tuple(np.shape(v))
        for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(bridge.to_numpy(mine)) == shapes(_np(params_j))
    assert shapes(bridge.to_numpy(params_t)) == shapes(_np(params_j))
    assert model_t.adapter_spec() == model_j.adapter_spec()
    assert model_t.runs == model_j.runs
    assert [g.windows for g in model_t.groups] == [
        g.windows for g in model_j.groups]


# ---------------------------------------------------------------------------
# RoPE


@pytest.mark.parametrize("head_dim", [16, 128])
@pytest.mark.parametrize("mode", ["train", "decode"])
def test_rope_matches_reference(mode, head_dim):
    """Angles at train positions (0..S-1) and decode positions (each
    slot's cache length, (B, 1)), and q-shaped tensors rotated by them."""
    rng = np.random.default_rng(head_dim)
    if mode == "train":
        pos = np.arange(SEQ, dtype=np.int32)
        x = rng.normal(size=(2, 3, SEQ, 4, head_dim)).astype(np.float32)
    else:
        pos = np.array([[0], [7], [31], [4095]], np.int32)
        x = rng.normal(size=(4, 1, 4, head_dim)).astype(np.float32)
    cos_j, sin_j = j_common.rope_angles(jnp.asarray(pos), head_dim, 5e5)
    cos_t, sin_t = t_common.rope_angles(torch.from_numpy(pos), head_dim,
                                        5e5)
    assert cos_t.dtype == torch.float32 and cos_t.shape == cos_j.shape
    for got, want in ((cos_t, cos_j), (sin_t, sin_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    got = t_common.apply_rope(torch.from_numpy(x), cos_t, sin_t)
    want = j_common.apply_rope(jnp.asarray(x), cos_j, sin_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_rope_keeps_bfloat16():
    x = torch.randn(2, 5, 3, 16).to(torch.bfloat16)
    cos, sin = t_common.rope_angles(torch.arange(5), 16, 1e4)
    assert t_common.apply_rope(x, cos, sin).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Logits


@pytest.mark.parametrize("case", DENSE + [HD128])
def test_logits_match_reference(case):
    """The full forward and head over SEQ tokens from the same weights:
    learned positions or RoPE, LayerNorm or RMSNorm, GELU, ReLU or
    SwiGLU, biases, tied or untied heads, GQA, gpt-neo's window."""
    (model_j, params_j), (model_t, params_t) = _pair(case)
    toks = np.random.default_rng(1).integers(0, 256, (2, SEQ)) \
        .astype(np.int32)
    x_j = model_j.forward(params_j, None, {"tokens": jnp.asarray(toks)})[0]
    want = model_j.head(params_j, x_j)
    with torch.no_grad():
        x_t = model_t.forward(params_t, None,
                              {"tokens": torch.from_numpy(toks)})[0]
        got = model_t.head(params_t, x_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)


# ---------------------------------------------------------------------------
# The sync round engine


def _round_setup(case):
    (model_j, params_j), (model_t, params_t) = _pair(case, layers=3)
    state_j = j_rounds.init_state(model_j, jax.random.PRNGKey(1),
                                  num_clients=3)
    rng = np.random.default_rng(0)
    for side in ("client_adapters", "server_adapters"):
        state_j[side] = jax.tree.map(
            lambda v: jnp.asarray(rng.normal(size=v.shape) * 0.05,
                                  jnp.float32), state_j[side])
    state_j["cuts"] = jnp.asarray(CUTS, jnp.int32)
    toks = rng.integers(3, 256, size=(3, 2, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
             "loss_mask": (rng.random((3, 2, SEQ)) > 0.1)
             .astype(np.float32)}
    comp = model_t.arch.split.smashed_compress
    return dict(model_j=model_j, params_j=params_j, model_t=model_t,
                params_t=params_t, state_np=_np(state_j), batch=batch,
                comp=comp)


@pytest.fixture(scope="module", params=["llama3-8b", "gpt-neo-125m"])
def rounds_setup(request):
    return _round_setup(request.param)


def test_round_losses_and_gradients_match_reference(rounds_setup):
    """Per-client losses and the client and server adapters' gradients of
    the weighted round loss (jax.grad against round_grads, f1-f5) at cuts
    [1, 2, 2], without smashed compression (see the module docstring);
    gpt-neo's window of 32 bites at SEQ 48."""
    s = rounds_setup
    model_j, model_t = s["model_j"], s["model_t"]
    state_j = jax.tree.map(jnp.asarray, s["state_np"])
    state_t = bridge.state_from_numpy(s["state_np"], "cpu")
    b_j = j_smashed.make_boundary(j_smashed.make_compressor("none"),
                                  state_j["cuts"])
    b_t = t_smashed.make_boundary(t_smashed.make_compressor("none"),
                                  state_t["cuts"])
    batch_j = jax.tree.map(jnp.asarray, s["batch"])
    wl = WEIGHTS / WEIGHTS.sum()

    def loss_j(cad, sad):
        eff = j_split.merge_adapters(model_j, cad, sad, state_j["cuts"])
        per, _ = model_j.loss(s["params_j"], eff, batch_j, per_client=True,
                              boundary=b_j)
        return jnp.sum(wl * per), per

    (_, per_j), g_j = jax.value_and_grad(loss_j, argnums=(0, 1),
                                         has_aux=True)(
        state_j["client_adapters"], state_j["server_adapters"])
    _, met_t, gc_t, gs_t = t_rounds.round_grads(
        model_t, s["params_t"], state_t, s["batch"], WEIGHTS, boundary=b_t)
    np.testing.assert_allclose(met_t["ce"].detach().numpy(),
                               np.asarray(per_j), rtol=1e-4, atol=1e-4)
    got = tree_leaves(gc_t) + tree_leaves(gs_t)
    want = jax.tree.leaves(g_j[0]) + jax.tree.leaves(g_j[1])
    assert len(got) == len(want)
    floor = 1e-4 * max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=floor)


def test_sgd_round_matches_reference(rounds_setup):
    """One round of make_train_step (SGD) under the config's smashed
    compressor (int8 for llama3-8b, none for gpt-neo): FedAvg, the
    broadcast, every client row and the server adapters, and the
    metrics."""
    s = rounds_setup
    sgd = lambda arch: arch.replace(train=dataclasses.replace(  # noqa: E731
        arch.train, optimizer="sgd"))
    model_j = j_build_model(sgd(s["model_j"].arch))
    model_t = build_model(sgd(s["model_t"].arch), device="cpu")
    step_j = j_rounds.make_train_step(model_j, smashed_compress=s["comp"])
    step_t = t_rounds.make_train_step(model_t, smashed_compress=s["comp"])
    state_j, met_j = step_j(s["params_j"],
                            jax.tree.map(jnp.asarray, s["state_np"]),
                            jax.tree.map(jnp.asarray, s["batch"]),
                            jnp.asarray(WEIGHTS), jnp.asarray(ACTIVE),
                            jnp.float32(LR), jnp.float32(LR))
    state_t, met_t = step_t(s["params_t"],
                            bridge.state_from_numpy(s["state_np"], "cpu"),
                            s["batch"], WEIGHTS, ACTIVE, LR, LR)
    got, want = bridge.to_numpy(state_t), _np(state_j)
    for side in ("client_adapters", "server_adapters"):
        flat = jax.tree_util.tree_flatten_with_path(want[side])[0]
        mine = dict((jax.tree_util.keystr(k), v) for k, v in
                    jax.tree_util.tree_flatten_with_path(got[side])[0])
        for k, v in flat:
            np.testing.assert_allclose(mine[jax.tree_util.keystr(k)], v,
                                       rtol=1e-5, atol=1e-5)
    met_t = bridge.to_numpy(met_t)
    for k in ("total", "ce", "accuracy", "tokens"):
        np.testing.assert_allclose(met_t[k], np.asarray(met_j[k]),
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Serving


@pytest.mark.parametrize("page_size", [0, 8])
@pytest.mark.parametrize("case", ["llama3-8b", "gpt-neo-125m"])
def test_serving_tokens_equal_jax_engine(case, page_size):
    """The port's engine against the JAX engine on the same weights and
    pool: prompts of 20 to 35 tokens and up to 12 new ones, so that
    prefill and decode run past gpt-neo's window of 32, and RoPE's
    positions through the prefill (from 0 per request) and decode (each
    slot's cache length); contiguous and in 8-token pages."""
    (model_j, params_j), (model_t, params_t) = _pair(case)
    pool_j = j_serving.build_adapter_pool(model_j, jax.random.PRNGKey(1), 3,
                                          ranks=[4, 2, 4])
    pool_t = bridge.pool_from_numpy(_np(pool_j), "cpu")
    rng = np.random.default_rng(7)
    reqs = [dict(rid=i, adapter=i % 3,
                 tokens=rng.integers(3, 250, size=int(rng.integers(20, 36))),
                 max_new=int(rng.integers(8, 13))) for i in range(4)]
    cfg = dict(num_slots=2, max_len=SEQ, page_size=page_size)
    want = j_serving.ServingEngine(
        model_j, params_j, pool_j, j_serving.ServeConfig(**cfg)).run(
        [j_serving.Request(**r) for r in reqs])
    got = t_serving.ServingEngine(
        model_t, params_t, pool_t, t_serving.ServeConfig(**cfg),
        device="cpu").run([t_serving.Request(**r) for r in reqs])
    assert [r["tokens"] for r in got] == [r["tokens"] for r in want]
    assert max(len(r["tokens"]) + len(q["tokens"])
               for r, q in zip(got, reqs)) > 32
