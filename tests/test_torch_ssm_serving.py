"""SSM prefill and decode through the recurrent cache, the port against
the JAX package: mamba2-780m and zamba2-1.2b, each reduced
(``config.reduced``: 3 layers, d_model 64, 8 SSD heads of P = 16, state
N = 16, chunk 16, conv width 4; zamba2's layer 1 is attention over 4
heads of 16), vocab 256, fp32.

The reference builds the weights (non-trivial per-head decays, dt biases
and skips), the adapter pool and, where a test starts from one, the
cache; ``repro_torch.bridge`` hands the same numpy arrays to the port.
Where the reference reaches a Pallas kernel it runs as its own CPU tests
run it (its plain path); its prefill, decode step and forward run under
``jax.jit``, as its engine and round step run them (eager JAX compiles
every op anew for each prompt length).  Tolerances (fp32, sums in
another order):

  * the SSD oracles' outputs and states: 1e-5;
  * one SSD block's output and its new cache: 1e-4;
  * logits: 2e-4, as the reference's own prefill-then-decode test;
  * served tokens: equal.

The reference's prefill is wrong for prompts shorter than W - 1 = 3: it
keeps ``xbc[..., -(W-1):, :]``, which has only s rows then, and writes
them at the start of the conv window.  The port left-pads the window
with zeros, the function the reference means.  So for prompts of 1 and
2 tokens the port's prefill then decode is held against the reference's
train-mode forward over the same tokens, and for longer ones against the
reference's own prefill then decode.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels.ssd_scan import ref as j_ssd_ref  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.models.common import NO_SHARDING  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.runtime import serving as j_serving  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import reduced as t_reduced  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as t_ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as t_ssd_ref  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import serving as t_serving  # noqa: E402

ARCHS = ["mamba2-780m", "zamba2-1.2b"]
SMALL = dict(layers=3, d_model=64, vocab=256)
SEQ = 20
LOGITS_TOL = dict(rtol=2e-4, atol=2e-4)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class _Jitted:
    """The reference's model with prefill, decode_step and the logits of
    a train-mode forward under jax.jit; every other attribute its own."""

    def __init__(self, model):
        self._model = model
        self.prefill = jax.jit(model.prefill)
        self.decode_step = jax.jit(model.decode_step)
        self.logits = jax.jit(lambda p, toks: model.head(
            p, model.forward(p, None, {"tokens": toks})[0]))

    def __getattr__(self, name):
        return getattr(self._model, name)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX model, params), (port model, params): the same weights, with
    per-head decay rates, dt biases and skips drawn from a seed."""
    model_j = j_build_model(j_reduced(j_get_config(name), **SMALL))
    params_j = model_j.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    ssm_j = dict(params_j["ssm"])
    for k, lo, hi in (("A_log", -1.0, 1.0), ("dt_bias", -0.5, 1.0),
                      ("D", 0.5, 1.5)):
        ssm_j[k] = jnp.asarray(rng.uniform(lo, hi, ssm_j[k].shape),
                               jnp.float32)
    params_j = dict(params_j, ssm=ssm_j)
    model_t = build_model(t_reduced(t_get_config(name), **SMALL),
                          device="cpu")
    return (_Jitted(model_j), params_j), (
        model_t, bridge.params_from_numpy(_np(params_j), "cpu"))


def _tokens(seed, b=2, s=SEQ):
    return np.random.default_rng(seed).integers(3, 256, (b, s)) \
        .astype(np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or BLOCK_TOL))


# ---------------------------------------------------------------------------
# The SSD oracles


def _ssd_inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)) + 0.5)) \
        .astype(np.float32)
    a = -np.exp(rng.normal(size=(h,)) * 0.5).astype(np.float32)
    bm = (rng.normal(size=(b, s, g, n)) * 0.3).astype(np.float32)
    c = (rng.normal(size=(b, s, g, n)) * 0.3).astype(np.float32)
    h0 = (rng.normal(size=(b, h, p, n)) * 0.1).astype(np.float32)
    return x, dt, a, bm, c, h0


@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_ssd_chunked_final_state_matches_reference(chunk):
    """ssd_chunked(return_state=True), from zero and from an h0, at
    chunks of 1, 5 and the whole sequence: y and the final state, and the
    public wrapper's CPU route; bf16 keeps the reference's state dtype."""
    x, dt, a, bm, c, h0 = _ssd_inputs(chunk, 2, 15 if chunk == 5 else 16,
                                      4, 8, 2, 16)
    if chunk == 16:
        x, dt, bm, c = x[:, :16], dt[:, :16], bm[:, :16], c[:, :16]
    j = [jnp.asarray(v) for v in (x, dt, a, bm, c)]
    t = [torch.from_numpy(v) for v in (x, dt, a, bm, c)]
    for init in (None, h0):
        want = j_ssd_ref.ssd_chunked(
            *j, None if init is None else jnp.asarray(init), chunk=chunk,
            return_state=True)
        got = t_ssd_ref.ssd_chunked(
            *t, None if init is None else torch.from_numpy(init),
            chunk=chunk, return_state=True)
        for g_, w_ in zip(got, want):
            _close(g_, w_, rtol=1e-5, atol=1e-5)
    got = t_ssd_ops.ssd_scan(*t, chunk=chunk, return_state=True)
    want = j_ssd_ref.ssd_chunked(*j, chunk=chunk, return_state=True)
    _close(got[1], want[1], rtol=1e-5, atol=1e-5)
    jb = [v.astype(jnp.bfloat16) if v.ndim == 4 else v for v in j]
    tb = [v.to(torch.bfloat16) if v.dim() == 4 else v for v in t]
    want = j_ssd_ref.ssd_chunked(*jb, chunk=chunk, return_state=True)
    got = t_ssd_ref.ssd_chunked(*tb, chunk=chunk, return_state=True)
    assert got[1].dtype == torch.bfloat16 and want[1].dtype == jnp.bfloat16
    _close(got[1].float(), np.asarray(want[1].astype(jnp.float32)),
           rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_matches_reference(g):
    """Eight one-token steps of the recurrence from an h0, each output and
    state against the reference's, and the last state against the
    chunked scan's over the same tokens."""
    x, dt, a, bm, c, h0 = _ssd_inputs(g, 3, 8, 4, 8, g, 16)
    st_j, st_t = jnp.asarray(h0), torch.from_numpy(h0)
    for i in range(8):
        y_j, st_j = j_ssd_ref.ssd_decode_step(
            st_j, jnp.asarray(x[:, i]), jnp.asarray(dt[:, i]),
            jnp.asarray(a), jnp.asarray(bm[:, i]), jnp.asarray(c[:, i]))
        y_t, st_t = t_ssd_ref.ssd_decode_step(
            st_t, torch.from_numpy(x[:, i]), torch.from_numpy(dt[:, i]),
            torch.from_numpy(a), torch.from_numpy(bm[:, i]),
            torch.from_numpy(c[:, i]))
        _close(y_t, y_j, rtol=1e-5, atol=1e-5)
        _close(st_t, st_j, rtol=1e-5, atol=1e-5)
    _, whole = t_ssd_ref.ssd_chunked(
        *(torch.from_numpy(v) for v in (x, dt, a, bm, c)),
        torch.from_numpy(h0), chunk=4, return_state=True)
    _close(st_t, whole, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# One SSD block with a cache


def _block(name):
    """The reference's ssm_apply of layer 0 under jit (prefill, decode),
    the port's config and layer 0's weights."""
    (model_j, params_j), (model_t, params_t) = _pair(name)
    p_j = jax.tree.map(lambda v: v[0], params_j["ssm"])
    p_t = jax.tree.map(lambda v: v[0], params_t["ssm"])
    apply_j = {mode: jax.jit(functools.partial(
        j_ssm.ssm_apply, p_j, None, cfg=model_j.cfg, policy=NO_SHARDING,
        mode=mode)) for mode in ("prefill", "decode")}
    return model_j.cfg, apply_j, model_t.cfg, p_t


@pytest.mark.parametrize("prompt", [3, 20])
@pytest.mark.parametrize("name", ARCHS)
def test_ssm_apply_prefill_and_decode_match_reference(name, prompt):
    """ssm_apply in prefill with a fresh cache (the new conv window and
    final state) and then three decode steps, each output and new cache
    against the reference's; 20 tokens pad to 32 at chunk 16."""
    cfg_j, apply_j, cfg_t, p_t = _block(name)
    u = np.random.default_rng(prompt).normal(
        size=(2, prompt + 3, 64)).astype(np.float32)
    c_j = j_ssm.init_ssm_cache(cfg_j, (2,), jnp.float32)
    c_t = t_ssm.init_ssm_cache(cfg_t, (2,), torch.float32)
    out_j, c_j = apply_j["prefill"](jnp.asarray(u[:, :prompt]), cache=c_j)
    out_t, c_t = t_ssm.ssm_apply(p_t, None, torch.from_numpy(u[:, :prompt]),
                                 cfg=cfg_t, mode="prefill", cache=c_t)
    _close(out_t, out_j)
    for k in ("conv", "state"):
        assert c_t[k].dtype == torch.float32
        _close(c_t[k], c_j[k])
    for i in range(prompt, prompt + 3):
        out_j, c_j = apply_j["decode"](jnp.asarray(u[:, i:i + 1]),
                                       cache=c_j)
        out_t, c_t = t_ssm.ssm_apply(p_t, None,
                                     torch.from_numpy(u[:, i:i + 1]),
                                     cfg=cfg_t, mode="decode", cache=c_t)
        _close(out_t, out_j)
        for k in ("conv", "state"):
            _close(c_t[k], c_j[k])


@pytest.mark.parametrize("prompt", [1, 2])
def test_short_prefill_keeps_a_zero_padded_conv_window(prompt):
    """A prompt shorter than W - 1: the output equals the reference's, and
    the window holds W - 1 - s zero rows, then the s rows the reference
    keeps (it writes those at the window's start instead)."""
    cfg_j, apply_j, cfg_t, p_t = _block("mamba2-780m")
    u = np.random.default_rng(prompt).normal(
        size=(2, prompt, 64)).astype(np.float32)
    out_j, c_j = apply_j["prefill"](
        jnp.asarray(u), cache=j_ssm.init_ssm_cache(cfg_j, (2,), jnp.float32))
    out_t, c_t = t_ssm.ssm_apply(
        p_t, None, torch.from_numpy(u), cfg=cfg_t, mode="prefill",
        cache=t_ssm.init_ssm_cache(cfg_t, (2,), torch.float32))
    _close(out_t, out_j)
    _close(c_t["state"], c_j["state"])
    width = cfg_t.ssm_conv_width
    assert c_t["conv"].shape == (2, width - 1, t_ssm.conv_channels(cfg_t))
    assert c_j["conv"].shape[-2] == prompt
    assert not c_t["conv"][:, :width - 1 - prompt].any()
    _close(c_t["conv"][:, width - 1 - prompt:], c_j["conv"])


@pytest.mark.parametrize("name", ARCHS)
def test_init_cache_layout_matches_reference(name):
    """Every leaf of Model.init_cache((B,), max_len): names, shapes and
    dtypes (the conv window in the cache dtype, the state in fp32, the
    attention layers' k/v), all zeros; and bridge.cache_from_numpy."""
    (model_j, _), (model_t, _) = _pair(name)
    for dtype_j, dtype_t in ((jnp.float32, torch.float32),
                             (jnp.bfloat16, torch.bfloat16)):
        want = model_j.init_cache((2,), 24, dtype_j)
        got = model_t.init_cache((2,), 24, dtype_t)
        flat_j = {jax.tree_util.keystr(k): v for k, v in
                  jax.tree_util.tree_flatten_with_path(want)[0]}
        flat_t = {jax.tree_util.keystr(k): v for k, v in
                  jax.tree_util.tree_flatten_with_path(got)[0]}
        assert sorted(flat_t) == sorted(flat_j)
        for k, v in flat_j.items():
            assert tuple(flat_t[k].shape) == v.shape, k
            assert str(flat_t[k].dtype).split(".")[-1] == str(v.dtype), k
            assert not flat_t[k].float().any()
    ported = bridge.cache_from_numpy(_np(model_j.init_cache((2,), 24)), "cpu")
    assert ported["len"].dtype == torch.int32
    assert ported["ssm"]["state"].dtype == torch.float32
    assert ported["ssm"]["conv"].shape == (3 if name == "mamba2-780m" else 2,
                                           2, 3, t_ssm.conv_channels(
                                               model_t.cfg))


# ---------------------------------------------------------------------------
# Prefill then decode through the model


@pytest.mark.parametrize("prompt", [1, 2, 3, 17])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_then_decode_logits_match_reference(name, prompt):
    """Model.prefill of `prompt` tokens, then decode_step to SEQ: logits
    at 2e-4 against the reference's prefill then decode (prompts >= 3,
    whose caches also agree after the prefill) or its train-mode forward
    (prompts of 1 and 2, module docstring).  zamba2's attention layer
    reads RoPE at the cache length."""
    (model_j, params_j), (model_t, params_t) = _pair(name)
    toks = _tokens(prompt)
    want = np.asarray(model_j.logits(params_j, jnp.asarray(toks)))
    got = []
    with torch.no_grad():
        cache = model_t.init_cache((2,), SEQ)
        lg, cache = model_t.prefill(
            params_t, None, {"tokens": torch.from_numpy(toks[:, :prompt])},
            cache)
        got.append(lg[:, -1].numpy())
        if prompt >= 3:
            lg_j, c_j = model_j.prefill(
                params_j, None, {"tokens": jnp.asarray(toks[:, :prompt])},
                model_j.init_cache((2,), SEQ))
            _close(lg[:, -1], lg_j[:, -1], **LOGITS_TOL)
            flat = jax.tree_util.tree_flatten_with_path(_np(c_j))[0]
            mine = {jax.tree_util.keystr(k): v for k, v in
                    jax.tree_util.tree_flatten_with_path(
                        bridge.to_numpy(cache))[0]}
            for k, v in flat:
                _close(mine[jax.tree_util.keystr(k)], v, **LOGITS_TOL)
            want_steps = []
            for t in range(prompt, SEQ):
                lg_j, c_j = model_j.decode_step(
                    params_j, None, jnp.asarray(toks[:, t:t + 1]), c_j)
                want_steps.append(np.asarray(lg_j[:, 0]))
        for t in range(prompt, SEQ):
            lg, cache = model_t.decode_step(
                params_t, None, torch.from_numpy(toks[:, t:t + 1]), cache)
            got.append(lg[:, 0].numpy())
    got = np.stack(got, 1)
    if prompt >= 3:
        _close(got[:, 1:], np.stack(want_steps, 1), **LOGITS_TOL)
    _close(got, want[:, prompt - 1:], **LOGITS_TOL)
    assert int(cache["len"][0]) == SEQ


@pytest.mark.parametrize("name", ARCHS)
def test_decode_from_the_reference_cache(name):
    """Both packages start from the reference's cache after a 9-token
    prefill (handed over by bridge.cache_from_numpy) and decode 4
    tokens: logits and the final caches agree."""
    (model_j, params_j), (model_t, params_t) = _pair(name)
    toks = _tokens(11)
    _, c_j = model_j.prefill(params_j, None,
                             {"tokens": jnp.asarray(toks[:, :9])},
                             model_j.init_cache((2,), 16))
    cache = bridge.cache_from_numpy(_np(c_j), "cpu")
    with torch.no_grad():
        for t in range(9, 13):
            lg_j, c_j = model_j.decode_step(
                params_j, None, jnp.asarray(toks[:, t:t + 1]), c_j)
            lg_t, cache = model_t.decode_step(
                params_t, None, torch.from_numpy(toks[:, t:t + 1]), cache)
            _close(lg_t[:, 0], lg_j[:, 0], **LOGITS_TOL)
    for k, v in jax.tree_util.tree_flatten_with_path(_np(c_j))[0]:
        mine = {jax.tree_util.keystr(kk): vv for kk, vv in
                jax.tree_util.tree_flatten_with_path(
                    bridge.to_numpy(cache))[0]}
        _close(mine[jax.tree_util.keystr(k)], v, **LOGITS_TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_serial_reference_tokens_equal_reference(name):
    """serial_reference with the indexed pool (3 adapters, ranks 4, 2, 4):
    4 requests of 3 to 18 prompt tokens and 4 to 8 new ones, one at a
    time through prefill and decode, the tokens equal to the
    reference's."""
    (model_j, params_j), (model_t, params_t) = _pair(name)
    pool_j = j_serving.build_adapter_pool(model_j, jax.random.PRNGKey(1), 3,
                                          ranks=[4, 2, 4])
    pool_t = bridge.pool_from_numpy(_np(pool_j), "cpu")
    rng = np.random.default_rng(5)
    reqs = [dict(rid=i, adapter=i % 3,
                 tokens=rng.integers(3, 250, size=int(rng.integers(3, 19))),
                 max_new=int(rng.integers(4, 9))) for i in range(4)]
    want = j_serving.serial_reference(
        model_j, params_j, pool_j, [j_serving.Request(**r) for r in reqs],
        max_len=SEQ + 8)
    got = t_serving.serial_reference(
        model_t, params_t, pool_t, [t_serving.Request(**r) for r in reqs],
        max_len=SEQ + 8)
    assert got == want
