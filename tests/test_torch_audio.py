"""The audio family of the port against the JAX package: whisper-medium
reduced (2 encoder and 2 decoder layers, d_model 64 over 4 heads of 16,
the encoder over 16 frames, or 24 for a ragged 8-key tail past a
16-key block), whose batches carry encoder "frames" that the encoder
turns into the decoder's cross-attention memory; and the learning-rate
schedules.

The reference builds the weights, the round-engine state and the frames
(normal x 0.02, as its tests draw them); ``repro_torch.bridge`` hands
the same numpy arrays to the port.  Tolerances as
tests/test_torch_vlm.py: encoder output and logits 2e-4; per-client
losses 1e-4; adapter gradients rtol 1e-4 with an absolute floor of 1e-4
of the tree's largest gradient; an SGD step's adapters 1e-5.  The
reference's flash and decode wrappers run their plain jnp versions on
the CPU; the port's take their plain PyTorch versions.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import SHAPES  # noqa: E402
from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import rounds as j_rounds  # noqa: E402
from repro.core import smashed as j_smashed  # noqa: E402
from repro.core import split as j_split  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.optim.schedule import make_schedule as j_schedule  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import reduced as t_reduced  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import rounds as t_rounds  # noqa: E402
from repro_torch.core import smashed as t_smashed  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.schedule import make_schedule  # noqa: E402
from repro_torch.runtime import serving  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

AUDIO = "whisper-medium"
SEQ = 12
TOL = dict(rtol=2e-4, atol=2e-4)
CUTS = [1, 2, 2]         # inside the encoder, at its last layer (twice)
WEIGHTS = np.array([0.25, 0.25, 0.5], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _archs(enc_len=16, targets=None):
    """Reduced whisper in both packages: 2 + 2 layers at d_model 64,
    encoder_seq_len enc_len, LoRA targets as the config's unless given."""
    kw = dict(layers=2, seq_len=SEQ, vocab=256)
    out = []
    for reduce, get in ((j_reduced, j_get_config), (t_reduced, t_get_config)):
        arch = reduce(get(AUDIO), **kw)
        model = dataclasses.replace(arch.model, encoder_seq_len=enc_len)
        lora = (arch.lora if targets is None
                else dataclasses.replace(arch.lora, targets=targets))
        out.append(arch.replace(model=model, lora=lora))
    return out


def _pair(enc_len):
    arch_j, arch_t = _archs(enc_len)
    model_j = j_build_model(arch_j)
    params_j = model_j.init_params(jax.random.PRNGKey(0))
    model_t = build_model(arch_t, device="cpu")
    return (model_j, params_j), (model_t, bridge.params_from_numpy(
        _np(params_j), "cpu"))


@pytest.fixture(scope="module")
def pair():
    """(JAX model, params), (port model, params): the same weights,
    encoder over 16 frames."""
    return _pair(16)


@pytest.fixture(scope="module")
def pair24():
    """As `pair`, the encoder over 24 frames."""
    return _pair(24)


def _batch(model, lead, seed, seq=SEQ):
    """Tokens, labels and frames ([N,] B, S_enc, d)."""
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, 256, size=lead + (seq + 1,)).astype(np.int32)
    frames = (rng.normal(size=lead + (cfg.encoder_seq_len, cfg.d_model))
              * 0.02).astype(np.float32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:],
            "frames": frames}


def _state(model_j, seed=1):
    """The reference's round state for len(CUTS) clients with non-zero
    adapters at CUTS, and its numpy copy."""
    state_j = j_rounds.init_state(model_j, jax.random.PRNGKey(seed),
                                  num_clients=len(CUTS))
    rng = np.random.default_rng(0)
    for side in ("client_adapters", "server_adapters"):
        state_j[side] = jax.tree.map(
            lambda v: jnp.asarray(rng.normal(size=v.shape) * 0.05,
                                  jnp.float32), state_j[side])
    state_j["cuts"] = jnp.asarray(CUTS, jnp.int32)
    return state_j, _np(state_j)


def _sgd(arch):
    return arch.replace(train=dataclasses.replace(arch.train,
                                                  optimizer="sgd"))


def _close_trees(got, want, **tol):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


# ---------------------------------------------------------------------------
# Config, layout and input shapes


@pytest.mark.parametrize("shrink", [False, True])
def test_config_copy_matches_reference(shrink):
    want, got = j_get_config(AUDIO), t_get_config(AUDIO)
    if shrink:
        want, got = j_reduced(want), t_reduced(got)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("enc_len", [16, 24])
@pytest.mark.parametrize("targets", [None, ("q", "k", "v", "o", "xq")])
def test_layout_matches_reference(enc_len, targets):
    """Parameter names and shapes (enc_pos, enc_norm, the decoder's
    xnorm and x* projections), adapter_spec (xq/xo only when "xq" is a
    target) and the execution runs (encoder ids first)."""
    arch_j, arch_t = _archs(enc_len, targets)
    model_j, model_t = j_build_model(arch_j), build_model(arch_t,
                                                          device="cpu")
    params_j = jax.eval_shape(model_j.init_params, jax.random.PRNGKey(0))
    mine = model_t.init_params(torch.Generator().manual_seed(0))
    shapes = lambda tree: {  # noqa: E731
        jax.tree_util.keystr(k): tuple(v.shape)
        for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(mine) == shapes(params_j)
    assert mine["embed"]["enc_pos"].shape == (enc_len, 64)
    assert model_t.adapter_spec() == model_j.adapter_spec()
    assert ("xq" in model_t.adapter_spec()["dec"]) == (targets is not None)
    assert model_t.runs == model_j.runs == [("enc", 0, 2), ("dec", 0, 2)]
    assert [g.causal for g in model_t.groups] == [False, True]


@pytest.mark.parametrize("shape,num_clients", [
    ("train_4k", 0), ("train_4k", 4), ("prefill_32k", 0), ("decode_32k", 0)])
def test_input_specs_match_reference(shape, num_clients):
    """The frames entry (train and prefill, split over the clients in
    training, 1500 positions of d_model) and the token entries, at full
    size."""
    sc = SHAPES[shape]
    want = j_build_model(j_get_config(AUDIO)).input_specs(
        sc, num_clients=num_clients)
    got = build_model(t_get_config(AUDIO), device="cpu").input_specs(
        sc.kind, sc.seq_len, sc.global_batch, num_clients=num_clients)
    assert {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in want.items()} == {
        k: (shp, str(dt).replace("torch.", "")) for k, (shp, dt) in
        got.items()}
    assert ("frames" in got) == (sc.kind != "decode")
    if "frames" in got:
        assert got["frames"][0][-2:] == (1500, 1024)


# ---------------------------------------------------------------------------
# Encoder, logits, prefill and decode


def test_encode_matches_reference(pair):
    (model_j, params_j), (model_t, params_t) = pair
    frames = _batch(model_t, (2,), 1)["frames"]
    want = model_j.encode(params_j, None, jnp.asarray(frames))
    with torch.no_grad():
        got = model_t.encode(params_t, None, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("enc_len", [16, 24])
def test_logits_match_reference(pair, pair24, enc_len):
    """The full forward (encoder, then the decoder from flat id 2 with
    cross-attention over the encoder's output) and the head; other
    frames give other logits."""
    (model_j, params_j), (model_t, params_t) = (pair if enc_len == 16
                                                else pair24)
    batch = _batch(model_t, (2,), 2)
    x_j, _, _ = model_j.forward(params_j, None, {
        k: jnp.asarray(batch[k]) for k in ("tokens", "frames")})
    want = model_j.head(params_j, x_j)
    with torch.no_grad():
        run = lambda b: model_t.head(params_t, model_t.forward(  # noqa: E731
            params_t, None, {k: torch.from_numpy(b[k])
                             for k in ("tokens", "frames")})[0])
        got = run(batch)
        other = run(dict(batch, frames=batch["frames"][::-1].copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not np.allclose(got.numpy(), other.numpy(), atol=1e-3)


def test_prefill_then_decode_matches_reference(pair):
    """Prefill of SEQ - 3 tokens with the frames (writing the cross
    cache), then 3 decode steps against the cache (no encoder run),
    logits against the reference's; the cross cache equals the
    reference's; and decode from the reference's own cache
    (bridge.cache_from_numpy carries xk/xv) gives the same logits."""
    (model_j, params_j), (model_t, params_t) = pair
    batch = _batch(model_t, (2,), 3)
    toks, frames = batch["tokens"], batch["frames"]
    n = SEQ - 3
    cache_j = model_j.init_cache((2,), SEQ)
    lg_j, cache_j = model_j.prefill(
        params_j, None, {"tokens": jnp.asarray(toks[:, :n]),
                         "frames": jnp.asarray(frames)}, cache_j)
    want, caches = [lg_j], [_np(cache_j)]
    for i in range(n, SEQ):
        lg_j, cache_j = model_j.decode_step(params_j, None,
                                            jnp.asarray(toks[:, i:i + 1]),
                                            cache_j)
        want.append(lg_j)
        caches.append(_np(cache_j))
    with torch.no_grad():
        cache_t = model_t.init_cache((2,), SEQ)
        assert "enc" not in cache_t
        assert cache_t["dec"]["xk"].shape == (2, 2, 16, 4, 16)
        lg_t, cache_t = model_t.prefill(
            params_t, None, {"tokens": torch.from_numpy(toks[:, :n]),
                             "frames": torch.from_numpy(frames)}, cache_t)
        for name in ("xk", "xv"):
            np.testing.assert_allclose(cache_t["dec"][name].numpy(),
                                       caches[0]["dec"][name], rtol=1e-5,
                                       atol=1e-5)
        got = [lg_t]
        for i in range(n, SEQ):
            lg_t, cache_t = model_t.decode_step(
                params_t, None, torch.from_numpy(toks[:, i:i + 1]), cache_t)
            got.append(lg_t)
        for name in ("xk", "xv"):   # the decode steps leave it unchanged
            np.testing.assert_allclose(cache_t["dec"][name].numpy(),
                                       caches[-1]["dec"][name], rtol=1e-5,
                                       atol=1e-5)
        bridged = bridge.cache_from_numpy(caches[0], "cpu")
        assert set(bridged["dec"]) == {"k", "v", "xk", "xv"}
        lg_b, _ = model_t.decode_step(params_t, None,
                                      torch.from_numpy(toks[:, n:n + 1]),
                                      bridged)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(lg_b.numpy(), np.asarray(want[1]), **TOL)


def test_encode_with_stateful_boundary_raises(pair):
    """A stateful (error-feedback) boundary cannot cross the encoder, in
    the port as in the reference."""
    (model_j, params_j), (model_t, params_t) = pair
    frames = _batch(model_t, (1, 1), 4)["frames"]
    residual = np.zeros(frames.shape, np.float32)
    b_j = j_smashed.make_boundary(j_smashed.make_compressor("int8"),
                                  jnp.asarray([1], jnp.int32),
                                  residual=jnp.asarray(residual))
    b_t = t_smashed.make_boundary(t_smashed.make_compressor("int8"),
                                  torch.tensor([1], dtype=torch.int32),
                                  residual=torch.from_numpy(residual))
    assert b_j.stateful and b_t.stateful
    with pytest.raises(NotImplementedError, match="encoder stack"):
        model_j.encode(params_j, None, jnp.asarray(frames), boundary=b_j)
    with pytest.raises(NotImplementedError, match="encoder stack"):
        model_t.encode(params_t, None, torch.from_numpy(frames),
                       boundary=b_t)


@pytest.mark.parametrize("page_size", [0, 8])
def test_engine_refuses_audio(pair, page_size):
    """ServingEngine refuses the audio family, contiguous and paged (the
    reference's engine passes only tokens to its prefill); so does the
    serve CLI."""
    _, (model_t, params_t) = pair
    pool = serving.build_adapter_pool(model_t,
                                      torch.Generator().manual_seed(1), 2)
    cfg = serving.ServeConfig(num_slots=2, max_len=32, page_size=page_size)
    with pytest.raises(NotImplementedError, match="encoder frames"):
        serving.ServingEngine(model_t, params_t, pool, cfg, device="cpu")
    if page_size:
        with pytest.raises(NotImplementedError, match="encoder frames"):
            t_serve.main(["--arch", AUDIO, "--reduced", "--device", "cpu"])


# ---------------------------------------------------------------------------
# The sync round engine


def test_round_matches_reference(pair):
    """Per-client losses and the client and server adapters' gradients
    of one round (jax.grad against round_grads) at cuts [1, 2, 2]: a cut
    inside the encoder and two at its last layer, uncompressed; the
    eval step of the global adapters; then one SGD step of
    make_train_step under int8 smashed activations, whose boundary acts
    inside the encoder."""
    (model_j, params_j), (model_t, params_t) = pair
    state_j, state_np = _state(model_j)
    state_t = bridge.state_from_numpy(state_np, "cpu")
    batch = _batch(model_t, (3, 1), 5)
    batch_j = jax.tree.map(jnp.asarray, batch)
    wl = WEIGHTS / WEIGHTS.sum()
    b_j = j_smashed.make_boundary(j_smashed.make_compressor("none"),
                                  state_j["cuts"])
    b_t = t_smashed.make_boundary(t_smashed.make_compressor("none"),
                                  state_t["cuts"])

    def loss_j(cad, sad):
        eff = j_split.merge_adapters(model_j, cad, sad, state_j["cuts"])
        per, _ = model_j.loss(params_j, eff, batch_j, per_client=True,
                              boundary=b_j)
        return jnp.sum(wl * per), per

    (_, per_j), g_j = jax.value_and_grad(loss_j, argnums=(0, 1),
                                         has_aux=True)(
        state_j["client_adapters"], state_j["server_adapters"])
    _, met_t, gc_t, gs_t = t_rounds.round_grads(
        model_t, params_t, state_t, batch, WEIGHTS, boundary=b_t)
    np.testing.assert_allclose(met_t["ce"].numpy(), np.asarray(per_j),
                               rtol=1e-4, atol=1e-4)
    got = tree_leaves(gc_t) + tree_leaves(gs_t)
    want = jax.tree.leaves(g_j[0]) + jax.tree.leaves(g_j[1])
    # {client, server} x {enc, dec} x {q, k, v, o} x {A, B}
    assert len(got) == len(want) == 2 * 2 * 4 * 2
    floor = 1e-4 * max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=floor)

    ev_j = j_rounds.make_eval_step(model_j)(params_j, state_j, batch_j,
                                            jnp.asarray(WEIGHTS))
    ev_t = t_rounds.make_eval_step(model_t)(params_t, state_t, batch,
                                            WEIGHTS)
    np.testing.assert_allclose(ev_t[0].numpy(), np.asarray(ev_j[0]),
                               rtol=1e-4, atol=1e-4)

    step_j = j_rounds.make_train_step(j_build_model(_sgd(model_j.arch)),
                                      smashed_compress="int8")
    step_t = t_rounds.make_train_step(
        build_model(_sgd(model_t.arch), device="cpu"),
        smashed_compress="int8")
    act = np.ones(3, np.float32)
    new_j, m_j = step_j(params_j, state_j, batch_j, jnp.asarray(WEIGHTS),
                        jnp.asarray(act), jnp.float32(1e-2),
                        jnp.float32(1e-2))
    new_t, m_t = step_t(params_t, bridge.state_from_numpy(state_np, "cpu"),
                        batch, WEIGHTS, act, 1e-2, 1e-2)
    for side in ("client_adapters", "server_adapters"):
        _close_trees(new_t[side], new_j[side], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m_t["ce"].numpy(), np.asarray(m_j["ce"]),
                               rtol=1e-4, atol=1e-4)


def test_microbatch_round_matches_reference(pair):
    """One SGD step under microbatch 2: the (N, B, S_enc, d) frames leaf
    is split into B/2-row slices with the tokens."""
    (model_j, params_j), (model_t, params_t) = pair
    state_j, state_np = _state(model_j, seed=2)
    batch = _batch(model_t, (3, 2), 6)
    step_j = j_rounds.make_train_step(j_build_model(_sgd(model_j.arch)),
                                      microbatch=2)
    step_t = t_rounds.make_train_step(
        build_model(_sgd(model_t.arch), device="cpu"), microbatch=2)
    act = np.ones(3, np.float32)
    new_j, m_j = step_j(params_j, state_j, jax.tree.map(jnp.asarray, batch),
                        jnp.asarray(WEIGHTS), jnp.asarray(act),
                        jnp.float32(1e-2), jnp.float32(1e-2))
    new_t, m_t = step_t(params_t, bridge.state_from_numpy(state_np, "cpu"),
                        batch, WEIGHTS, act, 1e-2, 1e-2)
    for side in ("client_adapters", "server_adapters"):
        _close_trees(new_t[side], new_j[side], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m_t["ce"].numpy(), np.asarray(m_j["ce"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_is_bitwise(pair, remat):
    """Remat across the encoder and the decoder (the encoder's output
    reaches every decoder layer's recomputed cross-attention) gives the
    step without remat bit for bit, with int8 at the encoder cut."""
    (model_j, _), (model_t, params_t) = pair
    _, state_np = _state(model_j, seed=3)
    batch = _batch(model_t, (3, 1), 7)
    out = {}
    for r in ("none", remat):
        state_t = bridge.state_from_numpy(state_np, "cpu")
        b_t = t_smashed.make_boundary(t_smashed.make_compressor("int8"),
                                      state_t["cuts"])
        total, met, gc, gs = t_rounds.round_grads(
            model_t, params_t, state_t, batch, WEIGHTS, boundary=b_t,
            remat=r)
        out[r] = [total, met["ce"]] + tree_leaves(gc) + tree_leaves(gs)
    assert all(torch.equal(a, b) for a, b in zip(out["none"], out[remat]))


# ---------------------------------------------------------------------------
# Learning-rate schedules


@pytest.mark.parametrize("kind", ["constant", "cosine", "linear"])
@pytest.mark.parametrize("warmup", [0, 10])
def test_schedule_matches_reference(kind, warmup):
    """lr(step) inside and past the warmup, through the decay and past
    the total, against the reference's fp32 schedule; and the schedule
    without a total (constant after the warmup)."""
    for total in (100, 0):
        kw = dict(warmup_steps=warmup, total_steps=total, min_ratio=0.1)
        want, got = j_schedule(kind, 3e-4, **kw), make_schedule(kind, 3e-4,
                                                                **kw)
        for step in (0, 1, 4, 9, 10, 11, 37, 55, 99, 100, 101, 250):
            np.testing.assert_allclose(got(step), float(want(step)),
                                       rtol=1e-6, atol=0)
    with pytest.raises(ValueError):
        make_schedule("step", 1e-3)
