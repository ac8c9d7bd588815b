"""Model-level parity of the PyTorch port against the JAX package.

Reduced gpt2-small: the JAX package builds the weights and the adapter
pool (ranks [4, 2, 4]); ``repro_torch.bridge`` hands the same numpy
arrays to the port.  Prefill and teacher-forced decode logits agree in
fp32 at 2e-4, through contiguous and paged caches.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import lora as j_lora  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.runtime import kv_cache as j_kv  # noqa: E402
from repro.runtime import serving as j_serving  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import reduced as t_reduced  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import lora as t_lora  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402
from repro_torch.runtime import kv_cache as t_kv  # noqa: E402
from repro_torch.runtime import serving as t_serving  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
SMALL = dict(d_model=32, vocab=256, seq_len=16)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, params, pool), (port model, params, pool): same weights."""
    arch_j = j_reduced(j_get_config("gpt2-small"), **SMALL)
    model_j = j_build_model(arch_j)
    params_j = model_j.init_params(jax.random.PRNGKey(0))
    pool_j = j_serving.build_adapter_pool(model_j, jax.random.PRNGKey(1), 3,
                                          ranks=[4, 2, 4])
    model_t = build_model(t_reduced(t_get_config("gpt2-small"), **SMALL),
                          device="cpu")
    params_t = bridge.params_from_numpy(_np_tree(params_j), "cpu")
    pool_t = bridge.pool_from_numpy(_np_tree(pool_j), "cpu")
    return (model_j, params_j, pool_j), (model_t, params_t, pool_t)


def _close(got_t, want_j):
    np.testing.assert_allclose(got_t.float().numpy(), np.asarray(want_j),
                               **TOL)


# ---------------------------------------------------------------------------
# Configs and parameter layout


@pytest.mark.parametrize("shrink", [False, True])
def test_port_config_copy_matches_reference(shrink):
    want = j_get_config("gpt2-small")
    got = t_get_config("gpt2_small")
    if shrink:
        want, got = j_reduced(want, **SMALL), t_reduced(got, **SMALL)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_unported_architectures_raise():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        t_get_config("whisper-medium")
    with pytest.raises(KeyError):
        t_get_config("no-such-model")


def test_init_params_names_and_layouts_match_reference(pair):
    (model_j, params_j, _), (model_t, _, _) = pair
    mine = model_t.init_params(torch.Generator().manual_seed(0))
    shapes_j = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                jax.tree_util.tree_flatten_with_path(params_j)[0]}
    shapes_t = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                jax.tree_util.tree_flatten_with_path(mine)[0]}
    assert shapes_t == shapes_j
    assert model_t.adapter_spec() == model_j.adapter_spec()
    assert model_t.runs == model_j.runs


def test_bridge_round_trips_names_and_values(pair):
    (_, params_j, pool_j), (_, params_t, pool_t) = pair
    for tree_j, tree_t in ((params_j, params_t), (pool_j, pool_t)):
        back = bridge.to_numpy(tree_t)
        flat_j = jax.tree_util.tree_flatten_with_path(tree_j)[0]
        flat_b = dict((jax.tree_util.keystr(k), v) for k, v in
                      jax.tree_util.tree_flatten_with_path(back)[0])
        for k, v in flat_j:
            np.testing.assert_array_equal(flat_b[jax.tree_util.keystr(k)],
                                          np.asarray(v))


def test_bridge_keeps_bfloat16():
    a = np.asarray(jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16))
    t = bridge.params_from_numpy({"w": a}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    assert t.float().tolist() == [1.5, -2.25, 3.0]


def test_port_rank_masks_match_reference(pair):
    (model_j, _, _), (model_t, _, _) = pair
    ranks = np.array([[4, 2], [1, 4], [3, 3]], np.int32)
    for g in model_t.groups:
        np.testing.assert_array_equal(
            t_lora.rank_masks_for_group(model_t, g.name,
                                        torch.from_numpy(ranks)).numpy(),
            np.asarray(j_lora.rank_masks_for_group(model_j, g.name, ranks)))
        np.testing.assert_allclose(
            t_lora.scales_for_group(model_t, g.name,
                                    torch.from_numpy(ranks)).numpy(),
            np.asarray(j_lora.scales_for_group(model_j, g.name, ranks)))


# ---------------------------------------------------------------------------
# Prefill + decode logits


def _adapters(kind, pool_j, pool_t, ids):
    """(JAX adapters, port adapters) of one kind: none, the indexed pool,
    or pool row 1 as one shared (rank-2) adapter."""
    if kind == "none":
        return None, None
    if kind == "pool":
        return (j_serving.attach_ids(pool_j, jnp.asarray(ids, jnp.int32)),
                t_serving.attach_ids(pool_t, ids))
    shared_j = jax.tree.map(lambda v: v[:, 1], pool_j)
    shared_t = {g: {t: {k: v[:, 1] for k, v in leaves.items()}
                    for t, leaves in targets.items()}
                for g, targets in pool_t.items()}
    return shared_j, shared_t


@pytest.mark.parametrize("kind", ["pool", "shared", "none"])
def test_prefill_and_decode_logits_match_contiguous(pair, kind):
    (model_j, params_j, pool_j), (model_t, params_t, pool_t) = pair
    rng = np.random.default_rng(0)
    b, plen, max_len = 3, 7, 16
    toks = rng.integers(3, 250, size=(b, plen)).astype(np.int32)
    ad_j, ad_t = _adapters(kind, pool_j, pool_t, [2, 0, 1])

    cache_j = model_j.init_cache((b,), max_len)
    cache_t = model_t.init_cache((b,), max_len)
    lj, cache_j = model_j.prefill(params_j, ad_j,
                                  {"tokens": jnp.asarray(toks)}, cache_j)
    lt, cache_t = model_t.prefill(params_t, ad_t,
                                  {"tokens": torch.from_numpy(toks)}, cache_t)
    _close(lt, lj)
    # teacher-forced decode: both sides take the same next tokens
    for step in range(4):
        nxt = rng.integers(3, 250, size=(b, 1)).astype(np.int32)
        lj, cache_j = model_j.decode_step(params_j, ad_j, jnp.asarray(nxt),
                                          cache_j)
        lt, cache_t = model_t.decode_step(params_t, ad_t,
                                          torch.from_numpy(nxt), cache_t)
        _close(lt, lj)
        np.testing.assert_array_equal(cache_t["len"].numpy(),
                                      np.asarray(cache_j["len"]))


def test_prefill_and_decode_logits_match_paged(pair):
    """Slots prefilled into temp caches and installed into page pools;
    decode through the page tables on both sides."""
    (model_j, params_j, pool_j), (model_t, params_t, pool_t) = pair
    ps, max_len, b = 8, 24, 2
    rng = np.random.default_rng(1)
    plens = [5, 11]
    ids = [0, 2]
    cache_j = j_kv.init_paged_cache(model_j, b, max_len, ps)
    cache_t = t_kv.init_paged_cache(model_t, b, max_len, ps)
    p_max = t_kv.pages_per_slot(max_len, ps)
    alloc = t_kv.PageAllocator(t_kv.default_num_pages(b, max_len, ps))
    for slot, pl in enumerate(plens):
        bucket = ps * ((pl + ps - 1) // ps)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :pl] = rng.integers(3, 250, size=pl)
        row = t_kv.page_row(alloc.alloc(bucket // ps), p_max)
        temp_j = model_j.init_cache((1,), bucket)
        _, _, temp_j = model_j.forward(
            params_j, j_serving.attach_ids(pool_j, jnp.asarray(ids[slot:slot + 1])),
            {"tokens": jnp.asarray(toks)}, cache=temp_j, mode="prefill")
        cache_j = j_kv.install_slot_paged(cache_j, slot, temp_j,
                                          jnp.asarray(row), pl)
        temp_t = model_t.init_cache((1,), bucket)
        _, _, temp_t = model_t.forward(
            params_t, t_serving.attach_ids(pool_t, ids[slot:slot + 1]),
            {"tokens": torch.from_numpy(toks)}, cache=temp_t, mode="prefill")
        t_kv.install_slot_paged(cache_t, slot, temp_t, row, pl)

    ad_j = j_serving.attach_ids(pool_j, jnp.asarray(ids, jnp.int32))
    ad_t = t_serving.attach_ids(pool_t, ids)
    for _ in range(5):
        nxt = rng.integers(3, 250, size=(b, 1)).astype(np.int32)
        lj, cache_j = model_j.decode_step(params_j, ad_j, jnp.asarray(nxt),
                                          cache_j)
        lt, cache_t = model_t.decode_step(params_t, ad_t,
                                          torch.from_numpy(nxt), cache_t)
        _close(lt, lj)
    view = t_kv.gather_contiguous(cache_t)
    view_j = j_kv.gather_contiguous(cache_j)
    for slot, pl in enumerate(plens):
        np.testing.assert_allclose(view["dec"]["k"][:, slot, :pl + 5].numpy(),
                                   np.asarray(view_j["dec"]["k"][:, slot,
                                                                 :pl + 5]),
                                   **TOL)


# ---------------------------------------------------------------------------
# Device rules and unported parts


def test_model_without_device_raises_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = t_reduced(t_get_config("gpt2-small"), **SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(arch)
    assert Model(arch, device="cpu").device.type == "cpu"


def test_unported_model_paths_raise(pair):
    """What the port leaves out raises: the audio family (whisper's
    encoder and cross-attention), Model.encode and a batch of encoder
    "frames" (RoPE and sliding windows run:
    tests/test_torch_dense_families.py; the MoE and vlm families:
    tests/test_torch_moe.py, tests/test_torch_vlm.py).  A stateful (error
    feedback) cut boundary runs: its carry comes back from run_blocks,
    and remat, chunked cross entropy and the rest run too
    (tests/test_torch_memory_knobs.py, tests/test_torch_engine_options.py)."""
    _, (model_t, params_t, _) = pair

    def ef_boundary(x, carry, fid):
        return x, carry + fid

    ef_boundary.stateful = True
    ef_boundary.init = lambda: torch.zeros(())
    x, aux, _, carry = model_t.run_blocks(
        params_t, None, torch.zeros(1, 2, 32), mode="train",
        boundary=ef_boundary)
    assert float(carry) == sum(range(model_t.num_flat_layers))
    assert aux == 0.0
    arch = t_reduced(t_get_config("gpt2-small"), **SMALL)
    audio = arch.replace(model=dataclasses.replace(
        arch.model, family="audio", num_encoder_layers=2))
    with pytest.raises(NotImplementedError, match="the audio family"):
        Model(audio, device="cpu")
    with pytest.raises(NotImplementedError, match="Model.encode"):
        model_t.encode(params_t, None, torch.zeros(1, 16, 32))
    with pytest.raises(NotImplementedError, match="frames"):
        model_t.forward(params_t, None,
                        {"tokens": torch.zeros(1, 4, dtype=torch.int32),
                         "frames": torch.zeros(1, 16, 32)})
