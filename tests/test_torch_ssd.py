"""The port's plain SSD scan against the JAX package's oracles and its
Pallas kernel (interpret mode), on numpy-seeded inputs.

  * ssd_sequential, ssd_chunked (with h0 and return_state) and
    ssd_decode_step against ``repro.kernels.ssd_scan.ref``, and
    ssd_chunked against ``ssd_scan_pallas(..., interpret=True)``: G in
    {1, 2}, chunk < S and chunk == S, fp32, rtol = atol = 2e-5 (sums in
    another order);
  * ``ops.ssd_scan``'s autograd against ``jax.vjp`` of the reference's
    ssd_chunked at chunk 16, where the reference's gradients are finite:
    1e-4 of each gradient's largest element;
  * at chunk 256 with decays past exp(88) inside a chunk, the reference's
    chunked gradients are not finite (its where(tri, exp(rel), 0) forms
    0 * inf in the backward); the port masks the exponent first, and its
    gradients are finite and equal jax.grad of the sequential oracle:
    rtol 1e-4 with an absolute floor of 1e-5 of the largest element (the
    A gradient sums every step's decay derivative, ~1e-4 relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ref as j_ref  # noqa: E402
from repro.kernels.ssd_scan.kernel import ssd_scan_pallas  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as t_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as t_ref  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(b, s, h, p, g, n, *, seed=0, dt_scale=1.0, state=False):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    out = dict(
        x=rng.normal(size=(b, s, h, p)).astype(f32),
        dt=(np.log1p(np.exp(rng.normal(size=(b, s, h)) + 0.5))
            * dt_scale).astype(f32),
        a=(-np.exp(rng.normal(size=(h,)) * 0.5)).astype(f32),
        bm=(rng.normal(size=(b, s, g, n)) * 0.5).astype(f32),
        c=(rng.normal(size=(b, s, g, n)) * 0.5).astype(f32))
    if state:
        out["h0"] = rng.normal(size=(b, h, p, n)).astype(f32)
    return out


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


ARGS = ("x", "dt", "a", "bm", "c")
# (B, S, H, P, G, N, chunk): G = 1 and 2, chunk < S and chunk == S
SHAPES = [(2, 32, 4, 8, 1, 16, 8), (1, 48, 4, 8, 2, 8, 16),
          (2, 16, 2, 4, 2, 8, 16)]


@pytest.mark.parametrize("shape", SHAPES)
def test_sequential_matches_reference(shape):
    b, s, h, p, g, n, _ = shape
    d = _inputs(b, s, h, p, g, n, state=True)
    y_t, st_t = t_ref.ssd_sequential(*(_t(d)[k] for k in ARGS),
                                     _t(d)["h0"], return_state=True)
    y_j, st_j = j_ref.ssd_sequential(*(_j(d)[k] for k in ARGS),
                                     _j(d)["h0"], return_state=True)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_chunked_matches_reference_and_sequential(shape, with_state):
    b, s, h, p, g, n, chunk = shape
    d = _inputs(b, s, h, p, g, n, seed=1, state=with_state)
    h0_t = _t(d)["h0"] if with_state else None
    h0_j = _j(d)["h0"] if with_state else None
    y_t, st_t = t_ref.ssd_chunked(*(_t(d)[k] for k in ARGS), h0_t,
                                  chunk=chunk, return_state=True)
    y_j, st_j = j_ref.ssd_chunked(*(_j(d)[k] for k in ARGS), h0_j,
                                  chunk=chunk, return_state=True)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), **TOL)
    y_s = t_ref.ssd_sequential(*(_t(d)[k] for k in ARGS), h0_t)
    np.testing.assert_allclose(y_t.numpy(), y_s.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_chunked_matches_pallas_interpret(shape):
    b, s, h, p, g, n, chunk = shape
    d = _inputs(b, s, h, p, g, n, seed=2)
    want = ssd_scan_pallas(*(_j(d)[k] for k in ARGS), chunk=chunk,
                           interpret=True)
    got = t_ops.ssd_scan(*(_t(d)[k] for k in ARGS), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_decode_step_matches_reference(groups):
    rng = np.random.default_rng(3)
    b, h, p, n = 3, 4, 8, 16
    st = rng.normal(size=(b, h, p, n)).astype(np.float32)
    xt = rng.normal(size=(b, h, p)).astype(np.float32)
    dtt = rng.random((b, h)).astype(np.float32)
    a = -rng.random(h).astype(np.float32) - 0.1
    bt, ct = (rng.normal(size=(b, groups, n)).astype(np.float32)
              for _ in range(2))
    arrs = (st, xt, dtt, a, bt, ct)
    y_t, s_t = t_ref.ssd_decode_step(*map(torch.from_numpy, arrs))
    y_j, s_j = j_ref.ssd_decode_step(*map(jnp.asarray, arrs))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **TOL)


def test_chunk_is_capped_at_seq_and_must_divide_it():
    d = _t(_inputs(1, 24, 2, 4, 1, 8))
    got = t_ops.ssd_scan(*(d[k] for k in ARGS), chunk=256)   # chunk -> 24
    want = t_ref.ssd_chunked(*(d[k] for k in ARGS), chunk=24)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="not divisible"):
        t_ops.ssd_scan(*(d[k] for k in ARGS), chunk=16)


def _grads_torch(d, gy, chunk):
    ins = {k: torch.from_numpy(d[k]).requires_grad_(True) for k in ARGS}
    y = t_ops.ssd_scan(*(ins[k] for k in ARGS), chunk=chunk)
    grads = torch.autograd.grad(y, [ins[k] for k in ARGS],
                                torch.from_numpy(gy))
    return [g.numpy() for g in grads]


def _assert_grads_close(got, want, rtol, share):
    for name, gt, gw in zip(ARGS, got, want):
        gw = np.asarray(gw)
        np.testing.assert_allclose(gt, gw, rtol=rtol,
                                   atol=share * float(np.abs(gw).max()),
                                   err_msg=name)


def test_scan_autograd_matches_reference_vjp():
    b, s, h, p, g, n, chunk = 2, 32, 4, 8, 2, 8, 16
    d = _inputs(b, s, h, p, g, n, seed=4)
    gy = np.random.default_rng(5).normal(size=(b, s, h, p)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda *a: j_ref.ssd_chunked(*a, chunk=chunk),
                     *(_j(d)[k] for k in ARGS))
    want = vjp(jnp.asarray(gy))
    assert all(np.isfinite(np.asarray(w)).all() for w in want)
    _assert_grads_close(_grads_torch(d, gy, chunk), want, 1e-4, 1e-4)


def test_long_chunk_gradients_are_finite_and_match_sequential():
    """Chunk 256, dt ~ 1 and A ~ -1 (mamba2 at init): a chunk's decay
    reaches ~250, past exp(88)."""
    b, s, h, p, g, n, chunk = 1, 256, 2, 4, 1, 8, 256
    d = _inputs(b, s, h, p, g, n, seed=6)
    d["dt"] = np.ones_like(d["dt"])
    d["a"] = -np.ones_like(d["a"])
    gy = np.random.default_rng(7).normal(size=(b, s, h, p)).astype(
        np.float32)

    def loss_j(fn):
        return lambda *a: jnp.sum(fn(*a) * gy)

    args_j = [_j(d)[k] for k in ARGS]
    ref_chunked = jax.grad(loss_j(lambda *a: j_ref.ssd_chunked(
        *a, chunk=chunk)), argnums=tuple(range(5)))(*args_j)
    # the reference's own chunked backward: 0 * inf at the masked entries
    assert not all(np.isfinite(np.asarray(r)).all() for r in ref_chunked)
    want = jax.grad(loss_j(j_ref.ssd_sequential),
                    argnums=tuple(range(5)))(*args_j)
    got = _grads_torch(d, gy, chunk)
    assert all(np.isfinite(gt).all() for gt in got)
    _assert_grads_close(got, want, 1e-4, 1e-5)
