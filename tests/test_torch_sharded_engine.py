"""The client-sharded round engine in 4 gloo processes against the
unsharded one, and against the JAX reference.

One spawn for the whole file (the module fixture): 4 ranks on a (4, 1)
mesh run every case of tests/torch_sharded_cases.py for 2 rounds of
``SplitFTSystem.run`` under a ``ClientShard``, then the same cases
without one, then the digest check and the checkpoints across world
sizes, and write what they found to a temporary directory.

Tolerances (tests/torch_sharded_cases.py has them and says why they are
not zero): each float leaf of the gathered state within rtol 1e-5 and
atol 1e-6 x max|leaf| of the unsharded run's, the per-round losses
within rtol 1e-6, every discrete leaf and record equal.  Most cases
train with SGD; the two AdamW cases, the int8 smashed quantizer's second
round and top-k's residual are held to per-leaf bounds set from the
measured gaps (torch_sharded_cases.BOUNDS), each of which still fails
the run without the server gradients' all-reduce.  With N = 5 on 4
ranks (no split) the run is the unsharded one bit for bit.

Time: ~20 s for the spawn, ~15 s for the JAX reference's 2 rounds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_sharded_cases as cases  # noqa: E402
from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import system as j_system  # noqa: E402
from repro_torch.launch.sharded import run_ranks  # noqa: E402
from test_torch_system import _losses_close  # noqa: E402

WORLD = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    ref = j_system.SplitFTSystem(
        cases.small_arch(4, j_reduced, j_get_config),
        j_system.SystemConfig(**cases.SYS), seed=0)
    torch.save((jax.tree.map(np.asarray, ref.base_params),
                jax.tree.map(np.asarray, ref.state)),
               out / cases.REF_WEIGHTS)
    run_ranks(cases.rank_main, WORLD, out / "group", args=(str(out),))
    return out, ref.run(cases.ROUNDS, log_every=0)


def _load(out, name):
    return torch.load(out / f"{name}.pt", weights_only=False)


@pytest.mark.parametrize("name", list(cases.CASES))
def test_sharded_case_matches_unsharded(runs, name):
    out, _ = runs
    n = cases.CASES[name][0]
    want_rows = n // WORLD if n % WORLD == 0 else n
    for r in range(WORLD):
        rows = _load(out, f"rows_{name}_{r}")
        assert rows and set(rows.values()) == {want_rows}, (r, rows)
    got, want = _load(out, f"sharded_{name}"), _load(out, f"plain_{name}")
    if n % WORLD:
        cases.same_bits(got, want)
    cases.held(got, want, name)


def test_a_rank_with_other_host_decisions_raises_on_every_rank(runs):
    out, _ = runs
    said = [_load(out, f"digest_{r}") for r in range(WORLD)]
    assert all("disagree at round 0" in s for s in said), said
    assert "rank 1 differs from rank 0" in said[1]
    assert all("agrees with rank 0" in s for i, s in enumerate(said)
               if i != 1)


@pytest.mark.parametrize("ckpt", ["ckpt_4to1", "ckpt_1to4"])
def test_checkpoint_restores_across_world_sizes(runs, ckpt):
    out, _ = runs
    got, want = _load(out, ckpt), _load(out, "plain_sync")
    cases.close_tree(got["state"], want["state"])
    cases.close_history(got["history"], want["history"][1:])
    assert got["sim_clock"] == want["sim_clock"]


def test_moe_router_loss_is_the_cohorts_mean(runs):
    """The router loss is a mean over every client's sequences: each rank
    adds its own groups' mean / world, so the total, the router loss and
    every gradient are the unsharded ones."""
    out, _ = runs
    moe = _load(out, "moe")
    got, want = moe["sharded"], moe["plain"]
    assert float(want["aux"]) > 0
    for k in ("total", "aux", "ce"):
        np.testing.assert_allclose(got[k], want[k], rtol=cases.LOSS_RTOL,
                                   err_msg=k)
    cases.close_tree({"client_adapters": got["client_grads"],
                 "server_adapters": got["server_grads"]},
                {"client_adapters": want["client_grads"],
                 "server_adapters": want["server_grads"]})


def test_sharded_losses_match_the_jax_reference(runs):
    out, ref_hist = runs
    _losses_close(ref_hist, _load(out, "sharded_sync")["history"])
