"""Engine-level parity of the PyTorch port, and the port's rules.

The port's ServingEngine must give exactly the JAX ServingEngine's greedy
tokens on one seeded workload (contiguous and paged), equal the port's own
serial reference, keep paged == contiguous, leave other slots' caches
bit-identical across free/admit, and raise on bad requests.  The port
imports neither JAX nor the JAX package, and its entry points refuse to
run on a missing GPU unless the CPU is asked for.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro.runtime import serving as j_serving  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import reduced as t_reduced  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import kv_cache, serving  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(d_model=32, vocab=256, seq_len=16)


@pytest.fixture(scope="module")
def setup():
    arch_j = j_reduced(j_get_config("gpt2-small"), **SMALL)
    model_j = j_build_model(arch_j)
    params_j = model_j.init_params(jax.random.PRNGKey(0))
    pool_j = j_serving.build_adapter_pool(model_j, jax.random.PRNGKey(1), 3,
                                          ranks=[4, 2, 4])
    model = build_model(t_reduced(t_get_config("gpt2-small"), **SMALL),
                        device="cpu")
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, params_j),
                                      "cpu")
    pool = bridge.pool_from_numpy(jax.tree.map(np.asarray, pool_j), "cpu")
    return (model_j, params_j, pool_j), (model, params, pool)


def _requests(mod, rng, n, n_adapters, *, max_plen=10, max_new=4):
    return [mod.Request(
        rid=i, adapter=int(rng.integers(0, n_adapters)),
        tokens=rng.integers(3, 250, size=int(rng.integers(2, max_plen))),
        max_new=int(rng.integers(1, max_new + 1))) for i in range(n)]


def _engine(model, params, pool, page_size, num_slots=3, max_len=24):
    return serving.ServingEngine(
        model, params, pool,
        serving.ServeConfig(num_slots=num_slots, max_len=max_len,
                            page_size=page_size), device="cpu")


# ---------------------------------------------------------------------------
# Tokens


@pytest.mark.parametrize("page_size", [0, 8])
def test_engine_tokens_equal_jax_engine(setup, page_size):
    (model_j, params_j, pool_j), (model, params, pool) = setup
    rng = np.random.default_rng(4)
    reqs_j = _requests(j_serving, rng, 6, 3)
    reqs = [serving.Request(rid=r.rid, adapter=r.adapter, tokens=r.tokens,
                            max_new=r.max_new) for r in reqs_j]
    cfg = dict(num_slots=3, max_len=24, page_size=page_size)
    want = j_serving.ServingEngine(model_j, params_j, pool_j,
                                   j_serving.ServeConfig(**cfg)).run(reqs_j)
    got = _engine(model, params, pool, page_size).run(reqs)
    assert [r["tokens"] for r in got] == [r["tokens"] for r in want]


@pytest.mark.parametrize("page_size", [0, 8])
def test_engine_matches_serial_reference(setup, page_size):
    _, (model, params, pool) = setup
    rng = np.random.default_rng(5)
    reqs = _requests(serving, rng, 7, 3)
    for i, r in enumerate(reqs):
        r.arrival = 0.002 * i                 # staggered, more than slots
    want = serving.serial_reference(model, params, pool, reqs, max_len=24)
    res = _engine(model, params, pool, page_size, num_slots=2).run(reqs)
    for r in res:
        assert r["tokens"] == want[r["rid"]], (page_size, r)
        assert r["t_first"] is not None and r["t_done"] >= r["t_first"]


def test_paged_engine_equals_contiguous(setup):
    _, (model, params, pool) = setup
    rng = np.random.default_rng(6)
    reqs = _requests(serving, rng, 6, 3, max_new=6)
    contig = _engine(model, params, pool, 0).run(reqs)
    paged = _engine(model, params, pool, 8).run(reqs)
    assert [r["tokens"] for r in paged] == [r["tokens"] for r in contig]


def test_built_pool_slices_are_what_the_kernel_takes(setup):
    """Every per-layer pool leaf that reaches the indexed LoRA kernel is
    contiguous with the dtype the CUDA wrapper checks (the wrapper refuses
    anything else on the card)."""
    _, (model, _, _) = setup
    pool = serving.build_adapter_pool(model, torch.Generator().manual_seed(3),
                                      3, ranks=[4, 2, 4])
    ad = serving.attach_ids(pool, [2, 0])
    for targets in ad.values():
        for leaves in targets.values():
            for i in range(leaves["A"].shape[0]):
                for name, want in (("A", torch.float32), ("B", torch.float32),
                                   ("scale", torch.float32),
                                   ("ids", torch.int32)):
                    t = leaves[name][i]
                    assert t.is_contiguous() and t.dtype == want, name


def test_serial_reference_logits_choose_its_tokens(setup):
    _, (model, params, pool) = setup
    reqs = _requests(serving, np.random.default_rng(7), 2, 3)
    toks, logits = serving.serial_reference(model, params, pool, reqs,
                                            max_len=24, return_logits=True)
    for r in reqs:
        assert logits[r.rid].shape == (r.max_new, 256)
        assert logits[r.rid].argmax(-1).tolist() == toks[r.rid]


# ---------------------------------------------------------------------------
# Slot churn: free/admit is surgical


def test_free_admit_leaves_other_slots_bit_identical(setup):
    _, (model, _, _) = setup
    ps, max_len = 8, 24
    cache = kv_cache.init_paged_cache(model, 3, max_len, ps)
    alloc = kv_cache.PageAllocator(kv_cache.default_num_pages(3, max_len, ps))
    p_max = kv_cache.pages_per_slot(max_len, ps)
    gen = torch.Generator().manual_seed(0)

    def random_temp(bucket):
        temp = model.init_cache((1,), bucket)
        for g in model.groups:
            for leaf in ("k", "v"):
                temp[g.name][leaf] = torch.randn(temp[g.name][leaf].shape,
                                                 generator=gen)
        return temp

    pages = {}
    for slot in range(3):
        pages[slot] = alloc.alloc(2)
        kv_cache.install_slot_paged(cache, slot, random_temp(16),
                                    kv_cache.page_row(pages[slot], p_max),
                                    10 + slot)

    def snapshot(slots):
        view = kv_cache.gather_contiguous(cache)
        return [view["dec"][leaf][:, slots].clone() for leaf in ("k", "v")] \
            + [view["len"][slots].clone(), cache["pages"][slots].clone()]

    before = snapshot([1, 2])
    kv_cache.free_slot(cache, 0)
    alloc.free(pages[0])
    kv_cache.install_slot_paged(cache, 0, random_temp(24),
                                kv_cache.page_row(alloc.alloc(3), p_max), 20)
    for b, a in zip(before, snapshot([1, 2])):
        assert torch.equal(b, a)
    assert int(cache["len"][0]) == 20


def test_allocator_exhaustion_and_free():
    alloc = kv_cache.PageAllocator(6)           # pages 1..5 usable
    a = alloc.alloc(3)
    b = alloc.alloc(2)
    assert sorted(a + b) == [1, 2, 3, 4, 5] and alloc.available == 0
    with pytest.raises(RuntimeError, match="exhausted"):
        alloc.alloc(1)
    alloc.free(b)
    assert sorted(alloc.alloc(2)) == sorted(b)
    with pytest.raises(ValueError):
        alloc.free([kv_cache.TRASH_PAGE])


# ---------------------------------------------------------------------------
# Guards


def test_capacity_adapter_and_max_new_guards_raise(setup):
    _, (model, params, pool) = setup
    eng = _engine(model, params, pool, 0, num_slots=1, max_len=16)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(serving.Request(rid=0, adapter=0, tokens=np.arange(3, 15),
                                   max_new=10))
    with pytest.raises(ValueError, match="adapter"):
        eng.submit(serving.Request(rid=1, adapter=7, tokens=np.arange(3, 7),
                                   max_new=2))
    with pytest.raises(ValueError, match="max_new"):
        eng.submit(serving.Request(rid=2, adapter=0, tokens=np.arange(3, 7),
                                   max_new=0))
    with pytest.raises(ValueError, match="position table"):
        _engine(model, params, pool, 0, max_len=10_000)


# ---------------------------------------------------------------------------
# CLI


def test_serve_cli_runs_reduced_on_cpu(capsys):
    assert t_serve.main(["--reduced", "--adapters", "3", "--requests", "4",
                         "--num-slots", "2", "--prompt-len", "6", "--gen",
                         "3", "--page-size", "8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 4 requests" in out and "on cpu" in out


def test_serve_cli_has_reference_flags_and_device():
    from repro.launch import serve as j_serve
    mine = {a.option_strings[0] for a in t_serve.build_parser()._actions
            if a.option_strings}
    ref = {a.option_strings[0] for a in j_serve.build_parser()._actions
           if a.option_strings}
    assert mine == ref | {"--device"}
    assert t_serve.build_parser().parse_args([]).device == "cuda"


# ---------------------------------------------------------------------------
# Rules


def _port_sources():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]


def test_port_imports_no_jax_and_no_reference_package():
    bad = re.compile(r"^\s*(import jax\b|from jax\b|import repro\.|"
                     r"from repro\.|import repro\s*$|from repro import)",
                     re.MULTILINE)
    offenders = [str(p.relative_to(REPO)) for p in _port_sources()
                 if bad.search(p.read_text())]
    assert not offenders, offenders


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.runtime.serving, repro_torch.bridge, "
            "repro_torch.launch.serve; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')];"
            " print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_engine_without_device_raises_when_no_cuda(setup, monkeypatch):
    _, (model, params, pool) = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.ServingEngine(model, params, pool, serving.ServeConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serve.main(["--reduced"])
