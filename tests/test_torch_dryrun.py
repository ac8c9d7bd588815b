"""The port's dry-run against the JAX package's: the shape cells, the
registry lists, the (arch x shape) cells' arguments and ``info``, the
model FLOPs, the roofline terms on one H100, the counted FLOPs of a
reduced prefill, a full-size cell built without allocating it, the
dry-run's CLI, and the two repairs that the cells' lengths need: the
indexed LoRA's row chunks and the whole-path profiles' count check
(``chip_smoke.py``).

The reference builds its cells with ``jax.eval_shape`` (abstract
arrays); the port's are fake tensors (``launch/cells.py``).  Both are
compared as {leaf path: (shape, dtype)}.  The train cells' microbatch
comes from an activation budget, passed as the reference's 11e9 bytes.
"""

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import SHAPES as J_SHAPES  # noqa: E402
from repro.config import MeshConfig as JMeshConfig  # noqa: E402
from repro.configs import ASSIGNED as J_ASSIGNED  # noqa: E402
from repro.configs import PAPER_MODELS as J_PAPER_MODELS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import list_configs as j_list_configs  # noqa: E402
from repro.launch import cells as j_cells  # noqa: E402
from repro.launch.mesh import make_host_mesh as j_host_mesh  # noqa: E402
from repro.roofline import analysis as j_analysis  # noqa: E402
from repro_torch.config import SHAPES, MeshConfig, ShapeConfig  # noqa: E402
from repro_torch.config import reduced  # noqa: E402
from repro_torch.configs import (ASSIGNED, PAPER_MODELS, get_config,  # noqa: E402
                                 list_configs)
from repro_torch.kernels.lora_matmul import ops as lops  # noqa: E402
from repro_torch.launch import cells, dryrun  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.roofline import analysis, counting  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF_BUDGET = 11e9
CELLS = [(a, s) for a in J_ASSIGNED for s in J_SHAPES
         if j_get_config(a).shape_applicable(J_SHAPES[s])[0]]
# llama3-8b's (K, N) pairs: q/o, k/v, the MLP's up and down projections
LLAMA_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _ref_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(p.idx if hasattr(p, "idx") else p.key for p in path)
        out[key] = (tuple(leaf.shape), _dtype(leaf.dtype))
    return out


def _port_leaves(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_leaves(v, prefix + (k,)))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, prefix + (i,)))
    else:
        out[prefix] = (tuple(tree.shape), _dtype(tree.dtype))
    return out


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# shapes, mesh, registry


@pytest.mark.parametrize("name", list(J_SHAPES))
def test_shape_cells_equal_reference(name):
    assert dataclasses.asdict(SHAPES[name]) == dataclasses.asdict(
        J_SHAPES[name])
    assert SHAPES[name].is_train == J_SHAPES[name].is_train
    assert list(SHAPES) == list(J_SHAPES)


def test_mesh_config_and_registry_equal_reference():
    assert dataclasses.asdict(MeshConfig()) == dataclasses.asdict(
        JMeshConfig())
    assert MeshConfig().num_devices == JMeshConfig().num_devices == 256
    assert ASSIGNED == J_ASSIGNED
    assert PAPER_MODELS == J_PAPER_MODELS
    assert list_configs() == j_list_configs()
    assert make_host_mesh() == MeshConfig((1, 1), ("data", "model"))
    assert make_production_mesh().num_devices == 1
    assert make_production_mesh(num_cards=4).shape == (1, 4)
    with pytest.raises(ValueError):
        make_production_mesh(num_cards=2)


@pytest.mark.parametrize("arch", j_list_configs())
@pytest.mark.parametrize("shape", list(J_SHAPES))
def test_shape_applicable_agrees(arch, shape):
    assert get_config(arch).shape_applicable(SHAPES[shape]) == \
        j_get_config(arch).shape_applicable(J_SHAPES[shape])


# ---------------------------------------------------------------------------
# the cells


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_args_and_info_equal_reference(arch, shape):
    ref = j_cells.build_cell(j_get_config(arch), J_SHAPES[shape],
                             j_host_mesh())
    got = cells.build_cell(get_config(arch), SHAPES[shape],
                           make_host_mesh(), budget=REF_BUDGET)
    assert len(got.args) == len(ref.args)
    assert _port_leaves(got.args) == _ref_leaves(ref.args)
    assert got.info == ref.info


class _FakeMesh:
    """As much of a jax Mesh as the reference's activation budget reads."""

    def __init__(self, mesh: MeshConfig):
        self.shape = dict(zip(mesh.axes, mesh.shape))


# the four cards of one host, and a ("pod", "data", "model") layout
SP_MESHES = {"1x4": MeshConfig((1, 4), ("data", "model")),
             "2x2x4": MeshConfig((2, 2, 4), ("pod", "data", "model"))}
TRAIN_CELLS = [(a, s) for a, s in CELLS if J_SHAPES[s].is_train]


@pytest.mark.parametrize("mesh", list(SP_MESHES))
@pytest.mark.parametrize("arch,shape", TRAIN_CELLS)
def test_microbatch_on_a_mesh_equals_reference(arch, shape, mesh):
    """The activation budget's microbatch on a mesh: the clients over
    "data", each client's rows over "pod" and, under the reference's
    default sequence parallelism (off for SSM and hybrid), the tokens
    over "model"; and with seq_shard forced on and off."""
    m = SP_MESHES[mesh]
    for seq_shard in (None, True, False):
        want_sp = (j_get_config(arch).model.family not in ("ssm", "hybrid")
                   if seq_shard is None else seq_shard)
        want = j_cells._auto_microbatch(
            j_get_config(arch), J_SHAPES[shape], _FakeMesh(m),
            cells.DRYRUN_CLIENTS, seq_shard=want_sp, budget=REF_BUDGET)
        got = cells._auto_microbatch(
            get_config(arch), SHAPES[shape], m, cells.DRYRUN_CLIENTS,
            seq_shard=want_sp, budget=REF_BUDGET)
        assert got == want, seq_shard


@pytest.mark.parametrize("mesh", list(SP_MESHES))
@pytest.mark.parametrize("arch", ["llama3-8b", "internvl2-76b"])
def test_train_cell_info_on_a_mesh_equals_reference(arch, mesh):
    """The train cell's ``info`` on a mesh: the reference's host-mesh
    cell's, with the microbatch of its budget on that mesh under its
    default sequence parallelism."""
    m = SP_MESHES[mesh]
    shape = "train_4k"
    ref = j_cells.build_cell(j_get_config(arch), J_SHAPES[shape],
                             j_host_mesh())
    want = dict(ref.info, microbatch=j_cells._auto_microbatch(
        j_get_config(arch), J_SHAPES[shape], _FakeMesh(m),
        cells.DRYRUN_CLIENTS, seq_shard=True, budget=REF_BUDGET))
    got = cells.build_cell(get_config(arch), SHAPES[shape], m,
                           budget=REF_BUDGET)
    assert got.info == want


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_reference(arch, shape):
    assert analysis.model_flops_for(get_config(arch), SHAPES[shape]) == \
        j_analysis.model_flops_for(j_get_config(arch), J_SHAPES[shape])


def test_roofline_terms_pinned():
    got = analysis.roofline_terms(989e12, 3.35e12 * 0.5, 0.0)
    assert got["compute_s"] == pytest.approx(1.0)
    assert got["memory_s"] == pytest.approx(0.5)
    assert got["collective_s"] == 0.0
    assert got["dominant"] == "compute_s"
    assert got["step_s_lower_bound"] == pytest.approx(1.0)
    assert got["compute_fraction"] == pytest.approx(1.0)
    got = analysis.roofline_terms(989e9, 6.7e12, 450e9)
    assert got["dominant"] == "memory_s"
    assert got["step_s_lower_bound"] == pytest.approx(2.0)
    assert got["collective_s"] == pytest.approx(1.0)
    assert got["compute_fraction"] == pytest.approx(0.0005)
    # the reference's terms on its own hardware table, the same formula
    hw = dict(j_analysis.HW, link_bw=j_analysis.HW["ici_bw"])
    assert analysis.roofline_terms(1e15, 2e12, 3e11, hw=hw) == \
        j_analysis.roofline_terms(1e15, 2e12, 3e11)
    rec = analysis.roofline_record(2e12, 1e9, model_flops=1e12)
    assert rec["useful_fraction"] == pytest.approx(0.5)
    assert rec["roofline_fraction"] == pytest.approx(0.5)


def _llama_prefill(seq=1024, batch=2):
    """llama3-8b at d_model 256 over 2 heads of 128 (GQA 2:1)."""
    arch = reduced(get_config("llama3-8b"), layers=2, d_model=256,
                   vocab=512)
    arch = arch.replace(model=dataclasses.replace(
        arch.model, num_heads=2, num_kv_heads=1, head_dim=128))
    return arch, ShapeConfig("prefill_small", seq, batch, "prefill")


def test_counted_flops_of_a_reduced_prefill_lie_in_their_bounds():
    """2 N D of model_flops_for <= counted <= that + the plain attention's
    4 B H S^2 hd a layer (its full Sq x Sk products).  N counts the
    embedding and the untied head, which the prefill does not multiply
    by D (a gather; the head at the last position only): at S 1024 the
    attention's products exceed that gap."""
    arch, shape = _llama_prefill()
    cell = cells.build_cell(arch, shape)
    got = counting.count(cell.fn, *cell.args)
    m = arch.model
    low = analysis.model_flops_for(arch, shape)
    attn = 4 * shape.global_batch * m.num_heads * shape.seq_len ** 2 \
        * m.head_dim * m.num_layers
    assert low <= got.flops <= low + attn
    assert got.kernel_calls == {"attention_fwd": m.num_layers,
                                "lora_matmul_indexed": 4 * m.num_layers}


def test_count_charges_a_kernel_as_the_kernel():
    """The plain decode attention's fp32 cache copy is not live; the
    kernel's workspace is, and it reads the cache once."""
    arch = reduced(get_config("llama3-8b"), layers=1, d_model=256,
                   vocab=512)
    shape = ShapeConfig("decode_small", 4096, 4, "decode")
    cell = cells.build_cell(arch, shape)
    got = counting.count(cell.fn, *cell.args)
    args = sum(math.prod(shp) * torch.empty((), dtype=getattr(torch, dt))
               .element_size() for shp, dt in _port_leaves(cell.args).values())
    cache = cell.args[3]["dec"]
    kv = 2 * cache["k"].numel() * cache["k"].element_size()
    m = arch.model
    work = 4 * 4 * (4096 // 64) * m.num_heads * (m.head_dim + 2)
    assert got.peak_bytes >= args + work
    assert got.peak_bytes < args + work + kv // 4
    assert got.bytes >= kv
    assert got.kernel_calls["decode_attention"] == 1


@pytest.mark.parametrize("arch,shape", [
    ("mamba2-780m", ShapeConfig("train_small", 512, 32, "train")),
    ("llama3-8b", ShapeConfig("train_small", 256, 32, "train")),
    ("mamba2-780m", ShapeConfig("prefill_small", 1024, 2, "prefill"))])
def test_count_of_repeated_kernels_equals_running_each(arch, shape,
                                                      monkeypatch):
    """A kernel called again on the same shapes (each layer, each
    microbatch, the SSD scan's recompute-backward) is counted from its
    first call: the FLOPs, bytes and peak equal those of running every
    call."""
    cfg = reduced(get_config(arch), layers=3, d_model=128, vocab=256)
    cell = cells.build_cell(cfg, shape, microbatch=2) if shape.is_train \
        else cells.build_cell(cfg, shape)
    memo = counting.count(cell.fn, *cell.args)
    monkeypatch.setattr(counting._Tracker, "_key",
                        staticmethod(lambda *a: object()))
    cell = cells.build_cell(cfg, shape, microbatch=2) if shape.is_train \
        else cells.build_cell(cfg, shape)
    every = counting.count(cell.fn, *cell.args)
    assert memo == every


def test_full_size_train_cell_is_built_without_allocating_it():
    code = (
        "import resource, sys\n"
        "from repro_torch.config import SHAPES\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.launch import cells\n"
        "from repro_torch.tree import tree_leaves\n"
        "before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss\n"
        "cell = cells.build_cell(get_config('llama3-8b'), "
        "SHAPES['train_4k'])\n"
        "after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss\n"
        "n = sum(t.numel() for t in tree_leaves(cell.args[0]))\n"
        "print(before, after, n)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    before, after, n = (int(v) for v in out.stdout.split())
    assert n > 8e9                       # all of llama3-8b
    assert (after - before) * 1024 < 1e9  # ru_maxrss is in KiB


def test_dryrun_main_writes_every_field(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(
        dryrun, "get_config",
        lambda name: reduced(get_config(name), layers=2, d_model=64,
                             vocab=256))
    small = {"train_4k": ShapeConfig("train_4k", 64, 32, "train"),
             "prefill_32k": ShapeConfig("prefill_32k", 128, 2, "prefill"),
             "decode_32k": ShapeConfig("decode_32k", 128, 4, "decode"),
             "long_500k": ShapeConfig("long_500k", 512, 1, "decode")}
    monkeypatch.setattr(dryrun, "SHAPES", small)
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "mamba2-780m", "--json", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [r["shape"] for r in recs] == list(small)
    for r in recs:
        assert r["status"] == "ok", r
        for key in ("trace_s", "flops", "bytes", "peak_bytes", "fits_card",
                    "cards_needed", "cards_needed_is_lower_bound", "info"):
            assert key in r
        assert r["fits_card"] is True and r["cards_needed"] == 1
        for key in ("dominant", "step_s_lower_bound", "model_flops",
                    "useful_fraction", "compute_s", "memory_s"):
            assert key in r["roofline"]
        assert r["flops"] > 0 and r["bytes"] > 0 and r["peak_bytes"] > 0
    assert "4 ok, 0 skipped, 0 failed" in capsys.readouterr().out


def test_dryrun_skips_where_the_reference_skips():
    rec = dryrun.run_cell("llama3-8b", "long_500k", verbose=False)
    assert rec["status"] == "skipped"
    assert rec["reason"] == j_get_config("llama3-8b").shape_applicable(
        J_SHAPES["long_500k"])[1]


# ---------------------------------------------------------------------------
# the indexed LoRA's row chunks


@pytest.mark.parametrize("m", [1, 16, 32768, 1048576])
@pytest.mark.parametrize("k,n", LLAMA_KN)
def test_indexed_lora_row_chunks_bound_each_launch(m, k, n):
    r = 16
    chunks = lops.row_chunks(m, k, n, r)
    assert chunks[0][0] == 0 and chunks[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    for lo, hi in chunks:
        assert 0 < hi - lo
        assert lo % lops.INDEXED_BM == 0
        assert lops.indexed_work_bytes(hi - lo, k, n, r) \
            <= lops.INDEXED_WORK_CAP
        assert math.ceil((hi - lo) / lops.INDEXED_BM) \
            <= lops.INDEXED_MAX_ROW_TILES
    if m <= 16:
        assert chunks == [(0, m)]


def test_indexed_lora_chunking_keeps_the_served_shapes_in_one_launch():
    """The served prefills that earlier phases count launches of (300
    tokens at mamba2's and zamba2's ssm_in, 1500 frames at whisper's MLP)
    stay one launch each."""
    for k, n, m in ((1536, 6448, 300), (2048, 8384, 300), (1024, 4096, 1500),
                    (4096, 1024, 1500)):
        assert lops.row_chunks(m, k, n, 16) == [(0, m)]


# ---------------------------------------------------------------------------
# the whole-path profiles' count check (chip_smoke.py)


def _events(names):
    return [(name, 10 * i, 10 * i + 5) for i, name in enumerate(names)]


def test_profile_count_check_on_made_up_events():
    cs = _chip_smoke()
    names = (["void flash_fwd_kernel<float, 64>(...)"] * 2
             + ["lora_indexed_kernel<float>"] * 3
             + ["ampere_sgemm_128x64_nn", "Memcpy HtoD"]
             + [f"void repro::{k}<float>" for k in
                ("ssd_chunk_state", "ssd_state_pass", "ssd_cb",
                 "ssd_chunk_scan")])
    busy, by_name, kernels = cs.summarize(_events(names))
    assert busy == pytest.approx(len(names) * 5e-6)
    assert cs.own_kernels(kernels) == 9
    launched = {"flash_attention_fwd": 2, "lora_matmul_indexed": 3,
                "ssd_scan": 1}
    assert cs.profile_short(kernels, launched) is None
    short = cs.profile_short(kernels, dict(launched, lora_matmul_indexed=4))
    assert short is not None and "9" in short and "10" in short
    assert cs.profile_short(kernels, dict(launched, ssd_scan=2)) is not None
    assert cs.profile_short({}, {}) is None


def test_device_busy_profiles_again_when_short_then_fails(monkeypatch):
    cs = _chip_smoke()

    class W:
        launches = 0

    w = W()
    passes = []
    full = _events(["lora_indexed_kernel"] * 2)

    def fake_profile(torch_, run, prefix=256):
        run()
        passes.append(prefix)
        return 0.1, full if len(passes) == 3 else full[:1], (prefix, prefix)

    def run():
        w.launches += 2

    monkeypatch.setattr(cs, "_profile", fake_profile)
    monkeypatch.setattr(cs, "port_wrappers", lambda: {
        "lora_matmul_indexed": w})
    wall, busy, _, kernels = cs.device_busy(torch, run, "test")
    assert len(passes) == 3 and kernels == {"lora_indexed_kernel": 2}
    # each pass pads the run with more throwaway kernels than the last
    assert passes == [cs.PROFILE_PREFIX * (i + 1) for i in range(3)]
    passes.clear()
    monkeypatch.setattr(cs, "_profile",
                        lambda t, r, prefix=256: (r(), passes.append(prefix),
                                              (0.1, full[:1], (prefix, 0)))[-1])
    tries = cs.PROFILE_TRIES
    with pytest.raises(RuntimeError, match=f"no profile of {tries}") as err:
        cs.device_busy(torch, run, "test")
    assert len(passes) == tries
    assert f"{cs.PROFILE_PREFIX} of {cs.PROFILE_PREFIX} before the run, " \
        f"0 of {cs.PROFILE_PREFIX} after it" in str(err.value)


def test_host_self_times_equal_key_averages():
    """chip_smoke.host_self_times reads the profiler's raw events (parsing
    them into FunctionEvents takes seconds for each 10^5): an autograd
    step's host ops, their self CPU time and calls, as key_averages()
    gives them, same-name nesting (aten::sum in aten::sum) included."""
    from torch.profiler import ProfilerActivity, profile

    cs = _chip_smoke()
    w = torch.randn(16, 16, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            y = torch.nn.functional.gelu(torch.randn(8, 16) @ w).sum()
            y.backward()
    got = cs.host_self_times(torch, cs.raw_events(prof))
    want = {e.key: (e.self_cpu_time_total, e.count)
            for e in prof.key_averages() if e.self_cpu_time_total > 0}
    assert set(want) <= set(got) and "aten::sum" in want
    for key, (us, calls) in want.items():
        assert got[key][1] == calls, key
        assert got[key][0] == pytest.approx(us, rel=1e-9, abs=1e-3), key
    assert all(got[k][0] == 0 for k in set(got) - set(want))
