#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from src/repro_torch/csrc and shows that
each flash attention kernel runs on the tensor cores (HMMA instructions in
its SASS, no spills); holds each kernel against its plain PyTorch version
on the card (fp32 and bf16; the differentiable ones through autograd too),
and times it beside its bound, the plain version and a library call.  A
product-shaped fp32 kernel's bound takes the card's fastest fp32-accurate
route, 3xTF32 on the tensor cores.  Then it drives the port's three paths
at full width (random weights from a seed):

  * serving gpt2-small: 4 LoRA adapters through ServingEngine, contiguous
    and paged, tokens checked against the one-request reference and
    logits against the CPU plain path;
  * training gpt2-small: 3 SplitFT rounds (Algorithm 1, sync) of 5
    clients with int8 smashed activations on a length-Dirichlet partition
    of the synthetic corpus, through SplitFTSystem.run (each round a train
    step, an eval step and the accuracy controller's cut adjustment, with
    the round's wall time split into train, eval and host); a deadline-
    scheduled run checkpointed and resumed, whose resumed rounds must
    equal the straight run's; the train CLI on the card; then one step at
    full width and reduced depth on the card and on the CPU plain path
    from one state, whose losses and adapter gradients must agree;
  * training mamba2-780m: the same 3 rounds through SplitFTSystem at full
    depth (48 SSD layers, every SSD scan through the chunked-scan kernel)
    at batch 1 per client; then the card-vs-CPU step at 2 layers and seq
    512 (SSD chunk 256).

The launch counters are read around each path.  Every phase that fails
raises, so the exit code is non-zero; without a GPU it exits 1 before
printing any result.  The last line is {"ok": true, "device": {...}};
the line before it lists the kernels with their launches on the paths
and their times.

TF32 is off for matmuls and cuDNN: fp32 means fp32 here.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12,    # fp32 outside the tensor cores
              "bfloat16": 989e12}  # dense bf16 tensor cores
TF32_FLOPS = 495e12                # dense TF32 tensor cores; 3xTF32 takes
                                   # three TF32 MMAs per fp32-accurate product
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOGITS_TOL = 1e-3
TOP2_GAP = 1e-4

# serving path: full-width gpt2-small
N_REQUESTS, PROMPT, GEN, SLOTS, MAX_LEN, PAGE = 16, 128, 32, 8, 256, 16
RANKS = [16, 8, 16, 4]
SEED = 0
# training path: the paper setting of configs/gpt2_small.py (5 clients,
# batch 4, seq 512, cut 2, r_cut 8, r_others 16) with int8 smashed
# activations; the quickstart's corpus sizes and partition (alpha 0.9)
ROUNDS, NUM_SAMPLES, EVAL_SAMPLES = 3, 400, 64
# the card-vs-CPU step: full width, reduced depth
SMALL_LAYERS, SMALL_CLIENTS, SMALL_BATCH, SMALL_SEQ = 2, 2, 1, 128
STEP_TOL = 1e-4        # per-client losses, relative
RESUME_RTOL = 1e-6     # a resumed round's per-client losses vs straight
# adapter grads: (relative, share of max|g|) per smashed compressor; int8
# allows a few cotangent elements to take the neighbouring int8 code
GRAD_TOL = {"none": (1e-3, 1e-4), "int8": (1e-3, 2e-3)}
# mamba2 training path: batch cut from the paper's 4 to 1 per client (no
# remat: 48 layers of saved fp32 activations), seq 512 = 2 SSD chunks
M_BATCH, M_SEQ = 1, 512
# the SSD kernel in phase 2: (B, S, H, P, G, N, chunk, dt scale); G = 1
# and G > 1, chunks of 16, 64 and 256, S of one chunk and of 8 chunks;
# at chunk 256 every chunk's decay passes exp(88)
SSD_CASES = [(2, 64, 4, 16, 1, 16, 16, 1.0), (1, 256, 8, 64, 2, 128, 64, 1.0),
             (2, 256, 6, 64, 3, 128, 256, 1.0),
             (1, 2048, 4, 64, 1, 128, 256, 1.0),
             (1, 512, 4, 64, 1, 128, 256, 3.0)]
# ... and at the mamba2 training path's shape (5 clients x batch 1)
SSD_PATH = (5, 512, 48, 64, 1, 128, 256)
# more SSD cases for the tensor-core passes: H / G of 1, 2, 4 and 8, P of
# 16 and 32 (the P tiles), N of 16 and 256, a chunk of 80 (not a multiple
# of the 64-row tile), and the state past exp(88) at chunk 256
SSD_EDGES = [(1, 256, 8, 16, 1, 256, 64, 1.0),
             (2, 160, 8, 32, 4, 64, 80, 1.0),
             (1, 512, 16, 16, 2, 16, 256, 3.0),
             (1, 128, 4, 64, 4, 32, 16, 1.0)]
# the fused LoRA at the wide pass's tile edges: (M, K, N, r); M, K and N
# off the 64/128-row, 128-column and 32/64-deep tiles, K = 61 and 97 and
# N = 83 not 16-byte aligned rows (x, W, dx's W^T and A^T), M over
# several slices of the backward's dA/dB pass, and r of 1, 5, 8, 16 and 64
LORA_EDGES = [(37, 96, 80, 5), (1000, 768, 768, 16), (1, 61, 80, 1),
              (130, 97, 136, 8), (257, 96, 83, 64), (300, 768, 6448, 16)]
# flash forward and backward at the kernels' tile edges (16-row warp tile,
# 8-key accumulator tile, 64-key tile): (Sq, Sk, hd, window, q_offset) at
# B 2, GQA 4/2; (200, 1) with window 9 and offset 4 leaves rows that see
# no key
FLASH_EDGES = [(1, 1, 16, 0, 0), (15, 15, 32, 9, 4), (16, 16, 64, 0, 4),
               (17, 17, 16, 9, 0), (63, 63, 32, 0, 0), (64, 64, 64, 9, 4),
               (65, 65, 16, 0, 4), (200, 200, 32, 9, 0), (1, 200, 64, 0, 4),
               (200, 1, 64, 9, 4), (17, 65, 32, 0, 0), (65, 17, 16, 9, 0)]


def log(msg: str) -> None:
    print(msg, flush=True)


def fmt(values) -> str:
    return "[" + ", ".join(f"{float(v):.4f}" for v in values) + "]"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Device time per call: a sleep kernel holds the stream while the host
    enqueues every call, so host launch overhead is not timed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype: str, products: bool = False):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the operations over the card's fastest route for them.  For
    product-shaped fp32 work (products=True) that route is 3xTF32 on the
    tensor cores, 3 x FLOPs at the TF32 rate, which keeps fp32-class
    accuracy; elementwise fp32 work runs at the CUDA-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if products and dtype == "float32":
        t_ops, by = 3 * flops / TF32_FLOPS * 1e3, "operations (3xTF32)"
    else:
        t_ops, by = flops / PEAK_FLOPS[dtype] * 1e3, "operations"
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, by)


def work(nbytes: float, flops: float, products: bool = False) -> dict:
    """A phase 3 row's bound (fp32).  For products it also keeps the bound
    on the CUDA cores alone (the bound before the 3xTF32 route), which the
    log prints beside it."""
    cc = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]) * 1e3
    return dict(bound=bound(nbytes, flops, "float32", products),
                cuda_core_bound=cc if products else None)


# the tensor-core kernels of phase 1's report: mangled name -> source stem
MMA_KERNELS = {"flash_fwd_kernel": "flash_fwd",
               "flash_bwd_dq_kernel": "flash_bwd",
               "flash_bwd_dkv_kernel": "flash_bwd",
               "lora_gemm_kernel": "lora_fused",
               "lora_xa_mma_kernel": "lora_fused",
               "lora_dab_kernel": "lora_fused",
               "ssd_chunk_state": "ssd_scan", "ssd_cb": "ssd_scan",
               "ssd_chunk_scan": "ssd_scan",
               "lora_indexed_kernel": "lora_indexed"}
# kernels the report covers for registers, shared memory and spills only
# (CUDA cores: no HMMA expected)
CUDA_CORE_KERNELS = {"decode_kernel": "decode_attention",
                     "smashed_quant_kernel": "smashed_quant",
                     "dequant_kernel": "smashed_quant"}


def mma_build_report(_build, lib_path) -> None:
    """Phase 1: each tensor-core kernel's registers and spills (ptxas -v,
    from the build's logs), its shared memory (the SSD passes' at the
    mamba2 path's N and chunk, the decode kernel's at the serving path's
    hd 64 and group 1), and the count of tensor-core MMA instructions
    (HMMA) in its SASS (cuobjdump -sass), for every instantiation of the
    flash, fused LoRA (thin pass, GEMM and the dA/dB pass), indexed LoRA
    and SSD scan kernels; the decode and int8 kernels (CUDA cores) for
    registers and spills, with the int8 kernels' clusters and grids.
    Fails if one spills, a tensor-core kernel has no HMMA, or a kernel is
    missing."""
    import re
    names = {**MMA_KERNELS, **CUDA_CORE_KERNELS}
    kern = re.compile(r"(" + "|".join(names) + r")I(f|13__nv_bfloat16)"
                      r"((?:L[ib]\d+E)*)E")

    def label(mangled):
        m = kern.search(mangled)
        return m and (m.group(1), "fp32" if m.group(2) == "f" else "bf16",
                      tuple(int(v) for v in re.findall(r"L[ib](\d+)E",
                                                       m.group(3))))

    info = {}
    for stem in sorted(set(names.values())):
        cur = None
        for line in (lib_path.parent / f"{stem}.log").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = label(m.group(1))
                if cur:
                    info[cur] = {"hmma": 0}
                continue
            if not cur:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                info[cur]["stack"] = int(m.group(1))
                info[cur]["spills"] = int(m.group(2)) + int(m.group(3))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                info[cur]["regs"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                info[cur]["static_smem"] = int(m.group(1))
    cuobjdump = str(Path(_build.find_nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = label(m.group(1))
        elif cur in info and "HMMA" in line:
            info[cur]["hmma"] += 1
    missing = set(names) - {name for name, _, _ in info}
    if missing:
        raise RuntimeError(f"tensor-core kernels missing from the build's "
                           f"ptxas output: {sorted(missing)}")
    lib = _build.library()
    code = {"fp32": 0, "bf16": 1}
    _, _, _, _, _, n_path, q_path = SSD_PATH
    for (name, dt, args), r in sorted(info.items()):
        c = code[dt]
        if name.startswith("flash"):
            hd = args[0]
            smem = (lib.flash_fwd_smem(hd, c) if "fwd" in name else
                    lib.flash_bwd_smem(int("dkv" in name), hd, c))
            what = f"hd {hd}"
        elif name == "lora_xa_mma_kernel":
            rn, kn = args
            smem = lib.lora_fused_xa_smem(rn, kn, c)
            what = (f"thin pass {'xa = x @ A' if kn else 'gb = g @ B^T'}, "
                    f"ranks up to {rn}")
        elif name == "lora_gemm_kernel":
            bm, kn = args
            smem = lib.lora_fused_smem(bm, kn, c)
            what = (f"{bm} x 128 tile, W read "
                    f"{'k-major (forward)' if kn else 'n-major (dx)'}")
        elif name == "lora_dab_kernel":
            smem = lib.lora_fused_dab_smem(args[0], c)
            what = (f"dA/dB pass, ranks up to {args[0]}, "
                    f"{lib.lora_fused_dab_ctas(10240, 768, 768)} CTAs at "
                    f"M 10240 K = N = 768")
        elif name == "smashed_quant_kernel":
            smem = 0
            what = (f"{'quantize' if args[0] else 'round trip'}, clusters "
                    f"of {lib.smashed_quant_cluster()} CTAs, "
                    f"{lib.smashed_quant_ctas(5, 768)} CTAs at G 5 d 768, "
                    f"static shared memory {r.get('static_smem')} B")
        elif name == "dequant_kernel":
            smem = 0
            what = (f"{lib.smashed_dequant_ctas(5, 2048, 768)} CTAs at G 5 "
                    f"M 2048 d 768")
        elif name == "lora_indexed_kernel":
            smem = 0
            what = (f"{lib.lora_indexed_ctas(SLOTS, 768, 768)} CTAs at the "
                    f"tick (M {SLOTS}, K = N = 768), static shared memory "
                    f"{r.get('static_smem')} B")
        elif name == "decode_kernel":
            smem = lib.decode_attention_smem(1, 64, c)
            what = (f"{'paged' if args[0] else 'contiguous'}, "
                    f"{lib.decode_attention_chunk()} positions per CTA, at "
                    f"hd 64 group 1")
        else:
            kind = {"ssd_chunk_state": 0, "ssd_cb": 1,
                    "ssd_chunk_scan": 2}[name]
            pt = args[0] if args else 64
            smem = lib.ssd_scan_smem(kind, pt, n_path, q_path, c)
            what = (f"P tile {pt}, " if args else "") + \
                f"at N {n_path} chunk {q_path}"
        log(f"phase 1: {name}<{dt}, {what}>: {r.get('regs')} "
            f"registers, {smem} B dynamic shared memory, {r.get('stack')} B "
            f"stack, {r.get('spills')} B spilled, {r['hmma']} HMMA in SASS")
    bad = [k for k, r in info.items() if r.get("spills") or (
        r["hmma"] == 0 and k[0] in MMA_KERNELS)]
    if bad:
        raise RuntimeError(f"tensor-core kernels without MMAs or kernels "
                           f"with spills: {bad}")


def device_busy(torch, run):
    """Run `run` under torch.profiler's CUDA activity.  Returns (wall s,
    device-busy s or None, {kernel name: device s}, {kernel name:
    launches}); busy is the union of the recorded device intervals, None
    when nothing was recorded."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name, kernels = [], {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                (e.time_range.end - e.time_range.start) * 1e-6
            if not e.name.startswith(("Memcpy", "Memset")):
                kernels[e.name] = kernels.get(e.name, 0) + 1
    if not spans:
        return wall, None, {}, {}
    busy, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in sorted(spans):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    return wall, busy * 1e-6, by_name, kernels


def host_top(torch, run, top: int = 8):
    """Run `run` under torch.profiler's CPU and CUDA activities; return
    (wall s, [(host op, self CPU ms, calls)] of the `top` ops by self CPU
    time).  A second profile, apart from device_busy's, because recording
    the host slows it and would raise the idle share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return wall, [(e.key, e.self_cpu_time_total * 1e-3, e.count)
                  for e in rows[:top]]


def pass_ms(torch, fn, names, iters: int = 10, launches: bool = False):
    """Device ms per call of each kernel whose name contains one of
    `names`, from torch.profiler over `iters` calls of fn; None when the
    profiler recorded no device activity.  launches: also the device
    kernels per call, of any name ("kernels/call") and of those names
    ("own/call")."""
    fn()
    torch.cuda.synchronize()
    _, busy, by_name, kernels = device_busy(
        torch, lambda: [fn() for _ in range(iters)])
    if busy is None:
        return None
    out = {n: sum(v for k, v in by_name.items() if n in k) * 1e3 / iters
           for n in names}
    if launches:
        out["kernels/call"] = sum(kernels.values()) / iters
        out["own/call"] = sum(c for k, c in kernels.items()
                              if any(n in k for n in names)) / iters
    return out


def check_kernels_per_call(passes, own: int, total: int, what: str) -> None:
    """The profiler's kernels per call: `own` of the listed kernels and
    `total` in all (nothing to check when the profiler saw nothing)."""
    if passes is not None and (passes["own/call"] != own
                               or passes["kernels/call"] != total):
        raise RuntimeError(f"{what}: {passes['own/call']} own kernels and "
                           f"{passes['kernels/call']} in all per call, "
                           f"want {own} and {total}")


def fmt_passes(passes) -> str:
    if passes is None:
        return "per-pass device time not measured (no profiler activity)"
    units = {"kernels/call": "kernels per call",
             "own/call": "of them its own"}
    return ", ".join(f"{v:.1f} {units[k]}" if k in units
                     else f"{k} {v:.4f} ms" for k, v in passes.items())


LORA_PASSES = ("lora_xa_mma_kernel", "lora_gemm_kernel")
LORA_BWD_PASSES = LORA_PASSES + ("lora_dab_kernel",)
SSD_PASSES = ("ssd_chunk_state", "ssd_state_pass", "ssd_cb",
              "ssd_chunk_scan")


def ssd_executed_flops(b, s, h, p, g, n, q, ks=8):
    """FLOPs the SSD kernel's MMAs execute (2 per multiply-add, one TF32
    pass), by pass, from its tiling (csrc/ssd_scan.cu): P padded to the
    16/32/64 tile, N to 16 (and to 128-column passes in the chunk state),
    64-row tiles, each warp's seen 8-column blocks of a diagonal tile."""
    tq, nc = 64, s // q
    pt = 16 if p <= 16 else 32 if p <= 32 else 64
    nk = (n + 15) // 16 * 16
    ntile = (q + tq - 1) // tq
    ksteps = sum((min(tq, q - i * tq) + ks - 1) // ks * ks
                 for i in range(ntile))
    state = pt * 128 * ((n + 127) // 128) * ksteps * 2

    def seen(z, it, w):
        nj = 8 if it < z else 2 * w + 2
        nj = min(nj, (q - it * tq + 7) // 8)
        return (nj + 1) // 2 * 2 if ks == 16 else nj

    cb = sum(16 * 8 * seen(z, it, w) * nk * 2 for z in range(ntile)
             for it in range(z + 1) for w in range(4))
    scan = sum(tq * pt * nk * 2 + sum(16 * pt * 8 * seen(z, it, w) * 2
                                      for it in range(z + 1)
                                      for w in range(4))
               for z in range(ntile))
    return {"chunk_state": b * h * nc * state, "cb": b * g * nc * cb,
            "chunk_scan": b * h * nc * scan}


def max_err(torch, got, want, dtype: str, what: str,
            scaled: bool = False) -> float:
    """max |got - want|, asserting closeness at TOL[dtype].  scaled: the
    absolute part of the tolerance is TOL times max|want| (at least 1),
    for reductions whose rounding grows with the size of their terms."""
    got, want = got.float().cpu(), want.float().cpu()
    err = float((got - want).abs().max())
    atol = TOL[dtype] * (max(1.0, float(want.abs().max())) if scaled
                         else 1.0)
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=atol,
                               msg=lambda m: f"{what} ({dtype}): {m}")
    return err


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.lora_matmul import ops as lops
    from repro_torch.kernels.smashed_quant import ops as sops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models.model import build_model
    from repro_torch.runtime import serving

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)

    # -- phase 0: the card --------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {name}; TF32 off (matmul and cuDNN)")

    # -- phase 1: build -----------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"phase 1: built {lib_path.name} from "
        f"{[p.name for p in _build.sources()]} in "
        f"{time.perf_counter() - t0:.1f} s")
    mma_build_report(_build, lib_path)

    gen = torch.Generator().manual_seed(SEED)

    def rand(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dtype).to(dev)

    wrappers = {"flash_attention_fwd": fops.flash_attention_fwd,
                "lora_matmul_indexed": lops.lora_matmul_indexed,
                "decode_attention": dops.decode_attention,
                "decode_attention_paged": dops.decode_attention_paged,
                "flash_attention_bwd": fops.flash_attention_bwd,
                "lora_matmul_fwd": lops.lora_matmul_fwd,
                "lora_matmul_bwd": lops.lora_matmul_bwd,
                "int8_roundtrip_smashed": sops.int8_roundtrip_smashed,
                "int8_quantize_smashed": sops.int8_quantize_smashed,
                "int8_dequantize_smashed": sops.int8_dequantize_smashed,
                "ssd_scan": ssd_ops.ssd_scan_fwd}
    worst = {k: 0.0 for k in wrappers}

    # -- phase 2: every kernel against its plain version ---------------------
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        errs = {k: 0.0 for k in wrappers}
        flash_cases = [(1, s, 12, 12, 0) for s in (128, 512, 1024)]
        flash_cases.append((2, 200, 8, 2, 50))          # ragged GQA + window
        for b, s, h, kvh, window in flash_cases:
            q, k, v = (rand(b, s, h, 64, dtype=dt), rand(b, s, kvh, 64, dtype=dt),
                       rand(b, s, kvh, 64, dtype=dt))
            out, lse = fops.flash_attention_fwd(q, k, v, window=window)
            r_out, r_lse = fops.ref.attention_fwd(q, k, v, window=window)
            e = max(max_err(torch, out, r_out, dname, f"flash S={s}"),
                    max_err(torch, lse, r_lse, dname, f"flash lse S={s}"))
            errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"], e)
        for m in (8, 512):
            args = lora_args(torch, rand, m, dt, gen)
            e = max_err(torch, lops.lora_matmul_indexed(*args),
                        lops.ref.lora_matmul_indexed(*args), dname,
                        f"lora M={m}")
            errs["lora_matmul_indexed"] = max(errs["lora_matmul_indexed"], e)
        for window in (0, 100):
            q, k, v, clen = decode_args(torch, rand, dt, dev, s=1024,
                                        lens=[0, 1, 63, 64, 65, 500, 1023,
                                              1024])
            e = max_err(torch, dops.decode_attention(q, k, v, clen,
                                                     window=window),
                        dops.ref.decode_attention(q, k, v, clen,
                                                  window=window),
                        dname, f"decode window={window}")
            errs["decode_attention"] = max(errs["decode_attention"], e)
            kp, vp, pt = paged_args(torch, k, v, gen, dev, ps=16)
            paged = dops.decode_attention_paged(q, kp, vp, pt, clen,
                                                window=window)
            e = max_err(torch, paged,
                        dops.ref.decode_attention_paged(q, kp, vp, pt, clen,
                                                        window=window),
                        dname, f"paged decode window={window}")
            errs["decode_attention_paged"] = max(
                errs["decode_attention_paged"], e)
            if not torch.equal(paged, dops.decode_attention(
                    q, k, v, clen, window=window)):
                raise RuntimeError(f"paged decode differs from contiguous "
                                   f"decode (window={window}, {dname})")
        check_serving_invariants(torch, rand, dname, dt, dev, gen)
        check_flash_edges(torch, rand, dname, dt, errs)
        check_training_kernels(torch, rand, dname, dt, errs)
        check_mamba2_kernels(torch, rand, dname, dt, errs)
        log(f"phase 2 ({dname}, tol {TOL[dname]}): max |kernel - plain| "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        if dname == "float32":
            worst = errs

    # -- phase 3: times at the paths' shapes (fp32) -------------------------
    rows = {}
    b, s, h, hd = 1, PROMPT, 12, 64
    q, k, v = rand(b, s, h, hd), rand(b, s, h, hd), rand(b, s, h, hd)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = s * (s + 1) // 2
    rows["flash_attention_fwd"] = dict(
        ms=cuda_ms(torch, lambda: fops.flash_attention_fwd(q, k, v)),
        plain_ms=cuda_ms(torch, lambda: fops.ref.attention_fwd(q, k, v)),
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        # read q, k, v; write out, lse.  Per visible pair: s and p v
        **work(4 * (4 * b * s * h * hd + b * h * s), 4 * hd * h * b * pairs,
               products=True),
        shape=f"B={b} S={s} H={h} hd={hd} causal fp32 (serving prefill)")
    kd, r = 768, 16
    for kname, m in (("lora_matmul_indexed", SLOTS),
                     ("lora_matmul_indexed (prefill)", PROMPT)):
        args = lora_args(torch, rand, m, torch.float32, gen)
        if kname.endswith("(prefill)"):   # one request: one adapter
            args = args[:5] + (torch.full_like(args[5], 1),)
        n_ids = int(torch.unique(args[5]).numel())
        worst["lora_matmul_indexed"] = max(
            worst["lora_matmul_indexed"],
            max_err(torch, lops.lora_matmul_indexed(*args),
                    lops.ref.lora_matmul_indexed(*args), "float32",
                    f"lora M={m}"))
        ctas = _build.library().lora_indexed_ctas(m, kd, kd)
        rows[kname] = dict(
            ms=cuda_ms(torch, lambda: lops.lora_matmul_indexed(*args)),
            plain_ms=cuda_ms(torch,
                             lambda: lops.ref.lora_matmul_indexed(*args)),
            library_ms=None,
            passes=pass_ms(torch, lambda: lops.lora_matmul_indexed(*args),
                           ("lora_indexed_kernel",), launches=True),
            **work(4 * (m * kd + kd * kd + n_ids * 2 * kd * r + m * kd + 4
                        + m), 2 * m * kd * kd + 4 * m * kd * r,
                   products=m > SLOTS),
            shape=f"M={m} K=N={kd} r={r} P=4 fp32, {ctas} CTAs")
    lens = [128 + 4 * i for i in range(SLOTS)]
    q1, kc, vc, clen = decode_args(torch, rand, torch.float32, dev,
                                   s=MAX_LEN, lens=lens)
    kp, vp, pt = paged_args(torch, kc, vc, gen, dev, ps=PAGE)
    tot = sum(lens)
    dec_bytes = 4 * (2 * SLOTS * 12 * 64 + 2 * tot * 12 * 64 + SLOTS)
    dec_flops = 4 * tot * 12 * 64
    chunk = _build.library().decode_attention_chunk()
    dec_ctas = 12 * sum((n - 1) // chunk + 1 for n in lens)
    mask = (torch.arange(MAX_LEN, device=dev)[None, :]
            < clen[:, None])[:, None, None, :]
    qs, ks, vs = q1[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
    ks, vs = ks.contiguous(), vs.contiguous()
    rows["decode_attention"] = dict(
        ms=cuda_ms(torch, lambda: dops.decode_attention(q1, kc, vc, clen)),
        plain_ms=cuda_ms(torch, lambda: dops.ref.decode_attention(
            q1, kc, vc, clen)),
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask)),
        passes=pass_ms(torch, lambda: dops.decode_attention(q1, kc, vc, clen),
                       ("decode_kernel",), launches=True),
        **work(dec_bytes, dec_flops),
        shape=f"B={SLOTS} S={MAX_LEN} cache_len {lens[0]}..{lens[-1]} fp32, "
              f"{dec_ctas} live CTAs")
    rows["decode_attention_paged"] = dict(
        ms=cuda_ms(torch, lambda: dops.decode_attention_paged(
            q1, kp, vp, pt, clen)),
        plain_ms=cuda_ms(torch, lambda: dops.ref.decode_attention_paged(
            q1, kp, vp, pt, clen)),
        library_ms=None,
        passes=pass_ms(torch, lambda: dops.decode_attention_paged(
            q1, kp, vp, pt, clen), ("decode_kernel",), launches=True),
        **work(dec_bytes + 4 * pt.numel(), dec_flops),
        shape=f"B={SLOTS} ps={PAGE} cache_len {lens[0]}..{lens[-1]} fp32, "
              f"{dec_ctas} live CTAs")
    rows.update(time_training_kernels(torch, F, rand, worst))
    rows.update(time_ssd_kernel(torch, rand, worst))
    rows.update(time_mamba2_lora(torch, rand, worst))
    for kname, row in rows.items():
        lib = ("n/a" if row["library_ms"] is None
               else f"{row['library_ms']:.4f}")
        extra = ""
        if "composition_ms" in row:
            extra = (f", torch composition {row['composition']} "
                     f"{row['composition_ms']:.4f} ms")
        if row["cuda_core_bound"] is not None:
            extra += (f"; fp32 CUDA-core bound "
                      f"{row['cuda_core_bound']:.4f} ms")
        if "tile" in row:
            extra += f"; wide pass in {row['tile']} x 128 CTAs"
        if "passes" in row:
            extra += f"; per pass (profiler): {fmt_passes(row['passes'])}"
        if "pass_bound" in row:
            pname, (pb, pby) = row["pass_bound"]
            extra += f"; {pname} bound {pb:.4f} ms ({pby})"
        log(f"phase 3 [{name}, {card}] {kname} at {row['shape']}: kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
            f"{lib} ms, bound {row['bound'][0]:.4f} ms "
            f"({row['bound'][1]}){extra}")

    # -- phase 4: the serving path ------------------------------------------
    arch = get_config("gpt2-small")
    model = build_model(arch, device=dev)
    params = model.init_params(torch.Generator().manual_seed(SEED))
    pool = serving.build_adapter_pool(
        model, torch.Generator().manual_seed(SEED + 1), len(RANKS),
        ranks=RANKS)
    rng = np.random.default_rng(SEED + 2)
    reqs = [serving.Request(rid=i, adapter=i % len(RANKS),
                            tokens=rng.integers(3, arch.model.vocab_size,
                                                size=PROMPT),
                            max_new=GEN) for i in range(N_REQUESTS)]
    warm = [serving.Request(rid=1000 + i, adapter=i, tokens=reqs[i].tokens,
                            max_new=4) for i in range(2)]

    launches = {k: 0 for k in wrappers}
    serve_kernels = ("flash_attention_fwd", "lora_matmul_indexed",
                     "decode_attention", "decode_attention_paged")
    tokens = {}
    for page in (0, PAGE):
        mode = "paged" if page else "contiguous"
        engine = serving.ServingEngine(
            model, params, pool,
            serving.ServeConfig(num_slots=SLOTS, max_len=MAX_LEN,
                                page_size=page), device=dev)
        engine.run(warm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        res = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: w.launches for k, w in wrappers.items()}
        for kname, c in counts.items():
            launches[kname] += c
        want = {"flash_attention_fwd", "lora_matmul_indexed",
                "decode_attention_paged" if page else "decode_attention"}
        idle = [k for k in want if counts[k] == 0]
        counts = {k: counts[k] for k in serve_kernels}
        if idle:
            raise RuntimeError(f"{mode} serving never launched {idle}")
        tokens[mode] = [r["tokens"] for r in res]
        n_tok = sum(len(t) for t in tokens[mode])
        ttft = np.percentile([r["t_first"] - r["t_submit"] for r in res], 50)
        log(f"phase 4 {mode} [{name}, {card}]: {N_REQUESTS} requests x "
            f"{GEN} tokens (prompt {PROMPT}, {SLOTS} slots, max_len "
            f"{MAX_LEN}) in {wall:.3f} s: {n_tok / wall:.1f} tokens/s, "
            f"TTFT p50 {ttft * 1e3:.1f} ms, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
            f"launches {counts}")
        if not page:
            profile_run(torch, serving, engine, reqs, name, card)
        del engine
    if tokens["paged"] != tokens["contiguous"]:
        raise RuntimeError("paged tokens differ from contiguous tokens")


    serial, logits = serving.serial_reference(
        model, params, pool, reqs, max_len=MAX_LEN, return_logits=True)
    cut = 0
    for r, got in zip(reqs, tokens["contiguous"]):
        top2 = torch.topk(logits[r.rid], 2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        upto = next((i for i, g in enumerate(gaps) if g < TOP2_GAP), GEN)
        cut += upto < GEN
        if got[:upto] != serial[r.rid][:upto]:
            raise RuntimeError(f"request {r.rid}: engine tokens {got} != "
                               f"serial {serial[r.rid]} before position "
                               f"{upto}")
    log(f"phase 4: engine tokens equal serial_reference on {N_REQUESTS} "
        f"requests; {cut} compared only up to a top-2 logit gap < "
        f"{TOP2_GAP}")

    # the same model on the CPU (plain versions): prefill + 4 decode steps
    cpu_model = build_model(arch, device="cpu")
    cpu_params = cpu_model.init_params(torch.Generator().manual_seed(SEED))
    cpu_pool = serving.build_adapter_pool(
        cpu_model, torch.Generator().manual_seed(SEED + 1), len(RANKS),
        ranks=RANKS)
    req = reqs[1]
    steps = serial[req.rid][:5]
    with torch.no_grad():
        outs = {}
        for role, dv, mdl, prm, pl in (
                ("card", dev, model, params, pool),
                ("cpu", torch.device("cpu"), cpu_model, cpu_params,
                 cpu_pool)):
            ad = serving.attach_ids(pl, [req.adapter])
            cache = mdl.init_cache((1,), MAX_LEN)
            toks = torch.as_tensor(np.asarray(req.tokens, np.int32)[None],
                                   device=dv)
            lg, cache = mdl.prefill(prm, ad, {"tokens": toks}, cache)
            seq = [lg[0, -1].float().cpu()]
            for tok in steps[:4]:
                lg, cache = mdl.decode_step(
                    prm, ad, torch.tensor([[tok]], dtype=torch.int32,
                                          device=dv), cache)
                seq.append(lg[0, -1].float().cpu())
            outs[role] = torch.stack(seq)
        diff = float((outs["card"] - outs["cpu"]).abs().max())
        torch.testing.assert_close(
            outs["card"], outs["cpu"], rtol=LOGITS_TOL, atol=LOGITS_TOL,
            msg=lambda m: f"card vs CPU logits: {m}")
        if not torch.isfinite(outs["card"]).all():
            raise RuntimeError("non-finite logits on the card")
    log(f"phase 4: prefill + 4 decode logits on the card match the CPU "
        f"plain path: max |diff| {diff:.3e} (tol {LOGITS_TOL}: fp32 sums "
        f"in another order through 12 layers and the 50257-wide head)")

    # -- phase 5: the training path ------------------------------------------
    for kname, c in train_phase(torch, dev, wrappers, name, card).items():
        launches[kname] += c

    # -- phase 5b, 5c: checkpoint resume, the train CLI ----------------------
    resume_phase(torch, dev, wrappers, name, card)
    cli_phase(torch, wrappers, name, card)

    # -- phase 6: one step at full width, reduced depth, card vs CPU --------
    small_step_check(torch, dev, "gpt2-small", SMALL_SEQ, tuple(GRAD_TOL),
                     "phase 6")

    # -- phase 7: the mamba2 training path ----------------------------------
    for kname, c in mamba2_phase(torch, dev, wrappers, name, card).items():
        launches[kname] += c

    # -- phase 8: one mamba2 step at full width, reduced depth, card vs CPU -
    small_step_check(torch, dev, "mamba2-780m", M_SEQ, ("none",), "phase 8")

    # -- phase 9: results -----------------------------------------------------
    fa = "src/repro/kernels/flash_attention/kernel.py"
    lk = "src/repro/kernels/lora_matmul/kernel.py"
    da = "src/repro/kernels/decode_attention/kernel.py"
    sk = "src/repro/kernels/smashed_quant/kernel.py"
    csrc = "src/repro_torch/csrc/"
    sources = {"flash_attention_fwd": ("flash_fwd.cu", f"{fa}:151"),
               "lora_matmul_indexed": ("lora_indexed.cu", f"{lk}:186"),
               "decode_attention": ("decode_attention.cu", f"{da}:187"),
               "decode_attention_paged": ("decode_attention.cu", f"{da}:133"),
               "flash_attention_bwd": ("flash_bwd.cu", f"{fa}:305"),
               "lora_matmul_fwd": ("lora_fused.cu", f"{lk}:99"),
               "lora_matmul_bwd": ("lora_fused.cu", f"{lk}:298"),
               "int8_roundtrip_smashed": ("smashed_quant.cu", f"{sk}:118"),
               "int8_quantize_smashed": ("smashed_quant.cu", f"{sk}:105"),
               "int8_dequantize_smashed": ("smashed_quant.cu", f"{sk}:129"),
               "ssd_scan": ("ssd_scan.cu",
                            "src/repro/kernels/ssd_scan/kernel.py:82")}
    kernels = []
    for kname, (src, replaces) in sources.items():
        row = rows[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": csrc + src,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": worst[kname], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0],
            "bound_by": row["bound"][1], "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def profile_run(torch, serving, engine, reqs, name, card):
    """The same workload again on a warm engine under the profiler: the
    device-busy share of the serving wall time, and the top kernels."""
    again = [serving.Request(rid=2000 + r.rid, adapter=r.adapter,
                             tokens=r.tokens, max_new=r.max_new)
             for r in reqs]
    wall, busy, by_name, _ = device_busy(torch, lambda: engine.run(again))
    if busy is None:
        log(f"phase 4 profile [{name}, {card}]: device busy share not "
            f"measured (the profiler recorded no device activity); wall "
            f"{wall:.3f} s")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"phase 4 profile [{name}, {card}]: contiguous run under "
        f"torch.profiler: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"(idle share {1 - busy / wall:.3f}); top device time: "
        + "; ".join(f"{k[:60]} {v * 1e3:.1f} ms" for k, v in top))


def check_serving_invariants(torch, rand, dname, dt, dev, gen):
    """Phase 2: what the serving path's exactness rests on, bit for bit.
    The indexed LoRA's rows do not depend on M (1, 8 and 128 rows: the
    serial reference, the tick and a prefill bucket); a decode row does
    not depend on B (1 against the tick's 8), contiguous and paged; paged
    equals contiguous at the tick; repeated calls are equal."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.lora_matmul import ops as lops

    def same(what, u, v):
        if not torch.equal(u, v):
            raise RuntimeError(f"{what} ({dname}): not bit-equal")

    x, w, a, b, s, ids = lora_args(torch, rand, 128, dt, gen)
    full = lops.lora_matmul_indexed(x, w, a, b, s, ids)
    same("indexed LoRA M=128 repeated", full,
         lops.lora_matmul_indexed(x, w, a, b, s, ids))
    same("indexed LoRA M=8 rows vs M=128",
         lops.lora_matmul_indexed(x[:8], w, a, b, s, ids[:8]), full[:8])
    for i in (0, 7, 77, 127):
        same(f"indexed LoRA M=1 row {i} vs M=128",
             lops.lora_matmul_indexed(x[i:i + 1], w, a, b, s,
                                      ids[i:i + 1])[0], full[i])
    lens = [128 + 4 * i for i in range(SLOTS)]
    q, k, v, clen = decode_args(torch, rand, dt, dev, s=MAX_LEN, lens=lens)
    kp, vp, pt = paged_args(torch, k, v, gen, dev, ps=PAGE)
    tick = dops.decode_attention(q, k, v, clen)
    tickp = dops.decode_attention_paged(q, kp, vp, pt, clen)
    same("paged vs contiguous decode at the tick", tickp, tick)
    same("decode repeated", dops.decode_attention(q, k, v, clen), tick)
    for i in range(SLOTS):
        sl = slice(i, i + 1)
        same(f"decode B=1 row {i} vs B={SLOTS}",
             dops.decode_attention(q[sl], k[sl], v[sl], clen[sl])[0], tick[i])
        same(f"paged decode B=1 row {i} vs B={SLOTS}",
             dops.decode_attention_paged(q[sl], kp, vp, pt[sl], clen[sl])[0],
             tickp[i])
    log(f"phase 2 ({dname}): indexed LoRA rows equal at M = 1, 8, 128; "
        f"decode rows equal at B = 1 and {SLOTS}, paged equal to "
        f"contiguous, repeats equal (bit for bit)")


def check_flash_edges(torch, rand, dname, dt, errs):
    """Phase 2: the flash forward and backward against their plain
    versions at FLASH_EDGES."""
    from repro_torch.kernels.flash_attention import ops as fops

    for sq, sk, hd, window, q_offset in FLASH_EDGES:
        q, do = rand(2, sq, 4, hd, dtype=dt), rand(2, sq, 4, hd, dtype=dt)
        k, v = rand(2, sk, 2, hd, dtype=dt), rand(2, sk, 2, hd, dtype=dt)
        kw = dict(window=window, q_offset=q_offset)
        what = f"Sq={sq} Sk={sk} hd={hd} window={window} q_offset={q_offset}"
        out, lse = fops.flash_attention_fwd(q, k, v, **kw)
        r_out, r_lse = fops.ref.attention_fwd(q, k, v, **kw)
        errs["flash_attention_fwd"] = max(
            errs["flash_attention_fwd"],
            max_err(torch, out, r_out, dname, f"flash {what}"),
            max_err(torch, lse, r_lse, dname, f"flash lse {what}"))
        got = fops.flash_attention_bwd(q, k, v, r_out, r_lse, do, **kw)
        want = fops.ref.attention_bwd(q, k, v, r_out, r_lse, do, **kw)
        errs["flash_attention_bwd"] = max(
            [errs["flash_attention_bwd"]]
            + [max_err(torch, g, w, dname, f"flash bwd {what} d{n}")
               for n, g, w in zip("qkv", got, want)])


def same_bits(torch, kname, first, again, what):
    """Two calls of a kernel on the same inputs give the same bits."""
    for u, v in zip(first, again):
        if not torch.equal(u, v):
            raise RuntimeError(f"{kname} at {what}: two calls on the same "
                               f"inputs differ")


def check_training_kernels(torch, rand, dname, dt, errs):
    """Phase 2 for the training slice's kernels: each against its plain
    version on the same inputs, and the differentiable ones through
    autograd against plain autograd.  Fills errs[kernel] (max |diff|)."""
    from repro_torch.core import smashed
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.lora_matmul import ops as lops
    from repro_torch.kernels.smashed_quant import ops as sops
    from repro_torch.models import common

    def worst(kname, pairs, what):
        # the LoRA gradients reduce over up to 1000 rows of O(10) terms:
        # their rounding scales with the output, so the tolerance does
        e = max(max_err(torch, g, w, dname, f"{what} {i}",
                        scaled=kname == "lora_matmul_bwd")
                for i, (g, w) in enumerate(pairs))
        errs[kname] = max(errs[kname], e)

    # flash backward from the same residuals: full, GQA + window, offset
    for b, s, h, kvh, window, q_offset in ((1, 512, 12, 12, 0, 0),
                                           (2, 200, 8, 2, 50, 0),
                                           (2, 77, 4, 2, 0, 9)):
        q, do = rand(b, s, h, 64, dtype=dt), rand(b, s, h, 64, dtype=dt)
        k, v = rand(b, s, kvh, 64, dtype=dt), rand(b, s, kvh, 64, dtype=dt)
        kw = dict(window=window, q_offset=q_offset)
        out, lse = fops.flash_attention_fwd(q, k, v, **kw)
        worst("flash_attention_bwd",
              zip(fops.flash_attention_bwd(q, k, v, out, lse, do, **kw),
                  fops.ref.attention_bwd(q, k, v, out, lse, do, **kw)),
              f"flash bwd S={s} window={window}")
    # autograd through the Function vs autograd through the plain forward
    ins = [t.requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(fops.flash_attention(*ins, **kw), ins, do)
    want = torch.autograd.grad(fops.ref.attention_fwd(*ins, **kw)[0], ins,
                               do)
    worst("flash_attention_bwd", zip(got, want), "flash autograd")

    for m, kd, n, r in LORA_EDGES:
        mask = (torch.arange(r) < max(1, r - 2)).float().to(q.device)
        x, g = rand(m, kd, dtype=dt), rand(m, n, dtype=dt)
        w = rand(kd, n, dtype=dt, scale=kd ** -0.5)
        a = (rand(kd, r, scale=r ** -0.5) * mask).to(dt)
        bb = (rand(r, n, scale=0.02) * mask[:, None]).to(dt)
        sc = torch.tensor(2.0, device=q.device)
        y, xa = lops.lora_matmul_fwd(x, w, a, bb, sc)
        want_y, want_xa = lops.ref.lora_matmul_fwd(x, w, a, bb, sc)
        what = f"M={m} K={kd} N={n} r={r}"
        worst("lora_matmul_fwd", [(y, want_y), (xa, want_xa)],
              f"lora fwd {what}")
        same_bits(torch, "lora_matmul_fwd", (y, xa),
                  lops.lora_matmul_fwd(x, w, a, bb, sc), what)
        grads = lops.lora_matmul_bwd(x, w, a, bb, sc, g, want_xa)
        worst("lora_matmul_bwd",
              zip(grads, lops.ref.lora_matmul_bwd(x, w, a, bb, sc, g,
                                                  want_xa)),
              f"lora bwd {what}")
        same_bits(torch, "lora_matmul_bwd", grads,
                  lops.lora_matmul_bwd(x, w, a, bb, sc, g, want_xa), what)
    # autograd through common.lora_dense (W frozen) vs plain autograd
    ins = [t.clone().requires_grad_(True) for t in (x, a, bb, sc)]
    yk = common.lora_dense(ins[0], w, None,
                           {"A": ins[1], "B": ins[2], "scale": ins[3]})
    got = torch.autograd.grad(yk, ins, g)
    xf, af, bf = (t.float() for t in ins[:3])
    yp = (xf @ w.float() + ins[3] * (xf @ af) @ bf).to(dt)
    want = torch.autograd.grad(yp, ins, g)
    worst("lora_matmul_bwd", zip(got, want), "lora autograd")

    # int8 quantizers: bit for bit, ties and an all-zero channel included
    for shape in ((3, 2, 70, 40), (5, 4, 64, 768)):
        x = rand(*shape, dtype=dt)
        x[..., 5] = 0.0
        x[0, 0, 0, 7], x[0, 0, 1, 7] = 127.0, 0.5
        x3 = x.reshape(shape[0], -1, shape[-1])
        q8, scale = sops.int8_quantize_smashed(x)
        want_q, want_scale = sops.ref.quantize(x3)
        deq = sops.int8_dequantize_smashed(q8, scale, dt)
        rt = sops.int8_roundtrip_smashed(x)
        pairs = {"int8_quantize_smashed": [(q8.reshape(x3.shape), want_q),
                                           (scale, want_scale)],
                 "int8_dequantize_smashed": [(deq.reshape(x3.shape),
                                              sops.ref.dequantize(
                                                  want_q, want_scale, dt))],
                 "int8_roundtrip_smashed": [(rt.reshape(x3.shape),
                                             sops.ref.roundtrip(x3))]}
        # the straight-through backward: the same round trip on the
        # cotangent
        xg = x.clone().requires_grad_(True)
        g = rand(*shape, dtype=dt)
        (ste,) = torch.autograd.grad(
            smashed.make_compressor("int8").apply(xg), xg, g)
        pairs["int8_roundtrip_smashed"].append(
            (ste.reshape(x3.shape), sops.ref.roundtrip(
                g.reshape(x3.shape))))
        for kname, kpairs in pairs.items():
            for got, want in kpairs:
                if not torch.equal(got, want):
                    raise RuntimeError(f"{kname} {shape} ({dname}) is not "
                                       f"bit-equal to its plain version")
            errs[kname] = max(errs[kname], 0.0)


def time_training_kernels(torch, F, rand, errs):
    """Phase 3 for the training slice's kernels, at the shapes the
    training path gives them (fp32): each timed call's result is first
    held against its plain version on the same inputs (at TOL["float32"];
    the int8 kernels bit for bit), and errs[kernel] takes the larger
    error."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels import _build
    from repro_torch.kernels.lora_matmul import ops as lops
    from repro_torch.kernels.smashed_quant import ops as sops

    at_path = {}

    def check(kname, pairs, what, scaled=False):
        e = max(max_err(torch, g, w, "float32", f"{what} {i}", scaled=scaled)
                for i, (g, w) in enumerate(pairs))
        at_path[kname] = max(at_path.get(kname, 0.0), e)

    def same(kname, pairs, what):
        for g, w in pairs:
            if not torch.equal(g, w):
                raise RuntimeError(f"{kname} at {what} is not bit-equal to "
                                   f"its plain version")
        at_path[kname] = 0.0

    rows = {}
    # flash forward and backward: 12 each per train step at B*H = 5
    # clients x 4 x 12 heads
    b, s, h, hd = 20, 512, 12, 64
    q, k, v, do = (rand(b, s, h, hd) for _ in range(4))
    out, lse = fops.flash_attention_fwd(q, k, v)
    check("flash_attention_fwd",
          zip((out, lse), fops.ref.attention_fwd(q, k, v)),
          f"flash fwd B={b} S={s} H={h}")
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    pairs = b * h * s * (s + 1) // 2
    with torch.no_grad():
        rows["flash_attention_fwd (gpt2 train)"] = dict(
            ms=cuda_ms(torch, lambda: fops.flash_attention_fwd(q, k, v),
                       iters=20),
            plain_ms=cuda_ms(torch, lambda: fops.ref.attention_fwd(q, k, v),
                             iters=10),
            library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), iters=20),
            **work(4 * (4 * b * s * h * hd + b * h * s), 4 * hd * pairs,
                   products=True),
            shape=f"B={b} S={s} H={h} hd={hd} causal fp32 (B*H={b * h}, "
                  f"the gpt2 train and eval steps)")
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    do_t = do.transpose(1, 2).contiguous()
    check("flash_attention_bwd",
          zip(fops.flash_attention_bwd(q, k, v, out, lse, do),
              fops.ref.attention_bwd(q, k, v, out, lse, do)),
          f"flash bwd B={b} S={s} H={h}")
    rows["flash_attention_bwd"] = dict(
        ms=cuda_ms(torch, lambda: fops.flash_attention_bwd(q, k, v, out, lse,
                                                           do), iters=20),
        plain_ms=cuda_ms(torch, lambda: fops.ref.attention_bwd(
            q, k, v, out, lse, do), iters=10),
        library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            o_lib, (qt, kt, vt), do_t, retain_graph=True), iters=20),
        # read q, k, v, out, do, lse; write dq, dk, dv.  Per visible pair:
        # s, dp, dq, dk, dv, 2 hd FLOPs each
        **work(4 * (8 * b * s * h * hd + b * h * s), 10 * hd * pairs,
               products=True),
        shape=f"B={b} S={s} H={h} hd={hd} causal fp32 (B*H={b * h}); "
              f"library = SDPA backward through autograd")
    # fused LoRA: 48 per eval step over every token of the 5 clients
    m, kd, r = 10240, 768, 16
    x, g = rand(m, kd), rand(m, kd)
    w = rand(kd, kd, scale=kd ** -0.5)
    a, bb = rand(kd, r, scale=r ** -0.5), rand(r, kd, scale=0.02)
    sc = torch.tensor(2.0, device=x.device)
    y, xa = lops.lora_matmul_fwd(x, w, a, bb, sc)
    check("lora_matmul_fwd", zip((y, xa), lops.ref.lora_matmul_fwd(
        x, w, a, bb, sc)), f"lora fwd M={m}")
    # the gradients reduce over M rows: the tolerance scales with them,
    # as in phase 2
    check("lora_matmul_bwd",
          zip(lops.lora_matmul_bwd(x, w, a, bb, sc, g, xa),
              lops.ref.lora_matmul_bwd(x, w, a, bb, sc, g, xa)),
          f"lora bwd M={m}", scaled=True)
    mat = 2 * m * kd * kd
    low = 2 * m * kd * r
    rows["lora_matmul_fwd"] = dict(
        ms=cuda_ms(torch, lambda: lops.lora_matmul_fwd(x, w, a, bb, sc)),
        plain_ms=cuda_ms(torch, lambda: lops.ref.lora_matmul_fwd(
            x, w, a, bb, sc)),
        library_ms=None,
        composition="x@W + s*(x@A)@B (three cuBLAS GEMMs)",
        composition_ms=cuda_ms(torch, lambda: x @ w + sc * ((x @ a) @ bb)),
        passes=pass_ms(torch, lambda: lops.lora_matmul_fwd(x, w, a, bb, sc),
                       LORA_PASSES),
        tile=_build.library().lora_fused_tile(m, kd),
        **work(4 * (2 * m * kd + kd * kd + 2 * kd * r + m * r + 1),
               mat + 2 * low, products=True),
        shape=f"M={m} K=N={kd} r={r} fp32")

    def composition_bwd():
        gb = g @ bb.T
        return (g @ w.T + sc * (gb @ a.T), sc * (x.T @ gb), sc * (xa.T @ g),
                (xa * gb).sum())

    # the backward: 3 kernels of its own (gb thin pass, dx GEMM, dA/dB
    # pass) and the wrapper's 2 torch ops for dscale = sum(xa * gb)
    bwd_passes = pass_ms(torch, lambda: lops.lora_matmul_bwd(
        x, w, a, bb, sc, g, xa), LORA_BWD_PASSES, launches=True)
    check_kernels_per_call(bwd_passes, 3, 5, "fused LoRA backward")
    rows["lora_matmul_bwd"] = dict(
        ms=cuda_ms(torch, lambda: lops.lora_matmul_bwd(x, w, a, bb, sc, g,
                                                       xa)),
        plain_ms=cuda_ms(torch, lambda: lops.ref.lora_matmul_bwd(
            x, w, a, bb, sc, g, xa)),
        library_ms=None,
        composition="g@W^T + s*(g@B^T)@A^T, s*x^T@gb, s*xa^T@g (cuBLAS)",
        composition_ms=cuda_ms(torch, composition_bwd),
        passes=bwd_passes,
        # the dA/dB pass alone: read x, g, gb, xa; write dA, dB
        pass_bound=("lora_dab_kernel", bound(
            4 * (2 * m * kd + 2 * m * r + 2 * kd * r), 2 * low,
            "float32", products=True)),
        # read x, W, A, B, g, xa; write dx, dA, dB
        **work(4 * (3 * m * kd + kd * kd + 4 * kd * r + m * r + 2),
               mat + 4 * low + 2 * m * r, products=True),
        shape=f"M={m} K=N={kd} r={r} fp32, dA/dB in "
              f"{_build.library().lora_fused_dab_ctas(m, kd, kd)} CTAs")
    # smashed int8: 2 per distinct cut layer per train step, 5 messages
    gq, mq, dq = 5, 2048, 768
    xs = rand(gq, 4, 512, dq)
    q8, scale = sops.int8_quantize_smashed(xs)
    x3 = xs.reshape(gq, mq, dq)
    want_q, want_scale = sops.ref.quantize(x3)
    same("int8_quantize_smashed",
         [(q8.reshape(x3.shape), want_q), (scale, want_scale)],
         f"G={gq} M={mq}")
    same("int8_dequantize_smashed",
         [(sops.int8_dequantize_smashed(q8, scale).reshape(x3.shape),
           sops.ref.dequantize(want_q, want_scale))], f"G={gq} M={mq}")
    same("int8_roundtrip_smashed",
         [(sops.int8_roundtrip_smashed(xs).reshape(x3.shape),
           sops.ref.roundtrip(x3))], f"G={gq} M={mq}")
    elems = gq * mq * dq
    # one kernel per call, and no other
    int8_passes = {}
    for kname, fn, kern in (
            ("int8_roundtrip_smashed",
             lambda: sops.int8_roundtrip_smashed(xs), "smashed_quant_kernel"),
            ("int8_quantize_smashed",
             lambda: sops.int8_quantize_smashed(xs), "smashed_quant_kernel"),
            ("int8_dequantize_smashed",
             lambda: sops.int8_dequantize_smashed(q8, scale),
             "dequant_kernel")):
        int8_passes[kname] = pass_ms(torch, fn, (kern,), launches=True)
        check_kernels_per_call(int8_passes[kname], 1, 1, kname)
    rows["int8_roundtrip_smashed"] = dict(
        ms=cuda_ms(torch, lambda: sops.int8_roundtrip_smashed(xs)),
        plain_ms=cuda_ms(torch, lambda: sops.ref.roundtrip(
            xs.reshape(gq, mq, dq))),
        library_ms=None,
        passes=int8_passes["int8_roundtrip_smashed"],
        **work(4 * 2 * elems, 6 * elems),
        shape=f"G={gq} M={mq} d={dq} fp32, clusters of "
              f"{_build.library().smashed_quant_cluster()}, "
              f"{_build.library().smashed_quant_ctas(gq, dq)} CTAs")
    rows["int8_quantize_smashed"] = dict(
        ms=cuda_ms(torch, lambda: sops.int8_quantize_smashed(xs)),
        plain_ms=cuda_ms(torch, lambda: sops.ref.quantize(
            xs.reshape(gq, mq, dq))),
        library_ms=None,
        passes=int8_passes["int8_quantize_smashed"],
        **work(5 * elems + 4 * gq * dq, 5 * elems),
        shape=f"G={gq} M={mq} d={dq} fp32 -> int8")
    rows["int8_dequantize_smashed"] = dict(
        ms=cuda_ms(torch, lambda: sops.int8_dequantize_smashed(q8, scale)),
        plain_ms=cuda_ms(torch, lambda: sops.ref.dequantize(
            q8.reshape(gq, mq, dq), scale)),
        library_ms=None,
        passes=int8_passes["int8_dequantize_smashed"],
        **work(5 * elems + 4 * gq * dq, elems),
        shape=f"G={gq} M={mq} d={dq} int8 -> fp32, "
              f"{_build.library().smashed_dequant_ctas(gq, mq, dq)} CTAs")
    for kname, e in at_path.items():
        errs[kname] = max(errs[kname], e)
    log("phase 3: at the training path's shapes, max |kernel - plain| "
        + ", ".join(f"{k} {v:.3e}" for k, v in at_path.items())
        + f" (tol {TOL['float32']}; the int8 kernels bit for bit)")
    return rows


def ssd_inputs(torch, rand, b, s, h, p, g, n, dtype, dt_scale=1.0):
    """SSD inputs near mamba2's: x and B/C as silu'd conv outputs are
    O(1), dt = softplus(. + 0.5), A = -exp(.)."""
    x = rand(b, s, h, p, dtype=dtype)
    dt = (torch.nn.functional.softplus(rand(b, s, h) + 0.5)
          * dt_scale).contiguous()
    a = -torch.exp(rand(h, scale=0.5))
    bm = rand(b, s, g, n, dtype=dtype, scale=0.3)
    c = rand(b, s, g, n, dtype=dtype, scale=0.3)
    return x, dt, a, bm, c


def max_chunk_decay(torch, dt, a, chunk):
    """The largest total log-decay -sum(dt * A) over one chunk."""
    b, s, h = dt.shape
    steps = (dt * a).reshape(b, s // chunk, chunk, h)
    return float(-steps.sum(dim=2).min())


def check_mamba2_kernels(torch, rand, dname, dt, errs):
    """Phase 2 for the mamba2 path: the SSD kernel against ref.ssd_chunked
    on SSD_CASES, and the fused LoRA forward at the eval step's shapes:
    M = clients x M_BATCH x M_SEQ rows through mamba2's ssm_in (K 1536,
    N 6448, not a multiple of the kernel's 64-wide tile) and ssm_out
    (K 3072, N 1536).  The SSD output's rounding grows with the chunk's
    sums, so its absolute tolerance scales with max|y|."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.lora_matmul import ops as lops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models.ssm import in_proj_dim

    decays = []
    for b, s, h, p, g, n, chunk, dt_scale in SSD_CASES + SSD_EDGES:
        ins = ssd_inputs(torch, rand, b, s, h, p, g, n, dt, dt_scale)
        y = ssd_ops.ssd_scan(*ins, chunk=chunk)
        same_bits(torch, "ssd_scan", (y,),
                  (ssd_ops.ssd_scan(*ins, chunk=chunk),),
                  f"S={s} H={h} G={g} P={p} N={n} chunk={chunk}")
        if not torch.isfinite(y).all():
            raise RuntimeError(f"SSD kernel: non-finite output at S={s} "
                               f"chunk={chunk} ({dname})")
        e = max_err(torch, y, ssd_ops.ref.ssd_chunked(*ins, chunk=chunk),
                    dname, f"ssd S={s} H={h} G={g} chunk={chunk}",
                    scaled=True)
        errs["ssd_scan"] = max(errs["ssd_scan"], e)
        decays.append(max_chunk_decay(torch, ins[1], ins[2], chunk))
    log(f"phase 2 ({dname}): SSD cases' largest chunk decays "
        f"{[round(d, 1) for d in decays]} (past 88 the reference's "
        f"unmasked exp overflows)")
    arch = get_config("mamba2-780m")
    m, r = arch.data.num_clients * M_BATCH * M_SEQ, arch.lora.r_others
    d = arch.model.d_model
    for kd, n in ((d, in_proj_dim(arch.model)), (arch.model.d_inner, d)):
        x = rand(m, kd, dtype=dt)
        mask = (torch.arange(r, device=x.device) < r - 2).float()
        w = rand(kd, n, dtype=dt, scale=kd ** -0.5)
        a = (rand(kd, r, scale=r ** -0.5) * mask).to(dt)
        bb = (rand(r, n, scale=0.02) * mask[:, None]).to(dt)
        sc = torch.tensor(2.0, device=x.device)
        y, xa = lops.lora_matmul_fwd(x, w, a, bb, sc)
        want_y, want_xa = lops.ref.lora_matmul_fwd(x, w, a, bb, sc)
        e = max(max_err(torch, y, want_y, dname, f"lora fwd K={kd} N={n}"),
                max_err(torch, xa, want_xa, dname, f"lora xa K={kd} N={n}"))
        errs["lora_matmul_fwd"] = max(errs["lora_matmul_fwd"], e)
        log(f"phase 2 ({dname}): fused LoRA forward at mamba2's M={m} K={kd} "
            f"N={n} r={r}: max |kernel - plain| {e:.3e}")


def time_ssd_kernel(torch, rand, errs):
    """Phase 3 for the SSD kernel at the mamba2 training path's shape
    (fp32): the timed call's result held against its plain version on the
    same inputs, then kernel and plain times beside the bound, the device
    time of each of its four passes, and the FLOPs its MMAs execute beside
    the bound's.  No PyTorch call computes the SSD scan: the library
    column is null.

    Bound: read x, dt, A, B, C once and write y once; operations per
    (b, h, chunk) are the inter-chunk term C . s (2 Q N P), the state
    update (2 Q P N) and the causal half of M @ x (2 Q(Q+1)/2 P), and per
    (b, group, chunk) the causal half of C . B (2 Q(Q+1)/2 N)."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    b, s, h, p, g, n, q = SSD_PATH
    ins = ssd_inputs(torch, rand, b, s, h, p, g, n, torch.float32)
    e = max_err(torch, ssd_ops.ssd_scan(*ins, chunk=q),
                ssd_ops.ref.ssd_chunked(*ins, chunk=q), "float32",
                "ssd at the path's shape", scaled=True)
    errs["ssd_scan"] = max(errs["ssd_scan"], e)
    nc, pairs = s // q, q * (q + 1) // 2
    cb_flops = b * nc * g * 2 * pairs * n
    flops = b * nc * h * (4 * q * n * p + 2 * pairs * p) + cb_flops
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * g * n)
    executed = ssd_executed_flops(b, s, h, p, g, n, q)
    if executed["cb"] > 2 * cb_flops:
        raise RuntimeError(f"SSD C.B^T executes {executed['cb']} FLOPs, "
                           f"over 2x the per-group {cb_flops}")
    # the train step's use: the kernel forward, then the plain recompute
    # backward (the difference of the two times is the backward's)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    gy = rand(b, s, h, p)
    fwd_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        ssd_ops.ssd_scan(*leaves, chunk=q), leaves, gy), iters=5, warmup=2)
    with torch.no_grad():
        row = dict(
            ms=cuda_ms(torch, lambda: ssd_ops.ssd_scan(*ins, chunk=q)),
            plain_ms=cuda_ms(torch, lambda: ssd_ops.ref.ssd_chunked(
                *ins, chunk=q), iters=10),
            library_ms=None,
            passes=pass_ms(torch, lambda: ssd_ops.ssd_scan(*ins, chunk=q),
                           SSD_PASSES),
            **work(nbytes, flops, products=True),
            shape=f"B={b} S={s} H={h} P={p} G={g} N={n} chunk={q} fp32 "
                  f"({flops / 1e9:.2f} GFLOP in the bound, "
                  f"{sum(executed.values()) / 1e9:.2f} executed by the MMAs "
                  f"(chunk state {executed['chunk_state'] / 1e9:.2f}, "
                  f"C.B^T {executed['cb'] / 1e9:.3f} = "
                  f"{executed['cb'] / cb_flops:.2f}x the per-group causal "
                  f"{cb_flops / 1e9:.3f}, chunk scan "
                  f"{executed['chunk_scan'] / 1e9:.2f}); "
                  f"{nbytes / 1e6:.1f} MB; "
                  f"max |kernel - plain| {e:.3e}; kernel forward + plain "
                  f"recompute backward through autograd "
                  f"{fwd_bwd_ms:.4f} ms)")
    return {"ssd_scan": row}


def time_mamba2_lora(torch, rand, errs):
    """Phase 3 for the fused LoRA forward at the mamba2 eval step's shapes
    (fp32): M = clients x M_BATCH x M_SEQ rows through ssm_in (K 1536,
    N 6448) and ssm_out (K 3072, N 1536), 48 launches each per eval step,
    beside the cuBLAS composition, so that PERF.md can order it by
    launches x (time - bound)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.lora_matmul import ops as lops
    from repro_torch.models.ssm import in_proj_dim

    arch = get_config("mamba2-780m")
    m, r = arch.data.num_clients * M_BATCH * M_SEQ, arch.lora.r_others
    d = arch.model.d_model
    rows = {}
    for proj, kd, n in (("ssm_in", d, in_proj_dim(arch.model)),
                        ("ssm_out", arch.model.d_inner, d)):
        x = rand(m, kd)
        w = rand(kd, n, scale=kd ** -0.5)
        a, bb = rand(kd, r, scale=r ** -0.5), rand(r, n, scale=0.02)
        sc = torch.tensor(2.0, device=x.device)
        y, xa = lops.lora_matmul_fwd(x, w, a, bb, sc)
        want_y, want_xa = lops.ref.lora_matmul_fwd(x, w, a, bb, sc)
        e = max(max_err(torch, y, want_y, "float32", f"lora fwd {proj}"),
                max_err(torch, xa, want_xa, "float32", f"lora xa {proj}"))
        errs["lora_matmul_fwd"] = max(errs["lora_matmul_fwd"], e)
        rows[f"lora_matmul_fwd (mamba2 {proj})"] = dict(
            ms=cuda_ms(torch, lambda: lops.lora_matmul_fwd(x, w, a, bb, sc),
                       iters=20),
            plain_ms=cuda_ms(torch, lambda: lops.ref.lora_matmul_fwd(
                x, w, a, bb, sc), iters=20),
            library_ms=None,
            composition="x@W + s*(x@A)@B (three cuBLAS GEMMs)",
            composition_ms=cuda_ms(torch, lambda: x @ w + sc * ((x @ a) @ bb),
                                   iters=20),
            passes=pass_ms(torch, lambda: lops.lora_matmul_fwd(
                x, w, a, bb, sc), LORA_PASSES),
            tile=_build.library().lora_fused_tile(m, n),
            **work(4 * (m * kd + kd * n + kd * r + r * n + 1 + m * n + m * r),
                   2 * m * kd * n + 2 * m * kd * r + 2 * m * r * n,
                   products=True),
            shape=f"M={m} K={kd} N={n} r={r} fp32 (max |kernel - plain| "
                  f"{e:.3e})")
    return rows


class TimedStep:
    """Stands in for a system's train_step or eval_step: calls the
    engine's step between two synchronizes, and keeps per call the cuts
    it ran with, the kernel launches it made and its wall seconds, and
    the last arguments (for the profiles).  The system calls whatever is
    bound to those attributes."""

    def __init__(self, torch, fn, wrappers):
        self.torch, self.fn, self.wrappers = torch, fn, wrappers
        self.calls, self.last = [], None

    def __call__(self, *args):
        sync = self.torch.cuda.synchronize
        sync()
        before = {k: w.launches for k, w in self.wrappers.items()}
        t0 = time.perf_counter()
        out = self.fn(*args)
        sync()
        self.calls.append((args[1]["cuts"].tolist(),
                           {k: w.launches - before[k]
                            for k, w in self.wrappers.items()},
                           time.perf_counter() - t0))
        self.last = args
        return out


def timed_system(torch, arch, dev, wrappers, sys_kw=None):
    """SplitFTSystem on `arch` at full width on the card, random weights
    from SEED, the quickstart's data sizes, with TimedStep in place of its
    train and eval steps."""
    from repro_torch.core.system import SplitFTSystem, SystemConfig

    system = SplitFTSystem(arch, SystemConfig(
        num_samples=NUM_SAMPLES, eval_samples=EVAL_SAMPLES,
        **(sys_kw or {})), seed=SEED, device=dev)
    system.train_step = TimedStep(torch, system.train_step, wrappers)
    system.eval_step = TimedStep(torch, system.eval_step, wrappers)
    return system


def run_rounds(torch, arch, dev, wrappers, tag, name, card,
               host_profile=False):
    """ROUNDS SplitFT rounds through SplitFTSystem.run on `arch` at full
    width (sync scheduler, the accuracy controller): each round a train
    step, an eval step and the C3 epilogue.  The launch counters are set
    to 0 before the rounds; each round prints its wall time, the train-
    and eval-step times and the host share (round wall - train - eval:
    planning, comm bytes, C3, records).  Then one more train + eval step
    of the system's engine runs under the profiler on its last inputs,
    and with host_profile one more train step under the host profiler.
    Returns (system, the launches over the rounds, [(cuts, train-step
    launches, eval-step launches)] per round)."""
    t = arch.train
    t0 = time.perf_counter()
    system = timed_system(torch, arch, dev, wrappers)
    train, ev = system.train_step, system.eval_step
    n = arch.data.num_clients
    log(f"{tag}: {arch.name} {system.model.num_flat_layers} layers, {n} "
        f"clients (samples {system.sample_counts.astype(int).tolist()}, "
        f"length-Dirichlet alpha {arch.data.alpha}), batch {t.batch_size} "
        f"x seq {t.seq_len}, r_cut {arch.lora.r_cut} r_others "
        f"{arch.lora.r_others}, smashed {system.smashed_compress}, "
        f"{t.optimizer} lr {t.lr_client}, scheduler "
        f"{system.scheduler.name}; SplitFTSystem built in "
        f"{time.perf_counter() - t0:.1f} s")

    tokens_per_step = n * t.batch_size * t.seq_len
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for r in range(ROUNDS):
        t0 = time.perf_counter()
        system.run(1, log_every=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = system.history[-1]
        (cuts, _, t_train), (_, _, t_eval) = train.calls[-1], ev.calls[-1]
        vals = [rec[k] for k in ("ce", "accuracy", "eval_ce",
                                 "eval_accuracy")]
        if not all(np.isfinite(v).all() for v in vals) or \
                not np.isfinite(rec["loss"]):
            raise RuntimeError(f"{tag} round {r}: non-finite loss")
        host = wall - t_train - t_eval
        log(f"{tag} round {r} [{name}, {card}]: cuts {cuts} -> "
            f"{system.state['cuts'].tolist()}; train ce {fmt(vals[0])} acc "
            f"{fmt(vals[1])}; eval ce {fmt(vals[2])} acc {fmt(vals[3])}; "
            f"comm per client "
            f"{(rec['comm'] / 1e6).round(3).tolist()} MB; round wall "
            f"{wall * 1e3:.1f} ms = train step {t_train * 1e3:.1f} ms "
            f"({tokens_per_step / t_train:.0f} tokens/s) + eval step "
            f"{t_eval * 1e3:.1f} ms + host {host * 1e3:.1f} ms (host share "
            f"{host / wall:.4f}); "
            f"max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    got = {k: w.launches for k, w in wrappers.items()}
    log(f"{tag} launches over {ROUNDS} rounds: "
        f"{ {k: c for k, c in got.items() if c} }")
    if len(train.calls) != ROUNDS or len(ev.calls) != ROUNDS:
        raise RuntimeError(f"{tag}: {len(train.calls)} train and "
                           f"{len(ev.calls)} eval steps in {ROUNDS} rounds")
    per_round = [(c, tl, el) for (c, tl, _), (_, el, _) in
                 zip(train.calls, ev.calls)]

    wall, busy, by_name, _ = device_busy(
        torch, lambda: (train.fn(*train.last), ev.fn(*ev.last)))
    if busy is None:
        log(f"{tag} profile [{name}, {card}]: device busy share not "
            f"measured (the profiler recorded no device activity); wall "
            f"{wall:.3f} s")
    else:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log(f"{tag} profile [{name}, {card}]: one train + one eval step "
            f"under torch.profiler: wall {wall:.3f} s, device busy "
            f"{busy:.3f} s (idle share {1 - busy / wall:.3f}); top device "
            f"time: " + "; ".join(f"{k[:60]} {v * 1e3:.1f} ms"
                                  for k, v in top))
    if host_profile:
        wall, top = host_top(torch, lambda: train.fn(*train.last))
        log(f"{tag} host profile [{name}, {card}]: one train step under "
            f"torch.profiler (CPU and CUDA): wall {wall:.3f} s; top host ops "
            f"by self CPU time: " + "; ".join(
                f"{k[:40]} {ms:.1f} ms x{calls}" for k, ms, calls in top))
    return system, got, per_round


def check_launches(per_round, want_train, want_eval, what):
    """Each round's train-step and eval-step launches against the counts
    the code gives; want_train maps the round's cuts to its counts.
    Kernels left out must not launch."""
    for r, (cuts, train, ev) in enumerate(per_round):
        for step, got, want in (("train", train, want_train(cuts)),
                                ("eval", ev, want_eval)):
            bad = {k: (c, want.get(k, 0)) for k, c in got.items()
                   if c != want.get(k, 0)}
            if bad:
                raise RuntimeError(f"{what} round {r} {step} step launches "
                                   f"(got, want): {bad}")


def gpt2_int8():
    """gpt2-small at the paper setting with int8 smashed activations."""
    import dataclasses

    from repro_torch.configs import get_config

    arch = get_config("gpt2-small")
    return arch.replace(split=dataclasses.replace(arch.split,
                                                  smashed_compress="int8"))


def train_phase(torch, dev, wrappers, name, card):
    """Phase 5: ROUNDS SplitFT rounds on full-width gpt2-small with int8
    smashed activations through SplitFTSystem; then the fused LoRA
    backward through autograd at the eval shape, on the system's served
    adapters.  Returns the launches of both."""
    from repro_torch.tree import tree_leaves, tree_map

    system, got, per_round = run_rounds(torch, gpt2_int8(), dev, wrappers,
                                        "phase 5", name, card)
    check_launches(per_round, lambda cuts: {
        "flash_attention_fwd": 12, "flash_attention_bwd": 12,
        "int8_roundtrip_smashed": 2 * len(set(cuts))},
        {"flash_attention_fwd": 12, "lora_matmul_fwd": 48},
        "gpt2-small training")

    # the fused LoRA backward at the eval shape: the gradient of the
    # global model's eval loss w.r.t. its served (rank-2) adapters,
    # through autograd on lora_dense (the round itself has no rank-2
    # backward)
    for w in wrappers.values():
        w.launches = 0
    params, eff = system.serve_model()
    eff = tree_map(lambda x: x.detach().requires_grad_(True), eff)
    ebatch = system.eval_step.last[2]
    t0 = time.perf_counter()
    with torch.enable_grad():
        per, _ = system.model.loss(
            params, eff, {k: torch.as_tensor(v, device=dev)
                          for k, v in ebatch.items()}, per_client=True)
        grads = torch.autograd.grad(per.sum(), tree_leaves(eff))
    torch.cuda.synchronize()
    if not all(torch.isfinite(g).all() for g in grads):
        raise RuntimeError("non-finite global-adapter gradient")
    bwd = {k: w.launches for k, w in wrappers.items()}
    if bwd["lora_matmul_bwd"] != 48:
        raise RuntimeError(f"global-adapter gradient launched the fused "
                           f"LoRA backward {bwd['lora_matmul_bwd']} times, "
                           f"want 48")
    log(f"phase 5 global-adapter gradient [{name}, {card}]: eval loss "
        f"and its gradient w.r.t. the 48 served adapters in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms; launches "
        f"{ {k: c for k, c in bwd.items() if c} }")
    # the round's launches, and the fused LoRA backward from the gradient
    # run (its forward launches are not the round's)
    return {**got, "lora_matmul_bwd": bwd["lora_matmul_bwd"]}


def resume_phase(torch, dev, wrappers, name, card):
    """Phase 5b: checkpoint and resume on full-width gpt2-small (int8
    smashed) under the deadline scheduler (straggler_sim: a simulated
    clock drops slow clients).  A run of 3 rounds checkpoints after round
    2 (checkpoint_every 2); a fresh system restores that checkpoint; the
    straight run takes round 3 and the resumed one rounds 2 and 3, whose
    per-client losses must equal the straight run's within RESUME_RTOL,
    with the same cuts, survivor masks and simulated clock."""
    import tempfile

    arch = gpt2_int8()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as d:
        kw = dict(straggler_sim=True, checkpoint_dir=d, checkpoint_every=2)
        straight = timed_system(torch, arch, dev, wrappers, kw)
        straight.run(3, log_every=0)
        resumed = timed_system(torch, arch, dev, wrappers, kw)
        if not resumed.restore() or int(resumed.state["round"]) != 2:
            raise RuntimeError(f"phase 5b: no checkpoint of round 2 in "
                               f"{straight.ckpt.steps()}")
        straight.run(1, log_every=0)
        resumed.run(2, log_every=0)
    bitwise = True
    for a, b in zip(straight.history[2:], resumed.history):
        for k in ("cuts", "active", "sim_clock", "sim_time"):
            if not np.array_equal(a[k], b[k]):
                raise RuntimeError(f"phase 5b round {a['round']}: {k} "
                                   f"{a[k]} straight, {b[k]} resumed")
        torch.testing.assert_close(
            torch.as_tensor(b["ce"]), torch.as_tensor(a["ce"]),
            rtol=RESUME_RTOL, atol=0,
            msg=lambda m: f"phase 5b round {a['round']} losses: {m}")
        bitwise &= np.array_equal(a["ce"], b["ce"])
    log(f"phase 5b [{name}, {card}]: gpt2-small, scheduler "
        f"{straight.scheduler.name}, checkpoint after round 2 restored; "
        f"per round (straight): " + "; ".join(
            f"round {h['round']} active {h['active'].astype(int).tolist()} "
            f"sim_clock {h['sim_clock']!r} s ce {fmt(h['ce'])}"
            for h in straight.history)
        + f"; resumed rounds 2-3 ce equal the straight run's within rtol "
        f"{RESUME_RTOL} (bitwise: {bitwise}); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def cli_phase(torch, wrappers, name, card):
    """Phase 5c: the train CLI (repro_torch.launch.train) on the card by
    default, 2 rounds of reduced gpt2-small into a temporary directory;
    its history.jsonl must hold 2 rows of finite losses, and the run must
    have launched the flash kernels (it ran on the card)."""
    import tempfile

    from repro_torch.launch import train as train_cli

    for w in wrappers.values():
        w.launches = 0
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        if train_cli.main(["--reduced", "--rounds", "2", "--samples", "64",
                           "--out", d]) != 0:
            raise RuntimeError("phase 5c: the train CLI failed")
        wall = time.perf_counter() - t0
        with open(Path(d) / "history.jsonl") as f:
            rows = [json.loads(line) for line in f]
    if len(rows) != 2 or not all(
            np.isfinite(r["loss"]) and np.isfinite(r["ce"]).all()
            for r in rows):
        raise RuntimeError(f"phase 5c: history.jsonl rows {rows}")
    got = {k: w.launches for k, w in wrappers.items() if w.launches}
    if not got.get("flash_attention_fwd"):
        raise RuntimeError(f"phase 5c: the CLI launched no flash kernel "
                           f"({got}): it did not run on the card")
    log(f"phase 5c [{name}, {card}]: python -m repro_torch.launch.train "
        f"--reduced --rounds 2 --samples 64 in {wall:.1f} s: losses "
        f"{[r['loss'] for r in rows]}; launches {got}")


def mamba2_phase(torch, dev, wrappers, name, card):
    """Phase 7: ROUNDS SplitFT rounds on full-width, full-depth
    mamba2-780m (48 SSD layers, the config's own smashed compressor
    "none"), 5 clients at batch M_BATCH x seq M_SEQ (2 chunks of 256).
    Every SSD scan of a train or eval step is a kernel launch; the eval
    step's global adapters run the fused LoRA forward on ssm_in and
    ssm_out.  Returns the launches."""
    import dataclasses

    from repro_torch.configs import get_config

    arch = get_config("mamba2-780m")
    arch = arch.replace(train=dataclasses.replace(
        arch.train, batch_size=M_BATCH, seq_len=M_SEQ))
    layers = arch.model.num_layers
    _, got, per_round = run_rounds(torch, arch, dev, wrappers, "phase 7",
                                   name, card, host_profile=True)
    check_launches(per_round, lambda cuts: {"ssd_scan": layers},
                   {"ssd_scan": layers, "lora_matmul_fwd": 2 * layers},
                   "mamba2-780m training")
    return got


def small_step_check(torch, dev, arch_name, seq, comps, tag):
    """Phases 6 and 8: one round's losses and adapter gradients at full
    width and reduced depth (2 layers, 2 clients with cuts [1, 2], batch 1,
    seq `seq`), on the card and on the CPU plain path from one state, for
    each smashed compressor in `comps`; every gradient must be finite.
    For mamba2 at seq 512 the SSD chunk is 256 and a chunk's decay passes
    exp(88), where the reference's chunked backward is not finite.
    Tolerances: STEP_TOL on the losses; for the
    gradients GRAD_TOL[compressor] (relative, share of max|g|): fp32 sums
    in another order without compression, and with int8 one quantum more,
    because a cotangent element within fp32 noise of an int8 rounding
    boundary takes the neighbouring code on one side.  The int8 tolerance
    must stay below the CPU's own int8-vs-none gap, so that a card step
    that skipped the compression would fail it."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import rounds, smashed
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves

    arch = get_config(arch_name)
    arch = arch.replace(
        model=dataclasses.replace(arch.model, num_layers=SMALL_LAYERS),
        split=dataclasses.replace(arch.split, cut_layer=1, cut_buckets=(1,)))
    rng = np.random.default_rng(SEED + 5)
    toks = rng.integers(3, arch.model.vocab_size,
                        size=(SMALL_CLIENTS, SMALL_BATCH, seq + 1))
    batch = {"tokens": toks[..., :-1].astype(np.int32),
             "labels": toks[..., 1:].astype(np.int32)}
    weights = np.array([0.25, 0.75], np.float32)
    out = {}
    for role, dv in (("card", dev), ("cpu", torch.device("cpu"))):
        model = build_model(arch, device=dv)
        params = model.init_params(torch.Generator().manual_seed(SEED))
        state = rounds.init_state(model,
                                  torch.Generator().manual_seed(SEED + 3),
                                  num_clients=SMALL_CLIENTS)
        gen = torch.Generator().manual_seed(SEED + 4)
        for side in ("client_adapters", "server_adapters"):
            for targets in state[side].values():
                for leaf in targets.values():   # non-zero B: every adapter
                    leaf["B"] = (torch.randn(leaf["B"].shape, generator=gen)
                                 * 0.02).to(dv)
        state["cuts"] = torch.tensor([1, 2], dtype=torch.int32)
        for comp in comps:
            _, met, gc, gs = rounds.round_grads(
                model, params, state, batch, weights,
                boundary=smashed.make_boundary(
                    smashed.make_compressor(comp), state["cuts"]))
            out[role, comp] = (met["ce"].cpu(), [
                g.cpu() for g in tree_leaves(gc) + tree_leaves(gs)])
    for comp in comps:
        rtol, share = GRAD_TOL[comp]
        (ce_k, g_k), (ce_c, g_c) = out["card", comp], out["cpu", comp]
        if not all(torch.isfinite(g).all() for g in g_k + g_c):
            raise RuntimeError(f"{tag} ({comp}): non-finite adapter "
                               f"gradient")
        torch.testing.assert_close(
            ce_k, ce_c, rtol=STEP_TOL, atol=0,
            msg=lambda m: f"card vs CPU losses ({comp}): {m}")
        scale = max(float(g.abs().max()) for g in g_c)
        worst = 0.0
        for gk, gc_ in zip(g_k, g_c):
            torch.testing.assert_close(
                gk, gc_, rtol=rtol, atol=share * scale,
                msg=lambda m: f"card vs CPU adapter gradient ({comp}): {m}")
            worst = max(worst, float((gk - gc_).abs().max()))
        if comp != "none":
            gap = max(float((a - b).abs().max())
                      for a, b in zip(g_c, out["cpu", "none"][1])) / scale
            if gap <= share:
                raise RuntimeError(
                    f"{comp} moves the CPU's adapter gradients by only "
                    f"{gap:.2e} of max|g|, within the card-vs-CPU tolerance "
                    f"{share}: the check cannot see the compression")
            log(f"{tag} ({comp}): the CPU's {comp}-vs-none gradient gap is "
                f"{gap:.2e} of max|g|, above the tolerance {share}")
        log(f"{tag} ({comp}): {arch_name} full-width {SMALL_LAYERS}-layer "
            f"step, {SMALL_CLIENTS} clients (cuts [1, 2]), batch "
            f"{SMALL_BATCH} x seq {seq}: card vs CPU losses {fmt(ce_k)} vs "
            f"{fmt(ce_c)} (rtol {STEP_TOL}); {len(g_k)} adapter gradients, "
            f"max |diff| {worst:.3e} = {worst / scale:.2e} of max|g| (tol "
            f"{rtol} relative + {share} of max|g|)")


def lora_args(torch, rand, m, dt, gen):
    """Indexed-LoRA inputs at gpt2-small's q/k/v/o width: a pool of 4
    adapters at r = 16 with effective ranks 16, 8, 16, 4 (masked slots)."""
    kd, r, p = 768, 16, 4
    mask = (torch.arange(r)[None, :] < torch.tensor(RANKS)[:, None]).float()
    x = rand(m, kd, dtype=dt)
    w = rand(kd, kd, dtype=dt, scale=kd ** -0.5)
    a = (rand(p, kd, r, scale=r ** -0.5) * mask.to(x.device)[:, None, :]
         ).to(dt)
    b = (rand(p, r, kd, scale=0.02) * mask.to(x.device)[:, :, None]).to(dt)
    scale = (16.0 / torch.tensor(RANKS, dtype=torch.float32)).to(x.device)
    ids = torch.randint(0, p, (m,), generator=gen, dtype=torch.int32
                        ).to(x.device)
    return x, w, a, b, scale, ids


def decode_args(torch, rand, dt, dev, *, s, lens):
    b = len(lens)
    q = rand(b, 12, 64, dtype=dt)
    k = rand(b, s, 12, 64, dtype=dt)
    v = rand(b, s, 12, 64, dtype=dt)
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)


def paged_args(torch, k, v, gen, dev, *, ps):
    """The contiguous cache scattered into page pools through a shuffled
    page table (page 0 is the trash page, never allocated)."""
    b, s = k.shape[:2]
    p_max = s // ps
    n_pages = 1 + b * p_max
    pt = (torch.randperm(n_pages - 1, generator=gen) + 1).reshape(b, p_max)
    kp = torch.zeros((n_pages, ps) + k.shape[2:], dtype=k.dtype, device=dev)
    vp = torch.zeros_like(kp)
    idx = pt.to(dev).long()
    kp[idx] = k.reshape(b, p_max, ps, *k.shape[2:])
    vp[idx] = v.reshape(b, p_max, ps, *v.shape[2:])
    return kp, vp, pt.to(torch.int32).to(dev)


if __name__ == "__main__":
    sys.exit(main())
