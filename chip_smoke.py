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
    equal the straight run's; the train CLI on the card; 4 rounds under
    the phase-time co-controller (per-client cut, rank at the cut,
    compressor and topk keep fraction, with its predictions held to the
    simulated clock); 4 rounds under the local-steps scheduler (unequal
    budgets, FedAvg every 2nd round, adapter top-k and smashed top-k,
    both with error feedback), 3 rounds of two-tier FedAvg with int8
    adapter deltas, 3 aggregations under the async scheduler (FedBuff
    buffer, overlapped pipeline) and a mid-buffer checkpoint resumed bit
    for bit, and requests served from the local-steps run's trained
    adapters; then steps at full width and reduced depth on the card and
    on the CPU plain path from one state, with and without the memory
    knobs (remat, chunked cross entropy, microbatches), under a
    per-client policy, and one step each of the local-steps, async and
    two-tier engines, whose losses, adapter gradients and deltas must
    agree;
  * training mamba2-780m: the same 3 rounds through SplitFTSystem at full
    depth (48 SSD layers, every SSD scan through the chunked-scan kernel)
    at batch 1 per client, then 3 at the paper's batch 4 under remat
    "full" (and one step under "dots"), each peak of device memory under
    90% of the card; then the card-vs-CPU step at 2 layers and seq 512
    (SSD chunk 256), with and without remat;
  * the dense family at head dim 128: llama3-8b at full width (8 of its
    32 layers, RoPE, 32 heads over 8 kv heads, the 128256-wide untied
    head under the chunked cross entropy), 3 rounds through
    SplitFTSystem.run at the paper setting with int8 smashed activations,
    then serving 4 adapters contiguous and paged, tokens checked against
    the one-request reference, and the card-vs-CPU step at 2 layers;
    opt-125m and gpt-neo-125m (the paper's generalizability models, gpt-
    neo's 256-wide window on its odd layers) at full size, 3 rounds and 4
    requests each, the prompts running past the window; and one
    card-vs-CPU step each of phi4-mini (fp8 smashed, tied 200064-wide
    head), qwen1.5-32b (QKV bias, 40 heads) and mistral-large (96 heads
    over 8 at d_model 12288) at full width and 2 layers.  The flash
    kernels are held against their plain versions at head dim 128 too,
    at the tile edges and at llama3-8b's train, prefill and decode shapes;
  * serving SSM models through the recurrent cache: full-width,
    full-depth mamba2-780m, 4 requests (prompts of 300, 256, 37 and 2
    tokens, 32 new each) from 2 adapters one at a time through
    serial_reference (the SSD kernel with its final state in every
    prefill, the conv window and the one-token recurrence in every
    decode step), logits held against the card's own full forward, and
    a 2-layer copy against the CPU;
  * the hybrid family: full-width, full-depth zamba2-1.2b (32 SSD layers,
    6 attention layers), 3 rounds through SplitFTSystem.run with fp8
    smashed activations at cut 4, then the same requests served from the
    trained adapters, a 2-layer card-vs-CPU round step and served logits.
    The SSD kernel's final state is held against its plain version at
    the prefill's chunk edges;
  * the MoE family and the vlm frontend prefix: kimi-k2 at full width
    (d_model 7168, 64 heads over 8 of 112, top-8 over 48 of its 384
    experts, a shared expert, the 163840-wide untied head; 4 of its 61
    layers), 3 rounds through SplitFTSystem.run with int8 smashed
    activations at capacity factor 1.25 (the share of (token, choice)
    pairs dropped per layer printed and required above 0), then phase
    4's workload served from the trained adapters, contiguous and paged,
    tokens checked against the one-request reference; one card-vs-CPU
    step each of kimi-k2 and llama4-maverick (16 experts) with
    prefill-then-decode logits and tokens, and of internvl2-76b over a
    batch with its 256-position prefix, at full width and 2 layers, the
    top-k choices compared first.  The flash kernels are held against
    their plain versions at head dim 112 too (tile edges, kimi-k2's
    train, prefill and decode shapes), and the LoRA and int8 kernels at
    its widths (K = 7168; N = 7168 and 896).

The launch counters are read around each path.  Every phase that fails
raises, so the exit code is non-zero; without a GPU it exits 1 before
printing any result.  The last line is {"ok": true, "device": {...}};
the line before it lists the kernels with their launches on the paths
and their times.

TF32 is off for matmuls and cuDNN: fp32 means fp32 here.
"""

from __future__ import annotations

import contextlib
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
# allows a few cotangent elements to take the neighbouring int8 code, topk
# a few magnitudes within fp32 noise of the k-th largest to be kept on one
# side and dropped on the other (the element moves by its whole value)
GRAD_TOL = {"none": (1e-3, 1e-4), "int8": (1e-3, 2e-3),
            "topk": (1e-3, 1e-2)}
# phase 5d: the co-controller's search space on gpt2-small (jitter 0, so
# each prediction must equal the next round's simulated time)
CO_ROUNDS = 4
CO_SYS = dict(controller="co", rank_buckets=(4, 8, 16),
              compressor_buckets=("none", "int8", "fp8", "topk"),
              continuous_topk=True, smashed_ef=False, straggler_sim=True,
              jitter_sigma=0.0)
# phases 5e-5h: the round engine's remaining options on gpt2-small (the
# paper setting of phase 5, int8 smashed unless a phase says otherwise).
# 5e: local steps with unequal budgets, FedAvg every 2nd round, adapter
# top-k (keep 0.05) with error feedback, smashed top-k with error feedback
LS_ROUNDS = 4
LS_SYS = dict(scheduler="local_steps", max_local_steps=3, straggler_sim=True,
              agg_every=2, compress="topk", topk_frac=0.05,
              smashed_compress="topk", smashed_ef=True)
# 5f: two-tier FedAvg over 2 edge groups, adapter int8; the server ingest
# link (100 MB/s) is charged so the edge groups shorten the adapter sync
EDGE_ROUNDS = 3
EDGE_SYS = dict(scheduler="sync", straggler_sim=True, edge_groups=2,
                compress="int8", server_ingest_bw=1e8)
# 5g: FedBuff async with the overlapped pipeline and jitter, 3
# aggregations, then a mid-buffer checkpoint resumed
ASYNC_ROUNDS = 3
ASYNC_SYS = dict(scheduler="async", buffer_size=3, staleness_power=0.5,
                 overlap_comm=True, straggler_sim=True, jitter_sigma=0.2)
# 5h: requests served from phase 5e's trained per-client adapters
TRAINED_REQUESTS = 4
# 5i: population mode with phase 5's model and data: a cohort of the 5
# clients drawn from POPULATION pids each round (4C <= P: the sampler's
# rejection branch), the sync scheduler with the simulated clock; then P
# = C against phase 5's fleet run, a checkpoint after round 2 resumed, and
# TRAINED_REQUESTS requests served from trained pids' slots
POPULATION, POP_ROUNDS = 1000, 4
POP_SYS = dict(population=POPULATION, scheduler="sync", straggler_sim=True)
# phase 6 on the card and the CPU: the round engine's options, one step
# each (SGD, so adapter top-k keeps the largest gradients rather than
# choosing among AdamW's equal first steps); adapter deltas within
# (relative, share of max|delta|): a top-k or int8 element within fp32
# noise of the k-th magnitude or a rounding boundary moves by its value
# or one quantum on one side only
ENGINE_STEPS = [("local steps K 2, budgets [1, 2], smashed topk + EF, "
                 "adapter topk", dict(max_local_steps=2,
                                      smashed_compress="topk",
                                      compress="topk"), (1e-3, 1e-2)),
                ("async tick, buffer 2, staleness [2, 1]",
                 dict(async_buffer=True, buffer_size=2), (1e-3, 1e-4)),
                ("edge groups 2, adapter int8, smashed int8",
                 dict(num_edges=2, compress="int8",
                      smashed_compress="int8"), (1e-3, 1e-2))]
ENGINE_LR = 1e-2
# a card step that skipped the adapter compression would sit as far from
# the CPU's compressed deltas as the CPU's plain FedAvg does (ratio ~1)
COMPRESSION_SEEN = 0.5
# phase 6 on the card and the CPU: the memory knobs and a per-client
# policy (client 0 int8 at rank 4, client 1 topk keeping 0.25 at rank 16)
SMALL_POLICY = dict(rank_cut=[4, 16], choice=["int8", "topk"],
                    topk_frac=[0.1, 0.25])
# mamba2 training path: phase 7 at batch 1 per client without remat (48
# layers of saved fp32 activations), phase 7b at the paper's 4 under
# remat "full"; seq 512 = 2 SSD chunks.  Each peak of device memory must
# stay below PEAK_SHARE of the card.
M_BATCH, M4_BATCH, M_SEQ = 1, 4, 512
PEAK_SHARE = 0.9
# the SSD kernel in phase 2: (B, S, H, P, G, N, chunk, dt scale); G = 1
# and G > 1, chunks of 16, 64 and 256, S of one chunk and of 8 chunks;
# at chunk 256 every chunk's decay passes exp(88)
SSD_CASES = [(2, 64, 4, 16, 1, 16, 16, 1.0), (1, 256, 8, 64, 2, 128, 64, 1.0),
             (2, 256, 6, 64, 3, 128, 256, 1.0),
             (1, 2048, 4, 64, 1, 128, 256, 1.0),
             (1, 512, 4, 64, 1, 128, 256, 3.0)]
# ... and at the mamba2 training paths' shapes (5 clients x batch 1, and
# x batch 4)
SSD_PATH = (5, 512, 48, 64, 1, 128, 256)
SSD_PATH4 = (20,) + SSD_PATH[1:]
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

# the dense family at head dim 128 (llama3-8b, phi4-mini, qwen1.5-32b,
# mistral-large) and the paper's generalizability models (opt-125m,
# gpt-neo-125m).  Phase 9: llama3-8b at full width (32 heads over 8 kv
# heads of 128), depth cut to LLAMA_LAYERS of 32 with the cut at 4 and
# the config's cut buckets below LLAMA_LAYERS, the cross entropy over the
# 128256-wide head in chunks of LLAMA_CE_CHUNK positions; the paper
# setting otherwise (5 clients, batch 4, seq 512, r_cut 8, r_others 16,
# the config's int8 smashed activations).  Phase 9b serves the same model.
LLAMA_LAYERS, LLAMA_CUT, LLAMA_BUCKETS, LLAMA_CE_CHUNK = 8, 4, (2, 4), 128
LLAMA_HEADS = (32, 8)
# phase 10: opt-125m and gpt-neo-125m at full size and the paper setting;
# gpt-neo's 256-wide window bites on its odd layers at seq 512, and the
# served prompt of GEN_PROMPT tokens plus GEN_NEW runs decode past it
GEN_ARCHS = ("opt-125m", "gpt-neo-125m")
GEN_ROUNDS, GEN_PROMPT, GEN_NEW, GEN_MAX_LEN = 3, 288, 16, 320
# phase 10b: one card-vs-CPU step each at full width, 2 layers, seq 64
DENSE_STEP_ARCHS = ("phi4-mini-3.8b", "qwen1.5-32b", "mistral-large-123b")
DENSE_STEP_SEQ = 64
# phases 11 and 12: SSM and hybrid models served one request at a time
# (serial_reference: Model.prefill, then decode_step with the indexed
# pool): prompts of 300 (a chunk of 256 and 44 more, zero-padded to 512),
# 256 (one whole chunk), 37 and 2 (shorter than the conv window of 3)
# tokens, SSM_NEW new tokens each, over 2 adapters (phase 11) or the
# trained clients' (phase 12).  Their prefill-then-decode logits are held
# against the card's own train-mode forward over the same tokens at
# SSM_LOGITS_TOL: fp32, the same kernels, but the chunked scan over the
# whole sequence against the prompt's scan and then the one-token
# recurrence, so sums in another order through every layer; the served
# tokens and logits of a 2-layer full-width model against the CPU plain
# path at LOGITS_TOL, SSM_CPU_NEW new tokens each
SSM_PROMPTS, SSM_NEW, SSM_CPU_NEW = (300, 256, 37, 2), 32, 8
SSM_RANKS = [16, 8]
SSM_MAX_LEN = max(SSM_PROMPTS) + SSM_NEW
SSM_LOGITS_TOL = 1e-3
# phase 12: zamba2-1.2b at full width and depth, 5 clients at batch
# Z_BATCH x M_SEQ without remat (phase 7's setting), the config's cut 4
# and fp8 smashed activations; its 2-layer card-vs-CPU step keeps an
# attention layer (layers [SSD, attention])
Z_BATCH = 1
Z_SMALL_ATTN = (1,)
# the SSD kernel's final state in phase 2: (B, S, H, P, G, N, chunk, true
# length) with dt = 0 past the true length: a one-token prompt (chunk 1),
# a 37-token one (chunk 37), a 300-token one zero-padded to 512 at chunk
# 256 at mamba2's H/P/N and at zamba2's (H = P = N = 64)
SSD_STATE_CASES = [(2, 3, 4, 16, 1, 32, 1, 3),
                   (1, 37, 48, 64, 1, 128, 37, 37),
                   (1, 512, 48, 64, 1, 128, 256, 300),
                   (1, 512, 64, 64, 1, 64, 256, 300)]
# phase 3: the prefill of a 300-token prompt (padded to 512) through the
# SSD kernel with the final state, at mamba2's and zamba2's heads
SSD_PREFILL = (1, 512, 48, 64, 1, 128, 256)
SSD_PREFILL_Z = (1, 512, 64, 64, 1, 64, 256)

# the MoE family and the vlm frontend prefix.  Phase 13: kimi-k2 at full
# width (d_model 7168, 64 heads over 8 of 112, d_ff 2048 per expert,
# top-8, one shared expert, vocab 163840 untied, capacity factor 1.25,
# router aux loss 0.001), cut to KIMI_EXPERTS of its 384 experts a layer
# and KIMI_LAYERS of its 61 layers (one card holds 48 experts of 4
# layers beside the embeddings; all 384 take expert-parallel sharding
# over four cards), cut 2 over the buckets KIMI_BUCKETS (the config's
# (3, 6, 12, 20) do not fit 4 layers), 5 clients x batch KIMI_BATCH x
# seq 512, the config's int8 smashed activations, the cross entropy in
# chunks of KIMI_CE_CHUNK; then phase 4's serving workload from the
# trained adapters.  SplitFTSystem draws its weights on the card
# (draw_on_device: a CPU draw of 45 GB takes minutes).
KIMI, LLAMA4, VLM = ("kimi-k2-1t-a32b", "llama4-maverick-400b-a17b",
                     "internvl2-76b")
KIMI_EXPERTS, KIMI_LAYERS, KIMI_CUT, KIMI_BUCKETS = 48, 4, 2, (1, 2, 3)
KIMI_BATCH, KIMI_CE_CHUNK = 1, 128
KIMI_HEADS = (64, 8)
# phase 13b: one card-vs-CPU step each at full width and SMALL_LAYERS
# layers, weights drawn on the card and copied to the CPU: kimi-k2 and
# llama4-maverick at MOE_STEP_EXPERTS experts (Llama-4-Scout's count,
# the source the llama4 config names) at seq DENSE_STEP_SEQ, with
# prefill-then-decode logits and tokens; internvl2-76b at seq VLM_SEQ =
# its 256 prefix positions + 32 text tokens
MOE_STEP_EXPERTS = 16
VLM_SEQ = 288
# phase 2's flash checks at the GQA 8:1 models of head dim 128 (B, S, H,
# KVH): internvl2-76b at phase 13b's step (2 clients x batch 1, seq
# VLM_SEQ) and at seq 512, llama4-maverick at seq 512
WIDE_128_STEPS = [(2, VLM_SEQ, 64, 8), (2, 512, 64, 8), (2, 512, 40, 8)]

# the kernels' rows at head dims 128 and 112 in the result line: their
# launches are those of phases 9, 9b, 10b and 13b's llama4 and internvl2
# layers (hd 128) and of phase 13 (kimi-k2, hd 112)
WIDE_HD = ("flash_attention_fwd", "flash_attention_bwd", "decode_attention",
           "decode_attention_paged")
WIDE_HDS = (128, 112)


def hd_row(kname: str, hd: int) -> str:
    return f"{kname} (hd {hd})"


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
                    f"hd 64 group 1 (at llama3-8b's hd 128 group 4: "
                    f"{lib.decode_attention_smem(4, 128, c)} B)")
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
                "ssd_scan": ssd_ops.ssd_scan_fwd,
                "ssd_scan (final state)": ssd_ops.ssd_scan_fwd_state}
    rows_of = list(wrappers) + [hd_row(k, hd) for hd in WIDE_HDS
                                for k in WIDE_HD]
    worst = {k: 0.0 for k in rows_of}

    # -- phase 2: every kernel against its plain version ---------------------
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        errs = {k: 0.0 for k in rows_of}
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
        check_wide_kernels(torch, rand, dname, dt, dev, gen, errs, hd=128,
                           heads=LLAMA_HEADS, edge_heads=(4, 2), train_b=20,
                           what="llama3-8b", more=WIDE_128_STEPS)
        check_wide_kernels(torch, rand, dname, dt, dev, gen, errs, hd=112,
                           heads=KIMI_HEADS, edge_heads=(8, 1), train_b=5,
                           what="kimi-k2")
        check_dense_widths(torch, rand, dname, dt, gen, errs, kd=4096,
                           ns=(4096, 1024), m_eval=10240, what="llama3-8b")
        check_dense_widths(torch, rand, dname, dt, gen, errs, kd=7168,
                           ns=(7168, 896), m_eval=2560, what="kimi-k2")
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
    rows["ssd_scan"] = time_ssd_kernel(torch, rand, worst, SSD_PATH)
    rows["ssd_scan (batch 4)"] = time_ssd_kernel(torch, rand, worst,
                                                 SSD_PATH4)
    rows["ssd_scan (final state)"] = time_ssd_kernel(
        torch, rand, worst, SSD_PREFILL, final_state=True)
    rows["ssd_scan (final state, zamba2)"] = time_ssd_kernel(
        torch, rand, worst, SSD_PREFILL_Z, final_state=True)
    rows.update(time_ssm_lora(torch, rand, gen, worst))
    rows.update(time_mamba2_lora(torch, rand, worst))
    rows.update(time_wide_kernels(torch, F, rand, dev, gen, worst, hd=128,
                                  heads=LLAMA_HEADS, train_b=20,
                                  what="llama3-8b"))
    rows.update(time_wide_kernels(torch, F, rand, dev, gen, worst, hd=112,
                                  heads=KIMI_HEADS, train_b=5,
                                  what="kimi-k2"))
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

    launches = {k: 0 for k in rows_of}
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


    cut, serial = check_served_tokens(serving, model, params, pool, reqs,
                                      tokens["contiguous"], MAX_LEN,
                                      "phase 4")
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
    got, accuracy_times, fleet = train_phase(torch, dev, wrappers, name,
                                             card)
    for kname, c in got.items():
        launches[kname] += c

    # -- phase 5b, 5c: checkpoint resume, the train CLI ----------------------
    resume_phase(torch, dev, wrappers, name, card)
    cli_phase(torch, wrappers, name, card)

    # -- phase 5d: gpt2-small under the phase-time co-controller ------------
    for kname, c in co_phase(torch, dev, wrappers, name, card,
                             accuracy_times).items():
        launches[kname] += c

    # -- phases 5e-5h: local steps, two-tier FedAvg, async, trained serving -
    ls_system, got = local_steps_phase(torch, dev, wrappers, name, card)
    for phase in (got, edge_phase(torch, dev, wrappers, name, card),
                  async_phase(torch, dev, wrappers, name, card),
                  trained_serving_phase(torch, dev, wrappers, name, card,
                                        ls_system)):
        for kname, c in phase.items():
            launches[kname] += c
    del ls_system

    # -- phase 5i: population mode ------------------------------------------
    for kname, c in population_phase(torch, dev, wrappers, name, card,
                                     accuracy_times, fleet).items():
        launches[kname] += c
    del fleet

    # -- phase 6: one step at full width, reduced depth, card vs CPU --------
    small_step_check(torch, dev, "gpt2-small", SMALL_SEQ, GPT2_STEPS,
                     "phase 6")
    engine_step_check(torch, dev)

    # -- phase 7, 7b: the mamba2 training path, batch 1 and batch 4 ---------
    for kname, c in mamba2_phase(torch, dev, wrappers, name, card).items():
        launches[kname] += c
    for kname, c in mamba2_batch4_phase(torch, dev, wrappers, name,
                                        card).items():
        launches[kname] += c

    # -- phase 8: one mamba2 step at full width, reduced depth, card vs CPU -
    small_step_check(torch, dev, "mamba2-780m", M_SEQ, MAMBA2_STEPS,
                     "phase 8")

    # -- phase 9, 9b: llama3-8b at full width, training and serving ---------
    system, got = llama_phase(torch, dev, wrappers, name, card)
    add_launches(launches, got, hd=128)
    add_launches(launches, llama_serving_phase(torch, dev, wrappers, name,
                                               card, system), hd=128)
    del system
    small_step_check(torch, dev, "llama3-8b", SMALL_SEQ, LLAMA_STEPS,
                     "phase 9 step", compressed="mean")

    # -- phase 10: opt-125m and gpt-neo-125m, training and serving ----------
    for arch_name in GEN_ARCHS:
        add_launches(launches, generalizability_phase(
            torch, dev, wrappers, name, card, arch_name), hd=64)

    # -- phase 10b: phi4-mini, qwen1.5-32b, mistral-large, card vs CPU ------
    for arch_name in DENSE_STEP_ARCHS:
        comp = get_config(arch_name).split.smashed_compress
        small_step_check(torch, dev, arch_name, DENSE_STEP_SEQ,
                         [("none", "none", {}), (comp, comp, {})],
                         "phase 10b", compressed="mean")

    # -- phase 11: mamba2-780m serving at full width and depth ---------------
    add_launches(launches, mamba2_serving_phase(torch, dev, wrappers, name,
                                                card), hd=64)

    # -- phase 12: zamba2-1.2b at full width, training and serving ----------
    add_launches(launches, zamba2_phase(torch, dev, wrappers, name, card),
                 hd=64)

    # -- phase 13: kimi-k2 at full width, training and serving --------------
    add_launches(launches, kimi_phase(torch, dev, wrappers, name, card),
                 hd=112)

    # -- phase 13b: kimi-k2, llama4-maverick, internvl2-76b, card vs CPU ----
    for hd, got in moe_vlm_steps(torch, dev, wrappers).items():
        add_launches(launches, got, hd=hd)

    # -- results ----------------------------------------------------------------
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
                            "src/repro/kernels/ssd_scan/kernel.py:82"),
               "ssd_scan (final state)": (
                   "ssd_scan.cu", "src/repro/kernels/ssd_scan/kernel.py:82")}
    for hd in WIDE_HDS:
        for kname in WIDE_HD:
            sources[hd_row(kname, hd)] = sources[kname]
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


def profile_run(torch, serving, engine, reqs, name, card, tag="phase 4"):
    """The same workload again on a warm engine under the profiler: the
    device-busy share of the serving wall time, and the top kernels."""
    again = [serving.Request(rid=2000 + r.rid, adapter=r.adapter,
                             tokens=r.tokens, max_new=r.max_new)
             for r in reqs]
    wall, busy, by_name, _ = device_busy(torch, lambda: engine.run(again))
    if busy is None:
        log(f"{tag} profile [{name}, {card}]: device busy share not "
            f"measured (the profiler recorded no device activity); wall "
            f"{wall:.3f} s")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"{tag} profile [{name}, {card}]: contiguous run under "
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
    on SSD_CASES, SSD_EDGES and the batch-4 path's shape SSD_PATH4, and
    the fused LoRA forward at the eval steps' shapes: M = clients x batch
    x M_SEQ rows (batch M_BATCH and M4_BATCH) through mamba2's ssm_in
    (K 1536, N 6448, not a multiple of the kernel's 64-wide tile) and
    ssm_out (K 3072, N 1536).  The SSD output's rounding grows with the
    chunk's sums, so its absolute tolerance scales with max|y|."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.lora_matmul import ops as lops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models.ssm import in_proj_dim

    decays = []
    for b, s, h, p, g, n, chunk, dt_scale in \
            SSD_CASES + SSD_EDGES + [SSD_PATH4 + (1.0,)]:
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
    for b, s, h, p, g, n, chunk, true_len in SSD_STATE_CASES:
        ins = ssd_inputs(torch, rand, b, s, h, p, g, n, dt)
        ins[1][:, true_len:] = 0.0          # the zero-padded prompt tail
        what = f"S={s} (prompt {true_len}) H={h} P={p} N={n} chunk={chunk}"
        got = ssd_ops.ssd_scan(*ins, chunk=chunk, return_state=True)
        same_bits(torch, "ssd_scan (final state)", got,
                  ssd_ops.ssd_scan(*ins, chunk=chunk, return_state=True),
                  what)
        want = ssd_ops.ref.ssd_chunked(*ins, chunk=chunk, return_state=True)
        if got[1].dtype != dt or not torch.isfinite(got[1].float()).all():
            raise RuntimeError(f"SSD final state: {got[1].dtype} or "
                               f"non-finite at {what} ({dname})")
        e = max(max_err(torch, got[0], want[0], dname, f"ssd y {what}",
                        scaled=True),
                max_err(torch, got[1], want[1], dname,
                        f"ssd final state {what}", scaled=True))
        errs["ssd_scan (final state)"] = max(errs["ssd_scan (final state)"],
                                             e)
    log(f"phase 2 ({dname}): SSD final state (return_state=True) at "
        f"{len(SSD_STATE_CASES)} prefill shapes (chunks 1, 37, 256 over a "
        f"300-token prompt padded to 512; mamba2's and zamba2's heads): "
        f"max |kernel - plain| {errs['ssd_scan (final state)']:.3e}")
    arch = get_config("mamba2-780m")
    r, d = arch.lora.r_others, arch.model.d_model
    for m, kd, n in ((arch.data.num_clients * batch * M_SEQ, kd, n)
                     for batch in (M_BATCH, M4_BATCH)
                     for kd, n in ((d, in_proj_dim(arch.model)),
                                   (arch.model.d_inner, d))):
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


def time_ssd_kernel(torch, rand, errs, shape, final_state=False):
    """Phase 3 for the SSD kernel at a mamba2 training path's shape (fp32;
    SSD_PATH or SSD_PATH4), or with final_state at a prefill's (a prompt
    of SSM_PROMPTS[0] tokens zero-padded to S, dt = 0 on the padding;
    SSD_PREFILL, SSD_PREFILL_Z) through ssd_scan(return_state=True): the
    timed call's result held against its plain version on the same
    inputs, then
    kernel and plain times beside the bound, the device time of each of
    its four passes, and the FLOPs its MMAs execute beside the bound's.
    No PyTorch call computes the SSD scan: the library column is null.

    Bound: read x, dt, A, B, C once and write y (and the final state)
    once; operations per (b, h, chunk) are the inter-chunk term C . s
    (2 Q N P), the state update (2 Q P N) and the causal half of M @ x
    (2 Q(Q+1)/2 P), and per (b, group, chunk) the causal half of C . B
    (2 Q(Q+1)/2 N)."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    b, s, h, p, g, n, q = shape
    ins = ssd_inputs(torch, rand, b, s, h, p, g, n, torch.float32)
    if final_state:
        ins[1][:, SSM_PROMPTS[0]:] = 0.0
        kname = "ssd_scan (final state)"

        def kernel():
            return ssd_ops.ssd_scan(*ins, chunk=q, return_state=True)

        def plain():
            return ssd_ops.ref.ssd_chunked(*ins, chunk=q, return_state=True)
        got, want = kernel(), plain()
        e = max(max_err(torch, got[0], want[0], "float32",
                        "ssd prefill y", scaled=True),
                max_err(torch, got[1], want[1], "float32",
                        "ssd prefill final state", scaled=True))
    else:
        kname = "ssd_scan"

        def kernel():
            return ssd_ops.ssd_scan(*ins, chunk=q)

        def plain():
            return ssd_ops.ref.ssd_chunked(*ins, chunk=q)
        e = max_err(torch, kernel(), plain(), "float32",
                    "ssd at the path's shape", scaled=True)
    errs[kname] = max(errs[kname], e)
    nc, pairs = s // q, q * (q + 1) // 2
    cb_flops = b * nc * g * 2 * pairs * n
    flops = b * nc * h * (4 * q * n * p + 2 * pairs * p) + cb_flops
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * g * n
                  + (b * h * p * n if final_state else 0))
    executed = ssd_executed_flops(b, s, h, p, g, n, q)
    if executed["cb"] > 2 * cb_flops:
        raise RuntimeError(f"SSD C.B^T executes {executed['cb']} FLOPs, "
                           f"over 2x the per-group {cb_flops}")
    use = "prefill with the final state"
    if not final_state:
        # the train step's use: the kernel forward, then the plain
        # recompute backward (the difference of the two times is the
        # backward's)
        leaves = [t.clone().requires_grad_(True) for t in ins]
        gy = rand(b, s, h, p)
        fwd_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            ssd_ops.ssd_scan(*leaves, chunk=q), leaves, gy), iters=5,
            warmup=2)
        use = (f"kernel forward + plain recompute backward through autograd "
               f"{fwd_bwd_ms:.4f} ms")
    with torch.no_grad():
        row = dict(
            ms=cuda_ms(torch, kernel),
            plain_ms=cuda_ms(torch, plain, iters=10),
            library_ms=None,
            passes=pass_ms(torch, kernel, SSD_PASSES),
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
                  f"max |kernel - plain| {e:.3e}; {use})")
    return row


def time_ssm_lora(torch, rand, gen, errs):
    """Phase 3 for the indexed LoRA at the served SSD layers' ssm_in
    (mamba2: K 1536, N 6448; zamba2: K 2048, N 8384) at a decode tick's
    one row and a 300-token prefill, r_others 16 over 2 adapters (fp32):
    the timed call held against its plain version, kernel and plain
    times beside the bound (W read once, each used adapter's A and B,
    x, y), and the kernels per call.  No PyTorch call computes the
    per-row adapter product: the library column is null."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.lora_matmul import ops as lops

    rows = {}
    r, n_pool = 16, len(SSM_RANKS)
    for arch_name, kd, n in (("mamba2", 1536, 6448), ("zamba2", 2048, 8384)):
        for m in (1, SSM_PROMPTS[0]):
            x = rand(m, kd)
            w = rand(kd, n, scale=kd ** -0.5)
            a, bb = rand(n_pool, kd, r, scale=r ** -0.5), rand(n_pool, r, n,
                                                               scale=0.02)
            sc = torch.full((n_pool,), 2.0, device=x.device)
            ids = torch.ones((1,), dtype=torch.int32, device=x.device)
            x3 = x[None]
            args = (x3, w, a, bb, sc, ids)
            e = max_err(torch, lops.lora_matmul_indexed(*args),
                        lops.ref.lora_matmul_indexed(*args), "float32",
                        f"indexed lora ssm_in {arch_name} M={m}")
            errs["lora_matmul_indexed"] = max(errs["lora_matmul_indexed"], e)
            ctas = _build.library().lora_indexed_ctas(m, kd, n)
            rows[f"lora_matmul_indexed ({arch_name} ssm_in, "
                 f"{'decode' if m == 1 else 'prefill'})"] = dict(
                ms=cuda_ms(torch, lambda: lops.lora_matmul_indexed(*args)),
                plain_ms=cuda_ms(torch, lambda: lops.ref.lora_matmul_indexed(
                    *args)),
                library_ms=None,
                passes=pass_ms(torch, lambda: lops.lora_matmul_indexed(*args),
                               ("lora_indexed_kernel",), launches=True),
                **work(4 * (m * kd + kd * n + kd * r + r * n + m * n + 2),
                       2 * m * kd * n + 2 * m * r * (kd + n),
                       products=m > 1),
                shape=f"M={m} K={kd} N={n} r={r} P={n_pool} fp32, {ctas} "
                      f"CTAs (max |kernel - plain| {e:.3e})")
    return rows


def time_mamba2_lora(torch, rand, errs):
    """Phase 3 for the fused LoRA forward at the mamba2 eval steps' shapes
    (fp32): M = clients x batch x M_SEQ rows (batch M_BATCH, and M4_BATCH
    for phase 7b) through ssm_in (K 1536, N 6448) and ssm_out (K 3072,
    N 1536), 48 launches each per eval step, beside the cuBLAS
    composition, so that PERF.md can order it by launches x (time -
    bound)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.lora_matmul import ops as lops
    from repro_torch.models.ssm import in_proj_dim

    arch = get_config("mamba2-780m")
    r, d = arch.lora.r_others, arch.model.d_model
    rows = {}
    for batch, proj, kd, n in (
            (batch, proj, kd, n) for batch in (M_BATCH, M4_BATCH)
            for proj, kd, n in (("ssm_in", d, in_proj_dim(arch.model)),
                                ("ssm_out", arch.model.d_inner, d))):
        m = arch.data.num_clients * batch * M_SEQ
        x = rand(m, kd)
        w = rand(kd, n, scale=kd ** -0.5)
        a, bb = rand(kd, r, scale=r ** -0.5), rand(r, n, scale=0.02)
        sc = torch.tensor(2.0, device=x.device)
        y, xa = lops.lora_matmul_fwd(x, w, a, bb, sc)
        want_y, want_xa = lops.ref.lora_matmul_fwd(x, w, a, bb, sc)
        e = max(max_err(torch, y, want_y, "float32", f"lora fwd {proj}"),
                max_err(torch, xa, want_xa, "float32", f"lora xa {proj}"))
        errs["lora_matmul_fwd"] = max(errs["lora_matmul_fwd"], e)
        rows[f"lora_matmul_fwd (mamba2 {proj}"
             + (")" if batch == M_BATCH else ", batch 4)")] = dict(
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


POLICY = ("cuts", "rank_cut", "smashed_choice", "topk_frac")
TRACKED = POLICY + ("step_budgets",)


class TimedStep:
    """Stands in for a system's train_step or eval_step: calls the
    engine's step between two synchronizes, and keeps per call the
    policy it ran with (the cuts, and the co-controller's rank, bucket
    and keep fraction per client), the kernel launches it made and its
    wall seconds, and the last arguments (for the profiles).  The system
    calls whatever is bound to those attributes."""

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
        policy = {k: args[1][k].tolist() for k in TRACKED if k in args[1]}
        if len(args) > 4:                       # a train step's mask
            policy["active"] = np.asarray(args[4]).tolist()
        self.calls.append((policy,
                           {k: w.launches - before[k]
                            for k, w in self.wrappers.items()},
                           time.perf_counter() - t0))
        self.last = args
        return out


class HostTimer:
    """Stands in for a host-side call (the population store's gather and
    scatter): calls it between two synchronizes and keeps each call's
    wall seconds."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.calls = torch, fn, []

    def __call__(self, *args, **kw):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        self.torch.cuda.synchronize()
        self.calls.append(time.perf_counter() - t0)
        return out


def timed_system(torch, arch, dev, wrappers, sys_kw=None, ce_chunk=0,
                 draw_on_device=False):
    """SplitFTSystem on `arch` at full width on the card, random weights
    from SEED (drawn on the card with draw_on_device), the quickstart's
    data sizes, with TimedStep in place of its train and eval steps (and
    in population mode HostTimer in place of its store's gather and
    scatter).  ce_chunk > 0: the system builds its steps with the chunked
    cross entropy (the round engine's memory knob, which SystemConfig,
    like the reference's, does not name)."""
    import functools

    from repro_torch.core import rounds
    from repro_torch.core.system import SplitFTSystem, SystemConfig

    factories = rounds.make_train_step, rounds.make_eval_step
    if ce_chunk:
        rounds.make_train_step, rounds.make_eval_step = (
            functools.partial(f, ce_chunk=ce_chunk) for f in factories)
    try:
        system = SplitFTSystem(arch, SystemConfig(
            num_samples=NUM_SAMPLES, eval_samples=EVAL_SAMPLES,
            **(sys_kw or {})), seed=SEED, device=dev,
            draw_on_device=draw_on_device)
    finally:
        rounds.make_train_step, rounds.make_eval_step = factories
    system.train_step = TimedStep(torch, system.train_step, wrappers)
    system.eval_step = TimedStep(torch, system.eval_step, wrappers)
    if system.store is not None:
        system.store.gather = HostTimer(torch, system.store.gather)
        system.store.scatter = HostTimer(torch, system.store.scatter)
    return system


def run_rounds(torch, arch, dev, wrappers, tag, name, card,
               host_profile=False, sys_kw=None, rounds=ROUNDS,
               after_round=None, ce_chunk=0, draw_on_device=False):
    """`rounds` SplitFT rounds through SplitFTSystem.run on `arch` at full
    width (the sync scheduler and the accuracy controller unless sys_kw
    says otherwise): each round a train step, an eval step and the C3
    epilogue.  The launch counters are set to 0 before the rounds; each
    round prints its wall time, the train- and eval-step times and the
    host share (round wall - train - eval: planning, comm bytes, C3,
    records); after_round(system, r), if given, checks the round and
    returns more of its log line.  ce_chunk, draw_on_device: as
    timed_system's.  Then one
    more train + eval step of the
    system's engine runs under the profiler on its last inputs, and with
    host_profile one more train step under the host profiler.  Returns
    (system, the launches over the rounds, [(policy, train-step
    launches, eval-step launches)] per round, [(wall, train, eval, host)
    seconds] per round)."""
    t = arch.train
    t0 = time.perf_counter()
    system = timed_system(torch, arch, dev, wrappers, sys_kw, ce_chunk,
                          draw_on_device)
    train, ev = system.train_step, system.eval_step
    n = arch.data.num_clients
    log(f"{tag}: {arch.name} {system.model.num_flat_layers} layers, {n} "
        f"clients (samples {system.sample_counts.astype(int).tolist()}, "
        f"length-Dirichlet alpha {arch.data.alpha}), batch {t.batch_size} "
        f"x seq {t.seq_len}, remat {t.remat}, r_cut {arch.lora.r_cut} "
        f"r_others {arch.lora.r_others}, smashed {system.smashed_compress}, "
        f"{t.optimizer} lr {t.lr_client}, scheduler "
        f"{system.scheduler.name}, controller {system.controller}; "
        f"SplitFTSystem built in {time.perf_counter() - t0:.1f} s")

    tokens_per_step = n * t.batch_size * t.seq_len
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for r in range(rounds):
        t0 = time.perf_counter()
        system.run(1, log_every=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = system.history[-1]
        (policy, _, t_train), (_, _, t_eval) = train.calls[-1], ev.calls[-1]
        vals = [rec[k] for k in ("ce", "accuracy", "eval_ce",
                                 "eval_accuracy")]
        if not all(np.isfinite(v).all() for v in vals) or \
                not np.isfinite(rec["loss"]):
            raise RuntimeError(f"{tag} round {r}: non-finite loss")
        host = wall - t_train - t_eval
        times.append((wall, t_train, t_eval, host))
        extra = after_round(system, r) if after_round else ""
        log(f"{tag} round {r} [{name}, {card}]: cuts {policy['cuts']} -> "
            f"{system.state['cuts'].tolist()}; train ce {fmt(vals[0])} acc "
            f"{fmt(vals[1])}; eval ce {fmt(vals[2])} acc {fmt(vals[3])}; "
            f"comm per client "
            f"{(rec['comm'] / 1e6).round(3).tolist()} MB; round wall "
            f"{wall * 1e3:.1f} ms = train step {t_train * 1e3:.1f} ms "
            f"({tokens_per_step / t_train:.0f} tokens/s) + eval step "
            f"{t_eval * 1e3:.1f} ms + host {host * 1e3:.1f} ms (host share "
            f"{host / wall:.4f}); "
            f"max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB{extra}")
    got = {k: w.launches for k, w in wrappers.items()}
    log(f"{tag} launches over {rounds} rounds: "
        f"{ {k: c for k, c in got.items() if c} }")
    if len(train.calls) != rounds or len(ev.calls) != rounds:
        raise RuntimeError(f"{tag}: {len(train.calls)} train and "
                           f"{len(ev.calls)} eval steps in {rounds} rounds")
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
    return system, got, per_round, times


def check_launches(per_round, want_train, want_eval, what):
    """Each round's train-step and eval-step launches against the counts
    the code gives; want_train maps the round's policy ({"cuts": ...,
    and under the co-controller its "smashed_choice" ...}) to its
    counts.  Kernels left out must not launch."""
    for r, (policy, train, ev) in enumerate(per_round):
        for step, got, want in (("train", train, want_train(policy)),
                                ("eval", ev, want_eval)):
            bad = {k: (c, want.get(k, 0)) for k, c in got.items()
                   if c != want.get(k, 0)}
            if bad:
                raise RuntimeError(f"{what} round {r} {step} step launches "
                                   f"(got, want): {bad}")


def gpt2_train_launches(policy):
    """A gpt2-small train step's launches (int8 smashed): flash forward
    and backward per layer, the int8 round trip twice per distinct cut."""
    return {"flash_attention_fwd": 12, "flash_attention_bwd": 12,
            "int8_roundtrip_smashed": 2 * len(set(policy["cuts"]))}


GPT2_EVAL_LAUNCHES = {"flash_attention_fwd": 12, "lora_matmul_fwd": 48}


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
    adapters.  Returns the launches of both, the rounds' times and the
    fleet run's records and final state (for phase 5i)."""
    from repro_torch.tree import tree_map

    fleet = {}

    def keep_final(system, r):
        if r == ROUNDS - 1:
            fleet["state"] = tree_map(lambda x: x.detach().clone(),
                                      system.state)
        return ""

    system, got, per_round, times = run_rounds(torch, gpt2_int8(), dev,
                                               wrappers, "phase 5", name,
                                               card, after_round=keep_final)
    fleet["history"] = list(system.history)
    check_launches(per_round, gpt2_train_launches, GPT2_EVAL_LAUNCHES,
                   "gpt2-small training")

    bwd = global_adapter_grad(torch, dev, wrappers, system, 48,
                              "phase 5", name, card)
    # the round's launches, and the fused LoRA backward from the gradient
    # run (its forward launches are not the round's)
    return {**got, "lora_matmul_bwd": bwd}, times, fleet


def global_adapter_grad(torch, dev, wrappers, system, n_adapters, tag, name,
                        card) -> int:
    """The fused LoRA backward at the eval shape: the gradient of the
    global model's eval loss w.r.t. its served (rank-2) adapters, through
    autograd on lora_dense (the round itself has no rank-2 backward),
    on the system's last eval batch.  Every gradient must be finite and
    the backward kernel launch once per adapter.  Returns its launches."""
    from repro_torch.tree import tree_leaves, tree_map

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
        raise RuntimeError(f"{tag}: non-finite global-adapter gradient")
    bwd = {k: w.launches for k, w in wrappers.items()}
    if bwd["lora_matmul_bwd"] != n_adapters:
        raise RuntimeError(f"{tag}: the global-adapter gradient launched the "
                           f"fused LoRA backward {bwd['lora_matmul_bwd']} "
                           f"times, want {n_adapters}")
    log(f"{tag} global-adapter gradient [{name}, {card}]: eval loss and "
        f"its gradient w.r.t. the {n_adapters} served adapters in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms; launches "
        f"{ {k: c for k, c in bwd.items() if c} }")
    return bwd["lora_matmul_bwd"]


def host_shares(times):
    """The host share of each round after round 0 (its first calls)."""
    return [host / wall for wall, _, _, host in times[1:]]


def co_phase(torch, dev, wrappers, name, card, accuracy_times):
    """Phase 5d: CO_ROUNDS rounds of full-width gpt2-small (int8 smashed
    by default) under the phase-time co-controller, through
    SplitFTSystem.run: each round's train step runs every client's own
    (cut, rank at the cut, compressor, topk keep fraction), and the C3
    epilogue prices 4 cut offsets x 3 ranks x 4 compressors on the host
    to move them.  Every policy must stay in its buckets and bounds; with
    jitter 0 each round's predicted time must equal the next round's
    simulated time exactly (the reference's pin); each train step
    launches the int8 round trip twice (forward and the straight-through
    backward) per distinct cut layer where some client chose int8.
    Returns the launches."""
    system, got, per_round, times = run_rounds(
        torch, gpt2_int8(), dev, wrappers, "phase 5d", name, card,
        sys_kw=CO_SYS, rounds=CO_ROUNDS)
    buckets = system.comp_buckets
    int8 = buckets.index("int8")
    check_launches(per_round, lambda p: {
        "flash_attention_fwd": 12, "flash_attention_bwd": 12,
        "int8_roundtrip_smashed": 2 * len({
            c for c, k in zip(p["cuts"], p["smashed_choice"])
            if k == int8})},
        GPT2_EVAL_LAUNCHES, "gpt2-small under the co-controller")
    cut_buckets = set(system.arch.split.buckets(system.model.num_flat_layers))
    lo, hi = 0.01, 1.0                      # co_adjust's frac_bounds
    hist = system.history
    for h in hist:
        if not (set(h["cuts"].tolist()) <= cut_buckets
                and set(h["rank_cut"].tolist()) <= set(CO_SYS["rank_buckets"])
                and set(h["smashed_choice"].tolist()) <= set(
                    range(len(buckets)))
                and ((h["topk_frac"] >= lo) & (h["topk_frac"] <= hi)).all()):
            raise RuntimeError(f"phase 5d round {h['round']}: a policy left "
                               f"its buckets: {h}")
    for a, b in zip(hist[:-1], hist[1:]):
        if not np.array_equal(a["predicted_time"], b["round_time_sim"]):
            raise RuntimeError(
                f"phase 5d round {a['round']}: predicted {a['predicted_time']}"
                f" != next simulated {b['round_time_sim']}")
    moves = [int(np.any([a[k] != b[k] for k in POLICY], axis=0).sum())
             for a, b in zip(hist[:-1], hist[1:])]
    rows = [f"round {h['round']} cuts {h['cuts'].tolist()} rank "
            f"{h['rank_cut'].tolist()} compressor "
            f"{[buckets[k] for k in h['smashed_choice']]} topk_frac "
            f"{np.round(h['topk_frac'].astype(float), 4).tolist()} "
            f"predicted {h['predicted_time'].round(6).tolist()} s"
            for h in hist]
    log(f"phase 5d [{name}, {card}]: buckets {buckets}; per round: "
        + "; ".join(rows) + f"; clients whose policy moved after each "
        f"round: {moves}; each round's predicted time equals the next "
        f"round's simulated time exactly")
    co, acc = host_shares(times), host_shares(accuracy_times)
    log(f"phase 5d [{name}, {card}]: after round 0, train step "
        f"{fmt([t * 1e3 for _, t, _, _ in times[1:]])} ms, eval step "
        f"{fmt([e * 1e3 for _, _, e, _ in times[1:]])} ms, host "
        f"{fmt([h * 1e3 for _, _, _, h in times[1:]])} ms, host share "
        f"{fmt(co)} (median {np.median(co):.4f}) against phase 5's "
        f"accuracy controller {fmt(acc)} (median {np.median(acc):.4f})")
    return got


def _rows_equal(system):
    """Whether every client holds the same layer-0 q adapter (a layer
    every client owns): true right after a FedAvg with everyone active."""
    a = system.state["client_adapters"]["dec"]["q"]["A"][0]
    return all(bool(a[0].equal(a[i])) for i in range(1, a.shape[0]))


def _norm(torch, tree):
    from repro_torch.tree import tree_leaves

    return float(torch.sqrt(sum(x.float().square().sum()
                                for x in tree_leaves(tree))))


def local_steps_phase(torch, dev, wrappers, name, card):
    """Phase 5e: LS_ROUNDS rounds of full-width gpt2-small under the
    local-steps scheduler (K up to 3, budgets from the straggler clock),
    FedAvg every 2nd round with adapter top-k and its error feedback, and
    smashed top-k with error feedback.  A train step runs max(budgets)
    inner steps, each 12 flash forwards and 12 backwards (top-k is plain
    torch: no int8 kernel); FedAvg must happen exactly in the rounds
    agg_every names (the layer-0 rows equal across clients), and both
    residuals must be nonzero after round 0.  Returns (system, launches,
    the rounds' times)."""
    def after(system, r):
        st = system.state
        agg = (r + 1) % LS_SYS["agg_every"] == 0
        if _rows_equal(system) != agg:
            raise RuntimeError(f"phase 5e round {r}: FedAvg ran "
                               f"{not agg}, agg_every says {agg}")
        sm, ad = _norm(torch, st["smashed_ef"]), _norm(torch, st["ef"])
        if not (sm > 0 and (ad > 0 or not agg)):
            raise RuntimeError(f"phase 5e round {r}: residual norms "
                               f"smashed {sm} adapter {ad}")
        return (f"; budgets {system.history[-1]['step_budgets'].tolist()}"
                f", aggregated {agg}; residual norms: smashed {sm:.4e}, "
                f"adapter {ad:.4e}")

    system, got, per_round, times = run_rounds(
        torch, gpt2_int8(), dev, wrappers, "phase 5e", name, card,
        sys_kw=LS_SYS, rounds=LS_ROUNDS, after_round=after)

    def inner(p):
        return max(b for b, a in zip(p["step_budgets"], p["active"]) if a)

    check_launches(per_round, lambda p: {
        "flash_attention_fwd": 12 * inner(p),
        "flash_attention_bwd": 12 * inner(p)},
        GPT2_EVAL_LAUNCHES, "gpt2-small local steps")
    steps = [inner(p) for p, _, _ in per_round]
    per_step = list(zip(times[1:], steps[1:]))
    log(f"phase 5e [{name}, {card}]: inner steps per round {steps}; after "
        f"round 0, train step "
        f"{fmt([t * 1e3 for _, t, _, _ in times[1:]])} ms = "
        f"{fmt([t * 1e3 / k for (_, t, _, _), k in per_step])}"
        f" ms per inner step, eval "
        f"{fmt([e * 1e3 for _, _, e, _ in times[1:]])} ms, host share "
        f"{fmt(host_shares(times))}")
    return system, got


def edge_phase(torch, dev, wrappers, name, card):
    """Phase 5f: EDGE_ROUNDS sync rounds of full-width gpt2-small (int8
    smashed) with two-tier FedAvg over 2 edge groups and int8 adapter
    deltas.  Launches as phase 5's; every round aggregates (layer-0 rows
    equal); the charged adapter-sync phase is logged per client."""
    def after(system, r):
        if not _rows_equal(system):
            raise RuntimeError(f"phase 5f round {r}: no FedAvg")
        rec = system.history[-1]
        return (f"; edges {system.state['edge_assign'].tolist()}, charged "
                f"adapter sync {np.round(rec['phase_times'][4], 6).tolist()}"
                f" s")

    system, got, per_round, times = run_rounds(
        torch, gpt2_int8(), dev, wrappers, "phase 5f", name, card,
        sys_kw=EDGE_SYS, rounds=EDGE_ROUNDS, after_round=after)
    check_launches(per_round, gpt2_train_launches, GPT2_EVAL_LAUNCHES,
                   "gpt2-small two-tier")
    log(f"phase 5f [{name}, {card}]: after round 0, train step "
        f"{fmt([t * 1e3 for _, t, _, _ in times[1:]])} ms, host share "
        f"{fmt(host_shares(times))}")
    return got


def async_phase(torch, dev, wrappers, name, card):
    """Phase 5g: full-width gpt2-small (int8 smashed) under the async
    scheduler with the overlapped pipeline and jitter, until ASYNC_ROUNDS
    aggregations.  Each tick is one train step over every client's batch
    (12 flash forwards and backwards, the int8 round trip twice per
    distinct cut); each aggregation one eval step.  Logs ticks per
    aggregation, buffer fills, staleness, tick wall and the host share.
    Then a second system ticks into a partly filled buffer, checkpoints,
    and a third restores it: the next aggregation of the restored system
    must equal the checkpointed one's bit for bit (loss, clock,
    staleness, every adapter).  Returns the launches of the first run."""
    import tempfile

    arch = gpt2_int8()
    system = timed_system(torch, arch, dev, wrappers, ASYNC_SYS)
    train, ev = system.train_step, system.eval_step
    for w in wrappers.values():
        w.launches = 0
    ticks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    system.run(ASYNC_ROUNDS, log_every=0,
               callback=lambda rec: ticks.append(len(train.calls)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: w.launches for k, w in wrappers.items()}
    check_launches([(c, tl, {}) for c, tl, _ in train.calls],
                   gpt2_train_launches, {}, "gpt2-small async ticks")
    check_launches([({}, {}, el) for _, el, _ in ev.calls], lambda p: {},
                   GPT2_EVAL_LAUNCHES, "gpt2-small async eval")
    hist = system.history
    for h in hist:
        if h["buffer_fill"] < ASYNC_SYS["buffer_size"] or \
                (h["staleness"] < 0).any() or not np.isfinite(h["loss"]):
            raise RuntimeError(f"phase 5g round {h['round']}: {h}")
    t_ticks = [t for _, _, t in train.calls]
    t_eval = [t for _, _, t in ev.calls]
    host = wall - sum(t_ticks) - sum(t_eval)
    log(f"phase 5g [{name}, {card}]: gpt2-small async, buffer "
        f"{system.scheduler.buffer_size}, staleness power "
        f"{ASYNC_SYS['staleness_power']}, overlap_comm; {len(train.calls)} "
        f"ticks for {len(hist)} aggregations (ticks at each flush "
        f"{ticks}); per aggregation: " + "; ".join(
            f"round {h['round']} fill {h['buffer_fill']} staleness "
            f"{h['staleness'].astype(int).tolist()} steps "
            f"{h['round_steps'].tolist()} sim_clock {h['sim_clock']!r} loss "
            f"{h['loss']:.4f}" for h in hist)
        + f"; tick wall {fmt([t * 1e3 for t in t_ticks])} ms (median "
        f"{np.median(t_ticks) * 1e3:.1f}), eval "
        f"{fmt([t * 1e3 for t in t_eval])} ms; wall {wall:.3f} s, host "
        f"{host * 1e3:.1f} ms, host share {host / wall:.4f}; launches "
        f"{ {k: c for k, c in got.items() if c} }")

    with tempfile.TemporaryDirectory() as d:
        kw = dict(ASYNC_SYS, checkpoint_dir=d)
        first = timed_system(torch, arch, dev, wrappers, kw)
        first.run(1, log_every=0)
        lr = first._lrs()
        while float(first.state["buffer_mask"].sum()) == 0:
            if first._async_tick(1, *lr) is not None:
                raise RuntimeError("phase 5g: a tick flushed an empty "
                                   "buffer")
        fill = float(first.state["buffer_mask"].sum())
        first.save(7)
        resumed = timed_system(torch, arch, dev, wrappers, kw)
        if not resumed.restore():
            raise RuntimeError("phase 5g: no checkpoint to restore")
        if resumed.scheduler.queue._pending != \
                first.scheduler.queue._pending:
            raise RuntimeError("phase 5g: the restored event queue differs")
        a, b = first.run(1, log_every=0)[-1], resumed.run(1, log_every=0)[-1]
    for k in ("loss", "sim_clock", "staleness", "ce", "cuts", "active"):
        if not np.array_equal(a[k], b[k]):
            raise RuntimeError(f"phase 5g resume: {k} {a[k]} straight, "
                               f"{b[k]} resumed")
    from repro_torch.tree import tree_leaves
    for x, y in zip(tree_leaves(first.state["client_adapters"]),
                    tree_leaves(resumed.state["client_adapters"])):
        if not torch.equal(x, y):
            raise RuntimeError("phase 5g resume: adapters differ")
    log(f"phase 5g resume [{name}, {card}]: checkpoint with {fill:.0f} of "
        f"{system.scheduler.buffer_size} buffered and "
        f"{len(first.scheduler.queue)} events in flight; the next "
        f"aggregation (round {a['round']}, sim_clock {a['sim_clock']!r}, "
        f"loss {a['loss']!r}) equals the straight run's bit for bit, "
        f"adapters included")
    return got


def decided_steps(torch, logits) -> int:
    """The steps of a generation before the first whose top-2 logits
    ((n_new, V), the reference's) lie within TOP2_GAP: up to there fp32
    sums in another order cannot pick the other token."""
    top2 = torch.topk(logits, 2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    return next((i for i, g in enumerate(gaps) if g < TOP2_GAP), len(gaps))


def check_served_tokens(serving, model, params, pool, reqs, tokens,
                        max_len, what):
    """The engine's tokens against serial_reference, compared up to the
    first step whose top-2 logits lie within TOP2_GAP (there fp32 sums
    in another order may pick the other token).  Returns how many
    requests were compared only that far, and the serial tokens."""
    import torch

    serial, logits = serving.serial_reference(
        model, params, pool, reqs, max_len=max_len, return_logits=True)
    cut = 0
    for r, got in zip(reqs, tokens):
        upto = decided_steps(torch, logits[r.rid])
        cut += upto < r.max_new
        if got[:upto] != serial[r.rid][:upto]:
            raise RuntimeError(f"{what}: request {r.rid}: engine tokens "
                               f"{got} != serial {serial[r.rid]} before "
                               f"position {upto}")
    return cut, serial


def serve_pool(torch, dev, wrappers, system, pool, tag):
    """TRAINED_REQUESTS requests, one per adapter of `pool` in turn,
    through the serving engine on the system's base weights; the tokens
    must equal serial_reference and the serving kernels must launch.
    Returns (the launches of the engine run, wall s, requests compared
    only up to a top-2 gap)."""
    from repro_torch.runtime import serving

    n = serving.num_pool_adapters(pool)
    rng = np.random.default_rng(SEED + 7)
    reqs = [serving.Request(rid=i, adapter=i % n,
                            tokens=rng.integers(3, system.arch.model
                                                .vocab_size, size=PROMPT),
                            max_new=GEN) for i in range(TRAINED_REQUESTS)]
    engine = serving.ServingEngine(
        system.model, system.base_params, pool,
        serving.ServeConfig(num_slots=SLOTS, max_len=MAX_LEN), device=dev)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: w.launches for k, w in wrappers.items()}
    for k in ("flash_attention_fwd", "lora_matmul_indexed",
              "decode_attention"):
        if not got[k]:
            raise RuntimeError(f"{tag}: {k} never launched")
    cut, _ = check_served_tokens(serving, system.model, system.base_params,
                                 pool, reqs, [r["tokens"] for r in res],
                                 MAX_LEN, tag)
    return got, wall, cut


def trained_serving_phase(torch, dev, wrappers, name, card, system):
    """Phase 5h: phase 5e's trained per-client adapters as a serving pool
    (runtime.serving.pool_from_state): TRAINED_REQUESTS requests, one per
    client, through the engine; the tokens must equal serial_reference.
    Returns the launches of the engine run."""
    from repro_torch.runtime import serving

    pool = serving.pool_from_state(system.model, system.state)
    got, wall, cut = serve_pool(torch, dev, wrappers, system, pool,
                                "phase 5h")
    log(f"phase 5h [{name}, {card}]: {TRAINED_REQUESTS} requests on phase "
        f"5e's {serving.num_pool_adapters(pool)} trained adapters "
        f"(pool_from_state) in {wall:.3f} s; tokens equal serial_reference "
        f"({cut} compared up to a top-2 gap < {TOP2_GAP}); launches "
        f"{({k: c for k, c in got.items() if c})}")
    return got


def _same_state(torch, a, b, what):
    """Two round states (or store trees) equal leaf for leaf, bit for
    bit."""
    from repro_torch.tree import tree_leaves_with_path

    la, lb = list(tree_leaves_with_path(a)), list(tree_leaves_with_path(b))
    if [k for k, _ in la] != [k for k, _ in lb]:
        raise RuntimeError(f"{what}: the trees differ in structure")
    for (keys, x), (_, y) in zip(la, lb):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        if x.dtype != y.dtype or not torch.equal(x.cpu(), y.cpu()):
            raise RuntimeError(f"{what}: {'/'.join(keys)} differs")


def population_phase(torch, dev, wrappers, name, card, accuracy_times,
                     fleet):
    """Phase 5i: population mode on phase 5's model and data.

    1. POP_ROUNDS rounds with a cohort of the 5 clients drawn from
       POPULATION pids (the sampler's rejection branch): every round a new
       cohort is gathered from the host-resident store onto the card and
       scattered back; launches per step as phase 5's; each round logs
       its train, eval and host ms and host share beside phase 5's, the
       store's gather and scatter ms and its bytes.
    2. P = C = 5 for ROUNDS rounds: losses, cuts and every state leaf equal
       phase 5's fleet run bit for bit.
    3. The first run's rounds 0-1 again with a checkpoint after round 2,
       restored into a fresh system, which runs rounds 2-3: cohorts,
       losses, sim_clock and every slot of the store equal the straight
       run's bit for bit.
    4. TRAINED_REQUESTS requests served from the store's slots of trained
       pids (runtime.serving.pool_from_population); tokens equal
       serial_reference.

    Returns the launches of the rounds of 1 and of the serving run."""
    import tempfile

    from repro_torch.runtime import serving

    arch = gpt2_int8()
    cohorts = []

    def after(system, r):
        store = system.store
        cohorts.append(system._cohort_pids.copy())
        return (f"; cohort {cohorts[-1].tolist()}, store gather "
                f"{store.gather.calls[-1] * 1e3:.1f} ms, scatter "
                f"{store.scatter.calls[-1] * 1e3:.1f} ms, "
                f"{len(store)} slots x {store.slot_bytes / 2**20:.2f} MiB = "
                f"{len(store) * store.slot_bytes / 2**20:.1f} MiB on the host")

    system, got, per_round, times = run_rounds(
        torch, arch, dev, wrappers, "phase 5i", name, card, sys_kw=POP_SYS,
        rounds=POP_ROUNDS, after_round=after)
    check_launches(per_round, gpt2_train_launches, GPT2_EVAL_LAUNCHES,
                   "gpt2-small population")
    store = system.store
    if len(cohorts) != POP_ROUNDS or len(store) <= arch.data.num_clients:
        raise RuntimeError(f"phase 5i: {len(cohorts)} cohorts drawn, "
                           f"{len(store)} slots in the store")
    moved = arch.data.num_clients * store.slot_bytes
    gather, scatter = store.gather.calls, store.scatter.calls
    log(f"phase 5i [{name}, {card}]: P = {POPULATION}, C = "
        f"{arch.data.num_clients}; after round 0, train step "
        f"{fmt([t * 1e3 for _, t, _, _ in times[1:]])} ms, eval "
        f"{fmt([e * 1e3 for _, _, e, _ in times[1:]])} ms, host "
        f"{fmt([h * 1e3 for _, _, _, h in times[1:]])} ms, host share "
        f"{fmt(host_shares(times))} against phase 5's "
        f"{fmt(host_shares(accuracy_times))}; gather "
        f"{fmt([t * 1e3 for t in gather])} ms, scatter "
        f"{fmt([t * 1e3 for t in scatter])} ms for "
        f"{moved / 2**20:.1f} MiB each way ({store.slot_bytes} bytes a "
        f"slot): {fmt([moved / t / 1e9 for t in gather])} and "
        f"{fmt([moved / t / 1e9 for t in scatter])} GB/s")

    # 2. P == C against phase 5's fleet run
    same = timed_system(torch, arch, dev, wrappers,
                        dict(population=arch.data.num_clients))
    same.run(ROUNDS, log_every=0)
    for a, b in zip(fleet["history"], same.history):
        for k in ("loss", "ce", "cuts"):
            if not np.array_equal(a[k], b[k]):
                raise RuntimeError(f"phase 5i P = C round {a['round']}: {k} "
                                   f"{b[k]} against phase 5's {a[k]}")
    _same_state(torch, fleet["state"], same.state, "phase 5i P = C state")
    del same

    # 3. checkpoint after round 2, resume, against the straight run
    with tempfile.TemporaryDirectory() as d:
        kw = dict(POP_SYS, checkpoint_dir=d, checkpoint_every=2)
        timed_system(torch, arch, dev, wrappers, kw).run(2, log_every=0)
        resumed = timed_system(torch, arch, dev, wrappers, kw)
        if not resumed.restore():
            raise RuntimeError("phase 5i: no checkpoint to restore")
        resumed_cohorts = []
        resumed.run(POP_ROUNDS - 2, log_every=0, callback=lambda rec:
                    resumed_cohorts.append(resumed._cohort_pids.copy()))
    for a, b, pa, pb in zip(system.history[2:], resumed.history,
                            cohorts[2:], resumed_cohorts):
        if not np.array_equal(pa, pb):
            raise RuntimeError(f"phase 5i resume: cohort {pb} against the "
                               f"straight run's {pa}")
        for k in ("loss", "ce", "sim_clock", "cuts"):
            if not np.array_equal(a[k], b[k]):
                raise RuntimeError(f"phase 5i resume round {a['round']}: "
                                   f"{k} {b[k]} against {a[k]}")
    _same_state(torch, store.state_tree(), resumed.store.state_tree(),
                "phase 5i resume store")
    log(f"phase 5i resume [{name}, {card}]: checkpoint after round 2 "
        f"restored; rounds 2-3 (cohorts {[c.tolist() for c in cohorts[2:]]}"
        f", sim_clock {[h['sim_clock'] for h in resumed.history]}) and "
        f"all {len(store)} slots equal the straight run's bit for bit; P = "
        f"C = {arch.data.num_clients}: losses, cuts and every state leaf "
        f"equal phase 5's fleet run bit for bit")
    del resumed

    # 4. serving trained pids from the store
    pids = sorted({int(p) for c in cohorts for p in c})[:TRAINED_REQUESTS]
    pool = serving.pool_from_population(system.model, system.state, store,
                                        pids)
    served, wall, cut = serve_pool(torch, dev, wrappers, system, pool,
                                   "phase 5i serving")
    log(f"phase 5i serving [{name}, {card}]: {TRAINED_REQUESTS} requests on "
        f"trained pids {pids} (pool_from_population) in {wall:.3f} s; "
        f"tokens equal serial_reference ({cut} compared up to a top-2 gap "
        f"< {TOP2_GAP}); launches "
        f"{({k: c for k, c in served.items() if c})}")
    return {k: got[k] + served[k] for k in got}


def engine_step_check(torch, dev):
    """Phase 6, the round engine's options: one step each of
    ENGINE_STEPS at full width and 2 layers (2 clients, cuts [1, 2],
    batch SMALL_BATCH, seq SMALL_SEQ, SGD at ENGINE_LR) on the card and
    on the CPU plain path from one state.  Per-client losses within
    STEP_TOL; the adapter deltas (new - start) within the case's
    (relative, share of max|delta|).  A few elements next to the k-th
    magnitude or an int8 rounding boundary may move by their value or a
    quantum, which can exceed what the compression itself changes at its
    largest element; so a compressed case is also held on average: the
    card's mean distance to the CPU's deltas must stay below
    COMPRESSION_SEEN times the CPU's mean distance to the same step
    without adapter compression, which a card step that skipped the
    compression would fail."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import rounds
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves

    arch = get_config("gpt2-small")
    arch = arch.replace(
        model=dataclasses.replace(arch.model, num_layers=SMALL_LAYERS),
        split=dataclasses.replace(arch.split, cut_layer=1, cut_buckets=(1,)),
        train=dataclasses.replace(arch.train, optimizer="sgd",
                                  batch_size=SMALL_BATCH,
                                  seq_len=SMALL_SEQ))
    rng = np.random.default_rng(SEED + 6)
    toks = rng.integers(3, arch.model.vocab_size,
                        size=(2, SMALL_CLIENTS, SMALL_BATCH, SMALL_SEQ + 1))
    batch2 = {"tokens": toks[..., :-1].astype(np.int32),
              "labels": toks[..., 1:].astype(np.int32)}
    weights = np.array([0.25, 0.75], np.float32)
    active = np.ones(SMALL_CLIENTS, np.float32)
    out = {}
    for role, dv in (("card", dev), ("cpu", torch.device("cpu"))):
        model = build_model(arch, device=dv)
        params = model.init_params(torch.Generator().manual_seed(SEED))
        for label, kw, _ in ENGINE_STEPS:
            variants = [(label, kw)]
            if role == "cpu" and kw.get("compress", "none") != "none":
                variants.append((label + " (plain FedAvg)",
                                 dict(kw, compress="none")))
            for lab, opt in variants:
                state = rounds.init_state(
                    model, torch.Generator().manual_seed(SEED + 3),
                    num_clients=SMALL_CLIENTS)
                gen = torch.Generator().manual_seed(SEED + 4)
                for side in ("client_adapters", "server_adapters"):
                    for targets in state[side].values():
                        for leaf in targets.values():
                            leaf["B"] = (torch.randn(leaf["B"].shape,
                                                     generator=gen)
                                         * 0.02).to(dv)
                state["cuts"] = torch.tensor([1, 2], dtype=torch.int32)
                state = rounds.prepare_state(
                    state, max_local_steps=opt.get("max_local_steps", 1),
                    async_buffer=opt.get("async_buffer", False),
                    edge_groups=opt.get("num_edges", 1))
                batch = {k: v[0] for k, v in batch2.items()}
                if opt.get("max_local_steps", 1) > 1:
                    state["step_budgets"] = torch.tensor([1, 2],
                                                         dtype=torch.int32)
                    batch = batch2
                if opt.get("compress") == "topk":
                    state = rounds.with_error_feedback(state)
                if opt.get("smashed_compress") == "topk":
                    state = rounds.with_smashed_ef(state, model)
                if opt.get("async_buffer"):
                    state["global_version"] = torch.tensor(
                        2, dtype=torch.int32)
                    state["adapter_version"] = torch.tensor(
                        [0, 1], dtype=torch.int32)
                start = [x.clone() for x in
                         tree_leaves(state["client_adapters"])
                         + tree_leaves(state["server_adapters"])]
                step = rounds.make_train_step(model, **opt)
                new, met = step(params, state, batch, weights, active,
                                ENGINE_LR, ENGINE_LR)
                if opt.get("async_buffer") and not bool(met["aggregated"]):
                    raise RuntimeError(f"phase 6 ({lab}): no aggregation")
                now = (tree_leaves(new["client_adapters"])
                       + tree_leaves(new["server_adapters"]))
                out[role, lab] = (met["ce"].cpu(),
                                  [(a - b).cpu() for a, b in zip(now, start)])
    for label, kw, (rtol, share) in ENGINE_STEPS:
        (ce_k, d_k), (ce_c, d_c) = out["card", label], out["cpu", label]
        torch.testing.assert_close(
            ce_k, ce_c, rtol=STEP_TOL, atol=0,
            msg=lambda m: f"phase 6 ({label}) card vs CPU losses: {m}")
        scale = max(float(d.abs().max()) for d in d_c)
        for a, b in zip(d_k, d_c):
            torch.testing.assert_close(
                a, b, rtol=rtol, atol=share * scale,
                msg=lambda m: f"phase 6 ({label}) card vs CPU adapter "
                              f"deltas: {m}")
        worst = max(float((a - b).abs().max()) for a, b in zip(d_k, d_c))
        seen = ""
        if kw.get("compress", "none") != "none":
            plain = out["cpu", label + " (plain FedAvg)"][1]
            mean = lambda xs, ys: float(sum(                    # noqa: E731
                (x - y).abs().sum() for x, y in zip(xs, ys))
                / sum(x.numel() for x in xs))
            off, comp = mean(d_k, d_c), mean(d_c, plain)
            if not off <= COMPRESSION_SEEN * comp:
                raise RuntimeError(
                    f"phase 6 ({label}): the card's mean |delta - CPU| "
                    f"{off:.3e} is not below {COMPRESSION_SEEN} x the "
                    f"CPU's mean gap to plain FedAvg {comp:.3e}: the card "
                    f"may have skipped the adapter compression")
            seen = (f"; mean |card - CPU| {off:.3e} against the CPU's "
                    f"mean gap to plain FedAvg {comp:.3e} (ratio "
                    f"{off / comp:.2e}, must be <= {COMPRESSION_SEEN})")
        log(f"phase 6 ({label}): gpt2-small full-width {SMALL_LAYERS}-layer "
            f"step, {SMALL_CLIENTS} clients (cuts [1, 2]), SGD lr "
            f"{ENGINE_LR}: card vs CPU losses {fmt(ce_k)} vs {fmt(ce_c)} "
            f"(rtol {STEP_TOL}); {len(d_k)} adapter deltas, max |diff| "
            f"{worst:.3e} = {worst / scale:.2e} of max|delta| (tol {rtol} "
            f"relative + {share} of max|delta|){seen}")


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


def mamba2_arch(batch, remat="none"):
    import dataclasses

    from repro_torch.configs import get_config

    arch = get_config("mamba2-780m")
    return arch.replace(train=dataclasses.replace(
        arch.train, batch_size=batch, seq_len=M_SEQ, remat=remat))


def mamba2_phase(torch, dev, wrappers, name, card):
    """Phase 7: ROUNDS SplitFT rounds on full-width, full-depth
    mamba2-780m (48 SSD layers, the config's own smashed compressor
    "none"), 5 clients at batch M_BATCH x seq M_SEQ (2 chunks of 256).
    Every SSD scan of a train or eval step is a kernel launch; the eval
    step's global adapters run the fused LoRA forward on ssm_in and
    ssm_out.  Returns the launches."""
    arch = mamba2_arch(M_BATCH)
    layers = arch.model.num_layers
    _, got, per_round, _ = run_rounds(torch, arch, dev, wrappers, "phase 7",
                                      name, card, host_profile=True)
    check_launches(per_round, lambda p: {"ssd_scan": layers},
                   {"ssd_scan": layers, "lora_matmul_fwd": 2 * layers},
                   "mamba2-780m training")
    return got


def mamba2_batch4_phase(torch, dev, wrappers, name, card):
    """Phase 7b: ROUNDS rounds of full-width, full-depth mamba2-780m at the
    paper's batch M4_BATCH (5 clients x 4 x seq 512) under remat "full",
    through SplitFTSystem.run.  A train step launches each layer's SSD
    kernel twice (the forward and its recompute in the backward; the
    backward itself recomputes the plain scan); an eval step has no
    recompute.  Then one train step at remat "dots" from the last round's
    inputs, whose per-client losses must equal the "full" step's within
    STEP_TOL.  Both peaks of device memory must stay below
    PEAK_SHARE of the card.  Returns the launches of the rounds."""
    from repro_torch.core import rounds

    arch = mamba2_arch(M4_BATCH, remat="full")
    layers = arch.model.num_layers
    system, got, per_round, _ = run_rounds(torch, arch, dev, wrappers,
                                           "phase 7b", name, card)
    peak_full = torch.cuda.max_memory_allocated()
    check_launches(per_round, lambda p: {"ssd_scan": 2 * layers},
                   {"ssd_scan": layers, "lora_matmul_fwd": 2 * layers},
                   "mamba2-780m training at batch 4 under remat full")
    dots = rounds.make_train_step(
        system.model, remat="dots", smashed_compress=system.smashed_compress,
        smashed_topk_frac=system.smashed_topk_frac)
    args = system.train_step.last
    ce_full = system.history[-1]["ce"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, met = dots(*args)
    torch.cuda.synchronize()
    t_dots = time.perf_counter() - t0
    peak_dots = torch.cuda.max_memory_allocated()
    ce_dots = met["ce"].cpu().numpy()
    torch.testing.assert_close(
        torch.as_tensor(ce_dots), torch.as_tensor(ce_full), rtol=STEP_TOL,
        atol=0, msg=lambda m: f"phase 7b dots vs full losses: {m}")
    total = torch.cuda.get_device_properties(0).total_memory
    for what, peak in (("full", peak_full), ("dots", peak_dots)):
        if peak > PEAK_SHARE * total:
            raise RuntimeError(f"phase 7b: remat {what} peaks at "
                               f"{peak / 2**30:.2f} GiB, over {PEAK_SHARE} "
                               f"of the card's {total / 2**30:.2f} GiB")
    log(f"phase 7b [{name}, {card}]: max_memory_allocated over the rounds "
        f"(remat full) {peak_full / 2**30:.2f} GiB; one train step at "
        f"remat dots {t_dots * 1e3:.1f} ms, max_memory_allocated "
        f"{peak_dots / 2**30:.2f} GiB, of the card's {total / 2**30:.2f} "
        f"GiB; dots losses {fmt(ce_dots)} vs full {fmt(ce_full)} (bitwise: "
        f"{np.array_equal(ce_dots, ce_full)})")
    return got


# phases 6 and 8: (label, smashed compressor or "policy", round_grads
# options); microbatch 2 runs on a batch of 2
GPT2_STEPS = [("none", "none", {}), ("int8", "int8", {}),
              ("int8, remat full", "int8", dict(remat="full")),
              ("int8, remat dots", "int8", dict(remat="dots")),
              ("none, ce_chunk 32", "none", dict(ce_chunk=32)),
              ("none, microbatch 2", "none", dict(microbatch=2)),
              ("per-client policy", "policy", {})]
MAMBA2_STEPS = [("none", "none", {}),
                ("none, remat full", "none", dict(remat="full"))]
LLAMA_STEPS = [("none", "none", {}), ("int8", "int8", {})]


def small_arch(arch_name, model_kw=None):
    """`arch_name` at full width and SMALL_LAYERS layers, cut 1 (more
    model fields from model_kw)."""
    import dataclasses

    from repro_torch.configs import get_config

    arch = get_config(arch_name)
    return arch.replace(
        model=dataclasses.replace(arch.model, num_layers=SMALL_LAYERS,
                                  **(model_kw or {})),
        split=dataclasses.replace(arch.split, cut_layer=1, cut_buckets=(1,)))


def small_step_check(torch, dev, arch_name, seq, steps, tag,
                     compressed="elementwise", model_kw=None, wide=False,
                     wrappers=None):
    """Phases 6, 8, 9 and 10b: one round's losses and adapter gradients
    at full width and reduced depth (2 layers, 2 clients with cuts [1, 2], batch
    SMALL_BATCH, 2 under microbatch 2, seq `seq`), on the card and on the
    CPU plain path from one state, for each of `steps`: a smashed
    compressor, with the memory knobs (remat, ce_chunk, microbatch), or
    the co-controller's per-client policy (SMALL_POLICY: rank at the cut,
    compressor bucket and topk keep fraction per client).  Every gradient
    must be finite.  For mamba2 at seq 512 the SSD chunk is 256 and a
    chunk's decay passes exp(88), where the reference's chunked backward
    is not finite.  Tolerances: STEP_TOL on the losses; for the
    gradients GRAD_TOL[compressor] (relative, share of max|g|; the policy
    takes topk's, its loosest): fp32 sums in another order without
    compression; with int8 one quantum more, because a cotangent element
    within fp32 noise of an int8 rounding boundary takes the neighbouring
    code on one side; with topk a whole element, because a magnitude
    within fp32 noise of the k-th largest is kept on one side only.  The
    int8 and the policy's tolerances must stay below the CPU's own gap to
    the uncompressed step, so that a card step that skipped the
    compression would fail them.  compressed="mean" (phases 9 and 10b, at
    widths of 3072 to 12288, where one flipped int8 code moved a llama3-8b
    gradient element by 2.8e-3 of max|g|, past int8's share) holds a
    compressed step's gradients on average instead, as phase 6's engine
    steps do: the mean card-vs-CPU distance below COMPRESSION_SEEN x the
    CPU's mean gap to the uncompressed step; the losses stay at STEP_TOL.
    A remat step is also compared with the card's own step without remat,
    and whether they are bitwise is logged.  model_kw: more fields of the
    reduced model config (a hybrid's attention layer indices, an MoE
    model's expert count).  wide=True (phase 13b: models of 15 to 25 GB)
    draws the weights on the card and copies them to the CPU (a CPU draw
    takes minutes) and logs the host's free memory before each step.  An
    MoE model's CPU step routes by the card's top-k choices
    (recorded_routing's replay), since a choice flipped on a near-tie of
    the router's probabilities would move its token's expert output
    wholesale; the number of (token, choice) pairs that the CPU would
    have chosen otherwise is logged, and the step is held as any other.
    The vlm family's batch carries the prefix that Model.input_specs
    gives a train batch (normal x 0.02, as the reference's tests draw
    it), and the loss mask drops the labels inside it.
    wrappers: returns the kernel launches of the card's steps."""
    from repro_torch.core import rounds, smashed
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves, tree_map

    arch = small_arch(arch_name, model_kw)
    rng = np.random.default_rng(SEED + 5)
    toks = rng.integers(3, arch.model.vocab_size,
                        size=(SMALL_CLIENTS, 2, seq + 1))
    specs = build_model(arch, device="cpu").input_specs(
        "train", seq, SMALL_CLIENTS * 2, num_clients=SMALL_CLIENTS)
    if "prefix" in specs:
        shape, _ = specs["prefix"]
        prefix = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    weights = np.array([0.25, 0.75], np.float32)
    buckets = CO_SYS["compressor_buckets"]
    out = {}
    # one draw of the weights (on the CPU, as init_params draws them, or
    # for a wide model on the card), copied to the other side
    if wide:
        cpu_params = tree_map(
            lambda t: t.cpu(), build_model(arch, device=dev).init_params(
                torch.Generator(device=dev).manual_seed(SEED)))
        torch.cuda.empty_cache()
    else:
        cpu_params = build_model(arch, device="cpu").init_params(
            torch.Generator().manual_seed(SEED))
    moe = arch.model.family == "moe"
    routes = {}
    launches = {}
    for role, dv in (("card", dev), ("cpu", torch.device("cpu"))):
        model = build_model(arch, device=dv)
        params = tree_map(lambda t: t.to(dv), cpu_params)
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
        if wrappers and role == "card":
            for w in wrappers.values():
                w.launches = 0
        for label, comp, kw in steps:
            b = 2 if kw.get("microbatch", 1) > 1 else SMALL_BATCH
            batch = {"tokens": toks[:, :b, :-1].astype(np.int32),
                     "labels": toks[:, :b, 1:].astype(np.int32)}
            if "prefix" in specs:
                batch["prefix"] = prefix[:, :b]
                batch["loss_mask"] = np.broadcast_to(
                    np.arange(seq) >= prefix.shape[-2] - 1,
                    batch["labels"].shape).astype(np.float32)
            if wide:
                log(f"{tag} ({label}, {role}): host memory available "
                    f"{host_available_gib():.1f} GiB")
            st = state
            if comp == "policy":
                st = dict(
                    state,
                    rank_cut=torch.tensor(SMALL_POLICY["rank_cut"],
                                          dtype=torch.int32),
                    smashed_choice=torch.tensor(
                        [buckets.index(c) for c in SMALL_POLICY["choice"]],
                        dtype=torch.int32),
                    topk_frac=torch.tensor(SMALL_POLICY["topk_frac"]))
                boundary = smashed.make_multi_boundary(
                    tuple(smashed.make_compressor(c) for c in buckets),
                    st["cuts"], st["smashed_choice"],
                    topk_frac=st["topk_frac"])
            else:
                boundary = smashed.make_boundary(
                    smashed.make_compressor(comp), state["cuts"])
            replay = routes["card", label] if role == "cpu" else None
            with recorded_routing(moe, replay=replay) as chosen:
                _, met, gc, gs = rounds.round_grads(
                    model, params, st, batch, weights, boundary=boundary,
                    **kw)
            routes[role, label] = chosen
            out[role, label] = (met["ce"].cpu(), [
                g.cpu() for g in tree_leaves(gc) + tree_leaves(gs)])
        if wrappers and role == "card":
            torch.cuda.synchronize()
            launches = {k: w.launches for k, w in wrappers.items()}
        del model, params, state
        if role == "card":
            torch.cuda.empty_cache()
    for label, comp, kw in steps:
        elementwise = comp == "none" or compressed == "elementwise"
        if elementwise:
            rtol, share = GRAD_TOL["topk" if comp == "policy" else comp]
        (ce_k, g_k), (ce_c, g_c) = out["card", label], out["cpu", label]
        if not all(torch.isfinite(g).all() for g in g_k + g_c):
            raise RuntimeError(f"{tag} ({label}): non-finite adapter "
                               f"gradient")
        if moe:
            flips = routing_flips(torch, routes["card", label],
                                  routes["cpu", label])
            n_pairs = sum(t.numel() for t, _ in routes["cpu", label])
            log(f"{tag} ({label}): top-k choices of {len(routes['cpu', label])}"
                f" MoE layer calls, card vs CPU's own: {flips} of {n_pairs} "
                f"(token, choice) pairs flipped; the CPU routes by the "
                f"card's")
        pairs = [("CPU", ce_c, g_c)]
        if "remat" in kw:
            pairs.append(("card without remat", *out["card", comp]))
        scale = max(float(g.abs().max()) for g in g_c)
        worst = 0.0
        for what, ce_w, g_w in pairs:
            torch.testing.assert_close(
                ce_k, ce_w, rtol=STEP_TOL, atol=0,
                msg=lambda m: f"{tag} ({label}) card vs {what} losses: {m}")
            for gk, gw in zip(g_k, g_w) if elementwise else ():
                torch.testing.assert_close(
                    gk, gw, rtol=rtol, atol=share * scale,
                    msg=lambda m: f"{tag} ({label}) card vs {what} adapter "
                                  f"gradient: {m}")
            if what == "CPU":
                worst = max(float((a - b).abs().max())
                            for a, b in zip(g_k, g_w))
        if comp != "none" and not elementwise:
            def mean_dist(u, v):
                return (sum(float((a - b).abs().sum()) for a, b in zip(u, v))
                        / sum(a.numel() for a in u))
            ratio = (mean_dist(g_k, g_c)
                     / mean_dist(g_c, out["cpu", "none"][1]))
            if not ratio < COMPRESSION_SEEN:
                raise RuntimeError(
                    f"{tag} ({label}): the card's mean |g - CPU| is {ratio:.3f}"
                    f" x the CPU's mean gap to the step without compression, "
                    f"not below {COMPRESSION_SEEN}")
            log(f"{tag} ({label}): the card's mean gradient distance to the "
                f"CPU is {ratio:.2e} x the CPU's mean gap to the step without "
                f"compression (held below {COMPRESSION_SEEN}; elementwise "
                f"max |diff| {worst / scale:.2e} of max|g|, not held)")
        elif comp != "none" and not kw:
            gap = max(float((a - b).abs().max())
                      for a, b in zip(g_c, out["cpu", "none"][1])) / scale
            if gap <= share:
                raise RuntimeError(
                    f"{label} moves the CPU's adapter gradients by only "
                    f"{gap:.2e} of max|g|, within the card-vs-CPU tolerance "
                    f"{share}: the check cannot see the compression")
            log(f"{tag} ({label}): the CPU's gradient gap to the step "
                f"without compression is {gap:.2e} of max|g|, above the "
                f"tolerance {share}")
        bits = ""
        if "remat" in kw:
            ce_n, g_n = out["card", comp]
            same = torch.equal(ce_k, ce_n) and all(
                torch.equal(a, b) for a, b in zip(g_k, g_n))
            bits = f"; against the card's step without remat: bitwise {same}"
        log(f"{tag} ({label}): {arch_name} full-width {SMALL_LAYERS}-layer "
            f"step, {SMALL_CLIENTS} clients (cuts [1, 2]), batch "
            f"{2 if kw.get('microbatch', 1) > 1 else SMALL_BATCH} x seq "
            f"{seq}: card vs CPU losses {fmt(ce_k)} vs {fmt(ce_c)} (rtol "
            f"{STEP_TOL}); {len(g_k)} adapter gradients, max |diff| "
            f"{worst:.3e} = {worst / scale:.2e} of max|g| ("
            + (f"tol {rtol} relative + {share} of max|g|" if elementwise
               else "held on average") + f"){bits}")
    return cpu_params, launches


def add_launches(launches, got, *, hd):
    """Adds a path's launches to the result line's counts; at head dim
    128 or 112 the flash and decode kernels' launches go to their rows at
    that head dim."""
    for kname, c in got.items():
        launches[hd_row(kname, hd) if hd in WIDE_HDS and kname in WIDE_HD
                 else kname] += c


def check_wide_kernels(torch, rand, dname, dt, dev, gen, errs, *, hd, heads,
                       edge_heads, train_b, what, more=()):
    """Phase 2 at head dim `hd` (128: llama3-8b's 32 heads over 8; 112:
    kimi-k2's 64 over 8): the flash forward and backward at FLASH_EDGES'
    lengths, windows and offsets (B 2, H and KVH `edge_heads`), at the
    model's train step (B `train_b`, S 512) and at its serving prefill (B
    1, S PROMPT) with `heads`, and at the (B, S, H, KVH) of `more` (other
    models' train steps at this head dim); the decode kernels at its tick
    (SLOTS slots, cache lengths 128..156, windows 0 and 100), contiguous
    and paged.  Each against its plain version; paged decode equal to
    contiguous bit for bit.  Fills errs' rows at that head dim."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops

    h, kvh = heads
    cases = [(2, sq, sk, *edge_heads, window, q_offset)
             for sq, sk, _, window, q_offset in FLASH_EDGES]
    cases += [(train_b, 512, 512, h, kvh, 0, 0),
              (1, PROMPT, PROMPT, h, kvh, 0, 0)]
    cases += [(b, s, s, hq, hk, 0, 0) for b, s, hq, hk in more]
    fwd = hd_row("flash_attention_fwd", hd)
    bwd = hd_row("flash_attention_bwd", hd)
    for b, sq, sk, hq, hk, window, q_offset in cases:
        q, do = rand(b, sq, hq, hd, dtype=dt), rand(b, sq, hq, hd, dtype=dt)
        k, v = rand(b, sk, hk, hd, dtype=dt), rand(b, sk, hk, hd, dtype=dt)
        kw = dict(window=window, q_offset=q_offset)
        desc = (f"hd {hd} B={b} Sq={sq} Sk={sk} H={hq} KVH={hk} "
                f"window={window} q_offset={q_offset}")
        out, lse = fops.flash_attention_fwd(q, k, v, **kw)
        r_out, r_lse = fops.ref.attention_fwd(q, k, v, **kw)
        errs[fwd] = max(errs[fwd],
                        max_err(torch, out, r_out, dname, f"flash {desc}"),
                        max_err(torch, lse, r_lse, dname,
                                f"flash lse {desc}"))
        got = fops.flash_attention_bwd(q, k, v, r_out, r_lse, do, **kw)
        want = fops.ref.attention_bwd(q, k, v, r_out, r_lse, do, **kw)
        errs[bwd] = max([errs[bwd]] + [
            max_err(torch, g, w, dname, f"flash bwd {desc} d{n}")
            for n, g, w in zip("qkv", got, want)])
    lens = [128 + 4 * i for i in range(SLOTS)]
    for window in (0, 100):
        q, k, v, clen = decode_args(torch, rand, dt, dev, s=MAX_LEN, lens=lens,
                                    heads=heads, hd=hd)
        kp, vp, pt = paged_args(torch, k, v, gen, dev, ps=PAGE)
        desc = f"hd {hd} B={SLOTS} H={h} KVH={kvh} window={window}"
        got = dops.decode_attention(q, k, v, clen, window=window)
        paged = dops.decode_attention_paged(q, kp, vp, pt, clen,
                                            window=window)
        for kname, g, w in (
                ("decode_attention", got, dops.ref.decode_attention(
                    q, k, v, clen, window=window)),
                ("decode_attention_paged", paged,
                 dops.ref.decode_attention_paged(q, kp, vp, pt, clen,
                                                 window=window))):
            errs[hd_row(kname, hd)] = max(errs[hd_row(kname, hd)], max_err(
                torch, g, w, dname, f"{kname} {desc}"))
        if not torch.equal(paged, got):
            raise RuntimeError(f"paged decode differs from contiguous "
                               f"decode ({desc}, {dname})")
    log(f"phase 2 ({dname}): hd {hd} flash forward and backward at "
        f"{len(cases)} shapes and decode at the {what} tick: max "
        f"|kernel - plain| " + ", ".join(
            f"{k} {errs[hd_row(k, hd)]:.3e}" for k in WIDE_HD))


def check_dense_widths(torch, rand, dname, dt, gen, errs, *, kd, ns, m_eval,
                       what):
    """Phase 2 at a wide model's widths (llama3-8b: K = 4096 into N = 4096
    for q, o and 1024 for k, v; kimi-k2: K = 7168 into 7168 and 896): the
    indexed LoRA at its tick and prefill (M = SLOTS and PROMPT) and the
    fused LoRA forward at its eval step (M = m_eval: 5 clients x batch x
    512), each against its plain version at r 16; the int8 quantizers at d
    = K (G 5, M = m_eval / 5) bit for bit.  At K = 4096 the indexed LoRA
    adds 64 K slices in order (12 at gpt2's 768); at d = 4096 the int8
    kernels run 64 clusters a message."""
    from repro_torch.kernels.lora_matmul import ops as lops
    from repro_torch.kernels.smashed_quant import ops as sops

    r, p = 16, len(RANKS)
    mask = (torch.arange(r)[None, :] < torch.tensor(RANKS)[:, None]).float()
    for n in ns:
        w = rand(kd, n, dtype=dt, scale=kd ** -0.5)
        dev = w.device
        a = (rand(p, kd, r, scale=r ** -0.5) * mask.to(dev)[:, None, :]
             ).to(dt)
        b = (rand(p, r, n, scale=0.02) * mask.to(dev)[:, :, None]).to(dt)
        scale = (16.0 / torch.tensor(RANKS, dtype=torch.float32)).to(dev)
        for m in (SLOTS, PROMPT):
            x = rand(m, kd, dtype=dt)
            ids = torch.randint(0, p, (m,), generator=gen,
                                dtype=torch.int32).to(dev)
            errs["lora_matmul_indexed"] = max(
                errs["lora_matmul_indexed"],
                max_err(torch, lops.lora_matmul_indexed(x, w, a, b, scale,
                                                        ids),
                        lops.ref.lora_matmul_indexed(x, w, a, b, scale, ids),
                        dname, f"indexed LoRA M={m} K={kd} N={n}"))
        x = rand(m_eval, kd, dtype=dt)
        sc = torch.tensor(2.0, device=dev)
        got = lops.lora_matmul_fwd(x, w, a[0], b[0], sc)
        want = lops.ref.lora_matmul_fwd(x, w, a[0], b[0], sc)
        errs["lora_matmul_fwd"] = max(
            [errs["lora_matmul_fwd"]]
            + [max_err(torch, g, wt, dname, f"fused LoRA {part} M={m_eval} "
                       f"K={kd} N={n}", scaled=True)
               for part, g, wt in zip(("y", "xa"), got, want)])
    xs = rand(5, m_eval // 2560, 512, kd, dtype=dt)
    x3 = xs.reshape(5, -1, kd)
    q8, s8 = sops.int8_quantize_smashed(xs)
    want_q, want_s = sops.ref.quantize(x3)
    for kname, got, want in (
            ("int8_quantize_smashed", q8.reshape(x3.shape), want_q),
            ("int8_quantize_smashed", s8, want_s),
            ("int8_dequantize_smashed",
             sops.int8_dequantize_smashed(q8, s8, dt).reshape(x3.shape),
             sops.ref.dequantize(want_q, want_s, dt)),
            ("int8_roundtrip_smashed",
             sops.int8_roundtrip_smashed(xs).reshape(x3.shape),
             sops.ref.roundtrip(x3))):
        if not torch.equal(got, want):
            raise RuntimeError(f"{kname} at d={kd} ({dname}) is not "
                               f"bit-equal to its plain version")
    log(f"phase 2 ({dname}): at {what}'s widths (K = {kd}, N = "
        f"{' and '.join(map(str, ns))}) the indexed LoRA (M = {SLOTS}, "
        f"{PROMPT}) and the fused LoRA forward (M = {m_eval}) agree with "
        f"their plain versions, the int8 kernels (d = {kd}) bit for bit")


def time_wide_kernels(torch, F, rand, dev, gen, errs, *, hd, heads, train_b,
                      what):
    """Phase 3 at head dim `hd` (fp32), at a wide model's shapes (128:
    llama3-8b's 32 heads over 8, 5 clients x batch 4; 112: kimi-k2's 64
    over 8, 5 clients x batch 1): the flash forward and backward at its
    train step (B `train_b`, S 512, causal), the forward at its serving
    prefill (B 1, S PROMPT), and the decode kernels at its tick (SLOTS
    slots, cache lengths 128..156), contiguous and paged.  Each timed
    call's result is first held against its plain version (errs takes
    the larger error).  The library call is SDPA with enable_gqa (the
    backward through autograd)."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops

    h, kvh = heads
    fwd = hd_row("flash_attention_fwd", hd)
    bwd = hd_row("flash_attention_bwd", hd)
    rows = {}
    for key, b, s, step in ((fwd, train_b, 512, f"the {what} train step"),
                            (f"flash_attention_fwd (hd {hd}, prefill)", 1,
                             PROMPT, f"the {what} serving prefill")):
        q, k, v = rand(b, s, h, hd), rand(b, s, kvh, hd), rand(b, s, kvh, hd)
        out, lse = fops.flash_attention_fwd(q, k, v)
        r_out, r_lse = fops.ref.attention_fwd(q, k, v)
        errs[fwd] = max(errs[fwd],
                        max_err(torch, out, r_out, "float32", f"{key} out"),
                        max_err(torch, lse, r_lse, "float32", f"{key} lse"))
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        pairs = b * h * s * (s + 1) // 2
        shape = (f"B={b} S={s} H={h} KVH={kvh} hd={hd} causal fp32 "
                 f"({step})")
        with torch.no_grad():
            rows[key] = dict(
                ms=cuda_ms(torch, lambda: fops.flash_attention_fwd(q, k, v),
                           iters=20),
                plain_ms=cuda_ms(torch, lambda: fops.ref.attention_fwd(
                    q, k, v), iters=10),
                library_ms=cuda_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True),
                    iters=20),
                # read q, k, v; write out, lse.  Per visible pair: s, p v
                **work(4 * (2 * b * s * (h + kvh) * hd + b * h * s),
                       4 * hd * pairs, products=True),
                shape=shape)
        if key != fwd:
            continue
        do = rand(b, s, h, hd)
        errs[bwd] = max([errs[bwd]] + [
            max_err(torch, g, w, "float32", f"{bwd} d{n}")
            for n, g, w in zip("qkv", fops.flash_attention_bwd(
                q, k, v, out, lse, do), fops.ref.attention_bwd(
                q, k, v, out, lse, do))])
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)
        do_t = do.transpose(1, 2).contiguous()
        rows[bwd] = dict(
            ms=cuda_ms(torch, lambda: fops.flash_attention_bwd(
                q, k, v, out, lse, do), iters=20),
            plain_ms=cuda_ms(torch, lambda: fops.ref.attention_bwd(
                q, k, v, out, lse, do), iters=10),
            library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                o_lib, (qt, kt, vt), do_t, retain_graph=True), iters=20),
            # read q, k, v, out, do, lse; write dq, dk, dv.  Per visible
            # pair: s, dp, dq, dk, dv, 2 hd FLOPs each
            **work(4 * (4 * b * s * (h + kvh) * hd + b * h * s),
                   10 * hd * pairs, products=True),
            shape=shape + "; library = SDPA backward through autograd")
        del o_lib, qt, kt, vt
    lens = [128 + 4 * i for i in range(SLOTS)]
    q1, kc, vc, clen = decode_args(torch, rand, torch.float32, dev,
                                   s=MAX_LEN, lens=lens, heads=heads, hd=hd)
    kp, vp, pt = paged_args(torch, kc, vc, gen, dev, ps=PAGE)
    for kname, fn, plain in (
            ("decode_attention",
             lambda: dops.decode_attention(q1, kc, vc, clen),
             lambda: dops.ref.decode_attention(q1, kc, vc, clen)),
            ("decode_attention_paged",
             lambda: dops.decode_attention_paged(q1, kp, vp, pt, clen),
             lambda: dops.ref.decode_attention_paged(q1, kp, vp, pt, clen))):
        errs[hd_row(kname, hd)] = max(errs[hd_row(kname, hd)], max_err(
            torch, fn(), plain(), "float32", f"{kname} hd {hd}"))
    tot = sum(lens)
    dec_bytes = 4 * (2 * SLOTS * h * hd + 2 * tot * kvh * hd + SLOTS)
    dec_flops = 4 * tot * h * hd
    mask = (torch.arange(MAX_LEN, device=dev)[None, :]
            < clen[:, None])[:, None, None, :]
    qs = q1[:, :, None, :]
    ks, vs = (t.transpose(1, 2).contiguous() for t in (kc, vc))
    shape = (f"B={SLOTS} S={MAX_LEN} H={h} KVH={kvh} hd={hd} cache_len "
             f"{lens[0]}..{lens[-1]} fp32 (the {what} decode tick)")
    rows[hd_row("decode_attention", hd)] = dict(
        ms=cuda_ms(torch, lambda: dops.decode_attention(q1, kc, vc, clen)),
        plain_ms=cuda_ms(torch, lambda: dops.ref.decode_attention(
            q1, kc, vc, clen)),
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)),
        passes=pass_ms(torch, lambda: dops.decode_attention(q1, kc, vc, clen),
                       ("decode_kernel",), launches=True),
        **work(dec_bytes, dec_flops), shape=shape)
    rows[hd_row("decode_attention_paged", hd)] = dict(
        ms=cuda_ms(torch, lambda: dops.decode_attention_paged(
            q1, kp, vp, pt, clen)),
        plain_ms=cuda_ms(torch, lambda: dops.ref.decode_attention_paged(
            q1, kp, vp, pt, clen)),
        library_ms=None,
        passes=pass_ms(torch, lambda: dops.decode_attention_paged(
            q1, kp, vp, pt, clen), ("decode_kernel",), launches=True),
        **work(dec_bytes + 4 * pt.numel(), dec_flops),
        shape=shape.replace("S=", f"ps={PAGE} S="))
    return rows


def llama_arch():
    """llama3-8b at full width, LLAMA_LAYERS deep, cut LLAMA_CUT over the
    buckets LLAMA_BUCKETS; the config's paper setting otherwise."""
    import dataclasses

    from repro_torch.configs import get_config

    arch = get_config("llama3-8b")
    return arch.replace(
        model=dataclasses.replace(arch.model, num_layers=LLAMA_LAYERS),
        split=dataclasses.replace(arch.split, cut_layer=LLAMA_CUT,
                                  cut_buckets=LLAMA_BUCKETS))


def llama_phase(torch, dev, wrappers, name, card):
    """Phase 9: ROUNDS SplitFT rounds on llama_arch() through
    SplitFTSystem.run, the cross entropy in chunks of LLAMA_CE_CHUNK
    positions in its train and eval steps.  A train step launches the
    flash forward and backward once per layer and the int8 round trip
    twice per distinct cut; an eval step the flash forward per layer and
    the fused LoRA forward per layer and target.  The peak of device
    memory must stay below PEAK_SHARE of the card.  Returns the system
    (for phase 9b) and the launches of the rounds."""
    arch = llama_arch()
    m = arch.model
    layers, targets = m.num_layers, len(arch.lora.targets)
    log(f"phase 9: {arch.name} reduced to {layers} of 32 layers, cut "
        f"{LLAMA_CUT} over buckets {LLAMA_BUCKETS}, ce_chunk "
        f"{LLAMA_CE_CHUNK}; full width: d_model {m.d_model}, {m.num_heads} "
        f"heads over {m.num_kv_heads} of {m.head_dim}, d_ff {m.d_ff}, vocab "
        f"{m.vocab_size}, untied head, RoPE theta {m.rope_theta:g}")
    system, got, per_round, times = run_rounds(
        torch, arch, dev, wrappers, "phase 9", name, card,
        ce_chunk=LLAMA_CE_CHUNK)
    peak = torch.cuda.max_memory_allocated()
    check_launches(
        per_round,
        lambda p: {"flash_attention_fwd": layers,
                   "flash_attention_bwd": layers,
                   "int8_roundtrip_smashed": 2 * len(set(p["cuts"]))},
        {"flash_attention_fwd": layers, "lora_matmul_fwd": targets * layers},
        "llama3-8b training")
    total = torch.cuda.get_device_properties(0).total_memory
    if peak > PEAK_SHARE * total:
        raise RuntimeError(f"phase 9: peaks at {peak / 2**30:.2f} GiB, over "
                           f"{PEAK_SHARE} of the card's "
                           f"{total / 2**30:.2f} GiB")
    nonzero = lambda d: {k: c for k, c in d.items() if c}  # noqa: E731
    log(f"phase 9 [{name}, {card}]: train step "
        f"{fmt([t * 1e3 for _, t, _, _ in times])} ms, eval step "
        f"{fmt([e * 1e3 for _, _, e, _ in times])} ms, host share per round "
        f"{fmt([hst / w for w, _, _, hst in times])}; launches per train "
        f"step {nonzero(per_round[-1][1])}, per eval step "
        f"{nonzero(per_round[-1][2])}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB of the card's {total / 2**30:.2f} GiB")
    return system, got


def serve_both(torch, dev, wrappers, model, params, pool, *, requests,
               prompt, gen, max_len, tag, name, card):
    """`requests` requests of `prompt` tokens and `gen` new ones, over the
    pool's adapters in turn, through ServingEngine (SLOTS slots)
    contiguous and paged (PAGE-token pages), each after a warm-up request:
    each run must launch the flash forward, the indexed LoRA and its
    decode kernel; paged tokens must equal contiguous, and contiguous
    serial_reference.  Logs tokens/s and TTFT p50, and the contiguous
    run's device-busy share under the profiler.  Returns the launches of
    both runs."""
    from repro_torch.runtime import serving

    n = serving.num_pool_adapters(pool)
    rng = np.random.default_rng(SEED + 2)
    reqs = [serving.Request(rid=i, adapter=i % n,
                            tokens=rng.integers(3, model.cfg.vocab_size,
                                                size=prompt),
                            max_new=gen) for i in range(requests)]
    warm = [serving.Request(rid=1000, adapter=0, tokens=reqs[0].tokens,
                            max_new=2)]
    total = {k: 0 for k in wrappers}
    tokens = {}
    for page in (0, PAGE):
        mode = "paged" if page else "contiguous"
        engine = serving.ServingEngine(
            model, params, pool,
            serving.ServeConfig(num_slots=SLOTS, max_len=max_len,
                                page_size=page), device=dev)
        engine.run(warm)
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        res = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: w.launches for k, w in wrappers.items()}
        for k, c in counts.items():
            total[k] += c
        decode = "decode_attention_paged" if page else "decode_attention"
        idle = [k for k in ("flash_attention_fwd", "lora_matmul_indexed",
                            decode) if not counts[k]]
        if idle:
            raise RuntimeError(f"{tag} {mode} serving never launched {idle}")
        tokens[mode] = [r["tokens"] for r in res]
        n_tok = sum(len(t) for t in tokens[mode])
        ttft = np.percentile([r["t_first"] - r["t_submit"] for r in res], 50)
        log(f"{tag} {mode} [{name}, {card}]: {model.arch.name} "
            f"{model.num_flat_layers} layers, {requests} requests x {gen} "
            f"tokens (prompt {prompt}, {SLOTS} slots, max_len {max_len}) in "
            f"{wall:.3f} s: {n_tok / wall:.1f} tokens/s, TTFT p50 "
            f"{ttft * 1e3:.1f} ms; launches "
            f"{ {k: c for k, c in counts.items() if c} }")
        if not page:
            profile_run(torch, serving, engine, reqs, name, card, tag=tag)
        del engine
    if tokens["paged"] != tokens["contiguous"]:
        raise RuntimeError(f"{tag}: paged tokens differ from contiguous")
    cut, _ = check_served_tokens(serving, model, params, pool, reqs,
                                 tokens["contiguous"], max_len, tag)
    log(f"{tag}: engine tokens equal serial_reference on {requests} "
        f"requests ({cut} compared only up to a top-2 logit gap < "
        f"{TOP2_GAP}); paged equal to contiguous")
    return total


def llama_serving_phase(torch, dev, wrappers, name, card, system):
    """Phase 9b: phase 9's llama3-8b (its base weights) serving
    N_REQUESTS requests of PROMPT tokens and GEN new ones over 4 adapters
    of ranks RANKS, contiguous and paged.  Returns the launches."""
    from repro_torch.runtime import serving

    pool = serving.build_adapter_pool(
        system.model, torch.Generator().manual_seed(SEED + 1), len(RANKS),
        ranks=RANKS)
    return serve_both(torch, dev, wrappers, system.model, system.base_params,
                      pool, requests=N_REQUESTS, prompt=PROMPT, gen=GEN,
                      max_len=MAX_LEN, tag="phase 9b", name=name, card=card)


def generalizability_phase(torch, dev, wrappers, name, card, arch_name):
    """Phase 10: GEN_ROUNDS SplitFT rounds on `arch_name` (opt-125m or
    gpt-neo-125m) at full size and the paper setting of its config (5
    clients, batch 4, seq 512, smashed "none") through SplitFTSystem.run:
    flash forward and backward per layer in a train step, the flash and
    fused LoRA forwards in an eval step.  Then TRAINED_REQUESTS requests of
    GEN_PROMPT tokens and GEN_NEW new ones on the system's base weights
    and 4 adapters (serve_both).  Returns the launches of both."""
    from repro_torch.configs import get_config
    from repro_torch.runtime import serving

    arch = get_config(arch_name)
    layers = arch.model.num_layers
    tag = f"phase 10 {arch_name}"
    system, got, per_round, _ = run_rounds(torch, arch, dev, wrappers, tag,
                                           name, card, rounds=GEN_ROUNDS)
    check_launches(
        per_round, lambda p: {"flash_attention_fwd": layers,
                              "flash_attention_bwd": layers},
        {"flash_attention_fwd": layers,
         "lora_matmul_fwd": len(arch.lora.targets) * layers},
        f"{arch_name} training")
    pool = serving.build_adapter_pool(
        system.model, torch.Generator().manual_seed(SEED + 1), len(RANKS),
        ranks=RANKS)
    served = serve_both(torch, dev, wrappers, system.model,
                        system.base_params, pool, requests=TRAINED_REQUESTS,
                        prompt=GEN_PROMPT, gen=GEN_NEW, max_len=GEN_MAX_LEN,
                        tag=f"{tag} serving", name=name, card=card)
    return {k: got[k] + served[k] for k in got}


def ssm_requests(serving, vocab: int, n_adapters: int):
    """Phases 11 and 12's requests: SSM_PROMPTS tokens, SSM_NEW new ones,
    over the pool's adapters in turn."""
    rng = np.random.default_rng(SEED + 11)
    return [serving.Request(rid=i, adapter=i % n_adapters,
                            tokens=rng.integers(3, vocab, size=plen),
                            max_new=SSM_NEW)
            for i, plen in enumerate(SSM_PROMPTS)]


def serve_serially(torch, dev, wrappers, model, params, pool, tag, name,
                   card, want_kernels):
    """SSM_PROMPTS' requests through serial_reference on the card, one at
    a time (prefill, then decode_step per token, through the indexed
    pool), with the launch counters set to 0 just before and read just
    after; every kernel of want_kernels must have launched.  Then each
    request's prefill-then-decode logits are held against the card's own
    train-mode forward over the same tokens (prompt and generated) at
    SSM_LOGITS_TOL, and the longest request is served once more, timed:
    prefill ms, and per decode step ms, hand-written kernel launches, and
    device kernels and busy share under the profiler.  Returns the
    launches of the serial run."""
    from repro_torch.runtime import serving

    reqs = ssm_requests(serving, model.cfg.vocab_size,
                        serving.num_pool_adapters(pool))
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens, logits = serving.serial_reference(
        model, params, pool, reqs, max_len=SSM_MAX_LEN, return_logits=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: w.launches for k, w in wrappers.items()}
    idle = [k for k in want_kernels if not got[k]]
    if idle:
        raise RuntimeError(f"{tag}: serving never launched {idle}")
    worst = 0.0
    with torch.no_grad():
        for r in reqs:
            if not torch.isfinite(logits[r.rid]).all():
                raise RuntimeError(f"{tag}: non-finite logits, request "
                                   f"{r.rid}")
            seq = np.concatenate([r.tokens, tokens[r.rid][:-1]])
            toks = torch.as_tensor(seq[None].astype(np.int32), device=dev)
            x = model.forward(params, serving.attach_ids(pool, [r.adapter]),
                              {"tokens": toks})[0]
            full = model.head(params, x[0, len(r.tokens) - 1:]).float().cpu()
            torch.testing.assert_close(
                logits[r.rid], full, rtol=SSM_LOGITS_TOL, atol=SSM_LOGITS_TOL,
                msg=lambda m: f"{tag}: request {r.rid} (prompt "
                              f"{len(r.tokens)}) prefill + decode vs the "
                              f"full forward: {m}")
            worst = max(worst, float((logits[r.rid] - full).abs().max()))
    n_tok = sum(len(t) for t in tokens.values())
    log(f"{tag} [{name}, {card}]: {model.arch.name} "
        f"{model.num_flat_layers} layers, {len(reqs)} requests (prompts "
        f"{list(SSM_PROMPTS)}) x {SSM_NEW} tokens through serial_reference "
        f"in {wall:.3f} s ({n_tok / wall:.1f} tokens/s); prefill + decode "
        f"logits vs the card's train-mode forward over the same tokens: "
        f"max |diff| {worst:.3e} (tol {SSM_LOGITS_TOL}); launches "
        f"{ {k: c for k, c in got.items() if c} }")

    # the longest request again, timed step by step
    req = reqs[0]
    ad = serving.attach_ids(pool, [req.adapter])
    toks = torch.as_tensor(np.asarray(req.tokens, np.int32)[None],
                           device=dev)
    step_ms, per_tok = [], []
    with torch.no_grad():
        cache = model.init_cache((1,), SSM_MAX_LEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = model.prefill(params, ad, {"tokens": toks}, cache)
        tok = int(torch.argmax(lg[0, -1]))
        prefill_ms = (time.perf_counter() - t0) * 1e3
        for _ in range(SSM_NEW - 1):
            before = {k: w.launches for k, w in wrappers.items()}
            t0 = time.perf_counter()
            lg, cache = model.decode_step(
                params, ad, torch.tensor([[tok]], dtype=torch.int32,
                                         device=dev), cache)
            tok = int(torch.argmax(lg[0, -1]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            per_tok.append({k: w.launches - before[k]
                            for k, w in wrappers.items()
                            if w.launches - before[k]})
        one = torch.tensor([[tok]], dtype=torch.int32, device=dev)
        dwall, busy, _, kernels = device_busy(
            torch, lambda: model.decode_step(params, ad, one, cache))
    busy_txt = ("device busy not measured (no profiler activity)"
                if busy is None else
                f"{sum(kernels.values())} device kernels, device busy "
                f"{busy * 1e3:.2f} ms of {dwall * 1e3:.2f} ms (idle share "
                f"{1 - busy / dwall:.3f})")
    log(f"{tag} timing [{name}, {card}]: prompt {len(req.tokens)}: "
        f"prefill (first token on the host) {prefill_ms:.2f} ms; decode "
        f"step ms p50 {np.percentile(step_ms, 50):.2f} (min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}) over "
        f"{len(step_ms)} steps; hand-written kernel launches per token "
        f"{per_tok[-1]}; one decode step under the profiler: {busy_txt}")
    return got


def ssm_card_vs_cpu(torch, dev, arch, pool_ranks, tag):
    """A 2-layer, full-width copy of `arch` served on the card and on the
    CPU plain path from one draw of weights and adapters: SSM_PROMPTS'
    requests with SSM_CPU_NEW new tokens each through serial_reference;
    logits at LOGITS_TOL and tokens equal up to a top-2 gap of TOP2_GAP."""
    from repro_torch.models.model import build_model
    from repro_torch.runtime import serving
    from repro_torch.tree import tree_map

    cpu_model = build_model(arch, device="cpu")
    cpu_params = cpu_model.init_params(torch.Generator().manual_seed(SEED))
    cpu_pool = serving.build_adapter_pool(
        cpu_model, torch.Generator().manual_seed(SEED + 1), len(pool_ranks),
        ranks=pool_ranks)
    model = build_model(arch, device=dev)
    params = tree_map(lambda t: t.to(dev), cpu_params)
    pool = tree_map(lambda t: t.to(dev), cpu_pool)
    reqs = [serving.Request(rid=r.rid, adapter=r.adapter, tokens=r.tokens,
                            max_new=SSM_CPU_NEW)
            for r in ssm_requests(serving, arch.model.vocab_size,
                                  len(pool_ranks))]
    out = {}
    for role, mdl, prm, pl in (("card", model, params, pool),
                               ("cpu", cpu_model, cpu_params, cpu_pool)):
        out[role] = serving.serial_reference(
            mdl, prm, pl, reqs, max_len=SSM_MAX_LEN, return_logits=True)
    (tok_k, log_k), (tok_c, log_c) = out["card"], out["cpu"]
    worst, cut = 0.0, 0
    for r in reqs:
        torch.testing.assert_close(
            log_k[r.rid], log_c[r.rid], rtol=LOGITS_TOL, atol=LOGITS_TOL,
            msg=lambda m: f"{tag}: card vs CPU logits, request {r.rid}: {m}")
        worst = max(worst, float((log_k[r.rid] - log_c[r.rid]).abs().max()))
        upto = decided_steps(torch, log_c[r.rid])
        cut += upto < r.max_new
        if tok_k[r.rid][:upto] != tok_c[r.rid][:upto]:
            raise RuntimeError(f"{tag}: request {r.rid}: card tokens "
                               f"{tok_k[r.rid]} != CPU {tok_c[r.rid]}")
    log(f"{tag}: {arch.name} full width, {arch.model.num_layers} layers, "
        f"{len(reqs)} requests (prompts {list(SSM_PROMPTS)}) x "
        f"{SSM_CPU_NEW} tokens on the card and the CPU: logits max |diff| "
        f"{worst:.3e} (tol {LOGITS_TOL}); tokens equal ({cut} compared up "
        f"to a top-2 gap < {TOP2_GAP})")


def mamba2_serving_phase(torch, dev, wrappers, name, card):
    """Phase 11: full-width, full-depth mamba2-780m (48 SSD layers)
    serving SSM_PROMPTS' requests from 2 adapters (ranks SSM_RANKS) one at
    a time: every prefill runs each layer's SSD kernel with the final
    state and the indexed LoRA at ssm_in and ssm_out; every decode step
    the conv window and the one-token recurrence (plain, as in the
    reference) between indexed LoRA calls (serve_serially).  Then the
    2-layer card-vs-CPU check.  Returns the launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.runtime import serving

    arch = get_config("mamba2-780m")
    model = build_model(arch, device=dev)
    params = model.init_params(torch.Generator().manual_seed(SEED))
    pool = serving.build_adapter_pool(
        model, torch.Generator().manual_seed(SEED + 1), len(SSM_RANKS),
        ranks=SSM_RANKS)
    got = serve_serially(torch, dev, wrappers, model, params, pool,
                         "phase 11", name, card,
                         ("ssd_scan (final state)", "lora_matmul_indexed"))
    layers = arch.model.num_layers
    want = {"ssd_scan (final state)": layers * len(SSM_PROMPTS),
            "lora_matmul_indexed": 2 * layers * len(SSM_PROMPTS) * SSM_NEW}
    bad = {k: (got[k], c) for k, c in want.items() if got[k] != c}
    others = {k: c for k, c in got.items() if c and k not in want}
    if bad or others:
        raise RuntimeError(f"phase 11 launches (got, want): {bad}; "
                           f"unexpected: {others}")
    del model, params, pool
    small = arch.replace(model=dataclasses.replace(arch.model,
                                                   num_layers=SMALL_LAYERS))
    ssm_card_vs_cpu(torch, dev, small, SSM_RANKS, "phase 11 card vs CPU")
    return got


def zamba2_arch():
    """zamba2-1.2b at full width and depth at batch Z_BATCH x M_SEQ."""
    import dataclasses

    from repro_torch.configs import get_config

    arch = get_config("zamba2-1.2b")
    return arch.replace(train=dataclasses.replace(
        arch.train, batch_size=Z_BATCH, seq_len=M_SEQ))


def zamba2_phase(torch, dev, wrappers, name, card):
    """Phase 12: full-width, full-depth zamba2-1.2b (32 SSD layers and
    attention layers 5, 11, ..., 35 at head dim 64).  ROUNDS SplitFT rounds
    through SplitFTSystem.run at 5 clients x batch Z_BATCH x seq M_SEQ
    without remat, cut 4 over the config's buckets, fp8 smashed
    activations (plain, as in the reference): a train step launches the
    SSD kernel per SSD layer and the flash forward and backward per
    attention layer; an eval step the SSD kernel and flash forward per
    layer and the fused LoRA forward per layer and target.  The peak of
    device memory must stay below PEAK_SHARE of the card.  Then the fused
    LoRA backward through autograd at the eval shape (phase 5's global-
    adapter gradient); then SSM_PROMPTS' requests served from the trained
    per-client adapters (pool_from_state, serve_serially: the SSD kernel
    with the final state, the indexed LoRA, the flash forward in the
    prefill and the contiguous decode kernel at each tick); then a 2-layer
    (SSD, attention) card-vs-CPU round step, uncompressed and under fp8,
    and card-vs-CPU served logits.  Returns the launches."""
    import dataclasses

    from repro_torch.runtime import serving

    arch = zamba2_arch()
    m = arch.model
    attn = len(m.attn_layer_indices)
    ssd = m.num_layers - attn
    n_ad = 2 * ssd + 4 * attn           # ssm_in, ssm_out; q, k, v, o
    log(f"phase 12: {arch.name} at full width and depth: {ssd} SSD layers "
        f"(d_inner {m.d_inner}, {m.ssm_heads} heads of {m.ssm_head_dim}, "
        f"state {m.ssm_state}), attention layers {list(m.attn_layer_indices)}"
        f" ({m.num_heads} heads of {m.head_dim}, d_ff {m.d_ff}), vocab "
        f"{m.vocab_size}, untied head; batch {Z_BATCH} without remat, cut "
        f"{arch.split.cut_layer} over {arch.split.cut_buckets}, smashed "
        f"{arch.split.smashed_compress}")
    system, got, per_round, times = run_rounds(torch, arch, dev, wrappers,
                                               "phase 12", name, card)
    peak = torch.cuda.max_memory_allocated()
    check_launches(
        per_round,
        lambda p: {"ssd_scan": ssd, "flash_attention_fwd": attn,
                   "flash_attention_bwd": attn},
        {"ssd_scan": ssd, "flash_attention_fwd": attn,
         "lora_matmul_fwd": n_ad},
        "zamba2-1.2b training")
    total = torch.cuda.get_device_properties(0).total_memory
    if peak > PEAK_SHARE * total:
        raise RuntimeError(f"phase 12: peaks at {peak / 2**30:.2f} GiB, over "
                           f"{PEAK_SHARE} of the card's "
                           f"{total / 2**30:.2f} GiB")
    nonzero = lambda d: {k: c for k, c in d.items() if c}  # noqa: E731
    log(f"phase 12 [{name}, {card}]: train step "
        f"{fmt([t * 1e3 for _, t, _, _ in times])} ms, eval step "
        f"{fmt([e * 1e3 for _, _, e, _ in times])} ms, host share per round "
        f"{fmt([hst / w for w, _, _, hst in times])}; launches per train "
        f"step {nonzero(per_round[-1][1])}, per eval step "
        f"{nonzero(per_round[-1][2])}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB of the card's {total / 2**30:.2f} GiB "
        f"(batch {Z_BATCH}, remat none)")

    got["lora_matmul_bwd"] += global_adapter_grad(
        torch, dev, wrappers, system, n_ad, "phase 12", name, card)

    # serving the trained per-client adapters
    pool = serving.pool_from_state(system.model, system.state)
    served = serve_serially(
        torch, dev, wrappers, system.model, system.base_params, pool,
        "phase 12 serving", name, card,
        ("ssd_scan (final state)", "lora_matmul_indexed",
         "flash_attention_fwd", "decode_attention"))
    n_req = len(SSM_PROMPTS)
    want = {"ssd_scan (final state)": ssd * n_req,
            "flash_attention_fwd": attn * n_req,
            "decode_attention": attn * n_req * (SSM_NEW - 1),
            "lora_matmul_indexed": n_ad * n_req * SSM_NEW}
    bad = {k: (served[k], c) for k, c in want.items() if served[k] != c}
    others = {k: c for k, c in served.items() if c and k not in want}
    if bad or others:
        raise RuntimeError(f"phase 12 serving launches (got, want): {bad}; "
                           f"unexpected: {others}")
    del system, pool

    small = arch.replace(model=dataclasses.replace(
        m, num_layers=SMALL_LAYERS, attn_layer_indices=Z_SMALL_ATTN))
    small_step_check(torch, dev, "zamba2-1.2b", M_SEQ,
                     [("none", "none", {}), ("fp8", "fp8", {})],
                     "phase 12 step", compressed="mean",
                     model_kw=dict(attn_layer_indices=Z_SMALL_ATTN))
    ssm_card_vs_cpu(torch, dev, small, SSM_RANKS, "phase 12 card vs CPU")
    return {k: got[k] + served[k] for k in got}


def host_available_gib() -> float:
    """The host's available memory (MemAvailable of /proc/meminfo), GiB."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) / 2**20
    return float("nan")


@contextlib.contextmanager
def recorded_routing(on=True, replay=None):
    """While open, every MoE layer's routing (transformer.moe_route) adds
    (its top-k indices on the host, the share of its (token, choice)
    pairs past capacity) to the yielded list.  replay: another run's
    list, whose i-th call's choices the i-th call routes by instead of
    its own (transformer.moe_queue); the list still records its own."""
    from repro_torch.models import transformer

    calls = []
    if not on:
        yield calls
        return
    route = transformer.moe_route

    def recording(cfg, yg, router):
        got = route(cfg, yg, router)
        own = got[2].detach().cpu()
        if replay is not None:
            if len(calls) >= len(replay):
                raise RuntimeError(f"more MoE layer calls than the "
                                   f"{len(replay)} replayed")
            theirs = replay[len(calls)][0]
            if theirs.shape != own.shape:
                raise RuntimeError(f"replayed choices {tuple(theirs.shape)}"
                                   f" for a call of {tuple(own.shape)}")
            got = transformer.moe_queue(cfg, got[0],
                                        theirs.to(got[2].device))
        _, _, _, pos, cap = got
        calls.append((own, float((pos >= cap).float().mean())))
        return got

    transformer.moe_route = recording
    try:
        yield calls
    finally:
        transformer.moe_route = route


def routing_flips(torch, card, cpu) -> int:
    """(token, choice) pairs chosen on the card and not on the CPU, over
    recorded_routing's calls of one step on each (a choice's rank among
    its token's k does not move its queue position)."""
    if len(card) != len(cpu):
        raise RuntimeError(f"{len(card)} MoE layer calls on the card, "
                           f"{len(cpu)} on the CPU")
    flips = 0
    for (a, _), (b, _) in zip(card, cpu):
        same = (a[..., :, None] == b[..., None, :]).any(-1)
        flips += int((~same).sum())
    return flips


def kimi_arch():
    """kimi-k2 at full width with KIMI_EXPERTS experts a layer and
    KIMI_LAYERS layers, cut KIMI_CUT over KIMI_BUCKETS, 5 clients x batch
    KIMI_BATCH x seq 512; the config's capacity, aux loss, LoRA and int8
    smashed activations."""
    import dataclasses

    from repro_torch.configs import get_config

    arch = get_config(KIMI)
    return arch.replace(
        model=dataclasses.replace(arch.model, num_layers=KIMI_LAYERS,
                                  num_experts=KIMI_EXPERTS),
        split=dataclasses.replace(arch.split, cut_layer=KIMI_CUT,
                                  cut_buckets=KIMI_BUCKETS),
        train=dataclasses.replace(arch.train, batch_size=KIMI_BATCH,
                                  seq_len=M_SEQ))


def drop_shares(torch, dev, system):
    """The share of (token, choice) pairs dropped past capacity in each
    MoE layer of one forward of the system's last train batch through
    its per-client adapters."""
    from repro_torch.core import split

    base, state, batch = system.train_step.last[:3]
    eff = split.merge_adapters(system.model, state["client_adapters"],
                               state["server_adapters"], state["cuts"],
                               rank_cut=state.get("rank_cut"))
    with recorded_routing() as calls, torch.no_grad():
        system.model.loss(base, eff, {k: torch.as_tensor(v, device=dev)
                                      for k, v in batch.items()},
                          per_client=True)
    return [share for _, share in calls]


def kimi_phase(torch, dev, wrappers, name, card):
    """Phase 13: kimi_arch() (weights drawn on the card), ROUNDS SplitFT
    rounds through SplitFTSystem.run, the cross entropy in chunks of
    KIMI_CE_CHUNK: a train step launches the flash forward and backward
    (hd 112) per layer and the int8 round trip twice per distinct cut; an
    eval step the flash forward per layer and the fused LoRA forward (K =
    7168) per layer and target.  The peak of device memory must stay
    below PEAK_SHARE of the card, and at capacity 1.25 some (token,
    choice) pairs must be dropped in every layer.  Then the fused LoRA
    backward at the eval shape (phase 5's global-adapter gradient), then
    phase 4's workload served from the trained adapters, contiguous and
    paged (the indexed LoRA at K = 7168 into 7168 and 896, decode at hd
    112): prompts of PROMPT tokens are a bucket, so the engine's prefill
    has serial_reference's capacity.  Returns the launches."""
    from repro_torch.models import transformer
    from repro_torch.runtime import serving

    arch = kimi_arch()
    m = arch.model
    layers, targets = m.num_layers, len(arch.lora.targets)
    log(f"phase 13: {arch.name} cut to {m.num_experts} of 384 experts a "
        f"layer and {layers} of 61 layers, cut {KIMI_CUT} over buckets "
        f"{KIMI_BUCKETS}, ce_chunk {KIMI_CE_CHUNK}; full width: d_model "
        f"{m.d_model}, {m.num_heads} heads over {m.num_kv_heads} of "
        f"{m.head_dim}, d_ff {m.moe_d_ff} per expert, top-{m.moe_top_k}, "
        f"{m.num_shared_experts} shared expert, vocab {m.vocab_size} untied, "
        f"capacity factor {m.moe_capacity_factor}, router aux loss "
        f"{m.router_aux_loss}; weights drawn on the card")
    system, got, per_round, times = run_rounds(
        torch, arch, dev, wrappers, "phase 13", name, card,
        ce_chunk=KIMI_CE_CHUNK, draw_on_device=True)
    peak = torch.cuda.max_memory_allocated()
    check_launches(
        per_round,
        lambda p: {"flash_attention_fwd": layers,
                   "flash_attention_bwd": layers,
                   "int8_roundtrip_smashed": 2 * len(set(p["cuts"]))},
        {"flash_attention_fwd": layers, "lora_matmul_fwd": targets * layers},
        "kimi-k2 training")
    total = torch.cuda.get_device_properties(0).total_memory
    if peak > PEAK_SHARE * total:
        raise RuntimeError(f"phase 13: peaks at {peak / 2**30:.2f} GiB, over "
                           f"{PEAK_SHARE} of the card's "
                           f"{total / 2**30:.2f} GiB")
    nonzero = lambda d: {k: c for k, c in d.items() if c}  # noqa: E731
    log(f"phase 13 [{name}, {card}]: train step "
        f"{fmt([t * 1e3 for _, t, _, _ in times])} ms, eval step "
        f"{fmt([e * 1e3 for _, _, e, _ in times])} ms, host share per round "
        f"{fmt([hst / w for w, _, _, hst in times])}; launches per train "
        f"step {nonzero(per_round[-1][1])}, per eval step "
        f"{nonzero(per_round[-1][2])}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB of the card's {total / 2**30:.2f} GiB")
    shares = drop_shares(torch, dev, system)
    log(f"phase 13: (token, choice) pairs dropped past capacity per layer "
        f"at capacity factor {m.moe_capacity_factor} ({m.moe_top_k} x "
        f"{M_SEQ} pairs a routing group, "
        f"{transformer.moe_capacity(m, M_SEQ)} slots per expert): "
        f"{fmt(shares)}")
    if len(shares) != layers or not all(sh > 0 for sh in shares):
        raise RuntimeError(f"phase 13: drop shares {shares}: the path must "
                           f"drop pairs in each of the {layers} layers")

    got["lora_matmul_bwd"] += global_adapter_grad(
        torch, dev, wrappers, system, targets * layers, "phase 13", name,
        card)
    pool = serving.pool_from_state(system.model, system.state)
    served = serve_both(torch, dev, wrappers, system.model,
                        system.base_params, pool, requests=N_REQUESTS,
                        prompt=PROMPT, gen=GEN, max_len=MAX_LEN,
                        tag="phase 13 serving", name=name, card=card)
    del system, pool
    torch.cuda.empty_cache()
    return {k: got[k] + served[k] for k in got}


def moe_decode_check(torch, dev, arch, cpu_params, tag):
    """Prefill of one PROMPT-token request and 4 decode steps through the
    indexed pool (ranks RANKS), on the card and on the CPU from the same
    weights: the card's tokens fed to both, logits within LOGITS_TOL and
    each step's token equal; the top-k choices' flips are logged."""
    from repro_torch.models.model import build_model
    from repro_torch.runtime import serving
    from repro_torch.tree import tree_map

    rng = np.random.default_rng(SEED + 13)
    prompt = rng.integers(3, arch.model.vocab_size, size=PROMPT)
    outs, toks, routes = {}, [], {}
    for role, dv in (("card", dev), ("cpu", torch.device("cpu"))):
        model = build_model(arch, device=dv)
        params = tree_map(lambda t: t.to(dv), cpu_params)
        pool = serving.build_adapter_pool(
            model, torch.Generator().manual_seed(SEED + 1), len(RANKS),
            ranks=RANKS)
        ad = serving.attach_ids(pool, [1])
        with torch.no_grad(), recorded_routing() as calls:
            cache = model.init_cache((1,), MAX_LEN)
            lg, cache = model.prefill(params, ad, {"tokens": torch.as_tensor(
                prompt[None].astype(np.int32), device=dv)}, cache)
            seq = [lg[0, -1].float().cpu()]
            for i in range(4):
                if role == "card":
                    toks.append(int(torch.argmax(seq[-1])))
                lg, cache = model.decode_step(
                    params, ad, torch.tensor([[toks[i]]], dtype=torch.int32,
                                             device=dv), cache)
                seq.append(lg[0, -1].float().cpu())
        outs[role], routes[role] = torch.stack(seq), calls
        del model, params, pool, cache
    torch.cuda.empty_cache()
    flips = routing_flips(torch, routes["card"], routes["cpu"])
    diff = float((outs["card"] - outs["cpu"]).abs().max())
    cpu_toks = [int(t) for t in torch.argmax(outs["cpu"], -1)[:4]]
    log(f"{tag}: prefill of {PROMPT} tokens + 4 decode steps, card vs CPU: "
        f"max |logit diff| {diff:.3e} (tol {LOGITS_TOL}), tokens {toks} vs "
        f"{cpu_toks}, {flips} top-k choices flipped")
    torch.testing.assert_close(
        outs["card"], outs["cpu"], rtol=LOGITS_TOL, atol=LOGITS_TOL,
        msg=lambda msg: f"{tag} card vs CPU logits ({flips} flips): {msg}")
    if cpu_toks != toks:
        raise RuntimeError(f"{tag}: card tokens {toks} != CPU {cpu_toks}")


def moe_vlm_steps(torch, dev, wrappers):
    """Phase 13b: one card-vs-CPU round step each at full width and
    SMALL_LAYERS layers, weights drawn on the card (small_step_check with
    wide=True), uncompressed and under the config's int8 (held on
    average): kimi-k2 (hd 112) and llama4-maverick (hd 128, top-1, RoPE
    theta 500000) at MOE_STEP_EXPERTS experts and seq DENSE_STEP_SEQ,
    each followed by moe_decode_check; internvl2-76b (hd 128, d_ff 28672)
    over a batch with its 256-position prefix at seq VLM_SEQ.  Each
    card step must launch the flash forward and backward.  Returns the
    launches by head dim."""
    by_hd = {}
    steps = [("none", "none", {}), ("int8", "int8", {})]
    for arch_name, seq, kw in (
            (KIMI, DENSE_STEP_SEQ, dict(num_experts=MOE_STEP_EXPERTS)),
            (LLAMA4, DENSE_STEP_SEQ, dict(num_experts=MOE_STEP_EXPERTS)),
            (VLM, VLM_SEQ, {})):
        arch = small_arch(arch_name, kw)
        m = arch.model
        plen = m.frontend_prefix_len if m.family == "vlm" else 0
        log(f"phase 13b: {arch_name} at full width, {SMALL_LAYERS} layers"
            + (f", {m.num_experts} experts top-{m.moe_top_k}"
               if m.num_experts else "")
            + f", d_model {m.d_model}, {m.num_heads} heads over "
            f"{m.num_kv_heads} of {m.head_dim}, seq {seq}"
            + (f" ({plen} prefix positions)" if plen else ""))
        cpu_params, got = small_step_check(
            torch, dev, arch_name, seq, steps, "phase 13b", compressed="mean",
            model_kw=kw, wide=True, wrappers=wrappers)
        idle = [k for k in ("flash_attention_fwd", "flash_attention_bwd")
                if not got[k]]
        if idle:
            raise RuntimeError(f"phase 13b {arch_name}: never launched {idle}")
        if m.num_experts:
            moe_decode_check(torch, dev, arch, cpu_params,
                             f"phase 13b {arch_name} serving")
        del cpu_params
        acc = by_hd.setdefault(m.head_dim, {})
        for k, c in got.items():
            acc[k] = acc.get(k, 0) + c
    return by_hd


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


def decode_args(torch, rand, dt, dev, *, s, lens, heads=(12, 12), hd=64):
    """Decode inputs: q (B, H, hd), a contiguous cache (B, s, KVH, hd) and
    cache lengths; gpt2-small's 12 heads of 64 unless heads = (H, KVH) and
    hd say otherwise."""
    b, (h, kvh) = len(lens), heads
    q = rand(b, h, hd, dtype=dt)
    k = rand(b, s, kvh, hd, dtype=dt)
    v = rand(b, s, kvh, hd, dtype=dt)
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
