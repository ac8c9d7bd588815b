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
    logits against the CPU plain path; then a cache with a client axis
    (lead (2, 2): 2 clients x 2 rows, each client its adapter) against
    the same rows over a lead of (4,), for gpt2-small and for
    mamba2-780m at full width and 2 layers (client_axis_check);
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
  * the dense family at head dim 128: llama3-8b at full width (6 of its
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
    its widths (K = 7168; N = 7168 and 896);
  * the audio family: whisper-medium at full width and depth (24
    encoder layers over 1500 frames of the stub frontend, 24 decoder
    layers with cross-attention, 817M parameters drawn on the card), 3
    rounds of the round engine's own steps in a thin loop (5 clients x
    batch 1 x 448 decoder positions, the config's cut 4 inside the
    encoder), then requests served from the trained adapters through
    Model.prefill (the encoder and the cross cache) and decode_step,
    batched and alone, tokens equal and logits held against the card's
    own train-mode forward; one card-vs-CPU step each uncompressed, int8
    and under remat "full" at 2 encoder + 2 decoder layers with cuts in
    the encoder and at its last layer, then prefill + 4 decode steps.
    The flash kernels are held non-causal at whisper's encoder (1500 x
    1500) and cross (448 x 1500) shapes and ragged edges, the decode
    kernel as the cross read at cache length 1500, the fused LoRA
    forward and backward, the indexed LoRA and the int8 kernels at its
    widths and the path's row counts, and phase 3 times the attention
    kernels and the indexed LoRA at a request's encoder prefill (M 1500);
  * the dry-run's serving cells (phase 15, ``repro_torch.launch.dryrun``
    on the host first, its predicted FLOPs, bytes, bound and peak
    printed beside the card's wall time and peak): llama3-8b at full
    width and 2 of its 32 layers, decode_32k (one decode step at B 128
    over a contiguous bf16 cache of 32768 positions drawn from the seed;
    its rows within tolerance of a B=2 step, the decode kernel's and
    the indexed LoRA's rows bit for bit; the B=2 step against the CPU)
    and prefill_32k (the largest batch up to P15_BATCH_CAP that the
    dry-run fits in 90% of the card; then one decode step; row 0's
    logits against the train-mode forward); mamba2-780m at full width
    and 24 of its 48 layers, long_500k (a cache made for 524288
    positions, a 300-token prompt and 4 decode steps) and prefill_32k,
    their paths also in fp32 against the train-mode forward.  The flash
    forward at S 32768, the decode kernel at capacity 32768, the indexed
    LoRA at M 32768 and the SSD scan at S 32768 are held against their
    plain versions and timed.
    ``python3 chip_smoke.py --only 15`` builds and runs phase 15 alone;
  * the cohort split over torch.distributed ranks (phase 16,
    ``runtime.sharding.ClientShard``): gpt2-small at full width, 4
    clients x batch 4 x seq 512, cut 2, int8 smashed, 2 rounds of
    ``SplitFTSystem.run`` with SGD and with the config's AdamW, each
    unsharded, under NCCL at world size 1 (bit for bit the unsharded
    run) and in 2 gloo ranks that share the card
    (``launch.sharded.run_ranks``; each rank holds 2 rows, launches per
    step what the unsharded steps launch, and matches the unsharded
    run's losses and state as P16_LOSS_RTOL, GRAD_TOL["int8"] and
    P16_OUTLIERS say, through ``runtime.agreement``); round walls and
    each rank's peak printed.  ``python3 chip_smoke.py --only 16``
    builds and runs phase 16 alone;
  * parameter sharding of the dense family (phase 17,
    ``runtime.sharding.MeshShard``): llama3-8b at full width, 2 of its 32
    layers, cut 1, 5 clients x batch 2 x seq 512, SGD, 1 round of
    ``SplitFTSystem.run`` without smashed compression,
    unsharded, under NCCL at world size 1 on a (1, 1)
    mesh (bit for bit the unsharded run) and in 2 gloo ranks that share
    the card on a (1, 2) mesh: tensor parallelism over "model" (16 of the
    32 heads and their 4 KV heads, half the FFN width and of the
    vocabulary on each rank, the vocab-parallel cross entropy).  Each
    rank records the shapes its flash and fused LoRA kernels ran at, its
    launches, its peak and its init's peak (held to its blocks, one full
    leaf and the round state: each leaf is narrowed as it is drawn, so no
    rank holds the whole tree); its results are held to the unsharded run's
    (P17_TOL, through ``runtime.agreement``), and the kernels of the path
    are held against their plain versions and timed at the TP-local
    shapes.  ``python3 chip_smoke.py --only 17`` builds and runs phase 17
    alone;
  * parameter sharding of the MoE and hybrid families (phase 18):
    kimi-k2 at full width (2 of its 61 layers, 32 of its 384 experts,
    top-8 at capacity 1.25, int8 smashed) and zamba2-1.2b at full width
    (4 of its 38 layers: 3 SSM, 1 attention; fp8 smashed), 5 clients x
    batch 2 x seq 512, SGD, 1 round each, unsharded, under NCCL at
    world size 1 (bit for bit) and in 2 gloo ranks on a (1, 2) mesh:
    the experts over "model" (each rank its 16, the router's logits
    gathered whole, so every rank routes alike; the gloo ranks by the
    unsharded run's choices, their own flips counted) and the SSM heads
    over "model" (in_proj and the conv gathered, a rank's heads taken,
    the gated norm's sum of squares summed over the ranks).  Each
    rank's blocks, kernel shapes, per-step launches (equal to the
    unsharded steps'), peaks and bytes all-reduced are checked or
    printed, its state held to the unsharded run's (P18_TOL), and the
    kernels held and timed at the TP-local shapes.  ``python3
    chip_smoke.py --only 18`` builds and runs phase 18 alone, and with
    ``--p18-smashed none`` without compression at the cut (the gloo
    state then within P18_TOL["none"], no element outside);
  * parameter sharding of the audio and vlm families, sequence
    parallelism and the "pod" axis (phase 19): whisper-medium at full
    width (2 + 2 layers over 1500 frames, cut 1 in the encoder) and
    internvl2-76b at full width (2 layers, its 256-position prefix), 5
    clients x batch 2, SGD, no compression at the cut, 1 round
    through ``SplitFTSystem.run`` with the frontend's input fed
    (``with_frontend``), each unsharded, under NCCL at world size 1 (bit
    for bit) and in 2 gloo ranks on a (1, 2) mesh with the residual
    stream's sequence split over "model" (the reference's default for
    both families); then gpt2-small at full width (4 layers, int8 at
    the cut) on a (2, 1, 2) ("pod", "data", "model") mesh of 4 gloo
    ranks (each client's rows over "pod", FSDP over "pod", the int8
    round trip over each whole message gathered at the cut).  Each
    rank's shapes, launches, bytes and init peak are checked and its
    state held to the unsharded run's (P19_TOL); the kernels are held
    and timed at the TP-local shapes.  After its round whisper-medium
    serves as phases 17 and 18 do, over seeded frames: on the gloo
    ranks its cross cache is split over "model" (750 of the 1500
    positions a rank) and each decode step reads it through the partial
    decode kernel and the lse merge, as it reads the self cache; phase
    17 holds and times that kernel at the cross read's shape.
    ``python3 chip_smoke.py --only 19`` builds and runs phase 19 alone.

The launch counters are read around each path, and every profile of a
path holds its count of the port's own kernels to them (a profile that
lost records is taken again, up to 3 times, then fails).  Every phase
that fails
raises, so the exit code is non-zero; without a GPU it exits 1 before
printing any result.  The last line is {"ok": true, "device": {...}};
the line before it lists the kernels with their launches on the paths
and their times.

TF32 is off for matmuls and cuDNN: fp32 means fp32 here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
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
# phase 4's cache with a client axis (client_axis_check): a cache of lead
# CLIENT_LEAD (N clients x B rows, "len" shared over N, each client's
# rows one adapter) against the same N x B rows over a lead of (N B,):
# a prefill of PROMPT tokens and CLIENT_STEPS decode steps into MAX_LEN,
# at gpt2-small's full width and at mamba2-780m's with CLIENT_SSM_LAYERS
# layers (its SSD scan with the final state in the prefill); the logits
# within CLIENT_TOL x max|logit|, the tokens and the launches equal
CLIENT_LEAD, CLIENT_STEPS, CLIENT_SSM_LAYERS, CLIENT_TOL = (2, 2), 4, 2, 1e-6
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
LLAMA_LAYERS, LLAMA_CUT, LLAMA_BUCKETS, LLAMA_CE_CHUNK = 6, 4, (2, 4), 128
LLAMA_HEADS = (32, 8)
# phase 10: opt-125m and gpt-neo-125m at full size and the paper setting;
# gpt-neo's 256-wide window bites on its odd layers at seq 512, and the
# served prompt of GEN_PROMPT tokens plus GEN_NEW runs decode past it
GEN_ARCHS = ("opt-125m", "gpt-neo-125m")
GEN_ROUNDS, GEN_PROMPT, GEN_NEW, GEN_MAX_LEN = 3, 288, 16, 320
# phase 10b: one card-vs-CPU step each at full width, 2 layers, seq
# DENSE_STEP_SEQ
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

# the audio family: whisper-medium (24 encoder + 24 decoder layers,
# d_model 1024, 16 heads of 64 over 16, d_ff 4096, vocab 51865 untied,
# 1500 encoder frames of the stub frontend).  Phase 14: full width and
# depth, weights drawn on the card, ROUNDS rounds of the round engine's
# steps in a thin loop at 5 clients x batch W_BATCH x seq W_SEQ
# (whisper's text context) over 1500 frames each, the config's cut 4
# (inside the encoder) and smashed default ("none"); then W_REQUESTS
# requests over W_ADAPTERS trained adapters, each with its own frames and
# a W_PROMPT-token prompt, W_NEW new tokens each, batched and alone.
# Phase 14b: the card-vs-CPU step at SMALL_LAYERS encoder and
# SMALL_LAYERS decoder layers over 1500 frames at seq W_SEQ, W_STEPS.
WHISPER = "whisper-medium"
W_BATCH, W_SEQ = 1, 448
W_REQUESTS, W_ADAPTERS, W_PROMPT, W_NEW = 4, 2, 8, 32
W_STEPS = [("none", "none", {}), ("int8", "int8", {}),
           ("none, remat full", "none", dict(remat="full"))]
# phase 2: the flash kernels non-causal at ragged edges (Sq, Sk, hd,
# window, q_offset) at B 2, GQA 4/2: one query and 65 over 1500 keys, the
# 16-row, 8-key and 64-key tile edges off the diagonal, a 28-key tail
# (1500's), keys past a 64-row query grid, and a window with an offset
FLASH_NONCAUSAL_EDGES = [(1, 1500, 64, 0, 0), (17, 65, 32, 0, 0),
                         (65, 1500, 64, 0, 0), (448, 28, 64, 0, 0),
                         (200, 1, 16, 0, 0), (63, 200, 64, 9, 4),
                         (1500, 64, 64, 0, 0)]


# phase 15: the dry-run's serving cells on the card (launch/dryrun.py).
# llama3-8b at full width and 2 of its 32 layers: decode_32k (B 128
# over a contiguous cache of 32768 positions) and prefill_32k; mamba2-780m
# at full width and 24 of its 48 layers (all 48 until the whole script
# needed the room): long_500k (a cache made for 524288 positions, a
# prompt of P15_PROMPT tokens and P15_NEW decode steps) and prefill_32k.
# A prefill's batch is the largest up to P15_BATCH_CAP that the dry-run
# fits in PEAK_SHARE of the card; the cap keeps the phase within its
# time (the length is never cut; the caps were 8 and 2 until phase 18
# needed the room).
P15_SEQ, P15_LONG = 32768, 524288
P15_LLAMA_LAYERS, P15_MAMBA2_LAYERS = 2, 24
P15_BATCH_CAP = {"llama3-8b": 2, "mamba2-780m": 1}
P15_PROMPT, P15_NEW = 300, 4
P15_FLASH_ROWS = 512          # the plain flash's query rows per call
P15_PLAIN_ROWS = 16           # the plain decode's sequences per call
P15_SSD = (1, P15_SEQ, 48, 64, 1, 128, 256)   # mamba2's prefill SSD
# the result line's rows of the kernels at phase 15's lengths
P15_ROWS = ("flash_attention_fwd (hd 128, S 32768)",
            "decode_attention (hd 128, capacity 32768)",
            "lora_matmul_indexed (M 32768)",
            "ssd_scan (final state, S 32768)")
# phase 16: the cohort split over torch.distributed ranks (ClientShard):
# gpt2-small at full width, P16_CLIENTS clients x batch 4 x seq 512, cut
# 2, int8 smashed, P16_ROUNDS rounds, three times for each optimizer of
# P16_TRAIN: unsharded, under NCCL at world size 1 (bit for bit the
# unsharded run) and in P16_RANKS gloo ranks that share the card.  A
# rank's GEMMs run at half the batch, and cuBLAS picks its kernels by
# shape, so a client's activations differ in their last bits from the
# unsharded run's and a few int8 codes at the cut take the neighbouring
# step: the state's float leaves are held as int8-compressed gradients
# are (GRAD_TOL["int8"]), with P16_OUTLIERS, the losses within
# P16_LOSS_RTOL, every discrete leaf and record equal
# (repro_torch.runtime.agreement, as the CPU tests of the sharded engine).
P16_ROUNDS, P16_CLIENTS, P16_RANKS = 2, 4, 2
# optimizer -> TrainConfig fields over gpt2-small's: SGD, and the config's
# own AdamW (lr 5e-5, grad_clip 1.0)
P16_TRAIN = {"sgd": dict(optimizer="sgd", lr_client=0.05, lr_server=0.05),
             "adamw": {}}
P16_RTOL, P16_ATOL_OF_MAX = GRAD_TOL["int8"]
# optimizer -> the losses' rtol.  AdamW's round-2 losses follow its
# round-1 sign flips (below): 1.04e-6 measured on an H100 (700 W)
P16_LOSS_RTOL = {"sgd": 1e-6, "adamw": 4e-6}
# optimizer -> per round {top-level state key: the largest share of a
# leaf's elements outside the tolerance}: AdamW's first steps move an
# element by ~lr sign(g), so where a flipped int8 code changes the sign
# of a small gradient element the two runs step it by lr in opposite
# directions, and the next round's gradients and moments follow
# (repro_torch.runtime.agreement).  About 4x the shares measured on an
# H100 (700 W): after round 1, 1.6e-3 and 1.0e-3 of the client and
# server adapters' elements; after round 2, 4.1e-3 and 2.2e-3 of the
# adapters', 2.1e-2 and 4.0e-3 of the client and server moments'.
P16_OUTLIERS = {"sgd": ({}, {}),
                "adamw": ({"client_adapters": 6e-3, "server_adapters": 6e-3},
                          {"client_adapters": 1.6e-2,
                           "server_adapters": 1.6e-2, "opt_c": 8e-2,
                           "opt_s": 1.6e-2})}
# the result line's rows that phase 16's rounds launch
P16_ROWS = ("flash_attention_fwd", "flash_attention_bwd", "lora_matmul_fwd",
            "lora_matmul_bwd", "int8_roundtrip_smashed")
# phase 17: parameter sharding of the dense family (MeshShard): llama3-8b
# at full width, P17_LAYERS of its 32 layers, cut P17_CUT, 5 clients x
# batch P17_BATCH x seq 512 (phase 9's batch 4, and 2 rounds, until the
# whole script needed the room), the cross entropy in chunks of
# LLAMA_CE_CHUNK, SGD, P17_ROUNDS rounds, for each smashed compressor of
# P17_SMASHED: unsharded, under NCCL at world size 1 on a (1, 1) mesh
# (bit for bit the unsharded run) and in P17_RANKS gloo ranks that share
# the card on a (1, P17_RANKS) mesh (tensor parallelism over "model").
P17_LAYERS, P17_CUT, P17_ROUNDS, P17_RANKS = 2, 1, 1, 2
P17_BATCH = 2
# int8 under TP is phase 18's (kimi-k2's smashed activations)
P17_SMASHED = ("none",)
# what else a rank's init may hold on the card beside its blocks, one full
# leaf and the round state (the generator, the caching allocator's
# rounding)
P17_INIT_SLACK = 64 * 2**20
P17_TRAIN = dict(optimizer="sgd", lr_client=0.05, lr_server=0.05)
# smashed compressor -> (rtol, atol as a share of max|leaf|, the losses'
# rtol) of the gloo ranks' state and records against the unsharded run.  A
# rank's GEMMs run at other shapes (N 2048 for wq, K 2048 for wo, half the
# vocabulary), and cuBLAS picks its kernels by shape, so every sum runs in
# another order; without compression the float leaves are held as the
# card-vs-CPU steps hold uncompressed gradients (GRAD_TOL["none"]), with
# int8 as int8-compressed ones (a code at the cut may take the
# neighbouring step)
P17_TOL = {"none": GRAD_TOL["none"] + (1e-5,),
           "int8": GRAD_TOL["int8"] + (1e-5,)}
# the shapes each rank's kernels run at on the (1, 2) mesh: the flash
# kernels over (B, S, heads, hd) of q and of k, the fused LoRA over (K, N)
P17_FLASH = {((5 * P17_BATCH, 512, 16, 128), (5 * P17_BATCH, 512, 4, 128))}
P17_LORA = {(4096, 2048), (4096, 1024), (2048, 4096)}
P17_WQ = (4096, 2048)        # the timed fused LoRA shape: wq's block
# the result line's rows of the kernels at those shapes
P17_ROWS = ("flash_attention_fwd (hd 128, TP 2)",
            "flash_attention_bwd (hd 128, TP 2)",
            "lora_matmul_fwd (TP 2)", "lora_matmul_bwd (TP 2)")
# phases 17 and 18 serve after the round (serving on a mesh, mesh_serve):
# each run's trained global model through serve_model on its own blocks,
# a prefill of SERVE_PROMPT tokens for SERVE_BATCH rows into a cache of
# SERVE_CAP positions (its rank's blocks: cache_specs splits the KV
# sequence over "model", 128 positions a rank on 2 ranks), then
# SERVE_STEPS decode steps at positions 126..129, across the block edge.
# The unsharded run decodes greedily; the NCCL world-1 and gloo runs are
# fed its tokens (kimi-k2 routed by its choices), so every step compares:
# NCCL bit for bit, the gloo ranks' logits within SERVE_TOL of max|logit|
# and their argmax the unsharded token wherever its top-2 gap is TOP2_GAP
# or more.  SERVE_TOL is ~4x the largest gap measured (zamba2's 4.29e-5,
# whose trained adapters carry the fp8 codes' flips at the cut; llama
# 2.98e-6, kimi-k2 1.66e-5)
SERVE_BATCH, SERVE_PROMPT, SERVE_CAP, SERVE_STEPS = 2, 126, 256, 4
SERVE_TOL = 2e-4
# the partial decode kernel (decode_attention_partial) at one rank's half
# of phase 15's decode_32k: B 128, the second 16384 positions of a
# 32768-position cache, llama3-8b's 32 heads over 8 of 128, bf16
PARTIAL_32K = (128, 16384, 32768, 32, 8, 128)
PARTIAL_ROW = "decode_attention_partial"
# the same kernel at whisper-medium's cross read on one of 2 "model"
# ranks (phase 19's serving): B 4, positions 750..1499 of the 1500 encoder
# positions, 16 heads of 64 (MHA), fp32; its bound is the block's K and V,
# 4 x 750 x 16 x 64 x 4 B x 2 = 24.6 MB, 7.3 us at HBM_BYTES_PER_S
PARTIAL_CROSS = (4, 750, 1500, 16, 16, 64)
PARTIAL_X_ROW = "decode_attention_partial (whisper cross)"


# phase 18: parameter sharding of the MoE family (EP: the experts over
# "model", their ff dim over "data") and of the hybrid family (TP over the
# SSM heads) in the training round.  kimi-k2 at full width, cut to
# P18_KIMI_LAYERS of its 61 layers and P18_KIMI_EXPERTS of its 384 experts
# (still top-8 at capacity 1.25: pairs are dropped in every layer call),
# int8 smashed, the cross entropy in chunks of KIMI_CE_CHUNK; zamba2-1.2b
# at full width, P18_Z_LAYERS of its 38 layers (SSM layers 0-2, attention
# at P18_Z_ATTN), fp8 smashed.  5 clients x batch P18_BATCH x seq 512,
# SGD, P18_ROUNDS rounds, each model unsharded, under NCCL at world size 1
# on a (1, 1) mesh (bit for bit the unsharded run) and in P17_RANKS gloo
# ranks that share the card on a (1, P17_RANKS) mesh.  The gloo ranks
# route by the unsharded run's top-k choices (recorded_routing's replay:
# a "model" sum that moves a logit's last bit can flip a choice), their
# own flips counted and every rank's own choices checked equal.
P18_MODELS = (KIMI, "zamba2-1.2b")
P18_KIMI_LAYERS, P18_KIMI_EXPERTS = 2, 32
P18_Z_LAYERS, P18_Z_ATTN = 4, (3,)
P18_CUT = {KIMI: 1, "zamba2-1.2b": 2}
P18_CE_CHUNK = {KIMI: KIMI_CE_CHUNK, "zamba2-1.2b": 0}
# (2 rounds until the whole script needed the room)
P18_BATCH, P18_ROUNDS = 2, 1
# smashed compressor -> (rtol, atol as a share of max|leaf|, the losses'
# rtol): phase 17's compressed tolerance, for int8 and fp8 alike (a code
# at the cut may take the neighbouring step)
P18_TOL = {"none": P17_TOL["none"], "int8": P17_TOL["int8"],
           "fp8": P17_TOL["int8"]}
# (model, smashed compressor) -> {leaf path: the largest share of its
# elements outside P18_TOL}: a few int8 (kimi-k2) or fp8 (zamba2) codes at
# the cut take the neighbouring step (the ranks' sums run in another
# order), and the attention backward carries such a code into the q and k
# adapters' B past 2e-3 x max|leaf|: kimi-k2 2.145e-3 and 2.592e-3 after
# rounds 1 and 2 on 3.5e-5 and 3.9e-5 of client_adapters/dec/k/B's
# elements; zamba2 2.496e-3 after round 1 on 3.1e-5 of attn/q/B's and
# attn/k/B's, client and server (an H100 at 700 W).  About 4x the shares
# measured; every other leaf is held to P18_TOL with no element outside
P18_OUTLIERS = {
    (KIMI, "int8"): {f"client_adapters/dec/{t}/B": 1.6e-4
                     for t in ("q", "k")},
    ("zamba2-1.2b", "fp8"): {f"{side}_adapters/attn/{t}/B": 1.2e-4
                             for side in ("client", "server")
                             for t in ("q", "k")}}
# the shapes each rank's kernels run at on the (1, 2) mesh (recorded_shapes)
P18_SHAPES = {
    KIMI: {"flash": {((10, 512, 32, 112), (10, 512, 4, 112))},
           "lora": {(7168, 3584), (7168, 896), (3584, 7168)},
           "ssd": set()},
    "zamba2-1.2b": {"flash": {((10, 512, 16, 64), (10, 512, 16, 64))},
                    # q, k and v, o; in_proj's columns of a rank's heads
                    # (x, z, dt) and B, C; out_proj's rows
                    "lora": {(2048, 1024), (2048, 2048), (1024, 2048),
                             (2048, 4256)},
                    "ssd": {(10, 512, 32, 64)}}}
P18_SSD_SHAPE = (10, 512, 32, 64, 1, 64, 256)   # (B, S, H, P, G, N, chunk)
# the result line's rows of the kernels at those shapes
P18_ROWS = ("flash_attention_fwd (hd 112, TP 2)",
            "flash_attention_bwd (hd 112, TP 2)",
            "flash_attention_fwd (hd 64, TP 2)",
            "flash_attention_bwd (hd 64, TP 2)",
            "lora_matmul_fwd (kimi-k2, TP 2)",
            "lora_matmul_bwd (kimi-k2, TP 2)",
            "lora_matmul_fwd (zamba2, TP 2)", "lora_matmul_bwd (zamba2, TP 2)",
            "ssd_scan (TP 2)")


# phase 19: parameter sharding of the audio and vlm families (TP over
# "model", their encoder's and decoder's streams under sequence
# parallelism, the reference's default for both), and of a client's batch
# rows over "pod", in the training round.  whisper-medium at full width,
# P19_W_ENC of its 24 encoder and P19_W_DEC of its 24 decoder layers, cut
# 1 (in the encoder), 5 clients x batch P19_BATCH x W_SEQ tokens over 1500
# frames; internvl2-76b at full width, P19_V_LAYERS of its 80 layers, cut
# 1, 5 x P19_BATCH x P19_V_SEQ with its 256-position prefix, the cross
# entropy in chunks of LLAMA_CE_CHUNK; both SGD, smashed none, the rounds
# of P19_ROUNDS, unsharded, under NCCL at world size 1 on a (1, 1) mesh
# (bit for bit the unsharded run) and in P17_RANKS gloo ranks that share
# the card on a (1, P17_RANKS) mesh.  Then phase 16's gpt2-small at full
# width and P19_POD_LAYERS of its 12 layers (4 clients x batch 4 x seq
# 512, cut 2, int8 at the cut, SGD) on a ("pod", "data", "model") mesh of
# P19_POD_MESH: unsharded, NCCL at world size 1 on (1, 1, 1), and 4 gloo
# ranks: each client's rows over "pod", TP and SP over "model", FSDP over
# "pod", the int8 round trip over each whole message gathered at the cut.
P19_W_ENC, P19_W_DEC, P19_V_LAYERS, P19_CUT = 2, 2, 2, 1
P19_BATCH, P19_V_SEQ = 2, 512
# rounds a run takes: whisper-medium's and internvl2-76b's 1 (2 until the
# whole script needed the room), the pod run's 2
P19_ROUNDS = {WHISPER: 1, VLM: 1, "pod": 2}
P19_POD_MESH = (2, 1, 2)          # ("pod", "data", "model")
P19_POD_LAYERS = 4
P19_MODELS = (WHISPER, VLM)
# the tolerances: without compression as phase 17's; the pod run with int8
# at the cut as phase 16 holds its SGD run (a code may take the
# neighbouring step), losses within rtol 1e-6
P19_TOL = {WHISPER: P17_TOL["none"], VLM: P17_TOL["none"],
           "pod": GRAD_TOL["int8"] + (1e-6,)}
# the shapes each rank's kernels run at: the flash kernels over (B, S,
# heads, hd) of q and of k (whisper: the encoder, the cross read, the
# decoder), the fused LoRA over (K, N), the int8 round trip over the
# message (the gathered one on the pod mesh)
P19_SHAPES = {
    WHISPER: {"flash": {((10, 1500, 8, 64), (10, 1500, 8, 64)),
                        ((10, 448, 8, 64), (10, 1500, 8, 64)),
                        ((10, 448, 8, 64), (10, 448, 8, 64))},
              "lora": {(1024, 512), (1024, 1024), (512, 1024)},
              "int8": set()},
    VLM: {"flash": {((10, 512, 32, 128), (10, 512, 4, 128))},
          "lora": {(8192, 4096), (8192, 1024), (4096, 8192)},
          "int8": set()},
    "pod": {"flash": {((8, 512, 6, 64), (8, 512, 6, 64))},
            "lora": {(768, 384), (768, 768), (384, 768)},
            "int8": {(4, 4, 512, 768)}}}
# the fused LoRA at internvl2's wq block (timed) and w_in block (held)
P19_LORA = ((8192, 4096), (8192, 14336))
P19_INT8 = (4, 4, 512, 768)
# the result line's rows of the kernels at those shapes
P19_ROWS = ("flash_attention_fwd (hd 64, TP 2, SP)",
            "flash_attention_bwd (hd 64, TP 2, SP)",
            "flash_attention_fwd (hd 128, TP 2, SP)",
            "flash_attention_bwd (hd 128, TP 2, SP)",
            "lora_matmul_fwd (TP 2, SP)", "lora_matmul_bwd (TP 2, SP)",
            "int8_roundtrip_smashed (gathered message)")


def hd_row(kname: str, hd: int) -> str:
    """The result line's row of kernel `kname` at head dim `hd`: the
    attention kernels at a head dim of WIDE_HDS have rows of their own."""
    return (f"{kname} (hd {hd})" if hd in WIDE_HDS and kname in WIDE_HD
            else kname)


def log(msg: str) -> None:
    """Prints msg after the time of day (UTC, to a tenth of a second), so
    that a cut run's output shows where its time went."""
    t = time.time()
    print(f"[{time.strftime('%H:%M:%S', time.gmtime(t))}.{int(t * 10) % 10}] "
          f"{msg}", flush=True)


def host_cpus() -> str:
    """The host's CPUs as this process sees them: the count, those it may
    run on, and the cgroup's CPU quota where one is set."""
    import os
    quota = "none"
    with contextlib.suppress(OSError, ValueError):
        limit, period = Path("/sys/fs/cgroup/cpu.max").read_text().split()
        if limit != "max":
            quota = f"{int(limit) / int(period):g} CPUs"
    return (f"{os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} in its "
            f"affinity, cgroup quota {quota}")


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


def start_sass(_build, lib_path):
    """Starts `cuobjdump -sass` of the built library in the background
    (phase 2 runs meanwhile); returns a function that waits for it and
    returns its output.  A dump still running when the script exits is
    killed."""
    import atexit
    import tempfile

    cuobjdump = str(Path(_build.find_nvcc()).parent / "cuobjdump")
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([cuobjdump, "-sass", str(lib_path)], stdout=out,
                            stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())

    def result() -> str:
        try:
            _, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        if proc.returncode:
            raise RuntimeError(f"cuobjdump -sass exited {proc.returncode}: "
                               f"{err[-2000:]}")
        out.seek(0)
        return out.read()
    return result


def mma_build_report(_build, lib_path, sass: str) -> None:
    """Phase 1's report (logged after phase 2, during which start_sass
    dumps the SASS): each tensor-core kernel's registers and spills (ptxas -v,
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


# device kernels that one launch of each wrapper runs (csrc/*.cu): the
# fused LoRA forward is its thin pass and its GEMM, the backward those
# and the dA/dB pass; the SSD scan's four passes; the flash backward's dq
# and dk/dv kernels
OWN_PER_LAUNCH = {"flash_attention_fwd": 1, "flash_attention_bwd": 2,
                  "lora_matmul_indexed": 1, "decode_attention": 1,
                  "decode_attention_partial": 1,
                  "decode_attention_paged": 1, "lora_matmul_fwd": 2,
                  "lora_matmul_bwd": 3, "int8_roundtrip_smashed": 1,
                  "int8_quantize_smashed": 1, "int8_dequantize_smashed": 1,
                  "ssd_scan": 4, "ssd_scan (final state)": 4}


def port_wrappers() -> dict:
    """{row name: wrapper} of every hand-written kernel's wrapper; each
    counts its launches in `.launches`."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.lora_matmul import ops as lops
    from repro_torch.kernels.smashed_quant import ops as sops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"flash_attention_fwd": fops.flash_attention_fwd,
            "lora_matmul_indexed": lops.lora_matmul_indexed,
            "decode_attention": dops.decode_attention,
            "decode_attention_paged": dops.decode_attention_paged,
            "decode_attention_partial": dops.decode_attention_partial,
            "flash_attention_bwd": fops.flash_attention_bwd,
            "lora_matmul_fwd": lops.lora_matmul_fwd,
            "lora_matmul_bwd": lops.lora_matmul_bwd,
            "int8_roundtrip_smashed": sops.int8_roundtrip_smashed,
            "int8_quantize_smashed": sops.int8_quantize_smashed,
            "int8_dequantize_smashed": sops.int8_dequantize_smashed,
            "ssd_scan": ssd_ops.ssd_scan_fwd,
            "ssd_scan (final state)": ssd_ops.ssd_scan_fwd_state}


# throwaway kernels that open and close every profile (torch.cuda._sleep's
# spin_kernel, left out of the counts)
PROFILE_PREFIX = 256
# passes of one profile before its phase fails
PROFILE_TRIES = 5


def _profile(torch, run, prefix: int = PROFILE_PREFIX):
    """(wall s, [(device event name, start us, end us)], (spin kernels
    recorded before the run, after it)) of `run` under torch.profiler's
    CUDA activity.  `prefix` throwaway kernels run first inside the
    profile, and as many after `run` before the profile stops: late in a
    whole script the profiler lost the first ~30 device records of a
    session (phase 11's decode step, its first indexed-LoRA kernel among
    them, in three passes running, with or without a discarded warm-up
    step or idle time before the run; the same step early in a process
    lost none), and on another H100 it lost 5 to 354 records of phase
    4's serving run in three passes, all of them of decode steps, which
    is what the run ends with."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(prefix):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for _ in range(prefix):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
    events, spins = [], []
    for e in raw_events(prof):
        if e.device_type() != torch.autograd.DeviceType.CUDA or hidden(e):
            continue
        lo = e.start_ns() / 1e3
        span = (e.name(), lo, lo + e.duration_ns() / 1e3)
        (spins if "spin_kernel" in span[0] else events).append(span)
    first = min((lo for _, lo, _ in events), default=None)
    before = sum(1 for _, lo, _ in spins if first is None or lo < first)
    return wall, events, (before, len(spins) - before)


def raw_events(prof):
    """The profiler's raw (kineto) events.  Parsing them into
    FunctionEvents (prof.events(), key_averages()) takes seconds for each
    10^5 events, and a whole-path profile holds that many: _profile and
    host_self_times read the raw ones."""
    return prof.profiler.kineto_results.events()


def hidden(event) -> bool:
    """Whether the profiler's own parsing would leave a raw event out (its
    bookkeeping records)."""
    from torch.autograd.profiler_util import _filter_name
    return (_filter_name(event.name())
            or getattr(event, "is_hidden_event", lambda: False)())


def host_self_times(torch, events) -> dict:
    """{host op: (self CPU us, calls)} of raw profiler events, as
    key_averages() gives them: per thread, an op nested in another (its
    interval inside the other's) is its child, and an op's self time is
    its duration less its children's; an op that is the only child of an
    op of its own name is merged into it (one call).  Ops that start and
    end on other threads, and device events, have no self CPU time."""
    cpu = torch.autograd.DeviceType.CPU
    threads = {}
    for e in events:
        if (e.device_type() != cpu or e.is_async() or hidden(e)
                or e.start_thread_id() != e.end_thread_id()):
            continue
        lo = e.start_ns()
        threads.setdefault(e.start_thread_id(), []).append(
            (lo, -(lo + e.duration_ns()), e.name()))
    out = {}
    for spans in threads.values():
        spans.sort()
        stack, done = [], []     # [end, name, self ns, children, parent]
        for lo, neg_hi, name in spans:
            hi = -neg_hi
            while stack and (lo >= stack[-1][0] or hi > stack[-1][0]):
                stack.pop()
            parent = stack[-1] if stack else None
            if parent:
                parent[2] -= hi - lo
                parent[3] += 1
            stack.append([hi, name, hi - lo, 0, parent])
            done.append(stack[-1])
        for op in reversed(done):
            parent = op[4]
            if parent and parent[1] == op[1] and parent[3] == 1:
                parent[2] += op[2]
                parent[3] = op[3]
                op[1] = None
        for _, name, own, _, _ in done:
            if name is not None:
                us, n = out.get(name, (0.0, 0))
                out[name] = (us + own / 1e3, n + 1)
    return out


def summarize(events):
    """(device-busy s or None, {name: device s}, {kernel name: launches})
    of profiler events; busy is the union of the intervals, None when
    there are none."""
    spans, by_name, kernels = [], {}, {}
    for name, lo, hi in events:
        spans.append((lo, hi))
        by_name[name] = by_name.get(name, 0.0) + (hi - lo) * 1e-6
        if not name.startswith(("Memcpy", "Memset")):
            kernels[name] = kernels.get(name, 0) + 1
    if not spans:
        return None, {}, {}
    busy, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in sorted(spans):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    return busy * 1e-6, by_name, kernels


OWN_KERNELS = tuple(MMA_KERNELS) + tuple(CUDA_CORE_KERNELS) + (
    "ssd_state_pass",)


def own_by_name(kernels) -> dict:
    """{the port's kernel name: launches} among {device name: launches}."""
    out = {}
    for k, c in kernels.items():
        for n in OWN_KERNELS:
            if n in k:
                out[n] = out.get(n, 0) + c
                break
    return out


def own_kernels(kernels) -> int:
    """Device kernels of the port's own sources among {name: launches}."""
    return sum(own_by_name(kernels).values())


def profile_short(kernels, launched):
    """None when a profile's {kernel name: launches} holds as many of the
    port's own kernels as the wrappers' counters say ran ({row: wrapper
    launches}); else what is missing.  A record the profiler drops can
    only lower the count."""
    want = sum(OWN_PER_LAUNCH[k] * c for k, c in launched.items())
    got = own_kernels(kernels)
    if got >= want:
        return None
    return (f"{got} of the port's own kernels recorded "
            f"({own_by_name(kernels)}), {want} launched "
            f"({ {k: c for k, c in launched.items() if c} })")


def device_busy(torch, run, what: str, tries: int = PROFILE_TRIES):
    """Run `run` under torch.profiler's CUDA activity.  Returns (wall s,
    device-busy s or None, {kernel name: device s}, {kernel name:
    launches}); busy is the union of the recorded device intervals, None
    when nothing was recorded.

    The wrappers' launch counters are read around each pass: a profile
    that holds fewer of the port's own kernels than they say ran lost
    records, so it is logged with its counts and `run` is profiled
    again, with a longer prefix and suffix, up to `tries` passes in all;
    then the phase fails.  No short profile's figures are returned."""
    wrappers = port_wrappers()
    short = []
    for i in range(tries):
        before = {k: w.launches for k, w in wrappers.items()}
        pad = PROFILE_PREFIX * (i + 1)
        wall, events, spins = _profile(torch, run, prefix=pad)
        launched = {k: w.launches - before[k] for k, w in wrappers.items()}
        busy, by_name, kernels = summarize(events)
        gap = profile_short(kernels, launched)
        if gap is None:
            if short:
                log(f"{what}: profile pass {i + 1} holds every launch after "
                    f"{len(short)} short one(s)")
            return wall, busy, by_name, kernels
        gap += (f"; spin kernels recorded {spins[0]} of {pad} before the "
                f"run, {spins[1]} of {pad} after it")
        short.append(f"pass {i + 1}: {gap}")
        log(f"{what}: the profiler dropped records in pass {i + 1}: {gap}")
    raise RuntimeError(f"{what}: no profile of {tries} holds the port's own "
                       f"kernels: {'; '.join(short)}")


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
    rows = sorted(host_self_times(torch, raw_events(prof)).items(),
                  key=lambda kv: -kv[1][0])
    return wall, [(k, us * 1e-3, n) for k, (us, n) in rows[:top]]


def profiled_pass(torch, fn, names, iters: int = 10):
    """One profiled pass of `iters` calls of fn: (device ms per call of
    each kernel whose name contains one of `names`, {kernel name:
    launches per call}), or (None, None) when the profiler recorded no
    device activity."""
    fn()
    torch.cuda.synchronize()
    _, busy, by_name, kernels = device_busy(
        torch, lambda: [fn() for _ in range(iters)], "phase 3 pass")
    if busy is None:
        return None, None
    return ({n: sum(v for k, v in by_name.items() if n in k) * 1e3 / iters
             for n in names},
            {k: c / iters for k, c in kernels.items()})


def launch_counts(per_kernel, names) -> dict:
    """{"kernels/call": all kernels per call, "own/call": those whose
    name contains one of `names`}."""
    return {"kernels/call": sum(per_kernel.values()),
            "own/call": sum(c for k, c in per_kernel.items()
                            if any(n in k for n in names))}


def pass_ms(torch, fn, names, iters: int = 10, launches: bool = False):
    """Device ms per call of each kernel whose name contains one of
    `names`, from torch.profiler over `iters` calls of fn; None when the
    profiler recorded no device activity.  launches: also the device
    kernels per call, of any name ("kernels/call") and of those names
    ("own/call")."""
    out, per_kernel = profiled_pass(torch, fn, names, iters)
    if out is not None and launches:
        out.update(launch_counts(per_kernel, names))
    return out


def check_kernels_per_call(torch, fn, names, own: int, total: int,
                           what: str, tries: int = PROFILE_TRIES):
    """pass_ms(launches=True) of fn, held to `own` kernels per call of
    `names` and `total` in all.  A record the profiler drops can only
    lower a count, so a pass below them is logged and profiled again, up
    to `tries` passes; each kernel's count is the highest over the
    passes so far.  Fails at once when a pass or those highest counts
    show more launches than wanted (an extra launch fails on the first
    pass), and when no pass shows exactly `own` and `total`.  Returns
    the pass that shows them (None when the profiler saw nothing)."""
    highest, dropped = {}, []
    for i in range(tries):
        out, per_kernel = profiled_pass(torch, fn, names)
        if out is None:
            return None
        for k, c in per_kernel.items():
            highest[k] = max(highest.get(k, 0.0), c)
        got, most = launch_counts(per_kernel, names), launch_counts(
            highest, names)
        for counts, which in ((got, f"pass {i + 1}"),
                              (most, f"the highest over {i + 1} passes")):
            if counts["own/call"] > own or counts["kernels/call"] > total:
                raise RuntimeError(
                    f"{what}: {counts['own/call']} own kernels and "
                    f"{counts['kernels/call']} in all per call in {which}, "
                    f"want {own} and {total}")
        if got == {"kernels/call": total, "own/call": own}:
            if dropped:
                log(f"phase 3: {what}: the profiler dropped launch records "
                    f"in {len(dropped)} pass(es) ({'; '.join(dropped)}); "
                    f"pass {i + 1} shows {own} own kernels and {total} in "
                    f"all per call")
            out.update(got)
            return out
        dropped.append(f"pass {i + 1}: {got['own/call']} own kernels and "
                       f"{got['kernels/call']} in all per call")
    raise RuntimeError(f"{what}: no pass of {tries} shows {own} own kernels "
                       f"and {total} in all per call: {'; '.join(dropped)}")


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


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Chip smoke test of the port.")
    ap.add_argument("--only", choices=["15", "16", "17", "18", "19"],
                    default=None,
                    help="build, then run this phase alone (no result "
                         "line); the contract's run takes no argument")
    ap.add_argument("--p18-smashed", choices=["none", "int8", "fp8"],
                    default=None,
                    help="with --only 18: both models' smashed compressor "
                         "(default: each config's own)")
    args = ap.parse_args(argv)
    if args.p18_smashed and args.only != "18":
        ap.error("--p18-smashed goes with --only 18")
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
    print(f"card: {card}", flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {name}; TF32 off (matmul and cuDNN); host: {host_cpus()}, "
        f"torch threads {torch.get_num_threads()}")

    # the wall time of each section, logged as it ends
    clock = {"name": "phase 1", "t": time.perf_counter()}

    def lap(name):
        now = time.perf_counter()
        log(f"wall: {clock['name']} {now - clock['t']:.1f} s")
        clock.update(name=name, t=now)

    # -- phase 1: build -----------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"phase 1: built {lib_path.name} from "
        f"{[p.name for p in _build.sources()]} in "
        f"{time.perf_counter() - t0:.1f} s")
    sass = start_sass(_build, lib_path)

    gen = torch.Generator().manual_seed(SEED)

    def rand(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dtype).to(dev)

    wrappers = port_wrappers()
    cells = (start_p15_cells(torch.cuda.get_device_properties(0).total_memory)
             if args.only in (None, "15") else None)
    rows_of = (list(wrappers) + [hd_row(k, hd) for hd in WIDE_HDS
                                 for k in WIDE_HD] + list(P15_ROWS)
               + list(P17_ROWS) + list(P18_ROWS) + list(P19_ROWS)
               + [PARTIAL_X_ROW])
    worst = {k: 0.0 for k in rows_of}
    if args.only:
        mma_build_report(_build, lib_path, sass())
    if args.only == "15":
        launches, rows = {k: 0 for k in rows_of}, {}
        phase15(torch, dev, wrappers, name, card, F, launches, worst, rows,
                cells)
        log(f"phase 15 alone: max |kernel - plain| "
            + ", ".join(f"{k} {worst[k]:.3e}" for k in P15_ROWS))
        return 0
    if args.only == "16":
        got = phase16(torch, dev, wrappers, name, card)
        log(f"phase 16 alone: launches {got}")
        return 0
    if args.only == "17":
        launches, rows = {k: 0 for k in rows_of}, {}
        phase17(torch, dev, F, wrappers, name, card, launches, worst, rows)
        log(f"phase 17 alone: launches "
            f"{ {k: c for k, c in launches.items() if c} }")
        return 0
    if args.only == "18":
        launches, rows = {k: 0 for k in rows_of}, {}
        phase18(torch, dev, F, wrappers, name, card, launches, worst, rows,
                smashed=args.p18_smashed)
        log(f"phase 18 alone: launches "
            f"{ {k: c for k, c in launches.items() if c} }")
        return 0
    if args.only == "19":
        launches, rows = {k: 0 for k in rows_of}, {}
        phase19(torch, dev, F, wrappers, name, card, launches, worst, rows)
        log(f"phase 19 alone: launches "
            f"{ {k: c for k, c in launches.items() if c} }")
        return 0

    lap("phase 2")
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
        check_flash_cases(torch, rand, dname, dt, errs, [
            (2, sq, sk, 4, 2, hd, True, window, q_offset)
            for sq, sk, hd, window, q_offset in FLASH_EDGES])
        check_training_kernels(torch, rand, dname, dt, errs)
        check_mamba2_kernels(torch, rand, dname, dt, errs)
        check_wide_kernels(torch, rand, dname, dt, dev, gen, errs, hd=128,
                           heads=LLAMA_HEADS, edge_heads=(4, 2), train_b=20,
                           what="llama3-8b", more=WIDE_128_STEPS)
        check_wide_kernels(torch, rand, dname, dt, dev, gen, errs, hd=112,
                           heads=KIMI_HEADS, edge_heads=(8, 1), train_b=5,
                           what="kimi-k2")
        check_dense_widths(torch, rand, dname, dt, gen, errs, kd=4096,
                           ns=(4096, 1024), m_evals=(10240,),
                           what="llama3-8b")
        check_dense_widths(torch, rand, dname, dt, gen, errs, kd=7168,
                           ns=(7168, 896), m_evals=(2560,), what="kimi-k2")
        check_whisper_kernels(torch, rand, dname, dt, dev, gen, errs)
        log(f"phase 2 ({dname}, tol {TOL[dname]}): max |kernel - plain| "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        if dname == "float32":
            worst = errs
    mma_build_report(_build, lib_path, sass())

    lap("phase 3")
    # -- phase 3: times at the paths' shapes (fp32) -------------------------
    rows = time_flash_cases(torch, F, rand, worst, [
        ("flash_attention_fwd", None, 1, PROMPT, PROMPT, 12, 12, 64, True,
         "serving prefill")])
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
    rows.update(time_whisper_kernels(torch, F, rand, dev, worst))
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

    lap("phase 4")
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
    del cpu_model, cpu_params, cpu_pool
    client_axis_check(torch, dev, wrappers, launches, model, params, pool,
                      "gpt2-small", name, card)
    del model, params, pool
    arch = get_config("mamba2-780m")
    arch = arch.replace(model=dataclasses.replace(
        arch.model, num_layers=CLIENT_SSM_LAYERS))
    model = build_model(arch, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    pool = serving.build_adapter_pool(
        model, torch.Generator().manual_seed(SEED + 1), len(RANKS))
    client_axis_check(torch, dev, wrappers, launches, model, params, pool,
                      f"mamba2-780m ({CLIENT_SSM_LAYERS} layers)", name, card)
    del model, params, pool

    lap("phase 5")
    # -- phase 5: the training path ------------------------------------------
    got, accuracy_times, fleet = train_phase(torch, dev, wrappers, name,
                                             card)
    for kname, c in got.items():
        launches[kname] += c

    lap("phase 5b, 5c")
    # -- phase 5b, 5c: checkpoint resume, the train CLI ----------------------
    resume_phase(torch, dev, wrappers, name, card)
    cli_phase(torch, wrappers, name, card)

    lap("phase 5d")
    # -- phase 5d: gpt2-small under the phase-time co-controller ------------
    for kname, c in co_phase(torch, dev, wrappers, name, card,
                             accuracy_times).items():
        launches[kname] += c

    lap("phases 5e-5h")
    # -- phases 5e-5h: local steps, two-tier FedAvg, async, trained serving -
    ls_system, got = local_steps_phase(torch, dev, wrappers, name, card)
    for phase in (got, edge_phase(torch, dev, wrappers, name, card),
                  async_phase(torch, dev, wrappers, name, card),
                  trained_serving_phase(torch, dev, wrappers, name, card,
                                        ls_system)):
        for kname, c in phase.items():
            launches[kname] += c
    del ls_system

    lap("phase 5i")
    # -- phase 5i: population mode ------------------------------------------
    for kname, c in population_phase(torch, dev, wrappers, name, card,
                                     accuracy_times, fleet).items():
        launches[kname] += c
    del fleet

    lap("phase 6")
    # -- phase 6: one step at full width, reduced depth, card vs CPU --------
    small_step_check(torch, dev, "gpt2-small", SMALL_SEQ, GPT2_STEPS,
                     "phase 6")
    engine_step_check(torch, dev)

    lap("phase 7, 7b")
    # -- phase 7, 7b: the mamba2 training path, batch 1 and batch 4 ---------
    for kname, c in mamba2_phase(torch, dev, wrappers, name, card).items():
        launches[kname] += c
    for kname, c in mamba2_batch4_phase(torch, dev, wrappers, name,
                                        card).items():
        launches[kname] += c

    lap("phase 8")
    # -- phase 8: one mamba2 step at full width, reduced depth, card vs CPU -
    small_step_check(torch, dev, "mamba2-780m", M_SEQ, MAMBA2_STEPS,
                     "phase 8")

    lap("phase 9, 9b")
    # -- phase 9, 9b: llama3-8b at full width, training and serving ---------
    system, got = llama_phase(torch, dev, wrappers, name, card)
    add_launches(launches, got, hd=128)
    add_launches(launches, llama_serving_phase(torch, dev, wrappers, name,
                                               card, system), hd=128)
    del system
    small_step_check(torch, dev, "llama3-8b", SMALL_SEQ, LLAMA_STEPS,
                     "phase 9 step", compressed="mean", wide=True)

    lap("phase 10")
    # -- phase 10: opt-125m and gpt-neo-125m, training and serving ----------
    for arch_name in GEN_ARCHS:
        add_launches(launches, generalizability_phase(
            torch, dev, wrappers, name, card, arch_name), hd=64)

    lap("phase 10b")
    # -- phase 10b: phi4-mini, qwen1.5-32b, mistral-large, card vs CPU ------
    for arch_name in DENSE_STEP_ARCHS:
        comp = get_config(arch_name).split.smashed_compress
        small_step_check(torch, dev, arch_name, DENSE_STEP_SEQ,
                         [("none", "none", {}), (comp, comp, {})],
                         "phase 10b", compressed="mean", wide=True)

    lap("phase 11")
    # -- phase 11: mamba2-780m serving at full width and depth ---------------
    add_launches(launches, mamba2_serving_phase(torch, dev, wrappers, name,
                                                card), hd=64)

    lap("phase 12")
    # -- phase 12: zamba2-1.2b at full width, training and serving ----------
    add_launches(launches, zamba2_phase(torch, dev, wrappers, name, card),
                 hd=64)

    lap("phase 13")
    # -- phase 13: kimi-k2 at full width, training and serving --------------
    add_launches(launches, kimi_phase(torch, dev, wrappers, name, card),
                 hd=112)

    lap("phase 13b")
    # -- phase 13b: kimi-k2, llama4-maverick, internvl2-76b, card vs CPU ----
    for hd, got in moe_vlm_steps(torch, dev, wrappers).items():
        add_launches(launches, got, hd=hd)

    lap("phase 14")
    # -- phase 14: whisper-medium at full width and depth, train and serve --
    add_launches(launches, whisper_phase(torch, dev, wrappers, name, card),
                 hd=64)

    lap("phase 14b")
    # -- phase 14b: whisper-medium, card vs CPU -----------------------------
    add_launches(launches, whisper_steps(torch, dev, wrappers), hd=64)

    lap("phase 15")
    # -- phase 15: the dry-run's serving cells at 32k and 500k --------------
    phase15(torch, dev, wrappers, name, card, F, launches, worst, rows,
            cells)

    lap("phase 16")
    # -- phase 16: the cohort split over ranks, NCCL and gloo ---------------
    for kname, c in phase16(torch, dev, wrappers, name, card).items():
        launches[kname] += c

    lap("phase 17")
    # -- phase 17: parameter sharding, TP over "model", NCCL and gloo ------
    phase17(torch, dev, F, wrappers, name, card, launches, worst, rows)

    lap("phase 18")
    # -- phase 18: parameter sharding, EP (MoE) and TP over SSM heads -------
    phase18(torch, dev, F, wrappers, name, card, launches, worst, rows)

    lap("phase 19")
    # -- phase 19: audio and vlm under TP and SP, the "pod" axis ------------
    phase19(torch, dev, F, wrappers, name, card, launches, worst, rows)

    lap("results")
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
               "decode_attention_partial": ("decode_attention.cu",
                                            f"{da}:187"),
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
    for kname in (P15_ROWS + P17_ROWS + P18_ROWS + P19_ROWS
                  + (PARTIAL_X_ROW,)):
        sources[kname] = sources[kname.split(" (")[0]]
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


def client_axis_check(torch, dev, wrappers, launches, model, params, pool,
                      what, name, card):
    """A cache with a client axis, Model.init_cache(CLIENT_LEAD): a
    prefill of PROMPT seeded tokens for N x B rows and CLIENT_STEPS decode
    steps fed seeded tokens, client n's rows served by adapter n (ids
    (N,): the indexed LoRA's rows are x's leading axis), against the same
    rows over a cache of lead (N B,), the ids repeated over B.  The
    logits within CLIENT_TOL x max|logit|, the argmax equal, and every
    wrapper's launches those of the (N B,) run, the flash and decode
    kernels' (and an SSM model's SSD scan with its final state) among
    them.  Adds both runs' launches to `launches`."""
    from repro_torch.runtime import serving

    n, b = CLIENT_LEAD
    cfg = model.cfg
    rng = np.random.default_rng(SEED + 40)
    prompt = rng.integers(3, cfg.vocab_size, (n, b, PROMPT)).astype(np.int32)
    fed = rng.integers(3, cfg.vocab_size,
                       (CLIENT_STEPS, n, b, 1)).astype(np.int32)
    ids = np.arange(n, dtype=np.int32)
    runs = {}
    for lead in (CLIENT_LEAD, (n * b,)):
        ad = serving.attach_ids(pool, ids if len(lead) == 2
                                else np.repeat(ids, b))
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        before = {k: w.launches for k, w in wrappers.items()}
        cache = model.init_cache(lead, MAX_LEN)
        with torch.no_grad():
            out, cache = model.prefill(params, ad, {"tokens": torch.as_tensor(
                prompt.reshape(lead + (PROMPT,)), device=dev)}, cache)
            out = [out]
            for tok in fed:
                lg, cache = model.decode_step(
                    params, ad, torch.as_tensor(tok.reshape(lead + (1,)),
                                                device=dev), cache)
                out.append(lg)
        torch.cuda.synchronize()
        counts = {k: w.launches - before[k] for k, w in wrappers.items()
                  if w.launches != before[k]}
        for k, c in counts.items():
            launches[k] += c
        logits = torch.cat(out, -2).float().cpu().numpy()
        runs[lead] = (logits.reshape((n * b,) + logits.shape[-2:]), counts,
                      time.perf_counter() - t0, tuple(cache["len"].shape))
    (got, got_c, got_s, got_len), (want, want_c, want_s, _) = (
        runs[CLIENT_LEAD], runs[(n * b,)])
    if not np.isfinite(got).all():
        raise RuntimeError(f"phase 4 client axis ({what}): non-finite "
                           "logits")
    gap = float(np.abs(got - want).max()) / float(np.abs(want).max())
    need = ["flash_attention_fwd", "decode_attention"]
    if cfg.family == "ssm":
        need = ["ssd_scan (final state)"]
    if gap > CLIENT_TOL or not np.array_equal(got.argmax(-1),
                                              want.argmax(-1)) \
            or got_c != want_c or any(not got_c.get(k) for k in need) \
            or got_len != (b,):
        raise RuntimeError(
            f"phase 4 client axis ({what}): logits {gap:.3e} x max|logit| "
            f"from the (N B,) lead's (tol {CLIENT_TOL}), tokens equal "
            f"{np.array_equal(got.argmax(-1), want.argmax(-1))}, launches "
            f"{got_c} vs {want_c} (each of {need} required), len {got_len}")
    log(f"phase 4 [{name}, {card}] client axis, {what}: a cache of lead "
        f"{CLIENT_LEAD} (len {got_len}), prefill of {PROMPT} + "
        f"{CLIENT_STEPS} decode steps == the same rows over lead "
        f"({n * b},): logits within {gap:.3e} x max|logit| (tol "
        f"{CLIENT_TOL}), tokens equal, launches {got_c} equal; walls "
        f"{got_s:.3f} s and {want_s:.3f} s")


def profile_run(torch, serving, engine, reqs, name, card, tag="phase 4"):
    """The same workload again on a warm engine under the profiler: the
    device-busy share of the serving wall time, and the top kernels."""
    again = [serving.Request(rid=2000 + r.rid, adapter=r.adapter,
                             tokens=r.tokens, max_new=r.max_new)
             for r in reqs]
    wall, busy, by_name, _ = device_busy(torch, lambda: engine.run(again),
                                         f"{tag} profile")
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


def check_flash_cases(torch, rand, dname, dt, errs, cases, show=0):
    """Phase 2: the flash forward and backward against their plain
    versions at each (B, Sq, Sk, H, KVH, hd, causal, window, q_offset) of
    `cases`; errs' rows at each case's head dim (hd_row) take the larger
    error.  The first `show` cases log their backward errors beside the
    gradients' scale."""
    from repro_torch.kernels.flash_attention import ops as fops

    for i, (b, sq, sk, hq, hk, hd, causal, window, q_offset) in enumerate(
            cases):
        q, do = rand(b, sq, hq, hd, dtype=dt), rand(b, sq, hq, hd, dtype=dt)
        k, v = rand(b, sk, hk, hd, dtype=dt), rand(b, sk, hk, hd, dtype=dt)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        desc = (f"B={b} Sq={sq} Sk={sk} H={hq} KVH={hk} hd={hd} "
                f"causal={causal} window={window} q_offset={q_offset}")
        fwd = hd_row("flash_attention_fwd", hd)
        bwd = hd_row("flash_attention_bwd", hd)
        out, lse = fops.flash_attention_fwd(q, k, v, **kw)
        r_out, r_lse = fops.ref.attention_fwd(q, k, v, **kw)
        errs[fwd] = max(errs[fwd],
                        max_err(torch, out, r_out, dname, f"flash {desc}"),
                        max_err(torch, lse, r_lse, dname,
                                f"flash lse {desc}"))
        got = fops.flash_attention_bwd(q, k, v, r_out, r_lse, do, **kw)
        want = fops.ref.attention_bwd(q, k, v, r_out, r_lse, do, **kw)
        e = [max_err(torch, g, w, dname, f"flash bwd {desc} d{n}")
             for n, g, w in zip("qkv", got, want)]
        errs[bwd] = max([errs[bwd]] + e)
        if i < show:
            log(f"phase 2 ({dname}): flash {desc}: max |kernel - plain| "
                f"dq, dk, dv [{', '.join(f'{x:.3e}' for x in e)}] at max "
                f"|dq|, |dk|, |dv| "
                f"{fmt(float(w.float().abs().max()) for w in want)}")
        del q, k, v, do, out, lse, r_out, r_lse, got, want
    torch.cuda.empty_cache()


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

    # flash forward and backward: 12 each per train step at B*H = 5
    # clients x 4 x 12 heads
    rows = time_flash_cases(torch, F, rand, errs, [
        ("flash_attention_fwd (gpt2 train)", "flash_attention_bwd", 20, 512,
         512, 12, 12, 64, True, "B*H=240, the gpt2 train and eval steps")])
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
    bwd_passes = check_kernels_per_call(
        torch, lambda: lops.lora_matmul_bwd(x, w, a, bb, sc, g, xa),
        LORA_BWD_PASSES, 3, 5, "fused LoRA backward")
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
        int8_passes[kname] = check_kernels_per_call(torch, fn, (kern,), 1,
                                                    1, kname)
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


def ssd_work(b, s, h, p, g, n, q, es, final_state):
    """(bytes, FLOPs, the C.B part of the FLOPs) of an SSD scan's bound:
    read x, dt, A, B, C once and write y (and the fp32 final state) once,
    x, B, C and y in `es`-byte elements; operations per (b, h, chunk)
    the inter-chunk term C . s (2 Q N P), the state update (2 Q P N) and
    the causal half of M @ x (2 Q(Q+1)/2 P), and per (b, group, chunk)
    the causal half of C . B (2 Q(Q+1)/2 N)."""
    nc, pairs = s // q, q * (q + 1) // 2
    cb_flops = b * nc * g * 2 * pairs * n
    flops = b * nc * h * (4 * q * n * p + 2 * pairs * p) + cb_flops
    nbytes = es * (2 * b * s * h * p + 2 * b * s * g * n) \
        + 4 * (b * s * h + h + (b * h * p * n if final_state else 0))
    return nbytes, flops, cb_flops


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
    The bound is ssd_work's."""
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
    nbytes, flops, cb_flops = ssd_work(b, s, h, p, g, n, q, 4, final_state)
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
        torch, lambda: (train.fn(*train.last), ev.fn(*ev.last)),
        f"{tag} profile")
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
    from repro_torch.runtime.sharding import shard_client_batch
    from repro_torch.tree import tree_leaves, tree_map

    for w in wrappers.values():
        w.launches = 0
    params, eff = system.serve_model()
    eff = tree_map(lambda x: x.detach().requires_grad_(True), eff)
    # this rank's rows of the batch under a split cohort (phase 16)
    ebatch = shard_client_batch(system.eval_step.last[2], system.cohort)
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
                                      name, card, host_profile=True,
                                      draw_on_device=True)
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
                                           "phase 7b", name, card,
                                           draw_on_device=True)
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
    model's expert count).  wide=True (phases 9, 10b and 13b: models of 2
    to 25 GB) draws the weights on the card (``redraw``), where the card's
    step uses them, copies them to the CPU once for the CPU's step
    (``to_host``; a CPU draw takes minutes) and logs the host's free
    memory before each step.  An MoE model's CPU
    step routes by the card's top-k choices
    (recorded_routing's replay), since a choice flipped on a near-tie of
    the router's probabilities would move its token's expert output
    wholesale; the number of (token, choice) pairs that the CPU would
    have chosen otherwise is logged, and the step is held as any other.
    The vlm family's batch carries the prefix that Model.input_specs
    gives a train batch (normal x 0.02, as the reference's tests draw
    it), and the loss mask drops the labels inside it; the audio
    family's carries its frames, drawn the same way.
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
    if "frames" in specs:
        frames = frames_of(rng, specs["frames"][0])
    weights = np.array([0.25, 0.75], np.float32)
    buckets = CO_SYS["compressor_buckets"]
    out = {}
    # one draw of the weights (on the CPU, as init_params draws them, or
    # for a wide model on the card), copied to the other side
    card_params = None
    if wide:
        card_params = redraw(torch, dev, arch)
        cpu_params = to_host(torch, card_params)
    else:
        cpu_params = build_model(arch, device="cpu").init_params(
            torch.Generator().manual_seed(SEED))
    moe = arch.model.family == "moe"
    routes = {}
    launches = {}
    for role, dv in (("card", dev), ("cpu", torch.device("cpu"))):
        model = build_model(arch, device=dv)
        params = (card_params if role == "card" and card_params is not None
                  else tree_map(lambda t: t.to(dv), cpu_params))
        card_params = None
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
            if "frames" in specs:
                batch["frames"] = frames[:, :b]
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
    """Adds a path's launches to the result line's counts, each at its row
    for head dim `hd` (hd_row)."""
    for kname, c in got.items():
        launches[hd_row(kname, hd)] += c


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

    h, kvh = heads
    cases = [(2, sq, sk, *edge_heads, hd, True, window, q_offset)
             for sq, sk, _, window, q_offset in FLASH_EDGES]
    cases += [(b, s, s, hq, hk, hd, True, 0, 0)
              for b, s, hq, hk in [(train_b, 512, h, kvh), (1, PROMPT, h, kvh),
                                   *more]]
    check_flash_cases(torch, rand, dname, dt, errs, cases)
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


def check_dense_widths(torch, rand, dname, dt, gen, errs, *, kd, ns, m_evals,
                       what, seq=512, requests=(), grads=False):
    """Phase 2 at a model's widths (llama3-8b: K = 4096 into N = 4096 for
    q, o and 1024 for k, v; kimi-k2: K = 7168 into 7168 and 896;
    whisper-medium: K = N = 1024): the indexed LoRA at a tick and a
    prefill (M = SLOTS and PROMPT rows over 4 adapters) and at the x of
    each (B, S) of `requests` (request i on adapter i % W_ADAPTERS), the
    fused LoRA forward at each M of `m_evals` (5 clients x batch x seq:
    the eval step's) and, with `grads`, its backward there, each against
    its plain version at r 16; the int8 quantizers at d = K over G 5
    messages of m_evals[0] / 5 rows (batch x `seq`) bit for bit.  At K =
    4096 the indexed LoRA adds 64 K slices in order (12 at gpt2's 768);
    at d = 4096 the int8 kernels run 64 clusters a message."""
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
        cases = [((m,), torch.randint(0, p, (m,), generator=gen,
                                      dtype=torch.int32))
                 for m in (SLOTS, PROMPT)]
        cases += [(shape, torch.arange(shape[0], dtype=torch.int32)
                   % W_ADAPTERS) for shape in requests]
        for shape, ids in cases:
            x, ids = rand(*shape, kd, dtype=dt), ids.to(dev)
            errs["lora_matmul_indexed"] = max(
                errs["lora_matmul_indexed"],
                max_err(torch, lops.lora_matmul_indexed(x, w, a, b, scale,
                                                        ids),
                        lops.ref.lora_matmul_indexed(x, w, a, b, scale, ids),
                        dname, f"indexed LoRA x{shape} K={kd} N={n}"))
        sc = torch.tensor(2.0, device=dev)
        for m in m_evals:
            x = rand(m, kd, dtype=dt)
            what_m = f"M={m} K={kd} N={n}"
            y, xa = lops.lora_matmul_fwd(x, w, a[0], b[0], sc)
            want_y, want_xa = lops.ref.lora_matmul_fwd(x, w, a[0], b[0], sc)
            errs["lora_matmul_fwd"] = max(
                [errs["lora_matmul_fwd"]]
                + [max_err(torch, g, wt, dname, f"fused LoRA {part} {what_m}",
                           scaled=True)
                   for part, g, wt in (("y", y, want_y), ("xa", xa, want_xa))])
            if grads:
                g = rand(m, n, dtype=dt)
                errs["lora_matmul_bwd"] = max(
                    [errs["lora_matmul_bwd"]]
                    + [max_err(torch, got, want, dname,
                               f"fused LoRA bwd {what_m} {i}", scaled=True)
                       for i, (got, want) in enumerate(zip(
                           lops.lora_matmul_bwd(x, w, a[0], b[0], sc, g,
                                                want_xa),
                           lops.ref.lora_matmul_bwd(x, w, a[0], b[0], sc, g,
                                                    want_xa)))])
    xs = rand(5, m_evals[0] // (5 * seq), seq, kd, dtype=dt)
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
        f"{PROMPT}; x of {list(requests)}) and the fused LoRA forward"
        f"{' and backward' if grads else ''} (M = {list(m_evals)}) agree "
        f"with their plain versions, the int8 kernels (d = {kd}, "
        f"{tuple(xs.shape)}) bit for bit")


def time_flash_cases(torch, F, rand, errs, cases):
    """Phase 3: the flash kernels (fp32) at each (forward row, backward row
    or None, B, Sq, Sk, H, KVH, hd, causal, what) of `cases`.  Each timed
    call's result is first held against its plain version (errs' row at
    hd takes the larger error), then timed beside it and SDPA (the
    backward through autograd).  Bounds: 4 hd FLOPs per visible pair
    forward (s and p v), 10 hd backward (s, dp, dq, dk, dv), at 3xTF32,
    the CUDA-core bound beside them; a pair is visible in all Sq Sk
    non-causal, in Sq (Sq + 1) / 2 causal."""
    from repro_torch.kernels.flash_attention import ops as fops

    rows = {}
    for fkey, bkey, b, sq, sk, h, kvh, hd, causal, what in cases:
        fwd = hd_row("flash_attention_fwd", hd)
        bwd = hd_row("flash_attention_bwd", hd)
        q, k, v = rand(b, sq, h, hd), rand(b, sk, kvh, hd), rand(b, sk, kvh, hd)
        out, lse = fops.flash_attention_fwd(q, k, v, causal=causal)
        r_out, r_lse = fops.ref.attention_fwd(q, k, v, causal=causal)
        errs[fwd] = max(errs[fwd],
                        max_err(torch, out, r_out, "float32", f"{fkey} out"),
                        max_err(torch, lse, r_lse, "float32", f"{fkey} lse"))
        del r_out, r_lse
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        sdpa = dict(is_causal=causal, enable_gqa=h != kvh)
        pairs = b * h * (sq * (sq + 1) // 2 if causal else sq * sk)
        shape = (f"B={b} Sq={sq} Sk={sk} H={h} KVH={kvh} hd={hd} "
                 f"{'causal' if causal else 'non-causal'} fp32 ({what})")
        with torch.no_grad():
            rows[fkey] = dict(
                ms=cuda_ms(torch, lambda: fops.flash_attention_fwd(
                    q, k, v, causal=causal), iters=20),
                plain_ms=cuda_ms(torch, lambda: fops.ref.attention_fwd(
                    q, k, v, causal=causal), iters=5),
                library_ms=cuda_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, **sdpa), iters=20),
                # read q, k, v; write out, lse
                **work(4 * (2 * b * sq * h * hd + 2 * b * sk * kvh * hd
                            + b * h * sq), 4 * hd * pairs, products=True),
                shape=shape)
        if bkey is not None:
            do = rand(b, sq, h, hd)
            errs[bwd] = max([errs[bwd]] + [
                max_err(torch, g, w, "float32", f"{bkey} d{n}")
                for n, g, w in zip("qkv", fops.flash_attention_bwd(
                    q, k, v, out, lse, do, causal=causal),
                    fops.ref.attention_bwd(q, k, v, out, lse, do,
                                           causal=causal))])
            o_lib = F.scaled_dot_product_attention(qt, kt, vt, **sdpa)
            do_t = do.transpose(1, 2).contiguous()
            rows[bkey] = dict(
                ms=cuda_ms(torch, lambda: fops.flash_attention_bwd(
                    q, k, v, out, lse, do, causal=causal), iters=20),
                plain_ms=cuda_ms(torch, lambda: fops.ref.attention_bwd(
                    q, k, v, out, lse, do, causal=causal), iters=5),
                library_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                    o_lib, (qt, kt, vt), do_t, retain_graph=True), iters=20),
                # read q, k, v, out, do, lse; write dq, dk, dv
                **work(4 * (4 * b * sq * h * hd + 4 * b * sk * kvh * hd
                            + b * h * sq), 10 * hd * pairs, products=True),
                shape=shape + "; library = SDPA backward through autograd")
            del do, o_lib, do_t
        del q, k, v, out, lse, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def time_wide_kernels(torch, F, rand, dev, gen, errs, *, hd, heads, train_b,
                      what):
    """Phase 3 at head dim `hd` (fp32), at a wide model's shapes (128:
    llama3-8b's 32 heads over 8, 5 clients x batch 4; 112: kimi-k2's 64
    over 8, 5 clients x batch 1): the flash forward and backward at its
    train step (B `train_b`, S 512, causal) and the forward at its serving
    prefill (B 1, S PROMPT) (time_flash_cases), and the decode kernels at
    its tick (SLOTS slots, cache lengths 128..156), contiguous and paged.
    Each timed call's result is first held against its plain version
    (errs takes the larger error)."""
    from repro_torch.kernels.decode_attention import ops as dops

    h, kvh = heads
    rows = time_flash_cases(torch, F, rand, errs, [
        (hd_row("flash_attention_fwd", hd), hd_row("flash_attention_bwd", hd),
         train_b, 512, 512, h, kvh, hd, True, f"the {what} train step"),
        (f"flash_attention_fwd (hd {hd}, prefill)", None, 1, PROMPT, PROMPT,
         h, kvh, hd, True, f"the {what} serving prefill")])
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
        ce_chunk=LLAMA_CE_CHUNK, draw_on_device=True)
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
            torch, lambda: model.decode_step(params, ad, one, cache),
            f"{tag} decode profile")
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
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
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
                                               "phase 12", name, card,
                                               draw_on_device=True)
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

    def recording(cfg, yg, router, **kw):
        got = route(cfg, yg, router, **kw)
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


# the page-locked host buffer that to_host copies wide weights into, while
# pinned_host holds one (phase 13b)
_HOST = {"arena": None}


def _host_sizes(tree):
    from repro_torch.tree import tree_leaves

    return [-(-x.numel() * x.element_size() // 64) * 64
            for x in tree_leaves(tree)]


def wide_bytes(torch, arch) -> int:
    """The host bytes to_host takes for `arch`'s weights (a fake draw)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.model import build_model

    with FakeTensorMode(allow_non_fake_inputs=True):
        params = build_model(arch, device="cpu").init_params(
            torch.Generator().manual_seed(SEED))
    return sum(_host_sizes(params))


@contextlib.contextmanager
def pinned_host(torch, nbytes: int):
    """While open, to_host copies into one host buffer of nbytes that CUDA
    has page-locked (cudaHostRegister), unregistered and freed on exit.
    Locking costs ~0.7 s a GiB once, and a copy into it ~0.02 s a GiB,
    where a copy into fresh pageable memory (`.cpu()`) costs ~0.5 s a
    GiB every time (on an H100 host: 24.11 GiB locked in 17.14 s; 15
    GiB copied pageable in 7.57–8.38 s), so models that take turns
    share it."""
    t0 = time.perf_counter()
    buf = torch.empty(nbytes, dtype=torch.uint8)
    rt = torch.cuda.cudart()
    torch.cuda.check_error(rt.cudaHostRegister(buf.data_ptr(), nbytes, 0))
    log(f"pinned {nbytes / 2**30:.2f} GiB of host memory in "
        f"{time.perf_counter() - t0:.2f} s")
    _HOST["arena"] = buf
    try:
        yield
    finally:
        _HOST["arena"] = None
        torch.cuda.check_error(rt.cudaHostUnregister(buf.data_ptr()))
        del buf


def to_host(torch, tree):
    """A tree of card tensors on the host: views of pinned_host's buffer,
    valid until the next call, while one is open; else pageable copies."""
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    arena = _HOST["arena"]
    if arena is None:
        return tree_map(lambda t: t.cpu(), tree)
    sizes = _host_sizes(tree)
    if sum(sizes) > arena.numel():
        raise RuntimeError(f"{sum(sizes)} bytes of weights for a pinned "
                           f"buffer of {arena.numel()}")
    out, off = [], 0
    for x, n in zip(tree_leaves(tree), sizes):
        view = arena[off:off + x.numel() * x.element_size()].view(
            x.dtype).view(x.shape)
        view.copy_(x)
        out.append(view)
        off += n
    return tree_unflatten(tree, out)


def redraw(torch, dev, arch):
    """small_step_check's wide weights, drawn on the card from SEED: the
    same bits at every call."""
    from repro_torch.models.model import build_model

    return build_model(arch, device=dev).init_params(
        torch.Generator(device=dev).manual_seed(SEED))


def decode_check(torch, dev, arch, cpu_params, tag, drawn=False):
    """Prefill of one PROMPT-token request (for the audio family with its
    encoder frames) and 4 decode steps through the indexed pool (ranks
    RANKS), on the card and on the CPU from the same weights: the card's
    tokens fed to both, logits within LOGITS_TOL and each step's token
    equal; an MoE model's top-k choices' flips are logged.  drawn: the
    CPU's weights are small_step_check's wide draw, which the card draws
    again (redraw) instead of copying them back."""
    from repro_torch.models.model import build_model
    from repro_torch.runtime import serving
    from repro_torch.tree import tree_map

    m = arch.model
    rng = np.random.default_rng(SEED + 13)
    prompt = {"tokens": rng.integers(3, m.vocab_size, size=(1, PROMPT))
              .astype(np.int32)}
    if m.family == "audio":
        prompt["frames"] = frames_of(rng, (1, m.encoder_seq_len, m.d_model))
    outs, toks, routes = {}, [], {}
    for role, dv in (("card", dev), ("cpu", torch.device("cpu"))):
        model = build_model(arch, device=dv)
        params = (redraw(torch, dev, arch) if drawn and role == "card"
                  else tree_map(lambda t: t.to(dv), cpu_params))
        pool = serving.build_adapter_pool(
            model, torch.Generator().manual_seed(SEED + 1), len(RANKS),
            ranks=RANKS)
        ad = serving.attach_ids(pool, [1])
        with torch.no_grad(), recorded_routing() as calls:
            cache = model.init_cache((1,), MAX_LEN)
            lg, cache = model.prefill(params, ad, {
                k: torch.as_tensor(v, device=dv) for k, v in prompt.items()},
                cache)
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
    log(f"{tag}: prefill of {PROMPT} tokens"
        + (f" over {m.encoder_seq_len} frames" if "frames" in prompt else "")
        + f" + 4 decode steps, card vs CPU: "
        f"max |logit diff| {diff:.3e} (tol {LOGITS_TOL}), tokens {toks} vs "
        f"{cpu_toks}" + (f", {flips} top-k choices flipped"
                         if m.family == "moe" else ""))
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
    each followed by decode_check; internvl2-76b (hd 128, d_ff 28672)
    over a batch with its 256-position prefix at seq VLM_SEQ.  Each
    card step must launch the flash forward and backward.  The three
    models' CPU weights take turns in one pinned host buffer
    (pinned_host).  Returns the launches by head dim."""
    by_hd = {}
    steps = [("none", "none", {}), ("int8", "int8", {})]
    models = ((KIMI, DENSE_STEP_SEQ, dict(num_experts=MOE_STEP_EXPERTS)),
              (LLAMA4, DENSE_STEP_SEQ, dict(num_experts=MOE_STEP_EXPERTS)),
              (VLM, VLM_SEQ, {}))
    with pinned_host(torch, max(wide_bytes(torch, small_arch(a, kw))
                                for a, _, kw in models)):
        for arch_name, seq, kw in models:
            arch = small_arch(arch_name, kw)
            m = arch.model
            plen = m.frontend_prefix_len if m.family == "vlm" else 0
            log(f"phase 13b: {arch_name} at full width, {SMALL_LAYERS} "
                "layers" + (f", {m.num_experts} experts top-{m.moe_top_k}"
                            if m.num_experts else "")
                + f", d_model {m.d_model}, {m.num_heads} heads over "
                f"{m.num_kv_heads} of {m.head_dim}, seq {seq}"
                + (f" ({plen} prefix positions)" if plen else ""))
            cpu_params, got = small_step_check(
                torch, dev, arch_name, seq, steps, "phase 13b",
                compressed="mean", model_kw=kw, wide=True, wrappers=wrappers)
            idle = [k for k in ("flash_attention_fwd", "flash_attention_bwd")
                    if not got[k]]
            if idle:
                raise RuntimeError(f"phase 13b {arch_name}: never launched "
                                   f"{idle}")
            if m.num_experts:
                decode_check(torch, dev, arch, cpu_params,
                             f"phase 13b {arch_name} serving", drawn=True)
            del cpu_params
            acc = by_hd.setdefault(m.head_dim, {})
            for k, c in got.items():
                acc[k] = acc.get(k, 0) + c
    return by_hd


def whisper_flash():
    """whisper-medium's attention at phase 14's train step (5 clients x
    batch W_BATCH, 16 heads of 64, MHA): (what, B, Sq, Sk, H, hd, causal)
    of the encoder's self-attention (non-causal, S 1500: 23 full 64-key
    tiles and a tail of 28; each key sums 1500 queries in the backward,
    past the fp32 flush of every 8 query tiles), the cross-attention
    (non-causal, Sq W_SEQ over Sk 1500) and the decoder's self-attention
    (causal, S W_SEQ)."""
    from repro_torch.configs import get_config

    m = get_config(WHISPER).model
    b, h, hd, enc = 5 * W_BATCH, m.num_heads, m.head_dim, m.encoder_seq_len
    return [("encoder", b, enc, enc, h, hd, False),
            ("cross", b, W_SEQ, enc, h, hd, False),
            ("decoder", b, W_SEQ, W_SEQ, h, hd, True)]


def check_whisper_kernels(torch, rand, dname, dt, dev, gen, errs):
    """Phase 2 at whisper-medium's shapes: the flash forward and backward
    at whisper_flash() and FLASH_NONCAUSAL_EDGES (B 2, GQA 4/2); the LoRA
    and int8 kernels at its widths (check_dense_widths: the fused LoRA
    forward and backward at the eval step's and the global-adapter
    gradient's M of 7500 encoder and 2240 decoder rows, the indexed LoRA
    at phase 14's served batches, the int8 kernels over 1500-row
    messages); and the decode kernel as the cross read (W_REQUESTS slots,
    cache_len 1500 for each) against the flash forward's plain version at
    Sq 1, non-causal.  Each against its plain version."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops

    m = get_config(WHISPER).model
    h, hd, enc = m.num_heads, m.head_dim, m.encoder_seq_len
    check_flash_cases(torch, rand, dname, dt, errs, [
        (b, sq, sk, hq, hq, d, causal, 0, 0)
        for _, b, sq, sk, hq, d, causal in whisper_flash()] + [
        (2, sq, sk, 4, 2, d, False, window, q_offset)
        for sq, sk, d, window, q_offset in FLASH_NONCAUSAL_EDGES], show=3)
    b = 5 * W_BATCH
    check_dense_widths(
        torch, rand, dname, dt, gen, errs, kd=m.d_model, ns=(m.d_model,),
        m_evals=(b * enc, b * W_SEQ), what=WHISPER, seq=enc, grads=True,
        requests=((W_REQUESTS, 1), (W_REQUESTS, W_PROMPT),
                  (W_REQUESTS, enc), (1, enc)))
    q = rand(W_REQUESTS, h, hd, dtype=dt)
    k, v = rand(W_REQUESTS, enc, h, hd, dtype=dt), rand(W_REQUESTS, enc, h,
                                                        hd, dtype=dt)
    full = torch.full((W_REQUESTS,), enc, dtype=torch.int32, device=dev)
    want, _ = fops.ref.attention_fwd(q[:, None].contiguous(), k, v,
                                     causal=False)
    errs["decode_attention"] = max(
        errs["decode_attention"],
        max_err(torch, dops.decode_attention(q, k, v, full), want[:, 0],
                dname, "decode as the whisper cross read"))
    del q, k, v, want
    torch.cuda.empty_cache()
    log(f"phase 2 ({dname}): whisper's flash shapes (encoder {enc} x {enc} "
        f"and cross {W_SEQ} x {enc} non-causal, decoder {W_SEQ} causal, B "
        f"{b}, {h} heads of {hd}), {len(FLASH_NONCAUSAL_EDGES)} non-causal "
        f"edges and the decode kernel as the cross read at cache_len {enc}: "
        f"max |kernel - plain| so far flash fwd "
        f"{errs['flash_attention_fwd']:.3e}, bwd "
        f"{errs['flash_attention_bwd']:.3e}, decode "
        f"{errs['decode_attention']:.3e}")


def time_whisper_kernels(torch, F, rand, dev, errs):
    """Phase 3 at whisper-medium's shapes (fp32): the flash forward and
    backward at whisper_flash() (time_flash_cases); the decode kernel as
    the cross read (W_REQUESTS slots at cache_len 1500); the indexed LoRA
    at a request's prefill of the encoder (M = 1500 rows of one adapter,
    K = N = 1024, r 16).  Each timed call's result is first held against
    its plain version; the library calls are SDPA and none for the
    indexed LoRA."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.lora_matmul import ops as lops

    cfg = get_config(WHISPER).model
    h, hd, enc = cfg.num_heads, cfg.head_dim, cfg.encoder_seq_len
    rows = time_flash_cases(torch, F, rand, errs, [
        (f"flash_attention_fwd (whisper {w})",
         f"flash_attention_bwd (whisper {w})", b, sq, sk, hq, hq, d, causal,
         f"the whisper train step's {w} attention")
        for w, b, sq, sk, hq, d, causal in whisper_flash()])
    n = W_REQUESTS
    q1 = rand(n, h, hd)
    kc, vc = rand(n, enc, h, hd), rand(n, enc, h, hd)
    full = torch.full((n,), enc, dtype=torch.int32, device=dev)
    errs["decode_attention"] = max(errs["decode_attention"], max_err(
        torch, dops.decode_attention(q1, kc, vc, full),
        fops.ref.attention_fwd(q1[:, None].contiguous(), kc, vc,
                               causal=False)[0][:, 0], "float32",
        "whisper cross read"))
    ks, vs = (t.transpose(1, 2).contiguous() for t in (kc, vc))
    chunk = _build.library().decode_attention_chunk()
    rows["decode_attention (whisper cross read)"] = dict(
        ms=cuda_ms(torch, lambda: dops.decode_attention(q1, kc, vc, full)),
        plain_ms=cuda_ms(torch, lambda: dops.ref.decode_attention(
            q1, kc, vc, full)),
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q1[:, :, None, :], ks, vs)),
        passes=pass_ms(torch, lambda: dops.decode_attention(q1, kc, vc, full),
                       ("decode_kernel",), launches=True),
        # read q, the cross cache, the lengths; write out
        **work(4 * (2 * n * h * hd + 2 * n * enc * h * hd + n),
               4 * n * enc * h * hd),
        shape=f"B={n} cache_len {enc} for every slot, H={h} hd={hd} fp32 "
              f"(a whisper decode step's cross read), "
              f"{h * n * ((enc - 1) // chunk + 1)} CTAs")

    kd, r, m = cfg.d_model, 16, enc
    x = rand(m, kd)
    w = rand(kd, kd, scale=kd ** -0.5)
    a = rand(W_ADAPTERS, kd, r, scale=r ** -0.5)
    bb = rand(W_ADAPTERS, r, kd, scale=0.02)
    sc = torch.full((W_ADAPTERS,), 2.0, device=dev)
    ids = torch.full((m,), 1, dtype=torch.int32, device=dev)
    args = (x, w, a, bb, sc, ids)
    errs["lora_matmul_indexed"] = max(
        errs["lora_matmul_indexed"],
        max_err(torch, lops.lora_matmul_indexed(*args),
                lops.ref.lora_matmul_indexed(*args), "float32",
                f"indexed LoRA M={m} K=N={kd}"))
    rows["lora_matmul_indexed (whisper prefill)"] = dict(
        ms=cuda_ms(torch, lambda: lops.lora_matmul_indexed(*args)),
        plain_ms=cuda_ms(torch, lambda: lops.ref.lora_matmul_indexed(*args)),
        library_ms=None,
        passes=pass_ms(torch, lambda: lops.lora_matmul_indexed(*args),
                       ("lora_indexed_kernel",), launches=True),
        # read x, W, one adapter's A and B, the scales and ids; write y
        **work(4 * (2 * m * kd + kd * kd + 2 * kd * r + W_ADAPTERS + m),
               2 * m * kd * kd + 4 * m * kd * r, products=True),
        shape=f"M={m} K=N={kd} r={r} one adapter fp32 (a whisper request's "
              f"encoder q/k/v/o in its prefill), "
              f"{_build.library().lora_indexed_ctas(m, kd, kd)} CTAs")
    return rows


def whisper_arch():
    """whisper-medium at full width and depth, phase 14's setting: 5
    clients x batch W_BATCH x seq W_SEQ; the config's cut 4 (inside the
    encoder), r_cut 8, r_others 16 and smashed default ("none")."""
    import dataclasses

    from repro_torch.configs import get_config

    arch = get_config(WHISPER)
    return arch.replace(
        train=dataclasses.replace(arch.train, batch_size=W_BATCH,
                                  seq_len=W_SEQ),
        data=dataclasses.replace(arch.data, num_clients=5))


def frames_of(rng, shape):
    """Stub frontend frames as the reference's tests draw them: normal x
    0.02, fp32."""
    return (rng.standard_normal(shape, dtype=np.float32) * 0.02)


def whisper_phase(torch, dev, wrappers, name, card):
    """Phase 14: whisper_arch() at full width and depth, weights drawn on
    the card from SEED.  ROUNDS rounds of the round engine's own steps
    (rounds.init_state, make_train_step, make_eval_step) in a thin loop:
    tokens and labels from the data pipeline (the synthetic corpus,
    HashTokenizer, the length-Dirichlet partition, as SplitFTSystem draws
    them), frames drawn from SEED per round, FedAvg weights by sample
    counts.  A train step launches the flash forward and backward once
    per encoder layer and twice per decoder layer (self and cross); an
    eval step the flash forward as often and the fused LoRA forward per
    layer and target.  Peak device memory below PEAK_SHARE of the
    card, finite losses.  Then the global-adapter gradient (the fused
    LoRA backward), then serving the trained adapters: W_REQUESTS
    requests over W_ADAPTERS of them, each with its own frames and a
    W_PROMPT-token prompt, W_NEW new tokens, batched (one prefill of all
    of them, then decode steps) and each alone; tokens batched equal to
    alone up to a top-2 gap (decided_steps), the served logits within
    LOGITS_TOL of the card's own train-mode forward over the same frames
    and tokens.  Returns the launches of the path."""
    from repro_torch.core import rounds, split
    from repro_torch.data import (HashTokenizer, make_client_loaders,
                                  partition_dataset, stack_client_batches,
                                  synthetic_corpus)
    from repro_torch.models.model import build_model
    from repro_torch.runtime import serving
    from repro_torch.tree import tree_leaves, tree_map

    arch = whisper_arch()
    m, t = arch.model, arch.train
    n, enc_l, dec_l = arch.data.num_clients, m.num_encoder_layers, m.num_layers
    targets = len(arch.lora.targets)
    t0 = time.perf_counter()
    model = build_model(arch, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    n_params = sum(p.numel() for p in tree_leaves(params))
    tok = HashTokenizer(m.vocab_size)
    samples = [np.asarray(tok.encode(s), np.int32)
               for s in synthetic_corpus(NUM_SAMPLES, seed=arch.data.seed)]
    parts = partition_dataset(
        [len(s) for s in samples], n, strategy=arch.data.partition,
        alpha=arch.data.alpha, num_classes=arch.data.num_length_classes,
        seed=arch.data.seed)
    loaders = make_client_loaders(samples, parts, batch_size=t.batch_size,
                                  seq_len=t.seq_len, seed=SEED)
    ev_tokens = [np.asarray(tok.encode(s), np.int32) for s in
                 synthetic_corpus(EVAL_SAMPLES, seed=arch.data.seed + 777)]
    ev_loaders = make_client_loaders(
        ev_tokens, [np.arange(len(ev_tokens))] * n, batch_size=t.batch_size,
        seq_len=t.seq_len, seed=SEED + 999)
    weights = np.array([len(p) for p in parts], np.float32)
    active = np.ones(n, np.float32)
    rng = np.random.default_rng(SEED + 14)
    state = rounds.init_state(model, torch.Generator().manual_seed(SEED + 3),
                              num_clients=n)
    train = TimedStep(torch, rounds.make_train_step(
        model, smashed_compress=arch.split.smashed_compress), wrappers)
    ev = TimedStep(torch, rounds.make_eval_step(model), wrappers)
    log(f"phase 14: {arch.name} at full width and depth: {enc_l} encoder + "
        f"{dec_l} decoder layers, d_model {m.d_model}, {m.num_heads} heads "
        f"of {m.head_dim}, d_ff {m.d_ff}, vocab {m.vocab_size} untied, "
        f"{m.encoder_seq_len} frames; {n_params / 1e6:.1f}M parameters drawn "
        f"on the card; {n} clients (samples {weights.astype(int).tolist()}) "
        f"x batch {t.batch_size} x seq {t.seq_len}, cut "
        f"{arch.split.cut_layer} (inside the encoder), r_cut "
        f"{arch.lora.r_cut} r_others {arch.lora.r_others}, smashed "
        f"{arch.split.smashed_compress}, {t.optimizer} lr {t.lr_client}; "
        f"built in {time.perf_counter() - t0:.1f} s")

    def with_frames(batch):
        batch["frames"] = frames_of(rng, (n, t.batch_size, m.encoder_seq_len,
                                          m.d_model))
        return batch

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for r in range(ROUNDS):
        batch = with_frames(stack_client_batches([ld.batch(r)
                                                  for ld in loaders]))
        state, met = train(params, state, batch, weights, active,
                           t.lr_client, t.lr_server)
        ebatch = with_frames(stack_client_batches([ld.batch(r)
                                                   for ld in ev_loaders]))
        e_loss, e_met = ev(params, state, ebatch, weights)
        vals = [met["ce"], met["accuracy"], e_met["ce"], e_met["accuracy"]]
        if not all(torch.isfinite(v).all() for v in vals):
            raise RuntimeError(f"phase 14 round {r}: non-finite loss")
        log(f"phase 14 round {r} [{name}, {card}]: train ce "
            f"{fmt(vals[0].cpu())} acc {fmt(vals[1].cpu())}; eval ce "
            f"{fmt(vals[2].cpu())} acc {fmt(vals[3].cpu())}; train step "
            f"{train.calls[-1][2] * 1e3:.1f} ms, eval step "
            f"{ev.calls[-1][2] * 1e3:.1f} ms; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    got = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    per_round = [(c, tl, el) for (c, tl, _), (_, el, _) in
                 zip(train.calls, ev.calls)]
    attn = enc_l + 2 * dec_l
    check_launches(
        per_round,
        lambda p: {"flash_attention_fwd": attn, "flash_attention_bwd": attn},
        {"flash_attention_fwd": attn,
         "lora_matmul_fwd": targets * (enc_l + dec_l)},
        "whisper training")
    total = torch.cuda.get_device_properties(0).total_memory
    if peak > PEAK_SHARE * total:
        raise RuntimeError(f"phase 14: peaks at {peak / 2**30:.2f} GiB, over "
                           f"{PEAK_SHARE} of the card's "
                           f"{total / 2**30:.2f} GiB")
    nonzero = lambda d: {k: c for k, c in d.items() if c}  # noqa: E731
    log(f"phase 14 [{name}, {card}]: train step "
        f"{fmt([c[2] * 1e3 for c in train.calls])} ms "
        f"({n * t.batch_size * (t.seq_len + m.encoder_seq_len) / train.calls[-1][2]:.0f}"
        f" decoder + encoder positions/s), eval step "
        f"{fmt([c[2] * 1e3 for c in ev.calls])} ms; launches per train step "
        f"{nonzero(per_round[-1][1])}, per eval step "
        f"{nonzero(per_round[-1][2])}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB of the card's {total / 2**30:.2f} GiB")
    wall, busy, by_name, _ = device_busy(
        torch, lambda: (train.fn(*train.last), ev.fn(*ev.last)),
        "phase 14 profile")
    if busy is not None:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log(f"phase 14 profile [{name}, {card}]: one train + one eval step "
            f"under torch.profiler: wall {wall:.3f} s, device busy "
            f"{busy:.3f} s (idle share {1 - busy / wall:.3f}); top device "
            f"time: " + "; ".join(f"{k[:60]} {v * 1e3:.1f} ms"
                                  for k, v in top))
    else:
        log(f"phase 14 profile [{name}, {card}]: device busy share not "
            f"measured (the profiler recorded no device activity)")

    # the global model's eval-loss gradient w.r.t. its served adapters
    for w in wrappers.values():
        w.launches = 0
    eff = split.serve_adapters(model, state["client_adapters"],
                               state["server_adapters"], state["cuts"],
                               weights)
    eff = tree_map(lambda x: x.detach().requires_grad_(True), eff)
    with torch.enable_grad():
        per, _ = model.loss(params, eff, {
            k: torch.as_tensor(v, device=dev) for k, v in ev.last[2].items()},
            per_client=True)
        grads = torch.autograd.grad(per.sum(), tree_leaves(eff))
    torch.cuda.synchronize()
    n_ad = targets * (enc_l + dec_l)
    if not all(torch.isfinite(g).all() for g in grads) or \
            wrappers["lora_matmul_bwd"].launches != n_ad:
        raise RuntimeError(f"phase 14: the global-adapter gradient launched "
                           f"the fused LoRA backward "
                           f"{wrappers['lora_matmul_bwd'].launches} times "
                           f"(want {n_ad}) or is not finite")
    got["lora_matmul_bwd"] += n_ad
    del eff, grads, per

    pool = serving.pool_head(serving.pool_from_state(model, state),
                             W_ADAPTERS)
    del state, train, ev
    torch.cuda.empty_cache()
    served = whisper_serving(torch, dev, wrappers, model, params, pool, rng,
                             "phase 14 serving", name, card)
    del model, params, pool
    torch.cuda.empty_cache()
    return {k: got[k] + served[k] for k in got}


def whisper_serving(torch, dev, wrappers, model, params, pool, rng, tag,
                    name, card):
    """W_REQUESTS requests (adapter i % W_ADAPTERS, their own frames, a
    W_PROMPT-token prompt) through Model.prefill and W_NEW - 1
    decode_steps, batched and each alone; see whisper_phase.  Returns
    the launches of the batched run."""
    from repro_torch.runtime import serving

    m = model.cfg
    ids = [i % W_ADAPTERS for i in range(W_REQUESTS)]
    prompts = rng.integers(3, m.vocab_size, size=(W_REQUESTS, W_PROMPT))
    frames = frames_of(rng, (W_REQUESTS, m.encoder_seq_len, m.d_model))
    max_len = W_PROMPT + W_NEW

    def generate(rows):
        """Prefill then decode for the requests `rows` as one batch:
        (tokens (R, W_NEW), logits (R, W_NEW, V) on the host, prefill s,
        decode s per step)."""
        ad = serving.attach_ids(pool, [ids[i] for i in rows])
        cache = model.init_cache((len(rows),), max_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = model.prefill(params, ad, {
            "tokens": torch.as_tensor(prompts[rows].astype(np.int32),
                                      device=dev),
            "frames": torch.as_tensor(frames[rows], device=dev)}, cache)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        steps = [lg[:, -1].float()]
        toks = [torch.argmax(steps[-1], -1).to(torch.int32)]
        t0 = time.perf_counter()
        for _ in range(W_NEW - 1):
            lg, cache = model.decode_step(params, ad, toks[-1][:, None],
                                          cache)
            steps.append(lg[:, -1].float())
            toks.append(torch.argmax(steps[-1], -1).to(torch.int32))
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t0) / (W_NEW - 1)
        return (torch.stack(toks, 1).cpu().numpy(),
                torch.stack(steps, 1).cpu(), t_pre, t_dec)

    with torch.no_grad():
        generate([0])                                   # warm
        for w in wrappers.values():
            w.launches = 0
        rows = list(range(W_REQUESTS))
        toks, logits, t_pre, t_dec = generate(rows)
        got = {k: w.launches for k, w in wrappers.items()}
        alone = [generate([i]) for i in rows]
        wall, busy, _, kernels = device_busy(torch, lambda: generate(rows),
                                             f"{tag} profile")
        # the card's own train-mode forward over prompt + served tokens
        seq = np.concatenate([prompts, toks[:, :-1]], 1).astype(np.int32)
        x, _, _ = model.forward(params, serving.attach_ids(pool, ids), {
            "tokens": torch.as_tensor(seq, device=dev),
            "frames": torch.as_tensor(frames, device=dev)})
        full = model.head(params, x[:, W_PROMPT - 1:]).float().cpu()
        del x
    if not torch.isfinite(logits).all():
        raise RuntimeError(f"{tag}: non-finite logits")
    for i, (tk, lg, _, _) in enumerate(alone):
        upto = decided_steps(torch, lg[0])
        if list(toks[i, :upto]) != list(tk[0, :upto]):
            raise RuntimeError(f"{tag}: request {i} batched tokens "
                               f"{toks[i].tolist()} != alone "
                               f"{tk[0].tolist()} before step {upto}")
    diff = float((logits - full).abs().max())
    torch.testing.assert_close(
        logits, full, rtol=LOGITS_TOL, atol=LOGITS_TOL,
        msg=lambda msg: f"{tag}: served vs train-mode logits: {msg}")
    idle = "not measured" if busy is None else f"{1 - busy / wall:.3f}"
    per_tok = (sum(kernels.values()) / W_NEW if busy is not None
               else float("nan"))
    need = {"flash_attention_fwd", "lora_matmul_indexed", "decode_attention"}
    if any(not got[k] for k in need):
        raise RuntimeError(f"{tag}: never launched "
                           f"{[k for k in need if not got[k]]}")
    log(f"{tag} [{name}, {card}]: {W_REQUESTS} requests over {W_ADAPTERS} "
        f"adapters, prompts of {W_PROMPT} tokens with {m.encoder_seq_len} "
        f"frames each, {W_NEW} new tokens: batched prefill "
        f"{t_pre * 1e3:.1f} ms, decode {t_dec * 1e3:.2f} ms per step; alone "
        f"prefill {fmt([a[2] * 1e3 for a in alone])} ms, decode "
        f"{fmt([a[3] * 1e3 for a in alone])} ms per step; batched tokens == "
        f"alone (top-2 gap {TOP2_GAP}); served logits vs the train-mode "
        f"forward max |diff| {diff:.3e} (tol {LOGITS_TOL}); under the "
        f"profiler: wall {wall:.3f} s, idle share {idle}, "
        f"{per_tok:.1f} device kernels per token (prefill included); "
        f"launches of the batched run "
        f"{ {k: c for k, c in got.items() if c} }")
    return got


def whisper_steps(torch, dev, wrappers):
    """Phase 14b: whisper-medium at full width, SMALL_LAYERS encoder and
    SMALL_LAYERS decoder layers, 1500 frames, seq W_SEQ: one card-vs-CPU
    round step each uncompressed, under int8 (held on average) and under
    remat "full" (small_step_check at cuts [1, 2]: inside the encoder and
    at its last layer), then the same weights' prefill and 4 decode
    steps card vs CPU (decode_check).  Returns the launches of the
    card's steps."""
    kw = dict(num_encoder_layers=SMALL_LAYERS)
    arch = small_arch(WHISPER, kw)
    m = arch.model
    log(f"phase 14b: {WHISPER} at full width, {m.num_encoder_layers} "
        f"encoder + {m.num_layers} decoder layers, d_model {m.d_model}, "
        f"{m.encoder_seq_len} frames, seq {W_SEQ}")
    cpu_params, got = small_step_check(
        torch, dev, WHISPER, W_SEQ, W_STEPS, "phase 14b", compressed="mean",
        model_kw=kw, wrappers=wrappers)
    idle = [k for k in ("flash_attention_fwd", "flash_attention_bwd")
            if not got[k]]
    if idle:
        raise RuntimeError(f"phase 14b: never launched {idle}")
    decode_check(torch, dev, arch, cpu_params, "phase 14b serving")
    return got


# ---------------------------------------------------------------------------
# phase 15: the dry-run's serving cells on the card


def p15_arch(name: str):
    """llama3-8b at full width cut to P15_LLAMA_LAYERS layers; mamba2-780m
    at full width cut to P15_MAMBA2_LAYERS."""
    from repro_torch.configs import get_config
    arch = get_config(name)
    return arch.replace(model=dataclasses.replace(
        arch.model, num_layers={"llama3-8b": P15_LLAMA_LAYERS,
                                "mamba2-780m": P15_MAMBA2_LAYERS}[name]))


def p15_shape(name: str, batch=None):
    from repro_torch.config import SHAPES
    shape = SHAPES[name]
    seq = P15_LONG if name == "long_500k" else P15_SEQ
    return dataclasses.replace(shape, seq_len=seq,
                               global_batch=batch or shape.global_batch)


# the dry-run's records of phase 15's cells, {(arch, shape, batch):
# record}: traced by a child process while phases 2-14 run (a 32768-token
# prefill's trace takes ~25 s on the host), or when first asked for
P15_RECORDS: dict = {}


def p15_record(arch, shape):
    """dryrun.run_cell's record of the cell, traced now unless
    P15_RECORDS holds it."""
    from repro_torch.launch import dryrun
    key = (arch.name, shape.name, shape.global_batch)
    if key not in P15_RECORDS:
        P15_RECORDS[key] = dryrun.run_cell(arch, shape, verbose=False)
    return P15_RECORDS[key]


def p15_cells(total: int) -> dict:
    """The records of every cell phase 15 runs, its prefills' batch
    search on a card of `total` bytes included (no GPU: fake tensors on
    the host)."""
    for arch_name, cell in (("llama3-8b", "decode_32k"),
                            ("llama3-8b", "prefill_32k"),
                            ("mamba2-780m", "long_500k"),
                            ("mamba2-780m", "prefill_32k")):
        arch = p15_arch(arch_name)
        if cell == "prefill_32k":
            p15_batch(arch, cell, total, quiet=True)
        else:
            p15_record(arch, p15_shape(cell))
    return dict(P15_RECORDS)


def _p15_cells_to(out: str, total: int) -> None:
    """A child process's p15_cells, pickled to `out` (no GPU)."""
    import pickle

    import torch
    torch.set_num_threads(1)
    Path(out).write_bytes(pickle.dumps(p15_cells(total)))


def start_p15_cells(total: int):
    """Starts p15_cells in a child process (daemonic: killed if the script
    exits first); returns a function that waits for it and adds its
    records to P15_RECORDS."""
    import atexit
    import multiprocessing
    import pickle
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_p15_"))
    out = tmp / "cells.pkl"
    proc = multiprocessing.get_context("spawn").Process(
        target=_p15_cells_to, args=(str(out), total), daemon=True)
    proc.start()

    def stop():
        if proc.is_alive():
            proc.kill()
            proc.join()
        shutil.rmtree(tmp, ignore_errors=True)
    atexit.register(stop)

    def result() -> None:
        t0 = time.perf_counter()
        proc.join(timeout=900)
        if proc.exitcode != 0:
            stop()
            raise RuntimeError(f"the dry-run of phase 15's cells: exit code "
                               f"{proc.exitcode} (its traceback is on "
                               f"stderr)")
        P15_RECORDS.update(pickle.loads(out.read_bytes()))
        stop()
        log(f"phase 15: the dry-run's records of its cells, traced in a "
            f"child process beside phases 2-14 (waited "
            f"{time.perf_counter() - t0:.1f} s for it)")
    return result


def p15_predict(arch, shape, tag, rec=None):
    """dryrun.run_cell's record of the cell (`rec` where the caller has
    it), printed."""
    if rec is None:
        rec = p15_record(arch, shape)
    roof = rec["roofline"]
    log(f"{tag} predicted (dry-run, traced in {rec['trace_s']:.1f} s on the "
        f"host): {rec['flops']:.4e} FLOPs, {rec['bytes']:.4e} HBM bytes, "
        f"bound {roof['step_s_lower_bound'] * 1e3:.3f} ms "
        f"({roof['dominant']}), peak {rec['peak_bytes'] / 2**30:.2f} GiB, "
        f"kernel calls {rec['kernel_calls']}")
    return rec


def p15_batch(arch, name, total: int, quiet: bool = False):
    """The largest batch up to P15_BATCH_CAP whose predicted peak fits in
    PEAK_SHARE of a card of `total` bytes, and its record."""
    cap = min(P15_BATCH_CAP[arch.name], p15_shape(name).global_batch)
    for b in range(cap, 0, -1):
        rec = p15_record(arch, p15_shape(name, b))
        if rec["peak_bytes"] <= PEAK_SHARE * total:
            return b, rec
        if not quiet:
            log(f"phase 15 {arch.name} {name}: batch {b} predicted at "
                f"{rec['peak_bytes'] / 2**30:.2f} GiB, over {PEAK_SHARE} "
                f"of {total / 2**30:.2f} GiB")
    raise RuntimeError(f"phase 15 {arch.name} {name}: the dry-run fits no "
                       f"batch in {PEAK_SHARE} of the card")


def p15_measured(torch, tag, rec, wall_s, peak, base):
    """The cell's measured peak, max_memory_allocated less what earlier
    phases left allocated (`base`, read before the cell's arguments),
    against the dry-run's."""
    total = torch.cuda.get_device_properties(0).total_memory
    ratio = (peak - base) / rec["peak_bytes"]
    log(f"{tag} measured: wall {wall_s * 1e3:.2f} ms, max_memory_allocated "
        f"{peak / 2**30:.2f} GiB of {total / 2**30:.2f} GiB, "
        f"{(peak - base) / 2**30:.2f} GiB over the {base / 2**30:.2f} GiB "
        f"allocated before the cell; measured / predicted peak {ratio:.3f}")
    return ratio


def counted(torch, wrappers, fn):
    """(fn(), wall s, {row: launches}) with every counter set to 0 just
    before fn and read just after."""
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {k: w.launches for k, w in wrappers.items()
                       if w.launches}


def p15_profile(torch, tag, run):
    wall, busy, by_name, kernels = device_busy(torch, run, tag)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"{tag} profile: device busy {busy * 1e3:.2f} ms of {wall * 1e3:.2f} "
        f"ms wall (idle share {1 - busy / wall:.3f}), {sum(kernels.values())} "
        f"device kernels; top: " + "; ".join(
            f"{k[:50]} {v * 1e3:.2f} ms" for k, v in top))
    return busy


def p15_llama_decode(torch, dev, wrappers, name, card, launches, worst, rows,
                     F):
    """decode_32k at B 128: one Model.decode_step over a contiguous cache
    of 32768 positions drawn from the seed, len 32767 in every row."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.lora_matmul import ops as lops
    from repro_torch.models.model import build_model
    from repro_torch.runtime import serving
    from repro_torch.tree import tree_map

    tag = "phase 15 llama3-8b decode_32k"
    arch = p15_arch("llama3-8b")
    shape = p15_shape("decode_32k")
    b, s = shape.global_batch, shape.seq_len
    rec = p15_predict(arch, shape, tag)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    cgen = torch.Generator(device=dev).manual_seed(SEED)
    model = build_model(arch, device=dev)
    params = model.init_params(cgen, dtype=torch.bfloat16)
    pool = serving.build_adapter_pool(
        model, torch.Generator().manual_seed(SEED + 1), 1,
        dtype=torch.bfloat16)
    cache = model.init_cache((b,), s, torch.bfloat16)
    for t in cache["dec"].values():
        t.normal_(generator=cgen)
    cache["len"].fill_(s - 1)
    tokens = torch.randint(3, arch.model.vocab_size, (b, 1), generator=cgen,
                           device=dev, dtype=torch.int32)
    rows2 = [0, b - 1]
    small = {"len": cache["len"][rows2].clone(),
             "dec": {k: v[:, rows2].clone() for k, v in cache["dec"].items()}}
    cpu_small = {"len": small["len"].cpu(),
                 "dec": {k: v.cpu() for k, v in small["dec"].items()}}
    ad = serving.attach_ids(pool, [0] * b)
    # the peak from here: the cell's arguments, then its step (the
    # weights' fp32 draw before is not the cell's)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        (logits, _), wall, got = counted(
            torch, wrappers,
            lambda: model.decode_step(params, ad, tokens, cache))
        peak = torch.cuda.max_memory_allocated()
        want = {"decode_attention": P15_LLAMA_LAYERS,
                "lora_matmul_indexed": 4 * P15_LLAMA_LAYERS}
        if got != want:
            raise RuntimeError(f"{tag}: launches {got}, want {want}")
        launches["decode_attention (hd 128, capacity 32768)"] += \
            got["decode_attention"]
        launches["lora_matmul_indexed"] += got["lora_matmul_indexed"]
        ratio = p15_measured(torch, tag, rec, wall, peak, base)
        # rows 0 and B-1 alone, over copies of their caches
        logits2, _ = model.decode_step(
            params, serving.attach_ids(pool, [0, 0]), tokens[rows2], small)
        same_logits = torch.equal(logits2, logits[rows2])
        e_rows = max_err(torch, logits2, logits[rows2], "bfloat16",
                         f"{tag} B=2 vs B={b} logits", scaled=True)
        # the hand-written kernels' rows at this shape do not depend on B
        dq = torch.randn((b, arch.model.num_heads, arch.model.head_dim),
                         generator=cgen, device=dev).to(torch.bfloat16)
        k0, v0 = cache["dec"]["k"][0], cache["dec"]["v"][0]
        clen = torch.full((b,), s, dtype=torch.int32, device=dev)
        if not torch.equal(
                dops.decode_attention(dq[rows2], k0[rows2], v0[rows2],
                                      clen[rows2]),
                dops.decode_attention(dq, k0, v0, clen)[rows2]):
            raise RuntimeError(f"{tag}: decode kernel rows 0 and {b - 1} "
                               f"differ between B={b} and B=2")
        qa = pool["dec"]["q"]
        xq = torch.randn((b, arch.model.d_model), generator=cgen,
                         device=dev).to(torch.bfloat16)
        ids = torch.zeros((b,), dtype=torch.int32, device=dev)
        wq = params["dec"]["wq"][0]
        if not torch.equal(
                lops.lora_matmul_indexed(xq[rows2], wq, qa["A"][0],
                                         qa["B"][0], qa["scale"][0],
                                         ids[rows2]),
                lops.lora_matmul_indexed(xq, wq, qa["A"][0], qa["B"][0],
                                         qa["scale"][0], ids)[rows2]):
            raise RuntimeError(f"{tag}: indexed LoRA rows 0 and {b - 1} "
                               f"differ between M={b} and M=2")
        log(f"{tag}: rows 0 and {b - 1} of the step: logits "
            f"{'bit for bit equal to' if same_logits else f'within {e_rows:.3e} of'} "
            f"a B=2 step over copies of their caches (the MLP and the head "
            f"are cuBLAS GEMMs, blocked by M); the decode kernel's and the "
            f"indexed LoRA's rows at this shape bit for bit at B=2 and "
            f"B={b}")
        # the B=2 step on the CPU's plain path
        cpu_model = build_model(arch, device="cpu")
        cpu_params = tree_map(lambda t: t.cpu(), params)
        cpu_logits, _ = cpu_model.decode_step(
            cpu_params, serving.attach_ids(tree_map(lambda t: t.cpu(), pool),
                                           [0, 0]),
            tokens[rows2].cpu(), cpu_small)
        e_cpu = max_err(torch, logits2, cpu_logits, "bfloat16",
                        f"{tag} card vs CPU logits", scaled=True)
        log(f"{tag}: the B=2 step's logits within {e_cpu:.3e} of the CPU's "
            f"plain path (tol {TOL['bfloat16']} x max |logit| "
            f"{float(cpu_logits.float().abs().max()):.3f})")
        del cpu_model, cpu_params, cpu_logits, cpu_small
        # the kernel at this shape against its plain version, by rows
        q = dq
        out = dops.decode_attention(q, k0, v0, clen)

        def plain():
            return torch.cat([dops.ref.decode_attention(
                q[i:i + P15_PLAIN_ROWS], k0[i:i + P15_PLAIN_ROWS],
                v0[i:i + P15_PLAIN_ROWS], clen[i:i + P15_PLAIN_ROWS])
                for i in range(0, b, P15_PLAIN_ROWS)])
        row = "decode_attention (hd 128, capacity 32768)"
        worst[row] = max(worst[row], max_err(
            torch, out, plain(), "bfloat16", f"{tag} decode kernel"))
        len0 = torch.full_like(cache["len"], s - 1)
        busy = p15_profile(torch, tag, lambda: model.decode_step(
            params, ad, tokens, dict(cache, len=len0)))
        h, kvh, hd = (arch.model.num_heads, arch.model.num_kv_heads,
                      arch.model.head_dim)
        ms = cuda_ms(torch, lambda: dops.decode_attention(q, k0, v0, clen),
                     iters=20)
        plain_ms = cuda_ms(torch, plain, iters=2, warmup=1)
        # SDPA over (B, KVH) with a kv head's query group as its rows:
        # the same function, one call
        ks, vs = k0.transpose(1, 2).contiguous(), v0.transpose(1, 2).contiguous()
        del cache, small, pool, ad, params, model, k0, v0
        torch.cuda.empty_cache()
        qs = q.reshape(b, kvh, h // kvh, hd)
        library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs), iters=10)
        del ks, vs
        nbytes = 2 * (2 * b * s * kvh * hd + 2 * b * h * hd) + 4 * b
        rows[row] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound=bound(nbytes, 4 * b * h * s * hd, "bfloat16"),
            cuda_core_bound=None,
            shape=f"B={b} capacity {s} cache_len {s}, H={h}/{kvh} hd={hd} "
                  f"bf16, {kvh * b * ((s - 1) // 64 + 1)} CTAs")
    torch.cuda.empty_cache()
    return dict(ratio=ratio, wall=wall, busy=busy)


def p15_logits_vs_forward(torch, tag, model, params, pool, toks, nxt,
                          last_logits, step_logits, held=True):
    """Row 0's prefill logits at its last position and the next decode
    step's, against the card's own train-mode forward over the prompt
    and the decoded token: held at TOL["bfloat16"] of the logits' scale
    where `held`, else only reported (an SSM's bf16 recurrent step
    against its chunked scan; p15_ssm_fp32 holds that path)."""
    from repro_torch.runtime import serving
    seq = torch.cat([toks[:1], nxt[:1]], dim=1)
    x, _, _ = model.forward(params, serving.attach_ids(pool, [0]),
                            {"tokens": seq})
    want = model.head(params, x[:, -2:]).float()[0]
    del x
    got = torch.stack([last_logits[0, -1].float(), step_logits[0, -1].float()])
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{tag}: non-finite logits")
    scale = float(want.abs().max())
    if held:
        e = max_err(torch, got, want, "bfloat16",
                    f"{tag} prefill-then-decode logits vs the train-mode "
                    f"forward", scaled=True)
    else:
        e = float((got - want).abs().max())
    log(f"{tag}: row 0's last prefill logits and the next step's within "
        f"{e:.3e} of the card's own train-mode forward over "
        f"{seq.shape[1]} tokens, max |logit| {scale:.3f} "
        + (f"(tol {TOL['bfloat16']} x max |logit|)" if held else
           "(bf16, reported; the fp32 run below holds the path)"))
    return e


def p15_ssm_fp32(torch, dev, arch, toks, n_new, tag):
    """The SSM cell's path in fp32 (weights and the adapter from the same
    seeds): row 0's prompt prefilled, n_new greedy decode steps, every
    step's logits within SSM_LOGITS_TOL of the card's own train-mode
    forward, as phase 11 holds them."""
    from repro_torch.models.model import build_model
    from repro_torch.runtime import serving
    model = build_model(arch, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    pool = serving.build_adapter_pool(
        model, torch.Generator().manual_seed(SEED + 1), 1)
    ad = serving.attach_ids(pool, [0])
    prompt = toks[:1]
    with torch.no_grad():
        cache = model.init_cache((1,), prompt.shape[1] + n_new)
        lg, cache = model.prefill(params, ad, {"tokens": prompt}, cache)
        outs, seq = [lg[0, -1]], []
        for _ in range(n_new):
            tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
            seq.append(tok)
            lg, cache = model.decode_step(params, ad, tok, cache)
            outs.append(lg[0, -1])
        x, _, _ = model.forward(params, ad, {
            "tokens": torch.cat([prompt] + seq, dim=1)})
        want = model.head(params, x[0, prompt.shape[1] - 1:])
        got = torch.stack(outs)
        del x
    e = float((got - want).abs().max())
    torch.testing.assert_close(
        got, want, rtol=SSM_LOGITS_TOL, atol=SSM_LOGITS_TOL,
        msg=lambda m: f"{tag} fp32 logits vs the train-mode forward: {m}")
    log(f"{tag}: in fp32, the prefill of {prompt.shape[1]} tokens and "
        f"{n_new} decode step(s): {n_new + 1} logits within {e:.3e} of the "
        f"card's own train-mode forward (tol {SSM_LOGITS_TOL})")
    del model, params, pool, ad, cache
    torch.cuda.empty_cache()
    return e


def p15_prefill(torch, dev, wrappers, name, card, launches, arch_name):
    """prefill_32k: Model.prefill of B sequences of 32768 tokens into a
    cache of 32769 positions, then one decode step."""
    from repro_torch.models.model import build_model
    from repro_torch.runtime import serving

    arch = p15_arch(arch_name)
    b, rec = p15_batch(arch, "prefill_32k",
                       torch.cuda.get_device_properties(0).total_memory)
    s = P15_SEQ
    tag = f"phase 15 {arch_name} prefill_32k (batch {b})"
    log(f"{tag}: batch {b} of 32: the largest up to the phase's time cap "
        f"{P15_BATCH_CAP[arch_name]} whose predicted peak fits in "
        f"{PEAK_SHARE} of the card")
    p15_predict(arch, p15_shape("prefill_32k", b), tag, rec)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    cgen = torch.Generator(device=dev).manual_seed(SEED)
    model = build_model(arch, device=dev)
    params = model.init_params(cgen, dtype=torch.bfloat16)
    pool = serving.build_adapter_pool(
        model, torch.Generator().manual_seed(SEED + 1), 1,
        dtype=torch.bfloat16)
    cache = model.init_cache((b,), s + 1, torch.bfloat16)
    toks = torch.randint(3, arch.model.vocab_size, (b, s), generator=cgen,
                         device=dev, dtype=torch.int32)
    ad = serving.attach_ids(pool, [0] * b)
    ssm = arch.model.family == "ssm"
    big = "ssd_scan (final state)" if ssm else "flash_attention_fwd"
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        len0 = cache["len"].clone()
        (logits, cache), wall, got = counted(
            torch, wrappers,
            lambda: model.prefill(params, ad, {"tokens": toks}, cache))
        layers = arch.model.num_layers
        if got.get(big) != layers or "lora_matmul_indexed" not in got \
                or set(got) != {big, "lora_matmul_indexed"}:
            raise RuntimeError(f"{tag}: prefill launches {got}")
        launches[P15_ROWS[3] if ssm else P15_ROWS[0]] += got[big]
        launches["lora_matmul_indexed (M 32768)"] += \
            got["lora_matmul_indexed"]
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        (step, _), dwall, dgot = counted(
            torch, wrappers, lambda: model.decode_step(params, ad, nxt, cache))
        peak = torch.cuda.max_memory_allocated()
        dec = "lora_matmul_indexed"
        if not ssm:
            launches["decode_attention (hd 128, capacity 32768)"] += \
                dgot.pop("decode_attention", 0)
        launches[dec] += dgot.pop(dec, 0)
        if dgot:
            raise RuntimeError(f"{tag}: decode step launches {dgot}")
        log(f"{tag}: prefill launches {got}; {b * s} tokens in "
            f"{wall * 1e3:.1f} ms ({b * s / wall:.0f} tokens/s); the decode "
            f"step after it {dwall * 1e3:.2f} ms")
        ratio = p15_measured(torch, tag, rec, wall, peak, base)
        e = p15_logits_vs_forward(torch, tag, model, params, pool, toks,
                                  nxt, logits, step, held=not ssm)
        busy = p15_profile(torch, tag, lambda: model.prefill(
            params, ad, {"tokens": toks}, dict(cache, len=len0)))
    del model, params, pool, cache, ad
    torch.cuda.empty_cache()
    if ssm:
        e = p15_ssm_fp32(torch, dev, arch, toks, 1, tag)
    return dict(ratio=ratio, wall=wall, busy=busy, batch=b, err=e)


def p15_long(torch, dev, wrappers, name, card, launches):
    """long_500k on mamba2-780m: init_cache at 524288 positions (the
    recurrent cache does not grow with it), a prompt of P15_PROMPT tokens,
    P15_NEW decode steps; the logits against the train-mode forward."""
    from repro_torch.models.model import build_model
    from repro_torch.runtime import serving
    from repro_torch.tree import tree_leaves, tree_map

    tag = "phase 15 mamba2-780m long_500k"
    arch = p15_arch("mamba2-780m")
    shape = p15_shape("long_500k")
    rec = p15_predict(arch, shape, tag)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    cgen = torch.Generator(device=dev).manual_seed(SEED)
    model = build_model(arch, device=dev)
    params = model.init_params(cgen, dtype=torch.bfloat16)
    pool = serving.build_adapter_pool(
        model, torch.Generator().manual_seed(SEED + 1), 1,
        dtype=torch.bfloat16)
    nbytes = lambda c: sum(t.numel() * t.element_size()  # noqa: E731
                           for t in tree_leaves(c))
    cache = model.init_cache((1,), shape.seq_len, torch.bfloat16)
    short = model.init_cache((1,), P15_PROMPT + P15_NEW, torch.bfloat16)
    if nbytes(cache) != nbytes(short):
        raise RuntimeError(f"{tag}: the cache at {shape.seq_len} positions "
                           f"holds {nbytes(cache)} bytes, at "
                           f"{P15_PROMPT + P15_NEW} {nbytes(short)}")
    del short
    ad = serving.attach_ids(pool, [0])
    toks = torch.randint(3, arch.model.vocab_size, (1, P15_PROMPT),
                         generator=cgen, device=dev, dtype=torch.int32)
    layers = arch.model.num_layers
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        (lg, cache), pwall, got = counted(
            torch, wrappers,
            lambda: model.prefill(params, ad, {"tokens": toks}, cache))
        if got != {"ssd_scan (final state)": layers,
                   "lora_matmul_indexed": 2 * layers}:
            raise RuntimeError(f"{tag}: prefill launches {got}")
        for k, c in got.items():
            launches[k] += c
        seq, outs, walls = [], [lg[0, -1].float()], []
        for _ in range(P15_NEW):
            tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
            seq.append(tok)
            (lg, cache), w, got = counted(
                torch, wrappers,
                lambda: model.decode_step(params, ad, tok, cache))
            if got != {"lora_matmul_indexed": 2 * layers}:
                raise RuntimeError(f"{tag}: decode launches {got}")
            launches["lora_matmul_indexed"] += got["lora_matmul_indexed"]
            outs.append(lg[0, -1].float())
            walls.append(w)
        peak = torch.cuda.max_memory_allocated()
        full = torch.cat([toks] + seq, dim=1)
        x, _, _ = model.forward(params, ad, {"tokens": full})
        want = model.head(params, x[0, P15_PROMPT - 1:]).float()
        got_l = torch.stack(outs)
        if not torch.isfinite(got_l).all():
            raise RuntimeError(f"{tag}: non-finite logits")
        e = float((got_l - want).abs().max())
        log(f"{tag}: cache of {nbytes(cache)} bytes at {shape.seq_len} "
            f"positions, as at {P15_PROMPT + P15_NEW}; prefill of "
            f"{P15_PROMPT} tokens {pwall * 1e3:.2f} ms, decode steps "
            f"{fmt([w * 1e3 for w in walls])} ms; {P15_NEW + 1} bf16 logits "
            f"within {e:.3e} of the card's own train-mode forward, max "
            f"|logit| {float(want.abs().max()):.3f} (reported; the fp32 run "
            f"below holds the path)")
        ratio = p15_measured(torch, tag, rec, min(walls), peak, base)
        state = tree_map(lambda t: t.clone(), cache)
        busy = p15_profile(torch, tag, lambda: model.decode_step(
            params, ad, tok, state))
    del model, params, pool, cache, state
    torch.cuda.empty_cache()
    p15_ssm_fp32(torch, dev, arch, toks, P15_NEW, tag)
    return dict(ratio=ratio, wall=min(walls), busy=busy)


def p15_kernels(torch, dev, F, worst, rows):
    """The flash forward at S 32768 (hd 128, GQA 4:1, causal, bf16), the
    indexed LoRA at M 32768 (llama's q, K = N = 4096, one adapter) and
    the SSD scan with its final state at mamba2's B 1, S 32768, each held
    against its plain version and timed beside its bound."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.lora_matmul import ops as lops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    gen = torch.Generator(device=dev).manual_seed(SEED + 15)

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    s, h, kvh, hd = P15_SEQ, LLAMA_HEADS[0], LLAMA_HEADS[1], 128
    q, k, v = rand(1, s, h, hd), rand(1, s, kvh, hd), rand(1, s, kvh, hd)
    off = s - P15_FLASH_ROWS
    with torch.no_grad():
        out, lse = fops.flash_attention_fwd(q, k, v)
        qt = q[:, off:].contiguous()
        r_out, r_lse = fops.ref.attention_fwd(qt, k, v, q_offset=off)
        o_out, o_lse = fops.flash_attention_fwd(qt, k, v, q_offset=off)
        lse_tail = lse.reshape(h, s)[:, off:].reshape(h, P15_FLASH_ROWS, 1)
        row = P15_ROWS[0]
        worst[row] = max(
            max_err(torch, out[:, off:], r_out, "bfloat16",
                    "flash S 32768, last rows"),
            max_err(torch, lse_tail, r_lse, "bfloat16",
                    "flash S 32768 lse, last rows"),
            max_err(torch, o_out, r_out, "bfloat16",
                    "flash q_offset, last rows"),
            max_err(torch, o_lse, r_lse, "bfloat16",
                    "flash q_offset lse, last rows"))

        def plain():
            for lo in range(0, s, P15_FLASH_ROWS):
                fops.ref.attention_fwd(q[:, lo:lo + P15_FLASH_ROWS], k, v,
                                       q_offset=lo)
        # SDPA over the kv heads repeated for each query head (copied
        # outside the timed call)
        qs = q.transpose(1, 2)
        ks, vs = (t.transpose(1, 2).repeat_interleave(h // kvh, dim=1)
                  for t in (k, v))
        flops = 4 * h * hd * s * (s + 1) // 2
        rows[row] = dict(
            ms=cuda_ms(torch, lambda: fops.flash_attention_fwd(q, k, v),
                       iters=5, warmup=1),
            plain_ms=cuda_ms(torch, plain, iters=1, warmup=1),
            library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True), iters=5, warmup=1),
            bound=bound(2 * s * hd * (2 * h + 2 * kvh) + 4 * h * s, flops,
                        "bfloat16"),
            cuda_core_bound=None,
            shape=f"B=1 S={s} causal H={h}/{kvh} hd={hd} bf16 (the plain "
                  f"version in {s // P15_FLASH_ROWS} calls of "
                  f"{P15_FLASH_ROWS} query rows)")
        del q, k, v, qs, ks, vs, out, lse, qt, r_out, r_lse, o_out, o_lse

        m, kd, r = s, 4096, 16
        x, w = rand(m, kd), rand(kd, kd, scale=kd ** -0.5)
        a, bb = rand(1, kd, r, scale=r ** -0.5), rand(1, r, kd, scale=0.02)
        sc = torch.full((1,), 2.0, device=dev)
        ids = torch.zeros((m,), dtype=torch.int32, device=dev)
        args = (x, w, a, bb, sc, ids)
        row = P15_ROWS[2]
        worst[row] = max(worst[row], max_err(
            torch, lops.lora_matmul_indexed(*args),
            lops.ref.lora_matmul_indexed(*args), "bfloat16",
            f"indexed LoRA M={m} K=N={kd}", scaled=True))
        chunks = len(lops.row_chunks(m, kd, kd, r))
        rows[row] = dict(
            ms=cuda_ms(torch, lambda: lops.lora_matmul_indexed(*args),
                       iters=10),
            plain_ms=cuda_ms(torch, lambda: lops.ref.lora_matmul_indexed(
                *args), iters=3, warmup=1),
            library_ms=None,
            bound=bound(2 * (2 * m * kd + kd * kd + 2 * kd * r) + 4 * (m + 1),
                        2 * m * kd * kd + 2 * m * r * 2 * kd, "bfloat16"),
            cuda_core_bound=None,
            shape=f"M={m} K=N={kd} r={r} one adapter bf16 (llama's q in a "
                  f"prefill of 32768 tokens), {chunks} launches of "
                  f"{lops.row_chunks(m, kd, kd, r)[0][1]} rows")
        del x, w, a, bb, sc, ids, args

        b, s2, h2, p, g, n, chunk = P15_SSD
        x = rand(b, s2, h2, p)
        dt = torch.nn.functional.softplus(rand(b, s2, h2, dtype=torch.float32)
                                          + 0.5).contiguous()
        a = -torch.exp(rand(h2, dtype=torch.float32, scale=0.5))
        bm, c = rand(b, s2, g, n, scale=0.3), rand(b, s2, g, n, scale=0.3)
        ins = (x, dt, a, bm, c)
        got = ssd_ops.ssd_scan(*ins, chunk=chunk, return_state=True)
        want = ssd_ops.ref.ssd_chunked(*ins, chunk=chunk, return_state=True)
        row = P15_ROWS[3]
        worst[row] = max(
            max_err(torch, got[0], want[0], "bfloat16", "ssd S 32768 y",
                    scaled=True),
            max_err(torch, got[1], want[1], "bfloat16",
                    "ssd S 32768 final state", scaled=True))
        nbytes, flops, _ = ssd_work(b, s2, h2, p, g, n, chunk, 2, True)
        rows[row] = dict(
            ms=cuda_ms(torch, lambda: ssd_ops.ssd_scan(
                *ins, chunk=chunk, return_state=True), iters=10),
            plain_ms=cuda_ms(torch, lambda: ssd_ops.ref.ssd_chunked(
                *ins, chunk=chunk, return_state=True), iters=3, warmup=1),
            library_ms=None,
            bound=bound(nbytes, flops, "bfloat16"), cuda_core_bound=None,
            shape=f"B={b} S={s2} H={h2} P={p} G={g} N={n} chunk={chunk} bf16 "
                  f"with the final state (mamba2's prefill)")
    torch.cuda.empty_cache()


def phase15(torch, dev, wrappers, name, card, F, launches, worst, rows,
            cells=None):
    """Phase 15: the dry-run's serving cells on the card, each beside its
    prediction (cells: start_p15_cells' wait, else traced here); the
    kernels at the cells' lengths held and timed."""
    t0 = time.perf_counter()
    if cells is not None:
        cells()
    got = {"llama3-8b decode_32k": p15_llama_decode(
        torch, dev, wrappers, name, card, launches, worst, rows, F)}
    got["llama3-8b prefill_32k"] = p15_prefill(
        torch, dev, wrappers, name, card, launches, "llama3-8b")
    got["mamba2-780m long_500k"] = p15_long(torch, dev, wrappers, name,
                                            card, launches)
    got["mamba2-780m prefill_32k"] = p15_prefill(
        torch, dev, wrappers, name, card, launches, "mamba2-780m")
    p15_kernels(torch, dev, F, worst, rows)
    for kname in P15_ROWS:
        row = rows[kname]
        lib = ("n/a" if row["library_ms"] is None
               else f"{row['library_ms']:.4f}")
        log(f"phase 15 [{name}, {card}] {kname} at {row['shape']}: kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
            f"{lib} ms, bound {row['bound'][0]:.4f} ms ({row['bound'][1]}); "
            f"launches on phase 15's paths {launches[kname]}")
    log(f"phase 15 [{name}, {card}]: measured / predicted peak " + ", ".join(
        f"{k} {v['ratio']:.3f}" for k, v in got.items())
        + f"; the phase took {time.perf_counter() - t0:.1f} s")
    idle = [k for k in P15_ROWS if not launches[k]]
    if idle:
        raise RuntimeError(f"phase 15 never launched {idle}")
    return got


def p16_arch(opt: str):
    import dataclasses

    arch = gpt2_int8()
    return arch.replace(
        data=dataclasses.replace(arch.data, num_clients=P16_CLIENTS),
        train=dataclasses.replace(arch.train, **P16_TRAIN[opt]))


def p16_run(torch, dev, wrappers, policy, opt, tag, name, card) -> dict:
    """P16_ROUNDS rounds of phase 16's system under `policy` (None or a
    ClientShard) and optimizer `opt`, then the fused LoRA backward at the
    eval shape on this rank's rows (global_adapter_grad).  Returns per
    round its wall and step seconds, each step's launches and the shard's
    collectives and bytes all-reduced, the gathered state after each
    round (numpy), the records, the rows this process holds, its
    max_memory_allocated and the LoRA backward's launches."""
    from repro_torch.core.system import SplitFTSystem, SystemConfig
    from repro_torch.runtime.sharding import gather_state
    from repro_torch.tree import tree_map

    system = SplitFTSystem(p16_arch(opt), SystemConfig(
        num_samples=NUM_SAMPLES, eval_samples=EVAL_SAMPLES), seed=SEED,
        device=dev, policy=policy)
    train = system.train_step = TimedStep(torch, system.train_step, wrappers)
    ev = system.eval_step = TimedStep(torch, system.eval_step, wrappers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rounds, states = [], []
    for r in range(P16_ROUNDS):
        before = ((policy.collectives, policy.bytes_reduced) if policy
                  else (0, 0))
        t0 = time.perf_counter()
        system.run(1, log_every=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = ((policy.collectives, policy.bytes_reduced) if policy
                 else (0, 0))
        rounds.append({"wall": wall, "train_s": train.calls[-1][2],
                       "eval_s": ev.calls[-1][2],
                       "train": train.calls[-1][1], "eval": ev.calls[-1][1],
                       "collectives": after[0] - before[0],
                       "bytes": after[1] - before[1]})
        states.append(tree_map(lambda x: x.detach().cpu().numpy(),
                               gather_state(system.state, system.cohort)))
        rec = system.history[-1]
        if not np.isfinite(rec["loss"]):
            raise RuntimeError(f"{tag} round {r}: non-finite loss")
    peak = torch.cuda.max_memory_allocated()
    bwd = global_adapter_grad(torch, dev, wrappers, system, 48, tag, name,
                              card)
    log(f"{tag} [{name}, {card}]: rows {system.state['cuts'].shape[0]} of "
        f"{P16_CLIENTS}; round wall "
        + ", ".join(f"{x['wall'] * 1e3:.1f} ms (train {x['train_s'] * 1e3:.1f}"
                    f" + eval {x['eval_s'] * 1e3:.1f})" for x in rounds)
        + f"; losses {[float(h['loss']) for h in system.history]}; "
        f"collectives per round {[x['collectives'] for x in rounds]}, "
        f"bytes all-reduced {[x['bytes'] for x in rounds]}; "
        f"max_memory_allocated {peak / 2**30:.3f} GiB")
    return {"rounds": rounds, "states": states,
            "history": [dict(h) for h in system.history],
            "rows": int(system.state["cuts"].shape[0]), "peak": peak,
            "lora_bwd": bwd}


def p16_rank(rank: int, world: int, out_dir: str, device: str = "cuda"):
    """Phase 16 on one of P16_RANKS gloo ranks that share the card (run
    by repro_torch.launch.sharded.run_ranks in a process of its own)."""
    import torch

    from repro_torch.launch.mesh import make_client_mesh
    from repro_torch.runtime.sharding import ClientShard

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    shard = ClientShard(make_client_mesh(world), device=dev, backend="gloo")
    got = {opt: p16_run(torch, dev, port_wrappers(), shard, opt,
                        f"phase 16 {opt} gloo rank {rank} of {world}",
                        torch.cuda.get_device_name(0), card_line())
           for opt in P16_TRAIN}
    torch.save(got, Path(out_dir) / f"gloo_rank{rank}.pt")


def p16_compare(got, want, what, opt):
    """A sharded run's states and records against the unsharded run's
    (repro_torch.runtime.agreement, as the CPU tests of the sharded
    engine).  Logs and returns per round the largest |diff| / max|leaf|
    of a float leaf."""
    from repro_torch.runtime import agreement

    gaps = [agreement.check_state(a, b, rtol=P16_RTOL,
                                  atol_of_max=P16_ATOL_OF_MAX,
                                  outliers=out)
            for a, b, out in zip(got["states"], want["states"],
                                 P16_OUTLIERS[opt], strict=True)]
    loss = agreement.check_history(got["history"], want["history"],
                                   loss_rtol=P16_LOSS_RTOL[opt])
    log(f"{what}: per round and state key the largest |diff| / max|leaf| "
        "and the largest share of a leaf's elements outside the "
        "tolerance: "
        + "; ".join(f"round {r}: " + ", ".join(
            f"{k} {v:.3e} {o:.3e}" for k, (v, o) in g.items())
            for r, g in enumerate(gaps))
        + f"; losses' largest relative difference {loss:.3e}")
    return [max(v for v, _ in g.values()) for g in gaps]


def phase16(torch, dev, wrappers, name, card):
    """Phase 16: the cohort split over torch.distributed ranks, for each
    optimizer of P16_TRAIN.  Returns the launches of every run (the gloo
    ranks' read from their processes)."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import make_client_mesh
    from repro_torch.launch.sharded import process_group, run_ranks
    from repro_torch.runtime import agreement
    from repro_torch.runtime.sharding import ClientShard

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_p16_"))
    try:
        plain = {opt: p16_run(torch, dev, wrappers, None, opt,
                              f"phase 16 {opt} unsharded", name, card)
                 for opt in P16_TRAIN}
        with process_group(0, 1, tmp / "nccl", backend="nccl"):
            shard = ClientShard(make_client_mesh(1), device=dev)
            nccl = {opt: p16_run(torch, dev, wrappers, shard, opt,
                                 f"phase 16 {opt} {shard.backend} world 1",
                                 name, card)
                    for opt in P16_TRAIN}
        t1 = time.perf_counter()
        run_ranks(p16_rank, P16_RANKS, tmp / "gloo",
                  args=(str(tmp), dev.type))
        spawned = time.perf_counter() - t1
        gloo = [torch.load(tmp / f"gloo_rank{r}.pt", weights_only=False)
                for r in range(P16_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    worst = {}
    for opt in P16_TRAIN:
        agreement.same_bits(
            {k: nccl[opt][k] for k in ("states", "history")},
            {k: plain[opt][k] for k in ("states", "history")},
            f"phase 16 {opt} NCCL world 1")
        worst[opt] = p16_compare(gloo[0][opt], plain[opt],
                                 f"phase 16 {opt} {P16_RANKS} gloo ranks",
                                 opt)
        for r, g in enumerate(x[opt] for x in gloo):
            if g["rows"] != P16_CLIENTS // P16_RANKS:
                raise RuntimeError(
                    f"phase 16 {opt} gloo rank {r} holds {g['rows']} "
                    f"rows, want {P16_CLIENTS // P16_RANKS}")
            for i, (a, b) in enumerate(zip(g["rounds"],
                                           plain[opt]["rounds"])):
                for step in ("train", "eval"):
                    if a[step] != b[step]:
                        raise RuntimeError(
                            f"phase 16 {opt} gloo rank {r} round {i} "
                            f"{step} step launches {a[step]}, unsharded "
                            f"{b[step]}")
            if g["lora_bwd"] != plain[opt]["lora_bwd"]:
                raise RuntimeError(f"phase 16 {opt} gloo rank {r}: fused "
                                   f"LoRA backward launches "
                                   f"{g['lora_bwd']}")
    launches = {k: 0 for k in P16_ROWS}
    for runs in [plain, nccl] + gloo:
        for run in runs.values():
            for x in run["rounds"]:
                for step in ("train", "eval"):
                    for k, c in x[step].items():
                        if k in launches:
                            launches[k] += c
            launches["lora_matmul_bwd"] += run["lora_bwd"]
    idle = [k for k, c in launches.items() if not c]
    if idle:
        raise RuntimeError(f"phase 16 never launched {idle}")
    log(f"phase 16 [{name}, {card}]: NCCL at world size 1 == unsharded bit "
        f"for bit; {P16_RANKS} gloo ranks on the card hold "
        f"{P16_CLIENTS // P16_RANKS} rows each, per-step launches == "
        f"unsharded, max |diff| / max|leaf| per round "
        + ", ".join(f"{opt} {[f'{w:.3e}' for w in worst[opt]]}"
                    for opt in P16_TRAIN)
        + f" (rtol {P16_RTOL}, atol {P16_ATOL_OF_MAX} x max, outliers "
        f"{P16_OUTLIERS}); peak per rank (GiB): "
        + "; ".join(f"{opt} unsharded {plain[opt]['peak'] / 2**30:.3f}, "
                    f"NCCL {nccl[opt]['peak'] / 2**30:.3f}, gloo "
                    f"{[round(g[opt]['peak'] / 2**30, 3) for g in gloo]}"
                    for opt in P16_TRAIN)
        + f"; spawn + {P16_RANKS} ranks {spawned:.1f} s; the phase took "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches


def p17_arch(smashed: str):
    """llama3-8b at full width, P17_LAYERS deep, cut P17_CUT, batch
    P17_BATCH, SGD, the smashed compressor `smashed`; phase 9's clients
    and seq."""
    import dataclasses

    from repro_torch.configs import get_config

    arch = get_config("llama3-8b")
    return arch.replace(
        model=dataclasses.replace(arch.model, num_layers=P17_LAYERS),
        split=dataclasses.replace(arch.split, cut_layer=P17_CUT,
                                  cut_buckets=(P17_CUT,),
                                  smashed_compress=smashed),
        train=dataclasses.replace(arch.train, batch_size=P17_BATCH,
                                  **P17_TRAIN))


@contextlib.contextmanager
def recorded_shapes():
    """While open, the yielded dict collects the shapes the model hands
    the flash kernels ((B, S, H, hd) of q and of k), the fused LoRA ((K,
    N) of W), the SSD scan ((B, S, H, P) of x) and the int8 kernels (the
    message, at the layout helper the wrapper calls first), at the module
    attributes the blocks call (the kernels' own wrappers and counters
    stay as they are)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.lora_matmul import ops as lops
    from repro_torch.kernels.smashed_quant import ops as sops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    got = {"flash": set(), "lora": set(), "ssd": set(), "int8": set()}
    flash, lora, scan = fops.flash_attention, lops.lora_matmul, \
        ssd_ops.ssd_scan
    canon = sops._canon

    def flash_rec(q, k, v, **kw):
        got["flash"].add((tuple(q.shape), tuple(k.shape)))
        return flash(q, k, v, **kw)

    def lora_rec(x, w, a, b, scale):
        got["lora"].add(tuple(w.shape))
        return lora(x, w, a, b, scale)

    def scan_rec(x, *args, **kw):
        got["ssd"].add(tuple(x.shape))
        return scan(x, *args, **kw)

    def int8_rec(x):
        got["int8"].add(tuple(x.shape))
        return canon(x)

    fops.flash_attention, lops.lora_matmul = flash_rec, lora_rec
    ssd_ops.ssd_scan, sops._canon = scan_rec, int8_rec
    try:
        yield got
    finally:
        fops.flash_attention, lops.lora_matmul = flash, lora
        ssd_ops.ssd_scan, sops._canon = scan, canon


def p17_grad(torch, dev, wrappers, system, shard,
             ce_chunk=LLAMA_CE_CHUNK):
    """The fused LoRA backward on the global model's eval loss (as
    global_adapter_grad, on this rank's blocks of the base weights, the
    cross entropy in chunks of `ce_chunk`): returns its launches and
    each gradient's largest |value|."""
    from repro_torch.core.split import serve_adapters
    from repro_torch.models.common import ShardingPolicy
    from repro_torch.runtime.sharding import shard_client_batch
    from repro_torch.tree import tree_leaves, tree_map

    policy = ShardingPolicy.for_model(shard, system.arch)
    eff = serve_adapters(
        system.model, system.state["client_adapters"],
        system.state["server_adapters"], system.state["cuts"],
        system.cohort.rows(torch.as_tensor(system._weights32())),
        cohort=system.cohort)
    eff = tree_map(lambda x: x.detach().requires_grad_(True), eff)
    ebatch = shard_client_batch(system.eval_step.last[2], system.cohort)
    before = wrappers["lora_matmul_bwd"].launches
    with torch.enable_grad():
        per, _ = system.model.loss(
            system.base_params, eff,
            {k: torch.as_tensor(v, device=dev) for k, v in ebatch.items()},
            per_client=True, ce_chunk=ce_chunk, policy=policy)
        grads = torch.autograd.grad(per.sum(), tree_leaves(eff))
    torch.cuda.synchronize()
    if not all(torch.isfinite(g).all() for g in grads):
        raise RuntimeError("non-finite global-adapter gradient")
    return (wrappers["lora_matmul_bwd"].launches - before,
            [float(g.abs().max()) for g in grads])


def p17_block_bytes(params, mesh=None) -> int:
    """The bytes of base weights that param_specs gives each rank of
    `mesh` (the (1, P17_RANKS) mesh by default)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.sharding import axis_sizes, param_specs
    from repro_torch.tree import tree_leaves

    mesh = mesh or make_mesh(1, P17_RANKS)
    sizes = axis_sizes(mesh)
    total = 0
    for x, spec in zip(tree_leaves(params),
                       tree_leaves(param_specs(params, mesh))):
        share = 1
        for entry in spec:
            for a in (() if entry is None else entry if
                      isinstance(entry, tuple) else (entry,)):
                share *= sizes[a]
        total += x.numel() * x.element_size() // share
    return total


def p17_rank(rank: int, world: int, out_dir: str, device: str = "cuda"):
    """Phase 17 on one of P17_RANKS gloo ranks that share the card, on a
    (1, P17_RANKS) mesh (run by repro_torch.launch.sharded.run_ranks in a
    process of its own)."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.sharding import MeshShard

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    shard = MeshShard(make_mesh(1, world), device=dev, backend="gloo")
    feed = torch.load(Path(out_dir) / "p17_serve.pt", weights_only=False)
    got = {sm: sharded_run(torch, dev, port_wrappers(), shard,
                           p17_arch(sm), P17_ROUNDS, LLAMA_CE_CHUNK,
                           f"phase 17 {sm} gloo rank {rank} of {world} "
                           f"{shard.coords}", serve=feed[sm])
           for sm in P17_SMASHED}
    torch.save(got, Path(out_dir) / f"gloo_rank{rank}.pt")


def p17_want(run, smashed):
    """Launches per train and eval step on every run: the flash forward
    and backward once a layer, the int8 round trip twice a distinct cut
    (int8 only), the fused LoRA forward once a layer and target in the
    eval step; its backward in the global-adapter gradient."""
    targets = 4
    train = {"flash_attention_fwd": P17_LAYERS,
             "flash_attention_bwd": P17_LAYERS,
             "int8_roundtrip_smashed": 2 if smashed == "int8" else 0}
    ev = {"flash_attention_fwd": P17_LAYERS,
          "lora_matmul_fwd": targets * P17_LAYERS}
    for what, want, steps in (("train", train, run["train"]),
                              ("eval", ev, run["eval"])):
        for i, got in enumerate(steps):
            for k, c in want.items():
                if got[k] != c:
                    raise RuntimeError(f"phase 17 {smashed} {what} step {i} "
                                       f"launched {k} {got[k]} times, want "
                                       f"{c}")
    if run["lora_bwd"] != targets * P17_LAYERS:
        raise RuntimeError(f"phase 17 {smashed}: the fused LoRA backward "
                           f"launched {run['lora_bwd']} times")


def p17_kernels(torch, F, rand, worst, rows):
    """The kernels of phase 17's path at the TP-local shapes of a (1, 2)
    mesh (fp32): the flash forward and backward over 16 query heads and 4
    KV heads of 128 (B 10, S 512, causal) through time_flash_cases; the
    fused LoRA forward and backward at M 5120 (the eval step's rows) for
    wq (K 4096, N 2048), wk and wv (4096, 1024) and wo (2048, 4096), r 16
    (P17_LORA).  Each against its plain version first (worst takes the
    larger error at the TP rows), then timed beside the plain version
    and, for flash, SDPA; the LoRA rows are P17_WQ's."""
    errs = {hd_row(k, 128): 0.0 for k in WIDE_HD}
    got = time_flash_cases(torch, F, rand, errs, [
        (P17_ROWS[0], P17_ROWS[1], 5 * P17_BATCH, 512, 512, 16, 4, 128, True,
         "a llama3-8b train step's block on one of 2 \"model\" ranks")])
    for i, k in enumerate(("flash_attention_fwd", "flash_attention_bwd")):
        worst[P17_ROWS[i]] = max(worst[P17_ROWS[i]], errs[hd_row(k, 128)])
    rows.update(got)
    for kd, n in sorted(P17_LORA):
        lora_tp_rows(torch, rand, worst, rows, P17_ROWS[2], P17_ROWS[3],
                     5 * P17_BATCH * 512, kd, n, "wq's column block",
                     timed=(kd, n) == P17_WQ)
    log("phase 17: the kernels at the TP-local shapes agree with their "
        "plain versions: " + ", ".join(f"{k} {worst[k]:.3e}"
                                       for k in P17_ROWS)
        + f" (tol {TOL['float32']}, the LoRA's scaled by its rows)")
    log_tp_rows(torch, "phase 17", P17_ROWS, rows)


def log_tp_rows(torch, phase, names, rows):
    """One line per timed row of `names`: its kernel, plain, library and
    bound times, with the card."""
    for kname in names:
        row = rows[kname]
        lib = ("n/a" if row["library_ms"] is None
               else f"{row['library_ms']:.4f}")
        cc = ("" if row["cuda_core_bound"] is None else
              f"; fp32 CUDA-core bound {row['cuda_core_bound']:.4f} ms")
        log(f"{phase} [{torch.cuda.get_device_name(0)}, {card_line()}] "
            f"{kname} at {row['shape']}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{row['bound'][0]:.4f} ms ({row['bound'][1]}){cc}")


def p17_compare(got, want, what, smashed):
    """A sharded run's states and records against the unsharded run's:
    logs per round and state key the largest |diff| / max|leaf| and the
    share of a leaf's elements outside the tolerance, then holds them to
    P17_TOL (runtime.agreement)."""
    from repro_torch.runtime import agreement

    rtol, atol, loss_rtol = P17_TOL[smashed]
    seen = [agreement.check_state(a, b, rtol=rtol, atol_of_max=atol,
                                  outliers={k: 1.0 for k in b})
            for a, b in zip(got["states"], want["states"], strict=True)]
    loss = agreement.check_history(got["history"], want["history"],
                                   loss_rtol=1.0)
    log(f"{what}: per round and state key the largest |diff| / max|leaf| "
        "and the share of a leaf's elements outside the tolerance: "
        + "; ".join(f"round {r}: " + ", ".join(
            f"{k} {v:.3e} {o:.3e}" for k, (v, o) in g.items())
            for r, g in enumerate(seen))
        + f"; losses' largest relative difference {loss:.3e}")
    for a, b in zip(got["states"], want["states"]):
        agreement.check_state(a, b, rtol=rtol, atol_of_max=atol)
    agreement.check_history(got["history"], want["history"],
                            loss_rtol=loss_rtol)
    return max(v for g in seen for v, _ in g.values()), loss


def phase17(torch, dev, F, wrappers, name, card, launches, worst, rows):
    """Phase 17: parameter sharding of the dense family's training round,
    for each smashed compressor of P17_SMASHED.  Adds every run's
    launches to `launches` (the flash and fused LoRA kernels at the
    TP-local shapes to P17_ROWS, the rest to their rows), fills `worst`
    and `rows` at P17_ROWS."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharded import process_group, run_ranks
    from repro_torch.runtime import agreement
    from repro_torch.runtime.sharding import MeshShard

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 17)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_p17_"))
    try:
        plain = {sm: sharded_run(torch, dev, wrappers, None, p17_arch(sm),
                                 P17_ROUNDS, LLAMA_CE_CHUNK,
                                 f"phase 17 {sm} unsharded", serve={})
                 for sm in P17_SMASHED}
        feed = {sm: serve_feed(plain[sm]) for sm in P17_SMASHED}
        torch.save(feed, tmp / "p17_serve.pt")
        with process_group(0, 1, tmp / "nccl", backend="nccl"):
            shard = MeshShard(make_mesh(1, 1), device=dev)
            nccl = {sm: sharded_run(torch, dev, wrappers, shard,
                                    p17_arch(sm), P17_ROUNDS,
                                    LLAMA_CE_CHUNK, f"phase 17 {sm} "
                                    f"{shard.backend} world 1",
                                    serve=feed[sm])
                    for sm in P17_SMASHED}
            del shard
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        run_ranks(p17_rank, make_mesh(1, P17_RANKS), tmp / "gloo",
                  args=(str(tmp), dev.type))
        spawned = time.perf_counter() - t1
        gloo = [torch.load(tmp / f"gloo_rank{r}.pt", weights_only=False)
                for r in range(P17_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    gaps, served = {}, {}
    for sm in P17_SMASHED:
        agreement.same_bits(
            {k: nccl[sm][k] for k in ("states", "history")},
            {k: plain[sm][k] for k in ("states", "history")},
            f"phase 17 {sm} NCCL world 1")
        served[sm] = serve_checks(torch, plain[sm], nccl[sm],
                                  [g[sm] for g in gloo], f"phase 17 {sm}",
                                  P17_LAYERS)
        for run in [plain[sm], nccl[sm]] + [g[sm] for g in gloo]:
            p17_want(run, sm)
        gaps[sm] = p17_compare(gloo[0][sm], plain[sm],
                               f"phase 17 {sm} {P17_RANKS} gloo ranks", sm)
        for r, g in enumerate(x[sm] for x in gloo):
            if g["shapes"]["flash"] != P17_FLASH or \
                    g["shapes"]["lora"] != P17_LORA:
                raise RuntimeError(f"phase 17 {sm} gloo rank {r} ran its "
                                   f"kernels at {g['shapes']}, want flash "
                                   f"{P17_FLASH} and LoRA {P17_LORA}")
            if g["base_bytes"] != plain[sm]["block_bytes"]:
                raise RuntimeError(f"phase 17 {sm} gloo rank {r} holds "
                                   f"{g['base_bytes']} bytes of base "
                                   "weights, param_specs gives it "
                                   f"{plain[sm]['block_bytes']}")
            # each leaf narrowed as it is drawn: the init holds the rank's
            # blocks, one full leaf and the round state, never the tree
            bound = (g["base_bytes"] + plain[sm]["largest_leaf"]
                     + g["state_bytes"] + P17_INIT_SLACK)
            if g["init_peak"] > bound:
                raise RuntimeError(f"phase 17 {sm} gloo rank {r}: the init "
                                   f"peaked at {g['init_peak']} bytes, over "
                                   f"its blocks, one full leaf and the "
                                   f"state ({bound})")
    # the unsharded runs' kernels ran at the full shapes: their launches go
    # to the kernels' rows, the ranks' at the TP-local shapes to P17_ROWS
    tp_row = {"flash_attention_fwd": P17_ROWS[0],
              "flash_attention_bwd": P17_ROWS[1],
              "lora_matmul_fwd": P17_ROWS[2], "lora_matmul_bwd": P17_ROWS[3]}
    for runs, tp in [(plain, False), (nccl, False)] + [(g, True)
                                                       for g in gloo]:
        for run in runs.values():
            for step in run["train"] + run["eval"]:
                for k, c in step.items():
                    row = tp_row.get(k, k) if tp else hd_row(k, 128)
                    launches[row] += c
            launches[tp_row["lora_matmul_bwd"] if tp
                     else "lora_matmul_bwd"] += run["lora_bwd"]
            for step in run["serve"]["steps"]:
                for k, c in step.items():
                    launches[tp_row.get(k, k) if tp else hd_row(k, 128)] += c
    p17_kernels(torch, F, rand, worst, rows)
    partial_kernels(torch, dev, F, worst, rows)
    log(f"phase 17 [{name}, {card}]: llama3-8b at full width, "
        f"{P17_LAYERS} layers; NCCL at world size 1 on a (1, 1) mesh == "
        f"unsharded bit for bit; {P17_RANKS} gloo ranks on a (1, "
        f"{P17_RANKS}) mesh ran the flash kernels at {sorted(P17_FLASH)} "
        f"and the fused LoRA at {sorted(P17_LORA)}, per-step launches as "
        "the unsharded steps'; largest |diff| / max|leaf| and losses' "
        "relative difference "
        + ", ".join(f"{sm} {gaps[sm][0]:.3e} {gaps[sm][1]:.3e} (tol "
                    f"{P17_TOL[sm]})" for sm in P17_SMASHED)
        + "; base weights per process (GiB): unsharded "
        f"{plain[P17_SMASHED[0]]['base_bytes'] / 2**30:.3f}, gloo "
        f"{[round(g[P17_SMASHED[0]]['base_bytes'] / 2**30, 3) for g in gloo]}"
        + "; init peak per process (GiB): "
        + "; ".join(f"{sm} unsharded {plain[sm]['init_peak'] / 2**30:.3f}, "
                    f"NCCL {nccl[sm]['init_peak'] / 2**30:.3f}, gloo "
                    f"{[round(g[sm]['init_peak'] / 2**30, 3) for g in gloo]}"
                    f" (bound: blocks + largest leaf "
                    f"{plain[sm]['largest_leaf'] / 2**30:.3f} + state)"
                    for sm in P17_SMASHED)
        + "; peak per process (GiB): "
        + "; ".join(f"{sm} unsharded {plain[sm]['peak'] / 2**30:.3f}, NCCL "
                    f"{nccl[sm]['peak'] / 2**30:.3f}, gloo "
                    f"{[round(g[sm]['peak'] / 2**30, 3) for g in gloo]}"
                    for sm in P17_SMASHED)
        + "; served: " + "; ".join(f"{sm} {served[sm]}"
                                   for sm in P17_SMASHED)
        + f"; spawn + {P17_RANKS} ranks {spawned:.1f} s; the phase took "
        f"{time.perf_counter() - t0:.1f} s")


def serve_checks(torch, plain, nccl, gloo, what, attn_layers) -> str:
    """Phases 17 and 18's serving: NCCL at world size 1 bit for bit the
    unsharded serve, each gloo rank held by check_served, the gloo ranks'
    launches per step equal.  Returns the summary for the phase's log."""
    p, n = plain["serve"], nccl["serve"]
    check_served(torch, p, p, f"{what} unsharded serving", attn_layers,
                 False)
    check_served(torch, n, p, f"{what} NCCL world 1 serving", attn_layers,
                 False)
    if not (np.array_equal(n["logits"], p["logits"])
            and np.array_equal(n["tokens"], p["tokens"])):
        raise RuntimeError(f"{what}: NCCL world-1 serving is not the "
                           "unsharded serving bit for bit")
    gaps = []
    for r, g in enumerate(gloo):
        gaps.append(check_served(torch, g["serve"], p,
                                 f"{what} gloo rank {r} serving",
                                 attn_layers, True))
        if g["serve"]["steps"] != gloo[0]["serve"]["steps"]:
            raise RuntimeError(f"{what}: gloo rank {r} launched "
                               f"{g['serve']['steps']} per serving step, "
                               f"rank 0 {gloo[0]['serve']['steps']}")
    line = (f"NCCL world 1 bit for bit; {len(gloo)} gloo ranks (seq_lo "
            f"{[g['serve']['seq_lo'] for g in gloo]}, xseq_lo "
            f"{[g['serve']['xseq_lo'] for g in gloo]}, cache bytes "
            f"{[sum(g['serve']['cache_bytes'].values()) for g in gloo]} of "
            f"{sum(p['cache_bytes'].values())}): logits within "
            f"{[f'{x:.3e}' for x, _ in gaps]} x max|logit| (tol "
            f"{SERVE_TOL}), "
            f"tokens equal on {gaps[0][1]} of {p['tokens'].size} decided "
            f"steps; serving walls unsharded {p['wall']:.2f} s, gloo "
            f"{fmt([g['serve']['wall'] for g in gloo])} s")
    log(f"{what} serving: {line}")
    return line


def sdpa_with_lse(torch, q, k, v, scale):
    """(one PyTorch call that returns attention's output and log-sum-exp
    over q, k, v (B, H, L, E) views, its op's name): SDPA's flash op
    where it takes these strides, else its memory-efficient op."""
    def flash_op():
        return torch.ops.aten._scaled_dot_product_flash_attention(
            q, k, v, 0.0, False, False, scale=scale)[:2]

    def efficient_op():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            q, k, v, None, True, 0.0, False, scale=scale)[:2]

    try:
        flash_op()
        return flash_op, "flash"
    except RuntimeError as e:
        log(f"SDPA's flash op refused these views "
            f"({str(e).splitlines()[0]}); the efficient op instead")
        return efficient_op, "efficient"


def partial_held(torch, got, want, what) -> float:
    """The partial kernel's (o, lse) at a timed block against its plain
    version's: both compute in fp32 (from the same bf16 inputs at
    PARTIAL_32K), so they are held at TOL["float32"], absolute and
    relative, which is ~1% of the outputs' size at PARTIAL_32K (sqrt(e /
    16384) ~ 1.3e-2) and 1e-5 of the lse's (~10): the bf16 tolerance's
    absolute part would pass an output scaled by 0.7."""
    return max(max_err(torch, got[0], want[0], "float32",
                       f"partial decode at {what}"),
               max_err(torch, got[1], want[1], "float32",
                       f"partial decode lse at {what}"))


def partial_timed(torch, rand, worst, rows, row, shape, dt, what):
    """decode_attention_partial over one rank's block of a cache, shape =
    (B, block positions, cache positions, H, KVH, hd): the block is the
    last of the cache and every row's length the whole cache, so every
    position of the block is read.  Held against its plain version (in
    calls of P15_PLAIN_ROWS sequences) by partial_held, which must refuse
    a planted 1% output error and a 0.01 lse error; then timed beside
    the plain version, SDPA's op with its log-sum-exp (a GQA group's
    query heads folded into its query rows: the same function over a
    block whose positions are all valid) and the bound: the block's K
    and V read once (with q, the lengths and the outputs)."""
    from repro_torch.kernels.decode_attention import ops as dops

    b, n, total, h, kvh, hd = shape
    lo = total - n
    q = rand(b, h, hd, dtype=dt)
    k, v = (rand(b, n, kvh, hd, dtype=dt) for _ in range(2))
    clen = torch.full((b,), total, dtype=torch.int32, device=q.device)
    with torch.no_grad():
        got = dops.decode_attention_partial(q, k, v, clen, lo)
        step = P15_PLAIN_ROWS
        want = [dops.ref.decode_attention_partial(
            q[i:i + step], k[i:i + step], v[i:i + step], clen[i:i + step],
            lo) for i in range(0, b, step)]
        want = tuple(torch.cat([w[j] for w in want]) for j in range(2))
        worst[row] = max(worst[row], partial_held(torch, got, want, what))
        for bad, plant in (((got[0] * 0.99, got[1]), "an output 1% small"),
                           ((got[0], got[1] + 0.01), "an lse 0.01 large")):
            try:
                partial_held(torch, bad, want, what)
            except AssertionError:
                continue
            raise RuntimeError(f"partial decode at {what}: the check "
                               f"passes {plant}")
        del want

        def plain():
            for i in range(0, b, step):
                dops.ref.decode_attention_partial(
                    q[i:i + step], k[i:i + step], v[i:i + step],
                    clen[i:i + step], lo)

        # SDPA: the h / kvh query heads of a KV head as as many query rows
        # over its keys (every position valid), (B, KVH, rows, hd) views
        # of the cache's (B, S, KVH, hd)
        qs = q.reshape(b, kvh, h // kvh, hd)
        ks, vs = k.transpose(1, 2), v.transpose(1, 2)
        library, lib_name = sdpa_with_lse(torch, qs, ks, vs, hd ** -0.5)
        lib_ms = cuda_ms(torch, library, iters=10, warmup=2)
        lib_o = library()[0].reshape(b, h, hd)
        worst_lib = float((lib_o.float() - got[0]).abs().max())
        es = q.element_size()
        nbytes = 2 * b * n * kvh * hd * es + b * h * hd * es + 4 * b \
            + 4 * b * h * (hd + 1)
        dname = "bfloat16" if dt == torch.bfloat16 else "float32"
        rows[row] = dict(
            ms=cuda_ms(torch, lambda: dops.decode_attention_partial(
                q, k, v, clen, lo), iters=10, warmup=2),
            plain_ms=cuda_ms(torch, plain, iters=1, warmup=1),
            library_ms=lib_ms,
            bound=bound(nbytes, 4 * b * h * n * hd, dname),
            cuda_core_bound=None,
            shape=f"B={b}, positions {lo}..{total - 1} of a {total}-position "
                  f"cache (one of {total // n} ranks' blocks), H={h}/{kvh} "
                  f"hd={hd} {dname} (the plain version in "
                  f"{-(-b // step)} call(s) of up to {step} sequences; "
                  f"SDPA's {lib_name} op output {worst_lib:.3e} from the "
                  "kernel's)")
    del q, k, v, got
    torch.cuda.empty_cache()


def partial_kernels(torch, dev, F, worst, rows):
    """decode_attention_partial against its plain version at the serving
    shapes of phases 17 and 18 (llama3-8b's 32 heads over 8 of 128,
    kimi-k2's 64 over 8 of 112, zamba2's 32 over 32 of 64; fp32 and
    bf16; one rank's block of SERVE_CAP / 2 positions from seq_lo 128,
    and blocks from 37 (off a chunk edge) and 64 (on one), at cache
    lengths before, inside and past the block), each block's output
    merged with the rest's into the whole cache's plain decode; then
    held and timed by partial_timed at PARTIAL_32K (bf16) and at
    whisper's cross read, PARTIAL_CROSS (fp32)."""
    from repro_torch.kernels.decode_attention import ops as dops

    gen = torch.Generator(device=dev).manual_seed(SEED + 31)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    err = 0.0
    for h, kvh, hd in ((32, 8, 128), (64, 8, 112), (32, 32, 64)):
        for dname, dt in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
            for lo, n in ((SERVE_CAP // 2, SERVE_CAP // 2), (37, 96),
                          (64, 96)):
                b = 6
                q = rand(b, h, hd, dtype=dt)
                k, v = (rand(b, n, kvh, hd, dtype=dt) for _ in range(2))
                clen = torch.tensor([0, lo, lo + 1, lo + 63, lo + n,
                                     lo + n + 50], dtype=torch.int32,
                                    device=dev)
                o, lse = dops.decode_attention_partial(q, k, v, clen, lo)
                ro, rl = dops.ref.decode_attention_partial(q, k, v, clen, lo)
                empty = torch.isinf(rl)
                if not torch.equal(torch.isinf(lse), empty) or \
                        not torch.equal(o[empty.any(-1)],
                                        torch.zeros_like(o[empty.any(-1)])):
                    raise RuntimeError(f"partial decode ({h}/{kvh} hd {hd} "
                                       f"{dname}, seq_lo {lo}): an empty "
                                       "block is not zeros and -inf")
                err = max(err, max_err(
                    torch, o, ro, dname,
                    f"partial decode {h}/{kvh} hd {hd} seq_lo {lo}"),
                    max_err(torch, lse[~empty], rl[~empty], dname,
                            f"partial decode lse seq_lo {lo}"))
            # a cache split into 4 blocks, merged: the whole cache's decode
            s, b = 256, 5
            q = rand(b, h, hd, dtype=torch.float32)
            k, v = (rand(b, s, kvh, hd, dtype=torch.float32)
                    for _ in range(2))
            clen = torch.tensor([0, 1, 64, 129, 256], dtype=torch.int32,
                                device=dev)
            parts = [dops.decode_attention_partial(
                q, k[:, lo:lo + 64].contiguous(),
                v[:, lo:lo + 64].contiguous(), clen, lo)
                for lo in range(0, s, 64)]
            err = max(err, max_err(
                torch, dops.ref.merge_partials([o for o, _ in parts],
                                               [m for _, m in parts]),
                dops.ref.decode_attention(q, k, v, clen), "float32",
                f"partial decode merged {h}/{kvh} hd {hd}"))
    worst[PARTIAL_ROW] = max(worst[PARTIAL_ROW], err)

    partial_timed(torch, rand, worst, rows, PARTIAL_ROW, PARTIAL_32K,
                  torch.bfloat16, "decode_32k's half (bf16 inputs)")
    partial_timed(torch, rand, worst, rows, PARTIAL_X_ROW, PARTIAL_CROSS,
                  torch.float32, "whisper's cross read, one rank's half")
    log(f"partial decode: against its plain version {worst[PARTIAL_ROW]:.3e}"
        f", at whisper's cross read {worst[PARTIAL_X_ROW]:.3e} (tol "
        f"{TOL['float32']} fp32, {TOL['bfloat16']} bf16, the merged blocks "
        f"and the timed shapes at fp32; a planted 1% output or 0.01 lse "
        f"error refused at both timed shapes)")
    log_tp_rows(torch, "phase 17", (PARTIAL_ROW, PARTIAL_X_ROW), rows)


def p18_arch(model: str, smashed=None):
    """Phase 18's cut of `model` (kimi-k2 or zamba2-1.2b) at full width:
    its depth (and kimi-k2's experts), cut, P18_BATCH x M_SEQ, SGD; the
    smashed compressor `smashed`, or the config's own."""
    import dataclasses

    from repro_torch.configs import get_config

    arch = get_config(model)
    m = arch.model
    if model == KIMI:
        m = dataclasses.replace(m, num_layers=P18_KIMI_LAYERS,
                                num_experts=P18_KIMI_EXPERTS)
    else:
        m = dataclasses.replace(m, num_layers=P18_Z_LAYERS,
                                attn_layer_indices=P18_Z_ATTN)
    cut = P18_CUT[model]
    return arch.replace(
        model=m,
        split=dataclasses.replace(
            arch.split, cut_layer=cut, cut_buckets=(cut,),
            smashed_compress=smashed or arch.split.smashed_compress),
        train=dataclasses.replace(arch.train, batch_size=P18_BATCH,
                                  seq_len=M_SEQ, **P17_TRAIN))


def sharded_run(torch, dev, wrappers, shard, arch, n_rounds, ce_chunk,
                tag, replay=None, mesh=None, serve=None) -> dict:
    """n_rounds rounds of `arch` under `shard` (None or a MeshShard), the
    cross entropy in chunks of `ce_chunk`, weights drawn on the card, then
    the global-adapter gradient.  Returns the gathered state after each round
    (numpy), the records, per step its launches and wall seconds, the
    kernels' shapes, the gradient's launches and sizes, the bytes of base
    weights this process holds (unsharded: the bytes param_specs gives one
    rank of `mesh`, the (1, P17_RANKS) mesh by default), its init's peak
    and its max_memory_allocated over the rounds, and the bytes it
    all-reduced a round.  The audio and vlm families' batches carry their
    frontend's input (``with_frontend``).  An MoE model records each layer
    call's routing (recorded_routing) per round; replay: the unsharded
    run's per-round calls, whose choices this run routes by (its own flips
    against them counted); under a shard every rank's own choices are
    checked equal each round (check_agree).  serve: after the rounds the
    trained model serves (mesh_serve; {} greedily, else fed the tokens
    and routes it holds), its record under "serve".  The system and its
    weights are gone when it returns."""
    import functools

    from repro_torch.core import rounds
    from repro_torch.core.system import SplitFTSystem, SystemConfig
    from repro_torch.runtime.sharding import gather_state
    from repro_torch.tree import tree_leaves, tree_map

    moe = arch.model.family == "moe"
    # an earlier run's system is freed here (its cycles), so the peaks
    # below are this run's
    gc.collect()
    torch.cuda.empty_cache()
    factories = rounds.make_train_step, rounds.make_eval_step
    rounds.make_train_step, rounds.make_eval_step = (
        functools.partial(f, ce_chunk=ce_chunk) for f in factories)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    try:
        system = SplitFTSystem(arch, SystemConfig(
            num_samples=NUM_SAMPLES, eval_samples=EVAL_SAMPLES), seed=SEED,
            device=dev, draw_on_device=True, policy=shard)
    finally:
        rounds.make_train_step, rounds.make_eval_step = factories
    with_frontend(system)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() - held
    leaves = tree_leaves(system.base_params)
    base = sum(x.numel() * x.element_size() for x in leaves)
    largest = max(x.numel() * x.element_size() for x in leaves)
    state_bytes = sum(x.numel() * x.element_size()
                      for x in tree_leaves(system.state)
                      if isinstance(x, torch.Tensor) and x.is_cuda)
    block = (p17_block_bytes(system.base_params, mesh) if shard is None
             else base)
    train = system.train_step = TimedStep(torch, system.train_step, wrappers)
    ev = system.eval_step = TimedStep(torch, system.eval_step, wrappers)
    reduced0 = shard.bytes_reduced if shard is not None else 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    states, walls, routes, flips, drops = [], [], [], 0, []
    with recorded_shapes() as shapes:
        for r in range(n_rounds):
            t0 = time.perf_counter()
            with recorded_routing(on=moe, replay=(
                    None if replay is None else replay[r])) as calls:
                system.run(1, log_every=0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if moe:
                if shard is not None:
                    shard.check_agree(f"{tag} routing round {r}",
                                      *[c.numpy() for c, _ in calls])
                if replay is not None:
                    flips += routing_flips(torch, calls, replay[r])
                routes.append(calls)
                drops.append([share for _, share in calls])
            states.append(tree_map(lambda x: x.detach().cpu().numpy(),
                                   gather_state(system.state,
                                                system.cohort)))
            if not np.isfinite(system.history[-1]["loss"]):
                raise RuntimeError(f"{tag} round {r}: non-finite loss")
        peak = torch.cuda.max_memory_allocated()
        reduced = (shard.bytes_reduced - reduced0) if shard is not None \
            else 0
        bwd, gmax = p17_grad(torch, dev, wrappers, system, shard,
                             ce_chunk=ce_chunk)
    served = (None if serve is None else
              mesh_serve(torch, dev, wrappers, system, shard, tag, serve))
    out = {"states": states, "history": [dict(h) for h in system.history],
           "train": [c[1] for c in train.calls],
           "eval": [c[1] for c in ev.calls],
           "step_s": [(c[2], e[2]) for c, e in zip(train.calls, ev.calls)],
           "walls": walls, "shapes": shapes, "lora_bwd": bwd,
           "grad_max": gmax, "base_bytes": base, "block_bytes": block,
           "peak": peak, "init_peak": init_peak, "largest_leaf": largest,
           "state_bytes": state_bytes, "routes": routes, "flips": flips,
           "drops": drops, "round_bytes": reduced / n_rounds,
           "serve": served}
    del system, train, ev
    torch.cuda.empty_cache()
    log(f"{tag}: round walls {fmt([w * 1e3 for w in walls])} ms, train "
        f"steps {fmt([a * 1e3 for a, _ in out['step_s']])} ms, eval steps "
        f"{fmt([b * 1e3 for _, b in out['step_s']])} ms; "
        f"losses {[float(h['loss']) for h in out['history']]}; base "
        f"weights {base / 2**30:.3f} GiB, init peak {init_peak / 2**30:.3f} "
        f"GiB, max_memory_allocated {peak / 2**30:.3f} GiB; bytes "
        f"all-reduced a round {out['round_bytes']:.0f}"
        + (f"; routing flips against the unsharded run {flips}"
           if moe and replay is not None else ""))
    return out


def mesh_serve(torch, dev, wrappers, system, shard, tag, feed) -> dict:
    """The trained global model served on this run's blocks: serve_model
    (under a MeshShard the rank's base blocks, the adapters at their
    blocks and the policy), a cache from Model.init_cache under that
    policy (cache_specs' blocks: the KV sequence split over "model"), a
    prefill of SERVE_PROMPT seeded tokens for SERVE_BATCH rows (the audio
    family's with seeded frames), then SERVE_STEPS decode steps, each fed
    feed["tokens"]' next token (or the argmax of the step before), an MoE
    model routed by feed["routes"]' choices where given.  Returns per
    step the last position's logits, the argmax and the kernels launched,
    the bytes of each cache leaf of this process and those cache_specs
    gives it, its "seq_lo" and "xseq_lo", the decode steps' cache reads
    by kernel and block length ("reads": {("partial" or "whole",
    positions): calls}, from transformer._decode_read, which the self and
    the cross read share), and the MoE layer calls' routing."""
    from repro_torch.launch.cells import served_adapters
    from repro_torch.models import transformer
    from repro_torch.models.common import NO_SHARDING
    from repro_torch.runtime.sharding import axis_sizes, cache_specs
    from repro_torch.tree import tree_leaves, tree_leaves_with_path

    model = system.model
    got = system.serve_model()
    base, eff = got[0], got[1]
    policy = got[2] if len(got) == 3 else NO_SHARDING
    vocab = model.cfg.vocab_size
    prompt = np.random.default_rng(SEED + 21).integers(
        3, vocab, size=(SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    batch = {"tokens": torch.as_tensor(prompt, device=dev)}
    cfg = model.cfg
    if cfg.family == "audio":
        batch["frames"] = torch.as_tensor(frames_of(
            np.random.default_rng(SEED + 22),
            (SERVE_BATCH, cfg.encoder_seq_len, cfg.d_model)), device=dev)
    fed = feed.get("tokens")
    reads = {}
    read = transformer._decode_read

    def read_rec(q1, k, v, lens, seq_lo, **kw):
        key = ("whole" if seq_lo is None else "partial", int(k.shape[-3]))
        reads[key] = reads.get(key, 0) + 1
        return read(q1, k, v, lens, seq_lo, **kw)

    t0 = time.perf_counter()
    cache = model.init_cache((SERVE_BATCH,), SERVE_CAP, policy=policy)
    pool = served_adapters(eff, SERVE_BATCH)
    logits, toks, steps = [], [], []
    transformer._decode_read = read_rec
    try:
        with torch.no_grad(), recorded_routing(
                on=model.cfg.family == "moe", replay=feed.get("routes")) as calls:
            for i in range(1 + SERVE_STEPS):
                torch.cuda.synchronize()
                before = {k: w.launches for k, w in wrappers.items()}
                if i == 0:
                    lg, cache = model.prefill(base, pool, batch, cache,
                                              policy=policy)
                else:
                    nxt = fed[:, i - 1] if fed is not None else toks[-1]
                    lg, cache = model.decode_step(
                        base, pool, torch.as_tensor(nxt[:, None], device=dev),
                        cache, policy=policy)
                torch.cuda.synchronize()
                steps.append({k: w.launches - before[k]
                              for k, w in wrappers.items()
                              if w.launches != before[k]})
                row = lg[:, -1].float().cpu()
                if not torch.isfinite(row).all():
                    raise RuntimeError(f"{tag} serving step {i}: non-finite "
                                       "logits")
                logits.append(row.numpy())
                toks.append(row.argmax(-1).numpy().astype(np.int32))
    finally:
        transformer._decode_read = read
    wall = time.perf_counter() - t0
    nbytes = {"/".join(k): t.numel() * t.element_size()
              for k, t in tree_leaves_with_path(cache)
              if isinstance(t, torch.Tensor)}
    whole = model.init_cache((SERVE_BATCH,), SERVE_CAP)
    want = {}
    sizes = {} if shard is None else axis_sizes(shard.mesh)
    for (keys, leaf), spec in zip(
            tree_leaves_with_path(whole),
            tree_leaves(cache_specs(whole, shard.mesh)) if shard is not None
            else [()] * len(tree_leaves(whole))):
        share = 1
        for entry in spec:
            for a in (() if entry is None else entry if
                      isinstance(entry, tuple) else (entry,)):
                share *= sizes[a]
        want["/".join(keys)] = leaf.numel() * leaf.element_size() // share
    del whole
    out = {"logits": np.stack(logits, 1), "tokens": np.stack(toks, 1),
           "steps": steps, "cache_bytes": nbytes, "cache_want": want,
           "seq_lo": cache.get("seq_lo"), "xseq_lo": cache.get("xseq_lo"),
           "reads": reads, "routes": calls, "wall": wall}
    log(f"{tag} serving: prefill of {SERVE_PROMPT} tokens x "
        f"{SERVE_BATCH} + {SERVE_STEPS} decode steps into a cache of "
        f"{SERVE_CAP} ({sum(nbytes.values()) / 2**20:.1f} MiB here, "
        f"seq_lo {out['seq_lo']}, xseq_lo {out['xseq_lo']}) in {wall:.2f} "
        f"s; launches per step {steps}; reads {reads}")
    return out


def serve_feed(run) -> dict:
    """What the NCCL and gloo runs are fed: the unsharded run's served
    tokens and its MoE layer calls' routing."""
    sv = run["serve"]
    return {"tokens": sv["tokens"], "routes": sv["routes"] or None}


def check_served(torch, got, want, what, attn_layers, sharded):
    """A run's serving against the unsharded run's (fed its tokens): the
    cache's bytes are cache_specs' blocks, every decode step launched the
    decode kernel attn_layers times, once a cache read (an attention
    layer's, and a decoder layer's cross read: the partial kernel where
    the sequence is split), the logits within SERVE_TOL of max|logit| and
    the argmax the unsharded token wherever its top-2 gap is TOP2_GAP or
    more.  Returns (largest |diff| / max|logit|, steps compared by
    token)."""
    if got["cache_bytes"] != got["cache_want"]:
        raise RuntimeError(f"{what}: cache bytes {got['cache_bytes']}, "
                           f"cache_specs gives {got['cache_want']}")
    kern = "decode_attention_partial" if sharded else "decode_attention"
    other = "decode_attention" if sharded else "decode_attention_partial"
    for i, step in enumerate(got["steps"][1:], 1):
        if step.get(kern, 0) != attn_layers or step.get(other, 0):
            raise RuntimeError(f"{what}: decode step {i} launched {step}, "
                               f"want {kern} {attn_layers} times")
    a, b = got["logits"], want["logits"]
    scale = float(np.abs(b).max())
    gap = float(np.abs(a - b).max()) / scale
    if not gap <= SERVE_TOL:
        raise RuntimeError(f"{what}: served logits {gap:.3e} x max|logit| "
                           f"from the unsharded run's (tol {SERVE_TOL})")
    top2 = np.sort(b, -1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) >= TOP2_GAP
    if (got["tokens"] != want["tokens"])[decided].any():
        raise RuntimeError(f"{what}: served tokens {got['tokens'].tolist()}"
                           f" != unsharded {want['tokens'].tolist()}")
    return gap, int(decided.sum())


def p18_rank(rank: int, world: int, out_dir: str, device: str = "cuda",
             smashed=None):
    """Phase 18 on one of P17_RANKS gloo ranks that share the card, on a
    (1, P17_RANKS) mesh: each model of P18_MODELS (smashed: as
    p18_arch), the MoE one routed by the unsharded run's choices
    (p18_routes.pt in out_dir)."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.sharding import MeshShard

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    shard = MeshShard(make_mesh(1, world), device=dev, backend="gloo")
    replay = torch.load(Path(out_dir) / "p18_routes.pt", weights_only=False)
    feed = torch.load(Path(out_dir) / "p18_serve.pt", weights_only=False)
    got = {}
    for model in P18_MODELS:
        got[model] = sharded_run(
            torch, dev, port_wrappers(), shard, p18_arch(model, smashed),
            P18_ROUNDS,
            P18_CE_CHUNK[model], f"phase 18 {model} gloo rank {rank} of "
            f"{world} {shard.coords}", replay=replay.get(model),
            serve=feed[model])
        got[model].pop("routes")
        got[model]["serve"].pop("routes")
    torch.save(got, Path(out_dir) / f"p18_gloo_rank{rank}.pt")


def lora_tp_rows(torch, rand, worst, rows, fwd_row, bwd_row, m, kd, n,
                 what, timed=True):
    """The fused LoRA forward and backward at (M, K, N), r 16, fp32: held
    against their plain versions (worst's rows take the errors), then
    (`timed`) timed beside them and the bound at `rows`' rows."""
    from repro_torch.kernels.lora_matmul import ops as lops

    r = 16
    x, g = rand(m, kd), rand(m, n)
    w = rand(kd, n, scale=kd ** -0.5)
    a, bb = rand(kd, r, scale=r ** -0.5), rand(r, n, scale=0.02)
    sc = torch.tensor(2.0, device=x.device)
    y, xa = lops.lora_matmul_fwd(x, w, a, bb, sc)
    shape = f"M={m} K={kd} N={n}"
    worst[fwd_row] = max([worst[fwd_row]] + [
        max_err(torch, got_, want, "float32", f"TP lora fwd {shape}",
                scaled=True)
        for got_, want in zip((y, xa), lops.ref.lora_matmul_fwd(
            x, w, a, bb, sc))])
    worst[bwd_row] = max([worst[bwd_row]] + [
        max_err(torch, got_, want, "float32", f"TP lora bwd {shape}",
                scaled=True)
        for got_, want in zip(lops.lora_matmul_bwd(x, w, a, bb, sc, g, xa),
                              lops.ref.lora_matmul_bwd(x, w, a, bb, sc, g,
                                                       xa))])
    if not timed:
        return
    mat, low = 2 * m * kd * n, 2 * m * r * (kd + n)
    rows[fwd_row] = dict(
        ms=cuda_ms(torch, lambda: lops.lora_matmul_fwd(x, w, a, bb, sc)),
        plain_ms=cuda_ms(torch, lambda: lops.ref.lora_matmul_fwd(
            x, w, a, bb, sc)),
        library_ms=None,
        # read x, W, A, B; write y, xa
        **work(4 * (m * kd + kd * n + kd * r + r * n + m * n + m * r),
               mat + low, products=True),
        shape=f"{shape} r={r} fp32 ({what})")
    rows[bwd_row] = dict(
        ms=cuda_ms(torch, lambda: lops.lora_matmul_bwd(
            x, w, a, bb, sc, g, xa)),
        plain_ms=cuda_ms(torch, lambda: lops.ref.lora_matmul_bwd(
            x, w, a, bb, sc, g, xa)),
        library_ms=None,
        # read x, W, A, B, g, xa; write dx, dA, dB
        **work(4 * (2 * m * kd + kd * n + 2 * kd * r + 2 * r * n + m * n
                    + m * r), mat + 2 * low + 2 * m * r, products=True),
        shape=f"{shape} r={r} fp32 ({what})")
    del x, g, w, a, bb, y, xa
    torch.cuda.empty_cache()


def p18_kernels(torch, F, rand, worst, rows):
    """The kernels of phase 18's paths at the TP-local shapes of a (1, 2)
    mesh (fp32), each against its plain version first, then timed beside
    it, SDPA (flash) and the bound: the flash forward and backward over
    kimi-k2's 32 query heads and 4 KV heads of 112 and zamba2's 16 heads
    of 64 (B 10, S 512, causal); the fused LoRA forward and backward at
    M 5120 at kimi-k2's wq block (K 7168, N 3584) and zamba2's ssm_in
    block (K 2048, N 4256: the rank's x, z and dt columns and B, C); the
    SSD scan over zamba2's 32 heads of a rank (P 64, N 64, chunk
    256)."""
    errs = {k: 0.0 for k in ("flash_attention_fwd", "flash_attention_bwd",
                             hd_row("flash_attention_fwd", 112),
                             hd_row("flash_attention_bwd", 112),
                             "ssd_scan")}
    rows.update(time_flash_cases(torch, F, rand, errs, [
        (P18_ROWS[0], P18_ROWS[1], 10, 512, 512, 32, 4, 112, True,
         "a kimi-k2 train step's block on one of 2 \"model\" ranks"),
        (P18_ROWS[2], P18_ROWS[3], 10, 512, 512, 16, 16, 64, True,
         "a zamba2 train step's block on one of 2 \"model\" ranks")]))
    for i, (k, hd) in enumerate((("flash_attention_fwd", 112),
                                 ("flash_attention_bwd", 112),
                                 ("flash_attention_fwd", 64),
                                 ("flash_attention_bwd", 64))):
        worst[P18_ROWS[i]] = max(worst[P18_ROWS[i]], errs[hd_row(k, hd)])
    lora_tp_rows(torch, rand, worst, rows, P18_ROWS[4], P18_ROWS[5],
                 5 * P18_BATCH * M_SEQ, 7168, 3584,
                 "kimi-k2's wq column block")
    lora_tp_rows(torch, rand, worst, rows, P18_ROWS[6], P18_ROWS[7],
                 5 * P18_BATCH * M_SEQ, 2048, 4256,
                 "zamba2's ssm_in block: a rank's heads")
    rows[P18_ROWS[8]] = time_ssd_kernel(torch, rand, errs, P18_SSD_SHAPE)
    worst[P18_ROWS[8]] = max(worst[P18_ROWS[8]], errs["ssd_scan"])
    log("phase 18: the kernels at the TP-local shapes agree with their "
        "plain versions: " + ", ".join(f"{k} {worst[k]:.3e}"
                                       for k in P18_ROWS)
        + f" (tol {TOL['float32']}, the LoRA's and the SSD's scaled)")
    log_tp_rows(torch, "phase 18", P18_ROWS, rows)


def p18_same_launches(run, want, what):
    """Every train and eval step of `run` launched what the unsharded
    run's same step did, kernel by kernel."""
    for kind in ("train", "eval"):
        if len(run[kind]) != len(want[kind]):
            raise RuntimeError(f"{what}: {len(run[kind])} {kind} steps, "
                               f"unsharded {len(want[kind])}")
        for i, (got, ref) in enumerate(zip(run[kind], want[kind])):
            if got != ref:
                raise RuntimeError(f"{what} {kind} step {i} launched {got}, "
                                   f"the unsharded step {ref}")
    if run["lora_bwd"] != want["lora_bwd"]:
        raise RuntimeError(f"{what}: the fused LoRA backward launched "
                           f"{run['lora_bwd']} times, unsharded "
                           f"{want['lora_bwd']}")


def phase18(torch, dev, F, wrappers, name, card, launches, worst, rows,
            smashed=None):
    """Phase 18: parameter sharding of the MoE (EP over "model") and
    hybrid (TP over the SSM heads) families' training round, for each
    model of P18_MODELS: unsharded, under NCCL at world size 1 on a (1, 1)
    mesh (bit for bit the unsharded run) and in P17_RANKS gloo ranks that
    share the card on a (1, P17_RANKS) mesh (within P18_TOL, routed by
    the unsharded run's choices, flips counted).  Adds every run's
    launches to `launches` (the ranks' at the TP-local shapes to
    P18_ROWS), fills `worst` and `rows` at P18_ROWS.  smashed: every
    run's smashed compressor (as p18_arch; the configs' own by default,
    "none" to see the gap without codes at the cut)."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharded import process_group, run_ranks
    from repro_torch.runtime import agreement
    from repro_torch.runtime.sharding import MeshShard

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 18)

    def rand(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dtype).to(dev)

    archs = {m: p18_arch(m, smashed) for m in P18_MODELS}
    for model in P18_MODELS:
        m = archs[model].model
        log(f"phase 18: {model} at full width (d_model {m.d_model}, "
            f"{m.num_heads} heads over {m.num_kv_heads} of {m.head_dim}, "
            f"vocab {m.vocab_size}"
            + (f", {m.num_experts} of 384 experts top-{m.moe_top_k} at "
               f"capacity {m.moe_capacity_factor}, d_ff {m.moe_d_ff} per "
               f"expert, {m.num_shared_experts} shared"
               if m.family == "moe" else
               f", {m.ssm_heads} SSM heads of {m.ssm_head_dim}, state "
               f"{m.ssm_state}, attention at {list(m.attn_layer_indices)}")
            + f"), {m.num_layers} layers, cut {P18_CUT[model]}, 5 clients x "
            f"batch {P18_BATCH} x seq {M_SEQ}, SGD, smashed "
            f"{archs[model].split.smashed_compress}, {P18_ROUNDS} rounds")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_p18_"))
    try:
        plain = {m: sharded_run(torch, dev, wrappers, None, archs[m],
                                P18_ROUNDS, P18_CE_CHUNK[m],
                                f"phase 18 {m} unsharded", serve={})
                 for m in P18_MODELS}
        torch.save({m: plain[m]["routes"] for m in P18_MODELS
                    if plain[m]["routes"]}, tmp / "p18_routes.pt")
        feed = {m: serve_feed(plain[m]) for m in P18_MODELS}
        torch.save(feed, tmp / "p18_serve.pt")
        with process_group(0, 1, tmp / "nccl", backend="nccl"):
            shard = MeshShard(make_mesh(1, 1), device=dev)
            nccl = {m: sharded_run(torch, dev, wrappers, shard,
                                   archs[m], P18_ROUNDS,
                                   P18_CE_CHUNK[m], f"phase 18 {m} "
                                   f"{shard.backend} world 1",
                                   serve=feed[m])
                    for m in P18_MODELS}
            del shard
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        run_ranks(p18_rank, make_mesh(1, P17_RANKS), tmp / "gloo",
                  args=(str(tmp), dev.type, smashed))
        spawned = time.perf_counter() - t1
        gloo = [torch.load(tmp / f"p18_gloo_rank{r}.pt", weights_only=False)
                for r in range(P17_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    gaps, bad, served = {}, [], {}
    for model in P18_MODELS:
        sm = archs[model].split.smashed_compress
        agreement.same_bits(
            {k: nccl[model][k] for k in ("states", "history")},
            {k: plain[model][k] for k in ("states", "history")},
            f"phase 18 {model} NCCL world 1")
        m = archs[model].model
        served[model] = serve_checks(
            torch, plain[model], nccl[model], [g[model] for g in gloo],
            f"phase 18 {model}",
            len(m.attn_layer_indices) if m.family == "hybrid"
            else m.num_layers)
        for run, what in [(nccl[model], "NCCL world 1")] + [
                (g[model], f"gloo rank {r}") for r, g in enumerate(gloo)]:
            p18_same_launches(run, plain[model], f"phase 18 {model} {what}")
        if plain[model]["drops"]:
            # every MoE layer call of a train step drops pairs
            train = [s for rnd in plain[model]["drops"] for s in rnd]
            if not all(s > 0 for s in train):
                raise RuntimeError(f"phase 18 {model}: drop shares {train}: "
                                   "every layer call must drop pairs")
        rtol, atol, loss_rtol = P18_TOL[sm]
        seen = [agreement.check_state(a, b, rtol=rtol, atol_of_max=atol,
                                      outliers={k: 1.0 for k in b})
                for a, b in zip(gloo[0][model]["states"],
                                plain[model]["states"], strict=True)]
        loss = agreement.check_history(gloo[0][model]["history"],
                                       plain[model]["history"], loss_rtol=1.0)
        log(f"phase 18 {model} {P17_RANKS} gloo ranks: per round and state "
            "key the largest |diff| / max|leaf| and the share of a leaf's "
            "elements outside the tolerance: "
            + "; ".join(f"round {r}: " + ", ".join(
                f"{k} {v:.3e} {o:.3e}" for k, (v, o) in g.items())
                for r, g in enumerate(seen))
            + f"; losses' largest relative difference {loss:.3e}")
        gaps[model] = (max(v for g in seen for v, _ in g.values()), loss)
        try:
            for a, b in zip(gloo[0][model]["states"],
                            plain[model]["states"]):
                agreement.check_state(a, b, rtol=rtol, atol_of_max=atol,
                                      outliers=P18_OUTLIERS.get((model, sm),
                                                                {}))
            agreement.check_history(gloo[0][model]["history"],
                                    plain[model]["history"],
                                    loss_rtol=loss_rtol)
        except agreement.Mismatch as e:
            # the other model's results are logged before the phase fails
            bad.append(f"phase 18 {model}: {e}")
        for r, g in enumerate(x[model] for x in gloo):
            got = {k: g["shapes"][k] for k in ("flash", "lora", "ssd")}
            want = P18_SHAPES[model]
            if got != want:
                raise RuntimeError(f"phase 18 {model} gloo rank {r} ran its "
                                   f"kernels at {got}, want {want}")
            if g["base_bytes"] != plain[model]["block_bytes"]:
                raise RuntimeError(f"phase 18 {model} gloo rank {r} holds "
                                   f"{g['base_bytes']} bytes of base "
                                   "weights, param_specs gives it "
                                   f"{plain[model]['block_bytes']}")
            bound = (g["base_bytes"] + plain[model]["largest_leaf"]
                     + g["state_bytes"] + P17_INIT_SLACK)
            if g["init_peak"] > bound:
                raise RuntimeError(f"phase 18 {model} gloo rank {r}: the "
                                   f"init peaked at {g['init_peak']} bytes, "
                                   f"over its blocks, one full leaf and the "
                                   f"state ({bound})")
    # the unsharded runs' kernels ran at the full shapes: their launches go
    # to the kernels' rows, the ranks' at the TP-local shapes to P18_ROWS
    for model, hd, tp_row in (
            (KIMI, 112, {"flash_attention_fwd": P18_ROWS[0],
                         "flash_attention_bwd": P18_ROWS[1],
                         "lora_matmul_fwd": P18_ROWS[4],
                         "lora_matmul_bwd": P18_ROWS[5]}),
            ("zamba2-1.2b", 64, {"flash_attention_fwd": P18_ROWS[2],
                                 "flash_attention_bwd": P18_ROWS[3],
                                 "lora_matmul_fwd": P18_ROWS[6],
                                 "lora_matmul_bwd": P18_ROWS[7],
                                 "ssd_scan": P18_ROWS[8]})):
        for run, tp in [(plain[model], False), (nccl[model], False)] + [
                (g[model], True) for g in gloo]:
            for step in run["train"] + run["eval"]:
                for k, c in step.items():
                    launches[tp_row.get(k, k) if tp else hd_row(k, hd)] += c
            launches[tp_row["lora_matmul_bwd"] if tp
                     else "lora_matmul_bwd"] += run["lora_bwd"]
            for step in run["serve"]["steps"]:
                for k, c in step.items():
                    launches[hd_row(k, hd)] += c
    p18_kernels(torch, F, rand, worst, rows)
    gib = lambda x: round(x / 2**30, 3)  # noqa: E731
    for model in P18_MODELS:
        p, n = plain[model], nccl[model]
        ranks = [g[model] for g in gloo]
        log(f"phase 18 [{name}, {card}] {model}: NCCL at world size 1 on a "
            f"(1, 1) mesh == unsharded bit for bit; {P17_RANKS} gloo ranks "
            f"on a (1, {P17_RANKS}) mesh ran their kernels at "
            f"{P18_SHAPES[model]}, per-step launches as the unsharded "
            f"steps'; largest |diff| / max|leaf| {gaps[model][0]:.3e}, "
            f"losses' relative difference {gaps[model][1]:.3e} (tol "
            f"{P18_TOL[archs[model].split.smashed_compress]})"
            + (f"; routing flips against the unsharded run "
               f"{[g['flips'] for g in ranks]}, dropped share per layer "
               f"call {fmt(p['drops'][0])}" if p["drops"] else "")
            + f"; base weights (GiB): unsharded {gib(p['base_bytes'])}, "
            f"gloo {[gib(g['base_bytes']) for g in ranks]}; init peak "
            f"(GiB): unsharded {gib(p['init_peak'])}, NCCL "
            f"{gib(n['init_peak'])}, gloo "
            f"{[gib(g['init_peak']) for g in ranks]}"
            f" (bound: blocks + largest leaf {gib(p['largest_leaf'])} + "
            f"state); train peak (GiB): unsharded {gib(p['peak'])}, NCCL "
            f"{gib(n['peak'])}, gloo {[gib(g['peak']) for g in ranks]}; "
            f"train steps (ms): unsharded "
            f"{fmt([a * 1e3 for a, _ in p['step_s']])}, gloo rank 0 "
            f"{fmt([a * 1e3 for a, _ in ranks[0]['step_s']])}; eval steps "
            f"(ms): unsharded {fmt([b * 1e3 for _, b in p['step_s']])}, "
            f"gloo rank 0 {fmt([b * 1e3 for _, b in ranks[0]['step_s']])}; "
            f"bytes all-reduced a round per gloo rank "
            f"{[round(g['round_bytes']) for g in ranks]}; served: "
            f"{served[model]}")
    log(f"phase 18 [{name}, {card}]: spawn + {P17_RANKS} ranks "
        f"{spawned:.1f} s; the phase took {time.perf_counter() - t0:.1f} s")
    if bad:
        raise RuntimeError("; ".join(bad))


def with_frontend(system):
    """The system's train and eval batches with its family's frontend
    input (which the data pipeline does not make): the audio family's
    frames ([N, B, 1500, d]), the vlm family's prefix, drawn per round
    from SEED as frames_of draws them; other families' batches as they
    are.  Returns the system."""
    cfg = system.arch.model
    key = {"audio": "frames", "vlm": "prefix"}.get(cfg.family)
    if key is None:
        return system
    length = (cfg.encoder_seq_len if key == "frames"
              else cfg.frontend_prefix_len)
    train, ev = system._train_batch, system._eval_batch

    def add(batch, seed):
        n, b = batch["tokens"].shape[:2]
        return dict(batch, **{key: frames_of(np.random.default_rng(seed),
                                             (n, b, length, cfg.d_model))})

    system._train_batch = lambda r: add(train(r), SEED + 190 + r)
    system._eval_batch = lambda r: add(ev(r), SEED + 1190 + r)
    return system


def p19_arch(model: str):
    """Phase 19's cut of `model` at full width: whisper-medium at
    P19_W_ENC + P19_W_DEC layers over W_SEQ tokens, internvl2-76b at
    P19_V_LAYERS over P19_V_SEQ; cut P19_CUT, 5 clients x batch
    P19_BATCH, SGD, smashed none; "pod": phase 16's gpt2-small with SGD
    (int8 at the cut) at P19_POD_LAYERS layers."""
    import dataclasses

    from repro_torch.configs import get_config

    if model == "pod":
        arch = p16_arch("sgd")
        return arch.replace(
            model=dataclasses.replace(arch.model,
                                      num_layers=P19_POD_LAYERS),
            split=dataclasses.replace(arch.split, cut_buckets=(
                arch.split.cut_layer,)))
    arch = get_config(model)
    if model == WHISPER:
        m = dataclasses.replace(arch.model, num_layers=P19_W_DEC,
                                num_encoder_layers=P19_W_ENC)
        seq = W_SEQ
    else:
        m = dataclasses.replace(arch.model, num_layers=P19_V_LAYERS)
        seq = P19_V_SEQ
    return arch.replace(
        model=m,
        split=dataclasses.replace(arch.split, cut_layer=P19_CUT,
                                  cut_buckets=(P19_CUT,),
                                  smashed_compress="none"),
        data=dataclasses.replace(arch.data, num_clients=5),
        train=dataclasses.replace(arch.train, batch_size=P19_BATCH,
                                  seq_len=seq, **P17_TRAIN))


P19_CE_CHUNK = {WHISPER: 0, VLM: LLAMA_CE_CHUNK, "pod": 0}


def p19_mesh(model: str):
    from repro_torch.launch.mesh import make_mesh

    if model == "pod":
        pod, data, tp = P19_POD_MESH
        return make_mesh(data, tp, pod=pod)
    return make_mesh(1, P17_RANKS)


def p19_rank(rank: int, world: int, out_dir: str, models, device="cuda"):
    """Phase 19 on one of `world` gloo ranks that share the card: each of
    `models` on its mesh (p19_mesh), sequence parallelism at the
    reference's default (on for these families); whisper then serves,
    fed the unsharded run's tokens (p19_serve.pt in out_dir)."""
    import torch

    from repro_torch.runtime.sharding import MeshShard

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    feed = torch.load(Path(out_dir) / "p19_serve.pt", weights_only=False)
    got = {}
    for model in models:
        shard = MeshShard(p19_mesh(model), device=dev, backend="gloo")
        got[model] = sharded_run(
            torch, dev, port_wrappers(), shard, p19_arch(model),
            P19_ROUNDS[model],
            P19_CE_CHUNK[model], f"phase 19 {model} gloo rank {rank} of "
            f"{world} {shard.coords}", serve=feed.get(model))
        got[model].pop("routes")
        del shard
    torch.save(got, Path(out_dir) / f"p19_gloo_rank{rank}_{world}.pt")


def p19_kernels(torch, F, rand, worst, rows):
    """The kernels of phase 19's paths at the TP-local shapes of a (1, 2)
    mesh (fp32), each against its plain version first, then timed beside
    it, SDPA (flash) and the bound: the flash forward and backward over 8
    of whisper-medium's 16 heads of 64 (B 10) at the encoder (S 1500,
    non-causal), the cross read (448 queries over 1500 keys) and the
    decoder (S 448, causal), the encoder's in the result line; over 32 of
    internvl2-76b's 64 heads and 4 of its 8 KV heads of 128 (B 10, S 512,
    causal); the fused LoRA forward and backward at M 5120 (internvl2's
    eval step) at its wq block (K 8192, N 4096, timed) and w_in block (K
    8192, N 14336, held); the int8 round trip over the pod run's gathered
    message (4 clients x 4 rows x 512 x 768)."""
    from repro_torch.kernels.smashed_quant import ops as sops

    errs = {k: 0.0 for k in ("flash_attention_fwd", "flash_attention_bwd",
                             hd_row("flash_attention_fwd", 128),
                             hd_row("flash_attention_bwd", 128))}
    w_cases = [("encoder", 1500, 1500, False), ("cross", 448, 1500, False),
               ("decoder", 448, 448, True)]
    for what, sq, sk, causal in w_cases:
        got = time_flash_cases(torch, F, rand, errs, [
            (f"{P19_ROWS[0]} {what}", f"{P19_ROWS[1]} {what}", 10, sq, sk,
             8, 8, 64, causal, f"whisper's {what} on one of 2 \"model\" "
             "ranks")])
        if what != "encoder":       # the encoder's is logged with the rows
            log_tp_rows(torch, "phase 19", list(got), got)
        else:
            rows[P19_ROWS[0]] = got[f"{P19_ROWS[0]} {what}"]
            rows[P19_ROWS[1]] = got[f"{P19_ROWS[1]} {what}"]
    rows.update(time_flash_cases(torch, F, rand, errs, [
        (P19_ROWS[2], P19_ROWS[3], 10, P19_V_SEQ, P19_V_SEQ, 32, 4, 128,
         True, "an internvl2-76b train step's block on one of 2 \"model\" "
         "ranks")]))
    for i, k in enumerate(("flash_attention_fwd", "flash_attention_bwd",
                           hd_row("flash_attention_fwd", 128),
                           hd_row("flash_attention_bwd", 128))):
        worst[P19_ROWS[i]] = max(worst[P19_ROWS[i]], errs[k])
    for kd, n in P19_LORA:
        lora_tp_rows(torch, rand, worst, rows, P19_ROWS[4], P19_ROWS[5],
                     5 * P19_BATCH * P19_V_SEQ, kd, n,
                     "internvl2-76b's wq column block",
                     timed=(kd, n) == P19_LORA[0])
    xs = rand(*P19_INT8)
    g, m, d = P19_INT8[0], P19_INT8[1] * P19_INT8[2], P19_INT8[3]
    worst[P19_ROWS[6]] = max(worst[P19_ROWS[6]], max_err(
        torch, sops.int8_roundtrip_smashed(xs).reshape(g, m, d),
        sops.ref.roundtrip(xs.reshape(g, m, d)), "float32",
        "int8 round trip, the gathered message"))
    rows[P19_ROWS[6]] = dict(
        ms=cuda_ms(torch, lambda: sops.int8_roundtrip_smashed(xs)),
        plain_ms=cuda_ms(torch, lambda: sops.ref.roundtrip(
            xs.reshape(g, m, d))),
        library_ms=None,
        # read x, write its round trip
        **work(4 * 2 * g * m * d, 6 * g * m * d),
        shape=f"G={g} M={m} d={d} fp32 (the pod run's message, gathered "
              "over \"pod\" and \"model\" at the cut)")
    del xs
    torch.cuda.empty_cache()
    log("phase 19: the kernels at the TP-local shapes agree with their "
        "plain versions: " + ", ".join(f"{k} {worst[k]:.3e}"
                                       for k in P19_ROWS)
        + f" (tol {TOL['float32']}, the LoRA's scaled by its rows)")
    log_tp_rows(torch, "phase 19", P19_ROWS, rows)


def p19_check(run, want, model, what, bad):
    """A gloo rank's run of `model` against the unsharded run: shapes,
    launches per step, bytes held and the init's peak (raise); its state
    and records within P19_TOL (appended to `bad`).  Returns the largest
    |diff| / max|leaf| and the losses' relative difference."""
    from repro_torch.runtime import agreement

    got = {k: run["shapes"][k] for k in ("flash", "lora", "int8")}
    if got != P19_SHAPES[model]:
        raise RuntimeError(f"{what} ran its kernels at {got}, want "
                           f"{P19_SHAPES[model]}")
    p18_same_launches(run, want, what)
    if run["base_bytes"] != want["block_bytes"]:
        raise RuntimeError(f"{what} holds {run['base_bytes']} bytes of base "
                           f"weights, param_specs gives it "
                           f"{want['block_bytes']}")
    bound = (run["base_bytes"] + want["largest_leaf"] + run["state_bytes"]
             + P17_INIT_SLACK)
    if run["init_peak"] > bound:
        raise RuntimeError(f"{what}: the init peaked at {run['init_peak']} "
                           f"bytes, over its blocks, one full leaf and the "
                           f"state ({bound})")
    rtol, atol, loss_rtol = P19_TOL[model]
    seen = [agreement.check_state(a, b, rtol=rtol, atol_of_max=atol,
                                  outliers={k: 1.0 for k in b})
            for a, b in zip(run["states"], want["states"], strict=True)]
    loss = agreement.check_history(run["history"], want["history"],
                                   loss_rtol=1.0)
    log(f"{what}: per round and state key the largest |diff| / max|leaf| "
        "and the share of a leaf's elements outside the tolerance: "
        + "; ".join(f"round {r}: " + ", ".join(
            f"{k} {v:.3e} {o:.3e}" for k, (v, o) in g.items())
            for r, g in enumerate(seen))
        + f"; losses' largest relative difference {loss:.3e}")
    try:
        for a, b in zip(run["states"], want["states"]):
            agreement.check_state(a, b, rtol=rtol, atol_of_max=atol)
        agreement.check_history(run["history"], want["history"],
                                loss_rtol=loss_rtol)
    except agreement.Mismatch as e:
        bad.append(f"{what}: {e}")
    return max(v for g in seen for v, _ in g.values()), loss


def phase19(torch, dev, F, wrappers, name, card, launches, worst, rows):
    """Phase 19: parameter sharding of the audio and vlm families' training
    round under sequence parallelism, and the "pod" axis: each model of
    P19_MODELS and the pod run unsharded, under NCCL at world size 1 on a
    mesh of ones (bit for bit the unsharded run), and in gloo ranks that
    share the card (P17_RANKS on (1, P17_RANKS) for the two models, one
    spawn; 4 on P19_POD_MESH for the pod run, another), each held by
    p19_check.  After its round each whisper run serves (mesh_serve: the
    cross cache split over "model" on the gloo ranks, read through the
    partial kernel and the lse merge), held by serve_checks.  Adds every
    run's launches to `launches` (the ranks' to P19_ROWS, their cross
    reads' partial launches to PARTIAL_X_ROW), fills `worst` and `rows`
    at P19_ROWS."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharded import process_group, run_ranks
    from repro_torch.runtime import agreement
    from repro_torch.runtime.sharding import MeshShard

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 19)

    def rand(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dtype).to(dev)

    models = P19_MODELS + ("pod",)
    for model in models:
        arch = p19_arch(model)
        m = arch.model
        log(f"phase 19: {model} ({arch.name}) at full width (d_model "
            f"{m.d_model}, {m.num_heads} heads over {m.num_kv_heads} of "
            f"{m.head_dim}, vocab {m.vocab_size}), {m.num_layers} layers"
            + (f" + {m.num_encoder_layers} encoder layers over "
               f"{m.encoder_seq_len} frames" if m.family == "audio" else "")
            + (f", a {m.frontend_prefix_len}-position prefix"
               if m.family == "vlm" else "")
            + f", cut {arch.split.cut_layer}, {arch.data.num_clients} "
            f"clients x batch {arch.train.batch_size} x seq "
            f"{arch.train.seq_len}, SGD, smashed "
            f"{arch.split.smashed_compress}, {P19_ROUNDS[model]} round(s); "
            f"mesh "
            f"{dict(zip(p19_mesh(model).axes, p19_mesh(model).shape))}")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_p19_"))
    spawned = {}
    try:
        plain = {m: sharded_run(torch, dev, wrappers, None, p19_arch(m),
                                P19_ROUNDS[m], P19_CE_CHUNK[m],
                                f"phase 19 {m} unsharded", mesh=p19_mesh(m),
                                serve={} if m == WHISPER else None)
                 for m in models}
        feed = {WHISPER: serve_feed(plain[WHISPER])}
        torch.save(feed, tmp / "p19_serve.pt")
        nccl = {}
        with process_group(0, 1, tmp / "nccl", backend="nccl"):
            for m in models:
                ones = (make_mesh(1, 1, pod=1) if m == "pod"
                        else make_mesh(1, 1))
                shard = MeshShard(ones, device=dev)
                nccl[m] = sharded_run(torch, dev, wrappers, shard,
                                      p19_arch(m), P19_ROUNDS[m],
                                      P19_CE_CHUNK[m], f"phase 19 {m} "
                                      f"{shard.backend} world 1",
                                      serve=feed.get(m))
                del shard
        torch.cuda.empty_cache()
        gloo = {}
        for group, world in ((P19_MODELS, P17_RANKS),
                             (("pod",), p19_mesh("pod").num_devices)):
            t1 = time.perf_counter()
            run_ranks(p19_rank, world, tmp / f"gloo{world}",
                      args=(str(tmp), group, dev.type))
            spawned[world] = time.perf_counter() - t1
            ranks = [torch.load(tmp / f"p19_gloo_rank{r}_{world}.pt",
                                weights_only=False) for r in range(world)]
            for m in group:
                gloo[m] = [g[m] for g in ranks]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    gaps, bad = {}, []
    for m in models:
        agreement.same_bits(
            {k: nccl[m][k] for k in ("states", "history")},
            {k: plain[m][k] for k in ("states", "history")},
            f"phase 19 {m} NCCL world 1")
        p18_same_launches(nccl[m], plain[m], f"phase 19 {m} NCCL world 1")
        got = [p19_check(g, plain[m], m, f"phase 19 {m} gloo rank {r}",
                         bad) for r, g in enumerate(gloo[m])]
        gaps[m] = got[0]
    # whisper's serving: each decoder layer reads its self and its cross
    # cache once a decode step
    served = serve_checks(torch, plain[WHISPER], nccl[WHISPER],
                          gloo[WHISPER], "phase 19 whisper-medium",
                          2 * P19_W_DEC)
    # the unsharded runs' kernels ran at the full shapes: their launches go
    # to the kernels' rows, the ranks' at the TP-local shapes to P19_ROWS
    for m, hd in ((WHISPER, 64), (VLM, 128), ("pod", 64)):
        tp_row = {"flash_attention_fwd": P19_ROWS[0 if hd == 64 else 2],
                  "flash_attention_bwd": P19_ROWS[1 if hd == 64 else 3],
                  "lora_matmul_fwd": P19_ROWS[4],
                  "lora_matmul_bwd": P19_ROWS[5],
                  "int8_roundtrip_smashed": P19_ROWS[6]}
        for run, tp in [(plain[m], False), (nccl[m], False)] + [
                (g, True) for g in gloo[m]]:
            sv = run["serve"]
            for step in run["train"] + run["eval"] + (
                    sv["steps"] if sv else []):
                for k, c in step.items():
                    launches[tp_row.get(k, k) if tp else hd_row(k, hd)] += c
            launches[tp_row["lora_matmul_bwd"] if tp
                     else "lora_matmul_bwd"] += run["lora_bwd"]
            if sv and tp:   # the cross reads' launches to their own row
                cross = sv["reads"].get(
                    ("partial", p19_arch(m).model.encoder_seq_len
                     // P17_RANKS), 0)
                launches[PARTIAL_ROW] -= cross
                launches[PARTIAL_X_ROW] += cross
    p19_kernels(torch, F, rand, worst, rows)
    gib = lambda x: round(x / 2**30, 3)  # noqa: E731
    for m in models:
        p, n, ranks = plain[m], nccl[m], gloo[m]
        log(f"phase 19 [{name}, {card}] {m}: NCCL at world size 1 == "
            f"unsharded bit for bit; {len(ranks)} gloo ranks on "
            f"{p19_mesh(m).shape} ran their kernels at {P19_SHAPES[m]}, "
            f"per-step launches as the unsharded steps'; largest |diff| / "
            f"max|leaf| {gaps[m][0]:.3e}, losses' relative difference "
            f"{gaps[m][1]:.3e} (tol {P19_TOL[m]}); losses unsharded "
            f"{[float(h['loss']) for h in p['history']]}; base weights "
            f"(GiB): unsharded {gib(p['base_bytes'])}, gloo "
            f"{[gib(g['base_bytes']) for g in ranks]}; init peak (GiB): "
            f"unsharded {gib(p['init_peak'])}, NCCL {gib(n['init_peak'])}, "
            f"gloo {[gib(g['init_peak']) for g in ranks]} (bound: blocks + "
            f"largest leaf {gib(p['largest_leaf'])} + state); train peak "
            f"(GiB): unsharded {gib(p['peak'])}, NCCL {gib(n['peak'])}, "
            f"gloo {[gib(g['peak']) for g in ranks]}; train steps (ms): "
            f"unsharded {fmt([a * 1e3 for a, _ in p['step_s']])}, gloo "
            f"rank 0 {fmt([a * 1e3 for a, _ in ranks[0]['step_s']])}; eval "
            f"steps (ms): unsharded {fmt([b * 1e3 for _, b in p['step_s']])}"
            f", gloo rank 0 {fmt([b * 1e3 for _, b in ranks[0]['step_s']])}"
            f"; bytes all-reduced a round per gloo rank "
            f"{[round(g['round_bytes']) for g in ranks]}")
    log(f"phase 19 [{name}, {card}] whisper-medium served after its "
        f"round: {served}")
    log(f"phase 19 [{name}, {card}]: spawns (world: s) "
        f"{ {w: round(s, 1) for w, s in spawned.items()} }; the phase took "
        f"{time.perf_counter() - t0:.1f} s")
    if bad:
        raise RuntimeError("; ".join(bad))


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
