#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from src/repro_torch/csrc, holds each
against its plain PyTorch version on the card (fp32 and bf16), times it
beside its bound, the plain version and a library call, then serves
full-width gpt2-small (12 layers, random weights from a seed, 4 LoRA
adapters) through ServingEngine, contiguous and paged, and checks the
tokens and logits.  Every phase that fails raises, so the exit code is
non-zero; without a GPU it exits 1 before printing any result.  The last
line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launches on the main path and their times.

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
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOGITS_TOL = 1e-3
TOP2_GAP = 1e-4

# main path: full-width gpt2-small serving
N_REQUESTS, PROMPT, GEN, SLOTS, MAX_LEN, PAGE = 16, 128, 32, 8, 256, 16
RANKS = [16, 8, 16, 4]
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


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


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_busy(torch, run):
    """Run `run` under torch.profiler's CUDA activity.  Returns (wall s,
    device-busy s or None, {kernel name: device s}); busy is the union of
    the recorded device intervals, None when nothing was recorded."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                (e.time_range.end - e.time_range.start) * 1e-6
    if not spans:
        return wall, None, {}
    busy, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in sorted(spans):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    return wall, busy * 1e-6, by_name


def max_err(torch, got, want, dtype: str, what: str) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype],
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

    gen = torch.Generator().manual_seed(SEED)

    def rand(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dtype).to(dev)

    wrappers = {"flash_attention_fwd": fops.flash_attention_fwd,
                "lora_matmul_indexed": lops.lora_matmul_indexed,
                "decode_attention": dops.decode_attention,
                "decode_attention_paged": dops.decode_attention_paged}
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
            e = max_err(torch, dops.decode_attention_paged(q, kp, vp, pt, clen,
                                                           window=window),
                        dops.ref.decode_attention_paged(q, kp, vp, pt, clen,
                                                        window=window),
                        dname, f"paged decode window={window}")
            errs["decode_attention_paged"] = max(
                errs["decode_attention_paged"], e)
        log(f"phase 2 ({dname}, tol {TOL[dname]}): max |kernel - plain| "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        if dname == "float32":
            worst = errs

    # -- phase 3: times at the main path's shapes (fp32) --------------------
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
        bound=bound(4 * (4 * b * s * h * hd + b * h * s),
                    4 * hd * h * b * pairs, "float32"),
        shape=f"B={b} S={s} H={h} hd={hd} causal fp32")
    m, kd, r = SLOTS, 768, 16
    args = lora_args(torch, rand, m, torch.float32, gen)
    n_ids = int(torch.unique(args[5]).numel())
    rows["lora_matmul_indexed"] = dict(
        ms=cuda_ms(torch, lambda: lops.lora_matmul_indexed(*args)),
        plain_ms=cuda_ms(torch, lambda: lops.ref.lora_matmul_indexed(*args)),
        library_ms=None,
        bound=bound(4 * (m * kd + kd * kd + n_ids * 2 * kd * r + m * kd
                         + 4 + m),
                    2 * m * kd * kd + 4 * m * kd * r, "float32"),
        shape=f"M={m} K=N={kd} r={r} P=4 fp32")
    lens = [128 + 4 * i for i in range(SLOTS)]
    q1, kc, vc, clen = decode_args(torch, rand, torch.float32, dev,
                                   s=MAX_LEN, lens=lens)
    kp, vp, pt = paged_args(torch, kc, vc, gen, dev, ps=PAGE)
    tot = sum(lens)
    dec_bytes = 4 * (2 * SLOTS * 12 * 64 + 2 * tot * 12 * 64 + SLOTS)
    dec_flops = 4 * tot * 12 * 64
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
        bound=bound(dec_bytes, dec_flops, "float32"),
        shape=f"B={SLOTS} S={MAX_LEN} cache_len {lens[0]}..{lens[-1]} fp32")
    rows["decode_attention_paged"] = dict(
        ms=cuda_ms(torch, lambda: dops.decode_attention_paged(
            q1, kp, vp, pt, clen)),
        plain_ms=cuda_ms(torch, lambda: dops.ref.decode_attention_paged(
            q1, kp, vp, pt, clen)),
        library_ms=None,
        bound=bound(dec_bytes + 4 * pt.numel(), dec_flops, "float32"),
        shape=f"B={SLOTS} ps={PAGE} cache_len {lens[0]}..{lens[-1]} fp32")
    for kname, row in rows.items():
        lib = ("n/a" if row["library_ms"] is None
               else f"{row['library_ms']:.4f}")
        log(f"phase 3 [{name}, {card}] {kname} at {row['shape']}: kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
            f"{lib} ms, bound {row['bound'][0]:.4f} ms ({row['bound'][1]})")

    # -- phase 4: the main path ---------------------------------------------
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

    # -- phase 5: results -----------------------------------------------------
    sources = {"flash_attention_fwd": ("src/repro_torch/csrc/flash_fwd.cu",
                                       "src/repro/kernels/flash_attention/"
                                       "kernel.py:151"),
               "lora_matmul_indexed": ("src/repro_torch/csrc/lora_indexed.cu",
                                       "src/repro/kernels/lora_matmul/"
                                       "kernel.py:186"),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention/"
                                    "kernel.py:187"),
               "decode_attention_paged": (
                   "src/repro_torch/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention/kernel.py:133")}
    kernels = []
    for kname, (src, replaces) in sources.items():
        row = rows[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
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
    wall, busy, by_name = device_busy(torch, lambda: engine.run(again))
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
