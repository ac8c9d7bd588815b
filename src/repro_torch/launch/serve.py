"""Serving CLI of the PyTorch port: continuous-batching multi-adapter
inference on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \
      --adapters 4 --requests 16 --num-slots 8 --page-size 16

Thin CLI over runtime.serving.ServingEngine: builds a random base model
and a stacked adapter pool from --seed, synthesizes a Poisson request
workload, runs the engine and prints latency and throughput.  With
--ckpt the pool is a SplitFT checkpoint's per-client adapters (point it
at a train run's <out>/ckpt): a SplitFTSystem of the same --arch and
--seed, with the state template the checkpoint's metadata names
(scheduler, state leaves, population and cohort size), restores it and
draws the base weights from the seed as the train run did; from a
population checkpoint it serves pids 0..--adapters-1 from the restored
store.  The flags are the reference CLI's
(src/repro/launch/serve.py) plus --device (default: the card; the CPU
runs only when asked for) and --draw-on-device (as the train CLI's;
with --ckpt the checkpoint's metadata says where they were drawn).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-small")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--adapters", type=int, default=4,
                    help="number of adapters in the serving pool")
    ap.add_argument("--requests", type=int, default=16,
                    help="number of requests in the workload")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrivals/sec (0 = all arrive at t=0)")
    ap.add_argument("--num-slots", type=int, default=4,
                    help="concurrent decode slots (continuous batch size)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="KV cache page size in tokens (0 = contiguous)")
    ap.add_argument("--max-len", type=int, default=0,
                    help="per-slot KV capacity (0 = prompt-len + gen)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--draw-on-device", action="store_true",
                    help="draw the random base weights on --device (no "
                         "host draw of a model of tens of GB; one seed "
                         "then gives other weights than the default host "
                         "draw; with --ckpt the checkpoint decides)")
    return ap


def checkpoint_config(ckpt_dir: str) -> dict:
    """SystemConfig fields whose state template matches the newest
    checkpoint under `ckpt_dir`, from its metadata: the scheduler, the
    options that add state leaves (adapter and smashed error feedback,
    edge groups, the co-controller's policy) and the population; under
    "cohort", a population run's cohort size (the arch's num_clients),
    and under "draw_on_device" whether its base weights were drawn on
    the device (SplitFTSystem's draw_on_device)."""
    from repro_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(ckpt_dir)
    steps = mgr.steps()
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    meta = mgr.metadata(steps[-1]) or {}
    keys = set(meta.get("state_keys") or ())
    kw = dict(scheduler=meta.get("scheduler"),
              compress="topk" if "ef" in keys else "none",
              smashed_ef="smashed_ef" in keys,
              edge_groups=2 if "edge_assign" in keys else None)
    if "smashed_ef" in keys:
        kw["smashed_compress"] = "topk"
    if "rank_cut" in keys:
        kw.update(controller="co", smashed_ef=False)
    if "topk_frac" in keys:
        kw.update(continuous_topk=True, compressor_buckets=("none", "topk"))
    if meta.get("population"):
        kw.update(population=int(meta["population"]),
                  cohort=int(meta["cohort"]))
    kw["draw_on_device"] = meta.get("weights_drawn_on", "cpu") != "cpu"
    return kw


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from repro_torch.config import reduced as reduced_cfg
    from repro_torch.configs import get_config
    from repro_torch.core.system import SplitFTSystem, SystemConfig
    from repro_torch.device import device_name
    from repro_torch.models.model import build_model
    from repro_torch.runtime import serving

    arch = get_config(args.arch)
    if args.reduced:
        arch = reduced_cfg(arch)
    if args.ckpt:
        kw = checkpoint_config(args.ckpt)
        cohort = kw.pop("cohort", None)
        draw = kw.pop("draw_on_device")
        if cohort:
            arch = arch.replace(data=dataclasses.replace(
                arch.data, num_clients=cohort))
        system = SplitFTSystem(
            arch, SystemConfig(num_samples=64, eval_samples=16,
                               checkpoint_dir=args.ckpt, **kw),
            seed=args.seed, device=args.device, draw_on_device=draw)
        if not system.restore():
            raise FileNotFoundError(f"no loadable checkpoint under "
                                    f"{args.ckpt}")
        model, params = system.model, system.base_params
        if system.store is not None:
            pool = serving.pool_from_population(
                model, system.state, system.store, range(args.adapters))
        else:
            pool = serving.pool_from_state(model, system.state)
            n = serving.num_pool_adapters(pool)
            if args.adapters > n:
                raise ValueError(f"--adapters {args.adapters} exceeds the "
                                 f"checkpoint's {n} per-client adapters")
            pool = serving.pool_head(pool, args.adapters)
    else:
        model = build_model(arch, device=args.device)
        # independent generators per consumer, as the reference splits
        # keys; the base weights drawn where SplitFTSystem draws them
        params = model.init_params(torch.Generator(
            device=model.device if args.draw_on_device else "cpu"
        ).manual_seed(args.seed))
        pool = serving.build_adapter_pool(
            model, torch.Generator().manual_seed(args.seed + 1),
            args.adapters)

    max_len = args.max_len or (args.prompt_len + args.gen)
    cfg = serving.ServeConfig(num_slots=args.num_slots, max_len=max_len,
                              page_size=args.page_size)
    engine = serving.ServingEngine(model, params, pool, cfg,
                                   device=model.device)

    rng = np.random.default_rng(args.seed + 2)
    v = arch.model.vocab_size
    arrivals = (np.cumsum(rng.exponential(1.0 / args.arrival_rate,
                                          args.requests))
                if args.arrival_rate > 0 else np.zeros(args.requests))
    reqs = [serving.Request(
        rid=i, adapter=i % args.adapters,
        tokens=rng.integers(3, v, size=args.prompt_len),
        max_new=args.gen, arrival=float(arrivals[i]))
        for i in range(args.requests)]

    t0 = time.time()
    results = engine.run(reqs)
    wall = time.time() - t0

    lat = np.array([r["t_done"] - r["t_submit"] for r in results])
    ttft = np.array([r["t_first"] - r["t_submit"] for r in results])
    toks = sum(len(r["tokens"]) for r in results)
    print(f"served {len(results)} requests x {args.gen} tokens over "
          f"{args.adapters} adapters in {wall:.3f}s ({toks / wall:.1f} "
          f"tok/s on {device_name(model.device)})")
    print(f"latency p50 {np.percentile(lat, 50) * 1e3:.1f} ms   "
          f"p99 {np.percentile(lat, 99) * 1e3:.1f} ms   "
          f"ttft p50 {np.percentile(ttft, 50) * 1e3:.1f} ms")
    print(f"generated ids (rid 0): {results[0]['tokens'][:16]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
