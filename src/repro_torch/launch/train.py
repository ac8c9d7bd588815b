"""SplitFT fine-tuning entry point of the PyTorch port, on the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \
      --rounds 300 --partition dirichlet --alpha 0.9 --adaptive

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \
      --remat full --rounds 3 --samples 400
  PYTHONPATH=src python -m repro_torch.launch.train --controller co \
      --rank-buckets 4,8,16 --compressor-buckets none,int8,fp8,topk \
      --continuous-topk --straggler-sim --jitter-sigma 0
  PYTHONPATH=src python -m repro_torch.launch.train --scheduler async \
      --buffer-size 3 --staleness-power 0.5 --overlap-comm --straggler-sim
  PYTHONPATH=src python -m repro_torch.launch.train --population 1000 \
      --cohort-size 5 --rounds 20

Port of src/repro/launch/train.py: the same flags, plus --device (default:
the card; the CPU runs only when asked for) and --remat (the round
engine's layer recompute, TrainConfig.remat: the paper's batch 4 of
mamba2-780m fits one card under "full") and --draw-on-device (the random
base weights drawn on the card: kimi-k2 at full width needs no host
draw of tens of GB).  It builds a
repro_torch.core.system.SplitFTSystem, resumes from <out>/ckpt when a
checkpoint is there, and writes <out>/history.jsonl (one row per round)
and <out>/final.json in the reference's format.  Every scheduler
(sync, deadline, local_steps, async), adapter --compress, --edge-groups,
the smashed channel's error feedback (on with --smashed-compress topk,
as in the reference) and population mode (--population P, a cohort of
--cohort-size clients drawn each round) run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def _int_list(s: str):
    return tuple(int(x) for x in s.split(",") if x)


def _str_list(s: str):
    return tuple(x.strip() for x in s.split(",") if x.strip())


def build_parser() -> argparse.ArgumentParser:
    """The CLI surface, exposed at module level so tooling (the docs-
    freshness test) can verify every flag the docs mention actually
    parses."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-small")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--clients", type=int, default=0)
    ap.add_argument("--partition", default=None, choices=[None, "iid",
                                                          "dirichlet"])
    ap.add_argument("--alpha", type=float, default=None)
    ap.add_argument("--cut", type=int, default=0)
    ap.add_argument("--r-cut", type=int, default=0)
    ap.add_argument("--r-others", type=int, default=0)
    ap.add_argument("--adaptive", action="store_true", default=None)
    ap.add_argument("--no-adaptive", dest="adaptive", action="store_false")
    ap.add_argument("--lr", type=float, default=0.0)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CI)")
    ap.add_argument("--compress", default="none",
                    choices=["none", "topk", "int8"],
                    help="adapter-sync (b1/b3) channel compressor")
    ap.add_argument("--smashed-compress", default=None,
                    choices=["none", "int8", "fp8", "topk"],
                    help="smashed-activation (f2/f4) channel compressor; "
                         "default: the arch config's choice")
    ap.add_argument("--smashed-topk-frac", type=float, default=None)
    ap.add_argument("--scheduler", default=None,
                    choices=[None, "sync", "deadline", "local_steps",
                             "async"],
                    help="round scheduler (repro_torch.core.scheduler); "
                         "default: the arch config's choice "
                         "(--straggler-sim alone implies deadline)")
    ap.add_argument("--max-local-steps", type=int, default=None,
                    help="static K cap for --scheduler local_steps")
    ap.add_argument("--deadline-frac", type=float, default=None,
                    help="drop threshold (x median) for deadline")
    ap.add_argument("--buffer-size", type=int, default=None,
                    help="--scheduler async: aggregate every M distinct "
                         "client completions (clamped to the client "
                         "count)")
    ap.add_argument("--staleness-power", type=float, default=None,
                    help="--scheduler async: (1+staleness)^-p weight "
                         "discount (0 disables)")
    ap.add_argument("--overlap-comm", action="store_true", default=None,
                    help="pipeline the comm phases on the simulated "
                         "clock: uplink of step k overlaps compute of "
                         "k+1 (double-buffered); default: the arch "
                         "config's choice")
    ap.add_argument("--no-overlap-comm", dest="overlap_comm",
                    action="store_false")
    ap.add_argument("--controller", default=None,
                    choices=[None, "accuracy", "co"],
                    help="C3 controller: 'accuracy' = the paper's "
                         "accuracy-only cut rule; 'co' = the phase-time "
                         "co-controller picking each client's (cut, "
                         "rank-at-cut, compressor) triple by predicted "
                         "pipelined makespan under an accuracy "
                         "dead-band; default: the arch config's choice")
    ap.add_argument("--rank-buckets", type=_int_list, default=None,
                    metavar="R1,R2,...",
                    help="--controller co: rank-at-cut search set "
                         "(each <= r_others; ranks are masks, so any "
                         "assignment shares one executable)")
    ap.add_argument("--compressor-buckets", type=_str_list, default=None,
                    metavar="C1,C2,...",
                    help="--controller co: smashed-compressor search "
                         "set (subset of none,int8,fp8,topk)")
    ap.add_argument("--acc-dead-band", type=float, default=None,
                    help="accuracy dead-band half-width gating "
                         "co-controller moves")
    ap.add_argument("--min-gain", type=float, default=None,
                    help="--controller co: relative predicted-makespan "
                         "improvement required before moving a "
                         "client's triple (hysteresis)")
    ap.add_argument("--continuous-topk", action="store_true",
                    default=None,
                    help="--controller co: tune the topk keep fraction "
                         "continuously per client (needs 'topk' in "
                         "--compressor-buckets)")
    ap.add_argument("--straggler-sim", action="store_true")
    ap.add_argument("--client-flops-per-s", type=float, default=None,
                    help="reference client device throughput (FLOP/s) "
                         "for the simulated compute phase; default: the "
                         "SpeedModel's 5e12")
    ap.add_argument("--jitter-sigma", type=float, default=None,
                    help="per-round lognormal jitter sigma on the "
                         "simulated clock (0 = deterministic: predicted "
                         "== simulated times)")
    ap.add_argument("--time-source", default=None,
                    choices=[None, "analytic", "trace", "measured"],
                    help="controller pricing source (runtime.timemodel): "
                         "'analytic' = the stationary SpeedModel; "
                         "'trace' = analytic x the trace's factors at "
                         "the current window; 'measured' = analytic "
                         "corrected by a per-client per-phase EWMA of "
                         "observed durations; default: trace when a "
                         "trace is installed, else analytic")
    ap.add_argument("--ewma-alpha", type=float, default=0.3,
                    help="--time-source measured: EWMA smoothing factor "
                         "for the observed/predicted phase ratios")
    ap.add_argument("--model-seed", type=int, default=None,
                    help="price candidates from a SpeedModel drawn at "
                         "this seed instead of the clock's (deliberate "
                         "mis-specification testbed; 'measured' learns "
                         "the correction, 'analytic' cannot)")
    ap.add_argument("--record-trace", default=None, metavar="PATH",
                    help="dump the run's observed per-phase factors to "
                         "PATH as a runtime.traces FileTrace JSON, "
                         "replayable via --trace")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="replay a recorded heterogeneity trace file "
                         "(runtime.traces JSON: per-window speed/"
                         "bandwidth/availability factors); implies a "
                         "simulated-clock speed model")
    ap.add_argument("--trace-gen", default=None, metavar="SPEC",
                    help="synthetic heterogeneity trace, e.g. "
                         "'diurnal:amp=0.8,period=900+markov:p_down="
                         "0.05,p_up=0.3+cells:k=4+thermal:floor=0.5' "
                         "(runtime.traces.make_trace_gen; mutually "
                         "exclusive with --trace)")
    ap.add_argument("--population", type=int, default=None,
                    help="fleet-scale mode: total client population; "
                         "each round a seeded cohort of --cohort-size "
                         "ids trains (persistent per-id state, "
                         "runtime.population).  0/unset = the clients "
                         "ARE the population (paper fleet mode)")
    ap.add_argument("--cohort-size", type=int, default=None,
                    help="clients sampled per round under --population "
                         "(the engine's static client axis); default: "
                         "the arch's num_clients")
    ap.add_argument("--edge-groups", type=int, default=None,
                    help="hierarchical aggregation: FedAvg clients "
                         "within this many edge groups, then edges to "
                         "the server; 1 = flat (bitwise paper path)")
    ap.add_argument("--samples", type=int, default=2000)
    ap.add_argument("--out", default="runs/train")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--draw-on-device", action="store_true",
                    help="draw the random base weights on --device (no "
                         "host draw of a model of tens of GB; one seed "
                         "then gives other weights than the default host "
                         "draw)")
    ap.add_argument("--remat", default=None,
                    choices=[None, "none", "dots", "full"],
                    help="recompute each layer in the backward: 'full' "
                         "saves only layer inputs, 'dots' also the "
                         "outputs of matrix products; default: the arch "
                         "config's TrainConfig.remat")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from repro_torch.config import reduced as reduced_cfg
    from repro_torch.configs import get_config
    from repro_torch.core.system import SplitFTSystem, SystemConfig

    arch = get_config(args.arch)
    if args.reduced:
        arch = reduced_cfg(arch)
    if args.partition or args.alpha is not None or args.clients:
        arch = arch.replace(data=dataclasses.replace(
            arch.data,
            partition=args.partition or arch.data.partition,
            alpha=args.alpha if args.alpha is not None else arch.data.alpha,
            num_clients=args.clients or arch.data.num_clients))
    if args.cut or args.adaptive is not None:
        arch = arch.replace(split=dataclasses.replace(
            arch.split,
            cut_layer=args.cut or arch.split.cut_layer,
            adaptive=(arch.split.adaptive if args.adaptive is None
                      else args.adaptive)))
    if args.r_cut or args.r_others:
        arch = arch.replace(lora=dataclasses.replace(
            arch.lora,
            r_cut=args.r_cut or arch.lora.r_cut,
            r_others=args.r_others or arch.lora.r_others))
    if args.lr:
        arch = arch.replace(train=dataclasses.replace(
            arch.train, lr_client=args.lr, lr_server=args.lr))
    if args.remat:
        arch = arch.replace(train=dataclasses.replace(arch.train,
                                                      remat=args.remat))
    if args.cohort_size:
        arch = arch.replace(data=dataclasses.replace(
            arch.data, num_clients=args.cohort_size))

    os.makedirs(args.out, exist_ok=True)
    sys_cfg = SystemConfig(
        num_samples=args.samples, compress=args.compress,
        smashed_compress=args.smashed_compress,
        smashed_topk_frac=args.smashed_topk_frac,
        scheduler=args.scheduler,
        max_local_steps=args.max_local_steps,
        deadline_frac=args.deadline_frac,
        buffer_size=args.buffer_size,
        staleness_power=args.staleness_power,
        overlap_comm=args.overlap_comm,
        controller=args.controller,
        rank_buckets=args.rank_buckets,
        compressor_buckets=args.compressor_buckets,
        acc_dead_band=args.acc_dead_band,
        min_gain=args.min_gain,
        continuous_topk=args.continuous_topk,
        straggler_sim=args.straggler_sim,
        client_flops_per_s=args.client_flops_per_s,
        jitter_sigma=args.jitter_sigma,
        time_source=args.time_source,
        ewma_alpha=args.ewma_alpha,
        model_seed=args.model_seed,
        record_trace=args.record_trace,
        trace=args.trace,
        trace_gen=args.trace_gen,
        population=args.population,
        edge_groups=args.edge_groups,
        checkpoint_dir=os.path.join(args.out, "ckpt"),
        checkpoint_every=max(args.rounds // 5, 1))
    system = SplitFTSystem(arch, sys_cfg, seed=args.seed,
                           device=args.device,
                           draw_on_device=args.draw_on_device)
    if system.restore():
        print(f"resumed from round {int(system.state['round'])}")

    hist_path = os.path.join(args.out, "history.jsonl")
    with open(hist_path, "a") as hf:
        def cb(rec):
            row = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                   for k, v in rec.items()}
            hf.write(json.dumps(row) + "\n")

        system.run(args.rounds, log_every=10, callback=cb)

    final = system.evaluate()
    print(f"final eval: {final}")
    with open(os.path.join(args.out, "final.json"), "w") as f:
        json.dump(final, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
