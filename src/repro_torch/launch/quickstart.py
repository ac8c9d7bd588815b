"""Quickstart of the PyTorch port: fine-tune GPT2-small with SplitFT on
synthetic data.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--rounds 30]

Port of examples/quickstart.py: a smoke-scale federated split fine-tuning
job (gpt2-small cut to 6 blocks of width 64, 5 clients, adaptive cut
layers, length-Dirichlet non-IID partition at alpha 0.9, 400 training and
64 eval samples) through repro_torch.core.system.SplitFTSystem, printing
the perplexity, the cut trajectory and the per-round comm.  It runs on the
card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.config import reduced
    from repro_torch.configs import get_config
    from repro_torch.core.system import SplitFTSystem, SystemConfig

    # paper model, shrunk to smoke scale (12 blocks -> 6, d=64)
    arch = reduced(get_config("gpt2-small"), layers=6, d_model=64,
                   vocab=2048, seq_len=64, batch=4)
    arch = arch.replace(
        train=dataclasses.replace(arch.train, lr_client=3e-3,
                                  lr_server=3e-3),
        data=dataclasses.replace(arch.data, partition="dirichlet",
                                 alpha=0.9, num_clients=5),
    )

    system = SplitFTSystem(arch, SystemConfig(num_samples=400,
                                              eval_samples=64),
                           seed=0, device=args.device)
    print(f"clients: {arch.data.num_clients}, "
          f"initial cut: {arch.split.cut_layer}, "
          f"r_cut={arch.lora.r_cut} r_others={arch.lora.r_others}, "
          f"device: {system.device}")

    history = system.run(args.rounds, log_every=10)

    final = system.evaluate()
    print(f"\nfinal: perplexity={final['perplexity']:.1f} "
          f"accuracy={final['accuracy']:.4f}")
    print(f"cut trajectory: {[h['cuts'].tolist() for h in history[::10]]}")
    print(f"per-round comm (MB/client): "
          f"{np.round(history[-1]['comm'] / 1e6, 2).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
