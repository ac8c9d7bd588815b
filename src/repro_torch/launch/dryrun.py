"""Dry-run of the assigned (architecture x shape) cells on one H100.

Port of src/repro/launch/dryrun.py.  The reference lowers and compiles
each cell for a TPU mesh and reads XLA's memory and cost analyses; the
port builds each cell on fake tensors (``launch/cells.py``: nothing the
size of the cell is allocated) and counts its FLOPs, HBM bytes and peak
live bytes by running its step on them (``roofline/counting.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape decode_32k --json out.json

Per cell it prints the trace time, FLOPs, bytes, the roofline terms on
one H100 (``roofline/analysis.py``: the dominant term and the lower
bound), the model FLOPs and the useful fraction, the peak live bytes,
whether that peak fits one 80 GiB card, and ``cards_needed`` =
ceil(peak / 80 GiB), a lower bound: sharding a cell over cards adds
what each card must also hold (replicated leaves, collective buffers).
A cell that ``shape_applicable`` rules out is skipped with its reason.
It exits 1 if any cell fails.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from typing import Any, Dict, Optional, Union

from repro_torch.config import SHAPES, ArchConfig, ShapeConfig
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline.analysis import model_flops_for, roofline_record
from repro_torch.roofline.counting import count

CARD_BYTES = 80 * 2**30          # one H100 80GB


def run_cell(arch: Union[str, ArchConfig], shape: Union[str, ShapeConfig],
             *, verbose: bool = True, cell_kw: Optional[Dict] = None
             ) -> Dict[str, Any]:
    """One cell's record.  `arch` is a registry name or an ArchConfig
    (a config whose depth is cut, say), `shape` a name of SHAPES or a
    ShapeConfig (another batch, say)."""
    arch = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    ok, why = arch.shape_applicable(shape)
    rec: Dict[str, Any] = {"arch": arch.name, "shape": shape.name,
                           "mesh": "1 card"}
    if not ok:
        rec.update(status="skipped", reason=why)
        if verbose:
            print(f"SKIP  {arch.name} x {shape.name}: {why}")
        return rec

    mesh = make_production_mesh()
    t0 = time.time()
    cell = build_cell(arch, shape, mesh, **(cell_kw or {}))
    counts = count(cell.fn, *cell.args)
    trace_s = time.time() - t0
    roof = roofline_record(counts.flops, counts.bytes,
                           model_flops=model_flops_for(arch, shape),
                           num_devices=mesh.num_devices)
    peak = counts.peak_bytes
    rec.update(
        status="ok", trace_s=round(trace_s, 2),
        flops=counts.flops, bytes=counts.bytes, peak_bytes=int(peak),
        fits_card=bool(peak <= CARD_BYTES),
        cards_needed=max(1, math.ceil(peak / CARD_BYTES)),
        cards_needed_is_lower_bound=True,
        roofline=roof, kernel_calls=counts.kernel_calls, info=cell.info)
    if verbose:
        print(f"OK    {arch.name} x {shape.name} [1 card] "
              f"peak {peak / 2**30:.2f} GiB fits={rec['fits_card']} "
              f"cards_needed>={rec['cards_needed']} "
              f"flops {counts.flops:.4e} bytes {counts.bytes:.4e} "
              f"dominant={roof['dominant']} bound "
              f"{roof['step_s_lower_bound'] * 1e3:.3f} ms "
              f"useful_frac={roof.get('useful_fraction', 0):.3f} "
              f"(traced in {trace_s:.1f} s)")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None,
                    help="one architecture (default: all assigned)")
    ap.add_argument("--shape", default=None,
                    help="one shape (default: all four)")
    ap.add_argument("--json", default=None, help="write results JSON")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(SHAPES)

    results = []
    failed = 0
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            try:
                results.append(run_cell(arch, shape))
            except Exception as e:  # noqa: BLE001 -- report every cell
                failed += 1
                traceback.print_exc()
                results.append({"arch": arch, "shape": shape,
                                "mesh": "1 card", "status": "error",
                                "error": str(e)})
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1, default=str)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    print(f"\n== dry-run summary: {n_ok} ok, {n_skip} skipped, "
          f"{failed} failed, of {len(results)} cells, "
          f"{time.time() - t0:.1f} s ==")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
