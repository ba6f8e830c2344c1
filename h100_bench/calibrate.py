"""The readings that a cell's limits are set from, on the card at the
cell's own size, in one process:

    python3 h100_bench/calibrate.py --workload <name> --seeds 11,12,... \
        --control-seeds 11,12,13

For every seed, the program's numbers against the reference as a run
compares them (a training cell after its set-up's first call; a
captioning cell after the traffic's ``trace_calls`` calls, which finish
its longest rows); for the control seeds also the control's (the
reference in TF32 in the program's place) and the planted faults'. One
JSON line a seed. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).parent:
    sys.path[0] = str(ROOT)


def readings(manifest, workload: str, seed: int, control: bool, device):
    from h100_bench.run import SetupParts, _program_in
    w = manifest.workload(workload)
    config = manifest.config(w["config"])
    traffic = manifest.traffic(w["traffic"])
    _program_in(manifest.root)
    driver = importlib.import_module(f"h100_bench.drivers.{traffic['kind']}")
    cell = driver.Cell(config, traffic, seed, device, config["vocab_size"])
    cell.setup(SetupParts())
    cell.traced_calls()
    cell.free_program()
    out = {"seed": seed, "program": cell.numbers()}
    if control:
        out.update(cell.control_numbers())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    import torch

    from h100_bench.manifest import Manifest
    from h100_bench.run import _load_kernels, SetupParts
    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 2
    manifest = Manifest(ROOT)
    traffic = manifest.traffic(manifest.workload(args.workload)["traffic"])
    _load_kernels(traffic.get("kernels", []), SetupParts())
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        out = readings(manifest, args.workload, seed, seed in controls,
                       "cuda")
        out["seconds"] = time.time() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
