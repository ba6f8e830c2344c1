"""Run one cell of ``BENCHMARK.json`` once, on the card, and print its
result as the last line of standard output.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (the program's imports, its kernels' libraries, weights and inputs
made on the card from the seed, one warm-up of the cell's own calls) runs
first; ``setup_s`` is the time from the process's start to the end of it,
and its parts go on an earlier line. The window then runs for ``--seconds``;
``--trace 0`` reports the cell's end-to-end metrics from it. ``--trace 1``
profiles the traffic's ``trace_calls`` calls after it and reports the
per-layer metrics with ``busy_s``, ``window_s`` and the breakdown of that
traced window; the per-layer metrics that need a time a step take it from
the untraced window, since the profiler's own cost a launch slows the
host. Either
way, once the window has closed and the peak memory is read, the program
is freed and what the window produced is compared with the plain reference
(``oracle.py``); each number compared is printed beside its limit, last on
standard error and last in the result line.

The run fails, printing no result, without a CUDA card, with fewer cards
than the cell asks for, where the program is not in the checkout, and
where JAX or the JAX package was imported.
"""

from __future__ import annotations

import time

START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).parent:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names a run may not hold: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "recnet_tpu", "bench",
                       "benchmarks"})
PROGRAM = "recnet_tpu_torch"


def forbidden_modules(names) -> list:
    """The module names whose top-level name, the part before the first
    dot, is one of FORBIDDEN as a whole."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


class SetupParts:
    """Seconds of each named part of the set-up."""

    def __init__(self):
        self.parts = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.parts[name] = self.parts.get(name, 0.0) + time.time() - t0


def _program_in(root: Path) -> None:
    """Import the program and refuse one from outside the checkout."""
    module = importlib.import_module(PROGRAM)
    where = Path(module.__file__).absolute()
    if Path(os.path.commonpath([where, root.absolute()])) != root.absolute():
        raise ImportError(f"{PROGRAM} comes from {where}, outside {root}")


def _load_kernels(names, parts) -> None:
    """Build the cell's kernel libraries side by side (nvcc a source),
    then load them."""
    from concurrent.futures import ThreadPoolExecutor

    from recnet_tpu_torch.ops.cuda import build
    with parts("kernel_loads"):
        with ThreadPoolExecutor(max(1, len(names))) as pool:
            list(pool.map(build.build, names))
        for name in names:
            build.load(name)


def run_cell(manifest, workload: str, seed: int, seconds: float,
             trace: bool, device, start: float = START,
             program_root: Path = None) -> dict:
    """The result of one run of a cell (a dict in the result line's
    order); ``device`` is the card, or the CPU for the tests, whose
    manifests may sit outside the checkout (``program_root``)."""
    import torch

    from h100_bench import oracle
    from h100_bench import trace as trace_mod
    w = manifest.workload(workload)
    config = manifest.config(w["config"])
    traffic = manifest.traffic(w["traffic"])
    limits = manifest.limits(workload)
    device = torch.device(device)
    cuda = device.type == "cuda"
    parts = SetupParts()
    parts.parts["start_and_torch"] = time.time() - start
    with parts("imports"):
        _program_in(program_root or manifest.root)
    if cuda:
        _load_kernels(traffic.get("kernels", []), parts)
    driver = importlib.import_module(f"h100_bench.drivers.{traffic['kind']}")
    cell = driver.Cell(config, traffic, seed, device, config["vocab_size"])
    cell.setup(parts)
    # what set-up made is kept for good: the window's collections skip it
    gc.collect()
    gc.freeze()
    setup_s = time.time() - start
    print("setup " + json.dumps({"setup_s": setup_s, **parts.parts}),
          flush=True)

    e2e = dict(cell.window(seconds), setup_s=setup_s)
    print("window " + json.dumps({k: v for k, v in e2e.items()
                                  if k != "setup_s"}), flush=True)
    tr = trace_mod.traced(cell.traced_calls, device) if trace else None
    attempted, failed, counts = cell.attempted(), cell.failed(), cell.counts()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    cell.free_program()
    numbers = cell.numbers()
    correct, rows = oracle.judge(numbers, limits)

    metrics = {}
    if trace:
        reading = types.SimpleNamespace(trace=tr, config=config,
                                        traffic=traffic, counts=counts,
                                        vocab=config["vocab_size"])
        for m in manifest.per_layer(workload):
            value = manifest.metric_module(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in manifest.end_to_end(workload):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": w["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                               "idle_gaps": [list(x) for x in tr.idle_gaps]}
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in rows}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(ROOT / "build" / "h100_bench" / sub))

    import torch

    from h100_bench.manifest import Manifest
    manifest = Manifest(ROOT)
    chips = manifest.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    result = run_cell(manifest, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda")
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"run.py: the run imported {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
