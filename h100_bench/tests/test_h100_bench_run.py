"""run.py's result line, its refusals, and a cell, a traffic mix and a
per-layer metric added by new files and entries alone."""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from h100_bench import run as run_mod
from h100_bench.manifest import Manifest
from h100_bench.tests import tiny

CELLS = ["msvd-global-train-f32-b1024", "msvd-global-beam5-b1024"]


def _run(manifest, workload, trace, device="cpu"):
    return run_mod.run_cell(manifest, workload, 2 ** 31 + 11, 0.2, trace,
                            device, program_root=tiny.REPO)


def _check_line(result, manifest, workload, trace):
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    json.loads(json.dumps(result))
    assert isinstance(result["correct"], bool)
    assert isinstance(result["attempted"], int)
    assert isinstance(result["failed"], int)
    want = (manifest.per_layer(workload) if trace
            else manifest.end_to_end(workload))
    names = {m["name"]: m["unit"] for m in want}
    for name, m in result["metrics"].items():
        assert set(m) == {"value", "unit"} and names[name] == m["unit"]
    if not trace:
        assert set(result["metrics"]) == set(names)
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert dev["busy_s"] > 0 and dev["window_s"] > 0
        for part in ("device_ops", "idle_gaps"):
            rows = result["breakdown"][part]
            assert len(rows) <= 10
            assert all(isinstance(n, str) and isinstance(s, float)
                       for n, s in rows)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("workload", CELLS)
def test_result_line(tmp_path, workload, trace):
    manifest = tiny.tiny_manifest(tmp_path)
    result = _run(manifest, workload, trace)
    _check_line(result, manifest, workload, trace)
    assert result["correct"]


def test_without_a_card_the_command_prints_no_result(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is here")
    proc = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tiny.REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not [line for line in proc.stdout.splitlines()
                if line.startswith("{")]


def test_the_program_has_to_be_in_the_checkout(tmp_path):
    shutil.copytree(tiny.BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    with pytest.raises(ImportError):
        run_mod._program_in(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert not [line for line in proc.stdout.splitlines()
                if line.startswith("{")]


DUMMY_METRIC = '''"""Train steps in the traced calls."""

UNIT = "steps"
LAYER = "train step"
MOVES = "train_samples_per_s"
SOURCE = "program_counter"
READS = ("the driver's step count",)


def read(r):
    return float(r.counts["trace"]["train_steps"])
'''


def test_a_cell_traffic_and_metric_come_by_new_files_alone(tmp_path):
    """A dummy configuration, traffic mix, cell and per-layer metric: new
    files and new entries, and no file of the benchmark edited."""
    tiny.tiny_manifest(tmp_path)
    bench = tmp_path / "h100_bench"
    data = json.loads((tmp_path / "BENCHMARK.json").read_text())
    config = json.loads((bench / "configs" / "msvd-local.json").read_text())
    config["decoder_hidden_size"] = 24
    (bench / "configs" / "dummy.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "train-f32-b1024.json").read_text())
    traffic.update(batch_size=4, steps_per_call=4)
    (bench / "traffic" / "dummy-train.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "dummy_steps.py").write_text(DUMMY_METRIC)
    shutil.copy(bench / "limits" / "msvd-local-train-f32-b1024.json",
                bench / "limits" / "dummy-cell.json")
    data["configs"].append({"name": "dummy", "source": "https://example.org",
                            "file": "h100_bench/configs/dummy.json",
                            "reduced": [], "why": "a test"})
    data["workloads"].append({"name": "dummy-cell", "config": "dummy",
                              "traffic": "dummy-train", "chips": 1,
                              "why": "a test"})
    for m in data["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("dummy-cell")
    data["per_layer"].append({"name": "dummy_steps", "unit": "steps",
                              "better": "higher",
                              "source": "program_counter",
                              "layer": "train step",
                              "moves": "train_samples_per_s",
                              "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    manifest = Manifest(tmp_path)
    result = _run(manifest, "dummy-cell", True)
    _check_line(result, manifest, "dummy-cell", True)
    assert result["correct"], result["checks"]
    assert result["metrics"]["dummy_steps"]["value"] == 4.0
    assert "dummy_steps" not in {
        m["name"] for m in manifest.per_layer("msvd-global-train-f32-b1024")}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# Limits at the tiny widths of ``tiny.WIDTHS``, set between the program's
# largest reading and the TF32 control's smallest, on an H100 over nine
# seeds (the test's seed among them): program / control.
TINY_LIMITS = {
    "msvd-global-train-f32-b1024": {
        "loss_gap": 6e-7,        # 1.03e-7 / 2.28e-6
        "grad_gap": 1e-5,        # 2.41e-7 / 1.92e-4
        "change_gap": 1.5e-5,    # 4.38e-6 / 3.91e-5
    },
    "msvd-global-beam5-b1024": {
        "score_gap": 6e-6,       # 2.66e-7 / 9.93e-5
        "topk_gap": 3e-5,        # 0 / 0 (a token altered: 0.154)
    },
}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_small_cell_on_the_card(tmp_path, card, workload):
    """A traced run through the card's kernels at the CPU tests' widths:
    the line, the trace, and every number compared against the limits of
    these widths (the cells' own limits belong to the cells' widths: the
    change gap reads up to 4.4e-6 here, 4.8e-8 at the cells' widths)."""
    manifest = tiny.tiny_manifest(tmp_path)
    result = _run(manifest, workload, True, device=card)
    _check_line(result, manifest, workload, True)
    assert result["device"]["platform"] == "gpu"
    assert result["breakdown"]["device_ops"]
    limits = TINY_LIMITS[workload]
    assert set(result["checks"]) == set(limits)
    assert all(math.isfinite(c["value"]) and c["value"] <= limits[name]
               for name, c in result["checks"].items()), result["checks"]
