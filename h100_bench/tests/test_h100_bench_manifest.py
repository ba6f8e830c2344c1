"""BENCHMARK.json against the benchmark's contract, and the files each of
its names finds."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from h100_bench.manifest import Manifest
from h100_bench.run import FORBIDDEN, forbidden_modules

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "h100_bench"
DATA = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head)"
                   r"|(_dim|_rank|_size)$")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert DATA["command"] == ["python3", "h100_bench/run.py"]
    assert 1 <= len(DATA["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in DATA["paths"])
    assert isinstance(DATA["run_seconds"], int)
    assert 1 <= DATA["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43200 seconds
    runs = 2 + 14 * 24
    assert runs * (DATA["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_contract_keys_and_names(section):
    entries = DATA[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_metrics_sources_and_bounds():
    names = [m["name"] for m in DATA["end_to_end"]]
    assert "setup_s" in names and 2 <= len(names) <= 16
    for m in DATA["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in DATA["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"].split()) <= 6
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cells_and_what_they_report():
    m = Manifest(REPO)
    configs = {c["name"] for c in DATA["configs"]}
    used = {w["config"] for w in DATA["workloads"]}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in DATA["workloads"]:
        assert w["chips"] == 1
        e2e = {x["name"] for x in m.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert m.per_layer(w["name"]), w["name"]
    for x in DATA["end_to_end"] + DATA["per_layer"]:
        for cell in x.get("workloads", []):
            assert cell in {w["name"] for w in DATA["workloads"]}


def test_each_per_layer_metric_moves_what_its_cells_report():
    m = Manifest(REPO)
    e2e = {x["name"] for x in DATA["end_to_end"]}
    for x in DATA["per_layer"]:
        assert x["moves"] in e2e
        assert x["workloads"], x["name"]
        for cell in x["workloads"]:
            assert x["moves"] in {y["name"] for y in m.end_to_end(cell)}, \
                (x["name"], cell)
    layers = {}
    for x in DATA["per_layer"]:
        layers.setdefault(x["layer"].lower(), set()).add(x["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("workload", [w["name"] for w in DATA["workloads"]])
def test_cell_files_resolve_by_name(workload):
    m = Manifest(REPO)
    w = m.workload(workload)
    config = m.config(w["config"])
    traffic = m.traffic(w["traffic"])
    limits = m.limits(workload)
    assert (BENCH / "drivers" / f"{traffic['kind']}.py").is_file()
    assert config["vocab_size"] > 0 and limits
    for name, entry in limits.items():
        assert entry["lower"] < entry["limit"] < entry["upper"], name


@pytest.mark.parametrize("config", DATA["configs"],
                         ids=[c["name"] for c in DATA["configs"]])
def test_config_files(config):
    path = REPO / config["file"]
    assert path.is_file()
    assert path.relative_to(BENCH)
    data = json.loads(path.read_text())
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert len(config["reduced"]) <= 16
    assert not [k for k in config["reduced"] if WIDTH.search(k)]
    assert len({c["file"] for c in DATA["configs"]}) == len(DATA["configs"])


@pytest.mark.parametrize("metric", DATA["per_layer"],
                         ids=[x["name"] for x in DATA["per_layer"]])
def test_metric_modules_declare_their_entry(metric):
    module = Manifest(REPO).metric_module(metric["name"])
    assert module.UNIT == metric["unit"]
    assert module.LAYER == metric["layer"]
    assert module.MOVES == metric["moves"]
    assert module.SOURCE == metric["source"]
    assert module.READS and callable(module.read)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert forbidden_modules(_imports(path)) == []


@pytest.mark.parametrize("part", ["work.py", "oracle.py", "seeded.py",
                                  "trace.py", "reference/recnet.py",
                                  "reference/train.py",
                                  "reference/decode.py"])
def test_the_yardstick_imports_nothing_of_the_program(part):
    assert not [m for m in _imports(BENCH / part)
                if m.split(".")[0] == "recnet_tpu_torch"]


def test_forbidden_modules_compares_whole_top_level_names():
    names = ["recnet_tpu_torch", "recnet_tpu_torch.ops.cuda", "recnet_tpu",
             "recnet_tpu.models.decoder", "jax", "jax.numpy", "jaxlib",
             "flax.linen", "flaxen", "jaxtyping", "bench", "benchmarks",
             "benchmarks.serve_load", "benchmark_utils", "torch"]
    assert forbidden_modules(names) == sorted(
        ["recnet_tpu", "recnet_tpu.models.decoder", "jax", "jax.numpy",
         "jaxlib", "flax.linen", "bench", "benchmarks",
         "benchmarks.serve_load"])
    assert {"jax", "jaxlib", "flax", "recnet_tpu"} <= FORBIDDEN
