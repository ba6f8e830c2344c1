"""``BENCHMARK.json`` and the files it names.

The checkout's root is the folder that holds ``BENCHMARK.json`` and this
package. A cell's files are found by the names in the manifest: its
configuration's ``file``, ``traffic/<traffic>.json``, ``limits/<workload>
.json`` and, for each per-layer metric, ``metrics/<metric>.py``, all under
``h100_bench/``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

PACKAGE = "h100_bench"


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = self.root / PACKAGE

    def _named(self, key: str, name: str) -> Dict:
        hits = [e for e in self.data[key] if e["name"] == name]
        if len(hits) != 1:
            raise KeyError(f"{len(hits)} entries named {name!r} in {key}")
        return hits[0]

    def workload(self, name: str) -> Dict:
        return self._named("workloads", name)

    def config(self, name: str) -> Dict:
        return json.loads((self.root / self._named("configs", name)["file"])
                          .read_text())

    def traffic(self, name: str) -> Dict:
        return json.loads((self.bench / "traffic" / f"{name}.json")
                          .read_text())

    def limits(self, workload: str) -> Dict:
        return json.loads((self.bench / "limits" / f"{workload}.json")
                          .read_text())

    def end_to_end(self, workload: str) -> List[Dict]:
        """The end-to-end metrics a cell reports."""
        return [m for m in self.data["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[Dict]:
        """The per-layer metrics a cell's traced run reports: those whose
        ``workloads`` list it."""
        return [m for m in self.data["per_layer"]
                if workload in m["workloads"]]

    def metric_module(self, name: str) -> ModuleType:
        path = self.bench / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"{PACKAGE}_metric_{name.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
