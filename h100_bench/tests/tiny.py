"""A copy of the benchmark's manifest and data files at a size the CPU
runs in seconds: every width cut, batches of a few rows. The generators,
metrics and reference are the package's own."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from h100_bench.manifest import Manifest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "h100_bench"

WIDTHS = dict(decoder_hidden_size=16, embedding_size=12,
              encoder_output_size=20, encoder_output_len=5,
              decoder_attn_size=8, reconstructor_hidden_size=20,
              reconstructor_attn_size=8, caption_max_len=7, vocab_size=40)
TRAIN = dict(batch_size=6, steps_per_call=3, videos=20, pool_calls=2,
             trace_calls=1, caption_words={"2": 2, "4": 3, "6": 1})
CAPTION = dict(batch_size=16, pool_batches=2, sample_rows=24, trace_calls=2)


def tiny_manifest(tmp: Path, widths=None) -> Manifest:
    """A manifest under ``tmp`` with the benchmark's entries, configs cut
    to ``widths``, traffic cut to a few rows, the metrics and limits as
    they are."""
    (tmp / "h100_bench").mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "limits"):
        shutil.copytree(BENCH / sub, tmp / "h100_bench" / sub,
                        dirs_exist_ok=True)
    for sub in ("configs", "traffic"):
        (tmp / "h100_bench" / sub).mkdir(exist_ok=True)
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        d = json.loads((REPO / c["file"]).read_text())
        d.update(widths or WIDTHS)
        (tmp / c["file"]).write_text(json.dumps(d))
    for w in manifest["workloads"]:
        name = f"{w['traffic']}.json"
        t = json.loads((BENCH / "traffic" / name).read_text())
        t.update(TRAIN if t["kind"] == "train" else CAPTION)
        (tmp / "h100_bench" / "traffic" / name).write_text(json.dumps(t))
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return Manifest(tmp)
