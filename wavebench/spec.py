"""The cell a run measures, found by name in ``BENCHMARK.json``.

A workload names a configuration (its file of sizes, ``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); its correctness limits are in
``limits/<workload>.json`` and its per-layer metrics are read by the
modules under ``metrics/``. Nothing here knows any cell by name: a new cell
is new files and new entries.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict        # the configuration file as written
    traffic_name: str
    traffic: dict       # the traffic mix's parameters
    limits: dict        # {number: limit} that decide ``correct``
    end_to_end: list    # the BENCHMARK.json entries this cell reports
    per_layer: list

    def model_fields(self) -> dict:
        """The configuration's ``WaveNetConfig`` fields."""
        return dict(self.config["model"])


def _reports(metric: dict, cell: str, e2e_names: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # without the key: every cell that reports the metric it moves
    return e2e_names is None or metric.get("moves") in e2e_names


def load_cell(workload: str, bench_file: Path | None = None) -> Cell:
    bench = _read(bench_file or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = _read(ROOT / cfg_entry["file"])
    traffic = _read(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = _read(BENCH_DIR / "limits" / f"{workload}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(workload, w["config"], config, w["traffic"], traffic,
                limits, e2e, per_layer)
