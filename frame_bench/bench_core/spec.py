"""Find a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names the cells; each
configuration is ``frame_bench/configs/<config>.json``, each traffic mix
``frame_bench/traffic/<traffic>.json``, each per-layer metric a reader
``frame_bench/metrics/<name>.py``, each kernel's roofline count
``frame_bench/roofline/<kernel>.py``, each span ``frame_bench/spans/<name>.json`` (installed where a
metric of the cell reads its label)
and each cell's comparison limits ``frame_bench/limits/<cell>.json``. A
later cell, configuration, mix, metric or span is a new file and a new
entry; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list
    limits: dict  # compared number -> limit
    bench_dir: Path


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    return Cell(
        name=name,
        chips=w["chips"],
        config=_read_json(bench_dir / "configs" / f"{w['config']}.json"),
        traffic=_read_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        limits=_read_json(bench_dir / "limits" / f"{name}.json")["limits"],
        bench_dir=bench_dir,
    )


def load_module(path: Path):
    """Import one reader file by path (metrics/, roofline/)."""
    spec = importlib.util.spec_from_file_location(f"frame_bench_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(bench_dir: Path, name: str):
    return load_module(bench_dir / "metrics" / f"{name}.py")


def roofline(bench_dir: Path, kernel: str):
    return load_module(bench_dir / "roofline" / f"{kernel}.py")


def spans_for(cell: Cell) -> list:
    """The span files whose label a per-layer metric of the cell reads
    (the reader's ``SPAN``), in name order: a span that no metric of a
    cell reads adds no host cost to its traced slice."""
    wanted = {getattr(metric_reader(cell.bench_dir, m["name"]), "SPAN", None)
              for m in cell.per_layer}
    found = [_read_json(p) for p in sorted((cell.bench_dir / "spans").glob("*.json"))]
    return [s for s in found if s["label"] in wanted]
