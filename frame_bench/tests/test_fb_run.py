"""The harness end to end on the CPU at a tiny size: the result line's
keys, no fall-back to the CPU without a card, the import guard, and the
harness finding a configuration, a traffic mix and a metric that were
only added as files and entries."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
SIZE = (32, 32)


def test_result_line_keys():
    sys.path.insert(0, str(BENCH_DIR))
    import run

    out = {"correct": True, "attempted": 3, "failed": 0, "metrics": {"frame_ms": {}},
           "busy_s": 1.0, "window_s": 2.0, "breakdown": {"device_ops": [], "idle_gaps": []},
           "checks": {"rel_rmse": {"value": 0.0, "limit": 1e-3}}, "memory_peak_bytes": 5}
    dev = {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 5}
    plain = run.result_line(out, dev, trace=False)
    assert list(plain) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(plain["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    traced = run.result_line(out, dev, trace=True)
    assert list(traced) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                            "checks"]
    assert traced["device"]["busy_s"] == 1.0 and traced["device"]["window_s"] == 2.0


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "frame_bench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


def test_no_card_fails_without_a_result(tmp_path):
    """Without a CUDA device the run fails and prints no result; it
    never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run(["--workload", "classroom_spatial_temporal_1080p.moving", "--seed", "3",
              "--seconds", "1",
              "--trace", "0"], ROOT)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
    assert "CUDA" in p.stderr


def test_benchmark_files_alone_fail(tmp_path):
    """A directory holding only BENCHMARK.json and frame_bench/ has no
    program: the run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "frame_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["--workload", "classroom_spatial_temporal_1080p.moving", "--seed", "3",
              "--seconds", "1",
              "--trace", "0"], tmp_path)
    assert p.returncode != 0 and not p.stdout.strip()


GUARD_SCRIPT = """
import sys, time, json
sys.path[:0] = [{root!r}, {bench!r}]
from bench_core import guard, spec
from bench_core.harness import run_cell, TRACE_FRAMES
import bench_core.harness as h
h.TRACE_FRAMES = 2
h.step_frame = lambda seed, first: first
out = run_cell(spec.load_cell("classroom_spatial_temporal_1080p.moving"), 5, 0.1, False, "cpu",
               time.perf_counter(), size={size!r}, cache_dir={cache!r})
print(json.dumps({{"correct": out["correct"], "forbidden": guard.forbidden_loaded(),
                  "loaded": sorted({{guard.top(m) for m in sys.modules}})}}))
"""


def test_a_run_loads_no_jax(tmp_path):
    """A run of the harness in a fresh interpreter loads the port and the
    frozen reference and no module of JAX or the JAX package (top-level
    names compared whole); the reference's sources import none of them
    nor the port."""
    from bench_core import guard

    code = GUARD_SCRIPT.format(root=str(ROOT), bench=str(BENCH_DIR), size=SIZE,
                               cache=str(tmp_path))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["forbidden"] == []
    assert {"unitysspathtracingurp_tpu_torch", "sspt_plain"} <= set(res["loaded"])
    assert guard.reference_violations(BENCH_DIR / "sspt_plain") == []


def test_guard_compares_whole_top_level_names():
    from bench_core import guard

    assert guard.forbidden_loaded(["unitysspathtracingurp_tpu_torch.ops", "jaxtyping",
                                   "sspt_plain"]) == []
    assert guard.forbidden_loaded(["jax.numpy", "unitysspathtracingurp_tpu.ops.rng", "flax",
                                   "numpy"]) == ["flax", "jax.numpy",
                                                 "unitysspathtracingurp_tpu.ops.rng"]


def test_guard_finds_an_import_of_the_port(tmp_path):
    from bench_core import guard

    (tmp_path / "a.py").write_text("import numpy\nfrom unitysspathtracingurp_tpu_torch import x\n")
    (tmp_path / "b.py").write_text("from . import c\nimport jax.numpy as jnp\n")
    assert guard.reference_violations(tmp_path) == [(str(tmp_path / "a.py"),
                                                     "unitysspathtracingurp_tpu_torch"),
                                                    (str(tmp_path / "b.py"), "jax")]


NEW_METRIC = '''"""Frames in the traced slice that opened the accumulation's span (a
metric and its span added as files)."""

SPAN = "Offline Accumulation"


def read(trace):
    return float(trace.frames) if SPAN in {s.label for s in trace.spans} else None
'''
NEW_SPAN = {"label": "Offline Accumulation", "attr": "offline_accumulate",
            "module": "unitysspathtracingurp_tpu_torch.models.renderer"}


def test_added_files_are_found(tmp_path, small):
    """A configuration, a traffic mix, a per-layer metric and its span,
    each added as a file and a BENCHMARK.json entry to a copy of the
    benchmark, are found and run without editing any file that was
    there; the span is installed only in the cell whose metric reads it."""
    from bench_core import spec
    from bench_core.harness import run_cell

    shutil.copytree(BENCH_DIR, tmp_path / "frame_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "frame_bench").rglob("*") if p.is_file()}
    fb = tmp_path / "frame_bench"
    cfg = json.loads((fb / "configs" / "boxscene_offline_1080p.json").read_text())
    cfg.update(name="boxscene_offline_2b_1080p", settings={**cfg["settings"], "maximum_depth": 2})
    (fb / "configs" / "boxscene_offline_2b_1080p.json").write_text(json.dumps(cfg))
    (fb / "traffic" / "pan.json").write_text(json.dumps({
        "poses": [0.0, 0.02, 0.04], "probes": {"kind": "constant", "color": [0.1, 0.1, 0.1]},
        "restart": "max_sample"}))
    (fb / "metrics" / "frames_traced.py").write_text(NEW_METRIC)
    (fb / "spans" / "offline_accum.json").write_text(json.dumps(NEW_SPAN))
    name = "boxscene_offline_2b_1080p.pan"
    (fb / "limits" / f"{name}.json").write_text(json.dumps({"limits": {"rel_rmse": 1e-6}}))
    bench["configs"].append({"name": "boxscene_offline_2b_1080p", "source": "x",
                             "file": "frame_bench/configs/boxscene_offline_2b_1080p.json",
                             "reduced": ["maximum_depth"], "why": "x"})
    bench["workloads"].append({"name": name, "config": "boxscene_offline_2b_1080p",
                               "traffic": "pan", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                               "source": "device_trace", "layer": "harness",
                               "moves": "frame_ms", "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell(name, root=tmp_path, bench_dir=fb)
    assert cell.config["settings"]["maximum_depth"] == 2 and len(cell.traffic["poses"]) == 3
    assert [m["name"] for m in cell.per_layer][-1] == "frames_traced"
    assert NEW_SPAN in spec.spans_for(cell)
    old = spec.load_cell("classroom_spatial_temporal_1080p.moving", root=tmp_path, bench_dir=fb)
    assert NEW_SPAN not in spec.spans_for(old) and spec.spans_for(old)
    out = run_cell(cell, 7, 0.1, True, "cpu", time.perf_counter(), size=SIZE,
                   cache_dir=tmp_path / "cache")
    assert out["correct"] and out["metrics"]["frames_traced"]["value"] == small.TRACE_FRAMES
    for p, data in before.items():
        assert p.read_bytes() == data
