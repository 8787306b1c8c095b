"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command(bench):
    assert set(bench) == TOP_KEYS
    assert bench["command"] == ["python3", "frame_bench/run.py"]
    assert bench["paths"] == ["frame_bench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_full_check_fits_its_time_with_24_cells(bench):
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_entry_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert w["config"] in names and len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        names.append(w["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        names.append(m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in bench["workloads"]}
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    roofline = [m for m in bench["per_layer"] if m["name"].endswith("_roofline")]
    assert roofline and all(m["unit"] == "%" for m in roofline)


def test_every_cell_has_its_files(bench):
    from bench_core import spec

    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"] and cell.limits
        assert any(m["name"] == "setup_s" for m in cell.end_to_end) and len(cell.end_to_end) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.metric_reader(BENCH_DIR, m["name"]).read)


def test_config_files_match_their_entries(bench):
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("frame_bench/")
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert (cfg["height"], cfg["width"]) == (1080, 1920)


def test_traffic_passes_a_key_only_when_the_scene_changes():
    """The restart rule passes a new scene key once the accumulation is
    full and none otherwise; a mix without it never passes one."""
    from types import SimpleNamespace

    from bench_core.traffic import Traffic

    full, filling = SimpleNamespace(sample=512, max_sample=512), SimpleNamespace(sample=3,
                                                                                 max_sample=512)
    still = Traffic({"poses": [0.0], "restart": "max_sample"})
    assert still.scene_key(filling, 0) is None
    assert still.scene_key(full, 0) == 1 and still.scene_key(full, 4) == 5
    moving = Traffic({"poses": [0.0, 0.05]})
    assert moving.scene_key(full, 0) is None and moving.pose(3) == 1
    with pytest.raises(ValueError):
        Traffic({"poses": [0.0], "restart": "sometimes"})


def _listed_cells(test_file: str, name: str) -> set:
    """The cell names of the (cell, frames) list ``name`` in a test file,
    read from its source: importing the anchor would load JAX."""
    import ast

    tree = ast.parse((BENCH_DIR / "tests" / test_file).read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == name
                                                for t in node.targets):
            return {cell for cell, _ in ast.literal_eval(node.value)}
    raise AssertionError(f"{test_file} has no {name}")


def test_every_config_is_anchored():
    """Every configuration file, whether or not BENCHMARK.json lists it, has
    a cell in the anchor against the JAX package and in the bit-for-bit
    test against the port's plain path."""
    configs = {p.stem for p in (BENCH_DIR / "configs").glob("*.json")}
    for test_file, name in (("test_fb_anchor.py", "CELLS"), ("test_fb_reference.py", "CASES")):
        cells = _listed_cells(test_file, name)
        assert configs <= {c.rsplit(".", 1)[0] for c in cells}, test_file
        for c in cells:
            config, traffic = c.rsplit(".", 1)
            assert (BENCH_DIR / "traffic" / f"{traffic}.json").exists(), c
