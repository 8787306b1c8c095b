"""The frame benchmark's CPU tests: ``python -m pytest frame_bench/tests -q``.

They import the harness (``frame_bench/``) and the port from the
checkout and need no CUDA device."""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def small(monkeypatch):
    """Shrink the harness's fixed frame counts so a CPU run stays short:
    a 2-frame traced slice and the stepped frame right after it."""
    from bench_core import harness

    monkeypatch.setattr(harness, "TRACE_FRAMES", 2)
    monkeypatch.setattr(harness, "step_frame", lambda seed, first: first + seed % 2)
    return harness


@pytest.fixture
def pair_cell():
    """``name`` -> the cell ``<config>.<traffic>`` built from its files,
    whether or not BENCHMARK.json lists it (the offline configuration and
    mixes are kept for a later cell); it has no metrics and no limits."""
    import json

    from bench_core import spec

    def load(name: str):
        config, traffic = name.rsplit(".", 1)
        read = lambda kind, n: json.loads((BENCH_DIR / kind / f"{n}.json").read_text())  # noqa: E731
        return spec.Cell(name=name, chips=1, config=read("configs", config),
                         traffic=read("traffic", traffic), end_to_end=[], per_layer=[],
                         limits={}, bench_dir=BENCH_DIR)

    return load
