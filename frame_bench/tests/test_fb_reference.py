"""The frozen reference (``sspt_plain``) against the port's plain path on
the CPU at 64x64: a few frames of each configuration through both sides'
``Renderer`` from the same inputs, bit for bit. The test imports both;
the reference itself imports neither the port nor JAX."""

import copy

import pytest
import torch

from bench_core.inputs import make_inputs
from bench_core.sides import PROGRAM, REFERENCE, Side
from bench_core.traffic import Traffic

SIZE = (64, 64)
CASES = [  # (cell, frames)
    ("boxscene_offline_1080p.still", 3),
    ("boxscene_offline_1080p.probe_lit", 2),
    ("classroom_spatial_temporal_1080p.moving", 4),
    ("classroom_spatial_temporal_1080p.still", 3),
    ("boxscene_glass_spatial_temporal_1080p.moving", 4),
    ("boxscene_glass_spatial_temporal_1080p.still", 3),
]


@pytest.mark.parametrize("cell_name, frames", CASES)
def test_reference_equals_the_ports_plain_path(cell_name, frames, tmp_path, pair_cell):
    cell = pair_cell(cell_name)
    inputs = make_inputs(cell.config, cell.traffic, *SIZE, cache_dir=tmp_path)
    traffic = Traffic(cell.traffic)
    images = {}
    for pkg in (PROGRAM, REFERENCE):
        side = Side(pkg)
        r = side.make_renderer(cell.config, inputs, "cpu")
        r.frame_index = 4321
        gbs = [side.gbuffers(p, "cpu") for p in inputs.poses]
        cams = [side.cam(p, "cpu") for p in inputs.poses]
        images[pkg] = [r.render_frame(gbs[traffic.pose(i)], cams[traffic.pose(i)], scene_key=0)
                       for i in range(frames)]
    for a, b in zip(images[PROGRAM], images[REFERENCE]):
        assert torch.equal(a, b)
    assert float(images[REFERENCE][-1].abs().sum()) > 0.0


@pytest.mark.parametrize("part, change", [
    ("cfg", {"hiz_home_prefix": True}),
    ("cfg", {"pallas_extract": True}),
    ("settings", {"noise_method": "BLUE_NOISE"}),
    ("settings", {"noise_method": "SOBOL_OWEN"}),
    ("renderer", {"kernel": "xla"}),
])
def test_reference_raises_on_paths_it_leaves_out(part, change, tmp_path, pair_cell):
    """What the copy leaves out raises rather than running another path,
    also under refraction with back faces."""
    cell = pair_cell("boxscene_glass_spatial_temporal_1080p.still")
    config = copy.deepcopy(cell.config)
    config[part].update(change)
    inputs = make_inputs(config, cell.traffic, 32, 32, cache_dir=tmp_path)
    side = Side(REFERENCE)
    with pytest.raises(ValueError, match="this copy"):
        r = side.make_renderer(config, inputs, "cpu")
        r.render_frame(side.gbuffers(inputs.poses[0], "cpu"), side.cam(inputs.poses[0], "cpu"))
