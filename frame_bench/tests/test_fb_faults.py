"""The comparison catches what it must: each cell's control (the port's
11-bit HDR path) and the faults a renderer can have, planted under the
timed path of an otherwise whole run (the harness's look for a card
skipped), make ``correct`` false; the sound run makes it true. On the
CPU at 32x32 with each cell's own limits."""

import time

import pytest

from bench_core import spec
from bench_core.harness import run_cell

SIZE = (32, 32)
CELLS = ["classroom_spatial_temporal_1080p.moving", "classroom_spatial_temporal_1080p.still"]


def unchanged(r):
    """A step that returns its state unchanged: after the first frame,
    the first frame again, and the renderer never advances."""
    real, first = r.render_frame, []

    def frame(gb, cam, scene_key=None):
        if not first:
            first.append(real(gb, cam, scene_key=scene_key))
        return first[0].clone()

    r.render_frame = frame


def half_left_out(r):
    """Half of the frame left out: the lower half's pixels are the mean
    of the rest."""
    real = r.render_frame

    def frame(gb, cam, scene_key=None):
        img = real(gb, cam, scene_key=scene_key).clone()
        h = img.shape[0] // 2
        img[h:] = img[:h].mean(dim=(0, 1))
        return img

    r.render_frame = frame


def one_pixel_altered(r):
    """An answer altered where it is produced: one pixel's red channel
    of every frame raised by 1."""
    real = r.render_frame

    def frame(gb, cam, scene_key=None):
        img = real(gb, cam, scene_key=scene_key).clone()
        img[img.shape[0] // 3, img.shape[1] // 5, 0] += 1.0
        return img

    r.render_frame = frame


def run(name, tmp_path, **kw):
    return run_cell(spec.load_cell(name), 11, 0.1, False, "cpu", time.perf_counter(),
                    size=SIZE, cache_dir=tmp_path, **kw)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tmp_path, small):
    out = run(name, tmp_path)
    assert out["correct"] and out["failed"] == 0
    assert all(c["value"] == 0.0 for c in out["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name, tmp_path, small):
    out = run(name, tmp_path, hdr_64bit=False)
    assert not out["correct"] and out["failed"] > 0


@pytest.mark.parametrize("fault", [unchanged, half_left_out, one_pixel_altered])
@pytest.mark.parametrize("name", CELLS)
def test_fault_fails(name, fault, tmp_path, small):
    out = run(name, tmp_path, fault=fault)
    assert not out["correct"]
