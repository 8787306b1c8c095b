"""The cell's inputs, made by the benchmark and handed to both sides.

The scene, its cameras and G-buffers and the baked probes come from the
frozen copies in ``sspt_plain`` (``models/scene.py``, the host
rasterizer and cameras of ``models/fixtures.py``, ``models/probes.py``),
so a later change to the port's fixtures does not move the yardstick.
Inputs are plain numpy arrays; each side builds its own tensors and
objects from them.

Rasterizing a 1080p pose takes seconds on the host, so G-buffers are
kept in ``build/frame_bench/inputs/`` inside the checkout, keyed on the
scene, cameras, size and the sources that make them; a later run of the
cell loads them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from pathlib import Path

import numpy as np

from .spec import BENCH_DIR, ROOT

CACHE_DIR = ROOT / "build" / "frame_bench" / "inputs"
_SOURCES = ("sspt_plain/models/fixtures.py", "sspt_plain/models/scene.py",
            "sspt_plain/camera.py", "sspt_plain/gbuffer.py", "bench_core/inputs.py")


@dataclasses.dataclass
class Pose:
    gbuffers: dict  # GBuffers field -> array
    camera: dict  # Camera field -> array


@dataclasses.dataclass
class Inputs:
    height: int
    width: int
    poses: list  # Pose, in the traffic's camera cycle
    probes: dict  # {"kind": "constant", "color"} or {"kind": "baked", "probes", "positions"}


def camera_at(scene_cfg: dict, offset: float, height: int, width: int):
    """The frozen copy's camera of the config at ``offset`` along the
    camera's x axis (the traffic's pose)."""
    from sspt_plain.camera import make_camera

    c = scene_cfg["camera"]
    eye = list(c["eye"])
    eye[0] += offset
    return make_camera(eye=eye, target=c["target"], up=c["up"],
                       fov_y=np.radians(c["fov_y_deg"]), aspect=width / height,
                       near=c["near"], far=c["far"], device="cpu")


def build_scene(scene_cfg: dict):
    from sspt_plain.models import scene

    return getattr(scene, f"build_{scene_cfg['name']}_scene")(**scene_cfg.get("build", {}))


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name).numpy() for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _cache_key(config: dict, traffic: dict, height: int, width: int) -> str:
    h = hashlib.sha256(json.dumps([config["scene"], config["settings"]["denoiser"],
                                   traffic["poses"], height, width], sort_keys=True).encode())
    for rel in _SOURCES:
        h.update((BENCH_DIR / rel).read_bytes())
    return h.hexdigest()[:20]


def _rasterize(config: dict, traffic: dict, height: int, width: int) -> list:
    from sspt_plain.models import fixtures

    scene_cfg = config["scene"]
    sc = build_scene(scene_cfg)
    offsets = traffic["poses"]
    cams = [camera_at(scene_cfg, o, height, width) for o in offsets]
    realtime = config["settings"]["denoiser"] in ("TEMPORAL", "SPATIAL_TEMPORAL")
    poses = []
    for i, cam in enumerate(cams):
        # Real-time frames carry motion vectors to the previous pose of
        # the cycle (exact zeros for a camera that stays).
        prev = cams[i - 1] if realtime else None
        gb = fixtures.rasterize_gbuffers(sc, cam, height, width, device="cpu",
                                         with_backface=scene_cfg.get("backface", False),
                                         prev_cam=prev)
        poses.append(Pose(gbuffers=_fields(gb), camera=_fields(cam)))
    return poses


def _save(path: Path, poses: list):
    flat = {}
    for i, p in enumerate(poses):
        flat.update({f"{i}.gb.{k}": v for k, v in p.gbuffers.items()})
        flat.update({f"{i}.cam.{k}": v for k, v in p.camera.items()})
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def _load(path: Path, n: int) -> list:
    with np.load(path) as data:
        poses = [Pose({}, {}) for _ in range(n)]
        for key in data.files:
            i, kind, name = key.split(".")
            (poses[int(i)].gbuffers if kind == "gb" else poses[int(i)].camera)[name] = data[key]
    return poses


def bake_probes(config: dict, traffic: dict) -> dict:
    p = traffic["probes"]
    if p["kind"] == "constant":
        return {"kind": "constant", "color": p["color"]}
    from sspt_plain.models.probes import bake_probe

    scene_cfg = config["scene"]
    box = scene_cfg["probes"]
    sc = build_scene(scene_cfg)
    baked = [bake_probe(sc, pos, resolution=p["resolution"], seed=i, box_min=box["box_min"],
                        box_max=box["box_max"], device="cpu")
             for i, pos in enumerate(box["positions"])]
    # Each side builds its own mips from the baked texture.
    return {"kind": "baked", "positions": box["positions"],
            "probes": [_fields(dataclasses.replace(b, mips=None)) for b in baked]}


def make_inputs(config: dict, traffic: dict, height: int | None = None,
                width: int | None = None, cache_dir: Path | None = CACHE_DIR) -> Inputs:
    """The cell's poses (cached) and probes. ``height`` / ``width``
    default to the configuration's; ``cache_dir=None`` keeps nothing."""
    height = height or config["height"]
    width = width or config["width"]
    poses = None
    path = None
    if cache_dir is not None:
        path = Path(cache_dir) / f"{_cache_key(config, traffic, height, width)}.npz"
        if path.exists():
            poses = _load(path, len(traffic["poses"]))
    if poses is None:
        poses = _rasterize(config, traffic, height, width)
        if path is not None:
            _save(path, poses)
    return Inputs(height=height, width=width, poses=poses, probes=bake_probes(config, traffic))


def fov_y(config: dict) -> float:
    return math.radians(config["scene"]["camera"]["fov_y_deg"])
