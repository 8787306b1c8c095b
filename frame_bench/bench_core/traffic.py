"""The one traffic generator. A mix is a data file (``traffic/<name>.json``):

- ``poses``: the camera cycle, as offsets of the configuration's camera
  along its x axis; frame i is shown from pose i mod len(poses). A
  real-time configuration rasterizes each pose with its motion vectors to
  the pose before it in the cycle (one pose: exact zeros).
- ``probes``: ``{"kind": "constant", "color": [r, g, b]}`` or
  ``{"kind": "baked", "resolution": n}`` (the configuration's probes,
  baked once; the two closest to the first pose's camera bound once).
- ``restart``: ``"max_sample"`` passes a new ``scene_key`` once the
  offline accumulation is full, as a user re-renders a still after an
  edit, so every frame traces; every other frame passes none (the scene
  is unchanged). Absent, no frame passes a key.

The loop is closed with one caller: the next frame starts when the last
one has been presented.
"""

from __future__ import annotations


class Traffic:
    def __init__(self, spec: dict):
        self.poses = spec["poses"]
        self.restart = spec.get("restart")
        if self.restart not in (None, "max_sample"):
            raise ValueError(f"unknown restart rule {self.restart!r}")

    def pose(self, i: int) -> int:
        return i % len(self.poses)

    def scene_key(self, renderer, edits: int):
        """The ``scene_key`` of the next frame after ``edits`` edits: a
        new key (``edits + 1``) once the accumulation is full, else None."""
        if self.restart == "max_sample" and renderer.sample >= renderer.max_sample:
            return edits + 1
        return None
