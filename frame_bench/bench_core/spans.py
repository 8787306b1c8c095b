"""Spans the benchmark puts around calls into the port.

Each ``spans/*.json`` names a function of the port by the module where
its caller looks it up and the attribute there (``{"label", "module",
"attr"}``), and may name a roofline count (``"roofline": <kernel>``)
whose ``launch(args, kwargs)`` records each call's shapes. The wrapper
opens a ``torch.profiler.record_function`` range under the label around
the call; the port is not edited. Wrappers are installed for the traced
slice only and removed after it.
"""

from __future__ import annotations

import functools
import importlib

FRAME = "Frame"  # one Renderer.render_frame call
PRESENT = "Present"  # the synchronize that presents it


class Spans:
    def __init__(self, span_files: list, roofline_of):
        """``roofline_of(kernel)`` loads ``roofline/<kernel>.py``."""
        self.files = span_files
        self.roofline_of = roofline_of
        self.launches: dict = {}  # label -> [shape dict per call while installed]
        self._saved = []

    def install(self):
        from torch.profiler import record_function

        for s in self.files:
            mod = importlib.import_module(s["module"])
            orig = getattr(mod, s["attr"])
            shape = self.roofline_of(s["roofline"]).launch if "roofline" in s else None
            self.launches.setdefault(s["label"], [])
            setattr(mod, s["attr"], self._wrap(orig, s["label"], shape, record_function))
            self._saved.append((mod, s["attr"], orig))

    def _wrap(self, orig, label, shape, record_function):
        @functools.wraps(orig)
        def spanned(*args, **kwargs):
            if shape is not None:
                self.launches[label].append(shape(args, kwargs))
            with record_function(label):
                return orig(*args, **kwargs)

        return spanned

    def remove(self):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()
