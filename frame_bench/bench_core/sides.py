"""Both sides of the comparison, built from the same inputs.

``PROGRAM`` is the port under test; ``REFERENCE`` is the frozen copy of
its plain path in ``sspt_plain``. They share module names, so one
adapter builds either side's settings, G-buffers, cameras, probes and
``Renderer`` from the cell's configuration and the inputs' arrays.
Each side derives what it derives (probe mips, depth tiles, history)
itself.
"""

from __future__ import annotations

import enum
import importlib

PROGRAM = "unitysspathtracingurp_tpu_torch"
REFERENCE = "sspt_plain"


class Side:
    def __init__(self, package: str):
        def mod(name):
            return importlib.import_module(f"{package}.{name}")

        self.package = package
        self.config = mod("config")
        self.camera = mod("camera")
        self.gbuffer = mod("gbuffer")
        self.envprobe = mod("ops.envprobe")
        self.renderer = mod("models.renderer")

    def settings(self, config: dict):
        """(PTSettings, PTConfig) of the configuration file: enum fields
        by member name, lists as tuples."""
        PTSettings, PTConfig = self.config.PTSettings, self.config.PTConfig
        defaults = PTSettings()
        kw = {}
        for k, v in config["settings"].items():
            d = getattr(defaults, k)
            kw[k] = type(d)[v] if isinstance(d, enum.Enum) else v
        cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in config["cfg"].items()}
        return PTSettings(**kw), PTConfig(**cfg)

    def gbuffers(self, pose, device):
        import torch

        return self.gbuffer.GBuffers(**{k: torch.as_tensor(v).to(device)
                                        for k, v in pose.gbuffers.items()})

    def cam(self, pose, device):
        import torch

        return self.camera.Camera(**{k: torch.as_tensor(v).to(device)
                                     for k, v in pose.camera.items()})

    def probe_list(self, probes: dict, device) -> list:
        import torch

        ep = self.envprobe
        out = []
        for raw in probes["probes"]:
            t = {k: torch.as_tensor(v).to(device) for k, v in raw.items()}
            out.append(ep.EnvProbe(**t, mips=ep.build_probe_mips(t["texture"])))
        return out

    def make_renderer(self, config: dict, inputs, device, hdr_64bit: bool | None = None):
        """The configuration's Renderer with the traffic's probes bound
        (baked probes: the two closest to pose 0's camera, bound once)."""
        from .inputs import fov_y

        settings, cfg = self.settings(config)
        r_cfg = config["renderer"]
        probes = None
        if inputs.probes["kind"] == "constant":
            probes = self.envprobe.ProbeSet(
                probe0=self.envprobe.constant_probe(inputs.probes["color"], device=device))
        r = self.renderer.Renderer(
            settings, inputs.height, inputs.width, cfg=cfg, probes=probes,
            fov_y=fov_y(config), kernel=r_cfg["kernel"], device=device,
            hdr_64bit=r_cfg["hdr_64bit"] if hdr_64bit is None else hdr_64bit)
        if inputs.probes["kind"] == "baked":
            r.bind_probes(self.probe_list(inputs.probes, device), inputs.probes["positions"],
                          self.cam(inputs.poses[0], device))
        return r
