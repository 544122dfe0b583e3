"""The feed of frames made of one point cloud each: the ring comes from
the traffic generator (`generator.py`), and the configuration's pipeline
entry takes ``(xyz, valid, *args, **kwargs)`` and returns a NamedTuple.

A feed is the file `feeds/<name>.py` that a configuration names under
``feed`` (this one, ``cloud``, where it names none). It defines
``Feed(cfg, mix, seed, device)`` with:

- ``ring``: the number of distinct frames, made in set-up from ``seed``;
- ``run(i)``: frame ``i`` (ring slot ``i % ring``, RANSAC seed ``i``)
  through the program, on the card;
- ``read(out)``: what a downstream consumer reads of it, to the host;
- ``control(ref, i, dtype)``: the reference module's ``run`` in the
  program's place, in ``dtype``, on the same frame;
- ``judge(ref, i, out)``: the numbers compared, from the reference
  module's ``judge``.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from portbench import generator


class Feed:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg = cfg
        frames = generator.ring(cfg["scene"], mix, seed)
        self.ring = len(frames)
        self.xyz = [torch.from_numpy(f).to(device) for f in frames]
        self.valid = [torch.ones(f.shape[0], dtype=torch.bool, device=device)
                      for f in frames]
        mod, self.fn = cfg["entry"].split(":")
        self.module = importlib.import_module(mod)
        self.args = []
        for name, value in cfg["args"]:
            if name == "seed":
                self.args.append(None)
            elif isinstance(value, list):
                self.args.append(torch.tensor(value, dtype=torch.float32,
                                              device=device))
            else:
                self.args.append(np.float32(value))
        self.seed_at = [n for n, _ in cfg["args"]].index("seed")
        self.kwargs = dict(cfg["kwargs"])
        self.readout = list(cfg["readout"])

    def run(self, i: int):
        args = list(self.args)
        args[self.seed_at] = int(i)
        j = i % self.ring
        # Looked up at each call, so that a span or a fault swapped into
        # the module is the one called.
        return getattr(self.module, self.fn)(self.xyz[j], self.valid[j],
                                             *args, **self.kwargs)

    def read(self, out):
        """The frame's labels and flags to the host, as one copy."""
        parts = [getattr(out, f).reshape(-1).to(torch.int32)
                 for f in self.readout]
        return torch.cat(parts).cpu()

    def control(self, ref, i: int, dtype) -> dict:
        return ref.run(self.xyz[i % self.ring], self.cfg, i, dtype)

    def judge(self, ref, i: int, out) -> dict:
        out = out._asdict() if hasattr(out, "_asdict") else dict(out)
        return ref.judge(self.xyz[i % self.ring], out, self.cfg, i)
