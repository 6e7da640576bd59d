"""Periodic whole-graph inference (the paper's workload: every vertex's
prediction refreshed from new readings).

Set-up draws the weights and a ring of feature snapshots from the seed on
the card, lays each snapshot out in the layout's blocks, as each edge
server would hold its own vertices' readings, and warms the program's
captured BSP forward up (its first call runs eagerly and captures).  Step
k runs the forward over snapshot k mod ring.  The outputs of the first
pass over the ring and of the last are kept, and once the program has
been released each is compared with the plain reference, in float64, on
its snapshot."""
from __future__ import annotations

import time

import torch

from bench import checks
from bench.ref.common import TF32, Precision, graph_tensors

METRIC = "infer_ms"


class Traffic:
    train = False

    def __init__(self, system, seed: int, params: dict):
        dev = system.device
        self.system, self.ring = system, int(params["ring"])
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.params = system.params(gen)
        n, d = system.graph["n"], system.dims[0]
        self.x = torch.randn((self.ring, n, d), generator=gen, device=dev)
        self.blocks = system.scatter(self.x, lead=1)
        self.fwd = system.forward()
        self.mode = self.fwd.mode
        t0 = time.perf_counter()
        for k in range(int(params["warmup"])):
            self.fwd(self.params, self.blocks[k % self.ring])
        system.timings["warmup_s"] = time.perf_counter() - t0
        self.first, self.last = {}, {}

    def call(self, k: int) -> None:
        s = k % self.ring
        out = self.fwd(self.params, self.blocks[s])
        if k < self.ring:
            self.first[s] = out
        self.last[s] = out

    def window(self, res: dict) -> dict:
        return {METRIC: res["seconds"] / max(res["steps"], 1) * 1e3}

    def release(self) -> None:
        self.fwd = None
        self.blocks = None

    def check(self, limits: dict) -> tuple:
        """({"out_err": (value, limit)}, answers compared, answers failed)."""
        sys_ = self.system
        graph = graph_tensors(sys_.graph["n"], sys_.graph["edges"],
                              sys_.device)
        errs = []
        for s in range(self.ring):
            outs = [o for o in (self.first.get(s), self.last.get(s))
                    if o is not None]
            if not outs:
                continue
            with torch.no_grad():
                ref = sys_.model.forward(self.params, self.x[s], graph,
                                         Precision(torch.float64))
            errs += [checks.rel_max_err(sys_.gather(o), ref) for o in outs]
        return self._judge(errs, limits)

    def control(self, limits: dict) -> tuple:
        """:meth:`check` with the reference in TF32 in the program's place,
        over every snapshot."""
        sys_ = self.system
        graph = graph_tensors(sys_.graph["n"], sys_.graph["edges"],
                              sys_.device)
        errs = []
        with torch.no_grad():
            for s in range(self.ring):
                ref = sys_.model.forward(self.params, self.x[s], graph,
                                         Precision(torch.float64))
                low = sys_.model.forward(self.params, self.x[s], graph,
                                         TF32())
                errs.append(checks.rel_max_err(low, ref))
        return self._judge(errs, limits)

    @staticmethod
    def _judge(errs: list, limits: dict) -> tuple:
        worst = max(errs) if errs else float("inf")
        limit = limits["out_err"]
        failed = sum(not checks.passes(e, limit) for e in errs)
        return {"out_err": (worst, limit)}, len(errs), failed
