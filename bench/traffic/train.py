"""Full-batch training: the program's captured distributed train step
(plain SGD) over every vertex, with features and labels drawn from the
seed and fixed, each step's new parameters feeding the next.

Set-up draws the weights and the data on the card and makes the step.
One call from the drawn weights runs eagerly and captures, and its
result is dropped: the window times replays only, so every step compared
is a replay too.  The first three steps then start again from the drawn
weights, through the window's own call, and the window goes on from the
third.  Once the program has been released, the plain reference follows
those three steps in float64 from the same weights: each step's loss,
the first gradient as the update applied it ((p0 - p1) / lr), and the
change of the parameters over the three, each by the worst leaf."""
from __future__ import annotations

import time

import torch

from bench import checks
from bench.ref.common import TF32, Precision, graph_tensors, sgd

METRIC = "train_step_ms"
FIRST = 3
# A leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone (a score's bias under the softmax).
STILL = 1e-3


class Traffic:
    train = True

    def __init__(self, system, seed: int, params: dict):
        dev = system.device
        self.system, self.lr = system, float(params["lr"])
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.params0 = system.params(gen)
        n, d = system.graph["n"], system.dims[0]
        self.x = torch.randn((n, d), generator=gen, device=dev)
        self.labels = (self.x[:, 0] + 0.5 * self.x[:, 1] > 0).long()
        self.blocks = system.scatter(self.x)
        self.step = system.train_step(
            system.scatter(self.labels),
            system.scatter(torch.ones(n, device=dev)), self.lr)
        self.mode = system.forward().mode
        t0 = time.perf_counter()
        self.step(self.params0, self.blocks)
        self.p, self.losses, self.after = self.params0, [], []
        for _ in range(FIRST):
            self.call(-1)
            self.losses.append(self.loss)
            self.after.append(self.p)
        system.timings["warmup_s"] = time.perf_counter() - t0

    def call(self, k: int) -> None:
        self.p, self.loss = self.step(self.p, self.blocks)

    def window(self, res: dict) -> dict:
        return {METRIC: res["seconds"] / max(res["steps"], 1) * 1e3}

    def release(self) -> None:
        self.step = None
        self.blocks = None

    def check(self, limits: dict) -> tuple:
        """The loss, first-gradient and change gaps, each with its limit;
        the steps compared; the numbers failed."""
        return self._judge(self.losses, self.after, limits)

    def control(self, limits: dict) -> tuple:
        """:meth:`check` with the reference in TF32 in the program's
        place."""
        sys_ = self.system
        graph = graph_tensors(sys_.graph["n"], sys_.graph["edges"],
                              sys_.device)
        losses, _, after = sgd(sys_.model, self.params0, self.x,
                               self.labels, graph, self.lr, FIRST, TF32())
        return self._judge(losses, after, limits)

    def _judge(self, losses, after, limits: dict) -> tuple:
        sys_ = self.system
        graph = graph_tensors(sys_.graph["n"], sys_.graph["edges"],
                              sys_.device)
        ref_losses, ref_g, ref_after = sgd(
            sys_.model, self.params0, self.x, self.labels, graph, self.lr,
            FIRST, Precision(torch.float64))
        got = numbers(self.params0, losses, after, ref_losses, ref_g,
                      ref_after, self.lr)
        self.leaf_norms = leaf_norms(self.params0, after, ref_g, ref_after,
                                     self.lr)
        out = {k: (v, limits[k]) for k, v in got.items()}
        failed = sum(not checks.passes(v, lim) for v, lim in out.values())
        return out, FIRST, failed


def numbers(params0, losses, after, ref_losses, ref_g, ref_after,
            lr: float) -> dict:
    """The three numbers compared: ``loss_gap`` (worst step's relative
    loss gap), ``grad_gap`` (first gradient) and ``change_gap`` (the
    change over the steps, over the leaves the reference moves)."""
    loss_gap = max(abs(float(a) - float(b)) / abs(float(b))
                   for a, b in zip(losses, ref_losses))
    p0 = checks.leaves(params0)
    g_got = {k: (p0[k].double() - v.double()) / lr
             for k, v in checks.leaves(after[0]).items()}
    g_ref = checks.leaves(ref_g)
    g_norm = {k: checks.norm(v) for k, v in g_ref.items()}
    med = sorted(g_norm.values())[len(g_norm) // 2]
    moved = {k for k, v in g_norm.items() if v >= STILL * med}
    d_got = {k: v.double() - p0[k].double()
             for k, v in checks.leaves(after[-1]).items()}
    d_ref = {k: v.double() - p0[k].double()
             for k, v in checks.leaves(ref_after[-1]).items()}
    return {"loss_gap": loss_gap,
            "grad_gap": checks.leaf_gaps(g_got, g_ref),
            "change_gap": checks.leaf_gaps(d_got, d_ref, keep=moved)}


def leaf_norms(params0, after, ref_g, ref_after, lr: float) -> dict:
    """Every leaf's norms, for a look at the numbers: the first gradient's
    (program's, reference's), the change's over the steps (program's,
    reference's) and the weights'."""
    p0 = checks.leaves(params0)
    one, last = checks.leaves(after[0]), checks.leaves(after[-1])
    g_ref, d_ref = checks.leaves(ref_g), checks.leaves(ref_after[-1])
    return {k: [checks.norm((p0[k].double() - one[k].double()) / lr),
                checks.norm(g_ref[k]),
                checks.norm(last[k].double() - p0[k].double()),
                checks.norm(d_ref[k] - p0[k].double()), checks.norm(p0[k])]
            for k in p0}
