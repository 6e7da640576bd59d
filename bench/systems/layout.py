"""The GNN layout system, built from a configuration file: the data graph
and the fleet from the frozen generators, then the program's own GLAD-S
layout, its plan and its BSP forward (``repro_torch.gnn``).

The benchmark hands the program the graph and the fleet it made, feeds it
blocks scattered by the program's vertex-to-row map once that map has
been checked, and reads the program's outputs back through the same map.
"""
from __future__ import annotations

import dataclasses
import importlib
import time
from typing import Optional

import numpy as np
import torch

import repro_torch.gnn  # noqa: F401  (the program, timed as an import)
from bench.yardstick import cost, fleet, peaks


def model_module(name: str):
    """The reference module of a model (``bench/ref/<name>.py``)."""
    return importlib.import_module(f"bench.ref.{name}")


def graph_module(name: str):
    """A data-graph generator (``bench/graphs/<name>.py``)."""
    return importlib.import_module(f"bench.graphs.{name}")


def halo_rows(n: int, edges: np.ndarray, assign: np.ndarray) -> int:
    """Rows a layout makes servers hold for their neighbours: for every
    server, its vertices' neighbours that live elsewhere, each once."""
    a = assign[edges[:, 0]]
    b = assign[edges[:, 1]]
    cut = a != b
    # (server that needs the row, vertex whose row it needs)
    need = np.concatenate([
        a[cut] * np.int64(n) + edges[cut, 1],
        b[cut] * np.int64(n) + edges[cut, 0]])
    return int(len(np.unique(need)))


def load_kernels(config: dict, device: torch.device) -> bool:
    """Loads the program's kernel library, building it on a checkout's
    first run, where the configuration's forward aggregates with it (K1);
    whether it did."""
    from repro_torch.gnn import GNNConfig
    from repro_torch.gnn.distributed import resolve_aggregate
    cfg = GNNConfig(config["model"], tuple(config["layer_dims"]))
    if resolve_aggregate(cfg, config["forward"]["aggregate"],
                         device) != "bsr":
        return False
    from repro_torch.kernels import _build
    _build.load_library()
    return True


@dataclasses.dataclass
class Layout:
    """The layout's own checks: every vertex on exactly one server, the
    program's vertex-to-row map a bijection onto the real vertices that
    agrees with the assignment."""

    assign_bad: int        # vertices whose server is not one of the fleet's
    row_map_bad: int       # vertices with no row, two rows, or a row on
                           # another server; padded rows naming a vertex
    rows: np.ndarray       # (n,) flat row p * cap + r of every vertex


def check_layout(n: int, m: int, assign: np.ndarray,
                 local: np.ndarray) -> Layout:
    assign = np.asarray(assign)
    assign_bad = int(n - np.count_nonzero(
        (assign >= 0) & (assign < m))) if assign.shape == (n,) else n
    P, cap = local.shape
    flat = local.reshape(-1)
    real = flat >= 0
    bad = int(np.count_nonzero(flat >= n))
    ids = flat[real & (flat < n)]
    count = np.bincount(ids, minlength=n)
    bad += int(np.count_nonzero(count != 1))
    rows = np.full(n, -1, dtype=np.int64)
    where = np.flatnonzero(real & (flat < n))
    rows[flat[where]] = where
    ok = (rows >= 0) & (count == 1)
    if assign_bad == 0:
        bad += int(np.count_nonzero(ok & (rows // cap != assign)))
    return Layout(assign_bad, bad, rows)


class System:
    """A configuration, built: ``graph`` and ``fleet`` (the frozen
    generators' arrays), the program's layout (``assign``, its reported
    ``reported_cost``) and ``plan``; ``layout_cost`` by the frozen Eq. 9;
    ``timings`` of GLAD-S and of the plan.  ``model`` is the reference
    module (``bench/ref/<model>.py``), ``dims`` its layer widths; the
    port's GNN path computes in float32 with TF32 off."""

    peak_ops_per_s = peaks.FP32_OPS_PER_S

    def __init__(self, config: dict, device: torch.device,
                 graphs: Optional[bool] = None):
        from repro_torch.core import (
            CostModel, glad_s, partition_from_assign, workload_for)
        from repro_torch.gnn import GNNConfig, compile_plan
        from repro_torch.graphs.datagraph import DataGraph
        from repro_torch.graphs.edgenet import EdgeNetwork

        self.config, self.device, self.graphs = config, device, graphs
        self.model = model_module(config["model"])
        self.dims = tuple(config["layer_dims"])
        g = config["graph"]
        t0 = time.perf_counter()
        self.graph = graph_module(g["generator"]).generate(**g["params"])
        n, edges = self.graph["n"], self.graph["edges"]
        fl = config["fleet"]
        self.fleet = fleet.build(self.graph["coords"], **fl)
        self.timings = {"graph_and_fleet_s": time.perf_counter() - t0}

        port_graph = DataGraph(n=n, edges=edges.copy(),
                               coords=self.graph["coords"])
        net = EdgeNetwork(**{k: self.fleet[k] for k in (
            "m", "w", "tau", "alpha", "beta", "gamma", "rho", "eps", "mu",
            "sku", "coords")})
        dims = self.dims
        cm = CostModel(net, port_graph, workload_for(
            config["model"], dims[0], hidden=dims[1], out_dim=dims[-1],
            layers=len(dims) - 1))
        lay = config["layout"]
        t0 = time.perf_counter()
        res = glad_s(cm, seed=lay["seed"])
        self.timings["glad_s_s"] = time.perf_counter() - t0
        self.assign = np.asarray(res.assign)
        self.reported_cost = float(res.cost)
        self.layout_cost = cost.total(self.fleet, n, edges, config["model"],
                                      dims, self.assign)

        t0 = time.perf_counter()
        part = partition_from_assign(port_graph, self.assign, fl[
            "num_servers"], cm.factors(self.assign))
        self.plan = compile_plan(port_graph, part, **config["plan"])
        self.timings["plan_s"] = time.perf_counter() - t0
        self.cfg = GNNConfig(config["model"], dims)
        self.layout = check_layout(n, fl["num_servers"], self.assign,
                                   self.plan.local)
        self.counts = {"n": n, "arcs": 2 * len(edges),
                       "halo_rows": halo_rows(n, edges, self.assign),
                       "rows": int(self.plan.local.size),
                       "messages": int(self.plan.edges_dst.size)}
        self._forward = None

    # ------------------------------------------- what the harness reads
    def checks(self, limits: dict) -> dict:
        """The layout's own comparisons, each with its limit: vertices off
        the fleet, faults of the vertex-to-row map, and the gap between
        the program's reported cost and the frozen Eq. 9."""
        lay = self.layout
        return {"assign_bad": (lay.assign_bad, 0),
                "row_map_bad": (lay.row_map_bad, 0),
                "cost_gap": (abs(self.reported_cost - self.layout_cost)
                             / self.layout_cost, limits["cost_gap"])}

    def values(self) -> dict:
        """The end-to-end metrics the system gives: the layout's cost."""
        return {"layout_cost": self.layout_cost}

    def flops(self, train: bool) -> float:
        """The model's floating-point operations a step on the real graph
        (a forward, or with ``train`` a whole SGD step)."""
        return self.model.flops(self.counts, self.dims, train)

    # -------------------------------------------------- the program's entry
    def forward(self):
        """The program's BSP forward over the plan, made once, its plan
        tensors (and the BSR pack, where it aggregates with K1) built and
        counted into ``plan_s``."""
        if self._forward is None:
            from repro_torch.gnn import make_bsp_forward
            fw = self.config["forward"]
            t0 = time.perf_counter()
            fwd = make_bsp_forward(self.cfg, self.plan, device=self.device,
                                   graphs=self.graphs, **fw)
            fwd.sync()
            self.timings["plan_s"] += time.perf_counter() - t0
            self._forward = fwd
        return self._forward

    def train_step(self, labels_blocks, mask_blocks, lr: float):
        from repro_torch.gnn import make_distributed_train_step
        return make_distributed_train_step(self.cfg, self.forward(),
                                           labels_blocks, mask_blocks, lr=lr)

    def release(self) -> None:
        """Drop the program's forward, its plan tensors and its graphs."""
        self._forward = None

    # ------------------------------------------------- the benchmark's data
    def params(self, gen: torch.Generator):
        """Glorot-uniform weights with the model's leaves, drawn on the
        device in one call."""
        shapes = self.model.param_shapes(self.dims)
        sizes = [int(np.prod(s)) for layer in shapes
                 for s, _, _ in layer.values()]
        u = torch.rand(sum(sizes), generator=gen, device=self.device)
        parts = iter(torch.split(u, sizes))
        out = []
        for layer in shapes:
            leaves = {}
            for k, (shape, fan_in, fan_out) in layer.items():
                lim = (6.0 / (fan_in + fan_out)) ** 0.5
                leaves[k] = ((2.0 * next(parts) - 1.0) * lim).reshape(shape)
            out.append(leaves)
        return out

    def rows(self) -> torch.Tensor:
        return torch.as_tensor(self.layout.rows, device=self.device)

    def scatter(self, x: torch.Tensor, lead: int = 0,
                fill=0) -> torch.Tensor:
        """``x`` with the vertex axis after ``lead`` leading axes, in vertex
        order, as blocks (..., P, cap, ...) by the checked map; ``fill`` on
        padded rows."""
        P, cap = self.plan.local.shape
        head, tail = tuple(x.shape[:lead]), tuple(x.shape[lead + 1:])
        out = torch.full(head + (P * cap,) + tail, fill, dtype=x.dtype,
                         device=x.device)
        out[(slice(None),) * lead + (self.rows(),)] = x
        return out.reshape(head + (P, cap) + tail)

    def gather(self, blocks: torch.Tensor) -> torch.Tensor:
        """(P, cap, d) blocks -> (n, d) in vertex order by the checked map."""
        P, cap = blocks.shape[:2]
        return blocks.reshape(P * cap, *blocks.shape[2:])[self.rows()]
