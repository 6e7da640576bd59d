"""Fault tolerance runtime: failure detection, elastic re-layout, restart.

This is where the paper's algorithms become the cluster's control plane:

  * node loss      -> vertex deletions in the server graph; GLAD-E proves
                      deletions never raise cost (Sec. V-B), so the surviving
                      fleet re-layouts incrementally in O(changed) time;
  * straggler      -> per-device step-time EWMA feeds the alpha_i compute
                      coefficients; the Thm-8 drift bound decides WHEN a
                      re-layout pays for the migration it causes;
  * restart        -> CheckpointManager's mesh-agnostic restore re-shards the
                      state onto whatever slice count survived.

Heartbeats are timestamps supplied by the caller (tests drive a fake clock).

The port's copy of ``repro.runtime.fault``, with ``repro`` renamed ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.core.cost import CostModel, GNNWorkload
from repro_torch.core.engine import LayoutSession
from repro_torch.core.glad_s import glad_s
from repro_torch.core.partition import DevicePartition, partition_from_assign
from repro_torch.graphs.datagraph import DataGraph
from repro_torch.graphs.edgenet import EdgeNetwork


@dataclasses.dataclass
class DeviceHealth:
    last_heartbeat: float = 0.0
    step_time_ewma: float = 0.0
    alive: bool = True
    # False until the device is first observed (heartbeat/revive/sweep).
    # Guards the timeout compare: the 0.0 default is not a real heartbeat
    # time, and wall-clock sweeps must not treat it as one.
    seen: bool = False


class FailureDetector:
    """Heartbeat-timeout failure detection + step-time EWMA (straggler)."""

    def __init__(self, num_devices: int, timeout_s: float = 30.0,
                 ewma: float = 0.2):
        self.devices = [DeviceHealth() for _ in range(num_devices)]
        self.timeout_s = timeout_s
        self.ewma = ewma

    def heartbeat(self, device: int, now: float,
                  step_time_s: Optional[float] = None):
        """Record a heartbeat from a LIVE device.  A late heartbeat from a
        device already swept dead is ignored: sweep() reports each death
        exactly once, so silently flipping ``alive`` back would desync the
        detector from a coordinator that has already removed the server
        from the net.  Re-admitting a repaired device is an explicit
        control-plane action — :meth:`revive`."""
        d = self.devices[device]
        if not d.alive:
            return
        d.last_heartbeat = now
        d.seen = True
        if step_time_s is not None:
            d.step_time_ewma = (step_time_s if d.step_time_ewma == 0.0 else
                                (1 - self.ewma) * d.step_time_ewma
                                + self.ewma * step_time_s)

    def revive(self, device: int, now: float):
        """Explicitly re-admit a repaired device (fresh EWMA, live again)."""
        d = self.devices[device]
        d.alive = True
        d.last_heartbeat = now
        d.step_time_ewma = 0.0
        d.seen = True

    def sweep(self, now: float) -> List[int]:
        """Mark timed-out devices dead; return newly-dead ids.

        A device that has never been observed is STAMPED with the sweep
        time instead of judged by it: the fresh-detector default
        ``last_heartbeat=0.0`` is not a real heartbeat, and comparing a
        wall-clock ``now`` against it would declare the entire fleet dead
        on the first sweep.  The stamp starts that device's timeout clock
        at first observation (registration time, effectively), so a device
        that stays silent still dies exactly one timeout period later."""
        dead = []
        for i, d in enumerate(self.devices):
            if not d.alive:
                continue
            if not d.seen:
                d.last_heartbeat = now
                d.seen = True
                continue
            if now - d.last_heartbeat > self.timeout_s:
                d.alive = False
                dead.append(i)
        return dead

    def stragglers(self, factor: float = 2.0) -> List[int]:
        """Devices whose EWMA step time exceeds factor x the median step
        time of the OTHER live devices (leave-one-out).  Including a
        device's own sample would let an extreme straggler drag the fleet
        median up past its own threshold: with two devices at 1s and 10s,
        the self-inclusive median is 5.5s and the 10s device passes a
        factor-2 check — mathematically undetectable."""
        live = [(i, d.step_time_ewma) for i, d in enumerate(self.devices)
                if d.alive and d.step_time_ewma > 0]
        if len(live) < 2:
            return []
        out = []
        for k, (i, t) in enumerate(live):
            others = [t2 for j, (_, t2) in enumerate(live) if j != k]
            if t > factor * float(np.median(others)):
                out.append(i)
        return out


@dataclasses.dataclass
class RelayoutEvent:
    kind: str                   # 'failure' | 'straggler' | 'revive'
    devices: List[int]
    old_cost: float
    new_cost: float
    migrated: int
    wall_time_s: float
    # Move delta vs the pre-event layout: the vertices a serving layer must
    # re-home — feed straight into gnn.distributed.patch_plan to patch the
    # live ShardPlan instead of recompiling it.
    moved: Optional[np.ndarray] = None


class ElasticCoordinator:
    """Drives GLAD re-layout when the failure detector reports changes.

    Holds the data-graph layout of the current workload (the GNN data
    partition, or any workload expressed as a graph — MoE expert placement
    plugs in the same way).
    """

    def __init__(self, net: EdgeNetwork, graph: DataGraph, gnn: GNNWorkload,
                 part: DevicePartition, workers: int = 0,
                 cache: "bool | str" = "auto",
                 chunk_nodes: "int | str" = "auto",
                 warm: "bool | str" = "auto",
                 multilevel: "bool | str" = False,
                 coarsen_to: int = 1024,
                 levels: Optional[int] = None,
                 chunk_vertices: "int | str | None" = None,
                 replicate: "bool | dict" = False,
                 session: bool = True):
        self.net = net
        self.graph = graph
        self.gnn = gnn
        self.part = part
        # EdgeNetwork mutations have no inverse (without_server floods the
        # dead server's rows with OFFLINE_COST; the originals are gone), so
        # on_revive rebuilds the current net by replaying the surviving ops
        # — ("dead", d) / ("degrade", s, factor), in commit order — over
        # the pristine topology.
        self._pristine_net = net
        self._net_ops: List[tuple] = []
        self.events: List[RelayoutEvent] = []
        # Move delta of the most recent relayout (also on each event) — the
        # input to the serving layer's ShardPlan patch.
        self.last_moved: np.ndarray = np.zeros(0, dtype=np.int64)
        # Engine knobs for the GLAD re-layouts (assembly caching, chunked
        # block fan-out, warm-started incremental re-solves) — relayout
        # latency is the control plane's budget.  The warm-started
        # relayouts carry no active mask, so cache/warm 'auto' resolve OFF
        # there; pass cache=True, warm=True to retain flow state across a
        # coordinator's repeated relayouts of the same fleet.  'multilevel'
        # ('auto' recommended for very large graphs) escalates relayouts to
        # the coarsen/solve/refine V-cycle — the warm init is restricted up
        # the hierarchy by majority vote, so survivors still anchor the
        # coarse solve.
        # 'replicate' (True or replicate_greedy kwargs) keeps a
        # move-vs-replicate overlay attached to every partition this
        # coordinator produces; its replicas double as the degraded-mode
        # fallback on failure — an orphan with a live replica re-homes to
        # the replica's host instead of a random survivor.
        # One persistent LayoutSession for the coordinator's lifetime:
        # consecutive relayouts of the same fleet rebind the engine
        # (diff-driven epoch bumps for the degraded/dead/revived servers)
        # instead of rebuilding it from scratch, keeping the assembly
        # cache and warm residuals alive across events.  With multilevel
        # the session ALSO carries the persistent LevelStack: the data
        # graph is constant across fault events, so every escalated
        # relayout refreshes the cached coarsening hierarchy (reused
        # matchings, rebuilt coarse cost models) instead of re-coarsening
        # from scratch, and the V-cycle's finest refinement adopts the
        # engine.  'chunk_vertices' streams any coarsening in bounded
        # vertex windows (out-of-core scale).  session=False forces the
        # per-event rebuild (the benchmark's A/B control arm).
        self._session = (None if not session else
                         LayoutSession(workers=workers, cache=cache,
                                       chunk_nodes=chunk_nodes, warm=warm))
        self._glad_opts = dict(workers=workers, cache=cache,
                               chunk_nodes=chunk_nodes, warm=warm,
                               multilevel=multilevel, coarsen_to=coarsen_to,
                               levels=levels, chunk_vertices=chunk_vertices,
                               replicate=replicate, session=self._session)

    def on_failure(self, dead: List[int], seed: int = 0) -> DevicePartition:
        """Node loss: disconnect dead servers, re-layout incrementally
        (warm-started — survivors keep their placement unless they hosted
        orphans)."""
        t0 = time.perf_counter()
        net = self.net
        for d in dead:
            net = net.without_server(d)
        cm = CostModel(net, self.graph, self.gnn)
        # Recompute under the DEGRADED net (same convention as
        # on_straggler) so RelayoutEvent deltas are comparable across event
        # kinds: old_cost is "what staying put would cost now", not the
        # stale stored total from before the failure.
        old_cost = cm.total(self.part.assign)
        # Orphans must move; everything else is warm-started.  An orphan
        # whose row is REPLICATED on a surviving server re-homes there (the
        # copy is already resident — degraded mode serves from it with zero
        # migration); lowest replica-hosting part wins, deterministically.
        # Remaining orphans scatter randomly as before.
        assign = self.part.assign.copy()
        orphan = np.isin(assign, dead)
        alive = [i for i in range(net.m) if i not in dead]
        rng = np.random.default_rng(seed)
        assign[orphan] = rng.choice(alive, size=int(orphan.sum()))
        repl = getattr(self.part, "replication", None)
        if repl is not None:
            placed = np.zeros(self.graph.n, dtype=bool)
            for p in sorted(repl.by_part):
                if p in dead:
                    continue                 # the copy died with its host
                ids = np.asarray(repl.by_part[p], dtype=np.int64)
                take = ids[orphan[ids] & ~placed[ids]]
                assign[take] = p
                placed[take] = True
        res = glad_s(cm, init=assign, R=net.m, seed=seed, sweep="batched",
                     **self._glad_opts)
        new_part = partition_from_assign(self.graph, res.assign,
                                         self.part.num_parts, res.factors,
                                         replication=res.replication)
        moved = np.flatnonzero(res.assign != self.part.assign)
        self.events.append(RelayoutEvent(
            "failure", dead, old_cost, res.cost, len(moved),
            time.perf_counter() - t0, moved=moved))
        self._net_ops += [("dead", d) for d in dead]
        self.net = net
        self.part = new_part
        self.last_moved = moved
        return new_part

    def on_straggler(self, slow: List[int], slow_factor: float = 3.0,
                     seed: int = 0) -> DevicePartition:
        """Degrade the straggler's compute coefficients and re-layout."""
        t0 = time.perf_counter()
        net = self.net
        for s in slow:
            net = net.degrade(s, slow_factor)
        cm = CostModel(net, self.graph, self.gnn)
        old_cost = cm.total(self.part.assign)
        res = glad_s(cm, init=self.part.assign, R=net.m, seed=seed,
                     sweep="batched", **self._glad_opts)
        new_part = partition_from_assign(self.graph, res.assign,
                                         self.part.num_parts, res.factors,
                                         replication=res.replication)
        moved = np.flatnonzero(res.assign != self.part.assign)
        self.events.append(RelayoutEvent(
            "straggler", slow, old_cost, res.cost, len(moved),
            time.perf_counter() - t0, moved=moved))
        self._net_ops += [("degrade", s, slow_factor) for s in slow]
        self.net = net
        self.part = new_part
        self.last_moved = moved
        return new_part

    def on_revive(self, devices: List[int], seed: int = 0) -> DevicePartition:
        """Re-admit repaired servers and re-layout onto the restored fleet.

        The detector's :meth:`FailureDetector.revive` flips the device
        live again, but without this hook the coordinator's net keeps
        pricing it at OFFLINE_COST forever — ``without_server`` has no
        inverse.  The current net is therefore rebuilt from the pristine
        topology by replaying, in commit order, every failure/degrade op
        whose device is NOT being revived: the revived server returns at
        its pristine coefficients (mirroring the detector's fresh EWMA),
        and the warm-started relayout pulls work back onto it wherever
        that pays."""
        t0 = time.perf_counter()
        back = set(devices)
        self._net_ops = [op for op in self._net_ops if op[1] not in back]
        net = self._pristine_net
        for op in self._net_ops:
            net = (net.without_server(op[1]) if op[0] == "dead"
                   else net.degrade(op[1], op[2]))
        cm = CostModel(net, self.graph, self.gnn)
        old_cost = cm.total(self.part.assign)
        res = glad_s(cm, init=self.part.assign, R=net.m, seed=seed,
                     sweep="batched", **self._glad_opts)
        new_part = partition_from_assign(self.graph, res.assign,
                                         self.part.num_parts, res.factors,
                                         replication=res.replication)
        moved = np.flatnonzero(res.assign != self.part.assign)
        self.events.append(RelayoutEvent(
            "revive", list(devices), old_cost, res.cost, len(moved),
            time.perf_counter() - t0, moved=moved))
        self.net = net
        self.part = new_part
        self.last_moved = moved
        return new_part
