"""Layout -> device-placement bridge (DESIGN.md §4).

Promotes the paper's technique to a first-class placement engine for the
framework's parallel workloads:

  * ``data_partition``   — GLAD layout of the GNN data graph over mesh slices,
                           exported as padded per-device vertex lists + halo
                           exchange plans for the shard_map BSP engine.
  * ``expert_layout``    — MoE expert placement: experts are vertices weighted
                           by routed-token load (C_P), expert co-activation is
                           the link set (C_T = all-to-all bytes), mesh slices
                           are the servers.  GLAD-S minimizes collective
                           traffic + compute imbalance.
  * ``rebalance``        — straggler mitigation: re-run GLAD-E with degraded
                           alpha_i for the slow device.

The port's copy of ``repro.core.partition``, with ``repro`` renamed ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.cost import CostModel, GNNWorkload
from repro_torch.core.glad_s import glad_s
from repro_torch.graphs.datagraph import DataGraph
from repro_torch.graphs.edgenet import EdgeNetwork, pod_edge_network


@dataclasses.dataclass
class DevicePartition:
    """A static, padding-complete partition consumable by shard_map.

    All arrays are rectangular (padded with -1 / last-valid) so the compiled
    program is shape-static regardless of the layout.
    """

    num_parts: int
    assign: np.ndarray            # (n,) vertex -> part
    part_vertices: np.ndarray     # (P, cap) vertex ids, -1 padded
    part_sizes: np.ndarray        # (P,)
    halo_src: np.ndarray          # (P, halo_cap) vertex ids this part must RECEIVE
    halo_sizes: np.ndarray        # (P,)
    cut_links: int
    cost_factors: dict
    # Optional move-vs-replicate overlay (core.cost.Replication) attached by
    # the replicate= solver knob: the read-only copies each part should host
    # on top of its residents.  compile_plan promotes it to the ShardPlan's
    # persistent replica table.
    replication: Optional[object] = None

    @property
    def capacity(self) -> int:
        return int(self.part_vertices.shape[1])


def _pad_lists(lists, pad_val=-1, cap: Optional[int] = None) -> np.ndarray:
    cap = cap or max((len(l) for l in lists), default=1)
    cap = max(cap, 1)
    out = np.full((len(lists), cap), pad_val, dtype=np.int64)
    for k, l in enumerate(lists):
        out[k, : len(l)] = l
    return out


def halos_of(
    graph: DataGraph,
    assign: np.ndarray,
    num_parts: int,
    parts: Optional[np.ndarray] = None,
) -> dict:
    """Per-part halo sets: the out-of-part neighbors each part aggregates.

    One grouped pass over the cut links (no per-part edge scan): every cut
    link (u, v) contributes (part(v), u) and (part(u), v) need-pairs; a
    single ``np.unique`` over the combined key yields each part's halo,
    sorted ascending by vertex id — deterministic, and the order the
    ShardPlan's searchsorted halo coordinates rely on.

    ``parts`` restricts the output (and the grouping work) to a subset —
    the plan-patch path asks only for the dirty parts.
    """
    targets = range(num_parts) if parts is None else [int(p) for p in parts]
    empty = np.zeros(0, np.int64)
    out = {p: empty for p in targets}
    e = graph.edges
    if len(e) == 0 or graph.n == 0:
        return out
    pu, pv = assign[e[:, 0]], assign[e[:, 1]]
    cross = pu != pv
    if parts is not None:
        # Restrict BEFORE materializing the need-pairs: a dirty-part patch
        # pays O(cut links incident to dirty parts), not O(cut links).
        inpart = np.zeros(num_parts, dtype=bool)
        inpart[np.asarray(parts, dtype=np.int64)] = True
        c1 = cross & inpart[pv]
        c2 = cross & inpart[pu]
    else:
        c1 = c2 = cross
    owner = np.concatenate([pv[c1], pu[c2]]).astype(np.int64)
    need = np.concatenate([e[c1, 0], e[c2, 1]]).astype(np.int64)
    if len(owner) == 0:
        return out
    key = np.unique(owner * np.int64(graph.n) + need)
    ow = key // graph.n
    nd = key % graph.n
    bounds = np.searchsorted(ow, np.array(sorted(targets) + [num_parts]))
    for k, p in enumerate(sorted(targets)):
        out[p] = nd[bounds[k]:bounds[k + 1]]
    return out


def partition_from_assign(
    graph: DataGraph, assign: np.ndarray, num_parts: int, factors: dict,
    replication=None,
) -> DevicePartition:
    parts = [np.where(assign == p)[0] for p in range(num_parts)]
    sizes = np.array([len(p) for p in parts], dtype=np.int64)
    # Halo: for each part, the out-of-part neighbors its vertices aggregate.
    e = graph.edges
    halo_map = halos_of(graph, assign, num_parts)
    halos = [halo_map[p] for p in range(num_parts)]
    cut = int((assign[e[:, 0]] != assign[e[:, 1]]).sum()) if len(e) else 0
    return DevicePartition(
        num_parts=num_parts,
        assign=assign.astype(np.int64),
        part_vertices=_pad_lists(parts),
        part_sizes=sizes,
        halo_src=_pad_lists(halos),
        halo_sizes=np.array([len(h) for h in halos], dtype=np.int64),
        cut_links=cut,
        cost_factors=factors,
        replication=replication,
    )


def data_partition(
    graph: DataGraph,
    gnn: GNNWorkload,
    num_parts: int,
    pods: int = 1,
    net: Optional[EdgeNetwork] = None,
    R: Optional[int] = None,
    seed: int = 0,
    init: Optional[np.ndarray] = None,
    workers: int = 0,
    cache: "bool | str" = "auto",
    chunk_nodes: "int | str" = "auto",
    warm: "bool | str" = "auto",
    multilevel: "bool | str" = False,
    coarsen_to: int = 1024,
    levels: Optional[int] = None,
    replicate: "bool | dict" = False,
) -> DevicePartition:
    """GLAD-S over a pod-shaped EdgeNetwork -> shard_map-ready partition.

    Uses the batched disjoint-pair sweep — the placement bridge wants wall
    time, not the paper's exact Alg.-1 trajectory.  ``workers`` /
    ``cache`` / ``chunk_nodes`` / ``warm`` tune the engine's block fan-out,
    cross-round assembly caching and warm-started incremental re-solves;
    ``multilevel`` ('auto' recommended for n >= 200k) routes the layout
    through the coarsen/solve/refine V-cycle
    (see :func:`repro_torch.core.glad_s.glad_s`).  ``replicate`` (True or a dict
    of ``replicate_greedy`` kwargs) attaches the move-vs-replicate overlay
    to the partition — ``compile_plan`` then materializes the replica
    table; the cut itself is unchanged."""
    if net is None:
        net = pod_edge_network(num_parts, graph.n, pods=pods, seed=seed)
    cm = CostModel(net, graph, gnn)
    res = glad_s(cm, R=R, seed=seed, init=init, sweep="batched",
                 workers=workers, cache=cache, chunk_nodes=chunk_nodes,
                 warm=warm, multilevel=multilevel, coarsen_to=coarsen_to,
                 levels=levels, replicate=replicate)
    return partition_from_assign(graph, res.assign, num_parts, res.factors,
                                 replication=res.replication)


# --------------------------------------------------------------------- MoE
def coactivation_graph(
    routing_counts: np.ndarray, top_pairs: int = 4096
) -> DataGraph:
    """Build the expert co-activation graph from a routing histogram.

    Args:
      routing_counts: (E, E) symmetric counts of token-level co-routing
        (tokens whose top-k set contains both experts), diagonal = load.
    """
    E = routing_counts.shape[0]
    iu, ju = np.triu_indices(E, 1)
    wts = routing_counts[iu, ju]
    order = np.argsort(wts)[::-1][:top_pairs]
    keep = order[wts[order] > 0]
    edges = np.stack([iu[keep], ju[keep]], axis=1)
    g = DataGraph(n=E, edges=edges)
    # Weights aligned to the CANONICAL edge order (C_T = tau * co-activation).
    g.edge_weights = routing_counts[g.edges[:, 0], g.edges[:, 1]].astype(
        np.float64)
    g.coords = np.zeros((E, 2), dtype=np.float32)
    return g


def expert_layout(
    routing_counts: np.ndarray,
    num_slices: int,
    pods: int = 1,
    flops_per_token: float = 1.0,
    bytes_per_pair: float = 1.0,
    balance_rounds: int = 5,
    balance_tol: float = 1.15,
    seed: int = 0,
) -> DevicePartition:
    """GLAD applied to MoE expert placement (DESIGN.md §4, kimi/deepseek).

    Cost mapping: the unary term carries per-expert routed load (alpha_i *
    load_v — the paper's C_P), C_T carries co-activation traffic (tau *
    co-routed tokens).  Because makespan (max per-slice load) is not
    expressible in GLAD's linear unary terms, we add *congestion pricing*
    on top of the paper: after each layout, alpha_i of overloaded slices is
    scaled up exponentially and GLAD-S re-runs warm-started, until the load
    imbalance meets ``balance_tol`` (beyond-paper extension, DESIGN.md §7).
    """
    E = routing_counts.shape[0]
    g = coactivation_graph(routing_counts)
    net = pod_edge_network(num_slices, E, pods=pods, seed=seed,
                           link_cost=bytes_per_pair)
    load = routing_counts.diagonal().astype(np.float64)
    net.mu = np.zeros((E, num_slices))
    gnn = GNNWorkload([1, 1], agg_scale=flops_per_token, name="moe")
    target = load.sum() / num_slices

    # 1) Capacity-capped agglomeration: merge heaviest co-activation pairs
    #    while cluster load stays under target*tol (union-find).
    cap = target * balance_tol
    parent = np.arange(E)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    cl_load = load.copy()
    order = np.argsort(-g.edge_weights) if len(g.edges) else []
    for ei in order:
        u, v = g.edges[ei]
        ru, rv = find(u), find(v)
        if ru != rv and cl_load[ru] + cl_load[rv] <= cap:
            parent[rv] = ru
            cl_load[ru] += cl_load[rv]

    # 2) Bin-pack clusters largest-first onto the least-loaded slice.
    roots = {}
    for v in range(E):
        roots.setdefault(find(v), []).append(v)
    slices_load = np.zeros(num_slices)
    assign0 = np.zeros(E, dtype=np.int64)
    for r, members in sorted(roots.items(),
                             key=lambda kv: -load[kv[1]].sum()):
        s = int(np.argmin(slices_load))
        assign0[members] = s
        slices_load[s] += load[members].sum()

    # 3) GLAD-S refinement with a balance guard: accept the refined layout
    #    only while the load imbalance stays within tolerance (makespan is
    #    outside GLAD's linear objective — noted in DESIGN.md §7).
    cm = CostModel(net, g, gnn)
    res = glad_s(cm, seed=seed, init=assign0, R=num_slices, sweep="batched")
    sl = np.array([load[res.assign == s].sum() for s in range(num_slices)])
    if sl.max() > cap * 1.05:
        assign = assign0
        factors = cm.factors(assign0)
    else:
        assign = res.assign
        factors = res.factors
    return partition_from_assign(g, assign, num_slices, factors)


def rebalance(
    graph: DataGraph,
    gnn: GNNWorkload,
    part: DevicePartition,
    net: EdgeNetwork,
    straggler: int,
    slow_factor: float,
    seed: int = 0,
    workers: int = 0,
    cache: "bool | str" = "auto",
    chunk_nodes: "int | str" = "auto",
    warm: "bool | str" = "auto",
    multilevel: "bool | str" = False,
    coarsen_to: int = 1024,
    levels: Optional[int] = None,
    replicate: "bool | dict" = False,
    session=None,
) -> DevicePartition:
    """Straggler mitigation: degrade the slow server's compute coefficients
    and run an incremental re-layout warm-started from the current one.
    ``multilevel`` escalates to the V-cycle (warm init restricted up the
    hierarchy by majority vote) — for fleets serving very large graphs.
    ``replicate`` re-greedies the move-vs-replicate overlay against the
    degraded fleet and attaches it to the new partition.  ``session``
    (a :class:`repro_torch.core.engine.LayoutSession`) reuses engine state from
    previous relayouts; incompatible with ``multilevel``."""
    net2 = net.degrade(straggler, slow_factor)
    cm = CostModel(net2, graph, gnn)
    res = glad_s(cm, init=part.assign, R=net2.m, seed=seed, sweep="batched",
                 workers=workers, cache=cache, chunk_nodes=chunk_nodes,
                 warm=warm, multilevel=multilevel, coarsen_to=coarsen_to,
                 levels=levels, replicate=replicate, session=session)
    return partition_from_assign(graph, res.assign, part.num_parts,
                                 res.factors, replication=res.replication)
