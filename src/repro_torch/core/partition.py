"""Layout -> device-partition bridge (the port's copy of the host half of
``repro.core.partition``).

``DevicePartition``, ``_pad_lists``, ``halos_of`` and
``partition_from_assign`` are copied line for line; the GLAD-driven
``data_partition`` / ``expert_layout`` / ``rebalance`` come with the layout
slice, together with the cost model they need.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.graphs.datagraph import DataGraph


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
