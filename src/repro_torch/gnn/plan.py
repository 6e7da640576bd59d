"""ShardPlan host code: compile -> patch -> BSR retiling -> data shuffling.

A numpy copy of the host half of ``repro/gnn/distributed.py`` (everything
above its device kernels).  The reference module imports JAX at its top, so
this code is copied rather than imported; ``tests/test_torch_plan.py`` holds
the two copies equal array for array over compiles, patch sequences, growth
and replica tables.  One difference is deliberate: :func:`_rebuild` takes
the old universe size from ``plan.assign``, where the reference reads
``plan.n`` after :func:`patch_plan` has already grown ``slot_of``, and fails
when a slot that inserts vertices overflows ``e_cap``.

Plan lifecycle (compile -> patch -> rebuild):

  * :func:`compile_plan` builds a :class:`ShardPlan` once on the host from
    (DataGraph, DevicePartition); every array is rectangular, and ``slack``
    reserves capacity headroom so later relayouts keep the shapes.
  * :func:`patch_plan` updates the plan in place for a new assignment (and
    optionally an evolved graph), rebuilding only the dirty partitions; the
    result is bit-identical to :func:`recompile_like`.
  * :func:`repro_torch.gnn.distributed.make_bsp_forward` keeps the plan's
    arrays resident on the device and refreshes them in place when
    ``plan.version`` moves; it rebuilds only when a capacity grows or a new
    ppermute round appears (:attr:`PlanDelta.retrace_expected`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.partition import DevicePartition, halos_of
from repro_torch.graphs.datagraph import DataGraph

_I32_MAX = np.iinfo(np.int32).max


def _pad_up(x: int, mult: int) -> int:
    return max(mult, ((x + mult - 1) // mult) * mult)


def _slack_cap(need: int, slack: float, pad_mult: int) -> int:
    """Capacity for ``need`` items with fractional headroom, pad-aligned."""
    return _pad_up(int(np.ceil(need * (1.0 + slack))), pad_mult)


def _grow_cap(cur: int, need: int, pad_mult: int) -> int:
    """Grow-by-doubling: smallest doubling of ``cur`` that fits ``need``."""
    cur = max(cur, pad_mult)
    while cur < need:
        cur *= 2
    return _pad_up(cur, pad_mult)


def _check_int32(cap: int, halo_cap: int) -> None:
    # Per-device tables (edges_src/edges_dst, round send/recv) hold LOCAL
    # coordinates bounded by cap + halo_cap + 1, pinned int32.  Global slot
    # ids p * cap + k are int64 (slot_of / halo_slot) — at large P * cap
    # they overflow int32 long before any per-device coordinate does.
    if cap + halo_cap + 1 > _I32_MAX:
        raise OverflowError(
            f"device table coordinates (cap={cap} + halo_cap={halo_cap} + 1) "
            f"exceed int32; shrink the partition capacity")


@dataclasses.dataclass
class PlanCaps:
    """Pinned plan capacities — compile with these and the arrays come out
    shape-identical (and, for the same assignment, bit-identical) to the
    plan they were read from.  ``round_widths`` also pins the ppermute
    schedule: every listed shift is emitted even when currently empty."""

    cap: int
    halo_cap: int
    e_cap: int
    round_widths: dict                  # shift -> padded width
    bsr_max_blocks: Optional[int] = None
    r_cap: int = 0                      # replica slots per device


@dataclasses.dataclass
class PlanBSR:
    """Per-device block-sparse (BSR) retiling of the plan's edge tables.

    The aggregation A @ table (A[dst, src] = link weight, table = [local;
    halo; zero row]) chopped into dense (bm, bk) blocks per device, in the
    exact (values, block_cols) layout ``kernels/gnn_aggregate.spmm``
    consumes.  All devices share one ``max_blocks`` so the stacked arrays
    are rectangular for the batched forward."""

    bm: int
    bk: int
    nb: int                             # dst block-rows per device
    max_blocks: int                     # stored blocks per dst block-row
    src_rows: int                       # table rows padded to a bk multiple
    values: np.ndarray                  # (P, nb*max_blocks, bm, bk) f32
    block_cols: np.ndarray              # (P, nb, max_blocks) int32


@dataclasses.dataclass
class PlanDelta:
    """What :func:`patch_plan` did — and whether the next forward retraces."""

    moved: np.ndarray                   # vertices whose server changed
    new_vertices: int                   # appended since the old plan
    dirty_parts: np.ndarray             # partitions whose tables rebuilt
    patched: bool                       # False -> full rebuild (a cap grew)
    grew: tuple = ()                    # which capacities grew, if any
    rounds_added: int = 0               # new ppermute shifts (schedule grew)

    @property
    def retrace_expected(self) -> bool:
        return bool(self.grew) or self.rounds_added > 0


@dataclasses.dataclass
class ShardPlan:
    """Rectangular, device-ready encoding of a GLAD layout."""

    num_parts: int
    cap: int                      # local vertex slots per device
    halo_cap: int                 # halo slots per device
    e_cap: int                    # directed-edge slots per device
    local: np.ndarray             # (P, cap) global vertex ids, -1 pad
    local_mask: np.ndarray        # (P, cap) bool
    slot_of: np.ndarray           # (n,) -> p * cap + k  (int64: P*cap scale)
    halo: np.ndarray              # (P, halo_cap) global ids, -1 pad
    halo_slot: np.ndarray         # (P, halo_cap) global SLOT ids, P*cap pad
    edges_src: np.ndarray         # (P, e_cap) table idx: [0,cap)=local,
                                  #   [cap,cap+halo_cap)=halo, pad=cap+halo_cap
    edges_dst: np.ndarray         # (P, e_cap) local idx, pad = cap
    deg: np.ndarray               # (P, cap) float32 global degree
    rounds: Sequence[dict]        # pruned ppermute rounds (stable schedule)
    halo_bytes_ppermute: int      # exchanged payload rows (sum over rounds)
    halo_rows_allgather: int      # rows moved by the naive path
    assign: np.ndarray            # (n,) the assignment this plan encodes
    pad_mult: int = 8
    slack: float = 0.0            # capacity-headroom fraction
    version: int = 0              # bumped by every patch (device-array cache)
    bsr: Optional[PlanBSR] = None
    # ---- persistent replica residents (move-vs-replicate overlay) -------
    # ``replication`` is the AUTHORITATIVE request: part -> sorted global
    # ids the part should host as read-only copies, independent of where
    # they are currently homed.  ``replica`` is its materialization at the
    # current assignment — the request minus ids homed on the part — in a
    # rectangular (P, r_cap) table parallel to ``halo`` (sorted ascending,
    # -1 pad), patched in place by :func:`patch_plan` under the same
    # bit-identity-vs-fresh-compile contract as every other table.
    # ``rounds0`` is the layer-0 ppermute schedule with replica-resident
    # landing slots pruned (replicas carry RAW input features, so only the
    # first exchange shrinks; deeper layers move activations and use the
    # full ``rounds``); ``replica_halo_mask`` marks which halo slots those
    # are, and ``halo_bytes_ppermute0`` counts the layer-0 rows that still
    # cross the network.
    replication: Optional[dict] = None
    r_cap: int = 0
    replica: Optional[np.ndarray] = None          # (P, r_cap) ids, -1 pad
    replica_halo_mask: Optional[np.ndarray] = None  # (P, halo_cap) bool
    rounds0: Optional[Sequence[dict]] = None
    halo_bytes_ppermute0: int = 0

    @property
    def table_rows(self) -> int:
        return self.cap + self.halo_cap + 1     # +1 zero row for padding

    @property
    def n(self) -> int:
        return int(self.slot_of.shape[0])

    @property
    def has_replicas(self) -> bool:
        return self.replication is not None


# --------------------------------------------------------- host construction
def _degree_buckets(deg: np.ndarray) -> np.ndarray:
    """Power-of-two degree buckets: floor(log2(deg)) (degree <= 1 -> 0).

    The member-slotting key: coarse enough that the small degree drift of
    incremental graph evolution almost never crosses a bucket boundary,
    while hubs still sort ahead of the tail (the BSR-density property the
    tiled aggregation kernels rely on)."""
    return np.where(deg > 1,
                    np.log2(np.maximum(deg, 1)).astype(np.int64), 0)


def _part_members(graph: DataGraph, assign: np.ndarray, num_parts: int,
                  parts=None) -> dict:
    """Per-part member lists: degree-BUCKET descending, vertex-id ascending
    within a bucket.

    Deterministic — two compiles of the same assignment produce identical
    tables — and hub-first, the within-partition ordering the BSR tiling
    assumes (kernels/gnn_aggregate: degree ordering concentrates links in
    few blocks, so block density tracks layout quality).  Bucketing by
    floor(log2(degree)) instead of exact degree makes slots ID-STABLE
    across patches: a vertex whose degree drifts within its power-of-two
    bucket keeps its relative slot, so ``patch_plan`` reslots (and the BSR
    layer retiles) only the parts whose membership or bucket census
    actually changed — the prerequisite for finer per-block-row BSR
    patching."""
    b = _degree_buckets(graph.degrees)
    out = {}
    for p in (range(num_parts) if parts is None else parts):
        vs = np.flatnonzero(assign == p)
        if len(vs):
            vs = vs[np.lexsort((vs, -b[vs]))]
        out[int(p)] = vs.astype(np.int64)
    return out


def _edge_tables(graph: DataGraph, assign: np.ndarray, loc_idx: np.ndarray,
                 halos: dict, parts, cap: int, halo_cap: int,
                 num_parts: int):
    """Per-device directed edge lists in table coordinates for ``parts``.

    The edge list is doubled into (src, dst) arcs; arcs are grouped by
    destination part PRESERVING the doubled order, so each destination's
    float summation order is graph-intrinsic — independent of the layout,
    the capacities, and of which parts this call rebuilds.  Returns
    (rows: dict p -> (src_row, dst_row, count), counts: (P,) arc counts).
    """
    e = graph.edges
    parts = [int(p) for p in parts]
    counts = {p: 0 for p in parts}
    if len(e) == 0:
        return {p: (np.zeros(0, np.int32), np.zeros(0, np.int32), 0)
                for p in parts}, counts
    # Prefilter by destination part BEFORE doubling, so a dirty-part patch
    # touches O(arcs incident to dirty parts), not O(2|E|).  Selection
    # preserves the doubled order: forward arcs (edge order) then backward
    # arcs (edge order) — the per-part subsequences match a full compile.
    pe_u, pe_v = assign[e[:, 0]], assign[e[:, 1]]
    inpart = np.zeros(num_parts, dtype=bool)
    inpart[parts] = True
    m1 = inpart[pe_v]                    # forward arcs: dst = e[:, 1]
    m2 = inpart[pe_u]                    # backward arcs: dst = e[:, 0]
    srcs = np.concatenate([e[m1, 0], e[m2, 1]])
    dsts = np.concatenate([e[m1, 1], e[m2, 0]])
    ps = np.concatenate([pe_v[m1], pe_u[m2]])
    # One stable part-sort groups every part's arcs (stable = doubled order
    # preserved within each part) instead of an O(|parts| * |arcs|) scan.
    order = np.argsort(ps, kind="stable")
    ps_sorted = ps[order]
    rows = {}
    for p in sorted(parts):
        lo, hi = np.searchsorted(ps_sorted, [p, p + 1])
        idx = order[lo:hi]
        s, d = srcs[idx], dsts[idx]
        same = assign[s] == p
        s_tab = np.where(same, loc_idx[s], 0).astype(np.int64)
        crossm = ~same
        if crossm.any():
            s_tab[crossm] = cap + np.searchsorted(halos[p], s[crossm])
        rows[p] = (s_tab.astype(np.int32), loc_idx[d].astype(np.int32),
                   int(len(s)))
        counts[p] = int(len(s))
    return rows, counts


def _build_rounds(assign: np.ndarray, halos: dict, loc_idx: np.ndarray,
                  num_parts: int, halo_cap: int, pad_mult: int,
                  slack: float, keep_widths: Optional[dict] = None):
    """ppermute rotation schedule.

    ``keep_widths`` pins the schedule: every listed shift is emitted even if
    it carries no traffic (so a patched plan keeps its collective structure
    and the jitted forward its signature), and pinned widths only grow —
    by doubling — when traffic overflows them.  Returns
    (rounds, total_rows, widths, widths_grew, new_shifts)."""
    rounds = []
    total_rows = 0
    widths = dict(keep_widths) if keep_widths else {}
    widths_grew = False
    new_shifts = 0
    for s in range(1, num_parts):
        sends = []
        for p in range(num_parts):
            q = (p + s) % num_parts
            hq = halos[q]
            sends.append(hq[assign[hq] == p] if len(hq) else hq)
        max_send = max((len(x) for x in sends), default=0)
        if max_send == 0 and s not in widths:
            continue
        if s not in widths:
            widths[s] = _slack_cap(max_send, slack, pad_mult)
            if keep_widths is not None:
                new_shifts += 1
        elif max_send > widths[s]:
            widths[s] = _grow_cap(widths[s], max_send, pad_mult)
            widths_grew = True
        w = widths[s]
        send_idx = np.full((num_parts, w), -1, dtype=np.int32)
        recv_pos = np.full((num_parts, w), halo_cap, dtype=np.int32)
        for p in range(num_parts):
            q = (p + s) % num_parts
            rows = sends[p]
            if len(rows):
                send_idx[p, : len(rows)] = loc_idx[rows]
                # device q receives from p at shift s; store where each row
                # lands in q's halo buffer.
                recv_pos[q, : len(rows)] = np.searchsorted(halos[q], rows)
            total_rows += len(rows)
        rounds.append({
            "shift": s, "send_idx": send_idx, "recv_pos": recv_pos,
            "width": w,
        })
    return rounds, total_rows, widths, widths_grew, new_shifts


def _patch_rounds(plan: ShardPlan, assign: np.ndarray, halos: dict,
                  loc_idx: np.ndarray, halo_changed, mover_parts, resized):
    """Incremental ppermute-schedule patch.

    The (p -> q) pair of a round changes only when q's halo SET changed
    (membership/order -> every sender's rows and recv positions may move),
    or p is a mover's old/new home (its selection inside stable halos
    flipped), or p re-slotted (its members' local indices shifted).  The
    affected pairs' rows are derived in ONE pass: every halo entry is a
    (receiver, sender, position) triple whose round is shift = (q - p) mod
    P; one lexsort of the affected triples groups every pair's send rows
    in halo order, so cost is O(affected halo entries * log) — flat in P —
    instead of per-pair python dispatch.  Traffic accounting is maintained
    by delta.  Pinned shifts persist even when empty; a pair gaining
    traffic on a missing shift adds a round (schedule change -> retrace);
    width overflow grows by doubling and copies the unaffected rows
    verbatim (shape change -> retrace).  Returns (widths_grew,
    new_shifts)."""
    Pn, halo_cap = plan.num_parts, plan.halo_cap
    dirty = sorted({int(q) for q in halo_changed})
    movres = sorted({int(p) for p in mover_parts} | {int(p) for p in resized})
    if not dirty and not movres:
        return False, 0
    by_shift = {r["shift"]: r for r in plan.rounds}
    total = plan.halo_bytes_ppermute
    widths_grew = False
    new_shifts = 0

    # Affected triples: receiver dirty (whole halo column) or sender
    # moved/re-slotted (its selection or local indices changed).
    in_q = np.zeros(Pn, dtype=bool)
    in_q[dirty] = True
    in_p = np.zeros(Pn, dtype=bool)
    in_p[movres] = True
    qs_l, hv_l, pos_l = [], [], []
    for q in range(Pn):
        hq = halos[q]
        if len(hq):
            qs_l.append(np.full(len(hq), q, dtype=np.int64))
            hv_l.append(hq)
            pos_l.append(np.arange(len(hq), dtype=np.int64))
    per_shift: dict = {}
    hv = pos = None
    if qs_l:
        qs = np.concatenate(qs_l)
        hv = np.concatenate(hv_l)
        pos = np.concatenate(pos_l)
        snd = assign[hv]
        aff = in_q[qs] | in_p[snd]
        qs, hv, pos, snd = qs[aff], hv[aff], pos[aff], snd[aff]
        if len(qs):
            shift = (qs - snd) % Pn
            order = np.lexsort((pos, snd, shift))
            shift, snd = shift[order], snd[order]
            pos, hv = pos[order], hv[order]
            key = shift * Pn + snd
            bounds = np.flatnonzero(np.diff(key)) + 1
            starts = np.concatenate([[0], bounds])
            ends = np.concatenate([bounds, [len(key)]])
            for a, b in zip(starts, ends):
                per_shift.setdefault(int(shift[a]), []).append(
                    (int(snd[a]), int(a), int(b)))

    for s in sorted(set(per_shift) | set(by_shift)):
        glist = per_shift.get(s, [])
        gmax = max((b - a for _, a, b in glist), default=0)
        r = by_shift.get(s)
        if r is None:
            # Shift currently pruned: it gains a round only if an affected
            # pair now carries traffic (clean pairs were and stay empty).
            if gmax == 0:
                continue
            w = _slack_cap(gmax, plan.slack, plan.pad_mult)
            r = {"shift": s,
                 "send_idx": np.full((Pn, w), -1, dtype=np.int32),
                 "recv_pos": np.full((Pn, w), halo_cap, dtype=np.int32),
                 "width": w}
            by_shift[s] = r
            new_shifts += 1
        elif gmax > r["width"]:
            # Grow by doubling; unaffected rows are value-unchanged, so
            # copy them verbatim into the wider arrays.
            w = _grow_cap(r["width"], gmax, plan.pad_mult)
            ns = np.full((Pn, w), -1, dtype=np.int32)
            nr = np.full((Pn, w), halo_cap, dtype=np.int32)
            ns[:, : r["width"]] = r["send_idx"]
            nr[:, : r["width"]] = r["recv_pos"]
            r["send_idx"], r["recv_pos"], r["width"] = ns, nr, w
            widths_grew = True
        # Clear + account every affected pair of this round (send row p and
        # recv row q belong exclusively to pair (p -> q=(p+s)%P)), then
        # scatter the recomputed rows of the pairs that carry traffic.
        ps = np.unique(np.array(
            [(q - s) % Pn for q in dirty] + movres, dtype=np.int64))
        total -= int((r["send_idx"][ps] >= 0).sum())
        r["send_idx"][ps] = -1
        r["recv_pos"][(ps + s) % Pn] = halo_cap
        for p, a, b in glist:
            k = b - a
            r["send_idx"][p, :k] = loc_idx[hv[a:b]]
            r["recv_pos"][(p + s) % Pn, :k] = pos[a:b]
            total += k
    plan.rounds = [by_shift[s] for s in sorted(by_shift)]
    plan.halo_bytes_ppermute = total
    return widths_grew, new_shifts


# ------------------------------------------------------------- replication
def _normalize_replication(replication, n: int) -> Optional[dict]:
    """Canonical replication request: ``{part: sorted unique int64 ids}``
    with out-of-range ids dropped and empty parts removed; ``None`` when
    nothing remains.  Accepts a core.cost.Replication (its ``by_part``),
    a plain dict, or None."""
    if replication is None:
        return None
    by_part = getattr(replication, "by_part", replication)
    out = {}
    for p, ids in by_part.items():
        ids = np.unique(np.asarray(ids, dtype=np.int64))
        ids = ids[(ids >= 0) & (ids < n)]
        if len(ids):
            out[int(p)] = ids
    return out or None


def _replica_rows(replication: Optional[dict], assign: np.ndarray,
                  parts) -> dict:
    """Materialized replica row per part: the request minus ids currently
    HOMED on the part (a resident needs no copy — but the request keeps the
    id, so a later move away re-materializes it)."""
    out = {}
    for p in parts:
        ids = (replication or {}).get(int(p))
        if ids is None:
            out[int(p)] = np.zeros(0, dtype=np.int64)
        else:
            out[int(p)] = ids[assign[ids] != p]
    return out


def _derive_rounds0(plan: ShardPlan) -> None:
    """Layer-0 ppermute schedule: the full ``rounds`` with every send whose
    landing halo slot is replica-resident pruned (send -1 / recv dump slot).

    A pure function of (rounds, halo, replica) recomputed wholesale after
    every compile/patch — so the patch-vs-fresh-compile bit-identity of
    those tables carries over to ``rounds0`` for free.  Shifts and widths
    mirror ``rounds`` exactly: a value-only patch keeps the jitted
    forward's signature, replica hits only blank out payload rows."""
    if not plan.has_replicas:
        plan.replica_halo_mask = None
        plan.rounds0 = plan.rounds
        plan.halo_bytes_ppermute0 = plan.halo_bytes_ppermute
        return
    Pn, halo_cap = plan.num_parts, plan.halo_cap
    mask = np.zeros((Pn, halo_cap + 1), dtype=bool)   # col halo_cap: pad slot
    for p in range(Pn):
        ids = plan.replica[p]
        ids = ids[ids >= 0]
        hp = plan.halo[p]
        cnt = int((hp >= 0).sum())
        if len(ids) and cnt:
            # Replicas that are ALSO halo members shrink the exchange;
            # serving-only replicas (outside the halo) simply don't match.
            k = np.searchsorted(hp[:cnt], ids)
            k = np.minimum(k, cnt - 1)
            mask[p, k[hp[k] == ids]] = True
    plan.replica_halo_mask = mask[:, :halo_cap]
    rounds0, total0 = [], 0
    for r in plan.rounds:
        q_of = (np.arange(Pn) + r["shift"]) % Pn      # receiver of each sender
        hit = mask[np.arange(Pn)[:, None], r["recv_pos"]]   # by receiver row
        send0 = np.where(hit[q_of], np.int32(-1), r["send_idx"])
        recv0 = np.where(hit, np.int32(halo_cap), r["recv_pos"])
        total0 += int((send0 >= 0).sum())
        rounds0.append({"shift": r["shift"], "send_idx": send0,
                        "recv_pos": recv0, "width": r["width"]})
    plan.rounds0 = rounds0
    plan.halo_bytes_ppermute0 = total0


def scatter_replica_halo(plan: ShardPlan, features: np.ndarray) -> np.ndarray:
    """(n, d) -> (P, halo_cap, d): each device's halo buffer pre-filled with
    its replica-resident rows (raw input features), zeros elsewhere — the
    layer-0 ``replica0`` operand of :func:`make_bsp_forward`."""
    features = np.asarray(features)
    d = features.shape[1] if features.ndim > 1 else 1
    out = np.zeros((plan.num_parts, plan.halo_cap, d), dtype=features.dtype)
    if plan.has_replicas and plan.replica_halo_mask is not None:
        m = plan.replica_halo_mask
        out[m] = features.reshape(len(features), d)[plan.halo[m]]
    return out


def set_replication(plan: ShardPlan, replication) -> PlanDelta:
    """Install (or clear, with None) the plan's replication request IN
    PLACE: re-materializes the replica table at the current assignment,
    re-derives the layer-0 schedule, bumps the version.  Growing ``r_cap``
    (or toggling replicas on/off) changes the forward's signature — one
    retrace; re-installing within capacity is value-only."""
    req = _normalize_replication(replication, plan.n)
    plan.replication = req
    Pn = plan.num_parts
    grew = ()
    if req is None:
        if plan.r_cap:
            grew = ("r_cap",)
        plan.r_cap = 0
        plan.replica = np.full((Pn, 0), -1, dtype=np.int64)
    else:
        rows = _replica_rows(req, plan.assign, range(Pn))
        need = max((len(r) for r in rows.values()), default=0)
        r_cap = plan.r_cap
        if need > r_cap:
            r_cap = (_grow_cap(r_cap, need, plan.pad_mult) if r_cap
                     else _slack_cap(need, plan.slack, plan.pad_mult))
            grew = ("r_cap",)
        plan.r_cap = r_cap
        replica = np.full((Pn, r_cap), -1, dtype=np.int64)
        for p in range(Pn):
            replica[p, : len(rows[p])] = rows[p]
        plan.replica = replica
    _derive_rounds0(plan)
    plan.version += 1
    return PlanDelta(
        moved=np.zeros(0, dtype=np.int64), new_vertices=0,
        dirty_parts=np.arange(Pn, dtype=np.int64), patched=True, grew=grew)


def _compile_from_assign(
    graph: DataGraph, assign: np.ndarray, num_parts: int,
    pad_mult: int = 8, slack: float = 0.0, caps: Optional[PlanCaps] = None,
    grow: bool = False, replication=None,
) -> ShardPlan:
    """Full host-side plan compilation (numpy only, no device state).

    With ``caps`` the capacities (and the ppermute schedule) are pinned, so
    the result is shape-compatible with — and for the same assignment
    bit-identical to — the plan the caps were read from.  Construction is
    deterministic throughout: members degree-ordered with id tie-breaks,
    halos ascending by id, arcs in doubled-edge order."""
    assign = np.asarray(assign, dtype=np.int64)
    Pn, n = num_parts, graph.n

    members = _part_members(graph, assign, Pn)
    sizes = np.array([len(members[p]) for p in range(Pn)], dtype=np.int64)
    max_size = int(sizes.max()) if Pn else 1
    if caps is not None:
        if max_size > caps.cap and not grow:
            raise ValueError(f"pinned cap {caps.cap} < needed {max_size}")
        cap = _grow_cap(caps.cap, max_size, pad_mult)
    else:
        cap = _slack_cap(max_size, slack, pad_mult)

    halos = halos_of(graph, assign, Pn)
    max_halo = max((len(halos[p]) for p in range(Pn)), default=1)
    if caps is not None:
        if max_halo > caps.halo_cap and not grow:
            raise ValueError(
                f"pinned halo_cap {caps.halo_cap} < needed {max_halo}")
        halo_cap = _grow_cap(caps.halo_cap, max_halo, pad_mult)
    else:
        halo_cap = _slack_cap(max_halo, slack, pad_mult)
    _check_int32(cap, halo_cap)

    # Global slot ids are p * cap + k: int64 by construction (P * cap
    # overflows int32 at production scale — satellite audit pin).
    local = np.full((Pn, cap), -1, dtype=np.int64)
    slot_of = np.full(n, -1, dtype=np.int64)
    deg_all = graph.degrees.astype(np.float32)
    deg = np.zeros((Pn, cap), dtype=np.float32)
    for p in range(Pn):
        vs = members[p]
        local[p, : len(vs)] = vs
        slot_of[vs] = p * cap + np.arange(len(vs), dtype=np.int64)
        deg[p, : len(vs)] = deg_all[vs]
    local_mask = local >= 0
    loc_idx = slot_of - assign * cap

    halo = np.full((Pn, halo_cap), -1, dtype=np.int64)
    halo_slot = np.full((Pn, halo_cap), Pn * cap, dtype=np.int64)
    for p in range(Pn):
        hs = halos[p]
        halo[p, : len(hs)] = hs
        halo_slot[p, : len(hs)] = slot_of[hs]

    rows, counts = _edge_tables(graph, assign, loc_idx, halos,
                                range(Pn), cap, halo_cap, Pn)
    max_e = max(counts.values(), default=0)
    if caps is not None:
        if max_e > caps.e_cap and not grow:
            raise ValueError(f"pinned e_cap {caps.e_cap} < needed {max_e}")
        e_cap = _grow_cap(caps.e_cap, max_e, pad_mult)
    else:
        e_cap = _slack_cap(max_e, slack, pad_mult)
    edges_src = np.full((Pn, e_cap), cap + halo_cap, dtype=np.int32)
    edges_dst = np.full((Pn, e_cap), cap, dtype=np.int32)
    for p in range(Pn):
        s_row, d_row, cnt = rows[p]
        edges_src[p, :cnt] = s_row
        edges_dst[p, :cnt] = d_row

    keep = caps.round_widths if caps is not None else None
    rounds, total_rows, _w, _grew, _new = _build_rounds(
        assign, halos, loc_idx, Pn, halo_cap, pad_mult, slack,
        keep_widths=keep)

    repl = _normalize_replication(replication, n)
    if repl is not None:
        rows_r = _replica_rows(repl, assign, range(Pn))
        max_r = max((len(r) for r in rows_r.values()), default=0)
        if caps is not None:
            if max_r > caps.r_cap and not grow:
                raise ValueError(
                    f"pinned r_cap {caps.r_cap} < needed {max_r}")
            # A pinned r_cap that fits is kept EXACTLY (0 is a legit pinned
            # value _grow_cap can't reproduce).
            r_cap = (caps.r_cap if max_r <= caps.r_cap
                     else _grow_cap(caps.r_cap, max_r, pad_mult))
        else:
            r_cap = _slack_cap(max_r, slack, pad_mult)
    else:
        r_cap = caps.r_cap if caps is not None else 0
    replica = np.full((Pn, r_cap), -1, dtype=np.int64)
    if repl is not None:
        for p in range(Pn):
            replica[p, : len(rows_r[p])] = rows_r[p]

    plan = ShardPlan(
        num_parts=Pn, cap=cap, halo_cap=halo_cap, e_cap=e_cap,
        local=local, local_mask=local_mask, slot_of=slot_of,
        halo=halo, halo_slot=halo_slot,
        edges_src=edges_src, edges_dst=edges_dst, deg=deg,
        rounds=rounds,
        halo_bytes_ppermute=total_rows,
        halo_rows_allgather=Pn * cap * max(Pn - 1, 0),
        assign=assign.copy(), pad_mult=pad_mult, slack=slack,
        replication=repl, r_cap=r_cap, replica=replica,
    )
    _derive_rounds0(plan)
    return plan


def compile_plan(
    graph: DataGraph, part: DevicePartition, pad_mult: int = 8,
    slack: float = 0.0, caps: Optional[PlanCaps] = None,
    replication=None,
) -> ShardPlan:
    """Host-side plan compilation from a DevicePartition.

    ``slack`` reserves fractional capacity headroom on every padded axis so
    later :func:`patch_plan` calls stay shape-stable (no retrace); ``caps``
    pins capacities outright (the patch oracle / growth path).
    ``replication`` seeds the plan's replica table — defaults to the
    partition's attached move-vs-replicate overlay (``part.replication``
    from a ``glad_s(..., replicate=True)`` solve) when present."""
    if replication is None:
        replication = getattr(part, "replication", None)
    return _compile_from_assign(graph, part.assign, part.num_parts,
                                pad_mult=pad_mult, slack=slack, caps=caps,
                                replication=replication)


def plan_caps(plan: ShardPlan) -> PlanCaps:
    """The plan's current capacities, pinnable into a fresh compile."""
    return PlanCaps(
        cap=plan.cap, halo_cap=plan.halo_cap, e_cap=plan.e_cap,
        round_widths={r["shift"]: r["width"] for r in plan.rounds},
        bsr_max_blocks=None if plan.bsr is None else plan.bsr.max_blocks,
        r_cap=plan.r_cap,
    )


def recompile_like(plan: ShardPlan, graph: DataGraph,
                   assign: np.ndarray) -> ShardPlan:
    """From-scratch compile at ``plan``'s capacities (the patch oracle):
    a correct :func:`patch_plan` leaves ``plan`` array-identical to this."""
    caps = plan_caps(plan)
    fresh = _compile_from_assign(graph, assign, plan.num_parts,
                                 pad_mult=plan.pad_mult, slack=plan.slack,
                                 caps=caps, replication=plan.replication)
    if plan.bsr is not None:
        build_plan_bsr(fresh, bm=plan.bsr.bm, bk=plan.bsr.bk,
                       max_blocks=plan.bsr.max_blocks)
    return fresh


def plans_equal(a: ShardPlan, b: ShardPlan) -> list:
    """Array-level comparison; returns the list of differing fields."""
    bad = []
    for f in ("num_parts", "cap", "halo_cap", "e_cap",
              "halo_bytes_ppermute", "halo_rows_allgather",
              "r_cap", "halo_bytes_ppermute0"):
        if getattr(a, f) != getattr(b, f):
            bad.append(f)
    for f in ("local", "local_mask", "slot_of", "halo", "halo_slot",
              "edges_src", "edges_dst", "deg", "assign",
              "replica", "replica_halo_mask"):
        if not np.array_equal(getattr(a, f) if getattr(a, f) is not None
                              else np.zeros(0),
                              getattr(b, f) if getattr(b, f) is not None
                              else np.zeros(0)):
            bad.append(f)
    for name, ga, gb in (("rounds", a.rounds, b.rounds),
                         ("rounds0", a.rounds0 or (), b.rounds0 or ())):
        if len(ga) != len(gb):
            bad.append(f"{name}(len)")
            continue
        for ra, rb in zip(ga, gb):
            if (ra["shift"] != rb["shift"] or ra["width"] != rb["width"]
                    or not np.array_equal(ra["send_idx"], rb["send_idx"])
                    or not np.array_equal(ra["recv_pos"], rb["recv_pos"])):
                bad.append(f"{name}(shift={ra['shift']})")
    if (a.bsr is None) != (b.bsr is None):
        bad.append("bsr(presence)")
    elif a.bsr is not None:
        for f in ("bm", "bk", "nb", "max_blocks", "src_rows"):
            if getattr(a.bsr, f) != getattr(b.bsr, f):
                bad.append(f"bsr.{f}")
        for f in ("values", "block_cols"):
            if not np.array_equal(getattr(a.bsr, f), getattr(b.bsr, f)):
                bad.append(f"bsr.{f}")
    return bad


# ------------------------------------------------------------- incremental
def patch_plan(
    plan: ShardPlan,
    graph: DataGraph,
    new_assign: np.ndarray,
    dirty_vertices: Optional[np.ndarray] = None,
) -> PlanDelta:
    """Patch ``plan`` in place for a new assignment (and/or evolved graph).

    Only the dirty partitions — those that gained/lost members, or host a
    neighbor of a moved/structurally-changed vertex — rebuild their
    local/halo/edge tables (and BSR rows); ``halo_slot`` is refreshed
    globally (values only, O(P * halo_cap)) because re-slotting a partition
    shifts the global slot ids other partitions' halos reference.  The
    ppermute schedule is rebuilt with pinned shifts/widths so the jitted
    forward keeps its signature.

    ``dirty_vertices``: vertices whose incident structure changed (new /
    removed links, fresh insertions) — pass the endpoints of a
    ``GraphDelta`` when the graph itself evolved.  Vertex DELETIONS keep
    their id slot but implicitly remove every incident arc, and those
    arcs are invisible in the new edge set — so pass the deleted
    vertices' PRE-DELTA neighborhoods (``old_graph.neighbors(v)``) too,
    or the parts that lose the deleted vertex from halos/edge tables are
    never marked dirty.  Assignment-only relayouts can omit it; movers
    are derived from the assignment diff.

    Any capacity overflow falls back to a full rebuild at grown
    (doubled) capacities — flagged in the returned :class:`PlanDelta`,
    whose ``retrace_expected`` says whether the next forward recompiles.
    """
    Pn = plan.num_parts
    new_assign = np.asarray(new_assign, dtype=np.int64)
    if len(new_assign) != graph.n:
        raise ValueError(f"assign has {len(new_assign)} entries for "
                         f"{graph.n} vertices")
    if len(new_assign) and (new_assign.min() < 0 or new_assign.max() >= Pn):
        raise ValueError("assignment targets outside [0, num_parts)")
    n_old = plan.n
    if graph.n < n_old:
        # Vertex deletions renumber the universe — no incremental mapping.
        return _rebuild(plan, graph, new_assign, grew=("universe",))

    moved = np.flatnonzero(new_assign[:n_old] != plan.assign)
    new_vertices = graph.n - n_old
    dirty = [moved, np.arange(n_old, graph.n, dtype=np.int64)]
    if dirty_vertices is not None and len(dirty_vertices):
        dv = np.asarray(dirty_vertices, dtype=np.int64)
        dirty.append(dv[dv < graph.n])
    dv = np.unique(np.concatenate(dirty))
    if len(dv) == 0:
        plan.assign = new_assign.copy()
        return PlanDelta(moved=moved, new_vertices=0,
                         dirty_parts=np.zeros(0, np.int64), patched=True)

    # Dirty partitions: old/new homes of the dirty vertices plus every
    # partition hosting one of their (current) neighbors — those see halo
    # membership and boundary-coordinate changes.
    dmask = np.zeros(graph.n, dtype=bool)
    dmask[dv] = True
    plist = [plan.assign[dv[dv < n_old]], new_assign[dv]]
    e = graph.edges
    if len(e):
        em = dmask[e[:, 0]] | dmask[e[:, 1]]
        plist += [new_assign[e[em, 0]], new_assign[e[em, 1]]]
    D = np.unique(np.concatenate(plist))

    # ---- growth checks (grow-by-doubling on any overflow -> full rebuild)
    grew = []
    sizes = np.bincount(new_assign, minlength=Pn)
    cap = plan.cap
    if sizes.max() > cap:
        grew.append("cap")
    halosD = halos_of(graph, new_assign, Pn, parts=D)
    max_halo = max((len(h) for h in halosD.values()), default=0)
    if max_halo > plan.halo_cap:
        grew.append("halo_cap")
    if grew:
        return _rebuild(plan, graph, new_assign, grew=tuple(grew))

    members = _part_members(graph, new_assign, Pn, parts=D)
    deg_all = graph.degrees.astype(np.float32)
    if graph.n > n_old:
        slot_of = np.full(graph.n, -1, dtype=np.int64)
        slot_of[:n_old] = plan.slot_of
        plan.slot_of = slot_of
    resized = []                         # parts whose slotting changed
    halo_changed = []                    # parts whose halo set changed
    for p in D:
        vs = members[int(p)]
        old_row = plan.local[p].copy()
        plan.local[p] = -1
        plan.local[p, : len(vs)] = vs
        if not np.array_equal(old_row, plan.local[p]):
            resized.append(int(p))
        plan.deg[p] = 0.0
        plan.deg[p, : len(vs)] = deg_all[vs]
        plan.slot_of[vs] = p * cap + np.arange(len(vs), dtype=np.int64)
        old_halo = plan.halo[p].copy()
        plan.halo[p] = -1
        hs = halosD[int(p)]
        plan.halo[p, : len(hs)] = hs
        if not np.array_equal(old_halo, plan.halo[p]):
            halo_changed.append(int(p))
    plan.local_mask = plan.local >= 0
    loc_idx = plan.slot_of - new_assign * cap
    # Movers' old/new homes: their selection inside STABLE halos flipped,
    # so their send rows must be recomputed toward every receiver.
    mover_parts = np.unique(np.concatenate(
        [plan.assign[moved], new_assign[moved]])) if len(moved) else []

    # Global slot ids shifted for every member of a re-slotted partition;
    # refresh halo_slot everywhere (values only — cheap, shape-stable).
    valid = plan.halo >= 0
    plan.halo_slot[...] = Pn * cap
    plan.halo_slot[valid] = plan.slot_of[plan.halo[valid]]

    halos_all = {p: (halosD[int(p)] if int(p) in halosD
                     else plan.halo[p][plan.halo[p] >= 0])
                 for p in range(Pn)}
    rows, counts = _edge_tables(graph, new_assign, loc_idx, halos_all,
                                D, cap, plan.halo_cap, Pn)
    if max(counts.values(), default=0) > plan.e_cap:
        # Roll back nothing: the tables written above are re-derived by the
        # full rebuild from (graph, new_assign) — plan state is overwritten.
        return _rebuild(plan, graph, new_assign, grew=("e_cap",))
    for p in D:
        s_row, d_row, cnt = rows[int(p)]
        plan.edges_src[p] = cap + plan.halo_cap
        plan.edges_dst[p] = cap
        plan.edges_src[p, :cnt] = s_row
        plan.edges_dst[p, :cnt] = d_row

    # Replica rows: part p's materialization (request minus homed ids)
    # changes only when a replicated vertex moves to or from p — both homes
    # are in D, so refreshing the dirty parts covers every changed row.
    if plan.has_replicas:
        rrows = _replica_rows(plan.replication, new_assign, D)
        if max((len(r) for r in rrows.values()), default=0) > plan.r_cap:
            return _rebuild(plan, graph, new_assign, grew=("r_cap",))
        for p in D:
            plan.replica[p] = -1
            plan.replica[p, : len(rrows[int(p)])] = rrows[int(p)]

    widths_grew, new_shifts = _patch_rounds(
        plan, new_assign, halos_all, loc_idx, halo_changed, mover_parts,
        resized)
    _derive_rounds0(plan)
    plan.assign = new_assign.copy()
    plan.version += 1

    delta = PlanDelta(
        moved=moved, new_vertices=new_vertices, dirty_parts=D, patched=True,
        grew=("round_width",) if widths_grew else (),
        rounds_added=new_shifts)
    if plan.bsr is not None:
        _patch_plan_bsr(plan, D, delta)
    return delta


def _rebuild(plan: ShardPlan, graph: DataGraph,
             new_assign: np.ndarray, grew: tuple) -> PlanDelta:
    """Full recompile at grown (doubled-as-needed) capacities, written into
    ``plan`` in place so callers holding the plan object see the update.

    The old universe size is ``len(plan.assign)``: :func:`patch_plan` may
    already have grown ``plan.slot_of`` (and with it ``plan.n``) to the new
    graph before an ``e_cap`` or ``r_cap`` overflow sends it here."""
    n_old = len(plan.assign)
    moved = (np.flatnonzero(new_assign[:n_old] != plan.assign)
             if graph.n >= n_old else np.arange(graph.n, dtype=np.int64))
    # Existing capacities become minimums (grow-by-doubling past them) and
    # the collective schedule persists: pinned shifts stay, widths re-grow
    # inside _build_rounds if they must.
    caps = PlanCaps(
        cap=plan.cap, halo_cap=plan.halo_cap, e_cap=plan.e_cap,
        round_widths={r["shift"]: r["width"] for r in plan.rounds},
        r_cap=plan.r_cap,
    )
    if "universe" in grew:
        caps = None                      # renumbered graph: clean slate
    bsr = plan.bsr
    fresh = _compile_from_assign(graph, new_assign, plan.num_parts,
                                 pad_mult=plan.pad_mult, slack=plan.slack,
                                 caps=caps, grow=True,
                                 replication=plan.replication)
    grew = tuple(grew) + tuple(
        f for f in ("cap", "halo_cap", "e_cap", "r_cap")
        if getattr(fresh, f) != getattr(plan, f) and f not in grew)
    version = plan.version + 1
    plan.__dict__.update(fresh.__dict__)
    plan.version = version
    if bsr is not None:
        build_plan_bsr(plan, bm=bsr.bm, bk=bsr.bk)
    return PlanDelta(
        moved=moved, new_vertices=max(graph.n - n_old, 0),
        dirty_parts=np.arange(plan.num_parts, dtype=np.int64),
        patched=False, grew=grew)


# --------------------------------------------------------- block-sparse tiling
def _device_block_rows(edges_src_row: np.ndarray, edges_dst_row: np.ndarray,
                       cap: int, bm: int, bk: int, nb: int) -> list:
    """One device's edge table -> per-dst-block-row [(src_block, block)].

    Deterministic: blocks keyed and emitted in (dst_block, src_block)
    lexicographic order; padded table entries (dst == cap) are dropped."""
    live = edges_dst_row < cap
    src, dst = edges_src_row[live], edges_dst_row[live]
    rows = [[] for _ in range(nb)]
    if len(src) == 0:
        return rows
    ib = dst // bm
    jb = src // bk
    order = np.lexsort((jb, ib))
    src, dst, ib, jb = src[order], dst[order], ib[order], jb[order]
    key = ib.astype(np.int64) * (1 << 32) + jb
    bounds = np.flatnonzero(np.diff(key)) + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [len(src)]])
    for a, b in zip(starts, ends):
        i, j = int(ib[a]), int(jb[a])
        blk = np.zeros((bm, bk), np.float32)
        np.add.at(blk, (dst[a:b] - i * bm, src[a:b] - j * bk), 1.0)
        rows[i].append((j, blk))
    return rows


def build_plan_bsr(plan: ShardPlan, bm: int = 8, bk: int = 128,
                   max_blocks: Optional[int] = None) -> PlanBSR:
    """Re-tile every device's edge table into the kernel's BSR layout.

    ``max_blocks`` pins the per-row block budget (patch oracle); otherwise
    it is the current max over devices padded by the plan's slack."""
    Pn, cap = plan.num_parts, plan.cap
    nb = _pad_up(cap, bm) // bm
    src_rows = _pad_up(plan.table_rows, bk)
    per_dev = [
        _device_block_rows(plan.edges_src[p], plan.edges_dst[p],
                           cap, bm, bk, nb)
        for p in range(Pn)
    ]
    need = max((len(r) for rows in per_dev for r in rows), default=0)
    if max_blocks is None:
        max_blocks = max(1, int(np.ceil(max(need, 1) * (1.0 + plan.slack))))
    elif need > max_blocks:
        raise ValueError(f"pinned max_blocks {max_blocks} < needed {need}")
    values = np.zeros((Pn, nb * max_blocks, bm, bk), np.float32)
    block_cols = np.zeros((Pn, nb, max_blocks), np.int32)
    for p in range(Pn):
        _fill_device_bsr(values[p], block_cols[p], per_dev[p], max_blocks)
    plan.bsr = PlanBSR(bm=bm, bk=bk, nb=nb, max_blocks=max_blocks,
                       src_rows=src_rows, values=values,
                       block_cols=block_cols)
    return plan.bsr


def _fill_device_bsr(values_p, block_cols_p, rows, max_blocks):
    values_p[...] = 0.0
    block_cols_p[...] = 0
    for i, row in enumerate(rows):
        for k, (j, blk) in enumerate(row):      # rows already (i, j)-sorted
            values_p[i * max_blocks + k] = blk
            block_cols_p[i, k] = j


def _patch_plan_bsr(plan: ShardPlan, dirty_parts, delta: PlanDelta) -> None:
    """Rebuild only the dirty devices' BSR rows; grow-by-doubling
    ``max_blocks`` (full re-tile + retrace) when a device overflows it."""
    bsr = plan.bsr
    per_dev = {
        int(p): _device_block_rows(plan.edges_src[p], plan.edges_dst[p],
                                   plan.cap, bsr.bm, bsr.bk, bsr.nb)
        for p in dirty_parts
    }
    need = max((len(r) for rows in per_dev.values() for r in rows), default=0)
    if need > bsr.max_blocks or _pad_up(plan.table_rows, bsr.bk) != bsr.src_rows:
        grown = bsr.max_blocks
        while grown < need:
            grown *= 2
        build_plan_bsr(plan, bm=bsr.bm, bk=bsr.bk,
                       max_blocks=max(grown, 1))
        delta.grew = delta.grew + ("bsr_max_blocks",)
        return
    for p, rows in per_dev.items():
        _fill_device_bsr(bsr.values[p], bsr.block_cols[p], rows,
                         bsr.max_blocks)


# ------------------------------------------------------------ data shuffling
def scatter_features(plan: ShardPlan, features: np.ndarray) -> np.ndarray:
    """(n, d) -> (P, cap, d) per-device blocks (zero rows on padding)."""
    features = np.asarray(features)
    d = features.shape[1] if features.ndim > 1 else 1
    out = np.zeros((plan.num_parts, plan.cap, d), dtype=features.dtype)
    valid = plan.local >= 0
    out[valid] = features.reshape(len(features), d)[plan.local[valid]]
    return out


def scatter_ints(plan: ShardPlan, values: np.ndarray, pad=0) -> np.ndarray:
    """(n,) -> (P, cap) per-device blocks; padding (and every slot of an
    empty partition) carries ``pad``."""
    out = np.full((plan.num_parts, plan.cap), pad, dtype=values.dtype)
    valid = plan.local >= 0
    if valid.any():
        out[valid] = values[plan.local[valid]]
    return out


def gather_outputs(plan: ShardPlan, blocks: np.ndarray, n: int) -> np.ndarray:
    """(P, cap, ...) -> (n, ...) inverse of scatter_features; rows of
    vertices not present in the plan (never with patch) stay zero."""
    out = np.zeros((n,) + blocks.shape[2:], dtype=blocks.dtype)
    valid = plan.local >= 0
    if valid.any():
        out[plan.local[valid]] = blocks[valid]
    return out


