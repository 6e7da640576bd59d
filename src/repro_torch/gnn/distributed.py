"""BSP GNN forward over a ShardPlan on one device (paper Sec. III-B).

The paper's execution model: each edge server hosts a vertex partition, and
one BSP round per GNN layer exchanges the features of vertices whose links
the layout cuts.  The JAX reference runs one program per TPU device under
``shard_map``.  An H100 is one device, so here the P partitions run as ONE
batched program: every per-partition table carries a leading P axis, and a
layer is a handful of batched gathers, segment sums and matmuls over all
partitions at once.

Two exchanges (both move exactly the rows the reference moves):
  * ``ppermute`` — the plan's rotation rounds as index copies: in the round
    of shift s, partition q receives sender (q - s) % P's ``send_idx`` rows
    into its halo at ``recv_pos`` (the reference's ``_exchange_ppermute``).
    On a plan with replicas, layer 0 starts each halo from ``replica0``
    (:func:`scatter_replica_halo`: the replica-resident rows' raw features)
    and runs the pruned ``rounds0``, whose pruned receives land on the dump
    row ``halo_cap``; later layers move activations, start from zeros and
    run the full ``rounds``.
  * ``allgather`` — every halo row gathered from the flat (P*cap + 1, d)
    table of all blocks by ``halo_slot``.

Two aggregation paths:
  * ``segment`` — gather messages by the edge table, deterministic segment
    sum by destination.  Every model.
  * ``bsr`` — the plan's block-sparse retiling, packed to its nonzeros
    (:func:`pack_bsr`) and aggregated by the ``spmm_csr`` kernel: ONE
    launch per layer covering all P partitions.  GCN/SAGE only; GAT's
    per-link softmax weights depend on the features, so it stays on the
    segment path.

Plan tensors stay resident on the device; the BSR's dense ``values`` stay
on the host and only its packed nonzeros, at ``plan.e_cap`` entries per
partition, go to the device, beside their transpose (the operand of K1's
backward, :func:`transpose_packed`); both are made once per plan version
and shared by every forward over the plan.  When ``plan.version`` moves
(a :func:`patch_plan` that kept every capacity) they are refreshed in place;
the forward is rebuilt, re-allocating them, only when the reference's
signature changes (a capacity grew, a ppermute round appeared, or the
ppermute forward's replicas were switched on or off).
``fwd.stats['builds']`` counts those rebuilds.  The segment path's sums
read their order from the plan tensors too (:func:`segment_order` of the
edge table's destinations), refreshed with them.

Compiled forward.  The reference jits its forward and counts its traces;
here ``fwd.stats['traces']`` counts the same, and on the card each trace
is one CUDA graph (:class:`repro_torch.step.Step`), captured at its first
call and replayed after: nothing on the path reads the device from the
host, K1 runs inside the graph, and a value-only patch rewrites the
tensors the graph reads, in place.

Gradients.  The eager forward (``fwd.eager``) is differentiable in the
parameters and the blocks, and deterministic on the card: every gather
whose indices can
repeat goes through :func:`gather_rows` (a sorted segment sum backward),
the exchange's roll transposes to the opposite roll, and K1's backward is
the kernel over the transposed operand.  The halo writes have gather-shaped
backwards; the dump row that takes a round's padded receives is sliced off,
so its duplicates get no gradient.

Tracing (:mod:`repro_torch.tracing`, off by default).  A layer marks its
phases on the device: ``exchange`` (the rounds or the allgather, with the
halo writes), ``aggregate`` (the table build and the neighbour sum; GAT:
``attention``, the projection, logits, segment max, exponentials and
denominator, then ``messages``, the weighted gather and sum) and
``dense`` (normalisation, matmul, activation); a captured step's graph
lies between its ``step`` and ``exit`` marks (:func:`call_captured`).  A
forward call is the host span ``bsp.call`` around ``plan.sync``,
``step.key``, the step's own spans and ``out.clone``, between the
call-begin and call-end marks.  Whether tracing is on keys the forward's
steps beside its input signature (``fwd.marked_steps`` beside
``fwd.steps``): turning it on captures one marked graph beside the
unmarked one, and neither ``stats['traces']`` nor ``stats['builds']``
counts it.  The exchange
counts the rows it moves in ``exchange_counts.rows`` (registered as
``exchange.rows``), whether tracing is on or not.

One partition.  The same code serves one rank of the per-process forward
(:mod:`repro_torch.gnn.ranks`): ``_PlanTensors(..., part=q)`` holds
partition q's rows of every table as P = 1 tensors, and the layer runs
unchanged on its (1, cap, d) block.  Only the exchange differs: the
``wire`` argument of :func:`_bsp_forward` moves the rounds' rows and
gathers the blocks, here by index arithmetic on one device, there by
collectives between processes.
"""
from __future__ import annotations

import functools
import weakref
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.gnn.models import (
    GNNConfig, gather_rows, param_leaves, params_from_leaves, segment_max,
    segment_order, segment_sum)
from repro_torch.gnn.plan import (
    ShardPlan, build_plan_bsr, gather_outputs, scatter_features,
    scatter_replica_halo)
from repro_torch.kernels import segment_sum as k3
from repro_torch.kernels.gnn_aggregate import (
    PackedBSR, pack_bsr, spmm_packed, transpose_packed)
from repro_torch.step import resolve_graphs, spec, step_for

EXCHANGES = ("ppermute", "allgather")

# The halo exchange's rows, counted where it runs: "copied", the rows its
# tables move (P x each round's width, summed over rounds and layers; the
# allgather P x halo_cap a layer), and "live", those that land in a halo
# row below halo_cap (the allgather's: those of real vertices).  A replay
# adds what its capture counted (repro_torch.step.Step).
exchange_counts = SimpleNamespace(rows={"copied": 0, "live": 0})
tracing.register(exchange_counts, "rows", "exchange.rows")


def resolve_aggregate(cfg: GNNConfig, aggregate: str,
                      device: DeviceLike = "cuda") -> str:
    """Aggregate-path decision:

      * 'segment' — gather + segment sum.  Every model, every device.
      * 'bsr'     — block-sparse SpMM over the plan's BSR tiling: the CUDA
        kernel on the card, its plain torch version on the CPU.  GCN/SAGE
        only; GAT resolves to 'segment'.
      * 'auto'    — 'bsr' for GCN/SAGE on CUDA, 'segment' otherwise.
    """
    if aggregate == "auto":
        return ("bsr" if torch.device(device).type == "cuda"
                and cfg.model in ("gcn", "sage") else "segment")
    if aggregate not in ("segment", "bsr"):
        raise ValueError(f"unknown aggregate {aggregate!r}")
    if aggregate == "bsr" and cfg.model == "gat":
        return "segment"
    return aggregate


# id(plan.bsr) -> (weak reference to it, (plan.version, plan.e_cap),
# (pack, its transpose)).
_PACKS: dict = {}


def _plan_pack(plan: ShardPlan):
    """The plan's BSR packed on the host at ``e_cap`` entries per partition,
    and its transpose over the ``bsr.src_rows``-row table, once per
    ``plan.version``: every forward over the plan (a GCN and a SAGE
    forward, say) shares them, so a patch costs one pack.  Nonzeros per
    partition <= live arcs <= e_cap, which is in the forward's signature: a
    value-only patch keeps both operands' shapes."""
    b, key = plan.bsr, (plan.version, plan.e_cap)
    hit = _PACKS.get(id(b))
    if hit is not None and hit[0]() is b and hit[1] == key:
        return hit[2]
    packed = pack_bsr(b.values, b.block_cols, b.bm, b.bk, nnz_cap=plan.e_cap)
    both = (packed, transpose_packed(packed, b.src_rows))
    _PACKS[id(b)] = (weakref.ref(b, lambda _, k=id(b): _PACKS.pop(k, None)),
                     key, both)
    return both


# The BSR tiling of a partition's own pack (build_plan_bsr's defaults).
PART_BM, PART_BK = 8, 128


def _part_pack(plan: ShardPlan, q: int):
    """Partition ``q``'s rows of the plan's pack and of its transpose, as
    P = 1 operands: the entries ``pack_bsr`` makes from
    ``build_plan_bsr(plan)`` for that partition (each (dst, src) pair of
    its live arcs once, weighted by its count, sources ascending within a
    row), at ``e_cap`` entries, but made from its edge table alone.  A
    rank thus never holds the dense BSR of every partition."""
    n_rows = -(-plan.cap // PART_BM) * PART_BM
    rows = -(-plan.table_rows // PART_BK) * PART_BK
    src, dst = plan.edges_src[q], plan.edges_dst[q]
    live = dst < plan.cap
    pair, count = np.unique(dst[live].astype(np.int64) * rows + src[live],
                            return_counts=True)
    row_ptr = np.zeros((1, n_rows + 1), np.int32)
    np.cumsum(np.bincount(pair // rows, minlength=n_rows),
              out=row_ptr[0, 1:])
    col = np.zeros((1, plan.e_cap), np.int32)
    w = np.zeros((1, plan.e_cap), np.float32)
    col[0, :len(pair)] = pair % rows
    w[0, :len(pair)] = count
    packed = PackedBSR(row_ptr, col, w, rows, n_rows)
    return packed, transpose_packed(packed, rows)


class _PlanTensors:
    """The plan tables the forward reads, as device tensors.

    Allocated at the plan's current shapes; :meth:`refresh` overwrites them
    in place from the host plan, so the tensors (and their addresses)
    outlive value-only patches.  With ``part=q`` they hold partition q's
    rows only, as P = 1 tables (one rank's share).  In mode 'segment' they
    also hold the order of the segment sums over the edge table's
    destinations (:func:`segment_order` of the flat ``dst``, in
    ``segments``: the order, the sorted ``dst`` and the segments'
    offsets), which the plan alone fixes, and on a card K3's library is
    loaded with them.  ``moved`` holds what a
    layer's exchange counts (:meth:`_moved`)."""

    def __init__(self, plan: ShardPlan, mode: str, exchange: str,
                 device: torch.device, part: Optional[int] = None):
        self.mode, self.exchange, self.part = mode, exchange, part
        self.replicas = _use_replicas(plan, exchange)
        self.num_parts = plan.num_parts if part is None else 1
        self.cap, self.halo_cap = plan.cap, plan.halo_cap
        self.slots = plan.num_parts * plan.cap     # halo_slot's pad value
        self.shifts = ([r["shift"] for r in plan.rounds]
                       if exchange == "ppermute" else [])
        if mode != "bsr":
            self.table_rows = plan.table_rows
        elif part is None:
            self.table_rows = plan.bsr.src_rows
        else:
            self.table_rows = -(-plan.table_rows // PART_BK) * PART_BK
        arrs = self._host(plan)
        self.moved = self._moved(arrs)
        self.t = {}
        for name, arr in arrs.items():
            dtype = (torch.float32 if arr.dtype.kind == "f"
                     else torch.int32 if name.startswith("bsr_")
                     else torch.int64)
            self.t[name] = torch.empty(arr.shape, dtype=dtype, device=device)
        self._copy(arrs)
        if mode == "bsr":
            n_rows = self.t["bsr_row_ptr"].shape[1] - 1
            self.packed = PackedBSR(
                self.t["bsr_row_ptr"], self.t["bsr_col"], self.t["bsr_w"],
                src_rows=self.table_rows, n_rows=n_rows)
            self.packed_t = PackedBSR(
                self.t["bsr_t_row_ptr"], self.t["bsr_t_col"],
                self.t["bsr_t_w"], src_rows=n_rows, n_rows=self.table_rows)
        self.segments = None
        if mode == "segment":
            self.segments = tuple(self.t[k] for k in (
                "seg_order", "seg_keys", "seg_offsets"))
            if device.type == "cuda":
                k3.load()          # K3's library, outside any capture

    def _host(self, plan: ShardPlan) -> dict:
        q = (slice(None) if self.part is None
             else slice(self.part, self.part + 1))
        arrs = {"edges_src": plan.edges_src[q], "edges_dst": plan.edges_dst[q],
                "deg": plan.deg[q], "halo_slot": plan.halo_slot[q]}
        if self.mode == "segment":
            ed = arrs["edges_dst"].astype(np.int64)
            dst = ed + np.arange(len(ed))[:, None] * (self.cap + 1)
            arrs["seg_order"], arrs["seg_keys"], arrs["seg_offsets"] = (
                segment_order(dst, len(ed) * (self.cap + 1)))
        if self.mode == "bsr":
            packs = (_plan_pack(plan) if self.part is None
                     else _part_pack(plan, self.part))
            for pre, packed in zip(("bsr_", "bsr_t_"), packs):
                arrs[pre + "row_ptr"] = packed.row_ptr
                arrs[pre + "col"] = packed.col
                arrs[pre + "w"] = packed.w
        for k, r in enumerate(plan.rounds if self.exchange == "ppermute"
                              else ()):
            arrs[f"send_flat{k}"] = self._send_flat(r["send_idx"][q])
            arrs[f"recv_pos{k}"] = r["recv_pos"][q]
        for k, r in enumerate(plan.rounds0 if self.replicas else ()):
            arrs[f"send_flat0_{k}"] = self._send_flat(r["send_idx"][q])
            arrs[f"recv_pos0_{k}"] = r["recv_pos"][q]
        return arrs

    def _send_flat(self, send_idx: np.ndarray) -> np.ndarray:
        """A round's ``send_idx`` as rows of the flat (P * (cap + 1), d)
        send table; padding (-1) reads each partition's zero row ``cap``."""
        cap = self.cap
        part = np.arange(self.num_parts)[:, None] * (cap + 1)
        return np.where(send_idx < 0, cap, send_idx) + part

    def _copy(self, arrs: dict) -> None:
        for name, arr in arrs.items():
            self.t[name].copy_(torch.from_numpy(np.ascontiguousarray(arr)))

    def _moved(self, arrs: dict) -> dict:
        """(rows copied, live rows among them) of one layer's exchange, by
        the tables it runs: ``rounds``, ``rounds0`` (layer 0 over
        replicas), ``allgather``."""
        if self.exchange == "allgather":
            slot = arrs["halo_slot"]
            return {"allgather": (int(slot.size), int(np.count_nonzero(
                slot < self.slots)))}
        out = {}
        for name, send, recv in (("rounds", "send_flat{}", "recv_pos{}"),
                                 ("rounds0", "send_flat0_{}",
                                  "recv_pos0_{}")):
            ks = [k for k in range(len(self.shifts))
                  if send.format(k) in arrs]
            out[name] = (
                sum(int(arrs[send.format(k)].size) for k in ks),
                sum(int(np.count_nonzero(arrs[recv.format(k)]
                                         < self.halo_cap)) for k in ks))
        return out

    def refresh(self, plan: ShardPlan) -> None:
        arrs = self._host(plan)
        self._copy(arrs)
        self.moved = self._moved(arrs)


class _OneDevice:
    """The batched program's wire: every partition is on this device."""

    @staticmethod
    def shift(send: torch.Tensor, s: int) -> torch.Tensor:
        """(P, w, d) rows, partition q's sent to (q + s) % P."""
        return torch.roll(send, shifts=s, dims=0)

    @staticmethod
    def blocks(h: torch.Tensor) -> torch.Tensor:
        """Every partition's (cap, d) block, (P, cap, d)."""
        return h


def _exchange_allgather(h: torch.Tensor, halo_slot: torch.Tensor,
                        wire=_OneDevice):
    """Naive exchange: every block everywhere, halo rows picked by slot.
    Its adjoint sums each vertex's halo copies into its owner's row."""
    blocks = wire.blocks(h)
    P, cap, d = blocks.shape
    flat = torch.cat([blocks.reshape(P * cap, d), h.new_zeros((1, d))])
    slot = halo_slot.clamp(max=P * cap)
    return gather_rows(flat, slot.reshape(-1)).reshape(
        *slot.shape, d)                                     # (P, halo_cap, d)


def _exchange_ppermute(h: torch.Tensor, ops: _PlanTensors, init=None,
                       wire=_OneDevice):
    """Move exactly the cut-link rows (the paper's C_T) round by round.

    ``init``: the layer-0 replica halo, (P, halo_cap + 1, d) with the dump
    row last, written in place; with it the exchange runs the pruned
    ``rounds0`` tables."""
    P, cap, d = h.shape
    rows = torch.arange(P, device=h.device)[:, None]
    table = torch.cat([h, h.new_zeros((P, 1, d))], dim=1)    # row cap = 0
    table = table.reshape(P * (cap + 1), d)
    if init is None:
        halo = h.new_zeros((P, ops.halo_cap + 1, d))     # row halo_cap: dump
        send_k, recv_k = "send_flat{}", "recv_pos{}"
    else:
        halo = init
        send_k, recv_k = "send_flat0_{}", "recv_pos0_{}"
    for k, shift in enumerate(ops.shifts):
        send_flat = ops.t[send_k.format(k)]
        send = gather_rows(table, send_flat.reshape(-1)).reshape(
            *send_flat.shape, d)
        got = wire.shift(send, shift)                        # q <- (q - s) % P
        halo[rows, ops.t[recv_k.format(k)]] = got
    return halo[:, : ops.halo_cap]


def _device_layer(cfg: GNNConfig, p, h, halo, ops: _PlanTensors, idx, last):
    """One GNN layer on all partitions: (P, cap, d) -> (P, cap, d').

    Mirrors the reference's per-device ``_device_layer``: aggregation over
    each partition's edge table in table coordinates ([local; halo; zero
    row]; padded arcs read the zero row and land in the dummy cap-th
    segment), or over the plan's BSR retiling of the same table."""
    P, cap, d = h.shape
    halo_cap, rows = ops.halo_cap, ops.table_rows
    tracing.mark("attention" if cfg.model == "gat" else "aggregate",
                 h.device)
    table = h.new_zeros((P, rows, d))
    table[:, :cap] = h
    table[:, cap:cap + halo_cap] = halo
    nseg = P * (cap + 1)

    def dst_sum(msgs):
        return segment_sum(msgs, idx["dst_flat"], nseg, ops.segments)

    def neighbour_sum(x_flat):
        msgs = gather_rows(x_flat, idx["src_flat"])
        return dst_sum(msgs).reshape(P, cap + 1, -1)[:, :cap]

    if cfg.model in ("gcn", "sage"):
        if ops.mode == "bsr":
            agg = spmm_packed(ops.packed, table, ops.packed_t)[:, :cap]
        else:
            agg = neighbour_sum(table.reshape(P * rows, d))
        tracing.mark("dense", h.device)
        deg = ops.t["deg"]
        if cfg.model == "gcn":
            out = ((agg + h) / (deg[..., None] + 1.0)) @ p["w"]
        else:
            agg = agg / torch.clamp(deg, min=1.0)[..., None]
            out = torch.cat([agg, h], dim=-1) @ p["w"]
    elif cfg.model == "gat":
        ed = ops.t["edges_dst"]
        wh = table @ p["w"]                                   # (P, rows, d')
        a_dst = wh[:, :cap] @ p["att_src"]                    # local dsts only
        a_src = wh @ p["att_dst"]

        def per_arc(x, flat):                  # (P, rows) by a flat index
            return gather_rows(x.reshape(-1), idx[flat]).reshape(ed.shape)

        logits = F.leaky_relu(per_arc(a_dst, "dst_mod_flat")
                              + per_arc(a_src, "src_flat"), 0.2)
        pad = ed >= cap
        logits = logits.masked_fill(pad, float("-inf"))
        self_logit = F.leaky_relu(a_dst + wh[:, :cap] @ p["att_dst"], 0.2)
        seg_max = segment_max(logits.reshape(-1), idx["dst_flat"],
                              nseg).reshape(P, cap + 1)[:, :cap]
        seg_max = torch.maximum(
            torch.where(torch.isfinite(seg_max), seg_max, float("-inf")),
            self_logit)
        ex = torch.where(pad, 0.0,
                         torch.exp(logits - per_arc(seg_max, "dst_mod_flat")))
        ex_self = torch.exp(self_logit - seg_max)
        ex_flat = ex.reshape(-1, 1)
        denom = dst_sum(ex_flat).reshape(P, cap + 1)[:, :cap] + ex_self
        tracing.mark("messages", h.device)
        wh_flat = wh.reshape(P * rows, -1)
        msgs = ex_flat * gather_rows(wh_flat, idx["src_flat"])
        num = dst_sum(msgs).reshape(P, cap + 1, -1)[:, :cap]
        num = num + ex_self[..., None] * wh[:, :cap]
        tracing.mark("dense", h.device)
        out = num / torch.clamp(denom, min=1e-16)[..., None]
    else:
        raise ValueError(cfg.model)
    return out if last else torch.relu(out)


def _bsp_forward(cfg, params, h, ops: _PlanTensors, halo0=None,
                 wire=_OneDevice):
    P, cap = ops.num_parts, ops.cap
    part = torch.arange(P, device=h.device)[:, None]
    ed = ops.t["edges_dst"]
    idx = {"src_flat": (ops.t["edges_src"] + part * ops.table_rows).reshape(-1),
           "dst_flat": (ed + part * (cap + 1)).reshape(-1)}
    if cfg.model == "gat":         # padded arcs (ed = cap) read local row 0
        idx["dst_mod_flat"] = (ed % cap + part * cap).reshape(-1)
    for k, p in enumerate(params):
        tracing.mark("exchange", h.device)
        if ops.exchange == "ppermute":
            init = halo0 if k == 0 else None
            halo = _exchange_ppermute(h, ops, init, wire)
            table = "rounds" if init is None else "rounds0"
        else:
            halo = _exchange_allgather(h, ops.t["halo_slot"], wire)
            table = "allgather"
        copied, live = ops.moved[table]
        exchange_counts.rows["copied"] += copied
        exchange_counts.rows["live"] += live
        h = _device_layer(cfg, p, h, halo, ops, idx, k == len(params) - 1)
    return h


def _use_replicas(plan: ShardPlan, exchange: str) -> bool:
    return exchange == "ppermute" and plan.has_replicas


def _signature(plan: ShardPlan, exchange: str, mode: str,
               part: Optional[int] = None) -> tuple:
    """What fixes the resident tensors' shapes: a change rebuilds them."""
    sig = (plan.cap, plan.halo_cap, plan.e_cap)
    if exchange == "ppermute":
        sig += (tuple(r["shift"] for r in plan.rounds),
                tuple(r["width"] for r in plan.rounds))
    if _use_replicas(plan, exchange):
        # rounds0 mirrors rounds' shifts and widths: one flag suffices.
        sig += ("repl",)
    if mode == "bsr" and part is None:
        # A partition's own pack (part=q) is fixed by cap, halo_cap, e_cap.
        b = plan.bsr
        sig += (b.bm, b.bk, b.max_blocks, b.src_rows)
    return sig


def _sync_ops(state: dict, plan: ShardPlan, mode: str, exchange: str,
              device: torch.device, part: Optional[int] = None) -> None:
    """Bring ``state['ops']`` up to the plan: rebuilt (``builds`` + 1)
    when its signature changed, refreshed in place when only its version
    moved."""
    sig = _signature(plan, exchange, mode, part)
    if sig != state["sig"]:
        state["ops"] = _PlanTensors(plan, mode, exchange, device, part)
        state["sig"] = sig
        state["builds"] += 1
        state["version"] = plan.version
    elif state["version"] != plan.version:
        state["ops"].refresh(plan)
        state["version"] = plan.version


def _replica0_used(plan: ShardPlan, exchange: str, replica0) -> bool:
    """Whether the forward reads ``replica0``: on a plan whose ppermute
    forward has replicas, where it may not be missing."""
    if not _use_replicas(plan, exchange):
        return False
    if replica0 is None:
        raise ValueError(
            "plan has replicas: pass replica0="
            "scatter_replica_halo(plan, features) so layer 0 can "
            "serve replica-resident halo slots locally")
    return True


def _halo0(plan: ShardPlan, exchange: str, replica0, h: torch.Tensor):
    """The layer-0 halo with the replica-resident rows, (P, halo_cap + 1,
    d) with the dump row last, on a plan whose ppermute forward has
    replicas; None otherwise."""
    if not _replica0_used(plan, exchange, replica0):
        return None
    r0 = torch.as_tensor(replica0, device=h.device).to(h.dtype)
    return torch.cat([r0, r0.new_zeros((r0.shape[0], 1, r0.shape[-1]))],
                     dim=1)


def input_signature(params, blocks, replica0=None) -> tuple:
    """What fixes a trace of the reference's jitted forward besides the
    plan: every parameter's shape and dtype, the blocks', and replica0's
    where the forward reads it (None otherwise)."""
    return (tuple(tuple((k, spec(v)) for k, v in p.items())
                  for p in params), spec(blocks),
            None if replica0 is None else spec(replica0))


def call_captured(steps: dict, key, name: str, fn, pool, device, params,
                  blocks, replica0=None):
    """``fn(params, blocks, replica0)`` through the :class:`Step` of
    ``key`` in ``steps`` (:func:`repro_torch.step.step_for`: made at its
    first use, over static buffers of the parameters, the blocks and
    ``replica0`` when given; run eagerly and captured the first time,
    replayed after).  Returns the step's outputs, which its next call
    rewrites.  While tracing is on the body runs between the step's begin
    and end marks (``step``, ``exit``), captured with it, and the step
    between the marks ``launch`` (after the input copies) and ``clone``, so
    the graph's entry and exit lie in phases of their own."""
    extra = {} if replica0 is None else {"replica0": replica0}

    def body(blocks, replica0=None, **leaves):
        tracing.mark("step", device)
        out = fn(params_from_leaves(params, leaves), blocks, replica0)
        tracing.mark("exit", device)
        return out

    step = step_for(steps, key, name, body, pool, device,
                    **param_leaves(params), blocks=blocks, **extra)
    tracing.mark("launch", device)
    out = step()
    tracing.mark("clone", device)
    return out


def make_bsp_forward(
    cfg: GNNConfig,
    plan: ShardPlan,
    exchange: str = "ppermute",
    aggregate: str = "auto",
    device: DeviceLike = "cuda",
    graphs: Optional[bool] = None,
):
    """Build the BSP forward: (params, blocks (P, cap, d)) -> (P, cap, d').

    The returned callable reads the plan at CALL time: a :func:`patch_plan`
    that kept every capacity is picked up by refreshing the resident plan
    tensors in place, with zero rebuilds; capacity growth or a new ppermute
    round changes the signature and rebuilds exactly once, as does turning
    the ppermute forward's replicas on or off (growth of ``r_cap`` alone is
    value-only).  ``exchange`` and ``aggregate`` pick the halo exchange and
    the neighbour sum (see :func:`resolve_aggregate`).

    ``fwd.stats`` holds ``builds``, the rebuilds, and ``traces``, what the
    reference's jitted forward counts as traces: one for each distinct pair
    of the plan's signature and :func:`input_signature` (a rebuild forgets
    the signatures seen), counted on the CPU too.

    ``graphs`` (None: on a CUDA device; True elsewhere raises) captures the
    forward: one CUDA graph for each trace, made at its first call (which
    runs eagerly) and replayed by later calls over the same tensors, so a
    value-only patch replays with no new trace and a rebuild captures
    anew; while tracing is on, one marked graph a trace beside it
    (``fwd.marked_steps``; module docstring).  The parameters, ``blocks``
    and ``replica0`` are copied into the graph's static input buffers
    (:meth:`repro_torch.step.Step.write`: not when the caller passes a
    buffer itself, or the tensor it wrote last, unchanged), and every
    call returns a new tensor.  A captured
    forward is not differentiable: under grad with parameters that require
    it, it raises (the train step differentiates ``fwd.eager``).  A capture
    that fails raises.  ``fwd.steps`` maps each input signature of the
    current build to its :class:`repro_torch.step.Step` (None for one only
    run eagerly), with its capture seconds and pool bytes.

    On a plan with replicas the ppermute forward takes
    ``replica0=scatter_replica_halo(plan, features)``, (P, halo_cap, d): the
    replica-resident halo rows of layer 0, which it does not move.  The
    allgather forward ignores replicas.
    """
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange {exchange!r}")
    dev = resolve_device(device)
    graphs = resolve_graphs(graphs, dev, "make_bsp_forward")
    mode = resolve_aggregate(cfg, aggregate, dev)
    if mode == "bsr" and plan.bsr is None:
        build_plan_bsr(plan)
    state = {"sig": None, "version": -1, "ops": None, "builds": 0,
             "traces": 0}
    steps = {}                  # input signature -> Step (or None), a build's
    marked = {}                 # the same, captured with tracing on
    pool = torch.cuda.graph_pool_handle() if graphs else None

    def sync():
        """Bring the plan tensors up to the plan; a rebuild drops the
        build's traces and graphs."""
        builds = state["builds"]
        _sync_ops(state, plan, mode, exchange, dev)
        if state["builds"] != builds:
            steps.clear()
            marked.clear()

    def trace(params, blocks, replica0):
        used = _replica0_used(plan, exchange, replica0)
        key = input_signature(params, blocks, replica0 if used else None)
        if key not in steps:
            steps[key] = None
            state["traces"] += 1
        return key, used

    def body(params, blocks, replica0=None):
        h = torch.as_tensor(blocks, device=dev).to(cfg.dtype)
        return _bsp_forward(cfg, params, h, state["ops"],
                            _halo0(plan, exchange, replica0, h))

    def eager(params, blocks, replica0=None):
        """The forward run eagerly over the plan tensors: differentiable,
        never captured."""
        with tracing.span("plan.sync"):
            sync()
        with tracing.span("step.key"):
            trace(params, blocks, replica0)
        return body(params, blocks, replica0)

    def forward(params, blocks, replica0=None):
        with tracing.call("bsp.call", dev):
            if not graphs:
                tracing.mark("step", dev)
                out = eager(params, blocks, replica0)
                tracing.mark("clone", dev)
                return out
            if torch.is_grad_enabled() and any(
                    v.requires_grad for p in params for v in p.values()
                    if isinstance(v, torch.Tensor)):
                raise ValueError("a captured BSP forward is not "
                                 "differentiable: build it with "
                                 "graphs=False, or differentiate fwd.eager")
            with tracing.span("plan.sync"):
                sync()
            with tracing.span("step.key"):
                key, used = trace(params, blocks, replica0)
            out = call_captured(
                marked if tracing.on() else steps, key,
                f"bsp {cfg.model} {exchange} {mode}", torch.no_grad()(body),
                pool, dev, params, blocks, replica0 if used else None)
            with tracing.span("out.clone"):
                return out.clone()

    forward.stats = state
    forward.steps = steps
    forward.marked_steps = marked
    forward.plan = plan
    forward.mode = mode
    forward.device = dev
    forward.graphs = graphs
    forward.eager = eager
    forward.reads_replica0 = functools.partial(_replica0_used, plan,
                                               exchange)
    forward.sync = sync
    return forward


def simulate_bsp_forward(cfg: GNNConfig, params, plan: ShardPlan,
                         features: np.ndarray, exchange: str = "ppermute",
                         aggregate: str = "auto",
                         device: DeviceLike = "cuda") -> np.ndarray:
    """Whole-graph convenience: scatter ``features`` (n, s_0) over the plan,
    run the BSP forward once, eagerly (a graph captured for one call only
    costs time), with the replica halo on a plan that has replicas, and
    gather (n, s_K) back as numpy."""
    fwd = make_bsp_forward(cfg, plan, exchange=exchange, aggregate=aggregate,
                           device=device, graphs=False)
    features = np.asarray(features)
    replica0 = (torch.from_numpy(scatter_replica_halo(plan, features))
                if plan.has_replicas else None)
    out = fwd(params, torch.from_numpy(scatter_features(plan, features)),
              replica0=replica0)
    return gather_outputs(plan, out.cpu().numpy(), features.shape[0])
