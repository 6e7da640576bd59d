"""BSP GNN forward across processes: one ``torch.distributed`` rank per
edge server (paper Sec. III-B).

The counterpart of the reference's mesh-bound ``make_bsp_forward``, which
runs one program per TPU device under ``shard_map``
(``repro/gnn/distributed.py``): rank q holds partition q of a
:class:`ShardPlan` and maps its own (cap, s_0) block to its output block.
Each layer moves the halo between processes and then runs the one-device
layer code of :mod:`repro_torch.gnn.distributed` on a P = 1 share of the
plan (``_PlanTensors(..., part=q)``), so the layer maths is written once.

Exchanges (the reference's ``_exchange_ppermute`` / ``_exchange_allgather``):
  * ``ppermute`` — for each round of shift s, rank q gathers its
    ``send_idx`` rows (padding reads the zero row), sends them to
    (q + s) % P and receives (q - s) % P's in one ``batch_isend_irecv``,
    and writes what it received at ``recv_pos`` (the dump row takes the
    padding).  On a plan with replicas, layer 0 starts from ``replica0``
    and runs the pruned ``rounds0``.
  * ``allgather`` — every rank's block gathered, the halo picked by
    ``halo_slot``.

Each collective is a ``torch.autograd.Function`` with its adjoint: the
send/recv of shift s transposes to the send/recv of -s, and the
all_gather to a reduce-scatter, written as an ``all_to_all`` followed by a
sum in rank order (gloo's own reduction promises no order), so gradients
are the same bits run to run.  The gathers and writes around the
collectives stay in autograd, as in the batched program.

Backend.  The group must be gloo, the only backend this module runs:
gloo moves host memory, so on the card every send and receive is staged
through pinned host buffers explicitly, one device-to-host and one
host-to-device copy a collective (:attr:`RankGroup.staged`).  NCCL would
move device memory directly, but refuses two ranks on one card.

The plan on every rank.  Rank 0 runs the layout and
:func:`broadcast_assign` gives every rank its assignment (n ints); every
rank then compiles, and later patches, the same plan from it (the host
code is deterministic).  Before every forward the ranks all-gather a
digest of their plan (:func:`plan_digest`) and refuse to run if any
differs.
"""
from __future__ import annotations

import hashlib
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.gnn.distributed import (
    EXCHANGES, _bsp_forward, _halo0, _sync_ops, _use_replicas,
    resolve_aggregate)
from repro_torch.gnn.models import GNNConfig
from repro_torch.gnn.plan import ShardPlan


class RankGroup:
    """One rank's end of a gloo group: the collectives of the rank forward
    and train step, staged through pinned host buffers when the tensors
    live on the card.

    ``log`` gets one entry per collective: the rows and bytes this rank
    sent and received, and the host seconds it took (staging included,
    after the device has finished the work queued before it); the rank
    forward empties it as it starts.  ``staged`` counts the device-to-host
    and host-to-device copies."""

    def __init__(self, group, device: torch.device):
        backend = dist.get_backend(group)
        if backend != "gloo":
            raise ValueError(f"the rank forward runs over gloo only, the "
                             f"group's backend is {backend!r}")
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.device = device
        self.log: list = []
        self.staged = {"d2h": 0, "h2d": 0}

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def _start(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return time.perf_counter()

    def _record(self, t0: float, x: torch.Tensor, sent: int,
                recv: int) -> None:
        """``sent`` and ``recv``: how many rows shaped as ``x``'s."""
        row = x[0].numel() * x.element_size()
        self.log.append({"rows_sent": sent, "rows_recv": recv,
                         "bytes_sent": sent * row, "bytes_recv": recv * row,
                         "s": time.perf_counter() - t0})

    def _to_host(self, x: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cpu":
            return x.contiguous()
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)                            # waits for the copy
        self.staged["d2h"] += 1
        return buf

    def _host_empty(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def _to_device(self, buf: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cpu":
            return buf
        self.staged["h2d"] += 1
        return buf.to(self.device, non_blocking=True)

    def shift(self, x: torch.Tensor, s: int) -> torch.Tensor:
        """Send ``x`` to rank (q + s) % P; return rank (q - s) % P's
        ``x``, of the same shape."""
        t0 = self._start()
        send = self._to_host(x)
        recv = self._host_empty(x.shape, x.dtype)
        ops = [dist.P2POp(dist.isend, send,
                          self._peer((self.rank + s) % self.world),
                          self.group),
               dist.P2POp(dist.irecv, recv,
                          self._peer((self.rank - s) % self.world),
                          self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        self._record(t0, x, x.shape[0], x.shape[0])
        return self._to_device(recv)

    def _gather_host(self, x: torch.Tensor) -> torch.Tensor:
        t0 = self._start()
        send = self._to_host(x)
        out = self._host_empty((self.world,) + tuple(x.shape), x.dtype)
        dist.all_gather(list(out.unbind(0)), send, group=self.group)
        self._record(t0, x, x.shape[0], (self.world - 1) * x.shape[0])
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x``, stacked in rank order: (P, *x.shape)."""
        return self._to_device(self._gather_host(x))

    def reduce_scatter(self, g: torch.Tensor) -> torch.Tensor:
        """The adjoint of :meth:`all_gather`: from every rank's (P, ...)
        ``g``, the sum over ranks r of ``g_r[q]``, added in rank order."""
        t0 = self._start()
        send = self._to_host(g.contiguous())
        got = self._host_empty(g.shape, g.dtype)
        dist.all_to_all_single(got, send, group=self.group)
        rows = (self.world - 1) * g.shape[1]
        self._record(t0, g[0], rows, rows)
        return self._to_device(_sum_in_order(got))

    def sum_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x`` (at least 1-D), added in rank
        order on the host, so every rank holds the same bits."""
        return self._to_device(_sum_in_order(self._gather_host(x)))

    def agree(self, digest: bytes) -> float:
        """Raise on every rank unless every rank passed the same digest;
        returns the host seconds the check took."""
        t0 = time.perf_counter()
        mine = torch.frombuffer(bytearray(digest), dtype=torch.uint8)
        every = torch.empty((self.world, mine.numel()), dtype=torch.uint8)
        dist.all_gather(list(every.unbind(0)), mine, group=self.group)
        if not bool((every == mine).all()):
            bad = [r for r in range(self.world)
                   if not torch.equal(every[r], every[0])]
            raise RuntimeError(f"ranks hold different plans: rank(s) {bad} "
                               "differ from rank 0")
        return time.perf_counter() - t0


def _sum_in_order(parts: torch.Tensor) -> torch.Tensor:
    acc = parts[0].clone()
    for r in range(1, parts.shape[0]):
        acc += parts[r]
    return acc


class _Shift(torch.autograd.Function):
    """Rows to rank (q + s) % P, rows from (q - s) % P; the adjoint is the
    shift by -s."""

    @staticmethod
    def forward(ctx, x, s, comm):
        ctx.s, ctx.comm = s, comm
        return comm.shift(x, s)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.shift(g.contiguous(), -ctx.s), None, None


class _AllGather(torch.autograd.Function):
    """Every rank's block; the adjoint is the reduce-scatter."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce_scatter(g), None


class _Wire:
    """The rank forward's wire for ``_bsp_forward``: its (1, ...) tensors
    moved by collectives."""

    def __init__(self, comm: RankGroup):
        self.comm = comm

    def shift(self, send: torch.Tensor, s: int) -> torch.Tensor:
        return _Shift.apply(send[0], s, self.comm)[None]

    def blocks(self, h: torch.Tensor) -> torch.Tensor:
        return _AllGather.apply(h[0], self.comm)


def plan_digest(plan: ShardPlan) -> bytes:
    """SHA-256 of every table a forward over the plan reads (and of the
    assignment): equal plans give equal digests."""
    h = hashlib.sha256()
    h.update(np.asarray([plan.num_parts, plan.cap, plan.halo_cap,
                         plan.e_cap, plan.r_cap], np.int64).tobytes())
    arrays = [plan.assign, plan.local, plan.halo, plan.halo_slot,
              plan.edges_src, plan.edges_dst, plan.deg]
    if plan.replica is not None:
        arrays.append(plan.replica)
    for r in list(plan.rounds) + list(plan.rounds0 or ()):
        h.update(np.asarray([r["shift"], r["width"]], np.int64).tobytes())
        arrays += [r["send_idx"], r["recv_pos"]]
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()


def broadcast_assign(assign: Optional[np.ndarray], n: int,
                     group=None) -> np.ndarray:
    """Rank 0's assignment (n server ids) on every rank; the other ranks
    pass None (or anything: it is not read)."""
    if dist.get_rank(group) == 0:
        t = torch.from_numpy(np.asarray(assign, np.int64).copy())
        if t.shape != (n,):
            raise ValueError(f"assignment of shape {tuple(t.shape)}, the "
                             f"graph has {n} vertices")
    else:
        t = torch.empty(n, dtype=torch.int64)
    src = 0 if group is None else dist.get_global_rank(group, 0)
    dist.broadcast(t, src=src, group=group)
    return t.numpy()


def make_rank_bsp_forward(
    cfg: GNNConfig,
    plan: ShardPlan,
    group=None,
    exchange: str = "ppermute",
    aggregate: str = "auto",
    device: DeviceLike = "cuda",
    graphs: Optional[bool] = None,
):
    """Build this rank's BSP forward: (params, its block (cap, d) or
    (1, cap, d)) -> its output block of the same rank.  It runs eagerly:
    ``graphs=True`` raises (its gloo collectives, staged through the host,
    cannot be captured into a CUDA graph), and so does a train step over
    it that asks for graphs.

    ``group`` is a gloo process group of ``plan.num_parts`` ranks (None:
    the default group); rank q serves partition q.  Every rank calls the
    forward with the same parameters at the same time (each layer's
    exchange is a collective).  The callable reads the plan at CALL time,
    as :func:`repro_torch.gnn.distributed.make_bsp_forward` does: a
    value-only :func:`patch_plan` refreshes the rank's tensors in place
    with zero rebuilds; capacity growth, a new round, or replicas switched
    on or off rebuild exactly once (``fwd.stats['builds']``).  Before each
    forward the ranks check that they hold the same plan.

    On a plan with replicas the ppermute forward takes ``replica0``, the
    rank's (halo_cap, d) row of ``scatter_replica_halo(plan, features)``,
    and raises without it.

    ``fwd.stats`` also holds, for the last forward, ``traffic``: per layer
    the rows and bytes this rank sent and received (``rows_sent`` counts
    the padded round widths; ``live_rows_sent`` the rows the schedule
    fills), ``exchange_s``, the host seconds of its exchanges, and
    ``agree_s``, those of the plan check.  ``fwd.comm`` is the
    :class:`RankGroup`."""
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange {exchange!r}")
    if graphs:
        raise ValueError("make_rank_bsp_forward(graphs=True): the rank "
                         "forward's gloo collectives are not captured")
    dev = resolve_device(device)
    comm = RankGroup(group, dev)
    if plan.num_parts != comm.world:
        raise ValueError(f"the plan has {plan.num_parts} partitions, the "
                         f"group {comm.world} ranks")
    mode = resolve_aggregate(cfg, aggregate, dev)
    wire = _Wire(comm)
    state = {"sig": None, "version": -1, "ops": None, "builds": 0,
             "digest": None, "traffic": [], "exchange_s": 0.0,
             "agree_s": 0.0}

    def forward(params, block, replica0=None):
        if state["version"] != plan.version or state["digest"] is None:
            state["digest"] = plan_digest(plan)
        state["agree_s"] = comm.agree(state["digest"])
        _sync_ops(state, plan, mode, exchange, dev, part=comm.rank)
        h = torch.as_tensor(block, device=dev).to(cfg.dtype)
        one = h.dim() == 2
        if h.dim() not in (2, 3) or h.shape[-2] != plan.cap or (
                not one and h.shape[0] != 1):
            raise ValueError(f"block of shape {tuple(h.shape)}: a rank "
                             f"takes its own (cap={plan.cap}, d) block")
        h = h.reshape(1, plan.cap, -1)
        if replica0 is not None:
            replica0 = torch.as_tensor(replica0).reshape(1, plan.halo_cap, -1)
        halo0 = _halo0(plan, exchange, replica0, h)
        comm.log.clear()
        out = _bsp_forward(cfg, params, h, state["ops"], halo0, wire)
        _account(state, plan, exchange, comm, list(comm.log), len(params))
        return out[0] if one else out

    forward.stats = state
    forward.plan = plan
    forward.mode = mode
    forward.device = dev
    forward.comm = comm
    forward.graphs = False
    return forward


def _account(state, plan, exchange, comm, entries, layers) -> None:
    """The last forward's traffic per layer and its exchange seconds."""
    q = comm.rank
    per = len(entries) // layers
    traffic = []
    for k in range(layers):
        mine = entries[k * per:(k + 1) * per]
        row = {key: sum(e[key] for e in mine) for key in (
            "rows_sent", "rows_recv", "bytes_sent", "bytes_recv")}
        if exchange == "ppermute":
            rounds = (plan.rounds0 if k == 0 and _use_replicas(plan, exchange)
                      else plan.rounds)
            row["live_rows_sent"] = sum(int((r["send_idx"][q] >= 0).sum())
                                        for r in rounds)
        traffic.append(row)
    state["traffic"] = traffic
    state["exchange_s"] = sum(e["s"] for e in entries)
