"""GNN models exactly per the paper's Sec. II-A execution semantics.

  GCN  (Eq. 1):  a_v = sum_{u in N_v} h_u
                 h_v' = sigma(W . (a_v + h_v) / (|N_v| + 1))
  GAT  (Eq. 2):  a_v = sum_{u in N_v u {v}} eta_vu . W h_u,  h_v' = sigma(a_v)
  SAGE (Eq. 3):  a_v = mean_{u in N_v} h_u
                 h_v' = sigma(W . concat(a_v, h_v))

The torch counterpart of ``repro.gnn.models``: plain functions over a list of
per-layer parameter dicts (``{"w", "att_src", "att_dst"}``, the reference's
keys and shapes) and a directed src->dst edge tensor (each undirected link
appears twice).  The neighbour sum runs through a pluggable ``aggregate`` so
the BSP engine and the ego server reuse the same layer semantics.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.kernels import segment_sum as k3
from repro_torch.step import cached_step, resolve_graphs, spec

Aggregate = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]
# (messages (E, d), dst_ids (E,), num_nodes) -> (n, d) summed per dst.


def segment_order(dst: np.ndarray, n: int):
    """The order of a segment sum over ``dst`` fixed on the host, for
    :func:`segment_sum`'s ``segments``: (the stable argsort of ``dst``,
    ``dst`` in that order, the offsets of its ``n`` ids' segments in it:
    the exclusive prefix of their counts, then the total), int64 arrays.
    Made wherever ``dst`` is known before the call (a plan's edge table, a
    batch's arcs), so the sum on the card reads nothing back to the
    host."""
    dst = np.asarray(dst).astype(np.int64).reshape(-1)
    order = np.argsort(dst, kind="stable")
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=offsets[1:])
    return order, dst[order], offsets


def segment_sum(messages: torch.Tensor, dst: torch.Tensor, n: int,
                segments=None) -> torch.Tensor:
    """Sum the rows of ``messages`` per destination id: (E, ...) -> (n, ...).

    On the CPU this is ``index_add_``, which adds in edge order.  On the card
    ``index_add_`` uses float atomics whose order changes from run to run, so
    the sum goes through :func:`sorted_segment_sum` instead: deterministic,
    bit for bit, from one run to the next.  ``segments`` (the tensors of
    :func:`segment_order` for this ``dst``) saves it the sort."""
    if messages.device.type == "cpu":
        out = messages.new_zeros((n,) + tuple(messages.shape[1:]))
        return out.index_add_(0, dst, messages)
    return sorted_segment_sum(messages, dst, n, segments)


def sorted_segment_sum(messages: torch.Tensor, dst: torch.Tensor, n: int,
                       segments=None) -> torch.Tensor:
    """Destination-sorted segment sum: K3 on the card, its plain version
    (the messages in stable ``dst`` order, then ``segment_reduce``)
    elsewhere; both in :mod:`repro_torch.kernels.segment_sum`.  The plain
    version sums each destination's messages in edge order, as
    ``index_add_`` does on the CPU.  K3 does too for a destination whose
    messages lie in one of its tiles of 256 sorted positions (in its
    segmented scan's fixed order for 1- and 2-wide messages); a longer
    segment is summed tile by tile, the tiles' partials then in tile
    order.  Either way the order is fixed by the shapes alone and the
    result does not depend on scheduling.  The gradient with respect to
    ``messages`` is the output's gathered by ``dst``.

    Nothing is read back to the host, so the sum can be captured into a
    CUDA graph: the order, sorted ``dst`` and offsets are ``segments``
    (made on the host by :func:`segment_order`) or, without them, a stable
    sort on the device and a ``searchsorted`` of each id's first
    position."""
    if segments is None:
        keys, order = torch.sort(dst.long(), stable=True)
        offsets = torch.searchsorted(
            keys, torch.arange(n + 1, device=keys.device))
        path = "device"
    else:
        order, keys, offsets = segments
        if order.shape[0] != messages.shape[0] or offsets.shape[0] != n + 1:
            raise ValueError(
                f"segment order of {order.shape[0]} messages into "
                f"{offsets.shape[0] - 1} segments, given "
                f"{messages.shape[0]} into {n}")
        path = "plan"
    return k3.segment_sum(messages.contiguous(), dst, order, keys, offsets,
                          path)


def segment_max(values: torch.Tensor, dst: torch.Tensor,
                n: int) -> torch.Tensor:
    """Per-destination max of a 1-D tensor; empty segments give -inf (the
    identity ``jax.ops.segment_max`` uses).  Max is exact in any order, and
    its backward counts ties with a scatter-add of 0/1 values, exact in any
    order too."""
    out = torch.full((n,), float("-inf"), dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, dst.long(), values, reduce="amax",
                               include_self=True)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along dim 0, with a deterministic backward.

    Autograd's own backward of a row gather is a scatter-add, which on the
    card uses float atomics wherever an index repeats.  This one sums each
    row's gradient with :func:`segment_sum`: ``index_add_`` on the CPU,
    :func:`sorted_segment_sum` on the card (its order found on the device,
    so the backward can be captured).  Both add a row's contributions in
    an order fixed by the shapes, so card gradients are bit-equal run to
    run and differ from the CPU's only in rounding."""
    return _GatherRows.apply(x, idx)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        idx, = ctx.saved_tensors
        return segment_sum(g, idx, ctx.rows), None


def directed_edges(edges: np.ndarray) -> np.ndarray:
    """Undirected (E,2) u<v edge list -> directed (2E,2) src->dst pairs."""
    if len(edges) == 0:
        return np.zeros((0, 2), dtype=np.int32)
    fwd = edges
    bwd = edges[:, ::-1]
    return np.concatenate([fwd, bwd], axis=0).astype(np.int32)


def degrees_from_directed(src_dst: torch.Tensor, n: int) -> torch.Tensor:
    """In-degree per vertex as float32 (exact integer counts).  An integer
    ``scatter_add_`` of ones (exact in any order), where ``bincount``
    would read its size to the host: the whole-graph forward can be
    captured."""
    dst = src_dst[:, 1].long()
    deg = torch.zeros(n, dtype=torch.long, device=dst.device)
    return deg.scatter_add_(0, dst, torch.ones_like(dst)).to(torch.float32)


# ---------------------------------------------------------------- parameters
def _glorot(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    lim = (6.0 / (fan_in + fan_out)) ** 0.5
    u = torch.rand(shape, generator=gen, dtype=dtype)
    return (2.0 * u - 1.0) * lim


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    model: str                      # 'gcn' | 'gat' | 'sage'
    layer_dims: Sequence[int]       # [s_0, ..., s_K]
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        # Tuple-ize so the config is hashable.
        object.__setattr__(self, "layer_dims", tuple(self.layer_dims))

    @property
    def num_layers(self) -> int:
        return len(self.layer_dims) - 1


def init_params(cfg: GNNConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = "cuda"):
    """Glorot-uniform parameters with the reference's keys and shapes.

    The numbers come from ``generator`` (a CPU ``torch.Generator``; seed 0
    when omitted) and differ from ``jax.random``'s; carry the reference's
    own weights across with :func:`params_from_jax`."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    params = []
    for k in range(cfg.num_layers):
        d_in, d_out = cfg.layer_dims[k], cfg.layer_dims[k + 1]
        if cfg.model == "gcn":
            layer = {"w": _glorot(gen, (d_in, d_out), cfg.dtype)}
        elif cfg.model == "gat":
            layer = {
                "w": _glorot(gen, (d_in, d_out), cfg.dtype),
                "att_src": _glorot(gen, (d_out, 1), cfg.dtype)[:, 0],
                "att_dst": _glorot(gen, (d_out, 1), cfg.dtype)[:, 0],
            }
        elif cfg.model == "sage":
            layer = {"w": _glorot(gen, (2 * d_in, d_out), cfg.dtype)}
        else:
            raise ValueError(cfg.model)
        params.append({name: t.to(dev) for name, t in layer.items()})
    return params


def params_or_init(cfg: GNNConfig, params=None, device: DeviceLike = "cuda"):
    """``params`` (a parameter list of tensors or arrays, e.g. the
    reference's through :func:`params_from_jax`) moved to ``device``, or
    when it is None, :func:`init_params`'s seed-0 draw there: the same
    weights on every device."""
    if params is None:
        return init_params(cfg, device=device)
    dev = resolve_device(device)
    return [{k: torch.as_tensor(v).to(dev) for k, v in layer.items()}
            for layer in params]


def param_leaves(params) -> dict:
    """The parameter list's tensors by name, ``p{layer}.{key}``."""
    return {f"p{k}.{name}": v for k, p in enumerate(params)
            for name, v in p.items()}


def params_from_leaves(like, leaves: dict):
    """A parameter list shaped as ``like`` over the tensors of
    :func:`param_leaves`' names in ``leaves``."""
    return [{k: leaves[f"p{i}.{k}"] for k in p} for i, p in enumerate(like)]


def params_from_jax(params_np, device: DeviceLike = "cuda"):
    """The reference's parameter list (``[{"w", "att_src", "att_dst"}, ...]``
    of arrays, e.g. ``jax.tree.map(np.asarray, params)``) as torch tensors,
    so both packages compute with the same weights."""
    dev = resolve_device(device)
    return [{name: torch.from_numpy(np.array(v)).to(dev)
             for name, v in layer.items()} for layer in params_np]


# -------------------------------------------------------------------- layers
def _activation(x: torch.Tensor, last: bool) -> torch.Tensor:
    return x if last else torch.relu(x)


def gcn_layer(p, h, src_dst, deg, n, last, aggregate: Aggregate):
    msgs = gather_rows(h, src_dst[:, 0])
    agg = aggregate(msgs, src_dst[:, 1], n)                       # sum_{N_v} h_u
    out = (agg + h) / (deg[:, None] + 1.0)                        # / (|N_v|+1)
    return _activation(out @ p["w"], last)


def gat_layer(p, h, src_dst, deg, n, last, aggregate: Aggregate):
    wh = h @ p["w"]                                               # W h_u
    # Attention logits per link (GATv1): LeakyReLU(a_s . Wh_dst + a_d . Wh_src)
    alpha_dst = wh @ p["att_src"]                                 # (n,)
    alpha_src = wh @ p["att_dst"]                                 # (n,)
    # Self loops: every vertex attends to itself too (Eq. 2: N_v u {v}).
    self_ids = torch.arange(n, dtype=src_dst.dtype, device=src_dst.device)
    src = torch.cat([src_dst[:, 0], self_ids])
    dst = torch.cat([src_dst[:, 1], self_ids])
    logits = F.leaky_relu(gather_rows(alpha_dst, dst)
                          + gather_rows(alpha_src, src), 0.2)
    # Softmax over each dst's incoming links (numerically stable via segment max).
    seg_max = segment_max(logits, dst, n)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.exp(logits - gather_rows(seg_max, dst))
    denom = aggregate(ex[:, None], dst, n)[:, 0]                  # sum exp per dst
    eta = ex / torch.clamp(gather_rows(denom, dst), min=1e-16)    # eta_vu
    agg = aggregate(eta[:, None] * gather_rows(wh, src), dst, n)  # sum eta W h_u
    return _activation(agg, last)


def sage_layer(p, h, src_dst, deg, n, last, aggregate: Aggregate):
    msgs = gather_rows(h, src_dst[:, 0])
    agg = aggregate(msgs, src_dst[:, 1], n) / torch.clamp(deg, min=1.0)[:, None]
    cat = torch.cat([agg, h], dim=-1)                             # (a_v, h_v)
    return _activation(cat @ p["w"], last)


_LAYERS = {"gcn": gcn_layer, "gat": gat_layer, "sage": sage_layer}


def forward(
    cfg: GNNConfig,
    params,
    features: torch.Tensor,
    src_dst,
    n: Optional[int] = None,
    aggregate: Aggregate = segment_sum,
) -> torch.Tensor:
    """Full-graph inference: features (n, s_0) -> embeddings (n, s_K).

    Runs on the device of ``features``; ``src_dst`` (array or tensor) is
    moved there as int64."""
    n = n if n is not None else features.shape[0]
    src_dst = torch.as_tensor(src_dst, device=features.device).long()
    deg = degrees_from_directed(src_dst, n)
    layer_fn = _LAYERS[cfg.model]
    h = features.to(cfg.dtype)
    for k, p in enumerate(params):
        h = layer_fn(p, h, src_dst, deg, n, k == cfg.num_layers - 1, aggregate)
    return h


def loss_fn(cfg: GNNConfig, params, features, src_dst, labels, mask=None,
            aggregate: Aggregate = segment_sum):
    """Node-classification cross entropy (the paper's SIoT/Yelp tasks)."""
    logits = forward(cfg, params, features, src_dst, aggregate=aggregate)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def predict(cfg: GNNConfig, params, features, src_dst,
            graphs: Optional[bool] = None) -> torch.Tensor:
    """The argmax class of every vertex, on the device of ``features``.

    The counterpart of the reference's jitted ``predict``: one step for
    each static ``cfg`` and each device and shape and dtype of the
    parameters, the features and ``src_dst`` (``predict.steps``; clear it
    to drop them).  ``graphs`` (None: on a CUDA device; True elsewhere
    raises) captures each step into a CUDA graph at its first call, which
    runs eagerly (:class:`repro_torch.step.Step`), and replays it after;
    the parameters, features and edges are inputs written into its
    buffers at every call, not constants.  Returns a new tensor."""
    dev = features.device
    graphs = resolve_graphs(graphs, dev, "predict")
    src_dst = torch.as_tensor(src_dst, device=dev).long()
    leaves = param_leaves(params)
    key = (cfg, dev, graphs, tuple((k, spec(v)) for k, v in leaves.items()),
           spec(features), spec(src_dst))

    @torch.no_grad()
    def body(features, src_dst, **leaves):
        return torch.argmax(forward(cfg, params_from_leaves(params, leaves),
                                    features, src_dst), dim=-1)

    return cached_step(predict.steps, key, f"predict {cfg.model}", body,
                       graph_pool(dev) if graphs else None, dev,
                       features=features, src_dst=src_dst, **leaves).clone()


predict.steps = {}
_POOLS: dict = {}


def graph_pool(dev: torch.device):
    """The graph pool the whole-graph steps on ``dev`` share (``predict``
    and ``training.train_step``): each call clones its outputs before
    another step of the pool runs."""
    if dev not in _POOLS:
        _POOLS[dev] = torch.cuda.graph_pool_handle()
    return _POOLS[dev]
