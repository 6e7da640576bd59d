"""Fine-grained MoE layer (DeepSeekMoE / Kimi-K2 style), the torch
counterpart of ``repro.models.moe``:

  router_topk        fp32 softmax over ``x @ w_router``, top-k, weights
                     renormalised to sum 1, Switch-style aux loss
  grouped_gemm       ``jax.lax.ragged_dot``'s semantics: row i times the
                     weight of its group; rows past ``sum(group_sizes)``
                     give zero
  moe_ffn            the routed experts: dropless without a mesh, expert
                     parallel with a per-expert capacity under one
  moe_ffn_dense_ref  every expert on every token, one-hot combine (the
                     oracle of the tests and of ``chip_smoke.py``)

``moe_ffn`` computes the function the reference computes where there is no
mesh (``transformer._ffn_moe_local``, which is ``moe_ffn_dense_ref``): every
token gets its top-k experts and none is dropped.  It computes it routed,
not densely: the ``T * k`` assignments are sorted by expert (stable), the
rows gathered in that order, the experts' two products run as grouped GEMMs
over the groups, each row weighted by its router weight, and the rows put
back to ``(T, k, d)`` and summed over k in fp32.  That is the dense oracle's
function up to the order of summation.  Nothing in it is an atomic or an
``index_add_``, so it repeats bit for bit, and a token's result never
depends on the other tokens of the batch beyond the GEMMs' tiling (a pad
token of a serving bucket never takes a real token's place).

Under a mesh (``moe_ffn(..., mesh, batch_axes, model_axis, data_axis,
fsdp_axes)``, the reference's body, ``moe.py:101-185``): tokens are split
over the batch axes and whole on ``model``; the experts are split over
``model`` (``E_local = E / model``) and their weights gathered whole over
the other axes where used.  Each shard routes its tokens (replicated over
``model``), sorts its T·k assignments stably by local expert (others to
the tail) and gives each local expert a fixed block of ``C = max(64,
ceil64(T_local·k / E · capacity_factor))`` rows, so the experts' two
products are batched GEMMs over ``(E_local, C, ·)`` (``torch.bmm``, as the
reference's ``einsum`` is XLA's).  The drop rule is the reference CODE's:
an expert keeps the first C of its assignments in flat token order ``t·k
+ j``, so the later tokens drop whatever their router weight (the
reference's docstring, ``moe.py:13-15``, says overflow drops "the weakest
expert"; its code, ``moe.py:149-160``, does not).  The combine gathers
each kept row back to ``(T, k, d)``, zero where an assignment dropped, and
sums over k in fp32 (no ``index_add_``: float atomics would break
bit-identity); the shards' parts are summed over ``model``.  The routing
and the capacity body run on each shard's local tensors through
``Dist.local_map``; ``return_dropped`` gives the dropped assignments.  It
agrees with the dropless function wherever nothing overflows.

The grouped GEMM.  ``ragged_dot`` is XLA, not a Pallas kernel, so its port
is a library call, as the dense GEMMs are ``torch.matmul``.  Two routes,
picked by :func:`grouped_gemm_route` from the device and the shapes, never
from the data and never because a call raised:

* ``"grouped_mm"``: ``torch._grouped_mm(x, w, offs=...)`` with the group
  ends on the device, for every call on a CUDA card whose row lengths
  ``torch._grouped_mm`` takes; in bf16 one launch per product and no host
  sync (the served path), in fp32 torch's own per-group fallback;
* ``"loop"``: one ``torch.matmul`` per non-empty group over sizes read to
  the host once per call, for the CPU and for rows that are not whole
  16-byte chunks.

The adjoints are autograd's through the product, and they are the
reference's (``grouped_gemm``'s ``custom_vjp``, ``_gg_bwd``): ``dx =
grouped(dy, wᵀ)`` and a ragged ``dw[e] = x[group e]ᵀ dy[group e]``, with
the forward's FLOPs.  The reference needs its ``custom_vjp`` because
autodiff of ``ragged_dot`` makes ``dW`` dense ("30x total-step compute");
torch's derivative of ``torch._grouped_mm`` is already the ragged pair
(``dx`` over ``wᵀ``, ``dw`` in its K-ragged mode), and on the loop route
each group's product differentiates alone: ``x`` is split and ``w``
unbound once, so ``dx`` is one ``cat`` and ``dw`` one ``stack`` (slicing
them per group would sum a dense zero-filled copy per group).  An empty
group's ``dw`` is 0, and ``grouped_gemm`` zeroes the rows past the groups
before the product, so their ``dx`` is 0.

``grouped_gemm.launches_by_route`` counts the forward calls by route, one
per grouped GEMM, and ``grouped_gemm.backward_launches_by_route`` the
backward calls, one where autograd reaches a grouped GEMM's output.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.models.common import Dist, LMConfig


def router_topk(x, w_router, k: int):
    """x (..., d) -> (idx (..., k) int64, weights (..., k) x.dtype, aux)."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    # Load-balance aux loss (Switch-style): E * sum_e f_e * p_e.
    E = w_router.shape[-1]
    me = probs.reshape(-1, E).mean(0)
    experts = torch.arange(E, device=x.device)
    one_hot = (idx.reshape(-1, k, 1) == experts).float().sum(1)
    ce = one_hot.mean(0) / k
    aux = E * torch.sum(me * ce)
    return idx, w.to(x.dtype), aux


def grouped_gemm_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """Which route :func:`grouped_gemm` takes for ``x (m, k)`` and ``w (g,
    k, n)``: "grouped_mm" on a CUDA card when both row lengths are whole
    16-byte chunks (``torch._grouped_mm``'s stride rule), else "loop"."""
    k, n = w.shape[-2:]
    aligned = all(length * x.element_size() % 16 == 0 for length in (k, n))
    return "grouped_mm" if x.is_cuda and aligned else "loop"


def reads_host(cfg: LMConfig, device: torch.device) -> bool:
    """Whether ``cfg``'s mesh-free ``moe_ffn`` on ``device`` reads the host
    (so a CUDA graph cannot capture it): the loop route reads the group
    ends (``ends.tolist()``), and ``torch._grouped_mm`` syncs on its
    per-group fallback outside bf16.  Only bf16 on the grouped_mm route
    stays on the device."""
    if not cfg.n_experts:
        return False
    x = torch.empty((0, cfg.d_model), dtype=cfg.dtype, device=device)
    f = cfg.expert_d_ff
    routes = {grouped_gemm_route(x, x.new_empty((0, k, n)))
              for k, n in ((cfg.d_model, 2 * f), (f, cfg.d_model))}
    return routes != {"grouped_mm"} or cfg.dtype != torch.bfloat16


def _product(route: str, x, w, ends):
    """Rows ``ends[e-1]:ends[e]`` of ``x (m, k)`` times ``w[e] (k, n)`` on
    ``route``; rows past ``ends[-1]`` are left unspecified on grouped_mm
    and 0 on the loop."""
    if route == "grouped_mm":
        return torch._grouped_mm(x, w, offs=ends)
    bounds = [0] + ends.tolist()
    xs = x.split([b - a for a, b in zip(bounds, bounds[1:])]
                 + [x.shape[0] - bounds[-1]])
    parts = [xg @ wg for xg, wg in zip(xs, w.unbind(0)) if len(xg)]
    parts.append(x.new_zeros((len(xs[-1]), w.shape[-1])))
    return torch.cat(parts)


def _backward_hook(route: str):
    def hook(dy):
        grouped_gemm.backward_launches_by_route[route] += 1
        return dy.contiguous()          # torch._grouped_mm's stride rule
    return hook


def _grouped(x, w, ends):
    """Rows ``ends[e-1]:ends[e]`` of ``x`` times ``w[e]``; ``ends`` (g,)
    int32, the groups' cumulative sizes, on x's device.  Rows past
    ``ends[-1]`` are left unspecified on the grouped_mm route and 0 on the
    loop route.  One count per call, and one per backward."""
    route = grouped_gemm_route(x, w)
    grouped_gemm.launches_by_route[route] += 1
    out = _product(route, x.contiguous(), w.contiguous(), ends)
    if out.requires_grad:
        out.register_hook(_backward_hook(route))
    return out


def grouped_gemm(x, w, group_sizes):
    """``jax.lax.ragged_dot(x, w, group_sizes)`` with the reference's
    ragged adjoints: x (m, k), w (g, k, n), group_sizes (g,) -> (m, n) in
    x's dtype; row i is multiplied by the weight of the group it falls in,
    and rows past ``sum(group_sizes)`` are 0 (and get no gradient)."""
    ends = torch.cumsum(group_sizes.to(x.device), 0).to(torch.int32)
    past = (torch.arange(x.shape[0], device=x.device) >= ends[-1])[:, None]
    return _grouped(x.masked_fill(past, 0), w, ends).masked_fill(past, 0)


grouped_gemm.launches_by_route = {"grouped_mm": 0, "loop": 0}
grouped_gemm.backward_launches_by_route = {"grouped_mm": 0, "loop": 0}
tracing.register(grouped_gemm, "launches_by_route")
tracing.register(grouped_gemm, "backward_launches_by_route")


def capacity(cfg: LMConfig, tokens: int) -> int:
    """Rows per local expert for ``tokens`` tokens a shard: ``tokens * k /
    E * capacity_factor``, rounded up to a multiple of 64, at least 64."""
    C = int((tokens * cfg.top_k / cfg.n_experts) * cfg.capacity_factor)
    return max(64, ((C + 63) // 64) * 64)


def _capacity_local(cfg: LMConfig, E_local: int, C: int, first: int,
                    xb, idxb, wb, w13, w2):
    """One shard's experts ``first .. first + E_local - 1`` over its tokens
    (the reference's ``moe_ffn`` body): xb (B_l, L, d), idxb/wb (B_l, L,
    k), w13 (E_local, d, 2f), w2 (E_local, f, d).  Returns this shard's
    part of the output (B_l, L, d) and its dropped assignments (B_l, L, k)
    int32, 1 = dropped."""
    B, L, d = xb.shape
    k = cfg.top_k
    n = B * L * k
    dev = xb.device
    flat_idx = idxb.reshape(n)
    local_e = flat_idx - first
    is_mine = (local_e >= 0) & (local_e < E_local)
    key = torch.where(is_mine, local_e, E_local)
    order = torch.sort(key, stable=True).indices     # assignments by expert
    ends = torch.searchsorted(key[order], torch.arange(
        E_local, device=dev, dtype=key.dtype), right=True)
    starts = ends - torch.diff(ends, prepend=ends.new_zeros(1))
    sizes = ends - starts
    slot = torch.arange(C, device=dev)
    valid = slot[None, :] < sizes.clamp(max=C)[:, None]  # (E_local, C)
    src = order[(starts[:, None] + slot[None, :]).clamp(max=n - 1)]
    # Each token k times, gathered by assignment: a kept slot reads its own
    # assignment's row, so the backward sees each kept index once.
    xk = xb.reshape(-1, 1, d).expand(-1, k, -1).reshape(n, d)
    xB = xk[src] * valid[..., None].to(xb.dtype)     # (E_local, C, d)
    h = torch.bmm(xB, w13.to(xb.dtype))
    g, u = h.chunk(2, dim=-1)
    act = (F.silu(g.float()) * u.float()).to(xb.dtype)
    y = torch.bmm(act, w2.to(xb.dtype)).reshape(E_local * C, d)
    # Back to the assignments: an assignment's slot is its rank among its
    # expert's assignments; it is kept when that rank is under C.
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    rank = rank - torch.cat([starts, ends[-1:]])[key]
    kept = is_mine & (rank < C)
    row = key.clamp(max=E_local - 1) * C + rank.clamp(0, C - 1)
    out = y[row].float() * wb.reshape(n).float()[:, None]
    out = torch.where(kept[:, None], out, 0.0)
    out = out.view(B * L, k, d).sum(1).to(xb.dtype).view(B, L, d)
    dropped = (is_mine & ~kept).to(torch.int32).view(B, L, k)
    return out, dropped


def _router_local(k: int, x, w_router):
    """One shard's routing (``router_topk``'s) over its tokens: (idx,
    weights, the probabilities' sum over the tokens (E,), the top-k counts
    per expert (E,)); the aux loss needs the last two summed over every
    token."""
    probs = torch.softmax(x.float() @ w_router.float(), dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    E = w_router.shape[-1]
    experts = torch.arange(E, device=x.device)
    counts = (idx.reshape(-1, k, 1) == experts).float().sum(1).sum(0)
    return idx, w.to(x.dtype), probs.reshape(-1, E).sum(0), counts


def _moe_ffn_mesh(cfg: LMConfig, p, x, dist: Dist):
    """The reference's expert-parallel ``moe_ffn`` over ``dist.mesh``
    (module docstring).  Returns (out, aux, dropped)."""
    from torch.distributed.tensor import Partial, Replicate
    m, b = dist.model_axis, dist.batch
    B, L, _ = x.shape
    k, E = cfg.top_k, cfg.n_experts
    x_pl = dist.placements(b, None, None)
    r_pl = dist.placements(None, None)
    sums = dist.swap([Replicate()] * dist.mesh.ndim, dist.batch_axes,
                     Partial())
    idx, weights, psum, counts = dist.local_map(
        functools.partial(_router_local, k), out=(x_pl, x_pl, sums, sums),
        ins=(x_pl, r_pl), grads=(x_pl, dist.batch_partial(r_pl)))(
        x, dist.gathered(p["router"]))
    # Load-balance aux loss (Switch-style): E * sum_e f_e * p_e.
    aux = E * torch.sum((psum / (B * L)) * (counts / (B * L) / k))
    msize = dist.size(m)
    E_local = E // msize
    bshard = 1
    for a in dist.batch_axes:
        bshard *= dist.size(a)
    C = capacity(cfg, (B // bshard) * L)
    w_pl = dist.placements(m, None, None)
    part = dist.swap(x_pl, (m,), Partial())
    fn = functools.partial(_capacity_local, cfg, E_local, C,
                           dist.rank(m) * E_local)
    out, dropped = dist.local_map(
        fn, out=(part, part), ins=(x_pl, x_pl, x_pl, w_pl, w_pl),
        grads=(part, x_pl, part, dist.batch_partial(w_pl),
               dist.batch_partial(w_pl)))(
        x, idx, weights, dist.gathered(p["w13"]), dist.gathered(p["w2"]))
    return dist.wsc(out, b, None, None), aux, dist.wsc(dropped, b, None, None)


def moe_ffn(cfg: LMConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
            mesh=None, batch_axes=("data",), model_axis: str = "model",
            data_axis: str = "data", fsdp_axes=None,
            return_dropped: bool = False):
    """x (B, L, d) -> ((B, L, d) routed experts' output, aux loss).

    p: {'router': (d, E), 'w13': (E, d, 2f), 'w2': (E, f, d)}.  Without a
    mesh it computes the mesh-free function of the reference
    (``moe_ffn_dense_ref``): dropless top-k routing, the experts' SwiGLU
    with the activation in fp32, the outputs weighted by the router and
    summed over k in fp32; routed over grouped GEMMs (the module
    docstring).  With ``mesh`` (x and p DTensors laid out by
    ``transformer.param_specs``) it is the expert-parallel function with
    its per-expert capacity.  ``return_dropped`` adds a third result, the
    (B, L, k) int32 dropped assignments (1 = dropped; all 0 without a
    mesh)."""
    if mesh is not None:
        dist = Dist(mesh, tuple(batch_axes), model_axis, data_axis,
                    fsdp_axes=tuple(fsdp_axes or ()))
        out, aux, dropped = _moe_ffn_mesh(cfg, p, x, dist)
        return (out, aux, dropped) if return_dropped else (out, aux)
    idx, weights, aux = router_topk(x, p["router"], cfg.top_k)
    B, L, d = x.shape
    k, E = cfg.top_k, cfg.n_experts
    xf = x.reshape(-1, d)
    n = xf.shape[0] * k
    flat = idx.reshape(n)
    order = torch.sort(flat, stable=True).indices     # assignments by expert
    experts = torch.arange(E, device=x.device, dtype=flat.dtype)
    ends = torch.searchsorted(flat[order], experts, right=True,
                              out_int32=True)         # cumulative sizes
    # Each token k times, then the assignments in expert order: a gather
    # by a permutation, whose backward sees each index once (the gradient
    # repeats bit for bit; gathering ``xf[order // k]`` would accumulate
    # repeated indices).
    xk = xf[:, None].expand(-1, k, -1).reshape(n, d)
    h = _grouped(xk[order], p["w13"].to(x.dtype), ends)
    g, u = h.chunk(2, dim=-1)
    act = (F.silu(g.float()) * u.float()).to(x.dtype)
    y = _grouped(act, p["w2"].to(x.dtype), ends)
    y = y.float() * weights.reshape(n)[order].float()[:, None]
    back = torch.empty_like(order)
    back[order] = torch.arange(n, device=x.device)    # the inverse permutation
    out = y[back].view(-1, k, d).sum(1).to(x.dtype).reshape(B, L, d)
    if return_dropped:
        return out, aux, torch.zeros_like(idx, dtype=torch.int32)
    return out, aux


def moe_ffn_dense_ref(cfg: LMConfig, p: Dict[str, torch.Tensor],
                      x: torch.Tensor):
    """Oracle: every expert on every token, one-hot combine (the
    reference's ``moe_ffn_dense_ref``; tests and ``chip_smoke.py`` only)."""
    idx, weights, aux = router_topk(x, p["router"], cfg.top_k)
    B, L, d = x.shape
    xf = x.reshape(-1, d)
    h = torch.einsum("td,edf->tef", xf, p["w13"].to(x.dtype))
    g, u = h.chunk(2, dim=-1)
    act = F.silu(g.float()) * u.float()
    y = torch.einsum("tef,efd->ted", act.to(xf.dtype), p["w2"].to(x.dtype))
    comb = torch.zeros((xf.shape[0], cfg.n_experts), dtype=x.dtype,
                       device=x.device)
    comb.scatter_add_(1, idx.reshape(-1, cfg.top_k),
                      weights.reshape(-1, cfg.top_k))
    out = torch.einsum("te,ted->td", comb, y)
    return out.reshape(B, L, d), aux
