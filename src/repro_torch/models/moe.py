"""Fine-grained MoE layer (DeepSeekMoE / Kimi-K2 style) on one device.

The torch counterpart of ``repro.models.moe`` without a mesh:

  router_topk        fp32 softmax over ``x @ w_router``, top-k, weights
                     renormalised to sum 1, Switch-style aux loss
  grouped_gemm       ``jax.lax.ragged_dot``'s semantics: row i times the
                     weight of its group; rows past ``sum(group_sizes)``
                     give zero
  moe_ffn            the routed experts, dropless, on one device
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
token of a serving bucket never takes a real token's place).  The
reference's ``moe_ffn`` of the same name is the expert-parallel path under
a mesh, with a per-expert capacity that drops overflow; it agrees with this
one wherever nothing overflows, and its capacity semantics come with the
mesh slice (ROADMAP.md).

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

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import LMConfig


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


def moe_ffn(cfg: LMConfig, p: Dict[str, torch.Tensor],
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, L, d) -> ((B, L, d) routed experts' output, aux loss).

    p: {'router': (d, E), 'w13': (E, d, 2f), 'w2': (E, f, d)}.  Computes
    the mesh-free function of the reference (``moe_ffn_dense_ref``):
    dropless top-k routing, the experts' SwiGLU with the activation in
    fp32, the outputs weighted by the router and summed over k in fp32;
    routed over grouped GEMMs (the module docstring)."""
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
    out = y[back].view(-1, k, d).sum(1)
    return out.to(x.dtype).reshape(B, L, d), aux


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
