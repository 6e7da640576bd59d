"""xLSTM stack (arXiv:2405.04517) on one device: mLSTM blocks (chunkwise
parallel) with interleaved sLSTM blocks (a sequential scan), the xlstm-1.3b
arch.

The torch counterpart of ``repro.models.xlstm``.

mLSTM, the matrix-memory LSTM.  Per head
    C_t = f_t C_{t-1} + i_t (k_t (x) v_t),   n_t = f_t n_{t-1} + i_t k_t,
    y_t = (q_t . C_t) / max(|q_t . n_t|, 1)
is the SSD recurrence with B <- k, xbar <- i*v, C <- q, loga <- log f, so a
prompt runs the chunked SSD scan with per-head B and C
(:func:`_ssd_chunked_heads`), and ``n`` goes through the same scan as a
width-1 value channel.  The input gate is i = exp(min(itilde, ICLAMP)) in
fp32, the reference's clamp in place of a running-max stabilizer.  A decode
step updates the matrix memory of the cache IN PLACE (``C *= f``, then
``C += (i k) (x) v``: the functional form's two roundings, in its order,
as two kernels, so no multiply-add is contracted).

sLSTM, the scalar-memory LSTM with block-diagonal recurrence, exponential
gating and the m-state stabilizer, runs as a Python loop over time.

Serving state (``init_cache``): ``mC`` (mLSTM layers, B, H, P, P) and
``mn`` (.., H, P) fp32; ``sh``/``sc``/``sn``/``sm`` (sLSTM layers, B, H,
P_s) fp32 with ``sn`` starting at 1; ``len``.  ``decode_step`` updates the
cache's tensors in place and returns them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models.common import (Dist, LMConfig, P, _dtype_scale,
                                       dense_init, rms_norm, sharded_ce_loss)
from repro_torch.models.ssm import _ssd_chunked_heads
from repro_torch.models.transformer import _embed, _unembed, vocab_padded

ICLAMP = 8.0
_SLSTM_KEYS = ("sh", "sc", "sn", "sm")


# ------------------------------------------------------------------- mLSTM
def _hdims(cfg: LMConfig):
    din = cfg.ssm_expand * cfg.d_model if cfg.ssm_expand else 2 * cfg.d_model
    H = cfg.n_heads
    P = din // H
    return din, H, P


def _mlstm_shapes_fixed(cfg: LMConfig):
    d = cfg.d_model
    din, H, P = _hdims(cfg)
    return {
        "norm": (d,),
        "up": (d, 2 * din),
        "wq": (din, din), "wk": (din, din), "wv": (din, din),
        "w_if": (din, 2 * H),
        "down": (din, d),
    }


def mlstm_forward(cfg: LMConfig, p, x, state=None):
    """x (B, L, d) -> (out, (C, n)): C (B, H, P, P) matrix memory, n (B, H,
    P).  With ``state`` = (C, n) and L == 1, the recurrent step, which
    updates ``C`` in place and returns it; otherwise the chunked scan from
    ``state`` (zeros when None)."""
    Bz, L, d = x.shape
    din, H, P = _hdims(cfg)
    h = rms_norm(x, p["norm"].to(x.dtype), cfg.norm_eps)
    up = h @ p["up"].to(h.dtype)
    xm, z = up.chunk(2, dim=-1)
    scale = _dtype_scale(P ** -0.5, h.dtype)
    q = (xm @ p["wq"].to(h.dtype)).reshape(Bz, L, H, P) * scale
    k = (xm @ p["wk"].to(h.dtype)).reshape(Bz, L, H, P) * scale
    v = (xm @ p["wv"].to(h.dtype)).reshape(Bz, L, H, P)
    gif = (xm @ p["w_if"].to(h.dtype)).float().reshape(Bz, L, H, 2)
    it, ft = gif[..., 0], gif[..., 1]
    logf = F.logsigmoid(ft)                                   # (B,L,H)
    i = torch.exp(torch.clamp(it, max=ICLAMP))                # (B,L,H)

    kf, vf, qf = k.float(), v.float(), q.float()
    if state is not None and L == 1:
        C, n0 = state
        f1 = torch.exp(logf[:, 0])                            # (B,H)
        ik = i[:, 0][:, :, None] * kf[:, 0]                   # (B,H,P)
        C.mul_(f1[:, :, None, None])
        C.add_(ik[..., :, None] * vf[:, 0][..., None, :])     # (B,H,P,P)
        nn = n0 * f1[:, :, None] + ik
        num = torch.einsum("bhp,bhpq->bhq", qf[:, 0], C)
        den = torch.abs(torch.einsum("bhp,bhp->bh", qf[:, 0], nn))
        y = (num / torch.clamp(den, min=1.0)[..., None])[:, None]
        Sn, nn_out = C, nn
    else:
        # Chunkwise: S carries (B,H,N=P,P); n via a width-1 value channel.
        xbar = vf * i[..., None]
        y_num, Sn = _ssd_chunked_heads(
            xbar, logf, kf, qf, state0=None if state is None else state[0])
        n_y, nn_out = _ssd_chunked_heads(
            i[..., None], logf, kf, qf,
            state0=None if state is None else state[1][..., None])
        nn_out = nn_out[..., 0]
        den = torch.abs(n_y[..., 0])
        y = y_num / torch.clamp(den, min=1.0)[..., None]

    y = y.reshape(Bz, L, din).to(x.dtype)
    y = y * F.silu(z)
    return x + y @ p["down"].to(x.dtype), (Sn, nn_out)


# ------------------------------------------------------------------- sLSTM
def slstm_shapes(cfg: LMConfig):
    d = cfg.d_model
    H = cfg.n_heads
    P = d // H
    return {
        "norm": (d,),
        "w_in": (d, 4 * d),               # z, i, f, o pre-activations
        "r": (H, P, 4 * P),               # block-diagonal recurrent weights
        "bias": (4 * d,),
        "out": (d, d),
    }


def slstm_forward(cfg: LMConfig, p, x, state=None):
    """x (B, L, d) -> (out, (h, c, n, m)), each state (B, H, P) fp32, with
    the exponential-gate stabilizer m; a Python loop over the L steps."""
    Bz, L, d = x.shape
    H = cfg.n_heads
    P = d // H
    xin = rms_norm(x, p["norm"].to(x.dtype), cfg.norm_eps)
    pre = (xin @ p["w_in"].to(x.dtype) + p["bias"].to(x.dtype)).float()
    pre = pre.reshape(Bz, L, H, 4 * P)

    if state is None:
        zeros = torch.zeros((Bz, H, P), dtype=pre.dtype, device=x.device)
        h, c, n, m = zeros, zeros, torch.ones_like(zeros), zeros
    else:
        h, c, n, m = state
    r = p["r"].float()
    ys = []
    for t in range(L):
        rec = torch.einsum("bhp,hpq->bhq", h, r)              # (B,H,4P)
        g = pre[:, t] + rec
        z_, i_, f_, o_ = g.chunk(4, dim=-1)
        z = torch.tanh(z_)
        o = torch.sigmoid(o_)
        logf_m = F.logsigmoid(f_) + m
        m_new = torch.maximum(logf_m, i_)
        ig = torch.exp(i_ - m_new)
        fg = torch.exp(logf_m - m_new)
        c = fg * c + ig * z
        n = fg * n + ig
        h = o * c / torch.clamp(n, min=1e-6)
        m = m_new
        ys.append(h)
    y = torch.stack(ys, dim=1).reshape(Bz, L, d).to(x.dtype)
    return x + y @ p["out"].to(x.dtype), (h, c, n, m)


# -------------------------------------------------------------------- stack
def _layer_kinds(cfg: LMConfig):
    if not cfg.slstm_every:
        return ["m"] * cfg.n_layers
    return ["s" if (i + 1) % cfg.slstm_every == 0 else "m"
            for i in range(cfg.n_layers)]


def _init_stack(gen: torch.Generator, shapes, n: int, dtype, dev):
    """Norms ones, biases zeros, the rest Normal(0, 1/sqrt(shape[-2])), each
    layer's slice drawn in fp32 and cast into the stack."""
    out = {}
    for name, shp in shapes.items():
        if name == "norm":
            out[name] = torch.ones((n,) + shp, dtype=dtype, device=dev)
        elif name == "bias":
            out[name] = torch.zeros((n,) + shp, dtype=dtype, device=dev)
        else:
            out[name] = torch.empty((n,) + shp, dtype=dtype, device=dev)
            for i in range(n):
                out[name][i] = torch.randn(shp, generator=gen,
                                           device=gen.device).mul_(
                                               shp[-2] ** -0.5)
    return out


def init_params(cfg: LMConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = "cuda") -> Dict:
    """Random parameters with the reference's keys, shapes and scales
    (``params["mlstm"]``, ``params["slstm"]`` stacked per kind).  The
    numbers differ from ``jax.random``'s; carry the reference's across with
    ``transformer.params_from_jax``."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    vp, pdt = vocab_padded(cfg), cfg.param_dtype
    kinds = _layer_kinds(cfg)
    nm, ns = kinds.count("m"), kinds.count("s")
    params = {
        "embed": dense_init(gen, (vp, cfg.d_model), pdt, scale=0.02).to(dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=pdt, device=dev),
        "mlstm": _init_stack(gen, _mlstm_shapes_fixed(cfg), nm, pdt, dev),
    }
    if ns:
        params["slstm"] = _init_stack(gen, slstm_shapes(cfg), ns, pdt, dev)
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (cfg.d_model, vp), pdt,
                                       scale=0.02).to(dev)
    return params


def param_specs(cfg: LMConfig, dist: Dist) -> Dict:
    """Each parameter's spec, the reference's leaf for leaf."""
    m, da = dist.model_axis, dist.data_axis
    specs = {
        "embed": P(None, m), "final_norm": P(None),
        "mlstm": {
            "norm": P(None, None), "up": P(None, da, m),
            "wq": P(None, da, m), "wk": P(None, da, m), "wv": P(None, da, m),
            "w_if": P(None, da, None), "down": P(None, m, da),
        },
    }
    if "s" in _layer_kinds(cfg):
        specs["slstm"] = {
            "norm": P(None, None), "w_in": P(None, da, m),
            "r": P(None, None, None, None), "bias": P(None, m),
            "out": P(None, da, m),
        }
    if not cfg.tie_embeddings:
        specs["unembed"] = P(da, m)
    return specs


def _layers(cfg: LMConfig, params):
    """(kind, index in its stack, weights) for each layer in order; each
    stack unbound once."""
    split = {kind: {name: t.unbind(0) for name, t in params[key].items()}
             for kind, key in (("m", "mlstm"), ("s", "slstm"))
             if key in params}
    seen = {"m": 0, "s": 0}
    out = []
    for kind in _layer_kinds(cfg):
        j = seen[kind]
        out.append((kind, j, {name: t[j] for name, t in split[kind].items()}))
        seen[kind] += 1
    return out


def _layer_out(cfg, kind, p, x):
    fwd = mlstm_forward if kind == "m" else slstm_forward
    return fwd(cfg, p, x)[0]


def forward(cfg: LMConfig, params, batch: Dict):
    """Teacher-forced logits (B, L, vocab_padded) and aux 0.0.  With
    ``cfg.remat`` and grad on, each layer is checkpointed."""
    x = _embed(cfg, params, batch["tokens"])
    remat = cfg.remat and torch.is_grad_enabled()
    for kind, _, p in _layers(cfg, params):
        x = (checkpoint(_layer_out, cfg, kind, p, x, use_reentrant=False)
             if remat else _layer_out(cfg, kind, p, x))
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _unembed(cfg, params, x), 0.0


def loss_fn(cfg: LMConfig, params, batch: Dict):
    logits, _ = forward(cfg, params, batch)
    return sharded_ce_loss(logits, batch["labels"].long())


# ------------------------------------------------------------------ serving
def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: DeviceLike = "cuda"):
    """The recurrent state of ``batch`` rows (``max_len`` bounds nothing
    here: the state does not grow)."""
    dev = resolve_device(device)
    din, H, P = _hdims(cfg)
    kinds = _layer_kinds(cfg)
    nm, ns = kinds.count("m"), kinds.count("s")
    f32 = dict(dtype=torch.float32, device=dev)
    cache = {
        "mC": torch.zeros((nm, batch, H, P, P), **f32),
        "mn": torch.zeros((nm, batch, H, P), **f32),
        "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }
    if ns:
        shp = (ns, batch, cfg.n_heads, cfg.d_model // cfg.n_heads)
        cache.update({key: (torch.ones(shp, **f32) if key == "sn"
                            else torch.zeros(shp, **f32))
                      for key in _SLSTM_KEYS})
    return cache


def _run_layers(cfg: LMConfig, params, x, cache):
    """Every layer from the state in ``cache``, whose tensors receive the
    new state in place.  Returns the last hidden state."""
    for kind, j, p in _layers(cfg, params):
        if kind == "m":
            C, n = cache["mC"][j], cache["mn"][j]
            x, (C1, n1) = mlstm_forward(cfg, p, x, state=(C, n))
            if C1 is not C:                   # the chunked scan's new state
                C.copy_(C1)
            n.copy_(n1)
        else:
            st = tuple(cache[key][j] for key in _SLSTM_KEYS)
            x, s1 = slstm_forward(cfg, p, x, state=st)
            for old, new in zip(st, s1):
                old.copy_(new)
    return x


def prefill(cfg: LMConfig, params, batch: Dict, max_len: int):
    """The prompt at its exact length -> (logits of its last position,
    decode-ready cache).  There is no ``lengths``: a pad token would pass
    through the recurrent state."""
    x = _embed(cfg, params, batch["tokens"])
    B, L, _ = x.shape
    cache = init_cache(cfg, B, max_len, device=x.device)
    x = _run_layers(cfg, params, x, cache)
    cache["len"].fill_(L)
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _unembed(cfg, params, x[:, -1:]), cache


def decode_step(cfg: LMConfig, params, tokens, cache):
    """tokens (B, 1) -> (logits (B, 1, V), cache'): the cache's tensors are
    updated in place; the returned cache holds them and ``len + 1``."""
    x = _embed(cfg, params, tokens)
    x = _run_layers(cfg, params, x, cache)
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _unembed(cfg, params, x), {**cache, "len": cache["len"] + 1}
