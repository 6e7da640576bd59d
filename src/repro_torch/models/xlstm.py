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

Under a mesh (``dist``) every entry point runs (:func:`_mlstm_mesh`,
:func:`_slstm_mesh`): the projections TP over ``model`` with the
reference's two mLSTM constraints; the mLSTM's chunk products q.k formed
from each shard's own columns and summed over ``model``, then each shard
scans the value columns ``cache_specs`` gives its ``mC`` (P / model of
every head); the sLSTM recurrence whole on every shard (its recurrent
matrix is replicated, as the reference's spec has it).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models.common import (NO_DIST, Dist, LMConfig, P,
                                       checkpointed,
                                       _dtype_scale, dense_init, local_device,
                                       rms_norm, sharded_ce_loss)
from repro_torch.models.ssm import _ssd_chunked_heads, chunk_qk
from repro_torch.models.transformer import (_embed, _from_local,
                                            _stack_layers, _unembed,
                                            vocab_padded)

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


def mlstm_forward(cfg: LMConfig, p, x, state=None, dist: Dist = NO_DIST,
                  layer=None):
    """x (B, L, d) -> (out, (C, n)): C (B, H, P, P) matrix memory, n (B, H,
    P).  With ``state`` = (C, n) and L == 1, the recurrent step, which
    updates ``C`` in place and returns it; otherwise the chunked scan from
    ``state`` (zeros when None).  Under ``dist.mesh``:
    :func:`_mlstm_mesh`."""
    if dist.mesh is not None:
        return _mlstm_mesh(cfg, p, x, dist, state, layer)
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


def slstm_forward(cfg: LMConfig, p, x, state=None, dist: Dist = NO_DIST,
                  layer=None):
    """x (B, L, d) -> (out, (h, c, n, m)), each state (B, H, P) fp32, with
    the exponential-gate stabilizer m; a Python loop over the L steps.
    Under ``dist.mesh``: :func:`_slstm_mesh`."""
    if dist.mesh is not None:
        return _slstm_mesh(cfg, p, x, dist, state, layer)
    xin = rms_norm(x, p["norm"].to(x.dtype), cfg.norm_eps)
    pre = (xin @ p["w_in"].to(x.dtype) + p["bias"].to(x.dtype)).float()
    y, st = _slstm_scan(cfg, pre, p["r"], state)
    return x + y.to(x.dtype) @ p["out"].to(x.dtype), st


def _slstm_scan(cfg: LMConfig, pre, r, state=None):
    """The sLSTM recurrence over the pre-activations ``pre`` (B, L, 4d)
    fp32 from ``state`` (the initial state when None) -> (y (B, L, d)
    fp32, (h, c, n, m))."""
    Bz, L, d = pre.shape[0], pre.shape[1], pre.shape[2] // 4
    H = cfg.n_heads
    P = d // H
    pre = pre.reshape(Bz, L, H, 4 * P)
    if state is None:
        zeros = torch.zeros((Bz, H, P), dtype=pre.dtype, device=pre.device)
        h, c, n, m = zeros, zeros, torch.ones_like(zeros), zeros
    else:
        h, c, n, m = state
    r = r.float()
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
    return torch.stack(ys, dim=1).reshape(Bz, L, d), (h, c, n, m)


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


def _layer_out(cfg, kind, p, x, dist=NO_DIST):
    fwd = mlstm_forward if kind == "m" else slstm_forward
    return fwd(cfg, p, x, dist=dist)[0]


def forward(cfg: LMConfig, params, batch: Dict, dist: Dist = NO_DIST):
    """Teacher-forced logits (B, L, vocab_padded) and aux 0.0.  With
    ``cfg.remat`` and grad on, each layer is checkpointed.  Under
    ``dist.mesh`` params and batch are DTensors laid out by
    :func:`param_specs` and ``launch.sharding``."""
    x = _embed(cfg, params, batch["tokens"], dist)
    remat = cfg.remat and torch.is_grad_enabled()
    for kind, _, p in _layers(cfg, params):
        x = (checkpointed(_layer_out, cfg, kind, p, x, dist) if remat
             else _layer_out(cfg, kind, p, x, dist))
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _unembed(cfg, params, x, dist), 0.0


def loss_fn(cfg: LMConfig, params, batch: Dict, dist: Dist = NO_DIST):
    logits, _ = forward(cfg, params, batch, dist)
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


def prefill(cfg: LMConfig, params, batch: Dict, max_len: int,
            dist: Dist = NO_DIST):
    """The prompt at its exact length -> (logits of its last position,
    decode-ready cache).  There is no ``lengths``: a pad token would pass
    through the recurrent state.  Under ``dist.mesh``:
    :func:`_prefill_mesh`."""
    if dist.mesh is not None:
        return _prefill_mesh(cfg, params, batch, max_len, dist)
    x = _embed(cfg, params, batch["tokens"])
    B, L, _ = x.shape
    cache = init_cache(cfg, B, max_len, device=x.device)
    x = _run_layers(cfg, params, x, cache)
    cache["len"].fill_(L)
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _unembed(cfg, params, x[:, -1:]), cache


def decode_step(cfg: LMConfig, params, tokens, cache, dist: Dist = NO_DIST):
    """tokens (B, 1) -> (logits (B, 1, V), cache'): the cache's tensors are
    updated in place; the returned cache holds them and ``len + 1``.  Under
    ``dist.mesh``: :func:`_decode_mesh`."""
    if dist.mesh is not None:
        return _decode_mesh(cfg, params, tokens, cache, dist)
    x = _embed(cfg, params, tokens)
    x = _run_layers(cfg, params, x, cache)
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _unembed(cfg, params, x), {**cache, "len": cache["len"] + 1}


# ------------------------------------------------------------- under a mesh
def _mlstm_layout(cfg: LMConfig, dist: Dist):
    """(pv, qk) for :func:`_mlstm_mesh`: ``pv`` the value columns of every
    head this shard runs (a slice; all of them when ``model`` does not
    divide P), and ``qk`` (first head, heads) of the q/k columns the
    shard's TP split holds, when they are whole heads or a part of one
    head (so the chunk products split over ``model`` and sum), else
    None."""
    din, H, P = _hdims(cfg)
    msize, r = dist.size(dist.model_axis), dist.rank(dist.model_axis)
    pv = slice(0, P)
    if msize > 1 and P % msize == 0:
        w = P // msize
        pv = slice(r * w, (r + 1) * w)
    W = din // msize
    qk = None
    if msize > 1 and din % msize == 0 and (W % P == 0 or P % W == 0):
        qk = (r * W // P, max(1, W // P))
    return pv, qk


def _qk_local(cfg: LMConfig, heads, q, k):
    """This shard's part of the chunk products (:func:`ssm.chunk_qk`):
    q, k (B, L, W) its TP columns, which are the heads ``heads`` = (first,
    count) or part of one head; the other heads' products are 0, so the
    parts sum over ``model`` to the products."""
    din, H, P = _hdims(cfg)
    Bz, L, W = q.shape
    h0, hn = heads
    part = chunk_qk(k.reshape(Bz, L, hn, W // hn).float(),
                    q.reshape(Bz, L, hn, W // hn).float())
    if hn == H:
        return part
    out = part.new_zeros(part.shape[:-1] + (H,))
    out[..., h0:h0 + hn] = part
    return out


def _mlstm_local(cfg: LMConfig, pv, layer, qk, q, k, v, gif, C=None,
                 n=None):
    """One shard's mLSTM between the projections: q, k, v (B, L, din)
    whole (q and k scaled), gif (B, L, 2H) fp32, ``qk`` the chunk
    products or None.  The shard runs the value columns ``pv`` of every
    head: it returns y (B, L, H, pv) and the state (C (B, H, P, pv), n
    (B, H, P) whole), or with the stacked caches (decode: ``C`` this
    shard's, ``n`` whole) updates layer ``layer``'s in place and returns
    y."""
    din, H, P = _hdims(cfg)
    Bz, L, _ = q.shape
    qf = q.reshape(Bz, L, H, P).float()
    kf = k.reshape(Bz, L, H, P).float()
    vf = v.reshape(Bz, L, H, P)[..., pv].float()
    gif = gif.reshape(Bz, L, H, 2)
    logf = F.logsigmoid(gif[..., 1])
    i = torch.exp(torch.clamp(gif[..., 0], max=ICLAMP))
    if C is not None and L == 1:
        Cl, n0 = C[layer], n[layer]
        f1 = torch.exp(logf[:, 0])
        ik = i[:, 0][:, :, None] * kf[:, 0]
        Cl.mul_(f1[:, :, None, None])
        Cl.add_(ik[..., :, None] * vf[:, 0][..., None, :])
        nn = n0 * f1[:, :, None] + ik
        num = torch.einsum("bhp,bhpq->bhq", qf[:, 0], Cl)
        den = torch.abs(torch.einsum("bhp,bhp->bh", qf[:, 0], nn))
        n0.copy_(nn)
        return (num / torch.clamp(den, min=1.0)[..., None])[:, None]
    xbar = vf * i[..., None]
    y_num, Sn = _ssd_chunked_heads(xbar, logf, kf, qf, qk=qk)
    n_y, nn = _ssd_chunked_heads(i[..., None], logf, kf, qf, qk=qk)
    y = y_num / torch.clamp(torch.abs(n_y[..., 0]), min=1.0)[..., None]
    return y, Sn, nn[..., 0]


def _mlstm_mesh(cfg: LMConfig, p, x, dist: Dist, state=None, layer=None):
    """An mLSTM block under a mesh, the reference's two constraints
    (``xlstm.py:49``, ``:88``): ``up`` TP over ``model`` and gathered
    whole, the q/k/v projections TP over ``model``; the chunk products
    q.k formed from each shard's own columns and summed over ``model``
    (:func:`_qk_local`); then q, k, v gathered whole and each shard runs
    the value columns ``cache_specs`` gives it (P / model of every head)
    through the scan; y gathered whole, gated, into ``down`` (rows TP) and
    reduced.  Without caches returns (out, (C, n)) laid out as
    ``cache_specs`` lays them; with the stacked caches (decode: ``C`` as
    laid out, ``n`` whole on ``model``) they are updated in place and
    (out, None) returned."""
    from torch.distributed.tensor import Partial
    m, b = dist.model_axis, dist.batch
    din, H, P = _hdims(cfg)
    pv, qk_heads = _mlstm_layout(cfg, dist)
    split = pv.stop - pv.start < P
    h = rms_norm(x, p["norm"].to(x.dtype), cfg.norm_eps)
    up = dist.wsc(h @ dist.gathered(p["up"]).to(h.dtype), b, None, m)
    xm, z = dist.wsc(up, b, None, None).chunk(2, dim=-1)
    scale = _dtype_scale(P ** -0.5, h.dtype)
    q = dist.wsc(xm @ dist.gathered(p["wq"]).to(h.dtype), b, None, m) * scale
    k = dist.wsc(xm @ dist.gathered(p["wk"]).to(h.dtype), b, None, m) * scale
    v = dist.wsc(xm @ dist.gathered(p["wv"]).to(h.dtype), b, None, m)
    gif = dist.wsc((xm @ dist.gathered(p["w_if"]).to(h.dtype)).float(),
                   b, None, None)
    sh_pl = dist.placements(b, None, m)
    whole = dist.placements(b, None, None)
    qk = None
    qk_pl = dist.placements(b, None, None, None, None)
    if qk_heads is not None and state is None:
        part = dist.swap(qk_pl, (m,), Partial())
        qk = dist.local_map(functools.partial(_qk_local, cfg, qk_heads),
                            out=part, ins=(sh_pl, sh_pl))(q, k)
        qk = dist.wsc(qk, b, None, None, None, None)
    q, k, v = (dist.wsc(t, b, None, None) for t in (q, k, v))

    def used_in_part(pl):
        """The gradient placements of an input each shard uses a part of:
        partial over ``model`` where the shards run different columns."""
        return dist.swap(pl, (m,), Partial()) if split else pl
    y_pl = dist.placements(b, None, None, m if split else None)
    fn = functools.partial(_mlstm_local, cfg, pv, layer)
    ins, args = [whole] * 4, [q, k, v, gif]
    if qk is None:
        fn = functools.partial(fn, None)
    else:
        ins, args = [qk_pl] + ins, [qk] + args
    if state is None:
        c_pl = dist.placements(b, None, None, m if split else None)
        y, C, n = dist.local_map(
            fn, out=(y_pl, c_pl, whole), ins=ins,
            grads=[used_in_part(pl) for pl in ins])(*args)
        kept = (C, n)
    else:
        C, n = state
        y = dist.local_map(fn, out=y_pl, ins=ins + [
            list(C.placements), list(n.placements)])(*args, C, n)
        kept = None
    y = dist.wsc(y, b, None, None, None).reshape(y.shape[0], y.shape[1], din)
    y = y.to(x.dtype) * F.silu(z)
    y = dist.wsc(y, b, None, m)
    out = y @ dist.gathered(p["down"]).to(x.dtype)
    return x + dist.wsc(out, b, None, None), kept


def _slstm_local(cfg: LMConfig, layer, pre, r, *state):
    """One shard's sLSTM recurrence (the whole of it: ``model`` does not
    split it): from the initial state, or with the stacked states
    (decode: whole on ``model``) from layer ``layer``'s, updated in
    place."""
    if not state:
        y, st = _slstm_scan(cfg, pre, r)
        return (y,) + st
    cur = tuple(t[layer] for t in state)
    y, st = _slstm_scan(cfg, pre, r, cur)
    for old, new in zip(cur, st):
        old.copy_(new)
    return y


def _slstm_mesh(cfg: LMConfig, p, x, dist: Dist, state=None, layer=None):
    """An sLSTM block under a mesh: ``w_in`` and ``out`` TP over ``model``
    (the pre-activations gathered whole), the recurrence on every shard of
    its batch rows (its block-diagonal ``r`` is replicated, as the
    reference's spec has it).  Returns (out, (h, c, n, m) whole on
    ``model``), or with the stacked states (decode) updates them in place
    and returns (out, None)."""
    from torch.distributed.tensor import Replicate
    b = dist.batch
    xin = rms_norm(x, p["norm"].to(x.dtype), cfg.norm_eps)
    pre = (xin @ dist.gathered(p["w_in"]).to(x.dtype)
           + dist.gathered(p["bias"]).to(x.dtype)).float()
    pre = dist.wsc(pre, b, None, None)
    rep = [Replicate()] * dist.mesh.ndim
    r = dist.gathered(p["r"]).redistribute(dist.mesh, rep)
    whole = dist.placements(b, None, None)
    st_pl = dist.placements(b, None, None)
    fn = functools.partial(_slstm_local, cfg, layer)
    if state is None:
        y, *st = dist.local_map(
            fn, out=tuple([whole] + [st_pl] * 4), ins=(whole, rep),
            grads=(whole, dist.batch_partial(rep)))(pre, r)
        kept = tuple(st)
    else:
        y = dist.local_map(fn, out=whole, ins=[whole, rep] + [
            list(t.placements) for t in state])(pre, r, *state)
        kept = None
    out = y.to(x.dtype) @ dist.gathered(p["out"]).to(x.dtype)
    return x + dist.wsc(out, b, None, None), kept


def _prefill_mesh(cfg: LMConfig, params, batch: Dict, max_len: int,
                  dist: Dist):
    """:func:`prefill` under a mesh: the states laid out by
    ``launch.sharding.cache_specs``, ``len`` replicated."""
    from torch.distributed.tensor import Replicate
    from repro_torch.launch.sharding import cache_specs
    from repro_torch.models.common import ShapeCfg
    x = _embed(cfg, params, batch["tokens"], dist)
    B, L, _ = x.shape
    specs = cache_specs(cfg, ShapeCfg("prefill", max_len, B, "prefill"),
                        dist)
    got = {key: [] for key in ("mC", "mn") + _SLSTM_KEYS}
    for kind, _, p in _layers(cfg, params):
        if kind == "m":
            x, (C, n) = mlstm_forward(cfg, p, x, dist=dist)
            got["mC"].append(C)
            got["mn"].append(n)
        else:
            x, st = slstm_forward(cfg, p, x, dist=dist)
            for key, t in zip(_SLSTM_KEYS, st):
                got[key].append(t)
    cache = {key: _stack_layers(dist, parts, specs[key])
             for key, parts in got.items() if parts}
    cache["len"] = _from_local(dist, torch.full(
        (B,), L, dtype=torch.int32, device=local_device(x)), (B,),
        [Replicate()] * dist.mesh.ndim)
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _unembed(cfg, params, x[:, -1:], dist), cache


def _decode_mesh(cfg: LMConfig, params, tokens, cache, dist: Dist):
    """:func:`decode_step` under a mesh: ``mC`` updated in place shard by
    shard; ``mn`` and the sLSTM states, which a shard reads whole, through
    copies whole on ``model``, written back."""
    x = _embed(cfg, params, tokens, dist)
    b = dist.batch
    keys = ["mn"] + [k for k in _SLSTM_KEYS if k in cache]
    whole = {k: dist.wsc(cache[k], None, b, None, None)
             for k in keys}
    for kind, j, p in _layers(cfg, params):
        if kind == "m":
            x, _ = mlstm_forward(cfg, p, x, (cache["mC"], whole["mn"]),
                                 dist, j)
        else:
            x, _ = slstm_forward(cfg, p, x, tuple(
                whole[k] for k in _SLSTM_KEYS), dist, j)
    for k in keys:
        cache[k].to_local().copy_(whole[k].redistribute(
            dist.mesh, list(cache[k].placements)).to_local())
    x = rms_norm(x, params["final_norm"].to(cfg.dtype), cfg.norm_eps)
    return _unembed(cfg, params, x, dist), {**cache,
                                            "len": cache["len"] + 1}
