"""Faults planted under the timed path, to show that a run's comparison
catches them: each patches the program (``repro_torch``) in the running
process and returns a function that takes the patch out.  Plant one
before the program's entry is made, so a captured step captures it."""
from __future__ import annotations

import torch

FAULTS = ("state_unchanged", "half_batch", "exchange_left_out",
          "answer_altered")


def _swap(obj, name: str, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    return lambda: setattr(obj, name, old)


def _every_other_row(cap: int, device) -> torch.Tensor:
    return (torch.arange(cap, device=device) % 2 == 0).float()


def plant(name: str, kind: str):
    """Plants fault ``name`` for traffic ``kind`` ("infer" or "train").

    * ``state_unchanged``: a train step returns the parameters it was
      given; a forward keeps reading the first blocks it was given.
    * ``half_batch``: a train step's mask leaves every other vertex out,
      and the loss is the mean over the rest; a forward's outputs on every
      other row are zero.
    * ``exchange_left_out``: the halo exchange between the servers moves
      nothing (every halo row reads zero).
    * ``answer_altered``: one real vertex's first output is 1 too high,
      where the forward produces it."""
    from repro_torch.gnn import distributed as dist
    from repro_torch.gnn import training
    import repro_torch.gnn as gnn

    if name == "state_unchanged" and kind == "train":
        return _swap(training, "sgd_step",
                     lambda params, grads, lr: [dict(p) for p in params])
    if name == "state_unchanged":
        body = dist._bsp_forward
        first = {}

        def stale(cfg, params, h, ops, *a, **kw):
            if id(ops) not in first:      # the first call runs eagerly
                first[id(ops)] = h.detach().clone()
            return body(cfg, params, first[id(ops)], ops, *a, **kw)
        return _swap(dist, "_bsp_forward", stale)
    if name == "half_batch" and kind == "train":
        make = gnn.make_distributed_train_step

        def halved(cfg, fwd, labels_blocks, mask_blocks, *a, **kw):
            mask = torch.as_tensor(mask_blocks).clone()
            flat = mask.reshape(-1)
            real = torch.nonzero(flat > 0).reshape(-1)
            flat[real[1::2]] = 0.0
            return make(cfg, fwd, labels_blocks, mask, *a, **kw)
        return _swap(gnn, "make_distributed_train_step", halved)
    if name == "half_batch":
        body = dist._bsp_forward

        def halved(cfg, params, h, ops, *a, **kw):
            out = body(cfg, params, h, ops, *a, **kw)
            return out * _every_other_row(out.shape[1], out.device)[:, None]
        return _swap(dist, "_bsp_forward", halved)
    if name == "exchange_left_out":
        exchange = dist._exchange_ppermute

        def nothing(h, ops, init=None, wire=dist._OneDevice):
            return torch.zeros_like(exchange(h, ops, init, wire))
        return _swap(dist, "_exchange_ppermute", nothing)
    if name == "answer_altered":
        body = dist._bsp_forward
        bumps = {}

        def altered(cfg, params, h, ops, *a, **kw):
            out = body(cfg, params, h, ops, *a, **kw)
            key = (id(ops), tuple(out.shape))
            if key not in bumps:          # the first call runs eagerly
                ed = ops.t["edges_dst"].cpu()
                live = (ed < out.shape[1]).sum(1)
                p = int(torch.argmax(live))
                bump = torch.zeros_like(out)
                bump[p, int(ed[p, 0]), 0] = 1.0
                bumps[key] = bump
            return out + bumps[key]
        return _swap(dist, "_bsp_forward", altered)
    raise ValueError(f"unknown fault {name!r}")
