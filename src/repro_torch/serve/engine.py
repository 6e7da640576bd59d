"""Batched serving engine: continuous batching over a slot-based cache.

The torch counterpart of ``repro.serve.engine``.  One ``decode_step`` serves
all slots per tick; requests flow through
  queue -> prefill (builds the request's cache, spliced into a free slot)
  -> decode ticks (all live slots advance one token)
  -> completion (EOS / max_new_tokens / cache full) frees the slot.

Per-slot lengths ride in the cache's ``len`` vector.  For the KV-cache
families (dense, MoE) prompts are padded to power-of-two buckets, as in the
reference, where that bounded the jitted prefill's traces; the port keeps
the buckets, which bound its prefill steps the same way (one a bucket),
and both compute the same thing (pad positions are inert: attention is
causal and decode masks KV beyond ``len``).  The recurrent families
(hybrid, xLSTM) would carry a pad token through their state, and a VLM
prompt's positions are offset by its patches, so these prefill at the
prompt's exact length, as the reference does.  The engine serves a VLM
as text only: a ``Request`` carries no patches, and the reference's
engine passes none.  The enc-dec family is
refused at construction: its prefill needs ``batch["frames"]``, which a
``Request`` does not carry, so the reference's engine fails on it at the
first prefill (enc-dec is served through ``models.prefill``/
``decode_step``).  A slot receives every key of the request's cache but
``len`` (KV, SSM and conv state, mLSTM and sLSTM state).

The compiled steps.  The reference wraps ``decode_step`` and ``prefill`` in
``jax.jit``, with or without its ``dist``; the port builds a
:class:`~repro_torch.step.Step` per key: one decode step per engine,
and one prefill step per bucket for the bucketed families.
``trace_counts = {"prefill": n, "decode": m}`` counts the steps built, as
the reference counts its traces.  The exact-length families (hybrid,
xLSTM, VLM) prefill eagerly: each prompt has its own length, so a graph
would be captured for one use; they count 0 prefill builds where the
reference retraces once per distinct length.  With ``graphs`` each step is
captured into a CUDA graph after its first call (run eagerly, its results
used) and replayed from then on; all of one engine's graphs share one
memory pool.  The decode step reads the slots' tokens from a static
``(slots, 1)`` buffer, updates the cache in place (``len + 1`` written back
into the one ``cache["len"]`` tensor) and takes the argmax on the device; a
tick reads the tokens and lengths to the host once, as the reference does.
A prefill step's outputs are spliced into the slot before any other step
runs.  Without ``graphs`` the steps run eagerly on the same buffers.

``graphs=None`` resolves to True on a CUDA device, and under a mesh of
CUDA devices, unless a step would read the host: the MoE family off the
bf16 grouped_mm route (``moe.reads_host``: fp32 syncs).  ``graphs=True``
raises on the CPU, under a mesh of CPU devices (gloo) and on a
host-reading route, and a capture that fails raises: nothing falls back to
eager running.  Under a mesh the steps' buffers are DTensors (the decode
step's tokens laid out by the batch, a prefill step's tokens and lengths
replicated) and so are the cache and the prefill step's cache; a replay
runs the kernels that the captured call's DTensor dispatch launched.

Under a mesh (``dist``, the reference's argument) the engine serves
through the zoo's meshed ``prefill`` and ``decode_step``: the weights laid
out by ``param_specs`` (whole tensors are laid out, DTensors taken as they
are), the batch cache by ``launch.sharding.cache_specs`` for ``slots``
rows at ``max_len``, the slot's tokens placed by the batch.  A request's
one-row prefill runs with the batch replicated (one row does not split
over the batch axes); its cache is redistributed to the batch cache's
layout but for the batch dimension, and each process splices the slot's
row into its own shard when the slot lies in it.  ``len`` is replicated
and set on every process.

The engine runs on weights cast once to ``cfg.dtype``
(``transformer.cast_params``: the values of the reference's per-use casts;
the leaves the reference reads in fp32, and weights already in
``cfg.dtype``, are kept as they are, with no second copy).  An MoE layer
routes every token of a padded bucket, and a pad token never takes a real
token's place (``models.moe``).  On the card every attention, in prefill
and in decode, is the flash-attention kernel (K2).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch import models as zoo
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models import moe
from repro_torch.models.common import NO_DIST, Dist, LMConfig, P, ShapeCfg
from repro_torch.models.transformer import _seq_index, cast_params
from repro_torch.step import Step, capture_refusal


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (L,) int
    max_new_tokens: int = 16
    eos_id: int = 0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineStats:
    ticks: int = 0
    prefills: int = 0
    completed: int = 0
    generated_tokens: int = 0


class ServeEngine:
    """Continuous batching for every decoder-only family on one device,
    or under ``dist``'s mesh.  ``params`` lie on ``device``.  ``graphs``:
    capture the steps into CUDA graphs (None: where they can be; module
    docstring); ``engine.graphs`` holds the resolved value."""

    def __init__(self, cfg: LMConfig, params, slots: int = 4,
                 max_len: int = 256, device: DeviceLike = "cuda",
                 dist: Dist = NO_DIST, graphs: Optional[bool] = None):
        zoo.family_module(cfg)                  # raises for unknown families
        if cfg.family == "encdec":
            raise ValueError(
                f"{cfg.name}: ServeEngine serves decoder-only families; an "
                "enc-dec prefill needs batch['frames'], which a Request "
                "does not carry (use models.prefill/decode_step)")
        self.device = resolve_device(device)
        self.cfg, self.dist = cfg, dist
        eager_why = self._eager_reason()
        if graphs and eager_why:
            raise ValueError(f"{cfg.name}: ServeEngine(graphs=True) "
                             f"{eager_why}")
        self.graphs = eager_why is None if graphs is None else bool(graphs)
        self.slots = slots
        self.max_len = max_len
        self.cache = zoo.init_cache(cfg, slots, max_len, device=self.device)
        if dist.mesh is not None:
            from repro_torch.launch.sharding import cache_specs
            params = _laid_out(params, zoo.param_specs(cfg, dist), dist.mesh)
            specs = cache_specs(cfg, ShapeCfg("serve", max_len, slots,
                                              "decode"), dist)
            self.cache = {k: _laid_out(t, specs[k], dist.mesh)
                          for k, t in self.cache.items()}
            # A one-row prefill: the batch replicated.
            self._prefill_dist = Dist(
                dist.mesh, batch_axes=(), model_axis=dist.model_axis,
                data_axis=dist.data_axis, fsdp_axes=dist.fsdp_axes)
        self.params = cast_params(cfg, params)
        # Only the KV-cache families take bucketed prompts (module docstring).
        self._bucketed = cfg.family in ("dense", "moe")
        self.live: List[Optional[Request]] = [None] * slots
        self.queue: deque[Request] = deque()
        self.stats = EngineStats()
        # Steps built, by key ("decode", or ("prefill", bucket)).
        self.steps = {}
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None

    @property
    def trace_counts(self):
        """The steps built: ``{"prefill": n, "decode": m}``, the
        reference's count of its ``jax.jit`` traces."""
        decode = int("decode" in self.steps)
        return {"prefill": len(self.steps) - decode, "decode": decode}

    def _eager_reason(self) -> Optional[str]:
        """Why this engine's steps cannot be captured, or None."""
        why = capture_refusal(self.device, self.dist.mesh)
        if why is None and moe.reads_host(self.cfg, self.device):
            why = (f"serves the MoE family in {self.cfg.dtype}, whose "
                   "grouped GEMM reads the host")
        return why

    def _step(self, key, fn, shapes) -> Step:
        """The step of ``key``, built at its first use: ``fn`` over static
        input buffers of ``shapes`` (name: (shape, dtype, spec)), laid out
        by ``spec`` under a mesh."""
        step = self.steps.get(key)
        if step is None:
            inputs = {}
            for name, (shape, dtype, spec) in shapes.items():
                buf = torch.zeros(shape, dtype=dtype, device=self.device)
                inputs[name] = (buf if self.dist.mesh is None
                                else _laid_out(buf, spec, self.dist.mesh))
            step = self.steps[key] = Step(f"{self.cfg.name} {key}", fn,
                                          inputs, self._pool)
        return step

    # ----------------------------------------------------------- the steps
    def _prefill(self, tokens, lengths=None):
        """``zoo.prefill`` of one request: (logits, its cache).  Under a
        mesh whole inputs (the exact-length prefill's) are replicated."""
        batch = {"tokens": tokens}
        if lengths is not None:
            batch["lengths"] = lengths
        if self.dist.mesh is None:
            return zoo.prefill(self.cfg, self.params, batch, self.max_len)
        batch = {k: _laid_out(t, P(*(None,) * t.dim()), self.dist.mesh)
                 for k, t in batch.items()}
        logits, rcache = zoo.prefill(self.cfg, self.params, batch,
                                     self.max_len, self._prefill_dist)
        return logits.full_tensor(), rcache

    def _decode(self, tokens):
        """``zoo.decode_step`` of every slot on the batch cache, updated in
        place: (logits (slots, 1, V), the next tokens (slots,))."""
        logits, cache = zoo.decode_step(self.cfg, self.params, tokens,
                                        self.cache, self.dist)
        if self.dist.mesh is not None:
            logits = logits.full_tensor()
        for key, t in cache.items():
            if key != "len" and t is not self.cache[key]:
                raise RuntimeError(f"{self.cfg.name}: decode_step returned "
                                   f"a new cache[{key!r}]; the engine's "
                                   "steps need it updated in place")
        _local(self.cache["len"]).copy_(_local(cache["len"]))
        return logits, torch.argmax(logits[:, 0], dim=-1)

    def _run_prefill(self, prompt: np.ndarray):
        """One request's prefill: through its bucket's step for the
        bucketed families, eagerly at the exact length for the rest."""
        L = len(prompt)
        tokens = torch.as_tensor(np.asarray(prompt), dtype=torch.long)
        if not self._bucketed:
            return self._prefill(tokens[None].to(self.device))
        bucket = min(self._bucket(L), self.max_len)
        step = self._step(("prefill", bucket), self._prefill, {
            "tokens": ((1, bucket), torch.long, P(None, None)),
            "lengths": ((1,), torch.int32, P(None))})
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :L] = prompt
        step.write("tokens", padded)
        step.write("lengths", np.array([L], np.int32))
        return step()

    def _run_decode(self, last: np.ndarray):
        """One decode step of every slot, ``last`` (slots, 1) the tokens
        fed to it: (logits, next tokens), read before any other step."""
        step = self._step("decode", self._decode, {
            "tokens": ((self.slots, 1), torch.long, P(self.dist.batch,
                                                       None))})
        step.write("tokens", last)
        return step()

    # ----------------------------------------------------------------- admin
    def submit(self, req: Request):
        self.queue.append(req)

    def _free_slots(self):
        return [i for i, r in enumerate(self.live) if r is None]

    @staticmethod
    def _bucket(length: int) -> int:
        """Smallest power of two >= length."""
        return 1 << max(length - 1, 0).bit_length()

    def _insert(self, slot: int, req: Request) -> bool:
        """Prefill one request; splice its cache into the batch cache.  If
        the request already finishes at prefill (first generated token is
        EOS, or a one-token budget), it completes here and the slot stays
        free — returns True iff the slot was occupied."""
        L = len(req.prompt)
        logits, rcache = self._run_prefill(req.prompt)
        self.stats.prefills += 1
        tok = int(torch.argmax(logits[0, -1]))
        req.out_tokens.append(tok)
        if tok == req.eos_id or req.max_new_tokens <= 1:
            req.done = True
            self.stats.completed += 1
            return False
        for key, t in rcache.items():
            if key == "len":
                continue
            if self.dist.mesh is None:
                self.cache[key][:, slot] = t[:, 0]
            else:
                _splice(self.cache[key], t, slot, self.dist)
        _local(self.cache["len"])[slot] = L
        self.live[slot] = req
        return True

    # ------------------------------------------------------------------ tick
    def tick(self):
        """Admit from queue, then advance every live slot one token."""
        for slot in self._free_slots():
            # A request that completes at prefill leaves the slot free for
            # the next queued one.
            while self.queue:
                if self._insert(slot, self.queue.popleft()):
                    break

        if not any(r is not None for r in self.live):
            return

        last = np.zeros((self.slots, 1), np.int64)
        for i, r in enumerate(self.live):
            if r is not None:
                last[i, 0] = r.out_tokens[-1]
        _, nxt = self._run_decode(last)
        nxt = nxt.cpu().numpy()
        # One host transfer for all slot lengths per tick.
        lens = _local(self.cache["len"]).cpu().numpy()
        self.stats.ticks += 1

        for i, r in enumerate(self.live):
            if r is None:
                continue
            tok = int(nxt[i])
            r.out_tokens.append(tok)
            self.stats.generated_tokens += 1
            full = int(lens[i]) >= self.max_len - 1
            if tok == r.eos_id or len(r.out_tokens) >= r.max_new_tokens or full:
                r.done = True
                self.live[i] = None
                _local(self.cache["len"])[i] = 0
                self.stats.completed += 1

    def run(self, max_ticks: int = 1000):
        while (self.queue or any(r is not None for r in self.live)) \
                and self.stats.ticks < max_ticks:
            self.tick()
        return self.stats


def _local(t):
    """A DTensor's local shard (for a replicated one, the whole tensor on
    this process), or ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


def _laid_out(tree, specs, mesh):
    """Whole tensors of ``tree`` laid out on ``mesh`` by ``specs``; DTensors
    are kept as they are."""
    from repro_torch.launch.mesh import shard_tree
    if isinstance(tree, dict):
        return {k: _laid_out(v, specs[k], mesh) for k, v in tree.items()}
    return tree if hasattr(tree, "to_local") else shard_tree(tree, specs,
                                                              mesh)


def _splice(cache, row, slot: int, dist: Dist) -> None:
    """Write the one-row cache ``row`` (n, 1, ...) into row ``slot`` of the
    batch cache ``cache`` (n, slots, ...), both DTensors: ``row`` is laid
    out as ``cache`` is but for its batch dimension (replicated), and the
    process whose batch shard holds the slot writes it into its shard."""
    from torch.distributed.tensor import Replicate, Shard
    names = dist.mesh.mesh_dim_names
    batch_axes = [a for a, pl in zip(names, cache.placements)
                  if isinstance(pl, Shard) and pl.dim == 1]
    target = [Replicate() if a in batch_axes else pl
              for a, pl in zip(names, cache.placements)]
    local = cache.to_local()
    part = row.redistribute(dist.mesh, target).to_local()
    lo = _seq_index(dist, batch_axes) * local.shape[1]
    if lo <= slot < lo + local.shape[1]:
        local[:, slot - lo] = part[:, 0]
