"""Batched serving engine: continuous batching over a slot-based cache.

The torch counterpart of ``repro.serve.engine``.  One ``decode_step`` serves
all slots per tick; requests flow through
  queue -> prefill (builds the request's cache, spliced into a free slot)
  -> decode ticks (all live slots advance one token)
  -> completion (EOS / max_new_tokens / cache full) frees the slot.

Per-slot lengths ride in the cache's ``len`` vector.  For the KV-cache
families (dense, MoE) prompts are padded to power-of-two buckets, as in the
reference, where that bounded the jitted prefill's traces; the port runs
eagerly and keeps the buckets so that both compute the same thing (pad
positions are inert: attention is causal and decode masks KV beyond
``len``).  The recurrent families (hybrid, xLSTM) would carry a pad token
through their state, and a VLM prompt's positions are offset by its
patches, so these prefill at the prompt's exact length, as the reference
does.  The engine serves a VLM as text only: a ``Request`` carries no
patches, and the reference's engine passes none.  The enc-dec family is
refused at construction: its prefill needs ``batch["frames"]``, which a
``Request`` does not carry, so the reference's engine fails on it at the
first prefill (enc-dec is served through ``models.prefill``/
``decode_step``).  A slot receives every key of the request's cache but
``len`` (KV, SSM and conv state, mLSTM and sLSTM state).  The reference's
``trace_counts`` counted ``jax.jit`` traces, which eager PyTorch has none
of; it returns as a capture counter with CUDA graphs.

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
from repro_torch.models.common import LMConfig
from repro_torch.models.transformer import cast_params


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
    """Continuous batching for every decoder-only family on one device.
    ``params`` lie on ``device``."""

    def __init__(self, cfg: LMConfig, params, slots: int = 4,
                 max_len: int = 256, device: DeviceLike = "cuda"):
        zoo.family_module(cfg)                  # raises for unknown families
        if cfg.family == "encdec":
            raise ValueError(
                f"{cfg.name}: ServeEngine serves decoder-only families; an "
                "enc-dec prefill needs batch['frames'], which a Request "
                "does not carry (use models.prefill/decode_step)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = cast_params(cfg, params)
        self.slots = slots
        self.max_len = max_len
        self.cache = zoo.init_cache(cfg, slots, max_len, device=self.device)
        # Only the KV-cache families take bucketed prompts (module docstring).
        self._bucketed = cfg.family in ("dense", "moe")
        self.live: List[Optional[Request]] = [None] * slots
        self.queue: deque[Request] = deque()
        self.stats = EngineStats()

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
        tokens = torch.as_tensor(np.asarray(req.prompt), dtype=torch.long)
        if self._bucketed:
            bucket = min(self._bucket(L), self.max_len)
            prompt = torch.zeros((1, bucket), dtype=torch.long)
            prompt[0, :L] = tokens
            batch = {"tokens": prompt.to(self.device),
                     "lengths": torch.tensor([L], dtype=torch.int32,
                                             device=self.device)}
        else:
            batch = {"tokens": tokens[None].to(self.device)}
        logits, rcache = zoo.prefill(self.cfg, self.params, batch,
                                     self.max_len)
        self.stats.prefills += 1
        tok = int(torch.argmax(logits[0, -1]))
        req.out_tokens.append(tok)
        if tok == req.eos_id or req.max_new_tokens <= 1:
            req.done = True
            self.stats.completed += 1
            return False
        for key, t in rcache.items():
            if key != "len":
                self.cache[key][:, slot] = t[:, 0]
        self.cache["len"][slot] = L
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
        logits, self.cache = zoo.decode_step(
            self.cfg, self.params, torch.from_numpy(last).to(self.device),
            self.cache)
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        # One host transfer for all slot lengths per tick.
        lens = self.cache["len"].cpu().numpy()
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
                self.cache["len"][i] = 0
                self.stats.completed += 1

    def run(self, max_ticks: int = 1000):
        while (self.queue or any(r is not None for r in self.live)) \
                and self.stats.ticks < max_ticks:
            self.tick()
        return self.stats
