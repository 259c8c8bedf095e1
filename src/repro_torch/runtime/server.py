"""Batched inference server: continuous-batching decode loop.

The port of ``repro.runtime.server``:
  * requests queue up with prompts; the slot scheduler (``SlotScheduler``,
    shared with the stream server) packs up to ``max_batch`` concurrent
    sequences into the fixed decode batch (padding unused rows),
  * prompts go through the decode path token by token (every family:
    attention caches, RWKV and SSD states, the encoder-decoder's zero
    cross caches),
  * each decode step emits one token for every live row; finished rows
    (EOS or max_tokens) retire and their slots are refilled (continuous
    batching),
  * per-row state is owned by the fixed-shape cache, updated in place.

The model holds its parameters: ``Server(model, ...)`` where the reference
has ``Server(model, params, ...)``.  The model's device is the server's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from repro_torch.models.transformer import Transformer
from repro_torch.runtime.scheduler import SlotScheduler


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (T,) int32
    max_tokens: int = 16
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submit_t: float = 0.0
    finish_t: float = 0.0


class Server:
    def __init__(
        self,
        model: Transformer,
        max_batch: int = 8,
        max_len: int = 512,
        eos_id: int = -1,
    ):
        self.model = model
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.sched = SlotScheduler(max_batch)
        self.slot_pos = np.zeros(max_batch, np.int32)   # tokens consumed
        self.cache = model.init_cache(max_batch, max_len)
        self.steps = 0

    @property
    def slots(self):
        return self.sched.slots

    @property
    def completed(self) -> List[Request]:
        return self.sched.completed

    def submit(self, req: Request):
        req.submit_t = time.perf_counter()
        self.sched.submit(req)

    # -- scheduling --------------------------------------------------------------

    def _on_admit(self, i: int, req: Request):
        self.slot_pos[i] = 0
        self._reset_row(i)

    def _reset_row(self, i: int):
        """Zero row i of every per-row cache buffer (slot reuse), in
        place: every family's cache keeps its rows on axis 1 of each
        stacked leaf (k, v, cross_k, cross_v, s, x_last, conv, attn_k,
        attn_v) and on axis 0 of ``len`` and ``enc_len``.  The reference
        finds the axis by matching ``max_batch`` against the shape; the
        fixed axis cannot mistake a layer axis of that extent for it."""
        for leaf in self.cache.values():
            if leaf.ndim == 1:
                leaf[i] = 0
            else:
                leaf[:, i] = 0

    # -- the decode loop -----------------------------------------------------------

    def step(self):
        """One global decode step: feeds each live row its next input token
        (prompt token during prefill phase, else the last sampled token)."""
        self.sched.admit(self._on_admit)
        tok = np.zeros((self.max_batch, 1), np.int32)
        for i, req in self.sched.live():
            pos = self.slot_pos[i]
            if pos < len(req.prompt):
                tok[i, 0] = req.prompt[pos]          # prefill phase
            elif req.out_tokens:
                tok[i, 0] = req.out_tokens[-1]       # decode phase
        logits, self.cache = self.model.decode_step(tok, self.cache)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        self.steps += 1
        for i, req in self.sched.live():
            self.slot_pos[i] += 1
            if self.slot_pos[i] >= len(req.prompt):
                req.out_tokens.append(int(nxt[i]))
                if (
                    len(req.out_tokens) >= req.max_tokens
                    or int(nxt[i]) == self.eos_id
                    or self.slot_pos[i] + len(req.out_tokens) >= self.max_len - 1
                ):
                    req.done = True
                    req.finish_t = time.perf_counter()
                    self.sched.retire(i)   # continuous batching: slot refills

    def run_until_drained(self, max_steps: int = 100000) -> List[Request]:
        steps = 0
        while self.sched.active() and steps < max_steps:
            self.step()
            steps += 1
        return self.sched.completed
