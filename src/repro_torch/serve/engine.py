"""Serving: a slot-based batched server over the model's decode step.

The port of ``repro/serve/engine.py``'s ``Request`` and
``BatchedServer``.  Serving has no gradient reduction, so the paper's
technique does not apply here (DESIGN.md §Arch-applicability); every
attention of every step is the flash kernel on the card (masked decode
over the KV cache).  The reference's ``make_serve_fns`` describes a
sharded layout for a JAX mesh (``NamedSharding``s for the parameters
and ``rules.cache_specs`` for the cache); that is the dry-run tooling's,
ROADMAP queue 1 item 15.

The server follows the reference step for step, its quirk included:
one decode step writes every lane's K/V at one shared position, the
first active slot's (``step``), and a prompt is fed through single-lane
steps at its slot's position with token 0 in the other lanes
(``_admit``).  Lanes that stand at different positions therefore write
where another lane stands; the port gives the reference's tokens all
the same.  The positions live on the host (numpy), the cache's ``pos``
is a host int, and a step copies its ``(slots,)`` greedy tokens to the
host once.  Steps run under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (prompt_len,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


def _device(params) -> torch.device:
    from repro_torch import tree
    return tree.flatten(params)[0][0].device


class BatchedServer:
    """Slot-based batched decode (continuous-batching-lite).

    Fixed ``slots`` decode lanes over one shared KV cache; requests are
    admitted into free slots (prompt fed one token at a time into the
    slot's cache rows), then all active slots decode in lockstep.  This
    is the minimal shape of a production batcher: admission, per-slot
    position tracking, EOS/max-token retirement, cache reuse.  The cache
    lives on the parameters' device, in the model's compute dtype.
    """

    def __init__(self, model, params, *, slots: int = 8,
                 max_len: int = 256, eos: int = -1):
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos = eos
        self.device = _device(params)
        self.cache = model.init_cache(slots, max_len, device=self.device)
        self.cache["pos"] = 0
        self.pos = np.zeros(slots, np.int32)        # per-slot next position
        self.active: list[Request | None] = [None] * slots
        self.queue: list[Request] = []
        self._next = 0

    def submit(self, prompt: np.ndarray, max_new: int = 32) -> Request:
        r = Request(self._next, np.asarray(prompt, np.int32), max_new)
        self._next += 1
        self.queue.append(r)
        return r

    def _decode(self, toks: np.ndarray, pos: int) -> torch.Tensor:
        """One decode step of every lane at ``pos``: ``(slots, 1, V)``
        logits; the cache is updated in place."""
        self.cache["pos"] = pos
        with torch.inference_mode():
            logits, self.cache = self.model.decode(
                self.params, torch.from_numpy(toks).to(self.device),
                self.cache)
        return logits

    def _admit(self):
        for i in range(self.slots):
            if self.active[i] is None and self.queue:
                r = self.queue.pop(0)
                self.active[i] = r
                self.pos[i] = 0
                # feed the prompt through decode steps on this slot's lane
                # (single-lane prefill keeps the server simple; a
                # production server would batch prefills separately)
                for t in r.prompt:
                    self._step_slot(i, int(t))

    def _step_slot(self, i: int, tok: int) -> torch.Tensor:
        toks = np.zeros((self.slots, 1), np.int32)
        toks[i, 0] = tok
        logits = self._decode(toks, int(self.pos[i]))
        self.pos[i] += 1
        return logits[i, -1]

    def step(self) -> int:
        """One decode step for all active slots; returns #active."""
        self._admit()
        act = [i for i, r in enumerate(self.active) if r is not None]
        if not act:
            return 0
        toks = np.zeros((self.slots, 1), np.int32)
        for i in act:
            r = self.active[i]
            toks[i, 0] = r.out[-1] if r.out else (r.prompt[-1] if
                                                  len(r.prompt) else 0)
        logits = self._decode(toks, int(self.pos[act[0]]))
        nxt = logits[:, -1].argmax(-1).cpu().numpy()
        for i in act:
            r = self.active[i]
            tok = int(nxt[i])
            r.out.append(tok)
            self.pos[i] += 1
            if tok == self.eos or len(r.out) >= r.max_new \
                    or self.pos[i] >= self.max_len - 1:
                r.done = True
                self.active[i] = None
        return len(act)

    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or any(self.active)) and steps < max_steps:
            self.step()
            steps += 1
        return steps
