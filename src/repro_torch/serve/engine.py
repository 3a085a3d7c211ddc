"""Serving: sharded prefill/decode steps and a slot-based batched server.

The port of ``repro/serve/engine.py``.  Serving has no gradient
reduction, so the paper's technique does not apply here (DESIGN.md
§Arch-applicability); every attention of every step is the flash kernel
on the card (masked decode over the KV cache).

``make_serve_fns`` is the sharded entry point: prefill and decode steps
on the rank-axis layout of a ``(pod, data, model)`` mesh.  Parameters
follow the same FSDP+TP rules as training (``rules.shard_params``,
gathered per layer by ``rules.make_gather``), in the compute dtype; the
tokens are placed as ``rules.batch_spec`` says and the cache as
``rules.cache_specs`` does: KV heads over ``model`` when they divide,
otherwise a *sequence-split* KV cache, each ``model`` rank holding
``S/tp`` of the context, attended by one partial flash launch over every
rank's block and combined by the log-sum-exp over ``model``
(``base.attend_shards``).  Where the reference's XLA partitions the
softmax reduction, the port computes it explicitly.

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
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import tp
from repro_torch.mesh import require_emulated
from repro_torch.models import base
from repro_torch.models.registry import abstract_params
from repro_torch.sharding import rules

#: the cache leaves that hold K/V (a sequence or heads dim to split)
_KV_LEAVES = frozenset(rules._CACHE_SEQ_DIM)


@dataclasses.dataclass(frozen=True)
class ServeLayout:
    """Where sharded serving puts everything, the counterpart of the
    reference's ``shardings``: the mesh, each parameter's FSDP and TP dims
    (``rules.param_specs`` / ``tp_specs`` of the cast parameters, -1 where
    replicated), each cache leaf's :class:`rules.Spec`
    (``rules.cache_specs`` of the ``(cache_batch, cache_len)`` cache),
    the device and the compute dtype."""

    mesh: rules.MeshCfg
    params: Any
    tp: Any
    cache: Any
    device: torch.device
    dtype: torch.dtype

    def shard_params(self, params: Any) -> Any:
        """Global parameters → every rank's, in the compute dtype
        (``rules.cast_params``; ``KEEP_F32`` leaves stay fp32), on the
        device."""
        cast = rules.cast_params(params, self.dtype)
        return rules.shard_params(
            tree.map_leaves(lambda t: t.to(self.device), cast), self.mesh)

    @property
    def seq_split(self) -> frozenset:
        """The cache entries split over their sequence on ``model``
        (``rules.seq_split_entries``)."""
        return rules.seq_split_entries(self.cache, self.mesh)

    def shard_cache(self, cache: Any) -> Any:
        """A global cache (``model.init_cache``'s layout) → the rank
        axes, on the device."""
        return rules.shard_cache(tree.map_leaves(
            lambda t: t.to(self.device) if isinstance(t, torch.Tensor)
            else t, cache), self.mesh, self.cache)

    def unshard_cache(self, cache: Any) -> Any:
        """A cache on the rank axes → its global view."""
        return rules.unshard_cache(cache, self.mesh, self.cache)


def make_serve_fns(model, mesh_cfg: rules.MeshCfg, *, cache_batch: int,
                   cache_len: int, device: str | torch.device = "cuda"
                   ) -> tuple[Callable, Callable, ServeLayout]:
    """``(prefill_fn, decode_fn, layout)`` on the mesh ``mesh_cfg``.

    ``prefill_fn(params, batch)`` → ``(logits (B, 1, V), cache)`` and
    ``decode_fn(params, tokens, cache)`` → ``(logits (B, S, V), cache)``:
    ``params`` are ``layout.shard_params(global_params)``, ``batch`` and
    ``tokens`` global (``(B, S)`` int tokens; the VLM's
    ``vision_embeds``, whisper's ``enc_frames``), the logits global, the
    cache on the rank axes as ``layout.cache`` says (``prefill_fn``'s for
    the prompt's length; ``layout.shard_cache`` places a global one).
    ``decode_fn`` writes the cache in place (it is consumed, as the
    reference's is under donation).  Both run without autograd, under
    ``core.tp.parallel``.  At ``model`` = 1 and ``data`` = 1 they are the
    unsharded ``prefill`` / ``decode_step`` on the rank axes' single
    rank.  A K/V cache that the specs would leave whole over ``model``
    (neither its heads nor its length divide) is refused.

    ``device`` is where the steps run (the card by default; there is no
    fallback to the CPU).  The FSDP gathers take the rhd schedule, the
    trainer's default (forward only: every schedule gives the same
    bits).  Serving on a ``ProcessMesh`` raises."""
    require_emulated(mesh_cfg.rank_mesh(), "serving (make_serve_fns)", 24)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_serve_fns: no CUDA device (pass "
                           "device='cpu' to serve on the CPU)")
    cfg = model.cfg
    shapes = rules.cast_params(abstract_params(model), cfg.dtype)
    cache_like = model.init_cache(cache_batch, cache_len, device="meta")
    layout = ServeLayout(mesh_cfg, rules.param_specs(shapes, mesh_cfg),
                         rules.tp_specs(shapes, mesh_cfg),
                         rules.cache_specs(cache_like, mesh_cfg), dev,
                         cfg.dtype)
    if mesh_cfg.tp > 1:
        for path, sp in zip(tree.paths(layout.cache),
                            tree.flatten(layout.cache)[0]):
            if path[-1] in _KV_LEAVES and sp.dim_of("model") is None:
                raise NotImplementedError(
                    f"make_serve_fns: cache leaf {'/'.join(map(str, path))}"
                    f" would stay whole over {mesh_cfg.tp} model ranks "
                    f"(neither its heads nor its length {cache_len} divide)")
    seq = layout.seq_split
    gather = rules.make_gather(mesh_cfg, "rhd", shapes)
    vocab = "model" if mesh_cfg.tp > 1 and cfg.vocab % mesh_cfg.tp == 0 \
        else None

    def run(fn, tokens: torch.Tensor, *args) -> tuple:
        """``fn`` on the rank axes as the layout says (``base.serving``:
        an MoE routes the global batch, the layers attend each cache
        entry as it is split); its logits made global: the rows as the
        tokens were placed, the vocabulary blocks joined over ``model``
        where it is split."""
        rows = rules.batch_spec({"t": tokens}, mesh_cfg)["t"].dims
        split = (rows or ((),))[0]
        dims = tuple(mesh_cfg.reduce_axes.index(a) for a in split)
        with tp.parallel(mesh_cfg.tp), base.serving(dims, seq), \
                torch.no_grad():
            logits, cache = fn(*args, gather=gather)
        spec = rules.Spec(((rows or (None,))[0], None, vocab))
        return rules._unplace(logits, spec, mesh_cfg), cache

    def prefill_fn(params: Any, batch: dict) -> tuple:
        batch = {k: v.to(dev) for k, v in batch.items()}
        return run(model.prefill, batch["tokens"], params,
                   rules.split_batch(batch, mesh_cfg))

    def decode_fn(params: Any, tokens: torch.Tensor, cache: Any) -> tuple:
        tokens = tokens.to(dev)
        return run(model.decode, tokens, params,
                   rules.split_batch({"t": tokens}, mesh_cfg)["t"], cache)

    return prefill_fn, decode_fn, layout


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
