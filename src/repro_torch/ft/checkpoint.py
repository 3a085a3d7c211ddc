"""Sharded checkpointing: per-host shard files, manifest + CRC, atomic
rename commit, async save thread, keep-N garbage collection.

The port of ``repro/ft/checkpoint.py``, on the same on-disk layout (one
directory per step)::

    ckpt_dir/
      step_000100/                 # committed (rename from .tmp)
        manifest.json              # leaf names, shapes, dtypes, CRCs
        shard_h000.npz             # this host's shard of every leaf
      step_000100.tmp/             # in-flight (never loaded)

Leaves are torch tensors, named as ``jax.tree_util.keystr`` names them
(``['o']['m']['embed']``), in the JAX package's leaf order
(``repro_torch.tree``), and stored with the dtype strings and bytes the
reference stores (a bfloat16 leaf as 2-byte void, manifest dtype
``"bfloat16"``).  So for the same state the two packages write the same
manifest, byte for byte, and each restores the other's checkpoints.

The state saved is the *global* view of a run (``sharding.rules.
unshard_params``): the manifest stores global shapes, so an elastic
restart onto another mesh restores the global leaves and lays them out
with ``rules.shard_params`` for the new mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch import tree as tree_mod

#: numpy has no bfloat16: its two bytes are stored as the reference
#: stores them, a 2-byte void ("<V2")
_BF16_VOID = np.dtype("V2")


def _crc32(a: np.ndarray) -> int:
    """The CRC of an array's bytes (``zlib.crc32(a.tobytes())``, without
    the copy ``tobytes`` makes)."""
    return zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def _keystr(path: tuple) -> str:
    """A leaf path as ``jax.tree_util.keystr`` renders it."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def _flatten_with_names(tree: Any) -> tuple[list[str], list]:
    leaves, _ = tree_mod.flatten(tree)
    return [_keystr(p) for p in tree_mod.paths(tree)], leaves


def _host_copy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A numpy copy of ``t`` in host memory that nothing else aliases,
    and the dtype name the manifest gives it."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        a = t.view(torch.int16).to("cpu", copy=True).numpy()
        return a.view(_BF16_VOID), "bfloat16"
    a = t.to("cpu", copy=True).numpy()
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, dtype_name: str, target: torch.Tensor
               ) -> torch.Tensor:
    """A loaded array on the target leaf's device and dtype."""
    a = np.require(a, requirements="C")      # keeps 0-d leaves 0-d
    if dtype_name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=target.device, dtype=target.dtype)


class CheckpointManager:
    """Async, atomic, keep-N sharded checkpoint manager."""

    def __init__(self, directory: str, *, keep: int = 3, host_id: int = 0,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.host_id = host_id
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any) -> None:
        """Copy every leaf to host memory synchronously, write
        asynchronously.

        The copy is the snapshot: training updates its tensors in place
        (``train.optim``), so the write thread must never read them.  On
        the card the copy is the device-to-host transfer."""
        names, leaves = _flatten_with_names(tree)
        copies = [_host_copy(l) for l in leaves]
        arrays = [a for a, _ in copies]
        dtypes = [d for _, d in copies]
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_or_keep_error,
                args=(step, names, arrays, dtypes))
            self._thread.start()
        else:
            self._write(step, names, arrays, dtypes)

    def wait(self) -> None:
        """Join the write thread; raise what the write raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise error

    def _write_or_keep_error(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as e:       # re-raised by wait()
            self._error = e

    def _write(self, step: int, names: list[str], arrays: list[np.ndarray],
               dtypes: list[str]) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)

        shard_file = os.path.join(tmp, f"shard_h{self.host_id:03d}.npz")
        np.savez(shard_file, **{f"a{i}": a for i, a in enumerate(arrays)})
        manifest = {
            "step": step,
            "names": names,
            "shapes": [list(a.shape) for a in arrays],
            "dtypes": dtypes,
            "crc32": [_crc32(a) for a in arrays],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)            # atomic commit
        self._gc()

    # -- restore --------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def restore(self, step: int, target_tree: Any) -> Any:
        """Load a step into ``target_tree``'s structure: each leaf on the
        target leaf's device and in its dtype.  The target's names must be
        the saved ones; every leaf's CRC is checked."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(d, f"shard_h{self.host_id:03d}.npz"))
        arrays = [data[f"a{i}"] for i in range(len(manifest["names"]))]
        for i, a in enumerate(arrays):
            if _crc32(a) != manifest["crc32"][i]:
                raise IOError(f"checkpoint corruption: leaf "
                              f"{manifest['names'][i]} CRC mismatch")
        names, targets = _flatten_with_names(target_tree)
        if names != manifest["names"]:
            raise ValueError("checkpoint/tree structure mismatch:\n"
                             f"  saved:  {manifest['names'][:3]}...\n"
                             f"  target: {names[:3]}...")
        _, spec = tree_mod.flatten(target_tree)
        return tree_mod.unflatten(spec, [
            _to_tensor(a, dt, t)
            for a, dt, t in zip(arrays, manifest["dtypes"], targets)])

    # -- misc ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:06d}")

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
