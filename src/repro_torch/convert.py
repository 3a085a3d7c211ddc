"""Carry the JAX package's parameter or gradient trees into the port.

The JAX side hands over a pytree of numpy arrays (``np.asarray`` of each
leaf); the port takes the same dict structure of torch tensors.  bf16
arrays (``ml_dtypes.bfloat16``) cross through their bits.  Nothing here
imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree


def tensor_from_numpy(a: Any, device: str | torch.device = "cuda"
                      ) -> torch.Tensor:
    """One array → a tensor of the same dtype and bits on ``device``."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(tree_of_numpy: Any,
                    device: str | torch.device = "cuda") -> Any:
    """A pytree of numpy arrays → the same tree of tensors on ``device``."""
    return tree.map_leaves(lambda a: tensor_from_numpy(a, device),
                           tree_of_numpy)
