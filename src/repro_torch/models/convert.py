"""Carry weights across from the JAX package.

The port keeps the JAX package's parameter tree and layouts (``wq [L, d,
nh, hd]``, ``wo [L, nh, hd, d]``, ``table [V, d]``, ...), so converting is
a leaf-by-leaf copy.  The JAX side hands its tree over as numpy arrays
(``jax.tree.map(np.asarray, params)``); nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch


def params_from_numpy(tree: Any, device: Union[str, torch.device],
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts of numpy arrays -> the same tree of tensors on
    ``device``.  Floating leaves are cast to ``dtype`` when given; a
    bfloat16 numpy leaf goes through float32, which is exact."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    a = np.array(tree, copy=True)       # writable, owned by the tensor
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)
