"""Hand data from the JAX package to the port: a dict, NamedTuple, tuple or
list of arrays (anything numpy can read, such as jax arrays) becomes the
same structure of torch tensors on ``device``. Python scalars and None
pass through unchanged. The port itself never imports JAX; the tests use
this to feed both sides the same inputs."""

from __future__ import annotations

import numpy as np
import torch


def to_torch(tree, device=None):
    if tree is None or isinstance(tree, (bool, int, float)):
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_torch(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(v, device) for v in tree)
    a = np.array(tree)  # a writable copy
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device)
