"""Parameters across the two packages: ``uno_tpu``'s flax param tree <->
``uno_tpu_torch``'s modules, and ``.npz`` files of the tree.

A flax tree (as numpy arrays) looks like ``{"params": {"fc": {"kernel",
"bias"}, "fc0": ..., "block0": {"conv": {"weights"}, "w": {"kernel",
"bias"}, "norm_scale", "norm_bias"}, ..., "fc1": ..., "fc2": ...}}``.  The
port's parameter names are the same path joined by ``.``, except that a
Dense or 1x1 conv ``kernel`` (flax ``[in, out]``) is a torch ``weight``
(``[out, in]``): the bridge transposes it.  A round trip is bit-exact.
An ``.npz`` file keys each array by its ``/``-joined flax path, e.g.
``params/block0/conv/weights``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn


def _flat(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _nest(flat: Dict[Tuple[str, ...], np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _flax_path(torch_name: str) -> Tuple[Tuple[str, ...], bool]:
    """Flax path of a torch parameter name, and whether it is transposed."""
    path = tuple(torch_name.split("."))
    if path[-1] == "weight":
        return path[:-1] + ("kernel",), True
    return path, False


def params_to_flax(module: nn.Module) -> dict:
    """The module's parameters as a flax param tree of numpy arrays."""
    flat = {}
    for name, p in module.named_parameters():
        path, transpose = _flax_path(name)
        a = p.detach().cpu().numpy()
        flat[("params",) + path] = np.ascontiguousarray(a.T) if transpose else a.copy()
    return _nest(flat)


def params_from_flax(module: nn.Module, tree) -> nn.Module:
    """Load a flax param tree (numpy or jax arrays, with or without the
    top-level ``params`` key) into ``module``; every parameter must be
    present with its exact shape.  Returns ``module``."""
    if "params" in tree:
        tree = tree["params"]
    flat = {path: np.asarray(v) for path, v in _flat(tree)}
    wanted = dict(module.named_parameters())
    paths = {_flax_path(n)[0]: n for n in wanted}
    missing = sorted("/".join(p) for p in set(paths) - set(flat))
    extra = sorted("/".join(p) for p in set(flat) - set(paths))
    if missing or extra:
        raise ValueError(f"param tree mismatch: missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for path, name in paths.items():
            p = wanted[name]
            a = flat[path]
            if _flax_path(name)[1]:
                a = a.T
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{'/'.join(path)}: shape {a.shape}, module wants {tuple(p.shape)}")
            p.copy_(torch.tensor(a, dtype=p.dtype))
    return module


def save_npz(path: str, tree) -> None:
    """Write a flax param tree to ``path`` keyed by ``/``-joined paths."""
    np.savez(path, **{"/".join(k): np.asarray(v) for k, v in _flat(tree)})


def load_npz(path: str) -> dict:
    """Read a tree written by ``save_npz``."""
    with np.load(path) as z:
        return _nest({tuple(k.split("/")): z[k] for k in z.files})
