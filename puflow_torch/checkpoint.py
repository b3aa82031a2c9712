"""Checkpoints: the JAX package's native ``.npz`` format, the reference's
``.pt`` state_dicts (`puflow_torch.convert`), and the bridge between their
numpy parameter trees and the port's model.

The ``.npz`` holds the (params, state) trees flattened to
``params/flow_blocks/0/actnorm/logs``-style keys, as
`puflow_tpu.checkpoint` writes them; the flatten/unflatten code is a copy
of that module's, so the port reads and writes the same files without
importing jax.
"""

from __future__ import annotations

import numpy as np
import torch

from puflow_torch.convert.torch_ckpt import (load_cnf_checkpoint,
                                             load_discrete_checkpoint)
from puflow_torch.models.continuous import ContinuousModel
from puflow_torch.models.discrete import DiscreteModel
from puflow_torch.models.fold_bn import empty_bn_state, fold_bn_inference
from puflow_torch.utils.device import resolve_device


def _flatten(prefix: str, tree, out: dict):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}/{k}" if prefix else str(k), v, out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(f"{prefix}/{i}", v, out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def save_checkpoint(path: str, params, state) -> None:
    """Write numpy (params, state) trees as one ``.npz``."""
    flat = {}
    _flatten("params", params, flat)
    _flatten("state", state, flat)
    np.savez(path, **flat)


def load_npz_checkpoint(path: str):
    """``.npz`` -> numpy (params, state) trees."""
    with np.load(path) as data:
        tree = _unflatten({k: data[k] for k in data.files})
    return tree["params"], tree["state"]


# "continuous" names the CNF family too: `puflow_tpu.checkpoint` serves
# every family other than "discrete" as the CNF (`bench.py` passes it)
MODELS = {"discrete": DiscreteModel, "cnf": ContinuousModel,
          "continuous": ContinuousModel}


def _model_class(model: str):
    if model not in MODELS:
        raise ValueError(f"unknown model family {model!r}: expected one of "
                         f"{sorted(MODELS)}")
    return MODELS[model]


def from_numpy_tree(params, state, device="cuda",
                    model: str = "discrete") -> DiscreteModel:
    """The port's model on ``device`` from numpy (params, state) trees,
    e.g. the JAX package's parameters after ``jax.tree.map(np.asarray,
    ...)``, keys unchanged. ``model`` names the family: ``"discrete"`` ->
    `DiscreteModel`, ``"cnf"`` -> `ContinuousModel` (trees of
    `continuous.init`)."""
    cls = _model_class(model)
    device = resolve_device(device)

    def to_tensor(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    return cls(_map_tree(to_tensor, params), _map_tree(to_tensor, state))


def to_numpy_tree(model: DiscreteModel):
    """Inverse of `from_numpy_tree`, for either family: numpy (params,
    state) trees."""
    params, state = model.trees()

    def to_numpy(t):
        return t.detach().cpu().numpy()

    return _map_tree(to_numpy, params), _map_tree(to_numpy, state)


def load_numpy_checkpoint(path: str, model: str = "discrete"):
    """Any supported checkpoint of the ``model`` family -> numpy (params,
    state) trees: a native ``.npz``, or a reference ``.pt`` / ``.ckpt``
    state_dict through `puflow_torch.convert.torch_ckpt`, as
    `puflow_tpu.checkpoint.load_checkpoint` reads them."""
    cls = _model_class(model)
    if path.endswith(".npz"):
        return load_npz_checkpoint(path)
    if path.endswith((".pt", ".ckpt")):
        if cls is DiscreteModel:
            return load_discrete_checkpoint(path)
        return load_cnf_checkpoint(path)
    raise ValueError(f"unrecognised checkpoint format: {path}")


def load_checkpoint(path: str, device="cuda", fold: bool = False,
                    model: str = "discrete") -> DiscreteModel:
    """Load a checkpoint of the ``model`` family (``"discrete"``, or
    ``"cnf"`` / ``"continuous"``) onto ``device``: a native ``.npz`` or a
    reference ``.pt`` / ``.ckpt`` (`load_numpy_checkpoint`).
    ``fold=True`` folds eval-mode BatchNorm into the convs
    (`models.fold_bn`; the flow blocks of either family pass through), the
    inference configuration the upsample CLI runs by default; do not fold
    parameters that will be trained further."""
    cls = _model_class(model)
    loaded = from_numpy_tree(*load_numpy_checkpoint(path, model),
                             device=device, model=model)
    if not fold:
        return loaded
    params, state = loaded.trees()
    return cls(fold_bn_inference(params, state), empty_bn_state(state))
