"""Parameter bookkeeping helpers.

Counterpart of `puflow_tpu.utils.params`: parameter counting, selective
freezing and the per-epoch progress line, over nested dicts, lists and
tuples whose leaves are tensors or numpy arrays.
"""

from __future__ import annotations

import math


def tree_leaves(tree):
    """The leaves in order: dict values, list and tuple items; None is an
    empty subtree."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif tree is not None:
        yield tree


def count_parameters(tree) -> int:
    return sum(int(math.prod(x.shape)) for x in tree_leaves(tree))


def parameter_breakdown(tree) -> dict:
    """Top-level key -> parameter count."""
    return {k: count_parameters(v) for k, v in tree.items()}


def freeze_mask(params, frozen_prefixes):
    """Boolean tree of the same structure: True = trainable, False =
    frozen.

    `frozen_prefixes`: '/'-joined key-path prefixes to freeze (e.g.
    ['feat_convs', 'interp/weight_unit']; list items by index). To freeze
    with `torch.optim` (where the JAX package names `optax.masked`), drop
    the frozen leaves' gradients before each ``step()``::

        for p, trainable in zip(tree_leaves(params), tree_leaves(mask)):
            if not trainable:
                p.grad = None

    An optimizer skips a leaf whose ``grad`` is None, so neither weight
    decay nor momentum moves it; a zeroed gradient keeps plain SGD and
    Adam still but not weight decay.
    """
    prefixes = tuple(frozen_prefixes)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + [str(k)]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + [str(i)])
                              for i, v in enumerate(node))
        if node is None:
            return None
        key = "/".join(path)
        return not any(key.startswith(f) for f in prefixes)

    return walk(params, [])


def print_progress_log(epoch: int, metrics: dict, extra=(), log_fn=print):
    """One-line epoch summary."""
    parts = [f"Epoch {epoch:4d}"]
    parts += [f"{k} {v:.6f}" if isinstance(v, float) else f"{k} {v}"
              for k, v in metrics.items()]
    parts += list(extra)
    log_fn(" | ".join(parts))
