"""Functional optimizer core (port of ``repro.optim.base``).

Parameters, gradients and optimizer states are trees: dicts, lists,
tuples and NamedTuples of tensors, with ``None`` as an empty subtree, as
in JAX. The helpers here walk them in JAX's order (dict keys sorted), so
the port and the reference flatten one tree to the same leaf order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch

Params = Any
State = Any
Updates = Any


@dataclasses.dataclass(frozen=True)
class OptimizerDef:
    init: Callable[[Params], State]
    update: Callable[[Updates, State, Params], Tuple[Updates, State]]


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _children(t):
    """``(keys, children, rebuild)`` of a tree node, or None for a leaf;
    ``keys`` are the JAX key-path strings of the children."""
    if t is None:
        return [], [], lambda _: None
    if isinstance(t, dict):
        keys = sorted(t)
        return ([f"[{k!r}]" for k in keys], [t[k] for k in keys],
                lambda ch: type(t)(zip(keys, ch)))
    if _is_namedtuple(t):
        return ([f".{f}" for f in t._fields], list(t),
                lambda ch: type(t)(*ch))
    if isinstance(t, (list, tuple)):
        return ([f"[{i}]" for i in range(len(t))], list(t),
                lambda ch: type(t)(ch))
    return None


def tree_flatten_with_path(tree) -> Tuple[List[str], List, Callable]:
    """``(paths, leaves, unflatten)``: each leaf's key path joined by ``/``
    as the reference's checkpointer writes it (``.w`` for a NamedTuple
    field, ``['w']`` for a dict key, ``[0]`` for a sequence index), the
    leaves in JAX's order, and a function that rebuilds the tree from a
    list of new leaves."""
    paths, leaves = [], []

    def walk(t, path):
        node = _children(t)
        if node is None:
            paths.append("/".join(path))
            leaves.append(t)
            return lambda it: next(it)
        keys, children, rebuild = node
        subs = [walk(c, path + [k]) for k, c in zip(keys, children)]
        return lambda it: rebuild([s(it) for s in subs])

    build = walk(tree, [])
    return paths, leaves, lambda new: build(iter(new))


def tree_leaves(tree) -> List:
    return tree_flatten_with_path(tree)[1]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and trees of the same
    structure (``rest`` may hold whole subtrees where ``tree`` has a leaf,
    as JAX's ``tree_map`` allows)."""
    _, leaves, unflatten = tree_flatten_with_path(tree)
    others = [tree_flatten_up_to(tree, r) for r in rest]
    return unflatten([fn(x, *xs) for x, *xs in zip(leaves, *others)])


def tree_flatten_up_to(shape_tree, tree) -> List:
    """``tree``'s subtrees at the leaf positions of ``shape_tree``."""
    out = []

    def walk(s, t):
        node = _children(s)
        if node is None:
            out.append(t)
            return
        keys, children, _ = node
        t_node = _children(t)
        if t_node is None or len(t_node[1]) != len(children) or (
                isinstance(s, dict) and sorted(s) != sorted(t)):
            raise ValueError("tree structures differ")
        for c, tc in zip(children, t_node[1]):
            walk(c, tc)

    walk(shape_tree, tree)
    return out


def apply_updates(params: Params, updates: Updates) -> Params:
    return tree_map(
        lambda p, u: (p + u.to(p.dtype)) if u is not None else p,
        params, updates,
    )


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))
