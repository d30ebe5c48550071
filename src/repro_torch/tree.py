"""Trees of tensors in the reference's leaf order.

The reference keeps parameters, optimizer state and checkpoints as JAX
pytrees: nested dicts, tuples and lists whose leaves ``jax.tree.leaves``
lists with every dict's keys in sorted order, ``None`` holding no leaf.
The port walks its trees the same way, so leaf ``i`` of either package is
the same quantity and a leaf's path (``units/0/attn/wq``, ``opt/mu/3/m``)
is the reference's checkpoint key.

One leaf type is the port's own: :class:`Stack`.  The reference stacks
each unit's parameters along a leading axis (``units/...`` of shape
``(L, ...)``) for ``lax.scan``; the port's LM keeps one tensor per unit,
and a ``Stack`` holds those tensors as one leaf, ``stacked()`` giving the
reference's array.
"""
from __future__ import annotations

import torch


class Stack(tuple):
    """One leaf made of per-unit tensors: the reference's stacked
    ``(L, ...)`` array, unit ``u`` being ``self[u]``."""

    def stacked(self) -> torch.Tensor:
        return torch.stack(tuple(self))


def _is_sequence(tree) -> bool:
    """A tuple or list holding leaves, as ``jax.tree`` sees one: not a
    :class:`Stack` or another tuple subclass (a partition spec is a leaf)."""
    return type(tree) in (tuple, list)


def leaves_with_paths(tree, prefix=()):
    """``(path, leaf)`` in ``jax.tree.leaves`` order: dict keys sorted,
    tuples and lists in order, ``None`` empty.  Everything else is a leaf:
    tensors, numpy arrays, :class:`Stack` s, tuple subclasses."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + (k,))
    elif _is_sequence(tree):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def path_key(path) -> str:
    """The reference's checkpoint key of a path: its parts joined by ``/``."""
    return "/".join(str(p) for p in path)


def _map(fn, tree, rest, path):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], [r[k] for r in rest], path + (k,))
                for k in tree}
    if _is_sequence(tree):
        return type(tree)(_map(fn, v, [r[i] for r in rest], path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def map_leaves(fn, tree, *rest):
    """``tree`` with every leaf replaced by ``fn(leaf, *rest_leaves)``, the
    other trees walked in step (``jax.tree.map``)."""
    return _map(lambda _, *ls: fn(*ls), tree, rest, ())


def unflatten(tree, values):
    """``tree`` with its leaves replaced by ``values``, given in
    :func:`leaves` order."""
    table = {path: v for (path, _), v in
             zip(leaves_with_paths(tree), values, strict=True)}
    return _map(lambda path, _: table[path], tree, (), ())


def map_with_paths(fn, tree):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    return _map(fn, tree, (), ())


def parts(leaf) -> tuple:
    """The tensors of a leaf: a :class:`Stack`'s units, else the leaf."""
    return tuple(leaf) if isinstance(leaf, Stack) else (leaf,)


def flat_parts(tree) -> list:
    """Every tensor of ``tree``: its leaves' :func:`parts`, in order."""
    return [t for leaf in leaves(tree) for t in parts(leaf)]


def from_parts(tree, flat):
    """``tree`` rebuilt from :func:`flat_parts`-ordered tensors ``flat``."""
    it = iter(flat)
    return unflatten(tree, [Stack(next(it) for _ in leaf)
                            if isinstance(leaf, Stack) else next(it)
                            for leaf in leaves(tree)])


def as_array(leaf) -> torch.Tensor:
    """A leaf as one tensor, a :class:`Stack` stacked."""
    return leaf.stacked() if isinstance(leaf, Stack) else leaf


def like(leaf, array: torch.Tensor):
    """``array`` shaped as ``leaf``: split into a :class:`Stack` along its
    leading axis when ``leaf`` is one."""
    if isinstance(leaf, Stack):
        return Stack(array.unbind(0))
    return array


@torch.no_grad()
def copy_(dst, src) -> None:
    """Copy every leaf of ``src`` into the tensors of ``dst`` in place."""
    for d, s in zip(leaves(dst), leaves(src), strict=True):
        for a, b in zip(parts(d), parts(s), strict=True):
            a.copy_(b)
