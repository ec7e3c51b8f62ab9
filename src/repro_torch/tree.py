"""Nested-dict parameter trees: the port's stand-in for ``jax.tree_util``.

Parameters, task vectors and packed experts are nested ``dict``s of
leaves.  Flattening walks keys in sorted order, exactly as JAX flattens a
dict, so leaf order (and hence segment order in the compression buffer)
matches the JAX package.  Paths are ``"/"``-joined keys, the strings the
JAX package's ``peft.lora._path_str`` produces for dict trees.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

Tree = Any


def _path_str(keys) -> str:
    return "/".join(str(k) for k in keys)


def _walk(node, keys, is_leaf, out) -> None:
    if isinstance(node, dict) and not (is_leaf and is_leaf(node)):
        for k in sorted(node):
            _walk(node[k], keys + (k,), is_leaf, out)
    elif node is not None:
        out.append((_path_str(keys), node))


def flatten_with_paths(tree: Tree, is_leaf: Optional[Callable] = None
                       ) -> list[tuple[str, Any]]:
    """[(path, leaf)] in JAX's dict order (sorted keys, depth first).

    The walk is a module-level function: a recursive closure would sit in
    a reference cycle with the list it fills, which would keep every leaf
    alive (device memory included) until Python's cyclic collector ran."""
    out: list[tuple[str, Any]] = []
    _walk(tree, (), is_leaf, out)
    return out


def leaves(tree: Tree, is_leaf: Optional[Callable] = None) -> list:
    return [l for _, l in flatten_with_paths(tree, is_leaf)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree,
             is_leaf: Optional[Callable] = None) -> Tree:
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    return fn(tree, *rest)


def unflatten_paths(flat: dict[str, Any]) -> dict:
    """{path: leaf} -> nested dict (inverse of :func:`flatten_with_paths`)."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def unflatten_like(like: Tree, leaves_: list,
                   is_leaf: Optional[Callable] = None) -> Tree:
    """A tree of ``like``'s structure holding ``leaves_`` in
    :func:`flatten_with_paths` order (inverse of :func:`leaves`; keys may
    hold ``"/"``, as LoRA trees' path keys do)."""
    return _build(like, iter(leaves_), is_leaf)


def _build(node, it, is_leaf):
    """:func:`unflatten_like`'s walk (module level, so no reference cycle
    holds the leaves)."""
    if isinstance(node, dict) and not (is_leaf and is_leaf(node)):
        return {k: _build(node[k], it, is_leaf) for k in sorted(node)}
    return None if node is None else next(it)
