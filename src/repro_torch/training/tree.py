"""Trees of tensors (nested dicts, lists and tuples) in the order JAX
flattens them: dict entries by sorted key, sequences in order, ``None``
an empty subtree.  The optimizer walks them, and checkpoints store their
leaves in this order, so a checkpoint written by either package restores
into the other's tree."""

from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of ``tree``, in JAX's order."""
    return [x for _, x in leaves_with_paths(tree)]


def leaves_with_paths(tree, prefix: str = "") -> list:
    """(path, leaf) pairs of ``tree`` in :func:`leaves` order; a path is
    ``/key`` for each dict entry and ``[i]`` for each sequence item on the
    way down (``/layers/attn/wq``)."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in leaves_with_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in leaves_with_paths(v, f"{prefix}[{i}]")]
    if tree is None:
        return []
    return [(prefix, tree)]


def unflatten(tree, values):
    """``tree``'s structure with its leaves replaced, in order, by
    ``values`` (an iterable as long as ``leaves(tree)``)."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}  # the caller's key order
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        if node is None:
            return None
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, (fn(*xs) for xs in zip(*flat)))
