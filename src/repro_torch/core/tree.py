"""Parameter pytrees as nested dicts and lists of tensors.

The leaf order is the one ``jax.flatten_util.ravel_pytree`` uses: dict keys
sorted, then list order.  Every flat view of parameters in the port (the
plane, the member stacks) follows it, so a port plane and a JAX plane of the
same parameters are equal element by element.
"""
from __future__ import annotations


def tree_leaves(tree) -> list:
    """Leaves in ``ravel_pytree`` order (sorted dict keys, list order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves):
    """Rebuild ``template``'s structure from ``leaves`` (same order as
    ``tree_leaves``)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over trees of one structure."""
    others = [tree_leaves(r) for r in rest]
    leaves = tree_leaves(tree)
    return tree_unflatten(tree, [fn(x, *(o[i] for o in others))
                                 for i, x in enumerate(leaves)])
