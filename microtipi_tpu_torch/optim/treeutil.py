"""Linear-algebra helpers over a tensor or a ``dict[str, Tensor]``.

Port of ``microtipi_tpu/optim/treeutil.py``: the optimizer's vocabulary
(dot, norm, axpy, select) over its variable, which is one tensor for the
object step and a dict of families for the joint PSF fit. Dict leaves are
visited in sorted-key order, as ``jax.tree`` does, so sums accumulate in the
same order as in the JAX package. A sharded volume's tiles are a dict
keyed (batch, z) (``parallel/mesh.py``), summed batch-major. On a mesh over
processes each rank holds its own tiles, as a :class:`Shares` that sums its
dots over every rank in that order, so every rank takes the same decisions.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

Tree = Union[torch.Tensor, dict]

__all__ = ["Shares", "Tree", "leaves", "like", "tmap", "tdot", "tnorm", "taxpy", "tscale", "tsub", "twhere",
           "value_and_grad"]


class Shares(dict):
    """A dict variable that is this process's share of a larger one. ``total``
    takes the per-leaf values of this share (a dict by key) and returns their
    sum over every share, the same on every process. The tree operations keep
    the kind."""

    def __init__(self, items, total: Callable[[dict], torch.Tensor]):
        super().__init__(items)
        self.total = total


def like(trees, items: dict) -> dict:
    """``items`` as a tree of the kind of ``trees``' first :class:`Shares`
    (a plain dict if none is one)."""
    ref = next((t for t in trees if isinstance(t, Shares)), None)
    return items if ref is None else Shares(items, ref.total)


def leaves(a: Tree) -> list[torch.Tensor]:
    return [a[k] for k in sorted(a)] if isinstance(a, dict) else [a]


def tmap(fn: Callable, a: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leaf-wise across trees of the same structure."""
    if isinstance(a, dict):
        return like((a, *rest), {k: fn(a[k], *(r[k] for r in rest)) for k in sorted(a)})
    return fn(a, *rest)


def tdot(a: Tree, b: Tree) -> torch.Tensor:
    """Sum of elementwise products over all leaves, a 0-dim tensor on the
    first leaf's device: each leaf's dot is taken on its own device and
    added there in leaf order, so a variable sharded over devices
    (``parallel/``, keyed (batch, z)) sums in a fixed order; a
    :class:`Shares` hands its per-leaf dots to its ``total``."""
    parts = [torch.dot(x.reshape(-1), y.reshape(-1)) for x, y in zip(leaves(a), leaves(b))]
    share = next((t for t in (a, b) if isinstance(t, Shares)), None)
    if share is not None:
        return share.total(dict(zip(sorted(share), parts)))
    first = parts[0].device
    return sum((t.to(first) for t in parts[1:]), parts[0])


def tnorm(a: Tree) -> torch.Tensor:
    return torch.sqrt(tdot(a, a))


def _on(alpha, t: torch.Tensor):
    """A scalar ``alpha`` where leaf ``t`` is: a 0-dim tensor (a ``tdot`` on
    the first leaf's device) goes to ``t``'s device, since the leaves of a
    variable sharded over cards lie on several."""
    return alpha.to(t.device) if isinstance(alpha, torch.Tensor) else alpha


def taxpy(alpha, x: Tree, y: Tree) -> Tree:
    """alpha * x + y."""
    return tmap(lambda xi, yi: _on(alpha, xi) * xi + yi, x, y)


def tscale(alpha, x: Tree) -> Tree:
    return tmap(lambda xi: _on(alpha, xi) * xi, x)


def tsub(a: Tree, b: Tree) -> Tree:
    return tmap(torch.subtract, a, b)


def twhere(pred: Tree, a: Tree, b: Tree) -> Tree:
    """Elementwise select between two same-structure trees."""
    return tmap(torch.where, pred, a, b)


def value_and_grad(objective: Callable[[Tree], torch.Tensor]) -> Callable:
    """``x -> (f, grad f)`` by autograd, the counterpart of
    ``jax.value_and_grad``; ``f`` and the gradient come back detached. A
    per-lane ``f`` of a batch (B,) gives the gradient of its sum, which is
    each lane's own gradient."""

    def fun(x: Tree):
        with torch.enable_grad():
            xv = tmap(lambda t: t.detach().requires_grad_(True), x)
            f = objective(xv)
            grads = torch.autograd.grad(f.sum(), leaves(xv))
        if isinstance(xv, dict):
            return f.detach(), like((xv,), dict(zip(sorted(xv), grads)))
        return f.detach(), grads[0]

    return fun
