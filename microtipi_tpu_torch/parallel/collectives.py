"""The collectives of a mesh that spans processes.

A mesh built with a process group (``mesh.make_mesh(..., group=pg)``) gives
each cell an owner rank, and a sharded volume's tiles live with their owners
(the counterpart of a JAX mesh over ``jax.distributed`` processes). These
functions move what one rank holds to the ranks that need it, over
``torch.distributed``:

- :func:`exchange`: tensors between cells, the sends and receives paired in
  one batch, in the order the caller lists the moves, which every rank lists
  alike; a move between two cells of one rank stays on that rank;
- :func:`transpose`: the distributed FFT's exchange within each mesh row,
  differentiable (its backward is the inverse exchange);
- :func:`assemble`: each cell's tensor put together from pieces of other
  cells' tiles (a slab with the planes after it, the frames of a z column),
  differentiable (its backward sends each piece's gradient back to its tile);
- :func:`all_cells`: every listed cell's tensor on every rank (the
  counterpart of ``process_allgather``);
- :func:`cell_values`: every listed cell's 0-dim value on every rank in one
  all-gather, differentiable (each value's gradient goes back to its own
  rank's part).

Every rank gets the same bits: a reduction gathers the cells' parts and adds
them on each rank in the single-process mesh's order (``Mesh.add``), never
through a backend reduction whose order is the backend's.

Transport: NCCL moves the tensors where they are (one CUDA device a rank).
Gloo moves host tensors, so a CUDA tensor goes through a host copy on its way
to and from gloo. A complex tensor travels as its real view. Nothing falls
back: a backend that refuses an operation raises, and a rank that stops makes
the others fail at the group's timeout.

:data:`sent` counts the bytes this rank sent, by kind ("halo", "transpose",
"cells", "values", "rows", "pupil"), since the last ``sent.clear()``.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

__all__ = ["all_cells", "assemble", "cell_values", "exchange", "sent", "transpose"]

#: Bytes this rank sent to other ranks since the last ``clear()``, by kind.
sent: Counter = Counter()


def _wire(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` as it goes on the wire: contiguous and real; on the host under
    gloo, on this rank's device under NCCL."""
    t = t.detach().contiguous()
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.to("cpu" if mesh.backend == "gloo" else mesh.first)


def _buffer(shape, dtype: torch.dtype, mesh) -> torch.Tensor:
    """A receive buffer for a tensor of ``shape`` and ``dtype`` (see :func:`_wire`)."""
    if dtype.is_complex:
        shape, dtype = (*shape, 2), torch.empty((), dtype=dtype).real.dtype
    return torch.empty(shape, dtype=dtype, device="cpu" if mesh.backend == "gloo" else mesh.first)


def _unwire(buf: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    return (torch.view_as_complex(buf) if dtype.is_complex else buf).to(device)


def exchange(mesh, moves, kind: str = "halo") -> list:
    """Carry out ``moves``, a list of ``(src cell, dst cell, tensor, shape,
    dtype)``: ``tensor`` is the source where this rank owns ``src`` (else
    None), ``shape`` and ``dtype`` describe it for the receiver. Returns, per
    move, the tensor on ``dst``'s device where this rank owns ``dst`` (the
    source itself, or a view of it, where it is there already), else None.
    Every rank passes the same list in the same order: a move's place in it
    is its tag."""
    out, ops, recvs = [None] * len(moves), [], []
    for i, (src, dst, t, shape, dtype) in enumerate(moves):
        mine_src, mine_dst = mesh.is_local(*src), mesh.is_local(*dst)
        if mine_src and mine_dst:
            out[i] = t.to(mesh.device(*dst))
        elif mine_src:
            w = _wire(t, mesh)
            sent[kind] += w.numel() * w.element_size()
            ops.append(dist.P2POp(dist.isend, w, mesh.peer(*dst), mesh.group, tag=i))
        elif mine_dst:
            buf = _buffer(shape, dtype, mesh)
            ops.append(dist.P2POp(dist.irecv, buf, mesh.peer(*src), mesh.group, tag=i))
            recvs.append((i, buf, dtype, mesh.device(*dst)))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for i, buf, dtype, device in recvs:
        out[i] = _unwire(buf, dtype, device)
    return out


def _transpose(mesh, cells, local, tensors, split: int, cat: int) -> list:
    """Within each mesh row of ``cells``: cell j's output is the j-th block
    along ``split`` of every cell's tensor of the row, concatenated along
    ``cat`` in z order. ``tensors`` are those of ``local`` (this rank's cells).
    A block from another rank is laid out as a local block is (an FFT's
    output may be channels-last), so the concatenation, and the FFT after it,
    is the same bits as on a mesh driven by one process."""
    p = mesh.shape["z"]
    by = dict(zip(local, tensors))
    like = tensors[0]
    blk = like.shape[split] // p
    block = like.narrow(split, 0, blk)
    moves = [((b, i), (b, j), by[(b, i)].narrow(split, j * blk, blk) if (b, i) in by else None, block.shape,
              like.dtype) for b, j in cells for i in range(p)]
    pieces = {}
    for (src, dst, *_), t in zip(moves, exchange(mesh, moves, "transpose")):
        if t is not None:
            pieces[(dst, src[1])] = t if src in by else torch.empty_like(block, device=t.device).copy_(t)
    return [torch.cat([pieces[(c, i)] for i in range(p)], dim=cat) for c in local]


class _Transpose(torch.autograd.Function):
    """:func:`_transpose` with the inverse exchange as its backward."""

    @staticmethod
    def forward(ctx, mesh, cells, local, split, cat, *tensors):
        ctx.args = (mesh, cells, local, split, cat)
        return tuple(_transpose(mesh, cells, local, tensors, split, cat))

    @staticmethod
    def backward(ctx, *grads):
        mesh, cells, local, split, cat = ctx.args
        return (None,) * 5 + tuple(_transpose(mesh, cells, local, grads, cat, split))


def transpose(mesh, cells, local, tensors, split: int, cat: int) -> list:
    """The distributed FFT's exchange (see :func:`_transpose`) over the rows
    of ``cells`` (every cell of a volume, batch-major), differentiable; every
    rank of the mesh calls it, forward and backward, in the same order."""
    return list(_Transpose.apply(mesh, list(cells), list(local), split, cat, *tensors))


def _sized(shape, dim: int, n: int) -> list:
    shape = list(shape)
    shape[dim] = n
    return shape


class _Assemble(torch.autograd.Function):
    """:func:`assemble` over ``pieces``, the plan's pieces of this rank's
    tiles in plan order; the backward returns each piece's gradient to the
    rank that holds it, and autograd adds a tile's pieces' gradients into it
    one by one, as it adds those of any other use of the tile. ``like``, one
    of this rank's tiles, gives the pieces' shape and ties the outputs to the
    graph on a rank that holds none of the pieces (it gets no gradient)."""

    @staticmethod
    def forward(ctx, mesh, local, plan, dim, like, *pieces):
        shape, dtype = like.shape, like.dtype
        ctx.args = (mesh, local, plan, dim, shape, dtype)
        held = iter(pieces)
        moves = [(src, dst, next(held) if mesh.is_local(*src) else None, _sized(shape, dim, n), dtype)
                 for dst, src, _, n in plan]
        parts = {c: [] for c in local}
        for (dst, *_), t in zip(plan, exchange(mesh, moves, "halo")):
            if dst in parts:
                parts[dst].append(t)
        return tuple(torch.cat(parts[c], dim) if parts[c] else torch.empty(
            _sized(shape, dim, 0), dtype=dtype, device=mesh.device(*c)) for c in local)

    @staticmethod
    def backward(ctx, *grads):
        mesh, local, plan, dim, shape, dtype = ctx.args
        by, at, moves = dict(zip(local, grads)), dict.fromkeys(local, 0), []
        for dst, src, _, n in plan:
            part = None
            if dst in by:
                part, at[dst] = by[dst].narrow(dim, at[dst], n), at[dst] + n
            moves.append((dst, src, part, _sized(shape, dim, n), dtype))
        back = [t for (_, src, *_), t in zip(plan, exchange(mesh, moves, "halo")) if mesh.is_local(*src)]
        return (None,) * 5 + tuple(back)


def assemble(mesh, local, tiles, plan, dim: int) -> dict:
    """Each local cell's tensor: the pieces ``plan`` lists for it (``(dst,
    src, start, length)``: planes ``start:start+length`` along ``dim`` of
    cell ``src``'s tile), concatenated along ``dim`` in plan order (none: an
    empty tensor). ``tiles`` are those of ``local`` (this rank's cells, all
    of one shape); every rank passes the same plan. Differentiable; its
    backward is an exchange too, so every rank must reach it."""
    by = dict(zip(local, tiles))
    pieces = [by[src].narrow(dim, start, n) for _, src, start, n in plan if mesh.is_local(*src)]
    return dict(zip(local, _Assemble.apply(mesh, list(local), list(plan), dim, tiles[0], *pieces)))


def all_cells(mesh, tiles: dict, cells, kind: str = "cells") -> dict:
    """Every cell of ``cells``' tensor on every rank, on :attr:`Mesh.first`
    (a local cell's own tensor as it is): one broadcast a cell, from its
    owner, its bytes counted under ``kind``. ``tiles`` holds this rank's;
    every cell's tensor has the shape and dtype of this rank's first."""
    like = next(iter(tiles.values()))
    out = {}
    for c in cells:
        if mesh.is_local(*c):
            buf = _wire(tiles[c], mesh)
            sent[kind] += buf.numel() * buf.element_size() * (mesh.size - 1)
        else:
            buf = _buffer(like.shape, like.dtype, mesh)
        dist.broadcast(buf, mesh.peer(*c), group=mesh.group)
        out[c] = tiles[c] if mesh.is_local(*c) else _unwire(buf, like.dtype, mesh.first)
    return out


class _CellValues(torch.autograd.Function):
    """Every listed cell's 0-dim value from its owner: one all-gather of a
    vector a rank (its own cells' values, zeros elsewhere)."""

    @staticmethod
    def forward(ctx, mesh, cells, own, dtype, *parts):
        index, first = {c: i for i, c in enumerate(cells)}, mesh.first
        mine = torch.zeros(len(cells), dtype=dtype, device=first)
        for c, p in zip(own, parts):
            if c in index:
                mine[index[c]] = p.to(first)
        w = _wire(mine, mesh)
        sent["values"] += w.numel() * w.element_size() * (mesh.size - 1)
        every = [torch.empty_like(w) for _ in range(mesh.size)]
        dist.all_gather(every, w, group=mesh.group)
        ctx.index, ctx.own, ctx.devices = index, own, [p.device for p in parts]
        return torch.stack([every[mesh.owner(*c)][i] for i, c in enumerate(cells)]).to(first)

    @staticmethod
    def backward(ctx, g):
        zero = torch.zeros((), dtype=g.dtype)
        return (None, None, None, None, *[(g[ctx.index[c]] if c in ctx.index else zero).to(d)
                                          for c, d in zip(ctx.own, ctx.devices)])


def cell_values(mesh, parts: dict, cells, dtype: torch.dtype) -> torch.Tensor:
    """The values of ``cells`` (a real 0-dim tensor of ``dtype`` each) as one
    vector on every rank, in the order of ``cells``; ``parts`` holds this
    rank's. Differentiable; the backward is local, since every rank holds the
    same gradient of a replicated result, and gives a part of a cell not
    listed a zero gradient (so that every rank's backward reaches its parts)."""
    own = list(parts)
    return _CellValues.apply(mesh, list(cells), own, dtype, *(parts[c] for c in own))
