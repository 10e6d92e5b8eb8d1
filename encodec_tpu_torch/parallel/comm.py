"""Collectives on a process group, for the parallel paths.

New in the port (JAX inserts its collectives inside `shard_map` and the
SPMD partitioner; torch calls them by hand): `all_reduce` (sum or mean),
`all_gather` in rank order, `shift_right` (a tensor to the next rank, one
from the previous: sp's halos and pp's activations), `send` / `recv`,
`broadcast` and `barrier`, each on a group (None: the default group).

Transport. The group's backend picks the device a collective runs on
(`transport(group)`), never a failure. On an NCCL group it is the card:
CUDA tensors stay there, and a CPU tensor is copied to the current card
and its result back to the host. gloo reduces and broadcasts CUDA tensors
but has no gather or point-to-point for them, so on a gloo group every
CUDA tensor travels through host memory: a copy to the host, the
collective there, a copy back. Each function returns its result on its
input's device. A collective's error propagates.

Data parallelism (`DataParallel`). The training steps built with a mesh
compute every loss as a mean over the *global* batch, identical on every
rank, so that the step equals the single-process step on the whole batch
(JAX's mesh step is that step, partitioned). The step hands a
`DataParallel` over its data group to each function that takes a batch
mean or reads the quantizer's rows (the `dp` argument of the losses,
`models.forward_train` and `quant.rvq_forward`; `ops.batch_reduce.LOCAL`,
the identity, outside a mesh):
- `dp.mean(m)` turns `m`, a mean over this rank's rows, into the mean over
  every rank's rows (the ranks hold equal row counts); `dp.sum(s)` sums a
  sum over the ranks; `dp.gather(x)` concatenates rows in rank order;
- the forward reduction of `mean` and `sum` has the identity as its
  backward: each rank computes the same replicated loss, so the gradient
  of the global loss for this rank's inputs is the upstream gradient as it
  is, and a parameter's gradient is the SUM over ranks of what each rank's
  backward gives (`all_reduce_tree`). No collective runs in a backward;
- `dp.check_replicated(metrics)` ends every step: the scalar metrics must
  be equal on every rank, bit for bit. A batch mean that missed `dp` is
  this rank's own, so the loss differs between the ranks and the step
  raises instead of summing a local mean's gradient over the ranks.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.distributed as dist

from ..ops.batch_reduce import BatchReduce

Group = tp.Optional[dist.ProcessGroup]

# flat buckets of the gradient all-reduce (floats per bucket)
BUCKET_NUMEL = 1 << 23


def world(group: Group = None) -> int:
    return dist.get_world_size(group)


def rank(group: Group = None) -> int:
    return dist.get_rank(group)


def global_rank(group: Group, group_rank: int) -> int:
    """The default group's rank of `group`'s rank `group_rank`."""
    return group_rank if group is None else dist.get_global_rank(
        group, group_rank)


def transport(group: Group = None) -> str:
    """"device" (NCCL: tensors stay on the card) or "host" (gloo: CUDA
    tensors are staged through host memory)."""
    return "device" if dist.get_backend(group) == "nccl" else "host"


def _wire(x: torch.Tensor, group: Group) -> torch.device:
    """The device a collective on `group` carries `x` on: the host on
    gloo, the card on NCCL (`x`'s own, or the current one for a CPU
    tensor)."""
    if transport(group) == "host":
        return torch.device("cpu")
    if x.device.type == "cuda":
        return x.device
    return torch.device("cuda", torch.cuda.current_device())


def _out(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return y.to(like.device) if y.device != like.device else y


def all_reduce(x: torch.Tensor, op: str = "sum", group: Group = None
               ) -> torch.Tensor:
    """The sum (or mean) of `x` over the group's ranks, as a new tensor on
    `x`'s device; `x` is not changed."""
    if op not in ("sum", "mean"):
        raise ValueError(f"all_reduce op must be 'sum' or 'mean', got {op!r}")
    y = x.detach().to(_wire(x, group), copy=True).contiguous()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    if op == "mean":
        y = y / world(group)
    return _out(y, x)


def all_gather(x: torch.Tensor, group: Group = None, dim: int = 0
               ) -> torch.Tensor:
    """Every rank's `x` (equal shapes), concatenated along `dim` in rank
    order."""
    src = x.detach().to(_wire(x, group)).contiguous()
    parts = [torch.empty_like(src) for _ in range(world(group))]
    dist.all_gather(parts, src, group=group)
    return _out(torch.cat(parts, dim=dim), x)


def broadcast(x: torch.Tensor, src: int = 0, group: Group = None
              ) -> torch.Tensor:
    """Group rank `src`'s `x` on every rank (a new tensor; the other ranks'
    `x` gives the shape and dtype)."""
    y = x.detach().to(_wire(x, group), copy=True).contiguous()
    dist.broadcast(y, global_rank(group, src), group=group)
    return _out(y, x)


def send(x: torch.Tensor, dst: int, group: Group = None) -> None:
    """`x` to group rank `dst` (blocking)."""
    y = x.detach().to(_wire(x, group)).contiguous()
    dist.send(y, global_rank(group, dst), group=group)


def recv(like: torch.Tensor, src: int, group: Group = None) -> torch.Tensor:
    """A tensor shaped like `like` (on its device) from group rank `src`."""
    y = torch.empty(like.shape, dtype=like.dtype,
                    device=_wire(like, group))
    dist.recv(y, global_rank(group, src), group=group)
    return _out(y, like)


def shift_right(x: torch.Tensor, group: Group = None
                ) -> tp.Optional[torch.Tensor]:
    """Send `x` to the next rank and return the previous rank's `x`
    (None on rank 0; the last rank sends nothing). Every rank's `x` has
    the same shape."""
    r, n = rank(group), world(group)
    wire = _wire(x, group)
    ops = []
    if r + 1 < n:
        out = x.detach().to(wire).contiguous()
        ops.append(dist.P2POp(dist.isend, out, global_rank(group, r + 1),
                              group))
    got = None
    if r > 0:
        got = torch.empty(x.shape, dtype=x.dtype, device=wire)
        ops.append(dist.P2POp(dist.irecv, got, global_rank(group, r - 1),
                              group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return None if got is None else _out(got, x)


def barrier(group: Group = None) -> None:
    dist.barrier(group=group)


def any_rank(flag: bool, group: Group = None) -> bool:
    """True on every rank when `flag` is True on any (the ranks agree on a
    preemption request, so none waits in a collective the others left)."""
    t = torch.tensor([1.0 if flag else 0.0])
    return bool(all_reduce(t, "sum", group).item() > 0)


def all_reduce_tree(tree, group: Group = None):
    """The sum over ranks of every tensor leaf of `tree` (dicts, lists,
    tuples), reduced in flat buckets of at most `BUCKET_NUMEL` floats in
    the leaves' flattening order (`train.optim.tree_leaves`); returns a
    tree of new tensors."""
    from ..train.optim import tree_leaves, tree_map

    leaves = tree_leaves(tree)
    out: tp.Dict[int, torch.Tensor] = {}
    start = 0
    while start < len(leaves):
        stop, numel = start, 0
        while stop < len(leaves) and (stop == start or numel
                                      + leaves[stop].numel() <= BUCKET_NUMEL):
            numel += leaves[stop].numel()
            stop += 1
        chunk = leaves[start:stop]
        flat = all_reduce(torch.cat([t.reshape(-1) for t in chunk]), "sum",
                          group)
        for t, piece in zip(chunk, flat.split([t.numel() for t in chunk])):
            out[id(t)] = piece.view_as(t)
        start = stop
    return tree_map(lambda t: out[id(t)], tree)


# ---------------------------------------------------------------------------
# The reductions of a data-parallel training step
# ---------------------------------------------------------------------------

class _ReplicatedSum(torch.autograd.Function):
    """The sum over ranks in the forward; the identity in the backward
    (the result feeds a loss replicated on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class DataParallel(BatchReduce):
    """The batch reductions of a training step whose batch is split over
    `group`'s ranks (the mesh's `data` axis); see the module docstring."""

    def __init__(self, group: Group):
        self.group = group

    def mean(self, m: torch.Tensor) -> torch.Tensor:
        return _ReplicatedSum.apply(m, self.group) / world(self.group)

    def sum(self, s: torch.Tensor) -> torch.Tensor:
        return _ReplicatedSum.apply(s, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return all_gather(x, self.group)

    def rows(self) -> tp.Tuple[int, int]:
        return rank(self.group), world(self.group)

    def check_replicated(self, metrics: tp.Mapping[str, tp.Any]) -> None:
        names = sorted(k for k, v in metrics.items()
                       if isinstance(v, torch.Tensor) and v.dim() == 0
                       and v.is_floating_point())
        if not names:
            return
        dev = metrics[names[0]].device
        mine = torch.stack([metrics[k].detach().float().to(dev)
                            for k in names])
        every = all_gather(mine[None], self.group).cpu()
        bits = every.view(torch.int32)        # NaN equal to its own bits
        differ = [k for k, col in zip(names, bits.t())
                  if not bool((col == col[0]).all())]
        if differ:
            raise RuntimeError(
                f"data-parallel step: {', '.join(differ)} differ between "
                f"the ranks ({every.tolist()} over {names}); a batch mean "
                "or sum was taken without `dp`, so its gradient would be "
                "summed over the ranks")
