"""Collectives on a process group, for the parallel paths.

New in the port (JAX inserts its collectives inside `shard_map` and the
SPMD partitioner; torch calls them by hand): `all_reduce` (sum or mean),
`all_gather` in rank order, `shift_right` / `shift_left` (a tensor to the
next rank, one from the previous, or the reverse: pp's activations),
`send` / `recv`, `broadcast` and `barrier`, each on a group (None: the
default group). These detach their inputs. The differentiable ones, for a
time axis sharded over a group (sp's trunks, inference and training):
`halo` (a conv layer's left context from the previous rank; rank 0's own
start context), `tail_handoff` (a transposed conv's overlap into the next
rank), `gather_time` (all-gather, reduce-scatter backward) and `sum_over`
(all-reduce both ways).

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


def _shift(x: torch.Tensor, group: Group, step: int
            ) -> tp.Optional[torch.Tensor]:
    """Send `x` to rank `r + step` and return rank `r - step`'s `x` (None
    where that rank does not exist)."""
    r, n = rank(group), world(group)
    wire = _wire(x, group)
    ops = []
    if 0 <= r + step < n:
        out = x.detach().to(wire).contiguous()
        ops.append(dist.P2POp(dist.isend, out, global_rank(group, r + step),
                              group))
    got = None
    if 0 <= r - step < n:
        got = torch.empty(x.shape, dtype=x.dtype, device=wire)
        ops.append(dist.P2POp(dist.irecv, got, global_rank(group, r - step),
                              group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return None if got is None else _out(got, x)


def shift_right(x: torch.Tensor, group: Group = None
                ) -> tp.Optional[torch.Tensor]:
    """Send `x` to the next rank and return the previous rank's `x`
    (None on rank 0; the last rank sends nothing). Every rank's `x` has
    the same shape."""
    return _shift(x, group, 1)


def shift_left(x: torch.Tensor, group: Group = None
               ) -> tp.Optional[torch.Tensor]:
    """Send `x` to the previous rank and return the next rank's `x` (None
    on the last rank; rank 0 sends nothing)."""
    return _shift(x, group, -1)


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
# Differentiable collectives of a sharded time axis (the data×seq step)
# ---------------------------------------------------------------------------
#
# Each backward is its forward's adjoint, with the cotangent convention of
# `train.steps`: a cotangent of a tensor replicated over the group is this
# rank's share (the true cotangent is the sum over the ranks). Every rank
# builds the same graph of these nodes, so their backwards run in the same
# order on every rank. Under `torch.no_grad()` they are the plain
# collectives (the inference paths of `parallel.sp`).

class _Halo(torch.autograd.Function):
    """Forward: the previous rank's `tail` (rank 0: `prime.clone()`, its
    own stream-start context). Backward: the cotangent goes back to the
    previous rank, where it is `tail`'s; rank 0's is `prime`'s."""

    @staticmethod
    def forward(ctx, tail, prime, group):
        ctx.group = group
        got = shift_right(tail, group)
        return prime.clone() if got is None else got

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        back = shift_left(g, ctx.group)
        first = rank(ctx.group) == 0
        return back, (g if first else None), None


class _TailHandoff(torch.autograd.Function):
    """Forward: `head` with the previous rank's `tail` added to its first
    samples (time on the last axis; rank 0 adds nothing). Backward: the
    cotangent of those samples goes back to the previous rank, where it is
    `tail`'s."""

    @staticmethod
    def forward(ctx, head, tail, group):
        ctx.group, ctx.pt = group, tail.shape[-1]
        got = shift_right(tail, group)
        out = head.clone()
        if got is not None:
            out[..., :ctx.pt] += got
        return out

    @staticmethod
    def backward(ctx, g):
        back = shift_left(g[..., :ctx.pt].contiguous(), ctx.group)
        return g, back, None


class _GatherTime(torch.autograd.Function):
    """Forward: every rank's `x` concatenated along `dim` in rank order.
    Backward: the sum of the ranks' cotangents, this rank's slice: a
    reduce-scatter on NCCL; gloo has none, so there an all-reduce of the
    whole cotangent, then this rank's slice of it."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, n = ctx.group, ctx.dim, ctx.n
        if transport(group) == "device":
            # the rank-ordered blocks along dim 0, as NCCL scatters them
            src = g.movedim(dim, 0).to(_wire(g, group)).contiguous()
            mine = src.new_empty((n,) + tuple(src.shape[1:]))
            dist.reduce_scatter_tensor(mine, src, group=group)
            return _out(mine.movedim(0, dim).contiguous(), g), None, None
        total = all_reduce(g.contiguous(), "sum", group)
        return total.narrow(dim, rank(group) * n, n), None, None


class _SumOver(torch.autograd.Function):
    """The sum over the group's ranks, forward and backward (all-reduce is
    its own adjoint)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), "sum", ctx.group), None


def _wide(x: tp.Optional[torch.Tensor]) -> tp.Optional[torch.Tensor]:
    """`x` as the seq exchanges carry it: a reduced-precision activation
    (bf16 under `compute_dtype`) in float32, for the transport only (the
    cast back on arrival, and its cotangent's round trip, are exact), so
    gloo and NCCL see one dtype; float32 and float64 as they are."""
    if x is None or x.dtype in (torch.float32, torch.float64):
        return x
    return x.float()


def halo(tail: torch.Tensor, prime: tp.Optional[torch.Tensor],
         group: Group = None) -> torch.Tensor:
    """A conv layer's left context: the previous rank's `tail`; on rank 0
    `prime` (which only rank 0 needs). Differentiable."""
    return _Halo.apply(_wide(tail), _wide(prime), group).to(tail.dtype)


def tail_handoff(head: torch.Tensor, tail: torch.Tensor,
                 group: Group = None) -> torch.Tensor:
    """A transposed conv's overlap-add across ranks: `head` (`[..., L]`)
    plus the previous rank's `tail` (`[..., k - s]`) on its first samples.
    Differentiable."""
    return _TailHandoff.apply(_wide(head), _wide(tail), group).to(head.dtype)


def gather_time(x: torch.Tensor, group: Group = None, dim: int = 1
                ) -> torch.Tensor:
    """`all_gather` along `dim` with a reduce-scatter backward."""
    return _GatherTime.apply(_wide(x), group, dim).to(x.dtype)


def sum_over(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """`all_reduce` (sum) with an all-reduce backward."""
    return _SumOver.apply(x, group)


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
    `group`'s ranks (the mesh's `data` axis); see the module docstring.
    `check_replicated` holds the metrics equal over the whole world (a
    data×seq mesh's seq peers too)."""

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
        every = all_gather(mine[None]).cpu()
        bits = every.view(torch.int32)        # NaN equal to its own bits
        differ = [k for k, col in zip(names, bits.t())
                  if not bool((col == col[0]).all())]
        if differ:
            raise RuntimeError(
                f"data-parallel step: {', '.join(differ)} differ between "
                f"the ranks ({every.tolist()} over {names}); a batch mean "
                "or sum was taken without `dp`, so its gradient would be "
                "summed over the ranks")
