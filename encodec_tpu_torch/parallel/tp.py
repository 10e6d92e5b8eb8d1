"""Codebook-sharded (tensor-parallel) RVQ search over a `model` mesh axis.

Port of `encodec_tpu/parallel/tp.py` (`nearest_codebook_tp`,
`rvq_encode_tp`). The nearest search shards cleanly over the codebook:
each rank scores its `bins/n` rows with K1 (`kernels.nearest_codebook`,
its plain twin for CPU tensors), which returns the winner's score (its
negated distance, the number K1 compares); the (score, global index)
pairs of every shard are gathered, and the highest score wins, the lowest
global index on ties: each shard's K1 already picks its lowest local index,
and the first shard among equal scores has the lowest offset. K1 computes
each row's score in the same order whichever slice of the book it is given,
so on the card the codes equal the single-device K1 chain's at every
position. The winning row reaches every rank as a masked sum (the owning
rank contributes it, the others zeros: JAX's masked `psum`, exact), so the
residual update never gathers the sharded book.

With `batch_axis` (a 2-D `data × model` mesh) each data row searches its
block of the batch and the codes are gathered over `data` at the end.
"""

from __future__ import annotations

import typing as tp

import torch

from ..kernels import nearest_codebook
from . import comm


def _groups(mesh, axis_name: str, batch_axis: tp.Optional[str]):
    model = mesh.get_group(axis_name)
    data = mesh.get_group(batch_axis) if batch_axis else None
    return model, data


def _rows(x: torch.Tensor, data) -> torch.Tensor:
    """This data rank's block of rows of `x` (all of them without a data
    axis)."""
    if data is None:
        return x
    r, n = comm.rank(data), comm.world(data)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} data "
                         "ranks")
    b = x.shape[0] // n
    return x[r * b:(r + 1) * b]


def _shard(embed: torch.Tensor, model) -> tp.Tuple[torch.Tensor, int]:
    """This rank's slice of the book and its offset."""
    n, r = comm.world(model), comm.rank(model)
    bins = embed.shape[0]
    if bins % n:
        raise ValueError(f"{bins} codebook rows do not split over {n} "
                         "model ranks")
    per = bins // n
    return embed[r * per:(r + 1) * per].contiguous(), r * per


def _search(x: torch.Tensor, embed_local: torch.Tensor, offset: int, model,
            with_lookup: bool):
    """Global indices `[N]` (int64) of the nearest rows over every shard,
    and with `with_lookup` the winning rows `[N, D]`."""
    idx, _, score = nearest_codebook(x.contiguous(), embed_local,
                                     return_score=True)
    scores = comm.all_gather(score[None], model)            # [S, N]
    idxs = comm.all_gather((idx.long() + offset)[None], model)
    best = scores.argmax(dim=0)   # the first maximum: the lowest shard
    gidx = idxs.gather(0, best[None])[0]
    if not with_lookup:
        return gidx
    per = embed_local.shape[0]
    mine = (gidx >= offset) & (gidx < offset + per)
    rows = embed_local[(gidx - offset).clamp(0, per - 1)]
    q = comm.all_reduce(torch.where(mine[:, None], rows,
                                    torch.zeros_like(rows)), "sum", model)
    return gidx, q


def nearest_codebook_tp(x: torch.Tensor, embed: torch.Tensor, mesh,
                        axis_name: str = "model",
                        batch_axis: tp.Optional[str] = None) -> torch.Tensor:
    """Sharded nearest-codebook search: x `[N, D]`, embed `[bins, D]` (the
    whole book, the same on every rank; each rank searches its slice).
    Returns the `[N]` global indices (int64) on every rank, the
    single-device search's."""
    model, data = _groups(mesh, axis_name, batch_axis)
    local, offset = _shard(embed, model)
    gidx = _search(_rows(x, data), local, offset, model, with_lookup=False)
    return gidx if data is None else comm.all_gather(gidx, data)


@torch.no_grad()
def rvq_encode_tp(state, x: torch.Tensor, cfg, mesh, *,
                  n_q: tp.Optional[int] = None, axis_name: str = "model",
                  batch_axis: tp.Optional[str] = None) -> torch.Tensor:
    """Tensor-parallel `rvq_encode`: x `[B, T, D]` → codes `[K, B, T]`
    (int32, as `quant.rvq_encode`). Each stage's search and its residual
    lookup run sharded; each rank takes its slice of the books once."""
    n_q = min(n_q or cfg.n_q, cfg.n_q)
    model, data = _groups(mesh, axis_name, batch_axis)
    B, T, D = x.shape
    residual = _rows(x.reshape(B * T, D).float(), data).contiguous()
    books = [_shard(b, model) for b in state.embed[:1 if cfg.shared_codebook
                                                   else n_q]]
    codes = []
    for k in range(n_q):
        local, offset = books[0 if cfg.shared_codebook else k]
        idx, q = _search(residual, local, offset, model, with_lookup=True)
        residual = residual - q
        codes.append(idx)
    out = torch.stack(codes).to(torch.int32)                 # [K, rows]
    if data is not None:
        out = comm.all_gather(out.t().contiguous(), data).t()
    return out.reshape(n_q, B, T)
