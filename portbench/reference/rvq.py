"""The plain residual vector quantizer (SoundStream Alg. 1; EnCodec §3.2),
training and inference, in float32 PyTorch.

Training follows the breathing-tokenizer fork: one codebook of `bins`
rows shared by every stage (each stage searches the book as the stage
before it left it), EMA statistics (decay 0.99, Laplace smoothing 1e-5),
dead codes (EMA count under 2) replaced by batch rows drawn without
replacement, the straight-through estimator and the commit loss. The
draws come from a CPU `torch.Generator` in the trainer's order: one draw
of replacement rows per stage. The book starts as `drawn_books` makes it
(the fork's k-means start on the first batch is not followed: its
rounding flips make two runs part at once, PERF.md).

Distances are squared Euclidean, `‖x‖² − 2·x·E + ‖E‖²`, the first index
winning an exact tie.
"""

from __future__ import annotations

import typing as tp

import torch


def distances(x: torch.Tensor, book: torch.Tensor) -> torch.Tensor:
    """`[N, bins]` squared distances of the rows of `x` to the book's."""
    return (x.square().sum(1, keepdim=True) - 2.0 * (x @ book.t())
            + book.square().sum(1)[None])


def nearest(x: torch.Tensor, book: torch.Tensor,
            rows: int = 8192) -> torch.Tensor:
    """The nearest book row of each row of `x` (int64), in blocks."""
    return torch.cat([distances(x[i:i + rows], book).argmin(1)
                      for i in range(0, x.shape[0], rows)])


def draw(n: int, num: int, generator: torch.Generator) -> torch.Tensor:
    """`num` row indices of `n`: a permutation's first `num`, or `num`
    uniform draws where there are fewer rows."""
    if n >= num:
        return torch.randperm(n, generator=generator)[:num]
    return torch.randint(0, n, (num,), generator=generator)


class Books(tp.NamedTuple):
    embed: torch.Tensor          # [bins, D]
    embed_avg: torch.Tensor
    cluster_size: torch.Tensor   # [bins]


def train_forward(books: Books, z: torch.Tensor, arch: dict,
                  generator: torch.Generator, decay: float = 0.99,
                  eps: float = 1e-5, dead: float = 2.0,
                  forced: tp.Optional[torch.Tensor] = None):
    """The training RVQ on latents `z` [B, T, D] with one shared book.
    Returns (quantized [B, T, D] with the straight-through gradient,
    codes [K, B·T], commit losses [K], the new books, the widest gap).

    `forced` [K, B·T]: codes to take in place of the searches' (a served
    model's tokens, as it were): each stage's distance of the forced code
    less its least distance, over the latents' mean squared norm, is read,
    and the widest returned (0 without `forced`)."""
    B, T, D = z.shape
    bins, n_q = arch["bins"], arch["n_q"]
    flat = z.reshape(B * T, D)
    embed, embed_avg, size = books
    residual = flat
    quantized, codes, commits = 0.0, [], []
    scale = flat.detach().square().sum(1).mean()
    widest = 0.0
    for k in range(n_q):
        xd = residual.detach()
        if forced is None:
            idx = nearest(xd, embed)
        else:
            idx = forced[k].to(xd.device).long()
            widest = max(widest, forced_gap(xd, embed, idx, scale))
        q = embed[idx]
        counts = torch.bincount(idx, minlength=bins).to(xd.dtype)
        sums = xd.new_zeros(bins, D).index_add_(0, idx, xd)
        size = size * decay + counts * (1 - decay)
        embed_avg = embed_avg * decay + sums * (1 - decay)
        n = size.sum()
        smoothed = (size + eps) / (n + bins * eps) * n
        embed = embed_avg / smoothed[:, None]
        expired = (size < dead)[:, None]
        repl = xd[draw(xd.shape[0], bins, generator).to(xd.device)]
        embed = torch.where(expired, repl, embed)
        embed_avg = torch.where(expired, repl * smoothed[:, None], embed_avg)
        q_st = residual + (q - residual).detach()
        commits.append((q_st.detach() - residual).square().mean())
        residual = residual - q_st
        quantized = quantized + q_st
        codes.append(idx)
    return (quantized.reshape(B, T, D), torch.stack(codes),
            torch.stack(commits), Books(embed, embed_avg, size), widest)


def forced_gap(x: torch.Tensor, book: torch.Tensor, idx: torch.Tensor,
               scale: torch.Tensor, rows: int = 8192) -> float:
    """The widest distance gap of the codes `idx` of the rows `x` over the
    nearest's, relative to `scale`, in float64 and in blocks."""
    widest = 0.0
    b = book.double()
    for i in range(0, x.shape[0], rows):
        d = distances(x[i:i + rows].double(), b)
        gap = d.gather(1, idx[i:i + rows, None])[:, 0] - d.min(1).values
        widest = max(widest, (gap.max() / scale).item())
    return widest


def drawn_books(z: torch.Tensor, bins: int, generator: torch.Generator
                ) -> Books:
    """A trained-looking shared book without k-means: `bins` distinct rows
    of the latents `z` [B, T, D] drawn from `generator`, each as if it had
    held N / bins rows (so the EMA leaves it where it is and no code
    expires at once)."""
    flat = z.reshape(-1, z.shape[-1])
    idx = torch.randperm(flat.shape[0], generator=generator,
                         device=generator.device)[:bins]
    embed = flat[idx].clone()
    size = flat.new_full((bins,), flat.shape[0] / bins)
    return Books(embed, embed * size[:, None], size)


def decode(books: torch.Tensor, codes: torch.Tensor, shared: bool
           ) -> torch.Tensor:
    """Codes [B, K, T] → quantized latents [B, T, D]; `books` [n, bins, D]."""
    out = 0.0
    for k in range(codes.shape[1]):
        book = books[0 if shared else k]
        out = out + book[codes[:, k].long()]
    return out


def teacher_forced_gap(books: torch.Tensor, z: torch.Tensor,
                       codes: torch.Tensor, shared: bool) -> torch.Tensor:
    """How far the given codes lie from the nearest rows, stage by stage:
    at each stage the residual is the latents `z` [B, T, D] less the given
    codes' rows so far, and the gap of a position is the distance of its
    given code less the least distance, over the mean squared norm of the
    latents. Distances in float64, so that their own rounding is not
    read. Returns the gaps [B, K, T] (0 where the given code is the
    nearest)."""
    B, T, D = z.shape
    books = books.double()
    residual = z.reshape(B * T, D).double()
    scale = residual.square().sum(1).mean()
    gaps = []
    for k in range(codes.shape[1]):
        book = books[0 if shared else k]
        c = codes[:, k].reshape(-1).long()
        d = distances(residual, book)
        gaps.append((d.gather(1, c[:, None])[:, 0] - d.min(1).values)
                    / scale)
        residual = residual - book[c]
    return torch.stack(gaps).reshape(codes.shape[1], B, T).transpose(0, 1)
