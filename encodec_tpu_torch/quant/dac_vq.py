"""DAC-style residual vector quantizer (gradient-trained codebooks).

Port of `encodec_tpu/quant/dac_vq.py` (behavioral reference:
encodec/quantization/dac_vq.py, the alternative RVQ the fork keeps beside
the EMA quantizer and does not wire into the model; neither does the
port): factorized codes through weight-normed 1x1 projections, an
L2-normalized cosine lookup, per-stage commitment and codebook MSE losses,
quantizer dropout in training, and `dac_from_codes` / `dac_from_latents`.
Also `snake`, the DAC codebase's periodic activation
(encodec/quantization/dac.py:17-32).

Activations are `[B, T, D]` (channels-last), as in the JAX package. A
weight-normed 1x1 conv is a linear `{"v": [out, in], "g": [out], "b":
[out]}` in torch's layout (the reference's `weight_v[:, :, 0]`; JAX holds
`v` transposed). The lookup is a plain float32 `torch.matmul`, as JAX's
`jnp.dot` outside any kernel. Losses are per batch item `[B]`.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import numpy as np
import torch


def snake(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """snake(x) = x + sin²(alpha·x)/alpha (ref dac.py:17-24)."""
    return x + torch.sin(alpha * x).square() / (alpha + 1e-9)


@dataclasses.dataclass(frozen=True)
class DacRVQConfig:
    input_dim: int = 512
    n_codebooks: int = 9
    codebook_size: int = 1024
    codebook_dim: tp.Union[int, tp.Tuple[int, ...]] = 8
    quantizer_dropout: float = 0.0

    def dims(self) -> tp.Tuple[int, ...]:
        d = self.codebook_dim
        return tuple(d for _ in range(self.n_codebooks)) \
            if isinstance(d, int) else tuple(d)


def _init_wn_linear(gen: torch.Generator, fan_in: int, fan_out: int,
                    device: torch.device) -> dict:
    """A weight-normed 1x1 conv as a linear: `v` kaiming-uniform, `g` its
    row norms (so the initial weight is `v`), `b` uniform ±1/√fan_in."""
    bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)
    v = (torch.rand(fan_out, fan_in, generator=gen) * 2 - 1) * bound
    b = (torch.rand(fan_out, generator=gen) * 2 - 1) / math.sqrt(fan_in)
    return {"v": v.to(device), "g": v.square().sum(1).sqrt().to(device),
            "b": b.to(device)}


def _wn_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """`x @ (g·v/‖v‖)ᵀ + b`, the norm over each output row's inputs."""
    w = p["g"][:, None] * p["v"] / p["v"].square().sum(1, keepdim=True).sqrt()
    return torch.matmul(x, w.t()) + p["b"]


def init_dac_rvq(gen: torch.Generator, cfg: DacRVQConfig,
                 device: tp.Union[str, torch.device] = "cpu") -> dict:
    """Random parameters drawn from `gen`: per stage the in and out
    projections and a `[codebook_size, dim]` codebook, N(0, 1) (torch's
    `nn.Embedding` init)."""
    device = torch.device(device)
    stages = []
    for dim in cfg.dims():
        stages.append({
            "in_proj": _init_wn_linear(gen, cfg.input_dim, dim, device),
            "out_proj": _init_wn_linear(gen, dim, cfg.input_dim, device),
            "codebook": torch.randn(cfg.codebook_size, dim,
                                    generator=gen).to(device),
        })
    return {"stages": stages}


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=1, keepdim=True).clamp(min=1e-12)


def _decode_latents(codebook: torch.Tensor, z_e: torch.Tensor
                    ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Cosine nearest-neighbour lookup. z_e `[B, T, d]` → (z_q `[B, T,
    d]`, indices `[B, T]` int64); a tie goes to the lower index."""
    B, T, d = z_e.shape
    enc_n = _unit_rows(z_e.reshape(B * T, d))
    cb_n = _unit_rows(codebook)
    dist = (enc_n.square().sum(1, keepdim=True)
            - 2 * torch.matmul(enc_n, cb_n.t())
            + cb_n.square().sum(1)[None, :])
    indices = torch.argmax(-dist, dim=1).reshape(B, T)
    return codebook[indices], indices


def dac_vq_stage(stage: dict, residual: torch.Tensor, training: bool):
    """One VectorQuantize stage (ref dac_vq.py:52-93). Returns (z_q `[B, T,
    D]`, commit `[B]`, codebook `[B]`, indices `[B, T]`, z_e `[B, T, d]`).
    In training z_q passes the gradient straight through to z_e, before
    the codebook loss is taken (the fork's order: that loss then reaches
    no codebook)."""
    z_e = _wn_linear(stage["in_proj"], residual)
    z_q, indices = _decode_latents(stage["codebook"], z_e)
    if training:
        z_q = z_e + (z_q - z_e).detach()
    commit = (z_e - z_q.detach()).square().mean(dim=(1, 2))
    codebook = (z_q - z_e.detach()).square().mean(dim=(1, 2))
    return (_wn_linear(stage["out_proj"], z_q), commit, codebook, indices,
            z_e)


def dac_rvq_forward(params: dict, z: torch.Tensor, cfg: DacRVQConfig, *,
                    n_quantizers: tp.Optional[int] = None,
                    training: bool = False,
                    generator: tp.Optional[torch.Generator] = None,
                    draws: tp.Optional[torch.Tensor] = None) -> dict:
    """The full RVQ (ref dac_vq.py:149-231). z: `[B, T, D]`.

    Training with `quantizer_dropout`: the first `floor(B·dropout)` items
    keep a random number of active quantizers in [1, n_codebooks], drawn
    per item from `generator` (on the CPU), or taken from `draws` (`[B]`,
    e.g. JAX's draws); the other items keep every stage. Returns a dict:
    z `[B, T, D]`, codes `[B, N, T]`, latents `[B, T, sum(d)]`,
    commitment_loss `[B, N]`, codebook_loss `[B, N]`."""
    B, T, D = z.shape
    N = cfg.n_codebooks
    if n_quantizers is None:
        n_quantizers = N
    if training:
        nq = torch.full((B,), float(N + 1), device=z.device)
        if cfg.quantizer_dropout > 0:
            if draws is None:
                if generator is None:
                    raise ValueError("quantizer dropout needs a generator "
                                     "or the draws")
                draws = torch.randint(1, N + 1, (B,), generator=generator)
            n_drop = int(B * cfg.quantizer_dropout)
            nq[:n_drop] = draws[:n_drop].to(nq)
        stages = N
    else:
        nq = torch.full((B,), float(n_quantizers), device=z.device)
        stages = min(n_quantizers, N)

    z_q = torch.zeros_like(z)
    residual = z
    codes, latents, commits, books = [], [], [], []
    for i in range(stages):
        z_q_i, commit_i, book_i, idx_i, z_e_i = dac_vq_stage(
            params["stages"][i], residual, training)
        mask = (i < nq).to(z.dtype)[:, None, None]
        z_q = z_q + z_q_i * mask
        residual = residual - z_q_i
        codes.append(idx_i)
        latents.append(z_e_i)
        commits.append(commit_i)
        books.append(book_i)
    return {
        "z": z_q,
        "codes": torch.stack(codes, dim=1),
        "latents": torch.cat(latents, dim=-1),
        "commitment_loss": torch.stack(commits, dim=1),
        "codebook_loss": torch.stack(books, dim=1),
    }


def dac_from_codes(params: dict, codes: torch.Tensor):
    """codes `[B, N, T]` → (z_q `[B, T, D]`, z_p `[B, T, sum(d)]`,
    codes)."""
    z_q = 0.0
    z_p = []
    for i in range(codes.shape[1]):
        stage = params["stages"][i]
        z_p_i = stage["codebook"][codes[:, i].long()]
        z_p.append(z_p_i)
        z_q = z_q + _wn_linear(stage["out_proj"], z_p_i)
    return z_q, torch.cat(z_p, dim=-1), codes


def dac_from_latents(params: dict, latents: torch.Tensor,
                     cfg: DacRVQConfig):
    """latents `[B, T, sum(d_i)]` → (z_q, z_p, codes `[B, N, T]`), N the
    stages whose latents fit (ref dac_vq.py:257-290)."""
    dims = np.cumsum([0] + list(cfg.dims()))
    n_codebooks = int(np.where(dims <= latents.shape[-1])[0].max())
    z_q = 0.0
    z_p, codes = [], []
    for i in range(n_codebooks):
        j, k = int(dims[i]), int(dims[i + 1])
        stage = params["stages"][i]
        z_p_i, codes_i = _decode_latents(stage["codebook"],
                                         latents[:, :, j:k])
        z_p.append(z_p_i)
        codes.append(codes_i)
        z_q = z_q + _wn_linear(stage["out_proj"], z_p_i)
    return z_q, torch.cat(z_p, dim=-1), torch.stack(codes, dim=1)
