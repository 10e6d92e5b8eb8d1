"""The entropy-coding LM: configuration, parameters, the float network and
the loader.

Port of `encodec_tpu/models/lm.py` (behavioral reference: encodec/model.py
LMModel and encodec/modules/transformer.py): summed per-codebook
embeddings, an input norm and sinusoidal positions offset by the stream
position, a post-norm causal transformer (torch `norm_first=False`, exact
GELU) whose attention window is `past_context` steps, and per-codebook
linear heads with a softmax over the cardinality.

- `lm_forward_batch` evaluates a whole teacher-forced `[B, K, T]`
  sequence at once (one masked attention per layer): the training and
  likelihood path.
- `lm_step` is one streaming step over a fixed `[L, B, W, C]` cache ring
  (left-shift insert, `length` masks validity); `lm_scan_chunk` and
  `lm_scan` loop it.
- Parity quirk kept: the reference starts every layer's cache with one
  all-zero entry (transformer.py:106), which is attended until it leaves
  the window. The batch path puts it as key 0 of a `[T, T+1]` mask, the
  step path counts it in `length`.

The attention is two matmuls and a softmax with a `-inf` mask, as in JAX;
every op is float32 (`device.set_fp32_policy` keeps TF32 off).

Not ported: the JAX module's pinned executables of the lmv=2 format
(`LMModel.chunk_exec`, `fused_decode_chunk_exec`, the `*_bounds_exec`
family, `codec_probas`, `codec_symbol_bounds*`) and `bits_checksum`, their
self-check. lmv=2 streams are bound to the JAX package's compiled float
executable, and the port refuses them by design (`stream/compress.py`);
its LM streams are lmv=3, coded by the integer LM (`models.ilm`) derived
from these parameters.

Parameter layout (the JAX package's, as float32 tensors): `emb [n_q, card+1,
d]` (index 0 = no previous code), `linears {w [n_q, d, card], b [n_q,
card]}`, `norm_in {scale, bias}` and per layer `q, k, v, out, ff1, ff2`
(`{w [in, out], b [out]}`) and `norm1, norm2`. `init_lm` draws it from an
explicit `torch.Generator`; `get_lm_model` reads the published LM
checkpoint of a codec from a local `repository` (the port never
downloads).
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp
from pathlib import Path

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .model import _to_device

Tensor = torch.Tensor

# published LM checkpoint of each codec (ref model.py:265-284)
LM_CHECKPOINTS = {
    "encodec_24khz": "encodec_lm_24khz-1608e3c0.th",
    "encodec_48khz": "encodec_lm_48khz-7add9fc3.th",
}


@dataclasses.dataclass(frozen=True)
class LMConfig:
    n_q: int = 32
    card: int = 1024
    dim: int = 200
    num_heads: int = 8
    num_layers: int = 5
    hidden_scale: float = 4.0
    max_period: float = 10000.0
    past_context: int = 1000


def init_lm(gen: torch.Generator, cfg: LMConfig,
            device: tp.Union[str, torch.device] = "cpu") -> dict:
    """Random LM parameters with the distributions of the JAX `init_lm`
    (torch Linear defaults U(±1/sqrt(fan_in)), N(0, 1) embeddings, N(0,
    1/d) heads), drawn from `gen` on the CPU and moved to `device`."""
    d, h = cfg.dim, int(cfg.dim * cfg.hidden_scale)

    def uniform(shape, bound):
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound

    def lin(fan_in, fan_out):
        bound = 1.0 / math.sqrt(fan_in)
        return {"w": uniform((fan_in, fan_out), bound),
                "b": uniform((fan_out,), bound)}

    def norm():
        return {"scale": torch.ones(d), "bias": torch.zeros(d)}

    p: dict = {
        "emb": torch.randn((cfg.n_q, cfg.card + 1, d), generator=gen),
        "linears": {
            "w": torch.randn((cfg.n_q, d, cfg.card), generator=gen)
            / math.sqrt(d),
            "b": torch.zeros((cfg.n_q, cfg.card)),
        },
        "norm_in": norm(),
        "layers": [{"q": lin(d, d), "k": lin(d, d), "v": lin(d, d),
                    "out": lin(d, d), "ff1": lin(d, h), "ff2": lin(h, d),
                    "norm1": norm(), "norm2": norm()}
                   for _ in range(cfg.num_layers)],
    }
    return _to_device(p, resolve_device(device))


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _layer_norm(x: Tensor, p: dict, eps: float = 1e-5) -> Tensor:
    """JAX's `_layer_norm`: the biased variance and `rsqrt(var + eps)`."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _linear(x: Tensor, p: dict) -> Tensor:
    return x @ p["w"] + p["b"]


def sin_embedding(positions: Tensor, dim: int,
                  max_period: float = 10000.0) -> Tensor:
    """positions `[*]` (float32) → `[*, dim]`: the cos half, then the sin
    half (ref transformer.py:16-27)."""
    half = dim // 2
    adim = torch.arange(half, dtype=torch.float32, device=positions.device)
    phase = positions[..., None] / (max_period ** (adim / (half - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def _attention(layer: dict, q_in: Tensor, kv_in: Tensor, mask: Tensor,
               num_heads: int) -> Tensor:
    """Masked multi-head attention: q_in `[B, T, C]`, kv_in `[B, S, C]`,
    mask `[T, S]` (True = attend)."""
    B, T, C = q_in.shape
    S = kv_in.shape[1]
    hd = C // num_heads
    q = _linear(q_in, layer["q"]).reshape(B, T, num_heads, hd)
    k = _linear(kv_in, layer["k"]).reshape(B, S, num_heads, hd)
    v = _linear(kv_in, layer["v"]).reshape(B, S, num_heads, hd)
    logits = torch.einsum("bthd,bshd->bhts", q, k)
    logits = logits / math.sqrt(hd)
    logits = logits.masked_fill(~mask, float("-inf"))
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", attn, v)
    return _linear(out.reshape(B, T, C), layer["out"])


def _transformer_layer(layer: dict, x: Tensor, x_past: Tensor, mask: Tensor,
                       num_heads: int) -> tp.Tuple[Tensor, Tensor]:
    """Post-norm transformer layer. Returns (output, the layer's input),
    the input feeding the next step's cache."""
    kv = torch.cat([x_past, x], dim=1)
    y = _layer_norm(x + _attention(layer, x, kv, mask, num_heads),
                    layer["norm1"])
    ff = _linear(F.gelu(_linear(y, layer["ff1"]), approximate="none"),
                 layer["ff2"])
    return _layer_norm(y + ff, layer["norm2"]), x


def _embed(params: dict, indices: Tensor) -> Tensor:
    """Summed per-codebook embeddings: indices `[B, K, *]` → `[B, *, C]`."""
    K = indices.shape[1]
    book = torch.arange(K, device=indices.device).reshape(
        (1, K) + (1,) * (indices.dim() - 2))
    return params["emb"][book, indices.long()].sum(dim=1)


# ---------------------------------------------------------------------------
# Batched (teacher-forced) evaluation
# ---------------------------------------------------------------------------

def lm_prologue(params: dict, indices: Tensor, cfg: LMConfig,
                offset: int = 0) -> tp.Tuple[Tensor, Tensor]:
    """The trunk's input (summed embeddings, input norm, sinusoid positions
    from `offset`) and the `[T, T+1]` mask: keys are the zero entry and
    the sequence; query t attends key positions with 0 <= (t+1) - kpos <=
    past_context."""
    T = indices.shape[-1]
    dev = indices.device
    x = _embed(params, indices)                              # [B, T, C]
    positions = torch.arange(T, dtype=torch.float32, device=dev) + offset
    x = _layer_norm(x, params["norm_in"]) + sin_embedding(
        positions, cfg.dim, cfg.max_period)[None]
    delta = (torch.arange(1, T + 1, device=dev)[:, None]
             - torch.arange(0, T + 1, device=dev)[None, :])
    mask = (delta >= 0) & (delta <= cfg.past_context)
    return x, mask


def lm_head(params: dict, x: Tensor, K: int,
            return_logits: bool = False) -> Tensor:
    """The per-codebook heads: trunk output `[B, T, C]` → `[B, card, K, T]`
    logits, or probabilities (softmax over the cardinality)."""
    logits = torch.einsum("btc,kcn->bnkt", x, params["linears"]["w"][:K]) \
        + params["linears"]["b"][:K].T[None, :, :, None]
    return logits if return_logits else torch.softmax(logits, dim=1)


def lm_forward_batch(params: dict, indices: Tensor, cfg: LMConfig,
                     offset: int = 0, return_logits: bool = False) -> Tensor:
    """The LM over a whole `[B, K, T]` index sequence at once.

    `indices[..., t]` is 1 + the code at step t-1 (0 at t=0): the caller
    shifts (`train.lm_train.shift_codes`). Returns probabilities `[B, card,
    K, T]` (logits with `return_logits`), equal to a from-scratch
    streaming evaluation, the zero cache entry included."""
    B, K, T = indices.shape
    x, mask = lm_prologue(params, indices, cfg, offset)
    zero = x.new_zeros((B, 1, cfg.dim))
    for layer in params["layers"]:
        x, _ = _transformer_layer(layer, x, zero, mask, cfg.num_heads)
    return lm_head(params, x, K, return_logits)


# ---------------------------------------------------------------------------
# Streaming single-step evaluation
# ---------------------------------------------------------------------------

class LMStreamState(tp.NamedTuple):
    cache: Tensor   # [num_layers, B, W, C] the layers' inputs, newest last
    length: int     # valid entries, the zero entry included (<= W + 1)
    offset: int     # absolute stream position


def init_lm_stream(cfg: LMConfig, batch: int = 1,
                   device: tp.Union[str, torch.device] = "cuda"
                   ) -> LMStreamState:
    """A fresh stream on `device` (default `cuda`): a zero cache whose one
    valid entry is the reference's initial zero state."""
    cache = torch.zeros((cfg.num_layers, batch, cfg.past_context, cfg.dim),
                        dtype=torch.float32, device=resolve_device(device))
    return LMStreamState(cache=cache, length=1, offset=0)


def lm_step(params: dict, indices: Tensor, state: LMStreamState,
            cfg: LMConfig) -> tp.Tuple[Tensor, LMStreamState]:
    """One streaming step: indices `[B, K]` (1 + the previous codes, 0
    first) → (probabilities `[B, card, K]`, the next state). The cache is
    a fixed `[L, B, W, C]` ring: the newest `min(length, W)` slots are
    valid, all within the window since W = past_context."""
    K = indices.shape[1]
    W = cfg.past_context
    dev = indices.device
    x = _embed(params, indices)                              # [B, C]
    pos = sin_embedding(torch.tensor([float(state.offset)], device=dev),
                        cfg.dim, cfg.max_period)[0]
    x = (_layer_norm(x, params["norm_in"]) + pos)[:, None]  # [B, 1, C]
    n_valid = min(state.length, W)
    mask = torch.ones((1, W + 1), dtype=torch.bool, device=dev)
    mask[0, :W - n_valid] = False
    new_cache = []
    for li, layer in enumerate(params["layers"]):
        past = state.cache[li]                               # [B, W, C]
        x, sa_input = _transformer_layer(layer, x, past, mask,
                                         cfg.num_heads)
        new_cache.append(torch.cat([past[:, 1:], sa_input], dim=1))
    logits = torch.einsum("bc,kcn->bnk", x[:, 0],
                          params["linears"]["w"][:K]) \
        + params["linears"]["b"][:K].T[None]
    return torch.softmax(logits, dim=1), LMStreamState(
        cache=torch.stack(new_cache), length=min(state.length + 1, W + 1),
        offset=state.offset + 1)


def lm_scan_chunk(params: dict, indices: Tensor, state: LMStreamState,
                  cfg: LMConfig) -> tp.Tuple[Tensor, LMStreamState]:
    """`lm_step` over a `[B, K, C]` chunk of shifted indices from `state`:
    (probabilities `[B, card, K, C]`, the state after it). A step's row
    depends only on `state` and the indices up to it, so chunks carried
    one after another equal one scan."""
    out = []
    for t in range(indices.shape[-1]):
        probas, state = lm_step(params, indices[:, :, t], state, cfg)
        out.append(probas)
    return torch.stack(out, dim=-1), state


def lm_scan(params: dict, indices: Tensor, cfg: LMConfig) -> Tensor:
    """The streaming cell teacher-forced over a whole `[B, K, T]` shifted
    sequence from a fresh state: probabilities `[B, card, K, T]`."""
    state = init_lm_stream(cfg, batch=indices.shape[0],
                           device=indices.device)
    return lm_scan_chunk(params, indices, state, cfg)[0]


class LMModel:
    """An LM's config and parameters on `device` (default `cuda`), with the
    float network's entry points (inference only; `train.lm_train` trains
    the parameter tree). The integer coder derived from it
    (`ilm.IntLMModel.from_lm`) runs there too."""

    def __init__(self, cfg: LMConfig, params: dict,
                 device: tp.Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)

    @property
    def card(self) -> int:
        return self.cfg.card

    @property
    def n_q(self) -> int:
        return self.cfg.n_q

    def _indices(self, indices) -> Tensor:
        return torch.as_tensor(indices).to(self.device, torch.int64)

    @torch.inference_mode()
    def forward_batch(self, indices, offset: int = 0) -> Tensor:
        """`lm_forward_batch` of `[B, K, T]` shifted indices."""
        return lm_forward_batch(self.params, self._indices(indices), self.cfg,
                                offset)

    @torch.inference_mode()
    def scan(self, indices) -> Tensor:
        """`lm_scan` of `[B, K, T]` shifted indices."""
        return lm_scan(self.params, self._indices(indices), self.cfg)

    @torch.inference_mode()
    def step(self, indices, state: LMStreamState
             ) -> tp.Tuple[Tensor, LMStreamState]:
        return lm_step(self.params, self._indices(indices), state, self.cfg)

    def init_stream(self, batch: int = 1) -> LMStreamState:
        return init_lm_stream(self.cfg, batch, self.device)

    def __call__(self, indices, states: tp.Optional[LMStreamState] = None,
                 offset: int = 0):
        """The reference signature (ref model.py:64-83): indices `[B, K,
        T]` (1 + the previous code, 0 = none) and an optional stream state
        → `(probabilities [B, card, K, T], the next state, offset + T)`,
        one streaming step per position."""
        indices = self._indices(indices)
        if states is None:
            states = self.init_stream(batch=indices.shape[0])
        with torch.inference_mode():
            probas, states = lm_scan_chunk(self.params, indices, states,
                                           self.cfg)
        return probas, states, offset + indices.shape[-1]


def lm_config_for(model) -> LMConfig:
    """The LM configuration of a codec model (ref model.py:265-284): dim
    200, 5 layers, the codec's stages and bins, a 3.5 s attention window."""
    return LMConfig(n_q=model.cfg.rvq.n_q, card=model.cfg.rvq.bins,
                    num_layers=5, dim=200,
                    past_context=int(3.5 * model.frame_rate))


def get_lm_model(model, repository: tp.Optional[str] = None) -> LMModel:
    """The published LM of a codec model, read from
    `{repository}/{LM_CHECKPOINTS[model.name]}`, on the model's device."""
    if model.name not in LM_CHECKPOINTS:
        raise RuntimeError("No LM pre-trained for the current Encodec model.")
    name = LM_CHECKPOINTS[model.name]
    if repository is None:
        raise RuntimeError(
            f"no local checkpoint repository given for {name}: pass "
            "repository=DIR (CLI: --repository DIR); the port does not "
            "download checkpoints")
    from .zoo import lm_params_from_state

    cfg = lm_config_for(model)
    state = torch.load(Path(repository) / name, map_location="cpu",
                       weights_only=True)
    params = lm_params_from_state(state, cfg.n_q, cfg.num_layers)
    return LMModel(cfg, params, device=model.device)
