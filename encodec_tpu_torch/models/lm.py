"""The entropy-coding LM's configuration, parameters and loader.

Port of what the lmv=3 coder needs from `encodec_tpu/models/lm.py`:
`LMConfig`, the parameter layout with a random init (`init_lm`, from an
explicit `torch.Generator`), a slim `LMModel` holding config and parameters
on a device, and `get_lm_model`, which reads the published LM checkpoint of
a codec from a local `repository` (the port never downloads).

Parameter layout (the JAX package's, as float32 tensors): `emb [n_q, card+1,
d]` (index 0 = no previous code), `linears {w [n_q, d, card], b [n_q,
card]}`, `norm_in {scale, bias}` and per layer `q, k, v, out, ff1, ff2`
(`{w [in, out], b [out]}`) and `norm1, norm2`. The integer coder
(`models.ilm`) derives its weights from these; the float forward is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp
from pathlib import Path

import torch

from ..device import resolve_device
from .model import _to_device

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


class LMModel:
    """An LM's config and parameters on `device` (default `cuda`). The
    integer coder derived from it (`ilm.IntLMModel.from_lm`) runs there."""

    def __init__(self, cfg: LMConfig, params: dict,
                 device: tp.Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)


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
