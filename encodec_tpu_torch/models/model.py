"""EncodecModel: the codec API (encode / decode / bandwidth), 24 kHz slice.

Port of `encodec_tpu/models/model.py`: `EncodecConfig`, `encode_frame`,
`encode_frame_margins`, `decode_frame`, `EncodecModel` (`encode`,
`encode_guarded`, `decode`, `set_target_bandwidth`, `n_q_active`),
`build_model`, `encodec_model_24khz` and `MODELS`. `encode` returns a list
of `(codes [B, K, T'], scale)` frames and `decode` consumes them, the
contract the `.ecdc` pipeline depends on. Audio is `[B, C, T]` at these
methods, like the JAX package.

Not ported yet: the 48 kHz segment / overlap-add path (and per-segment
normalization) — `encode`/`decode` raise on such a config — the PCM16 wire
helpers, the training forward and the reduced-precision modes (only the
'highest' float32 path exists).
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import numpy as np
import torch

from .. import ops
from ..device import resolve_device
from ..quant import (RVQConfig, RVQState, init_rvq, num_quantizers_for_bandwidth,
                     resolve_ties_f64, rvq_decode, rvq_encode,
                     rvq_encode_margins)
from .seanet import (SEANetConfig, init_seanet_decoder, init_seanet_encoder,
                     seanet_decoder, seanet_encoder)

EncodedFrame = tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class EncodecConfig:
    seanet: SEANetConfig
    rvq: RVQConfig
    target_bandwidths: tp.Tuple[float, ...]
    sample_rate: int
    channels: int
    normalize: bool = False
    segment: tp.Optional[float] = None
    name: str = "unset"

    @property
    def frame_rate(self) -> int:
        return math.ceil(self.sample_rate / np.prod(self.seanet.ratios))

    @property
    def segment_length(self) -> tp.Optional[int]:
        if self.segment is None:
            return None
        return int(self.segment * self.sample_rate)

    @property
    def bits_per_codebook(self) -> int:
        b = int(math.log2(self.rvq.bins))
        if 2 ** b != self.rvq.bins:
            raise ValueError("quantizer bins must be a power of 2")
        return b


# ---------------------------------------------------------------------------
# Pure compute functions (audio [B, T, C], codes [B, K, T'])
# ---------------------------------------------------------------------------

def encode_frame(params, qstate: RVQState, x: torch.Tensor,
                 cfg: EncodecConfig, n_q: int, plain: bool = False
                 ) -> torch.Tensor:
    """Encode one unsegmented frame `[B, T, C]` → codes `[B, K, T']` (K3, K2).

    `plain=True` runs every kernel's plain twin, even on CUDA tensors."""
    emb = seanet_encoder(params["encoder"], x, cfg.seanet, plain=plain)
    codes = rvq_encode(qstate, emb, cfg.rvq, n_q=n_q, plain=plain)
    return codes.permute(1, 0, 2)


def encode_frame_margins(params, qstate: RVQState, x: torch.Tensor,
                         cfg: EncodecConfig, n_q: int, plain: bool = False):
    """`encode_frame` plus the latents and per-stage argmin margins, for the
    near-tie guard (K3, K1). Returns (codes [B, K, T'], z [B, T', D],
    margins [B, K, T'])."""
    emb = seanet_encoder(params["encoder"], x, cfg.seanet, plain=plain)
    codes, margins = rvq_encode_margins(qstate, emb, cfg.rvq, n_q=n_q,
                                        plain=plain)
    return codes.permute(1, 0, 2), emb, margins.permute(1, 0, 2)


def decode_frame(params, qstate: RVQState, codes: torch.Tensor,
                 cfg: EncodecConfig) -> torch.Tensor:
    """Decode codes `[B, K, T']` → waveform `[B, T, C]` (K3)."""
    emb = rvq_decode(qstate, codes.permute(1, 0, 2), cfg.rvq)
    return seanet_decoder(params["decoder"], emb, cfg.seanet)


# ---------------------------------------------------------------------------
# Model object
# ---------------------------------------------------------------------------

def _to_device(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=torch.float32)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


class EncodecModel:
    """Stateful convenience wrapper mirroring the reference API surface.

    Holds the parameter tree (`params`, weight norm as (v, g)) and the
    quantizer state on `device`; the weight-norm fold is computed once per
    assignment of `params` (`infer_params`), not on every call."""

    def __init__(self, cfg: EncodecConfig, params, qstate: RVQState,
                 device: tp.Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.qstate = qstate
        self.bandwidth: tp.Optional[float] = None

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, params) -> None:
        self._params = _to_device(params, self.device)
        self.infer_params = ops.fold_weight_norm_tree(self._params)

    @property
    def qstate(self) -> RVQState:
        return self._qstate

    @qstate.setter
    def qstate(self, qstate: RVQState) -> None:
        self._qstate = RVQState(
            *(_to_device(t, self.device) for t in qstate[:3]),
            inited=bool(qstate.inited))

    # -- reference-parity properties ------------------------------------
    @property
    def name(self) -> str:
        return self.cfg.name

    @property
    def sample_rate(self) -> int:
        return self.cfg.sample_rate

    @property
    def channels(self) -> int:
        return self.cfg.channels

    @property
    def frame_rate(self) -> int:
        return self.cfg.frame_rate

    @property
    def segment_length(self) -> tp.Optional[int]:
        return self.cfg.segment_length

    @property
    def bits_per_codebook(self) -> int:
        return self.cfg.bits_per_codebook

    def set_target_bandwidth(self, bandwidth: float) -> None:
        if bandwidth not in self.cfg.target_bandwidths:
            raise ValueError(
                f"This model doesn't support the bandwidth {bandwidth}. "
                f"Select one of {list(self.cfg.target_bandwidths)}.")
        self.bandwidth = bandwidth

    @property
    def n_q_active(self) -> int:
        return num_quantizers_for_bandwidth(self.cfg.rvq, self.frame_rate,
                                            self.bandwidth)

    # -- public API -------------------------------------------------------
    def _audio(self, x) -> torch.Tensor:
        """`[B, C, T]` audio as float32 `[B, T, C]` on the model's device."""
        if self.cfg.segment is not None or self.cfg.normalize:
            raise NotImplementedError(
                "segmented / normalized models (the 48 kHz path) are not "
                "ported yet; this slice serves the unsegmented 24 kHz codec")
        x = torch.as_tensor(x)
        if x.dim() != 3 or not 0 < x.shape[1] <= 2:
            raise ValueError(f"expected [B, C, T] audio, got {tuple(x.shape)}")
        if not x.is_floating_point():
            # int16 PCM input (the JAX package's wire format) is not ported
            raise TypeError(f"expected float audio in [-1, 1], got {x.dtype}")
        return x.to(device=self.device, dtype=torch.float32).transpose(1, 2)

    @torch.inference_mode()
    def encode(self, x) -> tp.List[EncodedFrame]:
        """x: `[B, C, T]` audio. Returns `[(codes [B, K, T'] int32, None)]`."""
        codes = encode_frame(self.infer_params, self.qstate, self._audio(x),
                             self.cfg, self.n_q_active)
        return [(codes, None)]

    @torch.inference_mode()
    def encode_guarded(self, x, threshold: float = 1e-3
                       ) -> tp.Tuple[tp.List[EncodedFrame], dict]:
        """`encode` with the container-writing near-tie guard.

        Per position the RVQ argmin's top-2 gap is computed on the device
        (K1); positions whose margin at any stage falls under `threshold`
        get their whole code chain re-resolved on the host in float64 with
        the reference association order (`resolve_ties_f64`), so writers
        whose latents agree emit identical codes. Returns (frames, stats:
        min_margin, n_flagged, n_changed, n_positions)."""
        codes, z, margins = encode_frame_margins(
            self.infer_params, self.qstate, self._audio(x), self.cfg,
            self.n_q_active)
        codes = codes.cpu().numpy()                  # [B, K, T']
        m = margins.cpu().numpy()                    # [B, K, T']
        stats = {"min_margin": float(m.min()) if m.size else float("inf"),
                 "n_flagged": 0, "n_changed": 0,
                 "n_positions": int(m.shape[0] * m.shape[2])}
        flagged = (m < threshold).any(axis=1)        # [B, T']
        if flagged.any():
            bs, ts = np.nonzero(flagged)
            fixed = resolve_ties_f64(self.qstate, z.cpu().numpy()[bs, ts],
                                     self.cfg.rvq, codes.shape[1])
            before = codes[bs, :, ts].copy()
            codes[bs, :, ts] = fixed
            stats["n_flagged"] = int(bs.size)
            stats["n_changed"] = int((before != fixed).any(1).sum())
        return [(torch.from_numpy(codes).to(self.device), None)], stats

    @torch.inference_mode()
    def decode(self, frames: tp.Sequence[EncodedFrame]) -> torch.Tensor:
        """Decode frames → `[B, C, T]` waveform (may be slightly longer than
        the original input; callers trim)."""
        if self.cfg.segment is not None or len(frames) != 1:
            raise NotImplementedError(
                "segmented decode (the 48 kHz path) is not ported yet")
        codes, scale = frames[0]
        if scale is not None:
            raise NotImplementedError("scaled frames (normalized models) are "
                                      "not ported yet")
        codes = torch.as_tensor(codes).to(self.device)
        out = decode_frame(self.infer_params, self.qstate, codes, self.cfg)
        return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# Factories
# ---------------------------------------------------------------------------

def _n_q_from_bandwidth(target_bandwidths, sample_rate, hop_length) -> int:
    # the reference hard-codes 10 bits per codebook in the denominator
    frame_rate = math.ceil(sample_rate / hop_length)
    return int(1000 * target_bandwidths[-1] // (frame_rate * 10))


def build_model(target_bandwidths: tp.Sequence[float], sample_rate: int = 10,
                channels: int = 1, causal: bool = True,
                model_norm: str = "weight_norm", audio_normalize: bool = False,
                segment: tp.Optional[float] = None,
                name: str = "breathing_model",
                ratios: tp.Sequence[int] = (8, 5, 4, 2), bins: int = 256,
                dimension: int = 128, n_filters: int = 32,
                decoder_final_norm: tp.Optional[str] = None,
                shared_codebook: bool = False, kmeans_init: bool = True,
                seed: int = 0,
                device: tp.Union[str, torch.device] = "cuda") -> EncodecModel:
    """A random-weight model (weights from a `torch.Generator` seeded with
    `seed`). With `kmeans_init` (the reference default) the codebooks are
    all zeros until trained, so every code is 0; `kmeans_init=False` gives
    kaiming-uniform books that exercise the search."""
    dev = resolve_device(device)
    seanet = SEANetConfig(channels=channels, dimension=dimension,
                          n_filters=n_filters, ratios=tuple(ratios),
                          norm=model_norm, causal=causal,
                          decoder_final_norm=decoder_final_norm)
    n_q = _n_q_from_bandwidth(target_bandwidths, sample_rate,
                              int(np.prod(ratios)))
    rvq = RVQConfig(dimension=dimension, n_q=n_q, bins=bins,
                    shared_codebook=shared_codebook, kmeans_init=kmeans_init)
    cfg = EncodecConfig(seanet=seanet, rvq=rvq,
                        target_bandwidths=tuple(target_bandwidths),
                        sample_rate=sample_rate, channels=channels,
                        normalize=audio_normalize, segment=segment, name=name)
    gen = torch.Generator().manual_seed(seed)
    params = {"encoder": init_seanet_encoder(gen, seanet, dev),
              "decoder": init_seanet_decoder(gen, seanet, dev)}
    return EncodecModel(cfg, params, init_rvq(gen, rvq, dev), device=dev)


def encodec_model_24khz(pretrained: bool = False,
                        repository: tp.Optional[str] = None, *,
                        device: tp.Union[str, torch.device] = "cuda",
                        kmeans_init: bool = True) -> EncodecModel:
    """Causal mono 24 kHz model (n_filters=32, dimension=128, 1024 bins,
    up to 32 stages, LSTM H=512). `pretrained` loads the published
    checkpoint from the local `repository`."""
    model = build_model(
        target_bandwidths=[1.5, 3.0, 6.0, 12.0, 24.0], sample_rate=24_000,
        channels=1, causal=True, model_norm="weight_norm",
        audio_normalize=False,
        name="encodec_24khz" if pretrained else "unset",
        ratios=[8, 5, 4, 2], bins=1024, dimension=128,
        kmeans_init=kmeans_init, device=device)
    if pretrained:
        from .zoo import load_pretrained
        load_pretrained(model, "encodec_24khz-d7cc33bc.th", repository)
    return model


MODELS = {
    "encodec_24khz": encodec_model_24khz,
}
