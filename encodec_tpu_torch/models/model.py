"""EncodecModel: the codec API (encode / decode / bandwidth).

Port of `encodec_tpu/models/model.py`: `EncodecConfig`, `encode_frame`,
`encode_frame_margins`, `decode_frame`, the PCM16 wire helpers,
`EncodecModel` (`encode`, `encode_guarded`, `decode`,
`set_target_bandwidth`, `n_q_active`, `codebooks`), `build_model`,
`encodec_model_24khz`, `encodec_model_48khz`, `breathing_model` and
`MODELS`. `encode` returns
a list of `(codes [B, K, T'], scale [B, 1] or None)` frames and `decode`
consumes them, the contract the `.ecdc` pipeline depends on. Audio is
`[B, C, T]` at these methods, like the JAX package.

Segmented models (the 48 kHz codec) cut the input into `segment_length`
segments `segment_stride` apart, normalize each by its RMS (the frame's
scale) and overlap-add the decoded segments. Segments of equal length run
as one batch, at row `s·B + b` for segment s and item b, so the LSTM kernel
sees all of them at once; the frames `encode` returns are views into that
batch.

`forward_train` is the training forward (float32 only): encoder, the
training RVQ (EMA codebooks, k-means init, straight-through) and decoder,
on the unfolded weight-norm parameters `(v, g)`, outside inference mode,
so autograd can differentiate it (the LSTM through K3's backward kernel).
`EncodecModel.forward` / `__call__` is the fork's eval forward. Not ported:
the reduced-precision modes (only the 'highest' float32 path exists).
"""

from __future__ import annotations

import dataclasses
import math
import typing as tp

import numpy as np
import torch

from .. import ops
from ..device import resolve_device
from ..ops.batch_reduce import LOCAL, BatchReduce
from ..quant import (RVQConfig, RVQState, init_rvq, num_quantizers_for_bandwidth,
                     resolve_ties_f64, rvq_decode, rvq_encode,
                     rvq_encode_margins, rvq_forward)
from ..utils.overlap import linear_overlap_add
from .seanet import (SEANetConfig, init_seanet_decoder, init_seanet_encoder,
                     seanet_decoder, seanet_encoder)

EncodedFrame = tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]

# served bandwidths (kbps) of the published models
TARGET_BANDWIDTHS = {
    "encodec_24khz": (1.5, 3.0, 6.0, 12.0, 24.0),
    "encodec_48khz": (3.0, 6.0, 12.0, 24.0),
}


@dataclasses.dataclass(frozen=True)
class EncodecConfig:
    seanet: SEANetConfig
    rvq: RVQConfig
    target_bandwidths: tp.Tuple[float, ...]
    sample_rate: int
    channels: int
    normalize: bool = False
    segment: tp.Optional[float] = None
    overlap: float = 0.01
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
    def segment_stride(self) -> tp.Optional[int]:
        sl = self.segment_length
        if sl is None:
            return None
        return max(1, int((1 - self.overlap) * sl))

    @property
    def bits_per_codebook(self) -> int:
        b = int(math.log2(self.rvq.bins))
        if 2 ** b != self.rvq.bins:
            raise ValueError("quantizer bins must be a power of 2")
        return b

    def segments(self, length: int) -> tp.List[tp.Tuple[int, int]]:
        """`(offset, length)` of each segment of a `length`-sample input; one
        segment for an unsegmented model."""
        seg_len = self.segment_length or length
        stride = self.segment_stride or length
        return [(off, min(seg_len, length - off))
                for off in range(0, length, stride)]


# ---------------------------------------------------------------------------
# Pure compute functions (audio [B, T, C], codes [B, K, T'])
# ---------------------------------------------------------------------------

def _normalize(x: torch.Tensor, cfg: EncodecConfig):
    """Per-item RMS normalization of `[B, T, C]` for normalized models:
    returns (x / scale, scale [B, 1]), else (x, None)."""
    if not cfg.normalize:
        return x, None
    mono = x.mean(dim=2, keepdim=True)                         # [B, T, 1]
    volume = mono.square().mean(dim=1, keepdim=True).sqrt()
    scale = 1e-8 + volume                                       # [B, 1, 1]
    return x / scale, scale.reshape(-1, 1)


def encode_frame(params, qstate: RVQState, x: torch.Tensor,
                 cfg: EncodecConfig, n_q: int, plain: bool = False):
    """Encode one segment `[B, T, C]` → (codes [B, K, T'], scale [B, 1] or
    None) (K3, K2).

    `plain=True` runs every kernel's plain twin, even on CUDA tensors."""
    x, scale = _normalize(x, cfg)
    emb = seanet_encoder(params["encoder"], x, cfg.seanet, plain=plain)
    codes = rvq_encode(qstate, emb, cfg.rvq, n_q=n_q, plain=plain)
    return codes.permute(1, 0, 2), scale


def encode_frame_margins(params, qstate: RVQState, x: torch.Tensor,
                         cfg: EncodecConfig, n_q: int, plain: bool = False):
    """`encode_frame` plus the latents and per-stage argmin margins, for the
    near-tie guard (K3, K1). Returns (codes [B, K, T'], scale or None,
    z [B, T', D], margins [B, K, T'])."""
    x, scale = _normalize(x, cfg)
    emb = seanet_encoder(params["encoder"], x, cfg.seanet, plain=plain)
    codes, margins = rvq_encode_margins(qstate, emb, cfg.rvq, n_q=n_q,
                                        plain=plain)
    return codes.permute(1, 0, 2), scale, emb, margins.permute(1, 0, 2)


def decode_frame(params, qstate: RVQState, codes: torch.Tensor,
                 cfg: EncodecConfig,
                 scale: tp.Optional[torch.Tensor] = None,
                 plain: bool = False) -> torch.Tensor:
    """Decode codes `[B, K, T']` (and scale `[B, 1]`) → waveform `[B, T, C]`
    (K3; `plain=True` runs its plain twin, even on CUDA tensors)."""
    emb = rvq_decode(qstate, codes.permute(1, 0, 2), cfg.rvq)
    out = seanet_decoder(params["decoder"], emb, cfg.seanet, plain=plain)
    if scale is not None:
        out = out * scale.reshape(-1, 1, 1)
    return out


def forward_train(params, qstate: RVQState, x: torch.Tensor,
                  cfg: EncodecConfig, n_q: int,
                  generator: tp.Optional[torch.Generator] = None,
                  training: bool = True, plain: bool = False,
                  dp: BatchReduce = LOCAL, **draws):
    """Fork-style training forward on one (unsegmented) batch `[B, T, C]`.

    Returns (x_hat [B, T, C], codes [B, K, T'], commit_losses [K],
    new_qstate). `params` is the unfolded tree (weight norm as (v, g)), so
    gradients reach v and g; the same commit quantity doubles as commit and
    codebook loss in the reference (vq.py:114), and callers weight them
    separately. `training=False` is the eval forward: K2 codes and the
    quantizer state unchanged. `draws` (`init_idx`, `sample_idx`,
    `margins`) go to `rvq_forward`, and `dp` (the batch's reductions over
    a data-parallel step's ranks); `plain=True` runs every kernel's plain
    twin."""
    emb = seanet_encoder(params["encoder"], x, cfg.seanet, plain=plain)
    quantized, codes, commit, new_qstate = rvq_forward(
        qstate, emb, cfg.rvq, n_q=n_q, training=training, generator=generator,
        plain=plain, dp=dp, **draws)
    out = seanet_decoder(params["decoder"], quantized, cfg.seanet, plain=plain)
    return out[:, :x.shape[1]], codes.permute(1, 0, 2), commit, new_qstate


# ---------------------------------------------------------------------------
# PCM16 wire format, converted on the device: int16 → f32 is exact (/32768
# is a power of two), so an int16 input gives the codes of its float
# conversion; the output quantizer is `utils.audio.save_wav`'s (clip ±0.99,
# ×32767, truncate toward zero).
# ---------------------------------------------------------------------------

def _float_from_pcm16(x: torch.Tensor) -> torch.Tensor:
    """int16 PCM → [-1, 1) float32, as `utils.audio.load_wav` converts it;
    float input is cast to float32."""
    if x.dtype == torch.int16:
        return x.to(torch.float32) / 32768.0
    if not x.is_floating_point():
        raise TypeError(f"expected int16 PCM or float audio, got {x.dtype}")
    return x.to(torch.float32)


def _pcm16_from_float(wav: torch.Tensor) -> torch.Tensor:
    """float → int16 PCM, bit-identical to `save_wav`'s host quantizer."""
    return torch.trunc(wav.clamp(-0.99, 0.99) * 32767.0).to(torch.int16)


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
    def normalize(self) -> bool:
        return self.cfg.normalize

    @property
    def frame_rate(self) -> int:
        return self.cfg.frame_rate

    @property
    def segment_length(self) -> tp.Optional[int]:
        return self.cfg.segment_length

    @property
    def segment_stride(self) -> tp.Optional[int]:
        return self.cfg.segment_stride

    @property
    def bits_per_codebook(self) -> int:
        return self.cfg.bits_per_codebook

    @property
    def target_bandwidths(self) -> tp.List[float]:
        return list(self.cfg.target_bandwidths)

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

    @property
    def codebooks(self) -> torch.Tensor:
        """Stacked RVQ codebooks `[n_books, bins, dim]` (one book for a
        shared-codebook model)."""
        return self.qstate.embed

    def get_lm_model(self, repository: tp.Optional[str] = None):
        """The published LM of this model (`models.lm.get_lm_model`), read
        from the local `repository`, on this model's device."""
        from .lm import get_lm_model
        return get_lm_model(self, repository)

    # -- public API -------------------------------------------------------
    def segment_groups(self, x) -> tp.Tuple[int, tp.List[tp.Tuple[
            tp.List[int], torch.Tensor]]]:
        """Cut `[B, C, T]` audio (float, or int16 PCM) into the model's
        segments and stack the segments of equal length on the batch axis.

        Returns (B, [(segment indices, float32 `[G·B, L, C]` on the model's
        device, row `j·B + b` = segment `indices[j]` of item b)]), groups in
        the order of their first segment."""
        x = torch.as_tensor(x)
        if x.dim() != 3 or not 0 < x.shape[1] <= 2 or x.shape[2] == 0:
            raise ValueError(f"expected [B, C, T] audio, got {tuple(x.shape)}")
        x = _float_from_pcm16(x.to(self.device)).transpose(1, 2)
        by_len: tp.Dict[int, tp.List[tp.Tuple[int, int]]] = {}
        for i, (off, length) in enumerate(self.cfg.segments(x.shape[1])):
            by_len.setdefault(length, []).append((i, off))
        groups = []
        for length, members in by_len.items():
            idxs = [i for i, _ in members]
            stacked = torch.cat([x[:, off:off + length] for _, off in members])
            groups.append((idxs, stacked))
        return x.shape[0], groups

    @staticmethod
    def _split(B: int, idxs: tp.List[int], codes: torch.Tensor,
               scale: tp.Optional[torch.Tensor],
               frames: tp.List[tp.Optional[EncodedFrame]]) -> None:
        for j, i in enumerate(idxs):
            frames[i] = (codes[j * B:(j + 1) * B],
                         None if scale is None else scale[j * B:(j + 1) * B])

    @torch.inference_mode()
    def encode(self, x) -> tp.List[EncodedFrame]:
        """x: `[B, C, T]` audio (float in [-1, 1], or int16 PCM). Returns one
        `(codes [B, K, T'] int32, scale [B, 1] or None)` frame per segment."""
        B, groups = self.segment_groups(x)
        frames: tp.List[tp.Optional[EncodedFrame]] = [None] * sum(
            len(idxs) for idxs, _ in groups)
        for idxs, stacked in groups:
            codes, scale = encode_frame(self.infer_params, self.qstate,
                                        stacked, self.cfg, self.n_q_active)
            self._split(B, idxs, codes, scale, frames)
        return frames  # type: ignore[return-value]

    @torch.inference_mode()
    def encode_guarded(self, x, threshold: float = 1e-3
                       ) -> tp.Tuple[tp.List[EncodedFrame], dict]:
        """`encode` with the container-writing near-tie guard.

        Per position the RVQ argmin's top-2 gap is computed on the device
        (K1); positions whose margin at any stage falls under `threshold`
        get their whole code chain re-resolved on the host in float64 with
        the reference association order (`resolve_ties_f64`), so writers
        whose latents agree emit identical codes. Runs once per group of
        equal-length segments. Returns (frames, stats: min_margin (minimum
        over groups), n_flagged, n_changed, n_positions (sums))."""
        B, groups = self.segment_groups(x)
        frames: tp.List[tp.Optional[EncodedFrame]] = [None] * sum(
            len(idxs) for idxs, _ in groups)
        stats = {"min_margin": float("inf"), "n_flagged": 0, "n_changed": 0,
                 "n_positions": 0}
        for idxs, stacked in groups:
            codes, scale, z, margins = encode_frame_margins(
                self.infer_params, self.qstate, stacked, self.cfg,
                self.n_q_active)
            codes = codes.cpu().numpy()              # [G·B, K, T']
            m = margins.cpu().numpy()                # [G·B, K, T']
            stats["n_positions"] += int(m.shape[0] * m.shape[2])
            if m.size:
                stats["min_margin"] = min(stats["min_margin"], float(m.min()))
            flagged = (m < threshold).any(axis=1)    # [G·B, T']
            if flagged.any():
                bs, ts = np.nonzero(flagged)
                fixed = resolve_ties_f64(self.qstate, z.cpu().numpy()[bs, ts],
                                         self.cfg.rvq, codes.shape[1])
                before = codes[bs, :, ts].copy()
                codes[bs, :, ts] = fixed
                stats["n_flagged"] += int(bs.size)
                stats["n_changed"] += int((before != fixed).any(1).sum())
            self._split(B, idxs, torch.from_numpy(codes).to(self.device),
                        scale, frames)
        return frames, stats  # type: ignore[return-value]

    @torch.inference_mode()
    def decode(self, frames: tp.Sequence[EncodedFrame],
               pcm16: bool = False) -> torch.Tensor:
        """Decode frames → `[B, C, T]` waveform (may be slightly longer than
        the original input; callers trim).

        Frames of equal code length and scale presence decode as one batch
        (the S full segments of a segmented stream at once, the shorter tail
        by itself), then a segmented model overlap-adds them, even a single
        one. `pcm16=True` returns int16 PCM quantized on the device,
        bit-identical to `utils.audio.save_wav`'s host quantizer."""
        if not frames:
            raise ValueError("no frames to decode")
        if self.cfg.segment is None and len(frames) != 1:
            raise ValueError(f"an unsegmented model decodes one frame, got "
                             f"{len(frames)}")
        B = frames[0][0].shape[0]
        by_key: tp.Dict[tp.Tuple[int, bool], tp.List[int]] = {}
        for i, (codes, scale) in enumerate(frames):
            by_key.setdefault((codes.shape[-1], scale is None), []).append(i)
        outs: tp.List[tp.Optional[torch.Tensor]] = [None] * len(frames)
        for (_, no_scale), idxs in by_key.items():
            codes = torch.cat([torch.as_tensor(frames[i][0]) for i in idxs])
            scale = None if no_scale else torch.cat(
                [torch.as_tensor(frames[i][1]) for i in idxs]).to(self.device)
            out = decode_frame(self.infer_params, self.qstate,
                               codes.to(self.device), self.cfg, scale)
            for j, i in enumerate(idxs):
                outs[i] = out[j * B:(j + 1) * B]
        if self.cfg.segment is None:
            out = outs[0]
        else:
            out = linear_overlap_add(outs, self.segment_stride)
        out = out.transpose(1, 2)
        return _pcm16_from_float(out) if pcm16 else out

    def forward(self, x):
        """Fork-parity forward: returns (x_hat [B, C, T], codes [B, K, T'],
        commit, codebook) without updating the quantizer state (eval
        semantics).

        Unsegmented, unnormalized models (the trainable configuration) run
        the training graph with `training=False`; segmented or normalized
        models (48 kHz) go through encode → decode, so per-segment scaling
        and overlap-add apply, as in the reference forward (model.py:
        248-257)."""
        x = _float_from_pcm16(torch.as_tensor(x).to(self.device))
        if self.cfg.segment is None and not self.cfg.normalize:
            out, codes, commit, _ = forward_train(
                self.params, self.qstate, x.transpose(1, 2), self.cfg,
                self.n_q_active, training=False)
            return out.transpose(1, 2), codes, commit, commit
        frames = self.encode(x)
        codes = torch.cat([f[0] for f in frames], dim=-1)
        out = self.decode(frames)[:, :, :x.shape[-1]]
        commit = x.new_zeros(codes.shape[1])
        return out, codes, commit, commit

    __call__ = forward


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
        target_bandwidths=TARGET_BANDWIDTHS["encodec_24khz"],
        sample_rate=24_000, channels=1, causal=True,
        model_norm="weight_norm", audio_normalize=False,
        name="encodec_24khz" if pretrained else "unset",
        ratios=[8, 5, 4, 2], bins=1024, dimension=128,
        kmeans_init=kmeans_init, device=device)
    if pretrained:
        from .zoo import load_pretrained
        load_pretrained(model, "encodec_24khz-d7cc33bc.th", repository)
    return model


def encodec_model_48khz(pretrained: bool = False,
                        repository: tp.Optional[str] = None, *,
                        device: tp.Union[str, torch.device] = "cuda",
                        kmeans_init: bool = True) -> EncodecModel:
    """Non-causal stereo 48 kHz model (n_filters=32, dimension=128, 1024
    bins, up to 16 stages, `time_group_norm`, per-segment normalization, 1 s
    segments with 1% overlap). `pretrained` loads the published checkpoint
    from the local `repository`."""
    model = build_model(
        target_bandwidths=TARGET_BANDWIDTHS["encodec_48khz"],
        sample_rate=48_000, channels=2, causal=False,
        model_norm="time_group_norm", audio_normalize=True, segment=1.0,
        name="encodec_48khz" if pretrained else "unset",
        ratios=[8, 5, 4, 2], bins=1024, dimension=128,
        kmeans_init=kmeans_init, device=device)
    if pretrained:
        from .zoo import load_pretrained
        load_pretrained(model, "encodec_48khz-7e698e3e.th", repository)
    return model


def breathing_model(target_bandwidths: tp.Sequence[float] = (0.08,),
                    sample_rate: int = 10, channels: int = 1,
                    ratios: tp.Sequence[int] = (6, 5, 5, 2, 1),
                    bins: int = 1024, dimension: int = 256,
                    causal: bool = True, model_norm: str = "layer_norm", *,
                    device: tp.Union[str, torch.device] = "cuda",
                    kmeans_init: bool = True, **kw) -> EncodecModel:
    """The fork's trainable breathing tokenizer: 10 Hz, hop 300, 1024 bins,
    dimension 256, one shared codebook, 8 stages at 0.08 kbps, causal
    `layer_norm` convs and no norm on the decoder's last conv; its LSTM has
    H = 32·2⁵ = 1024 (K3's grid kernel on the card). `kw` goes to
    `build_model` (`n_filters`, `seed`, ...)."""
    return build_model(target_bandwidths=list(target_bandwidths),
                       sample_rate=sample_rate, channels=channels,
                       causal=causal, model_norm=model_norm,
                       ratios=list(ratios), bins=bins, dimension=dimension,
                       name="breathing_model", decoder_final_norm="none",
                       shared_codebook=True, kmeans_init=kmeans_init,
                       device=device, **kw)


MODELS = {
    "encodec_24khz": encodec_model_24khz,
    "encodec_48khz": encodec_model_48khz,
}
