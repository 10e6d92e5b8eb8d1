"""Streaming SEANet codec: chunked causal encode/decode with carried state.

Port of `encodec_tpu/models/streaming.py`. Exactness contract: chunks
whose lengths are multiples of the hop (`prod(ratios)`) reproduce the batch
encoder's latents, hence its codes, including the reflect padding at the
signal start: each conv's initial context is primed from the head of its
own first-chunk input, which equals the batch padding by induction, so the
first chunk must be at least `min_first_chunk` samples. `encode_finish`
makes a tail shorter than a hop exact too. On the card, K3 runs each
chunk's LSTM layers from the carried `(h, c)` with the arithmetic of one
launch over the whole sequence; what can still move a latent by an ulp is
a library choosing another algorithm for a chunk's shape than for the
whole sequence's (cuDNN per convolution shape, cuBLAS for the LSTM's
input projection). Chunked decode matches the batch decoder to float
tolerance: a transposed conv adds the carried overlap tail after the
chunk's convolution, not inside one whole-sequence sum.

State is a plain dict and list tree of tensors on the model's device
(per-conv left contexts, the LSTM's `(h, c)`, per-transposed-conv overlap
tails). Causal models only: the 48 kHz non-causal model streams through
its segments instead.
"""

from __future__ import annotations

import typing as tp

import torch

from .. import ops
from ..device import precision_scope
from ..ops.streaming import (convtr_stream_init, prime_conv_stream,
                             sconv1d_stream, sconv1d_stream_finish,
                             sconv_transpose1d_stream)
from ..quant import rvq_decode, rvq_encode
from .model import _float_from_pcm16
from .seanet import SEANetConfig, _act, _resblock_dims, resolve_activation

Params = tp.Dict[str, tp.Any]
State = tp.Dict[str, tp.Any]


def min_first_chunk(cfg: SEANetConfig) -> int:
    """Smallest valid FIRST chunk length in samples (a hop multiple).

    Priming a conv's reflect left context from the first chunk needs at
    least `ctx + 1` samples at that layer's rate; a shorter first chunk
    takes the short-input reflect path and diverges from the batch
    encoder. Walks the encoder's layers and returns the smallest hop
    multiple that satisfies every one."""
    reqs: tp.List[tp.Tuple[int, int]] = []  # (ctx, downsampling factor there)
    factor = 1

    def add(k: int, s: int = 1, d: int = 1) -> None:
        ctx = (k - 1) * d + 1 - s
        if ctx > 0:
            reqs.append((ctx, factor))

    add(cfg.kernel_size)
    for ratio in cfg.encoder_ratios:
        for j in range(cfg.n_residual_layers):
            add(cfg.residual_kernel_size, d=cfg.dilation_base ** j)
            add(1)
        add(2 * ratio, s=ratio)
        factor *= ratio
    add(cfg.last_kernel_size)  # token rate
    L = hop = factor
    while any(L // f < ctx + 1 for ctx, f in reqs):
        L += hop
    return L


def min_first_latent_chunk(cfg: SEANetConfig) -> int:
    """Smallest valid FIRST chunk length in latents for the streaming
    decoder: each conv after the init conv and each upsampling stage primes
    its reflect context from its own first-chunk input, which needs
    `ctx + 1` samples at that layer's rate."""
    factor = 1  # samples per latent at the current depth

    def req(k: int, d: int = 1) -> int:
        return -(-((k - 1) * d + 1) // factor)

    need = max(1, req(cfg.kernel_size))
    for ratio in cfg.ratios:
        factor *= ratio
        for j in range(cfg.n_residual_layers):
            need = max(need, req(cfg.residual_kernel_size,
                                 cfg.dilation_base ** j))
    return max(need, req(cfg.last_kernel_size))


def _require_causal(cfg: SEANetConfig) -> None:
    if not cfg.causal:
        raise ValueError("streaming requires a causal model")


def _stream_conv(p: Params, x: torch.Tensor, st: tp.Optional[torch.Tensor],
                 *, k: int, s: int = 1, d: int = 1, cfg: SEANetConfig,
                 norm: tp.Optional[str] = None):
    """Streaming conv; primes the state from this first chunk when None."""
    if st is None:
        st = prime_conv_stream(x, k, s, d, pad_mode=cfg.pad_mode)
    return sconv1d_stream(p, x, st, kernel_size=k, stride=s, dilation=d,
                          norm=cfg.norm if norm is None else norm)


def _stream_resblock(p: Params, x: torch.Tensor, st, cfg: SEANetConfig,
                     dilations: tp.Sequence[int]):
    ks, _ = _resblock_dims(cfg, x.shape[-1])
    sts = st if st is not None else [None] * (len(ks) + 1)
    new_sts = []
    y = x
    for i, (conv_p, k, d) in enumerate(zip(p["convs"], ks, dilations)):
        y = _act(y, cfg.activation_alpha)
        y, s_new = _stream_conv(conv_p, y, sts[i], k=k, d=d, cfg=cfg)
        new_sts.append(s_new)
    if "shortcut" in p:
        sc, s_new = _stream_conv(p["shortcut"], x, sts[len(ks)], k=1, cfg=cfg)
        new_sts.append(s_new)
    else:
        sc = x
        new_sts.append(x[:, :0])
    return sc + y, new_sts


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def encoder_stream_step(params: Params, chunk: torch.Tensor,
                        state: tp.Optional[State], cfg: SEANetConfig
                        ) -> tp.Tuple[torch.Tensor, State]:
    """Encode one `[B, L, C]` chunk (`L % hop == 0`) → `[B, L/hop, D]`.

    Pass `state=None` for the first chunk (priming) and the returned state
    afterwards."""
    _require_causal(cfg)
    if chunk.shape[1] % cfg.hop_length:
        raise ValueError(f"chunk length {chunk.shape[1]} is not a multiple "
                         f"of the hop {cfg.hop_length}")
    st = state or {}
    new_st: State = {}
    y, new_st["init"] = _stream_conv(params["init_conv"], chunk,
                                     st.get("init"), k=cfg.kernel_size,
                                     cfg=cfg)
    res_states = st.get("res") or [None] * len(params["stages"])
    down_states = st.get("down") or [None] * len(params["stages"])
    new_res, new_down = [], []
    for si, (stage, ratio) in enumerate(zip(params["stages"],
                                            cfg.encoder_ratios)):
        stage_res = res_states[si] or [None] * len(stage["res"])
        stage_new = []
        for j, res_p in enumerate(stage["res"]):
            y, rst = _stream_resblock(res_p, y, stage_res[j], cfg,
                                      [cfg.dilation_base ** j, 1])
            stage_new.append(rst)
        new_res.append(stage_new)
        y = _act(y, cfg.activation_alpha)
        y, s = _stream_conv(stage["down"], y, down_states[si], k=ratio * 2,
                            s=ratio, cfg=cfg)
        new_down.append(s)
    if cfg.lstm:
        y, new_st["lstm"] = ops.lstm(params["lstm"], y, skip=True,
                                     state=st.get("lstm"), return_state=True)
    y = _act(y, cfg.activation_alpha)
    y, s = _stream_conv(params["final_conv"], y, st.get("final"),
                        k=cfg.last_kernel_size, cfg=cfg)
    new_st.update(res=new_res, down=new_down, final=s)
    return y, new_st


def encoder_stream_finish(params: Params, tail: torch.Tensor, state: State,
                          cfg: SEANetConfig) -> torch.Tensor:
    """Encode the stream's FINAL partial chunk (`0 < L_tail < hop`) with the
    batch encoder's end-of-signal padding → the last latent frame
    `[B, 1, D]`.

    The batch encoder right-pads every conv so its last window is full, so
    a signal of `L` samples gives `ceil(L / hop)` frames; chunks cover the
    first `floor(L / hop) · hop` samples exactly and this covers the rest.
    `state` must come from at least one prior chunk; the stream is then
    finished (no state is returned)."""
    _require_causal(cfg)
    if not state:
        raise ValueError("finish requires a primed stream state")
    if not 0 < tail.shape[1] < cfg.hop_length:
        raise ValueError(f"tail length {tail.shape[1]} must be in "
                         f"(0, {cfg.hop_length})")

    def fin(p, x, st, *, k, s=1, d=1):
        return sconv1d_stream_finish(p, x, st, kernel_size=k, stride=s,
                                     dilation=d, norm=cfg.norm,
                                     pad_mode=cfg.pad_mode)

    def fin_resblock(p, x, sts, dilations):
        ks, _ = _resblock_dims(cfg, x.shape[-1])
        y = x
        for i, (conv_p, k, d) in enumerate(zip(p["convs"], ks, dilations)):
            y = fin(conv_p, _act(y, cfg.activation_alpha), sts[i], k=k, d=d)
        sc = fin(p["shortcut"], x, sts[len(ks)], k=1) if "shortcut" in p \
            else x
        return sc + y

    y = fin(params["init_conv"], tail, state["init"], k=cfg.kernel_size)
    for si, (stage, ratio) in enumerate(zip(params["stages"],
                                            cfg.encoder_ratios)):
        for j, res_p in enumerate(stage["res"]):
            y = fin_resblock(res_p, y, state["res"][si][j],
                             [cfg.dilation_base ** j, 1])
        y = fin(stage["down"], _act(y, cfg.activation_alpha),
                state["down"][si], k=ratio * 2, s=ratio)
    if cfg.lstm:
        y, _ = ops.lstm(params["lstm"], y, skip=True, state=state["lstm"],
                        return_state=True)
    return fin(params["final_conv"], _act(y, cfg.activation_alpha),
               state["final"], k=cfg.last_kernel_size)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def decoder_stream_step(params: Params, z_chunk: torch.Tensor,
                        state: tp.Optional[State], cfg: SEANetConfig
                        ) -> tp.Tuple[torch.Tensor, State]:
    """Decode a `[B, Lz, D]` latent chunk → `[B, Lz*hop, C]` audio."""
    _require_causal(cfg)
    if cfg.trim_right_ratio != 1.0:
        raise ValueError("streaming decode requires trim_right_ratio == 1.0")
    need = min_first_latent_chunk(cfg)
    if state is None and z_chunk.shape[1] < need:
        raise ValueError(
            f"first latent chunk ({z_chunk.shape[1]}) is shorter than "
            f"min_first_latent_chunk ({need}): the conv contexts cannot be "
            "primed exactly and decode would silently diverge from the "
            "batch path")
    st = state or {}
    new_st: State = {}
    y, new_st["init"] = _stream_conv(params["init_conv"], z_chunk,
                                     st.get("init"), k=cfg.kernel_size,
                                     cfg=cfg)
    if cfg.lstm:
        y, new_st["lstm"] = ops.lstm(params["lstm"], y, skip=True,
                                     state=st.get("lstm"), return_state=True)
    up_states = st.get("up") or [None] * len(params["stages"])
    res_states = st.get("res") or [None] * len(params["stages"])
    new_up, new_res = [], []
    for si, (stage, ratio) in enumerate(zip(params["stages"], cfg.ratios)):
        y = _act(y, cfg.activation_alpha)
        carry = up_states[si]
        if carry is None:
            out_ch = ops.effective_weight(stage["up"]).shape[1]
            carry = convtr_stream_init(y.shape[0], out_ch, ratio * 2, ratio,
                                       y.dtype, y.device)
        y, carry = sconv_transpose1d_stream(
            stage["up"], y, carry, kernel_size=ratio * 2, stride=ratio,
            norm=cfg.norm if cfg.norm in ("none", "weight_norm") else "none")
        # module norms (layer_norm) act per time step: apply them here
        if cfg.norm == "layer_norm":
            y = ops.layer_norm(y, stage["up"]["norm"]["scale"],
                               stage["up"]["norm"]["bias"])
        new_up.append(carry)
        stage_res = res_states[si] or [None] * len(stage["res"])
        stage_new = []
        for j, res_p in enumerate(stage["res"]):
            y, rst = _stream_resblock(res_p, y, stage_res[j], cfg,
                                      [cfg.dilation_base ** j, 1])
            stage_new.append(rst)
        new_res.append(stage_new)
    y = _act(y, cfg.activation_alpha)
    y, s = _stream_conv(params["final_conv"], y, st.get("final"),
                        k=cfg.last_kernel_size, cfg=cfg,
                        norm=cfg.resolved_decoder_final_norm())
    if cfg.final_activation is not None:
        y = resolve_activation(cfg.final_activation)(y)
    new_st.update(up=new_up, res=new_res, final=s)
    return y, new_st


# ---------------------------------------------------------------------------
# Codec-level convenience
# ---------------------------------------------------------------------------

class StreamingCodec:
    """Chunked encode/decode around a causal `EncodecModel`.

    Audio is `[B, C, L]` (float, or int16 PCM) and codes `[B, K, L']`, as
    at `EncodecModel`. `n_q` is fixed when the codec is built (the model's
    bandwidth setting then, unless given) and does not follow later
    changes of the model's bandwidth; assigning `codec.n_q` takes effect
    from the next chunk. Each chunk runs in the model's precision mode at
    that call (`EncodecModel.set_precision`: its TF32 flags around the
    chunk, its conv dtype), as the offline calls do, so streamed codes
    follow the same arithmetic as `model.encode`'s."""

    def __init__(self, model, n_q: tp.Optional[int] = None):
        self.model = model
        self.cfg = model.cfg
        self.n_q = n_q or model.n_q_active
        self._enc_state: tp.Optional[State] = None
        self._dec_state: tp.Optional[State] = None

    @property
    def hop(self) -> int:
        return self.cfg.seanet.hop_length

    def reset(self) -> None:
        self._enc_state = None
        self._dec_state = None

    def _audio(self, chunk) -> torch.Tensor:
        """Audio in the conv trunk's dtype, `[B, L, C]`."""
        x = _float_from_pcm16(torch.as_tensor(chunk).to(self.model.device))
        return x.to(self.model.compute_dtype).transpose(1, 2)

    def _codes(self, emb: torch.Tensor) -> torch.Tensor:
        codes = rvq_encode(self.model.qstate, emb.float(), self.cfg.rvq,
                           n_q=self.n_q)
        return codes.permute(1, 0, 2)

    @torch.inference_mode()
    def encode_chunk(self, chunk) -> torch.Tensor:
        """`[B, C, L]` audio chunk (`L % hop == 0`) → codes `[B, K, L/hop]`
        (K3 from the carried state, K2)."""
        with precision_scope(self.model.precision):
            emb, self._enc_state = encoder_stream_step(
                self.model.infer_params["encoder"], self._audio(chunk),
                self._enc_state, self.cfg.seanet)
            return self._codes(emb)

    @torch.inference_mode()
    def encode_finish(self, tail) -> torch.Tensor:
        """Encode the stream's FINAL partial chunk (`0 < L < hop`) with the
        batch path's end-of-signal padding → codes `[B, K, 1]`; the encode
        stream is then finished (state cleared). Chunks and finish together
        give the codes of `model.encode` for any signal length."""
        if self._enc_state is None:
            raise ValueError("encode_finish needs at least one prior "
                             "encode_chunk")
        with precision_scope(self.model.precision):
            emb = encoder_stream_finish(self.model.infer_params["encoder"],
                                        self._audio(tail), self._enc_state,
                                        self.cfg.seanet)
            self._enc_state = None
            return self._codes(emb)

    @torch.inference_mode()
    def decode_chunk(self, codes) -> torch.Tensor:
        """codes `[B, K, Lq]` → audio `[B, C, Lq*hop]` (K3 from the carried
        state)."""
        codes = torch.as_tensor(codes).to(self.model.device)
        emb = rvq_decode(self.model.qstate, codes.permute(1, 0, 2),
                         self.cfg.rvq)
        with precision_scope(self.model.precision):
            out, self._dec_state = decoder_stream_step(
                self.model.infer_params["decoder"],
                emb.to(self.model.compute_dtype), self._dec_state,
                self.cfg.seanet)
        return out.float().transpose(1, 2)
