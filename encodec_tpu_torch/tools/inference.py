"""Code extraction: offline, and through the streaming encoder in fixed chunks.

Port of `encodec_tpu/tools/inference.py:20-185` (`extract_codes` and
`_StreamExtractor`). Signals are `[C, T]` numpy arrays and codes `[K, T']`
int32 numpy arrays, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.streaming import (encoder_stream_finish, encoder_stream_step,
                                min_first_chunk)
from ..quant import rvq_encode


def extract_codes(model, x: np.ndarray) -> np.ndarray:
    """Encode one `[C, T]` signal → codes `[K, T']` (int32)."""
    frames = model.encode(torch.as_tensor(np.asarray(x))[None])
    codes = np.concatenate([f[0][0].cpu().numpy() for f in frames], axis=-1)
    return codes.astype(np.int32)


class _StreamExtractor:
    """Fixed-chunk code extraction through the streaming encoder, equal to
    `extract_codes` for every length.

    Every signal runs as chunks of `chunk_hops` hops, then the remainder of
    whole hops as a binary ladder of power-of-two pieces (at most
    log2(chunk_hops) shapes, shared by every signal), then a tail shorter
    than a hop through `encoder_stream_finish`, the batch path's
    end-of-signal padding. A dataset sweep therefore meets a bounded set of
    convolution shapes, where `extract_codes` meets a new set for every new
    length; on the card each new shape pays a library's per-shape setup.
    `exact_tail=False` zero-pads the signal to a chunk multiple instead
    (one chunk shape; the final partial frame may differ). Signals shorter
    than one chunk go to `extract_codes` (they cannot prime the contexts at
    the chunk shape). The number of stages follows the model's bandwidth
    setting at each call."""

    def __init__(self, model, chunk_hops: int = 1024,
                 exact_tail: bool = True):
        cfg = model.cfg
        if cfg.normalize or cfg.segment is not None:
            raise ValueError(
                "streaming extraction bypasses per-segment scaling; use "
                "the offline extract_codes for normalize/segmented models")
        self.model = model
        self.hop = cfg.seanet.hop_length
        self.chunk = chunk_hops * self.hop
        self.exact_tail = exact_tail
        need = min_first_chunk(cfg.seanet)
        if self.chunk < need:
            raise ValueError(
                f"chunk ({self.chunk} samples) must be >= min_first_chunk "
                f"({need}) to prime the streaming conv contexts exactly")

    def _codes(self, emb: torch.Tensor) -> torch.Tensor:
        return rvq_encode(self.model.qstate, emb, self.model.cfg.rvq,
                          n_q=self.model.n_q_active)      # [K, 1, T']

    def _step(self, xt: torch.Tensor, st):
        emb, st = encoder_stream_step(self.model.infer_params["encoder"], xt,
                                      st, self.model.cfg.seanet)
        return self._codes(emb), st

    @torch.inference_mode()
    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        T = x.shape[1]
        hop = self.hop
        T_full = (T // hop) * hop
        if not self.exact_tail or T_full == T:
            return self._zero_padded(x)
        if T_full < self.chunk:
            return extract_codes(self.model, x)  # too short to prime
        xt_all = torch.from_numpy(np.ascontiguousarray(x.T, np.float32))[
            None].to(self.model.device)                   # [1, T, C]
        boundary = (T_full // self.chunk) * self.chunk
        outs = []
        st = None
        for off in range(0, boundary, self.chunk):
            codes, st = self._step(xt_all[:, off:off + self.chunk], st)
            outs.append(codes)
        # the remaining m whole hops, by m's own binary representation
        off = boundary
        m = (T_full - boundary) // hop
        b = 1 << (m.bit_length() - 1) if m > 0 else 0
        while m > 0:
            if m >= b:
                codes, st = self._step(xt_all[:, off:off + b * hop], st)
                outs.append(codes)
                off += b * hop
                m -= b
            b //= 2
        emb = encoder_stream_finish(self.model.infer_params["encoder"],
                                    xt_all[:, T_full:], st,
                                    self.model.cfg.seanet)
        outs.append(self._codes(emb))
        return torch.cat(outs, dim=-1)[:, 0].cpu().numpy().astype(np.int32)

    def _zero_padded(self, x: np.ndarray) -> np.ndarray:
        C, T = x.shape
        n_frames = -(-T // self.hop)
        Tp = -(-T // self.chunk) * self.chunk
        xp = np.zeros((1, Tp, C), np.float32)
        xp[0, :T] = x.T
        xt_all = torch.from_numpy(xp).to(self.model.device)
        outs, st = [], None
        for off in range(0, Tp, self.chunk):
            codes, st = self._step(xt_all[:, off:off + self.chunk], st)
            outs.append(codes)
        codes = torch.cat(outs, dim=-1)[:, 0, :n_frames]
        return codes.cpu().numpy().astype(np.int32)
