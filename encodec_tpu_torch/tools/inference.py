"""Token extraction over a dataset, and codebook diagnostics.

Port of `encodec_tpu/tools/inference.py`: `extract_codes` (offline) and
`_StreamExtractor` (the streaming encoder in fixed chunks), `process_dataset`
(codes per night to `.npz`), `code_distribution`, `decode_most_frequent`
and the command line

    python -m encodec_tpu_torch.tools.inference --config CFG.yaml \
        --checkpoint MODEL.ckpt --data_root DIR --dataset NAME --out DIR \
        [--channel thorax] [--stream_chunk_hops N] [--device cuda]

which reads a checkpoint of the JAX trainer or of the port's
(`train.checkpoint`; the port's by its `param_layout`) and writes the same
`.npz` files as the JAX tool. The config is YAML (read without PyYAML where
it is missing, `train.load_config`) or JSON. Signals are `[C, T]` numpy
arrays and codes `[K, T']` int32 numpy arrays, as in the JAX package.
"""

from __future__ import annotations

import functools
import os
import typing as tp

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


def process_dataset(model, dataset, out_dir: str,
                    channel_subdir: bool = True,
                    stream_chunk_hops: tp.Optional[int] = None) -> int:
    """Dump codes for every item of a (test-mode) dataset to
    `{out_dir}/[{channel}/]{filename}.npz` with keys `codes` and `fs` (the
    token rate). Returns the number written. `stream_chunk_hops` (causal
    models): extract through `_StreamExtractor` in chunks of that many hops,
    so every night meets the same few shapes."""
    token_fs = model.sample_rate / int(np.prod(model.cfg.seanet.ratios))
    if stream_chunk_hops is None:
        extract = functools.partial(extract_codes, model)
    else:
        extract = _StreamExtractor(model, stream_chunk_hops)
    count = 0
    for i in range(len(dataset)):
        item = dataset[i]
        codes = extract(item["x"])
        sub = os.path.join(out_dir, item["selected_channel"]) \
            if channel_subdir else out_dir
        os.makedirs(sub, exist_ok=True)
        np.savez(os.path.join(sub, item["filename"]), codes=codes,
                 fs=token_fs)
        count += 1
    return count


def code_distribution(all_codes: np.ndarray, bins: int) -> dict:
    """Per-codebook histogram and empirical entropy of `[K, N]` (or
    `[K, B, T]`) codes: {"counts": [K, bins], "probs", "entropy": [K]}."""
    codes = all_codes.reshape(all_codes.shape[0], -1)
    K = codes.shape[0]
    counts = np.stack([np.bincount(codes[k], minlength=bins)
                       for k in range(K)])
    probs = counts / np.maximum(1, counts.sum(axis=1, keepdims=True))
    entropy = np.array([
        float(-(p[p > 0] * np.log2(p[p > 0])).sum()) for p in probs])
    return {"counts": counts, "probs": probs, "entropy": entropy}


def decode_most_frequent(model, counts: np.ndarray, length: int) -> np.ndarray:
    """Decode a constant stream of each codebook's most frequent token,
    `length` frames long. Returns `[C, T]` audio."""
    top = counts.argmax(axis=1)                           # [K]
    codes = np.tile(top[None, :, None], (1, 1, length))  # [1, K, T]
    out = model.decode([(torch.from_numpy(codes.astype(np.int32)), None)])
    return out[0].cpu().numpy()


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> None:
    import argparse

    from ..data import BreathingDataset
    from ..models.zoo import params_from_jax
    from ..train import load_checkpoint, load_config, model_from_config
    from ..train.trainer import PARAM_LAYOUT, state_to_device

    parser = argparse.ArgumentParser("encodec_tpu_torch.tools.inference")
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True,
                        help="a .ckpt written by the JAX trainer or the "
                             "port's")
    parser.add_argument("--data_root", required=True)
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--channel", default="thorax")
    parser.add_argument("--out", required=True)
    parser.add_argument("--stream_chunk_hops", type=int, default=None,
                        help="fixed-chunk streaming extraction (causal "
                             "models): the same few shapes for every night "
                             "length")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only when "
                             "asked)")
    args = parser.parse_args(argv)

    model = model_from_config(load_config(args.config), device=args.device)
    state, _, extra = load_checkpoint(args.checkpoint)
    # TrainState's first two fields: the model's parameters and its
    # quantizer state, in the JAX layout unless the port's trainer wrote
    # them
    if extra.get("param_layout") == PARAM_LAYOUT:
        state = state_to_device(state, model.device)
        model.params, model.qstate = state.params, state.qstate
    else:
        model.params, model.qstate = params_from_jax(state[0], state[1],
                                                     model.cfg)
    ds = BreathingDataset(args.data_root, args.dataset, mode="test",
                          channels={args.channel: 1.0})
    n = process_dataset(model, ds, args.out,
                        stream_chunk_hops=args.stream_chunk_hops)
    print(f"wrote {n} code files to {args.out}")


if __name__ == "__main__":
    main()
