"""Weights and signals made from the seed, on the device, in a few large
calls.

Weights: the parameter tree whose shapes the program's factory gave is
filled anew from one `torch.Generator` on the device: every conv weight
and bias uniform in ±1/sqrt(fan_in) (PyTorch's default for `Conv1d`,
`ConvTranspose1d` and `Conv2d`), weight norm's g the norm of v (so the
weight is v), every LSTM matrix and bias uniform in ±1/sqrt(H), spectral
norm's vectors normalized, each norm's scale uniform in 1 ± 0.1 and its
bias in ±0.1. One `torch.rand` covers the whole tree.

Signals (each row different, every seed the same sizes):
- `breathing`: 10 Hz respiration belts: a breathing rhythm of 10-20
  breaths a minute that drifts slowly, an amplitude that swells and
  fades, baseline wander and sensor noise, each row scaled to unit
  variance;
- `audio`: speech-like 24 kHz clips: a voiced tone of 80-300 Hz with
  harmonics and vibrato under a syllable-rate envelope, plus breath
  noise, peak 0.5-0.9.
"""

from __future__ import annotations

import math
import typing as tp

import torch


def device_generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def _conv_weight_key(node: dict) -> tp.Optional[str]:
    for key in ("w", "v", "w_orig"):
        t = node.get(key)
        if isinstance(t, torch.Tensor) and t.dim() >= 3:
            return key
    return None


def _plan(node, out: list) -> None:
    """(tensor, bound, offset) for every leaf drawn uniformly, in tree
    order."""
    if isinstance(node, dict):
        if "scale" in node and "bias" in node:
            out += [(node["scale"], 0.1, 1.0), (node["bias"], 0.1, 0.0)]
            return
        wkey = _conv_weight_key(node)
        if wkey is not None:
            w = node[wkey]
            bound = 1.0 / math.sqrt(w[0].numel())
            out.append((w, bound, 0.0))
            if isinstance(node.get("b"), torch.Tensor):
                out.append((node["b"], bound, 0.0))
            for key in ("u_sn", "v_sn"):
                if key in node:
                    out.append((node[key], 1.0, 0.0))
            if "norm" in node:
                _plan(node["norm"], out)
            return
        if "w_hh" in node:
            bound = 1.0 / math.sqrt(node["w_hh"].shape[1])
            for key in ("w_ih", "w_hh", "b_ih", "b_hh"):
                out.append((node[key], bound, 0.0))
            return
        for key in sorted(node):
            _plan(node[key], out)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _plan(v, out)


def _finish(node) -> None:
    """Weight norm's g from v; spectral norm's vectors normalized."""
    if isinstance(node, dict):
        if isinstance(node.get("v"), torch.Tensor) and "g" in node:
            v = node["v"]
            node["g"].copy_(torch.linalg.vector_norm(v.flatten(1), dim=1))
        for key in ("u_sn", "v_sn"):
            if key in node:
                node[key].div_(torch.linalg.vector_norm(node[key]))
        for key in sorted(node):
            _finish(node[key])
    elif isinstance(node, (list, tuple)):
        for v in node:
            _finish(v)


def fill_weights(tree, generator: torch.Generator) -> None:
    """Draw every weight of `tree` (tensors on the generator's device) in
    place."""
    leaves = []
    _plan(tree, leaves)
    total = sum(t.numel() for t, _, _ in leaves)
    flat = torch.rand(total, generator=generator,
                      device=generator.device).mul_(2.0).sub_(1.0)
    at = 0
    with torch.no_grad():
        for t, bound, offset in leaves:
            n = t.numel()
            t.copy_(flat[at:at + n].view_as(t)).mul_(bound).add_(offset)
            at += n
        _finish(tree)


def _u(generator: torch.Generator, rows: int, lo: float, hi: float
       ) -> torch.Tensor:
    r = torch.rand(rows, 1, generator=generator, device=generator.device)
    return lo + (hi - lo) * r


def breathing(generator: torch.Generator, rows: int, length: int,
              sample_rate: float) -> torch.Tensor:
    """`[rows, length]` respiration belts (see the module's docstring)."""
    dev = generator.device
    t = torch.arange(length, device=dev, dtype=torch.float32)[None] \
        / sample_rate
    rate = _u(generator, rows, 10.0, 20.0) / 60.0
    drift = _u(generator, rows, 0.05, 0.2) * rate
    p1 = _u(generator, rows, 600.0, 3600.0)
    ph = _u(generator, rows, 0.0, 2 * math.pi)
    freq = rate + drift * torch.sin(2 * math.pi * t / p1 + ph)
    phase = 2 * math.pi * torch.cumsum(freq, dim=1) / sample_rate
    p2 = _u(generator, rows, 60.0, 600.0)
    amp = 1.0 + 0.4 * torch.sin(2 * math.pi * t / p2 + 2 * ph)
    wander = 0.3 * torch.sin(2 * math.pi * t / (3 * p1) + 3 * ph)
    noise = 0.1 * torch.randn(rows, length, generator=generator, device=dev)
    x = amp * torch.sin(phase + ph) + wander + noise
    x = x - x.mean(1, keepdim=True)
    return x / x.std(1, keepdim=True)


def audio(generator: torch.Generator, rows: int, length: int,
          sample_rate: float) -> torch.Tensor:
    """`[rows, length]` speech-like clips (see the module's docstring)."""
    dev = generator.device
    t = torch.arange(length, device=dev, dtype=torch.float32)[None] \
        / sample_rate
    f0 = _u(generator, rows, 80.0, 300.0)
    vib = 1.0 + 0.03 * torch.sin(2 * math.pi * _u(generator, rows, 4, 7) * t)
    phase = 2 * math.pi * torch.cumsum(f0 * vib, dim=1) / sample_rate
    voiced = sum(torch.sin(k * phase) / k for k in range(1, 6))
    syl = _u(generator, rows, 3.0, 6.0)
    env = torch.relu(torch.sin(2 * math.pi * syl * t
                               + _u(generator, rows, 0, 2 * math.pi)))
    noise = torch.randn(rows, length, generator=generator, device=dev)
    x = env * voiced + 0.05 * noise
    peak = _u(generator, rows, 0.5, 0.9)
    return x * peak / x.abs().amax(1, keepdim=True)
