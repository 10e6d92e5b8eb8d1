"""Work of one unit of a cell's traffic, from its shapes: FLOPs of a
training call or a codec batch, and the K3 launches it makes.

Training calls (`traffic.mix` names them): `gen`, the generator step
without the GAN terms; `gan_gen`, with them; `disc`, the discriminator
step. Codec: `batch`, one encode and decode of the batch.
"""

from __future__ import annotations

import math
import typing as tp

from . import kernels, msstftd, seanet


def _shapes(arch: dict, traffic: dict) -> tp.Tuple[int, int, int, int]:
    """(batch, samples, latent frames, LSTM width)."""
    batch = traffic["batch"]
    length = traffic["length"]
    _, lstm, frames = seanet.encoder_plan(arch, length)
    return batch, length, frames, lstm.units


def n_q(arch: dict, traffic: dict) -> int:
    """Stages served at the traffic's bandwidth."""
    bits = math.log2(arch["bins"]) * arch["frame_rate"]
    return int(max(1, math.floor(traffic["bandwidth_kbps"] * 1000 / bits)))


def call_flops(arch: dict, cfg: dict, traffic: dict, call: str) -> float:
    """FLOPs of one training call or codec batch (see the module)."""
    batch, length, _, _ = _shapes(arch, traffic)
    if call == "batch":
        return sum(seanet.codec_flops(arch, batch, length,
                                      n_q(arch, traffic)).values())
    model = cfg["config"]["model"]
    if call in ("gen", "gan_gen"):
        loss = cfg["config"]["loss"]
        sr = arch["sample_rate"]
        flops = (sum(seanet.train_step_flops(arch, batch, length).values())
                 + seanet.spectral_loss_flops(length, batch, loss["n_fft"],
                                              loss.get("hop_length")
                                              or 5 * sr))
        if call == "gan_gen":
            flops += msstftd.gan_gen_flops(model, batch, length)
        return flops
    if call == "disc":
        gen_fwd = sum(seanet.codec_flops(arch, batch, length,
                                         arch["n_q"]).values())
        return gen_fwd + msstftd.disc_flops(model, batch, length)
    raise ValueError(f"no count for call {call!r}")


def k3_work(arch: dict, traffic: dict, call: str) -> tp.List[dict]:
    """FLOPs and bytes of each K3 launch of one call or batch: every LSTM
    layer of the encoder and the decoder once forward (saving its c when
    the call trains the generator) and, when it does, once backward."""
    batch, _, frames, h = _shapes(arch, traffic)
    layers = 2 * arch["lstm_layers"]
    if call in ("gen", "gan_gen"):
        return layers * [kernels.k3_forward(batch, frames, h, save_c=True),
                         kernels.k3_backward(batch, frames, h)]
    if call in ("disc", "batch"):
        return layers * [kernels.k3_forward(batch, frames, h)]
    raise ValueError(f"no count for call {call!r}")
