"""Operation counts of the SEANet codec from its shapes alone.

A frozen copy of the architecture's arithmetic (the EnCodec SEANet:
Défossez et al., arXiv:2210.13438, §3.1): every convolution with its
channels, kernel, stride and output length, and the LSTM, so that a
roofline or an MFU reading never depends on how the port computes them.
Counts are multiply-adds times two; biases, norms and activations are not
counted (they are a few operations per element against hundreds per
output of a convolution).

`arch` is the flat dict of `reference.arch.arch_from_config`.
"""

from __future__ import annotations

import math
import typing as tp


class Conv(tp.NamedTuple):
    name: str
    cin: int
    cout: int
    kernel: int
    stride: int
    dilation: int
    t_in: int
    t_out: int
    transposed: bool

    def flops(self, batch: int) -> float:
        """Forward FLOPs: 2·Cin·Cout·K per output frame (per input frame
        for a transposed conv, which scatters K taps of each input)."""
        frames = self.t_in if self.transposed else self.t_out
        return 2.0 * self.cin * self.cout * self.kernel * frames * batch


class Lstm(tp.NamedTuple):
    name: str
    units: int       # input width = hidden width H
    layers: int
    t: int

    def flops(self, batch: int) -> float:
        """Forward FLOPs of the stack: per layer the input projection and
        the recurrent product, 2·4H·(in + H) per step and row."""
        h = self.units
        return self.layers * 2.0 * 4 * h * (h + h) * self.t * batch

    def recurrent_flops(self, batch: int) -> float:
        """The recurrence alone, per layer: 8·B·T·H² (what K3 computes)."""
        return 8.0 * batch * self.t * self.units ** 2


def conv_out(t: int, kernel: int, stride: int = 1, dilation: int = 1) -> int:
    """Frames out of a streamable conv (the input padded so its last
    window is full)."""
    ek = (kernel - 1) * dilation + 1
    pad_total = ek - stride
    n_frames = (t - ek + pad_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (ek - pad_total)
    padded = t + pad_total + (ideal - t)
    return (padded - ek) // stride + 1


def _resblock(name: str, dim: int, t: int, arch: dict) -> tp.List[Conv]:
    hidden = dim // arch["compress"]
    out = []
    for j in range(arch["n_residual_layers"]):
        d = arch["dilation_base"] ** j
        k = arch["residual_kernel_size"]
        out.append(Conv(f"{name}.res{j}.conv0", dim, hidden, k, 1, d, t,
                        conv_out(t, k, 1, d), False))
        out.append(Conv(f"{name}.res{j}.conv1", hidden, dim, 1, 1, 1, t, t,
                        False))
        if not arch["true_skip"]:
            out.append(Conv(f"{name}.res{j}.shortcut", dim, dim, 1, 1, 1, t,
                            t, False))
    return out


def encoder_plan(arch: dict, length: int) -> tp.Tuple[list, Lstm, int]:
    """(convs, lstm, latent frames) of the encoder on `length` samples."""
    f = arch["n_filters"]
    t = length
    convs = [Conv("enc.init", arch["channels"], f, arch["kernel_size"], 1, 1,
                  t, conv_out(t, arch["kernel_size"]), False)]
    t = convs[-1].t_out
    mult = 1
    for i, r in enumerate(reversed(arch["ratios"])):
        dim = mult * f
        convs += _resblock(f"enc.stage{i}", dim, t, arch)
        t_out = conv_out(t, 2 * r, r)
        convs.append(Conv(f"enc.stage{i}.down", dim, 2 * dim, 2 * r, r, 1, t,
                          t_out, False))
        t = t_out
        mult *= 2
    lstm = Lstm("enc.lstm", mult * f, arch["lstm_layers"], t)
    convs.append(Conv("enc.final", mult * f, arch["dimension"],
                      arch["last_kernel_size"], 1, 1, t,
                      conv_out(t, arch["last_kernel_size"]), False))
    return convs, lstm, t


def decoder_plan(arch: dict, frames: int) -> tp.Tuple[list, Lstm]:
    """(convs, lstm) of the decoder on `frames` latent frames."""
    f = arch["n_filters"]
    mult = 2 ** len(arch["ratios"])
    t = frames
    convs = [Conv("dec.init", arch["dimension"], mult * f,
                  arch["kernel_size"], 1, 1, t,
                  conv_out(t, arch["kernel_size"]), False)]
    lstm = Lstm("dec.lstm", mult * f, arch["lstm_layers"], t)
    for i, r in enumerate(arch["ratios"]):
        dim = mult * f
        convs.append(Conv(f"dec.stage{i}.up", dim, dim // 2, 2 * r, r, 1, t,
                          t * r, True))
        t = t * r
        convs += _resblock(f"dec.stage{i}", dim // 2, t, arch)
        mult //= 2
    convs.append(Conv("dec.final", f, arch["channels"],
                      arch["last_kernel_size"], 1, 1, t,
                      conv_out(t, arch["last_kernel_size"]), False))
    return convs, lstm


def codec_flops(arch: dict, batch: int, length: int, n_q: int) -> dict:
    """Forward FLOPs of one encode and decode of `batch` × `length`
    samples at `n_q` stages, by part: convs, lstm, rvq (each stage's
    search over the book: 2·N·bins·D)."""
    enc, enc_lstm, frames = encoder_plan(arch, length)
    dec, dec_lstm = decoder_plan(arch, frames)
    n = batch * frames
    return {
        "conv": sum(c.flops(batch) for c in enc + dec),
        "lstm": enc_lstm.flops(batch) + dec_lstm.flops(batch),
        "rvq": 2.0 * n * arch["bins"] * arch["dimension"] * n_q,
    }


def train_step_flops(arch: dict, batch: int, length: int) -> dict:
    """FLOPs of one generator training step (forward, backward, nothing
    recomputed), by part. A conv's backward is its input gradient and its
    weight gradient, each as many FLOPs as its forward; the first conv
    takes no input gradient (the signal needs none). The LSTM's backward is
    twice its forward (d input and d h through both weight matrices, and
    both weight gradients). The RVQ's searches (every stage) and its EMA
    statistics (N·D each) have no backward. The spectral loss's STFTs are
    counted by `stft_flops`."""
    enc, enc_lstm, frames = encoder_plan(arch, length)
    dec, dec_lstm = decoder_plan(arch, frames)
    conv_fwd = sum(c.flops(batch) for c in enc + dec)
    conv_bwd = 2 * conv_fwd - enc[0].flops(batch)
    lstm_fwd = enc_lstm.flops(batch) + dec_lstm.flops(batch)
    n = batch * frames
    n_q = arch["n_q"]
    return {
        "conv": conv_fwd + conv_bwd,
        "lstm": 3 * lstm_fwd,
        "rvq": n_q * (2.0 * n * arch["bins"] * arch["dimension"]
                      + n * arch["dimension"]),
    }


def stft_flops(frames: int, n_fft: int, rows: int) -> float:
    """A real FFT of `n_fft` points per frame, 2.5·n·log2(n) FLOPs, over
    `rows` signals of `frames` frames."""
    return 2.5 * n_fft * math.log2(n_fft) * frames * rows


def spectral_loss_flops(length: int, batch: int, n_fft: int, hop: int
                        ) -> float:
    """The reconstruction loss's two spectrograms (signal and
    reconstruction, reflect-padded by (n_fft - hop) // 2 each side) and
    the reconstruction's backward."""
    p = (n_fft - hop) // 2
    frames = (length + 2 * p - n_fft) // hop + 1
    return 3 * stft_flops(frames, n_fft, batch)
