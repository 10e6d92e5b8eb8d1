"""The whole training step's share of the card's FP32 peak, in %: the
model FLOPs of the traced window's calls (`counts/steps.py`: convs, LSTM,
the RVQ's searches and the spectral loss's STFTs, forward and backward,
nothing recomputed counted) over the window's seconds × 67 TFLOP/s."""

from portbench.counts import kernels, steps


def read(m):
    if m.kind != "train" or not m.work:
        return None
    flops = sum(steps.call_flops(m.arch, m.config, m.traffic, c)
                for c in m.work)
    return 100.0 * flops / (m.trace.window_s * kernels.FP32_PEAK)
