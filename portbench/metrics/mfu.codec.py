"""A codec batch's share of the card's FP32 peak, in %: the model FLOPs of
the traced batches (`counts/steps.py`: convs, LSTM and the RVQ's searches
of encode and decode) over the window's seconds × 67 TFLOP/s."""

from portbench.counts import kernels, steps


def read(m):
    if m.kind != "codec_batch" or not m.work:
        return None
    flops = sum(steps.call_flops(m.arch, m.config, m.traffic, c)
                for c in m.work)
    return 100.0 * flops / (m.trace.window_s * kernels.FP32_PEAK)
