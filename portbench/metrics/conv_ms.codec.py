"""Device ms per codec batch of the SEANet's convolutions and transposed
convolutions (`counts/names.py`: cuDNN kernels launched by a 1-D
convolution, which cuDNN runs as `[B, C, 1, T]`)."""


def read(m):
    if m.kind != "codec_batch" or not m.units:
        return None
    ms = m.trace.groups["conv1d_forward"] + m.trace.groups["conv1d_backward"]
    return 1e3 * ms / m.units if ms > 0 else None
