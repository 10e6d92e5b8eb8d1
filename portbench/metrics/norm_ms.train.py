"""Device ms per training iteration of elementwise work and reductions
(`counts/names.py`'s `elementwise` group: every kernel that is neither
the port's, nor a convolution, a matrix product or an FFT by the aten
operation that launched it; the SEANet's norms and ELUs, the losses,
Adam's update, copies)."""


def read(m):
    if m.kind != "train" or not m.work:
        return None
    return 1e3 * m.trace.groups["elementwise"] / m.units
