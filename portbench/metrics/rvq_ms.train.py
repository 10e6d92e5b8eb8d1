"""Stream ms per training iteration of the training RVQ: the program's
`rvq.train` span (`quant/rvq.py`: each stage's K1 search, EMA update and
expiry draw), from the CUDA events at its entry and exit, the device's
idle inside it included (`lib/program_spans.py`)."""

from portbench.lib import program_spans


def read(m):
    if m.kind != "train":
        return None
    return program_spans.stream_ms(m, ("rvq.train",))
