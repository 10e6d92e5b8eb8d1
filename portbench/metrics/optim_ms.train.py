"""Stream ms per training iteration of the optimizer: the program's
`optim.adam` span (`train/optim.py::adam_update`: the global norm, the
clip and Adam over every leaf), from the CUDA events at its entry and
exit, the device's idle inside it included (`lib/program_spans.py`)."""

from portbench.lib import program_spans


def read(m):
    if m.kind != "train":
        return None
    return program_spans.stream_ms(m, ("optim.adam",))
