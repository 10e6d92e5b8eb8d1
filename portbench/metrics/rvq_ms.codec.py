"""Stream ms per codec batch of the RVQ: the program's `rvq.encode` (K2)
and `rvq.decode` spans (`quant/rvq.py`), from the CUDA events at their
entry and exit, the device's idle inside them included
(`lib/program_spans.py`)."""

from portbench.lib import program_spans


def read(m):
    if m.kind != "codec_batch":
        return None
    return program_spans.stream_ms(m, ("rvq.encode", "rvq.decode"))
