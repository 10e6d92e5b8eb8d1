"""Host synchronizations per training iteration: the program's `sync.*`
counts made inside the window's root spans (`train.gen_step`, and
`train.disc_step` in a mix with discriminator calls), each a call that
made the host wait for the device (`lib/program_spans.py`)."""

from portbench.lib import program_spans


def read(m):
    if m.kind != "train":
        return None
    return program_spans.syncs(m)
