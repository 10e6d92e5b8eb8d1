"""Host synchronizations per codec batch inside the program: the
`sync.*` counts made inside the window's root spans (`codec.encode`,
`codec.decode`), each a call that made the host wait for the device; the
harness's own synchronize that ends a batch is not the program's
(`lib/program_spans.py`)."""

from portbench.lib import program_spans


def read(m):
    if m.kind != "codec_batch":
        return None
    return program_spans.syncs(m)
