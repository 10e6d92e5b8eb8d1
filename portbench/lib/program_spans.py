"""The program's own spans and counters in a traced window, for the
readers of the `program_span` and `program_counter` metrics.

The program (`encodec_tpu_torch.utils.profiling`) keeps a record of each
span opened while a `torch.profiler` is in its active phase: after a
traced run it holds the window's records and no others (the warm-up unit
runs in the profiler's warm-up phase, and nothing else in a run turns
spans on). Each record has a name, its parent's name, the stream ms
between two CUDA events at its entry and exit, and the `sync.*` counts
made inside it.

The window's records are read only where they stand for it: the root
spans of the cell's units (`ROOTS`) are as many as the window's
generator calls (training) or batches (codec), and every record has its
stream time (CUDA). Otherwise, and with a program that keeps no records,
the readers return None.
"""

from __future__ import annotations

import typing as tp

ROOTS = {"train": "train.gen_step", "codec_batch": "codec.encode"}
GEN_CALLS = ("gen", "gan_gen")


def program_records() -> list:
    """The program's finished span records, or [] for a program that
    keeps none."""
    from encodec_tpu_torch.utils import profiling

    read = getattr(profiling, "records", None)
    return [] if read is None else list(read())


def window(m) -> tp.Optional[list]:
    """The traced window's records, or None where they cannot stand for
    it (see the module's docstring)."""
    root = ROOTS.get(m.kind)
    if root is None or not m.units:
        return None
    recs = program_records()
    if not recs or any(r.stream_ms is None for r in recs):
        return None
    want = (sum(c in GEN_CALLS for c in m.work) if m.kind == "train"
            else m.units)
    roots = sum(r.parent is None and r.name == root for r in recs)
    return recs if roots == want else None


def stream_ms(m, names: tp.Iterable[str]) -> tp.Optional[float]:
    """Stream ms per unit of the spans `names`, or None."""
    recs = window(m)
    if recs is None:
        return None
    names = set(names)
    return sum(r.stream_ms for r in recs if r.name in names) / m.units


def syncs(m) -> tp.Optional[float]:
    """`sync.*` counts per unit made inside the window's root spans, or
    None."""
    recs = window(m)
    if recs is None:
        return None
    return sum(r.syncs for r in recs if r.parent is None) / m.units
