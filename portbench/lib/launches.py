"""The port's own launch counters, read by kernel name (`counts.names`).

`encodec_tpu_torch.kernels` counts the launches of each wrapper, and
apart those of a second kernel behind one wrapper; the difference gives
the first. A traced window's records of each kernel are held against
these counts, which also show that the timed path launched the kernels
and not their plain twins.
"""

from __future__ import annotations

import typing as tp


def counts() -> tp.Dict[str, int]:
    """Launches so far of each of the port's kernels, by kernel name."""
    from encodec_tpu_torch import kernels as k

    c = k.launch_counts()
    grid = k.lstm_scan.grid_launches
    bwd_cluster = k.lstm_scan_backward.cluster_launches
    rowblock = k.nearest_codebook.rowblock_launches
    return {"lstm_grid_kernel": grid,
            "lstm_scan_kernel": c["lstm_scan"] - grid,
            "lstm_bwd_cluster_kernel": bwd_cluster,
            "lstm_bwd_kernel": c["lstm_scan_backward"] - bwd_cluster,
            "vq_nearest_rowblock_kernel": rowblock,
            "vq_nearest_kernel": c["nearest_codebook"] - rowblock,
            "vq_rvq_kernel": c["rvq_encode_fused"],
            "ac_head_pull_kernel": c["ac_head_pull"]}


def delta(before: dict, after: dict) -> tp.Dict[str, int]:
    return {k: after[k] - before[k] for k in after}
