"""K3's share of its roofline in a training step, in %: the least time of
the window's K3 launches from their shapes (`counts/kernels.py`: the
saving forward and the backward, 8·B·T·H² FLOPs each) over the device
time of K3's kernels in the trace (`lstm_grid`/`lstm_scan` and
`lstm_bwd`/`lstm_bwd_cluster`). Where the trace kept fewer records than
the port's counters launched, the kept records' time is scaled up by the
ratio; with no record, nothing is read."""

from portbench.counts import kernels, steps

K3 = ("lstm_grid_kernel", "lstm_scan_kernel", "lstm_bwd_kernel",
      "lstm_bwd_cluster_kernel")


def read(m):
    if m.kind != "train":
        return None
    made = sum(m.launches.get(k, 0) for k in K3)
    kept = sum(m.trace.own_records.get(k, 0) for k in K3)
    busy = m.trace.groups["k3_forward"] + m.trace.groups["k3_backward"]
    if not made or not kept or busy <= 0:
        return None
    least = sum(kernels.bound_s(w) for c in m.work
                for w in steps.k3_work(m.arch, m.traffic, c))
    return 100.0 * least / (busy * made / kept)
