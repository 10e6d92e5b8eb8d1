"""Hand-written Hopper kernels (CUDA C++, `csrc/`) and their plain twins.

| port wrapper | replaces (encodec_tpu/kernels/) | source |
| --- | --- | --- |
| `nearest_codebook` (K1) | `vq_pallas.py::nearest_codebook_pallas` | `csrc/vq_search.cu` |
| `rvq_encode_fused` (K2) | `vq_pallas.py::rvq_encode_pallas` | `csrc/vq_search.cu` |
| `lstm_scan` (K3) | `lstm_pallas.py::lstm_scan_pallas` | `csrc/lstm_scan.cu` (H ≤ 512), |
| | | `csrc/lstm_grid.cu` (512 < H ≤ 1024) |
| `lstm_scan_backward` (K3's gradient) | none (see below) | `csrc/lstm_bwd.cu` (H ≤ 1024) |
| `ac_head_pull` (the range decoder and the LM's head) | none (see below) | `csrc/ac_decode.cu` |

K3's backward has no TPU kernel to replace: the JAX trainer differentiates
the `lax.scan` of `encodec_tpu/ops/lstm.py:56-72`, and XLA runs the VJP.
Nor has the range decoder of lmv=3: JAX runs its CDF head and the
`lax.scan` of `encodec_tpu/stream/device_ac.py::ac_pull_row` inside its
fused decode scan.

Each wrapper runs its plain twin for CPU tensors and launches its kernel
for CUDA tensors (or raises); each counts its launches in `.launches`,
`nearest_codebook.rowblock_launches` counts K1's row-block route (its
second kernel, for large N),
`lstm_scan.stateful_launches` counts K3's launches from a given `(h0, c0)`,
`lstm_scan.grid_launches` those of K3's grid kernel and
`lstm_scan.save_launches` those that saved every step's c for the backward.
`ac_head_pull.launches` also counts the replays of the LM decode's CUDA
graph, one launch each.
"""

from .ac_cuda import ac_head_pull, ac_head_pull_plain  # noqa: F401
from .lstm_cuda import (  # noqa: F401
    lstm_scan,
    lstm_scan_backward,
    lstm_scan_backward_plain,
    lstm_scan_plain,
)
from .vq_cuda import (  # noqa: F401
    nearest_codebook,
    nearest_codebook_plain,
    rvq_encode_fused,
    rvq_encode_fused_plain,
)

WRAPPERS = (nearest_codebook, rvq_encode_fused, lstm_scan, lstm_scan_backward,
            ac_head_pull)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0  # type: ignore[attr-defined]
    nearest_codebook.rowblock_launches = 0  # type: ignore[attr-defined]
    lstm_scan.stateful_launches = 0  # type: ignore[attr-defined]
    lstm_scan.grid_launches = 0  # type: ignore[attr-defined]
    lstm_scan.save_launches = 0  # type: ignore[attr-defined]


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}  # type: ignore[attr-defined]
