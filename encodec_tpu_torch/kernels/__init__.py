"""Hand-written Hopper kernels (CUDA C++, `csrc/`) and their plain twins.

| port wrapper | replaces (encodec_tpu/kernels/) | source |
| --- | --- | --- |
| `nearest_codebook` (K1) | `vq_pallas.py::nearest_codebook_pallas` | `csrc/vq_search.cu` |
| `rvq_encode_fused` (K2) | `vq_pallas.py::rvq_encode_pallas` | `csrc/vq_search.cu` |
| `lstm_scan` (K3) | `lstm_pallas.py::lstm_scan_pallas` | `csrc/lstm_scan.cu` (H ≤ 512), |
| | | `csrc/lstm_grid.cu` (512 < H ≤ 1024) |

Each wrapper runs its plain twin for CPU tensors and launches its kernel
for CUDA tensors (or raises); each counts its launches in `.launches`,
`lstm_scan.stateful_launches` counts K3's launches from a given `(h0, c0)`
and `lstm_scan.grid_launches` those of K3's grid kernel.
"""

from .lstm_cuda import lstm_scan, lstm_scan_plain  # noqa: F401
from .vq_cuda import (  # noqa: F401
    nearest_codebook,
    nearest_codebook_plain,
    rvq_encode_fused,
    rvq_encode_fused_plain,
)

WRAPPERS = (nearest_codebook, rvq_encode_fused, lstm_scan)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0  # type: ignore[attr-defined]
    lstm_scan.stateful_launches = 0  # type: ignore[attr-defined]
    lstm_scan.grid_launches = 0  # type: ignore[attr-defined]


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}  # type: ignore[attr-defined]
