"""The frozen table that puts each device operation of a trace in a group.

The port's own kernels go by their CUDA names (`kernels/csrc/*.cu`); every
other kernel by the aten operation that launched it: convolutions (1-D or
2-D, forward or backward, told apart by the operation's 4-D operand
shapes: cuDNN runs a 1-D conv as `[B, C, 1, T]`), matrix products and
FFTs. What is left is elementwise work and reductions: the norms, the
activations, the losses, the optimizer's update, copies.
"""

from __future__ import annotations

import typing as tp

# (group, substring of the CUDA kernel's name); first match wins
OWN_KERNELS = (
    ("k3_backward", "lstm_bwd_cluster_kernel"),
    ("k3_backward", "lstm_bwd_kernel"),
    ("k3_forward", "lstm_grid_kernel"),
    ("k3_forward", "lstm_scan_kernel"),
    ("k1", "vq_nearest_rowblock_kernel"),
    ("k1", "vq_nearest_kernel"),
    ("k2", "vq_rvq_kernel"),
    ("ac", "ac_head_pull_kernel"),
)

GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
            "aten::matmul", "aten::linear", "aten::addmv", "aten::mv",
            "aten::dot")

GROUPS = ("k3_forward", "k3_backward", "k1", "k2", "ac", "conv1d_forward",
          "conv1d_backward", "conv2d_forward", "conv2d_backward", "gemm",
          "fft", "elementwise")


def own_group(kernel_name: str) -> tp.Optional[str]:
    """The group of one of the port's kernels, or None."""
    for group, key in OWN_KERNELS:
        if key in kernel_name:
            return group
    return None


def op_group(op_name: str, input_shapes) -> tp.Optional[str]:
    """The group of a kernel launched by aten operation `op_name` with
    operand shapes `input_shapes` (a profile's `record_shapes`), or None
    (elementwise)."""
    if "conv" in op_name:
        two_d = any(isinstance(sh, (list, tuple)) and len(sh) == 4
                    and sh[2] > 1 and sh[3] > 1 for sh in input_shapes or ())
        kind = "conv2d" if two_d else "conv1d"
        return f"{kind}_backward" if "backward" in op_name else \
            f"{kind}_forward"
    if op_name in GEMM_OPS:
        return "gemm"
    if "fft" in op_name:
        return "fft"
    return None
