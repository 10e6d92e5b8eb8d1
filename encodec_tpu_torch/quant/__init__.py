"""Residual vector quantization (layer L2): inference and training."""

from .rvq import (  # noqa: F401
    RVQConfig,
    RVQState,
    init_rvq,
    rvq_encode,
    rvq_encode_margins,
    rvq_decode,
    rvq_forward,
    resolve_ties_f64,
    num_quantizers_for_bandwidth,
    bandwidth_per_quantizer,
)
