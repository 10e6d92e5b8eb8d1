"""Residual vector quantization (layer L2): inference and training, and
the DAC-style RVQ (`dac_vq`, not wired into the model)."""

from .rvq import (  # noqa: F401
    RVQConfig,
    RVQState,
    init_rvq,
    rvq_encode,
    rvq_encode_margins,
    rvq_decode,
    rvq_forward,
    rvq_intermediate_results,
    resolve_ties_f64,
    num_quantizers_for_bandwidth,
    bandwidth_per_quantizer,
)
from .dac_vq import (  # noqa: F401
    DacRVQConfig,
    dac_from_codes,
    dac_from_latents,
    dac_rvq_forward,
    dac_vq_stage,
    init_dac_rvq,
    snake,
)
