"""Primitive ops (layer L0): padding, streamable convs, norms, LSTM, STFT.

Public functions take channels-last `[B, T, C]` tensors, like
`encodec_tpu.ops`, so each has a direct JAX counterpart.
"""

from .pad import (  # noqa: F401
    get_extra_padding_for_conv1d,
    pad1d,
    unpad1d,
)
from .conv import (  # noqa: F401
    sconv1d,
    sconv_transpose1d,
    init_sconv1d,
    init_sconv_transpose1d,
    effective_weight,
    fold_weight_norm,
    fold_weight_norm_tree,
    layer_norm,
    time_group_norm,
)
from .lstm import lstm, init_lstm, lstm_step  # noqa: F401
from .stft import hann_window, stft  # noqa: F401
