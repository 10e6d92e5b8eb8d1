"""Network architectures and the codec model API."""

from .seanet import (  # noqa: F401
    SEANetConfig,
    init_seanet_encoder,
    init_seanet_decoder,
    seanet_encoder,
    seanet_decoder,
)
from .model import (  # noqa: F401
    EncodecConfig,
    EncodecModel,
    encodec_model_24khz,
    encodec_model_48khz,
    breathing_model,
    build_model,
    MODELS,
)
from .streaming import (  # noqa: F401
    StreamingCodec,
    min_first_chunk,
    min_first_latent_chunk,
)
from .zoo import (  # noqa: F401
    lm_params_from_jax,
    lm_params_from_state,
    load_pretrained,
    load_state,
    model_params_from_state,
    params_from_jax,
    train_state_from_jax,
)
from .lm import LMConfig, LMModel, get_lm_model, init_lm  # noqa: F401
from .ilm import IntLMModel  # noqa: F401
