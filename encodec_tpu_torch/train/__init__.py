"""Training-side modules that inference needs: experiment configs, reading
the JAX trainer's checkpoints, and building a model from a config."""

from .config import (  # noqa: F401
    ConfigNamespace,
    config_to_dict,
    load_config,
    parse_segment,
)
from .checkpoint import (  # noqa: F401
    CheckpointVersionError,
    load_checkpoint,
    load_checkpoint_with_fallback,
)
from .trainer import model_from_config  # noqa: F401
