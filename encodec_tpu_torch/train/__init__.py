"""Training the breathing tokenizer: experiment configs, checkpoints (the
JAX trainer's and the port's), the optimizer, the steps and the Trainer.

`python -m encodec_tpu_torch.train --config C --log_dir D` runs it."""

from .config import (  # noqa: F401
    ConfigNamespace,
    config_to_dict,
    load_config,
    parse_segment,
)
from .checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    CheckpointVersionError,
    load_checkpoint,
    load_checkpoint_with_fallback,
    save_checkpoint,
)
from .metrics import Metrics  # noqa: F401
from .optim import AdamState, adam_update, init_adam  # noqa: F401
from .preemption import PreemptionGuard  # noqa: F401
from .schedulers import linear_warmup_cosine, warmup_wrap  # noqa: F401
from .steps import (  # noqa: F401
    LossWeights,
    TrainState,
    create_train_state,
    make_train_steps,
)
from .trainer import Trainer, model_from_config  # noqa: F401
