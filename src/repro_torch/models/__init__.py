"""The LM stack of the port (``repro/models``): configuration, every block
family, prefill and KV-cache / recurrent-state decode, and the training
path's loss and train step."""
from .common import ExecConfig, chunked_ce_loss  # noqa: F401
from .config import SHAPES, ModelConfig, ShapeSpec, cell_is_runnable  # noqa: F401
from .model import (LM, decode_step, forward_hidden, init_caches,  # noqa: F401
                    init_params, n_units, prefill_logits, unit_kinds)
from .steps import (make_decode_step, make_loss_fn,  # noqa: F401
                    make_prefill_step, make_train_step)
from .weights import from_reference  # noqa: F401
