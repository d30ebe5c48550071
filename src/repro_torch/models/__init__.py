"""The LM stack of the port (``repro/models``): configuration, every block
family, prefill and KV-cache / recurrent-state decode.  The training entry
points (``make_loss_fn``, ``make_train_step``) wait for the training path
(ROADMAP Queue 1, item 9)."""
from .common import ExecConfig  # noqa: F401
from .config import SHAPES, ModelConfig, ShapeSpec, cell_is_runnable  # noqa: F401
from .model import (LM, decode_step, forward_hidden, init_caches,  # noqa: F401
                    init_params, n_units, prefill_logits, unit_kinds)
from .steps import make_decode_step, make_prefill_step  # noqa: F401
from .weights import from_reference  # noqa: F401
