"""The optimizer of the port's training path (``repro/optim``)."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,  # noqa: F401
                    clip_by_global_norm, cosine_schedule)
from .compression import ef_int8_compress, ef_int8_decompress  # noqa: F401
