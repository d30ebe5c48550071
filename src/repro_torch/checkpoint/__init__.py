from .store import (CheckpointManager, latest_step, restore_checkpoint,  # noqa: F401
                    save_checkpoint)
