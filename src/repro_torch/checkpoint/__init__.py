from .store import (CheckpointManager, latest_step, restore_checkpoint,
                    save_checkpoint)
