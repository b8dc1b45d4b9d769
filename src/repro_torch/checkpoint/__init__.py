from .store import (CheckpointManager, latest_step, restore_checkpoint,
                    restore_into, save_checkpoint, save_sharded)
