from .manager import CheckpointManager, restore_lsm, save_lsm
