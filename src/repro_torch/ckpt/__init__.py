from repro_torch.ckpt.checkpoint import (  # noqa: F401
    CheckpointManager, restore_state, save_state,
)
