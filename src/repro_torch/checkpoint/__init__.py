from repro_torch.checkpoint.store import (  # noqa: F401
    CheckpointManager, load_checkpoint, save_checkpoint,
)
