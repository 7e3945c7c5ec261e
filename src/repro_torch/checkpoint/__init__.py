from repro_torch.checkpoint.checkpoint import (CheckpointManager, load_checkpoint,  # noqa: F401
                                               save_checkpoint)
