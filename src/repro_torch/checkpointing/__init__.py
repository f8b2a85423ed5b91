from repro_torch.checkpointing.checkpoint import (  # noqa: F401
    CheckpointCorruptError,
    latest_step,
    restore,
    restore_latest_valid,
    save,
    validate,
)
