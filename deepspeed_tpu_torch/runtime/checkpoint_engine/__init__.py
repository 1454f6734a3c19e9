from .checkpoint_engine import (  # noqa: F401
    AsyncCheckpointEngine,
    CheckpointEngine,
    CheckpointWriteError,
    NativeCheckpointEngine,
    get_checkpoint_engine,
)
