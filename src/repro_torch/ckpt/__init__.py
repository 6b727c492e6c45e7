from .checkpoint import CheckpointManager, CheckpointReadError  # noqa: F401
