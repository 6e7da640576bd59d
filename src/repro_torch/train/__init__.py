from repro_torch.train.checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
