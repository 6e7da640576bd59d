from repro_torch.train.optim import (
    OptConfig, OptState, apply_updates, for_model, init_opt_state,
)
from repro_torch.train.step import init_error_feedback, make_train_step
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import DataConfig, batch_at_step, stream

# ``jit_train_step`` and ``opt_state_specs`` are GSPMD sharding; they come
# with launch/'s mesh work (ROADMAP.md).
__all__ = [
    "OptConfig", "OptState", "apply_updates", "for_model", "init_opt_state",
    "init_error_feedback", "make_train_step", "CheckpointManager",
    "DataConfig", "batch_at_step", "stream",
]
