"""The serving engine's compiled step: :class:`repro_torch.step.Step`,
re-exported here, where the engine's callers found it first."""
from repro_torch.step import COUNTERS, Step

__all__ = ["COUNTERS", "Step"]
