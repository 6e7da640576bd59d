from repro_torch.configs.registry import (
    ARCHS, QUEUED, all_cells, applicable_shapes, get_config,
    get_smoke_config, input_specs, skip_reason,
)

__all__ = [
    "ARCHS", "QUEUED", "all_cells", "applicable_shapes", "get_config",
    "get_smoke_config", "input_specs", "skip_reason",
]
