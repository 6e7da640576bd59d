from repro_torch.configs.registry import (
    ARCHS, QUEUED, get_config, get_smoke_config,
)

__all__ = ["ARCHS", "QUEUED", "get_config", "get_smoke_config"]
