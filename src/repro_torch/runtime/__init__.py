from repro_torch.runtime.fault import (
    DeviceHealth, ElasticCoordinator, FailureDetector, RelayoutEvent,
)

__all__ = ["DeviceHealth", "ElasticCoordinator", "FailureDetector",
           "RelayoutEvent"]
