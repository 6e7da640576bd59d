from repro_torch.core.baselines import random_layout
from repro_torch.core.partition import (
    DevicePartition, halos_of, partition_from_assign,
)

__all__ = ["random_layout", "DevicePartition", "halos_of",
           "partition_from_assign"]
