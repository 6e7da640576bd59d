from repro_torch.kernels.gnn_aggregate import (
    build_bsr, bsr_density, spmm, spmm_plain,
)
from repro_torch.kernels.ops import BSRAggregate, aggregate_features

__all__ = ["BSRAggregate", "aggregate_features", "build_bsr", "bsr_density",
           "spmm", "spmm_plain"]
