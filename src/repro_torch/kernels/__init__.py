from repro_torch.kernels.gnn_aggregate import (
    PackedBSR, build_bsr, bsr_density, pack_bsr, spmm, spmm_packed,
    spmm_packed_plain, spmm_plain, transpose_packed,
)
from repro_torch.kernels.ops import BSRAggregate, aggregate_features, attention

# ``flash_attention`` and ``flash_attention_plain`` stay in their module
# (``repro_torch.kernels.flash_attention``): a package attribute of the same
# name would shadow the submodule.
__all__ = ["BSRAggregate", "PackedBSR", "aggregate_features", "attention",
           "build_bsr", "bsr_density", "pack_bsr", "spmm", "spmm_packed",
           "spmm_packed_plain", "spmm_plain", "transpose_packed"]
