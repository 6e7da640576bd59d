from repro_torch.graphs.datagraph import (
    DataGraph, csr_multirange, synthetic_siot, synthetic_yelp,
)

__all__ = ["DataGraph", "csr_multirange", "synthetic_siot", "synthetic_yelp"]
