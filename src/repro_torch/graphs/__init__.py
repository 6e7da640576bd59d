from repro_torch.graphs.datagraph import (
    DataGraph, csr_multirange, synthetic_siot, synthetic_yelp,
)
from repro_torch.graphs.edgenet import (
    EdgeNetwork, build_edge_network, pod_edge_network,
)
from repro_torch.graphs.kmeans import kmeans

__all__ = [
    "DataGraph", "csr_multirange", "synthetic_siot", "synthetic_yelp",
    "EdgeNetwork", "build_edge_network", "pod_edge_network", "kmeans",
]
