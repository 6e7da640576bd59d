"""The paper's OWN workload: 2-layer GCN/GAT/GraphSAGE over SIoT/Yelp
(Sec. VI-A — input dims 52/100, hidden 16, binary output)."""
from repro_torch.gnn.models import GNNConfig

SIOT_GCN = GNNConfig("gcn", (52, 16, 2))
SIOT_GAT = GNNConfig("gat", (52, 16, 2))
SIOT_SAGE = GNNConfig("sage", (52, 16, 2))
YELP_GCN = GNNConfig("gcn", (100, 16, 2))
YELP_GAT = GNNConfig("gat", (100, 16, 2))
YELP_SAGE = GNNConfig("sage", (100, 16, 2))

ALL = {
    ("siot", "gcn"): SIOT_GCN, ("siot", "gat"): SIOT_GAT,
    ("siot", "sage"): SIOT_SAGE,
    ("yelp", "gcn"): YELP_GCN, ("yelp", "gat"): YELP_GAT,
    ("yelp", "sage"): YELP_SAGE,
}
