from repro_torch.core.cost import (
    CostModel, GNNWorkload, LayoutState, Replication, workload_for,
)
from repro_torch.core.engine import PairCutEngine, round_robin_rounds
from repro_torch.core.glad_s import GladResult, glad_s, solve_pair
from repro_torch.core.glad_e import glad_e
from repro_torch.core.glad_a import GladA, drift_bound
from repro_torch.core.baselines import (
    greedy_layout, random_layout, uploading_first_layout,
)
from repro_torch.core.evolution import (
    GraphDelta, apply_delta, changed_vertices, evolution_trace, sample_delta,
)
from repro_torch.core.partition import (
    DevicePartition, data_partition, expert_layout, halos_of,
    partition_from_assign, rebalance,
)

__all__ = [
    "CostModel", "GNNWorkload", "LayoutState", "Replication", "workload_for",
    "PairCutEngine", "round_robin_rounds",
    "GladResult", "glad_s", "solve_pair", "glad_e", "GladA", "drift_bound",
    "greedy_layout", "random_layout", "uploading_first_layout",
    "GraphDelta", "apply_delta", "changed_vertices", "evolution_trace",
    "sample_delta",
    "DevicePartition", "data_partition", "expert_layout", "halos_of",
    "partition_from_assign", "rebalance",
]
