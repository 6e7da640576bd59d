from repro_torch.gnn.models import (
    GNNConfig, directed_edges, forward, init_params, loss_fn,
    params_from_jax, params_or_init, predict, segment_sum,
)
from repro_torch.gnn.plan import (
    PlanBSR, PlanCaps, PlanDelta, ShardPlan, build_plan_bsr, compile_plan,
    gather_outputs, patch_plan, plan_caps, plans_equal, recompile_like,
    scatter_features, scatter_ints, scatter_replica_halo, set_replication,
)
from repro_torch.gnn.distributed import (
    make_bsp_forward, resolve_aggregate, simulate_bsp_forward,
)
from repro_torch.gnn.ranks import (
    RankGroup, broadcast_assign, make_rank_bsp_forward, plan_digest,
)
from repro_torch.gnn.training import (
    accuracy, fit, loss_and_grads, make_distributed_train_step, sgd_step,
    train_step,
)
from repro_torch.gnn.serving import (
    EgoBatch, FeatureCache, GNNServeEngine, ServeStats, ego_tables,
    extract_ego, extract_ego_batch, link_traffic, make_ego_forward,
    replicate_for_stream, request_traffic, serving_cost, zipf_requests,
)

__all__ = [
    "GNNConfig", "directed_edges", "forward", "init_params", "loss_fn",
    "params_from_jax", "params_or_init", "predict", "segment_sum",
    "PlanBSR", "PlanCaps", "PlanDelta", "ShardPlan", "build_plan_bsr",
    "compile_plan", "gather_outputs", "make_bsp_forward", "patch_plan",
    "plan_caps", "plans_equal", "recompile_like", "resolve_aggregate",
    "scatter_features", "scatter_ints", "scatter_replica_halo",
    "set_replication", "simulate_bsp_forward",
    "RankGroup", "broadcast_assign", "make_rank_bsp_forward", "plan_digest",
    "EgoBatch", "FeatureCache", "GNNServeEngine", "ServeStats", "ego_tables",
    "extract_ego", "extract_ego_batch", "link_traffic", "make_ego_forward",
    "replicate_for_stream", "request_traffic", "serving_cost",
    "zipf_requests",
    "accuracy", "fit", "loss_and_grads", "make_distributed_train_step",
    "sgd_step", "train_step",
]
