"""kimi-k2-1t-a32b [moe] — 61L d7168 64H (GQA kv=8) v163840; trillion-param
MoE: 384 routed experts top-8 (expert dff=2048) + 1 shared; first layer
dense (dff=18432).  Optimizer = lion (momentum-only); weights held in bf16.
[arXiv:2501.kimi2; unverified — paper-table config]

At 1 T parameters the full width does not fit one card; the port runs it at
its smoke width until the multi-device slice (ROADMAP.md)."""
import torch

from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=18_432, vocab=163_840, rope_theta=1_000_000.0,
    n_experts=384, n_shared_experts=1, top_k=8, expert_d_ff=2048,
    first_dense_layers=1, capacity_factor=1.5,
    optimizer="lion", param_dtype=torch.bfloat16,
    fsdp_over_pod=True, train_microbatches=8,
)

SMOKE = LMConfig(
    name="kimi-k2-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=256, vocab=512, remat=False,
    n_experts=16, n_shared_experts=1, top_k=4, expert_d_ff=16,
    first_dense_layers=1, optimizer="lion",
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (DESIGN.md §4)"}
