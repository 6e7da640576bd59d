"""deepseek-moe-16b [moe] — 28L d2048 16H (GQA kv=16) v102400; fine-grained
MoE: 64 routed experts top-6 (expert dff=1408) + 2 shared experts; first
layer is a dense FFN (dff=10944). [arXiv:2401.06066; hf]"""
from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10_944, vocab=102_400, rope_theta=10_000.0,
    n_experts=64, n_shared_experts=2, top_k=6, expert_d_ff=1408,
    first_dense_layers=1,
)

SMOKE = LMConfig(
    name="deepseek-moe-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=192, vocab=512, remat=False,
    n_experts=8, n_shared_experts=2, top_k=2, expert_d_ff=32,
    first_dense_layers=1,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (DESIGN.md §4)"}
