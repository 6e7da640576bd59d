"""qwen2.5-32b [dense] — 64L d5120 40H (GQA kv=8) dff27648 v152064, QKV bias.
[hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=27_648, vocab=152_064, qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE = LMConfig(
    name="qwen2.5-32b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=256, vocab=512, qkv_bias=True, remat=False,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (DESIGN.md §4)"}
