"""phi3-mini-3.8b [dense] — 32L d3072 32H (GQA kv=32 = MHA) dff8192 v32064,
RoPE SwiGLU. [arXiv:2404.14219; unverified]"""
from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32_064, rope_theta=10_000.0,
)

SMOKE = LMConfig(
    name="phi3-mini-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=512, remat=False,
)
