"""zamba2-1.2b [hybrid] — 38L d2048, Mamba2 backbone + ONE shared attention
block (32H, GQA kv=32, dff8192) applied every 6 layers; ssm_state=64, v32000.
[arXiv:2411.15242; hf]"""
from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32_000,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64, attn_every=6,
)

SMOKE = LMConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, remat=False,
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=16, attn_every=2,
)

SKIP_SHAPES = {}          # hybrid: sub-quadratic decode -> long_500k runs
