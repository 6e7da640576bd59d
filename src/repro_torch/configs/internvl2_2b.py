"""internvl2-2b [vlm] — InternLM2 backbone: 24L d2048 16H (GQA kv=8) dff8192
v92553; InternViT frontend is a STUB supplying patch embeddings.
[arXiv:2404.16821; hf]"""
from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92_553, rope_theta=1_000_000.0,
    frontend_dim=1024, frontend_len=256,
)

SMOKE = LMConfig(
    name="internvl2-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, remat=False, frontend_dim=32, frontend_len=8,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (DESIGN.md §4)"}
