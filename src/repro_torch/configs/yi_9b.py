"""yi-9b [dense] — 48L d4096 32H (GQA kv=4) dff11008 v64000, llama-arch.
[arXiv:2403.04652; hf]"""
from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11_008, vocab=64_000, rope_theta=500_000.0,
)

SMOKE = LMConfig(
    name="yi-9b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=192, vocab=512, remat=False,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (DESIGN.md §4)"}
