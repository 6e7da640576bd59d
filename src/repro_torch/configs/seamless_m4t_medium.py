"""seamless-m4t-medium [audio enc-dec] — 12L enc + 12L dec, d1024 16H
(kv=16) dff4096 v256206.  Modality frontend is a STUB: input_specs provides
precomputed frame embeddings. [arXiv:2308.11596; hf]"""
from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256_206, rope_theta=10_000.0,
    frontend_dim=1024, frontend_len=1024,
)

SMOKE = LMConfig(
    name="seamless-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, remat=False, frontend_dim=32, frontend_len=12,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (DESIGN.md §4)"}
