"""llama3.2-1b [dense] — 16L d2048 32H (GQA kv=8) dff8192 v128256.
[hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=128_256, rope_theta=500_000.0, tie_embeddings=True,
    remat=False, train_microbatches=16,
)

SMOKE = LMConfig(
    name="llama3.2-1b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab=512, tie_embeddings=True, remat=False,
)
