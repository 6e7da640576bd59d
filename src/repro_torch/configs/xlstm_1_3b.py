"""xlstm-1.3b [ssm] — 48 blocks d2048 4H v50304; mLSTM backbone with one
sLSTM block every 8 (xLSTM[7:1]); d_ff=0 (block-internal projections).
The reference's mLSTM has dense din x din q/k/v projections, which
``params_count()`` leaves out: the tensors hold about 3.5 B parameters.
[arXiv:2405.04517; unverified]"""
from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50_304, ssm_expand=2, slstm_every=8,
)

SMOKE = LMConfig(
    name="xlstm-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=512, remat=False, ssm_expand=2, slstm_every=3,
)

SKIP_SHAPES = {}          # recurrent decode -> long_500k runs
