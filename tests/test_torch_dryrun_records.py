"""The port's dry-run held to the reference dry-run's own records, cell by
cell on pod16x16 and pod2x16x16 (32 cells a mesh, 8 skipped).

``REFERENCE`` pins, for every cell, the reference's record (``python -m
repro.launch.dryrun --arch A --shape S [--multi-pod]``, JAX 0.9.0 on the
CPU): FLOPs per device (``roofline.flops_per_device``, after its probe
extrapolation), ``peak_estimate_bytes``, ``argument_bytes`` and the
collective bytes by kind.  ``PORT`` pins the port's (``python -m
repro_torch.launch.dryrun --all [--multi-pod]``, torch ``PORT_TORCH`` on
the CPU).  No reference runs here.

The gate is on FLOPs per device: the port's within 10% of the reference's.
``EXCEPTIONS`` lists the cells where the reference's count is not the
function's products, each with its cause; there the port's FLOPs are held
within 10% of :func:`analytic_flops`, the matrix products of the cell at
the port's layout written out from the config (independent of the
dry-run's counter), and the reference's count must really be off (more
than 10%), or the cell leaves the list.  Peak and collective bytes are not
gated: ``PERF.md`` section 6 sets them beside the reference's.

Five cells run live in tier-1 (two subprocesses): qwen2.5-32b
``prefill_32k``, llama3.2-1b ``decode_32k``, zamba2-1.2b ``long_500k``,
xlstm-1.3b ``decode_32k`` and seamless-m4t-medium ``train_4k``: each ok,
its argument bytes the reference's, its FLOPs the pinned ones."""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import all_cells, frames_len  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import SHAPES  # noqa: E402

MESHES = {"pod16x16": 16, "pod2x16x16": 32}     # batch shards a mesh
MODEL = 16                                      # the model axis of both
TOL = 0.10
LIVE = [("qwen2.5-32b", "prefill_32k"), ("llama3.2-1b", "decode_32k"),
        ("zamba2-1.2b", "long_500k"), ("xlstm-1.3b", "decode_32k"),
        ("seamless-m4t-medium", "train_4k")]

_DECODE = ("XLA's cost analysis counts elementwise ops, about 14 per "
           "cached element a layer (the cache update, the casts and the "
           "masks over the cache; llama3.2-1b 0.242 GFLOP a layer over "
           "16.8 M cached elements, phi3-mini 1.43 over 100 M): at one "
           "token a row they rival the products, which are all the "
           "dry-run counts")
EXCEPTIONS = {
    # Every decode cell but kimi's, whose expert products dwarf the
    # elementwise ops (the port within 3% of the reference there).
    **{(a, s, m): _DECODE for a, s, skip in all_cells() if not skip
       and SHAPES[s].kind == "decode" and a != "kimi-k2-1t-a32b"
       for m in MESHES},
    **{("qwen2.5-32b", "prefill_32k", m):
       "an undercount: the reference's HLO attends 5 of the 40 heads a "
       "device (f32[2,1024,163840] products), at least 352 TFLOP of "
       "attention alone, above its whole record of 269.9" for m in MESHES},
    ("llama3.2-1b", "train_4k", "pod2x16x16"):
        "the reference counts its probes at microbatches=1 "
        "(repro/launch/dryrun.py measure_probe), 8 rows a device; its "
        "program runs 16 microbatches of 16 rows, which 32 batch shards "
        "split by padding, one row a device each: 16 rows, as the port's",
    **{("zamba2-1.2b", "train_4k", m):
       "the reference's forward runs the shared block under lax.cond in "
       "every scanned (and rematerialised) layer, and XLA's cost analysis "
       "counts the branch in all 38 layers, not the 6 sites: 32 extra "
       "sites x 4 passes is the gap, and its prefill, without the cond, "
       "agrees within 8%" for m in MESHES},
}


def _vocab_padded(cfg) -> int:
    return -(-cfg.vocab // 256) * 256


def _attn_proj(cfg) -> float:
    """q, k, v and o products a token, every projection split over
    ``model``."""
    d, hd = cfg.d_model, cfg.hd
    return (2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
            + 2 * cfg.n_heads * hd * d) / MODEL


def _ffn(d: int, dff: int) -> float:
    return 6 * d * dff / MODEL


def _rows(cfg, shape, shards: int) -> int:
    """Batch rows a device runs: a train step's microbatches split over
    the batch axes when they divide its rows, else over 'data' alone
    (16), as ``train.step.microbatch_dist`` lays them."""
    B = shape.global_batch
    if shape.kind != "train":
        return B // shards if B % shards == 0 else max(1, B // 16)
    M = cfg.train_microbatches or shape.microbatches
    per = B // M
    return M * (per // shards if per % shards == 0 else per // 16)


def analytic_flops(arch: str, shape_name: str, mesh: str) -> float:
    """The cell's matrix products per device at the port's layout, from the
    config: every projection split over ``model`` (router and the
    replicated w_if and sLSTM recurrence whole), attention over every key
    of the plain path's chunks at the heads a device attends (qwen's
    head groups: 1/gcd(heads, 16)), decode over the cache a device holds,
    a train step three passes (four with remat, less the unembedding)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    d, hd, H, L = cfg.d_model, cfg.hd, cfg.n_heads, shape.seq_len
    decode = shape.kind == "decode"
    long_ctx = decode and shape.global_batch < 16
    rows = _rows(cfg, shape, MESHES[mesh])
    tokens = rows * (1 if decode else L)
    out = 2 * d * _vocab_padded(cfg) / MODEL * (
        tokens if shape.kind == "train" else rows)
    attn = 4 * hd * H * L / (MODEL * (16 if long_ctx else 1))
    per_tok = per_row = 0.0
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        n_dense = cfg.first_dense_layers if cfg.n_experts else cfg.n_layers
        n_moe = cfg.n_layers - n_dense
        per_tok += cfg.n_layers * _attn_proj(cfg) + n_dense * _ffn(d,
                                                                   cfg.d_ff)
        if n_moe:
            E, f = cfg.n_experts, cfg.expert_d_ff
            T = rows * (1 if decode else L)       # tokens a data shard
            C = moe.capacity(cfg, T)
            per_tok += n_moe * _ffn(d, cfg.n_shared_experts * f)
            per_row += n_moe * (2 * d * E * T
                                + E // MODEL * C * 6 * d * f) / rows
        if decode:
            per_tok += cfg.n_layers * attn
        else:
            groups = math.gcd(H, MODEL)
            per_row += cfg.n_layers * 4 * hd * (H / groups) * L * L
    elif fam == "hybrid":
        din, N, Pd = cfg.ssm_expand * d, cfg.ssm_state, cfg.ssm_head_dim
        heads = din // Pd / MODEL
        mamba = (2 * d * (2 * din + 2 * N + din // Pd) + 2 * din * d) / MODEL
        mamba += heads * (4 * N * Pd if decode
                          else 2 * 128 * (N + Pd) + 4 * N * Pd)
        sites = sum(1 for i in range(cfg.n_layers)
                    if (i + 1) % cfg.attn_every == 0)
        site = 4 * d * d / MODEL + _attn_proj(cfg) + _ffn(d, cfg.d_ff)
        per_tok += cfg.n_layers * mamba + sites * site
        if decode:
            per_tok += sites * attn
        else:
            per_row += sites * 4 * hd * (H / MODEL) * L * L
        if shape.kind == "train":           # remat: the Mamba layers again
            return (3 * (per_tok * tokens + per_row * rows + out)
                    + cfg.n_layers * mamba * tokens)
    elif fam == "ssm":
        din, Hm = cfg.ssm_expand * d, cfg.n_heads
        P, Ps = din // Hm, d // Hm
        n_s = sum(1 for i in range(cfg.n_layers)
                  if (i + 1) % cfg.slstm_every == 0)
        mlstm = (2 * d * 2 * din + 6 * din * din + 2 * din * d) / MODEL \
            + 4 * din * Hm
        slstm = (8 * d * d + 2 * d * d) / MODEL + 8 * Hm * Ps * Ps
        if decode:
            mlstm += 2 * Hm * P * P / MODEL + 2 * Hm * P
        else:                  # the chunk products split, the v scan too
            mlstm += 2 * 128 * din / MODEL + Hm * (
                2 * 128 * P / MODEL + 4 * P * P / MODEL + 2 * 128 + 4 * P)
        per_tok += (cfg.n_layers - n_s) * mlstm + n_s * slstm
        if shape.kind == "train":
            return 3 * (per_tok * tokens + out) + per_tok * tokens
    elif fam == "encdec":
        Fr = frames_len(cfg, shape)
        dec = _attn_proj(cfg) + 4 * d * H * hd / MODEL + _ffn(d, cfg.d_ff)
        per_tok += cfg.n_layers * dec
        if decode:
            per_tok += cfg.n_layers * (attn + 4 * hd * H * Fr / MODEL)
        else:
            enc = _attn_proj(cfg) + _ffn(d, cfg.d_ff)
            per_row += cfg.n_enc_layers * (
                enc * Fr + 4 * hd * (H / MODEL) * Fr * Fr)
            per_row += Fr * 2 * cfg.frontend_dim * d / MODEL
            per_row += cfg.n_layers * Fr * 4 * d * cfg.n_kv_heads * hd / MODEL
            per_row += cfg.n_layers * 4 * hd * (H / MODEL) * L * (L + Fr)
    total = per_tok * tokens + per_row * rows + out
    if shape.kind == "train":
        return total * 4 - out if cfg.remat else total * 3
    return total


REFERENCE = {
    ("deepseek-moe-16b", "decode_32k", "pod16x16"): (153760535680.0, 16069738584, 5811917344,
        {"all-gather": 3507939840.0, "all-reduce": 10199040.0, "collective-permute": 869760.0}),
    ("deepseek-moe-16b", "decode_32k", "pod2x16x16"): (138348267008.0, 9392173000, 3932869136,
        {"all-gather": 3508053248.0, "all-reduce": 5099520.0, "collective-permute": 436672.0}),
    ("deepseek-moe-16b", "prefill_32k", "pod16x16"): (63535120646144.0, 7030700368, 2054082560,
        {"all-gather": 10801643520.0, "all-reduce": 83550535680.0, "collective-permute": 7125073920.0}),
    ("deepseek-moe-16b", "prefill_32k", "pod2x16x16"): (31784692744192.0, 4769957840, 2053951488,
        {"all-gather": 10776477696.0, "all-reduce": 41775267840.0, "collective-permute": 3562536960.0}),
    ("deepseek-moe-16b", "train_4k", "pod16x16"): (149347640541184.0, 9949003680, 919476228,
        {"all-gather": 18142801920.0, "all-reduce": 280594940370.0, "all-to-all": 5343805440.0, "collective-permute": 14252802048.0, "reduce-scatter": 3503554560.0}),
    ("deepseek-moe-16b", "train_4k", "pod2x16x16"): (74677788082176.0, 5926207584, 919214084,
        {"all-gather": 18344128512.0, "all-reduce": 140888307938.5, "all-to-all": 2671902720.0, "collective-permute": 7127728128.0, "reduce-scatter": 3503554560.0}),
    ("internvl2-2b", "decode_32k", "pod16x16"): (15833254016.0, 6279131272, 1847005728,
        {"all-gather": 26747904.0, "all-reduce": 10269696.0, "all-to-all": 49152.0, "collective-permute": 2015232.0}),
    ("internvl2-2b", "decode_32k", "pod2x16x16"): (8253672192.0, 3376580472, 1041699344,
        {"all-gather": 25981440.0, "all-reduce": 5134848.0, "all-to-all": 24576.0, "collective-permute": 1007616.0}),
    ("internvl2-2b", "prefill_32k", "pod16x16"): (40446469079040.0, 2810080920, 237965312,
        {"all-gather": 32864222208.0, "all-reduce": 48720142080.0, "all-to-all": 80314368.0, "collective-permute": 16637755392.0}),
    ("internvl2-2b", "prefill_32k", "pod2x16x16"): (20237542752256.0, 1739014488, 237309952,
        {"all-gather": 16345603584.0, "all-reduce": 24360071040.0, "all-to-all": 40157184.0, "collective-permute": 8318877696.0}),
    ("internvl2-2b", "train_4k", "pod16x16"): (75522708078592.0, 6489374136, 233709572,
        {"all-gather": 4390305792.0, "all-reduce": 183655726215.0, "all-to-all": 14118027264.0, "collective-permute": 35508977664.0}),
    ("internvl2-2b", "train_4k", "pod2x16x16"): (37763528785920.0, 3491878456, 229253124,
        {"all-gather": 2628698112.0, "all-reduce": 92301172359.5, "all-to-all": 7059013632.0, "collective-permute": 17754488832.0}),
    ("kimi-k2-1t-a32b", "decode_32k", "pod16x16"): (8395969425920.0, 42830055032, 11766387232,
        {"all-gather": 237897513344.0, "all-reduce": 117220864.0, "all-to-all": 109312.0, "collective-permute": 1522432.0}),
    ("kimi-k2-1t-a32b", "decode_32k", "pod2x16x16"): (8358667483776.0, 25864307680, 5957475856,
        {"all-gather": 245818454208.0, "all-reduce": 58610432.0, "all-to-all": 54656.0, "collective-permute": 761216.0}),
    ("kimi-k2-1t-a32b", "prefill_32k", "pod16x16"): (607557412454400.0, 40730719512, 8184713216,
        {"all-gather": 268199362560.0, "all-reduce": 589257768960.0, "all-to-all": 1761607680.0, "collective-permute": 0.0}),
    ("kimi-k2-1t-a32b", "prefill_32k", "pod2x16x16"): (303940599545856.0, 23130446936, 4166638592,
        {"all-gather": 308543324160.0, "all-reduce": 294628884480.0, "all-to-all": 880803840.0, "collective-permute": 0.0}),
    ("kimi-k2-1t-a32b", "train_4k", "pod16x16"): (1602146994749440.0, 77662743168, 16369426524,
        {"all-gather": 432613253120.0, "all-reduce": 2151849856353.5, "all-to-all": 11368660992.0, "collective-permute": 25962872832.0, "reduce-scatter": 237817036800.0}),
    ("kimi-k2-1t-a32b", "train_4k", "pod2x16x16"): (811272798994432.0, 43437269560, 8333277276,
        {"all-gather": 443221159936.0, "all-reduce": 1080279826026.75, "all-to-all": 5684330496.0, "collective-permute": 13086347264.0, "reduce-scatter": 245744271360.0}),
    ("llama3.2-1b", "decode_32k", "pod16x16"): (7252364096.0, 2306370440, 691474976,
        {"all-gather": 9402368.0, "all-reduce": 7000064.0, "all-to-all": 16384.0, "collective-permute": 1327104.0}),
    ("llama3.2-1b", "decode_32k", "pod2x16x16"): (3846409664.0, 1324795128, 423039504,
        {"all-gather": 8911872.0, "all-reduce": 3500032.0, "all-to-all": 8192.0, "collective-permute": 663552.0}),
    ("llama3.2-1b", "prefill_32k", "pod16x16"): (26339381608448.0, 2313785560, 154865664,
        {"all-gather": 0.0, "all-reduce": 26172456960.0, "all-to-all": 251658240.0, "collective-permute": 7230980096.0}),
    ("llama3.2-1b", "prefill_32k", "pod2x16x16"): (13187239378944.0, 1367167544, 154734592,
        {"all-gather": 0.0, "all-reduce": 13086228480.0, "all-to-all": 125829120.0, "collective-permute": 3615490048.0}),
    ("llama3.2-1b", "train_4k", "pod16x16"): (38730694918144.0, 13083046296, 243949572,
        {"all-gather": 764936192.0, "all-reduce": 99891264624.5, "all-to-all": 8321499136.0, "collective-permute": 11005853696.0}),
    ("llama3.2-1b", "train_4k", "pod2x16x16"): (19366623051776.0, 13082784416, 243687428,
        {"all-gather": 496500736.0, "all-reduce": 50320506481.0, "all-to-all": 4160749568.0, "collective-permute": 5502926848.0}),
    ("phi3-mini-3.8b", "decode_32k", "pod16x16"): (56085240064.0, 24181180144, 6920608288,
        {"all-gather": 6051840.0, "all-reduce": 11796480.0, "collective-permute": 2621440.0}),
    ("phi3-mini-3.8b", "decode_32k", "pod2x16x16"): (28822542976.0, 12604724704, 3699382800,
        {"all-gather": 6204416.0, "all-reduce": 5898240.0, "collective-permute": 1312768.0}),
    ("phi3-mini-3.8b", "prefill_32k", "pod16x16"): (84276596441088.0, 5858015976, 478418944,
        {"all-gather": 754974720.0, "all-reduce": 96636764160.0, "collective-permute": 21474836480.0}),
    ("phi3-mini-3.8b", "prefill_32k", "pod2x16x16"): (42173715447808.0, 3618515752, 478287872,
        {"all-gather": 377487360.0, "all-reduce": 48318382080.0, "collective-permute": 10737418240.0}),
    ("phi3-mini-3.8b", "train_4k", "pod16x16"): (147306242375680.0, 10406383272, 251752452,
        {"all-gather": 2476892160.0, "all-reduce": 341533186687.5, "all-to-all": 16106127360.0, "collective-permute": 42949672960.0}),
    ("phi3-mini-3.8b", "train_4k", "pod2x16x16"): (73656843108352.0, 5443690216, 251490308,
        {"all-gather": 2099404800.0, "all-reduce": 171722907008.0, "all-to-all": 8053063680.0, "collective-permute": 21474836480.0}),
    ("qwen2.5-32b", "decode_32k", "pod16x16"): (95360644352.0, 26989223848, 8391690784,
        {"all-gather": 77608960.0, "all-reduce": 59289600.0, "all-to-all": 786432.0, "collective-permute": 18481152.0}),
    ("qwen2.5-32b", "decode_32k", "pod2x16x16"): (54483129600.0, 19389012888, 6244207120,
        {"all-gather": 72424448.0, "all-reduce": 29644800.0, "all-to-all": 393216.0, "collective-permute": 9240576.0}),
    ("qwen2.5-32b", "prefill_32k", "pod16x16"): (269898485858304.0, 17900183672, 4096985088,
        {"all-gather": 0.0, "all-reduce": 5671370096640.0, "all-to-all": 12683575296.0, "collective-permute": 124352724992.0}),
    ("qwen2.5-32b", "prefill_32k", "pod2x16x16"): (135026041159680.0, 15328925240, 4096854016,
        {"all-gather": 0.0, "all-reduce": 2835685048320.0, "all-to-all": 6341787648.0, "collective-permute": 62176362496.0}),
    ("qwen2.5-32b", "train_4k", "pod16x16"): (1083714142470144.0, 36775820048, 2091978756,
        {"all-gather": 48280657920.0, "all-reduce": 2176521264790.0, "all-to-all": 128043712512.0, "collective-permute": 309237645312.0}),
    ("qwen2.5-32b", "train_4k", "pod2x16x16"): (541875880591360.0, 20417477456, 2091716612,
        {"all-gather": 31545384960.0, "all-reduce": 1096454078358.5, "all-to-all": 64021856256.0, "collective-permute": 154618822656.0}),
    ("seamless-m4t-medium", "decode_32k", "pod16x16"): (6886630912.0, 3253268528, 924462112,
        {"all-gather": 791040.0, "all-reduce": 2211840.0, "collective-permute": 491520.0}),
    ("seamless-m4t-medium", "decode_32k", "pod2x16x16"): (3506036096.0, 1736758176, 509226000,
        {"all-gather": 801024.0, "all-reduce": 1105920.0, "collective-permute": 246528.0}),
    ("seamless-m4t-medium", "prefill_32k", "pod16x16"): (10003640090624.0, 1812754376, 139522048,
        {"all-gather": 255590400.0, "all-reduce": 19629342720.0, "collective-permute": 4529848320.0}),
    ("seamless-m4t-medium", "prefill_32k", "pod2x16x16"): (5008444620800.0, 971092648, 131002368,
        {"all-gather": 129761280.0, "all-reduce": 9814671360.0, "collective-permute": 2264924160.0}),
    ("seamless-m4t-medium", "train_4k", "pod16x16"): (21165342982144.0, 5085147648, 265965572,
        {"all-gather": 529428480.0, "all-reduce": 74951623965.0, "all-to-all": 3774873600.0, "collective-permute": 10066329600.0}),
    ("seamless-m4t-medium", "train_4k", "pod2x16x16"): (10583497768960.0, 2835149696, 248926212,
        {"all-gather": 403599360.0, "all-reduce": 37720777501.5, "all-to-all": 1887436800.0, "collective-permute": 5033164800.0}),
    ("xlstm-1.3b", "decode_32k", "pod16x16"): (6409794368.0, 2390508536, 843967008,
        {"all-gather": 7007616.0, "all-reduce": 5146416.0, "all-to-all": 265334784.0, "collective-permute": 356040704.0}),
    ("xlstm-1.3b", "decode_32k", "pod2x16x16"): (3913194016.0, 1861332264, 667585040,
        {"all-gather": 3503808.0, "all-reduce": 2573208.0, "all-to-all": 132667392.0, "collective-permute": 178020352.0}),
    ("xlstm-1.3b", "long_500k", "pod16x16"): (1691409800.0, 1389573520, 535298056,
        {"all-gather": 34900656.0, "all-reduce": 821862.0, "all-to-all": 136704.0, "collective-permute": 11520000.0}),
    ("xlstm-1.3b", "long_500k", "pod2x16x16"): (1673967824.0, 1389573736, 535298056,
        {"all-gather": 34944560.0, "all-reduce": 830694.0, "all-to-all": 136704.0, "collective-permute": 11493888.0}),
    ("xlstm-1.3b", "prefill_32k", "pod16x16"): (30794867408896.0, 5108903320, 491464704,
        {"all-gather": 0.0, "all-reduce": 79562145792.0, "all-to-all": 0.0, "collective-permute": 0.0}),
    ("xlstm-1.3b", "prefill_32k", "pod2x16x16"): (15398147325952.0, 3012858104, 491333632,
        {"all-gather": 0.0, "all-reduce": 39781072896.0, "all-to-all": 0.0, "collective-permute": 0.0}),
    ("xlstm-1.3b", "train_4k", "pod16x16"): (125304191320064.0, 5590922680, 541626372,
        {"all-gather": 168170323968.0, "all-reduce": 482059674414.0, "all-to-all": 11098423296.0, "collective-permute": 28186902528.0}),
    ("xlstm-1.3b", "train_4k", "pod2x16x16"): (62491701280768.0, 3273915096, 541364228,
        {"all-gather": 84902191104.0, "all-reduce": 208263886510.5, "all-to-all": 5549211648.0, "collective-permute": 14093623296.0}),
    ("yi-9b", "decode_32k", "pod16x16"): (35776203264.0, 8465911208, 2715034144,
        {"all-gather": 31475712.0, "all-reduce": 42651648.0, "all-to-all": 73728.0, "collective-permute": 5406720.0}),
    ("yi-9b", "decode_32k", "pod2x16x16"): (19696457600.0, 5945024152, 1909727760,
        {"all-gather": 28369920.0, "all-reduce": 21325824.0, "all-to-all": 36864.0, "collective-permute": 2703360.0}),
    ("yi-9b", "prefill_32k", "pod16x16"): (176654114095104.0, 7129293624, 1104683008,
        {"all-gather": 0.0, "all-reduce": 170120970240.0, "all-to-all": 1182793728.0, "collective-permute": 32329695232.0}),
    ("yi-9b", "prefill_32k", "pod2x16x16"): (88381640146944.0, 5300438008, 1104551936,
        {"all-gather": 0.0, "all-reduce": 85060485120.0, "all-to-all": 591396864.0, "collective-permute": 16164847616.0}),
    ("yi-9b", "train_4k", "pod16x16"): (326022991970304.0, 20797231680, 603471876,
        {"all-gather": 12510658560.0, "all-reduce": 687445506175.5, "all-to-all": 34275852288.0, "collective-permute": 89590333440.0}),
    ("yi-9b", "train_4k", "pod2x16x16"): (163018228891648.0, 10998780608, 603209732,
        {"all-gather": 8383463424.0, "all-reduce": 345931594880.0, "all-to-all": 17137926144.0, "collective-permute": 44795166720.0}),
    ("zamba2-1.2b", "decode_32k", "pod16x16"): (4761478576.0, 2891006944, 973220864,
        {"all-gather": 8352000.0, "all-reduce": 6145440.0, "collective-permute": 2743552.0}),
    ("zamba2-1.2b", "decode_32k", "pod2x16x16"): (2614561744.0, 1656304464, 560365424,
        {"all-gather": 4575360.0, "all-reduce": 3072720.0, "collective-permute": 1372160.0}),
    ("zamba2-1.2b", "long_500k", "pod16x16"): (889158704.0, 700225416, 250723336,
        {"all-gather": 673920.0, "all-reduce": 611220.0, "collective-permute": 374880.0}),
    ("zamba2-1.2b", "long_500k", "pod2x16x16"): (882724256.0, 700226016, 250723336,
        {"all-gather": 674528.0, "all-reduce": 617310.0, "collective-permute": 365056.0}),
    ("zamba2-1.2b", "prefill_32k", "pod16x16"): (20387690872832.0, 3614231792, 147771616,
        {"all-gather": 19818178560.0, "all-reduce": 52734197760.0, "all-to-all": 4930928640.0, "collective-permute": 22475177984.0}),
    ("zamba2-1.2b", "prefill_32k", "pod2x16x16"): (10200557944832.0, 1974071280, 147640544,
        {"all-gather": 9909089280.0, "all-reduce": 26367098880.0, "all-to-all": 2465464320.0, "collective-permute": 11237588992.0}),
    ("zamba2-1.2b", "train_4k", "pod16x16"): (151761660674048.0, 4578785832, 103511364,
        {"all-gather": 427515002880.0, "all-reduce": 471626341140.0, "all-to-all": 48487464960.0, "collective-permute": 96666124288.0}),
    ("zamba2-1.2b", "train_4k", "pod2x16x16"): (75884194693120.0, 2406585960, 103249220,
        {"all-gather": 214926704640.0, "all-reduce": 236806236898.5, "all-to-all": 24243732480.0, "collective-permute": 48333062144.0}),
}
PORT_TORCH = '2.13.0+cpu'
PORT = {
    ("deepseek-moe-16b", "decode_32k", "pod16x16"): (124616572928.0, 5991289408, 5811917344,
        {"all-gather": 668006400.0, "all-reduce": 5122200.0}),
    ("deepseek-moe-16b", "prefill_32k", "pod16x16"): (62437065752576.0, 12734370408, 2054082560,
        {"all-gather": 919633920.0, "all-reduce": 41854907040.0}),
    ("deepseek-moe-16b", "train_4k", "pod16x16"): (145690659389440.0, 17728667664, 919476228,
        {"all-gather": 104327331840.0, "all-reduce": 113507483595.0, "reduce-scatter": 20216094720.0}),
    ("internvl2-2b", "decode_32k", "pod16x16"): (4920967168.0, 2049628768, 1847005728,
        {"all-gather": 1535416320.0, "all-reduce": 2949120.0}),
    ("internvl2-2b", "prefill_32k", "pod16x16"): (39891837911040.0, 3207485448, 237965312,
        {"all-gather": 7850557440.0, "all-reduce": 24347934720.0}),
    ("internvl2-2b", "train_4k", "pod16x16"): (71547175829504.0, 15309633548, 233709572,
        {"all-gather": 97593262080.0, "all-reduce": 79921766512.5, "reduce-scatter": 12919111680.0}),
    ("kimi-k2-1t-a32b", "decode_32k", "pod16x16"): (8160051200000.0, 14585192648, 11766387232,
        {"all-gather": 124558705920.0, "all-reduce": 39338880.0}),
    ("kimi-k2-1t-a32b", "prefill_32k", "pod16x16"): (598815371427840.0, 54099172936, 8184713216,
        {"all-gather": 138649835520.0, "all-reduce": 320848700160.0}),
    ("kimi-k2-1t-a32b", "train_4k", "pod16x16"): (1594214550863872.0, 64442157152, 16369426524,
        {"all-gather": 2116703846400.0, "all-reduce": 889653688455.0, "reduce-scatter": 992795934720.0}),
    ("llama3.2-1b", "decode_32k", "pod16x16"): (3383230464.0, 861566560, 691474976,
        {"all-gather": 1023590400.0, "all-reduce": 2027520.0}),
    ("llama3.2-1b", "prefill_32k", "pod16x16"): (25563711012864.0, 3542036488, 154865664,
        {"all-gather": 3019898880.0, "all-reduce": 16609443840.0}),
    ("llama3.2-1b", "train_4k", "pod16x16"): (36966783516672.0, 15156446220, 243949572,
        {"all-gather": 116682915840.0, "all-reduce": 46235320702.5, "reduce-scatter": 33849016320.0}),
    ("phi3-mini-3.8b", "decode_32k", "pod16x16"): (10165420032.0, 7330198632, 6920608288,
        {"all-gather": 3019944960.0, "all-reduce": 5898240.0}),
    ("phi3-mini-3.8b", "prefill_32k", "pod16x16"): (82463396855808.0, 5769533440, 478418944,
        {"all-gather": 3397386240.0, "all-reduce": 48318382080.0}),
    ("phi3-mini-3.8b", "train_4k", "pod16x16"): (140973711556608.0, 8565696524, 251752452,
        {"all-gather": 75786977280.0, "all-reduce": 125524070512.5, "reduce-scatter": 26140508160.0}),
    ("qwen2.5-32b", "decode_32k", "pod16x16"): (53459025920.0, 9524316736, 8391690784,
        {"all-gather": 34140564480.0, "all-reduce": 19660800.0}),
    ("qwen2.5-32b", "prefill_32k", "pod16x16"): (607480368988160.0, 13908781064, 4096985088,
        {"all-gather": 90974453760.0, "all-reduce": 161061273600.0}),
    ("qwen2.5-32b", "train_4k", "pod16x16"): (1143384718704640.0, 35641210892, 2091978756,
        {"all-gather": 810259415040.0, "all-reduce": 553387315312.5, "reduce-scatter": 284790128640.0}),
    ("seamless-m4t-medium", "decode_32k", "pod16x16"): (1319370752.0, 995282024, 924462112,
        {"all-gather": 188759040.0, "all-reduce": 1105920.0}),
    ("seamless-m4t-medium", "prefill_32k", "pod16x16"): (9613276151808.0, 2191857672, 139522048,
        {"all-gather": 519045120.0, "all-reduce": 9814671360.0}),
    ("seamless-m4t-medium", "train_4k", "pod16x16"): (19544248680448.0, 36785782796, 265965572,
        {"all-gather": 165373132800.0, "all-reduce": 29376061545.0, "reduce-scatter": 3502817280.0}),
    ("xlstm-1.3b", "decode_32k", "pod16x16"): (4003594240.0, 868411936, 843967008,
        {"all-gather": 26388480.0, "all-reduce": 2580480.0}),
    ("xlstm-1.3b", "long_500k", "pod16x16"): (500449280.0, 553033736, 535298056,
        {"all-gather": 3298560.0, "all-reduce": 322560.0}),
    ("xlstm-1.3b", "prefill_32k", "pod16x16"): (33780614692864.0, 21189617664, 491464704,
        {"all-gather": 161816248320.0, "all-reduce": 31708938240.0}),
    ("xlstm-1.3b", "train_4k", "pod16x16"): (134568304705536.0, 11315421196, 541626372,
        {"all-gather": 380574597120.0, "all-reduce": 296567162992.5, "reduce-scatter": 3209134080.0}),
    ("yi-9b", "decode_32k", "pod16x16"): (21451767808.0, 3075875392, 2715034144,
        {"all-gather": 8215572480.0, "all-reduce": 11796480.0}),
    ("yi-9b", "prefill_32k", "pod16x16"): (173585463771136.0, 5435572232, 1104683008,
        {"all-gather": 14659092480.0, "all-reduce": 96636764160.0}),
    ("yi-9b", "train_4k", "pod16x16"): (313618511953920.0, 16865095692, 603471876,
        {"all-gather": 198088458240.0, "all-reduce": 264316600432.5, "reduce-scatter": 68902256640.0}),
    ("zamba2-1.2b", "decode_32k", "pod16x16"): (2305032192.0, 1256323144, 973220864,
        {"all-gather": 391209120.0, "all-reduce": 3072000.0}),
    ("zamba2-1.2b", "long_500k", "pod16x16"): (288129024.0, 385920520, 250723336,
        {"all-gather": 380566800.0, "all-reduce": 384000.0}),
    ("zamba2-1.2b", "prefill_32k", "pod16x16"): (18753991081984.0, 3868641512, 147771616,
        {"all-gather": 41289184800.0, "all-reduce": 25165824000.0}),
    ("zamba2-1.2b", "train_4k", "pod16x16"): (46389941764096.0, 23742703372, 103511364,
        {"all-gather": 105330270720.0, "all-reduce": 133185761392.5, "reduce-scatter": 4240830720.0}),
    ("deepseek-moe-16b", "decode_32k", "pod2x16x16"): (122102284288.0, 4112208416, 3932869136,
        {"all-gather": 667991040.0, "all-reduce": 2574492.0}),
    ("deepseek-moe-16b", "prefill_32k", "pod2x16x16"): (31218532876288.0, 7398290024, 2053951488,
        {"all-gather": 793804800.0, "all-reduce": 20927466912.0}),
    ("deepseek-moe-16b", "train_4k", "pod2x16x16"): (72845329694720.0, 9490602000, 919214084,
        {"all-gather": 72618655744.0, "all-reduce": 58900341739.0, "reduce-scatter": 20215603200.0}),
    ("internvl2-2b", "decode_32k", "pod2x16x16"): (2460483584.0, 1175949856, 1041699344,
        {"all-gather": 1522682880.0, "all-reduce": 1474560.0}),
    ("internvl2-2b", "prefill_32k", "pod2x16x16"): (19945918955520.0, 1743341572, 237309952,
        {"all-gather": 4680253440.0, "all-reduce": 12173967360.0}),
    ("internvl2-2b", "train_4k", "pod2x16x16"): (35773587914752.0, 7817102348, 229253124,
        {"all-gather": 62452072448.0, "all-reduce": 41953468560.5, "reduce-scatter": 12918620160.0}),
    ("kimi-k2-1t-a32b", "decode_32k", "pod2x16x16"): (8138769694720.0, 9480809320, 5957475856,
        {"all-gather": 128465683072.0, "all-reduce": 19848000.0}),
    ("kimi-k2-1t-a32b", "prefill_32k", "pod2x16x16"): (299407685713920.0, 28184504904, 4166638592,
        {"all-gather": 135511247872.0, "all-reduce": 160424528640.0}),
    ("kimi-k2-1t-a32b", "train_4k", "pod2x16x16"): (797107275431936.0, 32522794080, 8333277276,
        {"all-gather": 2116750196736.0, "all-reduce": 2370932095179.0, "reduce-scatter": 544910704640.0}),
    ("llama3.2-1b", "decode_32k", "pod2x16x16"): (1691615232.0, 557290016, 423039504,
        {"all-gather": 1015111680.0, "all-reduce": 1013760.0}),
    ("llama3.2-1b", "prefill_32k", "pod2x16x16"): (12781855506432.0, 1867329540, 154734592,
        {"all-gather": 2013265920.0, "all-reduce": 8304721920.0}),
    ("llama3.2-1b", "train_4k", "pod2x16x16"): (36966783516672.0, 15156184076, 243687428,
        {"all-gather": 116683177984.0, "all-reduce": 46235320702.5, "reduce-scatter": 33849016320.0}),
    ("phi3-mini-3.8b", "decode_32k", "pod2x16x16"): (5082710016.0, 3904309048, 3699382800,
        {"all-gather": 3019921920.0, "all-reduce": 2949120.0}),
    ("phi3-mini-3.8b", "prefill_32k", "pod2x16x16"): (41231698427904.0, 3126990848, 478287872,
        {"all-gather": 3208642560.0, "all-reduce": 24159191040.0}),
    ("phi3-mini-3.8b", "train_4k", "pod2x16x16"): (70486855778304.0, 4456923148, 251490308,
        {"all-gather": 65500708864.0, "all-reduce": 66215792784.5, "reduce-scatter": 26140016640.0}),
    ("qwen2.5-32b", "decode_32k", "pod2x16x16"): (26729512960.0, 7376751136, 6244207120,
        {"all-gather": 34057213440.0, "all-reduce": 9830400.0}),
    ("qwen2.5-32b", "prefill_32k", "pod2x16x16"): (303740184494080.0, 9023858692, 4096854016,
        {"all-gather": 62474158080.0, "all-reduce": 80530636800.0}),
    ("qwen2.5-32b", "train_4k", "pod2x16x16"): (571692359352320.0, 19264098316, 2091716612,
        {"all-gather": 706545025024.0, "all-reduce": 314206277776.5, "reduce-scatter": 284789637120.0}),
    ("seamless-m4t-medium", "decode_32k", "pod2x16x16"): (659685376.0, 544767032, 509226000,
        {"all-gather": 188751360.0, "all-reduce": 552960.0}),
    ("seamless-m4t-medium", "prefill_32k", "pod2x16x16"): (4806638075904.0, 1159402500, 131002368,
        {"all-gather": 448266240.0, "all-reduce": 4907335680.0}),
    ("seamless-m4t-medium", "train_4k", "pod2x16x16"): (9772124340224.0, 18564212748, 248926212,
        {"all-gather": 86526771200.0, "all-reduce": 15623594121.0, "reduce-scatter": 3502325760.0}),
    ("xlstm-1.3b", "decode_32k", "pod2x16x16"): (2001797120.0, 813763088, 667585040,
        {"all-gather": 13194240.0, "all-reduce": 1290240.0}),
    ("xlstm-1.3b", "long_500k", "pod2x16x16"): (500449280.0, 553033736, 535298056,
        {"all-gather": 3298560.0, "all-reduce": 322560.0}),
    ("xlstm-1.3b", "prefill_32k", "pod2x16x16"): (16890307346432.0, 10840418304, 491333632,
        {"all-gather": 80908124160.0, "all-reduce": 15854469120.0}),
    ("xlstm-1.3b", "train_4k", "pod2x16x16"): (67284152352768.0, 6024902668, 541364228,
        {"all-gather": 193451229184.0, "all-reduce": 149503068304.5, "reduce-scatter": 3208642560.0}),
    ("yi-9b", "decode_32k", "pod2x16x16"): (10725883904.0, 2270503456, 1909727760,
        {"all-gather": 8165775360.0, "all-reduce": 5898240.0}),
    ("yi-9b", "prefill_32k", "pod2x16x16"): (86792731885568.0, 3291103236, 1104551936,
        {"all-gather": 11387535360.0, "all-reduce": 48318382080.0}),
    ("yi-9b", "train_4k", "pod2x16x16"): (156809255976960.0, 8851425292, 603209732,
        {"all-gather": 171884806144.0, "all-reduce": 141335888016.5, "reduce-scatter": 68901765120.0}),
    ("zamba2-1.2b", "decode_32k", "pod2x16x16"): (1152516096.0, 710199168, 560365424,
        {"all-gather": 385100640.0, "all-reduce": 1536000.0}),
    ("zamba2-1.2b", "long_500k", "pod2x16x16"): (288129024.0, 385920520, 250723336,
        {"all-gather": 380566800.0, "all-reduce": 384000.0}),
    ("zamba2-1.2b", "prefill_32k", "pod2x16x16"): (9376995540992.0, 2027085028, 147640544,
        {"all-gather": 20834088480.0, "all-reduce": 12582912000.0}),
    ("zamba2-1.2b", "train_4k", "pod2x16x16"): (23194970882048.0, 11972706060, 103249220,
        {"all-gather": 55344914944.0, "all-reduce": 67219531920.5, "reduce-scatter": 4240339200.0}),
}


def _ids(cell):
    return "-".join(cell)


def test_every_cell_is_pinned():
    want = {(a, s, m) for a, s, skip in all_cells() if not skip
            for m in MESHES}
    assert len(want) == 64
    assert set(REFERENCE) == set(PORT) == want
    assert set(EXCEPTIONS) <= want


@pytest.mark.parametrize("cell", sorted(REFERENCE), ids=_ids)
def test_flops_match_reference_or_analytic(cell):
    """The port's FLOPs per device within 10% of the reference's, or of
    the analytic count where the reference's is listed in EXCEPTIONS;
    the argument bytes equal the reference's in every cell."""
    port_flops, _, port_args, _ = PORT[cell]
    ref_flops, _, ref_args, _ = REFERENCE[cell]
    assert port_args == ref_args
    want = analytic_flops(*cell) if cell in EXCEPTIONS else ref_flops
    assert abs(port_flops - want) <= TOL * want, (port_flops, want)


@pytest.mark.parametrize("cell", sorted(EXCEPTIONS), ids=_ids)
def test_exceptions_are_off_the_reference(cell):
    """A cell stays an exception only while the reference's count is more
    than 10% from the port's."""
    assert abs(PORT[cell][0] - REFERENCE[cell][0]) > TOL * REFERENCE[cell][0]


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """The port's dry-run of the LIVE cells on pod16x16, in two
    subprocesses (qwen's prefill alone, the rest together)."""
    out = tmp_path_factory.mktemp("dryrun-records")
    env = dict(os.environ)
    env["PYTHONPATH"] = "src" + os.pathsep + env.get("PYTHONPATH", "")
    groups = [LIVE[:1], LIVE[1:]]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells",
         ",".join(f"{a}:{s}" for a, s in cells), "--out", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for cells in groups]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), [log[-3000:]
                                                   for log in logs]
    recs = {}
    for arch, shape in LIVE:
        with open(out / "pod16x16" / f"{arch}__{shape}.json") as f:
            recs[(arch, shape, "pod16x16")] = json.load(f)
    return recs


@pytest.mark.parametrize("cell", LIVE, ids=_ids)
def test_live_cell_matches_pins(live, cell):
    """The cell runs here as pinned: ok, the reference's argument bytes,
    the pinned FLOPs (exactly under the pinned torch), and so within the
    gate of the reference's or the analytic count."""
    rec = live[cell + ("pod16x16",)]
    key = cell + ("pod16x16",)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["memory"]["argument_bytes"] == REFERENCE[key][2]
    flops = rec["roofline"]["flops_per_device"]
    rel = 0.0 if rec["torch"] == PORT_TORCH else 0.02
    assert abs(flops - PORT[key][0]) <= rel * PORT[key][0], (flops,
                                                             PORT[key][0])
    want = analytic_flops(*key) if key in EXCEPTIONS else REFERENCE[key][0]
    assert abs(flops - want) <= TOL * want


def test_qwen_attention_is_split_over_head_groups(live):
    """qwen2.5-32b's 40 heads on a 16-way ``model``: a device attends one
    of gcd(40, 16) = 8 head groups, so its attention is 1/8 of the whole
    (a layout that attends all 40 on every device counts 3,070.4 TFLOP a
    device)."""
    cfg = get_config("qwen2.5-32b")
    flops = live[("qwen2.5-32b", "prefill_32k", "pod16x16")][
        "roofline"]["flops_per_device"]
    L, rows = 32_768, 2
    whole = cfg.n_layers * rows * 4 * cfg.hd * cfg.n_heads * L * L
    attn = flops - (analytic_flops("qwen2.5-32b", "prefill_32k",
                                   "pod16x16") - whole / 8)
    assert attn <= whole / 8 * 1.001
    assert flops < 3_070.4e12 / 4
