"""K2's two vector kernels, mirrored on the CPU: the split-key decode
(:func:`flash_decode_split_plain`, per-split partials combined in split
order) and the tensor-core prefill (:func:`flash_prefill_tiles_plain`,
64-key tiles with P rounded to v's dtype), each against the reference's
Pallas kernel in interpret mode and against :func:`flash_attention_plain`;
then the wrapper's dispatch rule.  The kernels themselves run only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    TC_HEAD_DIMS, aligned16, decode_split, flash_attention,
    flash_attention_plain, flash_decode_split_plain,
    flash_prefill_tiles_plain, kernel_path)

# The reference's tolerances (tests/test_kernels.py), rtol = atol.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
KS = 128                        # the decode split at D = 32..128 in bf16
LK = 300                        # not a multiple of KS
KV_LENS = [0, 1, KS - 1, KS, KS + 1, LK]


def _arrays(seed, B, Hq, Hkv, Lq, Lk, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Hq, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D))]


def _pair(arrs, dtype):
    """The same values as JAX arrays and torch tensors (bf16 rounds to
    nearest even in both)."""
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def _close(out, ref, dtype):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _against_both(mirror, jx, tx, kv_len, causal, dtype, bq=64, bkv=64):
    """``mirror`` (a torch result) against the Pallas kernel on the same
    values and against flash_attention_plain."""
    jkl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    tkl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    ref = j_flash(*jx, jkl, causal=causal, bq=bq, bkv=bkv, interpret=True)
    plain = flash_attention_plain(*tx, tkl, causal)
    assert mirror.dtype == tx[0].dtype and mirror.shape == tx[0].shape
    _close(mirror.float().numpy(), ref, dtype)
    _close(mirror.float().numpy(), plain.float().numpy(), dtype)
    return plain


# ------------------------------------------------------- split-key decode
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("kv_len", KV_LENS)
def test_decode_split_mirror_matches_pallas_and_plain(kv_len, group, dtype):
    """Lq = 1 against a 300-key cache, one batch row at each split edge
    (and a second at Lk): a fully masked row, one live key, the last key
    of split 0, exactly one split, one key into split 1, every key."""
    Hkv = 2
    jx, tx = _pair(_arrays(kv_len + 7 * group, 2, Hkv * group, Hkv, 1, LK,
                           32), dtype)
    tkl = torch.tensor([kv_len, LK], dtype=torch.int32)
    out = flash_decode_split_plain(*tx, tkl, split=KS, causal=False)
    _against_both(out, jx, tx, [kv_len, LK], False, dtype, bq=8, bkv=128)
    if kv_len == 0:
        assert torch.equal(out[0], torch.zeros_like(out[0]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lq,group,kv_len", [(2, 4, [250]), (4, 4, [129]),
                                             (16, 1, [300]), (3, 2, [5])])
def test_decode_split_mirror_causal_rows(Lq, group, kv_len, dtype):
    """Lq > 1 on the decode path (Lq * group <= 16): each row's own causal
    limit inside the splits."""
    Hkv = 2
    jx, tx = _pair(_arrays(Lq * group, 1, Hkv * group, Hkv, Lq, LK, 64),
                   dtype)
    out = flash_decode_split_plain(*tx, torch.tensor(kv_len,
                                                     dtype=torch.int32),
                                   split=KS, causal=True)
    _against_both(out, jx, tx, kv_len, True, dtype, bq=16, bkv=128)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000))
def test_decode_split_mirror_property(seed):
    """Random kv_len, split lengths, groups and Lq: the split order changes
    the sum's rounding only."""
    rng = np.random.default_rng(seed)
    split = int(rng.choice([8, 16, 32, 64, 128]))
    group = int(rng.choice([1, 2, 4]))
    Lq = int(rng.integers(1, 16 // group + 1))
    Lk = int(rng.integers(Lq, 200))
    B, Hkv, D = 3, int(rng.integers(1, 3)), int(rng.choice([16, 32, 64]))
    causal = bool(rng.integers(0, 2))
    kv_len = [int(x) for x in rng.integers(0, Lk + 1, size=B)]
    jx, tx = _pair(_arrays(seed, B, Hkv * group, Hkv, Lq, Lk, D), "float32")
    out = flash_decode_split_plain(*tx, torch.tensor(kv_len,
                                                     dtype=torch.int32),
                                   split=split, causal=causal)
    _against_both(out, jx, tx, kv_len, causal, "float32", bq=16, bkv=32)


# --------------------------------------------------- tensor-core prefill
PREFILL_CASES = [
    # B, Hkv, group, Lq, Lk, D, causal, kv_len
    (1, 2, 4, 100, 100, 64, True, None),       # ragged Lq
    (1, 2, 2, 96, 160, 64, True, None),        # Lq < Lk, bottom-right
    (2, 1, 4, 64, 200, 32, False, [37, 200]),  # kv_len, Lq > 1
    (2, 2, 1, 70, 70, 96, True, [64, 65]),     # kv_len on a tile edge
    (1, 1, 4, 40, 130, 128, True, [0]),        # fully masked rows
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hkv,group,Lq,Lk,D,causal,kv_len", PREFILL_CASES)
def test_prefill_tile_mirror_matches_pallas_and_plain(B, Hkv, group, Lq, Lk,
                                                      D, causal, kv_len,
                                                      dtype):
    jx, tx = _pair(_arrays(Lq + Lk + D, B, Hkv * group, Hkv, Lq, Lk, D),
                   dtype)
    tkl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    out = flash_prefill_tiles_plain(*tx, tkl, causal)
    _against_both(out, jx, tx, kv_len, causal, dtype)
    if kv_len == [0]:
        assert torch.equal(out, torch.zeros_like(out))
    if dtype == "float32":
        # Rounding p to v's dtype is a no-op in fp32.
        torch.testing.assert_close(out, flash_attention_plain(*tx, tkl,
                                                              causal),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("scale", [0.0, -0.3, 2.0])
@pytest.mark.parametrize("mirror", ["prefill", "decode"])
def test_mirrors_take_any_scale(mirror, scale):
    """The scores are scaled before the running max, so a zero or
    negative scale gives the reference's softmax too (scale 0: the mean
    of the live values)."""
    Lq = 40 if mirror == "prefill" else 1
    jx, tx = _pair(_arrays(11, 2, 8, 2, Lq, 130, 32), "float32")
    kv_len = [0, 97]
    tkl = torch.tensor(kv_len, dtype=torch.int32)
    if mirror == "prefill":
        out = flash_prefill_tiles_plain(*tx, tkl, True, scale)
    else:
        out = flash_decode_split_plain(*tx, tkl, KS, True, scale)
    ref = j_flash(*jx, jnp.asarray(kv_len, jnp.int32), causal=True,
                  scale=scale, bq=64, bkv=64, interpret=True)
    _close(out.numpy(), ref, "float32")
    _close(out.numpy(), flash_attention_plain(*tx, tkl, True, scale).numpy(),
           "float32")
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    if scale == 0.0 and mirror == "decode":
        mean = tx[2][1, :, :97].mean(1)                  # (Hkv, D)
        _close(out[1, :, 0].numpy(),
               mean.repeat_interleave(4, 0).numpy(), "float32")


def test_prefill_tile_mirror_rounds_p_like_the_reference_chunks():
    """In bf16, the per-tile rounding of p moves the result by a few bf16
    ulps at most, inside the reference's 2e-2."""
    _, tx = _pair(_arrays(3, 1, 8, 2, 128, 128, 64), "bfloat16")
    out = flash_prefill_tiles_plain(*tx, None, True)
    plain = flash_attention_plain(*tx, None, True)
    diff = (out.float() - plain.float()).abs().max().item()
    assert 0 < diff <= 2e-2


# ------------------------------------------------------------- dispatch
@pytest.mark.parametrize("dtype,Hq,Hkv,Lq,D,path", [
    (torch.bfloat16, 32, 8, 1, 64, "decode"),        # llama decode
    (torch.float32, 32, 8, 1, 64, "decode"),         # lm_parity decode
    (torch.bfloat16, 4, 1, 4, 128, "decode"),        # 16 rows
    (torch.bfloat16, 4, 1, 5, 128, "prefill_tc"),    # 20 rows
    (torch.bfloat16, 32, 8, 1024, 64, "prefill_tc"),  # llama prefill
    (torch.bfloat16, 32, 32, 512, 96, "prefill_tc"),  # phi3
    (torch.bfloat16, 40, 8, 512, 128, "prefill_tc"),  # qwen2.5
    (torch.float32, 32, 8, 1024, 64, "general"),     # fp32 prefill
    (torch.bfloat16, 8, 2, 64, 256, "general"),      # D outside the templates
    (torch.bfloat16, 8, 2, 1, 100, "general"),       # rows not 16-byte whole
    (torch.float32, 8, 2, 1, 30, "general"),
])
def test_kernel_path_rule(dtype, Hq, Hkv, Lq, D, path):
    assert kernel_path(dtype, Hq, Hkv, Lq, D) == path


@pytest.mark.parametrize("dtype,Hq,Hkv,Lq,D", [
    (torch.bfloat16, 32, 8, 1, 64), (torch.float32, 32, 8, 1, 64),
    (torch.bfloat16, 32, 8, 1024, 64)])
def test_kernel_path_sends_unaligned_views_to_the_general_kernel(dtype, Hq,
                                                                 Hkv, Lq, D):
    assert kernel_path(dtype, Hq, Hkv, Lq, D) != "general"
    assert kernel_path(dtype, Hq, Hkv, Lq, D, aligned=False) == "general"


def test_decode_split_depends_on_row_bytes_only():
    assert decode_split(64, torch.bfloat16) == 128
    assert decode_split(128, torch.bfloat16) == 128
    assert decode_split(64, torch.float32) == 128
    assert decode_split(128, torch.float32) == 64
    assert decode_split(256, torch.float32) == 32
    assert set(TC_HEAD_DIMS) == {32, 64, 96, 128}


def test_model_views_are_aligned_and_odd_views_are_not():
    """The model's (B, L, H, D) tensors seen as (B, H, L, D), and a
    cache layer's slice, take the vector paths without a copy; a view off
    a 16-byte boundary or with a strided last dim does not."""
    x = torch.zeros((2, 16, 8, 64), dtype=torch.bfloat16)
    assert aligned16(x.transpose(1, 2))
    cache = torch.zeros((2, 3, 64, 8, 64), dtype=torch.bfloat16)
    assert aligned16(cache[1].transpose(1, 2))
    assert not aligned16(x[..., 1:33].transpose(1, 2))
    assert not aligned16(x.transpose(1, 3))


def test_cpu_call_never_launches_or_copies():
    _, tx = _pair(_arrays(1, 2, 8, 2, 1, 40, 64), "bfloat16")
    launches = flash_attention.launches
    by_path = dict(flash_attention.launches_by_path)
    out = flash_attention(*tx, torch.tensor([3, 40], dtype=torch.int32),
                          causal=False)
    assert torch.equal(out, flash_attention_plain(
        *tx, torch.tensor([3, 40], dtype=torch.int32), False))
    assert flash_attention.launches == launches
    assert flash_attention.launches_by_path == by_path
