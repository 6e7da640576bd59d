"""Port attention vs the JAX reference: K2's plain version against the
Pallas kernel (interpret mode) over the reference's cases, the model-side
full and chunked attention, the fully masked row, and the CPU dispatch.
The CUDA kernel itself runs only on the card: ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold it against ``flash_attention_plain`` there."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.ref import attention_ref as j_attention_ref  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.ref import attention_ref  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402

# The reference's own cases and tolerances (tests/test_kernels.py).
CASES = [
    # B, Hq, Hkv, Lq, Lk, D, causal, kv_len, dtype
    (2, 4, 2, 128, 128, 64, True, None, "float32"),
    (1, 8, 8, 192, 192, 64, True, None, "float32"),
    (2, 4, 1, 100, 100, 32, True, None, "float32"),
    (1, 4, 2, 1, 256, 64, True, [190], "float32"),
    (2, 2, 2, 64, 64, 16, False, None, "float32"),
    (1, 4, 4, 96, 160, 64, True, None, "float32"),
    (2, 4, 2, 64, 64, 64, True, None, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, B, Hq, Hkv, Lq, Lk, D, layout="bhld"):
    rng = np.random.default_rng(seed)
    if layout == "bhld":
        shapes = (B, Hq, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D)
    else:
        shapes = (B, Lq, Hq, D), (B, Lk, Hkv, D), (B, Lk, Hkv, D)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _pair(arrs, dtype):
    """The same values as JAX arrays and torch tensors (bf16 rounds to
    nearest even in both)."""
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal,kv_len,dtype", CASES)
def test_flash_plain_matches_pallas_kernel(B, Hq, Hkv, Lq, Lk, D, causal,
                                           kv_len, dtype):
    (jq, jk, jv), (tq, tk, tv) = _pair(
        _inputs(B * 100 + Lq, B, Hq, Hkv, Lq, Lk, D), dtype)
    jkl = jnp.asarray(kv_len, jnp.int32) if kv_len else None
    tkl = torch.tensor(kv_len, dtype=torch.int32) if kv_len else None
    ref = j_flash(jq, jk, jv, jkl, causal=causal, bq=64, bkv=64,
                  interpret=True)
    out = flash_attention_plain(tq, tk, tv, tkl, causal)
    assert out.dtype == tq.dtype and out.shape == (B, Hq, Lq, D)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_fully_masked_row_gives_zero():
    """kv_len = 0 masks every key of batch row 0: the kernel's clamped
    denominator gives 0 there (the repeat-then-softmax oracle gives NaN);
    row 1 still matches the Pallas kernel."""
    (jq, jk, jv), (tq, tk, tv) = _pair(_inputs(7, 2, 4, 2, 3, 40, 32),
                                       "float32")
    kl = [0, 17]
    out = flash_attention_plain(tq, tk, tv, torch.tensor(kl, dtype=torch.int32),
                                causal=False)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    ref = j_flash(jq, jk, jv, jnp.asarray(kl, jnp.int32), causal=False,
                  bq=8, bkv=8, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    oracle = attention_ref(tq, tk, tv, causal=False,
                           kv_len=torch.tensor(kl, dtype=torch.int32))
    assert torch.isnan(oracle[0]).all()
    np.testing.assert_allclose(oracle[1].numpy(), out[1].numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, [5, 31])])
def test_attention_ref_matches_reference_oracle(causal, kv_len):
    (jq, jk, jv), (tq, tk, tv) = _pair(_inputs(3, 2, 6, 3, 9, 31, 16),
                                       "float32")
    jkl = jnp.asarray(kv_len, jnp.int32) if kv_len else None
    tkl = torch.tensor(kv_len, dtype=torch.int32) if kv_len else None
    ref = j_attention_ref(jq, jk, jv, causal=causal, kv_len=jkl)
    out = attention_ref(tq, tk, tv, causal=causal, kv_len=tkl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# Model-side attention in the (B, L, H, D) layout.
MODEL_CASES = [
    # B, Hq, Hkv, Lq, Lk, D, causal, kv_len
    (2, 8, 2, 16, 16, 16, True, None),
    (1, 4, 4, 7, 20, 32, True, None),
    (2, 4, 2, 1, 24, 16, False, [9, 24]),
    (2, 6, 3, 5, 12, 8, False, None),
]


@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal,kv_len", MODEL_CASES)
def test_full_attention_matches_reference(B, Hq, Hkv, Lq, Lk, D, causal,
                                          kv_len):
    (jq, jk, jv), (tq, tk, tv) = _pair(
        _inputs(Lq + Lk, B, Hq, Hkv, Lq, Lk, D, "blhd"), "float32")
    jkl = jnp.asarray(kv_len, jnp.int32) if kv_len else None
    tkl = torch.tensor(kv_len, dtype=torch.int32) if kv_len else None
    ref = JC.full_attention(jq, jk, jv, causal=causal, kv_len=jkl)
    out = TC.full_attention(tq, tk, tv, causal=causal, kv_len=tkl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal,kv_len", MODEL_CASES)
@pytest.mark.parametrize("chunk", [4, 64])
def test_chunked_attention_matches_reference(B, Hq, Hkv, Lq, Lk, D, causal,
                                             kv_len, chunk):
    """chunk = 4 puts Lk past 2 * chunk, so several chunks (and a padded
    last one) run through the online softmax."""
    (jq, jk, jv), (tq, tk, tv) = _pair(
        _inputs(Lq * Lk, B, Hq, Hkv, Lq, Lk, D, "blhd"), "float32")
    jkl = jnp.asarray(kv_len, jnp.int32) if kv_len else None
    tkl = torch.tensor(kv_len, dtype=torch.int32) if kv_len else None
    ref = JC.chunked_attention(jq, jk, jv, causal=causal, chunk=chunk,
                               kv_len=jkl)
    out = TC.chunked_attention(tq, tk, tv, causal=causal, chunk=chunk,
                               kv_len=tkl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        out.numpy(), TC.full_attention(tq, tk, tv, causal=causal,
                                       kv_len=tkl).numpy(),
        rtol=1e-5, atol=1e-5)


def test_attention_any_on_cpu_takes_the_reference_choice():
    _, (tq, tk, tv) = _pair(_inputs(11, 1, 4, 2, 6, 20, 16, "blhd"),
                            "float32")
    before = flash_attention.launches
    chunked = TC.attention_any(tq, tk, tv, causal=True, chunk=4)
    assert torch.equal(chunked, TC.chunked_attention(tq, tk, tv, causal=True,
                                                     chunk=4))
    full = TC.attention_any(tq, tk, tv, causal=True, chunk=10)
    assert torch.equal(full, TC.full_attention(tq, tk, tv, causal=True))
    assert flash_attention.launches == before


def test_cpu_dispatch_takes_plain_path_and_never_launches():
    _, (tq, tk, tv) = _pair(_inputs(5, 2, 4, 2, 9, 9, 16), "float32")
    kl = torch.tensor([4, 9], dtype=torch.int32)
    before = flash_attention.launches
    plain = flash_attention_plain(tq, tk, tv, kl, True)
    assert torch.equal(flash_attention(tq, tk, tv, kl, causal=True), plain)
    assert torch.equal(ops.attention(tq, tk, tv, kl, causal=True), plain)
    assert torch.equal(ops.attention(tq, tk, tv, kl, causal=True,
                                     impl="plain"), plain)
    np.testing.assert_allclose(
        ops.attention(tq, tk, tv, kl, causal=True, impl="ref").numpy(),
        plain.numpy(), rtol=1e-5, atol=1e-5)
    assert flash_attention.launches == before
    with pytest.raises(ValueError):
        ops.attention(tq, tk, tv, causal=True, impl="kernel")
    with pytest.raises(ValueError):
        ops.attention(tq, tk, tv, causal=True, impl="pallas")
