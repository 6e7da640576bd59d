"""K2's backward on the CPU: ``flash_attention_bwd_plain`` (the formulas
the two backward kernels compute) against autograd of the plain forward and
against ``jax.grad`` of the reference's ``chunked_attention`` and
``full_attention`` (the reference trains attention in plain jnp; its Pallas
kernel has no backward), and the ``_FlashAttention`` Function, which on CPU
tensors routes both directions to the plain versions.  The CUDA kernels
themselves run only on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold them against ``flash_attention_bwd_plain`` there."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import common as JC  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_plain)

# B, Hq, Hkv, Lq, Lk, D, causal, kv_len: causal and not, Lq != Lk both
# ways, GQA groups 1, 4 and 8, L off the 64-row tiles, ragged kv_len.
CASES = [
    (2, 4, 2, 33, 33, 16, True, None),
    (1, 8, 8, 20, 29, 8, True, None),
    (2, 8, 2, 29, 20, 16, True, None),
    (2, 8, 1, 17, 17, 32, False, None),
    (3, 4, 1, 1, 40, 16, False, [1, 25, 40]),
    (2, 4, 4, 12, 30, 8, True, [18, 30]),
    (2, 16, 2, 70, 70, 8, True, [70, 41]),
]
TOL = 2e-5                       # fp32, another order of the same sums
# The cases in which every query row keeps a live key: the reference's
# -1e30 mask gives a fully masked row uniform weights, where K2 gives 0.
LIVE_CASES = [c for c in CASES if not (c[6] and c[3] > c[4])]


def _arrays(seed, B, Hq, Hkv, Lq, Lk, D):
    """q, k, v and an output gradient in the reference's (B, L, H, D)
    order, from numpy."""
    rng = np.random.default_rng(seed)
    shapes = ((B, Lq, Hq, D), (B, Lk, Hkv, D), (B, Lk, Hkv, D),
              (B, Lq, Hq, D))
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _bhld(a):
    return torch.from_numpy(a).transpose(1, 2)


def _assert_close(got, ref, tol=TOL):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), r, rtol=tol, atol=tol)


def _plain_bwd(q, k, v, do, kl, causal):
    """flash_attention_bwd_plain on (B, H, L, D) views of the arrays, its
    gradients back in (B, L, H, D)."""
    q, k, v, do = (_bhld(a) for a in (q, k, v, do))
    out = flash_attention_plain(q, k, v, kl, causal)
    return [g.transpose(1, 2) for g in flash_attention_bwd_plain(
        q, k, v, out, do, kl, causal)]


@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal,kv_len", CASES)
def test_bwd_plain_matches_autograd_of_plain_forward(B, Hq, Hkv, Lq, Lk, D,
                                                     causal, kv_len):
    q, k, v, do = (_bhld(a) for a in _arrays(Lq + Lk, B, Hq, Hkv, Lq, Lk,
                                              D))
    kl = torch.tensor(kv_len, dtype=torch.int32) if kv_len else None
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_plain(*leaves, kl, causal)
    ref = torch.autograd.grad(out, leaves, do)
    got = flash_attention_bwd_plain(q, k, v, out.detach(), do, kl, causal)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("which", ["full", "chunked"])
@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal,kv_len", LIVE_CASES)
def test_bwd_plain_matches_jax_grad_of_reference(which, B, Hq, Hkv, Lq, Lk,
                                                 D, causal, kv_len):
    """jax.grad of the reference's model attention, on the cases where
    every row keeps a live key."""
    q, k, v, do = _arrays(Lq + Lk, B, Hq, Hkv, Lq, Lk, D)
    jkl = jnp.asarray(kv_len, jnp.int32) if kv_len else None

    def f(q, k, v):
        if which == "full":
            out = JC.full_attention(q, k, v, causal=causal, kv_len=jkl)
        else:
            out = JC.chunked_attention(q, k, v, causal=causal, chunk=8,
                                       kv_len=jkl)
        return jnp.sum(out * jnp.asarray(do))

    ref = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (q, k, v)))
    kl = torch.tensor(kv_len, dtype=torch.int32) if kv_len else None
    _assert_close(_plain_bwd(q, k, v, do, kl, causal), ref)


@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal,kv_len", CASES)
def test_function_routes_to_the_plain_directions_on_cpu(B, Hq, Hkv, Lq, Lk,
                                                        D, causal, kv_len):
    """flash_attention under grad on CPU tensors: the gradient equals
    flash_attention_bwd_plain's bit for bit and autograd of the plain
    forward within tolerance; no kernel launch is counted."""
    q, k, v, do = (_bhld(a) for a in _arrays(Lq + Lk + 1, B, Hq, Hkv, Lq,
                                              Lk, D))
    kl = torch.tensor(kv_len, dtype=torch.int32) if kv_len else None
    launches = (flash_attention.launches,
                dict(flash_attention.backward_launches))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves, kl, causal=causal)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, do)
    assert torch.equal(out, flash_attention_plain(q, k, v, kl, causal))
    want = flash_attention_bwd_plain(q, k, v, out.detach(), do, kl, causal)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(
        flash_attention_bwd(q, k, v, out.detach(), do, kl, causal), want))
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(flash_attention_plain(*plain, kl, causal),
                              plain, do)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=TOL, atol=TOL)
    assert launches == (flash_attention.launches,
                        flash_attention.backward_launches)


@pytest.mark.parametrize("causal,kv_len,Lq,Lk", [
    (False, [0, 9], 7, 9),          # kv_len = 0: a batch row with no key
    (True, None, 12, 5),            # Lq > Lk: the first 7 rows see no key
])
def test_fully_masked_rows_get_zero_gradient(causal, kv_len, Lq, Lk):
    q, k, v, do = (_bhld(a) for a in _arrays(3, 2, 4, 2, Lq, Lk, 8))
    kl = torch.tensor(kv_len, dtype=torch.int32) if kv_len else None
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves, kl, causal=causal)
    dq, dk, dv = torch.autograd.grad(out, leaves, do)
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()
    if kv_len:
        for g in (dq, dk, dv):
            assert torch.equal(g[0], torch.zeros_like(g[0]))
    else:
        dead = Lq - Lk
        assert torch.equal(dq[:, :, :dead], torch.zeros_like(dq[:, :, :dead]))
        assert torch.equal(out[:, :, :dead],
                           torch.zeros_like(out[:, :, :dead]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_plain_keeps_each_input_dtype(dtype):
    q, k, v, do = (_bhld(a).to(dtype) for a in _arrays(5, 1, 4, 2, 9, 9, 8))
    out = flash_attention_plain(q, k, v, None, True)
    for g, t in zip(flash_attention_bwd_plain(q, k, v, out, do), (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
