"""K2's tensor-core backward, mirrored on the CPU:
:func:`flash_bwd_tc_tiles_plain` (the dq kernel's LSE over 64-key tiles in
the log2 domain, P and dS rounded to bf16 before their products, dQ summed
over the key tiles and dK, dV over (group head, query tile) in order)
against :func:`flash_attention_bwd_plain` and against ``jax.grad`` of the
reference's ``chunked_attention`` and ``full_attention`` (the reference
trains attention in plain jnp; its Pallas kernel has no backward); then
the wrapper's :func:`backward_path` rule.  The kernels themselves run only
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import common as JC  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    TC_HEAD_DIMS, TC_TILE, aligned16, backward_path, flash_attention,
    flash_attention_bwd_plain, flash_bwd_tc_tiles_plain,
    flash_prefill_tiles_plain)

# B, Hq, Hkv, Lq, Lk, D, causal, kv_len: L off the 64-row tiles and over
# two of them, GQA groups 1, 4 and 8, Lq != Lk both ways, Lq = 1, a ragged
# kv_len and one with a 0 row.
CASES = [
    (2, 8, 2, 130, 130, 64, True, None),
    (1, 8, 8, 77, 150, 32, True, None),
    (2, 8, 1, 150, 77, 32, True, None),
    (2, 4, 4, 65, 65, 64, False, None),
    (3, 8, 2, 1, 130, 64, False, [1, 70, 130]),
    (2, 16, 2, 100, 100, 32, True, [100, 41]),
    (3, 8, 2, 70, 70, 32, False, [0, 33, 70]),
]
# The cases in which every query row keeps a live key: the reference's
# -1e30 mask gives a fully masked row uniform weights, where K2 gives 0.
LIVE_CASES = [c for c in CASES
              if not (c[6] and c[3] > c[4]) and 0 not in (c[7] or [])]
# bf16: the card's gate for K2's backward (tests/test_torch_cuda.py), 2e-2
# of max|ref|.  The mirror rounds out, P, dS and its outputs to bf16 (each
# 2^-9 relative) and sums up to 150 such terms; it reads up to 7e-3 of
# max|ref| from the plain backward and 5.3e-3 from jax.grad on these cases.
BF16_TOL = 2e-2
# fp32: the same function as the plain backward, in another order of the
# same sums (tiles), with nothing rounded.
F32_TOL = 2e-5


def _tensors(seed, B, Hq, Hkv, Lq, Lk, D):
    """q, k, v and an output gradient from numpy in the reference's (B, L,
    H, D) order, rounded to bf16, as (B, H, L, D) views."""
    rng = np.random.default_rng(seed)
    shapes = ((B, Lq, Hq, D), (B, Lk, Hkv, D), (B, Lk, Hkv, D),
              (B, Lq, Hq, D))
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        torch.bfloat16).transpose(1, 2) for s in shapes]


def _kv(kv_len):
    return torch.tensor(kv_len, dtype=torch.int32) if kv_len else None


def _assert_rel(got, ref, tol):
    for g, r in zip(got, ref):
        g, r = torch.as_tensor(g).float(), torch.as_tensor(r).float()
        assert g.shape == r.shape and torch.isfinite(g).all()
        err = float((g - r).abs().max())
        assert err <= tol * float(r.abs().max()), err


@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal,kv_len", CASES)
def test_mirror_matches_plain_backward_in_bf16(B, Hq, Hkv, Lq, Lk, D,
                                               causal, kv_len):
    """On bf16 inputs, with the tensor-core prefill's own output, the
    mirror is within the card's gate of the plain backward and keeps each
    input's dtype and shape."""
    q, k, v, do = _tensors(Lq + Lk, B, Hq, Hkv, Lq, Lk, D)
    kl = _kv(kv_len)
    out = flash_prefill_tiles_plain(q, k, v, kl, causal)
    got = flash_bwd_tc_tiles_plain(q, k, v, out, do, kl, causal)
    for g, t in zip(got, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
    _assert_rel(got, flash_attention_bwd_plain(q, k, v, out, do, kl, causal),
                BF16_TOL)


@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal,kv_len", CASES)
def test_mirror_in_fp32_is_the_plain_backward(B, Hq, Hkv, Lq, Lk, D, causal,
                                              kv_len):
    """With nothing rounded, the tiles change only the order of the sums."""
    q, k, v, do = (t.float() for t in _tensors(Lq + Lk + 1, B, Hq, Hkv, Lq,
                                               Lk, D))
    kl = _kv(kv_len)
    out = flash_prefill_tiles_plain(q, k, v, kl, causal)
    got = flash_bwd_tc_tiles_plain(q, k, v, out, do, kl, causal)
    ref = flash_attention_bwd_plain(q, k, v, out, do, kl, causal)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("which", ["full", "chunked"])
@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal,kv_len", LIVE_CASES)
def test_mirror_matches_jax_grad_of_reference(which, B, Hq, Hkv, Lq, Lk, D,
                                              causal, kv_len):
    """jax.grad of the reference's model attention in fp32 on the same
    bf16-rounded values, on the cases where every row keeps a live key."""
    q, k, v, do = _tensors(Lq + Lk, B, Hq, Hkv, Lq, Lk, D)
    kl = _kv(kv_len)
    arrs = [t.transpose(1, 2).float().numpy() for t in (q, k, v, do)]
    jkl = jnp.asarray(kv_len, jnp.int32) if kv_len else None

    def f(q, k, v):
        if which == "full":
            o = JC.full_attention(q, k, v, causal=causal, kv_len=jkl)
        else:
            o = JC.chunked_attention(q, k, v, causal=causal, chunk=16,
                                     kv_len=jkl)
        return jnp.sum(o * jnp.asarray(arrs[3]))

    ref = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in arrs[:3]))
    out = flash_prefill_tiles_plain(q, k, v, kl, causal)
    got = flash_bwd_tc_tiles_plain(q, k, v, out, do, kl, causal)
    _assert_rel([g.transpose(1, 2) for g in got],
                [np.array(r) for r in ref], BF16_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_mirror_gives_a_fully_masked_row_exactly_zero(causal):
    """kv_len = 0: the batch row has no live key, LSE = +inf, and every
    gradient of that row is exactly 0, never NaN."""
    q, k, v, do = _tensors(9, 2, 8, 2, 70, 70, 64)
    kl = _kv([0, 70])
    out = flash_prefill_tiles_plain(q, k, v, kl, causal)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    got = flash_bwd_tc_tiles_plain(q, k, v, out, do, kl, causal)
    for g in got:
        assert torch.isfinite(g).all()
        assert torch.equal(g[0], torch.zeros_like(g[0]))
        assert g[1].abs().max() > 0


# ------------------------------------------------------------- dispatch
@pytest.mark.parametrize("dtype,Hq,Hkv,Lq,D,path", [
    (torch.bfloat16, 32, 8, 1024, 64, "tc"),        # llama3.2-1b train
    (torch.bfloat16, 32, 8, 512, 64, "tc"),
    (torch.bfloat16, 32, 32, 512, 96, "tc"),        # phi3
    (torch.bfloat16, 40, 8, 512, 128, "tc"),        # qwen2.5
    (torch.bfloat16, 8, 8, 77, 32, "tc"),           # group 1
    (torch.bfloat16, 32, 8, 1, 64, "tc"),           # Lq = 1
    (torch.float32, 32, 8, 1024, 64, "general"),    # the fp32 parity pass
    (torch.float32, 8, 2, 1, 64, "general"),
    (torch.bfloat16, 8, 2, 64, 256, "general"),     # D outside the templates
    (torch.bfloat16, 8, 2, 64, 100, "general"),
    (torch.bfloat16, 8, 2, 64, 16, "general"),
])
def test_backward_path_rule(dtype, Hq, Hkv, Lq, D, path):
    assert backward_path(dtype, Hq, Hkv, Lq, D) == path
    assert backward_path(dtype, Hq, Hkv, Lq, D, aligned=False) == "general"


def test_backward_path_head_dims_are_the_prefills():
    assert TC_TILE == 64
    for D in TC_HEAD_DIMS:
        assert backward_path(torch.bfloat16, 8, 2, 64, D) == "tc"


def test_model_views_take_the_tc_backward_and_odd_views_do_not():
    """The model's (B, L, H, D) tensors seen as (B, H, L, D), and the
    gradients ``empty_like`` gives for them, keep 16-byte rows: "tc" with
    no copy.  A view off a 16-byte boundary or with a strided last dim is
    "general"."""
    x = torch.zeros((2, 16, 8, 64), dtype=torch.bfloat16)
    view = x.transpose(1, 2)
    grad = torch.empty_like(view)
    assert grad.stride() == view.stride()
    assert all(aligned16(t) for t in (view, grad))
    assert backward_path(torch.bfloat16, 8, 8, 16, 64,
                         all(aligned16(t) for t in (view, grad))) == "tc"
    for odd in (x[..., 1:33].transpose(1, 2), x.transpose(1, 3)):
        assert not aligned16(odd)
        assert backward_path(torch.bfloat16, 8, 8, 16, odd.shape[-1],
                             aligned16(odd)) == "general"


def test_cpu_backward_never_launches():
    """On CPU tensors the backward is the plain one: no launch is counted
    on either path."""
    q, k, v, do = _tensors(3, 2, 8, 2, 70, 70, 64)
    by_path = dict(flash_attention.backward_launches_by_path)
    launches = dict(flash_attention.backward_launches)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    want = flash_attention_bwd_plain(q, k, v, out.detach(), do)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert flash_attention.backward_launches_by_path == by_path
    assert flash_attention.backward_launches == launches
