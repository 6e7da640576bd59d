"""Checks that need a CUDA card: the spmm_csr (K1) and flash_attention
kernels against their plain torch versions, the wrappers' input checks, and the
port's card paths (BSP forward and train step, K1's backward, LM prefill and
decode) against its CPU paths.  Without a card every test here skips.  The file
imports neither ``jax`` nor ``repro``, so it runs on a machine with the card
and the port alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import (  # noqa: E402
    CostModel, partition_from_assign, random_layout, workload_for)
from repro_torch.gnn import (  # noqa: E402
    GNNConfig, compile_plan, directed_edges, forward, init_params,
    simulate_bsp_forward)
from repro_torch.gnn import plan as TP  # noqa: E402
from repro_torch.gnn.distributed import make_bsp_forward  # noqa: E402
from repro_torch.gnn.models import segment_sum  # noqa: E402
from repro_torch.gnn.training import (  # noqa: E402
    loss_and_grads, make_distributed_train_step)
from repro_torch.graphs import (  # noqa: E402
    build_edge_network, synthetic_siot)
from repro_torch.kernels import (  # noqa: E402
    BSRAggregate, PackedBSR, build_bsr, pack_bsr, spmm, spmm_packed,
    spmm_packed_plain, spmm_plain)
from repro_torch.kernels.gnn_aggregate import transpose_packed  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain, kernel_path)
from repro_torch import models as lm  # noqa: E402
from repro_torch.models.common import attention_any  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402

pytestmark = pytest.mark.cuda


def _cost_model(g, m):
    """A cost model over an ``m``-server fleet for ``random_layout``, which
    reads the graph's and the fleet's sizes from it."""
    return CostModel(build_edge_network(g, m, seed=0), g,
                     workload_for("gcn", g.features.shape[1]))


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _bsr_case(seed, P, n, arcs, bm, bk, d):
    rng = np.random.default_rng(seed)
    vals, cols = [], []
    for _ in range(P):
        sd = rng.integers(0, n, size=(arcs, 2))
        w = rng.uniform(0.1, 2.0, size=arcs).astype(np.float32)
        v, c, _, n_src = build_bsr(sd, w, n, bm, bk)
        vals.append(v)
        cols.append(c)
    maxb = max(c.shape[1] for c in cols)
    nb = cols[0].shape[0]
    V = np.zeros((P, nb * maxb, bm, bk), np.float32)
    C = np.zeros((P, nb, maxb), np.int32)
    for p in range(P):
        mb = cols[p].shape[1]
        V[p].reshape(nb, maxb, bm, bk)[:, :mb] = vals[p].reshape(nb, mb, bm, bk)
        C[p, :, :mb] = cols[p]
    F = rng.normal(size=(P, n_src, d)).astype(np.float32)
    return [torch.from_numpy(x) for x in (V, C, F)]


def _assert_close(out, ref):
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    assert float((out - ref).abs().max()) <= 1e-5 * scale + 1e-5


@pytest.mark.parametrize("P,n,arcs,bm,bk,d", [
    (1, 250, 1000, 8, 256, 128), (4, 3000, 20000, 8, 128, 52),
    (3, 500, 3000, 16, 128, 100), (2, 300, 2000, 4, 8, 13),
    (2, 300, 2000, 64, 8, 16)])
def test_spmm_kernel_matches_plain_and_is_deterministic(dev, P, n, arcs, bm,
                                                        bk, d):
    """The dense-layout entry point: packed by pack_bsr, then K1; against
    both plain versions, bit for bit across launches, batched and not.
    bm = 64 was beyond the dense-block kernel."""
    args = [t.to(dev) for t in _bsr_case(n, P, n, arcs, bm, bk, d)]
    before = spmm.launches
    out = spmm(*args, bm, bk)
    again = spmm(*args, bm, bk)
    torch.cuda.synchronize()
    assert spmm.launches == before + 2
    assert torch.equal(out, again)
    _assert_close(out, spmm_plain(*args, bm, bk))
    _assert_close(out, spmm_packed_plain(pack_bsr(*args[:2], bm, bk), args[2]))
    unbatched = spmm(args[0][0], args[1][0], args[2][0], bm, bk)
    assert torch.equal(unbatched, out[0])


def _csr_case(dev, seed, P, n_rows, src_rows, d, lengths):
    """A packed operand with the given row lengths (cycled over rows) in
    every partition, weighted, with spare entries past the last row."""
    rng = np.random.default_rng(seed)
    counts = np.resize(np.asarray(lengths), n_rows)
    nnz = int(counts.sum())
    row_ptr = np.zeros((P, n_rows + 1), np.int32)
    row_ptr[:, 1:] = np.cumsum(counts)
    col = np.zeros((P, nnz + 7), np.int32)
    w = np.zeros((P, nnz + 7), np.float32)
    col[:, :nnz] = rng.integers(0, src_rows, size=(P, nnz))
    w[:, :nnz] = rng.uniform(0.1, 2.0, size=(P, nnz))
    packed = PackedBSR(row_ptr, col, w, src_rows, n_rows).to(dev)
    feats = torch.from_numpy(rng.normal(size=(P, src_rows, d)).astype(
        np.float32)).to(dev)
    return packed, feats


@pytest.mark.parametrize("d", [1, 16, 52, 100, 256, 300])
def test_spmm_packed_kernel_widths_hub_and_empty_rows(dev, d):
    """Every column template (d = 300 takes two 256-column tiles), a hub row
    of 300 nonzeros, empty rows and rows of every length up to 40."""
    lengths = [300, 0, 5, 0, 0, 1, 33, 64, 2, 0] + list(range(41))
    packed, feats = _csr_case(dev, d, 3, 200, 700, d, lengths)
    before = spmm.launches
    out = spmm_packed(packed, feats)
    again = spmm_packed(packed, feats)
    torch.cuda.synchronize()
    assert spmm.launches == before + 2
    assert out.shape == (3, 200, d)
    assert torch.equal(out, again)
    ref = spmm_packed_plain(packed, feats)
    _assert_close(out, ref)
    empty = (packed.row_ptr[:, 1:] == packed.row_ptr[:, :-1])
    assert bool((out[empty] == 0).all())
    unbatched = PackedBSR(packed.row_ptr[:1], packed.col[:1], packed.w[:1],
                          packed.src_rows, packed.n_rows)
    assert torch.equal(spmm_packed(unbatched, feats[0]), out[0])


def test_spmm_wrapper_rejects_what_the_kernel_does_not_take(dev):
    packed, f = _csr_case(dev, 1, 2, 64, 300, 16, [3, 0, 7])
    bad = lambda **kw: PackedBSR(**{**vars(packed), **kw})  # noqa: E731
    with pytest.raises(TypeError):
        spmm_packed(bad(col=packed.col.long()), f)
    with pytest.raises(TypeError):
        spmm_packed(bad(w=packed.w.double()), f)
    with pytest.raises(TypeError):
        spmm_packed(packed, f.double())
    with pytest.raises(ValueError):
        spmm_packed(packed, f.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        spmm_packed(bad(col=packed.col[:, ::2]), f)
    with pytest.raises(ValueError):
        spmm_packed(bad(row_ptr=packed.row_ptr.cpu()), f)
    with pytest.raises(ValueError):
        spmm_packed(bad(row_ptr=packed.row_ptr[:, :-1].contiguous()), f)
    with pytest.raises(ValueError):
        spmm_packed(packed, f[:, :100])                  # rows < src_rows
    with pytest.raises(ValueError):
        spmm_packed(packed, f[:1])                       # P mismatch
    v, c, fd = [t.to(dev) for t in _bsr_case(1, 2, 100, 300, 8, 128, 16)]
    with pytest.raises(ValueError):
        spmm(v.cpu(), c, fd, 8, 128)
    with pytest.raises(ValueError):
        spmm(v, c, fd, 16, 64)


def test_segment_sum_on_card_is_deterministic(dev):
    rng = np.random.default_rng(0)
    msgs = torch.from_numpy(rng.normal(size=(50_000, 16)).astype(np.float32))
    dst = torch.from_numpy(rng.integers(0, 3000, size=50_000))
    a = segment_sum(msgs.to(dev), dst.to(dev), 3001)
    b = segment_sum(msgs.to(dev), dst.to(dev), 3001)
    assert torch.equal(a, b)
    cpu = segment_sum(msgs, dst, 3001)
    np.testing.assert_allclose(a.cpu().numpy(), cpu.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_bsr_aggregate_kernel_matches_plain(dev):
    g = synthetic_siot(n=400, target_links=1600)
    sd = directed_edges(g.edges)
    agg = BSRAggregate(sd, g.n, device=dev)
    feats = torch.from_numpy(g.features).to(dev)
    out = agg(feats, impl="kernel")
    np.testing.assert_allclose(out.cpu().numpy(),
                               agg(feats, impl="plain").cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_bsp_forward_on_card_matches_cpu(dev, model):
    g = synthetic_siot(n=600, target_links=2500)
    plan = compile_plan(g, partition_from_assign(
        g, random_layout(_cost_model(g, 4), seed=0), 4, {}), slack=0.5)
    cfg = GNNConfig(model, (52, 16, 2))
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    cpu_params = [{k: v.cpu() for k, v in p.items()} for p in params]
    before = spmm.launches
    out = simulate_bsp_forward(cfg, params, plan, g.features, device=dev)
    assert spmm.launches - before == (2 if model != "gat" else 0)
    ref = forward(cfg, cpu_params, torch.from_numpy(g.features),
                  directed_edges(g.edges)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("d", [16, 52, 100])
def test_spmm_backward_kernel_matches_plain_and_is_deterministic(dev, d):
    """K1's backward: the kernel over the transposed operand, against the
    plain product over it and the CPU autograd of the plain forward; bit
    for bit across two runs, counted as backward launches."""
    lengths = [300, 0, 5, 0, 0, 1, 33, 64, 2, 0] + list(range(41))
    packed, feats = _csr_case(dev, d + 1, 3, 200, 700, d, lengths)
    g = torch.randn((3, 200, d), generator=torch.Generator().manual_seed(d))
    t = transpose_packed(packed, 700)
    assert t.col.device == feats.device

    def grad():
        x = feats.clone().requires_grad_(True)
        out, = torch.autograd.grad(spmm_packed(packed, x, t), x, g.to(dev))
        return out

    fwd, bwd = (spmm.launches_by_dir[k] for k in ("fwd", "bwd"))
    a, b = grad(), grad()
    torch.cuda.synchronize()
    assert spmm.launches_by_dir["fwd"] == fwd + 2
    assert spmm.launches_by_dir["bwd"] == bwd + 2
    assert torch.equal(a, b)
    _assert_close(a, spmm_packed_plain(t, g.to(dev)))
    x = feats.cpu().requires_grad_(True)
    cpu, = torch.autograd.grad(
        spmm_packed_plain(packed.to("cpu"), x), x, g)
    _assert_close(a.cpu(), cpu)
    lazy = feats.clone().requires_grad_(True)        # transpose made in bwd
    assert torch.equal(torch.autograd.grad(
        spmm_packed(packed, lazy), lazy, g.to(dev))[0], a)


def test_spmm_forward_of_a_table_that_needs_no_grad_skips_the_backward(dev):
    packed, feats = _csr_case(dev, 3, 2, 64, 300, 16, [3, 0, 7])
    w = torch.randn((2, 16, 8), device=dev, requires_grad=True)
    bwd = spmm.launches_by_dir["bwd"]
    loss = (spmm_packed(packed, feats) @ w).sum()
    grad, = torch.autograd.grad(loss, w)
    assert spmm.launches_by_dir["bwd"] == bwd
    weights = PackedBSR(**{**vars(packed), "w": packed.w.clone()
                           .requires_grad_(True)})
    with pytest.raises(RuntimeError, match="link weights"):
        spmm_packed(weights, feats)


def _train_case(dev, model, exchange, aggregate="auto"):
    g = synthetic_siot(n=600, target_links=2500)
    plan = compile_plan(g, partition_from_assign(
        g, random_layout(_cost_model(g, 4), seed=0), 4, {}), slack=0.5)
    cfg = GNNConfig(model, (52, 16, 2))
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    fwd = make_bsp_forward(cfg, plan, exchange=exchange, aggregate=aggregate,
                           device=dev)
    step = make_distributed_train_step(
        cfg, fwd, TP.scatter_ints(plan, g.labels),
        TP.scatter_ints(plan, np.ones(g.n, np.float32)), lr=0.1)
    blocks = torch.from_numpy(TP.scatter_features(plan, g.features)).to(dev)
    return g, cfg, params, fwd, step, blocks


@pytest.mark.parametrize("exchange", ["ppermute", "allgather"])
@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_bsp_train_step_on_card_matches_cpu_and_repeats(dev, model, exchange):
    """The distributed step's gradients on the card (K1 both ways for
    GCN/SAGE) within 2e-4 of the CPU whole-graph gradients with every
    vertex in the mask, and bit-equal from one run to the next."""
    g, cfg, params, fwd, step, blocks = _train_case(dev, model, exchange)
    assert fwd.mode == ("bsr" if model != "gat" else "segment")
    bwd = spmm.launches_by_dir["bwd"]
    loss, grads = step.loss_and_grads(params, blocks)
    loss2, grads2 = step.loss_and_grads(params, blocks)
    torch.cuda.synchronize()
    # Layer 0's table is the input features: one backward launch a step.
    assert spmm.launches_by_dir["bwd"] - bwd == (2 if model != "gat" else 0)
    assert torch.equal(loss, loss2)
    cpu_params = [{k: v.cpu() for k, v in p.items()} for p in params]
    ref_loss, ref = loss_and_grads(cfg, cpu_params, g.features,
                                   directed_edges(g.edges), g.labels,
                                   device="cpu")
    assert abs(float(loss) - float(ref_loss)) <= 2e-4 * abs(float(ref_loss))
    for a, b, r in zip(grads, grads2, ref):
        for k in a:
            assert torch.equal(a[k], b[k]), k
            scale = float(r[k].abs().max())
            assert float((a[k].cpu() - r[k]).abs().max()) <= 2e-4 * scale, k
    new, _ = step(params, blocks)
    again, _ = step(params, blocks)
    for a, b in zip(new, again):
        for k in a:
            assert torch.equal(a[k], b[k])


def test_flash_kernel_refuses_gradients(dev):
    q, k, v = _flash_inputs(dev, 1, 4, 2, 8, 8, 16, torch.float32)
    launches = flash_attention.launches
    for grad_of in ("q", "k", "v"):
        args = {"q": q, "k": k, "v": v}
        args[grad_of] = args[grad_of].detach().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            flash_attention(args["q"], args["k"], args["v"])
        with torch.no_grad():
            out = flash_attention(args["q"], args["k"], args["v"])
        assert out.grad_fn is None
    assert flash_attention.launches == launches + 3
    qg = q.detach().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        attention_any(qg.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=True, chunk=64)


# ------------------------------------------------------------ flash attention
# The reference's cases (tests/test_kernels.py) plus the main path's layouts
# at reduced size: (B, L, H, D) views, a cache slice with ragged kv_len, and
# head dims off the fast path.
FLASH_CASES = [
    # B, Hq, Hkv, Lq, Lk, D, causal, kv_len, dtype
    (2, 4, 2, 128, 128, 64, True, None, torch.float32),
    (1, 8, 8, 192, 192, 64, True, None, torch.float32),
    (2, 4, 1, 100, 100, 32, True, None, torch.float32),
    (1, 4, 2, 1, 256, 64, True, [190], torch.float32),
    (2, 2, 2, 64, 64, 16, False, None, torch.float32),
    (1, 4, 4, 96, 160, 64, True, None, torch.float32),
    (2, 4, 2, 64, 64, 64, True, None, torch.bfloat16),
    (3, 32, 8, 1, 300, 64, False, [1, 150, 300], torch.bfloat16),
    (1, 6, 2, 40, 40, 100, True, None, torch.float32),
    (1, 4, 1, 33, 70, 256, True, None, torch.float32),
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _flash_inputs(dev, B, Hq, Hkv, Lq, Lk, D, dtype, seed=0):
    """q/k/v as (B, H, L, D) views of (B, L, H, D) tensors, as the model
    passes them."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Lq, Hq, D), generator=gen).to(dev, dtype)
    k = torch.randn((B, Lk, Hkv, D), generator=gen).to(dev, dtype)
    v = torch.randn((B, Lk, Hkv, D), generator=gen).to(dev, dtype)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal,kv_len,dtype", FLASH_CASES)
def test_flash_kernel_matches_plain_and_is_deterministic(
        dev, B, Hq, Hkv, Lq, Lk, D, causal, kv_len, dtype):
    q, k, v = _flash_inputs(dev, B, Hq, Hkv, Lq, Lk, D, dtype)
    kl = (torch.tensor(kv_len, dtype=torch.int32, device=dev)
          if kv_len else None)
    before = flash_attention.launches
    out = flash_attention(q, k, v, kl, causal=causal)
    again = flash_attention(q, k, v, kl, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert torch.equal(out, again)
    assert out.dtype == dtype and out.shape == (B, Hq, Lq, D)
    ref = flash_attention_plain(q, k, v, kl, causal)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
    cont = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), kl,
                           causal=causal)
    assert torch.equal(cont, out)


def test_flash_kernel_fully_masked_row_is_zero(dev):
    q, k, v = _flash_inputs(dev, 2, 8, 2, 1, 64, 64, torch.bfloat16)
    kl = torch.tensor([0, 64], dtype=torch.int32, device=dev)
    out = flash_attention(q, k, v, kl, causal=False)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(out, flash_attention_plain(q, k, v, kl, False),
                               rtol=2e-2, atol=2e-2)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q, k, v = _flash_inputs(dev, 1, 4, 2, 8, 8, 16, torch.float32)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        flash_attention(q[:, :3], k, v)                 # 3 % 2 != 0
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, torch.tensor([8], device=dev))   # int64
    big = torch.zeros((1, 2, 4, 264), device=dev)
    with pytest.raises(ValueError):
        flash_attention(big, big, big)


def _flash_twice(q, k, v, kl, causal, path, scale=None):
    """Two launches on the dispatch branch ``path``: bitwise equal, within
    the reference's tolerance of the plain version."""
    launches = flash_attention.launches
    on_path = flash_attention.launches_by_path[path]
    out = flash_attention(q, k, v, kl, causal=causal, scale=scale)
    again = flash_attention(q, k, v, kl, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 2
    assert flash_attention.launches_by_path[path] == on_path + 2
    assert torch.equal(out, again)
    tol = FLASH_TOL[q.dtype]
    torch.testing.assert_close(
        out, flash_attention_plain(q, k, v, kl, causal, scale),
        rtol=tol, atol=tol)
    return out


@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal,kv_len", [
    (1, 8, 2, 256, 256, 64, True, None),
    (1, 8, 2, 256, 256, 96, True, None),
    (1, 8, 2, 256, 256, 128, True, None),
    (1, 4, 4, 200, 200, 32, True, None),
    (1, 8, 2, 100, 100, 64, True, None),          # ragged Lq
    (1, 8, 2, 96, 160, 64, True, None),           # Lq < Lk, bottom-right
    (2, 8, 2, 64, 200, 64, False, [37, 200]),     # kv_len, Lq > 1
    (2, 8, 2, 64, 200, 128, True, [150, 64]),
    (1, 40, 8, 130, 130, 128, True, None),        # group 5
    (1, 4, 1, 40, 130, 64, True, [0]),            # fully masked
])
def test_flash_prefill_tensor_cores_match_plain(dev, B, Hq, Hkv, Lq, Lk, D,
                                                causal, kv_len):
    q, k, v = _flash_inputs(dev, B, Hq, Hkv, Lq, Lk, D, torch.bfloat16)
    kl = (torch.tensor(kv_len, dtype=torch.int32, device=dev)
          if kv_len else None)
    out = _flash_twice(q, k, v, kl, causal, "prefill_tc")
    if kv_len == [0]:
        assert torch.equal(out, torch.zeros_like(out))


SPLIT_KV_LENS = [0, 1, 127, 128, 129, 300]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,Lq,D,causal", [
    (32, 8, 1, 64, False), (8, 8, 1, 64, False), (8, 4, 1, 128, False),
    (8, 2, 4, 64, True), (4, 1, 2, 32, True)])
def test_flash_split_decode_matches_plain(dev, dtype, Hq, Hkv, Lq, D, causal):
    """Every kv_len edge of the 128-key splits in one batch over a
    300-key cache (not a multiple of the split)."""
    B = len(SPLIT_KV_LENS)
    q, k, v = _flash_inputs(dev, B, Hq, Hkv, Lq, 300, D, dtype, seed=Lq)
    kl = torch.tensor(SPLIT_KV_LENS, dtype=torch.int32, device=dev)
    out = _flash_twice(q, k, v, kl, causal, "decode")
    assert torch.equal(out[0], torch.zeros_like(out[0]))


@pytest.mark.parametrize("scale", [0.0, -0.3])
@pytest.mark.parametrize("dtype,Lq,path", [
    (torch.bfloat16, 100, "prefill_tc"), (torch.bfloat16, 1, "decode"),
    (torch.float32, 1, "decode"), (torch.float32, 100, "general")])
def test_flash_any_scale_matches_plain(dev, scale, dtype, Lq, path):
    """A zero or negative scale on every kernel: the scores are scaled
    before the running max, so neither gives NaN or overflows."""
    q, k, v = _flash_inputs(dev, 2, 8, 2, Lq, 160, 64, dtype, seed=5)
    kl = torch.tensor([0, 130], dtype=torch.int32, device=dev)
    out = _flash_twice(q, k, v, kl, True, path, scale=scale)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.isfinite(out).all()


def test_flash_decode_on_two_streams_at_once(dev):
    """Decodes queued on two streams in turns, without waiting for each
    other: each stream keeps its own arrival counters, so every result
    equals the same decode on the default stream."""
    q, k, v = _flash_inputs(dev, 8, 32, 8, 1, 2048, 64, torch.bfloat16)
    kl = torch.tensor([64, 1056, 700, 129, 1, 0, 2048, 511],
                      dtype=torch.int32, device=dev)
    ref = _flash_twice(q, k, v, kl, False, "decode")
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    outs = [[], []]
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(flash_attention(q, k, v, kl, causal=False))
    torch.cuda.synchronize()
    for per_stream in outs:
        for out in per_stream:
            assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_batch_equals_each_row_alone(dev, dtype):
    """The serving shape: 8 slots of a 2048-position cache, ragged
    kv_len.  A row's bits never depend on the batch."""
    gen = torch.Generator().manual_seed(3)
    cache = torch.randn((2, 8, 2048, 8, 64), generator=gen).to(dev, dtype)
    q = torch.randn((8, 1, 32, 64), generator=gen).to(dev, dtype)
    q = q.transpose(1, 2)
    k, v = cache[1].transpose(1, 2), cache[0].transpose(1, 2)
    kl = torch.tensor([64, 1056, 700, 129, 1, 0, 2048, 511],
                      dtype=torch.int32, device=dev)
    out = _flash_twice(q, k, v, kl, False, "decode")
    for b in range(8):
        alone = flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                kl[b:b + 1], causal=False)
        assert torch.equal(alone, out[b:b + 1]), b


@pytest.mark.parametrize("Lq,path", [(64, "prefill_tc"), (1, "decode")])
def test_flash_unaligned_views_take_the_general_kernel(dev, Lq, path):
    """The model's transposed views take the vector kernels; the same
    values in a view with a strided last dim, or rows off a 16-byte
    boundary, take the general kernel, with no copy, within the tolerance
    of the plain version."""
    q, k, v = _flash_inputs(dev, 1, 8, 2, Lq, 64, 64, torch.bfloat16)
    _flash_twice(q, k, v, None, True, path)
    wide = torch.zeros((1, Lq, 8, 128), dtype=torch.bfloat16, device=dev)
    wide[..., ::2] = q.transpose(1, 2)
    strided = wide[..., ::2].transpose(1, 2)
    shifted = torch.zeros((1, 64, 2, 72), dtype=torch.bfloat16, device=dev)
    shifted[..., 1:65] = k.transpose(1, 2)
    for qq, kk in ((strided, k), (q, shifted[..., 1:65].transpose(1, 2))):
        assert kernel_path(qq.dtype, 8, 2, Lq, 64) == path
        _flash_twice(qq, kk, v, None, True, "general")


def test_lm_bf16_serving_path_stays_on_the_vector_kernels(dev):
    """Smoke llama in bf16 through prefill and decode: every attention
    call reads the model's views in place, on the tensor-core prefill or
    the split decode, never the general kernel (head dim 64, as the full
    model's)."""
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), head_dim=64)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    tok = torch.randint(1, 500, (2, 32),
                        generator=torch.Generator().manual_seed(1)).to(dev)
    lens = torch.tensor([20, 32], dtype=torch.int32, device=dev)
    before = dict(flash_attention.launches_by_path)
    _, cache = lm.prefill(cfg, params, {"tokens": tok, "lengths": lens}, 48)
    for step in range(3):
        _, cache = lm.decode_step(cfg, params,
                                  torch.tensor([[3], [9]], device=dev), cache)
    torch.cuda.synchronize()
    after = flash_attention.launches_by_path
    assert after["general"] == before["general"]
    assert after["prefill_tc"] - before["prefill_tc"] == cfg.n_layers
    assert after["decode"] - before["decode"] == 3 * cfg.n_layers


def test_lm_prefill_and_decode_on_card_match_cpu(dev):
    """Smoke llama in fp32: prefill + decode through K2 on the card against
    the plain attention on the CPU, one launch per layer per call."""
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              dtype=torch.float32)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    cpu = {"embed": params["embed"].cpu(),
           "final_norm": params["final_norm"].cpu(),
           "layers": {k: v.cpu() for k, v in params["layers"].items()}}
    tok = torch.randint(1, 500, (2, 32), generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([20, 32], dtype=torch.int32)
    before = flash_attention.launches
    gl, gc = lm.prefill(cfg, params, {"tokens": tok.to(dev),
                                      "lengths": lens.to(dev)}, 48)
    assert flash_attention.launches - before == cfg.n_layers
    cl, cc = lm.prefill(cfg, cpu, {"tokens": tok, "lengths": lens}, 48)
    torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
    for step in range(3):
        nxt = torch.tensor([[3 + step], [9 + step]])
        before = flash_attention.launches
        gl, gc = lm.decode_step(cfg, params, nxt.to(dev), gc)
        assert flash_attention.launches - before == cfg.n_layers
        cl, cc = lm.decode_step(cfg, cpu, nxt, cc)
        torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gc["k"].cpu(), cc["k"], rtol=1e-4, atol=1e-4)
