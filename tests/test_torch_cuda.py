"""Checks that need a CUDA card: the spmm_csr (K1) and flash_attention
kernels (K2 both ways) against their plain torch versions, the wrappers'
input checks, and the port's card paths (BSP forward and train step, K1's
backward, LM prefill, decode and train step, the LM training CLI, the MoE
FFN and its grouped GEMM's routes, MoE serving, the recurrent families'
prefill, decode and serving, the VLM and enc-dec families' prefill and
decode, an idle serving slot past the cache, the example twins) against
its CPU paths, and the captured steps (the serving engine's, the GNN
path's BSP forward, train steps, ``predict`` and ego forward, and the LM
train step) against their eager twins.
Without a card every test here skips.  The file imports neither ``jax``
nor ``repro``, so it runs on a machine with the card and the port alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import (  # noqa: E402
    CostModel, partition_from_assign, random_layout, workload_for)
from repro_torch.gnn import (  # noqa: E402
    GNNConfig, broadcast_assign, compile_plan, directed_edges, forward,
    init_params, make_rank_bsp_forward, simulate_bsp_forward)
from repro_torch.gnn import plan as TP  # noqa: E402
from repro_torch.gnn.distributed import make_bsp_forward  # noqa: E402
from repro_torch.gnn.models import (  # noqa: E402
    segment_order, segment_sum, sorted_segment_sum)
from repro_torch.kernels.segment_sum import (  # noqa: E402
    segment_sum as segment_sum_k3, segment_sum_plain,
    segment_sum_tiles_plain)
from repro_torch.step import Step, static_inputs  # noqa: E402
from repro_torch.gnn.training import (  # noqa: E402
    loss_and_grads, make_distributed_train_step)
from repro_torch.graphs import (  # noqa: E402
    build_edge_network, synthetic_siot)
from repro_torch.kernels import (  # noqa: E402
    BSRAggregate, PackedBSR, build_bsr, pack_bsr, spmm, spmm_packed,
    spmm_packed_plain, spmm_plain)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.gnn_aggregate import transpose_packed  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    backward_path, flash_attention, flash_attention_bwd_plain,
    flash_attention_plain, flash_bwd_tc_tiles_plain, kernel_path)
from repro_torch import models as lm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import LMConfig  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.models.common import attention_any  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.common import ShapeCfg  # noqa: E402
from repro_torch.train import (  # noqa: E402
    OptConfig, batch_at_step, init_opt_state, make_train_step, optim)

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


# The siot-gat plan's edge tables: P partitions of e_cap arcs, each
# partition's live arcs first, its padded arcs into its dummy segment cap.
GAT_PLAN = {"P": 8, "cap": 11_912, "e_cap": 100_136,
            "live": (12, 3, 15, 66_753, 90, 77, 16, 52)}


def _gat_plan_case(d, seed=0):
    """Messages and the host-made order of a sum over the siot-gat plan's
    801,088 message slots (8 dummy segments of 33,383 to 100,133 messages,
    live segments up to 277), as (messages, dst, segments, n) on the CPU."""
    rng = np.random.default_rng(seed)
    P, cap, e_cap = GAT_PLAN["P"], GAT_PLAN["cap"], GAT_PLAN["e_cap"]
    ed = np.full((P, e_cap), cap, np.int64)
    for p, live in enumerate(GAT_PLAN["live"]):
        dst = rng.integers(1, max(2, live // 8), size=live)
        dst[:min(277, live)] = 0                        # a hub of 277
        ed[p, :live] = rng.permutation(dst)
    dst = (ed + np.arange(P)[:, None] * (cap + 1)).reshape(-1)
    n = P * (cap + 1)
    shape = (P * e_cap,) if d == 1 else (P * e_cap, d)
    msgs = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    segments = tuple(torch.from_numpy(a) for a in segment_order(dst, n))
    assert int(torch.diff(segments[2]).max()) == e_cap - 3
    return msgs, torch.from_numpy(dst), segments, n


@pytest.mark.parametrize("d", [1, 2, 16, 52])
def test_k3_at_the_gat_plan_shapes(dev, d):
    """K3 over the siot-gat plan's shapes: bit-equal twice and to the plain
    mirror of its association, within 1e-5 of the segment's magnitudes of
    the plain version (``segment_reduce``), counted once a sum on the
    plan's path; the order sorted on the card gives the same bits."""
    msgs, dst, segments, n = _gat_plan_case(d)
    m, dt = msgs.to(dev), dst.to(dev)
    seg = tuple(t.to(dev) for t in segments)
    before = dict(segment_sum_k3.launches_by_path)
    a = sorted_segment_sum(m, dt, n, seg)
    b = sorted_segment_sum(m, dt, n, seg)
    torch.cuda.synchronize()
    assert segment_sum_k3.launches_by_path["plan"] == before["plan"] + 2
    assert torch.equal(a, b)
    assert torch.equal(a, segment_sum_tiles_plain(m, *seg))
    plain = segment_sum_plain(m, seg[0], seg[2])
    mag = segment_sum_plain(m.abs(), seg[0], seg[2])
    assert bool(((a - plain).abs() <= 1e-5 * mag + 1e-6).all())
    c = sorted_segment_sum(m, dt, n)
    assert segment_sum_k3.launches_by_path["device"] == before["device"] + 1
    assert torch.equal(a, c)
    cpu = sorted_segment_sum(msgs, dst, n, segments)
    assert torch.equal(a.cpu(), segment_sum_tiles_plain(msgs, *segments))
    assert bool(((a.cpu() - cpu).abs() <= 1e-5 * mag.cpu() + 1e-6).all())


@pytest.mark.parametrize("d", [1, 2, 3, 16, 17, 33, 52, 100, 300])
def test_k3_equals_its_mirror_over_ragged_cases(dev, d):
    """Every width's branch (grid y past 256 columns) over segments that
    cross tiles, lie inside one, are empty or trail empty, and over no
    messages at all: bit-equal to the mirror, the empties exactly 0."""
    rng = np.random.default_rng(d)
    n = 90
    dst = rng.integers(0, 60, size=3_000)
    dst[rng.random(3_000) < 0.3] = 70
    dst[dst == 30] = 31
    seg = tuple(torch.from_numpy(a).to(dev) for a in segment_order(dst, n))
    m = torch.from_numpy(rng.standard_normal((3_000, d)).astype(
        np.float32)).to(dev)
    out = segment_sum_k3(m, torch.from_numpy(dst).to(dev), *seg)
    assert torch.equal(out, segment_sum_tiles_plain(m, *seg))
    assert not out[30].any() and not out[71:].any()
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    none = segment_sum_k3(m[:0], empty, empty, empty,
                          torch.zeros(6, dtype=torch.int64, device=dev))
    assert none.shape == (5, d) and not none.any()


@pytest.mark.parametrize("d", [1, 2, 16, 52])
def test_k3_over_runs_of_empty_segments(dev, d):
    """Empty segments first, runs of thousands of empty segments between
    full ones (a tile and a tile boundary inside them), single-message
    segments and empty ones last: bit-equal to the mirror and every empty
    segment exactly 0."""
    rng = np.random.default_rng(100 + d)
    n = 12_000
    ids = np.array([3, 4, 700, 5_000, 5_001, 9_000, 11_000])
    dst = rng.choice(ids, size=4_000, p=[.1, .1, .002, .3, .297, .1, .101])
    dst = np.concatenate([dst, np.arange(6_000, 6_010)])
    seg = tuple(torch.from_numpy(a).to(dev) for a in segment_order(dst, n))
    m = torch.from_numpy(rng.standard_normal((len(dst), d)).astype(
        np.float32)).to(dev)
    out = segment_sum_k3(m, torch.from_numpy(dst).to(dev), *seg)
    assert torch.equal(out, segment_sum_tiles_plain(m, *seg))
    empty = torch.ones(n, dtype=torch.bool)
    empty[np.unique(dst)] = False
    assert not out[empty.to(dev)].any()


def test_k3_captured_equals_eager_and_counts_each_replay(dev):
    """One sum on each path captured into a CUDA graph: replays over new
    messages bit-equal to eager calls, each replay counted once a sum."""
    msgs, dst, segments, n = _gat_plan_case(16, seed=1)
    dt = dst.to(dev)
    seg = tuple(t.to(dev) for t in segments)

    def body(m):
        return (sorted_segment_sum(m, dt, n, seg),
                sorted_segment_sum(m[:, :1].contiguous(), dt, n))

    step = Step("k3", body, static_inputs(dev, m=msgs),
                torch.cuda.graph_pool_handle())
    for k in range(3):
        m = (msgs * (k + 1) - k).to(dev)
        step.write("m", m)
        before = dict(segment_sum_k3.launches_by_path)
        got = [t.clone() for t in step()]
        torch.cuda.synchronize()
        assert segment_sum_k3.launches_by_path == {
            "plan": before["plan"] + 1, "device": before["device"] + 1}
        want = body(m)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert step.graph is not None and step.replays == 2


def test_k3_wrapper_rejects_what_it_does_not_take(dev):
    msgs, dst, segments, n = _gat_plan_case(2)
    m, dt = msgs.to(dev), dst.to(dev)
    seg = tuple(t.to(dev) for t in segments)
    with pytest.raises(TypeError, match="segment_sum"):
        sorted_segment_sum(m.double(), dt, n, seg)
    with pytest.raises(ValueError, match="segment_sum"):
        segment_sum_k3(m, dt, seg[0].cpu(), seg[1], seg[2])
    with pytest.raises(ValueError, match="segment_sum"):
        segment_sum_k3(m.t(), dt, *seg)
    with pytest.raises(ValueError, match="segment order"):
        sorted_segment_sum(m[1:], dt[1:], n, seg)


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


def _card_rank(rank, P):
    """One of P ranks on cuda:0: a GCN forward and a train step over a
    random 4-way plan, with K1's launches and the staging copies."""
    dev = torch.device("cuda", 0)
    g = synthetic_siot(n=600, target_links=2000)
    assign = broadcast_assign(np.random.default_rng(0).integers(0, P, g.n)
                              if rank == 0 else None, g.n)
    plan = compile_plan(g, partition_from_assign(g, assign, P, {}),
                        slack=0.25)
    cfg = GNNConfig("gcn", (52, 16, 2))
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    block = TP.scatter_features(plan, g.features)[rank]
    fwd = make_rank_bsp_forward(cfg, plan, device=dev)
    before = dict(spmm.launches_by_dir)
    out = fwd(params, block)
    torch.cuda.synchronize()
    fwd_launches = {k: spmm.launches_by_dir[k] - before[k] for k in before}
    staged = dict(fwd.comm.staged)
    step = make_distributed_train_step(
        cfg, fwd, TP.scatter_ints(plan, g.labels)[rank],
        TP.scatter_ints(plan, np.ones(g.n, np.float32))[rank], lr=0.1)
    before = dict(spmm.launches_by_dir)
    loss, grads = step.loss_and_grads(params, block)
    torch.cuda.synchronize()
    return {"mode": fwd.mode, "out": out.cpu().numpy(), "loss": float(loss),
            "grads": [{k: v.cpu().numpy() for k, v in layer.items()}
                      for layer in grads],
            "fwd_launches": fwd_launches, "staged": staged,
            "rounds": len(plan.rounds),
            "step_launches": {k: spmm.launches_by_dir[k] - before[k]
                              for k in before}}


def test_rank_forward_and_step_on_card(dev):
    """Four ranks sharing cuda:0 over gloo: the GCN forward (K1 once a
    layer on every rank, one staging copy each way a round) and a train
    step (K1's backward once) against the one-device program."""
    _build.load_library()            # built once here, not in every rank
    P = 4
    res = run_ranks(_card_rank, P, P, timeout=300)
    g = synthetic_siot(n=600, target_links=2000)
    assign = np.random.default_rng(0).integers(0, P, g.n)
    plan = compile_plan(g, partition_from_assign(g, assign, P, {}),
                        slack=0.25)
    cfg = GNNConfig("gcn", (52, 16, 2))
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    blocks = torch.from_numpy(TP.scatter_features(plan, g.features)).to(dev)
    fwd = make_bsp_forward(cfg, plan, device=dev)
    ref = fwd(params, blocks).cpu().numpy()
    step = make_distributed_train_step(
        cfg, fwd, TP.scatter_ints(plan, g.labels),
        TP.scatter_ints(plan, np.ones(g.n, np.float32)), lr=0.1)
    ref_loss, ref_grads = step.loss_and_grads(params, blocks)
    out = np.stack([r["out"] for r in res])
    assert float(np.abs(out - ref).max()) <= 2e-4 * float(np.abs(ref).max())
    for r in res:
        assert r["mode"] == "bsr" and r["rounds"] > 0
        assert r["fwd_launches"] == {"fwd": 2, "bwd": 0}
        assert r["step_launches"] == {"fwd": 2, "bwd": 1}
        assert r["staged"] == {"d2h": 2 * r["rounds"], "h2d": 2 * r["rounds"]}
        assert r["loss"] == res[0]["loss"]
        assert abs(r["loss"] - float(ref_loss)) <= 2e-4 * abs(float(ref_loss))
        for layer, ref_layer in zip(r["grads"], ref_grads):
            for k, v in layer.items():
                want = ref_layer[k].cpu().numpy()
                assert np.abs(v - want).max() <= 2e-4 * np.abs(want).max(), k


# K2's backward: every forward kernel under grad (prefill_tc, general, and
# decode shapes) and both backward paths (tc, general), causal and not,
# Lq != Lk both ways, GQA groups 1, 4 and 8, head dims 32, 64 and 128, L
# off the 64-row tiles, ragged kv_len with a 0 row, Lq = 1 in bf16, and
# the LM train shape.
FLASH_BWD_CASES = [
    # B, Hq, Hkv, Lq, Lk, D, causal, kv_len, dtype, forward, backward path
    (2, 8, 2, 128, 128, 64, True, None, torch.bfloat16, "prefill_tc", "tc"),
    (1, 32, 8, 200, 200, 64, True, None, torch.bfloat16, "prefill_tc", "tc"),
    (2, 8, 8, 70, 150, 32, True, None, torch.bfloat16, "prefill_tc", "tc"),
    (2, 8, 1, 100, 60, 128, True, None, torch.bfloat16, "prefill_tc", "tc"),
    (3, 8, 2, 65, 65, 64, False, [0, 33, 65], torch.bfloat16, "prefill_tc",
     "tc"),
    (4, 32, 8, 1024, 1024, 64, True, None, torch.bfloat16, "prefill_tc",
     "tc"),
    (2, 8, 8, 130, 130, 32, False, None, torch.bfloat16, "prefill_tc", "tc"),
    (1, 16, 4, 96, 200, 128, True, [170], torch.bfloat16, "prefill_tc",
     "tc"),
    (2, 32, 8, 77, 77, 64, True, None, torch.bfloat16, "prefill_tc", "tc"),
    (2, 8, 2, 130, 130, 64, True, [0, 100], torch.bfloat16, "prefill_tc",
     "tc"),
    (2, 4, 2, 128, 128, 64, True, None, torch.float32, "general", "general"),
    (2, 4, 1, 100, 100, 32, True, None, torch.float32, "general", "general"),
    (1, 8, 8, 96, 160, 128, True, [150], torch.float32, "general", "general"),
    (2, 16, 2, 77, 40, 64, True, None, torch.float32, "general", "general"),
    (2, 6, 2, 40, 40, 100, False, [0, 17], torch.float32, "general",
     "general"),
    (2, 6, 2, 40, 40, 100, True, [0, 17], torch.bfloat16, "general",
     "general"),
    (3, 32, 8, 1, 300, 64, False, [0, 150, 300], torch.bfloat16, "decode",
     "tc"),
    (2, 8, 2, 4, 200, 64, True, [77, 200], torch.float32, "decode",
     "general"),
]
FLASH_BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 0.0)}
# The tensor-core backward against its mirror (the same tiles and bf16
# roundings): one bf16 ulp at the top of the range (up to 2^-7 of max|ref|)
# plus the fp32 sums' order inside the products.
FLASH_BWD_TC_MIRROR_TOL = 1e-2


def _assert_grad_close(got, ref, dtype):
    rel, abs_ = FLASH_BWD_TOL[dtype]
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.isfinite(g).all()
        err = float((g.float() - r.float()).abs().max())
        assert err <= rel * float(r.float().abs().max()) + abs_, err


@pytest.mark.parametrize(
    "B,Hq,Hkv,Lq,Lk,D,causal,kv_len,dtype,path,bpath", FLASH_BWD_CASES)
def test_flash_backward_matches_plain_and_is_deterministic(
        dev, B, Hq, Hkv, Lq, Lk, D, causal, kv_len, dtype, path, bpath):
    """Under grad the call takes its forward kernel once and returns an
    output with a backward; the backward launches the two backward kernels
    of its path once each, repeats bit for bit, and is within tolerance of
    the plain backward on the same (q, k, v, out, dout) (and, on "tc", of
    its mirror): the model's (B, L, H, D) views, and a dout with the
    strides autograd gives.  The gradient of each input alone is the one
    taken through all three."""
    q, k, v = (t.detach().requires_grad_(True) for t in _flash_inputs(
        dev, B, Hq, Hkv, Lq, Lk, D, dtype, seed=Lq))
    kl = (torch.tensor(kv_len, dtype=torch.int32, device=dev)
          if kv_len else None)
    assert kernel_path(dtype, Hq, Hkv, Lq, D) == path
    assert backward_path(dtype, Hq, Hkv, Lq, D) == bpath
    fwd = dict(flash_attention.launches_by_path)
    bwd = dict(flash_attention.backward_launches)
    by_path = dict(flash_attention.backward_launches_by_path)
    out = flash_attention(q, k, v, kl, causal=causal)
    assert out.grad_fn is not None
    dout = torch.randn((B, Lq, Hq, D), generator=torch.Generator(
    ).manual_seed(7)).to(dev, dtype).transpose(1, 2)
    got = torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)
    again = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_path[path] == fwd[path] + 1
    assert flash_attention.backward_launches == {
        "dq": bwd["dq"] + 2, "dkdv": bwd["dkdv"] + 2}
    assert flash_attention.backward_launches_by_path == {
        **by_path, bpath: by_path[bpath] + 2}
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    args = (q.detach(), k.detach(), v.detach(), out.detach(), dout, kl,
            causal)
    _assert_grad_close(got, flash_attention_bwd_plain(*args), dtype)
    if bpath == "tc":
        for g, r in zip(got, flash_bwd_tc_tiles_plain(*args)):
            err = float((g.float() - r.float()).abs().max())
            assert err <= FLASH_BWD_TC_MIRROR_TOL * float(
                r.float().abs().max()), err
    if kv_len and kv_len[0] == 0:               # a fully masked batch row
        for g in got:
            assert torch.equal(g[0], torch.zeros_like(g[0]))
    for i in range(3):                          # each input alone
        leaves = [t.detach() for t in (q, k, v)]
        leaves[i].requires_grad_(True)
        g, = torch.autograd.grad(flash_attention(*leaves, kl, causal=causal),
                                 leaves[i], dout)
        assert torch.equal(g, got[i])
    assert flash_attention.backward_launches_by_path == {
        **by_path, bpath: by_path[bpath] + 5}
    with torch.no_grad():
        plain_out = flash_attention(q, k, v, kl, causal=causal)
    assert plain_out.grad_fn is None and torch.equal(plain_out, out)
    assert flash_attention.launches_by_path[path] == fwd[path] + 5
    assert flash_attention.backward_launches == {
        "dq": bwd["dq"] + 5, "dkdv": bwd["dkdv"] + 5}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_of_each_input_alone(dev, dtype):
    """Grad through q, k or v alone: the same gradient as through all
    three, and none for the others."""
    q, k, v = _flash_inputs(dev, 2, 8, 2, 80, 80, 64, dtype, seed=3)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(4)
                       ).to(dev, dtype)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    full = torch.autograd.grad(flash_attention(*leaves), leaves, dout)
    for i in range(3):
        args = [q, k, v]
        args[i] = args[i].detach().requires_grad_(True)
        out = flash_attention(*args)
        g, = torch.autograd.grad(out, args[i], dout)
        assert torch.equal(g, full[i])


def test_flash_attention_any_differentiates_on_the_card(dev):
    """The model's attention entry under grad: the gradient of the card
    path within tolerance of the CPU's plain attention, in fp32."""
    q, k, v = _flash_inputs(dev, 2, 8, 2, 50, 50, 32, torch.float32)
    args = [t.transpose(1, 2).detach().requires_grad_(True)
            for t in (q, k, v)]
    out = attention_any(*args, causal=True, chunk=64)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    got = torch.autograd.grad(out, args, g.to(dev))
    cpu = [a.detach().cpu().requires_grad_(True) for a in args]
    ref = torch.autograd.grad(attention_any(*cpu, causal=True, chunk=64),
                              cpu, g)
    _assert_grad_close([x.cpu() for x in got], ref, torch.float32)


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
    (1, 16, 16, 300, 300, 128, True, None),       # deepseek: group 1, D 128
    (2, 16, 16, 64, 200, 128, True, [150, 64]),
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
    (8, 2, 4, 64, True), (4, 1, 2, 32, True),
    (16, 16, 1, 128, False)])                     # deepseek: group 1, D 128
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


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def test_lm_train_step_on_card_matches_cpu(dev):
    """Smoke llama (2 layers) in fp32: the loss and every gradient leaf of
    a train step on the card (K2 both ways, one forward and one of each
    backward launch per layer) against the CPU's; after one AdamW step on
    each, the next loss still agrees."""
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              dtype=torch.float32)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    cpu = _to_cpu(params)
    batch = batch_at_step(cfg, ShapeCfg("t", 64, 4, "train"), 0)
    gb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    cb = {k: torch.from_numpy(v) for k, v in batch.items()}
    opt = OptConfig(lr=1e-3)
    step = make_train_step(cfg, opt)
    fwd = flash_attention.launches_by_path["general"]
    bwd = dict(flash_attention.backward_launches)
    loss, grads = step.grads_of(params, gb)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_path["general"] == fwd + cfg.n_layers
    assert flash_attention.backward_launches == {
        k: n + cfg.n_layers for k, n in bwd.items()}
    ref_loss, ref = step.grads_of(cpu, cb)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    for g, r in zip(optim.leaves(grads), optim.leaves(ref)):
        assert float((g.cpu() - r).abs().max()) <= (
            1e-4 * float(r.abs().max()) + 1e-6)
    params, _, _, _ = step(params, init_opt_state(opt, params), None, gb)
    cpu, _, _, _ = step(cpu, init_opt_state(opt, cpu), None, cb)
    assert float(step.grads_of(params, gb)[0]) == pytest.approx(
        float(step.grads_of(cpu, cb)[0]), rel=1e-4)


def test_launch_train_smoke_on_card(capsys):
    """``python -m repro_torch.launch.train --smoke`` on the card: the loss
    falls and every step's attention ran K2 both ways."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.launch import train as launch_train
    bwd = dict(flash_attention.backward_launches)
    losses = launch_train.main(["--arch", "llama3.2-1b", "--smoke",
                                "--steps", "20"])
    assert len(losses) == 20 and losses[-1] < losses[0]
    assert "on cuda" in capsys.readouterr().out
    cfg = get_smoke_config("llama3.2-1b")
    assert flash_attention.backward_launches == {
        k: n + 20 * cfg.n_layers for k, n in bwd.items()}


# --------------------------------------------------------------------- MoE
def _moe_case(dev, dtype, T=96, d=64, E=8, k=2, f=32, seed=0):
    cfg = LMConfig(name="t", family="moe", n_layers=1, d_model=d, n_heads=2,
                   n_kv_heads=2, d_ff=0, vocab=64, n_experts=E, top_k=k,
                   expert_d_ff=f, dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    p = {"router": torch.randn((d, E), generator=gen) * d ** -0.5,
         "w13": torch.randn((E, d, 2 * f), generator=gen) * d ** -0.5,
         "w2": torch.randn((E, f, d), generator=gen) * f ** -0.5}
    p = {key: v.to(dev, dtype) for key, v in p.items()}
    x = torch.randn((2, T // 2, d), generator=gen).to(dev, dtype)
    return cfg, p, x


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "grouped_mm"),
                                         (torch.float32, "grouped_mm")])
def test_moe_ffn_on_card_matches_dense_oracle_and_repeats(dev, dtype, route):
    """The routed MoE FFN on the card, bf16 and fp32 on torch._grouped_mm,
    each against moe_ffn_dense_ref on the card (bf16 within 2e-2 of
    max|ref|, fp32 1e-5) and bit-equal twice."""
    cfg, p, x = _moe_case(dev, dtype)
    before = dict(moe.grouped_gemm.launches_by_route)
    out, aux = moe.moe_ffn(cfg, p, x)
    again, _ = moe.moe_ffn(cfg, p, x)
    torch.cuda.synchronize()
    assert moe.grouped_gemm.launches_by_route[route] == before[route] + 4
    ref, ref_aux = moe.moe_ffn_dense_ref(cfg, p, x)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    scale = float(ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= tol * scale
    assert torch.equal(out, again)
    assert float(aux) == pytest.approx(float(ref_aux), abs=1e-6)


@pytest.mark.parametrize("dtype,n,route", [(torch.bfloat16, 48, "grouped_mm"),
                                           (torch.float32, 48, "grouped_mm"),
                                           (torch.bfloat16, 44, "loop")])
def test_grouped_gemm_routes_match_the_per_expert_loop(dev, dtype, n, route):
    """grouped_gemm on the card (grouped_mm where the rows are whole
    16-byte chunks, else the loop) against a per-expert loop of matmuls:
    an empty group, rows past the last group give 0."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((70, 64), generator=gen).to(dev, dtype)
    w = torch.randn((5, 64, n), generator=gen).to(dev, dtype)
    sizes = [13, 0, 29, 1, 20]                   # 63 rows; 7 past the end
    before = dict(moe.grouped_gemm.launches_by_route)
    out = moe.grouped_gemm(x, w, torch.tensor(sizes, device=dev))
    assert moe.grouped_gemm.launches_by_route[route] == before[route] + 1
    ref, start = torch.zeros((70, n), device=dev, dtype=dtype), 0
    for e, size in enumerate(sizes):
        ref[start:start + size] = x[start:start + size] @ w[e]
        start += size
    torch.testing.assert_close(out, ref, rtol=2e-2 if dtype == torch.bfloat16
                               else 1e-5, atol=1e-5)
    assert torch.equal(out[63:], torch.zeros_like(out[63:]))


def _serve_tokens(cfg, params, dev, prompts, max_new=6):
    eng = ServeEngine(cfg, params, slots=2, max_len=64, device=dev)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=max_new, eos_id=-1)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run(max_ticks=50)
    return [r.out_tokens for r in reqs], stats


def test_moe_smoke_served_on_card(dev):
    """deepseek's smoke config behind ServeEngine on the card: in fp32 the
    same tokens as on the CPU from the same weights; in bf16 (head dim 64)
    every request completes with every prefill on prefill_tc (prompts past
    16 tokens: with group 1, a bucket of up to 16 rows takes the decode
    kernel), every tick on the split decode and every MoE layer's grouped
    GEMMs on grouped_mm."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 400, size=n).astype(np.int32)
               for n in (20, 17, 30, 25, 40)]
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              dtype=torch.float32)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    card, _ = _serve_tokens(cfg, params, dev, prompts)
    cpu, _ = _serve_tokens(cfg, _to_cpu(params), torch.device("cpu"),
                           prompts)
    assert card == cpu
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              head_dim=64)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    k2 = dict(flash_attention.launches_by_path)
    routes = dict(moe.grouped_gemm.launches_by_route)
    tokens, stats = _serve_tokens(cfg, params, dev, prompts)
    assert all(len(t) == 6 for t in tokens)
    n, n_moe = cfg.n_layers, cfg.n_layers - cfg.first_dense_layers
    calls = stats.prefills + stats.ticks
    assert {key: flash_attention.launches_by_path[key] - k2[key]
            for key in k2} == {"prefill_tc": n * stats.prefills,
                               "decode": n * stats.ticks, "general": 0}
    assert {key: moe.grouped_gemm.launches_by_route[key] - routes[key]
            for key in routes} == {"grouped_mm": 2 * n_moe * calls,
                                   "loop": 0}


# ------------------------------------------------- recurrent families (K2)
@pytest.mark.parametrize("B,Lq,Lk,kv_len,path", [
    (1, 337, 337, None, "prefill_tc"), (1, 1000, 1000, None, "prefill_tc"),
    (8, 1, 2048, [64, 1056, 300, 1, 777, 2048, 129, 500], "decode")])
def test_flash_zamba2_shapes_match_plain(dev, B, Lq, Lk, kv_len, path):
    """zamba2-1.2b's shared attention: 32/32 heads of 64 (group 1) in bf16,
    prefill at exact lengths off the powers of two, decode over the slot
    cache with ragged kv_len."""
    q, k, v = _flash_inputs(dev, B, 32, 32, Lq, Lk, 64, torch.bfloat16,
                            seed=Lq)
    kl = (torch.tensor(kv_len, dtype=torch.int32, device=dev)
          if kv_len else None)
    _flash_twice(q, k, v, kl, kv_len is None, path)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_recurrent_prefill_and_decode_on_card_match_cpu(dev, arch):
    """The smoke models in fp32, one prompt past an SSD chunk: prefill and
    3 decode steps on the card against the CPU, logits and every cache
    key; the hybrid's attention launches K2 once per shared-block site."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    cpu = _to_cpu(params)
    sites = lm.ssm.num_shared_calls(cfg) if cfg.family == "hybrid" else 0
    tok = torch.randint(1, 500, (2, 150),
                        generator=torch.Generator().manual_seed(1))
    before = flash_attention.launches
    gl, gc = lm.prefill(cfg, params, {"tokens": tok.to(dev)}, 192)
    assert flash_attention.launches - before == sites
    cl, cc = lm.prefill(cfg, cpu, {"tokens": tok}, 192)
    torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
    for step in range(3):
        nxt = torch.tensor([[3 + step], [9 + step]])
        gl, gc = lm.decode_step(cfg, params, nxt.to(dev), gc)
        cl, cc = lm.decode_step(cfg, cpu, nxt, cc)
        torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
    assert sorted(gc) == sorted(cc)
    for key in cc:
        torch.testing.assert_close(gc[key].cpu(), cc[key], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_recurrent_smoke_served_on_card(dev, arch):
    """The smoke models behind ServeEngine on the card: in fp32 the same
    tokens as on the CPU from the same weights; in bf16 (the hybrid with
    head dim 64) every request completes, each prefill at its exact length
    on prefill_tc and each tick on the split decode, once per site."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 400, size=n).astype(np.int32)
               for n in (20, 17, 30, 25, 40)]
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    card, _ = _serve_tokens(cfg, params, dev, prompts)
    cpu, _ = _serve_tokens(cfg, _to_cpu(params), torch.device("cpu"),
                           prompts)
    assert card == cpu
    cfg = get_smoke_config(arch)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, head_dim=64)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    k2 = dict(flash_attention.launches_by_path)
    tokens, stats = _serve_tokens(cfg, params, dev, prompts)
    assert all(len(t) == 6 for t in tokens)
    sites = lm.ssm.num_shared_calls(cfg) if cfg.family == "hybrid" else 0
    assert {key: flash_attention.launches_by_path[key] - k2[key]
            for key in k2} == {"prefill_tc": sites * stats.prefills,
                               "decode": sites * stats.ticks, "general": 0}


# ------------------------------------------ VLM and enc-dec families (K2)
@pytest.mark.parametrize("Lq", [17, 48, 64, 200])
def test_flash_noncausal_prefill_with_fewer_queries_than_keys(dev, Lq):
    """The enc-dec cross-attention's branch of the tensor-core prefill:
    bf16, causal=False, Lq != Lk = 1024 (a partial 64-row tile at Lq = 17,
    48 and 200), D = 64, group 1, no kv_len: every key read, no row under
    a causal limit."""
    q, k, v = _flash_inputs(dev, 2, 16, 16, Lq, 1024, 64, torch.bfloat16,
                            seed=Lq)
    assert kernel_path(q.dtype, 16, 16, Lq, 64) == "prefill_tc"
    _flash_twice(q, k, v, None, False, "prefill_tc")


@pytest.mark.parametrize("B,Lq,Lk,causal,kv_len,path", [
    (1, 768, 768, True, None, "prefill_tc"),
    (2, 64, 300, False, None, "prefill_tc"),
    (8, 1, 2048, False, [64, 1056, 300, 1, 777, 2048, 129, 500], "decode")])
def test_flash_internvl2_shapes_match_plain(dev, B, Lq, Lk, causal, kv_len,
                                            path):
    """internvl2-2b's attention: 16/8 heads of 128 (group 2) in bf16, the
    prefill of 256 patches + 512 tokens, a non-causal prefill and decode
    over the slot cache with ragged kv_len."""
    q, k, v = _flash_inputs(dev, B, 16, 8, Lq, Lk, 128, torch.bfloat16,
                            seed=Lq)
    kl = (torch.tensor(kv_len, dtype=torch.int32, device=dev)
          if kv_len else None)
    _flash_twice(q, k, v, kl, causal, path)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_cross_decode_without_kv_len(dev, dtype):
    """Decode's cross-attention: one query per row over all 1024 frames'
    keys with kv_len=None, on the split decode."""
    q, k, v = _flash_inputs(dev, 8, 16, 16, 1, 1024, 64, dtype, seed=3)
    _flash_twice(q, k, v, None, False, "decode")


def test_engine_idle_slot_past_max_len_on_card(dev):
    """An idle slot's len passes max_len while the other slot serves (four
    runs of one request): the dropped cache writes raise no device-side
    assert, and the served tokens equal the CPU engine's."""
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              dtype=torch.float32)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 400, size=10) for _ in range(4)]
    out = []
    for d, p in ((dev, params), (torch.device("cpu"), _to_cpu(params))):
        eng = ServeEngine(cfg, p, slots=2, max_len=16, device=d)
        toks = []
        for i, prompt in enumerate(prompts):
            req = Request(uid=i, prompt=prompt, eos_id=-1)
            eng.submit(req)
            eng.run()
            toks.append(req.out_tokens)
        if d.type == "cuda":
            torch.cuda.synchronize()
        out.append((toks, eng.cache["len"].tolist()))
    assert out[0] == out[1] and out[0][1][1] > 16


@pytest.mark.parametrize("arch", ["internvl2-2b", "seamless-m4t-medium"])
def test_frontend_families_on_card_match_cpu(dev, arch):
    """The smoke models in fp32 with their stub frontend's input: prefill
    and 3 decode steps on the card against the CPU, logits and every cache
    key, K2 once per attention (enc-dec: encoder, decoder self and cross
    at prefill; self and cross per step)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    cpu = _to_cpu(params)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(1, 500, (2, 20), generator=gen)}
    key = "patches" if cfg.family == "vlm" else "frames"
    batch[key] = torch.randn((2, cfg.frontend_len, cfg.frontend_dim),
                             generator=gen)
    enc = cfg.family == "encdec"
    before = flash_attention.launches
    gl, gc = lm.prefill(cfg, params, {k: t.to(dev) for k, t in batch.items()},
                        64)
    assert flash_attention.launches - before == (
        cfg.n_enc_layers + 2 * cfg.n_layers if enc else cfg.n_layers)
    cl, cc = lm.prefill(cfg, cpu, batch, 64)
    torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
    for step in range(3):
        nxt = torch.tensor([[3 + step], [9 + step]])
        before = flash_attention.launches
        gl, gc = lm.decode_step(cfg, params, nxt.to(dev), gc)
        assert flash_attention.launches - before == (
            2 * cfg.n_layers if enc else cfg.n_layers)
        cl, cc = lm.decode_step(cfg, cpu, nxt, cc)
        torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
    assert sorted(gc) == sorted(cc)
    for name in cc:
        torch.testing.assert_close(gc[name].cpu(), cc[name], rtol=1e-4,
                                   atol=1e-4)


# ------------------------------------------------ training of the families
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grouped_gemm_backward_on_card_matches_loop_and_dense(dev, dtype):
    """grouped_gemm's ragged adjoints on the grouped_mm route (torch's
    derivative of ``torch._grouped_mm``: dx over wᵀ, the K-ragged dw)
    against the loop route's and against autograd through
    the dense per-row product, with an empty group and rows past the
    last group (their dx 0), counted once a backward, bit-equal run to
    run."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((70, 64), generator=gen).to(dev, dtype)
    w = torch.randn((5, 64, 48), generator=gen).to(dev, dtype)
    dy = torch.randn((70, 48), generator=gen).to(dev, dtype)
    sizes = torch.tensor([13, 0, 29, 1, 20], device=dev)

    def grads():
        leaves = [t.detach().requires_grad_(True) for t in (x, w)]
        return torch.autograd.grad(moe.grouped_gemm(*leaves, sizes), leaves,
                                   dy)
    before = dict(moe.grouped_gemm.backward_launches_by_route)
    got, again = grads(), grads()
    assert moe.grouped_gemm.backward_launches_by_route == {
        **before, "grouped_mm": before["grouped_mm"] + 2}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ends = torch.cumsum(sizes, 0).to(torch.int32)
    leaves = [t.detach().requires_grad_(True) for t in (x, w)]
    loop = torch.autograd.grad(moe._product("loop", *leaves, ends), leaves,
                               dy)
    gid = torch.searchsorted(ends, torch.arange(70, device=dev), right=True)
    leaves = [t.float().detach().requires_grad_(True) for t in (x, w)]
    wz = torch.cat([leaves[1], torch.zeros_like(leaves[1][:1])])
    dense = torch.einsum("mk,mkn->mn", leaves[0], wz[gid])
    dense_grads = torch.autograd.grad(dense, leaves, dy.float())
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for g, lp, dn in zip(got, loop, dense_grads):
        for ref in (lp.float(), dn):
            scale = float(ref.abs().max())
            assert float((g.float() - ref).abs().max()) <= tol * scale + 1e-6
    assert torch.equal(got[0][63:], torch.zeros_like(got[0][63:]))
    assert torch.equal(got[1][1], torch.zeros_like(got[1][1]))


TRAIN_ARCHS = ["deepseek-moe-16b", "zamba2-1.2b", "internvl2-2b",
               "seamless-m4t-medium", "xlstm-1.3b"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_family_train_step_on_card_matches_cpu(dev, arch):
    """Each family's smoke config cut to 2 layers (2 + 2), fp32, every
    layer checkpointed: the loss and every gradient leaf of ``grads_of``
    on the card (K2 both ways, the grouped GEMMs both ways on grouped_mm)
    against the CPU's, at chip_smoke's parity gates (the loss within 1e-4
    relative, each leaf within 1e-3 * max|ref| + 1e-5); the card's step
    bit-equal run to run; one AdamW step on each side, then the losses
    still agree."""
    cut = {"n_layers": 2, "remat": True, "dtype": torch.float32}
    if arch == "seamless-m4t-medium":
        cut["n_enc_layers"] = 2
    if arch == "zamba2-1.2b":
        cut["attn_every"] = 2
    if arch == "xlstm-1.3b":
        cut["slstm_every"] = 2
    cfg = dataclasses.replace(get_smoke_config(arch), **cut)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    cpu = _to_cpu(params)
    batch = batch_at_step(cfg, ShapeCfg("t", 160, 2, "train"), 0)
    gb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    cb = {k: torch.from_numpy(v) for k, v in batch.items()}
    opt = OptConfig(lr=1e-3)
    step = make_train_step(cfg, opt)
    loss, grads = step.grads_of(params, gb)
    loss2, grads2 = step.grads_of(params, gb)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(optim.leaves(grads),
                                                  optim.leaves(grads2)))
    ref_loss, ref = step.grads_of(cpu, cb)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-4)
    for g, r in zip(optim.leaves(grads), optim.leaves(ref)):
        assert float((g.cpu() - r).abs().max()) <= (
            1e-3 * float(r.abs().max()) + 1e-5)
    params, _, _, _ = step(params, init_opt_state(opt, params), None, gb)
    cpu, _, _, _ = step(cpu, init_opt_state(opt, cpu), None, cb)
    assert float(step.grads_of(params, gb)[0]) == pytest.approx(
        float(step.grads_of(cpu, cb)[0]), rel=1e-4)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_launch_train_family_smoke_on_card(capsys, arch):
    """``python -m repro_torch.launch.train --arch <family> --smoke`` on
    the card: 10 steps, the loss finite and falling."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.launch import train as launch_train
    losses = launch_train.main(["--arch", arch, "--smoke", "--steps", "10"])
    assert len(losses) == 10 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert "on cuda" in capsys.readouterr().out


# ------------------------------------------------------- the example twins
# Fields of a twin's record that are times or name the device: left out of
# the card-vs-CPU comparison.  Forward floats are compared within 2e-4.
EX_TIMES = {"glad_s_s", "step_s", "patch_s", "forward_s", "relayout_ms",
            "req_per_s", "p50_ms", "p99_ms", "device"}
EX_FLOATS = {"max_err", "initial_max_err", "emb", "served_max_err"}


def _ex_split(rec, floats):
    """``rec`` without its times, with its forward floats moved to
    ``floats`` (by path)."""
    if isinstance(rec, dict):
        out = {}
        for k, v in rec.items():
            if k in EX_TIMES:
                continue
            if k in EX_FLOATS:
                floats.append(np.ravel(v).astype(float))
                continue
            out[k] = _ex_split(v, floats)
        return out
    if isinstance(rec, list):
        return [_ex_split(v, floats) for v in rec]
    return rec


def _ex_same(card, cpu):
    fa, fb = [], []
    assert _ex_split(card, fa) == _ex_split(cpu, fb)
    assert len(fa) == len(fb)
    for a, b in zip(fa, fb):
        assert np.abs(a - b).max() <= 2e-4


@pytest.mark.parametrize("name,launches", [
    ("quickstart", 2 * 2), ("adaptive_relayout", 2 * 31), ("serve_gnn", 0)])
def test_example_twin_on_card_matches_its_cpu_run(dev, capsys, name,
                                                  launches):
    """Each GNN example twin at its example's default size on the card and
    on the CPU: the records equal but for times and the forward floats
    (within 2e-4); K1 twice a BSP forward, never in the ego forward."""
    import importlib
    main = importlib.import_module(f"repro_torch.launch.{name}").main
    before = spmm.launches
    card = main(device=dev)
    assert spmm.launches - before == launches
    cpu = main(device="cpu")
    _ex_same(card, cpu)
    errs = [card.get("initial_max_err", 0.0)]
    errs += [s["max_err"] for s in card.get("slots", [])]
    errs += [v["max_err"] for v in card.get("layouts", {}).values()]
    errs += card.get("served_max_err", [])
    assert max(errs) <= 2e-4
    capsys.readouterr()


def test_serve_lm_twin_on_card_matches_cpu(dev, capsys):
    """``launch.serve_lm`` in fp32 at the example's size: the card's tokens
    equal the CPU's, with K2 launched n_layers x (prefills + ticks)."""
    from repro_torch.launch import serve_lm
    before = flash_attention.launches
    card = serve_lm.main(device=dev)
    assert flash_attention.launches - before == card["n_layers"] * (
        card["prefills"] + card["ticks"])
    cpu = serve_lm.main(device="cpu")
    assert card["tokens"] == cpu["tokens"]
    assert (card["completed"], card["generated_tokens"]) == (12, 132)
    capsys.readouterr()


# ----------------------------------------------------- the 1x1 mesh (NCCL)
@pytest.fixture(scope="module")
def mesh11():
    """A one-process NCCL group and its 1x1 (data, model) mesh, destroyed
    after this file's mesh tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import socket
    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_debug_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tdist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                             rank=0, world_size=1)
    yield make_debug_mesh(1, 1, device_type="cuda")
    tdist.destroy_process_group()


def _mesh_case(dev, mesh, arch="llama3.2-1b"):
    from repro_torch.launch.mesh import shard_tree
    from repro_torch.models.common import P, Dist
    cfg = dataclasses.replace(get_smoke_config(arch), head_dim=64)
    dist = Dist(mesh, batch_axes=("data",))
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab, (2, 128), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    specs = lm.param_specs(cfg, dist)
    return (cfg, dist, params, batch, shard_tree(params, specs, mesh),
            {k: shard_tree(v, P("data", None), mesh)
             for k, v in batch.items()})


def test_mesh_forward_and_prefill_bit_equal_on_card(dev, mesh11):
    """Under Dist on the 1x1 mesh the forward and the prefill equal the
    mesh-free path's bit for bit, K2 once a layer on prefill_tc through
    local_map."""
    cfg, dist, params, batch, placed, pbatch = _mesh_case(dev, mesh11)
    with torch.no_grad():
        ref = lm.forward(cfg, params, batch)[0]
        before = dict(flash_attention.launches_by_path)
        got = lm.forward(cfg, placed, pbatch, dist)[0].to_local()
        after = dict(flash_attention.launches_by_path)
        assert torch.equal(got, ref)
        assert after["prefill_tc"] - before["prefill_tc"] == cfg.n_layers
        rl, rc = lm.prefill(cfg, params, {"tokens": batch["tokens"]}, 160)
        gl, gc = lm.prefill(cfg, placed, {"tokens": pbatch["tokens"]}, 160,
                            dist)
        assert torch.equal(gl.to_local(), rl)
        for key in ("k", "v", "len"):
            assert torch.equal(gc[key].to_local(), rc[key]), key


def test_mesh_train_step_bit_equal_on_card(dev, mesh11):
    """jit_train_step on the 1x1 mesh: two steps' losses, parameters and
    moments equal make_train_step's bit for bit."""
    from repro_torch.launch.mesh import full_tree
    from repro_torch.models.common import P
    from repro_torch.train.step import jit_train_step
    cfg, dist, params, batch, placed, _ = _mesh_case(dev, mesh11)
    opt_cfg = optim.for_model(cfg)
    rp = optim.tree_map(lambda t: t.clone(), params)
    ro = init_opt_state(opt_cfg, rp)
    step = make_train_step(cfg, opt_cfg)
    mstep = jit_train_step(cfg, dist, lm.param_specs(cfg, dist), opt_cfg,
                           batch_specs={k: P("data", None) for k in batch})
    mo = init_opt_state(opt_cfg, placed)
    for _ in range(2):
        rp, ro, _, rm = step(rp, ro, None, batch)
        placed, mo, _, mm = mstep(placed, mo, None, batch)
        assert torch.equal(mm["loss"].to_local(), rm["loss"])
    got = full_tree({"p": placed, "m": mo.m, "v": mo.v})
    for a, b in zip(optim.leaves(got), optim.leaves(
            {"p": rp, "m": ro.m, "v": ro.v})):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_capacity_moe_on_card(dev, mesh11, cf):
    """The expert-parallel moe_ffn on the card: its dropped set is the
    capacity rule over the card's routing; with nothing dropped it is the
    dropless path in another summation order."""
    from repro_torch.launch.mesh import shard_tree
    from repro_torch.models.common import P, Dist
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              capacity_factor=cf)
    dist = Dist(mesh11, batch_axes=("data",))
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    lay, spec = params["layers"], lm.param_specs(cfg, dist)["layers"]
    p = {"router": lay["router"][0], "w13": lay["moe_w13"][0],
         "w2": lay["moe_w2"][0]}
    sp = {k: shard_tree(v, P(*spec[key][1:]), mesh11) for (k, v), key in
          zip(p.items(), ("router", "moe_w13", "moe_w2"))}
    x = torch.randn((2, 512, cfg.d_model), device=dev,
                    generator=torch.Generator(dev).manual_seed(2))
    with torch.no_grad():
        out, _, dropped = moe.moe_ffn(cfg, sp, shard_tree(
            x, P("data", None, None), mesh11), mesh11, ("data",),
            return_dropped=True)
        ref = moe.moe_ffn(cfg, p, x)[0]
        idx = moe.router_topk(x, p["router"], cfg.top_k)[0]
    C = moe.capacity(cfg, x.shape[0] * x.shape[1])
    flat, seen = idx.reshape(-1).cpu().numpy(), np.zeros(cfg.n_experts, int)
    want = np.zeros(flat.shape, np.int32)
    for a, e in enumerate(flat):
        want[a] = seen[e] >= C
        seen[e] += 1
    np.testing.assert_array_equal(dropped.to_local().reshape(-1).cpu(), want)
    if cf > 1:
        assert want.sum() == 0
        got = out.to_local()
        assert float((got - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())
    else:
        assert want.mean() >= 0.1


# ------------------------------------------------ K2's decode with stats
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,Lq,D,causal", [
    (32, 8, 1, 64, False), (8, 8, 1, 64, False), (8, 4, 1, 128, False),
    (8, 2, 4, 64, True), (4, 1, 2, 32, True),
    (16, 16, 1, 128, False)])
def test_flash_decode_stats_match_plain(dev, dtype, Hq, Hkv, Lq, D, causal):
    """Every decode branch with stats: the fp32 output, M and L against
    the kernel's plain mirror with stats; the output is the plain
    kernel's call's in q's dtype bit for bit; a row with no live key has
    M = -inf, L = 0 and output 0; two launches are bit-equal."""
    from repro_torch.kernels.flash_attention import (
        decode_split, flash_decode_split_plain)
    B = len(SPLIT_KV_LENS)
    q, k, v = _flash_inputs(dev, B, Hq, Hkv, Lq, 300, D, dtype, seed=Lq)
    kl = torch.tensor(SPLIT_KV_LENS, dtype=torch.int32, device=dev)
    before = (flash_attention.stats_launches,
              flash_attention.launches_by_path["decode"])
    got = flash_attention(q, k, v, kl, causal=causal, return_stats=True)
    again = flash_attention(q, k, v, kl, causal=causal, return_stats=True)
    torch.cuda.synchronize()
    assert (flash_attention.stats_launches,
            flash_attention.launches_by_path["decode"]) == (
        before[0] + 2, before[1] + 2)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    o, M, L = got
    assert o.dtype == M.dtype == L.dtype == torch.float32
    ref = flash_decode_split_plain(q, k, v, kl, decode_split(D, dtype),
                                   causal, return_stats=True)
    tol = FLASH_TOL[dtype] if dtype == torch.float32 else 1e-5
    for a, b in zip(got, (r.to(dev) for r in ref)):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
    assert torch.equal(o.to(dtype), flash_attention(q, k, v, kl,
                                                    causal=causal))
    assert torch.equal(o[0], torch.zeros_like(o[0]))
    assert bool((M[0] == float("-inf")).all()) and bool((L[0] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slices", [1, 2, 4, 16])
def test_flash_split_and_combine_match_whole_cache(dev, dtype, slices):
    """llama's decode shapes (32/8 heads of 64, 8 rows over 2048 keys) cut
    into slices, each through K2 with stats, merged: within the
    reference's tolerance of the whole-cache kernel, bit-equal twice, one
    slice the whole-cache kernel's bits."""
    from repro_torch.kernels.flash_attention import combine_decode_partials
    q, k, v = _flash_inputs(dev, 8, 32, 8, 1, 2048, 64, dtype, seed=3)
    kl = torch.tensor([0, 1, 100, 127, 128, 1000, 1057, 2048],
                      dtype=torch.int32, device=dev)
    w = 2048 // slices

    def split():
        parts = [flash_attention(
            q, k[:, :, i * w:(i + 1) * w], v[:, :, i * w:(i + 1) * w],
            (kl - i * w).clamp(0, w).to(torch.int32), causal=False,
            return_stats=True) for i in range(slices)]
        return combine_decode_partials(*zip(*parts))
    got, again = split(), split()
    whole = flash_attention(q, k, v, kl, causal=False)
    assert torch.equal(got, again)
    scale = float(whole.float().abs().max())
    tol = 2e-5 if dtype == torch.float32 else 2e-2 * scale
    assert float((got - whole.float()).abs().max()) <= tol
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    if slices == 1:
        assert torch.equal(got.to(dtype), whole)


def _serve_prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, size=int(rng.integers(4, 40)))
            for _ in range(6)]


def test_mesh_decode_and_engine_bit_equal_on_card(dev, mesh11):
    """On the 1x1 mesh a prefill then 4 decode steps, and ServeEngine with
    ``dist``, equal the mesh-free path bit for bit (the decode kernel,
    no launch with stats)."""
    from repro_torch.launch.mesh import shard_tree
    from repro_torch.models.common import P
    cfg, dist, params, batch, placed, pbatch = _mesh_case(dev, mesh11)
    stats = flash_attention.stats_launches
    with torch.no_grad():
        _, rc = lm.prefill(cfg, params, {"tokens": batch["tokens"]}, 160)
        _, gc = lm.prefill(cfg, placed, {"tokens": pbatch["tokens"]}, 160,
                           dist)
        for i in range(4):
            tok = batch["tokens"][:, i:i + 1]
            rl, rc = lm.decode_step(cfg, params, tok, rc)
            gl, gc = lm.decode_step(cfg, placed, shard_tree(
                tok, P("data", None), mesh11), gc, dist)
            assert torch.equal(gl.to_local(), rl)
    for key in ("k", "v", "len"):
        assert torch.equal(gc[key].to_local(), rc[key]), key
    runs = []
    for kw in ({}, {"dist": dist}):
        eng = ServeEngine(cfg, params, slots=4, max_len=96, device=dev, **kw)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=8, eos_id=-1)
                for i, p in enumerate(_serve_prompts(cfg.vocab))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        runs.append([r.out_tokens for r in reqs])
    assert runs[0] == runs[1]
    assert flash_attention.stats_launches == stats


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b",
                                  "seamless-m4t-medium"])
def test_mesh_family_step_bit_equal_on_card(dev, mesh11, arch):
    """One step of each family on the 1x1 mesh at the smoke width (bf16):
    the forward, a prefill and a decode step, and one jit_train_step
    (loss and parameters) equal the mesh-free path bit for bit."""
    from repro_torch.launch.mesh import full_tree, shard_tree
    from repro_torch.models.common import P, Dist
    from repro_torch.train.step import jit_train_step
    cfg = dataclasses.replace(get_smoke_config(arch), head_dim=64)
    dist = Dist(mesh11, batch_axes=("data",))
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    gen = torch.Generator(dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 160), device=dev, generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (2, cfg.frontend_len, cfg.frontend_dim), device=dev,
            generator=gen)
    spec = {k: P("data", *([None] * (v.dim() - 1))) for k, v in batch.items()}
    specs = lm.param_specs(cfg, dist)
    placed = shard_tree(params, specs, mesh11)
    pbatch = {k: shard_tree(v, spec[k], mesh11) for k, v in batch.items()}
    serve = {k: v for k, v in batch.items() if k != "labels"}
    pserve = {k: v for k, v in pbatch.items() if k != "labels"}
    with torch.no_grad():
        assert torch.equal(lm.forward(cfg, placed, pbatch, dist)[0]
                           .to_local(), lm.forward(cfg, params, batch)[0])
        _, rc = lm.prefill(cfg, params, serve, 176)
        _, gc = lm.prefill(cfg, placed, pserve, 176, dist)
        tok = tokens[:, :1]
        rl, rc = lm.decode_step(cfg, params, tok, rc)
        gl, gc = lm.decode_step(cfg, placed, shard_tree(
            tok, P("data", None), mesh11), gc, dist)
        assert torch.equal(gl.to_local(), rl)
        for key in rc:
            assert torch.equal(gc[key].to_local(), rc[key]), key
    opt_cfg = optim.for_model(cfg)
    rp = optim.tree_map(lambda t: t.clone(), params)
    rp, _, _, rm = make_train_step(cfg, opt_cfg)(
        rp, init_opt_state(opt_cfg, rp), None, batch)
    step = jit_train_step(cfg, dist, specs, opt_cfg, batch_specs=spec)
    gp, _, _, gm = step(placed, init_opt_state(opt_cfg, placed), None, batch)
    assert torch.equal(gm["loss"].to_local(), rm["loss"])
    for a, b in zip(optim.leaves(full_tree(gp)), optim.leaves(rp)):
        assert torch.equal(a, b)


# ------------------------------------- the serving engine's CUDA graphs
GRAPH_ARCHS = ["llama3.2-1b", "deepseek-moe-16b", "zamba2-1.2b",
               "xlstm-1.3b", "internvl2-2b"]


def _graph_serve(cfg, params, dev, graphs, **kw):
    """The smoke traffic of the serving tests (5 prompts over 2 slots, a
    freed slot taken again) through one engine (``kw``: its other
    arguments, ``dist``): (engine, tokens, each tick's logits copied, K2
    and grouped GEMM launches)."""
    eng = ServeEngine(cfg, params, slots=2, max_len=64, device=dev,
                      graphs=graphs, **kw)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(1, 400, size=n), eos_id=-1,
                    max_new_tokens=6) for i, n in enumerate((20, 17, 30, 25,
                                                             40))]
    for r in reqs:
        eng.submit(r)
    k2 = dict(flash_attention.launches_by_path)
    routes = dict(moe.grouped_gemm.launches_by_route)
    logits = []
    while eng.queue or any(r is not None for r in eng.live):
        ticks = eng.stats.ticks
        eng.tick()
        if eng.stats.ticks > ticks:
            logits.append(eng.steps["decode"].out[0].clone())
    torch.cuda.synchronize()
    launched = ({k: flash_attention.launches_by_path[k] - k2[k] for k in k2},
                {k: moe.grouped_gemm.launches_by_route[k] - routes[k]
                 for k in routes})
    return eng, [r.out_tokens for r in reqs], logits, launched


@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_graph_engine_bit_equal_to_eager_engine(dev, arch):
    """Each decoder-only family at the smoke width in bf16 (head dim 64
    where it attends):
    the engine as users get it resolves to CUDA graphs, and its tokens and
    every tick's logits are bit-equal to the eager engine's on the same
    weights; one decode step and one prefill step per bucket built (none
    for the exact-length families); K2 and the grouped GEMM counted per
    replay exactly as the eager engine counts its launches."""
    cfg = get_smoke_config(arch)
    if cfg.family != "ssm":
        cfg = dataclasses.replace(cfg, head_dim=64)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    graph = _graph_serve(cfg, params, dev, None)
    eager = _graph_serve(cfg, params, dev, False)
    assert graph[0].graphs is True and eager[0].graphs is False
    assert graph[1] == eager[1]
    assert len(graph[2]) == len(eager[2]) == graph[0].stats.ticks
    assert all(torch.equal(a, b) for a, b in zip(graph[2], eager[2]))
    bucketed = cfg.family in ("dense", "moe")
    buckets = {ServeEngine._bucket(n) for n in (20, 17, 30, 25, 40)}
    assert graph[0].trace_counts == eager[0].trace_counts == {
        "prefill": len(buckets) if bucketed else 0, "decode": 1}
    assert graph[3] == eager[3]
    assert all(s.graph is not None for s in graph[0].steps.values())
    assert sum(s.pool_bytes for s in graph[0].steps.values()) > 0


def test_flash_decode_and_grouped_gemm_captured_alone(dev):
    """K2's decode (8 slots over a 2048-position cache, ragged kv_len) and
    the bf16 grouped GEMM, each captured alone in a Step and replayed
    twice with new inputs copied into its buffers: bit-equal to eager
    calls, and each replay adds the launches the capture recorded (the
    capture itself adds none)."""
    from repro_torch.step import Step
    q, k, v = _flash_inputs(dev, 8, 32, 8, 1, 2048, 64, torch.bfloat16)
    kl = torch.tensor([64, 1056, 300, 1, 777, 2048, 129, 500],
                      dtype=torch.int32, device=dev)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((96, 64), generator=gen).to(dev, torch.bfloat16)
    w = torch.randn((4, 64, 48), generator=gen).to(dev, torch.bfloat16)
    sizes = torch.tensor([30, 0, 41, 20], device=dev)
    cases = [
        (lambda q, kl: flash_attention(q, k, v, kl, causal=False),
         {"q": q.clone(), "kl": kl.clone()},
         lambda: flash_attention.launches_by_path["decode"]),
        (lambda x, sizes: moe.grouped_gemm(x, w, sizes),
         {"x": x.clone(), "sizes": sizes.clone()},
         lambda: moe.grouped_gemm.launches_by_route["grouped_mm"])]
    for fn, inputs, count in cases:
        base = {key: t.clone() for key, t in inputs.items()}
        step = Step("alone", fn, inputs, torch.cuda.graph_pool_handle())
        n = count()
        first = step().clone()                  # eager, then the capture
        assert step.graph is not None and count() == n + 1
        for scale in (0.5, 2.0):
            new = {key: (t * scale).to(t.dtype) if t.is_floating_point()
                   else t for key, t in base.items()}
            for key, t in new.items():
                step.inputs[key].copy_(t)
            n = count()
            out = step().clone()
            assert count() == n + 1
            torch.cuda.synchronize()
            assert torch.equal(out, fn(**new))
        assert not torch.equal(first, out)


def test_failed_capture_raises(dev):
    """A step that reads the card's values to the host cannot be captured:
    its first call runs, then the capture raises; nothing falls back."""
    from repro_torch.step import Step
    step = Step("reads", lambda t: t * int(t.sum()),
                {"t": torch.ones(4, device=dev)},
                torch.cuda.graph_pool_handle())
    with pytest.raises(RuntimeError, match="capture failed"):
        step()
    assert step.graph is None


def test_fp32_moe_engine_stays_eager(dev, mesh11):
    """The fp32 MoE's grouped GEMM reads the host: its engine resolves to
    eager and graphs=True raises; under the NCCL mesh graphs=True builds
    graphs (since the meshed steps are captured)."""
    from repro_torch.models.common import Dist
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              dtype=torch.float32)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    assert ServeEngine(cfg, params, slots=2, max_len=32,
                       device=dev).graphs is False
    with pytest.raises(ValueError, match="reads the host"):
        ServeEngine(cfg, params, slots=2, max_len=32, device=dev,
                    graphs=True)
    cfg = get_smoke_config("llama3.2-1b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    eng = ServeEngine(cfg, params, slots=2, max_len=32, device=dev,
                      dist=Dist(mesh11, batch_axes=("data",)), graphs=True)
    req = Request(uid=0, prompt=np.arange(1, 8), max_new_tokens=4,
                  eos_id=-1)
    eng.submit(req)
    eng.run()
    assert eng.graphs is True and len(req.out_tokens) == 4
    assert eng.trace_counts == {"prefill": 1, "decode": 1}
    assert all(s.graph is not None for s in eng.steps.values())


# ------------------------------------------- the GNN path's compiled steps
def _gnn_graph_plan(seed=0, n=600, links=2500, P=4, slack=0.5):
    g = synthetic_siot(n=n, target_links=links)
    plan = compile_plan(g, partition_from_assign(
        g, random_layout(_cost_model(g, P), seed=seed), P, {}), slack=slack)
    return g, plan


def _no_sync(fn, *args, **kw):
    """``fn`` run with the card's sync debug mode at "error": any op that
    reads the device from the host raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("replicas", [False, True])
@pytest.mark.parametrize("exchange", ["ppermute", "allgather"])
@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_gnn_bsp_forward_graph_equals_eager(dev, model, exchange, replicas):
    """The captured BSP forward (one trace, one build) bit-equal to the
    eager forward over two inputs, the first result surviving the second
    replay, K1 launched num_layers times a replay for GCN/SAGE (0 for
    GAT), and the eager forward free of host reads."""
    g, plan = _gnn_graph_plan()
    if replicas:
        TP.set_replication(plan, {0: np.arange(40, 90), 2: np.arange(100,
                                                                     160)})
    cfg = GNNConfig(model, (52, 16, 2))
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    graph = make_bsp_forward(cfg, plan, exchange=exchange, device=dev)
    eager = make_bsp_forward(cfg, plan, exchange=exchange, device=dev,
                             graphs=False)
    assert graph.graphs is True and eager.graphs is False
    feats = [g.features, g.features * 0.5 + 0.25]
    blocks = [torch.from_numpy(TP.scatter_features(plan, f)).to(dev)
              for f in feats]
    r0 = [torch.from_numpy(TP.scatter_replica_halo(plan, f)).to(dev)
          if replicas else None for f in feats]
    want = [eager(params, b, replica0=r) for b, r in zip(blocks, r0)]
    first = graph(params, blocks[0], replica0=r0[0])     # eager, captured
    per = cfg.num_layers if model != "gat" else 0
    sums = 2 * cfg.num_layers if model == "gat" else 0   # K3: denom, num
    outs = []
    for b, r in zip(blocks, r0):
        n, k3 = spmm.launches, dict(segment_sum_k3.launches_by_path)
        outs.append(graph(params, b, replica0=r))
        torch.cuda.synchronize()
        assert spmm.launches - n == per
        assert segment_sum_k3.launches_by_path == {
            "plan": k3["plan"] + sums, "device": k3["device"]}
    assert torch.equal(first, want[0])
    assert torch.equal(outs[0], want[0]) and torch.equal(outs[1], want[1])
    assert not torch.equal(outs[0], outs[1])
    assert graph.stats["traces"] == graph.stats["builds"] == 1
    step, = graph.steps.values()
    assert step.graph is not None and step.capture_s > 0
    assert torch.equal(_no_sync(eager.eager, params, blocks[1],
                                replica0=r0[1]), want[1])


def test_gnn_bsp_graph_over_patches(dev):
    """Value-only patches replay with 0 new traces and read the refreshed
    plan (bit-equal to a fresh plan's eager forward); a capacity overflow
    rebuilds and captures once (1 build, 1 trace); on both aggregates."""
    g, plan = _gnn_graph_plan(slack=0.3)
    for model, agg in (("gcn", "bsr"), ("sage", "segment"),
                       ("gat", "segment")):
        work = TP.recompile_like(plan, g, plan.assign)
        cfg = GNNConfig(model, (52, 16, 2))
        params = init_params(cfg, torch.Generator().manual_seed(1),
                             device=dev)
        fwd = make_bsp_forward(cfg, work, aggregate=agg, device=dev)
        blocks = torch.from_numpy(TP.scatter_features(work, g.features)).to(
            dev)
        fwd(params, blocks)
        rng = np.random.default_rng(3)
        for k in range(4):
            new = work.assign.copy()
            if k == 3:
                new[: g.n // 2] = 0                 # capacities grow
            else:
                movers = rng.choice(g.n, size=3, replace=False)
                new[movers] = (new[movers] + 1) % work.num_parts
            delta = TP.patch_plan(work, g, new)
            traces, builds = fwd.stats["traces"], fwd.stats["builds"]
            blocks = torch.from_numpy(TP.scatter_features(work, g.features)
                                      ).to(dev)
            out = fwd(params, blocks)
            out2 = fwd(params, blocks)
            grew = int(delta.retrace_expected)
            assert fwd.stats["traces"] - traces == grew, (model, k)
            assert fwd.stats["builds"] - builds == grew, (model, k)
            fresh = TP.recompile_like(work, g, new)
            want = make_bsp_forward(cfg, fresh, aggregate=agg, device=dev,
                                    graphs=False)(params, blocks)
            assert torch.equal(out, want) and torch.equal(out2, want)
        assert grew == 1


@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_gnn_train_step_graph_equals_eager(dev, model):
    """Five captured train steps bit-equal to five eager ones, K1's
    launches and K3's sums a replay exact both ways, the eager step free
    of host reads, and after a value-only patch (the targets moved by
    ``set_targets``) the same graph's replay reads the new plan: bit-equal
    to a fresh plan's eager step."""
    g, cfg, params, fwd, step, blocks = _train_case(dev, model, "ppermute")
    eager_fwd = make_bsp_forward(cfg, fwd.plan, device=dev, graphs=False)
    labels = TP.scatter_ints(fwd.plan, g.labels)
    mask = TP.scatter_ints(fwd.plan, np.ones(g.n, np.float32))
    eager = make_distributed_train_step(cfg, eager_fwd, labels, mask, lr=0.1)
    assert step.graphs is True and eager.graphs is False
    p, q = params, params
    for _ in range(5):
        before = dict(spmm.launches_by_dir)
        k3 = dict(segment_sum_k3.launches_by_path)
        p, loss = step(p, blocks)
        torch.cuda.synchronize()
        got = {k: spmm.launches_by_dir[k] - before[k] for k in before}
        k3_replay = {k: segment_sum_k3.launches_by_path[k] - k3[k]
                     for k in k3}
        k3 = dict(segment_sum_k3.launches_by_path)
        q, want = eager(q, blocks)
        k3_eager = {k: segment_sum_k3.launches_by_path[k] - k3[k]
                    for k in k3}
        assert torch.equal(loss, want)
        assert got == ({"fwd": 2, "bwd": 1} if model != "gat"
                       else {"fwd": 0, "bwd": 0})
        assert k3_replay == k3_eager        # K3 counted per replay
        # GAT's forward sums over the plan's order; over a device sort the
        # layer-2 exchange's adjoint (a sum a round) and GAT's four per-arc
        # gathers' a layer
        rounds = len(fwd.plan.rounds)
        assert k3_replay == ({"plan": 4, "device": rounds + 8}
                             if model == "gat"
                             else {"plan": 0, "device": rounds})
    for a, b in zip(p, q):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    _no_sync(eager, q, blocks)
    new = fwd.plan.assign.copy()
    movers = np.random.default_rng(5).choice(g.n, size=3, replace=False)
    new[movers] = (new[movers] + 1) % fwd.plan.num_parts
    captured, = step.steps.values()
    assert not TP.patch_plan(fwd.plan, g, new).retrace_expected
    blocks = torch.from_numpy(TP.scatter_features(fwd.plan, g.features)).to(
        dev)
    step.set_targets(TP.scatter_ints(fwd.plan, g.labels),
                     TP.scatter_ints(fwd.plan, np.ones(g.n, np.float32)))
    fresh = TP.recompile_like(fwd.plan, g, new)
    ref = make_distributed_train_step(
        cfg, make_bsp_forward(cfg, fresh, device=dev, graphs=False),
        TP.scatter_ints(fresh, g.labels),
        TP.scatter_ints(fresh, np.ones(g.n, np.float32)), lr=0.1)
    a, la = step(p, blocks)
    b, lb = ref(p, blocks)
    assert torch.equal(la, lb)
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert fwd.stats["builds"] == 1
    assert list(step.steps.values()) == [captured]      # replayed


@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_gnn_ego_forward_graph_equals_eager(dev, model):
    """The serving engine with one CUDA graph a bucket against the eager
    engine: every answer bit-equal, the same traces, one capture a trace;
    and the eager ego forward free of host reads given its segments."""
    from repro_torch.gnn.serving import (
        GNNServeEngine, ego_segments, ego_tables, extract_ego_batch,
        zipf_requests)
    g, plan = _gnn_graph_plan()
    cfg = GNNConfig(model, (52, 16, 2))
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    targets = zipf_requests(g.n, 100, s=1.1, seed=0)
    outs = {}
    for graphs in (True, False):
        eng = GNNServeEngine(cfg, params, g, plan, hops=2, batch=16,
                             device=dev, graphs=graphs)
        assert eng.fwd.graphs is graphs
        outs[graphs] = (eng.serve(targets), eng.fwd.stats["traces"],
                        eng.fwd.captures())
    assert np.array_equal(outs[True][0], outs[False][0])
    assert outs[True][1] == outs[False][1] == outs[True][2] > 1
    assert outs[False][2] == 0
    ego = extract_ego_batch(g, targets[:16], 2, batch=16)
    feats, deg, rows = ego_tables(ego, g.features,
                                  g.degrees.astype(np.float32))
    args = [torch.from_numpy(a).to(dev) for a in (feats, ego.arcs, deg,
                                                  rows)]
    seg = [torch.from_numpy(a).to(dev) for a in ego_segments(ego, model)]
    eng.fwd(*args, segments=seg)
    _no_sync(eng.fwd, *args, segments=seg)


def test_gnn_failed_capture_raises(dev, monkeypatch):
    """A BSP forward whose body reads the card to the host: its first
    call runs, the capture raises, and so does the next call; nothing
    falls back to eager running."""
    from repro_torch.gnn import distributed as TD
    g, plan = _gnn_graph_plan()
    cfg = GNNConfig("gcn", (52, 16, 2))
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    real = TD._bsp_forward
    monkeypatch.setattr(TD, "_bsp_forward", lambda *a, **kw: real(
        *a, **kw) * float(a[2].sum() > -1))
    fwd = make_bsp_forward(cfg, plan, device=dev)
    blocks = torch.from_numpy(TP.scatter_features(plan, g.features)).to(dev)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture failed"):
            fwd(params, blocks)
    step, = fwd.steps.values()
    assert step.graph is None


# ------------------------------------------ tracing inside the GNN graphs
GNN_LAYER = {"gcn": ["exchange", "aggregate", "dense"],
             "gat": ["exchange", "attention", "messages", "dense"]}


def _mark_kernels(fn, *args):
    """How many mark kernels ``fn(*args)`` ran on the card."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    return sum("mark_kernel" in e.name for e in prof.events())


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_gnn_marked_graphs_mark_each_replay_and_keep_the_bits(dev, model):
    """With tracing on the BSP forward and the train step capture marked
    graphs beside their unmarked ones: each replay writes one set of
    marks in the documented order, its outputs equal the unmarked
    graph's bit for bit, K1's launches a replay and the steps'
    ``per_replay`` are the same, and the unmarked graphs run no mark
    kernel."""
    from repro_torch import tracing
    g, cfg, params, fwd, step, blocks = _train_case(dev, model, "ppermute")
    runs = {}
    try:
        for on in (False, True):
            (tracing.enable if on else tracing.disable)()
            fwd(params, blocks)                 # eager, then captured
            step(params, blocks)
            tracing.clear()
            before = dict(spmm.launches_by_dir)
            outs = [fwd(params, blocks), step(params, blocks)]
            outs.append(step(outs[1][0], blocks))
            torch.cuda.synchronize()
            launches = {k: spmm.launches_by_dir[k] - before[k]
                        for k in before}
            marks = tracing.read()["marks"].get(str(dev), [])
            steps = (fwd.marked_steps if on else fwd.steps,
                     step.marked_steps if on else step.steps)
            per = [s.per_replay for d in steps for s in d.values()]
            runs[on] = outs, launches, marks, per
            kernels = (_mark_kernels(fwd, params, blocks),
                       _mark_kernels(step, params, blocks))
            if on:
                marked = kernels
            else:
                assert kernels == (0, 0)
    finally:
        tracing.disable()
        tracing.clear()
    (off, l_off, m_off, p_off), (on, l_on, m_on, p_on) = runs[False], runs[
        True]
    assert m_off == []
    layers = GNN_LAYER[model] * 2
    fwd_marks = ["write", "launch", "step", *layers, "exit", "clone",
                 "idle"]
    train_marks = ["write", "launch", "step", *layers, "loss", "backward",
                   "sgd", "exit", "clone", "idle"]
    assert [p for p, _ in m_on] == fwd_marks + train_marks * 2
    times = [t for _, t in m_on]
    assert times == sorted(times)
    assert marked == (len(fwd_marks), len(train_marks))
    assert torch.equal(off[0], on[0])
    for (pa, la), (pb, lb) in zip(off[1:], on[1:]):
        assert torch.equal(la, lb)
        for a, b in zip(pa, pb):
            for k in a:
                assert torch.equal(a[k], b[k]), k
    assert l_off == l_on == ({"fwd": 6, "bwd": 2} if model == "gcn"
                             else {"fwd": 0, "bwd": 0})
    assert p_off == p_on
    assert fwd.stats["traces"] == fwd.stats["builds"] == 1


# --------------------------- the LM train step and the whole-graph GNN steps
def _train_graph_case(dev, arch):
    """A 2-layer bf16 model with head dim 64 (K2 on ``prefill_tc`` and the
    ``tc`` backward), every layer checkpointed: llama, or deepseek's
    dense layer and one MoE layer (its grouped GEMMs on ``grouped_mm``)."""
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=2,
                              head_dim=64, remat=True)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at_step(
        cfg, ShapeCfg("t", 128, 4, "train"), 0).items()}
    return cfg, batch


def _train_state(cfg, opt, dev, compress):
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    ef = (optim.tree_map(torch.zeros_like, params) if compress else None)
    return params, init_opt_state(opt, params), ef


def _state_tensors(p, o, e):
    return (optim.leaves(p) + optim.leaves(o.m) + optim.leaves(o.v)
            + [o.step] + (optim.leaves(e) if e is not None else []))


def _launches():
    return (dict(flash_attention.launches_by_path),
            dict(flash_attention.backward_launches_by_path),
            dict(moe.grouped_gemm.launches_by_route),
            dict(moe.grouped_gemm.backward_launches_by_route))


def _since(before):
    return [{k: d[k] - b.get(k, 0) for k in d if d[k] - b.get(k, 0)}
            for d, b in zip(_launches(), before)]


@pytest.mark.parametrize("arch,mbs,compress", [
    ("llama3.2-1b", 1, False), ("llama3.2-1b", 2, True),
    ("deepseek-moe-16b", 1, False), ("deepseek-moe-16b", 2, True)])
def test_lm_train_graph_equals_eager(dev, arch, mbs, compress):
    """Three steps of the captured train step bit-equal to three eager
    ones (``graphs=False``) from the same state: loss, grad norm and every
    parameter, moment, step and error-feedback leaf; the step returns the
    tensors it was given; K2's and the grouped GEMM's launches per replay
    equal the eager step's; one step built; and the eager step free of
    host reads."""
    cfg, batch = _train_graph_case(dev, arch)
    opt = OptConfig(lr=1e-3)
    runs = {}
    for graphs in (False, True):
        step = make_train_step(cfg, opt, microbatches=mbs,
                               compress_grads=compress, graphs=graphs)
        state = _train_state(cfg, opt, dev, compress)
        ids = [id(t) for t in _state_tensors(*state)]
        seen = []
        for _ in range(3):
            before = _launches()
            p, o, e, m = step(*state, batch)
            torch.cuda.synchronize()
            seen.append((m["loss"].clone(), m["grad_norm"].clone(),
                         [t.clone() for t in _state_tensors(p, o, e)],
                         _since(before)))
            assert [id(t) for t in _state_tensors(p, o, e)] == ids
            state = (p, o, e)
        assert step.graphs is graphs
        runs[graphs] = seen, step, state
    (eager, _, state), (graph, step, _) = runs[False], runs[True]
    for (la, ga, ta, ca), (lb, gb, tb, cb) in zip(eager, graph):
        assert torch.equal(la, lb) and torch.equal(ga, gb)
        assert all(torch.equal(a, b) for a, b in zip(ta, tb))
        assert ca == cb and ca[0].get("prefill_tc") and ca[1].get("tc")
        if arch == "deepseek-moe-16b":
            assert ca[2].get("grouped_mm") and ca[3].get("grouped_mm")
    captured, = step.steps.values()
    assert captured.graph is not None and captured.pool_bytes > 0
    _no_sync(runs[False][1], *state, batch)


def test_lm_train_graph_resume_copies_state_in(dev):
    """A captured step called with other state tensors (a restored
    checkpoint's) copies them into its buffers once and returns its own
    tensors, updated as the eager step updates the given ones; the same
    graph replays."""
    cfg, batch = _train_graph_case(dev, "llama3.2-1b")
    opt = OptConfig(lr=1e-3)
    step = make_train_step(cfg, opt)
    state = _train_state(cfg, opt, dev, False)
    for _ in range(2):
        state = step(*state, batch)[:3]
    captured, = step.steps.values()
    restored = optim.tree_map(torch.clone, state[0]), optim.OptState(
        state[1].step.clone(), optim.tree_map(torch.clone, state[1].m),
        optim.tree_map(torch.clone, state[1].v)), None
    want = make_train_step(cfg, opt, graphs=False)(
        *(optim.tree_map(torch.clone, restored[0]), optim.OptState(
            restored[1].step.clone(), optim.tree_map(torch.clone,
                                                     restored[1].m),
            optim.tree_map(torch.clone, restored[1].v)), None), batch)
    got = step(*restored, batch)
    assert list(step.steps.values()) == [captured]
    assert all(a is b for a, b in zip(_state_tensors(*got[:3]),
                                       _state_tensors(*state)))
    assert torch.equal(got[3]["loss"], want[3]["loss"])
    assert all(torch.equal(a, b) for a, b in zip(
        _state_tensors(*got[:3]), _state_tensors(*want[:3])))


def test_lm_train_failed_capture_raises(dev):
    """A train step whose loss reads the card to the host: its first call
    runs, the capture raises, and so does the next call; nothing falls
    back to eager running."""
    cfg, batch = _train_graph_case(dev, "llama3.2-1b")

    def loss_fn(p, b):
        loss = lm.loss_fn(cfg, p, b)
        return loss * float(loss > -1)

    step = make_train_step(cfg, loss_fn=loss_fn)
    state = _train_state(cfg, OptConfig(), dev, False)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture failed"):
            step(*state, batch)
    captured, = step.steps.values()
    assert captured.graph is None


def test_lm_train_graphs_refused_where_the_moe_reads_the_host(dev):
    """The fp32 MoE's grouped GEMM reads the host on the card: the train
    step resolves to eager, and graphs=True raises."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              dtype=torch.float32)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at_step(
        cfg, ShapeCfg("t", 32, 2, "train"), 0).items()}
    step = make_train_step(cfg)
    step(*_train_state(cfg, OptConfig(), dev, False), batch)
    assert step.graphs is False and step.steps == {}
    with pytest.raises(ValueError, match="reads the host"):
        make_train_step(cfg, graphs=True)(
            *_train_state(cfg, OptConfig(), dev, False), batch)


@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_gnn_whole_graph_train_graph_equals_eager(dev, model):
    """The whole-graph ``train_step`` from a CUDA graph bit-equal to the
    eager one over 5 steps, then over a permuted edge list of the same
    shape (the same graph replayed); ``predict`` from a graph equal to
    eager ``predict`` on both lists; one step a signature; the eager step
    free of host reads."""
    from repro_torch.gnn.models import predict
    from repro_torch.gnn.training import train_step
    g = synthetic_siot(n=600, target_links=2500)
    cfg = GNNConfig(model, (52, 16, 2))
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    feats = torch.from_numpy(g.features).to(dev)
    labels = torch.from_numpy(g.labels).to(dev).long()
    sd = torch.from_numpy(directed_edges(g.edges)).to(dev).long()
    perm = sd[torch.randperm(sd.shape[0], generator=torch.Generator(
        ).manual_seed(1)).to(dev)]
    train_step.steps.clear()
    predict.steps.clear()
    p, q = params, params
    for edges in [sd] * 5 + [perm]:
        p, loss = train_step(cfg, p, feats, edges, labels, 0.1, device=dev)
        q, want = train_step(cfg, q, feats, edges, labels, 0.1, device=dev,
                             graphs=False)
        assert torch.equal(loss, want)
        assert all(torch.equal(a[k], b[k]) for a, b in zip(p, q) for k in a)
        assert torch.equal(predict(cfg, p, feats, edges),
                           predict(cfg, p, feats, edges, graphs=False))
    assert len(train_step.steps) == len(predict.steps) == 2
    assert sum(s.graph is not None for s in train_step.steps.values()) == 1
    _no_sync(train_step, cfg, q, feats, sd, labels, 0.1, device=dev,
             graphs=False)
    train_step.steps.clear()
    predict.steps.clear()


# ------------------------------------ the compiled steps under the 1x1 mesh
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_mesh_graph_engine_bit_equal(dev, mesh11, arch):
    """Each decoder-only family at the smoke width in bf16 behind
    ``ServeEngine(dist=the 1x1 NCCL mesh)``: the engine resolves to CUDA
    graphs, and its tokens, every tick's logits, ``trace_counts`` and
    K2's (and the grouped GEMM's) launches per replay equal the meshed
    eager engine's; tokens and logits also equal the mesh-free engine's
    (but for the MoE, whose meshed layer is the capacity one)."""
    from repro_torch.models.common import Dist
    cfg = get_smoke_config(arch)
    if cfg.family != "ssm":
        cfg = dataclasses.replace(cfg, head_dim=64)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    dist = Dist(mesh11, batch_axes=("data",))
    graph = _graph_serve(cfg, params, dev, None, dist=dist)
    eager = _graph_serve(cfg, params, dev, False, dist=dist)
    assert graph[0].graphs is True and eager[0].graphs is False
    runs = [eager]
    if cfg.family != "moe":
        runs.append(_graph_serve(cfg, params, dev, False))
    for other in runs:
        assert graph[1] == other[1] and len(graph[2]) == len(other[2])
        assert all(torch.equal(a, b) for a, b in zip(graph[2], other[2]))
    assert graph[0].trace_counts == eager[0].trace_counts
    assert graph[3] == eager[3]
    assert all(s.graph is not None for s in graph[0].steps.values())


def _mesh_train_case(dev, mesh, compress, mbs, **kw):
    """jit_train_step of ``_train_graph_case``'s llama on ``mesh`` and a
    fresh seeded state laid out on it (copies: a 1x1 mesh's shards are the
    tensors given)."""
    from repro_torch.launch.mesh import shard_tree
    from repro_torch.models.common import Dist, P
    from repro_torch.train.step import jit_train_step
    cfg, batch = _train_graph_case(dev, "llama3.2-1b")
    opt = OptConfig(lr=1e-3)
    dist = Dist(mesh, batch_axes=("data",))
    specs = lm.param_specs(cfg, dist)
    step = jit_train_step(cfg, dist, specs, opt, microbatches=mbs,
                          compress_grads=compress,
                          batch_specs={k: P("data", None) for k in batch},
                          **kw)

    def state():
        p, o, e = _train_state(cfg, opt, dev, compress)
        p = shard_tree(p, specs, mesh)
        e = None if e is None else shard_tree(e, specs, mesh)
        return p, init_opt_state(opt, p), e

    return cfg, step, state, batch


@pytest.mark.parametrize("mbs,compress", [(1, False), (2, False),
                                          (2, True)])
def test_mesh_graph_train_step_equals_eager(dev, mesh11, mbs, compress):
    """Three steps of jit_train_step from a CUDA graph on the 1x1 NCCL mesh
    bit-equal to three eager meshed ones (``graphs=False``) from the same
    state: loss, grad norm and every parameter, moment, step and
    error-feedback leaf; the very DTensors given returned; K2's launches
    per replay equal the eager step's, both ways; one step built."""
    runs = {}
    for graphs in (False, None):
        _, step, state, batch = _mesh_train_case(dev, mesh11, compress, mbs,
                                                 graphs=graphs)
        state = state()
        ids = [id(t) for t in _state_tensors(*state)]
        seen = []
        for _ in range(3):
            before = _launches()
            p, o, e, m = step(*state, batch)
            torch.cuda.synchronize()
            seen.append((m["loss"].to_local().clone(),
                         m["grad_norm"].to_local().clone(),
                         [t.to_local().clone() if hasattr(t, "to_local")
                          else t.clone() for t in _state_tensors(p, o, e)],
                         _since(before)))
            assert [id(t) for t in _state_tensors(p, o, e)] == ids
            state = (p, o, e)
        assert step.step.graphs is (graphs is None)
        runs[graphs] = seen, step
    (eager, _), (graph, step) = runs[False], runs[None]
    for (la, ga, ta, ca), (lb, gb, tb, cb) in zip(eager, graph):
        assert torch.equal(la, lb) and torch.equal(ga, gb)
        assert all(torch.equal(a, b) for a, b in zip(ta, tb))
        assert ca == cb and ca[0].get("prefill_tc") and ca[1].get("tc")
    captured, = step.step.steps.values()
    assert captured.graph is not None and captured.pool_bytes > 0


def test_mesh_graph_train_resume_copies_state_in(dev, mesh11):
    """A captured meshed step called with other DTensor state (a restored
    checkpoint's) copies it into its buffers once and returns its own
    DTensors, updated as the eager meshed step updates the given ones; the
    same graph replays."""
    _, step, state, batch = _mesh_train_case(dev, mesh11, False, 1)
    _, eager, _, _ = _mesh_train_case(dev, mesh11, False, 1, graphs=False)
    first = state()
    for _ in range(2):
        first = step(*first, batch)[:3]
    captured, = step.step.steps.values()
    clone = lambda s: (optim.tree_map(torch.clone, s[0]),  # noqa: E731
                       optim.OptState(s[1].step.clone(),
                                      optim.tree_map(torch.clone, s[1].m),
                                      optim.tree_map(torch.clone, s[1].v)),
                       None)
    restored = clone(first)
    want = eager(*clone(restored), batch)
    got = step(*restored, batch)
    assert list(step.step.steps.values()) == [captured]
    assert all(a is b for a, b in zip(_state_tensors(*got[:3]),
                                       _state_tensors(*first)))
    assert torch.equal(got[3]["loss"].to_local(), want[3]["loss"].to_local())
    assert all(torch.equal(a.to_local(), b.to_local())
               if hasattr(a, "to_local") else torch.equal(a, b)
               for a, b in zip(_state_tensors(*got[:3]),
                               _state_tensors(*want[:3])))


def test_mesh_graph_failed_capture_raises(dev, mesh11):
    """Under the mesh a step that reads the card to the host runs once,
    then its capture raises, and so does the next call: a Step over a
    DTensor, and jit_train_step whose loss is read back."""
    from repro_torch.launch.mesh import shard_tree
    from repro_torch.models.common import Dist, P
    from repro_torch.step import Step
    t = shard_tree(torch.ones(4, device=dev), P(None), mesh11)
    step = Step("reads", lambda t: t * int(t.to_local().sum()), {"t": t},
                torch.cuda.graph_pool_handle())
    with pytest.raises(RuntimeError, match="capture failed"):
        step()
    assert step.graph is None
    dist = Dist(mesh11, batch_axes=("data",))
    cfg, _, state, batch = _mesh_train_case(dev, mesh11, False, 1)

    def loss_fn(p, b):
        loss = lm.loss_fn(cfg, p, b, dist)
        return loss * float(loss.to_local() > -1)

    _, step, _, _ = _mesh_train_case(dev, mesh11, False, 1, loss_fn=loss_fn)
    state = state()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture failed"):
            step(*state, batch)
    captured, = step.step.steps.values()
    assert captured.graph is None


def test_mesh_fp32_moe_resolves_to_eager(dev, mesh11):
    """The fp32 MoE under the 1x1 NCCL mesh: the engine and jit_train_step
    resolve to eager (``moe.reads_host``), and graphs=True raises."""
    from repro_torch.launch.mesh import shard_tree
    from repro_torch.models.common import Dist, P
    from repro_torch.train.step import jit_train_step
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              dtype=torch.float32)
    dist = Dist(mesh11, batch_axes=("data",))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    assert ServeEngine(cfg, params, slots=2, max_len=32, device=dev,
                       dist=dist).graphs is False
    with pytest.raises(ValueError, match="reads the host"):
        ServeEngine(cfg, params, slots=2, max_len=32, device=dev, dist=dist,
                    graphs=True)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_at_step(
        cfg, ShapeCfg("t", 32, 2, "train"), 0).items()}
    specs = lm.param_specs(cfg, dist)
    bspecs = {k: P("data", None) for k in batch}
    placed = shard_tree(params, specs, mesh11)
    step = jit_train_step(cfg, dist, specs, batch_specs=bspecs)
    step(placed, init_opt_state(optim.for_model(cfg), placed), None, batch)
    assert step.step.graphs is False and step.step.steps == {}
    with pytest.raises(ValueError, match="reads the host"):
        jit_train_step(cfg, dist, specs, batch_specs=bspecs, graphs=True)(
            placed, init_opt_state(optim.for_model(cfg), placed), None,
            batch)
