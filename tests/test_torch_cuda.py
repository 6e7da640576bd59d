"""Checks that need a CUDA card: the spmm_bsr kernel against its plain
torch version, the wrapper's input checks, and the port's card paths
against its CPU paths.  Without a card every test here skips.  The file
imports neither ``jax`` nor ``repro``, so it runs on a machine with the card
and the port alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import partition_from_assign, random_layout  # noqa: E402
from repro_torch.gnn import (  # noqa: E402
    GNNConfig, compile_plan, directed_edges, forward, init_params,
    simulate_bsp_forward)
from repro_torch.gnn.models import segment_sum  # noqa: E402
from repro_torch.graphs import synthetic_siot  # noqa: E402
from repro_torch.kernels import BSRAggregate, build_bsr, spmm, spmm_plain  # noqa: E402

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("P,n,arcs,bm,bk,d", [
    (1, 250, 1000, 8, 256, 128), (4, 3000, 20000, 8, 128, 52),
    (3, 500, 3000, 16, 128, 100), (2, 300, 2000, 4, 8, 13)])
def test_spmm_kernel_matches_plain_and_is_deterministic(dev, P, n, arcs, bm,
                                                        bk, d):
    args = [t.to(dev) for t in _bsr_case(n, P, n, arcs, bm, bk, d)]
    before = spmm.launches
    out = spmm(*args, bm, bk)
    again = spmm(*args, bm, bk)
    torch.cuda.synchronize()
    assert spmm.launches == before + 2
    assert torch.equal(out, again)
    ref = spmm_plain(*args, bm, bk)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= 1e-5 * scale + 1e-5
    unbatched = spmm(args[0][0], args[1][0], args[2][0], bm, bk)
    assert torch.equal(unbatched, out[0])


def test_spmm_wrapper_rejects_what_the_kernel_does_not_take(dev):
    v, c, f = [t.to(dev) for t in _bsr_case(1, 2, 100, 300, 8, 128, 16)]
    with pytest.raises(TypeError):
        spmm(v, c.long(), f, 8, 128)
    with pytest.raises(TypeError):
        spmm(v, c, f.double(), 8, 128)
    with pytest.raises(ValueError):
        spmm(v, c, f.transpose(1, 2).contiguous().transpose(1, 2), 8, 128)
    with pytest.raises(ValueError):
        spmm(v.cpu(), c, f, 8, 128)
    with pytest.raises(ValueError):
        spmm(v, c, f, 16, 64)


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
        g, random_layout(g.n, 4, seed=0), 4, {}), slack=0.5)
    cfg = GNNConfig(model, (52, 16, 2))
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    cpu_params = [{k: v.cpu() for k, v in p.items()} for p in params]
    before = spmm.launches
    out = simulate_bsp_forward(cfg, params, plan, g.features, device=dev)
    assert spmm.launches - before == (2 if model != "gat" else 0)
    ref = forward(cfg, cpu_params, torch.from_numpy(g.features),
                  directed_edges(g.edges)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
