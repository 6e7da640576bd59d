"""GNN training on the port against the JAX reference (CPU, small sizes).

Whole-graph ``train_step``/``fit`` against ``jax.value_and_grad`` of the
reference's ``loss_fn`` and its ``fit``; the distributed step over the
one-device BSP forward against the reference's whole-graph gradients and
its own ``make_distributed_train_step`` (4-device subprocess); K1's
backward (``transpose_packed`` and the autograd Function); ``gather_rows``;
the checkpoint format across both packages; and ``launch.train_gnn``.  The
card runs the same step through ``chip_smoke.py``'s ``train`` phase and
``tests/test_torch_cuda.py``."""
import functools
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.gnn import models as JM  # noqa: E402
from repro.gnn import training as JT  # noqa: E402
from repro.graphs.datagraph import synthetic_siot as j_siot  # noqa: E402
from repro.graphs.datagraph import synthetic_yelp as j_yelp  # noqa: E402
from repro.kernels import gnn_aggregate as JK  # noqa: E402
from repro.train import CheckpointManager as JCheckpointManager  # noqa: E402
from repro_torch.core import partition_from_assign  # noqa: E402
from repro_torch.gnn import distributed as TD  # noqa: E402
from repro_torch.gnn import models as TM  # noqa: E402
from repro_torch.gnn import plan as TP  # noqa: E402
from repro_torch.gnn import training as TT  # noqa: E402
from repro_torch.graphs import DataGraph  # noqa: E402
from repro_torch.kernels import gnn_aggregate as TK  # noqa: E402
from repro_torch.kernels.ops import BSRAggregate  # noqa: E402
from repro_torch.train import CheckpointManager  # noqa: E402
from tests.conftest import random_graph  # noqa: E402

TOL = {"gcn": 1e-5, "sage": 1e-5, "gat": 1e-4}   # test_torch_models.py
DIST_TOL = 2e-4                 # the reference's BSP gate (test_distributed_gnn)
FIT_LOSS_TOL = 1e-4             # per-step losses over 40 SGD steps
MODELS = ("gcn", "sage", "gat")


def _pair(model, dims, seed=0):
    jcfg = JM.GNNConfig(model, dims)
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return (jcfg, jp, TM.GNNConfig(model, dims),
            TM.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))


def _assert_grads_close(grads, ref, tol):
    for layer, ref_layer in zip(grads, ref):
        assert layer.keys() == ref_layer.keys()
        for k, g in layer.items():
            np.testing.assert_allclose(g.numpy(), np.asarray(ref_layer[k]),
                                       rtol=tol, atol=tol, err_msg=k)


def _mask(n, seed=3):
    return (np.random.default_rng(seed).random(n) < 0.6).astype(np.float32)


# --------------------------------------------------------------- whole graph
@pytest.mark.parametrize("model", MODELS)
def test_training_improves(model, small_yelp):
    """The reference's ``test_gnn_models.py::test_training_improves``, for
    each model on the port."""
    _, _, cfg, params = _pair(model, (100, 16, 2))
    sd = TM.directed_edges(small_yelp.edges)
    a0 = TT.accuracy(cfg, params, small_yelp.features, sd,
                     small_yelp.labels, device="cpu")
    params, losses = TT.fit(cfg, params, small_yelp.features, sd,
                            small_yelp.labels, steps=40, lr=0.1,
                            device="cpu")
    a1 = TT.accuracy(cfg, params, small_yelp.features, sd,
                     small_yelp.labels, device="cpu")
    assert losses[-1] < losses[0]
    assert a1 >= a0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("graph", ["small_siot", "small_yelp"])
@pytest.mark.parametrize("model", MODELS)
def test_one_step_matches_reference(model, graph, masked, request):
    g = request.getfixturevalue(graph)
    jcfg, jp, cfg, params = _pair(model, (g.features.shape[1], 16, 2))
    sd = JM.directed_edges(g.edges)
    mask = _mask(g.n) if masked else None
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jnp.asarray(g.features),
                             jnp.asarray(sd), jnp.asarray(g.labels),
                             None if mask is None else jnp.asarray(mask)))(jp)
    loss, grads = TT.loss_and_grads(cfg, params, g.features, sd, g.labels,
                                    mask, device="cpu")
    tol = TOL[model]
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=tol,
                               atol=tol)
    _assert_grads_close(grads, ref_grads, tol)
    lr = 0.1
    new, step_loss = TT.train_step(cfg, params, g.features, sd, g.labels, lr,
                                   mask, device="cpu")
    assert float(step_loss) == float(loss)
    for layer, p, gr in zip(new, params, grads):
        for k in p:                                  # p - lr * g, exactly
            assert torch.equal(layer[k], p[k] - lr * gr[k])
    assert all(not v.requires_grad for layer in new for v in layer.values())


@functools.lru_cache(maxsize=None)
def _reference_fit(model):
    g = j_yelp(n=120, target_links=160)
    jcfg, jp, _, _ = _pair(model, (100, 16, 2))
    sd = JM.directed_edges(g.edges)
    a0 = JT.accuracy(jcfg, jp, g.features, sd, g.labels)
    jp, losses = JT.fit(jcfg, jp, g.features, sd, g.labels, steps=40, lr=0.1)
    a1 = JT.accuracy(jcfg, jp, g.features, sd, g.labels)
    return np.asarray(losses), a0, a1


@pytest.mark.parametrize("model", MODELS)
def test_fit_40_steps_matches_reference(model, small_yelp):
    """Per-step losses of 40 SGD steps within 1e-4 of the reference's (the
    rounding difference grows with the step count); the two accuracies
    differ by at most one vertex."""
    ref_losses, ref_a0, ref_a1 = _reference_fit(model)
    _, _, cfg, params = _pair(model, (100, 16, 2))
    sd = TM.directed_edges(small_yelp.edges)
    a0 = TT.accuracy(cfg, params, small_yelp.features, sd,
                     small_yelp.labels, device="cpu")
    params, losses = TT.fit(cfg, params, small_yelp.features, sd,
                            small_yelp.labels, steps=40, lr=0.1,
                            device="cpu")
    a1 = TT.accuracy(cfg, params, small_yelp.features, sd,
                     small_yelp.labels, device="cpu")
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=FIT_LOSS_TOL)
    one = 1.0 / small_yelp.n + 1e-12
    assert abs(a0 - ref_a0) <= one and abs(a1 - ref_a1) <= one


def test_sgd_step_is_p_minus_lr_g():
    p = [{"w": torch.randn(3, 4)}, {"w": torch.randn(4, 2),
                                    "att_src": torch.randn(2)}]
    g = [{k: torch.randn_like(v) for k, v in layer.items()} for layer in p]
    new = TT.sgd_step(p, g, 0.3)
    for a, b, c in zip(new, p, g):
        for k in b:
            assert torch.equal(a[k], b[k] - 0.3 * c[k])


# ----------------------------------------------------------- distributed step
@functools.lru_cache(maxsize=None)
def _dist_case():
    g = j_siot(n=150, target_links=450)
    assign = np.random.default_rng(1).integers(0, 4, size=g.n)
    return g, assign, _mask(g.n)


def _port_step(model, exchange, agg, lr=0.05, seed=0):
    g, assign, mask = _dist_case()
    tg = DataGraph(n=g.n, edges=g.edges.copy(), features=g.features,
                   labels=g.labels)
    plan = TP.compile_plan(tg, partition_from_assign(tg, assign, 4, {}),
                           slack=0.25)
    jcfg, jp, cfg, params = _pair(model, (52, 16, 2), seed)
    fwd = TD.make_bsp_forward(cfg, plan, exchange=exchange, aggregate=agg,
                              device="cpu")
    step = TT.make_distributed_train_step(
        cfg, fwd, TP.scatter_ints(plan, g.labels),
        TP.scatter_ints(plan, mask), lr=lr)
    blocks = torch.from_numpy(TP.scatter_features(plan, g.features))
    return g, mask, jcfg, jp, params, fwd, step, blocks


@pytest.mark.parametrize("agg", ["segment", "bsr"])
@pytest.mark.parametrize("exchange", ["ppermute", "allgather"])
@pytest.mark.parametrize("model", MODELS)
def test_distributed_step_matches_whole_graph_reference(model, exchange, agg):
    g, mask, jcfg, jp, params, fwd, step, blocks = _port_step(
        model, exchange, agg)
    assert fwd.mode == ("segment" if model == "gat" else agg)
    sd = JM.directed_edges(g.edges)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jnp.asarray(g.features),
                             jnp.asarray(sd), jnp.asarray(g.labels),
                             jnp.asarray(mask)))(jp)
    loss, grads = step.loss_and_grads(params, blocks)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=DIST_TOL,
                               atol=DIST_TOL)
    _assert_grads_close(grads, ref_grads, DIST_TOL)
    new, step_loss = step(params, blocks)
    assert float(step_loss) == float(loss)
    for layer, p, gr in zip(new, params, grads):
        for k in p:
            assert torch.equal(layer[k], p[k] - 0.05 * gr[k])
    assert all(torch.isfinite(v).all() for layer in grads
               for v in layer.values())
    assert TK.spmm.launches == 0                   # CPU tensors never launch


_REF_STEP = textwrap.dedent("""
    import os
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
    import json
    import jax
    import numpy as np
    from repro.core.partition import partition_from_assign
    from repro.gnn import GNNConfig, init_params
    from repro.gnn.distributed import (compile_plan, make_bsp_forward,
                                       scatter_features, scatter_ints)
    from repro.gnn.training import make_distributed_train_step
    from repro.graphs.datagraph import synthetic_siot
    from repro.jaxcompat import make_mesh

    g = synthetic_siot(n=150, target_links=450)
    assign = np.random.default_rng(1).integers(0, 4, size=g.n)
    mask = (np.random.default_rng(3).random(g.n) < 0.6).astype(np.float32)
    plan = compile_plan(g, partition_from_assign(g, assign, 4, {}),
                        slack=0.25)
    cfg = GNNConfig('gcn', (52, 16, 2))
    params = init_params(jax.random.PRNGKey(0), cfg)
    mesh = make_mesh((4,), ('data',))
    fwd = make_bsp_forward(cfg, plan, mesh, exchange='ppermute',
                           aggregate='segment')
    step = make_distributed_train_step(
        cfg, fwd, scatter_ints(plan, g.labels), scatter_ints(plan, mask),
        lr=1.0)
    new, loss = step(params, scatter_features(plan, g.features))
    print("RESULT", json.dumps({"loss": float(loss), "params": [
        {k: np.asarray(v).tolist() for k, v in p.items()} for p in new]}))
""")


def test_distributed_step_matches_reference_distributed_step():
    """GCN, ppermute, segment: one step of the port's distributed train
    step against the reference's ``make_distributed_train_step`` over its
    shard_map'd forward on 4 CPU devices.  lr = 1 makes the updated
    parameters differ by exactly the gradients' difference."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REF_STEP], env=env,
                       capture_output=True, text=True, timeout=600)
    assert "RESULT" in r.stdout, r.stdout + r.stderr
    ref = json.loads(r.stdout.split("RESULT")[1])
    _, _, _, _, params, _, step, blocks = _port_step(
        "gcn", "ppermute", "segment", lr=1.0)
    new, loss = step(params, blocks)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=DIST_TOL,
                               atol=DIST_TOL)
    for layer, ref_layer in zip(new, ref["params"]):
        for k, v in layer.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(ref_layer[k]),
                                       rtol=DIST_TOL, atol=DIST_TOL)


@pytest.mark.parametrize("agg", ["segment", "bsr"])
@pytest.mark.parametrize("model", MODELS)
def test_value_only_patch_step_equals_fresh_plan_step(model, agg):
    """After a value-only patch the train step refreshes the resident plan
    tensors (the transposed operand too) with 0 rebuilds, and its loss,
    gradients and updated parameters equal a fresh plan's, bit for bit."""
    rng = np.random.default_rng(11)
    g = random_graph(rng, 90, 120)
    g = DataGraph(n=g.n, edges=g.edges, features=g.features,
                  labels=rng.integers(0, 2, size=g.n))
    P = 4
    plan = TP.compile_plan(g, partition_from_assign(
        g, rng.integers(0, P, size=g.n), P, {}), slack=0.5)
    _, _, cfg, params = _pair(model, (g.features.shape[1], 8, 2), seed=4)
    fwd = TD.make_bsp_forward(cfg, plan, aggregate=agg, device="cpu")

    def one_step(p, f):
        step = TT.make_distributed_train_step(
            cfg, f, TP.scatter_ints(p, g.labels),
            TP.scatter_ints(p, np.ones(g.n, np.float32)), lr=0.1)
        blocks = torch.from_numpy(TP.scatter_features(p, g.features))
        loss, grads = step.loss_and_grads(params, blocks)
        return loss, grads, step(params, blocks)[0]

    one_step(plan, fwd)
    ops = fwd.stats["ops"]
    patched = 0
    for _ in range(8):
        new = plan.assign.copy()
        movers = rng.choice(g.n, size=3, replace=False)
        new[movers] = rng.integers(0, P, size=3)
        if TP.patch_plan(plan, g, new).retrace_expected:
            continue
        got = one_step(plan, fwd)
        assert fwd.stats["builds"] == 1 and fwd.stats["ops"] is ops
        fresh = TP.recompile_like(plan, g, new)
        want = one_step(fresh, TD.make_bsp_forward(
            cfg, fresh, aggregate=agg, device="cpu"))
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1] + got[2], want[1] + want[2]):
            for k in a:
                assert torch.equal(a[k], b[k]), k
        patched += 1
    assert patched >= 2


def test_gat_padded_arcs_get_zero_gradient():
    """GAT masks padded arcs with -inf logits: their gradients are exactly
    0 and nothing is NaN, also on a partition with no arcs at all."""
    g, assign, mask = _dist_case()
    tg = DataGraph(n=g.n, edges=g.edges.copy(), features=g.features,
                   labels=g.labels)
    assign = assign.copy()
    assign[assign == 3] = 2                         # partition 3 is empty
    plan = TP.compile_plan(tg, partition_from_assign(tg, assign, 4, {}),
                           slack=0.25)
    _, _, cfg, params = _pair("gat", (52, 16, 2))
    fwd = TD.make_bsp_forward(cfg, plan, device="cpu")
    blocks = torch.from_numpy(TP.scatter_features(plan, g.features))
    blocks.requires_grad_(True)
    out = fwd(params, blocks)
    gin, = torch.autograd.grad(out.square().sum(), blocks)
    assert torch.isfinite(gin).all()
    pad = torch.from_numpy(plan.local < 0)
    assert torch.equal(gin[pad], torch.zeros_like(gin[pad]))
    step = TT.make_distributed_train_step(
        cfg, fwd, TP.scatter_ints(plan, g.labels),
        TP.scatter_ints(plan, mask))
    _, grads = step.loss_and_grads(params, blocks.detach())
    assert all(torch.isfinite(v).all() for layer in grads
               for v in layer.values())


# ------------------------------------------------------------ K1 and gathers
def _bsr_case(seed=0, n=300, arcs=2000, bm=8, bk=128):
    rng = np.random.default_rng(seed)
    sd = rng.integers(0, n, size=(arcs, 2))
    w = rng.uniform(0.1, 2.0, size=arcs).astype(np.float32)
    vals, cols, _, n_src = JK.build_bsr(sd, w, n, bm, bk)
    return TK.pack_bsr(vals, cols, bm, bk), vals, cols, n_src


def test_spmm_packed_gradcheck_float64():
    pk, _, _, n_src = _bsr_case(1, n=60, arcs=200, bm=4, bk=16)
    x = torch.randn(n_src, 5, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda f: TK.spmm_packed(pk, f), (x,))
    xb = torch.randn(1, n_src, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda f: TK.spmm_packed(pk, f), (xb,))


@pytest.mark.parametrize("source", ["build_bsr", "plan"])
def test_transpose_packed_twice_is_identity(source):
    if source == "build_bsr":
        pk, _, _, n_src = _bsr_case(2)
    else:
        rng = np.random.default_rng(4)
        g = DataGraph(n=120, edges=random_graph(rng, 120, 200).edges,
                      features=np.zeros((120, 4), np.float32))
        plan = TP.compile_plan(g, partition_from_assign(
            g, rng.integers(0, 4, size=g.n), 4, {}), slack=0.3)
        b = TP.build_plan_bsr(plan, 4, 8)
        pk = TK.pack_bsr(b.values, b.block_cols, b.bm, b.bk,
                         nnz_cap=plan.e_cap)
        n_src = b.src_rows
    t = TK.transpose_packed(pk, n_src)
    assert (t.n_rows, t.src_rows, t.nnz_cap) == (n_src, pk.n_rows,
                                                 pk.nnz_cap)
    assert (np.asarray(t.row_ptr[:, -1]) == np.asarray(pk.row_ptr[:, -1])).all()
    for r in range(t.n_rows):                     # sorted by destination row
        for p in range(t.col.shape[0]):
            row = t.col[p, t.row_ptr[p, r]:t.row_ptr[p, r + 1]]
            assert (np.diff(row) > 0).all()
    back = TK.transpose_packed(t, pk.n_rows)
    for f in ("row_ptr", "col", "w"):
        np.testing.assert_array_equal(getattr(back, f), getattr(pk, f))
    assert (back.n_rows, back.src_rows) == (pk.n_rows, n_src)
    tt = TK.transpose_packed(pk.to("cpu"), n_src)         # tensors in, out
    assert isinstance(tt.col, torch.Tensor)
    for f in ("row_ptr", "col", "w"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), getattr(t, f))


def test_transposed_gradient_equals_index_add_autograd():
    pk, vals, cols, n_src = _bsr_case(3)
    feats = torch.randn(n_src, 24)
    g = torch.randn(pk.n_rows, 24)
    x = feats.clone().requires_grad_(True)
    got, = torch.autograd.grad(TK.spmm_packed(pk, x), x, g)
    y = feats.clone().requires_grad_(True)
    want, = torch.autograd.grad(TK.spmm_packed_plain(pk, y), y, g)
    assert torch.equal(got, want)
    t = TK.transpose_packed(pk, n_src)
    assert torch.equal(got, TK.spmm_packed_plain(t, g))
    dense = torch.einsum("rc,rd->cd", torch.from_numpy(
        _dense(vals, cols, 8, 128, n_src)), g)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)


def _dense(vals, cols, bm, bk, n_src):
    nb, maxb = cols.shape
    a = np.zeros((nb * bm, n_src), np.float32)
    blocks = vals.reshape(nb, maxb, bm, bk)
    for i in range(nb):
        for j in range(maxb):
            c = cols[i, j] * bk
            a[i * bm:(i + 1) * bm, c:c + bk] += blocks[i, j]
    return a


def test_transpose_packed_rows_follow_the_callers_table():
    """The backward's rows are the table the forward was given, which may
    be taller than ``src_rows``: a pack sized to ``src_rows`` would drop
    the gradient of the rows past it (here, none of them are read, so
    their gradient is 0, but the shape must be the table's)."""
    pk, _, _, n_src = _bsr_case(5)
    rows = n_src + 128
    x = torch.randn(rows, 8, requires_grad=True)
    got, = torch.autograd.grad(TK.spmm_packed(pk, x).sum(), x)
    assert got.shape == (rows, 8)
    with pytest.raises(ValueError, match="transposed operand has"):
        TK.spmm_packed(pk, x, TK.transpose_packed(pk, n_src))
    with pytest.raises(ValueError, match="src_rows"):
        TK.transpose_packed(pk, pk.src_rows - 1)


def test_spmm_packed_refuses_weight_gradients():
    pk, _, _, n_src = _bsr_case(6)
    pt = pk.to("cpu")
    pt.w.requires_grad_(True)
    with pytest.raises(RuntimeError, match="link weights"):
        TK.spmm_packed(pt, torch.randn(n_src, 4))
    with torch.no_grad():
        TK.spmm_packed(pt, torch.randn(n_src, 4))


def test_bsr_aggregate_gradient_equals_dense_transpose(small_siot):
    """``BSRAggregate`` (and ``aggregate_features``) pads the features to
    ``n_src_pad`` rows; its backward runs over the transpose at that
    height and reaches the caller's (n, d) features."""
    sd = TM.directed_edges(small_siot.edges)
    agg = BSRAggregate(sd, small_siot.n, device="cpu")
    assert agg.packed_t.n_rows == agg.n_src_pad
    feats = torch.from_numpy(small_siot.features).requires_grad_(True)
    g = torch.randn(small_siot.n, feats.shape[1])
    got, = torch.autograd.grad(agg(feats), feats, g)
    a = np.zeros((small_siot.n, small_siot.n), np.float32)
    np.add.at(a, (sd[:, 1], sd[:, 0]), 1.0)
    np.testing.assert_allclose(got.numpy(), a.T @ g.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(40,), (40, 7)])
def test_gather_rows_backward_bit_equals_index_add(shape):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, shape[0], size=300))
    g = torch.from_numpy(rng.normal(size=(300,) + shape[1:]).astype(
        np.float32))
    xr = x.clone().requires_grad_(True)
    out = TM.gather_rows(xr, idx)
    assert torch.equal(out, x[idx])
    got, = torch.autograd.grad(out, xr, g)
    want = torch.zeros_like(x).index_add_(0, idx, g)
    assert torch.equal(got, want)


# ------------------------------------------------------------- checkpoints
def _tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"params": [{"w": torch.randn(5, 3, generator=gen),
                        "att_src": torch.randn(3, generator=gen)},
                       {"w": torch.randn(3, 2, generator=gen)}],
            "step": torch.tensor(7)}


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        assert torch.equal(torch.as_tensor(np.asarray(a)),
                           torch.as_tensor(np.asarray(b)))


@pytest.mark.parametrize("async_write", [False, True])
def test_checkpoint_round_trip(tmp_path, async_write):
    ck = CheckpointManager(str(tmp_path), async_write=async_write)
    tree = _tree()
    ck.save(3, tree, extra={"mesh": "1"})
    tree["params"][0]["w"].add_(1.0)        # the snapshot was taken at save
    ck.wait()
    restored, man = ck.restore(3, _tree(1))
    assert man["step"] == 3 and man["extra"] == {"mesh": "1"}
    assert man["treedef"] == ("{'params': [{'att_src': *, 'w': *}, "
                              "{'w': *}], 'step': *}")
    _assert_trees_equal(restored, _tree())
    assert sorted(os.listdir(tmp_path / "step_00000003")) == [
        "MANIFEST.json", "params__0__att_src.npy", "params__0__w.npy",
        "params__1__w.npy", "step.npy"]


def test_checkpoint_keep_gc_and_tmp_ignored(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3):
        ck.save(s, _tree(s))
    assert ck.all_steps() == [2, 3]
    os.makedirs(tmp_path / "step_00000009.tmp")           # crashed writer
    assert ck.latest_step() == 3
    restored, _ = ck.restore(2, _tree())
    _assert_trees_equal(restored, _tree(2))


def test_checkpoint_restore_device_argument(tmp_path):
    ck = CheckpointManager(str(tmp_path), async_write=False)
    ck.save(1, _tree())
    restored, _ = ck.restore(1, {"params": [{"w": 0, "att_src": 0},
                                            {"w": 0}], "step": 0},
                             device="cpu")
    assert restored["params"][1]["w"].device.type == "cpu"
    _assert_trees_equal(restored, _tree())


def test_checkpoints_cross_between_packages(tmp_path):
    """A checkpoint written by the reference's CheckpointManager restores
    bit-equal in the port, and one written by the port in the
    reference."""
    _, jp, _, tp = _pair("gat", (52, 16, 2), seed=5)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    JCheckpointManager(str(jdir), async_write=False).save(
        4, {"params": jp, "s": jnp.asarray(4)})
    restored, man = CheckpointManager(str(jdir)).restore(
        4, {"params": tp, "s": torch.tensor(0)})
    assert man["step"] == 4 and int(restored["s"]) == 4
    _assert_trees_equal(restored["params"],
                        jax.tree.map(np.asarray, jp))
    CheckpointManager(str(tdir), async_write=False).save(6, {"params": tp})
    jrest, jman = JCheckpointManager(str(tdir)).restore(6, {"params": jp})
    assert jman["step"] == 6
    _assert_trees_equal(jax.tree.map(np.asarray, jrest["params"]), tp)


# ------------------------------------------------------------ launch script
def test_train_gnn_launch_runs_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train_gnn
    losses, a0, a1 = train_gnn.main(steps=20, device="cpu",
                                    ckdir=str(tmp_path))
    out = capsys.readouterr().out
    assert "failure detected on servers [4]" in out and "OK" in out
    assert len(losses) == 20 and losses[-1] < losses[0] and a1 > a0
    assert CheckpointManager(str(tmp_path)).all_steps() == [10]
