"""The GNN path's compiled steps on the CPU, against the reference.

On the CPU ``make_bsp_forward``, ``make_distributed_train_step`` and
``make_ego_forward`` run eagerly (``graphs`` resolves to False); the
captures themselves run on the card (``tests/test_torch_cuda.py -k gnn_``).
These tests hold what the captures stand on:

* the segment sum that reads nothing back to the host, bit-equal to the
  sort-and-bincount sum it replaces and to ``index_add_`` (empty segments
  and padded arcs included), with its order made on the host from a plan's
  edge table or a batch's arcs, and close to the reference's
  ``jax.ops.segment_sum``;
* ``stats['traces']`` over input signatures and rebuilds (the patch and
  replication sequences against the reference are in
  ``tests/test_torch_distributed.py``);
* a forward's result kept by the caller across later calls, and
  ``Step.write``'s copies into the static buffers (none for the buffer
  itself or the tensor last written, unchanged);
* ``graphs=True`` refused on the CPU and over ranks;
* the BSP forward, the train step and the ego forward run on meta tensors,
  which raise on any read of a value to the host (what a CUDA graph cannot
  capture), with K1 replaced by an empty product of its shape.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.gnn import models as JM  # noqa: E402
from repro_torch.core import partition_from_assign  # noqa: E402
from repro_torch.gnn import distributed as TD  # noqa: E402
from repro_torch.gnn import models as TM  # noqa: E402
from repro_torch.gnn import plan as TP  # noqa: E402
from repro_torch.gnn import serving as TS  # noqa: E402
from repro_torch.gnn.ranks import make_rank_bsp_forward  # noqa: E402
from repro_torch.gnn.training import make_distributed_train_step  # noqa: E402
from repro_torch.graphs import synthetic_siot  # noqa: E402
from repro_torch.kernels import gnn_aggregate  # noqa: E402
from repro_torch.step import Step  # noqa: E402


def _bincount_segment_sum(messages, dst, n):
    """The card's segment sum before it could be captured: a stable sort,
    ``bincount`` (which reads its size to the host) and ``segment_reduce``
    with its checks."""
    dst = dst.long()
    order = torch.argsort(dst, stable=True)
    lengths = torch.bincount(dst, minlength=n)
    return torch.segment_reduce(messages[order], "sum", lengths=lengths,
                                axis=0)


@pytest.mark.parametrize("d", [1, 16])
def test_segment_sum_bit_equal_with_empty_segments_and_padding(d):
    """The new sum, with its order found on the device or made on the host,
    equals the sort-and-bincount sum and ``index_add_`` bit for bit; the
    last 40 of 700 segments are empty and a tenth of the arcs are padding
    into the dummy segment n - 1, as a plan's edge table pads."""
    rng = np.random.default_rng(d)
    E, n = 6000, 700
    dst = rng.integers(0, n - 41, size=E)
    dst[rng.random(E) < 0.1] = n - 1
    msgs = torch.from_numpy(rng.standard_normal((E, d)).astype(np.float32))
    dt = torch.from_numpy(dst)
    want = _bincount_segment_sum(msgs, dt, n)
    order, keys, offsets = TM.segment_order(dst, n)
    assert np.array_equal(order, np.argsort(dst, kind="stable"))
    assert np.array_equal(keys, dst[order])
    host = tuple(torch.from_numpy(a) for a in (order, keys, offsets))
    for got in (TM.sorted_segment_sum(msgs, dt, n),
                TM.sorted_segment_sum(msgs, dt, n, host),
                TM.segment_sum(msgs, dt, n)):
        assert torch.equal(got, want)
    assert not want[n - 41:n - 1].any()
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(msgs.numpy()),
                                         jnp.asarray(dst), n))
    np.testing.assert_allclose(want.numpy(), ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="segment order"):
        TM.sorted_segment_sum(msgs[:-1], dt[:-1], n, host)


def _plan(n=120, P=4, seed=5, slack=0.3):
    g = synthetic_siot(n=n, target_links=3 * n)
    assign = np.random.default_rng(seed).integers(0, P, size=g.n)
    return g, TP.compile_plan(g, partition_from_assign(g, assign, P, {}),
                              slack=slack)


def test_plan_segments_follow_the_edge_table_through_patches():
    """Mode 'segment' holds the order of the sums over the flat edge
    destinations (padded arcs into each partition's dummy segment), equal
    to the sort and counts the device would find, and a value-only patch
    rewrites them in place to a fresh plan's."""
    g, plan = _plan()
    ops = TD._PlanTensors(plan, "segment", "ppermute", torch.device("cpu"))
    order, keys, offsets = ops.segments

    def expect(p):
        P, cap = p.num_parts, p.cap
        dst = (torch.from_numpy(p.edges_dst).long()
               + torch.arange(P)[:, None] * (cap + 1)).reshape(-1)
        order = torch.argsort(dst, stable=True)
        lengths = torch.bincount(dst, minlength=P * (cap + 1))
        return order, dst[order], torch.cat([lengths.new_zeros(1),
                                             lengths.cumsum(0)])

    assert len(ops.segments) == 3
    for want, got in zip(expect(plan), ops.segments):
        assert torch.equal(want, got)
    lengths = torch.diff(offsets)
    assert int(lengths.reshape(plan.num_parts, -1)[:, plan.cap].sum()) == int(
        (plan.edges_dst == plan.cap).sum())
    new = plan.assign.copy()
    new[[3, 17, 40]] = (new[[3, 17, 40]] + 1) % plan.num_parts
    assert not TP.patch_plan(plan, g, new).retrace_expected
    ops.refresh(plan)
    assert all(a is b for a, b in zip(ops.segments, (order, keys, offsets)))
    fresh = TP.recompile_like(plan, g, new)
    for want, got in zip(expect(fresh), ops.segments):
        assert torch.equal(want, got)
    TP.build_plan_bsr(plan, 4, 8)
    assert TD._PlanTensors(plan, "bsr", "ppermute",
                           torch.device("cpu")).segments is None


def test_traces_count_input_signatures_within_a_build():
    """One trace a distinct (plan signature, input signature) pair: the
    same shapes again add none, parameters of another width add one, a
    rebuild forgets the signatures seen; eager calls by the train step
    count as the forward's own."""
    g, plan = _plan()
    cfg = TM.GNNConfig("gcn", (52, 16, 2))
    narrow = TM.GNNConfig("gcn", (52, 8, 2))
    p16 = TM.init_params(cfg, device="cpu")
    p8 = TM.init_params(narrow, device="cpu")
    fwd = TD.make_bsp_forward(cfg, plan, device="cpu")
    blocks = TP.scatter_features(plan, g.features)
    counts = []
    for p in (p16, p16, p8, p16, p8):
        fwd(p, blocks)
        counts.append(fwd.stats["traces"])
    assert counts == [1, 1, 2, 2, 2]
    grow = plan.assign.copy()
    grow[: g.n // 2] = 0
    assert TP.patch_plan(plan, g, grow).retrace_expected
    blocks = TP.scatter_features(plan, g.features)
    fwd.eager(p16, blocks)
    fwd(p16, blocks)
    assert (fwd.stats["traces"], fwd.stats["builds"]) == (3, 2)
    fwd(p8, blocks)
    assert fwd.stats["traces"] == 4
    assert list(fwd.steps.values()) == [None, None]     # nothing captured


def test_results_survive_later_calls():
    """A caller's result is never overwritten by a later call: the BSP
    forward's, the train step's and the ego forward's."""
    g, plan = _plan()
    cfg = TM.GNNConfig("sage", (52, 16, 2))
    params = TM.init_params(cfg, device="cpu")
    fwd = TD.make_bsp_forward(cfg, plan, device="cpu")
    a = fwd(params, TP.scatter_features(plan, g.features))
    keep = a.clone()
    b = fwd(params, TP.scatter_features(plan, g.features * 2.0))
    assert torch.equal(a, keep) and not torch.equal(a, b)
    step = make_distributed_train_step(
        cfg, fwd, TP.scatter_ints(plan, g.labels),
        TP.scatter_ints(plan, np.ones(g.n, np.float32)), lr=0.1)
    blocks = TP.scatter_features(plan, g.features)
    new, loss = step(params, blocks)
    kept = [{k: v.clone() for k, v in p.items()} for p in new]
    step(new, blocks)
    assert all(torch.equal(x[k], y[k]) for x, y in zip(new, kept) for k in x)
    ego_fwd = TS.make_ego_forward(cfg, params, device="cpu")
    outs = []
    for t in ([3, 9], [50, 60]):
        ego = TS.extract_ego_batch(g, np.array(t), 2, batch=2)
        feats, deg, rows = TS.ego_tables(ego, g.features,
                                         g.degrees.astype(np.float32))
        outs.append(ego_fwd(feats, ego.arcs, deg, rows))
        if len(outs) == 1:
            keep = outs[0].clone()
    assert torch.equal(outs[0], keep) and not torch.equal(outs[0], outs[1])


def test_step_write_copies_only_what_changed():
    """``Step.write`` copies a tensor into its buffer unless it is the
    buffer or the tensor written last with its version unchanged; an
    in-place change, another tensor or an array is copied."""
    step = Step("w", lambda x: x * 2, {"x": torch.zeros(3)})
    buf = step.inputs["x"]
    t = torch.ones(3)
    step.write("x", t)
    assert torch.equal(step(), torch.full((3,), 2.0))
    buf.fill_(5.0)                  # only the next copy can undo this
    step.write("x", t)
    assert torch.equal(buf, torch.full((3,), 5.0))      # skipped
    t.add_(1.0)
    step.write("x", t)
    assert torch.equal(buf, torch.full((3,), 2.0))      # copied
    step.write("x", torch.full((3,), 2.0))
    step.write("x", np.arange(3, dtype=np.float32))
    assert torch.equal(buf, torch.arange(3.0))
    step.write("x", buf)
    assert torch.equal(step(), torch.arange(3.0) * 2)


def test_graphs_true_raises_off_the_card_and_over_ranks():
    """graphs=True is refused where nothing is captured: on the CPU (the
    BSP forward, the train step, the ego forward, the serving engine) and
    over ranks (the rank forward, a train step over one); graphs=None
    resolves to False on the CPU."""
    g, plan = _plan()
    cfg = TM.GNNConfig("gcn", (52, 16, 2))
    params = TM.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        TD.make_bsp_forward(cfg, plan, device="cpu", graphs=True)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        TS.make_ego_forward(cfg, params, device="cpu", graphs=True)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        TS.GNNServeEngine(cfg, params, g, plan, device="cpu", graphs=True)
    fwd = TD.make_bsp_forward(cfg, plan, device="cpu")
    assert fwd.graphs is False
    labels = TP.scatter_ints(plan, g.labels)
    mask = TP.scatter_ints(plan, np.ones(g.n, np.float32))
    assert make_distributed_train_step(cfg, fwd, labels, mask).graphs is False
    with pytest.raises(ValueError, match="needs a CUDA device"):
        make_distributed_train_step(cfg, fwd, labels, mask, graphs=True)
    with pytest.raises(ValueError, match="gloo collectives"):
        make_rank_bsp_forward(cfg, plan, device="cpu", graphs=True)

    def rank_forward(params, block, replica0=None):
        raise AssertionError("not called")

    rank_forward.device, rank_forward.comm = torch.device("cpu"), object()
    with pytest.raises(ValueError, match="gloo collectives"):
        make_distributed_train_step(cfg, rank_forward, labels[0], mask[0],
                                    graphs=True)


def _meta(tree):
    return [{k: v.to("meta") for k, v in p.items()} for p in tree]


@pytest.mark.parametrize("model,exchange,aggregate,replicas", [
    ("gcn", "ppermute", "bsr", True), ("sage", "allgather", "bsr", False),
    ("sage", "ppermute", "segment", False), ("gat", "ppermute", "segment",
                                             True),
    ("gat", "allgather", "segment", False)])
def test_steps_read_nothing_back_on_meta(model, exchange, aggregate,
                                         replicas, monkeypatch):
    """The BSP forward, the train step (forward, gradients through K1's
    backward and the segment sums', SGD) and the ego forward run on meta
    tensors, which have no values: an op that reads one to the host (a
    ``bincount``, an ``.item()``) raises.  K1 is a launch with shape checks
    only; here it is an empty product of its output's shape."""
    def product(packed, feats, direction):
        return feats.new_empty((feats.shape[0], packed.n_rows,
                                feats.shape[-1]))

    monkeypatch.setattr(gnn_aggregate, "_product", product)
    monkeypatch.setattr(TD, "spmm_packed", lambda packed, feats, t=None: (
        gnn_aggregate._SpmmPacked.apply(feats, packed, t)))
    g, plan = _plan()
    if replicas:
        TP.set_replication(plan, {0: np.arange(10, 30), 2: np.arange(40, 60)})
    cfg = TM.GNNConfig(model, (52, 16, 2))
    params = _meta(TM.init_params(cfg, device="cpu"))
    fwd = TD.make_bsp_forward(cfg, plan, exchange=exchange,
                              aggregate=aggregate, device="meta")
    assert fwd.graphs is False and fwd.mode == (
        "segment" if model == "gat" else aggregate)
    blocks = torch.from_numpy(TP.scatter_features(plan, g.features)).to(
        "meta")
    r0 = (torch.from_numpy(TP.scatter_replica_halo(plan, g.features)).to(
        "meta") if replicas else None)
    out = fwd(params, blocks, replica0=r0)
    assert out.shape == (plan.num_parts, plan.cap, 2)
    step = make_distributed_train_step(
        cfg, fwd, TP.scatter_ints(plan, g.labels),
        TP.scatter_ints(plan, np.ones(g.n, np.float32)), lr=0.1)
    new, loss = step(params, blocks, replica0=r0)
    assert loss.shape == () and [p["w"].shape for p in new] == [
        p["w"].shape for p in params]
    ego_fwd = TS.make_ego_forward(cfg, params, device="meta")
    ego = TS.extract_ego_batch(g, np.array([1, 5, 9]), 2, batch=4)
    feats, deg, rows = TS.ego_tables(ego, g.features,
                                     g.degrees.astype(np.float32))
    seg = TS.ego_segments(ego, model)
    assert ego_fwd(feats, ego.arcs, deg, rows, seg).shape == (4, 2)


def test_ego_segments_order_the_layer_sums():
    """The ego batch's host order is the one each model's layer sums in:
    the arcs' destinations, with GAT's self loops after them; the
    reference's ``EgoBatch`` and tables are unchanged by it."""
    g, _ = _plan()
    ego = TS.extract_ego_batch(g, np.array([2, 7, 7, 30]), 2, batch=4)
    n = ego.dummy + 1
    for model in ("gcn", "gat"):
        order, keys, offsets = TS.ego_segments(ego, model)
        dst = ego.arcs[:, 1].astype(np.int64)
        if model == "gat":
            dst = np.concatenate([dst, np.arange(n)])
        assert np.array_equal(order, np.argsort(dst, kind="stable"))
        assert np.array_equal(keys, dst[order])
        assert np.array_equal(np.diff(offsets), np.bincount(dst, minlength=n))
        assert offsets[0] == 0 and offsets[-1] == len(dst)
    cfg = TM.GNNConfig("gat", (52, 16, 2))
    params = TM.init_params(cfg, device="cpu")
    feats, deg, rows = TS.ego_tables(ego, g.features,
                                     g.degrees.astype(np.float32))
    fwd = TS.make_ego_forward(cfg, params, device="cpu")
    assert torch.equal(fwd(feats, ego.arcs, deg, rows),
                       fwd(feats, ego.arcs, deg, rows,
                           TS.ego_segments(ego, "gat")))
    assert fwd.stats == {"traces": 1} and fwd.captures() == 0
    jcfg = JM.GNNConfig("gat", (52, 16, 2))
    assert jcfg.num_layers == cfg.num_layers
