"""The per-rank BSP forward and train step (``repro_torch.gnn.ranks``,
``launch.ranks``) under gloo in 4 and 8 CPU processes, against the JAX
reference in this process.

The port's counterparts of the reference's multi-device scripts:
``tests/test_distributed_gnn.py:70-111`` (4 devices, n = 120),
``tests/test_plan_patch.py:322-416`` and ``tests/test_replication.py:
213-244`` (8 devices, n = 160).  One module-scoped spawn per size runs
every case on every rank (``tests/test_torch_ranks_cases.py``, JAX-free, so
the ranks import only torch and the port); the tests below assert the
cases one by one: the forward against the reference's dense forward and
``simulate_bsp_forward`` (its scripts' gate, relative error < 1e-4) and
against the port's one-device batched forward; the rows on the wire
against the plan's schedule; one train step's loss and gradients against
``jax.grad`` of the reference's ``loss_fn``; the exchanges' adjoints
against the batched program's autograd; the collectives alone; the
zero-rebuild patch sequence and the one-rebuild growth; the replicated
forward.  The card runs the same forward as 8 ranks in ``chip_smoke.py``'s
``ranks`` phase and ``tests/test_torch_cuda.py``."""
import concurrent.futures
import functools
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.partition import partition_from_assign as j_partition  # noqa: E402
from repro.gnn import distributed as JD  # noqa: E402
from repro.gnn import models as JM  # noqa: E402
from repro.graphs.datagraph import synthetic_siot as j_siot  # noqa: E402
from repro_torch.core import partition_from_assign  # noqa: E402
from repro_torch.gnn import distributed as TD  # noqa: E402
from repro_torch.gnn import models as TM  # noqa: E402
from repro_torch.gnn import plan as TP  # noqa: E402
from repro_torch.gnn import ranks as TR  # noqa: E402
from repro_torch.graphs import synthetic_siot  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from tests.test_torch_ranks_cases import (  # noqa: E402
    ADJ_CASES, DIMS, EXCHANGES, FWD_CASES, LR, MODELS, TRAIN_CASES, _cotangent,
    _key, _mask, _rank_cases)

REF_TOL = 1e-4          # the reference scripts' relative gate
BATCHED_TOL = 1e-5      # against the port's batched forward: rounding only
DIST_TOL = 2e-4         # the batched step's gradient gate (test_torch_training)
RANK_TIMEOUT = 240.0    # a lost rank fails the file well inside the suite's limit
SIZES = {4: (120, 300), 8: (160, 420)}     # the reference scripts' graphs


# ---------------------------------------------------------------- the spawns
def _spawn(P):
    """The ranks' results; the reference's numbers are computed here while
    the ranks run."""
    n, links = SIZES[P]
    jparams = {m: JM.init_params(jax.random.PRNGKey(0), JM.GNNConfig(m, DIMS))
               for m in MODELS}
    params_np = {m: jax.tree.map(np.asarray, p) for m, p in jparams.items()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(run_ranks, _rank_cases, P, P, n, links,
                              params_np, timeout=RANK_TIMEOUT)
        for case in FWD_CASES:
            _reference(P, *case)
        for model in MODELS:
            _reference_step(P, model)
        results = running.result()
    g = synthetic_siot(n=n, target_links=links)
    assign = np.random.default_rng(0).integers(0, P, size=g.n)
    plan = TP.compile_plan(g, partition_from_assign(g, assign, P, {}))
    return types.SimpleNamespace(
        P=P, g=g, jg=j_siot(n=n, target_links=links), assign=assign,
        plan=plan, params_np=params_np, results=results)


@pytest.fixture(scope="module")
def ranks4():
    return _spawn(4)


@pytest.fixture(scope="module")
def ranks8():
    return _spawn(8)


@pytest.fixture(params=[4, 8], ids=["P4", "P8"])
def ranks(request):
    return request.getfixturevalue(f"ranks{request.param}")


def _gathered(run, what, key):
    blocks = np.stack([r[what][key] for r in run.results])
    return TP.gather_outputs(run.plan, blocks, run.g.n)


def _rel(got, ref):
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9))


@functools.lru_cache(maxsize=None)
def _reference(P, model, exchange, agg):
    """The reference's dense forward and ``simulate_bsp_forward`` on the
    spawn's graph and assignment."""
    n, links = SIZES[P]
    jg = j_siot(n=n, target_links=links)
    assign = np.random.default_rng(0).integers(0, P, size=jg.n)
    jplan = JD.compile_plan(jg, j_partition(jg, assign, P, {}))
    cfg = JM.GNNConfig(model, DIMS)
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    dense = np.asarray(JM.forward(cfg, params, jnp.asarray(jg.features),
                                  jnp.asarray(JM.directed_edges(jg.edges))))
    sim = JD.simulate_bsp_forward(
        cfg, params, jplan, jg.features, exchange=exchange,
        aggregate="pallas" if agg == "bsr" else "segment")
    return dense, sim


@functools.lru_cache(maxsize=None)
def _reference_step(P, model):
    """``jax.value_and_grad`` of the reference's whole-graph ``loss_fn``
    with the ranks' mask."""
    jg = j_siot(*SIZES[P])
    cfg = JM.GNNConfig(model, DIMS)
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    return jax.value_and_grad(lambda p: JM.loss_fn(
        cfg, p, jnp.asarray(jg.features),
        jnp.asarray(JM.directed_edges(jg.edges)), jnp.asarray(jg.labels),
        jnp.asarray(_mask(jg.n))))(params)


# --------------------------------------------------------------- the checks
def test_ranks_share_rank0s_assignment_and_graph(ranks):
    np.testing.assert_array_equal(ranks.g.edges, ranks.jg.edges)
    for r in ranks.results:
        np.testing.assert_array_equal(r["assign"], ranks.assign)
    assert all(r["launches"] == 0 for r in ranks.results)  # CPU: no kernel


@pytest.mark.parametrize("model,exchange,agg", FWD_CASES)
def test_rank_forward_matches_reference(ranks, model, exchange, agg):
    key = _key(model, exchange, agg)
    out = _gathered(ranks, "forward", key)
    dense, sim = _reference(ranks.P, model, exchange, agg)
    assert _rel(out, dense) < REF_TOL and _rel(out, sim) < REF_TOL
    cfg = TM.GNNConfig(model, DIMS)
    batched = TD.make_bsp_forward(cfg, ranks.plan, exchange=exchange,
                                  aggregate=agg, device="cpu")(
        TM.params_from_jax(ranks.params_np[model], device="cpu"),
        TP.scatter_features(ranks.plan, ranks.g.features))
    assert _rel(out, TP.gather_outputs(ranks.plan, batched.numpy(),
                                       ranks.g.n)) < BATCHED_TOL
    assert all(r["repeat"][key] for r in ranks.results)


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_rank_wire_rows_match_schedule(ranks, exchange):
    """Rows and bytes on the wire per layer, summed over ranks: the
    padded round widths, of which ``halo_bytes_ppermute`` rows are live;
    or every rank's block to every other rank."""
    plan, P = ranks.plan, ranks.P
    per_rank = [r["traffic"][_key("gcn", exchange, "segment")]
                for r in ranks.results]
    for layer, d in enumerate(DIMS[:-1]):
        rows = {k: sum(t[layer][k] for t in per_rank) for k in per_rank[0][0]}
        if exchange == "ppermute":
            width = sum(r["width"] for r in plan.rounds)
            assert rows["rows_sent"] == rows["rows_recv"] == P * width
            assert rows["live_rows_sent"] == plan.halo_bytes_ppermute > 0
        else:
            assert rows["rows_sent"] == P * plan.cap
            assert rows["rows_recv"] == plan.halo_rows_allgather
        assert rows["bytes_sent"] == rows["rows_sent"] * d * 4
        assert rows["bytes_recv"] == rows["rows_recv"] * d * 4


@pytest.mark.parametrize("model,exchange,agg", TRAIN_CASES)
def test_rank_train_step_matches_reference(ranks, model, exchange, agg):
    """One step: the global loss and every gradient leaf against
    ``jax.grad`` of the reference's whole-graph ``loss_fn`` with the same
    mask; every rank holds the same bits; the update is p - lr * g and
    leaves the parameters equal on every rank."""
    ref_loss, ref = _reference_step(ranks.P, model)
    got = [r["train"][_key(model, exchange, agg)] for r in ranks.results]
    first = got[0]
    np.testing.assert_allclose(first["loss"], float(ref_loss), rtol=DIST_TOL,
                               atol=DIST_TOL)
    for layer, ref_layer in zip(first["grads"], ref):
        for k, g in layer.items():
            np.testing.assert_allclose(g, np.asarray(ref_layer[k]),
                                       rtol=DIST_TOL, atol=DIST_TOL,
                                       err_msg=k)
    for layer, g_layer, p in zip(first["new"], first["grads"],
                                 ranks.params_np[model]):
        for k in layer:
            np.testing.assert_array_equal(
                layer[k], (torch.from_numpy(np.array(p[k]))
                           - LR * torch.from_numpy(g_layer[k])).numpy())
    for other in got[1:]:
        assert other["loss"] == first["loss"] == other["step_loss"]
        for a, b in zip(other["grads"] + other["new"],
                        first["grads"] + first["new"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("model,exchange", ADJ_CASES)
def test_rank_exchange_adjoint_matches_batched_autograd(ranks, model,
                                                        exchange):
    """The gradient with respect to each rank's input block, through every
    layer's exchange adjoint, against autograd of the batched program."""
    cfg = TM.GNNConfig(model, DIMS)
    fwd = TD.make_bsp_forward(cfg, ranks.plan, exchange=exchange,
                              device="cpu")
    x = torch.from_numpy(TP.scatter_features(ranks.plan, ranks.g.features))
    x.requires_grad_(True)
    out = fwd(TM.params_from_jax(ranks.params_np[model], device="cpu"), x)
    cot = np.stack([_cotangent(q, out.shape[1:]) for q in range(ranks.P)])
    (out * torch.from_numpy(cot)).sum().backward()
    got = np.stack([r["block_grad"][_key(model, exchange)]
                    for r in ranks.results])
    assert np.abs(x.grad.numpy()).max() > 0
    assert _rel(got, x.grad.numpy()) < BATCHED_TOL


def test_collectives_and_their_adjoints(ranks):
    """Shift s: rank q gets (q - s)'s rows, and its input's gradient is
    (q + s)'s cotangent.  All-gather: every rank's rows in rank order; the
    gradient is the cotangents' rows q summed in rank order, exactly."""
    P = ranks.P
    res = [r["collectives"] for r in ranks.results]
    for s in range(1, P):
        for q in range(P):
            y, gx = res[q][f"shift{s}"]
            np.testing.assert_array_equal(
                y, _cotangent((q - s) % P + 10 * s, (5, 3)))
            np.testing.assert_array_equal(gx, _cotangent((q + s) % P, (5, 3)))
    xs = np.stack([_cotangent(q + 1000, (5, 3)) for q in range(P)])
    for q in range(P):
        y, gx = res[q]["all_gather"]
        np.testing.assert_array_equal(y, xs)
        want = _cotangent(0, (P, 5, 3))[q].copy()
        for r in range(1, P):
            want += _cotangent(r, (P, 5, 3))[q]
        np.testing.assert_array_equal(gx, want)


def test_patch_sequence_rebuilds_nothing_and_equals_fresh_plan(ranks8):
    """Value-only patches: 0 rebuilds, the patched plan equals a fresh
    compile and its rank forward a fresh plan's, bit for bit, on every
    rank."""
    seqs = [r["patch"] for r in ranks8.results]
    value_only = 0
    for i in range(4):
        steps = [s[i] for s in seqs]
        assert all(s == steps[0] for s in steps[1:])
        assert steps[0]["plans_equal"] and steps[0]["bit_equal"]
        if not steps[0]["retrace"]:
            assert steps[0]["patched"] and steps[0]["builds"] == 1 + sum(
                s["retrace"] for s in seqs[0][:i])
            value_only += 1
    assert value_only >= 2


def test_capacity_growth_rebuilds_exactly_once(ranks8):
    for seq in (r["patch"] for r in ranks8.results):
        grow, before = seq[4], seq[3]
        assert grow["retrace"] and not grow["patched"]
        assert grow["builds"] == before["builds"] + 1
        assert grow["plans_equal"] and grow["bit_equal"]


@pytest.mark.parametrize("model", MODELS)
def test_replicated_rank_forward_bit_equal_to_unreplicated(ranks8, model):
    """Replicas carry exact copies of what the pruned rounds would have
    moved, so the rank forward is bit-identical, with fewer live rows
    sent at layer 0 and all of them later."""
    res = [r["replicas"] for r in ranks8.results]
    assert res[0]["count"] > 0 and res[0]["rows0"] < res[0]["rows"]
    assert all(r[model]["bit_equal"] for r in res)
    assert sum(r[model]["live0"] for r in res) == res[0]["rows0"]
    assert sum(r[model]["live1"] for r in res) == res[0]["rows"]


def test_replicated_rank_forward_requires_replica0(ranks8):
    assert all(r["replicas"]["missing_replica0_raises"]
               for r in ranks8.results)


# ------------------------------------------------------- without a process group
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partition_pack_is_a_row_of_the_plan_pack(seed):
    """``_part_pack(plan, q)`` (made from partition q's edge table alone)
    equals row q of the pack of ``build_plan_bsr(plan)`` and of its
    transpose, so a rank's K1 operand is the batched program's row."""
    rng = np.random.default_rng(seed)
    g = synthetic_siot(n=150, target_links=450, seed=seed)
    P = 4
    plan = TP.compile_plan(g, partition_from_assign(
        g, rng.integers(0, P, size=g.n), P, {}), slack=0.25)
    TP.build_plan_bsr(plan)
    whole = TD._plan_pack(plan)
    for q in range(P):
        for mine, full in zip(TD._part_pack(plan, q), whole):
            assert (mine.n_rows, mine.nnz_cap) == (full.n_rows, full.nnz_cap)
            for f in ("row_ptr", "col", "w"):
                np.testing.assert_array_equal(getattr(mine, f)[0],
                                              getattr(full, f)[q], err_msg=f)


def test_plan_digest_tells_plans_apart():
    g = synthetic_siot(n=120, target_links=300)
    assign = np.random.default_rng(0).integers(0, 4, size=g.n)
    a = TP.compile_plan(g, partition_from_assign(g, assign, 4, {}))
    b = TP.compile_plan(g, partition_from_assign(g, assign, 4, {}))
    assert TR.plan_digest(a) == TR.plan_digest(b)
    moved = assign.copy()
    moved[0] = (moved[0] + 1) % 4
    TP.patch_plan(b, g, moved)
    assert TR.plan_digest(a) != TR.plan_digest(b)


def test_rank_forward_refuses_other_backends_and_missing_card(monkeypatch):
    g = synthetic_siot(n=120, target_links=300)
    plan = TP.compile_plan(g, partition_from_assign(
        g, np.zeros(g.n, np.int64), 1, {}))
    cfg = TM.GNNConfig("gcn", DIMS)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TR.make_rank_bsp_forward(cfg, plan)
    monkeypatch.setattr(TR.dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="gloo"):
        TR.make_rank_bsp_forward(cfg, plan, device="cpu")
    with pytest.raises(ValueError, match="exchange"):
        TR.make_rank_bsp_forward(cfg, plan, exchange="ring", device="cpu")
