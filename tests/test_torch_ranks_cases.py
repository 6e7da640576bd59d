"""The rank side of ``tests/test_torch_ranks.py`` (no tests of its own):
what every gloo rank runs, JAX-free so that the spawned processes import
only torch and the port."""
import numpy as np
import torch

from repro_torch.core import CostModel, partition_from_assign, workload_for
from repro_torch.gnn import models as TM
from repro_torch.gnn import plan as TP
from repro_torch.gnn import ranks as TR
from repro_torch.gnn.training import make_distributed_train_step
from repro_torch.graphs import build_edge_network, synthetic_siot
from repro_torch.kernels.gnn_aggregate import spmm

MODELS = ("gcn", "sage", "gat")
EXCHANGES = ("ppermute", "allgather")
DIMS = (52, 16, 2)
LR = 0.05
FWD_CASES = [(m, ex, agg) for m in MODELS for ex in EXCHANGES
             for agg in (("segment",) if m == "gat" else ("segment", "bsr"))]
TRAIN_CASES = [(m, ex, "segment") for m in MODELS for ex in EXCHANGES] + [
    (m, "ppermute", "bsr") for m in ("gcn", "sage")]
ADJ_CASES = [(m, ex) for m in ("gcn", "gat") for ex in EXCHANGES]


def _key(*parts) -> str:
    return "-".join(parts)


def _mask(n):
    return (np.random.default_rng(3).random(n) < 0.6).astype(np.float32)


def _cotangent(rank, shape):
    return np.random.default_rng(100 + rank).standard_normal(shape).astype(
        np.float32)


def _tree_np(tree):
    return [{k: v.detach().numpy().copy() for k, v in layer.items()}
            for layer in tree]


# ------------------------------------------------------------ on every rank
def _rank_cases(rank, P, n, links, params_np):
    """Every case on rank ``rank`` of ``P``; numpy results."""
    g = synthetic_siot(n=n, target_links=links)
    rng = np.random.default_rng(0)
    assign = TR.broadcast_assign(
        rng.integers(0, P, size=g.n) if rank == 0 else None, g.n)
    part = partition_from_assign(g, assign, P, {})
    plan = TP.compile_plan(g, part)
    block = TP.scatter_features(plan, g.features)[rank]
    params = {m: TM.params_from_jax(params_np[m], device="cpu")
              for m in MODELS}
    cfgs = {m: TM.GNNConfig(m, DIMS) for m in MODELS}
    res = {"assign": assign, "forward": {}, "traffic": {}, "repeat": {},
           "train": {}, "block_grad": {}}
    launches = spmm.launches
    for model, ex, agg in FWD_CASES:
        fwd = TR.make_rank_bsp_forward(cfgs[model], plan, exchange=ex,
                                       aggregate=agg, device="cpu")
        out = fwd(params[model], block)
        key = _key(model, ex, agg)
        res["forward"][key] = out.numpy()
        res["traffic"][key] = fwd.stats["traffic"]
        res["repeat"][key] = torch.equal(out, fwd(params[model], block))
    mask = TP.scatter_ints(plan, _mask(g.n))[rank]
    labels = TP.scatter_ints(plan, g.labels)[rank]
    for model, ex, agg in TRAIN_CASES:
        fwd = TR.make_rank_bsp_forward(cfgs[model], plan, exchange=ex,
                                       aggregate=agg, device="cpu")
        step = make_distributed_train_step(cfgs[model], fwd, labels, mask,
                                           lr=LR)
        loss, grads = step.loss_and_grads(params[model], block)
        new, step_loss = step(params[model], block)
        res["train"][_key(model, ex, agg)] = {
            "loss": float(loss), "step_loss": float(step_loss),
            "grads": _tree_np(grads), "new": _tree_np(new)}
    for model, ex in ADJ_CASES:
        fwd = TR.make_rank_bsp_forward(cfgs[model], plan, exchange=ex,
                                       device="cpu")
        x = torch.from_numpy(block).requires_grad_(True)
        out = fwd(params[model], x)
        (out * torch.from_numpy(_cotangent(rank, out.shape))).sum().backward()
        res["block_grad"][_key(model, ex)] = x.grad.numpy()
    res["collectives"] = _collectives(rank, P, fwd.comm)
    if P == 8:
        res["patch"] = _patch_sequence(rank, g, assign, params["gcn"])
        res["replicas"] = _replicas(rank, g, assign, part, params)
    res["launches"] = spmm.launches - launches
    return res


def _collectives(rank, P, comm):
    """The Functions alone: each shift and the all-gather, forward and
    adjoint, on rank-seeded data."""
    out = {}
    for s in range(1, P):
        x = torch.from_numpy(_cotangent(rank + 10 * s, (5, 3)))
        x.requires_grad_(True)
        y = TR._Shift.apply(x, s, comm)
        (y * torch.from_numpy(_cotangent(rank, (5, 3)))).sum().backward()
        out[f"shift{s}"] = (y.detach().numpy(), x.grad.numpy())
    x = torch.from_numpy(_cotangent(rank + 1000, (5, 3))).requires_grad_(True)
    y = TR._AllGather.apply(x, comm)
    (y * torch.from_numpy(_cotangent(rank, (P, 5, 3)))).sum().backward()
    out["all_gather"] = (y.detach().numpy(), x.grad.numpy())
    return out


def _patch_sequence(rank, g, assign, params):
    """``tests/test_plan_patch.py:357-416`` on ranks: value-only patches,
    then capacity growth, each against a fresh plan's rank forward."""
    rng = np.random.default_rng(0)
    rng.integers(0, 8, size=g.n)              # the assignment's draw
    plan = TP.compile_plan(g, partition_from_assign(g, assign, 8, {}),
                           slack=0.5)
    cfg = TM.GNNConfig("gcn", DIMS)
    fwd = TR.make_rank_bsp_forward(cfg, plan, aggregate="bsr", device="cpu")
    fwd(params, TP.scatter_features(plan, g.features)[rank])
    steps, cur = [], assign
    for i in range(5):
        new = cur.copy()
        if i < 4:
            movers = rng.choice(g.n, size=6, replace=False)
            new[movers] = rng.integers(0, 8, size=6)
        else:
            new[: g.n // 2] = 0                 # a stampede: capacity grows
        delta = TP.patch_plan(plan, g, new)
        fresh = TP.recompile_like(plan, g, new)
        blk = TP.scatter_features(plan, g.features)[rank]
        out = fwd(params, blk)
        want = TR.make_rank_bsp_forward(cfg, fresh, aggregate="bsr",
                                        device="cpu")(params, blk)
        steps.append({"retrace": delta.retrace_expected,
                      "patched": delta.patched,
                      "plans_equal": TP.plans_equal(plan, fresh) == [],
                      "builds": fwd.stats["builds"],
                      "bit_equal": torch.equal(out, want)})
        cur = new
    return steps


def _replicas(rank, g, assign, part, params):
    """``tests/test_replication.py:213-244`` on ranks."""
    net = build_edge_network(g, 8, seed=0, mu_factor=2.0)
    cm = CostModel(net, g, workload_for("gcn", g.features.shape[1]))
    repl = cm.replicate_greedy(assign)
    plain = TP.compile_plan(g, part, slack=0.25)
    rplan = TP.compile_plan(g, part, slack=0.25, replication=repl)
    blk = TP.scatter_features(plain, g.features)[rank]
    halo0 = TP.scatter_replica_halo(rplan, g.features)[rank]
    out = {"count": repl.count, "rows0": rplan.halo_bytes_ppermute0,
           "rows": rplan.halo_bytes_ppermute}
    for model in MODELS:
        cfg = TM.GNNConfig(model, DIMS)
        f0 = TR.make_rank_bsp_forward(cfg, plain, device="cpu")
        f1 = TR.make_rank_bsp_forward(cfg, rplan, device="cpu")
        a, b = f0(params[model], blk), f1(params[model], blk, replica0=halo0)
        out[model] = {"bit_equal": torch.equal(a, b),
                      "live0": f1.stats["traffic"][0]["live_rows_sent"],
                      "live1": f1.stats["traffic"][1]["live_rows_sent"]}
    try:
        f1(params["gat"], blk)
    except ValueError:
        out["missing_replica0_raises"] = True
    else:
        out["missing_replica0_raises"] = False
    return out
