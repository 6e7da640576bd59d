"""The last one-device jitted steps of the reference on the CPU: the LM
train step (``make_train_step``, ``launch/train.py``'s ``jax.jit``) and the
whole-graph GNN ``train_step`` and ``predict``.

On the CPU ``graphs`` resolves to False; the whole-graph GNN steps still
run through their cached steps (static buffers, one step a signature), so
these tests hold the buffer plumbing against the reference; the captures
run on the card (``tests/test_torch_cuda.py -k train_graph``).

* ``graphs=True`` raises on the CPU for all three, and under a gloo mesh
  for the LM step; ``graphs=None`` resolves to eager there.
* ``degrees_from_directed`` (an integer ``scatter_add_``, no host read)
  equals the reference's degrees with isolated vertices and ``n`` past the
  largest id.
* The whole-graph ``train_step`` against the reference's, then again over
  another edge list of the same shape (an input, not a constant).
* The compressed LM step updates the very tensors it is given (parameters,
  moments, step, error feedback) to the values of the functional update.
* The steps run on meta tensors, which raise on any read of a value to
  the host (what a CUDA graph cannot capture).
"""
import contextlib
import dataclasses
import socket

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.gnn import models as JM  # noqa: E402
from repro.gnn import training as JT  # noqa: E402
from repro_torch import models as tz  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.gnn import models as TM  # noqa: E402
from repro_torch.gnn import training as TT  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import Dist, ShapeCfg  # noqa: E402
from repro_torch.train import (  # noqa: E402
    OptConfig, batch_at_step, init_error_feedback, init_opt_state,
    make_train_step, optim)

TOL = {"gcn": 1e-5, "sage": 1e-5, "gat": 1e-4}   # test_torch_training.py


def _gnn_pair(model, g):
    jcfg = JM.GNNConfig(model, (g.features.shape[1], 16, 2))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return (jcfg, jp, TM.GNNConfig(model, jcfg.layer_dims),
            TM.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))


def _llama():
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              dtype=torch.float32)
    params = tz.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_at_step(
        cfg, ShapeCfg("t", 16, 2, "train"), 0).items()}
    return cfg, params, batch


@contextlib.contextmanager
def _gloo_mesh():
    """A gloo group of one process and its 1x1 mesh, destroyed after."""
    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_debug_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                             rank=0, world_size=1)
    try:
        yield make_debug_mesh(1, 1, device_type="cpu")
    finally:
        tdist.destroy_process_group()


def test_graphs_true_raises_on_the_cpu(small_siot):
    """``graphs=True`` raises on the CPU for the LM step (at its first
    call; also under a gloo mesh, at its first call), and for the
    whole-graph GNN
    ``train_step`` and ``predict``; ``graphs=None`` resolves to eager
    there, the GNN steps built without a graph pool."""
    cfg, params, batch = _llama()
    step = make_train_step(cfg, graphs=True)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        step(params, init_opt_state(OptConfig(), params), None, batch)
    with _gloo_mesh() as mesh:
        from repro_torch.launch.mesh import shard_tree
        dist = Dist(mesh, batch_axes=("data",))
        placed = shard_tree(params, tz.param_specs(cfg, dist), mesh)
        step = make_train_step(cfg, dist=dist, graphs=True)
        with pytest.raises(ValueError, match="under a mesh"):
            step(placed, init_opt_state(OptConfig(), placed), None, batch)
    step = make_train_step(cfg)
    assert step.graphs is None
    step(params, init_opt_state(OptConfig(), params), None, batch)
    assert step.graphs is False and step.steps == {}
    g = small_siot
    _, _, tcfg, tp = _gnn_pair("gcn", g)
    sd = TM.directed_edges(g.edges)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        TT.train_step(tcfg, tp, g.features, sd, g.labels, 0.1,
                      device="cpu", graphs=True)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        TM.predict(tcfg, tp, torch.from_numpy(g.features), sd, graphs=True)
    TT.train_step(tcfg, tp, g.features, sd, g.labels, 0.1, device="cpu")
    TM.predict(tcfg, tp, torch.from_numpy(g.features), sd)
    for steps in (TT.train_step.steps, TM.predict.steps):
        assert steps and all(s.pool is None and s.graph is None
                             for s in steps.values())


def test_degrees_equal_the_reference_with_isolated_vertices():
    """The integer ``scatter_add_`` degrees equal the reference's exactly:
    vertices with no arc, and ``n`` past the largest destination."""
    rng = np.random.default_rng(0)
    sd = rng.integers(0, 60, size=(500, 2)).astype(np.int32)
    sd[:, 1] = np.where(sd[:, 1] % 7 == 0, 3, sd[:, 1])   # isolated ids
    n = 90
    ref = np.asarray(JM.degrees_from_directed(jnp.asarray(sd), n))
    got = TM.degrees_from_directed(torch.from_numpy(sd), n)
    assert got.dtype == torch.float32 and (ref[60:] == 0).all()
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(got.numpy(), np.bincount(sd[:, 1], minlength=n))


@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_whole_graph_step_follows_the_reference_over_new_edges(model,
                                                               small_siot):
    """The cached whole-graph ``train_step`` against the reference's jitted
    step, then a second call over another edge list of the same shape (the
    same step, its edge buffer rewritten) against the reference over that
    list; ``predict`` on both lists equal to the reference's."""
    g = small_siot
    jcfg, jp, tcfg, tp = _gnn_pair(model, g)
    sd = TM.directed_edges(g.edges)
    rng = np.random.default_rng(1)
    other = sd.copy()
    other[:, 0] = rng.permutation(g.n)[other[:, 0]]       # rewired sources
    tol = TOL[model]
    built = []
    for edges in (sd, other):
        ref_new, ref_loss = JT.train_step(jcfg, jp, jnp.asarray(g.features),
                                          jnp.asarray(edges),
                                          jnp.asarray(g.labels), 0.1)
        new, loss = TT.train_step(tcfg, tp, torch.from_numpy(g.features),
                                  torch.from_numpy(edges).long(),
                                  torch.from_numpy(g.labels).long(), 0.1,
                                  device="cpu")
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=tol,
                                   atol=tol)
        for layer, ref_layer in zip(new, ref_new):
            for k, v in layer.items():
                np.testing.assert_allclose(v.numpy(), np.asarray(
                    ref_layer[k]), rtol=tol, atol=tol, err_msg=k)
        pred = TM.predict(tcfg, tp, torch.from_numpy(g.features), edges)
        assert np.array_equal(pred.numpy(), np.asarray(JM.predict(
            jcfg, jp, jnp.asarray(g.features), jnp.asarray(edges))))
        built.append(len(TT.train_step.steps))
    assert built[1] == built[0]           # the same step, over new edges


def test_compressed_step_updates_the_given_tensors():
    """``make_train_step(compress_grads=True)`` returns the very tensors it
    is given for the parameters, both moments, the step and the error
    feedback, holding the functional update's values: AdamW on the
    int8-quantized gradients and the residual ``g + ef - deq``."""
    cfg, params, batch = _llama()
    opt = OptConfig(lr=1e-2)
    state = init_opt_state(opt, params)
    ef = optim.tree_map(lambda p: torch.full_like(p, 1e-4), params)
    clone = lambda t: optim.tree_map(torch.clone, t)  # noqa: E731
    want_p, want_m, want_v = clone(params), clone(state.m), clone(state.v)
    step = make_train_step(cfg, opt, compress_grads=True)
    _, grads = step.grads_of(params, batch)
    deq, want_ef = {}, {}
    for (name, g), e in zip(optim.named_leaves(grads), optim.leaves(ef)):
        g32 = g.float() + e
        scale = g32.abs().max() / 127.0 + 1e-12
        q = torch.clamp(torch.round(g32 / scale), -127, 127) * scale
        deq[name], want_ef[name] = q.to(g.dtype), g32 - q
    names = iter(deq)
    optim.apply_updates(opt, want_p, optim.tree_map(
        lambda _: deq[next(names)], grads), optim.OptState(
        torch.zeros((), dtype=torch.int32), want_m, want_v))
    ids = [id(t) for t in (optim.leaves(params) + optim.leaves(state.m)
                           + optim.leaves(state.v) + [state.step]
                           + optim.leaves(ef))]
    p, o, e, m = step(params, state, ef, batch)
    assert [id(t) for t in (optim.leaves(p) + optim.leaves(o.m)
                            + optim.leaves(o.v) + [o.step]
                            + optim.leaves(e))] == ids
    assert int(o.step) == 1 and m["step"] is o.step
    for got, want in ((p, want_p), (o.m, want_m), (o.v, want_v)):
        assert all(torch.equal(a, b) for a, b in zip(optim.leaves(got),
                                                     optim.leaves(want)))
    assert all(torch.equal(a, want_ef[name])
               for name, a in optim.named_leaves(e))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-moe-16b"])
def test_steps_read_nothing_back_on_meta(arch, small_siot, monkeypatch):
    """The LM train step (bf16, remat, 2 microbatches, int8 error
    feedback; the MoE's grouped GEMMs on grouped_mm both ways), and the
    whole-graph GNN ``train_step`` and ``predict`` for each model, run on
    meta tensors, which have no values: an op that reads one to the host
    raises."""
    cfg = dataclasses.replace(get_smoke_config(arch), remat=True)
    monkeypatch.setattr(moe, "grouped_gemm_route", lambda x, w: "grouped_mm")
    params = tz.init_params(cfg, torch.Generator().manual_seed(0),
                            device="meta")
    opt = OptConfig()
    batch = {k: torch.zeros((4, 32), dtype=torch.long, device="meta")
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, opt, microbatches=2, compress_grads=True)
    p, o, e, m = step(params, init_opt_state(opt, params),
                      init_error_feedback(params), batch)
    assert step.graphs is False and m["loss"].shape == ()
    g = small_siot
    sd = torch.from_numpy(TM.directed_edges(g.edges)).to("meta").long()
    feats = torch.from_numpy(g.features).to("meta")
    for model in ("gcn", "sage", "gat"):
        tcfg = TM.GNNConfig(model, (g.features.shape[1], 16, 2))
        tp = [{k: v.to("meta") for k, v in layer.items()}
              for layer in TM.init_params(tcfg, device="cpu")]
        new, loss = TT.train_step(tcfg, tp, feats, sd,
                                  torch.zeros(g.n, dtype=torch.long,
                                              device="meta"), 0.1,
                                  device="meta")
        assert loss.shape == () and new[0]["w"].shape == tp[0]["w"].shape
        assert TM.predict(tcfg, tp, feats, sd).shape == (g.n,)
