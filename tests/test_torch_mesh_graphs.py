"""The compiled steps under a mesh on the CPU: ``ServeEngine(dist)``'s
decode and bucketed prefill and ``jit_train_step`` over DTensor buffers,
against the reference's engine and the eager meshed step.

One gloo group of one process and its 1x1 (data, model) mesh, made in this
process (nothing is spawned).  On the CPU ``graphs`` resolves to False, so
the steps run eagerly on their DTensor buffers; the captures run on the
card (``tests/test_torch_cuda.py -k mesh_graph``).

* ``spec``, ``static_inputs`` and ``Step.write`` on DTensors: the buffer
  over a zeroed local shard of the local shape, no copy when the buffer or
  the tensor last written is passed back unchanged, a copy after an
  in-place change, a redistribution where the placements differ, whole
  tensors and arrays laid out into the buffer.
* The meshed engine (``graphs=False``) at the smoke width, dense and
  hybrid: its tokens and ``len`` vector after every tick equal to the
  reference's engine (JAX, CPU) on the same weights, its buffers DTensors,
  ``trace_counts`` as the mesh-free engine's.
* ``jit_train_step`` through its cached step (the path a card captures,
  here run eagerly) with the caller's DTensor state adopted: the very
  DTensors returned, loss and every leaf equal to the eager meshed step's.
* The resolution rule: ``graphs=True`` on the gloo mesh raises and names
  the mesh; ``graphs=None`` resolves to eager there.
"""
import dataclasses
import socket

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.serve import Request as JRequest, ServeEngine as JServeEngine  # noqa: E402
from repro_torch import models as tz  # noqa: E402
from repro_torch import step as S  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import full_tree, make_debug_mesh, shard_tree  # noqa: E402
from repro_torch.models.common import Dist, P, ShapeCfg  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.train import (  # noqa: E402
    batch_at_step, init_opt_state, optim)
from repro_torch.train import step as train_step  # noqa: E402


@pytest.fixture(scope="module")
def mesh():
    """One intra-op thread (the steps repeat bit for bit), a gloo group of
    one process and its 1x1 mesh; the group is destroyed after."""
    import torch.distributed as tdist
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                             rank=0, world_size=1)
    try:
        yield make_debug_mesh(1, 1, device_type="cpu")
    finally:
        tdist.destroy_process_group()
        torch.set_num_threads(threads)


def test_dtensor_buffers_and_writes(mesh, monkeypatch):
    """A DTensor's signature, its static buffer and what ``Step.write``
    copies into it, and when it copies nothing."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = shard_tree(torch.arange(12.).reshape(3, 4), P("data", None), mesh)
    assert S.spec(x) == ((3, 4), torch.float32, mesh,
                         (Shard(0), Replicate()))
    assert S.spec(np.zeros((2, 1), np.int64)) == ((2, 1), torch.int64)
    buf = S.static_inputs("cpu", x=x)["x"]
    assert isinstance(buf, DTensor) and S.spec(buf) == S.spec(x)
    assert buf.to_local().shape == x.to_local().shape
    assert not buf.to_local().any()
    assert buf.to_local().data_ptr() != x.to_local().data_ptr()

    step = S.Step("write", lambda x: x * 2, {"x": buf})
    redistributed = []
    redistribute = DTensor.redistribute

    def counting(self, *args, **kw):
        redistributed.append(self)
        return redistribute(self, *args, **kw)

    monkeypatch.setattr(DTensor, "redistribute", counting)
    local = buf.to_local()
    step.write("x", x)
    assert torch.equal(local, x.to_local())
    local.fill_(-1)
    step.write("x", x)                  # the same tensor, unchanged: no copy
    assert (local == -1).all()
    x.to_local().add_(1)                # changed in place: copied again
    step.write("x", x)
    assert torch.equal(local, x.to_local())
    local.fill_(-1)
    step.write("x", buf)                # the buffer itself: no copy
    assert (local == -1).all() and not redistributed
    whole = x.redistribute(mesh, [Replicate(), Replicate()])
    redistributed.clear()
    step.write("x", whole)              # other placements: redistributed
    assert redistributed == [whole] and torch.equal(local, x.to_local())
    step.write("x", torch.ones(3, 4))   # whole tensors and arrays: laid out
    assert (local == 1).all()
    step.write("x", np.full((3, 4), 5, np.float32))
    assert (local == 5).all()
    out = step()
    assert isinstance(out, DTensor) and out.placements == buf.placements
    assert (out.to_local() == 10).all()


_MODELS = {}


def _model(arch):
    """The smoke config in fp32, the port's seeded weights and the same
    weights as the reference's parameter tree (built once per arch)."""
    if arch not in _MODELS:
        jcfg = dataclasses.replace(j_get_smoke(arch), dtype=jnp.float32)
        tcfg = dataclasses.replace(get_smoke_config(arch),
                                   dtype=torch.float32)
        tp = tz.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
        jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
        _MODELS[arch] = jcfg, jp, tcfg, tp
    return _MODELS[arch]


def _serve(eng, cls):
    """Four requests over two slots (the third and fourth queued until a
    slot frees): the tokens and the ``len`` vector after every tick."""
    rng = np.random.default_rng(3)
    reqs = [cls(uid=i, prompt=rng.integers(1, 400, size=5).astype(np.int32),
                max_new_tokens=n, eos_id=-1)
            for i, n in enumerate((3, 6, 4, 5))]
    for r in reqs:
        eng.submit(r)
    lens = []
    while eng.queue or any(r is not None for r in eng.live):
        eng.tick()
        length = eng.cache["len"]
        lens.append(np.asarray(length.to_local() if hasattr(
            length, "to_local") else length).tolist())
    return [r.out_tokens for r in reqs], lens


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b"])
def test_meshed_engine_serves_as_the_reference_engine(arch, mesh):
    """The meshed engine (``graphs=False``) over DTensor buffers: tokens and
    ``len`` after every tick equal to the reference engine's, its steps'
    buffers DTensors laid out as the engine lays them out, and
    ``trace_counts`` as the mesh-free engine's."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    jcfg, jp, tcfg, tp = _model(arch)
    ref = _serve(JServeEngine(jcfg, jp, slots=2, max_len=16), JRequest)
    dist = Dist(mesh, batch_axes=("data",))
    eng = ServeEngine(tcfg, tp, slots=2, max_len=16, device="cpu",
                      dist=dist, graphs=False)
    plain = ServeEngine(tcfg, tp, slots=2, max_len=16, device="cpu")
    assert _serve(eng, Request) == ref == _serve(plain, Request)
    assert eng.trace_counts == plain.trace_counts == {
        "prefill": 1 if arch == "llama3.2-1b" else 0, "decode": 1}
    tokens = eng.steps["decode"].inputs["tokens"]
    assert isinstance(tokens, DTensor) and tokens.placements == (
        Shard(0), Replicate())
    for key, step in eng.steps.items():
        assert step.pool is None and step.graph is None
        if key != "decode":
            assert all(isinstance(t, DTensor) and t.placements == (
                Replicate(), Replicate()) for t in step.inputs.values())


def _train_case(mesh, microbatches):
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              dtype=torch.float32)
    dist = Dist(mesh, batch_axes=("data",))
    params = tz.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_at_step(
        cfg, ShapeCfg("t", 16, 4, "train"), 0).items()}
    specs = tz.param_specs(cfg, dist)
    opt_cfg = dataclasses.replace(optim.for_model(cfg), lr=1e-3)
    make = lambda **kw: train_step.jit_train_step(  # noqa: E731
        cfg, dist, specs, opt_cfg, microbatches=microbatches,
        batch_specs={k: P("data", None) for k in batch}, **kw)
    # A 1x1 mesh's shards are the whole tensors given: lay out copies.
    state = lambda: (lambda p: (p, init_opt_state(opt_cfg, p)))(  # noqa: E731
        shard_tree(optim.tree_map(torch.clone, params), specs, mesh))
    return make, state, batch


@pytest.mark.parametrize("microbatches", [1, 2])
def test_jit_train_step_adopts_dtensor_state(mesh, monkeypatch,
                                             microbatches):
    """``jit_train_step`` through its cached step with the caller's DTensor
    state as its buffers (``graphs`` forced on with no graph pool, so the
    step runs eagerly on them): two calls return the very DTensors given,
    build one step, and equal the eager meshed step's loss and leaves."""
    make, state, batch = _train_case(mesh, microbatches)
    eager = make(graphs=False)
    ep, eo = state()
    monkeypatch.setattr(train_step, "resolve_graphs",
                        lambda graphs, dev, what, mesh=None: graphs is None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    run = make()
    gp, go = state()
    given = optim.leaves(gp) + optim.leaves(go.m) + optim.leaves(go.v)
    for _ in range(2):
        ep, eo, _, em = eager(ep, eo, None, batch)
        gp, go, _, gm = run(gp, go, None, batch)
        got = optim.leaves(gp) + optim.leaves(go.m) + optim.leaves(go.v)
        assert all(a is b for a, b in zip(got, given))
        assert torch.equal(gm["loss"].to_local(), em["loss"].to_local())
        assert torch.equal(gm["step"], em["step"])
        assert all(torch.equal(a, b) for a, b in zip(
            optim.leaves(full_tree({"p": gp, "m": go.m, "v": go.v})),
            optim.leaves(full_tree({"p": ep, "m": eo.m, "v": eo.v}))))
    assert run.step.graphs is True and eager.step.graphs is False
    captured, = run.step.steps.values()
    assert captured.pool is None and captured.graph is None
    assert not eager.step.steps


def test_graphs_true_raises_on_a_gloo_mesh(mesh):
    """``graphs=True`` names the mesh (the engine at once, the train step
    at its first call); ``graphs=None`` resolves to eager on it."""
    _, _, tcfg, tp = _model("llama3.2-1b")
    dist = Dist(mesh, batch_axes=("data",))
    why = r"needs a CUDA device; it runs under a mesh on the CPU \(gloo\)"
    with pytest.raises(ValueError, match=why):
        ServeEngine(tcfg, tp, slots=2, max_len=16, device="cpu", dist=dist,
                    graphs=True)
    assert ServeEngine(tcfg, tp, slots=2, max_len=16, device="cpu",
                       dist=dist).graphs is False
    make, state, batch = _train_case(mesh, 1)
    with pytest.raises(ValueError, match=why):
        make(graphs=True)(*state(), None, batch)
    run = make()
    assert run.step.graphs is None
    run(*state(), None, batch)
    assert run.step.graphs is False and not run.step.steps
