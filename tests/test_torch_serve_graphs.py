"""The serving engine's compiled steps on the CPU, against the reference
engine's ``jax.jit`` steps.

On the CPU ``ServeEngine`` resolves ``graphs`` to False: it builds the same
steps (static input buffers, one decode step, one prefill step per bucket
for the KV-cache families) and runs each eagerly on its buffers.  So these
tests hold the buffer plumbing and ``trace_counts`` against the reference;
the capture itself runs on the card (``tests/test_torch_cuda.py``).

* The reference's own scenario (``tests/test_serve.py``: 14 prompt lengths,
  3 to 16) for the dense and MoE smoke models: ``trace_counts`` equal to
  the reference engine's (3 prefill buckets, 1 decode) and its tokens.
* Each decoder-only family: the tokens and the ``len`` vector after every
  tick equal to the reference engine's, through a freed slot taken by a
  queued request and an idle slot counted past ``max_len``; the per-tick
  logits bit-equal to an engine built with ``graphs=False``; no step
  function reads a value to the host (what a CUDA graph cannot capture),
  run on meta tensors, which have no values to read.
* ``graphs=True`` raises on the CPU, under a gloo 1x1 mesh and for an fp32
  MoE model (whose grouped GEMM reads the host); ``graphs=None`` resolves
  to False in each.
"""
import dataclasses
import socket

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jz  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.serve import Request as JRequest, ServeEngine as JServeEngine  # noqa: E402
from repro_torch import models as tz  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import Dist  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

FAMILIES = ["llama3.2-1b", "deepseek-moe-16b", "zamba2-1.2b", "xlstm-1.3b",
            "internvl2-2b"]
BUCKETED = ("llama3.2-1b", "deepseek-moe-16b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the smoke models' eager loops make many tiny
    ops, which extra threads only slow where other workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _model(arch):
    """The smoke config in fp32 and the reference's weights carried
    across (built once per arch)."""
    if arch not in _MODELS:
        jcfg = dataclasses.replace(j_get_smoke(arch), dtype=jnp.float32)
        tcfg = dataclasses.replace(get_smoke_config(arch),
                                   dtype=torch.float32)
        jp = jz.init_params(jcfg, jax.random.PRNGKey(0))
        tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[arch] = jcfg, jp, tcfg, tp
    return _MODELS[arch]


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 400, size=n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("arch", BUCKETED)
def test_trace_counts_equal_the_reference_engines(arch):
    """tests/test_serve.py's scenario: 14 distinct lengths over 2 slots
    build 3 prefill steps (buckets 4, 8, 16) and 1 decode step, exactly as
    many as the reference engine traces, and serve its tokens."""
    jcfg, jp, tcfg, tp = _model(arch)
    prompts = _prompts(1, range(3, 17))
    engines = (JServeEngine(jcfg, jp, slots=2, max_len=64),
               ServeEngine(tcfg, tp, slots=2, max_len=64, device="cpu"))
    tokens = []
    for eng, cls in zip(engines, (JRequest, Request)):
        reqs = [cls(uid=i, prompt=p, max_new_tokens=3, eos_id=-1)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        tokens.append([r.out_tokens for r in reqs])
    ref, got = engines
    assert got.graphs is False
    assert got.trace_counts == ref.trace_counts == {"prefill": 3,
                                                    "decode": 1}
    assert set(got.steps) == {"decode", ("prefill", 4), ("prefill", 8),
                              ("prefill", 16)}
    assert tokens[1] == tokens[0]


# (prompt length, max_new_tokens) of each request, run by run, over two
# slots and a 16-position cache: three requests at once (the third queued
# until the first frees its slot), then two alone, so the idle slot's len
# runs past max_len.  One prompt length: the reference compiles a prefill
# for each length of the exact-length families.
RUNS = (((5, 3), (5, 7), (5, 4)), ((5, 10),), ((5, 10),))


def _serve_runs(eng, cls, logits=None):
    """Serve RUNS on ``eng``: (tokens, the len vector after every tick);
    with ``logits`` (a list) also each tick's decode logits."""
    rng = np.random.default_rng(3)
    tokens, lens, uid = [], [], 0
    for run in RUNS:
        reqs = []
        for n, max_new in run:
            reqs.append(cls(uid=uid, prompt=rng.integers(
                1, 400, size=n).astype(np.int32), max_new_tokens=max_new,
                eos_id=-1))
            eng.submit(reqs[-1])
            uid += 1
        while eng.queue or any(r is not None for r in eng.live):
            ticks = eng.stats.ticks
            eng.tick()
            lens.append(np.asarray(eng.cache["len"]).tolist())
            if logits is not None and eng.stats.ticks > ticks:
                logits.append(eng.steps["decode"].out[0].clone())
        tokens += [r.out_tokens for r in reqs]
    return tokens, lens


def _meta_steps(arch, monkeypatch, route="grouped_mm"):
    """The engine's step functions, decode and (for the bucketed
    families) prefill, run once on the meta device in bf16 with the MoE's
    grouped GEMM on ``route``.  A meta tensor has no values, so a step
    that reads one to the host raises, as it would fail a CUDA graph's
    capture; scalars the host makes for itself stay readable."""
    cfg = get_smoke_config(arch)
    params = tz.init_params(cfg, torch.Generator().manual_seed(0),
                            device="meta")
    eng = ServeEngine(cfg, params, slots=2, max_len=16, device="meta")
    monkeypatch.setattr(moe, "grouped_gemm_route", lambda x, w: route)
    logits, nxt = eng._decode(torch.zeros((2, 1), dtype=torch.long,
                                          device="meta"))
    assert logits.shape[:2] == (2, 1) and nxt.shape == (2,)
    if arch in BUCKETED:
        eng._prefill(torch.zeros((1, 8), dtype=torch.long, device="meta"),
                     torch.zeros((1,), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("arch", FAMILIES)
def test_steps_serve_as_the_reference_engine(arch, monkeypatch):
    """Each family's tokens and ``len`` vector after every tick equal to
    the reference engine's (a freed slot reused, an idle slot past
    max_len), every tick's logits bit-equal to a ``graphs=False``
    engine's, and every step function free of host reads."""
    jcfg, jp, tcfg, tp = _model(arch)
    ref = _serve_runs(JServeEngine(jcfg, jp, slots=2, max_len=16), JRequest)
    eng = ServeEngine(tcfg, tp, slots=2, max_len=16, device="cpu")
    logits, eager_logits = [], []
    got = _serve_runs(eng, Request, logits)
    eager = ServeEngine(tcfg, tp, slots=2, max_len=16, device="cpu",
                        graphs=False)
    again = _serve_runs(eager, Request, eager_logits)
    assert got == ref and again == got
    assert max(max(v) for v in got[1]) > 16       # the idle slot passed
    assert len(logits) == eng.stats.ticks == len(eager_logits)
    assert all(torch.equal(a, b) for a, b in zip(logits, eager_logits))
    assert eng.trace_counts == {
        "prefill": len([k for k in eng.steps if k != "decode"]),
        "decode": 1}
    assert eng.trace_counts["prefill"] == (1 if arch in BUCKETED else 0)
    _meta_steps(arch, monkeypatch)


def test_the_host_read_check_sees_the_loop_route(monkeypatch):
    """The MoE's loop route reads its group ends to the host: on meta
    tensors the step raises (so fp32 MoE engines stay eager)."""
    with pytest.raises(NotImplementedError, match="meta"):
        _meta_steps("deepseek-moe-16b", monkeypatch, route="loop")


def test_graphs_true_raises_where_steps_are_not_captured():
    """graphs=True raises on the CPU and for an MoE model off the bf16
    grouped_mm route (as ``moe.reads_host`` decides); graphs=None resolves
    to eager there."""
    _, _, tcfg, tp = _model("llama3.2-1b")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        ServeEngine(tcfg, tp, slots=2, max_len=16, device="cpu", graphs=True)
    assert ServeEngine(tcfg, tp, slots=2, max_len=16,
                       device="cpu").graphs is False
    cfg = get_smoke_config("deepseek-moe-16b")
    cpu = torch.device("cpu")
    assert moe.reads_host(cfg, cpu)                 # the CPU's loop route
    assert moe.reads_host(dataclasses.replace(cfg, dtype=torch.float32), cpu)
    assert not moe.reads_host(get_smoke_config("llama3.2-1b"), cpu)


def test_graphs_true_raises_under_a_mesh():
    """A gloo group of one process and its 1x1 mesh: graphs=True raises
    with the mesh as the reason; graphs=None serves eagerly, the tokens of
    the mesh-free engine."""
    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_debug_mesh
    _, _, tcfg, tp = _model("llama3.2-1b")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                             rank=0, world_size=1)
    try:
        dist = Dist(make_debug_mesh(1, 1, device_type="cpu"),
                    batch_axes=("data",))
        with pytest.raises(ValueError, match="under a mesh"):
            ServeEngine(tcfg, tp, slots=2, max_len=16, device="cpu",
                        dist=dist, graphs=True)
        tokens, engines = [], []
        for kw in ({"dist": dist}, {}):
            engines.append(ServeEngine(tcfg, tp, slots=2, max_len=16,
                                       device="cpu", **kw))
            req = Request(uid=0, prompt=np.arange(1, 8), max_new_tokens=4,
                          eos_id=-1)
            engines[-1].submit(req)
            engines[-1].run()
            tokens.append(req.out_tokens)
        meshed = engines[0]
        assert meshed.graphs is False and tokens[0] == tokens[1]
        assert meshed.trace_counts == {"prefill": 1, "decode": 1}
    finally:
        tdist.destroy_process_group()
