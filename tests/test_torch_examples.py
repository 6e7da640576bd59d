"""The port's example twins (``repro_torch.launch.*``) against the
reference's examples, on the CPU: each twin runs with ``device="cpu"`` and
the reference's weights beside the reference example's ``main()``
(imported by path, its standard output captured), and every printed line
is held equal, with the timing fields masked and the forward floats
(``max_err``, ``emb=``) within ``FWD_TOL``.  This file holds the layout
twins (quickstart, adaptive_relayout), the ego forward's trace count, and
``chip_smoke.py``'s GNN example phases rehearsed at a small size;
``tests/test_torch_examples_serve.py`` holds the serving twins."""
import contextlib
import importlib.util
import io
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.gnn import GNNConfig as JGNNConfig  # noqa: E402
from repro.gnn import init_params as j_init_params  # noqa: E402
from repro.gnn import serving as JS  # noqa: E402
from repro_torch.gnn import GNNConfig, params_from_jax  # noqa: E402
from repro_torch.gnn import serving as TS  # noqa: E402
from repro_torch.graphs import synthetic_yelp  # noqa: E402
from repro_torch.launch import adaptive_relayout, quickstart  # noqa: E402
from tests.test_torch_ssm import keep_counts  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FWD_TOL = 2e-4         # the reference's BSP gate (test_distributed_gnn)

# Printed fields that are times: masked before lines are compared.
TIMING = (r"\d+\.\d+s\)", r"\d+ req/s", r"p99 [\d.]+ ms", r"in \d+ ms",
          r"in [\d.]+s \([\d.]+ tok/s on \w+\)")
# Printed forward floats: compared within FWD_TOL.
FLOATS = (r"max_err=(\S+)", r"emb=(\S+)")


def load_example(name: str):
    """The reference's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def captured(fn, *args, **kw):
    """``fn``'s return value and its printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


def _split(line: str):
    floats = []
    for pat in FLOATS:
        floats += [float(x) for x in re.findall(pat, line)]
        line = re.sub(pat, lambda m: m.group(0).replace(m.group(1), "<f>"),
                      line)
    for pat in TIMING:
        line = re.sub(pat, "<t>", line)
    return line, floats


def assert_same_lines(got, ref):
    """Printed lines equal but for times; forward floats within FWD_TOL."""
    assert len(got) == len(ref), (got, ref)
    for a, b in zip(got, ref):
        (ta, fa), (tb, fb) = _split(a), _split(b)
        assert ta == tb, (a, b)
        assert len(fa) == len(fb) and all(
            abs(x - y) <= FWD_TOL for x, y in zip(fa, fb)), (a, b)


def reference_gnn_params(dims, model="gcn"):
    """The reference's ``init_params(PRNGKey(0))`` for ``dims``, carried to
    the port on the CPU."""
    jp = j_init_params(jax.random.PRNGKey(0), JGNNConfig(model, dims))
    return params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


# ------------------------------------------------------------------ twins
def test_quickstart_twin_matches_reference():
    ref_out, ref = captured(load_example("quickstart").main)
    rec, got = captured(quickstart.main, device="cpu",
                        params=reference_gnn_params((100, 16, 2)))
    assert ref_out is None
    assert_same_lines(got, ref)
    assert rec["costs"]["glad_s"] <= rec["costs"]["greedy"] \
        < rec["costs"]["random"]
    assert rec["iterations"] == 85
    assert {k: round(v, 1) for k, v in rec["factors"].items()} == {
        "C_U": 109.1, "C_P": 35.1, "C_T": 0.0, "C_M": 118.0, "total": 262.2}
    lay = rec["layouts"]
    assert [lay["random"][k] for k in ("cut_links", "halo_rows_exchanged",
                                       "ppermute_rounds")] == [700, 789, 7]
    assert [lay["GLAD-S"][k] for k in ("cut_links", "halo_rows_exchanged",
                                       "ppermute_rounds")] == [0, 0, 0]
    assert max(v["max_err"] for v in lay.values()) <= FWD_TOL


def test_adaptive_relayout_twin_matches_reference():
    ref_mod = load_example("adaptive_relayout")
    _, ref = captured(ref_mod.main, slots=30)
    d = synthetic_yelp(n=800, target_links=1000).features.shape[1]
    rec, got = captured(adaptive_relayout.main, slots=30, device="cpu",
                        params=reference_gnn_params((d, 16, 4)))
    assert_same_lines(got, ref)
    slots = rec["slots"]
    assert rec["glad_s_slots"] == 21 and len(slots) == 30
    assert [s["t"] for s in slots if s["plan"] == "REBUILD"] == [7]
    assert (rec["patched"], rec["rebuilt"], rec["plan_version"]) == (29, 1, 30)
    assert (rec["cap"], rec["halo_cap"], rec["e_cap"]) == (1232, 168, 2024)
    assert round(rec["final_cost"], 1) == 410.7
    # One resident forward bound to the live plan: it rebuilt exactly when
    # a patch said the signature moved, and every slot's output is the
    # whole-graph forward's.
    assert rec["builds_first"] == 1
    assert rec["builds"] - rec["builds_first"] == rec["retrace_expected"]
    assert max([rec["initial_max_err"]] + [s["max_err"] for s in slots]) \
        <= FWD_TOL


# --------------------------------------------------------- ego trace count
def test_ego_forward_traces_equal_the_reference_jit_traces():
    """``stats['traces']`` counts the distinct input signatures the port's
    forward saw: over the same batches, the reference's jit trace count."""
    rng = np.random.default_rng(0)
    g = synthetic_yelp(n=300, target_links=500)
    dims = (g.features.shape[1], 8, 4)
    jp = j_init_params(jax.random.PRNGKey(0), JGNNConfig("gcn", dims))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jfwd = JS.make_ego_forward(JGNNConfig("gcn", dims), jp)
    tfwd = TS.make_ego_forward(GNNConfig("gcn", dims), tp, device="cpu")
    assert tfwd.stats == {"traces": 0}
    deg = g.degrees.astype(np.float32)
    counts = []
    for b in (16, 16, 4, 16, 1, 4, 16):
        targets = rng.integers(0, g.n, size=b)
        ego = TS.extract_ego_batch(g, targets, 2, batch=16 if b > 8 else b)
        feats, d, rows = TS.ego_tables(ego, g.features, deg)
        out = tfwd(feats, ego.arcs, d, rows)
        ref = np.asarray(jfwd(feats, ego.arcs, d, rows))
        assert np.abs(out.numpy() - ref).max() <= FWD_TOL
        counts.append((tfwd.stats["traces"], jfwd.stats["traces"]))
    assert all(t == j for t, j in counts), counts
    assert counts[-1][0] > 1


# ------------------------------------------ chip_smoke.py's example phases
def _chip_smoke_gnn_on_cpu(monkeypatch):
    """``chip_smoke.py`` as a module, its GNN example phases shrunk and set
    up for the CPU: the block-sparse aggregate forced for GCN/SAGE, K1's
    plain product behind a wrapper that counts launches, the CUDA clock
    stubbed."""
    from repro_torch.gnn import distributed as TD
    from repro_torch.kernels import gnn_aggregate as GA

    keep_counts(monkeypatch)
    spec = importlib.util.spec_from_file_location("chip_smoke_ex_cpu",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    plain_product = GA._product

    def product(packed, feats, direction):
        GA.spmm.launches += 1
        GA.spmm.launches_by_dir[direction] += 1
        return plain_product(packed, feats, direction)

    resolve = TD.resolve_aggregate
    monkeypatch.setattr(GA, "_product", product)
    monkeypatch.setattr(TD, "resolve_aggregate", lambda cfg, agg, dev="cuda":
                        resolve(cfg, "bsr" if agg == "auto" else agg, dev))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "EX_YELP", {"n": 400, "links": 600})
    monkeypatch.setattr(cs, "EX_SIOT", {"graph": "siot", "n": 400,
                                        "links": 1200})
    monkeypatch.setattr(cs, "EX_RELAYOUT_SLOTS", 4)
    monkeypatch.setattr(cs, "EX_REQUESTS", 160)
    return cs


def test_chip_smoke_example_gnn_phases_run_on_cpu(monkeypatch, capsys):
    """``ex_quickstart``, ``ex_relayout``, ``ex_serve_gnn`` and
    ``ex_experts`` at a small size: every gate holds, with K1 launched
    twice a BSP forward (2 x 2 in quickstart, 2 x (slots + 1) in the
    relayout) and never by the ego forward."""
    cs = _chip_smoke_gnn_on_cpu(monkeypatch)
    dev = torch.device("cpu")
    from repro_torch.kernels import gnn_aggregate as GA
    before = GA.spmm.launches
    cs.phase_ex_quickstart(dev)
    cs.phase_ex_relayout(dev)
    cs.phase_ex_serve_gnn(dev)
    cs.phase_ex_experts(dev)
    assert GA.spmm.launches - before == 4 + 2 * 5
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"phase"')]
    phases = [__import__("json").loads(ln)["phase"] for ln in lines]
    assert phases == ["ex_quickstart", "ex_relayout", "ex_serve_gnn",
                      "ex_experts"]
