"""The port's serving and placement twins (``launch.serve_gnn``,
``launch.expert_placement``, ``launch.serve_lm``) against the reference's
examples on the CPU, as ``tests/test_torch_examples.py`` holds the layout
twins: the same weights, every printed line equal with the timing fields
masked; the serving example's stream, failure and rows, the expert
assignment and the LM's tokens held exactly.  Also ``chip_smoke.py``'s
``ex_serve_lm`` phase rehearsed on the CPU, and each CLI's refusal without
a card."""
import dataclasses
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jz  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.graphs import synthetic_yelp  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    expert_placement, serve_gnn, serve_lm)
from repro_torch.models import transformer as TT  # noqa: E402
from tests.test_torch_examples import (  # noqa: E402
    FWD_TOL, ROOT, assert_same_lines, captured, load_example,
    reference_gnn_params)

TWINS = ("quickstart", "adaptive_relayout", "serve_gnn", "expert_placement",
         "serve_lm")


def test_serve_gnn_twin_matches_reference():
    ref_mod = load_example("serve_gnn_requests")
    engines = []

    class Engine(ref_mod.GNNServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    ref_mod.GNNServeEngine = Engine
    _, ref = captured(ref_mod.main)
    d = synthetic_yelp(n=800, target_links=1000).features.shape[1]
    rec, got = captured(serve_gnn.main, device="cpu",
                        params=reference_gnn_params((d, 16, 4)))
    assert_same_lines(got, ref)
    f, s2 = rec["failure"], rec["second_half"]
    assert round(rec["layout_cost"], 1) == 3071.7
    assert (f["dead"], f["moved"], f["plan"], f["plan_version"],
            f["dirty"]) == (5, 280, "rebuilt", 1, 6)
    assert (s2["local_rows"], s2["cache_hit_rows"], s2["fetched_rows"],
            s2["plan_refreshes"]) == (10786, 3645, 397, 1)
    assert round(s2["fetch_cost"], 1) == 1033.9
    assert rec["overall"]["traces"] == engines[0].fwd.stats["traces"] == 15
    assert rec["dead_vertices_left"] == 0
    assert max(rec["served_max_err"]) <= FWD_TOL


def test_expert_placement_twin_matches_reference():
    ref_mod = load_example("expert_placement")
    parts = []
    layout = ref_mod.expert_layout

    def recording(*a, **kw):
        parts.append(layout(*a, **kw))
        return parts[-1]

    ref_mod.expert_layout = recording
    _, ref = captured(ref_mod.main)
    rec, got = captured(expert_placement.main, device="cpu")
    assert got == ref
    assert rec["assign"] == parts[0].assign.tolist()
    assert rec["per_slice_experts"] == [8] * 8
    counts = ref_mod.synth_routing()
    assert np.array_equal(counts, expert_placement.synth_routing())


def _reference_lm():
    jcfg = dataclasses.replace(j_get_smoke("llama3.2-1b"), dtype=jnp.float32)
    return jcfg, jz.init_params(jcfg, jax.random.PRNGKey(0))


def test_serve_lm_twin_matches_reference():
    ref_mod = load_example("serve_lm")
    reqs = []
    request = ref_mod.Request

    def recording(**kw):
        reqs.append(request(**kw))
        return reqs[-1]

    ref_mod.Request = recording
    _, ref = captured(ref_mod.main)
    _, jp = _reference_lm()
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rec, got = captured(serve_lm.main, device="cpu", params=tp)
    assert_same_lines(got, ref)
    assert rec["tokens"] == [list(map(int, r.out_tokens)) for r in reqs]
    assert rec["prompts"] == [r.prompt.tolist() for r in reqs]
    assert (rec["completed"], rec["ticks"], rec["prefills"],
            rec["generated_tokens"]) == (12, 33, 12, 132)


def _attention_counting(monkeypatch, on_card):
    """Attention routed through K2's wrapper with its plain version behind a
    counter that adds one to the kernel the card would take, while
    ``on_card()`` says so; the CPU's plain attention otherwise."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import common as TC
    plain_forward, plain_attention = FA._forward, TC.attention_any

    def forward(q, k, v, kv_len, causal, scale):
        path = FA.kernel_path(q.dtype, q.shape[1], k.shape[1], q.shape[2],
                              q.shape[3],
                              all(FA.aligned16(t) for t in (q, k, v)))
        FA.flash_attention.launches += 1
        FA.flash_attention.launches_by_path[path] += 1
        return plain_forward(q, k, v, kv_len, causal, scale)

    def attention_any(q, k, v, *, causal, chunk, kv_len=None):
        if not on_card():
            return plain_attention(q, k, v, causal=causal, chunk=chunk,
                                   kv_len=kv_len)
        return FA.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), kv_len,
                                  causal=causal).transpose(1, 2)

    monkeypatch.setattr(FA, "_forward", forward)
    monkeypatch.setattr(TC, "attention_any", attention_any)
    monkeypatch.setattr(TT, "attention_any", attention_any)


def test_chip_smoke_ex_serve_lm_runs_on_cpu(monkeypatch, capsys):
    """``ex_serve_lm`` with the full model cut to the smoke width in bf16:
    the reduced run's tokens equal the CPU run's, two of the full run's
    requests are re-scored by a teacher-forced forward within the gap
    tolerance, and both runs' K2 launches equal n_layers x (prefills +
    ticks) by the kernel each call takes; the re-score adds none.  The
    phase's card run is the one given a ``torch.device``."""
    import importlib.util
    import json
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve as launch_serve
    from tests.test_torch_ssm import keep_counts

    keep_counts(monkeypatch)
    spec = importlib.util.spec_from_file_location("chip_smoke_exlm_cpu",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = {"now": False}
    main = serve_lm.main

    def run(full=False, device="cuda", params=None):
        card["now"] = isinstance(device, torch.device)
        try:
            return main(full=full, device=device, params=params)
        finally:
            card["now"] = False

    smoke = get_smoke_config("llama3.2-1b")
    monkeypatch.setattr(serve_lm, "main", run)
    monkeypatch.setattr(launch_serve, "get_config", lambda arch: smoke)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    _attention_counting(monkeypatch, lambda: card["now"])
    before = dict(FA.flash_attention.launches_by_path)
    by_path = cs.phase_ex_serve_lm(torch.device("cpu"))
    added = {k: FA.flash_attention.launches_by_path[k] - before[k]
             for k in before}
    assert added == by_path and sum(by_path.values()) == 2 * 2 * (12 + 33)
    line = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"phase": "ex_serve_lm"')][0]
    assert line["reduced"]["tokens_equal_cpu"]
    assert line["full"]["record"]["dtype"] == "torch.bfloat16"
    assert line["full"]["teacher_forced_checked"] == 2 * 12
    assert line["full"]["teacher_forced_max_gap"] <= cs.SERVE_GAP_TOL


@pytest.mark.parametrize("name", TWINS)
def test_twin_cli_runs_on_cpu_and_refuses_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    args = {"adaptive_relayout": ["--slots", "2", "--n", "200",
                                  "--links", "300"],
            "quickstart": ["--n", "200", "--links", "300"],
            "serve_gnn": ["--requests", "64", "--n", "200",
                          "--links", "300"]}.get(name, [])
    cmd = [sys.executable, "-m", f"repro_torch.launch.{name}"] + args
    ok = subprocess.run(cmd + ["--device", "cpu"], env=env,
                        capture_output=True, text=True, timeout=300)
    assert ok.returncode == 0, ok.stderr
    assert ok.stdout.startswith("== ") and len(ok.stdout.splitlines()) > 1
    refused = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=300)
    assert refused.returncode != 0
    assert "CUDA device requested" in refused.stderr
