"""Port MoE family vs the JAX reference on the same weights: the router, the
grouped GEMM (``ragged_dot``'s semantics), the routed dropless FFN against
the reference's dense oracle and its 1x1-mesh expert-parallel path, then
deepseek-moe-16b's and kimi-k2's smoke configs end to end (forward and aux,
``loss_fn``, bucketed prefill and decode, the serving engine, the CLI), the
per-layer init and the routed path's determinism."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jz  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.jaxcompat import make_mesh  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.common import LMConfig as JLMConfig  # noqa: E402
from repro.serve import Request as JRequest, ServeEngine as JServeEngine  # noqa: E402
from repro_torch import models as tz  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import LMConfig  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5                                   # fp32, another summation order
MOE = ["deepseek-moe-16b", "kimi-k2-1t-a32b"]


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=tol,
                               atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ router
@pytest.mark.parametrize("shape,E,k", [((3, 5, 16), 8, 3), ((2, 9, 32), 16, 4),
                                       ((1, 4, 64), 64, 6)])
def test_router_topk_matches_reference(shape, E, k):
    rng = np.random.default_rng(E)
    x = rng.normal(size=shape).astype(np.float32)
    wr = rng.normal(size=(shape[-1], E)).astype(np.float32)
    j_idx, j_w, j_aux = JM.router_topk(jnp.asarray(x), jnp.asarray(wr), k)
    idx, w, aux = TM.router_topk(_t(x), _t(wr), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    _close(w, j_w, 1e-6)
    _close(aux, j_aux, 1e-6)
    assert w.dtype == torch.float32 and idx.shape == shape[:-1] + (k,)


# ------------------------------------------------------------ grouped GEMM
@pytest.mark.parametrize("short", [0, 5])
@pytest.mark.parametrize("m,k,n,g", [(32, 16, 12, 4), (64, 8, 8, 8),
                                     (16, 32, 4, 2)])
def test_grouped_gemm_matches_reference(m, k, n, g, short):
    """The reference's cases (tests/test_moe_and_loss.py); with ``short``
    the groups cover all but the last rows, which give 0."""
    rng = np.random.default_rng(m + g + short)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(g, k, n)).astype(np.float32)
    gs = rng.multinomial(m - short, np.ones(g) / g).astype(np.int32)
    ref = JM.grouped_gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs))
    before = dict(TM.grouped_gemm.launches_by_route)
    out = TM.grouped_gemm(_t(x), _t(w), _t(gs))
    _close(out, ref)
    assert torch.equal(out[m - short:], torch.zeros((short, n)))
    assert TM.grouped_gemm.launches_by_route == {
        **before, "loop": before["loop"] + 1}


def test_grouped_gemm_route_rule():
    """The CPU always loops; the rule reads the device and the row
    lengths, never the dtype or the group sizes."""
    x = torch.zeros((4, 16), dtype=torch.bfloat16)
    w = torch.zeros((2, 16, 8), dtype=torch.bfloat16)
    assert TM.grouped_gemm_route(x, w) == "loop"
    assert TM.grouped_gemm_route(x.float(), w.float()) == "loop"


# --------------------------------------------------------------- MoE FFN
def _ffn_case(seed, T=(2, 6), d=16, E=4, k=2, f=8):
    """Inputs of tests/test_models_zoo.py's 1x1-mesh case, from numpy."""
    cfg_args = dict(name="t", family="moe", n_layers=1, d_model=d, n_heads=2,
                    n_kv_heads=2, d_ff=0, vocab=64, n_experts=E, top_k=k,
                    expert_d_ff=f, capacity_factor=4.0)
    jcfg = JLMConfig(**cfg_args, dtype=jnp.float32)
    tcfg = LMConfig(**cfg_args, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(size=(d, E)) * 0.1,
         "w13": rng.normal(size=(E, d, 2 * f)) * 0.1,
         "w2": rng.normal(size=(E, f, d)) * 0.1}
    p = {key: v.astype(np.float32) for key, v in p.items()}
    x = rng.normal(size=T + (d,)).astype(np.float32)
    return jcfg, tcfg, p, x


@pytest.mark.parametrize("seed,T,E,k", [(0, (2, 6), 4, 2), (1, (3, 7), 8, 3),
                                        (2, (1, 1), 4, 2)])
def test_moe_ffn_matches_dense_ref_and_mesh_path(seed, T, E, k):
    jcfg, tcfg, p, x = _ffn_case(seed, T, E=E, k=k)
    jp = {key: jnp.asarray(v) for key, v in p.items()}
    ref, ref_aux = JM.moe_ffn_dense_ref(jcfg, jp, jnp.asarray(x))
    mesh = make_mesh((1, 1), ("data", "model"))
    sharded, _ = jax.jit(lambda p, x: JM.moe_ffn(jcfg, p, x, mesh,
                                                 ("data",)))(jp, jnp.asarray(x))
    tp = {key: _t(v) for key, v in p.items()}
    out, aux = TM.moe_ffn(tcfg, tp, _t(x))
    _close(out, ref)
    _close(out, sharded)
    _close(aux, ref_aux, 1e-6)
    dense, dense_aux = TM.moe_ffn_dense_ref(tcfg, tp, _t(x))
    _close(dense, ref)
    _close(dense_aux, ref_aux, 1e-6)


def test_routed_path_is_bit_equal_run_to_run():
    _, tcfg, p, x = _ffn_case(3, (4, 33), d=32, E=8, k=3)
    tp = {key: _t(v) for key, v in p.items()}
    first, _ = TM.moe_ffn(tcfg, tp, _t(x))
    for _ in range(3):
        assert torch.equal(TM.moe_ffn(tcfg, tp, _t(x))[0], first)
    # A token's result does not depend on the rest of the batch beyond
    # rounding: the first row alone agrees with the batch.
    alone, _ = TM.moe_ffn(tcfg, tp, _t(x[:1, :5]))
    _close(alone, first[:1, :5], 1e-6)


# ----------------------------------------------------------- whole models
def _configs(arch):
    jcfg = dataclasses.replace(j_get_smoke(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(registry.get_smoke_config(arch),
                               dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=MOE)
def pair(request):
    """Smoke configs in fp32 and the reference's weights carried across."""
    jcfg, tcfg = _configs(request.param)
    jp = jz.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def test_params_layout_equals_reference(pair):
    jcfg, jp, tcfg, tp = pair
    own = tz.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    flat_j = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
              for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}

    def flat(d, pre=""):
        out = {}
        for k, v in d.items():
            out.update(flat(v, f"{pre}{k}/") if isinstance(v, dict)
                       else {f"{pre}{k}": v})
        return out
    for tree in (tp, own):
        got = flat(tree)
        assert sorted(got) == sorted(flat_j)
        for name, t in got.items():
            assert tuple(t.shape) == tuple(flat_j[name].shape), name
    assert "dense_layers/w13" in flat_j and "layers/moe_w13" in flat_j


def test_forward_and_loss_match_reference(pair):
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(0)
    tok = rng.integers(1, 500, size=(2, 13))
    lab = rng.integers(0, 500, size=(2, 13))
    lab[0, :3] = -100
    ref, ref_aux = jz.forward(jcfg, jp, {"tokens": jnp.asarray(tok, jnp.int32)})
    out, aux = tz.forward(tcfg, tp, {"tokens": torch.from_numpy(tok)})
    assert out.shape == ref.shape
    _close(out, ref)
    _close(aux, ref_aux)
    assert float(aux) > 0.0
    jb = {"tokens": jnp.asarray(tok, jnp.int32),
          "labels": jnp.asarray(lab, jnp.int32)}
    ref_loss = jz.loss_fn(jcfg, jp, jb)
    loss = tz.loss_fn(tcfg, tp, {"tokens": torch.from_numpy(tok),
                                 "labels": torch.from_numpy(lab)})
    _close(loss, ref_loss)


@pytest.mark.parametrize("bucketed", [False, True])
def test_prefill_then_decode_matches_reference(pair, bucketed):
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(1)
    tok = rng.integers(1, 500, size=(2, 16))
    jb = {"tokens": jnp.asarray(tok, jnp.int32)}
    tb = {"tokens": torch.from_numpy(tok)}
    if bucketed:
        lens = np.array([9, 16], np.int32)       # row 0 right-padded
        jb["lengths"] = jnp.asarray(lens)
        tb["lengths"] = torch.from_numpy(lens)
    jl, jc = jax.jit(lambda p, b: jz.prefill(jcfg, p, b, 40))(jp, jb)
    tl, tc = tz.prefill(tcfg, tp, tb, 40)
    j_decode = jax.jit(lambda p, t, c: jz.decode_step(jcfg, p, t, c))
    _close(tl, jl)
    for key in ("k", "v"):
        assert tc[key].shape == jc[key].shape
        _close(tc[key], jc[key])
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    for step in range(4):
        nxt = rng.integers(1, 500, size=(2, 1))
        jl, jc = j_decode(jp, jnp.asarray(nxt, jnp.int32), jc)
        tl, tc = tz.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
        _close(tl, jl)
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    for key in ("k", "v"):
        _close(tc[key], jc[key])


def test_prefill_decode_matches_forward(pair):
    """prefill(prompt) + decode_step(next) == forward(prompt + next)[-1]
    (the reference's tests/test_models_zoo.py check, inside the port)."""
    _, _, tcfg, tp = pair
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab, size=(2, 12)))
    _, cache = tz.prefill(tcfg, tp, {"tokens": toks[:, :8]}, 16)
    lg, _ = tz.decode_step(tcfg, tp, toks[:, 8:9], cache)
    full, _ = tz.forward(tcfg, tp, {"tokens": toks[:, :9]})
    _close(lg[:, 0], full[:, -1])


def _serve(engine, request_cls, prompts, max_new):
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=max_new, eos_id=-1)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    stats = engine.run(max_ticks=50)
    return [r.out_tokens for r in reqs], dataclasses.asdict(stats)


def test_engine_matches_reference(pair):
    """Queueing behind 2 slots over 3 buckets: the same tokens and stats as
    the reference's engine."""
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 400, size=n).astype(np.int32)
               for n in (5, 3, 12, 4, 7)]
    ref = _serve(JServeEngine(jcfg, jp, slots=2, max_len=64), JRequest,
                 prompts, 6)
    got = _serve(ServeEngine(tcfg, tp, slots=2, max_len=64, device="cpu"),
                 Request, prompts, 6)
    assert got == ref


def test_engine_keeps_weights_already_in_compute_dtype(pair):
    _, _, tcfg, tp = pair
    eng = ServeEngine(tcfg, tp, slots=1, max_len=16, device="cpu")
    assert eng.params["layers"]["moe_w13"] is tp["layers"]["moe_w13"]
    assert eng.params["dense_layers"]["w13"] is tp["dense_layers"]["w13"]


def test_engine_keeps_the_router_in_fp32_under_bf16_compute():
    """dtype bf16 over param_dtype fp32 (deepseek-moe-16b's own split): the
    reference routes with the router read .astype(float32), so the engine
    keeps the fp32 tensor it was given, and routing over the engine's
    weights is routing over the fp32 weights, bit for bit."""
    cfg = dataclasses.replace(registry.get_smoke_config("deepseek-moe-16b"),
                              dtype=torch.bfloat16, param_dtype=torch.float32)
    tp = tz.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(cfg, tp, slots=1, max_len=16, device="cpu")
    router = eng.params["layers"]["router"]
    assert router is tp["layers"]["router"]
    assert router.dtype == torch.float32
    assert eng.params["layers"]["moe_w13"].dtype == torch.bfloat16
    x = torch.randn((3, 7, cfg.d_model), generator=torch.Generator().manual_seed(
        1)).to(torch.bfloat16)
    for layer in range(router.shape[0]):
        got = TM.router_topk(x, router[layer], cfg.top_k)
        ref = TM.router_topk(x, tp["layers"]["router"][layer].float(),
                             cfg.top_k)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def test_launch_serve_cli_runs_deepseek_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--arch", "deepseek-moe-16b", "--smoke", "--device",
                        "cpu", "--requests", "4", "--max-new", "4"],
                       env=env, capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "4/4 requests" in r.stdout and "on cpu" in r.stdout


# ---------------------------------------------------------------- init
@pytest.mark.parametrize("arch", MOE + ["llama3.2-1b"])
def test_bf16_init_is_the_fp32_init_rounded_once(arch):
    cfg = registry.get_smoke_config(arch)
    f32 = tz.init_params(dataclasses.replace(cfg, param_dtype=torch.float32),
                         torch.Generator().manual_seed(0), device="cpu")
    b16 = tz.init_params(dataclasses.replace(cfg, param_dtype=torch.bfloat16),
                         torch.Generator().manual_seed(0), device="cpu")

    def check(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for key in a:
                check(a[key], b[key])
        else:
            assert b.dtype == torch.bfloat16
            assert torch.equal(a.to(torch.bfloat16), b)
    check(f32, b16)


def test_init_scales_follow_fan_in():
    cfg = registry.get_smoke_config("deepseek-moe-16b")
    p = tz.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert float(p["layers"]["moe_w13"].std()) == pytest.approx(
        cfg.d_model ** -0.5, rel=0.1)
    assert float(p["layers"]["moe_w2"].std()) == pytest.approx(
        cfg.expert_d_ff ** -0.5, rel=0.1)
    assert p["dense_layers"]["w13"].shape == (1, cfg.d_model, 2 * cfg.d_ff)
    assert p["layers"]["router"].shape == (cfg.n_layers - 1, cfg.d_model,
                                           cfg.n_experts)


# ------------------------------------------------------------- registry
@pytest.mark.parametrize("arch", MOE)
def test_registry_configs_equal_reference(arch):
    for get_t, get_j in ((registry.get_config, j_get_config),
                         (registry.get_smoke_config, j_get_smoke)):
        t, j = get_t(arch), get_j(arch)
        tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
        jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
        for key in ("dtype", "param_dtype"):
            assert str(tf.pop(key)).split(".")[-1] == jnp.dtype(
                jf.pop(key)).name
        assert tf == jf
        assert (t.hd, t.group, t.params_count()) == (j.hd, j.group,
                                                     j.params_count())
    full = registry.get_config("deepseek-moe-16b")
    assert full.params_count() == pytest.approx(16.4e9, rel=0.01)


# ------------------------------------------------- chip_smoke.py rehearsal
class _HostEvent:
    """``torch.cuda.Event`` on the host clock (CPU rehearsal only)."""

    def __init__(self, enable_timing=False):
        self.t = 0.0

    def record(self, *a):
        import time
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_chip_smoke_moe_phases_run_on_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s ``moe_parity`` and ``moe_serve`` phases (the fp32
    router check included) on the CPU at deepseek's smoke width (head dim 64, so bf16 attention names the
    ``prefill_tc`` kernel): K2's plain version stands in behind a counting
    wrapper, every grouped GEMM takes the grouped_mm route (torch's CPU
    ``_grouped_mm``) as on the card, and the CUDA clock, memory stats and
    timers are stubbed.  Every check of the phases holds, with the launch
    counts the card run requires."""
    import importlib.util
    import json
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import common as TC

    from test_torch_ssm import keep_counts

    keep_counts(monkeypatch)
    spec = importlib.util.spec_from_file_location("chip_smoke_moe_cpu",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    small = dataclasses.replace(registry.get_smoke_config("deepseek-moe-16b"),
                                head_dim=64)
    plain_forward = FA._forward

    def forward(q, k, v, kv_len, causal, scale):
        path = FA.kernel_path(q.dtype, q.shape[1], k.shape[1], q.shape[2],
                              q.shape[3],
                              all(FA.aligned16(t) for t in (q, k, v)))
        FA.flash_attention.launches += 1
        FA.flash_attention.launches_by_path[path] += 1
        return plain_forward(q, k, v, kv_len, causal, scale)

    plain_attention = TC.attention_any
    on_card = {"now": True}

    def attention_any(q, k, v, *, causal, chunk, kv_len=None):
        if not on_card["now"]:
            return plain_attention(q, k, v, causal=causal, chunk=chunk,
                                   kv_len=kv_len)
        return FA.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), kv_len,
                                  causal=causal).transpose(1, 2)

    lm_run, runs = cs._lm_run, []

    def lm_run_once_on_card(*args):
        """moe_parity's first run stands for the card's, the second is the
        CPU's and takes the plain attention."""
        on_card["now"] = not runs
        runs.append(1)
        try:
            return lm_run(*args)
        finally:
            on_card["now"] = True

    def route(x, w):
        return "grouped_mm"

    monkeypatch.setattr(cs, "get_config", lambda arch: small)
    monkeypatch.setattr(FA, "_forward", forward)
    monkeypatch.setattr(TC, "attention_any", attention_any)
    monkeypatch.setattr(TT, "attention_any", attention_any)
    monkeypatch.setattr(TM, "grouped_gemm_route", route)
    monkeypatch.setattr(cs, "_lm_run", lm_run_once_on_card)
    for name, fn in (("synchronize", lambda *a: None),
                     ("empty_cache", lambda: None),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("max_memory_allocated", lambda *a: 0),
                     ("memory_allocated", lambda *a: 0),
                     ("Event", _HostEvent)):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(cs, "time_ms", lambda fn, reps=25, warmup=3:
                        (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "device_ms", lambda fn, **kw: (fn(), 0.0)[1])

    dev = torch.device("cpu")
    cs._zero_counts()
    cs.phase_moe_parity(dev)
    assert len(runs) == 2
    launches, by_path = cs.phase_moe_serve(dev, [
        {"shape": "deepseek_decode_B8_S2048_D128", "device_ms": 0.0}])
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    serve = next(o for o in out if o.get("phase") == "moe_serve")
    n = small.n_layers
    assert by_path == {"decode": n * serve["ticks"],
                       "prefill_tc": n * serve["prefills"], "general": 0}
    assert launches == n * (serve["ticks"] + serve["prefills"])
    assert serve["grouped_gemm_launches_by_route"] == {
        "grouped_mm": 2 * (n - 1) * (serve["ticks"] + serve["prefills"]),
        "loop": 0}
    assert max(serve["route_flip_max_share_of_a_layer"].values()) <= 0.5
    assert serve["teacher_forced_checked"] == 64
    assert serve["teacher_forced_max_gap"] <= cs.SERVE_GAP_TOL
    fp32 = next(o for o in out if o.get("phase") == "moe_route_fp32")
    assert fp32["route_flips"] <= 0.01 * fp32["route_pairs"]
    assert fp32["teacher_forced_checked"] == 64
    parity = next(o for o in out if o.get("phase") == "moe_parity")
    assert parity["expert_sets_equal"] and parity["greedy_tokens_equal"]
    assert any(o.get("phase") == "moe_profile" for o in out)
