"""Port hybrid family (Mamba2 SSD + Zamba2's shared attention) vs the JAX
reference on the same weights: the chunked SSD scan (with and without an
initial state, L = 1, L off the chunk grid, L past one chunk), both
branches of the Mamba2 block, the parameter layout, zamba2-1.2b's smoke
config end to end (forward, ``loss_fn``, exact-length prefill then decode
with every cache key, the serving engine, the CLI), decode after prefill
against ``forward`` (also where the SSM head dim differs from the state
size), the engine's exact-length prefill and its fp32-at-use weights.

Tolerance: TOL = 1e-5 (fp32, another summation order), rtol = atol on
logits and outputs; the SSM state, whose entries grow with the prompt, is
held relative to max|ref|.  Prefill + decode against ``forward`` uses the
reference's own gate for that identity, 2e-3 (tests/test_models_zoo.py)."""
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
from repro.models import ssm as JS  # noqa: E402
from repro.models.transformer import Dist  # noqa: E402
from repro.serve import Request as JRequest, ServeEngine as JServeEngine  # noqa: E402
from repro_torch import models as tz  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5                                   # fp32, another summation order
ZOO_TOL = 2e-3                               # tests/test_models_zoo.py
ARCH = "zamba2-1.2b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the models' eager loops
    make thousands of tiny ops, which extra threads only slow (tenfold
    where other test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=tol,
                               atol=tol)


def _close_rel(out, ref, tol=TOL):
    """max|out - ref| <= tol * max|ref| (states whose scale grows)."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1.0)


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------- SSD scan
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("L", [1, 77, 128, 300])
def test_ssd_chunked_matches_reference(L, with_state):
    rng = np.random.default_rng(L + with_state)
    B, H, P, N = 2, 3, 8, 5
    xbar = rng.normal(size=(B, L, H, P)).astype(np.float32)
    loga = -rng.uniform(0.0, 0.5, size=(B, L, H)).astype(np.float32)
    Bm = rng.normal(size=(B, L, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, N)).astype(np.float32)
    s0 = (rng.normal(size=(B, H, N, P)).astype(np.float32) if with_state
          else None)
    jy, js = JS._ssd_chunked(*map(jnp.asarray, (xbar, loga, Bm, Cm)),
                             state0=None if s0 is None else jnp.asarray(s0))
    y, s = TS._ssd_chunked(*map(_t, (xbar, loga, Bm, Cm)),
                           state0=None if s0 is None else _t(s0))
    assert y.shape == (B, L, H, P) and s.shape == (B, H, N, P)
    _close_rel(y, jy)
    _close_rel(s, js)


def test_ssd_pad_steps_carry_the_state():
    """A prompt off the chunk grid gives the state of the unpadded
    recurrence: the scan over L equals a step-by-step loop."""
    rng = np.random.default_rng(7)
    B, L, H, P, N = 1, 131, 2, 4, 3
    xbar = torch.from_numpy(rng.normal(size=(B, L, H, P)).astype(np.float32))
    loga = -torch.from_numpy(rng.uniform(0, 0.3, size=(B, L, H)).astype(
        np.float32))
    Bm = torch.from_numpy(rng.normal(size=(B, L, N)).astype(np.float32))
    Cm = torch.from_numpy(rng.normal(size=(B, L, N)).astype(np.float32))
    _, s = TS._ssd_chunked(xbar, loga, Bm, Cm)
    S = torch.zeros((B, H, N, P))
    for t in range(L):
        S = (S * torch.exp(loga[:, t])[:, :, None, None]
             + torch.einsum("bn,bhp->bhnp", Bm[:, t], xbar[:, t]))
    _close_rel(s, S)


# ------------------------------------------------------------ Mamba2 block
def _configs(**kw):
    jcfg = dataclasses.replace(j_get_smoke(ARCH), dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(registry.get_smoke_config(ARCH),
                               dtype=torch.float32, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def pair():
    """The smoke config in fp32 and the reference's weights carried
    across."""
    jcfg, tcfg = _configs()
    jp = jz.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _layer(tree, i):
    return {k: v[i] for k, v in tree.items()}


@pytest.mark.parametrize("L,stateful", [(37, False), (150, True), (1, True)])
def test_mamba_forward_matches_reference(pair, L, stateful):
    """The chunked branch from zeros and from a state, and the recurrent
    step (L = 1 with a state)."""
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(L)
    din, H, N, conv_ch = TS._mamba_dims(tcfg)
    x = rng.normal(size=(2, L, tcfg.d_model)).astype(np.float32)
    S = rng.normal(size=(2, H, N, tcfg.ssm_head_dim)).astype(np.float32)
    tail = rng.normal(size=(2, tcfg.ssm_conv - 1, conv_ch)).astype(np.float32)
    jkw = dict(state=jnp.asarray(S), conv_tail=jnp.asarray(tail)) \
        if stateful else {}
    tkw = dict(state=_t(S), conv_tail=_t(tail)) if stateful else {}
    jo, (jS, jt) = JS.mamba_forward(jcfg, _layer(jp["mamba"], 1),
                                    jnp.asarray(x), Dist(), **jkw)
    to, (tS, tt) = TS.mamba_forward(tcfg, _layer(tp["mamba"], 1), _t(x),
                                    **tkw)
    _close(to, jo)
    _close_rel(tS, jS)
    _close(tt, jt)


# ------------------------------------------------------------ whole model
def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        out.update(_flat(v, f"{pre}{k}/") if isinstance(v, dict)
                   else {f"{pre}{k}": v})
    return out


def test_params_layout_equals_reference(pair):
    """Converted keys, shapes and dtypes equal the port's own init."""
    jcfg, jp, tcfg, tp = pair
    own = _flat(tz.init_params(tcfg, torch.Generator().manual_seed(0),
                               device="cpu"))
    ref = _flat(jax.tree.map(np.asarray, jp))
    conv = _flat(tp)
    assert sorted(own) == sorted(ref) == sorted(conv)
    for name, t in own.items():
        assert tuple(t.shape) == ref[name].shape == tuple(conv[name].shape)
        assert t.dtype == conv[name].dtype == torch.float32, name
    assert "shared/concat_proj" in own and "mamba/A_log" in own
    _close(own["mamba/A_log"], ref["mamba/A_log"], 1e-6)
    assert float(own["mamba/conv_w"].std()) == pytest.approx(0.1, rel=0.1)
    assert float(own["mamba/in_proj"].std()) == pytest.approx(
        tcfg.d_model ** -0.5, rel=0.1)


def test_forward_and_loss_match_reference(pair):
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(0)
    tok = rng.integers(1, 500, size=(2, 140))
    lab = rng.integers(0, 500, size=(2, 140))
    lab[0, :3] = -100
    ref, _ = jz.forward(jcfg, jp, {"tokens": jnp.asarray(tok, jnp.int32)})
    out, aux = tz.forward(tcfg, tp, {"tokens": torch.from_numpy(tok)})
    assert out.shape == ref.shape and aux == 0.0
    _close(out, ref)
    ref_loss = jz.loss_fn(jcfg, jp, {"tokens": jnp.asarray(tok, jnp.int32),
                                     "labels": jnp.asarray(lab, jnp.int32)})
    loss = tz.loss_fn(tcfg, tp, {"tokens": torch.from_numpy(tok),
                                 "labels": torch.from_numpy(lab)})
    _close(loss, ref_loss)


def _check_cache(tc, jc):
    assert sorted(tc) == sorted(jc)
    for key in tc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        if key == "len":
            np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
        else:
            _close_rel(tc[key], jc[key])


@pytest.mark.parametrize("L", [1, 13, 150])
def test_prefill_then_decode_matches_reference(pair, L):
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(L)
    tok = rng.integers(1, 500, size=(2, L))
    jl, jc = jax.jit(lambda p, b: jz.prefill(jcfg, p, b, 160))(
        jp, {"tokens": jnp.asarray(tok, jnp.int32)})
    tl, tc = tz.prefill(tcfg, tp, {"tokens": torch.from_numpy(tok)}, 160)
    _close(tl, jl)
    _check_cache(tc, jc)
    j_decode = jax.jit(lambda p, t, c: jz.decode_step(jcfg, p, t, c))
    for _ in range(4):
        nxt = rng.integers(1, 500, size=(2, 1))
        jl, jc = j_decode(jp, jnp.asarray(nxt, jnp.int32), jc)
        tl, tc = tz.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
        _close(tl, jl)
    _check_cache(tc, jc)


def _decode_vs_forward(tcfg, tp, n_prompt, n_decode, seed):
    """Prefill ``n_prompt`` tokens, decode ``n_decode``: each step's logits
    against the teacher-forced forward at that position."""
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        1, tcfg.vocab, size=(2, n_prompt + n_decode)))
    full, _ = tz.forward(tcfg, tp, {"tokens": toks})
    lg, cache = tz.prefill(tcfg, tp, {"tokens": toks[:, :n_prompt]},
                           n_prompt + n_decode)
    _close(lg[:, 0], full[:, n_prompt - 1], ZOO_TOL)
    for t in range(n_prompt, n_prompt + n_decode):
        lg, cache = tz.decode_step(tcfg, tp, toks[:, t:t + 1], cache)
        _close(lg[:, 0], full[:, t], ZOO_TOL)


@pytest.mark.parametrize("n_prompt", [8, 127, 130])
def test_prefill_decode_matches_forward(pair, n_prompt):
    _, _, tcfg, tp = pair
    _decode_vs_forward(tcfg, tp, n_prompt, 4, n_prompt)


def test_decode_after_prefill_when_head_dim_differs_from_state():
    """ssm_head_dim 8 != ssm_state 16 (a port-only config): the state is
    (B, H, N, P) in the scan, the decode step and the cache alike."""
    cfg = dataclasses.replace(registry.get_smoke_config(ARCH),
                              dtype=torch.float32, ssm_head_dim=8)
    tp = tz.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    din, H, N, _ = TS._mamba_dims(cfg)
    assert (H, N, cfg.ssm_head_dim) == (16, 16, 8)
    cache = tz.init_cache(cfg, 2, 32, device="cpu")
    assert cache["ssm"].shape == (cfg.n_layers, 2, H, N, 8)
    _decode_vs_forward(cfg, tp, 11, 4, 3)


# ------------------------------------------------------------------ serving
def _serve(engine, request_cls, prompts, max_new):
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=max_new, eos_id=-1)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    stats = engine.run(max_ticks=60)
    return [r.out_tokens for r in reqs], dataclasses.asdict(stats)


def test_engine_matches_reference(pair):
    """2 slots, 5 prompts of 1-200 tokens: the same tokens and stats as the
    reference's engine."""
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 400, size=n).astype(np.int32)
               for n in (1, 200, 9, 130, 40)]
    ref = _serve(JServeEngine(jcfg, jp, slots=2, max_len=256), JRequest,
                 prompts, 6)
    got = _serve(ServeEngine(tcfg, tp, slots=2, max_len=256, device="cpu"),
                 Request, prompts, 6)
    assert got == ref


def test_bucketing_would_change_the_answer_and_the_engine_does_not_bucket(
        pair, monkeypatch):
    _, _, tcfg, tp = pair
    prompt = np.random.default_rng(5).integers(1, 400, size=11)
    exact, _ = tz.prefill(tcfg, tp, {"tokens": torch.from_numpy(prompt)[None]},
                          32)
    padded = np.zeros(16, np.int64)
    padded[:11] = prompt
    # The pad tokens run through the state: the last real position's logits
    # and the state differ from the exact-length prefill's.
    _, pcache = tz.prefill(tcfg, tp, {"tokens": torch.from_numpy(padded)[None]},
                           32)
    _, ecache = tz.prefill(tcfg, tp, {"tokens": torch.from_numpy(prompt)[None]},
                           32)
    assert not torch.allclose(pcache["ssm"], ecache["ssm"], atol=1e-3)
    seen = []
    prefill = tz.prefill

    def spy(cfg, params, batch, max_len):
        seen.append((tuple(batch["tokens"].shape), sorted(batch)))
        return prefill(cfg, params, batch, max_len)
    monkeypatch.setattr(tz, "prefill", spy)
    eng = ServeEngine(tcfg, tp, slots=1, max_len=32, device="cpu")
    req = Request(uid=0, prompt=prompt, max_new_tokens=2, eos_id=-1)
    eng.submit(req)
    eng.run()
    assert seen == [((1, 11), ["tokens"])]
    assert req.out_tokens[0] == int(exact[0, -1].argmax())


def test_engine_keeps_fp32_at_use_leaves():
    """bf16 compute over fp32 weights: the engine rounds the matrices to
    bf16 and keeps A_log, D and dt_bias as the fp32 tensors it was given
    (the reference reads them .astype(float32))."""
    cfg = dataclasses.replace(registry.get_smoke_config(ARCH),
                              dtype=torch.bfloat16, param_dtype=torch.float32)
    tp = tz.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(cfg, tp, slots=1, max_len=16, device="cpu")
    for key in ("A_log", "D", "dt_bias"):
        assert eng.params["mamba"][key] is tp["mamba"][key], key
    assert eng.params["mamba"]["in_proj"].dtype == torch.bfloat16
    assert eng.params["shared"]["wq"].dtype == torch.bfloat16


def test_launch_serve_cli_runs_zamba2_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "4", "--max-new", "4"],
                       env=env, capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "4/4 requests" in r.stdout and "on cpu" in r.stdout


def test_registry_configs_equal_reference():
    for get_t, get_j in ((registry.get_config, j_get_config),
                         (registry.get_smoke_config, j_get_smoke)):
        t, j = get_t(ARCH), get_j(ARCH)
        tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
        jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
        for key in ("dtype", "param_dtype"):
            assert str(tf.pop(key)).split(".")[-1] == jnp.dtype(
                jf.pop(key)).name
        assert tf == jf
        assert (t.hd, t.group, t.params_count()) == (j.hd, j.group,
                                                     j.params_count())
    full = registry.get_config(ARCH)
    assert TS.num_shared_calls(full) == 6
    assert full.params_count() == pytest.approx(1.18e9, rel=0.02)


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


def keep_counts(monkeypatch):
    """Every launch counter of the port's kernel wrappers replaced by a copy
    of itself until the test ends, so a rehearsal that bumps or zeroes them
    (``chip_smoke.py``'s ``_zero_counts``, the counting wrappers) leaves
    them as it found them for the tests that run after it."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gnn_aggregate as GA
    from repro_torch.models import moe as TMoE
    for fn, names in (
            (FA.flash_attention, ("launches", "launches_by_path",
                                  "stats_launches",
                                  "backward_launches",
                                  "backward_launches_by_path")),
            (GA.spmm, ("launches", "launches_by_dir")),
            (TMoE.grouped_gemm, ("launches_by_route",
                                 "backward_launches_by_route"))):
        for name in names:
            value = getattr(fn, name)
            monkeypatch.setattr(fn, name, dict(value)
                                if isinstance(value, dict) else value)


def _chip_smoke_on_cpu(monkeypatch, configs):
    """``chip_smoke.py`` imported as a module, set up to run its LM phases
    on the CPU at the smoke widths in ``configs`` (arch -> config): K2's
    plain version behind a wrapper that counts launches by the kernel the
    card would take, the CUDA clock, memory stats and timers stubbed.
    Every second call of ``_lm_run`` and ``_batch_run`` (counted together
    in the returned list) takes the CPU's plain attention, as the parity
    phases' CPU runs do.  Returns the module and that list."""
    import importlib.util
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import common as TC
    from repro_torch.models import encdec as TE

    keep_counts(monkeypatch)
    spec = importlib.util.spec_from_file_location("chip_smoke_rec_cpu",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    plain_forward = FA._forward

    def forward(q, k, v, kv_len, causal, scale):
        path = FA.kernel_path(q.dtype, q.shape[1], k.shape[1], q.shape[2],
                              q.shape[3],
                              all(FA.aligned16(t) for t in (q, k, v)))
        FA.flash_attention.launches += 1
        FA.flash_attention.launches_by_path[path] += 1
        return plain_forward(q, k, v, kv_len, causal, scale)

    plain_attention = TC.attention_any
    card = {"now": True}

    def attention_any(q, k, v, *, causal, chunk, kv_len=None):
        if not card["now"]:
            return plain_attention(q, k, v, causal=causal, chunk=chunk,
                                   kv_len=kv_len)
        return FA.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), kv_len,
                                  causal=causal).transpose(1, 2)

    runs = []

    def second_on_cpu(run):
        def wrapped(*args):
            """A parity phase's first run stands for the card's, the second
            is the CPU's and takes the plain attention."""
            card["now"] = len(runs) % 2 == 0
            runs.append(1)
            try:
                return run(*args)
            finally:
                card["now"] = True
        return wrapped

    monkeypatch.setattr(cs, "get_config", lambda arch: configs[arch])
    monkeypatch.setattr(FA, "_forward", forward)
    monkeypatch.setattr(TC, "attention_any", attention_any)
    monkeypatch.setattr(TT, "attention_any", attention_any)
    monkeypatch.setattr(TE, "attention_any", attention_any)
    for name in ("_lm_run", "_batch_run"):
        monkeypatch.setattr(cs, name, second_on_cpu(getattr(cs, name)))
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
    return cs, runs


def _phase_lines(capsys):
    import json
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_chip_smoke_hybrid_phases_run_on_cpu(monkeypatch, capsys):
    """``hybrid_parity`` and ``hybrid_serve`` at zamba2's smoke width with
    head dim 64 (so bf16 attention names the ``prefill_tc`` kernel): every
    check of the phases holds, with the launch counts the card run
    requires: one per shared-block site per prefill and per tick."""
    small = dataclasses.replace(registry.get_smoke_config(ARCH), head_dim=64)
    cs, runs = _chip_smoke_on_cpu(monkeypatch, {ARCH: small})
    dev = torch.device("cpu")
    cs._zero_counts()
    cs.phase_hybrid_parity(dev)
    assert len(runs) == 2
    launches, by_path = cs.phase_hybrid_serve(dev)
    out = _phase_lines(capsys)
    parity = next(o for o in out if o.get("phase") == "hybrid_parity")
    assert parity["k2_sites"] == 3 and parity["greedy_tokens_equal"]
    assert set(parity["allclose_excess_by_output"]) == {
        "forward", "step_logits", "ssm", "conv", "k", "v"}
    serve = next(o for o in out if o.get("phase") == "hybrid_serve")
    sites = TS.num_shared_calls(small)
    assert by_path == {"decode": sites * serve["ticks"],
                       "prefill_tc": sites * serve["prefills"], "general": 0}
    assert launches == sites * (serve["ticks"] + serve["prefills"])
    assert serve["teacher_forced_checked"] == 16 * 32
    assert serve["teacher_forced_max_gap"] <= cs.SERVE_GAP_TOL
    assert max(serve["noise_ratio"].values()) <= cs.REC_NOISE_RATIO
    assert any(o.get("phase") == "hybrid_profile" for o in out)
