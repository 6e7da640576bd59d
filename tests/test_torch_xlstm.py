"""Port xLSTM family (mLSTM + sLSTM) vs the JAX reference on the same
weights: the per-head chunked SSD scan (with and without an initial state,
L = 1, L off the chunk grid, L past one chunk), both branches of the mLSTM
and sLSTM blocks, the parameter layout, xlstm-1.3b's smoke config end to
end (forward, ``loss_fn``, exact-length prefill then decode with every
cache key, the serving engine, the CLI), decode after prefill against
``forward``, the in-place matrix-memory update and the engine's fp32-at-use
weights.

Tolerance: TOL = 1e-5 (fp32, another summation order), rtol = atol on
logits and block outputs; the states and the mLSTM's scan outputs, whose
magnitudes reach e^8 (the input gate's clamp), are held relative to
max|ref|.  Prefill + decode against ``forward`` uses the reference's own
gate for that identity, 2e-3 (tests/test_models_zoo.py)."""
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
import torch.nn.functional as F  # noqa: E402

from repro import models as jz  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.models.transformer import Dist  # noqa: E402
from repro.serve import Request as JRequest, ServeEngine as JServeEngine  # noqa: E402
from repro_torch import models as tz  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5                                   # fp32, another summation order
ZOO_TOL = 2e-3                               # tests/test_models_zoo.py
ARCH = "xlstm-1.3b"


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
def test_ssd_chunked_heads_matches_reference(L, with_state):
    rng = np.random.default_rng(L + with_state)
    B, H, P, N = 2, 3, 8, 5
    # xbar as the mLSTM makes it: v times an input gate up to e^8.
    xbar = (rng.normal(size=(B, L, H, P))
            * np.exp(rng.uniform(0, 8, size=(B, L, H, 1)))).astype(np.float32)
    loga = -rng.uniform(0.0, 0.5, size=(B, L, H)).astype(np.float32)
    keys = rng.normal(size=(B, L, H, N)).astype(np.float32)
    queries = rng.normal(size=(B, L, H, N)).astype(np.float32)
    s0 = (rng.normal(size=(B, H, N, P)).astype(np.float32) * 100 if with_state
          else None)
    jy, js = JX._ssd_chunked_heads(
        *map(jnp.asarray, (xbar, loga, keys, queries)),
        state0=None if s0 is None else jnp.asarray(s0))
    y, s = TX._ssd_chunked_heads(*map(_t, (xbar, loga, keys, queries)),
                                 state0=None if s0 is None else _t(s0))
    assert y.shape == (B, L, H, P) and s.shape == (B, H, N, P)
    _close_rel(y, jy)
    _close_rel(s, js)


# ------------------------------------------------------------------ blocks
def _configs():
    jcfg = dataclasses.replace(j_get_smoke(ARCH), dtype=jnp.float32)
    tcfg = dataclasses.replace(registry.get_smoke_config(ARCH),
                               dtype=torch.float32)
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


def _mstate(rng, tcfg):
    din, H, P = TX._hdims(tcfg)
    C = (rng.normal(size=(2, H, P, P)) * 50).astype(np.float32)
    n = (rng.normal(size=(2, H, P)) * 50).astype(np.float32)
    return C, n


@pytest.mark.parametrize("L,stateful", [(37, False), (150, True), (1, True)])
def test_mlstm_forward_matches_reference(pair, L, stateful):
    """The chunked branch from zeros and from a state, and the recurrent
    step, which updates the given matrix memory in place."""
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(L)
    x = rng.normal(size=(2, L, tcfg.d_model)).astype(np.float32)
    C, n = _mstate(rng, tcfg)
    jst = (jnp.asarray(C), jnp.asarray(n)) if stateful else None
    C_t = _t(C)
    tst = (C_t, _t(n)) if stateful else None
    jo, (jC, jn) = JX.mlstm_forward(jcfg, _layer(jp["mlstm"], 1),
                                    jnp.asarray(x), Dist(), state=jst)
    to, (tC, tn) = TX.mlstm_forward(tcfg, _layer(tp["mlstm"], 1), _t(x),
                                    state=tst)
    _close(to, jo)
    _close_rel(tC, jC)
    _close_rel(tn, jn)
    assert (tC is C_t) == (L == 1)         # the decode step works in place


def test_mlstm_in_place_update_equals_the_functional_form(pair):
    """C *= f; C += (i k) (x) v gives the bits of C f + (i k) (x) v."""
    _, _, tcfg, tp = pair
    rng = np.random.default_rng(11)
    x = _t(rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32))
    C, n = map(_t, _mstate(rng, tcfg))
    p = _layer(tp["mlstm"], 0)
    C0 = C.clone()
    TX.mlstm_forward(tcfg, p, x, state=(C, n))
    # The functional form from the same gates.
    din, H, P = TX._hdims(tcfg)
    h = rms_norm(x, p["norm"], tcfg.norm_eps)
    xm = (h @ p["up"]).chunk(2, dim=-1)[0]
    k = (xm @ p["wk"]).reshape(2, 1, H, P) * P ** -0.5
    v = (xm @ p["wv"]).reshape(2, 1, H, P)
    gif = (xm @ p["w_if"]).reshape(2, 1, H, 2)
    f1 = torch.exp(F.logsigmoid(gif[..., 1]))[:, 0]
    i = torch.exp(torch.clamp(gif[..., 0], max=TX.ICLAMP))[:, 0]
    ref = (C0 * f1[:, :, None, None]
           + i[:, :, None, None] * k[:, 0][..., :, None] * v[:, 0][..., None, :])
    assert torch.equal(C, ref)


@pytest.mark.parametrize("L,stateful", [(9, False), (20, True), (1, True)])
def test_slstm_forward_matches_reference(pair, L, stateful):
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(L + 100)
    x = rng.normal(size=(2, L, tcfg.d_model)).astype(np.float32)
    H, P = tcfg.n_heads, tcfg.d_model // tcfg.n_heads
    st = [rng.normal(size=(2, H, P)).astype(np.float32) for _ in range(4)]
    st[2] = np.abs(st[2]) + 1.0                          # n > 0
    jo, js = JX.slstm_forward(jcfg, _layer(jp["slstm"], 0), jnp.asarray(x),
                              Dist(), state=tuple(map(jnp.asarray, st))
                              if stateful else None)
    to, ts = TX.slstm_forward(tcfg, _layer(tp["slstm"], 0), _t(x),
                              state=tuple(map(_t, st)) if stateful else None)
    _close(to, jo)
    for a, b in zip(ts, js):
        _close_rel(a, b)


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
    assert own["mlstm/wq"].shape[0] == 3 and own["slstm/r"].shape[0] == 1
    P = tcfg.d_model // tcfg.n_heads
    assert float(own["slstm/r"].std()) == pytest.approx(P ** -0.5, rel=0.1)
    assert float(own["mlstm/wq"].std()) == pytest.approx(
        (2 * tcfg.d_model) ** -0.5, rel=0.1)


def test_forward_and_loss_match_reference(pair):
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(0)
    tok = rng.integers(1, 500, size=(2, 13))
    lab = rng.integers(0, 500, size=(2, 13))
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


def test_forward_past_a_chunk_is_as_close_to_fp64_as_the_reference(
        pair, monkeypatch):
    """Past one chunk the mLSTM sums gated terms up to e^8 that cancel, so
    fp32 rounding in any order moves the logits by about 1e-5 (at L = 140
    the reference is 1.6e-5 from an fp64 evaluation of the same function,
    the port 1.0e-5, and the two 1.2e-5 apart).  The port must be no
    further from the fp64 evaluation than the reference is, or within TOL
    of it."""
    jcfg, jp, tcfg, tp = pair
    tok = np.random.default_rng(0).integers(1, 500, size=(2, 140))
    ref, _ = jz.forward(jcfg, jp, {"tokens": jnp.asarray(tok, jnp.int32)})
    out, _ = tz.forward(tcfg, tp, {"tokens": torch.from_numpy(tok)})
    # fp64 throughout: the model's own fp32 casts become fp64 ones.
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    exact, _ = tz.forward(dataclasses.replace(tcfg, dtype=torch.float64),
                          jax.tree.map(lambda t: t.double(), tp),
                          {"tokens": torch.from_numpy(tok)})
    exact = exact.numpy()
    ref_err = np.abs(np.asarray(ref) - exact).max()
    port_err = np.abs(out.numpy() - exact).max()
    assert port_err <= max(ref_err, TOL), (port_err, ref_err)


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


@pytest.mark.parametrize("n_prompt", [8, 127, 130])
def test_prefill_decode_matches_forward(pair, n_prompt):
    _, _, tcfg, tp = pair
    n_decode = 4
    toks = torch.from_numpy(np.random.default_rng(n_prompt).integers(
        1, tcfg.vocab, size=(2, n_prompt + n_decode)))
    full, _ = tz.forward(tcfg, tp, {"tokens": toks})
    lg, cache = tz.prefill(tcfg, tp, {"tokens": toks[:, :n_prompt]}, 64)
    _close(lg[:, 0], full[:, n_prompt - 1], ZOO_TOL)
    for t in range(n_prompt, n_prompt + n_decode):
        lg, cache = tz.decode_step(tcfg, tp, toks[:, t:t + 1], cache)
        _close(lg[:, 0], full[:, t], ZOO_TOL)


def test_init_cache_starts_the_slstm_normaliser_at_one(pair):
    _, _, tcfg, _ = pair
    cache = tz.init_cache(tcfg, 3, 8, device="cpu")
    assert torch.equal(cache["sn"], torch.ones_like(cache["sn"]))
    assert cache["mC"].shape == (3, 3, 4, 32, 32)
    assert all(cache[k].dtype == torch.float32 for k in cache if k != "len")


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
    padded = np.zeros(16, np.int64)
    padded[:11] = prompt
    _, pcache = tz.prefill(tcfg, tp, {"tokens": torch.from_numpy(padded)[None]},
                           32)
    exact, ecache = tz.prefill(tcfg, tp,
                               {"tokens": torch.from_numpy(prompt)[None]}, 32)
    assert not torch.allclose(pcache["mC"], ecache["mC"], atol=1e-3)
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
    """bf16 compute over fp32 weights: the engine keeps the sLSTM's
    recurrent matrix ``r`` as the fp32 tensor it was given (the reference
    reads it .astype(float32)) and rounds the rest."""
    cfg = dataclasses.replace(registry.get_smoke_config(ARCH),
                              dtype=torch.bfloat16, param_dtype=torch.float32)
    tp = tz.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(cfg, tp, slots=1, max_len=16, device="cpu")
    assert eng.params["slstm"]["r"] is tp["slstm"]["r"]
    assert eng.params["slstm"]["w_in"].dtype == torch.bfloat16
    assert eng.params["mlstm"]["wq"].dtype == torch.bfloat16


def test_launch_serve_cli_runs_xlstm_smoke_on_cpu():
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
    assert TX._layer_kinds(full).count("s") == 6
    # params_count() leaves the mLSTM's din x din q/k/v out: it reports
    # about 1.41 B of the tensors' 3.53 B.
    assert full.params_count() == pytest.approx(1.41e9, rel=0.01)


# ------------------------------------------------- chip_smoke.py rehearsal
def test_chip_smoke_xlstm_and_fp32_phases_run_on_cpu(monkeypatch, capsys):
    """``xlstm_parity``, ``xlstm_serve`` (no K2 launch) and
    ``recurrent_fp32`` (both recurrent families) at the smoke widths: every
    check of the phases holds."""
    from test_torch_ssm import _chip_smoke_on_cpu, _phase_lines
    configs = {ARCH: registry.get_smoke_config(ARCH),
               "zamba2-1.2b": dataclasses.replace(
                   registry.get_smoke_config("zamba2-1.2b"), head_dim=64)}
    cs, runs = _chip_smoke_on_cpu(monkeypatch, configs)
    dev = torch.device("cpu")
    cs._zero_counts()
    cs.phase_xlstm_parity(dev)
    assert len(runs) == 2
    launches, by_path = cs.phase_xlstm_serve(dev)
    assert launches == 0 and not any(by_path.values())
    cs.phase_recurrent_fp32(dev)
    out = _phase_lines(capsys)
    parity = next(o for o in out if o.get("phase") == "xlstm_parity")
    assert parity["k2_sites"] == 0 and parity["greedy_tokens_equal"]
    assert set(parity["allclose_excess_by_output"]) == {
        "forward", "step_logits", "mC", "mn", "sh", "sc", "sn", "sm"}
    serve = next(o for o in out if o.get("phase") == "xlstm_serve")
    assert serve["teacher_forced_checked"] == 16 * 32
    assert serve["gap_tol"] == "not gated"
    assert max(serve["noise_ratio"].values()) <= cs.REC_NOISE_RATIO
    assert any(o.get("phase") == "xlstm_profile" for o in out)
    fp32 = [o for o in out if o.get("phase") == "recurrent_fp32"]
    assert [o["arch"] for o in fp32] == ["zamba2-smoke", "xlstm-smoke"]
    assert all(o["tokens_equal"] and o["tokens_checked"] == 64
               and o["allclose_excess"] <= cs.REC_FP32_TOL for o in fp32)
