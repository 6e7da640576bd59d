"""Port VLM family (internvl2-2b: the dense backbone with a stub patch
frontend) vs the JAX reference on the same weights: the parameter layout
(``patch_proj``), forward and ``loss_fn`` with patches in front of the
tokens, prefill with patches (the cache grown by the patch positions) then
decode with every cache key, decode against ``forward``, a 3-step train,
the serving engine (text only, exact length) against the reference's
engine, the CLIs, and ``chip_smoke.py``'s VLM phases rehearsed on the CPU.

Tolerance: TOL = 1e-5 (fp32, another summation order: the dense family's,
tests/test_torch_lm.py), rtol = atol.  Prefill + decode against
``forward`` uses the reference's own gate for that identity, 2e-3
(tests/test_models_zoo.py)."""
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
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.serve import Request as JRequest, ServeEngine as JServeEngine  # noqa: E402
from repro_torch import models as tz  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.train import (OptConfig, init_opt_state,  # noqa: E402
                               make_train_step, optim)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5                                   # fp32, another summation order
ZOO_TOL = 2e-3                               # tests/test_models_zoo.py
ARCH = "internvl2-2b"


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=tol,
                               atol=tol)


def _configs():
    jcfg = dataclasses.replace(j_get_smoke(ARCH), dtype=jnp.float32)
    tcfg = dataclasses.replace(registry.get_smoke_config(ARCH),
                               dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _configs()
    jp = jz.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _batch(cfg, seed, B=2, L=13, patches=True):
    """numpy tokens, labels and (optionally) patches from ``seed``."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(1, 500, size=(B, L)).astype(np.int32),
         "labels": rng.integers(0, 500, size=(B, L)).astype(np.int32)}
    b["labels"][0, :3] = -100
    if patches:
        b["patches"] = rng.normal(size=(B, cfg.frontend_len,
                                        cfg.frontend_dim)).astype(np.float32)
    return b


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        out.update(_flat(v, f"{pre}{k}/") if isinstance(v, dict)
                   else {f"{pre}{k}": v})
    return out


def test_params_layout_equals_reference(pair):
    jcfg, jp, tcfg, tp = pair
    own = tz.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    ref = _flat(jax.tree.map(np.asarray, jp))
    assert "patch_proj" in ref
    for tree in (tp, own):
        got = _flat(tree)
        assert sorted(got) == sorted(ref)
        for name, t in got.items():
            assert tuple(t.shape) == ref[name].shape, name
            assert t.dtype == torch.float32
    assert float(own["patch_proj"].std()) == pytest.approx(
        tcfg.frontend_dim ** -0.5, rel=0.1)


@pytest.mark.parametrize("patches", [True, False])
def test_forward_and_loss_match_reference(pair, patches):
    jcfg, jp, tcfg, tp = pair
    b = _batch(tcfg, 0, patches=patches)
    ref, _ = jz.forward(jcfg, jp, _j(b))
    out, aux = tz.forward(tcfg, tp, _t(b))
    extra = tcfg.frontend_len if patches else 0
    assert out.shape == ref.shape == (2, 13 + extra, TT.vocab_padded(tcfg))
    assert aux == 0.0
    _close(out, ref)
    jl = jz.loss_fn(jcfg, jp, _j(b))
    tl = tz.loss_fn(tcfg, tp, _t(b))
    _close(tl, jl)


def test_prefill_then_decode_matches_reference(pair):
    jcfg, jp, tcfg, tp = pair
    b = _batch(tcfg, 1, L=9)
    del b["labels"]
    max_len = 12                      # < patches + prompt: the cache grows
    jl, jc = jax.jit(lambda p, x: jz.prefill(jcfg, p, x, max_len))(jp, _j(b))
    tl, tc = tz.prefill(tcfg, tp, _t(b), max_len)
    _close(tl, jl)
    assert sorted(tc) == sorted(jc)
    for key in ("k", "v"):
        assert tc[key].shape[2] == tcfg.frontend_len + 9
        _close(tc[key], jc[key])
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist()
    # Room for the decode steps, as the engine's max_len would give.
    grow = lambda c, pad: {**c, "k": pad(c["k"]), "v": pad(c["v"])}  # noqa: E731
    jc = grow(jc, lambda t: jnp.pad(t, ((0, 0), (0, 0), (0, 3), (0, 0),
                                        (0, 0))))
    tc = grow(tc, lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 3)))
    j_decode = jax.jit(lambda p, t, c: jz.decode_step(jcfg, p, t, c))
    rng = np.random.default_rng(2)
    for _ in range(3):
        nxt = rng.integers(1, 500, size=(2, 1))
        jl, jc = j_decode(jp, jnp.asarray(nxt, jnp.int32), jc)
        tl, tc = tz.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
        _close(tl, jl)
        assert tc["len"].tolist() == np.asarray(jc["len"]).tolist()
    for key in ("k", "v"):
        _close(tc[key], jc[key])


def test_prefill_decode_matches_forward(pair):
    """tests/test_models_zoo.py's form, on the port alone: prefill(patches
    + prompt) then decode_step(next) equals forward(patches + prompt +
    next) at its last position."""
    _, _, tcfg, tp = pair
    b = _t(_batch(tcfg, 3, L=12))
    toks, patches = b["tokens"], b["patches"]
    lg, cache = tz.prefill(tcfg, tp, {"tokens": toks[:, :8],
                                      "patches": patches},
                           max_len=16 + tcfg.frontend_len)
    for i in range(8, 12):
        lg, cache = tz.decode_step(tcfg, tp, toks[:, i:i + 1], cache)
        full, _ = tz.forward(tcfg, tp, {"tokens": toks[:, :i + 1],
                                        "patches": patches})
        _close(lg[:, 0], full[:, -1], ZOO_TOL)


def test_train_step_lowers_the_loss(pair):
    """tests/test_models_zoo.py::test_smoke_train_step's form: three steps
    on one batch with patches, the loss finite and falling."""
    _, _, tcfg, tp = pair
    params = optim.tree_map(torch.clone, tp)   # the step updates in place
    opt = OptConfig(name=tcfg.optimizer, lr=1e-2)
    state = init_opt_state(opt, params)
    step = make_train_step(tcfg, opt)
    b = _t(_batch(tcfg, 4, L=16))
    losses = []
    for _ in range(3):
        params, state, _, m = step(params, state, None, b)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def _serve(engine, request_cls, prompts, max_new):
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=max_new, eos_id=-1)
            for i, p in enumerate(prompts)]
    lens = []
    for r in reqs:
        engine.submit(r)
    while engine.queue or any(r is not None for r in engine.live):
        engine.tick()
        lens.append(np.asarray(engine.cache["len"]).tolist())
    return ([r.out_tokens for r in reqs], lens,
            dataclasses.asdict(engine.stats))


def test_engine_matches_reference(pair):
    """2 slots, 5 prompts of 1-30 tokens: the same tokens, the same ``len``
    vector after every tick and the same stats as the reference's engine,
    which serves the VLM as text only at the exact prompt length."""
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 400, size=n).astype(np.int32)
               for n in (1, 30, 9, 17, 4)]
    ref = _serve(JServeEngine(jcfg, jp, slots=2, max_len=48), JRequest,
                 prompts, 6)
    got = _serve(ServeEngine(tcfg, tp, slots=2, max_len=48, device="cpu"),
                 Request, prompts, 6)
    assert got == ref


def test_engine_prefills_text_at_exact_length(pair, monkeypatch):
    _, _, tcfg, tp = pair
    seen = []
    prefill = tz.prefill

    def spy(cfg, params, batch, max_len):
        seen.append((tuple(batch["tokens"].shape), sorted(batch)))
        return prefill(cfg, params, batch, max_len)
    monkeypatch.setattr(tz, "prefill", spy)
    eng = ServeEngine(tcfg, tp, slots=1, max_len=32, device="cpu")
    eng.submit(Request(uid=0, prompt=np.arange(1, 12), max_new_tokens=2,
                       eos_id=-1))
    eng.run()
    assert seen == [((1, 11), ["tokens"])]


def test_launch_serve_cli_runs_internvl2_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "4", "--max-new", "4"],
                       env=env, capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "4/4 requests" in r.stdout and "on cpu" in r.stdout


def test_launch_train_smoke_runs_through_the_vlm_loss(capsys):
    """The data pipeline gives a VLM batch ``patches``; ``launch.train``
    runs the VLM ``loss_fn`` over them."""
    losses = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                                "--steps", "3", "--seq-len", "16",
                                "--batch", "2"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "done:" in capsys.readouterr().out


def test_chip_smoke_vlm_phases_run_on_cpu(monkeypatch, capsys):
    """``vlm_parity`` and ``vlm_serve`` at internvl2's smoke width with head
    dim 64 (so bf16 attention names the ``prefill_tc`` kernel): every check
    of the phases holds, with the launch counts the card run requires: one
    per layer per prefill and per tick."""
    from test_torch_ssm import _chip_smoke_on_cpu, _phase_lines
    small = dataclasses.replace(registry.get_smoke_config(ARCH), head_dim=64)
    cs, runs = _chip_smoke_on_cpu(monkeypatch, {ARCH: small})
    dev = torch.device("cpu")
    cs._zero_counts()
    cs.phase_vlm_parity(dev)
    assert len(runs) == 2
    launches, by_path = cs.phase_vlm_serve(dev)
    out = _phase_lines(capsys)
    parity = next(o for o in out if o.get("phase") == "vlm_parity")
    assert parity["greedy_tokens_equal"] and parity["n_layers"] == 2
    assert set(parity["allclose_excess_by_output"]) == {
        "forward", "step_logits", "k", "v"}
    assert parity["launches_per_call"] == [2] * 9
    serve = next(o for o in out if o.get("phase") == "vlm_serve")
    n = small.n_layers
    assert by_path == {"decode": n * serve["ticks"],
                       "prefill_tc": n * serve["prefills"], "general": 0}
    assert launches == n * (serve["ticks"] + serve["prefills"])
    assert serve["teacher_forced_checked"] == 16 * 32
    assert serve["teacher_forced_max_gap"] <= cs.SERVE_GAP_TOL
    assert serve["patch_checked"] == cs.VLM_STEPS + 1
    assert serve["patch_launches_per_call"] == [n] * (cs.VLM_STEPS + 1)
    assert any(o.get("phase") == "vlm_profile" for o in out)
