"""Port enc-dec family (seamless-m4t-medium: a bidirectional encoder over
stub frame embeddings, a decoder of causal self-attention, cross-attention
and FFN) vs the JAX reference on the same weights: the parameter layout,
the encoder, forward and ``loss_fn``, prefill (every cache key: ``k``,
``v``, ``xk``, ``xv``, ``len``, ``xlen``) then decode, decode past the end
of the cache (the write dropped, as the reference drops it), decode against
``forward``, a 3-step train, the refusal of both serving engines and both
serve CLIs, ``launch.train``, and ``chip_smoke.py``'s enc-dec phases
rehearsed on the CPU.

Tolerance: TOL = 1e-5 (fp32, another summation order: the dense family's,
tests/test_torch_lm.py), rtol = atol.  Prefill + decode against
``forward`` uses the reference's own gate for that identity, 2e-3
(tests/test_models_zoo.py)."""
import dataclasses
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jz  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.launch import serve as j_launch_serve  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.serve import Request as JRequest, ServeEngine as JServeEngine  # noqa: E402
from repro_torch import models as tz  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import (OptConfig, init_opt_state,  # noqa: E402
                               make_train_step, optim)

TOL = 1e-5                                   # fp32, another summation order
ZOO_TOL = 2e-3                               # tests/test_models_zoo.py
ARCH = "seamless-m4t-medium"
CACHE_KEYS = ["k", "len", "v", "xk", "xlen", "xv"]


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(j_get_smoke(ARCH), dtype=jnp.float32)
    tcfg = dataclasses.replace(registry.get_smoke_config(ARCH),
                               dtype=torch.float32)
    jp = jz.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _batch(cfg, seed, B=2, L=13):
    """numpy frames, tokens and labels from ``seed``."""
    rng = np.random.default_rng(seed)
    b = {"frames": rng.normal(size=(B, cfg.frontend_len,
                                    cfg.frontend_dim)).astype(np.float32),
         "tokens": rng.integers(1, 500, size=(B, L)).astype(np.int32),
         "labels": rng.integers(0, 500, size=(B, L)).astype(np.int32)}
    b["labels"][1, -2:] = -100
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
    for key in ("frontend_proj", "enc_norm", "encoder/wq", "decoder/x_wq",
                "decoder/x_wo", "decoder/ln_x"):
        assert key in ref
    for tree in (tp, own):
        got = _flat(tree)
        assert sorted(got) == sorted(ref)
        for name, t in got.items():
            assert tuple(t.shape) == ref[name].shape, name
            assert t.dtype == torch.float32
    assert float(own["decoder"]["x_wk"].std()) == pytest.approx(
        tcfg.d_model ** -0.5, rel=0.1)
    assert float(own["frontend_proj"].std()) == pytest.approx(
        tcfg.frontend_dim ** -0.5, rel=0.1)
    assert torch.equal(own["decoder"]["ln_x"],
                       torch.ones_like(own["decoder"]["ln_x"]))


def test_encoder_matches_reference(pair):
    jcfg, jp, tcfg, tp = pair
    b = _batch(tcfg, 0)
    ref = JE.encode(jcfg, jp, jnp.asarray(b["frames"]))
    _close(TE.encode(tcfg, tp, torch.from_numpy(b["frames"])), ref)


def test_forward_and_loss_match_reference(pair):
    jcfg, jp, tcfg, tp = pair
    b = _batch(tcfg, 1)
    ref, _ = jz.forward(jcfg, jp, _j(b))
    out, aux = tz.forward(tcfg, tp, _t(b))
    assert out.shape == ref.shape == (2, 13, TT.vocab_padded(tcfg))
    assert aux == 0.0
    _close(out, ref)
    _close(tz.loss_fn(tcfg, tp, _t(b)), jz.loss_fn(jcfg, jp, _j(b)))


def _check_cache(tc, jc):
    assert sorted(tc) == sorted(jc) == CACHE_KEYS
    for key in CACHE_KEYS:
        assert tuple(tc[key].shape) == jc[key].shape, key
        if key in ("len", "xlen"):
            assert tc[key].tolist() == np.asarray(jc[key]).tolist(), key
        else:
            _close(tc[key], jc[key])


def test_prefill_then_decode_matches_reference(pair):
    jcfg, jp, tcfg, tp = pair
    b = _batch(tcfg, 2, L=7)
    del b["labels"]
    jl, jc = jax.jit(lambda p, x: jz.prefill(jcfg, p, x, 12))(jp, _j(b))
    tl, tc = tz.prefill(tcfg, tp, _t(b), 12)
    _close(tl, jl)
    _check_cache(tc, jc)
    j_decode = jax.jit(lambda p, t, c: jz.decode_step(jcfg, p, t, c))
    rng = np.random.default_rng(3)
    for _ in range(3):
        nxt = rng.integers(1, 500, size=(2, 1))
        jl, jc = j_decode(jp, jnp.asarray(nxt, jnp.int32), jc)
        tl, tc = tz.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
        _close(tl, jl)
    _check_cache(tc, jc)


def test_init_cache_matches_reference(pair):
    jcfg, _, tcfg, _ = pair
    _check_cache(tz.init_cache(tcfg, 3, 10, device="cpu"),
                 jz.init_cache(jcfg, 3, 10))


def test_decode_past_the_cache_drops_the_write_as_the_reference(pair):
    """A row whose ``len`` is at or past the cache's end (an idle serving
    slot) writes nothing and attends over the whole cache; the other row
    decodes as before."""
    jcfg, jp, tcfg, tp = pair
    b = _batch(tcfg, 4, L=6)
    del b["labels"]
    jl, jc = jax.jit(lambda p, x: jz.prefill(jcfg, p, x, 8))(jp, _j(b))
    tl, tc = tz.prefill(tcfg, tp, _t(b), 8)
    jc = {**jc, "len": jnp.asarray([8, 3], jnp.int32)}
    tc = {**tc, "len": torch.tensor([8, 3], dtype=torch.int32)}
    j_decode = jax.jit(lambda p, t, c: jz.decode_step(jcfg, p, t, c))
    k_before = tc["k"][:, 0].clone()
    for step in range(3):
        nxt = np.array([[7 + step], [11 + step]])
        jl, jc = j_decode(jp, jnp.asarray(nxt, jnp.int32), jc)
        tl, tc = tz.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
        _close(tl, jl)
    _check_cache(tc, jc)
    assert torch.equal(tc["k"][:, 0], k_before)
    assert tc["len"].tolist() == [11, 6]


def test_prefill_decode_matches_forward(pair):
    """tests/test_models_zoo.py's form, on the port alone: prefill(frames,
    prompt) then decode_step(next) equals forward(frames, prompt + next)
    at its last position."""
    _, _, tcfg, tp = pair
    b = _t(_batch(tcfg, 5, L=12))
    toks, frames = b["tokens"], b["frames"]
    lg, cache = tz.prefill(tcfg, tp, {"tokens": toks[:, :8],
                                      "frames": frames}, max_len=16)
    for i in range(8, 12):
        lg, cache = tz.decode_step(tcfg, tp, toks[:, i:i + 1], cache)
        full, _ = tz.forward(tcfg, tp, {"tokens": toks[:, :i + 1],
                                        "frames": frames})
        _close(lg[:, 0], full[:, -1], ZOO_TOL)


def test_train_step_lowers_the_loss(pair):
    """tests/test_models_zoo.py::test_smoke_train_step's form: three steps
    on one batch, the loss finite and falling."""
    _, _, tcfg, tp = pair
    params = optim.tree_map(torch.clone, tp)   # the step updates in place
    opt = OptConfig(name=tcfg.optimizer, lr=1e-2)
    state = init_opt_state(opt, params)
    step = make_train_step(tcfg, opt)
    b = _t(_batch(tcfg, 6, L=16))
    losses = []
    for _ in range(3):
        params, state, _, m = step(params, state, None, b)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_remat_gives_the_reference_gradients(pair):
    """With ``cfg.remat`` every encoder and decoder layer is checkpointed;
    the loss and every gradient leaf equal ``jax.grad`` of the reference's
    ``loss_fn``, as without it."""
    jcfg, jp, tcfg, tp = pair
    b = _batch(tcfg, 7, L=10)
    jl, jg = jax.value_and_grad(lambda p: jz.loss_fn(jcfg, p, _j(b)))(jp)
    ref = _flat(jax.tree.map(np.array, jg))
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        loss, grads = make_train_step(cfg).grads_of(tp, _t(b))
        _close(loss, jl)
        for name, g in _flat(grads).items():
            scale = max(float(np.abs(ref[name]).max()), 1.0)
            assert float((g - torch.from_numpy(ref[name])).abs().max()) \
                <= TOL * scale, (remat, name)


def test_both_engines_refuse_encdec(pair):
    """The reference's engine cannot serve enc-dec (its prefill reads
    ``batch["frames"]``, which a request does not carry): it fails at the
    first prefill.  The port's refuses at construction."""
    jcfg, jp, tcfg, tp = pair
    ref = JServeEngine(jcfg, jp, slots=2, max_len=16)
    ref.submit(JRequest(uid=0, prompt=np.array([3, 4, 5], np.int32)))
    with pytest.raises(KeyError, match="frames"):
        ref.run()
    with pytest.raises(ValueError, match="decoder-only"):
        ServeEngine(tcfg, tp, slots=2, max_len=16, device="cpu")


@pytest.mark.parametrize("package", ["reference", "port"])
def test_both_serve_clis_refuse_encdec(monkeypatch, package):
    args = ["--arch", ARCH, "--smoke"]
    if package == "port":
        run = lambda: launch_serve.main(args + ["--device", "cpu"])  # noqa: E731
    else:
        monkeypatch.setattr(sys, "argv", ["serve"] + args)
        run = j_launch_serve.main
    with pytest.raises(SystemExit, match="enc-dec serving needs frames"):
        run()


def test_launch_train_smoke_runs_through_the_encdec_loss(capsys):
    """The data pipeline gives an enc-dec batch ``frames``; ``launch.train``
    runs the enc-dec ``loss_fn`` over them."""
    losses = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                                "--steps", "3", "--seq-len", "16",
                                "--batch", "2"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "done:" in capsys.readouterr().out


def test_chip_smoke_encdec_and_zoo_fp32_phases_run_on_cpu(monkeypatch,
                                                          capsys):
    """``encdec_parity``, ``encdec_serve`` (with the idle-slot check) and
    ``zoo_fp32`` (both families) at the smoke widths, head dim 64 and 32
    frames (so every bf16 prefill attention names the ``prefill_tc``
    kernel, as at full width): every check of the phases holds, with the
    launch counts the card run requires."""
    from test_torch_ssm import _chip_smoke_on_cpu, _phase_lines
    small = dataclasses.replace(registry.get_smoke_config(ARCH), head_dim=64,
                                frontend_len=32)
    configs = {ARCH: small,
               "internvl2-2b": registry.get_smoke_config("internvl2-2b"),
               "llama3.2-1b": registry.get_smoke_config("llama3.2-1b")}
    cs, runs = _chip_smoke_on_cpu(monkeypatch, configs)
    dev = torch.device("cpu")
    cs._zero_counts()
    cs.phase_encdec_parity(dev)
    assert len(runs) == 2
    launches, by_path = cs.phase_encdec_serve(dev)
    runs.clear()
    cs.phase_zoo_fp32(dev)
    out = _phase_lines(capsys)
    parity = next(o for o in out if o.get("phase") == "encdec_parity")
    assert parity["greedy_tokens_equal"]
    assert set(parity["allclose_excess_by_output"]) == {
        "forward", "step_logits", "k", "v", "xk", "xv"}
    assert parity["launches_per_call"] == [6] + [4] * 8
    serve = next(o for o in out if o.get("phase") == "encdec_serve")
    per_prefill = small.n_enc_layers + 2 * small.n_layers
    assert by_path == {"prefill_tc": per_prefill,
                       "decode": 2 * small.n_layers * cs.ENCDEC_STEPS,
                       "general": 0}
    assert launches == per_prefill + 2 * small.n_layers * cs.ENCDEC_STEPS
    assert serve["teacher_forced_checked"] == cs.ENCDEC_BATCH * (
        cs.ENCDEC_STEPS + 1)
    assert serve["teacher_forced_max_gap"] <= cs.SERVE_GAP_TOL
    assert serve["idle_slot_on_card"]["len"][1] > 16
    fp32 = [o for o in out if o.get("phase") == "zoo_fp32"]
    assert [o["arch"] for o in fp32] == ["internvl2-smoke", "seamless-smoke"]
    assert all(o["tokens_equal"] and o["tokens_checked"] == 2 * 17
               and o["allclose_excess"] <= cs.REC_FP32_TOL for o in fp32)
