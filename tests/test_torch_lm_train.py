"""Port LM training vs the JAX reference on the CPU: the cross entropy, the
transformer's ``loss_fn`` and its gradients (direct and chunked attention,
with and without remat), AdamW, Lion, clipping, microbatching, int8
gradient compression with error feedback, the data pipeline, checkpoints
of ``{"p", "o"}`` across both packages, restart determinism, the
``launch.train`` CLI, and ``chip_smoke.py``'s LM-training phases run on the
CPU.  Smoke configs in fp32; the reference's weights are
carried across with ``transformer.params_from_jax``."""
import dataclasses
import importlib.util
import json
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jz  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models.common import ShapeCfg as JShape  # noqa: E402
from repro.models.common import sharded_ce_loss as j_ce  # noqa: E402
from repro.models.transformer import Dist  # noqa: E402
from repro.train.optim import clip_by_global_norm as j_clip  # noqa: E402
from repro.train.step import _quantize_int8 as j_quantize  # noqa: E402
from repro_torch import models as tz  # noqa: E402
from repro_torch import train as ttrain  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.common import ShapeCfg  # noqa: E402
from repro_torch.models.common import sharded_ce_loss  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.step import _quantize_int8  # noqa: E402


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves_close(got, ref, rel, atol=0.0):
    """Every leaf of the port's dict tree within rel * max|ref| + atol of
    the reference's leaf at the same keys."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        t = got
        for p in path:
            t = t[p.key]
        r = np.asarray(leaf, np.float32)
        err = np.abs(t.detach().float().numpy() - r).max()
        assert err <= rel * np.abs(r).max() + atol, (path, err)


@pytest.fixture(scope="module", params=["llama3.2-1b", "qwen2.5-32b"])
def pair(request):
    """fp32 smoke configs, the reference's weights and a batch from the
    data pipeline; qwen covers the QKV bias and the untied unembed."""
    jcfg = dataclasses.replace(j_get_smoke(request.param), dtype=jnp.float32)
    tcfg = dataclasses.replace(registry.get_smoke_config(request.param),
                               dtype=torch.float32)
    jp = jz.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(_np(jp), device="cpu")
    batch = jtrain.batch_at_step(jcfg, JShape("t", 32, 8, "train"), 0)
    return jcfg, jp, tcfg, tp, batch


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------- the loss
@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_ce_loss_matches_reference(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(3, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    labels[0, 0] = labels[2, 4] = -100
    ref, jg = jax.value_and_grad(lambda x: j_ce(x, jnp.asarray(labels)))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = sharded_ce_loss(x, torch.from_numpy(labels).long())
    g, = torch.autograd.grad(loss, x)
    assert float(loss.detach()) == pytest.approx(float(ref), rel=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


def test_sharded_ce_loss_extreme_logits_and_all_ignored():
    x = torch.tensor([[[1e4, -1e4, 0.0]]])
    assert float(sharded_ce_loss(x, torch.tensor([[0]]))) == pytest.approx(
        0.0, abs=1e-3)
    ref = j_ce(jnp.asarray(x.numpy()), jnp.asarray([[2]], jnp.int32))
    assert float(sharded_ce_loss(x, torch.tensor([[2]]))) == pytest.approx(
        float(ref), rel=1e-6)
    assert float(sharded_ce_loss(x, torch.tensor([[-100]]))) == 0.0


@pytest.mark.parametrize("remat,chunk", [(False, 1024), (True, 1024),
                                         (False, 4), (True, 4)])
def test_loss_fn_and_grads_match_reference(pair, remat, chunk):
    """loss within 1e-5 relative, every gradient leaf within
    1e-4 * max|ref|; chunk 4 sends the CPU side down the chunked path
    (L = 32 > 2 * 4), 1024 down the direct one."""
    jcfg, jp, tcfg, tp, batch = pair
    jcfg = dataclasses.replace(jcfg, remat=remat, attn_chunk=chunk)
    tcfg = dataclasses.replace(tcfg, remat=remat, attn_chunk=chunk)
    ref, jg = jax.jit(jax.value_and_grad(
        lambda p: jz.loss_fn(jcfg, p, _jb(batch))))(jp)
    loss, grads = ttrain.make_train_step(tcfg).grads_of(tp, _tb(batch))
    assert float(loss) == pytest.approx(float(ref), rel=1e-5)
    _leaves_close(grads, jg, 1e-4)
    direct = tz.loss_fn(tcfg, tp, _tb(batch))
    assert float(direct) == pytest.approx(float(loss), rel=1e-7)


def test_remat_checkpoints_each_layer(pair):
    """With remat on and grad on, each layer's forward runs again in the
    backward; the gradients are the same bits."""
    _, _, tcfg, tp, batch = pair
    calls = []
    from repro_torch.models import transformer as TT
    orig = TT._one_layer

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        calls.clear()
        TT._one_layer = counting
        try:
            grads[remat] = ttrain.make_train_step(cfg).grads_of(
                tp, _tb(batch))[1]
        finally:
            TT._one_layer = orig
        assert len(calls) == tcfg.n_layers * (2 if remat else 1)
    for a, b in zip(optim.leaves(grads[False]), optim.leaves(grads[True])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- optimizer
def _tree(rng, scale=1.0):
    return {"a": (rng.normal(size=(4, 5)) * scale).astype(np.float32),
            "b": {"c": (rng.normal(size=(7,)) * scale).astype(np.float32),
                  "d": (rng.normal(size=(2, 3, 2)) * scale).astype(
                      np.float32)}}


def _torch_tree(t):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), t)


@pytest.mark.parametrize("name", ["adamw", "lion"])
def test_apply_updates_matches_reference_over_three_steps(name):
    rng = np.random.default_rng(1)
    params = _tree(rng)
    grads = [_tree(rng, s) for s in (0.5, 3.0, 0.05)]   # clipped, or not
    mdt = (jnp.bfloat16, torch.bfloat16) if name == "lion" else (
        jnp.float32, torch.float32)
    jopt = jtrain.OptConfig(name=name, lr=1e-2, momentum_dtype=mdt[0])
    topt = optim.OptConfig(name=name, lr=1e-2, momentum_dtype=mdt[1])
    jp = jax.tree.map(jnp.asarray, params)
    js = jtrain.init_opt_state(jopt, jp)
    tp = _torch_tree(params)
    ts = optim.init_opt_state(topt, tp)
    for g in grads:
        jp, js, jgn = jtrain.apply_updates(jopt, jp, jax.tree.map(
            jnp.asarray, g), js)
        tp2, ts, tgn = optim.apply_updates(topt, tp, _torch_tree(g), ts)
        assert tp2 is tp                                   # in place
        assert float(tgn) == pytest.approx(float(jgn), rel=1e-6)
        _leaves_close(tp, jp, 1e-6, 1e-7)
        _leaves_close(ts.m, js.m, 1e-2 if name == "lion" else 1e-6, 1e-7)
        if name == "adamw":
            _leaves_close(ts.v, js.v, 1e-6, 1e-9)
    assert int(ts.step) == int(js.step) == 3
    assert ts.m["a"].dtype == mdt[1]


B1 = optim.OptConfig().b1


def _first_moment(grads, max_norm):
    """One AdamW step of ``apply_updates`` from zero moments: its first
    moment, ``(1 - b1)`` times the gradients as its clip scaled them, and
    the global norm."""
    opt = optim.OptConfig(lr=1e-3, grad_clip=max_norm)
    params = optim.tree_map(torch.zeros_like, grads)
    _, state, gn = optim.apply_updates(opt, params, grads,
                                       optim.init_opt_state(opt, params))
    return state.m, gn


def test_clip_by_global_norm():
    """The reference's ``clip_by_global_norm`` as ``apply_updates`` applies
    it: the norm, and the clipped gradients the first moment takes."""
    g = {"a": torch.full((4,), 100.0)}
    m, gn = _first_moment(g, 1.0)
    assert float(gn) == pytest.approx(200.0)
    assert float(torch.linalg.norm(m["a"])) == pytest.approx(
        1.0 - B1, rel=1e-5)
    small = {"a": torch.full((4,), 0.1)}
    m, _ = _first_moment(small, 1.0)
    assert torch.equal(m["a"], (1 - B1) * small["a"])
    rng = np.random.default_rng(2)
    tree = _tree(rng, 5.0)
    jc, jgn = j_clip(jax.tree.map(jnp.asarray, tree), 1.0)
    m, tgn = _first_moment(_torch_tree(tree), 1.0)
    assert float(tgn) == pytest.approx(float(jgn), rel=1e-6)
    _leaves_close(optim.tree_map(lambda t: t / (1 - B1), m), jc, 1e-6)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2.5-32b", "yi-9b",
                                  "phi3-mini-3.8b"])
@pytest.mark.parametrize("opt", ["adamw", "lion"])
def test_for_model_matches_reference(arch, opt):
    j = jtrain.for_model(dataclasses.replace(j_get_config(arch),
                                             optimizer=opt))
    t = optim.for_model(dataclasses.replace(registry.get_config(arch),
                                            optimizer=opt))
    for f in dataclasses.fields(t):
        if f.name != "momentum_dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert str(t.momentum_dtype).split(".")[-1] == jnp.dtype(
        j.momentum_dtype).name


# --------------------------------------------------------------------- step
def test_microbatch_equals_fullbatch_grads(pair):
    """Accumulated microbatch grads == monolithic grads (same tokens), on
    the port, and the port's 4-microbatch step equals the reference's."""
    jcfg, jp, tcfg, tp, batch = pair
    opt = optim.OptConfig(lr=0.0, weight_decay=0.0)   # params unchanged
    out = {}
    for mb in (1, 4):
        step = ttrain.make_train_step(tcfg, opt, microbatches=mb)
        _, o, _, m = step(tp, ttrain.init_opt_state(opt, tp), None,
                          _tb(batch))
        out[mb] = (o, m)
    (o1, m1), (o4, m4) = out[1], out[4]
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-4)
    for a, b in zip(optim.leaves(o1.m), optim.leaves(o4.m)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-5)
    jopt = jtrain.OptConfig(lr=0.0, weight_decay=0.0)
    jstep = jax.jit(jtrain.make_train_step(jcfg, Dist(), jopt,
                                           microbatches=4))
    _, jo, _, jm = jstep(jp, jtrain.init_opt_state(jopt, jp), None,
                         _jb(batch))
    assert float(m4["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    _leaves_close(o4.m, jo.m, 1e-4)


def test_lion_microbatch_step_matches_reference(pair):
    """Lion with 2 microbatches: the gradients accumulate in bf16, as in
    the reference; the loss and the bf16 momentum after one step match the
    reference's (momentum within 1e-2 * max|ref|: one bf16 rounding of
    sums taken in another order)."""
    jcfg, jp, tcfg, tp, batch = pair
    jopt = jtrain.OptConfig(name="lion", lr=1e-4,
                            momentum_dtype=jnp.bfloat16)
    topt = optim.OptConfig(name="lion", lr=1e-4,
                           momentum_dtype=torch.bfloat16)
    jstep = jax.jit(jtrain.make_train_step(jcfg, Dist(), jopt,
                                           microbatches=2))
    _, jo, _, jm = jstep(jp, jtrain.init_opt_state(jopt, jp), None,
                         _jb(batch))
    p = jax.tree.map(lambda t: t.clone(), tp)
    _, to, _, tm = ttrain.make_train_step(tcfg, topt, microbatches=2)(
        p, ttrain.init_opt_state(topt, p), None, _tb(batch))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert to.m["embed"].dtype == torch.bfloat16
    _leaves_close(to.m, jo.m, 1e-2)


@pytest.mark.parametrize("name", ["adamw", "lion"])
def test_optimizer_decreases_loss(pair, name):
    _, _, tcfg, tp, batch = pair
    opt = optim.OptConfig(name=name, lr=5e-3 if name == "adamw" else 5e-4)
    step = ttrain.make_train_step(tcfg, opt)
    p = jax.tree.map(lambda t: t.clone(), tp)
    o = ttrain.init_opt_state(opt, p)
    losses = []
    for _ in range(6):
        p, o, _, m = step(p, o, None, _tb(batch))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_quantize_int8_matches_reference():
    rng = np.random.default_rng(3)
    g = (rng.normal(size=(64, 9)) * 0.3).astype(np.float32)
    ef = (rng.normal(size=(64, 9)) * 1e-3).astype(np.float32)
    jd, je = j_quantize(jnp.asarray(g), jnp.asarray(ef))
    td, te = _quantize_int8(torch.from_numpy(g), torch.from_numpy(ef))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    half = torch.tensor([0.5, 1.5, 2.5, -0.5, 127.0])    # scale 1
    d, _ = _quantize_int8(half, torch.zeros(5))
    assert torch.equal(d, torch.tensor([0.0, 2.0, 2.0, -0.0, 127.0]))


def test_compressed_step_matches_reference():
    """Three int8 error-feedback AdamW steps of a loss whose gradient both
    packages compute to the same bits (c + w): the quantized updates and
    the residuals agree with the reference's."""
    rng = np.random.default_rng(4)
    params = _tree(rng)
    c = _tree(rng, 2.0)

    def jloss(p, b):
        return sum(jnp.sum(ci * w + 0.5 * w * w) for ci, w in zip(
            jax.tree.leaves(c), jax.tree.leaves(p)))

    def tloss(p, b):
        return sum((torch.from_numpy(ci) * w + 0.5 * w * w).sum()
                   for ci, w in zip(jax.tree.leaves(c), optim.leaves(p)))

    cfg = registry.get_smoke_config("llama3.2-1b")
    jcfg = j_get_smoke("llama3.2-1b")
    jopt = jtrain.OptConfig(lr=1e-2)
    topt = optim.OptConfig(lr=1e-2)
    jstep = jtrain.make_train_step(jcfg, Dist(), jopt, compress_grads=True,
                                   loss_fn=jloss)
    tstep = ttrain.make_train_step(cfg, topt, compress_grads=True,
                                   loss_fn=tloss)
    jp = jax.tree.map(jnp.asarray, params)
    js, jef = jtrain.init_opt_state(jopt, jp), jtrain.init_error_feedback(jp)
    tp = _torch_tree(params)
    ts, tef = ttrain.init_opt_state(topt, tp), ttrain.init_error_feedback(tp)
    for _ in range(3):
        jp, js, jef, jm = jstep(jp, js, jef, None)
        tp, ts, tef, tm = tstep(tp, ts, tef, None)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-6)
        _leaves_close(tef, jef, 1e-5, 1e-7)
        _leaves_close(tp, jp, 1e-6, 1e-7)


def test_compression_error_feedback_converges(pair):
    """int8 + EF training tracks the uncompressed trajectory."""
    _, _, tcfg, tp, batch = pair
    opt = optim.OptConfig(lr=5e-3)
    plain = ttrain.make_train_step(tcfg, opt)
    comp = ttrain.make_train_step(tcfg, opt, compress_grads=True)
    p1 = jax.tree.map(lambda t: t.clone(), tp)
    p2 = jax.tree.map(lambda t: t.clone(), tp)
    o1, o2 = ttrain.init_opt_state(opt, p1), ttrain.init_opt_state(opt, p2)
    ef = ttrain.init_error_feedback(p2)
    for _ in range(5):
        p1, o1, _, m1 = plain(p1, o1, None, _tb(batch))
        p2, o2, ef, m2 = comp(p2, o2, ef, _tb(batch))
    assert float(m2["loss"]) < 6.0
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 0.3


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("arch,smoke", [("llama3.2-1b", True),
                                        ("llama3.2-1b", False),
                                        ("qwen2.5-32b", True)])
def test_batch_at_step_bit_equal_to_reference(arch, smoke):
    jcfg = (j_get_smoke if smoke else j_get_config)(arch)
    tcfg = (registry.get_smoke_config if smoke else registry.get_config)(arch)
    shape, jshape = ShapeCfg("t", 48, 6, "train"), JShape("t", 48, 6, "train")
    for step in (0, 7):
        for sl in (None, slice(0, 3), slice(2, 5)):
            got = ttrain.batch_at_step(tcfg, shape, step, host_slice=sl)
            ref = jtrain.batch_at_step(jcfg, jshape, step, host_slice=sl)
            assert got.keys() == ref.keys()
            for k in got:
                assert got[k].dtype == ref[k].dtype
                np.testing.assert_array_equal(got[k], ref[k])
    it = ttrain.stream(tcfg, shape, start_step=3)
    np.testing.assert_array_equal(next(it)["tokens"], ttrain.batch_at_step(
        tcfg, shape, 3)["tokens"])


# -------------------------------------------------------------- checkpoints
def test_adamw_checkpoint_crosses_between_packages(pair, tmp_path):
    """{"p": params, "o": OptState} written by either package restores
    bit-equal in the other: an OptState's leaves are keyed by field name
    (o/m/..., o/v/..., o/step) in both."""
    jcfg, jp, tcfg, tp, batch = pair
    jopt, topt = jtrain.OptConfig(lr=1e-3), optim.OptConfig(lr=1e-3)
    jstep = jax.jit(jtrain.make_train_step(jcfg, Dist(), jopt))
    jp1, js1, _, _ = jstep(jp, jtrain.init_opt_state(jopt, jp), None,
                           _jb(batch))
    p = jax.tree.map(lambda t: t.clone(), tp)
    p, ts1, _, _ = ttrain.make_train_step(tcfg, topt)(
        p, ttrain.init_opt_state(topt, p), None, _tb(batch))

    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jtrain.CheckpointManager(str(jdir), async_write=False).save(
        1, {"p": jp1, "o": js1})
    like = {"p": tp, "o": ttrain.init_opt_state(topt, tp)}
    restored, _ = ttrain.CheckpointManager(str(jdir)).restore(1, like)
    assert isinstance(restored["o"], ttrain.OptState)
    for got, ref in ((restored["p"], jp1), (restored["o"].m, js1.m),
                     (restored["o"].v, js1.v)):
        _leaves_close(got, ref, 0.0)
    assert int(restored["o"].step) == 1

    ttrain.CheckpointManager(str(tdir), async_write=False).save(
        1, {"p": p, "o": ts1})
    names = sorted(f.name for f in (tdir / "step_00000001").iterdir())
    assert "o__m__layers__wq.npy" in names and "o__step.npy" in names
    jrest, man = jtrain.CheckpointManager(str(tdir)).restore(
        1, {"p": jp, "o": jtrain.init_opt_state(jopt, jp)})
    assert man["treedef"].startswith("{'o': OptState(step=*, m={")
    assert int(jrest["o"].step) == 1
    for got, ref in ((p, jrest["p"]), (ts1.m, jrest["o"].m),
                     (ts1.v, jrest["o"].v)):
        _leaves_close(got, ref, 0.0)


def test_restart_determinism(pair, tmp_path):
    """Train 4 == train 2, checkpoint, restore, train 2 (same data)."""
    _, _, tcfg, tp, _ = pair
    opt = optim.OptConfig(lr=1e-3)
    step = ttrain.make_train_step(tcfg, opt)
    shape = ShapeCfg("t", 32, 8, "train")

    def run(p, o, s0, n):
        for s in range(s0, s0 + n):
            p, o, _, m = step(p, o, None,
                              _tb(ttrain.batch_at_step(tcfg, shape, s)))
        return p, o, m

    fresh = lambda: jax.tree.map(lambda t: t.clone(), tp)  # noqa: E731
    pa = fresh()
    pa, oa, ma = run(pa, ttrain.init_opt_state(opt, pa), 0, 4)
    pb = fresh()
    pb, ob, _ = run(pb, ttrain.init_opt_state(opt, pb), 0, 2)
    ck = ttrain.CheckpointManager(str(tmp_path), async_write=False)
    ck.save(2, {"p": pb, "o": ob})
    rest, _ = ck.restore(2, {"p": tp, "o": ttrain.init_opt_state(opt, tp)})
    pc, oc, mc = run(rest["p"], rest["o"], 2, 2)
    assert float(ma["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-6)
    for a, b in zip(optim.leaves(pa), optim.leaves(pc)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
    assert int(oc.step) == 4


# --------------------------------------------------------------- launch CLI
def test_launch_train_smoke_on_cpu_lowers_the_loss(capsys):
    losses = launch_train.main(["--arch", "llama3.2-1b", "--smoke",
                                "--device", "cpu", "--steps", "20"])
    out = capsys.readouterr().out
    assert len(losses) == 20 and losses[-1] < losses[0]
    assert "step    19 loss" in out and "|g|" in out and "tok/s" in out


def test_launch_train_resume_restores(tmp_path, capsys):
    args = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    full = launch_train.main(args + ["--steps", "6"])
    assert ttrain.CheckpointManager(str(tmp_path)).all_steps() == [3, 6]
    resumed = launch_train.main(args + ["--steps", "8", "--resume"])
    assert "resumed from step 6" in capsys.readouterr().out
    assert len(resumed) == 2
    # The same run from scratch to step 8 gives the resumed losses.
    again = launch_train.main(["--arch", "llama3.2-1b", "--smoke",
                               "--device", "cpu", "--steps", "8"])
    assert again[:6] == pytest.approx(full, rel=1e-6)
    assert again[6:] == pytest.approx(resumed, rel=1e-6)


def test_launch_train_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        launch_train.main(["--arch", "llama3.2-1b", "--smoke", "--steps",
                           "1"])


# ------------------------------------------------------ chip_smoke on the CPU
class _HostEvent:
    """A host-clock stand-in for ``torch.cuda.Event``."""

    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_chip_smoke_lm_train_phases_run_on_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s K2-backward rows and ``lm_train`` phase, run on
    the CPU at the smoke width (head dim 64, so bf16 attention names the
    ``prefill_tc`` kernel): the kernels' plain versions stand in behind
    counting wrappers, attention on CPU tensors goes through
    ``flash_attention`` as on the card, and the CUDA clock, memory stats and
    timers are stubbed.  Every check of the phases holds, with the launch
    counts the card run requires."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import common as TC
    from repro_torch.models import transformer as TT

    from test_torch_ssm import keep_counts

    keep_counts(monkeypatch)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_cpu", Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    small = dataclasses.replace(registry.get_smoke_config("llama3.2-1b"),
                                head_dim=64)
    plain_forward = FA._forward

    def forward(q, k, v, kv_len, causal, scale):
        path = FA.kernel_path(q.dtype, q.shape[1], k.shape[1], q.shape[2],
                              q.shape[3],
                              all(FA.aligned16(t) for t in (q, k, v)))
        FA.flash_attention.launches += 1
        FA.flash_attention.launches_by_path[path] += 1
        return plain_forward(q, k, v, kv_len, causal, scale)

    def backward(q, k, v, out, dout, *rest):
        path = FA.backward_path(q.dtype, q.shape[1], k.shape[1], q.shape[2],
                                q.shape[3], all(FA.aligned16(t) for t in (
                                    q, k, v, out, dout)))
        for key in FA.flash_attention.backward_launches:
            FA.flash_attention.backward_launches[key] += 1
        FA.flash_attention.backward_launches_by_path[path] += 1
        return FA.flash_attention_bwd_plain(q, k, v, out, dout, *rest)

    def attention_any(q, k, v, *, causal, chunk, kv_len=None):
        return FA.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), kv_len,
                                  causal=causal).transpose(1, 2)

    def device_ms(fn, reps=25, warmup=3, tries=3, label="", parts=None):
        fn()
        if parts is not None:
            parts.update({"flash_bwd_dq_tc_kernel": 0.0,
                          "flash_bwd_dkdv_tc_kernel": 0.0})
        return 0.0

    monkeypatch.setattr(cs, "get_config", lambda arch: small)
    monkeypatch.setattr(FA, "_forward", forward)
    monkeypatch.setattr(FA, "flash_attention_bwd", backward)
    monkeypatch.setattr(cs, "flash_attention_bwd", backward)
    monkeypatch.setattr(TC, "attention_any", attention_any)
    monkeypatch.setattr(TT, "attention_any", attention_any)
    for name, fn in (("synchronize", lambda *a: None),
                     ("empty_cache", lambda: None),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("max_memory_allocated", lambda *a: 0),
                     ("Event", _HostEvent)):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(cs, "time_ms", lambda fn, reps=25, warmup=3:
                        (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "device_ms", device_ms)
    monkeypatch.setattr(cs, "TRAIN_LM_STEPS", 4)

    dev = torch.device("cpu")
    rows, worst = cs.phase_flash_backward(dev)
    assert [r["shape"] for r in rows] == ["train_B4_L1024_bwd",
                                          "train_B4_L512_bwd"]
    assert all(r["path"] == "tc" for r in rows)
    # One intra-op thread: the steps then repeat bit for bit (the
    # embedding's index accumulation), as the graph-vs-eager gate needs.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches, fwd, bwd, by_path = cs.phase_lm_train(dev)
    finally:
        torch.set_num_threads(threads)
    # The counts are the main path's alone (the parity pass runs before
    # they start), per layer: the full model's no-grad loss, 2 x grads_of,
    # 1 + 2 microbatches, the 4 steps eagerly and from the graph step, 3
    # profiled steps and 3 compressed steps of 2 microbatches each way on
    # "prefill_tc", all but the first with a backward on "tc".
    n, mbs = small.n_layers, 2 + 3 + 2 * 4 + 3 + 2 * 3 * 2
    assert fwd == {"decode": 0, "prefill_tc": (mbs + 1) * n, "general": 0}
    assert bwd == {"dq": mbs * n, "dkdv": mbs * n}
    assert launches == (mbs + 1) * n
    assert by_path == {"tc": mbs * n, "general": 0}
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    train = next(r for r in out if r.get("phase") == "lm_train")
    assert train["step0_rel_err"] == 0.0
    assert train["losses"][-1] < train["losses"][0]
    assert train["graph_steps_bit_equal_to_eager"] == len(train["losses"])
    assert train["compressed_steps"]["graph_steps_bit_equal_to_eager"] == 3
    assert train["checkpoint_bit_equal"]
    # A report, not a gate: on the CPU the embedding gather's backward
    # need not repeat bit for bit.
    assert set(train["same_step_twice"]) == {
        "loss_bit_equal", "grad_leaves_differing", "grads_bit_equal"}
