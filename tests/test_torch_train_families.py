"""Training of the MoE, hybrid, VLM, enc-dec and xLSTM families, port vs the
JAX reference on the same weights: the grouped GEMM's ragged adjoints
(``models/moe.py``, the reference's ``custom_vjp``) on both routes, every
gradient leaf of each family's ``loss_fn`` against ``jax.grad`` of the
reference's, three ``make_train_step`` steps lowering the loss (the
reference's ``test_smoke_train_step`` form), the optimizer's chunked
update, and ``chip_smoke.py``'s training phases rehearsed on the CPU at the
smoke widths.

Tolerances: the grouped GEMM's forward and adjoints rtol = atol = 1e-4 (the
reference's own, tests/test_moe_and_loss.py); a gradient leaf within
1e-4 * max|ref| + 1e-6 (fp32, another summation order through a whole
model's backward)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jz  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import (OptConfig, init_opt_state,  # noqa: E402
                               make_train_step, optim)

GG_TOL = 1e-4                      # tests/test_moe_and_loss.py
GRAD_REL, GRAD_ABS = 1e-4, 1e-6
ARCHS = ["deepseek-moe-16b", "kimi-k2-1t-a32b", "zamba2-1.2b", "xlstm-1.3b",
         "internvl2-2b", "seamless-m4t-medium"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the models' eager loops make thousands of tiny
    ops, and with one thread the CPU's index accumulation (the embedding's
    backward) runs in one order, so a gradient repeats bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ grouped GEMM
def _route(monkeypatch, route):
    """Both routes on the CPU: "loop" is the CPU's own, "grouped_mm" runs
    torch's CPU ``_grouped_mm`` (its per-group fallback)."""
    monkeypatch.setattr(TM, "grouped_gemm_route", lambda x, w: route)


@pytest.mark.parametrize("route", ["loop", "grouped_mm"])
@pytest.mark.parametrize("m,k,n,g,sizes", [
    (32, 16, 12, 4, None), (64, 8, 8, 8, None), (16, 32, 4, 2, None),
    (32, 16, 12, 4, [9, 0, 13, 5])])
def test_grouped_gemm_adjoints_match_reference(monkeypatch, m, k, n, g,
                                               sizes, route):
    """The reference's three cases (groups covering every row), and one
    with an empty group and 5 rows past the groups: the forward and both
    adjoints against ``jax.grad`` of the reference's ``grouped_gemm``
    (its ``custom_vjp``), each call's forward and backward counted once on
    its route, an empty group's dw and the rows past the groups' dx 0."""
    _route(monkeypatch, route)
    rng = np.random.default_rng(m + k + g + (sizes is not None))
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(g, k, n)).astype(np.float32)
    dy = rng.normal(size=(m, n)).astype(np.float32)
    gs = (np.asarray(sizes, np.int32) if sizes is not None
          else rng.multinomial(m, np.ones(g) / g).astype(np.int32))

    def j_loss(x, w):
        return (JM.grouped_gemm(x, w, jnp.asarray(gs)) * dy).sum()
    ref = JM.grouped_gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs))
    j_dx, j_dw = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(x),
                                                  jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    fwd = dict(TM.grouped_gemm.launches_by_route)
    bwd = dict(TM.grouped_gemm.backward_launches_by_route)
    out = TM.grouped_gemm(tx, tw, torch.from_numpy(gs))
    dx, dw = torch.autograd.grad(out, (tx, tw), torch.from_numpy(dy))
    for got, want in ((out, ref), (dx, j_dx), (dw, j_dw)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=GG_TOL, atol=GG_TOL)
    assert TM.grouped_gemm.launches_by_route == {**fwd, route: fwd[route] + 1}
    assert TM.grouped_gemm.backward_launches_by_route == {
        **bwd, route: bwd[route] + 1}
    covered = int(gs.sum())
    assert torch.equal(dx[covered:], torch.zeros((m - covered, k)))
    for e in np.flatnonzero(gs == 0):
        assert torch.equal(dw[e], torch.zeros((k, n)))


def test_grouped_gemm_backward_is_ragged_and_repeats(monkeypatch):
    """The adjoints do the forward's work: dw[e] is group e's rows alone
    (a row's change moves only its own group's dw), and two backwards of
    one call are bit-equal on both routes."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(40, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(4, 16, 8)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32))
    ends = torch.tensor([10, 10, 30, 40], dtype=torch.int32)
    grads = {}
    for route in ("loop", "grouped_mm"):
        _route(monkeypatch, route)
        leaves = [t.clone().requires_grad_(True) for t in (x, w)]
        out = TM._grouped(*leaves, ends)
        first = torch.autograd.grad(out, leaves, dy, retain_graph=True)
        again = torch.autograd.grad(out, leaves, dy)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        grads[route] = first
        moved = [x.clone(), w.clone().requires_grad_(True)]
        moved[0][12] += 1.0                    # a row of group 2
        dw2, = torch.autograd.grad(TM._grouped(*moved, ends), moved[1], dy)
        changed = [e for e in range(4)
                   if not torch.equal(dw2[e], first[1][e])]
        assert changed == [2]
    for a, b in zip(grads["loop"], grads["grouped_mm"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_moe_ffn_gradients_repeat_and_match_the_dense_oracle():
    """``moe_ffn`` under autograd: the dispatch gathers by a permutation,
    so its gradients repeat bit for bit, and they equal autograd through
    the dense oracle (every expert on every token)."""
    from repro_torch.models.common import LMConfig
    cfg = LMConfig(name="t", family="moe", n_layers=1, d_model=16, n_heads=2,
                   n_kv_heads=2, d_ff=0, vocab=64, n_experts=8, top_k=3,
                   expert_d_ff=8, dtype=torch.float32)
    rng = np.random.default_rng(5)
    p = {"router": rng.normal(size=(16, 8)) * 0.3,
         "w13": rng.normal(size=(8, 16, 16)) * 0.3,
         "w2": rng.normal(size=(8, 8, 16)) * 0.3}
    p = {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}
    x = torch.from_numpy(rng.normal(size=(2, 9, 16)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(2, 9, 16)).astype(np.float32))

    def grads(fn):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xl = x.clone().requires_grad_(True)
        out, aux = fn(cfg, leaves, xl)
        return torch.autograd.grad((out * dout).sum() + aux,
                                   [xl] + list(leaves.values()))
    first, again = grads(TM.moe_ffn), grads(TM.moe_ffn)
    dense = grads(TM.moe_ffn_dense_ref)
    for a, b, r in zip(first, again, dense):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ----------------------------------------------------- gradients of loss_fn
def _pair(arch, **kw):
    """The smoke config in fp32 (with ``kw``) on both sides and the
    reference's weights carried across."""
    jcfg = dataclasses.replace(j_get_smoke(arch), dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(registry.get_smoke_config(arch),
                               dtype=torch.float32, **kw)
    jp = jz.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _batch(cfg, seed, B=2, L=40):
    """numpy tokens and labels (some ignored), and the stub frontend's
    input (VLM patches, enc-dec frames), from ``seed``."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(1, cfg.vocab, size=(B, L)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, size=(B, L)).astype(np.int32)}
    b["labels"][0, :3] = -100
    if cfg.family == "vlm":
        b["patches"] = rng.normal(size=(B, cfg.frontend_len,
                                        cfg.frontend_dim)).astype(np.float32)
    if cfg.family == "encdec":
        b["frames"] = rng.normal(size=(B, cfg.frontend_len,
                                       cfg.frontend_dim)).astype(np.float32)
    return b


def _named(tree, pre=""):
    out = {}
    for k, v in tree.items():
        out.update(_named(v, f"{pre}{k}/") if isinstance(v, dict)
                   else {f"{pre}{k}": v})
    return out


@pytest.mark.parametrize("arch,L", [(a, 40) for a in ARCHS]
                         + [("zamba2-1.2b", 160), ("xlstm-1.3b", 160)])
def test_every_gradient_leaf_matches_reference(arch, L):
    """``grads_of`` (autograd through the port's ``loss_fn``, every layer
    checkpointed as the full configs run it) against ``jax.grad`` of the
    reference's ``loss_fn`` on the same weights and batch: the loss and
    every leaf; L = 160 runs the recurrent families' scans past one SSD
    chunk (128)."""
    jcfg, jp, tcfg, tp = _pair(arch)
    b = _batch(tcfg, L, L=L)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jz.loss_fn(jcfg, p, b)))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    ref = _named(jax.tree.map(np.asarray, jg))
    cfg = dataclasses.replace(tcfg, remat=True)
    loss, grads = make_train_step(cfg).grads_of(
        tp, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-5)
    got = _named(grads)
    assert sorted(got) == sorted(ref)
    for name, g in got.items():
        r = ref[name]
        err = float(np.abs(g.numpy() - r).max())
        assert err <= GRAD_REL * float(np.abs(r).max()) + GRAD_ABS, (name,
                                                                     err)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_lower_the_loss(arch):
    """tests/test_models_zoo.py::test_smoke_train_step's form: the arch's
    optimizer at lr 1e-2, three steps on one batch, each loss finite and
    the last below the first; kimi-k2 keeps its weights in bf16 as its
    full config does (Lion, bf16 momentum)."""
    kw = ({"param_dtype": torch.bfloat16} if arch == "kimi-k2-1t-a32b"
          else {})
    cfg = dataclasses.replace(registry.get_smoke_config(arch),
                              dtype=torch.float32, **kw)
    params = TT.params_from_jax(jax.tree.map(np.asarray, jz.init_params(
        dataclasses.replace(j_get_smoke(arch), dtype=jnp.float32),
        jax.random.PRNGKey(0))), device="cpu")
    params = optim.tree_map(lambda t: t.to(cfg.param_dtype), params)
    opt = OptConfig(name=cfg.optimizer, lr=1e-2,
                    momentum_dtype=optim.for_model(cfg).momentum_dtype)
    state = init_opt_state(opt, params)
    step = make_train_step(cfg, opt)
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 11, L=16).items()}
    losses = []
    for _ in range(3):
        params, state, _, m = step(params, state, None, b)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


@pytest.mark.parametrize("name", ["adamw", "lion"])
def test_chunked_update_equals_whole_leaves(monkeypatch, name):
    """``apply_updates`` works on flat chunks of each leaf: with chunks of
    7 elements, two steps give the parameters, moments and norms of
    whole-leaf chunks bit for bit."""
    rng = np.random.default_rng(2)

    def tree(scale):
        return {"a": torch.from_numpy(rng.normal(size=(5, 9)).astype(
                    np.float32) * scale),
                "b": {"c": torch.from_numpy(rng.normal(size=(3, 4, 6))
                                            .astype(np.float32) * scale),
                      "d": torch.from_numpy(rng.normal(size=(11,))
                                            .astype(np.float32) * scale)}}
    cfg = OptConfig(name=name, lr=1e-2, grad_clip=0.5)
    params, grads = tree(1.0), tree(3.0)
    out = []
    for chunk in (7, optim.UPDATE_CHUNK):
        monkeypatch.setattr(optim, "UPDATE_CHUNK", chunk)
        p = optim.tree_map(torch.clone, params)
        state = init_opt_state(cfg, p)
        norms = []
        for _ in range(2):
            p, state, gn = optim.apply_updates(cfg, p, grads, state)
            norms.append(gn)
        out.append(optim.leaves({"p": p, "m": state.m, "v": state.v})
                   + norms)
    assert all(torch.equal(a, b) for a, b in zip(*out))


# ------------------------------------------------------ chip_smoke on the CPU
TRAIN_PHASES = ["moe_train", "hybrid_train", "vlm_train", "encdec_train",
                "xlstm_train"]


def _train_rehearsal(monkeypatch):
    """``chip_smoke.py`` set up to run its training phases on the CPU at
    the smoke widths with head dim 64 (so bf16 attention names the
    ``prefill_tc`` kernel and its backward the ``tc`` pair) and every layer
    checkpointed, as the full configs run: K2's plain forward and backward
    behind wrappers that count launches by the kernel and path the card
    would take, every grouped GEMM on the grouped_mm route (torch's CPU
    ``_grouped_mm``), the CUDA clock and memory stats stubbed."""
    from test_torch_ssm import _chip_smoke_on_cpu
    from repro_torch.kernels import flash_attention as FA

    configs = {arch: dataclasses.replace(registry.get_smoke_config(arch),
                                         head_dim=64, remat=True)
               for arch in ARCHS}
    cs, _ = _chip_smoke_on_cpu(monkeypatch, configs)

    def backward(q, k, v, out, dout, *rest):
        path = FA.backward_path(q.dtype, q.shape[1], k.shape[1], q.shape[2],
                                q.shape[3], all(FA.aligned16(t) for t in (
                                    q, k, v, out, dout)))
        for key in FA.flash_attention.backward_launches:
            FA.flash_attention.backward_launches[key] += 1
        FA.flash_attention.backward_launches_by_path[path] += 1
        return FA.flash_attention_bwd_plain(q, k, v, out, dout, *rest)

    monkeypatch.setattr(FA, "flash_attention_bwd", backward)
    monkeypatch.setattr(cs, "flash_attention_bwd", backward)
    monkeypatch.setattr(TM, "grouped_gemm_route", lambda x, w: "grouped_mm")
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (0, 0))
    for phase, (arch, cut, _, _, lr) in cs.TRAIN_MAIN.items():
        monkeypatch.setitem(cs.TRAIN_MAIN, phase, (arch, cut, 160, 4, lr))
    return cs, configs


@pytest.mark.parametrize("phase", TRAIN_PHASES)
def test_chip_smoke_train_phases_run_on_cpu(monkeypatch, capsys, phase):
    """Each family's training phase: the parity part (card side and CPU
    side on the same weights) and the main path, every gate holding, with
    the launches the card run requires: per microbatch one K2 forward a
    site and again for each site a remat backward recomputes, one of each
    backward kernel a site on the tensor-core pair, and two grouped GEMMs
    each way a MoE layer (the forward again under remat)."""
    import json
    cs, configs = _train_rehearsal(monkeypatch)
    dev = torch.device("cpu")
    fwd, bwd, by_path = cs.phase_family_train(phase, dev)
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    parity = next(o for o in out if o.get("phase") == f"{phase}_parity")
    main = next(o for o in out if o.get("phase") == phase)
    arch, cut, seq, steps, lr = cs.TRAIN_MAIN[phase]
    cfg = dataclasses.replace(configs[arch], **cut)
    sites, again = cs._train_k2_sites(cfg)
    # grads_of twice, the steps eagerly and from the graph step, profile
    mbs = 2 + 2 * steps + 1 + main["profiled_steps"]
    assert main["lr"] == lr and main["profiled_steps"] == 2
    assert fwd == {"decode": 0, "general": 0,
                   "prefill_tc": sites + mbs * (sites + again)}
    assert bwd == {"dq": mbs * sites, "dkdv": mbs * sites}
    assert by_path == {"tc": mbs * sites, "general": 0}
    if cfg.family == "moe":
        assert parity["expert_sets_equal"] is True
        n_moe = cfg.n_layers - cfg.first_dense_layers
        assert main["grouped_gemm_calls_per_microbatch"] == [4 * n_moe,
                                                              2 * n_moe]
    assert sites == {"moe": cfg.n_layers, "vlm": cfg.n_layers,
                     "hybrid": cs.ssm.num_shared_calls(cfg),
                     "encdec": cfg.n_enc_layers + 2 * cfg.n_layers,
                     "ssm": 0}[cfg.family]
    assert parity["grad_excess"] <= 0 and parity["loss_rel_err"] <= 1e-4
    assert main["grads_bit_equal_twice"] and main["step0_rel_err"] <= 1e-3
    assert len(main["losses"]) == steps
    assert main["losses"][-1] < main["losses"][0]


def test_chip_smoke_train_kernel_rows_run_on_cpu(monkeypatch, capsys):
    """The ``kernels`` phase's training rows at the smoke widths (head dim
    64): K2's backward at the four families' five training shapes on the
    tensor-core pair, and the grouped GEMM's backward on grouped_mm for
    both products of a MoE layer, each against its plain version, with
    the bound and the library call."""
    import json
    cs, _ = _train_rehearsal(monkeypatch)
    rows, worst, gg = cs.phase_train_kernels(torch.device("cpu"))
    assert [r["shape"] for r in rows] == [
        "deepseek_train_B4_L1024_D128_bwd",
        "internvl2_train_B4_L1280_D128_g2_bwd",
        "zamba2_train_B4_L1024_D64_bwd",
        "seamless_train_B4_L1024_D64_noncausal_bwd",
        "seamless_dec_train_B4_L1024_D64_bwd"]
    assert all(r["path"] == "tc" for r in rows)
    assert [r["causal"] for r in rows] == [True, True, True, False, True]
    assert [g["shape"] for g in gg] == ["deepseek_w13_T4096x6_bwd",
                                        "deepseek_w2_T4096x6_bwd"]
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    for row in gg:
        assert row["route"] == "grouped_mm" and row["bound_ms"] > 0
        assert row["bound_by"] in ("bytes", "operations")
        assert set(row["max_abs_err"]) == {"dx", "dw"}
    assert sum(o.get("kernel") == "grouped_gemm_backward" for o in out) == 2
