"""The transformer families under a mesh (``Dist`` over a ``DeviceMesh``,
DTensors laid out by ``param_specs``) in 4 gloo CPU processes, against the
JAX reference's mesh path on 4 host devices of the same (data, model)
shape, (2, 2) and (1, 4).

One module-scoped spawn per mesh shape runs every case on every rank
(``tests/test_torch_mesh_cases.py``, JAX-free); the reference runs once in
a subprocess with ``--xla_force_host_platform_device_count=4`` while the
ranks run.  Both start from the reference's smoke weights in fp32.  The
gates: forward and prefill logits and caches within rtol = atol = 1e-3
(on (1, 4) the cache split by sequence, as ``cache_specs`` says), the loss
within 1e-4 relative and every gradient leaf within 1e-3 max|ref| + 1e-5
(the port's ``lm_train_parity`` gates), three ``jit_train_step`` steps
each within 1e-4 relative of the reference's, and the capacity
``moe_ffn``'s dropped assignments equal to the reference's, its output
within 1e-5 max|ref| + 1e-6.  A 1x1 mesh (one rank) is bit-equal to the
mesh-free path for the dense smoke configs."""
import concurrent.futures
import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jzoo  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from tests.test_torch_mesh_cases import (  # noqa: E402
    DENSE_ARCHS, MESH_ARCHS, MOE_FACTORS, TRAIN_ARCHS, chip_mesh_rank,
    mesh_rank, single_rank)

SHAPES = ((2, 2), (1, 4))
RANK_TIMEOUT = 300.0

_REFERENCE = textwrap.dedent('''
    import os, pickle, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import models as zoo
    from repro.configs import get_smoke_config
    from repro.launch.mesh import make_debug_mesh
    from repro.models import moe as M
    from repro.models.transformer import Dist
    from repro.train import optim
    from repro.train.step import init_error_feedback, jit_train_step
    sys.path.insert(0, os.getcwd())
    from tests.test_torch_mesh_cases import (
        MAX_LEN, MESH_ARCHS, MOE_FACTORS, STEPS, TRAIN_ARCHS, batch_np,
        microbatches, moe_x_np)
    inp = pickle.load(open(sys.argv[1], "rb"))
    BSPEC = {"tokens": P("data", None), "labels": P("data", None),
             "patches": P("data", None, None)}
    is_p = lambda s: isinstance(s, P)
    shape = tuple(int(n) for n in sys.argv[3].split("x"))
    mesh = make_debug_mesh(*shape)
    assert mesh.devices.shape == shape
    dist = Dist(mesh, batch_axes=("data",))
    ns = lambda s: NamedSharding(mesh, s)
    res = {"arch": {}, "train": {}, "moe": {}}
    for arch in MESH_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  dtype=jnp.float32)
        pspecs = zoo.param_specs(cfg, dist)
        params = jax.device_put(
            jax.tree.map(jnp.asarray, inp[arch]),
            jax.tree.map(ns, pspecs, is_leaf=is_p))
        bnp = batch_np(cfg)
        batch = {k: jax.device_put(jnp.asarray(v), ns(BSPEC[k]))
                 for k, v in bnp.items()}
        def cases(p, b):
            serve = {k: v for k, v in b.items() if k != "labels"}
            last, cache = zoo.prefill(cfg, p, serve, MAX_LEN, dist)
            loss, grads = jax.value_and_grad(
                lambda p: zoo.loss_fn(cfg, p, b, dist))(p)
            return {"logits": zoo.forward(cfg, p, b, dist)[0],
                    "prefill_logits": last, "cache_k": cache["k"],
                    "cache_v": cache["v"], "cache_len": cache["len"],
                    "loss": loss, "grads": grads}
        res["arch"][arch] = jax.tree.map(
            np.asarray, jax.jit(cases)(params, batch))
        if arch in TRAIN_ARCHS[shape]:
            opt_cfg = optim.for_model(cfg)
            step = jit_train_step(cfg, dist, pspecs, opt_cfg,
                                  microbatches=microbatches(arch),
                                  batch_specs={k: BSPEC[k]
                                               for k in batch})
            opt = optim.init_opt_state(opt_cfg, params)
            ef = init_error_feedback(params)
            losses = []
            for _ in range(STEPS):
                params, opt, ef, m = step(params, opt, ef, batch)
                losses.append(float(m["loss"]))
            res["train"][arch] = losses
    cfg0 = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                               dtype=jnp.float32)
    lay = inp["deepseek-moe-16b"]["layers"]
    p = {"router": jnp.asarray(lay["router"][0]),
         "w13": jax.device_put(jnp.asarray(lay["moe_w13"][0]),
                               ns(P("model", "data", None))),
         "w2": jax.device_put(jnp.asarray(lay["moe_w2"][0]),
                              ns(P("model", None, "data")))}
    x = jax.device_put(jnp.asarray(moe_x_np(cfg0)),
                       ns(P("data", None, None)))
    def routed(p, x):
        idx, w, _ = M.router_topk(x, p["router"], cfg0.top_k)
        # Every expert's output on every token (the dense oracle's).
        h = jnp.einsum("btd,edf->btef", x, p["w13"])
        g, u = jnp.split(h, 2, axis=-1)
        ffn = jnp.einsum("btef,efd->bted", jax.nn.silu(g) * u, p["w2"])
        return {"idx": idx, "weights": w, "ffn": ffn}
    every = jax.tree.map(np.asarray, jax.jit(routed)(p, x))
    for cf in MOE_FACTORS:
        cfg = dataclasses.replace(cfg0, capacity_factor=cf)
        y, _ = jax.jit(lambda p, x: M.moe_ffn(
            cfg, p, x, mesh, ("data",), "model", "data"))(p, x)
        res["moe"][cf] = {"out": np.asarray(y), **every}
    pickle.dump(res, open(sys.argv[2], "wb"))
    print("REFERENCE OK")
''')


def _params(arch):
    cfg = dataclasses.replace(j_smoke(arch), dtype=jnp.float32)
    params = jzoo.init_params(cfg, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def runs():
    """The reference's results and each rank spawn's (rank 0's)."""
    params = {a: _params(a) for a in MESH_ARCHS + DENSE_ARCHS}
    with tempfile.TemporaryDirectory(prefix="mesh-ref-") as tmp:
        src = os.path.join(tmp, "in.pkl")
        with open(src, "wb") as f:
            pickle.dump(params, f)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("XLA_FLAGS", None)
        refs = {s: subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, src,
             os.path.join(tmp, f"{s[0]}x{s[1]}.pkl"), f"{s[0]}x{s[1]}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for s in SHAPES}
        try:
            with concurrent.futures.ThreadPoolExecutor(4) as pool:
                spawns = {s: pool.submit(run_ranks, mesh_rank, 4, s, params,
                                         timeout=RANK_TIMEOUT)
                          for s in SHAPES}
                single = pool.submit(run_ranks, single_rank, 1, params,
                                     timeout=RANK_TIMEOUT)
                chip = pool.submit(run_ranks, chip_mesh_rank, 1,
                                   timeout=RANK_TIMEOUT)
                port = {s: f.result()[0] for s, f in spawns.items()}
                one = single.result()[0]
                rehearsal = chip.result()[0]
            reference = {}
            for s, ref in refs.items():
                log, _ = ref.communicate(timeout=RANK_TIMEOUT)
                assert "REFERENCE OK" in log, log[-4000:]
                with open(os.path.join(tmp, f"{s[0]}x{s[1]}.pkl"), "rb") as f:
                    reference[s] = pickle.load(f)
        finally:
            for ref in refs.values():
                if ref.poll() is None:
                    ref.kill()
    return {"port": port, "ref": reference, "one": one,
            "chip": rehearsal}


def _close(got, ref, rtol, atol):
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_forward_and_prefill_match_reference_mesh(runs, arch, shape):
    got = runs["port"][shape]["arch"][arch]
    ref = runs["ref"][shape]["arch"][arch]
    for key in ("logits", "prefill_logits", "cache_k", "cache_v"):
        _close(got[key], ref[key], 1e-3, 1e-3)
    np.testing.assert_array_equal(got["cache_len"], ref["cache_len"])
    assert got["cache_placed"], got["cache_spec"]
    if shape == (1, 4) and arch != "deepseek-moe-16b":
        # 2 KV heads on a 4-way model axis: the cache is split by sequence.
        assert got["cache_spec"] == "P(None, 'data', 'model', None, None)"


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_loss_and_gradients_match_reference_mesh(runs, arch, shape):
    got = runs["port"][shape]["arch"][arch]
    ref = runs["ref"][shape]["arch"][arch]
    assert abs(float(got["loss"]) - float(ref["loss"])) <= \
        1e-4 * abs(float(ref["loss"]))
    g_leaves, r_leaves = _leaves(got["grads"]), _leaves(ref["grads"])
    assert [n for n, _ in g_leaves] == [n for n, _ in r_leaves]
    for (name, g), (_, r) in zip(g_leaves, r_leaves):
        tol = 1e-3 * float(np.abs(r).max()) + 1e-5
        assert np.abs(g - r).max() <= tol, name


@pytest.mark.parametrize("shape,arch", [
    (s, a) for s in SHAPES for a in TRAIN_ARCHS[s]],
    ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v)
def test_jit_train_step_matches_reference_mesh(runs, arch, shape):
    got = runs["port"][shape]["train"][arch]
    ref = runs["ref"][shape]["train"][arch]
    assert got[-1] < got[0]
    for g, r in zip(got, ref):
        assert abs(g - r) <= 1e-4 * abs(r), (got, ref)


def _reference_drops(idx, T_local, E, C):
    """The reference body's rule (``moe.py:149-160``): per data shard, an
    assignment is kept when fewer than C earlier assignments (in flat token
    order t*k + j) chose its expert."""
    B, L, k = idx.shape
    flat = idx.reshape(-1, T_local * k)            # one row per data shard
    dropped = np.zeros_like(flat)
    for row, assign in zip(dropped, flat):
        seen = np.zeros(E, np.int64)
        for a, e in enumerate(assign):
            row[a] = seen[e] >= C
            seen[e] += 1
    return dropped.reshape(B, L, k)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("cf", MOE_FACTORS)
def test_capacity_moe_drops_match_reference(runs, cf, shape):
    """The port's dropped set equals the reference's, shown to be the
    reference's by its output: the reference's ``moe_ffn`` equals every
    kept assignment's expert output weighted and summed (and no other
    set)."""
    from repro_torch.models.moe import capacity
    from tests.test_torch_mesh_cases import config
    got = runs["port"][shape]["moe"][cf]
    ref = runs["ref"][shape]["moe"][cf]
    cfg = dataclasses.replace(config("deepseek-moe-16b"), capacity_factor=cf)
    B, L, k = ref["idx"].shape
    T_local = B // shape[0] * L
    C = capacity(cfg, T_local)
    drops = _reference_drops(ref["idx"], T_local, cfg.n_experts, C)
    keep = (1 - drops) * ref["weights"]
    oracle = np.einsum("btk,btkd->btd", keep, np.take_along_axis(
        ref["ffn"], ref["idx"][..., None], axis=2))
    scale = float(np.abs(ref["out"]).max())
    assert np.abs(oracle - ref["out"]).max() <= 1e-5 * scale + 1e-6
    np.testing.assert_array_equal(got["dropped"], drops)
    assert np.abs(got["out"] - ref["out"]).max() <= 1e-5 * scale + 1e-6
    if cf < 1:
        assert drops.mean() >= 0.1, drops.mean()
    else:
        assert drops.sum() == 0


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("case", ("forward", "prefill", "train"))
def test_one_by_one_mesh_bit_equal(runs, arch, case):
    """On a 1x1 mesh the DTensor path runs the mesh-free path's operations
    on the whole tensors: forward, prefill and one ``jit_train_step``
    (loss, parameters, moments) equal bit for bit."""
    ref, got = runs["one"][arch][case]
    assert ref.shape == got.shape
    np.testing.assert_array_equal(got, ref)


def test_one_by_one_capacity_moe_matches_dropless(runs):
    """The capacity path with nothing dropped is the dropless function in
    another summation order."""
    ref, got, dropped = runs["one"]["moe"]
    assert dropped == 0
    assert np.abs(got - ref).max() <= 1e-5 * float(np.abs(ref).max())


def test_chip_smoke_mesh_phases_run_on_cpu(runs):
    """``chip_smoke.py``'s mesh_parity, mesh_train and mesh_moe on a 1x1
    gloo mesh at the smoke widths, behind counting stand-ins for K2: every
    check of the phases holds (bit-equal forward, prefill and train runs;
    the dropped set against the host rule, about half of it at 0.5), with
    the launch counts the card run requires."""
    rec = {r["phase"]: r for r in runs["chip"]["records"]}
    assert set(rec) == {"mesh_parity", "mesh_train", "mesh_moe"}
    assert rec["mesh_parity"]["forward_bit_equal"]
    assert all(rec["mesh_parity"]["prefill_bit_equal"].values())
    assert rec["mesh_train"]["bit_equal_to_mesh_free"]
    drops = rec["mesh_moe"]["capacity_factors"]
    assert drops["2.0"]["dropped"] == 0
    assert drops["0.5"]["dropped_share"] >= 0.1
    assert all(d["drops_equal_host_rule"] for d in drops.values())
    launched = runs["chip"]["launched"]
    L = 2                                     # the smoke llama's layers
    assert launched["mesh_parity"]["prefill_tc"] == 2 * L
    assert launched["mesh_train"][0]["prefill_tc"] == 2 * 3 * L
    assert launched["mesh_train"][2]["tc"] == 2 * 3 * L

