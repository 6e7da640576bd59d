"""The hybrid, xLSTM and enc-dec families under a mesh (``Dist`` over a
``DeviceMesh``, DTensors laid out by ``param_specs`` and
``launch.sharding``) in 4 gloo CPU processes, against the JAX reference's
mesh path on 4 host devices of the same (data, model) shape, (2, 2) and
(1, 4).

One module-scoped spawn per mesh shape runs every case on every rank
(``tests/test_torch_mesh_family_cases.py``, JAX-free); the reference runs
once per shape in a subprocess with ``--xla_force_host_platform_device_count
=4`` while the ranks run.  Both start from the reference's smoke weights
in fp32, on 4 x 136 tokens (past one SSD chunk).  The gates are
``tests/test_torch_mesh_ranks.py``'s: forward and prefill logits and every
cache key within rtol = atol = 1e-3 (laid out as ``cache_specs`` says),
each of 8 decode steps' logits and the cache after them the same, the
loss within 1e-4 relative and every gradient leaf within 1e-3 max|ref| +
1e-5, three ``jit_train_step`` steps (each family on one of the shapes)
each within 1e-4 relative of the reference's.  A 1x1 mesh (one rank) is
bit-equal to the mesh-free path."""
import concurrent.futures
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
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from tests.test_torch_mesh_family_cases import (  # noqa: E402
    FAMILY_ARCHS, TRAIN_SHAPES, families_rank, one_by_one_rank)

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
    from repro.models.transformer import Dist
    from repro.train import optim
    from repro.train.step import init_error_feedback, jit_train_step
    sys.path.insert(0, os.getcwd())
    from tests.test_torch_mesh_family_cases import (
        FAMILY_ARCHS, MAX_LEN, STEPS, TRAIN_SHAPES, batch_np,
        decode_tokens_np)
    inp = pickle.load(open(sys.argv[1], "rb"))
    BSPEC = {"tokens": P("data", None), "labels": P("data", None),
             "frames": P("data", None, None)}
    is_p = lambda s: isinstance(s, P)
    shape = tuple(int(n) for n in sys.argv[3].split("x"))
    mesh = make_debug_mesh(*shape)
    dist = Dist(mesh, batch_axes=("data",))
    ns = lambda s: NamedSharding(mesh, s)
    res = {}
    for arch in FAMILY_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=jnp.float32)
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
                    "prefill_logits": last, "cache": cache,
                    "loss": loss, "grads": grads}
        out = jax.jit(cases)(params, batch)
        decode = jax.jit(lambda p, t, c: zoo.decode_step(cfg, p, t, c, dist))
        cache = out["cache"]
        logits = []
        for t in decode_tokens_np(cfg):
            lg, cache = decode(params, jax.device_put(
                jnp.asarray(t), ns(BSPEC["tokens"])), cache)
            logits.append(lg)
        out["decode_logits"] = logits
        out["decode_cache"] = cache
        res[arch] = jax.tree.map(np.asarray, out)
        if TRAIN_SHAPES[arch] != shape:
            continue
        opt_cfg = optim.for_model(cfg)
        step = jit_train_step(cfg, dist, pspecs, opt_cfg, microbatches=1,
                              batch_specs={k: BSPEC[k] for k in batch})
        opt = optim.init_opt_state(opt_cfg, params)
        ef = init_error_feedback(params)
        losses = []
        for _ in range(STEPS):
            params, opt, ef, m = step(params, opt, ef, batch)
            losses.append(float(m["loss"]))
        res[arch]["train"] = losses
    pickle.dump(res, open(sys.argv[2], "wb"))
    print("REFERENCE OK")
''')


def _params(arch):
    from repro.configs import get_smoke_config
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=jnp.float32)
    return jax.tree.map(np.asarray,
                        jzoo.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def runs():
    """The reference's results and each rank spawn's (rank 0's)."""
    params = {a: _params(a) for a in FAMILY_ARCHS}
    with tempfile.TemporaryDirectory(prefix="mesh-fam-") as tmp:
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
            with concurrent.futures.ThreadPoolExecutor(3) as pool:
                spawns = {s: pool.submit(run_ranks, families_rank, 4, s,
                                         params, timeout=RANK_TIMEOUT)
                          for s in SHAPES}
                single = pool.submit(run_ranks, one_by_one_rank, 1, params,
                                     timeout=RANK_TIMEOUT)
                port = {s: f.result()[0] for s, f in spawns.items()}
                one = single.result()[0]
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
    return {"port": port, "ref": reference, "one": one}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


def _close(got, ref, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=1e-3,
                               atol=1e-3, err_msg=what)


SHAPE_IDS = {"ids": lambda s: f"{s[0]}x{s[1]}"}


@pytest.mark.parametrize("shape", SHAPES, **SHAPE_IDS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_and_prefill_match_reference_mesh(runs, arch, shape):
    got = runs["port"][shape][arch]
    ref = runs["ref"][shape][arch]
    for key in ("logits", "prefill_logits"):
        _close(got[key], ref[key], key)
    assert sorted(got["cache"]) == sorted(ref["cache"])
    for key in ref["cache"]:
        _close(got["cache"][key], ref["cache"][key], f"cache {key}")
    assert got["cache_placed"]


@pytest.mark.parametrize("shape", SHAPES, **SHAPE_IDS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_steps_match_reference_mesh(runs, arch, shape):
    got = runs["port"][shape][arch]
    ref = runs["ref"][shape][arch]
    assert len(got["decode_logits"]) == len(ref["decode_logits"]) == 8
    for i, (g, r) in enumerate(zip(got["decode_logits"],
                                   ref["decode_logits"])):
        _close(g, r, f"decode step {i}")
    for key in ref["decode_cache"]:
        _close(got["decode_cache"][key], ref["decode_cache"][key],
               f"cache {key} after decode")


@pytest.mark.parametrize("shape", SHAPES, **SHAPE_IDS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_gradients_match_reference_mesh(runs, arch, shape):
    got = runs["port"][shape][arch]
    ref = runs["ref"][shape][arch]
    assert abs(float(got["loss"]) - float(ref["loss"])) <= \
        1e-4 * abs(float(ref["loss"]))
    g_leaves, r_leaves = _leaves(got["grads"]), _leaves(ref["grads"])
    assert [n for n, _ in g_leaves] == [n for n, _ in r_leaves]
    for (name, g), (_, r) in zip(g_leaves, r_leaves):
        tol = 1e-3 * float(np.abs(r).max()) + 1e-5
        assert np.abs(g - r).max() <= tol, name


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_jit_train_step_matches_reference_mesh(runs, arch):
    shape = TRAIN_SHAPES[arch]
    got = runs["port"][shape][arch]["train"]
    ref = runs["ref"][shape][arch]["train"]
    assert got[-1] < got[0]
    for g, r in zip(got, ref):
        assert abs(g - r) <= 1e-4 * abs(r), (got, ref)


@pytest.mark.parametrize("case", ("logits", "prefill_logits", "cache",
                                  "decode_logits", "decode_cache", "loss",
                                  "grads"))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_one_by_one_mesh_bit_equal(runs, arch, case):
    """On a 1x1 mesh the three families' meshed forward, prefill, decode
    steps, loss and gradients are the mesh-free path's bits."""
    ref, got = runs["one"][arch][case]
    assert ref.shape == got.shape
    np.testing.assert_array_equal(got, ref)
