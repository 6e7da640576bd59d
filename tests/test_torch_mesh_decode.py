"""Decode and serving under a mesh, in 4 gloo CPU processes against the
JAX reference's mesh path on 4 host devices of the same (data, model)
shape, (2, 2) and (1, 4); and K2's decode with stats merged across key
slices, against the reference's Pallas kernel in interpret mode.

* llama3.2-1b (smoke, fp32): a prefill of 4 x 20 tokens into a 32-position
  cache, then 8 decode steps on given tokens.  On (1, 4) its 2 KV heads do
  not divide ``model``, so ``cache_specs`` splits the cache by sequence:
  each shard attends its slice with K2's stats and the slices merge in
  order (``transformer._attn_decode_mesh``).
* llama_mqa (one KV head), B = 1 on (2, 2): the long-context layout, the
  cache split by sequence over both axes.
* qwen6 (6 q heads): on (1, 4) the heads do not divide ``model``; the
  head-group split (``transformer._attn_layout``) computes the reference's
  function: forward, prefill, loss and every gradient.
* ``ServeEngine(dist=...)``: the tokens of 6 requests equal to the
  reference engine's under its ``dist``.

The gates are ``tests/test_torch_mesh_ranks.py``'s (rtol = atol = 1e-3 on
logits and caches, 1e-4 relative on the loss, 1e-3 max|ref| + 1e-5 on each
gradient leaf); served tokens are equal."""
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
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    combine_decode_partials, decode_split, flash_attention,
    flash_decode_split_plain)
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from tests.test_torch_mesh_family_cases import (  # noqa: E402
    VARIANTS, chip_rehearsal_rank, decode_rank)

SHAPES = ((2, 2), (1, 4))
RANK_TIMEOUT = 300.0
NAMES = ("llama3.2-1b", "qwen6", "llama_mqa")

_REFERENCE = textwrap.dedent('''
    import os, pickle, sys, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import models as zoo
    from repro.configs import get_smoke_config
    from repro.launch.mesh import make_debug_mesh
    from repro.models.transformer import Dist
    from repro.serve import Request, ServeEngine
    sys.path.insert(0, os.getcwd())
    from tests import test_torch_mesh_cases as MC
    from tests.test_torch_mesh_family_cases import (
        DEC_B, DEC_L, DEC_MAX, SERVE, VARIANTS, batch_np, decode_tokens_np,
        serve_prompts)
    inp = pickle.load(open(sys.argv[1], "rb"))
    is_p = lambda s: isinstance(s, P)
    shape = tuple(int(n) for n in sys.argv[3].split("x"))
    mesh = make_debug_mesh(*shape)
    ns = lambda s: NamedSharding(mesh, s)

    def config(name):
        base, over = VARIANTS.get(name, (name, {}))
        return dataclasses.replace(get_smoke_config(base),
                                   dtype=jnp.float32, **over)

    def placed(name, dist):
        cfg = config(name)
        return cfg, jax.device_put(
            jax.tree.map(jnp.asarray, inp[name]),
            jax.tree.map(ns, zoo.param_specs(cfg, dist), is_leaf=is_p))

    def decode(name, dist, rows):
        cfg, params = placed(name, dist)
        b = dist.batch
        tokens = jax.device_put(jnp.asarray(
            batch_np(cfg, rows, DEC_L)["tokens"]), ns(P(b, None)))
        _, cache = jax.jit(lambda p, t: zoo.prefill(
            cfg, p, {"tokens": t}, DEC_MAX, dist))(params, tokens)
        step = jax.jit(lambda p, t, c: zoo.decode_step(cfg, p, t, c, dist))
        logits = []
        for t in decode_tokens_np(cfg, rows):
            lg, cache = step(params, jax.device_put(jnp.asarray(t),
                                                    ns(P(b, None))), cache)
            logits.append(np.asarray(lg))
        return {"logits": logits,
                "cache": {k: np.asarray(cache[k]) for k in ("k", "v",
                                                            "len")}}

    dist = Dist(mesh, batch_axes=("data",))
    res = {"llama": decode("llama3.2-1b", dist, DEC_B)}
    cfg, params = placed("qwen6", dist)
    bnp = MC.batch_np(cfg)
    bsp = {"tokens": P("data", None), "labels": P("data", None)}
    batch = {k: jax.device_put(jnp.asarray(v), ns(bsp[k]))
             for k, v in bnp.items()}
    def cases(p, b):
        serve = {k: v for k, v in b.items() if k != "labels"}
        last, cache = zoo.prefill(cfg, p, serve, MC.MAX_LEN, dist)
        loss, grads = jax.value_and_grad(
            lambda p: zoo.loss_fn(cfg, p, b, dist))(p)
        return {"logits": zoo.forward(cfg, p, b, dist)[0],
                "prefill_logits": last, "cache_k": cache["k"],
                "cache_v": cache["v"], "cache_len": cache["len"],
                "loss": loss, "grads": grads}
    res["qwen6"] = jax.tree.map(np.asarray, jax.jit(cases)(params, batch))
    cfg, params = placed("llama3.2-1b", dist)
    eng = ServeEngine(cfg, params, slots=SERVE["slots"],
                      max_len=SERVE["max_len"], dist=dist)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=SERVE["max_new"],
                    eos_id=-1) for i, p in enumerate(serve_prompts(cfg))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    res["serve"] = [r.out_tokens for r in reqs]
    if shape == (2, 2):
        res["long"] = decode("llama_mqa", Dist(mesh, batch_axes=(),
                                               seq_shard=True), 1)
    pickle.dump(res, open(sys.argv[2], "wb"))
    print("REFERENCE OK")
''')


def _params(name):
    base, over = VARIANTS.get(name, (name, {}))
    cfg = dataclasses.replace(j_smoke(base), dtype=jnp.float32, **over)
    return jax.tree.map(np.asarray,
                        jzoo.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def runs():
    """The reference's results and each rank spawn's (rank 0's)."""
    params = {n: _params(n) for n in NAMES}
    with tempfile.TemporaryDirectory(prefix="mesh-dec-") as tmp:
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
                spawns = {s: pool.submit(run_ranks, decode_rank, 4, s,
                                         params, timeout=RANK_TIMEOUT)
                          for s in SHAPES}
                chip = pool.submit(run_ranks, chip_rehearsal_rank, 1,
                                   timeout=RANK_TIMEOUT)
                port = {s: f.result()[0] for s, f in spawns.items()}
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
    return {"port": port, "ref": reference, "chip": rehearsal}


def _close(got, ref, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=1e-3,
                               atol=1e-3, err_msg=what)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


def _decode_matches(got, ref):
    assert len(got["logits"]) == len(ref["logits"]) == 8
    for i, (g, r) in enumerate(zip(got["logits"], ref["logits"])):
        _close(g, r, f"decode step {i}")
    for key in ("k", "v"):
        _close(got["cache"][key], ref["cache"][key], f"cache {key}")
    np.testing.assert_array_equal(got["cache"]["len"], ref["cache"]["len"])
    assert got["cache_placed"], got["cache_spec"]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_matches_reference_mesh(runs, shape):
    """llama's 8 decode steps under the mesh: on (1, 4) over the cache
    split by sequence (K2's stats merged across the 4 slices), on (2, 2)
    over the cache split by heads."""
    got = runs["port"][shape]["llama"]
    _decode_matches(got, runs["ref"][shape]["llama"])
    want = {(1, 4): "P(None, 'data', 'model', None, None)",
            (2, 2): "P(None, 'data', None, 'model', None)"}[shape]
    assert got["cache_spec"] == want


def test_long_context_decode_splits_both_axes(runs):
    """B = 1 with one KV head on (2, 2): the cache split by sequence over
    ('data', 'model'), 4 slices merged in mesh order."""
    got = runs["port"][(2, 2)]["long"]
    _decode_matches(got, runs["ref"][(2, 2)]["long"])
    assert got["cache_spec"] == "P(None, None, ('data', 'model'), None, None)"


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_heads_not_dividing_model_match_reference(runs, shape):
    """qwen6's 6 q heads: on (1, 4) two groups of 3 heads, each attended
    by 2 shards that keep their halves of the output; on (2, 2) the heads
    divide.  Forward, prefill, loss and every gradient as the
    reference's."""
    got = runs["port"][shape]["qwen6"]
    ref = runs["ref"][shape]["qwen6"]
    for key in ("logits", "prefill_logits", "cache_k", "cache_v"):
        _close(got[key], ref[key], key)
    assert abs(float(got["loss"]) - float(ref["loss"])) <= \
        1e-4 * abs(float(ref["loss"]))
    for (name, g), (_, r) in zip(_leaves(got["grads"]),
                                 _leaves(ref["grads"])):
        assert np.abs(g - r).max() <= 1e-3 * float(np.abs(r).max()) + \
            1e-5, name


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_serve_engine_under_mesh_matches_reference(runs, shape):
    got = runs["port"][shape]["serve"]
    assert got == runs["ref"][shape]["serve"]
    assert all(len(t) == 6 for t in got)


# ------------------------------------------- K2's stats merged across slices
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slices", [1, 2, 4, 16])
def test_combined_slices_match_pallas_on_whole_cache(dtype, slices):
    """The cache cut into ``slices`` slices, some wholly past ``kv_len``:
    each slice's plain partials with stats (the CPU side of
    ``flash_attention(..., return_stats=True)``), merged by
    ``combine_decode_partials``, against the reference's kernel in
    interpret mode on the whole cache; a row with no live key is exactly
    0."""
    B, Hq, Hkv, D, S = 4, 8, 2, 64, 512
    rng = np.random.default_rng(slices)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in (
        (B, Hq, 1, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    kv_len = np.array([0, 1, 200, S], np.int32)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    w = S // slices
    outs, Ms, Ls = [], [], []
    for i in range(slices):
        kl = torch.from_numpy(np.clip(kv_len - i * w, 0, w).astype(np.int32))
        o, M, L = flash_attention(tq, tk[:, :, i * w:(i + 1) * w],
                                  tv[:, :, i * w:(i + 1) * w], kl,
                                  causal=False, return_stats=True)
        assert o.dtype == M.dtype == L.dtype == torch.float32
        outs.append(o)
        Ms.append(M)
        Ls.append(L)
    got = combine_decode_partials(outs, Ms, Ls)
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)]
    ref = j_flash(*jx, jnp.asarray(kv_len), causal=False, bq=64, bkv=64,
                  interpret=True)
    tol = 2e-5 if dtype == "float32" else 2e-2 * float(
        np.abs(np.asarray(ref, np.float32)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


def test_stats_of_one_slice_are_the_split_decode():
    """With one slice the stats entry's output is the split decode's own
    (the kernel's mirror), in fp32: merging does nothing to it; a row
    with no live key has M = -inf, L = 0."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((3, 4, 1, 32), (3, 2, 300, 32), (3, 2, 300, 32)))
    kl = torch.tensor([0, 77, 300], dtype=torch.int32)
    o, M, L = flash_decode_split_plain(q, k, v, kl, decode_split(32,
                                                                 q.dtype),
                                       causal=False, return_stats=True)
    whole = flash_decode_split_plain(q, k, v, kl, decode_split(32, q.dtype),
                                     causal=False)
    assert torch.equal(o, whole)
    assert torch.equal(combine_decode_partials([o], [M], [L]), o)
    assert bool((M[0] == float("-inf")).all()) and bool((L[0] == 0).all())


def test_chip_smoke_stats_and_mesh_serving_phases_run_on_cpu(runs):
    """``chip_smoke.py``'s kernels_decode_stats (full width), mesh_serve
    and mesh_families (smoke widths) on a 1x1 gloo mesh behind counting
    stand-ins for K2: every check of the phases holds, with the launch
    counts the card run requires."""
    rec = {r["phase"]: r for r in runs["chip"]["records"]}
    assert set(rec) == {"kernels_decode_stats", "mesh_serve",
                        "mesh_families"}
    rows = rec["kernels_decode_stats"]["rows"]
    assert len(rows) == 3 * 4 and all(r["bitwise_equal"] for r in rows)
    assert all(r["max_abs_err"] <= r["tol"] for r in rows)
    serve = rec["mesh_serve"]
    assert serve["tokens_bit_equal"] and serve["tick_logits_bit_equal"]
    L = 2                                     # the smoke llama's layers
    assert runs["chip"]["launched"]["mesh_serve"] == {
        "prefill_tc": L * serve["prefills"], "decode": L * serve["ticks"]}
    assert serve["k2_stats_launches"] == 0
    fams = rec["mesh_families"]["archs"]
    assert set(fams) == {"zamba2-1.2b", "xlstm-1.3b", "seamless-m4t-medium"}
    assert all(f["serve_bit_equal"] and f["train_bit_equal"]
               for f in fams.values())
    assert not fams["xlstm-1.3b"]["k2_launches"]["serve"]
