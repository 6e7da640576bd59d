"""Port LM (dense transformer) vs the JAX reference on the same weights:
norm and rope blocks, forward, bucketed prefill and a run of decode steps
(logits and caches), parameter layout and the config registry."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jz  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro_torch import models as tz  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

TOL = 1e-5                                   # fp32, another summation order
DENSE = ["llama3.2-1b", "qwen2.5-32b", "yi-9b", "phi3-mini-3.8b"]


def _configs(arch):
    jcfg = dataclasses.replace(j_get_smoke(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(registry.get_smoke_config(arch),
                               dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=["llama3.2-1b", "qwen2.5-32b"])
def pair(request):
    """Smoke configs in fp32 (as tests/test_serve.py) and the reference's
    weights carried across.  qwen covers the QKV bias and untied unembed."""
    jcfg, tcfg = _configs(request.param)
    jp = jz.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TT.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=tol,
                               atol=tol)


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    g = rng.normal(size=(64,)).astype(np.float32)
    ref = JC.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5)
    _close(TC.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-5), ref)


@pytest.mark.parametrize("hd,theta", [(8, 1e6), (64, 5e5), (96, 1e4)])
def test_rope_matches_reference(hd, theta):
    rng = np.random.default_rng(hd)
    pos = rng.integers(0, 2048, size=(3, 7)).astype(np.int32)
    jc, js = JC.rope_tables(jnp.asarray(pos), hd, theta)
    tc, ts = TC.rope_tables(torch.from_numpy(pos), hd, theta)
    _close(tc, jc, 2e-4)          # angles up to 2048 rad: fp32 sin/cos ulps
    _close(ts, js, 2e-4)
    x = rng.normal(size=(3, 7, 4, hd)).astype(np.float32)
    ref = JC.apply_rope(jnp.asarray(x), jc[:, :, None, :], js[:, :, None, :])
    out = TC.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(jc))[
        :, :, None, :], torch.from_numpy(np.array(js))[:, :, None, :])
    _close(out, ref)


def test_forward_matches_reference(pair):
    jcfg, jp, tcfg, tp = pair
    tok = np.random.default_rng(0).integers(1, 500, size=(2, 13))
    ref, _ = jz.forward(jcfg, jp, {"tokens": jnp.asarray(tok, jnp.int32)})
    out, aux = tz.forward(tcfg, tp, {"tokens": torch.from_numpy(tok)})
    assert out.shape == ref.shape and aux == 0.0
    _close(out, ref)


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


def test_decode_writes_the_cache_in_place(pair):
    _, _, tcfg, tp = pair
    cache = tz.init_cache(tcfg, 2, 8, device="cpu")
    k_before = cache["k"]
    _, out = tz.decode_step(tcfg, tp, torch.tensor([[3], [4]]), cache)
    assert out["k"] is k_before and out["len"].tolist() == [1, 1]
    assert k_before[:, :, 0].abs().sum() > 0 and k_before[:, :, 1:].abs().sum() == 0


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
            assert t.dtype == torch.float32
    # Same per-shape scales as the reference's _stack_init / dense_init.
    assert float(own["embed"].std()) == pytest.approx(0.02, rel=0.1)
    assert float(own["layers"]["wq"].std()) == pytest.approx(
        tcfg.d_model ** -0.5, rel=0.1)
    assert torch.equal(own["layers"]["ln1"], torch.ones_like(own["layers"]["ln1"]))


@pytest.mark.parametrize("arch", DENSE)
def test_registry_configs_equal_reference(arch):
    for get_t, get_j in ((registry.get_config, j_get_config),
                         (registry.get_smoke_config, j_get_smoke)):
        t, j = get_t(arch), get_j(arch)
        tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
        jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
        assert tf.pop("dtype") == torch.bfloat16 and tf.pop("param_dtype") == torch.float32
        jf.pop("dtype"), jf.pop("param_dtype")
        assert tf == jf
        assert (t.hd, t.group, t.params_count()) == (j.hd, j.group,
                                                     j.params_count())


def test_unported_families_name_their_slice():
    for arch, family in registry.QUEUED.items():
        assert j_get_config(arch).family == family
        with pytest.raises(NotImplementedError, match=f"family '{family}'.*"
                           "slice"):
            registry.get_config(arch)
    moe = dataclasses.replace(registry.get_smoke_config("llama3.2-1b"),
                              family="moe")
    with pytest.raises(NotImplementedError, match="MoE"):
        tz.init_params(moe, device="cpu")
    with pytest.raises(KeyError):
        registry.get_config("gpt-2")
