"""The mesh path's plain data against the reference, in this process: every
family's ``param_specs``, the input and cache specs of every applicable
cell, the optimizer state's specs, their divisibility on 2x16x16, the
registry's cells and input stand-ins, the wire-bytes model and the 6ND
FLOPs, and the placements a spec maps to.

The reference's ``param_specs`` read only axis names (``Dist(None,
...)``, as ``tests/test_launch.py`` takes them); its ``batch_dim_spec``,
``input_sharding_specs`` and ``cache_specs`` read only the mesh's sizes
and axis names, so a stand-in of the production mesh's sizes serves both
packages (no 256-device process)."""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import models as jzoo  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.launch import hlo as jhlo  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models.common import SHAPES as JSHAPES  # noqa: E402
from repro.models.transformer import Dist as JDist  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch import models as zoo  # noqa: E402
from repro_torch.configs import registry as reg  # noqa: E402
from repro_torch.launch import hlo, sharding  # noqa: E402
from repro_torch.launch.dryrun import build_dist, strip_fsdp  # noqa: E402
from repro_torch.models.common import SHAPES, Dist, P, placements  # noqa: E402
from repro_torch.models.transformer import abstract_params  # noqa: E402
from repro_torch.train import optim  # noqa: E402

ARCHS = sorted(reg.ARCHS)
SIZES = {"pod": 2, "data": 16, "model": 16}


class AbstractMesh:
    """A mesh's axis names and sizes with no process group behind it: what
    the port's specs read (``launch.sharding``, ``Dist.size``)."""

    def __init__(self, names):
        self.mesh_dim_names = tuple(names)
        self.ndim = len(names)

    def size(self, dim):
        return SIZES[self.mesh_dim_names[dim]]


def production_shape(multi_pod):
    return AbstractMesh(("pod", "data", "model") if multi_pod
                        else ("data", "model"))


def _norm(spec):
    """A spec's entries as plain tuples (either package's)."""
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def _flat(tree, is_spec, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], is_spec,
                                                       f"{prefix}{k}/")]
    if isinstance(tree, tuple) and not is_spec(tree) and hasattr(
            tree, "_fields"):
        return [x for f in tree._fields for x in _flat(
            getattr(tree, f), is_spec, f"{prefix}{f}/")]
    return [(prefix.rstrip("/"), _norm(tree))]


def _same(port_tree, ref_tree):
    got = _flat(port_tree, lambda t: isinstance(t, P))
    ref = _flat(ref_tree, lambda t: isinstance(t, JP))
    assert [n for n, _ in got] == [n for n, _ in ref]
    assert got == ref


def _ref_mesh(multi_pod):
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return types.SimpleNamespace(shape={a: SIZES[a] for a in names},
                                 axis_names=names)


def _dists(cfg, shape, multi_pod):
    """The dry-run's Dist on the production mesh, in both packages."""
    mesh = production_shape(multi_pod)
    d = build_dist(mesh, cfg, shape)
    rd = JDist(_ref_mesh(multi_pod), batch_axes=d.batch_axes,
               seq_shard=d.seq_shard, fsdp_axes=d.fsdp_axes)
    return d, rd


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("axes", [("data",), ("pod", "data")])
def test_param_specs_equal_reference(arch, axes):
    for fsdp in ((), ("data", "pod")):
        _same(zoo.param_specs(reg.get_config(arch),
                              Dist(None, batch_axes=axes, fsdp_axes=fsdp)),
              jzoo.param_specs(jreg.get_config(arch),
                               JDist(None, batch_axes=axes,
                                     fsdp_axes=fsdp)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_input_and_cache_specs_equal_reference(arch, multi_pod):
    cfg, rcfg = reg.get_config(arch), jreg.get_config(arch)
    for name in reg.applicable_shapes(arch):
        d, rd = _dists(cfg, SHAPES[name], multi_pod)
        assert sharding.batch_dim_spec(SHAPES[name].global_batch, d) == \
            jsharding.batch_dim_spec(JSHAPES[name].global_batch, rd)
        _same(sharding.input_sharding_specs(cfg, SHAPES[name], d),
              jsharding.input_sharding_specs(rcfg, JSHAPES[name], rd))
        _same(sharding.cache_specs(cfg, SHAPES[name], d),
              jsharding.cache_specs(rcfg, JSHAPES[name], rd))
    assert sharding.decode_cache_present_keys(cfg) == \
        jsharding.decode_cache_present_keys(rcfg)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", ["adamw", "lion"])
def test_opt_state_specs_equal_reference(arch, name):
    d = Dist(None, batch_axes=("pod", "data"))
    rd = JDist(None, batch_axes=("pod", "data"))
    _same(optim.opt_state_specs(optim.OptConfig(name=name),
                                zoo.param_specs(reg.get_config(arch), d)),
          joptim.opt_state_specs(joptim.OptConfig(name=name),
                                 jzoo.param_specs(jreg.get_config(arch),
                                                  rd)))


def _divides(spec, shape):
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n = int(np.prod([SIZES[a] for a in axes])) if axes else 1
        assert dim % n == 0, (spec, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_divide_on_two_pods(arch):
    """Every parameter's spec divides its dims on 2x16x16 (shapes from the
    reference's init, which the port's trees equal), and so do the specs
    of every applicable cell's inputs and caches."""
    cfg = reg.get_config(arch)
    rcfg = jreg.get_config(arch)
    shapes = jax.eval_shape(lambda: jzoo.init_params(
        rcfg, jax.random.PRNGKey(0)))
    specs = zoo.param_specs(cfg, Dist(None, batch_axes=("pod", "data")))
    flat_s = _flat(specs, lambda t: isinstance(t, P))
    flat_p = _flat(jax.tree.map(lambda s: s.shape, shapes),
                   lambda t: True)
    assert [n for n, _ in flat_s] == [n for n, _ in flat_p]
    for (_, spec), (_, shape) in zip(flat_s, flat_p):
        _divides(spec, shape)
    for name in reg.applicable_shapes(arch):
        d, _ = _dists(cfg, SHAPES[name], True)
        ins = reg.input_specs(cfg, SHAPES[name])
        specs = sharding.input_sharding_specs(cfg, SHAPES[name], d)
        for key, t in ins.items():
            if key == "cache":
                for ck, ct in t.items():
                    _divides(specs["cache"][ck], ct.shape)
            else:
                _divides(specs[key], t.shape)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2.5-32b",
                                  "deepseek-moe-16b", "kimi-k2-1t-a32b",
                                  "internvl2-2b"])
def test_abstract_params_match_init(arch):
    """The dry-run's meta tree has ``init_params``'s keys, shapes and
    dtypes (smoke width; the full trees' shapes are the reference's)."""
    cfg = reg.get_smoke_config(arch)
    real = zoo.init_params(cfg, device="cpu")
    meta = abstract_params(cfg)
    got = optim.named_leaves(meta)
    ref = optim.named_leaves(real)
    assert [(n, tuple(t.shape), t.dtype) for n, t in got] == \
        [(n, tuple(t.shape), t.dtype) for n, t in ref]
    assert all(t.device.type == "meta" for _, t in got)


def test_registry_cells_and_skips():
    # The same cells; the port's registry lists the archs in its own order.
    assert sorted(reg.all_cells()) == sorted(jreg.all_cells())
    cells = list(reg.all_cells())
    assert len(cells) == 40 and sum(1 for c in cells if c[2]) == 8
    for arch in ARCHS:
        assert reg.applicable_shapes(arch) == jreg.applicable_shapes(arch)
        for name in SHAPES:
            assert reg.skip_reason(arch, name) == jreg.skip_reason(arch,
                                                                   name)
            assert reg.frames_len(reg.get_config(arch), SHAPES[name]) == \
                jreg.frames_len(jreg.get_config(arch), JSHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch):
    cfg, rcfg = reg.get_config(arch), jreg.get_config(arch)
    for name in reg.applicable_shapes(arch):
        got = reg.input_specs(cfg, SHAPES[name])
        ref = jreg.input_specs(rcfg, JSHAPES[name])
        g = [(n, tuple(t.shape), str(t.dtype).split(".")[-1])
             for n, t in optim.named_leaves(got)]
        r = [(n, tuple(s.shape), str(s.dtype))
             for n, s in optim.named_leaves(ref)]
        assert g == r
        assert all(t.device.type == "meta" for _, t in
                   optim.named_leaves(got))


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute", "other"])
def test_wire_bytes_equal_reference(kind):
    for n in (1, 2, 16, 256):
        for buf in (0, 4096, 123457):
            assert hlo._wire_bytes(kind, buf, n) == \
                jhlo._wire_bytes(kind, buf, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(arch):
    for name in SHAPES:
        assert hlo.model_flops_for(reg.get_config(arch), SHAPES[name]) == \
            jhlo.model_flops_for(jreg.get_config(arch), JSHAPES[name])


def test_roofline_terms_and_bottleneck():
    colls = [hlo.collective("all-reduce", 1000, 4),
             hlo.collective("all-gather", 4000, 4)]
    r = hlo.roofline(2 * hlo.PEAK_FLOPS, hlo.HBM_BW, colls, 8,
                     model_flops=8.0 * hlo.PEAK_FLOPS)
    assert r.compute_s == 2.0 and r.memory_s == 1.0
    assert r.collectives == {"all-reduce": 1500.0, "all-gather": 3000.0}
    assert r.collective_s == 4500.0 / hlo.LINK_BW
    assert r.bottleneck == "compute" and r.useful_ratio == 0.5


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = production_shape(True)
    assert placements(P(("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert placements(P(None, "model"), mesh) == \
        [Replicate(), Replicate(), Shard(1)]
    # kimi's FSDP ("data", "pod"): split in the mesh's order, pod major.
    assert placements(P("model", ("data", "pod"), None), mesh) == \
        [Shard(1), Shard(1), Shard(0)]
    assert strip_fsdp(P(None, ("pod", "data"), "model")) == \
        P(None, None, "model")
    assert strip_fsdp(P(("data", "model"), None)) == P("model", None)


def test_meshed_families_run_under_a_mesh(tmp_path):
    """The hybrid, xLSTM and enc-dec families under a stand-in mesh (a 1x1
    gloo mesh in this process): each smoke forward runs and equals the
    mesh-free forward bit for bit."""
    import dataclasses
    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_debug_mesh, shard_tree
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                             rank=0, world_size=1)
    try:
        d = Dist(make_debug_mesh(1, 1, device_type="cpu"),
                 batch_axes=("data",))
        for arch in ("zamba2-1.2b", "xlstm-1.3b", "seamless-m4t-medium"):
            cfg = dataclasses.replace(reg.get_smoke_config(arch),
                                      dtype=torch.float32)
            params = zoo.init_params(cfg, device="cpu")
            gen = torch.Generator().manual_seed(0)
            batch = {"tokens": torch.randint(0, cfg.vocab, (2, 24),
                                             generator=gen)}
            if cfg.family == "encdec":
                batch["frames"] = torch.randn(
                    (2, cfg.frontend_len, cfg.frontend_dim), generator=gen)
            placed = shard_tree(params, zoo.param_specs(cfg, d), d.mesh)
            pbatch = {k: shard_tree(v, P("data", *([None] * (v.dim() - 1))),
                                    d.mesh) for k, v in batch.items()}
            with torch.no_grad():
                ref = zoo.forward(cfg, params, batch)[0]
                got = zoo.forward(cfg, placed, pbatch, d)[0]
            assert torch.equal(got.to_local(), ref), arch
    finally:
        tdist.destroy_process_group()
