"""Multi-pod dry-run: every (architecture x input shape) cell laid out on
the production mesh and run once over a fake process group, with
per-device memory, FLOPs, HBM bytes, collective bytes and the three-term
roofline in an H100's terms.  The counterpart of ``repro.launch.dryrun``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k [--multi-pod] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun \
      --cells llama3.2-1b:train_4k,deepseek-moe-16b:prefill_32k

Each cell writes <out>/<mesh>/<arch>__<shape>.json with the reference's
keys (``status``, ``devices``, ``memory``, ``cost``, ``roofline``).

How it counts.  The process joins a fake process group of 256 (pod16x16)
or 512 (pod2x16x16) ranks as rank 0 and builds the production
``DeviceMesh`` over it; its collectives move nothing.  Parameters, optimizer
state and inputs are DTensors whose local shards are fake tensors (shapes
and dtypes, no storage: kimi's 2 TB of weights never exist), laid out by
the specs as the reference lays them out.  The cell's program (the train
step, or the prefill) then runs eagerly, layer by layer at full depth,
under a dispatch mode that sees each operation on rank 0's local shards:

  * FLOPs: ``torch.utils.flop_counter``'s formulas (the matrix products)
    on the local shapes; compute replicated over an axis (the router, a
    gathered KV) counts on every device;
  * HBM bytes: each non-view operation's input and output bytes, unfused,
    so an upper bound on a fused program (the record's ``notes`` say so);
  * collectives: each ``_c10d_functional`` operation's kind, buffer and
    group size, through the reference's ring model (``hlo._wire_bytes``);
  * memory: the bytes of live storages, arguments included, and their
    peak (weakref finalizers on the storages; torch's ``MemTracker`` would
    also count the propagation's global-shape tensors below).  Argument
    bytes and the peak count only the arguments an operation reads or the
    program returns, as XLA's do (an unused argument is dropped): a
    decode step reads no encoder weight.

DTensor's sharding propagation runs some operations at the global shapes to
learn the output's shape; those are not counted.  Attention counts the
plain path's FLOPs (``common.attention_any`` on the CPU: every KV chunk,
masked or not, as the reference's chunked attention computes them), not
K2's, which skips the masked blocks on the card.  There is no HLO and no
extrapolation: the reference's ``--keep-hlo`` and ``--no-exact`` have no
counterpart (``launch/analysis.py`` corrects XLA's count of a scanned body,
and the port's layer loop is not scanned).

A dimension split over several mesh axes is split in the mesh's order:
kimi's FSDP over ("data", "pod") becomes pod-major, the reference's
data-major; the shard sizes and the collectives' groups are the same.

A decode cell runs one ``decode_step`` against a cache filled to the
shape's length (``configs.input_specs``), laid out by ``cache_specs``; the
cell's arguments are the weights, the tokens and the cache.  Each record
names the ``torch`` version that counted it (``torch``): DTensor chooses
its redistributions by version.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch

from repro_torch import models as zoo
from repro_torch.configs import ARCHS, get_config, input_specs, skip_reason
from repro_torch.launch.hlo import (HARDWARE, collective, model_flops_for,
                                    roofline)
from repro_torch.launch.mesh import batch_axes_of, make_production_mesh
from repro_torch.launch.sharding import (batch_dim_spec,
                                         input_sharding_specs)
from repro_torch.models.common import SHAPES, Dist, P, placements, spec_axes
from repro_torch.train import optim
from repro_torch.train.step import _split_placed, make_train_step

NOTES = ("per device, rank 0's shards; FLOPs: matrix products only; "
         "hbm_bytes: every non-view op's inputs and outputs, unfused (an "
         "upper bound); attention: the plain path's FLOPs, every KV chunk")

_C10D_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def build_dist(mesh, cfg, shape) -> Dist:
    axes = batch_axes_of(mesh)
    fsdp = (("data", "pod") if (cfg.fsdp_over_pod
                                and "pod" in mesh.mesh_dim_names) else ())
    probe = Dist(mesh, batch_axes=axes, fsdp_axes=fsdp)
    if batch_dim_spec(shape.global_batch, probe) is None:
        return Dist(mesh, batch_axes=(), seq_shard=True, fsdp_axes=fsdp)
    return probe


def strip_fsdp(spec):
    """``spec`` without its 'data'/'pod' entries (serving keeps weights TP
    sharded only)."""
    clean = []
    for entry in spec:
        kept = tuple(a for a in spec_axes(entry) if a not in ("data", "pod"))
        clean.append(None if not kept else kept[0] if len(kept) == 1
                     else kept)
    return P(*clean)


def _local_shape(shape, pls, mesh):
    out = list(shape)
    for i, pl in enumerate(pls):
        if pl.is_shard():
            n = mesh.size(i)
            if out[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not "
                                 f"divide over {n}")
            out[pl.dim] //= n
    return out


def _placed(meta, spec, mesh, dtype=None):
    """A DTensor of ``meta``'s global shape laid out by ``spec``, whose
    local shard is a tensor of the current (fake) mode."""
    from torch.distributed.tensor import DTensor
    pls = placements(spec, mesh)
    local = torch.empty(_local_shape(meta.shape, pls, mesh),
                        dtype=dtype or meta.dtype)
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=meta.shape, stride=meta.stride())


class _Counter:
    """The dispatch mode that counts one device's work (module
    docstring).  Built lazily: ``torch.utils._python_dispatch`` is imported
    only when a cell runs."""

    def __new__(cls):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_flatten
        from torch.utils.flop_counter import flop_registry

        class Counter(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.flops = 0
                self.hbm = 0
                self.colls = []
                self.live = 0
                self.peak = 0
                self.seen = set()
                self.read = set()      # storages an operation took in
                self.meta_depth = 0

            def track(self, t):
                """Count ``t``'s storage live until it is freed."""
                st = t.untyped_storage()
                key = st._cdata
                if key in self.seen:
                    return
                self.seen.add(key)
                n = st.nbytes()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, key, n)

            def repeat(self, before, times: int):
                """Count the work since ``before`` ``times`` times."""
                flops, hbm, n = before
                self.flops += (times - 1) * (self.flops - flops)
                self.hbm += (times - 1) * (self.hbm - hbm)
                self.colls += (times - 1) * self.colls[n:]

            def _free(self, key, n):
                self.seen.discard(key)
                self.live -= n

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                flat, _ = tree_flatten((args, kwargs))
                if any(isinstance(a, DTensor) for a in flat):
                    return NotImplemented
                out = func(*args, **kwargs)
                if self.meta_depth:
                    return out
                name = func._schema.name
                rets = func._schema.returns
                view = rets and all(r.alias_info is not None
                                    and not r.alias_info.is_write
                                    for r in rets)
                if not view and not name.startswith("prim::"):
                    self.read.update(a.untyped_storage()._cdata
                                     for a in flat
                                     if isinstance(a, torch.Tensor))
                if name.startswith("_c10d_functional::"):
                    self._collective(name.split("::")[1], func, args, out)
                    return out
                outs = [o for o in tree_flatten(out)[0]
                        if isinstance(o, torch.Tensor)]
                for o in outs:
                    self.track(o)
                pk = func._overloadpacket
                if pk in flop_registry:
                    self.flops += flop_registry[pk](*args, **kwargs,
                                                    out_val=out)
                if not view and not name.startswith(("aten::empty",
                                                     "prim::")):
                    self.hbm += sum(t.numel() * t.element_size()
                                    for t in flat + outs
                                    if isinstance(t, torch.Tensor))
                return out

            def _collective(self, op, func, args, out):
                if op == "wait_tensor":
                    return
                kind = _C10D_KIND.get(op)
                if kind is None:
                    raise NotImplementedError(
                        f"dry-run: no byte model for collective {op}")
                from torch.distributed.distributed_c10d import \
                    _resolve_process_group
                group = _resolve_process_group(args[-1]).size()
                if kind in ("all-gather", "reduce-scatter"):
                    buf = out.numel() * out.element_size()
                else:
                    buf = args[0].numel() * args[0].element_size()
                self.colls.append(collective(kind, buf, group))

        counter = Counter()
        name = "_propagate_tensor_meta_non_cached"
        if not hasattr(ShardingPropagator, name):
            raise RuntimeError(
                "dry-run: this torch's DTensor has no "
                f"ShardingPropagator.{name}; its global-shape propagation "
                "could not be told from the local work")
        inner = getattr(ShardingPropagator, name)

        def propagate(self, *a, **k):
            counter.meta_depth += 1
            try:
                return inner(self, *a, **k)
            finally:
                counter.meta_depth -= 1
        counter.restore = lambda: setattr(ShardingPropagator, name, inner)
        setattr(ShardingPropagator, name, propagate)
        return counter


def _program(cfg, shape, dist):
    """The cell's arguments (laid out, fake) and the function of them."""
    mesh = dist.mesh
    serving = shape.kind != "train"
    pspecs = zoo.param_specs(cfg, dist)
    tp_weight_bytes = cfg.params_count() * 2 / dist.size(dist.model_axis)
    if serving and tp_weight_bytes <= 8 * 2**30:
        # Serving keeps weights TP-sharded but not FSDP-sharded, except at
        # 1 T parameters (kimi), where expert shards must stay sharded.
        pspecs = optim.tree_map(strip_fsdp, pspecs)
    # Serving runs on bf16 weights (fp32 masters are a training concern).
    wdt = torch.bfloat16 if serving else None
    if cfg.family in ("dense", "moe", "vlm"):
        meta = zoo.transformer.abstract_params(cfg)
    else:                  # drawn under the caller's fake mode: no storage
        meta = zoo.init_params(cfg, device="meta")
    params = optim.tree_map(
        lambda m, s: _placed(m, s, mesh, wdt if m.dtype == torch.float32
                             else None), meta, pspecs)
    in_specs = input_sharding_specs(cfg, shape, dist)
    metas = input_specs(cfg, shape)
    if shape.kind == "decode":
        tokens = _placed(metas["tokens"], in_specs["tokens"], mesh)
        cache = {k: _placed(v, in_specs["cache"][k], mesh)
                 for k, v in metas["cache"].items()}
        return (params, tokens, cache), [(1, lambda: zoo.decode_step(
            cfg, params, tokens, cache, dist))]
    batch = {k: _placed(v, in_specs[k], mesh) for k, v in metas.items()}
    if shape.kind == "train":
        opt, phases = _train_phases(cfg, shape, dist, params, batch)
        return (params, opt, batch), phases
    return (params, batch), [(1, lambda: zoo.prefill(
        cfg, params, batch, shape.seq_len, dist))]


def _train_phases(cfg, shape, dist, params, batch):
    """The train step (``train.step.make_train_step`` with the config's
    microbatches) as three phases, each ``(times, fn)``: the batch split
    into M microbatches, one microbatch's loss and gradients accumulated
    into the fp32 (Lion: bf16) sum, counted M times (the M microbatches
    have the same shapes, so they do the same work), and the optimizer's
    update.  Returns (the optimizer state, an argument, and the phases)."""
    opt_cfg = optim.for_model(cfg)
    opt = optim.init_opt_state(opt_cfg, params)
    M = cfg.train_microbatches or shape.microbatches
    acc_dtype = torch.bfloat16 if opt_cfg.name == "lion" else torch.float32
    grads_of = make_train_step(cfg, opt_cfg, dist=dist).grads_of
    state = {}

    def split():
        state["acc"] = optim.tree_map(
            lambda p: torch.zeros_like(p, dtype=acc_dtype), params)
        state["mb"] = ({k: _split_placed(x, M, dist)[0]
                        for k, x in batch.items()} if M > 1 else batch)

    def micro():
        _, grads = grads_of(params, state["mb"])
        state["acc"] = optim.tree_map(
            lambda a, g: (a.float() + g.float() / M).to(acc_dtype),
            state["acc"], grads)

    def update():
        return optim.apply_updates(opt_cfg, params, state.pop("acc"), opt)
    return opt, [(1, split), (M, micro), (1, update)]


def _locals(tree):
    """The local tensors (a DTensor's shard) of a tree of dicts, tuples and
    lists."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _locals(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _locals(v)]
    if isinstance(tree, torch.Tensor):
        return [tree.to_local() if hasattr(tree, "to_local") else tree]
    return []


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _slstm_scan_at_once(cfg, pre, r, state=None):
    """The dry-run's stand-in for ``xlstm._slstm_scan``: the recurrence's
    products and shapes without its L sequential steps.  Under fake
    tensors no value is computed, so the L steps' recurrent products
    (h_t @ r, per head) are one einsum over L stand-in states, with the
    same FLOPs, and the gates' elementwise work runs once over (B, L, H,
    P).  L Python steps at a time on fake tensors took over 20 minutes for
    xlstm-1.3b's ``train_4k`` (the reference corrects its scanned sLSTM
    the same way, analytically: ``launch/analysis.py``)."""
    Bz, L, d = pre.shape[0], pre.shape[1], pre.shape[2] // 4
    H = cfg.n_heads
    P = d // H
    pre = pre.reshape(Bz, L, H, 4 * P)
    hs = pre[..., :P]                       # L states, (B, L, H, P)
    g = pre + torch.einsum("blhp,hpq->blhq", hs, r.float())
    z_, i_, f_, o_ = g.chunk(4, dim=-1)
    logf = torch.nn.functional.logsigmoid(f_)
    m = torch.maximum(logf, i_)
    c = torch.exp(logf - m) + torch.exp(i_ - m) * torch.tanh(z_)
    n = torch.exp(logf - m) + torch.exp(i_ - m)
    h = torch.sigmoid(o_) * c / torch.clamp(n, min=1e-6)
    last = tuple(t[:, -1] for t in (h, c, n, m))
    return h.reshape(Bz, L, d), last


def measure(cfg, shape, mesh) -> dict:
    """Run the cell's program once on ``mesh`` (over the current process
    group) under fake tensors; returns the record's measured part."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    dist = build_dist(mesh, cfg, shape)
    if _get_current_dispatch_mode_stack():
        raise RuntimeError("dry-run: another dispatch mode is active")
    from repro_torch.models import xlstm
    scan, xlstm._slstm_scan = xlstm._slstm_scan, _slstm_scan_at_once
    try:
        return _measure(cfg, shape, mesh, dist)
    finally:
        xlstm._slstm_scan = scan


def _measure(cfg, shape, mesh, dist) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        args, phases = _program(cfg, shape, dist)
        counter = _Counter()
        try:
            for t in _locals(args):
                counter.track(t)
            t0 = time.time()
            grad = torch.enable_grad() if shape.kind == "train" else \
                torch.no_grad()
            with counter, grad:
                for times, fn in phases:
                    before = (counter.flops, counter.hbm, len(counter.colls))
                    outputs = fn()
                    counter.repeat(before, times)
            run_s = time.time() - t0
        finally:
            counter.restore()
        # The arguments the program reads or returns: XLA drops the others
        # (jit's keep_unused=False; a decode step reads no encoder
        # weight), and they stay live, untouched, for the whole run.
        used = counter.read | {t.untyped_storage()._cdata
                               for t in _locals(outputs)}
        arg_bytes = _nbytes(t for t in _locals(args)
                            if t.untyped_storage()._cdata in used)
        unused = _nbytes(_locals(args)) - arg_bytes
        out_bytes = _nbytes(_locals(outputs))
        held = {t.untyped_storage()._cdata for t in _locals(args)}
        alias = _nbytes(t for t in _locals(outputs)
                        if t.untyped_storage()._cdata in held)
    devices = mesh.size()
    rf = roofline(counter.flops, counter.hbm, counter.colls, devices,
                  model_flops_for(cfg, shape))
    return {
        "run_s": round(run_s, 1),
        "devices": devices,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": counter.peak - unused - arg_bytes,
            "alias_bytes": alias,
            "unused_argument_bytes": unused,
            "peak_estimate_bytes": counter.peak - unused,
        },
        "cost": {"flops": float(counter.flops),
                 "bytes accessed": float(counter.hbm)},
        "collective_ops": _count_kinds(counter.colls),
        "roofline": rf.as_dict(),
        "hardware": HARDWARE,
        "torch": torch.__version__,
        "notes": NOTES,
    }


def _count_kinds(colls) -> dict:
    out = {}
    for c in colls:
        out[c.kind] = out.get(c.kind, 0) + 1
    return out


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str) -> dict:
    skip = skip_reason(arch, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if skip:
        rec.update({"status": "skipped", "reason": skip})
        return rec
    try:
        cfg = get_config(arch)
        shape = SHAPES[shape_name]
        rec.update({"status": "ok", **measure(cfg, shape, mesh)})
    except Exception as e:                                 # noqa: BLE001
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    return rec


def join_fake_group(world: int) -> None:
    """Join a fake process group of ``world`` ranks as rank 0 (no
    communication: every collective returns at once)."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if tdist.is_initialized():
        raise RuntimeError("dry-run: a process group is already initialised")
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=world)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cells", default=None,
                    help="arch:shape,... (cells run in one process)")
    ap.add_argument("--out", default="benchmarks/artifacts_torch")
    args = ap.parse_args(argv)

    mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"
    os.makedirs(os.path.join(args.out, mesh_name), exist_ok=True)
    archs = list(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    cells = [(a, s) for a in archs for s in shapes]
    if args.cells:
        cells = [tuple(c.split(":")) for c in args.cells.split(",")]

    join_fake_group(512 if args.multi_pod else 256)
    mesh = make_production_mesh(multi_pod=args.multi_pod, device_type="cpu")
    ok = skipped = failed = 0
    for arch, shape in cells:
        rec = run_cell(arch, shape, mesh, mesh_name)
        path = os.path.join(args.out, mesh_name, f"{arch}__{shape}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        st = rec["status"]
        ok += st == "ok"
        skipped += st == "skipped"
        failed += st == "error"
        extra = ""
        if st == "ok":
            pk = rec["memory"]["peak_estimate_bytes"] / 2**30
            extra = (f" peak={pk:.2f}GiB/dev "
                     f"bottleneck={rec['roofline']['bottleneck']}")
        if st == "error":
            extra = " " + rec["error"][:160]
        print(f"[{st:7s}] {arch:22s} {shape:12s} {mesh_name}{extra}",
              flush=True)
    print(f"\ndry-run {mesh_name}: {ok} ok, {skipped} skipped, "
          f"{failed} failed")
    return 0 if failed == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
