#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

It builds the port's hand-written kernels from ``src/repro_torch/kernels/
csrc`` and drives the port's two paths: the GNN pipeline at the paper's full
widths, then LM serving on llama3.2-1b at its published width:

  device  the card's name, count and power limit (exit 1 without a card);
  build   nvcc for sm_90a, with the build seconds and each kernel's ptxas
          registers and spill bytes;
  kernels each kernel against its plain torch version at the main path's
          shapes and at small shape cases: max abs error, bitwise
          determinism, median CUDA-event times of the kernel, the plain
          version and one library call, and the bound from bytes and
          operations.  K1 (spmm_csr on the BSR's packed nonzeros) runs at
          SIoT d = 52 and 16 and Yelp d = 100, against both its plain
          version and the dense layout's; its rows add the device time per
          call (torch.profiler) of the kernel and the library call, which
          leaves out the host's time to enqueue them;
  bsp     the batched BSP forward (GCN, SAGE, GAT x ppermute, allgather) on
          SIoT (8001 vertices) and Yelp (3912), 8 partitions of a random
          layout, held against the whole-graph forward on the card and on
          the CPU; counts the kernel's launches per forward, the resident
          plan tensors and the forward's peak device memory;
  patch   a 2% relayout patched in place (0 rebuilds, output bit-equal to a
          fresh plan's; the host time of each model's first forward after
          it: GCN's repacks the plan, SAGE's shares that pack), then a
          capacity overflow (exactly 1 rebuild);
  serve   256 Zipf requests through the ego-serving engine over the live
          plan, held against the BSP forward's rows;
  kernels flash_attention against its plain torch version at the LM path's
          prefill (L = 512, 1024: the bf16 tensor-core kernel) and decode
          (cache strides, ragged kv_len: the split-key kernel) shapes, with
          the same error, determinism, time, device time and bound fields as
          K1 and scaled_dot_product_attention as the library call (at decode
          also over the cache cut to the longest live row); a decoded batch
          equals each row decoded alone, bit for bit; the split decode at
          every kv_len edge of its splits, f32 and bf16; the tensor-core
          prefill at D = 96 and 128; fp32 prefill (lm_parity's) on the
          general kernel at L = 128 and 512; the reference's 7 test cases
          and a fully masked row; each case that names a kernel is held
          to have launched it;
  lm_parity  llama3.2-1b at full width cut to 2 layers, fp32: prefill of two
          bucketed prompts and 8 greedy decode steps on the card (K2) and on
          the CPU (plain attention) agree, with n_layers launches per call;
  lm_serve   the full 16-layer bf16 llama3.2-1b behind ServeEngine (8 slots,
          2048 positions) serves 16 requests of 32 tokens; K2 launches
          16 x (prefills + ticks), every prefill's on the tensor-core
          kernel and every tick's on the split decode; two requests are
          re-scored by a teacher-forced forward; prefill and decode-tick
          times;
  lm_profile  torch.profiler over 4 decode ticks with 8 live slots: the
          device's busy share, kernel time by name and K2's device time
          per tick.

Each phase prints JSON lines.  Any failed check exits non-zero.  Before
the last line it prints the kernels summary and the ``nvidia-smi`` name and
power limit; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import models as lm  # noqa: E402
from repro_torch.configs import get_config, gnn_paper  # noqa: E402
from repro_torch.core import partition_from_assign, random_layout  # noqa: E402
from repro_torch.gnn import (  # noqa: E402
    GNNServeEngine, build_plan_bsr, compile_plan, directed_edges, forward,
    gather_outputs, init_params, make_bsp_forward, patch_plan, plans_equal,
    recompile_like, scatter_features, zipf_requests)
from repro_torch.graphs import DataGraph, synthetic_siot, synthetic_yelp  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    decode_split, flash_attention, flash_attention_plain, kernel_path)
from repro_torch.kernels.gnn_aggregate import (  # noqa: E402
    build_bsr, pack_bsr, spmm, spmm_packed, spmm_packed_plain, spmm_plain)
from repro_torch.serve import Request, ServeEngine  # noqa: E402

PARTS = 8
SLACK = 0.5
SEED = 0
FWD_TOL = 2e-4                 # the reference's own gate (test_distributed_gnn)
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, fp32 outside tensor
# cores, bf16 dense on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# K2 against its plain version: the reference's own tolerances
# (tests/test_kernels.py), rtol = atol.
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# lm_parity, card (K2) vs CPU (plain attention), fp32 at d_model 2048 and a
# 128256-entry vocab: the same arithmetic summed in other orders (cuBLAS vs
# the CPU's GEMMs, the kernel's online softmax vs the direct one).  1e-5 holds
# at the CPU tests' width 64; 2048-wide dot products and logits near 4 leave
# errors near 1e-5 here, so 1e-3 (rtol = atol) leaves room without hiding a
# wrong mask or a wrong head, which move logits by O(1).
LM_PARITY_TOL = 1e-3
# lm_serve: a served token must be the top logit of the teacher-forced row or
# within this of it.  Logits come out of bf16 GEMMs at |logit| ~ 4, where one
# bf16 ulp is 2**-5; serving (bucketed prefill, then one token per decode
# step) and teacher forcing (one pass) round at different places through 16
# layers.  8 ulps; a wrong token under random weights is ~4 below the top.
SERVE_GAP_TOL = 0.25
LLAMA_SLOTS = 8
LLAMA_MAX_LEN = 2048


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 25, warmup: int = 3, tries: int = 3):
    """Device time per call of ``fn``: the CUDA time ``torch.profiler``
    records over ``reps`` calls (kernels, copies and fills), divided by
    ``reps``.  Unlike :func:`time_ms` it leaves out the host's time to
    enqueue the call, which a kernel of a few microseconds can be shorter
    than.  A window whose device events are not a whole number per call
    lost some and is measured again, up to ``tries`` times.  "not
    measured" where no window holds a whole trace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev and all(e.count % reps == 0 for e in dev):
            return sum(e.self_device_time_total for e in dev) / 1e3 / reps
    return "not measured"


def allclose_err(out, ref, tol: float) -> float:
    """Largest |out - ref| beyond the rtol = atol = tol allowance (<= 0 means
    within tolerance)."""
    diff = (out - ref).abs() - tol * ref.abs()
    return float(diff.max()) if diff.numel() else 0.0


# ------------------------------------------------------------------ phases
def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false); this script runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=120)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi_line, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return kind, smi_line


def phase_build():
    res = _build.build()
    emit({"phase": "build", "seconds": res.seconds,
          "library": os.path.relpath(res.path),
          "ptxas": res.kernels()})


def make_dataset(name: str, dev):
    g = synthetic_siot() if name == "siot" else synthetic_yelp()
    assign = random_layout(g.n, PARTS, seed=SEED)
    t0 = time.perf_counter()
    plan = compile_plan(g, partition_from_assign(g, assign, PARTS, {}),
                        slack=SLACK)
    build_plan_bsr(plan)
    host_s = time.perf_counter() - t0
    b = plan.bsr
    emit({"phase": "plan", "dataset": name, "n": g.n, "links": g.num_edges,
          "parts": PARTS, "cap": plan.cap, "halo_cap": plan.halo_cap,
          "e_cap": plan.e_cap, "rounds": len(plan.rounds),
          "bsr_nb": b.nb, "bsr_max_blocks": b.max_blocks,
          "bsr_src_rows": b.src_rows, "values_mb": b.values.nbytes / 1e6,
          "nnz": int((b.values != 0).sum()),
          "nnz_density": float((b.values != 0).mean()),
          "host_compile_s": host_s})
    feats = torch.from_numpy(g.features).to(dev)
    sd = torch.from_numpy(directed_edges(g.edges)).to(dev)
    return {"name": name, "graph": g, "plan": plan, "feats": feats, "sd": sd}


def _random_graph(rng, n, extra):
    edges = [(rng.integers(0, v), v) for v in range(1, n)]
    for _ in range(extra):
        u, v = rng.integers(0, n, size=2)
        if u != v:
            edges.append((min(u, v), max(u, v)))
    return DataGraph(n=n, edges=np.array(edges))


def _library_csr(values: np.ndarray, cols: np.ndarray, src_rows: int, dev):
    """The batched block-diagonal adjacency of a BSR as one CSR tensor."""
    P, nbm, bm, bk = values.shape
    nb, maxb = cols.shape[1], cols.shape[2]
    p, blk, r, k = np.nonzero(values)
    i, j = blk // maxb, blk % maxb
    rows = p * (nb * bm) + i * bm + r
    cidx = p * src_rows + cols[p, i, j].astype(np.int64) * bk + k
    a = sp.csr_matrix((values[p, blk, r, k], (rows, cidx)),
                      shape=(P * nb * bm, P * src_rows))
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
        csr = torch.sparse_csr_tensor(
            torch.from_numpy(a.indptr.astype(np.int64)),
            torch.from_numpy(a.indices.astype(np.int64)),
            torch.from_numpy(a.data.astype(np.float32)),
            size=a.shape, device=dev, check_invariants=True)
    return csr, int(a.nnz)


def _require_close(label, out, ref, what):
    err = float((out - ref).abs().max()) if ref.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    require(err <= 1e-5 * scale + 1e-5,
            f"spmm_csr {label}: max abs err {err} vs {what} (scale {scale})")
    return err


def _check_k1(label, run, refs):
    """Two launches of K1 (``run``) against each plain version in ``refs``
    (name -> its result on the same inputs): bitwise equal to each other,
    each within 1e-5 * max|ref| + 1e-5.  Returns the output and the max abs
    error against each."""
    out, again = run(), run()
    torch.cuda.synchronize()
    require(torch.equal(out, again), f"spmm_csr {label}: not bitwise "
            "deterministic across two launches")
    return out, {name: _require_close(label, out, ref, name)
                 for name, ref in refs.items()}


def phase_kernels(datasets, dev):
    """K1 (spmm_csr on the packed BSR) against its plain versions; times at
    the main path's shapes: SIoT's two layer widths, Yelp's first."""
    gen = torch.Generator().manual_seed(SEED)
    results, worst = [], 0.0
    for ds, d in ((datasets[0], 52), (datasets[0], 16), (datasets[1], 100)):
        b, plan = ds["plan"].bsr, ds["plan"]
        t0 = time.perf_counter()
        host = pack_bsr(b.values, b.block_cols, b.bm, b.bk,
                        nnz_cap=plan.e_cap)
        pack_s = time.perf_counter() - t0
        packed = dataclasses.replace(host.to(dev), src_rows=b.src_rows)
        values = torch.from_numpy(b.values).to(dev)
        cols = torch.from_numpy(b.block_cols).to(dev)
        lib_a, nnz = _library_csr(b.values, b.block_cols, b.src_rows, dev)
        require(nnz == int(host.row_ptr[:, -1].sum()),
                f"{ds['name']}: packed nonzeros != the library CSR's {nnz}")
        feats = torch.randn((PARTS, b.src_rows, d), generator=gen).to(dev)
        label = f"{ds['name']}_P{PARTS}_d{d}"
        out, errs = _check_k1(label, lambda: spmm_packed(packed, feats), {
            "spmm_packed_plain": spmm_packed_plain(packed, feats),
            "spmm_plain": spmm_plain(values, cols, feats, b.bm, b.bk)})
        err, dense_err = errs["spmm_packed_plain"], errs["spmm_plain"]
        worst = max(worst, err, dense_err)
        flat = feats.reshape(PARTS * b.src_rows, d)
        lib_out = torch.sparse.mm(lib_a, flat).reshape(out.shape)
        lib_err = float((lib_out - out).abs().max())
        require(lib_err <= 1e-4 * float(out.abs().max()) + 1e-4,
                f"library product disagrees with spmm_csr: {lib_err}")
        # Bound: the bytes and operations these nonzeros need: each entry's
        # weight and column, the row pointers, each feature row that an
        # entry reads (once), the output (once).  The dense values' bytes
        # stay beside it as the earlier yardstick.
        live = (torch.arange(packed.nnz_cap, device=dev)[None, :]
                < packed.row_ptr[:, -1:])
        part = torch.arange(PARTS, device=dev)[:, None]
        rows_read = int(torch.unique(
            (part * b.src_rows + packed.col)[live]).numel())
        nbytes = (nnz * 8 + packed.row_ptr.numel() * 4 + rows_read * d * 4
                  + out.numel() * 4)
        ops = 2 * nnz * d
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        dense_bytes = (values.numel() * 4 + cols.numel() * 4
                       + feats.numel() * 4 + out.numel() * 4)
        counts = (packed.row_ptr[:, 1:] - packed.row_ptr[:, :-1])
        row = {
            "shape": label, "max_abs_err": err, "dense_max_abs_err": dense_err,
            "bitwise_equal": True,
            "ms": time_ms(lambda: spmm_packed(packed, feats)),
            "device_ms": device_ms(lambda: spmm_packed(packed, feats)),
            "plain_ms": time_ms(lambda: spmm_packed_plain(packed, feats)),
            "dense_plain_ms": time_ms(
                lambda: spmm_plain(values, cols, feats, b.bm, b.bk)),
            "library_ms": time_ms(lambda: torch.sparse.mm(lib_a, flat)),
            "library_device_ms": device_ms(
                lambda: torch.sparse.mm(lib_a, flat)),
            "library_call": "torch.sparse.mm(sparse_csr_tensor, feats)",
            "bytes": nbytes, "ops": ops, "nnz": nnz,
            "feature_rows_read": rows_read,
            "feature_rows": int(feats.shape[0] * feats.shape[1]),
            "max_row_nnz": int(counts.max()),
            "empty_rows": int((counts == 0).sum()),
            "rows": int(counts.numel()), "pack_s": pack_s,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "dense_values_bound_ms": max(dense_bytes / HBM_BYTES_PER_S * 1e3,
                                         t_ops),
        }
        row["faster_than_library"] = row["ms"] < row["library_ms"]
        row["faster_than_library_on_device"] = (
            isinstance(row["device_ms"], float)
            and isinstance(row["library_device_ms"], float)
            and row["device_ms"] < row["library_device_ms"])
        results.append(row)
        emit({"phase": "kernels", "kernel": "spmm_csr", **row})
        del values, cols
    # The reference's test shapes, a weighted case and a ragged d.
    rng = np.random.default_rng(SEED)
    for n, extra, bm, bk, d, weighted in [
            (40, 60, 8, 128, 128, False), (100, 200, 8, 128, 256, False),
            (17, 10, 16, 128, 128, False), (250, 500, 8, 256, 128, False),
            (30, 40, 8, 128, 128, True), (300, 600, 8, 128, 52, False)]:
        g = _random_graph(rng, n, extra)
        sd = directed_edges(g.edges)
        w = (rng.uniform(0.1, 2.0, size=len(sd)).astype(np.float32)
             if weighted else None)
        v, c, _, n_src = build_bsr(sd, w, n, bm, bk)
        feats = torch.from_numpy(
            rng.normal(size=(n_src, d)).astype(np.float32)).to(dev)
        label = f"n{n}_bm{bm}_bk{bk}_d{d}" + ("_weighted" if weighted else "")
        v, c = torch.from_numpy(v).to(dev), torch.from_numpy(c).to(dev)
        _, errs = _check_k1(label, lambda: spmm(v, c, feats, bm, bk), {
            "spmm_packed_plain": spmm_packed_plain(pack_bsr(v, c, bm, bk),
                                                   feats),
            "spmm_plain": spmm_plain(v, c, feats, bm, bk)})
        err = max(errs.values())
        worst = max(worst, err)
        emit({"phase": "kernels", "kernel": "spmm_csr", "shape": label,
              "max_abs_err": err, "bitwise_equal": True})
    return results, worst


def phase_bsp(datasets, dev):
    """Main path: the BSP forward at paper width, both exchanges."""
    params_of, blocks_ref = {}, {}
    for ds in datasets:
        g, plan = ds["graph"], ds["plan"]
        blocks = torch.from_numpy(scatter_features(plan, g.features)).to(dev)
        for model in ("gcn", "sage", "gat"):
            cfg = gnn_paper.ALL[(ds["name"], model)]
            params = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
            params_of[(ds["name"], model)] = params
            ref = forward(cfg, params, ds["feats"], ds["sd"])
            cpu_params = [{k: v.cpu() for k, v in p.items()} for p in params]
            ref_cpu = forward(cfg, cpu_params, ds["feats"].cpu(),
                              ds["sd"].cpu())
            cpu_err = allclose_err(ref.cpu(), ref_cpu, FWD_TOL)
            require(cpu_err <= FWD_TOL, f"{ds['name']} {model}: whole-graph "
                    f"forward on the card vs the CPU: {cpu_err}")
            blocks_ref[(ds["name"], model)] = ref
            for exchange in ("ppermute", "allgather"):
                fwd = make_bsp_forward(cfg, plan, exchange=exchange,
                                       device=dev)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                before = spmm.launches
                out = fwd(params, blocks)
                torch.cuda.synchronize()
                launched = spmm.launches - before
                peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
                resident = fwd.stats["ops"].t
                require("bsr_values" not in resident,
                        f"{ds['name']} {model}: dense BSR values resident")
                want = cfg.num_layers if model in ("gcn", "sage") else 0
                require(launched == want, f"{ds['name']} {model} {exchange}: "
                        f"{launched} spmm_csr launches, expected {want}")
                full = torch.from_numpy(
                    gather_outputs(plan, out.cpu().numpy(), g.n))
                err = allclose_err(full, ref.cpu(), FWD_TOL)
                require(err <= FWD_TOL, f"{ds['name']} {model} {exchange}: "
                        f"BSP forward vs whole-graph forward: {err}")
                ms = time_ms(lambda: fwd(params, blocks), reps=20)
                emit({"phase": "bsp", "dataset": ds["name"], "model": model,
                      "exchange": exchange, "aggregate": fwd.mode,
                      "spmm_launches": launched, "allclose_excess": err,
                      "max_abs_err": float((full - ref.cpu()).abs().max()),
                      "card_vs_cpu_excess": cpu_err, "forward_ms": ms,
                      "plan_tensor_mb": sum(t.numel() * t.element_size()
                                            for t in resident.values()) / 1e6,
                      "forward_peak_mb": peak_mb})
    return params_of, blocks_ref


def phase_patch(siot, params_of, dev):
    g, plan = siot["graph"], siot["plan"]
    fwds = {m: make_bsp_forward(gnn_paper.ALL[("siot", m)], plan,
                                exchange="ppermute", device=dev)
            for m in ("gcn", "sage")}
    for m, fwd in fwds.items():
        fwd(params_of[("siot", m)],
            torch.from_numpy(scatter_features(plan, g.features)).to(dev))
    rng = np.random.default_rng(SEED + 1)
    k = g.n // 50
    movers = rng.choice(g.n, size=k, replace=False)
    new = plan.assign.copy()
    new[movers] = (new[movers] + rng.integers(1, PARTS, size=k)) % PARTS
    t0 = time.perf_counter()
    delta = patch_plan(plan, g, new)
    patch_s = time.perf_counter() - t0
    require(not delta.retrace_expected,
            f"a {k}-vertex relayout overflowed the plan's slack: {delta.grew}")
    fresh = recompile_like(plan, g, new)
    require(plans_equal(plan, fresh) == [], "patched plan != fresh compile")
    blocks = torch.from_numpy(scatter_features(plan, g.features)).to(dev)
    refresh_s = {}
    for m, fwd in fwds.items():
        cfg, params = gnn_paper.ALL[("siot", m)], params_of[("siot", m)]
        t0 = time.perf_counter()
        out = fwd(params, blocks)     # refreshes; the first one repacks
        torch.cuda.synchronize()
        refresh_s[m] = time.perf_counter() - t0
        require(fwd.stats["builds"] == 1,
                f"{m}: value-only patch rebuilt the forward")
        fresh_fwd = make_bsp_forward(cfg, fresh, exchange="ppermute",
                                     device=dev)
        require(torch.equal(out, fresh_fwd(params, blocks)),
                f"{m}: patched forward != fresh plan's forward, bit for bit")
    emit({"phase": "patch", "moved": int(len(delta.moved)),
          "dirty_parts": int(len(delta.dirty_parts)), "host_patch_s": patch_s,
          "refresh_s": refresh_s,
          "builds_after_patch": {m: f.stats["builds"] for m, f in fwds.items()},
          "bit_equal_to_fresh": True})
    grow = new.copy()
    grow[: g.n // 2] = 0                      # stampede into partition 0
    delta = patch_plan(plan, g, grow)
    require(delta.retrace_expected, "stampede did not grow the plan")
    blocks = torch.from_numpy(scatter_features(plan, g.features)).to(dev)
    for m, fwd in fwds.items():
        cfg, params = gnn_paper.ALL[("siot", m)], params_of[("siot", m)]
        out = fwd(params, blocks)
        require(fwd.stats["builds"] == 2,
                f"{m}: growth gave {fwd.stats['builds'] - 1} rebuilds, not 1")
        ref = forward(cfg, params, siot["feats"], siot["sd"]).cpu()
        full = torch.from_numpy(gather_outputs(plan, out.cpu().numpy(), g.n))
        err = allclose_err(full, ref, FWD_TOL)
        require(err <= FWD_TOL, f"{m}: forward after growth: {err}")
    emit({"phase": "patch_growth", "grew": list(delta.grew), "cap": plan.cap,
          "builds": {m: f.stats["builds"] for m, f in fwds.items()}})


def phase_serve(siot, params_of, dev):
    g, plan = siot["graph"], siot["plan"]
    cfg, params = gnn_paper.SIOT_GCN, params_of[("siot", "gcn")]
    fwd = make_bsp_forward(cfg, plan, device=dev)
    bsp = gather_outputs(plan, fwd(params, torch.from_numpy(
        scatter_features(plan, g.features)).to(dev)).cpu().numpy(), g.n)
    engine = GNNServeEngine(cfg, params, g, plan, hops=2, batch=16,
                            device=dev)
    targets = zipf_requests(g.n, 256, s=1.1, seed=SEED)
    out = engine.serve(targets)
    err = allclose_err(torch.from_numpy(out), torch.from_numpy(bsp[targets]),
                       FWD_TOL)
    require(out.shape == (256, cfg.layer_dims[-1]) and np.isfinite(out).all(),
            f"served output shape {out.shape} or non-finite values")
    require(err <= FWD_TOL, f"served answers vs BSP forward rows: {err}")
    s = engine.stats
    lat = engine.latency_percentiles()
    emit({"phase": "serve", "requests": s.requests, "batches": s.batches,
          "local_rows": s.local_rows, "cache_hit_rows": s.cache_hit_rows,
          "fetched_rows": s.fetched_rows,
          "replica_hit_rows": s.replica_hit_rows,
          "req_per_s": s.throughput_rps, "p50_ms": lat["p50"] * 1e3,
          "p99_ms": lat["p99"] * 1e3, "allclose_excess": err,
          "cache": engine.cache_stats()})


# ------------------------------------------------------- flash attention (K2)
def _flash_work(q, k, kv_len, causal):
    """(operations, bytes) the attention needs on these inputs: 4 * D flops
    per (query row, live key); q and the output once, each live K/V row
    once, kv_len once."""
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    live = (torch.full((B,), Lk) if kv_len is None
            else kv_len.cpu().long().clamp(0, Lk))
    keys = live[:, None].expand(B, Lq)
    if causal:
        q_pos = torch.arange(Lq) + (Lk - Lq)
        keys = torch.minimum(keys, (q_pos + 1).clamp(min=0)[None, :])
    ops = 4 * D * Hq * int(keys.sum())
    kv_rows = Hkv * int(keys.max(dim=1).values.sum())
    esize = q.element_size()
    nbytes = (2 * q.numel() + 2 * kv_rows * D) * esize
    nbytes += 0 if kv_len is None else kv_len.numel() * 4
    return ops, nbytes


def _sdpa(q, k, v, kv_len, causal):
    """One PyTorch call computing the same attention (a causal case or a
    kv_len case): the library yardstick, never called by the port."""
    mask = None
    if kv_len is not None:
        pos = torch.arange(k.shape[2], device=k.device)
        mask = (pos[None, :] < kv_len[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)


def _check_flash(label, q, k, v, kv_len, causal, path=None):
    """Two launches against the plain version; with ``path``, both must
    have taken that kernel."""
    before = flash_attention.launches_by_path.get(path, 0)
    out = flash_attention(q, k, v, kv_len, causal=causal)
    again = flash_attention(q, k, v, kv_len, causal=causal)
    if path is not None:
        require(flash_attention.launches_by_path[path] == before + 2,
                f"flash_attention {label}: did not take the {path} kernel")
    ref = flash_attention_plain(q, k, v, kv_len, causal)
    torch.cuda.synchronize()
    tol = FLASH_TOL[q.dtype]
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    excess = float((diff - tol * ref.float().abs()).max())
    require(out.shape == q.shape and out.dtype == q.dtype,
            f"flash_attention {label}: output {tuple(out.shape)} {out.dtype}")
    require(excess <= tol, f"flash_attention {label}: max abs err {err} vs "
            f"plain beyond rtol = atol = {tol}")
    require(torch.equal(out, again), f"flash_attention {label}: not bitwise "
            "deterministic across two launches")
    return out, err


def _bhld_views(gen, dev, B, Hq, Hkv, Lq, Lk, D, dtype):
    """q, k, v as (B, H, L, D) views of (B, L, H, D) tensors, the layout the
    model hands the kernel."""
    q = torch.randn((B, Lq, Hq, D), generator=gen, device=dev, dtype=dtype)
    k = torch.randn((B, Lk, Hkv, D), generator=gen, device=dev, dtype=dtype)
    v = torch.randn((B, Lk, Hkv, D), generator=gen, device=dev, dtype=dtype)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def phase_flash_kernels(dev):
    """flash_attention against flash_attention_plain; times at the LM
    path's prefill and decode shapes."""
    cfg = get_config("llama3.2-1b")
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    bf16 = torch.bfloat16
    main_cases = []
    for L in (512, 1024):                          # prefill: B = 1, causal
        main_cases.append((f"prefill_L{L}", *_bhld_views(
            gen, dev, 1, Hq, Hkv, L, L, D, bf16), None, True))
    # Decode: one token per slot against a layer slice of the slot cache,
    # kv_len drawn like the served requests' (prompt 64-1024, + <= 32).
    cache = torch.randn((2, LLAMA_SLOTS, LLAMA_MAX_LEN, Hkv, D), generator=gen,
                        device=dev, dtype=bf16)
    q = torch.randn((LLAMA_SLOTS, 1, Hq, D), generator=gen, device=dev,
                    dtype=bf16).transpose(1, 2)
    kv_len = torch.from_numpy(rng.integers(64, 1057, size=LLAMA_SLOTS)).to(
        dev, torch.int32)
    main_cases.append(("decode_B8_S2048", q, cache[1].transpose(1, 2),
                       cache[0].transpose(1, 2), kv_len, False))
    rows, worst = [], 0.0
    for label, q, k, v, kl, causal in main_cases:
        path = kernel_path(q.dtype, Hq, Hkv, q.shape[2], D)
        out, err = _check_flash(label, q, k, v, kl, causal, path)
        worst = max(worst, err)
        lib_err = float((_sdpa(q, k, v, kl, causal).float()
                         - out.float()).abs().max())
        require(lib_err <= 0.1, f"{label}: the library call disagrees with "
                f"flash_attention by {lib_err}")
        ops, nbytes = _flash_work(q, k, kl, causal)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / BF16_OPS_PER_S * 1e3
        kernel = lambda: flash_attention(q, k, v, kl, causal=causal)  # noqa: E731
        library = lambda: _sdpa(q, k, v, kl, causal)  # noqa: E731
        row = {
            "shape": label, "dtype": "bf16", "max_abs_err": err,
            "path": path, "bitwise_equal": True, "library_max_abs_diff": lib_err,
            "ms": time_ms(kernel), "device_ms": device_ms(kernel),
            "plain_ms": time_ms(
                lambda: flash_attention_plain(q, k, v, kl, causal)),
            "library_ms": time_ms(library),
            "library_device_ms": device_ms(library),
            "library_call": "torch.nn.functional.scaled_dot_product_attention"
                            "(q, k, v, attn_mask=kv_len mask or is_causal, "
                            "enable_gqa=True)",
            "bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        if kl is not None:
            # The same function over the cache cut to the longest live
            # row, the cut taken before timing: the fair library yardstick.
            cut = int(kl.max())
            kc, vc = k[:, :, :cut], v[:, :, :cut]
            cut_call = lambda: _sdpa(q, kc, vc, kl, causal)  # noqa: E731
            cut_err = float((cut_call().float() - out.float()).abs().max())
            require(cut_err <= 0.1, f"{label}: the cut library call "
                    f"disagrees with flash_attention by {cut_err}")
            row.update(library_cut_keys=cut, library_cut_ms=time_ms(cut_call),
                       library_cut_device_ms=device_ms(cut_call))
            # A row's bits never depend on the batch.
            for b in range(q.shape[0]):
                alone = flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                        kl[b:b + 1], causal=causal)
                require(torch.equal(alone, out[b:b + 1]), f"{label}: batch "
                        f"row {b} decoded alone differs from the batch")
            row["batch_equals_rows_alone"] = True
        require(torch.equal(kernel(), out), f"{label}: the output after the "
                "timed launches differs from the first")
        rows.append(row)
        emit({"phase": "kernels", "kernel": "flash_attention", **row})
    # The reference's cases (tests/test_kernels.py), contiguous (B, H, L, D).
    for B, hq, hkv, Lq, Lk, d, causal, kl, dtype in [
            (2, 4, 2, 128, 128, 64, True, None, torch.float32),
            (1, 8, 8, 192, 192, 64, True, None, torch.float32),
            (2, 4, 1, 100, 100, 32, True, None, torch.float32),
            (1, 4, 2, 1, 256, 64, True, [190], torch.float32),
            (2, 2, 2, 64, 64, 16, False, None, torch.float32),
            (1, 4, 4, 96, 160, 64, True, None, torch.float32),
            (2, 4, 2, 64, 64, 64, True, None, bf16)]:
        q = torch.randn((B, hq, Lq, d), generator=gen, device=dev, dtype=dtype)
        k = torch.randn((B, hkv, Lk, d), generator=gen, device=dev, dtype=dtype)
        v = torch.randn((B, hkv, Lk, d), generator=gen, device=dev, dtype=dtype)
        klt = None if kl is None else torch.tensor(kl, dtype=torch.int32,
                                                   device=dev)
        label = (f"B{B}_H{hq}/{hkv}_Lq{Lq}_Lk{Lk}_D{d}"
                 f"{'_causal' if causal else ''}{'_kvlen' if kl else ''}"
                 f"_{str(dtype).split('.')[-1]}")
        _, err = _check_flash(label, q, k, v, klt, causal)
        worst = max(worst, err)
        emit({"phase": "kernels", "kernel": "flash_attention", "shape": label,
              "max_abs_err": err, "tol": FLASH_TOL[dtype],
              "bitwise_equal": True})
    # The split decode at every edge of its splits (kv_len 0, 1, Ks - 1,
    # Ks, Ks + 1, Lk) over the serving cache and a 300-key one, f32 and
    # bf16; the tensor-core prefill at the zoo's other head dims.
    for dtype in (torch.float32, bf16):
        ks = decode_split(D, dtype)
        for Lk in (LLAMA_MAX_LEN, 300):
            lens = [0, 1, ks - 1, ks, ks + 1, Lk]
            q, k, v = _bhld_views(gen, dev, len(lens), Hq, Hkv, 1, Lk, D,
                                  dtype)
            kl = torch.tensor(lens, dtype=torch.int32, device=dev)
            label = f"decode_edges_Lk{Lk}_{str(dtype).split('.')[-1]}"
            out, err = _check_flash(label, q, k, v, kl, False, "decode")
            require(torch.equal(out[0], torch.zeros_like(out[0])),
                    f"{label}: the kv_len = 0 row is not 0")
            worst = max(worst, err)
            emit({"phase": "kernels", "kernel": "flash_attention",
                  "shape": label, "path": "decode", "kv_len": lens,
                  "split": ks,
                  "max_abs_err": err, "tol": FLASH_TOL[dtype],
                  "bitwise_equal": True, "masked_row_zero": True})
    for arch in ("phi3-mini-3.8b", "qwen2.5-32b"):
        c = get_config(arch)
        q, k, v = _bhld_views(gen, dev, 1, c.n_heads, c.n_kv_heads, 512, 512,
                              c.hd, bf16)
        label = f"prefill_L512_{arch}_D{c.hd}"
        _, err = _check_flash(label, q, k, v, None, True, "prefill_tc")
        worst = max(worst, err)
        emit({"phase": "kernels", "kernel": "flash_attention", "shape": label,
              "path": "prefill_tc", "max_abs_err": err,
              "tol": FLASH_TOL[bf16], "bitwise_equal": True})
    # fp32 prefill, lm_parity's path, on the general kernel at its shapes.
    for L in (128, 512):
        q, k, v = _bhld_views(gen, dev, 1, Hq, Hkv, L, L, D, torch.float32)
        label = f"prefill_L{L}_f32"
        _, err = _check_flash(label, q, k, v, None, True, "general")
        worst = max(worst, err)
        emit({"phase": "kernels", "kernel": "flash_attention", "shape": label,
              "path": "general", "max_abs_err": err,
              "tol": FLASH_TOL[torch.float32], "bitwise_equal": True})
    # A fully masked row (kv_len = 0) gives exactly 0.
    q, k, v = _bhld_views(gen, dev, 2, Hq, Hkv, 1, 256, D, bf16)
    kl = torch.tensor([0, 256], dtype=torch.int32, device=dev)
    out, err = _check_flash("kv_len0", q, k, v, kl, False)
    require(torch.equal(out[0], torch.zeros_like(out[0])),
            "flash_attention: the fully masked row is not 0")
    emit({"phase": "kernels", "kernel": "flash_attention",
          "shape": "kv_len0_row", "max_abs_err": err, "masked_row_zero": True})
    return rows, worst


# ------------------------------------------------------------ LM serving path
def _to_cpu(params):
    if isinstance(params, dict):
        return {k: _to_cpu(v) for k, v in params.items()}
    return params.cpu()


def _bucketed(prompt, dev):
    n = len(prompt)
    toks = torch.zeros((1, 1 << (n - 1).bit_length()), dtype=torch.long)
    toks[0, :n] = torch.from_numpy(prompt)
    return {"tokens": toks.to(dev),
            "lengths": torch.tensor([n], dtype=torch.int32, device=dev)}


def _lm_run(cfg, params, prompts, max_len, steps, dev):
    """Prefill each prompt in its bucket, splice the caches into one batch,
    then ``steps`` greedy decode steps.  Returns logits, tokens, the final
    cache and K2's launches per call."""
    logits, caches, launches = [], [], []
    for p in prompts:
        before = flash_attention.launches
        lg, c = lm.prefill(cfg, params, _bucketed(p, dev), max_len)
        launches.append(flash_attention.launches - before)
        logits.append(lg[:, -1])
        caches.append(c)
    cache = {"k": torch.cat([c["k"] for c in caches], dim=1),
             "v": torch.cat([c["v"] for c in caches], dim=1),
             "len": torch.cat([c["len"] for c in caches])}
    toks = [torch.stack([lg.argmax(-1) for lg in logits], dim=1)[0]]
    step_logits = [torch.cat(logits)]
    for _ in range(steps):
        before = flash_attention.launches
        lg, cache = lm.decode_step(cfg, params, toks[-1][:, None], cache)
        launches.append(flash_attention.launches - before)
        step_logits.append(lg[:, 0])
        toks.append(lg[:, 0].argmax(-1))
    return step_logits, torch.stack(toks, 1), cache, launches


def phase_lm_parity(dev):
    """Full-width llama3.2-1b cut to 2 layers, fp32: the card (K2) against
    the CPU (plain attention) on the same weights."""
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2,
                              dtype=torch.float32)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    cpu_params = _to_cpu(params)
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int64)
               for n in (100, 300)]
    max_len, steps = 512 + 16, 8
    g_logits, g_toks, g_cache, launches = _lm_run(cfg, params, prompts,
                                                  max_len, steps, dev)
    torch.cuda.synchronize()
    require(launches == [cfg.n_layers] * (len(prompts) + steps),
            f"lm_parity: flash_attention launches per call {launches}, "
            f"expected {cfg.n_layers} each")
    c_logits, c_toks, c_cache, c_launches = _lm_run(
        cfg, cpu_params, prompts, max_len, steps, torch.device("cpu"))
    require(c_launches == [0] * len(c_launches), "the CPU run launched K2")
    errs = [allclose_err(g.cpu(), c, LM_PARITY_TOL)
            for g, c in zip(g_logits, c_logits)]
    errs += [allclose_err(g_cache[key].cpu(), c_cache[key], LM_PARITY_TOL)
             for key in ("k", "v")]
    max_abs = max(float((g.cpu() - c).abs().max())
                  for g, c in zip(g_logits, c_logits))
    require(max(errs) <= LM_PARITY_TOL, f"lm_parity: card vs CPU beyond "
            f"{LM_PARITY_TOL}: excess {max(errs)}")
    require(torch.equal(g_toks.cpu(), c_toks),
            f"lm_parity: greedy tokens differ: {g_toks.tolist()} vs "
            f"{c_toks.tolist()}")
    require(torch.equal(g_cache["len"].cpu(), c_cache["len"]),
            "lm_parity: cache lengths differ")
    emit({"phase": "lm_parity", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "vocab": cfg.vocab, "dtype": "float32",
          "prompt_lengths": [len(p) for p in prompts], "decode_steps": steps,
          "launches_per_call": launches, "logits_max_abs_diff": max_abs,
          "allclose_excess": max(errs), "tol": LM_PARITY_TOL,
          "greedy_tokens_equal": True, "tokens": g_toks.tolist()})


def phase_lm_serve(dev, flash_rows):
    """Main path: the full bf16 llama3.2-1b behind ServeEngine."""
    cfg = get_config("llama3.2-1b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    engine = ServeEngine(cfg, params, slots=LLAMA_SLOTS,
                         max_len=LLAMA_MAX_LEN, device=dev)
    del params                       # the engine keeps its bf16 copies
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab, size=int(n)),
                    max_new_tokens=32, eos_id=-1)
            for i, n in enumerate(rng.integers(64, 1025, size=16))]
    for r in reqs:
        engine.submit(r)
    torch.cuda.reset_peak_memory_stats()

    spmm.launches = 0                         # the LM path starts here
    flash_attention.launches = 0
    flash_attention.launches_by_path = dict.fromkeys(
        flash_attention.launches_by_path, 0)
    decode_s, admit_s = [], []
    t_run = time.perf_counter()
    while engine.queue or any(r is not None for r in engine.live):
        prefills = engine.stats.prefills
        t = time.perf_counter()
        engine.tick()
        torch.cuda.synchronize()
        (decode_s if engine.stats.prefills == prefills else admit_s).append(
            time.perf_counter() - t)
    run_s = time.perf_counter() - t_run
    launches = flash_attention.launches       # ... and ends here
    by_path = dict(flash_attention.launches_by_path)
    s = engine.stats
    require(all(r.done and len(r.out_tokens) == 32 for r in reqs),
            f"lm_serve: token counts {[len(r.out_tokens) for r in reqs]}")
    require(s.completed == 16 and s.prefills == 16, f"lm_serve: {s}")
    require(launches == cfg.n_layers * (s.prefills + s.ticks),
            f"lm_serve: {launches} flash_attention launches, expected "
            f"{cfg.n_layers} x ({s.prefills} prefills + {s.ticks} ticks)")
    require(spmm.launches == 0, "lm_serve launched spmm_csr")
    require(by_path == {"prefill_tc": cfg.n_layers * s.prefills,
                        "decode": cfg.n_layers * s.ticks, "general": 0},
            f"lm_serve: flash_attention launches by kernel {by_path}, "
            "expected every prefill on prefill_tc, every tick on decode")

    # Two requests re-scored by one teacher-forced forward each.
    exact, gaps = 0, []
    for r in reqs[:2]:
        n = len(r.prompt)
        toks = np.concatenate([r.prompt, r.out_tokens[:-1]])
        logits, _ = lm.forward(cfg, engine.params, {
            "tokens": torch.from_numpy(toks)[None].to(dev)})
        rows = logits[0, n - 1:n - 1 + len(r.out_tokens)].float()
        served = torch.tensor(r.out_tokens, device=dev)
        require(bool(torch.isfinite(rows).all()), "lm_serve: non-finite logits")
        gap = rows.max(-1).values - rows[torch.arange(len(served)), served]
        exact += int((rows.argmax(-1) == served).sum())
        gaps.append(float(gap.max()))
    require(max(gaps) <= SERVE_GAP_TOL, f"lm_serve: a served token is "
            f"{max(gaps)} below the teacher-forced top logit")

    prefill_ms = {}
    for L in sorted({ServeEngine._bucket(len(r.prompt)) for r in reqs}):
        batch = _bucketed(reqs[0].prompt[:1].repeat(L), dev)
        prefill_ms[L] = time_ms(lambda: lm.prefill(
            cfg, engine.params, batch, LLAMA_MAX_LEN), reps=5, warmup=1)
    tick_ms = statistics.median(decode_s) * 1e3
    decode_row = next(r for r in flash_rows if r["shape"].startswith("decode"))
    tokens = s.generated_tokens + s.prefills
    emit({"phase": "lm_serve", "arch": cfg.name, "n_layers": cfg.n_layers,
          "dtype": "bfloat16", "slots": LLAMA_SLOTS,
          "max_len": LLAMA_MAX_LEN, "requests": len(reqs),
          "prompt_lengths": [len(r.prompt) for r in reqs],
          "prefills": s.prefills, "ticks": s.ticks, "completed": s.completed,
          "tokens": tokens, "flash_attention_launches": launches,
          "setup_s": setup_s, "run_s": run_s, "tok_per_s": tokens / run_s,
          "decode_tick_ms_median": tick_ms,
          "decode_tick_ms_p90": float(np.percentile(decode_s, 90)) * 1e3,
          "admit_tick_ms_median": statistics.median(admit_s) * 1e3,
          "prefill_ms_by_bucket": prefill_ms,
          "flash_attention_launches_by_path": by_path,
          "k2_share_of_decode_tick": (
              cfg.n_layers * decode_row["device_ms"] / tick_ms
              if isinstance(decode_row["device_ms"], float)
              else "not measured"),
          "teacher_forced_exact": exact, "teacher_forced_checked": 64,
          "teacher_forced_max_gap": max(gaps), "gap_tol": SERVE_GAP_TOL,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    _profile_decode(engine, cfg)
    return launches, by_path


def _profile_decode(engine, cfg, ticks: int = 4):
    """Where a decode tick's time goes: ``torch.profiler`` over a few ticks
    with all 8 slots live, after the counted run.  Prints the device's busy
    share of the window and kernel time by name; "not measured" where the
    trace holds no device time."""
    rng = np.random.default_rng(SEED + 3)
    for i in range(LLAMA_SLOTS):
        engine.submit(Request(uid=100 + i, prompt=rng.integers(
            1, cfg.vocab, size=512), max_new_tokens=ticks + 2, eos_id=-1))
    engine.tick()                             # admit all, one decode
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(ticks):
            engine.tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k2 = [e for e in kernels if "flash_" in e.key]
    k2_ms = sum(e.self_device_time_total for e in k2) / 1e3 / ticks
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    emit({"phase": "lm_profile", "ticks": ticks, "window_ms": wall_ms,
          "device_busy_ms": busy_ms if kernels else "not measured",
          "device_busy_share": busy_ms / wall_ms if kernels
          else "not measured",
          "kernel_launches_per_tick": sum(e.count for e in kernels) / ticks,
          "k2_device_ms_per_tick": k2_ms if k2 else "not measured",
          "k2_launches_per_tick": sum(e.count for e in k2) / ticks,
          "top_kernels_ms_per_tick": {
              e.key[:80]: e.self_device_time_total / 1e3 / ticks
              for e in top}})


def main() -> int:
    t_start = time.perf_counter()
    kind, smi_line = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    siot = make_dataset("siot", dev)
    yelp = make_dataset("yelp", dev)
    kernel_rows, worst = phase_kernels([siot, yelp], dev)
    flash_rows, flash_worst = phase_flash_kernels(dev)

    spmm.launches = 0                         # the GNN path starts here
    flash_attention.launches = 0
    params_of, _ = phase_bsp([siot, yelp], dev)
    phase_patch(siot, params_of, dev)
    phase_serve(siot, params_of, dev)
    launches = spmm.launches                  # ... and ends here
    require(launches > 0, "the GNN path never launched spmm_csr")
    del params_of, siot, yelp

    phase_lm_parity(dev)
    flash_launches, flash_by_path = phase_lm_serve(dev, flash_rows)
    require(flash_launches > 0, "the LM path never launched flash_attention")

    head = kernel_rows[0]
    flash_head = next(r for r in flash_rows
                      if r["shape"].startswith("decode"))
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [{
        "name": "spmm_bsr", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spmm_csr.cu",
        "replaces": "src/repro/kernels/gnn_aggregate.py:77",
        "launches": launches, "max_abs_err": worst,
        "ms": head["ms"], "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_device_ms": head["library_device_ms"],
        "dense_values_bound_ms": head["dense_values_bound_ms"],
        "shape": head["shape"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:117",
        "launches": flash_launches, "launches_by_path": flash_by_path,
        "max_abs_err": flash_worst,
        "ms": flash_head["ms"], "device_ms": flash_head["device_ms"],
        "plain_ms": flash_head["plain_ms"],
        "bound_ms": flash_head["bound_ms"],
        "bound_by": flash_head["bound_by"],
        "library_ms": flash_head["library_ms"],
        "library_device_ms": flash_head["library_device_ms"],
        "shape": flash_head["shape"],
        "shapes": {r["shape"]: {key: r.get(key) for key in (
            "path", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "library_cut_ms",
            "library_cut_device_ms")} for r in flash_rows}}]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
