#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

It builds the port's hand-written kernels from ``src/repro_torch/kernels/
csrc`` and drives the port's main path at the paper's full widths:

  device  the card's name, count and power limit (exit 1 without a card);
  build   nvcc for sm_90a, with the build seconds and ptxas' register use;
  kernels each kernel against its plain torch version at the main path's
          shapes and at small shape cases: max abs error, bitwise
          determinism, median CUDA-event times of the kernel, the plain
          version and one library call, and the bound from bytes and
          operations;
  bsp     the batched BSP forward (GCN, SAGE, GAT x ppermute, allgather) on
          SIoT (8001 vertices) and Yelp (3912), 8 partitions of a random
          layout, held against the whole-graph forward on the card and on
          the CPU; counts the kernel's launches per forward;
  patch   a 2% relayout patched in place (0 rebuilds, output bit-equal to a
          fresh plan's), then a capacity overflow (exactly 1 rebuild);
  serve   256 Zipf requests through the ego-serving engine over the live
          plan, held against the BSP forward's rows.

Each phase prints one JSON line.  Any failed check exits non-zero.  Before
the last line it prints the kernels summary and the ``nvidia-smi`` name and
power limit; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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

from repro_torch.configs import gnn_paper  # noqa: E402
from repro_torch.core import partition_from_assign, random_layout  # noqa: E402
from repro_torch.gnn import (  # noqa: E402
    GNNServeEngine, build_plan_bsr, compile_plan, directed_edges, forward,
    gather_outputs, init_params, make_bsp_forward, patch_plan, plans_equal,
    recompile_like, scatter_features, zipf_requests)
from repro_torch.graphs import DataGraph, synthetic_siot, synthetic_yelp  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.gnn_aggregate import (  # noqa: E402
    build_bsr, spmm, spmm_plain)

PARTS = 8
SLACK = 0.5
SEED = 0
FWD_TOL = 2e-4                 # the reference's own gate (test_distributed_gnn)
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, fp32 outside tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


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
    ptxas = [ln.strip() for ln in res.log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": res.seconds,
          "library": os.path.relpath(res.path), "ptxas": ptxas})


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


def _check_case(label, values, cols, feats, bm, bk):
    out = spmm(values, cols, feats, bm, bk)
    again = spmm(values, cols, feats, bm, bk)
    ref = spmm_plain(values, cols, feats, bm, bk)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    require(err <= 1e-5 * scale + 1e-5,
            f"spmm_bsr {label}: max abs err {err} vs plain (scale {scale})")
    require(torch.equal(out, again), f"spmm_bsr {label}: not bitwise "
            "deterministic across two launches")
    return out, err


def phase_kernels(siot, dev):
    """spmm_bsr against spmm_plain; times at the main path's shapes."""
    gen = torch.Generator().manual_seed(SEED)
    results, worst = [], 0.0
    plan = siot["plan"]
    b = plan.bsr
    values = torch.from_numpy(b.values).to(dev)
    cols = torch.from_numpy(b.block_cols).to(dev)
    lib_a, nnz = _library_csr(b.values, b.block_cols, b.src_rows, dev)
    for d in (52, 16):                 # SIoT GCN/SAGE layer widths
        feats = torch.randn((PARTS, b.src_rows, d), generator=gen).to(dev)
        label = f"siot_P{PARTS}_d{d}"
        out, err = _check_case(label, values, cols, feats, b.bm, b.bk)
        worst = max(worst, err)
        flat = feats.reshape(PARTS * b.src_rows, d)
        lib_out = torch.sparse.mm(lib_a, flat).reshape(out.shape)
        lib_err = float((lib_out - out).abs().max())
        require(lib_err <= 1e-4 * float(out.abs().max()) + 1e-4,
                f"library product disagrees with spmm_bsr: {lib_err}")
        nbytes = (values.numel() * 4 + cols.numel() * 4 + feats.numel() * 4
                  + out.numel() * 4)
        ops = 2 * nnz * d
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        row = {
            "shape": label, "max_abs_err": err,
            "ms": time_ms(lambda: spmm(values, cols, feats, b.bm, b.bk)),
            "plain_ms": time_ms(
                lambda: spmm_plain(values, cols, feats, b.bm, b.bk)),
            "library_ms": time_ms(lambda: torch.sparse.mm(lib_a, flat)),
            "library_call": "torch.sparse.mm(sparse_csr_tensor, feats)",
            "bytes": nbytes, "ops": ops, "nnz": nnz,
            "dense_block_ops": 2 * values.numel() * d,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        results.append(row)
        emit({"phase": "kernels", "kernel": "spmm_bsr", **row})
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
        _, err = _check_case(label, torch.from_numpy(v).to(dev),
                             torch.from_numpy(c).to(dev), feats, bm, bk)
        worst = max(worst, err)
        emit({"phase": "kernels", "kernel": "spmm_bsr", "shape": label,
              "max_abs_err": err})
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
                before = spmm.launches
                out = fwd(params, blocks)
                torch.cuda.synchronize()
                launched = spmm.launches - before
                want = cfg.num_layers if model in ("gcn", "sage") else 0
                require(launched == want, f"{ds['name']} {model} {exchange}: "
                        f"{launched} spmm_bsr launches, expected {want}")
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
                      "card_vs_cpu_excess": cpu_err, "forward_ms": ms})
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
    for m, fwd in fwds.items():
        cfg, params = gnn_paper.ALL[("siot", m)], params_of[("siot", m)]
        out = fwd(params, blocks)
        require(fwd.stats["builds"] == 1,
                f"{m}: value-only patch rebuilt the forward")
        fresh_fwd = make_bsp_forward(cfg, fresh, exchange="ppermute",
                                     device=dev)
        require(torch.equal(out, fresh_fwd(params, blocks)),
                f"{m}: patched forward != fresh plan's forward, bit for bit")
    emit({"phase": "patch", "moved": int(len(delta.moved)),
          "dirty_parts": int(len(delta.dirty_parts)), "host_patch_s": patch_s,
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


def main() -> int:
    t_start = time.perf_counter()
    kind, smi_line = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    siot = make_dataset("siot", dev)
    yelp = make_dataset("yelp", dev)
    kernel_rows, worst = phase_kernels(siot, dev)

    spmm.launches = 0                         # the main path starts here
    params_of, _ = phase_bsp([siot, yelp], dev)
    phase_patch(siot, params_of, dev)
    phase_serve(siot, params_of, dev)
    launches = spmm.launches                  # ... and ends here
    require(launches > 0, "the main path never launched spmm_bsr")

    head = kernel_rows[0]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [{
        "name": "spmm_bsr", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spmm_bsr.cu",
        "replaces": "src/repro/kernels/gnn_aggregate.py:77",
        "launches": launches, "max_abs_err": worst,
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "shape": head["shape"]}]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
