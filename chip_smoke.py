#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

It builds the port's hand-written kernels from ``src/repro_torch/kernels/
csrc`` and drives the port's paths: the GNN pipeline at the paper's full
widths, then LM serving and LM training on llama3.2-1b, MoE serving on
deepseek-moe-16b, the recurrent families' serving on zamba2-1.2b and
xlstm-1.3b, the VLM and enc-dec families' serving on internvl2-2b and
seamless-m4t-medium, and the training of those five families, at their
published widths:

  device  the card's name, count and power limit (exit 1 without a card);
  build   nvcc for sm_90a, with the build seconds and each kernel's ptxas
          registers and spill bytes;
  layout  the paper's first stage on SIoT (8001 vertices) and Yelp (3912)
          over two 8-server edge networks: the default fleet (mu_factor
          0.05, the quickstart's) and the fleet of the repo's serving and
          layout benchmarks (mu_factor 2.0).  Under each, the DGPE cost
          model of a GCN and the costs of the Random, Greedy and GLAD-S
          layouts (GLAD-S below Random), GLAD-S's iterations and host
          seconds.  Three plans: Random, GLAD-S on the default fleet (which
          puts SIoT on one server and cuts no link) and GLAD-S on the
          mu_factor 2.0 fleet (the main plan: it cuts links and has
          ppermute rounds), each with its cut links, halo rows,
          capacities, rounds and BSR nonzeros;
  kernels each kernel against its plain torch version at the main path's
          shapes and at small shape cases: max abs error, bitwise
          determinism, median CUDA-event times of the kernel, the plain
          version and one library call, and the bound from bytes and
          operations.  K1 (spmm_csr on the BSR's packed nonzeros) runs at
          SIoT d = 52 and 16 and Yelp d = 100 over the three plans (the
          main plan's first); the Random plan's rows (the shapes of
          earlier runs) also against the dense layout's plain version;
          rows add the device time per call (torch.profiler) of the kernel
          and the library call, which leaves out the host's time to
          enqueue them.  K1's backward (Aᵀ·g: the kernel over the
          transposed operand) at the main plans' three shapes, against the
          plain product over that operand and autograd of the plain
          forward, with torch.sparse.mm on the transposed CSR as the
          library call;
  train   the distributed train step over the main plans of SIoT and
          Yelp (GCN, SAGE, GAT x ppermute, allgather; GCN and SAGE on K1
          both ways and also on the segment path): gradients against the
          CPU whole-graph gradients, bitwise run to run, K1's forward and
          backward launches per step, 20 steps lowering the loss, the
          trained parameters through a checkpoint bit for bit, a value-only
          patch (the step bit-equal to a fresh plan's, 0 rebuilds); the
          step is captured (one CUDA graph, replayed): 20 steps bit-equal
          to 20 eager ones, also replayed after the patch, the eager step
          free of host reads, host ms (enqueue, call) and device ms both
          ways, capture s, pool MB; the
          path's launches are counted apart from the forward path's; then
          K2 differentiating through q, k or v alone (each gradient
          against the plain backward's);
  whole_graph  the whole-graph train_step and predict (the reference's
          jitted ones, on the segment sum) over the six paper configs on
          the full graphs: 20 steps from a CUDA graph bit-equal to 20 eager
          ones, the loss falling, a replay over a permuted edge list
          bit-equal to the eager step over it, predict from a graph equal
          to eager predict, one build a signature, the eager step free of
          host reads; host ms (enqueue, call) and device ms both ways,
          capture s, pool MB;
  bsp     the batched BSP forward (GCN, SAGE, GAT x ppermute, allgather) on
          SIoT and Yelp over each of the three plans, held against the
          whole-graph forward on the card and on the CPU; counts the
          kernel's launches per forward, the resident plan tensors and the
          forward's peak device memory; the forward is captured, and each
          case's bsp_graph line holds a replay bit-equal to the eager
          forward, 1 trace and 1 build, K1 a replay, host ms (enqueue,
          call) and device ms both ways, capture s and pool MB;
  serve   256 Zipf requests through the ego-serving engine over each plan,
          held against the BSP forward's rows; the Random plan fetches
          remote rows; the serve_graph line: the stream through the graph
          engine (one CUDA graph a bucket) and an eager engine, twice
          each, answers bit-equal, traces equal, req/s and p50/p99 both
          ways for both passes;
  replicate  replicate_for_stream on serve's stream over SIoT's Random and
          main plans, set_replication, and the replicated forward (GCN,
          SAGE, GAT) bit-equal to the unreplicated one with fewer layer-0
          halo rows; the stream served over the replicated plan, with
          replica hits; replicas then switched off again;
  patch   on the main plan: a 2% relayout off it (rebuilds exactly as the
          plan's retrace_expected says: it grows halo_cap), then the
          relayout back to it, patched in place (0 rebuilds, output
          bit-equal to a fresh plan's; the host time of each model's first
          forward after it: GCN's repacks the plan, SAGE's shares that
          pack), then a capacity overflow (exactly 1 rebuild); the
          forwards are captured: new traces = rebuilds at every patch,
          each replay bit-equal to a fresh plan's eager forward;
  evolve  the paper's dynamic path on SIoT over the main fleet: three slots
          of sample_delta / apply_delta, GLAD-E relayouts and patch_plan
          with the structural dirty set, on the main layout compiled
          without headroom; every slot patched == fresh compile, the GCN
          forward bit-equal to a fresh plan's, rebuilds as
          retrace_expected says, and one slot that inserts vertices and
          overflows e_cap;
  ex_quickstart, ex_relayout, ex_serve_gnn, ex_experts  the example
          twins (repro_torch.launch.*) at the paper's sizes, inside the
          GNN path's K1 count: quickstart on Yelp (3912 vertices, 8
          servers; GLAD-S at or below Greedy and below Random, both
          plans' BSP forwards on K1 within FWD_TOL), adaptive_relayout on
          Yelp (GLAD-A over EX_RELAYOUT_SLOTS slots of the evolution
          trace, the live plan patched each slot and one resident forward
          bound to it: every forward within FWD_TOL, rebuilds == the
          slots' retrace_expected, K1 twice a forward), serve_gnn on SIoT
          (6 servers, mu_factor 2.0, 2000 Zipf requests, the most loaded
          server failing half way: every served answer within FWD_TOL, no
          vertex left on it, one cache re-seed; req/s and p50/p99 before
          and after) and expert_placement at the example's size;
  ranks   the per-rank BSP forward (gnn.ranks.make_rank_bsp_forward) as 8
          spawned processes, one per server of the plans, all on this card
          over gloo, halos staged through pinned host memory (one spawn,
          after the GNN path's K1 count is read): rank 0 lays SIoT and
          Yelp out as layout does and broadcasts the assignments, every
          rank compiles the main and Random plans and runs GCN, SAGE and
          GAT under both exchanges; the gathered blocks against the
          whole-graph forward (FWD_TOL) and the one-device batched forward
          (error reported), a repeat bit-equal, K1 launches per rank,
          staging copies per collective, rows and bytes per layer against
          the plan's schedule, each rank's forward ms split into exchange,
          plan check and compute beside the one-device forward's ms; the
          replicated forward on SIoT's Random plan (replicate_greedy)
          bit-equal to the unreplicated one, and raising without
          replica0; the whole-graph forward timed on every rank at once and
          on one at a time;
  ranks_train  in the same ranks, the train step over both main plans
          (GCN, SAGE, GAT, ppermute): the loss and every gradient leaf
          against the one-device step on the card, a step repeated
          bit-equal, 20 steps lowering the loss with the parameters'
          digest equal on every rank after each, K1 both ways per step;
          then phase_patch's relayouts on the ranks' SIoT main plan (0
          rebuilds and bit-equal to a fresh plan's rank forward after the
          value-only one, 1 after growth);
  kernels_decode_stats  K2's decode with stats (the mesh's
          sequence-split decode) at llama3.2-1b's B = 8 over 2048
          positions (bf16 and fp32) and deepseek-moe-16b's D = 128: the
          cache cut into 1, 2, 4 and 16 slices (a row at kv_len 0, slices
          wholly past kv_len), each slice with stats, merged, against the
          whole-cache kernel and the plain version (fp32 2e-5, bf16 2e-2
          max|ref|), bit-equal run to run, one slice the whole-cache
          kernel's bits; the split-plus-merge's device time beside the
          whole-cache kernel's; its rows go into K2's shapes;
  kernels flash_attention against its plain torch version at the LM path's
          prefill (L = 512, 1024: the bf16 tensor-core kernel) and decode
          (cache strides, ragged kv_len: the split-key kernel) shapes, and
          at deepseek-moe-16b's (16/16 heads of 128: prefill L = 1024,
          decode of 8 slots over 2048 positions), zamba2-1.2b's (32/32
          heads of 64: prefill at L = 337 and 1000, decode as above),
          internvl2-2b's (16/8 heads of 128: prefill at L = 768, decode as
          above) and seamless-m4t-medium's (16/16 heads of 64, none causal:
          the encoder at L = 1024, the cross-attention of 8 32-token
          prompts and of 8 decode rows over 1024 frames), with
          the same error, determinism, time, device time and bound fields as
          K1 and scaled_dot_product_attention as the library call (at decode
          also over the cache cut to the longest live row); a decoded batch
          equals each row decoded alone, bit for bit; the split decode at
          every kv_len edge of its splits, f32 and bf16; ex_serve_lm's
          shapes at llama's heads (causal prefill at its buckets L = 4 to
          32, decode of 4 slots over a 96-position cache at kv_len 1-30);
          the tensor-core prefill at D = 96 and 128; fp32 prefill
          (lm_parity's) on the general kernel at L = 128 and 512; the reference's 7 test cases
          and a fully masked row; each case that names a kernel is held
          to have launched it.  K2's backward (the dq kernel, then the
          dkdv kernel, on the path backward_path names: the tensor-core
          pair for bf16 with the prefill's head dims, the CUDA-core pair
          otherwise) at the LM train step's shape (B = 4, L = 1024, bf16,
          causal) and at L = 512 against flash_attention_bwd_plain, both
          on the tensor-core pair, with the same fields, the device time
          of each kernel, and the backward of scaled_dot_product_attention
          as the library call; then small cases through autograd on every
          forward kernel and both backward paths, fp32 and bf16 (causal
          and not, Lq != Lk, groups 1, 4 and 8, D = 32, 64 and 128, ragged
          kv_len with a 0 row, Lq = 1); then the training path's rows:
          K2's backward at deepseek-moe-16b's (D = 128, causal, L = 1024),
          internvl2-2b's (16/8 heads of 128, L = 256 + 1024) and
          seamless-m4t-medium's (non-causal, L = 1024) training shapes,
          and the grouped GEMM's backward (dx over wᵀ, the K-ragged dw) at
          deepseek-moe-16b's width for both products of a MoE layer,
          against the loop route, with autograd through
          torch._grouped_mm as the library call;
  lm_parity  llama3.2-1b at full width cut to 2 layers, fp32: prefill of two
          bucketed prompts and 8 greedy decode steps on the card (K2) and on
          the CPU (plain attention) agree, with n_layers launches per call;
  lm_serve   the full 16-layer bf16 llama3.2-1b behind ServeEngine (8 slots,
          2048 positions) serves 16 requests of 32 tokens; the engine as
          users get it replays CUDA graphs (its decode step and one prefill
          step per prompt bucket, captured once); K2 launches 16 x
          (prefills + ticks), counted per replay, every prefill's on the
          tensor-core kernel and every tick's on the split decode; two
          requests are re-scored by a teacher-forced forward; prefill and
          decode-tick times; then lm_serve_graphs: the same requests
          through an eager engine (graphs=False) on the same weights,
          tokens and every tick's logits bit-equal, trace_counts one
          decode step and one prefill step per bucket, both ways' tick
          host ms and tok/s, capture seconds and the graphs' pool MB;
  ex_serve_lm  the launch.serve_lm twin inside the LM path's K2 count:
          the example's reduced llama in fp32 (12 requests of 12 tokens,
          4 slots) with the card's tokens equal to the CPU's, then the
          full-width bf16 llama3.2-1b behind the same engine, two of its
          requests re-scored by a teacher-forced forward within
          SERVE_GAP_TOL; K2 launches n_layers x (prefills + ticks),
          exactly by kernel path;
  lm_profile  torch.profiler over 4 decode ticks with 8 live slots: the
          device's busy share, kernel time by name and by class (K2, grouped
          GEMM, other GEMMs, elementwise) and K2's device time per tick;
          the ticks are graph replays, and the profile must show K2's
          kernels in them, n_layers a tick (the same in every serve
          phase's profile);
  moe_parity  deepseek-moe-16b at full width cut to 2 layers (the dense
          first layer and one MoE layer: 64 experts top-6, 2 shared), fp32,
          as lm_parity, and the router's expert sets equal on the card and
          the CPU at every (token, layer), with the smallest gap between a
          token's k-th and (k+1)-th router probability; then the MoE FFN
          alone at full width, 512 tokens in bf16 on the card, against the
          dense oracle (moe_ffn_dense_ref) and bit-equal twice;
  moe_serve  the full 28-layer bf16 deepseek-moe-16b (16.4 B parameters,
          32.8 GB, drawn on the card in bf16) behind ServeEngine (8 slots,
          2048 positions) serves 16 requests of 32 tokens; K2 launches
          28 x (prefills + ticks) (every prefill on prefill_tc at D = 128,
          group 1, every tick on the split decode) and every MoE layer two
          grouped GEMMs on the grouped_mm route; two requests re-scored by a
          teacher-forced forward routed as serving routed them, every served
          token held as in lm_serve, and the router's own choices in that
          pass against the served ones at every (position, layer); tick,
          prefill and setup times and peak memory; moe_profile as
          lm_profile; then moe_route_fp32: the same model in fp32 serves
          two of the prompts and an unforced teacher-forced forward agrees
          with serving's routes at all but 1% of (position, layer) pairs;
          moe_serve's engine runs eagerly (graphs=False: its checks wrap
          the router call by call); moe_serve_graphs then serves its
          requests through the engine as users get it (CUDA graphs, bf16
          on grouped_mm): tokens and every tick's logits bit-equal to the
          eager run's, K2 and grouped GEMM launches exact per replay, both
          kernels seen in a profiled window of replays (moe_graph_profile);
          the fp32 engine resolves to eager (its grouped GEMM reads the
          host);
  hybrid_parity, xlstm_parity  zamba2-1.2b cut to 6 layers (one
          shared-block site) and xlstm-1.3b cut to 8 (its one sLSTM layer)
          at full width, fp32: the teacher-forced forward over 300 tokens,
          then two prompts prefilled at their exact lengths and 8 greedy
          decode steps, card against CPU: logits, every cache key, tokens;
  hybrid_serve, xlstm_serve  each full-depth bf16 model behind
          ServeEngine with lm_serve's traffic, every prompt prefilled at
          its exact length; K2 6 x (prefills + ticks) for zamba2 (every
          prefill on prefill_tc, every tick on decode), 0 for xlstm;
          every served token re-scored by a bf16 teacher-forced forward
          and by the fp32 model over the same weights: serving's logits no
          further from the fp32 model's than the forward's
          (REC_NOISE_RATIO), zamba2's tokens also to lm_serve's gate;
          prefill ms by length, tick times, a profiled window as
          lm_profile; the engine replays its decode step from a CUDA graph
          (prefill stays eager at the exact length), held as lm_serve's
          against an eager twin (xlstm's serves the 9 shortest prompts);
  recurrent_fp32  both full-depth models in fp32 serve two prompts (one
          past an SSD chunk), and each token's served logits agree with
          the teacher-forced forward's within 2e-3, tokens equal;
  vlm_parity, encdec_parity  internvl2-2b cut to 2 layers and
          seamless-m4t-medium cut to 2 + 2 at full width, fp32: two prompts
          (64 tokens after 256 stub patches; 16 tokens over 1024 stub
          frames), the teacher-forced forward, then one prefill and 8
          greedy decode steps, card against CPU: logits, every cache key
          (enc-dec's cross-attention xk/xv too), tokens;
  vlm_serve  the full 24-layer bf16 internvl2-2b behind ServeEngine with
          lm_serve's traffic, text only at exact length (as the reference's
          engine serves it): K2 24 x (prefills + ticks) by kernel, every
          served token against a teacher-forced forward (lm_serve's gate);
          then 256 patches + a 512-token prompt and 16 decode steps through
          the zoo, each token against the forward with the patches; tick,
          prefill and profile (vlm_profile) lines; its decode step replayed
          from a CUDA graph, held as lm_serve's against an eager twin;
  encdec_serve  the full 12 + 12-layer bf16 seamless-m4t-medium: 8
          utterances of 1024 frames with 32-token prompts prefilled in one
          batch, 32 decode steps (the reference's form of enc-dec serving);
          K2 36 per prefill (encoder, decoder self, cross: prefill_tc) and
          24 per step (decode); every token against teacher forcing;
          encoder and prefill ms, step times; then the idle-slot repair on
          the card (llama3.2-1b cut to 2 layers, an idle slot's len past
          max_len: no device assert);
  zoo_fp32  both at full depth in fp32: 16 decode steps' logits against the
          teacher-forced forward within 2e-3, tokens equal;
  lm_train_parity  llama3.2-1b at full width cut to 2 layers, fp32, 2 x
          128 tokens from the data pipeline: loss_fn and every gradient
          leaf on the card (K2 both ways) against the CPU's;
  lm_train  the full 16-layer llama3.2-1b (bf16 compute, fp32 weights,
          AdamW at lr 1e-3) on 4 x 1024 tokens through make_train_step:
          step 0's loss equals a no-grad forward's, 2 microbatches equal 1,
          10 steps on one batch from a CUDA graph (captured at the first,
          replayed after) bit-equal to 10 eager ones from the same seeded
          state (loss, grad norm and a digest of every parameter and moment
          at every step; the eager step free of host reads) and lowering
          the loss, 3 compressed (int8 + error feedback) steps of 2
          microbatches from a graph bit-equal to eager ones and finite, the
          trained weights and optimizer state through a checkpoint bit for
          bit, K2 launches n_layers forwards and n_layers of each backward
          kernel per microbatch (a replay counts as a step), every
          backward on the tensor-core pair (the fp32 parity pass's on the
          CUDA-core pair); host-clocked step ms and tokens/s from the graph
          and eager, capture s, pool GB, peak memory each way, two
          profiled replays (busy share, device time by class), and whether
          the same step repeats bit for bit;
  moe_train, hybrid_train, vlm_train, encdec_train, xlstm_train  each of
          deepseek-moe-16b (cut to 1 dense + MOE_TRAIN_LAYERS MoE layers by
          memory), zamba2-1.2b, internvl2-2b (256 stub patches a row),
          seamless-m4t-medium (1024 stub frames a row) and xlstm-1.3b (4 x
          256 tokens, 6 steps) trained at full width: first its parity
          part (cut to 2 (2 + 2) layers, fp32, grads_of on the card and
          the CPU: the loss, every gradient leaf, the MoE router's expert
          sets, launches), then its main path (bf16 compute, fp32
          weights, AdamW, every layer checkpointed as the configs say, 4 x
          1024 tokens): step 0's loss equals a no-grad forward's, grads_of
          twice from one state bit-equal, 10 steps from a CUDA graph
          bit-equal to 10 eager ones (as lm_train's), each finite with the
          last below the first, two profiled replays (busy share, device
          time by class: K2 and the grouped GEMM each way, cuBLAS,
          elementwise), K2 and grouped GEMM launches exactly by kernel,
          path and route; step ms and tokens/s graph and eager, capture s,
          pool GB, peak memory each way;
  mesh_parity  the mesh path (Dist over a 1x1 DeviceMesh, NCCL at world
          size 1; the reference's make_debug_mesh on one device):
          llama3.2-1b at full width, bf16, its weights laid out by
          param_specs, forward and prefill bit-equal to the mesh-free
          path, K2 once a layer a pass on prefill_tc through local_map;
  mesh_train  llama3.2-1b through jit_train_step on that mesh, 3 steps on
          4 x 1024 tokens, twice from a CUDA graph (the first step eager,
          then captured over DTensors and replayed) and once eagerly,
          each run's losses, parameters and moments bit-equal to
          make_train_step's; K2 both ways counted, exact per replay; step
          ms graph / meshed eager / mesh-free, capture s, pool and peak
          GB, the NCCL kernels and busy share of a profiled replay;
  mesh_moe  deepseek-moe-16b's expert-parallel moe_ffn with its capacity
          at full width (64 experts, top-6, bf16, 4096 tokens): nothing
          dropped at capacity factor 2.0 (the output against the dropless
          path), about half at 0.5 (the dropped set equal to the rule on
          the host over the card's own routing), each batched GEMM's
          device time beside the grouped GEMM's;
  mesh_serve  llama3.2-1b at full width (16 layers, bf16) behind
          ServeEngine(dist=the 1x1 mesh), its decode step and a prefill
          step a bucket captured into CUDA graphs, lm_serve's 16 requests
          of 32 tokens: tokens and every tick's logits bit-equal to an
          eager mesh-free engine's and, for the first 4 requests, to a
          meshed eager engine's; trace_counts; K2 launched exactly once a
          layer a prefill (prefill_tc) and a tick (decode), per replay,
          none with stats; tick host ms three ways, a replayed and an
          eager decode step's device ms, capture s, pool GB, the NCCL
          kernels and busy share of a profiled replay;
  mesh_families  zamba2-1.2b, xlstm-1.3b and seamless-m4t-medium at full
          width (bf16) on the 1x1 mesh: forward, then prefill and 8 decode
          steps, bit-equal to the mesh-free path; two jit_train_steps each
          (fp32 weights, AdamW; xlstm cut to 8 layers on 2 x 256 tokens),
          the second replayed from a CUDA graph, bit-equal to
          make_train_step's, K2 exact per replay;
  dryrun  the dry-run (launch/dryrun.py: fake groups of 256 and 512 ranks
          on the host, DRYRUN_WORKERS processes started before the build
          and run beside every card phase) of every cell on pod16x16 and
          pod2x16x16: 32 ok and 8 skipped a mesh, the pinned cells'
          per-device argument bytes equal to the reference dry-run's, each
          cell's FLOPs, peak and collective bytes by kind with the torch
          version that counted them, the roofline in the H100's terms.

Each phase prints JSON lines; a phase_seconds line splits the run's host
seconds by phase before the done line.  Any failed check exits non-zero.
Before the last line it prints the kernels summary and the ``nvidia-smi`` name and
power limit; the last line is ``{"ok": true, "device": {...}}``.  The
kernel summary's ``launches`` are the main paths' (train, then the GNN
forward path from bsp to evolve and the example twins (K1's ``gnn`` and
``examples``), then the ranks (K1's ``ranks_fwd`` and
``ranks_bwd``, summed over the ranks), then LM serving, MoE serving, hybrid
serving, VLM serving, enc-dec serving, then LM training, the five
families' training and the mesh phases), each counted from 0; K2's
``launches_by_path`` counts by kernel and its ``examples_launches`` the
part of them that ex_serve_lm made (also in ``launches_by_phase``), its
``launches_from_replays_by_phase`` the part of the mesh phases' that
their CUDA graphs' replays made; its
``flash_attention_bwd_tc`` entry
is K2's tensor-core backward (both kernels' launches on the training
paths, by phase).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import models as lm  # noqa: E402
from repro_torch.models import moe, ssm  # noqa: E402
from repro_torch.configs import get_config, gnn_paper  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CostModel, apply_delta, glad_e, glad_s, greedy_layout,
    partition_from_assign, random_layout, sample_delta, workload_for)
from repro_torch.gnn import (  # noqa: E402
    GNNServeEngine, broadcast_assign, build_plan_bsr, compile_plan,
    directed_edges, forward, gather_outputs, init_params, loss_and_grads,
    make_bsp_forward, make_distributed_train_step, make_rank_bsp_forward,
    patch_plan, plans_equal, recompile_like, replicate_for_stream,
    scatter_features, scatter_ints, scatter_replica_halo, serving_cost,
    set_replication, zipf_requests)
from repro_torch.gnn.models import predict  # noqa: E402
from repro_torch.gnn.training import (  # noqa: E402
    train_step as whole_train_step)
from repro_torch.graphs import (  # noqa: E402
    DataGraph, build_edge_network, synthetic_siot, synthetic_yelp)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    adaptive_relayout, expert_placement, quickstart, serve_gnn, serve_lm)
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.launch.serve import serve_config  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    aligned16, backward_path, combine_decode_partials, decode_split,
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_plain, flash_decode_split_plain, kernel_path)
from repro_torch.kernels.gnn_aggregate import (  # noqa: E402
    build_bsr, pack_bsr, spmm, spmm_packed, spmm_packed_plain, spmm_plain,
    transpose_packed)
from repro_torch.launch.mesh import (  # noqa: E402
    full_tree, make_debug_mesh, shard_tree)
from repro_torch.models.common import P, Dist, ShapeCfg  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.train import (  # noqa: E402
    CheckpointManager, OptConfig, batch_at_step, init_error_feedback,
    init_opt_state, make_train_step, optim)
from repro_torch.train.step import jit_train_step  # noqa: E402

PARTS = 8
SLACK = 0.5
SEED = 0
# The two fleets' upload-cost factor: build_edge_network's default (the
# quickstart's), and the one the repo's serving and layout benchmarks use
# (benchmarks/serving.py, examples/serve_gnn_requests.py,
# benchmarks/layout_engine.py), under which GLAD-S spreads over servers.
FLEETS = {"default": 0.05, "mu2": 2.0}
# The plans, the main one first: GLAD-S on the mu2 fleet, GLAD-S on the
# default fleet, Random.  CUTTING: the plans that must cut links.
LAYOUTS = ("glad_s_mu2", "glad_s", "random")
CUTTING = ("glad_s_mu2", "random")
# evolve: the trace's seed base; its first slot inserts 3 vertices and
# overflows the headroom-free main plan's e_cap (and not its cap or
# halo_cap).
EVOLVE_SEED = 4
EVOLVE_SLOTS = 3
FWD_TOL = 2e-4                 # the reference's own gate (test_distributed_gnn)
# train: steps and learning rate of the check that training lowers the loss
# (the reference's test_training_improves trains at lr 0.1).
TRAIN_STEPS = 20
TRAIN_LR = 0.1
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
# moe_serve: deepseek-moe-16b behind the same engine shape.  The
# teacher-forced pass routes every (position, layer) to the experts serving
# chose, so it computes serving's function and its logits differ by
# rounding alone: every served token is held to SERVE_GAP_TOL.  The
# router's own choice in that pass sees serving's hidden state up to bf16
# rounding, which flips near-ties between the k-th and (k+1)-th expert of
# a near-uniform random router: 2.1% of prompt and 11% of decode pairs on
# an H100 (PERF.md, PR 19 F), at most 18% of one layer's pairs of a kind.
# A wrong router, a misaligned position or a leaking pad changes nearly
# every pair it touches (a random 6 of 64 equals the served set with
# probability 1.3e-8): at most half of each (kind, MoE layer) cell may
# differ, so a fault confined to one layer still shows.  Where rounding
# is 2**-24, the fp32 model's serving and teacher forcing, unforced, may
# differ at no more than 1% of all pairs (moe_route_fp32).
MOE_SLOTS = 8
MOE_MAX_LEN = 2048
MOE_ROUTE_FLIP_SHARE = 0.01
MOE_ROUTE_FLIP_CELL_SHARE = 0.5
# The recurrent families (hybrid_serve: zamba2-1.2b, xlstm_serve:
# xlstm-1.3b) behind lm_serve's engine shape, with its traffic.
# recurrent_fp32 holds each decode step of the fp32 models against the
# teacher-forced forward with the reference's own gate for that identity
# (tests/test_models_zoo.py: rtol = atol = 2e-3).
REC_SLOTS = 8
REC_MAX_LEN = 2048
REC_FP32_TOL = 2e-3
# Each serve phase's graph engine is held against an eager twin serving the
# same requests; xlstm-1.3b's twin serves the 9 shortest prompts (its
# prefill is a host-bound sLSTM loop over the prompt), one more than the
# slots, so a freed slot is taken again.
XLSTM_EAGER_REQUESTS = 9
# Serving's logits against the fp32 model over the same weights (the bf16
# model's function without its activation rounding), beside the bf16
# teacher-forced forward's: bf16 rounding alone moves both about as far
# (on an H100, zamba2 median 0.143 / 0.142, xlstm 1.284 / 1.299 over the
# 512 served positions), so serving's distance may be at most
# REC_NOISE_RATIO times the forward's, at the median and at the largest
# position.  Injected state-path faults move serving alone, to 1.66-30
# times (tools/recurrent_probe.py --phases faults; PERF.md).  xLSTM's bf16
# rounding moves its logits by 1.3 at the median, so lm_serve's per-token
# SERVE_GAP_TOL holds zamba2's tokens only; the exact identity for both is
# recurrent_fp32's.
REC_NOISE_RATIO = 1.25
# The VLM and enc-dec families.  vlm_serve: internvl2-2b behind lm_serve's
# engine shape and traffic (text only, as the reference's engine serves
# it), then one prefill of VLM_PATCHES stub patches in front of a
# VLM_PROMPT-token prompt and VLM_STEPS decode steps through the zoo.
# encdec_serve: the reference's own form of enc-dec serving
# (tests/test_models_zoo.py:65-88), ENCDEC_BATCH utterances of
# frontend_len frames with ENCDEC_PROMPT-token decoder prompts prefilled in
# one batch, then ENCDEC_STEPS decode steps.  zoo_fp32 holds both models'
# decode against teacher forcing in fp32 with the reference's gate for
# that identity (REC_FP32_TOL: tests/test_models_zoo.py:88).
VLM_SLOTS = 8
VLM_MAX_LEN = 2048
VLM_PATCHES = 256
VLM_PROMPT = 512
VLM_STEPS = 16
ENCDEC_BATCH = 8
ENCDEC_PROMPT = 32
ENCDEC_STEPS = 32
# moe_parity: the routed MoE FFN alone in bf16 against the dense oracle,
# relative to max|ref|: both round the expert outputs to bf16 (the oracle
# also its combine), the routed path sums in another order.
MOE_FFN_BF16_TOL = 2e-2
# lm_train: steps on one fixed batch (the loss must fall), and the gate on
# the first moments of 2 microbatches against 1, elementwise as the
# reference's (tests/test_train.py:45: rtol 2e-3, atol 2e-5, for fp32
# compute).  In bf16 each microbatch's gradient rounds to 2**-8 relative,
# and the tied embedding's sums two such terms (the unembedding GEMM's and
# the gather's), so an element may be off by more than one ulp of the sum;
# at the smoke width (tests/test_torch_lm_train.py runs this phase on the
# CPU) the reference's rtol fails there.  rtol is 2 bf16 ulps, atol the
# reference's; the excess over the reference's own rtol is reported.
TRAIN_LM_STEPS = 10
MB_M_RTOL, MB_M_ATOL, MB_M_REF_RTOL = 2 ** -7, 2e-5, 2e-3
# The families' training (moe_train, hybrid_train, vlm_train, encdec_train,
# xlstm_train).  TRAIN_PARITY: the 2-layer (2 + 2) fp32 cut of each, run on
# the card and the CPU, with the config changes that keep every kind of
# layer in it (xLSTM's sLSTM layer; zamba2 at 4 layers, two sites of its
# shared block, so the block's gradient sums over sites) and the sequence
# length (past one SSD chunk of 128 for the recurrent two).
# TRAIN_MAIN: the full-width run (bf16 compute, fp32 parameters, AdamW),
# with its depth cut, sequence length, steps and learning rate: 1e-3, the
# CLI's default, but for zamba2-1.2b, whose loss climbs past step 0's by
# step 8 at 1e-3 in fp32 compute as in bf16 (tools/train_probe.py --phases
# sweep; PERF.md), so 3e-4, OptConfig's default.  deepseek-moe-16b: 1
# dense + MOE_TRAIN_LAYERS MoE layers, the most that leave 10 GB of the
# card free (one more runs out of memory: fp32 weights, gradients and
# AdamW moments take 16 bytes a parameter, 9.4 GB a MoE layer).
# xlstm-1.3b: 4 x 256 tokens and 6 steps: its sLSTM loop is sequential in
# L (256 still spans two SSD chunks) and a step takes ~5.5 s.
MOE_TRAIN_LAYERS = 5
# The mesh phases (mesh_parity, mesh_train, mesh_moe, dryrun): a 1x1
# DeviceMesh over NCCL at world size 1 (the reference's make_debug_mesh on
# one device).  mesh_train: MESH_TRAIN_STEPS steps of llama3.2-1b on 4 x
# 1024 tokens.  mesh_moe: deepseek-moe-16b's capacity moe_ffn on
# MESH_MOE_TOKENS tokens at each of MESH_MOE_FACTORS (2.0: nothing should
# drop; 0.5: about half the assignments drop).  DRYRUN_PINNED: the dry-run
# cells and their per-device argument bytes, the reference dry-run's.
MESH_TRAIN_STEPS = 3
# mesh_serve's meshed eager engine serves the first few of its requests
# (its ticks are host-bound).
MESH_EAGER_REQUESTS = 4
# K2's decode with stats: the cache cut into these many slices.
STATS_SLICES = (1, 2, 4, 16)
MESH_MOE_TOKENS = 4096
MESH_MOE_FACTORS = (2.0, 0.5)
DRYRUN_PINNED = {"llama3.2-1b:train_4k": 243_949_572,
                 "deepseek-moe-16b:prefill_32k": 2_054_082_560}
DRYRUN_WORKERS = 4         # dry-run processes, half a mesh
TRAIN_FAMILY_STEPS = 10
TRAIN_PARITY = {
    "moe_train": ("deepseek-moe-16b", {"n_layers": 2}, 128),
    "hybrid_train": ("zamba2-1.2b", {"n_layers": 4, "attn_every": 2}, 160),
    "vlm_train": ("internvl2-2b", {"n_layers": 2}, 128),
    "encdec_train": ("seamless-m4t-medium",
                     {"n_layers": 2, "n_enc_layers": 2}, 128),
    "xlstm_train": ("xlstm-1.3b", {"n_layers": 2, "slstm_every": 2}, 160),
}
TRAIN_MAIN = {
    "moe_train": ("deepseek-moe-16b", {"n_layers": 1 + MOE_TRAIN_LAYERS},
                  1024, TRAIN_FAMILY_STEPS, 1e-3),
    "hybrid_train": ("zamba2-1.2b", {}, 1024, TRAIN_FAMILY_STEPS, 3e-4),
    "vlm_train": ("internvl2-2b", {}, 1024, TRAIN_FAMILY_STEPS, 1e-3),
    "encdec_train": ("seamless-m4t-medium", {}, 1024, TRAIN_FAMILY_STEPS,
                     1e-3),
    "xlstm_train": ("xlstm-1.3b", {}, 256, 6, 1e-3),
}


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


def host_ms(fn, reps: int = 20, warmup: int = 3) -> dict:
    """Host-clock medians over ``reps`` calls of ``fn``, each started on an
    idle card: ``enqueue`` (until ``fn`` returns) and ``call`` (until the
    card has finished it, a ``synchronize`` after)."""
    for _ in range(warmup):
        fn()
    enqueue, call = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        enqueue.append((t1 - t0) * 1e3)
        call.append((t2 - t0) * 1e3)
    return {"enqueue": statistics.median(enqueue),
            "call": statistics.median(call)}


def _no_host_reads(fn) -> bool:
    """Whether ``fn`` runs with the card's sync debug mode at "error"
    (an op that reads the device from the host raises; the mode is a
    prototype and may miss some).  Off the card: True."""
    if not torch.cuda.is_available():
        fn()
        return True
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError:
        return False
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return True


def _captured(steps) -> dict:
    """The count, capture seconds and pool MB of the captured graphs among
    ``steps`` (Steps, or None for signatures only run eagerly)."""
    done = [s for s in steps if s is not None and s.graph is not None]
    return {"graphs": len(done), "capture_s": sum(s.capture_s for s in done),
            "pool_mb": sum(s.pool_bytes for s in done) / 1e6}


# Windows whose kernels' counts were not whole multiples of the calls, with
# what they held (printed after the kernels phases).
LOST_WINDOWS: list = []


def device_ms(fn, reps: int = 25, warmup: int = 3, tries: int = 3,
              label: str = "", parts: dict = None):
    """Device time per call of ``fn`` from ``torch.profiler``: over ``reps``
    calls, each kernel's mean device time times its launches per call,
    summed (kernels, copies and fills).  Unlike :func:`time_ms` it leaves
    out the host's time to enqueue the call, which a kernel of a few
    microseconds can be shorter than.

    A profiler started right before the calls loses the events of the
    first call (on an H100 under torch 2.11, most windows of 25 calls held
    24 events of every kernel of the first call), so the calls are traced
    as the active step of a schedule after one traced warm-up step, which
    is discarded.  A window
    where a kernel's count is more than one event off a whole number per
    call is recorded in ``LOST_WINDOWS`` and measured again, up to
    ``tries`` times; one event off (also recorded) still gives the mean.
    "not measured" where no window does.  ``parts``, if given, receives
    each device entry's time per call by its name."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(tries):
        traced = []
        with torch.profiler.profile(
                activities=acts,
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                on_trace_ready=lambda p: traced.append(p.key_averages())
        ) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()                        # the warm-up step ends
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()                        # the active step ends
        dev = [e for e in (traced[0] if traced else [])
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]   # the step's span
        per_call = [max(1, round(e.count / reps)) for e in dev]
        off = [abs(e.count - k * reps) for e, k in zip(dev, per_call)]
        if not dev or any(off):
            LOST_WINDOWS.append({"label": label, "try": attempt,
                                 "reps": reps, "device_events": {
                                     e.key[:60]: [e.count,
                                                  e.self_device_time_total]
                                     for e in dev}})
        if dev and max(off) <= 1:
            each = {e.key: e.self_device_time_total / e.count * k / 1e3
                    for e, k in zip(dev, per_call)}
            if parts is not None:
                parts.update(each)
            return sum(each.values())
    return "not measured"


def allclose_err(out, ref, tol: float) -> float:
    """Largest |out - ref| beyond the rtol = atol = tol allowance (<= 0 means
    within tolerance)."""
    diff = (out - ref).abs() - tol * ref.abs()
    return float(diff.max()) if diff.numel() else 0.0


# ------------------------------------------------------------------ phases
CARD = "not read"               # nvidia-smi's name and power limit


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false); this script runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=120)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    global CARD
    CARD = smi_line
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


def _compile(g, cm, assign):
    """The layout's plan with its BSR, and the row that describes it."""
    part = partition_from_assign(g, assign, PARTS, cm.factors(assign))
    t0 = time.perf_counter()
    plan = compile_plan(g, part, slack=SLACK)
    build_plan_bsr(plan)
    host_s = time.perf_counter() - t0
    b = plan.bsr
    nnz = int(np.count_nonzero(b.values))
    return plan, {
        "cost": cm.total(assign), "cut_links": part.cut_links,
        "halo_bytes_ppermute": plan.halo_bytes_ppermute,
        "halo_rows_allgather": plan.halo_rows_allgather,
        "part_sizes": np.bincount(assign, minlength=PARTS).tolist(),
        "cap": plan.cap, "halo_cap": plan.halo_cap, "e_cap": plan.e_cap,
        "rounds": len(plan.rounds), "bsr_nb": b.nb,
        "bsr_max_blocks": b.max_blocks, "bsr_src_rows": b.src_rows,
        "values_mb": b.values.nbytes / 1e6, "nnz": nnz,
        "nnz_density": nnz / b.values.size, "host_compile_s": host_s}


def phase_layout(name: str, dev):
    """The paper's first stage on each fleet: edge network, cost model,
    GLAD-S against the Random and Greedy baselines; then the plans of
    Random and of GLAD-S on each fleet."""
    g = synthetic_siot() if name == "siot" else synthetic_yelp()
    d = gnn_paper.ALL[(name, "gcn")].layer_dims[0]
    fleets, layouts = {}, {}
    for fleet, mu in FLEETS.items():
        net = build_edge_network(g, PARTS, seed=SEED, mu_factor=mu)
        cm = CostModel(net, g, workload_for("gcn", d))
        rand = random_layout(cm, seed=SEED)
        t0 = time.perf_counter()
        res = glad_s(cm, seed=SEED)
        glad_s_s = time.perf_counter() - t0
        costs = {"random": cm.total(rand),
                 "greedy": cm.total(greedy_layout(cm)), "glad_s": res.cost}
        require(np.isfinite(list(costs.values())).all(),
                f"{name} {fleet}: non-finite layout cost {costs}")
        require(res.cost < costs["random"], f"{name} {fleet}: GLAD-S cost "
                f"{res.cost} not below the Random layout's {costs['random']}")
        fleets[fleet] = {"mu_factor": mu, "costs": costs,
                         "glad_s_iterations": res.iterations,
                         "glad_s_host_s": glad_s_s,
                         "glad_s_factors": res.factors}
        key = "glad_s" if fleet == "default" else f"glad_s_{fleet}"
        layouts[key] = {"cm": cm, "assign": res.assign.copy()}
        if fleet == "default":
            layouts["random"] = {"cm": cm, "assign": rand}
    rows = {}
    for key in LAYOUTS:
        lay = layouts[key]
        lay["plan"], rows[key] = _compile(g, lay["cm"],
                                          lay["assign"].copy())
    for key in CUTTING:
        require(rows[key]["cut_links"] > 0 and rows[key]["rounds"] > 0,
                f"{name} {key}: the plan cuts no link or has no ppermute "
                f"round ({rows[key]['cut_links']}, {rows[key]['rounds']})")
    emit({"phase": "layout", "dataset": name, "n": g.n,
          "links": g.num_edges, "parts": PARTS, "fleets": fleets,
          "plans": rows})
    feats = torch.from_numpy(g.features).to(dev)
    sd = torch.from_numpy(directed_edges(g.edges)).to(dev)
    return {"name": name, "graph": g, "layouts": layouts, "feats": feats,
            "sd": sd}


def _random_graph(rng, n, extra):
    edges = [(rng.integers(0, v), v) for v in range(1, n)]
    for _ in range(extra):
        u, v = rng.integers(0, n, size=2)
        if u != v:
            edges.append((min(u, v), max(u, v)))
    return DataGraph(n=n, edges=np.array(edges))


def _library_csr(values: np.ndarray, cols: np.ndarray, src_rows: int, dev,
                 transpose: bool = False):
    """The batched block-diagonal adjacency of a BSR (or its transpose) as
    one CSR tensor on ``dev``, its nonzero count, and the scipy matrix it
    was made from (read off the dense ``values``)."""
    P, nbm, bm, bk = values.shape
    nb, maxb = cols.shape[1], cols.shape[2]
    p, blk, r, k = np.nonzero(values)
    i, j = blk // maxb, blk % maxb
    rows = p * (nb * bm) + i * bm + r
    cidx = p * src_rows + cols[p, i, j].astype(np.int64) * bk + k
    a = sp.csr_matrix((values[p, blk, r, k], (rows, cidx)),
                      shape=(P * nb * bm, P * src_rows))
    if transpose:
        a = a.T.tocsr()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
        csr = torch.sparse_csr_tensor(
            torch.from_numpy(a.indptr.astype(np.int64)),
            torch.from_numpy(a.indices.astype(np.int64)),
            torch.from_numpy(a.data.astype(np.float32)),
            size=a.shape, device=dev, check_invariants=True)
    return csr, int(a.nnz), a


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


def _k1_stats(label, packed, feats, out, lib_a, nnz, dev):
    """K1 on ``packed`` x ``feats`` (its result ``out``) beside its plain
    version and the library product ``lib_a`` @ feats: times, device
    times, and the bound from the bytes and operations these nonzeros
    need: each entry's weight and column, the row pointers, each feature
    row that an entry reads (once), the output (once)."""
    P, rows, d = feats.shape
    flat = feats.reshape(P * rows, d)
    lib_out = torch.sparse.mm(lib_a, flat).reshape(out.shape)
    lib_err = float((lib_out - out).abs().max())
    require(lib_err <= 1e-4 * float(out.abs().max()) + 1e-4,
            f"{label}: library product disagrees with spmm_csr: {lib_err}")
    live = (torch.arange(packed.nnz_cap, device=dev)[None, :]
            < packed.row_ptr[:, -1:])
    part = torch.arange(P, device=dev)[:, None]
    rows_read = int(torch.unique((part * rows + packed.col)[live]).numel())
    nbytes = (nnz * 8 + packed.row_ptr.numel() * 4 + rows_read * d * 4
              + out.numel() * 4)
    ops = 2 * nnz * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    counts = (packed.row_ptr[:, 1:] - packed.row_ptr[:, :-1])
    return {
        "ms": time_ms(lambda: spmm_packed(packed, feats)),
        "device_ms": device_ms(lambda: spmm_packed(packed, feats),
                               label=label),
        "plain_ms": time_ms(lambda: spmm_packed_plain(packed, feats)),
        "library_ms": time_ms(lambda: torch.sparse.mm(lib_a, flat)),
        "library_device_ms": device_ms(
            lambda: torch.sparse.mm(lib_a, flat), label=label + " library"),
        "library_call": "torch.sparse.mm(sparse_csr_tensor, feats)",
        "bytes": nbytes, "ops": ops, "nnz": nnz,
        "feature_rows_read": rows_read, "feature_rows": P * rows,
        "max_row_nnz": int(counts.max()),
        "empty_rows": int((counts == 0).sum()),
        "rows": int(counts.numel()),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def _faster(row):
    row["faster_than_library"] = row["ms"] < row["library_ms"]
    row["faster_than_library_on_device"] = (
        isinstance(row["device_ms"], float)
        and isinstance(row["library_device_ms"], float)
        and row["device_ms"] < row["library_device_ms"])
    return row


def _k1_row(ds, layout, d, gen, dev):
    """K1 over ``layout``'s plan of ``ds`` at width ``d`` against its plain
    versions and the library product: errors, times and the bound."""
    plan = ds["layouts"][layout]["plan"]
    b, dense = plan.bsr, layout == "random"
    t0 = time.perf_counter()
    host = pack_bsr(b.values, b.block_cols, b.bm, b.bk, nnz_cap=plan.e_cap)
    pack_s = time.perf_counter() - t0
    packed = dataclasses.replace(host.to(dev), src_rows=b.src_rows)
    lib_a, nnz, _ = _library_csr(b.values, b.block_cols, b.src_rows, dev)
    require(nnz == int(host.row_ptr[:, -1].sum()),
            f"{ds['name']}: packed nonzeros != the library CSR's {nnz}")
    feats = torch.randn((PARTS, b.src_rows, d), generator=gen).to(dev)
    label = f"{ds['name']}_{layout}_P{PARTS}_d{d}"
    refs = {"spmm_packed_plain": spmm_packed_plain(packed, feats)}
    if dense:
        values = torch.from_numpy(b.values).to(dev)
        cols = torch.from_numpy(b.block_cols).to(dev)
        refs["spmm_plain"] = spmm_plain(values, cols, feats, b.bm, b.bk)
    out, errs = _check_k1(label, lambda: spmm_packed(packed, feats), refs)
    err = errs["spmm_packed_plain"]
    dense_err = errs.get("spmm_plain", "not measured")
    # The dense values' bytes stay beside the bound as the earlier
    # yardstick.
    dense_bytes = (b.values.size * 4 + b.block_cols.size * 4
                   + feats.numel() * 4 + out.numel() * 4)
    row = {"shape": label, "max_abs_err": err, "dense_max_abs_err": dense_err,
           "bitwise_equal": True,
           **_k1_stats(label, packed, feats, out, lib_a, nnz, dev),
           "dense_plain_ms": (time_ms(
               lambda: spmm_plain(values, cols, feats, b.bm, b.bk))
               if dense else "not measured"),
           "pack_s": pack_s}
    row["dense_values_bound_ms"] = max(
        dense_bytes / HBM_BYTES_PER_S * 1e3, row["ops"] / FP32_OPS_PER_S * 1e3)
    row["worst"] = max([err] + ([dense_err] if dense else []))
    return _faster(row)


def _k1_bwd_row(ds, d, gen, dev):
    """K1's backward over the main plan of ``ds`` at width ``d``: Aᵀ·g, the
    kernel over the transposed operand, against the plain product over it,
    autograd of the plain forward (an index_add over A's own entries,
    which does not read the transpose) and Aᵀ·g in fp64 on the host with
    Aᵀ read off the dense BSR values by scipy; bit for bit across two
    launches and equal to what autograd's backward through K1 launches;
    times, bound, and torch.sparse.mm on the transposed CSR."""
    plan = ds["layouts"]["glad_s_mu2"]["plan"]
    b = plan.bsr
    host = pack_bsr(b.values, b.block_cols, b.bm, b.bk, nnz_cap=plan.e_cap)
    t0 = time.perf_counter()
    host_t = transpose_packed(host, b.src_rows)
    transpose_s = time.perf_counter() - t0
    packed = dataclasses.replace(host.to(dev), src_rows=b.src_rows)
    packed_t = host_t.to(dev)
    lib_at, nnz, dense_t = _library_csr(b.values, b.block_cols, b.src_rows,
                                        dev, transpose=True)
    require(nnz == int(host_t.row_ptr[:, -1].sum()),
            f"{ds['name']}: transposed nonzeros != the library CSR's {nnz}")
    label = f"{ds['name']}_glad_s_mu2_P{PARTS}_d{d}_bwd"
    g = torch.randn((PARTS, host.n_rows, d), generator=gen).to(dev)
    x = torch.randn((PARTS, b.src_rows, d), generator=gen).to(dev)
    xg = x.clone().requires_grad_(True)
    through_autograd, = torch.autograd.grad(
        spmm_packed(packed, xg, packed_t), xg, g)
    xp = x.clone().requires_grad_(True)
    plain_autograd, = torch.autograd.grad(spmm_packed_plain(packed, xp),
                                          xp, g)
    dense = dense_t @ g.reshape(-1, d).cpu().double().numpy()
    out, errs = _check_k1(label, lambda: spmm_packed(packed_t, g), {
        "spmm_packed_plain": spmm_packed_plain(packed_t, g),
        "autograd_plain": plain_autograd,
        "dense_values": torch.from_numpy(dense).float().reshape(
            PARTS, b.src_rows, d).to(dev)})
    require(torch.equal(through_autograd, out),
            f"{label}: autograd's backward through spmm_packed != the "
            "kernel over the transposed operand")
    row = {"shape": label, "max_abs_err": errs["spmm_packed_plain"],
           "autograd_plain_max_abs_err": errs["autograd_plain"],
           "dense_max_abs_err": errs["dense_values"],
           "bitwise_equal": True,
           **_k1_stats(label, packed_t, g, out, lib_at, nnz, dev),
           "transpose_s": transpose_s}
    row["library_call"] = "torch.sparse.mm(transposed sparse_csr_tensor, g)"
    row["worst"] = max(errs.values())
    return _faster(row)


def phase_kernels(datasets, dev):
    """K1 (spmm_csr on the packed BSR) against its plain versions; times at
    the main path's shapes (SIoT's two layer widths, Yelp's first) over
    each plan: the main plan's rows first, the Random plan's (the shapes
    of earlier runs) last.  The dense layout's plain version runs on the
    Random plans only: over a GLAD-S plan its gathered operand (every
    stored block's feature tile) would take tens of GB.  K1's backward
    (the kernel over the transposed operand) at the main plans' shapes."""
    gen = torch.Generator().manual_seed(SEED)
    results, bwd_rows, worst = [], [], 0.0
    siot, yelp = datasets
    for layout in LAYOUTS:
        for ds, d in ((siot, 52), (siot, 16), (yelp, 100)):
            row = _k1_row(ds, layout, d, gen, dev)
            worst = max(worst, row.pop("worst"))
            results.append(row)
            emit({"phase": "kernels", "kernel": "spmm_csr", **row})
    for ds, d in ((siot, 52), (siot, 16), (yelp, 100)):
        row = _k1_bwd_row(ds, d, gen, dev)
        worst = max(worst, row.pop("worst"))
        bwd_rows.append(row)
        emit({"phase": "kernels", "kernel": "spmm_csr_backward", **row})
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
    return results, bwd_rows, worst


def phase_bsp(datasets, dev):
    """Main path: the BSP forward at paper width over each plan, both
    exchanges, against the whole-graph forward on the card and the CPU.
    The forward is the default one, captured (one CUDA graph, replayed);
    each case's ``bsp_graph`` line holds it against the eager forward."""
    params_of = {}
    for ds in datasets:
        g = ds["graph"]
        for model in ("gcn", "sage", "gat"):
            cfg = gnn_paper.ALL[(ds["name"], model)]
            params = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
            params_of[(ds["name"], model)] = params
            ref = forward(cfg, params, ds["feats"], ds["sd"]).cpu()
            cpu_params = [{k: v.cpu() for k, v in p.items()} for p in params]
            ref_cpu = forward(cfg, cpu_params, ds["feats"].cpu(),
                              ds["sd"].cpu())
            cpu_err = allclose_err(ref, ref_cpu, FWD_TOL)
            require(cpu_err <= FWD_TOL, f"{ds['name']} {model}: whole-graph "
                    f"forward on the card vs the CPU: {cpu_err}")
            for layout in LAYOUTS:
                plan = ds["layouts"][layout]["plan"]
                blocks = torch.from_numpy(
                    scatter_features(plan, g.features)).to(dev)
                for exchange in ("ppermute", "allgather"):
                    label = f"{ds['name']} {layout} {model} {exchange}"
                    fwd = make_bsp_forward(cfg, plan, exchange=exchange,
                                           device=dev)
                    require(fwd.graphs is (dev.type == "cuda"),
                            f"{label}: the forward on {dev} resolved graphs "
                            f"to {fwd.graphs}")
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
                            f"{label}: dense BSR values resident")
                    want = cfg.num_layers if model in ("gcn", "sage") else 0
                    require(launched == want, f"{label}: {launched} spmm_csr "
                            f"launches, expected {want}")
                    full = torch.from_numpy(
                        gather_outputs(plan, out.cpu().numpy(), g.n))
                    err = allclose_err(full, ref, FWD_TOL)
                    require(err <= FWD_TOL, f"{label}: BSP forward vs "
                            f"whole-graph forward: {err}")
                    ms = time_ms(lambda: fwd(params, blocks), reps=20)
                    emit({"phase": "bsp", "dataset": ds["name"],
                          "layout": layout, "model": model,
                          "exchange": exchange, "aggregate": fwd.mode,
                          "rounds": len(plan.rounds),
                          "halo_rows": (plan.halo_bytes_ppermute
                                        if exchange == "ppermute"
                                        else plan.halo_rows_allgather),
                          "spmm_launches": launched, "allclose_excess": err,
                          "max_abs_err": float((full - ref).abs().max()),
                          "card_vs_cpu_excess": cpu_err, "forward_ms": ms,
                          "plan_tensor_mb": sum(
                              t.numel() * t.element_size()
                              for t in resident.values()) / 1e6,
                          "forward_peak_mb": peak_mb})
                    _bsp_graph(fwd, cfg, plan, params, blocks, out, want,
                               label, {"dataset": ds["name"],
                                       "layout": layout, "model": model,
                                       "exchange": exchange}, dev)
    return params_of


def _bsp_graph(fwd, cfg, plan, params, blocks, out, want, label, key, dev):
    """The captured forward ``fwd`` (already called once: run eagerly,
    then captured) against an eager forward over the same plan: a replay
    and the first call bit-equal to it, one trace and one build, ``want``
    K1 launches a replay; host ms both ways, device ms, capture seconds
    and pool MB."""
    eager = make_bsp_forward(cfg, plan, exchange=key["exchange"],
                             device=dev, graphs=False)
    expect = eager(params, blocks)
    before = spmm.launches
    replay = fwd(params, blocks)
    torch.cuda.synchronize()
    per_replay = spmm.launches - before
    equal = torch.equal(replay, expect) and torch.equal(out, expect)
    quiet = _no_host_reads(lambda: eager.eager(params, blocks))
    row = {"phase": "bsp_graph", **key, "aggregate": fwd.mode,
           "bit_equal_to_eager": equal, "eager_no_host_reads": quiet,
           "traces": fwd.stats["traces"],
           "builds": fwd.stats["builds"],
           "spmm_launches_per_replay": per_replay,
           "host_ms": {"graph": host_ms(lambda: fwd(params, blocks),
                                        reps=10, warmup=1),
                       "eager": host_ms(lambda: eager(params, blocks),
                                        reps=10, warmup=1)},
           "device_ms": {
               "graph": device_ms(lambda: fwd(params, blocks), reps=5,
                                  warmup=1, label=f"{label} graph"),
               "eager": device_ms(lambda: eager(params, blocks), reps=5,
                                  warmup=1, label=f"{label} eager")},
           **_captured(fwd.steps.values())}
    emit(row)
    require(equal, f"{label}: the captured forward != the eager forward, "
            "bit for bit")
    require(quiet, f"{label}: the eager forward reads the card from the "
            "host")
    require(fwd.stats["traces"] == fwd.stats["builds"] == 1,
            f"{label}: {fwd.stats['traces']} traces, "
            f"{fwd.stats['builds']} builds")
    require(per_replay == want, f"{label}: {per_replay} spmm_csr launches "
            f"a replay, expected {want}")


def _grad_excess(grads, ref):
    """Largest |g - ref| over each leaf's 2e-4 * max|ref| allowance (<= 0:
    within), with the largest |g - ref|."""
    excess, err = -np.inf, 0.0
    for layer, ref_layer in zip(grads, ref):
        for k, g in layer.items():
            diff = float((g.cpu() - ref_layer[k]).abs().max())
            scale = float(ref_layer[k].abs().max())
            excess = max(excess, diff - FWD_TOL * scale)
            err = max(err, diff)
    return excess, err


def _equal_trees(a, b) -> bool:
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def _train_setup(plan, g, dev):
    blocks = torch.from_numpy(scatter_features(plan, g.features)).to(dev)
    return (blocks, scatter_ints(plan, g.labels),
            scatter_ints(plan, np.ones(g.n, np.float32)))


def phase_train(datasets, dev):
    """The distributed train step over the main plans (GLAD-S, mu_factor
    2.0) of SIoT and Yelp: GCN, SAGE and GAT under both exchanges with
    aggregate 'auto' (K1 both ways for GCN/SAGE), and GCN/SAGE also on the
    segment path.  Gradients within 2e-4 * max|ref| of the CPU whole-graph
    loss_fn's (mask: every vertex), bit-equal run to run, K1's launches per
    step exact, 20 steps lowering the loss, a checkpoint of the trained
    parameters restored bit for bit; then a value-only patch of a copy of
    SIoT's main plan (train step bit-equal to a fresh plan's, 0
    rebuilds)."""
    rows = {}
    for ds in datasets:
        g = ds["graph"]
        plan = ds["layouts"]["glad_s_mu2"]["plan"]
        blocks, labels_b, mask_b = _train_setup(plan, g, dev)
        sd = directed_edges(g.edges)
        for model in ("gcn", "sage", "gat"):
            cfg = gnn_paper.ALL[(ds["name"], model)]
            params = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
            cpu_params = [{k: v.cpu() for k, v in p.items()} for p in params]
            t0 = time.perf_counter()
            ref_loss, ref = loss_and_grads(cfg, cpu_params, g.features, sd,
                                           g.labels, device="cpu")
            cpu_s = time.perf_counter() - t0
            aggs = ("auto",) if model == "gat" else ("auto", "segment")
            for exchange in ("ppermute", "allgather"):
                for agg in aggs:
                    label = f"train {ds['name']} {model} {exchange} {agg}"
                    fwd = make_bsp_forward(cfg, plan, exchange=exchange,
                                           aggregate=agg, device=dev)
                    step = make_distributed_train_step(
                        cfg, fwd, labels_b, mask_b, lr=TRAIN_LR)
                    eager = make_distributed_train_step(
                        cfg, make_bsp_forward(cfg, plan, exchange=exchange,
                                              aggregate=agg, device=dev,
                                              graphs=False),
                        labels_b, mask_b, lr=TRAIN_LR)
                    require(step.graphs is (dev.type == "cuda")
                            and not eager.graphs, f"{label}: the step on "
                            f"{dev} resolved graphs to {step.graphs}")
                    before = dict(spmm.launches_by_dir)
                    loss, grads = step.loss_and_grads(params, blocks)
                    loss2, grads2 = step.loss_and_grads(params, blocks)
                    new, _ = step(params, blocks)
                    new2, _ = step(params, blocks)
                    torch.cuda.synchronize()
                    got = {k: spmm.launches_by_dir[k] - before[k]
                           for k in before}
                    L = cfg.num_layers
                    want = ({"fwd": 4 * L, "bwd": 4 * (L - 1)}
                            if fwd.mode == "bsr" else {"fwd": 0, "bwd": 0})
                    require(fwd.mode == ("bsr" if agg == "auto"
                                         and model != "gat" else "segment"),
                            f"{label}: aggregate resolved to {fwd.mode}")
                    require(got == want, f"{label}: spmm_csr launches "
                            f"{got} over 4 steps, expected {want}")
                    require(torch.equal(loss, loss2)
                            and _equal_trees(grads, grads2)
                            and _equal_trees(new, new2),
                            f"{label}: not bitwise equal run to run")
                    excess, err = _grad_excess(grads, ref)
                    loss_err = abs(float(loss) - float(ref_loss))
                    eager(params, blocks)     # its plan tensors, uploaded
                    require(excess <= 0 and loss_err
                            <= FWD_TOL * abs(float(ref_loss)),
                            f"{label}: gradients vs the CPU whole-graph "
                            f"gradients: excess {excess}, loss {loss_err}")
                    row = {"phase": "train", "dataset": ds["name"],
                           "model": model, "exchange": exchange,
                           "aggregate": fwd.mode, "loss": float(loss),
                           "loss_err": loss_err, "grad_max_abs_err": err,
                           "grad_excess": excess, "bitwise_equal": True,
                           "spmm_launches_4_steps": got,
                           "eager_step_no_host_reads": _no_host_reads(
                               lambda: eager(params, blocks)),
                           "step_ms": time_ms(lambda: step(params, blocks),
                                              reps=10, warmup=2),
                           "step_host_ms": {
                               "graph": host_ms(lambda: step(params, blocks),
                                                reps=10, warmup=1),
                               "eager": host_ms(
                                   lambda: eager(params, blocks), reps=10,
                                   warmup=1)},
                           "step_device_ms": device_ms(
                               lambda: step(params, blocks), reps=5,
                               warmup=1, label=label),
                           "eager_step_device_ms": device_ms(
                               lambda: eager(params, blocks), reps=5,
                               warmup=1, label=f"{label} eager"),
                           **{f"step_{k}": v for k, v in _captured(
                               step.steps.values()).items()},
                           "forward_ms": time_ms(
                               lambda: fwd(params, blocks), reps=10,
                               warmup=2),
                           "cpu_whole_graph_grad_s": cpu_s}
                    row["device_busy_share"] = (
                        row["step_device_ms"] / row["step_ms"]
                        if isinstance(row["step_device_ms"], float)
                        else "not measured")
                    require(row["eager_step_no_host_reads"],
                            f"{label}: the eager step reads the card from "
                            "the host")
                    if agg == "auto":
                        row.update(_train_and_checkpoint(step, params,
                                                         blocks, label,
                                                         eager))
                    rows[(ds["name"], model, exchange, fwd.mode)] = row
                    emit(row)
    _train_patch(datasets[0], dev)
    return rows


def phase_whole_graph(datasets, dev):
    """The whole-graph GNN ``train_step`` and ``predict`` (the reference's
    jitted ones) over the six paper configs on the full graphs: TRAIN_STEPS
    steps at TRAIN_LR from a CUDA graph bit-equal to TRAIN_STEPS eager
    ones (``graphs=False``) and lowering the loss; a replay over a
    permuted edge list (same shape) bit-equal to the eager step over it;
    ``predict`` from a graph equal to eager ``predict`` on both lists; one
    build a signature; the eager step free of host reads.  Host ms
    (enqueue, call) and device ms both ways, capture s, pool MB."""
    for ds in datasets:
        g, feats, sd = ds["graph"], ds["feats"], ds["sd"].long()
        labels = torch.from_numpy(g.labels).to(dev).long()
        perm = sd[torch.randperm(sd.shape[0], generator=torch.Generator(
            ).manual_seed(SEED)).to(dev)]
        for model in ("gcn", "sage", "gat"):
            cfg = gnn_paper.ALL[(ds["name"], model)]
            label = f"whole_graph {ds['name']} {model}"
            params = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
            whole_train_step.steps.clear()
            predict.steps.clear()

            def run(p, edges=sd, graphs=None):
                return whole_train_step(cfg, p, feats, edges, labels,
                                        TRAIN_LR, device=dev, graphs=graphs)

            p, q, losses, same = params, params, [], True
            for _ in range(TRAIN_STEPS):
                p, loss = run(p)
                q, want = run(q, graphs=False)
                same &= bool(torch.equal(loss, want)) and _equal_trees(p, q)
                losses.append(float(loss))
            require(same, f"{label}: {TRAIN_STEPS} steps from a graph != "
                    f"{TRAIN_STEPS} eager steps, bit for bit")
            require(np.isfinite(losses).all() and losses[-1] < losses[0],
                    f"{label}: {TRAIN_STEPS} steps at lr {TRAIN_LR} did not "
                    f"lower the loss: {losses[0]} -> {losses[-1]}")
            (p2, lp), (q2, lq) = run(p, perm), run(q, perm, False)
            require(torch.equal(lp, lq) and _equal_trees(p2, q2),
                    f"{label}: the replay over a permuted edge list != the "
                    "eager step over it")
            for edges in (sd, perm):
                require(torch.equal(predict(cfg, p, feats, edges),
                                    predict(cfg, p, feats, edges,
                                            graphs=False)),
                        f"{label}: predict from a graph != eager predict")
            built = {name: _captured(f.steps.values()) for name, f in (
                ("train_step", whole_train_step), ("predict", predict))}
            require(all(b["graphs"] == int(dev.type == "cuda")
                        for b in built.values())
                    and len(whole_train_step.steps) == len(predict.steps)
                    == 1 + (dev.type == "cuda"),
                    f"{label}: not one build a signature: {built}")
            row = {"phase": "whole_graph", "dataset": ds["name"],
                   "model": model, "n": g.n, "arcs": int(sd.shape[0]),
                   "train_losses": [losses[0], losses[-1]],
                   "steps_bit_equal_to_eager": TRAIN_STEPS,
                   "permuted_edges_bit_equal": True,
                   "predict_equal_to_eager": True,
                   "eager_step_no_host_reads": _no_host_reads(
                       lambda: run(q, graphs=False)),
                   "step_host_ms": {
                       "graph": host_ms(lambda: run(p), reps=10, warmup=1),
                       "eager": host_ms(lambda: run(q, graphs=False),
                                        reps=10, warmup=1)},
                   "step_device_ms": device_ms(lambda: run(p), reps=5,
                                               warmup=1, label=label),
                   "eager_step_device_ms": device_ms(
                       lambda: run(q, graphs=False), reps=5, warmup=1,
                       label=f"{label} eager"),
                   "predict_host_ms": {
                       "graph": host_ms(lambda: predict(cfg, p, feats, sd),
                                        reps=10, warmup=1),
                       "eager": host_ms(lambda: predict(
                           cfg, p, feats, sd, graphs=False), reps=10,
                           warmup=1)},
                   **{f"{name}_{k}": v for name, b in built.items()
                      for k, v in b.items()}}
            require(row["eager_step_no_host_reads"],
                    f"{label}: the eager step reads the card from the host")
            emit(row)
    whole_train_step.steps.clear()
    predict.steps.clear()


def _steps_equal(step, eager, params, blocks, n: int = TRAIN_STEPS):
    """``n`` steps of the captured ``step`` and of ``eager`` from
    ``params``: whether every loss and the last parameters are bit-equal,
    the captured run's losses and last parameters."""
    losses, p, q, same = [], params, params, True
    for _ in range(n):
        p, loss = step(p, blocks)
        q, want = eager(q, blocks)
        same &= bool(torch.equal(loss, want))
        losses.append(float(loss))
    return same and _equal_trees(p, q), losses, p


def _train_and_checkpoint(step, params, blocks, label, eager):
    """TRAIN_STEPS captured steps at TRAIN_LR lower the loss and are
    bit-equal to TRAIN_STEPS eager ones; the trained parameters survive a
    checkpoint (async write) bit for bit, on the card."""
    same, losses, p = _steps_equal(step, eager, params, blocks)
    require(same, f"{label}: {TRAIN_STEPS} captured steps != "
            f"{TRAIN_STEPS} eager steps, bit for bit")
    require(np.isfinite(losses).all() and losses[-1] < losses[0],
            f"{label}: {TRAIN_STEPS} steps at lr {TRAIN_LR} did not lower "
            f"the loss: {losses[0]} -> {losses[-1]}")
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, keep=1)
        ck.save(TRAIN_STEPS, {"params": p})
        ck.wait()
        restored, manifest = ck.restore(TRAIN_STEPS, {"params": params})
    back = restored["params"]
    require(manifest["step"] == TRAIN_STEPS and _equal_trees(back, p)
            and all(v.device == blocks.device for x in back
                    for v in x.values()),
            f"{label}: checkpoint round trip not bit-equal on the card")
    return {"train_losses": [losses[0], losses[-1]],
            "steps_bit_equal_to_eager": TRAIN_STEPS,
            "checkpoint_bit_equal": True}


def _train_patch(siot, dev):
    """A value-only patch of a copy of SIoT's main plan under captured
    train steps (GCN and SAGE on K1 both ways, GAT on the segment path):
    each step, captured before the patch, replays after it (the same
    graph, its targets moved by ``set_targets``) and reads the resident
    plan tensors and the transposed operand, refreshed in place with 0
    rebuilds; its loss and gradients equal a fresh plan's bit for bit, and
    TRAIN_STEPS replays equal TRAIN_STEPS eager steps over the fresh plan.
    As in ``patch``: 2% of the vertices moved off the plan (which grows
    it), then back (value-only)."""
    g, main = siot["graph"], siot["layouts"]["glad_s_mu2"]["plan"]
    plan = recompile_like(main, g, main.assign)
    rng = np.random.default_rng(SEED + 1)
    k = g.n // 50
    movers = rng.choice(g.n, size=k, replace=False)
    home = plan.assign.copy()
    off = home.copy()
    off[movers] = (off[movers] + rng.integers(1, PARTS, size=k)) % PARTS
    patch_plan(plan, g, off)
    models = {}
    for model in ("gcn", "sage", "gat"):
        cfg = gnn_paper.ALL[("siot", model)]
        params = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
        fwd = make_bsp_forward(cfg, plan, device=dev)
        blocks, labels_b, mask_b = _train_setup(plan, g, dev)
        step = make_distributed_train_step(cfg, fwd, labels_b, mask_b,
                                           lr=TRAIN_LR)
        step(params, blocks)                  # run, then captured
        models[model] = (cfg, params, fwd, step)
    t0 = time.perf_counter()
    delta = patch_plan(plan, g, home)
    patch_s = time.perf_counter() - t0
    require(not delta.retrace_expected,
            f"train: the relayout back overflowed the plan: {delta.grew}")
    fresh = recompile_like(plan, g, home)
    out = {}
    for model, (cfg, params, fwd, step) in models.items():
        ops = fwd.stats["ops"]
        graph = list(step.steps.values())
        blocks, labels_b, mask_b = _train_setup(plan, g, dev)
        step.set_targets(labels_b, mask_b)
        f_blocks, f_labels, f_mask = _train_setup(fresh, g, dev)
        ref = make_distributed_train_step(
            cfg, make_bsp_forward(cfg, fresh, device=dev, graphs=False),
            f_labels, f_mask, lr=TRAIN_LR)
        la, ga = step.loss_and_grads(params, blocks)
        lb, gb = ref.loss_and_grads(params, f_blocks)
        pa, pb = step(params, blocks)[0], ref(params, f_blocks)[0]
        require(fwd.stats["builds"] == 1 and fwd.stats["ops"] is ops,
                f"train patch {model}: {fwd.stats['builds']} builds")
        require(list(step.steps.values()) == graph
                and len(graph) == int(dev.type == "cuda")
                and all(st.graph is not None for st in graph),
                f"train patch {model}: the step was captured again after "
                "a value-only patch")
        require(torch.equal(la, lb) and _equal_trees(ga, gb)
                and _equal_trees(pa, pb),
                f"train patch {model}: the patched plan's step != a fresh "
                "plan's, bit for bit")
        same, _, _ = _steps_equal(step, ref, params, blocks)
        require(same, f"train patch {model}: {TRAIN_STEPS} replays over "
                f"the patched plan != {TRAIN_STEPS} eager steps over a "
                "fresh plan's, bit for bit")
        out[model] = {"aggregate": fwd.mode, "builds": fwd.stats["builds"],
                      "traces": fwd.stats["traces"],
                      "steps_bit_equal_to_fresh_eager": TRAIN_STEPS}
    emit({"phase": "train_patch", "moved": int(len(delta.moved)),
          "host_patch_s": patch_s, "models": out, "bit_equal_to_fresh": True})


def _k2_differentiates(dev):
    """K2 under grad, through q, k or v alone: its gradient matches the
    plain backward's, and the call launched the forward kernel once and each
    backward kernel once."""
    gen = torch.Generator(dev).manual_seed(SEED)
    q, k, v = (torch.randn((1, 4, 8, 64), generator=gen, device=dev)
               for _ in range(3))
    dout = torch.randn((1, 4, 8, 64), generator=gen, device=dev)
    ref = flash_attention_bwd_plain(q, k, v, flash_attention_plain(q, k, v),
                                    dout)
    errs = []
    for i in range(3):
        args = [q, k, v]
        args[i] = args[i].clone().requires_grad_(True)
        fwd = flash_attention.launches
        bwd = dict(flash_attention.backward_launches)
        g, = torch.autograd.grad(flash_attention(*args), args[i], dout)
        torch.cuda.synchronize()
        require(flash_attention.launches == fwd + 1
                and flash_attention.backward_launches == {
                    key: n + 1 for key, n in bwd.items()},
                "K2 under grad: launches off by kernel")
        err = float((g - ref[i]).abs().max())
        require(err <= 1e-4 * float(ref[i].abs().max()) + 1e-5,
                f"K2's gradient of {'qkv'[i]} vs the plain backward: {err}")
        errs.append(err)
    emit({"phase": "train_k2_grad", "max_abs_err": errs})


def _relayout(plan, g, new, fwds, params_of, dev, label):
    """Patch ``plan`` to ``new`` in place and run each captured forward
    over it twice: patched == fresh compile, rebuilds and new traces
    exactly as ``retrace_expected`` says, and both outputs (the second a
    replay) bit-equal to a fresh plan's eager forward.  Returns the delta,
    the host patch seconds and each model's first-forward seconds."""
    builds = {m: f.stats["builds"] for m, f in fwds.items()}
    traces = {m: f.stats["traces"] for m, f in fwds.items()}
    t0 = time.perf_counter()
    delta = patch_plan(plan, g, new)
    patch_s = time.perf_counter() - t0
    fresh = recompile_like(plan, g, new)
    require(plans_equal(plan, fresh) == [],
            f"{label}: patched plan != fresh compile")
    blocks = torch.from_numpy(scatter_features(plan, g.features)).to(dev)
    refresh_s = {}
    for m, fwd in fwds.items():
        cfg, params = gnn_paper.ALL[("siot", m)], params_of[("siot", m)]
        t0 = time.perf_counter()
        out = fwd(params, blocks)     # refreshes; the first one repacks
        torch.cuda.synchronize()
        refresh_s[m] = time.perf_counter() - t0
        replay = fwd(params, blocks)
        rebuilt = fwd.stats["builds"] - builds[m]
        traced = fwd.stats["traces"] - traces[m]
        require(rebuilt == traced == int(delta.retrace_expected),
                f"{label} {m}: {rebuilt} rebuilds and {traced} traces, "
                f"retrace_expected {delta.retrace_expected} ({delta.grew})")
        fresh_fwd = make_bsp_forward(cfg, fresh, exchange="ppermute",
                                     device=dev, graphs=False)
        want = fresh_fwd(params, blocks)
        require(torch.equal(out, want) and torch.equal(replay, want),
                f"{label} {m}: patched forward != fresh plan's forward, "
                "bit for bit")
    return delta, patch_s, refresh_s


def phase_patch(siot, params_of, dev):
    """On the main plan: a 2% relayout off it, the relayout back to it
    (value-only: no rebuild), then a capacity overflow (one rebuild).  The
    first step grows the plan: GLAD-S leaves few halo rows, and a random 2%
    moves many more across servers than its halo_cap holds."""
    g, plan = siot["graph"], siot["layouts"]["glad_s_mu2"]["plan"]
    fwds = {m: make_bsp_forward(gnn_paper.ALL[("siot", m)], plan,
                                exchange="ppermute", device=dev)
            for m in ("gcn", "sage")}
    for m, fwd in fwds.items():
        fwd(params_of[("siot", m)],
            torch.from_numpy(scatter_features(plan, g.features)).to(dev))
    rng = np.random.default_rng(SEED + 1)
    k = g.n // 50
    movers = rng.choice(g.n, size=k, replace=False)
    home = plan.assign.copy()
    off = home.copy()
    off[movers] = (off[movers] + rng.integers(1, PARTS, size=k)) % PARTS
    delta, off_s, off_refresh = _relayout(plan, g, off, fwds, params_of, dev,
                                          "relayout off the main plan")
    emit({"phase": "patch_off", "moved": int(len(delta.moved)),
          "grew": list(delta.grew), "rounds_added": delta.rounds_added,
          "retrace_expected": delta.retrace_expected,
          "cap": plan.cap, "halo_cap": plan.halo_cap, "e_cap": plan.e_cap,
          "rounds": len(plan.rounds), "host_patch_s": off_s,
          "refresh_s": off_refresh, "bit_equal_to_fresh": True})
    delta, patch_s, refresh_s = _relayout(plan, g, home, fwds, params_of, dev,
                                          "relayout back to the main plan")
    require(not delta.retrace_expected,
            f"the {k}-vertex relayout back overflowed the plan: {delta.grew}")
    emit({"phase": "patch", "moved": int(len(delta.moved)),
          "dirty_parts": int(len(delta.dirty_parts)), "host_patch_s": patch_s,
          "refresh_s": refresh_s,
          "builds_after_patch": {m: f.stats["builds"] for m, f in fwds.items()},
          "traces_after_patch": {m: f.stats["traces"] for m, f in fwds.items()},
          "bit_equal_to_fresh": True})
    builds = {m: f.stats["builds"] for m, f in fwds.items()}
    traces = {m: f.stats["traces"] for m, f in fwds.items()}
    grow = home.copy()
    grow[: g.n // 2] = 0                      # stampede into partition 0
    delta = patch_plan(plan, g, grow)
    require(delta.retrace_expected, "stampede did not grow the plan")
    blocks = torch.from_numpy(scatter_features(plan, g.features)).to(dev)
    for m, fwd in fwds.items():
        cfg, params = gnn_paper.ALL[("siot", m)], params_of[("siot", m)]
        out = fwd(params, blocks)
        require(torch.equal(fwd(params, blocks), out),
                f"{m}: the forward captured after growth != its first run")
        require(fwd.stats["builds"] == builds[m] + 1
                and fwd.stats["traces"] == traces[m] + 1,
                f"{m}: growth gave {fwd.stats['builds'] - builds[m]} "
                f"rebuilds and {fwd.stats['traces'] - traces[m]} traces, "
                "not 1")
        ref = forward(cfg, params, siot["feats"], siot["sd"]).cpu()
        full = torch.from_numpy(gather_outputs(plan, out.cpu().numpy(), g.n))
        err = allclose_err(full, ref, FWD_TOL)
        require(err <= FWD_TOL, f"{m}: forward after growth: {err}")
    emit({"phase": "patch_growth", "grew": list(delta.grew), "cap": plan.cap,
          "builds": {m: f.stats["builds"] for m, f in fwds.items()},
          "traces": {m: f.stats["traces"] for m, f in fwds.items()},
          **_captured([s for f in fwds.values()
                       for s in f.steps.values()])})


def _serve_pass(engine, targets):
    """Serve ``targets`` to the end; the answers, and the pass's req/s and
    p50/p99 ms from the engine's ledger."""
    done, secs, lats = (engine.stats.requests, engine.stats.wall_time_s,
                        len(engine.latencies))
    out = engine.serve(targets)
    arr = np.asarray(engine.latencies[lats:])
    return out, {"req_per_s": (engine.stats.requests - done)
                 / (engine.stats.wall_time_s - secs),
                 "p50_ms": float(np.percentile(arr, 50)) * 1e3,
                 "p99_ms": float(np.percentile(arr, 99)) * 1e3}


def phase_serve(siot, params_of, dev):
    """256 Zipf requests through the ego-serving engine over each of SIoT's
    plans, against the BSP forward's rows.  The engine captures one CUDA
    graph a bucket; an eager engine serves the same stream: every answer
    bit-equal, the same traces.  Each engine serves the stream twice: the
    first pass captures (or, eager, meets) every bucket, the second
    replays; the ``serve_graph`` line holds req/s and p50/p99 both ways
    for both passes, the captures and their seconds and pool MB."""
    g = siot["graph"]
    cfg, params = gnn_paper.SIOT_GCN, params_of[("siot", "gcn")]
    targets = zipf_requests(g.n, 256, s=1.1, seed=SEED)
    for layout in LAYOUTS:
        plan = siot["layouts"][layout]["plan"]
        fwd = make_bsp_forward(cfg, plan, device=dev, graphs=False)
        bsp = gather_outputs(plan, fwd(params, torch.from_numpy(
            scatter_features(plan, g.features)).to(dev)).cpu().numpy(), g.n)
        engine = GNNServeEngine(cfg, params, g, plan, hops=2, batch=16,
                                device=dev)
        on_card = dev.type == "cuda"
        require(engine.fwd.graphs is on_card, f"serve over {layout}: the "
                f"engine on {dev} resolved graphs to {engine.fwd.graphs}")
        out, cold = _serve_pass(engine, targets)
        err = allclose_err(torch.from_numpy(out),
                           torch.from_numpy(bsp[targets]), FWD_TOL)
        require(out.shape == (256, cfg.layer_dims[-1])
                and np.isfinite(out).all(), f"served output shape "
                f"{out.shape} or non-finite values over {layout}")
        require(err <= FWD_TOL, f"served answers vs BSP forward rows over "
                f"{layout}: {err}")
        s = engine.stats
        if layout == "random":
            require(s.fetched_rows > 0, "serving over the Random plan "
                    "fetched no remote row")
        lat = engine.latency_percentiles()
        emit({"phase": "serve", "layout": layout, "requests": s.requests,
              "batches": s.batches, "local_rows": s.local_rows,
              "cache_hit_rows": s.cache_hit_rows,
              "fetched_rows": s.fetched_rows,
              "replica_hit_rows": s.replica_hit_rows,
              "req_per_s": s.throughput_rps, "p50_ms": lat["p50"] * 1e3,
              "p99_ms": lat["p99"] * 1e3, "allclose_excess": err,
              "cache": engine.cache_stats()})
        eager = GNNServeEngine(cfg, params, g, plan, hops=2, batch=16,
                               device=dev, graphs=False)
        e_out, e_cold = _serve_pass(eager, targets)
        again, warm = _serve_pass(engine, targets)
        e_again, e_warm = _serve_pass(eager, targets)
        equal = (np.array_equal(out, e_out) and np.array_equal(again, out)
                 and np.array_equal(e_again, e_out))
        traces = (engine.fwd.stats["traces"], eager.fwd.stats["traces"])
        emit({"phase": "serve_graph", "layout": layout,
              "requests_per_pass": len(targets),
              "answers_bit_equal": equal, "traces": traces[0],
              "eager_traces": traces[1], "captures": engine.fwd.captures(),
              **_captured(engine.fwd.steps.values()),
              "first_pass": {"graph": cold, "eager": e_cold},
              "second_pass": {"graph": warm, "eager": e_warm}})
        require(equal, f"serve over {layout}: the graph engine's answers "
                "!= the eager engine's, bit for bit")
        require(traces[0] == traces[1] and engine.fwd.captures() == (
            traces[0] if on_card else 0), f"serve over {layout}: traces "
            f"{traces}, captures {engine.fwd.captures()}")


def phase_evolve(siot, params_of, dev):
    """The paper's dynamic path (Sec. V): graph evolution, GLAD-E relayout
    on the main fleet and an in-place plan patch per slot, on the main
    layout compiled without headroom, so that vertex insertions overflow
    its edge table."""
    g = siot["graph"]
    assign = siot["layouts"]["glad_s_mu2"]["assign"].copy()
    cfg, params = gnn_paper.SIOT_GCN, params_of[("siot", "gcn")]
    gnn = workload_for("gcn", cfg.layer_dims[0])
    plan = compile_plan(g, partition_from_assign(g, assign, PARTS, {}))
    build_plan_bsr(plan)
    fwd = make_bsp_forward(cfg, plan, exchange="ppermute", device=dev)
    fwd(params, torch.from_numpy(scatter_features(plan, g.features)).to(dev))
    e_cap_path = False
    for t in range(EVOLVE_SLOTS):
        delta = sample_delta(g, pct_links=0.01, pct_vertices=0.0005,
                             seed=EVOLVE_SEED + 17 * t)
        g_new = apply_delta(g, delta)
        cm = CostModel(build_edge_network(g_new, PARTS, seed=SEED,
                                          mu_factor=FLEETS["mu2"]), g_new, gnn)
        t0 = time.perf_counter()
        res = glad_e(cm, g, assign, seed=SEED)
        glad_e_s = time.perf_counter() - t0
        structural = [delta.add_edges.ravel(), delta.del_edges.ravel(),
                      delta.del_vertices]
        structural += [g.neighbors(int(v)) for v in delta.del_vertices]
        structural = np.unique(np.concatenate(structural))
        caps = (plan.cap, plan.halo_cap, plan.e_cap)
        t0 = time.perf_counter()
        pd = patch_plan(plan, g_new, res.assign, dirty_vertices=structural)
        patch_s = time.perf_counter() - t0
        fresh = recompile_like(plan, g_new, res.assign)
        require(plans_equal(plan, fresh) == [],
                f"evolve slot {t}: patched plan != fresh compile")
        require(pd.new_vertices == g_new.n - g.n,
                f"evolve slot {t}: {pd.new_vertices} new vertices reported")
        blocks = torch.from_numpy(scatter_features(plan, g_new.features)
                                  ).to(dev)
        builds, traces = fwd.stats["builds"], fwd.stats["traces"]
        before = spmm.launches
        out = fwd(params, blocks)
        replay = fwd(params, blocks)
        torch.cuda.synchronize()
        require(spmm.launches - before == 2 * cfg.num_layers,
                f"evolve slot {t}: {spmm.launches - before} spmm_csr launches "
                "over two forwards")
        rebuilt = fwd.stats["builds"] - builds
        traced = fwd.stats["traces"] - traces
        require(rebuilt == traced == int(pd.retrace_expected),
                f"evolve slot {t}: {rebuilt} rebuilds and {traced} traces, "
                f"retrace_expected {pd.retrace_expected} ({pd.grew})")
        fresh_out = make_bsp_forward(cfg, fresh, exchange="ppermute",
                                     device=dev, graphs=False)(params, blocks)
        require(torch.equal(out, fresh_out) and torch.equal(replay, fresh_out),
                f"evolve slot {t}: forward over the patched plan != fresh "
                "plan's, bit for bit")
        sd = torch.from_numpy(directed_edges(g_new.edges)).to(dev)
        ref = forward(cfg, params, torch.from_numpy(g_new.features).to(dev),
                      sd).cpu()
        full = torch.from_numpy(
            gather_outputs(plan, out.cpu().numpy(), g_new.n))
        err = allclose_err(full, ref, FWD_TOL)
        require(err <= FWD_TOL, f"evolve slot {t}: forward vs whole-graph "
                f"forward: {err}")
        hit = (pd.new_vertices > 0 and "e_cap" in pd.grew
               and caps[:2] == (plan.cap, plan.halo_cap))
        e_cap_path = e_cap_path or hit
        emit({"phase": "evolve", "slot": t, "n": g_new.n,
              "links": g_new.num_edges, "add_vertices": delta.add_vertices,
              "del_vertices": int(len(delta.del_vertices)),
              "add_links": int(len(delta.add_edges)),
              "del_links": int(len(delta.del_edges)),
              "glad_e_moved": int(len(res.moved)), "glad_e_cost": res.cost,
              "glad_e_host_s": glad_e_s, "host_patch_s": patch_s,
              "grew": list(pd.grew), "retrace_expected": pd.retrace_expected,
              "builds": fwd.stats["builds"], "traces": fwd.stats["traces"],
              "graph_replayed": True, "e_cap": plan.e_cap,
              "e_cap_growth_after_insertion": hit, "allclose_excess": err,
              "bit_equal_to_fresh": True})
        g, assign = g_new, res.assign
    require(e_cap_path, "no evolve slot inserted vertices and overflowed "
            "e_cap alone")


def phase_replicate(siot, params_of, dev):
    """Serving-side move-vs-replicate on SIoT's Random and main plans, for
    serve's stream: the replicated forward equals the unreplicated one bit
    for bit, and the engine serves replica-resident rows.  Replicas are
    switched off again at the end (one more rebuild, the same output)."""
    g = siot["graph"]
    targets = zipf_requests(g.n, 256, s=1.1, seed=SEED)
    for layout in ("random", "glad_s_mu2"):
        lay = siot["layouts"][layout]
        cm, plan, assign = lay["cm"], lay["plan"], lay["assign"]
        t0 = time.perf_counter()
        repl = replicate_for_stream(cm, assign, targets, hops=2)
        repl_s = time.perf_counter() - t0
        require(repl.count > 0, f"{layout}: replicate_for_stream chose no "
                "replica")
        base_cost = serving_cost(cm, assign, targets, hops=2)
        repl_cost = serving_cost(cm, assign, targets, hops=2,
                                 replication=repl)
        require(abs(repl_cost - (base_cost - repl.gain)) <= 1e-9 * base_cost,
                f"{layout}: serving_cost with replicas {repl_cost} != base "
                f"{base_cost} - gain {repl.gain}")
        blocks = torch.from_numpy(scatter_features(plan, g.features)).to(dev)
        fwds, plain = {}, {}
        for m in ("gcn", "sage", "gat"):
            cfg = gnn_paper.ALL[("siot", m)]
            fwds[m] = make_bsp_forward(cfg, plan, exchange="ppermute",
                                       device=dev)
            plain[m] = fwds[m](params_of[("siot", m)], blocks)
        set_replication(plan, repl)
        require(plan.halo_bytes_ppermute0 < plan.halo_bytes_ppermute,
                f"{layout}: replicas pruned no layer-0 row: "
                f"{plan.halo_bytes_ppermute0} of {plan.halo_bytes_ppermute}")
        replica0 = torch.from_numpy(scatter_replica_halo(plan, g.features)
                                    ).to(dev)
        launches = {}
        for m, fwd in fwds.items():
            cfg, params = gnn_paper.ALL[("siot", m)], params_of[("siot", m)]
            try:
                fwd(params, blocks)
            except ValueError:
                pass
            else:
                require(False, f"{layout} {m}: replicated forward ran "
                        "without replica0")
            before = spmm.launches
            out = fwd(params, blocks, replica0=replica0)
            torch.cuda.synchronize()
            launches[m] = spmm.launches - before
            want = cfg.num_layers if m in ("gcn", "sage") else 0
            require(launches[m] == want, f"{layout} {m}: {launches[m]} "
                    f"spmm_csr launches, expected {want}")
            require(fwd.stats["builds"] == 2, f"{layout} {m}: replicas gave "
                    f"{fwd.stats['builds'] - 1} rebuilds, not 1")
            require(torch.equal(out, plain[m]), f"{layout} {m}: replicated "
                    "forward != unreplicated, bit for bit")
        cfg, params = gnn_paper.SIOT_GCN, params_of[("siot", "gcn")]
        bsp = gather_outputs(plan, plain["gcn"].cpu().numpy(), g.n)
        engine = GNNServeEngine(cfg, params, g, plan, hops=2, batch=16,
                                device=dev)
        out = engine.serve(targets)
        err = allclose_err(torch.from_numpy(out),
                           torch.from_numpy(bsp[targets]), FWD_TOL)
        require(np.isfinite(out).all() and err <= FWD_TOL, f"{layout}: "
                f"served answers over the replicated plan vs BSP rows: {err}")
        s = engine.stats
        require(s.replica_hit_rows > 0, f"{layout}: no served row came from "
                "a replica")
        lat = engine.latency_percentiles()
        emit({"phase": "replicate", "layout": layout, "replicas": repl.count,
              "host_replicate_s": repl_s, "r_cap": plan.r_cap,
              "halo_rows_layer0": plan.halo_bytes_ppermute0,
              "halo_rows_later_layers": plan.halo_bytes_ppermute,
              "layer0_rows_saved": (plan.halo_bytes_ppermute
                                    - plan.halo_bytes_ppermute0),
              "serving_cost": base_cost, "serving_cost_replicated": repl_cost,
              "gain": repl.gain, "spmm_launches": launches,
              "bit_equal_to_unreplicated": True,
              "requests": s.requests, "local_rows": s.local_rows,
              "replica_hit_rows": s.replica_hit_rows,
              "cache_hit_rows": s.cache_hit_rows,
              "fetched_rows": s.fetched_rows,
              "req_per_s": s.throughput_rps, "p50_ms": lat["p50"] * 1e3,
              "p99_ms": lat["p99"] * 1e3, "allclose_excess": err})
        set_replication(plan, None)
        for m, fwd in fwds.items():
            out = fwd(params_of[("siot", m)], blocks)
            require(fwd.stats["builds"] == 3 and torch.equal(out, plain[m]),
                    f"{layout} {m}: with replicas off again, "
                    f"{fwd.stats['builds']} builds (not 3) or another output")


# ------------------------------------------------------- the example twins
# The paper's sizes: synthetic_yelp() and synthetic_siot() at their defaults.
EX_YELP = {"n": 3912, "links": 4677}
EX_SIOT = {"graph": "siot", "n": 8001, "links": 33509}
EX_RELAYOUT_SLOTS = 30          # of the example's 30; PERF.md §4
EX_REQUESTS = 2000
EX_LM_REQUESTS = 12             # serve_lm's requests of 12 new tokens


def _ex_run(fn, **kw):
    """Run an example twin's ``main`` with its printed lines captured;
    returns its record, the lines and the seconds it took."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rec = fn(**kw)
    torch.cuda.synchronize()
    return rec, buf.getvalue().splitlines(), time.perf_counter() - t0


def phase_ex_quickstart(dev):
    """launch.quickstart on the paper's Yelp over 8 servers: the Random,
    Greedy and GLAD-S costs, and the BSP forward of the Random and GLAD-S
    plans (GCN 100->16->2, K1 in both layers) against the whole-graph
    forward."""
    before = spmm.launches
    rec, lines, secs = _ex_run(quickstart.main, **EX_YELP, device=dev)
    launched = spmm.launches - before
    c = rec["costs"]
    require(c["glad_s"] <= c["greedy"] and c["glad_s"] < c["random"],
            f"ex_quickstart: GLAD-S cost not below Greedy's and Random's {c}")
    for name, lay in rec["layouts"].items():
        require(lay["finite"] and lay["shape"] == [rec["n"], 2]
                and lay["max_err"] <= FWD_TOL, f"ex_quickstart {name}: "
                f"shape {lay['shape']}, max_err {lay['max_err']}")
    want = 2 * len(rec["layouts"])
    require(launched == want, f"ex_quickstart: {launched} spmm_csr launches, "
            f"expected {want}")
    emit({"phase": "ex_quickstart", "card": CARD, "seconds": secs,
          "spmm_launches": launched, "record": rec, "printed": lines})


def phase_ex_relayout(dev):
    """launch.adaptive_relayout on the paper's Yelp: GLAD-A over the
    evolution trace with a live plan patched every slot and one resident
    BSP forward bound to it; every forward against the whole-graph
    forward, rebuilds exactly as retrace_expected says, K1 twice a
    forward."""
    before = spmm.launches
    rec, _, secs = _ex_run(adaptive_relayout.main,
                           slots=EX_RELAYOUT_SLOTS, **EX_YELP, device=dev)
    launched = spmm.launches - before
    slots = rec["slots"]
    require(len(slots) == EX_RELAYOUT_SLOTS,
            f"ex_relayout: {len(slots)} slots")
    errs = [rec["initial_max_err"]] + [s["max_err"] for s in slots]
    require(max(errs) <= FWD_TOL and all(s["finite"] for s in slots),
            f"ex_relayout: forward vs whole-graph forward: {max(errs)}")
    rebuilt = rec["builds"] - rec["builds_first"]
    require(rebuilt == rec["retrace_expected"], f"ex_relayout: {rebuilt} "
            f"rebuilds, retrace_expected over the slots "
            f"{rec['retrace_expected']}")
    want = 2 * (len(slots) + 1)
    require(launched == want, f"ex_relayout: {launched} spmm_csr launches, "
            f"expected 2 x {len(slots) + 1} forwards")
    step_s = [s["step_s"] for s in slots]
    emit({"phase": "ex_relayout", "card": CARD, "seconds": secs,
          "slots": len(slots), "spmm_launches": launched, "rebuilds": rebuilt,
          "glad_a_step_s_mean": statistics.mean(step_s),
          "glad_a_step_s_max": max(step_s),
          "patch_s_mean": statistics.mean(s["patch_s"] for s in slots),
          "forward_s_mean": statistics.mean(s["forward_s"] for s in slots),
          "max_err": max(errs), "record": rec})


def phase_ex_serve_gnn(dev):
    """launch.serve_gnn on the paper's SIoT over 6 servers (mu_factor
    2.0): the traffic-aware GLAD-S layout, 2000 Zipf requests through the
    ego-serving engine, the most loaded server failing half way; every
    served answer against the whole-graph forward, no vertex left on the
    dead server, one cache re-seed."""
    before = spmm.launches
    rec, lines, secs = _ex_run(serve_gnn.main, requests=EX_REQUESTS,
                               servers=6, **EX_SIOT, device=dev)
    half = EX_REQUESTS // 2
    require(rec["served_finite"]
            and rec["served_shape"] == [[half, 4], [EX_REQUESTS - half, 4]],
            f"ex_serve_gnn: served shapes {rec['served_shape']}")
    require(max(rec["served_max_err"]) <= FWD_TOL, f"ex_serve_gnn: served "
            f"answers vs whole-graph forward {rec['served_max_err']}")
    require(rec["dead_vertices_left"] == 0
            and rec["second_half"]["plan_refreshes"] == 1,
            f"ex_serve_gnn: {rec['dead_vertices_left']} vertices on the dead "
            f"server, {rec['second_half']['plan_refreshes']} re-seeds")
    require(spmm.launches == before, "ex_serve_gnn: the ego forward "
            "launched spmm_csr")
    emit({"phase": "ex_serve_gnn", "card": CARD, "seconds": secs,
          "req_per_s": {"before": rec["first_half"]["req_per_s"],
                        "after": rec["second_half"]["req_per_s"]},
          "p50_ms": {"before": rec["first_half"]["p50_ms"],
                     "after": rec["second_half"]["p50_ms"]},
          "p99_ms": {"before": rec["first_half"]["p99_ms"],
                     "after": rec["second_half"]["p99_ms"]},
          "traces": rec["overall"]["traces"], "record": rec,
          "printed": lines})


def phase_ex_experts(dev):
    """launch.expert_placement at the example's size: 64 experts on 8
    slices in 2 pods."""
    rec, lines, secs = _ex_run(expert_placement.main, device=dev)
    cut = rec["cut_weight"]
    require(sum(rec["per_slice_experts"]) == rec["experts"]
            and cut["glad"] < cut["random"],
            f"ex_experts: {rec['per_slice_experts']}, cut {cut}")
    emit({"phase": "ex_experts", "card": CARD, "seconds": secs,
          "record": rec, "printed": lines})


def _ex_lm_expected(rec) -> dict:
    """K2 launches by kernel path that ``launch.serve_lm``'s record implies:
    ``n_layers`` a prefill at the prompt's bucket, and a tick (one query
    row a slot)."""
    dtype = {"torch.float32": torch.float32,
             "torch.bfloat16": torch.bfloat16}[rec["dtype"]]
    shape = (rec["n_heads"], rec["n_kv_heads"])
    want = dict.fromkeys(flash_attention.launches_by_path, 0)
    for prompt in rec["prompts"]:
        L = min(ServeEngine._bucket(len(prompt)), rec["max_len"])
        want[kernel_path(dtype, *shape, L, rec["head_dim"])] += rec["n_layers"]
    want[kernel_path(dtype, *shape, 1, rec["head_dim"])] += (
        rec["n_layers"] * rec["ticks"])
    return want


def _ex_lm_rescore(rec, cfg, params, dev, n=2):
    """The first ``n`` served requests of a ``launch.serve_lm`` record
    re-scored by one teacher-forced forward each, as lm_serve re-scores
    its own: returns how many served tokens are the forward's top logit,
    of how many, and the largest gap below it."""
    exact, checked, gaps = 0, 0, []
    for prompt, served in zip(rec["prompts"][:n], rec["tokens"][:n]):
        toks = torch.tensor(prompt + served[:-1], device=dev)[None]
        logits, _ = lm.forward(cfg, params, {"tokens": toks})
        rows = logits[0, len(prompt) - 1:len(toks[0])].float()
        got = torch.tensor(served, device=dev)
        require(bool(torch.isfinite(rows).all()),
                "ex_serve_lm: non-finite teacher-forced logits")
        gap = rows.max(-1).values - rows[torch.arange(len(got)), got]
        exact += int((rows.argmax(-1) == got).sum())
        checked += len(got)
        gaps.append(float(gap.max()))
    return exact, checked, max(gaps)


def phase_ex_serve_lm(dev):
    """launch.serve_lm: the example's reduced llama in fp32 on the card and
    on the CPU (the same tokens), then ``full=True``: the full-width
    llama3.2-1b in bf16 behind the same engine, two of its requests
    re-scored by a teacher-forced forward within SERVE_GAP_TOL.  K2
    launches n_layers x (prefills + ticks), exactly by kernel path."""
    out, by_path = {}, dict.fromkeys(flash_attention.launches_by_path, 0)
    for full in (False, True):
        cfg = serve_config(serve_lm.ARCH, smoke=not full)
        params = None
        if full:                     # the twin's own draw, kept to re-score
            params = lm.init_params(
                cfg, torch.Generator(dev).manual_seed(0), dev)
        before = dict(flash_attention.launches_by_path)
        rec, lines, secs = _ex_run(serve_lm.main, full=full, device=dev,
                                   params=params)
        got = {k: flash_attention.launches_by_path[k] - before[k]
               for k in before}
        want = _ex_lm_expected(rec)
        label = "full" if full else "reduced"
        require(got == want, f"ex_serve_lm {label}: K2 launches by kernel "
                f"{got}, expected {want}")
        require(rec["completed"] == EX_LM_REQUESTS and all(
            len(t) == 12 for t in rec["tokens"]),
            f"ex_serve_lm {label}: {rec['completed']} completed, tokens "
            f"{[len(t) for t in rec['tokens']]}")
        row = {"seconds": secs, "launches_by_path": got,
               "record": {k: v for k, v in rec.items() if k != "prompts"},
               "printed": lines}
        if full:
            exact, checked, gap = _ex_lm_rescore(rec, cfg, params, dev)
            require(gap <= SERVE_GAP_TOL, f"ex_serve_lm full: a served token "
                    f"is {gap} below the teacher-forced top logit")
            row.update(teacher_forced_exact=exact,
                       teacher_forced_checked=checked,
                       teacher_forced_max_gap=gap, gap_tol=SERVE_GAP_TOL)
        else:
            cpu, _, cpu_s = _ex_run(serve_lm.main, full=False, device="cpu")
            require(cpu["tokens"] == rec["tokens"], "ex_serve_lm: the card's "
                    "tokens differ from the CPU's in fp32")
            row["cpu_seconds"] = cpu_s
            row["tokens_equal_cpu"] = True
        out[label] = row
        for k in by_path:
            by_path[k] += got[k]
        del params
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "ex_serve_lm", "card": CARD, **out})
    return by_path


# ------------------------------------------------------------ ranks (gloo)
RANK_LAYOUTS = ("glad_s_mu2", "random")
RANK_MODELS = ("gcn", "sage", "gat")
RANK_EXCHANGES = ("ppermute", "allgather")
RANK_REPS = 10                 # timed forwards per case on every rank
RANK_TIMEOUT = 600.0           # a lost rank fails the phase, not the run


def _rank_layouts(rank, name, g):
    """Rank 0 lays the graph out as phase_layout does (GLAD-S on the mu2
    fleet, Random on the default one); every rank gets the assignments."""
    mine = {}
    if rank == 0:
        wl = workload_for("gcn", gnn_paper.ALL[(name, "gcn")].layer_dims[0])
        cms = {fleet: CostModel(build_edge_network(
            g, PARTS, seed=SEED, mu_factor=mu), g, wl)
            for fleet, mu in FLEETS.items()}
        mine = {"glad_s_mu2": glad_s(cms["mu2"], seed=SEED).assign,
                "random": random_layout(cms["default"], seed=SEED)}
    return {layout: broadcast_assign(mine.get(layout), g.n)
            for layout in RANK_LAYOUTS}


def _rank_forwards(rank, name, layout, plan, block, dev):
    """Every model and exchange over one plan: the output block, a repeat,
    K1's launches, the traffic per layer and the forward's time split."""
    rows = {}
    for model in RANK_MODELS:
        cfg = gnn_paper.ALL[(name, model)]
        params = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
        for exchange in RANK_EXCHANGES:
            fwd = make_rank_bsp_forward(cfg, plan, exchange=exchange,
                                        device=dev)
            before = spmm.launches
            staged = dict(fwd.comm.staged)
            out = fwd(params, block)
            torch.cuda.synchronize()
            launched = spmm.launches - before
            staged = {k: v - staged[k] for k, v in fwd.comm.staged.items()}
            collectives = len(fwd.comm.log)
            repeat = torch.equal(out, fwd(params, block))
            total, exch, check = [], [], []
            for _ in range(RANK_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fwd(params, block)
                torch.cuda.synchronize()
                total.append(time.perf_counter() - t0)
                exch.append(fwd.stats["exchange_s"])
                check.append(fwd.stats["agree_s"])
            rows[(name, layout, model, exchange)] = {
                "out": out.cpu().numpy(), "repeat": repeat,
                "launches": launched, "traffic": fwd.stats["traffic"],
                "staged": staged, "collectives": collectives,
                "ms": statistics.median(total) * 1e3,
                "exchange_ms": statistics.median(exch) * 1e3,
                "plan_check_ms": statistics.median(check) * 1e3}
    return rows


def _rank_contention(rank, g, dev):
    """The whole-graph GCN forward on the card (no collective), timed on
    every rank at once and then on one rank at a time while the others
    wait: what sharing the card costs a rank's compute."""
    cfg = gnn_paper.SIOT_GCN
    params = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    feats = torch.from_numpy(g.features).to(dev)
    sd = torch.from_numpy(directed_edges(g.edges)).to(dev)

    def timed():
        times = []
        for _ in range(RANK_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(cfg, params, feats, sd)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    timed()                                 # warm-up
    torch.distributed.barrier()
    together = timed()
    alone = None
    for q in range(PARTS):
        torch.distributed.barrier()
        if q == rank:
            alone = timed()
    return {"together_ms": together, "alone_ms": alone}


def _rank_patch(rank, g, plan, dev):
    """phase_patch's relayouts on the rank's copy of SIoT's main plan: off
    it (its halo_cap grows), back to it (value-only), then a stampede
    (capacity growth); each forward against a fresh plan's."""
    rng = np.random.default_rng(SEED + 1)
    k = g.n // 50
    movers = rng.choice(g.n, size=k, replace=False)
    home = plan.assign.copy()
    off = home.copy()
    off[movers] = (off[movers] + rng.integers(1, PARTS, size=k)) % PARTS
    grow = home.copy()
    grow[: g.n // 2] = 0
    models = ("gcn", "sage")
    params = {m: init_params(gnn_paper.ALL[("siot", m)],
                             torch.Generator().manual_seed(SEED), dev)
              for m in models}
    fwds = {m: make_rank_bsp_forward(gnn_paper.ALL[("siot", m)], plan,
                                     device=dev) for m in models}
    block = scatter_features(plan, g.features)[rank]
    for m in models:
        fwds[m](params[m], block)
    steps = []
    for label, target in (("off", off), ("back", home), ("growth", grow)):
        builds = {m: f.stats["builds"] for m, f in fwds.items()}
        delta = patch_plan(plan, g, target)
        fresh = recompile_like(plan, g, target)
        block = scatter_features(plan, g.features)[rank]
        row = {"step": label, "retrace_expected": delta.retrace_expected,
               "grew": list(delta.grew),
               "plans_equal": plans_equal(plan, fresh) == []}
        for m in models:
            cfg = gnn_paper.ALL[("siot", m)]
            out = fwds[m](params[m], block)
            want = make_rank_bsp_forward(cfg, fresh, device=dev)(params[m],
                                                                 block)
            row[m] = {"rebuilds": fwds[m].stats["builds"] - builds[m],
                      "bit_equal_to_fresh": torch.equal(out, want)}
        steps.append(row)
    return steps


def _rank_replicas(rank, g, assign, plain_out, dev):
    """SIoT's Random plan with CostModel.replicate_greedy's replicas: the
    rank forward bit-equal to the unreplicated one (``plain_out``), with
    fewer live layer-0 rows; without replica0 it raises."""
    wl = workload_for("gcn", gnn_paper.SIOT_GCN.layer_dims[0])
    cm = CostModel(build_edge_network(g, PARTS, seed=SEED,
                                      mu_factor=FLEETS["default"]), g, wl)
    repl = cm.replicate_greedy(assign)
    rplan = compile_plan(g, partition_from_assign(g, assign, PARTS, {}),
                         slack=SLACK, replication=repl)
    block = scatter_features(rplan, g.features)[rank]
    halo0 = scatter_replica_halo(rplan, g.features)[rank]
    out = {"replicas": repl.count, "rows0": rplan.halo_bytes_ppermute0,
           "rows": rplan.halo_bytes_ppermute}
    for model in RANK_MODELS:
        cfg = gnn_paper.ALL[("siot", model)]
        params = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
        fwd = make_rank_bsp_forward(cfg, rplan, device=dev)
        got = fwd(params, block, replica0=halo0)
        out[model] = {"bit_equal": bool(np.array_equal(
            got.cpu().numpy(), plain_out[("siot", "random", model,
                                          "ppermute")]["out"])),
            "live_rows": [t["live_rows_sent"]
                          for t in fwd.stats["traffic"]]}
    try:
        fwd(params, block)
    except ValueError:
        out["missing_replica0_raises"] = True
    else:
        out["missing_replica0_raises"] = False
    return out


def _param_digest(params) -> str:
    h = hashlib.sha256()
    for layer in params:
        for k in sorted(layer):
            h.update(layer[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _rank_train(rank, name, plan, g, dev):
    """ranks_train on one main plan: one step's loss and gradients, the
    step repeated, TRAIN_STEPS steps with the parameters' digest after
    each, K1's launches per step."""
    block = scatter_features(plan, g.features)[rank]
    labels = scatter_ints(plan, g.labels)[rank]
    mask = scatter_ints(plan, np.ones(g.n, np.float32))[rank]
    rows = {}
    for model in RANK_MODELS:
        cfg = gnn_paper.ALL[(name, model)]
        params = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
        fwd = make_rank_bsp_forward(cfg, plan, device=dev)
        step = make_distributed_train_step(cfg, fwd, labels, mask,
                                           lr=TRAIN_LR)
        before = dict(spmm.launches_by_dir)
        loss, grads = step.loss_and_grads(params, block)
        torch.cuda.synchronize()
        launched = {k: spmm.launches_by_dir[k] - before[k] for k in before}
        loss2, grads2 = step.loss_and_grads(params, block)
        new, _ = step(params, block)
        new2, _ = step(params, block)
        repeat = (torch.equal(loss, loss2) and _equal_trees(grads, grads2)
                  and _equal_trees(new, new2))
        p, losses, digests, times = params, [], [], []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, step_loss = step(p, block)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(step_loss))
            digests.append(_param_digest(p))
        rows[(name, model)] = {
            "loss": float(loss), "repeat": repeat, "launches": launched,
            "grads": [{k: v.cpu().numpy() for k, v in layer.items()}
                      for layer in grads],
            "losses": losses, "digests": digests,
            "step_ms": statistics.median(times) * 1e3}
    return rows


def _rank_program(rank, device: str):
    """One rank of the ranks phases, on ``device`` (the parent's card)
    beside the others: the layouts (rank 0) and plans, every forward over
    the plans, the replica checks, ranks_train, then the patches."""
    t_start = time.perf_counter()
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    _build.load_library()                  # the parent built it
    _zero_counts()
    res = {"assign": {}, "forward": {}, "train": {}}
    graphs, main = {}, {}
    for name in ("siot", "yelp"):
        g = synthetic_siot() if name == "siot" else synthetic_yelp()
        graphs[name] = g
        for layout, assign in _rank_layouts(rank, name, g).items():
            res["assign"][(name, layout)] = assign
            plan = compile_plan(g, partition_from_assign(g, assign, PARTS,
                                                         {}), slack=SLACK)
            block = scatter_features(plan, g.features)[rank]
            res["forward"].update(_rank_forwards(rank, name, layout, plan,
                                                 block, dev))
            if layout == "glad_s_mu2":
                main[name] = plan
    res["replicas"] = _rank_replicas(rank, graphs["siot"],
                                     res["assign"][("siot", "random")],
                                     res["forward"], dev)
    res["fwd_launches"] = dict(spmm.launches_by_dir)
    for name, plan in main.items():
        res["train"].update(_rank_train(rank, name, plan, graphs[name], dev))
    res["patch"] = _rank_patch(rank, graphs["siot"], main["siot"], dev)
    res["launches"] = dict(spmm.launches_by_dir)
    res["contention"] = _rank_contention(rank, graphs["siot"], dev)
    res["seconds"] = time.perf_counter() - t_start
    return res


def _traffic_check(label, plan, exchange, per_rank, dims):
    """Rows and bytes per layer summed over the ranks against the plan's
    schedule; returns the sums."""
    sums = []
    for layer, d in enumerate(dims):
        row = {k: sum(t[layer][k] for t in per_rank) for k in per_rank[0][layer]}
        if exchange == "ppermute":
            width = PARTS * sum(r["width"] for r in plan.rounds)
            ok = (row["rows_sent"] == row["rows_recv"] == width
                  and row["live_rows_sent"] == plan.halo_bytes_ppermute)
        else:
            ok = (row["rows_sent"] == PARTS * plan.cap
                  and row["rows_recv"] == plan.halo_rows_allgather)
        ok = ok and row["bytes_sent"] == row["rows_sent"] * d * 4 and (
            row["bytes_recv"] == row["rows_recv"] * d * 4)
        require(ok, f"{label} layer {layer}: rows on the wire {row} against "
                f"the plan's schedule")
        sums.append(row)
    return sums


def phase_ranks(datasets, dev):
    """The per-rank BSP forward and train step as RANKS processes sharing
    cuda:0 over gloo (one spawn), held against the whole-graph forward,
    the one-device batched program and the plan's schedule; returns K1's
    launches in the ranks by direction."""
    t0 = time.perf_counter()
    res = run_ranks(_rank_program, PARTS, str(dev), timeout=RANK_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    main = {}
    for ds in datasets:
        name, g = ds["name"], ds["graph"]
        for layout in RANK_LAYOUTS:
            assign = ds["layouts"][layout]["assign"]
            require(all(np.array_equal(r["assign"][(name, layout)], assign)
                        for r in res), f"ranks {name} {layout}: rank 0's "
                    "layout differs from phase_layout's")
            plan = compile_plan(g, partition_from_assign(g, assign, PARTS,
                                                         {}), slack=SLACK)
            build_plan_bsr(plan)
            blocks = torch.from_numpy(scatter_features(plan, g.features)
                                      ).to(dev)
            if layout == "glad_s_mu2":
                main[name] = (plan, blocks, g)
            for model in RANK_MODELS:
                cfg = gnn_paper.ALL[(name, model)]
                params = init_params(cfg, torch.Generator().manual_seed(SEED),
                                     dev)
                ref = forward(cfg, params, ds["feats"], ds["sd"]).cpu()
                for exchange in RANK_EXCHANGES:
                    key = (name, layout, model, exchange)
                    label = "ranks " + " ".join(key)
                    rec = [r["forward"][key] for r in res]
                    out = np.stack([x["out"] for x in rec])
                    full = torch.from_numpy(gather_outputs(plan, out, g.n))
                    err = allclose_err(full, ref, FWD_TOL)
                    require(err <= FWD_TOL, f"{label}: rank outputs vs the "
                            f"whole-graph forward: {err}")
                    bfwd = make_bsp_forward(cfg, plan, exchange=exchange,
                                            device=dev)
                    batched = bfwd(params, blocks).cpu().numpy()
                    want = cfg.num_layers if model in ("gcn", "sage") else 0
                    require(all(x["launches"] == want for x in rec),
                            f"{label}: K1 launches per rank "
                            f"{[x['launches'] for x in rec]}, expected {want}")
                    require(all(x["repeat"] for x in rec),
                            f"{label}: a repeated forward differs")
                    n_coll = cfg.num_layers * (len(plan.rounds)
                                               if exchange == "ppermute" else 1)
                    copies = n_coll if dev.type == "cuda" else 0  # CPU: none
                    require(all(x["collectives"] == n_coll and x["staged"]
                                == {"d2h": copies, "h2d": copies}
                                for x in rec),
                            f"{label}: staging copies "
                            f"{[x['staged'] for x in rec]}, expected one "
                            f"each way for each of {n_coll} collectives")
                    traffic = _traffic_check(label, plan, exchange,
                                             [x["traffic"] for x in rec],
                                             cfg.layer_dims[:-1])
                    ms = [x["ms"] for x in rec]
                    exch = [x["exchange_ms"] for x in rec]
                    check = [x["plan_check_ms"] for x in rec]
                    emit({"phase": "ranks", "dataset": name, "layout": layout,
                          "model": model, "exchange": exchange,
                          "ranks": PARTS, "aggregate": bfwd.mode,
                          "allclose_excess": err,
                          "batched_max_abs_err": float(
                              np.abs(out - batched).max()),
                          "bit_equal_to_batched": bool(
                              np.array_equal(out, batched)),
                          "k1_launches_per_rank": want,
                          "rows_per_layer": traffic,
                          "forward_ms_by_rank": ms,
                          "exchange_ms_by_rank": exch,
                          "plan_check_ms_by_rank": check,
                          "compute_ms_by_rank": [a - b - c for a, b, c in
                                                 zip(ms, exch, check)],
                          "one_device_forward_ms": time_ms(
                              lambda: bfwd(params, blocks), reps=20)})
    _ranks_checks(res, main, dev)
    launches = {k: sum(r["launches"][k] for r in res)
                for k in ("fwd", "bwd")}
    emit({"phase": "ranks_summary", "ranks": PARTS,
          "phase_s": time.perf_counter() - t0, "spawn_s": spawn_s,
          "rank_program_s": [r["seconds"] for r in res],
          "whole_graph_forward_ms_all_ranks_at_once": [
              r["contention"]["together_ms"] for r in res],
          "whole_graph_forward_ms_one_rank_at_a_time": [
              r["contention"]["alone_ms"] for r in res],
          "k1_launches": launches, "k1_launches_by_rank": [
              r["launches"] for r in res]})
    return launches


def _ranks_checks(res, main, dev):
    """The replica, ranks_train and patch results of the ranks."""
    rep = [r["replicas"] for r in res]
    require(rep[0]["replicas"] > 0 and rep[0]["rows0"] < rep[0]["rows"],
            f"ranks replicas: {rep[0]['replicas']} replicas, layer-0 rows "
            f"{rep[0]['rows0']} of {rep[0]['rows']}")
    for model in RANK_MODELS:
        require(all(x[model]["bit_equal"] for x in rep), f"ranks replicas "
                f"{model}: the replicated forward differs from the "
                "unreplicated one")
        live = [sum(x[model]["live_rows"][k] for x in rep) for k in (0, 1)]
        require(live == [rep[0]["rows0"], rep[0]["rows"]], f"ranks replicas "
                f"{model}: live rows {live}")
    require(all(x["missing_replica0_raises"] for x in rep),
            "ranks replicas: a forward without replica0 ran")
    emit({"phase": "ranks_replicas", "layout": "random",
          "replicas": rep[0]["replicas"], "halo_rows_layer0": rep[0]["rows0"],
          "halo_rows_later_layers": rep[0]["rows"],
          "bit_equal_to_unreplicated": True})
    for name, (plan, blocks, g) in main.items():
        labels_b, mask_b = _train_setup(plan, g, dev)[1:]
        for model in RANK_MODELS:
            cfg = gnn_paper.ALL[(name, model)]
            params = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
            step1 = make_distributed_train_step(
                cfg, make_bsp_forward(cfg, plan, exchange="ppermute",
                                      device=dev), labels_b, mask_b,
                lr=TRAIN_LR)
            ref_loss, ref = step1.loss_and_grads(params, blocks)
            ref = [{k: v.cpu() for k, v in layer.items()} for layer in ref]
            rec = [r["train"][(name, model)] for r in res]
            label = f"ranks_train {name} {model}"
            excess, err = _grad_excess(
                [{k: torch.from_numpy(v) for k, v in layer.items()}
                 for layer in rec[0]["grads"]], ref)
            loss_err = abs(rec[0]["loss"] - float(ref_loss))
            require(excess <= 0 and loss_err <= FWD_TOL * abs(float(ref_loss)),
                    f"{label}: vs the one-device step: excess {excess}, loss "
                    f"{loss_err}")
            require(all(x["repeat"] for x in rec),
                    f"{label}: a repeated step differs")
            require(all(x["digests"] == rec[0]["digests"] and x["losses"]
                        == rec[0]["losses"] for x in rec),
                    f"{label}: the ranks' parameters or losses differ")
            losses = rec[0]["losses"]
            require(np.isfinite(losses).all() and losses[-1] < losses[0],
                    f"{label}: {TRAIN_STEPS} steps did not lower the loss")
            L = cfg.num_layers
            want = ({"fwd": L, "bwd": L - 1} if model in ("gcn", "sage")
                    else {"fwd": 0, "bwd": 0})
            require(all(x["launches"] == want for x in rec),
                    f"{label}: K1 launches per step "
                    f"{[x['launches'] for x in rec]}, expected {want}")
            emit({"phase": "ranks_train", "dataset": name, "model": model,
                  "ranks": PARTS, "loss": rec[0]["loss"], "loss_err": loss_err,
                  "grad_max_abs_err": err, "grad_excess": excess,
                  "bitwise_equal_repeat": True,
                  "params_equal_on_every_rank": True,
                  "train_losses": [losses[0], losses[-1]],
                  "k1_launches_per_step": want,
                  "step_ms_by_rank": [x["step_ms"] for x in rec],
                  "one_device_step_ms": time_ms(
                      lambda: step1(params, blocks), reps=10, warmup=2)})
    steps = [r["patch"] for r in res]
    for i, row in enumerate(steps[0]):
        require(all(s[i] == row for s in steps[1:]),
                f"ranks patch {row['step']}: the ranks disagree")
        want = int(row["retrace_expected"])
        require(row["plans_equal"] and all(
            row[m]["rebuilds"] == want and row[m]["bit_equal_to_fresh"]
            for m in ("gcn", "sage")), f"ranks patch {row['step']}: {row}")
    require([r["retrace_expected"] for r in steps[0]][1:] == [False, True],
            f"ranks patch: retraces {[r['retrace_expected'] for r in steps[0]]}"
            ": the relayout back must be value-only, the stampede grow")
    emit({"phase": "ranks_patch", "steps": steps[0]})


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


def _stats_split(q, k, v, kv_len, n: int):
    """K2's decode over the cache (B, Hkv, S, D) cut into ``n`` slices of
    positions, each through ``flash_attention(..., return_stats=True)``
    with ``kv_len`` clipped to it, merged by ``combine_decode_partials``:
    what a decode step does across a cache split by sequence."""
    w = k.shape[2] // n
    parts = [flash_attention(q, k[:, :, i * w:(i + 1) * w],
                             v[:, :, i * w:(i + 1) * w],
                             (kv_len - i * w).clamp(0, w).to(torch.int32),
                             causal=False, return_stats=True)
             for i in range(n)]
    return combine_decode_partials(*zip(*parts))


def _stats_split_plain(q, k, v, kv_len, n: int):
    """:func:`_stats_split` through the plain versions."""
    w = k.shape[2] // n
    split = decode_split(q.shape[-1], q.dtype)
    parts = [flash_decode_split_plain(
        q, k[:, :, i * w:(i + 1) * w], v[:, :, i * w:(i + 1) * w],
        (kv_len - i * w).clamp(0, w).to(torch.int32), split, causal=False,
        return_stats=True) for i in range(n)]
    return combine_decode_partials(*zip(*parts))


def phase_flash_stats(dev):
    """K2's decode with stats (the mesh's sequence-split decode): at
    llama3.2-1b's B = 8 over 2048 positions (bf16 and fp32) and at
    deepseek-moe-16b's D = 128, the cache cut into STATS_SLICES slices, a
    row at kv_len 0 and slices wholly past kv_len; each slice through the
    kernel with stats, merged, against the whole-cache kernel and
    flash_attention_plain (fp32 within 2e-5, bf16 within 2e-2 max|ref|),
    bit-equal run to run, the kv_len = 0 row exactly 0, one slice equal to
    the whole-cache kernel's bits; the split-plus-merge's device time
    beside the whole-cache kernel's.  Returns (rows, worst error)."""
    gen = torch.Generator(dev).manual_seed(SEED + 11)
    rng = np.random.default_rng(SEED + 11)
    cases = []
    for name, arch, dtype in (("llama", "llama3.2-1b", torch.bfloat16),
                              ("llama", "llama3.2-1b", torch.float32),
                              ("deepseek", "deepseek-moe-16b",
                               torch.bfloat16)):
        cfg = get_config(arch)
        q, k, v = _bhld_views(gen, dev, LLAMA_SLOTS, cfg.n_heads,
                              cfg.n_kv_heads, 1, LLAMA_MAX_LEN, cfg.hd, dtype)
        kv_len = rng.integers(64, 1057, size=LLAMA_SLOTS)
        kv_len[0] = 0
        cases.append((name, q, k, v, torch.from_numpy(kv_len).to(
            dev, torch.int32)))
    rows, worst = [], 0.0
    for name, q, k, v, kl in cases:
        dt = "bf16" if q.dtype == torch.bfloat16 else "fp32"
        whole = flash_attention(q, k, v, kl, causal=False)
        plain = flash_attention_plain(q, k, v, kl, False).float()
        scale = float(plain.abs().max())
        tol = 2e-5 if q.dtype == torch.float32 else 2e-2 * scale
        whole_dev = device_ms(lambda: flash_attention(q, k, v, kl,
                                                      causal=False),
                              label=f"stats {name} {dt} whole")
        ops, nbytes = _flash_work(q, k, kl, False)
        for n in STATS_SLICES:
            label = f"decode_stats_{name}_B{q.shape[0]}_S{k.shape[2]}_" \
                    f"D{q.shape[3]}_{dt}_slices{n}"
            before = flash_attention.stats_launches
            got = _stats_split(q, k, v, kl, n)
            again = _stats_split(q, k, v, kl, n)
            torch.cuda.synchronize()
            require(flash_attention.stats_launches == before + 2 * n,
                    f"{label}: {flash_attention.stats_launches - before} "
                    f"launches with stats, expected {2 * n}")
            err = max(float((got - whole.float()).abs().max()),
                      float((got - plain).abs().max()))
            worst = max(worst, err)
            require(err <= tol, f"{label}: max abs err {err} against the "
                    f"whole-cache kernel and the plain version, tol {tol}")
            require(torch.equal(got, again), f"{label}: not bit-equal run "
                    "to run")
            require(torch.equal(got[0], torch.zeros_like(got[0])),
                    f"{label}: the kv_len = 0 row is not exactly 0")
            if n == 1:
                require(torch.equal(got.to(q.dtype), whole), f"{label}: one "
                        "slice differs from the whole-cache kernel's bits")
            part_bytes = 2 * n * q.shape[0] * q.shape[1] * (q.shape[3] + 2) * 4
            t_bytes = (nbytes + part_bytes) / HBM_BYTES_PER_S * 1e3
            t_ops = ops / (BF16_OPS_PER_S if q.dtype == torch.bfloat16
                           else FP32_OPS_PER_S) * 1e3
            split = lambda: _stats_split(q, k, v, kl, n)  # noqa: E731
            library = lambda: _sdpa(q, k, v, kl, False)  # noqa: E731
            rows.append({
                "shape": label, "dtype": dt, "path": "decode", "slices": n,
                "max_abs_err": err, "tol": tol, "heads": [q.shape[1],
                                                          k.shape[1]],
                "head_dim": q.shape[3], "bitwise_equal": True,
                "ms": time_ms(split), "device_ms": device_ms(
                    split, label=label),
                "whole_cache_device_ms": whole_dev,
                "plain_ms": time_ms(
                    lambda: _stats_split_plain(q, k, v, kl, n), reps=3,
                    warmup=1),
                "library_ms": time_ms(library),
                "library_device_ms": device_ms(library,
                                               label=label + " library"),
                "bytes": nbytes + part_bytes, "ops": ops,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    emit({"phase": "kernels_decode_stats", "slices": list(STATS_SLICES),
          "rows": rows, "max_abs_err": worst})
    return rows, worst


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
    # deepseek-moe-16b's attention (moe_serve's): 16/16 heads of 128, group
    # 1; prefill at L = 1024, decode of 8 slots as above.
    ds = get_config("deepseek-moe-16b")
    main_cases.append(("deepseek_prefill_L1024_D128", *_bhld_views(
        gen, dev, 1, ds.n_heads, ds.n_kv_heads, 1024, 1024, ds.hd, bf16),
        None, True))
    cache = torch.randn((2, MOE_SLOTS, MOE_MAX_LEN, ds.n_kv_heads, ds.hd),
                        generator=gen, device=dev, dtype=bf16)
    q = torch.randn((MOE_SLOTS, 1, ds.n_heads, ds.hd), generator=gen,
                    device=dev, dtype=bf16).transpose(1, 2)
    kv_len = torch.from_numpy(rng.integers(64, 1057, size=MOE_SLOTS)).to(
        dev, torch.int32)
    main_cases.append(("deepseek_decode_B8_S2048_D128", q,
                       cache[1].transpose(1, 2), cache[0].transpose(1, 2),
                       kv_len, False))
    # zamba2-1.2b's shared attention block (hybrid_serve's): 32/32 heads of
    # 64, group 1; prefill at exact lengths off every power of two, decode
    # of 8 slots over 2048 positions with ragged kv_len.
    zc = get_config("zamba2-1.2b")
    for L in (337, 1000):
        main_cases.append((f"zamba2_prefill_L{L}_D64", *_bhld_views(
            gen, dev, 1, zc.n_heads, zc.n_kv_heads, L, L, zc.hd, bf16),
            None, True))
    cache = torch.randn((2, REC_SLOTS, REC_MAX_LEN, zc.n_kv_heads, zc.hd),
                        generator=gen, device=dev, dtype=bf16)
    q = torch.randn((REC_SLOTS, 1, zc.n_heads, zc.hd), generator=gen,
                    device=dev, dtype=bf16).transpose(1, 2)
    kv_len = torch.from_numpy(rng.integers(64, 1057, size=REC_SLOTS)).to(
        dev, torch.int32)
    main_cases.append(("zamba2_decode_B8_S2048_D64", q,
                       cache[1].transpose(1, 2), cache[0].transpose(1, 2),
                       kv_len, False))
    # internvl2-2b's attention (vlm_serve's): 16/8 heads of 128, group 2;
    # prefill of the stub patches and a prompt (causal), decode of 8 slots
    # over 2048 positions with ragged kv_len.
    iv = get_config("internvl2-2b")
    L = VLM_PATCHES + VLM_PROMPT
    main_cases.append((f"internvl2_prefill_L{L}_D128", *_bhld_views(
        gen, dev, 1, iv.n_heads, iv.n_kv_heads, L, L, iv.hd, bf16),
        None, True))
    cache = torch.randn((2, VLM_SLOTS, VLM_MAX_LEN, iv.n_kv_heads, iv.hd),
                        generator=gen, device=dev, dtype=bf16)
    q = torch.randn((VLM_SLOTS, 1, iv.n_heads, iv.hd), generator=gen,
                    device=dev, dtype=bf16).transpose(1, 2)
    kv_len = torch.from_numpy(rng.integers(64, 1057, size=VLM_SLOTS)).to(
        dev, torch.int32)
    main_cases.append(("internvl2_decode_B8_S2048_D128", q,
                       cache[1].transpose(1, 2), cache[0].transpose(1, 2),
                       kv_len, False))
    # seamless-m4t-medium's (encdec_serve's): 16/16 heads of 64, group 1,
    # none causal and none with kv_len: the encoder's self-attention over
    # the frames, the decoder prompt's cross-attention over them (Lq = 32:
    # one partial 64-row tile of the tensor-core prefill) and decode's
    # cross-attention (Lq = 1 over every frame).
    sm = get_config("seamless-m4t-medium")
    Fm = sm.frontend_len
    main_cases.append((f"seamless_encoder_L{Fm}_D64", *_bhld_views(
        gen, dev, 1, sm.n_heads, sm.n_kv_heads, Fm, Fm, sm.hd, bf16),
        None, False))
    main_cases.append((
        f"seamless_cross_prefill_B{ENCDEC_BATCH}_Lq{ENCDEC_PROMPT}_Lk{Fm}",
        *_bhld_views(gen, dev, ENCDEC_BATCH, sm.n_heads, sm.n_kv_heads,
                     ENCDEC_PROMPT, Fm, sm.hd, bf16), None, False))
    main_cases.append((
        f"seamless_cross_decode_B{ENCDEC_BATCH}_Lk{Fm}",
        *_bhld_views(gen, dev, ENCDEC_BATCH, sm.n_heads, sm.n_kv_heads, 1,
                     Fm, sm.hd, bf16), None, False))
    del cache
    rows, worst = [], 0.0
    for label, q, k, v, kl, causal in main_cases:
        path = kernel_path(q.dtype, q.shape[1], k.shape[1], q.shape[2],
                           q.shape[3])
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
            "shape": label, "dtype": "bf16", "path": path, "max_abs_err": err,
            "heads": [q.shape[1], k.shape[1]], "head_dim": q.shape[3],
            "bitwise_equal": True, "library_max_abs_diff": lib_err,
            "ms": time_ms(kernel), "device_ms": device_ms(kernel, label=label),
            "plain_ms": time_ms(
                lambda: flash_attention_plain(q, k, v, kl, causal)),
            "library_ms": time_ms(library),
            "library_device_ms": device_ms(library,
                                           label=label + " library"),
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
                       library_cut_device_ms=device_ms(
                           cut_call, label=label + " library cut"))
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
    # ex_serve_lm's full run (launch.serve_lm --full): llama's heads behind
    # ServeEngine(slots=4, max_len=96).  Its prompts of 4-19 tokens prefill
    # causally at their buckets: 8 to 32 on one partial 64-row tile of the
    # tensor-core prefill, 4 (16 rows) on the split decode.  Its ticks
    # decode the 4 slots over the 96-position cache at kv_len 5-30 (the
    # prompt and up to 11 tokens; an idle slot attends to 1 key).
    for L in (4, 8, 16, 32):
        q, k, v = _bhld_views(gen, dev, 1, Hq, Hkv, L, L, D, bf16)
        path = kernel_path(bf16, Hq, Hkv, L, D)
        label = f"serve_lm_prefill_L{L}"
        _, err = _check_flash(label, q, k, v, None, True, path)
        worst = max(worst, err)
        emit({"phase": "kernels", "kernel": "flash_attention", "shape": label,
              "path": path, "max_abs_err": err, "tol": FLASH_TOL[bf16],
              "bitwise_equal": True})
    cache = torch.randn((2, serve_lm.SLOTS, serve_lm.MAX_LEN, Hkv, D),
                        generator=gen, device=dev, dtype=bf16)
    q = torch.randn((serve_lm.SLOTS, 1, Hq, D), generator=gen, device=dev,
                    dtype=bf16).transpose(1, 2)
    lens = [1, 5, 19, 30]
    kl = torch.tensor(lens, dtype=torch.int32, device=dev)
    label = f"serve_lm_decode_B{serve_lm.SLOTS}_S{serve_lm.MAX_LEN}"
    _, err = _check_flash(label, q, cache[1].transpose(1, 2),
                          cache[0].transpose(1, 2), kl, False, "decode")
    worst = max(worst, err)
    emit({"phase": "kernels", "kernel": "flash_attention", "shape": label,
          "path": "decode", "kv_len": lens, "max_abs_err": err,
          "tol": FLASH_TOL[bf16], "bitwise_equal": True})
    del cache
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


# K2's backward: tolerances against flash_attention_bwd_plain (relative to
# max|ref|, plus an absolute floor): bf16 outputs round to 8 bits, fp32
# sums run in another order.
FLASH_BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 0.0)}


def _bwd_path(q, k, v, out, dout):
    """The backward path of a CUDA call on these tensors (its gradients
    come from ``empty_like``, with the inputs' strides)."""
    B, Hq, Lq, D = q.shape
    return backward_path(q.dtype, Hq, k.shape[1], Lq, D, all(
        aligned16(t) for t in (q, k, v, out, dout)))


def _check_flash_bwd(label, q, k, v, out, dout, kv_len, causal):
    """Two launches of the backward against its plain version: each
    kernel of its path launched once per call, bitwise equal, within
    FLASH_BWD_TOL.  Returns the gradients, the largest abs error and the
    path."""
    path = _bwd_path(q, k, v, out, dout)
    before = dict(flash_attention.backward_launches)
    by_path = dict(flash_attention.backward_launches_by_path)
    got = flash_attention_bwd(q, k, v, out, dout, kv_len, causal)
    again = flash_attention_bwd(q, k, v, out, dout, kv_len, causal)
    ref = flash_attention_bwd_plain(q, k, v, out, dout, kv_len, causal)
    torch.cuda.synchronize()
    require(flash_attention.backward_launches == {
        key: n + 2 for key, n in before.items()}
        and flash_attention.backward_launches_by_path == {
            **by_path, path: by_path[path] + 2},
        f"flash_attention backward {label}: launches off by kernel or "
        f"path (expected 2 on {path})")
    rel, floor = FLASH_BWD_TOL[q.dtype]
    worst = 0.0
    for name, g, g2, r in zip(("dq", "dk", "dv"), got, again, ref):
        require(g.shape == r.shape and g.dtype == r.dtype,
                f"flash_attention backward {label}: {name} {g.shape} "
                f"{g.dtype}")
        require(torch.equal(g, g2), f"flash_attention backward {label}: "
                f"{name} not bitwise equal across two launches")
        err = float((g.float() - r.float()).abs().max())
        require(err <= rel * float(r.float().abs().max()) + floor,
                f"flash_attention backward {label}: {name} max abs err "
                f"{err} vs plain (max|ref| {float(r.abs().max())})")
        worst = max(worst, err)
    return got, worst, path


def _flash_bwd_row(label, gen, dev, B, Hq, Hkv, L, D, causal):
    """K2's backward at one bf16 shape (B, Hq/Hkv heads of D, Lq = Lk =
    L) against its plain version, on the tensor-core pair: error, bitwise
    repeat, times, device times (both kernels and each alone), the plain
    version's time, the backward of scaled_dot_product_attention by
    autograd as the library call, and the bound.  Returns (row, err)."""
    bf16 = torch.bfloat16
    q, k, v = _bhld_views(gen, dev, B, Hq, Hkv, L, L, D, bf16)
    out = flash_attention(q, k, v, causal=causal)
    dout = torch.randn((B, L, Hq, D), generator=gen, device=dev,
                       dtype=bf16).transpose(1, 2)
    (dq, dk, dv), err, path = _check_flash_bwd(label, q, k, v, out, dout,
                                               None, causal)
    require(path == "tc", f"{label}: the backward took {path}, not tc")
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                             enable_gqa=True)
    lib_grads = torch.autograd.grad(lib_out, leaves, dout, retain_graph=True)
    lib_err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(lib_grads, (dq, dk, dv)))
    require(lib_err <= 0.1 * max(float(g.abs().max()) for g in (dq, dk, dv)),
            f"{label}: the library backward disagrees by {lib_err}")
    fwd_ops, _ = _flash_work(q, k, None, causal)
    ops = fwd_ops // 4 * 10                   # 10 D per (row, live key)
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    kernel = lambda: flash_attention_bwd(  # noqa: E731
        q, k, v, out, dout, None, causal)
    library = lambda: torch.autograd.grad(  # noqa: E731
        lib_out, leaves, dout, retain_graph=True)
    by_kernel = {}
    row = {
        "shape": label, "dtype": "bf16", "heads": [Hq, Hkv], "head_dim": D,
        "causal": causal, "path": path, "max_abs_err": err,
        "bitwise_equal": True, "library_max_abs_diff": lib_err,
        "ms": time_ms(kernel, reps=10),
        "device_ms": device_ms(kernel, reps=10, label=label,
                               parts=by_kernel),
        "plain_ms": time_ms(lambda: flash_attention_bwd_plain(
            q, k, v, out, dout, None, causal), reps=5),
        "library_ms": time_ms(library, reps=10),
        "library_device_ms": device_ms(library, reps=10,
                                       label=label + " library"),
        "library_call": "torch.autograd.grad of torch.nn.functional."
                        f"scaled_dot_product_attention(q, k, v, "
                        f"is_causal={causal}, enable_gqa=True)",
        "bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    row["device_ms_by_kernel"] = {
        ("dq" if "bwd_dq" in key else "dkdv" if "bwd_dkdv" in key
         else key[:60]): ms for key, ms in by_kernel.items()}
    emit({"phase": "kernels", "kernel": "flash_attention_backward", **row})
    return row, err


def phase_flash_backward(dev):
    """K2's backward kernels against flash_attention_bwd_plain: at the LM
    train step's shape (B = 4, 32/8 heads, L = 1024, D = 64, bf16, causal)
    and at L = 512, both on the tensor-core pair, with times, device times
    (both kernels and each alone), the plain version's time, the backward
    of scaled_dot_product_attention as the library call, and the bound;
    then small cases through autograd on every forward path and both
    backward paths, fp32 and bf16."""
    cfg = get_config("llama3.2-1b")
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(dev).manual_seed(SEED + 5)
    bf16 = torch.bfloat16
    rows, worst = [], 0.0
    for L in (1024, 512):
        row, err = _flash_bwd_row(f"train_B4_L{L}_bwd", gen, dev, 4, Hq, Hkv,
                                  L, D, True)
        rows.append(row)
        worst = max(worst, err)
    # Small cases through autograd: every forward kernel under grad and both
    # backward paths (bf16 takes "tc", fp32 "general"), causal and not,
    # Lq != Lk both ways, groups 1, 4 and 8, D = 32, 64 and 128, L off the
    # 64-row tiles, ragged kv_len with a 0 row, Lq = 1.
    paths = {"tc": 0, "general": 0}
    for dtype in (torch.float32, bf16):
        for B, hq, hkv, Lq, Lk, d, causal, kl in [
                (2, 8, 2, 200, 200, 64, True, None),
                (2, 8, 8, 130, 130, 32, False, None),
                (1, 16, 2, 96, 160, 128, True, None),
                (2, 8, 2, 150, 90, 64, True, None),
                (2, 32, 8, 77, 77, 64, True, None),
                (3, 8, 2, 100, 100, 64, False, [0, 50, 100]),
                (3, 32, 8, 1, 300, 64, False, [0, 1, 299])]:
            q, k, v = _bhld_views(gen, dev, B, hq, hkv, Lq, Lk, d, dtype)
            klt = (None if kl is None
                   else torch.tensor(kl, dtype=torch.int32, device=dev))
            path = kernel_path(dtype, hq, hkv, Lq, d)
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            on_path = flash_attention.launches_by_path[path]
            out = flash_attention(*leaves, klt, causal=causal)
            require(flash_attention.launches_by_path[path] == on_path + 1,
                    f"backward case: the forward did not take {path}")
            dout = torch.randn(out.shape, generator=gen, device=dev,
                               dtype=dtype)
            label = (f"B{B}_H{hq}/{hkv}_Lq{Lq}_Lk{Lk}_D{d}"
                     f"{'_causal' if causal else ''}"
                     f"{'_kvlen' if kl else ''}_{str(dtype).split('.')[-1]}")
            got = torch.autograd.grad(out, leaves, dout, retain_graph=True)
            (dq, dk, dv), err, bpath = _check_flash_bwd(
                label, q, k, v, out.detach(), dout, klt, causal)
            paths[bpath] += 1
            require(all(torch.equal(a, b) for a, b in zip(got, (dq, dk, dv))),
                    f"backward case {label}: autograd's gradients != the "
                    "backward kernels'")
            if kl is not None and kl[0] == 0:
                require(all(torch.equal(g[0], torch.zeros_like(g[0]))
                            for g in got),
                        f"backward case {label}: the kv_len = 0 row's "
                        "gradient is not 0")
            worst = max(worst, err)
            emit({"phase": "kernels", "kernel": "flash_attention_backward",
                  "shape": label, "forward_path": path, "path": bpath,
                  "max_abs_err": err, "tol": FLASH_BWD_TOL[dtype],
                  "bitwise_equal": True})
    require(paths["tc"] > 0 and paths["general"] > 0,
            f"the backward cases did not cover both paths: {paths}")
    return rows, worst


def _grouped_bwd_row(name, x, w, dy, ends):
    """The grouped GEMM's backward (autograd through ``torch._grouped_mm``,
    the reference's ragged adjoints: dx over wᵀ, the K-ragged dw) for one
    product at deepseek-moe-16b's width on the grouped_mm route, against
    the loop route's (its plain version, one product per group): error
    relative to max|ref|, bitwise repeat, device times and the bound.  The
    port's route is torch's own derivative of ``torch._grouped_mm``, so no
    other library call stands beside it."""
    route = moe.grouped_gemm_route(x, w)
    require(route == "grouped_mm", f"grouped GEMM backward {name}: the "
            f"route is {route}")
    leaves = [t.detach().requires_grad_(True) for t in (x, w)]
    before = dict(moe.grouped_gemm.backward_launches_by_route)
    out = moe._grouped(*leaves, ends)
    got = torch.autograd.grad(out, leaves, dy, retain_graph=True)
    again = torch.autograd.grad(moe._grouped(*leaves, ends), leaves, dy)
    require(moe.grouped_gemm.backward_launches_by_route == {
        **before, "grouped_mm": before["grouped_mm"] + 2},
        f"grouped GEMM backward {name}: not counted once a call on "
        "grouped_mm")
    loop_out = moe._product("loop", *leaves, ends)
    ref = torch.autograd.grad(loop_out, leaves, dy, retain_graph=True)
    torch.cuda.synchronize()
    errs = {}
    for label, g, g2, r in zip(("dx", "dw"), got, again, ref):
        require(torch.equal(g, g2), f"grouped GEMM backward {name}: {label} "
                "not bitwise equal across two calls")
        err = float((g.float() - r.float()).abs().max())
        scale = float(r.float().abs().max())
        require(err <= MOE_FFN_BF16_TOL * scale, f"grouped GEMM backward "
                f"{name}: {label} max abs err {err} vs the loop (max|ref| "
                f"{scale})")
        errs[label] = err
    kernel = lambda: torch.autograd.grad(  # noqa: E731
        out, leaves, dy, retain_graph=True)
    plain = lambda: torch.autograd.grad(  # noqa: E731
        loop_out, leaves, dy, retain_graph=True)
    m, k = x.shape
    N = w.shape[-1]
    ops = 2 * 2 * m * k * N                   # dx and dw, 2 m k n each
    nbytes = (2 * x.numel() + dy.numel() + 2 * w.numel()) * x.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    row = {"kernel": "grouped_gemm_backward", "shape": name,
           "rows": m, "k": k, "n": N, "groups": w.shape[0], "dtype": "bf16",
           "route": route, "max_abs_err": errs, "bitwise_equal": True,
           "device_ms": device_ms(kernel, reps=10, label=name),
           "ms": time_ms(kernel, reps=10),
           "plain_ms": time_ms(plain, reps=5),
           "plain_device_ms": device_ms(plain, reps=5, label=name + " loop"),
           "library_ms": None,
           "bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    emit({"phase": "kernels", **row})
    return row


def phase_train_kernels(dev):
    """The training path's kernel rows: K2's backward at the families'
    training shapes (deepseek-moe-16b: 16/16 heads of 128, causal, B = 4,
    L = 1024, where the tensor-core dkdv spills; internvl2-2b: 16/8 heads
    of 128, causal, L = 256 patches + 1024 tokens; zamba2-1.2b's shared
    block: 32/32 heads of 64, causal, L = 1024; seamless-m4t-medium: 16/16
    heads of 64, non-causal, L = 1024, its encoder's and its
    cross-attention's shape in training, and causal, its decoder's
    self-attention), then the grouped GEMM's backward
    at deepseek-moe-16b's width: both products of one MoE layer over the
    4 x 1024 tokens' 6 assignments each, routed by a random router.
    Returns the K2 rows, their largest error and the grouped GEMM rows."""
    gen = torch.Generator(dev).manual_seed(SEED + 7)
    ds, vl, zb, sm = (get_config(a) for a in (
        "deepseek-moe-16b", "internvl2-2b", "zamba2-1.2b",
        "seamless-m4t-medium"))
    rows, worst = [], 0.0
    for label, cfg, L, causal in (
            ("deepseek_train_B4_L1024_D128_bwd", ds, 1024, True),
            ("internvl2_train_B4_L1280_D128_g2_bwd", vl, VLM_PATCHES + 1024,
             True),
            ("zamba2_train_B4_L1024_D64_bwd", zb, 1024, True),
            ("seamless_train_B4_L1024_D64_noncausal_bwd", sm, 1024, False),
            ("seamless_dec_train_B4_L1024_D64_bwd", sm, 1024, True)):
        row, err = _flash_bwd_row(label, gen, dev, 4, cfg.n_heads,
                                  cfg.n_kv_heads, L, cfg.hd, causal)
        rows.append(row)
        worst = max(worst, err)

    bf16 = torch.bfloat16
    d, E, f, k = ds.d_model, ds.n_experts, ds.expert_d_ff, ds.top_k
    x = torch.randn((4 * 1024, d), generator=gen, device=dev).to(bf16)
    router = torch.randn((d, E), generator=gen, device=dev) * d ** -0.5
    idx, _, _ = moe.router_topk(x, router, k)
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    ends = torch.searchsorted(flat[order], torch.arange(E, device=dev),
                              right=True, out_int32=True)
    xs = x[order // k].contiguous()
    act = torch.randn((xs.shape[0], f), generator=gen, device=dev).to(bf16)
    w13 = (torch.randn((E, d, 2 * f), generator=gen, device=dev)
           * d ** -0.5).to(bf16)
    w2 = (torch.randn((E, f, d), generator=gen, device=dev)
          * f ** -0.5).to(bf16)
    gg = [_grouped_bwd_row(
        name, a, w, torch.randn((a.shape[0], w.shape[-1]), generator=gen,
                                device=dev).to(bf16), ends)
        for name, a, w in (("deepseek_w13_T4096x6_bwd", xs, w13),
                           ("deepseek_w2_T4096x6_bwd", act, w2))]
    return rows, worst, gg


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
    """Prefill each prompt as the engine does (in its bucket for the
    KV-cache families, at its exact length for the recurrent ones), splice
    every key of the caches into one batch, then ``steps`` greedy decode
    steps.  Returns logits, tokens, the final cache and K2's launches per
    call."""
    logits, caches, launches = [], [], []
    for p in prompts:
        batch = (_bucketed(p, dev) if cfg.family in ("dense", "moe")
                 else {"tokens": torch.from_numpy(p)[None].to(dev)})
        before = flash_attention.launches
        lg, c = lm.prefill(cfg, params, batch, max_len)
        launches.append(flash_attention.launches - before)
        logits.append(lg[:, -1])
        caches.append(c)
    cache = {key: torch.cat([c[key] for c in caches],
                            dim=0 if key == "len" else 1)
             for key in caches[0]}
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
    """Main path: the full bf16 llama3.2-1b behind ServeEngine, which
    replays its steps from CUDA graphs; then held against an eager twin
    (:func:`_graph_check`)."""
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
    t_run = time.perf_counter()
    with _LogitLog(engine, reqs) as log:
        decode_s, admit_s = _timed_ticks(engine)
    run_s = time.perf_counter() - t_run
    launches = flash_attention.launches       # ... and ends here
    by_path = dict(flash_attention.launches_by_path)
    counts = dict(engine.trace_counts)
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

    prefill_ms, replay_ms = {}, {}
    for L in sorted({ServeEngine._bucket(len(r.prompt)) for r in reqs}):
        batch = _bucketed(reqs[0].prompt[:1].repeat(L), dev)
        prefill_ms[L] = time_ms(lambda: lm.prefill(
            cfg, engine.params, batch, LLAMA_MAX_LEN), reps=5, warmup=1)
        replay_ms[L] = time_ms(engine.steps[("prefill", L)], reps=5,
                               warmup=1)
    tick_ms = statistics.median(decode_s) * 1e3
    decode_row = next(r for r in flash_rows if r["shape"].startswith("decode"))
    tokens = s.generated_tokens + s.prefills
    emit({"phase": "lm_serve", "arch": cfg.name, "n_layers": cfg.n_layers,
          "dtype": "bfloat16", "graphs": engine.graphs, "slots": LLAMA_SLOTS,
          "max_len": LLAMA_MAX_LEN, "requests": len(reqs),
          "prompt_lengths": [len(r.prompt) for r in reqs],
          "prefills": s.prefills, "ticks": s.ticks, "completed": s.completed,
          "tokens": tokens, "flash_attention_launches": launches,
          "setup_s": setup_s, "run_s": run_s, "tok_per_s": tokens / run_s,
          "decode_tick_ms_median": tick_ms,
          "decode_tick_ms_p90": float(np.percentile(decode_s, 90)) * 1e3,
          "admit_tick_ms_median": statistics.median(admit_s) * 1e3,
          "prefill_ms_by_bucket": prefill_ms,
          "prefill_replay_ms_by_bucket": replay_ms,
          "flash_attention_launches_by_path": by_path,
          "k2_share_of_decode_tick": (
              cfg.n_layers * decode_row["device_ms"] / tick_ms
              if isinstance(decode_row["device_ms"], float)
              else "not measured"),
          "teacher_forced_exact": exact, "teacher_forced_checked": 64,
          "teacher_forced_max_gap": max(gaps), "gap_tol": SERVE_GAP_TOL,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    prof = _profile_decode(engine, cfg, "lm_profile", LLAMA_SLOTS,
                           k2_per_tick=cfg.n_layers)
    _graph_check("lm_serve", engine, (reqs, log, decode_s, admit_s), counts,
                 prof, _eager_run(engine, reqs))
    return launches, by_path


def _timed_ticks(engine):
    """Tick ``engine`` until every request is done; returns the host
    seconds of the ticks that only decoded and of those that admitted."""
    decode_s, admit_s = [], []
    while engine.queue or any(r is not None for r in engine.live):
        prefills = engine.stats.prefills
        t = time.perf_counter()
        engine.tick()
        torch.cuda.synchronize()
        (decode_s if engine.stats.prefills == prefills else admit_s).append(
            time.perf_counter() - t)
    return decode_s, admit_s


def _kernel_kind(name: str) -> str:
    """The class of a profiled device entry, by its name: K2, the grouped
    GEMM (CUTLASS's grouped kernel behind ``torch._grouped_mm``), the
    other GEMMs (cuBLAS, CUTLASS), or elementwise and the rest."""
    low = name.lower()
    if "flash_" in low:
        return "k2"
    if "group" in low:
        return "grouped_gemm"
    if any(key in low for key in ("gemm", "gemv", "nvjet", "cutlass",
                                  "xmma", "cublas")):
        return "gemm"
    return "elementwise_and_other"


def _profile_decode(engine, cfg, phase: str, slots: int, ticks: int = 4,
                    k2_per_tick: int = 0, grouped: bool = False):
    """Where a decode tick's time goes: ``torch.profiler`` over a few ticks
    with all ``slots`` live, after the counted run.  Prints the device's
    busy share of the window, kernel time by name and by class
    (:func:`_kernel_kind`) and the launches per tick; "not measured" where
    the trace holds no device time.  Where the engine replays CUDA graphs
    the window must show the kernels the graphs launch: ``k2_per_tick``
    K2 kernels a tick and, with ``grouped``, the grouped GEMM's.  The
    ticks are the active step of a schedule after one traced warm-up tick
    (a window's first call loses events: :func:`device_ms`).  Returns the
    printed record."""
    rng = np.random.default_rng(SEED + 3)
    for i in range(slots):
        engine.submit(Request(uid=100 + i, prompt=rng.integers(
            1, cfg.vocab, size=512), max_new_tokens=ticks + 3, eos_id=-1))
    engine.tick()                             # admit all, one decode
    torch.cuda.synchronize()
    require(all(r is not None for r in engine.live),
            f"{phase}: not every slot is live in the profiled window")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    traced = []
    with torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
            on_trace_ready=lambda p: traced.append(p.key_averages())
    ) as prof:
        engine.tick()
        torch.cuda.synchronize()
        prof.step()                            # the warm-up tick ends
        t = time.perf_counter()
        for _ in range(ticks):
            engine.tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        prof.step()                            # the active step ends
    kernels = [e for e in (traced[0] if traced else [])
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k2 = [e for e in kernels if "flash_" in e.key]
    k2_ms = sum(e.self_device_time_total for e in k2) / 1e3 / ticks
    by_kind, launches_by_kind = {}, {}
    for e in kernels:
        kind = _kernel_kind(e.key)
        by_kind[kind] = (by_kind.get(kind, 0.0)
                         + e.self_device_time_total / 1e3 / ticks)
        launches_by_kind[kind] = launches_by_kind.get(kind, 0) + e.count / ticks
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    k2_count = sum(e.count for e in k2) / ticks
    if engine.graphs:
        require(k2_count == k2_per_tick, f"{phase}: {k2_count} K2 kernels a "
                f"replayed tick in the profile, expected {k2_per_tick}")
        require(not grouped or launches_by_kind.get("grouped_gemm", 0) > 0,
                f"{phase}: no grouped GEMM kernel in the replayed ticks")
    record = {
        "phase": phase, "ticks": ticks, "live_slots": slots,
        "graphs": engine.graphs, "window_ms": wall_ms,
        "device_busy_ms": busy_ms if kernels else "not measured",
        "device_busy_share": busy_ms / wall_ms if kernels
        else "not measured",
        "kernel_launches_per_tick": sum(e.count for e in kernels) / ticks,
        "k2_device_ms_per_tick": k2_ms if k2 else "not measured",
        "k2_launches_per_tick": k2_count,
        "device_ms_per_tick_by_kind": by_kind if kernels
        else "not measured",
        "launches_per_tick_by_kind": launches_by_kind,
        "top_kernels_ms_per_tick": {
            e.key[:80]: e.self_device_time_total / 1e3 / ticks
            for e in top}}
    emit(record)
    return record


# ------------------------------------------------------------- MoE serving
class _RouteLog:
    """Records the experts ``models.moe.router_topk`` picks, call by call
    (the MoE layers in the order they run), while it is entered: it wraps
    the module's function, which ``moe_ffn`` looks up at each call, and
    puts it back on exit.  With ``gaps`` each call also records, per
    token, the gap between the k-th and (k+1)-th router probability (a
    near-tie that rounding may flip).  With ``force``, one index tensor per
    call in call order, each call still records the router's own choice
    but routes to the forced experts, weighted as ``router_topk`` weights
    its own: the router's probabilities there, renormalised.  It stores
    device tensors and syncs nothing."""

    def __init__(self, gaps: bool = False, force=None):
        self.gaps, self.force = gaps, force
        self.calls = []

    def __enter__(self):
        self._orig = moe.router_topk

        def recording(x, w_router, k):
            idx, w, aux = self._orig(x, w_router, k)
            gap = None
            if self.gaps or self.force is not None:
                probs = torch.softmax(x.float() @ w_router.float(), -1)
            if self.gaps:
                top = probs.topk(k + 1, dim=-1).values
                gap = top[..., k - 1] - top[..., k]
            if self.force is not None:
                forced = self.force[len(self.calls)].reshape(idx.shape)
                w = probs.gather(-1, forced)
                w = (w / w.sum(-1, keepdim=True).clamp_min(1e-9)).to(x.dtype)
            self.calls.append((idx, gap))
            return (idx if self.force is None else forced), w, aux

        moe.router_topk = recording
        return self

    def __exit__(self, *exc):
        moe.router_topk = self._orig


def _expert_sets(idx):
    """The chosen experts as sets: each row's top-k indices sorted."""
    return idx.sort(dim=-1).values


def phase_moe_parity(dev):
    """deepseek-moe-16b at full width cut to 2 layers (the dense first
    layer and one MoE layer with all 64 experts and the 2 shared), fp32:
    the card against the CPU on the same weights, as lm_parity, with the
    router's expert sets equal at every (token, layer); then the MoE FFN
    alone at full width in bf16 on the card against the dense oracle."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), n_layers=2,
                              dtype=torch.float32)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    cpu_params = _to_cpu(params)
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int64)
               for n in (100, 300)]
    max_len, steps = 512 + 16, 8
    _zero_counts()
    with _RouteLog(gaps=True) as g_log:
        g_logits, g_toks, g_cache, launches = _lm_run(cfg, params, prompts,
                                                      max_len, steps, dev)
    torch.cuda.synchronize()
    g_routes = dict(moe.grouped_gemm.launches_by_route)
    require(launches == [cfg.n_layers] * (len(prompts) + steps),
            f"moe_parity: flash_attention launches per call {launches}, "
            f"expected {cfg.n_layers} each")
    with _RouteLog() as c_log:
        c_logits, c_toks, c_cache, c_launches = _lm_run(
            cfg, cpu_params, prompts, max_len, steps, torch.device("cpu"))
    require(c_launches == [0] * len(c_launches), "the CPU run launched K2")
    n_calls = len(prompts) + steps                   # one MoE layer each
    require(len(g_log.calls) == len(c_log.calls) == n_calls,
            f"moe_parity: router calls {len(g_log.calls)} / "
            f"{len(c_log.calls)}, expected {n_calls}")
    for (gi, _), (ci, _) in zip(g_log.calls, c_log.calls):
        require(torch.equal(_expert_sets(gi).cpu(), _expert_sets(ci)),
                "moe_parity: the router chose other experts on the card "
                "than on the CPU")
    min_gap = min(float(gap.min()) for _, gap in g_log.calls)
    errs = [allclose_err(g.cpu(), c, LM_PARITY_TOL)
            for g, c in zip(g_logits, c_logits)]
    errs += [allclose_err(g_cache[key].cpu(), c_cache[key], LM_PARITY_TOL)
             for key in ("k", "v")]
    max_abs = max(float((g.cpu() - c).abs().max())
                  for g, c in zip(g_logits, c_logits))
    require(max(errs) <= LM_PARITY_TOL, f"moe_parity: card vs CPU beyond "
            f"{LM_PARITY_TOL}: excess {max(errs)}")
    require(torch.equal(g_toks.cpu(), c_toks),
            f"moe_parity: greedy tokens differ: {g_toks.tolist()} vs "
            f"{c_toks.tolist()}")
    require(torch.equal(g_cache["len"].cpu(), c_cache["len"]),
            "moe_parity: cache lengths differ")
    peak_2layer = torch.cuda.max_memory_allocated() / 1e9

    # The MoE FFN alone at full width, bf16, 512 tokens: the layer's
    # weights rounded to bf16, against the dense oracle on the card.
    bf16 = torch.bfloat16
    layer = params["layers"]
    p = {"router": layer["router"][0].to(bf16),
         "w13": layer["moe_w13"][0].to(bf16), "w2": layer["moe_w2"][0].to(bf16)}
    del params, cpu_params, g_cache, c_cache
    x = torch.randn((1, 512, cfg.d_model), generator=torch.Generator(
        dev).manual_seed(SEED + 5), device=dev).to(bf16)
    before = dict(moe.grouped_gemm.launches_by_route)
    out, aux = moe.moe_ffn(cfg, p, x)
    again, _ = moe.moe_ffn(cfg, p, x)
    ffn_routes = {r: n - before[r]
                  for r, n in moe.grouped_gemm.launches_by_route.items()}
    ref, ref_aux = moe.moe_ffn_dense_ref(cfg, p, x)
    torch.cuda.synchronize()
    scale = float(ref.float().abs().max())
    ffn_err = float((out.float() - ref.float()).abs().max())
    require(ffn_routes == {"grouped_mm": 4, "loop": 0},
            f"moe_parity: the bf16 MoE FFN took the routes {ffn_routes}, "
            "expected 2 grouped_mm calls each")
    require(bool(torch.isfinite(out).all()) and out.shape == x.shape,
            "moe_parity: the bf16 MoE FFN's output is not finite")
    require(ffn_err <= MOE_FFN_BF16_TOL * scale, f"moe_parity: the bf16 MoE "
            f"FFN is {ffn_err} off the dense oracle (max|ref| {scale})")
    require(torch.equal(out, again), "moe_parity: the bf16 MoE FFN is not "
            "bit-equal run to run")
    require(abs(float(aux) - float(ref_aux)) <= 1e-6,
            "moe_parity: the routed and dense aux losses differ")
    ffn = lambda: moe.moe_ffn(cfg, p, x)  # noqa: E731
    emit({"phase": "moe_parity", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "experts": [cfg.n_experts, cfg.top_k, cfg.n_shared_experts],
          "vocab": cfg.vocab, "dtype": "float32",
          "prompt_lengths": [len(p) for p in prompts], "decode_steps": steps,
          "launches_per_call": launches, "grouped_gemm_routes": g_routes,
          "logits_max_abs_diff": max_abs, "allclose_excess": max(errs),
          "tol": LM_PARITY_TOL, "greedy_tokens_equal": True,
          "expert_sets_equal": True, "router_calls": n_calls,
          "min_router_gap_kth_vs_next": min_gap,
          "tokens": g_toks.tolist(), "peak_mem_gb": peak_2layer,
          "ffn_bf16": {"tokens": x.shape[1], "routes_two_calls": ffn_routes,
                       "max_abs_err": ffn_err, "ref_max_abs": scale,
                       "tol_rel": MOE_FFN_BF16_TOL, "bit_equal_twice": True,
                       "ms": time_ms(ffn),
                       "device_ms": device_ms(ffn, label="moe_ffn bf16")}})


def _serve_tick_routes(calls, watch, admitted, decoded, n_moe):
    """After one engine tick whose router calls are ``calls`` (each
    admitted request's prefill, then the decode of the ``decoded``
    requests; one call per MoE layer each): the experts each watched
    request's tokens were routed to, in the router's order.  ``watch`` maps
    a request's uid to its record: its slot, its prompt's experts by layer,
    and one entry by layer for each decode step that fed it a token."""
    require(len(calls) == n_moe * (len(admitted) + int(bool(decoded))),
            f"moe_serve: {len(calls)} router calls in a tick of "
            f"{len(admitted)} prefills, expected {n_moe} per prefill and "
            "per decode")
    for j, r in enumerate(admitted):
        if r.uid in watch:
            watch[r.uid]["prompt"] = [
                idx[0, :len(r.prompt)]
                for idx, _ in calls[j * n_moe:(j + 1) * n_moe]]
    for r in decoded:
        if r.uid in watch:
            slot = watch[r.uid]["slot"]
            watch[r.uid]["decode"].append([idx[slot, 0]
                                           for idx, _ in calls[-n_moe:]])


def _serve_watched(engine, reqs, n_moe):
    """Serve ``reqs`` to the end, recording the experts the first two were
    routed to (:func:`_serve_tick_routes`).  Each tick is timed alone, from
    its launch to the card's end of it; the bookkeeping of its routes runs
    outside the clock.  The router is watched call by call, so the engine
    runs eagerly.  Returns the decode ticks' and the admitting ticks'
    seconds, the watched requests' records and the served logits
    (:class:`_LogitLog`)."""
    require(not engine.graphs, "a watched engine must run eagerly")
    for r in reqs:
        engine.submit(r)
    watch = {r.uid: {"slot": None, "prompt": None, "decode": []}
             for r in reqs[:2]}
    decode_s, admit_s = [], []
    with _LogitLog(engine, reqs) as logits:
        while engine.queue or any(r is not None for r in engine.live):
            queued = list(engine.queue)
            live = [r for r in engine.live if r is not None]
            prefills, ticks = engine.stats.prefills, engine.stats.ticks
            with _RouteLog() as log:
                t = time.perf_counter()
                engine.tick()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
            (decode_s if engine.stats.prefills == prefills
             else admit_s).append(dt)
            admitted = queued[:len(queued) - len(engine.queue)]
            for r in admitted:
                if r.uid in watch:
                    watch[r.uid]["slot"] = next(
                        i for i, x in enumerate(engine.live) if x is r)
            _serve_tick_routes(log.calls, watch, admitted,
                               live + admitted if engine.stats.ticks > ticks
                               else [], n_moe)
    return decode_s, admit_s, watch, logits


def _rescore(cfg, params, reqs, watch, n_moe, dev, force: bool):
    """Each watched request re-scored by one teacher-forced forward over its
    prompt and served tokens; with ``force`` that pass is routed at every
    (position, layer) to the experts serving chose there, so it computes
    serving's function.  The router's own choices in the pass are counted
    against serving's by kind of position (prompt, decode) and MoE layer.
    Returns the counts, the router gaps (all and where the choices
    differ) and, per served token, its gap below the teacher-forced top
    logit and whether every layer agreed at the position that fed it."""
    flips = {"prompt": [0] * n_moe, "decode": [0] * n_moe}
    pairs = {"prompt": 0, "decode": 0}
    flip_gaps, all_gaps, token_gaps, token_agree, exact = [], [], [], [], 0
    for r in reqs[:2]:
        n, rec = len(r.prompt), watch[r.uid]
        require(len(rec["decode"]) == len(r.out_tokens) - 1,
                f"{len(rec['decode'])} decode steps recorded for a request "
                f"of {len(r.out_tokens)} tokens")
        served = [torch.cat([rec["prompt"][layer]]
                            + [step[layer][None] for step in rec["decode"]])
                  for layer in range(n_moe)]          # (n + 31, k) each
        toks = np.concatenate([r.prompt, r.out_tokens[:-1]])
        with _RouteLog(gaps=True, force=served if force else None) as log:
            logits, _ = lm.forward(cfg, params, {
                "tokens": torch.from_numpy(toks)[None].to(dev)})
        require(len(log.calls) == n_moe, f"the teacher-forced forward made "
                f"{len(log.calls)} router calls, expected {n_moe}")
        same = torch.ones(len(toks), dtype=torch.bool, device=dev)
        for layer, (idx, gap) in enumerate(log.calls):
            agree = (_expert_sets(idx[0])
                     == _expert_sets(served[layer])).all(-1)
            same &= agree
            flips["prompt"][layer] += int((~agree[:n]).sum())
            flips["decode"][layer] += int((~agree[n:]).sum())
            flip_gaps.append(gap[0][~agree])
            all_gaps.append(gap[0])
        pairs["prompt"] += n * n_moe
        pairs["decode"] += (len(toks) - n) * n_moe
        rows = logits[0, n - 1:n - 1 + len(r.out_tokens)].float()
        served_toks = torch.tensor(r.out_tokens, device=dev)
        require(bool(torch.isfinite(rows).all()), "non-finite logits")
        token_gaps.append(rows.max(-1).values
                          - rows[torch.arange(len(served_toks)), served_toks])
        token_agree.append(same[n - 1:n - 1 + len(r.out_tokens)])
        exact += int((rows.argmax(-1) == served_toks).sum())
    flip_gaps, all_gaps = torch.cat(flip_gaps), torch.cat(all_gaps)
    n_flips = sum(flips["prompt"]) + sum(flips["decode"])
    n_pairs = pairs["prompt"] + pairs["decode"]
    token_gaps, token_agree = torch.cat(token_gaps), torch.cat(token_agree)
    summary = {
        "route_pairs": n_pairs, "route_flips": n_flips,
        "route_flip_share": n_flips / n_pairs,
        "route_pairs_by_kind": pairs,
        "route_flips_by_layer": flips,
        "route_flip_share_by_kind": {
            kind: sum(flips[kind]) / pairs[kind] for kind in pairs},
        "route_flip_max_share_of_a_layer": {
            kind: max(flips[kind]) * n_moe / pairs[kind] for kind in pairs},
        "route_flip_max_router_gap": (float(flip_gaps.max())
                                      if flip_gaps.numel() else 0.0),
        "router_gap_quantiles": {
            q: float(torch.quantile(all_gaps.float(), q))
            for q in (0.01, 0.05, 0.5)},
        "teacher_forced_exact": exact,
        "teacher_forced_checked": len(token_gaps),
        "teacher_forced_agreed": int(token_agree.sum())}
    return summary, token_gaps, token_agree


def _moe_route_fp32(dev, prompts):
    """The router's gate where rounding cannot flip it: the full 28-layer
    deepseek-moe-16b in fp32 (the bf16 model's weights before rounding)
    serves two prompts, 32 tokens each, behind ServeEngine, and an
    unforced teacher-forced forward re-scores them.  The router may choose
    other experts in the two passes at no more than MOE_ROUTE_FLIP_SHARE of
    the (position, layer) pairs, and every served token fed by positions
    where every layer agreed is within SERVE_GAP_TOL of the top logit."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              dtype=torch.float32, param_dtype=torch.float32)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    engine = ServeEngine(cfg, params, slots=2, max_len=MOE_MAX_LEN,
                         device=dev)
    del params
    reqs = [Request(uid=i, prompt=p, max_new_tokens=32, eos_id=-1)
            for i, p in enumerate(prompts)]
    _, _, watch, _ = _serve_watched(engine, reqs, n_moe)
    require(all(r.done and len(r.out_tokens) == 32 for r in reqs),
            f"moe_route_fp32: token counts {[len(r.out_tokens) for r in reqs]}")
    check, token_gaps, agreed = _rescore(cfg, engine.params, reqs, watch,
                                         n_moe, dev, force=False)
    held = token_gaps[agreed]
    check["teacher_forced_max_gap"] = float(held.max()) if held.numel() else 0.0
    emit({"phase": "moe_route_fp32", "arch": cfg.name,
          "n_layers": cfg.n_layers, "dtype": "float32",
          "prompt_lengths": [len(p) for p in prompts], **check,
          "route_flip_tol": MOE_ROUTE_FLIP_SHARE, "gap_tol": SERVE_GAP_TOL,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    require(check["route_flips"] <= MOE_ROUTE_FLIP_SHARE * check["route_pairs"],
            f"moe_route_fp32: the router chose other experts at "
            f"{check['route_flips']} of {check['route_pairs']} (position, "
            "layer) pairs in serving than in teacher forcing")
    require(check["teacher_forced_max_gap"] <= SERVE_GAP_TOL,
            f"moe_route_fp32: a served token is "
            f"{check['teacher_forced_max_gap']} below the teacher-forced top "
            "logit where every layer agreed")


def phase_moe_serve(dev, flash_rows):
    """Main path: the full 28-layer bf16 deepseek-moe-16b behind
    ServeEngine, every layer's attention through K2 and every MoE layer's
    experts through the grouped GEMM's grouped_mm route; then the same
    model in fp32 holds the router (:func:`_moe_route_fp32`)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("deepseek-moe-16b")
    cfg = dataclasses.replace(cfg, param_dtype=cfg.dtype)  # the CLI's rule
    n_moe = cfg.n_layers - cfg.first_dense_layers
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    engine = ServeEngine(cfg, params, slots=MOE_SLOTS, max_len=MOE_MAX_LEN,
                         device=dev, graphs=False)
    require(engine.params["layers"]["moe_w13"] is params["layers"]["moe_w13"],
            "moe_serve: the engine copied weights already in bf16")
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size()
                     for t in optim.leaves(engine.params)) / 1e9
    resident_gb = torch.cuda.memory_allocated() / 1e9   # + the KV cache
    rng = np.random.default_rng(SEED)
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab, size=int(n)),
                    max_new_tokens=32, eos_id=-1)
            for i, n in enumerate(rng.integers(64, 1025, size=16))]

    _zero_counts()                            # the main path starts here
    decode_s, admit_s, watch, log = _serve_watched(engine, reqs, n_moe)
    run_s = sum(decode_s) + sum(admit_s)      # the ticks alone
    launches = flash_attention.launches       # ... and ends here
    by_path = dict(flash_attention.launches_by_path)
    routes = dict(moe.grouped_gemm.launches_by_route)
    s = engine.stats
    require(all(r.done and len(r.out_tokens) == 32 for r in reqs),
            f"moe_serve: token counts {[len(r.out_tokens) for r in reqs]}")
    require(s.completed == 16 and s.prefills == 16, f"moe_serve: {s}")
    require(launches == cfg.n_layers * (s.prefills + s.ticks),
            f"moe_serve: {launches} flash_attention launches, expected "
            f"{cfg.n_layers} x ({s.prefills} prefills + {s.ticks} ticks)")
    require(spmm.launches == 0, "moe_serve launched spmm_csr")
    require(by_path == {"prefill_tc": cfg.n_layers * s.prefills,
                        "decode": cfg.n_layers * s.ticks, "general": 0},
            f"moe_serve: flash_attention launches by kernel {by_path}, "
            "expected every prefill on prefill_tc, every tick on decode")
    require(routes == {"grouped_mm": 2 * n_moe * (s.prefills + s.ticks),
                       "loop": 0},
            f"moe_serve: grouped GEMM calls by route {routes}, expected "
            f"2 x {n_moe} MoE layers x (prefills + ticks) on grouped_mm")

    # Two requests re-scored by a teacher-forced forward routed as serving
    # routed them: every served token is held, and the router's own
    # choices in that pass against serving's, in each (kind, layer) cell.
    route_check, token_gaps, _ = _rescore(cfg, engine.params, reqs, watch,
                                          n_moe, dev, force=True)
    route_check.update(teacher_forced_max_gap=float(token_gaps.max()),
                       gap_tol=SERVE_GAP_TOL,
                       route_flip_cell_tol=MOE_ROUTE_FLIP_CELL_SHARE)
    emit({"phase": "moe_serve_routes", **route_check})
    worst = max(route_check["route_flip_max_share_of_a_layer"].values())
    require(worst <= MOE_ROUTE_FLIP_CELL_SHARE, f"moe_serve: in one MoE "
            f"layer the router chose other experts in teacher forcing than "
            f"in serving at {worst:.3f} of one kind of position")
    require(route_check["teacher_forced_max_gap"] <= SERVE_GAP_TOL,
            f"moe_serve: a served token is "
            f"{route_check['teacher_forced_max_gap']} below the "
            "teacher-forced top logit")

    prefill_ms = {}
    for L in sorted({ServeEngine._bucket(len(r.prompt)) for r in reqs}):
        batch = _bucketed(reqs[0].prompt[:1].repeat(L), dev)
        prefill_ms[L] = time_ms(lambda: lm.prefill(
            cfg, engine.params, batch, MOE_MAX_LEN), reps=5, warmup=1)
    tick_ms = statistics.median(decode_s) * 1e3
    decode_row = next((r for r in flash_rows
                       if r["shape"].startswith("deepseek_decode")),
                      {"device_ms": "not measured"})
    tokens = s.generated_tokens + s.prefills
    emit({"phase": "moe_serve", "arch": cfg.name, "n_layers": cfg.n_layers,
          "moe_layers": n_moe, "dtype": "bfloat16",
          "params": cfg.params_count(), "weights_gb": weights_gb,
          "resident_gb": resident_gb,
          "slots": MOE_SLOTS, "max_len": MOE_MAX_LEN, "requests": len(reqs),
          "prompt_lengths": [len(r.prompt) for r in reqs],
          "prefills": s.prefills, "ticks": s.ticks, "completed": s.completed,
          "tokens": tokens, "flash_attention_launches": launches,
          "setup_s": setup_s, "run_s": run_s, "tok_per_s": tokens / run_s,
          "decode_tick_ms_median": tick_ms,
          "decode_tick_ms_p90": float(np.percentile(decode_s, 90)) * 1e3,
          "admit_tick_ms_median": statistics.median(admit_s) * 1e3,
          "prefill_ms_by_bucket": prefill_ms,
          "flash_attention_launches_by_path": by_path,
          "grouped_gemm_route": "grouped_mm",
          "grouped_gemm_launches_by_route": routes,
          "k2_share_of_decode_tick": (
              cfg.n_layers * decode_row["device_ms"] / tick_ms
              if isinstance(decode_row["device_ms"], float)
              else "not measured"),
          **route_check,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    _profile_decode(engine, cfg, "moe_profile", MOE_SLOTS)
    _moe_graphs(engine, (reqs, log, decode_s, admit_s), dev)
    del engine, log
    _moe_route_fp32(dev, [r.prompt for r in reqs[:2]])
    return launches, by_path


def _moe_graphs(eager, eager_run, dev):
    """moe_serve's requests through the engine as users get it: the same
    weights behind a ServeEngine that resolves to CUDA graphs (bf16, the
    grouped_mm route), held against the eager, router-watched run
    ``eager_run`` by :func:`_graph_check`; K2 and the grouped GEMM counted
    per replay, exactly by kernel and route, and both seen in a profiled
    window of replayed ticks."""
    cfg = eager.cfg
    n_moe = cfg.n_layers - cfg.first_dense_layers
    engine = ServeEngine(cfg, eager.params, slots=MOE_SLOTS,
                         max_len=MOE_MAX_LEN, device=dev)
    reqs = _copies(eager_run[0])
    for r in reqs:
        engine.submit(r)
    before = _counts()
    routes = dict(moe.grouped_gemm.launches_by_route)
    with _LogitLog(engine, reqs) as log:
        decode_s, admit_s = _timed_ticks(engine)
    launched = _counts_delta(before)[0]
    routes = {k: moe.grouped_gemm.launches_by_route[k] - routes[k]
              for k in routes}
    counts = dict(engine.trace_counts)
    prefills, ticks = engine.stats.prefills, engine.stats.ticks
    calls = prefills + ticks
    require(launched == {"prefill_tc": cfg.n_layers * prefills,
                         "decode": cfg.n_layers * ticks},
            f"moe_serve graphs: K2 launched {launched}")
    require(routes == {"grouped_mm": 2 * n_moe * calls, "loop": 0},
            f"moe_serve graphs: grouped GEMM calls by route {routes}")
    prof = _profile_decode(engine, cfg, "moe_graph_profile", MOE_SLOTS,
                           k2_per_tick=cfg.n_layers, grouped=True)
    row = _graph_check("moe_serve", engine, (reqs, log, decode_s, admit_s),
                       counts, prof, eager_run)
    emit({"phase": "moe_serve_graph_launches", "k2": launched,
          "grouped_gemm": routes, "prefills": prefills, "ticks": ticks,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "pool_mb": row["pool_mb"]})
    del engine, log
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------ recurrent families
def _k2_sites(cfg) -> int:
    """K2 launches per prefill or decode call: one per shared-block site of
    the hybrid family, none for xLSTM."""
    return ssm.num_shared_calls(cfg) if cfg.family == "hybrid" else 0


def _fresh_device():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _recurrent_parity(phase: str, arch: str, n_layers: int, dev):
    """``arch`` at full width cut to ``n_layers``, fp32: the card against
    the CPU on the same weights.  The teacher-forced forward over a
    300-token prompt, then two prompts (100 and 300 tokens, the SSD scan
    past one chunk) prefilled at their exact lengths and 8 greedy decode
    steps: logits, every cache key and the tokens."""
    _fresh_device()
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              dtype=torch.float32)
    sites = _k2_sites(cfg)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    cpu_params = _to_cpu(params)
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int64)
               for n in (100, 300)]
    max_len, steps = 512 + 16, 8
    long = torch.from_numpy(prompts[1])[None]
    g_fwd, _ = lm.forward(cfg, params, {"tokens": long.to(dev)})
    c_fwd, _ = lm.forward(cfg, cpu_params, {"tokens": long})
    g_logits, g_toks, g_cache, launches = _lm_run(cfg, params, prompts,
                                                  max_len, steps, dev)
    torch.cuda.synchronize()
    require(launches == [sites] * (len(prompts) + steps),
            f"{phase}: flash_attention launches per call {launches}, "
            f"expected {sites} each")
    c_logits, c_toks, c_cache, c_launches = _lm_run(
        cfg, cpu_params, prompts, max_len, steps, torch.device("cpu"))
    require(c_launches == [0] * len(c_launches), "the CPU run launched K2")
    errs = {"forward": allclose_err(g_fwd.cpu(), c_fwd, LM_PARITY_TOL),
            "step_logits": max(allclose_err(g.cpu(), c, LM_PARITY_TOL)
                               for g, c in zip(g_logits, c_logits))}
    errs.update({key: allclose_err(g_cache[key].cpu(), c_cache[key],
                                   LM_PARITY_TOL)
                 for key in c_cache if key != "len"})
    require(max(errs.values()) <= LM_PARITY_TOL, f"{phase}: card vs CPU "
            f"beyond {LM_PARITY_TOL}: excess by output {errs}")
    require(torch.equal(g_toks.cpu(), c_toks),
            f"{phase}: greedy tokens differ: {g_toks.tolist()} vs "
            f"{c_toks.tolist()}")
    require(torch.equal(g_cache["len"].cpu(), c_cache["len"]),
            f"{phase}: cache lengths differ")
    emit({"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab, "dtype": "float32",
          "k2_sites": sites, "prompt_lengths": [len(p) for p in prompts],
          "forward_length": len(prompts[1]), "decode_steps": steps,
          "launches_per_call": launches,
          "forward_max_abs_diff": float((g_fwd.cpu() - c_fwd).abs().max()),
          "logits_max_abs_diff": max(float((g.cpu() - c).abs().max())
                                     for g, c in zip(g_logits, c_logits)),
          "allclose_excess_by_output": errs, "tol": LM_PARITY_TOL,
          "cache_keys": sorted(c_cache), "greedy_tokens_equal": True,
          "tokens": g_toks.tolist(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})


def phase_hybrid_parity(dev):
    """zamba2-1.2b cut to 6 layers: one shared-block site runs."""
    _recurrent_parity("hybrid_parity", "zamba2-1.2b", 6, dev)


def phase_xlstm_parity(dev):
    """xlstm-1.3b cut to 8 layers: its one sLSTM layer runs."""
    _recurrent_parity("xlstm_parity", "xlstm-1.3b", 8, dev)


def _rescore_recurrent(cfg, params, reqs, served, dev):
    """Each request's served tokens re-scored by one bf16 teacher-forced
    forward and by the fp32 model over the same weights widened (the bf16
    model's function without its activation rounding).  ``served`` maps a
    request to the logits serving computed for each of its tokens
    (:class:`_LogitLog`).  Returns, per served token, its gap below the
    bf16 forward's top logit, and per position the distance (max over the
    vocab) of serving's logits and of the bf16 forward's from the fp32
    model's, and how many served tokens are the bf16 forward's top."""
    f32 = dataclasses.replace(cfg, dtype=torch.float32,
                              param_dtype=torch.float32)
    wide = optim.tree_map(lambda t: t.float(), params)
    gaps, d_served, d_forward, exact = [], [], [], 0
    for r in reqs:
        n, count = len(r.prompt), len(r.out_tokens)
        batch = {"tokens": torch.from_numpy(np.concatenate(
            [r.prompt, r.out_tokens[:-1]]))[None].to(dev)}
        rows = lm.forward(cfg, params, batch)[0][0, n - 1:n - 1 + count]
        ref = lm.forward(f32, wide, batch)[0][0, n - 1:n - 1 + count]
        rows = rows.float()
        got = torch.stack(served[r.uid]).float()
        require(bool(torch.isfinite(rows).all() and torch.isfinite(got).all()),
                f"{cfg.name}: non-finite logits")
        tok = torch.tensor(r.out_tokens, device=dev)
        gaps.append(rows.max(-1).values - rows[torch.arange(count), tok])
        exact += int((rows.argmax(-1) == tok).sum())
        d_served.append((got - ref).abs().amax(-1))
        d_forward.append((rows - ref).abs().amax(-1))
    del wide
    return torch.cat(gaps), torch.cat(d_served), torch.cat(d_forward), exact


def _recurrent_serve(phase: str, arch: str, dev, gap_gate: bool,
                     eager_requests: int = 16):
    """Main path: the full-depth bf16 model behind ServeEngine with
    lm_serve's traffic, every prompt prefilled at its exact length.  K2
    launches once per shared-block site per prefill (prefill_tc) and per
    tick (decode).  Every served token is re-scored
    (:func:`_rescore_recurrent`): serving's logits may be no further from
    the fp32 model's than the bf16 teacher-forced forward's are
    (REC_NOISE_RATIO, at the median and at the largest position), and with
    ``gap_gate`` each token is the bf16 forward's top or within
    SERVE_GAP_TOL of it (lm_serve's gate).  The engine replays CUDA
    graphs (:func:`_graph_check`); its eager twin serves the
    ``eager_requests`` shortest prompts, in order."""
    _fresh_device()
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, param_dtype=cfg.dtype)  # the CLI's rule
    sites = _k2_sites(cfg)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    engine = ServeEngine(cfg, params, slots=REC_SLOTS, max_len=REC_MAX_LEN,
                         device=dev)
    del params                       # the engine holds the same tensors
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size()
                     for t in optim.leaves(engine.params)) / 1e9
    n_params = sum(t.numel() for t in optim.leaves(engine.params))
    cache_gb = sum(t.numel() * t.element_size()
                   for t in engine.cache.values()) / 1e9
    resident_gb = torch.cuda.memory_allocated() / 1e9
    rng = np.random.default_rng(SEED)
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab, size=int(n)),
                    max_new_tokens=32, eos_id=-1)
            for i, n in enumerate(rng.integers(64, 1025, size=16))]
    for r in reqs:
        engine.submit(r)

    _zero_counts()                            # the main path starts here
    with _LogitLog(engine, reqs) as log:
        decode_s, admit_s = _timed_ticks(engine)
    run_s = sum(decode_s) + sum(admit_s)      # the ticks alone
    launches = flash_attention.launches       # ... and ends here
    by_path = dict(flash_attention.launches_by_path)
    counts = dict(engine.trace_counts)
    s = engine.stats
    require(all(r.done and len(r.out_tokens) == 32 for r in reqs),
            f"{phase}: token counts {[len(r.out_tokens) for r in reqs]}")
    require(s.completed == 16 and s.prefills == 16, f"{phase}: {s}")
    require(launches == sites * (s.prefills + s.ticks),
            f"{phase}: {launches} flash_attention launches, expected "
            f"{sites} x ({s.prefills} prefills + {s.ticks} ticks)")
    require(by_path == {"prefill_tc": sites * s.prefills,
                        "decode": sites * s.ticks, "general": 0},
            f"{phase}: flash_attention launches by kernel {by_path}, "
            "expected every prefill on prefill_tc, every tick on decode")
    require(spmm.launches == 0, f"{phase} launched spmm_csr")

    gaps, d_served, d_forward, exact = _rescore_recurrent(
        cfg, engine.params, reqs, log.logits, dev)
    ratio = {"median": float(d_served.median() / d_forward.median()),
             "max": float(d_served.max() / d_forward.max())}

    prompt = torch.from_numpy(reqs[0].prompt[:1].repeat(1024))[None].to(dev)
    prefill_ms = {L: time_ms(lambda: lm.prefill(
        cfg, engine.params, {"tokens": prompt[:, :L]}, REC_MAX_LEN),
        reps=2, warmup=1) for L in (64, 256, 1024)}
    tokens = s.generated_tokens + s.prefills
    emit({"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
          "dtype": "bfloat16", "graphs": engine.graphs, "params": n_params,
          "params_count": cfg.params_count(), "weights_gb": weights_gb,
          "cache_gb": cache_gb, "resident_gb": resident_gb,
          "k2_sites": sites, "slots": REC_SLOTS, "max_len": REC_MAX_LEN,
          "requests": len(reqs),
          "prompt_lengths": [len(r.prompt) for r in reqs],
          "prefills": s.prefills, "ticks": s.ticks, "completed": s.completed,
          "tokens": tokens, "flash_attention_launches": launches,
          "flash_attention_launches_by_path": by_path,
          "setup_s": setup_s, "run_s": run_s, "tok_per_s": tokens / run_s,
          "decode_tick_ms_median": statistics.median(decode_s) * 1e3,
          "decode_tick_ms_p90": float(np.percentile(decode_s, 90)) * 1e3,
          "admit_tick_ms_median": statistics.median(admit_s) * 1e3,
          "prefill_ms_by_length": prefill_ms,
          "teacher_forced_exact": exact,
          "teacher_forced_checked": int(gaps.numel()),
          "teacher_forced_max_gap": float(gaps.max()),
          "gap_tol": SERVE_GAP_TOL if gap_gate else "not gated",
          "served_vs_fp32": {"median": float(d_served.median()),
                             "max": float(d_served.max())},
          "bf16_forward_vs_fp32": {"median": float(d_forward.median()),
                                   "max": float(d_forward.max())},
          "noise_ratio": ratio, "noise_ratio_tol": REC_NOISE_RATIO,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    require(max(ratio.values()) <= REC_NOISE_RATIO, f"{phase}: serving's "
            f"logits are {ratio} times as far from the fp32 model's as the "
            "bf16 teacher-forced forward's")
    require(not gap_gate or float(gaps.max()) <= SERVE_GAP_TOL,
            f"{phase}: a served token is {float(gaps.max())} below the "
            "teacher-forced top logit")
    prof = _profile_decode(engine, cfg, phase.replace("serve", "profile"),
                           REC_SLOTS, k2_per_tick=sites)
    shortest = sorted(sorted(reqs, key=lambda r: len(r.prompt))
                      [:eager_requests], key=lambda r: r.uid)
    _graph_check(phase, engine, (reqs, log, decode_s, admit_s), counts,
                 prof, _eager_run(engine, shortest))
    return launches, by_path


def phase_hybrid_serve(dev):
    return _recurrent_serve("hybrid_serve", "zamba2-1.2b", dev,
                            gap_gate=True)


def phase_xlstm_serve(dev):
    """xlstm-1.3b's served tokens are not held to SERVE_GAP_TOL: bf16
    rounding alone moves its logits by far more (REC_NOISE_RATIO).  Its
    eager twin serves XLSTM_EAGER_REQUESTS of the requests (its prefill is
    host-bound)."""
    return _recurrent_serve("xlstm_serve", "xlstm-1.3b", dev,
                            gap_gate=False,
                            eager_requests=XLSTM_EAGER_REQUESTS)


class _LogitLog:
    """Records, per request, the logits serving computed for each of its
    tokens while it is entered: it wraps the engine's own prefill and
    decode calls (``_run_prefill``, ``_run_decode``, which the engine looks
    up on itself at each call; a replayed step's outputs are those of its
    graph) and takes them off on exit.  A prefill's logits go to the
    request admitted next (in ``order``), a tick's row ``i`` to the request
    live in slot ``i``.  Each call's logits are copied once (a replay
    rewrites them); ``ticks`` holds each tick's whole (slots, 1, V)
    copy."""

    def __init__(self, engine, order):
        self.engine, self.order = engine, iter(order)
        self.logits, self.ticks = {}, []

    def __enter__(self):
        engine = self.engine
        run_prefill, run_decode = engine._run_prefill, engine._run_decode

        def prefill(prompt):
            lg, cache = run_prefill(prompt)
            self.logits[next(self.order).uid] = [lg[0, -1].clone()]
            return lg, cache

        def decode(last):
            lg, nxt = run_decode(last)
            lg = lg.clone()
            self.ticks.append(lg)
            for i, r in enumerate(engine.live):
                if r is not None:
                    self.logits[r.uid].append(lg[i, 0])
            return lg, nxt
        engine._run_prefill, engine._run_decode = prefill, decode
        return self

    def __exit__(self, *exc):
        del self.engine._run_prefill, self.engine._run_decode


def _copies(reqs):
    """Fresh requests with the prompts and budgets of ``reqs``."""
    return [Request(uid=r.uid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens, eos_id=r.eos_id)
            for r in reqs]


def _eager_run(engine, reqs):
    """``reqs`` served anew by an eager engine (``graphs=False``) on
    ``engine``'s weights and engine shape: (the served copies, their
    :class:`_LogitLog`, the decode and admitting ticks' host seconds)."""
    twin = ServeEngine(engine.cfg, engine.params, slots=engine.slots,
                       max_len=engine.max_len, device=engine.device,
                       graphs=False)
    copies = _copies(reqs)
    for r in copies:
        twin.submit(r)
    with _LogitLog(twin, copies) as log:
        decode_s, admit_s = _timed_ticks(twin)
    return copies, log, decode_s, admit_s


def _graph_check(phase, engine, run, counts, prof, eager):
    """The graph engine ``engine`` against an eager engine on the same
    weights.  ``run`` is the graph engine's run (its requests, their
    :class:`_LogitLog`, its decode and admitting ticks' host seconds),
    ``counts`` its ``trace_counts`` after it, ``prof`` the record of a
    profiled window of its replayed ticks, ``eager`` the eager engine's
    run (:func:`_eager_run`) of those requests or of a subset of them in
    order.  Every request's tokens and every served token's logits must be
    bit-equal, and, over the same requests, every tick's logits;
    ``trace_counts`` one decode step and one prefill step per distinct
    bucket (0 for the exact-length families).  Prints the
    ``<phase>_graphs`` line: both ways' decode-tick host ms and tok/s, the
    replayed ticks' device ms, capture seconds and pool MB."""
    on_card = engine.device.type == "cuda"
    require(engine.graphs is on_card, f"{phase}: the engine on "
            f"{engine.device} resolved graphs to {engine.graphs}")
    reqs, log, decode_s, admit_s = run
    e_reqs, e_log, e_decode, e_admit = eager
    by_uid = {r.uid: r for r in reqs}
    buckets = {min(ServeEngine._bucket(len(r.prompt)), engine.max_len)
               for r in reqs} if engine._bucketed else set()
    want = {"prefill": len(buckets), "decode": 1}
    tokens_equal = all(by_uid[r.uid].out_tokens == r.out_tokens
                       for r in e_reqs)
    logits_equal = all(
        len(log.logits[r.uid]) == len(e_log.logits[r.uid]) and all(
            torch.equal(a, b) for a, b in zip(log.logits[r.uid],
                                              e_log.logits[r.uid]))
        for r in e_reqs)
    same = len(e_reqs) == len(reqs)
    if same:
        logits_equal &= len(log.ticks) == len(e_log.ticks) and all(
            torch.equal(a, b) for a, b in zip(log.ticks, e_log.ticks))
    steps = engine.steps.values()
    tokens = [sum(len(r.out_tokens) for r in rs) for rs in (reqs, e_reqs)]

    def ms(secs):
        return {"median": statistics.median(secs) * 1e3,
                "p90": float(np.percentile(secs, 90)) * 1e3}
    busy = prof["device_busy_ms"]
    row = {"phase": f"{phase}_graphs", "arch": engine.cfg.name,
           "graphs": engine.graphs, "trace_counts": counts,
           "trace_counts_want": want, "requests": len(reqs),
           "eager_requests": [r.uid for r in e_reqs],
           "tokens_bit_equal": tokens_equal,
           "logits_bit_equal": logits_equal,
           "tokens_compared": tokens[1],
           "ticks_compared": len(e_log.ticks) if same else 0,
           "capture_s": sum(st.capture_s for st in steps),
           "pool_mb": sum(st.pool_bytes for st in steps) / 1e6,
           "decode_tick_host_ms": {"graph": ms(decode_s),
                                   "eager": ms(e_decode)},
           "tok_per_s": {
               "graph": tokens[0] / (sum(decode_s) + sum(admit_s)),
               "graph_without_capture": tokens[0] / (
                   sum(decode_s) + sum(admit_s)
                   - sum(st.capture_s for st in steps)),
               "eager": tokens[1] / (sum(e_decode) + sum(e_admit))},
           "replayed_tick_device_ms": (busy / prof["ticks"]
                                       if isinstance(busy, float)
                                       else "not measured"),
           "replayed_tick_window_ms": prof["window_ms"] / prof["ticks"],
           "replayed_tick_busy_share": prof["device_busy_share"]}
    emit(row)
    require(tokens_equal, f"{phase}: the graph engine's tokens differ from "
            "the eager engine's")
    require(logits_equal, f"{phase}: a served token's logits differ between "
            "the graph engine and the eager engine")
    require(counts == want, f"{phase}: trace_counts {counts}, expected "
            f"{want}")
    return row


def phase_recurrent_fp32(dev):
    """Both full-depth recurrent models in fp32 (unrounded weights) serve two
    prompts (200 tokens, past one SSD chunk, and 77), 32 tokens each,
    behind ServeEngine; each token's logits as served against the
    teacher-forced forward at that position (REC_FP32_TOL), and the served
    tokens equal to its greedy ones.  Where rounding is 2**-24 a miss is a
    fault of the state path."""
    for arch in ("zamba2-1.2b", "xlstm-1.3b"):
        _fresh_device()
        cfg = dataclasses.replace(get_config(arch), dtype=torch.float32,
                                  param_dtype=torch.float32)
        params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED),
                                dev)
        engine = ServeEngine(cfg, params, slots=2, max_len=REC_MAX_LEN,
                             device=dev)
        del params
        weights_gb = sum(t.numel() * t.element_size()
                         for t in optim.leaves(engine.params)) / 1e9
        rng = np.random.default_rng(SEED + 4)
        reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab, size=n),
                        max_new_tokens=32, eos_id=-1)
                for i, n in enumerate((200, 77))]
        for r in reqs:
            engine.submit(r)
        with _LogitLog(engine, reqs) as log:
            engine.run()
        require(all(r.done and len(r.out_tokens) == 32 for r in reqs),
                f"recurrent_fp32 {arch}: token counts "
                f"{[len(r.out_tokens) for r in reqs]}")
        excess, max_abs, equal = [], [], True
        for r in reqs:
            n = len(r.prompt)
            toks = np.concatenate([r.prompt, r.out_tokens[:-1]])
            logits, _ = lm.forward(cfg, engine.params, {
                "tokens": torch.from_numpy(toks)[None].to(dev)})
            rows = logits[0, n - 1:n - 1 + len(r.out_tokens)]
            served = torch.stack(log.logits[r.uid])
            require(served.shape == rows.shape, f"recurrent_fp32 {arch}: "
                    f"{tuple(served.shape)} served logits, expected "
                    f"{tuple(rows.shape)}")
            excess.append(allclose_err(served, rows, REC_FP32_TOL))
            max_abs.append(float((served - rows).abs().max()))
            equal &= r.out_tokens == rows.argmax(-1).tolist()
        emit({"phase": "recurrent_fp32", "arch": cfg.name,
              "n_layers": cfg.n_layers, "dtype": "float32",
              "weights_gb": weights_gb,
              "prompt_lengths": [len(r.prompt) for r in reqs],
              "tokens_checked": sum(len(r.out_tokens) for r in reqs),
              "logits_max_abs_diff": max(max_abs),
              "allclose_excess": max(excess), "tol": REC_FP32_TOL,
              "tokens_equal": equal,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        require(equal, f"recurrent_fp32 {arch}: served tokens differ from "
                "the teacher-forced greedy ones")
        require(max(excess) <= REC_FP32_TOL, f"recurrent_fp32 {arch}: served "
                f"logits beyond rtol = atol = {REC_FP32_TOL} of the "
                f"teacher-forced forward (excess {max(excess)}, max abs "
                f"{max(max_abs)})")
        del engine


# ------------------------------------------------ the VLM and enc-dec families
def _batch_run(cfg, params, batch, max_len, steps, times=None):
    """Prefill ``batch`` in one call (every row's prompt of one length:
    the reference's enc-dec prefill has no ``lengths``), then ``steps``
    greedy decode steps through the zoo.  Returns the logits of the prefill
    and of each step, the tokens (B, 1 + steps), the final cache and K2's
    launches per call; with ``times``, appends each call's host seconds
    (the card synchronised)."""
    logits, toks, launches = [], [], []
    lg, cache = None, None
    for i in range(steps + 1):
        before = flash_attention.launches
        t = time.perf_counter()
        if i == 0:
            lg, cache = lm.prefill(cfg, params, batch, max_len)
        else:
            lg, cache = lm.decode_step(cfg, params, toks[-1][:, None], cache)
        if times is not None:
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        launches.append(flash_attention.launches - before)
        logits.append(lg[:, -1])
        toks.append(lg[:, -1].argmax(-1))
    return logits, torch.stack(toks, 1), cache, launches


def _k2_per_call(cfg) -> tuple:
    """K2 launches of one prefill and of one decode step: one per decoder
    layer, and for enc-dec one per encoder layer and one cross-attention
    per decoder layer at prefill, self and cross per decoder layer at
    decode."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers, 2 * cfg.n_layers
    return cfg.n_layers, cfg.n_layers


def _frontend_batch(cfg, rng, B: int, prompt: int) -> dict:
    """numpy tokens and the stub frontend's input (VLM patches, enc-dec
    frames) from ``rng``."""
    batch = {"tokens": rng.integers(1, cfg.vocab, size=(B, prompt))}
    key = "patches" if cfg.family == "vlm" else "frames"
    n = VLM_PATCHES if cfg.family == "vlm" else cfg.frontend_len
    batch[key] = rng.standard_normal((B, n, cfg.frontend_dim),
                                     dtype=np.float32)
    return batch


def _on(batch, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _frontend_parity(phase: str, cfg, prompt: int, dev):
    """``cfg`` (a full-width model cut in depth), fp32: the card against the
    CPU on the same weights.  Two prompts of ``prompt`` tokens with the
    stub frontend's input: the teacher-forced forward, then one prefill
    and 8 greedy decode steps: logits, every cache key, the tokens."""
    _fresh_device()
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    cpu_params = _to_cpu(params)
    batch = _frontend_batch(cfg, np.random.default_rng(SEED + 2), 2, prompt)
    extra = VLM_PATCHES if cfg.family == "vlm" else 0
    max_len, steps = extra + prompt + 16, 8
    g_fwd, _ = lm.forward(cfg, params, _on(batch, dev))
    c_fwd, _ = lm.forward(cfg, cpu_params, _on(batch, "cpu"))
    g_logits, g_toks, g_cache, launches = _batch_run(
        cfg, params, _on(batch, dev), max_len, steps)
    torch.cuda.synchronize()
    per_prefill, per_step = _k2_per_call(cfg)
    require(launches == [per_prefill] + [per_step] * steps,
            f"{phase}: flash_attention launches per call {launches}, "
            f"expected {per_prefill} per prefill and {per_step} per step")
    c_logits, c_toks, c_cache, c_launches = _batch_run(
        cfg, cpu_params, _on(batch, "cpu"), max_len, steps)
    require(c_launches == [0] * len(c_launches), "the CPU run launched K2")
    errs = {"forward": allclose_err(g_fwd.cpu(), c_fwd, LM_PARITY_TOL),
            "step_logits": max(allclose_err(g.cpu(), c, LM_PARITY_TOL)
                               for g, c in zip(g_logits, c_logits))}
    errs.update({key: allclose_err(g_cache[key].cpu(), c_cache[key],
                                   LM_PARITY_TOL)
                 for key in c_cache if key not in ("len", "xlen")})
    require(max(errs.values()) <= LM_PARITY_TOL, f"{phase}: card vs CPU "
            f"beyond {LM_PARITY_TOL}: excess by output {errs}")
    require(torch.equal(g_toks.cpu(), c_toks),
            f"{phase}: greedy tokens differ: {g_toks.tolist()} vs "
            f"{c_toks.tolist()}")
    for key in ("len", "xlen"):
        require(key not in c_cache or torch.equal(g_cache[key].cpu(),
                                                  c_cache[key]),
                f"{phase}: cache {key} differs")
    emit({"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
          "n_enc_layers": cfg.n_enc_layers, "d_model": cfg.d_model,
          "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.hd,
          "vocab": cfg.vocab, "dtype": "float32",
          "batch": {k: list(v.shape) for k, v in batch.items()},
          "decode_steps": steps, "launches_per_call": launches,
          "forward_max_abs_diff": float((g_fwd.cpu() - c_fwd).abs().max()),
          "logits_max_abs_diff": max(float((g.cpu() - c).abs().max())
                                     for g, c in zip(g_logits, c_logits)),
          "allclose_excess_by_output": errs, "tol": LM_PARITY_TOL,
          "cache_keys": sorted(c_cache), "greedy_tokens_equal": True,
          "tokens": g_toks.tolist(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})


def phase_vlm_parity(dev):
    """internvl2-2b at full width cut to 2 layers: 64-token prompts after
    VLM_PATCHES patches."""
    cfg = dataclasses.replace(get_config("internvl2-2b"), n_layers=2,
                              dtype=torch.float32)
    _frontend_parity("vlm_parity", cfg, 64, dev)


def phase_encdec_parity(dev):
    """seamless-m4t-medium at full width cut to 2 encoder and 2 decoder
    layers: 16-token decoder prompts over frontend_len frames."""
    cfg = dataclasses.replace(get_config("seamless-m4t-medium"), n_layers=2,
                              n_enc_layers=2, dtype=torch.float32)
    _frontend_parity("encdec_parity", cfg, 16, dev)


def _served_gaps(cfg, params, batch, toks, start: int):
    """Each served token (``toks`` (B, n), the first from the prefill) held
    against one teacher-forced forward over the prompt and the served
    tokens but the last: its gap below that row's top logit, and how many
    are the top.  ``start`` is the prompt's last position in the forward's
    output (after any patches)."""
    n = toks.shape[1]
    fb = {**batch, "tokens": torch.cat([batch["tokens"], toks[:, :-1]], 1)}
    rows = lm.forward(cfg, params, fb)[0][:, start:start + n].float()
    require(bool(torch.isfinite(rows).all()), f"{cfg.name}: non-finite "
            "teacher-forced logits")
    top = rows.max(-1).values
    got = rows.gather(-1, toks[..., None].long())[..., 0]
    return top - got, int((rows.argmax(-1) == toks).sum())


def phase_vlm_serve(dev):
    """Main path: the full 24-layer bf16 internvl2-2b behind ServeEngine
    with lm_serve's traffic, text only, every prompt prefilled at its exact
    length.  K2 launches n_layers x (prefills + ticks), every prefill on
    prefill_tc (D = 128, group 2), every tick on decode; every served token
    held to lm_serve's gate by a teacher-forced forward.  Then the patch
    path through the zoo: VLM_PATCHES patches and a VLM_PROMPT-token
    prompt prefilled, VLM_STEPS decode steps, each token held to the same
    gate by the forward with the patches."""
    _fresh_device()
    cfg = get_config("internvl2-2b")
    cfg = dataclasses.replace(cfg, param_dtype=cfg.dtype)  # the CLI's rule
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    engine = ServeEngine(cfg, params, slots=VLM_SLOTS, max_len=VLM_MAX_LEN,
                         device=dev)
    del params                       # the engine holds the same tensors
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size()
                     for t in optim.leaves(engine.params)) / 1e9
    rng = np.random.default_rng(SEED)
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab, size=int(n)),
                    max_new_tokens=32, eos_id=-1)
            for i, n in enumerate(rng.integers(64, 1025, size=16))]
    for r in reqs:
        engine.submit(r)

    _zero_counts()                            # the main path starts here
    with _LogitLog(engine, reqs) as log:
        decode_s, admit_s = _timed_ticks(engine)
    run_s = sum(decode_s) + sum(admit_s)
    launches = flash_attention.launches       # ... and ends here
    by_path = dict(flash_attention.launches_by_path)
    counts = dict(engine.trace_counts)
    s = engine.stats
    n = cfg.n_layers
    require(all(r.done and len(r.out_tokens) == 32 for r in reqs),
            f"vlm_serve: token counts {[len(r.out_tokens) for r in reqs]}")
    require(s.completed == 16 and s.prefills == 16, f"vlm_serve: {s}")
    require(launches == n * (s.prefills + s.ticks),
            f"vlm_serve: {launches} flash_attention launches, expected "
            f"{n} x ({s.prefills} prefills + {s.ticks} ticks)")
    require(by_path == {"prefill_tc": n * s.prefills, "decode": n * s.ticks,
                        "general": 0},
            f"vlm_serve: flash_attention launches by kernel {by_path}, "
            "expected every prefill on prefill_tc, every tick on decode")
    require(spmm.launches == 0, "vlm_serve launched spmm_csr")
    gaps, exact = [], 0
    for r in reqs:
        g, e = _served_gaps(cfg, engine.params, {"tokens": torch.from_numpy(
            r.prompt)[None].to(dev)}, torch.tensor([r.out_tokens],
                                                   device=dev),
            len(r.prompt) - 1)
        gaps.append(g.flatten())
        exact += e
    gaps = torch.cat(gaps)
    require(float(gaps.max()) <= SERVE_GAP_TOL, f"vlm_serve: a served token "
            f"is {float(gaps.max())} below the teacher-forced top logit")

    # The patch path: one request with the stub frontend's patches.
    batch = _on(_frontend_batch(cfg, np.random.default_rng(SEED + 5), 1,
                                VLM_PROMPT), dev)
    before = _counts()
    _, ptoks, _, plaunches = _batch_run(cfg, engine.params, batch,
                                        VLM_MAX_LEN, VLM_STEPS)
    torch.cuda.synchronize()
    require(plaunches == [n] * (VLM_STEPS + 1) and _counts_delta(before)[0] == {
            "prefill_tc": n, "decode": n * VLM_STEPS},
            f"vlm_serve: the patch path launched K2 {plaunches} times per "
            "call, expected n_layers each, prefill on prefill_tc")
    pgaps, pexact = _served_gaps(cfg, engine.params, batch, ptoks,
                                 VLM_PATCHES + VLM_PROMPT - 1)
    require(float(pgaps.max()) <= SERVE_GAP_TOL, f"vlm_serve: a token served "
            f"after patches is {float(pgaps.max())} below the teacher-forced "
            "top logit")

    prompt = torch.from_numpy(reqs[0].prompt[:1].repeat(1024))[None].to(dev)
    prefill_ms = {L: time_ms(lambda: lm.prefill(
        cfg, engine.params, {"tokens": prompt[:, :L]}, VLM_MAX_LEN),
        reps=3, warmup=1) for L in (64, 256, 1024)}
    prefill_ms[f"{VLM_PATCHES}+{VLM_PROMPT}"] = time_ms(lambda: lm.prefill(
        cfg, engine.params, batch, VLM_MAX_LEN), reps=3, warmup=1)
    tokens = s.generated_tokens + s.prefills
    emit({"phase": "vlm_serve", "arch": cfg.name, "n_layers": n,
          "dtype": "bfloat16", "graphs": engine.graphs,
          "weights_gb": weights_gb,
          "slots": VLM_SLOTS, "max_len": VLM_MAX_LEN, "requests": len(reqs),
          "prompt_lengths": [len(r.prompt) for r in reqs],
          "prefills": s.prefills, "ticks": s.ticks, "completed": s.completed,
          "tokens": tokens, "flash_attention_launches": launches,
          "flash_attention_launches_by_path": by_path,
          "setup_s": setup_s, "run_s": run_s, "tok_per_s": tokens / run_s,
          "decode_tick_ms_median": statistics.median(decode_s) * 1e3,
          "decode_tick_ms_p90": float(np.percentile(decode_s, 90)) * 1e3,
          "admit_tick_ms_median": statistics.median(admit_s) * 1e3,
          "prefill_ms_by_length": prefill_ms,
          "teacher_forced_exact": exact,
          "teacher_forced_checked": int(gaps.numel()),
          "teacher_forced_max_gap": float(gaps.max()),
          "patches": VLM_PATCHES, "patch_prompt": VLM_PROMPT,
          "patch_steps": VLM_STEPS, "patch_launches_per_call": plaunches,
          "patch_exact": pexact, "patch_checked": int(pgaps.numel()),
          "patch_max_gap": float(pgaps.max()), "gap_tol": SERVE_GAP_TOL,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    prof = _profile_decode(engine, cfg, "vlm_profile", VLM_SLOTS,
                           k2_per_tick=n)
    _graph_check("vlm_serve", engine, (reqs, log, decode_s, admit_s), counts,
                 prof, _eager_run(engine, reqs))
    return launches, by_path


def _idle_slot_on_card(dev):
    """The idle-slot repair on the card: llama3.2-1b cut to 2 layers behind
    ServeEngine(slots=2, max_len=16), four runs of one 10-token request,
    so the idle slot's ``len`` passes the cache; its dropped writes must
    raise no device-side assert (the synchronize would report one)."""
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    engine = ServeEngine(cfg, params, slots=2, max_len=16, device=dev)
    rng = np.random.default_rng(SEED + 6)
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab, size=10),
                    eos_id=-1) for i in range(4)]
    for r in reqs:
        engine.submit(r)
        engine.run()
    torch.cuda.synchronize()
    lens = engine.cache["len"].tolist()
    require(all(r.done for r in reqs) and lens[1] > engine.max_len,
            f"idle slot: requests done {[r.done for r in reqs]}, len {lens}")
    return {"slots": 2, "max_len": engine.max_len, "runs": len(reqs),
            "ticks": engine.stats.ticks, "len": lens}


def phase_encdec_serve(dev):
    """Main path: the full 12 + 12-layer bf16 seamless-m4t-medium serving
    ENCDEC_BATCH utterances in the reference's form: one batched prefill
    (encoder, decoder prompt, cross-attention caches), then ENCDEC_STEPS
    greedy decode steps through the zoo.  K2 launches exactly
    n_enc_layers + 2 n_layers per prefill (all on prefill_tc) and
    2 n_layers per step (all on decode); every served token held to
    lm_serve's gate by a teacher-forced forward.  Then the idle-slot
    repair on the card (:func:`_idle_slot_on_card`)."""
    _fresh_device()
    cfg = get_config("seamless-m4t-medium")
    cfg = dataclasses.replace(cfg, param_dtype=cfg.dtype)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size()
                     for t in optim.leaves(params)) / 1e9
    batch = _on(_frontend_batch(cfg, np.random.default_rng(SEED),
                                ENCDEC_BATCH, ENCDEC_PROMPT), dev)
    max_len = ENCDEC_PROMPT + ENCDEC_STEPS

    _zero_counts()                            # the main path starts here
    times = []
    _, toks, cache, per_call = _batch_run(cfg, params, batch, max_len,
                                          ENCDEC_STEPS, times)
    launches = flash_attention.launches       # ... and ends here
    by_path = dict(flash_attention.launches_by_path)
    per_prefill, per_step = _k2_per_call(cfg)
    require(per_call == [per_prefill] + [per_step] * ENCDEC_STEPS,
            f"encdec_serve: flash_attention launches per call {per_call}, "
            f"expected {per_prefill} per prefill, {per_step} per step")
    require(by_path == {"prefill_tc": per_prefill,
                        "decode": per_step * ENCDEC_STEPS, "general": 0},
            f"encdec_serve: flash_attention launches by kernel {by_path}, "
            "expected the prefill's on prefill_tc, every step's on decode")
    require(spmm.launches == 0, "encdec_serve launched spmm_csr")
    require(cache["len"].tolist() == [max_len] * ENCDEC_BATCH,
            f"encdec_serve: cache len {cache['len'].tolist()}")
    gaps, exact = _served_gaps(cfg, params, batch, toks, ENCDEC_PROMPT - 1)
    require(float(gaps.max()) <= SERVE_GAP_TOL, f"encdec_serve: a served "
            f"token is {float(gaps.max())} below the teacher-forced top "
            "logit")

    encode_ms = time_ms(lambda: lm.encdec.encode(cfg, params,
                                                 batch["frames"]),
                        reps=5, warmup=1)
    prefill_ms = time_ms(lambda: lm.prefill(cfg, params, batch, max_len),
                         reps=5, warmup=1)
    last = toks[:, -1:]
    step = lambda: lm.decode_step(cfg, params, last, cache)  # noqa: E731
    step_device_ms = device_ms(step, reps=10, label="encdec decode step")
    idle = _idle_slot_on_card(dev)
    tokens = int(toks.numel())
    run_s = sum(times)
    emit({"phase": "encdec_serve", "arch": cfg.name,
          "n_enc_layers": cfg.n_enc_layers, "n_layers": cfg.n_layers,
          "dtype": "bfloat16", "weights_gb": weights_gb,
          "utterances": ENCDEC_BATCH, "frames": cfg.frontend_len,
          "prompt": ENCDEC_PROMPT, "decode_steps": ENCDEC_STEPS,
          "tokens": tokens, "flash_attention_launches": launches,
          "flash_attention_launches_by_path": by_path,
          "launches_per_prefill": per_prefill, "launches_per_step": per_step,
          "setup_s": setup_s, "run_s": run_s, "tok_per_s": tokens / run_s,
          "prefill_ms_in_run": times[0] * 1e3,
          "prefill_ms": prefill_ms, "encoder_ms": encode_ms,
          "decoder_prefill_ms": prefill_ms - encode_ms,
          "decode_step_ms_median": statistics.median(times[1:]) * 1e3,
          "decode_step_ms_p90": float(np.percentile(times[1:], 90)) * 1e3,
          "decode_step_device_ms": step_device_ms,
          "teacher_forced_exact": exact,
          "teacher_forced_checked": int(gaps.numel()),
          "teacher_forced_max_gap": float(gaps.max()),
          "gap_tol": SERVE_GAP_TOL, "idle_slot_on_card": idle,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, by_path


def phase_zoo_fp32(dev):
    """Both models at full depth in fp32: two prompts with the stub
    frontend's input prefilled in one batch (internvl2: VLM_PATCHES
    patches and 64 tokens; seamless: frontend_len frames and 16 tokens)
    and 16 greedy decode steps; each step's logits against the
    teacher-forced forward at its position within REC_FP32_TOL (the
    reference's gate for this identity, tests/test_models_zoo.py:88), the
    tokens equal to its greedy ones."""
    for arch, prompt in (("internvl2-2b", 64), ("seamless-m4t-medium", 16)):
        _fresh_device()
        cfg = dataclasses.replace(get_config(arch), dtype=torch.float32,
                                  param_dtype=torch.float32)
        params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED),
                                dev)
        weights_gb = sum(t.numel() * t.element_size()
                         for t in optim.leaves(params)) / 1e9
        batch = _on(_frontend_batch(cfg, np.random.default_rng(SEED + 4), 2,
                                    prompt), dev)
        extra = VLM_PATCHES if cfg.family == "vlm" else 0
        steps = 16
        logits, toks, _, _ = _batch_run(cfg, params, batch,
                                        extra + prompt + steps, steps)
        fb = {**batch, "tokens": torch.cat([batch["tokens"], toks[:, :-1]],
                                           1)}
        start = extra + prompt - 1
        rows = lm.forward(cfg, params, fb)[0][:, start:start + steps + 1]
        served = torch.stack(logits, 1)
        require(served.shape == rows.shape, f"zoo_fp32 {arch}: "
                f"{tuple(served.shape)} served logits, expected "
                f"{tuple(rows.shape)}")
        excess = allclose_err(served, rows, REC_FP32_TOL)
        equal = torch.equal(toks, rows.argmax(-1))
        emit({"phase": "zoo_fp32", "arch": cfg.name,
              "n_layers": cfg.n_layers, "n_enc_layers": cfg.n_enc_layers,
              "dtype": "float32", "weights_gb": weights_gb,
              "batch": {k: list(v.shape) for k, v in batch.items()},
              "decode_steps": steps, "tokens_checked": int(toks.numel()),
              "logits_max_abs_diff": float((served - rows).abs().max()),
              "allclose_excess": excess, "tol": REC_FP32_TOL,
              "tokens_equal": equal,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        require(equal, f"zoo_fp32 {arch}: served tokens differ from the "
                "teacher-forced greedy ones")
        require(excess <= REC_FP32_TOL, f"zoo_fp32 {arch}: served logits "
                f"beyond rtol = atol = {REC_FP32_TOL} of the teacher-forced "
                f"forward (excess {excess})")
        del params


def _counts():
    return (dict(flash_attention.launches_by_path),
            dict(flash_attention.backward_launches),
            dict(flash_attention.backward_launches_by_path),
            dict(moe.grouped_gemm.launches_by_route),
            dict(moe.grouped_gemm.backward_launches_by_route))


def _counts_delta(before):
    """Launches since ``before`` (:func:`_counts`): K2 forwards by kernel,
    K2 backwards by kernel and by path, grouped GEMMs forward and backward
    by route; keys with no launch are left out."""
    return tuple({k: n - b[k] for k, n in now.items() if n - b[k]}
                 for now, b in zip(_counts(), before))


def _lm_train_parity(dev):
    """llama3.2-1b at full width cut to 2 layers, fp32, B = 2 x L = 128
    from the data pipeline: loss_fn and every gradient leaf on the card
    (K2 both ways, its forward on the general kernel) against the CPU
    (the reference's plain attention, autograd)."""
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2,
                              dtype=torch.float32)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    batch = batch_at_step(cfg, ShapeCfg("lm_train_parity", 128, 2, "train"),
                          0)
    grads_of = make_train_step(cfg).grads_of
    before = _counts()
    by_path = dict(flash_attention.backward_launches_by_path)
    loss, grads = grads_of(params, {k: torch.from_numpy(x).to(dev)
                                    for k, x in batch.items()})
    torch.cuda.synchronize()
    launched = _counts_delta(before)[:2]
    require(launched == ({"general": cfg.n_layers},
                         {"dq": cfg.n_layers, "dkdv": cfg.n_layers})
            and flash_attention.backward_launches_by_path == {
                **by_path, "general": by_path["general"] + cfg.n_layers},
            f"lm_train parity: K2 launches {launched}, expected "
            f"{cfg.n_layers} general forwards and {cfg.n_layers} of each "
            "backward kernel, every backward on the general pair")
    t0 = time.perf_counter()
    ref_loss, ref = grads_of(_to_cpu(params), {k: torch.from_numpy(x)
                                               for k, x in batch.items()})
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    require(loss_rel <= 1e-4, f"lm_train parity: loss {float(loss)} vs the "
            f"CPU's {float(ref_loss)}")
    excess, errs = -np.inf, {}
    for (key, r), g in zip(optim.named_leaves(ref), optim.leaves(grads)):
        err = float((g.cpu() - r).abs().max())
        errs[key] = err
        excess = max(excess, err - 1e-3 * float(r.abs().max()) - 1e-5)
    require(excess <= 0, f"lm_train parity: a gradient leaf beyond "
            f"1e-3 * max|ref| + 1e-5 (excess {excess}): {errs}")
    emit({"phase": "lm_train_parity", "arch": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model, "dtype": "float32",
          "batch": [2, 128], "loss": float(loss), "cpu_loss": float(ref_loss),
          "loss_rel_err": loss_rel, "grad_max_abs_err": errs,
          "grad_excess": excess, "k2_launches": launched,
          "cpu_grad_s": cpu_s})


_DIGEST_W: dict = {}


def _leaf_digest(t: torch.Tensor) -> torch.Tensor:
    """A digest of a tensor's bits, on its device: the sum, mod 2^64, of
    each element's bits (an integer of its width) times an odd weight of
    its position mod 2^24 (a product mod 2^32, or 2^64 for 8-byte
    elements), in chunks of 2^24 elements.  Equal tensors give equal
    digests; an element that differs moves the product (an odd weight is
    a bijection mod 2^32)."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    bits = t.detach().reshape(-1).view(ints[t.element_size()])
    w = _DIGEST_W.get(t.device)
    if w is None:
        odd = torch.randint(0, 1 << 30, (1 << 24,),
                            generator=torch.Generator().manual_seed(SEED))
        w = _DIGEST_W[t.device] = (2 * odd + 1).to(torch.int32).to(t.device)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for chunk in bits.split(1 << 24):
        total += torch.sum(chunk * w[:chunk.numel()], dtype=torch.int64)
    return total


def _state_digest(params, opt_state, ef) -> torch.Tensor:
    """:func:`_leaf_digest` of every parameter, moment, step and
    error-feedback leaf, stacked."""
    leaves = (optim.leaves(params) + optim.leaves(opt_state.m)
              + optim.leaves(opt_state.v) + [opt_state.step]
              + (optim.leaves(ef) if ef is not None else []))
    return torch.stack([_leaf_digest(t) for t in leaves])


def _init_train_state(cfg, opt_cfg, dev, compress: bool):
    """The seeded weights (SEED), zero moments and, when compressing, zero
    error feedback."""
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    return (params, init_opt_state(opt_cfg, params),
            init_error_feedback(params) if compress else None)


def _run_steps(step, state, batch, n: int, label: str,
               check_reads: bool = False):
    """``n`` steps from ``state``: each step's host ms to a finished card,
    its loss and grad norm (copies) and the state's digest after it.  With
    ``check_reads`` the first step runs under the sync debug mode "error"
    (:func:`_no_host_reads`)."""
    rec = {"ms": [], "loss": [], "grad_norm": [], "digest": []}
    for i in range(n):
        out = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        if check_reads and i == 0:
            require(_no_host_reads(lambda: out.append(step(*state, batch))),
                    f"{label}: the eager step reads the card from the host")
        else:
            out.append(step(*state, batch))
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t) * 1e3)
        params, opt_state, ef, m = out[0]
        rec["loss"].append(m["loss"].clone())
        rec["grad_norm"].append(m["grad_norm"].clone())
        rec["digest"].append(_state_digest(params, opt_state, ef))
        state = (params, opt_state, ef)
    return state, rec


def _graph_twin(label: str, cfg, opt_cfg, batch, n: int, dev, **kw):
    """``n`` steps of ``make_train_step(..., graphs=False, **kw)`` (the
    eager twin, its first step free of host reads) from the seeded state;
    then, that state freed and drawn again, ``n`` steps of the step as
    users get it (captured at its first call, replayed after).  Every
    step's loss, grad norm and state digest (every parameter, moment,
    step and error-feedback leaf) must be bit-equal, and one graph built.
    Returns the graph step, its state and the figures: host ms a step each
    way, capture s, pool GB, peak GB each way, the losses."""
    compress = kw.get("compress_grads", False)
    _fresh_device()
    eager = make_train_step(cfg, opt_cfg, graphs=False, **kw)
    state, want = _run_steps(
        eager, _init_train_state(cfg, opt_cfg, dev, compress), batch, n,
        label, check_reads=True)
    eager_peak = torch.cuda.max_memory_allocated() / 1e9
    del state
    _fresh_device()
    step = make_train_step(cfg, opt_cfg, **kw)
    state, got = _run_steps(step, _init_train_state(cfg, opt_cfg, dev,
                                                    compress), batch, n,
                            label)
    require(step.graphs is (dev.type == "cuda"), f"{label}: the step on "
            f"{dev} resolved graphs to {step.graphs}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    differ = [i for i in range(n) if not all(
        torch.equal(got[k][i], want[k][i])
        for k in ("loss", "grad_norm", "digest"))]
    require(not differ, f"{label}: graph steps {differ} of {n} differ from "
            "the eager twin's (loss, grad norm or a state leaf's bits)")
    cap = _captured(step.steps.values())
    require(len(step.steps) == cap["graphs"] == int(step.graphs),
            f"{label}: {len(step.steps)} steps built, {cap['graphs']} "
            "captured")
    return step, state, {
        "graph_steps_bit_equal_to_eager": n,
        "step_ms_graph": got["ms"], "step_ms_eager": want["ms"],
        "step_ms_median_graph": statistics.median(got["ms"][1:]),
        "step_ms_median_eager": statistics.median(want["ms"][1:]),
        "capture_s": cap["capture_s"], "pool_gb": cap["pool_mb"] / 1e3,
        "peak_gb_graph": peak, "peak_gb_eager": eager_peak,
        "losses": [float(x) for x in got["loss"]],
        "grad_norms": [float(x) for x in got["grad_norm"]]}


def _lm_train_full(dev):
    """The full 16-layer llama3.2-1b at its published width: bf16 compute,
    fp32 parameters, AdamW from optim.for_model at lr 1e-3 (the CLI's
    default), 4 x 1024 tokens from the data pipeline through
    make_train_step: the reports run eagerly, the steps from a CUDA graph
    against their eager twin (:func:`_graph_twin`), also 3 compressed
    steps of 2 microbatches."""
    cfg = get_config("llama3.2-1b")
    L, n = cfg.n_layers, 4 * 1024
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    opt_cfg = dataclasses.replace(optim.for_model(cfg), lr=1e-3)
    batch = {k: torch.from_numpy(x).to(dev) for k, x in batch_at_step(
        cfg, ShapeCfg("lm_train", 1024, 4, "train"), 0).items()}
    per_mb = lambda m: ({"prefill_tc": m * L},  # noqa: E731
                        {"dq": m * L, "dkdv": m * L})
    with torch.no_grad():
        before = _counts()
        fwd_loss = float(lm.loss_fn(cfg, params, batch))
        require(_counts_delta(before)[:2] == ({"prefill_tc": L}, {}),
                "lm_train: the no-grad loss did not take prefill_tc once a "
                "layer")

    # Two runs of the same step from the same state (a report).
    grads_of = make_train_step(cfg, opt_cfg).grads_of
    before = _counts()
    loss_a, grads_a = grads_of(params, batch)
    torch.cuda.synchronize()
    require(_counts_delta(before)[:2] == per_mb(1), f"lm_train: K2 launches "
            f"{_counts_delta(before)[:2]} for one microbatch")
    loss_b, grads_b = grads_of(params, batch)
    differ = [name for (name, a), b in zip(optim.named_leaves(grads_a),
                                           optim.leaves(grads_b))
              if not torch.equal(a, b)]
    repeat = {"loss_bit_equal": bool(torch.equal(loss_a, loss_b)),
              "grad_leaves_differing": differ,
              "grads_bit_equal": not differ}
    del grads_a, grads_b

    # microbatches = 2 against 1 on the same batch, lr 0 (the reference's
    # test): the loss, and the first moments.
    zero = OptConfig(lr=0.0, weight_decay=0.0)
    moments, mb_loss = {}, {}
    for mb in (1, 2):
        state = init_opt_state(zero, params)
        before = _counts()
        _, state, _, m = make_train_step(cfg, zero, microbatches=mb,
                                         graphs=False)(
            params, state, None, batch)
        torch.cuda.synchronize()
        require(_counts_delta(before)[:2] == per_mb(mb), f"lm_train: K2 "
                f"launches {_counts_delta(before)[:2]} for {mb} "
                "microbatches")
        moments[mb], mb_loss[mb] = state.m, float(m["loss"])
        del state
    mb_rel = abs(mb_loss[2] - mb_loss[1]) / abs(mb_loss[1])
    require(mb_rel <= 1e-3, f"lm_train: 2 microbatches' loss {mb_loss[2]} "
            f"vs 1's {mb_loss[1]}")
    m_excess = {rtol: max(float(((a - b).abs() - MB_M_ATOL - rtol * b.abs())
                                 .max()) for a, b in zip(
        optim.leaves(moments[2]), optim.leaves(moments[1])))
        for rtol in (MB_M_RTOL, MB_M_REF_RTOL)}
    require(m_excess[MB_M_RTOL] <= 0, f"lm_train: 2 microbatches' first "
            f"moments vs 1's beyond rtol {MB_M_RTOL}, atol {MB_M_ATOL} "
            f"(excess {m_excess[MB_M_RTOL]})")
    del moments

    # Ten steps on the fixed batch from the seeded state, eagerly and from
    # a graph: bit-equal; step 0's loss is the forward's, the loss falls.
    n_params = sum(t.numel() for t in optim.leaves(params))
    del params
    step, state, twin = _graph_twin("lm_train", cfg, opt_cfg, batch,
                                    TRAIN_LM_STEPS, dev)
    losses = twin["losses"]
    require(np.isfinite(losses).all() and losses[-1] < losses[0],
            f"lm_train: {TRAIN_LM_STEPS} steps did not lower the loss: "
            f"{losses}")
    step0_rel = abs(losses[0] - fwd_loss) / abs(fwd_loss)
    require(step0_rel <= 1e-3, f"lm_train: step 0's loss {losses[0]} vs the "
            f"no-grad forward's {fwd_loss}")
    state, prof = _profile_train(step, state, batch)

    # The trained parameters and optimizer state through a checkpoint.
    params, opt_state, _ = state
    tree = {"p": params, "o": opt_state}
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, keep=1, async_write=False)
        t0 = time.perf_counter()
        ck.save(int(opt_state.step), tree)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, manifest = ck.restore(int(opt_state.step), tree)
        restore_s = time.perf_counter() - t0
    equal = all(torch.equal(a, b) and a.device == b.device for a, b in zip(
        optim.leaves(back["p"]) + optim.leaves(back["o"].m)
        + optim.leaves(back["o"].v) + [back["o"].step],
        optim.leaves(params) + optim.leaves(opt_state.m)
        + optim.leaves(opt_state.v) + [opt_state.step]))
    require(equal, "lm_train: the checkpoint round trip is not bit-equal")
    del back, tree, params, opt_state, state, step

    # Three int8 error-feedback steps of 2 microbatches, eagerly and from a
    # graph: bit-equal (the error feedback too) and finite.
    _, state, comp = _graph_twin("lm_train compressed", cfg, opt_cfg, batch,
                                 3, dev, microbatches=2,
                                 compress_grads=True)
    finite = (bool(np.isfinite(comp["losses"]).all())
              and all(bool(torch.isfinite(t).all())
                      for t in optim.leaves(state[0])
                      + optim.leaves(state[2])))
    require(finite, "lm_train: the compressed steps are not finite")
    del state

    med = twin["step_ms_median_graph"]
    emit({"phase": "lm_train", "arch": cfg.name, "n_layers": L,
          "d_model": cfg.d_model, "vocab": cfg.vocab, "params": n_params,
          "dtype": "bfloat16", "param_dtype": "float32",
          "optimizer": opt_cfg.name, "lr": opt_cfg.lr, "batch": [4, 1024],
          "no_grad_loss": fwd_loss, "step0_loss": losses[0],
          "step0_rel_err": step0_rel, "microbatch_loss": mb_loss,
          "microbatch_loss_rel": mb_rel,
          "microbatch_m_excess": m_excess[MB_M_RTOL],
          "microbatch_m_rtol_atol": [MB_M_RTOL, MB_M_ATOL],
          "microbatch_m_excess_reference_rtol": m_excess[MB_M_REF_RTOL],
          "k2_launches_per_microbatch": per_mb(1), **twin,
          "tokens_per_s": n / (med / 1e3),
          "tokens_per_s_eager": n / (twin["step_ms_median_eager"] / 1e3),
          **prof, "compressed_steps": {
              key: comp[key] for key in (
                  "graph_steps_bit_equal_to_eager", "step_ms_median_graph",
                  "step_ms_median_eager", "capture_s", "pool_gb",
                  "peak_gb_graph", "losses")},
          "compressed_microbatches": 2, "compressed_steps_finite": True,
          "checkpoint_bit_equal": True, "checkpoint_save_s": save_s,
          "checkpoint_restore_s": restore_s,
          "checkpoint_leaves": len(manifest["leaves"]),
          "same_step_twice": repeat})


def phase_lm_train(dev):
    """LM training on the card: the 2-layer parity check, then the main
    path, whose counts start from 0 just before it.  The main path takes
    gradients of 40 microbatches (two repeat runs, 1 + 2 microbatches, the
    steps eagerly and from a graph, three profiled replays, three
    compressed steps of 2 microbatches each way) and one no-grad forward,
    all forwards on prefill_tc and all backwards on the tensor-core pair;
    a replay counts its launches as the eager step would."""
    gc.collect()
    torch.cuda.empty_cache()
    _lm_train_parity(dev)
    _zero_counts()                            # the main path starts here
    _lm_train_full(dev)
    fwd = dict(flash_attention.launches_by_path)      # ... and ends here
    bwd = dict(flash_attention.backward_launches)
    by_path = dict(flash_attention.backward_launches_by_path)
    n_layers = get_config("llama3.2-1b").n_layers
    grad_mbs = 2 + 3 + 2 * TRAIN_LM_STEPS + 3 + 2 * 3 * 2
    require(fwd == {**dict.fromkeys(fwd, 0),
                    "prefill_tc": (grad_mbs + 1) * n_layers}
            and bwd == {"dq": grad_mbs * n_layers,
                        "dkdv": grad_mbs * n_layers}
            and by_path == {"tc": grad_mbs * n_layers, "general": 0},
            f"the LM train path launched K2 {fwd} forward and {bwd} "
            f"backward ({by_path} by path), expected "
            f"{(grad_mbs + 1) * n_layers} prefill_tc and "
            f"{grad_mbs * n_layers} of each backward kernel, all on tc")
    require(spmm.launches == 0, "lm_train launched spmm_csr")
    return flash_attention.launches, fwd, bwd, by_path


# ------------------------------------------------ training of the families
def _train_k2_sites(cfg) -> tuple:
    """K2's sites in one training forward, and how many of them a remat
    backward runs again: every attention of the transformer families and
    of enc-dec (the encoder's, the decoder's self- and cross-attention;
    each layer checkpointed under ``cfg.remat``), zamba2's shared-block
    sites (outside its checkpointed Mamba layers), none for xLSTM."""
    if cfg.family == "hybrid":
        return ssm.num_shared_calls(cfg), 0
    if cfg.family == "ssm":
        return 0, 0
    sites = (cfg.n_enc_layers + 2 * cfg.n_layers if cfg.family == "encdec"
             else cfg.n_layers)
    return sites, sites if cfg.remat else 0


def _train_gg_calls(cfg) -> tuple:
    """Grouped GEMM calls of one microbatch: (forward, backward).  Two
    products a MoE layer, run again by a remat backward."""
    if cfg.family != "moe":
        return 0, 0
    prods = 2 * (cfg.n_layers - cfg.first_dense_layers)
    return prods * (2 if cfg.remat else 1), prods


def _expected(cfg, grad_mbs: int, no_grad: int, fwd_path: str,
              bwd_path: str):
    """The launches ``_counts_delta`` must show after ``grad_mbs``
    microbatches under grad and ``no_grad`` forwards without it, K2's on
    ``fwd_path`` and ``bwd_path``, every grouped GEMM on grouped_mm (the
    card's route at every dtype the phases run)."""
    sites, again = _train_k2_sites(cfg)
    gg_fwd, gg_bwd = _train_gg_calls(cfg)
    fwd = no_grad * sites + grad_mbs * (sites + again)
    bwd = grad_mbs * sites
    gg_f = no_grad * gg_fwd // (2 if cfg.remat else 1) + grad_mbs * gg_fwd
    return tuple({k: n for k, n in d.items() if n} for d in (
        {fwd_path: fwd}, {"dq": bwd, "dkdv": bwd}, {bwd_path: bwd},
        {"grouped_mm": gg_f}, {"grouped_mm": grad_mbs * gg_bwd}))


def _family_cfg(arch: str, cut: dict, dtype=None):
    cfg = dataclasses.replace(get_config(arch), **cut)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def _train_parity(phase: str, arch: str, cut: dict, L: int, dev):
    """``arch`` at full width cut to ``cut`` (TRAIN_PARITY), fp32, B = 2 x L
    from the data pipeline: ``grads_of`` (remat as the main run) on the
    card (K2 both ways on the CUDA-core pair; the MoE grouped GEMMs both
    ways on grouped_mm) against the CPU's (the plain attention, the loop
    route): the loss within 1e-4 relative, every gradient leaf within
    1e-3 * max|ref| + 1e-5 (lm_train_parity's gates), K2 and grouped GEMM
    launches exactly, and for MoE the router's expert sets equal on both
    devices at every call."""
    _fresh_device()
    cfg = _family_cfg(arch, cut, torch.float32)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    batch = batch_at_step(cfg, ShapeCfg(phase, L, 2, "train"), 0)
    grads_of = make_train_step(cfg).grads_of
    before = _counts()
    with _RouteLog() as g_log:
        loss, grads = grads_of(params, _on(batch, dev))
    torch.cuda.synchronize()
    launched = _counts_delta(before)
    want = _expected(cfg, 1, 0, "general", "general")
    require(launched == want, f"{phase} parity: launches {launched}, "
            f"expected {want}")
    t0 = time.perf_counter()
    with _RouteLog() as c_log:
        ref_loss, ref = grads_of(_to_cpu(params), _on(batch,
                                                      torch.device("cpu")))
    cpu_s = time.perf_counter() - t0
    require(len(g_log.calls) == len(c_log.calls)
            and all(torch.equal(_expert_sets(gi).cpu(), _expert_sets(ci))
                    for (gi, _), (ci, _) in zip(g_log.calls, c_log.calls)),
            f"{phase} parity: the router chose other experts on the card "
            "than on the CPU")
    loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    require(loss_rel <= 1e-4, f"{phase} parity: loss {float(loss)} vs the "
            f"CPU's {float(ref_loss)}")
    excess, errs = -np.inf, {}
    for (key, r), g in zip(optim.named_leaves(ref), optim.leaves(grads)):
        err = float((g.cpu() - r).abs().max())
        errs[key] = err
        excess = max(excess, err - 1e-3 * float(r.abs().max()) - 1e-5)
    require(excess <= 0, f"{phase} parity: a gradient leaf beyond "
            f"1e-3 * max|ref| + 1e-5 (excess {excess}): {errs}")
    emit({"phase": f"{phase}_parity", "arch": cfg.name, "cut": cut,
          "d_model": cfg.d_model, "dtype": "float32", "remat": cfg.remat,
          "batch": [2, L], "loss": float(loss), "cpu_loss": float(ref_loss),
          "loss_rel_err": loss_rel, "grad_max_abs_err": errs,
          "grad_excess": excess, "launches": launched,
          "router_calls": len(g_log.calls),
          "expert_sets_equal": cfg.family == "moe" or "no router",
          "cpu_grad_s": cpu_s})


def _train_class(name: str) -> str:
    """The class of a device kernel in a training step, by its name: K2
    forward or backward, the grouped GEMM, cuBLAS and CUTLASS GEMMs,
    elementwise work and the rest."""
    low = name.lower()
    if "flash_bwd" in low:
        return "k2_backward"
    if "flash_" in low:
        return "k2_forward"
    return {"grouped_gemm": "grouped_gemm", "gemm": "cublas"}.get(
        _kernel_kind(name), "elementwise")


def _profile_train(step, state, batch, steps: int = 2):
    """Two train steps, replays of a captured step, under torch.profiler
    after a traced warm-up step (a window's first call loses events): each
    step's wall time, the device's busy share and the device time per step
    by class (:func:`_train_class`: K2 forward and backward, the grouped
    GEMM both ways, cuBLAS, elementwise).  A replay runs no CPU op, so the
    trace costs little even for xlstm's ~150k kernels a step, and it
    cannot tell a grouped GEMM's backward from its forward (an eager
    step's profile can, by the autograd node that launched a kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    traced, wall = [], []
    with torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=steps),
            on_trace_ready=lambda p: traced.append(p.events())) as prof:
        for i in range(steps + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state = step(*state, batch)[:3]
            torch.cuda.synchronize()
            if i:
                wall.append((time.perf_counter() - t) * 1e3)
            prof.step()
    events = traced[0] if traced else []
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation       # the steps' GPU spans
              and not e.name.startswith("ProfilerStep")]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
    by_class, launches = {}, {}
    for e in device:
        kind = _train_class(e.name)
        ms = e.time_range.elapsed_us() / 1e3
        by_class[kind] = by_class.get(kind, 0.0) + ms
        launches[kind] = launches.get(kind, 0) + 1
    wall_ms = sum(wall)
    per = lambda d: {k: v / steps for k, v in d.items()}  # noqa: E731
    return state, {
        "profiled_steps": steps, "profiled_step_ms": wall,
        "device_busy_ms_per_step": busy / steps if device
        else "not measured",
        "device_busy_share": busy / wall_ms if device else "not measured",
        "device_ms_per_step_by_class": per(by_class) if device
        else "not measured",
        "launches_per_step_by_class": per(launches),
        "kernel_launches_per_step": len(device) / steps}


def _train_main(phase: str, arch: str, cut: dict, seq: int, steps: int,
                lr: float, dev):
    """``arch`` at full width (depth cut by ``cut``): bf16 compute, fp32
    parameters, AdamW from optim.for_model at ``lr``, 4 x ``seq`` tokens
    from the data pipeline through make_train_step: ``grads_of`` twice
    from the same state bit-equal; ``steps`` steps eagerly and from a CUDA
    graph, bit-equal (:func:`_graph_twin`), each finite with the last
    below the first and step 0's loss within 1e-3 of a no-grad forward's;
    then two profiled replays; K2 and grouped GEMM launches exactly at
    each part.  Returns the microbatches under grad and the no-grad
    forwards it ran."""
    _fresh_device()
    cfg = _family_cfg(arch, cut)
    n = 4 * seq
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    n_params = sum(t.numel() for t in optim.leaves(params))
    opt_cfg = dataclasses.replace(optim.for_model(cfg), lr=lr)
    batch = _on(batch_at_step(cfg, ShapeCfg(phase, seq, 4, "train"), 0), dev)
    on_card = ("prefill_tc", "tc")
    with torch.no_grad():
        before = _counts()
        fwd_loss = float(lm.loss_fn(cfg, params, batch))
        require(_counts_delta(before) == _expected(cfg, 0, 1, *on_card),
                f"{phase}: the no-grad loss launched {_counts_delta(before)}")

    grads_of = make_train_step(cfg, opt_cfg, graphs=False).grads_of
    before = _counts()
    loss_a, grads_a = grads_of(params, batch)
    torch.cuda.synchronize()
    require(_counts_delta(before) == _expected(cfg, 1, 0, *on_card),
            f"{phase}: one microbatch launched {_counts_delta(before)}, "
            f"expected {_expected(cfg, 1, 0, *on_card)}")
    loss_b, grads_b = grads_of(params, batch)
    differ = [name for (name, a), b in zip(optim.named_leaves(grads_a),
                                           optim.leaves(grads_b))
              if not torch.equal(a, b)]
    require(torch.equal(loss_a, loss_b) and not differ,
            f"{phase}: grads_of twice from the same state differ (loss "
            f"{float(loss_a)} / {float(loss_b)}; leaves {differ})")
    finite = all(bool(torch.isfinite(g).all()) for g in optim.leaves(grads_a))
    require(finite, f"{phase}: a gradient is not finite")
    del grads_a, grads_b, params

    before = _counts()
    step, state, twin = _graph_twin(phase, cfg, opt_cfg, batch, steps, dev)
    want = _expected(cfg, 2 * steps, 0, *on_card)
    require(_counts_delta(before) == want, f"{phase}: {steps} steps each "
            f"way launched {_counts_delta(before)}, expected {want}")
    losses = twin["losses"]
    require(np.isfinite(losses).all() and losses[-1] < losses[0],
            f"{phase}: {steps} steps did not lower the loss: {losses}")
    step0_rel = abs(losses[0] - fwd_loss) / abs(fwd_loss)
    require(step0_rel <= 1e-3, f"{phase}: step 0's loss {losses[0]} vs the "
            f"no-grad forward's {fwd_loss}")
    state, prof = _profile_train(step, state, batch)
    del state, step
    med = twin["step_ms_median_graph"]
    sites, again = _train_k2_sites(cfg)
    emit({"phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
          "cut": cut, "d_model": cfg.d_model, "vocab": cfg.vocab,
          "params": n_params, "dtype": "bfloat16", "param_dtype": "float32",
          "remat": cfg.remat, "optimizer": opt_cfg.name, "lr": opt_cfg.lr,
          "batch": [4, seq], "no_grad_loss": fwd_loss,
          "step0_loss": losses[0], "step0_rel_err": step0_rel,
          "grads_bit_equal_twice": True,
          "k2_sites_per_microbatch": sites, "k2_sites_recomputed": again,
          "grouped_gemm_calls_per_microbatch": _train_gg_calls(cfg),
          **twin, "tokens_per_s": n / (med / 1e3),
          "tokens_per_s_eager": n / (twin["step_ms_median_eager"] / 1e3),
          "card_mem_gb": torch.cuda.mem_get_info(dev)[1] / 1e9, **prof})
    return 2 + 2 * steps + 1 + prof["profiled_steps"], 1


def phase_family_train(phase: str, dev):
    """One family's training: the parity part, then the main path, whose
    counts start from 0 just before it.  Returns the main path's K2
    forwards by kernel and backwards by kernel and by path."""
    arch, cut, L = TRAIN_PARITY[phase]
    _train_parity(phase, arch, cut, L, dev)
    arch, cut, seq, steps, lr = TRAIN_MAIN[phase]
    _zero_counts()                            # the main path starts here
    grad_mbs, no_grad = _train_main(phase, arch, cut, seq, steps, lr, dev)
    got = _counts()                           # ... and ends here
    cfg = _family_cfg(arch, cut)
    want = _expected(cfg, grad_mbs, no_grad, "prefill_tc", "tc")
    require(tuple({k: n for k, n in d.items() if n} for d in got) == want,
            f"{phase}: the main path launched {got}, expected {want}")
    require(spmm.launches == 0, f"{phase} launched spmm_csr")
    _fresh_device()
    return got[0], got[1], got[2]


@contextlib.contextmanager
def _one_rank_mesh(dev):
    """A torch.distributed group of one process (NCCL on the card, gloo on
    the CPU) and its 1x1 (data, model) mesh; the group is destroyed after."""
    import socket
    import torch.distributed as tdist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tdist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                             init_method=f"tcp://localhost:{port}", rank=0,
                             world_size=1)
    try:
        yield make_debug_mesh(1, 1, device_type=dev.type)
    finally:
        tdist.destroy_process_group()


def _mesh_llama(dev, mesh):
    """llama3.2-1b at full width (bf16 compute, fp32 weights), its weights
    whole and laid out on ``mesh`` by param_specs, and 4 x 1024 tokens from
    the data pipeline, whole and laid out over 'data'."""
    cfg = get_config("llama3.2-1b")
    dist = Dist(mesh, batch_axes=("data",))
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    batch = {k: torch.from_numpy(x).to(dev) for k, x in batch_at_step(
        cfg, ShapeCfg("mesh", 1024, 4, "train"), 0).items()}
    bspecs = {k: P("data", None) for k in batch}
    placed = shard_tree(params, lm.param_specs(cfg, dist), mesh)
    pbatch = {k: shard_tree(v, bspecs[k], mesh) for k, v in batch.items()}
    return cfg, dist, params, batch, placed, pbatch, bspecs


def phase_mesh_parity(dev, mesh):
    """forward and prefill of the full-width llama3.2-1b under Dist on the
    1x1 mesh, bit-equal to the mesh-free path on the same weights; K2
    launched once a layer a pass on prefill_tc, through local_map.
    Returns the meshed calls' K2 launches by kernel."""
    cfg, dist, params, batch, placed, pbatch, _ = _mesh_llama(dev, mesh)
    L, max_len = cfg.n_layers, 1024 + 64
    meshed = {}
    with torch.no_grad():
        ref = lm.forward(cfg, params, batch)[0]
        before = _counts()
        got = lm.forward(cfg, placed, pbatch, dist)[0]
        torch.cuda.synchronize()
        meshed["forward"] = _counts_delta(before)[0]
        fwd_equal = bool(torch.equal(got.to_local(), ref))
        del ref, got
        r_last, r_cache = lm.prefill(cfg, params, {"tokens": batch["tokens"]},
                                     max_len)
        before = _counts()
        g_last, g_cache = lm.prefill(cfg, placed,
                                     {"tokens": pbatch["tokens"]}, max_len,
                                     dist)
        torch.cuda.synchronize()
        meshed["prefill"] = _counts_delta(before)[0]
        pre_equal = {key: bool(torch.equal(g.to_local(), r)) for key, g, r in (
            ("logits", g_last, r_last), ("k", g_cache["k"], r_cache["k"]),
            ("v", g_cache["v"], r_cache["v"]),
            ("len", g_cache["len"], r_cache["len"]))}
        del r_cache, g_cache
        ms = {"forward": time_ms(lambda: lm.forward(cfg, params, batch),
                                 reps=3, warmup=1),
              "forward_mesh": time_ms(lambda: lm.forward(
                  cfg, placed, pbatch, dist), reps=3, warmup=1)}
    for key, got in meshed.items():
        require(got == {"prefill_tc": L}, f"mesh_parity: the meshed {key} "
                f"launched K2 {got}, expected {L} on prefill_tc")
    require(fwd_equal, "mesh_parity: the meshed forward's logits differ "
            "from the mesh-free forward's")
    require(all(pre_equal.values()), f"mesh_parity: the meshed prefill "
            f"differs from the mesh-free one: {pre_equal}")
    emit({"phase": "mesh_parity", "arch": cfg.name, "n_layers": L,
          "d_model": cfg.d_model, "dtype": "bfloat16", "mesh": [1, 1],
          "backend": "nccl" if dev.type == "cuda" else "gloo",
          "batch": [4, 1024], "prefill_max_len": max_len,
          "forward_bit_equal": fwd_equal, "prefill_bit_equal": pre_equal,
          "k2_launches": meshed, "forward_ms": ms})
    return {k: sum(d.get(k, 0) for d in meshed.values())
            for k in flash_attention.launches_by_path}


def _replay_profile(fn, label: str, dev) -> dict:
    """One call of ``fn`` (a replayed step) under torch.profiler, after a
    traced warm-up call (a window's first call loses events:
    :func:`device_ms`): the NCCL kernels it ran, by name and count, its
    kernels in all, the device's busy ms and busy share of the call's host
    time; "not measured" off the card or where the trace holds no device
    time."""
    if dev.type != "cuda":
        return {"label": label, "nccl_kernels": "not measured",
                "device_busy_share": "not measured"}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    traced = []
    with torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
            on_trace_ready=lambda p: traced.append(p.key_averages())
    ) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()                            # the warm-up call ends
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        prof.step()                            # the active call ends
    kernels = [e for e in (traced[0] if traced else [])
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    nccl = {e.key[:80]: e.count for e in kernels if "nccl" in e.key.lower()}
    return {"label": label, "host_ms": wall_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "nccl_kernels": nccl if kernels else "not measured",
            "device_busy_ms": busy if kernels else "not measured",
            "device_busy_share": busy / wall_ms if kernels
            else "not measured"}


# K2's launches that the mesh phases' graphs made by replaying, by phase:
# forward by kernel and backward by path (the kernels summary line).
REPLAYED: dict = {}


def _count_replays(phase: str, per: tuple, replays: int) -> None:
    """Adds ``replays`` replays of a step launching ``per`` (forward by
    kernel, backward by path: :func:`_k2_per_replay`) to ``REPLAYED``."""
    got = REPLAYED.setdefault(phase, ({}, {}))
    for into, each in zip(got, per):
        for key, n in each.items():
            into[key] = into.get(key, 0) + n * replays


def _k2_per_replay(step) -> tuple:
    """K2's launches (forward by kernel, backward by path) that each replay
    of ``step`` (a captured Step) adds, without the kernels it never
    launched."""
    return tuple({k: n for k, n in step.per_replay[f"flash_attention.{c}"]
                  .items() if n}
                 for c in ("launches_by_path", "backward_launches_by_path"))


def _mesh_train_run(cfg, dist, specs, params, batch, bspecs, opt_cfg,
                    graphs=False):
    """MESH_TRAIN_STEPS steps from a copy of ``params``: mesh-free and eager
    (make_train_step) when ``dist`` is None, else jit_train_step on its
    mesh with ``graphs`` (None: from a CUDA graph on the card, its first
    step eager, then captured).  Returns (losses, the final params and
    moments whole, each step's host ms, the meshed step's Step or None,
    a function that runs one more step)."""
    start = optim.tree_map(lambda t: t.clone(), params)
    if dist is None:
        step, state = make_train_step(cfg, opt_cfg, graphs=False), start
        opt = init_opt_state(opt_cfg, state)
    else:
        step = jit_train_step(cfg, dist, specs, opt_cfg, batch_specs=bspecs,
                              graphs=graphs)
        state = shard_tree(start, specs, dist.mesh)
        opt = init_opt_state(opt_cfg, state)
    del start
    _fresh_device()                  # cached blocks released before capture
    losses, ms = [], []
    for _ in range(MESH_TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, opt, _, m = step(state, opt, None, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        loss = m["loss"]
        losses.append(float(loss.to_local() if hasattr(loss, "to_local")
                            else loss))
    steps = {} if dist is None else step.step.steps
    captured = next((s for s in steps.values() if s.graph is not None), None)
    return (losses, full_tree({"p": state, "m": opt.m, "v": opt.v}), ms,
            captured, lambda: step(state, opt, None, batch))


def phase_mesh_train(dev, mesh):
    """llama3.2-1b at full width through jit_train_step on the 1x1 mesh,
    MESH_TRAIN_STEPS steps on 4 x 1024 tokens: twice from a CUDA graph (on
    the card; the first step eager, then captured and replayed) and once
    eagerly (``graphs=False``, the host-time twin), each run's losses,
    parameters and moments bit-equal to the mesh-free make_train_step's;
    K2 both ways exact per replay; step ms graph, meshed eager and
    mesh-free, capture s, pool and peak GB, and the NCCL kernels in one
    profiled replay.  Returns the graph runs' K2 launches (forward by
    kernel, backward by kernel and by path)."""
    cfg, dist, params, batch, _, _, bspecs = _mesh_llama(dev, mesh)
    specs = lm.param_specs(cfg, dist)
    opt_cfg = dataclasses.replace(optim.for_model(cfg), lr=1e-3)
    ref_losses, ref, ref_ms, _, _ = _mesh_train_run(
        cfg, None, specs, params, batch, bspecs, opt_cfg)
    L, n = cfg.n_layers, MESH_TRAIN_STEPS
    want = ({"prefill_tc": n * L}, {"dq": n * L, "dkdv": n * L},
            {"tc": n * L})
    on_card = dev.type == "cuda"
    runs, launched, graph = [], [], {}
    for graphs in (None, None, False):
        before = _counts()
        losses, got, ms, captured, more = _mesh_train_run(
            cfg, dist, specs, params, batch, bspecs, opt_cfg, graphs)
        count = _counts_delta(before)[:3]
        peak = torch.cuda.max_memory_allocated() / 1e9
        differ = [name for (name, a), b in zip(optim.named_leaves(got),
                                               optim.leaves(ref))
                  if not torch.equal(a, b)]
        run = {"graphs": graphs is None and on_card, "losses": losses,
               "losses_equal": losses == ref_losses,
               "leaves_differing": differ[:8],
               "n_leaves_differing": len(differ), "step_ms": ms,
               "peak_gb": peak, "k2_launches": count}
        require(count == want, f"mesh_train: a run launched K2 {count}, "
                f"expected {want}")
        require(run["losses_equal"] and not differ, f"mesh_train: "
                f"jit_train_step on the 1x1 mesh is not bit-equal to "
                f"make_train_step: {run}")
        require((captured is not None) == run["graphs"], f"mesh_train: a "
                f"run with graphs={graphs} captured {captured}")
        if captured is not None:
            per = _k2_per_replay(captured)
            require(per == ({"prefill_tc": L}, {"tc": L}), f"mesh_train: "
                    f"a replay launches K2 {per}, expected {L} a layer")
            _count_replays("mesh_train", per, captured.replays)
            run.update(capture_s=captured.capture_s,
                       pool_gb=captured.pool_bytes / 1e9,
                       replays=captured.replays, k2_per_replay=per)
            if not graph:
                graph = _replay_profile(more, "mesh_train replay", dev)
        if graphs is None:
            launched.append(count)
        runs.append(run)
        del got, captured, more
    require(ref_losses[-1] < ref_losses[0], f"mesh_train: {n} steps did "
            f"not lower the loss: {ref_losses}")
    med = lambda ms: statistics.median(ms[1:])  # noqa: E731
    emit({"phase": "mesh_train", "arch": cfg.name, "n_layers": L,
          "dtype": "bfloat16", "param_dtype": "float32", "mesh": [1, 1],
          "optimizer": opt_cfg.name, "lr": opt_cfg.lr, "batch": [4, 1024],
          "steps": n, "losses": ref_losses, "runs": runs,
          "bit_equal_to_mesh_free": True, "bit_equal_twice": True,
          "step_ms_median": {"graph": [med(r["step_ms"]) for r in runs[:2]],
                             "mesh_eager": med(runs[2]["step_ms"]),
                             "mesh_free_eager": med(ref_ms)},
          "mesh_free_step_ms": ref_ms, "replay_profile": graph,
          "k2_launches_per_run": launched[0]})
    fwd = {k: sum(g[0].get(k, 0) for g in launched)
           for k in flash_attention.launches_by_path}
    bwd = {k: sum(g[1].get(k, 0) for g in launched)
           for k in flash_attention.backward_launches}
    by_path = {k: sum(g[2].get(k, 0) for g in launched)
               for k in flash_attention.backward_launches_by_path}
    return fwd, bwd, by_path


def _mesh_serve_run(cfg, params, dev, dist, graphs, requests: int = 16):
    """lm_serve's 16 requests (the first ``requests`` of them) through one
    ServeEngine with ``graphs``, on ``dist``'s mesh when given, else
    mesh-free: the engine, the requests, their :class:`_LogitLog`, the
    host seconds of the ticks that only decoded, K2's launches by kernel
    and those with stats."""
    kw = {} if dist is None else {"dist": dist}
    engine = ServeEngine(cfg, params, slots=LLAMA_SLOTS,
                         max_len=LLAMA_MAX_LEN, device=dev, graphs=graphs,
                         **kw)
    rng = np.random.default_rng(SEED)
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab, size=int(n)),
                    max_new_tokens=32, eos_id=-1)
            for i, n in enumerate(rng.integers(64, 1025, size=16))]
    for r in reqs[:requests]:
        engine.submit(r)
    before, stats0 = _counts(), flash_attention.stats_launches
    with _LogitLog(engine, reqs[:requests]) as log, torch.no_grad():
        decode_s, _ = _timed_ticks(engine)
    launched = _counts_delta(before)[0]
    return (engine, reqs[:requests], log, decode_s, launched,
            flash_attention.stats_launches - stats0)


def phase_mesh_serve(dev, mesh):
    """llama3.2-1b at full width (16 layers, bf16) behind
    ServeEngine(dist=the 1x1 mesh) as users get it (on the card its decode
    step and a prefill step a bucket captured into CUDA graphs and
    replayed) with lm_serve's 16 requests of 32 tokens: the tokens and
    every tick's logits bit-equal to an eager mesh-free engine's, and the
    first MESH_EAGER_REQUESTS requests' tokens and logits to a meshed
    eager engine's (``graphs=False``); trace_counts one decode step and a
    prefill step a bucket; K2 launched once a layer a prefill on
    prefill_tc and once a layer a tick on decode, exactly per replay (no
    launch with stats: a 1-wide sequence axis merges nothing); the
    decode ticks' host ms three ways, the replayed and the mesh-free eager
    decode step's device ms, capture s, pool GB, and the NCCL kernels in
    one profiled replay.  Returns the meshed engine's K2 launches by
    kernel."""
    _fresh_device()
    cfg = get_config("llama3.2-1b")
    dist = Dist(mesh, batch_axes=("data",))
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    ref = _mesh_serve_run(cfg, params, dev, None, False)
    got = _mesh_serve_run(cfg, params, dev, dist, None)
    twin = _mesh_serve_run(cfg, params, dev, dist, False,
                           MESH_EAGER_REQUESTS)
    del params
    (r_eng, r_reqs, r_log, r_s, _, _) = ref
    (g_eng, g_reqs, g_log, g_s, launched, stats) = got
    (e_eng, e_reqs, e_log, e_s, e_launched, _) = twin
    s = g_eng.stats
    on_card = dev.type == "cuda"
    tokens_equal = [r.out_tokens for r in r_reqs] == [r.out_tokens
                                                       for r in g_reqs]
    logits_equal = len(r_log.ticks) == len(g_log.ticks) and all(
        torch.equal(a, b) for a, b in zip(r_log.ticks, g_log.ticks))
    eager_equal = all(
        r.out_tokens == g.out_tokens and len(e_log.logits[r.uid]) == len(
            g_log.logits[r.uid]) and all(torch.equal(a, b) for a, b in zip(
                e_log.logits[r.uid], g_log.logits[r.uid]))
        for r, g in zip(e_reqs, g_reqs))
    buckets = {min(ServeEngine._bucket(len(r.prompt)), LLAMA_MAX_LEN)
               for r in g_reqs}
    counts = g_eng.trace_counts
    L = cfg.n_layers
    want = {"prefill_tc": L * s.prefills, "decode": L * s.ticks}
    require(g_eng.graphs is on_card and e_eng.graphs is False, f"mesh_serve:"
            f" the meshed engines resolved graphs to {g_eng.graphs} and "
            f"{e_eng.graphs} on {dev}")
    require(all(r.done and len(r.out_tokens) == 32 for r in g_reqs),
            "mesh_serve: a request did not finish its 32 tokens")
    require(tokens_equal, "mesh_serve: the meshed engine's tokens differ "
            "from the mesh-free engine's")
    require(logits_equal, "mesh_serve: a tick's logits differ from the "
            "mesh-free engine's")
    require(eager_equal, "mesh_serve: the meshed graph engine's tokens or "
            "logits differ from the meshed eager engine's")
    require(counts == {"prefill": len(buckets), "decode": 1}, f"mesh_serve:"
            f" trace_counts {counts} for {len(buckets)} buckets")
    require(launched == want and stats == 0, f"mesh_serve: K2 launched "
            f"{launched} ({stats} with stats), expected {want}")
    steps = list(g_eng.steps.values())
    per_replay = {}
    if on_card:
        require(all(st.graph is not None for st in steps),
                "mesh_serve: a step of the meshed engine was not captured")
        for key, st in g_eng.steps.items():
            per = _k2_per_replay(st)
            per_replay[str(key)] = per[0]
            require(per == ({"decode" if key == "decode" else "prefill_tc":
                             L}, {}), f"mesh_serve: a replay of {key} "
                    f"launches K2 {per}, expected {L}")
            _count_replays("mesh_serve", per, st.replays)
    tok = torch.zeros((LLAMA_SLOTS, 1), dtype=torch.long, device=dev)
    decode = g_eng.steps["decode"]
    with torch.no_grad():
        step_ms = {
            "mesh_free_eager": device_ms(lambda: lm.decode_step(
                cfg, r_eng.params, tok, r_eng.cache), reps=10,
                label="mesh_serve decode step"),
            "mesh_replayed": device_ms(decode, reps=10,
                                       label="mesh_serve replayed tick")}
        profile = _replay_profile(decode, "mesh_serve decode replay", dev)
    emit({"phase": "mesh_serve", "arch": cfg.name, "n_layers": L,
          "dtype": "bfloat16", "mesh": [1, 1], "slots": LLAMA_SLOTS,
          "max_len": LLAMA_MAX_LEN, "requests": len(g_reqs),
          "prefills": s.prefills, "ticks": s.ticks, "graphs": g_eng.graphs,
          "trace_counts": counts, "tokens_bit_equal": tokens_equal,
          "tick_logits_bit_equal": logits_equal, "ticks_compared":
          len(g_log.ticks), "eager_requests": len(e_reqs),
          "bit_equal_to_mesh_eager": eager_equal,
          "k2_launches": launched, "k2_stats_launches": stats,
          "k2_launches_mesh_eager": e_launched,
          "k2_per_replay": per_replay,
          "capture_s": sum(st.capture_s for st in steps),
          "pool_gb": sum(st.pool_bytes for st in steps) / 1e9,
          "decode_tick_host_ms_median": {
              "graph": statistics.median(g_s) * 1e3,
              "mesh_eager": statistics.median(e_s) * 1e3,
              "mesh_free_eager": statistics.median(r_s) * 1e3},
          "decode_step_device_ms": step_ms, "replay_profile": profile})
    return launched


# The three families of mesh_families at full width: B x L tokens, and the
# train step's depth cut and tokens (xlstm-1.3b's: its sLSTM loop runs on
# the host one step at a time, and 3.5 B fp32 parameters with AdamW's
# moments, twice, would not fit beside the mesh-free run).
MESH_FAMILY = {"zamba2-1.2b": ({}, 2, 512),
               "xlstm-1.3b": ({"n_layers": 8}, 2, 256),
               "seamless-m4t-medium": ({}, 2, 512)}
MESH_FAMILY_DECODE = 8
# jit_train_step's steps in mesh_families: the first eager, the second
# replayed from the graph captured after it.
MESH_FAMILY_STEPS = 2


def _family_batch(cfg, B: int, L: int, dev, seed: int):
    gen = torch.Generator(dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (B, L), generator=gen, device=dev)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((B, cfg.frontend_len, cfg.frontend_dim),
                                      generator=gen, device=dev).to(cfg.dtype)
    return batch


def _family_serve(cfg, params, batch, steps, dev, dist=None):
    """forward's logits, prefill's logits and cache, then ``steps`` decode
    steps' logits and the cache after them (DTensors gathered)."""
    kw = {} if dist is None else {"dist": dist}
    whole = lambda t: t.full_tensor() if hasattr(  # noqa: E731
        t, "full_tensor") else t
    serve = {k: v for k, v in batch.items() if k != "labels"}
    out = [whole(lm.forward(cfg, params, batch, **kw)[0])]
    last, cache = lm.prefill(cfg, params, serve,
                             batch["tokens"].shape[1] + steps, **kw)
    out += [whole(last)] + [whole(cache[k]).clone() for k in sorted(cache)]
    gen = torch.Generator(dev).manual_seed(SEED + 5)
    for _ in range(steps):
        tok = torch.randint(0, cfg.vocab, (batch["tokens"].shape[0], 1),
                            generator=gen, device=dev)
        if dist is not None:
            tok = shard_tree(tok, P("data", None), dist.mesh)
        logits, cache = lm.decode_step(cfg, params, tok, cache, **kw)
        out.append(whole(logits))
    return out + [whole(cache[k]) for k in sorted(cache)]


def phase_mesh_families(dev, mesh):
    """zamba2-1.2b, xlstm-1.3b and seamless-m4t-medium at full width (bf16)
    under Dist on the 1x1 mesh: forward, then prefill and
    MESH_FAMILY_DECODE decode steps, bit-equal to the mesh-free path;
    MESH_FAMILY_STEPS steps of jit_train_step as users get it (fp32
    weights, AdamW; on the card the first eager, then captured, the
    second replayed) bit-equal to make_train_step's (xlstm's depth cut,
    MESH_FAMILY), K2 exact per replay.  Returns the meshed calls' K2
    launches: forward by kernel, backward by kernel and by path."""
    dist = Dist(mesh, batch_axes=("data",))
    fwd, bwd, bwd_path, rec = {}, {}, {}, {}
    for arch, (cut, B, L) in MESH_FAMILY.items():
        _fresh_device()
        t0 = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, param_dtype=full.dtype)
        params = lm.init_params(cfg, torch.Generator(dev).manual_seed(SEED),
                                dev)
        placed = shard_tree(params, lm.param_specs(cfg, dist), mesh)
        batch = _family_batch(cfg, B, L, dev, SEED + 3)
        pbatch = {k: shard_tree(v, P("data", *([None] * (v.dim() - 1))),
                                mesh) for k, v in batch.items()}
        with torch.no_grad():
            ref = _family_serve(cfg, params, batch, MESH_FAMILY_DECODE, dev)
            before = _counts()
            got = _family_serve(cfg, placed, pbatch, MESH_FAMILY_DECODE, dev,
                                dist)
            torch.cuda.synchronize()
            serve_launched = _counts_delta(before)[0]
        serve_equal = len(ref) == len(got) and all(
            torch.equal(a, b) for a, b in zip(ref, got))
        del ref, got, params, placed
        _fresh_device()
        tcfg = dataclasses.replace(full, **cut)
        params = lm.init_params(tcfg, torch.Generator(dev).manual_seed(SEED),
                                dev)
        tbatch = _family_batch(tcfg, B, L if not cut else 256, dev,
                               SEED + 4)
        specs = lm.param_specs(tcfg, dist)
        opt_cfg = optim.for_model(tcfg)
        bspecs = {k: P("data", *([None] * (v.dim() - 1)))
                  for k, v in tbatch.items()}
        start = optim.tree_map(lambda t: t.clone(), params)
        step = make_train_step(tcfg, opt_cfg, graphs=False)
        state = (start, init_opt_state(opt_cfg, start), None)
        ref_loss = []
        for _ in range(MESH_FAMILY_STEPS):
            *state, m = step(*state, tbatch)
            ref_loss.append(float(m["loss"]))
        ref_leaves = [t.clone() for t in optim.leaves(state[0])]
        del start, state, step
        # jit_train_step as users get it: its first step eager, then
        # captured, its second a replay (on the card).
        _fresh_device()
        step = jit_train_step(tcfg, dist, specs, opt_cfg, batch_specs=bspecs)
        placed = shard_tree(params, specs, mesh)
        state, loss, train_launched = (placed, init_opt_state(
            opt_cfg, placed), None), [], []
        for _ in range(MESH_FAMILY_STEPS):
            before = _counts()
            *state, gm = step(*state, tbatch)
            loss.append(float(gm["loss"].to_local()))
            torch.cuda.synchronize()
            train_launched.append(_counts_delta(before))
        captured = next(iter(step.step.steps.values()), None)
        got_leaves = optim.leaves(full_tree(state[0]))
        train_equal = (loss == ref_loss and all(
            torch.equal(a, b) for a, b in zip(ref_leaves, got_leaves)))
        per_replay = None
        if dev.type == "cuda":
            require(step.step.graphs and captured.graph is not None
                    and captured.replays == MESH_FAMILY_STEPS - 1,
                    f"mesh_families {arch}: jit_train_step did not replay "
                    "a CUDA graph")
            per_replay = _k2_per_replay(captured)
            eager = tuple({k: n for k, n in d.items() if n} for d in (
                train_launched[0][0], train_launched[0][2]))
            require(per_replay == eager, f"mesh_families {arch}: a replay "
                    f"launches K2 {per_replay}, the eager step {eager}")
            _count_replays("mesh_families", per_replay, captured.replays)
        train_launched = tuple(
            {k: sum(d[i].get(k, 0) for d in train_launched)
             for k in set().union(*(d[i] for d in train_launched))}
            for i in range(len(train_launched[0])))
        capture = ({} if captured is None or captured.graph is None else {
            "capture_s": captured.capture_s,
            "pool_gb": captured.pool_bytes / 1e9})
        del params, placed, state, ref_leaves, got_leaves, step, captured
        require(serve_equal, f"mesh_families {arch}: the meshed forward, "
                "prefill or decode differs from the mesh-free path")
        require(train_equal, f"mesh_families {arch}: jit_train_step on the "
                f"1x1 mesh is not bit-equal to make_train_step: {loss} vs "
                f"{ref_loss}")
        attention = cfg.family != "ssm"
        require(bool(serve_launched) == attention, f"mesh_families {arch}: "
                f"K2 launches {serve_launched}")
        for key, n in serve_launched.items():
            fwd[key] = fwd.get(key, 0) + n
        for key, n in train_launched[0].items():
            fwd[key] = fwd.get(key, 0) + n
        for d, got in ((bwd, train_launched[1]), (bwd_path,
                                                  train_launched[2])):
            for key, n in got.items():
                d[key] = d.get(key, 0) + n
        rec[arch] = {"tokens": [B, L], "decode_steps": MESH_FAMILY_DECODE,
                     "serve_bit_equal": serve_equal,
                     "train_cut": cut, "train_tokens": list(
                         tbatch["tokens"].shape), "train_loss": ref_loss,
                     "train_steps": MESH_FAMILY_STEPS,
                     "train_bit_equal": train_equal,
                     "train_graphs": bool(capture),
                     "train_k2_per_replay": per_replay, **capture,
                     "k2_launches": {"serve": serve_launched,
                                     "train": train_launched[:3]},
                     "seconds": time.perf_counter() - t0}
    emit({"phase": "mesh_families", "mesh": [1, 1], "dtype": "bfloat16",
          "archs": rec})
    return fwd, bwd, bwd_path


def _host_drops(idx, C: int, E: int) -> torch.Tensor:
    """The capacity rule on the host: an assignment (t, j) is dropped when
    C earlier assignments (in flat order t*k + j) chose its expert."""
    flat = idx.reshape(-1).cpu().numpy()
    seen = np.zeros(E, np.int64)
    out = np.zeros(flat.shape, np.int32)
    for a, e in enumerate(flat):
        out[a] = seen[e] >= C
        seen[e] += 1
    return torch.from_numpy(out.reshape(idx.shape))


def _gemm_ms(parts: dict) -> dict:
    """The matrix-product kernels among ``device_ms``'s parts."""
    return {name[:90]: t for name, t in parts.items()
            if any(tag in name.lower() for tag in ("gemm", "nvjet", "cutlass",
                                                  "xmma", "grouped"))}


def phase_mesh_moe(dev, mesh):
    """deepseek-moe-16b's expert-parallel moe_ffn at full width (64
    experts of 1408, top-6, bf16) on MESH_MOE_TOKENS tokens on the 1x1
    mesh: at capacity factor 2.0 the drop count (none: the output within
    MOE_FFN_BF16_TOL * max|ref| of the dropless path), at 0.5 the dropped
    set equal to the rule applied on the host to the card's own routing;
    each batched GEMM's device time beside the grouped GEMM's."""
    cfg = get_config("deepseek-moe-16b")
    dist = Dist(mesh, batch_axes=("data",))
    gen = torch.Generator(dev).manual_seed(SEED + 7)
    bf16, d, f, E = torch.bfloat16, cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    p = {"router": torch.randn((d, E), generator=gen, device=dev) * d ** -0.5,
         "w13": (torch.randn((E, d, 2 * f), generator=gen, device=dev)
                 * d ** -0.5).to(bf16),
         "w2": (torch.randn((E, f, d), generator=gen, device=dev)
                * f ** -0.5).to(bf16)}
    x = torch.randn((1, MESH_MOE_TOKENS, d), generator=gen,
                    device=dev).to(bf16)
    spec = lm.param_specs(cfg, dist)["layers"]
    sp = {"router": shard_tree(p["router"], P(*spec["router"][1:]), mesh),
          "w13": shard_tree(p["w13"], P(*spec["moe_w13"][1:]), mesh),
          "w2": shard_tree(p["w2"], P(*spec["moe_w2"][1:]), mesh)}
    sx = shard_tree(x, P("data", None, None), mesh)
    with torch.no_grad():
        dropless = moe.moe_ffn(cfg, p, x)[0]
        idx = moe.router_topk(x, p["router"], cfg.top_k)[0]
        rec = {}
        for cf in MESH_MOE_FACTORS:
            c = dataclasses.replace(cfg, capacity_factor=cf)
            C = moe.capacity(c, MESH_MOE_TOKENS)
            routes = dict(moe.grouped_gemm.launches_by_route)
            out, _, dropped = moe.moe_ffn(c, sp, sx, mesh, ("data",),
                                          return_dropped=True)
            require(moe.grouped_gemm.launches_by_route == routes,
                    "mesh_moe: the capacity path ran the grouped GEMM")
            out, dropped = out.to_local(), dropped.to_local()
            torch.cuda.synchronize()
            host = _host_drops(idx, C, E)
            n_drop = int(dropped.sum())
            rec[cf] = {"capacity": C, "dropped": n_drop,
                       "dropped_share": n_drop / idx.numel(),
                       "drops_equal_host_rule": bool(torch.equal(
                           dropped.cpu(), host)),
                       "finite": bool(torch.isfinite(out).all())}
            require(rec[cf]["finite"] and out.shape == x.shape,
                    f"mesh_moe: capacity {cf}: the output is not finite")
            require(rec[cf]["drops_equal_host_rule"], f"mesh_moe: capacity "
                    f"{cf}: the card's dropped set is not the rule's on its "
                    "own routing")
            if n_drop == 0:
                scale = float(dropless.float().abs().max())
                err = float((out.float() - dropless.float()).abs().max())
                rec[cf].update({"max_abs_err_vs_dropless": err,
                                "ref_max_abs": scale})
                require(err <= MOE_FFN_BF16_TOL * scale, f"mesh_moe: "
                        f"capacity {cf} drops nothing but is {err} off the "
                        f"dropless path (max|ref| {scale})")
        require(rec[MESH_MOE_FACTORS[-1]]["dropped_share"] >= 0.1,
                f"mesh_moe: capacity {MESH_MOE_FACTORS[-1]} dropped "
                f"{rec[MESH_MOE_FACTORS[-1]]['dropped_share']:.3f} of the "
                "assignments")
        cap = dataclasses.replace(cfg, capacity_factor=MESH_MOE_FACTORS[0])
        parts_cap, parts_free = {}, {}
        cap_ms = device_ms(lambda: moe.moe_ffn(cap, sp, sx, mesh, ("data",)),
                           reps=5, label="mesh_moe capacity",
                           parts=parts_cap)
        free_ms = device_ms(lambda: moe.moe_ffn(cfg, p, x), reps=5,
                            label="mesh_moe dropless", parts=parts_free)
        gemms = _moe_gemm_rows(cfg, p, idx, moe.capacity(cap, x.shape[1]),
                               dev)
    emit({"phase": "mesh_moe", "arch": cfg.name, "mesh": [1, 1],
          "experts": [E, cfg.top_k], "expert_d_ff": f, "dtype": "bfloat16",
          "tokens": MESH_MOE_TOKENS, "capacity_factors": rec,
          "device_ms": {"capacity": cap_ms, "dropless": free_ms},
          "gemm_kernels_ms": {"capacity_bmm": _gemm_ms(parts_cap),
                              "dropless_grouped": _gemm_ms(parts_free)},
          "gemms": gemms})


def _moe_gemm_rows(cfg, p, idx, C: int, dev) -> dict:
    """Each of the MoE layer's two products alone, device ms: the capacity
    path's batched GEMMs over (E, C, ·) and the dropless path's grouped
    GEMMs over the T·k sorted assignments (``idx``'s groups), with the
    FLOPs each computes (the batched ones over C rows an expert, padding
    included)."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    gen = torch.Generator(dev).manual_seed(SEED + 8)
    bf16 = torch.bfloat16
    xb = torch.randn((E, C, d), generator=gen, device=dev).to(bf16)
    ab = torch.randn((E, C, f), generator=gen, device=dev).to(bf16)
    n = idx.numel()
    xs = torch.randn((n, d), generator=gen, device=dev).to(bf16)
    xa = torch.randn((n, f), generator=gen, device=dev).to(bf16)
    ends = torch.searchsorted(torch.sort(idx.reshape(-1)).values,
                              torch.arange(E, device=dev), right=True,
                              out_int32=True)
    rows = {}
    for name, fn, flops in (
            ("bmm_w13", lambda: torch.bmm(xb, p["w13"]),
             2 * E * C * d * 2 * f),
            ("bmm_w2", lambda: torch.bmm(ab, p["w2"]), 2 * E * C * f * d),
            ("grouped_w13", lambda: moe._grouped(xs, p["w13"], ends),
             2 * n * d * 2 * f),
            ("grouped_w2", lambda: moe._grouped(xa, p["w2"], ends),
             2 * n * f * d)):
        ms = device_ms(fn, reps=10, label=f"mesh_moe {name}")
        rows[name] = {"device_ms": ms, "flops": flops,
                      "bound_ms": flops / 989e12 * 1e3}
    return rows


def _dryrun_cells():
    """Every (arch, shape) cell of the registry, the skipped ones included
    (the dry-run records them as skipped)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.common import SHAPES
    return [f"{a}:{s}" for a in ARCHS for s in SHAPES]


def _start_dryrun(out_dir):
    """The dry-run of every cell on both meshes (CPU only: a fake process
    group of 256 or 512 ranks), started now in DRYRUN_WORKERS processes of
    its own, a mesh's cells dealt round-robin among its workers; read by
    :func:`phase_dryrun`."""
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"), CUDA_VISIBLE_DEVICES="",
        OMP_NUM_THREADS="1")
    cells = _dryrun_cells()
    procs = []
    for flag in ([], ["--multi-pod"]):
        for w in range(DRYRUN_WORKERS // 2):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--cells", ",".join(cells[w::DRYRUN_WORKERS // 2]),
                 "--out", out_dir] + flag, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def phase_dryrun(procs, out_dir, t0):
    """The dry-run's records, every cell on both meshes: 32 ok and 8
    skipped a mesh; the pinned cells' per-device argument bytes the
    reference dry-run's; every ok cell's roofline sane (0 < useful_ratio
    <= 3, the bottleneck one of the three terms), its FLOPs, peak and
    collective bytes by kind recorded with the torch version that counted
    them."""
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=1200)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    require(all(p.returncode == 0 for p in procs), "dryrun: a worker "
            f"failed: {[log[-2000:] for log in logs]}")
    cells, counts, hardware = {}, {}, None
    for mesh in ("pod16x16", "pod2x16x16"):
        counts[mesh] = {"ok": 0, "skipped": 0}
        for cell in _dryrun_cells():
            arch, shape = cell.split(":")
            with open(os.path.join(out_dir, mesh,
                                   f"{arch}__{shape}.json")) as fh:
                rec = json.load(fh)
            require(rec["status"] in ("ok", "skipped"), f"dryrun {mesh} "
                    f"{cell}: {rec.get('error')}")
            counts[mesh][rec["status"]] += 1
            if rec["status"] == "skipped":
                continue
            rf, mem, hardware = rec["roofline"], rec["memory"], rec["hardware"]
            pinned = DRYRUN_PINNED.get(cell) if mesh == "pod16x16" else None
            require(pinned is None or mem["argument_bytes"] == pinned,
                    f"dryrun {cell}: argument bytes {mem['argument_bytes']},"
                    f" pinned {pinned}")
            require(0 < rf["useful_ratio"] <= 3 and rf["bottleneck"] in (
                "compute", "memory", "collective"), f"dryrun {mesh} {cell}: "
                f"roofline {rf}")
            cells[f"{mesh}:{cell}"] = {
                "flops": rf["flops_per_device"],
                "peak_bytes": mem["peak_estimate_bytes"],
                "argument_bytes": mem["argument_bytes"],
                "collectives": rf["collectives"],
                "bottleneck": rf["bottleneck"], "run_s": rec["run_s"]}
    for mesh, got in counts.items():
        require(got == {"ok": 32, "skipped": 8}, f"dryrun {mesh}: {got}")
    emit({"phase": "dryrun", "meshes": {"pod16x16": 256, "pod2x16x16": 512},
          "counts": counts, "torch": torch.__version__, "cells": cells,
          "hardware": hardware, "wall_s": time.perf_counter() - t0})


# (phase, host clock when it ended), for the phase_seconds line.
MARKS: list = []


def _mark(name: str) -> None:
    MARKS.append((name, time.perf_counter()))


def _zero_counts() -> None:
    spmm.launches = 0
    spmm.launches_by_dir = {"fwd": 0, "bwd": 0}
    flash_attention.launches = 0
    flash_attention.launches_by_path = dict.fromkeys(
        flash_attention.launches_by_path, 0)
    flash_attention.stats_launches = 0
    flash_attention.backward_launches = dict.fromkeys(
        flash_attention.backward_launches, 0)
    flash_attention.backward_launches_by_path = dict.fromkeys(
        flash_attention.backward_launches_by_path, 0)
    moe.grouped_gemm.launches_by_route = dict.fromkeys(
        moe.grouped_gemm.launches_by_route, 0)
    moe.grouped_gemm.backward_launches_by_route = dict.fromkeys(
        moe.grouped_gemm.backward_launches_by_route, 0)


def main() -> int:
    t_start = time.perf_counter()
    kind, smi_line = phase_device()
    dev = torch.device("cuda", 0)
    # The dry-run runs on the host while the card runs every phase.
    dry_dir = tempfile.mkdtemp(prefix="dryrun-")
    t_dry = time.perf_counter()
    dry = _start_dryrun(dry_dir)
    phase_build()
    _mark("build")
    siot = phase_layout("siot", dev)
    yelp = phase_layout("yelp", dev)
    kernel_rows, bwd_rows, worst = phase_kernels([siot, yelp], dev)
    _mark("layout_and_kernels")
    flash_rows, flash_worst = phase_flash_kernels(dev)
    stats_rows, stats_worst = phase_flash_stats(dev)
    flash_rows += stats_rows
    flash_worst = max(flash_worst, stats_worst)
    flash_bwd_rows, flash_bwd_worst = phase_flash_backward(dev)
    _mark("flash_kernels")
    train_rows, train_worst, _ = phase_train_kernels(dev)
    _mark("train_kernels")
    flash_bwd_rows += train_rows
    flash_bwd_worst = max(flash_bwd_worst, train_worst)
    emit({"phase": "profiler_windows", "off_windows": len(LOST_WINDOWS),
          "windows": LOST_WINDOWS[:12]})

    _zero_counts()                            # the train path starts here
    phase_train([siot, yelp], dev)
    _mark("train")
    train_launches = dict(spmm.launches_by_dir)       # ... and ends here
    require(train_launches["bwd"] > 0,
            "the train path never launched spmm_csr's backward")
    require(flash_attention.launches == 0, "the train path launched K2")
    phase_whole_graph([siot, yelp], dev)
    _mark("whole_graph")
    require(spmm.launches_by_dir == train_launches
            and flash_attention.launches == 0,
            "the whole-graph steps launched a kernel of the reference's")
    _k2_differentiates(dev)
    _mark("k2_grad")

    _zero_counts()                            # the GNN path starts here
    params_of = phase_bsp([siot, yelp], dev)
    _mark("bsp")
    phase_serve(siot, params_of, dev)
    _mark("serve")
    phase_replicate(siot, params_of, dev)
    _mark("replicate")
    phase_patch(siot, params_of, dev)
    _mark("patch")
    phase_evolve(siot, params_of, dev)
    _mark("evolve")
    gnn_launches = spmm.launches              # the example twins from here
    phase_ex_quickstart(dev)
    _mark("ex_quickstart")
    phase_ex_relayout(dev)
    _mark("ex_relayout")
    phase_ex_serve_gnn(dev)
    _mark("ex_serve_gnn")
    phase_ex_experts(dev)
    _mark("ex_experts")
    launches = spmm.launches                  # ... and ends here
    require(launches > gnn_launches,
            "the example twins never launched spmm_csr")
    require(launches > 0, "the GNN path never launched spmm_csr")
    require(spmm.launches_by_dir["bwd"] == 0,
            "the forward path launched spmm_csr's backward")
    del params_of
    # The ranks path: its launches are counted in the ranks, each from 0;
    # the comparison forwards here come after the GNN path's count.
    rank_launches = phase_ranks([siot, yelp], dev)
    _mark("ranks")
    require(rank_launches["fwd"] > 0 and rank_launches["bwd"] > 0,
            f"the ranks never launched spmm_csr both ways: {rank_launches}")
    del siot, yelp

    phase_lm_parity(dev)
    _mark("lm_parity")
    flash_launches, flash_by_path = phase_lm_serve(dev, flash_rows)
    _mark("lm_serve")
    require(flash_launches > 0, "the LM path never launched flash_attention")
    ex_by_path = phase_ex_serve_lm(dev)       # inside the LM path's count
    _mark("ex_serve_lm")
    require(sum(ex_by_path.values()) > 0,
            "the LM example twin never launched flash_attention")
    flash_launches += sum(ex_by_path.values())
    flash_by_path = {k: flash_by_path[k] + ex_by_path[k]
                     for k in flash_by_path}
    phase_moe_parity(dev)
    moe_launches, moe_by_path = phase_moe_serve(dev, flash_rows)
    _mark("moe_serve")
    require(moe_launches > 0, "the MoE path never launched flash_attention")
    phase_hybrid_parity(dev)
    hybrid_launches, hybrid_by_path = phase_hybrid_serve(dev)
    _mark("hybrid_serve")
    require(hybrid_launches > 0,
            "the hybrid path never launched flash_attention")
    phase_xlstm_parity(dev)
    xlstm_launches, _ = phase_xlstm_serve(dev)
    _mark("xlstm_serve")
    require(xlstm_launches == 0, "the xLSTM path launched flash_attention")
    phase_recurrent_fp32(dev)
    phase_vlm_parity(dev)
    vlm_launches, vlm_by_path = phase_vlm_serve(dev)
    _mark("vlm_serve")
    require(vlm_launches > 0, "the VLM path never launched flash_attention")
    phase_encdec_parity(dev)
    encdec_launches, encdec_by_path = phase_encdec_serve(dev)
    _mark("encdec_serve")
    require(encdec_launches > 0,
            "the enc-dec path never launched flash_attention")
    phase_zoo_fp32(dev)
    _mark("zoo_fp32")
    train_launches_k2, train_by_path, train_bwd, train_bwd_by_path = (
        phase_lm_train(dev))
    _mark("lm_train")
    family_train = {name: phase_family_train(name, dev)
                    for name in TRAIN_MAIN}
    _mark("family_train")
    # The mesh path: a 1x1 NCCL mesh in this process.
    _fresh_device()
    with _one_rank_mesh(dev) as mesh:
        mesh_fwd = phase_mesh_parity(dev, mesh)
        mesh_train_fwd, mesh_train_bwd, mesh_train_by_path = (
            phase_mesh_train(dev, mesh))
        phase_mesh_moe(dev, mesh)
        _zero_counts()                  # the meshed serving path starts here
        mesh_serve_by_path = phase_mesh_serve(dev, mesh)
        fam_fwd, fam_bwd, fam_bwd_by_path = phase_mesh_families(dev, mesh)
        require(flash_attention.launches_by_path["decode"] > 0
                and flash_attention.launches_by_path["prefill_tc"] > 0,
                "the meshed serving path never launched K2's decode and "
                "prefill kernels")
    require(spmm.launches == 0, "the mesh phases launched spmm_csr")
    _mark("mesh")
    phase_dryrun(dry, dry_dir, t_dry)
    _mark("dryrun")
    for key, n in fam_bwd_by_path.items():
        mesh_train_by_path[key] = mesh_train_by_path.get(key, 0) + n
    train_fwd_phases = {"lm_train": train_by_path, **{
        name: {key: got[0].get(key, 0) for key in train_by_path}
        for name, got in family_train.items()},
        "mesh_parity": mesh_fwd, "mesh_train": mesh_train_fwd,
        "mesh_serve": {k: mesh_serve_by_path.get(k, 0)
                       for k in train_by_path},
        "mesh_families": {k: fam_fwd.get(k, 0) for k in train_by_path}}
    train_bwd_phases = {"lm_train": train_bwd, **{
        name: got[1] for name, got in family_train.items()},
        "mesh_train": mesh_train_bwd,
        "mesh_families": {k: fam_bwd.get(k, 0) for k in train_bwd}}

    head = kernel_rows[0]
    flash_head = next(r for r in flash_rows
                      if r["shape"].startswith("decode"))
    bwd_head = flash_bwd_rows[0]                 # the train shape, L = 1024
    ends = [("start", t_start)] + MARKS
    emit({"phase": "phase_seconds", "seconds": {
        name: t - was for (_, was), (name, t) in zip(ends, ends[1:])}})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [{
        "name": "spmm_bsr", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spmm_csr.cu",
        "replaces": "src/repro/kernels/gnn_aggregate.py:77",
        "launches": (launches + sum(train_launches.values())
                     + sum(rank_launches.values())),
        "launches_by_path": {"gnn": gnn_launches,
                             "examples": launches - gnn_launches,
                             "train_fwd": train_launches["fwd"],
                             "train_bwd": train_launches["bwd"],
                             "ranks_fwd": rank_launches["fwd"],
                             "ranks_bwd": rank_launches["bwd"]},
        "backward_launches": train_launches["bwd"] + rank_launches["bwd"],
        "max_abs_err": worst,
        "ms": head["ms"], "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_device_ms": head["library_device_ms"],
        "dense_values_bound_ms": head["dense_values_bound_ms"],
        "shape": head["shape"],
        "shapes": {r["shape"]: {key: r.get(key) for key in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "nnz")}
            for r in kernel_rows},
        "backward_shapes": {r["shape"]: {key: r.get(key) for key in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms", "nnz")}
            for r in bwd_rows}}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:117",
        "launches": (flash_launches + moe_launches + hybrid_launches
                     + vlm_launches + encdec_launches + sum(
                         sum(d.values()) for d in train_fwd_phases.values())),
        "launches_by_path": {key: flash_by_path[key] + moe_by_path[key]
                             + hybrid_by_path[key] + vlm_by_path[key]
                             + encdec_by_path[key]
                             + sum(d[key] for d in train_fwd_phases.values())
                             for key in flash_by_path},
        "examples_launches": sum(ex_by_path.values()),
        "launches_from_replays_by_phase": {
            phase: got[0] for phase, got in REPLAYED.items()},
        "launches_by_phase": {"lm_serve": {k: flash_by_path[k]
                                           - ex_by_path[k]
                                           for k in flash_by_path},
                              "ex_serve_lm": ex_by_path,
                              "moe_serve": moe_by_path,
                              "hybrid_serve": hybrid_by_path,
                              "vlm_serve": vlm_by_path,
                              "encdec_serve": encdec_by_path,
                              **train_fwd_phases},
        "backward_launches": {key: sum(d.get(key, 0)
                                       for d in train_bwd_phases.values())
                              for key in train_bwd},
        "backward_launches_by_phase": train_bwd_phases,
        "backward_launches_by_path": {key: train_bwd_by_path[key] + sum(
            got[2].get(key, 0) for got in family_train.values())
            + mesh_train_by_path.get(key, 0) for key in train_bwd_by_path},
        "backward_source": "src/repro_torch/kernels/csrc/"
                           "flash_attention_bwd_tc.cu",
        "max_abs_err": flash_worst,
        "backward_max_abs_err": flash_bwd_worst,
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
            "library_cut_device_ms")} for r in flash_rows},
        "backward_shapes": {r["shape"]: {key: r.get(key) for key in (
            "path", "max_abs_err", "ms", "device_ms", "device_ms_by_kernel",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms")} for r in flash_bwd_rows}}, {
        "name": "flash_attention_bwd_tc", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu",
        "replaces": "src/repro/kernels/flash_attention.py:117",
        "launches": sum(sum(d.values()) for d in train_bwd_phases.values()),
        "launches_by_kernel": {key: sum(d.get(key, 0)
                                        for d in train_bwd_phases.values())
                               for key in train_bwd},
        "launches_by_phase": train_bwd_phases,
        "launches_from_replays_by_phase": {
            phase: got[1] for phase, got in REPLAYED.items() if got[1]},
        "backward_launches_by_path": {key: train_bwd_by_path[key] + sum(
            got[2].get(key, 0) for got in family_train.values())
            + mesh_train_by_path.get(key, 0) for key in train_bwd_by_path},
        "max_abs_err": flash_bwd_worst,
        "ms": bwd_head["ms"], "device_ms": bwd_head["device_ms"],
        "device_ms_by_kernel": bwd_head["device_ms_by_kernel"],
        "plain_ms": bwd_head["plain_ms"], "bound_ms": bwd_head["bound_ms"],
        "bound_by": bwd_head["bound_by"],
        "library_ms": bwd_head["library_ms"],
        "library_device_ms": bwd_head["library_device_ms"],
        "shape": bwd_head["shape"]}]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
