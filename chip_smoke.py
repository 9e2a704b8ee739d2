#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: build, check and drive it on one GPU.

    python3 chip_smoke.py [--baseline DIR]

Phases, each fatal on failure (exit code 1, no result line):

1. Build every CUDA source of ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together).
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it and at one larger shape, and time kernel,
   plain version and (where one exists) a library call with CUDA events.
   The int8 quantize/dequantize kernels must be bit-equal to theirs, at
   every averaging shape of config C (8 machines × each leaf's size, with
   uniforms), config D's halo buffer (round-half-up) and (65536, 256) both
   ways, and the grouped dequantize on C's whole round table (one launch),
   segments of rows of 1, 8, 17 and 33 values, unaligned and
   non-contiguous views, empty segments and more segments than a launch's
   table holds; ``torch.mul(q, s)`` (``torch._foreach_mul`` for a table)
   is the dequantize's library yardstick; the edge softmax runs at config
   B's four shapes and two large
   ones; the SpMM runs on the slice graph, a 16,384-node SBM graph and the
   same with 16 hubs of 4,096 neighbors; the chunked linear scan is
   checked in both conventions (RWKV6's strict one at the serving shapes,
   ragged and large; the plain one at Mamba2 widths) and in the plain
   convention's scalar-decay mode at zamba2's prefill shapes ((448, 192)
   and the ragged (448, 77), with and without a carried state, and at −3
   per step, where the factored form overflows), also against the
   one-token recurrence replayed, and must fit two CTAs on each SM in
   every mode.  The ``csr`` aggregation layout (plain PyTorch, no kernel
   of its own) is timed at config A's shape and on config F3's graph,
   forward and forward + backward, eager and CUDA-graph replay, against
   the SpMM (mean) and the padded fused edge-softmax route (GAT), and held
   against them.
3. Drive the trainer — ``build_trainer(data, model, plan).run()`` on the
   paper's ``reddit`` setting for 3 rounds — in four configurations:
   A (``llcg_plan``, arch SBSBS, server correction through the CSR SpMM
   kernel, the ``bcsr_kernel`` layout), B (the same on a fused GAT, every
   aggregation through the edge-softmax kernel), C (config A with int8
   error-feedback compressed averaging: 13 parameter leaves, one quantize
   launch each and one grouped dequantize launch for all of them per
   round) and D (``ggs_plan``, arch
   SBSBS, the halo exchange executed with int8 halo compression: one
   quantize and one dequantize launch per round).  Launch counts are reset
   just before each run and read just after; each config must launch its
   kernels, B, C and D exactly as many times as stated (B: (K local steps
   + S correction steps + 1 evaluation) × 2 GAT layers per round).  The
   History must be finite, its bytes must equal the trainer's accounting,
   and its losses must agree with the same run on the CPU (plain versions,
   same stochastic-rounding uniforms).
4. Serve rwkv6-1.6b at full width (config E): random weights from a seed,
   drawn once on the CPU.  E1 serves 8 greedy requests (4 prompts of 192
   tokens, 4 of 77, 32 new tokens each; two waves of 4) through
   ``ServingEngine`` in the config's bfloat16 (embedding rows rounded to
   bf16, layers in f32, as the JAX package computes it): every prefill
   layer's scan through the kernel (exactly 48 launches), every logit
   finite, the same tokens when served again, and the 77-token wave's
   prefill on the card within 1e-3 × max(1, max|cpu|) of the CPU's in the
   same config, layer by layer (each layer fed the CPU's input to it).
   E2 runs the f32 model on the card and on the CPU on one 77-token
   prompt: prefill logits, every layer's state and 4 teacher-forced
   decode steps must agree within the same tolerance.

Between 3 and 4, configs F1–F3 run the server correction through the
``csr`` layout, each through ``_drive``'s gates: F1 is config A's plan
with ``server_agg_layout="csr"`` (exactly 0 SpMM launches, and A's
trajectory within the CPU tolerance), F2 config B's GAT, not fused, with
csr (exactly 0 edge-softmax launches), F3 ``server_agg_layout="auto"`` on
a degree-skewed R-MAT graph of 16,384 nodes, which must resolve to csr.
Phase P then drives the paper runner (``benchmarks/torch/
paper_experiments.py``) on the card and on the CPU: ``fig2_and_fig4`` for
3 rounds (all four ``run_*`` shims, each History held against the CPU's),
``estimate_discrepancies`` on ``kappa_vs_gap``'s setting (random
partition), ``run_subgraph_approx`` on fig11's for 3 rounds, and
``run_llcg`` with ``server_agg_layout="bcsr_kernel"``, whose SpMM launches
must be exactly rounds × S × (2 × aggregating layers − 1).

After P, phase K checkpoints config C's plan (int8_ef: the snapshot
carries the error-feedback residual and the stochastic-rounding uniform
stream) every round with the async writer: the uninterrupted run three times
(pairwise within ``K_DEFAULT_LIMIT``), resumes from steps 1 and 2 and
``run_or_resume`` on a directory holding step 1, each with its exact
quantize / dequantize / SpMM launches, every count equal to the
uninterrupted run's, its series and parameters within ``K_DEFAULT_LIMIT``
of it and its trajectory within the card-vs-CPU rule (losses within 1e-3
relative, F1 within one eval node);
the same again under ``torch.use_deterministic_algorithms(True)``, where
the two runs and the three resumes must agree bit for bit; one SIGKILL
trial of ``repro_torch.checkpoint.chaos`` on the card; the card's checkpoint resumed on the CPU must follow the CPU's run; the
caller-thread cost of ``save()`` is printed.  Phase S serves through
``repro_torch.serving.gnn``: S1 trains config B's fused GAT 3 rounds with
``checkpoint_dir`` and serves 64 requests (half at full width, half at
fanout 10) through ``GNNServingEngine.from_plan`` with the int8 halo codec
(per wave one quantize, one dequantize and one edge-softmax launch per GAT
layer), S2 the same with 2 serve-time correction steps (stored params
unchanged), S3 config A's SAGE stack without its batch norms (serving
refuses batch statistics) through stacked csr operands, wave and slot,
against the single-machine full-graph forward, S4 F3's graph with
``agg_layout="auto"`` (must resolve to csr); S1, S2 and S4 agree with the
CPU's serve (predictions equal, logits within 1e-4 × max(1, max|cpu|)).
After E1, E3 serves E1's 8 requests through ``scheduler="slot"``: a
batch-1 prefill per request (24 scan launches each, 192 in all) and the
same tokens as E1's waves.

Last, config Z serves zamba2-7b at full width (81 layers: 68 Mamba2
blocks on the scan's scalar-decay mode and 13 applications of one shared
attention block; 5.78 B random f32 weights drawn once on the CPU, ~42 s,
and copied to the card; the host copy serves Z2).  Z1 serves E1's 8
requests through ``ServingEngine`` in the bfloat16 config, batch 4,
``max_seq`` 256: exactly 136 scan launches (68 per prefill), every logit
finite, the same tokens when served again; prints time to first token, ms
per decode step, tokens/s, peak device memory and the busy share of the
77-token wave served alone.  Z2 runs one 77-token prompt and 4
teacher-forced decode steps at batch 1, each layer on the card fed the
CPU's input and state, output and every state leaf (conv tail, h, each
shared application's K/V cache) within 1e-3 × max(1, max|cpu|), the
positions exactly; the card's own chain is printed against the CPU's, not
gated.  Z3: ``prefill(x[:T])`` then ``decode_step(x[T])`` equals the last
logits of ``prefill(x[:T+1])`` within 2e-4 × max(1, max|logits|), T 76
and 128.  Z-slot serves Z1's requests through ``scheduler="slot"`` (4
slots, each decoding at its own position): exactly 544 scan launches (68
per batch-1 prefill) and Z1's tokens.

Then the dense attention stacks, random f32 weights from a seed drawn on
the CPU (config Z's host copy freed first), no hand-written kernel on
their paths (0 launches, gated):
- G, gemma3-1b uncut (26 layers, 5 ``swa`` + 1 ``full`` a unit, MQA,
  ``qk_norm``, window 512), ``max_seq`` 1024, its bfloat16 config.  G1
  serves 8 requests (4 prompts of 640 tokens, 4 of 77, 32 new) in two
  waves: finite logits, the same tokens served again; TTFT, ms per decode
  step, tokens/s, peak memory and the busy share of the 640-token wave.
  G2 holds the 640-token wave's prefill and 4 teacher-forced decode steps
  against the CPU layer by layer (the rings wrap in both), every cache's
  positions exactly.  G3 serves G1's requests through the slot scheduler
  (exact buckets, the window being shorter than ``max_seq``) and must give
  G1's tokens, each sampled logits row within 1e-3 × max(1, max|wave|) of
  G1's wave path's (the pool's rows sit at their own positions).
- H, h2o-danube-3-4b uncut (24 ``swa`` layers, GQA 32/8, head 120,
  window 4096), E's requests at ``max_seq`` 256: H1 the wave scheduler
  (G1's gates and metrics, the 192-token wave profiled), H2 the slot
  scheduler with pow2 buckets (the 77-token prompts prefill padded to
  128, the 192-token ones to 256; H1's tokens and, as G3, its logits), H3
  the 77-token wave's prefill against the CPU layer by layer.
- SC, starcoder2-15b at full width cut to 2 layers (48/4 GQA ``full``,
  the GELU MLP): a 77-token prompt and 4 decode steps against the CPU
  layer by layer.
- G4, gemma3-1b at full width cut to 2 layers (``swa``, ``full``) with
  the int8 KV cache and ``logit_softcap=50``: G's 640-token prompts and 4
  decode steps against the CPU layer by layer, the int8 codes after
  dequantization within one quantization step.
Each layer-by-layer comparison is at E's 1e-3 × max(1, max|cpu|).

Then the MoE stacks and the frontends, random f32 weights from a seed, no
hand-written kernel on their paths (0 launches, gated):
- Q, qwen2-moe-a2.7b at full width cut to Q_LAYERS of its 24 ``moe``
  layers (60 experts top-4 of 1408, 4 fused shared experts; cut in depth
  for the script's time, SCRIPT_LIMIT_S), weights drawn a layer at a
  time into their stacks on the card (the host never holds the tree): Q1 E's
  requests through the wave scheduler, served twice with equal tokens; Q2
  the slot scheduler, exact buckets (padding moves an MoE's capacity),
  its tokens and every sampled logits row against a batch-1 wave's at
  LM_TOL (capacity depends on what shares a prefill); Q3 its first
  MOE_LAYERS layers, the 192-token wave's prefill and 4 decode steps
  against the CPU layer by layer.
- QW, qwen3-moe-30b-a3b at full width (128 experts top-8 of 768, GQA
  32/4, ``qk_norm``) cut to MOE_LAYERS layers: as Q3.  In Q3 and QW each
  MoE layer's routing is recorded on both sides; a token routed
  otherwise on the card must be a near tie (the CPU's k-th and (k+1)-th
  router probabilities within ROUTE_TIE) or the capacity shift one
  causes, is counted and printed, and is left out of that layer's
  output; the rest are held at LM_TOL.
- V, internvl2-2b uncut (24 ``full`` layers, 256 patch tokens before the
  prompt), ``max_seq`` 512: V1 E's requests through the wave scheduler
  (zero patches, decode from prefix + prompt), twice; V2 the slot
  scheduler, pow2 buckets [128, 256]: V1's tokens and logits; V3 the
  77-token wave with random patches against the CPU layer by layer.
- HB, hubert-xlarge uncut (48 bidirectional ``full`` layers, the GELU
  MLP, bfloat16 stream): ``LM.forward`` on 4 clips of 500 frames with
  seeded masks on the card, and one clip layer by layer against the CPU
  at the bf16 rule's 2e-2 × max(1, max|cpu|).

Then LM training (rwkv6-1.6b's trainer; TF32 off throughout):
- T1, the scan's gradient kernel (``csrc/linear_scan_bwd.cu``) against
  torch autograd of its plain version on the card, every gradient within
  SCAN_TOL × max(1, max|plain|): strict with ``u`` at rwkv6's training
  shape (BH 128, T 128, and a ragged 77, in rwkv6's chunks of 8),
  plain per-key with a carried state and a
  cotangent of h_T, and the scalar-decay mode at zamba2's (448, 192);
  eager and CUDA-graph times, the plain version's, the bound.
- T2, card against CPU, in the shipped bfloat16 configs: rwkv6-1.6b at
  full width cut to T2_LAYERS layers, and zamba2-7b at full width cut to
  one unit of its shared block and T2_MAMBA_LAYERS Mamba2 blocks (the
  scalar-decay gradient).  Each:
  ``LM.loss`` within 1e-4 relative, every gradient leaf within 1e-3 of
  its max (the embedding, rounded to bf16, within BF16_TOL of its max),
  then one ``build_llcg_round_step`` round (G=2, K=T2_K, S=1; parameters
  within LM_TOL × max(1, max|cpu|), losses 1e-4).  One forward and one
  backward scan launch a scan layer a step, exactly.
- T3, the LLCG round of rwkv6-1.6b uncut (24 layers at full width; an
  OOM fails it), G=2, K=2, S=1, batch 4
  × 128 a machine on ``_local_batches`` / ``_corr_batches``, 3 rounds:
  finite losses, the copies equal after the broadcast, (G·K + S) × 24
  forward and backward scans a round; ms per round and per local step,
  tokens/s, peak memory, the busy share of a fourth, profiled round.
- T4, ``train()`` of rwkv6-1.6b uncut on the card (G=1, K 4, 4, 4):
  finite losses, ``comm`` 2·G·(parameter MB) a round, exact launches, the
  round-3 checkpoint restoring ``params_G[0]``; and the JAX package's
  ``test_system`` run (gemma3-1b smoke) on the card against the CPU,
  losses within 1e-4.

Then the dry run and the sharded steps (``repro_torch.launch.dryrun``):
- DR, started right after the build in a process of its own on the CPU
  (``chip_smoke.py --dryrun``; the traces allocate nothing) and read
  after T4: ``train_4k`` of rwkv6-1.6b, gemma3-1b, zamba2-7b,
  qwen3-moe-30b-a3b, internvl2-2b and hubert-xlarge on the (16, 16) mesh,
  gemma3-1b ``decode_32k`` and rwkv6-1.6b ``long_500k`` on (2, 16, 16),
  each rank 0's program traced at full depth and width on a fake process
  group, every case ``ok``, its per-device GB printed against the card's
  80 GB with its TFLOP, inter / intra-group bytes and roofline terms; the
  three GNN engine cases (0, 1,048,576 and 278,528 all-gather bytes a
  halo exchange, the HaloProgram's); config D's plan on a fake group of
  4, whose halo bytes must equal what phase M2's ranks counted on the
  card; and DW's two cases traced on a fake (2, 2) group.
- DW (``chip_smoke.py --sharded``): the sharded LLCG round on 4 gloo
  ranks sharing the card, ``data`` × ``model`` = DW_MESH, for rwkv6-1.6b
  at full width with T2_LAYERS layers and gemma3-1b with 2 layers
  (batch DW_BATCH × DW_SEQ, K, S, lr DW_LR / DW_SERVER_LR), held to the
  unsharded round run on the card (:func:`_dw_flaws`): each rank's
  gradient of its group's first local step within DW_GRAD_TOL of the
  leaf's largest (the bf16 embedding within BF16_TOL), which no Adam
  update can hide; the round's parameters none beyond 2·(lr·K + slr·S),
  LM_TOL here,
  at most DW_FLIP_SHARE of a leaf's elements beyond DW_TOL +
  DW_TOL·|unsharded| (DW_TOL a fifth of DW_LR, as the CPU test's), and
  the two rounds' updates within DW_UPDATE_TOL of each other in norm; its
  losses within 1e-4, its counted collective bytes equal to DR's trace of
  the same case, its scan launches exact ((K + S) × scan layers, forward
  and gradient).

With ``--baseline DIR`` (DIR: the root of an unpacked earlier commit, its
``src/repro_torch`` beside this script's), a last phase times the quantize,
dequantize and edge-softmax wrappers of both packages at phase 2's shapes,
and ``comm.compress.decompress_tree`` on config C's round table, each
package in a process of its own, in turns: earlier, this, this, earlier.

Prints the card (``nvidia-smi`` name and power limit) and one JSON line of
per-kernel numbers (with the paths on which no kernel launched), then
``{"ok": true, "device": {...}}`` as the last line.
Exits non-zero without a result when no GPU is visible or when the
``src/repro_torch`` package is not beside this script.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores.  Both kernels compute in f32.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

ROUNDS = 3
# round time: the least wall time of this many runs of each length
TIMING_REPS = 3
# kernel vs plain version on the card: both f32, summed in another order
SPMM_TOL = 1e-4          # × max(1, max|plain|): sums of ≤ max-degree terms
ESM_TOL = 1e-5           # absolute: weights ≤ 1 on unit-scale values
# quantize/dequantize: correctly rounded divisions and an order-independent
# max on both sides, so kernel and plain version are bit-equal
QUANT_TOL = 0.0
# the card's run vs the CPU run of the same plan: f32 in another order,
# compounded over 3 rounds of Adam steps
TRAJ_RTOL = 1e-3
# linear scan kernel vs plain version: f32 summed in another order (the scan
# tolerance of tests/test_kernels.py), × max(1, max|plain|)
SCAN_TOL = 2e-4
# config E2, the card's f32 LM vs the CPU's: f32 in another order over 24
# layers, × max(1, max|cpu|)
LM_TOL = 1e-3
# phase K, default mode: two runs of config C on the card, resumed or not,
# differ through index_add_'s atomics, and an int8 rounding the noise flips
# moves the parameters by a discrete step; the largest distance read on the
# card is 6.156e-3 (PERF.md, phase K), this leaves room above it
K_DEFAULT_LIMIT = 1e-2
E_SEED = 0
# config F3: a degree-skewed R-MAT graph (8,933 of its nodes have no edge)
F3_NODES = 16384
F3_EDGES = 32768
# phase P: rounds of each paper-runner call
P_ROUNDS = 3
# phase S: requests of S1 (half at full width, half at fanout 10), the
# correction steps of S2, and the served logits' tolerance against the CPU
# (f32 in another order over two layers), × max(1, max|cpu|)
S_REQUESTS = 64
S2_STEPS = 2
SERVE_TOL = 1e-4
E_PROMPTS = (192,) * 4 + (77,) * 4
E_NEW_TOKENS = 32
E_DECODE_STEPS = 4
# config Z: zamba2-7b served with E's requests; Z3's prefill lengths
Z_SEED = 0
Z_MAX_SEQ = 256
Z3_LENGTHS = (76, 128)
# config G: gemma3-1b uncut; its 640-token prompts outrun the 512-token
# window, so every ring cache wraps in prefill and again in decode
G_SEED = 0
G_PROMPTS = (640,) * 4 + (77,) * 4
G_MAX_SEQ = 1024
# config H: h2o-danube-3-4b uncut, E's requests; config SC: starcoder2-15b
# at full width cut to this many layers
H_SEED = 0
H_MAX_SEQ = 256
SC_LAYERS = 2
# the contract's limit for the whole script (the build included), of which
# it aims to use half; uncut (Q 24 layers, T2's zamba2 5 Mamba2 blocks) the
# script took 1056 s, 88% of it, so those two are cut in depth
SCRIPT_LIMIT_S = 1200
# config Q: qwen2-moe-a2.7b at full width cut to Q_LAYERS of its 24
# layers (uncut it took ~106 s of SCRIPT_LIMIT_S), E's requests; Q3 and QW
# (qwen3-moe at full width) keep MOE_LAYERS layers
Q_SEED = 0
Q_LAYERS = 6
Q_MAX_SEQ = 256
MOE_LAYERS = 2
# MoE routing, card against CPU: the router probabilities differ by ~1e-7
# (f32 products over d_model in another order), so a token may take
# another expert on the card only where the CPU's k-th and (k+1)-th
# probabilities lie within this, a hundred times that difference
ROUTE_TIE = 1e-5
# config V: internvl2-2b uncut, E's requests after its 256 patch tokens:
# 256 + 256 (the 192-token prompts' pow2 bucket) + 32 new fits in 512
V_SEED = 0
V_MAX_SEQ = 512
# what is computed in bf16 on both sides (a frontend's projection in a
# bfloat16 config, hubert's whole stream) differs by bf16 roundings: the
# bf16 parity rule, × max(1, max|cpu|)
BF16_TOL = 2e-2
# config HB: hubert-xlarge uncut, 4 clips of 10 s at 50 frames/s, in its
# bfloat16 config (the audio stream has no √d scale to promote it); the
# CPU side of the layer-by-layer check takes one clip (its time)
HB_SEED = 0
HB_CLIPS = 4
HB_FRAMES = 500
HB_MASK = 0.08
# LM training (T2-T4): rwkv6-1.6b's trainer, the defaults of TrainConfig
T_SEED = 0
T_LR, T_SERVER_LR = 3e-4, 1e-4
T_SEQ = 128
T2_LAYERS = 2            # rwkv6-1.6b at full width, as SC and QW are cut
# zamba2-7b's Mamba2 blocks in T2 (its unit has 5; the CPU's round of the
# whole unit took 96 s, cut in depth for SCRIPT_LIMIT_S)
T2_MAMBA_LAYERS = 2
T3_G, T3_K, T3_S = 2, 2, 1
# local steps of T2's round: two, so the round takes Adam's second,
# bias-corrected local step
T2_K = 2
T3_BATCH = 4             # per machine; the correction batch is twice this
T3_ROUNDS = 3
T_LOSS_TOL = 1e-4        # card vs CPU, relative
# The gradient leaves that cross a bfloat16 cast in a bfloat16 config: the
# embedding's rows are rounded to bf16 before the f32 stream
# (LM._embed_tokens), so their gradient is rounded there too, one bf16 ulp
# (up to 7.8e-3 of the leaf's max) wherever card and CPU round either side;
# held to BF16_TOL, every other leaf (f32 throughout) to LM_TOL
T2_BF16_LEAVES = ("embed",)
RWKV6_CHUNK = 8          # models/transformer/rwkv6.py's _CHUNK
# phase DR: the dry run's cases traced at full depth and width on fake
# process groups of 256 / 512 ranks (arch, shape, multi-pod)
DR_CASES = (("rwkv6-1.6b", "train_4k", False),
            ("gemma3-1b", "train_4k", False),
            ("zamba2-7b", "train_4k", False),
            ("qwen3-moe-30b-a3b", "train_4k", False),
            ("internvl2-2b", "train_4k", False),
            ("hubert-xlarge", "train_4k", False),
            ("gemma3-1b", "decode_32k", True),
            ("rwkv6-1.6b", "long_500k", True))
DR_GNN = (("local", "none", 0), ("halo", "none", 1_048_576),
          ("halo", "int8", 278_528))
DR_LIMIT_S = 900         # the DR child's wall limit (it overlaps the rest)
CARD_GB = 80.0
# phase DW: the sharded LLCG round on 4 gloo ranks sharing the card,
# data × model = (2, 2).  An Adam first-step sign flip moves an element by
# at most 2·(lr·K + slr·S), which these rates make LM_TOL; DW_TOL is the
# CPU test's elementwise tolerance, a fifth of lr.  On the card rwkv6's
# first-step gradients, sharded and unsharded, differ by up to 1.2e-3 of a
# leaf's max (the scan kernels launched on half the heads round otherwise;
# gemma3's, without a scan, by 2e-6), so elements whose gradient lies
# below that may flip, beyond the CPU test's floor: the share of elements
# beyond DW_TOL and the norm of the update's difference bound the flips
# instead.  A missing all-reduce moves most of a leaf (on the CPU at
# these rates: 86-89% of its elements beyond DW_TOL, the update off by
# 1.1-1.3 of its norm, the gradients by 1.3-3.0 of their max)
DW_MESH = (2, 2)
DW_BATCH = 4             # a correction step's rows; a group's local step 2
DW_SEQ = 128
DW_K, DW_S = 2, 1
DW_LR, DW_SERVER_LR = 2e-4, 1e-4
DW_TOL = DW_LR / 5
DW_GRAD_TOL = 1e-2       # a first-step gradient, of its leaf's max
DW_FLIP_SHARE = 1e-2     # of a leaf's elements beyond DW_TOL
DW_UPDATE_TOL = 0.2      # |update - unsharded update| / |unsharded update|


class SmokeFailure(Exception):
    pass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _time_ms(fn, iters: int = 20, warmup: int = 10) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls, by
    CUDA events, after ``warmup`` calls (the host's first calls of a path
    run slower)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int = 20, warmup: int = 1) -> float:
    """Device time per launch: ``iters`` launches captured in one CUDA graph
    and replayed, so the host's launch cost drops out of the timing."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(warmup):                     # warm-up off the graph
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return _time_ms(graph.replay, iters=5, warmup=1) / iters


def _bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------
def _spmm_plain(indptr, indices, values, h, max_floats: int = 2**28):
    """The plain SpMM over blocks of rows, each gathering at most
    ``max_floats`` floats (one block at the small shapes), so the plain
    version fits the card at the benchmark graph's size."""
    import numpy as np
    import torch
    from repro_torch.kernels.ref import spmm_csr_ref

    ptr = indptr.cpu().numpy().astype(np.int64)
    n, d = h.shape
    per_block = max(1, max_floats // max(1, d))
    blocks, r0 = [], 0
    while r0 < n:
        r1 = max(r0 + 1, int(np.searchsorted(ptr, ptr[r0] + per_block,
                                              "right")) - 1)
        r1 = min(r1, n)
        lo, hi = int(ptr[r0]), int(ptr[r1])
        blocks.append(spmm_csr_ref(indptr[r0:r1 + 1] - lo, indices[lo:hi],
                                   values[lo:hi], h))
        r0 = r1
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks)


def _spmm_case(graph, d: int, label: str, seed: int) -> dict:
    """The CSR SpMM against its plain version and ``torch.sparse.mm`` on
    the unnormalized adjacency of ``graph`` at width ``d``, under the
    column split :func:`slab_plan` picks (its passes counted)."""
    import numpy as np
    import torch
    from repro_torch.kernels.ops import csr_device_operands
    from repro_torch.kernels.spmm import slab_plan, spmm_csr

    indptr, indices, values, items = csr_device_operands(
        graph, "cuda", normalization="none")
    n, nnz = graph.num_nodes, graph.num_edges
    h = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, d)).astype(np.float32)).cuda()
    plan = slab_plan(n, d, h.data_ptr())
    kernel = lambda: spmm_csr(indptr, indices, values, h, items)
    plain = lambda: _spmm_plain(indptr, indices, values, h)
    passes = spmm_csr.slab_passes
    out, ref = kernel(), plain()
    _check(spmm_csr.slab_passes - passes == plan.slabs,
           f"spmm_csr {label} D={d}: {spmm_csr.slab_passes - passes} slab "
           f"passes counted, the plan makes {plan.slabs}")
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    tol = SPMM_TOL * max(1.0, float(ref.abs().max()))
    _check(math.isfinite(err) and err <= tol,
           f"spmm_csr {label} D={d}: max |kernel - plain| {err} > {tol}")
    a = torch.sparse_csr_tensor(                  # the library yardstick
        indptr.long(), indices.long(), values, size=(n, n),
        check_invariants=True)
    library = lambda: torch.sparse.mm(a, h)
    lib_err = float((library() - ref).abs().max())
    _check(lib_err <= tol, f"library yardstick disagrees: {lib_err}")
    del out, ref
    try:                    # the yardstick's device time, where it captures
        library_device_ms = _graph_ms(library)
        library_device = "CUDA-graph replay"
    except RuntimeError as e:
        library_device_ms = None
        library_device = f"not captured: {str(e)[:120]}"
    # the work, whatever the format: indptr, indices and values once, H read
    # once, out written once; an FMA per nonzero and column
    nbytes = 4 * (n + 1) + 8 * nnz + 4 * n * d + 4 * n * d
    bound_ms, bound_by = _bound(nbytes, 2.0 * nnz * d)
    deg = graph.degrees()
    return {"label": label, "shape": f"N {n}, nnz {nnz}, D {d}, max degree "
            f"{int(deg.max())}, work items "
            f"{n if items is None else items.shape[1]}",
            "plan": plan._asdict(),
            "max_abs_err": err, "tol": tol,
            "ms": _time_ms(kernel), "device_ms": _graph_ms(kernel),
            "plain_ms": _time_ms(plain, iters=5, warmup=1),
            "library_ms": _time_ms(library),
            "library_device_ms": library_device_ms,
            "library_device": library_device,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes_gathered": 4 * nnz * d}


def _cell_graph():
    """The LLCG benchmark cell's graph (``llcg_bench/configs/
    reddit-sage.json``: 232,965 rows, ~23.2 M stored entries, a few rows
    above the row split), drawn on the card."""
    import numpy as np
    from llcg_bench.sbm import sbm
    from repro_torch.graph.csr import CSRGraph

    g = json.loads((ROOT / "llcg_bench" / "configs" / "reddit-sage.json")
                   .read_text())["graph"]
    cell = sbm(g["num_nodes"], g["num_classes"], 1, g["avg_degree"],
               g["homophily"], g["feature_snr"], g["structure_seed"], "cuda")
    return CSRGraph(cell.indptr.astype(np.int32),
                    cell.indices.astype(np.int32), cell.num_nodes)


def _pack_case(n: int, d: int, seed: int) -> dict:
    """The SpMM's pack kernel (H into its slab-major copy) against its
    plain version, bit for bit, at (n, d)."""
    import numpy as np
    import torch
    from repro_torch.kernels.ref import pack_slabs_ref
    from repro_torch.kernels.spmm import SLAB_WIDTH, pack_slabs

    h = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, d)).astype(np.float32)).cuda()
    slabs = -(-d // SLAB_WIDTH)
    kernel = lambda: pack_slabs(h, slabs)
    plain = lambda: pack_slabs_ref(h, SLAB_WIDTH, slabs)
    _check(torch.equal(kernel(), plain()),
           f"spmm_csr pack ({n}, {d}) differs from its plain version")
    nbytes = 4 * n * d + 4 * n * slabs * SLAB_WIDTH     # H read, copy written
    bound_ms, bound_by = _bound(nbytes, 0.0)
    return {"label": "cell pack", "shape": f"N {n}, D {d}, slabs {slabs}",
            "bit_equal": True, "ms": _time_ms(kernel),
            "device_ms": _graph_ms(kernel),
            "plain_ms": _time_ms(plain, iters=5, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by}


def _hub_graph(base, hubs: int = 16, fan: int = 4096, seed: int = 2):
    """``base`` plus ``hubs`` nodes, each joined symmetrically to ``fan``
    random nodes: the degree-skewed SpMM case."""
    import numpy as np
    from repro_torch.graph.csr import CSRGraph

    rng = np.random.default_rng(seed)
    n = base.num_nodes + hubs
    src, dst = base.to_edges()
    hub_src = np.repeat(np.arange(base.num_nodes, n), fan)
    hub_dst = np.concatenate([rng.choice(base.num_nodes, fan, replace=False)
                              for _ in range(hubs)])
    return CSRGraph.from_edges(n, np.concatenate([src, hub_src]),
                               np.concatenate([dst, hub_dst]))


def _quant_inputs(r: int, c: int, with_u: bool, seed: int) -> tuple:
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((r, c)) * 3.0).astype(
        np.float32)).cuda()
    u = (torch.from_numpy(rng.random((r, c)).astype(np.float32)).cuda()
         if with_u else None)
    return x, u


def _esm_inputs(n: int, f: int, d: int, seed: int) -> tuple:
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    scores = torch.from_numpy(rng.standard_normal((n, f)).astype(
        np.float32)).cuda()
    mask = torch.from_numpy((rng.random((n, f)) < 0.7).astype(
        np.float32)).cuda()
    mask[: max(1, n // 64)] = 0.0                 # fully masked rows
    vals = torch.from_numpy(rng.standard_normal((n, f, d)).astype(
        np.float32)).cuda()
    return scores, mask, vals


def _esm_case(n: int, f: int, d: int, label: str, seed: int) -> dict:
    import torch
    from repro_torch.kernels.edge_softmax import edge_softmax
    from repro_torch.kernels.ref import edge_softmax_ref

    scores, mask, vals = _esm_inputs(n, f, d, seed)
    out = edge_softmax(scores, mask, vals)
    ref = edge_softmax_ref(scores, mask, vals)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    _check(math.isfinite(err) and err <= ESM_TOL,
           f"edge_softmax {label} ({n},{f},{d}): max |kernel - plain| "
           f"{err} > {ESM_TOL}")
    _check(float(out[: max(1, n // 64)].abs().max()) == 0.0,
           "edge_softmax: a fully masked row is not 0")
    nbytes = 4 * (2 * n * f + n * f * d + n * d)
    bound_ms, bound_by = _bound(nbytes, n * f * (2.0 * d + 5))
    return {"label": label, "shape": f"({n}, {f}, {d})", "max_abs_err": err,
            "tol": ESM_TOL,
            "ms": _time_ms(lambda: edge_softmax(scores, mask, vals)),
            "device_ms": _graph_ms(lambda: edge_softmax(scores, mask, vals)),
            "plain_ms": _time_ms(lambda: edge_softmax_ref(scores, mask,
                                                          vals)),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


def _quant_case(r: int, c: int, with_u: bool, label: str,
                seed: int) -> tuple:
    """Quantize then dequantize ``(r, c)`` rows on the card, bit-compared
    with the plain versions; one result row per kernel."""
    import torch
    from repro_torch.kernels.quantize import dequantize_rows, quantize_rows
    from repro_torch.kernels.ref import (dequantize_int8_rows_ref,
                                         quantize_int8_rows_ref)

    x, u = _quant_inputs(r, c, with_u, seed)
    q, s = quantize_rows(x, u)
    deq = dequantize_rows(q, s)
    qr, sr = quantize_int8_rows_ref(x, u)
    dr = dequantize_int8_rows_ref(qr, sr)
    torch.cuda.synchronize()
    q_err = float((q.int() - qr.int()).abs().max())
    s_err = float((s - sr).abs().max())
    d_err = float((deq - dr).abs().max())
    name = f"({r}, {c}) {'u' if with_u else 'u=None'} {label}"
    _check(q_err <= QUANT_TOL and s_err <= QUANT_TOL,
           f"quantize_rows {name}: q differs by {q_err}, scale by {s_err}")
    _check(d_err <= QUANT_TOL, f"dequantize_rows {name}: differs by {d_err}")
    # the library yardstick: int8 times f32 promotes to f32, one exact
    # conversion and one multiply, as the plain version
    library = lambda: torch.mul(q, s)
    _check(torch.equal(library(), dr), f"torch.mul disagrees at {name}")
    n = r * c
    rows = []
    for kernel, fn, plain, nbytes, ops, err, lib in (
            ("quantize_rows", lambda: quantize_rows(x, u),
             lambda: quantize_int8_rows_ref(x, u),
             n * (4 + (4 if with_u else 0) + 1) + 4 * r, 6.0 * n,
             max(q_err, s_err), None),
            ("dequantize_rows", lambda: dequantize_rows(q, s),
             lambda: dequantize_int8_rows_ref(q, s), n * (1 + 4) + 4 * r,
             2.0 * n, d_err, library)):
        bound_ms, bound_by = _bound(nbytes, ops)
        rows.append({"kernel": kernel, "label": label, "shape": name,
                     "max_abs_err": err, "tol": QUANT_TOL,
                     "ms": _time_ms(fn), "device_ms": _graph_ms(fn),
                     "plain_ms": _time_ms(plain),
                     "library_ms": None if lib is None else _time_ms(lib),
                     "library_device_ms": (None if lib is None
                                           else _graph_ms(lib)),
                     "bound_ms": bound_ms, "bound_by": bound_by})
    return tuple(rows)


def _grouped_case(label: str, qs: list, ss: list) -> dict:
    """The grouped dequantize over the segments ``(qs[i], ss[i])``: each
    result bit-equal to the plain version, exactly one launch per
    ``MAX_SEGMENTS`` non-empty segments; timed against the plain version
    per segment and ``torch._foreach_mul``, one PyTorch call that computes
    the same list."""
    import torch
    from repro_torch.kernels.quantize import (MAX_SEGMENTS, dequantize_rows,
                                              dequantize_rows_many)
    from repro_torch.kernels.ref import dequantize_int8_rows_ref

    shapes = [tuple(q.shape) for q in qs]
    want = -(-sum(1 for r, c in shapes if r * c) // MAX_SEGMENTS)
    before = dequantize_rows.launches
    outs = dequantize_rows_many(qs, ss)
    launches = dequantize_rows.launches - before
    plain = lambda: [dequantize_int8_rows_ref(q, s) for q, s in zip(qs, ss)]
    refs = plain()
    torch.cuda.synchronize()
    _check(launches == want, f"dequantize_rows_many {label}: {launches} "
           f"launches, not {want}")
    err = 0.0
    for q, out, ref in zip(qs, outs, refs):
        _check(out.shape == q.shape and out.is_contiguous(),
               f"dequantize_rows_many {label}: a result is not a "
               f"contiguous {tuple(q.shape)}")
        if out.numel():
            err = max(err, float((out - ref).abs().max()))
    _check(err <= QUANT_TOL, f"dequantize_rows_many {label}: differs by "
           f"{err}")
    library = lambda: torch._foreach_mul(qs, ss)
    _check(all(torch.equal(a, b) for a, b in zip(library(), refs)),
           f"torch._foreach_mul disagrees at {label}")
    fn = lambda: dequantize_rows_many(qs, ss)
    n, r = sum(q.numel() for q in qs), sum(q.shape[0] for q in qs)
    bound_ms, bound_by = _bound(n * (1 + 4) + 4 * r, 2.0 * n)
    return {"kernel": "dequantize_rows", "label": label,
            "shape": f"{len(shapes)} segments {shapes[:6]}"
                     f"{'...' if len(shapes) > 6 else ''}, {n} values",
            "launches": launches, "max_abs_err": err, "tol": QUANT_TOL,
            "ms": _time_ms(fn), "device_ms": _graph_ms(fn),
            "plain_ms": _time_ms(plain), "library_ms": _time_ms(library),
            "library_device_ms": _graph_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by}


def _grouped_cases(round_table: list) -> list:
    """The grouped dequantize's phase-2 cases: config C's round table (the
    quantize outputs of its 13 leaves), rows of 1, 8, 17 and 33 values, an
    unaligned and a non-contiguous view, empty segments, and more segments
    than one launch's table holds."""
    import numpy as np
    import torch
    rng = np.random.default_rng(50)

    def operands(shapes):
        qs = [torch.from_numpy(rng.integers(-127, 128, (r, c)).astype(
            np.int8)).cuda() for r, c in shapes]
        ss = [torch.from_numpy((rng.random((r, 1)) * 3e-2 + 1e-9).astype(
            np.float32)).cuda() for r, _ in shapes]
        return qs, ss

    cases = [_grouped_case("C round", *map(list, zip(*round_table)))]
    cases.append(_grouped_case("awkward", *operands(
        [(8, 1), (8, 8), (8, 17), (8, 33), (800, 17), (5, 1)])))
    qs, ss = operands([(8, 4097), (1, 4096), (3, 33)])
    odd = torch.cat([qs[2].new_zeros(1), qs[2].flatten()])[1:].view(3, 33)
    _check(odd.data_ptr() % 16 != 0, "the offset view is aligned")
    cases.append(_grouped_case("unaligned",
                               [qs[0][:, 1:], qs[1][:, 1:], odd], ss))
    cases.append(_grouped_case("empty", *operands(
        [(0, 64), (8, 64), (3, 0), (0, 0), (8, 8)])))
    cases.append(_grouped_case("split", *operands(
        [(8, 8 + 24 * i) for i in range(40)])))
    return cases


def _scan_ops(bh: int, t: int, chunk: int, dk: int, dv: int, strict: bool,
              with_h0: bool, scalar: bool = False) -> float:
    """Operations the scan needs on this run's inputs: per head and chunk of
    l real steps (the last chunk cut to its length), the masked products
    q~k~ᵀ and A·V over the l(l+1)/2 kept pairs (l(l−1)/2 when strict), the
    inter-chunk read q~·h_in (none in the first chunk when h0 is zero), the
    state update (k~P_L)ᵀV, 2-3 exponentials per (step, key) element and
    the strict bonus, as multiply-adds counted twice.  ``scalar``: the
    scalar-decay mode's exponentials instead, one per kept pair and two
    per step."""
    total = 0.0
    for c0 in range(0, t, chunk):
        ln = min(chunk, t - c0)
        pairs = ln * (ln - 1) // 2 if strict else ln * (ln + 1) // 2
        total += 2.0 * pairs * (dk + dv) + 2.0 * ln * dk * dv
        if c0 or with_h0:
            total += 2.0 * ln * dk * dv
        if scalar:
            total += pairs + 2 * ln
        else:
            total += (3 if strict else 2) * ln * dk
        if strict:
            total += 2.0 * ln * (dk + dv)
    return bh * total


def _scan_case(bh: int, t: int, d: int, strict: bool, with_h0: bool,
               label: str, seed: int, chunk: int = 64,
               scalar_decay: float = 0.0) -> dict:
    """``ops.linear_scan`` (the kernel; a ragged T masked inside it) vs the
    plain chunked form on the card; dk = dv = ``d``.  A ragged case also
    times the kernel alone on inputs padded to whole chunks.

    ``scalar_decay`` > 0: the scalar-decay mode (Mamba2's), log_w (BH, T)
    of −``scalar_decay`` per step (below 1: −``scalar_decay``·U(0, 1)),
    held against its plain segsum form and against the one-token
    recurrence ``scan_decode_step`` replayed step by step; where a chunk's
    summed |log_w| passes ~88.7 the factored form, fed the same decay
    broadcast over dk, must be the one that is not finite."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.linear_scan import linear_scan_chunked
    from repro_torch.kernels.ref import (chunked_scan_ref,
                                         chunked_scan_scalar_ref)
    from repro_torch.models.transformer.scan_common import scan_decode_step

    scalar = scalar_decay > 0
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).cuda()
    q, k, v = f(bh, t, d), f(bh, t, d), f(bh, t, d)
    if not scalar:
        lw = torch.from_numpy((-0.15 * rng.random((bh, t, d))).astype(
            np.float32)).cuda()
    elif scalar_decay < 1:
        lw = torch.from_numpy((-scalar_decay * rng.random((bh, t))).astype(
            np.float32)).cuda()
    else:
        lw = torch.full((bh, t), -scalar_decay, device="cuda")
    h0 = f(bh, d, d) if with_h0 else None
    u = f(bh, d) * 0.3 if strict else None
    pad = -t % chunk
    padded = [torch.nn.functional.pad(x, (0, 0, 0, pad))
              for x in (q, k, v)]
    padded.append(torch.nn.functional.pad(
        lw, (0, pad) if scalar else (0, 0, 0, pad)))

    def kernel():
        return ops.linear_scan(q, k, v, lw, h0, chunk=chunk, strict=strict,
                               u=u)

    def kernel_alone():
        return linear_scan_chunked(*padded, h0, u=u, chunk=chunk,
                                   strict=strict)

    def plain():
        if scalar:
            y, h = chunked_scan_scalar_ref(*padded, h0, chunk=chunk)
        else:
            y, h = chunked_scan_ref(*padded, h0, chunk=chunk, strict=strict,
                                    u=u)
        return y[:, :t], h

    (y, h), (y_r, h_r) = kernel(), plain()
    torch.cuda.synchronize()
    err = max(float((y - y_r).abs().max()), float((h - h_r).abs().max()))
    tol = SCAN_TOL * max(1.0, float(y_r.abs().max()), float(h_r.abs().max()))
    name = (f"{'strict' if strict else 'plain'}"
            f"{' scalar-decay' if scalar else ''} BH={bh} T={t} dk=dv={d} "
            f"L={chunk}{' h0' if with_h0 else ''}"
            f"{f' log_w -{scalar_decay}' if scalar else ''}")
    _check(math.isfinite(err) and err <= tol,
           f"linear_scan {name}: max |kernel - plain| {err} > {tol}")
    case = {"label": label, "shape": name, "max_abs_err": err, "tol": tol}
    if scalar:
        hs = torch.zeros(bh, d, d, device="cuda") if h0 is None else h0
        ys = []
        for i in range(t):
            y_i, hs = scan_decode_step(q[:, i], k[:, i], v[:, i],
                                       lw[:, i, None].expand(bh, d), hs)
            ys.append(y_i)
        y_s = torch.stack(ys, dim=1)
        err_s = max(float((y - y_s).abs().max()),
                    float((h - hs).abs().max()))
        tol_s = SCAN_TOL * max(1.0, float(y_s.abs().max()),
                               float(hs.abs().max()))
        _check(math.isfinite(err_s) and err_s <= tol_s,
               f"linear_scan {name}: max |kernel - sequential| {err_s} > "
               f"{tol_s}")
        y_f, _ = chunked_scan_ref(*padded[:3],
                                  padded[3][..., None].expand(-1, -1, d), h0,
                                  chunk=chunk)
        factored_finite = bool(torch.isfinite(y_f).all())
        _check(factored_finite is (scalar_decay * chunk < 88.7),
               f"linear_scan {name}: the factored form is "
               f"{'' if factored_finite else 'not '}finite")
        case.update(max_abs_err_sequential=err_s, tol_sequential=tol_s,
                    factored_form_finite=factored_finite)
    # each input read once, each output written once, at the real T
    nbytes = 4 * (bh * t * (4 * d + (1 if scalar else d))
                  + bh * d * d * (2 if with_h0 else 1)
                  + (bh * d if strict else 0))
    bound_ms, bound_by = _bound(
        nbytes, _scan_ops(bh, t, chunk, d, d, strict, with_h0, scalar))
    case.update({"ms": _time_ms(kernel), "device_ms": _graph_ms(kernel),
                 "plain_ms": _time_ms(plain), "library_ms": None,
                 "bound_ms": bound_ms, "bound_by": bound_by})
    if pad:
        case.update(padded_to=t + pad,
                    kernel_alone_ms=_time_ms(kernel_alone),
                    kernel_alone_device_ms=_graph_ms(kernel_alone))
    return case


def _csr_case(graph, label: str, seed: int, d: int = 64,
              iters: int = 20) -> dict:
    """The ``csr`` layout's aggregates (plain PyTorch: ``index_add`` and
    ``scatter_reduce``, no kernel of their own) against the routes of the
    ``bcsr_kernel`` layout at the same shapes: mean aggregation against
    the SpMM (``bcsr_mean_aggregate``), the GAT softmax-aggregate from
    (z, scores) against the padded table through the fused edge-softmax
    op.  Forward and forward + backward, eager and CUDA-graph replay; each
    csr result held against the kernel route's."""
    import numpy as np
    import torch
    from repro_torch.graph.csr import build_neighbor_table
    from repro_torch.kernels.ops import edge_softmax_aggregate_trainable
    from repro_torch.models.gnn import agg
    from repro_torch.models.gnn.layers import _gather

    edges = agg.edge_operands(graph, device="cuda")
    spmm_ops = agg.bcsr_operands(graph, "cuda")
    table, mask = (torch.from_numpy(a).cuda()
                   for a in build_neighbor_table(graph))
    n, e = graph.num_nodes, graph.num_edges
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).cuda()
    h, z, src, dst = f(n, d), f(n, d), f(n), f(n)
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(
        np.float32)).cuda()

    def fused_gat(z, src, dst):
        # the GAT layer's fused route: index_select gathers (an index_add
        # backward), scores, then the edge-softmax op
        e_ = torch.nn.functional.leaky_relu(
            src[:, None] + _gather(dst[None], table[None])[0], 0.2)
        return edge_softmax_aggregate_trainable(
            e_, mask, _gather(z[None], table[None])[0])

    routes = {
        "mean csr": (lambda h: agg.csr_mean_aggregate(h, edges), (h,)),
        "mean spmm": (lambda h: agg.bcsr_mean_aggregate(h, spmm_ops), (h,)),
        "gat csr": (lambda z, s, t: agg.csr_gat_aggregate(z, s, t, edges),
                    (z, src, dst)),
        "gat fused": (fused_gat, (z, src, dst)),
    }
    outs = {name: fn(*args) for name, (fn, args) in routes.items()}
    torch.cuda.synchronize()
    errs = {}
    for op in ("mean", "gat"):
        ref = outs[f"{op} {'spmm' if op == 'mean' else 'fused'}"]
        err = float((outs[f"{op} csr"] - ref).abs().max())
        tol = SPMM_TOL * max(1.0, float(ref.abs().max()))
        _check(math.isfinite(err) and err <= tol, f"csr {op} {label}: max "
               f"|csr - kernel route| {err} > {tol}")
        errs[op] = err
    times = {}
    for name, (fn, args) in routes.items():
        fwd = lambda: fn(*args)

        def both():
            # fresh leaves on the calling stream: a leaf used before on
            # another stream would tie the captured backward to that stream
            xs = [a.detach().requires_grad_(True) for a in args]
            return torch.autograd.grad(fn(*xs), xs, g)
        times[name] = {
            "fwd_ms": _time_ms(fwd, iters=iters, warmup=min(10, iters)),
            "fwd_device_ms": _graph_ms(fwd, iters=iters),
            "fwd_bwd_ms": _time_ms(both, iters=iters,
                                   warmup=min(10, iters)),
            "fwd_bwd_device_ms": _graph_ms(both, iters=iters, warmup=3)}
    # the csr mean's work: seg, nbr (int64) and the weight per edge, h read
    # and out written once; an FMA per edge and column
    bound_ms, bound_by = _bound(20 * e + 8 * n * d, 2.0 * e * d)
    deg = graph.degrees()
    return {"label": label, "shape": f"N {n}, E {e}, D {d}, max degree "
            f"{int(deg.max())}, zero-degree rows {int((deg == 0).sum())}",
            "max_abs_err": errs, "tol_rel": SPMM_TOL, "times": times,
            "mean_csr_bound_ms": bound_ms, "bound_by": bound_by}


def _wrapper_times(src: str, cases: dict) -> dict:
    """Eager and CUDA-graph ms per call of the quantize, dequantize and
    edge-softmax wrappers of the ``repro_torch`` package under ``src``, at
    ``cases["quant"]`` ((r, c, with_u) triples) and ``cases["esm"]`` ((n,
    f, d) triples), on the inputs phase 2 draws for them, and of its
    ``decompress_tree`` on ``cases["tree"]`` (machines, leaf sizes)."""
    import torch
    sys.path.insert(0, src)
    from repro_torch.kernels.edge_softmax import edge_softmax
    from repro_torch.kernels.quantize import dequantize_rows, quantize_rows

    times = {}

    def timed(name, fn):
        # eager: the host's cost per call, the least of 5 windows of 50
        # calls (a shared host's other work only ever adds to a window)
        times[name] = {"ms": min(_time_ms(fn, iters=50) for _ in range(5)),
                       "device_ms": _graph_ms(fn)}

    for r, c, with_u in cases["quant"]:
        x, u = _quant_inputs(r, c, with_u, 0)
        q, s = quantize_rows(x, u)
        shape = f"({r}, {c}) {'u' if with_u else 'u=None'}"
        timed(f"quantize_rows {shape}", lambda: quantize_rows(x, u))
        timed(f"dequantize_rows {shape}", lambda: dequantize_rows(q, s))
    for n, f, d in cases["esm"]:
        scores, mask, vals = _esm_inputs(n, f, d, 0)
        timed(f"edge_softmax ({n}, {f}, {d})",
              lambda: edge_softmax(scores, mask, vals))
    # config C's round: the 13 leaves' (machines, numel) payloads
    from repro_torch.comm.compress import decompress_tree
    machines, sizes = cases["tree"]
    payload, scales = {}, {}
    for i, c in enumerate(sizes):
        x, u = _quant_inputs(machines, c, True, 60 + i)
        payload[f"leaf{i:02d}"], scales[f"leaf{i:02d}"] = quantize_rows(x, u)
    timed(f"decompress_tree C round ({len(sizes)} leaves)",
          lambda: decompress_tree(payload, scales, "int8_ef"))
    torch.cuda.synchronize()
    return times


def _compare(baseline: pathlib.Path, cases: dict) -> None:
    """The wrappers of the package under ``baseline/src`` against this
    checkout's, each timed in a process of its own, in turns: earlier,
    this, this, earlier.  Prints one JSON line per turn and one per call
    shape with the four device and eager times."""
    turns = []
    for which in ("baseline", "this", "this", "baseline"):
        src = baseline / "src" if which == "baseline" else ROOT / "src"
        run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                              "--wrapper-times", str(src),
                              json.dumps(cases)],
                             capture_output=True, text=True, timeout=600)
        _check(run.returncode == 0, f"timing the {which} wrappers failed: "
               f"{run.stderr[-2000:]}")
        turns.append((which, json.loads(run.stdout.strip().splitlines()[-1])))
        print(f"compare turn {len(turns)} ({which}, {src}): "
              f"{json.dumps(turns[-1][1])}")
    for name in turns[0][1]:
        row = {"call": name}
        for key in ("device_ms", "ms"):
            row[key] = [(which, t[name][key]) for which, t in turns]
        print(f"compare {json.dumps(row)}")


# --------------------------------------------------------------------------
# phase 3: the main path
# --------------------------------------------------------------------------
def _with_comm(plan, **comm):
    return dataclasses.replace(plan,
                               comm=dataclasses.replace(plan.comm, **comm))


def _configs():
    from repro_torch.configs.gnn_datasets import make_paper_setting
    from repro_torch.core.plan import ggs_plan, llcg_plan
    from repro_torch.models.gnn.model import build_model

    data, model_a, cfg = make_paper_setting("reddit")
    cfg = dataclasses.replace(cfg, server_agg_layout="bcsr_kernel",
                              rounds=ROUNDS)
    model_b = build_model("GAT", data.feature_dim, data.num_classes,
                          hidden_dim=64, fused_gat=True)
    plans = {"A": (model_a, llcg_plan(cfg)),
             "B": (model_b, llcg_plan(cfg)),
             "C": (model_a, _with_comm(llcg_plan(cfg),
                                       compression="int8_ef")),
             "D": (model_a, _with_comm(ggs_plan(cfg),
                                       halo_compression="int8"))}
    return data, cfg, plans


def _device_busy_share(run, parts: tuple = ()) -> str:
    """Summed device time of the kernels over the wall time of ``run()``,
    from ``torch.profiler``, with the count of kernels and the five that
    take the most device time, then, for each name in ``parts``, the
    launches and device time of the kernels whose name holds it and their
    share of the device time; "not measured" if it records no device
    time.  The profiler's raw device events are summed here:
    ``key_averages()`` takes tens of seconds on a served run's ~500,000
    events."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        cuda = torch.autograd.DeviceType.CUDA
        device = collections.defaultdict(lambda: [0, 0])  # count, ns
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                device[e.name()][0] += 1
                device[e.name()][1] += e.duration_ns()
    except (RuntimeError, AttributeError) as e:    # tracing unavailable
        return f"not measured ({e})"
    device_ns = sum(ns for _, ns in device.values())
    if device_ns <= 0:
        return "not measured"
    n_events = sum(n for n, _ in device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1][1])[:5]
    top_s = "; ".join(f"{name[:60]} x{n} {ns / 1e6:.3f} ms"
                      for name, (n, ns) in top)
    part_s = ""
    for part in parts:
        n = sum(c for name, (c, _) in device.items() if part in name)
        ns = sum(t for name, (_, t) in device.items() if part in name)
        part_s += (f"; {part} x{n} {ns / 1e6:.3f} ms device, "
                   f"{ns / device_ns:.4f} of it")
    return (f"{device_ns / 1e9 / wall:.4f} ({device_ns / 1e6:.3f} ms device "
            f"in {wall * 1e3:.3f} ms wall, {n_events} device events; top: "
            f"{top_s}){part_s}")


def _drive(name: str, data, model, plan, kernels) -> tuple:
    """Run ``plan`` on the card through ``build_trainer``: launch counts of
    the counted run, round times, busy share, and the gates (finite,
    accounting, agreement with the CPU run).  Returns ``(counts, hist)``."""
    import itertools

    import torch
    from repro_torch.core.plan import RoundSampler, build_trainer, lower_plan
    from repro_torch.kernels.spmm import spmm_csr

    one_round = dataclasses.replace(
        plan, schedule=dataclasses.replace(plan.schedule, rounds=1))

    def timed(p) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        build_trainer(data, model, p).run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # warm-up: loads the built libraries (the host's first calls run slower)
    build_trainer(data, model, one_round).run()
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    spmm_csr.slab_passes = 0
    t0 = time.perf_counter()
    trainer = build_trainer(data, model, plan)        # device "cuda"
    hist = trainer.run()
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    counts = {k.__name__: k.launches for k in kernels}
    slab_passes = spmm_csr.slab_passes
    # steady round time: (least 3-round wall − least 1-round wall) / 2, so
    # set-up (partition, sampling plans, operand builds) drops out
    walls += [timed(plan) for _ in range(TIMING_REPS - 1)]
    walls1 = [timed(one_round) for _ in range(TIMING_REPS)]
    wall, wall1 = min(walls), min(walls1)
    busy = _device_busy_share(lambda: build_trainer(data, model, plan).run())
    # the host layer alone: one round's sampling and its copy to the card
    sampler = RoundSampler(data, model, plan, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for desc in lower_plan(plan):
        sampler.sample(desc)
    torch.cuda.synchronize()
    sample_ms = (time.perf_counter() - t0) / ROUNDS * 1e3
    corr = hist.meta["corr_loss"] or [None] * len(hist.rounds)
    for r in range(len(hist.rounds)):
        print(f"config {name} round {hist.rounds[r]}: steps_cum "
              f"{hist.steps_cum[r]} bytes_cum {hist.bytes_cum[r]} "
              f"train_loss {hist.train_loss[r]} val_f1 {hist.val_score[r]} "
              f"local_loss {hist.meta['local_loss'][r]} corr_loss "
              f"{corr[r]}")
    per_round = (wall - wall1) / (ROUNDS - 1)
    print(f"config {name}: {per_round * 1e3:.3f} ms per round (least run() "
          f"wall of {TIMING_REPS}: {wall:.4f} s for {ROUNDS} rounds, "
          f"{wall1:.4f} s for 1; all: {[round(w, 4) for w in walls]}, "
          f"{[round(w, 4) for w in walls1]}), of which "
          f"sampling (host draw + copy, or the device draw) {sample_ms:.3f} "
          f"ms; launches {counts}; spmm_csr slab passes {slab_passes}; "
          f"device busy {busy} of a profiled run")

    # what comes out: finite, exact accounting, and the CPU run's numbers
    vals = hist.train_loss + hist.meta["local_loss"] + hist.meta["corr_loss"]
    _check(all(math.isfinite(v) for v in vals), f"config {name}: non-finite "
           "loss")
    _check(all(0.0 <= s <= 1.0 for s in hist.val_score),
           f"config {name}: F1 out of range")
    acct = list(itertools.accumulate(row["bytes"]
                                     for row in trainer.accounting()))
    _check(hist.bytes_cum == acct,
           f"config {name}: bytes {hist.bytes_cum} vs accounting {acct}")
    cpu = build_trainer(data, model, plan, device="cpu").run()
    for a, b in zip(vals, cpu.train_loss + cpu.meta["local_loss"]
                    + cpu.meta["corr_loss"]):
        _check(abs(a - b) <= TRAJ_RTOL * max(1.0, abs(b)),
               f"config {name}: GPU loss {a} vs CPU {b}")
    one_node = 1.0 / len(data.val_nodes)
    for a, b in zip(hist.val_score, cpu.val_score):
        _check(abs(a - b) <= one_node + 1e-6,
               f"config {name}: GPU F1 {a} vs CPU {b}")
    _check(hist.steps_cum == cpu.steps_cum
           and hist.bytes_cum == cpu.bytes_cum,
           f"config {name}: accounting differs from the CPU run")
    return counts, hist


def _same_trajectory(label: str, hist, ref, one_node: float) -> None:
    """Gate two runs of the same math: losses within TRAJ_RTOL relative,
    F1 within one eval node, byte and step accounting equal."""
    series = lambda h, key: (h.train_loss if key == "train_loss"
                             else h.meta.get(key, []))
    for key in ("train_loss", "local_loss", "corr_loss"):
        a, b = series(hist, key), series(ref, key)
        _check(len(a) == len(b), f"{label}: {len(a)} {key} values, not "
               f"{len(b)}")
        for x, y in zip(a, b):
            _check(math.isfinite(x) and abs(x - y)
                   <= TRAJ_RTOL * max(1.0, abs(y)),
                   f"{label}: {key} {x} vs {y}")
    for x, y in zip(hist.val_score, ref.val_score):
        _check(abs(x - y) <= one_node + 1e-6, f"{label}: F1 {x} vs {y}")
    _check(hist.bytes_cum == ref.bytes_cum
           and hist.steps_cum == ref.steps_cum,
           f"{label}: accounting {hist.bytes_cum} {hist.steps_cum} vs "
           f"{ref.bytes_cum} {ref.steps_cum}")


def _f3_setting():
    """Config F3: the reddit setting's model and plan on a degree-skewed
    R-MAT graph, where ``server_agg_layout="auto"`` resolves to csr."""
    from repro_torch.graph.datasets import rmat_graph
    from repro_torch.models.gnn.model import build_model
    data = rmat_graph(num_nodes=F3_NODES, num_edges=F3_EDGES,
                      feature_dim=32, num_classes=8, seed=0)
    model = build_model("SBSBS", data.feature_dim, data.num_classes,
                        hidden_dim=64)
    return data, model


def _configs_f(data, cfg, plans, f3, hist_a, kernels) -> dict:
    """Configs F1–F3: the server correction through the ``csr`` layout.
    F1 (config A's plan) must launch no SpMM and follow A's trajectory;
    F2 (config B's GAT, not fused) no edge softmax; F3 resolves ``auto``
    to csr on F3's graph.  Each also passes ``_drive``'s gates."""
    from repro_torch.core.plan import llcg_plan
    from repro_torch.models.gnn.model import build_model

    csr_cfg = dataclasses.replace(cfg, server_agg_layout="csr")
    gat = build_model("GAT", data.feature_dim, data.num_classes,
                      hidden_dim=64)
    f3_data, f3_model = f3
    f3_cfg = dataclasses.replace(cfg, server_agg_layout="auto")
    counts = {}
    counts["F1"], hist_f1 = _drive("F1", data, plans["A"][0],
                                   llcg_plan(csr_cfg), kernels)
    counts["F2"], _ = _drive("F2", data, gat, llcg_plan(csr_cfg), kernels)
    counts["F3"], hist_f3 = _drive("F3", f3_data, f3_model,
                                   llcg_plan(f3_cfg), kernels)
    _check(hist_f1.meta["corr_agg_layout"] == "csr",
           f"config F1 ran {hist_f1.meta['corr_agg_layout']}")
    _check(counts["F1"]["spmm_csr"] == 0, f"config F1 launched spmm_csr "
           f"{counts['F1']['spmm_csr']} times, not 0")
    _check(counts["F2"]["edge_softmax"] == 0, f"config F2 launched "
           f"edge_softmax {counts['F2']['edge_softmax']} times, not 0")
    _check(hist_f3.meta["corr_agg_layout"] == "csr",
           f"config F3: auto resolved to {hist_f3.meta['corr_agg_layout']}")
    _same_trajectory("config F1 vs A", hist_f1, hist_a,
                     1.0 / len(data.val_nodes))
    return counts


def _paper_phase(kernels) -> dict:
    """Phase P: the paper runner (``benchmarks/torch/paper_experiments``)
    on the card, each result held against the same call on the CPU:
    ``fig2_and_fig4`` (all four ``run_*`` shims), κ² on ``kappa_vs_gap``'s
    setting, ``run_subgraph_approx`` on fig11's, and ``run_llcg`` with the
    SpMM carrying the correction (an exact launch count)."""
    import torch
    sys.path.insert(0, str(ROOT))
    from benchmarks.torch import paper_experiments as paper
    from repro_torch.core import (DistConfig, estimate_discrepancies,
                                  run_llcg)
    from repro_torch.core.subgraph_approx import run_subgraph_approx
    from repro_torch.graph import partition_graph, sbm_graph
    from repro_torch.kernels.spmm import spmm_csr
    from repro_torch.models.gnn import build_model

    # fig2: record each shim's History as the runner calls it
    shims = ("run_psgd_pa", "run_llcg", "run_ggs", "run_single_machine")
    runs = {}
    for role, dev in (("card", "cuda"), ("cpu", "cpu")):
        hists = runs[role] = []
        originals = {name: getattr(paper, name) for name in shims}

        def recording(fn):
            def run(*args, **kw):
                hists.append(fn(*args, **kw))
                return hists[-1]
            return run
        for name, fn in originals.items():
            setattr(paper, name, recording(fn))
        try:
            t0 = time.perf_counter()
            rows = paper.fig2_and_fig4(rounds=P_ROUNDS, device=dev)
            if role == "card":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for name, fn in originals.items():
                setattr(paper, name, fn)
        print(f"phase P fig2_and_fig4 on {dev}: {len(rows)} rows in "
              f"{wall:.3f} s")
    one_node = 1.0 / len(paper._dataset().val_nodes)
    _check(len(runs["card"]) == len(shims) == len(runs["cpu"]),
           f"phase P: fig2 ran {len(runs['card'])} strategies")
    for name, a, b in zip(shims, runs["card"], runs["cpu"]):
        _check(a.meta["device"] == "cuda", f"phase P {name} ran on "
               f"{a.meta['device']}")
        _same_trajectory(f"phase P {name}", a, b, one_node)
        print(f"phase P {name}: val_f1 {a.val_score} train_loss "
              f"{a.train_loss} bytes_cum {a.bytes_cum}")

    # κ² on kappa_vs_gap's setting, one partition method
    ds = paper._dataset(seed=4)
    model = build_model("GG", ds.feature_dim, ds.num_classes, hidden_dim=32)
    part = partition_graph(ds.graph, 4, method="random")
    est = {role: estimate_discrepancies(ds, part, model,
                                        model.init(0, device=dev), fanout=8,
                                        num_sampling_trials=3)
           for role, dev in (("card", "cuda"), ("cpu", "cpu"))}
    for field in dataclasses.fields(est["cpu"]):
        a = getattr(est["card"], field.name)
        b = getattr(est["cpu"], field.name)
        _check(abs(a - b) <= TRAJ_RTOL * abs(b) + 1e-7,
               f"phase P estimate_discrepancies {field.name}: {a} vs {b}")
    print(f"phase P estimate_discrepancies (random): card {est['card']}, "
          f"cpu {est['cpu']}")

    # subgraph approximation on fig11's setting, first seed
    ds11 = sbm_graph(num_nodes=480, num_classes=4, feature_dim=16,
                     feature_snr=0.08, homophily=0.96, avg_degree=14, seed=6)
    m11 = build_model("GG", ds11.feature_dim, ds11.num_classes,
                      hidden_dim=32)
    cfg11 = paper._base_cfg(rounds=P_ROUNDS, local_k=2, correction_steps=1,
                            seed=6)
    apx = {role: run_subgraph_approx(ds11, m11, cfg11, device=dev)
           for role, dev in (("card", "cuda"), ("cpu", "cpu"))}
    _same_trajectory("phase P run_subgraph_approx", apx["card"], apx["cpu"],
                     1.0 / len(ds11.val_nodes))
    print(f"phase P run_subgraph_approx: val_f1 {apx['card'].val_score} "
          f"storage {apx['card'].meta['storage_overhead_bytes']} bytes")

    # LLCG with the correction through the SpMM: per correction step, one
    # forward launch per aggregating layer and one backward launch for each
    # but the first, whose input (the features) takes no gradient
    cfg = dataclasses.replace(paper._base_cfg(rounds=P_ROUNDS),
                              server_agg_layout="bcsr_kernel")
    gg = build_model("GG", ds.feature_dim, ds.num_classes, hidden_dim=32)
    data2 = paper._dataset()
    run_llcg(data2, gg, cfg, device="cuda")              # warm-up
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    hist = run_llcg(data2, gg, cfg, device="cuda")
    torch.cuda.synchronize()
    counts = {k.__name__: k.launches for k in kernels}
    n_agg = sum(op in "GS" for op in gg.arch)
    want = P_ROUNDS * cfg.correction_steps * (2 * n_agg - 1)
    _check(counts["spmm_csr"] == want, f"phase P run_llcg launched "
           f"spmm_csr {counts['spmm_csr']} times, not {want}")
    _same_trajectory("phase P run_llcg bcsr_kernel", hist,
                     run_llcg(data2, gg, cfg, device="cpu"), one_node)
    print(f"phase P run_llcg bcsr_kernel: launches {counts}; val_f1 "
          f"{hist.val_score}")
    return counts


# --------------------------------------------------------------------------
# phase DS and configs A-dev, D-dev: the device sampler
# --------------------------------------------------------------------------
def _device_placed(plan):
    return dataclasses.replace(plan, sampler=dataclasses.replace(
        plan.sampler, placement="device"))


def _kernel_launches(fn):
    """Device kernels one call of ``fn`` launches (``torch.profiler``), or
    "not measured" when the profiler records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    except (RuntimeError, AttributeError) as e:    # tracing unavailable
        return f"not measured ({e})"
    return n if n > 0 else "not measured"


def _draw_ms(fn, reps: int = 5) -> float:
    """Median wall time of ``fn()`` to its last kernel, in ms."""
    import statistics

    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _phase_ds(data, cfg, plans, f3) -> None:
    """Phase DS: the device sampler drawn on the card and on the CPU, bit
    for bit, at the main path's shapes: A's local stack (K = 4, the narrow
    rank-select), D's extended-graph stack, F3's R-MAT graph — its local
    stacks (train pools over 128: the wide rank-select of the batches) and
    the unpartitioned graph a single-machine plan samples (dmax 928: the
    wide rank-select of the tables) — and S4's full-width serving tables
    over 8 extended graphs.  The large draws are checked on the CPU at
    their first and last machine (a rank's shard draws its slice of the
    stack exactly) or their first step (each step folds its own key).
    Times the eager draw against the host draw + copy at the same shape,
    and counts its launches."""
    import torch
    from repro_torch.core.plan import (RoundSampler, lower_plan,
                                       single_machine_plan)
    from repro_torch.launch.mesh import MachineMesh
    from repro_torch.graph.sampling import (build_device_csr,
                                            sample_serving_tables,
                                            sample_serving_tables_device)
    from repro_torch.models.gnn.model import build_model
    from repro_torch.serving.core import wave_key, wave_rng
    from repro_torch.serving.gnn import GNNServingEngine

    def same(label, card, cpu, rows=None):
        for a, b in zip(card, cpu):
            a = a.cpu() if rows is None else a[rows].cpu()
            _check(a.dtype == b.dtype and torch.equal(a, b),
                   f"phase DS {label}: card and CPU draws differ")

    f3_data, f3_model = f3
    cpu = torch.device("cpu")
    rounds = {"A local": (data, *plans["A"]), "D ext": (data, *plans["D"]),
              "F3 local": (f3_data, f3_model, plans["A"][1]),
              "F3 full": (f3_data, f3_model, single_machine_plan(cfg))}
    for label, (d, model, plan) in rounds.items():
        plan = _device_placed(plan)
        desc = lower_plan(plan)[0]
        card = RoundSampler(d, model, plan, "cuda")
        dcsr = card._device_csr(desc.kind)
        draw = lambda: card.sample_round_on_device(desc)
        got = draw()
        P = dcsr.num_machines
        if label.startswith("F3"):
            wide = (dcsr.dmax if label == "F3 full"
                    else dcsr.train_nodes.shape[1])
            _check(wide > 128, f"phase DS {label}: width {wide}, not the "
                   "wide rank-select")
        if label == "F3 full":
            one = dataclasses.replace(desc, k=1)
            same(f"{label} step 0", [x[:, :1] for x in got[:4]],
                 RoundSampler(d, model, plan, "cpu")
                 .sample_round_on_device(one)[:4])
        elif label == "F3 local":
            for p in (0, P - 1):
                shard = RoundSampler(d, model, plan, "cpu",
                                     mesh=MachineMesh(p, P, cpu))
                same(f"{label} machine {p}", got[:4],
                     shard.sample_round_on_device(desc)[:4],
                     rows=slice(p, p + 1))
        else:
            same(label, got[:4], RoundSampler(d, model, plan, "cpu")
                 .sample_round_on_device(desc)[:4])
        ms = _draw_ms(draw)
        launches = _kernel_launches(draw)
        host = RoundSampler(d, model, dataclasses.replace(
            plan, sampler=dataclasses.replace(plan.sampler,
                                              placement="host")), "cuda")
        host.prewarm({desc.kind})
        host_ms = _draw_ms(lambda: host.sample(
            dataclasses.replace(desc, correction=False)))
        print(f"phase DS {label}: tables {tuple(got[0].shape)} (dmax "
              f"{dcsr.dmax}, t_pad {dcsr.train_nodes.shape[1]}), batches "
              f"{tuple(got[2].shape)}: card = CPU bit for bit; device draw "
              f"{ms:.3f} ms eager, {launches} kernel launches; host draw + "
              f"copy {host_ms:.3f} ms")

    # S4's serving tables: F3's graph on 8 BFS machines at full width
    ss = build_model("SS", f3_data.feature_dim, f3_data.num_classes,
                     hidden_dim=64)
    eng = GNNServingEngine(ss, ss.init(0), f3_data, num_machines=8,
                           batch_size=8, agg_layout="auto",
                           sampler_placement="device")
    be = eng.backend
    width, key = be.full_fanout, wave_key(0, [be.full_fanout])
    draw = lambda: sample_serving_tables_device(be._dcsr, key, width)
    got = draw()
    for p in (0, 7):
        one = build_device_csr([be.plan.ext_graphs[p]], n_pad=be.n_ext_pad,
                               device="cpu", machines=(p,),
                               dmax=be._dcsr.dmax)
        same(f"S4 serving machine {p}", got,
             sample_serving_tables_device(one, key, width),
             rows=slice(p, p + 1))
    ms = _draw_ms(draw, reps=3)
    launches = _kernel_launches(draw)

    def host_draw():
        t, m = sample_serving_tables(be.plan.ext_graphs, width,
                                     wave_rng(0, [width]), be.n_ext_pad)
        return (torch.from_numpy(t).cuda(), torch.from_numpy(m).cuda())

    host_ms = _draw_ms(host_draw, reps=3)
    print(f"phase DS S4 serving: tables {tuple(got[0].shape)} (dmax "
          f"{be._dcsr.dmax}): card = CPU bit for bit at machines 0 and 7; "
          f"device draw {ms:.3f} ms eager, {launches} kernel launches; host "
          f"draw + copy {host_ms:.3f} ms")


def _configs_dev(data, plans, counts, kernels) -> dict:
    """Configs A-dev and D-dev: A's and D's plans with the device sampler
    (overlap on), through ``_drive``'s gates, with A's and D's exact
    launches."""
    out = {}
    for name in ("A", "D"):
        model, plan = plans[name]
        out[f"{name}-dev"], hist = _drive(f"{name}-dev", data, model,
                                          _device_placed(plan), kernels)
        _check(hist.meta["sampler_placement"] == "device"
               and hist.meta["sampler_overlap"],
               f"config {name}-dev: {hist.meta['sampler_placement']}")
        for k, n in counts[name].items():
            _check(out[f"{name}-dev"][k] == n, f"config {name}-dev launched "
                   f"{k} {out[f'{name}-dev'][k]} times, not {n}")
    return out


# --------------------------------------------------------------------------
# phase M: the shard_map backend, four ranks on the card
# --------------------------------------------------------------------------
M_MACHINES = 4       # ShardedGNNConfig's default group


def _m_plans():
    """M1: config C's plan (int8_ef) on the device sampler; M2: config D's
    (the int8 halo); both on M_MACHINES machines."""
    data, _, plans = _configs()
    four = lambda plan: dataclasses.replace(plan, comm=dataclasses.replace(
        plan.comm, num_machines=M_MACHINES))
    return data, {"M1": (plans["C"][0], _device_placed(four(plans["C"][1]))),
                  "M2": (plans["D"][0], four(plans["D"][1]))}


def _kernel_counts():
    from repro_torch.kernels.edge_softmax import edge_softmax
    from repro_torch.kernels.linear_scan import linear_scan_chunked
    from repro_torch.kernels.quantize import dequantize_rows, quantize_rows
    from repro_torch.kernels.spmm import spmm_csr
    return (spmm_csr, edge_softmax, quantize_rows, dequantize_rows,
            linear_scan_chunked)


def _m_rank(mesh, name):
    """One rank of phase M: the run, its wall time, this rank's launches
    and collective bytes (gathered to the lead)."""
    import torch
    from repro_torch.core.plan import build_trainer
    data, plans = _m_plans()
    model, plan = plans[name]
    build_trainer(data, model, dataclasses.replace(
        plan, schedule=dataclasses.replace(plan.schedule, rounds=1)),
        backend="shard_map", mesh=mesh).run()        # loads the libraries
    kernels = _kernel_counts()
    for k in kernels:
        k.launches = 0
    mesh.wire_bytes.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = build_trainer(data, model, plan, backend="shard_map",
                         mesh=mesh).run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    import torch.distributed as dist
    launches = [None] * mesh.size
    dist.all_gather_object(launches, {k.__name__: k.launches
                                      for k in kernels})
    return hist, wall, launches, mesh.gather_wire_bytes()


def _m_average_rank(mesh):
    """M1's averaging on its own: every rank runs config C's first local
    round stacked, as the vmap backend does (deterministic, so the same
    bits on every rank), and averages its own machine's rows through the
    all-gather; the result must be the vmap average bit for bit."""
    import torch
    from repro_torch.core.engine import EngineConfig, RoundProgram
    from repro_torch.core.plan import RoundSampler, lower_plan
    data, plans = _m_plans()
    model, plan = plans["M1"]
    sampler = RoundSampler(data, model, plan, mesh.device)
    desc = lower_plan(plan)[0]
    inputs = sampler.sample(desc)
    cfg = EngineConfig(num_machines=mesh.size, compression="int8_ef",
                       comm_seed=plan.seed)
    vmap = RoundProgram(model, sampler.opt, None, cfg)
    shard = RoundProgram(model, sampler.opt, None, dataclasses.replace(
        cfg, backend="shard_map"), mesh=mesh)
    params = model.init(plan.seed, device=mesh.device)
    s_vmap, s_shard = vmap.init_state(params), shard.init_state(params)
    p_new, _, _ = vmap._local_round(
        params, None, sampler.feats, sampler.labels, inputs.tables,
        inputs.masks, inputs.batches, inputs.bmasks, [1.0] * desc.k)
    from repro_torch.utils.pytree import tree_leaves, tree_map
    want, want_res = vmap.average(s_vmap, p_new)
    got, got_res = shard.average(s_shard, tree_map(shard._mine, p_new))
    same = all(torch.equal(a, b) for a, b in
               zip(tree_leaves(want), tree_leaves(got)))
    same_res = all(torch.equal(shard._mine(a), b) for a, b in
                   zip(tree_leaves(want_res), tree_leaves(got_res)))
    flat = torch.cat([x.reshape(-1) for x in tree_leaves(p_new)])
    ranks = mesh.all_gather([flat[None]], "check")[0]
    import torch.distributed as dist
    verdict = [None] * mesh.size
    dist.all_gather_object(verdict, (same, same_res,
                                     bool((ranks == ranks[0]).all())))
    return verdict


def _local_round_gap(data, model, plan) -> tuple:
    """How far config C's first local round, run for one machine alone (a
    rank's batch of one), lies from the same machine's rows of the stacked
    round (the vmap backend's batch of P): ``(max |diff|, unequal leaves,
    leaves)``."""
    import torch
    from repro_torch.core.plan import RoundSampler, lower_plan
    from repro_torch.core.machine import make_local_round
    from repro_torch.utils.pytree import tree_leaves
    sampler = RoundSampler(data, model, plan, "cuda")
    desc = lower_plan(plan)[0]
    inputs = sampler.sample(desc)
    run = make_local_round(model, sampler.opt)
    params = model.init(plan.seed, device="cuda")
    sv = [1.0] * desc.k
    full, _, _ = run(params, None, sampler.feats, sampler.labels,
                     inputs.tables, inputs.masks, inputs.batches,
                     inputs.bmasks, sv)
    worst, unequal, total = 0.0, 0, 0
    for p in range(plan.comm.num_machines):
        s = slice(p, p + 1)
        one, _, _ = run(params, None, sampler.feats[s], sampler.labels[s],
                        inputs.tables[s], inputs.masks[s], inputs.batches[s],
                        inputs.bmasks[s], sv)
        for a, b in zip(tree_leaves(full), tree_leaves(one)):
            worst = max(worst, float((a[p] - b[0]).abs().max()))
            unequal += int(not torch.equal(a[p], b[0]))
            total += 1
    return worst, unequal, total


def _machines_child() -> dict:
    """Phase M's body, in a fresh process (cuBLAS reads its workspace
    setting once, at start): every rank, the vmap run it is held against
    and this process under ``torch.use_deterministic_algorithms(True)``."""
    import torch
    from repro_torch.core.plan import build_trainer
    from repro_torch.launch.mesh import launch_machines
    from repro_torch.utils.pytree import tree_leaves
    torch.use_deterministic_algorithms(True)
    data, plans = _m_plans()
    out = {}
    for name, (model, plan) in plans.items():
        vmap_walls = []
        for _ in range(2):                   # the first loads the libraries
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = build_trainer(data, model, plan).run()
            torch.cuda.synchronize()
            vmap_walls.append(time.perf_counter() - t0)
        hist, wall, launches, wire = launch_machines(
            _m_rank, M_MACHINES, name, device="cuda", deterministic=True)
        series = lambda h: (h.train_loss + h.meta["local_loss"]
                            + h.meta["corr_loss"])
        out[name] = {
            "wall_s": wall, "vmap_wall_s": vmap_walls[-1],
            "launches": launches, "wire": wire,
            "bytes_cum": hist.bytes_cum, "vmap_bytes_cum": ref.bytes_cum,
            "steps": hist.steps_cum[-1] // M_MACHINES,
            "halo_bytes_per_step": hist.meta.get("halo_bytes_per_step", 0),
            "series": series(hist), "vmap_series": series(ref),
            "val": hist.val_score, "vmap_val": ref.val_score,
            "param_diffs": sorted(float(x) for x in torch.cat([
                (a - b).abs().reshape(-1) for a, b in zip(
                    tree_leaves(hist.meta["final_params"]),
                    tree_leaves(ref.meta["final_params"]))]).tolist()),
            "device": hist.meta["device"],
            "placement": hist.meta["sampler_placement"],
            "n_val": len(data.val_nodes)}
    # context for M1's distance: the same vmap run on the CPU
    model, plan = plans["M1"]
    cpu = build_trainer(data, model, plan, device="cpu").run()
    ref = build_trainer(data, model, plan).run()
    out["M1"]["cpu_param_diff"] = max(
        float((a.cpu() - b).abs().max()) for a, b in zip(
            tree_leaves(ref.meta["final_params"]),
            tree_leaves(cpu.meta["final_params"])))
    out["average"] = launch_machines(_m_average_rank, M_MACHINES,
                                     device="cuda", deterministic=True)
    out["local_round_gap"] = _local_round_gap(data, *plans["M1"])
    return out


def _phase_m(card: str) -> dict:
    """Phase M: M1 and M2 on four gloo ranks sharing the card, each against
    the vmap backend at P = 4 on the card, with the predicted launches per
    rank and the accounting's bytes at the collectives.  Every number is
    printed before the gates run."""
    import os
    t0 = time.perf_counter()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--machines"], env=env, capture_output=True,
                          text=True, timeout=600)
    _check(proc.returncode == 0, f"phase M child failed: "
           f"{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    from repro_torch.utils.pytree import tree_leaves
    data, plans = _m_plans()
    leaves = len(tree_leaves(plans["M1"][0].init_numpy(0)))
    worst, unequal, total_leaves = out["local_round_gap"]
    # int8 stochastic rounding (M1): a delta within f32 noise of a rounding
    # boundary rounds one level apart, and Adam's normalized steps carry
    # the flip on; the share beyond one level per round is reported, the
    # gate is the drift two Adam trajectories can have
    # (tests/test_torch_slice.py's cap)
    loc = plans["M1"][1].local
    S = plans["M1"][1].server.correction_steps
    level = 1e-4 + ROUNDS * loc.local_k * loc.lr / 127
    cap = 2 * ROUNDS * (loc.local_k + S) * loc.lr
    for name in ("M1", "M2"):
        m = out[name]
        diffs = m["param_diffs"]
        m["param_diff"] = diffs[-1]
        m["beyond"] = sum(d > level for d in diffs) / len(diffs)
        m["loss_diff"] = max(abs(x - y) / max(1.0, abs(y)) for x, y in
                             zip(m["series"], m["vmap_series"]))
        print(f"phase {name}: {M_MACHINES} gloo ranks on one card, "
              f"{m['placement']} sampling: {m['wall_s'] * 1e3 / ROUNDS:.3f} "
              f"ms per round of a run() against "
              f"{m['vmap_wall_s'] * 1e3 / ROUNDS:.3f} for the vmap backend "
              f"(set-up included, deterministic algorithms); launches per "
              f"rank {m['launches']}; collective operand bytes per rank "
              f"{m['wire']}; |shard - vmap|: params max "
              f"{m['param_diff']:.3e} ({m['beyond']:.2%} beyond "
              f"{level:.3e}), losses {m['loss_diff']:.3e} relative, F1 "
              f"{m['val']} vs {m['vmap_val']} ({card})")
    print(f"phase M1 averaging: ranks report (params equal, residual equal, "
          f"inputs equal) {out['average']}; a machine's local round run "
          f"alone (a batch of one, as a rank runs it) lies {worst:.3e} from "
          f"its rows of the stacked round, {unequal} of {total_leaves} "
          f"leaves unequal; the vmap run of M1 on the card lies "
          f"{out['M1']['cpu_param_diff']:.3e} from the same run on the CPU")
    counts = {}
    for name in ("M1", "M2"):
        m = out[name]
        _check(m["device"].startswith("cuda") and len(m["launches"]) ==
               M_MACHINES, f"phase {name}: ran on {m['device']}")
        _check(m["bytes_cum"] == m["vmap_bytes_cum"],
               f"phase {name}: bytes {m['bytes_cum']} vs the vmap run's "
               f"{m['vmap_bytes_cum']}")
        total = lambda kind: sum(w.get(kind, 0) for w in m["wire"])
        priced = (2 * total("averaging") + 2 * total("gradients")
                  + (M_MACHINES - 1) * total("halo"))
        _check(priced == m["bytes_cum"][-1], f"phase {name}: the "
               f"collectives carried {m['wire']}, priced {priced}, not the "
               f"accounting's {m['bytes_cum'][-1]}")
        for x, y in zip(m["val"], m["vmap_val"]):
            _check(abs(x - y) <= 1.0 / m["n_val"] + 1e-6,
                   f"phase {name}: F1 {x} vs {y}")
        counts[name] = {kname: sum(r[kname] for r in m["launches"])
                        for kname in m["launches"][0]}
    # M2: the reference's bound between its two backends; M1: the int8
    # trajectories' cap on params and, on losses, the card-vs-CPU
    # trajectory gate that config C (the same int8 flips) passes
    _check(out["M2"]["param_diff"] <= 1e-4 and out["M2"]["loss_diff"]
           <= 1e-4, f"phase M2: params {out['M2']['param_diff']:.3e}, "
           f"losses {out['M2']['loss_diff']:.3e} from the vmap backend's")
    _check(out["M1"]["param_diff"] <= cap
           and out["M1"]["loss_diff"] <= TRAJ_RTOL, f"phase M1: max "
           f"{out['M1']['param_diff']:.3e} (cap {cap:.3e}), losses "
           f"{out['M1']['loss_diff']:.3e} relative")
    # predicted launches per rank per round (PERF.md, written before the
    # first run): M1 — one quantize per leaf and one grouped dequantize of
    # the gathered table; the lead also the correction's SpMM (A's 10 per
    # round); M2 — one quantize of its send buffer, one dequantize of each
    # step's gathered buffer
    k = plans["M2"][1].local.local_k
    for rank in range(M_MACHINES):
        want1 = {"quantize_rows": ROUNDS * leaves,
                 "dequantize_rows": ROUNDS,
                 "spmm_csr": ROUNDS * 10 if rank == 0 else 0,
                 "edge_softmax": 0, "linear_scan_chunked": 0}
        want2 = {"quantize_rows": ROUNDS, "dequantize_rows": ROUNDS * k,
                 "spmm_csr": 0, "edge_softmax": 0, "linear_scan_chunked": 0}
        for name, want in (("M1", want1), ("M2", want2)):
            got = out[name]["launches"][rank]
            _check(got == want, f"phase {name} rank {rank}: launches {got}, "
                   f"not {want}")
    _check(all(all(v) for v in out["average"]), f"phase M1 averaging: "
           f"ranks report (params equal, residual equal, inputs equal) "
           f"{out['average']}")
    print(f"phase M: every gate passed in {time.perf_counter() - t0:.1f} s")
    return counts, out["M2"]["wire"]


# --------------------------------------------------------------------------
# phase K: checkpoint and exact resume on the card
# --------------------------------------------------------------------------
def _hist_series(hist) -> dict:
    """Every History series a resume must reproduce, and the params."""
    from repro_torch.utils.pytree import tree_leaves
    out = {k: list(getattr(hist, k)) for k in ("rounds", "steps_cum",
                                               "val_score", "train_loss",
                                               "bytes_cum")}
    for k in ("local_loss", "corr_loss", "corr_rounds", "num_retraces",
              "num_corr_retraces", "masked_steps"):
        out[k] = hist.meta[k]
    out["params"] = [x.detach().cpu() for x in
                     tree_leaves(hist.meta["final_params"])]
    return out


def _distance(a: dict, b: dict) -> float:
    """Largest absolute difference between two runs' series and params;
    inf if their counts or accounting differ."""
    worst = 0.0
    for k in a:
        if k == "params":
            for x, y in zip(a[k], b[k]):
                worst = max(worst, float((x - y).abs().max()))
        elif k in ("val_score", "train_loss", "local_loss", "corr_loss"):
            worst = max([worst] + [abs(x - y) for x, y in zip(a[k], b[k])])
            if len(a[k]) != len(b[k]):
                return math.inf
        elif a[k] != b[k]:
            return math.inf
    return worst


def _phase_k(data, plans, kernels, card: str) -> dict:
    """Phase K: config C's plan (int8_ef: the snapshot carries a residual
    and the uniform stream) with ``CheckpointSpec(every=1, async_=True)``
    on the card.  The uninterrupted run three times; resumes from steps 1
    and 2 and ``run_or_resume`` on a directory holding step 1, each with
    its exact quantize / dequantize / SpMM launches and the uninterrupted
    run's trajectory (``gate``); the same under
    ``torch.use_deterministic_algorithms``, bit for bit; one chaos trial;
    the card's checkpoint resumed on the CPU; the caller-thread cost of
    ``save()``."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint import manager as M
    from repro_torch.core.plan import CheckpointSpec, build_trainer
    from repro_torch.launch.train import resume, run_or_resume

    model, base = plans["C"]
    leaves = sum(len(layer) for layer in model.init_numpy(0).values())
    n_agg = sum(op in "GS" for op in model.arch)
    (ROOT / "build").mkdir(exist_ok=True)
    root = pathlib.Path(tempfile.mkdtemp(prefix="phase_k_",
                                         dir=ROOT / "build"))
    spec = lambda d: dataclasses.replace(base, checkpoint=CheckpointSpec(
        dir=str(root / d), every=1, async_=True))
    save_s = []
    orig_save = M.CheckpointManager.save

    def timed_save(self, *a, **kw):
        t0 = time.perf_counter()
        orig_save(self, *a, **kw)
        save_s.append(time.perf_counter() - t0)
    M.CheckpointManager.save = timed_save
    try:
        runs = []
        for d in ("u1", "u2", "u3"):
            for k in kernels:
                k.launches = 0
            runs.append(build_trainer(data, model, spec(d)).run())
            torch.cuda.synchronize()
        full_counts = {k.__name__: k.launches for k in kernels}
        n_saves = len(save_s)
    finally:
        M.CheckpointManager.save = orig_save
    # the spread of index_add_'s atomics: the distances between the three
    # uninterrupted runs
    series = [_hist_series(h) for h in runs]
    pairs = [_distance(series[i], series[j])
             for i, j in ((0, 1), (0, 2), (1, 2))]
    one_node = 1.0 / len(data.val_nodes)
    print(f"phase K: three uninterrupted runs on the card, pairwise "
          f"distances {[f'{d:.3e}' for d in pairs]}; "
          f"launches of one run {full_counts}; save() on the caller thread "
          f"{[round(x * 1e3, 3) for x in save_s]} ms for {n_saves} saves "
          f"(mean {sum(save_s) / n_saves * 1e3:.3f} ms per round; {card})")
    _check(n_saves == 3 * ROUNDS, f"phase K: {n_saves} saves, not "
           f"{3 * ROUNDS}")
    _check(max(pairs) <= K_DEFAULT_LIMIT, f"phase K: uninterrupted runs "
           f"{max(pairs):.3e} apart, beyond {K_DEFAULT_LIMIT:.3e}")

    def gate(label, hist, counts, rounds_run, ref, limit):
        """A resumed run against the uninterrupted History ``ref``: every
        count, retrace and accounting series equal, the loss and F1 series
        and the parameters within ``limit`` (deterministic mode: 0.0, bit
        for bit; default mode: ``K_DEFAULT_LIMIT``, and the trajectory
        within the card-vs-CPU rule, ``_same_trajectory``); and the exact
        launches."""
        got = _hist_series(hist)
        dist = _distance(_hist_series(ref), got)
        _check(dist <= limit, f"phase K {label}: resumed run {dist:.3e} "
               f"from the uninterrupted one (inf: a count or the "
               f"accounting differs), beyond {limit:.3e}")
        note = ""
        if limit > 0:
            _same_trajectory(f"phase K {label}", hist, ref, one_node)
            nearest = min(_distance(x, got) for x in series)
            note = (f" (nearest uninterrupted run {nearest:.3e}; their "
                    f"pairwise distances {[f'{d:.3e}' for d in pairs]})")
        want = {"quantize_rows": rounds_run * leaves,
                "dequantize_rows": rounds_run,
                "spmm_csr": rounds_run * base.server.correction_steps
                * (2 * n_agg - 1)}
        for name, n in want.items():
            _check(counts[name] == n, f"phase K {label}: {name} launched "
                   f"{counts[name]} times, not {n}")
        print(f"phase K {label}: distance {dist:.3e}{note}; launches "
              f"{counts}")

    def resumes(src: str, ref, limit, key: str, mode: str) -> dict:
        """Resumes from steps 1 and 2 of ``src``'s checkpoints and
        ``run_or_resume`` on a directory holding step 1, each gated
        against ``ref`` (``gate``); returns their launch counts."""
        out = {}
        for step in (1, 2):
            for k in kernels:
                k.launches = 0
            got = build_trainer(data, model, base).run(
                resume_from=str(root / src), resume_step=step)
            torch.cuda.synchronize()
            counts = {k.__name__: k.launches for k in kernels}
            gate(f"{mode}resume from step {step}", got, counts,
                 ROUNDS - step, ref, limit)
            out[f"{key}{step}"] = counts
        dst = root / f"{src}_r"
        dst.mkdir()
        for f in ("ckpt_1.npz", "ckpt_1.json"):
            shutil.copy(root / src / f, dst / f)
        for k in kernels:
            k.launches = 0
        got = run_or_resume(data, model, spec(dst.name))
        torch.cuda.synchronize()
        counts = {k.__name__: k.launches for k in kernels}
        gate(f"{mode}run_or_resume on step 1", got, counts, ROUNDS - 1, ref,
             limit)
        out[f"{key}_run_or_resume"] = counts
        return out

    all_counts = resumes("u1", runs[0], K_DEFAULT_LIMIT, "K", "")

    # the same under torch.use_deterministic_algorithms (index_add_ — the
    # gathers' backward, float atomics by default — takes its sorted,
    # deterministic path): two uninterrupted runs that must agree bit for
    # bit, and the three resumes, which must equal them bit for bit; the
    # round time in each mode
    def rounds_ms(plan) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        build_trainer(data, model, plan).run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / ROUNDS * 1e3

    default_ms = min(rounds_ms(base) for _ in range(TIMING_REPS))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det_ms = min(rounds_ms(base) for _ in range(TIMING_REPS))
        det = [build_trainer(data, model, spec(d)).run()
               for d in ("d1", "d2")]
        d_det = _distance(_hist_series(det[0]), _hist_series(det[1]))
        print(f"phase K with torch.use_deterministic_algorithms(True): two "
              f"uninterrupted runs differ by {d_det:.3e}; {det_ms:.3f} ms "
              f"per round of a run() against {default_ms:.3f} without "
              f"({card})")
        _check(d_det == 0.0, "phase K deterministic: two uninterrupted runs "
               f"differ by {d_det:.3e}")
        all_counts.update(resumes("d1", det[0], 0.0, "Kdet",
                                  "deterministic "))
    finally:
        torch.use_deterministic_algorithms(False)

    # one SIGKILL chaos trial on the card: its children run deterministic
    from repro_torch.checkpoint.chaos import run_chaos
    t0 = time.perf_counter()
    run_chaos(kill_round=2, device="cuda")
    print(f"phase K chaos trial on the card: {time.perf_counter() - t0:.1f} "
          "s for the killed, relaunched and reference children")

    # the card's checkpoint resumed on the CPU: portable across devices
    cpu_res = resume(data, model, base, ckpt_dir=str(root / "u1"), step=1,
                     device="cpu")
    cpu_ref = build_trainer(data, model, base, device="cpu").run()
    _same_trajectory("phase K card checkpoint resumed on the CPU", cpu_res,
                     cpu_ref, 1.0 / len(data.val_nodes))
    _check(cpu_res.meta["device"] == "cpu", "phase K: CPU resume ran on "
           f"{cpu_res.meta['device']}")
    print(f"phase K: the card's step-1 checkpoint resumed on the CPU agrees "
          f"with the CPU's uninterrupted run: val_f1 {cpu_res.val_score}")
    shutil.rmtree(root)
    all_counts["K"] = full_counts
    return all_counts


# --------------------------------------------------------------------------
# phase S: GNN serving on the card
# --------------------------------------------------------------------------
def _serve(engine, reqs) -> tuple:
    """Submit ``reqs`` (dicts), run, and return ``({uid: result}, wall s)``."""
    import torch
    from repro_torch.serving.gnn import GNNRequest
    for r in reqs:
        engine.submit(GNNRequest(**r))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = {r.uid: r for r in engine.run()}
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _served_alike(label: str, card: dict, cpu: dict) -> float:
    """Gate a card serve against the CPU's: predictions equal, logits
    within 1e-4 × max(1, max|cpu|).  Returns the largest difference."""
    import numpy as np
    _check(sorted(card) == sorted(cpu), f"{label}: served {sorted(card)}")
    worst = 0.0
    for uid, c in cpu.items():
        g = card[uid]
        err = float(np.abs(g.embeddings - c.embeddings).max())
        tol = SERVE_TOL * max(1.0, float(np.abs(c.embeddings).max()))
        _check(np.isfinite(g.embeddings).all() and err <= tol,
               f"{label} uid {uid}: max |card - cpu| {err} > {tol}")
        _check(g.predictions == c.predictions, f"{label} uid {uid}: "
               f"predictions {g.predictions} vs CPU {c.predictions}")
        worst = max(worst, err)
    return worst


def _serve_counts(kernels, fn) -> tuple:
    import torch
    for k in kernels:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in kernels}


def _phase_s(data, cfg, plans, f3, kernels) -> dict:
    """Phase S: GNN serving.  S1 trains config B's fused GAT 3 rounds with
    ``checkpoint_dir`` and serves it through ``GNNServingEngine.from_plan``
    with the int8 halo codec (two width buckets); S2 adds the serve-time
    correction; S3 serves config A's SAGE stack (its batch-norm ops left
    out: serving refuses batch statistics) through stacked csr operands,
    wave and slot, against the full-graph forward; S4 serves F3's graph
    with ``agg_layout="auto"``, which must resolve to csr."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core.plan import build_trainer
    from repro_torch.graph.csr import build_neighbor_table
    from repro_torch.models.gnn.model import build_model
    from repro_torch.serving.gnn import GNNServingEngine
    from repro_torch.utils.pytree import tree_leaves

    counts = {}
    (ROOT / "build").mkdir(exist_ok=True)
    root = pathlib.Path(tempfile.mkdtemp(prefix="phase_s_",
                                         dir=ROOT / "build"))
    model_b, plan_b = plans["B"]
    plan = dataclasses.replace(plan_b, checkpoint_dir=str(root / "b"))
    build_trainer(data, model_b, plan).run()
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    reqs = [dict(uid=i, nodes=rng.integers(0, data.num_nodes, 16).tolist(),
                 fanout=None if i < S_REQUESTS // 2 else 10,
                 return_embeddings=True) for i in range(S_REQUESTS)]
    gat_layers = len(model_b.init_numpy(0))

    # ---- S1: wave serving of the trained GAT with the int8 halo codec
    kw = dict(halo_compression="int8", batch_size=8)
    warm = GNNServingEngine.from_plan(plan, model_b, data, **kw)
    _serve(warm, reqs[:1])                          # loads the libraries
    eng = GNNServingEngine.from_plan(plan, model_b, data, **kw)
    (card, wall), c1 = _serve_counts(kernels, lambda: _serve(eng, reqs))
    cpu, _ = _serve(GNNServingEngine.from_plan(plan, model_b, data,
                                               device="cpu", **kw), reqs)
    st = eng.stats()
    waves = st["waves"]
    err = _served_alike("phase S1", card, cpu)
    _check(waves == S_REQUESTS // 8 and len(st["widths_compiled"]) == 2,
           f"phase S1: {waves} waves over widths {st['widths_compiled']}")
    for name, want in (("quantize_rows", waves), ("dequantize_rows", waves),
                       ("edge_softmax", waves * gat_layers),
                       ("spmm_csr", 0), ("linear_scan_chunked", 0)):
        _check(c1[name] == want, f"phase S1: {name} launched {c1[name]} "
               f"times, not {want}")
    _check(st["exchange_bytes_cum"] == waves * st["exchange_bytes_per_wave"],
           f"phase S1: exchange bytes {st['exchange_bytes_cum']}")
    lat = sorted(eng.scheduler.request_log, key=lambda r: r["uid"])
    print(f"phase S1: {S_REQUESTS} requests in {waves} waves, {wall:.4f} s "
          f"({wall / waves * 1e3:.3f} ms per wave); service time "
          f"{st['service_s']}; launches {c1}; max |card - cpu| {err:.3e}; "
          f"stats num_retraces {st['num_retraces']} widths "
          f"{st['widths_compiled']} exchange {st['exchange_bytes_per_wave']} "
          f"B per wave, {st['exchange_bytes_cum']} B in all; first request "
          f"served in {lat[0]['service_s'] * 1e3:.3f} ms")
    counts["S1"] = c1

    # ---- S1-dev: S1 on the device sampler, against the CPU's device draw
    kwd = dict(kw, sampler_placement="device")
    warm = GNNServingEngine.from_plan(plan, model_b, data, **kwd)
    _serve(warm, reqs[:1])
    eng = GNNServingEngine.from_plan(plan, model_b, data, **kwd)
    (card, wall_d), c1d = _serve_counts(kernels, lambda: _serve(eng, reqs))
    cpu, _ = _serve(GNNServingEngine.from_plan(plan, model_b, data,
                                               device="cpu", **kwd), reqs)
    err = _served_alike("phase S1-dev", card, cpu)
    _check(eng.stats()["waves"] == waves, "phase S1-dev: other waves")
    for name, n in c1.items():
        _check(c1d[name] == n, f"phase S1-dev: {name} launched {c1d[name]} "
               f"times, not S1's {n}")
    print(f"phase S1-dev: {S_REQUESTS} requests in {waves} waves, "
          f"{wall_d:.4f} s ({wall_d / waves * 1e3:.3f} ms per wave against "
          f"S1's {wall / waves * 1e3:.3f}); launches {c1d}; max |card - cpu|"
          f" {err:.3e}")
    counts["S1-dev"] = c1d

    # ---- S2: the same checkpoint with the serve-time correction
    kw2 = dict(kw, correction_steps=S2_STEPS)
    sub = reqs[:8] + reqs[-8:]
    eng = GNNServingEngine.from_plan(plan, model_b, data, **kw2)
    stored = [x.clone() for x in tree_leaves(eng.params)]
    (card, wall), c2 = _serve_counts(kernels, lambda: _serve(eng, sub))
    cpu, _ = _serve(GNNServingEngine.from_plan(plan, model_b, data,
                                               device="cpu", **kw2), sub)
    err = _served_alike("phase S2", card, cpu)
    _check(all(torch.equal(a, b) for a, b in zip(tree_leaves(eng.params),
                                                  stored)),
           "phase S2: the correction changed the stored params")
    waves = eng.stats()["waves"]
    for name, want in (("quantize_rows", waves), ("dequantize_rows", waves),
                       ("edge_softmax", waves * gat_layers * (S2_STEPS + 1))):
        _check(c2[name] == want, f"phase S2: {name} launched {c2[name]} "
               f"times, not {want}")
    print(f"phase S2: correction_steps {S2_STEPS}, {len(sub)} requests in "
          f"{waves} waves, {wall / waves * 1e3:.3f} ms per wave; launches "
          f"{c2}; max |card - cpu| {err:.3e}; stored params unchanged")
    counts["S2"] = c2

    # ---- S3: config A's SAGE stack through stacked csr operands
    sss = build_model("SSS", data.feature_dim, data.num_classes,
                      hidden_dim=64)
    params = sss.init(0)
    table, mask = build_neighbor_table(data.graph)
    with torch.no_grad():
        full = sss.apply(params, torch.from_numpy(data.features).cuda(),
                         torch.from_numpy(table).cuda(),
                         torch.from_numpy(mask).cuda()).cpu().numpy()
    full_reqs = [dict(r, fanout=None) for r in reqs[:S_REQUESTS // 2]]
    out = {}
    for sched in ("wave", "slot"):
        eng = GNNServingEngine(sss, params, data, num_machines=8,
                               batch_size=8, scheduler=sched,
                               agg_layout="csr")
        (res, wall), c3 = _serve_counts(kernels,
                                        lambda: _serve(eng, full_reqs))
        _check(eng.backend._agg_for_width(eng.backend.full_fanout)
               is not None, f"phase S3 {sched}: full width not csr")
        _check(sum(c3.values()) == 0, f"phase S3 {sched}: launched {c3}")
        for uid, r in res.items():
            ref = full[r.nodes]
            e = float(np.abs(r.embeddings - ref).max())
            _check(e <= SERVE_TOL * max(1.0, float(np.abs(ref).max()))
                   and r.predictions == list(ref.argmax(-1)),
                   f"phase S3 {sched} uid {uid}: {e} from the full-graph "
                   "forward")
        out[sched] = res
        print(f"phase S3 {sched}: {len(res)} requests in {wall:.4f} s; "
              f"stats {json.dumps({k: v for k, v in eng.stats().items() if not isinstance(v, dict)})}")
    _check({u: r.predictions for u, r in out["wave"].items()}
           == {u: r.predictions for u, r in out["slot"].items()},
           "phase S3: slot predictions differ from wave predictions")
    counts["S3"] = c3

    # ---- S4: F3's degree-skewed graph, agg_layout="auto" → csr
    f3_data = f3[0]
    ss = build_model("SS", f3_data.feature_dim, f3_data.num_classes,
                     hidden_dim=64)
    p4 = ss.init(0)
    rng = np.random.default_rng(4)
    r4 = [dict(uid=i, nodes=rng.integers(0, f3_data.num_nodes, 16).tolist(),
               return_embeddings=True) for i in range(16)]
    eng = GNNServingEngine(ss, p4, f3_data, num_machines=8, batch_size=8,
                           agg_layout="auto")
    _check(eng.backend._agg_for_width(eng.backend.full_fanout) is not None,
           "phase S4: auto did not resolve to csr at full width")
    (card, wall), c4 = _serve_counts(kernels, lambda: _serve(eng, r4))
    cpu, wall_cpu = _serve(GNNServingEngine(
        ss, ss.init(0, device="cpu"), f3_data, num_machines=8, batch_size=8,
        agg_layout="auto", device="cpu"), r4)
    err = _served_alike("phase S4", card, cpu)
    print(f"phase S4: F3's graph, n_ext_pad {eng.backend.n_ext_pad}, full "
          f"width {eng.backend.full_fanout}: 16 requests in {wall:.4f} s "
          f"({eng.stats()['waves']} waves; host tables included), launches "
          f"{c4}; max |card - cpu| {err:.3e}")
    counts["S4"] = c4

    # ---- S4-dev: S4 on the device sampler.  At full width the drawn
    # tables are the full neighbor tables, so S4's card serve is the gate
    eng = GNNServingEngine(ss, p4, f3_data, num_machines=8, batch_size=8,
                           agg_layout="auto", sampler_placement="device")
    _serve(eng, r4[:1])
    eng = GNNServingEngine(ss, p4, f3_data, num_machines=8, batch_size=8,
                           agg_layout="auto", sampler_placement="device")
    (dev, wall_d), c4d = _serve_counts(kernels, lambda: _serve(eng, r4))
    err = _served_alike("phase S4-dev", dev, card)
    _check(c4d == c4, f"phase S4-dev: launches {c4d}, not S4's {c4}")
    w4 = eng.stats()["waves"]
    print(f"phase S4-dev: 16 requests in {wall_d:.4f} s ({w4} waves, "
          f"{wall_d / w4 * 1e3:.3f} ms per wave against S4's "
          f"{wall / w4 * 1e3:.3f} with host tables); max |device-drawn - "
          f"host-drawn| {err:.3e}")
    counts["S4-dev"] = c4d
    shutil.rmtree(root)
    return counts


def _close_to_cpu(label: str, what: str, gpu, cpu, worst: list,
                  rtol: float = LM_TOL) -> None:
    """Gate one card-vs-CPU comparison of an LM at ``rtol`` × max(1,
    max|cpu|) and record its share of the tolerance in ``worst``."""
    err = float((gpu.cpu().float() - cpu.float()).abs().max())
    tol = rtol * max(1.0, float(cpu.float().abs().max()))
    _check(gpu.dtype == cpu.dtype and math.isfinite(err) and err <= tol,
           f"config {label} {what}: max |card - cpu| {err} > {tol} "
           f"({gpu.dtype}, {cpu.dtype})")
    worst.append((err / tol, what, err))


def _config_e(kernels) -> dict:
    """Config E: rwkv6-1.6b at full width.  E1 serves through
    ``ServingEngine`` in the config's dtype; E2 holds the f32 model on the
    card against the CPU.  Returns the launch counts of E1's counted
    run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer.model import LM
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.utils.pytree import tree_leaves, tree_map

    cfg = get_config("rwkv6-1.6b")
    t0 = time.perf_counter()
    p_cpu = LM(cfg).init(E_SEED, "cpu")      # drawn once, used by E1 and E2
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_gpu = tree_map(lambda x: x.cuda(), p_cpu)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(p_cpu))
    print(f"config E: {cfg.name}, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{n_params} parameters (f32), dtype {cfg.dtype}; init on the CPU "
          f"{init_s:.1f} s, copy to the card {time.perf_counter() - t0:.1f} s")

    # ---- E1: serving through the engine, greedy, the bf16 config
    rng = np.random.default_rng(E_SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in E_PROMPTS]
    finite = []
    first_logits = {}             # prompt length → the wave's prefill logits

    def serve(check_logits: bool = False):
        eng = ServingEngine(cfg, params=p_gpu, batch_size=4, max_seq=512)
        if check_logits:                  # every logit the engine samples from
            sample = eng.backend._sample

            def checked(logits, wave, step):
                finite.append(torch.isfinite(logits).all())
                if step == 0:
                    first_logits[len(wave[0].prompt)] = (
                        [r.prompt for r in wave], logits.cpu())
                return sample(logits, wave, step)
            eng.backend._sample = checked
        for uid, prompt in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=prompt,
                               max_new_tokens=E_NEW_TOKENS))
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        return eng, {r.uid: r for r in res}, time.perf_counter() - t0

    warm, first, _ = serve()              # warm-up; also the repeat check
    for w in warm.stats()["wave_log"]:
        print(f"config E1 warm-up wave {w['wave']}: {w['prompt_len']} prompt "
              f"tokens; time to first token {w['ttft_s'] * 1e3:.3f} ms")
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    eng, res, wall = serve(check_logits=True)
    counts = {k.__name__: k.launches for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _check(sorted(res) == list(range(len(prompts))),
           f"config E1: served {sorted(res)}")
    _check(all(len(r.tokens) == E_NEW_TOKENS for r in res.values()),
           "config E1: a request did not get its tokens")
    _check(bool(torch.stack(finite).all()), "config E1: a logit is not "
           "finite")
    _check(all(res[u].tokens == first[u].tokens for u in res),
           "config E1: the same requests served again gave other tokens")
    want = cfg.num_layers * len(set(E_PROMPTS))
    _check(counts["linear_scan_chunked"] == want,
           f"config E1 launched linear_scan_chunked "
           f"{counts['linear_scan_chunked']} times, not {want}")
    n_tok = sum(len(r.tokens) for r in res.values())
    for w in eng.stats()["wave_log"]:
        print(f"config E1 wave {w['wave']}: {w['requests']} requests x "
              f"{w['prompt_len']} prompt tokens; time to first token "
              f"{w['ttft_s'] * 1e3:.3f} ms; {w['decode_steps']} decode steps "
              f"{w['decode_s'] / max(1, w['decode_steps']) * 1e3:.3f} ms each")
    busy = _device_busy_share(lambda: serve())
    print(f"config E1: {n_tok} tokens in {wall:.4f} s = {n_tok / wall:.2f} "
          f"generated tokens/s; peak memory allocated {peak_gb:.3f} GB; "
          f"launches {counts}; device busy {busy} of a served run; "
          f"tokens of uid 0: {res[0].tokens[:8]}...")

    # the served prefill of each wave alone, least of 3, and where its device
    # time goes (the scan kernel masks the ragged wave's last chunk); then
    # the same in the JAX package's chunk of 64 (finite at these random
    # weights), which rwkv6 gave up for training's decays: what the chunk
    # of 8 costs a prefill, within one call
    from repro_torch.models.transformer import rwkv6 as R6
    lm = LM(cfg)
    served_chunk = R6._CHUNK
    for chunk in (served_chunk, 64):
        R6._CHUNK = chunk
        try:
            for plen, (wave_prompts, _) in sorted(first_logits.items()):
                batch = {"tokens": torch.tensor(wave_prompts, device="cuda")}

                def prefill():
                    with torch.no_grad():
                        lm.prefill(p_gpu, batch, max_seq=512)
                times = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    prefill()
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                busy = _device_busy_share(prefill,
                                          parts=("linear_scan_kernel",))
                print(f"config E1 prefill alone, {len(wave_prompts)} x "
                      f"{plen} tokens, scan chunk {chunk}"
                      f"{'' if chunk == served_chunk else ' (not served)'}: "
                      f"{min(times) * 1e3:.3f} ms (least of 3; "
                      f"{[round(x * 1e3, 3) for x in times]}); device busy "
                      f"{busy}")
        finally:
            R6._CHUNK = served_chunk

    # the ragged wave's served prefill against the CPU's in the same config,
    # one layer at a time: each layer on the card takes the CPU's input to
    # it, so a comparison holds one layer's f32 sums in another order.  End
    # to end the 24 layers compound that (GroupNorm over a near-constant
    # head divides by ~sqrt(eps)): the served logits' distance from the
    # CPU's is printed, not gated (PERF.md, PR 13)
    from repro_torch.models.transformer import blocks as B
    wave_prompts, served = first_logits[min(E_PROMPTS)]
    toks = torch.tensor(wave_prompts)
    worst_e1 = []
    layer_check = lambda what, gpu, cpu: _close_to_cpu("E1", what, gpu, cpu,
                                                       worst_e1)

    with torch.no_grad():
        h = lm._embed(p_cpu, {"tokens": toks})
        layer_check("embedding", lm._embed(p_gpu, {"tokens": toks.cuda()}),
                    h)
        for n, (group, key, kind, idx) in enumerate(lm._layers()):
            out_g, st_g, _ = B.block_prefill(
                kind, lm._layer_params(p_gpu, group, key, idx), h.cuda(),
                cfg, 512)
            out_c, st_c, _ = B.block_prefill(
                kind, lm._layer_params(p_cpu, group, key, idx), h, cfg, 512)
            layer_check(f"layer {n} output", out_g, out_c)
            for name in st_c:
                layer_check(f"layer {n} state {name}", st_g[name],
                            st_c[name])
            h = out_c
        cpu_logits = lm._head(p_cpu, h[:, -1])
        layer_check("logits", lm._head(p_gpu, h[:, -1].cuda()), cpu_logits)
        # the same wave in the f32 config, end to end: how far the
        # compounding goes without the bf16 rounding of the embeddings
        lm32 = LM(dataclasses.replace(cfg, dtype="float32"))
        g32, _ = lm32.prefill(p_gpu, {"tokens": toks.cuda()}, max_seq=512)
        c32, _ = lm32.prefill(p_cpu, {"tokens": toks}, max_seq=512)
    worst_e1.sort(reverse=True)
    e2e = float((served.float() - cpu_logits).abs().max())
    e2e32 = float((g32.cpu() - c32).abs().max())
    print(f"config E1: the served {cfg.dtype} prefill of the "
          f"{len(wave_prompts)} x {min(E_PROMPTS)} wave, card vs CPU layer "
          f"by layer: {len(worst_e1)} comparisons, worst {worst_e1[0][1]} "
          f"{worst_e1[0][2]:.3e} ({worst_e1[0][0]:.3f} of its tolerance); "
          f"end to end, max |card - cpu| of the logits: served "
          f"{e2e:.3e} of max |cpu| {float(cpu_logits.abs().max()):.3f}, "
          f"the f32 config {e2e32:.3e} of {float(c32.abs().max()):.3f}")

    # ---- E3: the same requests through the slot scheduler: a batch-1
    # prefill per admitted request (one scan launch per layer each), the
    # pool of 4 slots decoding together
    eng3 = ServingEngine(cfg, params=p_gpu, batch_size=4, max_seq=512,
                         scheduler="slot")
    for k in kernels:
        k.launches = 0
    for uid, prompt in enumerate(prompts):
        eng3.submit(Request(uid=uid, prompt=prompt,
                            max_new_tokens=E_NEW_TOKENS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res3 = {r.uid: r for r in eng3.run()}
    torch.cuda.synchronize()
    wall3 = time.perf_counter() - t0
    counts3 = {k.__name__: k.launches for k in kernels}
    want = cfg.num_layers * len(prompts)
    _check(counts3["linear_scan_chunked"] == want,
           f"config E3 launched linear_scan_chunked "
           f"{counts3['linear_scan_chunked']} times, not {want}")
    same = [u for u in res if res3[u].tokens == res[u].tokens]
    for u in res:
        if res3[u].tokens != res[u].tokens:
            at = next(i for i, (a, b) in enumerate(zip(res3[u].tokens,
                                                        res[u].tokens))
                      if a != b)
            print(f"config E3 uid {u}: slot tokens leave the wave's at "
                  f"token {at}: {res3[u].tokens[:at + 2]} vs "
                  f"{res[u].tokens[:at + 2]}")
    _check(len(same) == len(res), f"config E3: {len(res) - len(same)} of "
           f"{len(res)} requests got other tokens than E1's wave")
    st3 = eng3.stats()
    n_tok3 = sum(len(r.tokens) for r in res3.values())
    print(f"config E3: slot scheduler, {n_tok3} tokens in {wall3:.4f} s = "
          f"{n_tok3 / wall3:.2f} generated tokens/s; {st3['steps']} pool "
          f"steps, occupancy {st3['occupancy_mean']:.3f}, prefill buckets "
          f"{st3['prefill_lens_compiled']}; launches {counts3}; tokens equal "
          f"E1's wave for all {len(res)} requests")

    # ---- E2: the card against the CPU, f32, batch 1, teacher-forced
    model = LM(dataclasses.replace(cfg, dtype="float32"))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 77)))
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (E_DECODE_STEPS, 1)))
    worst = []
    compare = lambda what, gpu, cpu: _close_to_cpu("E2", what, gpu, cpu,
                                                   worst)

    t0 = time.perf_counter()
    with torch.no_grad():
        lg, sg = model.prefill(p_gpu, {"tokens": toks.cuda()}, max_seq=512)
        lc, sc = model.prefill(p_cpu, {"tokens": toks}, max_seq=512)
        compare("prefill logits", lg, lc)
        for entry, g_tree in sg["units"].items():    # (n_units, count, …)
            for name, g in g_tree.items():
                c = sc["units"][entry][name]
                for layer, (a, b) in enumerate(zip(g.flatten(0, 1),
                                                   c.flatten(0, 1))):
                    compare(f"units/{entry} layer {layer} {name}", a, b)
        for step in range(E_DECODE_STEPS):
            lg, sg = model.decode_step(p_gpu, sg, feed[step].cuda(),
                                       77 + step, max_seq=512)
            lc, sc = model.decode_step(p_cpu, sc, feed[step], 77 + step,
                                       max_seq=512)
            compare(f"decode step {step} logits", lg, lc)
    worst.sort(reverse=True)
    print(f"config E2: card vs CPU, f32, {len(worst)} comparisons in "
          f"{time.perf_counter() - t0:.1f} s; worst {worst[0][1]} "
          f"{worst[0][2]:.3e} ({worst[0][0]:.3f} of its tolerance)")
    return counts, counts3


def _host_ram() -> str:
    """The machine's RAM and what is available of it, from /proc/meminfo."""
    try:
        with open("/proc/meminfo") as f:
            info = dict(line.split(":", 1) for line in f)
        gib = lambda key: int(info[key].split()[0]) / 2 ** 20
        return (f"{gib('MemTotal'):.1f} GiB, {gib('MemAvailable'):.1f} GiB "
                f"available")
    except (OSError, KeyError, ValueError):
        return "not read"


def _serve_lm(cfg, params, prompts, max_seq: int, kernels,
              scheduler: str = "wave", gather: dict | None = None,
              order=None, batch_size: int = 4) -> dict:
    """Serve ``prompts`` (uid = index, greedy, E_NEW_TOKENS new tokens
    each) through ``ServingEngine`` on the card, ``batch_size`` 4, the launch
    counts set to 0 just before ``run()`` and read just after.  The wave
    scheduler's sampled logits are checked finite; the slot scheduler's
    admits (prefill + first token) and pool steps are timed.  With
    ``gather``, each request's logits row from which its token ``t`` is
    sampled goes to ``gather[(uid, t)]``, copied to the host so the peak
    device memory stays the serve's own.  ``order``: the uids in the
    order they are submitted (default: by uid).  Returns the engine,
    ``{uid: result}``, wall s, launches, the logits' finiteness, the peak
    device memory (GB) and the slot times (s)."""
    import torch
    from repro_torch.serving.engine import Request, ServingEngine

    eng = ServingEngine(cfg, params=params, batch_size=batch_size,
                        max_seq=max_seq, scheduler=scheduler)
    finite = []
    times = {"admit": [], "step": []}
    backend = eng.backend
    if scheduler == "wave":
        sample = backend._sample

        def checked(logits, wave, step):
            finite.append(torch.isfinite(logits).all())
            if gather is not None:
                for i, r in enumerate(wave):
                    gather[(r.uid, step)] = logits[i].cpu()
            return sample(logits, wave, step)
        backend._sample = checked
    else:
        if gather is not None:
            # rows of the next prefill / decode: (uid, token index, row)
            rows = []
            admit, step, lm = backend.admit, backend.step, backend.model

            def gathered(fn):
                def run(*a, **kw):
                    out = fn(*a, **kw)
                    for uid, t, i in rows:
                        gather[(uid, t)] = out[0][i].cpu()
                    return out
                return run

            def admitting(slot, req):
                rows[:] = [(req.uid, 0, 0)]
                return admit(slot, req)

            def stepping():
                rows[:] = [(e["req"].uid, int(backend._steps[i]), i)
                           for i, e in enumerate(backend._slots)
                           if e is not None]
                return step()
            class Gathering:                  # the LM with gathered logits
                prefill = staticmethod(gathered(lm.prefill))
                decode_step = staticmethod(gathered(lm.decode_step))

                def __getattr__(self, name):
                    return getattr(lm, name)
            backend.model = Gathering()
            backend.admit, backend.step = admitting, stepping
        def timed(fn, key):
            def run(*a):
                t0 = time.perf_counter()
                out = fn(*a)
                torch.cuda.synchronize()
                times[key].append(time.perf_counter() - t0)
                return out
            return run
        eng.backend.admit = timed(eng.backend.admit, "admit")
        eng.backend.step = timed(eng.backend.step, "step")
    for uid in order or range(len(prompts)):
        eng.submit(Request(uid=uid, prompt=list(prompts[uid]),
                           max_new_tokens=E_NEW_TOKENS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in kernels}
    return {"engine": eng, "res": {r.uid: r for r in res}, "wall": wall,
            "counts": counts,
            "finite": bool(torch.stack(finite).all()) if finite else None,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "times": times}


def _served_gates(label: str, run: dict, n: int, launches: dict) -> None:
    """Every request served with its tokens, every gathered logit finite,
    each kernel launched exactly as ``launches`` says (0 elsewhere)."""
    res = run["res"]
    _check(sorted(res) == list(range(n)), f"config {label}: served "
           f"{sorted(res)}")
    _check(all(len(r.tokens) == E_NEW_TOKENS for r in res.values()),
           f"config {label}: a request did not get its tokens")
    _check(run["finite"] is not False, f"config {label}: a logit is not "
           "finite")
    for name, got in run["counts"].items():
        want = launches.get(name, 0)
        _check(got == want, f"config {label} launched {name} {got} times, "
               f"not {want}")


def _interleaved(n: int) -> list:
    """Uids 0, n/2, 1, n/2 + 1, ...: the two halves of E's and G's
    prompts (two lengths) alternate, so a slot pool holds both at once."""
    return [u for pair in zip(range(n // 2), range(n // 2, n))
            for u in pair]


def _same_logits(label: str, got: dict, want: dict, of: str) -> None:
    """Every request's sampled logits, token by token, within LM_TOL ×
    max(1, max|want|) of ``want``'s: the slot pool's rows, each at its own
    position, against the wave path's."""
    _check(sorted(got) == sorted(want), f"config {label}: logits of "
           f"{len(got)} (request, token) pairs, {of} {len(want)}")
    worst, at = 0.0, None
    for key, ref in want.items():
        tol = LM_TOL * max(1.0, float(ref.abs().max()))
        r = float((got[key] - ref).abs().max()) / tol
        if r >= worst:
            worst, at = r, key
    print(f"config {label}: {len(want)} sampled logits rows against "
          f"{of}, the worst (uid, token) {at} at {worst:.4f} of "
          f"LM_TOL x max(1, max|ref|)")
    _check(worst <= 1.0, f"config {label}: (uid, token) {at} logits "
           f"{worst:.3f} x the tolerance from {of}'s")


def _same_tokens(label: str, got: dict, want: dict, of: str) -> None:
    for u in want:
        if got[u].tokens != want[u].tokens:
            at = next((i for i, (a, b) in enumerate(zip(got[u].tokens,
                                                         want[u].tokens))
                       if a != b), 0)
            print(f"config {label} uid {u}: tokens leave {of}'s at token "
                  f"{at}: {got[u].tokens[:at + 2]} vs {want[u].tokens[:at + 2]}")
    same = sum(got[u].tokens == want[u].tokens for u in want)
    _check(same == len(want), f"config {label}: {len(want) - same} of "
           f"{len(want)} requests got other tokens than {of}'s")


def _print_wave_metrics(label: str, run: dict, busy: str, card: str) -> None:
    """TTFT and ms per decode step of each wave, tokens/s, peak memory
    and the busy share of a profiled wave, beside the card."""
    for w in run["engine"].stats()["wave_log"]:
        print(f"config {label} wave {w['wave']}: {w['requests']} requests x "
              f"{w['prompt_len']} prompt tokens; time to first token "
              f"{w['ttft_s'] * 1e3:.3f} ms; {w['decode_steps']} decode steps "
              f"{w['decode_s'] / max(1, w['decode_steps']) * 1e3:.3f} ms each "
              f"({card})")
    n_tok = sum(len(r.tokens) for r in run["res"].values())
    print(f"config {label}: {n_tok} tokens in {run['wall']:.4f} s = "
          f"{n_tok / run['wall']:.2f} generated tokens/s; peak memory "
          f"allocated {run['peak_gb']:.3f} GB; launches {run['counts']}; "
          f"tokens of uid 0: {run['res'][0].tokens[:8]}...; device busy "
          f"{busy} ({card})")


def _print_slot_metrics(label: str, run: dict, busy: str, card: str) -> None:
    """The slot path's time to first token (each admit: prefill and first
    sample), ms per pool step, tokens/s, peak memory and busy share."""
    st, t = run["engine"].stats(), run["times"]
    n_tok = sum(len(r.tokens) for r in run["res"].values())
    print(f"config {label}: slot scheduler, {n_tok} tokens in "
          f"{run['wall']:.4f} s = {n_tok / run['wall']:.2f} generated "
          f"tokens/s; time to first token (admit) "
          f"{[round(x * 1e3, 3) for x in t['admit']]} ms; {len(t['step'])} "
          f"pool steps {sum(t['step']) / len(t['step']) * 1e3:.3f} ms each "
          f"(least {min(t['step']) * 1e3:.3f}); occupancy "
          f"{st['occupancy_mean']:.3f}; prefill bucket {st['prefill_bucket']} "
          f"{st['prefill_lens_compiled']}; peak memory allocated "
          f"{run['peak_gb']:.3f} GB; launches {run['counts']}; device busy "
          f"{busy} ({card})")


def _layers_vs_cpu(label: str, lm, p_gpu, p_cpu, batch: dict, max_seq: int,
                   feed=None, causal: bool = True, rtol: float = LM_TOL,
                   kernels=()) -> dict:
    """The prefill of ``batch`` (CPU tensors: ``tokens``, and a vision
    config's ``patches``; with ``feed`` (steps, B), that many
    teacher-forced decode steps after it) on the card against the CPU, one
    layer at a time: each layer on the card takes the CPU's input to it
    and, in decode, the CPU's state.  Each output, the logits and every
    state leaf within ``rtol`` × max(1, max|cpu|); each cache's positions
    exactly; an int8 cache's codes after dequantization within one
    quantization step (a ~1e-7 difference in k can flip a rounding).
    ``causal=False``: the encoder's ``block_forward`` (an audio batch's
    ``frames`` and ``mask_positions``), every row's logits, no decode.
    A frontend's embedding in a bfloat16 config (the patch projector runs
    in bf16) is held to BF16_TOL; each layer then takes the CPU's rows.
    An MoE layer's routing is recorded on both sides: a token routed
    otherwise on the card must be a near tie (ROUTE_TIE) or the capacity
    shift one causes (``moe.routing_differences``); its rows are counted,
    printed and left out of that layer's output, the rest held to the
    gate.  End to end the card's own chain is printed, not gated
    (ROADMAP.md Queue 3, quirk 5).  Returns the launch counts of
    ``kernels``, set to 0 just before and read just after."""
    import torch
    from repro_torch.models.transformer import blocks as B
    from repro_torch.models.transformer import moe as MOE
    from repro_torch.utils.pytree import tree_map

    cfg = lm.cfg
    worst = []
    n_exact = 0
    int8 = []        # (share of codes differing, max |dequantized diff|)
    flips = []       # (what, tokens routed otherwise, tokens)
    dprobs = []      # max |card - cpu| router probability, alike tokens
    check = lambda what, gpu, cpu: _close_to_cpu(label, what, gpu, cpu, worst,
                                                 rtol)
    routes, route = [], MOE.route

    def recording(*args, **kw):
        routes.append(route(*args, **kw))
        return routes[-1]

    def check_out(what, out_g, out_c):
        """A layer's output; an MoE layer's on the tokens routed alike."""
        if not routes:
            return check(what, out_g, out_c)
        _check(len(routes) == 2, f"config {label} {what}: {len(routes)} "
               "MoE routings recorded, not 2")
        rg = MOE.Routing(*(x.cpu() if torch.is_tensor(x) else x
                           for x in routes[0]))
        rc = routes[1]
        routes.clear()
        differ, unexplained = MOE.routing_differences(rc, rg, ROUTE_TIE)
        _check(not bool(unexplained.any()), f"config {label} {what}: "
               f"{int(unexplained.sum())} tokens routed otherwise on the "
               f"card without a near tie (gap > {ROUTE_TIE}) or its "
               "capacity shift")
        alike = ~differ.reshape(-1)
        flips.append((what, int(differ.sum()), differ.numel()))
        dprobs.append(float((rg.probs - rc.probs).reshape(
            -1, rc.probs.shape[-1])[alike].abs().max()))
        d = out_c.shape[-1]
        check(what, out_g.reshape(-1, d)[alike.cuda()],
              out_c.reshape(-1, d)[alike])

    def check_state(what, st_g, st_c):
        nonlocal n_exact
        for name, c in st_c.items():
            g = st_g[name].cpu()
            if name == "pos":
                _check(torch.equal(g, c), f"config {label} {what} pos: the "
                       "card's positions differ from the CPU's")
                n_exact += 1
            elif c.dtype == torch.int8:
                # one step of the CPU's scale, plus what 127 codes carry of
                # the two scales' own difference (checked at LM_TOL)
                s_g = st_g[f"{name}_scale"].cpu()[..., None]
                s_c = st_c[f"{name}_scale"][..., None]
                err = (g.float() * s_g - c.float() * s_c).abs()
                bound = (s_c + 127 * (s_g - s_c).abs()) * (1 + 1e-6)
                _check(bool((err <= bound).all()), f"config {label} {what} "
                       f"{name}: dequantized codes more than one step apart")
                int8.append((float((g != c).float().mean()),
                             float(err.max())))
            else:
                check(f"{what} state {name}", g, c)

    to_gpu = lambda tree: tree_map(lambda x: x.cuda(), tree)
    layers = list(lm._layers())
    steps = 0 if feed is None else feed.shape[0]
    t0 = time.perf_counter()
    for k in kernels:
        k.launches = 0
    MOE.route = recording
    try:
        with torch.no_grad():
            h = lm._embed(p_cpu, batch)
            _close_to_cpu(label, "embedding", lm._embed(p_gpu, to_gpu(batch)),
                          h, worst, BF16_TOL if cfg.frontend and
                          cfg.dtype == "bfloat16" else rtol)
            plen = h.shape[1]                   # a vision prefix counted
            emb0, emb0_g = h, h.cuda()     # what a shared block concatenates
            states = []
            for n, (group, key, kind, idx) in enumerate(layers):
                lp_g = lm._layer_params(p_gpu, group, key, idx)
                lp_c = lm._layer_params(p_cpu, group, key, idx)
                if causal:
                    out_g, st_g, _ = B.block_prefill(
                        kind, lp_g, h.cuda(), cfg, max_seq, emb0=emb0_g)
                    out_c, st_c, _ = B.block_prefill(
                        kind, lp_c, h, cfg, max_seq, emb0=emb0)
                    check_state(f"prefill layer {n} ({kind})", st_g, st_c)
                    states.append(st_c)
                else:
                    out_g, _ = B.block_forward(kind, lp_g, h.cuda(), cfg,
                                               causal=False)
                    out_c, _ = B.block_forward(kind, lp_c, h, cfg,
                                               causal=False)
                check_out(f"prefill layer {n} ({kind}) output", out_g, out_c)
                h = out_c
            last = slice(None) if not causal else -1
            cpu_logits = [lm._head(p_cpu, h[:, last])]
            check("prefill logits", lm._head(p_gpu, h[:, last].cuda()),
                  cpu_logits[0])
            for step in range(steps):
                h = lm._embed_tokens(p_cpu, feed[step])[:, None]
                emb0, emb0_g = h, h.cuda()
                for n, (group, key, kind, idx) in enumerate(layers):
                    out_g, st_g = B.block_decode(
                        kind, lm._layer_params(p_gpu, group, key, idx),
                        h.cuda(), cfg, to_gpu(states[n]), plen + step,
                        max_seq, emb0=emb0_g)
                    out_c, st_c = B.block_decode(
                        kind, lm._layer_params(p_cpu, group, key, idx), h,
                        cfg, states[n], plen + step, max_seq, emb0=emb0)
                    what = f"decode step {step} layer {n} ({kind})"
                    check_out(f"{what} output", out_g, out_c)
                    check_state(what, st_g, st_c)
                    states[n] = st_c
                    h = out_c
                cpu_logits.append(lm._head(p_cpu, h[:, 0]))
                check(f"decode step {step} logits",
                      lm._head(p_gpu, h[:, 0].cuda()), cpu_logits[-1])
            # the card's own chain, end to end
            if causal:
                lg, sg = lm.prefill(p_gpu, to_gpu(batch), max_seq=max_seq)
            else:
                lg, _ = lm.forward(p_gpu, to_gpu(batch))
            e2e = [float((lg.cpu().float() - cpu_logits[0].float()).abs()
                         .max())]
            for step in range(steps):
                lg, sg = lm.decode_step(p_gpu, sg, feed[step].cuda(),
                                        plen + step, max_seq=max_seq)
                e2e.append(float((lg.cpu() - cpu_logits[step + 1]).abs()
                                 .max()))
        torch.cuda.synchronize()
    finally:
        MOE.route = route
    counts = {k.__name__: k.launches for k in kernels}
    worst.sort(reverse=True)
    shape = f"{h.shape[0]}x{plen}"
    print(f"config {label}: card vs CPU, {cfg.dtype} config, a {shape} "
          f"{'prefill' if causal else 'bidirectional forward'} + {steps} "
          f"teacher-forced decode steps, layer by layer: "
          f"{len(worst) + n_exact} comparisons ({n_exact} position leaves "
          f"exact) in {time.perf_counter() - t0:.1f} s; worst {worst[0][1]} "
          f"{worst[0][2]:.3e} ({worst[0][0]:.3f} of its tolerance, {rtol} x "
          f"max(1, max|cpu|)); end to end, max |card - cpu| of the logits "
          f"(prefill, then each decode step): {[f'{x:.3e}' for x in e2e]} "
          f"of max |cpu| {float(cpu_logits[0].float().abs().max()):.3f}; "
          f"launches {counts}")
    if int8:
        print(f"config {label}: int8 caches, {len(int8)} code leaves: at "
              f"most {max(f for f, _ in int8):.3e} of the codes differ "
              f"between card and CPU; max |dequantized card - cpu| "
              f"{max(e for _, e in int8):.3e}")
    if flips:
        print(f"config {label}: MoE routing, card vs CPU, tokens routed "
              f"otherwise (near ties within {ROUTE_TIE} and their capacity "
              f"shifts) per layer and step: "
              f"{[n for _, n, _ in flips]} of "
              f"{sorted({t for _, _, t in flips})} tokens, "
              f"{sum(n for _, n, _ in flips)} in all; max |card - cpu| "
              f"router probability of the tokens routed alike "
              f"{max(dprobs):.3e}")
    return counts


def _config_z(kernels, card: str) -> tuple:
    """Config Z: zamba2-7b at full width (81 layers: 68 Mamba2 blocks and
    13 applications of the one shared attention block), random f32 weights
    drawn once on the CPU and copied to the card; the CPU copy serves Z2.
    Z1 serves E's 8 requests through ``ServingEngine`` in the config's
    bfloat16 (embedding rows rounded, layers in f32); Z2 holds the card
    against the CPU layer by layer, prefill and 4 teacher-forced decode
    steps; Z3 holds prefill + one decode step against the longer prefill;
    Z-slot serves Z1's requests through the slot scheduler.  Returns Z1's
    and Z-slot's launch counts."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer.model import LM
    from repro_torch.utils.pytree import tree_leaves, tree_map

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("zamba2-7b")
    lm = LM(cfg)
    n_mamba = cfg.layer_plan().count("mamba2")
    n_shared = cfg.layer_plan().count("shared_attn")
    print(f"config Z: host RAM {_host_ram()} before the draw")
    t0 = time.perf_counter()
    p_cpu = lm.init(Z_SEED, "cpu")           # one host copy, Z2's CPU side
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_gpu = tree_map(lambda x: x.cuda(), p_cpu)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(p_cpu))
    print(f"config Z: {cfg.name}, {cfg.num_layers} layers ({n_mamba} mamba2, "
          f"{n_shared} shared_attn applications of one set), d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, ssm {cfg.ssm}, {n_params} parameters (f32), "
          f"dtype {cfg.dtype}; init on the CPU {init_s:.1f} s, copy to the "
          f"card {time.perf_counter() - t0:.1f} s; host RAM {_host_ram()} "
          f"holding one host copy")

    # ---- Z1: serving through the engine, greedy, the bf16 config: the
    # first serve warms up and is the repeat check
    rng = np.random.default_rng(Z_SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in E_PROMPTS]
    warm = _serve_lm(cfg, p_gpu, prompts, Z_MAX_SEQ, kernels)
    for w in warm["engine"].stats()["wave_log"]:
        print(f"config Z1 warm-up wave {w['wave']}: {w['prompt_len']} prompt "
              f"tokens; time to first token {w['ttft_s'] * 1e3:.3f} ms")
    z1 = _serve_lm(cfg, p_gpu, prompts, Z_MAX_SEQ, kernels)
    _served_gates("Z1", z1, len(prompts),
                  {"linear_scan_chunked": n_mamba * len(set(E_PROMPTS))})
    _same_tokens("Z1", z1["res"], warm["res"], "the first serve")
    busy = _device_busy_share(lambda: _serve_lm(cfg, p_gpu, prompts[4:],
                                                Z_MAX_SEQ, ()))
    _print_wave_metrics("Z1", z1, f"{busy} of the {min(E_PROMPTS)}-token "
                        "wave served alone", card)

    # ---- Z2: one 77-token prompt at batch 1, the card against the CPU
    # layer by layer: the conv tail and h of each Mamba2 block, the K/V
    # cache and positions of each shared application
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (E_DECODE_STEPS, 1)))
    _layers_vs_cpu("Z2", lm, p_gpu, p_cpu,
                   {"tokens": torch.tensor([prompts[-1]])},
                   Z_MAX_SEQ, feed)

    # ---- Z3: prefill(x[:T]) + decode_step(x[T]) == prefill(x[:T+1])[-1]
    # on the card: the shared caches, the conv tails and the scan states
    # carried together
    for t in Z3_LENGTHS:
        x = torch.tensor([prompts[0][:t + 1]], device="cuda")
        with torch.no_grad():
            _, st = lm.prefill(p_gpu, {"tokens": x[:, :t]}, max_seq=Z_MAX_SEQ)
            got, _ = lm.decode_step(p_gpu, st, x[:, t], t, max_seq=Z_MAX_SEQ)
            want, _ = lm.prefill(p_gpu, {"tokens": x}, max_seq=Z_MAX_SEQ)
        err = float((got - want).abs().max())
        tol = SCAN_TOL * max(1.0, float(want.abs().max()))
        _check(math.isfinite(err) and err <= tol,
               f"config Z3: prefill({t}) + decode vs prefill({t + 1}): max "
               f"|diff| {err} > {tol}")
        print(f"config Z3: prefill({t}) + 1 decode step vs prefill({t + 1})"
              f": max |diff| of the logits {err:.3e} (tolerance {tol:.3e})")

    # ---- Z-slot: Z1's requests through the slot scheduler, 4 slots, each
    # decoding at its own position (13 shared caches per slot); a batch-1
    # prefill per request (exact buckets: the scan folds pads in), so
    # exactly 68 scan launches each
    del p_cpu
    gc.collect()
    zs = _serve_lm(cfg, p_gpu, prompts, Z_MAX_SEQ, kernels, scheduler="slot")
    _served_gates("Z-slot", zs, len(prompts),
                  {"linear_scan_chunked": n_mamba * len(prompts)})
    _same_tokens("Z-slot", zs["res"], z1["res"], "Z1's waves")
    _check(zs["engine"].stats()["prefill_bucket"] == "exact",
           "config Z-slot: the slot backend did not pick exact buckets")
    busy = _device_busy_share(lambda: _serve_lm(
        cfg, p_gpu, prompts[4:], Z_MAX_SEQ, (), scheduler="slot"))
    _print_slot_metrics("Z-slot", zs, f"{busy} of the 4 x "
                        f"{min(E_PROMPTS)}-token requests served alone",
                        card)
    return z1["counts"], zs["counts"]


def _draw(cfg, seed: int, label: str) -> tuple:
    """Random f32 weights of ``cfg`` drawn once on the CPU and copied to
    the card: (model, CPU params, card params)."""
    import gc
    import torch
    from repro_torch.models.transformer.model import LM
    from repro_torch.utils.pytree import tree_leaves, tree_map

    gc.collect()
    torch.cuda.empty_cache()
    lm = LM(cfg)
    t0 = time.perf_counter()
    p_cpu = lm.init(seed, "cpu")
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_gpu = tree_map(lambda x: x.cuda(), p_cpu)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(p_cpu))
    kinds = cfg.layer_plan()
    print(f"config {label}: {cfg.name}, {cfg.num_layers} layers "
          f"({', '.join(f'{kinds.count(k)} {k}' for k in sorted(set(kinds)))}"
          f"), d_model {cfg.d_model}, {cfg.num_heads} heads / "
          f"{cfg.num_kv_heads} KV heads of {cfg.resolved_head_dim}, d_ff "
          f"{cfg.d_ff} ({cfg.act}), window {cfg.sliding_window}, qk_norm "
          f"{cfg.qk_norm}, softcap {cfg.logit_softcap}, KV cache "
          f"{cfg.kv_cache_dtype or cfg.dtype}, vocab {cfg.vocab_size}, "
          f"moe {cfg.moe}, frontend {cfg.frontend} ({cfg.frontend_dim} x "
          f"{cfg.num_prefix_tokens} prefix), encoder_only {cfg.encoder_only}"
          f", {n_params} parameters (f32), dtype {cfg.dtype}; init on the CPU "
          f"{init_s:.1f} s, copy to the card {time.perf_counter() - t0:.1f} "
          f"s; host RAM {_host_ram()}")
    return lm, p_cpu, p_gpu


def _config_g(kernels, card: str) -> dict:
    """Config G: gemma3-1b uncut (26 layers: 5 ``swa`` + 1 ``full`` per
    unit, 4 units and 2 ``swa``; MQA, ``qk_norm``, window 512, tied
    262,144-row embedding), ``max_seq`` 1024.  G1 serves 8 requests (640
    and 77 prompt tokens, 32 new) in two waves; G2 holds the 640-token
    wave's prefill and 4 decode steps against the CPU layer by layer; G3
    serves G1's requests through the slot scheduler.  Returns the launch
    counts of G1 and G3."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    cfg = get_config("gemma3-1b")
    lm, p_cpu, p_gpu = _draw(cfg, G_SEED, "G")
    rng = np.random.default_rng(G_SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in G_PROMPTS]

    # ---- G1: the wave scheduler; no hand-written kernel on this path
    wave_rows = {}
    first = _serve_lm(cfg, p_gpu, prompts, G_MAX_SEQ, kernels,
                      gather=wave_rows)
    g1 = _serve_lm(cfg, p_gpu, prompts, G_MAX_SEQ, kernels)
    _served_gates("G1", g1, len(prompts), {})
    _same_tokens("G1", g1["res"], first["res"], "the first serve")
    busy = _device_busy_share(lambda: _serve_lm(cfg, p_gpu, prompts[:4],
                                                G_MAX_SEQ, ()))
    _print_wave_metrics("G1", g1, f"{busy} of the 4 x {G_PROMPTS[0]}-token "
                        "wave served alone", card)

    # ---- G2: the 640-token wave, card vs CPU layer by layer; the rings
    # (512 slots) wrap in prefill and in decode
    toks = torch.tensor(prompts[:4])
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (E_DECODE_STEPS, 4)))
    _layers_vs_cpu("G2", lm, p_gpu, p_cpu, {"tokens": toks}, G_MAX_SEQ,
                   feed)

    # ---- G3: the slot scheduler; the 512-token rings are shorter than
    # max_seq, so the buckets stay exact; submitted 640, 77, 640, ... so
    # the pool holds both lengths at once, each row at its own position
    # (the 640-token rows' rings wrapped), held against the wave path's
    # logits
    slot_rows = {}
    g3 = _serve_lm(cfg, p_gpu, prompts, G_MAX_SEQ, kernels, scheduler="slot",
                   gather=slot_rows, order=_interleaved(len(prompts)))
    _served_gates("G3", g3, len(prompts), {})
    _check(g3["engine"].stats()["prefill_bucket"] == "exact",
           "config G3: the buckets are not exact")
    _same_tokens("G3", g3["res"], g1["res"], "G1's waves")
    _same_logits("G3", slot_rows, wave_rows, "G1's waves")
    del slot_rows, wave_rows
    _print_slot_metrics("G3", g3, "not profiled", card)
    return {"G1": g1["counts"], "G3": g3["counts"]}


def _config_h(kernels, card: str) -> dict:
    """Config H: h2o-danube-3-4b uncut (24 ``swa`` layers, GQA 32/8, head
    120, window 4096), E's requests, ``max_seq`` 256.  H1 the wave
    scheduler; H2 the slot scheduler, which must pick pow2 buckets (the
    window covers ``max_seq``): the 77-token prompts prefill padded to
    128, the 192-token ones to 256, and the tokens and sampled logits
    must be H1's; H3 the 77-token wave's prefill against the CPU layer by
    layer.  Returns the launch counts of H1 and H2."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    cfg = get_config("h2o-danube-3-4b")
    lm, p_cpu, p_gpu = _draw(cfg, H_SEED, "H")
    rng = np.random.default_rng(H_SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in E_PROMPTS]

    wave_rows = {}
    first = _serve_lm(cfg, p_gpu, prompts, H_MAX_SEQ, kernels,
                      gather=wave_rows)
    h1 = _serve_lm(cfg, p_gpu, prompts, H_MAX_SEQ, kernels)
    _served_gates("H1", h1, len(prompts), {})
    _same_tokens("H1", h1["res"], first["res"], "the first serve")
    busy = _device_busy_share(lambda: _serve_lm(cfg, p_gpu, prompts[:4],
                                                H_MAX_SEQ, ()))
    _print_wave_metrics("H1", h1, f"{busy} of the 4 x {E_PROMPTS[0]}-token "
                        "wave served alone", card)

    slot_rows = {}
    h2 = _serve_lm(cfg, p_gpu, prompts, H_MAX_SEQ, kernels, scheduler="slot",
                   gather=slot_rows, order=_interleaved(len(prompts)))
    _served_gates("H2", h2, len(prompts), {})
    st = h2["engine"].stats()
    _check(st["prefill_bucket"] == "pow2" and
           st["prefill_lens_compiled"] == [128, 256],
           f"config H2: prefill bucket {st['prefill_bucket']} "
           f"{st['prefill_lens_compiled']}, not pow2 [128, 256]")
    _same_tokens("H2", h2["res"], h1["res"], "H1's waves")
    _same_logits("H2", slot_rows, wave_rows, "H1's waves")
    del slot_rows, wave_rows
    _print_slot_metrics("H2", h2, "not profiled", card)

    _layers_vs_cpu("H3", lm, p_gpu, p_cpu,
                   {"tokens": torch.tensor(prompts[4:])},
                   H_MAX_SEQ)
    return {"H1": h1["counts"], "H2": h2["counts"]}


def _config_sc() -> None:
    """Config SC: starcoder2-15b at full width (d_model 6144, 48/4 GQA
    ``full`` attention, the non-gated GELU MLP of 24,576, vocab 49,152),
    cut to SC_LAYERS layers: one 77-token prompt and 4 teacher-forced
    decode steps, card against CPU layer by layer."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("starcoder2-15b"),
                              num_layers=SC_LAYERS)
    lm, p_cpu, p_gpu = _draw(cfg, 0, "SC")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (1, min(E_PROMPTS))))
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (E_DECODE_STEPS, 1)))
    _layers_vs_cpu("SC", lm, p_gpu, p_cpu, {"tokens": toks}, H_MAX_SEQ,
                   feed)


def _config_g4() -> None:
    """Config G4: gemma3-1b at full width cut to 2 layers (``swa``, then
    ``full``) with ``kv_cache_dtype="int8"`` and ``logit_softcap=50``:
    G's 640-token prompts (the ring wraps) and 4 decode steps, card
    against CPU layer by layer, the int8 codes after dequantization within
    one quantization step."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(
        get_config("gemma3-1b"), num_layers=2, n_units=1, remainder=(),
        pattern=(("swa", 1), ("full", 1)), kv_cache_dtype="int8",
        logit_softcap=50.0)
    lm, p_cpu, p_gpu = _draw(cfg, G_SEED, "G4")
    rng = np.random.default_rng(G_SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (4, G_PROMPTS[0])))
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (E_DECODE_STEPS, 4)))
    _layers_vs_cpu("G4", lm, p_gpu, p_cpu, {"tokens": toks}, G_MAX_SEQ,
                   feed)


def _no_launches(label: str, counts: dict) -> None:
    _check(not any(counts.values()), f"config {label} launched {counts}, "
           "not 0")


def _first_layers(lm, params: dict, n: int) -> tuple:
    """The model cut to its first ``n`` layers (one-layer pattern) and
    views of those layers' parameters, embeddings and head: the same
    weights as ``params``' first ``n`` layers."""
    from repro_torch.models.transformer.model import LM
    from repro_torch.utils.pytree import tree_map

    cfg = dataclasses.replace(lm.cfg, num_layers=n)
    cut = {k: v for k, v in params.items() if k not in ("units", "rem")}
    cut["units"] = {"0": tree_map(lambda x: x[:n], params["units"]["0"])}
    cut["rem"] = {}
    return LM(cfg), cut


def _config_q(kernels, card: str) -> dict:
    """Config Q: qwen2-moe-a2.7b at full width cut to Q_LAYERS of its 24
    ``moe`` layers (MHA 16, 60 experts top-4 of 1408, 4 fused shared
    experts, vocab 151,936), random f32 weights drawn a layer at a time on
    the host into their stacks on the card (``LM.init(seed, "cuda")``: the
    host never holds the tree).  Q1 serves E's 8 requests through the wave
    scheduler twice: the same tokens.  Q2 serves them through the slot
    scheduler, which must pick exact buckets (padding moves an MoE's
    capacity), against a batch-1 wave (each prefill routed alone, as the
    slot's): its tokens and every sampled logits row at LM_TOL.  Q3 holds
    the first MOE_LAYERS layers' prefill of the 192-token wave and 4
    decode steps against the CPU, layer by layer, under the routing rule.
    Returns the launch counts."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer.model import LM
    from repro_torch.utils.pytree import tree_leaves, tree_map

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                              num_layers=Q_LAYERS)
    lm = LM(cfg)
    t0 = time.perf_counter()
    p_gpu = lm.init(Q_SEED, "cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(p_gpu))
    print(f"config Q: {cfg.name}, {cfg.num_layers} moe layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV "
          f"heads, {cfg.moe}, vocab {cfg.vocab_size}, {n_params} parameters "
          f"(f32, {torch.cuda.memory_allocated() / 1e9:.3f} GB on the card), "
          f"dtype {cfg.dtype}; drawn in {time.perf_counter() - t0:.1f} s; "
          f"host RAM {_host_ram()}")
    rng = np.random.default_rng(Q_SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in E_PROMPTS]

    # ---- Q1: the wave scheduler, twice; no hand-written kernel
    first = _serve_lm(cfg, p_gpu, prompts, Q_MAX_SEQ, kernels)
    q1 = _serve_lm(cfg, p_gpu, prompts, Q_MAX_SEQ, kernels)
    _served_gates("Q1", q1, len(prompts), {})
    _same_tokens("Q1", q1["res"], first["res"], "the first serve")
    busy = _device_busy_share(lambda: _serve_lm(cfg, p_gpu, prompts[4:],
                                                Q_MAX_SEQ, ()))
    _print_wave_metrics("Q1", q1, f"{busy} of the 4 x {min(E_PROMPTS)}"
                        "-token wave served alone", card)

    # ---- Q2: the slot scheduler (exact buckets; each pool row's token
    # routed alone) against a batch-1 wave: capacity depends on what
    # shares a prefill, so the batch-4 waves route otherwise
    wave_rows, slot_rows = {}, {}
    w1 = _serve_lm(cfg, p_gpu, prompts, Q_MAX_SEQ, kernels,
                   gather=wave_rows, batch_size=1)
    _served_gates("Q2 batch-1 wave", w1, len(prompts), {})
    q2 = _serve_lm(cfg, p_gpu, prompts, Q_MAX_SEQ, kernels, scheduler="slot",
                   gather=slot_rows, order=_interleaved(len(prompts)))
    _served_gates("Q2", q2, len(prompts), {})
    st = q2["engine"].stats()
    _check(st["prefill_bucket"] == "exact" and
           st["prefill_lens_compiled"] == sorted(set(E_PROMPTS)),
           f"config Q2: prefill bucket {st['prefill_bucket']} "
           f"{st['prefill_lens_compiled']}, not exact")
    _same_tokens("Q2", q2["res"], w1["res"], "a batch-1 wave")
    _same_logits("Q2", slot_rows, wave_rows, "a batch-1 wave")
    del slot_rows, wave_rows
    _print_wave_metrics("Q2 batch-1 wave", w1, "not profiled", card)
    _print_slot_metrics("Q2", q2, "not profiled", card)

    # ---- Q3: the first layers, card vs CPU under the routing rule
    lm3, p3_gpu = _first_layers(lm, p_gpu, MOE_LAYERS)
    p3_cpu = tree_map(lambda x: x.cpu(), p3_gpu)
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (E_DECODE_STEPS, 4)))
    q3 = _layers_vs_cpu("Q3", lm3, p3_gpu, p3_cpu,
                        {"tokens": torch.tensor(prompts[:4])}, Q_MAX_SEQ,
                        feed, kernels=kernels)
    _no_launches("Q3", q3)
    return {"Q1": q1["counts"], "Q2": q2["counts"], "Q2 wave": w1["counts"],
            "Q3": q3}


def _config_qw(kernels) -> dict:
    """Config QW: qwen3-moe-30b-a3b at full width (128 experts top-8 of
    768, GQA 32/4, head 128, ``qk_norm``) cut to MOE_LAYERS of its 48
    layers (uncut its 30.5 B f32 weights outgrow one card): E's 192-token
    wave's prefill and 4 decode steps against the CPU layer by layer,
    under the routing rule."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                              num_layers=MOE_LAYERS)
    lm, p_cpu, p_gpu = _draw(cfg, Q_SEED, "QW")
    rng = np.random.default_rng(Q_SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (4, E_PROMPTS[0])))
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (E_DECODE_STEPS, 4)))
    qw = _layers_vs_cpu("QW", lm, p_gpu, p_cpu, {"tokens": toks}, Q_MAX_SEQ,
                        feed, kernels=kernels)
    _no_launches("QW", qw)
    return {"QW": qw}


def _config_v(kernels, card: str) -> dict:
    """Config V: internvl2-2b uncut (24 ``full`` layers, GQA 16/8, d_ff
    8192, vocab 92,553; 256 patch tokens of 1024 values through the GELU
    projector before the prompt), E's requests at ``max_seq`` 512.  V1 the
    wave scheduler (zero patches, as the JAX package's backend passes),
    twice; V2 the slot scheduler with pow2 buckets [128, 256] after the
    prefix: V1's tokens and sampled logits; V3 the 77-token wave with
    random patches (zero ones test neither projector matrix), its prefill
    and 4 decode steps against the CPU layer by layer."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    cfg = get_config("internvl2-2b")
    lm, p_cpu, p_gpu = _draw(cfg, V_SEED, "V")
    rng = np.random.default_rng(V_SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in E_PROMPTS]

    wave_rows = {}
    first = _serve_lm(cfg, p_gpu, prompts, V_MAX_SEQ, kernels,
                      gather=wave_rows)
    v1 = _serve_lm(cfg, p_gpu, prompts, V_MAX_SEQ, kernels)
    _served_gates("V1", v1, len(prompts), {})
    _same_tokens("V1", v1["res"], first["res"], "the first serve")
    busy = _device_busy_share(lambda: _serve_lm(cfg, p_gpu, prompts[:4],
                                                V_MAX_SEQ, ()))
    _print_wave_metrics("V1", v1, f"{busy} of the 4 x {E_PROMPTS[0]}-token "
                        "wave served alone", card)

    slot_rows = {}
    v2 = _serve_lm(cfg, p_gpu, prompts, V_MAX_SEQ, kernels, scheduler="slot",
                   gather=slot_rows, order=_interleaved(len(prompts)))
    _served_gates("V2", v2, len(prompts), {})
    st = v2["engine"].stats()
    _check(st["prefill_bucket"] == "pow2" and
           st["prefill_lens_compiled"] == [128, 256],
           f"config V2: prefill bucket {st['prefill_bucket']} "
           f"{st['prefill_lens_compiled']}, not pow2 [128, 256]")
    _same_tokens("V2", v2["res"], v1["res"], "V1's waves")
    _same_logits("V2", slot_rows, wave_rows, "V1's waves")
    del slot_rows, wave_rows
    _print_slot_metrics("V2", v2, "not profiled", card)

    patches = torch.from_numpy(rng.standard_normal(
        (4, cfg.num_prefix_tokens, cfg.frontend_dim)).astype(np.float32))
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (E_DECODE_STEPS, 4)))
    v3 = _layers_vs_cpu("V3", lm, p_gpu, p_cpu,
                        {"tokens": torch.tensor(prompts[4:]),
                         "patches": patches}, V_MAX_SEQ, feed,
                        kernels=kernels)
    _no_launches("V3", v3)
    return {"V1": v1["counts"], "V2": v2["counts"], "V3": v3}


def _config_hb(kernels, card: str) -> dict:
    """Config HB: hubert-xlarge uncut (48 bidirectional ``full`` layers, d
    1280, MHA 16, the GELU MLP of 5120, a 504-way codebook head), its
    bfloat16 config, on HB_CLIPS clips of 10 s (500 frames of 512 values)
    with seeded ``mask_positions``: ``LM.forward`` on the card (finite
    bf16 logits, timed), and one clip layer by layer against the CPU at
    BF16_TOL."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.utils.pytree import tree_map

    cfg = get_config("hubert-xlarge")
    lm, p_cpu, p_gpu = _draw(cfg, HB_SEED, "HB")
    rng = np.random.default_rng(HB_SEED)
    batch = {"frames": torch.from_numpy(rng.standard_normal(
                 (HB_CLIPS, HB_FRAMES, cfg.frontend_dim)).astype(np.float32)),
             "mask_positions": torch.from_numpy(
                 rng.random((HB_CLIPS, HB_FRAMES)) < HB_MASK)}
    on_card = tree_map(lambda x: x.cuda(), batch)
    with torch.no_grad():
        lm.forward(p_gpu, on_card)               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        logits, _ = lm.forward(p_gpu, on_card)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in kernels}
    _check(tuple(logits.shape) == (HB_CLIPS, HB_FRAMES, cfg.vocab_size) and
           logits.dtype == torch.bfloat16 and
           bool(torch.isfinite(logits).all()),
           f"config HB: logits {tuple(logits.shape)} {logits.dtype}, or "
           "not finite")
    _no_launches("HB", counts)
    d, f, n = cfg.d_model, cfg.d_ff, HB_CLIPS * HB_FRAMES
    flop = 2 * n * cfg.num_layers * (4 * d * d + 2 * d * f
                                     + 2 * HB_FRAMES * d) \
        + 2 * n * (cfg.frontend_dim + cfg.vocab_size) * d
    print(f"config HB: forward of {HB_CLIPS} x {HB_FRAMES} frames "
          f"({int(batch['mask_positions'].sum())} masked) in "
          f"{wall * 1e3:.3f} ms = {n / wall:.1f} frames/s, {flop / 1e12:.3f} "
          f"TFLOP in bf16 ({flop / wall / 1e12:.2f} TFLOP/s); peak memory "
          f"allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB; "
          f"launches {counts} ({card})")
    hb = _layers_vs_cpu("HB", lm, p_gpu, p_cpu,
                        {k: v[:1] for k, v in batch.items()}, 0,
                        causal=False, rtol=BF16_TOL, kernels=kernels)
    _no_launches("HB layers", hb)
    return {"HB": counts, "HB layers": hb}


# --------------------------------------------------------------------------
# LM training: the scan's gradient kernel (T1), loss and round card vs CPU
# (T2), the LLCG round at full width (T3), train() end to end (T4)
# --------------------------------------------------------------------------
def _scan_bwd_ops(bh: int, t: int, chunk: int, dk: int, dv: int,
                  strict: bool, scalar: bool) -> float:
    """Operations the gradient kernel needs on this run's inputs: per head
    and chunk of l real steps, A and dA over the kept pairs, Aᵀ·dY,
    dA·K~ and dAᵀ·Q~ over them, the four (l, dk, dv) products of dV, dQ~,
    dK~ and dh_in, the decays (one exponential per key and step, or per
    kept pair in the scalar mode) and the reverse sum of d log_w, as
    multiply-adds counted twice."""
    total = 0.0
    for c0 in range(0, t, chunk):
        ln = min(chunk, t - c0)
        pairs = ln * (ln - 1) // 2 if strict else ln * (ln + 1) // 2
        total += 2.0 * pairs * (2 * dk + 2 * dv) + 2.0 * pairs * dk
        total += 4 * 2.0 * ln * dk * dv
        total += 2 * pairs if scalar else 3 * ln * dk
        total += 4.0 * ln * dk
        if strict:
            total += 6.0 * ln * dk + 2.0 * ln * dv
    return bh * total


def _scan_bwd_case(bh: int, t: int, d: int, mode: str, with_h0: bool,
                   label: str, seed: int, chunk: int = 64) -> dict:
    """The gradient kernel (``linear_scan_chunked_bwd``, from the forward
    kernel's saved chunk-start states) against torch autograd of the plain
    version on the card, every gradient within SCAN_TOL × max(1,
    max|plain|); dk = dv = ``d``; ``mode`` strict (with ``u``), plain
    (per-key decay) or scalar (log_w (BH, T)).  ``with_h0`` also carries a
    state in and a cotangent of h_T."""
    import numpy as np
    import torch
    from repro_torch.kernels.linear_scan import (linear_scan_chunked,
                                                 linear_scan_chunked_bwd)
    from repro_torch.kernels.ref import linear_scan_vjp_ref

    strict, scalar = mode == "strict", mode == "scalar"
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).cuda()
    q, k, v = f(bh, t, d), f(bh, t, d), f(bh, t, d)
    lw = torch.from_numpy((-(0.3 if scalar else 0.15) * rng.random(
        (bh, t) if scalar else (bh, t, d))).astype(np.float32)).cuda()
    h0 = f(bh, d, d) if with_h0 else None
    u = f(bh, d) * 0.3 if strict else None
    dy = f(bh, t, d)
    dh = f(bh, d, d) if with_h0 else None
    _, h_t, h_in = linear_scan_chunked(q, k, v, lw, h0, u=u, chunk=chunk,
                                       strict=strict, ragged=True,
                                       save_states=True)

    def kernel():
        return linear_scan_chunked_bwd(q, k, v, lw, h0, u, h_in, h_t, dy, dh,
                                       chunk=chunk, strict=strict)

    def plain():
        return linear_scan_vjp_ref(q, k, v, lw, h0, u, dy, dh, chunk=chunk,
                                   strict=strict)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    name = (f"{mode} BH={bh} T={t} dk=dv={d} L={chunk}"
            f"{' h0 dh_T' if with_h0 else ''}")
    errs = {}
    for what, a, b in zip(("dq", "dk", "dv", "dlog_w", "dh0", "du"), got,
                          want):
        _check((a is None) == (b is None),
               f"linear_scan_bwd {name}: {what} is "
               f"{'missing' if a is None else 'extra'}")
        if b is None:
            continue
        err = float((a - b).abs().max())
        tol = SCAN_TOL * max(1.0, float(b.abs().max()))
        _check(a.shape == b.shape and math.isfinite(err) and err <= tol,
               f"linear_scan_bwd {name} {what}: max |kernel - plain| {err} "
               f"> {tol}")
        errs[what] = {"max_abs_err": err, "tol": tol}
    # read once: q, k, v, log_w, dy, u, the saved states (and h_T, dh_T);
    # written once: dq, dk, dv, d log_w (and dh0, du)
    n_states = bh * -(-t // chunk) * d * d
    nbytes = 4 * (bh * t * (4 * d + (1 if scalar else d))   # q k v dy, log_w
                  + n_states + bh * t * (3 * d + (1 if scalar else d))
                  + (2 * bh * d if strict else 0)
                  + (3 * bh * d * d if with_h0 else 0))
    bound_ms, bound_by = _bound(
        nbytes, _scan_bwd_ops(bh, t, chunk, d, d, strict, scalar))
    return {"label": label, "shape": name, "errors": errs,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "ms": _time_ms(kernel), "device_ms": _graph_ms(kernel),
            "plain_ms": _time_ms(plain), "library_ms": None,
            "library": "none: no PyTorch call computes this gradient",
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}


def _stack_copies(params: dict, g: int) -> dict:
    from repro_torch.utils.pytree import tree_map
    return tree_map(lambda x: x.unsqueeze(0).expand(g, *x.shape).clone(),
                    params)


def _scan_layers(cfg) -> int:
    kinds = cfg.layer_plan()
    return kinds.count("rwkv6") + kinds.count("mamba2")


def _t2_model(label: str, cfg, kernels) -> dict:
    """One T2 model: ``LM.loss`` and its gradient, then one LLCG round
    (G=T3_G, K=T2_K, S=T3_S), on the card against the CPU; the card's scan
    launches exact (one forward and one backward a scan layer a step)."""
    import numpy as np
    import torch
    from repro_torch.distributed.steps import (LLCGStepConfig,
                                               build_llcg_round_step,
                                               value_and_grad)
    from repro_torch.optim import adamw
    from repro_torch.utils.pytree import flatten_with_paths, tree_map

    lm, p_cpu, p_gpu = _draw(cfg, T_SEED, label)
    layers = _scan_layers(cfg)
    rng = np.random.default_rng(T_SEED)
    ints = lambda *shape: torch.from_numpy(
        rng.integers(0, cfg.vocab_size, shape).astype(np.int32))
    batch = {"tokens": ints(2, T_SEQ), "labels": ints(2, T_SEQ)}
    on = lambda b: {k: v.cuda() for k, v in b.items()}
    t0 = time.perf_counter()
    (loss_g, grads_g), counts = _serve_counts(
        kernels, lambda: value_and_grad(lm.loss, p_gpu, on(batch)))
    grad_ms = (time.perf_counter() - t0) * 1e3
    _check(counts["linear_scan_chunked"] == layers
           and counts["linear_scan_chunked_bwd"] == layers,
           f"config {label} loss and gradient launched {counts}, not "
           f"{layers} forward and {layers} backward scans")
    t0 = time.perf_counter()
    loss_c, grads_c = value_and_grad(lm.loss, p_cpu, batch)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    lerr = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    _check(math.isfinite(float(loss_g)) and lerr <= T_LOSS_TOL,
           f"config {label} loss: card {float(loss_g)} cpu {float(loss_c)}")
    worst = {LM_TOL: 0.0, BF16_TOL: 0.0}
    for (key, a), (_, b) in zip(flatten_with_paths(grads_g),
                                flatten_with_paths(grads_c)):
        rule = BF16_TOL if key in T2_BF16_LEAVES else LM_TOL
        err = float((a.cpu() - b).abs().max())
        tol = rule * max(float(b.abs().max()), 1e-30)
        _check(math.isfinite(err) and err <= tol,
               f"config {label} gradient {key}: max |card - cpu| {err} > "
               f"{tol}")
        worst[rule] = max(worst[rule], err / tol)
    del grads_g, grads_c
    print(f"config {label} ({cfg.dtype}): loss card {float(loss_g):.6f} cpu "
          f"{float(loss_c):.6f} (rel {lerr:.3e}); every gradient leaf within"
          f" {worst[LM_TOL]:.4f} of 1e-3 × its max, {'/'.join(T2_BF16_LEAVES)}"
          f" within {worst[BF16_TOL]:.4f} of {BF16_TOL} × its max; "
          f"{counts['linear_scan_chunked']} + "
          f"{counts['linear_scan_chunked_bwd']} scan launches; loss and "
          f"gradient card {grad_ms:.1f} ms (first call), cpu {cpu_ms:.1f} ms")

    g, k, s = T3_G, T2_K, T3_S
    local = {"tokens": ints(g, k, 1, T_SEQ), "labels": ints(g, k, 1, T_SEQ)}
    corr = {"tokens": ints(s, 2, T_SEQ), "labels": ints(s, 2, T_SEQ)}
    step_cfg = LLCGStepConfig(num_groups=g, local_steps=k,
                              correction_steps=s)
    outs = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        step = build_llcg_round_step(lm, adamw(T_LR), adamw(T_SERVER_LR),
                                     step_cfg)
        params_G = _stack_copies(params, g)
        server = adamw(T_SERVER_LR).init(params)
        opt_G = adamw(T_LR).init(params_G)
        t0 = time.perf_counter()
        (out_G, _, _, m), round_counts = _serve_counts(kernels, lambda: step(
            params_G, opt_G, server, {n: x.to(dev) for n, x in local.items()},
            {n: x.to(dev) for n, x in corr.items()}))
        losses = (float(m["local_loss"]), float(m["corr_loss"]))
        outs[dev] = (out_G, losses, (time.perf_counter() - t0) * 1e3)
        if dev == "cuda":
            counts = round_counts
            want = (g * k + s) * layers
            _check(counts["linear_scan_chunked"] == want
                   and counts["linear_scan_chunked_bwd"] == want,
                   f"config {label} round launched {counts}, not {want} "
                   f"forward and {want} backward scans")
        del params, server, step, opt_G
    (g_G, g_l, g_ms), (c_G, c_l, c_ms) = outs["cuda"], outs["cpu"]
    for a, b, what in zip(g_l, c_l, ("local_loss", "corr_loss")):
        _check(math.isfinite(a) and abs(a - b) <= T_LOSS_TOL * abs(b),
               f"config {label} round {what}: card {a} cpu {b}")
    worst = 0.0
    for (key, a), (_, b) in zip(flatten_with_paths(g_G),
                                flatten_with_paths(c_G)):
        err = float((a.cpu() - b).abs().max())
        tol = LM_TOL * max(1.0, float(b.abs().max()))
        _check(math.isfinite(err) and err <= tol,
               f"config {label} round parameters {key}: max |card - cpu| "
               f"{err} > {tol}")
        worst = max(worst, err / tol)
    print(f"config {label} round (G={g}, K={k}, S={s}): local_loss card "
          f"{g_l[0]:.6f} cpu {c_l[0]:.6f}, corr_loss card {g_l[1]:.6f} cpu "
          f"{c_l[1]:.6f}; parameters within {worst:.4f} of LM_TOL; "
          f"{counts['linear_scan_chunked']} + "
          f"{counts['linear_scan_chunked_bwd']} scan launches; card "
          f"{g_ms:.1f} ms (first round), cpu {c_ms:.1f} ms")
    return counts


def _config_t2(kernels) -> dict:
    """Config T2: rwkv6-1.6b at full width cut to T2_LAYERS layers, and
    zamba2-7b at full width cut to one unit of a shared attention block
    and T2_MAMBA_LAYERS Mamba2 blocks (the scalar-decay gradient), each
    through
    :func:`_t2_model` in its shipped bfloat16 config, as T3 and T4 train
    it."""
    from repro_torch.configs import get_config

    rw = dataclasses.replace(get_config("rwkv6-1.6b"), num_layers=T2_LAYERS)
    zb = dataclasses.replace(get_config("zamba2-7b"),
                             num_layers=1 + T2_MAMBA_LAYERS, n_units=1,
                             pattern=(("shared_attn", 1),
                                      ("mamba2", T2_MAMBA_LAYERS)),
                             remainder=())
    return {"T2": _t2_model("T2", rw, kernels),
            "T2-zamba2": _t2_model("T2-zamba2", zb, kernels)}


def _config_t3(kernels, card: str) -> dict:
    """Config T3: the LLCG round of rwkv6-1.6b uncut (24 layers at full
    width; an OOM fails the phase), G=T3_G copies on the card, T3_ROUNDS rounds on
    the trainer's batches (``_local_batches`` / ``_corr_batches`` on its
    synthetic corpus): the losses finite, the copies equal after the
    broadcast, exactly (G·K + S) × layers forward and backward scans a
    round; then one profiled round, with the scan kernels' share of its
    device time."""
    import gc
    import statistics

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_corpus
    from repro_torch.distributed import steps
    from repro_torch.launch.train import (TrainConfig, _corr_batches,
                                          _local_batches)
    from repro_torch.models.transformer.model import LM
    from repro_torch.optim import adamw
    from repro_torch.utils.pytree import tree_bytes, tree_leaves, tree_map

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("rwkv6-1.6b")
    layers = cfg.num_layers
    lm = LM(cfg)
    g, k, s = T3_G, T3_K, T3_S
    tcfg = TrainConfig(arch=cfg.name, smoke=False, batch_per_group=T3_BATCH,
                       seq_len=T_SEQ, correction_steps=s, lr=T_LR,
                       server_lr=T_SERVER_LR, seed=T_SEED)
    t0 = time.perf_counter()
    corpus = synthetic_corpus(cfg.vocab_size, num_shards=g,
                              tokens_per_shard=max(T_SEQ * 64, 20_000),
                              heterogeneity=tcfg.heterogeneity, seed=T_SEED)
    corpus_s = time.perf_counter() - t0
    rng = np.random.default_rng(T_SEED)
    t0 = time.perf_counter()
    params = lm.init(T_SEED, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    param_gb = tree_bytes(params) / 1e9
    local_opt, server_opt = adamw(T_LR), adamw(T_SERVER_LR)
    server = server_opt.init(params)
    params_G = _stack_copies(params, g)
    del params
    opt_G = local_opt.init(params_G)
    step = steps.build_llcg_round_step(
        lm, local_opt, server_opt,
        steps.LLCGStepConfig(num_groups=g, local_steps=k,
                             correction_steps=s))
    want = (g * k + s) * layers
    rounds = []
    for r in range(1, T3_ROUNDS + 2):
        local = {n: x.cuda() for n, x in
                 _local_batches(corpus, g, k, tcfg, rng).items()}
        corr = {n: x.cuda() for n, x in
                _corr_batches(corpus, tcfg, rng).items()}
        out = {}

        def one_round():
            out["r"] = step(params_G, opt_G, server, local, corr)

        if r <= T3_ROUNDS:
            t0 = time.perf_counter()
            _, counts = _serve_counts(kernels, one_round)
            wall = time.perf_counter() - t0
            _check(counts["linear_scan_chunked"] == want
                   and counts["linear_scan_chunked_bwd"] == want,
                   f"config T3 round {r} launched {counts}, not {want} "
                   f"forward and {want} backward scans")
        else:                           # one more round, profiled
            busy = _device_busy_share(one_round, parts=(
                "linear_scan_kernel", "linear_scan_bwd_kernel"))
        params_G, opt_G, server, m = out["r"]
        losses = (float(m["local_loss"]), float(m["corr_loss"]))
        _check(all(math.isfinite(x) for x in losses),
               f"config T3 round {r}: losses {losses}")
        _check(all(torch.equal(x[0], x[i]) for x in tree_leaves(params_G)
                   for i in range(1, g)),
               f"config T3 round {r}: the {g} copies differ after the "
               f"broadcast")
        if r <= T3_ROUNDS:
            rounds.append({"round": r, "local_loss": losses[0],
                           "corr_loss": losses[1], "ms": wall * 1e3})
    # one local step alone (machine 0's loss, gradient and Adam update)
    view = tree_map(lambda x: x[0], params_G)
    state = steps._state_map(opt_G, lambda x: x[0])
    batch = {n: x[0, 0] for n, x in local.items()}
    step_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, grads = steps.value_and_grad(lm.loss, view, batch)
        state = steps._update_in_place(local_opt, grads, state, view)
        del grads
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = (g * k * T3_BATCH + s * 2 * T3_BATCH) * T_SEQ
    round_ms = statistics.median(x["ms"] for x in rounds)
    print(f"config T3: rwkv6-1.6b, {layers} layers, d_model {cfg.d_model}, "
          f"{n_params} parameters ({param_gb:.3f} GB f32 a copy), G={g} "
          f"K={k} S={s}, batch {T3_BATCH} x {T_SEQ} a machine, correction "
          f"batch {2 * T3_BATCH}; corpus {corpus_s:.1f} s, init on the card "
          f"{init_s:.1f} s")
    for x in rounds:
        print(f"config T3 round {x['round']}: local_loss "
              f"{x['local_loss']:.6f} corr_loss {x['corr_loss']:.6f} "
              f"{x['ms']:.1f} ms")
    print(f"config T3 ({card}): {round_ms:.3f} ms per round (median of "
          f"{T3_ROUNDS}), {statistics.median(step_ms):.3f} ms per local step"
          f" (median of 3: {', '.join(f'{x:.1f}' for x in step_ms)}), "
          f"{tokens / round_ms * 1e3:.1f} tokens trained per second "
          f"({tokens} a round), peak {peak_gb:.3f} GB; {want} + {want} scan "
          f"launches a round; busy share of one profiled round {busy}")
    del params_G, opt_G, server, view, state, step, out
    return {"T3": counts}


def _config_t4(kernels, card: str) -> dict:
    """Config T4: ``train()`` end to end.  rwkv6-1.6b uncut on the card
    (G=1 from the host mesh, 3 rounds, K·ρ^r bucketed to 4, 4, 4, S=1,
    checkpointed every round): finite losses, ``comm`` 2·G·(parameter MB)
    a round, the round-3 checkpoint restoring equal to ``params_G[0]``,
    exactly (K + S) × 24 forward and backward scans a round; prints, a
    step, the most negative sum of log_w over 64 positions (where the JAX
    package's chunk of 64 overflows past −88.7; rwkv6 scans in 8).  Then the JAX
    package's ``test_system`` run (gemma3-1b smoke, 4 rounds) on the card
    against the port on the CPU, losses within T_LOSS_TOL."""
    import gc
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint.store import restore_checkpoint
    from repro_torch.launch.train import TrainConfig, train
    from repro_torch.models.transformer import rwkv6 as R6
    from repro_torch.utils.pytree import tree_bytes, tree_leaves, tree_map

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_t4_")
    try:
        cfg = TrainConfig(arch="rwkv6-1.6b", smoke=False, rounds=3,
                          base_k=2, rho=1.3, correction_steps=1,
                          batch_per_group=4, seq_len=T_SEQ, ckpt_dir=ckpt)
        sums = []
        decay = R6._decay

        def watched(params, xw):     # the sums the JAX chunk of 64 scales by
            lw = decay(params, xw)
            sums.append(lw.detach()[:, :64].sum(dim=1).min())
            return lw

        R6._decay = watched
        try:
            t0 = time.perf_counter()
            (params_G, metrics), counts = _serve_counts(kernels,
                                                        lambda: train(cfg))
            wall = time.perf_counter() - t0
        finally:
            R6._decay = decay
        per_step = torch.stack(sums).view(-1, 24).amin(dim=1).tolist()
        past = [i for i, x in enumerate(per_step) if x < -88.7]
        hist = metrics["history"]
        g = params_G["embed"].shape[0]
        first = tree_map(lambda x: x[0], params_G)
        mb = tree_bytes(first) / 1e6
        _check([h["k"] for h in hist] == [4, 4, 4],
               f"config T4: K {[h['k'] for h in hist]}, not 4, 4, 4")
        _check(all(math.isfinite(h["local_loss"])
                   and math.isfinite(h["corr_loss"]) for h in hist),
               f"config T4: losses {hist}")
        _check(all(math.isclose(h["comm_mb"], r * 2 * g * mb, rel_tol=1e-12)
                   for r, h in enumerate(hist, start=1)),
               f"config T4: comm {[h['comm_mb'] for h in hist]}, not "
               f"2·{g}·{mb} a round")
        want = sum(h["k"] * g + cfg.correction_steps for h in hist) * 24
        _check(counts["linear_scan_chunked"] == want
               and counts["linear_scan_chunked_bwd"] == want,
               f"config T4 launched {counts}, not {want} forward and {want} "
               f"backward scans")
        t0 = time.perf_counter()
        restored, _, meta = restore_checkpoint(ckpt, first)
        restore_s = time.perf_counter() - t0
        _check(meta["step"] == 3 and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(restored),
                                              tree_leaves(first))),
               "config T4: the round-3 checkpoint does not restore "
               "params_G[0]")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for h in hist:
            print(f"config T4 round {h['round']}: K={h['k']} local_loss "
                  f"{h['local_loss']:.6f} corr_loss {h['corr_loss']:.6f} "
                  f"{h['seconds'] * 1e3:.1f} ms comm {h['comm_mb']:.2f} MB")
        print(f"config T4: the most negative sum of log_w over a step's "
              f"first 64 positions, a step: "
              f"{', '.join(f'{x:.2f}' for x in per_step)}; past -88.7 (where "
              f"a chunk of 64 overflows 1/P) from step "
              f"{past[0] + 1 if past else None} of {len(per_step)}")
        print(f"config T4 ({card}): train() of rwkv6-1.6b uncut, G={g}, "
              f"{wall:.1f} s in all (init, 3 rounds, 3 checkpoints of "
              f"{mb:.2f} MB); restore {restore_s:.1f} s; peak {peak_gb:.3f} "
              f"GB; {counts['linear_scan_chunked']} + "
              f"{counts['linear_scan_chunked_bwd']} scan launches")
        del params_G, metrics, first, restored
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    small = TrainConfig(arch="gemma3-1b", smoke=True, rounds=4, base_k=1,
                        rho=1.0, seq_len=64, batch_per_group=2)
    (pg, mg), gemma = _serve_counts(kernels, lambda: train(small))
    _no_launches("T4-gemma3", gemma)
    pc, mc = train(small, device="cpu")
    for a, b in zip(mg["history"], mc["history"]):
        for what in ("local_loss", "corr_loss"):
            _check(math.isfinite(a[what])
                   and abs(a[what] - b[what]) <= T_LOSS_TOL * abs(b[what]),
                   f"config T4-gemma3 round {a['round']} {what}: card "
                   f"{a[what]} cpu {b[what]}")
    print(f"config T4-gemma3: 4 rounds, card losses "
          f"{[round(h['local_loss'], 6) for h in mg['history']]} within "
          f"{T_LOSS_TOL} of the CPU's")
    return {"T4": counts, "T4-gemma3": gemma}


# --------------------------------------------------------------------------
# phases DR and DW: the dry run, and the sharded round on real ranks
# --------------------------------------------------------------------------
def _dw_configs() -> dict:
    """DW's models: rwkv6-1.6b at full width cut to T2_LAYERS layers (as
    T2), gemma3-1b at full width cut to 2 layers (``swa``, ``full``)."""
    from repro_torch.configs import get_config
    return {"DW-rwkv6": dataclasses.replace(get_config("rwkv6-1.6b"),
                                            num_layers=T2_LAYERS),
            "DW-gemma3": dataclasses.replace(
                get_config("gemma3-1b"), num_layers=2, n_units=1,
                remainder=(), pattern=(("swa", 1), ("full", 1)))}


def _d_fake_wire() -> dict:
    """Config D's plan (phase M2's) run by rank 0 of a fake group of
    M_MACHINES ranks on the CPU: the operand bytes its collectives carry,
    which need no data (the fake group moves none)."""
    import torch
    from repro_torch.core.plan import build_trainer
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import MachineMesh
    data, plans = _m_plans()
    model, plan = plans["M2"]
    with fake_group(M_MACHINES):
        mesh = MachineMesh(rank=0, size=M_MACHINES,
                           device=torch.device("cpu"))
        build_trainer(data, model, plan, backend="shard_map", mesh=mesh,
                      device="cpu").run()
    return dict(mesh.wire_bytes)


def _dryrun_child() -> dict:
    """Phase DR's body, in a process of its own on the CPU (the traces
    allocate nothing and use no card): DR_CASES at full size, the three
    GNN engine cases, DW's two cases on a fake group of 4, D's plan on a
    fake group of 4."""
    import torch
    from repro_torch.launch import dryrun
    torch.set_num_threads(1)
    out = {"cases": [], "gnn": [], "dw": {}}
    for arch, shape, multi in DR_CASES:
        t0 = time.perf_counter()
        res = dryrun.run_case(arch, shape, multi)
        blob = dataclasses.asdict(res)
        blob["roofline"] = dryrun.roofline_terms(res, 512 if multi else 256)
        blob["per_device_gb"] = dryrun.per_device_gb(res)
        blob["wall_s"] = time.perf_counter() - t0
        out["cases"].append(blob)
    for mode, comp, _ in DR_GNN:
        out["gnn"].append(dataclasses.asdict(dryrun.run_gnn_engine_case(
            16, mode=mode, halo_compression=comp)))
    for name, cfg in _dw_configs().items():
        res = dryrun.run_case(cfg.name, "train_4k", False, cfg_override=cfg,
                              mesh_shape=DW_MESH, global_batch=DW_BATCH,
                              seq_len=DW_SEQ, llcg_k=DW_K, llcg_s=DW_S,
                              remat=False)
        out["dw"][name] = dataclasses.asdict(res)
    out["d_fake"] = _d_fake_wire()
    return out


def _start_dr():
    """Start phase DR's child; its output goes to files beside nothing of
    the checkout (a temporary directory)."""
    import tempfile
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-dr-"))
    out, err = open(tmp / "out", "w"), open(tmp / "err", "w")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             "--dryrun"], stdout=out, stderr=err, text=True)
    return proc, tmp, time.perf_counter()


def _phase_dr(started, m2_wire: list, card: str) -> dict:
    """Phase DR: wait for the child, print every case (per-device GB
    against the card's 80 GB, TFLOP, inter / intra-group bytes, the three
    roofline terms) and gate: every case ``ok``, the GNN cases' bytes for
    one halo exchange (0, 1,048,576, 278,528) equal to the HaloProgram's,
    D's plan's halo bytes on the fake group equal to phase M2's ranks'.
    Returns the DW predictions."""
    import shutil
    proc, tmp, t0 = started
    try:
        proc.wait(timeout=max(1.0, DR_LIMIT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        _check(False, f"phase DR did not finish in {DR_LIMIT_S} s")
    text = (tmp / "out").read_text()
    errs = (tmp / "err").read_text()
    shutil.rmtree(tmp, ignore_errors=True)
    _check(proc.returncode == 0, f"phase DR child failed: {errs[-3000:]}")
    out = json.loads(text.strip().splitlines()[-1])
    for c in out["cases"]:
        coll, rf, mem = c["collective"], c.get("roofline", {}), c["memory"]
        print(f"phase DR {c['arch']} {c['shape']} {c['mesh']}: ok "
              f"{c['ok']}, trace {c['lower_s']:.1f} s, "
              f"{c['per_device_gb']:.3f} GB per device of {CARD_GB:.0f} "
              f"(arguments {mem.get('argument_size_in_bytes', 0) / 1e9:.3f}"
              f", temporaries {mem.get('temp_size_in_bytes', 0) / 1e9:.3f}"
              f"), "
              f"{c['flops'] / 1e12:.3f} TFLOP per device, inter-group "
              f"{coll.get('inter_group', 0):.6e} B, intra-group "
              f"{coll.get('intra_group', 0):.6e} B, roofline compute "
              f"{rf.get('compute_s', 0):.4f} s, memory "
              f"{rf.get('memory_s', 0):.4f} s, collective "
              f"{rf.get('collective_s', 0):.4f} s (H100 SXM 80 GB datasheet "
              f"figures; this card: {card}) {c['error'] or ''}")
    for c in out["cases"]:
        _check(c["ok"], f"phase DR {c['arch']} {c['shape']} {c['mesh']}: "
               f"{c['error']}")
    for (mode, comp, want), g in zip(DR_GNN, out["gnn"]):
        per = g["meta"].get("all_gather_bytes_per_exchange")
        print(f"phase DR gnn-engine {mode} {comp}: ok {g['ok']}, "
              f"all-gather {per} B per exchange (want {want}), collective "
              f"{ {k: v for k, v in g['collective'].items() if v} }")
        _check(g["ok"] and per == want, f"phase DR gnn {mode} {comp}: "
               f"{per} B per exchange, not {want} ({g['error']})")
        if mode == "halo":
            _check(g["meta"]["halo_bytes_match"] and per ==
                   g["meta"]["expected_all_gather_bytes"],
                   f"phase DR gnn {mode} {comp}: not the HaloProgram's "
                   f"{g['meta']['expected_all_gather_bytes']}")
    fake = out["d_fake"]
    print(f"phase DR config D on a fake group of {M_MACHINES}: rank 0 "
          f"carries {fake}; phase M2's ranks carried {m2_wire}")
    for rank, wire in enumerate(m2_wire):
        _check(wire.get("halo") == fake.get("halo"), f"phase DR: D's halo "
               f"bytes {fake.get('halo')} on the fake group, "
               f"{wire.get('halo')} on rank {rank} of phase M2")
    for name, c in out["dw"].items():
        _check(c["ok"], f"phase DR {name}: {c['error']}")
    print(f"phase DR: every gate passed ({len(out['cases'])} LM cases, "
          f"{len(out['gnn'])} GNN cases, D, and DW's "
          f"{len(out['dw'])} predictions)")
    return {name: c["collective"] for name, c in out["dw"].items()}


def _dw_rank(machine) -> dict:
    """One rank of phase DW: both models' sharded rounds
    (:func:`repro_torch.launch.dryrun.real_round`), each against the
    unsharded round on the card."""
    import torch
    from repro_torch.launch.dryrun import real_round
    out = {}
    for name, cfg in _dw_configs().items():
        t0 = time.perf_counter()
        out[name] = real_round(machine, cfg, DW_MESH, global_batch=DW_BATCH,
                               seq_len=DW_SEQ, llcg_k=DW_K, llcg_s=DW_S,
                               lr=DW_LR, server_lr=DW_SERVER_LR, seed=T_SEED,
                               device="cuda", tol=DW_TOL, first_grads=True)
        if out[name] is not None:
            out[name] = {"ranks": out[name],
                         "wall_s": time.perf_counter() - t0,
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        torch.cuda.empty_cache()
    return out


def _sharded_child() -> dict:
    from repro_torch.launch.mesh import launch_machines
    return launch_machines(_dw_rank, 4, device="cuda")


def _dw_flaws(info: dict, leaf: str) -> list:
    """What breaks DW's rule in one leaf's comparison (module docstring):
    a first-step gradient off, an element beyond the sign-flip bound, too
    many beyond DW_TOL, or the update off in norm."""
    bad = []
    if not info["off"] <= DW_FLIP_SHARE * info["n"]:
        bad.append(f"{info['off']} of {info['n']} elements beyond DW_TOL")
    flip = 2 * (DW_LR * DW_K + DW_SERVER_LR * DW_S)
    if not (math.isfinite(info["err"]) and info["err"] <= flip):
        bad.append(f"max |sharded - unsharded| {info['err']} > {flip}")
    if not (math.isfinite(info["update_err"])
            and info["update_err"] <= DW_UPDATE_TOL):
        bad.append(f"update off by {info['update_err']} of its norm")
    gtol = BF16_TOL if leaf in T2_BF16_LEAVES else DW_GRAD_TOL
    if not (math.isfinite(info["grad_err"]) and info["grad_err"] <= gtol):
        bad.append(f"first-step gradient {info['grad_err']} of its max > "
                   f"{gtol}")
    return bad


def _phase_dw(card: str, predicted: dict) -> dict:
    """Phase DW: the sharded round of each DW model on 4 gloo ranks on the
    card (a fresh process), gated by :func:`_dw_report`."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--sharded"], capture_output=True, text=True,
                          timeout=900)
    _check(proc.returncode == 0, f"phase DW child failed: "
           f"{proc.stderr[-3000:]}")
    counts = _dw_report(json.loads(proc.stdout.strip().splitlines()[-1]),
                        predicted, card)
    print(f"phase DW: every gate passed in {time.perf_counter() - t0:.1f} s")
    return counts


def _dw_report(out: dict, predicted: dict, card: str) -> dict:
    """DW's records (:func:`_dw_rank`): every rank's blocks held to the
    unsharded round's on the card by :func:`_dw_flaws`, its counted bytes
    equal to DR's trace of the same case (``predicted``), its scan
    launches exact ((K + S) × scan layers, forward and gradient).  Returns
    the launch counts."""
    cfgs = _dw_configs()
    counts = {}
    for name, res in out.items():
        layers = _scan_layers(cfgs[name])
        want = (DW_K + DW_S) * layers
        worst = grad_worst = off = upd = 0.0
        determined = 0
        for r in res["ranks"]:
            for leaf, info in r["leaves"].items():
                worst = max(worst, info["err"])
                grad_worst = max(grad_worst, info["grad_err"])
                off = max(off, info["off"] / info["n"])
                upd = max(upd, info["update_err"])
                determined += info["off_determined"]
            print(f"phase {name} rank {r['coord']}: losses {r['losses']} "
                  f"(unsharded {r['ref_losses']}), collective bytes "
                  f"{ {k: v for k, v in r['collective'].items() if v} }, "
                  f"scan launches {r['launches']}")
        print(f"phase {name}: {len(res['ranks'])} gloo ranks on one card, "
              f"(data, model) = {DW_MESH}, batch {DW_BATCH} × {DW_SEQ}, "
              f"K={DW_K}, S={DW_S}, lr {DW_LR} / {DW_SERVER_LR}: max "
              f"|sharded - unsharded| {worst:.3e} (bound "
              f"{2 * (DW_LR * DW_K + DW_SERVER_LR * DW_S):.1e}), at most "
              f"{off:.3e} of a leaf beyond {DW_TOL:.0e} (allowed "
              f"{DW_FLIP_SHARE:.0e}; {determined} of them, on all ranks, "
              f"with first-step gradients above dryrun.GRAD_FLOOR), updates "
              f"within {upd:.3e} of their norm (allowed {DW_UPDATE_TOL}), "
              f"first-step gradients within {grad_worst:.3e} of their max; "
              f"{res['wall_s']:.1f} s "
              f"for both rounds on rank 0, peak {res['peak_gb']:.3f} GB on "
              f"rank 0 ({card})")
        for r in res["ranks"]:
            for leaf, info in r["leaves"].items():
                bad = _dw_flaws(info, leaf)
                _check(not bad, f"phase {name} rank {r['coord']} {leaf}: "
                       f"{'; '.join(bad)}")
            for key in ("local_loss", "corr_loss"):
                a, b = r["losses"][key], r["ref_losses"][key]
                _check(abs(a - b) <= T_LOSS_TOL * abs(b), f"phase {name} "
                       f"{key}: sharded {a}, unsharded {b}")
            _check(r["collective"] == predicted[name], f"phase {name} rank "
                   f"{r['coord']}: counted {r['collective']}, DR predicted "
                   f"{predicted[name]}")
            _check(r["launches"] == {"linear_scan_chunked": want,
                                     "linear_scan_chunked_bwd": want},
                   f"phase {name} rank {r['coord']}: scan launches "
                   f"{r['launches']}, not {want} and {want}")
        counts[name] = res["ranks"][0]["launches"]
    return counts


def main(argv) -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is missing: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if argv[:1] == ["--machines"]:              # phase M's fresh process
        sys.path.insert(0, str(ROOT / "src"))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(json.dumps(_machines_child()))
        return 0
    if argv[:1] in (["--dryrun"], ["--sharded"]):    # phases DR / DW
        sys.path.insert(0, str(ROOT / "src"))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        body = _dryrun_child if argv[0] == "--dryrun" else _sharded_child
        print(json.dumps(body()))
        return 0
    if argv[:1] == ["--wrapper-times"]:         # one turn of _compare
        src, cases = argv[1], json.loads(argv[2])
        if not (pathlib.Path(src) / "repro_torch").is_dir():
            print(f"chip_smoke: no repro_torch under {src}", file=sys.stderr)
            return 2
        print(json.dumps(_wrapper_times(src, cases)))
        return 0
    baseline = None
    if argv[:1] == ["--baseline"] and len(argv) == 2:
        baseline = pathlib.Path(argv[1]).resolve()
    elif argv:
        print("usage: chip_smoke.py [--baseline DIR]", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    if baseline is not None and not (baseline / "src" / "repro_torch"
                                     ).is_dir():
        print(f"chip_smoke: no src/repro_torch under {baseline}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.graph.datasets import sbm_graph
    from repro_torch.kernels import build
    from repro_torch.kernels.edge_softmax import edge_softmax
    from repro_torch.kernels.linear_scan import (linear_scan_chunked,
                                                 linear_scan_chunked_bwd)
    from repro_torch.kernels.quantize import (MAX_SEGMENTS, dequantize_rows,
                                              quantize_rows)
    from repro_torch.kernels.linear_scan import ctas_per_sm
    from repro_torch.kernels.spmm import spmm_csr
    all_kernels = (spmm_csr, edge_softmax, quantize_rows, dequantize_rows,
                   linear_scan_chunked, linear_scan_chunked_bwd)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip()

    t_start = time.perf_counter()
    dr = None
    # the script's time so far after each phase: its limit is shared by all
    mark = lambda phase: print(f"chip_smoke: {phase} done at "
                               f"{time.perf_counter() - t_start:.1f} s of "
                               f"{SCRIPT_LIMIT_S}")
    try:
        t0 = time.perf_counter()
        libs = build.build(build.sources())
        print(f"built {[p.name for p in libs]} in "
              f"{time.perf_counter() - t0:.1f} s")
        # phase DR traces on the CPU in a process of its own, beside the
        # card's phases; read after phase M
        dr = _start_dr()

        data, cfg, plans = _configs()
        from repro_torch.core.plan import RoundSampler
        smp = RoundSampler(data, *plans["D"], "cpu")
        smp.ensure_halo()
        n_loc = cfg.num_machines * smp.n_max
        n_full, f_full = smp.full_table.shape
        n_send = cfg.num_machines * smp.halo_program.max_send

        spmm_cases = [_spmm_case(data.graph, d, "slice", s)
                      for s, d in enumerate((32, 64))]
        big = sbm_graph(num_nodes=16384, avg_degree=25, seed=1)
        spmm_cases += [_spmm_case(big.graph, d, "large", 10 + s)
                       for s, d in enumerate((64, 128))]
        # degree skew: 16 hubs of 4,096 neighbors each on the large graph
        spmm_cases.append(_spmm_case(_hub_graph(big.graph), 64, "large hubs",
                                     12))
        # the LLCG benchmark's graph, past half of the L2: one-line slabs
        # straight from H at D 256 and from the slab-major copy at D 602,
        # and the pack alone
        cell = _cell_graph()
        spmm_cases += [_spmm_case(cell, d, "cell", 13 + s)
                       for s, d in enumerate((256, 602))]
        pack_case = _pack_case(cell.num_nodes, 602, 15)
        del cell
        # phase S1's serving shapes: P stacked extended graphs of config
        # B's 2-hop inference halo, at the full and the fanout-10 width
        # buckets; its halo send buffer
        from repro_torch.graph.halo import (build_halo_program,
                                            build_inference_plan)
        inf = build_inference_plan(data.graph, smp.partition, 2)
        serve_prog = build_halo_program(data.graph, smp.partition, plan=inf)
        n_serve = cfg.num_machines * serve_prog.n_ext_pad
        f_serve = max(g.max_degree() for g in inf.ext_graphs)
        esm_shapes = [(n_loc, smp.fanout, 64, "slice local"),
                      (n_loc, smp.fanout, 8, "slice local"),
                      (n_full, f_full, 64, "slice full"),
                      (n_full, f_full, 8, "slice full"),
                      (n_serve, f_serve, 64, "serving full"),
                      (n_serve, f_serve, 8, "serving full"),
                      (n_serve, 16, 64, "serving fanout 10"),
                      (n_serve, 16, 8, "serving fanout 10"),
                      (65536, 10, 64, "large"),
                      (65536, big.graph.max_degree(), 64, "large")]
        esm_cases = [_esm_case(n, f, d, label, 20 + i)
                     for i, (n, f, d, label) in enumerate(esm_shapes)]
        # averaging: (P, leaf numel) rows for every leaf size of config C,
        # widest first (64x64); halo: (P·max_send, feature_dim) rows,
        # round-half-up
        import numpy as np
        leaf_sizes = sorted({int(np.prod(leaf.shape))
                             for layer in plans["C"][0].init_numpy(0).values()
                             for leaf in layer.values()}, reverse=True)
        quant_shapes = [(cfg.num_machines, c, True, "averaging")
                        for c in leaf_sizes]
        quant_shapes += [(n_send, data.feature_dim, False, "halo"),
                         (cfg.num_machines * serve_prog.max_send,
                          data.feature_dim, False, "serving halo"),
                         (65536, 256, True, "large"),
                         (65536, 256, False, "large")]
        quant_cases = [_quant_case(r, c, with_u, label, 30 + i)
                       for i, (r, c, with_u, label)
                       in enumerate(quant_shapes)]
        # config C's round table: each of the 13 leaves (tree_leaves order)
        # quantized over 8 machines, then dequantized in one grouped call
        from repro_torch.utils.pytree import tree_leaves
        round_sizes = [int(np.prod(leaf.shape)) for leaf in
                       tree_leaves(plans["C"][0].init_numpy(0))]
        round_table = [quantize_rows(*_quant_inputs(cfg.num_machines, c,
                                                    True, 60 + i))
                       for i, c in enumerate(round_sizes)]
        grouped_cases = _grouped_cases(round_table)
        # RWKV6 serving: batch 4 × 32 heads, prompts of 192 and 77 tokens
        # in rwkv6's chunks of 8 (the main path) and of 64 (the JAX
        # package's chunk: two chunks, the second ragged); a larger strict
        # case with a carried state; the plain convention with a per-key
        # decay (the
        # JAX API's plain mode; no model path of the port runs it, Mamba2
        # takes the scalar-decay mode below)
        scan_cases = [_scan_case(128, 192, 64, True, False, "slice", 40,
                                 chunk=RWKV6_CHUNK),
                      _scan_case(128, 77, 64, True, False, "slice ragged",
                                 49, chunk=RWKV6_CHUNK),
                      _scan_case(128, 192, 64, True, False, "slice L=64",
                                 50),
                      _scan_case(128, 77, 64, True, False,
                                 "slice ragged L=64", 41),
                      _scan_case(512, 2048, 64, True, True, "large", 42),
                      _scan_case(224, 1024, 64, False, True,
                                 "plain per-key decay", 43)]
        # the scalar-decay mode at zamba2's prefill shapes (batch 4 x 112
        # heads, state 64, head 64; prompts of 192 and 77 tokens), with and
        # without a carried state, and at −3 per step, where a chunk sums
        # to 192 and the factored form overflows
        scan_cases += [
            _scan_case(448, 192, 64, False, False, "zamba2", 44,
                       scalar_decay=0.3),
            _scan_case(448, 77, 64, False, False, "zamba2 ragged", 45,
                       scalar_decay=0.3),
            _scan_case(448, 192, 64, False, True, "zamba2 h0", 46,
                       scalar_decay=0.3),
            _scan_case(448, 77, 64, False, True, "zamba2 ragged h0", 47,
                       scalar_decay=0.3),
            _scan_case(448, 192, 64, False, False, "zamba2 strong decay", 48,
                       scalar_decay=3.0)]
        for c in spmm_cases:
            print(f"spmm_csr {json.dumps(c)}")
        print(f"spmm_csr {json.dumps(pack_case)}")
        for c in esm_cases:
            print(f"edge_softmax {json.dumps(c)}")
        for pair in quant_cases:
            for c in pair:
                print(f"{c['kernel']} {json.dumps(c)}")
        for c in grouped_cases:
            print(f"dequantize_rows grouped {json.dumps(c)}")
        for c in scan_cases:
            print(f"linear_scan_chunked {json.dumps(c)}")
        # the csr layout at config A's shape and on F3's graph
        f3 = _f3_setting()
        for c in (_csr_case(data.graph, "slice", 70),
                  _csr_case(f3[0].graph, "F3", 71, iters=5)):
            print(f"csr_layout {json.dumps(c)}")
        occ = {conv: ctas_per_sm(conv == "strict",
                                 scalar_decay=conv == "scalar-decay")
               for conv in ("strict", "plain", "scalar-decay")}
        print(f"linear_scan_chunked: CTAs per SM {occ} (two per batch·head)")
        _check(min(occ.values()) >= 2, f"linear_scan_chunked fits "
               f"{occ} CTAs per SM, not 2")

        hists = {}
        counts = {}
        for name in plans:
            counts[name], hists[name] = _drive(name, data, *plans[name],
                                               all_kernels)
        _check(counts["A"]["spmm_csr"] > 0,
               "config A launched no SpMM kernel")
        # B: every GAT layer's aggregation in K local steps, S correction
        # steps and one evaluation per round (14 for the reddit setting)
        gat_layers = len(plans["B"][0].init_numpy(0))
        want = ROUNDS * (cfg.local_k + cfg.correction_steps + 1) * gat_layers
        _check(counts["B"]["edge_softmax"] == want,
               f"config B launched edge_softmax "
               f"{counts['B']['edge_softmax']} times, not {want}")
        # C: a quantize launch per parameter leaf (13 for SBSBS) and one
        # grouped dequantize launch per MAX_SEGMENTS leaves, each round;
        # D: one of each per round
        leaves = len(round_sizes)
        for name, k, want in (
                ("C", "quantize_rows", ROUNDS * leaves),
                ("C", "dequantize_rows",
                 ROUNDS * -(-leaves // MAX_SEGMENTS)),
                ("D", "quantize_rows", ROUNDS),
                ("D", "dequantize_rows", ROUNDS)):
            _check(counts[name][k] == want,
                   f"config {name} launched {k} {counts[name][k]} "
                   f"times, not {want}")
        mark("phase 2 and configs A-D")
        _phase_ds(data, cfg, plans, f3)
        counts.update(_configs_dev(data, plans, counts, all_kernels))
        counts.update(_configs_f(data, cfg, plans, f3, hists["A"],
                                 all_kernels))
        counts["P"] = _paper_phase(all_kernels)
        mark("DS, A-dev, D-dev, F1-F3 and P")
        counts.update(_phase_k(data, plans, all_kernels, card))
        mark("K")
        counts.update(_phase_s(data, cfg, plans, f3, all_kernels))
        mark("S")
        m_counts, m2_wire = _phase_m(card)
        counts.update(m_counts)
        mark("M")
        counts["E"], counts["E3"] = _config_e(all_kernels)
        mark("E")
        counts["Z1"], counts["Z-slot"] = _config_z(all_kernels, card)
        mark("Z")
        counts.update(_config_g(all_kernels, card))
        mark("G")
        counts.update(_config_h(all_kernels, card))
        mark("H")
        _config_sc()
        _config_g4()
        mark("SC and G4")
        counts.update(_config_q(all_kernels, card))
        mark("Q")
        counts.update(_config_qw(all_kernels))
        mark("QW")
        counts.update(_config_v(all_kernels, card))
        mark("V")
        counts.update(_config_hb(all_kernels, card))
        mark("HB")
        # T1: the scan's gradient kernel at rwkv6's training shape (batch 4
        # x 32 heads, T 128, and a ragged 77, in rwkv6's chunks of 8),
        # plain per-key with a carried
        # state, and the scalar-decay mode at zamba2's (448, 192)
        bwd_cases = [
            _scan_bwd_case(128, 128, 64, "strict", False, "rwkv6 train", 80,
                           chunk=RWKV6_CHUNK),
            _scan_bwd_case(128, 77, 64, "strict", False, "rwkv6 ragged", 81,
                           chunk=RWKV6_CHUNK),
            _scan_bwd_case(128, 192, 64, "plain", True, "plain per-key h0",
                           82),
            _scan_bwd_case(448, 192, 64, "scalar", False, "zamba2", 83)]
        for c in bwd_cases:
            print(f"linear_scan_chunked_bwd {json.dumps(c)}")
        mark("T1")
        counts.update(_config_t2(all_kernels))
        mark("T2")
        counts.update(_config_t3(all_kernels, card))
        mark("T3")
        counts.update(_config_t4(all_kernels, card))
        mark("T4")
        dw_predicted = _phase_dr(dr, m2_wire, card)
        dr = None
        mark("DR")
        counts.update(_phase_dw(card, dw_predicted))
        mark("DW")
        if baseline is not None:
            _compare(baseline, {
                "quant": [list(s[:3]) for s in quant_shapes],
                "esm": [list(s[:3]) for s in esm_shapes],
                "tree": [cfg.num_machines, round_sizes]})
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if dr is not None and dr[0].poll() is None:   # stop phase DR
            dr[0].kill()
            dr[0].wait()

    def row(name, route, source, replaces, case, config):
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": counts[config][name],
                "launches_by_path": {path: c[name] for path, c in
                                     counts.items() if c.get(name)},
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "device_ms": case["device_ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": case["library_ms"],
                "library_device_ms": case.get("library_device_ms")}

    quant_src = "src/repro_torch/kernels/csrc/quantize_rows.cu"
    kernels = [
        row("spmm_csr", "cuda", "src/repro_torch/kernels/csrc/spmm_csr.cu",
            "src/repro/kernels/spmm.py:127", spmm_cases[1], "A"),
        row("edge_softmax", "cuda",
            "src/repro_torch/kernels/csrc/edge_softmax.cu",
            "src/repro/kernels/edge_softmax.py:49", esm_cases[0], "B"),
        row("quantize_rows", "cuda", quant_src,
            "src/repro/kernels/quantize.py:51", quant_cases[0][0], "C"),
        row("dequantize_rows", "cuda", quant_src,
            "src/repro/kernels/quantize.py:77", grouped_cases[0], "C"),
        row("linear_scan_chunked", "cuda",
            "src/repro_torch/kernels/csrc/linear_scan.cu",
            "src/repro/kernels/linear_scan.py:108", scan_cases[0], "E"),
        row("linear_scan_chunked_bwd", "cuda",
            "src/repro_torch/kernels/csrc/linear_scan_bwd.cu",
            "none: the JAX package differentiates its jnp chunked scan",
            bwd_cases[0], "T3"),
    ]
    # the SpMM at the benchmark cell's shape: its slab passes and the pack
    kernels[0]["at_the_cell_shape"] = [
        {k: c[k] for k in ("label", "shape", "device_ms", "bound_ms",
                           "bound_by") if k in c} | {"plan": c.get("plan")}
        for c in spmm_cases if c["label"] == "cell"] + [
        {k: pack_case[k] for k in ("label", "shape", "device_ms", "bound_ms",
                                   "bound_by")}]
    # the paths on which no hand-written kernel launched (the dense and MoE
    # stacks, the frontends): each was gated at 0 where it ran
    zero = sorted(path for path, c in counts.items() if not any(c.values()))
    print(json.dumps({"kernels": kernels, "zero_launch_paths": zero}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
