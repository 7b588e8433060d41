"""Chip smoke test of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (PATH or /usr/local/cuda/bin) and the repo's
``src/`` tree beside this file; exits non-zero otherwise.  It imports
neither ``jax`` nor ``repro``.  In order it:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA source of the port (``kernels/csrc/*.cu``, one nvcc
   per source, all started together) and prints the build time and the
   ptxas report;
3. holds each of the four codec kernels (quantize_int8, dequantize_int8,
   sparsify_quant_pack, unpack_dequant) equal to its plain PyTorch version
   on the card, at the four ResNet18 cut shapes of the main path (batch
   16), the scenario path's shapes (rows 8 and 16, d 64), the edge shapes
   of the CPU tests, the selection's edges (k = 1, +-0.0 next to
   subnormals, all-equal groups of 128) and NaN / +-inf input (the
   non-finite contract: NaN exactly where the plain version's is, every
   other float, int8 and word bit for bit), in bfloat16 too (x, and the
   decoders' output, at cut6 and the scenario shape, NaN / +-inf at cut6)
   and at smollm's smashed tensor under ``compress_smashed`` (8192, 960);
   at the cut shapes, the scenario path's batch-8 shape and cut6 in
   bfloat16 it times kernel and plain version on the device
   (``torch.profiler`` kernel time per call), the wrapper call (CUDA
   events) and, for dequantize_int8 in float32, one ``torch.mul`` of q by
   its scales (the same function bit for bit), beside the bytes bound (2
   bytes a value for a bfloat16 input or output); quantize_int8 and
   dequantize_int8 also at (8192, 960); and it times the launch floor (the
   device time of ``zero_()`` on one element);
4. holds unpack_dequant_matmul (the RSU's first matmul reading the packed
   topk_int8 buffer) to its plain version within 1e-5 + 1e-5·|b| (TF32
   off) at the scenario path's shapes (rows 8 and 16, d = n = 64), one
   row, a partial 8-row tile (rows 9), the CPU tests' shapes, a wide case
   (rows 4096, d 512, n 64), the path's shape with w in bfloat16 and two
   of NaN / +-inf input (the output NaN
   exactly where the plain version's is); on the wide case the call's peak
   allocation stays below its output plus the dense smashed tensor, and
   its gradient keeps no float32 tensor of the smashed shape; its device
   time at every case, and at the path's shape times it like the codec;
4b. holds the LM lane's kernels (rmsnorm, flash_attention, ssd_chunk_scan)
   to their plain versions within stated float32 tolerances at the serving
   path's shapes and edge shapes (rmsnorm also in bfloat16 and float16,
   with a float32 scale or one of x's dtype, within one ulp of the working
   type; its backward kernel against the closed-form plain backward and
   the plain vjp, two calls bit for bit, at d 256 / 960 / 1536 / 3072 and
   the families' training widths 2560 / 896 / 2048 in float32 and
   bfloat16, the bfloat16 archs' 5120 / 8192 and qwen3's qk-norm rows
   over 128 too), and at each served arch's prefill shape
   (smollm, mamba2; gemma3's global and local layers at d 256, 8 heads
   over 4, the local one also at s 1088 where its window masks keys;
   recurrentgemma's local MQA, window 2048; internvl2's 14 over 2;
   musicgen's MHA 32 / 32; rmsnorm at every shape in float32 and
   bfloat16, deepseek's ``kv_norm`` over the latent (8, 1024, 512) among
   them, its backward at the ten widths; at the bfloat16 archs' widths
   timed in bfloat16 only, RMS_BF16_WIDTHS) and flash in bfloat16 and
   float16 (``FLASH16_CASES``: every head dim and float32's edge shapes,
   their d-128 variants; qwen3-14b's prefill, 40 heads over 8 at d 128,
   and command-r-35b's, 64 over 8; within one ulp of the working type plus
   flash's float32 tolerance, two calls bit for bit on the route
   ``flash_route`` picks: d 64 and 128 on the Hopper route, the rest on
   the mma route; the timed prefills also checked forced onto the mma
   route, rows ``*_mma``, timed at d 64 (smollm's); bound: the bytes, or
   q.k^T once and p.v twice at 989 TFLOP/s dense bf16 / f16; the build
   prints the Hopper kernels' registers, spills and shared memory,
   forward and backward, at each head dim, and fails on a spill) and
   flash's backward kernels (``FLASH_BWD_TRAIN``: the training shapes of
   phase 10g's archs in their dtype, timed; ``FLASH_BWD_EDGES`` in every
   dtype: every head dim, windows that mask keys, sq != sk with rows that
   see no key, one query, q / k / v as views of one fused projection,
   aligned and misaligned by one element, a strided cotangent; each on
   the route ``flash_backward_route`` picks, 16-bit d 128 and 256 on the
   Hopper kernels, and the timed Hopper rows timed again forced onto the
   mma route, rows ``*_mma``) from the
   forward kernel's lse (within 1e-4 of the plain one, +inf exactly where
   a row sees no key) against its closed-form plain version and the plain
   vjp, each gradient within flash's tolerance of the largest (16-bit: one
   ulp more), two calls bit for bit, with the memory a call takes beyond
   what was allocated, SDPA's backward as the library call, bound: the
   bytes, or the five products' 10 d flops a visible pair and head (the
   16-bit kernel's split products, 24 d, beside it); and
   ssd_chunk_scan with x / B / C in bfloat16 and float16 at every SSD
   shape (``SSD_CASES``; at mamba2's prefill shape also with dt and A in
   x's dtype; y of x's dtype within one ulp of it plus the float32
   tolerance, the state float32; float32 math, so the float32 operations
   bound, bytes at 2 B a 16-bit value), times
   kernel (for
   ssd_chunk_scan and rmsnorm's backward every kernel of one wrapper
   call), wrapper call, plain version and one PyTorch library call
   (``scaled_dot_product_attention`` with ``enable_gqa``, under a window
   with a boolean mask; ``rms_norm``, and for the backward the backward
   half of ``torch.autograd.grad`` through it; none computes the SSD
   scan) beside the bound (bytes or float32
   operations, whichever is larger) and, for flash_attention and
   ssd_chunk_scan, which run 3xTF32 on the tensor cores, the operations
   bound at a third of the TF32 rate; every rmsnorm row (and its
   backward's) also with L2 flushed before each call, kernel and
   ``rms_norm`` (back-to-back calls keep a working set under 50 MB in
   L2);
5. drives the ASFL path — ``repro_torch.api.run`` of the paper's case
   study (resnet18, asfl, 4 vehicles, batch 16, adam) on the per-replica
   loop (``cohort_parallel="unroll"``, the schedule of every earlier
   measurement) — for two rounds over the ``topk_int8`` wire, with the
   launch counters zeroed just before and read just after: pack and unpack
   each launch twice per client batch step; each round's wall time
   excludes building the engine;
6. one round over the ``int8`` wire: the quant kernels launch;
7. one sgd SFL batch step per cut on the CPU and on the card from the same
   weights (``wire="none"``, TF32 off): the card's update agrees with the
   CPU's within 1 % of the largest update;
8. serves smollm-360m, mamba2-780m, gemma3-4b (local + global attention,
   qk-norm, GeGLU), recurrentgemma-2b (RG-LRU + local MQA), internvl2-1b
   (256 patch embeddings prepended), musicgen-large (4 codebooks in, 4
   heads out, sinusoidal positions), deepseek-v2-lite-16b (MLA and MoE,
   15.7B float32 parameters) and, last, on bfloat16 weights, qwen3-14b
   (qk-norm, 14.8B) and command-r-35b (32.4B, 64.8 GB; where it does not
   fit, the measured failure is printed and it is served at the fewest
   layers cut that fit, listed), then mamba2-780m with its parameters in
   bfloat16 and in float16 (the SSD scan on 16-bit inputs: 48 launches a
   prefill in the weights' dtype), at full width and depth through
   ``repro_torch.launch.serve`` (batch 8, prompt 1024, 32 decode steps, the
   default cut), with the launch counters zeroed just before and read just
   after each: exactly the kernel launches the model implies (flash per
   attention layer; rmsnorm 2 per layer, 2 more per attention layer under
   qk-norm, 1 more per MLA layer, and the final norm, per forward: 2,706
   for deepseek), finite logits of the right
   shape ((8, 1, 4, 2048) for musicgen), the parameter count equal to
   ``count_params`` plus the leaves it leaves out (qk-norm scales,
   RG-LRU's ``lam``); prints the prefill and decode times, the counted
   serve's peak memory, a second full-size prefill's time beside the
   first, the SM clocks (nvidia-smi) and reserved bytes just before
   and just after the counted serve, whose prefill is the first, and for
   deepseek the share of (token, expert) slots its prefill's grouped MoE
   dispatch dropped (some must be kept), taken in a third, untimed
   prefill of the same prompt, every dispatch's kept slots held to a
   plain count on the CPU; flash's launches by q's dtype, all in the
   weights' dtype, and by route, all on the Hopper route for the bfloat16
   archs and on the mma route for the float32 ones; both full-size
   prefills run under ``torch.profiler`` and are timed on the host clock
   inside their traces, and where the first takes over 5 % longer than
   the second the kernels whose summed device time differs most between
   them are printed (ROADMAP C);
9. at full width, prefill(s-1) + one decode step reproduces the last
   logits of prefill(s) within 1e-3 (gemma3 at s 1088 and recurrentgemma
   at s 2112, so that their local layers' rings wrap with a nonzero shift
   and flash masks keys left of the window; deepseek at batch 1, where
   both forwards take the drop-free dense MoE path, so the phase holds
   MLA's absorbed decode against its materialised prefill; the others at
   the served prompt, through their own batches; on 16-bit weights
   within 8 ulps of their dtype at the largest logit, the CPU tests'
   bfloat16 tolerance);
10. serves the reduced configs on the card and on the CPU from the same
    weights and inputs (smollm / mamba2 at three periods, the four
    families, deepseek and the bfloat16 qwen3-14b-smoke, command-r-35b-smoke
    and dbrx-132b-smoke at their own depth, mamba2 in bfloat16 and
    float16): logits within 2e-4, an MoE's expert choices equal; 16-bit
    logits within 8 ulps of their dtype at the largest,
    over 8 rows of which those the MoE routed apart on the card and the
    CPU (a near tie) are left out and counted, at most half;
10b. drives the multi-RSU scenario path through ``repro_torch.api.run``:
    mlp9 on ``highway_corridor`` with 256 vehicles and 4 RSUs, cloud sync
    every round, 4 rounds of local_steps 2 at batch 8 (sgd, lr 1e-3, the
    scenario benchmark's settings), ``paper`` cuts over the ``topk_int8``
    wire with error feedback; then 2 rounds of ``urban_grid`` (256
    vehicles) with ``residence`` cuts over the ``int8`` wire.  Counters
    zeroed just before and read just after each run; it checks finite
    losses, handovers after round 0 on the highway, RSU loads summing to
    the scheduled count, the cuts, and every codec launch count against the
    design's formula; prints each round's wall time;
10c. runs the two-cell handover trace (2 vehicles, 4 rounds, topk_int8,
    cloud sync every 2 rounds) on the card and on the CPU from the same
    weights: final global parameters within 1e-4 of the largest parameter;
10d. drives the single-RSU engine's five schemes at full width through
    ``repro_torch.api.run`` (resnet18, 4 vehicles on ``single_rsu``, the
    paper's spec): one round each of ``cl`` and ``fl`` (``auto``, which is
    ``vmap`` on the card) and ``sl`` over ``topk_int8``, then ``asfl`` over
    ``topk_int8`` under ``vmap`` and under ``unroll`` from the same seed,
    two rounds each.  Counters zeroed just before and read just after each
    run; every round has a finite loss, accuracy in [0, 1] and its cuts,
    the bytes on the wire equal the cost model's smashed bytes, and the
    codec launches equal the schedule's formula (per client batch step:
    the loop and the ``sl`` chain pack and unpack twice; ``vmap`` packs and
    unpacks once per (bucket, local step) on the stacked smashed tensor and
    once per client batch step on the downlink; ``cl`` / ``fl`` launch
    none); prints each round's wall time and the resolved ``engine.mode``;
10e. one sgd SFL round step of two buckets (cuts 2 and 6, two slots each,
    one slot sitting the step out) under ``vmap`` on the card from the same
    weights as the loop on the CPU, TF32 off, the model in float64: within
    phase 7's tolerance (the float32 comparisons printed beside it);
10f. (phases 10f-10i train smollm-360m, mamba2-780m, gemma3-4b,
    recurrentgemma-2b, internvl2-1b, musicgen-large and deepseek-v2-lite-
    16b (MLA, MoE), and in bfloat16 qwen3-14b, command-r-35b, gemma3-4b
    and dbrx-132b (MoE)) the LM
    kernels' autograd on the card (rmsnorm, flash GQA causal d 64,
    ssd chunk 256; small shapes and the training path's; flash at d 256
    with a window that masks keys, at gemma3's local (window 1024) and
    global layers at batch 4 and recurrentgemma's MQA with window 2048,
    internvl2's 14 heads over 2 and musicgen's MHA at d 64, rmsnorm over
    gemma3's qk-norm rows at batch 4 and over deepseek's 512-wide MLA
    latent (``kv_norm``); in bfloat16 flash at qwen3's, command-r's and
    dbrx's training shapes (the Hopper routes) and gemma3's local and
    global layers (d 256: the forward on the mma route, the backward on
    the Hopper route), rmsnorm at d 5120, over qwen3's
    qk-norm rows and at dbrx's d 6144; the SSD scan at mamba2's training
    shape with x / B / C in bfloat16 and in float16, each gradient in its
    input's dtype; a 16-bit output or gradient one
    ulp of it wider; each flash case on the route ``flash_route`` gives,
    and its backward on the route ``flash_backward_route`` gives):
    gradients through the Function (kernel forward; rmsnorm's and flash's
    backward kernels, the plain vjp for ssd) against all-plain autograd,
    forward within phase 4b's tolerances and gradients within them of the
    largest gradient; ``torch.func.vmap``
    of each Function equal to the per-slice calls, bit for bit where the
    rule folds the axis into the batch and within the forward tolerance
    where it loops over a parameter per replica; ``torch.func.vjp`` of
    that ``vmap`` (CohortEngine's vehicle side) under both rules against
    the per-replica vjps, within the forward tolerance of the largest
    gradient; for rmsnorm ``vmap`` of ``grad`` (scale shared and per
    replica: one backward launch for both replicas) and remat; every
    route's launches of the kernel and of its backward kernel exact;
    at the training shapes the device time of the Function's backward
    and the memory it takes, and for bfloat16 flash the device time of
    SDPA's backward on the same inputs;
10g. trains through ``repro_torch.launch.train.train`` at full width
    (seq 1024, the default cut, adamw lr 3e-4, clip 1.0, remat, 4
    clients, the donated step): smollm-360m and mamba2-780m at full depth
    and batch 8, smollm also with ``compress``;
    internvl2-1b (256 patch embeddings before 768 tokens) and
    musicgen-large at full depth, recurrentgemma-2b at one period (R, R,
    A) and its tail, all at batch 8, and gemma3-4b at one period (5 local
    + 1 global) without its tail at batch 4; in bfloat16 qwen3-14b at 15
    of 40 layers at batch 8 (also 2 layers under ``compress``, 1 step),
    command-r-35b at 3 of 40 at batch 4 and gemma3-4b whole at batch 4;
    deepseek-v2-lite-16b in float32 at 8 of 27 layers at batch 8 (the
    grouped MoE path with capacity drops) and dbrx-132b in bfloat16 at one
    layer at batch 4 (its router float32); mamba2-780m whole in bfloat16
    and in float16 and smollm-360m whole in float16 at batch 8; smollm-360m
    whole in float32 under the "dots" remat policy;
    2 steps each (depth and batch cut as one card forces, printed on each
    line; parameters in their dtype, moments float32; flash's launches
    on the route ``flash_route`` gives, 16-bit d 64 and 128 on the Hopper
    kernel, and its backward's on the route ``flash_backward_route``
    gives, 16-bit d 128 and 256 on the Hopper kernels: smollm f16's 64
    forward calls a step and gemma3 bf16's 34 backward calls); the launch
    counters zeroed just
    before and read just after each: finite losses and grad norms, the
    launches the model implies per step (remat runs each period's forward
    twice; rmsnorm's backward kernel once a norm, qk-norm's rows included:
    65 / 97 a step for smollm / mamba2), and nonzero first moments of the
    embedding (through the final rmsnorm) and in every layer of the
    attention's ``wk``, MLA's ``w_dkv``, the SSM's ``A_log`` or the
    RG-LRU's ``w_a``, of ``norm1``'s scale, under qk-norm of the
    ``q_norm`` / ``k_norm`` scales and of every MoE router (leaves whose
    gradient comes only through that layer's flash / SSD / recurrence /
    router and rmsnorm backward); prints step 0's and the later steps'
    s/step and peak memory; then one donated step against one functional
    step from the same state at qwen3-14b's width (1 layer, batch 4), bit
    for bit, the donated one in its own storage and below the functional
    one's peak; then deepseek at full width, 3 layers, batch 8, its
    objective and gradients with remat on and off: the recompute's expert
    choices and kept slots equal to the forward's (printed), losses within
    1e-5 and gradients within phase 4b's rmsnorm tolerance; then smollm
    at full width, 4 layers, batch 8: loss and gradients under the "dots"
    remat policy bit for bit those of full recompute, the matrix products
    of forward and backward counted (printed), the backward running no
    projection of the forward again under "dots" (it does under full
    recompute), the kernels' launches the same;
10h. one sgd train step of each trained arch's reduced config (smollm,
    mamba2, internvl2, musicgen at three layers; gemma3 and recurrentgemma
    at their period and tail, deepseek its MLA + MoE period and tail;
    vision and audio batches) on the card and on
    the CPU from the same weights and batch, remat on with smashed data
    dense and int8 and remat off dense: updates within phase 7's 1 % of
    the largest update, losses within 1e-4, and the card's launches exact
    (remat off runs each period's kernels once); the bfloat16 archs
    (qwen3-14b, command-r-35b, dbrx-132b, three layers) take one adamw
    step, each leaf's float32 first moment within 10 % of the CPU's in
    norm and the losses within 1e-3, and so do mamba2 in bfloat16 and in
    float16 and smollm in float16; an MoE's routing compared first, the
    (token, choice) slots routed apart printed;
10i. ``api.run`` of reduced text LMs (smollm, mamba2, recurrentgemma,
    qwen3-14b in bfloat16 and deepseek-v2-lite-16b) on ``single_rsu`` (4
    vehicles, the paper's spec, one round): ``asfl`` over ``topk_int8``
    under ``vmap`` and ``unroll`` from one seed (the same cuts), and, for
    smollm, qwen3 and deepseek, ``fl`` under ``vmap`` (the kernels
    inside ``vmap`` of ``grad``): finite loss, accuracy in [0, 1], wire
    bytes = the cost model's, and every launch count the schedule implies
    (rmsnorm's backward kernel once a norm a client batch step; under
    ``fl``'s ``vmap`` of ``grad`` once a norm a local step for all
    replicas; flash under ``vmap`` once for a bucket's replicas on the
    vehicle side, and its backward kernel once a forward call);
10j. the multi-RSU path of phase 10b under the parallel server schedule
    (arXiv:2405.18707; ``server_schedule="parallel"``): the highway on
    ``topk_int8`` under the ``ragged`` layout for 4 rounds one at a time
    (K = 1) and as one window (``superstep`` K = 4), under ``dense`` for 2
    rounds, and the urban grid's 2 ``residence`` rounds on ``int8``, the
    counters zeroed just before and read just after each: finite losses,
    RSU loads summing to the scheduled count, the cuts, handovers after
    round 0, client batch steps, and codec launches per (cut bucket,
    local step) and per (cut bucket, RSU, local step) as the schedule
    implies; K = 4 equal to K = 1 and ``dense`` equal to ``ragged`` bit
    for bit; the two-cell trace on the card against the CPU as in 10c;
    s/round printed beside phase 10b's, and each run's slot occupancy;
10k. phase 10b's highway cell with the fault plane (dropout 0.1, upload
    loss 0.05, RSU outage 0.1, a deadline at 0.01 x the residence time):
    ``sequential`` 4 rounds, ``parallel`` ``ragged`` K = 1 and one K = 4
    window, ``dense`` 2 rounds; then the ``streaming`` schedule (churn
    0.2, a buffer of 4, the ``poly`` kernel, alpha 0.5, 8 rounds, cloud
    sync every 4) as one K = 4 window and one round at a time; the
    counters zeroed just before and read just after each run: finite
    losses, dropouts + losses + stragglers + survivors = scheduled, every
    down RSU at load 0, stragglers in at least 2 rounds, StreamBuffer
    merges, occupancy below R x B, codec launches as the engine's plans
    imply (per client batch step performed, or per (cut bucket, local
    step) and per (cut bucket, RSU, local step) with an active slot);
    K = 4 equal to K = 1 bit for bit under faults and under streaming; the
    two-cell trace card vs CPU with both planes on (sequential and
    streaming); phase 10j's highway run again with fault and stream seeds
    7 equal to it bit for bit; s/round printed beside 10b's and 10j's;
10l. the city lattice and slot paging at the reference's city width
    (``benchmarks/bench_city.py``'s cell: mlp9, 4096 vehicles over a 16 x
    16 lattice of 256 RSUs, ``parallel`` ``ragged`` K = 4, one local step,
    mobility churn, cloud sync every round): (a) 4 rounds on ``none``
    unpaged and at ``page_slots=128``, each with s/round, scheduled,
    handovers, departures, ``occupancy_stats()``, the slot windows of 128
    (more than one), the peak memory and one profiled round (kernels a
    round, busy share), traced twice from a replay of the run (equal
    losses), read from the trace that kept the most kernel records, both
    counts printed: paged within 1e-6 of the largest parameter of
    unpaged, its peak below unpaged; (b) ``topk_int8`` paged, K = 4 and
    K = 1 bit for bit, codec launches per (cut bucket page, local step) and
    per (cut bucket page, RSU run, local step) counted from the plans;
    (c) the ``streaming`` schedule paged (B = 4, ``poly``, alpha 0.5, 8
    rounds, sync every 4): a merge, occupancy below R x B; (d) the reduced
    city (64 vehicles, 2 x 2, page 4, topk_int8) card vs CPU within 1e-4
    of the largest parameter;
11. prints the per-kernel JSON line (all eight kernels and the backward
    kernels of rmsnorm and flash, flash's by route, with their launches
    in phase 10g, the
    quant and LM
    kernels with their launches per training step, the LM kernels with
    their launches per served arch and their other timed shapes, flash
    with its launches per served arch by dtype, the codec
    kernels with their launches in phases 10j, 10k and 10l), then
    ``{"ok": true,
    "device": ...}`` as the last line.

Any failure raises and the script exits non-zero.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
BATCH = 16
CUT_SHAPES = {2: (BATCH, 32, 32, 64), 4: (BATCH, 16, 16, 128),
              6: (BATCH, 8, 8, 256), 8: (BATCH, 4, 4, 512)}
# (label, shape, k_frac, fill): the cut shapes, then the CPU tests' edges;
# a label ending in "_bf16" runs x (and the decoders' output) in bfloat16
CASES = ([(f"cut{c}", s, 0.25, "normal") for c, s in CUT_SHAPES.items()]
         + [("d200_k0.1", (64, 200), 0.1, "normal"),
            ("d200_k0.3", (64, 200), 0.3, "normal"),
            ("d200_k1.0", (64, 200), 1.0, "normal"),
            ("ties_cut6", (BATCH, 8, 8, 256), 0.25, "ties"),
            ("zeros_d128", (4, 128), 0.25, "zeros"),
            # the scenario path's cut (mlp9, batch 8 and 16)
            ("path_b8", (8, 64), 0.25, "normal"),
            ("path_b16", (16, 64), 0.25, "normal"),
            # the selection's edges: k = 1, +-0.0 beside subnormals, ties
            ("k1_d128", (16, 128), 0.001, "normal"),
            ("k1_ties_d64", (16, 64), 0.001, "ties"),
            ("subnormal_d128", (16, 128), 0.25, "subnormal"),
            ("subnormal_d200", (16, 200), 0.1, "subnormal"),
            ("equal_d128", (32, 128), 0.25, "equal"),
            # NaN, -NaN, +-inf, whole NaN groups beside finite ones; k = 1
            # with three NaNs in a group; the padded tail group
            ("nonfinite_cut6", (BATCH, 8, 8, 256), 0.25, "nonfinite"),
            ("nonfinite_k1_d64", (14, 64), 0.001, "nonfinite"),
            ("nonfinite_d200", (21, 200), 0.1, "nonfinite"),
            ("nonfinite_b8", (8, 64), 0.25, "nonfinite"),
            # the reference's bfloat16 inputs and outputs
            ("cut6_bf16", (BATCH, 8, 8, 256), 0.25, "normal"),
            ("path_b8_bf16", (8, 64), 0.25, "normal"),
            ("nonfinite_cut6_bf16", (BATCH, 8, 8, 256), 0.25, "nonfinite"),
            # smollm-360m's smashed tensor under compress_smashed (batch 8,
            # prompt 1024, width 960)
            ("lm_smollm", (8, 1024, 960), 0.25, "normal")])
# labels timed in phase 3: the cut shapes, the scenario path's batch 8 and
# cut6 in bfloat16; the int8 pair also at smollm's smashed tensor
TIMED = ("cut2", "cut4", "cut6", "cut8", "path_b8", "cut6_bf16")
QUANT_TIMED = {"quantize_int8": ("lm_smollm",),
               "dequantize_int8": ("lm_smollm",)}
KERNEL_META = {
    "quantize_int8": "src/repro/kernels/quant.py:37",
    "dequantize_int8": "src/repro/kernels/quant.py:76",
    "sparsify_quant_pack": "src/repro/kernels/wire.py:110",
    "unpack_dequant": "src/repro/kernels/wire.py:141",
}
SOURCE = "src/repro_torch/kernels/csrc/codec.cu"
MM_META = ("unpack_dequant_matmul", "src/repro/kernels/wire.py:170")
# kernel 5 against its plain version: |a - b| <= MM_TOL + MM_TOL * |b|
# (each slab's float32 products summed in another order; TF32 off)
MM_TOL = 1e-5
# (label, rows, d, n): the scenario path's cut (batch 8 and 16), one row,
# a partial 8-row tile, the CPU tests' shapes, a ragged tile / last group /
# column edge, the wide case, wide rows over 2 column blocks (16-row tiles)
MM_CASES = [("path_b8", 8, 64, 64), ("path_b16", 16, 64, 64),
            ("rows1", 1, 64, 64), ("rows9", 9, 64, 64),
            ("d256_n64", 16, 256, 64), ("d200_n32", 16, 200, 32),
            ("d48_n16", 16, 48, 16), ("ragged", 37, 130, 70),
            ("wide", 4096, 512, 64), ("wide_n128", 4096, 256, 128),
            ("wide_ragged", 4096, 130, 70),
            # w in bfloat16 (a label ending in "_bf16")
            ("path_b8_bf16", 8, 64, 64),
            # NaN / +-inf smashed values: NaN output rows
            ("nonfinite_b16", 16, 64, 64), ("nonfinite_d200", 21, 200, 32)]
# ---- the multi-RSU scenario path (benchmarks/bench_scenarios.py's cell)
SCEN_VEHICLES, SCEN_ROUNDS, SCEN_STEPS, SCEN_BATCH = 256, 4, 2, 8
SCEN_LR = 1e-3
# codec launches per client batch step on the scenario path (mlp9):
#   topk_int8: pack up + pack down; unpack for the vehicle's error-feedback
#     residual, for the RSU's dW (the fused matmul's backward) and for the
#     downlink; the fused matmul once (the RSU's first unit);
#   int8: quantize and dequantize once each way.
SCEN_LAUNCHES = {
    "topk_int8": {"sparsify_quant_pack": 2, "unpack_dequant": 3,
                  "unpack_dequant_matmul": 1},
    "int8": {"quantize_int8": 2, "dequantize_int8": 2}}
TRACE_TOL = 1e-4                # phase 10c: of the largest parameter
SGD_LR = 1e-2                   # phase 7: updates far above f32 rounding
STEP_RTOL = 1e-2                # phase 7: card vs CPU, of the largest update

# ---- the LM lane
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
#                                 (NVIDIA data sheet)
TF32_FLOPS_PER_S = 495e12       # H100 SXM TF32 tensor cores, dense (ditto)
BF16_FLOPS_PER_S = 989e12       # H100 SXM bf16 / fp16 tensor cores, dense
# kernels whose products run 3xTF32 on the tensor cores: three TF32
# products per float32 product
TENSOR_CORE_KERNELS = ("flash_attention", "flash_attention_backward",
                       "ssd_chunk_scan")
LM_SOURCE = "src/repro_torch/kernels/csrc/lm.cu"
LM_META = {
    "rmsnorm": "src/repro/kernels/rmsnorm.py:27",
    "flash_attention": "src/repro/kernels/flash_attention.py:94",
    "ssd_chunk_scan": "src/repro/kernels/ssd.py:68",
}
# kernel vs plain version, |a - b| <= tol + tol * |b|:
#   rmsnorm: the sum of squares in another order, rsqrtf within 2 ulp;
#   flash: float32 sums over up to 1024 keys in another order, and the
#     online rescaling (the reference's 2e-5 covers <= 256 keys);
#   ssd: exp of differences of prefix sums of dt*A (|cum| up to a few
#     hundred, one ulp ~3e-5) in another order: the reference's tolerance
#     of its own SSD kernel (tests/test_kernels.py).
#   rmsnorm_backward: the sums over d and over the rows in another order:
#     its tolerance times each gradient's largest value (dscale sums
#     8,192-65,536 rows);
#   16-bit rmsnorm: one ulp of the working type (the float32 results
#     differ by a few float32 ulps and are rounded once), the backward's
#     plus its float32 tolerance (dx subtracts terms of similar size).
#   flash_attention_backward: flash's float32 tolerance of each case's
#     largest gradient (sums over up to 1024 keys or queries and a GQA
#     group's heads in another order), a 16-bit gradient one ulp of its
#     dtype more.
LM_TOL = {"rmsnorm": 2e-5, "rmsnorm_backward": 2e-5,
          "flash_attention": 1e-4, "flash_attention_backward": 1e-4,
          "ssd_chunk_scan": 2e-4}
# the backward kernel (two kernels a call) replaces no TPU kernel: the JAX
# package differentiates rmsnorm_ref by autodiff
RMS_BWD_REPLACES = ("none: jax.vjp of rmsnorm_ref "
                    "(src/repro/kernels/ref.py:45), the port's plain vjp")
# flash's backward kernel (three kernels a call) replaces no TPU kernel
# either: the JAX package's flash_attention has no custom_vjp
FLASH_BWD_REPLACES = ("none: jax.vjp of attention_ref "
                      "(src/repro/kernels/ref.py:11; flash_attention, "
                      "src/repro/kernels/flash_attention.py:94, has no "
                      "custom_vjp), the port's plain vjp")
# the 16-bit backward kernels run S and dP three times (mma: in each of
# three passes; Hopper: twice in the dQ kernel, once in the dK / dV one)
# and split the three products with a float32 left operand into hi / lo
# halves: 24 d flops of 16-bit products a visible pair and head on either
# route, against the five products' 10 d
FLASH_BWD_SPLIT = 2.4
# the kernel a timed call launches (a pattern of its name), or None where
# the wrapper launches several (timed together); flash's names both routes'
# kernels, of which a call launches one
LM_SYMBOL = {"rmsnorm": "rmsnorm_",
             "flash_attention": "flash_attention_(?:hopper_)?kernel"}
# flash's Hopper route (csrc/flash_hopper.cu) as a kernel of its own in the
# JSON line, and the timed row it reports
HOPPER_NAME, HOPPER_SOURCE = ("flash_attention_hopper",
                              "src/repro_torch/kernels/csrc/flash_hopper.cu")
HOPPER_MAIN = "qwen3_prefill_bf16"
# flash's backward on the Hopper route (csrc/flash_hopper_bwd.cu: 16-bit
# d 128), a kernel of its own in the JSON line, and its timed row; the mma
# route's entry reports the same shape forced onto it, in the same call
HOPPER_BWD_NAME, HOPPER_BWD_SOURCE = (
    "flash_attention_backward_hopper",
    "src/repro_torch/kernels/csrc/flash_hopper_bwd.cu")
HOPPER_BWD_MAIN = "qwen3_train_bf16"
# the head dims the Hopper routes took on after d 128, each an entry of
# its own in the JSON line with its timed row: the forward's d 64
# (smollm-360m's f16 step) and the backward's d 256 (gemma3-4b's bf16 step)
HOPPER_D64_NAME, HOPPER_D64_MAIN = ("flash_attention_hopper_d64",
                                    "smollm_prefill_f16")
HOPPER_BWD_D256_NAME, HOPPER_BWD_D256_MAIN = (
    "flash_attention_backward_hopper_d256", "gemma3_global_train_bf16")
# the Hopper kernels whose ptxas report the build prints, and fails on a
# spill of, with the head dims each is instantiated at (in bf16 and f16)
HOPPER_KERNELS = {"flash_attention_hopper_kernel": (64, 128),
                  "flash_bwd_hopper_dq_kernel": (128, 256),
                  "flash_bwd_hopper_dkdv_kernel": (128, 256)}
# phase 8-10's served archs
# (deepseek-v2-lite-16b after the float32 ones: its 62.8 GB of float32
# weights take the card after every other arch's are freed; then the
# bfloat16 archs, qwen3-14b's 29.6 GB and command-r-35b's 64.8 GB, each on
# a freed card, so that every earlier arch is measured as before them)
SERVE_ARCHS = ("smollm-360m", "mamba2-780m", "gemma3-4b",
               "recurrentgemma-2b", "internvl2-1b", "musicgen-large",
               "deepseek-v2-lite-16b", "qwen3-14b", "command-r-35b",
               # the SSD scan on 16-bit inputs (1.7 GB of weights each),
               # after every earlier arch so those are measured as before
               "mamba2-780m:bfloat16", "mamba2-780m:float16")
# phases 10f-10i train every arch: the float32 ones (smollm, mamba2,
# internvl2 and musicgen at full depth; recurrentgemma and gemma3 at the
# depth of TRAIN_RUNS, phase 10g; deepseek-v2-lite-16b, MLA and MoE, at
# the depth one card holds) and, in bfloat16, qwen3-14b and command-r-35b
# at the depth one card holds, dbrx-132b (MoE) at one layer, and gemma3-4b
# at full depth
TRAIN_ARCHS = ("smollm-360m", "mamba2-780m", "gemma3-4b",
               "recurrentgemma-2b", "internvl2-1b", "musicgen-large",
               "deepseek-v2-lite-16b")
BF16_TRAIN_ARCHS = ("qwen3-14b", "command-r-35b", "dbrx-132b")
# the 16-bit parameter dtypes; a label "<arch>:<dtype>" serves or trains
# the arch with its parameters in that dtype (``dataclasses.replace(cfg,
# param_dtype=...)``, as a user would)
LOW_DTYPES = ("bfloat16", "float16")
# phase 10's and 10h's reduced configs grown to three periods (one layer a
# period); the families keep their reduced depth (one pattern and the tail)
THREE_PERIOD_ARCHS = ("smollm-360m", "mamba2-780m")
# phase 10's reduced bfloat16 archs beside the served ones: dbrx-132b's
# 263 GB of bfloat16 weights fit no card, its -smoke does
REDUCED_ONLY = ("dbrx-132b",)
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 8, 1024, 32
TRAIN_BATCH, TRAIN_SEQ = 8, 1024   # phases 4b and 10f-10i
# phase 4b's 16-bit flash cases, each in bfloat16 and float16: (label,
# (b, sq, sk, h, kv, d, causal, window), the dtypes timed).  Every head dim
# and the float32 edges (windows, MQA, ragged s, masked rows, one query),
# the d-128 edges (the Hopper route's), and the bfloat16 archs' prefills at
# d 128: qwen3-14b's 40 heads over 8, command-r-35b's 64 over 8.  A timed
# row is also checked on the mma route (its label + "_mma"), untimed where
# PR 28 recorded both routes' times (PERF.md section 6, rows 6h-6j), timed
# at the rows of FLASH16_MMA_TIMED.
FLASH16_CASES = (
    # smollm-360m's shape, timed in float16: its f16 train step's forward
    # (phase 10g, the Hopper route at d 64)
    ("smollm_prefill", (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 15, 5, 64,
                        True, 0), ("f16",)),
    ("d128_ragged", (1, 100, 100, 4, 2, 128, True, 0), ()),
    # the d-64 Hopper route's ragged edges: s past a 128-row tile, sq != sk
    # under a window
    ("d64_ragged", (2, 1087, 1087, 15, 5, 64, True, 0), ()),
    ("d64_window_sq_lt_sk", (2, 130, 260, 4, 2, 64, True, 100), ()),
    ("d256_mqa", (1, 70, 70, 4, 1, 256, True, 0), ()),
    ("d32_reduced", (2, 37, 37, 4, 2, 32, True, 0), ()),
    ("window48", (2, 200, 200, 4, 2, 64, True, 48), ()),
    ("noncausal", (2, 48, 80, 2, 2, 64, False, 0), ()),
    ("masked_rows", (1, 64, 16, 2, 1, 64, False, 8), ()),
    ("sq1", (2, 1, 77, 4, 2, 64, False, 0), ()),
    ("d256_window40", (1, 90, 90, 2, 1, 256, True, 40), ()),
    ("qk_x4", (1, 256, 256, 4, 2, 64, True, 0), ()),
    ("window48_d128", (2, 200, 200, 4, 2, 128, True, 48), ()),
    ("noncausal_d128", (2, 48, 80, 2, 2, 128, False, 0), ()),
    ("masked_rows_d128", (1, 64, 16, 2, 1, 128, False, 8), ()),
    ("sq1_d128", (2, 1, 77, 4, 2, 128, False, 0), ()),
    ("qwen3_prefill", (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 40, 8, 128,
                       True, 0), ("bf16", "f16")),
    ("command_r_prefill", (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 64, 8,
                           128, True, 0), ("bf16",)),
    # the bfloat16 train steps' forwards (phase 10g): gemma3-4b's global
    # layer at batch 4 (d 256: the mma route; its local layer's window of
    # 1024 masks nothing at s 1024) and dbrx-132b's at batch 4, 48 heads
    # over 8 (d 128: the Hopper route)
    ("gemma3_train", (4, SERVE_PROMPT, SERVE_PROMPT, 8, 4, 256, True, 0),
     ("bf16",)),
    ("dbrx_train", (4, SERVE_PROMPT, SERVE_PROMPT, 48, 8, 128, True, 0),
     ("bf16",)))
# the timed FLASH16_CASES rows whose mma twin is timed too: the d-64 Hopper
# route's (the kernel and the route it replaced, in one call)
FLASH16_MMA_TIMED = ("smollm_prefill",)
# phase 4b's backward cases: (label, (b, sq, sk, h, kv, d, causal,
# window), dtype, timed).  Timed: the training shapes of the archs' steps
# (phase 10g) in their dtype: qwen3-14b's and command-r-35b's (at batch 8,
# as their plain backward was first timed), dbrx-132b's and gemma3-4b's
# global layer in bfloat16, smollm in float16, and in float32 smollm,
# gemma3 (batch 4), recurrentgemma, internvl2 and musicgen.  Untimed, in
# every dtype: every head dim, windows that mask keys, sq != sk (rows
# that see no key), one query, q / k / v as views of one fused projection
# (aligned, and misaligned by one element) with a strided cotangent, at
# d 64 and 256, and gemma3's local layer (its window of 1024 masks nothing
# at s 1024: the global layer's work, timed apart until the Hopper
# backward's rows); the d-256 Hopper route's edges (sq > sk, non-causal
# sq < sk, rows with no key, one query).
FLASH_BWD_TRAIN = (
    ("qwen3_train", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 40, 8, 128, True, 0),
     "bf16"),
    ("command_r_train", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 64, 8, 128, True,
                         0), "bf16"),
    ("dbrx_train", (4, TRAIN_SEQ, TRAIN_SEQ, 48, 8, 128, True, 0), "bf16"),
    ("gemma3_global_train", (4, TRAIN_SEQ, TRAIN_SEQ, 8, 4, 256, True, 0),
     "bf16"),
    ("smollm_train", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 15, 5, 64, True, 0),
     "f16"),
    ("smollm_train", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 15, 5, 64, True, 0),
     "f32"),
    ("gemma3_global_train", (4, TRAIN_SEQ, TRAIN_SEQ, 8, 4, 256, True, 0),
     "f32"),
    ("recurrentgemma_train", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 10, 1, 256,
                              True, 2048), "f32"),
    ("internvl2_train", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 14, 2, 64, True,
                         0), "f32"),
    ("musicgen_train", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 32, 64, True,
                        0), "f32"))
FLASH_BWD_EDGES = (
    ("d32", (2, 37, 37, 4, 2, 32, True, 0)),
    ("d128", (2, 100, 100, 4, 2, 128, True, 0)),
    ("d256_mqa", (1, 70, 70, 4, 1, 256, True, 0)),
    ("window48", (2, 200, 200, 4, 2, 64, True, 48)),
    ("noncausal_sq_lt_sk", (2, 48, 80, 2, 2, 64, False, 0)),
    ("masked_rows", (1, 64, 16, 2, 1, 64, False, 8)),
    ("causal_sq_gt_sk", (2, 80, 48, 4, 2, 128, True, 0)),
    ("sq1", (2, 1, 77, 4, 2, 64, False, 0)),
    ("d256_window40", (1, 90, 90, 2, 1, 256, True, 40)),
    ("d32_window20", (2, 150, 150, 6, 3, 32, False, 20)),
    ("strided_qkv", (2, 50, 50, 4, 2, 64, True, 0)),
    ("strided_qkv_odd", (2, 50, 50, 4, 2, 64, True, 0)),
    ("strided_qkv_d256", (2, 50, 50, 4, 2, 256, True, 0)),
    ("strided_qkv_d256_odd", (2, 50, 50, 4, 2, 256, True, 0)),
    ("d256_sq_gt_sk", (2, 80, 48, 4, 2, 256, True, 0)),
    ("d256_noncausal_sq_lt_sk", (2, 48, 80, 2, 2, 256, False, 0)),
    ("d256_masked_rows", (1, 64, 16, 2, 1, 256, False, 8)),
    ("d256_sq1", (2, 1, 77, 4, 2, 256, False, 0)),
    ("gemma3_local_train", (4, TRAIN_SEQ, TRAIN_SEQ, 8, 4, 256, True,
                            1024)))
TEACHER_TOL = 1e-3              # phase 9: f32 through 24-48 layers, prefill
#                                 (kernels) vs decode (plain) sum orders
REDUCED_TOL = 2e-4              # phase 10: as the CPU parity tests
# phases 9 and 10 on bfloat16 weights: logits within BF16_ULPS ulps of
# bfloat16 at the largest |logit| (tests/test_torch_serve_bf16.py's
# tolerance; its measured spread, port against the reference and each
# against float32, was 2.5-3.3 ulps through 3 layers, and prefill(s-1) +
# decode against prefill(s) on the CPU 2-3.5 ulps through 1-40 layers of
# the reduced widths, in bfloat16 both ways)
BF16_ULPS = 8
# phase 10 on a bfloat16 MoE: an expert choice that a near tie of the
# router's probabilities sends the other way on the card and on the CPU
# changes a row's logits by O(1); such rows (independent sequences) are
# left out, counted, and at least half of BF16_ROWS must be routed alike
BF16_ROWS = 8


# CUPTI drops the records of runs of launches: on the card a trace's
# first two as a rule, at times up to 57 of 100 calls of a row, now and
# then in the middle, and on some traces 26 of 100 at the end; and a
# plain function's kernel can change its name from trace to trace
# (vectorised or unrolled, by a buffer's alignment).  So a time per call
# is read from the launches that were recorded (:func:`_per_call_ms`).  A
# trace opens with LEAD_IN_CALLS launches of a kernel of its own, a
# synchronize and LEAD_IN_S of sleep, left out; a time takes
# TRACES_PER_TIME traces, and one that holds no device kernel is taken
# again, at most PROFILE_ATTEMPTS more times
PROFILE_ATTEMPTS = 3
TRACES_PER_TIME = 2
LEAD_IN_CALLS, LEAD_IN_S, LEAD_IN_KERNEL = 64, 0.05, "erfinv"
# an L2-flushed timing writes this many bytes before each call (5x the
# H100's 50 MB L2), with a kernel named apart from the timed ones
L2_FLUSH_BYTES = 256 * 2 ** 20
FLUSH_KERNEL = "bitwise_not"


def _call_ms(fn, iters):
    """Mean milliseconds per call over ``iters`` back-to-back calls (CUDA
    events): at the codec's sizes this is the Python wrapper and launch."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _trace(fn, iters):
    """{kernel name: profiler event} of ``iters`` calls of ``fn`` in one
    ``torch.profiler`` trace, after the lead-in (LEAD_IN_CALLS launches of
    ``erfinv_``, a synchronize, LEAD_IN_S of sleep), which is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    lead = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN_CALLS):
            lead.erfinv_()
        torch.cuda.synchronize()
        time.sleep(LEAD_IN_S)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and LEAD_IN_KERNEL not in e.key}


def _traces(fn, iters, skip=None):
    """TRACES_PER_TIME traces of ``iters`` calls of ``fn`` (:func:`_trace`)
    that hold some device kernel, the kernels whose names hold ``skip``
    left out; an empty trace is taken again, at most PROFILE_ATTEMPTS more
    times in all."""
    out, empty = [], 0
    while len(out) < TRACES_PER_TIME:
        dev = {k: e for k, e in _trace(fn, iters).items()
               if skip is None or skip not in k}
        if dev:
            out.append(dev)
            continue
        empty += 1
        print(f"profiler: trace of {iters} calls holds no device kernel",
              flush=True)
        if empty > PROFILE_ATTEMPTS:
            raise AssertionError(f"profiler: {empty} traces of {iters} "
                                 f"calls hold no device kernel")
    return out


def _per_call_ms(traces, iters):
    """Device milliseconds per call from traces of ``iters`` calls that may
    have lost records: each kernel's launches per call (its recorded
    launches over ``iters``, rounded up, which is right while it lost
    fewer than ``iters`` records) times its mean time per recorded launch,
    summed over the kernels of the trace with the most launches per call
    (then the most records)."""
    def per_call(e):
        return -(-e.count // iters)

    dev = max(traces, key=lambda d: (sum(map(per_call, d.values())),
                                     sum(e.count for e in d.values())))
    short = sorted((k[:60], e.count) for k, e in dev.items()
                   if e.count % iters)
    if short:
        print(f"profiler: {iters} calls traced with lost records {short}; "
              f"timed per recorded launch", flush=True)
    return sum(per_call(e) * e.self_device_time_total / e.count
               for e in dev.values()) / 1e3


def _device_ms(fn, iters, symbol=None):
    """Device milliseconds per call: the kernel time (CUPTI, through
    ``torch.profiler``) of every device kernel a call launches
    (:func:`_per_call_ms` of :func:`_traces`).  With ``symbol``, exactly
    one kernel name matches it, and the result is its mean time per
    recorded launch in one trace (taken again, at most PROFILE_ATTEMPTS
    more times, while no kernel matches)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if symbol is None:
        return _per_call_ms(_traces(fn, iters), iters)
    # not preceded by a name character: quantize_int8_kernel must not
    # match dequantize_int8_kernel (mangled or demangled names)
    pat = re.compile(r"(^|[^A-Za-z_])" + symbol)
    for _ in range(PROFILE_ATTEMPTS + 1):
        dev = _trace(fn, iters)
        hits = [e for k, e in dev.items() if pat.search(k)]
        if hits:
            break
    if len(hits) != 1 or not 0 < hits[0].count <= iters:
        raise AssertionError(
            f"profiler: expected up to {iters} launches of {symbol}, got "
            f"{[(e.key, e.count) for e in hits]} among {list(dev)}")
    return hits[0].self_device_time_total / hits[0].count / 1e3


def _device_ms_flushed(fn, iters):
    """Device milliseconds per call with L2 flushed before each call: a
    ``bitwise_not_`` over L2_FLUSH_BYTES, then ``fn``; the time of ``fn``'s
    kernels (the flush's own, whose name holds FLUSH_KERNEL, left out) as
    :func:`_device_ms` reads it.  Every recorded launch of ``fn`` follows
    its call's flush on the stream, whether or not the flush's record was
    kept."""
    import torch
    buf = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")

    def flushed():
        buf.bitwise_not_()
        fn()
    for _ in range(3):
        flushed()
    torch.cuda.synchronize()
    return _per_call_ms(_traces(flushed, iters, FLUSH_KERNEL), iters)


def _nonfinite(shape, seed):
    """Normal values (x 3) with, row by row in turn, in the row's first
    quantisation group (g = min(128, d)): one NaN; three NaNs; a -NaN; +inf
    beside -inf (in the row's last group when it has two or more); a whole
    NaN group; a NaN beside +inf; nothing (the CPU tests' fill)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=shape) * 3.0).astype(np.float32)
    d = shape[-1]
    g = min(128, d)
    rows = a.reshape(-1, d)                       # a view: writes go to a
    for r in range(rows.shape[0]):
        cols = rng.permutation(g)[:3]
        kind = r % 7
        if kind == 0:
            rows[r, cols[0]] = np.nan
        elif kind == 1:
            rows[r, cols] = np.nan
        elif kind == 2:
            rows[r, cols[0]] = np.uint32(0xFFC00000).view(np.float32)
        elif kind == 3:
            rows[r, cols[0]] = np.inf
            rows[r, cols[1] if d == g else d - 1] = -np.inf
        elif kind == 4:
            rows[r, :g] = np.nan
        elif kind == 5:
            rows[r, cols[:2]] = (np.nan, np.inf)
    return a


def _same(a, b, scale_word=None):
    """(equal, max |a - b| where both are finite) under the codec's
    non-finite contract: floats NaN exactly where the other is NaN and
    every other element bit for bit; int tensors bit for bit; with
    ``scale_word = (bw, wpg)`` an int32 wire buffer whose scale words are
    compared as floats (``torch.equal`` is False on NaN)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False, math.inf
    if scale_word is not None:
        bw, wpg = scale_word
        a, b = a.reshape(-1, wpg), b.reshape(-1, wpg)
        ints = torch.arange(wpg, device=a.device) != bw
        ok, _ = _same(a[:, bw].contiguous().view(torch.float32),
                      b[:, bw].contiguous().view(torch.float32))
        return ok and torch.equal(a[:, ints], b[:, ints]), _abs_err(a, b)
    if not a.is_floating_point():
        return torch.equal(a, b), _abs_err(a, b)
    nan = torch.isnan(a)
    bits = torch.int32 if a.element_size() == 4 else torch.int16
    ok = (torch.equal(nan, torch.isnan(b))
          and torch.equal(a[~nan].view(bits), b[~nan].view(bits)))
    return ok, _abs_err(a, b)


def _abs_err(a, b):
    """max |a - b| over the elements finite in both (0 when none is)."""
    import torch
    a, b = a.to(torch.float64), b.to(torch.float64)
    both = torch.isfinite(a) & torch.isfinite(b)
    return float((a - b)[both].abs().max()) if bool(both.any()) else 0.0


def _make_input(shape, fill, seed):
    import numpy as np
    import torch
    if fill == "nonfinite":
        return torch.from_numpy(_nonfinite(shape, seed)).cuda()
    rng = np.random.default_rng(seed)
    if fill == "normal":
        a = rng.normal(size=shape) * 3.0
    elif fill == "ties":
        a = rng.integers(-3, 4, size=shape)
    elif fill == "equal":
        a = np.where(rng.random(shape) < 0.5, -1.5, 1.5)
    elif fill == "subnormal":
        # +-0.0 and +-subnormals (repeated: ties), a few normal values
        sub = (rng.integers(1, 1 << 23, size=shape).astype(np.uint32)
               .view(np.float32) * np.where(rng.random(shape) < 0.5,
                                            np.float32(-1), np.float32(1)))
        a = np.where(rng.random(shape) < 0.5, -0.0, 0.0).astype(np.float32)
        a = np.where(rng.random(shape) < 0.4, sub, a)
        a = np.where(rng.random(shape) < 0.2, sub[..., ::-1], a)
        a = np.where(rng.random(shape) < 0.05, rng.normal(size=shape), a)
    else:
        a = np.zeros(shape)
    return torch.from_numpy(a.astype(np.float32)).cuda()


def _bound_ms(name, shape, k_frac, esize=4):
    """Bytes each input read once and each output written once, over HBM
    bandwidth; the float tensor (x, or a decoder's output) has ``esize``
    bytes a value.  Each function does a few f32 operations per element,
    which over the card's f32 rate take far less than its bytes, so bytes
    bound."""
    from repro_torch.core import compression as C
    d = shape[-1]
    n = math.prod(shape)
    rows = n // d
    g, ng, k, wpg = C.wire_layout(d, k_frac)
    scales = 4 * rows * ng
    wire = 4 * rows * ng * wpg
    nbytes = {"quantize_int8": esize * n + n + scales,
              "dequantize_int8": n + scales + esize * n,
              "sparsify_quant_pack": esize * n + wire,
              "unpack_dequant": wire + esize * n}[name]
    return 1e3 * nbytes / HBM_BYTES_PER_S


def check_kernels():
    """Phase 3: every kernel equal to its plain version on the card, at
    every case; times at the cut shapes.  Returns {kernel: {label: row}}."""
    import torch
    from repro_torch.core import compression as C
    from repro_torch.kernels import quant, wire
    out = {name: {} for name in KERNEL_META}
    for ci, (label, shape, kf, fill) in enumerate(CASES):
        dt = torch.bfloat16 if label.endswith("_bf16") else torch.float32
        x = _make_input(shape, fill, seed=ci).to(dt)
        d = shape[-1]
        rows = math.prod(shape) // d
        g, ng, k, wpg = C.wire_layout(d, kf)
        q, s = quant.quantize_int8(x)
        q_ref, s_ref = (t.contiguous() for t in C.quantize_int8(x))
        buf = wire.sparsify_quant_pack(x, kf)
        buf_ref = C.sparsify_quant_pack_ref(x, kf)
        lib_dequant = None
        # one PyTorch call, the same function (in f32: a bf16 output would
        # take a second call)
        if ng * g == d and dt == torch.float32:
            def lib_dequant(q=q_ref, s=s_ref, rows=rows, ng=ng, g=g):
                return torch.mul(q.view(rows, ng, g), s.view(rows, ng, 1))
        pairs = {
            "quantize_int8": ((q, s), (q_ref, s_ref),
                              lambda: quant.quantize_int8(x),
                              lambda: C.quantize_int8(x), None),
            "dequantize_int8": (
                (quant.dequantize_int8(q_ref, s_ref, dtype=dt),),
                (C.dequantize_int8(q_ref, s_ref, dt),),
                lambda: quant.dequantize_int8(q_ref, s_ref, dtype=dt),
                lambda: C.dequantize_int8(q_ref, s_ref, dt), lib_dequant),
            "sparsify_quant_pack": ((buf,), (buf_ref,),
                                    lambda: wire.sparsify_quant_pack(x, kf),
                                    lambda: C.sparsify_quant_pack_ref(x, kf),
                                    None),
            "unpack_dequant": (
                (wire.unpack_dequant(buf_ref, d, kf, dtype=dt),),
                (C.wire_dequant_ref(buf_ref, d, kf, dtype=dt),),
                lambda: wire.unpack_dequant(buf_ref, d, kf, dtype=dt),
                lambda: C.wire_dequant_ref(buf_ref, d, kf, dtype=dt), None),
        }
        if lib_dequant is not None:     # the yardstick computes it too
            lib_ok, _ = _same(lib_dequant().reshape(q_ref.shape),
                              pairs["dequantize_int8"][1][0])
            if not lib_ok:
                raise AssertionError(f"torch.mul differs from the plain "
                                     f"dequantize at {label}")
        torch.cuda.synchronize()
        for name, (got, want, run_k, run_p, run_lib) in pairs.items():
            word = (-(-g // 32), wpg) if name == "sparsify_quant_pack" \
                else None
            same = [_same(a, b, word) for a, b in zip(got, want)]
            equal = all(ok for ok, _ in same)
            err = max(e for _, e in same)
            row = {"shape": list(shape), "k_frac": kf, "fill": fill,
                   "dtype": str(dt).replace("torch.", ""), "equal": equal,
                   "max_abs_err": err}
            if label in TIMED or label in QUANT_TIMED.get(name, ()):
                row["ms"] = _device_ms(run_k, 200, f"{name}_kernel")
                row["plain_ms"] = _device_ms(run_p, 100)
                row["call_ms"] = _call_ms(run_k, 200)
                row["bound_ms"] = _bound_ms(name, shape, kf,
                                            x.element_size())
                row["library_ms"] = (_device_ms(run_lib, 200) if run_lib
                                     else None)
            out[name][label] = row
            print(f"kernel {name:20s} {label:11s} shape={list(shape)} "
                  f"k_frac={kf} dtype={row['dtype']} equal={equal} "
                  f"max_abs_err={err:g}"
                  + (f" ms={row['ms']:.6f} plain_ms={row['plain_ms']:.6f} "
                     f"call_ms={row['call_ms']:.6f} "
                     f"bound_ms={row['bound_ms']:.6f} "
                     f"library_ms={row['library_ms']}"
                     if "ms" in row else ""), flush=True)
            if not equal:
                raise AssertionError(f"{name} differs from its plain "
                                     f"version at {label} {shape}")
    return out


def check_matmul_kernel():
    """Phase 4: kernel 5 against its plain version at every case (every
    case is checked before a failure stops the run), the no-materialization
    property on the wide case, its device time at every case and, at the
    path's shape (batch 8), the call, the plain version and the bound.
    Returns {label: row}."""
    import numpy as np
    import torch
    from repro_torch.core import compression as C
    from repro_torch.kernels import wire
    out, bad = {}, []
    for ci, (label, rows, d, n) in enumerate(MM_CASES):
        fill = "nonfinite" if label.startswith("nonfinite") else "normal"
        x = _make_input((rows, d), fill, seed=100 + ci) / 3.0
        rng = np.random.default_rng(200 + ci)
        w = torch.from_numpy((rng.normal(size=(d, n)) * math.sqrt(2.0 / d))
                             .astype(np.float32)).cuda()
        if label.endswith("_bf16"):
            w = w.to(torch.bfloat16)
        buf = wire.sparsify_quant_pack(x)
        got = wire.unpack_dequant_matmul(buf, w)
        want = C.wire_dequant_matmul_ref(buf, w)
        torch.cuda.synchronize()
        # a group that decodes to NaN makes its output row NaN, on both
        nan = torch.isnan(want)
        diff = (got - want)[~nan].abs()
        err = float(diff.max())
        ok = (torch.equal(torch.isnan(got), nan)
              and bool(nan.any()) == (fill == "nonfinite")
              and bool((diff <= MM_TOL + MM_TOL * want[~nan].abs()).all()))
        row = {"shape": [rows, d, n], "max_abs_err": err, "within_tol": ok,
               "fill": fill, "max_abs_out": float(want[~nan].abs().max()),
               "ms": _device_ms(lambda: wire.unpack_dequant_matmul(buf, w),
                                200 if label == "path_b8" else 50,
                                "unpack_dequant_matmul_kernel")}
        if label == "wide":
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res = wire.unpack_dequant_matmul(buf, w)
            torch.cuda.synchronize()
            grew = torch.cuda.max_memory_allocated() - base
            limit = 4 * res.numel() + 4 * rows * d
            entry = wire.dequant_matmul(buf, w.clone().requires_grad_(True))
            saved = [(str(t.dtype), list(t.shape))
                     for t in entry.grad_fn.saved_tensors]
            dense_saved = any(t.dtype == torch.float32
                              and tuple(t.shape) == (rows, d)
                              for t in entry.grad_fn.saved_tensors)
            row.update(peak_growth_bytes=grew, limit_bytes=limit,
                       saved_tensors=saved)
            print(f"kernel unpack_dequant_matmul no-materialization: peak "
                  f"growth {grew} B < output + dense smashed {limit} B: "
                  f"{grew < limit}; saved tensors {saved}", flush=True)
            if grew >= limit or dense_saved:
                bad.append(f"{label}: materialized (grew {grew} B, saved "
                           f"{saved})")
        if label == "path_b8":
            g, ng, k, wpg = C.wire_layout(d)
            nbytes = 4 * (buf.numel() + w.numel() + rows * n)
            # a sparse product: this run's data has k survivors per group
            flops = 2 * rows * ng * k * n
            bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            ops_ms = 1e3 * flops / F32_FLOPS_PER_S
            row.update(
                call_ms=_call_ms(lambda: wire.unpack_dequant_matmul(buf, w),
                                 200),
                plain_ms=_device_ms(
                    lambda: C.wire_dequant_matmul_ref(buf, w), 100),
                unpack_then_matmul_ms=_device_ms(
                    lambda: wire.unpack_dequant(buf, d) @ w, 100),
                library_ms=None, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes, flops=flops,
                dense_flops_bound_ms=1e3 * 2 * rows * d * n
                / F32_FLOPS_PER_S)
        out[label] = row
        print(f"kernel unpack_dequant_matmul {label:9s} rows={rows} d={d} "
              f"n={n} max_abs_err={err:g} max_abs_out="
              f"{row['max_abs_out']:g} tol={MM_TOL:g} ok={ok} "
              f"ms={row['ms']:.6f}"
              + (f" call_ms={row['call_ms']:.6f} "
                 f"plain_ms={row['plain_ms']:.6f} unpack_then_matmul_ms="
                 f"{row['unpack_then_matmul_ms']:.6f} bound_ms="
                 f"{row['bound_ms']:.6f} bound_by={row['bound_by']}"
                 if "call_ms" in row else ""), flush=True)
        if not ok:
            bad.append(f"{label}: error {err:g} outside tolerance")
    if bad:
        raise AssertionError(f"unpack_dequant_matmul: {bad}")
    return out


def launch_floor_ms():
    """The card's floor for one launch: the device time of ``zero_()`` on a
    one-element tensor (``torch.profiler``), printed beside the codec's
    times."""
    import torch
    z = torch.empty(1, device="cuda")
    ms = _device_ms(lambda: z.zero_(), 200)
    print(f"launch_floor zero_ numel=1 ms={ms:.6f}", flush=True)
    return ms


def _scenario_spec(scenario, n, rounds, strategy, wire, sync=1):
    from repro_torch import api
    return api.ExperimentSpec(
        model="mlp9",
        train=api.TrainConfig(scheme="asfl", rounds=rounds,
                              local_steps=SCEN_STEPS, batch_size=SCEN_BATCH,
                              lr=SCEN_LR, optimizer="sgd", eval_every=0,
                              wire=wire),
        adaptive=api.AdaptiveConfig(strategy=strategy),
        fleet=api.FleetConfig(n_vehicles=n, scenario=scenario,
                              scenario_kwargs={"seed": n},
                              cloud_sync_every=sync, round_interval_s=10.0,
                              per_vehicle_samples=64, data_seed=n))


def scenario_path(scenario, rounds, strategy, wire, cut_set):
    """Phase 10b: the multi-RSU path through ``repro_torch.api.run`` on the
    card, the launch counters zeroed just before and read just after.
    Returns (launches, timing row)."""
    import torch
    from repro_torch import api, kernels
    spec = _scenario_spec(scenario, SCEN_VEHICLES, rounds, strategy, wire)
    marks = []

    def on_round(m):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if not (math.isfinite(m.loss) and set(m.cuts) <= cut_set
                and sum(m.rsu_loads) == m.n_scheduled > 0
                and len(m.cuts) == SCEN_VEHICLES):
            raise AssertionError(f"bad scenario round: {m}")

    kernels.reset_launches()
    res = api.run(spec, on_round=on_round)
    counts = kernels.launch_counts()
    run_s = res.timing["run_s"]
    walls = [run_s - (marks[-1] - marks[0])] + [
        b - a for a, b in zip(marks, marks[1:])]
    for m, wall in zip(res.history, walls):
        print(f"scenario {scenario} {strategy} {wire} round={m.round} "
              f"loss={m.loss!r} scheduled={m.n_scheduled} "
              f"skipped={m.n_skipped} handover={m.n_handover} "
              f"loads={m.rsu_loads} wall_s={wall:.6f}", flush=True)
    steps = res.diagnostics["client_batch_steps"]
    print(f"scenario {scenario} device={res.diagnostics['device']!r} "
          f"client_batch_steps={steps} launches={counts} run_s={run_s:.6f} "
          f"wire_bytes={res.diagnostics['wire_bytes']}", flush=True)
    if len(res.history) != rounds or steps <= 0:
        raise AssertionError(f"{scenario}: {len(res.history)} rounds, "
                             f"{steps} client batch steps")
    if scenario == "highway_corridor" \
            and sum(m.n_handover for m in res.history[1:]) == 0:
        raise AssertionError("highway: no handover after round 0")
    want = dict.fromkeys(counts, 0)
    want.update({k: v * steps for k, v in SCEN_LAUNCHES[wire].items()})
    if counts != want:
        raise AssertionError(f"{scenario} {wire}: launches {counts}, "
                             f"expected {want} ({steps} client batch "
                             f"steps)")
    timing = {"scenario": scenario, "strategy": strategy, "wire": wire,
              "vehicles": SCEN_VEHICLES, "rounds": rounds,
              "client_batch_steps": steps, "round_wall_s": walls,
              "run_s": run_s}
    return counts, timing


def _two_cell_trace():
    """Vehicle 0 drives RSU0 -> RSU1, vehicle 1 parks inside RSU0 (the CPU
    tests' handover fixture)."""
    import numpy as np
    from repro_torch.core import channel, scenario
    times = np.arange(5, dtype=np.float64) * 5.0
    x = np.stack([np.linspace(300.0, 900.0, 5), np.full(5, 250.0)], -1)
    pos = np.stack([x, np.zeros_like(x)], axis=-1)
    rsus = np.array([[300.0, 0.0], [900.0, 0.0]])
    return scenario.TraceReplay(times, pos, rsus, ch=channel.ChannelConfig(
        fading_std_db=0.0, rsu_range_m=320.0), seed=0)


def scenario_cpu_vs_card(schedule="sequential", **planes):
    """Phase 10c (10j with ``schedule="parallel"``, 10k with the fault and
    streaming ``planes``, SimConfig fields): the two-cell trace (2
    vehicles, 4 rounds, topk_int8, sync every 2) on the card and on the
    CPU from the same weights.  Float32 sums in another order can move one
    smashed value across an int8 rounding boundary (one int8 step), so the
    lr is the scenario path's 1e-3 and the final parameters agree within
    TRACE_TOL of the largest."""
    import numpy as np
    from repro_torch.core import fedsim
    from repro_torch.models.mlp_unit import MLPUnitModel, make_mlp_fleet_data
    cfg = fedsim.SimConfig(rounds=4, local_steps=2, batch_size=8,
                           lr=SCEN_LR, optimizer="sgd", wire="topk_int8",
                           round_interval_s=5.0, eval_every=0,
                           server_schedule=schedule, **planes)
    clients, test = make_mlp_fleet_data(2, 24, seed=0, n_test=64)
    runs = {}
    for where in ("cpu", "cuda"):
        eng = fedsim.ScenarioEngine(MLPUnitModel(), clients, test, cfg,
                                    _two_cell_trace(), cloud_sync_every=2,
                                    device=where)
        hist = eng.run()
        flat = np.concatenate([t.detach().cpu().numpy().ravel()
                               for u in eng.units for t in u.values()]
                              + [t.detach().cpu().numpy().ravel()
                                 for t in eng.head.values()])
        runs[where] = (hist, flat)
    (hc, pc), (hg, pg) = runs["cpu"], runs["cuda"]
    err = float(np.abs(pc - pg).max())
    scale = float(np.abs(pc).max())
    ok = (err <= TRACE_TOL * scale and np.isfinite(pg).all()
          and [m.cuts for m in hc] == [m.cuts for m in hg]
          and sum(m.n_handover for m in hg) >= 1)
    if planes:      # the plans (host draws) and their telemetry: equal
        import dataclasses
        ok = ok and ([dataclasses.astuple(m)[6:] for m in hc]
                     == [dataclasses.astuple(m)[6:] for m in hg])
    events = ""
    if planes:
        events = (f" events dropout/lost/straggler/down/arrived/merges="
                  f"{[(m.n_dropout, m.n_upload_lost, m.n_straggler, m.n_rsu_down, m.n_arrived, m.stream_merges) for m in hg]}")
    print(f"scenario_cpu_vs_card {schedule}{' planes' if planes else ''} "
          f"two-cell trace losses_cpu="
          f"{[m.loss for m in hc]} losses_card={[m.loss for m in hg]}"
          f"{events} "
          f"max_param_diff={err:g} max_abs_param={scale:g} "
          f"tol={TRACE_TOL:g}x ok={ok}", flush=True)
    if not ok:
        raise AssertionError(f"two-cell trace: card and CPU disagree "
                             f"({err:g} > {TRACE_TOL:g} x {scale:g}, or "
                             f"cuts / handovers differ)")
    return err / scale


# ---- the single-RSU engine's schemes and replica schedules (phase 10d):
# (scheme, cohort_parallel, wire, rounds); resnet18 on the paper's spec
SCHEME_RUNS = (("cl", "auto", "none", 1), ("fl", "auto", "none", 1),
               ("sl", "auto", "topk_int8", 1),
               ("asfl", "vmap", "topk_int8", 2),
               ("asfl", "unroll", "topk_int8", 2))


def _bucket_most(cuts, steps):
    """Per distinct cut (a bucket), the most local steps among its
    vehicles: its (bucket, local step) pairs with an active slot."""
    most = {}
    for cut, n in zip(cuts, steps):
        most[cut] = max(most.get(cut, 0), n)
    return most


def _bucket_steps(cuts, steps):
    """(bucket, local step) pairs with an active slot in one split round."""
    return sum(_bucket_most(cuts, steps).values())


def scheme_path(scheme, mode, wire, rounds):
    """Phase 10d: one scheme through ``repro_torch.api.run`` on the card,
    the launch counters zeroed just before and read just after; client
    batch steps, wire bytes and codec launches checked against what the
    data and the schedule imply.  Returns a timing row."""
    import numpy as np
    import torch
    from repro_torch import api, kernels
    from repro_torch.core import cost
    spec = api.ExperimentSpec(
        train=api.TrainConfig(scheme=scheme, rounds=rounds, wire=wire),
        runtime=api.RuntimeConfig(cohort_parallel=mode))
    tr, f = spec.train, spec.fleet
    clients, _ = api.model_entry(spec.model).make_data(
        f.n_vehicles, f.per_vehicle_samples, f.test_samples, f.data_seed)
    steps = [max(len(c) // tr.batch_size, 1) * tr.local_epochs
             for c in clients]
    marks = []

    def on_round(m):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        cuts_ok = (m.cuts == [] if scheme in ("cl", "fl")
                   else len(m.cuts) == 4 and set(m.cuts) <= {2, 4, 6, 8})
        if not (math.isfinite(m.loss) and 0.0 <= m.test_acc <= 1.0
                and cuts_ok):
            raise AssertionError(f"{scheme} {mode}: bad round {m}")

    kernels.reset_launches()
    res = api.run(spec, on_round=on_round)
    counts = kernels.launch_counts()
    d = res.diagnostics
    run_s = res.timing["run_s"]
    walls = [run_s - (marks[-1] - marks[0])] + [
        b - a for a, b in zip(marks, marks[1:])]
    cuts = [m.cuts for m in res.history]
    if scheme == "cl":                   # one epoch of full batches a round
        want_steps = rounds * sum(len(c) // tr.batch_size for c in clients)
    else:
        want_steps = rounds * sum(steps)
    want_bytes, n_codec = 0.0, 0
    if scheme in ("sl", "asfl"):
        prof = cost.resnet_profile()
        for c in cuts:
            up, down = cost.effective_comm_bytes(
                prof, c, steps, tr.batch_size, wire, tr.wire_k,
                include_model_transfer=False)
            want_bytes += float(np.sum(up + down))
        # the loop and the sl chain: pack and unpack up and down per client
        # batch step; vmap: the uplink once per (bucket, local step) on the
        # stacked smashed tensor, the downlink per client batch step
        n_codec = (want_steps + sum(_bucket_steps(c, steps) for c in cuts)
                   if d["mode"] == "vmap" and scheme == "asfl"
                   else 2 * want_steps)
    want = dict.fromkeys(counts, 0)
    want.update({"sparsify_quant_pack": n_codec, "unpack_dequant": n_codec})
    want_mode = "vmap" if mode == "auto" else mode
    for m, wall in zip(res.history, walls):
        print(f"scheme {scheme} mode={d['mode']} wire={wire} "
              f"round={m.round} loss={m.loss!r} acc={m.test_acc!r} "
              f"cuts={m.cuts} wall_s={wall:.6f}", flush=True)
    print(f"scheme {scheme} mode={d['mode']} device={d['device']!r} "
          f"client_batch_steps={d['client_batch_steps']} launches={counts} "
          f"wire_bytes={d['wire_bytes']} cost_model_bytes={want_bytes!r} "
          f"run_s={run_s:.6f}", flush=True)
    if (d["mode"] != want_mode or d["client_batch_steps"] != want_steps
            or d["wire_bytes"] != want_bytes or counts != want):
        raise AssertionError(
            f"{scheme} {mode}: mode {d['mode']} (want {want_mode}), "
            f"{d['client_batch_steps']} client batch steps (want "
            f"{want_steps}), {d['wire_bytes']} wire bytes (want "
            f"{want_bytes}), launches {counts} (want {want})")
    return {"scheme": scheme, "mode": d["mode"], "wire": wire,
            "rounds": rounds, "cuts": cuts,
            "losses": [m.loss for m in res.history],
            "client_batch_steps": want_steps, "launches": counts,
            "wire_bytes": d["wire_bytes"], "round_wall_s": walls,
            "run_s": run_s}


def vmap_cpu_vs_card():
    """Phase 10e: one sgd local step of a two-bucket SFL round (cuts 2 and
    6, two slots each, the second slot of cut 6 sitting the step out),
    ``wire="none"``, TF32 off, from the same weights and batches: ``vmap``
    on the card against the loop on the CPU, with the model run in float64,
    within phase 7's tolerance (STEP_RTOL of the largest update).  The
    float32 runs (card vmap against CPU vmap and CPU loop, and the two CPU
    schedules) are printed beside it, not held: three slots chained
    through the RSU put BatchNorm outputs within float32 rounding of the
    ReLU's kink, where a 1-ulp difference in a sum flips a gradient, so the
    float32 schedules differ by about 1 % of the update even on one CPU,
    and on the card one float32 result came out either side of that
    (0.09 % or 1.1 % from the CPU's vmap in two processes of one call)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import fedsim
    from repro_torch.data.pipeline import make_federated_data
    from repro_torch.tree import tree_leaves, tree_map
    model = fedsim.ResNetModel()
    units, head = model.init(torch.Generator().manual_seed(0))
    clients, _ = make_federated_data(0, n_train=256, n_test=8)
    rng = np.random.default_rng(0)
    cuts_sig = ((2, 2), (6, 2))
    rows = [np.array([0, 1]), np.array([2, 3])]
    idx = [rng.integers(0, min(len(clients[r]) for r in rr),
                        size=(1, 2, BATCH)) for rr in rows]
    mask = [np.array([[True, True]]), np.array([[True, False]])]
    w = [np.array([len(clients[r]) for r in rr], np.float64) for rr in rows]
    suw = np.array([sum(len(clients[r]) for rr, (c, _) in zip(rows, cuts_sig)
                        for r in rr if c <= u) for u in range(model.n_units)],
                   np.float64)
    plan = fedsim.RoundPlan(cuts_sig, 1, rows, idx, mask, w, suw)
    init = tree_leaves([units, head])
    out = {}
    for where, mode, dtype in (("cpu", "unroll", torch.float32),
                               ("cpu", "vmap", torch.float32),
                               ("cuda", "vmap", torch.float32),
                               ("cpu", "unroll", torch.float64),
                               ("cuda", "vmap", torch.float64)):
        cfg = fedsim.SimConfig(optimizer="sgd", lr=SGD_LR, wire="none",
                               cohort_parallel=mode)
        dev = torch.device(where)
        eng = fedsim.CohortEngine(model, cfg, clients, dev)
        eng.stacked = dataclasses.replace(
            eng.stacked, images=eng.stacked.images.to(dtype))
        u = [tree_map(lambda a: a.to(dev, dtype), p) for p in units]
        h = tree_map(lambda a: a.to(dev, dtype), head)
        nu, nh, ls, cnt = eng.split_round(u, h, plan, BATCH)
        if eng.mode != mode or cnt != 3:
            raise AssertionError(f"{where} {mode}: mode {eng.mode}, {cnt} "
                                 f"client batch steps")
        out[where, mode, dtype] = (
            [t.cpu().double() for t in tree_leaves([nu, nh])],
            float(ls) / cnt)
    moved = max(float((a - a0).abs().max())
                for a, a0 in zip(out["cpu", "unroll", torch.float32][0],
                                 init))
    worst = {}
    for label, a, b, held in (
            ("f64 card vmap vs cpu loop", ("cuda", "vmap", torch.float64),
             ("cpu", "unroll", torch.float64), True),
            ("f32 card vmap vs cpu vmap", ("cuda", "vmap", torch.float32),
             ("cpu", "vmap", torch.float32), False),
            ("f32 card vmap vs cpu loop", ("cuda", "vmap", torch.float32),
             ("cpu", "unroll", torch.float32), False),
            ("f32 cpu vmap vs cpu loop", ("cpu", "vmap", torch.float32),
             ("cpu", "unroll", torch.float32), False)):
        (pa, la), (pb, lb) = out[a], out[b]
        diff = max(float((x - y).abs().max()) for x, y in zip(pa, pb))
        rel = diff / moved if moved > 0 else math.inf
        ok = (rel <= STEP_RTOL and abs(la - lb) <= 1e-4
              and all(bool(torch.isfinite(t).all()) for t in pa))
        print(f"vmap_cpu_vs_card {label}: loss {la!r} / {lb!r} "
              f"max_param_diff={diff:g} max_update={moved:g} "
              f"diff_over_update={rel:g} held={held} ok={ok}", flush=True)
        if held and not ok:
            raise AssertionError(f"vmap_cpu_vs_card {label}: {diff:g} = "
                                 f"{rel:g} of the largest update, losses "
                                 f"{la!r} / {lb!r}")
        worst[label] = rel
    return worst


def build_kernels():
    """Phase 2: build the kernel library from the checkout's sources."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS)} -> {lib.path.name} "
          f"nvcc_s={lib.build_s:.3f} load_s={time.perf_counter() - t0:.3f}",
          flush=True)
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"build: {line.strip()}", flush=True)
    if lib.log:
        hopper = hopper_ptxas(lib.log)
        smem = {"flash_attention_hopper_kernel":
                lib.lib.repro_flash_hopper_smem_bytes,
                "flash_bwd_hopper_dq_kernel":
                lambda d: lib.lib.repro_flash_hopper_bwd_smem_bytes(0, d),
                "flash_bwd_hopper_dkdv_kernel":
                lambda d: lib.lib.repro_flash_hopper_bwd_smem_bytes(1, d)}
        for (kernel, dtype, d), info in sorted(hopper.items()):
            print(f"build: {kernel} {dtype} d{d} registers="
                  f"{info['registers']} spill_stores={info['spill_stores']} "
                  f"spill_loads={info['spill_loads']} stack={info['stack']} "
                  f"dynamic_smem_bytes={smem[kernel](d)}", flush=True)
        want = {(kernel, dt, d) for kernel, dims in HOPPER_KERNELS.items()
                for dt in ("bf16", "f16") for d in dims}
        if set(hopper) != want or any(
                i.get("spill_stores", 1) or i.get("spill_loads", 1)
                for i in hopper.values()):
            raise AssertionError(f"Hopper kernels: ptxas reports {hopper} "
                                 f"(each of {sorted(want)}, no spills "
                                 f"wanted)")
    return lib


def hopper_ptxas(log):
    """The ptxas -v report of each Hopper flash kernel (HOPPER_KERNELS)
    per dtype and head dim (the mangled name's int template argument),
    from a build log: {(kernel, "bf16" | "f16", d): {registers,
    spill_stores, spill_loads, stack}}."""
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = None
            for kernel in HOPPER_KERNELS:
                m = re.search(kernel + r"I\w+?Li(\d+)E", line)
                if m:
                    cur = out.setdefault(
                        (kernel, "bf16" if "bfloat16" in line else "f16",
                         int(m[1])), {})
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                cur.update(stack=int(m[1]), spill_stores=int(m[2]),
                           spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m[1])
    return out


def card_line():
    """Phase 1: the card's name and power limit, as nvidia-smi gives them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    line = res.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def drive_path(wire, rounds, kernel_names):
    """Phases 5/6: the paper's case study through ``repro_torch.api.run``
    on the card, launch counters zeroed just before and read just after.
    Returns (launches of ``kernel_names``, cuts of every round)."""
    import torch
    from repro_torch import api, kernels
    spec = api.ExperimentSpec(
        train=api.TrainConfig(rounds=rounds, wire=wire),
        runtime=api.RuntimeConfig(cohort_parallel="unroll"))
    marks = []

    def on_round(m):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if not (math.isfinite(m.loss) and 0.0 <= m.test_acc <= 1.0
                and set(m.cuts) <= {2, 4, 6, 8} and len(m.cuts) == 4):
            raise AssertionError(f"bad round metrics: {m}")

    kernels.reset_launches()
    res = api.run(spec, on_round=on_round)
    counts = kernels.launch_counts()
    # run_s spans the rounds alone (engine built before it, ends with the
    # last round's synchronize), so round 0 is run_s less the later rounds
    run_s = res.timing["run_s"]
    walls = [run_s - (marks[-1] - marks[0])] + [
        b - a for a, b in zip(marks, marks[1:])]
    for m, wall in zip(res.history, walls):
        print(f"path {wire} round={m.round} loss={m.loss!r} "
              f"acc={m.test_acc!r} cuts={m.cuts} wall_s={wall:.6f}",
              flush=True)
    steps = res.diagnostics["client_batch_steps"]
    print(f"path {wire} device={res.diagnostics['device']!r} "
          f"client_batch_steps={steps} launches={counts} "
          f"run_s={run_s:.6f} wire_bytes={res.diagnostics['wire_bytes']}",
          flush=True)
    if len(res.history) != rounds or steps <= 0:
        raise AssertionError(f"{wire}: {len(res.history)} rounds, "
                             f"{steps} client batch steps")
    for name in KERNEL_META:
        want = 2 * steps if name in kernel_names else 0
        if counts[name] != want:
            raise AssertionError(f"{wire}: {name} launched {counts[name]} "
                                 f"times, expected {want} (2 x {steps} "
                                 f"client batch steps)")
    return ({k: counts[k] for k in kernel_names},
            [m.cuts for m in res.history])


def cpu_vs_card():
    """Phase 7: one sgd SFL batch step per cut (wire="none") from the same
    weights and batch on the CPU and on the card, TF32 off.  The card's
    update of every parameter agrees with the CPU's within STEP_RTOL of the
    largest update: the gradients differ only by float32 summation order
    (cuDNN and oneDNN sum the convolutions differently).  A card step that
    skipped its update is off by the whole update, so it fails."""
    import numpy as np
    import torch
    from repro_torch import optim
    from repro_torch.core import fedsim
    from repro_torch.device import resolve_device
    from repro_torch.tree import tree_leaves, tree_map
    dev = resolve_device("cuda")
    model = fedsim.ResNetModel()
    units, head = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(BATCH, 32, 32, 3))
                         .astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=BATCH))
    cfg = fedsim.SimConfig(optimizer="sgd", lr=SGD_LR, wire="none")
    init = tree_leaves([units, head])
    worst = 0.0
    for cut in (2, 4, 6, 8):
        step = fedsim.make_sfl_batch_step(model, cfg, cut)
        outs = {}
        for where in ("cpu", dev):
            u = [tree_map(lambda a: a.to(where), p) for p in units]
            h = tree_map(lambda a: a.to(where), head)
            opt = optim.from_name("sgd", SGD_LR)
            outs[str(where)] = step(
                u[:cut], u[cut:], h, opt.init(u[:cut]),
                opt.init({"units": u[cut:], "head": h}),
                {"images": x.to(where), "labels": y.to(where)})
        a, b = outs["cpu"], outs[str(dev)]
        la = tree_leaves([a[0], a[1], a[2]])
        lb = [t.cpu() for t in tree_leaves([b[0], b[1], b[2]])]
        if not all(bool(torch.isfinite(t).all()) for t in lb):
            raise AssertionError(f"non-finite parameters at cut {cut}")
        diff = max(float((p - q).abs().max()) for p, q in zip(la, lb))
        moved = max(float((p - p0).abs().max()) for p, p0 in zip(la, init))
        rel = diff / moved if moved > 0 else math.inf
        dloss = abs(float(a[5]) - float(b[5]))
        worst = max(worst, rel)
        print(f"cpu_vs_card cut={cut} loss_cpu={float(a[5])!r} "
              f"loss_card={float(b[5])!r} max_param_diff={diff:g} "
              f"max_update={moved:g} diff_over_update={rel:g}", flush=True)
        if rel > STEP_RTOL or dloss > 1e-4:
            raise AssertionError(f"cut {cut}: card and CPU disagree (params "
                                 f"{diff:g} = {rel:g} of the largest update "
                                 f"{moved:g} > {STEP_RTOL:g}, or loss "
                                 f"{dloss:g} > 1e-4)")
    return worst


# ------------------------------------------------------------- LM lane
def _randn(shape, seed, scale=1.0):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=shape) * scale)
                            .astype(np.float32)).cuda()


def _rms_case(rows_shape, seed):
    x = _randn(rows_shape, seed, 2.0)
    return x, _randn(rows_shape[-1:], seed + 1, 0.1) + 1.0


def _flash_case(b, sq, sk, h, kv, d, seed, qk_amp=1.0):
    return (_randn((b, sq, h, d), seed, qk_amp),
            _randn((b, sk, kv, d), seed + 1, qk_amp),
            _randn((b, sk, kv, d), seed + 2))


# the split case's shape (b, sq, sk, h, kv, d), non-causal
FLASH_SPLIT_SHAPE = (1, 256, 64, 4, 2, 128)


def flash_split_case(dtype, device="cuda", seed=0):
    """(q, k, v) in ``dtype`` on which the 16-bit flash kernel's output
    shows whether its p.v keeps p's low half: per (query, head) a key of
    score 0 with v = +C against two keys of score -delta (delta within 0.1
    of ln 2, drawn per query and head) with v = -C, so the output
    C (1 - 2p) / (1 + 2p) nearly cancels while one rounding of p to
    ``dtype`` moves it by up to C ulp(p); the other keys score
    -256 / sqrt(d) and carry v = 0.  C is 1, 2, 4, 8 by column: the low
    half's own rounding stays ~1e-5, under flash's float32 tolerance."""
    import numpy as np
    import torch
    b, sq, sk, h, kv, d = FLASH_SPLIT_SHAPE
    delta = np.log(2) + np.random.default_rng(seed).uniform(
        -0.1, 0.1, (b, sq, h))
    q = torch.zeros((b, sq, h, d))
    q[..., 0] = torch.from_numpy(delta * d ** 0.5).float()
    q[..., 1] = 256.0
    k = torch.zeros((b, sk, kv, d))
    k[:, 1:3, :, 0] = -1.0
    k[:, 3:, :, 1] = -1.0
    big = 2.0 ** (torch.arange(d) % 4).float()
    v = torch.zeros((b, sk, kv, d))
    v[:, 0] = big
    v[:, 1:3] = -big
    return tuple(t.to(device=device, dtype=dtype) for t in (q, k, v))


def flash_hi_only(q, k, v):
    """Non-causal attention in float32 from 16-bit q, k and v with p
    rounded once to their dtype before p.v (l from the float32 p): what
    the 16-bit kernel would give without p's low half."""
    import torch
    g = q.shape[2] // k.shape[2]
    kf, vf = (t.float().repeat_interleave(g, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * q.shape[-1] ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), vf)
    return (o / p.sum(-1).transpose(1, 2)[..., None]).to(q.dtype)


def _ssd_case(b, s, h, p, g, n, seed):
    """Inputs distributed as mamba2's prefill gives them: dt = softplus of
    a unit normal plus the model's dt_bias, A = -linspace(1, 16)."""
    import torch
    bias = torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, h))).cuda()
    dt = torch.nn.functional.softplus(_randn((b, s, h), seed + 1) + bias)
    return (_randn((b, s, h, p), seed, 0.5), dt,
            -torch.linspace(1.0, 16.0, h).cuda(),
            _randn((b, s, g, n), seed + 2), _randn((b, s, g, n), seed + 3))


# phase 4b's SSD shapes (label, (b, s, h, p, g, n, chunk), timed): mamba2's
# prefill, then the edges (ragged chunks, two groups, s below the chunk,
# chunk 32 / 64 / 128, odd p and n), each also in SSD16_DTYPES; the
# 16-bit rows of the timed shape are timed too
SSD_CASES = (("mamba2_prefill", (SERVE_BATCH, SERVE_PROMPT, 48, 64, 1, 128,
                                 256), True),
             ("ragged_g2", (2, 300, 8, 64, 2, 128, 256), False),
             ("chunk32_g2", (2, 100, 4, 32, 2, 16, 32), False),
             ("s_lt_chunk", (1, 40, 4, 16, 1, 16, 64), False),
             ("reduced", (2, 37, 32, 16, 1, 16, 32), False),
             ("g2_8heads", (1, 512, 16, 64, 2, 128, 256), False),
             ("chunk128_ragged", (2, 333, 6, 64, 1, 128, 128), False),
             ("chunk64", (1, 200, 8, 64, 1, 128, 64), False),
             ("odd_pn_h7", (1, 150, 7, 18, 1, 10, 64), False))
SSD16_DTYPES = ("bf16", "f16")
# the shape whose 16-bit rows also run with dt and A in x's dtype
SSD16_ALL_INPUTS = "mamba2_prefill"


def _ssd16_close(got, want):
    """The SSD scan on 16-bit inputs against its plain version on the same
    inputs: y of x's dtype within one ulp of it plus the float32
    tolerance (both compute in float32 and round once), the state float32
    within the float32 tolerance; finite, same shapes."""
    import torch
    tol = LM_TOL["ssd_chunk_scan"]
    (y, st), (y_p, st_p) = got, want
    return (y.dtype == y_p.dtype and st.dtype == st_p.dtype == torch.float32
            and y.shape == y_p.shape and st.shape == st_p.shape
            and bool(torch.isfinite(y).all())
            and bool(torch.isfinite(st).all())
            and _lm_within(y, y_p, tol)
            and bool(((st - st_p).abs() <= tol + tol * st_p.abs()).all()))


def _visible_pairs(sq, sk, causal, window):
    """(query, key) pairs the masks leave visible, per (batch, head)."""
    total = 0
    for i in range(sq):
        hi = min(sk, i + 1) if causal else sk
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def _ssd_flops(b, s, h, p, g, n, chunk):
    """Flops of the chunked form for this run (2 per multiply-add): C.B^T
    over the L(L+1)/2 pairs j <= i of a chunk of length L once per (batch,
    group, chunk), since the group's heads share it; per (batch, head) and
    chunk, scores @ x over the same pairs, and C.H and the state update
    over L x n x p."""
    per_group = per_head = 0
    for c0 in range(0, s, chunk):
        length = min(chunk, s - c0)
        pairs = length * (length + 1) // 2
        per_group += 2 * pairs * n
        per_head += 2 * pairs * p + 4 * length * n * p
    return b * (g * per_group + h * per_head)


def _sdpa_library(q, k, v, causal, window):
    """One ``scaled_dot_product_attention`` call on the same inputs (GQA
    by ``enable_gqa``; under a window a boolean mask of the same pairs)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if window > 0:
        mask = FA._mask(q.shape[1], k.shape[1], causal, window, q.device)
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)


# phase 4b's rmsnorm shapes: the serving prefills' widths (smollm, mamba2
# and its gated norm, gemma3 / recurrentgemma, internvl2, musicgen and
# deepseek's norm1 / norm2 at d 2048, deepseek's kv_norm over the latent),
# decode, gemma3's qk-norm over head_dim 256 (q's rows at prefill, k's at
# a decode step), edges (d not a multiple of the vector, d past the
# registers' 8192 float32)
RMS_SHAPES = (
    ("smollm_prefill_d960", (SERVE_BATCH, SERVE_PROMPT, 960)),
    ("mamba2_prefill_d1536", (SERVE_BATCH, SERVE_PROMPT, 1536)),
    ("mamba2_gated_d3072", (SERVE_BATCH, SERVE_PROMPT, 3072)),
    ("decode_d960", (SERVE_BATCH, 1, 960)),
    ("reduced_d256", (2, 12, 256)),
    ("odd_d1001", (5, 7, 1001)),
    ("gemma3_prefill_d2560", (SERVE_BATCH, SERVE_PROMPT, 2560)),
    ("internvl2_prefill_d896", (SERVE_BATCH, SERVE_PROMPT, 896)),
    ("musicgen_prefill_d2048", (SERVE_BATCH, SERVE_PROMPT, 2048)),
    ("deepseek_kv_norm_d512", (SERVE_BATCH, SERVE_PROMPT, 512)),
    ("gemma3_qk_norm_d256", (SERVE_BATCH * SERVE_PROMPT * 8, 256)),
    ("gemma3_decode_k_norm_d256", (SERVE_BATCH * 4, 256)),
    ("qwen3_d5120", (SERVE_BATCH, SERVE_PROMPT, 5120)),
    ("command_r_d8192", (SERVE_BATCH, SERVE_PROMPT, 8192)),
    ("qwen3_qk_norm_d128", (SERVE_BATCH * SERVE_PROMPT * 40, 128)),
    ("dbrx_train_d6144", (4, SERVE_PROMPT, 6144)),
    ("tiny_d6", (3, 6)),
    ("wide_d9000", (3, 9000)))
# the backward at the training path's widths (batch 8, seq 1024: smollm,
# mamba2 and its gated norm), over gemma3's qk-norm rows, at the
# families' widths (gemma3 / recurrentgemma, internvl2, musicgen;
# musicgen's d 2048 is deepseek's norm1 / norm2 too), deepseek's kv_norm
# over the MLA latent, and at the bfloat16 archs' (qwen3's d 5120 and
# qk-norm rows over head_dim 128, command-r's d 8192, dbrx's d 6144 at its
# batch of 4)
RMS_BWD_SHAPES = (
    ("gemma3_qk_norm_d256", (SERVE_BATCH * SERVE_PROMPT * 8, 256)),
    ("smollm_train_d960", (SERVE_BATCH, SERVE_PROMPT, 960)),
    ("mamba2_train_d1536", (SERVE_BATCH, SERVE_PROMPT, 1536)),
    ("mamba2_gated_d3072", (SERVE_BATCH, SERVE_PROMPT, 3072)),
    ("gemma3_train_d2560", (SERVE_BATCH, SERVE_PROMPT, 2560)),
    ("internvl2_train_d896", (SERVE_BATCH, SERVE_PROMPT, 896)),
    ("musicgen_train_d2048", (SERVE_BATCH, SERVE_PROMPT, 2048)),
    ("qwen3_train_d5120", (SERVE_BATCH, SERVE_PROMPT, 5120)),
    ("command_r_train_d8192", (SERVE_BATCH, SERVE_PROMPT, 8192)),
    ("qwen3_qk_norm_d128", (SERVE_BATCH * SERVE_PROMPT * 40, 128)),
    ("deepseek_kv_norm_train_d512", (SERVE_BATCH, SERVE_PROMPT, 512)),
    ("dbrx_train_d6144", (4, SERVE_PROMPT, 6144)))
# x's dtype and the scale's; a label's suffix is the key ("f32": none).
# The timed ones: float32, and bfloat16 with a bfloat16 scale (the same
# function as F.rms_norm's fused kernel on those inputs)
RMS_DTYPES = {"f32": ("float32", "float32"),
              "bf16": ("bfloat16", "bfloat16"),
              "bf16_f32scale": ("bfloat16", "float32"),
              "f16": ("float16", "float16"),
              "f16_f32scale": ("float16", "float32")}
RMS_TIMED = ("f32", "bf16")
# the bfloat16 archs' widths (qwen3's d 5120 and qk-norm rows over
# head_dim 128, command-r's d 8192, dbrx's d 6144), forward and backward:
# checked in every dtype above (the backward in RMS_TIMED's), timed in
# bfloat16 only, the dtype they train and serve in
RMS_BF16_WIDTHS = ("qwen3_d5120", "command_r_d8192", "qwen3_qk_norm_d128",
                   "qwen3_train_d5120", "command_r_train_d8192",
                   "dbrx_train_d6144")


def _dtype(name):
    import torch
    return getattr(torch, name)


def _ulp(b):
    """One ulp of each value of a 16-bit tensor, as float32."""
    import torch
    bits = {torch.bfloat16: 7, torch.float16: 10}[b.dtype]
    _, e = torch.frexp(b.float().abs().clamp_min(torch.finfo(b.dtype).tiny))
    return torch.ldexp(torch.ones_like(b, dtype=torch.float32),
                       e - 1 - bits)


def _rms_ok(a, b, scale_tol=0.0):
    """float32 within LM_TOL["rmsnorm"] (absolute + relative), 16-bit
    within one ulp, each plus ``scale_tol``; finite, same shape and
    dtype."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape or not bool(
            torch.isfinite(a).all()):
        return False
    tol = LM_TOL["rmsnorm"]
    err = (a.float() - b.float()).abs()
    bound = (tol + tol * b.abs() if a.dtype == torch.float32
             else _ulp(b)) + scale_tol
    return bool((err <= bound).all())


def _rms_close(got, want):
    return all(_rms_ok(a, b) for a, b in zip(got, want))


def _grad_tol(b):
    return LM_TOL["rmsnorm_backward"] * max(float(b.float().abs().max()),
                                            1.0)


def _rms_backward_close(x, g, dy):
    """The backward kernel's (dx, dscale) against the closed-form plain
    version and against the plain vjp (each gradient within its
    tolerance), and a second call bit for bit."""
    import torch
    from repro_torch.kernels import rmsnorm as RN

    def close(got, want):
        again = RN.rmsnorm_backward(x, g, dy)
        _, vjp = torch.func.vjp(RN.rmsnorm_plain, x, g)
        return (all(torch.equal(a, b) for a, b in zip(got, again))
                and all(_rms_ok(a, b, _grad_tol(b))
                        for ref in (want, vjp(dy)) for a, b in zip(got, ref)))
    return close


def _lm_close(name):
    """|a - b| <= tol + tol * |b| at LM_TOL[name], finite, same shape."""
    import torch
    tol = LM_TOL[name]
    return lambda got, want: all(
        a.shape == b.shape and bool(torch.isfinite(a).all())
        and bool(((a - b).abs() <= tol + tol * b.abs()).all())
        for a, b in zip(got, want))


def flash16_within(a, b):
    """16-bit flash output ``a`` within one ulp of the working type plus
    flash's float32 tolerance of ``b`` (both compute in float32 and round
    once)."""
    tol = LM_TOL["flash_attention"]
    return bool(((a.float() - b.float()).abs()
                 <= _ulp(b) + tol + tol * b.float().abs()).all())


def _flash16_close(run_k, route):
    """16-bit flash against its plain version: :func:`flash16_within`,
    finite, of q's dtype; a second call bit for bit, on ``route``."""
    import torch
    from repro_torch.kernels import flash_attention as FA

    def close(got, want):
        (a,), (b,) = got, want
        before = dict(FA.ROUTE_LAUNCHES)
        again = run_k()
        took = [r for r, n in FA.ROUTE_LAUNCHES.items() if n != before[r]]
        return (took == [route] and a.dtype == b.dtype
                and a.shape == b.shape and bool(torch.isfinite(a).all())
                and torch.equal(a, again) and flash16_within(a, b))
    return close


def _flash_bwd_inputs(label, shape, dtype, seed):
    """q, k, v and a cotangent dO of ``dtype`` for a backward case: drawn
    apart, or (``strided_qkv*``) q / k / v as views of one fused
    projection (``_odd``: misaligned by one element) and dO a view of a
    wider tensor (a contiguous trailing dim)."""
    b, sq, sk, h, kv, d = shape[:6]
    if label.startswith("strided_qkv"):
        n = b * sq * (h + 2 * kv) * d
        flat = _randn((n + 1,), seed).to(dtype)
        qkv = (flat[1:] if label.endswith("_odd") else flat[:-1]).view(
            b, sq, h + 2 * kv, d)
        wide = _randn((b, sq, h + 2, d), seed + 3).to(dtype)
        return (qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:],
                wide[:, :, 1:h + 1])
    q, k, v = (t.to(dtype) for t in _flash_case(b, sq, sk, h, kv, d, seed))
    return q, k, v, _randn((b, sq, h, d), seed + 3).to(dtype)


def _flash_bwd_close(q, k, v, lse, do, causal, window, run_k, route):
    """The backward kernels' (dq, dk, dv) against the closed form (the
    kernels' plain version, on the kernel's lse) and against the plain
    vjp of attention_plain, each gradient within LM_TOL of the largest
    (16-bit: one ulp more, :func:`_lm_within`), finite, of q's dtype; a
    second call bit for bit, on ``route``; the forward kernel's lse within
    1e-4 of the plain one, +inf exactly where a row sees no key."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    tol = LM_TOL["flash_attention_backward"]

    def within(got, want):
        big = max(float(w.float().abs().max()) for w in want)
        return all(a.dtype == w.dtype == q.dtype and a.shape == w.shape
                   and bool(torch.isfinite(a).all())
                   and _lm_within(a, w, tol, big)
                   for a, w in zip(got, want))

    def close(got, want):
        before = dict(FA.BACKWARD_ROUTE_LAUNCHES)
        again = run_k()
        took = [r for r, n in FA.BACKWARD_ROUTE_LAUNCHES.items()
                if n != before[r]]
        _, lse_p = FA._plain_forward(q, k, v, causal, window,
                                     q.shape[-1] ** -0.5)
        seen = torch.isfinite(lse_p)
        lse_ok = (torch.equal(seen, torch.isfinite(lse))
                  and bool(((lse - lse_p).abs()[seen] <= 1e-4).all()))
        del lse_p
        _, vjp = torch.func.vjp(lambda a, b, c: FA.attention_plain(
            a, b, c, causal=causal, window=window), q, k, v)
        return (took == [route] and lse_ok
                and all(torch.equal(a, b) for a, b in zip(got, again))
                and within(got, want) and within(got, vjp(do)))
    return close


def _sdpa_backward(q, k, v, do, causal, window):
    """The backward half of ``torch.autograd.grad`` through one
    ``scaled_dot_product_attention`` call on the same inputs and
    cotangent (its forward run once, outside the timed calls): the same
    function as flash's backward kernel; timed, never called by the
    port."""
    import torch
    req = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = _sdpa_library(*req, causal, window)()
    g = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, req, g, retain_graph=True)


def _rms_norm_backward_library(x, g, dy):
    """The backward half of ``torch.autograd.grad`` through
    ``F.rms_norm`` on the same inputs (its forward run once, outside the
    timed calls): the same function as the backward kernel."""
    import torch
    import torch.nn.functional as F
    xr = x.detach().clone().requires_grad_()
    gr = g.detach().clone().requires_grad_()
    y = F.rms_norm(xr, (x.shape[-1],), gr, 1e-6)
    return lambda: torch.autograd.grad(y, (xr, gr), dy, retain_graph=True)


# the row of each LM kernel that the per-kernel JSON line reports (its
# other timed rows go under "shapes")
LM_MAIN = {"rmsnorm": "smollm_prefill_d960",
           "rmsnorm_backward": "smollm_train_d960",
           "flash_attention_backward": "qwen3_train_bf16_mma",
           "flash_attention": "smollm_prefill",
           "ssd_chunk_scan": "mamba2_prefill"}
LM_ROW_KEYS = ("shape", "ms", "ms_flushed", "call_ms", "plain_ms",
               "library_ms", "library_ms_flushed", "bound_ms", "bound_by",
               "bound_tc_ms", "bound_split_ms", "max_abs_err", "route",
               "transient_gb")
FLUSHED_ITERS = 100


def _lm_cases():
    """(kernel, label, timed, kernel call, plain call, library call or
    None, bytes, operations, close, the card's rate for those operations)
    for the serving path's shapes (each served arch's prefill shape is
    timed; rmsnorm every shape, in float32 and bfloat16, and its backward
    at the training path's widths; flash also in bfloat16 and float16)
    and the edge shapes; close(got, want) says whether the kernel's
    outputs are within tolerance of the plain version's."""
    import torch.nn.functional as F
    B, S = SERVE_BATCH, SERVE_PROMPT
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd as SSD
    cases = []
    # one draw of a shape's inputs serves its every dtype (cast once each)
    for label, shape in RMS_SHAPES:
        x32, g32 = _rms_case(shape, len(cases))
        for dt, (x_dt, s_dt) in RMS_DTYPES.items():
            x, g = x32.to(_dtype(x_dt)), g32.to(_dtype(s_dt))
            n, d = math.prod(shape), shape[-1]
            es, gs = x.element_size(), g.element_size()
            cases.append((
                "rmsnorm", label + ("" if dt == "f32" else f"_{dt}"),
                dt == "bf16" if label in RMS_BF16_WIDTHS else dt in RMS_TIMED,
                lambda x=x, g=g: RN.rmsnorm(x, g),
                lambda x=x, g=g: RN.rmsnorm_plain(x, g),
                lambda x=x, g=g, d=d: F.rms_norm(x, (d,), g, 1e-6),
                es * 2 * n + gs * d, 3 * n, _rms_close, F32_FLOPS_PER_S))
    for label, shape in RMS_BWD_SHAPES:
        x32, g32 = _rms_case(shape, len(cases))
        dy32 = _randn(shape, len(cases) + 2)
        for dt in RMS_TIMED:
            x_dt, s_dt = RMS_DTYPES[dt]
            x, g = x32.to(_dtype(x_dt)), g32.to(_dtype(s_dt))
            dy = dy32.to(x.dtype)
            n, d = math.prod(shape), shape[-1]
            es, gs = x.element_size(), g.element_size()
            cases.append((
                "rmsnorm_backward", label + ("" if dt == "f32" else f"_{dt}"),
                dt == "bf16" or label not in RMS_BF16_WIDTHS,
                lambda x=x, g=g, dy=dy: RN.rmsnorm_backward(x, g, dy),
                lambda x=x, g=g, dy=dy: RN.rmsnorm_backward_plain(x, g, dy),
                _rms_norm_backward_library(x, g, dy),
                es * 3 * n + gs * 2 * d, 12 * n,
                _rms_backward_close(x, g, dy), F32_FLOPS_PER_S))
    for label, (b, sq, sk, h, kv, d, causal, window), timed in [
            ("smollm_prefill", (B, S, S, 15, 5, 64, True, 0), True),
            ("d128_ragged", (1, 100, 100, 4, 2, 128, True, 0), False),
            ("d256_mqa", (1, 70, 70, 4, 1, 256, True, 0), False),
            ("d32_reduced", (2, 37, 37, 4, 2, 32, True, 0), False),
            ("window48", (2, 200, 200, 4, 2, 64, True, 48), False),
            ("noncausal", (2, 48, 80, 2, 2, 64, False, 0), False),
            ("masked_rows", (1, 64, 16, 2, 1, 64, False, 8), False),
            ("sq1", (2, 1, 77, 4, 2, 64, False, 0), False),
            ("d256_window40", (1, 90, 90, 2, 1, 256, True, 40), False),
            ("qk_x4", (1, 256, 256, 4, 2, 64, True, 0), False),
            # the four families' prefills: gemma3's global and local layers
            # (at s = 1024 the window of 1024 masks nothing; at 1088 it
            # masks keys), recurrentgemma's local MQA, internvl2, musicgen
            ("gemma3_global", (B, S, S, 8, 4, 256, True, 0), True),
            ("gemma3_local", (B, S, S, 8, 4, 256, True, 1024), True),
            ("gemma3_local_s1088", (B, 1088, 1088, 8, 4, 256, True, 1024),
             True),
            ("recurrentgemma_local", (B, S, S, 10, 1, 256, True, 2048),
             True),
            ("internvl2_prefill", (B, S, S, 14, 2, 64, True, 0), True),
            ("musicgen_prefill", (B, S, S, 32, 32, 64, True, 0), True)]:
        # q and k scaled by 4: scores up to ~80 would show a 1xTF32 route
        q, k, v = _flash_case(b, sq, sk, h, kv, d, len(cases),
                              4.0 if label == "qk_x4" else 1.0)
        cases.append((
            "flash_attention", label, timed,
            lambda q=q, k=k, v=v, c=causal, w=window: FA.flash_attention(
                q, k, v, causal=c, window=w),
            lambda q=q, k=k, v=v, c=causal, w=window: FA.attention_plain(
                q, k, v, causal=c, window=w),
            _sdpa_library(q, k, v, causal, window) if timed else None,
            4 * (2 * q.numel() + k.numel() + v.numel()),
            4 * d * b * h * _visible_pairs(sq, sk, causal, window),
            _lm_close(name="flash_attention"), F32_FLOPS_PER_S))
    # the 16-bit kernel, bfloat16 and float16, at FLASH16_CASES (one draw
    # of a case's inputs for both), the timed rows also checked on the mma
    # route, and the split case (d 128: the Hopper route), where a p.v
    # without p's low half would fall outside the tolerance (held so
    # here).  The function's operations: q.k^T and p.v, 4 d per visible
    # pair and head, at the bf16 / f16 rate (bound_split_ms counts p.v
    # twice, as both routes run it)
    drawn = {}
    for dt in ("bf16", "f16"):
        q, k, v = flash_split_case(_dtype(RMS_DTYPES[dt][0]))
        if flash16_within(flash_hi_only(q, k, v),
                          FA.attention_plain(q, k, v, causal=False)):
            raise AssertionError(f"flash split case {dt}: p.v without p's "
                                 f"low half is within tolerance")
        b, sq, sk, h, kv, d = FLASH_SPLIT_SHAPE
        run_k = (lambda q=q, k=k, v=v:
                 FA.flash_attention(q, k, v, causal=False))
        cases.append((
            "flash_attention", f"p_split_{dt}", False, run_k,
            lambda q=q, k=k, v=v: FA.attention_plain(q, k, v, causal=False),
            None, 2 * (2 * q.numel() + k.numel() + v.numel()),
            4 * d * b * h * sq * sk,
            _flash16_close(run_k, FA.flash_route(q, k, v)),
            BF16_FLOPS_PER_S))
        for label, (b, sq, sk, h, kv, d, causal, window), timed_dts in \
                FLASH16_CASES:
            if label not in drawn:
                drawn[label] = _flash_case(b, sq, sk, h, kv, d, len(cases),
                                           4.0 if label == "qk_x4" else 1.0)
            q, k, v = (t.to(_dtype(RMS_DTYPES[dt][0]))
                       for t in drawn[label])
            for route in (None, "mma") if dt in timed_dts else (None,):
                timed = dt in timed_dts and (
                    route is None or label in FLASH16_MMA_TIMED)
                if route is None:
                    run_k = (lambda q=q, k=k, v=v, c=causal, w=window:
                             FA.flash_attention(q, k, v, causal=c, window=w))
                else:
                    run_k = (lambda q=q, k=k, v=v, c=causal, w=window, d=d:
                             FA._forward(q, k, v, c, w, d ** -0.5,
                                         route="mma"))
                cases.append((
                    "flash_attention",
                    f"{label}_{dt}" + (f"_{route}" if route else ""), timed,
                    run_k,
                    lambda q=q, k=k, v=v, c=causal, w=window:
                        FA.attention_plain(q, k, v, causal=c, window=w),
                    _sdpa_library(q, k, v, causal, window) if timed else None,
                    2 * (2 * q.numel() + k.numel() + v.numel()),
                    4 * d * b * h * _visible_pairs(sq, sk, causal, window),
                    _flash16_close(run_k, route or FA.flash_route(q, k, v)),
                    BF16_FLOPS_PER_S))
    # flash's backward kernels at FLASH_BWD_TRAIN (timed, in the training
    # dtype) and FLASH_BWD_EDGES (in every dtype), from the forward
    # kernel's lse and a fixed cotangent, on the route
    # flash_backward_route picks; a timed row on the Hopper route is also
    # timed forced onto the mma route (its label + "_mma").  Bytes: q, k,
    # v, dO and lse read, dq, dk, dv written once; operations: the five
    # products, 10 d flops a visible pair and head (float32 at the float32
    # rate, its 3xTF32 and the 16-bit kernels' split products beside it)
    for label, shape, dt, timed in (
            *((l, sh, dt, True) for l, sh, dt in FLASH_BWD_TRAIN),
            *((l, sh, dt, False) for l, sh in FLASH_BWD_EDGES
              for dt in ("f32", "bf16", "f16"))):
        b, sq, sk, h, kv, d, causal, window = shape
        q, k, v, do = _flash_bwd_inputs(label, shape,
                                        _dtype(RMS_DTYPES[dt][0]),
                                        len(cases))
        _, lse = FA._attend(q, k, v, causal, window, d ** -0.5)
        rule = FA.flash_backward_route(q, k, v, do)
        for route in (rule, "mma") if timed and rule == "hopper" else (rule,):
            # the public entry on the rule's route, the forced route beside
            run_k = ((lambda a=(q, k, v, lse, do), c=causal, w=window:
                      FA.flash_attention_backward(*a, causal=c, window=w))
                     if route == rule else
                     (lambda a=(q, k, v, lse, do), c=causal, w=window:
                      FA._backward(*a, c, w, a[0].shape[-1] ** -0.5,
                                   route="mma")))
            cases.append((
                "flash_attention_backward",
                f"{label}_{dt}" + ("_mma" if route != rule else ""), timed,
                run_k,
                lambda a=(q, k, v, lse, do), c=causal, w=window:
                    FA.attention_backward_plain(*a, causal=c, window=w),
                _sdpa_backward(q, k, v, do, causal, window)
                if timed and route == rule else None,
                q.element_size() * 2 * (q.numel() + k.numel() + v.numel())
                + 4 * b * h * sq,
                10 * d * b * h * _visible_pairs(sq, sk, causal, window),
                _flash_bwd_close(q, k, v, lse, do, causal, window, run_k,
                                 route),
                F32_FLOPS_PER_S if dt == "f32" else BF16_FLOPS_PER_S))
    # the SSD scan in float32 and, on one draw of a shape's inputs, with
    # x / B / C in bfloat16 and float16 (dt and A float32, as the model
    # gives them; at mamba2's prefill shape also with dt and A in x's
    # dtype): float32 math either way, so the operations bound is
    # float32's and the bytes bound counts 2 B a 16-bit value
    for label, (b, s, h, p, g, n, chunk), timed in SSD_CASES:
        x32, dt32, A32, B32, C32 = _ssd_case(b, s, h, p, g, n, len(cases))
        for dt_name, all16 in (("f32", False), *((d, False) for d in
                                                 SSD16_DTYPES),
                               *((d, True) for d in SSD16_DTYPES
                                 if label == SSD16_ALL_INPUTS)):
            low = _dtype(RMS_DTYPES[dt_name][0])
            x, B_, C = (t.to(low) for t in (x32, B32, C32))
            dt, A = (t.to(low) for t in (dt32, A32)) if all16 else (dt32,
                                                                    A32)
            nbytes = (x.element_size() * (2 * x.numel() + B_.numel()
                                          + C.numel())
                      + dt.element_size() * dt.numel()
                      + A.element_size() * A.numel() + 4 * b * h * n * p)
            tag = ("" if dt_name == "f32" else f"_{dt_name}"
                   + ("_dt16" if all16 else ""))
            cases.append((
                "ssd_chunk_scan", label + tag,
                timed and (dt_name == "f32" or not all16),
                lambda a=(x, dt, A, B_, C), c=chunk: SSD.ssd_chunk_scan(
                    *a, chunk=c),
                lambda a=(x, dt, A, B_, C), c=chunk: SSD.ssd_chunked(*a, c),
                None, nbytes, _ssd_flops(b, s, h, p, g, n, chunk),
                _lm_close(name="ssd_chunk_scan") if dt_name == "f32"
                else _ssd16_close, F32_FLOPS_PER_S))
    return cases


def check_lm_kernels():
    """Phase 4: the LM kernels against their plain versions at every case
    (every case is checked before a failure stops the run); times at each
    served arch's prefill shape.  Returns {kernel: {label: row}}."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    out = {name: {} for name in (*LM_META, "rmsnorm_backward",
                                 "flash_attention_backward")}
    bad = []
    for (name, label, timed, run_k, run_p, run_lib, nbytes, flops, close,
         rate) in _lm_cases():
        routes = (FA.BACKWARD_ROUTE_LAUNCHES
                  if name == "flash_attention_backward" else
                  FA.ROUTE_LAUNCHES)
        before = dict(routes)
        got, want = run_k(), run_p()
        took = ",".join(r for r, n in routes.items() if n != before[r])
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        tol = LM_TOL[name]
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        ok = close(got, want)
        row = {"shape": [list(a.shape) for a in got], "max_abs_err": err,
               "within_tol": ok}
        if name.startswith("flash_attention"):
            # the route the call took (16-bit, and the backward: close
            # checks it again); float32 has the mma route only
            row["route"] = took
            ok = row["within_tol"] = ok and (rate == BF16_FLOPS_PER_S
                                             or took == "mma")
        if timed:
            bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            ops_ms = 1e3 * flops / rate
            iters = 200 if name.startswith("rmsnorm") else 20
            if name in TENSOR_CORE_KERNELS and rate == F32_FLOPS_PER_S:
                row["bound_tc_ms"] = 1e3 * 3 * flops / TF32_FLOPS_PER_S
            if name == "flash_attention" and rate == BF16_FLOPS_PER_S:
                # q.k^T once, p.v twice (p's high and low 16-bit halves)
                row["bound_split_ms"] = 1e3 * 1.5 * flops / rate
            if (name == "flash_attention_backward"
                    and rate == BF16_FLOPS_PER_S):
                row["bound_split_ms"] = 1e3 * FLASH_BWD_SPLIT * flops / rate
            if name == "flash_attention_backward":
                # the memory one call takes beyond what was allocated
                # before it: its gradients and D (8.39 GB at qwen3's shape
                # for the plain vjp)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                grads = run_k()
                torch.cuda.synchronize()
                row["transient_gb"] = (torch.cuda.max_memory_allocated()
                                       - base) / 1e9
                del grads
            # a row forced onto the mma route shares its inputs, plain
            # version and library call with the row before it: their times
            # are taken once, in this run
            twin = (out[name].get(label[:-len("_mma")])
                    if label.endswith("_mma") else None)
            row.update(
                # ssd, rmsnorm_backward: every kernel of one call (four /
                # two behind one wrapper)
                ms=_device_ms(run_k, iters, LM_SYMBOL.get(name)),
                call_ms=_call_ms(run_k, iters),
                plain_ms=(twin["plain_ms"] if twin else _device_ms(
                    run_p, 50 if name.startswith("rmsnorm") else 5)),
                library_ms=(twin["library_ms"] if twin
                            else _device_ms(run_lib, iters) if run_lib
                            else None),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=nbytes, flops=flops, ops_per_s=rate)
            if name.startswith("rmsnorm"):
                # back-to-back calls keep a working set under 50 MB in L2:
                # these read x from HBM, as the bound assumes
                row.update(
                    ms_flushed=_device_ms_flushed(run_k, FLUSHED_ITERS),
                    library_ms_flushed=_device_ms_flushed(run_lib,
                                                          FLUSHED_ITERS))
        out[name][label] = row
        # 16-bit flash: one ulp of the working type plus the tolerance
        tol_s = (f"1ulp+{tol:g}" if rate == BF16_FLOPS_PER_S
                 or close is _ssd16_close else f"{tol:g}")
        print(f"kernel {name:16s} {label:22s} shape={row['shape']} "
              f"max_abs_err={err:g} tol={tol_s} ok={ok}"
              + (f" route={row['route']}" if "route" in row else "")
              + (f" ms={row['ms']:.6f} call_ms={row['call_ms']:.6f} "
                 f"plain_ms={row['plain_ms']:.6f} library_ms="
                 f"{row['library_ms']} bound_ms={row['bound_ms']:.6f} "
                 f"bound_by={row['bound_by']}"
                 + (f" bound_tc_ms={row['bound_tc_ms']:.6f}"
                    if "bound_tc_ms" in row else "")
                 + (f" bound_split_ms={row['bound_split_ms']:.6f}"
                    if "bound_split_ms" in row else "")
                 + (f" transient_gb={row['transient_gb']:.3f}"
                    if "transient_gb" in row else "")
                 + (f" ms_flushed={row['ms_flushed']:.6f} library_ms_flushed"
                    f"={row['library_ms_flushed']:.6f}"
                    if "ms_flushed" in row else "")
                 if timed else ""), flush=True)
        if not ok:
            bad.append(f"{name} {label}")
    if bad:
        raise AssertionError(f"kernels outside tolerance of their plain "
                             f"versions: {bad}")
    return out


def _arch_config(label):
    """The config of a label "<arch>" or "<arch>:<dtype>" (the arch with
    its parameters in that dtype)."""
    import dataclasses
    from repro_torch.configs import get_config
    arch, _, dtype = label.partition(":")
    cfg = get_config(arch)
    return dataclasses.replace(cfg, param_dtype=dtype) if dtype else cfg


def _expected_launches(cfg, decode_steps=SERVE_STEPS):
    """Kernel launches a prefill and ``decode_steps`` decode steps imply:
    per prefill one flash per attention layer (global, local or with an
    MoE FFN) and one SSD scan per SSM layer; per forward (prefill and each
    decode step) two rmsnorms per layer (an SSM block's second is its
    gated norm), two more per attention layer under qk-norm (q and k over
    head_dim), one more per MLA layer (``kv_norm`` over the latent: once,
    as the port's prefill computes the latents once), and the final norm;
    none for an RG-LRU block's recurrence, MLA's attention or an MoE FFN
    (plain PyTorch, as the reference computes them outside any Pallas
    kernel)."""
    from repro_torch.configs import (ATTN, ATTN_LOCAL, ATTN_MOE, MLA_DENSE,
                                     MLA_MOE, SSM)
    kinds = cfg.layer_types
    attn = sum(kinds.count(k) for k in (ATTN, ATTN_LOCAL, ATTN_MOE))
    mla = kinds.count(MLA_DENSE) + kinds.count(MLA_MOE)
    norms = 2 * len(kinds) + (2 * attn if cfg.qk_norm else 0) + mla + 1
    return {"flash_attention": attn,
            "ssd_chunk_scan": kinds.count(SSM),
            "rmsnorm": norms * (1 + decode_steps)}


def _gpu_clocks():
    """The card's SM clock, its maximum and the active throttle reasons,
    as nvidia-smi prints them (one line)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
         "clocks_throttle_reasons.active", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return (res.stdout.strip().splitlines() or [res.stderr.strip()])[0]


def _card_state():
    import torch
    return {"clocks": _gpu_clocks(),
            "reserved_gb": torch.cuda.memory_reserved() / 1e9}


def _logits_shape(cfg, rows):
    k = (cfg.n_codebooks,) if cfg.frontend == "audio" else ()
    return (rows, 1, *k, cfg.padded_vocab)


def _plain_keep(expert_idx, n_experts, cap):
    """The kept (token, choice) slots of one grouped dispatch, counted
    plainly from its (g, tpg, k) expert choices (nested lists): in each
    group, token by token and choice by choice, a slot is kept while fewer
    than ``cap`` earlier slots of the group went to its expert."""
    keep = []
    for group in expert_idx:
        seen = [0] * n_experts
        rows = []
        for choices in group:
            row = []
            for e in choices:
                row.append(seen[e] < cap)
                seen[e] += 1
            rows.append(row)
        keep.append(rows)
    return keep


def _count_moe_slots():
    """Wrap the grouped MoE dispatch (``moe._experts_grouped``) to tally
    the (token, expert) slots it routes and keeps, and to hold each call's
    kept slots to :func:`_plain_keep` on the CPU, at the reference's
    capacity formula (``src/repro/models/moe.py``); ``keeps`` lists each
    call's kept slots (on the CPU).  Returns the tally and the function
    that undoes the wrap."""
    import numpy as np
    from repro_torch.models import moe
    grouped = moe._experts_grouped
    tally = {"routed": 0, "kept": 0, "witnessed": 0, "keeps": []}

    def counted(p, cfg, xt, gate_vals, expert_idx, n_groups):
        y, keep = grouped(p, cfg, xt, gate_vals, expert_idx, n_groups)
        g, tpg, k = keep.shape
        m = cfg.moe
        cap = max(4, min(math.ceil(tpg * k / m.n_experts
                                   * m.capacity_factor), tpg))
        tally["keeps"].append(keep.cpu())
        got = tally["keeps"][-1].numpy()
        want = np.array(_plain_keep(
            expert_idx.reshape(g, tpg, k).tolist(), m.n_experts, cap))
        if got.shape != want.shape or not (got == want).all():
            raise AssertionError(
                f"grouped dispatch {tally['witnessed']}: kept slots differ "
                f"from the plain count (cap {cap}) at "
                f"{int((got != want).sum())} of {got.size}")
        tally["routed"] += got.size
        tally["kept"] += int(got.sum())
        tally["witnessed"] += 1
        return y, keep
    moe._experts_grouped = counted
    return tally, lambda: setattr(moe, "_experts_grouped", grouped)


def _count_flash_dtypes():
    """Wrap flash's dispatcher (``flash_attention._attend``, which on the
    card launches the kernel or raises) to tally its calls by q's dtype
    and its launches by route (``ROUTE_LAUNCHES`` across each call).
    Returns the tallies and the function that undoes the wrap."""
    from repro_torch.kernels import flash_attention as FA
    forward = FA._attend
    tally, routes = {}, {}

    def counted(q, *args, **kwargs):
        key = str(q.dtype).replace("torch.", "")
        tally[key] = tally.get(key, 0) + 1
        before = dict(FA.ROUTE_LAUNCHES)
        out = forward(q, *args, **kwargs)
        for route, n in FA.ROUTE_LAUNCHES.items():
            if n != before[route]:
                routes[route] = routes.get(route, 0) + n - before[route]
        return out
    FA._attend = counted
    return tally, routes, lambda: setattr(FA, "_attend", forward)


# phase 8 prints the kernels of the first full-size prefill whose summed
# device time differs most from the second's when the first's wall time is
# this much above the second's (ROADMAP C), and this many of them
SLOW_FIRST, SLOW_FIRST_TOP = 1.05, 8


def _profile_prefills():
    """Wrap ``serve``'s prefill step so that each prefill runs under
    ``torch.profiler`` (device activity only).  Per prefill, (its host-clock
    seconds from the call to a synchronize, inside the trace but without
    starting or stopping it; its kernels' summed device microseconds by
    name) go into the returned list.  Returns the list and the function
    that undoes the wrap."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    make = serve.D.make_prefill_step
    traces = []

    def made(*args, **kwargs):
        step = make(*args, **kwargs)

        def traced(*a, **k):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = step(*a, **k)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            traces.append((wall, {
                e.key: e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}))
            return out
        return traced
    serve.D.make_prefill_step = made
    return traces, lambda: setattr(serve.D, "make_prefill_step", make)


def _first_prefill_kernels(first, second):
    """(device ms of each trace, the SLOW_FIRST_TOP kernels whose summed
    device time differs most between them as (name, first ms, second
    ms))."""
    names = sorted(set(first) | set(second),
                   key=lambda n: -abs(first.get(n, 0) - second.get(n, 0)))
    return ((sum(first.values()) / 1e3, sum(second.values()) / 1e3),
            [(n[:80], first.get(n, 0) / 1e3, second.get(n, 0) / 1e3)
             for n in names[:SLOW_FIRST_TOP]])


def serve_path(arch, card=""):
    """Phase 8: serve ``arch`` (a label of :func:`_arch_config`) at full
    width and depth on the card, the
    launch counters zeroed just before and read just after; the SM clocks
    and the allocator's reserved bytes just before and just after that
    serve, whose prefill is the first at full size; for an MoE arch the
    share of (token, expert) slots its grouped dispatch dropped, taken in
    one more prefill of the same prompt that nothing times, each dispatch's
    kept slots held to a plain count on the CPU (decode takes the dense
    path, which drops nothing); flash's launches by dtype (all in the
    weights' dtype).  ``card`` (the card's name and power limit) is printed
    on the serve line.  Returns (config, params, serve result, counts,
    timing row)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import MLA_MOE, ATTN_MOE
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    dev = resolve_device("cuda")
    cfg = _arch_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    counted, uncounted = T.count_params(cfg), T.uncounted_params(cfg)
    # warm-up (cuBLAS plans, first launches), outside the counted run
    serve.serve(cfg, params, batch=SERVE_BATCH, prompt_len=64,
                decode_steps=2)
    # the SM clocks and the pool before and after the counted serve, the
    # process's first full-size prefill (decode's buffers are far smaller)
    probe = {"before_serve": _card_state()}
    flash_dtypes, flash_routes, unwrap_flash = _count_flash_dtypes()
    # both full-size prefills run under the profiler, each timed on the host
    # clock inside its trace (ROADMAP C's slow first prefill)
    prefill_traces, unwrap_prefill = _profile_prefills()
    kernels.reset_launches()
    try:
        res = serve.serve(cfg, params, batch=SERVE_BATCH,
                          prompt_len=SERVE_PROMPT, decode_steps=SERVE_STEPS)
        counts = kernels.launch_counts()
        unwrap_flash()               # the tallies hold the counted serve
        probe["after_serve"] = _card_state()
        # the counted serve's peak (the second serve below runs while this
        # one's caches are still held)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the process's first full-size prefill (the counted one) against
        # a second: a first one can wait on cudaMalloc growing the
        # allocator's pool (scripts/profile_port.py times those calls)
        serve.serve(cfg, params, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                    decode_steps=0)
    finally:
        unwrap_flash()
        unwrap_prefill()
    # the prefills' own host-clock times (serve's include the trace's stop)
    (prefill_s, first), (prefill_again_s, again) = prefill_traces
    (first_dev_ms, again_dev_ms), top = _first_prefill_kernels(first, again)
    slow_first = prefill_s > SLOW_FIRST * prefill_again_s
    print(f"serve {arch} prefill_trace first_ms={1e3 * prefill_s:.3f} "
          f"again_ms={1e3 * prefill_again_s:.3f} first_device_ms="
          f"{first_dev_ms:.3f} again_device_ms={again_dev_ms:.3f} kernels="
          f"{len(first)}/{len(again)} slow_first={slow_first}", flush=True)
    if slow_first:
        for name, a, b in top:
            print(f"serve {arch} slow_first_prefill kernel={name} "
                  f"first_ms={a:.3f} again_ms={b:.3f}", flush=True)
    slots = {"routed": 0, "kept": 0, "witnessed": 0}
    if cfg.moe is not None:
        tally, unwrap = _count_moe_slots()
        try:
            serve.serve(cfg, params, batch=SERVE_BATCH,
                        prompt_len=SERVE_PROMPT, decode_steps=0)
        finally:
            unwrap()
        slots = {k: tally[k] for k in slots}
    logits = res["logits"]
    want = dict.fromkeys(counts, 0)
    want.update(_expected_launches(cfg))
    timing = {"arch": arch, "params": n_params, "count_params": counted,
              "uncounted_params": uncounted, "cut": res["cut"],
              "init_s": init_s, "prefill_ms": 1e3 * prefill_s,
              "prefill_again_ms": 1e3 * prefill_again_s,
              "decode_ms_per_step": 1e3 * res["decode_s"] / SERVE_STEPS,
              "prefill_tokens_per_s":
                  SERVE_BATCH * SERVE_PROMPT / prefill_s,
              "decode_tokens_per_s":
                  SERVE_BATCH * SERVE_STEPS / res["decode_s"],
              "peak_mem_gb": peak_gb, "moe_slots": slots,
              "moe_dropped_share": (1 - slots["kept"] / slots["routed"]
                                    if slots["routed"] else None),
              "first_prefill_probe": probe, "launches": counts,
              "prefill_device_ms": first_dev_ms,
              "prefill_again_device_ms": again_dev_ms,
              "slow_first_kernels": top if slow_first else [],
              "flash_launches_by_dtype": flash_dtypes,
              "flash_launches_by_route": flash_routes,
              "param_dtype": cfg.param_dtype}
    print(f"serve {arch} params={n_params} count_params={counted} "
          f"uncounted={uncounted} cut={res['cut']} "
          f"batch={SERVE_BATCH} prompt={SERVE_PROMPT} steps={SERVE_STEPS} "
          f"init_s={init_s:.3f} prefill_ms={timing['prefill_ms']:.3f} "
          f"prefill_again_ms={timing['prefill_again_ms']:.3f} "
          f"decode_ms_per_step={timing['decode_ms_per_step']:.3f} "
          f"prefill_tokens_per_s={timing['prefill_tokens_per_s']:.1f} "
          f"decode_tokens_per_s={timing['decode_tokens_per_s']:.1f} "
          f"peak_mem_gb={timing['peak_mem_gb']:.3f} launches={counts} "
          f"flash_launches_by_dtype={flash_dtypes} "
          f"flash_launches_by_route={flash_routes} "
          f"param_dtype={cfg.param_dtype} "
          f"moe_slots={slots} moe_dropped_share="
          f"{timing['moe_dropped_share']} card={card}", flush=True)
    for when in ("before_serve", "after_serve"):
        print(f"serve {arch} first_prefill {when} clocks(sm,max_sm,"
              f"throttle)={probe[when]['clocks']} reserved_gb="
              f"{probe[when]['reserved_gb']:.3f}", flush=True)
    if n_params != counted + uncounted:
        raise AssertionError(f"{arch}: {n_params} parameters, count_params "
                             f"{counted} + {uncounted} left out")
    if tuple(logits.shape) != _logits_shape(cfg, SERVE_BATCH) or not \
            bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: bad logits {tuple(logits.shape)}")
    if any(int(t.max()) >= cfg.vocab_size for t in res["tokens"]):
        raise AssertionError(f"{arch}: sampled a token outside the vocab")
    if counts != want:
        raise AssertionError(f"{arch}: launches {counts}, expected {want}")
    if flash_dtypes != ({cfg.param_dtype: counts["flash_attention"]}
                        if counts["flash_attention"] else {}):
        raise AssertionError(f"{arch}: flash launched on {flash_dtypes}, "
                             f"its weights are {cfg.param_dtype}")
    # the forward's rule: the bfloat16 archs' prefills (d 128) take the
    # Hopper route, the float32 archs' the mma route
    route = flash_forward_route_of(cfg)
    if flash_routes != ({route: counts["flash_attention"]}
                        if counts["flash_attention"] else {}):
        raise AssertionError(f"{arch}: flash launched on routes "
                             f"{flash_routes}, expected {route} only")
    moe_layers = sum(cfg.layer_types.count(k) for k in (MLA_MOE, ATTN_MOE))
    if cfg.moe is not None and (slots["witnessed"] != moe_layers
                                or not 0 < slots["kept"] <= slots["routed"]):
        raise AssertionError(f"{arch}: the prefill's grouped dispatch kept "
                             f"{slots} over {moe_layers} MoE layers")
    return cfg, params, res, counts, timing


# phase 9's length per arch: past the window, so that prefill(s - 1)
# fills the local layers' rings with a nonzero shift and the flash kernel
# masks keys left of the window
TEACHER_S = {"gemma3-4b": 1088, "recurrentgemma-2b": 2112}
# phase 9's rows per arch where not the served batch: deepseek's prefill at
# batch 8 takes the grouped MoE path, which drops slots and regroups when
# s changes while decode drops none, so prefill(s-1) + decode is not
# prefill(s) there (nor in the reference); at batch 1 both sides take the
# drop-free dense path (1024 x 64 x 1408 <= 2^27), and the phase holds
# MLA's absorbed decode against its materialised prefill at full width
TEACHER_ROWS = {"deepseek-v2-lite-16b": 1}


def _split_last(cfg, batch):
    """(the batch without its last position, the last position's decode
    batch)."""
    if cfg.frontend == "audio":
        return ({"codes": batch["codes"][:, :, :-1]},
                {"codes": batch["codes"][:, :, -1:]})
    return (dict(batch, tokens=batch["tokens"][:, :-1]),
            {"tokens": batch["tokens"][:, -1:]})


def _bf16_ulp(x):
    """One ulp of bfloat16 at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def _ulp_at(x, dtype):
    """One ulp of ``dtype`` (bfloat16: 8 significant bits; float16: 11,
    subnormal below 2^-14) at |x|."""
    if dtype == "bfloat16":
        return _bf16_ulp(x)
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -14))) - 10)


def _logits_close(got, want, dtype):
    """(max error, tolerance, within): float32 logits within TEACHER_TOL
    (absolute + relative); 16-bit ones (``dtype`` in LOW_DTYPES) within
    BF16_ULPS ulps of that dtype at the largest |want|."""
    err = (got.float() - want.float()).abs()
    if dtype in LOW_DTYPES:
        tol = BF16_ULPS * _ulp_at(float(want.float().abs().max()), dtype)
        return float(err.max()), tol, bool((err <= tol).all())
    return (float(err.max()), TEACHER_TOL,
            bool((err <= TEACHER_TOL + TEACHER_TOL * want.abs()).all()))


def teacher_forcing(cfg, params, prompt):
    """Phase 9: at full width, prefill(s-1) + one decode step gives the
    last logits of prefill(s) within TEACHER_TOL (on 16-bit weights within
    BF16_ULPS ulps of their dtype at the largest logit: the prefill's
    attention runs flash's float32 math, decode's the plain scores in 16
    bits; the SSD's prefill the chunked scan, decode the recurrence).
    ``prompt`` is the served prompt batch; an arch in TEACHER_S gets a
    prompt of that length (seed 1) instead, one in TEACHER_ROWS the served
    prompt's first rows (MoE: both forwards on the dense path, checked)."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    if cfg.name in TEACHER_S:
        gen = torch.Generator(device="cuda").manual_seed(1)
        prompt = serve.prompt_batch(cfg, gen, SERVE_BATCH,
                                    TEACHER_S[cfg.name])
    rows = TEACHER_ROWS.get(cfg.name, SERVE_BATCH)
    prompt = {k: v[:rows] for k, v in prompt.items()}
    s = serve.prompt_length(cfg, prompt)
    if cfg.moe is not None and not moe.uses_dense_path(cfg, rows * s):
        raise AssertionError(f"{cfg.name}: phase 9 at {rows} x {s} takes "
                             f"the grouped MoE path")
    head, last_b = _split_last(cfg, prompt)
    with torch.no_grad():
        full, _, _ = T.forward(params, cfg, prompt, "prefill", capacity=s)
        last = full[:, -1].clone()
        del full
        _, _, caches = T.forward(params, cfg, head, "prefill", capacity=s)
        dec, _, _ = T.forward(params, cfg, last_b, "decode", caches=caches,
                              capacity=s, pos_offset=s - 1)
    dec = dec[:, 0]
    err, tol, ok = _logits_close(dec, last, cfg.param_dtype)
    print(f"teacher_forcing {cfg.name} rows={rows} s={s} "
          f"dtype={cfg.param_dtype} max_abs_err={err:g} "
          f"max_abs_logit={float(last.float().abs().max()):g} tol={tol:g} "
          f"ok={ok}", flush=True)
    if not ok:
        raise AssertionError(f"{cfg.name}: prefill+decode disagrees with "
                             f"prefill by {err:g}")
    return err


REDUCED_PROMPT, REDUCED_STEPS = 37, 3


def _reduced_stream(cfg, seed=0, rows=2):
    """(prompt batch of REDUCED_PROMPT positions, the decode batches) of
    ``rows`` rows, drawn on the CPU as ``launch.serve`` draws a served
    prompt and its steps' batches."""
    import torch
    from repro_torch.launch import serve
    gen = torch.Generator().manual_seed(seed)
    prompt = serve.prompt_batch(cfg, gen, rows, REDUCED_PROMPT)
    ids = (rows, cfg.n_codebooks) if cfg.frontend == "audio" else (rows,)
    return prompt, [serve.step_batch(cfg, torch.randint(
        0, cfg.vocab_size, ids, generator=gen))
        for _ in range(REDUCED_STEPS)]


def _reduced_config(label):
    """smollm / mamba2 at three periods (cut 1 leaves two on the RSU); the
    families and the bfloat16 archs at their reduced config's own depth
    (one pattern and the tail); a label "<arch>:<dtype>" in that
    param_dtype."""
    import dataclasses
    arch = label.partition(":")[0]
    cfg = _arch_config(label).reduced()
    if arch in THREE_PERIOD_ARCHS:
        cfg = dataclasses.replace(cfg, n_layers=3)
    return cfg


def _route_spy(probs=None):
    """Wrap the MoE router (``moe._route``) to record each call's expert
    choices (t, k) on the CPU, and its probabilities (t, E) into
    ``probs`` when given a list.  Returns the record and the function
    that undoes the wrap."""
    from repro_torch.models import moe
    route = moe._route
    record = []

    def spy(p, cfg, xt):
        res = route(p, cfg, xt)
        record.append(res[2].cpu())
        if probs is not None:
            probs.append(res[0].detach().cpu())
        return res
    moe._route = spy
    return record, lambda: setattr(moe, "_route", route)


def _route_pin(choices):
    """Wrap the MoE router's top-k (``moe.top_k``) to return, call after
    call, the given expert choices (t, k) in place of its own, with the
    caller's probabilities at them as the values: a step then routes as
    the run that recorded ``choices`` did, and its gates, aux loss and
    gradients are its own arithmetic.  Returns the function that undoes
    the wrap."""
    from repro_torch.models import moe
    top_k = moe.top_k
    left = list(choices)

    def pinned(probs, k):
        idx = left.pop(0).to(probs.device)
        if idx.shape != (*probs.shape[:-1], k):
            raise AssertionError(f"pinned choices {tuple(idx.shape)} for "
                                 f"probabilities {tuple(probs.shape)}")
        return probs.gather(-1, idx), idx
    moe.top_k = pinned
    return lambda: setattr(moe, "top_k", top_k)


def _row_flips(a, b, rows):
    """Rows (sequences) where two runs' routings (per MoE call, (t, k)
    expert ids over ``rows`` rows, row-major) chose another set of
    experts for some token."""
    import torch
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} and {len(b)} MoE calls")
    flips = torch.zeros(rows, dtype=torch.bool)
    for x, y in zip(a, b):
        x = x.reshape(rows, -1, x.shape[-1]).sort(-1).values
        y = y.reshape(rows, -1, y.shape[-1]).sort(-1).values
        flips |= (x != y).flatten(1).any(1)
    return flips


def reduced_arch_cpu_vs_card(arch):
    """Phase 10 for one arch: its reduced config served on the card
    (kernels) and on the CPU (plain versions) from the same weights (in
    the config's ``param_dtype``) and inputs, cut 1: prefill + 3 decode
    steps.  float32 logits within REDUCED_TOL (absolute + relative), and
    an MoE's expert choices equal on both; 16-bit logits within BF16_ULPS
    ulps of their dtype at the CPU's largest, over BF16_ROWS rows of which
    those an MoE routed apart (a near tie of its router) are left out, at
    most half.  Returns a row."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cfg = _reduced_config(arch)
    low = cfg.param_dtype in LOW_DTYPES
    rows = BF16_ROWS if low else 2
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    prompt, steps = _reduced_stream(cfg, rows=rows)
    cap = REDUCED_PROMPT + REDUCED_STEPS
    outs, routes = [], []
    for where in ("cpu", "cuda"):
        p = tree_map(lambda a: a.to(where), params)
        opts = D.DistOptions(cut=1)
        prefill = D.make_prefill_step(cfg, opts, cap)
        decode = D.make_decode_step(cfg, opts, cap)
        record, unwrap = _route_spy()
        try:
            logits, caches = prefill(p, tree_map(lambda a: a.to(where),
                                                 prompt))
            seq = [logits.cpu()]
            for i, batch in enumerate(steps):
                logits, caches = decode(
                    p, tree_map(lambda a: a.to(where), batch), caches,
                    REDUCED_PROMPT + i)
                seq.append(logits.cpu())
        finally:
            unwrap()
        outs.append(torch.stack(seq))
        routes.append(record)
    flips = _row_flips(*routes, rows)
    keep = ~flips
    a, b = (o[:, keep] for o in outs)
    if low:
        err, tol, ok = _logits_close(b, a, cfg.param_dtype)
        ok = ok and 2 * int(keep.sum()) >= rows
    else:
        err, tol = float((a - b).abs().max()), REDUCED_TOL
        ok = not bool(flips.any()) and bool(
            ((a - b).abs() <= REDUCED_TOL + REDUCED_TOL * a.abs()).all())
    row = {"arch": cfg.name + "".join(arch.partition(":")[1:]),
           "layers": cfg.n_layers, "dtype": cfg.param_dtype, "rows": rows,
           "rows_routed_apart": int(flips.sum()), "max_abs_err": err,
           "tol": tol, "ok": ok}
    print(f"reduced_cpu_vs_card {cfg.name} layers={cfg.n_layers} "
          f"dtype={cfg.param_dtype} rows={rows} rows_routed_apart="
          f"{row['rows_routed_apart']} max_abs_err={err:g} tol={tol:g} "
          f"ok={ok}", flush=True)
    return row


def reduced_cpu_vs_card():
    """Phase 10: :func:`reduced_arch_cpu_vs_card` for every served arch
    and REDUCED_ONLY; every check is made before a failure stops the run.
    Returns {arch: max error}."""
    rows = [reduced_arch_cpu_vs_card(a) for a in SERVE_ARCHS + REDUCED_ONLY]
    bad = [r["arch"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"card and CPU logits differ: {bad}")
    return {r["arch"]: r["max_abs_err"] for r in rows}


# ---- the LM training path (phases 10f-10i; TRAIN_BATCH, TRAIN_SEQ above)
# (arch, compress, steps, batch, changes): adamw lr 3e-4, clip 1.0, remat
# on, 4 clients, the default cut (clamped to the stack's periods), seq
# 1024, the donated step (the optimizer in place, leaf by leaf: 16 B a
# float32 parameter, 12 B a bfloat16 one, with its gradient), the config
# at full width in its param_dtype.  Depth is cut where one card forces
# it (PERF.md section 4): recurrentgemma-2b one period (R, R, A) and its
# tail (R, R); gemma3-4b in float32 one period (5 local + 1 global) without
# its tail at batch 4 (the cut of the functional step's runs, kept to
# compare the peaks); in bfloat16 qwen3-14b at 15 of 40 layers at batch 8
# (78.9 GB with flash's backward kernel; 13 with the plain backward's 8.4
# GB a layer) and command-r-35b at 3 of 40 at batch 4 (4 layers run out at
# the loss's float32 logits, 80.7 GB; 1 at batch 8 too), beside their
# embedding and head of 1.57B / 4.19B parameters, gemma3-4b whole at batch
# 4; qwen3 also under int8 smashed data (the bf16 codec), one step.  The
# MLA / MoE archs: deepseek-v2-lite-16b in float32 at batch 8 at 8 of 27
# layers, seven MLA + MoE periods and its MLA + dense tail (76.5 GB; 9
# ran out of memory in a grouped MoE einsum at 83.0 GB; the grouped path
# with capacity drops: 8,192 tokens x 64 experts x 1,408 > 2^27), and
# dbrx-132b in bfloat16 at one full-width layer at batch 4 (58.0 GB).
# One period holds every layer kind; the cut then clamps to 1, so the RSU
# holds the head alone (dbrx: its final norm and head).  16-bit parameters
# of float32 archs: mamba2-780m whole in bfloat16 and in float16 (the SSD
# scan on 16-bit inputs), smollm-360m whole in float16 (flash's 16-bit mma
# route at d 64 on a training path); and smollm-360m in float32 under the
# "dots" remat policy (``changes["remat_policy"]``), beside its default
# run.  smollm / mamba2 take 2 steps (3 until their 16-bit and "dots" runs
# came): step 0 apart, one timed step each
TRAIN_RUNS = (("smollm-360m", False, 2, TRAIN_BATCH, {}),
              ("mamba2-780m", False, 2, TRAIN_BATCH, {}),
              ("smollm-360m", True, 2, TRAIN_BATCH, {}),
              ("internvl2-1b", False, 2, TRAIN_BATCH, {}),
              ("musicgen-large", False, 2, TRAIN_BATCH, {}),
              ("recurrentgemma-2b", False, 2, TRAIN_BATCH, {"n_layers": 5}),
              ("gemma3-4b", False, 2, 4, {"n_layers": 6, "tail": ()}),
              ("qwen3-14b", False, 2, TRAIN_BATCH, {"n_layers": 15}),
              ("qwen3-14b", True, 1, TRAIN_BATCH, {"n_layers": 2}),
              ("command-r-35b", False, 2, 4, {"n_layers": 3}),
              ("gemma3-4b", False, 2, 4, {"param_dtype": "bfloat16"}),
              ("deepseek-v2-lite-16b", False, 2, TRAIN_BATCH,
               {"n_layers": 8}),
              ("dbrx-132b", False, 2, 4, {"n_layers": 1}),
              ("mamba2-780m", False, 2, TRAIN_BATCH,
               {"param_dtype": "bfloat16"}),
              ("mamba2-780m", False, 2, TRAIN_BATCH,
               {"param_dtype": "float16"}),
              ("smollm-360m", False, 2, TRAIN_BATCH,
               {"param_dtype": "float16"}),
              ("smollm-360m", False, 2, TRAIN_BATCH,
               {"remat_policy": "dots"}))
# phase 10g's donation check: (arch, changes, batch) at full width
DONATION_RUN = ("qwen3-14b", {"n_layers": 1}, 4)
# phase 10f, Function vs all-plain autograd on the card: rmsnorm's and
# flash's kernel forward and backward, ssd's kernel forward and the plain
# version's vjp.  The loss sum(w * y) gives the backward a cotangent w
# that does not depend on the forward, so the gradients differ only where
# the two backward passes reduce in another order: held at phase 4b's
# forward tolerances, relative to the largest gradient.  The forward
# outputs are held at LM_TOL as in phase 4b.  A 16-bit output or gradient
# gets one ulp of its working type more (both sides round float32 math
# once, :func:`_lm_within`).  Every route's launches of the kernel and of
# its backward kernel are counted exactly: a CUDA tensor's rmsnorm or
# flash gradient never reaches the plain vjp.


def _autograd_cases():
    """(kernel, label, fn, plain fn, args, library) at small shapes and at
    the training path's shapes; ``library`` (None but for the bfloat16
    flash cases) times the library's backward on the case's args."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ssd as SSD
    cases = []
    for label, shape in (("small", (2, 12, 256)),
                         ("smollm_train_d960", (TRAIN_BATCH, TRAIN_SEQ, 960)),
                         ("mamba2_gated_d3072",
                          (TRAIN_BATCH, TRAIN_SEQ, 3072))):
        x, g = _rms_case(shape, 40 + len(cases))
        cases.append(("rmsnorm", label, RN.rmsnorm, RN.rmsnorm_plain,
                      (x, g)))
    for label, (b, s, h, kv, d) in (
            ("small", (2, 37, 4, 2, 64)),
            ("smollm_train", (TRAIN_BATCH, TRAIN_SEQ, 15, 5, 64))):
        q, k, v = _flash_case(b, s, s, h, kv, d, 40 + len(cases))
        cases.append(("flash_attention", label,
                      lambda q, k, v: FA.flash_attention(q, k, v),
                      lambda q, k, v: FA.attention_plain(q, k, v),
                      (q, k, v)))
    for label, (b, s, h, p, g, n) in (
            ("small", (2, 300, 8, 64, 1, 128)),
            ("mamba2_train", (TRAIN_BATCH, TRAIN_SEQ, 48, 64, 1, 128))):
        x, dt, A, B, C = _ssd_case(b, s, h, p, g, n, 40 + len(cases))
        a_log = torch.log(-A)
        cases.append(("ssd_chunk_scan", label,
                      lambda x, dt, al, B, C: SSD.ssd_chunk_scan(
                          x, dt, -torch.exp(al), B, C, chunk=256)[0],
                      lambda x, dt, al, B, C: SSD.ssd_chunked(
                          x, dt, -torch.exp(al), B, C, 256)[0],
                      (x, dt, a_log, B, C)))
    # the families' training shapes (phase 10g): flash at head dim 256 with
    # a window that masks keys (small), gemma3's local and global layers at
    # its batch of 4, recurrentgemma's local MQA, internvl2's 14 heads over
    # 2, musicgen's MHA; rmsnorm over gemma3's qk-norm rows at batch 4
    for label, (b, s, h, kv, d, window) in (
            ("small_window_d256", (2, 37, 8, 4, 256, 16)),
            ("gemma3_local_train", (4, TRAIN_SEQ, 8, 4, 256, 1024)),
            ("gemma3_global_train", (4, TRAIN_SEQ, 8, 4, 256, 0)),
            ("recurrentgemma_train",
             (TRAIN_BATCH, TRAIN_SEQ, 10, 1, 256, 2048)),
            ("internvl2_train", (TRAIN_BATCH, TRAIN_SEQ, 14, 2, 64, 0)),
            ("musicgen_train", (TRAIN_BATCH, TRAIN_SEQ, 32, 32, 64, 0))):
        q, k, v = _flash_case(b, s, s, h, kv, d, 40 + len(cases))
        cases.append(("flash_attention", label,
                      lambda q, k, v, w=window: FA.flash_attention(
                          q, k, v, window=w),
                      lambda q, k, v, w=window: FA.attention_plain(
                          q, k, v, window=w),
                      (q, k, v)))
    x, g = _rms_case((4, TRAIN_SEQ, 8, 256), 40 + len(cases))
    cases.append(("rmsnorm", "gemma3_qk_rows_b4", RN.rmsnorm,
                  RN.rmsnorm_plain, (x, g)))
    # deepseek-v2-lite-16b's kv_norm over the 512-wide MLA latent (its
    # norm1 / norm2 at d 2048 are musicgen's width)
    x, g = _rms_case((TRAIN_BATCH, TRAIN_SEQ, 512), 40 + len(cases))
    cases.append(("rmsnorm", "deepseek_kv_norm_d512", RN.rmsnorm,
                  RN.rmsnorm_plain, (x, g)))
    # the bfloat16 train path: flash's Function at qwen3-14b's,
    # command-r-35b's and dbrx-132b's training shapes (its forward on the
    # Hopper route) and at gemma3-4b's local and global layers in bfloat16
    # (d 256: the mma route), rmsnorm at qwen3's and dbrx's widths and over
    # qwen3's qk-norm rows (head_dim 128), scale in bf16
    for label, (b, s, h, kv, d, window) in (
            ("qwen3_train_bf16", (TRAIN_BATCH, TRAIN_SEQ, 40, 8, 128, 0)),
            ("command_r_train_bf16",
             (TRAIN_BATCH, TRAIN_SEQ, 64, 8, 128, 0)),
            ("dbrx_train_bf16", (4, TRAIN_SEQ, 48, 8, 128, 0)),
            ("gemma3_local_train_bf16", (4, TRAIN_SEQ, 8, 4, 256, 1024)),
            ("gemma3_global_train_bf16", (4, TRAIN_SEQ, 8, 4, 256, 0))):
        q, k, v = (t.to(torch.bfloat16) for t in _flash_case(
            b, s, s, h, kv, d, 40 + len(cases)))
        cases.append(("flash_attention", label,
                      lambda q, k, v, w=window: FA.flash_attention(
                          q, k, v, window=w),
                      lambda q, k, v, w=window: FA.attention_plain(
                          q, k, v, window=w),
                      (q, k, v),
                      lambda q, k, v, w=window: _sdpa_backward_ms(
                          q, k, v, window=w)))
    for label, shape in (
            ("qwen3_train_d5120_bf16", (TRAIN_BATCH, TRAIN_SEQ, 5120)),
            ("qwen3_qk_rows_bf16", (TRAIN_BATCH * TRAIN_SEQ * 40, 128)),
            ("dbrx_train_d6144_bf16", (4, TRAIN_SEQ, 6144))):
        x, g = (t.to(torch.bfloat16) for t in _rms_case(shape,
                                                        40 + len(cases)))
        cases.append(("rmsnorm", label, RN.rmsnorm, RN.rmsnorm_plain,
                      (x, g)))
    # the 16-bit mamba2 train path: the SSD scan's Function at its
    # training shape with x / B / C in bfloat16 and float16 (dt and A_log
    # float32, as the model gives them); y and the gradients of x / B / C
    # come back in their dtype, dt's and A_log's in float32
    for dt_name in SSD16_DTYPES:
        x, dt, A, B, C = _ssd_case(TRAIN_BATCH, TRAIN_SEQ, 48, 64, 1, 128,
                                   40 + len(cases))
        x, B, C = (t.to(_dtype(RMS_DTYPES[dt_name][0])) for t in (x, B, C))
        cases.append(("ssd_chunk_scan", f"mamba2_train_{dt_name}",
                      lambda x, dt, al, B, C: SSD.ssd_chunk_scan(
                          x, dt, -torch.exp(al), B, C, chunk=256)[0],
                      lambda x, dt, al, B, C: SSD.ssd_chunked(
                          x, dt, -torch.exp(al), B, C, 256)[0],
                      (x, dt, torch.log(-A), B, C)))
    return [case + (None,) * (6 - len(case)) for case in cases]


def _lm_within(a, b, tol, big=None):
    """``a`` within ``tol + tol * |b|`` of ``b`` or, given ``big`` (a
    gradient's largest value), within ``tol * max(big, 1)``; a 16-bit
    ``a`` one ulp of ``b`` more."""
    import torch
    err = (a.float() - b.float()).abs()
    bound = (tol * max(big, 1.0) if big is not None
             else tol + tol * b.float().abs())
    if a.dtype in (torch.bfloat16, torch.float16):
        bound = bound + _ulp(b)
    return bool((err <= bound).all())


# the backward kernel of each LM kernel that has one
BACKWARD_KERNELS = {"rmsnorm": "rmsnorm_backward",
                    "flash_attention": "flash_attention_backward"}


class _Grew:
    """Launches of ``name`` and of its backward kernel (0 where it has
    none) while the ``with`` block runs, held to (forward, backward)
    exactly; the other backward kernels launch nothing."""

    def __init__(self, name, label, want):
        self.name, self.label, self.want = name, label, want

    def __enter__(self):
        from repro_torch import kernels
        self.before = kernels.launch_counts()
        return self

    def __exit__(self, *exc):
        from repro_torch import kernels
        if exc[0] is not None:
            return False
        now = kernels.launch_counts()
        grew = {k: now[k] - self.before[k] for k in now}
        bwd = BACKWARD_KERNELS.get(self.name)
        got = (grew[self.name], grew[bwd] if bwd else 0)
        others = {k: grew[k] for k in BACKWARD_KERNELS.values()
                  if k != bwd and grew[k]}
        if got != self.want or others:
            raise AssertionError(f"{self.name} {self.label}: launches "
                                 f"(kernel, its backward) {got}, expected "
                                 f"{self.want}; other backward kernels "
                                 f"{others}")
        return False


def _grads(fn, args, w):
    import torch
    req = [a.detach().clone().requires_grad_() for a in args]
    out = fn(*req)
    grads = torch.autograd.grad((out * w).sum(), req)
    return out.detach(), grads


def _vjp_of_vmap(fn, vin, dims, tol, launches):
    """``torch.func.vjp`` of ``vmap(fn, in_dims=dims)`` (CohortEngine's
    vehicle side under its ``vmap`` schedule) against the per-replica
    vjps, in every input that carries the replica axis, with the vmapped
    vjp's launches held to ``launches`` (a :class:`_Grew`).  Both backward
    passes are the same backward (the plain version's vjp, or a backward
    kernel), on the folded batch or on one replica, so they differ only in
    the order of their sums: held at the forward tolerance relative to the
    largest gradient.  Returns the worst error."""
    import torch
    diff = [i for i, d in enumerate(dims) if d is not None]

    def with_diff(base, d_args):
        full = list(base)
        for i, a in zip(diff, d_args):
            full[i] = a
        return full

    with launches:
        out, vjp = torch.func.vjp(
            lambda *d: torch.func.vmap(fn, in_dims=tuple(dims))(
                *with_diff(vin, d)), *[vin[i] for i in diff])
        g = _randn(tuple(out.shape), 91).to(out.dtype)
        got = vjp(g)
    pairs = []
    for r in range(out.shape[0]):
        sl = [a if d is None else a.select(d, r) for a, d in zip(vin, dims)]
        _, vjp1 = torch.func.vjp(lambda *d: fn(*with_diff(sl, d)),
                                 *[sl[i] for i in diff])
        pairs += zip((t[r] for t in got), vjp1(g[r]))
    err = max(float((a.float() - b.float()).abs().max()) for a, b in pairs)
    big = max(float(b.float().abs().max()) for _, b in pairs)
    if not (all(_lm_within(a, b, tol, big) for a, b in pairs)
            and all(bool(torch.isfinite(t).all()) for t in got)):
        raise AssertionError(f"vjp of vmap differs from the per-replica "
                             f"vjps by {err:g} (largest {big:g})")
    return err


def _vmap_checks(name, fn, args, tol):
    """vmap of the Function over two replicas (the batch split in two)
    against the per-replica calls: the activations-only rule (bit for bit)
    and, for rmsnorm and the SSD, the parameter-carried rule (a scale / an
    A_log per replica; within the forward tolerance).  Under each rule the
    vjp of the vmap against the per-replica vjps too (:func:`_vjp_of_vmap`).
    Launches exact: one kernel call for both replicas under the fold, one
    a replica under the loop, and as many of its backward kernel (rmsnorm's,
    flash's) as its forward's.  Returns the worst errors."""
    import torch
    split = [a.reshape(2, a.shape[0] // 2, *a.shape[1:]) for a in args]
    out = {}
    dims = [0] * len(args)
    if name == "rmsnorm":
        dims[1] = None
    elif name == "ssd_chunk_scan":
        dims[2] = None
    vin = [s if d == 0 else a for s, a, d in zip(split, args, dims)]
    bwd = int(name in BACKWARD_KERNELS)
    with _Grew(name, "vmap fold", (1, 0)):
        got = torch.func.vmap(fn, in_dims=tuple(dims))(*vin)
    want = torch.stack([fn(*[v[i] if d == 0 else v for v, d in
                             zip(vin, dims)]) for i in range(2)])
    out["fold"] = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: vmap fold differs from the "
                             f"per-slice calls by {out['fold']:g}")
    out["vjp_fold"] = _vjp_of_vmap(fn, vin, dims, tol, _Grew(
        name, "vjp of vmap fold", (1, bwd)))
    if name in ("rmsnorm", "ssd_chunk_scan"):
        pi = 1 if name == "rmsnorm" else 2
        par = torch.stack([args[pi], args[pi] * 1.01])
        vin = list(split)
        vin[pi] = par
        with _Grew(name, "vmap loop", (2, 0)):
            got = torch.func.vmap(fn)(*vin)
        want = torch.stack([fn(*[v[i] for v in vin]) for i in range(2)])
        err = float((got.float() - want.float()).abs().max())
        out["loop"] = err
        if not _lm_within(got, want, tol):
            raise AssertionError(f"{name}: vmap over a parameter differs "
                                 f"from the per-slice calls by {err:g}")
        out["vjp_loop"] = _vjp_of_vmap(fn, vin, [0] * len(vin), tol, _Grew(
            name, "vjp of vmap loop", (2, 2 * bwd)))
    return out


def _rms_func_routes(args, tol):
    """rmsnorm's other routes to its backward on the card: ``vmap`` of
    ``grad`` (the fl round) with the scale shared (the forward folded, one
    call) and per replica (one forward call a replica), one backward
    launch for both replicas either way, each replica's dscale its own;
    and remat (``torch.utils.checkpoint``: the forward twice, the backward
    once).  Each against the per-replica grads within the forward
    tolerance of the largest gradient.  Returns the worst errors."""
    import torch
    from torch.utils.checkpoint import checkpoint
    from repro_torch.kernels import rmsnorm as RN
    x, g = args
    xs = x.reshape(2, x.shape[0] // 2, *x.shape[1:])
    grad = torch.func.grad(lambda a, b: RN.rmsnorm(a, b).square().sum(),
                           argnums=(0, 1))
    out = {}
    for rule, s, dims, fwd in (("fold", g, (0, None), 1),
                               ("loop", torch.stack([g, g * 1.01]), (0, 0),
                                2)):
        with _Grew("rmsnorm", f"vmap of grad {rule}", (fwd, 1)):
            got = torch.func.vmap(grad, in_dims=dims)(xs, s)
        pairs = [(a, b) for r in range(2) for a, b in zip(
            (t[r] for t in got),
            grad(xs[r], s if dims[1] is None else s[r]))]
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in pairs)
        big = max(float(b.float().abs().max()) for _, b in pairs)
        if not all(_lm_within(a, b, tol, big) for a, b in pairs):
            raise AssertionError(f"rmsnorm vmap of grad ({rule}) differs "
                                 f"from the per-replica grads by {err:g}")
        out[f"vmap_grad_{rule}"] = err
    req = [a.detach().clone().requires_grad_() for a in args]
    w = 2 * RN.rmsnorm_plain(*args)
    with _Grew("rmsnorm", "remat", (2, 1)):
        y = checkpoint(RN.rmsnorm, *req, use_reentrant=False)
        got = torch.autograd.grad(y, req, w)
    want = _grads(RN.rmsnorm, args, w)[1]
    out["remat"] = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(got, want))
    big = max(float(b.float().abs().max()) for b in want)
    if not all(_lm_within(a, b, tol, big) for a, b in zip(got, want)):
        raise AssertionError(f"rmsnorm under remat differs by "
                             f"{out['remat']:g}")
    return out


def _sdpa_backward_ms(q, k, v, window=0):
    """Device ms of the backward of one causal ``scaled_dot_product_
    attention`` call (:func:`_sdpa_backward`) on q / k / v with a fixed
    cotangent: the library's time for flash's backward.  Profiled, as CUDA
    events around ``autograd.grad`` time the host at gemma3's 0.24 ms of
    device work (0.51 ms)."""
    do = _randn(tuple(q.shape), 92).to(q.dtype)
    return _device_ms(_sdpa_backward(q, k, v, do, True, window), 5)


def lm_autograd_on_card():
    """Phase 10f: the LM kernels' autograd on the card.  Returns per
    kernel and case the errors and, at the training shapes, the device
    time of the Function's backward (rmsnorm's and flash's backward
    kernels; the plain version's vjp, which recomputes the plain forward,
    for ssd) and the memory it takes beyond what was allocated before it
    (its gradients included).  A flash case must take the route
    ``flash_route`` gives its q / k / v (a bfloat16 one at head_dim 128
    the Hopper route, gemma3's bfloat16 d 256 and every float32 case the
    mma route) and its backward the route ``flash_backward_route`` gives
    them (bfloat16 at d 128 and gemma3's d 256 the Hopper route)."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    rows = []
    for name, label, fn, plain, args, library in _autograd_cases():
        tol = LM_TOL[name]
        w = _randn(tuple(fn(*args).shape), 90)
        before = dict(FA.ROUTE_LAUNCHES)
        before_bwd = dict(FA.BACKWARD_ROUTE_LAUNCHES)
        with _Grew(name, f"{label} grad",
                   (1, int(name in BACKWARD_KERNELS))):
            y_k, g_k = _grads(fn, args, w)
        routes = [r for r, n in FA.ROUTE_LAUNCHES.items() if n != before[r]]
        bwd_routes = [r for r, n in FA.BACKWARD_ROUTE_LAUNCHES.items()
                      if n != before_bwd[r]]
        y_p, g_p = _grads(plain, args, w)
        fwd_err = float((y_k.float() - y_p.float()).abs().max())
        big = max(float(g.float().abs().max()) for g in g_p)
        grad_err = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(g_k, g_p))
        fwd_ok = y_k.dtype == y_p.dtype and _lm_within(y_k, y_p, tol)
        # each rule on the case's q / k / v (and a cotangent like q)
        want_route = ([FA.flash_route(*args)]
                      if name == "flash_attention" else [])
        want_bwd = ([FA.flash_backward_route(*args,
                                             torch.empty_like(args[0]))]
                    if name == "flash_attention" else [])
        ok = (fwd_ok and routes == want_route and bwd_routes == want_bwd
              and all(g.dtype == a.dtype for g, a in zip(g_k, args))
              and all(_lm_within(a, b, tol, big) for a, b in zip(g_k, g_p))
              and all(bool(torch.isfinite(g).all()) for g in g_k))
        row = {"kernel": name, "case": label, "dtype": str(args[0].dtype),
               "shape": list(args[0].shape), "fwd_err": fwd_err,
               "fwd_within_tol": fwd_ok, "grad_err": grad_err,
               "max_grad": big, "tol": tol, "routes": routes,
               "backward_routes": bwd_routes}
        row.update(_vmap_checks(name, fn, args, tol))
        if name == "rmsnorm":
            row.update(_rms_func_routes(args, tol))
        if not label.startswith("small"):
            req = [a.detach().clone().requires_grad_() for a in args]
            out = fn(*req)
            wo = w.to(out.dtype)

            def bwd(out=out, req=req, w=wo):
                return torch.autograd.grad(out, req, w, retain_graph=True)

            # ssd: the plain vjp, ~15 ms a call
            row["bwd_ms"] = _device_ms(
                bwd, 3 if name == "ssd_chunk_scan" else 20)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            grads = bwd()
            torch.cuda.synchronize()
            row["bwd_transient_gb"] = (torch.cuda.max_memory_allocated()
                                       - base) / 1e9
            del out, req, grads
            if library is not None:
                row["library_bwd_ms"] = library(*args)
        rows.append(row)
        extra = " ".join(f"{k}_err={row[k]:g}" for k in
                         ("loop", "vjp_loop", "vmap_grad_fold",
                          "vmap_grad_loop", "remat") if k in row)
        print(f"autograd {name:16s} {label:20s} dtype={row['dtype']} "
              f"shape={row['shape']} routes={routes} "
              f"fwd_err={fwd_err:g} fwd_within_tol={fwd_ok} "
              f"grad_err={grad_err:g} max_grad={big:g} "
              f"tol={tol:g} vmap_fold_err={row['fold']:g} "
              f"vjp_vmap_fold_err={row['vjp_fold']:g} {extra}"
              + (f" bwd_ms={row['bwd_ms']:.6f} bwd_transient_gb="
                 f"{row['bwd_transient_gb']:.3f}" if "bwd_ms" in row
                 else "")
              + (f" library_bwd_ms={row['library_bwd_ms']:.6f}"
                 if "library_bwd_ms" in row else "")
              + " launches_exact=True"
              + f" ok={ok}", flush=True)
        if not ok:
            raise AssertionError(f"autograd {name} {label}: forward "
                                 f"{fwd_err:g} or gradient {grad_err:g} "
                                 f"(largest {big:g}) outside {tol:g}, a "
                                 f"gradient not finite, or routes "
                                 f"{routes} (want {want_route})")
        torch.cuda.empty_cache()
    return rows


def _train_launches(cfg, compress, steps, remat=True):
    """Kernel launches a run of ``steps`` train steps implies.  Per step:
    one forward's (:func:`_expected_launches` without decode: the qk-norm
    rows' rmsnorms included, nothing for an RG-LRU mixer); remat runs every
    period's forward again in the backward (the final norm is outside the
    periods); the backward runs rmsnorm's backward kernel once per norm
    and flash's once per flash layer (remat or not), and plain PyTorch for
    the rest.  ``compress`` adds one quantize and one dequantize (the
    smashed boundary)."""
    fwd = _expected_launches(cfg, decode_steps=0)
    runs = 2 if remat else 1
    want = {"rmsnorm": steps * (runs * (fwd["rmsnorm"] - 1) + 1),
            "rmsnorm_backward": steps * fwd["rmsnorm"],
            "flash_attention": steps * runs * fwd["flash_attention"],
            "flash_attention_backward": steps * fwd["flash_attention"],
            "ssd_chunk_scan": steps * runs * fwd["ssd_chunk_scan"]}
    if compress:
        want.update(quantize_int8=steps, dequantize_int8=steps)
    return want


def flash_forward_route_of(cfg):
    """The route an arch's flash forward takes by ``flash_route``'s rule:
    16-bit parameters at a head dim of HOPPER_FORWARD_DIMS (64, 128) on
    the Hopper route, the rest on the mma route (the model's q / k / v are
    views TMA can map)."""
    from repro_torch.kernels import flash_attention as FA
    return ("hopper" if cfg.param_dtype in LOW_DTYPES
            and cfg.head_dim_ in FA.HOPPER_FORWARD_DIMS else "mma")


def flash_backward_route_of(cfg):
    """The route an arch's flash backward takes by
    ``flash_backward_route``'s rule: 16-bit at HOPPER_BACKWARD_DIMS (128,
    256) on the Hopper route, the rest on the mma route."""
    from repro_torch.kernels import flash_attention as FA
    return ("hopper" if cfg.param_dtype in LOW_DTYPES
            and cfg.head_dim_ in FA.HOPPER_BACKWARD_DIMS else "mma")


def train_path(arch, compress, steps, batch=TRAIN_BATCH, changes=None):
    """Phase 10g: ``launch.train.train`` at full width on the card (seq
    1024, adamw lr 3e-4, clip 1.0, remat, 4 clients, the default cut, the
    donated step) at ``batch`` rows, in the config's ``param_dtype``
    (``changes`` may set it), its depth cut by ``changes`` (printed), under
    the remat policy ``changes["remat_policy"]`` (default None: full
    recompute; ``models.transformer.set_remat_policy``), the launch
    counters zeroed just before and read just after.  flash's launches
    must all take the route ``flash_route`` gives the run's q / k / v
    (16-bit at head_dim 64 or 128: the Hopper route), its backward's the
    route ``flash_backward_route`` gives (16-bit at 128 or 256: the Hopper
    route); the parameters stay in their dtype, the moments float32."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    full = get_config(arch)
    changes = dict(changes or {})
    policy = changes.pop("remat_policy", None)
    cfg = dataclasses.replace(full, **changes)
    torch.cuda.empty_cache()
    kernels.reset_launches()
    before = dict(FA.ROUTE_LAUNCHES)
    before_bwd = dict(FA.BACKWARD_ROUTE_LAUNCHES)
    T.set_remat_policy(policy)
    try:
        res = TR.train(cfg, steps=steps, batch=batch, seq=TRAIN_SEQ,
                       compress=compress, device="cuda")
    finally:
        T.set_remat_policy(None)
    counts = kernels.launch_counts()
    routes = {r: n - before[r] for r, n in FA.ROUTE_LAUNCHES.items()}
    bwd_routes = {r: n - before_bwd[r]
                  for r, n in FA.BACKWARD_ROUTE_LAUNCHES.items()}
    want = dict.fromkeys(counts, 0)
    want.update(_train_launches(cfg, compress, steps))
    fwd_route = flash_forward_route_of(cfg)
    bwd_route = flash_backward_route_of(cfg)
    moments = res["state"]["opt"]["m"]
    # the MoE router and the SSM's A_log / D / dt_bias stay float32
    # whatever the parameters' dtype
    dtypes = sorted({str(t.dtype).replace("torch.", "")
                     for t in tree_leaves(_without_float32_leaves(
                         res["state"]["params"]))})
    f32_leaf_dtypes = sorted({str(t.dtype).replace("torch.", "")
                            for t in _float32_leaves(
                                res["state"]["params"])})
    moment_dtypes = sorted({str(t.dtype).replace("torch.", "")
                            for t in tree_leaves(moments)})
    embed_moment = float(moments["embed"].abs().max())
    layer_moments = _layer_moments(moments)
    depth = {k: v for k, v in changes.items() if k in ("n_layers", "tail")}
    cut = ("" if not depth else
           f"layers {cfg.n_layers} of {full.n_layers} (tail "
           f"{list(cfg.tail)} of {list(full.tail)})")
    row = {"arch": arch, "compress": compress, "steps": steps,
           "dtype": cfg.param_dtype, "remat_policy": policy,
           "batch": batch, "layers": cfg.n_layers,
           "full_layers": full.n_layers, "depth_cut": cut,
           "cut": res["cut"], "params": cfg.param_count(),
           "full_params": full.param_count(),
           "losses": [m["loss"] for m in res["metrics"]],
           "grad_norms": [m["grad_norm"] for m in res["metrics"]],
           "step_s": res["step_s"],
           "head_dim": cfg.head_dim_,
           "peak_mem_gb": res["peak_bytes"] / 1e9,
           "launches": counts,
           "launches_per_step": {k: v // steps for k, v in counts.items()
                                 if v},
           "flash_routes": routes,
           "flash_backward_routes": bwd_routes,
           "embed_first_moment_max": embed_moment,
           **{f"{k}_first_moment_min": v for k, v in layer_moments.items()}}
    print(f"train {arch} dtype={cfg.param_dtype} compress={compress} "
          f"remat_policy={policy} cut={res['cut']} "
          f"batch={batch} seq={TRAIN_SEQ} steps={steps} "
          f"layers={cfg.n_layers}/{full.n_layers} "
          f"depth_cut={cut or 'none'} params={row['params']} "
          f"losses={row['losses']} grad_norms={row['grad_norms']} "
          f"step0_s={res['step_s'][0]:.6f} "
          f"later_s={res['step_s'][1:]} "
          f"peak_mem_gb={row['peak_mem_gb']:.3f} "
          f"param_dtypes={dtypes} f32_leaf_dtypes={f32_leaf_dtypes} "
          f"moment_dtypes={moment_dtypes} "
          f"launches={counts} "
          f"launches_per_step={row['launches_per_step']} "
          f"flash_routes={routes} flash_backward_routes={bwd_routes} "
          f"embed_first_moment_max={embed_moment:g} "
          + " ".join(f"{k}_first_moment_min={v:g}"
                     for k, v in layer_moments.items()), flush=True)
    if not all(math.isfinite(v) for v in row["losses"] + row["grad_norms"]):
        raise AssertionError(f"{arch}: non-finite loss or grad norm {row}")
    if counts != want:
        raise AssertionError(f"{arch} compress={compress}: launches "
                             f"{counts}, expected {want}")
    if (routes[fwd_route] != counts["flash_attention"]
            or bwd_routes[bwd_route]
            != counts["flash_attention_backward"]):
        raise AssertionError(f"{arch}: flash launches by route {routes}, "
                             f"its backward's {bwd_routes}, all expected "
                             f"on {fwd_route!r} / {bwd_route!r}")
    if (dtypes != [cfg.param_dtype] or moment_dtypes != ["float32"]
            or f32_leaf_dtypes not in ([], ["float32"])):
        raise AssertionError(f"{arch}: parameters {dtypes}, float32 leaves "
                             f"{f32_leaf_dtypes}, moments {moment_dtypes}")
    if not (embed_moment > 0.0
            and all(v > 0.0 for v in layer_moments.values())):
        raise AssertionError(f"{arch}: a leaf behind a kernel got no "
                             f"gradient (embedding {embed_moment:g}, "
                             f"layers {layer_moments})")
    del res, moments
    return row


def donation_check():
    """Phase 10g's donation check: at DONATION_RUN (full width, seq 1024,
    adamw, clip 1.0, remat; one donated warm-up step first so the moments
    are not zero) one functional train step and one donated step from the
    same state, with torch's deterministic algorithms where it has them:
    every parameter, moment, count and metric equal bit for bit, the
    donated step's state the storage it was given.  Prints both steps'
    peaks (``max_memory_allocated`` over the step) and the state's
    bytes."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.launch import train as TR
    from repro_torch.tree import tree_leaves
    arch, changes, batch = DONATION_RUN
    cfg = dataclasses.replace(get_config(arch), **changes)
    dev = torch.device("cuda")
    opts = D.DistOptions(cut=cfg.default_cut)
    torch.cuda.empty_cache()
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        state = D.init_state(torch.Generator(device=dev).manual_seed(0),
                             cfg, opts)
        donated = D.make_train_step(cfg, opts)
        functional = D.make_train_step(cfg, opts, donate=False)
        batches = [TR.synth_batch(cfg, torch.Generator(device=dev)
                                  .manual_seed(i), batch, TRAIN_SEQ, 4)
                   for i in range(2)]
        state, _ = donated(state, batches[0])
        state_gb = sum(t.numel() * t.element_size()
                       for t in tree_leaves(state)) / 1e9
        peaks = {}

        def step(fn, label):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = fn(state, batches[1])
            torch.cuda.synchronize()
            peaks[label] = torch.cuda.max_memory_allocated() / 1e9
            return out

        # the functional step's state waits on the host while the donated
        # step runs (two states beside it would raise its peak)
        want, m_want = step(functional, "functional")
        want = [t.cpu() for t in tree_leaves(want)]
        torch.cuda.empty_cache()
        ptrs = [t.data_ptr() for t in tree_leaves(state["params"])]
        got, m_got = step(donated, "donated")
        same_storage = ptrs == [t.data_ptr()
                                for t in tree_leaves(got["params"])]
        leaves = tree_leaves(got)
        equal = len(leaves) == len(want) and all(
            a.dtype == b.dtype and torch.equal(a, b.to(a.device))
            for a, b in zip(leaves, want)) and all(
            torch.equal(m_got[k], m_want[k]) for k in m_want)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    row = {"arch": arch, "layers": cfg.n_layers, "batch": batch,
           "dtype": cfg.param_dtype, "state_gb": state_gb,
           "functional_peak_gb": peaks["functional"],
           "donated_peak_gb": peaks["donated"], "bit_for_bit": equal,
           "same_storage": same_storage, "loss": float(m_got["loss"])}
    print(f"donation {arch} layers={cfg.n_layers} batch={batch} "
          f"dtype={cfg.param_dtype} state_gb={state_gb:.3f} "
          f"functional_peak_gb={peaks['functional']:.3f} "
          f"donated_peak_gb={peaks['donated']:.3f} "
          f"loss={row['loss']!r} bit_for_bit={equal} "
          f"same_storage={same_storage}", flush=True)
    del state, got, want, leaves
    torch.cuda.empty_cache()
    if not (equal and same_storage
            and peaks["donated"] < peaks["functional"]):
        raise AssertionError(f"donation: the donated step differs from "
                             f"the functional one or did not lower the "
                             f"peak: {row}")
    return row


# phase 10g's remat check: (arch, changes, batch) at full width, a depth
# that holds every activation with remat off; the losses within
# REMAT_LOSS_TOL, the gradients within phase 4b's tolerance of the
# kernels on its path (rmsnorm's forward and backward) of each leaf's
# largest
REMAT_RUN = ("deepseek-v2-lite-16b", {"n_layers": 3}, TRAIN_BATCH)
REMAT_LOSS_TOL = 1e-5
REMAT_GRAD_TOL = max(LM_TOL["rmsnorm"], LM_TOL["rmsnorm_backward"])


def moe_remat_check():
    """Phase 10g's remat check: the train step's objective and gradients
    (``distributed.loss_and_grads``) of REMAT_RUN at full width, seq 1024,
    from one set of weights and one batch, with remat on and off.  Routing
    first: with remat on every router call runs twice, in the forward and
    in the backward's recompute (periods in reverse order); the recompute's
    expert choices and grouped-dispatch kept slots must equal the
    forward's, and the forward's those of the run without remat.  Then the
    losses (ce + aux) within REMAT_LOSS_TOL and every gradient within
    REMAT_GRAD_TOL of its leaf's largest value."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    arch, changes, batch = REMAT_RUN
    cfg = dataclasses.replace(get_config(arch), **changes)
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    b = TR.synth_batch(cfg, torch.Generator(device=dev).manual_seed(0),
                       batch, TRAIN_SEQ, 4)
    runs = {}
    for remat in (True, False):
        routes, unroute = _route_spy()
        tally, uncount = _count_moe_slots()
        try:
            grads, _, _, m = D.loss_and_grads(
                cfg, D.DistOptions(cut=cfg.default_cut, remat=remat),
                params, b)
        finally:
            unroute()
            uncount()
        runs[remat] = (grads, {k: float(v) for k, v in m.items()}, routes,
                       tally["keeps"])
        del grads
    (g_on, m_on, r_on, k_on), (g_off, m_off, r_off, k_off) = (runs[True],
                                                              runs[False])
    n = len(r_off)

    def same(a, b):
        return len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))
    # the backward recomputes the periods last to first
    recompute_routes = same(r_on[:n], r_on[n:][::-1])
    recompute_kept = same(k_on[:n], k_on[n:][::-1])
    forward_same = same(r_on[:n], r_off) and same(k_on[:n], k_off)
    loss_err = max(abs(m_on[k] - m_off[k]) for k in ("loss", "ce", "aux"))
    grad_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    1e-30)
                   for a, b in zip(g_on, g_off))
    slots = sum(k.numel() for k in k_off)
    dropped = 1.0 - sum(int(k.sum()) for k in k_off) / max(slots, 1)
    ok = (n > 0 and len(r_on) == 2 * n and len(k_on) == 2 * n
          and recompute_routes and recompute_kept and forward_same
          and loss_err <= REMAT_LOSS_TOL and grad_rel <= REMAT_GRAD_TOL)
    row = {"arch": arch, "layers": cfg.n_layers, "batch": batch,
           "moe_calls": n, "loss_remat": m_on["loss"],
           "loss_no_remat": m_off["loss"], "aux": m_on["aux"],
           "max_loss_err": loss_err, "max_grad_rel_err": grad_rel,
           "grad_tol": REMAT_GRAD_TOL,
           "recompute_routing_equal": recompute_routes,
           "recompute_kept_equal": recompute_kept,
           "remat_forward_equals_no_remat": forward_same,
           "dropped_share": dropped, "ok": ok}
    print(f"remat_check {arch} layers={cfg.n_layers} batch={batch} "
          f"moe_calls={n} loss_remat={m_on['loss']!r} "
          f"loss_no_remat={m_off['loss']!r} aux={m_on['aux']!r} "
          f"max_loss_err={loss_err:g} max_grad_rel_err={grad_rel:g} "
          f"grad_tol={REMAT_GRAD_TOL:g} "
          f"recompute_routing_equal={recompute_routes} "
          f"recompute_kept_equal={recompute_kept} "
          f"remat_forward_equals_no_remat={forward_same} "
          f"dropped_share={dropped:.6f} ok={ok}", flush=True)
    del runs, g_on, g_off, params
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"remat check: {row}")
    return row


# phase 10g's "dots" check: (arch, changes, batch) at full width
DOTS_RUN = ("smollm-360m", {"n_layers": 4}, TRAIN_BATCH)


def _gemm_spy():
    """A dispatch mode that records, for every matrix product it sees
    (mm, addmm, bmm, baddbmm), its op and its tensor operands' shapes and
    strides; ``calls`` holds the records.  A ``checkpoint`` recompute's
    saved products (the "dots" policy's) never reach it."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten
    ops = (aten.mm.default, aten.addmm.default, aten.bmm.default,
           aten.baddbmm.default)

    class Spy(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in ops:
                self.calls.append((str(func), tuple(
                    (tuple(a.shape), a.stride()) for a in args
                    if torch.is_tensor(a))))
            return func(*args, **(kwargs or {}))
    return Spy()


def _projection(call):
    """A recorded product without batch dims (mm / addmm, or a batch of
    one): what the "dots" policy saves."""
    op, operands = call
    return (op in ("aten.mm.default", "aten.addmm.default")
            or operands[-2][0][0] == 1)


def dots_check():
    """Phase 10g's "dots" check: the loss and gradients of
    ``transformer.loss_fn`` with remat at DOTS_RUN (full width, seq 1024,
    one set of weights and one batch) under full recompute and under the
    "dots" policy, bit for bit (torch's deterministic algorithms where it
    has them).  The matrix products are recorded (:func:`_gemm_spy`) in
    the forward and in the backward; a backward product is a projection
    run a second time when its op and operands' shapes and strides are
    those of a forward product without batch dims (:func:`_projection`).
    Under "dots" the backward runs none; under full recompute it runs
    them again.  The kernels' launches are the same under both.  Prints
    the counts; returns a row."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_flatten
    arch, changes, batch = DOTS_RUN
    cfg = dataclasses.replace(get_config(arch), **changes)
    dev = torch.device("cuda")
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    data = TR.synth_batch(cfg, torch.Generator(device=dev).manual_seed(1),
                          batch, TRAIN_SEQ, 4)
    leaves, rebuild = tree_flatten(params)
    runs = {}
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for policy in (None, "dots"):
            T.set_remat_policy(policy)
            kernels.reset_launches()
            req = [t.detach().requires_grad_(True) for t in leaves]
            with _gemm_spy() as fwd:
                loss, _ = T.loss_fn(rebuild(req), cfg, data, remat=True)
            with _gemm_spy() as bwd:
                grads = torch.autograd.grad(loss, req)
            torch.cuda.synchronize()
            proj = {c for c in fwd.calls if _projection(c)}
            runs[policy] = {
                "loss": loss.detach(), "grads": grads,
                "forward_gemms": len(fwd.calls),
                "forward_projections": sum(map(_projection, fwd.calls)),
                "backward_gemms": len(bwd.calls),
                "backward_projections_again": sum(c in proj
                                                  for c in bwd.calls),
                "launches": {k: v for k, v in kernels.launch_counts().items()
                             if v}}
            del req, loss
    finally:
        T.set_remat_policy(None)
        torch.use_deterministic_algorithms(deterministic)
    full, dots = runs[None], runs["dots"]
    same = (torch.equal(full["loss"], dots["loss"])
            and all(torch.equal(a, b)
                    for a, b in zip(full["grads"], dots["grads"])))
    row = {"arch": arch, "layers": cfg.n_layers, "batch": batch,
           "bit_for_bit": same, "loss": float(full["loss"]),
           **{f"{k}_{name}": r[k] for name, r in (("full", full),
                                                  ("dots", dots))
              for k in ("forward_gemms", "forward_projections",
                        "backward_gemms", "backward_projections_again",
                        "launches")}}
    print(f"dots_check {arch} layers={cfg.n_layers} batch={batch} "
          f"seq={TRAIN_SEQ} bit_for_bit={same} loss={row['loss']!r} "
          + " ".join(f"{k}={v}" for k, v in row.items()
                     if k.endswith(("_full", "_dots"))), flush=True)
    del runs, full, dots, params
    torch.cuda.empty_cache()
    if not (same and row["backward_projections_again_dots"] == 0
            and row["backward_projections_again_full"] > 0
            and row["launches_full"] == row["launches_dots"]):
        raise AssertionError(f"dots check: {row}")
    return row


def _routers(tree):
    """The MoE routers of a parameter (or moment) tree."""
    return [layer["ffn"]["router"] for seg in tree["segments"]
            for period in seg for layer in period
            if "router" in layer.get("ffn", {})]


# an SSM block's leaves that stay float32 whatever the parameters' dtype,
# as the reference's ``init_ssm`` builds them
SSM_FLOAT32 = ("A_log", "D", "dt_bias")


def _float32_leaves(tree):
    """The leaves of a parameter tree that stay float32 in any
    param_dtype: the MoE routers and the SSM's SSM_FLOAT32."""
    return _routers(tree) + [
        layer["mixer"][k] for seg in tree["segments"] for period in seg
        for layer in period for k in SSM_FLOAT32
        if k in layer.get("mixer", {})]


def _without_float32_leaves(tree):
    """The tree's leaves but :func:`_float32_leaves`."""
    from repro_torch.tree import tree_leaves
    ids = {id(t) for t in _float32_leaves(tree)}
    return [t for t in tree_leaves(tree) if id(t) not in ids]


def _layer_moments(moments):
    """The smallest, over the layers, of the largest adamw first moment of
    a leaf whose gradient comes only through that layer: the attention's
    ``wk`` (its gradient is flash's key gradient), MLA's ``w_dkv`` (through
    ``kv_norm``'s rmsnorm backward kernel), the SSM's ``A_log`` (the SSD
    scan's), the RG-LRU's ``w_a`` (its gate's, through the plain scan),
    ``norm1``'s scale (the rmsnorm's), under qk-norm the ``q_norm`` and
    ``k_norm`` scales (the qk-norm rows' rmsnorm backward kernel) and an
    MoE FFN's router (its gates' and the aux loss's gradient, through the
    top-k and, under remat, the recompute).  The embedding's gradient also
    reaches it around every mixer on the residual stream, so it alone
    shows only the final norm's backward."""
    layers = [layer for seg in moments["segments"] for period in seg
              for layer in period]

    def least(leaves):
        return min(float(t.abs().max()) for t in leaves)

    def mixer_leaf(mixer):
        return mixer[next(k for k in ("wk", "w_dkv", "A_log", "w_a")
                          if k in mixer)]

    out = {"mixer": least(mixer_leaf(layer["mixer"]) for layer in layers),
           "norm1": least(layer["norm1"]["scale"] for layer in layers)}
    qk = [layer["mixer"][k] for layer in layers for k in ("q_norm", "k_norm")
          if k in layer["mixer"]]
    if qk:
        out["qk_norm"] = least(qk)
    if _routers(moments):
        out["router"] = least(_routers(moments))
    return out


def _train_smoke_config(arch):
    """Phase 10h's config: smollm / mamba2 grown to three periods, the
    families' ``-smoke`` config (gemma3's period and tail, recurrentgemma's
    period and tail), internvl2 and musicgen grown to three layers, so cut 1
    leaves layers on the RSU (as the CPU parity tests); a label
    "<arch>:<dtype>" in that param_dtype."""
    import dataclasses
    cfg = _arch_config(arch).reduced()
    if len(cfg.pattern) == 1 and not cfg.tail:
        cfg = dataclasses.replace(cfg, n_layers=3)
    return cfg


# phase 10h's bfloat16 archs: a bfloat16 parameter rounds away an update
# below half its ulp, so their step is adamw and the gradient is held in
# the float32 first moment ((1 - b1) g after one step), leaf by leaf in
# norm relative to the CPU's; on the CPU these smokes' bfloat16 moments
# differ from float32's (same bfloat16-valued weights) by at most 5.4 %
# (gemma3-smoke in bfloat16 under int8: 2.5-5.4 %, qwen3 / command-r
# 1.8-3.5 %), card and CPU by less (they round at the same places).  The
# loss: on the card 1e-5 to 3.5e-4 from the CPU's for qwen3 / command-r /
# gemma3, 5.6e-4 (routed as the card) to 6.6e-4 for dbrx-smoke's three MoE
# layers (H100); routed its own way, two near-tie tokens of dbrx-smoke's
# 256 moved the CPU's loss to 9.9e-4 from the card's
BF16_MOMENT_RTOL = 0.1
BF16_LOSS_TOL = 1e-3
# phase 10h's float32 archs with 16-bit parameters, held as the bfloat16
# archs are (an adamw step, BF16_MOMENT_RTOL, BF16_LOSS_TOL)
LOW_TRAIN_SMOKES = ("mamba2-780m:bfloat16", "mamba2-780m:float16",
                    "smollm-360m:float16")


def _moment_rel_err(want, got):
    """The largest, over the leaves, of ||got - want|| / ||want|| (a leaf
    whose ``want`` is zero: 0 if ``got`` is zero too, else inf)."""
    worst = 0.0
    for a, b in zip(want, got, strict=True):
        err, ref = float((b - a).norm()), float(a.norm())
        worst = max(worst, err / ref if ref > 0 else
                    (0.0 if err == 0 else math.inf))
    return worst


def _routing_apart(a, b):
    """Two runs' routings (per MoE call, (t, k) expert ids): the (token,
    choice) slots whose expert differs, and the tokens whose set of
    experts differs (a slot can differ by a swap of two near-tied
    choices)."""
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} and {len(b)} MoE calls")
    slots = sum(int((x != y).sum()) for x, y in zip(a, b))
    tokens = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1)
                     .sum()) for x, y in zip(a, b))
    return slots, tokens


def _flip_margins(cpu, card, cpu_probs, card_probs):
    """For each token that the card routed to another set of experts than
    the CPU: the CPU's margin that the card crossed, the least CPU
    probability among the experts only the CPU chose less the largest
    among those only the card chose, in bfloat16 ulps of the former.
    Raises unless the card's choices are the top-k of the card's own
    probabilities (``moe.top_k`` on them), so a flip comes from the
    probabilities, never from the selection."""
    import torch
    from repro_torch.models import moe
    margins = []
    for a, b, pa, pb in zip(cpu, card, cpu_probs, card_probs):
        if not torch.equal(moe.top_k(pb, b.shape[-1])[1], b):
            raise AssertionError("the card's expert choices are not the "
                                 "top-k of its own router probabilities")
        for t in torch.nonzero((a.sort(-1).values != b.sort(-1).values)
                               .any(-1)).flatten().tolist():
            only_a = [e for e in a[t].tolist() if e not in b[t].tolist()]
            only_b = [e for e in b[t].tolist() if e not in a[t].tolist()]
            low = min(float(pa[t, e]) for e in only_a)
            high = max(float(pa[t, e]) for e in only_b)
            ulp = 2.0 ** (math.floor(math.log2(low)) - 7)
            margins.append((low - high) / ulp)
    return margins


def train_cpu_vs_card():
    """Phase 10h: one sgd train step (lr 1e-2, clip 1.0) of each trained
    arch's reduced config (:func:`_train_smoke_config`; deepseek's MLA +
    MoE period and its tail, dbrx's three MoE periods in bfloat16), cut 1,
    on the CPU and on the card from the same weights and batch (64
    positions drawn by ``launch.train.synth_batch`` on the CPU: tokens, patch
    embeddings, codebooks), TF32 off: remat on with the smashed data dense
    and as int8, and remat off with it dense.  The updates within
    STEP_RTOL of the largest update, the losses within 1e-4, and the
    card's launches those :func:`_train_launches` gives (remat off runs
    each period's kernels once).  The bfloat16 archs (BF16_TRAIN_ARCHS,
    their int8 trip the bf16 codec) and LOW_TRAIN_SMOKES (float32 archs in
    bfloat16 or float16) take an adamw step instead (lr 1e-2, clip 1.0):
    each leaf's first moment within BF16_MOMENT_RTOL of the CPU's in norm
    (:func:`_moment_rel_err`), the losses within BF16_LOSS_TOL, the
    parameters in their 16-bit dtype (the MoE router float32) and the
    moments float32.  An MoE's routing is compared first: the (token,
    choice) slots the card routed elsewhere than the CPU, over the
    forward's and the recompute's router calls, are counted and printed.
    A float32 step is held to its tolerance as it ran, so a flip fails it
    there, printed, never silently.  In bfloat16 the card's and the CPU's
    activations round at other places, so a router near tie can fall
    either way: the card's choices must be the top-k of its own
    probabilities (:func:`_flip_margins`, the CPU margin each routed-apart
    token crossed printed in bfloat16 ulps), and the card's step is held
    to a CPU step that routes as the card did (:func:`_route_pin`), the
    free CPU step's loss printed beside it.  Each side steps its own copy
    of the weights (the step donates its state)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import distributed as D
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map
    worst = {}
    for arch in TRAIN_ARCHS + BF16_TRAIN_ARCHS + LOW_TRAIN_SMOKES:
        cfg = _train_smoke_config(arch)
        params = T.init_params(torch.Generator().manual_seed(0), cfg)
        batch = TR.synth_batch(cfg, torch.Generator().manual_seed(0), 4, 64,
                               2)
        bf16 = cfg.param_dtype in LOW_DTYPES
        for compress, remat in ((False, True), (True, True),
                                (False, False)):
            opts = D.DistOptions(cut=1,
                                 optimizer="adamw" if bf16 else "sgd",
                                 learning_rate=SGD_LR,
                                 compress_smashed=compress, remat=remat)

            def side(where, pin=None):
                """One step on ``where`` from a copy of the weights,
                routed as ``pin`` when given: (parameters, loss, first
                moments), the routes, their probabilities, the launches."""
                kernels.reset_launches()
                p = tree_map(lambda a: a.to(where, copy=True), params)
                state = {"params": p,
                         "opt": D.make_optimizer(opts).init(p),
                         "step": torch.zeros((), dtype=torch.int32,
                                             device=where)}
                probs = []
                routes, unwrap = _route_spy(probs)
                unpin = _route_pin(pin) if pin is not None else None
                try:
                    new, m = D.make_train_step(cfg, opts)(
                        state, {k: v.to(where) for k, v in batch.items()})
                finally:
                    unwrap()
                    if unpin is not None:
                        unpin()
                out = ([t.cpu() for t in tree_leaves(new["params"])],
                       float(m["loss"]),
                       [t.cpu() for t in tree_leaves(new["opt"].get("m",
                                                                    []))])
                torch.cuda.synchronize()
                return out, routes, probs, kernels.launch_counts(), new
            cpu, routes_cpu, probs_cpu, _, _ = side("cpu")
            card, routes_card, probs_card, counts, new = side("cuda")
            # an MoE's routing first: the (token, choice) slots a near tie
            # of the router sends elsewhere on the card
            slots_apart, tokens_apart = _routing_apart(routes_cpu,
                                                       routes_card)
            margins = _flip_margins(routes_cpu, routes_card, probs_cpu,
                                    probs_card)
            free_loss = cpu[1]
            if bf16 and tokens_apart:
                cpu = side("cpu", pin=routes_card)[0]
            want = dict.fromkeys(counts, 0)
            want.update(_train_launches(cfg, compress, 1, remat))
            (pa, la, ma), (pb, lb, mb) = cpu, card
            init = tree_leaves(params)
            moved = max(float((a.float() - a0.float()).abs().max())
                        for a, a0 in zip(pa, init))
            diff = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(pa, pb))
            key = f"{arch} compress={compress}" + ("" if remat
                                                    else " remat=False")
            if bf16:
                rel = _moment_rel_err(ma, mb)
                close = (rel <= BF16_MOMENT_RTOL
                         and abs(la - lb) <= BF16_LOSS_TOL
                         and {t.dtype for t in _without_float32_leaves(
                             new["params"])} == {_dtype(cfg.param_dtype)}
                         and {t.dtype for t in _float32_leaves(
                             new["params"])} <= {torch.float32}
                         and {t.dtype for t in mb} == {torch.float32}
                         and all(bool(torch.isfinite(t).all())
                                 for t in mb))
                measure = "moment_rel"
            else:
                rel = diff / moved if moved > 0 else math.inf
                close = rel <= STEP_RTOL and abs(la - lb) <= 1e-4
                measure = "over_update"
            worst[key] = rel
            print(f"train_cpu_vs_card {cfg.name} layers={cfg.n_layers} "
                  f"dtype={cfg.param_dtype} compress={compress} "
                  f"remat={remat} loss_cpu={la!r} loss_card={lb!r} "
                  f"max_param_diff={diff:g} max_update={moved:g} "
                  f"diff_{measure}={rel:g} moe_calls={len(routes_cpu)} "
                  f"slots_routed_apart={slots_apart} "
                  f"tokens_routed_apart={tokens_apart} "
                  f"flip_margins_bf16_ulps={[round(x, 4) for x in margins]} "
                  f"cpu_routed_as_card={bool(bf16 and tokens_apart)} "
                  f"loss_cpu_own_routing={free_loss!r} "
                  f"launches={counts}", flush=True)
            if (not close
                    or not all(bool(torch.isfinite(t).all()) for t in pb)):
                raise AssertionError(f"{key}: card and CPU disagree "
                                     f"({measure} {rel:g}, losses "
                                     f"{la!r} / {lb!r})")
            if counts != want:
                raise AssertionError(f"{key}: launches {counts}, expected "
                                     f"{want}")
    return worst


# phase 10i: the text archs that TransformerUnitModel trains (the vision
# and audio frontends stay refused there, as in the reference), at their
# reduced configs: smollm / mamba2 one layer, gemma3 its period and tail
# (10 attention layers under qk-norm), recurrentgemma its period and tail
# (one local attention among 4 RG-LRU layers), qwen3-14b's one layer in
# bfloat16 (qk-norm; its units bfloat16, the FedAvg and the codec on
# bfloat16 leaves and smashed data) and deepseek-v2-lite-16b's MLA + MoE
# period and its MLA + dense tail (the MoE's dense path batched over a
# bucket's replicas under vmap; the units drop the aux loss, as the
# reference's).  Each arch runs every one of LM_FED_RUNS on a fleet of
# LM_FED_SAMPLES samples a vehicle (one batch of 16, so 5 local steps of
# the spec's 5 epochs): the spec's 64 took the phase 35-58 s with one arch
# fewer
LM_FED_ARCHS = ("smollm-360m", "mamba2-780m", "gemma3-4b",
                "recurrentgemma-2b", "qwen3-14b", "deepseek-v2-lite-16b")
LM_FED_RUNS = (("asfl", "vmap"), ("asfl", "unroll"), ("fl", "vmap"))
LM_FED_SAMPLES = 16


def _unit_launches(cfg):
    """Per unit of ``TransformerUnitModel`` (the embedding, then one a
    period) the kernel launches of its forward, and the head's (the final
    norm), as :func:`_expected_launches` counts a forward."""
    import dataclasses
    from repro_torch.models import transformer as T
    units = [{"rmsnorm": 0, "flash_attention": 0, "ssd_chunk_scan": 0}]
    for pat, n in T.segments_of(cfg):
        one = _expected_launches(dataclasses.replace(
            cfg, pattern=pat, tail=(), n_layers=len(pat)), decode_steps=0)
        one["rmsnorm"] -= 1                 # the final norm is the head's
        units += [one] * n
    return units, {"rmsnorm": 1, "flash_attention": 0, "ssd_chunk_scan": 0}


def lm_fed_path(arch, scheme, mode):
    """Phase 10i: ``api.run`` of the reduced LM on ``single_rsu`` (4
    vehicles of LM_FED_SAMPLES samples, the paper's spec otherwise, one
    round; ``asfl`` over ``topk_int8``),
    the launch counters zeroed just before and read just after.  Checks
    finite loss, accuracy in [0, 1], the cuts, wire bytes = the cost
    model's at the data's 8 tokens a sample, and every launch count: the
    codec's by phase 10d's formula; per forward of the model its norms
    (:func:`_expected_launches`: two a layer, two more an attention layer
    under qk-norm, the final norm), one flash per attention layer and one
    SSD scan per SSM layer, where ``fl``'s vmap runs the rmsnorms (the
    qk-norm scales too) and the SSD (a parameter per replica) once per
    replica and the flash kernel (activations only) once for all; per
    training forward one of rmsnorm's backward kernel a norm, where
    ``fl``'s ``vmap`` of ``grad`` folds the replicas into one."""
    import numpy as np
    import torch
    from repro_torch import api, kernels
    from repro_torch.core import cost
    wire = "topk_int8" if scheme == "asfl" else "none"
    spec = api.ExperimentSpec(
        model=arch, train=api.TrainConfig(scheme=scheme, rounds=1,
                                          wire=wire),
        fleet=api.FleetConfig(per_vehicle_samples=LM_FED_SAMPLES),
        runtime=api.RuntimeConfig(cohort_parallel=mode))
    tr, f = spec.train, spec.fleet
    entry = api.model_entry(arch)
    clients, test = entry.make_data(f.n_vehicles, f.per_vehicle_samples,
                                    f.test_samples, f.data_seed)
    steps = [max(len(c) // tr.batch_size, 1) * tr.local_epochs
             for c in clients]
    model = entry.build()
    units, head = _unit_launches(model.cfg)
    assert len(units) == model.n_units

    def launches(name, lo=0, hi=None):
        """``name``'s launches in a forward of units [lo, hi), with the
        head when ``hi`` is None."""
        return (sum(u[name] for u in units[lo:hi])
                + (head[name] if hi is None else 0))

    norms, flash, ssd = (launches("rmsnorm"), launches("flash_attention"),
                         launches("ssd_chunk_scan"))
    kernels.reset_launches()
    res = api.run(spec)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    d, (m,) = res.diagnostics, res.history
    n_steps = sum(steps)
    evals = len(test["labels"]) // 256 + bool(len(test["labels"]) % 256)
    want = dict.fromkeys(counts, 0)
    want_bytes = 0.0
    if scheme == "asfl":
        # under vmap a bucket's vehicle side runs flash once for its
        # replicas a local step (activations only); its rmsnorms and SSD
        # scans carry a parameter per replica and run once a replica
        if mode == "vmap":
            n_flash = (sum(launches("flash_attention", 0, cut) * n
                           for cut, n in _bucket_most(m.cuts, steps).items())
                       + sum(launches("flash_attention", cut) * n
                             for cut, n in zip(m.cuts, steps)))
        else:
            n_flash = flash * n_steps
        want.update(rmsnorm=norms * (n_steps + evals),
                    rmsnorm_backward=norms * n_steps,
                    flash_attention=n_flash + flash * evals,
                    flash_attention_backward=n_flash,
                    ssd_chunk_scan=ssd * (n_steps + evals))
        n_codec = (n_steps + _bucket_steps(m.cuts, steps)
                   if mode == "vmap" else 2 * n_steps)
        want.update(sparsify_quant_pack=n_codec, unpack_dequant=n_codec)
        prof = model.profile(seq=test["images"].shape[1])
        up, down = cost.effective_comm_bytes(
            prof, m.cuts, steps, tr.batch_size, wire, tr.wire_k,
            include_model_transfer=False)
        want_bytes = float(np.sum(up + down))
    else:
        n = f.n_vehicles
        local = max(steps)
        want.update(rmsnorm=norms * (n * local + evals),
                    rmsnorm_backward=norms * local,
                    flash_attention=flash * (local + evals),
                    flash_attention_backward=flash * local,
                    ssd_chunk_scan=ssd * (n * local + evals))
    print(f"lm_fed {arch} {scheme} mode={d['mode']} loss={m.loss!r} "
          f"acc={m.test_acc!r} cuts={m.cuts} client_batch_steps="
          f"{d['client_batch_steps']} wire_bytes={d['wire_bytes']} "
          f"cost_model_bytes={want_bytes!r} launches={counts} "
          f"run_s={res.timing['run_s']:.6f}", flush=True)
    cuts_ok = (m.cuts == [] if scheme == "fl"
               else len(m.cuts) == 4
               and set(m.cuts) <= set(range(1, model.n_units)))
    if not (math.isfinite(m.loss) and 0.0 <= m.test_acc <= 1.0 and cuts_ok
            and d["mode"] == mode and d["client_batch_steps"] == n_steps
            and d["wire_bytes"] == want_bytes and counts == want):
        raise AssertionError(f"lm_fed {arch} {scheme} {mode}: {m}, "
                             f"{d['client_batch_steps']} steps (want "
                             f"{n_steps}), {d['wire_bytes']} bytes (want "
                             f"{want_bytes}), launches {counts} (want "
                             f"{want})")
    return {"arch": arch, "scheme": scheme, "mode": d["mode"],
            "loss": m.loss, "acc": m.test_acc, "cuts": m.cuts,
            "wire_bytes": d["wire_bytes"], "launches": counts,
            "run_s": res.timing["run_s"]}


# ---- the parallel server schedule on the multi-RSU path (phase 10j):
# phase 10b's cells under server_schedule="parallel" (arXiv:2405.18707).
# (label, scenario, strategy, wire, layout, superstep K, rounds)
PAR_RUNS = (
    ("highway_ragged_k1", "highway_corridor", "paper", "topk_int8",
     "ragged", 1, SCEN_ROUNDS),
    ("highway_ragged_k4", "highway_corridor", "paper", "topk_int8",
     "ragged", 4, SCEN_ROUNDS),
    ("highway_dense_k1", "highway_corridor", "paper", "topk_int8", "dense",
     1, 2),
    ("urban_ragged_k1", "urban_grid", "residence", "int8", "ragged", 1, 2))
# codec launches of the parallel schedule (mlp9) as (a, b): a per (cut
# bucket, local step) and b per (cut bucket, RSU, local step), the
# engine's ``bucket_steps`` / ``rsu_bucket_steps``.  topk_int8: pack up
# and down; unpack for the vehicles' residuals (which is also the RSU's
# dense copy for its first weight's gradient) and for the downlink; the
# fused matmul once per RSU in the bucket.  int8: quantize and dequantize
# once each way.
PAR_LAUNCHES = {
    "topk_int8": {"sparsify_quant_pack": (2, 0), "unpack_dequant": (2, 0),
                  "unpack_dequant_matmul": (0, 1)},
    "int8": {"quantize_int8": (2, 0), "dequantize_int8": (2, 0)}}


def _flat_params(units, head):
    import numpy as np
    return np.concatenate(
        [t.detach().cpu().numpy().ravel() for u in units for t in u.values()]
        + [t.detach().cpu().numpy().ravel() for t in head.values()])


def parallel_path(label, scenario, strategy, wire, layout, k, rounds,
                  cut_set, **groups):
    """Phase 10j: one run of the parallel schedule through the front door
    (``api.build_engine`` of phase 10b's spec with ``server_schedule=
    "parallel"``, ``superstep`` K and the layout, then ``engine.run``), the
    launch counters zeroed just before and read just after: finite losses,
    RSU loads summing to the scheduled count, cuts in the strategy's set,
    handovers after round 0 on the highway, client batch steps and codec
    launches as the schedule implies.  ``groups`` replace spec groups
    (phase 10k's seeds).  Returns a row with the losses, the global model
    after each sync (K = 1) and at the end, and the residuals."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import api, kernels
    spec = _scenario_spec(scenario, SCEN_VEHICLES, rounds, strategy, wire)
    spec = dataclasses.replace(
        spec, train=dataclasses.replace(spec.train,
                                        server_schedule="parallel"),
        runtime=dataclasses.replace(spec.runtime, superstep=k,
                                    superstep_layout=layout), **groups)
    eng = api.build_engine(spec)
    marks, synced = [], {}

    def on_round(m):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if not (math.isfinite(m.loss) and set(m.cuts) <= cut_set
                and sum(m.rsu_loads) == m.n_scheduled > 0
                and len(m.cuts) == SCEN_VEHICLES):
            raise AssertionError(f"parallel {label}: bad round {m}")

    def on_merge(rnd, e):
        synced[rnd] = _flat_params(e.units, e.head)

    steps0, b0, r0 = eng.batch_steps, eng.bucket_steps, eng.rsu_bucket_steps
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    hist = eng.run(on_round=on_round, on_cloud_merge=on_merge)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    buckets, rsu_buckets = eng.bucket_steps - b0, eng.rsu_bucket_steps - r0
    steps = eng.batch_steps - steps0
    walls = ([run_s - (marks[-1] - marks[0])]
             + [b - a for a, b in zip(marks, marks[1:])]) if k == 1 else []
    occ = eng.occupancy_stats()
    for m, wall in zip(hist, walls or [float("nan")] * len(hist)):
        print(f"parallel {label} round={m.round} loss={m.loss!r} "
              f"scheduled={m.n_scheduled} handover={m.n_handover} "
              f"loads={m.rsu_loads} wall_s={wall:.6f}", flush=True)
    print(f"parallel {label} layout={layout} K={k} client_batch_steps="
          f"{steps} bucket_steps={buckets} rsu_bucket_steps={rsu_buckets} "
          f"launches={counts} run_s={run_s:.6f} "
          f"s_per_round={run_s / rounds:.6f} occupancy={occ}", flush=True)
    want = dict.fromkeys(counts, 0)
    want.update({name: a * buckets + b * rsu_buckets
                 for name, (a, b) in PAR_LAUNCHES[wire].items()})
    if (len(hist) != rounds or eng.mode != "parallel" or counts != want
            or steps != SCEN_STEPS * sum(m.n_scheduled for m in hist)):
        raise AssertionError(
            f"parallel {label}: {len(hist)} rounds, mode {eng.mode}, "
            f"launches {counts} (want {want}), {steps} client batch steps")
    if scenario == "highway_corridor" \
            and sum(m.n_handover for m in hist[1:]) == 0:
        raise AssertionError(f"parallel {label}: no handover after round 0")
    res = [np.zeros(0, np.float32) if r is None
           else r.detach().cpu().numpy().ravel() for r in eng.wire_res]
    return {"label": label, "scenario": scenario, "wire": wire,
            "layout": layout, "k": k, "rounds": rounds,
            "losses": [m.loss for m in hist], "synced": synced,
            "final": _flat_params(eng.units, eng.head), "residuals": res,
            "launches": counts, "bucket_steps": buckets,
            "rsu_bucket_steps": rsu_buckets, "client_batch_steps": steps,
            "round_wall_s": walls, "run_s": run_s,
            "s_per_round": run_s / rounds, "occupancy": occ}


def parallel_phase(seq_timings):
    """Phase 10j: the parallel runs; K = 4 equal to K = 1 bit for bit (a
    handover and four cloud merges inside the window), ``ragged`` equal to
    ``dense`` bit for bit on the two rounds both ran, the two-cell trace
    card vs CPU; s/round printed beside phase 10b's sequential rounds.
    Returns the timing rows, the trace's error and the runs' rows."""
    import numpy as np
    cut_sets = {"paper": {0, 2, 4, 6, 8}, "residence": set(range(9))}
    rows = {run[0]: parallel_path(*run, cut_sets[run[2]])
            for run in PAR_RUNS}
    k1, k4 = rows["highway_ragged_k1"], rows["highway_ragged_k4"]
    dense = rows["highway_dense_k1"]
    same_k = (k4["losses"] == k1["losses"]
              and np.array_equal(k4["final"], k1["final"])
              and all(np.array_equal(a, b) for a, b in
                      zip(k4["residuals"], k1["residuals"])))
    same_layout = (dense["losses"] == k1["losses"][:2]
                   and np.array_equal(dense["synced"][1], k1["synced"][1]))
    print(f"parallel bit_for_bit K4_vs_K1={same_k} "
          f"dense_vs_ragged={same_layout}", flush=True)
    if not (same_k and same_layout):
        raise AssertionError("parallel: K = 4 vs K = 1 or dense vs ragged "
                             "differ in their bits")
    trace_err = scenario_cpu_vs_card("parallel")
    seq = {t["scenario"]: t for t in seq_timings}
    out = []
    for row in rows.values():
        s = seq[row["scenario"]]
        print(f"parallel vs sequential {row['label']}: s_per_round "
              f"parallel={row['s_per_round']:.6f} sequential="
              f"{s['run_s'] / s['rounds']:.6f} (rounds "
              f"{[round(w, 6) for w in s['round_wall_s']]})", flush=True)
        out.append({key: row[key] for key in (
            "label", "scenario", "wire", "layout", "k", "rounds", "losses",
            "launches", "bucket_steps", "rsu_bucket_steps",
            "client_batch_steps", "round_wall_s", "run_s", "s_per_round",
            "occupancy")}
            | {"sequential_s_per_round": s["run_s"] / s["rounds"]})
    return out, trace_err, rows


# ---- the fault plane and the streaming plane on the multi-RSU path
# (phase 10k): phase 10b's highway cell (256 vehicles, 4 RSUs, mlp9,
# topk_int8 with error feedback, sgd lr 1e-3, local steps 2).  Faults:
# mid-round dropout, upload loss, RSU outage, and a deadline at 0.01 x the
# residence time, which some vehicles miss every round (the analytic
# latency at the chosen cut over the residence runs 1.2e-4 to 0.15 on this
# cell; 6-12 vehicles a round above 0.01, before dropout and loss take
# precedence).  Streaming: the reference's bench_streaming.py settings.
PLANE_FAULTS = dict(dropout_rate=0.1, upload_loss_rate=0.05,
                    rsu_outage_rate=0.1, straggler_factor=0.01)
PLANE_STREAM = dict(churn_rate=0.2, buffer_size=4, kernel="poly", alpha=0.5)
# (label, schedule, layout, superstep K, rounds, cloud sync, faults, stream)
PLANE_RUNS = (
    ("faults_sequential", "sequential", "ragged", 1, SCEN_ROUNDS, 1, True,
     False),
    ("faults_ragged_k1", "parallel", "ragged", 1, SCEN_ROUNDS, 1, True,
     False),
    ("faults_ragged_k4", "parallel", "ragged", 4, SCEN_ROUNDS, 1, True,
     False),
    ("faults_dense_k1", "parallel", "dense", 1, 2, 1, True, False),
    ("streaming_k4", "streaming", "ragged", 4, 8, 4, False, True),
    ("streaming_k1", "streaming", "ragged", 1, 8, 4, False, True))
# the two-cell trace card vs CPU with both planes on: failures on 2
# vehicles (the 1e-7 deadline makes every survivor a straggler but the one
# the rescue keeps), churn and a buffer of 2.  Stream seed 5 keeps both
# vehicles present long enough for the fixture's handover; with it the
# four rounds hold a dropout, stragglers, outages, an arrival and (on
# streaming) a merge on both schedules
TRACE_PLANES = dict(fault_dropout=0.3, fault_upload_loss=0.2,
                    fault_rsu_outage=0.3, fault_straggler=1e-7,
                    stream_churn_rate=0.3, stream_seed=5,
                    stream_buffer_size=2, stream_kernel="poly")


def _plane_codec_want(schedule, plans, steps):
    """Codec launches phase 10k expects, counted from the engine's plans
    (each vehicle's cut, cell and performed local steps): per client batch
    step on the sequential schedule (SCEN_LAUNCHES); per (cut bucket,
    local step) with an active slot, and per (cut bucket, RSU, local
    step) with one, on the parallel machinery (PAR_LAUNCHES)."""
    import numpy as np
    if schedule == "sequential":
        n = sum(int(p["dstep"][p["cuts"] > 0].sum()) for p in plans)
        return {k: v * n for k, v in SCEN_LAUNCHES["topk_int8"].items()}, \
            (n, 0)
    buckets = runs = 0
    for p in plans:
        for s in range(steps):
            act = (p["cuts"] > 0) & (p["dstep"] > s)
            buckets += len(np.unique(p["cuts"][act]))
            runs += len(set(zip(p["cuts"][act].tolist(),
                                p["serving"][act].tolist())))
    return {name: a * buckets + b * runs
            for name, (a, b) in PAR_LAUNCHES["topk_int8"].items()}, \
        (buckets, runs)


def plane_path(label, schedule, layout, k, rounds, sync, faulted, streamed):
    """Phase 10k: one run of phase 10b's highway cell with the fault plane
    and / or the streaming schedule through the front door
    (``api.build_engine``, then ``engine.run``), the launch counters
    zeroed just before and read just after: finite losses, loads summing
    to the scheduled count, dropouts + losses + stragglers + survivors =
    scheduled, every down RSU (the engine's draw, through
    ``ensure_rsu_up``) at load 0, the merge callback on the rounds that
    merged, buffer occupancy below R x B, codec launches as the plans
    imply.  Returns a row."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import api, kernels
    from repro_torch.core import faults
    spec = _scenario_spec("highway_corridor", SCEN_VEHICLES, rounds, "paper",
                          "topk_int8", sync)
    spec = dataclasses.replace(
        spec, train=dataclasses.replace(spec.train, server_schedule=schedule),
        runtime=dataclasses.replace(spec.runtime, superstep=k,
                                    superstep_layout=layout),
        faults=api.FaultsConfig(**(PLANE_FAULTS if faulted else {})),
        stream=api.StreamConfig(**(PLANE_STREAM if streamed else {})))
    eng = api.build_engine(spec)
    plans, marks, merged = [], [], []
    real_plan = eng._plan

    def spy(*args):
        plans.append(real_plan(*args))
        return plans[-1]

    eng._plan = spy

    def on_round(m):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    steps0, b0, r0 = eng.batch_steps, eng.bucket_steps, eng.rsu_bucket_steps
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    hist = eng.run(on_round=on_round,
                   on_stream_merge=lambda m, e: merged.append(m.round))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    steps = eng.batch_steps - steps0
    walls = ([run_s - (marks[-1] - marks[0])]
             + [b - a for a, b in zip(marks, marks[1:])]) if k == 1 else []
    R, B = eng.n_rsus, PLANE_STREAM["buffer_size"]
    bad = []
    for m, wall in zip(hist, walls or [float("nan")] * len(hist)):
        print(f"planes {label} round={m.round} loss={m.loss!r} "
              f"scheduled={m.n_scheduled} loads={m.rsu_loads} "
              f"dropout={m.n_dropout} lost={m.n_upload_lost} "
              f"straggler={m.n_straggler} rsu_down={m.n_rsu_down} "
              f"survivor_frac={m.survivor_frac:.6f} "
              f"stale_merged={m.stale_merged} present={m.n_present} "
              f"arrived={m.n_arrived} merges={m.stream_merges} "
              f"occupancy={m.buffer_occupancy} "
              f"absorbed={m.absorbed_samples} wall_s={wall:.6f}",
              flush=True)
        surv = round(m.survivor_frac * m.n_scheduled)
        if not (math.isfinite(m.loss) and sum(m.rsu_loads) == m.n_scheduled
                and m.n_dropout + m.n_upload_lost + m.n_straggler + surv
                == m.n_scheduled and 0 <= m.buffer_occupancy < R * B):
            bad.append(m.round)
        if faulted:
            down = faults.ensure_rsu_up(eng.fault_draws(m.round)[3])
            if int(down.sum()) != m.n_rsu_down or any(
                    m.rsu_loads[r] for r in np.nonzero(down)[0]):
                bad.append(m.round)
    want, (units, runs) = _plane_codec_want(schedule, plans, SCEN_STEPS)
    full = dict.fromkeys(counts, 0)
    full.update(want)
    engine_units = ((steps, 0) if schedule == "sequential" else
                    (eng.bucket_steps - b0, eng.rsu_bucket_steps - r0))
    print(f"planes {label} schedule={schedule} layout={layout} K={k} "
          f"client_batch_steps={steps} launch_units={(units, runs)} "
          f"launches={counts} run_s={run_s:.6f} "
          f"s_per_round={run_s / rounds:.6f}", flush=True)
    if (bad or len(hist) != rounds or counts != full
            or engine_units != (units, runs)
            or merged != [m.round for m in hist if m.stream_merges]):
        raise AssertionError(
            f"planes {label}: bad rounds {sorted(set(bad))}, "
            f"{len(hist)} rounds, launches {counts} (want {full}), "
            f"units {engine_units} (want {(units, runs)}), merge "
            f"callbacks {merged}")
    if faulted and rounds == SCEN_ROUNDS and sum(
            m.n_straggler > 0 for m in hist) < 2:
        raise AssertionError(f"planes {label}: stragglers in fewer than 2 "
                             f"rounds")
    if streamed and not any(m.stream_merges for m in hist):
        raise AssertionError(f"planes {label}: no StreamBuffer fired")
    res = [np.zeros(0, np.float32) if r is None
           else r.detach().cpu().numpy().ravel() for r in eng.wire_res]
    return {"label": label, "schedule": schedule, "layout": layout, "k": k,
            "rounds": rounds, "losses": [m.loss for m in hist],
            "final": _flat_params(eng.units, eng.head), "residuals": res,
            "launches": counts, "launch_units": [units, runs],
            "client_batch_steps": steps, "round_wall_s": walls,
            "run_s": run_s, "s_per_round": run_s / rounds,
            "telemetry": {f: [getattr(m, f) for m in hist] for f in (
                "n_scheduled", "n_dropout", "n_upload_lost", "n_straggler",
                "n_rsu_down", "stale_merged", "n_present", "n_arrived",
                "stream_merges", "buffer_occupancy", "absorbed_samples")}}


def plane_phase(seq_timings, par_rows):
    """Phase 10k: the fault and streaming runs; K = 4 equal to K = 1 bit
    for bit under faults (parallel) and under streaming; the two-cell
    trace card vs CPU with both planes on (sequential and streaming); the
    zero-rate invariant (phase 10j's highway K = 1 run again with
    ``fault_seed`` and ``stream_seed`` 7: the same bits); s/round printed
    beside phases 10b and 10j.  Returns (timing rows, trace errors)."""
    import numpy as np
    from repro_torch import api
    rows = {run[0]: plane_path(*run) for run in PLANE_RUNS}

    def same(a, b):
        return (a["losses"] == b["losses"]
                and np.array_equal(a["final"], b["final"])
                and all(np.array_equal(x, y) for x, y in
                        zip(a["residuals"], b["residuals"])))

    same_faults = same(rows["faults_ragged_k4"], rows["faults_ragged_k1"])
    same_stream = same(rows["streaming_k4"], rows["streaming_k1"])
    k1 = par_rows["highway_ragged_k1"]
    zero = parallel_path(
        "highway_ragged_k1_seeded", "highway_corridor", "paper", "topk_int8",
        "ragged", 1, SCEN_ROUNDS, {0, 2, 4, 6, 8},
        faults=api.FaultsConfig(seed=7), stream=api.StreamConfig(seed=7))
    same_zero = same(zero, k1) and all(
        np.array_equal(zero["synced"][r], k1["synced"][r])
        for r in k1["synced"])
    print(f"planes bit_for_bit faults_K4_vs_K1={same_faults} "
          f"streaming_K4_vs_K1={same_stream} "
          f"zero_rates_vs_10j={same_zero}", flush=True)
    if not (same_faults and same_stream and same_zero):
        raise AssertionError("planes: K = 4 vs K = 1, or the seeded "
                             "zero-rate run vs phase 10j, differ in their "
                             "bits")
    trace_err = {sched: scenario_cpu_vs_card(sched, **TRACE_PLANES)
                 for sched in ("sequential", "streaming")}
    seq = {t["scenario"]: t for t in seq_timings}["highway_corridor"]
    out = []
    for row in rows.values():
        print(f"planes vs 10b / 10j {row['label']}: s_per_round "
              f"{row['s_per_round']:.6f} sequential_10b="
              f"{seq['run_s'] / seq['rounds']:.6f} parallel_10j="
              f"{k1['s_per_round']:.6f}", flush=True)
        out.append({key: row[key] for key in (
            "label", "schedule", "layout", "k", "rounds", "losses",
            "launches", "launch_units", "client_batch_steps",
            "round_wall_s", "run_s", "s_per_round", "telemetry")}
            | {"sequential_10b_s_per_round": seq["run_s"] / seq["rounds"],
               "parallel_10j_s_per_round": k1["s_per_round"]})
    return out, trace_err


# ---- the city lattice and slot paging (phase 10l): the reference's city
# cell (benchmarks/bench_city.py's ``_spec``): mlp9, asfl, sgd lr 1e-3,
# 4096 vehicles on a 16 x 16 lattice of 256 RSUs (scenario and data seed
# 4096), 16 samples a vehicle, batch 8, one local step, ``paper`` cuts,
# cloud sync every round, 10 s rounds, ``parallel`` ``ragged`` K = 4,
# mobility churn; unpaged and at ``page_slots=128``.
CITY_VEHICLES, CITY_GRID, CITY_PAGE = 4096, (16, 16), 128
CITY_ROUNDS, CITY_K = 4, 4
# paged against unpaged on the none wire, of the largest parameter: a run
# of one RSU that a page splits is summed in two parts
PAGE_TOL = 1e-6
# the reduced city card vs CPU: tests/test_fleet_sharding.py's
# ``_city_engines`` lattice (64 vehicles, 2 x 2, page 4) on topk_int8
CITY_SMALL_N, CITY_SMALL_PAGE = 64, 4


def _city_spec(wire="none", page=0, k=CITY_K, rounds=CITY_ROUNDS,
               schedule="parallel", sync=1, stream=None):
    from repro_torch import api
    gx, gy = CITY_GRID
    return api.ExperimentSpec(
        model="mlp9",
        train=api.TrainConfig(scheme="asfl", rounds=rounds, local_steps=1,
                              batch_size=8, lr=1e-3, optimizer="sgd",
                              eval_every=0, wire=wire,
                              server_schedule=schedule),
        adaptive=api.AdaptiveConfig(strategy="paper"),
        stream=stream or api.StreamConfig(churn_source="mobility"),
        fleet=api.FleetConfig(n_vehicles=CITY_VEHICLES, scenario="city",
                              scenario_kwargs={"seed": CITY_VEHICLES,
                                               "grid_x": gx, "grid_y": gy},
                              cloud_sync_every=sync, round_interval_s=10.0,
                              per_vehicle_samples=16,
                              data_seed=CITY_VEHICLES),
        runtime=api.RuntimeConfig(superstep=k, superstep_layout="ragged",
                                  page_slots=page))


def _page_units(plans, page, steps=1):
    """(cut bucket page, local step) and (cut bucket page, RSU run, local
    step) units, counted afresh from the plans' cuts and cells: each cut's
    scheduled vehicles RSU-major, in windows of ``page`` (one window
    unpaged), every vehicle active every step (no fault plane here)."""
    import numpy as np
    units = runs = 0
    for p in plans:
        cuts, serving = p["cuts"], p["serving"]
        for c in np.unique(cuts[cuts > 0]):
            seg = np.sort(serving[cuts == c], kind="stable")
            n = len(seg)
            wins = ([(a, min(a + page, n)) for a in range(0, n, page)]
                    if 0 < page < n else [(0, n)])
            units += len(wins)
            runs += sum(len(np.unique(seg[a:e])) for a, e in wins)
    return units * steps, runs * steps


def city_path(label, spec, profile=False):
    """Phase 10l: one run of the city through the front door
    (``api.build_engine``, then ``engine.run``), the launch counters
    zeroed and the peak memory reset just before and both read just
    after: s/round after synchronize, finite losses, loads summing to the
    scheduled count, cuts in the paper's set, handovers and departures
    (mobility churn), ``occupancy_stats()`` and the slot windows of 128,
    codec launches as the plans imply (PAR_LAUNCHES per page unit); with
    ``profile`` one more round under ``torch.profiler`` (kernels a round,
    busy share).  Returns a row."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch import api, kernels
    eng = api.build_engine(spec)
    plans, merged = [], []
    real_plan = eng._plan

    def spy(*args):
        plans.append(real_plan(*args))
        return plans[-1]

    eng._plan = spy
    rounds, page = spec.train.rounds, spec.runtime.page_slots
    b0, r0 = eng.bucket_steps, eng.rsu_bucket_steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kernels.reset_launches()
    t0 = time.perf_counter()
    hist = eng.run(on_stream_merge=lambda m, e: merged.append(m.round))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    occ = eng.occupancy_stats()
    windows = -(-occ["executed_slots"] // CITY_PAGE)
    R, B = eng.n_rsus, spec.stream.buffer_size
    present, departures, bad = CITY_VEHICLES, [], []
    for m in hist:
        departures.append(present - (m.n_present - m.n_arrived))
        present = m.n_present
        print(f"city {label} round={m.round} loss={m.loss!r} "
              f"scheduled={m.n_scheduled} handover={m.n_handover} "
              f"present={m.n_present} arrived={m.n_arrived} "
              f"departed={departures[-1]} "
              f"cells_served={sum(c > 0 for c in m.rsu_loads)} "
              f"max_load={max(m.rsu_loads)} merges={m.stream_merges} "
              f"occupancy={m.buffer_occupancy}", flush=True)
        if not (math.isfinite(m.loss) and len(m.cuts) == CITY_VEHICLES
                and set(m.cuts) <= {0, 2, 4, 6, 8}
                and sum(m.rsu_loads) == m.n_scheduled > 0
                and 0 <= m.buffer_occupancy < R * B):
            bad.append(m.round)
    units, runs = _page_units(plans, page)
    want = dict.fromkeys(counts, 0)
    if spec.train.wire != "none":
        want.update({name: a * units + b * runs for name, (a, b)
                     in PAR_LAUNCHES[spec.train.wire].items()})
    engine_units = (eng.bucket_steps - b0, eng.rsu_bucket_steps - r0)
    row = {"label": label, "wire": spec.train.wire,
           "schedule": spec.train.server_schedule, "k":
           spec.runtime.superstep, "page_slots": page, "rounds": rounds,
           "n_rsus": R, "losses": [m.loss for m in hist],
           "scheduled": [m.n_scheduled for m in hist],
           "handovers": [m.n_handover for m in hist],
           "departures": departures,
           "arrivals": [m.n_arrived for m in hist],
           "merges": [m.stream_merges for m in hist],
           "run_s": run_s, "s_per_round": run_s / rounds,
           "occupancy": occ, "slot_windows": windows,
           "page_units": [units, runs], "launches": counts,
           "peak_bytes": peak, "held_bytes": held}
    print(f"city {label} wire={spec.train.wire} schedule="
          f"{spec.train.server_schedule} K={spec.runtime.superstep} "
          f"page_slots={page} run_s={run_s:.6f} s_per_round="
          f"{run_s / rounds:.6f} occupancy={occ} slot_windows={windows} "
          f"page_units={(units, runs)} launches={counts} "
          f"peak_bytes={peak} held_bytes={held}", flush=True)
    if (bad or len(hist) != rounds or counts != want or windows <= 1
            or engine_units != (units, runs)
            or merged != [m.round for m in hist if m.stream_merges]):
        raise AssertionError(
            f"city {label}: bad rounds {bad}, {len(hist)} rounds, launches "
            f"{counts} (want {want}), units {engine_units} (want "
            f"{(units, runs)}), {windows} slot windows, merge callbacks "
            f"{merged}")
    if profile:     # one warm round more, under the profiler
        # CUPTI drops runs of records, so the round is traced
        # TRACES_PER_TIME times, each from a replay of the counted run
        # (reset, the same rounds): the same work each time, the same
        # loss bit for bit; the trace that kept the most kernel records
        # is read (the rule of _per_call_ms), and a shorter one printed
        eng._plan = real_plan
        traces = []
        for _ in range(TRACES_PER_TIME):
            eng.reset()
            eng.run()
            torch.cuda.synchronize()
            with tprofile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                (m,) = eng.run_superstep(rounds, 1)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            dev = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            traces.append((sum(e.count for e in dev), wall, sum(
                float(e.self_device_time_total) for e in dev) / 1e6,
                m.loss))
        counts_seen = [t[0] for t in traces]
        if len(set(counts_seen)) > 1:
            print(f"city {label} traces of one round kept {counts_seen} "
                  f"kernel records: the shorter lost records; the longest "
                  f"is read", flush=True)
        if len({t[3] for t in traces}) > 1:
            raise AssertionError(f"city {label}: the profiled round's "
                                 f"replays gave losses {traces}")
        n, wall, busy, _ = max(traces)
        row.update(profiled_round_s=wall, kernels_per_round=n,
                   busy_share=busy / wall, traced_kernels=counts_seen)
        print(f"city {label} profiled_round_s={wall:.6f} "
              f"kernels_per_round={n} traced_kernels={counts_seen} "
              f"device_busy_s={busy:.6f} busy_share={busy / wall:.4f}",
              flush=True)
    res = [np.zeros(0, np.float32) if r is None
           else r.detach().cpu().numpy().ravel() for r in eng.wire_res]
    return row, _flat_params(eng.units, eng.head), res


def city_cpu_vs_card():
    """Phase 10l (d): the reduced paged city (64 vehicles, 2 x 2, page 4,
    topk_int8, 4 rounds as one window, local steps 2, batch 8, sgd lr
    1e-2, cloud sync every 2) on the card and on the CPU from the same
    weights: final parameters within TRACE_TOL of the largest."""
    import numpy as np
    from repro_torch.core import fedsim, scenario
    from repro_torch.models.mlp_unit import MLPUnitModel, make_mlp_fleet_data
    cfg = fedsim.SimConfig(rounds=4, local_steps=2, batch_size=8, lr=1e-2,
                           optimizer="sgd", wire="topk_int8",
                           round_interval_s=5.0, eval_every=0, superstep=4,
                           server_schedule="parallel",
                           page_slots=CITY_SMALL_PAGE)
    clients, test = make_mlp_fleet_data(CITY_SMALL_N, 24, seed=0, n_test=64)
    runs = {}
    for where in ("cpu", "cuda"):
        sc = scenario.make_scenario("city", CITY_SMALL_N, seed=1, grid_x=2,
                                    grid_y=2)
        eng = fedsim.ScenarioEngine(MLPUnitModel(), clients, test, cfg, sc,
                                    cloud_sync_every=2, device=where)
        runs[where] = (eng.run(), _flat_params(eng.units, eng.head),
                       eng.bucket_steps)
    (hc, pc, uc), (hg, pg, ug) = runs["cpu"], runs["cuda"]
    err, scale = float(np.abs(pc - pg).max()), float(np.abs(pc).max())
    ok = (err <= TRACE_TOL * scale and np.isfinite(pg).all() and uc == ug
          and [m.cuts for m in hc] == [m.cuts for m in hg])
    print(f"city_cpu_vs_card reduced city losses_cpu={[m.loss for m in hc]} "
          f"losses_card={[m.loss for m in hg]} page_units={ug} "
          f"max_param_diff={err:g} max_abs_param={scale:g} "
          f"tol={TRACE_TOL:g}x ok={ok}", flush=True)
    if not ok:
        raise AssertionError(f"reduced city: card and CPU disagree ({err:g}"
                             f" > {TRACE_TOL:g} x {scale:g}, or cuts / "
                             f"pages differ)")
    return err / scale


def city_phase():
    """Phase 10l: (a) the city cell on ``none`` unpaged and at
    ``page_slots=128``, each with one profiled round: the paged losses and
    final parameters within PAGE_TOL of the unpaged ones, the paged peak
    memory below the unpaged; (b) the cell on ``topk_int8`` paged, K = 4
    and K = 1, equal bit for bit; (c) the ``streaming`` schedule on it,
    paged (B = 4, ``poly``, alpha 0.5, mobility churn, K = 4, 8 rounds,
    sync every 4): a merge, occupancy below R x B; (d) the reduced city
    card vs CPU.  Returns (rows, the paged-vs-unpaged error, the reduced
    city's error)."""
    import numpy as np
    from repro_torch import api
    unpaged, p0, _ = city_path("none_unpaged", _city_spec(), profile=True)
    paged, p1, _ = city_path("none_paged", _city_spec(page=CITY_PAGE),
                             profile=True)
    err = float(np.abs(p0 - p1).max())
    scale = float(np.abs(p0).max())
    loss_err = max(abs(a - b) for a, b in zip(unpaged["losses"],
                                              paged["losses"]))
    ok = (err <= PAGE_TOL * scale and loss_err <= PAGE_TOL
          and unpaged["scheduled"] == paged["scheduled"]
          and paged["peak_bytes"] < unpaged["peak_bytes"])
    print(f"city paged_vs_unpaged max_param_diff={err:g} max_abs_param="
          f"{scale:g} max_loss_diff={loss_err:g} tol={PAGE_TOL:g} "
          f"peak_bytes unpaged={unpaged['peak_bytes']} paged="
          f"{paged['peak_bytes']} kernels_per_round unpaged="
          f"{unpaged['kernels_per_round']} paged="
          f"{paged['kernels_per_round']} ok={ok}", flush=True)
    if not ok:
        raise AssertionError("city: paged and unpaged disagree, or paging "
                             "did not lower the peak memory")
    k4, f4, res4 = city_path("topk_paged_k4",
                             _city_spec("topk_int8", CITY_PAGE))
    k1, f1, res1 = city_path("topk_paged_k1",
                             _city_spec("topk_int8", CITY_PAGE, k=1))
    same = (k4["losses"] == k1["losses"] and np.array_equal(f4, f1)
            and all(np.array_equal(a, b) for a, b in zip(res4, res1)))
    print(f"city bit_for_bit topk_paged_K4_vs_K1={same}", flush=True)
    if not same:
        raise AssertionError("city: paged topk_int8 K = 4 and K = 1 differ "
                             "in their bits")
    stream, _, _ = city_path("streaming_paged", _city_spec(
        "topk_int8", CITY_PAGE, rounds=8, schedule="streaming", sync=4,
        stream=api.StreamConfig(churn_source="mobility", buffer_size=4,
                                kernel="poly", alpha=0.5)))
    if not any(stream["merges"]):
        raise AssertionError("city streaming: no StreamBuffer fired")
    small_err = city_cpu_vs_card()
    return [unpaged, paged, k4, k1, stream], err / scale, small_err


def _main_cut(cuts_per_round):
    """The cut the path used most often (ties to the smaller cut)."""
    flat = [c for cuts in cuts_per_round for c in cuts]
    return min(set(flat), key=lambda c: (-flat.count(c), c))


def _run_label(run):
    """A phase-10g run's name in the JSON line: the arch, "+compress"
    under int8 smashed data, "+bf16" / "+f16" for a float32 arch trained
    in bfloat16 / float16, "+dots" under the "dots" remat policy."""
    tag = {"bfloat16": "+bf16", "float16": "+f16"}.get(run["dtype"], "")
    return (run["arch"] + ("+compress" if run["compress"] else "")
            + (tag if run["arch"] not in BF16_TRAIN_ARCHS else "")
            + (f"+{run['remat_policy']}" if run["remat_policy"] else ""))


def kernel_report(checks, launches, main_cuts, mm_checks, mm_launches,
                  lm_checks, serving, training, par_launches,
                  plane_launches, city_launches):
    """Phase 11: one entry per kernel, timed at its path's main shape.  The
    quant and LM kernels also carry their launches per training step of
    each phase-10g run (``train_launches_per_step``), the codec kernels
    their launches in phase 10j's parallel highway (topk_int8) or urban
    (int8) run (``parallel_launches``), in phase 10k's faulted
    sequential and parallel highway runs and its streaming window
    (``plane_launches``) and in phase 10l's paged topk_int8 city run (K =
    1) and paged streaming city run (``city_launches``).  The LM kernels'
    ``launches`` are phase 8's over every served arch, per arch under
    ``serving_launches``; their other timed shapes under ``shapes``.
    rmsnorm's and flash's backward kernels, which serving never runs,
    have phase 10g's launches over its runs (per run under
    ``train_launches``); flash's backward one entry a route (lm.cu's mma
    kernels, and ``HOPPER_BWD_NAME``: 16-bit d 128); the Hopper routes'
    later head dims an entry each (``HOPPER_D64_NAME``: the forward at
    16-bit d 64, whose launches are phase 10g's; ``HOPPER_BWD_D256_NAME``:
    the backward at 16-bit d 256).  Fails if an entry took no launch."""
    per_step = {}
    for run in training:
        label = _run_label(run)
        for name, n in run["launches_per_step"].items():
            per_step.setdefault(name, {})[label] = n
    out = []
    for name, replaces in KERNEL_META.items():
        label = f"cut{main_cuts[name]}"
        row = checks[name][label]
        out.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"]
                               for r in checks[name].values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "call_ms": row["call_ms"], "bound_ms": row["bound_ms"],
            "bound_by": "bytes", "library_ms": row["library_ms"],
            "shape": row["shape"],
            "parallel_launches": par_launches.get(name, 0),
            "plane_launches": plane_launches.get(name, {}),
            "city_launches": city_launches.get(name, {}),
            **({"train_launches_per_step": per_step[name]}
               if name in per_step else {}),
            **{extra: {key: checks[name][extra][key] for key in
                       ("shape", "ms", "call_ms", "plain_ms", "bound_ms",
                        "library_ms")}
               for extra in ("path_b8", "cut6_bf16",
                             *QUANT_TIMED.get(name, ()))}})
    row = mm_checks["path_b8"]
    out.append({
        "name": MM_META[0], "route": "cuda", "source": SOURCE,
        "replaces": MM_META[1], "launches": mm_launches,
        "max_abs_err": max(r["max_abs_err"] for r in mm_checks.values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "call_ms": row["call_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
        "unpack_then_matmul_ms": row["unpack_then_matmul_ms"],
        "parallel_launches": par_launches.get(MM_META[0], 0),
        "plane_launches": plane_launches.get(MM_META[0], {}),
        "city_launches": city_launches.get(MM_META[0], {}),
        "wide_ms": mm_checks["wide"]["ms"], "shape": row["shape"]})
    def flash_routes(route):
        return {t["arch"]: t["flash_launches_by_route"].get(route, 0)
                for t in serving}

    for name, replaces in LM_META.items():
        row = lm_checks[name][LM_MAIN[name]]
        out.append({
            "name": name, "route": "cuda", "source": LM_SOURCE,
            "replaces": replaces,
            # flash: lm.cu's kernel, the mma route (the wrapper's count,
            # both routes, under wrapper_launches)
            "launches": (sum(flash_routes("mma").values())
                         if name == "flash_attention" else
                         sum(t["launches"][name] for t in serving)),
            "serving_launches": (flash_routes("mma")
                                 if name == "flash_attention" else
                                 {t["arch"]: t["launches"][name]
                                  for t in serving}),
            **({"launches_by_dtype": {t["arch"]: t["flash_launches_by_dtype"]
                                      for t in serving},
                "wrapper_launches": sum(t["launches"][name]
                                        for t in serving)}
               if name == "flash_attention" else {}),
            "max_abs_err": max(r["max_abs_err"]
                               for r in lm_checks[name].values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "call_ms": row["call_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"][0],
            "train_launches_per_step": per_step.get(name, {}),
            "shapes": {label: {key: r[key] for key in LM_ROW_KEYS
                               if key in r}
                       for label, r in lm_checks[name].items()
                       if "ms" in r and label != LM_MAIN[name]},
            **({"bound_tc_ms": row["bound_tc_ms"]} if "bound_tc_ms" in row
               else {})})
    # flash's Hopper route by head dim, an entry each: d 128 (the bfloat16
    # archs' prefills and training steps) and d 64 (smollm f16's step)
    for entry, dim, main in ((HOPPER_NAME, 128, HOPPER_MAIN),
                             (HOPPER_D64_NAME, 64, HOPPER_D64_MAIN)):
        rows = {label: r for label, r in lm_checks["flash_attention"].items()
                if r.get("route") == "hopper" and r["shape"][0][-1] == dim}
        row = rows[main]
        serving_launches = flash_routes("hopper") if dim == 128 else {}
        train = {_run_label(t): t["flash_routes"]["hopper"]
                 for t in training if t["head_dim"] == dim
                 and t["flash_routes"]["hopper"]}
        out.append({
            "name": entry, "route": "cuda", "source": HOPPER_SOURCE,
            "replaces": LM_META["flash_attention"],
            "launches": (sum(serving_launches.values()) if dim == 128
                         else sum(train.values())),
            "serving_launches": serving_launches,
            "train_launches": train,
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "call_ms": row["call_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "bound_split_ms": row["bound_split_ms"],
            "shape": row["shape"][0],
            "train_launches_per_step": {
                _run_label(t): t["flash_routes"]["hopper"] // t["steps"]
                for t in training if t["head_dim"] == dim
                and t["flash_routes"]["hopper"]},
            "shapes": {label: {key: r[key] for key in LM_ROW_KEYS
                               if key in r}
                       for label, r in rows.items()
                       if "ms" in r and label != main}})
    out.append(_backward_entry("rmsnorm_backward", RMS_BWD_REPLACES,
                               lm_checks, training, per_step))
    # flash's backward by route: lm.cu's mma kernels and the Hopper ones
    # (d 128, and d 256 as an entry of its own), each with its launches in
    # phase 10g and its own rows
    for route, entry, source, main, dim in (
            ("mma", "flash_attention_backward", LM_SOURCE,
             LM_MAIN["flash_attention_backward"], None),
            ("hopper", HOPPER_BWD_NAME, HOPPER_BWD_SOURCE,
             HOPPER_BWD_MAIN, 128),
            ("hopper", HOPPER_BWD_D256_NAME, HOPPER_BWD_SOURCE,
             HOPPER_BWD_D256_MAIN, 256)):
        out.append(_backward_entry(
            "flash_attention_backward", FLASH_BWD_REPLACES, lm_checks,
            training, per_step, route=route, entry=entry, source=source,
            main=main, dim=dim))
    # every kernel of the path took a launch in this run
    idle = [k["name"] for k in out if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels launched no time on the main path: "
                             f"{idle}")
    return {"kernels": out}


def _backward_entry(name, replaces, lm_checks, training, per_step, *,
                    route=None, entry=None, source=LM_SOURCE, main=None,
                    dim=None):
    """The JSON line's entry of a backward kernel, which serving never
    runs: its launches are phase 10g's over its runs (per run under
    ``train_launches``).  For flash's backward, ``route``'s launches and
    the rows that ran on it, under the name ``entry``; with ``dim``, only
    those at that head dim."""
    main = main or LM_MAIN[name]
    row = lm_checks[name][main]
    rows = {label: r for label, r in lm_checks[name].items()
            if (route is None or r.get("route") == route)
            and (dim is None or r["shape"][0][-1] == dim)}

    def launches(t):
        if dim is not None and t["head_dim"] != dim:
            return 0
        return (t["launches"][name] if route is None
                else t["flash_backward_routes"][route])

    return {
        "name": entry or name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": sum(launches(t) for t in training),
        "train_launches": {_run_label(t): launches(t) for t in training},
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "call_ms": row["call_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "shape": row["shape"][0],
        "train_launches_per_step": (
            per_step.get(name, {}) if route is None else
            {_run_label(t): launches(t) // t["steps"]
             for t in training if launches(t)}),
        "shapes": {label: {key: r[key] for key in LM_ROW_KEYS if key in r}
                   for label, r in rows.items() if label != main},
        **({"bound_split_ms": row["bound_split_ms"]}
           if "bound_split_ms" in row else {})}


_LAP = [time.perf_counter()]


def _lap(name):
    """Print the wall seconds since the last lap: a phase's share of the
    run's time limit."""
    now = time.perf_counter()
    print(f"phase_s {name} {now - _LAP[0]:.1f}", flush=True)
    _LAP[0] = now


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # the port must be importable from this checkout before anything runs
    from repro_torch.device import set_float32_precision
    set_float32_precision()
    card = card_line()
    build_kernels()
    _lap("build")
    checks = check_kernels()
    launch_floor_ms()
    mm_checks = check_matmul_kernel()
    _lap("codec")
    lm_checks = check_lm_kernels()
    _lap("lm_kernels")
    topk_launches, topk_cuts = drive_path(
        "topk_int8", 2, ("sparsify_quant_pack", "unpack_dequant"))
    int8_launches, int8_cuts = drive_path(
        "int8", 1, ("quantize_int8", "dequantize_int8"))
    cpu_vs_card()
    _lap("asfl")
    serving = []
    for arch in SERVE_ARCHS:
        cfg, params, res, counts, timing = serve_path(arch, card)
        timing["teacher_forcing_err"] = teacher_forcing(cfg, params,
                                                        res["prompt"])
        serving.append(timing)
        del params, res
    _lap("serving")
    reduced_cpu_vs_card()
    print(json.dumps({"serving": serving}))
    # the multi-RSU phases run after serving, so every earlier path is
    # measured after the same phases as before they existed
    highway, highway_timing = scenario_path(
        "highway_corridor", SCEN_ROUNDS, "paper", "topk_int8",
        {0, 2, 4, 6, 8})
    urban, urban_timing = scenario_path("urban_grid", 2, "residence",
                                        "int8", set(range(9)))
    scenario_cpu_vs_card()
    _lap("reduced_and_scenarios")
    print(json.dumps({"scenarios": [highway_timing, urban_timing]}))
    # the single-RSU schemes and schedules run last, so every earlier path
    # is measured after the same phases as before they existed
    schemes = [scheme_path(*run) for run in SCHEME_RUNS]
    vmap, loop = schemes[-2:]
    if vmap["cuts"] != loop["cuts"]:
        raise AssertionError(f"asfl vmap / unroll from one seed chose "
                             f"other cuts: {vmap['cuts']} / {loop['cuts']}")
    vmap_cpu_vs_card()
    _lap("schemes")
    print(json.dumps({"schemes": schemes}))
    # the LM training path runs after every earlier phase, so their
    # numbers stay comparable with the slices before it
    autograd = lm_autograd_on_card()
    _lap("train_autograd")
    training = [train_path(*run) for run in TRAIN_RUNS]
    _lap("train_runs")
    donation = donation_check()
    remat = moe_remat_check()
    dots = dots_check()
    _lap("donation")
    train_worst = train_cpu_vs_card()
    _lap("train_cpu_vs_card")
    lm_fed = [lm_fed_path(arch, *run) for arch in LM_FED_ARCHS
              for run in LM_FED_RUNS]
    _lap("lm_fed")
    for arch in LM_FED_ARCHS:
        vmap_run, loop_run = (r for r in lm_fed if r["arch"] == arch
                              and r["scheme"] == "asfl")
        if vmap_run["cuts"] != loop_run["cuts"]:
            raise AssertionError(f"{arch}: asfl vmap / unroll chose other "
                                 f"cuts: {vmap_run['cuts']} / "
                                 f"{loop_run['cuts']}")
    print(json.dumps({"training": {"autograd": autograd, "runs": training,
                                   "donation": donation, "remat": remat,
                                   "dots": dots,
                                   "cpu_vs_card": train_worst,
                                   "federation": lm_fed}}))
    # the parallel schedule runs after every earlier phase, so their
    # numbers stay comparable with the slices before it
    parallel, parallel_trace_err, par_rows = parallel_phase(
        [highway_timing, urban_timing])
    _lap("parallel")
    print(json.dumps({"parallel": parallel,
                      "trace_cpu_vs_card": parallel_trace_err}))
    # the fault and streaming planes run after every earlier phase, so
    # their numbers stay comparable with the slices before it
    planes, planes_trace_err = plane_phase([highway_timing, urban_timing],
                                           par_rows)
    _lap("planes")
    print(json.dumps({"planes": planes,
                      "trace_cpu_vs_card": planes_trace_err}))
    # the city and slot paging run after every earlier phase, so their
    # numbers stay comparable with the slices before it
    city, paged_err, small_err = city_phase()
    _lap("city")
    print(json.dumps({"city": city, "paged_vs_unpaged": paged_err,
                      "reduced_city_cpu_vs_card": small_err}))
    city_launches = {}
    for row in city:
        if row["label"] in ("topk_paged_k1", "streaming_paged"):
            for name, n in row["launches"].items():
                if n:
                    city_launches.setdefault(name, {})[row["label"]] = n
    plane_launches = {}
    for row in planes:
        if row["label"] in ("faults_sequential", "faults_ragged_k1",
                            "streaming_k4"):
            for name, n in row["launches"].items():
                if n:
                    plane_launches.setdefault(name, {})[row["label"]] = n
    par_launches = {}
    for row in parallel:
        if row["label"] in ("highway_ragged_k1", "urban_ragged_k1"):
            par_launches.update({name: n for name, n in
                                 row["launches"].items() if n})
    main_cuts = {"sparsify_quant_pack": _main_cut(topk_cuts),
                 "unpack_dequant": _main_cut(topk_cuts),
                 "quantize_int8": _main_cut(int8_cuts),
                 "dequantize_int8": _main_cut(int8_cuts)}
    print(json.dumps(kernel_report(checks, {**topk_launches,
                                            **int8_launches}, main_cuts,
                                   mm_checks,
                                   highway["unpack_dequant_matmul"],
                                   lm_checks, serving, training,
                                   par_launches, plane_launches,
                                   city_launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
