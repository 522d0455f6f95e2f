"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``epnet_tpu_torch/csrc`` (nvcc, at
first use), then:

1. holds the FPS kernel (A) against its plain PyTorch version at every FPS
   shape of a forward, at the batch-4 RPN sa0 shape of a train step and on
   a tie-heavy 16384-point cloud (a lattice, points duplicated across the
   cluster's slice boundaries): picks must be identical; prints each
   shape's configuration (blocks a cloud, a thread-block cluster above 1;
   threads a block) and microseconds a step, times kernel and plain, and
   at RPN sa0 and sa1 times every other configuration beside the one the
   launcher takes;
2. holds the fused set-abstraction kernel (B) against its plain version
   (at most 1e-4 relative error) at the RCNN sa0/sa1 shapes on random
   tables (timed, the kernel's line) and at sa0 on real eval tables (the
   exact ball query around FPS centroids of 100 pooled RoIs: timed,
   reported beside); prints the share of distinct rows and both operation
   counts of the bound;
3. drives the main path: ``EPNet`` in TEST mode at the full width of the
   published recipe (cfgs/LI_Fusion_with_attention_use_ce_loss.yaml: 16384
   points, a 384x1280 image, 100 RoIs of 512 points), random weights from a
   seeded generator, answering three batch-1 requests on distinct
   structured scenes; checks shapes, finiteness and the kernels' launch
   counts (6 FPS, 2 fused-SA, 4 F and 2 NMS launches a forward);
4. holds the same model at tiny widths on the card (kernels) against the
   CPU (plain versions) under identical weights;
5. holds the fused set-abstraction backward kernel (C) against its plain
   version at the train shapes of RCNN sa0/sa1 (batch 4: 256 sampled RoIs)
   on random tables with tied rows, and at sa0 on real tables (the exact
   ball query, radius 0.2 and 64 samples, around FPS centroids of pooled
   RoIs): at most 1e-4 of each gradient's max, dW/db of two launches
   bitwise equal; prints the shares of distinct and live rows and how many
   max selections differ from the plain version's, and times both;
6. drives the train path: ``EPNet`` in TRAIN mode at the recipe's full
   width, random weights from a seeded generator, three train steps
   (forward, joint loss, backward, global-norm clip, AdamW under OneCycle)
   on batch-4 labelled structured scenes after a warm-up step; checks a
   finite loss and gradients, that the parameters moved, and 6 FPS, 2
   fused-SA forward, 2 fused-SA backward, 4 D, 3 E, 4 F and 8 NMS (two
   a scan) launches a step;
7. holds one tiny-width train step on the card against the CPU under
   identical weights and identical sampled RoIs;
8. holds the image tower's 3x3 conv weight-gradient kernels (D, stride 2,
   and E, stride 1: one kernel, 3xTF32 on the tensor cores) against their
   plain versions at five edge shapes and at the seven tower shapes of a
   batch-4 train step (at most 1e-4 x max|dw|, two launches bitwise
   equal), and at the tower shapes times the kernel, the plain version and
   ``torch.nn.grad.conv2d_weight`` (cuDNN, no TF32) in turns; prints each
   shape's kernel / library ratio and the design's 3xTF32 direct count at
   the TF32 peak beside the Winograd count at the f32 peak;
9. drives the train path again: a warm-up step and three batch-4
   full-width steps on scenes 0/1/2, checking 6 FPS, 2 fused-SA forward,
   2 fused-SA backward, 4 D, 3 E and 4 F launches a step, each in turn
   with a step on the same state whose tower weight gradients come from
   ``conv2d_weight`` instead (patched in here, the yardstick of its
   time); then holds one step's tower conv weight gradients against that
   route's (same weights, batch and draws; before the clip);
10. holds the image tower's stride-2 conv forward kernel (F) against its
   plain version at the four tower shapes of a batch-1 forward and of a
   batch-4 batch and at five edge shapes (at most 1e-4 x max|y|, two
   launches bitwise equal), and at the tower shapes times the kernel (3xTF32
   on the tensor cores), the plain version and ``F.conv2d`` on the padded
   NCHW input (cuDNN, no TF32) in turns; prints each shape's kernel /
   library ratio and both counts of the bound, as phase 8;
11. runs the eval CLI (``epnet_tpu_torch.tools.eval.main``, joint eval,
   batch 4, 4 loader workers) at the recipe's full width on a synthetic
   KITTI tree of 8 scenes (370x1240 images, 30000 LiDAR points each) with
   seeded random weights saved as a port checkpoint: the 8 result files,
   a finite AP dict, 6 FPS, 2 fused-SA and 4 F launches a batch, and scans
   per second over the loop, loader included; and the host time of the
   port's PNG reader on one of its images under each row filter;
12. runs the CLI at tiny widths on the card and on the CPU with the same
   checkpoint: the same detections within 1e-3 x (1 + |x|), plus one unit
   of the last printed digit, and the same recall;
13. holds the windowed fused SA kernels G (forward) and H (backward)
   against their plain versions at the block-local configuration's RCNN
   sa0 (N 512, M 128, S 64, a window of 256 rows for each of 4 tiles,
   C 128/128/128; G at T = 100, 256 and 400, the tables of a batch-1
   forward, a batch-4 train step and a batch-4 CLI batch; H at T = 256),
   on window indices
   from the port's own sorted FPS, bucket query and window starts over
   RoIs pooled from a Morton-sorted scene, and on edge cases (mostly empty
   balls, windows at 0 and N - W): at most 1e-4 x max|out| for G, 1e-4 of
   each gradient's max for H (and H's shares of distinct and live rows and
   its max selections differing from plain, as phase 5); G (kernel B's
   main kernel after the windowed dedupe) bitwise equal to B on the same
   work, the global rows starts + idx_rel; and times kernel, plain version
   and kernel B or C on that work in turns (G at T = 100 and 256, H at
   256), printing G's share of distinct rows and both operation counts of
   its bound;
14. drives the block-local configuration (the recipe with ``EXACT_QUERIES
   residual``, ``RPN.BLOCK_LOCAL`` and ``RCNN.BLOCK_LOCAL``) at full width
   in turns with the exact configuration, same weights and Morton-sorted
   scenes: three batch-1 TEST forwards each (6 FPS, 1 B, 1 G and 4 F
   launches a block-local forward), then a warm-up and three batch-4 train
   steps each (6 FPS, 1 B, 1 G, 1 C, 1 H, 4 D, 3 E and 4 F a block-local
   step; a finite loss; parameters that moved); medians and peak memory of
   both;
15. runs the eval CLI on phase 11's tree and checkpoint (saved in the exact
   configuration) with ``--set EXACT_QUERIES residual RPN.BLOCK_LOCAL True
   RCNN.BLOCK_LOCAL True``: the 8 result files, a finite AP dict, and 6
   FPS, 1 B, 1 G and 4 F launches a batch;
16. repeats phases 4 and 7 (tiny widths, card against CPU, one forward and
   one train step) in the block-local configuration at the test widths of
   ``utils/testing.BLOCK_LOCAL_TINY``;
17. holds the bf16 instances against their plain versions: B-bf16 (bf16
   ``wgmma`` on each ball's distinct rows) at the RCNN sa0/sa1 shapes (T =
   100, a batch-1 forward, timed; T = 400, the tables of a batch-4 CLI
   batch, checked only) and on phase 2's real sa0 tables in bf16 (timed,
   beside), G-bf16 (the same kernel after the windowed dedupe) on phase
   13's real windows and edge cases (T = 100), F-bf16 (bf16 ``wgmma``) at
   the eight tower shapes and five edge shapes; each within one bf16 unit
   in the last place of max|out|, two launches bitwise equal; times
   kernel, plain version and (for F) ``F.conv2d`` in bf16 on the padded
   input in turns, printing B-bf16's and G-bf16's design, shares of
   bit-identical outputs and of distinct rows beside each time and F-bf16's
   total against ``F.conv2d``'s; and checks that B-bf16 raises on a stage
   beyond its limits (C3 = 512);
18. drives the bf16 TEST forward (the recipe with ``MIXED_PRECISION``) at
   full width in turns with the f32 forward on the same weights: three
   batch-1 requests each on scenes 0/1/2 (6 FPS, 2 B-bf16 and 4 F-bf16
   launches a bf16 forward, no f32 B or F), medians and peak memory; then
   one bf16 forward of the block-local configuration (1 B-bf16, 1 G-bf16);
19. holds the tiny bf16 model on the card against the CPU, at
   ``utils/testing.MIXED_TINY`` and at the bf16 block-local
   ``MIXED_BLOCK_LOCAL_TINY``: backbone and RPN outputs, then the RCNN fed
   the same pooled input, within 4 bf16 units of (1 + max|x|); prints each
   output's share of that bound, where its worst element sits, and which
   output sets the worst;
20. runs the eval CLI on phase 11's tree and checkpoint with ``--set
   MIXED_PRECISION True``: the 8 result files, a finite AP dict, and 6
   FPS, 2 B-bf16 and 4 F-bf16 launches a batch;
21. holds the bf16 backward kernels against their plain versions: C-bf16
   (the recompute on bf16 ``wgmma`` with certified maxima and masks) at
   the train shapes of RCNN sa0/sa1 on random tables with ties (timed, the
   line's sum), on phase 5's real sa0 tables (timed, beside), on real
   tables whose table rows come in equal pairs and on a real table
   repeated T times with uneven row norms and maxima just below 0
   (checked), H-bf16 on phase
   13's real windows at T = 256 (timed beside C-bf16 on the same rows) and
   edge cases, each with its flagged shares (h2 elements and maxima summed
   exactly) and 0 max selections differing from the plain bf16
   arithmetic's; first it probes the tensor cores' accumulation that the
   certificate bounds (``sa_fused.wgmma_sum_probe`` on random and
   adversarial bf16 tiles against f64 sums, within the kernel's gamma_tc);
   D-bf16
   and E-bf16 (a TMA ring, bf16 ``wgmma`` m64n192k16 on shifted
   descriptors; the bytes their design and the first bf16 design bring
   into shared memory printed beside) at the five edge shapes and the seven tower
   shapes: every output cast to its input's
   dtype within BF16_ULPS bf16 units of max|.|, the f32 sums of dW2, dW3,
   db2, db3 within SA_RTOL and of dw within DW_RTOL; dY and dO, whose
   terms are roundings of recomputed sums, element by element within the
   bound that such a rounding's flip sets (``_sa_bwd_bf16_flip_bounds``)
   plus SA_RTOL of max|.|;
   dW/db of two launches bitwise equal; times the kernel, the plain version
   and (D, E) ``conv2d_weight`` in bf16 in turns;
22. drives the bf16 train step (the recipe with ``MIXED_PRECISION``) at
   full width in turns with the f32 step from the same initial weights:
   a warm-up and three batch-4 steps each (6 FPS, 2 B-bf16, 2 C-bf16, 4
   D-bf16, 3 E-bf16 and 4 F-bf16 launches a bf16 step, no f32 B, C, D, E
   or F), then the same in the block-local configuration (1 B-bf16, 1
   G-bf16, 1 C-bf16, 1 H-bf16 a bf16 step); finite losses and f32
   gradients, parameters that moved, medians and peak memory;
23. holds one tiny bf16 train step on the card against the CPU, at
   ``utils/testing.MIXED_TRAIN_TINY`` and ``MIXED_BLOCK_LOCAL_TRAIN_TINY``,
   within the CPU's own bf16-vs-f32 gap of the same step (the loss, the
   RPN outputs, the heads' and the RCNN's worst leaf, the backbone's norm);
24. runs the train CLI (``epnet_tpu_torch.tools.train.main``) at the
   recipe's full width (f32, batch 4, 2 loader workers) on a synthetic
   KITTI tree of 20 training and 4 val scenes (370x1240 images, 14000
   LiDAR points each): ``rcnn_online`` for 2 epochs, a ``--ckpt`` resume
   for a third with ``--train_with_eval``, ``rpn`` for 1 epoch, ``rcnn``
   warm-started from it by ``--rpn_ckpt`` for 1 epoch, and 1 epoch with
   ``--set MIXED_PRECISION True``: finite losses, each step's launches (6
   FPS, 2 B, 2 C, 4 D, 3 E and 4 F a joint step; 4 FPS, 4 D, 3 E, 4 F an
   RPN step; 6 FPS, 2 B, 2 C, 4 F a fixed-RPN step; the bf16 instances in
   bf16), ``train/*`` and ``val/*`` scalars, checkpoint epochs 0-2, the
   resume at the saved epoch + 1 and step count, and the fixed RPN moved
   by AdamW's decay alone; prints steps/s, each pass's time to its first
   batch and the wall times;
25. runs the LiDAR-only two-phase flow (``cfgs/default.yaml``, f32, batch
   4, 2 loader workers in training) on a tree of 20 training and 4 val
   scenes like phase 24's: the host library (``csrc/host_ops.cpp``) built
   and loaded; the gt database and one pass of aug scenes; ``rpn
   --gt_database`` for 100 steps (the items carry pasted boxes); the RPN
   eval with ``--save_rpn_feature`` on both splits (recall, seg IoU);
   ``rcnn_offline`` for 2 epochs on the train dumps (every step labelled
   RoIs, half or more foreground); the offline eval on the val dumps (a
   txt for every frame, AP); ``--eval_all`` over the offline checkpoints
   (each once); a ``rcnn_online`` epoch with the paste; a tiny offline step
   and eval frame, card vs CPU. Each step's, batch's and frame's launches
   (4 FPS an RPN step or eval batch; 2 FPS, 2 fused-SA forward, 2 backward
   an offline step; 6, 2, 2 a joint step; 2 FPS, 2 fused-SA an offline
   eval frame; no D, E or F); prints steps/s, each pass's time to its first
   batch, the host time of an item with and without the paste and of an
   offline sample, and every stage's wall time;
26. drives the JAX package's headline configuration
   (``config.headline_config``: the recipe in bf16 with the approximate
   queries, ``EXACT_QUERIES`` false) at full width: three batch-1 requests
   under the default ball policy ``first_nested`` in turns with the parity
   recipe on the same weights and scenes, and under ``first_multi``; 6 FPS,
   2 B-bf16 and 4 F-bf16 launches a forward. RPN sa0's nested ball, FP
   level 0's approximate ``three_nn`` and the eval pool's first k are held
   against the same port functions on the CPU on the card's inputs:
   identical except where the card's and the CPU's matmul-form distances
   (or box tests) round to opposite sides, bounded from their arithmetic
   and counted. Two batch-4 train steps in turns with the parity recipe's
   f32 step (6 FPS, 2 B-bf16, 2 C-bf16, 4 D-bf16, 3 E-bf16, 4 F-bf16), the
   wall and device busy time of a forward and a step of each, then the
   headline configuration with both ``BLOCK_LOCAL`` flags (1 B-bf16 and 1
   G-bf16 a forward, 1 C-bf16 and 1 H-bf16 a step);
27. runs the last recipe rows at full width in f32, each step with 6 FPS,
   2 B, 2 C, 4 D, 3 E and 4 F launches and each forward with 6 FPS, 2 B and
   4 F: the IoU-branch recipe's train step and joint eval step (the
   fusion); score-based proposals under ``NMS_TYPE: rotate`` (a forward, a
   train step, and the proposal layer at TRAIN and TEST budgets on a
   forward's RPN outputs, its keep list identical to the CPU's, its time
   printed); People's train step and joint eval step; three steps each of
   ``adam`` and ``sgd``, the third also from a checkpoint of the second,
   whose update must match;
28. runs data-parallel training (``epnet_tpu_torch/parallel``): two ranks
   spawned by ``parallel.mesh.run_ranks`` on this card over gloo (NCCL
   refuses two ranks on one device), each with 2 rows of a batch-4
   full-width recipe step (f32, seeded weights, phase 6's scenes), the
   RCNN's targets pinned to this process's one-process step on the same
   global batch and seed: the loss and every ``tb`` entry, ``grad_norm``,
   the BN running statistics, the summed gradients and the parameters after
   the update against that step (``DP_*`` tolerances), the ranks holding
   the same ``tb`` and parameters bitwise; then batches 0 and 1 as one
   ``Trainer`` call of ``steps_per_call`` 2 against two single steps (the
   call's ``loss`` and ``loss_mean``; the update within 1e-3 of its norm,
   or twice the gap between two runs of the single steps);
   6 A, 2 B, 2 C, 4 D, 3 E and 4 F launches a step on each rank; prints a
   rank's step time against the one-process step's, the all-reduces and
   their bytes a step, and the phase's wall time, beside the card's name
   and power limit;
29. runs the rest of the approximation family at full width, on one set
   of seeded weights: batch-1 forwards of the pin's ``--speed-mode``
   configuration (bf16, approximate queries, ``RPN.FPS_GROUPS 8``, both
   ``BLOCK_LOCAL`` flags; 6 A, 1 B-bf16, 1 G-bf16, 4 F-bf16), of the
   headline configuration under the ``nearest`` ball policy and under
   ``RPN.SAMPLING random`` (2 A: the RCNN's alone) and of the pin's
   ``fpwin`` cell (the ``RPN.FP_WINDOW`` middle mode, windows of 512), each
   with its wall and device busy time; RPN sa0's nearest-first nested ball
   held to the CPU on the card's inputs (identical except where the two
   fields round apart, then the selection of the card's own field); a
   batch-4 speed-mode train step (the headline block-local step's
   launches); and kernel A at the partitioned shapes those two gave it (8
   and 32 sub-clouds of 2048, 512, 128 and 32 points, 512, 128, 32 and 8
   picks) against its plain version, 0 picks differing, and the whole
   partitioned call against the CPU, identical; times and bound of each
   shape (the kernels line's ``fps`` entry lists them as ``partitioned``).

30. runs the JAX package's model and data switches, ported as arguments,
   and the PointNet++ segmentation harness at full width: (a) the harness
   (``tools/pointnet2_seg.run``) on a synthetic tree of 8 train and 4 val
   scenes (16384 points each sample), one epoch at batch 4 and the val
   fg-IoU, 4 A launches a batch, step times, finite loss and IoU, the
   trained net's logits on a val scene within 1e-3 (1 + max|x|) of the
   CPU's; (b) the headline configuration with ``exact_ops`` each of
   ``ball``, ``three_nn`` and ``roipool`` (the headline forward's
   launches; that family exact and the others approximate; its indices
   held to the CPU's on the card's inputs: the exact ball query identical,
   the 3-NN and the pool identical except within the rounding bounds of
   phase 26; wall and device busy time); (c) ``img_f32`` under
   ``MIXED_PRECISION``: a batch-1 forward (6 A, 2 B-bf16, 4 F in f32) and a
   batch-4 step (6 A, 2 B-bf16, 2 C-bf16, 4 D, 3 E and 4 F in f32), finite
   outputs and f32 gradients, parameters that moved, the forward's gap to
   the f32 and bf16 forwards; (d) the block-local configuration with
   ``fp_block`` False: a full-width forward (SA block-local, the four FP
   stages on the dense 3-NN; 6 A, 1 B, 1 G, 4 F) and the tiny forward card
   vs CPU, as phase 16; (e) the ``nearest`` policy with ``ball_f32`` and
   ``three_nn_f32``: RPN sa0's ball and FP level 0's 3-NN held to the
   CPU's as phase 29 holds them; (f) the eval CLI twice over the tree's 8
   train scenes with ``--img_cache`` and the loader in this process: cold,
   then warm on a copy whose PNGs hold only their header, so every image
   must come from the cache; a ``.npy`` a scene, the same detections,
   scans/s of each;
31. runs the research harnesses (``epnet_tpu_torch/tools``): the sampling
   ablation and the block-local ablation at their tiny widths for
   ``ABLATION_STEPS`` steps a cell under ``EXACT_QUERIES`` 'residual' (every
   query exact but the block-local grouping: the policy of phases 4 and
   16), each with its launches (``ABLATION_LAUNCHES``: 6 A, 2 B, 2 C, 4 D,
   2 E and 4 F a tiny step, 2 A under ``SAMPLING random``) and every cell's
   evaluation, the swaps included, again card vs CPU: every FPS call's
   picks identical, boxes, scores, RoIs and per-gt IoU within phase 4's
   bound; then ``block_local_fullscale`` ``dense`` and ``block`` at full
   width (the headline configuration, bf16, batch 2) for
   ``ABLATION_STEPS`` steps each: a finite loss, the step time, the per-gt
   IoU and the bf16 launches of phase 26's step and forward;
32. holds the port's tracer (``utils/trace.py``) on the card: on two
   full-width batch-1 eval requests and two batch-4 train steps of the
   recipe, the ``host_syncs`` it counts against the synchronizing calls
   that ``torch.cuda.set_sync_debug_mode('warn')`` reports (those made in
   ``trace.host_int`` must equal the count; every other site is printed
   with its calls a request or step), that the NMS kernel launches two a
   scan inside the ``proposal`` span and nowhere else (none in ``detect``,
   whose rotated overlap takes the plain loop), and on RCNN sa0's real train tables
   the distinct rows that kernels B and C count against ``_distinct_rows``'
   recount of the same indices (equal);
33. builds the NMS kernel (``csrc/nms.cu``) and prints ptxas's registers
   and shared memory; holds it against the plain loop (``nms_bev_plain``),
   index for index, in every call of the proposal layer at the recipe's
   TEST and TRAIN budgets (near and far range, batch-2 structured scenes
   with RPN-like outputs) and on a long walk (18,415 boxes, 1000 kept);
   times the launch alone, the wrapper (sort, launch, the kept count's
   read) and the plain loop with CUDA events at those shapes, and prints
   the bound (the kept boxes' N-wide IoU passes at the f32 peak, the
   boxes' bytes read once). Its launches on the main path are counted in
   phases 3, 6 and 32.

Launch counts are read around each main-path phase (3, 6, 9, 11, 14, 15,
18, 20, 22 and 24-31) with the counters set to 0 just before it (the NMS
kernel's in phases 3 and 6);
phase 28 counts in its ranks and in this process, and adds them up;
the kernels line sums them. The script leaves TF32 as PyTorch sets it and checks that building
the model turns it off, as the f32 recipe needs.

Every kernel's ``bound_ms`` is the least time the card could take for its
work at these shapes: the larger of its operations at the f32 peak (for
the bf16 instances, their products at the bf16 tensor-core peak, the rest
at the f32 peak: for C-bf16 and H-bf16 the recompute's products too, whose
operands are bf16-valued, while their design's count, the recompute as
FFMA at the f32 peak, is printed beside as ``design_count_ms``; for
D-bf16 and E-bf16 the direct product at the bf16 peak, since bf16
Winograd transforms are not exact; for B, G, C and H the smaller of that
count and their
design's own, which takes the products (for C and H layer 2's two
backward products) in three TF32 passes at the TF32 tensor-core peak,
beside the rest at the f32 peak, the larger of the two pipes' times:
either is exact to f32) and its bytes (each
input read once, each output written once) at the memory rate (NVIDIA
H100 SXM data sheet, below); for D, E and F the operations of the
cheapest exact algorithm counted (``_dw_bound_ops``; for F the same count,
its four stride-2 phases being the same correlations of x, now with the
weights), the smaller of that count at the f32 peak and in three TF32
passes at the TF32 tensor-core peak, either exact to f32; their design's
own count, the direct product in three TF32 passes, is printed beside
(``_conv_counts``); for B, C, G and H each ball's distinct rows
(``_sa_fwd_bound``), and for C and H the backward's products where this
run's data makes them nonzero, since the max's gradient reaches only the
rows that hold it (``_sa_bwd_bound``). ``library_ms`` is one PyTorch call that
computes the same function, where one exists (null otherwise).

Prints the card's name and power limit, a JSON line describing each kernel,
and as the last line ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero; without a CUDA device it exits non-zero at once.
"""

import collections
import concurrent.futures
import contextlib
import inspect
import io
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

FPS_SHAPES = [  # (B, N, npoint) of the six sampling SA stages of one forward
    (1, 16384, 4096), (1, 4096, 1024), (1, 1024, 256), (1, 256, 64),
    (100, 512, 128), (100, 128, 32)]
SA_SHAPES = {  # T, N, M, S, C1, C2, C3 of the RCNN tower's fused stages
    'rcnn.sa0': (100, 512, 128, 64, 128, 128, 128),
    'rcnn.sa1': (100, 128, 32, 64, 128, 128, 256)}
TRAIN_BATCH = 4
TRAIN_SEEDS = (0, 1, 2)  # scenes of the measured steps; seed 3 warms up
SA_TRAIN_SHAPES = {  # the same stages in a batch-4 train step: 4 x 64 sampled RoIs
    'rcnn.sa0': (256, 512, 128, 64, 128, 128, 128),
    'rcnn.sa1': (256, 128, 32, 64, 128, 128, 256)}
SA_RTOL = 1e-4
SA_BWD_DESIGN = ('each distinct row once (warp bitonic dedupe), blocks split by cost, f32 FFMA '
                 'recompute in cuBLAS order, sparse max gradient (dW3 as gathers), dh2 and '
                 'layer 2 over the live rows on mma.sync m16n8k8 3xTF32, dW/db on chip, '
                 'fixed-order reduction')
SA_FWD_DESIGN = ('each distinct row once (warp bitonic dedupe), blocks split by cost, tiles of '
                 '64 distinct rows of whole centroids, layers 2-3 on mma.sync m16n8k8 3xTF32 '
                 '(hi and lo rounded to nearest in integer operations) against 32-row weight '
                 'K-tiles through a double-buffered cp.async ring, segmented max in shared '
                 'memory')
FPS_DESIGN = ('points and running distances in registers, argmax over packed (distance bits, '
              '~index) keys by __reduce_max_sync; clouds above 4096 points on a thread-block '
              'cluster (distributed shared memory, one cluster barrier a step), smaller ones '
              'on one block or one warp')
DW_DESIGN = ('wgmma m64nNk8 3xTF32 (hi and lo rounded to nearest in integer operations), A (x '
             'rows) split in registers, B (dy) split into hi/lo planes (64-byte swizzle), 4-step '
             'cp.async ring, split-K in fixed order')
FWD_DESIGN = ('wgmma m64nNk8 3xTF32 (hi and lo rounded to nearest in integer operations), A (x, '
              'tap then 16 channels) split in registers, K split and transposed once a call into '
              'hi/lo planes (F, 9C) that a 4-step cp.async ring copies K-major (64-byte swizzle), '
              'split-K in fixed order')
SA_BWD_BF16_DESIGN = ('kernel C\'s dedupe, then blocks split the tiles evenly (64 distinct rows '
                      'of whole centroids, packed a chunk of 32 centroids at a time); W2, |W2| and '
                      'W3 resident in shared memory in bf16 (swizzled panels read N-major and, '
                      'transposed, K-major); two warpgroups on one tile; p2, p3 on wgmma '
                      'm64n64k16, each k16 step summed from 0, with certified h2 roundings, ReLU '
                      'masks and '
                      'maxima (|p_tc - p_plain| <= gamma (S + |b|) + 2^-22 |p|), the flagged ones '
                      'summed exactly in f32 FFMA in cuBLAS order; one sample\'s gradient a '
                      'distinct row with the multiplicity applied where samples add; dh2, dh1, dW2 '
                      '(two exact bf16 pieces of k bf16(dp2)) and, at C3 = 128, dW3 on wgmma; dp1 '
                      'rounded before the dY atomics')
DW_BF16_DESIGN = ('a block of 64 channels by 64 dy columns in all nine taps, one SM: a producer '
                  'warp fills a TMA ring (128-byte swizzle, zero fill at the pad and edges) of '
                  'stages of 4 x 16 output pixels, three consumer warpgroups (tap column e) run '
                  'wgmma m64n192k16 bf16 (A = dy M-major, B = three taps d N-major) on '
                  'descriptors shifted by a row of x for each tap d and by a pixel for each tap '
                  'e in one shared x box (stride 2: x as pixel pairs, even and odd columns), '
                  'split-K to one wave, f32 partials summed in fixed order')
FPS_TRAIN_SHAPE = (4, 16384, 4096)  # RPN sa0 in a batch-4 train step
# the image tower's convs in a batch-4 train step of the recipe: (B, H, W, C, F)
DW_SHAPES = {
    'conv3x3_dw_s2': {'blk0': (4, 384, 1280, 64, 64), 'blk1': (4, 192, 640, 128, 128),
                      'blk2': (4, 96, 320, 256, 256), 'blk3': (4, 48, 160, 512, 512)},
    'conv3x3_dw_s1': {'blk1': (4, 192, 640, 64, 128), 'blk2': (4, 96, 320, 128, 256),
                      'blk3': (4, 48, 160, 256, 512)}}
# shapes off the tower's tiling, checked but not timed: partial row and
# column tiles (C = 8, 132; F = 16, 200), odd sizes at stride 1, one pixel row
DW_EDGE_SHAPES = [(2, 16, 64, 8, 16, 2), (2, 12, 20, 132, 200, 2), (1, 7, 9, 12, 20, 1),
                  (3, 1, 33, 64, 64, 1), (1, 2, 2, 4, 4, 2)]
DW_RTOL = 1e-4
# the stride-2 tower convs in a batch-1 forward and a batch-4 batch: (B, H, W, C, F)
FWD_SHAPES = {f'b{B} {blk}': (B, H, W, C, C) for B in (1, 4)
              for blk, (H, W, C) in (('blk0', (384, 1280, 64)), ('blk1', (192, 640, 128)),
                                     ('blk2', (96, 320, 256)), ('blk3', (48, 160, 512)))}
# off the tower's tiling: partial tiles (C = 8, 132; F = 16, 200), a 2x2
# image (one output pixel, every tap but one in the pad), H != W
FWD_EDGE_SHAPES = [(2, 16, 64, 8, 16), (2, 12, 20, 132, 200), (1, 2, 2, 4, 4),
                   (3, 10, 6, 12, 20), (1, 6, 10, 64, 64)]
FWD_RTOL = 1e-4
RECIPE = 'cfgs/LI_Fusion_with_attention_use_ce_loss.yaml'
CLI_SCENES = 8
CLI_BATCH = 4
OUT = 'output/chip_smoke'  # scratch under the checkout (ignored by git)
# conv2d_weight as a yardstick: it must compute the same function, but cuDNN
# may pick reduced-multiplication algorithms whose transforms round more
LIBRARY_RTOL = 1e-3
# the tower's weight gradients of one whole train step, kernels vs
# conv2d_weight: beyond the kernels' own 1e-6, the backward above the tower
# is not bitwise reproducible (atomic adds in the point branch's gathers,
# amplified by batch-statistics BatchNorm); two conv2d_weight runs are
# printed beside it as the floor
ROUTE_RTOL = 1e-3
F32_PEAK = 67e12     # FLOP/s, f32 outside the tensor cores
BF16_PEAK = 989e12   # FLOP/s, bf16 products on the tensor cores (dense)
TF32_PEAK = 495e12   # FLOP/s, TF32 products on the tensor cores (dense)
MEMORY_RATE = 3.35e12  # bytes/s of HBM
# the bf16 instances against their plain versions: both sum in f32, in
# different orders, then round to bf16 once, so they may differ by one bf16
# unit in the last place at the largest output
BF16_ULPS = 1.0


def _bound(ops, nbytes, products=0.0):
    """(ms, ms) the operations and the bytes need at the card's peaks:
    ``ops`` at the f32 peak, ``products`` (bf16 multiply-adds' operations)
    at the bf16 tensor-core peak, on their own units, so the larger of the
    two."""
    return (max(ops / F32_PEAK, products / BF16_PEAK) * 1e3,
            nbytes / MEMORY_RATE * 1e3)


def _bf16_ulp(v):
    """One bf16 unit in the last place at magnitude ``v`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def _dw_bf16_smem_bytes(B, H, W, C, Fo, stride):
    """Bytes that D-bf16/E-bf16 bring into shared memory for one conv
    (what each SM takes in, summed over blocks), and the first bf16
    design's (128 x TN im2col tiles by cp.async): (this, first).
    This design: a stage of 4 x 16 output pixels loads, for each tile, the
    x rows its three taps d read (6 at stride 1, 9 at stride 2) in one box
    of 24 columns (stride 1) or in boxes of 17 even and 16 odd pixel pairs
    (stride 2), and 4 rows of 16 dy columns, 64 channels each; the first
    read 9C x values a pixel for every column tile and F dy values for
    every row tile of 128 (x rows and dy columns outside the image or the
    tile were zero-filled, not read). x and dy are bf16."""
    from epnet_tpu_torch.ops import conv2d
    tiles, _, stages = conv2d.dw_bf16_grid((B, H, W, C), Fo, stride, 1)
    row = 64 * 2  # a pixel's 64 bf16 values
    x_box = 6 * 24 * row if stride == 1 else 9 * (17 + 16) * row
    this = tiles * stages * (x_box + 4 * 16 * row)
    pixels = B * (H // stride) * (W // stride)
    tn = 64 if Fo <= 64 else 128
    first = pixels * 2 * (-(-Fo // tn) * 9 * C + -(-9 * C // 128) * Fo)
    return this, first


def _dw_bound_ops(C, Fo, pixels, stride):
    """Operations of a 3x3 weight gradient over ``pixels`` dy pixels by the
    cheapest exact algorithm counted: Winograd with 4x4 tiles of dy (Lavin
    and Gray, 2016), the largest tile f32 libraries use. Stride 1 is
    F(3x3, 4x4): 36 products per tile, 2.25 a pixel against the direct 9.
    At stride 2 the four phases of x take 2x2, 2x1, 1x2 and 1x1 taps: 25/16
    + 5/4 + 5/4 + 1 = 5.0625 products a pixel. Each product is a multiply-
    add for every (c, f) pair. The transforms, O((C + F) * pixels), are
    left out, so this stays a lower bound."""
    per_pixel = 36 / 16 if stride == 1 else 25 / 16 + 2 * 5 / 4 + 1
    return 2.0 * per_pixel * C * Fo * pixels


def _conv_counts(C, Fo, pixels, stride, nbytes):
    """The bound's parts for a 3x3 conv, or its weight gradient, over
    ``pixels`` output (dy) pixels, in ms: ``f32_count_ms``, the cheapest
    exact algorithm's operations (``_dw_bound_ops``) at the f32 peak;
    ``tf32_count_ms``, the same operations in three TF32 passes at the TF32
    tensor-core peak; ``design_count_ms``, kernels D, E and F's own design,
    the direct product in three TF32 passes there; ``bytes_ms``, ``nbytes``
    at the memory rate. Each count is exact to f32, so ``bound_ms`` takes
    the smaller of the first two (the third is above the second), or the
    bytes where they take longer."""
    ops = _dw_bound_ops(C, Fo, pixels, stride)
    counts = {'f32_count_ms': ops / F32_PEAK * 1e3,
              'tf32_count_ms': 3 * ops / TF32_PEAK * 1e3,
              'design_count_ms': 3 * 2.0 * 9 * C * Fo * pixels / TF32_PEAK * 1e3,
              'bytes_ms': _bound(0, nbytes)[1]}
    return {'bound_ms': max(min(counts['f32_count_ms'], counts['tf32_count_ms']),
                            counts['bytes_ms']), **counts}


def _conv_row_line(row, library):
    """Phase 8's and 10's line for one tower shape's ``row``."""
    return (f'  kernel {row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, {library} '
            f'{row["library_ms"]:.4f} ms (kernel / library {row["ms"] / row["library_ms"]:.3f}), '
            f'bound {row["bound_ms"]:.4f} ms (operations: Winograd {row["f32_count_ms"]:.4f} at '
            f'the f32 peak, {row["tf32_count_ms"]:.4f} in three TF32 passes; this design\'s '
            f'count, the direct product in three TF32 passes, {row["design_count_ms"]:.4f}; bytes '
            f'{row["bytes_ms"]:.4f})')


def _distinct_rows(idx):
    """idx (T, M, S) sorted along S, and a mask of each ball's first
    occurrence of a row: a ball repeats rows (short balls are padded with a
    hit), and a repeated row gives the same values, so the function needs
    each (t, m, row) once."""
    import torch

    idx = idx.sort(dim=-1).values
    first = torch.ones_like(idx, dtype=torch.bool)
    first[..., 1:] = idx[..., 1:] != idx[..., :-1]
    return idx, first


def _sa_fwd_bound(idx, N, C1, C2, C3, bf16=False, tf32=False):
    """(ms, ms) of the fused-SA forward over the table rows ``idx``: the
    two products, layer 1's subtract and ReLU, the biases and ReLUs of
    layers 2 and 3 and the max, over each ball's distinct rows. ``bf16``:
    the products at the bf16 tensor-core peak, the elementwise work at the
    f32 peak, and y, o, the weights and the output in 2 bytes (the biases
    in 4). ``tf32``: kernel B's own count, the products in three TF32
    passes at the TF32 tensor-core peak beside the elementwise work at the
    f32 peak (the larger of the two pipes), f32 bytes."""
    T, M, S = idx.shape
    rows = int(_distinct_rows(idx)[1].sum())
    products = 2.0 * rows * (C1 * C2 + C2 * C3)
    elementwise = rows * (2 * C1 + 2 * C2 + 3 * C3)
    if bf16:
        return _bound(elementwise, 2 * (T * N * C1 + T * M * C1 + C1 * C2 + C2 * C3 + T * M * C3)
                      + 4 * (C2 + C3) + 8 * T * M * S, products)
    weights = C1 * C2 + C2 + C2 * C3 + C3
    nbytes = 4 * (T * N * C1 + T * M * C1 + weights + T * M * C3) + 8 * T * M * S
    if tf32:
        return (max(_bound(elementwise, 0)[0], 3 * products / TF32_PEAK * 1e3),
                _bound(0, nbytes)[1])
    return _bound(products + elementwise, nbytes)


def _sa_bwd_work(y, o, idx, w2, b2, w3, b3, gout, bf16=False):
    """What the fused-SA backward needs on these inputs, from the plain
    version's own arithmetic, in chunks of tables: the nonzeros of dp3
    (one per (centroid, channel) where the max is on a row with p3 > 0,
    more where distinct rows tie), the live rows (distinct rows holding at
    least one of them), the distinct rows, and the plain version's max
    selections (T, M, C3) int32 as kernels C and H report theirs: the first
    tied table row * 128 + the tied samples, -1 where no row has p3 > 0.
    ``bf16``: the plain bf16 arithmetic (f32 inputs holding bf16 values; h1
    and h2 rounded to bf16, as ``_sa_bwd_bf16_flip_bounds`` recomputes
    them), C-bf16's and H-bf16's."""
    import torch

    def r(t):
        return t.to(torch.bfloat16).float() if bf16 else t
    T, N, C1 = y.shape
    _, M, S = idx.shape
    rows, first = _distinct_rows(idx)
    nnz3 = rows2 = 0
    sel = []
    for t in range(0, T, 32):  # ~0.5 GB of temporaries a chunk
        sl = slice(t, t + 32)
        ti = rows[sl].reshape(-1, M * S, 1)
        g = torch.gather(y[sl], 1, ti.expand(-1, M * S, C1)).reshape(-1, M, S, C1)
        h2 = r(torch.relu(r(torch.relu(g - o[sl, :, None, :])) @ w2 + b2))
        p3 = h2 @ w3 + b3
        h3 = torch.relu(p3)
        mx = h3.amax(dim=2, keepdim=True)
        tie = (h3 == mx) & (mx > 0)
        live = tie & (gout[sl, :, None, :] != 0) & first[sl, :, :, None]
        nnz3 += int(live.sum())
        rows2 += int(live.any(dim=-1).sum())
        lead = torch.where(tie, rows[sl, :, :, None], N).amin(dim=2)
        sel.append(torch.where(mx[:, :, 0] > 0, lead * 128 + tie.sum(dim=2), -1).int())
    return nnz3, rows2, int(first.sum()), torch.cat(sel)


def _sa_bwd_bound(y, o, idx, w2, b2, w3, b3, gout, work=None):
    """(ms, ms, ms) of the fused-SA backward on these inputs: operations by
    the f32 count, operations by kernel C/H's own design, and bytes. The
    recompute over each ball's distinct rows (the forward's count, to find
    the max), then the max's gradient, which reaches only the rows that
    hold it: layer 3's two products take 2 * C2 operations for each nonzero
    of dp3; layer 2's two take 2 * C1 * C2 a row for the live rows. Both
    counts come from this data; ReLU zeros are not skipped, as in the
    forward's count. Elementwise passes on the nonzeros: tie split, mask
    and db3 on dp3; mask and db2 on dp2; mask, the dy and do adds on dp1.
    The f32 count takes every operation at the f32 peak. The design's
    (kernels C and H) takes layer 2's two products in three TF32 passes at
    the TF32 tensor-core peak, and the rest (the recompute, the elementwise
    work and layer 3's gathers, dW3 and dh2) at the f32 peak; dh2 as the
    dense product dp3 W3^T over the distinct rows in three TF32 passes
    instead, where that is the cheaper (the kernel runs it so). The two
    pipes run side by side, so the design's count is the larger of its two
    parts, as in ``_bound``. Either algorithm is exact to f32, so the bound
    is the smaller."""
    T, N, C1 = y.shape
    _, M, S = idx.shape
    C2, C3 = w2.shape[-1], w3.shape[-1]
    nnz3, rows2, distinct, _ = work or _sa_bwd_work(y, o, idx, w2, b2, w3, b3, gout)
    fwd_ms, _ = _sa_fwd_bound(idx, N, C1, C2, C3)
    layer2 = 4.0 * rows2 * C1 * C2
    elementwise = 3.0 * nnz3 + rows2 * (2 * C2 + 3 * C1)
    weights = C1 * C2 + C2 + C2 * C3 + C3
    nbytes = (4 * (T * N * C1 + T * M * C1 + weights + T * M * C3)   # inputs
              + 8 * T * M * S + 4 * (T * N * C1 + T * M * C1 + weights))  # idx, outputs
    f32_ms = fwd_ms + _bound(layer2 + 4.0 * nnz3 * C2 + elementwise, 0)[0]
    ffma_ms = fwd_ms + _bound(2.0 * nnz3 * C2 + elementwise, 0)[0]
    tensor_ms = 3 * layer2 / TF32_PEAK * 1e3
    dh2_gather_ms = _bound(2.0 * nnz3 * C2, 0)[0]
    dh2_dense_ms = 3 * 2.0 * distinct * C2 * C3 / TF32_PEAK * 1e3
    if dh2_gather_ms <= dh2_dense_ms:
        ffma_ms += dh2_gather_ms
    else:
        tensor_ms += dh2_dense_ms
    design_ms = max(ffma_ms, tensor_ms)
    return f32_ms, design_ms, _bound(0, nbytes)[1]


def _library_dw_call(x, dy, stride):
    """A call of ``torch.nn.grad.conv2d_weight`` (cuDNN) that gives the
    (3, 3, C, F) weight gradient, with its input made beforehand: at
    stride 1 SAME is conv2d_weight's own pad of 1; at stride 2 it is (0, 1),
    which conv2d_weight cannot express, so x is padded here, outside the
    call."""
    import torch
    import torch.nn.functional as F
    from epnet_tpu_torch.ops import conv2d

    x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    if stride == 1:
        xp, pad = x_nchw, 1
    else:
        xp, pad = F.pad(x_nchw, conv2d._nchw_pads(x_nchw, 3, stride)), 0
    size = (dy.shape[-1], x.shape[-1], 3, 3)
    return lambda: torch.nn.grad.conv2d_weight(xp, size, dy_nchw, stride=stride,
                                               padding=pad).permute(2, 3, 1, 0)


def _library_dw(x, dy, stride):
    return _library_dw_call(x, dy, stride)()


@contextlib.contextmanager
def library_dw_route():
    """The tower's weight gradients by ``_library_dw`` instead of kernels D
    and E for the block: the yardstick, patched in here only."""
    from unittest import mock
    from epnet_tpu_torch.ops import conv2d

    with mock.patch.object(conv2d, 'dw3x3_s2', lambda x, dy: _library_dw(x, dy, 2)), \
            mock.patch.object(conv2d, 'dw3x3_s1', lambda x, dy: _library_dw(x, dy, 1)):
        yield


def _require_f32(where):
    import torch
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    if tf32 != (False, False):
        raise AssertionError(f'{where}: TF32 on (cudnn, matmul) = {tf32}; the recipe is f32')


def _bound_keys(op_ms, byte_ms):
    """``bound_ms`` summed over shapes (each shape's larger term) and which
    term sets most of it."""
    return {'bound_ms': sum(max(o, b) for o, b in zip(op_ms, byte_ms)),
            'bound_by': 'operations' if sum(op_ms) >= sum(byte_ms) else 'bytes'}


def _time_ms(fn, reps):
    import torch
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _tie_cloud():
    """16384 points on a 16 x 32 x 32 integer lattice (many exactly equal
    distances), 8 points at the end of every 1024-point slice replaced by
    copies of the first 8 of the next slice (equal points on both sides of
    a cluster's slice boundaries)."""
    import numpy as np

    g = np.stack(np.meshgrid(np.arange(16), np.arange(32), np.arange(32), indexing='ij'),
                 -1).reshape(-1, 3).astype(np.float32)
    for r in range(1, 16):
        g[r * 1024 - 8:r * 1024] = g[r * 1024:r * 1024 + 8]
    return g[None]


def fps_cases(dev):
    """Phase 1's inputs, [((B, N, npoint), kind, xyz)]: the six shapes of a
    forward (a structured scene's first N points; RoI-local clouds a few
    metres around the box center), the batch-4 RPN sa0 shape of a train step
    (four scenes) and the tie-heavy lattice cloud."""
    import numpy as np
    import torch
    from epnet_tpu_torch.utils.testing import structured_scene

    scene = torch.from_numpy(structured_scene(np.random.RandomState(0), 16384)[0]).to(dev)
    rng = np.random.RandomState(1)
    out = []
    for B, N, npoint in FPS_SHAPES:
        if B == 1:
            xyz = scene[None, :N].contiguous()
        else:
            xyz = torch.from_numpy((rng.randn(B, N, 3) * 1.5).astype(np.float32)).to(dev)
        out.append(((B, N, npoint), 'forward', xyz))
    B, N, _ = FPS_TRAIN_SHAPE
    xyz = np.stack([structured_scene(np.random.RandomState(s), N)[0] for s in range(B)])
    out.append((FPS_TRAIN_SHAPE, 'train step', torch.from_numpy(xyz).to(dev)))
    out.append(((1, 16384, 4096), 'ties', torch.from_numpy(_tie_cloud()).to(dev)))
    return out


def phase_fps(dev):
    import torch
    from epnet_tpu_torch.ops import fps

    rows, max_err, ms, plain_ms, op_ms, byte_ms = [], 0, 0.0, 0.0, [], []
    for (B, N, npoint), kind, xyz in fps_cases(dev):
        # npoint - 1 steps over N points: 3 sub, 3 mul, 2 add, min, argmax compare
        o, m = _bound(10.0 * B * N * (npoint - 1), 4 * B * N * 3 + 8 * B * npoint)
        got = fps.furthest_point_sample_kernel(xyz, npoint)
        want = fps.furthest_point_sample_plain(xyz, npoint)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if err:
            raise AssertionError(f'fps kernel picks differ from plain at {(B, N, npoint)} '
                                 f'({kind}): {int((got != want).sum())} of {got.numel()}')
        cs, threads = fps.kernel_config(N)
        k = _time_ms(lambda: fps.furthest_point_sample_kernel(xyz, npoint), 10 if N > 1024 else 200)
        p = _time_ms(lambda: fps.furthest_point_sample_plain(xyz, npoint), 2)
        step_us = k / (npoint - 1) * 1e3
        row = {'shape': [B, N, 3], 'npoint': npoint, 'kind': kind, 'cluster': cs,
               'threads': threads, 'ms': k, 'us_per_step': step_us, 'plain_ms': p,
               'bound_ms': max(o, m)}
        print(f'fps {(B, N, 3)} -> {npoint} ({kind}): picks identical; {cs} block(s) a cloud'
              f'{" (a cluster)" if cs > 1 else ""} of {threads} threads; kernel {k:.4f} ms, '
              f'{step_us:.3f} us a step; plain {p:.4f} ms, bound {max(o, m):.4f} ms',
              flush=True)
        rows.append(row)
        max_err = max(max_err, err)
        if kind == 'forward':  # the line's sums: the six launches of a forward
            op_ms.append(o)
            byte_ms.append(m)
            ms, plain_ms = ms + k, plain_ms + p
    # no single PyTorch call samples furthest points
    return {'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
            **_bound_keys(op_ms, byte_ms), 'library_ms': None, 'per_shape': rows}


def sa_cases(dev, train=False):
    """Phase 2's inputs (``train``: phase 5's), [(name, shape, kind, args)]:
    random tables at SA_SHAPES (SA_TRAIN_SHAPES), short balls padded with
    their first hit, and RCNN sa0 on real tables (``_real_sa0_idx``); args
    y, o, idx, w2, b2, w3, b3 (and gout)."""
    import numpy as np
    import torch

    shapes = SA_TRAIN_SHAPES if train else SA_SHAPES
    rng = np.random.RandomState(5 if train else 2)
    cases = [(name, shape, None) for name, shape in shapes.items()]
    cases.append(('rcnn.sa0 real', shapes['rcnn.sa0'], 'real'))
    out = []
    for name, (T, N, M, S, C1, C2, C3), kind in cases:
        def f(*shape, scale=1.0):
            return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)
        if kind == 'real':
            idx = _real_sa0_idx(T, 21 if train else 22, dev)
        else:
            idx = torch.from_numpy(rng.randint(0, N, (T, M, S))).to(dev)
            idx[:, :M // 4, S // 2:] = idx[:, :M // 4, :1]  # short balls padded with the first hit
        args = (f(T, N, C1), f(T, M, C1, scale=0.1), idx, f(C1, C2, scale=C1 ** -0.5),
                f(C2, scale=0.01), f(C2, C3, scale=C2 ** -0.5), f(C3, scale=0.01))
        if train:
            args += (f(T, M, C3),)
        out.append((name, (T, N, M, S, C1, C2, C3), kind, args))
    return out


def phase_sa(dev):
    import torch
    from epnet_tpu_torch.ops import sa_fused

    rows, max_err, ms, plain_ms, op_ms, byte_ms = [], 0.0, 0.0, 0.0, [], []
    for name, (T, N, M, S, C1, C2, C3), kind, args in sa_cases(dev):
        idx = args[2]
        f32_ms, m = _sa_fwd_bound(idx, N, C1, C2, C3)
        design_ms, _ = _sa_fwd_bound(idx, N, C1, C2, C3, tf32=True)
        o = min(f32_ms, design_ms)
        distinct = float(_distinct_rows(idx)[1].float().mean())
        got = sa_fused.fused_point_mlp_max_kernel(*args)
        want = sa_fused.fused_point_mlp_max_plain(*args)
        torch.cuda.synchronize()
        abs_err = float((got - want).abs().max())
        rel_err = abs_err / float(want.abs().max())
        print(f'sa_fused {name} {(T, N, M, S, C1, C2, C3)}: max abs err {abs_err:.3e}, '
              f'max rel err {rel_err:.3e}; distinct rows {distinct:.4f} of the samples',
              flush=True)
        if not rel_err <= SA_RTOL:
            raise AssertionError(f'fused SA kernel off by {rel_err:.3e} relative at {name}')
        k = _time_ms(lambda: sa_fused.fused_point_mlp_max_kernel(*args), 20)
        p = _time_ms(lambda: sa_fused.fused_point_mlp_max_plain(*args), 20)
        rows.append({'stage': name, 'shape': [T, N, M, S, C1, C2, C3], 'ms': k,
                     'plain_ms': p, 'bound_ms': max(o, m), 'f32_count_ms': f32_ms,
                     'design_count_ms': design_ms, 'distinct_rows': distinct,
                     'max_rel_err': rel_err})
        print(f'  kernel {k:.4f} ms, plain {p:.4f} ms, bound {max(o, m):.4f} ms (f32 count '
              f'{f32_ms:.4f}, this design\'s count {design_ms:.4f}, bytes {m:.4f})', flush=True)
        if kind == 'real':
            continue  # beside the line's sum, which stays the random tables'
        max_err = max(max_err, abs_err)
        op_ms.append(o)
        byte_ms.append(m)
        ms, plain_ms = ms + k, plain_ms + p
    # no single PyTorch call fuses the gather, the three layers and the max
    return {'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
            **_bound_keys(op_ms, byte_ms), 'library_ms': None, 'per_shape': rows}


def _real_sa0_idx(T, seed, dev):
    """RCNN sa0's table rows in a train step: the port's exact ball query
    (radius 0.2, 64 samples: the recipe's RCNN.SA_CONFIG) around 128 FPS
    centroids of T pooled RoIs."""
    import torch
    from epnet_tpu_torch.ops import fps, pointops

    xyz = _pooled_rois(T, seed, dev)
    M, S = SA_TRAIN_SHAPES['rcnn.sa0'][2:4]
    centers = torch.gather(xyz, 1, fps.furthest_point_sample_kernel(xyz, M)[..., None]
                           .expand(T, M, 3))
    return pointops.ball_query(0.2, S, xyz, centers)


def _check_bwd(name, got, want, sel, work, shape):
    """Each gradient within SA_RTOL of the plain one's max; prints the
    errors, the shares of distinct and live rows and the max selections
    that differ from the plain version's; returns (max abs err, max rel
    err)."""
    T, N, M, S = shape[:4]
    names = ('dy', 'do', 'dw2', 'db2', 'dw3', 'db3')
    errs, max_err = {}, 0.0
    for k, x, z in zip(names, got, want):
        abs_err = float((x - z).abs().max())
        errs[k] = abs_err / float(z.abs().max())
        max_err = max(max_err, abs_err)
    _, rows2, distinct, want_sel = work
    differ = int((sel != want_sel).sum())
    print(f'{name} {tuple(shape)}: max rel err '
          + ', '.join(f'{k} {v:.3e}' for k, v in errs.items())
          + f'; distinct rows {distinct / (T * M * S):.4f} of the samples, live rows '
          f'{rows2 / distinct:.4f} of the distinct; max selections differing from plain: '
          f'{differ} of {sel.numel()}', flush=True)
    bad = {k: v for k, v in errs.items() if not v <= SA_RTOL}
    if bad:
        raise AssertionError(f'fused SA backward kernel off at {name}: {bad}')
    return max_err, max(errs.values()), differ


def phase_sa_bwd(dev):
    """The fused-SA backward kernel against its plain version at the train
    shapes: on random tables with tied rows (sa0, sa1: timed, their sum is
    the kernel's line) and on RCNN sa0's real tables (the exact ball query
    over pooled RoIs: timed, reported beside); each of the six outputs within
    SA_RTOL of the plain one's max, dW/db of two launches bitwise equal;
    prints the shares of distinct and live rows, the max selections that
    differ from the plain version's, and both operation counts of the bound
    (``_sa_bwd_bound``)."""
    import torch
    from epnet_tpu_torch.ops import sa_fused

    rows, max_err, ms, plain_ms, op_ms, byte_ms = [], 0.0, 0.0, 0.0, [], []
    for name, (T, N, M, S, C1, C2, C3), kind, args in sa_cases(dev, train=True):
        work = _sa_bwd_work(*args)
        f32_ms, design_ms, b_ms = _sa_bwd_bound(*args, work=work)
        o_ms = min(f32_ms, design_ms)
        *got, sel = sa_fused.fused_point_mlp_max_bwd_kernel(*args, selections=True)
        again = sa_fused.fused_point_mlp_max_bwd_kernel(*args)
        want = sa_fused.fused_point_mlp_max_bwd_plain(*args)
        torch.cuda.synchronize()
        abs_err, rel_err, differ = _check_bwd(f'sa_fused_bwd {name}', got, want, sel, work,
                                              (T, N, M, S, C1, C2, C3))
        if not all(torch.equal(x, z) for x, z in zip(got[2:], again[2:])):
            raise AssertionError(f'sa_fused_bwd {name}: dW/db differ between two launches')
        del got, want, again
        k = _time_ms(lambda: sa_fused.fused_point_mlp_max_bwd_kernel(*args), 5)
        p = _time_ms(lambda: sa_fused.fused_point_mlp_max_bwd_plain(*args), 5)
        rows.append({'stage': name, 'shape': [T, N, M, S, C1, C2, C3], 'ms': k,
                     'plain_ms': p, 'bound_ms': max(o_ms, b_ms), 'f32_count_ms': f32_ms,
                     'design_count_ms': design_ms, 'max_rel_err': rel_err,
                     'selections_differing': differ})
        print(f'  kernel {k:.4f} ms, plain {p:.4f} ms, bound {max(o_ms, b_ms):.4f} ms (f32 '
              f'count {f32_ms:.4f}, this design\'s count {design_ms:.4f}, bytes {b_ms:.4f})',
              flush=True)
        if kind == 'real':
            continue  # beside the line's sum, which stays the random tables'
        max_err = max(max_err, abs_err)
        op_ms.append(o_ms)
        byte_ms.append(b_ms)
        ms, plain_ms = ms + k, plain_ms + p
    # no single PyTorch call gives these six gradients
    return {'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
            **_bound_keys(op_ms, byte_ms), 'library_ms': None, 'per_shape': rows}


def _pooled_rois(T, seed, dev):
    """RCNN sa0's tables as the block-local configuration builds them: T
    RoIs (the scene's cars and car-sized boxes around random points) pooled
    from a Morton-sorted structured scene by the exact roipool (512 points
    each, in scan order), in each RoI's canonical frame."""
    import numpy as np
    import torch
    from epnet_tpu_torch.ops.boxes import rotate_points_along_y
    from epnet_tpu_torch.ops.morton import morton_argsort_np
    from epnet_tpu_torch.ops.roipool3d import roipool3d
    from epnet_tpu_torch.utils.testing import structured_scene

    rng = np.random.RandomState(seed)
    pts, _, gt = structured_scene(rng, 16384)
    pts = pts[morton_argsort_np(pts)]
    boxes = np.zeros((T, 7), np.float32)
    boxes[:len(gt)] = gt
    centers = pts[rng.choice(len(pts), T - len(gt), replace=False)]
    boxes[len(gt):, :3] = centers + rng.randn(T - len(gt), 3).astype(np.float32) * 0.3
    boxes[len(gt):, 3:6] = (1.55, 1.6, 3.9)
    boxes[len(gt):, 6] = rng.uniform(-np.pi, np.pi, T - len(gt))
    xyz = torch.from_numpy(pts).to(dev)[None]
    rois = torch.from_numpy(boxes).to(dev)[None]
    pxyz, _, _, _ = roipool3d(xyz, xyz[..., :1], rois, 0.2, sampled_pt_num=512)
    local = rotate_points_along_y(pxyz - rois[..., None, 0:3], rois[..., 6, None])
    return local[0].contiguous()


def _sa_win_geometry():
    """(window, tiles a table, radius) of the block-local configuration's
    windowed RCNN sa0."""
    from epnet_tpu_torch.config import block_local_config, parity_config

    rc = block_local_config(parity_config()).RCNN
    return rc.BLOCK_WINDOW, rc.SA_CONFIG.NPOINTS[0] // rc.BLOCK_C, rc.SA_CONFIG.RADIUS[0]


def _window_inputs(T, seed, dev, edge=False):
    """idx_rel and starts of RCNN sa0 over pooled RoIs, from the port's own
    sorted FPS, bucket query, window starts and window-relative indices;
    ``edge``: a radius that leaves most balls empty and windows forced to
    0 and N - W."""
    import torch
    from epnet_tpu_torch.ops import block_local, fps

    xyz = _pooled_rois(T, seed, dev)
    N, (W, NB, radius) = xyz.shape[1], _sa_win_geometry()
    M, S = SA_SHAPES['rcnn.sa0'][2:4]
    picks = fps.furthest_point_sample_kernel(xyz, M).sort(dim=-1).values
    new_xyz = torch.gather(xyz, 1, picks[..., None].expand(T, M, 3))
    gidx = block_local.bucket_ball_query(0.01 if edge else radius, S, xyz, new_xyz)
    starts = block_local.window_starts(picks, N, W, M // NB)
    if edge:
        starts[:, 0], starts[:, -1] = 0, N - W
    return block_local.to_window_relative(gidx, starts, W), starts


def phase_sa_win(dev):
    """Kernels G and H against their plain versions at the block-local
    configuration's RCNN sa0 (G at T = 100, 256 and 400: a batch-1 forward,
    a batch-4 train step and a batch-4 CLI batch; H at T = 256) on real
    window indices and on edge cases, and G bitwise against B on the same
    work, the global rows starts + idx_rel (G is B's kernel after the
    windowed dedupe); then G at T = 100 and 256 and H at T = 256: kernel,
    plain and B (or C) on the same work, timed in turns. G's line is T =
    100's (the forward's), with T = 256's beside it."""
    import numpy as np
    import torch
    from epnet_tpu_torch.ops import sa_fused

    rng = np.random.RandomState(13)
    W, tiles, _ = _sa_win_geometry()
    names = ('dy', 'do', 'dw2', 'db2', 'dw3', 'db3')
    res = {}
    for kind, T in (('fwd', 100), ('fwd', 256), ('fwd', 400), ('bwd', 256)):
        _, N, M, S, C1, C2, C3 = SA_SHAPES['rcnn.sa0']
        def f(*shape, scale=1.0):
            return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)
        y, o = f(T, N, C1), f(T, M, C1, scale=0.1)
        w = (f(C1, C2, scale=C1 ** -0.5), f(C2, scale=0.01), f(C2, C3, scale=C2 ** -0.5),
             f(C3, scale=0.01))
        gout = f(T, M, C3)
        errs, real = {}, None
        for edge in (False, True):
            idx_rel, starts = _window_inputs(T, T + edge, dev, edge)
            args = (y, o, idx_rel, starts, *w, W)
            real = real or (args, starts)
            if kind == 'fwd':
                got = [sa_fused.fused_point_mlp_max_win_kernel(*args)]
                want = [sa_fused.fused_point_mlp_max_win_plain(*args)]
                same = sa_fused.fused_point_mlp_max_kernel(
                    y, o, sa_fused.window_rows(idx_rel, starts), *w)
                equal = float((got[0] == same).float().mean())
                print(f'G T={T} {"edge cases" if edge else "real windows"}: bitwise equal to B '
                      f'on the global rows: {torch.equal(got[0], same)} ({equal:.6f} of the '
                      f'outputs)', flush=True)
                if not torch.equal(got[0], same):
                    raise AssertionError(f'kernel G differs from B on the same rows at T={T}')
                del same
            else:
                *got, sel = sa_fused.fused_point_mlp_max_win_bwd_kernel(*args, gout,
                                                                         selections=True)
                want = sa_fused.fused_point_mlp_max_win_bwd_plain(*args, gout)
                work = _sa_bwd_work(y, o, sa_fused.window_rows(idx_rel, starts), *w, gout)
                _, rows2, distinct, want_sel = work
                differ = int((sel != want_sel).sum())
                print(f'H T={T} {"edge cases" if edge else "real windows"}: distinct rows '
                      f'{distinct / (T * M * S):.4f} of the samples, live rows '
                      f'{rows2 / distinct:.4f} of the distinct; max selections differing '
                      f'from plain: {differ} of {sel.numel()}', flush=True)
                if not edge:
                    real_work, real_differ = work, differ
            torch.cuda.synchronize()
            for k, x, z in zip(('out',) if kind == 'fwd' else names, got, want):
                e = float((x - z).abs().max()), float(z.abs().max())
                errs[k] = max(errs.get(k, (0.0, 1.0)), e, key=lambda v: v[0] / v[1])
            del got, want
        rel = {k: a / b for k, (a, b) in errs.items()}
        name = 'G' if kind == 'fwd' else 'H'
        print(f'{name} T={T}: real windows and edge cases (empty balls, windows at 0 and N - W): '
              f'max rel err ' + ', '.join(f'{k} {v:.3e}' for k, v in rel.items()), flush=True)
        bad = {k: v for k, v in rel.items() if not v <= SA_RTOL}
        if bad:
            raise AssertionError(f'kernel {name} off its plain version at T={T}: {bad}')
        if kind == 'fwd' and T == 400:
            continue  # checked at the CLI batch's shape; timed at the forward's and step's
        args, starts = real  # timed on the real windows
        rows = sa_fused.window_rows(args[2], starts)
        if kind == 'fwd':
            f32_ms, b_ms = _sa_fwd_bound(rows, N, C1, C2, C3)
            design_ms, _ = _sa_fwd_bound(rows, N, C1, C2, C3, tf32=True)
            o_ms = min(f32_ms, design_ms)
            distinct = float(_distinct_rows(rows)[1].float().mean())
            print(f'  G bound: f32 count {f32_ms:.4f} ms, this design\'s count {design_ms:.4f} '
                  f'ms; distinct rows {distinct:.4f} of the samples', flush=True)
            fns = {'ms': (lambda: sa_fused.fused_point_mlp_max_win_kernel(*args), 20),
                   'plain_ms': (lambda: sa_fused.fused_point_mlp_max_win_plain(*args), 10),
                   'table_kernel_ms': (lambda: sa_fused.fused_point_mlp_max_kernel(
                       y, o, rows, *w), 20)}
        else:
            f32_ms, design_ms, b_ms = _sa_bwd_bound(y, o, rows, *w, gout, work=real_work)
            o_ms = min(f32_ms, design_ms)
            print(f'  H bound: f32 count {f32_ms:.4f} ms, this design\'s count {design_ms:.4f} '
                  f'ms', flush=True)
            fns = {'ms': (lambda: sa_fused.fused_point_mlp_max_win_bwd_kernel(*args, gout), 5),
                   'plain_ms': (lambda: sa_fused.fused_point_mlp_max_win_bwd_plain(*args, gout),
                                5),
                   'table_kernel_ms': (lambda: sa_fused.fused_point_mlp_max_bwd_kernel(
                       y, o, rows, *w, gout), 5)}
        b_ms += _bound(0, 8 * starts.numel())[1]  # the window starts
        row = dict.fromkeys(fns, 0.0)
        for key in ('ms', 'plain_ms', 'table_kernel_ms', 'table_kernel_ms', 'plain_ms', 'ms'):
            fn, reps = fns[key]
            row[key] += _time_ms(fn, reps) / 2
        table = 'B' if kind == 'fwd' else 'C'
        print(f'  T={T}: kernel {name} {row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, kernel '
              f'{table} on the global rows {row["table_kernel_ms"]:.4f} ms, bound '
              f'{max(o_ms, b_ms):.4f} ms', flush=True)
        row.update(f32_count_ms=f32_ms, design_count_ms=design_ms, bound_ms=max(o_ms, b_ms))
        if kind == 'bwd':
            row.update(selections_differing=real_differ)
        else:
            row.update(distinct_rows=distinct, bitwise_equal_to_B=True)
        shape = {'stage': 'rcnn.sa0', 'shape': [T, N, M, S, C1, C2, C3], 'window': W,
                 'tiles': tiles, **row, 'max_rel_err': max(rel.values())}
        if name in res:  # G at T = 256, beside the forward's shape that sets the line
            res[name]['per_shape'].append(shape)
            continue
        res[name] = {'max_abs_err': max(a for a, _ in errs.values()), 'ms': row['ms'],
                     'plain_ms': row['plain_ms'], **_bound_keys([o_ms], [b_ms]),
                     'library_ms': None, 'design_count_ms': design_ms, 'per_shape': [shape]}
        if kind == 'fwd':
            res[name]['distinct_rows'] = distinct
    return res


def _request(seed, cfg, dev):
    import numpy as np
    import torch
    from epnet_tpu_torch.utils.testing import structured_scene

    rng = np.random.RandomState(seed)
    pts, xy, _ = structured_scene(rng, cfg.RPN.NUM_POINTS, n_cars=8, img_hw=(384, 1280))
    img = rng.rand(1, 384, 1280, 3).astype(np.float32)
    return {'pts_input': torch.from_numpy(pts[None]).to(dev),
            'img': torch.from_numpy(img).to(dev),
            'pts_origin_xy': torch.from_numpy(xy[None]).to(dev)}


def phase_slice(dev):
    import torch
    from epnet_tpu_torch.config import parity_config
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.ops import conv2d, fps, nms, sa_fused

    cfg = parity_config()
    gen = torch.Generator(device=dev).manual_seed(0)
    # as a caller may have left them: building the model must turn them off
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    model = EPNet(cfg, 'TEST', device=dev, generator=gen).eval()
    _require_f32('EPNet')
    n_params = sum(p.numel() for p in model.parameters())
    print(f'EPNet TEST, parity recipe, {n_params} parameters on {dev}', flush=True)
    requests = [_request(seed, cfg, dev) for seed in (0, 1, 2)]
    model(requests[0])  # warm-up: cuDNN autotuning, allocator
    torch.cuda.synchronize()

    counters = (fps.furthest_point_sample_kernel, sa_fused.fused_point_mlp_max_kernel,
                conv2d.conv3x3_s2_fwd_kernel, nms.nms_bev_kernel)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for seed, batch in zip((0, 1, 2), requests):
        before = [c.launches for c in counters]
        t0 = time.perf_counter()
        out = model(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        delta = [c.launches - b for c, b in zip(counters, before)]
        R = cfg.TEST.RPN_POST_NMS_TOP_N
        want = {'rois': (1, R, 7), 'rcnn_cls': (R, 1), 'rcnn_reg': (R, cfg.RCNN.reg_channel),
                'rpn_cls': (1, cfg.RPN.NUM_POINTS, 1),
                'backbone_features': (1, cfg.RPN.NUM_POINTS, 128)}
        for k, shape in want.items():
            if tuple(out[k].shape) != shape:
                raise AssertionError(f'{k}: shape {tuple(out[k].shape)}, expected {shape}')
        for k, v in out.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise AssertionError(f'request {seed}: non-finite values in {k}')
        if delta != [6, 2, 4, 2]:
            raise AssertionError(f'request {seed}: kernel launches {delta}, expected '
                                 f'[6, 2, 4, 2]')
        print(f'request scene {seed}: {times[-1]:.2f} ms, rois {int(out["roi_counts"][0])}, '
              f'launches fps +{delta[0]} sa_fused +{delta[1]} conv3x3_s2_fwd +{delta[2]} '
              f'nms_bev +{delta[3]}', flush=True)
    launches = [c.launches for c in counters]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f'slice forward, batch 1: median {statistics.median(times):.2f} ms over '
          f'{len(times)} requests; peak memory {peak:.2f} GiB', flush=True)
    return launches


def _tiny_batch(cfg):
    """Two structured scenes at tiny widths (Morton-sorted under
    RPN.BLOCK_LOCAL, as the loader sorts them) with random images, on the
    CPU."""
    import numpy as np
    import torch
    from epnet_tpu_torch.ops.morton import morton_argsort_np
    from epnet_tpu_torch.utils.testing import structured_scene

    rng = np.random.RandomState(3)
    pts, xy, _ = zip(*[structured_scene(rng, cfg.RPN.NUM_POINTS, n_cars=3, img_hw=(32, 64),
                                        z_range=(1.5, 25.0), car_z_range=(5.0, 16.0))
                       for _ in range(2)])
    if cfg.RPN.BLOCK_LOCAL:
        perms = [morton_argsort_np(p) for p in pts]
        pts, xy = [p[i] for p, i in zip(pts, perms)], [u[i] for u, i in zip(xy, perms)]
    return {'pts_input': torch.from_numpy(np.stack(pts)),
            'img': torch.from_numpy(rng.rand(2, 32, 64, 3).astype(np.float32)),
            'pts_origin_xy': torch.from_numpy(np.stack(xy))}


def phase_small_reference(dev, over=None, **switches):
    """The tiny-width model with identical weights: card (kernels) vs CPU
    (plain versions); ``over``: the config's overrides (default the exact
    queries); ``switches``: ``EPNet``'s (``fp_block``, ...). Under
    RPN.BLOCK_LOCAL the scenes are Morton-sorted."""
    import torch
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.utils.testing import tiny_config

    cfg = tiny_config(**(over or {'EXACT_QUERIES': True}))
    cpu = EPNet(cfg, 'TEST', device='cpu', generator=torch.Generator().manual_seed(1),
                **switches).eval()
    card = EPNet(cfg, 'TEST', device=dev, **switches).eval()
    card.load_state_dict(cpu.state_dict())
    batch = _tiny_batch(cfg)
    want = cpu(batch)
    got = card({k: v.to(dev) for k, v in batch.items()})
    worst = 0.0
    for k in ('backbone_features', 'rpn_cls', 'rpn_reg', 'rois', 'rcnn_cls', 'rcnn_reg'):
        err = float((got[k].cpu() - want[k]).abs().max())
        bound = 1e-3 * (1.0 + float(want[k].abs().max()))
        worst = max(worst, err / bound)
        if not err <= bound:
            raise AssertionError(f'tiny model on the card vs CPU: {k} off by {err:.3e}')
    if not torch.equal(got['roi_counts'].cpu(), want['roi_counts']):
        raise AssertionError('tiny model on the card vs CPU: roi counts differ')
    print(f'tiny model{" (block-local)" if cfg.RPN.BLOCK_LOCAL else ""}'
          f'{"".join(f" {k}={v}" for k, v in switches.items())}, card vs CPU plain '
          f'path: agree (worst {worst:.3f} of the bound 1e-3 * (1 + max|x|))', flush=True)


def _train_batch(cfg, seed, dev):
    from epnet_tpu_torch.train.trainer import device_batch
    from epnet_tpu_torch.utils.testing import full_batch
    return device_batch(full_batch(cfg, TRAIN_BATCH, seed=seed, with_labels=True), dev)


TRAIN_NAMES = ('fps', 'sa_fused_fwd', 'sa_fused_bwd', 'conv3x3_dw_s2', 'conv3x3_dw_s1',
               'conv3x3_s2_fwd')  # the kernels a train step runs, named as in the kernels line


def _train_counters():
    from epnet_tpu_torch.ops import conv2d, fps, sa_fused
    return (fps.furthest_point_sample_kernel, sa_fused.fused_point_mlp_max_kernel,
            sa_fused.fused_point_mlp_max_bwd_kernel, conv2d.dw3x3_s2_kernel,
            conv2d.dw3x3_s1_kernel, conv2d.conv3x3_s2_fwd_kernel)


def _launches(delta, names=TRAIN_NAMES):
    return ' '.join(f'{n} +{d}' for n, d in zip(names, delta))


def phase_train(dev):
    import torch
    from epnet_tpu_torch.config import parity_config
    from epnet_tpu_torch.ops import nms
    from epnet_tpu_torch.train.trainer import create_train_state, train_step

    cfg = parity_config()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    state = create_train_state(cfg, total_steps=100, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    _require_f32('create_train_state')
    params = list(state.model.parameters())
    print(f'EPNet TRAIN, parity recipe, {sum(p.numel() for p in params)} parameters, '
          f'batch {TRAIN_BATCH}', flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = {seed: _train_batch(cfg, seed, dev) for seed in (3,) + TRAIN_SEEDS}
    tb = train_step(state, batches[3], 0.1, gen)  # warm-up: cuDNN autotuning, allocator
    torch.cuda.synchronize()
    print(f'warm-up step: loss {float(tb["loss"]):.4f}', flush=True)

    counters = _train_counters() + (nms.nms_bev_kernel,)
    want = [6, 2, 2, 4, 3, 4, 2 * TRAIN_BATCH]  # the NMS kernel: two walks a scan
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for seed in TRAIN_SEEDS:
        before = [c.launches for c in counters]
        old = [p.detach().clone() for p in params]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tb = train_step(state, batches[seed], 0.1, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        delta = [c.launches - b for c, b in zip(counters, before)]
        loss = float(tb['loss'])
        if not math.isfinite(loss):
            raise AssertionError(f'train step on scene {seed}: loss {loss}')
        bad = [n for n, p in state.model.named_parameters()
               if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
        if bad:
            raise AssertionError(f'train step on scene {seed}: non-finite gradients in {bad[:5]}')
        moved = sum(not torch.equal(a, p) for a, p in zip(old, params))
        if moved < 0.9 * len(params):
            raise AssertionError(f'train step on scene {seed}: {moved} of {len(params)} '
                                 f'parameters moved')
        if delta != want:
            raise AssertionError(f'train step on scene {seed}: kernel launches {delta}, '
                                 f'expected {want}')
        print(f'train step scene {seed}: {times[-1]:.2f} ms, loss {loss:.4f}, grad norm '
              f'{float(tb["grad_norm"]):.3f}, rcnn fg {int(tb["rcnn_cls_fg"])}, '
              f'{moved}/{len(params)} parameters moved, launches '
              f'{_launches(delta, TRAIN_NAMES + ("nms_bev",))}', flush=True)
    launches = [c.launches for c in counters]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f'train step, batch {TRAIN_BATCH}: median {statistics.median(times):.2f} ms over '
          f'{len(times)} steps; peak memory {peak:.2f} GiB', flush=True)
    return launches


def phase_small_train_reference(dev, over=None):
    """One tiny-width train step, card (kernels) vs CPU (plain versions):
    identical weights, dropout 0 and identical sampled RoIs. The loss, the
    RPN heads' and the RCNN's gradients within 1e-3 * (1 + max|x|); the
    backbone's within 0.25 of each leaf's scale and 10% of their norm,
    because batch-statistics BatchNorm amplifies summation-order roundoff
    into ReLU flips (tests/test_torch_train_step.py says more)."""
    from unittest import mock

    import numpy as np
    import torch
    from epnet_tpu_torch.models import epnet as epnet_mod
    from epnet_tpu_torch.train.loss import joint_loss
    from epnet_tpu_torch.utils.testing import synthetic_batch, tiny_config

    cfg = tiny_config(**(over or {'EXACT_QUERIES': True})).merged({'RPN': {'DP_RATIO': 0.0}})
    cpu = epnet_mod.EPNet(cfg, 'TRAIN', device='cpu',
                         generator=torch.Generator().manual_seed(1)).train()
    card = epnet_mod.EPNet(cfg, 'TRAIN', device=dev)
    card.load_state_dict(cpu.state_dict())
    card.train()
    batch = synthetic_batch(np.random.RandomState(3), cfg, batch=2, structured=True)
    recorded, real = [], epnet_mod.proposal_target_layer

    def record(*args, **kwargs):
        recorded.append(real(*args, **kwargs))
        return recorded[-1]

    def step(model, b, layer):
        with mock.patch.object(epnet_mod, 'proposal_target_layer', layer):
            out = model(b, generator=torch.Generator(device=model.rcnn.cls_out.weight.device)
                        .manual_seed(2))
        loss, _ = joint_loss(cfg, out, b)
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().cpu() for n, p in model.named_parameters()}

    want_loss, want = step(cpu, {k: torch.from_numpy(v) for k, v in batch.items()}, record)
    targets = type(recorded[0])(*(t.to(dev) for t in recorded[0]))
    got_loss, got = step(card, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
                         lambda *a, **k: targets)
    if not abs(got_loss - want_loss) <= 1e-3 * (1 + abs(want_loss)):
        raise AssertionError(f'tiny train step, card vs CPU: loss {got_loss} vs {want_loss}')
    gmax = max(float(g.abs().max()) for g in want.values())
    worst_head, worst_bb, diff2, norm2 = 0.0, 0.0, 0.0, 0.0
    for n, w in want.items():
        err = float((got[n] - w).abs().max())
        if n.startswith('rpn.backbone.'):
            worst_bb = max(worst_bb, err / max(float(w.abs().max()), 1e-2 * gmax))
            diff2 += float(((got[n] - w).double() ** 2).sum())
            norm2 += float((w.double() ** 2).sum())
        else:
            worst_head = max(worst_head, err / (1e-3 * (1 + float(w.abs().max()))))
    print(f'tiny train step{" (block-local)" if cfg.RPN.BLOCK_LOCAL else ""}, card vs CPU: '
          f'loss {got_loss:.6f} vs {want_loss:.6f}; heads and '
          f'RCNN worst {worst_head:.3f} of the bound 1e-3 * (1 + max|x|); backbone worst leaf '
          f'{worst_bb:.4f} of its scale, {math.sqrt(diff2 / norm2):.4f} of its norm', flush=True)
    if not (worst_head <= 1.0 and worst_bb <= 0.25 and diff2 <= 0.01 * norm2):
        raise AssertionError('tiny train step: the card and the CPU disagree')


def dw_cases(dev):
    """Phase 8's inputs, made on the card from one seed: (name, shape,
    stride, x, dy) for the edge shapes (name ``'edge'``), then for each
    kernel (``DW_SHAPES``' keys) its tower shapes (shape: the block)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(8)

    def draw(B, H, W, C, Fo, stride):
        return (torch.randn(B, H, W, C, device=dev, generator=gen),
                torch.randn(B, H // stride, W // stride, Fo, device=dev, generator=gen))
    for B, H, W, C, Fo, stride in DW_EDGE_SHAPES:
        yield ('edge', (B, H, W, C, Fo), stride, *draw(B, H, W, C, Fo, stride))
    for name, shapes in DW_SHAPES.items():
        stride = 2 if name.endswith('s2') else 1
        for blk, shape in shapes.items():
            yield (name, blk, stride, *draw(*shape, stride))


def dw_kernel_and_plain(stride):
    """(kernel, plain version) of the weight gradient at ``stride``: D or E."""
    from epnet_tpu_torch.ops import conv2d
    return ((conv2d.dw3x3_s2_kernel, conv2d.dw3x3_s2_plain) if stride == 2
            else (conv2d.dw3x3_s1_kernel, conv2d.dw3x3_s1_plain))


def phase_conv_dw(dev):
    """Kernels D and E against their plain versions at the tower's train
    shapes; kernel, plain and library (``_library_dw_call``, cuDNN without
    TF32) timed in turns."""
    import torch

    _require_f32('conv2d_weight')
    cases = dw_cases(dev)
    for _, shape, stride, x, dy in itertools.islice(cases, len(DW_EDGE_SHAPES)):
        kernel, plain = dw_kernel_and_plain(stride)
        want = plain(x, dy)
        err = float((kernel(x, dy) - want).abs().max()) / float(want.abs().max())
        if not err <= DW_RTOL:
            raise AssertionError(f'stride {stride} kernel off by {err:.3e} of max|dw| at {shape}')
    print(f'conv3x3_dw at {len(DW_EDGE_SHAPES)} edge shapes: within {DW_RTOL} of max|dw|',
          flush=True)
    rows = collections.defaultdict(list)
    for name, blk, stride, x, dy in cases:
        kernel, plain = dw_kernel_and_plain(stride)
        B, H, W, C, Fo = DW_SHAPES[name][blk]
        pixels = B * (H // stride) * (W // stride)
        counts = _conv_counts(C, Fo, pixels, stride,
                              4 * (B * H * W * C + pixels * Fo + 9 * C * Fo))
        library = _library_dw_call(x, dy, stride)
        got, want = kernel(x, dy), plain(x, dy)
        lib_dw = library()
        again = kernel(x, dy)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        lib_err = float((lib_dw - want).abs().max())
        print(f'{name} {blk} x {(B, H, W, C)} -> dy F {Fo}: max abs err {err:.3e} '
              f'({err / scale:.2e} of max|dw|); conv2d_weight {lib_err / scale:.2e}',
              flush=True)
        if not err <= DW_RTOL * scale:
            raise AssertionError(f'{name} {blk}: kernel off by {err / scale:.3e} of max|dw|')
        if not lib_err <= LIBRARY_RTOL * scale:
            raise AssertionError(f'{name} {blk}: conv2d_weight is not the same function')
        if not torch.equal(got, again):
            raise AssertionError(f'{name} {blk}: two launches differ')
        del got, want, lib_dw, again
        fns = {'ms': (lambda: kernel(x, dy), 10), 'plain_ms': (lambda: plain(x, dy), 3),
               'library_ms': (library, 10)}
        row = dict.fromkeys(fns, 0.0)
        for key in ('ms', 'plain_ms', 'library_ms', 'library_ms', 'plain_ms', 'ms'):
            fn, reps = fns[key]
            row[key] += _time_ms(fn, reps) / 2
        row.update(block=blk, shape=[B, H, W, C, Fo], **counts, max_abs_err=err,
                   max_rel_err=err / scale)
        rows[name].append(row)
        print(_conv_row_line(row, 'conv2d_weight'), flush=True)
        del x, dy, library
    return {name: _conv_totals(name, r, 'conv2d_weight') for name, r in rows.items()}


def _conv_totals(name, rows, library):
    """A conv kernel's entry of the kernels line from its tower shapes'
    rows (``_conv_counts``): times and counts summed, ``bound_ms`` each
    shape's, summed; prints it."""
    counts = ('f32_count_ms', 'tf32_count_ms', 'design_count_ms')
    res = {'max_abs_err': max(r['max_abs_err'] for r in rows),
           **{k: sum(r[k] for r in rows) for k in ('ms', 'plain_ms', 'library_ms')},
           **_bound_keys([min(r['f32_count_ms'], r['tf32_count_ms']) for r in rows],
                         [r['bytes_ms'] for r in rows]),
           **{k: sum(r[k] for r in rows) for k in counts},
           'per_shape': rows}
    print(f'{name}: kernel {res["ms"]:.4f} ms, {library} {res["library_ms"]:.4f} ms (kernel / '
          f'library {res["ms"] / res["library_ms"]:.3f}), bound {res["bound_ms"]:.4f} ms '
          f'(Winograd {res["f32_count_ms"]:.4f} at the f32 peak, {res["tf32_count_ms"]:.4f} in '
          f'three TF32 passes; this design\'s count {res["design_count_ms"]:.4f})', flush=True)
    return res


def _tower_conv_grads(model, batch, cfg, dev):
    """The image tower's conv weight gradients of one forward and backward
    (no optimizer step, so before the clip), with fixed draws."""
    import torch
    from epnet_tpu_torch.train.loss import joint_loss

    model.train()
    model.zero_grad(set_to_none=True)
    out = model(batch, bn_momentum=0.1, generator=torch.Generator(device=dev).manual_seed(7))
    loss, _ = joint_loss(cfg, out, batch)
    loss.backward()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if '.img_block' in n and n.endswith('Conv_0.weight')}


def phase_train_dw(dev):
    """The train path in turns with the ``conv2d_weight`` route on the same
    state (step time, memory, launch counts of all six kernels); then one
    step's tower conv weight gradients by kernels D and E against that
    route's."""
    import torch
    from epnet_tpu_torch.config import parity_config
    from epnet_tpu_torch.train.trainer import create_train_state, train_step

    cfg = parity_config()
    state = create_train_state(cfg, total_steps=100, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    params = list(state.model.parameters())
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = {seed: _train_batch(cfg, seed, dev) for seed in (3,) + TRAIN_SEEDS}
    counters = _train_counters()

    def route(on):
        return contextlib.nullcontext() if on else library_dw_route()

    for on in (True, False):  # warm-up, both routes
        with route(on):
            train_step(state, batches[3], 0.1, gen)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    times, peaks = {True: [], False: []}, {True: 0.0, False: 0.0}
    # in turns, so that both routes see the same process and host: on, off;
    # off, on; on, off
    for i, seed in enumerate(TRAIN_SEEDS):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            name = 'kernel' if on else 'conv2d_weight'
            with route(on):
                before = [c.launches for c in counters]
                old = [p.detach().clone() for p in params]
                torch.cuda.reset_peak_memory_stats(dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tb = train_step(state, batches[seed], 0.1, gen)
                torch.cuda.synchronize()
                times[on].append((time.perf_counter() - t0) * 1e3)
                peaks[on] = max(peaks[on], torch.cuda.max_memory_allocated(dev) / 2 ** 30)
            delta = [c.launches - b for c, b in zip(counters, before)]
            loss = float(tb['loss'])
            moved = sum(not torch.equal(a, p) for a, p in zip(old, params))
            if not math.isfinite(loss) or moved < 0.9 * len(params):
                raise AssertionError(f'{name}-route step on scene {seed}: loss {loss}, '
                                     f'{moved} of {len(params)} parameters moved')
            want = [6, 2, 2, 4, 3, 4] if on else [6, 2, 2, 0, 0, 4]
            if delta != want:
                raise AssertionError(f'{name}-route step on scene {seed}: launches {delta}, '
                                     f'expected {want}')
            print(f'{name}-route step scene {seed}: {times[on][-1]:.2f} ms, loss {loss:.4f}, '
                  f'launches {_launches(delta)}', flush=True)
    launches = [c.launches for c in counters]
    for on in (True, False):
        print(f'{"kernel" if on else "conv2d_weight"}-route train step, batch {TRAIN_BATCH}, '
              f'in turns: median {statistics.median(times[on]):.2f} ms over {len(times[on])} steps; peak '
              f'memory {peaks[on]:.2f} GiB', flush=True)
    on = _tower_conv_grads(state.model, batches[0], cfg, dev)
    with library_dw_route():
        off = _tower_conv_grads(state.model, batches[0], cfg, dev)
        off2 = _tower_conv_grads(state.model, batches[0], cfg, dev)

    def rel(a, b):
        return {n: float((a[n] - g).abs().max()) / float(g.abs().max()) for n, g in b.items()}

    diff, floor = rel(on, off), rel(off2, off)
    for n in off:
        print(f'  {n}: kernels vs conv2d_weight {diff[n]:.2e}, conv2d_weight twice '
              f'{floor[n]:.2e} of max|dw|', flush=True)
    print(f'tower conv weight gradients ({len(off)} convs), before the clip: kernels vs '
          f'conv2d_weight worst {max(diff.values()):.2e} of max|dw| (bound {ROUTE_RTOL}); two '
          f'conv2d_weight runs worst {max(floor.values()):.2e}', flush=True)
    bad = {n: v for n, v in diff.items() if not v <= ROUTE_RTOL}
    if bad:
        raise AssertionError(f'kernels vs conv2d_weight: tower conv gradients off: {bad}')
    return launches


def _library_fwd_call(x, w):
    """A call of ``F.conv2d`` (cuDNN) that gives the stride-2 SAME conv,
    its input padded beforehand: SAME is (0, 1) here, which ``F.conv2d``'s
    own symmetric padding cannot express."""
    import torch.nn.functional as F
    from epnet_tpu_torch.ops import conv2d

    x_nchw = x.permute(0, 3, 1, 2)
    xp = F.pad(x_nchw, conv2d._nchw_pads(x_nchw, 3, 2))
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    return lambda: F.conv2d(xp, w_oihw, None, 2)


def phase_bf16_kernels(dev):
    """The bf16 instances against their plain versions: B-bf16 at the RCNN
    sa0/sa1 shapes (T = 100, a batch-1 forward, and T = 400, a batch-4 CLI
    batch) and on phase 2's real sa0 tables, G-bf16 on phase 13's real
    windows (T = 100) and edge cases, F-bf16 at the eight tower shapes and
    the five edge shapes; each within BF16_ULPS bf16 units of max|out|, two
    launches bitwise equal; B-bf16 raises beyond its limits. Kernel, plain
    version and (for F) ``F.conv2d`` in bf16 on the padded input timed in
    turns."""
    import numpy as np
    import torch
    from epnet_tpu_torch.ops import conv2d, sa_fused

    bf = torch.bfloat16
    rng = np.random.RandomState(17)
    res = {}

    def check(name, kernel, plain, args):
        got, again, want = kernel(*args), kernel(*args), plain(*args)
        torch.cuda.synchronize()
        if got.dtype != bf or want.dtype != bf:
            raise AssertionError(f'{name}: outputs {got.dtype} / {want.dtype}, expected bf16')
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        exact = float((got == want).float().mean())
        if not err <= BF16_ULPS * _bf16_ulp(scale) or not torch.equal(got, again):
            raise AssertionError(f'{name}: off by {err:.3e} at max|out| {scale:.3e} (one bf16 '
                                 f'ulp {_bf16_ulp(scale):.3e}), or two launches differ')
        return err, scale, exact

    def timed(fns):
        row = dict.fromkeys(fns, 0.0)
        keys = list(fns)
        for key in keys + keys[::-1]:
            fn, reps = fns[key]
            row[key] += _time_ms(fn, reps) / 2
        return row

    def sa_args(T, N, M, C1, C2, C3, r=rng):
        def f(*shape, scale=1.0, dtype=bf):
            return torch.from_numpy((r.randn(*shape) * scale).astype(np.float32)).to(dev, dtype)
        return (f(T, N, C1), f(T, M, C1, scale=0.1)), (
            f(C1, C2, scale=C1 ** -0.5), f(C2, scale=0.01, dtype=torch.float32),
            f(C2, C3, scale=C2 ** -0.5), f(C3, scale=0.01, dtype=torch.float32))

    def b_args(T, N, M, S, C1, C2, C3, r=rng):
        (y, o), w = sa_args(T, N, M, C1, C2, C3, r)
        idx = torch.from_numpy(r.randint(0, N, (T, M, S))).to(dev)
        idx[:, :M // 4, S // 2:] = idx[:, :M // 4, :1]  # short balls padded with the first hit
        return y, o, idx, w

    # B-bf16: random tables at SA_SHAPES (the line's sum), then phase 2's
    # real sa0 tables in bf16 (beside it)
    design = sa_fused.bf16_design()
    print(f'B-bf16 and G-bf16: {design}', flush=True)
    rows, max_err, op_ms, byte_ms = [], 0.0, [], []
    total = {'ms': 0.0, 'plain_ms': 0.0}
    cli_rng = np.random.RandomState(23)
    real = next(args for _, _, kind, args in sa_cases(dev) if kind == 'real')
    real = (real[0].to(bf), real[1].to(bf), real[2], real[3].to(bf), real[4], real[5].to(bf),
            real[6])
    cases = [(name, shape, None) for name, shape in SA_SHAPES.items()]
    cases.append(('rcnn.sa0 real', SA_SHAPES['rcnn.sa0'], real))
    for name, (T, N, M, S, C1, C2, C3), given in cases:
        if given is None:
            # the CLI's tables (batch 4 x RPN_POST_NMS_TOP_N): checked, not timed
            y, o, idx, w = b_args(4 * T, N, M, S, C1, C2, C3, cli_rng)
            err, scale, exact = check(f'B-bf16 {name} T={4 * T}',
                                      sa_fused.fused_point_mlp_max_bf16_kernel,
                                      sa_fused.fused_point_mlp_max_plain, (y, o, idx, *w))
            max_err = max(max_err, err)
            print(f'B-bf16 {name} T={4 * T}: max abs err {err:.3e} (max|out| {scale:.3e}), '
                  f'{exact:.4f} of outputs bit-identical', flush=True)
            del y, o, idx, w
            y, o, idx, w = b_args(T, N, M, S, C1, C2, C3)
            args = (y, o, idx, *w)
        else:
            args = given
        idx = args[2]
        om, bm = _sa_fwd_bound(idx, N, C1, C2, C3, bf16=True)
        distinct = float(_distinct_rows(idx)[1].float().mean())
        err, scale, exact = check(f'B-bf16 {name}', sa_fused.fused_point_mlp_max_bf16_kernel,
                                  sa_fused.fused_point_mlp_max_plain, args)
        row = timed({'ms': (lambda: sa_fused.fused_point_mlp_max_bf16_kernel(*args), 20),
                     'plain_ms': (lambda: sa_fused.fused_point_mlp_max_plain(*args), 10)})
        rows.append({'stage': name, 'shape': [T, N, M, S, C1, C2, C3], **row,
                     'bound_ms': max(om, bm), 'max_abs_err': err, 'bit_identical': exact,
                     'distinct_rows': distinct})
        print(f'B-bf16 {name} {(T, N, M, S, C1, C2, C3)}: max abs err {err:.3e} (max|out| '
              f'{scale:.3e}), {exact:.4f} of outputs bit-identical, distinct rows '
              f'{distinct:.4f} of the samples; kernel {row["ms"]:.4f} ms, plain '
              f'{row["plain_ms"]:.4f} ms, bound {max(om, bm):.4f} ms '
              f'({max(om, bm) / row["ms"]:.3f} of it)', flush=True)
        if given is not None:
            continue  # beside the line's sum, which stays the random tables'
        max_err = max(max_err, err)
        op_ms.append(om)
        byte_ms.append(bm)
        for k in total:
            total[k] += row[k]
    res['B'] = {'max_abs_err': max_err, **total, **_bound_keys(op_ms, byte_ms),
                'library_ms': None, 'design': design, 'per_shape': rows}
    del real, args
    y, o, idx, w = b_args(2, 64, 8, 16, 128, 128, 128)
    try:
        sa_fused.fused_point_mlp_max_bf16_kernel(y, o, idx, w[0], w[1],
                                                 torch.zeros(128, 512, dtype=bf, device=dev),
                                                 torch.zeros(512, device=dev))
    except ValueError as e:
        print(f'B-bf16 at C3 = 512 raises on the card: {e}', flush=True)
    else:
        raise AssertionError('B-bf16 ran a stage beyond its limits (C3 = 512)')

    # G-bf16
    W, tiles, _ = _sa_win_geometry()
    T, N, M, S, C1, C2, C3 = (100,) + SA_SHAPES['rcnn.sa0'][1:]
    (y, o), w = sa_args(T, N, M, C1, C2, C3)
    max_err, real, exact_real = 0.0, None, None
    for edge in (False, True):
        idx_rel, starts = _window_inputs(T, T + edge, dev, edge)
        args = (y, o, idx_rel, starts, *w, W)
        real = real or args
        err, scale, exact = check(f'G-bf16{" edge" if edge else ""}',
                                  sa_fused.fused_point_mlp_max_win_bf16_kernel,
                                  sa_fused.fused_point_mlp_max_win_plain, args)
        exact_real = exact if exact_real is None else exact_real
        max_err = max(max_err, err)
        print(f'G-bf16 T={T}{" edge cases" if edge else " real windows"}: max abs err {err:.3e} '
              f'(max|out| {scale:.3e}), {exact:.4f} of outputs bit-identical', flush=True)
    args = real
    grows = sa_fused.window_rows(args[2], args[3])
    om, bm = _sa_fwd_bound(grows, N, C1, C2, C3, bf16=True)
    bm += _bound(0, 8 * args[3].numel())[1]  # the window starts
    distinct = float(_distinct_rows(grows)[1].float().mean())
    row = timed({'ms': (lambda: sa_fused.fused_point_mlp_max_win_bf16_kernel(*args), 20),
                 'plain_ms': (lambda: sa_fused.fused_point_mlp_max_win_plain(*args), 10),
                 'table_kernel_ms': (lambda: sa_fused.fused_point_mlp_max_bf16_kernel(
                     y, o, grows, *w), 20)})
    print(f'  G-bf16 real windows: {exact_real:.4f} of outputs bit-identical, distinct rows '
          f'{distinct:.4f} of the samples; kernel {row["ms"]:.4f} ms, plain '
          f'{row["plain_ms"]:.4f} ms, B-bf16 on the global rows {row["table_kernel_ms"]:.4f} '
          f'ms, bound {max(om, bm):.4f} ms ({max(om, bm) / row["ms"]:.3f} of it)', flush=True)
    res['G'] = {'max_abs_err': max_err, 'ms': row['ms'], 'plain_ms': row['plain_ms'],
                **_bound_keys([om], [bm]), 'library_ms': None, 'design': design,
                'per_shape': [{'stage': 'rcnn.sa0', 'shape': [T, N, M, S, C1, C2, C3],
                               'window': W, 'tiles': tiles, 'distinct_rows': distinct,
                               'bit_identical': exact_real, **row}]}

    # F-bf16
    gen = torch.Generator(device=dev).manual_seed(19)

    def conv_inputs(B, H, Wd, C, Fo):
        x = torch.randn(B, H, Wd, C, device=dev, generator=gen).to(bf)
        return x, (torch.randn(3, 3, C, Fo, device=dev, generator=gen) / (3 * C ** 0.5)).to(bf)

    kernel, plain = conv2d.conv3x3_s2_fwd_bf16_kernel, conv2d.conv3x3_s2_fwd_plain
    worst = 0.0
    for shape in FWD_EDGE_SHAPES:
        err, scale, _ = check(f'F-bf16 edge {shape}', kernel, plain, conv_inputs(*shape))
        worst = max(worst, err / _bf16_ulp(scale))
    print(f'F-bf16 at {len(FWD_EDGE_SHAPES)} edge shapes: within {worst:.2f} bf16 ulp of '
          f'max|y|, bitwise reproducible', flush=True)
    rows, max_err, op_ms, byte_ms = [], 0.0, [], []
    total = {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0}
    for name, (B, H, Wd, C, Fo) in FWD_SHAPES.items():
        x, wt = conv_inputs(B, H, Wd, C, Fo)
        pixels = B * (H // 2) * (Wd // 2)
        om, bm = _bound(0, 2 * (B * H * Wd * C + 9 * C * Fo + pixels * Fo),
                        _dw_bound_ops(C, Fo, pixels, 2))
        op_ms.append(om)
        byte_ms.append(bm)
        err, scale, exact = check(f'F-bf16 {name}', kernel, plain, (x, wt))
        tiles, splits = conv2d.conv3x3_s2_fwd_grid(x.shape, Fo, dev, bf)
        library = _library_fwd_call(x, wt)
        lib_err = float((library().permute(0, 2, 3, 1).float() - plain(x, wt).float()).abs().max())
        max_err = max(max_err, err)
        row = timed({'ms': (lambda: kernel(x, wt), 10), 'plain_ms': (lambda: plain(x, wt), 3),
                     'library_ms': (library, 10)})
        for k in total:
            total[k] += row[k]
        rows.append({'shape': name, 'dims': [B, H, Wd, C, Fo], **row, 'bound_ms': max(om, bm),
                     'blocks': tiles * splits, 'max_abs_err': err, 'bit_identical': exact})
        print(f'F-bf16 {name} x {(B, H, Wd, C)} -> F {Fo}: {tiles * splits} blocks ({tiles} '
              f'tiles x {splits} K splits); max abs err {err:.3e} (max|y| '
              f'{scale:.3e}), {exact:.4f} bit-identical, F.conv2d bf16 {lib_err:.3e}; kernel '
              f'{row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, F.conv2d '
              f'{row["library_ms"]:.4f} ms, bound {max(om, bm):.4f} ms', flush=True)
        del x, wt, library
    res['F'] = {'max_abs_err': max_err, **total, **_bound_keys(op_ms, byte_ms),
                'per_shape': rows}
    print(f'F-bf16 at the 8 tower shapes: kernel {total["ms"]:.4f} ms, F.conv2d bf16 '
          f'{total["library_ms"]:.4f} ms ({total["ms"] / total["library_ms"]:.2f}x), bound '
          f'{res["F"]["bound_ms"]:.4f} ms', flush=True)
    return res


def fwd_cases(dev):
    """Phase 10's inputs, made on the card from one seed: (name, shape, x,
    w) for the edge shapes (name ``'edge'``), then for ``FWD_SHAPES``."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(9)

    def draw(B, H, W, C, Fo):
        x = torch.randn(B, H, W, C, device=dev, generator=gen)
        return x, torch.randn(3, 3, C, Fo, device=dev, generator=gen) / (3 * C ** 0.5)
    for shape in FWD_EDGE_SHAPES:
        yield ('edge', shape, *draw(*shape))
    for name, shape in FWD_SHAPES.items():
        yield (name, shape, *draw(*shape))


def phase_conv_fwd(dev):
    """Kernel F against its plain version at the tower's stride-2 shapes of
    a batch-1 forward and a batch-4 batch and at edge shapes; kernel, plain
    and library (``_library_fwd_call``, cuDNN without TF32) timed in
    turns."""
    import torch
    from epnet_tpu_torch.ops import conv2d

    _require_f32('F.conv2d')
    kernel, plain = conv2d.conv3x3_s2_fwd_kernel, conv2d.conv3x3_s2_fwd_plain
    cases = fwd_cases(dev)
    for _, shape, x, w in itertools.islice(cases, len(FWD_EDGE_SHAPES)):
        got, want = kernel(x, w), plain(x, w)
        err = float((got - want).abs().max()) / float(want.abs().max())
        if not err <= FWD_RTOL or not torch.equal(kernel(x, w), got):
            raise AssertionError(f'conv3x3_s2_fwd off by {err:.3e} of max|y| or not '
                                 f'reproducible at {shape}')
    print(f'conv3x3_s2_fwd at {len(FWD_EDGE_SHAPES)} edge shapes: within {FWD_RTOL} of '
          f'max|y|, bitwise reproducible', flush=True)
    rows = []
    for name, (B, H, W, C, Fo), x, w in cases:
        pixels = B * (H // 2) * (W // 2)
        counts = _conv_counts(C, Fo, pixels, 2, 4 * (B * H * W * C + 9 * C * Fo + pixels * Fo))
        library = _library_fwd_call(x, w)
        got, want, again = kernel(x, w), plain(x, w), kernel(x, w)
        lib_y = library().permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        lib_err = float((lib_y - want).abs().max())
        tiles, splits = conv2d.conv3x3_s2_fwd_grid(x.shape, Fo, dev)
        print(f'conv3x3_s2_fwd {name} x {(B, H, W, C)} -> F {Fo}: {tiles * splits} blocks '
              f'({tiles} tiles x {splits} K splits); max abs err {err:.3e} ({err / scale:.2e} '
              f'of max|y|); F.conv2d {lib_err / scale:.2e}', flush=True)
        if not err <= FWD_RTOL * scale:
            raise AssertionError(f'conv3x3_s2_fwd {name}: kernel off by {err / scale:.3e}')
        if not lib_err <= LIBRARY_RTOL * scale:
            raise AssertionError(f'conv3x3_s2_fwd {name}: F.conv2d is not the same function')
        if not torch.equal(got, again):
            raise AssertionError(f'conv3x3_s2_fwd {name}: two launches differ')
        del got, want, again, lib_y
        fns = {'ms': (lambda: kernel(x, w), 10), 'plain_ms': (lambda: plain(x, w), 3),
               'library_ms': (library, 10)}
        row = dict.fromkeys(fns, 0.0)
        for key in ('ms', 'plain_ms', 'library_ms', 'library_ms', 'plain_ms', 'ms'):
            fn, reps = fns[key]
            row[key] += _time_ms(fn, reps) / 2
        row.update(shape=name, dims=[B, H, W, C, Fo], blocks=tiles * splits, **counts,
                   max_abs_err=err, max_rel_err=err / scale)
        rows.append(row)
        print(_conv_row_line(row, 'F.conv2d'), flush=True)
        del x, w, library
    return _conv_totals('conv3x3_s2_fwd', rows, 'F.conv2d')


class _TimedLoader:
    """The CLI's loader, timed and counted: the wall time from the first
    batch asked for to the end of the last one's processing, and the
    kernel counters at each batch boundary. Patched in by this script."""

    def __init__(self, loader, counters):
        self.loader, self.counters = loader, counters
        self.t0 = None
        self.snapshots, self.times, self.scans = [], [], 0

    def _snapshot(self):
        self.snapshots.append([c.launches for c in self.counters])
        self.times.append(time.perf_counter())

    def __iter__(self):
        self.t0 = time.perf_counter()
        for batch in self.loader:
            self._snapshot()
            self.scans += len(batch['sample_id'])
            yield batch
        self._snapshot()


@contextlib.contextmanager
def timed_cli_loader(counters, record):
    from unittest import mock
    from epnet_tpu_torch.data import loader as loader_mod

    real = loader_mod.eval_loader

    def make(*args, **kwargs):
        record.append(_TimedLoader(real(*args, **kwargs), counters))
        return record[-1]

    with mock.patch.object(loader_mod, 'eval_loader', make):
        yield


def _parse_results(result_dir):
    import numpy as np
    out = {}
    for f in sorted(os.listdir(result_dir)):
        with open(os.path.join(result_dir, f)) as fh:
            rows = [line.split() for line in fh if line.strip()]
        out[f] = ([r[0] for r in rows], np.array([[float(v) for v in r[1:]] for r in rows]))
    return out


def _filtered_png(path, img, kind):
    """Write (H, W, 3) uint8 ``img`` as a PNG whose rows all use PNG filter
    ``kind`` (1 Sub, 2 Up, 3 Average, 4 Paeth): encoding predicts from the
    unfiltered pixels, so it is vectorized here."""
    import struct
    import zlib

    import numpy as np
    cur = img.reshape(img.shape[0], -1).astype(np.int32)
    a = np.pad(cur, ((0, 0), (3, 0)))[:, :-3]   # left, 3 bytes a pixel
    b = np.pad(cur, ((1, 0), (0, 0)))[:-1]      # up
    c = np.pad(b, ((0, 0), (3, 0)))[:, :-3]     # up-left
    if kind == 4:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        pred = {1: a, 2: b, 3: (a + b) // 2}[kind]
    rows = np.concatenate([np.full((len(cur), 1), kind), (cur - pred) & 255], axis=1)

    def chunk(tag, payload):
        return struct.pack('>I', len(payload)) + tag + payload + \
            struct.pack('>I', zlib.crc32(tag + payload))

    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n'
                + chunk(b'IHDR', struct.pack('>IIBBBBB', img.shape[1], img.shape[0], 8, 2, 0, 0, 0))
                + chunk(b'IDAT', zlib.compress(rows.astype(np.uint8).tobytes()))
                + chunk(b'IEND', b''))


def _png_times(root):
    """Host time of ``data/png.read_rgb`` on one 370x1240 scene image,
    stored with filter 0 (as ``make_fake_kitti`` writes it) and with every
    row Sub, Up, Average or Paeth; the pixels must come back unchanged."""
    import numpy as np
    from epnet_tpu_torch.data import png

    src = os.path.join(root, 'KITTI', 'object', 'training', 'image_2', '000000.png')
    img = png.read_rgb(src)
    times = {}
    for kind in (0, 1, 2, 3, 4):
        path = src if kind == 0 else os.path.join(OUT, f'filter{kind}.png')
        if kind:
            _filtered_png(path, img, kind)
        t0 = time.perf_counter()
        got = png.read_rgb(path)
        times[kind] = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(got, img):
            raise AssertionError(f'PNG with filter {kind} read back wrong')
    print(f'PNG read of one {img.shape[0]}x{img.shape[1]} image on the host, ms by row '
          f'filter: ' + ', '.join(f'{k} {v:.1f}' for k, v in times.items()), flush=True)


def _save_weights(cfg, dev, path_dir, seed):
    """Seeded random weights saved as a port checkpoint (epoch 0)."""
    import torch
    from epnet_tpu_torch.train.trainer import create_train_state, save_checkpoint
    state = create_train_state(cfg, total_steps=1, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(seed))
    return save_checkpoint(path_dir, state, epoch=0)


FWD_KERNELS = ('fps', 'sa_fused_fwd', 'sa_fused_win_fwd', 'conv3x3_s2_fwd', 'sa_fused_fwd_bf16',
               'sa_fused_win_fwd_bf16', 'conv3x3_s2_fwd_bf16')  # a forward's, by name


def _fwd_counters():
    from epnet_tpu_torch.ops import conv2d, fps, sa_fused
    return (fps.furthest_point_sample_kernel, sa_fused.fused_point_mlp_max_kernel,
            sa_fused.fused_point_mlp_max_win_kernel, conv2d.conv3x3_s2_fwd_kernel,
            sa_fused.fused_point_mlp_max_bf16_kernel, sa_fused.fused_point_mlp_max_win_bf16_kernel,
            conv2d.conv3x3_s2_fwd_bf16_kernel)


def _fwd_launches(delta):
    return ' '.join(f'{n} +{d}' for n, d in zip(FWD_KERNELS, delta) if d)


# the launches of one CLI batch (batch 4) or one forward, by configuration
FWD_WANT = {'exact': [6, 2, 0, 4, 0, 0, 0], 'block-local': [6, 1, 1, 4, 0, 0, 0],
            'bf16': [6, 0, 0, 0, 2, 0, 4], 'bf16 block-local': [6, 0, 0, 0, 1, 1, 4]}
MIXED_SET = ('MIXED_PRECISION', 'True')


def phase_cli(dev, mode='exact'):
    """The eval CLI on the card at the recipe's full width; in the
    'block-local' and 'bf16' modes on the same tree and checkpoint (saved
    in the exact configuration) with that configuration's ``--set``."""
    import shutil

    import numpy as np
    from epnet_tpu_torch.config import BLOCK_LOCAL_SET, load_config
    from epnet_tpu_torch.tools import eval as cli
    from epnet_tpu_torch.utils.testing import make_fake_kitti

    root = os.path.join(OUT, 'kitti')
    if mode != 'exact':
        ckpt = os.path.join(OUT, 'ckpt', 'checkpoint_epoch_0.pth')
    else:
        shutil.rmtree(OUT, ignore_errors=True)
        t0 = time.perf_counter()
        make_fake_kitti(root, n_samples=CLI_SCENES, n_points=30000, seed=11)
        print(f'fake KITTI tree of {CLI_SCENES} scenes written in '
              f'{time.perf_counter() - t0:.2f} s', flush=True)
        _png_times(root)
        ckpt = _save_weights(load_config(RECIPE), dev, os.path.join(OUT, 'ckpt'), seed=0)
    sets = {'exact': (), 'block-local': BLOCK_LOCAL_SET, 'bf16': MIXED_SET}[mode]
    counters = _fwd_counters()
    for c in counters:
        c.launches = 0
    record = []
    out_dir = os.path.join(OUT, 'eval' if mode == 'exact' else f'eval_{mode}')
    t0 = time.perf_counter()
    with timed_cli_loader(counters, record):
        ret = cli.main(['--cfg_file', RECIPE, '--data_root', root, '--ckpt', ckpt,
                        '--batch_size', str(CLI_BATCH), '--workers', '4',
                        '--output_dir', out_dir, '--device', str(dev)]
                       + (['--set', *sets] if sets else []))
    wall = time.perf_counter() - t0
    timed = record[0]
    final_dir = os.path.join(out_dir, 'epoch_0', 'final_result', 'data')
    files = sorted(os.listdir(final_dir))
    if files != ['%06d.txt' % i for i in range(CLI_SCENES)]:
        raise AssertionError(f'CLI result files: {files}')
    ap = ret['ap']['Car']
    if not all(math.isfinite(v) for k in ap for v in ap[k]):
        raise AssertionError(f'CLI AP not finite: {ap}')
    snaps = np.array(timed.snapshots)
    # snapshot k is taken as batch k is handed out, the last one after the
    # last batch was processed: batch k's launches lie between k and k + 1
    per_batch = np.diff(snaps, axis=0).tolist()
    if timed.scans != CLI_SCENES or per_batch != [FWD_WANT[mode]] * (CLI_SCENES // CLI_BATCH):
        raise AssertionError(f'CLI: {timed.scans} scans, launches a batch {per_batch}, '
                             f'expected {FWD_WANT[mode]}')
    loop = timed.times[-1] - timed.t0
    dets = [len(v[0]) for v in _parse_results(final_dir).values()]
    steps = ', '.join(f'{(b - a) * 1e3:.1f}' for a, b in zip(timed.times, timed.times[1:]))
    print(f'eval CLI, recipe{" --set " + " ".join(sets) if sets else ""} at '
          f'full width, batch {CLI_BATCH}: {timed.scans} scans in '
          f'{loop:.3f} s of loop (loader included) = {timed.scans / loop:.3f} scans/s; first '
          f'batch handed out after {(timed.times[0] - timed.t0) * 1e3:.1f} ms (workers start), '
          f'then each batch processed and the next received in {steps} ms; main() '
          f'{wall:.3f} s; detections a scan {dets}; launches a batch '
          f'{_fwd_launches(per_batch[0])}; rcnn_recall(0.5) '
          f'{ret["rcnn_recall(thresh=0.50)"]:.4f}, Car 3d AP {ap["3d"]}', flush=True)
    return dict(zip(FWD_KERNELS, (int(v) for v in snaps[-1])))


def phase_bf16_slice(dev):
    """The bf16 TEST forward (the recipe with ``MIXED_PRECISION``) at full
    width, in turns with the f32 forward on the same weights: three batch-1
    requests each on scenes 0/1/2 (6 FPS, 2 B-bf16 and 4 F-bf16 launches a
    bf16 forward, no f32 B or F), medians and peak memory; then one
    batch-1 forward of the block-local configuration in bf16 (1 B-bf16, 1
    G-bf16) on a Morton-sorted scene."""
    import torch
    from epnet_tpu_torch.config import block_local_config, parity_config
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.train.trainer import device_batch
    from epnet_tpu_torch.utils.testing import full_batch

    cfgs = {'bf16': parity_config().with_overrides([MIXED_SET]), 'exact': parity_config()}
    gen = torch.Generator(device=dev).manual_seed(0)
    models = {'exact': EPNet(cfgs['exact'], 'TEST', device=dev, generator=gen).eval()}
    models['bf16'] = EPNet(cfgs['bf16'], 'TEST', device=dev).eval()
    models['bf16'].load_state_dict(models['exact'].state_dict())
    if torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        raise AssertionError('the bf16 EPNet left bf16 split-K reductions in bf16')
    requests = [_request(seed, cfgs['exact'], dev) for seed in (0, 1, 2)]
    for m in models.values():  # warm-up
        m(requests[0])
    torch.cuda.synchronize()
    counters = _fwd_counters()
    for c in counters:
        c.launches = 0
    times = {k: [] for k in models}
    peaks = dict.fromkeys(models, 0.0)
    R = cfgs['exact'].TEST.RPN_POST_NMS_TOP_N
    for i, batch in enumerate(requests):
        outs = {}
        for name in (('bf16', 'exact') if i % 2 == 0 else ('exact', 'bf16')):
            before = [c.launches for c in counters]
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = models[name](batch)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated(dev) / 2 ** 30)
            delta = [c.launches - b for c, b in zip(counters, before)]
            bad = [k for k, v in out.items()
                   if v.is_floating_point() and not bool(torch.isfinite(v).all())]
            if (tuple(out['rcnn_cls'].shape) != (R, 1) or bad or out['rcnn_cls'].dtype !=
                    torch.float32 or delta != FWD_WANT[name]):
                raise AssertionError(f'{name} forward on scene {i}: rcnn_cls '
                                     f'{tuple(out["rcnn_cls"].shape)} {out["rcnn_cls"].dtype}, '
                                     f'non-finite {bad}, launches {delta}, expected '
                                     f'{FWD_WANT[name]}')
            outs[name] = out
            print(f'{name} forward scene {i}: {times[name][-1]:.2f} ms, rois '
                  f'{int(out["roi_counts"][0])}, launches {_fwd_launches(delta)}', flush=True)
        gaps = {k: float((outs['bf16'][k] - outs['exact'][k]).abs().max()) /
                float(outs['exact'][k].abs().max()) for k in ('backbone_features', 'rpn_cls')}
        print(f'  bf16 vs f32 on scene {i}: ' + ', '.join(f'{k} {v:.3e} of max|x|'
                                                          for k, v in gaps.items()), flush=True)
    for name in models:
        print(f'{name} forward, batch 1, in turns: median {statistics.median(times[name]):.2f} '
              f'ms over {len(times[name])} scenes; peak memory {peaks[name]:.2f} GiB', flush=True)
    del models
    total = collections.Counter(dict(zip(FWD_KERNELS, (c.launches for c in counters))))

    cfg = block_local_config(cfgs['bf16'])
    model = EPNet(cfg, 'TEST', device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    batch = device_batch(full_batch(cfg, 1, seed=0), dev)
    model.eval()(batch)  # warm-up
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    out = model(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    delta = [c.launches for c in counters]
    bad = [k for k, v in out.items() if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    if bad or delta != FWD_WANT['bf16 block-local'] or tuple(out['rcnn_cls'].shape) != (R, 1):
        raise AssertionError(f'bf16 block-local forward: non-finite {bad}, launches {delta}, '
                             f'expected {FWD_WANT["bf16 block-local"]}')
    print(f'bf16 block-local forward scene 0: {ms:.2f} ms, rois {int(out["roi_counts"][0])}, '
          f'launches {_fwd_launches(delta)}', flush=True)
    total.update(dict(zip(FWD_KERNELS, delta)))
    return total


def phase_small_bf16_reference(dev, over=None):
    """The tiny-width bf16 model on the card (kernels) against the CPU
    (plain versions) under identical weights; ``over``: the config's
    overrides (default ``utils/testing.MIXED_TINY``). Backbone and RPN
    outputs, then the RCNN fed the same pooled input (the CPU's RoIs,
    pooled on the CPU), each within 4 bf16 units of (1 + max|x|): both
    sides round to bf16 at the same places but sum in different orders."""
    import torch
    from epnet_tpu_torch.models.epnet import EPNet, pool_for_eval
    from epnet_tpu_torch.utils.testing import MIXED_TINY, tiny_config

    cfg = tiny_config(**(over or MIXED_TINY))
    name = 'block-local' if cfg.RPN.BLOCK_LOCAL else 'exact-query'
    cpu = EPNet(cfg, 'TEST', device='cpu', generator=torch.Generator().manual_seed(1)).eval()
    card = EPNet(cfg, 'TEST', device=dev).eval()
    card.load_state_dict(cpu.state_dict())
    batch = _tiny_batch(cfg)
    want = cpu(batch)
    got = card({k: v.to(dev) for k, v in batch.items()})
    with torch.no_grad():
        xyz = want['backbone_xyz']
        pooled = pool_for_eval(cfg, want['rois'], xyz, want['backbone_features'],
                               want['seg_result'], torch.linalg.norm(xyz, dim=2))
        want.update(cpu.rcnn(pooled))
        got.update(card.rcnn(pooled.to(dev)))
    ratios = {}
    for k in ('backbone_features', 'rpn_cls', 'rpn_reg', 'rcnn_cls', 'rcnn_reg'):
        diff = (got[k].cpu().float() - want[k].float()).abs()
        err = float(diff.max())
        bound = 4 * 2.0 ** -7 * (1.0 + float(want[k].abs().max()))
        ratios[k] = err / bound
        # where the worst element sits: its index, both values, and how many
        # elements differ at all
        at = tuple(int(i) for i in torch.nonzero(diff == diff.max())[0])
        print(f'  {k} {tuple(want[k].shape)}: {ratios[k]:.4f} of the bound, worst at {at} '
              f'(card {float(got[k].cpu()[at]):.6g}, CPU {float(want[k][at]):.6g}), '
              f'{int((diff > 0).sum())} of {diff.numel()} elements differ', flush=True)
        if not err <= bound:
            raise AssertionError(f'tiny {name} bf16 model on the card vs CPU: {k} off by '
                                 f'{err:.3e}')
    worst = max(ratios, key=ratios.get)
    same_rois = bool(torch.equal(got['rois'].cpu(), want['rois']))
    print(f'tiny {name} bf16 model, card vs CPU plain path: agree (worst {ratios[worst]:.3f} of '
          f'the bound 4 * 2^-7 * (1 + max|x|), set by {worst}); RoIs '
          f'{"identical" if same_rois else "differ"}', flush=True)


BL_KERNELS = ('fps', 'sa_fused_fwd', 'sa_fused_win_fwd', 'sa_fused_bwd', 'sa_fused_win_bwd',
              'conv3x3_dw_s2', 'conv3x3_dw_s1', 'conv3x3_s2_fwd')


def _bl_counters():
    from epnet_tpu_torch.ops import conv2d, fps, sa_fused
    return (fps.furthest_point_sample_kernel, sa_fused.fused_point_mlp_max_kernel,
            sa_fused.fused_point_mlp_max_win_kernel, sa_fused.fused_point_mlp_max_bwd_kernel,
            sa_fused.fused_point_mlp_max_win_bwd_kernel, conv2d.dw3x3_s2_kernel,
            conv2d.dw3x3_s1_kernel, conv2d.conv3x3_s2_fwd_kernel)


def phase_block_local(dev):
    """The block-local configuration's main path at full width, in turns
    with the exact configuration on the same weights and scenes (Morton-
    sorted, as the loader sorts them): three batch-1 TEST forwards, then a
    warm-up and three batch-4 train steps each."""
    import torch
    from epnet_tpu_torch.config import block_local_config, parity_config
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.train.trainer import create_train_state, device_batch, train_step
    from epnet_tpu_torch.utils.testing import full_batch

    cfgs = {'block-local': block_local_config(parity_config()), 'exact': parity_config()}
    want = {'block-local': ([6, 1, 1, 0, 0, 0, 0, 4], [6, 1, 1, 1, 1, 4, 3, 4]),
            'exact': ([6, 2, 0, 0, 0, 0, 0, 4], [6, 2, 0, 2, 0, 4, 3, 4])}
    counters = _bl_counters()
    gen = torch.Generator(device=dev).manual_seed(0)
    models = {'exact': EPNet(cfgs['exact'], 'TEST', device=dev, generator=gen).eval()}
    models['block-local'] = EPNet(cfgs['block-local'], 'TEST', device=dev).eval()
    models['block-local'].load_state_dict(models['exact'].state_dict())
    requests = {seed: device_batch(full_batch(cfgs['block-local'], 1, seed=seed), dev)
                for seed in (0, 1, 2)}
    for m in models.values():  # warm-up
        m(requests[0])
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0

    def timed(name, fn):
        before = [c.launches for c in counters]
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        return out, ms, peak, [c.launches - b for c, b in zip(counters, before)]

    times = {k: [] for k in cfgs}
    peaks = dict.fromkeys(cfgs, 0.0)
    for i, seed in enumerate((0, 1, 2)):
        for name in (('block-local', 'exact') if i % 2 == 0 else ('exact', 'block-local')):
            out, ms, peak, delta = timed(name, lambda: models[name](requests[seed]))
            times[name].append(ms)
            peaks[name] = max(peaks[name], peak)
            R = cfgs[name].TEST.RPN_POST_NMS_TOP_N
            if tuple(out['rcnn_cls'].shape) != (R, 1) or tuple(out['rois'].shape) != (1, R, 7):
                raise AssertionError(f'{name} forward: rois {tuple(out["rois"].shape)}')
            bad = [k for k, v in out.items()
                   if v.is_floating_point() and not bool(torch.isfinite(v).all())]
            if bad or delta != want[name][0]:
                raise AssertionError(f'{name} forward on scene {seed}: non-finite {bad}, '
                                     f'launches {delta}, expected {want[name][0]}')
            print(f'{name} forward scene {seed}: {ms:.2f} ms, rois {int(out["roi_counts"][0])}, '
                  f'launches ' + ' '.join(f'{n} +{d}' for n, d in zip(BL_KERNELS, delta) if d),
                  flush=True)
    for name in cfgs:
        print(f'{name} forward, batch 1, in turns: median {statistics.median(times[name]):.2f} '
              f'ms over {len(times[name])} scenes; peak memory {peaks[name]:.2f} GiB', flush=True)
    total = collections.Counter(dict(zip(BL_KERNELS, (c.launches for c in counters))))
    del models

    states = {name: create_train_state(cfg, total_steps=100, device=dev,
                                       generator=torch.Generator(device=dev).manual_seed(0))
              for name, cfg in cfgs.items()}
    states['block-local'].model.load_state_dict(states['exact'].model.state_dict())
    batches = {seed: device_batch(full_batch(cfgs['block-local'], TRAIN_BATCH, seed=seed,
                                             with_labels=True), dev) for seed in (3,) + TRAIN_SEEDS}
    gens = {name: torch.Generator(device=dev).manual_seed(1) for name in cfgs}
    for name in cfgs:  # warm-up
        train_step(states[name], batches[3], 0.1, gens[name])
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    times = {k: [] for k in cfgs}
    peaks = dict.fromkeys(cfgs, 0.0)
    for i, seed in enumerate(TRAIN_SEEDS):
        for name in (('block-local', 'exact') if i % 2 == 0 else ('exact', 'block-local')):
            params = list(states[name].model.parameters())
            old = [p.detach().clone() for p in params]
            tb, ms, peak, delta = timed(name, lambda: train_step(states[name], batches[seed], 0.1,
                                                                 gens[name]))
            times[name].append(ms)
            peaks[name] = max(peaks[name], peak)
            loss = float(tb['loss'])
            moved = sum(not torch.equal(a, p) for a, p in zip(old, params))
            if not math.isfinite(loss) or moved < 0.9 * len(params) or delta != want[name][1]:
                raise AssertionError(f'{name} train step on scene {seed}: loss {loss}, {moved} of '
                                     f'{len(params)} parameters moved, launches {delta}, '
                                     f'expected {want[name][1]}')
            print(f'{name} train step scene {seed}: {ms:.2f} ms, loss {loss:.4f}, rcnn fg '
                  f'{int(tb["rcnn_cls_fg"])}, {moved}/{len(params)} parameters moved, launches '
                  + ' '.join(f'{n} +{d}' for n, d in zip(BL_KERNELS, delta) if d), flush=True)
    for name in cfgs:
        print(f'{name} train step, batch {TRAIN_BATCH}, in turns: median '
              f'{statistics.median(times[name]):.2f} ms over {len(times[name])} steps; peak '
              f'memory {peaks[name]:.2f} GiB', flush=True)
    total.update(dict(zip(BL_KERNELS, (c.launches for c in counters))))
    return total


def _compare_detections(name, got, want):
    """Two CLI runs' detections (``_parse_results``): the same labels in
    every file, the numbers within 1e-3 (1 + |x|) + 1e-4 (one unit of the
    4 printed decimals). Returns (the worst share of that bound, the
    detections)."""
    import numpy as np
    worst, n = 0.0, 0
    for f, (names, w) in want.items():
        got_names, g = got[f]
        if got_names != names or g.shape != w.shape:
            raise AssertionError(f'{name}: {f}: {len(got_names)} vs {len(names)} detections')
        if names:
            worst = max(worst, float((np.abs(g - w) / (1e-3 * (1 + np.abs(w)) + 1e-4)).max()))
        n += len(names)
    if worst > 1.0:
        raise AssertionError(f'{name}: worst {worst:.3f} of the bound')
    return worst, n


def phase_small_cli(dev):
    """The CLI at tiny widths on the card and on the CPU, one checkpoint."""
    import numpy as np
    import yaml
    from epnet_tpu_torch.tools import eval as cli
    from epnet_tpu_torch.utils.testing import make_fake_kitti, tiny_config

    cfg = tiny_config(EXACT_QUERIES=True, RCNN={'SCORE_THRESH': 0.01},
                      TRAIN={'OPTIMIZER': 'adam_onecycle'})
    root = os.path.join(OUT, 'kitti_tiny')
    make_fake_kitti(root, n_samples=4, n_points=3000, seed=12)

    def plain(v):
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        return [plain(x) for x in v] if isinstance(v, (tuple, list)) else v

    cfg_file = os.path.join(OUT, 'tiny.yaml')
    with open(cfg_file, 'w') as f:
        yaml.safe_dump(plain(cfg.asdict()), f)
    ckpt = _save_weights(cfg, 'cpu', os.path.join(OUT, 'ckpt_tiny'), seed=1)
    rets, dets = {}, {}
    for where in ('cpu', str(dev)):
        out = os.path.join(OUT, f'eval_tiny_{where.replace(":", "")}')
        rets[where] = cli.main(['--cfg_file', cfg_file, '--data_root', root, '--ckpt', ckpt,
                                '--batch_size', '2', '--workers', '0', '--output_dir', out,
                                '--device', where])
        dets[where] = _parse_results(os.path.join(out, 'epoch_0', 'final_result', 'data'))
    if not all(names for names, _ in dets['cpu'].values()):
        raise AssertionError('tiny CLI on the CPU: a scene without detections')
    worst, n = _compare_detections('tiny CLI, card vs CPU', dets[str(dev)], dets['cpu'])
    recall = {k: v for k, v in rets['cpu'].items() if 'recall' in k}
    if any(rets[str(dev)][k] != v for k, v in recall.items()):
        raise AssertionError(f'tiny CLI, card vs CPU: recall {recall} vs {rets[str(dev)]}')
    print(f'tiny CLI, card vs CPU: {n} detections on 4 scenes agree (worst {worst:.3f} of '
          f'1e-3 x (1 + |x|) + 1e-4), recall equal', flush=True)


def _sa_bwd_bf16_bound(y, o, idx, w2, b2, w3, b3, gout, work, flagged_h2=0, flagged_max=0):
    """(ms, ms, ms) of C-bf16's (H-bf16's) work on these inputs: operations,
    this design's count of them, and bytes. The function's products (the
    recompute over each ball's distinct rows, the forward's count; layer
    2's two backward products over the live rows, dW2 in its two exact
    bf16 pieces; dW3 and dh2 on dp3's nonzeros, as ``_sa_bwd_bound`` counts
    them) all take bf16-valued operands summed in f32, so the bound counts
    them at the bf16 tensor-core peak and the elementwise work at the f32
    peak, the larger of the two pipes. The design's count: the recompute,
    dh2, dh1 and dW2's two pieces dense over the distinct rows at the bf16
    peak, beside the elementwise work, the certificates (~10 operations an
    element of p2 and p3), the dW3 gathers and the exact f32 FFMA sums of
    the flagged h2 elements (``flagged_h2``, C1 multiply-adds each) and
    maxima (``flagged_max``, C2 a distinct row of the centroid, counted as
    a whole ball) at the f32 peak. Bytes: the bf16 y, o, weights, gout, dy,
    do and dW, the f32 biases and db, and the indices."""
    T, N, C1 = y.shape
    _, M, S = idx.shape
    C2, C3 = w2.shape[-1], w3.shape[-1]
    nnz3, rows2, distinct, _ = work
    rows = int(_distinct_rows(idx)[1].sum())
    recompute = 2.0 * rows * (C1 * C2 + C2 * C3)
    elementwise = (rows * (2 * C1 + 2 * C2 + 3 * C3) + 3.0 * nnz3
                   + rows2 * (2 * C2 + 3 * C1))
    products = 2.0 * rows2 * C1 * C2 * 3 + 4.0 * nnz3 * C2  # dh1, dW2 in two pieces; dW3, dh2
    dense = recompute + 2.0 * rows * (C3 * C2 + C2 * C1 + 2 * C1 * C2)
    exact = (2.0 * flagged_h2 * C1 + 2.0 * flagged_max * (rows / max(T * M, 1)) * C2
             + 10.0 * rows * (C2 + C3) + 2.0 * nnz3 * C2)
    bf16_in = T * N * C1 + T * M * C1 + C1 * C2 + C2 * C3 + T * M * C3
    nbytes = 2 * (2 * bf16_in - T * M * C3) + 8 * (C2 + C3) + 8 * T * M * S
    return (_bound(elementwise, 0, recompute + products)[0],
            _bound(elementwise + exact, 0, dense)[0], _bound(0, nbytes)[1])


# dY and dO against the plain bf16 backward, element by element: each term
# of dY is bf16(dp1) and each term of dO the f32 dp1 = (bf16(dp2) W2^T)
# masked, where dp1 and dp2 are recomputed sums. Another summation order
# moves such a sum by f32 roundoff and so may flip its rounding to the
# neighbouring bf16 value, one unit in the last place, at most 2^-7 of the
# value. A flip of bf16(dp2)_j moves dp1_c by at most 2^-7 |bf16(dp2)_j|
# |W2_cj|; bf16(dp1) may then flip too. So |err dO| <= k 2^-7 sum_s P1_s
# and |err dY| <= k 2^-7 sum_s (|bf16(dp1_s)| + P1_s), with P1 = |bf16(dp2)|
# |W2|^T masked as dp1 and k = 1 + 2^-6 for the products' own f32 roundoff,
# plus SA_RTOL of max|.| for the f32 sums' order.
SA_FLIP_K = 1.0 + 2.0 ** -6


def _sa_bwd_bf16_flip_bounds(y, o, idx, w2, b2, w3, b3, gout):
    """The elementwise bounds on |err dY| (T, N, C1) and |err dO| (T, M,
    C1) above, from the plain bf16 backward's own arithmetic, in chunks of
    tables (before the SA_RTOL floor)."""
    import torch

    def r(t):
        return t.to(torch.bfloat16).float()
    T, N, C1 = y.shape
    _, M, S = idx.shape
    w2f, w3f = w2.float(), w3.float()
    dy = torch.zeros(T, N, C1, device=y.device)
    do = torch.empty(T, M, C1, device=y.device)
    for t in range(0, T, 32):  # ~0.5 GB of temporaries a chunk
        sl = slice(t, t + 32)
        n = y[sl].shape[0]
        g = torch.gather(y[sl].float(), 1, idx[sl].reshape(n, M * S, 1).expand(-1, -1, C1))
        g1 = g.reshape(n, M, S, C1) - o[sl].float()[:, :, None, :]
        h1 = r(torch.relu(g1))
        p2 = h1 @ w2f + b2
        p3 = r(torch.relu(p2)) @ w3f + b3
        h3 = torch.relu(p3)
        ties = (h3 == h3.amax(dim=2, keepdim=True)).float()
        dp3c = r(torch.where(p3 > 0, ties * (gout[sl, :, None, :] / ties.sum(dim=2,
                                                                              keepdim=True)), 0.0))
        dp2c = r(torch.where(p2 > 0, dp3c @ w3f.t(), 0.0))
        live = g1 > 0
        p1 = torch.where(live, dp2c.abs() @ w2f.abs().t(), 0.0)
        dp1c = r(torch.where(live, dp2c @ w2f.t(), 0.0))
        do[sl] = SA_FLIP_K * 2.0 ** -7 * p1.sum(dim=2)
        dy[sl].scatter_add_(1, idx[sl].reshape(n, M * S, 1).expand(-1, -1, C1),
                            (SA_FLIP_K * 2.0 ** -7 * (dp1c.abs() + p1)).reshape(n, M * S, C1))
    return dy, do


def _check_bwd_bf16(name, got, want, inputs, idx, gout):
    """C-bf16 or H-bf16 against its plain version: the outputs cast as the
    custom VJP casts them within BF16_ULPS bf16 units of max|.|; the f32
    sums dW2, db2, dW3 and db3 within SA_RTOL of their max (their terms
    are the same on both sides up to f32 roundoff, and dW2's the rare flip
    of bf16(dp2) within it); dY and dO, whose terms are roundings of
    recomputed sums, element by element within the flip bounds
    (``_sa_bwd_bf16_flip_bounds``) plus SA_RTOL of max|.|. Returns (the
    largest error in ulps after the cast, each output's relative error
    before it, dY's and dO's worst share of their bounds). ``inputs``: y,
    o, w2, b2, w3, b3; ``idx`` the table rows."""
    from epnet_tpu_torch.ops import sa_fused

    names = ('dy', 'do', 'dw2', 'db2', 'dw3', 'db3')
    rel = {k: float((x - z).abs().max()) / float(z.abs().max())
           for k, x, z in zip(names, got, want)}
    ulps = {}
    for k, x, z in zip(names, sa_fused.cast_grads(got, *inputs),
                       sa_fused.cast_grads(want, *inputs)):
        scale = float(z.float().abs().max())
        ulps[k] = float((x.float() - z.float()).abs().max()) / _bf16_ulp(scale)
    y, o, w2, b2, w3, b3 = inputs
    flips = {}
    for k, x, z, b in zip(('dy', 'do'), got, want,
                          _sa_bwd_bf16_flip_bounds(y, o, idx, w2, b2, w3, b3, gout)):
        flips[k] = float(((x - z).abs() / (b + SA_RTOL * float(z.abs().max()))).max())
    print(f'{name}: after the cast (bf16 ulps of max|.|) '
          + ', '.join(f'{k} {v:.3f}' for k, v in ulps.items())
          + '; f32 sums, max rel err ' + ', '.join(f'{k} {v:.2e}' for k, v in rel.items())
          + '; dy, do elementwise: worst ' + ', '.join(f'{v:.3f}' for v in flips.values())
          + ' of the flip bound', flush=True)
    bad = {k: v for k, v in ulps.items() if not v <= BF16_ULPS}
    bad.update({k: rel[k] for k in ('dw2', 'db2', 'dw3', 'db3') if not rel[k] <= SA_RTOL})
    bad.update({f'{k} flips': v for k, v in flips.items() if not v <= 1.0})
    if bad:
        raise AssertionError(f'{name} off its plain version: {bad}')
    return max(ulps.values()), rel, flips


def _run_bwd_bf16(name, kernel, plain, args, inputs, rows, work):
    """C-bf16 or H-bf16 (``kernel``) on ``args`` against ``plain``: the
    checks of ``_check_bwd_bf16``, dW/db of two launches bitwise equal, and
    0 max selections differing from the plain bf16 arithmetic's
    (``_sa_bwd_work(..., bf16=True)``, ``work``); prints the flagged
    shares, the h2 elements (of the distinct rows' C2) and the maxima (of
    the (centroid, channel) pairs) that the kernel summed exactly. Returns
    (max abs err, ulps after the cast, rel errs, flip-bound shares, the
    flagged shares, the flagged counts). ``inputs``: y, o, w2, b2, w3, b3;
    ``rows`` the table rows; args[-1] is gout."""
    import torch

    *got, sel, stats = kernel(*args, selections=True)
    again = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    ulps, rel, flips = _check_bwd_bf16(name, got, want, inputs, rows, args[-1])
    if not all(torch.equal(x, z) for x, z in zip(got[2:], again[2:])):
        raise AssertionError(f'{name}: dW/db differ between two launches')
    _, _, distinct, want_sel = work
    differ = int((sel != want_sel).sum())
    counts = [int(v) for v in stats.tolist()]
    shares = {'h2': counts[0] / (distinct * inputs[2].shape[-1]), 'maxima': counts[1] / sel.numel()}
    print(f'  {name}: max selections differing from the plain bf16 arithmetic: {differ} of '
          f'{sel.numel()}; flagged and summed exactly: {shares["h2"]:.4f} of the h2 elements, '
          f'{shares["maxima"]:.6f} of the maxima', flush=True)
    if differ:
        raise AssertionError(f'{name}: {differ} max selections differ from the plain bf16 '
                             f'arithmetic')
    abs_err = max(float((x - z).abs().max()) for x, z in zip(got, want))
    return abs_err, ulps, rel, flips, shares, counts


def _near_zero_b3(y, o, idx, w2, b2, w3, b3):
    """b3 that puts maxima of p3 just below 0: for each channel c, the
    largest h2 W3[:, c] of centroid c mod (T M) over its ball (h1 and h2
    rounded to bf16, as the plain bf16 arithmetic rounds them), negated and
    lifted by a 2^-(13 + c mod 8) share of itself, so that this centroid's
    max lies below 0 by a fraction or a few times the certificate's bound
    (in every table, where the tables repeat the first), and about half
    the centroids have no max in the channel; b3's own value where that
    largest sum is <= 0."""
    import torch

    T, M = idx.shape[:2]
    C3 = w3.shape[1]
    ch = torch.arange(C3, device=y.device)
    t, m = ch % (T * M) // M, ch % (T * M) % M
    h1 = torch.relu(y[t[:, None], idx[t, m]].float() - o[t, m][:, None].float())
    h2 = torch.relu(h1.bfloat16().float() @ w2.float() + b2).bfloat16().float()  # (C3, S, C2)
    q = (h2 * w3.float().t()[:, None, :]).sum(-1).amax(1)
    return torch.where(q > 0, -q * (1 + 2.0 ** -(13 + ch % 8).float()), b3)


def _wgmma_probe(dev):
    """The tensor cores' bf16 sums, as C-bf16's recompute runs them
    (``sa_fused.wgmma_sum_probe``: 64 x 128 by 128 x 64 tiles, each of the
    eight m64n64k16 steps from 0, added in f32), against exact f64 sums on three kinds of
    tiles: random (h1 = relu of normals against W2-like weights),
    magnitudes spread over 2^-20 .. 2^1 with random signs, and blocks whose
    large products cancel from one k16 step to the next while 15 small
    ones of full 16-bit significands are added beside them each step (the
    truncation that aligning to a large accumulator causes). Fails if any
    sum leaves gamma_tc S, S the sum of the products' magnitudes, with the
    gamma_tc that the kernel certifies with (the library's ``kGammaTc``:
    each k16 step from 0 and the eight step sums added in f32, (1.5 * 16
    2^-23 + 8 2^-24) at K = 128); returns each kind's largest |err| / S in
    units of 2^-23 and of gamma_tc."""
    import numpy as np
    import torch
    from epnet_tpu_torch.ops import sa_fused

    rng = np.random.RandomState(31)
    K, tiles = 128, 64

    def spread(*shape):
        return (rng.choice([-1.0, 1.0], shape) * 2.0 ** rng.randint(-20, 2, shape)
                * (1 + rng.randint(0, 128, shape) / 128))
    a_mant = 1 + rng.randint(0, 128, (tiles, 64, K)) / 128
    big = np.zeros((K, 64))
    big[0::16] = rng.choice([-1.0, 1.0], (K // 16, 64)) * np.where(
        np.arange(K // 16)[:, None] % 2 == 0, 1.0, -1.0)
    small = rng.choice([-1.0, 1.0], (K, 64)) * 2.0 ** -9 * (1 + rng.randint(0, 128, (K, 64)) / 128)
    kinds = {'random': (np.maximum(rng.randn(tiles, 64, K), 0), rng.randn(K, 64) / np.sqrt(K)),
             'spread': (spread(tiles, 64, K), spread(K, 64)),
             'cancelling': (a_mant, np.where(np.arange(K)[:, None] % 16 == 0, big, small))}
    out = {}
    for kind, (a, w) in kinds.items():
        at = torch.from_numpy(a).to(dev, torch.bfloat16)
        wt = torch.from_numpy(w).to(dev, torch.bfloat16)
        got, gamma_tc = sa_fused.wgmma_sum_probe(at, wt)
        got = got.double()
        a64, w64 = at.double(), wt.double()
        exact = a64 @ w64
        mag = a64.abs() @ w64.abs()
        ratio = float(((got - exact).abs() / mag.clamp_min(1e-300)).max())
        out[kind] = {'max_err_over_S_2^-23': ratio / 2.0 ** -23,
                     'max_err_over_gamma_tc_S': ratio / gamma_tc}
        print(f'wgmma bf16 sums ({kind}, {tiles} tiles of 64 x 64 sums, K = {K}): max |err| / S = '
              f'{ratio / 2.0 ** -23:.3f} x 2^-23, {ratio / gamma_tc:.4f} of gamma_tc',
              flush=True)
        if not ratio <= gamma_tc:
            raise AssertionError(f'wgmma sums leave the certificate\'s model ({kind}): '
                                 f'{ratio / gamma_tc:.3f} of gamma_tc')
    return out


def phase_bf16_bwd_kernels(dev):
    """The tensor cores' sums that C-bf16's certificate bounds
    (``_wgmma_probe``); C-bf16 at SA_TRAIN_SHAPES on random tables with
    ties (timed; the line's sum), on phase 5's real sa0 tables (timed,
    beside), on those tables with their rows in equal pairs, and on the
    first of them repeated with maxima just below 0 beside uneven row
    norms (``_near_zero_b3``); H-bf16 on
    phase 13's real windows at T = 256 (timed) and edge cases (each with 0
    max selections differing from the plain bf16 arithmetic, and its
    flagged shares: ``_run_bwd_bf16``); D-bf16
    and E-bf16 at DW_EDGE_SHAPES and DW_SHAPES (timed beside
    ``conv2d_weight`` in bf16, with the bytes their design and the first
    bf16 design bring into shared memory, ``_dw_bf16_smem_bytes``); each
    against its plain version
    (``_check_bwd_bf16``; the weight gradients' f32 sums within DW_RTOL
    of max|dw| and their bf16 cast within BF16_ULPS), dW/db of two
    launches bitwise equal."""
    import torch
    from epnet_tpu_torch.ops import conv2d, sa_fused

    bf = torch.bfloat16
    res = {}

    def timed(fns):
        row = dict.fromkeys(fns, 0.0)
        keys = list(fns)
        for key in keys + keys[::-1]:
            fn, reps = fns[key]
            row[key] += _time_ms(fn, reps) / 2
        return row

    def to_bf16(args):
        y, o, idx, w2, b2, w3, b3, gout = args
        return (y.to(bf), o.to(bf), idx, w2.to(bf), b2, w3.to(bf), b3,
                gout.to(bf).float())  # gout: a bf16 cotangent, widened as the VJP widens it

    probe = _wgmma_probe(dev)
    c_kernel = sa_fused.fused_point_mlp_max_bwd_bf16_kernel
    rows, max_err, ms, plain_ms, op_ms, byte_ms = [], 0.0, 0.0, 0.0, [], []
    design_sum = 0.0
    for name, (T, N, M, S, C1, C2, C3), kind, args in sa_cases(dev, train=True):
        args = to_bf16(args)
        work = _sa_bwd_work(*[a.float() if a.dtype == bf else a for a in args], bf16=True)
        abs_err, ulps, rel, flips, shares, counts = _run_bwd_bf16(
            f'C-bf16 {name} {(T, N, M, S, C1, C2, C3)}', c_kernel,
            sa_fused.fused_point_mlp_max_bwd_plain, args, args[:2] + args[3:7], args[2], work)
        o_ms, design_ms, b_ms = _sa_bwd_bf16_bound(*args, work=work, flagged_h2=counts[0],
                                                   flagged_max=counts[1])
        row = timed({'ms': (lambda: c_kernel(*args), 5),
                     'plain_ms': (lambda: sa_fused.fused_point_mlp_max_bwd_plain(*args), 3)})
        _, rows2, distinct, _ = work
        rows.append({'stage': name, 'shape': [T, N, M, S, C1, C2, C3], **row,
                     'bound_ms': max(o_ms, b_ms), 'design_count_ms': design_ms,
                     'max_ulps_after_cast': ulps, 'max_rel_err_f32': rel,
                     'flip_bound_share': flips, 'distinct_rows': distinct / (T * M * S),
                     'live_rows': rows2 / distinct, 'flagged_shares': shares,
                     'selections_differing': 0})
        print(f'  kernel {row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, bound '
              f'{max(o_ms, b_ms):.4f} ms (operations {o_ms:.4f}, bytes {b_ms:.4f}; this '
              f'design\'s count, its dense products at the bf16 peak beside the flagged exact '
              f'sums and the rest at the f32 peak, {design_ms:.4f}); distinct rows '
              f'{distinct / (T * M * S):.4f} of the samples, live rows '
              f'{rows2 / distinct:.4f} of the distinct', flush=True)
        if kind == 'real':
            # equal table rows at different indices tie exactly: the same
            # tables with every odd row a copy of the even one before it
            y2 = args[0].clone()
            y2[:, 1::2] = y2[:, 0::2]
            dup = (y2,) + args[1:]
            work = _sa_bwd_work(*[a.float() if a.dtype == bf else a for a in dup], bf16=True)
            _run_bwd_bf16(f'C-bf16 {name}, table rows in equal pairs', c_kernel,
                          sa_fused.fused_point_mlp_max_bwd_plain, dup, dup[:2] + dup[3:7],
                          dup[2], work)
            # maxima just below 0 beside uneven row norms, where a certificate
            # of "no max" must hold on every row, not the top's alone: the
            # first real table in every table, so that each channel's
            # near-0 max recurs T times, with its odd rows x 4
            y3, o3, i3 = (a[:1].repeat(T, 1, 1) for a in args[:3])
            y3[:, 1::2] *= 4  # exact in bf16
            near = (y3, o3, i3) + args[3:6] + (_near_zero_b3(y3, o3, i3, *args[3:7]), args[7])
            work = _sa_bwd_work(*[a.float() if a.dtype == bf else a for a in near], bf16=True)
            _run_bwd_bf16(f'C-bf16 {name}, maxima near 0, table 0 repeated, odd rows x 4',
                          c_kernel, sa_fused.fused_point_mlp_max_bwd_plain, near,
                          near[:2] + near[3:7], near[2], work)
            del y2, dup, y3, o3, i3, near
            continue  # beside the line's sum, which stays the random tables'
        max_err = max(max_err, abs_err)
        op_ms.append(o_ms)
        byte_ms.append(b_ms)
        design_sum = design_sum + max(design_ms, b_ms)
        ms, plain_ms = ms + row['ms'], plain_ms + row['plain_ms']
    res['C'] = {'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
                **_bound_keys(op_ms, byte_ms), 'design_count_ms': design_sum,
                'library_ms': None, 'per_shape': rows, 'wgmma_probe': probe}

    # H-bf16 on the real windows of a batch-4 train step, and edge cases
    W, tiles, _ = _sa_win_geometry()
    T, N, M, S, C1, C2, C3 = (256,) + SA_SHAPES['rcnn.sa0'][1:]
    gen = torch.Generator(device=dev).manual_seed(29)

    def f(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale)
    y, o = f(T, N, C1).to(bf), f(T, M, C1, scale=0.1).to(bf)
    w = (f(C1, C2, scale=C1 ** -0.5).to(bf), f(C2, scale=0.01),
         f(C2, C3, scale=C2 ** -0.5).to(bf), f(C3, scale=0.01))
    gout = f(T, M, C3).to(bf).float()
    h_kernel = sa_fused.fused_point_mlp_max_win_bwd_bf16_kernel
    max_err, real = 0.0, None
    for edge in (False, True):
        idx_rel, starts = _window_inputs(T, T + edge, dev, edge)
        args = (y, o, idx_rel, starts, *w, W, gout)
        real = real or args
        grows = sa_fused.window_rows(idx_rel, starts)
        work = _sa_bwd_work(y.float(), o.float(), grows, w[0].float(), w[1], w[2].float(), w[3],
                            gout, bf16=True)
        abs_err, ulps, rel, flips, shares, counts = _run_bwd_bf16(
            f'H-bf16 T={T} {"edge cases" if edge else "real windows"}', h_kernel,
            sa_fused.fused_point_mlp_max_win_bwd_plain, args, (y, o, *w), grows, work)
        max_err = max(max_err, abs_err)
        if not edge:
            real_ulps, real_rel, real_flips, real_work = ulps, rel, flips, work
            real_shares, real_counts = shares, counts
    args = real
    grows = sa_fused.window_rows(args[2], args[3])
    o_ms, design_ms, b_ms = _sa_bwd_bf16_bound(y, o, grows, *w, gout, work=real_work,
                                               flagged_h2=real_counts[0],
                                               flagged_max=real_counts[1])
    b_ms += _bound(0, 8 * args[3].numel())[1]  # the window starts
    row = timed({'ms': (lambda: h_kernel(*args), 5),
                 'plain_ms': (lambda: sa_fused.fused_point_mlp_max_win_bwd_plain(*args), 3),
                 'table_kernel_ms': (lambda: c_kernel(y, o, grows, *w, gout), 5)})
    _, rows2, distinct, _ = real_work
    print(f'  H-bf16 T={T}: kernel {row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, C-bf16 '
          f'on the global rows {row["table_kernel_ms"]:.4f} ms, bound {max(o_ms, b_ms):.4f} ms '
          f'(operations {o_ms:.4f}, bytes {b_ms:.4f}; this design\'s count {design_ms:.4f}); '
          f'distinct rows {distinct / (T * M * S):.4f} of the samples, live rows '
          f'{rows2 / distinct:.4f} of the distinct', flush=True)
    res['H'] = {'max_abs_err': max_err, 'ms': row['ms'], 'plain_ms': row['plain_ms'],
                **_bound_keys([o_ms], [b_ms]), 'design_count_ms': max(design_ms, b_ms),
                'library_ms': None,
                'per_shape': [{'stage': 'rcnn.sa0', 'shape': [T, N, M, S, C1, C2, C3],
                               'window': W, 'tiles': tiles, **row, 'bound_ms': max(o_ms, b_ms),
                               'design_count_ms': design_ms, 'max_ulps_after_cast': real_ulps,
                               'max_rel_err_f32': real_rel, 'flip_bound_share': real_flips,
                               'flagged_shares': real_shares, 'selections_differing': 0}]}

    # D-bf16 and E-bf16
    kernels = {2: (conv2d.dw3x3_s2_bf16_kernel, conv2d.dw3x3_s2_plain),
               1: (conv2d.dw3x3_s1_bf16_kernel, conv2d.dw3x3_s1_plain)}

    def check_dw(what, stride, x, dy):
        kernel, plain = kernels[stride]
        got, again, want = kernel(x, dy), kernel(x, dy), plain(x, dy)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        ulps = float((got.to(bf).float() - want.to(bf).float()).abs().max()) / _bf16_ulp(scale)
        if not (err <= DW_RTOL * scale and ulps <= BF16_ULPS and torch.equal(got, again)):
            raise AssertionError(f'{what}: f32 sum off by {err / scale:.3e} of max|dw|, '
                                 f'{ulps:.3f} bf16 ulps after the cast, or two launches differ')
        return err, err / scale, ulps

    worst = 0.0
    for _, shape, stride, x, dy in itertools.islice(dw_cases(dev), len(DW_EDGE_SHAPES)):
        _, rel, _ = check_dw(f'dw bf16 edge {shape} stride {stride}', stride, x.to(bf), dy.to(bf))
        worst = max(worst, rel)
    print(f'D-bf16 / E-bf16 at {len(DW_EDGE_SHAPES)} edge shapes: within {worst:.2e} of max|dw| '
          f'(f32 sums), bitwise reproducible', flush=True)
    rows = collections.defaultdict(list)
    for name, blk, stride, x, dy in itertools.islice(dw_cases(dev), len(DW_EDGE_SHAPES), None):
        x, dy = x.to(bf), dy.to(bf)
        kernel, plain = kernels[stride]
        B, H, Wd, C, Fo = DW_SHAPES[name][blk]
        pixels = B * (H // stride) * (Wd // stride)
        om, bm = _bound(0, 2 * (B * H * Wd * C + pixels * Fo + 9 * C * Fo),
                        2.0 * 9 * C * Fo * pixels)
        err, rel, ulps = check_dw(f'{name}_bf16 {blk}', stride, x, dy)
        smem_in, first_in = _dw_bf16_smem_bytes(B, H, Wd, C, Fo, stride)
        library = _library_dw_call(x, dy, stride)
        lib_rel = float((library().float() - plain(x, dy)).abs().max()) / float(
            plain(x, dy).abs().max())
        row = timed({'ms': (lambda: kernel(x, dy), 10), 'plain_ms': (lambda: plain(x, dy), 3),
                     'library_ms': (library, 10)})
        row.update(block=blk, shape=[B, H, Wd, C, Fo], bound_ms=max(om, bm), ops_ms=om,
                   bytes_ms=bm, max_abs_err=err, max_rel_err=rel, ulps_after_cast=ulps,
                   smem_in_bytes=smem_in, first_design_smem_in_bytes=first_in)
        rows[name].append(row)
        print(f'{name}_bf16 {blk} x {(B, H, Wd, C)} -> dy F {Fo}: f32 sum {rel:.2e} of max|dw|, '
              f'{ulps:.3f} bf16 ulps after the cast; conv2d_weight bf16 {lib_rel:.2e}; kernel '
              f'{row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, conv2d_weight bf16 '
              f'{row["library_ms"]:.4f} ms (kernel / library {row["ms"] / row["library_ms"]:.3f}), '
              f'bound {max(om, bm):.4f} ms (bf16 products {om:.4f}, HBM bytes {bm:.4f}); into '
              f'shared memory {smem_in / 1e6:.1f} MB, the first design\'s {first_in / 1e6:.1f} MB '
              f'({first_in / smem_in:.2f}x), {smem_in / row["ms"] / 1e9:.2f} TB/s', flush=True)
        del x, dy, library
    for name, r in rows.items():
        tot = {k: sum(v[k] for v in r) for k in ('ms', 'plain_ms', 'library_ms')}
        res[name] = {'max_abs_err': max(v['max_abs_err'] for v in r), **tot,
                     **_bound_keys([v['ops_ms'] for v in r], [v['bytes_ms'] for v in r]),
                     'per_shape': r}
        print(f'{name}_bf16: kernel {tot["ms"]:.4f} ms, conv2d_weight bf16 '
              f'{tot["library_ms"]:.4f} ms (kernel / library {tot["ms"] / tot["library_ms"]:.3f}), '
              f'bound {res[name]["bound_ms"]:.4f} ms', flush=True)
    return res


BF16_TRAIN_KERNELS = ('fps', 'sa_fused_fwd_bf16', 'sa_fused_win_fwd_bf16', 'sa_fused_bwd_bf16',
                      'sa_fused_win_bwd_bf16', 'conv3x3_dw_s2_bf16', 'conv3x3_dw_s1_bf16',
                      'conv3x3_s2_fwd_bf16', 'sa_fused_fwd', 'sa_fused_bwd', 'conv3x3_dw_s2',
                      'conv3x3_dw_s1', 'conv3x3_s2_fwd')  # a bf16 or f32 step's, by name
# the launches of one train step, by configuration
BF16_TRAIN_WANT = {'bf16': [6, 2, 0, 2, 0, 4, 3, 4, 0, 0, 0, 0, 0],
                   'bf16 block-local': [6, 1, 1, 1, 1, 4, 3, 4, 0, 0, 0, 0, 0],
                   'f32': [6, 0, 0, 0, 0, 0, 0, 0, 2, 2, 4, 3, 4],
                   'f32 block-local': None}


def _bf16_train_counters():
    from epnet_tpu_torch.ops import conv2d, fps, sa_fused
    return (fps.furthest_point_sample_kernel, sa_fused.fused_point_mlp_max_bf16_kernel,
            sa_fused.fused_point_mlp_max_win_bf16_kernel,
            sa_fused.fused_point_mlp_max_bwd_bf16_kernel,
            sa_fused.fused_point_mlp_max_win_bwd_bf16_kernel, conv2d.dw3x3_s2_bf16_kernel,
            conv2d.dw3x3_s1_bf16_kernel, conv2d.conv3x3_s2_fwd_bf16_kernel,
            sa_fused.fused_point_mlp_max_kernel, sa_fused.fused_point_mlp_max_bwd_kernel,
            conv2d.dw3x3_s2_kernel, conv2d.dw3x3_s1_kernel, conv2d.conv3x3_s2_fwd_kernel)


def phase_bf16_train(dev):
    """The bf16 train step (the recipe with ``MIXED_PRECISION``) at full
    width, in turns with the f32 step on the same initial weights: a
    warm-up, then three batch-4 steps each on scenes 0/1/2 (6 FPS, 2
    B-bf16, 2 C-bf16, 4 D-bf16, 3 E-bf16 and 4 F-bf16 launches a bf16
    step, no f32 B, C, D, E or F), medians and peak memory; then the same
    for the block-local configuration in bf16 (1 B-bf16, 1 G-bf16, 1
    C-bf16, 1 H-bf16 a step) on Morton-sorted scenes. Each step: a finite
    loss and gradients, f32 parameters that moved."""
    import torch
    from epnet_tpu_torch.config import block_local_config, parity_config
    from epnet_tpu_torch.train.trainer import create_train_state, train_step

    counters = _bf16_train_counters()
    total = collections.Counter()
    for layout in ('exact', 'block-local'):
        cfgs = {'f32': parity_config(), 'bf16': parity_config().with_overrides([MIXED_SET])}
        if layout == 'block-local':
            cfgs = {k: block_local_config(c) for k, c in cfgs.items()}
        states = {k: create_train_state(c, total_steps=100, device=dev,
                                        generator=torch.Generator(device=dev).manual_seed(0))
                  for k, c in cfgs.items()}
        states['bf16'].model.load_state_dict(states['f32'].model.state_dict())
        if torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
            raise AssertionError('the bf16 EPNet left bf16 split-K reductions in bf16')
        gen = torch.Generator(device=dev).manual_seed(1)
        batches = {seed: _train_batch(cfgs['f32'], seed, dev) for seed in (3,) + TRAIN_SEEDS}
        for k in ('bf16', 'f32'):  # warm-up
            train_step(states[k], batches[3], 0.1, gen)
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        times, peaks = {k: [] for k in states}, dict.fromkeys(states, 0.0)
        for i, seed in enumerate(TRAIN_SEEDS):
            for k in (('bf16', 'f32') if i % 2 == 0 else ('f32', 'bf16')):
                name = k if layout == 'exact' else f'{k} block-local'
                params = list(states[k].model.parameters())
                old = [p.detach().clone() for p in params]
                before = [c.launches for c in counters]
                torch.cuda.reset_peak_memory_stats(dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tb = train_step(states[k], batches[seed], 0.1, gen)
                torch.cuda.synchronize()
                times[k].append((time.perf_counter() - t0) * 1e3)
                peaks[k] = max(peaks[k], torch.cuda.max_memory_allocated(dev) / 2 ** 30)
                delta = [c.launches - b for c, b in zip(counters, before)]
                loss = float(tb['loss'])
                moved = sum(not torch.equal(a, p) for a, p in zip(old, params))
                bad = [n for n, p in states[k].model.named_parameters()
                       if p.grad is not None and (p.grad.dtype != torch.float32
                                                  or not bool(torch.isfinite(p.grad).all()))]
                want = BF16_TRAIN_WANT[name]
                if (not math.isfinite(loss) or bad or moved < 0.9 * len(params)
                        or (want is not None and delta != want)):
                    raise AssertionError(f'{name} train step on scene {seed}: loss {loss}, '
                                         f'bad gradients {bad[:5]}, {moved} of {len(params)} '
                                         f'parameters moved, launches {delta}, expected {want}')
                if k == 'bf16':
                    total.update(dict(zip(BF16_TRAIN_KERNELS, delta)))
                print(f'{name} train step scene {seed}: {times[k][-1]:.2f} ms, loss {loss:.4f} '
                      f'(rpn {float(tb["rpn_loss"]):.4f}, rcnn {float(tb["rcnn_loss"]):.4f}), '
                      f'grad norm {float(tb["grad_norm"]):.3f}, launches '
                      + ' '.join(f'{n} +{d}' for n, d in zip(BF16_TRAIN_KERNELS, delta) if d),
                      flush=True)
        for k in states:
            print(f'{layout} {k} train step, batch {TRAIN_BATCH}, in turns: median '
                  f'{statistics.median(times[k]):.2f} ms over {len(times[k])} steps; peak '
                  f'memory {peaks[k]:.2f} GiB', flush=True)
        del states, batches
    return total


def phase_small_bf16_train_reference(dev, over=None):
    """One tiny-width bf16 train step, card (kernels) vs CPU (plain
    versions), identical weights, dropout 0 and identical sampled RoIs
    (``utils/testing.MIXED_TRAIN_TINY``, or ``over``). Batch-statistics
    BatchNorm makes the bf16 backbone chaotic (a value rounded to the
    neighbouring bf16 number moves ReLU inputs across 0:
    tests/test_torch_bf16_train.py measures JAX's own spread), so the card
    is held within the CPU's own bf16 rounding effect: the same step on the
    CPU in f32, same weights and RoIs. Each of the loss, the RPN outputs,
    the RPN heads' and the RCNN's worst gradient leaf and the backbone
    gradient's norm share: card vs CPU at most CPU bf16 vs CPU f32."""
    from unittest import mock

    import numpy as np
    import torch
    from epnet_tpu_torch.models import epnet as epnet_mod
    from epnet_tpu_torch.train.loss import joint_loss
    from epnet_tpu_torch.utils.testing import MIXED_TRAIN_TINY, synthetic_batch, tiny_config

    cfg = tiny_config(**(over or MIXED_TRAIN_TINY))
    cfg32 = cfg.merged({'MIXED_PRECISION': False})
    cpu = epnet_mod.EPNet(cfg, 'TRAIN', device='cpu',
                          generator=torch.Generator().manual_seed(1)).train()
    card = epnet_mod.EPNet(cfg, 'TRAIN', device=dev)
    cpu32 = epnet_mod.EPNet(cfg32, 'TRAIN', device='cpu')
    for m in (card, cpu32):
        m.load_state_dict(cpu.state_dict())
        m.train()
    batch = synthetic_batch(np.random.RandomState(3), cfg, batch=2, structured=True)
    recorded, real = [], epnet_mod.proposal_target_layer

    def record(*args, **kwargs):
        recorded.append(real(*args, **kwargs))
        return recorded[-1]

    def step(model, c, b, layer):
        with mock.patch.object(epnet_mod, 'proposal_target_layer', layer):
            out = model(b, generator=torch.Generator(device=model.rcnn.cls_out.weight.device)
                        .manual_seed(2))
        loss, _ = joint_loss(c, out, b)
        loss.backward()
        return {'loss': float(loss.detach()),
                **{k: out[k].detach().float().cpu() for k in ('rpn_cls', 'rpn_reg')},
                'grads': {n: p.grad.detach().cpu() for n, p in model.named_parameters()}}

    want = step(cpu, cfg, {k: torch.from_numpy(v) for k, v in batch.items()}, record)
    targets = recorded[0]
    on_card = type(targets)(*(t.to(dev) for t in targets))
    f32 = type(targets)(*(t.float() if t.dtype == torch.bfloat16 else t for t in targets))
    got = step(card, cfg, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
               lambda *a, **k: on_card)
    ref32 = step(cpu32, cfg32, {k: torch.from_numpy(v) for k, v in batch.items()},
                 lambda *a, **k: f32)

    def gaps(a, b):
        g = b['grads']
        gmax = max(float(x.abs().max()) for x in g.values())
        err = {n: float((a['grads'][n] - x).abs().max()) / max(float(x.abs().max()),
                                                               1e-2 * gmax)
               for n, x in g.items()}
        bb = [n for n in g if n.startswith('rpn.backbone.')]
        diff2 = sum(float(((a['grads'][n] - g[n]).double() ** 2).sum()) for n in bb)
        norm2 = sum(float((g[n].double() ** 2).sum()) for n in bb)
        return {'loss': abs(a['loss'] - b['loss']) / abs(b['loss']),
                **{k: float((a[k] - b[k]).abs().max()) / float(b[k].abs().max())
                   for k in ('rpn_cls', 'rpn_reg')},
                'rpn_heads': max(err[n] for n in g if n.startswith('rpn.') and n not in bb),
                'rcnn': max(err[n] for n in g if n.startswith('rcnn.')),
                'backbone_norm': math.sqrt(diff2 / norm2)}

    card_gap, bf16_gap = gaps(got, want), gaps(want, ref32)
    name = 'block-local' if cfg.RPN.BLOCK_LOCAL else 'exact'
    print(f'tiny {name} bf16 train step, card vs CPU: '
          + ', '.join(f'{k} {v:.3e}' for k, v in card_gap.items())
          + '; CPU bf16 vs CPU f32: ' + ', '.join(f'{k} {v:.3e}' for k, v in bf16_gap.items()),
          flush=True)
    bad = {k: (v, bf16_gap[k]) for k, v in card_gap.items() if not v <= bf16_gap[k]}
    if bad:
        raise AssertionError(f'tiny {name} bf16 train step: the card and the CPU disagree '
                             f'beyond bf16 rounding: {bad}')


# the train CLI (phase 24): a tree of 20 training and 4 val scenes at the
# pin's 14000 points, batch 4, so 5 steps an epoch and step 10 (the first
# scalars) in a run's second epoch. The RPN run trains 100 steps first: a
# random RPN's proposals overlap no car, so the RCNN would be sampled no
# foreground RoI; the later runs start from it by --rpn_ckpt
TRAIN_CLI_SCENES, TRAIN_CLI_VAL, TRAIN_CLI_POINTS = 20, 4, 14000
TRAIN_CLI_RPN_EPOCHS = 20
TRAIN_CLI_KERNELS = ('fps', 'sa_fused_fwd', 'sa_fused_bwd', 'conv3x3_dw_s2', 'conv3x3_dw_s1',
                     'conv3x3_s2_fwd', 'sa_fused_fwd_bf16', 'sa_fused_bwd_bf16',
                     'conv3x3_dw_s2_bf16', 'conv3x3_dw_s1_bf16', 'conv3x3_s2_fwd_bf16')
# a step's RCNN RoIs: labelled foreground and background, and regressed
RCNN_ROI_COUNTS = ('rcnn_cls_fg', 'rcnn_cls_bg', 'rcnn_reg_fg')
# the launches of one batch-4 train step by run: the RPN alone has 4 FPS
# stages and no RCNN; the fixed RPN runs no backward, so no D or E
TRAIN_CLI_WANT = {'rcnn_online': [6, 2, 2, 4, 3, 4, 0, 0, 0, 0, 0],
                  'resume': [6, 2, 2, 4, 3, 4, 0, 0, 0, 0, 0],
                  'rpn': [4, 0, 0, 4, 3, 4, 0, 0, 0, 0, 0],
                  'rcnn': [6, 2, 2, 0, 0, 4, 0, 0, 0, 0, 0],
                  'bf16': [6, 0, 0, 0, 0, 0, 2, 2, 4, 3, 4]}


class _TimedPasses:
    """The train loader, noting when each pass is asked for. Patched in by
    this script."""

    def __init__(self, loader, starts):
        self.loader, self.starts = loader, starts

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        self.starts.append(time.perf_counter())
        return iter(self.loader)


def _train_cli_counters():
    from epnet_tpu_torch.ops import conv2d, fps, sa_fused
    return (fps.furthest_point_sample_kernel, sa_fused.fused_point_mlp_max_kernel,
            sa_fused.fused_point_mlp_max_bwd_kernel, conv2d.dw3x3_s2_kernel,
            conv2d.dw3x3_s1_kernel, conv2d.conv3x3_s2_fwd_kernel,
            sa_fused.fused_point_mlp_max_bf16_kernel, sa_fused.fused_point_mlp_max_bwd_bf16_kernel,
            conv2d.dw3x3_s2_bf16_kernel, conv2d.dw3x3_s1_bf16_kernel,
            conv2d.conv3x3_s2_fwd_bf16_kernel)


def _train_run(name, argv, counters, want, check_rois=True):
    """One in-process run of the train CLI with ``argv``, each step timed
    with its launches (of ``counters``, each step's against ``want``), its
    loss, its RCNN RoI counts (with ``check_rois``: every step labelled,
    foreground in at least half) and its frames' gt boxes; prints steps/s,
    each pass's time to its first batch and the run's wall time. Returns
    the record: ``steps`` (start, end, loss, launches, RoI counts, gt boxes
    a frame, sample ids), ``starts``, ``start``, ``state``, ``wall``."""
    from unittest import mock

    from epnet_tpu_torch.tools import train as cli
    from epnet_tpu_torch.train import trainer as trainer_mod

    real_step, real_train = trainer_mod.train_step, trainer_mod.Trainer.train
    rec = {'steps': [], 'starts': []}

    def step(state, batch, bnm, gen, mesh=None):
        before = [c.launches for c in counters]
        t_start = time.perf_counter()
        tb = real_step(state, batch, bnm, gen, mesh)
        loss = float(tb['loss'])  # waits for the step
        gt = batch.get('gt_boxes3d')
        rec['steps'].append((t_start, time.perf_counter(), loss,
                             [c.launches - b for c, b in zip(counters, before)],
                             [int(tb[k]) for k in RCNN_ROI_COUNTS if k in tb],
                             [] if gt is None else (gt.abs().sum(-1) > 0).sum(-1).tolist(),
                             batch['sample_id'].tolist()))
        return tb

    def train(self, start_epoch, n_epochs, loader, **kwargs):
        rec['start'] = (start_epoch, self.state.step)
        return real_train(self, start_epoch, n_epochs, _TimedPasses(loader, rec['starts']),
                          **kwargs)

    t_run = time.perf_counter()
    with mock.patch.object(trainer_mod, 'train_step', step), \
            mock.patch.object(trainer_mod.Trainer, 'train', train):
        rec['state'] = cli.main(argv)
    rec['wall'] = time.perf_counter() - t_run
    steps = rec['steps']
    losses = [s[2] for s in steps]
    bad = [i for i, s in enumerate(steps) if s[3] != want]
    if not steps or not all(math.isfinite(v) for v in losses) or bad:
        raise AssertionError(f'train CLI {name}: losses {losses}, launches '
                             f'{[s[3] for s in steps]}, expected {want}')
    rois = [s[4] for s in steps]  # (cls fg, cls bg, reg fg) a step
    if check_rois and (not all(r[0] + r[1] > 0 for r in rois)
                       or 2 * sum(r[0] > 0 and r[2] > 0 for r in rois) < len(rois)):
        raise AssertionError(f'train CLI {name}: the RCNN was sampled (fg, bg, reg fg) '
                             f'RoIs {rois}: unlabelled, or foreground in under half the '
                             f'steps')
    # a pass's first batch waits for its workers to start and draw it
    firsts = [min(s[0] for s in steps if s[0] >= p) - p for p in rec['starts']]
    busy = sum(s[1] - s[0] for s in steps)
    loop = steps[-1][1] - rec['starts'][0]
    # the wait for each later batch of a pass: the loader's lag behind the steps
    gaps = [b[0] - a[1] for a, b in zip(steps, steps[1:])
            if not any(a[1] <= p <= b[0] for p in rec['starts'])]
    print(f'train CLI {name}: {len(steps)} steps, {len(steps) / busy:.3f} steps/s in the '
          f'steps, {len(steps) / loop:.3f} steps/s over the loop (loader and checkpoints '
          f'included); first batch of each pass after '
          + ', '.join(f'{f:.2f}' for f in firsts) + ' s; a later batch waited '
          + (f'{statistics.median(gaps) * 1e3:.1f} ms (median), {max(gaps) * 1e3:.1f} ms (max)'
             if gaps else '-') + '; step ms '
          + ', '.join(f'{(s[1] - s[0]) * 1e3:.1f}' for s in steps)
          + f'; losses {", ".join(f"{v:.4f}" for v in losses)}'
          + ('' if not check_rois else '; RCNN RoIs (fg, bg, reg fg) '
             + ' '.join(f'({a},{b},{c})' for a, b, c in rois))
          + f'; main() {rec["wall"]:.2f} s', flush=True)
    return rec


def phase_train_cli(dev):
    """The train CLI (``epnet_tpu_torch.tools.train.main``) on the card at
    the recipe's full width (f32; 16384 points, batch 4, 2 loader workers)
    on a synthetic tree of 20 training and 4 val scenes: ``rpn`` for 20
    epochs (100 steps); from its RPN by ``--rpn_ckpt``, ``rcnn_online`` for
    2 epochs; a ``--ckpt`` resume of its last checkpoint for a third epoch
    with ``--train_with_eval``; ``rcnn`` for 1 epoch; one epoch with ``--set
    MIXED_PRECISION True``. Checks finite losses, each step's launches,
    that every RCNN step was sampled labelled RoIs and at least half of a
    run's steps foreground ones (``rcnn_cls_fg``, ``rcnn_reg_fg``),
    ``train/*`` and ``val/*`` in ``scalars.jsonl``, checkpoint epochs 0, 1,
    2 (JAX's numbering at the default interval), the resume at the saved
    epoch + 1 and step count, and under ``rcnn`` the RPN's parameters moved
    by AdamW's decay alone (its BN statistics unchanged); prints steps/s,
    the time to each pass's first batch and each run's and the phase's
    wall time."""
    import shutil

    import torch
    from epnet_tpu_torch.train.schedules import one_cycle_lr
    from epnet_tpu_torch.utils.testing import make_fake_kitti

    t_phase = time.perf_counter()
    work = os.path.join(OUT, 'train_cli')
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, 'kitti')
    t0 = time.perf_counter()
    make_fake_kitti(root, n_samples=TRAIN_CLI_SCENES, n_val=TRAIN_CLI_VAL,
                    n_points=TRAIN_CLI_POINTS, seed=12, max_cars=4)
    print(f'train CLI: fake KITTI tree of {TRAIN_CLI_SCENES} + {TRAIN_CLI_VAL} scenes written '
          f'in {time.perf_counter() - t0:.2f} s', flush=True)
    counters = _train_cli_counters()
    for c in counters:
        c.launches = 0
    base = ['--cfg_file', RECIPE, '--data_root', root, '--batch_size', str(TRAIN_BATCH),
            '--workers', '2', '--device', str(dev)]

    def run(name, out, extra):
        return _train_run(name, base + ['--output_dir', out] + extra, counters,
                          TRAIN_CLI_WANT[name], check_rois=name != 'rpn')

    rpn_out = os.path.join(work, 'rpn')
    run('rpn', rpn_out, ['--epochs', str(TRAIN_CLI_RPN_EPOCHS), '--train_mode', 'rpn'])
    rpn_ckpt = os.path.join(rpn_out, 'ckpt', f'checkpoint_epoch_{TRAIN_CLI_RPN_EPOCHS - 1}.pth')
    warm_start = ['--rpn_ckpt', rpn_ckpt]

    joint_out = os.path.join(work, 'rcnn_online')
    ckpt_dir = os.path.join(joint_out, 'ckpt')
    run('rcnn_online', joint_out, ['--epochs', '2'] + warm_start)
    resume = run('resume', joint_out, [
        '--epochs', '3', '--ckpt', os.path.join(ckpt_dir, 'checkpoint_epoch_1.pth'),
        '--train_with_eval', '--set', 'TRAIN.VAL_SPLIT', 'val'])
    steps_per_epoch = TRAIN_CLI_SCENES // TRAIN_BATCH
    if resume['start'] != (2, 2 * steps_per_epoch) or resume['state'].step != 3 * steps_per_epoch:
        raise AssertionError(f'train CLI resume: started at (epoch, step) {resume["start"]}, '
                             f'ended at step {resume["state"].step}')
    ckpts = sorted(os.listdir(ckpt_dir))
    if ckpts != [f'checkpoint_epoch_{e}.pth' for e in range(3)]:
        raise AssertionError(f'train CLI checkpoints: {ckpts}')
    with open(os.path.join(joint_out, 'tensorboard', 'scalars.jsonl')) as f:
        scalars = [json.loads(line) for line in f]
    tags = collections.Counter(r['tag'].split('/')[0] for r in scalars)
    val = {r['tag']: r['value'] for r in scalars if r['tag'].startswith('val/')}
    if (not tags['train'] or not tags['val'] or set(tags) != {'train', 'val'}
            or not all(math.isfinite(r['value']) for r in scalars)):
        raise AssertionError(f'train CLI scalars: {tags}')
    print(f'train CLI scalars: {dict(tags)} records; val at epoch 2: rpn_iou '
          f'{val["val/rpn_iou"]:.4f}, rcnn_recall(0.5) {val["val/rcnn_recall(thresh=0.50)"]:.4f}',
          flush=True)

    rcnn = run('rcnn', os.path.join(work, 'rcnn'),
               ['--epochs', '1', '--train_mode', 'rcnn'] + warm_start)
    warm = torch.load(rpn_ckpt, map_location=dev, weights_only=True)['model']
    cfg = rcnn['state'].model.cfg
    lr = one_cycle_lr(steps_per_epoch, cfg.TRAIN.LR, cfg.TRAIN.DIV_FACTOR, cfg.TRAIN.PCT_START)
    factor = math.prod(1 - lr(t) * cfg.TRAIN.WEIGHT_DECAY for t in range(steps_per_epoch))
    params = {n for n, _ in rcnn['state'].model.named_parameters()}
    # each step takes lr_t * WEIGHT_DECAY * p off p, a few f32 units in
    # the last place of p: held element by element within the roundings,
    # and as the least-squares shrink of all of them, where they average out
    worst, num, den = 0.0, 0.0, 0.0
    for k, x in rcnn['state'].model.state_dict().items():
        if not k.startswith('rpn.'):
            continue
        if k not in params:
            if not torch.equal(x, warm[k]):
                raise AssertionError(f'train CLI rcnn: the fixed RPN\'s {k} changed')
            continue
        w = warm[k].double()
        worst = max(worst, float((x - warm[k] * factor).abs().max())
                    / max(float(warm[k].abs().max()), 1e-30))
        num += float((w * (w - x.double())).sum())
        den += float((w * w).sum())
    shrink = num / den
    if not (worst <= 1e-6 and abs(shrink / (1 - factor) - 1) <= 0.05):
        raise AssertionError(f'train CLI rcnn: the fixed RPN moved beyond the decay: worst '
                             f'{worst:.3e} of a tensor\'s max, shrink {shrink:.4e} against '
                             f'{1 - factor:.4e}')
    print(f'train CLI rcnn: the fixed RPN moved by the decay alone: shrink {shrink:.4e} '
          f'against 1 - prod(1 - lr_t WEIGHT_DECAY) = {1 - factor:.4e} over {steps_per_epoch} '
          f'steps, worst element {worst:.2e} of its tensor\'s max from it; BN statistics '
          f'unchanged', flush=True)

    run('bf16', os.path.join(work, 'bf16'), ['--epochs', '1'] + warm_start + ['--set', *MIXED_SET])
    snaps = [c.launches for c in counters]
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True, timeout=60).stdout
    print(f'train CLI phase on {card.strip().splitlines()[0]}: '
          f'{time.perf_counter() - t_phase:.1f} s wall; launches '
          + ' '.join(f'{n} +{d}' for n, d in zip(TRAIN_CLI_KERNELS, snaps) if d), flush=True)
    return dict(zip(TRAIN_CLI_KERNELS, snaps))


# the LiDAR-only two-phase flow (phase 25): cfgs/default.yaml on a tree like
# phase 24's, the RPN trained 100 steps with the gt paste so that its
# proposals overlap cars (the offline RCNN is sampled foreground RoIs from
# them); the evals read the tree in the main process (--workers 0: a pass of
# at most 5 batches would wait ~7 s for spawned workers)
LIDAR_RECIPE = 'cfgs/default.yaml'
FLOW_RPN_EPOCHS = 20
FLOW_OFFLINE_EPOCHS = 2
NO_IMAGE = [0] * 8  # D, E, F and the bf16 instances: LiDAR only, f32
FLOW_WANT = {'rpn': [4, 0, 0] + NO_IMAGE, 'rcnn_online': [6, 2, 2] + NO_IMAGE,
             'rcnn_offline': [2, 2, 2] + NO_IMAGE, 'rpn_eval': [4, 0, 0] + NO_IMAGE,
             'offline_eval': [2, 2, 0] + NO_IMAGE}
OFFLINE_TINY = {'RPN': {'ENABLED': False},
                'RCNN': {'ENABLED': True, 'ROI_SAMPLE_JIT': False, 'SCORE_THRESH': 1e-7}}


def _eval_run(name, argv, counters, step_module, step_name):
    """One in-process run of the eval CLI, each call of ``step_module``'s
    ``step_name`` (a batch or a frame) checked for ``FLOW_WANT[name]``'s
    launches. Returns (result, calls, wall seconds)."""
    from unittest import mock

    from epnet_tpu_torch.tools import eval as eval_cli

    real, calls = getattr(step_module, step_name), []

    def step(*args):
        before = [c.launches for c in counters]
        out = real(*args)
        calls.append([c.launches - b for c, b in zip(counters, before)])
        return out

    t0 = time.perf_counter()
    with mock.patch.object(step_module, step_name, step):
        ret = eval_cli.main(argv)
    wall = time.perf_counter() - t0
    bad = [c for c in calls if c != FLOW_WANT[name]]
    if not calls or bad:
        raise AssertionError(f'{name}: launches {calls}, expected {FLOW_WANT[name]} each')
    return ret, calls, wall


def _own_cars(root, sid):
    """The Car and Van lines of a frame's label file."""
    with open(os.path.join(root, 'KITTI', 'object', 'training', 'label_2',
                           '%06d.txt' % sid)) as f:
        return sum(1 for line in f if line.startswith(('Car ', 'Van ')))


def _host_item_ms(dataset, n, parts=()):
    """Median host ms of ``dataset[i]`` over its first ``n`` items, and the
    mean ms an item of each of ``parts``, (module, function name) pairs
    timed inside it."""
    from unittest import mock

    spent = collections.Counter()

    def timed(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] += time.perf_counter() - t0
        return run

    times = []
    with contextlib.ExitStack() as stack:
        for mod, fn in parts:
            wrapped = timed(fn, getattr(mod, fn))
            if isinstance(inspect.getattr_static(mod, fn), staticmethod):
                wrapped = staticmethod(wrapped)
            stack.enter_context(mock.patch.object(mod, fn, wrapped))
        for i in range(n):
            t0 = time.perf_counter()
            dataset[i]
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), {k: v * 1e3 / n for k, v in spent.items()}


def phase_lidar_flow(dev):
    """The LiDAR-only two-phase flow on the card (``cfgs/default.yaml``,
    f32; 16384 points, batch 4, 2 loader workers in training) on a synthetic
    tree of 20 training and 4 val scenes: the host library built and loaded;
    ``tools/generate_gt_database.py`` and ``tools/generate_aug_scene.py
    --aug_times 1``; ``rpn --gt_database`` for 20 epochs (100 steps; the
    items carry pasted boxes); ``eval --eval_mode rpn --save_rpn_feature``
    on the train and val splits (recall and seg IoU printed);
    ``rcnn_offline --set RCNN.ROI_SAMPLE_JIT False`` for 2 epochs from the
    train dumps (every step labelled RoIs, at least half foreground);
    ``eval --eval_mode rcnn_offline`` on the val dumps (a txt for every val
    frame, AP printed); ``eval --eval_all`` over the offline run's
    checkpoints with a short wait (each once); ``rcnn_online --gt_database``
    for 1 epoch from the RPN; then a tiny ``rcnn_offline`` step and a tiny
    offline-eval frame, card against CPU. Checks finite losses and each
    step's, batch's or frame's launches (``FLOW_WANT``: no D, E or F);
    prints steps/s, each pass's time to its first batch, the host ms of an
    item with and without the paste and of an offline sample, and every
    stage's wall time."""
    import shutil

    from epnet_tpu_torch.config import load_config
    from epnet_tpu_torch.data import native, rcnn_offline
    from epnet_tpu_torch.data.kitti_rcnn_dataset import KittiRCNNDataset
    from epnet_tpu_torch.eval import rcnn_offline_eval, rpn_eval
    from epnet_tpu_torch.tools import generate_aug_scene, generate_gt_database
    from epnet_tpu_torch.tools.train import apply_train_mode
    from epnet_tpu_torch.utils.testing import make_fake_kitti

    t_phase = time.perf_counter()
    stages = {}
    t0 = time.perf_counter()
    so = native.library_path()
    built = not so.exists()
    native.load()
    if not so.exists():
        raise AssertionError(f'the host library {so} did not build')
    stages['host library'] = time.perf_counter() - t0
    print(f'LiDAR flow: host library {so.name} {"built and " if built else ""}loaded in '
          f'{stages["host library"]:.2f} s', flush=True)

    work = os.path.join(OUT, 'lidar_flow')
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, 'kitti')
    t0 = time.perf_counter()
    make_fake_kitti(root, n_samples=TRAIN_CLI_SCENES, n_val=TRAIN_CLI_VAL,
                    n_points=TRAIN_CLI_POINTS, seed=13, max_cars=4)
    stages['tree'] = time.perf_counter() - t0
    db = os.path.join(work, 'db', 'train_gt_database.pkl')
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        entries = generate_gt_database.main(['--data_root', root, '--save_dir',
                                             os.path.dirname(db)])
        aug_ids = generate_aug_scene.main(['--data_root', root, '--gt_database', db,
                                           '--aug_times', '1'])
    stages['tools'] = time.perf_counter() - t0
    hard = sum(len(e['points']) <= 100 for e in entries)
    if not entries or not aug_ids or min(aug_ids) < 10000:
        raise AssertionError(f'LiDAR flow tools: {len(entries)} entries, aug ids {aug_ids}')
    print(f'LiDAR flow: gt database of {len(entries)} objects ({hard} hard) and '
          f'{len(aug_ids)} aug scenes in {stages["tools"]:.2f} s', flush=True)

    # the loader's host work, one item at a time in this process
    cfg = apply_train_mode(load_config(LIDAR_RECIPE), 'rpn')
    kw = dict(npoints=cfg.RPN.NUM_POINTS, split='train', mode='TRAIN')
    paste_ms, paste_parts = _host_item_ms(
        KittiRCNNDataset(root, cfg, gt_database_dir=db, **kw), 8,
        [(KittiRCNNDataset, 'apply_gt_aug_to_one_scene'), (native, 'points_in_boxes3d')])
    plain_ms, _ = _host_item_ms(KittiRCNNDataset(root, cfg, **kw), 8)

    counters = _train_cli_counters()
    for c in counters:
        c.launches = 0
    base = ['--cfg_file', LIDAR_RECIPE, '--data_root', root, '--batch_size', str(TRAIN_BATCH),
            '--device', str(dev)]
    train = base + ['--workers', '2']
    evals = base + ['--workers', '0']

    rpn = _train_run('rpn', train + ['--output_dir', os.path.join(work, 'rpn'), '--train_mode',
                                     'rpn', '--epochs', str(FLOW_RPN_EPOCHS),
                                     '--gt_database', db],
                     counters, FLOW_WANT['rpn'], check_rois=False)
    stages['rpn train'] = rpn['wall']
    frames = [(n, sid) for s in rpn['steps'] for n, sid in zip(s[5], s[6])]
    pasted = sum(n > _own_cars(root, sid) for n, sid in frames)
    if 2 * pasted < len(frames):
        raise AssertionError(f'LiDAR flow rpn: {pasted} of {len(frames)} frames carried '
                             f'pasted boxes')
    print(f'LiDAR flow rpn: {pasted} of {len(frames)} training frames carried pasted boxes '
          f'(gt boxes a frame {min(n for n, _ in frames)}-{max(n for n, _ in frames)})',
          flush=True)

    rpn_ckpt = os.path.join(work, 'rpn', 'ckpt', f'checkpoint_epoch_{FLOW_RPN_EPOCHS - 1}.pth')
    dumps = {}
    for split in ('train', 'val'):
        out = os.path.join(work, f'rpn_eval_{split}')
        ret, calls, wall = _eval_run('rpn_eval', evals + [
            '--eval_mode', 'rpn', '--ckpt', rpn_ckpt, '--save_rpn_feature', '--output_dir',
            out, '--set', 'TEST.SPLIT', split], counters, rpn_eval, 'rpn_eval_step')
        stages[f'rpn eval {split}'] = wall
        dumps[split] = os.path.join(out, f'epoch_{FLOW_RPN_EPOCHS - 1}')
        if not all(math.isfinite(v) for v in ret.values()):
            raise AssertionError(f'LiDAR flow rpn eval {split}: {ret}')
        print(f'LiDAR flow rpn eval ({split}, {len(calls)} batches, {wall:.2f} s): seg IoU '
              f'{ret["seg_iou"]:.4f}, recall '
              + ', '.join(f'{t} {ret[f"rpn_recall(thresh={t})"]:.4f}'
                          for t in ('0.10', '0.30', '0.50', '0.70', '0.90')), flush=True)

    feats = os.path.join(dumps['train'], 'features')
    rois = os.path.join(dumps['train'], 'roi_result', 'data')
    ocfg = apply_train_mode(load_config(LIDAR_RECIPE, [('RCNN.ROI_SAMPLE_JIT', 'False')]),
                            'rcnn_offline')
    sample_ms, sample_parts = _host_item_ms(
        KittiRCNNDataset(root, ocfg, split='train', mode='TRAIN', rcnn_training_roi_dir=rois,
                         rcnn_training_feature_dir=feats), 8,
        [(rcnn_offline, 'sample_rois_for_rcnn_offline'), (native, 'roipool3d_cpu'),
         (KittiRCNNDataset, '_load_rpn_features')])
    print(f'LiDAR flow host ms an item (median of 8, one process): LiDAR-only TRAIN item '
          f'{plain_ms:.1f}, with the gt paste {paste_ms:.1f} (the paste '
          f'{paste_parts["apply_gt_aug_to_one_scene"]:.1f}, its point-in-box masks '
          f'{paste_parts["points_in_boxes3d"]:.1f}, a mean); offline RCNN sample {sample_ms:.1f} '
          f'(RoI sampling and noise {sample_parts["sample_rois_for_rcnn_offline"]:.1f}, '
          f'roipool3d_cpu {sample_parts["roipool3d_cpu"]:.1f}, the dumps\' load '
          f'{sample_parts["_load_rpn_features"]:.1f}, means)', flush=True)
    offline_dir = os.path.join(work, 'rcnn_offline')
    offline = _train_run('rcnn_offline', train + [
        '--output_dir', offline_dir, '--train_mode', 'rcnn_offline', '--epochs',
        str(FLOW_OFFLINE_EPOCHS), '--rcnn_training_roi_dir', rois,
        '--rcnn_training_feature_dir', feats, '--set', 'RCNN.ROI_SAMPLE_JIT', 'False'],
        counters, FLOW_WANT['rcnn_offline'])
    stages['rcnn_offline train'] = offline['wall']

    val = ['--eval_mode', 'rcnn_offline', '--rcnn_eval_roi_dir',
           os.path.join(dumps['val'], 'roi_result', 'data'), '--rcnn_eval_feature_dir',
           os.path.join(dumps['val'], 'features')]
    ckpt_dir = os.path.join(offline_dir, 'ckpt')
    last = f'checkpoint_epoch_{FLOW_OFFLINE_EPOCHS - 1}.pth'
    ret, calls, wall = _eval_run('offline_eval', evals + val + [
        '--ckpt', os.path.join(ckpt_dir, last), '--output_dir',
        os.path.join(work, 'offline_eval')], counters, rcnn_offline_eval,
        'rcnn_offline_eval_step')
    stages['rcnn_offline eval'] = wall
    txts = sorted(os.listdir(os.path.join(work, 'offline_eval', f'epoch_{FLOW_OFFLINE_EPOCHS - 1}',
                                          'final_result', 'data')))
    want_txts = ['%06d.txt' % i for i in range(TRAIN_CLI_SCENES, TRAIN_CLI_SCENES + TRAIN_CLI_VAL)]
    ap = ret['ap']['Car']['3d']
    if txts != want_txts or len(calls) != TRAIN_CLI_VAL or not all(map(math.isfinite, ap)):
        raise AssertionError(f'LiDAR flow offline eval: files {txts}, {len(calls)} frames, '
                             f'3d AP {ap}')
    print(f'LiDAR flow offline eval ({len(calls)} frames, {wall:.2f} s): {ret["rcnn_avg_num"]:.2f} '
          f'boxes a frame; Car 3d AP {ap}, bev AP {ret["ap"]["Car"]["bev"]}', flush=True)

    ckpts = sorted(os.path.join(ckpt_dir, c) for c in os.listdir(ckpt_dir))
    evaluated, calls, wall = _eval_run('offline_eval', evals + val + [
        '--eval_all', '--ckpt_dir', ckpt_dir, '--max_waiting_mins', '0.02', '--output_dir',
        os.path.join(work, 'eval_all')],
        counters, rcnn_offline_eval, 'rcnn_offline_eval_step')
    stages['eval_all'] = wall
    if evaluated != ckpts or len(ckpts) != 2 or len(calls) != 2 * TRAIN_CLI_VAL:
        raise AssertionError(f'LiDAR flow --eval_all: evaluated {evaluated} of {ckpts}, '
                             f'{len(calls)} frames')
    print(f'LiDAR flow --eval_all: {len(evaluated)} checkpoints, each once, in {wall:.2f} s',
          flush=True)

    joint = _train_run('rcnn_online', train + [
        '--output_dir', os.path.join(work, 'rcnn_online'), '--epochs', '1', '--gt_database', db,
        '--rpn_ckpt', rpn_ckpt], counters, FLOW_WANT['rcnn_online'])
    stages['rcnn_online train'] = joint['wall']
    snaps = [c.launches for c in counters]

    t0 = time.perf_counter()
    _small_offline_reference(dev)
    stages['tiny card vs CPU'] = time.perf_counter() - t0
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True, timeout=60).stdout
    print(f'LiDAR flow phase on {card.strip().splitlines()[0]}: '
          f'{time.perf_counter() - t_phase:.1f} s wall; stages '
          + ', '.join(f'{k} {v:.2f} s' for k, v in stages.items()) + '; launches '
          + ' '.join(f'{n} +{d}' for n, d in zip(TRAIN_CLI_KERNELS, snaps) if d), flush=True)
    return dict(zip(TRAIN_CLI_KERNELS, snaps))


def _offline_tiny_batch(cfg, rng, frames=2):
    """An offline RCNN batch at tiny widths: each RoI's points uniform in a
    car-sized box of its canonical frame, seg mask, depth and random
    features, labels in {-1, 0, 1} and targets near the mean size."""
    import numpy as np
    from epnet_tpu_torch.models.epnet import offline_rcnn_channels

    R, S = cfg.RCNN.ROI_PER_IMAGE, cfg.RCNN.NUM_POINTS
    C = offline_rcnn_channels(cfg)
    xyz = rng.uniform(-1, 1, (frames, R, S, 3)) * np.array([1.9, 0.8, 0.8]) \
        + np.array([0.0, -0.75, 0.0])
    seg = (rng.rand(frames, R, S, 1) < 0.6).astype(np.float64)
    depth = rng.uniform(-0.4, 0.3, (frames, R, S, 1))
    pts = np.concatenate([xyz, seg, depth, rng.randn(frames, R, S, C - 5)], -1)
    cls = rng.randint(-1, 2, (frames, R)).astype(np.int32)
    gt = np.concatenate([rng.uniform(-0.3, 0.3, (frames, R, 3)),
                         np.array(cfg.CLS_MEAN_SIZE[0]) * rng.uniform(0.9, 1.1, (frames, R, 3)),
                         rng.uniform(-0.5, 0.5, (frames, R, 1))], -1)
    return {'pts_input': pts.astype(np.float32), 'cls_label': cls,
            'reg_valid_mask': (cls == 1).astype(np.int32),
            'gt_boxes3d_ct': gt.astype(np.float32),
            'roi_boxes3d': rng.uniform(-5, 5, (frames, R, 7)).astype(np.float32),
            'mask_score': seg[..., 0].mean(-1).astype(np.float32)}


def _small_offline_reference(dev):
    """A tiny ``rcnn_offline`` step and a tiny offline-eval frame, card
    (kernels B, C and A) vs CPU (plain versions), identical weights and
    batch: the loss and every gradient within 1e-3 * (1 + max|x|), then the
    frame's kept boxes and scores within the same bound and the same count."""
    import numpy as np
    import torch
    from epnet_tpu_torch.eval.rcnn_offline_eval import MAX_ROIS, rcnn_offline_eval_step
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.train.loss import joint_loss
    from epnet_tpu_torch.utils.testing import tiny_config

    cfg = tiny_config(li_fusion=False, rcnn=False, EXACT_QUERIES=True).merged(OFFLINE_TINY)
    cpu = EPNet(cfg, 'TRAIN', device='cpu', generator=torch.Generator().manual_seed(1)).train()
    card = EPNet(cfg, 'TRAIN', device=dev)
    card.load_state_dict(cpu.state_dict())
    card.train()
    batch = _offline_tiny_batch(cfg, np.random.RandomState(4))

    def step(model, device):
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        loss, _ = joint_loss(cfg, model(b), b)
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().cpu() for n, p in model.named_parameters()}

    want_loss, want = step(cpu, 'cpu')
    got_loss, got = step(card, dev)
    worst = max(float((got[n] - w).abs().max()) / (1e-3 * (1 + float(w.abs().max())))
                for n, w in want.items())
    if not (abs(got_loss - want_loss) <= 1e-3 * (1 + abs(want_loss)) and worst <= 1.0):
        raise AssertionError(f'tiny rcnn_offline step, card vs CPU: loss {got_loss} vs '
                             f'{want_loss}, worst gradient {worst:.3f} of its bound')
    frame = _offline_tiny_batch(cfg.merged({'RCNN': {'ROI_PER_IMAGE': MAX_ROIS}}),
                                np.random.RandomState(5), frames=1)
    pts = torch.from_numpy(frame['pts_input'][0])
    rois = torch.from_numpy(np.concatenate([
        np.random.RandomState(6).uniform(-20, 20, (MAX_ROIS, 3)) * [1, 0, 1] + [0, 1.6, 30],
        np.tile(cfg.CLS_MEAN_SIZE[0], (MAX_ROIS, 1)),
        np.random.RandomState(7).uniform(-3, 3, (MAX_ROIS, 1))], -1).astype(np.float32))
    cpu.eval()
    card.eval()
    n = 40
    wb, ws, wc = rcnn_offline_eval_step(cfg, cpu.rcnn, pts, rois, n)
    gb, gs, gc = rcnn_offline_eval_step(cfg, card.rcnn, pts.to(dev), rois.to(dev), n)
    errs = [float((g[:wc].cpu() - w[:wc]).abs().max() / (1e-3 * (1 + float(w[:wc].abs().max()))))
            for g, w in ((gb, wb), (gs, ws))] if wc else [0.0]
    if gc != wc or not wc or max(errs) > 1.0:
        raise AssertionError(f'tiny offline eval frame, card vs CPU: {gc} vs {wc} boxes kept, '
                             f'worst {max(errs):.3f} of the bound')
    print(f'tiny rcnn_offline step, card vs CPU: loss {got_loss:.6f} vs {want_loss:.6f}, worst '
          f'gradient {worst:.3f} of the bound 1e-3 * (1 + max|x|); tiny offline eval frame: '
          f'{gc} of {n} RoIs kept on both, worst {max(errs):.3f} of the bound', flush=True)


HEADLINE_WANT = {'forward': [6, 0, 0, 0, 2, 0, 4], 'block-local forward': [6, 0, 0, 0, 1, 1, 4],
                 'step': [6, 2, 0, 2, 0, 4, 3, 4, 0, 0, 0, 0, 0],
                 'block-local step': [6, 1, 1, 1, 1, 4, 3, 4, 0, 0, 0, 0, 0]}
F32_STEP_WANT = [6, 0, 0, 0, 0, 0, 0, 0, 2, 2, 4, 3, 4]  # a parity-width f32 step
F32_FWD_WANT = FWD_WANT['exact']
D2_EPS = 8 * 2.0 ** -24  # the roundings of |a|^2 + |b|^2 - 2ab, each at most half an ulp


def _d2_bound(a, b):
    """(..., M, N) bound on the card's and the CPU's difference in
    ``pointops._pairwise_d2(a, b)`` (f32): a few roundings, each within an
    ulp of the largest term, |a|^2 + |b|^2 + 2 sum |a_i b_i|."""
    aa = (a * a).sum(-1)[..., :, None]
    bb = (b * b).sum(-1)[..., None, :]
    ab = (a.abs()[..., :, None, :] * b.abs()[..., None, :, :]).sum(-1)
    return D2_EPS * (aa + bb + 2 * ab)


def _check_ball(name, idx_card, xyz, new_xyz, radius, nsample):
    """The card's first-hit query (``ball_query_approx``'s membership test,
    ``d2 / r^2 < 1``) against the same function on the CPU on the card's
    inputs: identical where the masks agree; where they differ, each
    flipped point within ``_d2_bound`` of the radius. Returns the flips."""
    import torch
    from epnet_tpu_torch.ops import pointops
    xs, cs = pointops._scaled(xyz, radius).cpu(), pointops._scaled(new_xyz, radius).cpu()
    want = pointops.ball_query_approx(radius, nsample, xyz.cpu(), new_xyz.cpu())
    got = idx_card.cpu()
    bad_rows = (got != want).any(-1)
    flips = 0
    for b, m in bad_rows.nonzero().tolist():
        d2_cpu = pointops._pairwise_d2(cs[b:b + 1, m:m + 1], xs[b:b + 1])[0, 0]
        d2_card = pointops._pairwise_d2(pointops._scaled(new_xyz[b:b + 1, m:m + 1], radius),
                                        pointops._scaled(xyz[b:b + 1], radius))[0, 0].cpu()
        flip = (d2_cpu < 1.0) != (d2_card < 1.0)
        bound = _d2_bound(cs[b:b + 1, m:m + 1], xs[b:b + 1])[0, 0]
        if not bool(flip.any()) or not bool(((d2_cpu - 1.0).abs() <= bound)[flip].all()):
            raise AssertionError(f'{name}: centroid ({b}, {m}) differs card vs CPU beyond the '
                                 f'radius boundary')
        if not torch.equal(pointops.first_hits(d2_card < 1.0, nsample), got[b, m]):
            raise AssertionError(f'{name}: centroid ({b}, {m}) is not the first hits of the '
                                 f'card\'s own membership')
        flips += int(flip.sum())
    print(f'  {name}: {int(bad_rows.sum())} of {bad_rows.numel()} balls differ card vs CPU, '
          f'{flips} points flipped within the d2 rounding bound of the radius', flush=True)
    return flips


def _check_three_nn(dist_card, idx_card, unknown, known, approx=True, f32_keys=False):
    """The card's ``three_nn`` (approximate by default) against the CPU's on
    the card's inputs: identical, except rows whose picks differ only where
    the two f32 fields round within ``_d2_bound`` (plus a bf16 unit of each
    other when the field is rounded to bf16). Returns the rows that
    differ."""
    import torch
    from epnet_tpu_torch.ops import pointops
    u, k = unknown.cpu(), known.cpu()
    dist, idx = pointops.three_nn(u, k, approx=approx, f32_keys=f32_keys)
    bf16 = approx and not f32_keys
    got = idx_card.cpu()
    rows = (got != idx).any(-1)
    for b, n in rows.nonzero().tolist():
        d2 = pointops._pairwise_d2(u[b:b + 1, n:n + 1], k[b:b + 1])[0, 0].clamp_min(0.0)
        bound = _d2_bound(u[b:b + 1, n:n + 1], k[b:b + 1])[0, 0]
        a, w = d2[got[b, n]], d2[idx[b, n]]
        ulp = torch.maximum(a, w).to(torch.bfloat16).float() * 2.0 ** -7 * bf16
        if not bool(((a - w).abs() <= 2 * torch.maximum(bound[got[b, n]], bound[idx[b, n]])
                     + ulp).all()):
            raise AssertionError(f'three_nn: row ({b}, {n}) differs card vs CPU beyond rounding')
    same = ~rows
    dc = dist_card.cpu()
    neq = same[..., None] & (dc != dist)
    if bf16 and bool(neq.any()):
        raise AssertionError('three_nn: distances of identical picks differ card vs CPU')
    b, n, j = neq.nonzero().unbind(1)  # an f32 field: within its rounding
    up, kp = u[b, n], k[b, idx[b, n, j]]
    bound = D2_EPS * ((up * up).sum(-1) + (kp * kp).sum(-1) + 2 * (up.abs() * kp.abs()).sum(-1))
    a2, w2 = dc[b, n, j] ** 2, dist[b, n, j] ** 2
    if not bool(((a2 - w2).abs() <= 2 * bound + 2.0 ** -22 * torch.maximum(a2, w2)).all()):
        raise AssertionError('three_nn: distances of identical picks differ card vs CPU beyond '
                             'the d2 rounding bound')
    print(f'  three_nn{"" if approx else " (exact)"}{" (f32 field)" if f32_keys else ""}: '
          f'{int(rows.sum())} of {rows.numel()} queries pick other neighbours card vs CPU, each '
          f'within the d2 rounding bound{" plus a bf16 unit" if bf16 else ""}', flush=True)
    return int(rows.sum())


def _check_roipool(pooled_card, xyz, feats, rois, extra, S, approx=True):
    """The card's pool (by default the approximate one: first k by index,
    slot-0 pad) against the CPU's on the card's inputs: identical boxes
    where the in-box masks agree; a differing box only by points within
    float rounding of its faces. Returns the boxes that differ."""
    import torch
    from epnet_tpu_torch.ops.boxes import enlarge_box3d, points_in_boxes3d
    from epnet_tpu_torch.ops.roipool3d import roipool3d
    want = roipool3d(xyz.cpu(), feats.cpu(), rois.cpu(), extra, sampled_pt_num=S, approx=approx)
    got = [t.cpu() for t in pooled_card]
    B, M = rois.shape[:2]
    differ = torch.zeros(B, M, dtype=torch.bool)
    for g, w in zip(got, want):
        d = g != w
        differ |= d.reshape(B, M, -1).any(-1) if d.dim() > 2 else d
    big = enlarge_box3d(rois.reshape(-1, 7), extra).reshape(B, M, 7)
    for b, m in differ.nonzero().tolist():
        box = big[b:b + 1, m:m + 1]
        flip = points_in_boxes3d(xyz[b:b + 1], box)[0, 0].cpu() != \
            points_in_boxes3d(xyz[b:b + 1].cpu(), box.cpu())[0, 0]
        box, p = box.cpu()[0, 0], xyz[b].cpu()
        local = p - box[:3]
        scale = local.abs().sum(-1) + box[3:6].sum()
        c, s = torch.cos(box[6]), torch.sin(box[6])
        margin = torch.minimum(torch.minimum(
            (box[5] / 2 - (local[:, 0] * c - local[:, 2] * s).abs()).abs(),
            (box[4] / 2 - (local[:, 0] * s + local[:, 2] * c).abs()).abs()),
            (box[3] / 2 - (local[:, 1] + box[3] / 2).abs()).abs())
        if not bool(flip.any()) or not bool((margin <= 16 * 2.0 ** -24 * scale)[flip].all()):
            raise AssertionError(f'roipool: box ({b}, {m}) differs card vs CPU beyond the '
                                 f'rounding of its faces')
    print(f'  roipool {"first k" if approx else "(exact)"}: {int(differ.sum())} of {B * M} '
          f'boxes differ card vs CPU (points within rounding of a face)', flush=True)
    return int(differ.sum())


@contextlib.contextmanager
def _spying(module, names, rec):
    """``module``'s functions ``names`` wrapped to append (args, kwargs,
    output) to ``rec[name]``."""
    from unittest import mock
    with contextlib.ExitStack() as stack:
        for name in names:
            real = getattr(module, name)

            def wrapped(*args, _real=real, _name=name, **kwargs):
                out = _real(*args, **kwargs)
                rec.setdefault(_name, []).append((args, kwargs, out))
                return out

            stack.enter_context(mock.patch.object(module, name, wrapped))
        yield rec


def _captured_queries(model, batch):
    """One forward of ``model`` with its approximate queries' inputs and
    outputs recorded: RPN sa0's nested ball, FP level 0's ``three_nn``, the
    eval pool."""
    from epnet_tpu_torch.models import epnet as epnet_mod
    from epnet_tpu_torch.models import pointnet2
    rec = {}
    with _spying(pointnet2, ('ball_query_nested_first_hit', 'three_nn'), rec), \
            _spying(epnet_mod, ('roipool3d',), rec):
        model(batch)
    return rec


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _check_out(name, out, want_shapes, delta, want_launches):
    import torch
    bad = [k for k, v in out.items()
           if torch.is_tensor(v) and v.is_floating_point() and not bool(torch.isfinite(v).all())]
    shapes = {k: tuple(out[k].shape) for k in want_shapes}
    if bad or shapes != want_shapes or (want_launches is not None and delta != want_launches):
        raise AssertionError(f'{name}: non-finite {bad}, shapes {shapes} (expected '
                             f'{want_shapes}), launches {delta}, expected {want_launches}')


def phase_headline(dev):
    """Phase 26: the JAX package's headline configuration
    (``config.headline_config``: the recipe in bf16 with the approximate
    queries, exact FPS, no block-local path) at full width. Three batch-1
    requests under the default ball policy ``first_nested`` in turns with
    the parity recipe (f32, exact queries) on the same weights and scenes,
    then the same requests under ``first_multi``; each forward's shapes,
    finiteness and launches (6 FPS, 2 B-bf16, 4 F-bf16). RPN sa0's nested
    ball, FP level 0's ``three_nn`` and the eval pool's first k, held
    against the same port functions on the CPU on the card's inputs. Two
    batch-4 train steps (6 FPS, 2 B-bf16, 2 C-bf16, 4 D-bf16, 3 E-bf16 and
    4 F-bf16 a step) in turns with the parity recipe's f32 step. Wall and
    device busy time of one forward and one step of each (``torch.profiler``).
    Then the headline configuration with both ``BLOCK_LOCAL`` flags, on
    Morton-sorted scenes: a forward (1 B-bf16, 1 G-bf16: RCNN sa1 takes the
    bucket select) and a step (1 C-bf16, 1 H-bf16)."""
    import torch
    from epnet_tpu_torch.config import headline_config, parity_config
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.train.trainer import create_train_state, device_batch, train_step
    from epnet_tpu_torch.utils.profiling import device_breakdown
    from epnet_tpu_torch.utils.testing import full_batch

    cfgs = {'headline': headline_config(), 'parity': parity_config()}
    models = {'headline': EPNet(cfgs['headline'], 'TEST', device=dev,
                                generator=torch.Generator(device=dev).manual_seed(0)).eval()}
    models['parity'] = EPNet(cfgs['parity'], 'TEST', device=dev).eval()
    models['first_multi'] = EPNet(cfgs['headline'], 'TEST', device=dev,
                                  ball_policy='first_multi').eval()
    for k in ('parity', 'first_multi'):
        models[k].load_state_dict(models['headline'].state_dict())
    requests = [_request(seed, cfgs['parity'], dev) for seed in (0, 1, 2)]
    for m in models.values():  # warm-up
        m(requests[0])
    counters = _fwd_counters()
    total = collections.Counter()
    R = cfgs['headline'].TEST.RPN_POST_NMS_TOP_N
    shapes = {'rois': (1, R, 7), 'rcnn_cls': (R, 1),
              'rcnn_reg': (R, cfgs['parity'].RCNN.reg_channel),
              'backbone_features': (1, cfgs['parity'].RPN.NUM_POINTS,
                                    models['parity'].rpn.backbone.out_features)}
    times = {k: [] for k in models}
    for i, batch in enumerate(requests):
        order = ('headline', 'parity') if i % 2 == 0 else ('parity', 'headline')
        for name in order + ('first_multi',):
            for c in counters:
                c.launches = 0
            out, ms = _timed(lambda: models[name](batch))
            times[name].append(ms)
            delta = [c.launches for c in counters]
            _check_out(f'{name} forward scene {i}', out, shapes, delta,
                       F32_FWD_WANT if name == 'parity' else HEADLINE_WANT['forward'])
            if name != 'parity':
                total.update(dict(zip(FWD_KERNELS, delta)))
            print(f'{name} forward scene {i}: {ms:.2f} ms, rois {int(out["roi_counts"][0])}, '
                  f'launches {_fwd_launches(delta)}', flush=True)
    for name in models:
        print(f'{name} forward, batch 1: median {statistics.median(times[name]):.2f} ms over '
              f'{len(times[name])} scenes (headline and parity in turns)', flush=True)

    rec = _captured_queries(models['headline'], requests[1])
    (args, _, idx), = rec['ball_query_nested_first_hit'][:1]
    radii, nsamples, xyz, new_xyz = args[:4]
    _check_ball('RPN sa0 nested ball', idx, xyz, new_xyz, float(radii[-1]), int(nsamples[-1]))
    args, _, (dist, nn_idx) = rec['three_nn'][-1]
    _check_three_nn(dist, nn_idx, args[0], args[1])
    args, kwargs, pooled = rec['roipool3d'][0]
    _check_roipool(pooled, args[0], args[1], args[2], args[3], kwargs['sampled_pt_num'])

    for name in ('headline', 'parity'):
        wall, busy, _ = device_breakdown(lambda: models[name](requests[2]), 3)
        print(f'{name} forward, profiled: wall {wall:.3f} ms, device busy {busy:.3f} ms',
              flush=True)
    del models

    counters = _bf16_train_counters()
    states = {k: create_train_state(c, total_steps=100, device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(0))
              for k, c in cfgs.items()}
    states['parity'].model.load_state_dict(states['headline'].model.state_dict())
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = {seed: _train_batch(cfgs['parity'], seed, dev) for seed in (3, 0, 1)}
    for k in states:  # warm-up
        train_step(states[k], batches[3], 0.1, gen)
    step_times = {k: [] for k in states}
    for i, seed in enumerate((0, 1)):
        for name in (('headline', 'parity') if i % 2 == 0 else ('parity', 'headline')):
            for c in counters:
                c.launches = 0
            tb, ms = _timed(lambda: train_step(states[name], batches[seed], 0.1, gen))
            step_times[name].append(ms)
            delta = [c.launches for c in counters]
            loss = float(tb['loss'])
            want = F32_STEP_WANT if name == 'parity' else HEADLINE_WANT['step']
            if not math.isfinite(loss) or delta != want:
                raise AssertionError(f'{name} train step on scene {seed}: loss {loss}, launches '
                                     f'{delta}, expected {want}')
            if name == 'headline':
                total.update(dict(zip(BF16_TRAIN_KERNELS, delta)))
            print(f'{name} train step scene {seed}: {ms:.2f} ms, loss {loss:.4f}, rcnn fg '
                  f'{int(tb["rcnn_cls_fg"])}, launches '
                  + ' '.join(f'{n} +{d}' for n, d in zip(BF16_TRAIN_KERNELS, delta) if d),
                  flush=True)
    for name in states:
        wall, busy, _ = device_breakdown(lambda: train_step(states[name], batches[0], 0.1, gen), 3)
        print(f'{name} train step, batch {TRAIN_BATCH}: {step_times[name]} ms in turns; '
              f'profiled: wall {wall:.3f} ms, device busy {busy:.3f} ms', flush=True)
    del states, batches

    cfg = cfgs['headline'].with_overrides([('RPN.BLOCK_LOCAL', 'True'),
                                           ('RCNN.BLOCK_LOCAL', 'True')])
    model = EPNet(cfg, 'TEST', device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    batch = device_batch(full_batch(cfg, 1, seed=0), dev)
    model.eval()(batch)  # warm-up
    counters = _fwd_counters()
    for c in counters:
        c.launches = 0
    out, ms = _timed(lambda: model(batch))
    delta = [c.launches for c in counters]
    _check_out('headline block-local forward', out, {'rcnn_cls': (R, 1)}, delta,
               HEADLINE_WANT['block-local forward'])
    total.update(dict(zip(FWD_KERNELS, delta)))
    print(f'headline block-local forward scene 0: {ms:.2f} ms, launches {_fwd_launches(delta)}',
          flush=True)
    del model
    state = create_train_state(cfg, total_steps=100, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    batch = _train_batch(cfg, 0, dev)
    train_step(state, batch, 0.1, gen)  # warm-up
    counters = _bf16_train_counters()
    for c in counters:
        c.launches = 0
    tb, ms = _timed(lambda: train_step(state, batch, 0.1, gen))
    delta = [c.launches for c in counters]
    if not math.isfinite(float(tb['loss'])) or delta != HEADLINE_WANT['block-local step']:
        raise AssertionError(f'headline block-local step: loss {float(tb["loss"])}, launches '
                             f'{delta}, expected {HEADLINE_WANT["block-local step"]}')
    total.update(dict(zip(BF16_TRAIN_KERNELS, delta)))
    print(f'headline block-local train step: {ms:.2f} ms, loss {float(tb["loss"]):.4f}, launches '
          + ' '.join(f'{n} +{d}' for n, d in zip(BF16_TRAIN_KERNELS, delta) if d), flush=True)
    return total


# the launches of one batch-1 forward of each approximation-family configuration
FAMILY_WANT = {'speed': HEADLINE_WANT['block-local forward'], 'nearest': [6, 0, 0, 0, 2, 0, 4],
               'random': [2, 0, 0, 0, 2, 0, 4], 'fpwin': [6, 0, 0, 0, 2, 0, 4]}


def _pairs(kv):
    return list(zip(kv[0::2], kv[1::2]))


def _family_configs():
    """Phase 29's configurations: the pin's ``--speed-mode`` and ``fpwin``
    cells on the recipe (their ``--set`` lists), and the headline
    configuration under ``SAMPLING random``; the ``nearest`` forward is the
    headline configuration with that ball policy."""
    from epnet_tpu_torch.config import headline_config, parity_config
    from epnet_tpu_torch.tools.synthetic_ap_pin import KNOBS, SPEED_MODE
    return {'speed': parity_config().with_overrides(_pairs(SPEED_MODE)),
            'nearest': headline_config(),
            'random': headline_config().with_overrides([('RPN.SAMPLING', 'random')]),
            'fpwin': parity_config().with_overrides([MIXED_SET] + _pairs(KNOBS['fpwin']))}


def _check_nested_nearest(idx_card, cnts_card, radii, nsamples, xyz, new_xyz, f32_keys=False):
    """The card's nearest-first nested ball (RPN sa0; its keys f32 with
    ``f32_keys``) against the same function on the CPU on the card's
    inputs: identical balls and counts, except where the two matmul-form
    fields differ by their rounding (``_d2_bound``); each such ball is the
    selection of the card's own field (``nested_nearest_select``). Returns
    the balls that differ."""
    import torch
    from epnet_tpu_torch.ops import pointops
    r_max, s_max = float(radii[-1]), int(nsamples[-1])
    want_idx, want_cnts = pointops.ball_query_nested(radii, nsamples, xyz.cpu(), new_xyz.cpu(),
                                                     f32_keys=f32_keys)
    got_idx, got_cnts = idx_card.cpu(), [c.cpu() for c in cnts_card]
    bad = (got_idx != want_idx).any(-1)
    for g, w in zip(got_cnts, want_cnts):
        bad |= g != w
    thrs = pointops.nested_thresholds(radii)
    xs_cpu, cs_cpu = pointops._scaled(xyz, r_max).cpu(), pointops._scaled(new_xyz, r_max).cpu()
    for b, m in bad.nonzero().tolist():
        d2_card = pointops._pairwise_d2(pointops._scaled(new_xyz[b:b + 1, m:m + 1], r_max),
                                        pointops._scaled(xyz[b:b + 1], r_max))[0, 0].cpu()
        d2_cpu = pointops._pairwise_d2(cs_cpu[b:b + 1, m:m + 1], xs_cpu[b:b + 1])[0, 0]
        bound = _d2_bound(cs_cpu[b:b + 1, m:m + 1], xs_cpu[b:b + 1])[0, 0]
        if not bool(((d2_card - d2_cpu).abs() <= bound).all()):
            raise AssertionError(f'nested nearest ball ({b}, {m}): card and CPU fields differ '
                                 f'beyond rounding')
        idx, cnts = pointops.nested_nearest_select(d2_card, s_max, thrs, f32_keys)
        if not torch.equal(idx, got_idx[b, m]) or \
                [int(c) for c in cnts] != [int(c[b, m]) for c in got_cnts]:
            raise AssertionError(f'nested nearest ball ({b}, {m}) is not the selection of the '
                                 f'card\'s own field')
    print(f'  RPN sa0 nested nearest ball{" (f32 keys)" if f32_keys else ""}: {int(bad.sum())} '
          f'of {bad.numel()} balls differ card vs CPU, each the selection of the card\'s own '
          f'field within the d2 rounding bound', flush=True)
    return int(bad.sum())


def _partitioned_rows(calls, kind):
    """Kernel A at the partitioned shapes the main path gave it (``calls``:
    the RPN's (xyz, npoint, groups, picks)): the B x groups sub-clouds
    through the kernel and the plain version on the card, index-identical;
    the whole partitioned call against the CPU on the card's input,
    identical; times and bound of each shape."""
    import torch
    from epnet_tpu_torch.ops import fps
    rows = []
    for xyz, npoint, groups, picks in calls:
        B, N = xyz.shape[:2]
        sub = xyz.float().reshape(B, N // groups, groups, 3).transpose(1, 2).reshape(
            B * groups, N // groups, 3).contiguous()
        n, k = N // groups, npoint // groups
        got = fps.furthest_point_sample_kernel(sub, k)
        want = fps.furthest_point_sample_plain(sub, k)
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        cpu = fps.furthest_point_sample(xyz.float().cpu(), npoint, groups=groups)
        if differ or not torch.equal(picks.cpu(), cpu):
            raise AssertionError(f'partitioned fps at {(B * groups, n, k)}: {differ} picks differ '
                                 f'kernel vs plain, card vs CPU equal: '
                                 f'{torch.equal(picks.cpu(), cpu)}')
        o, m = _bound(10.0 * B * groups * n * (k - 1), 4 * B * groups * n * 3 + 8 * B * groups * k)
        k_ms = _time_ms(lambda: fps.furthest_point_sample_kernel(sub, k), 20)
        p_ms = _time_ms(lambda: fps.furthest_point_sample_plain(sub, k), 2)
        cs, threads = fps.kernel_config(n)
        row = {'shape': [B * groups, n, 3], 'npoint': k, 'kind': kind, 'cluster': cs,
               'threads': threads, 'ms': k_ms, 'plain_ms': p_ms, 'bound_ms': max(o, m),
               'bound_by': 'operations' if o >= m else 'bytes', 'picks_differing': differ}
        print(f'fps partitioned {(B * groups, n, 3)} -> {k} ({kind}, {B} x {groups} '
              f'sub-clouds): 0 picks differ, card = CPU; {cs} block(s) of {threads} threads; '
              f'kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {max(o, m):.6f} ms',
              flush=True)
        rows.append(row)
    return rows


def phase_approx_family(dev):
    """Phase 29: the rest of the approximation family at full width. A
    batch-1 forward of each configuration (``_family_configs``; the same
    seeded weights; the speed and fpwin forwards on a Morton-sorted scene):
    shapes, finiteness, launches (``FAMILY_WANT``), wall and device busy
    time; the nearest forward's RPN sa0 nested ball held to the CPU
    (``_check_nested_nearest``). A batch-4 train step of the speed
    configuration (launches as the headline block-local step's). Kernel A
    at the partitioned shapes of the speed forward (batch 1) and step
    (batch 4), against its plain version and the CPU
    (``_partitioned_rows``)."""
    import torch
    from unittest import mock

    from epnet_tpu_torch.models import pointnet2
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.train.trainer import create_train_state, device_batch, train_step
    from epnet_tpu_torch.utils.profiling import device_breakdown
    from epnet_tpu_torch.utils.testing import full_batch

    t0 = time.perf_counter()
    cfgs = _family_configs()
    models = {'speed': EPNet(cfgs['speed'], 'TEST', device=dev,
                             generator=torch.Generator(device=dev).manual_seed(0)).eval()}
    for name in ('nearest', 'random', 'fpwin'):
        models[name] = EPNet(cfgs[name], 'TEST', device=dev, ball_policy=(
            'nearest' if name == 'nearest' else 'first_nested')).eval()
        models[name].load_state_dict(models['speed'].state_dict())
    calls, balls = [], []
    real_fps, real_ball = pointnet2.furthest_point_sample, pointnet2.ball_query_nested

    def fps_spy(xyz, npoint, groups=1):
        out = real_fps(xyz, npoint, groups=groups)
        calls.append((xyz, npoint, groups, out))
        return out

    def ball_spy(*args, **kwargs):
        out = real_ball(*args, **kwargs)
        balls.append((args, out))
        return out

    counters = _fwd_counters()
    total = collections.Counter()
    R = cfgs['speed'].TEST.RPN_POST_NMS_TOP_N
    shapes = {'rois': (1, R, 7), 'rcnn_cls': (R, 1)}
    fwd_calls = []
    for name, model in models.items():
        batch = device_batch(full_batch(cfgs[name], 1, seed=0), dev)
        model(batch)  # warm-up
        calls.clear()
        balls.clear()
        with mock.patch.object(pointnet2, 'furthest_point_sample', fps_spy), \
                mock.patch.object(pointnet2, 'ball_query_nested', ball_spy):
            for c in counters:
                c.launches = 0
            out, ms = _timed(lambda: model(batch))
            delta = [c.launches for c in counters]
        _check_out(f'{name} forward', out, shapes, delta, FAMILY_WANT[name])
        total.update(dict(zip(FWD_KERNELS, delta)))
        wall, busy, _ = device_breakdown(lambda: model(batch), 3)
        print(f'{name} forward, batch 1: {ms:.2f} ms, rois {int(out["roi_counts"][0])}, launches '
              f'{_fwd_launches(delta)}; profiled: wall {wall:.3f} ms, device busy {busy:.3f} ms',
              flush=True)
        if name == 'speed':
            fwd_calls = [c for c in calls if c[2] > 1]
        if name == 'nearest':
            (radii, nsamples, xyz, new_xyz), (idx, cnts) = balls[0]
            _check_nested_nearest(idx, cnts, radii, nsamples, xyz, new_xyz)
    del models

    state = create_train_state(cfgs['speed'], total_steps=100, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = _train_batch(cfgs['speed'], 0, dev)
    train_step(state, batch, 0.1, gen)  # warm-up
    counters = _bf16_train_counters()
    calls.clear()
    with mock.patch.object(pointnet2, 'furthest_point_sample', fps_spy):
        for c in counters:
            c.launches = 0
        tb, ms = _timed(lambda: train_step(state, batch, 0.1, gen))
        delta = [c.launches for c in counters]
    if not math.isfinite(float(tb['loss'])) or delta != HEADLINE_WANT['block-local step']:
        raise AssertionError(f'speed train step: loss {float(tb["loss"])}, launches {delta}, '
                             f'expected {HEADLINE_WANT["block-local step"]}')
    total.update(dict(zip(BF16_TRAIN_KERNELS, delta)))
    step_calls = [c for c in calls if c[2] > 1]
    wall, busy, _ = device_breakdown(lambda: train_step(state, batch, 0.1, gen), 3)
    print(f'speed train step, batch {TRAIN_BATCH}: {ms:.2f} ms, loss {float(tb["loss"]):.4f}, '
          f'launches ' + ' '.join(f'{n} +{d}' for n, d in zip(BF16_TRAIN_KERNELS, delta) if d)
          + f'; profiled: wall {wall:.3f} ms, device busy {busy:.3f} ms', flush=True)
    del state

    if len(fwd_calls) != 4 or len(step_calls) != 4:
        raise AssertionError(f'partitioned fps calls: {len(fwd_calls)} a forward, '
                             f'{len(step_calls)} a step; expected 4 (the RPN stages)')
    rows = _partitioned_rows(fwd_calls, 'speed forward') + \
        _partitioned_rows(step_calls, 'speed train step')
    print(f'phase 29 (approximation family): {time.perf_counter() - t0:.1f} s; '
          f'{_smi()}', flush=True)
    return total, rows


# phase 30: the launches of a batch-1 forward and a batch-4 step with the
# image tower in f32 under MIXED_PRECISION (F, D and E in f32), by
# FWD_KERNELS' and BF16_TRAIN_KERNELS' order; the seg harness's tree
IMG_F32_WANT = {'forward': [6, 0, 0, 4, 2, 0, 0],
                'step': [6, 2, 0, 2, 0, 0, 0, 0, 0, 0, 4, 3, 4]}
SEG_SCENES, SEG_VAL = 8, 4


def _phase30_seg(dev, root, total):
    """(a) The seg harness (``tools/pointnet2_seg.run``) at the RPN's full
    width: one epoch at batch 4, then the val IoU; 4 A launches a batch;
    the trained net's logits on a val scene against the CPU's."""
    import argparse

    import torch
    from epnet_tpu_torch.data.kitti_rcnn_dataset import KittiRCNNDataset
    from epnet_tpu_torch.ops import fps
    from epnet_tpu_torch.tools import pointnet2_seg as seg

    cfg = seg.seg_config()
    args = argparse.Namespace(data_root=root, epochs=1, batch_size=TRAIN_BATCH, lr=0.002,
                              device=str(dev))
    fps.furthest_point_sample_kernel.launches = 0
    out = seg.run(cfg, args, workers=0)
    launches = fps.furthest_point_sample_kernel.launches
    want = 4 * (len(out['steps_ms']) + SEG_VAL // TRAIN_BATCH)
    if launches != want or len(out['steps_ms']) != SEG_SCENES // TRAIN_BATCH or not all(
            math.isfinite(v) for v in out['loss'] + out['iou']):
        raise AssertionError(f'seg harness: {len(out["steps_ms"])} steps, loss {out["loss"]}, '
                             f'IoU {out["iou"]}, {launches} A launches, expected {want}')
    total['fps'] += launches
    model = out['model'].eval()
    cpu = seg.build_model(cfg, 'cpu').eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    pts = torch.from_numpy(KittiRCNNDataset(root, cfg, split='val', mode='EVAL')[0]['pts_input'])
    with torch.no_grad():
        got, ref = model(pts[None].to(dev)).cpu(), cpu(pts[None])
    err, bound = float((got - ref).abs().max()), 1e-3 * (1.0 + float(ref.abs().max()))
    if not err <= bound:
        raise AssertionError(f'seg logits card vs CPU off by {err:.3e} (bound {bound:.3e})')
    print(f'seg harness, {cfg.RPN.NUM_POINTS} points, batch {TRAIN_BATCH}: steps '
          + ', '.join(f'{t:.1f}' for t in out['steps_ms']) + f' ms; loss {out["loss"][0]:.4f}, '
          f'val fg-IoU {out["iou"][0]:.4f}; epoch {out["seconds"][0]:.2f} s; A +{launches}; '
          f'logits card vs CPU {err:.3e} ({err / bound:.3f} of 1e-3 (1 + max|x|))', flush=True)


def _phase30_exact_ops(dev, base, batch, counters, total):
    """(b) The headline configuration with each query family in turn kept
    exact (``exact_ops``): the forward's launches, wall and busy time, the
    exact family's indices held to the CPU's on the card's inputs, the
    other families still approximate."""
    import torch
    from epnet_tpu_torch.config import headline_config
    from epnet_tpu_torch.models import epnet as epnet_mod
    from epnet_tpu_torch.models import pointnet2
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.ops import pointops
    from epnet_tpu_torch.utils.profiling import device_breakdown

    cfg = headline_config()
    R = cfg.TEST.RPN_POST_NMS_TOP_N
    for op in pointops.QUERY_OPS:
        model = EPNet(cfg, 'TEST', device=dev,
                      queries=pointops.QueryOptions(exact_ops=(op,))).eval()
        model.load_state_dict(base.state_dict())
        model(batch)  # warm-up
        rec = {}
        with _spying(pointnet2, ('ball_query', 'ball_query_nested_first_hit', 'three_nn'), rec), \
                _spying(epnet_mod, ('roipool3d',), rec):
            for c in counters:
                c.launches = 0
            out, ms = _timed(lambda: model(batch))
            delta = [c.launches for c in counters]
        _check_out(f'exact_ops {op} forward', out, {'rcnn_cls': (R, 1)}, delta,
                   HEADLINE_WANT['forward'])
        total.update(dict(zip(FWD_KERNELS, delta)))
        paths = {'ball': len(rec.get('ball_query', ())) == 10 and
                 'ball_query_nested_first_hit' not in rec,
                 'three_nn': all(not kw.get('approx') for _, kw, _ in rec['three_nn']),
                 'roipool': not rec['roipool3d'][0][1]['approx']}
        if {k for k, v in paths.items() if v} != {op}:
            raise AssertionError(f'exact_ops {op}: exact families {paths}')
        if op == 'ball':
            for args, _, idx in (rec['ball_query'][0], rec['ball_query'][-1]):
                r, s, xyz, new_xyz = args[:4]
                want = pointops.ball_query(r, s, xyz.cpu(), new_xyz.cpu())
                if not torch.equal(idx.cpu(), want):
                    raise AssertionError(f'exact ball query (r {r}, {s} samples, '
                                         f'{xyz.dtype}): card and CPU differ')
            differ = 0
        elif op == 'three_nn':
            args, _, (dist, idx) = rec['three_nn'][-1]
            differ = _check_three_nn(dist, idx, args[0], args[1], approx=False)
        else:
            args, kwargs, pooled = rec['roipool3d'][0]
            differ = _check_roipool(pooled, args[0], args[1], args[2], args[3],
                                    kwargs['sampled_pt_num'], approx=False)
        wall, busy, _ = device_breakdown(lambda: model(batch), 3)
        print(f'headline, exact_ops {op}: forward {ms:.2f} ms, launches {_fwd_launches(delta)}, '
              f'{differ} {op} rows differing card vs CPU; profiled: wall {wall:.3f} ms, device '
              f'busy {busy:.3f} ms', flush=True)
        del model


def _phase30_img_f32(dev, total):
    """(c) ``img_f32`` under ``MIXED_PRECISION``: a batch-1 forward and a
    batch-4 step, their launches (F, D and E in f32), finite outputs and
    f32 gradients, parameters that moved; the forward's gap to the f32 and
    to the bf16 forward on the same weights."""
    import torch
    from epnet_tpu_torch.config import parity_config
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.train.trainer import create_train_state, train_step

    cfg = parity_config().with_overrides([MIXED_SET])
    models = {'img_f32': EPNet(cfg, 'TEST', device=dev, img_f32=True,
                               generator=torch.Generator(device=dev).manual_seed(0)).eval(),
              'bf16': EPNet(cfg, 'TEST', device=dev).eval(),
              'f32': EPNet(parity_config(), 'TEST', device=dev).eval()}
    for k in ('bf16', 'f32'):
        models[k].load_state_dict(models['img_f32'].state_dict())
    if models['img_f32'].rpn.backbone.img_block0.Conv2dBlock_0.dtype is not None:
        raise AssertionError('img_f32: the image tower is not f32')
    batch = _request(0, parity_config(), dev)
    outs = {}
    counters = _fwd_counters()
    for name, model in models.items():
        model(batch)  # warm-up
        for c in counters:
            c.launches = 0
        outs[name], ms = _timed(lambda: model(batch))
        if name == 'img_f32':
            delta = [c.launches for c in counters]
            _check_out('img_f32 forward', outs[name], {'rcnn_cls': (100, 1)}, delta,
                       IMG_F32_WANT['forward'])
            total.update(dict(zip(FWD_KERNELS, delta)))
            fwd = (ms, delta)
    gaps = {ref: {k: float((outs['img_f32'][k] - outs[ref][k]).abs().max())
                  / float(outs[ref][k].abs().max()) for k in ('backbone_features', 'rpn_cls')}
            for ref in ('f32', 'bf16')}
    print(f'img_f32 forward, batch 1: {fwd[0]:.2f} ms, launches {_fwd_launches(fwd[1])}; of '
          f'max|x|, against f32 ' + ', '.join(f'{k} {v:.3e}' for k, v in gaps['f32'].items())
          + ', against bf16 ' + ', '.join(f'{k} {v:.3e}' for k, v in gaps['bf16'].items()),
          flush=True)
    del models, outs

    state = create_train_state(cfg, total_steps=100, device=dev, img_f32=True,
                               generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    train_step(state, _train_batch(cfg, 3, dev), 0.1, gen)  # warm-up
    batch = _train_batch(cfg, 0, dev)
    params = list(state.model.parameters())
    old = [p.detach().clone() for p in params]
    counters = _bf16_train_counters()
    for c in counters:
        c.launches = 0
    tb, ms = _timed(lambda: train_step(state, batch, 0.1, gen))
    delta = [c.launches for c in counters]
    moved = sum(not torch.equal(a, p) for a, p in zip(old, params))
    bad = [n for n, p in state.model.named_parameters() if p.grad is not None and
           (p.grad.dtype != torch.float32 or not bool(torch.isfinite(p.grad).all()))]
    if (not math.isfinite(float(tb['loss'])) or bad or moved < 0.9 * len(params)
            or delta != IMG_F32_WANT['step']):
        raise AssertionError(f'img_f32 train step: loss {float(tb["loss"])}, bad gradients '
                             f'{bad[:5]}, {moved} of {len(params)} moved, launches {delta}, '
                             f'expected {IMG_F32_WANT["step"]}')
    total.update(dict(zip(BF16_TRAIN_KERNELS, delta)))
    print(f'img_f32 train step, batch {TRAIN_BATCH}: {ms:.2f} ms, loss {float(tb["loss"]):.4f}, '
          f'launches ' + ' '.join(f'{n} +{d}' for n, d in zip(BF16_TRAIN_KERNELS, delta) if d)
          + f' (F {delta[-1]}, D {delta[-3]}, E {delta[-2]} in f32)', flush=True)


def _phase30_dense_fp(dev, total):
    """(d) The block-local configuration with ``fp_block`` False: a batch-1
    full-width forward (SA block-local, every FP stage on the dense 3-NN;
    the RCNN's G and B as in phase 14), then the tiny forward card vs
    CPU."""
    import torch
    from epnet_tpu_torch.config import block_local_config, parity_config
    from epnet_tpu_torch.models import pointnet2
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.train.trainer import device_batch
    from epnet_tpu_torch.utils.testing import BLOCK_LOCAL_TINY, full_batch

    cfg = block_local_config(parity_config())
    model = EPNet(cfg, 'TEST', device=dev, fp_block=False,
                  generator=torch.Generator(device=dev).manual_seed(0)).eval()
    batch = device_batch(full_batch(cfg, 1, seed=0), dev)
    model(batch)  # warm-up
    counters = _fwd_counters()
    rec = {}
    with _spying(pointnet2, ('block_local_group_multi', 'block_local_three_interp', 'three_nn'),
                 rec):
        for c in counters:
            c.launches = 0
        out, ms = _timed(lambda: model(batch))
        delta = [c.launches for c in counters]
    _check_out('dense_fp block-local forward', out, {'rcnn_cls': (100, 1)}, delta,
               FWD_WANT['block-local'])
    calls = {k: len(v) for k, v in rec.items()}
    if calls.get('block_local_three_interp') or calls.get('three_nn') != 4 or \
            not calls.get('block_local_group_multi'):
        raise AssertionError(f'dense_fp block-local forward: paths {calls}')
    total.update(dict(zip(FWD_KERNELS, delta)))
    print(f'dense_fp block-local forward, batch 1: {ms:.2f} ms, launches {_fwd_launches(delta)}, '
          f'paths {calls}', flush=True)
    del model
    phase_small_reference(dev, BLOCK_LOCAL_TINY, fp_block=False)


def _phase30_f32_keys(dev, base, batch, counters, total):
    """(e) The headline configuration under the ``nearest`` policy with
    ``ball_f32`` and ``three_nn_f32``: RPN sa0's nearest-first ball (f32
    keys) and FP level 0's approximate 3-NN (f32 field) held to the CPU's
    on the card's inputs."""
    from epnet_tpu_torch.config import headline_config
    from epnet_tpu_torch.models import pointnet2
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.ops.pointops import QueryOptions

    cfg = headline_config()
    model = EPNet(cfg, 'TEST', device=dev, queries=QueryOptions(
        'nearest', ball_f32=True, three_nn_f32=True)).eval()
    model.load_state_dict(base.state_dict())
    model(batch)  # warm-up
    rec = {}
    with _spying(pointnet2, ('ball_query_nested', 'three_nn'), rec):
        for c in counters:
            c.launches = 0
        out, ms = _timed(lambda: model(batch))
        delta = [c.launches for c in counters]
    _check_out('f32 keys forward', out, {'rcnn_cls': (cfg.TEST.RPN_POST_NMS_TOP_N, 1)}, delta,
               HEADLINE_WANT['forward'])
    total.update(dict(zip(FWD_KERNELS, delta)))
    (radii, nsamples, xyz, new_xyz), kw, (idx, cnts) = rec['ball_query_nested'][0]
    args, nn_kw, (dist, nn_idx) = rec['three_nn'][-1]
    if not (kw.get('f32_keys') and nn_kw.get('approx') and nn_kw.get('f32_keys')):
        raise AssertionError(f'f32 keys forward: ball {kw}, three_nn {nn_kw}')
    balls = _check_nested_nearest(idx, cnts, radii, nsamples, xyz, new_xyz, f32_keys=True)
    rows = _check_three_nn(dist, nn_idx, args[0], args[1], approx=True, f32_keys=True)
    print(f'headline, nearest with ball_f32 and three_nn_f32: forward {ms:.2f} ms, launches '
          f'{_fwd_launches(delta)}; {balls} balls and {rows} 3-NN rows differ card vs CPU',
          flush=True)


def _phase30_img_cache(dev, root, total):
    """(f) The eval CLI twice over the tree's 8 train scenes with
    ``--img_cache``, its loader in this process (``--workers 0``: 8 scans
    are too few to amortize the workers' start, which would hide the
    decode): cold (decodes, fills the cache: a ``.npy`` a scene, no
    ``.tmp`` left), then warm on a copy of the tree whose PNGs are cut to
    their header (the shape is still read; the pixels can come only from
    the cache); the same detections; scans/s of each."""
    import shutil

    from epnet_tpu_torch.tools import eval as cli

    cache = os.path.join(OUT, 'img_cache')
    shutil.rmtree(cache, ignore_errors=True)
    cut = os.path.join(OUT, 'kitti_headers')
    shutil.rmtree(cut, ignore_errors=True)
    shutil.copytree(root, cut)
    img_dir = os.path.join(cut, 'KITTI', 'object', 'training', 'image_2')
    for f in os.listdir(img_dir):
        with open(os.path.join(img_dir, f), 'r+b') as fh:
            fh.truncate(33)  # the signature and IHDR: png.read_header's bytes
    counters = _fwd_counters()
    rates, dets = {}, {}
    for name, tree in (('cold', root), ('warm', cut)):
        for c in counters:
            c.launches = 0
        record = []
        out_dir = os.path.join(OUT, f'eval_cache_{name}')
        with timed_cli_loader(counters, record):
            cli.main(['--cfg_file', RECIPE, '--data_root', tree, '--batch_size', str(CLI_BATCH),
                      '--workers', '0', '--output_dir', out_dir, '--device', str(dev),
                      '--img_cache', cache, '--set', 'TEST.SPLIT', 'train'])
        timed = record[0]
        loop = timed.times[-1] - timed.t0
        rates[name] = timed.scans / loop
        dets[name] = _parse_results(os.path.join(out_dir, 'no_ckpt', 'final_result', 'data'))
        delta = [c.launches for c in counters]
        if timed.scans != SEG_SCENES or delta != [v * (SEG_SCENES // CLI_BATCH)
                                                  for v in FWD_WANT['exact']]:
            raise AssertionError(f'img_cache {name} eval: {timed.scans} scans, launches {delta}')
        total.update(dict(zip(FWD_KERNELS, delta)))
        files = sorted(os.listdir(cache))
        if files != ['%06d.npy' % i for i in range(SEG_SCENES)]:
            raise AssertionError(f'img_cache after the {name} pass: {files}')
    worst, n = _compare_detections('img_cache, warm vs cold', dets['warm'], dets['cold'])
    print(f'eval CLI with --img_cache, recipe, batch {CLI_BATCH}, no workers: cold '
          f'{rates["cold"]:.3f} scans/s, warm {rates["warm"]:.3f} scans/s; {SEG_SCENES} cache '
          f'hits of {SEG_SCENES} scans in the warm pass (its PNGs hold no pixels); {n} '
          f'detections agree (worst {worst:.3f} of the bound)', flush=True)


def phase_switches(dev):
    """Phase 30: the JAX package's model and data switches, ported as
    arguments, and its two user tools' paths, at full width: (a) the seg
    harness, (b) ``exact_ops``, (c) ``img_f32``, (d) ``fp_block`` False,
    (e) ``ball_f32`` and ``three_nn_f32``, (f) ``--img_cache`` (see each
    part). Returns the launches."""
    import torch
    from epnet_tpu_torch.config import headline_config, parity_config
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.utils.testing import make_fake_kitti

    t0 = time.perf_counter()
    total = collections.Counter()
    root = os.path.join(OUT, 'kitti_seg')
    make_fake_kitti(root, n_samples=SEG_SCENES, n_val=SEG_VAL, n_points=30000, seed=12)
    _phase30_seg(dev, root, total)
    torch.cuda.empty_cache()
    base = EPNet(headline_config(), 'TEST', device=dev,
                 generator=torch.Generator(device=dev).manual_seed(0)).eval()
    batch = _request(1, parity_config(), dev)
    counters = _fwd_counters()
    _phase30_exact_ops(dev, base, batch, counters, total)
    _phase30_f32_keys(dev, base, batch, counters, total)
    del base
    torch.cuda.empty_cache()
    _phase30_img_f32(dev, total)
    torch.cuda.empty_cache()
    _phase30_dense_fp(dev, total)
    torch.cuda.empty_cache()
    _phase30_img_cache(dev, root, total)
    print(f'phase 30 (switches and tools): {time.perf_counter() - t0:.1f} s; {_smi()}',
          flush=True)
    return total


# phase 31: the research harnesses' overfits on the card (the recorded runs
# take 300 steps; README.md names them)
ABLATION_STEPS = 10
FULLSCALE_KINDS = ('dense', 'block')
# phase 31's launches by path: (a train step's, an evaluation's), with 6
# FPS stages (2, the RCNN's, under SAMPLING random). The tiny tower runs
# 4 F and 4 D (blk0-3) and 2 E; the full-scale kinds are the headline
# configuration's bf16 step and forward.
ABLATION_LAUNCHES = {
    'tiny': ({'fps': 6, 'sa_fused_fwd': 2, 'sa_fused_bwd': 2, 'conv3x3_dw_s2': 4,
              'conv3x3_dw_s1': 2, 'conv3x3_s2_fwd': 4},
             {'fps': 6, 'sa_fused_fwd': 2, 'conv3x3_s2_fwd': 4}),
    'dense': ({'fps': 6, 'sa_fused_fwd_bf16': 2, 'sa_fused_bwd_bf16': 2,
               'conv3x3_dw_s2_bf16': 4, 'conv3x3_dw_s1_bf16': 3, 'conv3x3_s2_fwd_bf16': 4},
              {'fps': 6, 'sa_fused_fwd_bf16': 2, 'conv3x3_s2_fwd_bf16': 4}),
    'block': ({'fps': 6, 'sa_fused_fwd_bf16': 1, 'sa_fused_win_fwd_bf16': 1,
               'sa_fused_bwd_bf16': 1, 'sa_fused_win_bwd_bf16': 1, 'conv3x3_dw_s2_bf16': 4,
               'conv3x3_dw_s1_bf16': 3, 'conv3x3_s2_fwd_bf16': 4},
              {'fps': 6, 'sa_fused_fwd_bf16': 1, 'sa_fused_win_fwd_bf16': 1,
               'conv3x3_s2_fwd_bf16': 4})}


def _ablation_want(path, steps, evals, fps=6):
    """The launches of ``steps`` train steps and ``evals`` evaluations on
    ``path`` with ``fps`` FPS stages each."""
    step, ev = ABLATION_LAUNCHES[path]
    out = collections.Counter({k: v * steps for k, v in step.items()})
    out.update({k: v * evals for k, v in ev.items()})
    out['fps'] = fps * (steps + evals)
    return +out


def _all_counters():
    """Every kernel wrapper's launch counter, by its name in the kernels line."""
    from epnet_tpu_torch.ops import sa_fused
    return {**dict(zip(TRAIN_CLI_KERNELS, _train_cli_counters())),
            **dict(zip(FWD_KERNELS, _fwd_counters())),
            'sa_fused_win_bwd': sa_fused.fused_point_mlp_max_win_bwd_kernel,
            'sa_fused_win_bwd_bf16': sa_fused.fused_point_mlp_max_win_bwd_bf16_kernel}


def _counted(fn):
    """(fn(), its launches by kernel): the counters set to 0 just before."""
    counters = _all_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    return out, collections.Counter({n: c.launches for n, c in counters.items() if c.launches})


def _eval_card_vs_cpu(name, cfg, model, batch, dev):
    """``tools/ablation.evaluate``'s path for ``model``'s weights under
    ``cfg``, on the card and on the CPU (plain versions): every FPS call's
    picks identical, ``joint_eval_step``'s boxes, scores and RoIs and the
    per-gt IoU within phase 4's bound 1e-3 (1 + max|x|). Returns the worst
    share of the bound."""
    import torch
    from epnet_tpu_torch.eval.detect import joint_eval_step
    from epnet_tpu_torch.models import pointnet2
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.tools import ablation
    from epnet_tpu_torch.train.trainer import device_batch

    res, picks = {}, {}
    for side, where in (('card', dev), ('cpu', torch.device('cpu'))):
        test = EPNet(cfg, 'TEST', device=where)
        test.load_state_dict(model.state_dict())
        test.eval()
        rec = {}
        with _spying(pointnet2, ('furthest_point_sample',), rec):
            res[side] = {k: v.float().cpu() for k, v in joint_eval_step(
                cfg, test, device_batch(batch, where)).items()
                if k in ('pred_boxes3d', 'norm_scores', 'rois')}
        picks[side] = [out.cpu() for _, _, out in rec.get('furthest_point_sample', [])]
        res[side]['per-gt IoU'] = torch.tensor(ablation.per_gt_iou(res[side], batch))
    if len(picks['card']) != len(picks['cpu']) or not all(
            torch.equal(a, b) for a, b in zip(picks['card'], picks['cpu'])):
        raise AssertionError(f'{name}: FPS picks differ card vs CPU')
    worst = 0.0
    for k, want in res['cpu'].items():
        err = float((res['card'][k] - want).abs().max())
        bound = 1e-3 * (1.0 + float(want.abs().max()))
        worst = max(worst, err / bound)
        if not err <= bound:
            raise AssertionError(f'{name}: {k} off by {err:.3e} card vs CPU')
    return worst, len(picks['cpu'])


def _phase31_tiny(dev, module, total):
    """A tiny harness (``sampling_ablation`` or ``block_local_ablation``) for
    ``ABLATION_STEPS`` steps a cell under ``EXACT_QUERIES`` 'residual' (the
    policy of phases 4 and 16: block-local grouping where the config asks
    for it, every other query exact); every cell's evaluation, the swaps
    included, again card vs CPU."""
    import numpy as np
    from epnet_tpu_torch.tools import ablation
    from epnet_tpu_torch.utils.testing import synthetic_batch

    name = module.__name__.rsplit('.', 1)[-1]
    args = module.parse_args(['--steps', str(ABLATION_STEPS), '--device', str(dev),
                              '--exact_queries', 'residual'])
    t0 = time.perf_counter()
    out, launches = _counted(lambda: module.run(args))
    seconds = time.perf_counter() - t0
    total.update(launches)
    steps = ABLATION_STEPS
    if name == 'sampling_ablation':  # fps, fps-G8, random, then the swaps' evaluations
        want = (_ablation_want('tiny', 2 * steps, 2) + _ablation_want('tiny', steps, 1, fps=2)
                + _ablation_want('tiny', 0, 1) + _ablation_want('tiny', 0, 1, fps=2))
    else:  # dense and block-local (its RCNN dense), then the swap's evaluation
        want = _ablation_want('tiny', 2 * steps, 3)
    if launches != want:
        raise AssertionError(f'{name}: launches {dict(launches)}, expected {dict(want)}')
    for r in out:
        if 'loss' in r and not math.isfinite(r['loss']):
            raise AssertionError(f'{name} {r["name"]}: loss {r["loss"]}')
        if len(r['ious']) != 6:
            raise AssertionError(f'{name} {r["name"]}: {len(r["ious"])} IoUs for 6 gts')
    base = ablation.with_queries(module.base_config(), 'residual')
    models = [r['model'] for r in out if 'model' in r]
    if name == 'sampling_ablation':  # the three consistent cells, then the swaps
        cfgs = [base.merged({'RPN': over}) for _, over in module.MODES]
        cells = list(zip(cfgs, models)) + [(cfgs[0].merged({'RPN': over}), models[0])
                                           for _, over in module.MODES[1:]]
    else:  # dense, block-local, then the dense weights block-local
        cfgs = [base, base.merged({'RPN': {'BLOCK_LOCAL': True}})]
        cells = list(zip(cfgs, models)) + [(cfgs[1], models[0])]
    batches = {c.RPN.BLOCK_LOCAL: synthetic_batch(np.random.RandomState(11), c, batch=2,
                                                  structured=True) for c in cfgs}
    worst, n_fps = 0.0, 0
    for r, (cfg, model) in zip(out, cells):
        w, n = _eval_card_vs_cpu(f'{name} {r["name"]}', cfg, model,
                                 batches[cfg.RPN.BLOCK_LOCAL], dev)
        worst, n_fps = max(worst, w), n_fps + n
    print(f'{name}, {ABLATION_STEPS} steps a cell on the card: {seconds:.1f} s, launches '
          f'{dict(launches)}; ' + '; '.join(
              f'{r["name"]}: ' + (f'loss {r["loss"]:.3f}, {r["median_step_ms"]:.1f} ms a step, '
                                  if 'loss' in r else '') + f'min IoU {r["min"]:.3f}'
              for r in out), flush=True)
    print(f'{name}: {len(out)} evaluations card vs CPU, {n_fps} FPS calls with identical '
          f'picks, worst {worst:.3f} of the bound 1e-3 * (1 + max|x|)', flush=True)


def _phase31_fullscale(dev, total):
    """``block_local_fullscale`` ``dense`` and ``block`` at full width
    (the headline config in bf16 with the approximate queries, batch 2),
    ``ABLATION_STEPS`` steps each: finite losses, each kind's kernels."""
    import torch
    from epnet_tpu_torch.tools import block_local_fullscale as fs

    for kind in FULLSCALE_KINDS:
        args = fs.parse_args([kind, '--steps', str(ABLATION_STEPS), '--device', str(dev)])
        t0 = time.perf_counter()
        (r,), launches = _counted(lambda: fs.run(args))
        seconds = time.perf_counter() - t0
        total.update(launches)
        want = _ablation_want(kind, ABLATION_STEPS, 1)
        if not math.isfinite(r['loss']) or launches != want or len(r['ious']) < 6:
            raise AssertionError(f'full-scale {kind}: loss {r["loss"]}, {len(r["ious"])} IoUs, '
                                 f'launches {dict(launches)}, expected {dict(want)}')
        print(f'block_local_fullscale {kind}, {ABLATION_STEPS} steps at full width: '
              f'{seconds:.1f} s, loss {r["loss"]:.3f}, median step {r["median_step_ms"]:.1f} ms, '
              f'per-gt IoU {[round(v, 3) for v in r["ious"]]} (min {r["min"]:.3f} mean '
              f'{r["mean"]:.3f}); launches {dict(launches)}', flush=True)
        del r
        torch.cuda.empty_cache()


def phase_ablations(dev):
    """Phase 31: the research harnesses on the card (``epnet_tpu_torch/
    tools``): the sampling and block-local ablations at tiny widths, their
    evaluations card vs CPU, and the full-scale block-local overfit's
    ``dense`` and ``block`` kinds at full width. Returns the launches."""
    from epnet_tpu_torch.tools import block_local_ablation, sampling_ablation

    t0 = time.perf_counter()
    total = collections.Counter()
    _phase31_tiny(dev, sampling_ablation, total)
    _phase31_tiny(dev, block_local_ablation, total)
    _phase31_fullscale(dev, total)
    print(f'phase 31 (research harnesses): {time.perf_counter() - t0:.1f} s; {_smi()}',
          flush=True)
    return total


RECIPE_IOU = 'cfgs/LI_Fusion_with_attention_use_ce_loss_iou_branch.yaml'
PEOPLE_SET = [('CLASSES', 'People'), ('RCNN.LOSS_CLS', 'CrossEntropy')]


def _f32_step(name, state, batch, gen, total):
    """One full-width f32 step: finite loss, 6 FPS, 2 B, 2 C, 4 D, 3 E and 4
    F launches; adds them to ``total``."""
    from epnet_tpu_torch.train.trainer import train_step
    counters = _bf16_train_counters()
    for c in counters:
        c.launches = 0
    tb, ms = _timed(lambda: train_step(state, batch, 0.1, gen))
    delta = [c.launches for c in counters]
    if not math.isfinite(float(tb['loss'])) or delta != F32_STEP_WANT:
        raise AssertionError(f'{name}: loss {float(tb["loss"])}, launches {delta}, expected '
                             f'{F32_STEP_WANT}')
    total.update(dict(zip(BF16_TRAIN_KERNELS, delta)))
    print(f'{name}: {ms:.2f} ms, loss {float(tb["loss"]):.4f}, rcnn fg '
          f'{int(tb["rcnn_cls_fg"])}', flush=True)
    return tb


def _near_gt_target_layer():
    """``proposal_target_layer`` with each image's first RoIs replaced by
    its gt boxes moved 0.15 m and grown 5% (where the gt is real): with
    random weights the proposals miss the cars, and the RCNN's foreground
    terms (the IoU branch's loss, People's car class) need RoIs on them."""
    import torch
    from epnet_tpu_torch.models import epnet as epnet_mod
    real = epnet_mod.proposal_target_layer

    def layer(rois, gt_boxes3d, *args, **kwargs):
        gt = gt_boxes3d[..., :7]
        near = torch.cat([gt[..., 0:1] + 0.15, gt[..., 1:3], gt[..., 3:6] * 1.05, gt[..., 6:]], -1)
        k = min(gt.shape[1], rois.shape[1])
        rois = rois.clone()
        rois[:, :k] = torch.where((gt[:, :k] != 0).any(-1, keepdim=True), near[:, :k], rois[:, :k])
        return real(rois, gt_boxes3d, *args, **kwargs)

    return layer


def phase_recipe_rows(dev):
    """Phase 27: the last recipe rows at full width (f32). The IoU-branch
    recipe (``cfgs/..._iou_branch.yaml``): a batch-4 train step and a
    batch-1 joint eval step with the IoU fusion; its step and People's
    take RoIs moved off the gt boxes (``_near_gt_target_layer``), so the
    IoU loss and the car class see foreground RoIs. Score-based proposals
    under ``NMS_TYPE: rotate``: a TEST forward and a train step, and the
    proposal layer at TRAIN and TEST budgets (9000 candidates, one rotated
    scan each) on a forward's RPN outputs, its keep list held against the
    CPU's on the same boxes, the card's time printed. People: a train step
    and a joint eval step (three logits). ``adam`` and ``sgd``: three steps
    each, the third also from a checkpoint of the second, whose update must
    match. Every step 6 FPS, 2 B, 2 C, 4 D, 3 E and 4 F launches, every
    forward 6 FPS, 2 B and 4 F."""
    from unittest import mock

    import torch
    from epnet_tpu_torch.config import load_config, parity_config
    from epnet_tpu_torch.eval.detect import joint_eval_step
    from epnet_tpu_torch.models import epnet as epnet_mod
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.train.trainer import (create_train_state, load_checkpoint,
                                               save_checkpoint)

    total = collections.Counter()
    R = parity_config().TEST.RPN_POST_NMS_TOP_N
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = _train_batch(parity_config(), 0, dev)
    request = _request(1, parity_config(), dev)
    fwd_counters = _fwd_counters()

    def forward(name, model, fn=None):
        for c in fwd_counters:
            c.launches = 0
        out, ms = _timed(lambda: (fn or model)(request))
        delta = [c.launches for c in fwd_counters]
        if delta != F32_FWD_WANT:
            raise AssertionError(f'{name}: launches {delta}, expected {F32_FWD_WANT}')
        total.update(dict(zip(FWD_KERNELS, delta)))
        print(f'{name}: {ms:.2f} ms', flush=True)
        return out

    cfg = load_config(RECIPE_IOU)
    state = create_train_state(cfg, 100, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    with mock.patch.object(epnet_mod, 'proposal_target_layer', _near_gt_target_layer()):
        tb = _f32_step('IoU-branch recipe train step', state, batch, gen, total)
    fg = int(tb['rcnn_reg_fg'])
    grad = float(state.model.rcnn.iou_out.weight.grad.abs().sum())
    # the loss clips the raw logit to [1e-4, 1 - 1e-4] (losses.py, as the
    # JAX package), so a freshly drawn head outside that range has no gradient
    if not (float(tb['iou_branch_loss']) > 0 and fg > 0 and math.isfinite(grad)):
        raise AssertionError(f'IoU-branch step: IoU-branch loss {float(tb["iou_branch_loss"])}, '
                             f'iou_out gradient {grad} with {fg} foreground RoIs')
    print(f'  IoU-branch loss {float(tb["iou_branch_loss"]):.4f} over {fg} foreground RoIs, '
          f'|iou_out gradient| {grad:.3e}', flush=True)
    model = EPNet(cfg, 'TEST', device=dev).eval()
    model.load_state_dict(state.model.state_dict())
    res = forward('IoU-branch joint eval step (fusion)', model,
                  lambda b: joint_eval_step(cfg, model, b))
    _check_out('IoU-branch eval', {k: res[k] for k in ('raw_scores', 'pred_boxes3d')},
               {'raw_scores': (1, R), 'pred_boxes3d': (1, R, 7)}, None, None)
    del state, model

    cfg = parity_config().with_overrides([('RPN.NMS_TYPE', 'rotate'),
                                          ('TRAIN.RPN_DISTANCE_BASED_PROPOSE', 'False'),
                                          ('TEST.RPN_DISTANCE_BASED_PROPOSE', 'False')])
    model = EPNet(cfg, 'TEST', device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    model.eval()(request)  # warm-up
    out = forward('score-based rotated proposals, TEST forward', model)
    _check_out('score-based forward', out, {'rois': (1, R, 7), 'rcnn_cls': (R, 1)}, None, None)
    from epnet_tpu_torch.models.proposal import ProposalLayer
    args = (out['rpn_cls'][..., 0], out['rpn_reg'], out['backbone_xyz'])
    for mode in ('TRAIN', 'TEST'):
        layer = ProposalLayer(cfg, mode)
        layer(*args)  # warm-up
        (rois, scores, counts), ms = _timed(lambda: layer(*args))
        want = layer(*(a.cpu() for a in args))
        if not (torch.equal(counts.cpu(), want[2]) and torch.equal(scores.cpu(), want[1])
                and torch.allclose(rois.cpu(), want[0], rtol=1e-5, atol=1e-5)):
            raise AssertionError(f'score-based rotated proposals ({mode}): the card\'s keep '
                                 f'list differs from the CPU\'s')
        print(f'score-based rotated proposals, {mode} budget ({cfg.get(mode).RPN_PRE_NMS_TOP_N}'
              f' -> {cfg.get(mode).RPN_POST_NMS_TOP_N}): {ms:.2f} ms on the card, '
              f'{int(counts[0])} kept, keep list identical to the CPU\'s', flush=True)
    del model
    state = create_train_state(cfg, 100, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    _f32_step('score-based rotated proposals, train step', state, batch, gen, total)
    del state

    cfg = parity_config().with_overrides(PEOPLE_SET)
    state = create_train_state(cfg, 100, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    with mock.patch.object(epnet_mod, 'proposal_target_layer', _near_gt_target_layer()):
        tb = _f32_step('People train step', state, batch, gen, total)
    if state.model.rcnn.cls_out.weight.shape[0] != 3 or not int(tb['rcnn_cls_fg']) > 0:
        raise AssertionError(f'People: cls head of {state.model.rcnn.cls_out.weight.shape[0]} '
                             f'logits, {int(tb["rcnn_cls_fg"])} foreground RoIs')
    model = EPNet(cfg, 'TEST', device=dev).eval()
    model.load_state_dict(state.model.state_dict())
    res = forward('People joint eval step', model, lambda b: joint_eval_step(cfg, model, b))
    s = res['norm_scores']
    if not bool(((s >= 0) & (s <= 1)).all()):
        raise AssertionError('People eval: scores outside [0, 1]')
    del state, model

    ckpt_dir = os.path.join(OUT, 'recipe_rows_ckpt')
    for name in ('adam', 'sgd'):
        cfg = parity_config().with_overrides([('TRAIN.OPTIMIZER', name)])
        state = create_train_state(cfg, 100, device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(0),
                                   steps_per_epoch=2)
        for k in range(2):
            _f32_step(f'{name} step {k + 1}', state, batch,
                      torch.Generator(device=dev).manual_seed(k), total)
        path = save_checkpoint(ckpt_dir, state, epoch=0)
        resumed = create_train_state(cfg, 100, device=dev, steps_per_epoch=2)
        resumed, _ = load_checkpoint(path, resumed)
        before = [p.detach().clone() for p in state.model.parameters()]
        updates = []
        for st in (state, resumed):
            _f32_step(f'{name} step 3' + (' from the checkpoint' if st is resumed else ''), st,
                      batch, torch.Generator(device=dev).manual_seed(2), total)
            updates.append(torch.cat([(p.detach() - b).flatten()
                                      for p, b in zip(st.model.parameters(), before)]))
        gap = float((updates[0] - updates[1]).norm() / updates[0].norm())
        if not (resumed.optimizer.count == state.optimizer.count == 3 and gap <= 1e-3):
            raise AssertionError(f'{name}: the resumed step\'s update differs by {gap:.3e} of '
                                 f'its norm')
        print(f'{name}: resumed step 3 matches (update gap {gap:.2e} of its norm; the atomic '
              f'f32 sums of dY make two runs differ in the last bits)', flush=True)
        del state, resumed
    return total


DP_WORLD = 2
# world 2 vs world 1: tests/test_torch_data_parallel.py's tolerances against JAX's mesh step
# (those of tests/test_torch_train_step.py, the RPN heads at 1e-2: JAX's own 2-device step
# differs from its one-device step by 6.0e-3 there); that file's tiny world-2 step against
# world 1 holds tighter on the CPU
DP_TB_RTOL, DP_TB_ATOL = 1e-4, 1e-6
DP_STATS_RTOL, DP_STATS_ATOL = 1e-4, 1e-5
DP_HEAD_TOL, DP_RPN_HEAD_TOL, DP_BACKBONE_TOL = 1e-3, 1e-2, 0.25
DP_BACKBONE_NORM, DP_GRAD_NORM_RTOL = 0.1, 1e-3
DP_STEP_WANT = [6, 2, 2, 4, 3, 4]  # a rank's step, in TRAIN_NAMES' order, as at world 1


def _dp_grad_tol(name):
    if name.startswith('rpn.backbone.'):
        return DP_BACKBONE_TOL
    return DP_RPN_HEAD_TOL if name.startswith(('rpn.cls_', 'rpn.reg_')) else DP_HEAD_TOL


def _smi():
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def _pinned(targets, rows):
    """``proposal_target_layer`` that draws as the real one (so that the
    generator moves on alike) and returns ``rows`` of the recorded
    ``targets`` instead of its own."""
    from epnet_tpu_torch.models import epnet as epnet_mod
    from epnet_tpu_torch.models.target_assign import RCNNTargets
    real = epnet_mod.proposal_target_layer

    def layer(*args, **kwargs):
        real(*args, **kwargs)
        return RCNNTargets(**{k: v[rows] for k, v in targets.items()})

    return layer


def _recording(seen):
    from epnet_tpu_torch.models import epnet as epnet_mod
    real = epnet_mod.proposal_target_layer

    def layer(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    return layer


def _step_record(state):
    model = state.model
    return {'grads': {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            'params': {n: p.detach().cpu().clone() for n, p in model.named_parameters()},
            'stats': {k: v.cpu().clone() for k, v in model.state_dict().items()
                      if k.endswith(('running_mean', 'running_var'))}}


def _dp_rank(mesh, cfg, targets_path, bnm):
    """One rank of phase 28 (spawned by ``run_ranks``): step A on its rows
    of scene 3's batch with the world-1 step's targets pinned; then, from
    the state after A, batches 0 and 1 as two single steps (their targets
    recorded) and again as one ``Trainer`` call of ``steps_per_call`` 2
    with those targets pinned. Returns what the parent compares and the
    kernels' launches."""
    import torch
    from unittest import mock
    from epnet_tpu_torch.models import epnet as epnet_mod
    from epnet_tpu_torch.parallel.mesh import shard_batch
    from epnet_tpu_torch.train.trainer import Trainer, create_train_state, train_step

    dev = mesh.device
    n = TRAIN_BATCH // mesh.world
    per_rank = n * cfg.RCNN.ROI_PER_IMAGE
    rows = slice(mesh.rank * per_rank, (mesh.rank + 1) * per_rank)
    batches = {s: shard_batch(mesh, _train_batch(cfg, s, dev)) for s in (3,) + TRAIN_SEEDS[:2]}
    targets = torch.load(targets_path, map_location=dev, weights_only=True)
    counters = _train_counters()
    for c in counters:
        c.launches = 0
    state = create_train_state(cfg, total_steps=100, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    with mock.patch.object(epnet_mod, 'proposal_target_layer', _pinned(targets, rows)):
        tb = train_step(state, batches[3], bnm, torch.Generator(device=dev).manual_seed(1), mesh)
    out = {'A': {**_step_record(state), 'tb': {k: float(v) for k, v in tb.items()},
                 'lr': state.optimizer.lr(0)},
           'launches_A': [c.launches for c in counters]}
    saved = ({k: v.clone() for k, v in state.model.state_dict().items()},
             state.optimizer.state_dict())

    gen = torch.Generator(device=dev).manual_seed(2)
    losses, seen, times, reduces = [], [], [], []
    for s in TRAIN_SEEDS[:2]:
        count = dict(mesh.stats)
        with mock.patch.object(epnet_mod, 'proposal_target_layer', _recording(seen)):
            tb, ms = _timed(lambda: train_step(state, batches[s], bnm, gen, mesh))
        times.append(ms)
        reduces.append({k: v - count[k] for k, v in mesh.stats.items()})
        losses.append(float(tb['loss']))
    out['singles'] = {'losses': losses, 'ms': times, 'all_reduces': reduces,
                      'params': _step_record(state)['params']}

    def restore():
        state.model.load_state_dict(saved[0])
        state.optimizer.load_state_dict(saved[1])
        state.step = 1

    recorded = {f: torch.cat([getattr(t, f) for t in seen]) for f in seen[0]._fields}
    per_step = seen[0].cls_label.shape[0]

    def pinned_steps():
        layers = iter([_pinned(recorded, slice(0, per_step)),
                       _pinned(recorded, slice(per_step, 2 * per_step))])
        return mock.patch.object(epnet_mod, 'proposal_target_layer',
                                 lambda *a, **k: next(layers)(*a, **k))

    # the two single steps again, on the same targets: the card's run-to-run floor
    restore()
    gen = torch.Generator(device=dev).manual_seed(2)
    with pinned_steps():
        for s in TRAIN_SEEDS[:2]:
            train_step(state, batches[s], bnm, gen, mesh)
    out['singles']['again'] = _step_record(state)['params']

    restore()
    calls = []
    trainer = Trainer(cfg, state, ckpt_dir=os.path.join(OUT, 'dp_ckpt'), seed=2, device=dev,
                      mesh=mesh, steps_per_call=2)
    dispatch = trainer._dispatch

    def recorded_dispatch(pending, bnm_):
        tb = dispatch(pending, bnm_)
        calls.append({k: float(v) for k, v in tb.items()})
        return tb

    trainer._dispatch = recorded_dispatch
    with pinned_steps():
        trainer.train(0, 1, [batches[s] for s in TRAIN_SEEDS[:2]])
    out['multi'] = {'calls': calls, 'params': _step_record(state)['params'], 'step': state.step}
    out['launches'] = [c.launches for c in counters]
    return out


def _sync_sites(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode('warn')``: its result
    and the (file, line) of the Python frame of each synchronizing call."""
    import warnings
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    return out, [(os.path.relpath(w.filename), w.lineno) for w in caught
                 if 'synchroniz' in str(w.message)]


@contextlib.contextmanager
def _nms_launches_by_span(rec):
    """Counts the NMS kernel's calls by the innermost open span of the
    recording ``rec``; the wrapper's own ``.launches`` keeps counting."""
    from epnet_tpu_torch.ops import nms

    real, where = nms.nms_bev_kernel, collections.Counter()

    def spy(*args, **kw):
        where[rec.stack[-1] if rec.stack else None] += 1
        try:
            return real(*args, **kw)
        finally:  # the wrapper counted on the module's name, the spy
            real.launches = spy.launches

    spy.launches = real.launches
    nms.nms_bev_kernel = spy  # nms_bev looks it up at each call
    try:
        yield where
    finally:
        nms.nms_bev_kernel = real


def phase_trace(dev):
    import torch
    from epnet_tpu_torch.config import parity_config
    from epnet_tpu_torch.eval.detect import joint_eval_step
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.ops import sa_fused
    from epnet_tpu_torch.train.trainer import create_train_state, train_step
    from epnet_tpu_torch.utils import trace

    cfg = parity_config()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = EPNet(cfg, 'TEST', device=dev, generator=gen).eval()
    requests = [_request(seed, cfg, dev) for seed in (0, 1, 2)]
    state = create_train_state(cfg, total_steps=100, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    batches = [_train_batch(cfg, seed, dev) for seed in (3, 0, 1)]
    draws = torch.Generator(device=dev).manual_seed(1)
    calls = {'eval request, batch 1': (1, [lambda b=b: joint_eval_step(cfg, model, b)
                                           for b in requests]),
             f'train step, batch {TRAIN_BATCH}': (TRAIN_BATCH, [
                 lambda b=b: train_step(state, b, 0.1, draws) for b in batches])}
    here = os.path.relpath(trace.__file__)
    for what, (scans, fns) in calls.items():
        fns[0]()  # warm-up
        torch.cuda.synchronize()
        counted, made, others = 0, 0, collections.Counter()
        for fn in fns[1:]:
            with trace.recording() as rec, _nms_launches_by_span(rec) as nms_where:
                _, sites = _sync_sites(fn)
                torch.cuda.synchronize()
            counts = rec.snapshot()['counts']
            counted += sum(v for (_, k), v in counts.items() if k == 'host_syncs')
            made += sum(1 for f, _ in sites if f == here)
            others.update((f, line) for f, line in sites if f != here)
            launched = counts[(None, 'launches.nms_bev_kernel')]
            if nms_where != {'proposal': 2 * scans} or launched != 2 * scans:
                raise AssertionError(f'{what}: NMS kernel launches {launched}, by span '
                                     f'{dict(nms_where)}; want {2 * scans}, all in proposal')
        n = len(fns) - 1
        print(f'tracer, {what}: host_syncs {counted / n:g} a call, synchronizing calls in '
              f'trace.host_int {made / n:g}, elsewhere {sum(others.values()) / n:g}; '
              f'launches.nms_bev_kernel {2 * scans} a call, all in proposal, none in detect',
              flush=True)
        for (f, line), k in sorted(others.items()):
            print(f'  not counted: {f}:{line} {k / n:g} a call', flush=True)
        if counted != made:
            raise AssertionError(f'{what}: host_syncs {counted}, but {made} synchronizing '
                                 f'calls in trace.host_int')
    del model, state, batches

    name, (T, N, M, S, C1, C2, C3), _, args = [c for c in sa_cases(dev, train=True)
                                               if c[2] == 'real'][0]
    with trace.recording() as rec:
        sa_fused.fused_point_mlp_max_kernel(*args[:7])
        sa_fused.fused_point_mlp_max_bwd_kernel(*args)
    counts = rec.snapshot()['counts']
    recount = int(_distinct_rows(args[2])[1].sum())
    for way in ('fwd', 'bwd'):
        got = (counts[(None, 'sa_rows_distinct.' + way)],
               counts[(None, 'sa_rows_gathered.' + way)])
        print(f'tracer, {name} {way}: distinct rows {got[0]} of {got[1]} gathered '
              f'({100 * got[0] / got[1]:.2f}%); _distinct_rows {recount} of {T * M * S}',
              flush=True)
        if got != (recount, T * M * S):
            raise AssertionError(f'{name} {way}: the tracer counts {got}, the recount '
                                 f'{(recount, T * M * S)}')


NMS_DESIGN = ('one block of 512 threads a call: the (N, 5) boxes read from device memory '
              '(L1) at every step, a removed-bitmap of 64-bit words in shared memory; the '
              'next kept box by warp ballots and __ffsll, then one N-wide IoU pass (ballots, '
              'atomicOr) and one barrier a kept box')
# the operations greedy NMS needs: 13 an IoU (4 max/min, 2 differences, 2 clamps, the product,
# the areas' sum, the difference, the clamp at EPS, the division) beside 3 a box's area
NMS_IOU_OPS, NMS_AREA_OPS = 13, 3


def phase_nms(dev):
    import numpy as np
    import torch
    from epnet_tpu_torch.config import parity_config
    from epnet_tpu_torch.ops import cuda_build, nms
    from epnet_tpu_torch.utils.testing import proposal_inputs, proposal_nms_calls

    lib = nms._lib()
    for line in cuda_build.build_log('nms').splitlines():
        if 'registers' in line or 'smem' in line or 'spill' in line:
            print(f'  nms: {line.strip()}')
    rng = np.random.RandomState(9)
    n = 18415
    ctr = rng.uniform(-40, 40, (n, 2))
    wh = rng.uniform(1.0, 4.0, (n, 2))
    big = torch.from_numpy(np.concatenate([ctr - wh / 2, ctr + wh / 2, np.zeros((n, 1))],
                                          1).astype(np.float32)).to(dev)
    cfg = parity_config()
    inputs = proposal_inputs(cfg, 5, dev, ties=True)
    cases = [(f'{mode} {("near", "far")[k % 2]} scan {k // 2}', a, kw)
             for mode in ('TEST', 'TRAIN')
             for k, (a, kw) in enumerate(proposal_nms_calls(cfg, mode, inputs)[0])] + [
        (f'a long walk, {n} boxes',
         (big, torch.rand(n, device=dev), 0.3), {'max_keep': 1000, 'num_valid': n})]
    rows, ms, wrap_ms, plain_ms, op_ms, byte_ms = [], 0.0, 0.0, 0.0, [], []
    for name, args, kw in cases:
        kw = {k: v for k, v in kw.items() if k != 'rotated'}
        got, cnt = nms.nms_bev_kernel(*args, **kw)
        want, want_cnt = nms.nms_bev_plain(*args, **kw)
        if cnt != want_cnt or not torch.equal(got, want):
            raise AssertionError(f'nms kernel differs from plain at {name}: count {cnt} vs '
                                 f'{want_cnt}, {int((got != want).sum())} of {got.numel()} '
                                 f'indices')
        boxes, scores, thresh = args
        N, nv, max_keep = boxes.shape[0], kw['num_valid'], kw['max_keep']
        order = torch.argsort(-scores, stable=True)
        sb = boxes[order].contiguous()
        ranks = torch.empty(max_keep, dtype=torch.int64, device=dev)
        count = torch.empty(1, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def launch():
            lib.epnet_nms_launch(sb.data_ptr(), nv, thresh, max_keep, ranks.data_ptr(),
                                 count.data_ptr(), stream)
        k = _time_ms(launch, 50)
        w = _time_ms(lambda: nms.nms_bev_kernel(*args, **kw), 20)
        p = _time_ms(lambda: nms.nms_bev_plain(*args, **kw), 3)
        kept = ranks[:cnt].cpu().numpy()
        pairs = int(np.sum(nv - 1 - kept[:-1])) if cnt > 1 else 0
        o, m = _bound(NMS_IOU_OPS * pairs + NMS_AREA_OPS * nv, 20 * nv + 8 * cnt + 4)
        smem = (nv + 63) // 64 * 8  # the bitmap
        row = {'name': name, 'boxes': N, 'num_valid': nv, 'max_keep': max_keep,
               'thresh': thresh, 'kept': cnt, 'smem_bytes': smem, 'ms': k,
               'us_per_kept': 1e3 * k / max(cnt, 1), 'wrapper_ms': w, 'plain_ms': p,
               'bound_ms': max(o, m), 'iou_pairs': pairs}
        print(f'nms {name}: {N} boxes, {nv} valid, thresh {thresh}, kept {cnt} of {max_keep} '
              f'(identical to plain); {smem} B of shared memory; kernel {k:.4f} ms '
              f'({row["us_per_kept"]:.3f} us a kept box), wrapper {w:.4f} ms, plain {p:.4f} ms; '
              f'bound {max(o, m):.6f} ms '
              f'({pairs} IoUs at the f32 peak {o:.6f}, bytes {m:.6f})', flush=True)
        rows.append(row)
        if 'scan' in name:
            ms, wrap_ms, plain_ms = ms + k, wrap_ms + w, plain_ms + p
            op_ms.append(o)
            byte_ms.append(m)
    print(f'nms: the proposal layer\'s TEST and TRAIN calls on 2 scans: kernel {ms:.4f} ms, '
          f'wrapper {wrap_ms:.4f} ms, plain {plain_ms:.4f} ms', flush=True)
    return {'max_abs_err': 0, 'ms': ms, 'wrapper_ms': wrap_ms, 'plain_ms': plain_ms,
            **_bound_keys(op_ms, byte_ms), 'library_ms': None, 'per_shape': rows}


def phase_data_parallel(dev):
    """Phase 28: data-parallel training on the card. Two ranks
    (``parallel/mesh.run_ranks``, gloo, both on this card: NCCL refuses two
    ranks on one device) each take 2 rows of a batch-4 full-width recipe
    step (f32, exact queries, seeded weights, phase 6's structured scenes),
    against this process's one-process step on the same global batch and
    seed; the RCNN's targets are the one-process step's, pinned on the
    ranks (the proposals' order moves with the roundoff of the batch
    statistics' sums). Then the ranks run batches 0 and 1 as one
    ``Trainer`` call of ``steps_per_call`` 2 against two single steps.
    Tolerances are ``tests/test_torch_data_parallel.py``'s against JAX's
    mesh step (``DP_*``): at full width the RPN cls head's first layer, a
    BatchNorm and ReLU over 65536 points behind the backbone, moves on the
    roundoff of the split sums (4.2e-3 of its scale, H100 run DR), as JAX's
    own 2-device step moves it (6.0e-3 at tiny widths on the CPU)."""
    import torch
    from unittest import mock
    from epnet_tpu_torch.config import parity_config
    from epnet_tpu_torch.models import epnet as epnet_mod
    from epnet_tpu_torch.parallel.mesh import run_ranks
    from epnet_tpu_torch.train.schedules import bn_momentum_at
    from epnet_tpu_torch.train.trainer import create_train_state, train_step
    from epnet_tpu_torch.utils.testing import check_adam_step, check_gradients, leaf_errors

    t0 = time.perf_counter()
    cfg = parity_config()
    bnm = bn_momentum_at(cfg, 0)
    state = create_train_state(cfg, total_steps=100, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    before = {k: p.detach().cpu().clone() for k, p in state.model.named_parameters()}
    batches = {s: _train_batch(cfg, s, dev) for s in (3,) + TRAIN_SEEDS[:2]}
    counters = _train_counters()
    for c in counters:
        c.launches = 0
    seen = []
    with mock.patch.object(epnet_mod, 'proposal_target_layer', _recording(seen)):
        tb = train_step(state, batches[3], bnm, torch.Generator(device=dev).manual_seed(1))
    one = {**_step_record(state), 'tb': {k: float(v) for k, v in tb.items()}}
    gen = torch.Generator(device=dev).manual_seed(2)
    one_ms = [_timed(lambda: train_step(state, batches[s], bnm, gen))[1] for s in TRAIN_SEEDS[:2]]
    launches_one = [c.launches for c in counters]
    path = os.path.join(OUT, 'dp_targets.pt')
    os.makedirs(OUT, exist_ok=True)
    torch.save({k: v.cpu() for k, v in seen[0]._asdict().items()}, path)
    del state, seen
    torch.cuda.empty_cache()

    ranks = run_ranks(DP_WORLD, _dp_rank, (cfg, path, bnm), device=f'cuda:{dev.index or 0}',
                      backend='gloo', timeout_s=600)
    r0 = ranks[0]
    two = r0['A']
    smi = _smi()
    # every rank holds the global tb, statistics and parameters
    for r in ranks[1:]:
        if r['A']['tb'] != two['tb'] or any(not torch.equal(r['A']['params'][k], two['params'][k])
                                            for k in two['params']):
            raise AssertionError('data parallel: the ranks hold different tb or parameters')
    tb_err = {k: abs(two['tb'][k] - v) / ((0.0 if k == 'grad_norm' else DP_TB_ATOL)
                                          + (DP_GRAD_NORM_RTOL if k == 'grad_norm'
                                             else DP_TB_RTOL) * abs(v))
              for k, v in one['tb'].items()}
    stats_err = {k: float(((two['stats'][k] - v).abs() / (DP_STATS_ATOL + DP_STATS_RTOL * v.abs()))
                          .max()) for k, v in one['stats'].items()}
    errs, _ = leaf_errors(one['grads'], two['grads'])
    head_err = {k: e / _dp_grad_tol(k) for k, e in errs.items()
                if not k.startswith('rpn.backbone.')}
    backbone_err = {k: e / DP_BACKBONE_TOL for k, e in errs.items()
                    if k.startswith('rpn.backbone.')}
    keys = list(backbone_err)
    norm = sum(float(one['grads'][k].double().square().sum()) for k in keys) ** 0.5
    diff = sum(float((two['grads'][k] - one['grads'][k]).double().square().sum())
               for k in keys) ** 0.5
    for name, err in (('tb', tb_err), ('BN statistics', stats_err),
                      ('gradients after the backbone', head_err),
                      ('backbone gradients', backbone_err)):
        k = max(err, key=err.get)
        print(f'data parallel: {name}: worst {k} at {err[k]:.4f} of its tolerance', flush=True)
    print(f'data parallel: the backbone gradient off by {diff / norm:.3e} of its norm '
          f'({diff / norm / DP_BACKBONE_NORM:.4f} of the tolerance)', flush=True)
    if set(two['tb']) != set(one['tb']) or max(tb_err.values()) > 1:
        raise AssertionError(f'data parallel: tb entries world 2 vs world 1 beyond tolerance: '
                             f'{ {k: (two["tb"][k], one["tb"][k]) for k, e in tb_err.items() if e > 1} }')
    if max(stats_err.values()) > 1:
        raise AssertionError(f'data parallel: BN statistics beyond tolerance: '
                             f'{ {k: e for k, e in stats_err.items() if e > 1} }')
    worst = check_gradients(one['grads'], two['grads'], _dp_grad_tol, DP_BACKBONE_NORM,
                            'data parallel: gradients world 2 vs world 1')
    unsure = check_adam_step(before, one['params'], two['params'], one['grads'], two['lr'],
                             _dp_grad_tol, 'data parallel: parameters after the update')

    single, multi = r0['singles'], r0['multi']
    if multi['step'] != 3 or [set(c) for c in multi['calls']] != [{'loss', 'loss_mean'}]:
        raise AssertionError(f'steps_per_call 2: step {multi["step"]}, calls {multi["calls"]}')
    call = multi['calls'][0]
    mean = sum(single['losses']) / 2
    if not (abs(call['loss'] - single['losses'][1]) <= DP_TB_RTOL * abs(single['losses'][1])
            and abs(call['loss_mean'] - mean) <= DP_TB_RTOL * abs(mean)):
        raise AssertionError(f'steps_per_call 2: tb {call}, single steps {single["losses"]}')
    # the two steps' update: within 1e-3 of its norm, as phase 27 holds a resumed step's,
    # or within twice the gap between two runs of the same single steps
    def update(params):
        return torch.cat([(params[k] - two['params'][k]).flatten() for k in two['params']])

    ref = update(single['params'])
    gap = float((update(multi['params']) - ref).norm() / ref.norm())
    floor = float((update(single['again']) - ref).norm() / ref.norm())
    if not gap <= max(1e-3, 2 * floor):
        raise AssertionError(f'steps_per_call 2: the update differs from two single steps\' by '
                             f'{gap:.3e} of its norm (two runs of the single steps {floor:.3e})')
    for r in ranks:
        for key, want in (('launches_A', DP_STEP_WANT), ('launches', [7 * w for w in DP_STEP_WANT])):
            if r[key] != want:
                raise AssertionError(f'data parallel rank: launches {key} {r[key]}, expected {want}')
    if launches_one != [3 * w for w in DP_STEP_WANT]:
        raise AssertionError(f'data parallel world 1: launches {launches_one}')
    reduces = single['all_reduces'][1]
    print(f'data parallel ({smi}): world {DP_WORLD} (gloo, both ranks on this card, batch '
          f'{TRAIN_BATCH // DP_WORLD} each) vs world 1 (batch {TRAIN_BATCH}), one step: loss '
          f'{two["tb"]["loss"]:.6f} vs {one["tb"]["loss"]:.6f}, grad norm '
          f'{two["tb"]["grad_norm"]:.4f} vs {one["tb"]["grad_norm"]:.4f}; worst gradient leaf '
          f'{worst:.3f} of its tolerance; {100 * unsure:.3f}% of the update\'s elements with a '
          f'sign not sure; steps_per_call 2 over scenes 0 and 1 matches two single steps: '
          f'losses {call["loss"]:.6f} / {call["loss_mean"]:.6f} (last / mean) vs '
          f'{single["losses"]}, the update within {gap:.2e} of its norm (the single steps '
          f'run twice: {floor:.2e})', flush=True)
    print(f'data parallel ({smi}): a step (scene 1) {single["ms"][1]:.2f} ms a rank at world '
          f'{DP_WORLD} vs {one_ms[1]:.2f} ms at world 1 (both ranks share the card: the cost '
          f'of the reductions, not a speed-up); {reduces["all_reduces"]} all-reduces, '
          f'{reduces["bytes"] / 2 ** 20:.2f} MiB a step a rank; phase wall time '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    total = collections.Counter(dict(zip(TRAIN_NAMES, launches_one)))
    for r in ranks:
        total.update(dict(zip(TRAIN_NAMES, r['launches'])))
    return total


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU')
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from epnet_tpu_torch.ops import cuda_build
    from epnet_tpu_torch.utils.testing import (BLOCK_LOCAL_TINY, MIXED_BLOCK_LOCAL_TINY,
                                               MIXED_BLOCK_LOCAL_TRAIN_TINY)

    print(f'torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32 as PyTorch sets '
          f'it: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn '
          f'{torch.backends.cudnn.allow_tf32}', flush=True)
    print(_smi(), flush=True)
    dev = torch.device('cuda:0')
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    libs = ('fps', 'sa_fused', 'sa_fused_bwd', 'conv3x3_dw', 'conv3x3_s2_fwd', 'nms')
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:  # one nvcc each, together
        for f in [pool.submit(cuda_build.load_library, name) for name in libs]:
            f.result()
    print(f'kernels built and loaded in {time.perf_counter() - t0:.1f} s', flush=True)
    for name in libs:
        for line in cuda_build.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}')

    # launches on the main paths (phases 3, 6, 9, 11, 14, 15, 18, 20, 22 and 24-31), by kernel
    launches = collections.Counter()
    fps_res = phase_fps(dev)
    sa_res = phase_sa(dev)
    launches.update(dict(zip(('fps', 'sa_fused_fwd', 'conv3x3_s2_fwd', 'nms_bev'),
                             phase_slice(dev))))
    phase_small_reference(dev)
    bwd_res = phase_sa_bwd(dev)
    launches.update(dict(zip(TRAIN_NAMES + ('nms_bev',), phase_train(dev))))
    phase_small_train_reference(dev)
    dw_res = phase_conv_dw(dev)
    launches.update(dict(zip(TRAIN_NAMES, phase_train_dw(dev))))
    fwd_res = phase_conv_fwd(dev)
    launches.update(phase_cli(dev))
    phase_small_cli(dev)
    win_res = phase_sa_win(dev)
    launches.update(phase_block_local(dev))
    launches.update(phase_cli(dev, 'block-local'))
    phase_small_reference(dev, BLOCK_LOCAL_TINY)
    phase_small_train_reference(dev, BLOCK_LOCAL_TINY)
    bf16_res = phase_bf16_kernels(dev)
    launches.update(phase_bf16_slice(dev))
    phase_small_bf16_reference(dev)
    phase_small_bf16_reference(dev, MIXED_BLOCK_LOCAL_TINY)
    launches.update(phase_cli(dev, 'bf16'))
    bf16_bwd_res = phase_bf16_bwd_kernels(dev)
    launches.update(phase_bf16_train(dev))
    phase_small_bf16_train_reference(dev)
    phase_small_bf16_train_reference(dev, MIXED_BLOCK_LOCAL_TRAIN_TINY)
    launches.update(phase_train_cli(dev))
    launches.update(phase_lidar_flow(dev))
    launches.update(phase_headline(dev))
    launches.update(phase_recipe_rows(dev))
    launches.update(phase_data_parallel(dev))
    family_launches, partitioned = phase_approx_family(dev)
    launches.update(family_launches)
    launches.update(phase_switches(dev))
    launches.update(phase_ablations(dev))
    phase_trace(dev)
    nms_res = phase_nms(dev)

    kernels = [
        {'name': 'fps', 'route': 'cuda', 'source': 'epnet_tpu_torch/csrc/fps.cu',
         'replaces': 'epnet_tpu/ops/fps_pallas.py:40, epnet_tpu/ops/fps_pallas.py:80',
         'design': FPS_DESIGN, **fps_res, 'partitioned': partitioned},
        {'name': 'sa_fused_fwd', 'route': 'cuda', 'source': 'epnet_tpu_torch/csrc/sa_fused.cu',
         'replaces': 'epnet_tpu/ops/sa_fused.py:83', 'design': SA_FWD_DESIGN, **sa_res},
        {'name': 'sa_fused_bwd', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/sa_fused_bwd.cu',
         'replaces': 'epnet_tpu/ops/sa_fused.py:179', 'design': SA_BWD_DESIGN, **bwd_res},
        {'name': 'conv3x3_dw_s2', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/conv3x3_dw.cu',
         'replaces': 'epnet_tpu/ops/conv2d.py:294, tools/conv_dw_pallas_attic.py:323, '
                     'tools/conv_dw_pallas_attic.py:166',
         'design': DW_DESIGN + '; stride 2: pixel (2h + d, 2w + e), SAME pads (0, 1)',
         **dw_res['conv3x3_dw_s2']},
        {'name': 'conv3x3_dw_s1', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/conv3x3_dw.cu',
         'replaces': 'tools/conv_dw_pallas_attic.py:258, tools/conv_dw_pallas_attic.py:67',
         'design': DW_DESIGN, **dw_res['conv3x3_dw_s1']},
        {'name': 'conv3x3_s2_fwd', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/conv3x3_s2_fwd.cu',
         'replaces': 'tools/conv_fwd_attic.py:43', 'design': FWD_DESIGN, **fwd_res},
        {'name': 'sa_fused_win_fwd', 'route': 'cuda', 'source': 'epnet_tpu_torch/csrc/sa_fused.cu',
         'replaces': 'epnet_tpu/ops/sa_fused.py:334',
         'design': SA_FWD_DESIGN + '; after the windowed dedupe (idx_rel clamped into the '
                   'window, plus the tile\'s start, clamped into the table)', **win_res['G']},
        {'name': 'sa_fused_win_bwd', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/sa_fused_bwd.cu',
         'replaces': 'epnet_tpu/ops/sa_fused.py:424', 'design': SA_BWD_DESIGN,
         **win_res['H']},
        {'name': 'sa_fused_fwd_bf16', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/sa_fused.cu',
         'replaces': 'epnet_tpu/ops/sa_fused.py:83, tools/profile_fused_onehot.py:49, '
                     'tools/profile_fps_variants.py:118', **bf16_res['B']},
        {'name': 'sa_fused_win_fwd_bf16', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/sa_fused.cu',
         'replaces': 'epnet_tpu/ops/sa_fused.py:334', **bf16_res['G']},
        {'name': 'conv3x3_s2_fwd_bf16', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/conv3x3_s2_fwd.cu',
         'replaces': 'tools/conv_fwd_attic.py:43',
         'design': 'wgmma m64nNk16 bf16 (128-byte swizzle, transposed B), cp.async 4-stage, '
                   'split-K in fixed order', **bf16_res['F']},
        {'name': 'sa_fused_bwd_bf16', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/sa_fused_bwd.cu',
         'replaces': 'epnet_tpu/ops/sa_fused.py:179', 'design': SA_BWD_BF16_DESIGN,
         **bf16_bwd_res['C']},
        {'name': 'sa_fused_win_bwd_bf16', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/sa_fused_bwd.cu',
         'replaces': 'epnet_tpu/ops/sa_fused.py:424', 'design': SA_BWD_BF16_DESIGN,
         **bf16_bwd_res['H']},
        {'name': 'conv3x3_dw_s2_bf16', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/conv3x3_dw.cu',
         'replaces': 'epnet_tpu/ops/conv2d.py:294, tools/conv_dw_pallas_attic.py:323, '
                     'tools/conv_dw_pallas_attic.py:166',
         'design': DW_BF16_DESIGN + '; stride 2', **bf16_bwd_res['conv3x3_dw_s2']},
        {'name': 'conv3x3_dw_s1_bf16', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/conv3x3_dw.cu',
         'replaces': 'tools/conv_dw_pallas_attic.py:258, tools/conv_dw_pallas_attic.py:67',
         'design': DW_BF16_DESIGN, **bf16_bwd_res['conv3x3_dw_s1']},
        {'name': 'nms_bev', 'route': 'cuda', 'source': 'epnet_tpu_torch/csrc/nms.cu',
         'replaces': 'none: no TPU kernel (epnet_tpu/ops/nms.py::nms_bev is a lax.while_loop '
                     'that XLA compiles)', 'design': NMS_DESIGN, **nms_res},
    ]
    for k in kernels:
        k['launches'] = launches[k['name']]
    for k in kernels:
        if k['launches'] <= 0:
            raise AssertionError(f'{k["name"]} was never launched on the main path')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
