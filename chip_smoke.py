"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. Requires a CUDA card; prints its name and power limit (nvidia-smi).
2. Builds the port's CUDA kernels from ogc_tpu_torch/csrc with nvcc, and
   prints ptxas's registers, shared memory and spills for every kernel but
   #13's (served by #11's), the fused prologue of #4 and #6 included.
3. Kernel phase.  Holds each kernel against its plain PyTorch version on the
   card at every shape the paths give it, on grid-quantized clouds
   (1/8 grid: every d2 is exact, ties are common); outputs must be
   bit-equal.  Eval path (B=8 x 8192): 3 FPS and 6 KNN shapes.  Train path
   (B=4 items x 4 frames = 16 clouds of 8192): the same FPS and model KNN
   shapes at batch 16, the smooth KnnLoss KNN (4 x 8192 x 8192, k=32), the
   smooth BallQLoss ball query (4 x 8192 x 8192, ns 64, r 2; also on a
   continuous scene cloud, and SAPIEN's 32 x 512, ns 16, r 0.2; single
   call and device time), and the
   scatter-add of every grouping backward (5 model groups + 8 smooth-loss
   groups).  #1 is also timed by device time (device_ms, with the time of
   one greedy step) at the eval and train shapes and at the KITTI-SF flow
   forward's five stages (16 clouds, 8192 -> 4096 down to 512 -> 256),
   held bit-equal on every point the same, duplicated points, N 33, 1000,
   1500 (npoint = N), 20, 8191, 8193 and MAX_N, B 1 and 64, and every
   compiled instance that holds the cloud is timed against fps_plan's at
   every path shape (fps_crossover).  #11 is held bit-equal with int32 and
   int64 idx, its CSR equal to the torch sort's (segments), also on a hub,
   a site where every row has one destination, one with empty
   destinations and one of 20001 destinations (several windows of the CSR
   build), at C 1, 3, 99, 131 and at B 1; it is timed by single call and
   device time, split into the CSR build and the accumulation (both
   accumulation kernels), beside the torch prologue (segments) and
   index_add_.
   SAPIEN path (B=32 items x 2 or 4 frames x 512, 1/64 grid):
   the small-source gather at SA0's two scales (C 6, 256 x 64 rows) and at
   the smooth KNN and ball groups (C 8, 4096 / 8192 rows), and the
   small-source scatter (#8) at the smooth groups with int32 and int64 idx,
   also bit-equal to #11, each timed by single call and device time beside
   #11 and index_add_; #8 also at its edge cases (a hub of in-degree 1200,
   empty destinations, one destination, E 16421, n 1 and 1024, B 1, C
   1..16) at the plan's window and at 32, 64 and 256 rows, and every window
   timed at the smooth groups (the crossover onehot_scatter_plan follows).
   #2 is also timed by device time (device_ms), its edge cases (every k
   from 1 to 64 over a ragged M, M < 32 with k = M, N 1001 x M 1025 at B
   16 on a 1/64 grid, tied rows, one site) hold its kernels (thread and
   warp per query) bit-equal, and the two are timed against each other at
   k 3, 4, 8 and at the paths' small-k searches (where knn_plan's
   THREAD_MIN_QUERIES sits).
   Prints median CUDA-event times of kernel and plain version, the bound
   of each call, the library call on the same inputs (``index_add_`` in
   deterministic mode for a scatter, ``torch.gather`` for the small-source
   gather) and, for the small-source kernels, the general route
   ``ops.group`` would take without them (advanced indexing; #11 with its
   CSR built in CUDA).  Fast path: the block-min KNN (#3) at its five model
   sites at batch 16 and 8 and the smooth KNN (4 x 8192 x 8192, k 32), the
   block-min ball query at the smooth shape (crowded and under-full) and
   SAPIEN's, a ragged M = 1500 and a k = 3 case, on grid and continuous
   clouds, each by single call and device time beside the exact route (#2,
   #5); then #3 and #5 on the low-bit case (a run's full-d2 minimum against
   the truncated one), every k from 1 to 64, blk 4 to 32, ragged M and N,
   balls full within 32 candidates and empty ones, each kernel the plan
   can take; and the crossover of #3's thread and warp kernels at every
   path site, the flow forward's included.
4. Train phase (the main path, pinned exact as every parity phase): writes
   a synthetic KITTI-SF root (the write_kittisf layout plus
   flow_preds/flowstep3d/<id>/flow{1,2}.npy), train/val mappings of 40 and
   20 ids, and copies of config/seg/kittisf/kittisf_unsup{,_fast}.yaml with
   epochs 1; runs ogc_tpu_torch.train_seg.main: 10 steps at B=4 x 4 frames
   x 8192, then
   the val epoch (5 batches of 4 items x 2 frames).  Asserts finite loss
   terms and the launch counts derived below.  Then, past every start
   step (so every loss term and every scatter-add carries a gradient): two
   2-step runs from one seed on one batch must give bit-equal parameters
   (no atomics), and one step on the card must agree with the same step on
   the CPU (plain versions): loss terms rtol 1e-4, gradients rtol 3e-3 per
   leaf.
5. Profile: torch.profiler over 3 warm train steps, all terms on; prints
   the device's busy share of the steps, the device time of #1's, #2's,
   #3's, #5's, #8's, #10's, #11's and #12's kernels, and the operators and
   kernels that take the most device time.
6. Eval phase: ogc_tpu_torch.test_seg.main on the 100 ids of
   data_prepare/kittisf/splits/val.txt with the checkpoint the train phase
   wrote (25 batches of 8); asserts 3 FPS and 6 KNN launches per batch,
   finite metrics, card masks within 2e-4 of the CPU run, and a profile
   of 3 eval forwards of B=8 as in phase 5.
7. KITTI-SF OA-ICP: ogc_tpu_torch.oa_icp.main on the val ids with that
   checkpoint (10 batches of 20, 8192 points: the blockwise streaming
   path); asserts the derived launches and finite flow reports.
8. Fast mode (a main path of its own): phase 4 on kittisf_unsup_fast.yaml
   (bf16, symmetric smooth gradient) in train_seg's default approximate
   mode, with the fast launches derived below; the card-vs-CPU step with
   compute_dtype forced to f32 (kernels against plain versions through a
   whole approximate step, the tolerances of phase 4); one bf16 step on the
   card against the f32 step (BF16_LOSS_RTOL, BF16_GRAD_RTOL, and moved by
   BF16_MIN_MOVE); a profile as in phase 5;
   phase 6 with --approx_knn (bf16 masks card vs CPU by BF16_MASK_TOL and
   BF16_ARGMAX).
9. SAPIEN round alternation (a main path of its own, at full width: 512
   points, 8 slots, embed 128, 2 layers, B=32) on the protocol's synthetic
   scenes (ogc_tpu_torch/tools/synth.py, 120 train/val + 24 test), each
   stage through its CLI's main with the counts set to 0 before it and
   read after it: train_seg woinv R1 (1 epoch), oa_icp train and val R1
   --save, train_seg full R2 (1 epoch, augmented views and invariance
   from the first epoch), test_seg R2, vote R2 --use_gt_flow.  Asserts
   the derived launches of every stage and finite losses and metrics;
   then, on the full config past every start step, two bit-equal seeded 2-step runs,
   one step card vs CPU (the tolerances of phase 4), OA-ICP flows and
   voted masks card vs CPU (REFINE_TOL, VOTE_TOL; the voting also against
   float64 on the CPU, VOTE_F64_TOL, VOTE_MASK_TOL), and a profile as in
   phase 5.
10. KITTI-SF flow forward (a main path of its own: FlowStep3D inference at
   the JAX package's bench shape, kitti arch, B=8 x 8192, 5 iterations,
   random seeded weights, synthetic scenes), exact and then approximate
   (block-min search, nested FPS, frozen self-KNN), each with the gates
   OGC_PALLAS_POOL and OGC_PALLAS_EXACT_PRUNE at the JAX defaults, then
   (exact only) the pool gate alone, then both at on / knn: launches
   against the derived counts, flows bit-equal between the gate settings, the A/B of the median forward, peak memory,
   profiles as in phase 5, and one scene pair (2 iterations) on the card
   against the CPU within FLOW_TOL.
11. test_flow on SAPIEN (B=48, 4 iterations, --save, pool gate on) over
   the synthetic test scenes; the saved flows, read back through
   SapienDataset(predflow_path="flowstep3d"), equal the same forward.
12. The mxu smooth edge engine (a main path of its own): phase 4 on a copy
   of kittisf_unsup_fast.yaml with symmetric_grad false and edge_engine
   mxu (bf16, approximate), with the derived launches (MXU_STEP: #9 and
   #10 once per frame); the determinism, card-vs-CPU (f32) and bf16 checks
   of phase 8; a profile as in phase 5.
13. #6's entry point: ogc_tpu_torch.tools.bench_knn_pruned.main (#3
   against #6 at its four settings, scene-like clouds) with the counts set
   to 0 before it.
14. Flow training and the chained pipeline (main paths of their own) on a
   synthetic SAPIEN root of 60 + 24 scenes, each stage through its CLI's
   main in the CLI's default neighbour mode, its launches against the
   derived ones: train_flow on config/flow/sapien/sapien_unsup.yaml (B=32
   x 512, 4 iterations; 9 steps and a val epoch of 3 batches; SAP_FT_STEP
   and SAP_FT_VAL) with its median step time, clouds/s, peak memory and a
   profile of 3 steps; two seeded 3-step runs bit-equal; one step (B=2 x
   512, 2 iterations) on the card against the CPU.  Then test_flow --save
   (train, val, test) on its ``best``, train_seg woinv R1 on the saved
   flows, oa_icp train and val R1 --save, vote R1 on the predicted test
   flows: every stage's wall time and finite metrics.
15. OGC-DR flow training: train_flow on config/flow/ogcdr/ogcdr_unsup.yaml
   (B=16 x 2048, 4 iterations, 3 steps and a val batch, approximate: #3 in
   training) over synthetic rooms, launches against DR_FT_STEP and
   DR_FT_VAL.
16. Supervised training: train_seg_sup on config/seg/sapien/sapien_sup.yaml
   (B=128 x 512, 2 epochs of 2 steps) over phase 9's SAPIEN root, launches
   against SUP_STEP and SUP_VAL, step times and a profile of 3 steps.
17. The outdoor path (run_outdoor), each CLI through its main with the
   counts set to 0 before it and read after it, raising if it launched no
   #1 or #2 (and, for a trainer, no #11): test_flow_kittisf --save per
   scene and --scene_batch 2 (flows within OUT_BATCH_TOL of each other) on
   4 full-resolution synthetic KITTI-SF scenes of 40k-120k points,
   test_flow_kittisf_benchmark (the kitti142 protocol on 2 of them and a
   downsampled root), test_flow_waymo per scene (GPF, ICP, --bound,
   --save) and batched (--use_odometry --denoise) on 5 Waymo frames of
   30k-60k points, the kitti flownet at npoint 8192 with random seeded
   weights; ICP and GPF card against CPU (ICP_ROT_TOL, ICP_T_TOL); profiles
   of 3 scenes of each flow CLI; train_seg_waymo on waymo_unsup.yaml and
   waymo_unsup_fast.yaml (3 steps of B=4 x 8192) and train_seg_waymo_sup
   (2 steps of B=16 x 8192) with step times, peak memory and a profile of
   3 Waymo steps; test_seg_waymo and test_seg on KITTI-Det and
   SemanticKITTI (8192 points, 10 slots) with the first one's weights.
18. Data parallelism (run_dp; ogc_tpu_torch/parallel/mesh.py): NCCL at
   world size 1 (the launcher's variables set here, one rank on cuda:0):
   3 SAPIEN full SegTrainer steps (B=32 x 512, pinned exact) and 3 SAPIEN
   FlowTrainer steps (B=32 x 512, 4 iterations) bit-equal to the same
   steps without a process group.  Two gloo ranks sharing cuda:0
   (``share_device``; ``python3 chip_smoke.py dp_worker ...`` processes),
   each loading its 16-item block through the port's DataLoader, 3 steps
   of each trainer: SegTrainer and FlowTrainer under local sync against one
   process taking the ranks' steps at their shapes (split_steps): every
   step's terms within DP_LOSS_RTOL, the first averaged gradient within
   DP_GRAD_RTOL, local-sync running statistics within DP_STATS_RTOL;
   FlowTrainer under global sync against one process on the global batch,
   within those bounds or DP_WITNESS_X times what nudging the batch's
   clouds by one ulp moves that process; a checkpoint written by rank 0 alone and a
   resumed step equal to the continuing one; #1, #2 and #11 launched on
   each rank.  dp_eval_fwd over [cuda:0, cuda:0]: the KITTI-SF segnet on
   B=7 (padded to 8) within MASK_TOL of --dp 1, the kitti flownet (B=8 x
   8192) within DP_FLOW_TOL of its scale.  test_seg --dp (card count + 1)
   raises.  With two cards or more, two NCCL ranks on two cards held as
   the gloo ranks are, dp_eval_fwd over every card (``--dp 0``), and #1
   and #2 on cuda:1 after init_data_parallel("cuda:1") (a CLI's
   ``--device cuda:1``) bit-equal to their plain versions.
   Each arm's step ms and peak MiB beside the card's name and power limit.
   ``python3 chip_smoke.py dp_phase`` runs this phase alone on its own
   inputs; ``dp_phase cards`` only the references and the arms that need
   two cards.
The kernel phase also holds the row-group pool (#12) at every pool shape of
phases 10 and 11 (max and mean, float32 and bf16, broadcast and per-group add,
ReLU on and off; timed by single call, device time and host enqueue beside
torch.amax), on NaN and -0.0 rows with the scale and add absent, given, or a
-0.0 add, and at its runtime-S and scalar instances, and the bound-pruned exact
KNN (#4) at every shape its gate admits on the flow path and the seg parity
path, a ragged M and N, k = 1, k = 64 over 32-point blocks, every point at one
place and clouds over one CTA's sort (20000 points), bit-equal to their plain
versions and #4 to #2, its fused prologue (sort, selection) bit-equal to the
torch prologue, timed apart from its search; the block-sparse gather and
scatter (#9/#10) on the mxu path's tables (sorted synthetic KITTI-SF scenes, 4
x 8192 x 96, C 11), SAPIEN's, a ragged N with an odd S and a uniform table
(every 256-row tile reaches 64 blocks), #9 bit-equal to advanced indexing with
the presence it writes equal to bs_prologue's, #10 fed that presence bit-equal
to its plain version and #11 (timed by single call and device time beside #11
and index_add_), with the blocks per tile, #10 also on its edge cases (a hub,
empty destinations, one destination, n 1, two pieces a unit, C 1..16) with #9's
presence and with bs_prologue's, and #9 at every C from 1 to 16 from an aligned
and an unaligned source; #7 also at every C from 1 to 16, N 1 and 1024 and a
ragged E; #7 and #9 timed by single call and by device time beside
torch.gather; and the candidate-pruned KNN (#6) at bench_knn_pruned's shapes on
grid clouds and at its edge cases (a pad block among the candidates, k 1 and
64, 32-point blocks, ragged N and M, 20000-point clouds, real points beyond the
pad point), bit-equal to its plain version, its fused prologue to the torch
prologue, timed apart from its search beside #3 and #2 with its recall.  And
the kernels of the flow-train paths at their sites (check_flow_train): #1,
#2 (FT_KNN), #5 (32 x 512, ns 8, r 0.1), #7 / #8 and #11 (FT_GROUPS: #8 at
the C = 3 smooth and upsample groups) of one SAPIEN step, #1 and #3
(FT_BLOCKMIN and the smooth ball) of one OGC-DR step, bit-equal to their
plain versions (#8 also to #11) and timed per step.  And #1's cluster
instance (clouds above one CTA, check_fps_large) bit-equal to its plain
version at 16384, 65536 and 120000 points (B 1 and 4; grid, continuous and
padded clouds, no padding row picked), timed at an outdoor scene's calls
(npoint 1024, 2048, 8192) and at every cluster size.

The derived launches of a #4 call are four (the fused prologue's sort, the #3
pre-pass, the fused selection, the search), of a #6 call three; two more
(the sort's merge and finish) where a cloud is over one CTA's sort.

``pruned_crossover()`` (not run by main) times the searches of #4 and #6
at other launch sizes (queries a warp, warps a CTA), each built alone with
``-D``, against the library's at the flow forward's and the bench's
shapes: the measurement behind the sizes the two kernels are built with.

``parent_ab(root)`` (not run by main) times #1, #11, #3, #5, #8 and #10 of
a checkout of the port the same way (#8 and #10 on inputs of their own
seed, through scatter_ab), and #4 and #6 split into prologue and kernel
(pruned_ab): run on the parent's checkout and on this tree's, in one call,
it gives an A/B on one card.

Every phase raises on failure (exit code != 0).  The line before the last is
a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

import os

# cuBLAS reads this when its first handle is made; deterministic mode
# raises on a matmul without it.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os.path as osp  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = osp.dirname(osp.abspath(__file__))
BATCH, N_POINT = 8, 8192
TRAIN_B, TRAIN_T = 4, 4
# Device of the train and eval phases (the kernel phase is CUDA only).
DEVICE = "cuda"
SEED = 0
MASK_TOL = 2e-4
# bf16 (fast config): one bf16 step against the float32 step from the same
# weights and batch.  Its loss sum within BF16_LOSS_RTOL and its gradients
# within BF16_GRAD_RTOL (relative Frobenius norm over all leaves; 4x the JAX
# package's own bf16-vs-float32 gap, 2.65e-2, on tests/test_torch_fast.py's
# input).  And it must have moved: its largest relative term change and its
# gradient gap each at least BF16_MIN_MOVE.  A step that stayed in float32
# reads 0 on both (the float32 step is bit-reproducible), and the float32
# step on the card and on the CPU differ by ~3e-6 per term.  The sum moves
# far less than the terms: 10 x dynamic carries 99.7% of it and moves 1e-5,
# and the small smooth and invariance moves (0.1 x each) partly cancel.
# Eval masks card against CPU by their mean absolute difference and argmax
# agreement.
BF16_LOSS_RTOL, BF16_GRAD_RTOL, BF16_MIN_MOVE = 1e-2, 0.1, 1e-3
BF16_MASK_TOL, BF16_ARGMAX = 2e-3, 0.99
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL_FRAC = 1e-4, 3e-3, 2e-5
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 (non-tensor)
# operations/s.
HBM_BPS, F32_OPS = 3.35e12, 67e12
# f32 operations of one (query, candidate) pair's direct-form d2 in every
# search bound: 3 subtractions, 3 products and 2 sums (the compare is not a
# floating-point operation).
D2_OPS = 8
# (N, npoint) of the three FPS calls and (n_query, n_points, k) of the six
# KNN calls in one KITTI-SF forward (SA stages 8192 -> 2048 -> 1024 -> 512).
FPS_SHAPES = [(8192, 2048), (2048, 1024), (1024, 512)]
# (N, npoint) of the five FPS calls of the KITTI-SF flow forward (kitti
# arch: enc_loc SA1, SA2, enc_glob's three stages; 2 x FLOW_B clouds each).
FLOW_FPS_SHAPES = [(8192, 4096), (4096, 2048), (2048, 1024), (1024, 512),
                   (512, 256)]
KNN_SHAPES = [(2048, 8192, 64), (1024, 2048, 64), (512, 1024, 64),
              (8192, 2048, 3), (2048, 1024, 3), (1024, 512, 3)]
# Smooth-loss shapes (kittisf_unsup.yaml): KNN k=32 r=1, ball ns=64 r=2.
SMOOTH_K, SMOOTH_R, BALL_NS, BALL_R = 32, 1.0, 64, 2.0
# Derived launches of one train step (16 clouds forward + backward, loss on
# 4 frames of B=4):
#   fps 3       one per SA stage, all 16 clouds in one launch;
#   knn_exact 10  3 SA + 3 FP in the forward, 1 smooth KnnLoss per frame;
#   ball_query 4  1 smooth BallQLoss per frame;
#   scatter_add 13  the backward of every group whose source needs a
#     gradient: SA1 and SA2 (SA0 groups the input cloud, no gradient), the
#     3 FP interpolations, and the KNN and ball smooth groups of 4 frames.
#   gather_onehot, scatter_onehot 0: no KITTI-SF group has a source of at
#     most 1024 points with at most 16 channels (ops/onehot.py's gate).
# And of one val batch (8 clouds forward, loss on 2 frames, no backward).
KERNELS = ("fps", "knn_exact", "ball_query", "scatter_add", "gather_onehot",
           "scatter_onehot", "knn_blockmin", "ball_blockmin", "pool",
           "knn_exact_pruned", "gather_blocksparse", "scatter_blocksparse",
           "knn_cand_pruned", "pruned_sort", "pruned_select")


def launch_counts(**kw):
    return {k: kw.get(k, 0) for k in KERNELS}


STEP_LAUNCHES = launch_counts(fps=3, knn_exact=10, ball_query=4,
                              scatter_add=13)
VAL_LAUNCHES = launch_counts(fps=3, knn_exact=8, ball_query=2)
EVAL_LAUNCHES = launch_counts(fps=3, knn_exact=6)
N_TRAIN_IDS, N_VAL_IDS = 40, 20
# Fast mode (config/seg/kittisf/kittisf_unsup_fast.yaml: bf16, approximate
# neighbours, symmetric smooth gradient), the same B=4 x 4 frames x 8192.
# Block-min sites (#3) of one forward, (n_query, n_points, k, recall):
# SA0 (8192 -> 2048), SA1 and SA2 on nested FPS (prefixes of SA0's sample),
# and the two FP three_nn whose known cloud has >= 1024 points; FP's
# 1024 x 512 is below the gate and takes #2.  The smooth KNN (k 32, r 1)
# and ball (ns 64, r 2) run per frame at B=4 on 8192 x 8192.
BLOCKMIN_SHAPES = [(2048, 8192, 64, 0.95), (1024, 2048, 64, 0.95),
                   (512, 1024, 64, 0.95), (8192, 2048, 3, 0.99),
                   (2048, 1024, 3, 0.99)]
# Derived launches of one fast train step:
#   fps 1         SA0 only (SA1 and SA2 sample nested prefixes);
#   knn_exact 1   FP's 1024 x 512 three_nn, below the #3 gate;
#   knn_blockmin 9  SA0-SA2, 2 FP three_nn, 1 smooth KnnLoss per frame;
#   ball_blockmin 4  1 smooth BallQLoss per frame;
#   scatter_add 5  SA1, SA2 and the 3 FP groups; the smooth groups' symmetric
#     gradient gathers and scatters nothing.
# A fast val batch (8 clouds, loss on 2 frames) and a fast eval forward.
FAST_STEP = launch_counts(fps=1, knn_exact=1, knn_blockmin=9,
                          ball_blockmin=4, scatter_add=5)
FAST_VAL = launch_counts(fps=1, knn_exact=1, knn_blockmin=7, ball_blockmin=2)
FAST_EVAL = launch_counts(fps=1, knn_exact=1, knn_blockmin=5)
# The mxu smooth edge engine (a main path of its own): a copy of
# kittisf_unsup_fast.yaml with symmetric_grad false and edge_engine mxu, in
# train_seg's default approximate mode, B=4 x 4 frames x 8192.  Each smooth
# call (one per frame) sorts its 4 clouds by Morton code, builds the KNN
# (k 32, r 1) and ball (ns 64, r 2) tables of the sorted clouds (#3 against
# the stride-shuffled copy) and groups both in one block-sparse call: #9
# forward, #10 backward, 4 x 8192 x 96 edges x 11 channels (10 slots and
# the original index).  Derived launches of one step:
#   fps 1, knn_exact 1, knn_blockmin 9, ball_blockmin 4  as in fast mode;
#   scatter_add 9  SA1, SA2, the 3 FP groups, and per frame the backward of
#     the mask's gather into Morton order;
#   gather_blocksparse 4, scatter_blocksparse 4  one of each per frame.
# A val batch (2 frames, no backward): fast mode's and 2 #9.
MXU_STEP = launch_counts(fps=1, knn_exact=1, knn_blockmin=9, ball_blockmin=4,
                         scatter_add=9, gather_blocksparse=4,
                         scatter_blocksparse=4)
MXU_VAL = launch_counts(fps=1, knn_exact=1, knn_blockmin=7, ball_blockmin=2,
                        gather_blocksparse=2)
MXU_C = 11
# The channel counts #7 and #9 are compiled for (a template instance each).
KERNEL_MAX_C = 16
# #6's entry point (ogc_tpu_torch.tools.bench_knn_pruned, 10 timed calls
# after one warm-up): per shape #3 once and #6 once per (n_cand, blk).
BENCH_REPS = 10
# KITTI-SF OA-ICP (the blockwise path at 8192): per batch two forwards and
# the k=1 KNN of the mask interpolation.
KITTI_ICP_BATCH = 20
KITTI_ICP_LAUNCHES = launch_counts(fps=6, knn_exact=13)
# SAPIEN (config/seg/sapien/sapien_unsup*.yaml, the protocol's data: 120
# train/val scenes, 24 test scenes): B=32 items of 512 points, 8 slots;
# SA0 (256 centres x 64, radii 0.1/0.2) groups [xyz, pc], C 6; smooth KNN
# k 8 r 0.1, ball ns 16 r 0.2 over the 8-slot masks.
SAP_B, SAP_N, SAP_K = 32, 512, 8
SA0_NPOINT, SA0_NS, SA0_RADII = 256, 64, (0.1, 0.2)
SAP_KNN_K, SAP_KNN_R, SAP_BALL_NS, SAP_BALL_R = 8, 0.1, 16, 0.2
SAP_SCENES, SAP_TEST_SCENES = 120, 24
# Derived launches of one SAPIEN train step (all 2 or 4 frames of the B
# items in one forward, the loss per frame):
#   fps 2         SA0 and SA1;
#   knn_exact     SA0 (one table for both scales), SA1, 2 FP, and 1 smooth
#                 KnnLoss per frame: 6 (2 frames) or 8 (4 frames);
#   ball_query    1 smooth BallQLoss per frame;
#   scatter_add 3 the #11 backwards: SA1 (C 195) and the 2 FP groups;
#   gather_onehot the #7 groups: SA0's 2 scales, and the KNN and ball
#                 smooth groups per frame: 6 or 10;
#   scatter_onehot #8, the backward of the smooth groups (SA0's source, the
#                 input cloud, needs no gradient): 4 or 8.
# A val batch (2 frames, no backward), a test_seg or vote forward, and an
# OA-ICP batch (two forwards plus the k=1 KNN of the mask interpolation,
# whose 512 rows per cloud are below the #7 gate).
SAP_WOINV_STEP = launch_counts(fps=2, knn_exact=6, ball_query=2,
                               scatter_add=3, gather_onehot=6,
                               scatter_onehot=4)
SAP_FULL_STEP = launch_counts(fps=2, knn_exact=8, ball_query=4,
                              scatter_add=3, gather_onehot=10,
                              scatter_onehot=8)
SAP_VAL = launch_counts(fps=2, knn_exact=6, ball_query=2, gather_onehot=6)
SAP_FWD = launch_counts(fps=2, knn_exact=4, gather_onehot=2)
SAP_ICP = launch_counts(fps=4, knn_exact=9, gather_onehot=4)
SAP_ICP_BATCH, SAP_VOTE_BATCH = 48, 12
# Card against CPU for OA-ICP flows and voted masks, and each device's
# float32 voting against a float64 one on the CPU from the same masks:
# absolute, unit-scale scenes (see check_refine_card_vs_cpu).
REFINE_TOL, VOTE_TOL, VOTE_F64_TOL, VOTE_ARGMAX = 1e-4, 5e-3, 2.5e-3, 0.999
# float64 voting from the card's masks against that from the CPU's masks.
# Read on an H100: float32 against float64 6.5e-4 (card) and 1.47e-3 (CPU),
# float64 against float64 8.9e-7; VOTE_F64_TOL and VOTE_MASK_TOL leave
# about 1.7x and 11x room, and VOTE_TOL = 2 * VOTE_F64_TOL.
VOTE_MASK_TOL = 1e-5
# FlowStep3D inference.  KITTI-SF flow forward at the JAX package's bench
# shape (bench.py:115-142; config/flow/kittisf/kittisf_unsup.yaml): kitti
# arch, 8192 points, loc_flow_nn 16, loc_flow_rad 1.5, k_decay 0.5 (the test
# value), B=8, 5 iterations, eval, random seeded weights.  Both clouds are
# encoded in one 2B batch; the refinement re-encodes the warped cloud at B.
FLOW_B, FLOW_ITERS, FLOW_REPS = 8, 5, 5
FLOW_KW = dict(npoint=N_POINT, arch="kitti", loc_flow_nn=16, loc_flow_rad=1.5,
               k_decay_fact=0.5)
# Card against CPU: B=1, 2 iterations (the recurrence is chaotic past ~2,
# PARITY.md:238-241), within FLOW_TOL of the flow's scale (max |flow|, at
# least 1): the port's CPU suite holds the same bound against the JAX
# package.
FLOW_CPU_ITERS, FLOW_TOL = 2, 2e-5
# Derived launches of one KITTI-SF flow forward (exact mode, gates off):
#   fps 5         enc_loc SA1 and SA2, the three enc_glob stages (2B clouds
#                 in one launch each); the corr stages and every module on
#                 the 1/4 cloud keep their points, the refinement reuses
#                 frame 1's FPS indices;
#   knn_exact 24  12 before the refinement (enc_loc 2, enc_glob 3, corr SA 2,
#                 the 3 corr FP three_nn, the shared 1/4-cloud table, the
#                 upsample stencil) and 3 per refinement iteration (enc_loc
#                 SA1 and SA2 of the warped cloud, the FlowEmbedding KNN);
#   gather_onehot 1  the first corr FP's three_interpolate of the 3-channel
#                 flow from 256 points (ops/onehot.py's gate).
# With OGC_PALLAS_EXACT_PRUNE=knn, the enc_loc searches (4096 x 8192 and
# 2048 x 4096, k 32: M >= 4096, N >= 1024) take #4 instead of #2: 2 + 2 x 4
# = 10 calls, each four launches (the fused prologue's sort, the #3
# pre-pass, the fused selection, the search).  With OGC_PALLAS_POOL=on every
# pool whose S is a power of two launches #12 (flow_pool_sites).
FLOW_EXACT = launch_counts(fps=5, knn_exact=24, gather_onehot=1)
FLOW_PRUNED = 2 + 2 * (FLOW_ITERS - 1)
# Approximate mode (--approx_knn): FPS at enc_loc SA1 only (nested FPS),
# the self-KNN tables of the warped cloud frozen; #3 where the searched
# cloud has >= 1024 points: enc_loc SA1, SA2, enc_glob SA1, SA2, corr SA2,
# the last corr FP, the 1/4-cloud table, the stencil, and the FlowEmbedding
# KNN per iteration; #2 at enc_glob SA3, corr SA1 and the first two corr FP.
FLOW_APPROX = launch_counts(fps=1, knn_exact=4, gather_onehot=1,
                            knn_blockmin=8 + (FLOW_ITERS - 1))
# Its #3 searches (clouds, queries, points, k, recall): enc_loc SA1 and SA2,
# enc_glob SA1 and SA2 (2B clouds), corr SA2, the last corr FP, the 1/4-cloud
# table, the stencil, and the FlowEmbedding KNN (once per refinement
# iteration); blockmin_crossover times each.
FLOW_BLOCKMIN_SITES = [(2 * FLOW_B, 4096, 8192, 32, 0.95),
                       (2 * FLOW_B, 2048, 4096, 32, 0.95),
                       (2 * FLOW_B, 1024, 2048, 32, 0.95),
                       (2 * FLOW_B, 512, 1024, 24, 0.95),
                       (FLOW_B, 1024, 1024, 16, 0.95),
                       (FLOW_B, 2048, 1024, 3, 0.99),
                       (FLOW_B, 2048, 2048, 32, 0.95),
                       (FLOW_B, 8192, 2048, 3, 0.99),
                       (FLOW_B, 2048, 2048, 16, 0.95)]
# test_flow on SAPIEN (config/flow/sapien/sapien_unsup.yaml: 512 points,
# loc_flow_nn 8, loc_flow_rad 0.1) over the 24 synthetic test scenes x 6
# view pairs, B=48, 4 iterations, exact, pool gate on.  Per batch: fps 4
# (enc_loc 2, enc_glob 2); knn_exact 9 + 3 per iteration (enc_loc 2,
# enc_glob 2, corr SA 1, the 2 corr FP three_nn, the 1/4-cloud table and the
# stencil; no search reaches #4's M >= 4096); gather_onehot 1 + 1 per
# iteration (the upsample of the 3-channel flow from the 128-point cloud).
SAP_FLOW_B, SAP_FLOW_ITERS = 48, 4
SAP_FLOW = launch_counts(fps=4, knn_exact=9 + 3 * (SAP_FLOW_ITERS - 1),
                         gather_onehot=SAP_FLOW_ITERS)


# The symbols of #1's, #2's, #3's, #5's, #8's, #10's, #11's and #12's
# kernels, and of #4's and #6's prologue and search kernels, summed per call
# in every profile (#3's ball mode and #5 are instances of one template,
# ball_kernel<blk>; #5's blk is 1).
PROFILED_KERNELS = {"#1 fps": ("fps_kernel",),
                    "#2 knn_exact": ("knn_exact_kernel", "knn_warp_kernel"),
                    "#3 knn_blockmin": ("blockmin_thread_kernel",
                                        "blockmin_warp_kernel"),
                    "#3 ball_blockmin": tuple(f"ball_kernel<{blk}>" for blk
                                              in (4, 8, 16, 32)),
                    "#5 ball_query": ("ball_kernel<1>",),
                    "#8 scatter_onehot": ("scatter_rows_kernel",),
                    "#10 partition": ("bs_partition_kernel",),
                    "#10 sums": ("bs_accumulate_kernel",),
                    "#11 scatter_add": ("csr_count_kernel", "csr_scan_kernel",
                                        "csr_place_kernel",
                                        "accumulate_warp_kernel",
                                        "accumulate_thread_kernel"),
                    "#12 pool": ("rowgroup_pool_kernel",),
                    "#4/#6 fused sort": ("sort_kernel", "merge_kernel",
                                         "finish_kernel"),
                    "#4 fused selection": ("select_kernel<true>",),
                    "#4 search": ("pruned_knn_kernel",),
                    "#6 fused selection": ("select_kernel<false>",),
                    "#6 search": ("cand_knn_kernel",)}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn`` over ``reps`` runs, from CUDA events."""
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
    return float(np.median(times))


def device_ms(fn, reps=20, rounds=5):
    """Device milliseconds per launch: ``reps`` back-to-back calls of
    ``fn`` captured in a CUDA graph, replayed ``rounds`` times between two
    CUDA events.  The replay enqueues no host work, so unlike cuda_ms this
    holds no wrapper or launch time of the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * rounds)
    del graph
    torch.cuda.empty_cache()
    return ms


def host_us(fn, reps=200):
    """Host microseconds per call: ``reps`` calls enqueued back to back with
    no synchronisation between them, host clock (the device's work is
    queued, not waited for)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def ptxas_report(sources):
    """nvcc -Xptxas -v on each source with the build's own flags, all
    started together: every kernel's registers, shared memory and spill
    bytes as ptxas prints them (mangled names)."""
    from ogc_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        procs = [(src, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             osp.join(tmp, f"{i}.o"), src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
            for i, src in enumerate(sources)]
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc -Xptxas -v {src}:\n{out}")
            name, spill = None, ""
            for line in out.splitlines():
                if "Compiling entry function" in line:
                    name = line.split("'")[1]
                elif "spill" in line:
                    spill = line.split(":", 1)[-1].strip()
                elif "Used" in line and name:
                    log(f"ptxas {osp.basename(src)} {name}: "
                        f"{line.split('Used', 1)[1].strip()}; {spill}")
                    name = None


def bound_ms(nbytes, nops):
    """(least ms, what bounds it): bytes over HBM rate vs f32 operations
    over the f32 peak."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, nops / F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def box_pairs(q, p, half, last=None):
    """(query, point) pairs a search pruned by spatial cells must test, on
    this data: per query, the points in the cube of half-width ``half``
    (B, N) around it, and with ``last`` (B, N) only those of index <= last
    (a ball full by then needs no later point)."""
    total = torch.zeros((), dtype=torch.int64, device=q.device)
    idx = torch.arange(p.shape[1], device=q.device)
    for b in range(q.shape[0]):
        for s in range(0, q.shape[1], 512):
            inside = ((p[b][None] - q[b, s:s + 512, None]).abs().amax(-1)
                      <= half[b, s:s + 512, None])
            if last is not None:
                inside &= idx <= last[b, s:s + 512, None]
            total += inside.sum()
    return int(total.item())


class Report:
    """Per kernel: max abs error, and per call kernel ms, plain ms, bound ms
    (with what bounds it) and library ms, weighted by the call's launches
    per train step; for #2, #7, #9 and #12 also the device times of the
    kernel and of the library call where there is one (device_ms)."""

    def __init__(self):
        self.rows = {}

    def add(self, name, err, ms, plain, bound, by, lib=None, per_step=1,
            general=None, device=None):
        r = self.rows.setdefault(name, {"err": 0.0, "ms": 0.0, "plain": 0.0,
                                        "bound": 0.0, "by": {}, "lib": None,
                                        "general": None, "device": None})
        r["err"] = max(r["err"], float(err))
        r["ms"] += per_step * ms
        r["plain"] += per_step * plain
        r["bound"] += per_step * bound
        r["by"][by] = r["by"].get(by, 0.0) + per_step * bound
        if lib is not None:
            r["lib"] = (r["lib"] or 0.0) + per_step * lib
        if general is not None:
            r["general"] = (r["general"] or 0.0) + per_step * general
        if device is not None:
            kd, ld = r["device"] or (0.0, None)
            r["device"] = (kd + per_step * device[0],
                           ld if device[1] is None
                           else (ld or 0.0) + per_step * device[1])

    def entry(self, name):
        r = self.rows[name]
        e = {"max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain"],
             "bound_ms": r["bound"],
             "bound_by": max(r["by"], key=r["by"].get),
             "library_ms": r["lib"]}
        if r["general"] is not None:
            e["general_ms"] = r["general"]
        if r["device"] is not None:
            e["device_ms"], e["library_device_ms"] = r["device"]
        return e


def grid_cloud(gen, b, n, extent=30.0, step=1 / 8):
    """Coordinates on a grid of ``step`` (1/8 or 1/64): direct-form d2 is
    exact, ties are common."""
    x = torch.rand((b, n, 3), generator=gen, device="cuda") * extent
    return torch.round(x / step) * step


def scene_cloud(rng, n):
    """Outdoor-like continuous cloud: a ground plane plus a few clusters."""
    ground = np.c_[40 * rng.rand(n // 2, 2) - 20, 0.2 * rng.rand(n // 2, 1)]
    k = 8
    clusters = [np.r_[40 * rng.rand(2) - 20, 1.0]
                + rng.randn(-(-(n - n // 2) // k), 3) * [1.5, 1.5, 0.8]
                for _ in range(k)]
    return np.vstack([ground] + clusters)[:n].astype(np.float32)


def check_fps(report, gen, b, per_step, shapes=FPS_SHAPES):
    """#1 at ``shapes`` (N, npoint) over ``b`` grid clouds: bit-equal to its
    plain version, timed by single call and by device time (device_ms), with
    the device time of one greedy step."""
    from ogc_tpu_torch.ops.fps import fps, fps_plain

    for n, npoint in shapes:
        x = grid_cloud(gen, b, n)
        got, want = fps(x, npoint), fps_plain(x, npoint)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"FPS ({b},{n})->{npoint}: kernel != plain "
                                 f"at {(got != want).sum().item()} indices")
        ms = cuda_ms(lambda: fps(x, npoint), 20)
        dev = device_ms(lambda: fps(x, npoint))
        pms = cuda_ms(lambda: fps_plain(x, npoint), 3)
        # 10 f32 operations per point per step: 3 sub, 3 mul, 2 add, min,
        # and the compare of the max.  The npoint - 1 steps are sequential.
        bnd, by = bound_ms(b * (n * 12 + npoint * 4),
                           b * (npoint - 1) * n * 10)
        report.add("fps", 0, ms, pms, bnd, by, per_step=per_step,
                   device=(dev, None))
        log(f"fps ({b},{n},3)->{npoint}: bit-equal; kernel {ms:.4f} ms, "
            f"device {dev:.4f} ms ({dev / (npoint - 1) * 1e6:.1f} ns per "
            f"step), plain {pms:.4f} ms, bound {bnd:.4f} ms ({by})")


def fps_candidates(n):
    """Every compiled FPS instance (points a thread) that holds a cloud of
    ``n`` points, each with the fewest threads that do, up to the threads
    fps_plan gives that instance at the top of its range."""
    from ogc_tpu_torch.ops.fps import MAX_N, PLAN, FpsPlan, fps_plan

    plans = set()
    for top in [t for t, _ in PLAN] + [MAX_N]:
        ppt, most, reg, _ = fps_plan(top)
        threads = max(32, -(-n // (32 * ppt)) * 32)
        if threads <= most:
            plans.add(FpsPlan(ppt, threads, reg))
    return sorted(plans)


def fps_crossover(gen):
    """#1's instances against each other (the probe behind fps_plan's
    table): at every path shape over 16 clouds, every compiled instance
    that holds the cloud (fps_candidates), bit-equal to fps_plan's, by
    device time per greedy step."""
    from ogc_tpu_torch.ops.fps import _launch, fps, fps_plan

    for n, npoint in sorted(set(FPS_SHAPES) | set(FLOW_FPS_SHAPES)
                            | {(SAP_N, SAP_N // 2)}, reverse=True):
        x = grid_cloud(gen, 16, n)
        want = fps(x, npoint)
        row = []
        for plan in fps_candidates(n):
            if not torch.equal(_launch(x, npoint, plan), want):
                raise AssertionError(f"FPS (16,{n})->{npoint}: {plan} != "
                                     f"fps_plan's {fps_plan(n)}")
            ns = device_ms(lambda: _launch(x, npoint, plan), 5, 3) / (
                npoint - 1) * 1e6
            row.append((ns, plan))
        row.sort()
        log(f"fps instances (16,{n})->{npoint}, ns per step (ppt, threads, "
            f"reg_xyz; * planned): " + "; ".join(
                f"{'*' if p == fps_plan(n) else ''}{tuple(p)} {ns:.1f}"
                for ns, p in row))


def check_fps_cases(gen):
    """#1 bit-equal to its plain version on the CPU tests' clouds at card
    sizes (every point the same, duplicated points, a 1/8 grid, N 33, 1000,
    1500 with npoint = N, N < 32, N = 8191, 8193 and MAX_N, B = 1 and
    64), each at fps_plan's instance."""
    from ogc_tpu_torch.ops.fps import MAX_N, fps, fps_plain

    same = grid_cloud(gen, 1, 1).expand(4, N_POINT, 3).contiguous()
    dup = grid_cloud(gen, 4, N_POINT // 4).repeat(1, 4, 1)
    dup = dup[:, torch.randperm(N_POINT, generator=gen, device="cuda")]
    cases = [("same", same, 512), ("duplicated", dup, 2048),
             ("grid", grid_cloud(gen, 16, N_POINT), 2048),
             ("N 33", grid_cloud(gen, 8, 33, 2.0), 33),
             ("N 1000", grid_cloud(gen, 8, 1000), 500),
             ("N 1500", grid_cloud(gen, 4, 1500), 1500),
             ("N 20", grid_cloud(gen, 8, 20, 2.0), 20),
             ("N 8191", grid_cloud(gen, 4, 8191), 2048),
             ("N 8193", grid_cloud(gen, 4, 8193), 2048),
             ("N MAX_N", grid_cloud(gen, 2, MAX_N), 2048),
             ("B 1", grid_cloud(gen, 1, N_POINT), 2048),
             ("B 64", grid_cloud(gen, 64, 2048), 1024)]
    for name, x, npoint in cases:
        got, want = fps(x, npoint), fps_plain(x, npoint)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"FPS {name} {tuple(x.shape)}->{npoint}: "
                                 f"kernel != plain at "
                                 f"{(got != want).sum().item()} indices")
    log("fps cases bit-equal: " + ", ".join(
        f"{name} {tuple(x.shape)}->{npoint}" for name, x, npoint in cases))


# #1 above ops/fps.py::MAX_N (a cluster of 4-16 CTAs a cloud): the outdoor
# CLIs' full-resolution scenes.  Bit-equal checks at N (B 1 and 4) on 1/8-grid,
# continuous scene-like and padded clouds (the scene's first 80% and
# duplicates of its row 0, as the batched paths' _pad_rows), npoint 8192;
# the times at (N, npoint) of one outdoor scene's calls: ICP's 1024, GPF's
# 2048 and the network's 8192.
FPS_LARGE_N = (16384, 65536, 120000)
FPS_LARGE_NPOINT = (1024, 2048, 8192)


def large_cloud(gen, rng, b, n, kind):
    """(b, n, 3) float32 on the card: a 1/8 grid over 80 m, a continuous
    scene (scene_cloud), or a scene whose last fifth repeats its row 0."""
    if kind == "grid":
        return grid_cloud(gen, b, n, 80.0)
    x = np.stack([scene_cloud(rng, n) for _ in range(b)])
    if kind == "pad":
        x[:, n - n // 5:] = x[:, :1]
    return torch.from_numpy(x).cuda()


def check_fps_large(report, gen):
    """#1's cluster instances bit-equal to the plain version at FPS_LARGE_N
    (B 1 and 4; grid, continuous and padded clouds), and timed (single
    call, device time, per greedy step) with its plain version and bound
    at every (N, npoint) an outdoor scene gives it.  Also each cluster size
    that holds the cloud (2 to 16 CTAs), bit-equal to fps_plan's and timed
    against it: the measurement behind fps_plan's cluster sizes."""
    from ogc_tpu_torch.ops.fps import (CLUSTER_POINTS, MAX_CLUSTER, MAX_N,
                                       _launch, cluster_plan, fps,
                                       fps_plain, fps_plan)

    rng = np.random.RandomState(SEED)
    for n in FPS_LARGE_N:
        assert n > MAX_N
        for b in (1, 4):
            for kind in ("grid", "scene", "pad"):
                x = large_cloud(gen, rng, b, n, kind)
                got, want = fps(x, 8192), fps_plain(x, 8192)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"FPS {kind} ({b},{n})->8192 {fps_plan(n)}: kernel "
                        f"!= plain at {(got != want).sum().item()} indices")
                if kind == "pad" and (got >= n - n // 5).any():
                    raise AssertionError(f"FPS ({b},{n}): a padding row won")
        log(f"fps cluster {fps_plan(n)} at N {n}: bit-equal on grid, scene "
            f"and padded clouds, B 1 and 4, npoint 8192")
    # More samples than points (a sparse outdoor selection): zeros past N.
    for n in (3000, MAX_N + 2000):
        x = large_cloud(gen, rng, 2, n, "scene")
        if not torch.equal(fps(x, n + 1000), fps_plain(x, n + 1000)):
            raise AssertionError(f"FPS (2,{n})->{n + 1000}: kernel != plain")
    log("fps npoint > N (3000 and MAX_N + 2000 points): bit-equal")
    for n in FPS_LARGE_N:
        x = large_cloud(gen, rng, 1, n, "scene")
        for npoint in FPS_LARGE_NPOINT:
            ms = cuda_ms(lambda: fps(x, npoint), 10)
            dev = device_ms(lambda: fps(x, npoint), 5, 3)
            pms = cuda_ms(lambda: fps_plain(x, npoint), 1)
            bnd, by = bound_ms(n * 12 + npoint * 4, (npoint - 1) * n * 10)
            report.add("fps_large", 0, ms, pms, bnd, by, device=(dev, None))
            log(f"fps cluster (1,{n},3)->{npoint} {tuple(fps_plan(n))}: "
                f"kernel {ms:.4f} ms, device {dev:.4f} ms "
                f"({dev / (npoint - 1) * 1e6:.1f} ns per step), plain "
                f"{pms:.4f} ms, bound {bnd:.4f} ms ({by})")
        want = fps(x, 2048)
        row = []
        for c in range(2, MAX_CLUSTER + 1):
            if -(-n // c) > CLUSTER_POINTS:
                continue
            plan = cluster_plan(n, c)
            if not torch.equal(_launch(x, 2048, plan), want):
                raise AssertionError(f"FPS (1,{n}): {plan} != fps_plan's")
            row.append((device_ms(lambda: _launch(x, 2048, plan), 5, 3)
                        / 2047 * 1e6, plan))
        log(f"fps cluster sizes (1,{n})->2048, ns per step (ppt, threads, "
            f"reg_xyz, cluster; * planned): " + "; ".join(
                f"{'*' if p == fps_plan(n) else ''}{tuple(p)} {ns:.1f}"
                for ns, p in sorted(row)))


def knn_bits_equal(got, want):
    """Indices equal and distances the same bits (grid clouds: no NaN)."""
    (d, i), (pd, pi) = got, want
    return torch.equal(i, pi) and torch.equal(d.view(torch.int32),
                                              pd.view(torch.int32))


def check_knn(report, gen, shapes, per_step):
    """#2 at the path's shapes, bit-equal to its plain version, timed by
    single call (cuda_ms) and by device time (device_ms) beside the plain
    version.  Bound: D2_OPS f32 operations per pair a pruned search must
    test, or the bytes, the larger; the all-pairs operations bound is
    logged beside it."""
    from ogc_tpu_torch.ops.knn import knn_exact, knn_exact_plain, knn_plan

    for b, nq, m, k, reps in shapes:
        q, p = grid_cloud(gen, b, nq), grid_cloud(gen, b, m)
        (d, i), (pd, pi) = knn_exact(q, p, k), knn_exact_plain(q, p, k)
        torch.cuda.synchronize()
        if not knn_bits_equal((d, i), (pd, pi)):
            raise AssertionError(
                f"knn b{b} q{nq} p{m} k{k}: kernel != plain at "
                f"{(i != pi).sum().item()} indices, "
                f"max dist diff {(d - pd).abs().max().item()}")
        ms = cuda_ms(lambda: knn_exact(q, p, k), 20)
        dev = device_ms(lambda: knn_exact(q, p, k), reps=5, rounds=4)
        pms = cuda_ms(lambda: knn_exact_plain(q, p, k), 3)
        # D2_OPS per pair a pruned search must test: the points within the
        # k-th distance's cube.
        pairs = box_pairs(q, p, d[..., -1])
        bnd, by = bound_ms(b * ((nq + m) * 12 + nq * k * 8), pairs * D2_OPS)
        all_pairs, _ = bound_ms(0, b * nq * m * D2_OPS)
        report.add("knn_exact", 0, ms, pms, bnd, by, per_step=reps,
                   device=(dev, None))
        kernel = knn_plan(k, b * nq)[0]
        log(f"knn_exact ({b},{nq} q,{m} p,k={k}, {kernel} kernel) "
            f"x{reps}/{per_step}: idx and dist bit-equal; single call "
            f"{ms:.4f} ms, device {dev:.4f} ms, plain {pms:.4f} ms, bound "
            f"{bnd:.4f} ms ({by}; {pairs} pairs a pruned search tests; all "
            f"pairs {all_pairs:.4f} ms)")


def check_knn_cases(gen):
    """#2's edge cases, each kernel that takes the k (the warp kernel every
    k, the thread kernel k <= THREAD_MAX_K) bit-equal to the plain version:
    every k from 1 to 64 over a ragged M; M < 32 with k = M; M = 32 and 33;
    N not a multiple of the blocks; B = 16; grid clouds of 1/8 and 1/64
    steps, and crowded ones where whole rows of d2 tie (a 1/8 grid in a
    unit cube: 8192 points on 512 sites); every point the same."""
    from ogc_tpu_torch.ops.knn import (THREAD_MAX_K, knn_exact,
                                       knn_exact_plain)

    cases = [(2, 300, 1500, k, 30.0, 1 / 8) for k in range(1, 65)]
    cases += [(3, 77, m, m, 2.0, 1 / 8) for m in (1, 5, 20, 31)]
    cases += [(3, 77, m, k, 2.0, 1 / 8) for m in (32, 33) for k in (1, 32)]
    cases += [(16, 1001, 1025, k, 30.0, 1 / 64) for k in (3, 17, 64)]
    cases += [(2, 513, 8192, k, 1.0, 1 / 8) for k in (8, 32, 64)]
    cases += [(2, 100, 4100, k, 0.0, 1 / 8) for k in (1, 33, 64)]
    for b, nq, m, k, extent, step in cases:
        q = grid_cloud(gen, b, nq, extent, step)
        p = grid_cloud(gen, b, m, extent, step)
        want = knn_exact_plain(q, p, k)
        for variant in ("thread", "warp")[k > THREAD_MAX_K:]:
            if not knn_bits_equal(knn_exact(q, p, k, variant), want):
                raise AssertionError(
                    f"knn {variant} b{b} q{nq} p{m} k{k} extent {extent} "
                    f"step {step}: kernel != plain")
    log(f"knn_exact edge cases: {len(cases)} (k 1..64 over M 1500, M < 32 "
        f"with k = M, M 32/33, N 1001 x M 1025 at B 16 on a 1/64 grid, "
        f"tied rows, one site), each kernel bit-equal to plain")


def knn_crossover(gen):
    """The thread and the warp kernel at the same inputs for k 3, 4 and 8
    and at the paths' searches with k <= THREAD_MAX_K (device time, CUDA
    graphs): where knn_plan's THREAD_MIN_QUERIES sits."""
    from ogc_tpu_torch.ops.knn import (THREAD_MAX_K, THREAD_MIN_QUERIES,
                                       knn_exact, knn_plan)

    for b, nq, m in ((16, 2048, 8192), (16, 8192, 2048)):
        q, p = grid_cloud(gen, b, nq), grid_cloud(gen, b, m)
        row = []
        for k in (3, 4, 8):
            t = device_ms(lambda: knn_exact(q, p, k, "thread"), reps=3,
                          rounds=3)
            w = device_ms(lambda: knn_exact(q, p, k, "warp"), reps=3,
                          rounds=3)
            row.append(f"k {k}: thread {t:.4f} / warp {w:.4f}")
        log(f"knn_exact crossover ({b},{nq} q,{m} p) device ms: "
            f"{'; '.join(row)} (THREAD_MAX_K {THREAD_MAX_K})")
    # The searches with k <= THREAD_MAX_K the paths make: FP three_nn at
    # B 16 and 8, SAPIEN's smooth KNN (k 8 over 512 points, B 32).
    shapes = [(B, nq, m, k) for B in (16, 8) for nq, m, k in KNN_SHAPES
              if k <= THREAD_MAX_K] + [(SAP_B, SAP_N, SAP_N, SAP_KNN_K)]
    row = []
    for b, nq, m, k in shapes:
        q, p = grid_cloud(gen, b, nq), grid_cloud(gen, b, m)
        t = device_ms(lambda: knn_exact(q, p, k, "thread"), reps=5, rounds=4)
        w = device_ms(lambda: knn_exact(q, p, k, "warp"), reps=5, rounds=4)
        row.append(f"({b},{nq},{m},k={k}) thread {t:.4f} / warp {w:.4f}, "
                   f"planned {knn_plan(k, b * nq)[0]}")
    log(f"knn_exact small-k path shapes, device ms: {'; '.join(row)} "
        f"(THREAD_MIN_QUERIES {THREAD_MIN_QUERIES})")


def scene_clouds(rng, b, n):
    """``b`` scene_cloud's of ``n`` points as one (b, n, 3) CUDA tensor:
    continuous coordinates, so d2's low mantissa bits are not zero."""
    return torch.from_numpy(np.stack([scene_cloud(rng, n)
                                      for _ in range(b)])).cuda()


def ball_sites(gen):
    """The ball query's sites: (label, points, centres, r, ns, calls per
    step).  The smooth BallQLoss of a KITTI-SF frame (4 x 8192 x 8192, ns 64,
    r 2) on a crowded grid cloud (extent 8, not timed) and on an under-full
    one (extent 30: most balls hold fewer than 64 points, so most centres
    test every point; timed, 4 a parity or fast step), and SAPIEN's (32 x
    512, ns 16, r 0.2, a unit-scale 1/64 grid; 4 a full step)."""
    crowded = grid_cloud(gen, TRAIN_B, N_POINT, 8.0)
    sparse = grid_cloud(gen, TRAIN_B, N_POINT, 30.0)
    sap = grid_cloud(gen, SAP_B, SAP_N, 1.2, 1 / 64)
    return [("smooth crowded", crowded, crowded, BALL_R, BALL_NS, 0),
            ("smooth", sparse, sparse, BALL_R, BALL_NS, TRAIN_T),
            ("SAPIEN", sap, sap, SAP_BALL_R, SAP_BALL_NS, 4)]


def ball_need(got, n, blk):
    """Candidates a ball needs on this data: up to the run of its ns-th
    winner when it is full (its last slot differs from its first), all
    ``n`` when it is not."""
    full = got[..., -1] != got[..., 0]
    need = torch.where(full, (got[..., -1].long() // blk + 1) * blk, n)
    return full, need.clamp(max=n)


def check_ball(report, gen):
    """#5 at ball_sites, bit-equal to its plain version (also on a
    continuous scene cloud), timed by single call and device time beside
    the plain version.  Bound: the bytes, or D2_OPS per pair a search pruned
    by spatial cells tests (the points in the cube of half-width r around a
    centre, for a full ball only those up to its ns-th hit).  The smooth
    site goes into ``report`` (per parity step); SAPIEN's is logged per full
    step."""
    from ogc_tpu_torch.ops.ball import ball_query_exact, ball_query_plain

    rng = np.random.RandomState(SEED)
    x = scene_clouds(rng, TRAIN_B, N_POINT)
    if not torch.equal(ball_query_exact(x, x, BALL_R, BALL_NS),
                       ball_query_plain(x, x, BALL_R, BALL_NS)):
        raise AssertionError("ball query scene cloud: kernel != plain")
    for label, x, c, r, ns, calls in ball_sites(gen):
        b, n = x.shape[:2]
        got = ball_query_exact(x, c, r, ns)
        want = ball_query_plain(x, c, r, ns)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"ball query {label}: kernel != plain at "
                f"{(got != want).sum().item()} slots")
        full, need = ball_need(got, n, 1)
        head = (f"ball_query {label} ({b},{c.shape[1]} c,{n} p,ns={ns},"
                f"r={r}): bit-equal; full balls "
                f"{full.float().mean().item():.4f}")
        if not calls:
            log(head)
            continue
        pairs = box_pairs(c, x, torch.full(full.shape, r, device="cuda"),
                          need - 1)
        ms = cuda_ms(lambda: ball_query_exact(x, c, r, ns), 20)
        dev = device_ms(lambda: ball_query_exact(x, c, r, ns), reps=5,
                        rounds=4)
        pms = cuda_ms(lambda: ball_query_plain(x, c, r, ns), 3)
        m = c.shape[1]
        bnd, by = bound_ms(b * ((n + m) * 12 + m * ns * 4), pairs * D2_OPS)
        if label == "SAPIEN":
            log(f"per SAPIEN full step: ball_query single {calls * ms:.4f} "
                f"ms, device {calls * dev:.4f} ms, plain {calls * pms:.4f} "
                f"ms, bound {calls * bnd:.4f} ms ({by})")
        else:
            report.add("ball_query", 0, ms, pms, bnd, by, per_step=calls,
                       device=(dev, None))
        log(f"{head}; x{calls}/step: single call {ms:.4f} ms, device "
            f"{dev:.4f} ms, plain {pms:.4f} ms, bound {bnd:.4f} ms ({by}; "
            f"{pairs} pairs a pruned search tests)")


def scatter_sites(gen):
    """#11's calls on the KITTI-SF parity train path: (name, idx (B, R),
    C, n_dest, calls per step).  The smooth-loss groups of the 10-slot mask
    (B=4 per frame), the model's SA and FP groups (16 clouds); then, at no
    call per step, a hub (the smooth ball with 32 more queries listing one
    point 64 times), every row of 4 x 4096 to one destination, empty
    destinations (the smooth ball listing every fourth point only), and
    1 x 40000 rows into 20001 destinations (the CSR build over three
    windows of 8192)."""
    from ogc_tpu_torch.ops import knn
    from ogc_tpu_torch.ops.ball import ball_query_exact

    B = TRAIN_B * TRAIN_T
    x = grid_cloud(gen, TRAIN_B, N_POINT)
    d, i = knn(SMOOTH_K, x, x)
    ball = ball_query_exact(x, x, BALL_R, BALL_NS)
    sites = [("smooth knn", torch.where(d > SMOOTH_R, i[..., :1], i), 10,
              N_POINT, 4),
             ("smooth ball", ball, 10, N_POINT, 4)]
    for name, nq, m, k, radius, C in (("SA1", 1024, 2048, 64, 4.0, 99),
                                      ("SA2", 512, 1024, 64, 8.0, 131),
                                      ("FP2", 1024, 512, 3, None, 256),
                                      ("FP1", 2048, 1024, 3, None, 128),
                                      ("FP0", 8192, 2048, 3, None, 64)):
        p = grid_cloud(gen, B, m)
        q = p[:, :nq] if nq <= m else grid_cloud(gen, B, nq)
        d, i = knn(k, q, p)
        if radius is not None:
            i = torch.where(d > radius, i[..., :1], i)
        sites.append((name, i, C, m, 1))
    hub = ball.clone()
    hub[:, :32] = 7
    sites += [("hub", hub, 10, N_POINT, 0),
              ("one destination", torch.full((TRAIN_B, 4096), 3,
                                             dtype=torch.int32,
                                             device="cuda"), 10, N_POINT, 0),
              ("empty destinations", (ball // 4) * 4, 10, N_POINT, 0),
              ("windows", torch.randint(0, 20001, (1, 40000), generator=gen,
                                        dtype=torch.int32, device="cuda"),
               3, 20001, 0)]
    return [(name, idx.reshape(idx.shape[0], -1), C, n, calls)
            for name, idx, C, n, calls in sites]


def check_scatter(report, gen):
    """#11 at every scatter_sites site: bit-equal to its plain version with
    int32 and int64 idx, its CSR (scatter_csr) equal to the torch prologue's
    (segments); timed by single call and by device time, with the split
    into the CSR build and the accumulation, beside the torch prologue the
    parent commit ran (segments, device time) and index_add_ in
    deterministic mode.  Then odd C (1, 3, 99, 131) and B = 1, bit-equal."""
    from ogc_tpu_torch.ops import knn
    from ogc_tpu_torch.ops.scatter import (accumulate_plan,
                                           scatter_accumulate,
                                           scatter_add_rows,
                                           scatter_add_rows_plain,
                                           scatter_csr, segments)

    for name, flat, C, n_dest, calls in scatter_sites(gen):
        b, R = flat.shape
        g = torch.randn((b, R, C), generator=gen, device="cuda")
        got = scatter_add_rows(flat, g, n_dest)
        want = scatter_add_rows_plain(flat, g, n_dest)
        wide = scatter_add_rows(flat.long(), g, n_dest)
        order, start = scatter_csr(flat, n_dest)
        _, sorder, sstart = segments(flat, n_dest)
        torch.cuda.synchronize()
        if not (bits_equal(got, want) and bits_equal(wide, want)):
            raise AssertionError(
                f"scatter {name}: kernel != plain, max diff "
                f"{(got - want).abs().max().item()}")
        if not (torch.equal(order.long(), sorder)
                and torch.equal(start.long(), sstart)):
            raise AssertionError(f"scatter {name}: CSR != segments'")
        deg = torch.diff(sstart)
        ms = cuda_ms(lambda: scatter_add_rows(flat, g, n_dest), 20)
        dev = device_ms(lambda: scatter_add_rows(flat, g, n_dest))
        csr = device_ms(lambda: scatter_csr(flat, n_dest))
        acc = device_ms(lambda: scatter_accumulate(order, start, g, n_dest))
        other = "thread" if accumulate_plan(C) == "warp" else "warp"
        if not bits_equal(scatter_accumulate(order, start, g, n_dest, other),
                          want):
            raise AssertionError(f"scatter {name}: the {other} kernel != "
                                 f"plain")
        oacc = device_ms(lambda: scatter_accumulate(order, start, g, n_dest,
                                                    other))
        sort = device_ms(lambda: segments(flat, n_dest))
        pms = cuda_ms(lambda: scatter_add_rows_plain(flat, g, n_dest), 3)
        lib, ldev = index_add_ms(flat, g, n_dest)
        bnd, by = bound_ms(b * (R * C * 4 + R * 4 + n_dest * C * 4),
                           b * R * C)
        report.add("scatter_add", 0, ms, pms, bnd, by, lib, per_step=calls,
                   device=(dev, ldev))
        log(f"scatter_add {name} ({b},{R} rows,C={C})->{n_dest} x{calls}/"
            f"step (in-degree max {int(deg.max().item())}, empty "
            f"{int((deg == 0).sum().item())}): bit-equal (int32, int64 idx), "
            f"CSR = segments'; single call {ms:.4f} ms, index_add_ {lib:.4f} "
            f"ms; device {dev:.4f} ms (CSR {csr:.4f}, accumulate "
            f"{accumulate_plan(C)} {acc:.4f}; {other} {oacc:.4f}), "
            f"index_add_ {fmt_ms(ldev)} ms; torch prologue (segments) {sort:.4f} ms; plain {pms:.4f} "
            f"ms, bound {bnd:.4f} ms ({by})")
    x = grid_cloud(gen, 2, 1500)
    _, i = knn(16, x, x)
    for b, C in ((2, 1), (2, 3), (2, 99), (2, 131), (1, 10)):
        flat = i[:b].reshape(b, -1)
        g = torch.randn((b, flat.shape[1], C), generator=gen, device="cuda")
        want = scatter_add_rows_plain(flat, g, 1500)
        for idx in (flat, flat.long()):
            if not bits_equal(scatter_add_rows(idx, g, 1500), want):
                raise AssertionError(f"scatter B={b} C={C} {idx.dtype}: "
                                     f"kernel != plain")
        order, start = scatter_csr(flat, 1500)
        for variant in ("thread", "warp"):
            if not bits_equal(scatter_accumulate(order, start, g, 1500,
                                                 variant), want):
                raise AssertionError(f"scatter B={b} C={C} {variant} "
                                     f"kernel != plain")
    log("scatter_add C 1, 3, 99, 131 at B 2 and C 10 at B 1 (2 x 1500 "
        "points, 16 neighbours), int32 and int64 idx, both accumulation "
        "kernels: bit-equal")


def scatter_ab(label):
    """#8 at SAPIEN's smooth KNN and ball groups (32 clouds of 512 points,
    C 8; 4 calls each per full step) and #10 at the mxu KITTI-SF table (4
    sorted scenes x 8192 x 96, C 11, #9's presence; 4 calls per mxu step),
    each beside #11 on the same inputs, by single call and device time,
    on inputs made from a seed of their own: the same in every tree, so
    ``parent_ab`` on two checkouts times the same work."""
    from ogc_tpu_torch.losses.seg_unsup import OGCLossConfig, mxu_tables
    from ogc_tpu_torch.ops import blocksparse as bs
    from ogc_tpu_torch.ops.onehot import scatter_add_rows_onehot
    from ogc_tpu_torch.ops.scatter import scatter_add_rows

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    _, _, knn, ball = sapien_tables(gen, SAP_B)
    sites = []
    for name, idx in (("smooth knn", knn), ("smooth ball", ball)):
        flat = idx.reshape(SAP_B, -1)
        g = torch.randn((SAP_B, flat.shape[1], SAP_K), generator=gen,
                        device="cuda")
        sites.append(("#8", name, 4, lambda flat=flat, g=g:
                      scatter_add_rows_onehot(flat, g, SAP_N),
                      lambda flat=flat, g=g: scatter_add_rows(flat, g, SAP_N)))
    rng = np.random.RandomState(SEED + 11)
    kitti = torch.from_numpy(np.stack([kitti_scene(rng)[0]
                                       for _ in range(TRAIN_B)])).cuda()
    _, cat = mxu_tables(kitti, OGCLossConfig(
        knn_k=SMOOTH_K, knn_radius=SMOOTH_R, ball_q_k=BALL_NS,
        ball_q_radius=BALL_R, smooth_exact=False))
    b, M, S = cat.shape
    src = torch.randn((b, N_POINT, MXU_C), generator=gen, device="cuda")
    cot = torch.randn((b, M, S, MXU_C), generator=gen, device="cuda")
    _, table = bs.gather_blocksparse(src, cat)
    sites.append(("#10", "mxu smooth table", TRAIN_T,
                  lambda: bs.scatter_add_blocksparse(cat, cot, N_POINT,
                                                     table),
                  lambda: scatter_add_rows(cat.reshape(b, M * S),
                                           cot.reshape(b, M * S, MXU_C),
                                           N_POINT)))
    total = {}
    for kernel, name, calls, fn, general in sites:
        if not bits_equal(fn(), general()):
            raise AssertionError(f"{label} {kernel} {name}: != #11")
        t = (cuda_ms(fn, 20), device_ms(fn), cuda_ms(general, 20),
             device_ms(general))
        acc = total.setdefault(kernel, [0.0] * 4)
        for i, v in enumerate(t):
            acc[i] += calls * v
        log(f"{label} {kernel} {name} x{calls}/step: single {t[0]:.4f} ms, "
            f"device {t[1]:.4f} ms; #11 {t[2]:.4f} / {t[3]:.4f} ms")
    for kernel, what in (("#8", "SAPIEN full step"), ("#10", "mxu step")):
        t = total[kernel]
        log(f"{label} per {what}: {kernel} single {t[0]:.4f} ms, device "
            f"{t[1]:.4f} ms; #11 single {t[2]:.4f} ms, device {t[3]:.4f} ms")


def parent_ab(root):
    """#1, #11, #3 and #5 of a checkout of the port, timed as this
    tree's check_fps, check_scatter, check_blockmin and check_ball time
    them, #8 and #10 as scatter_ab times them, and #4 and #6 as pruned_ab
    times them, for an A/B on one card:

        python3 -c 'import chip_smoke; chip_smoke.parent_ab("<root>")'

    from this tree's root, in a process that has not imported the port, once
    with the parent's checkout and once with this tree's (``.``).
    The port is imported from ``root`` (its kernels build there): FPS at
    FPS_SHAPES (B 8 and 16) and FLOW_FPS_SHAPES (16 clouds); #3 at the
    fast train step's sites (16 clouds, the smooth KNN and ball, SAPIEN's
    ball shape) and #5 at ball_sites; the scatter-add at every
    scatter_sites site; each by single call and device time.  For a parent
    with the port's ogc_scatter_add_rows up to commit 03c3005 (g, int64
    order, int64 start, rows, C, out, stream) the scatter-add is also
    split into its torch prologue (segments) and its kernel fed that
    prologue's CSR."""
    if not torch.cuda.is_available():
        sys.exit("parent_ab: no CUDA device")
    root = osp.abspath(root)
    who = osp.basename(root)
    sys.path.insert(0, root)
    from ogc_tpu_torch.ops import _build
    from ogc_tpu_torch.ops.scatter import scatter_add_rows
    from ogc_tpu_torch.train_seg import set_deterministic

    if not _build.__file__.startswith(root):
        raise RuntimeError(f"parent_ab: the port came from {_build.__file__}")
    set_deterministic(torch.device("cuda"))
    _build.lib()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(f"{who}: kernels from {_build.library_path()}; "
        f"{smi.stdout.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for b, shapes, what in ((BATCH, FPS_SHAPES, "eval forward"),
                            (TRAIN_B * TRAIN_T, FPS_SHAPES, "train step"),
                            (2 * FLOW_B, FLOW_FPS_SHAPES, "flow forward")):
        rep = Report()
        check_fps(rep, gen, b, 1, shapes)
        e = rep.entry("fps")
        log(f"{who}: per {what}: fps kernel {e['ms']:.4f} ms, device "
            f"{e['device_ms']:.4f} ms")
    rep = Report()
    check_blockmin(rep, gen, TRAIN_B * TRAIN_T, BLOCKMIN_SHAPES)
    check_ball(rep, gen)
    for name, what in (("knn_blockmin", "fast"), ("ball_blockmin", "fast"),
                       ("ball_query", "parity")):
        e = rep.entry(name)
        log(f"{who}: per {what} train step: {name} single {e['ms']:.4f} ms, "
            f"device {e['device_ms']:.4f} ms")
    # The torch prologue and its kernel apart: the API up to 03c3005.
    split = len(_build._SIGNATURES["ogc_scatter_add_rows"]) == 7
    total = {"single": 0.0, "device": 0.0, "prologue": 0.0, "kernel": 0.0}
    for name, flat, C, n_dest, calls in scatter_sites(gen):
        b, R = flat.shape
        g = torch.randn((b, R, C), generator=gen, device="cuda")
        t = {"single": cuda_ms(lambda: scatter_add_rows(flat, g, n_dest), 20),
             "device": device_ms(lambda: scatter_add_rows(flat, g, n_dest)),
             "prologue": 0.0, "kernel": 0.0}
        if split:
            from ogc_tpu_torch.ops.scatter import segments

            _, order, start = segments(flat, n_dest)
            out = torch.empty((b, n_dest, C), device="cuda")

            def kernel():
                _build.check(_build.lib().ogc_scatter_add_rows(
                    g.data_ptr(), order.data_ptr(), start.data_ptr(),
                    b * n_dest, C, out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream), f"{who} kernel")

            kernel()
            if not bits_equal(out, scatter_add_rows(flat, g, n_dest)):
                raise AssertionError(f"{who} scatter {name}: kernel on the "
                                     f"prologue's CSR != the wrapper's "
                                     f"result")
            t["prologue"] = device_ms(lambda: segments(flat, n_dest))
            t["kernel"] = device_ms(kernel)
        for k in total:
            total[k] += calls * t[k]
        log(f"{who}: scatter_add {name} ({b},{R} rows,C={C})->{n_dest} "
            f"x{calls}/step: single call {t['single']:.4f} ms; device "
            f"{t['device']:.4f} ms (prologue {t['prologue']:.4f}, kernel "
            f"{t['kernel']:.4f})")
    log(f"{who}: per train step: scatter_add single {total['single']:.4f} "
        f"ms; device {total['device']:.4f} ms (prologue "
        f"{total['prologue']:.4f}, kernel {total['kernel']:.4f})")
    scatter_ab(who)
    pruned_ab(who, gen)


def pruned_ab(who, gen):
    """#4 at the gated flow forward's sites and #6 at bench_knn_pruned's
    settings (grid clouds) of the port imported, by single call and device
    time, split into the prologue and the search kernel: for a port with
    ops/pruned_prologue.py the fused prologue (with #4's #3 pre-pass) and
    the search; for one up to d832318 the torch prologue (prologue and
    survivors) and the kernel on its outputs (the un-sort gathers after it
    are the rest of the call).  Then a profile of one #4 and one #6 call
    (launches and device-side events per call)."""
    from ogc_tpu_torch.ops import _build
    from ogc_tpu_torch.ops import knn_cand as KC
    from ogc_tpu_torch.ops import knn_pruned as KP
    from ogc_tpu_torch.tools.bench_knn_pruned import CASES

    fused = hasattr(KP, "fused_prologue")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def split_4(q, p, k):
        nq, m = q.shape[1], p.shape[1]
        if fused:
            srt, sel = KP.fused_prologue(q, p, k)
            return (lambda: KP.fused_prologue(q, p, k),
                    lambda: KP.search(srt, sel, nq, m, k))
        pro = KP.prologue(q, p, KP.CB, KP.QT)
        order, count = KP.survivors(pro, p, k, KP.QT)
        b, np_ = pro.q_s.shape[:2]
        dist = torch.empty((b, np_, k), device="cuda")
        idx = torch.empty((b, np_, k), dtype=torch.int32, device="cuda")

        def kernel():
            _build.check(_build.lib().ogc_knn_exact_pruned(
                pro.q_s.data_ptr(), pro.p_s.data_ptr(), pro.pid.data_ptr(),
                order.data_ptr(), count.data_ptr(), b, np_,
                pro.p_s.shape[1], order.shape[1], order.shape[2], k, KP.CB,
                KP.QT, dist.data_ptr(), idx.data_ptr(), stream()), who)

        return (lambda: KP.survivors(KP.prologue(q, p, KP.CB, KP.QT), p, k,
                                     KP.QT), kernel)

    def split_6(q, p, k, n_cand, blk):
        N, M = q.shape[1], p.shape[1]
        if fused:
            srt, sel = KC.fused_prologue(q, p, n_cand)
            return (lambda: KC.fused_prologue(q, p, n_cand),
                    lambda: KC.search(srt, sel, N, M, k, blk))
        pro = KC.prologue(q, p, n_cand)
        b, np_ = pro.q_s.shape[:2]
        dist = torch.empty((b, np_, k), device="cuda")
        idx = torch.empty((b, np_, k), dtype=torch.int32, device="cuda")

        def kernel():
            _build.check(_build.lib().ogc_knn_cand(
                pro.q_s.data_ptr(), pro.p_s.data_ptr(), pro.pid.data_ptr(),
                pro.cand.data_ptr(), b, np_, pro.p_s.shape[1], n_cand, k,
                blk, KC.CB, KC.QT, pro.idx_bits, dist.data_ptr(),
                idx.data_ptr(), stream()), who)

        return lambda: KC.prologue(q, p, n_cand), kernel

    def timed(call, prologue, kernel):
        return {"single": cuda_ms(call, 10), "device": device_ms(call),
                "prologue": device_ms(prologue),
                "kernel": device_ms(kernel)}

    def add(total, t, calls):
        for key, v in t.items():
            total[key] = (None if total.get(key, 0.0) is None or v is None
                          else total.get(key, 0.0) + calls * v)

    def fmt(t):
        return ", ".join(f"{n} {fmt_ms(v)}" for n, v in t.items())

    rest = FLOW_ITERS - 1
    total = {}
    for b, nq, m, calls in ((2 * FLOW_B, 4096, 8192, 1),
                            (2 * FLOW_B, 2048, 4096, 1),
                            (FLOW_B, 4096, 8192, rest),
                            (FLOW_B, 2048, 4096, rest)):
        q, p = grid_cloud(gen, b, nq), grid_cloud(gen, b, m)
        t = timed(lambda: KP.knn_exact_pruned(q, p, 32), *split_4(q, p, 32))
        add(total, t, calls)
        log(f"{who}: knn_exact_pruned ({b},{nq} q,{m} p,k=32) x{calls}/"
            f"forward: {fmt(t)} ms")
    log(f"{who}: per flow forward: knn_exact_pruned {fmt(total)} ms")
    q, p = grid_cloud(gen, 2 * FLOW_B, 4096), grid_cloud(gen, 2 * FLOW_B, 8192)
    profile_steps(f"{who} #4 calls ({2 * FLOW_B} x 4096 x 8192, k 32)",
                  lambda _: KP.knn_exact_pruned(q, p, 32))
    total = {}
    for B, N, M, k, cfgs in CASES:
        q, p = grid_cloud(gen, B, N), grid_cloud(gen, B, M)
        for bc, blk in cfgs:
            n_cand = KC.resolve(M, k, bc, blk)[0]
            t = timed(lambda: KC.knn_cand(q, p, k, bc, blk=blk),
                      *split_6(q, p, k, n_cand, blk))
            add(total, t, 1)
            log(f"{who}: knn_cand B{B} N{N} M{M} k{k} (n_cand {bc}, blk "
                f"{blk}): {fmt(t)} ms")
    log(f"{who}: per bench_knn_pruned pass: knn_cand {fmt(total)} ms")
    profile_steps(f"{who} #6 calls (B{B} N{N} M{M} k{k}, n_cand {bc})",
                  lambda _: KC.knn_cand(q, p, k, bc, blk=blk))



# pruned_crossover's launch sizes, (queries a warp, warps a CTA): #4's
# lists must fit static shared memory (at most 32 queries a CTA at k 64),
# #6's CTA holds at most 1024 threads and its queries divide a tile of 128.
KNN4_SIZES = [(q, w) for q in (1, 2, 4) for w in (4, 8, 16, 32)
              if q * w <= 32]
KNN6_SIZES = [(q, w) for q in (1, 2, 4) for w in (8, 16, 32)]


def pruned_crossover():
    """The searches of #4 and #6 at every launch size of KNN4_SIZES and
    KNN6_SIZES, each source built alone with -D (``_build.variants``):
    #4 at the gated flow forward's four sites (16 and 8 clouds of 4096 x
    8192 and 2048 x 4096, k 32), #6 at bench_knn_pruned's settings (grid
    clouds), each size bit-equal to the library's search on the same
    fused prologue, by device time beside it; and the sum per flow forward
    and per bench pass.  Run from the repo's root in its own process:

        python3 -c 'import chip_smoke; chip_smoke.pruned_crossover()'

    The measurement behind the sizes knn_exact_pruned.cu and
    knn_cand_pruned.cu are built with (not run by main)."""
    if not torch.cuda.is_available():
        sys.exit("pruned_crossover: no CUDA device")
    os.chdir(REPO)
    sys.path.insert(0, REPO)
    from ogc_tpu_torch.ops import _build
    from ogc_tpu_torch.ops import knn_cand as KC
    from ogc_tpu_torch.ops import knn_pruned as KP
    from ogc_tpu_torch.tools.bench_knn_pruned import CASES

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(f"pruned_crossover: {smi.stdout.strip()}")
    t0 = time.perf_counter()
    libs = _build.variants(
        [("knn_exact_pruned.cu", {"OGC_KNN4_QUERIES": q, "OGC_KNN4_WARPS": w})
         for q, w in KNN4_SIZES]
        + [("knn_cand_pruned.cu", {"OGC_KNN6_QUERIES": q, "OGC_KNN6_WARPS": w})
           for q, w in KNN6_SIZES])
    lib4, lib6 = libs[:len(KNN4_SIZES)], libs[len(KNN4_SIZES):]
    log(f"pruned_crossover: {len(libs)} builds in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def row(what, ref, sizes, libs, launch, total, calls):
        times = {"library": device_ms(lambda: launch(_build.lib()), 10, 3)}
        for size, lib in zip(sizes, libs):
            got = launch(lib)
            if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                raise AssertionError(f"pruned_crossover {what}: size {size} "
                                     f"!= the library's search")
            times[size] = device_ms(lambda: launch(lib), 10, 3)
        for key, v in times.items():
            total[key] = total.get(key, 0.0) + calls * v
        log(f"pruned_crossover {what}: device ms (queries a warp, warps a "
            f"CTA): " + "; ".join(f"{n} {v:.4f}" for n, v in times.items()))

    rest = FLOW_ITERS - 1
    total = {}
    for b, nq, m, calls in ((2 * FLOW_B, 4096, 8192, 1),
                            (2 * FLOW_B, 2048, 4096, 1),
                            (FLOW_B, 4096, 8192, rest),
                            (FLOW_B, 2048, 4096, rest)):
        q, p = grid_cloud(gen, b, nq), grid_cloud(gen, b, m)
        srt, sel = KP.fused_prologue(q, p, 32)
        row(f"#4 ({b},{nq} q,{m} p,k=32) x{calls}/forward",
            KP.search(srt, sel, nq, m, 32), KNN4_SIZES, lib4,
            lambda lib: KP._launch(srt, sel, nq, m, 32, lib), total, calls)
    log("pruned_crossover #4 per flow forward: device ms "
        + "; ".join(f"{n} {v:.4f}" for n, v in total.items()))
    total = {}
    for B, N, M, k, cfgs in CASES:
        q, p = grid_cloud(gen, B, N), grid_cloud(gen, B, M)
        for bc, blk in cfgs:
            n_cand = KC.resolve(M, k, bc, blk)[0]
            srt, sel = KC.fused_prologue(q, p, n_cand)
            row(f"#6 B{B} N{N} M{M} k{k} (n_cand {bc}, blk {blk})",
                KC.search(srt, sel, N, M, k, blk), KNN6_SIZES, lib6,
                lambda lib: KC._launch(srt, sel, N, M, k, blk, lib), total,
                1)
    log("pruned_crossover #6 per bench pass: device ms "
        + "; ".join(f"{n} {v:.4f}" for n, v in total.items()))

def blockmin_launch(k, b, nq, m, rec):
    """(kernel, CTAs) of the port's #3 KNN for k over ``b`` clouds of
    ``nq`` queries in ``m`` points: blockmin_plan's kernel (128 queries a
    CTA for the thread kernel, 32 for the warp kernel), or the one thread
    per query of a port that has no plan."""
    from ogc_tpu_torch.ops import knn_blockmin as kb

    if not hasattr(kb, "blockmin_plan"):
        return "thread", b * -(-nq // 128)
    kernel, _ = kb.blockmin_plan(k, b * nq, kb.block_size(m, k, rec))
    return kernel, b * -(-nq // (128 if kernel == "thread" else 32))


def check_blockmin(report, gen, b, shapes, ball=True):
    """#3 at every block-min site of the fast path (``shapes`` of the model
    at ``b`` clouds; with ``ball`` the smooth KNN and ball at B=4 per frame,
    a ragged M = 1500 and a small-recall k = 3 case), bit-equal to the plain
    version in both modes, on grid clouds and on continuous scene clouds.
    Timed by single call and device time beside the plain version and the
    route exact mode takes at the same shape ("general": #2 for KNN, #5 for
    the ball).  Bound: D2_OPS f32 operations per (query, candidate) pair
    the function needs (every pair for KNN; for a ball, the candidates up
    to the run of its ns-th hit, all of them when it is not full), or the
    bytes, the larger.  The ball mode is also timed at SAPIEN's ball shape
    (no path sends it there: 512 points are below its gate).  No single
    PyTorch call computes block-min thinning with packed keys: no library
    time.  Uses only the API that every port since #3 has, so parent_ab
    times a parent's #3 with it."""
    from ogc_tpu_torch.ops.ball import ball_query_exact
    from ogc_tpu_torch.ops.knn import knn_exact
    from ogc_tpu_torch.ops.knn_blockmin import (ball_query_blockmin,
                                                ball_query_blockmin_plain,
                                                block_size, knn_blockmin,
                                                knn_blockmin_plain)

    rng = np.random.RandomState(SEED)
    cases = [(b, nq, m, k, rec, 1) for nq, m, k, rec in shapes]
    if ball:
        cases += [(TRAIN_B, N_POINT, N_POINT, SMOOTH_K, 0.95, TRAIN_T),
                  (2, 1500, 1500, 16, 0.95, 0), (2, 1500, 1500, 3, 0.99, 0)]
    for bb, nq, m, k, rec, per_step in cases:
        q, p = grid_cloud(gen, bb, nq), grid_cloud(gen, bb, m)
        for kind, qq, pp in (("grid", q, p), ("scene", scene_clouds(
                rng, bb, nq), scene_clouds(rng, bb, m))):
            got = knn_blockmin(qq, pp, k, rec)
            want = knn_blockmin_plain(qq, pp, k, rec)
            torch.cuda.synchronize()
            if not knn_bits_equal(got, want):
                raise AssertionError(
                    f"knn_blockmin {kind} b{bb} q{nq} p{m} k{k}: kernel != "
                    f"plain at {(got[1] != want[1]).sum().item()} indices")
        ms = cuda_ms(lambda: knn_blockmin(q, p, k, rec), 20)
        dev = device_ms(lambda: knn_blockmin(q, p, k, rec), reps=5, rounds=4)
        pms = cuda_ms(lambda: knn_blockmin_plain(q, p, k, rec), 3)
        gms = cuda_ms(lambda: knn_exact(q, p, min(k, m)), 5)
        bnd, by = bound_ms(bb * ((nq + m) * 12 + nq * k * 8),
                           bb * nq * m * D2_OPS)
        if per_step:
            report.add("knn_blockmin", 0, ms, pms, bnd, by,
                       per_step=per_step, general=gms, device=(dev, None))
        blk = block_size(m, k, rec)
        kernel, ctas = blockmin_launch(k, bb, nq, m, rec)
        log(f"knn_blockmin ({bb},{nq} q,{m} p,k={k},blk={blk},G="
            f"{-(-m // 1024) * 1024 // blk}; {kernel}, {ctas} CTAs) "
            f"x{per_step}/step: idx and dist bit-equal (grid, scene); single "
            f"call {ms:.4f} ms, device {dev:.4f} ms, plain {pms:.4f} ms, #2 "
            f"{gms:.4f} ms, bound {bnd:.4f} ms ({by})")
    if not ball:
        return
    x = scene_clouds(rng, TRAIN_B, N_POINT)
    if not torch.equal(ball_query_blockmin(x, x, BALL_R, BALL_NS),
                       ball_query_blockmin_plain(x, x, BALL_R, BALL_NS)):
        raise AssertionError("ball_blockmin scene cloud: kernel != plain")
    x = grid_cloud(gen, 2, 1500, 8.0)
    c = grid_cloud(gen, 2, 700, 8.0)
    for r_, ns in ((0.1, 8), (0.5, 16)):
        if not torch.equal(ball_query_blockmin(x, c, r_, ns),
                           ball_query_blockmin_plain(x, c, r_, ns)):
            raise AssertionError(f"ball_blockmin ragged r={r_}: kernel != "
                                 f"plain")
    log("ball_blockmin scene cloud (4,8192) r 2 ns 64; ragged (2,700 c,"
        "1500 p) r 0.1 ns 8, r 0.5 ns 16: bit-equal")
    for label, x, c, r, ns, calls in ball_sites(gen):
        bb, n = x.shape[:2]
        blk = block_size(n, ns, 0.95)
        got = ball_query_blockmin(x, c, r, ns)
        want = ball_query_blockmin_plain(x, c, r, ns)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"ball_blockmin {label}: kernel != plain at "
                f"{(got != want).sum().item()} slots")
        full, need = ball_need(got, n, blk)
        head = (f"ball_blockmin {label} ({bb},{c.shape[1]} c,{n} p,ns={ns},"
                f"r={r},blk={blk}): bit-equal; full balls "
                f"{full.float().mean().item():.4f}")
        if label == "smooth crowded":
            log(head)
            continue
        pairs = int(need.sum().item())
        ms = cuda_ms(lambda: ball_query_blockmin(x, c, r, ns), 20)
        dev = device_ms(lambda: ball_query_blockmin(x, c, r, ns), reps=5,
                        rounds=4)
        pms = cuda_ms(lambda: ball_query_blockmin_plain(x, c, r, ns), 3)
        gms = cuda_ms(lambda: ball_query_exact(x, c, r, ns), 5)
        m = c.shape[1]
        bnd, by = bound_ms(bb * ((n + m) * 12 + m * ns * 4), pairs * D2_OPS)
        if label == "smooth":
            report.add("ball_blockmin", 0, ms, pms, bnd, by, per_step=calls,
                       general=gms, device=(dev, None))
        log(f"{head}; x{calls if label == 'smooth' else 0}/step: single "
            f"call {ms:.4f} ms, device {dev:.4f} ms, plain {pms:.4f} ms, #5 "
            f"{gms:.4f} ms, bound {bnd:.4f} ms ({by}; {pairs} pairs needed)")


def check_blockmin_cases(gen):
    """#3 (both modes) and #5 bit-equal to their plain versions, every
    kernel and instance the plans can take, beyond the path sites:
    * KNN, each of the thread kernel (k <= THREAD_MAX_K) and the warp
      kernel: the low-bit case (two candidates of
      one run whose d2 agree above idx_bits, the lower index the farther:
      the full minimum keeps the nearer, the output says so), at blk 4, 8,
      16 and 32; every k from 1 to 64 over M 1500 on a grid; blk 4, 8, 16
      and 32 on continuous clouds of M 2047 (ragged, two tiles);
    * balls, #5 (blk 1) and #3 at blk 4, 8, 16 and 32: balls that fill
      within the first 32 candidates, empty balls (centres far away),
      continuous clouds, a ragged N."""
    from ogc_tpu_torch.ops.ball import ball_query_plain, launch_ball
    from ogc_tpu_torch.ops.knn_blockmin import (
        THREAD_MAX_K, TILE, ball_query_blockmin_plain, block_size,
        knn_blockmin, knn_blockmin_plain)

    def knn_case(label, q, p, k, rec):
        want = knn_blockmin_plain(q, p, k, rec)
        for variant in ("warp", "thread")[:1 + (k <= THREAD_MAX_K)]:
            if not knn_bits_equal(knn_blockmin(q, p, k, rec, variant), want):
                raise AssertionError(f"knn_blockmin {label} k{k} blk "
                                     f"{block_size(p.shape[1], k, rec)} "
                                     f"{variant}: kernel != plain")
        return want

    rng = np.random.RandomState(SEED + 1)
    # The low-bit case: 2048 points (idx_bits 11) far away but for 8 at
    # (1 + 2^-23, 0, 0), d2 1 + 2^-22, and 9 at (1, 0, 0), d2 1, against
    # queries at the origin.  k 16 at recall 0.99 / 0.95 / 0.9 / 0.8 takes
    # runs of 4 / 8 / 16 / 32 (8 and 9 share each).
    p = torch.from_numpy(100 + 30 * rng.rand(2, 2048, 3).astype(
        np.float32)).cuda()
    p[:, 8] = torch.tensor([float(np.nextafter(np.float32(1), 2)), 0, 0])
    p[:, 9] = torch.tensor([1.0, 0, 0])
    q = torch.zeros((2, 40, 3), device="cuda")
    for rec in (0.99, 0.95, 0.9, 0.8):
        d, i = knn_case("low bits", q, p, 16, rec)
        if not ((i[..., 0] == 9).all() and (d[..., 0] == 1.0).all()):
            raise AssertionError("knn_blockmin low bits: the run's winner "
                                 "is not the nearer candidate")
    x = grid_cloud(gen, 2, 1500, 8.0)
    c = grid_cloud(gen, 2, 300, 8.0)
    for k in range(1, 65):
        knn_case("k sweep", c, x, k, 0.95)
    q, p = scene_clouds(rng, 2, 500), scene_clouds(rng, 2, 2047)
    for rec in (0.99, 0.95, 0.9, 0.8):
        for k in (3, 16):
            knn_case("scene M 2047", q, p, k, rec)
    log("knn_blockmin cases bit-equal, both kernels: low bits (blk 4-32), k "
        "1..64 over (2,300 q,1500 p), scene clouds M 2047 at blk 4-32")

    def ball_case(label, x, c, r, ns):
        n = x.shape[1]
        for blk in (1, block_size(n, ns, 0.95)):
            want = (ball_query_plain(x, c, r, ns) if blk == 1
                    else ball_query_blockmin_plain(x, c, r, ns))
            n_pad = n if blk == 1 else -(-n // TILE) * TILE
            if not torch.equal(launch_ball(x, c, r, ns, blk, n_pad), want):
                raise AssertionError(f"ball {label} blk {blk}: kernel != "
                                     f"plain")
        return want

    # N 1500 (Np 2048): ns 2 / 8 / 16 / 40 take blk 32 / 16 / 8 / 4.
    tight = grid_cloud(gen, 2, 1500, 0.5, 1 / 64)
    far = grid_cloud(gen, 2, 77, 8.0) + 100
    x = scene_clouds(rng, 2, 1500)
    for ns in (2, 8, 16, 40):
        got = ball_case("tight", tight, tight[:, :200], 2.0, ns)
        if not (got == torch.arange(ns, device="cuda")
                * block_size(1500, ns, 0.95)).all():
            raise AssertionError(f"ball tight ns {ns}: not the first "
                                 f"candidate of each run")
        if ball_case("empty", tight, far, 2.0, ns).any():
            raise AssertionError(f"ball empty ns {ns}: not all zeros")
        ball_case("scene", x, x[:, :500], 1.0, ns)
        ball_case("ragged", x[:, :1111], x[:, 7:300], 3.0, ns)
    log("ball cases bit-equal, #5 and #3 at blk 4-32: balls full within the "
        "first 32 candidates, empty balls, scene clouds, ragged N")


def blockmin_crossover(gen):
    """#3's KNN kernels at every path site (16 and 8 clouds, the smooth
    KNN, the flow forward's) and at two small-k searches below
    THREAD_MIN_QUERIES: the thread kernel (k <= THREAD_MAX_K) and the warp
    kernel by device time, beside blockmin_plan's pick."""
    from ogc_tpu_torch.ops.knn_blockmin import (THREAD_MAX_K, block_size,
                                                blockmin_plan, knn_blockmin)

    # And two k = 3 searches below THREAD_MIN_QUERIES (3000 and 8192
    # queries), on no path: the other side of the plan's choice.
    sites = sorted({(b, nq, m, k, rec) for b in (16, 8)
                    for nq, m, k, rec in BLOCKMIN_SHAPES}
                   | {(TRAIN_B, N_POINT, N_POINT, SMOOTH_K, 0.95),
                      (2, 1500, 1500, 3, 0.99), (2, 4096, 2048, 3, 0.99)}
                   | set(FLOW_BLOCKMIN_SITES))
    for b, nq, m, k, rec in sites:
        q, p = grid_cloud(gen, b, nq), grid_cloud(gen, b, m)
        blk = block_size(m, k, rec)
        row = []
        for v in ("thread", "warp")[k > THREAD_MAX_K:]:
            t = device_ms(lambda: knn_blockmin(q, p, k, rec, v), reps=3,
                          rounds=2)
            row.append(f"{v} {t:.4f}")
        log(f"knn_blockmin crossover ({b},{nq} q,{m} p,k={k},blk={blk}) "
            f"device ms: {'; '.join(row)}; planned "
            f"{blockmin_plan(k, b * nq, blk)[0]}")


def flow_pool_sites(arch, npoint, b, iters, loc_flow_nn):
    """Every neighbour pool of one FlowStep3D eval forward (models/flownet.py)
    as (site, clouds, M, S, C, per-group add, ReLU, calls): the BatchNorm
    stacks fold their last affine and ReLU into the pool (a (C,) add), the
    single-layer stacks (H0Net's second conv, the GRU gates) their centre
    term (a per-group add, no activation)."""
    from ogc_tpu_torch.models.flownet import ARCHS

    a = ARCHS[arch]
    lr, rest = npoint // 4, iters - 1
    sites = []
    for i, sp in enumerate(a.enc_loc):
        m = npoint // sp.npoint_div
        sites.append((f"enc_loc_sa{i + 1}", 2 * b, m, sp.nsample, sp.mlp[-1],
                      False, True, 1))
        sites.append((f"enc_loc_sa{i + 1} (refine)", b, m, sp.nsample,
                      sp.mlp[-1], False, True, rest))
    for i, sp in enumerate(a.enc_glob):
        sites.append((f"enc_glob_sa{i + 1}", 2 * b, npoint // sp.npoint_div,
                      sp.nsample, sp.mlp[-1], False, True, 1))
    for i, sp in enumerate(a.corr_sa):
        sites.append((f"corr_sa{i + 1}", b, npoint // sp.npoint_div,
                      sp.nsample, sp.mlp[-1], False, True, 1))
    sites += [("flow0_sa1", b, lr, a.reg_nsample, a.reg_mlp[-1], False, True,
               1),
              ("h0_sa1", b, lr, 4, a.h0_mlp1[-1], False, True, 1),
              ("h0_sa2", b, lr, 4, a.hidden_dim, True, False, 1),
              ("local_corr", b, lr, loc_flow_nn, a.local_corr_mlp[-1], False,
               True, rest),
              ("flow_conv1", b, lr, a.flow_conv1.nsample,
               a.flow_conv1.mlp[-1], False, True, rest),
              ("flow_conv2", b, lr, a.flow_conv2.nsample,
               a.flow_conv2.mlp[-1], False, True, rest),
              ("gru_conv{z,r,q}", b, lr, 4, a.hidden_dim, True, False,
               3 * rest),
              ("flow_sa{1,2}", b, lr, a.reg_nsample, a.reg_mlp[-1], False,
               True, 2 * rest)]
    return sites


def pool_launches(sites):
    """#12 launches of a forward with OGC_PALLAS_POOL=on: the pools whose
    shape ops/pool.py::supported takes (the JAX package's gate)."""
    from ogc_tpu_torch.ops.pool import supported

    return sum(calls for _, clouds, m, s, c, _, _, calls in sites
               if supported(clouds * m, s, c))


def bits_equal(a, b):
    """Same shape, NaN at the same places, every other value the same bits
    (so -0.0 and +0.0 differ)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = a.isnan(), b.isnan()
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0).view(as_int[a.dtype]),
        b.masked_fill(nb, 0).view(as_int[b.dtype]))


def check_pool(report, gen, sites, what):
    """#12 at every supported pool shape of ``sites``, bit-equal to its
    plain version in every variant: max and mean, float32 and bf16, a
    broadcast and a per-group add, ReLU on and off.  The site's own variant
    (float32 max, its add and activation) is timed beside the plain
    version, the route the gate's off position takes (pool_neighbors' plain
    chain: "general"), and torch.amax over S (the library call of a bare
    max), by single call (cuda_ms, kernel and torch.amax in turns, each
    twice), by device time (device_ms) and by host enqueue time (host_us),
    weighted by the site's calls per forward.  Bound: bytes, every row
    read once and every pooled row written once."""
    from ogc_tpu_torch import ops
    from ogc_tpu_torch.ops.pool import (pool_plan, rowgroup_pool,
                                        rowgroup_pool_plain, supported)

    done, hosts = {}, []
    for site, clouds, m, s, c, per_group, relu, calls in sites:
        if not supported(clouds * m, s, c):
            log(f"pool {what} {site} ({clouds},{m},S={s},C={c}): S is not a "
                f"power of two, the plain chain pools (the JAX gate)")
            continue
        key = (clouds, m, s, c, per_group, relu)
        if key in done:
            d = done[key]
            report.add("pool", 0, d["ms"], d["plain"], d["bound"], d["by"],
                       d["lib"], per_step=calls, general=d["general"],
                       device=d["device"])
            hosts.append((calls, d["host"]))
            continue
        g = clouds * m
        x32 = torch.randn((g * s, c), generator=gen, device="cuda")
        scale = torch.rand((c,), generator=gen, device="cuda") + 0.5
        adds = {False: torch.randn((1, c), generator=gen, device="cuda"),
                True: torch.randn((g, c), generator=gen, device="cuda")}
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            for pg, add in adds.items():
                for rl in (True, False):
                    for mean in (False, True):
                        got = rowgroup_pool(x, scale, add.to(dt), s, rl, mean)
                        want = rowgroup_pool_plain(x, scale, add.to(dt), s,
                                                   rl, mean)
                        if not bits_equal(got, want):
                            raise AssertionError(
                                f"pool {site} {dt} per-group {pg} relu {rl} "
                                f"mean {mean}: kernel != plain, max diff "
                                f"{(got.float() - want.float()).abs().max()}")
        add = adds[per_group]
        x4 = x32.reshape(clouds, m, s, c)
        ms, lib = [], []
        for _ in range(2):
            ms.append(cuda_ms(lambda: rowgroup_pool(x32, scale, add, s, relu),
                              20))
            lib.append(cuda_ms(lambda: torch.amax(x4, 2), 20))
        ms, lib = float(np.median(ms)), float(np.median(lib))
        dev = (device_ms(lambda: rowgroup_pool(x32, scale, add, s, relu)),
               device_ms(lambda: torch.amax(x4, 2)))
        host = (host_us(lambda: rowgroup_pool(x32, scale, add, s, relu)),
                host_us(lambda: torch.amax(x4, 2)))
        pms = cuda_ms(lambda: rowgroup_pool_plain(x32, scale, add, s, relu),
                      5)
        ad4 = add.reshape(clouds, m, c) if per_group else add.reshape(c)
        ops.set_pool_mode("off")
        gms = cuda_ms(lambda: ops.pool_neighbors(
            x4, differentiable=False, scale=scale, add=ad4, relu=relu), 20)
        nbytes = ((g * s + g) * c * 4 + c * 4
                  + (g * c * 4 if per_group else c * 4))
        bnd, by = bound_ms(nbytes, 0)
        done[key] = dict(ms=ms, plain=pms, bound=bnd, by=by, lib=lib,
                         general=gms, device=dev, host=host)
        report.add("pool", 0, ms, pms, bnd, by, lib, per_step=calls,
                   general=gms, device=dev)
        s_t, vec = pool_plan(s, c, 4)
        log(f"pool {what} {site} ({clouds},{m},S={s},C={c}, "
            f"{'per-group' if per_group else 'broadcast'} add, relu {relu}; "
            f"S {'compiled' if s_t else 'runtime'}, "
            f"{'16-byte chunks' if vec else 'scalar'}) x{calls}/forward: "
            f"bit-equal in all 16 variants; single call: kernel {ms:.4f} ms, "
            f"torch.amax {lib:.4f} ms; device: kernel {dev[0]:.4f} ms, "
            f"torch.amax {dev[1]:.4f} ms ({bnd / dev[0]:.4f} of the bound); "
            f"host enqueue: kernel {host[0]:.2f} us, torch.amax "
            f"{host[1]:.2f} us; plain {pms:.4f} ms, gate-off chain "
            f"{gms:.4f} ms, bound {bnd:.4f} ms ({by})")
        hosts.append((calls, host))
    log(f"pool {what} per forward ({sum(c for c, _ in hosts)} calls): host "
        f"enqueue kernel {sum(c * h[0] for c, h in hosts):.2f} us, "
        f"torch.amax {sum(c * h[1] for c, h in hosts):.2f} us")


def negative_zeros(t):
    return int((torch.signbit(t.float()) & (t == 0)).sum())


def check_pool_cases(gen):
    """#12 on NaN and -0.0 rows, bit-equal to its plain version (NaN at the
    same places, zeros with the same sign): max and mean, ReLU on and off,
    float32 and bf16, with no scale and no add (null pointers; the kernel
    adds +0.0, so a -0.0 row pools to +0.0), with them given as ones and
    zeros, and with a -0.0 add (a -0.0 group stays -0.0 without ReLU); and
    the scalar and runtime-S instances (C = 12 and 6, S = 3, 5, 24, 64, a
    source off the 16-byte grid).  The given scale and add come first, so
    an entry point that takes no None meets the NaN rows first."""
    from ogc_tpu_torch.ops.pool import rowgroup_pool, rowgroup_pool_plain

    g, s, c = 4096, 8, 32
    x = torch.randn((g * s, c), generator=gen, device="cuda")
    rows = torch.randperm(g * s, generator=gen, device="cuda")
    x[rows[:64]] = float("nan")
    x[rows[64:80], :5] = float("nan")
    groups = torch.randperm(g, generator=gen, device="cuda")[:64]
    x.view(g, s, c)[groups] = -0.0  # whole groups of -0.0 rows
    x[rows[80:400]] = -0.0
    ones = torch.ones((c,), device="cuda")
    zeros = torch.zeros((1, c), device="cuda")
    negz = torch.full((1, c), -0.0, device="cuda")
    forms = [("ones/zeros", ones, zeros), ("ones/-0.0 add", ones, negz),
             ("none/none", None, None)]
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        for name, sc, ad in forms:
            ad = None if ad is None else ad.to(dt)
            for relu in (True, False):
                for mean in (False, True):
                    got = rowgroup_pool(xd, sc, ad, s, relu, mean)
                    want = rowgroup_pool_plain(xd, sc, ad, s, relu, mean)
                    n += 1
                    if not bits_equal(got, want):
                        raise AssertionError(
                            f"pool NaN/-0.0 rows {dt} scale/add {name} relu "
                            f"{relu} mean {mean}: kernel != plain; NaN at "
                            f"{int(got.isnan().sum())} against "
                            f"{int(want.isnan().sum())}, -0.0 at "
                            f"{negative_zeros(got)} against "
                            f"{negative_zeros(want)}")
    # The other instances: runtime S, the scalar chunk (C * 4 % 16 != 0, or
    # a source that starts 4 bytes off the grid).
    for s_, c_, off in ((3, 12, 0), (5, 6, 0), (24, 32, 0), (64, 16, 0),
                        (4, 32, 1), (16, 128, 1)):
        base = torch.randn((512 * s_ * c_ + off,), generator=gen,
                           device="cuda")
        xs = base[off:].view(512 * s_, c_)
        sc = torch.rand((c_,), generator=gen, device="cuda") + 0.5
        ad = torch.randn((512, c_), generator=gen, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            for relu, mean in ((True, False), (False, True)):
                got = rowgroup_pool(xs.to(dt), sc, ad.to(dt), s_, relu, mean)
                want = rowgroup_pool_plain(xs.to(dt), sc, ad.to(dt), s_, relu,
                                           mean)
                n += 1
                if not bits_equal(got, want):
                    raise AssertionError(f"pool S={s_} C={c_} offset {off} "
                                         f"{dt}: kernel != plain")
    log(f"pool NaN / -0.0 rows ({g} groups x S={s}, C={c}; scale/add "
        f"{', '.join(f[0] for f in forms)}) and the runtime-S and scalar "
        f"instances: {n} cases bit-equal to plain")


def same(a, b):
    """bits_equal for floats; equal shape, dtype and values for integers."""
    if a.is_floating_point():
        return bits_equal(a, b)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def check_prologue(what, pairs):
    """Each (name, fused kernel's output, torch prologue's) pair the same
    bits."""
    for name, got, want in pairs:
        if not same(got, want):
            raise AssertionError(f"{what}: fused prologue's {name} != the "
                                 f"torch prologue's")


def check_pruned(report, gen):
    """#4 at every shape its gate admits on the flow path (enc_loc SA1 4096 x
    8192 and SA2 2048 x 4096, k 32, at 2B = 16 clouds before the refinement
    and at B = 8 in it), at the seg parity SA0 (2048 x 8192, k 64) and smooth
    KNN (8192 x 8192, k 32) shapes, and at its edge cases: a ragged M = 5000,
    k = 64 over blocks of 32 points, k 1, a ragged N = 1000, every point at
    one place (every pair tied, nothing pruned), and clouds over one CTA's
    sort (M 20000, N 20000: the sort in runs).  Each call bit-equal to its
    plain version and to #2, and its fused prologue's sorted clouds, ids,
    boxes, lb2, order and count bit-equal to the torch prologue's
    (prologue, survivors).  At the flow sites, timed by single call and
    device time, split into the fused prologue (sort, #3 pre-pass,
    selection) and the search kernel, beside the torch prologue, the plain
    version and #2 ("general"); launches of one call (derived: sort, #3,
    selection, search, and the sort's merge and finish over one CTA's
    sort).  Bound as #2's (the pairs in each query's
    k-th-distance cube, D2_OPS operations each, or the bytes); the survivor
    share is the surviving (tile, block) pairs over all."""
    from ogc_tpu_torch.ops import knn_pruned as KP
    from ogc_tpu_torch.ops.knn import knn_exact
    from ogc_tpu_torch.ops.pruned_prologue import sort_launches

    CB, QT = KP.CB, KP.QT
    rest = FLOW_ITERS - 1
    # (label, clouds, queries, points, k, cb, calls per flow forward)
    cases = [("flow enc_loc SA1", 2 * FLOW_B, 4096, 8192, 32, CB, 1),
             ("flow enc_loc SA2", 2 * FLOW_B, 2048, 4096, 32, CB, 1),
             ("flow enc_loc SA1 (refine)", FLOW_B, 4096, 8192, 32, CB, rest),
             ("flow enc_loc SA2 (refine)", FLOW_B, 2048, 4096, 32, CB, rest),
             ("seg SA0", BATCH, 2048, 8192, 64, CB, 0),
             ("smooth knn", TRAIN_B, 8192, 8192, SMOOTH_K, CB, 0),
             ("ragged M", 2, 2048, 5000, 32, CB, 0),
             ("k 64 over 32-point blocks", 2, 1024, 4096, 64, 32, 0),
             ("k 1", 2, 1024, 4096, 1, CB, 0),
             ("ragged N", 2, 1000, 4096, 32, CB, 0),
             ("every point at one place", 2, 1024, 4096, 16, CB, 0),
             ("M over one CTA's sort", 2, 2048, 20000, 32, CB, 0),
             ("N over one CTA's sort", 1, 20000, 8192, 16, CB, 0)]
    total = {"single": 0.0, "device": 0.0, "prologue": 0.0, "search": 0.0,
             "torch prologue": 0.0}
    for label, b, nq, m, k, cb, calls in cases:
        q, p = grid_cloud(gen, b, nq), grid_cloud(gen, b, m)
        if label == "every point at one place":
            p = torch.full_like(p, 7.5)
        reset_counts()
        d, i = KP.knn_exact_pruned(q, p, k, cb)
        one_call = read_counts()
        pd, pi = KP.knn_exact_pruned_plain(q, p, k, cb)
        ed, ei = knn_exact(q, p, k)
        torch.cuda.synchronize()
        for other, od, oi in (("plain", pd, pi), ("#2", ed, ei)):
            if not (torch.equal(i, oi) and torch.equal(d, od)):
                raise AssertionError(
                    f"knn_exact_pruned {label}: kernel != {other} at "
                    f"{(i != oi).sum().item()} indices, max dist diff "
                    f"{(d - od).abs().max().item()}")
        want = launch_counts(pruned_sort=sort_launches(m, nq),
                             knn_blockmin=1, pruned_select=1,
                             knn_exact_pruned=1)
        if one_call != want:
            raise AssertionError(f"knn_exact_pruned {label}: launches "
                                 f"{one_call}, derived {want}")
        srt, sel = KP.fused_prologue(q, p, k, cb, QT)
        pro = KP.prologue(q, p, cb, QT)
        order, count = KP.survivors(pro, p, k, QT)
        check_prologue(f"knn_exact_pruned {label}", (
            ("q_s", srt.q_s, pro.q_s), ("p_s", srt.p4[..., :3], pro.p_s),
            ("pid", srt.p4[..., 3].view(torch.int32), pro.pid),
            ("qid", srt.qid[:, :nq], pro.qid.to(torch.int32)),
            ("q_box", srt.q_box, pro.q_box), ("p_box", srt.p_box, pro.p_box),
            ("lb2", sel.lb2, pro.lb2), ("order", sel.blocks, order),
            ("count", sel.count, count)))
        share = count.sum().item() / (count.numel() * order.shape[-1])
        if not calls:
            log(f"knn_exact_pruned {label} ({b},{nq} q,{m} p,k={k},cb={cb}): "
                f"idx and dist bit-equal to plain and to #2, the fused "
                f"prologue to the torch prologue; survivor share "
                f"{share:.4f}")
            continue
        t = {"single": cuda_ms(lambda: KP.knn_exact_pruned(q, p, k, cb), 10),
             "device": device_ms(lambda: KP.knn_exact_pruned(q, p, k, cb)),
             "prologue": device_ms(lambda: KP.fused_prologue(q, p, k, cb)),
             "search": device_ms(lambda: KP.search(srt, sel, nq, m, k)),
             "torch prologue": device_ms(
                 lambda: KP.survivors(KP.prologue(q, p, cb, QT), p, k, QT))}
        pro_ms = cuda_ms(lambda: KP.survivors(KP.prologue(q, p, cb, QT), p,
                                              k, QT), 10)
        pms = cuda_ms(lambda: KP.knn_exact_pruned_plain(q, p, k, cb), 3)
        gms = cuda_ms(lambda: knn_exact(q, p, k), 10)
        gdev = device_ms(lambda: knn_exact(q, p, k))
        pairs = box_pairs(q, p, d[..., -1])
        bnd, by = bound_ms(b * ((nq + m) * 12 + nq * k * 8), pairs * D2_OPS)
        report.add("knn_exact_pruned", 0, t["single"], pms, bnd, by,
                   per_step=calls, general=gms, device=(t["device"], None))
        for key in total:
            total[key] = (None if total[key] is None or t[key] is None
                          else total[key] + calls * t[key])
        log(f"knn_exact_pruned {label} ({b},{nq} q,{m} p,k={k},cb={cb}) "
            f"x{calls}/forward: idx and dist bit-equal to plain and to #2, "
            f"the fused prologue to the torch prologue; survivor share "
            f"{share:.4f}; single {t['single']:.4f} ms, device "
            f"{t['device']:.4f} ms (fused prologue {t['prologue']:.4f}, "
            f"search {t['search']:.4f}); torch prologue single {pro_ms:.4f}, "
            f"device {fmt_ms(t['torch prologue'])}; plain {pms:.4f} ms, #2 "
            f"{gms:.4f} single / {gdev:.4f} device, bound {bnd:.4f} ms "
            f"({by})")
    log("per KITTI-SF flow forward (gate on): knn_exact_pruned "
        + ", ".join(f"{n} {fmt_ms(v)}" for n, v in total.items()) + " ms")
    q, p = grid_cloud(gen, 2 * FLOW_B, 4096), grid_cloud(gen, 2 * FLOW_B, 8192)
    profile_steps("#4 calls (flow enc_loc SA1, 16 x 4096 x 8192, k 32)",
                  lambda _: KP.knn_exact_pruned(q, p, 32))


def sapien_tables(gen, clouds):
    """A grid cloud of SAPIEN scale (unit extent, 1/64 grid) and the index
    tables of its three grouping sites: SA0's KNN (256 FPS centres, k 64)
    clamped at each scale's radius, the smooth KNN (k 8, r 0.1) and the
    smooth ball (ns 16, r 0.2)."""
    from ogc_tpu_torch import ops

    x = grid_cloud(gen, clouds, SAP_N, 1.2, 1 / 64)
    centres = ops.gather(x, ops.furthest_point_sample(x, SA0_NPOINT))
    d, i = ops.knn(SA0_NS, centres, x)
    sa0 = [torch.where(d > r, i[..., :1], i) for r in SA0_RADII]
    d, i = ops.knn(SAP_KNN_K, x, x)
    knn = torch.where(d > SAP_KNN_R, i[..., :1], i)
    ball = ops.ball_query(SAP_BALL_R, SAP_BALL_NS, x, x)
    return x, sa0, knn, ball


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def index_add_ms(flat, g, n):
    """(single call, device) ms of index_add_ (deterministic mode) summing
    g (b, E, C) into (b * n, C) rows by flat (b, E); the device time is
    None where the call cannot be captured in a CUDA graph."""
    b, E, C = g.shape
    key = (flat.long() + torch.arange(b, device="cuda")[:, None] * n
           ).reshape(-1)
    rows = g.reshape(-1, C)
    acc = torch.zeros((b * n, C), device="cuda")
    lib = cuda_ms(lambda: acc.zero_().index_add_(0, key, rows), 20)
    try:
        ldev = device_ms(lambda: acc.zero_().index_add_(0, key, rows))
    except RuntimeError as e:  # not capturable in a CUDA graph
        ldev = None
        log(f"index_add_ device time not measured: {str(e)[:120]}")
    return lib, ldev


def check_onehot(reports, gen):
    """#7 and #8 at every SAPIEN shape, bit-equal to their plain versions
    (#8 with int32 and int64 idx, and to #11), timed beside the plain
    version, the general route (advanced indexing for the gather, #11 with
    its CSR built in CUDA for the scatter), the library call
    (torch.gather; deterministic index_add_) and the bytes bound; each
    kernel, its general route and the library call also by device time
    (device_ms).  Then #7 at every C from 1 to 16, at N 1 and 1024 and
    with E*C not a multiple of the 16-byte store.  ``reports`` maps a
    config to (Report, frames): each call is weighted by its calls per
    step of that config."""
    from ogc_tpu_torch.ops.onehot import (gather_rows_onehot,
                                          gather_rows_onehot_plain,
                                          onehot_scatter_plan,
                                          scatter_add_rows_onehot)
    from ogc_tpu_torch.ops.scatter import (scatter_add_rows,
                                           scatter_add_rows_plain)

    # (name, idx (clouds, M, S), source (clouds, N, C), scatter too,
    #  {config: calls per step})
    cases = []
    for frames in (2, 4):
        x, sa0, knn, ball = sapien_tables(gen, SAP_B * frames)
        src = torch.cat([x, x], -1)  # SA0 groups [xyz, pc]: C 6
        cfg = "woinv" if frames == 2 else "full"
        for r, idx in zip(SA0_RADII, sa0):
            cases.append((f"SA0 r{r} {frames} frames", idx, src, False,
                          {cfg: 1}))
    masks = torch.softmax(torch.randn((SAP_B, SAP_N, SAP_K), generator=gen,
                                      device="cuda") * 4, -1)
    calls = {cfg: frames for cfg, (_, frames) in reports.items()}
    cases.append(("smooth knn", knn[:SAP_B], masks, True, calls))
    cases.append(("smooth ball", ball[:SAP_B], masks, True, calls))
    for name, idx, src, scatter, per_step in cases:
        b, n, C = src.shape
        flat = idx.reshape(b, -1)
        E = flat.shape[1]
        got, want = gather_rows_onehot(src, flat), gather_rows_onehot_plain(
            src, flat)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"gather {name}: kernel != plain at "
                                 f"{(got != want).sum().item()} elements")
        lidx = flat.long()[..., None].expand(b, E, C)
        # Kernel and torch.gather in turns, each timed twice.
        ms, lib = [], []
        for _ in range(2):
            ms.append(cuda_ms(lambda: gather_rows_onehot(src, flat), 20))
            lib.append(cuda_ms(lambda: torch.gather(src, 1, lidx), 20))
        ms, lib = float(np.median(ms)), float(np.median(lib))
        dev = (device_ms(lambda: gather_rows_onehot(src, flat)),
               device_ms(lambda: torch.gather(src, 1, lidx)))
        pms = cuda_ms(lambda: gather_rows_onehot_plain(src, flat), 20)
        bnd, by = bound_ms(b * (n * C * 4 + E * 4 + E * C * 4), 0)
        for cfg, k in per_step.items():
            reports[cfg][0].add("gather_onehot", 0, ms, pms, bnd, by, lib,
                                per_step=k, device=dev)
        log(f"gather_onehot {name} ({b},{n},C={C}) x {E} rows x{per_step}/"
            f"step: bit-equal; single call: kernel {ms:.4f} ms, "
            f"torch.gather {lib:.4f} ms; device: kernel {dev[0]:.4f} ms, "
            f"torch.gather {dev[1]:.4f} ms; plain = general route (advanced "
            f"indexing) {pms:.4f} ms, bound {bnd:.4f} ms ({by})")
        if not scatter:
            continue
        g = torch.randn((b, E, C), generator=gen, device="cuda")
        want = scatter_add_rows_plain(flat, g, n)
        for got, what in ((scatter_add_rows_onehot(flat, g, n), "int32"),
                          (scatter_add_rows_onehot(flat.long(), g, n),
                           "int64"),
                          (scatter_add_rows(flat, g, n), "#11")):
            if not bits_equal(got, want):
                raise AssertionError(
                    f"scatter {name}: {what} != plain, max diff "
                    f"{(got - want).abs().max().item()}")
        ms = cuda_ms(lambda: scatter_add_rows_onehot(flat, g, n), 20)
        dev = device_ms(lambda: scatter_add_rows_onehot(flat, g, n))
        pms = cuda_ms(lambda: scatter_add_rows_plain(flat, g, n), 5)
        gms = cuda_ms(lambda: scatter_add_rows(flat, g, n), 20)
        gdev = device_ms(lambda: scatter_add_rows(flat, g, n))
        lib, ldev = index_add_ms(flat, g, n)
        bnd, by = bound_ms(b * (E * 4 + E * C * 4 + n * C * 4), b * E * C)
        for cfg, k in per_step.items():
            reports[cfg][0].add("scatter_onehot", 0, ms, pms, bnd, by, lib,
                                per_step=k, device=(dev, ldev))
            reports[cfg][0].add("scatter_general", 0, gms, pms, bnd, by, lib,
                                per_step=k, device=(gdev, ldev))
        log(f"scatter_onehot {name} ({b},{E} rows,C={C})->{n} x{per_step}/"
            f"step (windows of {onehot_scatter_plan(b, n, C).rows} rows): "
            f"bit-equal to plain (int32 and int64 idx) and to #11; single "
            f"call {ms:.4f} ms, device {dev:.4f} ms; #11 {gms:.4f} / "
            f"{gdev:.4f} ms; index_add_ {lib:.4f} / {fmt_ms(ldev)} ms; "
            f"plain {pms:.4f} ms, bound {bnd:.4f} ms ({by})")

    # Every C instance, N at both ends, ragged E (E * C % 4 != 0 for odd C:
    # later clouds start off the 16-byte grid, and the stores take the
    # word-by-word head and tail).
    for C in range(1, KERNEL_MAX_C + 1):
        for N, E in ((1, 37), (1024, 4099), (SAP_N, 16385)):
            src = torch.randn((3, N, C), generator=gen, device="cuda")
            idx = torch.randint(0, N, (3, E), generator=gen, device="cuda",
                                dtype=torch.int32)
            got = gather_rows_onehot(src, idx)
            if not torch.equal(got, gather_rows_onehot_plain(src, idx)):
                raise AssertionError(f"gather_onehot C={C} N={N} E={E}: "
                                     f"kernel != plain")
    log(f"gather_onehot C 1..{KERNEL_MAX_C} at (N, E) (1, 37), (1024, 4099), "
        f"({SAP_N}, 16385): bit-equal")


def scatter_edge_cases(gen):
    """(name, idx (B, E) int32, C, n) of #8's and #10's edge cases: a hub
    (one destination of in-degree >= 1000 among uniform edges), empty
    destinations (every fourth row only), every edge to one destination, E
    not a multiple of any tile (two 8192-edge tiles and 37), n 1 and n
    1024, C 1..16 (ragged E), B 1."""
    def rand(B, E, n):
        return torch.randint(0, n, (B, E), generator=gen, device="cuda",
                             dtype=torch.int32)

    hub = rand(4, 8192, 512)
    hub[:, 100:1300] = 7
    cases = [("hub", hub, 8, 512),
             ("empty destinations", (rand(4, 8192, 512) // 4) * 4, 8, 512),
             ("one destination", torch.full((3, 5000), 3, dtype=torch.int32,
                                            device="cuda"), 8, 512),
             ("ragged E", rand(2, 2 * 8192 + 37, 700), 8, 700),
             ("n 1", torch.zeros((2, 20001), dtype=torch.int32,
                                 device="cuda"), 5, 1),
             ("n 1024", rand(2, 4099, 1024), 16, 1024),
             ("B 1", rand(1, 3000, 300), 8, 300)]
    cases += [(f"C {C}", rand(2, 5003, 512), C, 512)
              for C in range(1, KERNEL_MAX_C + 1)]
    return cases


def check_onehot_cases(gen):
    """#8 at scatter_edge_cases, int32 and int64 idx, at the plan's window
    and at windows of 32, 64 and 256 rows (cut to what the kernel takes),
    bit-equal to its plain version and to #11; and windows of 32 to 256
    rows timed at SAPIEN's two smooth sites (device time), beside the
    plan's."""
    from ogc_tpu_torch.ops.onehot import (_launch_scatter,
                                          onehot_scatter_plan,
                                          scatter_add_rows_onehot,
                                          scatter_window)
    from ogc_tpu_torch.ops.scatter import (scatter_add_rows,
                                           scatter_add_rows_plain)

    for name, flat, C, n in scatter_edge_cases(gen):
        b, E = flat.shape
        g = torch.randn((b, E, C), generator=gen, device="cuda")
        want = scatter_add_rows_plain(flat, g, n)
        if not bits_equal(scatter_add_rows(flat, g, n), want):
            raise AssertionError(f"scatter {name}: #11 != plain")
        for rows in (None, 32, 64, 256):
            for idx in (flat, flat.long()):
                got = (scatter_add_rows_onehot(idx, g, n) if rows is None
                       else _launch_scatter(idx, g, n,
                                            scatter_window(n, C, rows)))
                if not bits_equal(got, want):
                    raise AssertionError(
                        f"scatter_onehot {name} ({b},{E})->{n} C={C} rows "
                        f"{rows} {idx.dtype}: != plain")
    log("scatter_onehot edge cases (hub of in-degree 1200, empty "
        "destinations, one destination, E 16421, n 1, n 1024, B 1, C 1..16) "
        "at the plan's window and 32, 64, 256 rows, int32 and int64 idx: "
        "bit-equal to plain and to #11")
    _, _, knn, ball = sapien_tables(gen, SAP_B)
    for name, idx in (("smooth knn", knn), ("smooth ball", ball)):
        flat = idx.reshape(SAP_B, -1)
        g = torch.randn((SAP_B, flat.shape[1], SAP_K), generator=gen,
                        device="cuda")
        times = {rows: device_ms(lambda: _launch_scatter(
            flat, g, SAP_N, scatter_window(SAP_N, SAP_K, rows)))
            for rows in (32, 64, 128, 256)}
        plan = onehot_scatter_plan(SAP_B, SAP_N, SAP_K).rows
        log(f"scatter_onehot window crossover {name} ({SAP_B},"
            f"{flat.shape[1]})->{SAP_N} C={SAP_K}: device ms by rows "
            + ", ".join(f"{r} {t:.4f}" for r, t in times.items())
            + f"; plan {plan}")


def check_blocksparse(report, gen):
    """#9/#10 on the mxu path's own table (mxu_tables of sorted synthetic
    KITTI-SF scenes, approximate as train_seg runs it: 4 x 8192 x 96, C 11),
    on SAPIEN's (512 points, 8 slots, exact routes below 1024 points), a
    ragged N = 1500 with an odd S = 17, and a uniform table whose every
    tile reaches more blocks than the JAX package's cap of 32.  #9 bit-equal
    to advanced indexing (its plain version and the route without the
    kernel) and the presence it writes bit-equal to bs_prologue's; #10 fed
    that presence bit-equal to its plain version and to #11.  Timed beside
    those, the library calls (torch.gather; index_add_, deterministic) and
    the bytes bound: #9 as the mxu forward calls it (bs_pad and the one
    launch), as a single call and by device time (device_ms), as
    torch.gather; #10 with #9's table.  Then #9 at every C from 1 to 16 on
    the ragged table, from an aligned source and from one at a storage
    offset of one float (not 16-byte aligned)."""
    from ogc_tpu_torch.losses.seg_unsup import OGCLossConfig, mxu_tables
    from ogc_tpu_torch.ops import blocksparse as bs
    from ogc_tpu_torch.ops.scatter import scatter_add_rows

    rng = np.random.RandomState(SEED)
    kitti = torch.from_numpy(np.stack([kitti_scene(rng)[0]
                                       for _ in range(TRAIN_B)])).cuda()
    sap = grid_cloud(gen, SAP_B, SAP_N, 1.2, 1 / 64)
    ragged = grid_cloud(gen, 2, 1500, 8.0)
    tables = [
        ("KITTI-SF smooth tables", kitti,
         (SMOOTH_K, SMOOTH_R, BALL_NS, BALL_R), MXU_C, TRAIN_T),
        ("SAPIEN smooth tables", sap,
         (SAP_KNN_K, SAP_KNN_R, SAP_BALL_NS, SAP_BALL_R), SAP_K + 1, 0),
        ("ragged N 1500, odd S 17", ragged, (8, 1.0, 9, 1.0), MXU_C, 0)]
    cases = []
    for name, pc, (k, r, ns, rb), C, per_step in tables:
        _, cat = mxu_tables(pc, OGCLossConfig(knn_k=k, knn_radius=r,
                                              ball_q_k=ns, ball_q_radius=rb,
                                              smooth_exact=False))
        cases.append((name, cat, pc.shape[1], C, per_step))
    cases.append(("uniform table", torch.randint(
        0, N_POINT, (1, 1024, 16), generator=gen, device="cuda",
        dtype=torch.int32), N_POINT, MXU_C, 0))
    for name, idx, n, C, per_step in cases:
        b, M, S = idx.shape
        src = torch.softmax(torch.randn((b, n, C), generator=gen,
                                        device="cuda") * 4, -1)
        src[..., -1] = torch.arange(n, device="cuda")  # the index column
        cot = torch.randn((b, M, S, C), generator=gen, device="cuda")
        flat, cflat = idx.reshape(b, M * S), cot.reshape(b, M * S, C)
        pro = bs.bs_prologue(idx, n)
        got, table = bs.gather_blocksparse(src, idx)
        want = bs.gather_blocksparse_plain(src, idx)
        grad = bs.scatter_add_blocksparse(idx, cot, n, table)
        plain = bs.scatter_add_blocksparse_plain(idx, cot, n)
        general = scatter_add_rows(flat, cflat, n)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"gather_blocksparse {name}: kernel != "
                                 f"indexing at {(got != want).sum().item()}")
        if not (torch.equal(table.presence, pro.presence)
                and torch.equal(table.idx, pro.idx)):
            raise AssertionError(f"gather_blocksparse {name}: presence != "
                                 f"bs_prologue's at "
                                 f"{(table.presence != pro.presence).sum()}")
        if not (torch.equal(grad, plain) and torch.equal(grad, general)):
            raise AssertionError(
                f"scatter_blocksparse {name}: kernel != plain or #11, max "
                f"diff {(grad - plain).abs().max().item()}")
        nblk = pro.nblk.float()
        units = pro.presence.sum(1, dtype=torch.int32).float()
        plan = bs.bs_scatter_plan(n, M, S)
        deg = torch.zeros((b, n), dtype=torch.int64, device="cuda")
        deg.scatter_add_(1, flat.long(),
                         torch.ones_like(flat, dtype=torch.int64))
        over = int((pro.nblk > bs.CAP).sum().item())
        if name == "uniform table" and over != pro.nblk.numel():
            raise AssertionError(f"uniform table: {over} of "
                                 f"{pro.nblk.numel()} tiles over the cap")
        lidx = flat.long()[..., None].expand(b, M * S, C)
        # #9 and torch.gather in turns, each timed twice.
        gms, glib = [], []
        for _ in range(2):
            gms.append(cuda_ms(lambda: bs.gather_blocksparse(src, idx), 20))
            glib.append(cuda_ms(lambda: torch.gather(src, 1, lidx), 20))
        gms, glib = float(np.median(gms)), float(np.median(glib))
        gdev = (device_ms(lambda: bs.gather_blocksparse(src, idx)),
                device_ms(lambda: torch.gather(src, 1, lidx)))
        gpl = cuda_ms(lambda: bs.gather_blocksparse_plain(src, idx), 20)
        sms = cuda_ms(lambda: bs.scatter_add_blocksparse(idx, cot, n, table),
                      20)
        sdev = device_ms(lambda: bs.scatter_add_blocksparse(idx, cot, n,
                                                            table))
        spl = cuda_ms(lambda: bs.scatter_add_blocksparse_plain(idx, cot, n),
                      3)
        s11 = cuda_ms(lambda: scatter_add_rows(flat, cflat, n), 20)
        s11dev = device_ms(lambda: scatter_add_rows(flat, cflat, n))
        slib, sldev = index_add_ms(flat, cflat, n)
        # #9 reads the source and the padded table and writes the rows and
        # the presence.
        gb, gby = bound_ms(b * (n * C * 4 + table.idx.shape[1] * 4
                                + M * S * C * 4)
                           + table.presence.numel(), 0)
        sb, sby = bound_ms(b * (M * S * 4 + M * S * C * 4 + n * C * 4),
                           b * M * S * C)
        if per_step:
            report.add("gather_blocksparse", 0, gms, gpl, gb, gby, glib,
                       per_step=per_step, general=gpl, device=gdev)
            report.add("scatter_blocksparse", 0, sms, spl, sb, sby, slib,
                       per_step=per_step, general=s11, device=(sdev, sldev))
            report.add("scatter_bs_general", 0, s11, spl, sb, sby, slib,
                       per_step=per_step, device=(s11dev, sldev))
        log(f"blocksparse {name} ({b},{n},C={C}) x {M} rows x S={S} "
            f"x{per_step}/step: blocks per 256-row tile max "
            f"{int(nblk.max().item())} mean {nblk.mean().item():.4f}, "
            f"{over} of {pro.nblk.numel()} tiles over 32; 32-row units "
            f"reaching a block max {int(units.max().item())} mean "
            f"{units.mean().item():.4f} of {pro.presence.shape[1]}; row "
            f"in-degree max {int(deg.max().item())} mean "
            f"{deg.float().mean().item():.4f}; #9 bit-equal to indexing, "
            f"its presence to bs_prologue's: single call {gms:.4f} ms, "
            f"torch.gather {glib:.4f} ms; device {gdev[0]:.4f} ms, "
            f"torch.gather {gdev[1]:.4f} ms; plain = general route "
            f"(indexing) {gpl:.4f} ms, bound {gb:.4f} ms ({gby}); #10 with "
            f"#9's presence bit-equal to plain and #11 ({plan.pieces} pieces "
            f"of {plan.piece} edges, {plan.ng} groups): single call {sms:.4f} ms, device "
            f"{sdev:.4f} ms; general route (#11, CSR built in CUDA) "
            f"{s11:.4f} / {s11dev:.4f} ms; index_add_ {slib:.4f} / "
            f"{fmt_ms(sldev)} ms; plain {spl:.4f} ms, bound {sb:.4f} ms "
            f"({sby})")
    # Every C instance on the ragged table and on a wide one (rows of 202
    # padded edges: a unit of 32 rows is more than one piece of 4096), from
    # an aligned source and from one whose data pointer is 4 bytes past the
    # 16-byte grid.
    wide = torch.randint(0, 700, (2, 300, 201), generator=gen, device="cuda",
                         dtype=torch.int32)
    for tname, idx, n in (("ragged", cases[2][1], cases[2][2]),
                          ("wide S 201", wide, 700)):
        b, M, S = idx.shape
        presence = bs.bs_prologue(idx, n).presence
        for C in range(1, KERNEL_MAX_C + 1):
            store = torch.randn((b * n * C + 1,), generator=gen,
                                device="cuda")
            for src in (store[:-1].view(b, n, C), store[1:].view(b, n, C)):
                got, table = bs.gather_blocksparse(src, idx)
                if not (torch.equal(got,
                                    bs.gather_blocksparse_plain(src, idx))
                        and torch.equal(table.presence, presence)):
                    raise AssertionError(
                        f"gather_blocksparse {tname} C={C} (source at byte "
                        f"{src.data_ptr() % 16} of 16): kernel != indexing "
                        f"or presence != bs_prologue's")
        log(f"gather_blocksparse C 1..{KERNEL_MAX_C} on the {tname} table "
            f"({b},{n}) x {M} x S={S}, source 16-byte aligned and 4 bytes "
            f"off: bit-equal, presence equal")


def check_blocksparse_cases(gen):
    """#10 on edge-case tables, fed #9's presence and bs_prologue's (the
    wrapper's own), bit-equal to its plain version and to #11: the
    KITTI-SF-like sorted scene's smooth table with 1200 edges to one point
    (a hub), every fourth point only (empty destinations), every edge to one
    destination, n 1, rows of 300 padded edges (two pieces a unit), and C
    1..16 on a ragged table (odd S 17)."""
    from ogc_tpu_torch.losses.seg_unsup import OGCLossConfig, mxu_tables
    from ogc_tpu_torch.ops import blocksparse as bs
    from ogc_tpu_torch.ops.scatter import scatter_add_rows

    rng = np.random.RandomState(SEED + 1)
    kitti = torch.from_numpy(kitti_scene(rng)[0][None]).cuda()
    _, cat = mxu_tables(kitti, OGCLossConfig(
        knn_k=SMOOTH_K, knn_radius=SMOOTH_R, ball_q_k=BALL_NS,
        ball_q_radius=BALL_R, smooth_exact=False))
    hub = cat.clone()
    hub.view(-1)[5000:6200] = 7
    ragged = grid_cloud(gen, 2, 1500, 8.0)
    _, rcat = mxu_tables(ragged, OGCLossConfig(
        knn_k=8, knn_radius=1.0, ball_q_k=9, ball_q_radius=1.0,
        smooth_exact=False))
    cases = [("hub", hub, N_POINT, MXU_C),
             ("empty destinations", (cat // 4) * 4, N_POINT, MXU_C),
             ("one destination", torch.full((2, 300, 17), 3,
                                            dtype=torch.int32,
                                            device="cuda"), 512, MXU_C),
             ("n 1", torch.zeros((2, 100, 7), dtype=torch.int32,
                                 device="cuda"), 1, 4),
             ("two pieces a unit", torch.randint(
                 0, 700, (2, 300, 300), generator=gen, device="cuda",
                 dtype=torch.int32), 700, MXU_C)]
    cases += [(f"C {C}", rcat, 1500, C) for C in range(1, KERNEL_MAX_C + 1)]
    for name, idx, n, C in cases:
        b, M, S = idx.shape
        src = torch.randn((b, n, C), generator=gen, device="cuda")
        cot = torch.randn((b, M, S, C), generator=gen, device="cuda")
        want = bs.scatter_add_blocksparse_plain(idx, cot, n)
        _, table = bs.gather_blocksparse(src, idx)
        got = [(bs.scatter_add_blocksparse(idx, cot, n, table),
                "#9's presence"),
               (bs.scatter_add_blocksparse(idx, cot, n), "bs_prologue's"),
               (scatter_add_rows(idx.reshape(b, M * S),
                                 cot.reshape(b, M * S, C), n), "#11")]
        for out, what in got:
            if not bits_equal(out, want):
                raise AssertionError(
                    f"scatter_blocksparse {name} ({b},{M},{S})->{n} C={C}: "
                    f"{what} != plain")
    log("scatter_blocksparse edge cases (hub of in-degree >= 1200, empty "
        "destinations, one destination, n 1, two pieces a unit, C 1..16 on "
        "an odd-S table) with #9's presence and bs_prologue's: bit-equal to "
        "plain and to #11")


def check_knn_cand(report, gen):
    """#6 at ogc_tpu_torch.tools.bench_knn_pruned's shapes and candidate
    settings on grid clouds, and at its edge cases (a pad block among the
    candidates at blk 1, k 1, k 64, blocks of 32 points, a ragged N and M,
    clouds over one CTA's sort: M 20000, N 20000; real points beyond the
    pad point, so that the pad key falls among real keys): bit-equal to
    its plain version, and its fused prologue's sorted clouds, ids, boxes,
    lb2, scores and candidates bit-equal to the torch prologue's.  At the
    bench's settings, timed by single call and device time, split into
    the fused prologue (sort, selection) and the search kernel, beside the
    torch prologue, the plain version, #3 at the same shape (the bench's
    other arm, "general") and #2's exact route; launches of one call
    (derived: sort, selection, search, and the sort's merge and finish
    over one CTA's sort); recall of #6 and of #3 against #2 (a report, not
    a gate).  Bound: D2_OPS f32
    operations per (query, candidate) pair the candidate blocks hold, or
    the bytes.  No single PyTorch call computes it: no library time.
    Weighted once per (shape, setting): one pass of the bench's calls."""
    from ogc_tpu_torch.ops import knn_cand as KC
    from ogc_tpu_torch.ops.knn import knn_exact
    from ogc_tpu_torch.ops.knn_blockmin import knn_blockmin
    from ogc_tpu_torch.ops.pruned_prologue import sort_launches
    from ogc_tpu_torch.tools.bench_knn_pruned import CASES

    def recall(i, ref):
        return (i[..., :, None] == ref[..., None, :]).any(-1).float().mean(
            ).item()

    def check(label, q, p, k, bc, blk, cb):
        N, M = q.shape[1], p.shape[1]
        reset_counts()
        d, i = KC.knn_cand(q, p, k, bc, blk=blk, cb=cb)
        one_call = read_counts()
        pd, pi = KC.knn_cand_plain(q, p, k, bc, blk=blk, cb=cb)
        torch.cuda.synchronize()
        if not (torch.equal(i, pi) and bits_equal(d, pd)):
            raise AssertionError(
                f"knn_cand {label}: kernel != plain at "
                f"{(i != pi).sum().item()} indices, max dist diff "
                f"{(d - pd).abs().max().item()}")
        want = launch_counts(pruned_sort=sort_launches(M, N),
                             pruned_select=1, knn_cand_pruned=1)
        if one_call != want:
            raise AssertionError(f"knn_cand {label}: launches {one_call}, "
                                 f"derived {want}")
        n_cand = KC.resolve(M, k, bc, blk, cb)[0]
        srt, sel = KC.fused_prologue(q, p, n_cand, cb)
        pro = KC.prologue(q, p, n_cand, cb)
        check_prologue(f"knn_cand {label}", (
            ("q_s", srt.q_s, pro.q_s), ("p_s", srt.p4[..., :3], pro.p_s),
            ("pid", srt.p4[..., 3].view(torch.int32), pro.pid),
            ("qid", srt.qid[:, :N], pro.qid.to(torch.int32)),
            ("q_box", srt.q_box, pro.q_box), ("p_box", srt.p_box, pro.p_box),
            ("lb2", sel.lb2, pro.lb2), ("score", sel.score, pro.score),
            ("cand", sel.blocks, pro.cand)))
        return d, i, n_cand, srt, sel

    # (label, clouds, queries, points, k, n_cand_blocks, blk, cb)
    edges = [("pad block among the candidates, blk 1", 2, 1000, 1000, 16, 7,
              1, KC.CB),
             ("k 1", 2, 2048, 4096, 1, 8, 2, KC.CB),
             ("k 64", 2, 2048, 8192, 64, 24, 2, KC.CB),
             ("32-point blocks", 2, 1500, 3000, 32, 40, 4, 32),
             ("ragged N and M", 2, 1001, 5003, 32, 16, 2, KC.CB),
             ("M over one CTA's sort", 1, 2048, 20000, 32, 24, 2, KC.CB),
             ("N over one CTA's sort", 1, 20000, 4096, 16, 8, 2, KC.CB),
             ("real points beyond the pad point", 2, 256, 300, 32, 2, 1,
              KC.CB)]
    for label, B, N, M, k, bc, blk, cb in edges:
        q, p = grid_cloud(gen, B, N), grid_cloud(gen, B, M)
        if label == "real points beyond the pad point":
            # All but 20 points 2e6 away, farther than the pads at 1e6:
            # the pad key falls among the real keys, by value.
            p[:, 20:, 0] -= 2e6
        _, i, n_cand, _, sel = check(label, q, p, k, bc, blk, cb)
        pads = (sel.blocks == -(-M // cb) - 1).any().item()
        mp = -(-M // cb) * cb
        is_pad = i == (1 << max(1, (mp - 1).bit_length())) - 1
        # Rows where a real key follows the pad key (no pad where mp = M).
        early = 0 if mp == M else (
            is_pad.any(-1) & (is_pad.int().argmax(-1) < k - 1)
            & (i[..., -1] < M)).sum().item()
        if label == "real points beyond the pad point" and not early:
            raise AssertionError(f"knn_cand {label}: no row has the pad key "
                                 f"before a real key")
        log(f"knn_cand {label} (B{B} N{N} M{M} k{k}, n_cand {n_cand}, blk "
            f"{blk}, cb {cb}): idx and dist bit-equal to plain, the fused "
            f"prologue to the torch prologue; pad block among the "
            f"candidates: {pads}; rows with a real key after the pad key: "
            f"{early}")
    total = {"single": 0.0, "device": 0.0, "prologue": 0.0, "search": 0.0,
             "torch prologue": 0.0}
    for B, N, M, k, cfgs in CASES:
        q, p = grid_cloud(gen, B, N), grid_cloud(gen, B, M)
        _, ei = knn_exact(q, p, k)
        _, fi = knn_blockmin(q, p, k, 0.95)
        fms = cuda_ms(lambda: knn_blockmin(q, p, k, 0.95), 10)
        fdev = device_ms(lambda: knn_blockmin(q, p, k, 0.95))
        ems = cuda_ms(lambda: knn_exact(q, p, k), 10)
        for bc, blk in cfgs:
            label = f"B{B} N{N} M{M} k{k} (n_cand {bc}, blk {blk})"
            d, i, n_cand, srt, sel = check(label, q, p, k, bc, blk, KC.CB)
            t = {"single": cuda_ms(lambda: KC.knn_cand(q, p, k, bc, blk=blk),
                                   10),
                 "device": device_ms(lambda: KC.knn_cand(q, p, k, bc,
                                                         blk=blk)),
                 "prologue": device_ms(lambda: KC.fused_prologue(q, p,
                                                                 n_cand)),
                 "search": device_ms(lambda: KC.search(srt, sel, N, M, k,
                                                       blk)),
                 "torch prologue": device_ms(
                     lambda: KC.prologue(q, p, n_cand))}
            pro_ms = cuda_ms(lambda: KC.prologue(q, p, n_cand), 10)
            pms = cuda_ms(lambda: KC.knn_cand_plain(q, p, k, bc, blk=blk), 3)
            bnd, by = bound_ms(B * ((N + M) * 12 + N * k * 8),
                               B * N * n_cand * KC.CB * D2_OPS)
            report.add("knn_cand_pruned", 0, t["single"], pms, bnd, by,
                       general=fms, device=(t["device"], None))
            for key in total:
                total[key] = (None if total[key] is None or t[key] is None
                              else total[key] + t[key])
            log(f"knn_cand_pruned {label}: idx and dist bit-equal to plain, "
                f"the fused prologue to the torch prologue; single "
                f"{t['single']:.4f} ms, device {t['device']:.4f} ms (fused "
                f"prologue {t['prologue']:.4f}, search {t['search']:.4f}); "
                f"torch prologue single {pro_ms:.4f}, device "
                f"{fmt_ms(t['torch prologue'])}; plain {pms:.4f} ms, #3 "
                f"{fms:.4f} single / {fdev:.4f} device, #2 {ems:.4f} ms, "
                f"bound {bnd:.4f} ms ({by}); recall against #2: "
                f"#6 {recall(i, ei):.4f}, #3 {recall(fi, ei):.4f}")
    log("per bench_knn_pruned pass: knn_cand_pruned "
        + ", ".join(f"{n} {fmt_ms(v)}" for n, v in total.items()) + " ms")
    # Where a call's time goes (the last setting's).
    profile_steps(f"#6 calls ({label})",
                  lambda _: KC.knn_cand(q, p, k, bc, blk=blk))


def check_kernels():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    eval_report, train_report = Report(), Report()
    log("-- eval path shapes (B=8)")
    check_fps(eval_report, gen, BATCH, 1)
    check_knn(eval_report, gen, [(BATCH, nq, m, k, 1)
                                 for nq, m, k in KNN_SHAPES], 6)
    from ogc_tpu_torch.ops.fps import fps, fps_plain

    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(np.stack([scene_cloud(rng, N_POINT)
                                   for _ in range(BATCH)])).cuda()
    mism = int((fps(x, 2048) != fps_plain(x, 2048)).sum().item())
    log(f"fps scene-like continuous cloud ({BATCH},{N_POINT},3)->2048: "
        f"{mism} mismatched indices (expected 0)")
    log("-- train path shapes (16 clouds; loss at B=4 per frame)")
    B = TRAIN_B * TRAIN_T
    check_fps(train_report, gen, B, 1)
    check_fps_cases(gen)
    fps_crossover(gen)
    check_knn(train_report, gen,
              [(B, nq, m, k, 1) for nq, m, k in KNN_SHAPES]
              + [(TRAIN_B, N_POINT, N_POINT, SMOOTH_K, 4)], 10)
    check_knn_cases(gen)
    knn_crossover(gen)
    check_ball(train_report, gen)
    check_scatter(train_report, gen)
    for rep, what, names in ((eval_report, "eval forward",
                              ("fps", "knn_exact")),
                             (train_report, "train step",
                              ("fps", "knn_exact", "ball_query",
                               "scatter_add"))):
        for name in names:
            e = rep.entry(name)
            log(f"per {what}: {name} kernel {e['ms']:.4f} ms, plain "
                f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
                f"({e['bound_by']}), library {e['library_ms']}"
                + (f"; device: kernel {e['device_ms']:.4f} ms"
                   if "device_ms" in e else ""))
    log("-- fast path: #3 at the train shapes (16 clouds; smooth terms at "
        "B=4 per frame), then at the eval shapes (B=8)")
    fast_report, fast_eval_report = Report(), Report()
    check_blockmin(fast_report, gen, B, BLOCKMIN_SHAPES)
    check_blockmin(fast_eval_report, gen, BATCH, BLOCKMIN_SHAPES, ball=False)
    check_blockmin_cases(gen)
    blockmin_crossover(gen)
    for rep, what in ((fast_report, "fast train step"),
                      (fast_eval_report, "fast eval forward")):
        for name in rep.rows:
            e = rep.entry(name)
            log(f"per {what}: {name} kernel {e['ms']:.4f} ms, device "
                f"{e['device_ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, "
                f"exact route {e['general_ms']:.4f} ms, bound "
                f"{e['bound_ms']:.4f} ms ({e['bound_by']})")
    log(f"-- SAPIEN path shapes (B={SAP_B} items x 2 or 4 frames x {SAP_N})")
    sapien = {"woinv": (Report(), 2), "full": (Report(), 4)}
    check_onehot(sapien, gen)
    check_onehot_cases(gen)
    for cfg, (rep, _) in sapien.items():
        for name in ("gather_onehot", "scatter_onehot", "scatter_general"):
            e = rep.entry(name)
            log(f"per SAPIEN {cfg} train step: {name} {e['ms']:.4f} ms, "
                f"plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
                f"({e['bound_by']}), library {e['library_ms']:.4f} ms"
                + (f"; device: kernel {e['device_ms']:.4f} ms, library "
                   f"{fmt_ms(e['library_device_ms'])} ms" if "device_ms" in e
                   else ""))
    log(f"-- flow path shapes (KITTI-SF B={FLOW_B} x {N_POINT}, "
        f"{FLOW_ITERS} iterations; SAPIEN test_flow B={SAP_FLOW_B} x "
        f"{SAP_N}, {SAP_FLOW_ITERS} iterations)")
    flow_report = Report()
    check_pool(flow_report, gen, flow_pool_sites(
        "kitti", N_POINT, FLOW_B, FLOW_ITERS, FLOW_KW["loc_flow_nn"]),
        "KITTI-SF")
    check_pool(Report(), gen, flow_pool_sites(
        "sapien", SAP_N, SAP_FLOW_B, SAP_FLOW_ITERS, 8), "SAPIEN")
    check_pool_cases(gen)
    check_pruned(flow_report, gen)
    check_fps(flow_report, gen, 2 * FLOW_B, 1, FLOW_FPS_SHAPES)
    e = flow_report.entry("fps")
    log(f"per KITTI-SF flow forward: fps kernel {e['ms']:.4f} ms, device "
        f"{e['device_ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, bound "
        f"{e['bound_ms']:.4f} ms ({e['bound_by']})")
    for name in ("pool", "knn_exact_pruned"):
        e = flow_report.entry(name)
        log(f"per KITTI-SF flow forward: {name} kernel {e['ms']:.4f} ms, "
            f"plain {e['plain_ms']:.4f} ms, general route "
            f"{e['general_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}), library {e['library_ms']}"
            + (f"; device: kernel {e['device_ms']:.4f} ms, library "
               f"{fmt_ms(e['library_device_ms'])} ms" if "device_ms" in e
               else ""))
    log(f"-- mxu edge engine: #9/#10 (KITTI-SF B={TRAIN_B} x {N_POINT} per "
        f"frame; SAPIEN; ragged; uniform)")
    mxu_report = Report()
    check_blocksparse(mxu_report, gen)
    check_blocksparse_cases(gen)
    log("-- #6 at ogc_tpu_torch.tools.bench_knn_pruned's shapes")
    cand_report = Report()
    check_knn_cand(cand_report, gen)
    for rep, what, names in (
            (mxu_report, "mxu train step",
             ("gather_blocksparse", "scatter_blocksparse",
              "scatter_bs_general")),
            (cand_report, "bench pass", ("knn_cand_pruned",))):
        for name in names:
            e = rep.entry(name)
            log(f"per {what}: {name} kernel {e['ms']:.4f} ms, plain "
                f"{e['plain_ms']:.4f} ms, general route "
                f"{fmt_ms(e.get('general_ms'))} ms, bound "
                f"{e['bound_ms']:.4f} ms ({e['bound_by']}), library "
                f"{e['library_ms']}"
                + (f"; device: kernel {e['device_ms']:.4f} ms, library "
                   f"{fmt_ms(e['library_device_ms'])} ms" if "device_ms" in e
                   else ""))
    log(f"-- flow-train paths: SAPIEN (B={SAP_FT_B} x {SAP_N}, "
        f"{SAP_FT_ITERS} iterations), OGC-DR (B={DR_FT_B} x {DR_FT_N})")
    flow_train = check_flow_train(gen)
    log("-- #1 above one CTA (the outdoor CLIs' full-resolution clouds)")
    outdoor_report = Report()
    check_fps_large(outdoor_report, gen)
    return {"parity": train_report, "sapien": sapien["full"][0],
            "fast": fast_report, "flow": flow_report, "mxu": mxu_report,
            "cand": cand_report, "flow_train": flow_train,
            "outdoor": outdoor_report}


# The flow-train paths (config/flow/sapien/sapien_unsup.yaml: B=32 x 512,
# 4 iterations; config/flow/ogcdr/ogcdr_unsup.yaml: B=16 x 2048).  The
# groups of one SAPIEN train step (name, queries M, S, source points N, C,
# #7 forward calls, backward calls): #7 where ops/onehot.py's gate holds
# (N <= 1024, C <= 16, M * S >= 1024), its backward #8; every other group
# whose source needs a gradient is advanced indexing with #11 backward.
# Calls: the encoders run on pc1 and pc2, then on the warped cloud in each
# of the 3 refinement iterations; the loss runs once per iteration.
FT_GROUPS = [("enc_loc sa1", 256, 16, 512, 6, 5, 0),
             ("upsample", 512, 3, 128, 3, 4, 4),
             ("flow_conv1", 128, 8, 128, 6, 3, 0),
             ("smooth knn", 512, 4, 512, 3, 4, 4),
             ("smooth ball", 512, 8, 512, 3, 4, 4),
             ("chamfer warped", 512, 1, 512, 3, 0, 4),
             ("enc_loc sa2", 128, 16, 256, 35, 0, 5),
             ("enc_glob sa1", 64, 16, 128, 67, 0, 2),
             ("enc_glob sa2", 32, 8, 64, 131, 0, 2),
             ("corr fp0", 64, 3, 32, 3, 0, 1),
             ("corr sa1", 64, 8, 64, 6, 0, 1),
             ("corr fp1", 128, 3, 64, 128, 0, 1),
             ("flow0 sa1", 128, 16, 128, 131, 0, 1),
             ("h0 sa1", 128, 4, 128, 67, 0, 1),
             ("h0 sa2", 128, 4, 128, 131, 0, 1),
             ("FlowEmbedding", 128, 8, 128, 67, 0, 3),
             ("flow_conv2", 128, 4, 128, 35, 0, 3),
             ("gru gates", 128, 4, 128, 342, 0, 9),
             ("flow_reg sa1", 128, 16, 128, 131, 0, 3),
             ("flow_reg sa2", 128, 16, 128, 131, 0, 3)]
# #2's searches of one SAPIEN train step (queries, points, k, calls): the
# encoders' SA KNN (enc_loc x 5, enc_glob x 2), the correlation's three_nn
# and SA, the shared 1/4-cloud table, the upsample stencil, the
# FlowEmbedding per refinement, and per iteration the two Chamfer k = 1
# searches and the smooth KNN (k 4).
FT_KNN = [(256, 512, 16, 5), (128, 256, 16, 5), (64, 128, 16, 2),
          (32, 64, 8, 2), (64, 32, 3, 1), (64, 64, 8, 1), (128, 64, 3, 1),
          (128, 128, 16, 1), (512, 128, 3, 1), (128, 128, 8, 3),
          (512, 512, 1, 8), (512, 512, 4, 4)]
# #3's searches of one OGC-DR train step (B=16 x 2048, approximate): the
# enc_loc SA KNN (x 5), and per iteration the Chamfer k = 1 searches and
# the smooth KNN (k 4) over 2048 points; the smooth ball (ns 8, r 0.1).
FT_BLOCKMIN = [(1024, 2048, 16, 0.95, 5), (512, 1024, 16, 0.95, 5),
               (2048, 2048, 1, 0.99, 8), (2048, 2048, 4, 0.99, 4)]
SAP_FT_B, SAP_FT_ITERS, DR_FT_B, DR_FT_N = 32, 4, 16, 2048
FT_BALL_NS, FT_BALL_R = 8, 0.1


def group_table(gen, b, m, s, n, ball=False, cross=False):
    """A neighbour table of ``m`` queries in a SAPIEN-scale grid cloud of
    ``n`` points (unit extent, 1/64 grid), by KNN or with ``ball`` the
    smooth ball: (b, m * s) int32.  The queries are a prefix of the points
    (the sampled centres) where m <= n, else, or with ``cross``, a cloud of
    their own."""
    from ogc_tpu_torch import ops

    p = grid_cloud(gen, b, n, 1.2, 1 / 64)
    q = (p[:, :m].contiguous() if m <= n and not cross
         else grid_cloud(gen, b, m, 1.2, 1 / 64))
    if ball:
        return ops.ball_query(FT_BALL_R, s, p, q, exact=True).reshape(b, -1)
    return ops.knn(s, q, p, exact=True)[1].reshape(b, -1)


def check_flow_train(gen):
    """The kernels of the flow-train paths at their sites, each bit-equal
    to its plain version and timed by single call and device time beside
    the plain version and the library call: for one SAPIEN step (B=32 x
    512) #1 (FPS 512 -> 256, twice), #2 at FT_KNN, #5 (the smooth ball, 32
    x 512, ns 8, r 0.1, 4 calls), #7 / #8 and #11 at FT_GROUPS (#8 and #11
    also equal to each other where both apply); for one OGC-DR step (B=16 x
    2048) #1 (2048 -> 1024, twice), #3's KNN at FT_BLOCKMIN and its ball
    (ns 8, r 0.1, 4 calls).  Returns {"sapien" | "ogcdr": Report}."""
    from ogc_tpu_torch.ops.ball import ball_query_exact, ball_query_plain
    from ogc_tpu_torch.ops.knn_blockmin import (ball_query_blockmin,
                                                ball_query_blockmin_plain,
                                                knn_blockmin,
                                                knn_blockmin_plain)
    from ogc_tpu_torch.ops.onehot import (gather_rows_onehot,
                                          gather_rows_onehot_plain,
                                          scatter_add_rows_onehot)
    from ogc_tpu_torch.ops.scatter import (scatter_add_rows,
                                           scatter_add_rows_plain)

    sap, dr = Report(), Report()
    b = SAP_FT_B
    check_fps(sap, gen, b, 2, [(SAP_N, SAP_N // 2)])
    check_knn(sap, gen, [(b, nq, m, k, calls) for nq, m, k, calls in FT_KNN],
              sum(c for *_, c in FT_KNN))
    x = grid_cloud(gen, b, SAP_N, 1.2, 1 / 64)
    got = ball_query_exact(x, x, FT_BALL_R, FT_BALL_NS)
    if not torch.equal(got, ball_query_plain(x, x, FT_BALL_R, FT_BALL_NS)):
        raise AssertionError("flow-train ball query: kernel != plain")
    full, need = ball_need(got, SAP_N, 1)
    pairs = box_pairs(x, x, torch.full(full.shape, FT_BALL_R, device="cuda"),
                      need - 1)
    ms = cuda_ms(lambda: ball_query_exact(x, x, FT_BALL_R, FT_BALL_NS), 20)
    dev = device_ms(lambda: ball_query_exact(x, x, FT_BALL_R, FT_BALL_NS))
    pms = cuda_ms(lambda: ball_query_plain(x, x, FT_BALL_R, FT_BALL_NS), 3)
    bnd, by = bound_ms(b * (SAP_N * 24 + SAP_N * FT_BALL_NS * 4),
                       pairs * D2_OPS)
    sap.add("ball_query", 0, ms, pms, bnd, by, per_step=4, device=(dev, None))
    log(f"ball_query flow smooth ({b},{SAP_N},ns={FT_BALL_NS},r={FT_BALL_R})"
        f" x4/step: bit-equal; full balls {full.float().mean().item():.4f}; "
        f"single {ms:.4f} ms, device {dev:.4f} ms, plain {pms:.4f} ms, bound "
        f"{bnd:.4f} ms ({by})")
    for name, m, s, n, C, fwd, bwd in FT_GROUPS:
        flat = group_table(gen, b, m, s, n, ball=name == "smooth ball",
                           cross=name.startswith("chamfer"))
        E = flat.shape[1]
        onehot = fwd > 0
        if onehot:
            src = torch.randn((b, n, C), generator=gen, device="cuda")
            got = gather_rows_onehot(src, flat)
            if not torch.equal(got, gather_rows_onehot_plain(src, flat)):
                raise AssertionError(f"flow-train gather {name}: kernel != "
                                     f"plain")
            lidx = flat.long()[..., None].expand(b, E, C)
            ms = cuda_ms(lambda: gather_rows_onehot(src, flat), 20)
            dev = device_ms(lambda: gather_rows_onehot(src, flat))
            lib = cuda_ms(lambda: torch.gather(src, 1, lidx), 20)
            ldev = device_ms(lambda: torch.gather(src, 1, lidx))
            pms = cuda_ms(lambda: gather_rows_onehot_plain(src, flat), 20)
            bnd, by = bound_ms(b * (n * C * 4 + E * 4 + E * C * 4), 0)
            sap.add("gather_onehot", 0, ms, pms, bnd, by, lib, per_step=fwd,
                    device=(dev, ldev))
            log(f"gather_onehot flow {name} ({b},{n},C={C}) x {E} rows "
                f"x{fwd}/step: bit-equal; single {ms:.4f} ms, device "
                f"{dev:.4f} ms, torch.gather {lib:.4f} / {ldev:.4f} ms, "
                f"plain {pms:.4f} ms, bound {bnd:.4f} ms ({by})")
        if not bwd:
            continue
        g = torch.randn((b, E, C), generator=gen, device="cuda")
        want = scatter_add_rows_plain(flat, g, n)
        kern = scatter_add_rows_onehot if onehot else scatter_add_rows
        for what, got in (("kernel", kern(flat, g, n)),
                          ("#11", scatter_add_rows(flat, g, n))):
            if not bits_equal(got, want):
                raise AssertionError(f"flow-train scatter {name}: {what} != "
                                     f"plain")
        ms = cuda_ms(lambda: kern(flat, g, n), 20)
        dev = device_ms(lambda: kern(flat, g, n))
        pms = cuda_ms(lambda: scatter_add_rows_plain(flat, g, n), 5)
        lib, ldev = index_add_ms(flat, g, n)
        bnd, by = bound_ms(b * (E * 4 + E * C * 4 + n * C * 4), b * E * C)
        label = "scatter_onehot" if onehot else "scatter_add"
        sap.add(label, 0, ms, pms, bnd, by, lib, per_step=bwd,
                device=(dev, ldev))
        log(f"{label} flow {name} ({b},{E} rows,C={C})->{n} x{bwd}/step: "
            f"bit-equal to plain and #11; single {ms:.4f} ms, device "
            f"{dev:.4f} ms, index_add_ {lib:.4f} / {fmt_ms(ldev)} ms, plain "
            f"{pms:.4f} ms, bound {bnd:.4f} ms ({by})")
    b = DR_FT_B
    check_fps(dr, gen, b, 2, [(DR_FT_N, DR_FT_N // 2)])
    for nq, m, k, rec, calls in FT_BLOCKMIN:
        p = grid_cloud(gen, b, m, 2.0, 1 / 64)
        q = p[:, :nq].contiguous()
        if not knn_bits_equal(knn_blockmin(q, p, k, rec),
                              knn_blockmin_plain(q, p, k, rec)):
            raise AssertionError(f"flow-train knn_blockmin q{nq} p{m} k{k}: "
                                 f"kernel != plain")
        ms = cuda_ms(lambda: knn_blockmin(q, p, k, rec), 20)
        dev = device_ms(lambda: knn_blockmin(q, p, k, rec), reps=5, rounds=4)
        pms = cuda_ms(lambda: knn_blockmin_plain(q, p, k, rec), 3)
        bnd, by = bound_ms(b * ((nq + m) * 12 + nq * k * 8),
                           b * nq * m * D2_OPS)
        dr.add("knn_blockmin", 0, ms, pms, bnd, by, per_step=calls,
               device=(dev, None))
        log(f"knn_blockmin OGC-DR flow ({b},{nq} q,{m} p,k={k}) x{calls}/"
            f"step: bit-equal; single {ms:.4f} ms, device {dev:.4f} ms, "
            f"plain {pms:.4f} ms, bound {bnd:.4f} ms ({by})")
    x = grid_cloud(gen, b, DR_FT_N, 2.0, 1 / 64)
    got = ball_query_blockmin(x, x, FT_BALL_R, FT_BALL_NS)
    if not torch.equal(got, ball_query_blockmin_plain(x, x, FT_BALL_R,
                                                      FT_BALL_NS)):
        raise AssertionError("flow-train ball_blockmin: kernel != plain")
    ms = cuda_ms(lambda: ball_query_blockmin(x, x, FT_BALL_R, FT_BALL_NS), 20)
    dev = device_ms(lambda: ball_query_blockmin(x, x, FT_BALL_R, FT_BALL_NS))
    pms = cuda_ms(lambda: ball_query_blockmin_plain(x, x, FT_BALL_R,
                                                    FT_BALL_NS), 3)
    bnd, by = bound_ms(b * (DR_FT_N * 24 + DR_FT_N * FT_BALL_NS * 4),
                       b * DR_FT_N * DR_FT_N * D2_OPS)
    dr.add("ball_blockmin", 0, ms, pms, bnd, by, per_step=4,
           device=(dev, None))
    log(f"ball_blockmin OGC-DR flow ({b},{DR_FT_N},ns={FT_BALL_NS},"
        f"r={FT_BALL_R}) x4/step: bit-equal; single {ms:.4f} ms, device "
        f"{dev:.4f} ms, plain {pms:.4f} ms, bound {bnd:.4f} ms ({by})")
    for rep, what in ((sap, "SAPIEN flow-train step"),
                      (dr, "OGC-DR flow-train step")):
        for name in rep.rows:
            e = rep.entry(name)
            log(f"per {what}: {name} single {e['ms']:.4f} ms, device "
                f"{e['device_ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, "
                f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}), library "
                f"{fmt_ms(e['library_ms'])} ms / device "
                f"{fmt_ms(e['library_device_ms'])} ms")
    return {"sapien": sap, "ogcdr": dr}

def kitti_scene(rng):
    """One synthetic KITTI-SF scene of N_POINT points: a static ground plane
    plus 3-6 rigid objects that move between frames.  :return: (pc1, flow1,
    segm1)."""
    n_obj = rng.randint(3, 7)
    counts = [N_POINT // 2] + [(N_POINT - N_POINT // 2) // n_obj] * n_obj
    counts[-1] += N_POINT - sum(counts)
    pc = [np.c_[60 * rng.rand(counts[0], 2) - 30,
                0.1 * rng.randn(counts[0], 1)]]
    segm = [np.zeros(counts[0], np.int64)]
    flow = [np.zeros((counts[0], 3))]
    for o in range(1, n_obj + 1):
        center = np.r_[50 * rng.rand(2) - 25, 0.8]
        pts = center + (rng.rand(counts[o], 3) - 0.5) * [4.0, 1.8, 1.5]
        a = rng.uniform(-0.1, 0.1)
        rot = np.array([[math.cos(a), -math.sin(a), 0],
                        [math.sin(a), math.cos(a), 0], [0, 0, 1]])
        moved = (pts - center) @ rot.T + center + np.r_[rng.randn(2), 0]
        pc.append(pts)
        segm.append(np.full(counts[o], o))
        flow.append(moved - pts)
    pc1 = np.vstack(pc).astype(np.float32)
    flow1 = np.vstack(flow).astype(np.float32)
    segm1 = np.concatenate(segm)
    perm = rng.permutation(N_POINT)
    return pc1[perm], flow1[perm], segm1[perm]


def write_kittisf(root, ids, seed):
    """KITTI-SF downsampled layout (data/<id>/{pc,flow,segm}{1,2}.npy) of
    kitti_scene's scenes; flow_preds/flowstep3d/<id>/flow{1,2}.npy hold the
    same flows as the predictions training reads."""
    rng = np.random.RandomState(seed)
    for sid in ids:
        pc1, flow1, segm1 = kitti_scene(rng)
        d = osp.join(root, "data", sid)
        os.makedirs(d)
        for name, arr in (("pc1", pc1), ("pc2", pc1 + flow1), ("flow1", flow1),
                          ("flow2", -flow1), ("segm1", segm1),
                          ("segm2", segm1)):
            np.save(osp.join(d, name + ".npy"), arr)
        d = osp.join(root, "flow_preds", "flowstep3d", sid)
        os.makedirs(d)
        np.save(osp.join(d, "flow1.npy"), flow1)
        np.save(osp.join(d, "flow2.npy"), -flow1)


def counters():
    from ogc_tpu_torch.ops.ball import ball_query_exact
    from ogc_tpu_torch.ops.blocksparse import (gather_blocksparse,
                                               scatter_add_blocksparse)
    from ogc_tpu_torch.ops.fps import fps
    from ogc_tpu_torch.ops.knn_cand import knn_cand
    from ogc_tpu_torch.ops.knn import knn_exact
    from ogc_tpu_torch.ops.knn_blockmin import (ball_query_blockmin,
                                                knn_blockmin)
    from ogc_tpu_torch.ops.knn_pruned import knn_exact_pruned
    from ogc_tpu_torch.ops.onehot import (gather_rows_onehot,
                                          scatter_add_rows_onehot)
    from ogc_tpu_torch.ops.pool import rowgroup_pool
    from ogc_tpu_torch.ops.pruned_prologue import select_blocks, sort_clouds
    from ogc_tpu_torch.ops.scatter import scatter_add_rows

    return {"fps": fps, "knn_exact": knn_exact,
            "ball_query": ball_query_exact, "scatter_add": scatter_add_rows,
            "gather_onehot": gather_rows_onehot,
            "scatter_onehot": scatter_add_rows_onehot,
            "knn_blockmin": knn_blockmin, "ball_blockmin": ball_query_blockmin,
            "pool": rowgroup_pool, "knn_exact_pruned": knn_exact_pruned,
            "gather_blocksparse": gather_blocksparse,
            "scatter_blocksparse": scatter_add_blocksparse,
            "knn_cand_pruned": knn_cand, "pruned_sort": sort_clouds,
            "pruned_select": select_blocks}


def reset_counts():
    """Every launch count to 0, #1's cluster instance's too."""
    for fn in counters().values():
        fn.launches = 0
    counters()["fps"].cluster_launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def setup_data(tmp):
    """Synthetic KITTI-SF root, mapping files, and copies of the parity, the
    fast and the mxu config pointing at them: {"parity" | "fast" | "mxu":
    (cfg, path)}.  The mxu config is the fast one with symmetric_grad false
    and edge_engine mxu (the JAX package takes the mxu engine only without
    the symmetric gradient)."""
    import yaml

    with open("data_prepare/kittisf/splits/train.txt") as f:
        train_ids = f.read().split()[:N_TRAIN_IDS]
    with open("data_prepare/kittisf/splits/val.txt") as f:
        val_ids = f.read().split()
    root = osp.join(tmp, "kittisf")
    t0 = time.perf_counter()
    write_kittisf(root, sorted(set(train_ids) | set(val_ids)), SEED)
    maps = {}
    for split, ids in (("train", train_ids), ("val", val_ids[:N_VAL_IDS])):
        maps[split] = osp.join(tmp, f"{split}.txt")
        with open(maps[split], "w") as f:
            f.write("\n".join(ids))
    out = {}
    for mode, name in (("parity", "kittisf_unsup"),
                       ("fast", "kittisf_unsup_fast"),
                       ("mxu", "kittisf_unsup_fast")):
        with open(f"config/seg/kittisf/{name}.yaml") as f:
            cfg = yaml.safe_load(f)
        if mode == "mxu":
            cfg["loss"]["smooth_loss_params"].update(symmetric_grad=False,
                                                     edge_engine="mxu")
            name = "kittisf_unsup_fast_mxu"
        cfg["data"].update(root=root, train_mapping=maps["train"],
                           val_mapping=maps["val"])
        cfg["save_path"] = osp.join(tmp, "ckpt", name)
        cfg["epochs"] = 1
        cfg_path = osp.join(tmp, f"{name}.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        out[mode] = (cfg, cfg_path)
    log(f"setup: {len(set(train_ids) | set(val_ids))} scenes x {N_POINT} "
        f"points in {time.perf_counter() - t0:.3f} s")
    return out


def set_modes(cfg, exact=None):
    """The process-wide settings the CLIs set: the compute dtype of ``cfg``
    and, unless None, the neighbour mode."""
    from ogc_tpu_torch import ops
    from ogc_tpu_torch.utils.config import apply_compute_dtype

    apply_compute_dtype(cfg)
    if exact is not None:
        ops.set_exact_neighbors(exact)


def make_model(cfg, device):
    from ogc_tpu_torch.models.segnet import MaskFormer3D

    sn = cfg["segnet"]
    return MaskFormer3D(
        n_slot=sn["n_slot"], n_point=sn["n_point"], arch=cfg["dataset"],
        use_xyz=sn["use_xyz"], n_transformer_layer=sn["n_transformer_layer"],
        transformer_embed_dim=sn["transformer_embed_dim"],
        transformer_input_pos_enc=sn["transformer_input_pos_enc"],
        generator=torch.Generator().manual_seed(SEED)).to(device)


def make_trainer(cfg, model, device, exp_base):
    from ogc_tpu_torch.losses.seg_unsup import OGCLossConfig
    from ogc_tpu_torch.train.seg import Adam, SegTrainer, make_lr_schedule

    opt = Adam(dict(model.named_parameters()),
               make_lr_schedule(cfg["lr"], cfg["lr_decay"], cfg["lr_clip"],
                                cfg["decay_step"], cfg["batch_size"]))
    return SegTrainer(model, OGCLossConfig.from_dict(cfg["loss"]), opt,
                      aug_transform_epoch=0, ignore_npoint_thresh=0,
                      exp_base=exp_base, device=device)


def fixed_batch(cfg, n_items):
    """One augmented batch (4 frames per item) of the train set, drawn with
    a fixed seed."""
    d = cfg["data"]
    common = dict(predflow_path=cfg["predflow_path"],
                  decentralize=d["decentralize"], aug_transform=True,
                  aug_transform_args=d["aug_transform_args"])
    if cfg["dataset"] == "sapien":
        from ogc_tpu_torch.data.sapien import SapienDataset

        ds = SapienDataset(data_root=osp.join(d["root"], "mbs-shapepart"),
                           split="train", view_sels=[[0, 1], [1, 2], [2, 3]],
                           **common)
    else:
        from ogc_tpu_torch.data.kittisf import KITTISceneFlowDataset

        ds = KITTISceneFlowDataset(
            data_root=d["root"], mapping_path=d["train_mapping"],
            downsampled=True, view_sels=[[0, 1]], **common)
    np.random.seed(SEED)
    items = [ds[i] for i in range(n_items)]
    return tuple(np.stack(f, 0) for f in zip(*items))


def run_train(tmp, cfg, cfg_path, exact, per_step, per_val):
    """train_seg on ``cfg`` in the given neighbour mode (train_seg itself
    follows the process's mode, as with OGC_EXACT_NEIGHBORS), its launches
    against the derived ones, then the determinism and card-vs-CPU checks
    (in float32 for a bf16 config, which also gets check_bf16_step)."""
    from ogc_tpu_torch import train_seg

    set_modes(cfg, exact)
    name = osp.basename(cfg_path)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = train_seg.main([cfg_path, "--round", "1", "--device", DEVICE])
    wall = time.perf_counter() - t0
    launches = read_counts()
    trainer = res["trainer"]
    steps = len(trainer.step_seconds)
    n_val = -(-N_VAL_IDS // TRAIN_B)
    want = {k: steps * per_step[k] + n_val * per_val[k] for k in KERNELS}
    log(f"train main path {name} ({'exact' if exact else 'approximate'}): "
        f"{steps} steps of B={TRAIN_B} x {TRAIN_T} frames x {N_POINT}, val "
        f"epoch of {n_val} batches; launches {launches}, derived {want} (per "
        f"step {per_step}, per val batch {per_val})")
    if steps != N_TRAIN_IDS // TRAIN_B or launches != want:
        raise AssertionError(f"expected {N_TRAIN_IDS // TRAIN_B} steps and "
                             f"launches {want}, got {steps} and {launches}")
    with open(osp.join(trainer.exp_base, "log", "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    terms = [s for s in scalars if s["tag"].startswith("train/")]
    if len(terms) != 6 * steps or not all(math.isfinite(s["value"])
                                          for s in terms):
        raise AssertionError(f"loss terms not all finite: {terms}")
    last = {s["tag"]: s["value"] for s in terms}
    step_ms = np.array(trainer.step_seconds) * 1e3
    med = float(np.median(step_ms[1:]))
    clouds = TRAIN_B * TRAIN_T
    log(f"train step {name} (host clock around a synchronised step, steps "
        f"2-{steps}): median {med:.4f} ms, min {step_ms[1:].min():.4f}, max "
        f"{step_ms[1:].max():.4f}; {1e3 / med:.4f} steps/s, "
        f"{clouds * 1e3 / med:.4f} clouds/s; first step {step_ms[0]:.4f} ms; "
        f"val epoch {trainer.val_seconds[0] * 1e3:.4f} ms; whole train_seg "
        f"{wall:.4f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    log(f"last step's terms: {last}; best val loss {res['best_loss']}")
    check_determinism(cfg, tmp, fixed_batch(cfg, TRAIN_B))
    check_card_vs_cpu({**cfg, "compute_dtype": "f32"}, tmp,
                      fixed_batch(cfg, 1))
    if cfg.get("compute_dtype") == "bf16":
        check_bf16_step(cfg, tmp, fixed_batch(cfg, 1))
    return launches


def first_it_all_terms(cfg, n_items):
    """The first step whose samples seen pass every start step, so that
    every loss term (and every scatter-add) carries a gradient."""
    return -(-max(cfg["loss"]["start_steps"]) // n_items)


def check_determinism(cfg, tmp, batch):
    """Two 2-step runs from one seed on one batch, all loss terms on:
    bit-equal parameters."""
    set_modes(cfg)
    it0 = first_it_all_terms(cfg, batch[0].shape[0])
    params = []
    for run in range(2):
        model = make_model(cfg, DEVICE)
        trainer = make_trainer(cfg, model, torch.device(DEVICE),
                               osp.join(tmp, f"det{run}"))
        for it in range(it0, it0 + 2):
            trainer.train_it(it, batch, aug_transform=True)
        params.append({k: v.detach().clone()
                       for k, v in model.named_parameters()})
    diff = [k for k in params[0] if not torch.equal(params[0][k],
                                                    params[1][k])]
    if diff:
        raise AssertionError(f"two seeded 2-step runs differ in {diff[:5]}")
    log(f"determinism: two seeded 2-step runs (steps {it0}-{it0 + 1}, all "
        f"terms on) give bit-equal parameters ({len(params[0])} tensors)")


def check_card_vs_cpu(cfg, tmp, batch):
    """One train step (all terms on: the samples seen pass every start
    step) on the card and on the CPU with the plain versions."""
    set_modes(cfg)
    it_samples = max(cfg["loss"]["start_steps"])
    shape = "x".join(map(str, batch[0].shape[:3]))
    out = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        model = make_model(cfg, dev)
        trainer = make_trainer(cfg, model, torch.device(dev),
                               osp.join(tmp, f"step_{dev}"))
        pcs, flows = trainer._to_device(batch[0], batch[2])
        loss, ld, _ = trainer._loss(pcs, flows, it_samples, True, True)
        loss.backward()
        out[dev] = ({k: float(v.detach()) for k, v in ld.items()},
                    {k: p.grad.detach().cpu().double().numpy()
                     for k, p in model.named_parameters()})
        log(f"one step {cfg['dataset']} items x frames x points {shape} on "
            f"{dev}: {time.perf_counter() - t0:.3f} s")
    (ld_c, g_c), (ld_r, g_r) = out[DEVICE], out["cpu"]
    for k in ld_r:
        if not math.isclose(ld_c[k], ld_r[k], rel_tol=LOSS_RTOL,
                            abs_tol=1e-12):
            raise AssertionError(f"term {k}: card {ld_c[k]} cpu {ld_r[k]}")
    c_all = np.concatenate([g_c[k].ravel() for k in g_r])
    r_all = np.concatenate([g_r[k].ravel() for k in g_r])
    gscale = np.sqrt((r_all ** 2).mean()) + 1e-12
    cos = c_all @ r_all / (np.linalg.norm(c_all) * np.linalg.norm(r_all))
    worst = max((np.linalg.norm(g_c[k] - g_r[k])
                 / (GRAD_RTOL * np.linalg.norm(g_r[k])
                    + GRAD_ATOL_FRAC * gscale * np.sqrt(g_r[k].size)), k)
                for k in g_r)
    log(f"card vs CPU, one step: terms {ld_c} vs {ld_r}; gradient cosine "
        f"{cos:.8f}, worst leaf at {worst[0]:.4f} of its tolerance "
        f"({worst[1]})")
    if not (cos > 0.9999 and worst[0] <= 1.0):
        raise AssertionError("card and CPU gradients disagree")


def check_bf16_step(cfg, tmp, batch):
    """One bf16 step on the card against the float32 step from the same
    weights and batch: finite, its loss and gradients within BF16_LOSS_RTOL
    and BF16_GRAD_RTOL, and moved from float32 by BF16_MIN_MOVE."""
    it_samples = max(cfg["loss"]["start_steps"])
    terms, grads = {}, {}
    for dt in ("f32", "bf16"):
        c = {**cfg, "compute_dtype": dt}
        set_modes(c)
        model = make_model(c, DEVICE)
        trainer = make_trainer(c, model, torch.device(DEVICE),
                               osp.join(tmp, f"bf16_{dt}"))
        pcs, flows = trainer._to_device(batch[0], batch[2])
        loss, ld, _ = trainer._loss(pcs, flows, it_samples, True, True)
        loss.backward()
        terms[dt] = {k: float(v.detach()) for k, v in ld.items()}
        grads[dt] = torch.cat([p.grad.detach().double().flatten()
                               for _, p in model.named_parameters()])
    set_modes(cfg)
    rel = {k: abs(terms["bf16"][k] - v) / max(abs(v), 1e-12)
           for k, v in terms["f32"].items()}
    moved = max(rel.values())
    gap = float((grads["bf16"] - grads["f32"]).norm()
                / grads["f32"].norm())
    log(f"bf16 step vs float32 step on the card: {terms['bf16']} vs "
        f"{terms['f32']}; relative differences {rel}; gradients' relative "
        f"gap {gap:.4e} (tolerances: loss {BF16_LOSS_RTOL}, gradients "
        f"{BF16_GRAD_RTOL}; largest term move and gradient gap at least "
        f"{BF16_MIN_MOVE})")
    if not (all(math.isfinite(v) for v in terms["bf16"].values())
            and torch.isfinite(grads["bf16"]).all()):
        raise AssertionError("bf16 step not finite")
    if rel["sum"] > BF16_LOSS_RTOL or gap > BF16_GRAD_RTOL:
        raise AssertionError("bf16 step off the float32 step")
    if moved < BF16_MIN_MOVE or gap < BF16_MIN_MOVE:
        raise AssertionError("bf16 step did not move from the float32 "
                             "step: it did not run in bf16")


#: Spin kernels (torch.cuda._sleep) launched in each profile before its
#: window: the trace can miss the first kernels after it starts (on an
#: NVIDIA H100 80GB HBM3, up to 33 a step of the SAPIEN flow-train
#: profile late in this script), and these take that loss instead of the
#: window's kernels.
PROFILE_GUARD_SPINS = 256


def profile_steps(what, fn, steps=3, expect=None):
    """torch.profiler over ``steps`` warm calls ``fn(i)``, i = 1..steps,
    after ``fn(0)``: the device's busy share of their host-clock time
    (device-side events' time over wall time; the profiler's own host cost
    lowers it a little), the operators whose kernels take the most device
    time, and the kernels that do.  The port's ctypes kernels are launched
    by no operator, so they show among the kernels only.

    PROFILE_GUARD_SPINS spin kernels run in the trace before the window
    and are left out of every figure; how many of them the trace holds is
    printed.  ``expect`` maps PROFILED_KERNELS labels to the kernels one
    call launches (the launch counters' count for a one-kernel wrapper),
    and the profile must show exactly that many.  Returns ({label: kernels
    per call}, device-side events per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_GUARD_SPINS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1, steps + 1):
            fn(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spins = [e for e in prof.key_averages() if "spin_kernel" in e.key]
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    kernels = [e for e in events if e.device_type != DeviceType.CPU
               and "spin_kernel" not in e.key]
    ops = [e for e in events if e.device_type == DeviceType.CPU]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_events = sum(e.count for e in kernels) / steps
    log(f"profile of {steps} {what}: device time {dev_us / 1e3:.4f} ms of "
        f"{wall_us / 1e3:.4f} ms wall, busy share {dev_us / wall_us:.4f}; "
        f"{n_events:g} device-side events per call; the trace holds "
        f"{sum(e.count for e in spins)} of {PROFILE_GUARD_SPINS} guard "
        f"spins")
    counts = {}
    for label, symbols in PROFILED_KERNELS.items():
        mine = [e for e in kernels if e.key.removeprefix("void ")
                .removeprefix("(anonymous namespace)::").startswith(symbols)]
        ms = sum(e.self_device_time_total for e in mine) / 1e3 / steps
        counts[label] = sum(e.count for e in mine) / steps
        log(f"  {label}: {ms:.4f} ms device time, {counts[label]:g} kernels "
            f"per call")
    for title, rows, n in (("operators", ops, 12), ("kernels", kernels, 8)):
        log(f"  top {title} by device time (share, ms per call, count per "
            f"call):")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:n]:
            name = e.key.removeprefix("void ").removeprefix(
                "(anonymous namespace)::").split("(")[0]
            log(f"  {e.self_device_time_total / dev_us:7.4f} "
                f"{e.self_device_time_total / 1e3 / steps:9.4f} "
                f"x{e.count // steps:<5d} {name[:100]}")
    off = {k: (counts[k], v) for k, v in (expect or {}).items()
           if counts[k] != v}
    if off:
        raise AssertionError(f"profile of {what}: kernels per call (profile, "
                             f"counters) {off}")
    return counts, n_events


def profile_train(cfg, tmp, batch, steps=3):
    """profile_steps over ``steps`` warm train steps on one fixed batch."""
    set_modes(cfg)
    model = make_model(cfg, DEVICE)
    trainer = make_trainer(cfg, model, torch.device(DEVICE),
                           osp.join(tmp, "prof_" + cfg["dataset"]))
    it0 = first_it_all_terms(cfg, batch[0].shape[0])
    profile_steps(
        f"{cfg['dataset']} train steps (items x frames x points "
        f"{'x'.join(map(str, batch[0].shape[:3]))})",
        lambda i: trainer.train_it(it0 + i, batch, aug_transform=True),
        steps)


def run_eval(tmp, cfg, cfg_path, approx=False):
    """test_seg on the 100 val ids with the train phase's checkpoint of
    ``cfg``; with ``approx`` under --approx_knn.  Then the trained model's
    masks on the card against the CPU's: within MASK_TOL in float32; in
    bf16, where cuBLAS and the CPU round bf16 products at other places, the
    mean absolute difference within BF16_MASK_TOL and the argmax agreeing at
    BF16_ARGMAX of the points."""
    from ogc_tpu_torch import test_seg
    from ogc_tpu_torch.data.kittisf import KITTISceneFlowDataset
    from ogc_tpu_torch.utils.checkpoint import load_model_state, weight_path

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = test_seg.main([cfg_path, "--split", "val", "--round", "1",
                         "--test_batch_size", str(BATCH), "--device", DEVICE]
                        + (["--approx_knn"] if approx else []))
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_batch = len(res["forward_s"])
    per_batch = FAST_EVAL if approx else EVAL_LAUNCHES
    log(f"eval path {osp.basename(cfg_path)}{' --approx_knn' * approx}: "
        f"{n_batch} forward batches of B={BATCH} x {N_POINT}; launches "
        f"{launches}, per batch derived {per_batch}")
    if n_batch != 25 or launches != {k: n_batch * v
                                     for k, v in per_batch.items()}:
        raise AssertionError(f"expected 25 batches with {per_batch} each, "
                             f"got {n_batch} and {launches}")
    for k in ("AP", "PQ", "F1", "per_scan_iou_avg", "per_scan_ri_avg"):
        if not math.isfinite(res[k]):
            raise AssertionError(f"metric {k} is {res[k]}")
    fwd = np.array(res["forward_s"][1:]) * 1e3
    log(f"AP@50 {res['AP']} PQ@50 {res['PQ']} F1 {res['F1']} "
        f"mIoU {res['per_scan_iou_avg']} RI {res['per_scan_ri_avg']}")
    q1, med, q3 = np.percentile(fwd, [25, 50, 75])
    log(f"forward (host clock, incl. copy to host; first batch excluded, "
        f"{fwd.size} samples): median {med:.4f} ms, quartiles {q1:.4f} / "
        f"{q3:.4f} ms, min {fwd.min():.4f} ms, max {fwd.max():.4f} ms per "
        f"batch of {BATCH}; "
        f"{BATCH * 1e3 / med:.4f} frames/s; first batch "
        f"{res['forward_s'][0] * 1e3:.4f} ms; whole eval incl. loading and "
        f"metrics {wall:.4f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # The trained model on the CPU (plain versions) as the reference.
    model = make_model(cfg, "cpu")
    model.load_state_dict(load_model_state(weight_path(cfg["save_path"], 1)))
    ds = KITTISceneFlowDataset(
        data_root=cfg["data"]["root"],
        mapping_path="data_prepare/kittisf/splits/val.txt", downsampled=True,
        view_sels=[[0, 1], [1, 0]], decentralize=cfg["data"]["decentralize"])
    pcs = torch.from_numpy(np.stack([ds[i][0][0] for i in range(BATCH)]))
    pc = pcs[:2]
    model.eval()
    with torch.no_grad():
        ref = model(pc, pc)
        got = model.to(DEVICE)(pc.to(DEVICE), pc.to(DEVICE)).cpu()
        # Where the time of one eval forward (B=8) goes on the device.
        pcs = pcs.to(DEVICE)
        profile_steps(f"eval forwards of {osp.basename(cfg_path)} (B={BATCH}"
                      f" x {N_POINT})", lambda i: model(pcs, pcs))
    if got.shape != (2, N_POINT, cfg["segnet"]["n_slot"]) \
            or not torch.isfinite(got).all():
        raise AssertionError(f"bad mask {tuple(got.shape)}")
    diff = (got - ref).abs().max().item()
    mean = (got - ref).abs().mean().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    bf16 = cfg.get("compute_dtype") == "bf16"
    log(f"card vs CPU reference, 2 frames x {N_POINT}: max abs mask diff "
        f"{diff:.3e}, mean {mean:.3e}, argmax agreement {agree:.6f} "
        f"(tolerance: " + (f"mean {BF16_MASK_TOL}, argmax {BF16_ARGMAX})"
                           if bf16 else f"max {MASK_TOL})"))
    if not (mean <= BF16_MASK_TOL and agree >= BF16_ARGMAX if bf16
            else diff <= MASK_TOL):
        raise AssertionError(f"card and CPU masks differ: max {diff}, mean "
                             f"{mean}, argmax {agree}")


def run_stage(name, fn, argv, per_unit, units_of):
    """Run one CLI's ``main(argv)`` with the counts set to 0 just before and
    read just after; ``units_of(result)`` gives its (steps, batches, ...)
    and ``per_unit`` the derived launches of each unit.  Raises when the
    counts differ from the derived ones."""
    reset_counts()
    t0 = time.perf_counter()
    res = fn(argv)
    wall = time.perf_counter() - t0
    launches = read_counts()
    units = units_of(res)
    want = {k: sum(n * per[k] for n, per in zip(units, per_unit))
            for k in KERNELS}
    log(f"{name}: {wall:.4f} s; units {units}; launches {launches}")
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, derived {want}")
    return res, launches


def check_finite(name, values):
    bad = {k: v for k, v in values.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"{name}: not finite {bad}")


def setup_sapien(tmp):
    """The protocol's synthetic SAPIEN root (ogc_tpu_torch/tools/synth.py:
    120 scenes for train/val, 24 for test; round-1 flow predictions equal
    to the true flows) and its two configs, cut to 1 epoch; the full config
    phases in the augmented views and the invariance loss from epoch 1."""
    import types

    import yaml

    from ogc_tpu_torch.tools import protocol_sapien as proto

    args = types.SimpleNamespace(seed=SEED, mode="parity",
                                 n_scenes=SAP_SCENES,
                                 n_test_scenes=SAP_TEST_SCENES,
                                 ref_scenes=2000, epochs=1)
    root = osp.join(tmp, "MBS_SAPIEN")
    t0 = time.perf_counter()
    proto.write_data(args, root)
    cfgs, paths = {}, {}
    for name in ("woinv", "full"):
        cfgs[name], _ = proto.build_cfg(args, root, osp.join(tmp, "ckpt"),
                                        name == "woinv")
        paths[name] = osp.join(tmp, f"sapien_{name}.yaml")
    cfgs["full"]["aug_transform_epoch"] = 0
    for name in cfgs:
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfgs[name], f)
    log(f"SAPIEN setup: {SAP_SCENES} + {SAP_TEST_SCENES} scenes x {SAP_N} "
        f"points and round-1 flows in {time.perf_counter() - t0:.3f} s")
    return cfgs, paths


def sapien_split_sizes(cfg):
    with open(osp.join(cfg["data"]["root"], "mbs-shapepart",
                       "meta.json")) as f:
        meta = json.load(f)
    with open(osp.join(cfg["data"]["root"], "mbs-sapien", "meta.json")) as f:
        test = json.load(f)["test"]
    return len(meta["train"]), len(meta["val"]), len(test)


def run_sapien(tmp):
    """The SAPIEN round alternation through the port's CLIs: train_seg
    woinv R1 -> oa_icp train/val R1 --save -> train_seg full R2 -> test_seg
    R2 -> vote R2 --use_gt_flow; each stage's launches against the derived
    counts.  Returns the configs and the launches of the whole path."""
    from ogc_tpu_torch import oa_icp, test_seg, train_seg, vote

    cfgs, paths = setup_sapien(tmp)
    set_modes(cfgs["woinv"], True)
    n_train, n_val, n_test = sapien_split_sizes(cfgs["woinv"])
    n_val_batch = -(-n_val * 3 // SAP_B)
    total = launch_counts()

    def add(launches):
        for k in KERNELS:
            total[k] += launches[k]

    for rnd, name, per_step in ((1, "woinv", SAP_WOINV_STEP),
                                (2, "full", SAP_FULL_STEP)):
        torch.cuda.reset_peak_memory_stats()
        res, launches = run_stage(
            f"train_seg {name} R{rnd}", train_seg.main,
            [paths[name], "--round", str(rnd), "--device", DEVICE],
            (per_step, SAP_VAL),
            lambda r: (len(r["trainer"].step_seconds), n_val_batch))
        add(launches)
        trainer = res["trainer"]
        steps = len(trainer.step_seconds)
        if steps != n_train * 3 // SAP_B:
            raise AssertionError(f"{steps} steps, want {n_train * 3 // SAP_B}")
        with open(osp.join(trainer.exp_base, "log", "scalars.jsonl")) as f:
            scalars = [json.loads(line) for line in f]
        terms = {f"{s['tag']}@{s['step']}": s["value"] for s in scalars}
        check_finite(f"train_seg {name}", terms)
        ms = np.array(trainer.step_seconds) * 1e3
        med = float(np.median(ms[1:]))
        frames = 2 if name == "woinv" else 4
        log(f"SAPIEN {name} step (B={SAP_B} x {frames} frames x {SAP_N}, "
            f"host clock around a synchronised step, steps 2-{steps}): "
            f"median {med:.4f} ms, min {ms[1:].min():.4f}, max "
            f"{ms[1:].max():.4f}; {SAP_B * frames * 1e3 / med:.4f} "
            f"clouds/s; first step {ms[0]:.4f} ms; val epoch "
            f"{trainer.val_seconds[0] * 1e3:.4f} ms; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        if rnd == 2:
            break
        for split, n_scene in (("train", n_train), ("val", n_val)):
            res, launches = run_stage(
                f"oa_icp {split} R1", oa_icp.main,
                [paths["woinv"], "--split", split, "--round", "1", "--save",
                 "--test_batch_size", str(SAP_ICP_BATCH), "--device",
                 DEVICE],
                (SAP_ICP,), lambda r: (-(-n_scene * 6 // SAP_ICP_BATCH),))
            add(launches)
            for report in res.values():
                check_finite(f"oa_icp {split}", report)
            log(f"oa_icp {split}: {res}")
    res, launches = run_stage(
        "test_seg R2", test_seg.main,
        [paths["full"], "--split", "test", "--round", "2", "--device",
         DEVICE], (SAP_FWD,), lambda r: (len(r["forward_s"]),))
    add(launches)
    metrics = {k: res[k] for k in ("AP", "PQ", "F1", "per_scan_iou_avg",
                                   "per_scan_ri_avg")}
    check_finite("test_seg", metrics)
    log(f"test_seg R2: {metrics}")
    res, launches = run_stage(
        "vote R2", vote.main,
        [paths["full"], "--split", "test", "--round", "2", "--use_gt_flow",
         "--test_batch_size", str(SAP_VOTE_BATCH), "--device", DEVICE],
        (SAP_FWD,), lambda r: (-(-n_test * 4 // SAP_VOTE_BATCH),))
    add(launches)
    check_finite("vote", res)
    log(f"vote R2: {res}")
    path = (SAP_WOINV_STEP, SAP_FULL_STEP, SAP_VAL, SAP_FWD, SAP_ICP)
    missing = [k for k in KERNELS
               if total[k] == 0 and any(per[k] for per in path)]
    if missing:
        raise AssertionError(f"SAPIEN path launched no {missing}")
    log(f"SAPIEN round alternation launches {total}")
    return cfgs, total


def check_refine_card_vs_cpu(cfgs):
    """OA-ICP (round 1's model, 12 train pairs, 20 iterations) and voting
    (round 2's model, 3 test scenes x 4 frames, true flows) on the card and
    on the CPU from the same weights and inputs.

    Tolerances, absolute on unit-scale scenes: REFINE_TOL for the Kabsch
    and OA-ICP flows (the masks of the two devices differ by ~1e-6, and
    every iteration ends in a Kabsch fit that averages over the object).
    VOTE_TOL for the voted masks, with their argmax agreeing at VOTE_ARGMAX
    of the points: voting warps by softmax(-d / 0.01) with d the sqrt of the
    reference's expanded |a|^2 - 2ab + |b|^2, and under the true flow a
    warped point lands on its target, where d2 ~ 0.  There the float32
    GEMM's rounding (~1e-7 at unit scale, cuBLAS and the CPU rounding
    differently) becomes a d of ~3e-4 after the sqrt, a logit shift of ~0.03
    and a weight change of ~3%, diluted by the window's other votes.  The
    witness: the same voting in float64 on the CPU, where that rounding is
    ~1e-16, from each device's masks.  Each device's float32 result lies
    within VOTE_F64_TOL of the float64 one from its own masks (so VOTE_TOL
    is twice that), and the two float64 results, which differ only by the
    masks, within VOTE_MASK_TOL."""
    from ogc_tpu_torch.data.sapien import SapienDataset
    from ogc_tpu_torch.refine.oa_icp import object_aware_icp, weighted_kabsch
    from ogc_tpu_torch.refine.vote import mask_voting_batch
    from ogc_tpu_torch.utils.checkpoint import load_model_state, weight_path

    root = cfgs["woinv"]["data"]["root"]
    icp_set = SapienDataset(osp.join(root, "mbs-shapepart"), split="train",
                            view_sels=[[0, 1], [1, 0], [1, 2], [2, 1],
                                       [2, 3], [3, 2]],
                            predflow_path="flowstep3d")
    items = [icp_set[i] for i in range(12)]
    pcs = np.stack([it[0] for it in items])
    flow = np.stack([it[2][0] for it in items])
    vote_set = SapienDataset(osp.join(root, "mbs-sapien"), split="test",
                             view_sels=[[0, 1], [1, 2], [2, 3], [3, 2]])
    items = [vote_set[i] for i in range(12)]
    vpc = np.stack([it[0][0] for it in items])
    vflows = np.stack([it[2] for it in items])
    out = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        res = {}
        with torch.no_grad():
            model = make_model(cfgs["woinv"], dev).eval()
            model.load_state_dict(load_model_state(weight_path(
                cfgs["woinv"]["save_path"], 1)))
            pc1, pc2, f = (torch.from_numpy(a).to(dev)
                           for a in (pcs[:, 0], pcs[:, 1], flow))
            m1, m2 = model(pc1, pc1), model(pc2, pc2)
            res["kabsch"] = weighted_kabsch(pc1, f, m1).cpu()
            res["oa_icp"] = object_aware_icp(pc1, pc2, f, m1, m2,
                                             icp_iter=20).cpu()
            model.load_state_dict(load_model_state(weight_path(
                cfgs["full"]["save_path"], 2)))
            pc = torch.from_numpy(vpc).to(dev)
            mask = model(pc, pc)
            fl = torch.from_numpy(vflows).to(dev).reshape(3, 4, 2, SAP_N, 3)
            vote_in = (pc.reshape(3, 4, SAP_N, 3),
                       mask.reshape(3, 4, SAP_N, -1), fl[:, :3])
            res["voted"] = mask_voting_batch(*vote_in).cpu()
            voted64 = mask_voting_batch(*(a.cpu().double() for a in vote_in))
        out[dev] = res
        out[dev + "/f64"] = voted64
        log(f"refine card-vs-CPU inputs on {dev}: "
            f"{time.perf_counter() - t0:.3f} s")
    tol = {"kabsch": REFINE_TOL, "oa_icp": REFINE_TOL, "voted": VOTE_TOL}
    diffs = {}
    for k in out["cpu"]:
        a, b = out[DEVICE][k], out["cpu"][k]
        if not torch.isfinite(a).all():
            raise AssertionError(f"{k}: card output not finite")
        diffs[k] = (a - b).abs().max().item()
        log(f"card vs CPU {k} {tuple(a.shape)}: max abs diff "
            f"{diffs[k]:.3e} (tolerance {tol[k]})")
    for label, a, b, t in (
            ("card float32 vs float64", out[DEVICE]["voted"],
             out[DEVICE + "/f64"], VOTE_F64_TOL),
            ("CPU float32 vs float64", out["cpu"]["voted"],
             out["cpu/f64"], VOTE_F64_TOL),
            ("float64 from card masks vs from CPU masks",
             out[DEVICE + "/f64"], out["cpu/f64"], VOTE_MASK_TOL)):
        diffs[label] = (a.double() - b).abs().max().item()
        log(f"voted {label}: max abs diff {diffs[label]:.3e} "
            f"(tolerance {t})")
        tol[label] = t
    for k, diff in diffs.items():
        if not diff <= tol[k]:
            raise AssertionError(f"{k}: differs by {diff}")
    agree = (out[DEVICE]["voted"].argmax(-1) == out["cpu"]["voted"].argmax(-1)
             ).float().mean().item()
    log(f"card vs CPU voted argmax agreement {agree:.6f} (at least "
        f"{VOTE_ARGMAX})")
    if agree < VOTE_ARGMAX:
        raise AssertionError(f"voted argmax agreement {agree}")


def run_kitti_oaicp(cfg_path):
    """OA-ICP on the KITTI-SF val ids with the checkpoint of the train
    phase: the blockwise (N = 8192 > tile) streaming path."""
    from ogc_tpu_torch import oa_icp

    with open("data_prepare/kittisf/splits/val.txt") as f:
        n_items = 2 * len(f.read().split())
    res, _ = run_stage(
        "KITTI-SF oa_icp val R1", oa_icp.main,
        [cfg_path, "--split", "val", "--round", "1", "--test_batch_size",
         str(KITTI_ICP_BATCH), "--device", DEVICE],
        (KITTI_ICP_LAUNCHES,), lambda r: (-(-n_items // KITTI_ICP_BATCH),))
    for report in res.values():
        check_finite("KITTI-SF oa_icp", report)
    log(f"KITTI-SF oa_icp val: {res}")


def make_flownet(kw, device, seed=SEED):
    """FlowStep3D with random weights from ``seed``: torch's default conv
    and linear init, BatchNorm affines and running statistics drawn away
    from the identity, so the eval fold's affines are not trivial."""
    from ogc_tpu_torch.models.flownet import FlowStep3D
    from ogc_tpu_torch.nn.flowstep3d import SchedulableBatchNorm

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = FlowStep3D(**kw)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, SchedulableBatchNorm):
                    m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape))
                    m.bias.copy_(0.1 * torch.randn(m.bias.shape))
                    m.running_mean.copy_(0.1 * torch.randn(m.weight.shape))
                    m.running_var.copy_(
                        1 + 0.2 * torch.randn(m.weight.shape).abs())
    return model.to(device).eval()


def flow_scenes(b, seed):
    """``b`` synthetic KITTI-SF scene pairs (kitti_scene): pc2 is pc1 moved
    by its flow, its points in another order.  :return: (pc1, pc2) float32
    (b, N_POINT, 3) on the card."""
    rng = np.random.RandomState(seed)
    pc1, pc2 = [], []
    for _ in range(b):
        p, f, _ = kitti_scene(rng)
        pc1.append(p)
        pc2.append((p + f)[rng.permutation(N_POINT)])
    return (torch.from_numpy(np.stack(pc1)).to(DEVICE),
            torch.from_numpy(np.stack(pc2)).to(DEVICE))


def set_flow_gates(setting):
    """The gates as the port reads them: "off" is the JAX package's
    defaults (OGC_PALLAS_POOL=off, OGC_PALLAS_EXACT_PRUNE=on), "pool" turns
    the pool kernel on, "on" also routes exact KNN to #4 (=knn)."""
    from ogc_tpu_torch import ops

    ops.set_pool_mode("off" if setting == "off" else "on")
    ops.set_exact_prune("knn" if setting == "on" else "on")


def flow_forward(model, pc1, pc2, iters):
    with torch.no_grad():
        return model(pc1, pc2, pc1, pc2, iters)


def run_flow():
    """The KITTI-SF flow forward (B=8 x 8192, 5 iterations), exact with the
    gates off, the pool gate alone and both gates on, then approximate with
    the gates off and on: launches against the derived counts, flows finite
    and bit-equal between the settings (every #12 pool is the plain chain's
    max of the same float32 values, #4 is #2's answer).  Then the A/B of the
    forward's median time (the settings in turns), peak memory, a profile
    of 3 forwards per gate setting at its ends, and the card against the
    CPU at B=1.  Returns the launches of the gates-on forwards."""
    from ogc_tpu_torch import ops

    model = make_flownet(FLOW_KW, DEVICE)
    pc1, pc2 = flow_scenes(FLOW_B, SEED)
    n_pool = pool_launches(flow_pool_sites(
        "kitti", N_POINT, FLOW_B, FLOW_ITERS, FLOW_KW["loc_flow_nn"]))
    total = launch_counts()
    for mode, exact in (("exact", True), ("approx", False)):
        ops.set_exact_neighbors(exact)
        settings = ("off", "pool", "on") if exact else ("off", "on")
        flows = {}
        for setting in settings:
            set_flow_gates(setting)
            want = dict(FLOW_EXACT if exact else FLOW_APPROX)
            if setting != "off":
                want["pool"] = n_pool
            if setting == "on" and exact:
                want["knn_exact_pruned"] = FLOW_PRUNED
                want["pruned_sort"] = want["pruned_select"] = FLOW_PRUNED
                want["knn_blockmin"] += FLOW_PRUNED
                want["knn_exact"] -= FLOW_PRUNED
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            flows[setting] = flow_forward(model, pc1, pc2, FLOW_ITERS)
            torch.cuda.synchronize()
            first = (time.perf_counter() - t0) * 1e3
            launches = read_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            log(f"flow forward {mode}, gates {setting}: first call "
                f"{first:.4f} ms, peak device memory {peak:.1f} MiB; "
                f"launches {launches}")
            if launches != want:
                raise AssertionError(f"flow {mode} gates {setting}: launches "
                                     f"{launches}, derived {want}")
            if setting == "on":
                for k in KERNELS:
                    total[k] += launches[k]
            check_finite(f"flow {mode}", {
                f"iteration {i}": f.abs().max().item()
                for i, f in enumerate(flows[setting])})
        for setting in settings[1:]:
            gaps = [(a - b).abs().max().item()
                    for a, b in zip(flows["off"], flows[setting])]
            log(f"flow {mode}: gates off vs {setting}, max abs gap per "
                f"iteration {gaps}")
            if any(gaps):
                raise AssertionError(f"flow {mode}: gates {setting} and off "
                                     f"differ")
        log(f"flow {mode}: |flow| max per iteration "
            f"{[f.abs().max().item() for f in flows['off']]}")
        times = {setting: [] for setting in settings}
        for r in range(FLOW_REPS):
            turn = settings if r % 2 == 0 else settings[::-1]
            for setting in turn:
                set_flow_gates(setting)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                flow_forward(model, pc1, pc2, FLOW_ITERS)
                torch.cuda.synchronize()
                times[setting].append((time.perf_counter() - t0) * 1e3)
        for setting in settings:
            med = float(np.median(times[setting]))
            log(f"flow forward {mode} gates {setting} (B={FLOW_B} x "
                f"{N_POINT}, {FLOW_ITERS} iterations, host clock around a "
                f"synchronised forward, {FLOW_REPS} calls in turns): median "
                f"{med:.4f} ms, min {min(times[setting]):.4f}, max "
                f"{max(times[setting]):.4f}; {FLOW_B * 1e3 / med:.4f} scene "
                f"pairs/s")
        for setting in (("off", "on") if exact else ("on",)):
            set_flow_gates(setting)
            profile_steps(f"flow forwards {mode} gates {setting} (B={FLOW_B} "
                          f"x {N_POINT}, {FLOW_ITERS} iterations)",
                          lambda i: flow_forward(model, pc1, pc2, FLOW_ITERS))
    set_flow_gates("off")
    check_flow_card_vs_cpu(model)
    return total


def check_flow_card_vs_cpu(model):
    """One scene pair (B=1 x 8192), exact, 2 iterations: the card with both
    gates on (kernels #1, #2, #3, #4, #12) against the CPU (plain versions),
    within FLOW_TOL of the flow's scale per iteration."""
    import copy

    from ogc_tpu_torch import ops

    ops.set_exact_neighbors(True)
    pc1, pc2 = flow_scenes(1, SEED + 1)
    set_flow_gates("on")
    card = flow_forward(model, pc1, pc2, FLOW_CPU_ITERS)
    set_flow_gates("off")
    t0 = time.perf_counter()
    cpu = flow_forward(copy.deepcopy(model).cpu(), pc1.cpu(), pc2.cpu(),
                       FLOW_CPU_ITERS)
    log(f"flow card-vs-CPU reference forward on the CPU: "
        f"{time.perf_counter() - t0:.3f} s")
    for it, (a, b) in enumerate(zip(card, cpu)):
        scale = max(1.0, b.abs().max().item())
        diff = (a.cpu() - b).abs().max().item()
        log(f"flow card vs CPU iteration {it} (1 x {N_POINT}): max abs diff "
            f"{diff:.3e}, flow scale {scale:.4f} (tolerance "
            f"{FLOW_TOL} x scale)")
        if not diff <= FLOW_TOL * scale:
            raise AssertionError(f"flow iteration {it}: card and CPU differ "
                                 f"by {diff}")


def run_test_flow(tmp):
    """test_flow on the synthetic SAPIEN root (ogc_tpu_torch/tools/synth.py
    through protocol_sapien.write_data; its 23 test scenes x 6 view pairs),
    B=48, 4 iterations, --save, the pool gate on, with random seeded
    weights: launches per batch against the derived ones, finite metrics;
    then the saved flows, read back through SapienDataset(predflow_path=
    "flowstep3d"), against the same forward on the first batch."""
    import types

    import yaml

    from ogc_tpu_torch import ops, test_flow
    from ogc_tpu_torch.data.sapien import SapienDataset
    from ogc_tpu_torch.tools import protocol_sapien as proto
    from ogc_tpu_torch.utils.checkpoint import (load_model_state,
                                                save_model_state)

    root = osp.join(tmp, "FLOW_SAPIEN")
    proto.write_data(types.SimpleNamespace(
        seed=SEED, n_scenes=SAP_SCENES, n_test_scenes=SAP_TEST_SCENES), root)
    with open("config/flow/sapien/sapien_unsup.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["data"]["root"] = root
    cfg["save_path"] = osp.join(tmp, "ckpt", "flow_sapien")
    cfg_path = osp.join(tmp, "flow_sapien.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    kw = dict(npoint=SAP_N, arch="sapien",
              loc_flow_nn=cfg["flownet"]["loc_flow_nn"],
              loc_flow_rad=cfg["flownet"]["loc_flow_rad"], k_decay_fact=0.5)
    save_model_state(make_flownet(kw, "cpu").state_dict(),
                     osp.join(cfg["save_path"], "best"))
    per_batch = dict(SAP_FLOW, pool=pool_launches(flow_pool_sites(
        "sapien", SAP_N, SAP_FLOW_B, SAP_FLOW_ITERS, kw["loc_flow_nn"])))
    ops.set_pool_mode("on")
    t0 = time.perf_counter()
    res, launches = run_stage(
        "test_flow SAPIEN", test_flow.main,
        [cfg_path, "--split", "test", "--test_batch_size", str(SAP_FLOW_B),
         "--test_model_iters", str(SAP_FLOW_ITERS), "--save", "--device",
         DEVICE], (per_batch,), lambda r: (len(r["forward_s"]),))
    wall = time.perf_counter() - t0
    metrics = {k: res[k] for k in ("EPE", "AccS", "AccR", "Outlier")}
    check_finite("test_flow", metrics)
    fwd = np.array(res["forward_s"]) * 1e3
    ds = SapienDataset(osp.join(root, "mbs-sapien"), split="test",
                       view_sels=test_flow.VIEW_SELS,
                       predflow_path="flowstep3d")
    log(f"test_flow SAPIEN: {metrics}; {len(ds)} pairs in {fwd.size} "
        f"batches of <= {SAP_FLOW_B}, wall {wall:.4f} s incl. loading, "
        f"metrics and saving ({len(ds) / wall:.4f} pairs/s); forward per "
        f"batch (host clock, incl. copy to host) first {fwd[0]:.4f} ms, "
        f"median of the rest {np.median(fwd[1:]):.4f} ms")
    model = make_flownet(kw, DEVICE)
    model.load_state_dict(load_model_state(osp.join(cfg["save_path"],
                                                    "best")))
    items = [ds[i] for i in range(min(SAP_FLOW_B, len(ds)))]
    pcs = torch.from_numpy(np.stack([it[0] for it in items])).to(DEVICE)
    saved = torch.from_numpy(np.stack([it[2][0] for it in items]))
    again = flow_forward(model, pcs[:, 0], pcs[:, 1], SAP_FLOW_ITERS)[-1]
    ops.set_pool_mode("off")
    diff = (again.cpu() - saved).abs().max().item()
    log(f"test_flow saved flows (read back through SapienDataset) vs the "
        f"same forward on the first batch: max abs diff {diff:.3e} "
        f"(expected 0)")
    if diff != 0:
        raise AssertionError(f"saved flows differ from the forward by {diff}")
    return launches


# Flow training (a main path of its own).  Derived launches of one SAPIEN
# train step (B=32 x 512, 4 iterations, approximate mode as train_flow
# runs by default; every search is below #3's 1024-point gate):
#   fps 2          enc_loc SA1 of pc1 and pc2 (SA2 and enc_glob nest; the
#                  refinement reuses frame 1's indices);
#   knn_exact 34   FT_KNN;
#   ball_query 4   the smooth ball, once per iteration;
#   gather_onehot 20, scatter_onehot 12, scatter_add 40  FT_GROUPS.
# A val batch (eval: both clouds in one 2B batch, the source-projected
# groups, frozen self-KNN tables): fps 1; knn_exact 24 (the encoders 4,
# the correlation 3, the 1/4-cloud table and the stencil, the FlowEmbedding
# per refinement, 3 a loss iteration); the ball 4; #7 12 (the upsample
# once plus once per refinement, the two smooth groups per iteration).
SAP_FT_STEP = launch_counts(fps=2, knn_exact=34, ball_query=4,
                            gather_onehot=20, scatter_onehot=12,
                            scatter_add=40)
SAP_FT_VAL = launch_counts(fps=1, knn_exact=24, ball_query=4,
                           gather_onehot=12)
# OGC-DR (B=16 x 2048, 4 iterations, approximate): #3 where the searched
# cloud has 2048 or 1024 points (FT_BLOCKMIN: 22, and the smooth ball 4);
# #2 at the 512-point levels (enc_glob 4, correlation 3, the 1/4-cloud
# table, the stencil, the FlowEmbedding 3); #7 / #8 where the source has at
# most 1024 points: the upsample (4, from 512 points), the correlation's SA
# (C 6 over 256 points x 8) and flow_conv1 (3, forward only); #11 for every
# other group with a gradient (11 before the refinement, 8 per refinement,
# the Chamfer and both smooth groups per iteration over 2048 points).  A
# val batch's source-projected groups add #7 at flow_conv2 (C 16, 512
# points x 4, once per refinement).
DR_FT_STEP = launch_counts(fps=2, knn_exact=12, knn_blockmin=22,
                           ball_blockmin=4, gather_onehot=8, scatter_onehot=5,
                           scatter_add=47)
DR_FT_VAL = launch_counts(fps=1, knn_exact=10, knn_blockmin=14,
                          ball_blockmin=4, gather_onehot=7)
# Supervised (sapien_sup.yaml: B=128 x 512, 8 slots, 2 layers; frame 0,
# approximate): SA0's FPS, its KNN and two #7 groups, SA1's and the two FP
# searches, #11 at SA1 and the FP groups.
SUP_STEP = launch_counts(fps=1, knn_exact=4, gather_onehot=2, scatter_add=3)
SUP_VAL = launch_counts(fps=1, knn_exact=4, gather_onehot=2)
SUP_B, SUP_EPOCHS = 128, 2
# The chained pipeline's synthetic SAPIEN root (tools/synth.py; no flow
# predictions until test_flow --save writes them): 60 scenes (48 train,
# 12 val), 24 test scenes; OGC-DR: 8 train and 2 val rooms of 2048 points.
FT_SCENES, FT_TEST_SCENES, DR_SCENES = 60, 24, 10
# Card against CPU for one flow step (B=2 x 512, 2 iterations, exact):
# iteration 0's flows within FLOW_TOL of their scale and its terms within
# LOSS_RTOL; iteration 1's flows within FT_FLOW1_TOL of the scale and the
# sum within FT_SUM_RTOL; the gradient's cosine above FT_COS, the gradient
# through iteration 0 alone above FT_COS0.  Both sides run the port's code
# (kernels bit-equal to their plain versions), so what differs is cuBLAS
# against the CPU's rounding, which train-mode BatchNorm amplifies through
# the refinement: an NVIDIA H100 80GB HBM3 at 700 W read 2.3e-5 of the
# scale at iteration 1 and 4.0e-6 on the sum.  A neighbour list or a statistic gone wrong after
# iteration 0 moves the flows it touches by a share of the flow itself.
FT_CPU_B, FT_CPU_ITERS = 2, 2
FT_FLOW1_TOL, FT_SUM_RTOL, FT_COS, FT_COS0 = 1e-3, 1e-4, 0.999, 0.9999


def write_ogcdr(root, n_scenes, seed):
    """An OGC-DR root (data/<id>/{pc,segm,pose}_%02d.npy, train.lst and
    val.lst): rooms of DR_FT_N points in a unit cube, a static background
    and 3 objects moved by their own SE(3)s in each of 4 views."""
    from ogc_tpu_torch.tools.synth import rand_se3

    rng = np.random.RandomState(seed)
    ids = ["scene%03d" % i for i in range(n_scenes)]
    for sid in ids:
        d = osp.join(root, "data", sid)
        os.makedirs(d)
        base = rng.rand(DR_FT_N, 3).astype(np.float32)
        segm = rng.randint(0, 4, size=DR_FT_N)
        for v in range(4):
            poses = np.stack([np.eye(4) if v == 0 else rand_se3(rng, 10, 0.1)
                              for _ in range(3)])
            pc = base.copy()
            for k in range(3):
                sel = segm == k + 1
                pc[sel] = base[sel] @ poses[k][:3, :3].T + poses[k][:3, 3]
            for name, arr in (("pc", pc.astype(np.float32)), ("segm", segm),
                              ("pose", poses)):
                np.save(osp.join(d, "%s_%02d.npy" % (name, v)), arr)
    for split, part in (("train", ids[:-2]), ("val", ids[-2:])):
        with open(osp.join(root, "data", split + ".lst"), "w") as f:
            f.write("\n".join(part))


def write_cfg(tmp, src, name, **over):
    """A copy of the YAML ``src`` with the top-level keys ``over`` (the
    ``data`` dict merged), written to <tmp>/<name>.yaml."""
    import yaml

    with open(src) as f:
        cfg = yaml.safe_load(f)
    data = over.pop("data", {})
    cfg.update(over)
    cfg["data"] = {**cfg["data"], **data}
    path = osp.join(tmp, name + ".yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg, path


def flow_batch(cfg, n_items, seed=SEED):
    """One augmented batch of the flow config's train set, drawn with a
    fixed seed."""
    import types

    from ogc_tpu_torch.train_flow import build_datasets

    ds = build_datasets(types.SimpleNamespace(**cfg))[0]
    np.random.seed(seed)
    items = [ds[i] for i in range(n_items)]
    return tuple(np.stack(f, 0) for f in zip(*items))


def make_flow_trainer(cfg, device, exp_base, iters=None, bn_sync="local"):
    """train_flow.py's model (seeded weights), Adam and FlowTrainer for
    ``cfg`` on ``device``."""
    from ogc_tpu_torch.losses.flow_unsup import FlowLossConfig
    from ogc_tpu_torch.models.flownet import FlowStep3D
    from ogc_tpu_torch.train.flow import FlowTrainer, make_bn_schedule
    from ogc_tpu_torch.train.seg import Adam, make_lr_schedule

    fn = cfg["flownet"]
    iters = iters or cfg["model_iters"]
    model = FlowStep3D(
        npoint=fn["npoint"], arch=cfg["dataset"],
        loc_flow_nn=fn["loc_flow_nn"], loc_flow_rad=fn["loc_flow_rad"],
        k_decay_fact=fn["k_decay_fact"],
        generator=torch.Generator().manual_seed(SEED)).to(device)
    loss = dict(cfg["loss"], iters_w=cfg["loss"]["iters_w"][:iters])
    opt = Adam(dict(model.named_parameters()),
               make_lr_schedule(cfg["lr"], cfg["lr_decay"], cfg["lr_clip"],
                                cfg["decay_step"], cfg["batch_size"]))
    return FlowTrainer(model, iters, FlowLossConfig.from_dict(loss), opt,
                       exp_base=exp_base, device=torch.device(device),
                       bn_schedule=make_bn_schedule(
                           cfg["bn_momentum"], cfg["bn_decay"],
                           cfg["decay_step"], cfg["batch_size"]),
                       bn_sync=bn_sync)


def log_steps(what, trainer, clouds, wall):
    """Median step time after the first (host clock around a synchronised
    step), clouds/s, the val epochs and peak device memory."""
    ms = np.array(trainer.step_seconds) * 1e3
    med = float(np.median(ms[1:]))
    log(f"{what}: {ms.size} steps, median {med:.4f} ms after the first "
        f"(min {ms[1:].min():.4f}, max {ms[1:].max():.4f}), "
        f"{clouds * 1e3 / med:.4f} clouds/s; first step {ms[0]:.4f} ms; val "
        f"epochs {[round(v * 1e3, 4) for v in trainer.val_seconds]} ms; "
        f"wall {wall:.4f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return med


def check_scalars(name, exp_base):
    with open(osp.join(exp_base, "log", "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    check_finite(name, {f"{d['tag']}@{d['step']}": d["value"]
                        for d in scalars})
    return {d["tag"]: d["value"] for d in scalars}


def check_flow_determinism(cfg, tmp, batch, steps=3):
    """Two seeded runs of ``steps`` train steps on one batch: bit-equal
    weights and BatchNorm statistics."""
    states = []
    for run in range(2):
        trainer = make_flow_trainer(cfg, DEVICE, osp.join(tmp, f"fdet{run}"))
        for it in range(steps):
            trainer.train_it(it, batch)
        states.append({k: v.detach().clone()
                       for k, v in trainer.model.state_dict().items()})
    diff = [k for k in states[0] if not torch.equal(states[0][k],
                                                    states[1][k])]
    if diff:
        raise AssertionError(f"two seeded {steps}-step flow runs differ in "
                             f"{diff[:5]}")
    log(f"flow determinism: two seeded {steps}-step runs give bit-equal "
        f"weights and statistics ({len(states[0])} tensors)")


def check_flow_card_vs_cpu_step(cfg, tmp, batch):
    """One flow train step's forward and backward (FT_CPU_B x 512,
    FT_CPU_ITERS iterations, exact) on the card and on the CPU."""
    from ogc_tpu_torch import ops
    from ogc_tpu_torch.losses.flow_unsup import flowstep3d_loss
    from ogc_tpu_torch.nn.flowstep3d import set_bn_momentum

    ops.set_exact_neighbors(True)
    out = {}
    for dev in (DEVICE, "cpu"):
        trainer = make_flow_trainer(cfg, dev, osp.join(tmp, f"fcpu_{dev}"),
                                    FT_CPU_ITERS)
        m = trainer.model.train()
        set_bn_momentum(m, trainer.bn_schedule(0))
        pc1, pc2, _ = trainer._inputs(batch)
        flows = m(pc1, pc2, pc1, pc2, FT_CPU_ITERS)
        loss, ld = flowstep3d_loss(pc1, pc2, flows, trainer.loss_cfg)
        params = list(m.parameters())
        cfg_l = trainer.loss_cfg
        it0 = cfg_l.iters_w[0] * (cfg_l.weights[0] * ld["chamfer_loss_#0"]
                                  + cfg_l.weights[1] * ld["smooth_loss_#0"])
        g0 = torch.autograd.grad(it0, params, retain_graph=True,
                                 allow_unused=True)
        g = torch.autograd.grad(loss, params, allow_unused=True)
        # A module that only the refinement runs has no gradient through
        # iteration 0.
        flat = (lambda gs: torch.cat([
            (torch.zeros_like(p) if t is None else t).detach().double()
            .flatten().cpu() for p, t in zip(params, gs)]))
        out[dev] = ([f.detach().cpu() for f in flows],
                    {k: float(v.detach()) for k, v in ld.items()}, flat(g0),
                    flat(g))
    (fc, lc, g0c, gc), (fr, lr, g0r, gr) = out[DEVICE], out["cpu"]
    scale = max(1.0, fr[0].abs().max().item())
    diff0 = (fc[0] - fr[0]).abs().max().item()
    diff1 = (fc[1] - fr[1]).abs().max().item()
    cos = (lambda a, b: float(a @ b / (a.norm() * b.norm())))
    cos0, cos_all = cos(g0c, g0r), cos(gc, gr)
    log(f"flow step card vs CPU ({FT_CPU_B} x {SAP_N}, {FT_CPU_ITERS} "
        f"iterations): iteration 0 max abs diff {diff0:.3e} (tolerance "
        f"{FLOW_TOL} x {scale:.4f}), iteration 1 {diff1:.3e} (tolerance "
        f"{FT_FLOW1_TOL} x {scale:.4f}); sum rel diff "
        f"{abs(lc['sum'] / lr['sum'] - 1):.3e} (tolerance {FT_SUM_RTOL}); "
        f"terms {lc} vs {lr}; gradient cosine {cos_all:.8f} (> {FT_COS}), "
        f"through iteration 0 {cos0:.8f} (> {FT_COS0})")
    bad = [k for k in ("chamfer_loss_#0", "smooth_loss_#0")
           if not math.isclose(lc[k], lr[k], rel_tol=LOSS_RTOL)]
    if (diff0 > FLOW_TOL * scale or bad or diff1 > FT_FLOW1_TOL * scale
            or not math.isclose(lc["sum"], lr["sum"], rel_tol=FT_SUM_RTOL)
            or cos_all <= FT_COS or cos0 <= FT_COS0):
        raise AssertionError(f"flow step: card and CPU disagree ({bad})")


def flow_profile_probe():
    """Not run by main: ``python -c "import chip_smoke;
    chip_smoke.flow_profile_probe()"``.  Which of the two counts of the
    SAPIEN flow-train step is right, the launch counters' or the profile's:
    the counters over one step, then profiles of 1 and of 3 steps, each
    with its kernels per step of #1, #2 and #5, its device-side events per
    step and the guard spins its trace holds."""
    from ogc_tpu_torch.ops import _build
    from ogc_tpu_torch.tools.synth import make_sapien_root_coherent
    from ogc_tpu_torch.train_seg import set_deterministic

    os.chdir(REPO)
    set_deterministic(torch.device("cuda"))
    _build.lib()
    with tempfile.TemporaryDirectory() as tmp:
        root = osp.join(tmp, "PIPE_SAPIEN")
        make_sapien_root_coherent(osp.join(root, "mbs-shapepart"),
                                  n_scenes=FT_SCENES, n_points=SAP_N,
                                  seed=200 + SEED)
        fcfg, _ = write_cfg(tmp, "config/flow/sapien/sapien_unsup.yaml",
                            "probe_flow", data={"root": root})
        batch = flow_batch(fcfg, SAP_FT_B)
        set_modes({}, False)
        trainer = make_flow_trainer(fcfg, DEVICE, osp.join(tmp, "probe"))
        trainer.train_it(0, batch)
        torch.cuda.synchronize()
        reset_counts()
        trainer.train_it(1, batch)
        got = read_counts()
        log(f"counters over one SAPIEN flow-train step: fps {got['fps']}, "
            f"knn_exact {got['knn_exact']}, ball_query {got['ball_query']} "
            f"(derived {SAP_FT_STEP['fps']}, {SAP_FT_STEP['knn_exact']}, "
            f"{SAP_FT_STEP['ball_query']})")
        for steps in (1, 3, 3):
            counts, events = profile_steps(
                "SAPIEN flow-train steps (probe)",
                lambda i: trainer.train_it(i, batch), steps)
            log(f"probe: {steps} step(s): #1 {counts['#1 fps']:g}, #2 "
                f"{counts['#2 knn_exact']:g}, #5 {counts['#5 ball_query']:g} "
                f"kernels a step; {events:g} device-side events a step")


def run_flow_pipeline(tmp):
    """Flow training and the chained SAPIEN pipeline on a root of its own,
    each stage through its CLI's main with the counts set to 0 before it
    and read after it, in the CLI's default neighbour mode: train_flow (1
    epoch; its launches against SAP_FT_STEP / SAP_FT_VAL; step times,
    clouds/s, peak memory, a profile of 3 steps; two seeded 3-step runs
    bit-equal; one step card vs CPU) -> test_flow --save on its ``best``
    (train, val, test) -> train_seg woinv R1 on the saved flows -> oa_icp
    train and val R1 --save -> vote R1 on the test flows.  Returns the
    launches of train_flow."""
    from ogc_tpu_torch import oa_icp, test_flow, train_flow, train_seg, vote
    from ogc_tpu_torch.tools.synth import make_sapien_root_coherent

    root = osp.join(tmp, "PIPE_SAPIEN")
    t0 = time.perf_counter()
    make_sapien_root_coherent(osp.join(root, "mbs-shapepart"),
                              n_scenes=FT_SCENES, n_points=SAP_N,
                              seed=200 + SEED)
    make_sapien_root_coherent(osp.join(root, "mbs-sapien"),
                              n_scenes=FT_TEST_SCENES, n_points=SAP_N,
                              seed=300 + SEED, test_frac=0.99)
    log(f"pipeline setup: {FT_SCENES} + {FT_TEST_SCENES} scenes in "
        f"{time.perf_counter() - t0:.3f} s")
    fcfg, fpath = write_cfg(tmp, "config/flow/sapien/sapien_unsup.yaml",
                            "pipe_flow", epochs=1, data={"root": root},
                            save_path=osp.join(tmp, "ckpt", "pipe_flow"))
    n_train = int(FT_SCENES * 0.8) * 6 // SAP_FT_B
    n_val = -(-(FT_SCENES - int(FT_SCENES * 0.8)) * 6 // SAP_FT_B)
    stages = {}

    def stage(name, fn, argv, per_unit, units_of, exact):
        set_modes({}, exact)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, launches = run_stage(name, fn, argv, per_unit, units_of)
        stages[name] = time.perf_counter() - t0
        return res, launches

    res, ft_launches = stage(
        "train_flow SAPIEN", train_flow.main, [fpath, "--device", DEVICE],
        (SAP_FT_STEP, SAP_FT_VAL),
        lambda r: (len(r["trainer"].step_seconds), n_val), False)
    trainer = res["trainer"]
    if len(trainer.step_seconds) != n_train:
        raise AssertionError(f"{len(trainer.step_seconds)} flow steps, want "
                             f"{n_train}")
    terms = {k: v for k, v in check_scalars(
        "train_flow", fcfg["save_path"]).items() if k.startswith("train/")}
    log(f"train_flow last terms: {terms}; best val loss {res['best_loss']}")
    log_steps(f"SAPIEN flow-train step (B={SAP_FT_B} x {SAP_N}, "
              f"{SAP_FT_ITERS} iterations)", trainer, 2 * SAP_FT_B,
              stages["train_flow SAPIEN"])
    log(f"launches per flow-train step {SAP_FT_STEP}, per val batch "
        f"{SAP_FT_VAL}")
    batch = flow_batch(fcfg, SAP_FT_B)
    set_modes({}, False)
    ptrainer = make_flow_trainer(fcfg, DEVICE, osp.join(tmp, "fprof"))
    profile_steps(f"SAPIEN flow-train steps (B={SAP_FT_B} x {SAP_N}, "
                  f"{SAP_FT_ITERS} iterations)",
                  lambda i: ptrainer.train_it(i, batch),
                  expect={"#1 fps": SAP_FT_STEP["fps"],
                          "#2 knn_exact": SAP_FT_STEP["knn_exact"],
                          "#5 ball_query": SAP_FT_STEP["ball_query"]})
    check_flow_determinism(fcfg, tmp, batch)
    check_flow_card_vs_cpu_step(fcfg, tmp, tuple(a[:FT_CPU_B] for a in batch))

    # test_flow --save on every split, exact (its default), B=48.
    tcfg, tpath = write_cfg(tmp, "config/flow/sapien/sapien_unsup.yaml",
                            "pipe_test_flow", data={"root": root},
                            save_path=fcfg["save_path"])
    for split, n_scene in (("train", int(FT_SCENES * 0.8)),
                           ("val", FT_SCENES - int(FT_SCENES * 0.8)),
                           ("test", FT_TEST_SCENES - 1)):
        res, _ = stage(
            f"test_flow --save {split}", test_flow.main,
            [tpath, "--split", split, "--test_batch_size", str(SAP_FLOW_B),
             "--save", "--device", DEVICE], (SAP_FLOW,),
            lambda r: (len(r["forward_s"]),), True)
        check_finite(f"test_flow {split}",
                     {k: res[k] for k in ("EPE", "AccS", "AccR", "Outlier")})
        log(f"test_flow {split} ({n_scene} scenes x 6 pairs): EPE "
            f"{res['EPE']} AccS {res['AccS']} AccR {res['AccR']} Outlier "
            f"{res['Outlier']}")
    scfg, spath = write_cfg(tmp, "config/seg/sapien/sapien_unsup_woinv.yaml",
                            "pipe_woinv", epochs=1, data={"root": root},
                            save_path=osp.join(tmp, "ckpt", "pipe_woinv"))
    seg_train = int(FT_SCENES * 0.8) * 3 // SAP_B
    seg_val = -(-(FT_SCENES - int(FT_SCENES * 0.8)) * 3 // SAP_B)
    res, _ = stage(
        "train_seg woinv R1", train_seg.main,
        [spath, "--round", "1", "--device", DEVICE],
        (dict(SAP_WOINV_STEP, fps=1), dict(SAP_VAL, fps=1)),
        lambda r: (len(r["trainer"].step_seconds), seg_val), False)
    if len(res["trainer"].step_seconds) != seg_train:
        raise AssertionError("pipeline train_seg: wrong step count")
    check_scalars("pipeline train_seg", res["trainer"].exp_base)
    log(f"train_seg woinv R1 on the predicted flows: best val loss "
        f"{res['best_loss']}")
    for split, n_scene in (("train", int(FT_SCENES * 0.8)),
                           ("val", FT_SCENES - int(FT_SCENES * 0.8))):
        res, _ = stage(
            f"oa_icp {split} R1", oa_icp.main,
            [spath, "--split", split, "--round", "1", "--save",
             "--test_batch_size", str(SAP_ICP_BATCH), "--device", DEVICE],
            (SAP_ICP,), lambda r: (-(-n_scene * 6 // SAP_ICP_BATCH),), True)
        for report in res.values():
            check_finite(f"pipeline oa_icp {split}", report)
        log(f"oa_icp {split} R1: {res}")
    res, _ = stage(
        "vote R1", vote.main,
        [spath, "--split", "test", "--round", "1", "--test_batch_size",
         str(SAP_VOTE_BATCH), "--device", DEVICE], (SAP_FWD,),
        lambda r: (-(-(FT_TEST_SCENES - 1) * 4 // SAP_VOTE_BATCH),), True)
    check_finite("pipeline vote", res)
    log(f"vote R1 on the predicted test flows: {res}")
    log(f"chained pipeline stage wall times (s): {stages}")
    return ft_launches


def run_ogcdr_flow_train(tmp):
    """train_flow on an OGC-DR root (ogcdr_unsup.yaml, B=16 x 2048, 4
    iterations, 3 steps and a val batch, approximate by default): launches
    against DR_FT_STEP / DR_FT_VAL (#3 in training), finite terms, step
    times.  Returns its launches."""
    from ogc_tpu_torch import train_flow

    root = osp.join(tmp, "OGCDR")
    write_ogcdr(root, DR_SCENES, SEED)
    cfg, path = write_cfg(tmp, "config/flow/ogcdr/ogcdr_unsup.yaml",
                          "ogcdr_flow", epochs=1, data={"root": root},
                          save_path=osp.join(tmp, "ckpt", "ogcdr_flow"))
    n_train = (DR_SCENES - 2) * 6 // DR_FT_B
    set_modes(cfg, False)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, launches = run_stage(
        "train_flow OGC-DR", train_flow.main, [path, "--device", DEVICE],
        (DR_FT_STEP, DR_FT_VAL),
        lambda r: (len(r["trainer"].step_seconds), -(-2 * 6 // DR_FT_B)))
    if len(res["trainer"].step_seconds) != n_train:
        raise AssertionError("OGC-DR flow: wrong step count")
    check_scalars("OGC-DR train_flow", cfg["save_path"])
    log_steps(f"OGC-DR flow-train step (B={DR_FT_B} x {DR_FT_N}, "
              f"{cfg['model_iters']} iterations)", res["trainer"],
              2 * DR_FT_B, time.perf_counter() - t0)
    log(f"launches per OGC-DR flow-train step {DR_FT_STEP}, per val batch "
        f"{DR_FT_VAL}")
    return launches


def run_seg_sup(tmp, root):
    """train_seg_sup on sapien_sup.yaml at B=128 x 512 over the SAPIEN
    root ``root`` (SUP_EPOCHS epochs; approximate by default): launches
    against SUP_STEP / SUP_VAL, finite terms, step times, a profile of 3
    steps.  Returns its launches."""
    from ogc_tpu_torch import train_seg_sup

    cfg, path = write_cfg(tmp, "config/seg/sapien/sapien_sup.yaml",
                          "sapien_sup", epochs=SUP_EPOCHS,
                          data={"root": root},
                          save_path=osp.join(tmp, "ckpt", "sapien_sup"))
    n_train, n_val, _ = sapien_split_sizes({"data": {"root": root}})
    set_modes(cfg, False)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, launches = run_stage(
        "train_seg_sup SAPIEN", train_seg_sup.main,
        [path, "--device", DEVICE], (SUP_STEP, SUP_VAL),
        lambda r: (len(r["trainer"].step_seconds),
                   SUP_EPOCHS * -(-n_val * 3 // SUP_B)))
    steps = len(res["trainer"].step_seconds)
    if steps != SUP_EPOCHS * (n_train * 3 // SUP_B):
        raise AssertionError(f"train_seg_sup: {steps} steps")
    terms = {k: v for k, v in check_scalars(
        "train_seg_sup", cfg["save_path"]).items() if k.startswith("train/")}
    log(f"train_seg_sup last terms: {terms}; best val loss "
        f"{res['best_loss']}")
    log_steps(f"supervised step (B={SUP_B} x {SAP_N}, frame 0)",
              res["trainer"], SUP_B, time.perf_counter() - t0)
    log(f"launches per supervised step {SUP_STEP}, per val batch {SUP_VAL}")
    # A profile of 3 steps on one fixed batch, from the CLI's pieces.
    import types

    from ogc_tpu_torch.losses.seg_sup import SupLossConfig
    from ogc_tpu_torch.train.seg import Adam, make_lr_schedule
    from ogc_tpu_torch.train.seg_sup import SupSegTrainer

    ds = train_seg_sup.build_datasets(types.SimpleNamespace(**cfg))[0]
    batch = tuple(np.stack(f, 0) for f in zip(*[ds[i]
                                                 for i in range(SUP_B)]))
    model = make_model(cfg, DEVICE)
    trainer = SupSegTrainer(
        model, SupLossConfig(weights=tuple(cfg["loss"]["weights"])),
        Adam(dict(model.named_parameters()),
             make_lr_schedule(cfg["lr"], cfg["lr_decay"], cfg["lr_clip"],
                              cfg["decay_step"], cfg["batch_size"])),
        ignore_npoint_thresh=0, exp_base=osp.join(tmp, "sup_prof"),
        device=torch.device(DEVICE))
    profile_steps(f"supervised steps (B={SUP_B} x {SAP_N})",
                  lambda i: trainer.train_it(i, batch),
                  expect={"#1 fps": SUP_STEP["fps"],
                          "#2 knn_exact": SUP_STEP["knn_exact"]})
    return launches

# The outdoor phase: the six outdoor CLIs and test_seg's single-frame
# datasets at full width on synthetic roots (ogc_tpu_torch/tools/synth.py),
# random seeded weights.  KITTI-SF full-resolution scenes of these sizes
# (about half of each is ground, removed by height), Waymo frames of
# 30k-60k points in the front field of view, the trainers' 8192-point
# frames.
OUT_KITTI_N = (40000, 70000, 100000, 120000)
OUT_WAYMO_FRAMES, OUT_WAYMO_N = 5, (30000, 60000)
OUT_TRAIN_STEPS, OUT_SUP_STEPS = 3, 2
OUT_SEG_SCENES = 16
# Card against CPU for the batched ICP, as the CPU tests hold the port to
# the JAX package: rotation entries and translation (m) of the transform.
ICP_ROT_TOL, ICP_T_TOL = 2e-5, 5e-4
# Batched (--scene_batch 2) against per-scene flows on the card: the
# network runs at another batch size (other library kernels), and the ICP's
# transforms on other batches; a sanity bound, the gap is printed.
OUT_BATCH_TOL = 0.05


def outdoor_stage(name, fn, argv, need):
    """One outdoor CLI's ``main(argv)`` with the counts set to 0 just
    before and read just after, #1's cluster instance's as
    ``fps_cluster``; raises if a kernel of ``need`` never launched.
    Returns (result, launches, wall seconds)."""
    reset_counts()
    t0 = time.perf_counter()
    res = fn(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    launches["fps_cluster"] = counters()["fps"].cluster_launches
    missing = [k for k in need if not launches[k]]
    log(f"{name}: {wall:.3f} s, launches {launches}")
    if missing:
        raise AssertionError(f"{name} launched no {missing}")
    return res, launches, wall


def split_files(cwd, files):
    """data_prepare/<name> files under ``cwd``: {name: [lines]}."""
    for name, lines in files.items():
        path = osp.join(cwd, "data_prepare", name)
        os.makedirs(osp.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(lines))


def saved_flows(root, name):
    d = osp.join(root, "flow_preds", name)
    out = {osp.relpath(osp.join(p, f), d): np.load(osp.join(p, f))
           for p, _, fs in os.walk(d) for f in fs if f.endswith(".npy")}
    if not out or not all(np.isfinite(v).all() and v.ndim == 2
                          and v.shape[1] == 3 for v in out.values()):
        raise AssertionError(f"bad saved flows under {d}")
    return out


def flow_gap(a, b):
    if sorted(a) != sorted(b):
        raise AssertionError("saved flow files differ")
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def check_icp_gpf(kroot, wroot, seq):
    """The batched ICP on a KITTI-SF scene's FPS-1024 subclouds and the
    batched GPF on padded Waymo frames (valid and FPS fit masks): the card
    against the CPU (plain kernels), ICP within ICP_ROT_TOL / ICP_T_TOL,
    GPF marks equal but for points within 1e-3 m of the threshold."""
    from ogc_tpu_torch.ops.fps import fps
    from ogc_tpu_torch.outdoor import bucket, pad_rows
    from ogc_tpu_torch.utils.gpf import ground_plane_fitting_batched
    from ogc_tpu_torch.utils.icp import icp_batched

    d = osp.join(kroot, "processed", "%06d" % 0)
    pc1, pc2 = (np.load(osp.join(d, f"pc{i}.npy")) for i in (1, 2))
    keep = ~((pc1[:, 1] < -1.4) & (pc2[:, 1] < -1.4))
    c = np.concatenate([pc1[keep], pc2[keep]]).mean(0)
    sub = [torch.from_numpy(p[keep] - c).to(DEVICE)[None] for p in (pc1, pc2)]
    A, B = (x[:, fps(x, 1024)[0].long()].contiguous() for x in sub)
    got = icp_batched(A, B, 50).cpu()
    want = icp_batched(A.cpu(), B.cpu(), 50)
    rot = (got[:, :3, :3] - want[:, :3, :3]).abs().max().item()
    tr = (got[:, :3, 3] - want[:, :3, 3]).abs().max().item()
    log(f"ICP card vs CPU (1024-point subclouds of a {len(pc1)}-point "
        f"scene, 50 iterations): rotation {rot:.3e} (tolerance "
        f"{ICP_ROT_TOL}), translation {tr:.3e} m ({ICP_T_TOL})")
    if rot > ICP_ROT_TOL or tr > ICP_T_TOL:
        raise AssertionError("ICP card and CPU transforms differ")
    frames = [np.load(osp.join(wroot, "data", seq, "pc_%04d.npy" % t))
              for t in range(min(4, OUT_WAYMO_FRAMES))]
    n = bucket(max(len(f) for f in frames))
    P = torch.from_numpy(np.stack([pad_rows(f, n) for f in frames])).to(DEVICE)
    V = torch.zeros(P.shape[:2], dtype=torch.bool, device=DEVICE)
    for i, f in enumerate(frames):
        V[i, :len(f)] = True
    FV = torch.zeros_like(V)
    FV.scatter_(1, fps(P, 2048).long(), True)
    kw = dict(n_iter=5, n_lpr=50, thresh_seed=0.4, thresh_dist=0.4)
    got = ground_plane_fitting_batched(P, V, FV, **kw).cpu()
    want = ground_plane_fitting_batched(P.cpu(), V.cpu(), FV.cpu(), **kw)
    bad = int((got != want).sum())
    log(f"GPF card vs CPU ({len(frames)} Waymo frames padded to {n}): "
        f"{bad} of {int(V.sum())} marks differ; {int(want.sum())} ground")
    if bad > 0.001 * int(V.sum()):
        raise AssertionError("GPF card and CPU marks differ")


def run_outdoor(tmp):
    """The outdoor CLIs at full width (see the module docstring); returns
    {CLI: launches} and the per-scene / per-step times."""
    import types

    import yaml

    from ogc_tpu_torch import (outdoor, test_flow_kittisf,
                               test_flow_kittisf_benchmark, test_flow_waymo,
                               test_seg, test_seg_waymo, train_seg_waymo,
                               train_seg_waymo_sup)
    from ogc_tpu_torch.tools import synth
    from ogc_tpu_torch.utils.checkpoint import save_model_state
    from ogc_tpu_torch.utils.config import load_config_into_args

    base = osp.join(tmp, "outdoor")
    cwd = osp.join(base, "cwd")
    os.makedirs(cwd)
    t_start = time.perf_counter()
    launches, times = {}, {}
    net = make_flownet(FLOW_KW, "cpu")
    flow_ckpt = save_model_state(net.state_dict(),
                                 osp.join(base, "ckpt", "flow", "best"))
    flownet = {k: FLOW_KW[k] for k in ("npoint", "loc_flow_nn",
                                        "loc_flow_rad")}
    flownet["use_instance_norm"] = False

    def flow_cfg(name, dataset, root, mapping):
        path = osp.join(base, name + ".yaml")
        with open(path, "w") as f:
            yaml.safe_dump({"dataset": dataset, "save_path": flow_ckpt,
                            "data": {"root": root, "mapping_path": mapping},
                            "flownet": flownet}, f)
        return path

    # KITTI-SF: per scene, batched, and the kitti142 benchmark.
    ids = ["%06d" % i for i in range(len(OUT_KITTI_N))]
    kroot = synth.make_kittisf_full_root(osp.join(base, "kitti"), ids,
                                         list(OUT_KITTI_N), seed=SEED)
    kmap = osp.join(kroot, "val.txt")
    with open(kmap, "w") as f:
        f.write("\n".join(ids))
    kcfg = flow_cfg("kitti", "kittisf", kroot, kmap)
    flags = [kcfg, "--split", "val", "--save", "--device", DEVICE]
    res, launches["test_flow_kittisf"], _ = outdoor_stage(
        "test_flow_kittisf per scene", test_flow_kittisf.main, flags,
        ("fps", "fps_cluster", "knn_exact"))
    times["test_flow_kittisf"] = res["scene_s"]
    per_scene = saved_flows(kroot, "flowstep3d")
    res_b, launches["test_flow_kittisf --scene_batch 2"], _ = outdoor_stage(
        "test_flow_kittisf --scene_batch 2", test_flow_kittisf.main,
        flags + ["--scene_batch", "2"], ("fps", "fps_cluster", "knn_exact"))
    times["test_flow_kittisf --scene_batch 2"] = res_b["scene_s"]
    gap = flow_gap(saved_flows(kroot, "flowstep3d"), per_scene)
    log(f"test_flow_kittisf: EPE per scene {res['EPE']:.6f}, batched "
        f"{res_b['EPE']:.6f}; saved flows {len(per_scene)} files, batched "
        f"against per scene within {gap:.3e} m (bound {OUT_BATCH_TOL})")
    if gap > OUT_BATCH_TOL:
        raise AssertionError("test_flow_kittisf batched != per scene")
    bench_ids = ids[:2]
    down = osp.join(base, "kitti_downsampled")
    write_kittisf(down, bench_ids, SEED)
    os.rename(osp.join(down, "flow_preds", "flowstep3d"),
              osp.join(down, "flow_preds", "flowstep3d_for-benchmark_R2"))
    split_files(cwd, {"kittisf/splits/kitti142.txt": bench_ids})
    with contextlib.chdir(cwd):
        res, launches["test_flow_kittisf_benchmark"], wall = outdoor_stage(
            "test_flow_kittisf_benchmark", test_flow_kittisf_benchmark.main,
            [flow_cfg("bench", "kittisf", kroot, kmap), "--device", DEVICE],
            ("fps", "knn_exact"))
    times["test_flow_kittisf_benchmark"] = [wall / len(bench_ids)]
    check_finite("benchmark", {**res["FlowStep3D"], **{
        "ours " + k: v for k, v in res["Ours"].items()}})

    # Waymo: per scene (GPF, ICP, --bound) and batched (odometry, denoise).
    seq = "segment-outdoor_smoke"
    wroot = synth.make_waymo_root(osp.join(base, "waymo"), [seq],
                                  OUT_WAYMO_FRAMES, OUT_WAYMO_N, seed=SEED)
    wmap = osp.join(wroot, "train.txt")
    with open(wmap, "w") as f:
        f.write(seq + ".tfrecord")
    wcfg = flow_cfg("waymo", "waymo", wroot, wmap)
    res, launches["test_flow_waymo"], _ = outdoor_stage(
        "test_flow_waymo per scene", test_flow_waymo.main,
        [wcfg, "--split", "train", "--bound", "--save", "--device", DEVICE],
        ("fps", "fps_cluster", "knn_exact"))
    times["test_flow_waymo"] = res["scene_s"]
    saved_flows(wroot, "flowstep3d_gpf_bound")
    res_b, launches["test_flow_waymo --scene_batch 2"], _ = outdoor_stage(
        "test_flow_waymo --scene_batch 2 --use_odometry --denoise",
        test_flow_waymo.main,
        [wcfg, "--split", "train", "--bound", "--save", "--use_odometry",
         "--denoise", "--scene_batch", "2", "--device", DEVICE],
        ("fps", "fps_cluster", "knn_exact"))
    times["test_flow_waymo --scene_batch 2"] = res_b["scene_s"]
    saved_flows(wroot, "flowstep3d_gpf_odo_bound_denoise")
    log(f"test_flow_waymo: EPE (ICP) {res['EPE']:.6f}, (odometry, denoise) "
        f"{res_b['EPE']:.6f}")
    check_finite("test_flow_waymo", {"EPE": res["EPE"],
                                     "EPE odometry": res_b["EPE"]})
    check_icp_gpf(kroot, wroot, seq)

    # Where a scene's time goes: profiles of 3 per-scene calls of each.
    for name, cfg_path, extra in (("test_flow_kittisf", kcfg, []),
                                  ("test_flow_waymo", wcfg, ["--bound"])):
        parser = outdoor.flow_parser()
        parser.add_argument("--use_odometry", action="store_true")
        parser.add_argument("--denoise", action="store_true")
        parser.add_argument("--bound", action="store_true")
        args = parser.parse_args([cfg_path, "--split", "train", "--device",
                                  DEVICE] + extra)
        load_config_into_args(args)
        dev = outdoor.OutdoorFlow(args)
        if name == "test_flow_kittisf":
            from ogc_tpu_torch.data.kittisf import KITTISceneFlowDataset

            ds = KITTISceneFlowDataset(kroot, kmap, downsampled=False,
                                       view_sels=[[0, 1], [1, 0]])
            from ogc_tpu_torch.utils.meters import AverageMeter

            meter = AverageMeter()
            fn = lambda i: test_flow_kittisf.eval_scene(  # noqa: E731
                args, dev, ds, 2 * (i % 4), meter, None)
        else:
            from ogc_tpu_torch.data.waymo import WaymoOpenDataset

            run = test_flow_waymo.WaymoFlow(args, dev, WaymoOpenDataset(
                wroot, wmap), None)
            fn = lambda i: run.scene(i % (OUT_WAYMO_FRAMES - 1))  # noqa
        profile_steps(f"{name} scenes (per scene)", fn)

    # The Waymo trainers at B=4 x 8192 (waymo_unsup and its fast mode) and
    # B=16 x 8192 (waymo_sup), then test_seg_waymo on the first one's
    # checkpoint, and test_seg on KITTI-Det and SemanticKITTI with it (the
    # same KITTI segnet, 10 slots).
    tseq = "segment-outdoor_train"
    n_frames = 4 * (OUT_TRAIN_STEPS + 1) + 1
    droot = synth.make_waymo_root(osp.join(base, "waymo_ds"), [tseq],
                                  n_frames, N_POINT, seed=SEED,
                                  downsampled=True)
    dmap = osp.join(droot, "train.txt")
    with open(dmap, "w") as f:
        f.write(tseq + ".tfrecord")
    pairs = [[tseq, t, t - 1] for t in range(1, n_frames)]
    frames = [[tseq, t % n_frames] for t in range(16 * (OUT_SUP_STEPS + 1))]
    sel = {}
    for name, rows in (("train2", pairs[:4 * OUT_TRAIN_STEPS]),
                       ("val2", pairs[4 * OUT_TRAIN_STEPS:]),
                       ("train1", frames[:16 * OUT_SUP_STEPS]),
                       ("val1", frames[16 * OUT_SUP_STEPS:])):
        sel[name] = osp.join(droot, name + ".json")
        with open(sel[name], "w") as f:
            json.dump(rows, f)
    data = {"root": droot, "train_mapping": dmap, "val_mapping": dmap}
    seg_save = osp.join(base, "ckpt", "waymo_unsup")
    set_modes({}, False)  # the trainers' default: approximate neighbours
    for src, name in (("waymo_unsup", "train_seg_waymo"),
                      ("waymo_unsup_fast", "train_seg_waymo fast")):
        cfg, path = write_cfg(
            base, f"config/seg/waymo/{src}.yaml", src, epochs=1,
            predflow_path="None", save_path=seg_save + ("_fast" if "fast"
                                                        in name else ""),
            data={**data, "train_select_frame": sel["train2"],
                  "val_select_frame": sel["val2"]})
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, launches[name], _ = outdoor_stage(
            name, train_seg_waymo.main, [path, "--round", "1", "--device",
                                         DEVICE],
            ("fps", "knn_exact", "scatter_add"))
        set_modes({"compute_dtype": None})
        log_steps(f"{name} step (B={cfg['batch_size']} x {N_POINT}, frame "
                  f"stride 2)", res["trainer"], cfg["batch_size"],
                  time.perf_counter() - t0)
        times[name] = [float(np.median(res["trainer"].step_seconds[1:]))]
        check_finite(name, {"best_loss": res["best_loss"]})
    cfg, path = write_cfg(
        base, "config/seg/waymo/waymo_sup.yaml", "waymo_sup", epochs=1,
        save_path=osp.join(base, "ckpt", "waymo_sup"),
        data={**data, "train_select_frame": sel["train1"],
              "val_select_frame": sel["val1"]})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, launches["train_seg_waymo_sup"], _ = outdoor_stage(
        "train_seg_waymo_sup", train_seg_waymo_sup.main,
        [path, "--device", DEVICE],
        ("fps", "knn_exact", "scatter_add"))
    log_steps(f"train_seg_waymo_sup step (B={cfg['batch_size']} x "
              f"{N_POINT})", res["trainer"], cfg["batch_size"],
              time.perf_counter() - t0)
    times["train_seg_waymo_sup"] = [
        float(np.median(res["trainer"].step_seconds[1:]))]
    check_finite("train_seg_waymo_sup", {"best_loss": res["best_loss"]})

    # A profile of 3 Waymo train steps on one batch, from the CLI's pieces.
    cfg, _ = write_cfg(base, "config/seg/waymo/waymo_unsup.yaml", "prof",
                       predflow_path="None",
                       data={**data, "train_select_frame": sel["train2"]})
    set_modes(cfg, False)
    from ogc_tpu_torch.data.waymo import WaymoOpenDataset

    ds = WaymoOpenDataset(droot, dmap, downsampled=True,
                          select_frame=sel["train2"], aug_transform=True,
                          aug_transform_args=cfg["data"]["aug_transform_args"],
                          decentralize=True)
    np.random.seed(SEED)
    batch = tuple(np.stack(f, 0) for f in zip(*[ds[i] for i in range(4)]))
    trainer = make_trainer(cfg, make_model(cfg, DEVICE), DEVICE,
                           osp.join(base, "exp_prof"))
    trainer.frame_stride = 2
    profile_steps(f"Waymo train steps (B=4 x {N_POINT})",
                  lambda i: trainer.train_it(i, batch, True))

    split_files(cwd, {"waymo/splits/val.txt": [tseq + ".tfrecord"],
                      "kittidet/splits/val.txt": [
                          "%06d" % i for i in range(OUT_SEG_SCENES)]})
    det = synth.make_single_frame_root(
        osp.join(base, "kittidet"), ["%06d" % i for i in range(
            OUT_SEG_SCENES)], N_POINT, seed=SEED)
    sem = synth.make_single_frame_root(
        osp.join(base, "semantickitti"), ["%02d_%06d" % (i % 11, i)
                                          for i in range(OUT_SEG_SCENES)],
        N_POINT, seed=SEED + 1)
    with contextlib.chdir(cwd):
        for name, dataset, root, split, mod in (
                ("test_seg_waymo", "waymo", droot, "val", test_seg_waymo),
                ("test_seg kittidet", "kittidet", det, "val", test_seg),
                ("test_seg semantickitti", "semantickitti", sem, "test",
                 test_seg)):
            _, path = write_cfg(
                base, osp.join(REPO, "config/seg/waymo/waymo_unsup.yaml"),
                "eval_" + dataset, dataset=dataset, save_path=seg_save,
                data={"root": root})
            res, launches[name], wall = outdoor_stage(
                name, mod.main, [path, "--split", split, "--round", "1",
                                 "--test_batch_size", "8", "--device",
                                 DEVICE],
                ("fps", "knn_exact"))
            times[name] = [float(np.median(res["forward_s"]))]
            check_finite(name, {k: res[k] for k in ("AP", "PQ",
                                                    "per_scan_iou_avg")})
    log(f"outdoor phase done in {time.perf_counter() - t_start:.1f} s; "
        f"seconds per scene / step (median): " + "; ".join(
            f"{k} {float(np.median(v)):.4f}" for k, v in times.items()))
    return launches, times

# ---------------------------------------------------------------------------
# Data parallelism (ogc_tpu_torch/parallel/mesh.py)
# ---------------------------------------------------------------------------

# Steps of each arm: SAPIEN full (B=32 x 512, 4 frames, pinned exact) and
# the SAPIEN flow trainer (B=32 x 512, the config's 4 iterations, exact).
DP_STEPS = 3
# Two ranks against one process that takes their steps itself
# (split_steps: each row block's forward and backward at the ranks'
# shapes, the gradients, terms and local-sync running statistics averaged
# as the ranks' collective averages them, one Adam step): every step's
# loss terms (rtol), the first step's averaged gradient (relative
# Frobenius, PARITY.md's gradient tolerance), the running statistics after
# the steps (relative to each tensor's largest entry); the eval forward
# over two shards against one (MASK_TOL; flows relative to their scale).
DP_LOSS_RTOL, DP_GRAD_RTOL, DP_STATS_RTOL, DP_FLOW_TOL = 1e-4, 3e-3, 1e-5, 2e-5
DP_EVAL_B = 7
# Global sync couples the row blocks in every BatchNorm, so no process can
# take the ranks' steps alone: the reference is one process on the global
# batch, whose statistics, weight gradients and loss means round another
# way.  Train-mode FlowStep3D amplifies rounding ~10-100x an iteration
# (the CPU float64 test holds the semantics to 1e-9; in float32 the outputs
# of 4 iterations part by percents), so that arm is held to the bounds
# above or, where larger, to DP_WITNESS_X times the distance the same
# one-process run moves when its clouds move by one unit in the last place
# (the largest over DP_NUDGES).
DP_WITNESS_X = 10
DP_NUDGES = (("one ulp up", np.inf), ("one ulp down", -np.inf))
#: the command that runs one rank (dp_worker)
DP_WORKER = [sys.executable, osp.join(REPO, "chip_smoke.py"), "dp_worker"]


class ItemList:
    """Items held in memory, as a dataset for the port's DataLoader."""

    def __init__(self, arrays):
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays[0])

    def __getitem__(self, i):
        return tuple(a[i] for a in self.arrays)


def dp_batch(arrays, rank=None, size=None):
    """This rank's block of the global batch ``arrays`` through the port's
    DataLoader (the whole batch without a process group)."""
    from ogc_tpu_torch.data.base import DataLoader

    (batch,) = list(DataLoader(ItemList(arrays), batch_size=len(arrays[0]),
                               num_workers=1, rank=rank, world_size=size))
    return batch


def flat_grads(model):
    return torch.cat([p.grad.detach().double().flatten().cpu()
                      for p in model.parameters() if p.grad is not None])


def split_steps(trainer, blocks, its, step):
    """``step(trainer, it, block)`` for each ``it`` of ``its`` as two ranks
    take it, in one process with no process group: every row block's
    forward and backward from the same weights and running statistics,
    their gradients, terms and running statistics averaged as the ranks'
    collective averages them (the sum, then halved, in their dtype), then
    one Adam step.  The ranks' shapes, so the ranks' rounding.  Returns the
    terms a step (keys sorted) and the first step's averaged gradient."""
    model, opt = trainer.model, trainer.optimizer
    params = list(model.parameters())
    bufs = dict(model.named_buffers())
    lds, grads = [], None
    for it in its:
        start = {k: b.clone() for k, b in bufs.items()}
        got = []
        opt.step = lambda: None     # the ranks step after the average
        try:
            for block in blocks:
                for k, b in bufs.items():
                    b.copy_(start[k])
                ld = step(trainer, it, block)
                got.append(([p.grad.clone() for p in params],
                            torch.tensor([ld[k] for k in sorted(ld)],
                                         dtype=torch.float32),
                            {k: b.clone() for k, b in bufs.items()}))
        finally:
            del opt.step
        (g0, t0, b0), (g1, t1, b1) = got
        for p, a, b in zip(params, g0, g1):
            p.grad = (a + b) / 2
        for k, b in bufs.items():
            b.copy_((b0[k] + b1[k]) / 2 if "running_" in k else b0[k])
        lds.append(((t0 + t1) / 2).tolist())
        if grads is None:
            grads = flat_grads(model)
        opt.step()
    return np.array(lds), grads


def dp_seg_steps(cfg, batch, exp_base, save_at=None, blocks=None):
    """DP_STEPS SegTrainer steps of ``cfg`` (from the first step with every
    term on) on ``batch``, or with ``blocks`` as two ranks take them on
    those row blocks (split_steps): (trainer, terms a step (keys sorted),
    the first step's gradient as the optimizer saw it, step ms, extra).
    With ``save_at``, a checkpoint after that many steps (rank 0 writes,
    counted) and the last step again from a trainer resumed from it."""
    from ogc_tpu_torch.utils import checkpoint

    set_modes(cfg, True)
    it0 = first_it_all_terms(cfg, SAP_B)
    model = make_model(cfg, DEVICE)
    trainer = make_trainer(cfg, model, torch.device(DEVICE), exp_base)
    if blocks is not None:
        lds, grads = split_steps(
            trainer, blocks, [it0 + i for i in range(DP_STEPS)],
            lambda tr, it, b: tr.train_it(it, b, aug_transform=True)[0])
        return trainer, lds, grads, None, {}
    lds, grads, extra = [], None, {}
    for i in range(DP_STEPS):
        if save_at == i:
            writes = []
            real = checkpoint.save_train_state
            checkpoint.save_train_state = (
                lambda *a: writes.append(1) or real(*a))
            try:
                trainer.save(True, 1)
            finally:
                checkpoint.save_train_state = real
            extra["writes"] = len(writes)
        ld, _, _ = trainer.train_it(it0 + i, batch, aug_transform=True)
        lds.append([ld[k] for k in sorted(ld)])
        extra["keys"] = sorted(ld)
        if i == 0:
            grads = flat_grads(model)
    if save_at is not None:
        resumed = make_trainer(cfg, make_model(cfg, DEVICE),
                               torch.device(DEVICE), exp_base)
        extra["epoch"] = resumed.resume(trainer.checkpoint_name + ".pth.tar")
        ld, _, _ = resumed.train_it(it0 + save_at, batch, aug_transform=True)
        extra["resumed"] = [ld[k] for k in sorted(ld)]
    ms = np.array(trainer.step_seconds) * 1e3
    return trainer, np.array(lds), grads, ms, extra


def dp_flow_steps(cfg, batch, exp_base, bn_sync, blocks=None):
    """DP_STEPS FlowTrainer steps of the config's iterations on ``batch``,
    or with ``blocks`` as two ranks take them (split_steps; local sync
    only): (trainer, terms a step (keys sorted), the first step's gradient,
    step ms)."""
    from ogc_tpu_torch import ops

    ops.set_exact_neighbors(True)
    trainer = make_flow_trainer(cfg, DEVICE, exp_base, bn_sync=bn_sync)
    if blocks is not None:
        lds, grads = split_steps(trainer, blocks, range(DP_STEPS),
                                 lambda tr, it, b: tr.train_it(it, b))
        return trainer, lds, grads, None
    lds, grads = [], None
    for it in range(DP_STEPS):
        ld = trainer.train_it(it, batch)
        lds.append([ld[k] for k in sorted(ld)])
        if it == 0:
            grads = flat_grads(trainer.model)
    return trainer, np.array(lds), grads, np.array(trainer.step_seconds) * 1e3


def running_stats(model):
    return {k: v.detach().double().cpu() for k, v in model.state_dict().items()
            if "running_" in k}


def dp_inputs(tmp, scfg):
    """The phase's configs (SAPIEN full of phase 9, the SAPIEN flow config
    on phase 14's root) and global batches, saved for the rank processes:
    the path of their spec."""
    cfg = dict(scfg, save_path=osp.join(tmp, "ckpt", "dp_seg"))
    fcfg, _ = write_cfg(tmp, "config/flow/sapien/sapien_unsup.yaml",
                        "dp_flow", data={"root": osp.join(tmp, "PIPE_SAPIEN")},
                        save_path=osp.join(tmp, "ckpt", "dp_flow"))
    arrays = {"seg": fixed_batch(cfg, SAP_B), "flow": flow_batch(fcfg,
                                                                 SAP_FT_B)}
    np.savez(osp.join(tmp, "dp_batches.npz"),
             **{f"{k}{i}": a for k, v in arrays.items()
                for i, a in enumerate(v)})
    spec = osp.join(tmp, "dp_spec.json")
    with open(spec, "w") as f:
        json.dump({"tmp": tmp, "cfg": cfg, "fcfg": fcfg}, f)
    return spec


def dp_load(spec_path):
    """(cfg, fcfg, seg arrays, flow arrays, spec) of ``dp_inputs``."""
    with open(spec_path) as f:
        spec = json.load(f)
    with np.load(osp.join(spec["tmp"], "dp_batches.npz")) as z:
        seg = tuple(z[f"seg{i}"] for i in range(4))
        flow = tuple(z[f"flow{i}"] for i in range(4))
    return spec["cfg"], spec["fcfg"], seg, flow, spec


def dp_worker(spec_path):
    """One rank of a data-parallel arm (``python3 chip_smoke.py dp_worker
    <spec.json> share|own <out dir>``, the launcher's variables set by the
    parent; ``share``: every rank on card 0, gloo): SegTrainer
    with a rank-0 checkpoint and a resume, FlowTrainer under global and
    local sync, each on this rank's row block of the global batches; the
    launch counts of the seg steps; writes rank<r>.npz."""
    from ogc_tpu_torch.ops import _build
    from ogc_tpu_torch.parallel import mesh
    from ogc_tpu_torch.train_seg import set_deterministic

    share, out_dir = sys.argv[3] == "share", sys.argv[4]
    device = mesh.init_data_parallel("cuda", share_device=share)
    global DEVICE
    DEVICE = str(device)
    set_deterministic(device)
    _build.lib()
    rank, size = mesh.world()
    cfg, fcfg, seg_arrays, flow_arrays, spec = dp_load(spec_path)
    tmp = spec["tmp"]
    out = {}
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    seg = dp_seg_steps(cfg, dp_batch(seg_arrays), osp.join(tmp, "dp_seg_w"),
                       save_at=DP_STEPS - 1)
    out["launches"] = np.array([read_counts()[k] for k in KERNELS])
    out["seg_ld"], out["seg_grads"], out["seg_ms"] = seg[1], seg[2].numpy(), \
        seg[3]
    out["seg_keys"] = np.array(seg[4]["keys"])
    out["seg_writes"] = np.array(seg[4]["writes"])
    out["seg_epoch"] = np.array(seg[4]["epoch"])
    out["seg_resumed"] = np.array(seg[4]["resumed"])
    flow_batch_r = dp_batch(flow_arrays)
    for sync in ("global", "local"):
        tr, ld, grads, ms = dp_flow_steps(
            fcfg, flow_batch_r, osp.join(tmp, f"dp_f{sync}_w"), sync)
        out[f"{sync}_ld"], out[f"{sync}_grads"] = ld, grads.numpy()
        out[f"{sync}_ms"] = ms
    for k, v in running_stats(tr.model).items():
        out["local/" + k] = v.numpy()
    out["peak_mib"] = np.array(torch.cuda.max_memory_allocated(device) / 2**20)
    out["rows"] = np.array([seg_arrays[0].shape[0],
                            dp_batch(seg_arrays).true_b])
    np.savez(osp.join(out_dir, f"rank{rank}.npz"), **out)
    mesh.shutdown()


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(spec, size, share):
    """``size`` rank processes of dp_worker on the inputs of ``spec`` (the
    launcher's variables set here, one card each or all on card 0 with
    ``share``); returns their outputs by rank and the wall seconds."""
    out = osp.join(osp.dirname(spec), f"dp_{size}_{int(share)}")
    os.makedirs(out, exist_ok=True)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [*DP_WORKER, spec, "share" if share else "own", out],
        cwd=REPO, env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(size),
                           LOCAL_RANK=str(0 if share else r),
                           MASTER_ADDR="localhost", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(size)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {size} failed "
                                 f"({p.returncode}):\n{text[-6000:]}")
    res = []
    for r in range(size):
        with np.load(osp.join(out, f"rank{r}.npz")) as z:
            res.append({k: z[k] for k in z.files})
    return res, wall


def rel_frobenius(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def step_rtol(a, b):
    """Each step's largest relative distance of the terms ``a`` from
    ``b``."""
    return np.abs(np.asarray(a) / np.asarray(b) - 1).max(1)


def dp_references(tmp, spec, smi):
    """The phase's one-process runs (no process group): SegTrainer and
    FlowTrainer (global sync, i.e. plain BatchNorm) on the global batches,
    the ranks' steps taken in one process (split_steps) for SegTrainer and
    local-sync FlowTrainer, and the global-sync witnesses (the global
    batch's clouds nudged by one ulp).  Returns them by name."""
    cfg, fcfg, seg_arrays, flow_arrays, _ = dp_load(spec)
    torch.cuda.reset_peak_memory_stats()
    ref = {"seg": dp_seg_steps(cfg, dp_batch(seg_arrays),
                               osp.join(tmp, "dp_seg_1")),
           "flow": dp_flow_steps(fcfg, dp_batch(flow_arrays),
                                 osp.join(tmp, "dp_f_1"), "global")}
    peak = torch.cuda.max_memory_allocated() / 2**20
    blocks = (lambda arrays: [dp_batch(arrays, r, 2) for r in range(2)])
    ref["seg_split"] = dp_seg_steps(cfg, None, osp.join(tmp, "dp_seg_s"),
                                    blocks=blocks(seg_arrays))
    ref["local_split"] = dp_flow_steps(fcfg, None, osp.join(tmp, "dp_fl_s"),
                                       "local", blocks=blocks(flow_arrays))
    flow_ld, flow_g = ref["flow"][1], ref["flow"][2].numpy()
    terms, grads = [], []
    for name, to in DP_NUDGES:
        pcs = np.nextafter(flow_arrays[0], np.float32(to))
        _, ld, g, _ = dp_flow_steps(
            fcfg, dp_batch((pcs, *flow_arrays[1:])),
            osp.join(tmp, "dp_f_w"), "global")
        terms.append(step_rtol(ld, flow_ld))
        grads.append(rel_frobenius(g.numpy(), flow_g))
        log(f"data parallel witness, one process on the global flow batch "
            f"({name}): terms' rtol a step {terms[-1].tolist()}, first "
            f"gradient's relative Frobenius {grads[-1]:.3e}")
    ref["witness"] = (np.max(terms, 0), max(grads))
    log(f"data parallel, one process: step ms seg "
        f"{np.round(ref['seg'][3], 4).tolist()}, flow "
        f"{np.round(ref['flow'][3], 4).tolist()}; peak {peak:.1f} MiB; {smi}")
    return ref


def check_ranks(what, ranks, ref, smi):
    """The ranks of one multi-rank arm against the one-process references
    of ``dp_references``."""
    seg_s, local_s = ref["seg_split"], ref["local_split"]
    flow_ld, flow_g = ref["flow"][1], ref["flow"][2].numpy()
    w_terms, w_grad = ref["witness"]
    local_stats = running_stats(local_s[0].model)
    for r, o in enumerate(ranks):
        checks = {
            "seg terms, every step": (
                float(step_rtol(o["seg_ld"], seg_s[1]).max()), DP_LOSS_RTOL),
            "seg gradient": (rel_frobenius(o["seg_grads"], seg_s[2]),
                             DP_GRAD_RTOL),
            "flow (local) terms, every step": (
                float(step_rtol(o["local_ld"], local_s[1]).max()),
                DP_LOSS_RTOL),
            "flow (local) gradient": (
                rel_frobenius(o["local_grads"], local_s[2]), DP_GRAD_RTOL),
            "flow (local) statistics": (max(
                float(np.abs(o["local/" + k] - v.numpy()).max()
                      / np.abs(v.numpy()).max())
                for k, v in local_stats.items()), DP_STATS_RTOL),
            "flow (global) gradient": (
                rel_frobenius(o["global_grads"], flow_g),
                max(DP_GRAD_RTOL, DP_WITNESS_X * w_grad))}
        for s, (d, w) in enumerate(zip(step_rtol(o["global_ld"], flow_ld),
                                       w_terms)):
            checks[f"flow (global) terms, step {s + 1}"] = (
                float(d), max(DP_LOSS_RTOL, DP_WITNESS_X * float(w)))
        log(f"{what} rank {r}: " + ", ".join(
            f"{k} {v:.3e} (bound {b:.3e})" for k, (v, b) in checks.items())
            + "; not bounded, from one process on the global batch: seg "
            f"terms' rtol a step "
            f"{step_rtol(o['seg_ld'], ref['seg'][1]).tolist()}, gradient "
            f"{rel_frobenius(o['seg_grads'], ref['seg'][2]):.3e}")
        bad = [k for k, (v, b) in checks.items() if not v <= b]
        launched = dict(zip(KERNELS, o["launches"].tolist()))
        missing = [k for k in ("fps", "knn_exact", "scatter_add")
                   if not launched[k]]
        if bad or missing:
            raise AssertionError(f"{what} rank {r}: out of bounds {bad}, "
                                 f"launched no {missing}")
        if int(o["seg_writes"]) != (1 if r == 0 else 0) or \
                int(o["seg_epoch"]) != 1:
            raise AssertionError(f"{what} rank {r}: checkpoint written "
                                 f"{int(o['seg_writes'])} times, epoch "
                                 f"{int(o['seg_epoch'])}")
        resumed = float(np.abs(o["seg_resumed"] / o["seg_ld"][-1] - 1).max())
        if not resumed <= DP_LOSS_RTOL:
            raise AssertionError(f"{what} rank {r}: the resumed step's terms "
                                 f"are {resumed:.3e} from the continuing "
                                 f"one's")
        log(f"{what} rank {r}: rows {o['rows'].tolist()} (global, own); "
            f"launches of the seg steps {launched}; checkpoint written by "
            f"rank 0 only, the resumed step {resumed:.3e} from the "
            f"continuing one; step ms seg "
            f"{np.round(o['seg_ms'], 4).tolist()}, flow global "
            f"{np.round(o['global_ms'], 4).tolist()}, local "
            f"{np.round(o['local_ms'], 4).tolist()}; peak "
            f"{float(o['peak_mib']):.1f} MiB; {smi}")


def check_dp_eval(pcfg, devices, smi):
    """dp_eval_fwd over ``devices`` against one shard on cuda:0: the
    KITTI-SF segnet forward on an odd batch (masks within MASK_TOL) and
    the kitti flownet forward (flows within DP_FLOW_TOL of their scale)."""
    from ogc_tpu_torch.parallel import mesh

    set_modes(pcfg, True)
    segnet = make_model(pcfg, DEVICE).eval()
    pc = fixed_batch(pcfg, DP_EVAL_B)[0][:, 0]
    fwd = (lambda m, x: m(x, x))
    one = [torch.device(DEVICE)]
    masks = {}
    for name, d in (("1", one), ("n", devices)):
        f = mesh.dp_eval_fwd(fwd, d, segnet)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks[name] = f(pc)
        masks[name + "_ms"] = (time.perf_counter() - t0) * 1e3
    mdiff = float(np.abs(masks["n"] - masks["1"]).max())
    flownet = make_flownet(FLOW_KW, DEVICE)
    pc1, pc2 = flow_scenes(FLOW_B, SEED)
    ffwd = (lambda m, a, b: m(a, b, a, b, FLOW_ITERS)[-1])
    flows = {n: mesh.dp_eval_fwd(ffwd, d, flownet)(pc1, pc2)
             for n, d in (("1", one), ("n", devices))}
    scale = max(1.0, float(np.abs(flows["1"]).max()))
    fdiff = float(np.abs(flows["n"] - flows["1"]).max())
    n = len(devices)
    names = [f"cuda:{torch.cuda.current_device()}" if str(d) == "cuda"
             else str(d) for d in devices]
    log(f"dp_eval_fwd over {names}: KITTI-SF segnet "
        f"B={DP_EVAL_B} x {N_POINT} (padded to {n * -(-DP_EVAL_B // n)}) "
        f"masks {mdiff:.3e} from --dp 1 (MASK_TOL {MASK_TOL}), "
        f"{masks['n_ms']:.4f} ms against {masks['1_ms']:.4f} ms; kitti "
        f"flownet B={FLOW_B} x {N_POINT} flows {fdiff:.3e} (bound "
        f"{DP_FLOW_TOL} x {scale:.4f}); {smi}")
    if masks["n"].shape != masks["1"].shape or not mdiff <= MASK_TOL or \
            not fdiff <= DP_FLOW_TOL * scale:
        raise AssertionError(f"dp_eval_fwd over {n} shards disagrees")


def check_card_index():
    """A CLI's ``--device cuda:1`` without the launcher's variables:
    init_data_parallel makes that card current (the kernels launch with
    the current card), then #1 and #2 on its tensors are bit-equal to
    their plain versions."""
    from ogc_tpu_torch.ops.fps import fps, fps_plain
    from ogc_tpu_torch.ops.knn import knn_exact, knn_exact_plain
    from ogc_tpu_torch.parallel import mesh

    gen = torch.Generator().manual_seed(SEED)
    x = (torch.randint(0, 64, (2, 4096, 3), generator=gen) / 8.0)
    try:
        x = x.to(mesh.init_data_parallel("cuda:1"))
        got = (fps(x, 512), *knn_exact(x, x, 16))
        want = (fps_plain(x, 512), *knn_exact_plain(x, x, 16))
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_device(0)
    same = [torch.equal(a, b) for a, b in zip(got, want)]
    log(f"--device cuda:1 (cuda:1 made current): #1, #2 bit-equal to "
        f"their plain versions: {same}")
    if not all(same):
        raise AssertionError("kernels on cuda:1 disagree with plain")


def run_dp(tmp, scfg, pcfg, pcfg_path, smi, shared=True):
    """The data-parallel phase: NCCL at world size 1 bit-equal to no
    process group; two gloo ranks sharing card 0 against one process
    (SegTrainer with a rank-0 checkpoint and a resume, FlowTrainer in
    global and local sync); dp_eval_fwd over [cuda:0, cuda:0]; --dp above
    the card count raising; where the machine has two cards or more, two
    NCCL ranks on two cards and dp_eval_fwd over every card.  Without
    ``shared``, only the one-process references and the arms that need
    more than one card."""
    from ogc_tpu_torch import test_seg
    from ogc_tpu_torch.parallel import mesh

    t_phase = time.perf_counter()
    spec = dp_inputs(tmp, scfg)
    cfg, fcfg, seg_arrays, flow_arrays, _ = dp_load(spec)
    ref = dp_references(tmp, spec, smi)
    seg, flow = ref["seg"], ref["flow"]

    if shared:
        # NCCL, world size 1: an average over one rank is the identity.
        env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
        os.environ.update(env)
        try:
            device = mesh.init_data_parallel("cuda")
            if torch.distributed.get_backend() != "nccl" or \
                    mesh.world() != (0, 1):
                raise AssertionError("world size 1: no NCCL group")
            torch.cuda.reset_peak_memory_stats()
            seg1 = dp_seg_steps(cfg, dp_batch(seg_arrays),
                                osp.join(tmp, "dp_seg_n"))
            flow1 = dp_flow_steps(fcfg, dp_batch(flow_arrays),
                                  osp.join(tmp, "dp_f_n"), "global")
            peak1 = torch.cuda.max_memory_allocated() / 2**20
        finally:
            mesh.shutdown()
            for k in env:
                os.environ.pop(k)
        diff = [k for k, a, b in (
            ("seg terms", seg1[1], seg[1]), ("flow terms", flow1[1], flow[1]))
            if not np.array_equal(a, b)]
        for name, (a, b) in (("seg", (seg1[0].model, seg[0].model)),
                             ("flow", (flow1[0].model, flow[0].model))):
            sa, sb = a.state_dict(), b.state_dict()
            diff += [f"{name} {k}" for k in sa
                     if not torch.equal(sa[k], sb[k])]
        log(f"NCCL world size 1 on {device}: {DP_STEPS} seg and {DP_STEPS} "
            f"flow steps against no process group: {len(diff)} differences; "
            f"step ms seg {np.round(seg1[3], 4).tolist()}, flow "
            f"{np.round(flow1[3], 4).tolist()}; peak {peak1:.1f} MiB; {smi}")
        if diff:
            raise AssertionError(f"NCCL world size 1 differs: {diff[:5]}")

        # Two gloo ranks sharing card 0 (stages through the host: a
        # correctness arm, not a scaling figure).
        ranks, wall = launch_ranks(spec, 2, share=True)
        log(f"gloo, 2 ranks sharing cuda:0 (a correctness arm; gloo stages "
            f"through the host): wall {wall:.3f} s")
        check_ranks("gloo 2 ranks on cuda:0", ranks, ref, smi)
        check_dp_eval(pcfg, [torch.device(DEVICE)] * 2, smi)

    # --dp above the card count raises the JAX package's message.
    n = torch.cuda.device_count()
    try:
        test_seg.main([pcfg_path, "--split", "val", "--dp", str(n + 1)])
    except ValueError as e:
        if f"n_devices={n + 1} exceeds the {n} local devices" not in str(e):
            raise
        log(f"test_seg --dp {n + 1} on {n} card(s) raises: {e}")
    else:
        raise AssertionError(f"test_seg --dp {n + 1} ran on {n} card(s)")
    if n >= 2:
        ranks, wall = launch_ranks(spec, 2, share=False)
        log(f"NCCL, 2 ranks on 2 cards: wall {wall:.3f} s")
        check_ranks("NCCL 2 ranks on 2 cards", ranks, ref, smi)
        check_dp_eval(pcfg, mesh.eval_devices(0, "cuda"), smi)
        check_card_index()
    else:
        log("NCCL on two cards and dp_eval_fwd over two cards: not run "
            "(this machine has one card)")
    log(f"data-parallel phase: {time.perf_counter() - t_phase:.3f} s")


def dp_phase(shared=True):
    """The data-parallel phase alone (``python3 chip_smoke.py dp_phase
    [cards]``): its inputs built as main builds them (the SAPIEN root of
    phase 9, phase 14's flow root, the KITTI-SF parity config), then
    run_dp; ``cards``: only what needs two cards or more, and the
    references it is held to."""
    from ogc_tpu_torch.ops import _build
    from ogc_tpu_torch.tools.synth import make_sapien_root_coherent
    from ogc_tpu_torch.train_seg import set_deterministic

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    os.chdir(REPO)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    set_deterministic(torch.device("cuda"))
    _build.lib()
    with tempfile.TemporaryDirectory() as tmp:
        cfgs = setup_data(tmp)
        sap_cfgs, _ = setup_sapien(tmp)
        make_sapien_root_coherent(osp.join(tmp, "PIPE_SAPIEN",
                                           "mbs-shapepart"),
                                  n_scenes=FT_SCENES, n_points=SAP_N,
                                  seed=200 + SEED)
        run_dp(tmp, sap_cfgs["full"], *cfgs["parity"], smi, shared=shared)
    log(smi)


def main():
    if len(sys.argv) == 5 and sys.argv[1] == "dp_worker":
        return dp_worker(sys.argv[2])
    if len(sys.argv) in (2, 3) and sys.argv[1] == "dp_phase":
        return dp_phase(shared=sys.argv[2:] != ["cards"])
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    os.chdir(REPO)
    sys.path.insert(0, REPO)
    from ogc_tpu_torch.ops import _build
    from ogc_tpu_torch.train_seg import set_deterministic

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}; {smi.stdout.strip()}")
    set_deterministic(torch.device("cuda"))
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernels built from {_build.CSRC_DIR} in {_build.build_seconds:.3f} s "
        f"(load {time.perf_counter() - t0:.3f} s): {_build.library_path()}")

    ptxas_report([osp.join(_build.CSRC_DIR, f)
                  for f in ("fps.cu", "knn_exact.cu", "knn_blockmin.cu",
                            "ball_query.cu", "pool.cu", "scatter_add.cu",
                            "onehot.cu", "onehot_bs.cu", "pruned_prologue.cu",
                            "knn_exact_pruned.cu", "knn_cand_pruned.cu")])
    reports = check_kernels()
    log(f"kernel phase done at {time.perf_counter() - t_start:.1f} s")
    # #6's entry point, with the counts set to 0 just before it.
    from ogc_tpu_torch.tools import bench_knn_pruned

    reset_counts()
    bench_knn_pruned.main(["--reps", str(BENCH_REPS)])
    cand_launches = read_counts()
    calls = sum(len(c[-1]) for c in bench_knn_pruned.CASES) * (BENCH_REPS + 1)
    # Each #6 call: the fused prologue's sort and selection, the search.
    want = launch_counts(knn_cand_pruned=calls, pruned_sort=calls,
                         pruned_select=calls, knn_blockmin=len(
                             bench_knn_pruned.CASES) * (BENCH_REPS + 1))
    log(f"bench_knn_pruned: launches {cand_launches}")
    if cand_launches != want:
        raise AssertionError(f"bench_knn_pruned: launches {cand_launches}, "
                             f"derived {want}")
    with tempfile.TemporaryDirectory() as tmp:
        cfgs = setup_data(tmp)
        # The parity phases pin exact neighbours, as protocol_sapien's
        # parity mode does with OGC_EXACT_NEIGHBORS=1.
        cfg, cfg_path = cfgs["parity"]
        launches = run_train(tmp, cfg, cfg_path, True, STEP_LAUNCHES,
                             VAL_LAUNCHES)
        log(f"train phase done at {time.perf_counter() - t_start:.1f} s")
        profile_train(cfg, tmp, fixed_batch(cfg, TRAIN_B))
        run_eval(tmp, cfg, cfg_path)
        log(f"eval phase done at {time.perf_counter() - t_start:.1f} s")
        run_kitti_oaicp(cfg_path)
        log(f"KITTI-SF OA-ICP done at {time.perf_counter() - t_start:.1f} s")
        # Fast mode: train_seg's default neighbour mode (approximate) on
        # kittisf_unsup_fast.yaml, then test_seg --approx_knn.
        fcfg, fcfg_path = cfgs["fast"]
        fast_launches = run_train(tmp, fcfg, fcfg_path, False, FAST_STEP,
                                  FAST_VAL)
        profile_train(fcfg, tmp, fixed_batch(fcfg, TRAIN_B))
        run_eval(tmp, fcfg, fcfg_path, approx=True)
        log(f"fast phase done at {time.perf_counter() - t_start:.1f} s")
        # The mxu edge engine: the fast config without the symmetric
        # gradient, smooth groups through #9/#10.
        mcfg, mcfg_path = cfgs["mxu"]
        mxu_launches = run_train(tmp, mcfg, mcfg_path, False, MXU_STEP,
                                 MXU_VAL)
        profile_train(mcfg, tmp, fixed_batch(mcfg, TRAIN_B))
        log(f"mxu phase done at {time.perf_counter() - t_start:.1f} s")
        sap_cfgs, sap_launches = run_sapien(tmp)
        log(f"SAPIEN alternation done at "
            f"{time.perf_counter() - t_start:.1f} s")
        full = sap_cfgs["full"]
        batch = fixed_batch(full, SAP_B)
        check_determinism(full, tmp, batch)
        check_card_vs_cpu(full, tmp, fixed_batch(full, 2))
        check_refine_card_vs_cpu(sap_cfgs)
        profile_train(full, tmp, batch)
        log(f"SAPIEN checks done at {time.perf_counter() - t_start:.1f} s")
        flow_launches = run_flow()
        log(f"KITTI-SF flow phase done at "
            f"{time.perf_counter() - t_start:.1f} s")
        for k, v in run_test_flow(tmp).items():
            flow_launches[k] += v
        log(f"test_flow phase done at {time.perf_counter() - t_start:.1f} s")
        # Flow training and supervised training (their own main paths).
        ft_launches = run_flow_pipeline(tmp)
        log(f"flow-train pipeline done at "
            f"{time.perf_counter() - t_start:.1f} s")
        dr_launches = run_ogcdr_flow_train(tmp)
        sup_launches = run_seg_sup(tmp, sap_cfgs["woinv"]["data"]["root"])
        log(f"OGC-DR flow train and supervised train done at "
            f"{time.perf_counter() - t_start:.1f} s")
        out_launches, _ = run_outdoor(tmp)
        log(f"outdoor phase done at {time.perf_counter() - t_start:.1f} s")
        run_dp(tmp, full, *cfgs["parity"], smi.stdout.strip())
        log(f"data-parallel phase done at "
            f"{time.perf_counter() - t_start:.1f} s")
    missing = [k for k in ("fps", "knn_exact", "ball_query", "gather_onehot",
                           "scatter_onehot", "scatter_add")
               if not ft_launches[k]]
    missing += [k for k in ("knn_blockmin", "ball_blockmin")
                if not dr_launches[k]]
    missing += [k for k in ("fps", "knn_exact", "gather_onehot",
                            "scatter_add") if not sup_launches[k]]
    if missing:
        raise AssertionError(f"the training paths launched no {missing}")
    log(f"launches: SAPIEN train_flow {ft_launches}; OGC-DR train_flow "
        f"{dr_launches}; train_seg_sup {sup_launches}")

    # name: (source, the TPU kernel it replaces); launches come from the
    # KITTI-SF train run, for #7/#8 from the SAPIEN alternation, for #3
    # from the fast KITTI-SF train run, for #12/#4 from the gates-on
    # KITTI-SF flow forwards (exact and approximate) and test_flow, for
    # #9/#10 from the mxu KITTI-SF train run, and for #6 from
    # bench_knn_pruned.
    meta = {
        "fps": ("ogc_tpu_torch/csrc/fps.cu",
                "ogc_tpu/ops/pallas_kernels.py:24"),
        "knn_exact": ("ogc_tpu_torch/csrc/knn_exact.cu",
                      "ogc_tpu/ops/pallas_knn.py:378"),
        "ball_query": ("ogc_tpu_torch/csrc/ball_query.cu",
                       "ogc_tpu/ops/pallas_knn.py:836"),
        "scatter_add": ("ogc_tpu_torch/csrc/scatter_add.cu",
                        "ogc_tpu/ops/pallas_scatter.py:54"),
        "gather_onehot": ("ogc_tpu_torch/csrc/onehot.cu",
                          "ogc_tpu/ops/pallas_onehot.py:62"),
        "scatter_onehot": ("ogc_tpu_torch/csrc/onehot.cu",
                           "ogc_tpu/ops/pallas_onehot.py:75"),
        "knn_blockmin": ("ogc_tpu_torch/csrc/knn_blockmin.cu",
                         "ogc_tpu/ops/pallas_knn.py:147"),
        "ball_blockmin": ("ogc_tpu_torch/csrc/ball_query.cu",
                          "ogc_tpu/ops/pallas_knn.py:147"),
        "pool": ("ogc_tpu_torch/csrc/pool.cu",
                 "ogc_tpu/ops/pallas_pool.py:112"),
        "knn_exact_pruned": ("ogc_tpu_torch/csrc/knn_exact_pruned.cu",
                             "ogc_tpu/ops/pallas_knn.py:757"),
        "gather_blocksparse": ("ogc_tpu_torch/csrc/onehot_bs.cu",
                               "ogc_tpu/ops/pallas_onehot.py:258"),
        "scatter_blocksparse": ("ogc_tpu_torch/csrc/onehot_bs.cu",
                                "ogc_tpu/ops/pallas_onehot.py:288"),
        "knn_cand_pruned": ("ogc_tpu_torch/csrc/knn_cand_pruned.cu",
                            "ogc_tpu/ops/pallas_knn.py:1164"),
    }
    kernels = []
    for name, (src, rep) in meta.items():
        rep_, counts = (
            (reports["sapien"], sap_launches) if name.endswith("_onehot")
            else (reports["fast"], fast_launches) if name.endswith("_blockmin")
            else (reports["flow"], flow_launches)
            if name in ("pool", "knn_exact_pruned")
            else (reports["mxu"], mxu_launches)
            if name.endswith("_blocksparse")
            else (reports["cand"], cand_launches)
            if name == "knn_cand_pruned"
            else (reports["parity"], launches))
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": counts[name],
                        **rep_.entry(name)})
    # #1's cluster instance (above one CTA): its times summed over one
    # outdoor scene's calls at each FPS_LARGE_N, and its launches in the
    # outdoor phase (the clouds above MAX_N points).
    kernels[0]["large_n"] = {
        **reports["outdoor"].entry("fps_large"),
        "launches": sum(v["fps_cluster"] for v in out_launches.values())}
    log(smi.stdout.strip())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
