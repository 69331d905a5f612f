#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which fails loudly:

1. device: the card's name and power limit; TF32 is switched off;
2. build: the three CUDA kernels (one nvcc each for sm_90a, in parallel)
   and the native host library (g++, ``csrc/pointutil.cpp``) are built from
   the checkout's sources into the port's gitignored ``_build/``;
3. kernel vs plain: the window-gather kernel against its plain PyTorch
   version at every shape the flagship's inference path gives it, on
   uniform random slab indices and on the indices the flagship's windowed
   search gives the first toy block at levels 0 and 1 (one case per conv
   band), bit for bit, timed with CUDA events both eagerly (host dispatch
   included) and as CUDA-graph replays (device time), beside its bound and
   one PyTorch call for the same gather (``index_select``);
4. serve: the flagship ``pointnet_s3dis`` (bf16 compute, weights drawn from
   torch.Generator seed 0) sweeps 8 blocks of 8192 points through
   ``eval_scene_probs`` and interpolates to a 4x-dense cloud; the kernel's
   launch count over the sweep must be the expected count per block;
5. determinism and parity: one block twice on the card gives bitwise-equal
   logits; in float32 the card and the CPU agree on neighbor indices and
   logit argmax;
6. slab-gradient kernels vs plain: the window gather's backward (its map
   kernel, then its sum kernel) against the plain PyTorch versions at every
   conv shape of the flagship, bf16 and one float32 case, on random and on
   the search's own indices as in phase 3: the map bit for bit, the sums
   in two runs bitwise equal, float32 within 1e-6 relative, bf16 within
   one bf16 ulp, timed like phase 3, beside their bounds, a stable
   ``torch.sort`` (map) and ``index_add_`` (sums; atomic, so timed only);
7. train: the flagship at full width (bf16 compute, weights from
   torch.Generator seed 0, S3DIS class weights) takes training steps on 4
   blocks of 8192 points: the backward kernels' determinism one op at a
   time, launch counts per block of both kernels, a finite loss at every
   step, a falling loss over 20 steps on one batch, a bitwise-repeatable
   step, the non-finite guard and float32 gradient parity card vs CPU
   (cosine); phase 21 times the flagship's steps;
8. fused conv: the fused-conv bench (``bench_fused_conv``) at levels 0 and
   1 at full width: its timed arms and its fused-vs-unfused cross-check
   (within 2^-6 of the largest output), exactly one fused window-conv
   launch per fused call, and the kernel against its plain version in bf16
   at both levels, in float32 at level 0, in bf16 at level 0 with a
   window of 96 rows, no multiple of the tile, and in bf16 on seeded random
   inputs at the flagship's other conv shapes (K=24 with dims 16,16,16,48,
   K=16 with dims 8,8,16,32), at K=8 with dims 4,4,8 (widths under 8), at
   odd widths 3,5,7 and at wide ones 32,32,64,128 (a slab longer than
   shared memory holds):
   two runs bitwise equal, the same points without a valid slot, float32
   within 1e-5 of each output's sum of magnitudes, bf16 within 2 bf16 ulps
   of the largest activation; timed beside its bound;
9. entry points: the user's commands at full width, each path's kernel
   launches counted per block.  (a) The train CLI
   (``train.cli.main``) trains the flagship on synthetic blocks, 3 steps
   of 4 blocks of 8192 points, with its test epoch: the metrics record has
   the JAX CLI's keys and a finite loss, a checkpoint is written, and
   ``--restore --eval`` gives the epoch's test metrics bit for bit.
   (b) The scene eval (``interpolate.main``) restores that checkpoint and
   labels a synthetic room prepared by ``s3dis.prepare_room`` into a scene
   pkl: finite probabilities whose rows sum to 1, an mIoU in [0, 1].
   (c) The train CLI trains ``pointnet_scannet`` (xyz-only first conv,
   which gathers nothing) for 3 steps with a finite loss, and its float32
   logits on one block agree with the CPU's argmax.  (d) The train CLI
   trains the flagship one epoch from that prepared room's pkl
   (``--data-dir``: the Provider, rgb and covariance features): the record
   has the JAX CLI's keys and a finite loss.
10. the rest of the PointNet family: ``pointnet_semantic3d`` (its level-1
   pre-stage conv), ``pointnet_semantic3d_dilate``, ``pointnet_baseline20``
   (20 noconcat convs on gathered features), ``pointnet_concat10_deconv``
   (the deconv decoder and the unfactored head) and ``pointnet_embed_only``
   at full width, bf16 compute, seeded weights; the Semantic3D keys on 10 m
   blocks of 10,240 points (13 features) that the port's
   ``semantic3d.sample_training_blocks`` cuts from a seeded synthetic
   outdoor scan, the S3DIS keys on toy blocks of 8192 points.  (a) One
   ``Trainer`` step of 4 blocks each: a finite loss, and both kernels'
   launches as counted per block (K3 only where the gathered features
   take a gradient).  (b) Each key's float32 logits on one block agree
   with the CPU's argmax.  (c) The train CLI trains ``--config semantic3d``
   one epoch from those blocks' pkl (``--data-dir``): the JAX CLI's record
   with 8 classes and a finite loss.  (d) K2 bit for bit and K3 under
   phase 6's rules at the new extreme row widths (the pre-stage's 13
   columns in float32 and bf16, and the widest gather of the five), timed
   as in phases 3 and 6.
11. the ECD and PGNet families and the PointNet++ baseline: the nine keys
   of ``ECD_KEYS`` at full width, no depth cut, bf16 compute, seeded
   weights, on toy blocks of 8192 points (``ecd_scannet`` under
   ``scannet_config``, without input features; the rest under
   ``s3dis_config``).  Their searches keep per-point overflow slots.
   (a) One ``Trainer`` step of 4 blocks each with a finite loss and both
   kernels' launches as ``ecd_gathers`` counts them per block, then one
   more step timed (train points/s); (b) each key's float32 logits on
   one block agree with the CPU's argmax on at least 0.999 of the valid
   points; (c) K2 bit for bit and K3 under phase 6's rules at the
   narrowest and the widest rows the nine keys gather, timed as in
   phases 3 and 6.
12. the GPN family and ModelNet40 classification at full width, no depth
   cut, bf16 compute, seeded weights.  (a) ``gpn_seg`` (26 anchors, three
   stages at 8192, 4096 and 1024 points, all windowed) takes one
   ``Trainer`` step of 4 toy blocks of 8192 points with a finite loss and
   both kernels' launches as ``gpn_gathers`` counts them per block, then
   one more step timed (train points/s, peak memory); (b) its float32 logits
   on one block agree with the CPU's argmax on at least 0.999 of the
   valid points; (c) ``gpn_modelnet40`` takes ``Trainer`` steps on
   batches of 32 seeded synthetic clouds of 1024 points with the port's
   ``modelnet.prepare_cloud`` features (finite loss, 32 clouds counted,
   clouds/s; no kernel runs: the JAX path builds the classifier's pyramid
   unsorted and levels 1-2 are too small to window), and 8 clouds' float32
   logits agree with the CPU's argmax; (d) the train CLI trains
   ``--config modelnet40`` one epoch from a pkl of (xyz, label) pairs
   with its test epoch (the JAX CLI's record, a finite loss), and
   ``--restore --eval`` gives the test metrics bit for bit; (e) K2 bit for
   bit and K3 under phase 6's rules at stage 0's widest and narrowest
   float32 rows and the widest bf16 row, timed as in phases 3 and 6.
13. the S3DIS composite models at full width, no depth cut, bf16
   compute, seeded weights: the four ``template_*`` keys (pointnet,
   anchor, mlp_anchor and diffusion_anchor convs over three windowed
   levels) and the refine cascade ``refine_s3dis`` (base ECD net, argmax,
   class-pure pyramid, refine net; [2, N, C] logits).  (a) Per key one
   ``Trainer`` step of 4 toy blocks of 8192 points with both kernels'
   launches as ``composite_gathers`` counts them per block, then one more
   step timed, a finite loss at every step (train points/s, peak
   memory); (b) each key's float32 logits on one block agree with the
   CPU's argmax on at least 0.999 of the valid points (both rows of the
   cascade; the class-pure segments' agreement printed beside them);
   (c) one ``refine_s3dis`` step twice from one state is bitwise equal;
   (d) K2 bit for bit and K3 under phase 6's rules at each row width the
   five keys gather (3 columns in bf16 and in float32, 16, 32 and 64
   bf16), timed as in phases 3 and 6; (e) the flagship with
   ``diffusion_steps=3`` sweeps 8 blocks through ``eval_scene_probs``
   (finite probabilities, rows sum to 1), and ``radius_neighbors`` on the
   card and on the CPU agree on at least 0.999 of the valid slots of one
   float32 block; (f) the train CLI trains ``--model refine_s3dis`` 3
   steps with its test epoch and ``--restore --eval`` gives its metrics
   bit for bit, the scene eval labels a prepared room from that
   checkpoint with the refine row, and the train CLI trains the flagship
   3 steps with ``--use-diffusion 3``.
14. the Semantic3D dense and context models at full width, no depth cut,
   bf16 compute, seeded weights, under ``semantic3d_config`` (10,240
   sampled points a block, caps 5120/1280): ``dense_semantic3d``
   (``DenseFeats`` on a dense cloud of 40,960 points, then the
   unfactored ``SEMANTIC3D_DILATE_ARCH`` encoder with per-point overflow
   slots) and ``context_semantic3d`` (the S3DIS ECD net on the block, and
   ``ContextNet`` on a context cloud of up to 512 points), on blocks of
   the seeded outdoor scan read and padded by the ``Provider`` (the dense
   read of ``semantic3d.save_blocks`` blocks; ``prepare_context_scene``
   blocks of the 120 m scene around the scan, the largest context clouds
   first: those above the cap of 512 are cut by ``pad_context``).
   (a) Each key's float32 logits on one block on the card and on the CPU
   agree on at least 0.999 of the valid points' argmax, and for the
   dense model at least 0.999 of the ``knn_in_support`` slots;
   (b) 8 ``Trainer`` steps of 4 blocks on one batch: both kernels'
   launches per block as ``dense_gathers`` / ``context_gathers`` count
   them (``ContextNet`` launches none: alone on the card it counts 0), a
   finite loss at every step that falls, one step twice from one state
   bitwise equal, the non-finite guard, train points/s and peak memory;
   (c) the train CLI trains each key 3 steps with its test epoch from
   ``--data-dir`` pkls (``semantic3d.save_blocks`` for the dense model,
   ``prepare_context_scene`` for the context model), and ``--restore
   --eval`` gives its test metrics bit for bit; (d) ``eval_scene_probs``
   with the key's ``extra_keys`` sweeps 4 blocks: finite probabilities
   whose rows sum to 1; (e) K2 bit for bit and K3 under phase 6's rules at
   each gather shape of the two models (the conv gathers at 10,240, 5120
   and 1280 rows), timed as in phases 3 and 6.
15. a whole Semantic3D scan from raw file to submission, through the
   entry points a user calls, at ``semantic3d_config``'s full width: the
   seeded outdoor scan (482,196 points) written as a ``.txt`` +
   ``.labels`` pair; (a) ``prepare_data`` modes ``semantic3d``,
   ``semantic3d_context`` and ``semantic3d_test --rotations 2`` with 2
   workers, each mode's host seconds; (b) the train CLI trains
   ``pointnet_semantic3d``, ``dense_semantic3d`` (on the ``semantic3d``
   pkl) and ``context_semantic3d`` (on the ``semantic3d_context`` pkl) one
   epoch each, writing checkpoints, K2 and K3 as the launch helpers count
   them per training and test block; (c) each key's float32 logits on one
   test block (with its dense cloud or context window) agree card vs CPU
   on at least 0.999 of the valid points' argmax; (d) the scene eval
   labels the scan: ``pointnet_semantic3d`` with ``--rot-ensemble 2`` (K2
   per block of each arm's own count), the other two keys one arm each,
   every ``.labels`` file 482,196 lines in 1..8, probabilities finite with
   rows summing to 1, dense points/s; (e) on arm 0 of the restored
   ``pointnet_semantic3d``: a repeated sweep is bitwise equal, and the
   device interpolation arm against the native one over every scan point:
   argmax agreement on at least 0.999 of them and the probabilities
   within 1e-3 (the blocks overlap, so the support holds copies of one
   point an ulp apart with other probabilities: the device arm ranks them
   by the native library's rounding of the distances); both arms' seconds
   and the device arm's peak memory.

16. the parallel paths on the one card, at full width (the flagship,
   bf16 compute, seeded weights).  (a) The mesh trainer on phase 7's
   batch: at world size 1 on NCCL in this process, 3 steps whose loss,
   metrics and parameters, and then the logits of block 0, are bitwise
   those of ``Trainer(mesh=None)``; then 2 gloo ranks sharing the card, 2
   blocks each: the step-1 loss within 1e-6 relative, the flat gradient
   within 1e-5 of its largest magnitude (only the order of the 4-block
   sum differs), equal step-1 metrics, parameters bitwise equal across
   the ranks after each of 3 steps, 2 x (16 K2 + 13 K3) launches a rank
   and step; step times and peak memory per rank.  (b) The train CLI's
   default (the mesh, one card, NCCL) and ``--no-mesh``, 3 steps of 4
   blocks with a test epoch: the metrics records equal bit for bit but
   for the throughput, launches as phase 9 counts them.  (c)
   ``scene_apply`` over 4 gloo ranks sharing the card, the flagship in
   float32 on the 32,768-point 48 m corridor of ``halo_study`` (8192
   points a shard), the halo the smallest multiple of 256 at or above
   ``geometric_required_halo`` at the flagship's receptive field (cells of
   its coarsest voxel), so every shard takes the windowed path: in both
   halo modes each rank's logits are within 1e-5 of the largest |logit|
   of the sequential run of the same extended shards on the card (and
   agree on at least 0.999 of the argmax), with the same halo rows and
   masks, probabilities finite with rows summing to 1, K2 16 times a
   shard; in geom mode the card's sequential run agrees with the CPU's
   on at least 0.999 of the argmax (the index mode's shards differ only
   in their halo rows, held exactly above); ungated, the argmax
   agreement with the full-neighbour run (index mode, halo = L),
   seconds, scene points/s and peak memory per rank.  Each group has a
   rendezvous and join timeout.
17. the analysis and tooling layer at full width (the flagship, bf16
   compute, seeded weights), each part's K2/K3 launches counted as the
   entry points' are.  (a) ``verify_search_recall`` on 8192 points, seeds
   0 and 1: the global search's recall of every band at least 0.99, the
   production windowed search's (slab:32:256:256, one K2 for its slab
   read) at least 0.94, against the exact float64 host reference.
   (b) ``capture_activations`` on one toy block of 8192 points (its host
   bytes counted from the shapes first; over 4 GiB it would capture 4096
   points): every module-level key of the flagship present (the model,
   ``encoder/__call__/0`` and ``/1``, each encoder module, the head),
   every value and statistic finite, 16 K2; ``cluster_activations(k=8)``
   on ``encoder/global`` assigns every valid point to 0..7 and dumps one
   6-column line per valid point.  (c) ``profile_step``'s rows (1 warm-up
   and 3 timed calls each) and ``trace_step``'s capture and analysis of 3
   steps of 4 blocks of 8192 points: the trace's kernel rows hold K2's
   kernel 64 times a step and K3's map and sum kernels 52 times each,
   and a positive total.  (d) ``conv_compare``'s 12 flavors at full
   width, 1 epoch of 3 steps of 2 blocks of 2048 points: each record
   with a finite loss and an mIoU and oAcc in [0, 1], each flavor's
   launches as the earlier phases' gather counts give them at 2048
   points.  (e) ``eval_parity`` cut to 2 training rooms, 1 test room and
   1 epoch at 8192 points: both arms' probabilities finite with rows
   summing to 1 and mIoU in [0, 1]; the windowed arm's sweeps launch K2
   16 times a block, the exact arm none.
18. the encoder's shared overflow edge list, the anchored-conv tail, the
   head variants and the geometry ops.  (a) The flagship built with
   ``ov_mode="edges"`` (full width and depth, bf16 compute, seeded
   weights) trains on phase 7's batches: one counted step of 4 x 8192
   points (16 K2 and 13 K3 a block, as in slots mode: the edge rows are
   read by plain indexing), 3 timed steps beside the bench's slots-mode
   step (phase 21, search chunk 2048), 2 steps under ``torch.profiler``
   (PyTorch's index backward's share of kernel time, the top kernels),
   one step twice from one state bitwise equal (the edge reads' backward
   is PyTorch's sort-based index accumulation, no float atomics); on one
   float32 block, every windowed level's search on the
   card and on the CPU from the same pyramid: the valid edge rows
   ((center, nbr) pairs) and each band's windowed slot rows equal on at
   least 0.999, sxyz and d2 of the shared rows within 1e-6, and each
   level's edge demand against its cap; logits argmax on at least 0.999
   of the valid points and the flat gradient's cosine at least 0.999.
   (b) On the windowed neighborhood of level 0's first band of that block
   (the slots-mode search, pooled overflow), float32 forward and
   backward card vs CPU with the same weights: ``AnchorConv``, ``GPNConv``
   (``xyz_feats``, summed, trainable ``pmiu``), ``GPNConvV2`` in both
   modes, the four ``WLWConv`` forms on ``compute_wlw`` weights,
   ``DiffFeatsWLW`` feeding ``WLWConv``, ``covariance_feats`` (gradient in
   xyz) and ``classifier_v2/v4/v5``: outputs within 1e-4 of max(1, the
   largest |value|), flat gradient cosine at least 0.999; and
   ``estimate_normals`` forward, |dot| within 1e-4 of 1 where the
   smallest eigenvalue is isolated.  (c) ``voxel_majority_label`` and
   ``average_downsample`` at the s3dis voxel sizes and caps: integers
   equal, floats within 1e-6.
19. the exact-search training arm and the windowed-vs-exact A/B.  (a) The
   flagship built with the exact global search at every level
   (``Trainer(windowed=False)``, full width and depth, bf16 compute,
   seeded weights) trains on phase 7's batches: one counted step of 4 x
   8192 points and 3 timed ones, none of which launches K2 or K3 (the
   exact arm gathers by plain indexing; a launch would mean the windowed
   path leaked in), beside the bench's windowed step (phase 21, search
   chunk 2048: step s, train points/s, peak memory); one step twice from
   one state bitwise equal;
   on one float32 block, card vs CPU, every level's exact search slot for
   slot (at least 0.999 of the valid slots equal), logits argmax on at
   least 0.999 of the valid points and the flat gradient's cosine at
   least 0.999.  (b) ``parity_ab.main`` cut to ``--arms windowed exact
   --hard``, 2 train rooms, 1 test room and 1 epoch of the flagship at
   8192 points: both arms' keys and the deltas (each the difference of
   the arms' values), every last train loss finite, the card in the
   JSON; the windowed arm's launches as its trained and tested blocks
   count them, the exact arm's none.
20. the search modes and the encoder settings, on phase 4's first toy
   room block (Morton-sorted, caps 4096/1024) and phase 7's batches, full
   width and depth, bf16 compute, seeded weights.  (a) The windowed
   search's global selection (64 candidates, overflow pool 0 and 256,
   slots and edges) at levels 0 and 1, card vs CPU from the same
   pyramid: at least 0.999 of the valid slots equal, and in edges mode of
   the edge rows, their geometry within 1e-6; ``verify_search_recall
   --grid`` on the card (8192 points, seeds 0 and 1): the global contract
   rows at least 0.99, the selection study's slab rows at least 0.94,
   its global rows printed beside them.  (b) The wide overflow tier
   (``ov_window=1024``, global selection) at level 0, slot for slot card
   vs CPU, and ``gather_neighbors`` of F=64 bf16 features on it forward
   (bitwise the CPU's) and backward: K2 bit for bit and K3 under phase
   6's rules at the tier's slab of 2304 rows (K2's column-chunk path, K3's
   third radix pass), and K2 at the global selection's geometry read,
   timed as in phases 3 and 6.  (c) The flagship under
   ``build_model(cfg, sel_mode="global", win_cand_k=64)`` (the JAX
   build's ``PCS_SEL_MODE=global PCS_CAND_K=64``): a served block, 4
   counted training steps on one batch with a finite loss that falls,
   one step twice from one state bitwise equal, float32 card vs CPU
   (argmax on at least 0.999 of the valid points, gradient cosine at
   least 0.999), K2 and K3 as counted per block.  (d) One step with
   ``remat=True`` beside one with ``remat=False`` from the same state:
   the parameters afterwards compared bit for bit, each step's time (the
   median of 3 more runs of it) and peak memory, K2 a block with the
   gathers the backward recomputes.
   (e) ``fast_conv=False`` (the plain ``PointNetConv`` for every concat
   conv): a served block, one step beside the fast conv's (time, peak
   memory), float32 card vs CPU as in (c).
21. the flagship bench (``python -m pointcloudsegmentation_tpu_torch.bench``,
   its ``main`` in-process at its defaults: 3 warm-up steps and 3 chains
   of 20 of 4 x 8192 points, full width, search chunk 2048, then one warm
   and 3 timed sweeps of its 8-block eval scene): the final line's seven
   keys of the repo-root ``bench.py``, each value finite and positive,
   ``mfu`` below 1 and at 4 significant figures; ``flops_per_step``
   (``Trainer.step_flops`` on the card) equal to the same count taken on
   the CPU for the same config and batch; K2 and K3 launched as every
   step's blocks, every sweep's blocks and the count's one training block
   give them.  It runs after phase 8: phases 18 and 19 set their steps
   beside its train step and peak memory, and its train and eval points/s
   and peak memory are the ones the summary line gives.
22. the measurement tools, in-process at full width.  (a) ``ab_arms``
   with three arms on the flagship (8192 points, 4 blocks, search chunk
   2048, ``iters`` 2): ``base``, whose K2 and K3 launches are its 9
   steps' blocks' (``per_block``), ``exact`` (``{"PCS_DISABLE_WINDOWED":
   "1"}``), which launches neither, and ``vmap`` (``PCS_BATCH_VMAP``, an
   XLA batch strategy the port refuses): its error line shows, the later
   arm still runs and the tool returns 1; the two result lines carry the
   JAX keys in the JAX order with finite, positive numbers.
   (b) ``model_breakdown --which conv``, ``sort`` and ``model``, (c)
   ``microbench --which all --reps 4``: every row's ms (and its CUDA-graph
   ms where the op could be captured) finite and positive; each row's K2
   and K3 launches equal to its op's launches (K2 once a windowed conv
   call and the flagship block's forward counts, K3 once a windowed conv
   backward and the training block's counts; none in the plain conv rows,
   the sort and pyramid rows and every microbench row) times the calls
   that its timing made (``reps`` x 6 chained, one to find whether it
   synchronises with the host, and 3 + ``reps`` for the graph where it
   does not; a call that stopped at a synchronisation may have launched
   part of its kernels); every row template of the JAX script's functions
   that were run (read from ``scripts/`` with ``ast``) matches a row label.

Prints one JSON line describing the kernels (launches on their phase's
path, error, kernel, plain, bound and one-call library milliseconds), then
the card's name and power limit, and as the last line ``{"ok": true,
"device": {...}}``.  Exits
non-zero without that line when there is no CUDA device or a phase fails.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_POINTS = 8192
N_BLOCKS = 8
TRAIN_BLOCKS = 4            # blocks per training step (bench.py's batch)
# what a phase must meet
PARITY_NBR_MIN = 0.999      # share of valid neighbor slots equal, card vs CPU
PARITY_ARGMAX_MIN = 0.99    # share of points with equal logit argmax
PROB_SUM_TOL = 1e-3
CLI_STEPS = 3               # phase 9: train and test steps of each CLI run
SEM3D_POINTS = 10240        # phase 10: semantic3d_config's point budget
SEM3D_KEYS = ("pointnet_semantic3d", "pointnet_semantic3d_dilate")
S3DIS_KEYS = ("pointnet_baseline20", "pointnet_concat10_deconv",
              "pointnet_embed_only")
METRICS_KEYS = {"epoch", "train_loss", "lr", "miou", "oiou", "oacc", "iou",
                "acc", "points_per_sec"}   # the JAX CLI's epoch record
# phase 11: the ECD and PGNet families and the PointNet++ baseline
# (ecd_scannet on scannet_config, the rest on s3dis_config)
ECD_KEYS = ("ecd_scannet", "ecd_s3dis", "pgnet_v3", "pgnet_v4", "pgnet_v5",
            "pgnet_v6", "pgnet_v7", "pgnet_v8", "pointnet2_s3dis")
ECD_ARGMAX_MIN = 0.999      # share of valid points with equal logit argmax
MODELNET_POINTS = 1024      # phase 12: points per ModelNet40 cloud
MODELNET_BATCH = 32         # clouds per classification training step
MODELNET_PARITY = 8         # clouds in the float32 card-vs-CPU check
MODELNET_CLI_CLOUDS = 16    # clouds in the CLI's pkl
MODELNET_CLI_BATCH = 8
# phase 13: the S3DIS composite models
COMPOSITE_KEYS = ("template_pointnet", "template_anchor",
                  "template_mlp_anchor", "template_diffusion_anchor",
                  "refine_s3dis")
DIFFUSION_STEPS = 3         # the flagship's --use-diffusion in phase 13
# phase 14: the Semantic3D dense and context models (semantic3d_config)
S3D_PIPELINE_KEYS = ("dense_semantic3d", "context_semantic3d")
# training steps on one batch, the loss falling from the first to the last:
# from Glorot weights at lr 1e-3 Adam's early steps overshoot on one batch
# (each key's loss rises at one of its first 4 steps), so 8 let the trend show
S3D_PIPELINE_STEPS = 8
# phase 15: a Semantic3D scan from raw file to submission
SCAN_KEYS = ("pointnet_semantic3d", "dense_semantic3d", "context_semantic3d")
SCAN_ROTATIONS = 2          # rotated arms of pointnet_semantic3d's ensemble
SCAN_WORKERS = 2            # prep processes
SCAN_KNN = 6                # the scene eval's k (its default)
INTERP_ARGMAX_MIN = 0.999   # device vs native interpolation over every scan
INTERP_PROB_TOL = 1e-3      # point: argmax agreement and largest |dp|
# phase 16: the parallel paths on the one card
P16_STEPS = 3               # training steps of each mesh configuration
P16_GLOO_RANKS = 2          # trainer ranks sharing the card over gloo
P16_SCENE_RANKS = 4         # scene_apply ranks sharing the card over gloo
P16_SCENE_POINTS = 32768    # the corridor: 4 shards of 8192 points
P16_SHARD = P16_SCENE_POINTS // P16_SCENE_RANKS
P16_SCENE_LENGTH = 48.0     # metres (scripts/halo_study.py's corridor)
P16_SORT_CELL = 0.2         # scene_apply's Morton cell (the study's)
P16_LOSS_RTOL = 1e-6        # gloo ranks vs one process: step-1 loss
P16_GRAD_REL = 1e-5         # ... flat gradient, of its largest |g|
P16_TIMEOUT = 300           # seconds: each group's rendezvous, collectives
#                             and join
SCENE_ARGMAX_MIN = 0.999    # scene_apply vs the sequential run (float32)
P16_LOGIT_REL = 1e-5        # ... its logits, of max(1, the largest |logit|)
# phase 17: the analysis and tooling layer
P17_RECALL_SEEDS = (0, 1)   # verify_search_recall's seeds
P17_CAPTURE_MAX_BYTES = 4 * 2**30   # host bytes of one block's activations
P17_WARMUP, P17_ITERS = 1, 3        # profile_step's rows (cut from 2, 10)
P17_TRACE_KERNELS = ("window_gather_kernel", "window_dslab_map_kernel",
                     "window_dslab_sum_kernel")
P17_CC_POINTS, P17_CC_STEPS, P17_CC_BATCH = 2048, 3, 2   # conv_compare
P17_EP_TRAIN_ROOMS, P17_EP_TEST_ROOMS, P17_EP_EPOCHS = 2, 1, 1  # eval_parity
P17_EXACT_ARM = {}          # the exact arm gathers by plain indexing
# phase 18: the overflow edge list, the conv tail and the helpers
EDGE_TIMED_STEPS = 3        # edges-mode train steps timed after the first
EDGE_ROW_MIN = 0.999        # edge rows, slot rows, argmax: card vs CPU
EDGE_GEO_TOL = 1e-6         # the shared edge rows' sxyz and d2
P18_PROFILED_STEPS = 2      # edges-mode train steps under torch.profiler
P18_TOP = 8                 # ... kernels listed by device time
P18_ANCHORS = 8             # anchors of the tail's anchored convs
P18_TAIL_TOL = 1e-4         # tail outputs, of max(1, the largest |value|)
P18_HELPER_TOL = 1e-6       # average_downsample's centers and features
# phase 19: the exact-search training arm and the parity A/B
P19_TIMED_STEPS = 3         # exact-arm train steps timed after the first
P19_AB_TRAIN_ROOMS, P19_AB_TEST_ROOMS, P19_AB_EPOCHS = 2, 1, 1  # parity_ab
# phase 20: the search modes and the encoder settings
P20_LEVELS = (0, 1)         # the global search's levels
P20_POOLS = (0, 256)        # ... its ov_pool_size
P20_CAND_K = 64             # ... its candidates
P20_OV_WINDOW = 1024        # the wide tier: 4 windows (JAX search.py:618-625)
P20_GLOBAL = dict(sel_mode="global", win_cand_k=64)   # PCS_SEL_MODE=global
#                                                       PCS_CAND_K=64
P20_STEPS = 4               # training steps of the global flagship
P20_TIMED_STEPS = 3         # (d), (e): the step again, timed; the median
# training steps timed after the counted first (phases 11-13; 3 until the
# measurement tools' phase 22 needed the time)
ECD_TIMED_STEPS = 1
DSLAB_F32_RTOL = 1e-6       # slab-gradient kernel vs plain, float32
GRAD_COSINE_MIN = 0.999     # flat gradient, float32 card vs CPU
K1_F32_RTOL = 1e-5          # fused conv vs plain, of the sum of magnitudes
K1_BF16_ULPS = 2            # fused conv vs plain, of the largest activation
FUSED_VS_UNFUSED_REL = 2.0 ** -6   # bench cross-check, of the largest output
ARM_ITERS = 20              # timed calls of each bench arm
# K1 on seeded random inputs, bf16, tile 256: (N, K, dims, window).  The
# flagship's other conv shapes and the tests' widths under 8 take the
# kernel's compile-time geometry; odd widths (with a window that leaves the
# last slab range unaligned for the TMA) and wide ones (a slab too long for
# shared memory, read from L2) take its table-driven geometry.
K1_CASES = ((4096, 24, (16, 16, 16, 48), 256), (8192, 16, (8, 8, 16, 32), 256),
            (2048, 8, (4, 4, 8), 256), (2048, 20, (3, 5, 7), 253),
            (1024, 16, (32, 32, 64, 128), 256))
# the card's peaks (H100 SXM data sheet, dense) and memory rate
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def log(msg=""):
    print(msg, flush=True)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes, flops, dtype):
    """The least time the card could take: bytes at the HBM rate or
    operations at the peak for ``dtype``, whichever is larger."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3 if flops else 0.0
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else \
        "operations"


def phase_device():
    import torch

    from pointcloudsegmentation_tpu_torch.utils.timing import card as card_name

    card = card_name()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"[device] nvidia-smi: {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{kind}; device_count={torch.cuda.device_count()}")
    log("[device] TF32 off for matmul and cuDNN (float32 is float32)")
    return card, kind


def phase_build():
    from pointcloudsegmentation_tpu_torch.data import native
    from pointcloudsegmentation_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    for name, built in _build.build_all(force=True).items():
        log(f"[build] {name}.cu -> sm_90a in {built.seconds:.2f} s; ptxas:")
        for line in built.log.splitlines():
            if "ptxas" in line and ("Used" in line or "spill" in line
                                    or "stack" in line):
                log(f"    {line.strip()}")
    log(f"[build] {len(_build.SOURCES)} kernels (one nvcc each, in "
        f"parallel) in {time.perf_counter() - t0:.2f} s")
    built = native.build(force=True)
    log(f"[build] native host library (g++ {os.path.relpath(native.SOURCE, ROOT)}"
        f" -> {os.path.relpath(built.path, ROOT)}) in {built.seconds:.2f} s")


def windowed_convs(model, cfg):
    """(level, K, F, grad) of every conv of the model that gathers
    features on a windowed level, in the order they run: Semantic3D's
    pre-stage at level 1 first, then each stage's convs but the xyz-only
    ones (they gather nothing).  F is a fast conv's ΣD, or the width of
    the features a PointNetConv gathers; grad says whether the gathered
    tensor takes a gradient, so that a training step's backward runs the
    slab-gradient kernels on it: not where a PointNetConv gathers the raw
    input features (the pre-stage, and a first conv without an embed)."""
    from pointcloudsegmentation_tpu_torch.models.layers import PointNetConv

    enc = model.encoder
    sizes = (cfg.data.num_points,) + tuple(cfg.data.caps)
    ps = enc.arch.pre_stage
    convs = []
    if ps is not None:
        convs.append((1, ps.k, (enc.feats_pre.fc_0.in_features - 3) // 2,
                      False))
    i = 0
    for s, stage in enumerate(enc.arch.stages):
        for j, c in enumerate(stage.convs):
            conv = getattr(enc, f"feats{i}")
            i += 1
            if c.nofeats:
                continue
            if isinstance(conv, PointNetConv):
                raw = s == 0 and j == 0 and c.embed is None and ps is None
                convs.append((s, c.k, (conv.fc_0.in_features - 3) // 2,
                              not raw))
            else:
                convs.append((s, c.k, conv.offs[-1], True))
    return [cv for cv in convs if sizes[cv[0]] % enc.win_tile == 0
            and sizes[cv[0]] >= 4 * enc.win_tile]


def gather_shapes(model, cfg):
    """(name, N, K, F, dtype) of every window-gather launch the model's
    forward makes, per windowed level: the search's xyzm read (K = its
    candidate pool) and each gathering conv's gather (``windowed_convs``),
    in the model's compute dtype."""
    import torch

    from pointcloudsegmentation_tpu_torch.ops import search

    enc = model.encoder
    sizes = (cfg.data.num_points,) + tuple(cfg.data.caps)
    convs = windowed_convs(model, cfg)
    shapes = []
    for s in range(len(enc.arch.stages)):
        n = sizes[s]
        if n % enc.win_tile or n < 4 * enc.win_tile:
            continue
        bands = [(mn, mx, k) for mx, mn, k in dict.fromkeys(
            enc.stage_specs(s))]
        ck = search.effective_win_cand_k(enc.win_cand_k, enc.cand_k, bands,
                                         n)
        shapes.append((f"L{s} search xyzm", n, ck, 4, torch.float32))
        shapes.extend((f"L{s} conv", n, k, f, enc.dtype or torch.float32)
                      for lvl, k, f, _ in convs if lvl == s)
    return shapes


def per_block(cfg, **encoder_kw):
    """Kernel launches per block of a forward and of a training step of
    ``cfg``'s model built with ``encoder_kw``: K2 at every gather of
    ``gather_shapes`` (with ``remat=True`` again at each windowed conv's
    gather, which the backward recomputes), and in the backward K3 (map
    and sum kernels) at every windowed gather that takes a gradient."""
    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    model = build_model(cfg, None, "cpu", **encoder_kw)
    enc = model.encoder
    gathers = len(gather_shapes(model, cfg))
    trained = sum(grad for *_, grad in windowed_convs(model, cfg))
    sizes = (cfg.data.num_points,) + tuple(cfg.data.caps)
    recomputed = sum(
        1 for s, st in enumerate(enc.arch.stages) for c in st.convs
        if not (c.nofeats or c.noconcat) and sizes[s] % enc.win_tile == 0
        and sizes[s] >= 4 * enc.win_tile) if enc.remat else 0
    return ({"window_gather": gathers},
            {"window_gather": gathers + recomputed, "window_dslab": trained,
             "window_dslab_map": trained})


def times(counts, n):
    return {k: v * n for k, v in counts.items()}


def plus(a, b):
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def path_neighborhoods(model, cfg, xyz, mask):
    """(level, (radius, min_radius, K), neighborhood) of every conv band
    the flagship's search gives one block: the Morton sort, the pyramid and
    each stage's multi-band search, as the encoder runs them."""
    from pointcloudsegmentation_tpu_torch.ops import hierarchy, morton

    enc = model.encoder
    xs, ms, _ = morton.sort_block(xyz, mask, cfg.data.voxel_sizes[0] / 4,
                                  cfg.data.block_size)
    pyr = hierarchy.build_pyramid(xs, ms, cfg.data.voxel_sizes, cfg.data.caps,
                                  cfg.data.block_size, morton_sorted=True)
    out = []
    for s, stage in enumerate(enc.arch.stages):
        specs = [(c.radius, c.min_radius, c.k) for c in stage.convs]
        res = enc._stage_neighborhoods(pyr.levels[s].xyz, pyr.levels[s].mask,
                                       specs, pyr.level_sorted(s))
        out.extend((s, spec, nb) for spec, (nb, *_) in res.items())
    return out


def path_lidx(model, cfg):
    """(name, lidx [N, K], F) of each windowed conv band at levels 0 and 1
    on the first toy block (seed 0): the slab indices the flagship's search
    gives the window gather, F the width of the band's first conv."""
    import torch

    b = make_blocks("cuda")[0][0]
    with torch.no_grad():
        nbs = path_neighborhoods(model, cfg, b["xyz"], b["mask"])
    widths = {}
    for s, stage in enumerate(model.encoder.arch.stages):
        for c in stage.convs:
            widths.setdefault((s, (c.radius, c.min_radius, c.k)),
                              sum(c.fc_dims) + c.out)
    return [(f"L{s} path r={spec[0]:g} K={spec[2]}", nb.lidx.contiguous(),
             widths[(s, spec)]) for s, spec, nb in nbs
            if s <= 1 and hasattr(nb, "lidx")]


def k2_case(name, feats, lidx, window, tile, card):
    """K2 against its plain version on one input, bit for bit, then timed
    beside its bound and ``index_select``."""
    import torch

    from pointcloudsegmentation_tpu_torch.kernels import window_gather as wg
    from pointcloudsegmentation_tpu_torch.utils.timing import cuda_ms, graph_ms

    (n, f), k, dtype = feats.shape, lidx.shape[1], feats.dtype
    got = wg.gather_fwd(feats, lidx, window, tile)
    want = wg.gather_fwd_reference(feats, lidx, window, tile)
    torch.cuda.synchronize()
    check(torch.equal(got, want),
          f"kernel != plain at {name} N={n} K={k} F={f} {dtype}")
    err = (got.float() - want.float()).abs().max().item()
    kernel = lambda: wg.gather_fwd(feats, lidx, window, tile)  # noqa: E731
    plain = lambda: wg.gather_fwd_reference(  # noqa: E731
        feats, lidx, window, tile)
    # one PyTorch call for the same gather: pad and row ids built outside
    fp_pad = torch.nn.functional.pad(feats, (0, 0, window, window))
    rowid = ((torch.arange(n, device="cuda") // tile * tile)[:, None]
             + lidx).reshape(-1)
    library = lambda: fp_pad.index_select(0, rowid)  # noqa: E731
    eager_ms, eager_plain_ms = cuda_ms(kernel), cuda_ms(plain)
    ms, plain_ms = graph_ms(kernel), graph_ms(plain)
    library_ms = graph_ms(library)
    bound, bound_by = bound_ms(nbytes(feats, lidx, got), 0, dtype)
    mb = n * k * f * feats.element_size() / 1e6
    log(f"[kernel] {name:18s} N={n:5d} K={k:2d} F={f:3d} "
        f"{str(dtype):14s} equal; device ms (graph replay): kernel "
        f"{ms:.4f} ({mb / ms:.1f} GB/s written, {bound / ms:.3f} of the "
        f"bound), plain {plain_ms:.4f}, index_select {library_ms:.4f}, "
        f"bound {bound:.4f} ({bound_by}); eager ms: kernel {eager_ms:.4f}, "
        f"plain {eager_plain_ms:.4f} [{card}]")
    return dict(name=name, n=n, k=k, f=f, dtype=str(dtype),
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=library_ms)


def phase_kernel(model, cfg, card):
    import torch

    tile, window = model.encoder.win_tile, model.encoder.win_window
    s = tile + 2 * window
    gen = torch.Generator(device="cuda").manual_seed(0)
    seen, rows = set(), []
    for name, n, k, f, dtype in gather_shapes(model, cfg):
        if (n, k, f, dtype) in seen:
            continue
        seen.add((n, k, f, dtype))
        feats = torch.randn((n, f), generator=gen, device="cuda").to(dtype)
        lidx = torch.randint(0, s, (n, k), generator=gen, device="cuda",
                             dtype=torch.int32)
        lidx[:, 0] = 0          # the zero rows before the block's start
        lidx[:, -1] = s - 1     # ... and past its end
        rows.append(k2_case(name, feats, lidx, window, tile, card))
    for name, lidx, f in path_lidx(model, cfg):
        feats = torch.randn((lidx.shape[0], f), generator=gen,
                            device="cuda").to(model.encoder.dtype)
        rows.append(k2_case(name, feats, lidx, window, tile, card))
    return rows


def make_blocks(device):
    """The bench's eval scene (``bench.eval_scene``, seed 0): 8 synthetic
    rooms of N_POINTS points, their arrays on ``device``, and the dense
    cloud 4 times as dense near the sampled surfaces."""
    import numpy as np
    import torch

    from pointcloudsegmentation_tpu_torch.bench import eval_scene

    blocks, dense = eval_scene(N_POINTS, np.random.RandomState(0))
    check(len(blocks) == N_BLOCKS, f"{len(blocks)} eval blocks")
    return [dict(b, **{k: torch.from_numpy(b[k]).to(device)
                       for k in ("xyz", "feats", "mask")})
            for b in blocks], dense


def phase_serve(model, cfg):
    import numpy as np
    import torch

    from pointcloudsegmentation_tpu_torch.eval.interpolate import (
        eval_scene_probs, interpolate_to_dense)
    from pointcloudsegmentation_tpu_torch.kernels import window_gather as wg

    blocks, dense = make_blocks("cuda")
    eval_scene_probs(model, blocks[:1])          # warm-up
    torch.cuda.synchronize()

    per_block = len(gather_shapes(model, cfg))
    wg.gather_fwd.launches = 0
    sxyz, probs = eval_scene_probs(model, blocks)
    launches = wg.gather_fwd.launches
    dprobs = interpolate_to_dense(sxyz, probs, dense, k=6)
    log(f"[serve] window-gather launches over the sweep: {launches} "
        f"({launches / N_BLOCKS:g} per block, expected {per_block})")
    check(launches == per_block * N_BLOCKS,
          f"{launches} launches, expected {per_block} x {N_BLOCKS}")
    check(probs.shape == (N_BLOCKS * N_POINTS, 13), f"probs {probs.shape}")
    check(np.isfinite(probs).all(), "non-finite probs")
    dev = np.abs(probs.sum(1) - 1.0).max()
    check(dev <= PROB_SUM_TOL, f"probs rows sum to 1 +- {dev}")
    check(dprobs.shape == (len(dense), 13) and np.isfinite(dprobs).all(),
          f"dense probs {dprobs.shape}")
    ddev = np.abs(dprobs.sum(1) - 1.0).max()
    check(ddev <= PROB_SUM_TOL, f"dense probs rows sum to 1 +- {ddev}")
    log(f"[serve] probs {probs.shape} finite, rows sum to 1 +- {dev:.2e}; "
        f"dense {dprobs.shape} rows sum to 1 +- {ddev:.2e}")
    return launches


def phase_parity(serve, cfg, block, card):
    import dataclasses

    import torch

    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    xyz, feats, mask = block
    # bitwise repeatability of the serving model (bf16) on the card
    with torch.inference_mode():
        a = serve(xyz.to("cuda"), feats.to("cuda"), mask.to("cuda"))
        b = serve(xyz.to("cuda"), feats.to("cuda"), mask.to("cuda"))
    check(torch.equal(a, b), "logits differ between two runs on the card")
    log(f"[parity] same block twice on the card: logits bitwise equal "
        f"({a.dtype})")

    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(f32, torch.Generator().manual_seed(0), dev).eval()
        with torch.inference_mode():
            x, m, f = xyz.to(dev), mask.to(dev), feats.to(dev)
            logits = model(x, f, m).cpu()
            nbrs = []
            for s, spec, nb in path_neighborhoods(model, cfg, x, m):
                nb = nb.to_neighborhood() if hasattr(
                    nb, "to_neighborhood") else nb
                nbrs.append((f"L{s} {spec}", nb.idx.cpu(), nb.mask.cpu()))
        out[dev] = (logits, nbrs)
    total = bad = 0
    for (name, gi, gm), (_, ci, cm) in zip(out["cuda"][1], out["cpu"][1]):
        valid = gm | cm
        diff = valid & ((gm != cm) | (gi != ci))
        total += int(valid.sum())
        bad += int(diff.sum())
        log(f"[parity] {name}: {int(diff.sum())} of {int(valid.sum())} "
            f"valid slots differ")
    share = 1.0 - bad / max(total, 1)
    log(f"[parity] neighbor slots card vs CPU: {bad} of {total} differ "
        f"({share:.6f} equal, need >= {PARITY_NBR_MIN})")
    check(share >= PARITY_NBR_MIN, f"neighbor parity {share}")
    gl, cl = out["cuda"][0], out["cpu"][0]
    agree = (gl.argmax(1) == cl.argmax(1)).float().mean().item()
    dmax = (gl - cl).abs().max().item()
    log(f"[parity] float32 logits card vs CPU: argmax agreement {agree:.6f} "
        f"(need >= {PARITY_ARGMAX_MIN}), max |dlogit| {dmax:.3e} [{card}]")
    check(agree >= PARITY_ARGMAX_MIN, f"argmax agreement {agree}")
    return bad, total


def bf16_ulp(x):
    """One bfloat16 ulp at each element of float32 ``x`` (8 bits of
    mantissa); the smallest normal's ulp at zero."""
    import torch

    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def k3_case(name, g, lidx, window, tile, card):
    """K3's map kernel against its plain version bit for bit, then K3
    against its plain version: two runs bitwise equal, float32 within
    DSLAB_F32_RTOL relative, bf16 within one bf16 ulp; both timed beside
    their bounds and one PyTorch call each."""
    import torch

    from pointcloudsegmentation_tpu_torch.kernels import window_gather as wg
    from pointcloudsegmentation_tpu_torch.utils.timing import cuda_ms, graph_ms

    (n, k, f), dtype = g.shape, g.dtype
    s = tile + 2 * window
    what = f"{name} N={n} K={k} F={f} {dtype}"
    start, order = wg.dslab_map(lidx, window, tile)
    rstart, rorder = wg.dslab_map_reference(lidx, window, tile)
    got = wg.dslab_bwd(g, lidx, window, tile)
    again = wg.dslab_bwd(g, lidx, window, tile)
    want = wg.dslab_bwd_reference(g, lidx, window, tile)
    torch.cuda.synchronize()
    check(torch.equal(start, rstart) and torch.equal(order, rorder),
          f"slab-gradient map kernel != plain at {what}")
    check(torch.equal(got, again),
          f"slab-gradient kernel not repeatable at {what}")
    d = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        bound = DSLAB_F32_RTOL * want.abs()
        stated = f"<= {DSLAB_F32_RTOL:g} relative"
    else:
        bound = bf16_ulp(want.float())
        stated = "<= 1 bf16 ulp"
    n_diff = int((d > 0).sum())
    check(bool((d <= bound).all()),
          f"slab-gradient kernel != plain at {what}: "
          f"{int((d > bound).sum())} elements beyond {stated}")
    err = d.max().item()
    kernel = lambda: wg.dslab_bwd(g, lidx, window, tile)  # noqa: E731
    plain = lambda: wg.dslab_bwd_reference(  # noqa: E731
        g, lidx, window, tile)
    # one PyTorch call for the same sums (atomic, not repeatable: timed
    # only); segment ids, the float32 copy of g and the sums' buffer made
    # outside
    lid = lidx.reshape(-1).long()
    seg = torch.where(
        (lid >= 0) & (lid < s),
        torch.arange(n * k, device="cuda") // (tile * k) * s + lid,
        torch.full_like(lid, n // tile * s))
    g32 = g.reshape(-1, f).float()
    sums = torch.zeros(n // tile * s + 1, f, dtype=torch.float32,
                       device="cuda")
    library = lambda: sums.zero_().index_add_(0, seg, g32)  # noqa: E731
    eager_ms, eager_plain_ms = cuda_ms(kernel), cuda_ms(plain)
    ms, plain_ms = graph_ms(kernel), graph_ms(plain)
    library_ms = graph_ms(library)
    # the sums: one add per element of g
    bound_t, bound_by = bound_ms(nbytes(g, lidx, got), g.numel(), dtype)
    # the map alone, beside a stable sort of the same keys per tile
    key = torch.where((lid >= 0) & (lid < s), lid,
                      torch.full_like(lid, s)).reshape(n // tile, tile * k)
    map_ms = graph_ms(lambda: wg.dslab_map(lidx, window, tile))
    map_plain_ms = graph_ms(lambda: wg.dslab_map_reference(lidx, window,
                                                           tile))
    sort_ms = graph_ms(lambda: torch.sort(key, dim=1, stable=True))
    map_bound, map_by = bound_ms(nbytes(lidx, start, order), 0, torch.int32)
    mb = (g.numel() + want.numel()) * g.element_size() / 1e6
    log(f"[dslab] {name:18s} N={n:5d} K={k:2d} F={f:3d} {str(dtype):14s} "
        f"map equal, repeatable; {n_diff} of {d.numel()} elements differ "
        f"from plain (max {err:.3e}, {stated}); device ms (graph replay): "
        f"kernel {ms:.4f} ({mb / ms:.1f} GB/s read+written, "
        f"{bound_t / ms:.3f} of the bound; map kernel alone {map_ms:.4f}), "
        f"plain {plain_ms:.4f}, index_add_ {library_ms:.4f}, bound "
        f"{bound_t:.4f} ({bound_by}); map: plain {map_plain_ms:.4f}, "
        f"stable sort {sort_ms:.4f}, bound {map_bound:.4f} ({map_by}); "
        f"eager ms: kernel {eager_ms:.4f}, plain {eager_plain_ms:.4f} "
        f"[{card}]")
    return dict(name=name, n=n, k=k, f=f, dtype=str(dtype),
                max_abs_err=err, n_diff=n_diff, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_t, bound_by=bound_by, library_ms=library_ms,
                map=dict(max_abs_err=0.0, ms=map_ms, plain_ms=map_plain_ms,
                         bound_ms=map_bound, bound_by=map_by,
                         library_ms=sort_ms))


def kernel_cases(cases, seed, card):
    """K2 (``k2_case``) and K3 (``k3_case``) at each (name, N, K, F, dtype)
    of ``cases``, on seeded random slab indices that read the slab's first
    and last rows and one row from a third of the slots.  Returns (K2
    rows, K3 rows)."""
    import torch

    tile = window = 256
    s = tile + 2 * window
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k2_rows, k3_rows = [], []
    for name, n, k, f, dtype in cases:
        lidx = torch.randint(0, s, (n, k), generator=gen, device="cuda",
                             dtype=torch.int32)
        lidx[:, 0] = 0
        lidx[:, -1] = s - 1
        lidx[::3, 1] = 7
        feats = torch.randn((n, f), generator=gen, device="cuda").to(dtype)
        k2_rows.append(k2_case(name, feats, lidx, window, tile, card))
        g = torch.randn((n, k, f), generator=gen, device="cuda").to(dtype)
        k3_rows.append(k3_case(name, g, lidx, window, tile, card))
    return k2_rows, k3_rows


def phase_dslab(model, cfg, card):
    """The slab-gradient kernels against their plain versions at each conv
    shape of the flagship (bf16), the L0 K=32 shape in float32, and the
    search's own indices at levels 0 and 1 (bf16)."""
    import torch

    tile, window = model.encoder.win_tile, model.encoder.win_window
    s = tile + 2 * window
    gen = torch.Generator(device="cuda").manual_seed(1)
    convs = [sh for sh in gather_shapes(model, cfg) if sh[0].endswith("conv")]
    cases = list(dict.fromkeys((n, k, f, dt) for _, n, k, f, dt in convs))
    cases.append(cases[0][:3] + (torch.float32,))
    names = {(n, k, f): name for name, n, k, f, _ in convs}
    rows = []
    for n, k, f, dtype in cases:
        g = torch.randn((n, k, f), generator=gen, device="cuda").to(dtype)
        lidx = torch.randint(0, s, (n, k), generator=gen, device="cuda",
                             dtype=torch.int32)
        lidx[:, 0] = 0          # the slab's first row ...
        lidx[:, -1] = s - 1     # ... and its last
        lidx[::3, 1] = 7        # one row read by a third of the slots
        lidx[::2, 2] = lidx[::2, 3]      # many repeated rows
        rows.append(k3_case(names[(n, k, f)], g, lidx, window, tile, card))
    for name, lidx, f in path_lidx(model, cfg):
        g = torch.randn((lidx.shape[0], lidx.shape[1], f), generator=gen,
                        device="cuda").to(model.encoder.dtype)
        rows.append(k3_case(name, g, lidx, window, tile, card))
    return rows


def backward_determinism(card):
    """The backward of each indexing and segment op of the training path,
    run twice at flagship-like sizes on the card: bitwise equal or fail."""
    import torch

    from pointcloudsegmentation_tpu_torch.ops import neighbors, segments

    gen = torch.Generator(device="cuda").manual_seed(2)
    n, v, f, nt, p, ko = 8192, 4096, 64, 32, 256, 8
    seg = torch.randint(0, v + 1, (n,), generator=gen, device="cuda")
    seg[: n // 4] = 5                     # one crowded voxel (ties in max)
    pool_idx = torch.randint(0, n, (nt, p), generator=gen, device="cuda",
                             dtype=torch.int32)
    ov_idx = torch.randint(0, p + 1, (n, ko), generator=gen, device="cuda",
                           dtype=torch.int32)
    x = torch.randn((n, f), generator=gen, device="cuda")
    x[: n // 8] = 1.0                     # tied maxima split the gradient
    xv = torch.randn((v, f), generator=gen, device="cuda")
    ops = {
        "segment_sum (sort + segment_reduce)":
            (x, lambda t: segments.segment_sum(t, seg, v)),
        "segment_max (scatter_reduce amax)":
            (x, lambda t: segments.segment_max(t, seg, v)),
        "segment_unpool (index)":
            (xv, lambda t: segments.segment_unpool(t, seg)),
        "pool gather feats[pool_idx] (index)":
            (x, lambda t: t[pool_idx.reshape(-1).long()]),
        "pool_take flat[ppos + tbase] (index)":
            (x[: nt * p].reshape(nt, p, f),
             lambda t: neighbors.pool_take(t, ov_idx, n // nt)),
    }
    for name, (inp, fn) in ops.items():
        grads = []
        for _ in range(2):
            t = inp.detach().clone().requires_grad_()
            out = fn(t)
            cot = torch.randn(out.shape, device="cuda",
                              generator=torch.Generator(device="cuda")
                              .manual_seed(3))
            out.backward(cot)
            grads.append(t.grad)
        torch.cuda.synchronize()
        check(torch.equal(grads[0], grads[1]),
              f"backward of {name} differs between two runs")
        log(f"[train] backward of {name}: bitwise equal in two runs "
            f"[{card}]")


def make_train_batches(device):
    """bench.py's training input: 2 batches of 4 synthetic S3DIS-shaped
    blocks of 8192 points (toy.toy_batches, seed 0)."""
    from pointcloudsegmentation_tpu_torch.data import toy
    from pointcloudsegmentation_tpu_torch.data.provider import to_device

    return [to_device(b, device) for b in toy.toy_batches(
        2, batch_size=TRAIN_BLOCKS, num_points=N_POINTS, kind="room",
        num_classes=13, feat_dim=12)]


def phase_train(cfg, card):
    import dataclasses
    import math

    import torch

    from pointcloudsegmentation_tpu_torch.kernels import window_gather as wg
    from pointcloudsegmentation_tpu_torch.train.loop import Trainer

    backward_determinism(card)
    trainer = Trainer(cfg, device="cuda")
    state0 = trainer.init_state(torch.Generator().manual_seed(0))
    batches = make_train_batches("cuda")
    log(f"[train] {cfg.model} {cfg.compute_dtype}: {trainer.num_params} "
        f"params, {TRAIN_BLOCKS} blocks x {N_POINTS} points per step")
    state, m = trainer.train_step(state0, batches[0])     # warm-up
    torch.cuda.synchronize()
    check(math.isfinite(float(m["loss"])), "warm-up loss not finite")

    # launch counts over one step of the training path
    wg.gather_fwd.launches = wg.dslab_bwd.launches = 0
    wg.dslab_map.launches = 0
    state, m = trainer.train_step(state, batches[1])
    torch.cuda.synchronize()
    launches = {"window_gather": wg.gather_fwd.launches,
                "window_dslab": wg.dslab_bwd.launches,
                "window_dslab_map": wg.dslab_map.launches}
    convs = sum(len(st.convs) for st in trainer.model.encoder.arch.stages)
    per_block = len(gather_shapes(trainer.model, cfg))
    log(f"[train] launches in one step: window_gather "
        f"{launches['window_gather']} ({launches['window_gather'] / TRAIN_BLOCKS:g}"
        f" per block, expected {per_block}), window_dslab "
        f"{launches['window_dslab']} ({launches['window_dslab'] / TRAIN_BLOCKS:g}"
        f" per block, expected {convs}), its map kernel "
        f"{launches['window_dslab_map']}")
    check(launches["window_gather"] == per_block * TRAIN_BLOCKS,
          f"window_gather launched {launches['window_gather']} times")
    check(launches["window_dslab"] == convs * TRAIN_BLOCKS,
          f"window_dslab launched {launches['window_dslab']} times")
    check(launches["window_dslab_map"] == convs * TRAIN_BLOCKS,
          f"window_dslab_map launched {launches['window_dslab_map']} times")

    # 20 steps on one batch: finite, falling loss
    losses = []
    st = state0
    for _ in range(20):
        st, m = trainer.train_step(st, batches[0])
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    log(f"[train] 20 steps on one batch: loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f} (min {min(losses):.5f}), every step finite")

    # one step twice from the same state: bitwise equal
    a, _ = trainer.train_step(state, batches[0])
    b, _ = trainer.train_step(state, batches[0])
    torch.cuda.synchronize()
    for f in ("params", "mu", "nu", "count"):
        check(torch.equal(getattr(a, f), getattr(b, f)),
              f"two runs of one step differ in {f}")
    log("[train] one step twice from one state: params, mu, nu and count "
        "bitwise equal")

    # the non-finite guard
    bad = dict(batches[0], feats=batches[0]["feats"].clone())
    bad["feats"][1, 100, 0] = float("nan")
    c, mc = trainer.train_step(a, bad)
    torch.cuda.synchronize()
    check(int(mc["skipped"]) == 1, "NaN batch not skipped")
    for f in ("params", "mu", "nu", "count"):
        check(torch.equal(getattr(c, f), getattr(a, f)),
              f"NaN batch changed {f}")
    log(f"[train] NaN feature: skipped={int(mc['skipped'])}, params, mu, nu "
        f"and count unchanged, step {a.step} -> {c.step}")

    # float32 gradient parity, card vs CPU, one block, train=False loss
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    block = {k: v[:1].cpu() for k, v in batches[0].items()}
    grads = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(f32, device=dev)
        st = tr.init_state(torch.Generator().manual_seed(0))
        t0 = time.perf_counter()
        loss, g = tr.loss_and_grad(st, block, train=False)
        grads[dev] = (float(loss), g.double().cpu())
        log(f"[train] float32 loss and grad on {dev}: {float(loss):.6f} in "
            f"{time.perf_counter() - t0:.2f} s")
    gc, gh = grads["cuda"][1], grads["cpu"][1]
    cos = float(gc @ gh / (gc.norm() * gh.norm()))
    rel = float((gc - gh).norm() / gh.norm())
    log(f"[train] float32 flat gradient card vs CPU: cosine {cos:.6f} "
        f"(need >= {GRAD_COSINE_MIN}), max |d| {(gc - gh).abs().max():.3e}"
        f", relative L2 {rel:.3e}, loss {grads['cuda'][0]:.6f} vs "
        f"{grads['cpu'][0]:.6f} [{card}]")
    check(cos >= GRAD_COSINE_MIN, f"gradient cosine {cos}")
    return launches


def k1_flops(lidx, dims):
    """Operations K1's output needs on this data: for every valid slot, the
    multiply-adds of ``sx @ wsx`` and of each layer's hidden kernel (2 each)
    plus the adds that form ``base`` and add the hidden products."""
    offs = [0]
    for d in dims:
        offs.append(offs[-1] + d)
    per_slot = 2 * (3 * offs[-1] + sum(offs[i] * dims[i]
                                       for i in range(1, len(dims))))
    per_slot += 2 * offs[-1] + sum(dims[1:])
    return int((lidx >= 0).sum()) * per_slot


def k1_check(fc, args, card, what):
    """K1 against its plain version on the bench's inputs ``args``: two
    runs bitwise equal, the same points without a valid slot, and within
    the stated bound; then both timed beside the bound."""
    import torch

    from pointcloudsegmentation_tpu_torch.utils.timing import graph_ms

    fpx, cen, xyzc, lidx, wsx, whids, window, tile, dims = args
    dtype = fpx.dtype
    before = fc.fused_window_conv_fwd.launches
    got = fc.fused_window_conv_fwd(*args)
    again = fc.fused_window_conv_fwd(*args)
    want = fc.fused_window_conv_reference(*args)
    slots = fc.window_conv_slots(*args)
    torch.cuda.synchronize()
    check(fc.fused_window_conv_fwd.launches == before + 2,
          f"{what}: the fused conv launched "
          f"{fc.fused_window_conv_fwd.launches - before} times in 2 calls")
    check(torch.equal(got, again), f"{what}: fused conv not repeatable")
    none = want.float() <= -1e29
    check(torch.equal(got.float() <= -1e29, none),
          f"{what}: points without a valid slot differ")
    d = (got.float() - want.float()).abs()
    valid = (lidx >= 0)[..., None]
    if dtype == torch.float32:
        # every input replaced by its magnitude and xyz_i negated, so each
        # sum and difference adds magnitudes and relu passes them through
        mags = fc.window_conv_slots(
            fpx.abs(), cen.abs(), -xyzc.abs(), lidx, wsx.abs(),
            tuple(w.abs() for w in whids), window, tile, dims)
        scale = torch.where(valid, mags, torch.zeros_like(mags)).amax(1)
        bound = K1_F32_RTOL * scale
        stated = f"<= {K1_F32_RTOL:g} of each output's sum of magnitudes"
    else:
        top = slots.abs()[valid.expand_as(slots)].max()
        bound = K1_BF16_ULPS * bf16_ulp(top)
        stated = (f"<= {K1_BF16_ULPS} bf16 ulps of the largest activation "
                  f"{top.item():.4f}")
    over = int((d > bound).sum())
    check(over == 0, f"{what}: {over} elements beyond {stated}")
    err = d.max().item()
    ms = graph_ms(lambda: fc.fused_window_conv_fwd(*args))
    plain_ms = graph_ms(lambda: fc.fused_window_conv_reference(*args))
    n_bytes = nbytes(fpx, cen, xyzc, lidx, wsx, *whids, got)
    flops = k1_flops(lidx, dims)
    bound_t, bound_by = bound_ms(n_bytes, flops, dtype)
    log(f"[fused] {what} {str(dtype):14s} repeatable; "
        f"{int((d > 0).sum())} of {d.numel()} elements differ from plain "
        f"(max {err:.3e}, {stated}); device ms (graph replay): kernel "
        f"{ms:.4f}, plain {plain_ms:.4f}, bound {bound_t:.4f} ({bound_by}: "
        f"{n_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP over "
        f"{int((lidx >= 0).sum())} valid slots; "
        f"{flops / ms / 1e9:.2f} TFLOP/s) [{card}]")
    return dict(name=what, dtype=str(dtype), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_t, bound_by=bound_by)


def rewindow(args, window):
    """K1's arguments ``args`` with the stream re-padded to ``window`` rows
    (no multiple of the tile) and each slab-local index moved with it: the
    same neighbours where they stay in the slab, a masked slot below it and
    a zero row above it."""
    import torch.nn.functional as F

    fpx, cen, xyzc, lidx, wsx, whids, w0, tile, dims = args
    fpx = F.pad(fpx[w0:fpx.shape[0] - w0], (0, 0, window, window))
    lidx = lidx.where(lidx < 0, lidx - w0 + window)
    return fpx, cen, xyzc, lidx, wsx, whids, window, tile, dims


def k1_inputs(n, tile, k, dims, window, seed):
    """K1's bf16 arguments on the card from a seeded numpy generator: a
    zero-padded [nbr_proj | hi | mid] stream, centre projections,
    coordinates in a 3 m block, slab-local indices with a fifth of the
    slots invalid, every 7th point without a valid slot and a few indices
    past the slab (zero rows), and weights of unit scale."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    s = tile + 2 * window
    sumd = sum(dims)
    offs = np.cumsum((0,) + tuple(dims))
    xyz = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    hi = torch.from_numpy(xyz).bfloat16().float().numpy()
    fp = np.concatenate([rng.randn(n, sumd).astype(np.float32), hi,
                         xyz - hi], -1)
    fpx = np.pad(fp, ((window, window), (0, 0)))
    cen = rng.randn(n, sumd).astype(np.float32)
    xyzc = np.concatenate([xyz, np.zeros((n, 1), np.float32)], -1)
    lidx = rng.randint(0, s, (n, k)).astype(np.int32)
    lidx[rng.rand(n, k) < 0.2] = -1
    lidx[::7] = -1
    lidx[1::5, 0] = s + 3
    wsx = (rng.randn(3, sumd) / np.sqrt(3)).astype(np.float32)
    whids = [(rng.randn(offs[i], dims[i]) / np.sqrt(offs[i]))
             .astype(np.float32) for i in range(1, len(dims))]
    dev = lambda a: torch.from_numpy(a).cuda().bfloat16()  # noqa: E731
    return (dev(fpx), dev(cen), torch.from_numpy(xyzc).cuda(),
            torch.from_numpy(lidx).cuda(), dev(wsx),
            tuple(dev(w) for w in whids), window, tile, tuple(dims))


def phase_fused_conv(card):
    """The fused-conv bench at levels 0 and 1 (full width), then K1 against
    its plain version on each level's inputs."""
    import torch

    from pointcloudsegmentation_tpu_torch import bench_fused_conv as bench
    from pointcloudsegmentation_tpu_torch.kernels import fused_conv as fc

    rows, launches = [], 0
    for level in (0, 1):
        b = bench.setup(level, "cuda")
        n, k = b.wn.lidx.shape
        what = f"L{level} N={n} K={k} dims={bench.LEVELS[level]['dims']}"
        # the bench path: its timed arms and its cross-check
        fc.fused_window_conv_fwd.launches = 0
        arms = bench.time_arms(b, ARM_ITERS)
        err, scale = bench.cross_check(b)
        torch.cuda.synchronize()
        got = fc.fused_window_conv_fwd.launches
        calls = 3 + ARM_ITERS + 1       # warm-up, timed, cross-check
        launches += got
        log(f"[fused] bench {what}: " + ", ".join(
            f"{arm} {ms:.4f} ms" for arm, ms in arms.items())
            + f" (CUDA events, {ARM_ITERS} eager calls) [{card}]")
        log(f"[fused] bench {what}: fused window-conv launches {got} in "
            f"{calls} fused calls; fused vs unfused (windowed slots, bf16) "
            f"max abs diff {err:.4f}, bound {FUSED_VS_UNFUSED_REL * scale:.4f}"
            f" (2^-6 of the largest |output| {scale:.4f})")
        check(got == calls, f"{got} fused window-conv launches in {calls} "
              f"fused calls")
        check(err <= FUSED_VS_UNFUSED_REL * scale,
              f"fused vs unfused {err} at {what}")
        with torch.no_grad():
            rows.append(k1_check(fc, bench.fused_arm(b)(), card, what))
            if level == 0:
                rows.append(k1_check(fc, bench.fused_arm(
                    b, torch.float32)(), card, what))
                rows.append(k1_check(fc, rewindow(bench.fused_arm(b)(), 96),
                                     card, f"{what} W=96"))
    with torch.no_grad():
        for seed, (n, k, dims, window) in enumerate(K1_CASES):
            rows.append(k1_check(fc, k1_inputs(n, 256, k, dims, window, seed),
                                 card, f"random N={n} K={k} dims={dims} "
                                 f"W={window}"))
    return rows, launches


def reset_counts():
    from pointcloudsegmentation_tpu_torch.kernels import window_gather as wg

    wg.gather_fwd.launches = wg.dslab_bwd.launches = 0
    wg.dslab_map.launches = 0


def read_counts():
    import torch

    from pointcloudsegmentation_tpu_torch.kernels import window_gather as wg

    torch.cuda.synchronize()
    return {"window_gather": wg.gather_fwd.launches,
            "window_dslab": wg.dslab_bwd.launches,
            "window_dslab_map": wg.dslab_map.launches}


def run_path(what, fn, expect):
    """Run one entry point with the kernel counts set to 0 just before and
    read just after, and check them against ``expect`` (kernel ->
    launches).  Returns (fn's result, counts, seconds)."""
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    counts = read_counts()
    seconds = time.perf_counter() - t0
    log(f"[entry] {what}: {seconds:.2f} s; launches "
        + ", ".join(f"{k} {v} (expected {expect.get(k, 0)})"
                    for k, v in counts.items()))
    for k, v in counts.items():
        check(v == expect.get(k, 0), f"{what}: {k} launched {v} times, "
              f"expected {expect.get(k, 0)}")
    return out, counts, seconds


def read_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase_entry_points(card):
    """9: the train CLI, the scene eval and ``pointnet_scannet`` at full
    width on the card, each with its own launch counts."""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pointcloudsegmentation_tpu_torch import interpolate
    from pointcloudsegmentation_tpu_torch.config import (s3dis_config,
                                                         scannet_config)
    from pointcloudsegmentation_tpu_torch.data import s3dis, synth_rooms, toy
    from pointcloudsegmentation_tpu_torch.train import cli
    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    total = {"window_gather": 0, "window_dslab": 0, "window_dslab_map": 0}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # (a) the train CLI on the flagship, then --restore --eval
        ck = os.path.join(tmp, "ck")
        base = ["--config", "s3dis", "--synthetic", "--steps-per-epoch",
                str(CLI_STEPS), "--batch-size", str(TRAIN_BLOCKS),
                "--num-points", str(N_POINTS), "--checkpoint-dir", ck]
        fwd, step = per_block(s3dis_config(data_num_points=N_POINTS))
        blocks = CLI_STEPS * TRAIN_BLOCKS
        log(f"[entry] flagship launches per block: {fwd} forward, {step} "
            f"training step")
        _, counts, secs = run_path(
            f"train CLI s3dis ({CLI_STEPS} train + {CLI_STEPS} test steps "
            f"of {TRAIN_BLOCKS} x {N_POINTS} points)",
            lambda: cli.main(base + ["--epochs", "1", "--metrics-file",
                                     os.path.join(tmp, "train.jsonl")]),
            plus(times(step, blocks), times(fwd, blocks)))
        total = {k: total[k] + counts[k] for k in total}
        rec, = read_records(os.path.join(tmp, "train.jsonl"))
        check(set(rec) == METRICS_KEYS, f"metrics record keys {sorted(rec)}")
        check(math.isfinite(rec["train_loss"]), f"train loss {rec}")
        check(os.path.exists(os.path.join(ck, "epoch_000000.pt")),
              "no checkpoint written")
        log(f"[entry] train CLI: epoch record train_loss "
            f"{rec['train_loss']:.5f}, lr {rec['lr']:g}, test mIoU "
            f"{rec['miou']:.6f}, oAcc {rec['oacc']:.6f}, "
            f"{rec['points_per_sec']:.1f} train points/s (host-bound, not a "
            f"benchmark) [{card}]; checkpoint written")
        res, counts, secs = run_path(
            f"train CLI --restore --eval ({CLI_STEPS} test steps)",
            lambda: cli.main(base + ["--restore", "--eval", "--metrics-file",
                                     os.path.join(tmp, "eval.jsonl")]),
            times(fwd, blocks))
        total = {k: total[k] + counts[k] for k in total}
        ev, = read_records(os.path.join(tmp, "eval.jsonl"))
        for key in ("miou", "oiou", "oacc", "iou", "acc"):
            check(ev[key] == rec[key], f"--restore --eval {key} {ev[key]} "
                  f"differs from the epoch's {rec[key]}")
        log(f"[entry] --restore --eval: mIoU {ev['miou']!r}, oAcc "
            f"{ev['oacc']!r}: bit for bit the epoch's test metrics")

        # (b) the scene eval on a prepared room, with that checkpoint
        scenes = os.path.join(tmp, "scenes")
        points, labels = synth_rooms.synthetic_s3dis_room(
            np.random.RandomState(0))
        prep = s3dis.prepare_room(points, labels,
                                  rng=np.random.RandomState(0))
        s3dis.save_pkl(os.path.join(scenes, "room0.pkl"), prep)
        nblk = len(prep["xyzs"])
        out, counts, secs = run_path(
            f"scene eval (a prepared room: {len(points)} points, {nblk} "
            f"blocks)",
            lambda: interpolate.main([
                "--config", "s3dis", "--checkpoint-dir", ck, "--scene-dir",
                scenes, "--out-dir", os.path.join(tmp, "out")]),
            times(fwd, nblk))
        total = {k: total[k] + counts[k] for k in total}
        r, = out
        dev = float(np.abs(r["probs"].sum(1) - 1.0).max())
        check(np.isfinite(r["probs"]).all(), "scene probs not finite")
        check(dev <= PROB_SUM_TOL, f"scene probs rows sum to 1 +- {dev}")
        check(0.0 <= r["res"]["miou"] <= 1.0, f"scene mIoU {r['res']}")
        log(f"[entry] scene eval: {r['points']} dense points labelled in "
            f"{r['seconds']:.3f} s (sweep + interpolation; {secs:.2f} s with "
            f"restore and prep), probs rows sum to 1 +- {dev:.2e}, mIoU "
            f"{r['res']['miou']:.4f}, oAcc {r['res']['oacc']:.4f} [{card}]")

        # (c) pointnet_scannet through the train CLI
        sfwd, sstep = per_block(scannet_config(data_num_points=N_POINTS))
        log(f"[entry] pointnet_scannet launches per block: {sfwd} forward, "
            f"{sstep} training step (its xyz-only first conv gathers "
            f"nothing)")
        _, counts, secs = run_path(
            f"train CLI scannet ({CLI_STEPS} train + {CLI_STEPS} test steps "
            f"of {TRAIN_BLOCKS} x {N_POINTS} points)",
            lambda: cli.main([
                "--config", "scannet", "--synthetic", "--epochs", "1",
                "--steps-per-epoch", str(CLI_STEPS), "--batch-size",
                str(TRAIN_BLOCKS), "--num-points", str(N_POINTS),
                "--metrics-file", os.path.join(tmp, "scannet.jsonl")]),
            plus(times(sstep, blocks), times(sfwd, blocks)))
        total = {k: total[k] + counts[k] for k in total}
        srec, = read_records(os.path.join(tmp, "scannet.jsonl"))
        check(math.isfinite(srec["train_loss"]),
              f"scannet train loss {srec}")
        log(f"[entry] pointnet_scannet: train loss {srec['train_loss']:.5f}"
            f", test mIoU {srec['miou']:.4f}, {srec['points_per_sec']:.1f} "
            f"train points/s (host-bound) [{card}]")
        f32 = scannet_config(compute_dtype="float32")
        b = toy.synthetic_room_block(np.random.RandomState(0), N_POINTS, 20,
                                     1)
        logits = {}
        for devname in ("cuda", "cpu"):
            m = build_model(f32, torch.Generator().manual_seed(0), devname)
            with torch.inference_mode():
                logits[devname] = m(
                    torch.from_numpy(b["xyz"]).to(devname),
                    torch.from_numpy(b["feats"]).to(devname),
                    torch.ones(N_POINTS, dtype=torch.bool,
                               device=devname)).cpu()
        agree = float((logits["cuda"].argmax(1) == logits["cpu"].argmax(1))
                      .double().mean())
        log(f"[entry] pointnet_scannet float32 logits card vs CPU: argmax "
            f"agreement {agree:.6f} (need >= {PARITY_ARGMAX_MIN}), max |d| "
            f"{(logits['cuda'] - logits['cpu']).abs().max():.3e} [{card}]")
        check(agree >= PARITY_ARGMAX_MIN, f"scannet argmax agreement {agree}")

        # (d) the train CLI on the prepared room's pkl: the Provider, rgb
        # and covariance features
        pblocks = -(-nblk // TRAIN_BLOCKS) * TRAIN_BLOCKS
        _, counts, secs = run_path(
            f"train CLI s3dis --data-dir (the prepared room: {nblk} blocks, "
            f"batches of {TRAIN_BLOCKS} x {N_POINTS} points)",
            lambda: cli.main([
                "--config", "s3dis", "--data-dir", scenes, "--epochs", "1",
                "--batch-size", str(TRAIN_BLOCKS), "--num-points",
                str(N_POINTS), "--metrics-file",
                os.path.join(tmp, "pkl.jsonl")]),
            plus(times(step, pblocks), times(fwd, pblocks)))
        total = {k: total[k] + counts[k] for k in total}
        prec, = read_records(os.path.join(tmp, "pkl.jsonl"))
        check(set(prec) == METRICS_KEYS, f"metrics record keys {sorted(prec)}")
        check(math.isfinite(prec["train_loss"]), f"pkl train loss {prec}")
        log(f"[entry] train CLI on room pkls: train loss "
            f"{prec['train_loss']:.5f}, test mIoU {prec['miou']:.4f}, "
            f"{prec['points_per_sec']:.1f} train points/s (host-bound) "
            f"[{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return total


def semantic3d_blocks(seed, count):
    """``count`` Semantic3D training blocks of at least SEM3D_POINTS points
    each, made by the port's ``semantic3d.sample_training_blocks`` (10 m
    blocks at a 5 m stride, 6 cm grid, covariance features) from the
    seeded outdoor scan."""
    import numpy as np

    from pointcloudsegmentation_tpu_torch.data import semantic3d
    from pointcloudsegmentation_tpu_torch.data.synth_outdoor import \
        outdoor_scan

    pts, labels = outdoor_scan(seed)
    blocks = semantic3d.sample_training_blocks(
        pts, labels, min_pn=SEM3D_POINTS, rng=np.random.RandomState(seed))
    check(len(blocks) >= count, f"{len(blocks)} Semantic3D blocks of >= "
          f"{SEM3D_POINTS} points from the scan, need {count}")
    check(all(len(b["xyz"]) >= SEM3D_POINTS for b in blocks[:count]),
          "a Semantic3D block below the point budget")
    log(f"[family] outdoor scan: {len(pts)} points -> {len(blocks)} blocks "
        f"of 10 m ({min(len(b['xyz']) for b in blocks)}-"
        f"{max(len(b['xyz']) for b in blocks)} points, 13 features)")
    return blocks[:count]


def block_batch(blocks, num_points, seed):
    """One training batch of ``blocks`` read as the train Provider reads
    them (Semantic3D's flips and colour jitter), each subsampled to
    ``num_points``: [B, num_points, ...] numpy arrays."""
    import numpy as np

    from pointcloudsegmentation_tpu_torch.data import batching, semantic3d

    rng = np.random.RandomState(seed)
    return batching.stack_blocks([
        batching.pad_block(b["xyz"], b["feats"], b["labels"], num_points, rng)
        for b in semantic3d.blocks_from_list("train", blocks, rng)])


def phase_family(card):
    """10: the five other PointNetSegEncoder archs at full width, bf16
    compute with f32 params and seeded weights: (a) one Trainer step of
    TRAIN_BLOCKS blocks each with a finite loss and the counted launches;
    (b) a float32 one-block forward on the card and on the CPU with equal
    argmax; (c) the train CLI on Semantic3D block pkls; (d) K2 and K3
    against their plain versions at the new extreme row widths."""
    import dataclasses
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pointcloudsegmentation_tpu_torch.config import (s3dis_config,
                                                         semantic3d_config)
    from pointcloudsegmentation_tpu_torch.data import semantic3d, toy
    from pointcloudsegmentation_tpu_torch.train import cli
    from pointcloudsegmentation_tpu_torch.train.loop import Trainer
    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    total = {"window_gather": 0, "window_dslab": 0, "window_dslab_map": 0}
    blocks = semantic3d_blocks(0, CLI_STEPS * TRAIN_BLOCKS)
    s3d_batch = block_batch(blocks[:TRAIN_BLOCKS], SEM3D_POINTS, 0)
    s3dis_batch = next(toy.toy_batches(1, batch_size=TRAIN_BLOCKS,
                                       num_points=N_POINTS, kind="room",
                                       num_classes=13, feat_dim=12))
    cfgs = [semantic3d_config(model=k) for k in SEM3D_KEYS] \
        + [s3dis_config(model=k) for k in S3DIS_KEYS]
    widest = None
    for cfg in cfgs:
        semantic = cfg.data.feat_dim == 13
        batch = s3d_batch if semantic else s3dis_batch
        n = batch["xyz"].shape[1]
        # (a) one training step at full width
        fwd, step = per_block(cfg)
        model = build_model(cfg, None, "cpu")
        for name, sn, k, f, dt in gather_shapes(model, cfg):
            if widest is None or f > widest[3]:
                widest = (f"{cfg.model} {name}", sn, k, f)
        trainer = Trainer(cfg, device="cuda")
        state = trainer.init_state(torch.Generator().manual_seed(0))
        log(f"[family] {cfg.model}: {trainer.num_params} params, launches "
            f"per block {fwd} forward, {step} training step")
        (state, m), counts, secs = run_path(
            f"{cfg.model} train step ({TRAIN_BLOCKS} x {n} points)",
            lambda: trainer.train_step(state, batch),
            times(step, TRAIN_BLOCKS))
        total = plus(total, counts)
        loss = float(m["loss"])
        check(math.isfinite(loss) and int(m["skipped"]) == 0,
              f"{cfg.model} train step loss {loss}")
        log(f"[family] {cfg.model}: train step loss {loss:.5f} in "
            f"{secs:.2f} s (first step, build included) [{card}]")
        # (b) float32 forward, card vs CPU, on the batch's first block
        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        logits = {}
        for dev in ("cuda", "cpu"):
            mdl = build_model(f32, torch.Generator().manual_seed(0), dev)
            with torch.inference_mode():
                logits[dev] = mdl(*(torch.from_numpy(batch[key][0]).to(dev)
                                    for key in ("xyz", "feats", "mask"))
                                  ).cpu()
        agree = float((logits["cuda"].argmax(1) == logits["cpu"].argmax(1))
                      .double().mean())
        log(f"[family] {cfg.model} float32 logits card vs CPU: argmax "
            f"agreement {agree:.6f} (need >= {PARITY_ARGMAX_MIN}), max |d| "
            f"{(logits['cuda'] - logits['cpu']).abs().max():.3e} [{card}]")
        check(agree >= PARITY_ARGMAX_MIN,
              f"{cfg.model} argmax agreement {agree}")
        del trainer, state, m

    # (c) the train CLI on Semantic3D block pkls
    tmp = tempfile.mkdtemp(prefix="chip_smoke_s3d_")
    try:
        semantic3d.save_blocks(os.path.join(tmp, "pkl", "scan0.pkl"), blocks)
        fwd, step = per_block(semantic3d_config())
        nblk = len(blocks)
        _, counts, secs = run_path(
            f"train CLI semantic3d --data-dir ({nblk} blocks, batches of "
            f"{TRAIN_BLOCKS} x {SEM3D_POINTS} points)",
            lambda: cli.main([
                "--config", "semantic3d", "--data-dir",
                os.path.join(tmp, "pkl"), "--epochs", "1", "--batch-size",
                str(TRAIN_BLOCKS), "--metrics-file",
                os.path.join(tmp, "s3d.jsonl")]),
            plus(times(step, nblk), times(fwd, nblk)))
        total = plus(total, counts)
        rec, = read_records(os.path.join(tmp, "s3d.jsonl"))
        check(set(rec) == METRICS_KEYS, f"metrics record keys {sorted(rec)}")
        check(math.isfinite(rec["train_loss"]), f"semantic3d loss {rec}")
        check(len(rec["iou"]) == 8, f"semantic3d classes {len(rec['iou'])}")
        log(f"[family] train CLI semantic3d: train loss "
            f"{rec['train_loss']:.5f}, test mIoU {rec['miou']:.4f}, "
            f"{rec['points_per_sec']:.1f} train points/s (host-bound) "
            f"[{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) K2 and K3 at the new extreme widths: the pre-stage's 13-column
    # rows (float32: 52 B, and bf16: 26 B) and the widest row of the five
    pre = semantic3d_config().data
    k2_rows, k3_rows = kernel_cases(
        [("pre-stage f32", pre.caps[0], 16, pre.feat_dim, torch.float32),
         ("pre-stage bf16", pre.caps[0], 16, pre.feat_dim, torch.bfloat16),
         (f"widest ({widest[0]})", widest[1], widest[2], widest[3],
          torch.bfloat16)], 10, card)
    return total, k2_rows, k3_rows


def ecd_gathers(model, cfg):
    """(what, level, K, F, dtype, grad) of every window-gather launch one
    forward of an ECD, PGNet or PointNet++ model makes on its windowed
    levels, in the order they run: each search's xyzm read (what
    "search", K its candidate pool, 4 float32 columns) and each conv's
    feature gather (what the conv's name, K the band's windowed slots).  F
    is the width gathered, dtype the dtype it is gathered in: the compute
    dtype, but float32 where the model concatenates the raw float32 input
    features before the gather (pgnet_v7's stage-0 ECD convs), as jnp
    promotes.  grad says whether the gathered tensor takes a gradient, so
    that a training step's backward runs K3 on it: not the xyzm reads, nor
    a first pointnet conv's gather of the raw input.  One gather per ECD
    conv: the port gathers once where the JAX layer gathers twice."""
    import torch

    from pointcloudsegmentation_tpu_torch.models import ecd
    from pointcloudsegmentation_tpu_torch.models.pointnet import \
        PointNet2Baseline

    enc = model.encoder
    sizes = (cfg.data.num_points,) + tuple(cfg.data.caps)
    cdt = enc.dtype or torch.float32
    f32 = torch.float32
    out = []

    def read(s, k):
        out.append(("search", s, min(k, sizes[s]), 4, f32, False))

    if isinstance(enc, (ecd.ECDSegModel, ecd.PGNetV6)):
        for s, sp in enumerate(enc.specs):
            read(s, 4 * sp.k)
            if isinstance(enc, ecd.ECDSegModel):
                out.extend((f"stage{s}.gc_{i}", s, sp.k, f, cdt, True)
                           for i, f in enumerate(sp.gc_dims))
            else:
                out.extend((f"stage{s}.feats_{i}", s, sp.k, fp[0], cdt, True)
                           for i, fp in enumerate(sp.feats_params))
    elif isinstance(enc, (ecd.PGNetHybrid, ecd.PGNetV7)):
        hybrid = isinstance(enc, ecd.PGNetHybrid)
        i = 0
        for s, stage in enumerate(enc.specs):
            seen = set()
            for c in stage.pairs if hybrid else stage.convs:
                if (c.radius, c.k) not in seen:
                    seen.add((c.radius, c.k))
                    read(s, 4 * c.k)
                pn = f"pointnet{i}" if hybrid else \
                    f"feats{i}" if c.kind == "pn" else None
                if pn is not None:
                    f = (getattr(enc, pn).fc_0.in_features - 3) // 2
                    out.append((pn, s, c.k, f, cdt, i > 0))
                if hybrid:
                    out.append((f"anchor_conv{i}", s, c.k, c.pn_out, cdt,
                                True))
                elif pn is None:
                    f = getattr(enc, f"ecd{i}").fc_ew.out_features
                    out.append((f"ecd{i}", s, c.k, f,
                                f32 if s == 0 else cdt, True))
                i += 1
    elif isinstance(enc, PointNet2Baseline):
        ci = 0
        for s, units in enumerate(enc.STAGES):
            read(s, enc.cand_k)
            for u in units:
                f = (getattr(enc, f"pn{ci}").fc_0.in_features - 3) // 2
                out.append((f"pn{ci}", s, u[1], f, cdt, ci > 0))
                out.append((f"anchor{ci}" if len(u) == 7 else f"pn{ci}b", s,
                            u[1], u[3], cdt, True))
                ci += 1
    else:
        raise TypeError(f"no gather count for {type(enc).__name__}")
    return [g for g in out if sizes[g[1]] % 256 == 0
            and sizes[g[1]] >= 4 * 256]


def gathers_per_block(cfg, gathers_fn):
    """Kernel launches per block of a forward and of a training step of
    ``cfg``'s model, from the gathers ``gathers_fn(model, cfg)`` lists: K2
    at each, K3 (map and sum kernels) at each that takes a gradient."""
    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    gathers = gathers_fn(build_model(cfg, None, "cpu"), cfg)
    trained = sum(g[-1] for g in gathers)
    return ({"window_gather": len(gathers)},
            {"window_gather": len(gathers), "window_dslab": trained,
             "window_dslab_map": trained})


def ecd_per_block(cfg):
    """Launches per block of an ECD-family model (``ecd_gathers``)."""
    return gathers_per_block(cfg, ecd_gathers)


def gpn_gathers(model, cfg):
    """(what, level, K, F, dtype, grad) of every window-gather launch one
    forward of ``gpn_seg`` makes on its windowed levels, in the order they
    run: per stage the search's xyzm read (K its candidate pool, 4 float32
    columns, no gradient), then each feats conv ``gc_{i}``'s gather of the
    stage's running features (K the band's windowed slots, F their width).
    They are float32 at stage 0, where the raw float32 input features
    join them (jnp promotes the concat), and the compute dtype after; all
    take a gradient, so a training step runs K3 on each."""
    import torch

    enc = model.encoder
    sizes = (cfg.data.num_points,) + tuple(cfg.data.caps)
    f32 = torch.float32
    out = []
    for s, sp in enumerate(enc.specs):
        out.append(("search", s, min(4 * sp.k, sizes[s]), 4, f32, False))
        dtype = f32 if s == 0 else enc.dtype or f32
        stage = getattr(enc, f"stage{s}")
        out.extend((f"stage{s}.gc_{i}", s, sp.k,
                    getattr(stage, f"gc_{i}").ifn, dtype, True)
                    for i in range(len(sp.gc_dims)))
    return [g for g in out if sizes[g[1]] % 256 == 0
            and sizes[g[1]] >= 4 * 256]


def gpn_per_block(cfg):
    """Launches per block of ``gpn_seg`` (``gpn_gathers``)."""
    return gathers_per_block(cfg, gpn_gathers)


def template_gathers(model, cfg):
    """(what, N, K, F, dtype, grad) of every window-gather launch one
    forward of a ``template_*`` model makes on its windowed levels, in the
    order they run: per stage the search's xyzm read (K its candidate
    pool, 4 float32 columns, no gradient), the xyz conv's gather and each
    ``gc_{i}``'s (K the band's windowed slots).  The xyz conv gathers the
    level's raw float32 xyz (the anchor convs keep it float32, the
    pointnet conv casts it to the compute dtype first), which takes no
    gradient; the diffusion-anchor conv gathers its embedding of it
    (``fc_embed``, the compute dtype), which does.  Each ``gc_{i}``
    gathers the compute-dtype output of its embed (the diffusion-anchor
    conv: of its ``fc_embed``), with a gradient."""
    import torch

    enc = model.encoder
    sizes = (cfg.data.num_points,) + tuple(cfg.data.caps)
    cdt = enc.dtype or torch.float32
    f32 = torch.float32
    out = []
    for s, sp in enumerate(enc.specs):
        stage = getattr(enc, f"stage{s}")
        n = sizes[s]
        out.append(("search", n, min(4 * sp.k, n), 4, f32, False))
        convs = [("xyz_gc", 3)] + [(f"gc_{i}", d)
                                   for i, d in enumerate(sp.gc_dims)]
        for name, width in convs:
            raw = name == "xyz_gc"
            if stage.conv == "diffusion_anchor":
                width = getattr(stage, name).fc_embed.out_features
                dtype, grad = cdt, True
            elif stage.conv == "pointnet":
                dtype, grad = cdt, not raw
            else:
                dtype, grad = (f32 if raw else cdt), not raw
            out.append((f"stage{s}.{name}", n, sp.k, width, dtype, grad))
    return [g for g in out if g[1] % 256 == 0 and g[1] >= 4 * 256]


def refine_gathers(model, cfg):
    """(what, N, K, F, dtype, grad) of every window-gather launch one
    forward of ``refine_s3dis`` makes, in order: the base ECD net's on the
    voxel pyramid (``ecd_gathers``), then the refine net's two ECD stages
    on the class-pure pyramid: the points, then ``refine_cap`` voxels
    (each stage's search read and its ``gc_{i}`` gathers, compute dtype,
    with a gradient: the refine net's weights train)."""
    import torch

    sizes = (cfg.data.num_points,) + tuple(cfg.data.caps)
    out = [(g[0], sizes[g[1]]) + g[2:] for g in ecd_gathers(model, cfg)]
    cdt = model.encoder.dtype or torch.float32
    rsizes = (cfg.data.num_points, model.refine_cap)
    for s, stage in enumerate((model.refine.stage0, model.refine.stage1)):
        sp, n = stage.spec, rsizes[s]
        if n % 256 or n < 4 * 256:
            continue
        out.append(("refine search", n, min(4 * sp.k, n), 4, torch.float32,
                    False))
        out.extend((f"refine.stage{s}.gc_{i}", n, sp.k, f, cdt, True)
                   for i, f in enumerate(sp.gc_dims))
    return out


def composite_gathers(model, cfg):
    """The gathers of a phase-13 key (``refine_gathers`` or
    ``template_gathers``)."""
    fn = refine_gathers if cfg.model == "refine_s3dis" else template_gathers
    return fn(model, cfg)


def phase_ecd(card):
    """11: the ECD and PGNet families and the PointNet++ baseline at full
    width, no depth cut, bf16 compute with f32 params and seeded weights:
    (a) per key, one counted Trainer step of TRAIN_BLOCKS toy blocks with
    a finite loss, then ECD_TIMED_STEPS more, timed; (b) a float32
    one-block forward on the card and on the CPU with equal argmax on at
    least ECD_ARGMAX_MIN of the valid points; (c) K2 and K3 against their
    plain versions at the narrowest and the widest gather rows of the nine
    keys.  Returns (launches, K2 rows, K3 rows, per-key records)."""
    import dataclasses
    import math

    import torch

    from pointcloudsegmentation_tpu_torch.config import (s3dis_config,
                                                         scannet_config)
    from pointcloudsegmentation_tpu_torch.data import toy
    from pointcloudsegmentation_tpu_torch.train.loop import Trainer
    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    total = {"window_gather": 0, "window_dslab": 0, "window_dslab_map": 0}
    records, rows = [], []
    for key in ECD_KEYS:
        scannet = key == "ecd_scannet"
        cfg = (scannet_config if scannet else s3dis_config)(model=key)
        d = cfg.data
        # ScanNet's labels run 0..20 with 0 ignored
        batch = next(toy.toy_batches(
            1, batch_size=TRAIN_BLOCKS, num_points=N_POINTS, kind="room",
            num_classes=d.num_classes + (1 if scannet else 0),
            feat_dim=d.feat_dim))
        fwd, step = ecd_per_block(cfg)
        sizes = (d.num_points,) + tuple(d.caps)
        rows.extend((key, sizes[g[1]]) + g for g in ecd_gathers(
            build_model(cfg, None, "cpu"), cfg) if g[0] != "search")
        # (a) training steps at full width
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, device="cuda")
        state = trainer.init_state(torch.Generator().manual_seed(0))
        log(f"[ecd] {key}: {trainer.num_params} params, launches per block "
            f"{fwd} forward, {step} training step")
        (state, m), counts, first = run_path(
            f"{key} train step ({TRAIN_BLOCKS} x {N_POINTS} points)",
            lambda: trainer.train_step(state, batch),
            times(step, TRAIN_BLOCKS))
        total = plus(total, counts)
        loss = float(m["loss"])
        check(math.isfinite(loss) and int(m["skipped"]) == 0,
              f"{key} train step loss {loss}")

        def timed():
            st = state
            for _ in range(ECD_TIMED_STEPS):
                st, mm = trainer.train_step(st, batch)
            torch.cuda.synchronize()
            return st, mm

        (state, m), counts, secs = run_path(
            f"{key} {ECD_TIMED_STEPS} timed train steps", timed,
            times(step, TRAIN_BLOCKS * ECD_TIMED_STEPS))
        total = plus(total, counts)
        check(math.isfinite(float(m["loss"])), f"{key} timed step loss")
        valid = int(batch["mask"].sum())
        step_s = secs / ECD_TIMED_STEPS
        pps = valid * ECD_TIMED_STEPS / secs
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[ecd] {key}: first step loss {loss:.5f} in {first:.2f} s "
            f"(set-up included); {step_s:.4f} s a step over "
            f"{ECD_TIMED_STEPS} steps, {pps:.1f} train points/s, peak "
            f"{peak:.3f} GiB [{card}]")
        params = trainer.num_params
        del trainer, state, m
        torch.cuda.empty_cache()
        # (b) float32 forward, card vs CPU, on the batch's first block
        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        logits = {}
        for dev in ("cuda", "cpu"):
            mdl = build_model(f32, torch.Generator().manual_seed(0), dev)
            with torch.inference_mode():
                logits[dev] = mdl(*(torch.from_numpy(batch[k][0]).to(dev)
                                    for k in ("xyz", "feats", "mask"))
                                  ).cpu()
            del mdl
        valid_rows = torch.from_numpy(batch["mask"][0])
        same = logits["cuda"].argmax(1) == logits["cpu"].argmax(1)
        agree = float(same[valid_rows].double().mean())
        check(bool(torch.isfinite(logits["cuda"]).all()),
              f"{key} float32 logits not finite")
        log(f"[ecd] {key} float32 logits card vs CPU: argmax agreement "
            f"{agree:.6f} over {int(valid_rows.sum())} valid points (need "
            f">= {ECD_ARGMAX_MIN}), max |d| "
            f"{(logits['cuda'] - logits['cpu']).abs().max():.3e} [{card}]")
        check(agree >= ECD_ARGMAX_MIN, f"{key} argmax agreement {agree}")
        records.append(dict(model=key, params=params, launches_per_block=step,
                            loss=loss, first_step_s=first, step_s=step_s,
                            train_points_per_sec=pps, peak_gib=peak,
                            argmax_agreement=agree))

    # (c) K2 and K3 at the narrowest and widest feature-gather rows (in
    # bytes) of the nine keys, the first of each in key order
    row_bytes = lambda r: r[5] * r[6].itemsize  # noqa: E731
    cases = []
    for what, pick in (("narrowest", min), ("widest", max)):
        key, n, conv, _, k, f, dtype, _ = pick(rows, key=row_bytes)
        cases.append((f"{what} ({key} {conv})", n, k, f, dtype))
    k2_rows, k3_rows = kernel_cases(cases, 11, card)
    log(f"[ecd] per-key records: {json.dumps(records)}")
    return total, k2_rows, k3_rows, records


def modelnet_pairs(seed, count, n=MODELNET_POINTS):
    """``count`` seeded synthetic (xyz, label) pairs in the layout of a
    prepared ModelNet40 pkl: Gaussian clouds of n points whose label
    decides which axis is stretched and by how much."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        label = int(rng.randint(0, 40))
        xyz = rng.randn(n, 3).astype(np.float32)
        xyz[:, label % 3] *= 1.5 + label // 3 * 0.25
        out.append((xyz, label))
    return out


def modelnet_batch(pairs, seed):
    """The pairs through ``modelnet.prepare_cloud`` (unit sphere, the 9
    covariance features) into one batch of padded clouds."""
    import numpy as np

    from pointcloudsegmentation_tpu_torch.data import modelnet
    from pointcloudsegmentation_tpu_torch.data.batching import (pad_block,
                                                                stack_blocks)

    rng = np.random.RandomState(seed)
    clouds = [modelnet.prepare_cloud(x, lab, rng=rng) for x, lab in pairs]
    return stack_blocks([pad_block(c["xyz"], c["feats"], c["labels"],
                                   MODELNET_POINTS, rng) for c in clouds])


def phase_gpn(card):
    """12: the GPN family and ModelNet40 classification at full width, no
    depth cut, bf16 compute with f32 params and seeded weights.  (a)
    ``gpn_seg`` under ``s3dis_config``: one counted Trainer step of
    TRAIN_BLOCKS toy blocks of 8192 points (launches as ``gpn_gathers``
    counts them per block), then ECD_TIMED_STEPS timed; (b) its float32
    logits on one block against the CPU's argmax; (c) ``gpn_modelnet40``:
    Trainer steps on MODELNET_BATCH seeded synthetic clouds (no kernel
    runs: the global search at every level), a float32 argmax check on
    MODELNET_PARITY clouds; (d) the train CLI's ``--config modelnet40``
    from a pkl of (xyz, label) pairs, then ``--restore --eval``; (e) K2
    and K3 at stage 0's widest and narrowest float32 rows and the widest
    bf16 row.  Returns (launches, K2 rows, K3 rows, record)."""
    import dataclasses
    import math
    import pickle
    import shutil
    import tempfile

    import torch

    from pointcloudsegmentation_tpu_torch.config import (modelnet40_config,
                                                         s3dis_config)
    from pointcloudsegmentation_tpu_torch.data import toy
    from pointcloudsegmentation_tpu_torch.train import cli
    from pointcloudsegmentation_tpu_torch.train.loop import Trainer
    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    record = {}
    # (a) gpn_seg trains
    cfg = s3dis_config(model="gpn_seg")
    batch = next(toy.toy_batches(1, batch_size=TRAIN_BLOCKS,
                                 num_points=N_POINTS, kind="room",
                                 num_classes=13, feat_dim=12))
    gathers = gpn_gathers(build_model(cfg, None, "cpu"), cfg)
    fwd, step = gpn_per_block(cfg)
    for what, lvl, k, f, dtype, _ in gathers:
        log(f"[gpn] gpn_seg gather {what}: level {lvl}, K={k}, F={f}, "
            f"{dtype}")
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    log(f"[gpn] gpn_seg: {trainer.num_params} params, decoder "
        f"{trainer.model.encoder.out_width} columns, launches per block "
        f"{fwd} forward, {step} training step")
    (state, m), launches, first = run_path(
        f"gpn_seg train step ({TRAIN_BLOCKS} x {N_POINTS} points)",
        lambda: trainer.train_step(state, batch), times(step, TRAIN_BLOCKS))
    loss = float(m["loss"])
    check(math.isfinite(loss) and int(m["skipped"]) == 0,
          f"gpn_seg train step loss {loss}")

    def timed():
        st = state
        for _ in range(ECD_TIMED_STEPS):
            st, mm = trainer.train_step(st, batch)
        torch.cuda.synchronize()
        return st, mm

    (state, m), counts, secs = run_path(
        f"gpn_seg {ECD_TIMED_STEPS} timed train steps", timed,
        times(step, TRAIN_BLOCKS * ECD_TIMED_STEPS))
    launches = plus(launches, counts)
    check(math.isfinite(float(m["loss"])), "gpn_seg timed step loss")
    pps = int(batch["mask"].sum()) * ECD_TIMED_STEPS / secs
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[gpn] gpn_seg: first step loss {loss:.5f} in {first:.2f} s "
        f"(set-up included); {secs / ECD_TIMED_STEPS:.4f} s a step over "
        f"{ECD_TIMED_STEPS} steps, {pps:.1f} train points/s, peak "
        f"{peak:.3f} GiB [{card}]")
    record.update(gpn_seg_params=trainer.num_params, gpn_seg_loss=loss,
                  gpn_seg_step_s=secs / ECD_TIMED_STEPS,
                  gpn_seg_train_points_per_sec=pps, gpn_seg_peak_gib=peak)
    del trainer, state, m
    torch.cuda.empty_cache()

    def f32_logits(cfg32, blocks):
        """Each block's float32 logits on the card and on the CPU."""
        out = {}
        for dev in ("cuda", "cpu"):
            mdl = build_model(cfg32, torch.Generator().manual_seed(0), dev)
            with torch.inference_mode():
                out[dev] = [mdl(*(torch.from_numpy(b[k]).to(dev)
                                  for k in ("xyz", "feats", "mask"))).cpu()
                            for b in blocks]
            del mdl
        return out

    # (b) gpn_seg float32 parity on the batch's first block
    logits = f32_logits(dataclasses.replace(cfg, compute_dtype="float32"),
                        [{k: batch[k][0] for k in ("xyz", "feats",
                                                   "mask")}])
    card_l, cpu_l = logits["cuda"][0], logits["cpu"][0]
    valid = torch.from_numpy(batch["mask"][0])
    check(bool(torch.isfinite(card_l).all()), "gpn_seg f32 logits")
    agree = float((card_l.argmax(1) == cpu_l.argmax(1))[valid]
                  .double().mean())
    log(f"[gpn] gpn_seg float32 logits card vs CPU: argmax agreement "
        f"{agree:.6f} over {int(valid.sum())} valid points (need >= "
        f"{ECD_ARGMAX_MIN}), max |d| {(card_l - cpu_l).abs().max():.3e} "
        f"[{card}]")
    check(agree >= ECD_ARGMAX_MIN, f"gpn_seg argmax agreement {agree}")
    record["gpn_seg_argmax_agreement"] = agree

    # (c) gpn_modelnet40 trains on synthetic clouds
    mcfg = modelnet40_config()
    mbatch = modelnet_batch(modelnet_pairs(1, MODELNET_BATCH), 1)
    trainer = Trainer(mcfg, device="cuda")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    log(f"[gpn] gpn_modelnet40: {trainer.num_params} params, cloud "
        f"descriptor {trainer.model.encoder.out_width} columns; no "
        f"windowed level (level 0 unsorted, caps {mcfg.data.caps}), so no "
        f"kernel launches")
    mloss = []

    def class_steps(n):
        """n steps with one sync after them, as gpn_seg's timed loop; each
        step's loss and count are read after the sync."""
        nonlocal state
        metrics = []
        for _ in range(n):
            state, mm = trainer.train_step(state, mbatch)
            metrics.append(mm)
        torch.cuda.synchronize()
        return metrics

    def check_class(metrics):
        for mm in metrics:
            mloss.append(float(mm["loss"]))
            check(math.isfinite(mloss[-1]) and int(mm["count"])
                  == MODELNET_BATCH, f"gpn_modelnet40 step loss "
                  f"{mloss[-1]}, count {int(mm['count'])}")

    metrics, _, first = run_path(f"gpn_modelnet40 train step "
                                 f"({MODELNET_BATCH} clouds of "
                                 f"{MODELNET_POINTS} points)",
                                 lambda: class_steps(1), {})
    check_class(metrics)
    metrics, _, secs = run_path(f"gpn_modelnet40 {ECD_TIMED_STEPS} timed "
                                f"train steps",
                                lambda: class_steps(ECD_TIMED_STEPS), {})
    check_class(metrics)
    cps = MODELNET_BATCH * ECD_TIMED_STEPS / secs
    log(f"[gpn] gpn_modelnet40: losses {mloss} (count {MODELNET_BATCH} "
        f"clouds a step), first step {first:.2f} s (set-up included); "
        f"{secs / ECD_TIMED_STEPS:.4f} s a step, {cps:.1f} train clouds/s "
        f"[{card}]")
    record.update(modelnet_params=trainer.num_params, modelnet_loss=mloss,
                  modelnet_step_s=secs / ECD_TIMED_STEPS,
                  modelnet_clouds_per_sec=cps)
    del trainer, state
    torch.cuda.empty_cache()
    logits = f32_logits(
        dataclasses.replace(mcfg, compute_dtype="float32"),
        [{k: mbatch[k][i] for k in ("xyz", "feats", "mask")}
         for i in range(MODELNET_PARITY)])
    card_l, cpu_l = torch.stack(logits["cuda"]), torch.stack(logits["cpu"])
    check(bool(torch.isfinite(card_l).all()), "gpn_modelnet40 f32 logits")
    agree = float((card_l.argmax(1) == cpu_l.argmax(1)).double().mean())
    log(f"[gpn] gpn_modelnet40 float32 logits of {MODELNET_PARITY} clouds "
        f"card vs CPU: argmax agreement {agree:.6f} (need >= "
        f"{ECD_ARGMAX_MIN}), max |d| {(card_l - cpu_l).abs().max():.3e} "
        f"[{card}]")
    check(agree >= ECD_ARGMAX_MIN, f"gpn_modelnet40 argmax agreement {agree}")
    record["modelnet_argmax_agreement"] = agree

    # (d) the train CLI on a ModelNet40 pkl, then --restore --eval
    tmp = tempfile.mkdtemp(prefix="chip_smoke_modelnet_")
    try:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        with open(os.path.join(data, "clouds.pkl"), "wb") as f:
            pickle.dump(modelnet_pairs(2, MODELNET_CLI_CLOUDS), f)
        base = ["--config", "modelnet40", "--data-dir", data,
                "--batch-size", str(MODELNET_CLI_BATCH), "--checkpoint-dir",
                os.path.join(tmp, "ck")]
        run_path(f"train CLI modelnet40 ({MODELNET_CLI_CLOUDS} clouds, "
                 f"batches of {MODELNET_CLI_BATCH}, with its test epoch)",
                 lambda: cli.main(base + ["--epochs", "1", "--metrics-file",
                                          os.path.join(tmp, "train.jsonl")]),
                 {})
        rec, = read_records(os.path.join(tmp, "train.jsonl"))
        check(set(rec) == METRICS_KEYS, f"metrics record keys {sorted(rec)}")
        check(math.isfinite(rec["train_loss"]), f"modelnet CLI loss {rec}")
        check(len(rec["iou"]) == 40, "modelnet CLI: 40 classes")
        run_path("train CLI modelnet40 --restore --eval",
                 lambda: cli.main(base + ["--restore", "--eval",
                                          "--metrics-file",
                                          os.path.join(tmp, "eval.jsonl")]),
                 {})
        ev, = read_records(os.path.join(tmp, "eval.jsonl"))
        for key in ("miou", "oiou", "oacc", "iou", "acc"):
            check(ev[key] == rec[key], f"modelnet --restore --eval {key} "
                  f"{ev[key]} differs from the epoch's {rec[key]}")
        log(f"[gpn] train CLI modelnet40: train loss "
            f"{rec['train_loss']:.5f}, test oAcc {rec['oacc']!r}, mIoU "
            f"{rec['miou']!r}; --restore --eval gives them bit for bit "
            f"[{card}]")
        record["modelnet_cli_train_loss"] = rec["train_loss"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (e) K2 and K3 at GPN's new widths
    sizes = (cfg.data.num_points,) + tuple(cfg.data.caps)
    convs = [g for g in gathers if g[0] != "search"]
    f32rows = [g for g in convs if g[4] == torch.float32]
    bfrows = [g for g in convs if g[4] == torch.bfloat16]
    picks = (("widest f32", max(f32rows, key=lambda g: g[3])),
             ("narrowest f32", min(f32rows, key=lambda g: g[3])),
             ("widest bf16", max(bfrows, key=lambda g: g[3])))
    k2_rows, k3_rows = kernel_cases(
        [(f"gpn {what} ({conv})", sizes[lvl], k, f, dtype)
         for what, (conv, lvl, k, f, dtype, _) in picks], 12, card)
    log(f"[gpn] record: {json.dumps(record)}")
    return launches, k2_rows, k3_rows, record


def f32_parity(cfg, block, card, what):
    """One block's float32 forward on the card and on the CPU (weights from
    torch.Generator seed 0; the model's ``extra_keys`` fields of ``block``
    passed after xyz, feats and mask) with the argmax agreement over its
    valid points: both rows of the refine cascade, and its class-pure
    segments (the refine net's pyramid, caught by a forward pre-hook).
    Returns {row name: agreement}."""
    import dataclasses

    import torch

    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    logits, segs = {}, {}
    for dev in ("cuda", "cpu"):
        mdl = build_model(f32, torch.Generator().manual_seed(0), dev)
        if hasattr(mdl, "refine"):
            mdl.refine.register_forward_pre_hook(
                lambda m, args, dev=dev: segs.__setitem__(
                    dev, args[0].seg[0].cpu()))
        keys = ("xyz", "feats", "mask") + getattr(mdl, "extra_keys", ())
        with torch.inference_mode():
            logits[dev] = mdl(*(torch.from_numpy(block[k]).to(dev)
                                for k in keys)).cpu()
        del mdl
    valid = torch.from_numpy(block["mask"])
    card_l, cpu_l = logits["cuda"], logits["cpu"]
    check(bool(torch.isfinite(card_l).all()), f"{what} f32 logits")
    rows = {"refine": (card_l[0], cpu_l[0]), "base": (card_l[1], cpu_l[1])} \
        if card_l.dim() == 3 else {"logits": (card_l, cpu_l)}
    agree = {}
    for name, (a, b) in rows.items():
        agree[name] = float((a.argmax(1) == b.argmax(1))[valid].double()
                            .mean())
        log(f"[f32] {what} float32 {name} card vs CPU: argmax "
            f"agreement {agree[name]:.6f} over {int(valid.sum())} valid "
            f"points (need >= {ECD_ARGMAX_MIN}), max |d| "
            f"{(a - b).abs().max():.3e} [{card}]")
    if segs:
        # the segments are in the sorted order on both sides; a point's
        # segment is its (voxel, predicted class) pair
        same = float((segs["cuda"] == segs["cpu"]).double().mean())
        log(f"[composite] {what} class-pure segments card vs CPU: "
            f"{same:.6f} of the points in the same segment "
            f"({int(segs['cuda'].max())} / {int(segs['cpu'].max())} "
            f"highest ids)")
        agree["segments"] = same
    for name in rows:
        check(agree[name] >= ECD_ARGMAX_MIN,
              f"{what} {name} argmax agreement {agree[name]}")
    return agree


def phase_composite(card):
    """13: the S3DIS composite models at full width, no depth cut, bf16
    compute with f32 params and seeded weights.  (a) Each of
    ``COMPOSITE_KEYS`` takes one counted Trainer step of TRAIN_BLOCKS toy
    blocks (launches as ``composite_gathers`` counts them per block), then
    ECD_TIMED_STEPS timed, each with a finite loss; (b) each key's float32
    logits on one block against the CPU's argmax (both rows of the
    cascade); (c) one ``refine_s3dis`` step twice from one state is
    bitwise equal; (d) K2 and K3 at each row width the five keys gather
    that no earlier phase held them to; (e) the flagship with
    ``diffusion_steps=3`` sweeps N_BLOCKS blocks through
    ``eval_scene_probs``, and ``radius_neighbors`` on the card and on the
    CPU agree slot for slot; (f) the train CLI trains ``--model
    refine_s3dis`` with its test epoch, ``--restore --eval`` gives its
    metrics bit for bit, the scene eval labels a prepared room from that
    checkpoint, and the train CLI trains the flagship with
    ``--use-diffusion``.  Returns (launches, K2 rows, K3 rows, records)."""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pointcloudsegmentation_tpu_torch import interpolate
    from pointcloudsegmentation_tpu_torch.config import s3dis_config
    from pointcloudsegmentation_tpu_torch.data import s3dis, synth_rooms, toy
    from pointcloudsegmentation_tpu_torch.eval.interpolate import \
        eval_scene_probs
    from pointcloudsegmentation_tpu_torch.ops import morton, search
    from pointcloudsegmentation_tpu_torch.train import cli
    from pointcloudsegmentation_tpu_torch.train.loop import Trainer
    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    total = {"window_gather": 0, "window_dslab": 0, "window_dslab_map": 0}
    records, widths = [], {}
    batch = next(toy.toy_batches(1, batch_size=TRAIN_BLOCKS,
                                 num_points=N_POINTS, kind="room",
                                 num_classes=13, feat_dim=12))
    block0 = {k: batch[k][0] for k in ("xyz", "feats", "mask")}
    for key in COMPOSITE_KEYS:
        cfg = s3dis_config(model=key)
        gathers = composite_gathers(build_model(cfg, None, "cpu"), cfg)
        for what, n, k, f, dtype, _ in gathers:
            if what.endswith("search"):
                continue
            if n > widths.get((f, dtype), (0,))[0]:
                widths[(f, dtype)] = (n, k, f"{key} {what}")
        fwd, step = gathers_per_block(cfg, composite_gathers)
        # (a) training steps at full width
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, device="cuda")
        state = trainer.init_state(torch.Generator().manual_seed(0))
        log(f"[composite] {key}: {trainer.num_params} params, launches per "
            f"block {fwd} forward, {step} training step")
        (state, m), counts, first = run_path(
            f"{key} train step ({TRAIN_BLOCKS} x {N_POINTS} points)",
            lambda: trainer.train_step(state, batch),
            times(step, TRAIN_BLOCKS))
        total = plus(total, counts)
        losses = [float(m["loss"])]
        check(math.isfinite(losses[0]) and int(m["skipped"]) == 0,
              f"{key} train step loss {losses[0]}")

        def timed():
            st, out = state, []
            for _ in range(ECD_TIMED_STEPS):
                st, mm = trainer.train_step(st, batch)
                out.append(mm)
            torch.cuda.synchronize()
            return st, out

        (state, ms), counts, secs = run_path(
            f"{key} {ECD_TIMED_STEPS} timed train steps", timed,
            times(step, TRAIN_BLOCKS * ECD_TIMED_STEPS))
        total = plus(total, counts)
        losses += [float(mm["loss"]) for mm in ms]
        check(all(math.isfinite(x) for x in losses)
              and not any(int(mm["skipped"]) for mm in ms),
              f"{key} losses {losses}")
        pps = int(batch["mask"].sum()) * ECD_TIMED_STEPS / secs
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[composite] {key}: losses {losses}, first step {first:.2f} s "
            f"(set-up included); {secs / ECD_TIMED_STEPS:.4f} s a step over "
            f"{ECD_TIMED_STEPS} steps, {pps:.1f} train points/s, peak "
            f"{peak:.3f} GiB [{card}]")
        rec = dict(model=key, params=trainer.num_params,
                   launches_per_block=step, losses=losses, first_step_s=first,
                   step_s=secs / ECD_TIMED_STEPS, train_points_per_sec=pps,
                   peak_gib=peak)
        if key == "refine_s3dis":
            # (c) one step twice from one state: bitwise equal
            a, _ = trainer.train_step(state, batch)
            b, _ = trainer.train_step(state, batch)
            torch.cuda.synchronize()
            for field in ("params", "mu", "nu", "count"):
                check(torch.equal(getattr(a, field), getattr(b, field)),
                      f"refine_s3dis: two runs of one step differ in {field}")
            log("[composite] refine_s3dis: one step twice from one state: "
                "params, mu, nu and count bitwise equal")
            del a, b
        del trainer, state, m, ms
        torch.cuda.empty_cache()
        # (b) float32 card vs CPU on the batch's first block
        rec["argmax_agreement"] = f32_parity(cfg, block0, card, key)
        records.append(rec)

    # (d) K2 and K3 at each row width the five keys gather (F and dtype),
    # at the most rows it has
    cases = [(f"composite {what}", n, k, f, dtype)
             for (f, dtype), (n, k, what) in sorted(
                 widths.items(), key=lambda w: (str(w[0][1]), w[0][0]))]
    log(f"[composite] new gather widths: "
        f"{[(c[3], str(c[4])) for c in cases]}")
    k2_rows, k3_rows = kernel_cases(cases, 13, card)

    # (e) the flagship with probability diffusion
    dcfg = s3dis_config(diffusion_steps=DIFFUSION_STEPS)
    dmodel = build_model(dcfg, torch.Generator().manual_seed(0),
                         "cuda").eval()
    blocks, _ = make_blocks("cuda")
    fwd, step = per_block(s3dis_config())
    eval_scene_probs(dmodel, blocks[:1])       # warm-up
    (sxyz, probs), counts, secs = run_path(
        f"flagship --use-diffusion {DIFFUSION_STEPS}: {N_BLOCKS} blocks "
        f"through eval_scene_probs", lambda: eval_scene_probs(dmodel, blocks),
        times(fwd, N_BLOCKS))
    total = plus(total, counts)
    check(probs.shape == (N_BLOCKS * N_POINTS, 13) and np.isfinite(probs)
          .all(), f"diffusion probs {probs.shape}")
    dev = float(np.abs(probs.sum(1) - 1.0).max())
    check(dev <= PROB_SUM_TOL, f"diffusion probs rows sum to 1 +- {dev}")
    log(f"[composite] diffusion sweep: probs {probs.shape} finite, rows sum "
        f"to 1 +- {dev:.2e}, alpha {dmodel.diffusion.alpha.item():g}; "
        f"{secs:.3f} s for {N_BLOCKS} blocks [{card}]")
    del dmodel
    nbrs = {}
    for devname in ("cuda", "cpu"):
        b = {k: blocks[0][k].to(devname) for k in ("xyz", "mask")}
        xs, ms, _ = morton.sort_block(b["xyz"], b["mask"],
                                      dcfg.data.voxel_sizes[0] / 4,
                                      dcfg.data.block_size)
        nb = search.radius_neighbors(xs, ms, 0.1, 8, chunk=1024)
        nbrs[devname] = (nb.idx.cpu(), nb.mask.cpu())
    (gi, gm), (ci, cm) = nbrs["cuda"], nbrs["cpu"]
    valid = gm | cm
    bad = int((valid & ((gm != cm) | (gi != ci))).sum())
    share = 1.0 - bad / max(int(valid.sum()), 1)
    log(f"[composite] radius_neighbors (r 0.1, k 8) float32 card vs CPU: "
        f"{bad} of {int(valid.sum())} valid slots differ ({share:.6f} "
        f"equal, need >= {PARITY_NBR_MIN})")
    check(share >= PARITY_NBR_MIN, f"radius_neighbors parity {share}")

    # (f) the entry points
    tmp = tempfile.mkdtemp(prefix="chip_smoke_composite_")
    try:
        cfg = s3dis_config(model="refine_s3dis")
        fwd, step = gathers_per_block(cfg, composite_gathers)
        blocks_n = CLI_STEPS * TRAIN_BLOCKS
        ck = os.path.join(tmp, "ck")
        base = ["--config", "s3dis", "--model", "refine_s3dis", "--synthetic",
                "--steps-per-epoch", str(CLI_STEPS), "--batch-size",
                str(TRAIN_BLOCKS), "--num-points", str(N_POINTS),
                "--checkpoint-dir", ck]
        _, counts, _ = run_path(
            f"train CLI refine_s3dis ({CLI_STEPS} train + {CLI_STEPS} test "
            f"steps of {TRAIN_BLOCKS} x {N_POINTS} points)",
            lambda: cli.main(base + ["--epochs", "1", "--metrics-file",
                                     os.path.join(tmp, "train.jsonl")]),
            plus(times(step, blocks_n), times(fwd, blocks_n)))
        total = plus(total, counts)
        rec, = read_records(os.path.join(tmp, "train.jsonl"))
        check(set(rec) == METRICS_KEYS, f"metrics record keys {sorted(rec)}")
        check(math.isfinite(rec["train_loss"]), f"refine CLI loss {rec}")
        _, counts, _ = run_path(
            "train CLI refine_s3dis --restore --eval",
            lambda: cli.main(base + ["--restore", "--eval", "--metrics-file",
                                     os.path.join(tmp, "eval.jsonl")]),
            times(fwd, blocks_n))
        total = plus(total, counts)
        ev, = read_records(os.path.join(tmp, "eval.jsonl"))
        for name in ("miou", "oiou", "oacc", "iou", "acc"):
            check(ev[name] == rec[name], f"refine --restore --eval {name} "
                  f"{ev[name]} differs from the epoch's {rec[name]}")
        log(f"[composite] train CLI refine_s3dis: train loss "
            f"{rec['train_loss']:.5f}, test mIoU {rec['miou']!r}, oAcc "
            f"{rec['oacc']!r}; --restore --eval gives them bit for bit "
            f"[{card}]")
        scenes = os.path.join(tmp, "scenes")
        points, labels = synth_rooms.synthetic_s3dis_room(
            np.random.RandomState(0))
        prep = s3dis.prepare_room(points, labels,
                                  rng=np.random.RandomState(0))
        s3dis.save_pkl(os.path.join(scenes, "room0.pkl"), prep)
        nblk = len(prep["xyzs"])
        out, counts, secs = run_path(
            f"scene eval refine_s3dis (a prepared room: {len(points)} "
            f"points, {nblk} blocks)",
            lambda: interpolate.main([
                "--config", "s3dis", "--model", "refine_s3dis",
                "--checkpoint-dir", ck, "--scene-dir", scenes, "--out-dir",
                os.path.join(tmp, "out")]),
            times(fwd, nblk))
        total = plus(total, counts)
        r, = out
        dev = float(np.abs(r["probs"].sum(1) - 1.0).max())
        check(np.isfinite(r["probs"]).all() and dev <= PROB_SUM_TOL,
              f"refine scene probs rows sum to 1 +- {dev}")
        check(0.0 <= r["res"]["miou"] <= 1.0, f"scene mIoU {r['res']}")
        log(f"[composite] scene eval refine_s3dis: {r['points']} dense "
            f"points labelled in {r['seconds']:.3f} s, rows sum to 1 +- "
            f"{dev:.2e}, mIoU {r['res']['miou']:.4f} [{card}]")
        fwd, step = per_block(s3dis_config())
        _, counts, _ = run_path(
            f"train CLI s3dis --use-diffusion {DIFFUSION_STEPS} ({CLI_STEPS} "
            f"train + {CLI_STEPS} test steps of {TRAIN_BLOCKS} x {N_POINTS} "
            f"points)",
            lambda: cli.main([
                "--config", "s3dis", "--synthetic", "--use-diffusion",
                str(DIFFUSION_STEPS), "--epochs", "1", "--steps-per-epoch",
                str(CLI_STEPS), "--batch-size", str(TRAIN_BLOCKS),
                "--num-points", str(N_POINTS), "--metrics-file",
                os.path.join(tmp, "diffusion.jsonl")]),
            plus(times(step, blocks_n), times(fwd, blocks_n)))
        total = plus(total, counts)
        drec, = read_records(os.path.join(tmp, "diffusion.jsonl"))
        check(set(drec) == METRICS_KEYS and math.isfinite(
            drec["train_loss"]), f"diffusion CLI record {drec}")
        log(f"[composite] train CLI --use-diffusion {DIFFUSION_STEPS}: train "
            f"loss {drec['train_loss']:.5f}, test mIoU {drec['miou']:.4f} "
            f"[{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[composite] records: {json.dumps(records)}")
    return total, k2_rows, k3_rows, records


def dense_gathers(model, cfg):
    """(what, N, K, F, dtype, grad) of every window-gather launch one
    forward of ``dense_semantic3d`` makes, in order: its encoder's
    (``gather_shapes``, with ``windowed_convs``' gradient flag for each
    conv; the search reads take none).  ``DenseFeats``' k-NN reads its
    dense rows by plain indexing."""
    grads = iter([g for *_, g in windowed_convs(model, cfg)])
    return [(what, n, k, f, dtype, "search" not in what and next(grads))
            for what, n, k, f, dtype in gather_shapes(model, cfg)]


def context_gathers(model, cfg):
    """(what, N, K, F, dtype, grad) of every window-gather launch one
    forward of ``context_semantic3d`` makes: the main ECD branch's on the
    block's pyramid (``ecd_gathers``).  ``ContextNet`` launches none: its
    stages take the global search on the unsorted context cloud."""
    sizes = (cfg.data.num_points,) + tuple(cfg.data.caps)
    return [(g[0], sizes[g[1]]) + g[2:] for g in ecd_gathers(model, cfg)]


def knn_parity(block, k, card):
    """``knn_in_support`` of one dense block's sampled points in its dense
    cloud, float32 on the card and on the CPU: the share of valid slots
    whose index and validity agree."""
    import torch

    from pointcloudsegmentation_tpu_torch.ops import search

    out = {}
    for dev in ("cuda", "cpu"):
        args = [torch.from_numpy(block[key]).to(dev) for key in
                ("xyz", "mask", "dense_xyz", "dense_mask")]
        idx, _, valid = search.knn_in_support(*args, k, chunk=1024)
        out[dev] = (idx.cpu(), valid.cpu())
    (gi, gv), (ci, cv) = out["cuda"], out["cpu"]
    slots = gv | cv
    bad = int((slots & ((gv != cv) | (gi != ci))).sum())
    share = 1.0 - bad / max(int(slots.sum()), 1)
    log(f"[semantic3d] knn_in_support (k {k}, {gi.shape[0]} x "
        f"{block['dense_xyz'].shape[0]}) float32 card vs CPU: {bad} of "
        f"{int(slots.sum())} valid slots differ ({share:.6f} equal, need >= "
        f"{PARITY_NBR_MIN}) [{card}]")
    check(share >= PARITY_NBR_MIN, f"knn_in_support parity {share}")
    return share


def phase_semantic3d(card):
    """14: ``dense_semantic3d`` and ``context_semantic3d`` at full width,
    no depth cut, bf16 compute with f32 params and seeded weights, on
    blocks of the seeded outdoor scan (the context model's of the scene
    around it) served by the Provider: (a) float32
    card vs CPU; (b) S3D_PIPELINE_STEPS Trainer steps of TRAIN_BLOCKS
    blocks with the counted launches, a falling loss, a repeatable step
    and the guard; (c) the train CLI from ``--data-dir`` pkls with
    ``--restore --eval``; (d) the eval sweep with the key's extra fields;
    (e) K2 and K3 at each gather shape of the two models.  Returns
    (launches, K2 rows, K3 rows, records)."""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pointcloudsegmentation_tpu_torch.config import semantic3d_config
    from pointcloudsegmentation_tpu_torch.data import semantic3d
    from pointcloudsegmentation_tpu_torch.data.synth_outdoor import (
        scan_batches, scan_blocks)
    from pointcloudsegmentation_tpu_torch.eval.interpolate import \
        eval_scene_probs
    from pointcloudsegmentation_tpu_torch.models.dense import DenseFeats
    from pointcloudsegmentation_tpu_torch.ops import hierarchy
    from pointcloudsegmentation_tpu_torch.train import cli
    from pointcloudsegmentation_tpu_torch.train.loop import Trainer
    from pointcloudsegmentation_tpu_torch.train.model_zoo import (
        blocks_fn_for, build_model)

    total = {"window_gather": 0, "window_dslab": 0, "window_dslab_map": 0}
    records, shapes = [], {}
    gathers_fns = {"dense_semantic3d": dense_gathers,
                   "context_semantic3d": context_gathers}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_s3d_pipelines_")
    try:
        for key in S3D_PIPELINE_KEYS:
            cfg = semantic3d_config(model=key)
            d = cfg.data
            nblk = CLI_STEPS * TRAIN_BLOCKS
            context = key == "context_semantic3d"
            blocks = scan_blocks(0, d.num_points, context=context)
            check(len(blocks) >= nblk, f"{key}: {len(blocks)} blocks of >= "
                  f"{d.num_points} points from the scan, need {nblk}")
            blocks = blocks[:nblk]
            batch = scan_batches(blocks_fn_for(cfg, "semantic3d"),
                                 blocks[:TRAIN_BLOCKS], d.num_points,
                                 TRAIN_BLOCKS, "train", 0)[0]
            log(f"[semantic3d] {key}: batch "
                + ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
                + f"; valid points per block {batch['mask'].sum(1).tolist()}"
                + (f", dense {batch['dense_mask'].sum(1).tolist()}"
                   if "dense_mask" in batch else "")
                + (f", context {batch['ctx_mask'].sum(1).tolist()} of the "
                   f"blocks' {[len(b['ctx_xyz']) for b in blocks]} context "
                   f"points (the cap keeps {batch['ctx_mask'].shape[1]})"
                   if "ctx_mask" in batch else ""))
            gathers_fn = gathers_fns[key]
            for what, n, k, f, dtype, _ in gathers_fn(
                    build_model(cfg, None, "cpu"), cfg):
                if "search" not in what:
                    shapes.setdefault((n, k, f, dtype), f"{key} {what}")
            fwd, step = gathers_per_block(cfg, gathers_fn)
            block0 = {k: v[0] for k, v in batch.items()}
            # (a) float32 card vs CPU on the batch's first block
            rec = dict(model=key, f32=f32_parity(cfg, block0, card, key))
            if context:
                rec["ctx_points"] = [len(b["ctx_xyz"]) for b in blocks]
            if key == "dense_semantic3d":
                rec["knn_slots"] = knn_parity(block0, DenseFeats.k, card)
            # (b) training steps on one batch at full width
            torch.cuda.reset_peak_memory_stats()
            trainer = Trainer(cfg, device="cuda")
            state = trainer.init_state(torch.Generator().manual_seed(0))
            log(f"[semantic3d] {key}: {trainer.num_params} params, launches "
                f"per block {fwd} forward, {step} training step")
            (state, m), counts, first = run_path(
                f"{key} train step ({TRAIN_BLOCKS} blocks)",
                lambda: trainer.train_step(state, batch),
                times(step, TRAIN_BLOCKS))
            total = plus(total, counts)
            losses = [float(m["loss"])]
            check(int(m["skipped"]) == 0, f"{key} first step skipped")
            state0 = state

            def timed():
                st, out = state, []
                for _ in range(S3D_PIPELINE_STEPS - 1):
                    st, mm = trainer.train_step(st, batch)
                    out.append(mm)
                torch.cuda.synchronize()
                return st, out

            steps = S3D_PIPELINE_STEPS - 1
            (state, ms), counts, secs = run_path(
                f"{key} {steps} timed train steps", timed,
                times(step, TRAIN_BLOCKS * steps))
            total = plus(total, counts)
            losses += [float(mm["loss"]) for mm in ms]
            check(all(math.isfinite(x) for x in losses)
                  and not any(int(mm["skipped"]) for mm in ms),
                  f"{key} losses {losses}")
            check(losses[-1] < losses[0], f"{key} loss does not fall: "
                  f"{losses}")
            pps = int(batch["mask"].sum()) * steps / secs
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"[semantic3d] {key}: losses {losses} (falling), first step "
                f"{first:.2f} s (set-up included); {secs / steps:.4f} s a "
                f"step over {steps} steps, {pps:.1f} train points/s, peak "
                f"{peak:.3f} GiB [{card}]")
            a, _ = trainer.train_step(state0, batch)
            b, _ = trainer.train_step(state0, batch)
            bad = {k: v.copy() for k, v in batch.items()}
            bad["feats"][-1, 100, 0] = float("nan")
            c, mc = trainer.train_step(a, bad)
            torch.cuda.synchronize()
            for field in ("params", "mu", "nu", "count"):
                check(torch.equal(getattr(a, field), getattr(b, field)),
                      f"{key}: two runs of one step differ in {field}")
                check(torch.equal(getattr(c, field), getattr(a, field)),
                      f"{key}: the NaN batch changed {field}")
            check(int(mc["skipped"]) == 1, f"{key}: NaN batch not skipped")
            log(f"[semantic3d] {key}: one step twice from one state: params, "
                f"mu, nu and count bitwise equal; NaN feature: skipped="
                f"{int(mc['skipped'])}, state unchanged")
            if key == "context_semantic3d":
                mdl = trainer.model
                dev_b = {k: torch.from_numpy(v[0]).cuda()
                         for k, v in batch.items()}
                reset_counts()
                with torch.no_grad():
                    pyr = hierarchy.build_pyramid(
                        dev_b["ctx_xyz"], dev_b["ctx_mask"],
                        (mdl.ctx_voxel_size,), (mdl.ctx_cap,),
                        mdl.ctx_block_size)
                    mdl.context(pyr, dev_b["ctx_feats"])
                ctx_counts = read_counts()
                check(not any(ctx_counts.values()),
                      f"ContextNet launched {ctx_counts}")
                log(f"[semantic3d] ContextNet alone on the card: launches "
                    f"{ctx_counts}")
            # (d) the eval sweep with the key's extra fields
            model = trainer.bind(state).eval()
            sweep = [{k: v[i] for k, v in batch.items()}
                     for i in range(TRAIN_BLOCKS)]
            (sxyz, probs), counts, ssecs = run_path(
                f"{key} eval_scene_probs ({TRAIN_BLOCKS} blocks)",
                lambda: eval_scene_probs(model, sweep,
                                         extra_keys=model.extra_keys),
                times(fwd, TRAIN_BLOCKS))
            total = plus(total, counts)
            dev = float(np.abs(probs.sum(1) - 1.0).max())
            check(probs.shape == (int(batch["mask"].sum()), d.num_classes)
                  and np.isfinite(probs).all() and dev <= PROB_SUM_TOL,
                  f"{key} sweep probs {probs.shape}, rows sum to 1 +- {dev}")
            log(f"[semantic3d] {key} sweep: probs {probs.shape} finite, rows "
                f"sum to 1 +- {dev:.2e}; {ssecs:.3f} s for {TRAIN_BLOCKS} "
                f"blocks [{card}]")
            rec.update(params=trainer.num_params, launches_per_block=step,
                       losses=losses, first_step_s=first,
                       step_s=secs / steps, train_points_per_sec=pps,
                       peak_gib=peak)
            del trainer, state, state0, model, a, b, c, m, ms
            torch.cuda.empty_cache()
            # (c) the train CLI from --data-dir pkls, and --restore --eval
            pkl = os.path.join(tmp, key, "pkl")
            semantic3d.save_blocks(os.path.join(pkl, "scan0.pkl"), blocks)
            ck = os.path.join(tmp, key, "ck")
            base = ["--config", "semantic3d", "--model", key, "--data-dir",
                    pkl, "--batch-size", str(TRAIN_BLOCKS),
                    "--checkpoint-dir", ck]
            _, counts, csecs = run_path(
                f"train CLI {key} --data-dir ({CLI_STEPS} train + "
                f"{CLI_STEPS} test steps of {TRAIN_BLOCKS} blocks)",
                lambda: cli.main(base + [
                    "--epochs", "1", "--metrics-file",
                    os.path.join(tmp, key, "train.jsonl")]),
                plus(times(step, nblk), times(fwd, nblk)))
            total = plus(total, counts)
            crec, = read_records(os.path.join(tmp, key, "train.jsonl"))
            check(set(crec) == METRICS_KEYS and math.isfinite(
                crec["train_loss"]) and len(crec["iou"]) == d.num_classes,
                f"{key} CLI record {crec}")
            _, counts, _ = run_path(
                f"train CLI {key} --restore --eval",
                lambda: cli.main(base + ["--restore", "--eval",
                                         "--metrics-file",
                                         os.path.join(tmp, key,
                                                      "eval.jsonl")]),
                times(fwd, nblk))
            total = plus(total, counts)
            ev, = read_records(os.path.join(tmp, key, "eval.jsonl"))
            for name in ("miou", "oiou", "oacc", "iou", "acc"):
                check(ev[name] == crec[name], f"{key} --restore --eval "
                      f"{name} {ev[name]} differs from the epoch's "
                      f"{crec[name]}")
            log(f"[semantic3d] train CLI {key}: train loss "
                f"{crec['train_loss']:.5f}, test mIoU {crec['miou']!r}, oAcc "
                f"{crec['oacc']!r}, {crec['points_per_sec']:.1f} train "
                f"points/s in {csecs:.2f} s; --restore --eval gives them bit "
                f"for bit [{card}]")
            rec["cli"] = dict(train_loss=crec["train_loss"],
                              miou=crec["miou"], oacc=crec["oacc"])
            records.append(rec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (e) K2 and K3 at each conv gather shape of the two models
    cases = [(what, n, k, f, dtype) for (n, k, f, dtype), what in
             shapes.items()]
    log(f"[semantic3d] gather shapes: "
        f"{[(c[1], c[2], c[3], str(c[4])) for c in cases]}")
    k2_rows, k3_rows = kernel_cases(cases, 14, card)
    log(f"[semantic3d] records: {json.dumps(records)}")
    return total, k2_rows, k3_rows, records


def scan_per_block(cfg):
    """Kernel launches per block of a forward and of a training step of a
    phase-15 key."""
    if cfg.model == "dense_semantic3d":
        return gathers_per_block(cfg, dense_gathers)
    if cfg.model == "context_semantic3d":
        return gathers_per_block(cfg, context_gathers)
    return per_block(cfg)


def interp_arms(sxyz, probs, qxyz, card):
    """Arm 0's probabilities interpolated onto the scan by the native
    library and by the device arm, with both arms' seconds and the device
    arm's peak memory.  The blocks overlap, so the support holds copies of
    one point an ulp apart with other probabilities; the device arm ranks
    by the native library's rounding of the distances (``knn_exact``), so
    over every scan point the argmax must agree and the probabilities
    match.  Returns a record of the comparison."""
    import numpy as np
    import torch

    from pointcloudsegmentation_tpu_torch.eval.interpolate import (
        SEMANTIC3D_RATIO, interpolate_to_dense)

    t0 = time.perf_counter()
    host = interpolate_to_dense(sxyz, probs, qxyz, k=SCAN_KNN,
                                ratio=SEMANTIC3D_RATIO)
    host_s = time.perf_counter() - t0
    s_d, p_d, q_d = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                     for a in (sxyz, probs, qxyz))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    dev = interpolate_to_dense(s_d, p_d, q_d, k=SCAN_KNN,
                               ratio=SEMANTIC3D_RATIO, prefer_native=False)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    dev = dev.cpu().numpy()
    dp = np.abs(host - dev).max(1)
    rec = dict(points=len(qxyz), support=len(sxyz), native_s=host_s,
               device_s=dev_s, device_peak_gib=peak,
               argmax=float((host.argmax(1) == dev.argmax(1)).mean()),
               max_dp=float(dp.max()),
               over_tol=int((dp > INTERP_PROB_TOL).sum()))
    log(f"[scan] interpolation of arm 0 ({len(sxyz)} support -> "
        f"{len(qxyz)} scan points, k {SCAN_KNN}): native {host_s:.3f} s, "
        f"device {dev_s:.3f} s (peak {peak:.3f} GiB above its inputs) "
        f"[{card}]; over every scan point argmax agreement "
        f"{rec['argmax']:.6f} (need >= {INTERP_ARGMAX_MIN}), max |dp| "
        f"{rec['max_dp']:.3e} (need <= {INTERP_PROB_TOL}; "
        f"{rec['over_tol']} points above it)")
    check(rec["argmax"] >= INTERP_ARGMAX_MIN,
          f"interpolation argmax {rec['argmax']}")
    check(rec["max_dp"] <= INTERP_PROB_TOL,
          f"interpolation probabilities {rec['max_dp']}")
    return rec


def phase_scan(card):
    """15: a Semantic3D scan from raw file to submission through the
    entry points, at full width (see the module docstring).  Returns
    (launches, records)."""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pointcloudsegmentation_tpu_torch import interpolate, prepare_data
    from pointcloudsegmentation_tpu_torch.config import semantic3d_config
    from pointcloudsegmentation_tpu_torch.data import io_util, semantic3d
    from pointcloudsegmentation_tpu_torch.data.synth_outdoor import \
        outdoor_scan
    from pointcloudsegmentation_tpu_torch.eval.interpolate import \
        eval_scene_probs
    from pointcloudsegmentation_tpu_torch.train import cli
    from pointcloudsegmentation_tpu_torch.train.checkpoint import \
        CheckpointManager
    from pointcloudsegmentation_tpu_torch.train.loop import Trainer
    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    total = {"window_gather": 0, "window_dslab": 0, "window_dslab_map": 0}
    records = {"prep_s": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_scan_")
    try:
        points, labels = outdoor_scan(0)
        n = len(points)
        t0 = time.perf_counter()
        semantic3d.write_points_txt(os.path.join(tmp, "raw", "scan0.txt"),
                                    points, labels)
        log(f"[scan] wrote the seeded scan ({n} points) as scan0.txt + "
            f".labels in {time.perf_counter() - t0:.2f} s")
        # (a) the prep, three modes
        dirs = {"semantic3d": os.path.join(tmp, "blocks"),
                "semantic3d_context": os.path.join(tmp, "ctx"),
                "semantic3d_test": os.path.join(tmp, "sem3d")}
        for mode, out in dirs.items():
            extra = ["--rotations", str(SCAN_ROTATIONS)] \
                if mode == "semantic3d_test" else []
            t0 = time.perf_counter()
            (path, count), = prepare_data.main(
                [mode, "--raw-dir", os.path.join(tmp, "raw"), "--out-dir",
                 out, "--workers", str(SCAN_WORKERS)] + extra)
            secs = time.perf_counter() - t0
            records["prep_s"][mode] = secs
            log(f"[scan] prepare_data {' '.join([mode] + extra)} --workers "
                f"{SCAN_WORKERS}: {count} blocks in {secs:.2f} s of host "
                f"time")
        test = os.path.join(dirs["semantic3d_test"], "test")
        arm_dirs = [test] + [f"{test}_{ri}"
                             for ri in range(1, SCAN_ROTATIONS + 1)]
        arm_blocks = [len(io_util.read_pkl(os.path.join(d, "scan0.pkl"))
                          ["xyzs"]) for d in arm_dirs]
        log(f"[scan] eval blocks per rotation arm: {arm_blocks}")
        for key in SCAN_KEYS:
            cfg = semantic3d_config(model=key)
            fwd, step = scan_per_block(cfg)
            rec = records.setdefault(key, {})
            # (b) the train CLI, one epoch, with a checkpoint
            data_dir = dirs["semantic3d_context" if key ==
                            "context_semantic3d" else "semantic3d"]
            nblk = len(io_util.read_pkl(os.path.join(data_dir,
                                                     "scan0.pkl")))
            padded = -(-nblk // TRAIN_BLOCKS) * TRAIN_BLOCKS
            ck = os.path.join(tmp, "ck", key)
            _, counts, secs = run_path(
                f"train CLI {key} on the prepared scan ({nblk} blocks, "
                f"batches of {TRAIN_BLOCKS}; train and test epoch)",
                lambda: cli.main([
                    "--config", "semantic3d", "--model", key, "--data-dir",
                    data_dir, "--epochs", "1", "--batch-size",
                    str(TRAIN_BLOCKS), "--checkpoint-dir", ck,
                    "--metrics-file", os.path.join(tmp, f"{key}.jsonl")]),
                plus(times(step, padded), times(fwd, padded)))
            total = plus(total, counts)
            crec, = read_records(os.path.join(tmp, f"{key}.jsonl"))
            check(math.isfinite(crec["train_loss"])
                  and os.path.exists(os.path.join(ck, "epoch_000000.pt")),
                  f"{key} CLI record {crec}")
            rec.update(train_blocks=nblk, train_s=secs,
                       train_loss=crec["train_loss"])
            # (c) float32 card vs CPU on arm 0's first test block
            block = interpolate.load_blocks(
                os.path.join(test, "scan0.pkl"), cfg, "semantic3d",
                np.random.RandomState(0),
                getattr(build_model(cfg, None, "cpu"), "extra_keys", ()))[0]
            rec["f32"] = f32_parity(cfg, block, card, f"{key} test block")
            # (d) the scene eval, to .labels
            arms = SCAN_ROTATIONS if key == "pointnet_semantic3d" else 0
            out = os.path.join(tmp, "out", key)
            (r,), counts, secs = run_path(
                f"scene eval {key} --rot-ensemble {arms} --labels-out "
                f"({arm_blocks[:arms + 1]} blocks)",
                lambda: interpolate.main([
                    "--config", "semantic3d", "--model", key,
                    "--checkpoint-dir", ck, "--scene-dir", test,
                    "--rot-ensemble", str(arms), "--labels-out",
                    "--out-dir", out]),
                times(fwd, sum(arm_blocks[:arms + 1])))
            total = plus(total, counts)
            with open(os.path.join(out, "scan0.labels")) as f:
                written = np.array([int(x) for x in f.read().split()])
            probs = r["probs"]
            dev = float(np.abs(probs.sum(1) - 1.0).max())
            check(len(written) == n and written.min() >= 1
                  and written.max() <= 8,
                  f"{key}: {len(written)} labels in [{written.min()}, "
                  f"{written.max()}] for {n} scan points")
            check(probs.shape == (n, 8) and np.isfinite(probs).all()
                  and dev <= PROB_SUM_TOL,
                  f"{key} probs {probs.shape}, rows sum to 1 +- {dev}")
            check(np.array_equal(written, probs.argmax(1) + 1),
                  f"{key}: the labels are not the probabilities' argmax")
            pps = n / r["seconds"]
            hist = np.bincount(written, minlength=9)[1:].tolist()
            log(f"[scan] scene eval {key}: {len(written)} labels in 1..8 "
                f"(counts {hist}), probs rows sum to 1 +- {dev:.2e}, mIoU "
                f"{None if r['res'] is None else r['res']['miou']}; "
                f"{r['seconds']:.3f} s for {arms + 1} arm(s) (sweep + "
                f"interpolation): {pps:.1f} dense points/s; {secs:.2f} s "
                f"with restore and reads [{card}]")
            rec.update(arms=arms + 1, eval_s=r["seconds"],
                       dense_points_per_sec=pps, eval_total_s=secs)
        # (e) arm 0 of the restored pointnet_semantic3d
        cfg = semantic3d_config()
        fwd, _ = scan_per_block(cfg)
        trainer = Trainer(cfg, device="cuda")
        ckpt = CheckpointManager(os.path.join(tmp, "ck", cfg.model))
        model = trainer.bind(trainer.init_state(
            state=ckpt.restore(device="cuda"))).eval()
        ckpt.close()
        data = io_util.read_pkl(os.path.join(test, "scan0.pkl"))
        blocks = interpolate.read_scene(data, cfg, "semantic3d",
                                        np.random.RandomState(0))
        sweeps = []
        for i in range(2):
            out, counts, _ = run_path(
                f"arm 0 sweep {i + 1} of pointnet_semantic3d "
                f"({len(blocks)} blocks)",
                lambda: eval_scene_probs(model, blocks), times(fwd,
                                                               len(blocks)))
            total = plus(total, counts)
            sweeps.append(out)
        check(np.array_equal(sweeps[0][0], sweeps[1][0])
              and np.array_equal(sweeps[0][1], sweeps[1][1]),
              "two sweeps of arm 0 differ")
        log("[scan] two sweeps of arm 0: points and probabilities bitwise "
            "equal")
        records["interp"] = interp_arms(*sweeps[0], data["scan_xyz"], card)
        del model, trainer
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[scan] records: {json.dumps(records)}")
    return total, records



# -- phase 16: the parallel paths on the one card ---------------------------

def p16_batch():
    """Phase 7's first batch: 4 toy blocks of 8192 points (seed 0)."""
    from pointcloudsegmentation_tpu_torch.data import toy

    return next(toy.toy_batches(1, batch_size=TRAIN_BLOCKS,
                                num_points=N_POINTS, kind="room",
                                num_classes=13, feat_dim=12))


def p16_group(store, n, rank, backend):
    """Join a group of ``n`` ranks on the card with phase 16's timeout."""
    import datetime

    import torch

    from pointcloudsegmentation_tpu_torch.parallel import (global_mesh,
                                                           initialize)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize(store, n, rank, backend=backend, device="cuda",
               timeout=datetime.timedelta(seconds=P16_TIMEOUT))
    return global_mesh("cuda")


def p16_steps(trainer, batch):
    """``P16_STEPS`` training steps from the seed-0 state: (per step: its
    metrics on the host, params and seconds), the last state."""
    import torch

    state = trainer.init_state(torch.Generator().manual_seed(0))
    steps = []
    for _ in range(P16_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        steps.append(({k: v.cpu() for k, v in m.items()},
                      state.params.cpu(), time.perf_counter() - t0))
    return steps, state


def p16_train_rank(rank, n, store, out_dir):
    """One of the gloo ranks sharing the card in phase 16 (a)."""
    import torch

    from pointcloudsegmentation_tpu_torch.config import s3dis_config
    from pointcloudsegmentation_tpu_torch.parallel import shard_batch
    from pointcloudsegmentation_tpu_torch.train.loop import Trainer

    mesh = p16_group(store, n, rank, "gloo")
    try:
        trainer = Trainer(s3dis_config(), device=mesh.device, mesh=mesh)
        batch = shard_batch(p16_batch(), mesh)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        loss, grad = trainer.loss_and_grad(state, batch, train=True)
        out = {"loss": float(loss), "grad": grad.cpu()}
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out["steps"], _ = p16_steps(trainer, batch)
        out["counts"] = read_counts()
        out["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.save(out, os.path.join(out_dir, f"train{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def p16_trainer(card):
    """16 (a): the mesh trainer at world size 1 on NCCL in this process,
    bitwise against ``Trainer(mesh=None)``, then 2 gloo ranks sharing the
    card against the one-process step."""
    import tempfile

    import torch

    from pointcloudsegmentation_tpu_torch.config import s3dis_config
    from pointcloudsegmentation_tpu_torch.parallel import run_ranks
    from pointcloudsegmentation_tpu_torch.train.loop import Trainer

    cfg = s3dis_config()
    batch = p16_batch()
    fwd, step = per_block(cfg)
    block0 = [torch.from_numpy(batch[k][0]).cuda()
              for k in ("xyz", "feats", "mask")]

    def run(trainer):
        torch.cuda.reset_peak_memory_stats()
        steps, state = p16_steps(trainer, batch)
        with torch.no_grad():
            logits = trainer.bind(state)(*block0, train=False)
        return (steps, logits.cpu(),
                torch.cuda.max_memory_allocated() / 2 ** 30)

    ref = Trainer(cfg, device="cuda")
    ref_loss, ref_grad = ref.loss_and_grad(
        ref.init_state(torch.Generator().manual_seed(0)), batch, train=True)
    ref_loss, ref_grad = float(ref_loss), ref_grad.cpu()
    ref_steps, ref_logits, ref_peak = run(ref)
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        mesh = p16_group("file://" + os.path.join(tmp, "nccl"), 1, 0, "nccl")
        try:
            trainer = Trainer(cfg, device=mesh.device, mesh=mesh)
            reset_counts()
            steps, logits, peak = run(trainer)
            counts = read_counts()
        finally:
            torch.distributed.destroy_process_group()
        expect = plus(times(step, P16_STEPS * TRAIN_BLOCKS), fwd)
        log(f"[parallel] (a) mesh of 1 rank on {mesh.backend} "
            f"({mesh.device}): launches "
            + ", ".join(f"{k} {v} (expected {expect[k]})"
                        for k, v in counts.items()))
        check(counts == expect, f"mesh of 1 launches {counts}")
        total = plus(total, counts)
        for i, ((m, p, _), (rm, rp, _)) in enumerate(zip(steps, ref_steps)):
            for key in rm:
                check(torch.equal(m[key], rm[key]),
                      f"NCCL mesh of 1, step {i + 1}: {key} differs")
            check(torch.equal(p, rp), f"NCCL mesh of 1, step {i + 1}: "
                  "params differ")
        check(torch.equal(logits, ref_logits), "NCCL mesh of 1: logits "
              "differ")
        log(f"[parallel] (a) NCCL mesh of 1 vs Trainer(mesh=None), "
            f"{P16_STEPS} steps of {TRAIN_BLOCKS} x {N_POINTS} points: loss, "
            f"metrics and params after every step and the logits of block 0 "
            f"bitwise equal; losses "
            + ", ".join(f"{float(m['loss']):.6f}" for m, _, _ in steps)
            + "; step s "
            + ", ".join(f"{t:.4f}" for *_, t in steps)
            + f" (alone: " + ", ".join(f"{t:.4f}" for *_, t in ref_steps)
            + f"); peak {peak:.3f} GiB (alone {ref_peak:.3f}) [{card}]")

        store = "file://" + os.path.join(tmp, "gloo_train")
        t0 = time.perf_counter()
        run_ranks(p16_train_rank, P16_GLOO_RANKS,
                  (P16_GLOO_RANKS, store, tmp), timeout=P16_TIMEOUT)
        secs = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"train{r}.pt"))
                 for r in range(P16_GLOO_RANKS)]
    per_rank = TRAIN_BLOCKS // P16_GLOO_RANKS
    expect = times(step, P16_STEPS * per_rank)
    g_scale = ref_grad.abs().max().item()
    for r, res in enumerate(ranks):
        check(res["counts"] == expect, f"gloo rank {r} launches "
              f"{res['counts']}, expected {expect}")
        total = plus(total, res["counts"])
        rel = abs(res["loss"] - ref_loss) / abs(ref_loss)
        dg = (res["grad"] - ref_grad).abs().max().item()
        check(rel <= P16_LOSS_RTOL, f"gloo rank {r}: step-1 loss "
              f"{res['loss']} vs {ref_loss}")
        check(dg <= P16_GRAD_REL * g_scale, f"gloo rank {r}: gradient "
              f"max |d| {dg} of max |g| {g_scale}")
        m1 = res["steps"][0][0]
        for key in ("cm", "correct", "count"):
            check(torch.equal(m1[key], ref_steps[0][0][key]),
                  f"gloo rank {r}: step-1 {key} differs")
        log(f"[parallel] (a) gloo rank {r} of {P16_GLOO_RANKS} on the card "
            f"({per_rank} blocks): step-1 loss rel {rel:.2e} (need <= "
            f"{P16_LOSS_RTOL:g}), gradient max |d| {dg:.3e} = "
            f"{dg / g_scale:.2e} of max |g| {g_scale:.4f} (need <= "
            f"{P16_GRAD_REL:g}), step-1 cm/correct/count equal; launches "
            f"{res['counts']} ({per_rank} x (16 K2 + 13 K3) a step); step s "
            + ", ".join(f"{t:.4f}" for *_, t in res["steps"])
            + f"; peak {res['peak']:.3f} GiB [{card}]")
    for i in range(P16_STEPS):
        check(all(torch.equal(res["steps"][i][1], ranks[0]["steps"][i][1])
                  for res in ranks), f"gloo ranks' params differ after "
              f"step {i + 1}")
    log(f"[parallel] (a) gloo ranks' params bitwise equal after each of "
        f"{P16_STEPS} steps; the group took {secs:.1f} s with its spawn")
    return total


def p16_cli(card):
    """16 (b): the train CLI's default (the mesh, one card, NCCL) and
    ``--no-mesh`` give the same metrics record bit for bit."""
    import tempfile

    from pointcloudsegmentation_tpu_torch.config import s3dis_config
    from pointcloudsegmentation_tpu_torch.train import cli

    fwd, step = per_block(s3dis_config(data_num_points=N_POINTS))
    blocks = CLI_STEPS * TRAIN_BLOCKS
    expect = plus(times(step, blocks), times(fwd, blocks))
    base = ["--config", "s3dis", "--synthetic", "--epochs", "1",
            "--steps-per-epoch", str(CLI_STEPS), "--batch-size",
            str(TRAIN_BLOCKS), "--num-points", str(N_POINTS)]
    total, recs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in (("mesh", []), ("no-mesh", ["--no-mesh"])):
            path = os.path.join(tmp, f"{name}.jsonl")
            _, counts, _ = run_path(
                f"(b) train CLI {name} ({CLI_STEPS} train + {CLI_STEPS} "
                f"test steps of {TRAIN_BLOCKS} x {N_POINTS} points)",
                lambda: cli.main(base + extra + ["--metrics-file", path]),
                expect)
            total = plus(total, counts)
            recs[name], = read_records(path)
    a, b = recs["mesh"], recs["no-mesh"]
    check(set(a) == set(b) == METRICS_KEYS, f"record keys {sorted(a)}")
    for k in METRICS_KEYS - {"points_per_sec"}:
        check(a[k] == b[k], f"CLI mesh vs --no-mesh: {k} {a[k]} != {b[k]}")
    log(f"[parallel] (b) CLI mesh vs --no-mesh: every key of the record "
        f"but the throughput bit for bit (train_loss {a['train_loss']!r}, "
        f"mIoU {a['miou']!r}); {a['points_per_sec']:.1f} vs "
        f"{b['points_per_sec']:.1f} train points/s [{card}]")
    return total


def p16_scene_cfg():
    """The flagship in float32 sized as ``scripts/halo_study.py`` sizes its
    model: for the largest extended shard (the reference's, halo = L),
    caps at one voxel a point (the corridor is sparse), block size the
    corridor's length."""
    from pointcloudsegmentation_tpu_torch.config import s3dis_config

    ext = 3 * P16_SHARD
    return s3dis_config(data_num_points=ext, data_caps=(ext, ext // 2),
                        data_block_size=P16_SCENE_LENGTH,
                        compute_dtype="float32")


def p16_scene():
    """The port's ``halo_study.corridor_scene`` at 4 x 8192 points over
    48 m, as numpy (xyz, feats, mask)."""
    import numpy as np

    from pointcloudsegmentation_tpu_torch.halo_study import corridor_scene

    return corridor_scene(np.random.RandomState(0), P16_SCENE_POINTS,
                          P16_SCENE_LENGTH)


def p16_apply(model):
    return lambda x, f, m: model(x, f, m, train=False)


def p16_scene_rank(rank, n, store, out_dir, halo):
    """One of the 4 gloo ranks sharing the card in phase 16 (c); after its
    card arms it also runs its own shard of the geom mode's sequential run
    on the CPU (``shard_logits``), so the 4 shards of the CPU reference run
    side by side."""
    import torch

    from pointcloudsegmentation_tpu_torch.ops import morton
    from pointcloudsegmentation_tpu_torch.parallel.scene_shard import (
        exchange_shard, model_receptive_field, scene_apply, shard_logits)
    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    mesh = p16_group(store, n, rank, "gloo")
    try:
        cfg = p16_scene_cfg()
        cell = cfg.data.voxel_sizes[-1]
        model = build_model(cfg, torch.Generator().manual_seed(0),
                            mesh.device).eval()
        rf = model_receptive_field(model.encoder.arch)
        xyz, feats, mask = (torch.from_numpy(a).to(mesh.device)
                            for a in p16_scene())
        out = {}
        torch.cuda.reset_peak_memory_stats()
        for arm, mode, h in (("geom", "geom", halo), ("index", "index", halo),
                             ("full", "index", P16_SHARD)):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits = scene_apply(
                    p16_apply(model), xyz, feats, mask, mesh, halo=h,
                    sort_cell=P16_SORT_CELL, scene_extent=P16_SCENE_LENGTH,
                    receptive_field=rf if arm == "geom" else 0.0,
                    halo_mode=mode, halo_cell=cell)
            torch.cuda.synchronize()
            out[arm] = {"seconds": time.perf_counter() - t0,
                        "counts": read_counts(), "logits": logits.cpu()}
        out["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
        xs, ms, _ = morton.sort_block(xyz, mask, P16_SORT_CELL,
                                      P16_SCENE_LENGTH)
        rows = torch.arange(xs.shape[0], dtype=torch.float32,
                            device=xs.device)[:, None]
        core = slice(rank * P16_SHARD, (rank + 1) * P16_SHARD)
        for mode in ("geom", "index"):
            _, r, m = exchange_shard(xs[core], rows[core], ms[core], halo,
                                     mesh, mode, cell)
            out[mode]["rows"], out[mode]["mask"] = r[:, 0].long().cpu(), \
                m.cpu()
        # this shard of the sequential run on the CPU (a quarter of the
        # host's cores: 4 ranks share them)
        torch.set_num_threads(max(os.cpu_count() // n, 1))
        cpu = model.cpu()
        xs, ms, _, fs = morton.sort_block(xyz.cpu(), mask.cpu(),
                                          P16_SORT_CELL, P16_SCENE_LENGTH,
                                          feats.cpu())
        t0 = time.perf_counter()
        with torch.no_grad():
            out["geom"]["cpu_core"] = shard_logits(
                p16_apply(cpu), xs, fs, ms, n, rank, halo, "geom", cell)
        out["cpu_seconds"] = time.perf_counter() - t0
        torch.save(out, os.path.join(out_dir, f"scene{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


ZERO_COUNTS = {"window_gather": 0, "window_dslab": 0, "window_dslab_map": 0}


def p16_agree(a, b):
    return float((a.argmax(-1) == b.argmax(-1)).double().mean())


def p16_scene_apply(card):
    """16 (c): ``scene_apply`` over 4 gloo ranks sharing the card, both halo
    modes, against the sequential run of the same extended shards on the
    card, and the geom mode's also on the CPU."""
    import tempfile

    import torch

    from pointcloudsegmentation_tpu_torch.ops import morton
    from pointcloudsegmentation_tpu_torch.parallel import run_ranks
    from pointcloudsegmentation_tpu_torch.parallel.scene_shard import (
        extended_shard, geometric_required_halo, model_receptive_field,
        sequential_scene_apply)
    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    cfg = p16_scene_cfg()
    cell = cfg.data.voxel_sizes[-1]
    xyz, feats, mask = (torch.from_numpy(a) for a in p16_scene())
    xs, ms, order = morton.sort_block(xyz, mask, P16_SORT_CELL,
                                      P16_SCENE_LENGTH)
    model = build_model(cfg, torch.Generator().manual_seed(0), "cpu").eval()
    rf = model_receptive_field(model.encoder.arch)
    t0 = time.perf_counter()
    need, unreachable = geometric_required_halo(
        xs.numpy(), ms.numpy(), P16_SCENE_RANKS, rf, cell_size=cell)
    t_rule = time.perf_counter() - t0
    halo = -(-need // 256) * 256
    ext = P16_SHARD + 2 * halo
    check(unreachable == 0 and halo <= P16_SHARD,
          f"required halo {need} ({unreachable} unreachable pairs)")
    fwd, _ = per_block(at_points(cfg, ext))
    full_fwd, _ = per_block(cfg)
    log(f"[parallel] (c) corridor {P16_SCENE_POINTS} points over "
        f"{P16_SCENE_LENGTH:g} m, {P16_SCENE_RANKS} shards of {P16_SHARD}: "
        f"flagship receptive field {rf:.2f} m, geometric_required_halo "
        f"{need} with cells of {cell:g} m ({t_rule:.2f} s on the host) -> "
        f"halo {halo}, extended shard {ext} points; K2 per shard "
        f"{fwd['window_gather']} (full-neighbour arm "
        f"{full_fwd['window_gather']})")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run_ranks(p16_scene_rank, P16_SCENE_RANKS,
                  (P16_SCENE_RANKS, "file://" + os.path.join(tmp, "s"), tmp,
                   halo), timeout=P16_TIMEOUT)
        t_ranks = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"scene{r}.pt"))
                 for r in range(P16_SCENE_RANKS)]
    inv = morton.inverse_permutation(order)
    seq_cpu = torch.cat([res["geom"]["cpu_core"] for res in ranks])[inv]
    total = {}
    expect = {"geom": fwd, "index": fwd, "full": full_fwd}
    for r, res in enumerate(ranks):
        for arm in ("geom", "index", "full"):
            check(res[arm]["counts"] == plus(expect[arm], ZERO_COUNTS),
                  f"rank {r} {arm}: "
                  f"launches {res[arm]['counts']}, expected {expect[arm]}")
            total = plus(total, res[arm]["counts"])
    gpu = model.cuda()
    xs_g, ms_g = xs.cuda(), ms.cuda()
    rows = torch.arange(P16_SCENE_POINTS, dtype=torch.float32,
                        device="cuda")[:, None]
    for mode in ("geom", "index"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            seq = sequential_scene_apply(
                p16_apply(gpu), xyz.cuda(), feats.cuda(), mask.cuda(),
                P16_SCENE_RANKS, halo, P16_SORT_CELL, P16_SCENE_LENGTH,
                halo_mode=mode, halo_cell=cell).cpu()
        t_seq = time.perf_counter() - t0
        if mode == "geom":
            agree_cpu = p16_agree(seq, seq_cpu)
            check(agree_cpu >= SCENE_ARGMAX_MIN, f"{mode}: card vs CPU "
                  f"sequential argmax {agree_cpu}")
            vs_cpu = f"card vs CPU sequential argmax {agree_cpu:.6f}"
        else:
            vs_cpu = "no CPU run (the halo rows differ, held above)"
        scale = max(1.0, float(seq.abs().max()))
        worst, worst_d, n_equal = 1.0, 0.0, 0
        for r, res in enumerate(ranks):
            got = res[mode]["logits"]
            probs = torch.softmax(got.double(), -1)
            dev = float((probs.sum(-1) - 1).abs().max())
            check(bool(torch.isfinite(probs).all()) and
                  dev <= PROB_SUM_TOL, f"rank {r} {mode}: probs rows sum "
                  f"to 1 +- {dev}")
            agree = p16_agree(got, seq)
            worst = min(worst, agree)
            check(agree >= SCENE_ARGMAX_MIN, f"rank {r} {mode}: argmax "
                  f"{agree} against the sequential run")
            d = float((got - seq).abs().max())
            worst_d = max(worst_d, d)
            n_equal += int(torch.equal(got, seq))
            check(d <= P16_LOGIT_REL * scale, f"rank {r} {mode}: logits "
                  f"differ from the sequential run by {d} (scale {scale})")
            *_, m_want, r_want = extended_shard(
                xs_g, rows, ms_g, P16_SCENE_RANKS, r, halo, mode, cell)
            check(torch.equal(res[mode]["rows"], r_want.cpu()) and
                  torch.equal(res[mode]["mask"], m_want.cpu()),
                  f"rank {r} {mode}: halo rows differ from extended_shard")
        secs = max(res[mode]["seconds"] for res in ranks)
        log(f"[parallel] (c) {mode} halo {halo}: each rank's logits vs the "
            f"sequential run on the card: max |d| {worst_d:.3e} (need <= "
            f"{P16_LOGIT_REL:g} x {scale:.3f}; {n_equal} of "
            f"{P16_SCENE_RANKS} ranks bitwise equal), argmax >= {worst:.6f} "
            f"(need >= {SCENE_ARGMAX_MIN}), halo rows and masks equal on "
            f"every rank; {vs_cpu}; probs finite, "
            f"rows sum to 1; {secs:.3f} s over {P16_SCENE_RANKS} ranks = "
            f"{P16_SCENE_POINTS / secs:.1f} scene points/s (sequential on the "
            f"card {t_seq:.3f} s) [{card}]")
    full = ranks[0]["full"]["logits"]
    log(f"[parallel] (c) ungated: argmax agreement with the full-neighbour "
        f"run (index, halo {P16_SHARD}): geom "
        f"{p16_agree(ranks[0]['geom']['logits'], full):.6f}, index "
        f"{p16_agree(ranks[0]['index']['logits'], full):.6f}; full arm "
        f"{max(res['full']['seconds'] for res in ranks):.3f} s; peak per "
        f"rank " + ", ".join(f"{res['peak']:.3f}" for res in ranks)
        + f" GiB; the ranks took {t_ranks:.1f} s with their spawn and their "
        f"CPU shards (" + ", ".join(f"{res['cpu_seconds']:.1f}"
                                    for res in ranks)
        + f" s of CPU time a rank for the geom mode) [{card}]")
    return total


def at_points(cfg, num_points):
    import dataclasses

    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, num_points=num_points))


def phase_parallel(card):
    """16: the parallel paths on the one card (see the docstring)."""
    total = p16_trainer(card)
    total = plus(total, p16_cli(card))
    return plus(total, p16_scene_apply(card))


# -- phase 17: the analysis and tooling layer -------------------------------

def p17_recall(card):
    """17 (a): ``verify_search_recall``'s global contract and production
    windowed configuration at 8192 points, seeds 0 and 1, held to the JAX
    script's gates; the windowed search reads its slab with one K2."""
    from pointcloudsegmentation_tpu_torch import verify_search_recall as vsr

    total = dict(ZERO_COUNTS)
    sel_mode, ck, pool, window = vsr.PRODUCTION
    for seed in P17_RECALL_SEEDS:
        res, counts, _ = run_path(
            f"global search recall, seed {seed}",
            lambda: vsr.band_recall(n=N_POINTS, seed=seed, device="cuda"), {})
        total = plus(total, counts)
        for band, r in res:
            log(f"[tools] global seed={seed} band={band}: recall={r:.4f}")
            check(r >= vsr.GLOBAL_MIN, f"global recall {r} < "
                  f"{vsr.GLOBAL_MIN} at band {band}, seed {seed}")
        res, counts, _ = run_path(
            f"windowed search recall [{sel_mode},ck={ck},P={pool},"
            f"W={window}], seed {seed}",
            lambda: vsr.windowed_band_recall(
                n=N_POINTS, cand_k=ck, seed=seed, sel_mode=sel_mode,
                ov_pool_size=pool, window=window, device="cuda"),
            {"window_gather": 1})
        total = plus(total, counts)
        for band, r in res:
            log(f"[tools] windowed seed={seed} band={band}: recall={r:.4f} "
                f"[{card}]")
            check(r >= vsr.WINDOWED_MIN, f"windowed recall {r} < "
                  f"{vsr.WINDOWED_MIN} at band {band}, seed {seed}")
    return total


def activation_bytes(model, *args):
    """Host bytes ``capture_activations`` would hold for this forward: 4
    per element of each module's first output tensors, from one forward
    that records shapes only."""
    import torch

    sizes, handles = {}, []

    def hook(name):
        def record(mod, inputs, out):
            outs = out if isinstance(out, (tuple, list)) else (out,)
            sizes.setdefault(name, sum(o.numel() for o in outs
                                       if isinstance(o, torch.Tensor)))
        return record

    try:
        for name, mod in model.named_modules():
            handles.append(mod.register_forward_hook(hook(name)))
        with torch.no_grad():
            model(*args)
    finally:
        for h in handles:
            h.remove()
    return 4 * sum(sizes.values())


def p17_activations(model, cfg, card):
    """17 (b): ``capture_activations`` on one toy block through the
    flagship at full width (bf16): every module-level key, finite values
    and statistics, 8 clusters of ``encoder/global`` and their dump."""
    import tempfile

    import numpy as np
    import torch

    from pointcloudsegmentation_tpu_torch.data import toy
    from pointcloudsegmentation_tpu_torch.eval import analysis
    from pointcloudsegmentation_tpu_torch.ops import hierarchy as hier
    from pointcloudsegmentation_tpu_torch.ops import morton

    n = N_POINTS
    b = toy.synthetic_room_block(np.random.RandomState(0), n=n,
                                 num_classes=13, feat_dim=12)
    args = (torch.from_numpy(b["xyz"]).cuda(),
            torch.from_numpy(b["feats"]).cuda(),
            torch.ones(n, dtype=torch.bool, device="cuda"))
    nbytes_host = activation_bytes(model, *args)
    log(f"[tools] captured activations of one {n}-point block will hold "
        f"{nbytes_host} host bytes ({nbytes_host / 2**30:.3f} GiB)")
    if nbytes_host > P17_CAPTURE_MAX_BYTES:
        n = N_POINTS // 2
        args = tuple(a[:n] for a in args)
        log(f"[tools] over {P17_CAPTURE_MAX_BYTES / 2**30:.0f} GiB: "
            f"capturing the block's first {n} points instead")
    (out, acts), counts, secs = run_path(
        f"capture_activations (flagship, one block of {n} points)",
        lambda: analysis.capture_activations(model, *args),
        {"window_gather": 16})
    want = {"__call__", "encoder/__call__/0", "encoder/__call__/1",
            "head/__call__"} | {f"encoder/{c}/__call__"
                                for c, _ in model.encoder.named_children()}
    check(want <= set(acts), f"module-level keys missing: "
          f"{sorted(want - set(acts))}")
    for prefix in ("feats", "embed", "pool", "global", "head_"):
        check(any(k.startswith(f"encoder/{prefix}") for k in want),
              f"no encoder/{prefix}* module")
    bad = [k for k, v in acts.items() if not np.isfinite(v).all()]
    check(not bad, f"non-finite activations: {bad[:5]}")
    stats = analysis.activation_stats(acts)
    check(all(np.isfinite([s["mean"], s["std"], s["min"], s["max"]]).all()
              for s in stats.values()), "non-finite activation stats")
    held = sum(v.nbytes for v in acts.values())
    log(f"[tools] {len(acts)} activations ({len(want)} module-level), "
        f"{held} host bytes, capture {secs:.2f} s [{card}]")
    # encoder/global's rows are the points of one pyramid level (the
    # coarsest): rebuild the model's pyramid for their centers and mask
    d = cfg.data
    xs, ms, _ = morton.sort_block(args[0], args[2], d.voxel_sizes[0] / 4.0,
                                  d.block_size)
    pyr = hier.build_pyramid(xs, ms, d.voxel_sizes, d.caps, d.block_size,
                             morton_sorted=True)
    layer = "encoder/global/__call__"
    level, = [lv for lv in pyr.levels
              if lv.xyz.shape[0] == acts[layer].shape[0]]
    valid = level.mask.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "clusters.txt")
        assign = analysis.cluster_activations(
            acts, layer, k=8, mask=valid, xyz=level.xyz.cpu().numpy(),
            dump_path=dump)
        with open(dump) as f:
            lines = f.read().splitlines()
    check(set(np.unique(assign[valid]).tolist()) <= set(range(8)),
          f"cluster ids {np.unique(assign)}")
    check(len(lines) == int(valid.sum())
          and all(len(ln.split()) == 6 for ln in lines),
          f"cluster dump: {len(lines)} lines for {int(valid.sum())} valid "
          "points")
    sizes = np.bincount(assign[valid], minlength=8).tolist()
    log(f"[tools] 8 clusters of {layer} over its {int(valid.sum())} valid "
        f"points (of {len(valid)}), sizes {sizes}; dump of {len(lines)} "
        "6-column lines")
    del out, acts
    return counts


def p17_profiling(card):
    """17 (c): ``profile_step``'s rows, then ``trace_step``'s capture and
    analysis of 3 flagship steps of 4 blocks of 8192 points."""
    import tempfile

    from pointcloudsegmentation_tpu_torch import profile_step, trace_step
    from pointcloudsegmentation_tpu_torch.config import s3dis_config

    total = dict(ZERO_COUNTS)
    fwd, step = per_block(s3dis_config(data_num_points=N_POINTS, data_caps=(
        N_POINTS // 2, N_POINTS // 8)))
    steps = 1 + 2 * (P17_WARMUP + P17_ITERS)
    rows, counts, secs = run_path(
        f"profile_step ({steps} steps of {TRAIN_BLOCKS} x {N_POINTS} "
        f"points, {P17_WARMUP + P17_ITERS} encoder forwards)",
        lambda: profile_step.main([
            "--num-points", str(N_POINTS), "--batch", str(TRAIN_BLOCKS),
            "--warmup", str(P17_WARMUP), "--iters", str(P17_ITERS),
            "--device", "cuda"]),
        plus(times(step, steps * TRAIN_BLOCKS),
             times(fwd, P17_WARMUP + P17_ITERS)))
    total = plus(total, counts)
    for name, row in rows.items():
        check(all(v > 0 for v in row.values()), f"{name}: {row}")
        log(f"[tools] profile_step {name}: median {row['ms_median']:.3f} ms "
            f"(min {row['ms_min']:.3f}, max {row['ms_max']:.3f}) [{card}]")
    # trace_step traces its own flagship configuration: 4 blocks of 8192
    # points
    _, tstep = per_block(s3dis_config(data_caps=(4096, 1024)))
    with tempfile.TemporaryDirectory() as tmp:
        res, counts, secs = run_path(
            f"trace_step ({2 * trace_step.STEPS} steps, the last "
            f"{trace_step.STEPS} traced)",
            lambda: trace_step.main(["--logdir", tmp, "--top", "20",
                                     "--device", "cuda"]),
            times(tstep, 2 * trace_step.STEPS * 4))
    total = plus(total, counts)
    check(res["what"] == "kernel" and res["total_ms"] > 0,
          f"trace analysis: {res['what']} total {res['total_ms']}")
    per_step = {name: sum(n for key, n, _, _ in res["rows"] if name in key)
                for name in P17_TRACE_KERNELS}
    want = {"window_gather_kernel": 4 * tstep["window_gather"],
            "window_dslab_map_kernel": 4 * tstep["window_dslab_map"],
            "window_dslab_sum_kernel": 4 * tstep["window_dslab"]}
    log(f"[tools] trace: {res['total_ms']:.3f} ms of kernels a step; "
        "calls a step " + ", ".join(f"{k} {v:g} (expected {want[k]})"
                                    for k, v in per_step.items())
        + f" [{card}]")
    check(per_step == want, f"trace kernel calls a step {per_step}, "
          f"expected {want}")
    return total


def flavor_per_block(cfg):
    """Launches per block of a forward and of a training step of any
    conv_compare flavor, from the earlier phases' gather counts."""
    if cfg.model in ECD_KEYS:
        return ecd_per_block(cfg)
    if cfg.model == "gpn_seg":
        return gpn_per_block(cfg)
    if cfg.model in COMPOSITE_KEYS:
        return gathers_per_block(cfg, composite_gathers)
    return per_block(cfg)


def p17_conv_compare(card):
    """17 (d): every conv_compare flavor at full width, 1 epoch of 3 steps
    of 2 blocks of 2048 points."""
    import math
    import tempfile

    from pointcloudsegmentation_tpu_torch import conv_compare
    from pointcloudsegmentation_tpu_torch.config import s3dis_config

    n, steps, batch = P17_CC_POINTS, P17_CC_STEPS, P17_CC_BATCH
    total = dict(ZERO_COUNTS)
    with tempfile.TemporaryDirectory() as tmp:
        for flavor in conv_compare.FLAVORS:
            fwd, step = flavor_per_block(s3dis_config(
                model=flavor, data_num_points=n, data_caps=(n // 2, n // 8)))
            res, counts, secs = run_path(
                f"conv_compare {flavor}",
                lambda: conv_compare.main([
                    "--flavors", flavor, "--epochs", "1", "--steps",
                    str(steps), "--batch", str(batch), "--num-points",
                    str(n), "--out", os.path.join(tmp, f"{flavor}.json"),
                    "--device", "cuda"]),
                plus(times(step, steps * batch), times(fwd, steps * batch)))
            total = plus(total, counts)
            rec, = res[flavor]
            check(set(rec) == {"epoch", "loss", "miou", "oacc", "epoch_sec"},
                  f"{flavor} record {sorted(rec)}")
            check(math.isfinite(rec["loss"]) and 0 <= rec["miou"] <= 1
                  and 0 <= rec["oacc"] <= 1, f"{flavor} record {rec}")
            log(f"[tools] conv_compare {flavor}: loss {rec['loss']:.4f}, "
                f"mIoU {rec['miou']:.4f}, oAcc {rec['oacc']:.4f}, epoch "
                f"{rec['epoch_sec']:.2f} s [{card}]")
    return total


def p17_eval_parity(card):
    """17 (e): eval_parity at a cut depth (2 train rooms, 1 test room, 1
    epoch, 8192 points): both arms finite, K2 16 times a block of the
    windowed arm's sweeps, the exact arm as predicted (none)."""
    import math
    import tempfile

    from pointcloudsegmentation_tpu_torch import eval_parity
    from pointcloudsegmentation_tpu_torch.config import s3dis_config

    import numpy as np

    fwd, step = per_block(s3dis_config(data_num_points=N_POINTS))
    arms, steps, probs_ok = [], [0], []
    real_arm, real_trainer = eval_parity.eval_arm, eval_parity.Trainer
    real_interp = eval_parity.interpolate_to_dense

    def checked_interp(sxyz, sprobs, qxyz, **kw):
        q = real_interp(sxyz, sprobs, qxyz, **kw)
        probs_ok.append(all(np.isfinite(p).all() and np.abs(
            p.sum(1) - 1).max() <= PROB_SUM_TOL for p in (sprobs, q)))
        return q

    class CountedTrainer(real_trainer):
        def train_step(self, state, batch):
            steps[0] += 1
            return super().train_step(state, batch)

    def counted_arm(model, rooms, *a):
        before = read_counts()
        rec, preds = real_arm(model, rooms, *a)
        after = read_counts()
        sweeps = 2 * len(rooms[0]) + sum(len(r) for r in rooms[1:])
        arms.append(({k: after[k] - before[k] for k in after}, sweeps,
                     before))
        return rec, preds

    eval_parity.eval_arm, eval_parity.Trainer = counted_arm, CountedTrainer
    eval_parity.interpolate_to_dense = checked_interp
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "eval_parity_torch.json")
            reset_counts()
            t0 = time.perf_counter()
            res = eval_parity.main([
                "--train-rooms", str(P17_EP_TRAIN_ROOMS), "--test-rooms",
                str(P17_EP_TEST_ROOMS), "--epochs", str(P17_EP_EPOCHS),
                "--num-points", str(N_POINTS), "--out", out, "--device",
                "cuda"])
            counts = read_counts()
            secs = time.perf_counter() - t0
    finally:
        eval_parity.eval_arm, eval_parity.Trainer = real_arm, real_trainer
        eval_parity.interpolate_to_dense = real_interp
    (wcounts, wblocks, trained), (ecounts, _, _) = arms
    want_train = times(step, steps[0] * TRAIN_BLOCKS)
    want = {"windowed": times(fwd, wblocks), "exact": P17_EXACT_ARM}
    log(f"[tools] eval_parity ({P17_EP_TRAIN_ROOMS} train rooms, "
        f"{steps[0]} steps; {P17_EP_TEST_ROOMS} test room): {secs:.2f} s; "
        f"training launches {trained} (expected {want_train}), windowed "
        f"arm {wcounts} over {wblocks} block forwards (expected "
        f"{want['windowed']}), exact arm {ecounts} (expected "
        f"{want['exact']})")
    check(plus(trained, ZERO_COUNTS) == plus(want_train, ZERO_COUNTS),
          f"eval_parity training launches {trained}, expected {want_train}")
    for arm, got in (("windowed", wcounts), ("exact", ecounts)):
        check(got == plus(want[arm], ZERO_COUNTS),
              f"{arm} arm launches {got}, expected {want[arm]}")
    check(counts == plus(plus(trained, wcounts), ecounts),
          f"eval_parity launches {counts} outside the counted parts")
    for arm in ("windowed", "exact"):
        r = res[arm]
        check(all(0 <= m <= 1 for m in r["miou_per_scene"])
              and 0 <= r["miou"] <= 1 and r["eval_points_per_sec"] > 0,
              f"{arm} arm {r}")
        log(f"[tools] eval_parity {arm}: mIoU {r['miou']:.4f}, "
            f"{r['eval_points_per_sec']:.1f} dense points/s [{card}]")
    check(len(probs_ok) == 2 * P17_EP_TEST_ROOMS and all(probs_ok),
          "an arm's probabilities are not finite or do not sum to 1")
    check(math.isfinite(res["delta_miou"]), f"delta {res['delta_miou']}")
    log(f"[tools] eval_parity delta_miou (windowed - exact) "
        f"{res['delta_miou']:+.4f}, speedup {res['speedup']:.3f}")
    return counts


def phase_tools(model, cfg, card):
    """17: the analysis and tooling layer on the card (see the
    docstring)."""
    parts = (("recall", lambda: p17_recall(card)),
             ("activations", lambda: p17_activations(model, cfg, card)),
             ("profiling", lambda: p17_profiling(card)),
             ("conv_compare", lambda: p17_conv_compare(card)),
             ("eval_parity", lambda: p17_eval_parity(card)))
    total = dict(ZERO_COUNTS)
    for name, fn in parts:
        t0 = time.perf_counter()
        total = plus(total, fn())
        log(f"[tools] part {name} in {time.perf_counter() - t0:.1f} s")
    return total


def timed_steps(trainer, state, batches, n, expect, what):
    """``n`` train steps from ``state`` over ``batches`` in turn, one host
    read at the end, counted by ``run_path``.  Returns (state, metrics,
    counts, seconds)."""
    import math

    def steps():
        st = state
        for i in range(n):
            st, mm = trainer.train_step(st, batches[i % len(batches)])
        float(mm["loss"])
        return st, mm

    (state, m), counts, secs = run_path(f"{what} {n} timed train steps",
                                        steps, expect)
    check(math.isfinite(float(m["loss"])), f"{what} timed step loss")
    return state, m, counts, secs


def step_twice(trainer, state, batch, expect, what):
    """One train step twice from one state, counted: params, mu, nu and
    count bitwise equal.  Returns the counts."""
    import torch

    (a, b), counts, _ = run_path(
        f"{what} step twice from one state",
        lambda: (trainer.train_step(state, batch)[0],
                 trainer.train_step(state, batch)[0]), expect)
    for f in ("params", "mu", "nu", "count"):
        check(torch.equal(getattr(a, f), getattr(b, f)),
              f"two runs of one {what} step differ in {f}")
    log(f"[{what}] one step twice from one state: params, mu, nu and count "
        "bitwise equal")
    return counts


def f32_grad_cosine(f32, block, expect, what, card, **trainer_kw):
    """The float32 ``train=False`` loss and flat gradient of one block on
    the card (counted) and on the CPU, weights from torch.Generator seed
    0: the cosine must reach GRAD_COSINE_MIN.  Returns the counts."""
    import torch

    from pointcloudsegmentation_tpu_torch.train.loop import Trainer

    grads = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(f32, device=dev, **trainer_kw)
        st = tr.init_state(torch.Generator().manual_seed(0))
        if dev == "cuda":
            (lo, g), counts, _ = run_path(
                f"{what} float32 loss and grad, one block",
                lambda: tr.loss_and_grad(st, block, train=False), expect)
        else:
            lo, g = tr.loss_and_grad(st, block, train=False)
        grads[dev] = (float(lo), g.double().cpu())
        del tr, st
    gc, gh = grads["cuda"][1], grads["cpu"][1]
    cos = float(gc @ gh / (gc.norm() * gh.norm()))
    log(f"[{what}] float32 flat gradient card vs CPU: cosine {cos:.6f} "
        f"(need >= {GRAD_COSINE_MIN}), loss {grads['cuda'][0]:.6f} vs "
        f"{grads['cpu'][0]:.6f} [{card}]")
    check(cos >= GRAD_COSINE_MIN, f"{what} gradient cosine {cos}")
    return counts


# -- phase 18: the overflow edge list, the conv tail and the helpers --------

def p18_move(obj, device):
    """A neighborhood, pyramid or edge list (dicts, tuples and frozen
    dataclasses of tensors) with every tensor on ``device``."""
    import dataclasses

    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: p18_move(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(p18_move(v, device) for v in obj))
    if isinstance(obj, tuple):
        return tuple(p18_move(v, device) for v in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: p18_move(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return obj


def p18_block(batch, cfg):
    """Block 0 of a card batch, Morton-sorted on the CPU, and its pyramid
    (CPU): (xyz, feats, mask, labels, pyramid)."""
    from pointcloudsegmentation_tpu_torch.ops import hierarchy, morton

    d = cfg.data
    xyz, feats, mask, labels = (batch[k][0].cpu() for k in
                                ("xyz", "feats", "mask", "labels"))
    xs, ms, _, fs, ls = morton.sort_block(xyz, mask, d.voxel_sizes[0] / 4,
                                          d.block_size, feats, labels)
    pyr = hierarchy.build_pyramid(xs, ms, d.voxel_sizes, d.caps,
                                  d.block_size, morton_sorted=True)
    return xs, fs, ms, ls, pyr


def p18_edge_rows(e_h, e_d, n):
    """The share of the valid edge rows, as (center, nbr) pairs, that the
    card's and the CPU's lists share (a pair one list lacks shifts every
    later row, so rows are matched by pair, not by position), and the
    largest |d| of sxyz and d2 over the shared pairs."""
    import torch

    keys = []
    for e in (e_h, e_d):
        k = (e.center.long() * n + e.nbr.long())[e.mask]
        order = torch.argsort(k)
        keys.append((k[order], e.sxyz[e.mask][order], e.d2[e.mask][order]))
    (kh, sh, dh), (kd, sd, dd) = keys
    pos = torch.searchsorted(kh, kd).clamp(max=max(len(kh) - 1, 0))
    hit = kh[pos] == kd if len(kh) else torch.zeros_like(kd, dtype=bool)
    share = float(hit.sum()) / max(len(kh), len(kd), 1)
    diffs = torch.cat([(sd[hit] - sh[pos[hit]]).reshape(-1),
                       dd[hit] - dh[pos[hit]], sd.new_zeros(1)])
    return share, float(diffs.abs().max())


def p18_searches(enc, pyr, card):
    """18 (a): every windowed level's edges-mode search on the card and on
    the CPU from the same (CPU-built) pyramid: the valid edge rows
    (``p18_edge_rows``) and each band's windowed slot rows (lidx and
    wmask) equal on at least EDGE_ROW_MIN, sxyz and d2 of the shared rows
    within EDGE_GEO_TOL; each level's edge demand (the rows a cap of 16 N
    keeps) against its cap.  Returns the card's launches."""
    from pointcloudsegmentation_tpu_torch.ops import search

    total = dict(ZERO_COUNTS)
    for s in range(len(enc.arch.stages)):
        lv = pyr.levels[s]
        n = lv.xyz.shape[0]
        if n % enc.win_tile or n < 4 * enc.win_tile:
            continue
        ratio = 3 if s == 0 else 5
        args = (enc.stage_specs(s), True, ratio)
        bands = tuple((mn, mx, k) for (mx, mn, k) in dict.fromkeys(args[0]))
        host = enc._stage_neighborhoods(lv.xyz, lv.mask, *args)

        def card_search():
            x, m = lv.xyz.cuda(), lv.mask.cuda()
            res = enc._stage_neighborhoods(x, m, *args)
            demand = search.windowed_multi_band_neighbors(
                x, m, bands, tile=enc.win_tile, window=enc.win_window,
                cand_k=search.effective_win_cand_k(enc.win_cand_k,
                                                   enc.cand_k, bands, n),
                ov_slots=8, chunk=min(enc.search_chunk, n), ov_mode="edges",
                edge_ratio=16, sel_mode="slab")[0][1].mask.sum()
            return p18_move(res, "cpu"), int(demand)

        (dev, demand), counts, secs = run_path(
            f"L{s} edges-mode search ({n} points) and its demand",
            card_search, {"window_gather": 2})
        total = plus(total, counts)
        e_h, e_d = next(iter(host.values()))[2], next(iter(dev.values()))[2]
        share, geo = p18_edge_rows(e_h, e_d, n)
        log(f"[edges] L{s}: {int(e_d.mask.sum())} of {ratio * n} edge rows "
            f"filled (CPU {int(e_h.mask.sum())}), demand {demand}; card vs "
            f"CPU rows shared {share:.6f} (need >= {EDGE_ROW_MIN}), sxyz/d2 "
            f"max |d| {geo:.3e} (need <= {EDGE_GEO_TOL}), {secs:.2f} s")
        check(share >= EDGE_ROW_MIN, f"L{s} edge rows shared {share}")
        check(geo <= EDGE_GEO_TOL, f"L{s} edge geometry |d| {geo}")
        for spec, (nb_h, _, _) in host.items():
            nb_d = dev[spec][0]
            check(nb_d.ov_idx.shape[1] == 0, "edges mode kept overflow slots")
            rows = ((nb_h.lidx == nb_d.lidx) & (nb_h.wmask == nb_d.wmask)
                    ).all(dim=1)
            slot_share = float(rows.double().mean())
            log(f"[edges] L{s} band {spec}: windowed slot rows equal card "
                f"vs CPU {slot_share:.6f}")
            check(slot_share >= EDGE_ROW_MIN,
                  f"L{s} {spec} windowed rows equal {slot_share}")
    return total


def p18_flagship(cfg, card, slots):
    """18 (a): the flagship with ``ov_mode="edges"`` at full width and
    depth (bf16 compute, seeded weights): a counted Trainer step of 4 toy
    blocks of 8192 points, EDGE_TIMED_STEPS timed ones beside the bench's
    slots-mode step, P18_PROFILED_STEPS under ``torch.profiler`` (the
    index backward's share of kernel time, the top kernels), one step
    twice from one state bitwise equal; on one
    float32 block, the searches (``p18_searches``), logits argmax and the
    flat gradient card vs CPU.  Returns (launches, the block)."""
    import dataclasses
    import math

    import torch

    from pointcloudsegmentation_tpu_torch import profile_train
    from pointcloudsegmentation_tpu_torch.train.loop import Trainer
    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    total = dict(ZERO_COUNTS)
    batches = make_train_batches("cuda")
    fwd, step = per_block(cfg)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, device="cuda", ov_mode="edges")
    check(trainer.model.encoder.ov_mode == "edges", "ov_mode not set")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    log(f"[edges] pointnet_s3dis ov_mode=edges {cfg.compute_dtype}: "
        f"{trainer.num_params} params; launches per block {fwd} forward, "
        f"{step} training step")
    (state, m), counts, first = run_path(
        f"edges train step ({TRAIN_BLOCKS} x {N_POINTS} points)",
        lambda: trainer.train_step(state, batches[0]),
        times(step, TRAIN_BLOCKS))
    total = plus(total, counts)
    loss = float(m["loss"])
    check(math.isfinite(loss) and int(m["skipped"]) == 0,
          f"edges train step loss {loss}")

    state, m, counts, secs = timed_steps(
        trainer, state, batches, EDGE_TIMED_STEPS,
        times(step, TRAIN_BLOCKS * EDGE_TIMED_STEPS), "edges")
    total = plus(total, counts)
    valid = int(batches[0]["mask"].sum())
    step_s, pps = secs / EDGE_TIMED_STEPS, valid * EDGE_TIMED_STEPS / secs
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    slots_pps, slots_peak = slots
    log(f"[edges] first step loss {loss:.5f} in {first:.2f} s (set-up "
        f"included); {step_s:.4f} s a step, {pps:.1f} train points/s, peak "
        f"{peak:.3f} GiB; the bench's slots step {valid / slots_pps:.4f} s, "
        f"{slots_pps:.1f} train points/s, peak {slots_peak:.3f} GiB "
        f"[{card}]")

    def profiled():
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            st = state
            for i in range(P18_PROFILED_STEPS):
                st, _ = trainer.train_step(st, batches[i % 2])
            torch.cuda.synchronize()
        return prof

    prof, counts, _ = run_path(
        f"edges {P18_PROFILED_STEPS} profiled train steps", profiled,
        times(step, TRAIN_BLOCKS * P18_PROFILED_STEPS))
    total = plus(total, counts)
    s = profile_train.summarize(prof.key_averages(), P18_PROFILED_STEPS,
                                step_s)
    index_ms = sum(ms for key, _, ms, _ in s["kernels"]
                   if "indexing_backward" in key)
    log(f"[edges] profiled step: kernels {s['kernel_ms']:.2f} ms in "
        f"{s['kernel_launches']:.0f} launches, busy {s['busy']:.3f} of the "
        f"{step_s:.4f} s step; PyTorch's index backward {index_ms:.3f} ms, "
        f"{index_ms / max(s['kernel_ms'], 1e-9):.3f} of kernel time; top "
        "kernels (calls, ms, share):")
    for key, n, ms, share in s["kernels"][:P18_TOP]:
        log(f"    {n:7.1f} {ms:8.3f} {share:6.3f}  {key[:100]}")

    total = plus(total, step_twice(trainer, state, batches[0],
                                   times(step, 2 * TRAIN_BLOCKS), "edges"))
    del trainer, state, m
    torch.cuda.empty_cache()

    # float32, one block, card vs CPU
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    block = p18_block(batches[0], cfg)
    host_model = build_model(f32, torch.Generator().manual_seed(0), "cpu",
                             ov_mode="edges")
    total = plus(total, p18_searches(host_model.encoder, block[4], card))
    one = {k: v[:1].cpu() for k, v in batches[0].items()}
    args = [one[k][0] for k in ("xyz", "feats", "mask")]
    card_model = build_model(f32, torch.Generator().manual_seed(0), "cuda",
                             ov_mode="edges")
    with torch.inference_mode():
        want = host_model(*args)
    def card_forward():
        with torch.inference_mode():
            return card_model(*(a.cuda() for a in args)).cpu()

    got, counts, _ = run_path("edges float32 forward, one block",
                              card_forward, fwd)
    total = plus(total, counts)
    ok = args[2]
    agree = float((got.argmax(1) == want.argmax(1))[ok].double().mean())
    log(f"[edges] float32 logits card vs CPU: argmax agreement {agree:.6f} "
        f"over {int(ok.sum())} valid points (need >= {EDGE_ROW_MIN}), max "
        f"|d| {(got - want).abs().max():.3e} [{card}]")
    check(bool(torch.isfinite(got).all()), "edges float32 logits")
    check(agree >= EDGE_ROW_MIN, f"edges argmax agreement {agree}")
    del host_model, card_model
    total = plus(total, f32_grad_cosine(f32, one, step, "edges", card,
                                        ov_mode="edges"))
    return total, block


def p18_chain(f, m, out):
    """``DiffFeatsWLW`` feeding ``WLWConv`` (its sum form on the
    features) as one module, for phase 18 (b)."""
    from torch import nn

    from pointcloudsegmentation_tpu_torch.models import variants as V

    class Chain(nn.Module):
        def __init__(self):
            super().__init__()
            self.wlw = V.DiffFeatsWLW(f, m, (16,))
            self.conv = V.WLWConv(f, m, out, mode="sum", use_xyz=False)

        def forward(self, sxyz, feats, nbr):
            return self.conv(sxyz, feats, nbr, self.wlw(feats, nbr))

    return Chain()


def p18_tail_cases(f):
    """(name, module factory, call(module, sxyz, feats, nbr, pmiu), expected
    K2 and K3 launches of one forward and backward) of phase 18 (b)."""
    from pointcloudsegmentation_tpu_torch.models import layers as L
    from pointcloudsegmentation_tpu_torch.models import variants as V

    m = P18_ANCHORS
    one, none = {"window_gather": 1, "window_dslab": 1,
                 "window_dslab_map": 1}, {}
    plain = lambda mod, sx, x, nb, pm: mod(sx, x, nb)  # noqa: E731
    first = lambda mod, sx, x, nb, pm: mod(sx, x, nb)[0]  # noqa: E731

    def wlw(mod, sx, x, nb, pm):
        return mod(sx, x, nb, V.compute_wlw(sx, nb, pm))

    cases = [("AnchorConv", lambda: L.AnchorConv(f, 32, m, 4), plain, one),
             ("GPNConv xyz_feats summed, trainable pmiu",
              lambda: L.GPNConv(f, m, 16, mode="xyz_feats",
                                pmiu_trainable=True), first, one),
             ("GPNConvV2 xyz", lambda: V.GPNConvV2(f, m, 16, mode="xyz"),
              first, none),
             ("GPNConvV2 feats", lambda: V.GPNConvV2(f, m, 16, mode="feats"),
              first, one)]
    for mode in ("sum", "concat"):
        for use_xyz in (True, False):
            cases.append((f"WLWConv {mode} {'xyz' if use_xyz else 'feats'}",
                          lambda mode=mode, use_xyz=use_xyz: V.WLWConv(
                              f, m, 16, mode=mode, use_xyz=use_xyz), wlw,
                          none if use_xyz else one))
    cases.append(("DiffFeatsWLW -> WLWConv", lambda: p18_chain(f, m, 16),
                  plain, times(one, 2)))
    return cases


def p18_compare(name, out, ref, grad, grad_ref, counts, card):
    """Phase 18 (b)'s gates on one module: outputs within P18_TAIL_TOL of
    max(1, the largest |CPU value|), flat gradient cosine at least
    GRAD_COSINE_MIN."""
    import torch

    scale = max(1.0, float(ref.abs().max()))
    err = float((out - ref).abs().max()) / scale
    cos = float(grad @ grad_ref / (grad.norm() * grad_ref.norm()))
    launched = ", ".join(f"{k} {v}" for k, v in counts.items())
    log(f"[tail] {name}: output max |d| {err:.3e} of scale {scale:.3g} "
        f"(need <= {P18_TAIL_TOL}), gradient cosine {cos:.6f}; launches "
        f"{launched or 'none'} [{card}]")
    check(bool(torch.isfinite(out).all()), f"{name} output not finite")
    check(err <= P18_TAIL_TOL, f"{name} output |d| {err}")
    check(cos >= GRAD_COSINE_MIN, f"{name} gradient cosine {cos}")


def p18_tail(block, cfg, card):
    """18 (b): each tail module on the windowed neighborhood of level 0's
    first band of one toy block (the flagship's slots-mode search: pooled
    overflow slots), forward and backward in float32 with the same weights
    (Glorot draws from seed 0 on the CPU) on the card and on the CPU;
    ``covariance_feats`` (its gradient in xyz), ``estimate_normals`` (up to
    sign where the smallest eigenvalue is isolated; forward only: an
    eigenvector's gradient is unbounded where eigenvalues nearly repeat),
    ``classifier_v2/v4/v5``.  Returns the card's launches."""
    import copy

    import torch

    from pointcloudsegmentation_tpu_torch.models import layers as L
    from pointcloudsegmentation_tpu_torch.ops import anchors as anchor_gen
    from pointcloudsegmentation_tpu_torch.ops import geometry
    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    total = dict(ZERO_COUNTS)
    xs, fs, ms, _, pyr = block
    enc = build_model(cfg, None, "cpu").encoder
    specs = enc.stage_specs(0)
    res = enc._stage_neighborhoods(xs, ms, specs, True)
    nb_h, sx_h, _ = res[specs[0]]
    nb_d, sx_d = p18_move(nb_h, "cuda"), sx_h.cuda()
    check(nb_h.pool_idx is not None, "level 0 is not windowed")
    f = fs.shape[1]
    pmiu = torch.from_numpy(anchor_gen.cached_sphere_anchors(P18_ANCHORS))
    gen = torch.Generator().manual_seed(7)
    for i, (name, make, call, expect) in enumerate(p18_tail_cases(f)):
        mod_h = make()
        L.init_glorot_(mod_h, torch.Generator().manual_seed(i))
        mod_d = copy.deepcopy(mod_h).cuda()
        outs, grads = {}, {}
        for side, dev, mod, nb, sx in (("host", "cpu", mod_h, nb_h, sx_h),
                                       ("card", "cuda", mod_d, nb_d, sx_d)):
            x = fs.to(dev).clone().requires_grad_(True)

            def run():
                out = call(mod, sx, x, nb, pmiu.to(dev))
                if side == "host":
                    outs["w"] = torch.randn(out.shape, generator=gen)
                (out * outs["w"].to(dev)).sum().backward()
                return out.detach().cpu()

            if side == "host":
                outs[side] = run()
            else:
                outs[side], counts, _ = run_path(f"tail {name}", run, expect)
                total = plus(total, counts)
            # the xyz-only forms read no features
            grads[side] = torch.cat([
                t.grad.reshape(-1).double().cpu() for t in
                list(mod.parameters()) + [x] if t.grad is not None])
        p18_compare(name, outs["card"], outs["host"], grads["card"],
                    grads["host"], counts, card)

    # the geometry ops on the same neighborhood
    outs, grads = {}, {}
    w = torch.randn(xs.shape[0], 9, generator=gen)
    for side, dev, nb in (("host", "cpu", nb_h), ("card", "cuda", nb_d)):
        x = xs.to(dev).clone().requires_grad_(True)

        def run():
            out = geometry.covariance_feats(x, nb)
            (out * w.to(dev)).sum().backward()
            return out.detach().cpu()

        if side == "host":
            outs[side] = run()
        else:
            outs[side], counts, _ = run_path(
                "tail covariance_feats", run,
                {"window_gather": 1, "window_dslab": 1,
                 "window_dslab_map": 1})
            total = plus(total, counts)
        grads[side] = x.grad.reshape(-1).double().cpu()
    p18_compare("covariance_feats", outs["card"], outs["host"],
                grads["card"], grads["host"], counts, card)
    n_h = geometry.estimate_normals(xs, nb_h)
    n_d, counts, _ = run_path(
        "tail estimate_normals",
        lambda: geometry.estimate_normals(xs.cuda(), nb_d).cpu(),
        {"window_gather": 1})
    total = plus(total, counts)
    ev = torch.linalg.eigvalsh(geometry._local_covariance(xs, nb_h).double())
    has = nb_h.mask.any(1)
    iso = has & (ev[:, 1] - ev[:, 0] > 1e-3 * ev[:, 2].clamp(min=1e-12))
    dot = (n_d * n_h).sum(1).abs()
    worst = float((1 - dot[iso]).max())
    log(f"[tail] estimate_normals: |dot| card vs CPU >= {1 - worst:.6f} on "
        f"the {int(iso.sum())} of {int(has.sum())} points whose smallest "
        f"eigenvalue is isolated (need >= {1 - P18_TAIL_TOL}); zeros "
        f"without a neighbor: {not bool(n_d[~has].any())} [{card}]")
    check(worst <= P18_TAIL_TOL and not bool(n_d[~has].any()),
          f"estimate_normals |dot| {1 - worst}")

    # the head variants (no neighborhood: dense rows)
    n = xs.shape[0]
    feats = torch.randn(n, 64, generator=gen)
    pfeats = torch.randn(n, 32, generator=gen)
    heads = (("classifier_v2", lambda: L.classifier_v2(13, 64), False),
             ("classifier_v4", lambda: L.classifier_v4(13, 64, 32), True),
             ("classifier_v5", lambda: L.classifier_v5(13, 64, 32), True))
    for i, (name, make, local) in enumerate(heads):
        mod_h = make()
        L.init_glorot_(mod_h, torch.Generator().manual_seed(100 + i))
        mod_d = copy.deepcopy(mod_h).cuda()
        w = torch.randn(n, 13, generator=gen)
        outs, grads = {}, {}
        for side, dev, mod in (("host", "cpu", mod_h),
                               ("card", "cuda", mod_d)):
            x = feats.to(dev).clone().requires_grad_(True)
            out = mod(x, pfeats.to(dev) if local else None)
            (out * w.to(dev)).sum().backward()
            outs[side] = out.detach().cpu()
            grads[side] = torch.cat([p.grad.reshape(-1).double().cpu()
                                     for p in mod.parameters()]
                                    + [x.grad.reshape(-1).double().cpu()])
        p18_compare(name, outs["card"], outs["host"], grads["card"],
                    grads["host"], {}, card)
    return total


def p18_helpers(block, cfg, card):
    """18 (c): ``voxel_majority_label`` and ``average_downsample`` at the
    s3dis voxel sizes and caps on the sorted block, card vs CPU: integers
    equal, floats within P18_HELPER_TOL.  No kernel runs."""
    import torch

    from pointcloudsegmentation_tpu_torch.ops import hierarchy, voxelize

    xs, fs, ms, ls, pyr = block
    d = cfg.data
    seg = pyr.seg[0]
    sides = (("host", "cpu"), ("card", "cuda"))
    lab = {side: voxelize.voxel_majority_label(
        ls.to(dev), ms.to(dev), seg.to(dev), d.caps[0], d.num_classes).cpu()
        for side, dev in sides}
    check(torch.equal(lab["host"], lab["card"]), "voxel_majority_label")
    worst = 0.0
    cur = {side: (xs.to(dev), fs.to(dev), ms.to(dev)) for side, dev in sides}
    for vs, cap in zip(d.voxel_sizes, d.caps):
        for side in cur:
            cur[side] = hierarchy.average_downsample(*cur[side], vs,
                                                     d.block_size, cap)
        (cx, cf, cm), (gx, gf, gm) = cur["host"], (
            t.cpu() for t in cur["card"])
        check(torch.equal(cm, gm), f"average_downsample mask at {vs}")
        worst = max(worst, float((cx - gx).abs().max()),
                    float((cf - gf).abs().max()))
    log(f"[helpers] voxel_majority_label over {d.caps[0]} voxels equal card "
        f"vs CPU ({int((lab['host'] > 0).sum())} non-zero); "
        f"average_downsample at {d.voxel_sizes} / caps {d.caps}: masks "
        f"equal, centers and "
        f"features max |d| {worst:.3e} (need <= {P18_HELPER_TOL}) [{card}]")
    check(worst <= P18_HELPER_TOL, f"average_downsample |d| {worst}")


def phase_edges(card, slots):
    """18: the encoder's shared overflow edge list, the anchored-conv tail,
    the head variants and the geometry ops on the card (see the
    docstring).  ``slots`` is the bench's (train points/s, peak GiB)."""
    import dataclasses

    from pointcloudsegmentation_tpu_torch.config import s3dis_config

    cfg = s3dis_config()
    t0 = time.perf_counter()
    total, block = p18_flagship(cfg, card, slots)
    log(f"[edges] part flagship in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    total = plus(total, p18_tail(block, dataclasses.replace(
        cfg, compute_dtype="float32"), card))
    log(f"[edges] part tail in {time.perf_counter() - t0:.1f} s")
    p18_helpers(block, cfg, card)
    return total


# -- phase 19: the exact-search training arm and the parity A/B --------------

def p19_exact_step(cfg, card, slots):
    """19 (a): the flagship trained with the exact global search
    (``Trainer(windowed=False)``, full width and depth, bf16 compute,
    seeded weights) on phase 7's batches: a counted step and
    P19_TIMED_STEPS timed ones with no K2 or K3 launch, beside the bench's
    windowed step; one step twice from one state bitwise equal; on one
    float32 block, card vs CPU: every level's exact search slot for slot,
    logits argmax and the flat gradient's cosine."""
    import dataclasses
    import math

    import torch

    from pointcloudsegmentation_tpu_torch.train.loop import Trainer
    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    total = dict(ZERO_COUNTS)
    batches = make_train_batches("cuda")
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, device="cuda", windowed=False)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    log(f"[exact] pointnet_s3dis windowed=False {cfg.compute_dtype}: "
        f"{trainer.num_params} params")
    (state, m), counts, first = run_path(
        f"exact train step ({TRAIN_BLOCKS} x {N_POINTS} points)",
        lambda: trainer.train_step(state, batches[0]), P17_EXACT_ARM)
    total = plus(total, counts)
    loss = float(m["loss"])
    check(math.isfinite(loss) and int(m["skipped"]) == 0,
          f"exact train step loss {loss}")

    state, m, counts, secs = timed_steps(trainer, state, batches,
                                         P19_TIMED_STEPS, P17_EXACT_ARM,
                                         "exact")
    total = plus(total, counts)
    valid = int(batches[0]["mask"].sum())
    step_s, pps = secs / P19_TIMED_STEPS, valid * P19_TIMED_STEPS / secs
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    slots_pps, slots_peak = slots
    log(f"[exact] first step loss {loss:.5f} in {first:.2f} s (set-up "
        f"included); {step_s:.4f} s a step, {pps:.1f} train points/s, peak "
        f"{peak:.3f} GiB; the bench's windowed step {valid / slots_pps:.4f} "
        f"s, {slots_pps:.1f} train points/s, peak {slots_peak:.3f} GiB "
        f"[{card}]")

    total = plus(total, step_twice(trainer, state, batches[0],
                                   P17_EXACT_ARM, "exact"))
    del trainer, state, m
    torch.cuda.empty_cache()

    # float32, one block, card vs CPU
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    one = {k: v[:1].cpu() for k, v in batches[0].items()}
    args = [one[k][0] for k in ("xyz", "feats", "mask")]
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(f32, torch.Generator().manual_seed(0), dev,
                            windowed=False).eval()

        def forward():
            with torch.inference_mode():
                x, f, mk = (t.to(dev) for t in args)
                nbrs = [(f"L{s} {spec}", nb.idx.cpu(), nb.mask.cpu())
                        for s, spec, nb in path_neighborhoods(
                            model, cfg, x, mk)]
                return model(x, f, mk).cpu(), nbrs

        if dev == "cuda":
            out[dev], counts, _ = run_path(
                "exact float32 search and forward, one block", forward,
                P17_EXACT_ARM)
            total = plus(total, counts)
        else:
            out[dev] = forward()
        del model
    slots_total = slots_bad = 0
    for (name, gi, gm), (_, ci, cm) in zip(out["cuda"][1], out["cpu"][1]):
        valid = gm | cm
        bad = int((valid & ((gm != cm) | (gi != ci))).sum())
        slots_total += int(valid.sum())
        slots_bad += bad
        log(f"[exact] search {name}: {bad} of {int(valid.sum())} valid "
            "slots differ")
    share = 1.0 - slots_bad / max(slots_total, 1)
    log(f"[exact] exact search card vs CPU: {share:.6f} of "
        f"{slots_total} valid slots equal (need >= {PARITY_NBR_MIN}) "
        f"[{card}]")
    check(share >= PARITY_NBR_MIN, f"exact search slot parity {share}")
    gl, cl = out["cuda"][0], out["cpu"][0]
    ok = args[2]
    agree = float((gl.argmax(1) == cl.argmax(1))[ok].double().mean())
    log(f"[exact] float32 logits card vs CPU: argmax agreement {agree:.6f} "
        f"over {int(ok.sum())} valid points (need >= {ECD_ARGMAX_MIN}), "
        f"max |d| {(gl - cl).abs().max():.3e} [{card}]")
    check(bool(torch.isfinite(gl).all()), "exact float32 logits")
    check(agree >= ECD_ARGMAX_MIN, f"exact argmax agreement {agree}")
    return plus(total, f32_grad_cosine(f32, one, P17_EXACT_ARM, "exact",
                                       card, windowed=False))


def p19_parity_ab(card):
    """19 (b): ``parity_ab.main`` at a cut depth (``--arms windowed exact
    --hard``, 2 train rooms, 1 test room, 1 epoch, the flagship at 8192
    points): both arms' keys, the deltas the differences of the arms'
    values, every last train loss finite, the card in the JSON; the
    windowed arm's K2/K3 launches as its steps and test blocks count them,
    the exact arm's none."""
    import math
    import tempfile

    from pointcloudsegmentation_tpu_torch import parity_ab
    from pointcloudsegmentation_tpu_torch.config import s3dis_config

    fwd, step = per_block(s3dis_config(data_num_points=N_POINTS))
    blocks = {"train": 0, "eval": 0}
    arms = {}
    real_arm, real_trainer = parity_ab.run_arm, parity_ab.Trainer

    class CountedTrainer(real_trainer):
        def train_step(self, state, batch):
            blocks["train"] += batch["xyz"].shape[0]
            return super().train_step(state, batch)

        def eval_step(self, state, batch):
            blocks["eval"] += batch["xyz"].shape[0]
            return super().eval_step(state, batch)

    def counted_arm(arm, *a):
        before, seen = read_counts(), dict(blocks)
        res = real_arm(arm, *a)
        after = read_counts()
        arms[arm] = ({k: after[k] - before[k] for k in after},
                     {k: blocks[k] - seen[k] for k in blocks})
        return res

    parity_ab.run_arm, parity_ab.Trainer = counted_arm, CountedTrainer
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "parity_ab_torch.json")
            reset_counts()
            t0 = time.perf_counter()
            res = parity_ab.main([
                "--arms", "windowed", "exact", "--hard", "--train-rooms",
                str(P19_AB_TRAIN_ROOMS), "--test-rooms",
                str(P19_AB_TEST_ROOMS), "--epochs", str(P19_AB_EPOCHS),
                "--num-points", str(N_POINTS), "--out", out, "--device",
                "cuda"])
            counts = read_counts()
            secs = time.perf_counter() - t0
            with open(out) as f:
                saved = json.load(f)
    finally:
        parity_ab.run_arm, parity_ab.Trainer = real_arm, real_trainer
    (wcounts, wblocks), (ecounts, eblocks) = arms["windowed"], arms["exact"]
    want = plus(times(step, wblocks["train"]), times(fwd, wblocks["eval"]))
    log(f"[parity_ab] --hard, {P19_AB_TRAIN_ROOMS} train rooms "
        f"({res['blocks'][0]} blocks), {P19_AB_TEST_ROOMS} test room "
        f"({res['blocks'][1]} blocks), {P19_AB_EPOCHS} epoch: {secs:.2f} s; "
        f"windowed arm {wcounts} over {wblocks['train']} trained and "
        f"{wblocks['eval']} tested blocks (expected {want}), exact arm "
        f"{ecounts} over {eblocks} (expected {P17_EXACT_ARM})")
    check(wcounts == plus(want, ZERO_COUNTS),
          f"windowed arm launches {wcounts}, expected {want}")
    check(ecounts == plus(P17_EXACT_ARM, ZERO_COUNTS),
          f"exact arm launches {ecounts}")
    check(counts == plus(wcounts, ecounts),
          f"parity_ab launches {counts} outside the arms")
    check(saved == json.loads(json.dumps(res)), "the JSON is not the result")
    check({"config", "blocks", "card", "windowed", "exact",
           "delta_final_miou", "delta_best_miou"} <= set(saved),
          f"parity_ab keys {sorted(saved)}")
    w, e = saved["windowed"], saved["exact"]
    for arm, r in (("windowed", w), ("exact", e)):
        check({"curve", "final_miou", "best_miou"} <= set(r)
              and len(r["curve"]) == P19_AB_EPOCHS
              and all(math.isfinite(c["last_train_loss"])
                      for c in r["curve"])
              and 0 <= r["best_miou"] <= 1, f"{arm} arm {r}")
        c = r["curve"][-1]
        log(f"[parity_ab] {arm}: best mIoU {r['best_miou']:.4f}, final "
            f"{r['final_miou']:.4f}, last train loss "
            f"{c['last_train_loss']:.5f}, epoch {c['epoch_s']:.2f} s "
            f"(train {c['train_s']:.2f} s) [{card}]")
    check(saved["delta_final_miou"] == w["final_miou"] - e["final_miou"]
          and saved["delta_best_miou"] == w["best_miou"] - e["best_miou"],
          "the deltas are not the arms' differences")
    log(f"[parity_ab] delta (windowed - exact): final "
        f"{saved['delta_final_miou']:+.4f}, best "
        f"{saved['delta_best_miou']:+.4f}; card {saved['card']}")
    return counts


def phase_exact(card, slots):
    """19: the exact-search training arm and the windowed-vs-exact A/B on
    the card (see the docstring).  ``slots`` is the bench's (train
    points/s, peak GiB)."""
    from pointcloudsegmentation_tpu_torch.config import s3dis_config

    t0 = time.perf_counter()
    total = p19_exact_step(s3dis_config(), card, slots)
    log(f"[exact] part exact step in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    total = plus(total, p19_parity_ab(card))
    log(f"[parity_ab] part parity_ab in {time.perf_counter() - t0:.1f} s")
    return total


# -- phase 20: the search modes and the encoder settings -------------------

def p20_block(cfg):
    """The first toy room block (phase 4's), Morton-sorted on the CPU, and
    its pyramid (CPU)."""
    import torch

    from pointcloudsegmentation_tpu_torch.ops import hierarchy, morton

    d = cfg.data
    b = make_blocks("cpu")[0][0]
    xs, ms, _ = morton.sort_block(b["xyz"], b["mask"], d.voxel_sizes[0] / 4,
                                  d.block_size)
    return hierarchy.build_pyramid(xs, ms, d.voxel_sizes, d.caps,
                                   d.block_size, morton_sorted=True)


def p20_level_bands(enc, s):
    return tuple((mn, mx, k) for (mx, mn, k) in dict.fromkeys(
        enc.stage_specs(s)))


def p20_slot_share(host, dev):
    """(valid slots differing, valid slots) over every band: each band's
    global view (``to_neighborhood``), card against CPU."""
    bad = total = 0
    for h, d in zip(host, dev):
        h, d = h[0].to_neighborhood(), d[0].to_neighborhood()
        valid = h.mask | d.mask
        bad += int((valid & ((h.mask != d.mask) | (h.idx != d.idx))).sum())
        total += int(valid.sum())
    return bad, total


def p20_searches(pyr, enc, card):
    """20 (a): the global selection (cand_k P20_CAND_K, pool 0 and 256,
    slots and edges) at levels 0 and 1 on the card and on the CPU from the
    same pyramid: valid slots equal on at least PARITY_NBR_MIN, in edges
    mode the edge rows on at least EDGE_ROW_MIN with their geometry within
    EDGE_GEO_TOL.  One K2 (the slab geometry read) a search.  Returns the
    card's launches."""
    from pointcloudsegmentation_tpu_torch.ops import search

    total = dict(ZERO_COUNTS)
    for s in P20_LEVELS:
        lv = pyr.levels[s]
        n = lv.xyz.shape[0]
        bands = p20_level_bands(enc, s)
        for pool in P20_POOLS:
            for mode in ("slots", "edges"):
                kw = dict(tile=256, window=256, cand_k=P20_CAND_K, ov_slots=8,
                          chunk=1024, return_sxyz=True, ov_pool_size=pool,
                          sel_mode="global", ov_mode=mode,
                          edge_ratio=3 if s == 0 else 5)
                host = search.windowed_multi_band_neighbors(
                    lv.xyz, lv.mask, bands, **kw)
                dev, counts, secs = run_path(
                    f"L{s} global search ({n} points, P={pool}, {mode})",
                    lambda: p18_move(search.windowed_multi_band_neighbors(
                        lv.xyz.cuda(), lv.mask.cuda(), bands, **kw), "cpu"),
                    {"window_gather": 1})
                total = plus(total, counts)
                bad, valid = p20_slot_share(host, dev)
                share = 1.0 - bad / max(valid, 1)
                msg = (f"[modes] L{s} global P={pool} {mode}: {bad} of "
                       f"{valid} valid slots differ card vs CPU ({share:.6f}"
                       f" equal, need >= {PARITY_NBR_MIN})")
                check(share >= PARITY_NBR_MIN,
                      f"L{s} global P={pool} {mode} slots {share}")
                if mode == "edges":
                    rows, geo = p18_edge_rows(host[0][2], dev[0][2], n)
                    msg += (f"; edge rows shared {rows:.6f} (need >= "
                            f"{EDGE_ROW_MIN}), sxyz/d2 max |d| {geo:.3e}")
                    check(rows >= EDGE_ROW_MIN, f"L{s} edge rows {rows}")
                    check(geo <= EDGE_GEO_TOL, f"L{s} edge geometry {geo}")
                log(f"{msg} [{card}]")
    return total


def p20_recall(card):
    """20 (a): ``verify_search_recall --grid`` on the card (8192 points,
    seeds 0 and 1): the global contract rows (at least 0.99, phase 17's
    gate) and the selection study's windowed rows, global beside slab;
    the slab rows held to 0.94, the global rows printed (the tool marks
    those under 0.94).  One K2 a windowed row."""
    import contextlib
    import io
    import re

    from pointcloudsegmentation_tpu_torch import verify_search_recall as vsr

    buf = io.StringIO()

    def grid():
        with contextlib.redirect_stdout(buf):
            try:
                vsr.main(["--grid", "--device", "cuda"])
            except SystemExit as e:
                return e.code
        return None

    code, counts, secs = run_path(
        f"verify_search_recall --grid ({N_POINTS} points)", grid,
        {"window_gather": 2 * 6})
    rows = 0
    for line in buf.getvalue().splitlines():
        log(f"[modes] {line} [{card}]" if "recall=" in line
            else f"[modes] {line}")
        m = re.search(r"recall=([0-9.]+)", line)
        if m is None:
            continue
        r = float(m.group(1))
        rows += 1
        if line.startswith("global"):
            check(r >= vsr.GLOBAL_MIN, f"global contract recall {line}")
        elif "[slab" in line:
            check(r >= vsr.WINDOWED_MIN, f"slab recall {line}")
    check(rows == 2 * 3 + 6 * 2 * 3, f"{rows} recall rows")
    log(f"[modes] --grid exit code {code} (1: a row under its threshold), "
        f"{secs:.1f} s")
    return counts


def p20_wide(pyr, enc, card):
    """20 (b): the wide tier (``sel_mode="global", ov_window=
    P20_OV_WINDOW``) at level 0, card vs CPU slot for slot, then
    ``gather_neighbors`` of F=64 bf16 features forward and backward on it
    (K2 at the window and at the tier's width, K3 at both in the
    backward), the forward bitwise the CPU's; K2 and K3 against their
    plain versions at the tier's slab (S = T + 2 * P20_OV_WINDOW) and K2 at
    the global selection's geometry read.  Returns (launches, K2 rows, K3
    rows)."""
    import torch

    from pointcloudsegmentation_tpu_torch.ops import neighbors, search

    total = dict(ZERO_COUNTS)
    lv = pyr.levels[0]
    n, tile, window = lv.xyz.shape[0], 256, 256
    bands = p20_level_bands(enc, 0)
    kw = dict(tile=tile, window=window, cand_k=P20_CAND_K, ov_slots=8,
              chunk=1024, return_sxyz=True, sel_mode="global",
              ov_window=P20_OV_WINDOW)
    host = search.windowed_multi_band_neighbors(lv.xyz, lv.mask, bands, **kw)
    dev, counts, _ = run_path(
        f"L0 wide-tier search ({n} points, ov_window={P20_OV_WINDOW})",
        lambda: search.windowed_multi_band_neighbors(
            lv.xyz.cuda(), lv.mask.cuda(), bands, **kw), {"window_gather": 2})
    total = plus(total, counts)
    bad, valid = p20_slot_share(host, p18_move(dev, "cpu"))
    share = 1.0 - bad / max(valid, 1)
    wide = sum(int(d[0].ov_mask.sum()) for d in dev)
    log(f"[modes] L0 wide tier: {bad} of {valid} valid slots differ card vs "
        f"CPU ({share:.6f} equal, need >= {PARITY_NBR_MIN}); {wide} valid "
        f"wide-tier slots over {len(bands)} bands [{card}]")
    check(share >= PARITY_NBR_MIN, f"wide tier slots {share}")
    check(wide > 0, "no valid wide-tier slot")

    wn_d, wn_h = dev[0][0], host[0][0]
    gen = torch.Generator(device="cuda").manual_seed(20)
    feats = torch.randn((n, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    x = feats.clone().requires_grad_()

    def fwd_bwd():
        y = neighbors.gather_neighbors(x, wn_d)
        y.backward(torch.ones_like(y))
        return y

    y, counts, _ = run_path(
        "wide-tier gather_neighbors F=64 bf16, forward and backward",
        fwd_bwd, {"window_gather": 2, "window_dslab": 2,
                  "window_dslab_map": 2})
    total = plus(total, counts)
    want = neighbors.gather_neighbors(feats.cpu(), wn_h)
    check(torch.equal(y.detach().cpu(), want),
          "wide-tier gather card != CPU")
    check(bool(torch.isfinite(x.grad.float()).all()),
          "wide-tier gather gradient")
    log(f"[modes] wide-tier gather {tuple(y.shape)} bitwise the CPU's; "
        f"gradient finite")

    lidx = wn_d.ov_idx.contiguous()
    k2 = [k2_case(f"L0 wide tier W={P20_OV_WINDOW}", feats, lidx,
                  P20_OV_WINDOW, tile, card)]
    g = torch.randn((n, lidx.shape[1], 64), generator=gen,
                    device="cuda").to(torch.bfloat16)
    k3 = [k3_case(f"L0 wide tier W={P20_OV_WINDOW}", g, lidx, P20_OV_WINDOW,
                  tile, card)]
    # the global selection's slab geometry read: xyzm rows at the clipped
    # slab-local index of the P20_CAND_K global candidates
    x_d, m_d = lv.xyz.cuda(), lv.mask.cuda()
    _, ci = search._global_select(x_d, search.sqnorm3(x_d), m_d,
                                  P20_CAND_K, 1024)
    s = tile + 2 * window
    lo = torch.arange(n, device="cuda") // tile * tile - window
    lci = (ci - lo[:, None]).clamp(0, s - 1).to(torch.int32).contiguous()
    xyzm = torch.cat([x_d, m_d.float()[:, None]], dim=-1).contiguous()
    k2.append(k2_case("L0 global xyzm read", xyzm, lci, window, tile, card))
    return total, k2, k3


def p20_served(cfg, what, expect, card, **kw):
    """One toy block served through ``eval_scene_probs`` by ``cfg``'s
    model built with ``kw`` (seeded weights), counted: finite probabilities
    whose rows sum to 1.  Returns the counts."""
    import numpy as np
    import torch

    from pointcloudsegmentation_tpu_torch.eval.interpolate import \
        eval_scene_probs
    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    model = build_model(cfg, torch.Generator().manual_seed(0), "cuda",
                        **kw).eval()
    blocks = make_blocks("cuda")[0][:1]
    (_, probs), counts, secs = run_path(
        f"{what} served block", lambda: eval_scene_probs(model, blocks),
        expect)
    dev = float(np.abs(probs.sum(1) - 1.0).max())
    check(np.isfinite(probs).all() and dev <= PROB_SUM_TOL,
          f"{what} served probs, rows sum to 1 +- {dev}")
    log(f"[modes] {what} served block: probs {probs.shape} finite, rows sum "
        f"to 1 +- {dev:.2e}, {secs:.2f} s")
    return counts


def p20_f32(cfg, batch, fwd, step, what, card, **kw):
    """Float32 card vs CPU on block 0 of ``batch``, models built with
    ``kw``: logits argmax on at least ECD_ARGMAX_MIN of the valid points
    and the flat gradient's cosine (``f32_grad_cosine``).  Returns the
    card's counts."""
    import dataclasses

    import torch

    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    one = {k: v[:1].cpu() for k, v in batch.items()}
    args = [one[k][0] for k in ("xyz", "feats", "mask")]
    host = build_model(f32, torch.Generator().manual_seed(0), "cpu", **kw)
    card_model = build_model(f32, torch.Generator().manual_seed(0), "cuda",
                             **kw)
    with torch.inference_mode():
        want = host(*args)

    def forward():
        with torch.inference_mode():
            return card_model(*(a.cuda() for a in args)).cpu()

    got, total, _ = run_path(f"{what} float32 forward, one block", forward,
                             fwd)
    ok = args[2]
    agree = float((got.argmax(1) == want.argmax(1))[ok].double().mean())
    log(f"[modes] {what} float32 logits card vs CPU: argmax agreement "
        f"{agree:.6f} over {int(ok.sum())} valid points (need >= "
        f"{ECD_ARGMAX_MIN}), max |d| {(got - want).abs().max():.3e} [{card}]")
    check(bool(torch.isfinite(got).all()), f"{what} float32 logits")
    check(agree >= ECD_ARGMAX_MIN, f"{what} argmax agreement {agree}")
    del host, card_model
    return plus(total, f32_grad_cosine(f32, one, step, what, card, **kw))


def p20_step_pair(cfg, batch, expect, what, **kw):
    """One counted Trainer step of ``cfg``'s model built with ``kw`` from
    the seeded initial state, then the same step P20_TIMED_STEPS times
    more, each timed alone, the peak memory reset before them: each
    bitwise equal to the first.  Returns (parameters after the step, loss,
    the median seconds, peak GiB, counts)."""
    import math

    import torch

    from pointcloudsegmentation_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, device="cuda", **kw)
    state0 = trainer.init_state(torch.Generator().manual_seed(0))
    (st, m), counts, _ = run_path(f"{what} train step",
                                  lambda: trainer.train_step(state0, batch),
                                  expect)
    loss = float(m["loss"])
    check(math.isfinite(loss) and int(m["skipped"]) == 0,
          f"{what} step loss {loss}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(P20_TIMED_STEPS):
        t0 = time.perf_counter()
        again, _ = trainer.train_step(state0, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        check(torch.equal(st.params, again.params),
              f"{what}: two runs of one step differ")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    secs = sorted(secs)[len(secs) // 2]
    params = st.params.cpu()
    del trainer, state0, st, again
    torch.cuda.empty_cache()
    return params, loss, secs, peak, counts


def p20_flagship(cfg, card):
    """20 (c): the flagship under ``build_model(cfg, **P20_GLOBAL)`` (the
    JAX build's ``PCS_SEL_MODE=global PCS_CAND_K=64``), full width and
    depth, bf16 compute, seeded weights: a served block, P20_STEPS counted
    training steps on phase 7's first batch with a finite loss that
    falls, one step twice from one state bitwise equal, float32 card vs
    CPU.  Returns the launches."""
    import math

    import torch

    from pointcloudsegmentation_tpu_torch.train.loop import Trainer

    fwd, step = per_block(cfg, **P20_GLOBAL)
    total = p20_served(cfg, "global", fwd, card, **P20_GLOBAL)
    batches = make_train_batches("cuda")
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, device="cuda", **P20_GLOBAL)
    enc = trainer.model.encoder
    check((enc.sel_mode, enc.win_cand_k) == ("global", 64),
          "the global settings did not reach the encoder")
    state0 = trainer.init_state(torch.Generator().manual_seed(0))
    log(f"[modes] pointnet_s3dis {P20_GLOBAL} {cfg.compute_dtype}: "
        f"launches per block {fwd} forward, {step} training step")

    def steps():
        st, losses, times_s = state0, [], []
        for _ in range(P20_STEPS):
            t0 = time.perf_counter()
            st, mm = trainer.train_step(st, batches[0])
            losses.append(float(mm["loss"]))
            times_s.append(time.perf_counter() - t0)
        return st, losses, times_s

    (state, losses, times_s), counts, _ = run_path(
        f"global {P20_STEPS} train steps ({TRAIN_BLOCKS} x {N_POINTS} "
        "points)", steps, times(step, TRAIN_BLOCKS * P20_STEPS))
    total = plus(total, counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = sum(times_s[1:]) / (P20_STEPS - 1)
    log(f"[modes] global losses {', '.join(f'{v:.5f}' for v in losses)}; "
        f"{step_s:.4f} s a step after the first ({times_s[0]:.2f} s), peak "
        f"{peak:.3f} GiB [{card}]")
    check(all(math.isfinite(v) for v in losses), "global loss not finite")
    check(losses[-1] < losses[0], f"global loss did not fall: {losses}")
    total = plus(total, step_twice(trainer, state0, batches[0],
                                   times(step, 2 * TRAIN_BLOCKS), "global"))
    del trainer, state0, state
    torch.cuda.empty_cache()
    return plus(total, p20_f32(cfg, batches[0], fwd, step, "global", card,
                               **P20_GLOBAL))


def p20_settings(cfg, card):
    """20 (d) and (e): one step with ``remat=True`` beside one with
    ``remat=False`` from the same state (the parameters afterwards
    compared bit for bit, each step's time and peak memory, K2 a block
    with the recomputed gathers), then ``fast_conv=False``: a served
    block, one step beside the fast conv's, float32 card vs CPU.  Returns
    the launches."""
    import torch

    total = dict(ZERO_COUNTS)
    batch = make_train_batches("cuda")[0]
    runs = {}
    for remat in (False, True):
        _, step = per_block(cfg, remat=remat)
        runs[remat] = p20_step_pair(cfg, batch, times(step, TRAIN_BLOCKS),
                                    f"remat={remat}", remat=remat)
        total = plus(total, runs[remat][4])
        log(f"[modes] remat={remat}: K2 {step['window_gather']} a training "
            f"block, loss {runs[remat][1]:.6f}, step {runs[remat][2]:.4f} s,"
            f" peak {runs[remat][3]:.3f} GiB [{card}]")
    d = (runs[True][0] - runs[False][0]).abs()
    log(f"[modes] remat=True vs remat=False after one step: parameters "
        f"bitwise equal {bool(torch.equal(runs[True][0], runs[False][0]))}, "
        f"{int((d > 0).sum())} of {d.numel()} differ, max |d| "
        f"{float(d.max()):.3e}")

    fwd, step = per_block(cfg, fast_conv=False)
    total = plus(total, p20_served(cfg, "fast_conv=False", fwd, card,
                                   fast_conv=False))
    plain = p20_step_pair(cfg, batch, times(step, TRAIN_BLOCKS),
                          "fast_conv=False", fast_conv=False)
    total = plus(total, plain[4])
    fast = runs[False]
    log(f"[modes] fast_conv=False: launches per block {fwd} forward, {step} "
        f"training step; loss {plain[1]:.6f}, step {plain[2]:.4f} s, peak "
        f"{plain[3]:.3f} GiB; the fast conv's {fast[2]:.4f} s, "
        f"{fast[3]:.3f} GiB [{card}]")
    return plus(total, p20_f32(cfg, batch, fwd, step, "fast_conv=False",
                               card, fast_conv=False))


def phase_modes(card):
    """20: the search modes and the encoder settings on the card (see the
    docstring).  Returns (launches, K2 rows, K3 rows)."""
    from pointcloudsegmentation_tpu_torch.config import s3dis_config
    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    cfg = s3dis_config()
    pyr = p20_block(cfg)
    enc = build_model(cfg, None, "cpu").encoder
    t0 = time.perf_counter()
    total = p20_searches(pyr, enc, card)
    total = plus(total, p20_recall(card))
    log(f"[modes] part (a) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts, k2, k3 = p20_wide(pyr, enc, card)
    total = plus(total, counts)
    log(f"[modes] part (b) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    total = plus(total, p20_flagship(cfg, card))
    log(f"[modes] part (c) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    total = plus(total, p20_settings(cfg, card))
    log(f"[modes] parts (d), (e) in {time.perf_counter() - t0:.1f} s")
    return total, k2, k3


def phase_bench(card):
    """21: the port's bench (``python -m
    pointcloudsegmentation_tpu_torch.bench``) in-process at its defaults
    (see the docstring).  Returns (its launches, its final line's object,
    its peak device memory in GiB)."""
    import math

    import torch

    from pointcloudsegmentation_tpu_torch import bench
    from pointcloudsegmentation_tpu_torch.config import s3dis_config
    from pointcloudsegmentation_tpu_torch.data import toy
    from pointcloudsegmentation_tpu_torch.train.loop import Trainer

    args = bench.parse_args([])
    cfg = s3dis_config(data_num_points=args.points, data_caps=bench.CAPS,
                       data_feat_dim=bench.FEAT_DIM)
    fwd, step = per_block(cfg)
    steps = bench.WARMUP + bench.CHAINS * bench.ITERS
    sweeps = 1 + bench.SWEEPS
    # every step's blocks, every sweep's blocks, and step_flops's one block
    expect = plus(plus(times(step, steps * args.batch),
                       times(fwd, sweeps * bench.EVAL_BLOCKS)), step)
    log(f"[bench] {steps} steps of {args.batch} blocks, {sweeps} sweeps of "
        f"{bench.EVAL_BLOCKS} blocks and step_flops's one block: expected "
        f"launches {expect}")
    out, counts, _ = run_path("bench", lambda: bench.main([]), expect)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30   # reset by main
    numbers = ("value", "vs_baseline", "mfu", "flops_per_step",
               "eval_points_per_sec_per_chip")
    check(list(out) == ["metric", "value", "unit", *numbers[1:]],
          f"bench keys {list(out)}")
    check(out["metric"] == "s3dis_train_points_per_sec_per_chip"
          and out["unit"] == "points/s", f"bench metric {out}")
    for k in numbers:
        check(math.isfinite(out[k]) and out[k] > 0, f"bench {k} {out[k]}")
    check(out["mfu"] < 1, f"bench mfu {out['mfu']}")
    check(out["mfu"] == float(f"{out['mfu']:.4g}"),
          f"bench mfu {out['mfu']} is not at 4 significant figures")

    # the count on the CPU, where the kernels' plain versions run
    t0 = time.perf_counter()
    cpu = Trainer(cfg, "cpu", search_chunk=args.chunk)
    batch = next(toy.toy_batches(
        2, batch_size=args.batch, num_points=args.points, kind="room",
        num_classes=bench.NUM_CLASSES, feat_dim=bench.FEAT_DIM))
    cpu_flops = cpu.step_flops(
        cpu.init_state(torch.Generator().manual_seed(0)), batch)
    log(f"[bench] step_flops on the card {out['flops_per_step']:.6e}, on "
        f"the CPU {cpu_flops:.6e} ({time.perf_counter() - t0:.1f} s)")
    check(out["flops_per_step"] == cpu_flops,
          f"step_flops card {out['flops_per_step']} != CPU {cpu_flops}")
    log(f"[bench] {json.dumps(out)} [{card}]")
    return counts, out, peak


P22_ARM_ITERS = 2            # steps per chain of each ab_arms arm
P22_ARMS = ({"label": "base"},
            {"label": "exact", "env": {"PCS_DISABLE_WINDOWED": "1"}},
            {"label": "vmap", "env": {"PCS_BATCH_VMAP": "1"}})
P22_ARM_KEYS = ["label", "points_per_sec", "step_ms", "batch", "model",
                "points", "chains_ms"]
P22_REPS = 4                # microbench --reps
P22_ITERS = 5               # microbench.repeat_timed's chains after its first
P22_GRAPH_WARMUP = 3        # utils.timing.graph_ms's calls before capture


def jax_row_patterns(script, functions):
    """Regexes of the row labels that the JAX script ``scripts/<script>``
    prints from ``functions``, read from its source with ``ast`` (no
    import): each f-string that formats a time (``{t...}`` or
    ``{step_time()...}``) after ": ", its text before that, each field
    matching any text."""
    import ast
    import re

    tree = ast.parse(open(os.path.join(ROOT, "scripts", script)).read())
    pats = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name in functions):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.JoinedStr):
                continue
            vals, label = node.values, None
            for i, v in enumerate(vals[:-1]):
                nxt = vals[i + 1]
                timed = isinstance(nxt, ast.FormattedValue) and (
                    ast.unparse(nxt.value) in ("t", "step_time()"))
                if (isinstance(v, ast.Constant) and v.value.endswith(": ")
                        and timed):
                    label = vals[:i] + [ast.Constant(v.value[:-2])]
                    break
            if label is not None:
                pats.append("".join(
                    re.escape(x.value) if isinstance(x, ast.Constant)
                    else ".+" for x in label))
    check(pats, f"no timed rows found in scripts/{script} {functions}")
    return pats


def p22_rows(what, run, per_call, extra, script, functions):
    """Run ``run`` (a tool's ``main``) with ``microbench.time_row`` wrapped
    to count each row's K2 and K3 launches, and check every row: its ms
    (and device ms) finite and positive, its launches ``per_call(label)``
    times the calls its timing made, the run's launches those of its rows
    plus ``extra`` (made outside them), and every JAX row template
    matched.  Returns the run's launches."""
    import math
    import re

    from pointcloudsegmentation_tpu_torch import microbench as mb

    real, seen = mb.time_row, []

    def counted(label, op, seed_val, reps, nbytes=0, note=""):
        before = read_counts()
        row = real(label, op, seed_val, reps, nbytes, note)
        after = read_counts()
        seen.append((row, reps, {k: after[k] - before[k] for k in after}))
        return row

    mb.time_row = counted
    reset_counts()
    t0 = time.perf_counter()
    try:
        rows = run()
    finally:
        mb.time_row = real
    total = read_counts()
    log(f"[measure] {what}: {len(rows)} rows in "
        f"{time.perf_counter() - t0:.1f} s; launches {total}")
    for r in rows:
        check(math.isfinite(r.ms) and r.ms > 0, f"{what} {r.label}: ms "
              f"{r.ms}")
        check(r.device_ms is None or (math.isfinite(r.device_ms)
                                      and r.device_ms > 0),
              f"{what} {r.label}: device ms {r.device_ms}")
    in_rows = {}
    for r, reps, counts in seen:
        one = per_call(r.label)
        calls = reps * (1 + P22_ITERS)
        if r.device_ms is not None:
            calls += 1 + P22_GRAPH_WARMUP + reps
        for k, v in counts.items():
            lo = one.get(k, 0) * calls
            hi = lo + (one.get(k, 0) if r.device_ms is None else 0)
            check(lo <= v <= hi, f"{what} {r.label}: {k} launched {v} "
                  f"times, expected {lo}" + (f" to {hi}" if hi > lo else ""))
        in_rows = plus(in_rows, counts)
    want = plus(in_rows, extra)
    for k, v in total.items():
        check(v == want.get(k, 0), f"{what}: {k} launched {v} times, its "
              f"rows {in_rows.get(k, 0)} and {extra.get(k, 0)} outside them")
    labels = [r.label for r in rows]
    for pat in jax_row_patterns(script, functions):
        check(any(re.fullmatch(pat, lb) for lb in labels),
              f"{what}: no row for the JAX row {pat!r} of scripts/{script}")
    return total


def p22_arms(cfg, card):
    """(a): ``ab_arms.main`` with ``P22_ARMS``, each arm's launches read
    around it.  Returns the launches."""
    import contextlib
    import io
    import math

    from pointcloudsegmentation_tpu_torch import ab_arms

    _, step = per_block(cfg)
    steps = ab_arms.WARMUP + ab_arms.CHAINS * P22_ARM_ITERS
    expect = {"base": times(step, steps * TRAIN_BLOCKS), "exact": {},
              "vmap": {}}
    arms = [dict(a, iters=P22_ARM_ITERS) for a in P22_ARMS]
    real, counts = ab_arms.run_arm, {}

    def counted(arm, device="cuda"):
        reset_counts()
        try:
            return real(arm, device)
        finally:
            counts[arm["label"]] = read_counts()

    ab_arms.run_arm = counted
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = ab_arms.main([json.dumps(arms)])
    finally:
        ab_arms.run_arm = real
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    for line in lines:
        log(f"[measure] ab_arms {json.dumps(line)} [{card}]")
    log(f"[measure] ab_arms: returned {rc} in "
        f"{time.perf_counter() - t0:.1f} s; launches {counts}")
    check(rc == 1, f"ab_arms returned {rc} with a refused arm")
    check([x["label"] for x in lines] == [a["label"] for a in arms],
          f"ab_arms lines {lines}")
    for x in lines[:2]:
        check(list(x) == P22_ARM_KEYS, f"ab_arms keys {list(x)}")
        check(x["model"] == cfg.model and x["points"] == cfg.data.num_points
              and x["batch"] == TRAIN_BLOCKS, f"ab_arms workload {x}")
        for v in [x["points_per_sec"], x["step_ms"], *x["chains_ms"]]:
            check(math.isfinite(v) and v > 0, f"ab_arms {x['label']}: {v}")
    check(list(lines[2]) == ["label", "error"]
          and "PCS_BATCH_VMAP" in lines[2]["error"],
          f"ab_arms refused arm {lines[2]}")
    total = {}
    for label, want in expect.items():
        for k, v in counts[label].items():
            check(v == want.get(k, 0), f"ab_arms {label}: {k} launched {v} "
                  f"times, expected {want.get(k, 0)}")
        total = plus(total, counts[label])
    return total


def phase_measure(cfg, card):
    """22: the measurement tools (see the docstring).  Returns their
    launches."""
    from pointcloudsegmentation_tpu_torch import microbench, model_breakdown

    total = p22_arms(cfg, card)
    fwd, step = per_block(cfg)
    conv_fwd = {"window_gather": 1}
    conv_step = {"window_gather": 1, "window_dslab": 1, "window_dslab_map": 1}

    def per_call(label):
        if "[windowed]" in label:
            return conv_step if "fwd+bwd" in label else conv_fwd
        if "full model fwd+bwd" in label:
            return step
        return fwd if "full model fwd" in label else {}

    # launches outside the rows: the conv rows' windowed search (one K2
    # geometry read of its global selection), the model rows' chained steps
    steps = model_breakdown.STEP_WARMUP + model_breakdown.STEP_REPS
    for which, extra in (("conv", {"window_gather": 1}), ("sort", {}),
                         ("model", times(step, steps * TRAIN_BLOCKS))):
        total = plus(total, p22_rows(
            f"model_breakdown --which {which}",
            lambda: model_breakdown.main(["--which", which]), per_call,
            extra, "model_breakdown.py", (f"bench_{which}",)))
    bench_fns = tuple(f"bench_{w}" for w in (
        "gather_scatter", "conv_shapes", "onehot_window", "select",
        "select2", "windowed", "scatter_variants", "compaction"))
    n = p22_rows(f"microbench --which all --reps {P22_REPS}",
                 lambda: microbench.main(["--which", "all", "--reps",
                                          str(P22_REPS)]),
                 lambda label: {}, {}, "microbench.py", bench_fns)
    return plus(total, n)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    port = os.path.join(ROOT, "pointcloudsegmentation_tpu_torch")
    if not os.path.isdir(port):
        print("chip smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    from pointcloudsegmentation_tpu_torch.config import s3dis_config
    from pointcloudsegmentation_tpu_torch.train.model_zoo import build_model

    t_start = time.perf_counter()
    card, kind = phase_device()
    phase_build()
    cfg = s3dis_config()
    model = build_model(cfg, torch.Generator().manual_seed(0), "cuda").eval()
    rows = phase_kernel(model, cfg, card)
    launches = phase_serve(model, cfg)
    blocks, _ = make_blocks("cpu")
    b0 = blocks[0]
    phase_parity(model, cfg, (b0["xyz"], b0["feats"], b0["mask"]), card)
    drows = phase_dslab(model, cfg, card)
    train_launches = phase_train(cfg, card)
    frows, fused_launches = phase_fused_conv(card)
    # phase 21 runs here: phases 18 and 19 set their steps beside its own
    t21 = time.perf_counter()
    entry_launches, bench_out, peak = phase_bench(card)
    log(f"[bench] phase 21 in {time.perf_counter() - t21:.1f} s")
    train_pps = bench_out["value"]
    t9 = time.perf_counter()
    entry_launches = plus(entry_launches, phase_entry_points(card))
    log(f"[entry] phase 9 in {time.perf_counter() - t9:.1f} s")
    t10 = time.perf_counter()
    family_launches, k2_family, k3_family = phase_family(card)
    log(f"[family] phase 10 in {time.perf_counter() - t10:.1f} s")
    rows += k2_family
    drows += k3_family
    entry_launches = plus(entry_launches, family_launches)
    t11 = time.perf_counter()
    ecd_launches, k2_ecd, k3_ecd, _ = phase_ecd(card)
    log(f"[ecd] phase 11 in {time.perf_counter() - t11:.1f} s")
    rows += k2_ecd
    drows += k3_ecd
    entry_launches = plus(entry_launches, ecd_launches)
    t12 = time.perf_counter()
    gpn_launches, k2_gpn, k3_gpn, _ = phase_gpn(card)
    log(f"[gpn] phase 12 in {time.perf_counter() - t12:.1f} s")
    rows += k2_gpn
    drows += k3_gpn
    entry_launches = plus(entry_launches, gpn_launches)
    t13 = time.perf_counter()
    composite_launches, k2_comp, k3_comp, _ = phase_composite(card)
    log(f"[composite] phase 13 in {time.perf_counter() - t13:.1f} s")
    rows += k2_comp
    drows += k3_comp
    entry_launches = plus(entry_launches, composite_launches)
    t14 = time.perf_counter()
    s3d_launches, k2_s3d, k3_s3d, _ = phase_semantic3d(card)
    log(f"[semantic3d] phase 14 in {time.perf_counter() - t14:.1f} s")
    rows += k2_s3d
    drows += k3_s3d
    entry_launches = plus(entry_launches, s3d_launches)
    t15 = time.perf_counter()
    scan_launches, _ = phase_scan(card)
    log(f"[scan] phase 15 in {time.perf_counter() - t15:.1f} s")
    entry_launches = plus(entry_launches, scan_launches)
    t16 = time.perf_counter()
    parallel_launches = phase_parallel(card)
    log(f"[parallel] phase 16 in {time.perf_counter() - t16:.1f} s")
    entry_launches = plus(entry_launches, parallel_launches)
    t17 = time.perf_counter()
    tools_launches = phase_tools(model, cfg, card)
    log(f"[tools] phase 17 in {time.perf_counter() - t17:.1f} s")
    entry_launches = plus(entry_launches, tools_launches)
    t18 = time.perf_counter()
    edge_launches = phase_edges(card, (train_pps, peak))
    log(f"[edges] phase 18 in {time.perf_counter() - t18:.1f} s")
    entry_launches = plus(entry_launches, edge_launches)
    t19 = time.perf_counter()
    exact_launches = phase_exact(card, (train_pps, peak))
    log(f"[exact] phase 19 in {time.perf_counter() - t19:.1f} s")
    entry_launches = plus(entry_launches, exact_launches)
    t20 = time.perf_counter()
    modes_launches, k2_modes, k3_modes = phase_modes(card)
    log(f"[modes] phase 20 in {time.perf_counter() - t20:.1f} s")
    rows += k2_modes
    drows += k3_modes
    entry_launches = plus(entry_launches, modes_launches)
    t22 = time.perf_counter()
    entry_launches = plus(entry_launches, phase_measure(cfg, card))
    log(f"[measure] phase 22 in {time.perf_counter() - t22:.1f} s")

    main_row = next(r for r in rows if r["name"].endswith("conv"))
    dmain, fmain = drows[0], frows[0]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s; "
        f"kernel times below are {main_row['name']} N={main_row['n']} "
        f"K={main_row['k']} F={main_row['f']} {main_row['dtype']} (gather), "
        f"{dmain['name']} N={dmain['n']} K={dmain['k']} F={dmain['f']} "
        f"{dmain['dtype']} (slab gradient: map and sum kernels; the map "
        f"alone in its own row) and {fmain['name']} "
        f"{fmain['dtype']} (fused conv); launches are the serve sweep's plus "
        f"one training step's, the entry points', the PointNet family's, "
        f"the ECD family's, the GPN family's, the composite models', the "
        f"Semantic3D pipelines', the Semantic3D scan's, the parallel "
        f"paths' (every rank's), the tools', the edge list's and conv "
        f"tail's, the windowed-vs-exact A/B's, the search modes' and "
        f"encoder settings', the flagship bench's and the measurement "
        f"tools', and the fused-conv "
        f"bench's; "
        f"the bench's eval {bench_out['eval_points_per_sec_per_chip']:.1f} "
        f"dense points/s, train {train_pps:.1f} points/s, peak {peak:.3f} "
        f"GiB")
    timing = ("ms", "plain_ms", "bound_ms", "bound_by")
    print(json.dumps({"kernels": [dict({
        "name": "window_gather",
        "route": "cuda",
        "source": "pointcloudsegmentation_tpu_torch/csrc/window_gather.cu",
        "replaces":
            "pointcloudsegmentation_tpu/ops/pallas/window_gather.py:95",
        "launches": launches + train_launches["window_gather"]
        + entry_launches["window_gather"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "library_ms": main_row["library_ms"],
    }, **{key: main_row[key] for key in timing}), dict({
        "name": "window_dslab",
        "route": "cuda",
        "source": "pointcloudsegmentation_tpu_torch/csrc/window_dslab.cu",
        "replaces":
            "pointcloudsegmentation_tpu/ops/pallas/window_gather.py:125",
        "launches": train_launches["window_dslab"]
        + entry_launches["window_dslab"],
        "max_abs_err": max(r["max_abs_err"] for r in drows),
        "library_ms": dmain["library_ms"],
    }, **{key: dmain[key] for key in timing}), dict({
        "name": "window_dslab_map",
        "route": "cuda",
        "source": "pointcloudsegmentation_tpu_torch/csrc/window_dslab.cu",
        "replaces":
            "pointcloudsegmentation_tpu/ops/pallas/window_gather.py:125",
        "launches": train_launches["window_dslab_map"]
        + entry_launches["window_dslab_map"],
        "max_abs_err": 0.0,
        "library_ms": dmain["map"]["library_ms"],
    }, **{key: dmain["map"][key] for key in timing}), dict({
        "name": "fused_window_conv",
        "route": "cuda",
        "source": "pointcloudsegmentation_tpu_torch/csrc/fused_window_conv.cu",
        "replaces": "pointcloudsegmentation_tpu/ops/pallas/fused_conv.py:106",
        "launches": fused_launches,
        "max_abs_err": max(r["max_abs_err"] for r in frows),
        "library_ms": None,
    }, **{key: fmain[key] for key in timing})]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
