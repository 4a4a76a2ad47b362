#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repo root: `python3 chip_smoke.py [--quality [--seeds S ...]
[--recipes R ...] [--quality-steps N]] [--profile] [--sass-against DIR]`,
or `python3 chip_smoke.py --quality-only [--recipes R ...]` (phase 1,
then phase 7 alone: no result lines),
or `python3 chip_smoke.py --volsdf-repeat ROOT [ROOT ...]` or
`--k5f-against ROOT [ROOT ...]` (below).
Phases, each printing its lines before the next starts:
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles every hand-written kernel from nerf_atlas_tpu_torch/csrc
     (one nvcc per source, all started together) and prints ptxas'
     registers and spills, and the tensor-core instructions in the SASS:
     HGMMA (wgmma) in each of render_fwd's six kernels, in render_ae_fwd,
     in both render_volsdf_fwd libraries (without and with the eikonal
     column) and in each of the four render_dyn_fwd libraries (K1's,
     K7f's, K8f's and K9f's split-TF32 products), HMMA in each render_bwd,
     render_ae_bwd,
     render_dyn_bwd and render_volsdf_bwd library (K2/K3's, K7b's, K9b's
     and K8b's; none in the reduction);
  3. kernels vs plain torch on the card, 4096 seeded rays at full width,
     64 steps, over sky and rgb-activation kinds and seeded/amplified
     weights: K1 (render_fwd) on the uniform grid and on a jittered ts,
     each line also held to the float64 products (`_witness`);
     K2 (render_bwd, cotangent mode) and K3 (render_bwd, loss mode) on a
     jittered ts, against autograd through the plain K1, over all rays
     and over the rays clear of leaky-relu kinks; a ragged batch;
     PlainCPRender's gradient against K2's. Then the hash grid: K5f
     (hash_fwd) bit for bit at T = 2^19, 2^14 and 2 and K5b (hash_bwd)
     at T = 2^19 and 2^14 over the check
     rays' 4096 x 64 points, bbox-face and out-of-bbox points, with the
     table seeded and amplified to +-1; two K5f launches bit for bit, and
     the share of corner pairs its 16-byte loads join per level
     (`testing.k5f_joined_share`); K5b bit for bit across two
     launches and a permutation of the points, and its fixed point
     against the float64 sum of the same products within its bound;
     K1/K2/K3 in hash mode at T = 2^19
     as for cp; the chained table gradient (K3-hash -> K5b) against
     autograd through the plain path; a ragged batch; PlainHashRender's
     gradient against K2-hash's. Then NeRFAE: K7f (render_ae_fwd) at
     (64 steps, 1001 rays) and (16 steps, 77 rays), black and white sky,
     on the grid and on a jittered ts, each line held to the float64
     products as K1's, and two K7f launches bit for bit; K7b
     (render_ae_bwd) in cotangent
     and loss mode at 4096 x 64 and 77 x 16 as for K2/K3, over all rays
     and the kink-free ones; AERender's gradient against mode G's; two
     K7b launches bit for bit; each K7b kink-free line also held per
     tensor to a float64 witness, as K9b's. Then the K4 modes of K1/K2/K3
     (posenc, tiny, cone, cylinder) at 4096 x 64 as for cp, a ragged
     batch, and PlainCPRender's gradient against K2's and two launches of
     K2 and of K3 bit for bit in each mode. Then VolSDF: K8f (render_volsdf_fwd)
     with and without its eikonal column at (64 steps, 1001 rays) and
     (16 steps, 77 rays), as for K7f (the column over the kink-free rays
     of `testing.volsdf_kink_free_rays`, and its float64 witness there),
     two K8f launches of each build bit for bit, and the eikonal build's
     sign stash, read back from one block, against the signs of the plain
     forward's leaky-relu inputs; K8b (render_volsdf_bwd) in
     modes G and L, each with and without the eikonal, at 4096 x 64 and
     77 x 16 as for K7b, with a float64 witness of the eikonal's loss
     mode; VolSDFRender's gradient against mode G's and two K8b launches
     of each mode bit for bit. Then D-NeRF, in four modes (cp and posenc
     canonical, Δx and the spline at S = 4), seeded and amplified weights
     with the warp active: K9f (render_dyn_fwd) with and without its dp²
     column at 16384 x 64 and 77 x 16, on the grid and a jittered ts, each
     line held to the float64 products as K1's, and two K9f launches of
     each mode bit for bit; K9b
     (render_dyn_bwd) in modes G and L, each with and without the dp²
     term, as for K8b over the rays `testing.dyn_kink_free_rays` clears,
     each kink-free check also held per tensor to a float64 witness;
     DynRender's gradient against mode G's and two K9b launches bit for
     bit. Then per-ray ts and the weights output (K6) in CoarseFineNeRF's
     modes (cp, posenc, cone, cylinder): K1 on the merged per-ray ts of a
     coarse pass at 4096 x 128 and ragged at 77 x 16, seeded and
     amplified, against its plain version (rgb, acc, weights); a shared
     ts against the same ts per ray, bit for bit; K2 and K3 on those ts as
     for cp; PlainCPRender (weights output on) against K2 and two K2
     launches, bit for bit;
  3n. the rest of the dynamic family, no kernel: the module forward on the
     card against the same module on the CPU (the same state_dict, 1024
     rays x 64 steps, the same times; rgb, dp and rigidity within 1e-4)
     for DynamicNeRFAE, LongDynamicNeRF (4 segments), DynamicNeRF with an
     8-wide time latent over plain-cp and DynamicNeRF over the tiny, ae
     and coarse_fine canonicals, each with its warp active; each dynamic
     regularizer on the same draws, card against CPU: the NR-NeRF offset
     and the rigidity sparsity on the time-latent model's forward, the
     divergence, FFJORD divergence, spline length and spline point 0 on
     it and on the LongDynamicNeRF (values within 1e-5 relative,
     parameter gradients within 1e-2);
  3s. the SDF family, no kernel, beside phase 2: the SDF renderer (the MLP
     shape and each other kind in its bounding sphere, bisect; the MLP
     shape with secant and sphere marching; 128 scan steps, seed 0) on
     the card against the same model on the CPU, 256 rays, on the rays
     whose scan decisions cannot flip (SDF_MARGIN): hits exact, rgb and
     pts within 1e-4, the throughput within 1e-3, the normals within
     1e-2 relative (sphere marching: hits on all but 1 ray in 50, the
     shading at the card's own end points); --volsdf-alternate
     --alt-train 1 for 20 steps of the volsdf_eikonal recipe through the
     module forward; a VolSDF-SIREN render at 64x64 writing the normals,
     depth and depth-query normal maps;
  4. main path, render: the port's runner renders and scores the
     procedural scene at 800x800 (2 views, train + test split, seeded
     random weights) and must launch K1; 4b. the same with --enc-kind
     hash (T = 2^19), which must launch K5f and K1-hash; 4c. the same
     with --model ae --normalize-latent, which must launch K7f and no K1;
     4d-4f. the same with --enc-kind posenc, --mip cone and cylinder, and
     --model tiny, which must launch K1 in that mode and nothing else,
     and run no module forward; 4g. the same with --model volsdf
     --sigmoid-kind upshifted, which must launch K8f and nothing else;
     4h. dnerf-render-800: --data-kind synthetic-dyn --dyn-model plain,
     each view at its own time, which must launch K9f and nothing else;
     4j. coarse_fine-render-800: --model coarse_fine --mip cone (BASELINE
     config #2), which must launch K1 twice per 65536-ray chunk (the
     coarse pass with weights, the fine pass on 128 per-ray ts), nothing
     else, and run no module forward; 4k. dnerf-ae-render-800: --model ae
     --dyn-model ae (DynamicNeRFAE), and 4l. long-render-800: --dyn-model
     long --long-vid-segments 4 (LongDynamicNeRF over plain-cp), each 1
     view x 2 splits on the dynamic scene, which must run module forwards
     and launch no kernel; 4m. dnerf-over-time-800: the spline S = 4
     D-NeRF with --render-over-time 0 --render-frames 4
     --render-bezier-keyframes --notraintest --notest, which must launch
     K9f 10 times per frame for the 8 frames, nothing else, and write
     the 8 PNGs;
  5. main path, train: the port's runner trains PlainNeRF-CP on the
     procedural scene (48x48, 30 views, batch 4096, 64 steps per ray,
     300 steps) and must engage the one-kernel step, launch K3 once per
     step and K1 in eval, and beat the all-black PSNR by 2 dB on both
     splits; 5b. the same for PlainNeRF-hash at the quality sweep's
     plain_hash recipe (--hash-table-log2 14), which must launch K5f,
     K3-hash and K5b once per step, then two 50-step hash runs from seed
     0 that must give the same loss curve and parameters bit for bit;
     5c. NeRFAE at the sweep's ae recipe
     (--normalize-latent --latent-l2-weight 1e-3), which must engage the
     one-kernel step and launch K7b once per step; 5d-5f. the sweep's
     plain_posenc and plain_mip_cone recipes (300 steps, both splits 2 dB
     over all-black), --mip cylinder (100 steps) and tiny (300 steps, its
     PSNR recorded), each through K3 in its mode once per step; 5g. the
     sweep's volsdf_eikonal recipe (300 steps), which must engage the
     one-kernel step, launch K8b once per step and K8f in eval, and beat
     all-black by 2 dB on both splits; 5h. dnerf-train-4096, the sweep's
     dnerf_dx recipe (200 steps), and 5i. dnerf-spline-train-4096, its
     dnerf_spline_dp recipe (--spline 4 --dp-weight 1e-3, 200 steps), each
     through the one-kernel step (K9b once per step, K9f in eval, nothing
     else), both splits 2 dB over all-black; 5j. coarse_fine-train-4096,
     the sweep's coarse_fine_mip recipe (200 steps), through the
     two-kernel path (K1 and K2 twice per step, K1 twice per eval chunk,
     nothing else), both splits 2 dB over all-black; 5k.
     dnerf-spline-reg-train-4096, the dnerf_spline_dp recipe (200 steps)
     with --spline-len-decay, --spline-pt0-decay and
     --dyn-divergence-weight 1e-3, through the two-kernel path (K9f with
     its dp² column and K9b-G once per step, the regularizers by autograd
     beside them, K9f in eval, nothing else), both splits 2 dB over
     all-black, its eval writing the flow and rigidity maps
     (--flow-images --rigidity-images) and clusters.png
     (--cluster-movement 3); 5l-5n. the module-forward paths at the
     sweep's shape, no kernel launched: the time latent with the offset,
     rigidity-sparsity and FFJORD terms (30 steps), DynamicNeRFAE (30
     steps), LongDynamicNeRF trained progressively over 2 segments (15
     steps each), each loss finite with its last-10 mean under its
     first-10 mean, results.txt written; 5s. sdf-surface-train-4096 (run
     beside phase 2): the sweep's sdf_surface recipe (--model sdf, 200
     steps) through the module forward, no kernel, its losses finite and
     falling, both splits' PSNR beside all-black, the normals maps
     written; 5v. volsdf-smooth-train-4096: the volsdf_eikonal recipe with
     --smooth-normals-weight 1e-3 (200 steps) through the two-kernel path
     (K8f with its eikonal column and K8b-G once per step, the smoothness
     term by autograd beside them, K8f in eval, nothing else), its loss
     falling; 5o. captured scenes: beside phase 2, on-disk fixtures written
     at their formats' sizes from the procedural scene rendered on the card
     (`testing.write_nerf_synthetic`, `write_dtu`: a NeRF-synthetic scene
     of 12 train + 4 test views at 800x800 RGBA, a D-NeRF scene of the same
     size with times, a DTU scan of 12 views at 1600x1200 RGB with masks
     and cameras.npz; row r of each PNG filtered by r mod 5); then through
     the runner, each load's decode + resize seconds per split: the
     makefile's `original` recipe (PlainNeRF --mip cone, size 128, batch
     4096, 64 samples), its `dtu` recipe (VolSDF, size 192, batch 1024,
     eikonal 0.1) and its `dnerf` recipe (size 128, batch 2048, --dp-weight
     1e-3), CAPTURED_STEPS steps each on `fused-one-kernel` with K3-cone,
     K8b-L and K9b-L once a step, K1-cone, K8f and K9f in eval and nothing
     else, the loss falling and train PSNR 2 dB over all-black; then
     BASELINE config #1 (--model tiny --data-kind original, size 64,
     --crop-size 32 --loss-fns l2 ssim fft --style-img <a test view>
     --msssim-loss, CROP_STEPS steps) on the module path: no kernel in
     training (K1-tiny once per eval view), MS-SSIM written for each view;
  6. timing: one 800x800x64 frame through render_view (kernel) and through
     the plain-torch reference, one 65536-ray K1 call and one 65536-ray K2
     call of each; per train step at 4096x64: K3, K1 + K2, the plain step
     and the optimizer alone. For hash: K5f and K5b per call (262144 and
     4194304 points, each at T = 2^19 and 2^14), the K1-hash and K3-hash
     calls, the hash train steps
     (K3 at T = 2^19 and 2^14, K1 + K2, plain) and one 800x800 hash frame.
     For NeRFAE: the K7f and plain calls at 65536 x 64, one 800x800 frame,
     the K7b and plain K7b calls at 4096 x 64, the train steps (K7b,
     K7f + K7b, plain) and the point-sampled latent L2's share of a step.
     For each K4 mode: the K1 and plain calls at 65536 x 64 and the K3 and
     plain K3 calls at 4096 x 64; for posenc, mip cone and tiny the three
     train steps (K3, K1 + K2, plain). For VolSDF: the K8f and plain calls
     at 65536 x 64 with and without the eikonal column, one 800x800
     frame, K8b calls at 4096 x 64 (mode L with and without the eikonal,
     mode G with it) and their plain versions, and the three train steps
     (K8b, K8f + K8b, plain) at the volsdf_eikonal recipe. For D-NeRF, Δx
     and the spline at S = 4: K9f and plain calls at 65536 x 64 with and
     without the dp² column, K9b-L and K9b-G calls at 4096 x 64 with and
     without the dp² term, one 800x800 frame, and the three train steps
     of the dnerf_dx and dnerf_spline_dp recipes. For coarse_fine: one
     800x800 mip-cone frame through render_view and through the plain
     version, K1 on per-ray ts at 65536 x 128 in each of its four modes
     and K2-cone on per-ray ts at 4096 x 128 with their plain versions,
     and the coarse_fine_mip train steps (K1 + K2 twice, plain);
  6b. with `--sass-against DIR` only: the libraries of SASS_SAME and
     SASS_SAME_KERNELS built again from DIR's csrc/ (a checkout of an
     earlier commit), their SASS held kernel by kernel to this tree's
     (K5b's three kernels in hash_encode), equal or not;
  7. with `--quality` only: the training run at 1500 steps (the quality
     sweep's budget) on the kernel path for each of
     `--seeds` (default 0) and with --no-fused for the first seed; then
     plain_hash, ae, plain_posenc, plain_mip_cone, volsdf_eikonal,
     dnerf_dx, dnerf_spline_dp, coarse_fine_mip, sdf_surface and
     volsdf_smooth (5v's recipe) at 1500 steps and tiny at 3000 for each
     seed (`--recipes` picks some of them; the D-NeRF and
     coarse_fine runs must beat all-black by 2 dB on both splits);
  8. with `--profile` only: where one frame's and one train step's time
     goes, for cp, hash, ae, posenc, volsdf and dnerf_dx (torch.profiler
     traces: device
     idle share, per-kernel shares; host-side costs; SM clock and power
     under load).
The last three lines are the kernels' JSON record (each kernel's
launches on its main path (K5f in two rows: `hash_fwd` at the eval
chunk's 4,194,304 points and T = 2^19, launched by 4b; `hash_fwd_train`
at the train step's 262,144 points and T = 2^14, launched by 5b's
steps; K9f with its dp² column and K9b-G: `render_dyn_fwd_spline_dp` and
`render_dyn_bwd_grad_spline_dp`, launched by 5k's steps; K8f's eikonal
column and K8b-G: `render_volsdf_fwd_eikonal` and
`render_volsdf_bwd_grad_eikonal`, launched by 5v's steps), max error
against its plain version, ms per
call, the plain version's ms, the bound from this run's bytes and
operations at the published H100 peaks, and a single PyTorch call's ms
where one computes the function), the card's name and power limit, and
the device JSON. Any failure raises (non-zero exit, no result lines).

With `--volsdf-repeat ROOT [ROOT ...]` it runs phase 1 and then only
phase 5g's recipe (volsdf_eikonal, TRAIN_STEPS steps: K8b once per step,
K8f in eval) from each checkout ROOT of the repo, each in a process of
its own that imports ROOT's chip_smoke.py and port and builds ROOT's
kernels into ROOT/build/kernels first, and compares the runs with the
first: the loss of every step and the trained parameters bit for bit,
and the eval PSNRs. Exits 1 where two loss curves or two trained models
differ.

With `--decode-views N` it runs phase 1 and then only a NeRF-synthetic
split of N views at 800x800 RGBA written as phase 5o writes it, and times
its load (decode + resize to 128) on the card's host.

With `--k5f-against ROOT [ROOT ...]` it runs phase 1 and then only K5f,
from this tree and from each ROOT's csrc/hash_encode.cu (a checkout of an
earlier commit, or a copy of the source), each held to the plain version
bit for bit and timed in turns at phase 6's four shapes and at T = 2, and
K5b's SASS held to each ROOT's (`_k5f_against`). Exits 1 where a K5f
differs from the plain version.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SIZE = 800
STEPS = 64
CHUNK = 65536                 # render_view's rays per call
N_CHECK = 4096
# K1 vs reference: both float32, summation order differs (per-thread FMA
# chains vs cuBLAS tiles); 1e-4 abs on rgb and acc in [0, 1]
TOL = 1e-4
# K2/K3 vs reference: the loss to 1e-5 relative; each of the 32 gradient
# tensors to ‖Δ‖/‖ref‖ ≤ 1e-4 over the rays clear of leaky-relu kinks (the
# other rays get a zero cotangent). A density-MLP pre-activation within
# round-off of 0 takes the other slope in one of the two float32
# implementations (their sums run in different orders) and moves that
# point's whole backward: at 4096 rays x 64 steps this alone puts the
# float32 plain version ~4e-4 from its own float64 evaluation (PERF.md
# §6). A ray is clear when every pre-activation of its points lies
# further from 0 than KINK_MARGIN times its column's float32-vs-float64
# round-off (RMS; `testing.kink_free_rays`). Over all rays the error is
# printed and held to ALL_RAY_RTOL.
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
KINK_MARGIN = 10.0
ALL_RAY_RTOL = 1e-2
# the quality sweep's plain_cp recipe (scripts/tpu_quality_sweep.py)
TRAIN_ARGV = ["--data-kind", "synthetic", "--model", "plain", "--enc-kind",
              "cp", "--size", "48", "--num-views", "30", "--batch-size",
              "4096", "--steps", "64", "--near", "2", "--far", "6", "-lr",
              "1e-3", "--loss-fns", "l2", "--seed", "0", "--nosave",
              "--valid-freq", "0"]
# the earlier families' train phases (once 500 steps: cut to keep the run
# without arguments inside its time limit as the D-NeRF phases joined)
TRAIN_STEPS = 300
QUALITY_STEPS = 1500
BATCH = 4096
# the quality sweep's plain_hash recipe (scripts/tpu_quality_sweep.py:58-60)
HASH_TRAIN_ARGV = (TRAIN_ARGV[:5] + ["hash", "--hash-table-log2", "14"]
                   + TRAIN_ARGV[6:])
HASH_T = 1 << 19                           # HashEncoder's default table
HASH_REPEAT_STEPS = 50                     # phase 5b's repeatability runs
HASH_TRAIN_T = 1 << 14
# (rays of 64 samples, T) of the K5f / K5b timings: the train step's
# 262,144 points and the eval chunk's 4,194,304 at both tables (the 1 MB
# table of 2^14 stays in L2; the 32 MB one of 2^19 shares it with the
# streams: the gap between the two is what the table's size costs)
K5F_SHAPES = ((BATCH, HASH_T), (CHUNK, HASH_T), (BATCH, HASH_TRAIN_T),
              (CHUNK, HASH_TRAIN_T))
# QUALITY_r05 plain_hash (TPU, seed 0, one run): a record, not a gate
QUALITY_R05_HASH = (33.686, 31.062)
# K5f vs plain torch: the same float operations in the same order, 1e-6
# abs; K5b vs plain torch: its order-free 64-bit fixed point against
# index_add_'s float32 sums, 1e-5 relative per level
HASH_TOL = 1e-6
HASH_GRAD_RTOL = 1e-5
# published H100 SXM peaks (NVIDIA's H100 datasheet): float32 outside
# the tensor cores, and HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# dense bf16 on the tensor cores: the bound a bf16 port could reach
PEAK_BF16 = 989e12
# dense TF32 on the tensor cores: K2/K3 run each float32 product as three
# TF32 products (csrc/mma_tf32.cuh), so their bound is 3 x the float32
# operations at this peak
PEAK_TF32 = 495e12
# float operations per (point, level) of K5f and of K5b: the cell (13),
# then per corner its weight and the two products and sums (7.5)
HASH_FLOP_PER_LEVEL = 73
# the quality sweep's ae recipe (scripts/tpu_quality_sweep.py:75-77)
AE_TRAIN_ARGV = (TRAIN_ARGV[:3] + ["ae", "--normalize-latent",
                                   "--latent-l2-weight", "1e-3"]
                 + TRAIN_ARGV[6:])
AE_LATENT_L2 = 1e-3
# QUALITY_r05 ae (TPU, seed 0, one run): a record, not a gate
QUALITY_R05_AE = (33.524, 33.169)
# the quality sweep's plain_posenc, plain_mip_cone and tiny recipes
# (scripts/tpu_quality_sweep.py:48-62; tiny trains EPOCH_MULT = 2 times
# the budget), and --mip cylinder on the same recipe
POSENC_TRAIN_ARGV = TRAIN_ARGV[:5] + ["posenc"] + TRAIN_ARGV[6:]
MIP_TRAIN_ARGV = TRAIN_ARGV[:4] + ["--mip", "cone"] + TRAIN_ARGV[6:]
CYLINDER_TRAIN_ARGV = TRAIN_ARGV[:4] + ["--mip", "cylinder"] + TRAIN_ARGV[6:]
TINY_TRAIN_ARGV = TRAIN_ARGV[:3] + ["tiny"] + TRAIN_ARGV[6:]
CYLINDER_STEPS = 100
# QUALITY_r05 plain_posenc, plain_mip_cone, tiny (TPU, seed 0, one run
# each): records, not gates
QUALITY_R05_POSENC = (33.413, 33.172)
QUALITY_R05_MIP = (33.381, 32.455)
QUALITY_R05_TINY = (23.284, 16.67)
K4_MODES = ("posenc", "tiny", "cone", "cylinder")
# the quality sweep's coarse_fine_mip recipe (scripts/tpu_quality_sweep.py:
# 63-64): BASELINE config #2, CoarseFineNeRF with the cone IPE and 64
# fine samples per ray (the fine pass composites 128); QUALITY_r05 (TPU,
# seed 0, one run, the two-kernel path): a record, not a gate
CF_TRAIN_ARGV = (TRAIN_ARGV[:3] + ["coarse_fine", "--mip", "cone"]
                 + TRAIN_ARGV[6:])
# (300 steps until the captured scenes' phase 5o joined: cut to 200 to keep
# the run without arguments inside its time limit)
CF_STEPS = 200
FINE_STEPS = 64
QUALITY_R05_CF = (33.359, 32.386)
# the kernel modes CoarseFineNeRF takes (K1/K2 with per-ray ts, K6)
CF_MODES = ("cp", "posenc", "cone", "cylinder")
# the quality sweep's volsdf_eikonal recipe (scripts/tpu_quality_sweep.py:
# 78-80); QUALITY_r05 volsdf_eikonal (TPU, seed 0, one run, its one-kernel
# path): a record, not a gate
_LR = TRAIN_ARGV.index("-lr")
VOLSDF_TRAIN_ARGV = (TRAIN_ARGV[:3] + ["volsdf", "--sdf-kind", "mlp",
                                       "--sigmoid-kind", "upshifted",
                                       "--sdf-eikonal", "0.01"]
                     + TRAIN_ARGV[6:_LR] + ["-lr", "3e-4"]
                     + TRAIN_ARGV[_LR + 2:])
VOLSDF_EIKONAL = 0.01
QUALITY_R05_VOLSDF = (34.763, 30.991)
# the quality sweep's dnerf_dx and dnerf_spline_dp recipes
# (scripts/tpu_quality_sweep.py:81-87) on the dynamic procedural scene;
# QUALITY_r05 (TPU, seed 0, one run each, the fused one-kernel path):
# records, not gates
DNERF_TRAIN_ARGV = (["--data-kind", "synthetic-dyn"] + TRAIN_ARGV[2:]
                    + ["--dyn-model", "plain"])
DNERF_SPLINE_ARGV = DNERF_TRAIN_ARGV + ["--spline", "4", "--dp-weight",
                                        "1e-3"]
DNERF_SPLINE = 4
DNERF_DP = 1e-3
# (500 steps until the dynamic family's phases joined, then 300 until the
# captured scenes' phase 5o joined: cut to keep the run without arguments
# inside its time limit)
DNERF_STEPS = 200
DNERF_SPLINE_STEPS = 200
# the rest of the dynamic family: phase 3n's module forwards on the card
# against the CPU (1024 rays x 64 steps; rgb, dp and rigidity 1e-4 abs;
# each regularizer's value 1e-5 relative and each parameter gradient 1e-2
# relative, ALL_RAY_RTOL: leaky-relu kinks), phases 4k-4m's renders and
# 5k-5n's training runs
FAMILY_RAYS = 1024
FAMILY_REG_RTOL = 1e-5
FAMILY_CASES = (
    ("DynamicNeRFAE", "DynamicNeRFAE", {}),
    ("LongDynamicNeRF", "LongDynamicNeRF", {"segments": 4}),
    ("DynamicNeRF time latent 8 plain-cp", "DynamicNeRF",
     {"time_latent_size": 8, "canonical_kwargs": {"enc_kind": "cp"}}),
    ("DynamicNeRF tiny", "DynamicNeRF", {"canonical_kind": "tiny"}),
    ("DynamicNeRF ae", "DynamicNeRF",
     {"canonical_kind": "ae", "canonical_kwargs": {"refl_kind": "view"}}),
    ("DynamicNeRF coarse_fine", "DynamicNeRF",
     {"canonical_kind": "coarse_fine",
      "canonical_kwargs": {"refl_kind": "view"}}))
# 5k: the dnerf_spline_dp recipe with the point-sampled regularizers, its
# eval writing the flow and rigidity maps and the movement clusters
DNERF_REG_ARGV = DNERF_SPLINE_ARGV + [
    "--spline-len-decay", "1e-3", "--spline-pt0-decay", "1e-3",
    "--dyn-divergence-weight", "1e-3"]
DNERF_REG_EVAL = ["--flow-images", "--rigidity-images", "--cluster-movement",
                  "3"]
# 5l-5n: the module-forward paths at the sweep's shape, (tag, flags, steps)
ORACLE_RUNS = (
    ("5l", "dnerf-latent-regs", ["--dyn-refl-latent", "8", "--offset-decay",
                                 "1e-3", "--rigidity-sparsity", "1e-3",
                                 "--ffjord-div-decay", "1e-3"], 30),
    ("5m", "dnerf-ae", ["--dyn-model", "ae"], 30),
    ("5n", "long-progressive", ["--dyn-model", "long",
                                "--long-vid-progressive-train", "2"], 15))
# the SDF family. 5s: the quality sweep's sdf_surface recipe
# (scripts/tpu_quality_sweep.py:107-108; --model sdf, the MLP shape in its
# bounding sphere, bisect over 128 scan steps, through the module
# forward), SDF_STEPS steps beside phase 2's nvcc jobs; QUALITY_r05
# sdf_surface (TPU, seed 0, one run, the oracle path): a record, not a
# gate. 3s: each shape kind and intersector, card vs CPU on SDF_CHECK_RAYS
# rays (the rays whose scan decisions cannot flip: every scan value off
# 0 by SDF_MARGIN and the minimum unique by it): hits exact, rgb and pts
# within TOL, the throughput within SDF_TPUT_TOL (the sigmoid of −500 ×
# the minimum sdf), the normals within ALL_RAY_RTOL relative (leaky-relu
# kinks). Sphere marching sums the field's values along the ray, and at
# random weights |∇sdf| > 1 grows the devices' round-off step by step
# (0.1 apart after 128 steps on the card): its hits may differ on 1 ray in
# 50, and its shading is held at the card's own end points;
# --volsdf-alternate --alt-train 1 for ALT_STEPS steps; the
# normals, depth and depth-query normal maps at MAPS_SIZE. 5v: the
# volsdf_eikonal recipe with --smooth-normals-weight through K8f's eikonal
# column and K8b-G (VOLSDF_SMOOTH_STEPS steps)
SDF_TRAIN_ARGV = TRAIN_ARGV[:3] + ["sdf", "--sdf-kind", "mlp"] + TRAIN_ARGV[6:]
SDF_STEPS = 200
QUALITY_R05_SDF = (18.613, 18.597)
SDF_KINDS = ("mlp", "siren", "curl-mlp", "local", "spheres", "triangles")
SDF_CHECK_RAYS = 256
SDF_MARGIN = 1e-4
SDF_TPUT_TOL = 1e-3
ALT_STEPS = 20
MAPS_SIZE = 64
VOLSDF_SMOOTH_ARGV = VOLSDF_TRAIN_ARGV + ["--smooth-normals-weight", "1e-3"]
VOLSDF_SMOOTH_STEPS = 200
# phase 5o: the makefile's dataset recipes on on-disk fixtures
# (makefile:92-124), and BASELINE config #1
CAPTURED_VIEWS = (12, 4)                   # NeRF-synthetic train, test
CAPTURED_SIZE = 800
DTU_VIEWS, DTU_W, DTU_H = 12, 1600, 1200
CAPTURED_STEPS = 100
CROP_STEPS = 50
CAPTURED_RUNS = (
    # (tag, scene, argv, train kernel, eval kernel; each a `_wrappers` key:
    # K3 in cone mode, K8b and K9b in loss mode)
    ("original", "lego", ["--data-kind", "original", "--model", "plain",
                          "--size", "128", "--batch-size", "4096", "--steps",
                          "64", "-lr", "5e-4", "--mip", "cone",
                          "--sigmoid-kind", "thin"], "K3", "K1"),
    ("dtu", "scan97", ["--data-kind", "dtu", "--model", "volsdf", "--size",
                       "192", "--batch-size", "1024", "--steps", "64", "-lr",
                       "5e-4", "--eikonal-weight", "0.1"], "K8b", "K8f"),
    ("dnerf", "jumpingjacks", ["--data-kind", "dnerf", "--model", "plain",
                               "--dyn-model", "plain", "--size", "128",
                               "--batch-size", "2048", "--steps", "64", "-lr",
                               "5e-4", "--dp-weight", "1e-3"], "K9b", "K9f"))
CROP_ARGV = ["--data-kind", "original", "--model", "tiny", "--size", "64",
             "--batch-size", "4096", "--steps", "64", "-lr", "5e-4",
             "--crop-size", "32", "--loss-fns", "l2", "ssim", "fft",
             "--msssim-loss"]
QUALITY_R05_DNERF = (33.236, 26.654)
QUALITY_R05_DNERF_SPLINE = (33.279, 26.543)
DNERF_MODES = (("cp", 0), ("cp", DNERF_SPLINE), ("posenc", 0),
               ("posenc", DNERF_SPLINE))
# K9b vs its plain version over all rays (ALL_RAY_RTOL) at 16384 rays: a
# warped point's CP tap (and a leaky-relu kink) can fall on the other side
# in the two float32 implementations, and the position gradient jumps
# there; under a random cotangent these jumps add up like the gradient
# itself, so they set a relative floor that does not fall with the ray
# count but whose spread does (at 4096 rays it ran 1e-4 to 1.1e-2 across
# the modes). `_dyn_floor` prints the float64 witness at 4096.
N_DYN_CHECK = 16384
# the sources whose MLP products run on the tensor cores in split TF32,
# and the SASS instruction phase 2 counts in each of their kernels: HMMA
# (mma.sync, csrc/mma_tf32.cuh) or HGMMA (wgmma, csrc/wgmma_tf32.cuh)
TC_SOURCES = {"render_bwd": "HMMA", "render_ae_bwd": "HMMA",
              "render_dyn_bwd": "HMMA", "render_volsdf_bwd": "HMMA",
              "render_fwd": "HGMMA", "render_ae_fwd": "HGMMA",
              "render_volsdf_fwd": "HGMMA", "render_dyn_fwd": "HGMMA"}
# the libraries whose code this slice leaves as it was, and the kernels
# it leaves as they were in a library it changes (K5b's three beside the
# new K5f): `--sass-against` compares their SASS with an earlier commit's
SASS_SAME = ("render_fwd", "render_bwd", "render_ae_fwd", "render_ae_bwd",
             "render_volsdf_fwd", "render_volsdf_bwd", "render_dyn_fwd",
             "render_dyn_bwd")
SASS_SAME_KERNELS = {"hash_encode": ("hash_bwd_max_kernel", "hash_bwd_kernel",
                                     "hash_bwd_convert_kernel")}


def _phase(pid: str, fn, *args, **kwargs):
  """fn(*args, **kwargs), then one `[phase] <pid> <seconds> s` line."""
  t0 = time.perf_counter()
  out = fn(*args, **kwargs)
  print(f"[phase] {pid} {time.perf_counter() - t0:.1f} s", flush=True)
  return out


def _sync_time(fn):
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  out = fn()
  torch.cuda.synchronize()
  return out, time.perf_counter() - t0


def _event_ms(fn, reps: int) -> float:
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  fn()                                        # warm-up
  torch.cuda.synchronize()
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def _check_rays(n: int, seed: int) -> np.ndarray:
  """Rays from a sphere of radius 4 aimed near the origin (they cross the
  CP bounding box), from numpy's seeded generator."""
  rng = np.random.default_rng(seed)
  o = rng.normal(size=(n, 3))
  o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
  d = -o / 4.0 + rng.normal(size=(n, 3)) * 0.15
  return np.concatenate([o, d], -1).astype(np.float32)


def _mean_s(fn, reps: int = 5) -> float:
  return sum(_sync_time(fn)[1] for _ in range(reps)) / reps


def _kernel_name(mangled: str) -> str:
  """The `*_kernel` identifier in a mangled name (<length><identifier>
  segments), with its template mode: render_fwd_kernel<2>."""
  import re
  i = 0
  while i < len(mangled):
    m = re.match(r"\d+", mangled[i:])
    if not m:
      i += 1
      continue
    start = i + len(m.group())
    ident = mangled[start:start + int(m.group())]
    if ident.endswith("_kernel"):
      t = re.match(r"ILi(\d+)E", mangled[start + len(ident):])
      return ident + (f"<{t.group(1)}>" if t else "")
    i = start + len(ident)
  return mangled


def _ptxas_entries(log: str):
  """[(kernel, "R registers, S B spill stores, L B spill loads")] from
  nvcc's -Xptxas=-v report, in its order; a template kernel carries its
  mode (`render_fwd_kernel<2>`)."""
  import re
  out, name, spill = [], None, ""
  for ln in log.splitlines():
    m = re.search(r"Compiling entry function '(\w+)'", ln)
    if m:
      name = _kernel_name(m.group(1))
    elif "spill stores" in ln:
      spill = ln.strip()
    elif "Used" in ln and "registers" in ln and name:
      regs = re.search(r"Used (\d+) registers", ln).group(1)
      out.append((name, f"{regs} registers, {spill.split(' stack frame, ')[-1]}"))
      name = None
  return out


def _build(build, k1, k8, k9):
  """Phase 2: `_build_start`, then `_build_finish`."""
  return _build_finish(build, _build_start(build, k1, k8, k9))


def _build_start(build, k1, k8, k9):
  """Phase 2's start: one nvcc per kernel source, started together in a
  thread pool; render_bwd.cu once per mode (`render.bwd_defines`),
  render_volsdf_fwd.cu without and with the eikonal column
  (`render_volsdf.fwd_defines`), render_dyn_fwd.cu and render_dyn_bwd.cu
  once per (canonical encoder, warp kind) (`render_dyn.defines`). Returns
  what `_build_finish` waits on."""
  jobs = [(name, ()) for name in ("render_fwd", "hash_encode",
                                  "render_ae_fwd", "render_ae_bwd",
                                  "render_volsdf_bwd")]
  jobs += [("render_volsdf_fwd", k8.fwd_defines(eik))
           for eik in (False, True)]
  jobs += [("render_bwd", k1.bwd_defines(kind)) for kind in k1.ENC_KINDS]
  jobs += [(name, k9.defines(enc, spline))
           for name in ("render_dyn_bwd", "render_dyn_fwd")
           for enc, spline in k9.variants()]
  pool = concurrent.futures.ThreadPoolExecutor(len(jobs))
  futures = [pool.submit(build.build, *job) for job in jobs]
  return jobs, pool, futures, time.perf_counter()


def _build_finish(build, pending):
  """Phase 2's end: wait for every library, print each one's build time,
  registers and spills and its tensor-core instruction count."""
  jobs, pool, futures, t0 = pending
  built = [f.result() for f in futures]
  pool.shutdown()
  secs = time.perf_counter() - t0
  print(f"[build] phase 2: {len(jobs)} libraries in {secs:.1f} s",
        flush=True)
  print(f"[phase] 2 {secs:.1f} s", flush=True)
  for (name, defines), b in zip(jobs, built):
    tag = f" {' '.join(defines)}" if defines else ""
    entries = [f"{n}: {r}" for n, r in _ptxas_entries(b.log)]
    print(f"[build] {name}.cu{tag} -> {b.path.name} in {b.seconds:.1f} s | "
          f"{' | '.join(entries)}", flush=True)
    if name in TC_SOURCES:
      _tensor_core_count(build, b.path, name, tag, TC_SOURCES[name])
  return jobs, built


def _sass(build, path):
  """{kernel (`_kernel_name`): its SASS lines} of a library (cuobjdump
  beside nvcc), each line stripped of its address comment, of any name in
  an anonymous namespace (whose mangling hashes the source's path) and of
  its column padding (whose width follows the library's longest line)."""
  import re
  tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
  text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                        text=True, check=True).stdout
  out, kernel = {}, None
  for ln in text.splitlines():
    m = re.search(r"Function : (\w+)", ln)
    if m:
      kernel = _kernel_name(m.group(1))
      out[kernel] = []
    elif kernel:
      ln = re.sub(r"^\s*/\*[0-9a-f]+\*/", "", ln)
      out[kernel].append(" ".join(re.sub(r"(_GLOBAL__N__|_INTERNAL_)\w+",
                                         r"\1#", ln).split()))
  return out


def _tensor_core_count(build, path, name, tag, op):
  """Phase 2: the tensor-core instructions (`op`: HMMA or HGMMA) in a
  library's SASS, per kernel; raises if one of its `<name>_kernel`s has
  none or the partials' reduction has any."""
  import re
  sass = _sass(build, path)
  counts = {k: sum(1 for ln in v if re.search(rf"\b{op}\.", ln))
            for k, v in sass.items()}
  ops = sorted({m for v in sass.values() for ln in v
                for m in re.findall(rf"\b{op}\.[\w.]+", ln)})
  per_kernel = ", ".join(f"{k} {v}" for k, v in counts.items())
  print(f"[build] {name}.cu{tag} SASS tensor-core instructions: "
        f"{per_kernel} ({', '.join(ops)})", flush=True)
  mains = [k for k in counts if k.startswith(f"{name}_kernel")]
  if not mains or not all(counts[k] for k in mains):
    raise RuntimeError(f"{name}.cu{tag}: no {op} in a kernel of {mains}")
  if any(v for k, v in counts.items() if k.startswith("reduce_partials")):
    raise RuntimeError(f"{name}.cu{tag}: {op} in the partials' reduction")


def _sass_against(build, jobs, built, ref_root):
  """Phase 2 with `--sass-against`: each library of SASS_SAME and of
  SASS_SAME_KERNELS built again from `ref_root`'s
  nerf_atlas_tpu_torch/csrc/ with the same flags (one nvcc per source and
  defines, started together), its SASS held kernel by kernel to this
  tree's (in SASS_SAME_KERNELS' libraries, the kernels it names); prints
  equal or the lines that differ. The kernels' mangled names carry a hash
  of their source path that differs between two checkouts: kernels are
  matched by `_kernel_name`."""
  csrc = os.path.join(os.path.abspath(ref_root), "nerf_atlas_tpu_torch",
                      "csrc")
  out_dir = tempfile.mkdtemp(prefix="sass_ref_", dir=build.BUILD_DIR)
  pairs = [(j, b) for j, b in zip(jobs, built)
           if j[0] in SASS_SAME or j[0] in SASS_SAME_KERNELS]

  def ref_build(job):
    name, defines = job
    lib = os.path.join(out_dir, f"lib{name}-{'-'.join(defines) or 'x'}.so")
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS,
                    *(f"-D{d}" for d in defines), "-o", lib,
                    os.path.join(csrc, f"{name}.cu")],
                   capture_output=True, text=True, check=True)
    return lib

  t0 = time.perf_counter()
  with concurrent.futures.ThreadPoolExecutor(len(pairs)) as pool:
    refs = list(pool.map(lambda p: ref_build(p[0]), pairs))
  print(f"[sass] {len(refs)} libraries built from {csrc} in "
        f"{time.perf_counter() - t0:.1f} s", flush=True)
  same = differ = 0
  for ((name, defines), b), ref in zip(pairs, refs):
    ours, theirs = _sass(build, b.path), _sass(build, ref)
    kernels = SASS_SAME_KERNELS.get(name, sorted(set(ours) | set(theirs)))
    for kernel in kernels:
      a, c = ours.get(kernel, []), theirs.get(kernel, [])
      diff = sum(x != y for x, y in zip(a, c)) + abs(len(a) - len(c))
      same, differ = same + (diff == 0 and bool(a)), differ + (diff != 0)
      tag = f" {' '.join(defines)}" if defines else ""
      print(f"[sass] {name}.cu{tag} {kernel}: "
            f"{'equal' if diff == 0 else f'{diff} lines differ'} "
            f"({len(a)} / {len(c)} lines)", flush=True)
  print(f"[sass] {same} kernels equal, {differ} differ", flush=True)


def _rel_error(k1, grad, ref):
  """(max over the 32 state_dict tensors of ‖grad − ref‖/‖ref‖, its key)."""
  g, r = k1.unpack_grads(grad), k1.unpack_grads(ref)
  errs = {key: float((g[key] - r[key]).norm() / r[key].norm()) for key in r}
  worst = max(errs, key=errs.get)
  return errs[worst], worst


def _check_bwd(what, k1, ws, rays, gen, kw, feats=None):
  """K2 (random g) and K3 (random target) against their plain versions,
  over all rays and over the kink-free rays (see GRAD_RTOL); in hash mode
  (with the points' features `feats`) dfeat is held as one more tensor;
  kw["enc_kind"], when given, picks a K4 mode. Returns the max |Δ| of the
  gradients."""
  from nerf_atlas_tpu_torch import testing
  n = rays.shape[0]
  enc = kw.get("enc_kind")
  keep = testing.kink_free_rays(ws, rays, kw["ts"], kw["steps"], KINK_MARGIN,
                                feats=feats, enc_kind=enc)
  g = torch.randn(n, 4, device=rays.device, generator=gen)
  target = torch.rand(n, 3, device=rays.device, generator=gen)
  if feats is None:
    out = k1.plain_cp_render_reference(ws, rays, **kw)[:, :3]
    tag = f"-{enc}" if enc else ""
    fns = ((f"K2{tag}", k1.plain_cp_render_grad,
            k1.plain_cp_render_grad_reference),
           (f"K3{tag}", k1.plain_cp_train_step,
            k1.plain_cp_train_step_reference))
    args = ()
  else:
    out = k1.plain_hash_render_reference(ws, rays, feats, **kw)[:, :3]
    fns = (("K2-hash", k1.plain_hash_render_grad,
            k1.plain_hash_render_grad_reference),
           ("K3-hash", k1.plain_hash_train_step,
            k1.plain_hash_train_step_reference))
    args = (feats,)
  max_abs = 0.0
  for (mode, fn, ref_fn), arg, masked in zip(
      fns, (g, target),
      (g * keep[:, None], torch.where(keep[:, None], target, out).contiguous())):
    line = []
    for name, a in (("all rays", arg), ("kink-free", masked)):
      got, ref = fn(ws, rays, *args, a, **kw), ref_fn(ws, rays, *args, a, **kw)
      if mode.startswith("K3"):
        (loss, *got), (loss_r, *ref) = got, ref
        loss_rel = abs(float(loss) - float(loss_r)) / abs(float(loss_r))
        if not loss_rel <= LOSS_RTOL:
          raise RuntimeError(f"{what} {mode} loss {float(loss)} vs plain "
                             f"{float(loss_r)}")
        line.append(f"{name} loss rel {loss_rel:.2e}")
      elif feats is None:
        got, ref = [got], [ref]
      torch.cuda.synchronize()
      err, key = _rel_error(k1, got[0], ref[0])
      if feats is not None:
        e = float((got[1] - ref[1]).norm() / ref[1].norm())
        err, key = max((err, key), (e, "dfeat"))
      tol = ALL_RAY_RTOL if name == "all rays" else GRAD_RTOL
      if not (err <= tol and all(bool(torch.isfinite(t).all()) for t in got)):
        raise RuntimeError(f"{what} {mode} ({name}): gradient of {key} "
                           f"{err:.3e} from its plain version (tol {tol})")
      line.append(f"{name}: max_t ‖Δ‖/‖ref‖ {err:.2e} ({key})")
      if name == "kink-free":
        max_abs = max([max_abs] + [float((x - y).abs().max())
                                   for x, y in zip(got, ref)])
    print(f"[check] {mode} {what}: {' | '.join(line)} | kink-free rays "
          f"{int(keep.sum())}/{n}", flush=True)
  return max_abs


def _witness(testing, what, got, ref, w64):
  """A forward kernel (K1, K7f, K8f, K9f) held to its float64 products
  (w64: `testing.k1_float64_render`, `ae_float64_render`,
  `volsdf_float64_render`, `dyn_float64_render`)
  beside its plain version: the kernel's max |Δ| from them and the plain
  version's, for the line; raises where their ratio, with the floor TOL
  / 2, passes `testing.WITNESS_RATIO`. Where the siren's gain meets
  amplified weights the plain float32 version itself lies near the gate
  from the float64 function, so the line shows which of the two the
  distance is."""
  ek = float((got.double() - w64).abs().max())
  ep = float((ref.double() - w64).abs().max())
  ratio = ek / max(ep, TOL / 2)
  if not ratio <= testing.WITNESS_RATIO:
    raise RuntimeError(f"{what} lies {ek:.3e} from its float64 products, "
                       f"its plain version {ep:.3e} (ratio {ratio:.2f})")
  return f"float64 products: kernel {ek:.3e}, plain {ep:.3e}"


def _check_kernels(k1, testing, rays_ops, model, dev):
  """Phase 3. Returns (K1 max |Δ|, render_bwd max |Δ| on gradients); each
  K1 line also prints `_witness`."""
  ws = k1.pack_weights(model.state_dict(), dev)
  amplified = dict(model.state_dict())
  amplified["refl.mlp.layer_out.weight"] = (
      amplified["refl.mlp.layer_out.weight"] * 40.0)
  amplified["density_mlp.layer_out.weight"] = (
      amplified["density_mlp.layer_out.weight"] * 8.0)
  ws_amp = k1.pack_weights(amplified, dev)
  rays = torch.from_numpy(_check_rays(N_CHECK, 0)).to(dev)
  gen = torch.Generator(device=dev).manual_seed(0)
  max_k1, max_bwd = 0.0, 0.0
  cases = [(w, sky, kind) for w in ("seeded", "amplified")
           for sky in ("black", "white") for kind in ("thin", "normal",
                                                      "tanh")]
  for wname, sky, kind in cases:
    w = ws if wname == "seeded" else ws_amp
    kw = dict(steps=STEPS, t_near=2.0, t_far=6.0, sigmoid_kind=kind,
              sky_kind=sky)
    ts = rays_ops.compute_ts(2.0, 6.0, STEPS, perturb=1.0, generator=gen,
                             device=dev)
    for name, t in (("grid", None), ("jittered ts", ts)):
      out = k1.plain_cp_render(w, rays, ts=t, **kw)
      ref = k1.plain_cp_render_reference(w, rays, ts=t, **kw)
      torch.cuda.synchronize()
      if not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"K1 output not finite ({wname}, {sky}, {kind})")
      e_rgb = float((out[:, :3] - ref[:, :3]).abs().max())
      e_acc = float((out[:, 3] - ref[:, 3]).abs().max())
      witness = _witness(testing, "K1", out, ref, testing.k1_float64_render(
          w, rays, ts=t, **kw))
      print(f"[check] K1 {wname:9s} sky {sky:5s} {kind:6s} {name:11s}: "
            f"max|rgb| {e_rgb:.3e} max|acc| {e_acc:.3e} (tol {TOL:.0e}; ref "
            f"rgb std {float(ref[:, :3].std()):.3f}) | {witness}", flush=True)
      if not (e_rgb <= TOL and e_acc <= TOL):
        raise RuntimeError(f"K1 disagrees with its reference: {e_rgb}, "
                           f"{e_acc}")
      max_k1 = max(max_k1, e_rgb, e_acc)
    max_bwd = max(max_bwd, _check_bwd(
        f"{wname:9s} sky {sky:5s} {kind:6s}", k1, w, rays, gen,
        dict(kw, ts=ts)))

  # a ragged batch: 16 steps = 4 rays per kernel block, 4093 rays
  rays_r = torch.from_numpy(_check_rays(4093, 1)).to(dev)
  ts = rays_ops.compute_ts(2.0, 6.0, 16, perturb=1.0, generator=gen,
                           device=dev)
  kw = dict(steps=16, t_near=2.0, t_far=6.0, sigmoid_kind="thin",
            sky_kind="white", ts=ts)
  max_bwd = max(max_bwd, _check_bwd("ragged 4093 rays x 16 steps", k1,
                                    ws_amp, rays_r, gen, kw))

  # the autograd Function's backward is K2
  g = torch.randn(4093, 4, device=dev, generator=gen)
  leaf = ws.clone().requires_grad_(True)
  out = k1.plain_cp_render_train(leaf, rays_r, ts, steps=16,
                                 sky_kind="white")
  (out * g).sum().backward()
  direct = k1.plain_cp_render_grad(ws, rays_r, g, steps=16, ts=ts,
                                   sky_kind="white")
  if not torch.equal(leaf.grad, direct):
    raise RuntimeError("PlainCPRender's gradient differs from K2's")
  print("[check] PlainCPRender backward == K2 (bitwise)", flush=True)
  return max_k1, max_bwd


def _hash_points(k1, dev):
  """The check rays' 4096 x 64 sample points on the uniform grid, points
  on the bbox's faces and corners, and points far outside it."""
  rays = torch.from_numpy(_check_rays(N_CHECK, 2)).to(dev)
  pts = k1.hash_pts(rays, torch.linspace(2.0, 6.0, STEPS, device=dev))
  rng = np.random.default_rng(3)
  face = rng.uniform(-1.0, 1.0, (4096, 3))
  i = np.arange(4096)
  face[i, i % 3] = np.where(i % 2, 1.0, -1.0)
  corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                      for z in (-1, 1)], np.float64)
  far = rng.uniform(-50.0, 50.0, (1024, 3))
  extra = torch.from_numpy(np.concatenate([face, corners, far]).astype(
      np.float32)).to(dev)
  return torch.cat([pts, extra]).contiguous()


def _check_hash_encoder(hk, k1, testing, dev):
  """Phase 3, K5f against its plain version bit for bit at T = 2^19, 2^14
  and 2 (seeded and amplified tables; two launches the same bits), with
  the share of corner pairs its 16-byte loads join; K5b against its plain
  version at T = 2^19 and 2^14. Returns (K5f max |Δ|, K5b max |Δ|)."""
  pts = _hash_points(k1, dev)
  gen = torch.Generator().manual_seed(4)
  g = torch.randn(pts.shape[0], 16, generator=gen).to(dev)
  max_f, max_b = 0.0, 0.0
  for size in (HASH_T, HASH_TRAIN_T, 2):
    for name, scale in (("seeded", 1e-4), ("amplified", 1.0)):
      table = ((torch.rand(8 * size, 2, generator=gen) * 2 - 1) * scale).to(dev)
      out = hk.hash_encode(table, pts)
      again = hk.hash_encode(table, pts)
      ref = hk.hash_encode_reference(table, pts)
      torch.cuda.synchronize()
      err = float((out - ref).abs().max())
      bitwise, repeat = torch.equal(out, ref), torch.equal(out, again)
      print(f"[check] K5f T=2^{size.bit_length() - 1} {name:9s} "
            f"{pts.shape[0]} points: max|Δ| {err:.3e} (tol {HASH_TOL:.0e}; "
            f"bitwise {bitwise}; two launches bit for bit {repeat})",
            flush=True)
      if not (err <= HASH_TOL and bitwise and repeat
              and bool(torch.isfinite(out).all())):
        raise RuntimeError(f"K5f disagrees with its plain version: {err}, "
                           f"bitwise {bitwise}, repeat {repeat}")
      max_f = max(max_f, err)
    shares = testing.k5f_joined_share(pts, size)
    print(f"[check] K5f T=2^{size.bit_length() - 1}: corner pairs joined "
          f"into one 16-byte load, per level "
          f"{' '.join(f'{v:.3f}' for v in shares)}", flush=True)
    if size == 2:
      continue
    got = hk.hash_encode_table_grad(pts, g, size)
    ref = hk.hash_encode_table_grad_reference(pts, g, size)
    torch.cuda.synchronize()
    errs = [float((got[sl] - ref[sl]).norm() / ref[sl].norm())
            for sl in (slice(l * size, (l + 1) * size) for l in range(8))]
    err_abs = float((got - ref).abs().max())
    print(f"[check] K5b T=2^{size.bit_length() - 1}: per-level ‖Δ‖/‖ref‖ "
          f"max {max(errs):.2e} (tol {HASH_GRAD_RTOL:.0e}), max|Δ| "
          f"{err_abs:.3e}", flush=True)
    if not max(errs) <= HASH_GRAD_RTOL:
      raise RuntimeError(f"K5b disagrees with its plain version: {errs}")
    max_b = max(max_b, err_abs)
    _check_hash_bits(hk, pts, g, size, got)
  return max_f, max_b


def _check_hash_bits(hk, pts, g, size, got):
  """K5b's order-free sum: a second launch, the points in a permuted
  order (another grid of blocks over other point runs), and the fixed
  point against the float64 sum of the same float32 products (each row
  off by at most half an ulp of its float32 result plus n·m·P·2^-61, n
  its contributions, m the column's max |dfeat|, P the points: the bound
  hash_encode.cu states)."""
  tag = f"T=2^{size.bit_length() - 1}"
  again = hk.hash_encode_table_grad(pts, g, size)
  perm = torch.from_numpy(np.random.default_rng(size).permutation(
      pts.shape[0])).to(pts.device)
  permuted = hk.hash_encode_table_grad(pts[perm].contiguous(),
                                       g[perm].contiguous(), size)
  torch.cuda.synchronize()
  same = (torch.equal(got, again), torch.equal(got, permuted))
  ref64 = torch.zeros(8 * size, 2, dtype=torch.float64, device=pts.device)
  count = torch.zeros(8 * size, dtype=torch.float64, device=pts.device)
  for li, _, idx, w in hk._corners(pts, size):
    ref64.index_add_(0, idx, (w[:, None] * g[:, 2 * li:2 * li + 2]).double())
    count.index_add_(0, idx, torch.ones_like(w, dtype=torch.float64))
  m = g.abs().amax(dim=0).double().view(8, 1, 2)
  step = (m * pts.shape[0] * 2.0 ** -61).expand(8, size, 2).reshape(-1, 2)
  ulp = (torch.nextafter(got.abs(), torch.full_like(got, math.inf))
         - got.abs()).double()
  err = (got.double() - ref64).abs()
  bound = 0.5 * ulp + count[:, None] * step + ref64.abs() * 2.0 ** -52
  worst = float((err / bound).max())
  print(f"[check] K5b {tag}: bit for bit across two launches {same[0]}, "
        f"across a permutation of the {pts.shape[0]} points {same[1]}; "
        f"fixed point vs the float64 sum of the same products: max|Δ| "
        f"{float(err.max()):.3e}, at most {worst:.3f} of its bound (half "
        f"an ulp + n·m·P·2^-61; the fixed-point part ≤ "
        f"{float((count[:, None] * step).max()):.3e})", flush=True)
  if not (all(same) and worst <= 1.0):
    raise RuntimeError(f"K5b is not order-free or exceeds its bound: {same}, "
                       f"{worst}")


def _check_hash_render(k1, hk, rays_ops, models, driver, dev):
  """Phase 3, K1/K2/K3 in hash mode at T = 2^19 against their plain
  versions, the chained table gradient, a ragged batch and
  PlainHashRender. Returns (K1-hash max |Δ|, K2/K3-hash max |Δ|)."""
  model = driver.init_model(models.PlainNeRF(steps=STEPS, enc_kind="hash",
                                             device=dev), seed=0)
  seeded = model.state_dict()
  amplified = dict(seeded)
  amplified["refl.mlp.layer_out.weight"] = (
      amplified["refl.mlp.layer_out.weight"] * 40.0)
  amplified["density_mlp.layer_out.weight"] = (
      amplified["density_mlp.layer_out.weight"] * 8.0)
  amplified[k1.HASH_TABLE_KEY] = amplified[k1.HASH_TABLE_KEY] * 1e4
  rays = torch.from_numpy(_check_rays(N_CHECK, 0)).to(dev)
  gen = torch.Generator(device=dev).manual_seed(5)
  max_k1, max_bwd = 0.0, 0.0
  for wname, sky, kind in (("seeded", "black", "thin"),
                           ("amplified", "white", "normal"),
                           ("amplified", "black", "tanh")):
    sd = seeded if wname == "seeded" else amplified
    ws, table = k1.pack_weights(sd, dev, "hash"), k1.hash_table(sd)
    kw = dict(steps=STEPS, t_near=2.0, t_far=6.0, sigmoid_kind=kind,
              sky_kind=sky)
    ts = rays_ops.compute_ts(2.0, 6.0, STEPS, perturb=1.0, generator=gen,
                             device=dev)
    for name, t in (("grid", None), ("jittered ts", ts)):
      grid = k1.sample_grid(STEPS, 2.0, 6.0, rays.device, t)[0]
      feats = hk.hash_encode(table, k1.hash_pts(rays, grid))
      out = k1.plain_hash_render(ws, rays, feats, ts=t, **kw)
      ref = k1.plain_hash_render_reference(ws, rays, feats, ts=t, **kw)
      torch.cuda.synchronize()
      e = float((out - ref).abs().max())
      print(f"[check] K1-hash {wname:9s} sky {sky:5s} {kind:6s} {name:11s}: "
            f"max|Δ| {e:.3e} (tol {TOL:.0e}; ref rgb std "
            f"{float(ref[:, :3].std()):.3f})", flush=True)
      if not (e <= TOL and bool(torch.isfinite(out).all())):
        raise RuntimeError(f"K1-hash disagrees with its reference: {e}")
      max_k1 = max(max_k1, e)
    max_bwd = max(max_bwd, _check_bwd(f"{wname:9s} sky {sky:5s} {kind:6s}",
                                      k1, ws, rays, gen, dict(kw, ts=ts),
                                      feats=feats))
    # the chained table gradient, on the kink-free rays' cotangent
    from nerf_atlas_tpu_torch import testing
    keep = testing.kink_free_rays(ws, rays, ts, STEPS, KINK_MARGIN,
                                  feats=feats)
    target = torch.where(keep[:, None],
                         torch.rand(N_CHECK, 3, device=dev, generator=gen),
                         ref[:, :3]).contiguous()
    _, _, dtable = k1.fused_plain_hash_train_step(ws, table, rays, target, ts,
                                                  **kw)
    leaf = table.clone().requires_grad_(True)
    out = k1.plain_hash_render_reference(
        ws, rays, hk.hash_encode_reference(leaf, k1.hash_pts(rays, ts)),
        ts=ts, **kw)
    torch.mean((out[:, :3] - target) ** 2).backward()
    e = float((dtable - leaf.grad).norm() / leaf.grad.norm())
    print(f"[check] K3-hash -> K5b table gradient {wname:9s}: ‖Δ‖/‖ref‖ "
          f"{e:.2e} (tol {GRAD_RTOL:.0e})", flush=True)
    if not e <= GRAD_RTOL:
      raise RuntimeError(f"chained table gradient {e} from autograd")

  # a ragged batch: 16 steps = 4 rays per kernel block, 4093 rays
  ws = k1.pack_weights(amplified, dev, "hash")
  rays_r = torch.from_numpy(_check_rays(4093, 1)).to(dev)
  ts = rays_ops.compute_ts(2.0, 6.0, 16, perturb=1.0, generator=gen,
                           device=dev)
  feats = hk.hash_encode(k1.hash_table(amplified), k1.hash_pts(rays_r, ts))
  kw = dict(steps=16, t_near=2.0, t_far=6.0, sigmoid_kind="thin",
            sky_kind="white", ts=ts)
  max_bwd = max(max_bwd, _check_bwd("ragged 4093 rays x 16 steps", k1, ws,
                                    rays_r, gen, kw, feats=feats))
  g = torch.randn(4093, 4, device=dev, generator=gen)
  leaf, fl = ws.clone().requires_grad_(True), feats.clone().requires_grad_(True)
  out = k1.PlainHashRender.apply(leaf, fl, rays_r, ts, 16, 2.0, 6.0, "thin",
                                 "white")
  (out * g).sum().backward()
  dws, dfeat = k1.plain_hash_render_grad(ws, rays_r, feats, g, **kw)
  if not (torch.equal(leaf.grad, dws) and torch.equal(fl.grad, dfeat)):
    raise RuntimeError("PlainHashRender's gradient differs from K2-hash's")
  print("[check] PlainHashRender backward == K2-hash (bitwise)", flush=True)
  return max_k1, max_bwd


def _ae_weights(models, driver, k7, dev, steps=STEPS):
  """(seeded, amplified) packed NeRFAE weights: the amplified ones scale
  the View's output layer by 40 and density_tfm's by 8, so that rgb
  spans (0, 1) and density varies along the rays."""
  sd = driver.init_model(models.NeRFAE(steps=steps, device=dev),
                         seed=0).state_dict()
  amp = dict(sd)
  amp["refl.mlp.layer_out.weight"] = amp["refl.mlp.layer_out.weight"] * 40.0
  amp["density_tfm.layer_out.weight"] = (
      amp["density_tfm.layer_out.weight"] * 8.0)
  return k7.pack_weights_ae(sd, dev), k7.pack_weights_ae(amp, dev)


def _check_ae_bwd(what, k7, testing, ws, rays, gen, kw):
  """K7b in modes G (random g) and L (random target) against autograd
  through the plain K7f, over all rays and over the kink-free rays (see
  GRAD_RTOL). The kink-free check also holds the kernel to the same
  gradient in float64 (`testing.ae_float64_grad`), tensor by tensor, as
  K9b's (`testing.float64_witness_ratio` with the floor GRAD_RTOL / 2),
  and prints the worst ratio. Returns the max |Δ| of the kink-free
  gradients."""
  n = rays.shape[0]
  keep = testing.ae_kink_free_rays(ws, rays, kw["ts"], kw["steps"],
                                   KINK_MARGIN)
  g = torch.randn(n, 4, device=rays.device, generator=gen)
  target = torch.rand(n, 3, device=rays.device, generator=gen)
  out = k7.ae_render_reference(ws, rays, **kw)[:, :3]
  step_kw = {k: v for k, v in kw.items() if k != "ts"}
  max_abs = 0.0
  for mode, arg, masked in (
      ("G", g, g * keep[:, None]),
      ("L", target, torch.where(keep[:, None], target, out).contiguous())):
    line = []
    for name, a in (("all rays", arg), ("kink-free", masked)):
      if mode == "G":
        got = k7.fused_ae_render_grad(ws, rays, a, **kw)
        ref = k7.ae_render_grad_reference(ws, rays, a, **kw)
      else:
        (loss, got) = k7.fused_ae_train_step(ws, rays, a, kw["ts"], **step_kw)
        (loss_r, ref) = k7.ae_train_step_reference(ws, rays, a, **kw)
        loss_rel = abs(float(loss) - float(loss_r)) / abs(float(loss_r))
        if not loss_rel <= LOSS_RTOL:
          raise RuntimeError(f"{what} K7b-L loss {float(loss)} vs plain "
                             f"{float(loss_r)}")
        line.append(f"{name} loss rel {loss_rel:.2e}")
      torch.cuda.synchronize()
      ug, ur = k7.unpack_grads_ae(got), k7.unpack_grads_ae(ref)
      errs = {k: float((ug[k] - ur[k]).norm() / ur[k].norm()) for k in ur}
      key = max(errs, key=errs.get)
      tol = ALL_RAY_RTOL if name == "all rays" else GRAD_RTOL
      if not (errs[key] <= tol and bool(torch.isfinite(got).all())):
        raise RuntimeError(f"{what} K7b-{mode} ({name}): gradient of {key} "
                           f"{errs[key]:.3e} from its plain version (tol "
                           f"{tol})")
      line.append(f"{name}: max_t ‖Δ‖/‖ref‖ {errs[key]:.2e} ({key})")
      if name == "kink-free":
        max_abs = max(max_abs, float((got - ref).abs().max()))
        w64 = testing.ae_float64_grad(
            ws, rays, kw["ts"], a, loss_mode=mode == "L",
            sigmoid_kind=kw.get("sigmoid_kind", "thin"),
            sky_kind=kw.get("sky_kind", "black"))
        ratio, k, ek, ep = testing.float64_witness_ratio(
            k7.unpack_grads_ae, got, ref, w64, GRAD_RTOL / 2)
        if not ratio <= testing.WITNESS_RATIO:
          raise RuntimeError(
              f"{what} K7b-{mode}: {k} lies {ek:.3e} from the float64 "
              f"gradient, its plain version {ep:.3e} (ratio {ratio:.2f} "
              f"with the floor {GRAD_RTOL / 2}; limit "
              f"{testing.WITNESS_RATIO})")
        line.append(f"float64 witness: worst ratio {ratio:.2f} ({k}: "
                    f"kernel {ek:.2e}, plain {ep:.2e})")
    print(f"[check] K7b-{mode} {what}: {' | '.join(line)} | kink-free rays "
          f"{int(keep.sum())}/{n}", flush=True)
  return max_abs


def _check_ae(k7, testing, rays_ops, models, driver, dev):
  """Phase 3, NeRFAE: K7f (each line with its float64 witness) and K7b
  against their plain versions, AERender against mode G, and K7f's and
  K7b's determinism. Returns (K7f max |Δ|, K7b max |Δ|)."""
  seeded, amplified = _ae_weights(models, driver, k7, dev)
  gen = torch.Generator(device=dev).manual_seed(6)
  max_f, max_b = 0.0, 0.0
  for steps, n in ((STEPS, 1001), (16, 77)):
    rays = torch.from_numpy(_check_rays(n, steps)).to(dev)
    ts = rays_ops.compute_ts(2.0, 6.0, steps, perturb=1.0, generator=gen,
                             device=dev)
    for (wname, ws), sky, kind in (
        (("seeded", seeded), "black", "thin"),
        (("amplified", amplified), "black", "thin"),
        (("amplified", amplified), "white", "normal")):
      for tname, t in (("grid", None), ("jittered ts", ts)):
        kw = dict(steps=steps, sigmoid_kind=kind, sky_kind=sky, ts=t)
        out = k7.fused_ae_render(ws, rays, **kw)
        ref = k7.ae_render_reference(ws, rays, **kw)
        torch.cuda.synchronize()
        e = float((out - ref).abs().max())
        witness = _witness(testing, "K7f", out, ref,
                           testing.ae_float64_render(ws, rays, **kw))
        print(f"[check] K7f {n} rays x {steps} {wname:9s} sky {sky:5s} "
              f"{kind:6s} {tname:11s}: max|Δ| {e:.3e} (tol {TOL:.0e}; ref "
              f"rgb std {float(ref[:, :3].std()):.3f}) | {witness}",
              flush=True)
        if not (e <= TOL and bool(torch.isfinite(out).all())):
          raise RuntimeError(f"K7f disagrees with its reference: {e}")
        max_f = max(max_f, e)
    # two launches bit for bit (the last line's inputs)
    if not torch.equal(out, k7.fused_ae_render(ws, rays, **kw)):
      raise RuntimeError(f"two K7f launches differ ({n} rays x {steps})")
    print(f"[check] K7f {n} rays x {steps}: two launches bitwise equal",
          flush=True)
  rays = torch.from_numpy(_check_rays(N_CHECK, 0)).to(dev)
  for sky, kind in (("white", "thin"), ("black", "normal")):
    ts = rays_ops.compute_ts(2.0, 6.0, STEPS, perturb=1.0, generator=gen,
                             device=dev)
    max_b = max(max_b, _check_ae_bwd(
        f"{N_CHECK} rays x {STEPS} sky {sky:5s} {kind:6s}", k7, testing,
        amplified, rays, gen, dict(steps=STEPS, sigmoid_kind=kind,
                                   sky_kind=sky, ts=ts)))
  rays_r = torch.from_numpy(_check_rays(77, 1)).to(dev)
  ts = rays_ops.compute_ts(2.0, 6.0, 16, perturb=1.0, generator=gen,
                           device=dev)
  kw = dict(steps=16, sigmoid_kind="thin", sky_kind="white", ts=ts)
  max_b = max(max_b, _check_ae_bwd("ragged 77 rays x 16", k7, testing,
                                   amplified, rays_r, gen, kw))
  g = torch.randn(77, 4, device=dev, generator=gen)
  leaf = amplified.clone().requires_grad_(True)
  (k7.fused_ae_render_train(leaf, rays_r, ts, steps=16, sky_kind="white")
   * g).sum().backward()
  direct = k7.fused_ae_render_grad(amplified, rays_r, g, **kw)
  again = k7.fused_ae_render_grad(amplified, rays_r, g, **kw)
  if not (torch.equal(leaf.grad, direct) and torch.equal(direct, again)):
    raise RuntimeError("AERender's gradient differs from K7b-G's, or two "
                       "K7b launches differ")
  print("[check] AERender backward == K7b-G (bitwise); two K7b launches "
        "bitwise equal", flush=True)
  return max_f, max_b


def _k4_model(models, mode, dev, **kw):
  """The model of a K4 mode at full width."""
  if mode == "tiny":
    return models.TinyNeRF(steps=STEPS, device=dev, **kw)
  if mode in ("cone", "cylinder"):
    return models.PlainNeRF(steps=STEPS, mip=mode, device=dev, **kw)
  return models.PlainNeRF(steps=STEPS, enc_kind=mode, device=dev, **kw)


def _k4_amplified(sd, mode):
  """The output layers scaled so that rgb spans (0, 1) and density varies
  along the rays: rgb ×40, density ×8 (tiny: the rows of its one
  layer_out)."""
  amp = dict(sd)
  if mode == "tiny":
    w = amp["mlp.layer_out.weight"]
    amp["mlp.layer_out.weight"] = torch.cat([w[:1] * 8.0, w[1:] * 40.0])
  else:
    amp["refl.mlp.layer_out.weight"] = amp["refl.mlp.layer_out.weight"] * 40.0
    amp["density_mlp.layer_out.weight"] = (
        amp["density_mlp.layer_out.weight"] * 8.0)
  return amp


def _check_k4(k1, testing, rays_ops, models, driver, dev):
  """Phase 3, the K4 modes: K1, K2 and K3 in each of posenc, tiny, cone
  and cylinder against their plain versions (K2/K3 over all rays and the
  kink-free ones), a ragged batch, PlainCPRender against K2, and two
  launches of K2 and of K3 bit for bit. Returns {mode: (K1 max |Δ|,
  K2/K3 max |Δ|)}."""
  rays = torch.from_numpy(_check_rays(N_CHECK, 0)).to(dev)
  rays_r = torch.from_numpy(_check_rays(4093, 1)).to(dev)
  out = {}
  for i, mode in enumerate(K4_MODES):
    sd = driver.init_model(_k4_model(models, mode, dev), seed=0).state_dict()
    seeded = k1.pack_weights(sd, dev, mode)
    amplified = k1.pack_weights(_k4_amplified(sd, mode), dev, mode)
    gen = torch.Generator(device=dev).manual_seed(10 + i)
    max_k1, max_bwd = 0.0, 0.0
    for wname, sky, kind in (("seeded", "black", "thin"),
                             ("amplified", "white", "normal"),
                             ("amplified", "black", "tanh")):
      ws = seeded if wname == "seeded" else amplified
      kw = dict(steps=STEPS, t_near=2.0, t_far=6.0, sigmoid_kind=kind,
                sky_kind=sky, enc_kind=mode)
      ts = rays_ops.compute_ts(2.0, 6.0, STEPS, perturb=1.0, generator=gen,
                               device=dev)
      for name, t in (("grid", None), ("jittered ts", ts)):
        got = k1.plain_cp_render(ws, rays, ts=t, **kw)
        ref = k1.plain_cp_render_reference(ws, rays, ts=t, **kw)
        torch.cuda.synchronize()
        e = float((got - ref).abs().max())
        witness = _witness(testing, f"K1-{mode}", got, ref,
                           testing.k1_float64_render(ws, rays, ts=t, **kw))
        print(f"[check] K1-{mode} {wname:9s} sky {sky:5s} {kind:6s} "
              f"{name:11s}: max|Δ| {e:.3e} (tol {TOL:.0e}; ref rgb std "
              f"{float(ref[:, :3].std()):.3f}) | {witness}", flush=True)
        if not (e <= TOL and bool(torch.isfinite(got).all())):
          raise RuntimeError(f"K1-{mode} disagrees with its reference: {e}")
        max_k1 = max(max_k1, e)
      max_bwd = max(max_bwd, _check_bwd(
          f"{wname:9s} sky {sky:5s} {kind:6s}", k1, ws, rays, gen,
          dict(kw, ts=ts)))
    # a ragged batch: 16 steps = 4 rays per kernel block, 4093 rays
    ts = rays_ops.compute_ts(2.0, 6.0, 16, perturb=1.0, generator=gen,
                             device=dev)
    kw = dict(steps=16, t_near=2.0, t_far=6.0, sigmoid_kind="thin",
              sky_kind="white", ts=ts, enc_kind=mode)
    max_bwd = max(max_bwd, _check_bwd("ragged 4093 rays x 16 steps", k1,
                                      amplified, rays_r, gen, kw))
    g = torch.randn(rays_r.shape[0], 4, device=dev, generator=gen)
    target = torch.rand(rays_r.shape[0], 3, device=dev, generator=gen)
    leaf = amplified.clone().requires_grad_(True)
    (k1.plain_cp_render_train(leaf, rays_r, ts, steps=16, sky_kind="white",
                              enc_kind=mode) * g).sum().backward()
    direct = k1.plain_cp_render_grad(amplified, rays_r, g, **kw)
    again = k1.plain_cp_render_grad(amplified, rays_r, g, **kw)
    step1 = k1.plain_cp_train_step(amplified, rays_r, target, **kw)
    step2 = k1.plain_cp_train_step(amplified, rays_r, target, **kw)
    if not (torch.equal(leaf.grad, direct) and torch.equal(direct, again)
            and all(torch.equal(a, b) for a, b in zip(step1, step2))):
      raise RuntimeError(f"PlainCPRender-{mode}'s gradient differs from "
                         "K2's, or two K2 or K3 launches differ")
    print(f"[check] PlainCPRender-{mode} backward == K2-{mode} (bitwise); "
          f"two K2-{mode} and two K3-{mode} launches bitwise equal",
          flush=True)
    out[mode] = (max_k1, max_bwd)
  return out


def _render_main(port_runner, *extra):
  """Phases 4 / 4b / 4c: the port's runner renders and scores 800x800, 2
  views x 2 splits, seeded random weights; returns (results, wall s,
  launches per kernel)."""
  with tempfile.TemporaryDirectory() as outdir:
    argv = ["--data-kind", "synthetic", "--size", str(SIZE), "--num-views",
            "2", "--epochs", "0", "--outdir", outdir, *extra]
    (results, secs), counts = _counted(
        lambda: _sync_time(lambda: port_runner.main(argv)))
    for split in ("train", "test"):
      if not os.path.exists(os.path.join(outdir, split, "results.txt")):
        raise RuntimeError(f"no {split}/results.txt")
      if not all(math.isfinite(p) for p in results[split]["psnrs"]):
        raise RuntimeError(f"{split} PSNR not finite: {results[split]}")
  return results, secs, counts


def _module_forwards(models, fn):
  """(fn(), calls of any model class's forward during it): a render that
  takes the kernel gate calls none."""
  calls = [0]
  saved = {cls: cls.forward for cls in set(models.MODEL_KINDS.values())
           | set(models.DYN_MODEL_KINDS.values())}

  def counting(forward):
    def wrapped(self, *a, **kw):
      calls[0] += 1
      return forward(self, *a, **kw)
    return wrapped

  for cls, forward in saved.items():
    cls.forward = counting(forward)
  try:
    out = fn()
  finally:
    for cls, forward in saved.items():
      cls.forward = forward
  return out, calls[0]


def _render_main_k4(port_runner, models, tag, *extra, kernel="K1",
                    every=False):
  """Phases 4d-4g: the runner's 800x800 render of a K4 family (VolSDF)
  must launch K1 in its mode (K8f) and nothing else, and run no module
  forward. Returns the launches (`every`: those of every kernel)."""
  (results, secs, counts), forwards = _module_forwards(
      models, lambda: _render_main(port_runner, *extra))
  others = {k: v for k, v in counts.items() if k != kernel and v}
  if counts[kernel] <= 0 or others or forwards:
    raise RuntimeError(f"the {tag} render launched {counts} and ran "
                       f"{forwards} module forwards")
  name = f"K1-{tag}" if kernel == "K1" else kernel
  print(f"[main] runner {tag} {SIZE}x{SIZE}x{STEPS}, 2 views x 2 splits: "
        f"{secs:.2f} s end to end (incl. ground-truth render + PNGs), "
        f"{2 * 2 * SIZE * SIZE / secs:,.0f} rays/s | {name} launches "
        f"{counts[kernel]}, other kernels 0, module forwards {forwards} | "
        f"PSNR train {results['train']['psnr_mean']:.3f} test "
        f"{results['test']['psnr_mean']:.3f}", flush=True)
  return counts if every else counts[kernel]


def _black_psnr(pixels) -> float:
  """Mean over views of the PSNR of an all-black render."""
  mse = (pixels[..., :3] ** 2).mean(dim=(1, 2, 3)).clamp_min(1e-10)
  return float((-10 * torch.log10(mse)).mean())


def _wrappers():
  """{name: wrapper} of every kernel wrapper that counts its launches."""
  from nerf_atlas_tpu_torch.ops.kernels import hash_encode as hk
  from nerf_atlas_tpu_torch.ops.kernels import render as k1
  from nerf_atlas_tpu_torch.ops.kernels import render_ae as k7
  from nerf_atlas_tpu_torch.ops.kernels import render_dyn as k9
  from nerf_atlas_tpu_torch.ops.kernels import render_volsdf as k8
  return {"K1": k1.plain_cp_render, "K2": k1.plain_cp_render_grad,
          "K9f-dp": k9.fused_dyn_render.dp,
          "K3": k1.plain_cp_train_step, "K1-hash": k1.plain_hash_render,
          "K2-hash": k1.plain_hash_render_grad,
          "K3-hash": k1.plain_hash_train_step, "K5f": hk.hash_encode,
          "K5b": hk.hash_encode_table_grad, "K7f": k7.fused_ae_render,
          "K7b-G": k7.fused_ae_render_grad, "K7b": k7.fused_ae_train_step,
          "K8f": k8.fused_volsdf_render,
          "K8f-eik": k8.fused_volsdf_render.eikonal,
          "K8b-G": k8.fused_volsdf_render_grad,
          "K8b": k8.fused_volsdf_train_step, "K9f": k9.fused_dyn_render,
          "K9b-G": k9.fused_dyn_render_grad, "K9b": k9.fused_dyn_train_step}


def _counted(fn):
  """(fn(), {kernel: launches in that call}), every count set to 0
  just before and read just after."""
  for w in _wrappers().values():
    w.launches = 0
  out = fn()
  return out, {name: w.launches for name, w in _wrappers().items()}


def _train_run(port_runner, k1, loaders, dev, steps: int, extra=(),
               argv=TRAIN_ARGV, outputs=()):
  """Run the port's runner on a sweep recipe; returns (results, wall s,
  launches per kernel, black PSNR per split). Each path of `outputs`
  (relative to the run's output directory) must have been written."""
  with tempfile.TemporaryDirectory() as outdir:
    argv = argv + ["--epochs", str(steps), "--outdir", outdir, *extra]
    (results, secs), counts = _counted(
        lambda: _sync_time(lambda: port_runner.main(argv)))
    with open(os.path.join(outdir, "log.json")) as f:
      logged = json.load(f)["engaged_path"]
    missing = [o for o in outputs
               if not os.path.exists(os.path.join(outdir, o))]
    if missing:
      raise RuntimeError(f"the run wrote no {missing}")
  if logged != results["engaged_path"]:
    raise RuntimeError(f"log.json says {logged}, the run "
                       f"{results['engaged_path']}")
  black = {}
  kind = argv[argv.index("--data-kind") + 1]
  for split, training in (("train", True), ("test", False)):
    px = loaders.load("", data_kind=kind, training=training, size=48,
                      num_views=30, device=dev).labels
    if isinstance(px, tuple):                    # dynamic: (imgs, times)
      px = px[0]
    black[split] = _black_psnr(torch.as_tensor(px))
  return results, secs, counts, black


def _check_trained(results, black, path="fused-one-kernel"):
  losses = [h["loss"] for h in results["history"]]
  if results["engaged_path"] != path:
    raise RuntimeError(f"engaged {results['engaged_path']}, not {path}")
  if not (all(math.isfinite(v) for v in losses)
          and losses[-1] < 0.5 * losses[0]):
    raise RuntimeError(f"loss not finite and falling: {losses}")
  for split in ("train", "test"):
    if not results[split]["psnr_mean"] >= black[split] + 2.0:
      raise RuntimeError(f"{split} PSNR {results[split]['psnr_mean']} does "
                         f"not beat all-black {black[split]} by 2 dB")
  return losses


def _train_main(port_runner, k1, loaders, dev):
  """Phase 5: the training main path. Returns the K3 launches."""
  results, secs, counts, black = _train_run(port_runner, k1, loaders, dev,
                                            TRAIN_STEPS)
  k3_n, k1_n = counts["K3"], counts["K1"]
  losses = _check_trained(results, black)
  if k3_n != TRAIN_STEPS:
    raise RuntimeError(f"K3 launched {k3_n} times in {TRAIN_STEPS} steps")
  if k1_n <= 0:
    raise RuntimeError("the trained model's eval never launched K1")
  print(f"[train] runner {TRAIN_STEPS} steps x {BATCH} rays x {STEPS} "
        f"samples (48x48, 30 views): {secs:.2f} s end to end | path "
        f"{results['engaged_path']} | K3 launches {k3_n}, K1 launches "
        f"{k1_n} | loss {losses[0]:.5f} -> {losses[-1]:.5f} | PSNR train "
        f"{results['train']['psnr_mean']:.3f} test "
        f"{results['test']['psnr_mean']:.3f} (all-black "
        f"{black['train']:.3f} / {black['test']:.3f})", flush=True)
  return k3_n


def _train_main_hash(port_runner, k1, loaders, dev):
  """Phase 5b: the hash training main path at the plain_hash recipe.
  Returns the launches per kernel."""
  results, secs, counts, black = _train_run(port_runner, k1, loaders, dev,
                                            TRAIN_STEPS,
                                            argv=HASH_TRAIN_ARGV)
  losses = _check_trained(results, black)
  # K5f also runs once per eval chunk, as K1-hash does
  want = {"K3-hash": TRAIN_STEPS, "K5b": TRAIN_STEPS,
          "K5f": TRAIN_STEPS + counts["K1-hash"]}
  if any(counts[k] != v for k, v in want.items()) or counts["K1-hash"] <= 0:
    raise RuntimeError(f"hash training launched {counts}, expected {want} "
                       "and K1-hash in eval")
  print(f"[train] runner hash T=2^14 {TRAIN_STEPS} steps x {BATCH} rays x "
        f"{STEPS} samples (48x48, 30 views): {secs:.2f} s end to end | path "
        f"{results['engaged_path']} | launches K5f {counts['K5f']}, K3-hash "
        f"{counts['K3-hash']}, K5b {counts['K5b']}, K1-hash "
        f"{counts['K1-hash']} | loss {losses[0]:.5f} -> {losses[-1]:.5f} | "
        f"PSNR train {results['train']['psnr_mean']:.3f} test "
        f"{results['test']['psnr_mean']:.3f} (all-black "
        f"{black['train']:.3f} / {black['test']:.3f})", flush=True)
  return counts


def _hash_repeat(port_runner):
  """Phase 5b, the repeat: two HASH_REPEAT_STEPS-step hash trains from one
  seed (the plain_hash recipe, no eval) must give the same loss curve and
  the same parameters bit for bit: K5b's sums are order-free."""
  argv = [a for a in HASH_TRAIN_ARGV if a != "--nosave"]
  runs = []
  for _ in range(2):
    with tempfile.TemporaryDirectory() as outdir:
      extra = ["--epochs", str(HASH_REPEAT_STEPS), "--notest",
               "--notraintest", "--save-freq", str(HASH_REPEAT_STEPS),
               "--outdir", outdir]
      (results, secs), counts = _counted(
          lambda: _sync_time(lambda: port_runner.main(argv + extra)))
      params = torch.load(os.path.join(outdir, "model.ckpt"),
                          map_location="cpu", weights_only=True)["params"]
    runs.append(([h["loss"] for h in results["history"]], params, counts,
                 secs))
  (loss_a, par_a, counts, secs), (loss_b, par_b, _, _) = runs
  same_loss = loss_a == loss_b
  same_params = (par_a.keys() == par_b.keys()
                 and all(torch.equal(par_a[k], par_b[k]) for k in par_a))
  print(f"[train] hash T=2^14 repeat, two {HASH_REPEAT_STEPS}-step runs from "
        f"seed 0: loss curves equal {same_loss} (last {loss_a[-1]!r} / "
        f"{loss_b[-1]!r}), all {len(par_a)} parameter tensors bit for bit "
        f"{same_params} | K5b launches {counts['K5b']} per run, {secs:.2f} s",
        flush=True)
  if not (same_loss and same_params and counts["K5b"] == HASH_REPEAT_STEPS):
    raise RuntimeError("two hash trains from one seed differ")


def _train_main_ae(port_runner, k1, loaders, dev):
  """Phase 5c: NeRFAE at the quality sweep's ae recipe. Returns the
  launches per kernel."""
  results, secs, counts, black = _train_run(port_runner, k1, loaders, dev,
                                            TRAIN_STEPS, argv=AE_TRAIN_ARGV)
  losses = _check_trained(results, black)
  others = {k: v for k, v in counts.items() if k not in ("K7b", "K7f") and v}
  if counts["K7b"] != TRAIN_STEPS or counts["K7f"] <= 0 or others:
    raise RuntimeError(f"ae training launched {counts}, expected "
                       f"{TRAIN_STEPS} K7b, K7f in eval and nothing else")
  print(f"[train] runner ae {TRAIN_STEPS} steps x {BATCH} rays x {STEPS} "
        f"samples (48x48, 30 views): {secs:.2f} s end to end | path "
        f"{results['engaged_path']} | launches K7b {counts['K7b']}, K7f "
        f"{counts['K7f']} | loss {losses[0]:.5f} -> {losses[-1]:.5f} | PSNR "
        f"train {results['train']['psnr_mean']:.3f} test "
        f"{results['test']['psnr_mean']:.3f} (all-black "
        f"{black['train']:.3f} / {black['test']:.3f})", flush=True)
  return counts


def _train_main_k4(port_runner, k1, loaders, dev, tag, argv, steps,
                   gate=True):
  """Phases 5d-5f: a K4 family's recipe through the one-kernel step: K3
  in its mode once per step, K1 in eval, nothing else; with `gate` both
  splits 2 dB over all-black (else the PSNR is recorded). Returns the K3
  launches."""
  results, secs, counts, black = _train_run(port_runner, k1, loaders, dev,
                                            steps, argv=argv)
  if gate:
    losses = _check_trained(results, black)
  else:
    losses = [h["loss"] for h in results["history"]]
    if (results["engaged_path"] != "fused-one-kernel"
        or not all(math.isfinite(v) for v in losses)):
      raise RuntimeError(f"{tag}: path {results['engaged_path']}, losses "
                         f"{losses}")
  others = {k: v for k, v in counts.items() if k not in ("K3", "K1") and v}
  if counts["K3"] != steps or counts["K1"] <= 0 or others:
    raise RuntimeError(f"{tag} training launched {counts}, expected {steps} "
                       "K3, K1 in eval and nothing else")
  print(f"[train] runner {tag} {steps} steps x {BATCH} rays x {STEPS} "
        f"samples (48x48, 30 views): {secs:.2f} s end to end | path "
        f"{results['engaged_path']} | launches K3-{tag} {counts['K3']}, "
        f"K1-{tag} {counts['K1']} | loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f} | PSNR train {results['train']['psnr_mean']:.3f} "
        f"test {results['test']['psnr_mean']:.3f} (all-black "
        f"{black['train']:.3f} / {black['test']:.3f})", flush=True)
  return counts["K3"]


def _step_fns(model_cls, driver, ds, dev, names=("K3 step", "K1+K2 step",
                                                 "plain step"),
              reg_coeffs=None, **model_kw):
  """The three train steps at batch 4096 on fresh seeded models: the
  one-kernel step ("K3 step"; K7b for NeRFAE), the two-kernel path
  ("K1+K2 step"; K7f + K7b), plain (module under autograd); and each
  one's optimizer."""
  from nerf_atlas_tpu_torch.train import losses, optim
  out = {}
  for name in names:
    model = driver.init_model(model_cls(steps=STEPS, device=dev, **model_kw),
                              seed=0)
    cfg = driver.TrainConfig(steps=1000, batch_size=BATCH,
                             learning_rate=1e-3, reg_coeffs=reg_coeffs or {},
                             no_fused=name == "plain step")
    opt = optim.load_optimizer(model.parameters(), "adam", 1e-3,
                               total_steps=1000)
    loss_fn = losses.load_loss_fn()
    fused_step = (driver._fused_step_fn(model, cfg, ds)
                  if name.startswith("K3 step") else None)
    fused_train = (driver._fused_train_fn(model, cfg, ds)
                   if name.startswith("K1+K2 step") else None)
    out[name] = (driver.make_train_step(model, ds, loss_fn, opt, cfg,
                                        fused_step, fused_train), opt)
  return out


def _time_training(card, model_cls, driver, loaders, sampler, k1, rays_ops,
                   dev):
  """Phase 6, training half: ms per step, train rays/s, the optimizer
  alone; and one 65536-ray K2 call against its plain version (summed
  over 8192-ray chunks: autograd through the plain K1 at 65536 rays
  would hold ~60 GB of activations). Returns the K3 and plain-K3 ms."""
  ds = sampler.RayDataset.from_bundle(
      loaders.load("", data_kind="synthetic", size=48, num_views=30,
                   device=dev), size=48, device=dev)
  fns = _step_fns(model_cls, driver, ds, dev)
  gen = torch.Generator(device=dev).manual_seed(1)
  ms = {}
  for name in ("K3 step", "K1+K2 step", "plain step", "plain step",
               "K1+K2 step", "K3 step"):
    step, _ = fns[name]
    ms.setdefault(name, []).append(_event_ms(lambda: step(0, gen), 5))
  opt = fns["K3 step"][1]
  opt_ms = _event_ms(opt.step, 20)
  for name, v in ms.items():
    print(f"[time] {card}: {name} at {BATCH}x{STEPS}: {v[0]:.2f} / "
          f"{v[1]:.2f} ms = {BATCH / (min(v) / 1e3):,.0f} train rays/s",
          flush=True)
  print(f"[time] {card}: optimizer step alone (Adam + cosine, 467,620 "
        f"weights): {opt_ms:.3f} ms", flush=True)

  ws = k1.pack_weights(driver.init_model(
      model_cls(steps=STEPS, device=dev), seed=0).state_dict(), dev)
  rays = ds.view_rays(0, 256).contiguous()            # 65536 rays
  ts = rays_ops.compute_ts(2.0, 6.0, STEPS, perturb=1.0, generator=gen,
                           device=dev)
  g = torch.randn(rays.shape[0], 4, device=dev, generator=gen)
  kw = dict(steps=STEPS, ts=ts)

  def plain_k2():
    return sum(k1.plain_cp_render_grad_reference(
        ws, rays[i:i + 8192], g[i:i + 8192], **kw)
               for i in range(0, rays.shape[0], 8192))

  # the plain K2 (~7.8 s a call) takes one turn, before the kernel's two:
  # its second turn went to keep the run inside its time limit
  launches = k1.plain_cp_render_grad.launches
  p1 = _event_ms(plain_k2, 1)
  kk1 = _event_ms(lambda: k1.plain_cp_render_grad(ws, rays, g, **kw), 2)
  kk2 = _event_ms(lambda: k1.plain_cp_render_grad(ws, rays, g, **kw), 2)
  k1.plain_cp_render_grad.launches = launches        # timing, not the path
  b2 = _mlp_bound(k1, "cp", rays.shape[0], STEPS, True)
  print(f"[time] {card}: one {rays.shape[0]}-ray x {STEPS}-step K2 call "
        f"{kk1:.2f} / {kk2:.2f} ms (bound {b2[0]:.2f} ms, split TF32 "
        f"{b2[3]:.2f} ms, bf16 tensor-core {b2[2]:.2f} ms), plain torch "
        f"{p1:.2f} ms", flush=True)
  target = torch.rand(BATCH, 3, device=dev, generator=gen)
  r4 = rays[:BATCH].contiguous()
  k3 = {}
  for name, fn, reps in (
      ("plain", lambda: k1.plain_cp_train_step_reference(ws, r4, target,
                                                         **kw), 5),
      ("kernel", lambda: k1.plain_cp_train_step(ws, r4, target, **kw), 5),
      ("kernel", lambda: k1.plain_cp_train_step(ws, r4, target, **kw), 5),
      ("plain", lambda: k1.plain_cp_train_step_reference(ws, r4, target,
                                                         **kw), 5)):
    k3.setdefault(name, []).append(_event_ms(fn, reps))
  print(f"[time] {card}: one {BATCH}-ray x {STEPS}-step K3 call "
        f"{k3['kernel'][0]:.2f} / {k3['kernel'][1]:.2f} ms, plain torch "
        f"{k3['plain'][0]:.2f} / {k3['plain'][1]:.2f} ms", flush=True)
  return min(k3["kernel"]), min(k3["plain"])


def _bound_ms(flop: float, nbytes: float):
  """(ms, "bytes" or "operations", bf16 ms, split-TF32 ms, its "bytes"
  or "operations"): the least time the card could take, the larger of
  the bytes over the HBM rate and the float32 operations over the float32
  peak; then the same with the operations over the bf16 tensor-core
  peak, and with three times the operations over the TF32 tensor-core
  peak (the split-TF32 products K2/K3, K8b and K9b run)."""
  t_ops, t_bytes = flop / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
  t_bf16 = max(flop / PEAK_BF16 * 1e3, t_bytes)
  t_tf32 = 3 * flop / PEAK_TF32 * 1e3
  tf32 = ((t_tf32, "operations") if t_tf32 >= t_bytes
          else (t_bytes, "bytes"))
  return ((t_ops, "operations", t_bf16, *tf32) if t_ops >= t_bytes
          else (t_bytes, "bytes", t_bf16, *tf32))


def _no_cotangent_macs(layers, prefix: str, hidden: int, rows: int) -> int:
  """Multiply-adds per point of the input-gradient products onto `rows`
  rows of the init feature of the MLP `prefix`, which no gradient needs:
  layer_in and each skip layer carry the init feature (their width is
  not `hidden`)."""
  return sum(rows * o for name, i, o in layers
             if name.startswith(prefix) and i != hidden)


def _mlp_bound(k1, enc: str, n: int, steps: int, backward: bool,
               per_ray: bool = False):
  """Bound of one K1 (or, backward, K2/K3) call on n rays (`per_ray`: with
  each ray's own ts and dists, [n, steps] each): 2 FLOP per
  multiply-add of the MLPs per sample point (3x that backward: the
  forward, the input- and the weight-gradient products, less the input
  gradients no output needs: the View's p and elev/azim rows, and for
  the parameter-free encoders (posenc, tiny, cone, cylinder) the density
  MLP's whole init feature); bytes: rays, ts, weights and the hash
  features in, [n, 4] out (backward: the target in, the gradient and
  dfeat out)."""
  lay = k1.LAYOUTS[enc]
  macs = sum(i * o for _, i, o in lay.density_layers + lay.refl_layers)
  pts = n * steps
  feat = pts * 16 if enc == "hash" else 0
  ts_floats = 2 * steps * (n if per_ray else 1)
  if backward:
    skip = _no_cotangent_macs(lay.refl_layers, "refl.mlp", k1.R_HIDDEN, 5)
    if enc not in ("cp", "hash"):
      name, _, hidden = lay.density_layers[0]
      skip += _no_cotangent_macs(lay.density_layers, name.rsplit(".", 1)[0],
                                 hidden, lay.feat_in)
    return _bound_ms(2 * (3 * macs - skip) * pts,
                     4 * (n * 9 + ts_floats + 2 * lay.weight_count
                          + 2 * feat))
  return _bound_ms(2 * macs * pts, 4 * (n * 10 + ts_floats + lay.weight_count
                                        + feat))


def _distinct_rows(hk, pts, size: int) -> int:
  """Table rows the points' corners touch: the rows K5f must read."""
  seen = torch.zeros(8 * size, dtype=torch.bool, device=pts.device)
  for _, _, idx, _ in hk._corners(pts, size):
    seen[idx] = True
  return int(seen.sum())


def _time_hash_kernels(card, k1, hk, frame_rays, dev):
  """Phase 6: K5f and K5b per call at K5F_SHAPES, kernel against plain
  (plain, kernel, kernel, plain), and one PyTorch call on the same rows
  and weights without the index math: `embedding_bag` (weighted sum of 8
  rows per point and level) for K5f, `index_add_` for K5b. Returns
  {(points, T): numbers}."""
  import torch.nn.functional as F
  grid = torch.linspace(2.0, 6.0, STEPS, device=dev)
  gen = torch.Generator().manual_seed(7)
  out = {}
  for n_rays, size in K5F_SHAPES:
    pts = k1.hash_pts(frame_rays[:n_rays], grid).contiguous()
    n = pts.shape[0]
    table = ((torch.rand(8 * size, 2, generator=gen) * 2 - 1) * 1e-4).to(dev)
    g = torch.randn(n, 16, device=dev)
    corners = list(hk._corners(pts, size))
    rows = torch.stack([c[2] for c in corners]).view(8, 8, n)
    wts = torch.stack([c[3] for c in corners]).view(8, 8, n)
    del corners
    bag_rows = rows.permute(2, 0, 1).reshape(n * 8, 8)
    bag_w = wts.permute(2, 0, 1).reshape(n * 8, 8)
    vals = (wts[..., None] * g.view(n, 8, 2).permute(1, 0, 2)[:, None]
            ).reshape(-1, 2)
    flat_rows = rows.reshape(-1)

    def lib_fwd():
      return F.embedding_bag(bag_rows, table, per_sample_weights=bag_w,
                             mode="sum")

    def lib_bwd():
      return torch.zeros(8 * size, 2, device=dev).index_add_(0, flat_rows,
                                                             vals)

    t = {}
    for name, fn, reps in (
        ("plain_f", lambda: hk.hash_encode_reference(table, pts), 2),
        ("kf", lambda: hk.hash_encode(table, pts), 10),
        ("kf", lambda: hk.hash_encode(table, pts), 10),
        ("plain_f", lambda: hk.hash_encode_reference(table, pts), 2),
        ("lib_f", lib_fwd, 5),
        ("plain_b", lambda: hk.hash_encode_table_grad_reference(pts, g, size),
         2),
        ("kb", lambda: hk.hash_encode_table_grad(pts, g, size), 10),
        ("kb", lambda: hk.hash_encode_table_grad(pts, g, size), 10),
        ("plain_b", lambda: hk.hash_encode_table_grad_reference(pts, g, size),
         2),
        ("lib_b", lib_bwd, 5)):
      t.setdefault(name, []).append(_event_ms(fn, reps))
    if not (torch.allclose(lib_fwd().view(n, 16), hk.hash_encode(table, pts),
                           atol=1e-6)):
      raise RuntimeError("embedding_bag yardstick computes another function")
    del bag_rows, bag_w, vals, flat_rows, rows, wts
    distinct = _distinct_rows(hk, pts, size)
    flop = HASH_FLOP_PER_LEVEL * 8 * n
    bf = _bound_ms(flop, n * 12 + distinct * 8 + n * 64)
    bb = _bound_ms(flop, n * 12 + n * 64 + 8 * size * 8)
    tag = f"{n} points, T=2^{size.bit_length() - 1}"
    print(f"[time] {card}: K5f {tag}: {t['kf'][0]:.4f} / {t['kf'][1]:.4f} ms "
          f"(bound {bf[0]:.4f} ms by {bf[1]}, {distinct} distinct rows); "
          f"plain torch {t['plain_f'][0]:.3f} / {t['plain_f'][1]:.3f} ms; "
          f"embedding_bag on precomputed rows {t['lib_f'][0]:.4f} ms",
          flush=True)
    print(f"[time] {card}: K5b {tag}: {t['kb'][0]:.4f} / {t['kb'][1]:.4f} ms "
          f"(bound {bb[0]:.4f} ms by {bb[1]}); plain torch "
          f"{t['plain_b'][0]:.3f} / {t['plain_b'][1]:.3f} ms; index_add_ on "
          f"precomputed rows {t['lib_b'][0]:.4f} ms", flush=True)
    out[(n, size)] = dict(
        fwd=(min(t["kf"]), min(t["plain_f"]), bf, t["lib_f"][0]),
        bwd=(min(t["kb"]), min(t["plain_b"]), bb, t["lib_b"][0]))
  return out


def _cold_ms(fn, reps: int, flush: torch.Tensor) -> float:
  """Mean ms of fn over `reps` launches, each timed alone after a write of
  `flush` (evict-normal lines through L2, as a streaming kernel leaves
  it)."""
  fn()                                        # warm-up
  marks = []
  for i in range(reps):
    flush.fill_(float(i))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    marks.append((a, b))
  torch.cuda.synchronize()
  return sum(a.elapsed_time(b) for a, b in marks) / reps


def _k5f_against(card, roots) -> int:
  """`--k5f-against ROOT [ROOT ...]`: K5f of this tree and of each ROOT (a
  checkout of the repo, or any directory that holds
  nerf_atlas_tpu_torch/csrc/hash_encode.cu), each built with this tree's
  nvcc flags, one nvcc each, started together; the SASS of K5b's three
  kernels (SASS_SAME_KERNELS) held to this tree's. Each is held to the plain
  version bit for bit at phase 3's points (T = 2^19, 2^14 and 2,
  amplified table) and at the timed shapes, then timed per call at
  K5F_SHAPES and at 4,194,304 points and T = 2 in turns (this tree, each
  ROOT, each ROOT in reverse, this tree), back to back (L2 warm) and each
  launch after a 256 MB write (as K1-hash's 268 MB feature stream leaves
  L2 between two eval chunks).
  Returns 1 where a K5f differs from the plain version."""
  import ctypes
  from nerf_atlas_tpu_torch.data import loaders, sampler
  from nerf_atlas_tpu_torch.ops.kernels import build
  from nerf_atlas_tpu_torch.ops.kernels import hash_encode as hk
  from nerf_atlas_tpu_torch.ops.kernels import render as k1
  dev = torch.device("cuda")
  build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
  out_dir = tempfile.mkdtemp(prefix="k5f_", dir=build.BUILD_DIR)
  labels = ["this tree"] + list(roots)

  def compile_lib(i):
    if i == 0:
      b = build.build("hash_encode")
      return str(b.path), b.log
    src = os.path.join(os.path.abspath(roots[i - 1]), "nerf_atlas_tpu_torch",
                       "csrc", "hash_encode.cu")
    lib = os.path.join(out_dir, f"libhash_encode-{i}.so")
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True, check=False)
    if proc.returncode:
      raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return lib, proc.stdout + proc.stderr

  t0 = time.perf_counter()
  with concurrent.futures.ThreadPoolExecutor(len(labels)) as pool:
    libs = list(pool.map(compile_lib, range(len(labels))))
  print(f"[k5f] {len(libs)} builds in {time.perf_counter() - t0:.1f} s",
        flush=True)
  ours = _sass(build, libs[0][0])
  for label, (path, _) in zip(labels[1:], libs[1:]):
    theirs = _sass(build, path)
    for kernel in SASS_SAME_KERNELS["hash_encode"]:
      a, c = ours.get(kernel, []), theirs.get(kernel, [])
      diff = [(x, y) for x, y in zip(a, c) if x != y]
      print(f"[k5f] SASS of {kernel} against {label}: "
            f"{'equal' if a and a == c else 'differs'} ({len(a)} / "
            f"{len(c)} lines)", flush=True)
      for x, y in diff[:3]:
        print(f"[k5f]   {x!r}\n[k5f]   {y!r}", flush=True)
  res = (ctypes.c_int * hk.LEVELS)(*hk.resolutions())
  fwds = []
  for label, (path, log) in zip(labels, libs):
    entries = [f"{n}: {r}" for n, r in _ptxas_entries(log)
               if n.startswith("hash_fwd")]
    print(f"[k5f] {label}: {' | '.join(entries) or 'reused build'}",
          flush=True)
    lib = ctypes.CDLL(path)
    lib.hash_fwd_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_longlong,
                                 ctypes.c_int * hk.LEVELS, ctypes.c_float,
                                 ctypes.c_float, ctypes.c_void_p])
    lib.hash_fwd_launch.restype = ctypes.c_int

    def fwd(table, pts, out, lib=lib):
      err = lib.hash_fwd_launch(
          table.data_ptr(), pts.data_ptr(), out.data_ptr(), pts.shape[0],
          table.shape[0] // hk.LEVELS, res, hk.BBOX[0], hk.BBOX[1],
          torch.cuda.current_stream().cuda_stream)
      if err:
        raise RuntimeError(f"hash_fwd launch failed: CUDA error {err}")
      return out
    fwds.append(fwd)

  bad = 0

  def check(tag, table, pts):
    nonlocal bad
    ref = hk.hash_encode_reference(table, pts)
    for label, fwd in zip(labels, fwds):
      out = fwd(table, pts, torch.empty_like(ref))
      torch.cuda.synchronize()
      same = torch.equal(out, ref)
      bad += not same
      print(f"[k5f] {tag} {label}: bitwise {same}, max|Δ| "
            f"{float((out - ref).abs().max()):.3e}", flush=True)

  gen = torch.Generator().manual_seed(4)
  pts = _hash_points(k1, dev)
  for size in (HASH_T, HASH_TRAIN_T, 2):
    table = (torch.rand(8 * size, 2, generator=gen) * 2 - 1).to(dev)
    check(f"phase 3's {pts.shape[0]} points, T=2^{size.bit_length() - 1} "
          "amplified,", table, pts)
  ds = sampler.RayDataset.from_bundle(
      loaders.load("", data_kind="synthetic", size=SIZE, num_views=1,
                   device=dev), size=SIZE, device=dev)
  frame_rays = ds.view_rays(0)
  grid = torch.linspace(2.0, 6.0, STEPS, device=dev)
  flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
  order = list(range(len(fwds))) + list(range(len(fwds)))[::-1]
  # and at T = 2, where the table is one 128-byte line: every load an L1
  # hit, the floor of the loads' own cost
  for n_rays, size in K5F_SHAPES + ((CHUNK, 2),):
    pts = k1.hash_pts(frame_rays[:n_rays], grid).contiguous()
    table = ((torch.rand(8 * size, 2, generator=gen) * 2 - 1) * 1e-4).to(dev)
    tag = f"{pts.shape[0]} points, T=2^{size.bit_length() - 1}"
    check(tag, table, pts)
    out = torch.empty(pts.shape[0], 16, device=dev)
    warm = [[] for _ in fwds]
    cold = [[] for _ in fwds]
    for i in order:
      warm[i].append(_event_ms(lambda: fwds[i](table, pts, out), 20))
      cold[i].append(_cold_ms(lambda: fwds[i](table, pts, out), 20, flush))
    for label, w, c in zip(labels, warm, cold):
      print(f"[k5f] {card}: {tag} {label}: back to back "
            f"{' / '.join(f'{v:.4f}' for v in w)} ms, after a 256 MB write "
            f"{' / '.join(f'{v:.4f}' for v in c)} ms", flush=True)
  return 1 if bad else 0


def _time_hash(card, models, driver, loaders, sampler, k1, hk, rays_ops, dev,
               frame_ds):
  """Phase 6, hash half: K5f/K5b, the K1-hash and K3-hash calls, the hash
  train steps and one 800x800 hash frame. Returns the numbers of the
  kernels line."""
  frame_rays = frame_ds.view_rays(0)
  res = {"k5": _time_hash_kernels(card, k1, hk, frame_rays, dev)}
  model = driver.init_model(models.PlainNeRF(steps=STEPS, enc_kind="hash",
                                             device=dev), seed=0)
  sd = model.state_dict()
  ws, table = k1.pack_weights(sd, dev, "hash"), k1.hash_table(sd)
  grid = torch.linspace(2.0, 6.0, STEPS, device=dev)
  kw = dict(steps=STEPS, t_near=2.0, t_far=6.0)
  call_rays = frame_rays[:CHUNK].contiguous()
  feats = hk.hash_encode(table, k1.hash_pts(call_rays, grid))
  ms = {}
  for name, fn, reps in (
      ("plain", lambda: k1.plain_hash_render_reference(ws, call_rays, feats,
                                                       **kw), 2),
      ("kernel", lambda: k1.plain_hash_render(ws, call_rays, feats, **kw), 3),
      ("kernel", lambda: k1.plain_hash_render(ws, call_rays, feats, **kw), 3),
      ("plain", lambda: k1.plain_hash_render_reference(ws, call_rays, feats,
                                                       **kw), 2)):
    ms.setdefault(name, []).append(_event_ms(fn, reps))
  res["k1"] = (min(ms["kernel"]), min(ms["plain"]),
               _mlp_bound(k1, "hash", CHUNK, STEPS, False))
  print(f"[time] {card}: one {CHUNK}-ray x {STEPS}-step K1-hash call "
        f"{ms['kernel'][0]:.2f} / {ms['kernel'][1]:.2f} ms (bound "
        f"{res['k1'][2][0]:.2f} ms, split TF32 {res['k1'][2][3]:.2f}), plain "
        f"torch {ms['plain'][0]:.2f} / {ms['plain'][1]:.2f} ms", flush=True)

  gen = torch.Generator(device=dev).manual_seed(8)
  r4 = call_rays[:BATCH].contiguous()
  ts = rays_ops.compute_ts(2.0, 6.0, STEPS, perturb=1.0, generator=gen,
                           device=dev)
  f4 = hk.hash_encode(table, k1.hash_pts(r4, ts))
  target = torch.rand(BATCH, 3, device=dev, generator=gen)
  k3 = {}
  for name, fn in (
      ("plain", lambda: k1.plain_hash_train_step_reference(
          ws, r4, f4, target, ts=ts, steps=STEPS)),
      ("kernel", lambda: k1.plain_hash_train_step(ws, r4, f4, target, ts=ts,
                                                  steps=STEPS)),
      ("kernel", lambda: k1.plain_hash_train_step(ws, r4, f4, target, ts=ts,
                                                  steps=STEPS)),
      ("plain", lambda: k1.plain_hash_train_step_reference(
          ws, r4, f4, target, ts=ts, steps=STEPS))):
    k3.setdefault(name, []).append(_event_ms(fn, 5))
  res["k3"] = (min(k3["kernel"]), min(k3["plain"]),
               _mlp_bound(k1, "hash", BATCH, STEPS, True))
  print(f"[time] {card}: one {BATCH}-ray x {STEPS}-step K3-hash call "
        f"{k3['kernel'][0]:.2f} / {k3['kernel'][1]:.2f} ms (bound "
        f"{res['k3'][2][3]:.2f} ms in split TF32), plain torch "
        f"{k3['plain'][0]:.2f} / {k3['plain'][1]:.2f} ms", flush=True)

  ds = sampler.RayDataset.from_bundle(
      loaders.load("", data_kind="synthetic", size=48, num_views=30,
                   device=dev), size=48, device=dev)
  fns = _step_fns(models.PlainNeRF, driver, ds, dev, enc_kind="hash")
  fns.update({f"{name} T=2^14": fn for name, fn in _step_fns(
      models.PlainNeRF, driver, ds, dev, names=("K3 step",), enc_kind="hash",
      table_size=HASH_TRAIN_T).items()})
  order = ["K3 step", "K3 step T=2^14", "K1+K2 step", "plain step"]
  step_ms = {}
  for name in order + order[::-1]:
    step, _ = fns[name]
    step_ms.setdefault(name, []).append(_event_ms(lambda: step(0, gen), 5))
  for name in order:
    v = step_ms[name]
    tag = name if "T=" in name else f"{name} T=2^19"
    print(f"[time] {card}: hash {tag} at {BATCH}x{STEPS}: {v[0]:.2f} / "
          f"{v[1]:.2f} ms = {BATCH / (min(v) / 1e3):,.0f} train rays/s",
          flush=True)

  def ref_frame():
    return torch.cat([k1.plain_hash_render_reference(
        ws, rc, hk.hash_encode_reference(table, k1.hash_pts(rc, grid)),
        **kw)[:, :3] for rc in frame_rays.split(CHUNK)])

  img_ref, ref_s = _sync_time(ref_frame)
  img_k, k_s = _sync_time(lambda: driver.render_view(model, frame_ds, 0))
  frame_err = float(np.abs(img_k.reshape(-1, 3)
                           - img_ref.cpu().numpy()).max())
  if frame_err > TOL:
    raise RuntimeError(f"800x800 hash frame: kernel vs reference {frame_err}")
  print(f"[time] {card}: one {SIZE}x{SIZE}x{STEPS} hash frame (T=2^19): "
        f"render_view (K5f + K1-hash) {k_s:.3f} s = {SIZE * SIZE / k_s:,.0f} "
        f"rays/s, plain torch {ref_s:.3f} s = {SIZE * SIZE / ref_s:,.0f} "
        f"rays/s | frame max diff {frame_err:.2e}", flush=True)
  res["frame_err"] = frame_err
  return res


def _ae_bound(k7, n: int, backward: bool):
  """Bound of one K7f (or, backward, K7b) call on n rays x 64 steps: 2
  FLOP per multiply-add of the three MLPs per sample point (3x that
  backward, less the input gradients no output needs: the encoder's 51
  posenc rows and the View's p and elev/azim rows); bytes: rays, ts,
  dists, the bands and the weights in, [n, 4] out (backward: the target
  in, the gradient out)."""
  macs = sum(i * o for _, i, o in k7.LAYERS)
  pts = n * STEPS
  fixed = 2 * STEPS + 8
  if backward:
    skip = (_no_cotangent_macs(k7.LAYERS, "encode", k7.E_HIDDEN, k7.E_IN)
            + _no_cotangent_macs(k7.LAYERS, "refl.mlp", k7.k1.R_HIDDEN, 5))
    return _bound_ms(2 * (3 * macs - skip) * pts,
                     4 * (n * 9 + fixed + 2 * k7.WEIGHT_COUNT))
  return _bound_ms(2 * macs * pts, 4 * (n * 10 + fixed + k7.WEIGHT_COUNT))


def _time_ae(card, models, driver, loaders, sampler, k7, rays_ops, dev,
             frame_ds):
  """Phase 6, NeRFAE: the K7f and plain calls at 65536 x 64, one 800x800
  frame, the K7b and plain K7b calls at 4096 x 64, the three train steps
  at the ae recipe and the latent L2's share of the K7b step. Returns the
  numbers of the kernels line."""
  from nerf_atlas_tpu_torch.train import regularizers
  model = driver.init_model(models.NeRFAE(steps=STEPS, device=dev), seed=0)
  ws = k7.pack_weights_ae(model.state_dict(), dev)
  frame_rays = frame_ds.view_rays(0)
  call_rays = frame_rays[:CHUNK].contiguous()
  kw = dict(steps=STEPS, t_near=2.0, t_far=6.0)
  res, ms = {}, {}
  for name, fn, reps in (
      ("plain", lambda: k7.ae_render_reference(ws, call_rays, **kw), 2),
      ("kernel", lambda: k7.fused_ae_render(ws, call_rays, **kw), 3),
      ("kernel", lambda: k7.fused_ae_render(ws, call_rays, **kw), 3),
      ("plain", lambda: k7.ae_render_reference(ws, call_rays, **kw), 2)):
    ms.setdefault(name, []).append(_event_ms(fn, reps))
  res["k7f"] = (min(ms["kernel"]), min(ms["plain"]),
                _ae_bound(k7, CHUNK, False))
  tflop = 2 * sum(i * o for _, i, o in k7.LAYERS) * CHUNK * STEPS / 1e12
  print(f"[time] {card}: one {CHUNK}-ray x {STEPS}-step K7f call "
        f"{ms['kernel'][0]:.2f} / {ms['kernel'][1]:.2f} ms "
        f"({tflop / (min(ms['kernel']) / 1e3):.2f} TFLOP/s; bound "
        f"{res['k7f'][2][0]:.2f} ms, split TF32 {res['k7f'][2][3]:.2f}), "
        f"plain torch {ms['plain'][0]:.2f} / "
        f"{ms['plain'][1]:.2f} ms ({tflop / (min(ms['plain']) / 1e3):.2f} "
        "TFLOP/s)", flush=True)

  def ref_frame():
    return torch.cat([k7.ae_render_reference(ws, rc, **kw)[:, :3]
                      for rc in frame_rays.split(CHUNK)])

  img_ref, ref_s = _sync_time(ref_frame)
  img_k, k_s = _sync_time(lambda: driver.render_view(model, frame_ds, 0))
  res["frame_err"] = float(np.abs(img_k.reshape(-1, 3)
                                  - img_ref.cpu().numpy()).max())
  if res["frame_err"] > TOL:
    raise RuntimeError(f"800x800 ae frame: kernel vs reference "
                       f"{res['frame_err']}")
  print(f"[time] {card}: one {SIZE}x{SIZE}x{STEPS} ae frame: render_view "
        f"(K7f) {k_s:.3f} s = {SIZE * SIZE / k_s:,.0f} rays/s, plain torch "
        f"{ref_s:.3f} s = {SIZE * SIZE / ref_s:,.0f} rays/s | frame max diff "
        f"{res['frame_err']:.2e}", flush=True)

  gen = torch.Generator(device=dev).manual_seed(9)
  r4 = call_rays[:BATCH].contiguous()
  ts = rays_ops.compute_ts(2.0, 6.0, STEPS, perturb=1.0, generator=gen,
                           device=dev)
  target = torch.rand(BATCH, 3, device=dev, generator=gen)
  launches = k7.fused_ae_train_step.launches
  k7b_ms = _event_ms(lambda: k7.fused_ae_train_step(ws, r4, target, ts,
                                                    steps=STEPS), 5)
  k7.fused_ae_train_step.launches = launches         # timing, not the path
  plain_ms = _event_ms(lambda: k7.ae_train_step_reference(
      ws, r4, target, ts=ts, steps=STEPS), 3)
  res["k7b"] = (k7b_ms, plain_ms, _ae_bound(k7, BATCH, True))
  print(f"[time] {card}: one {BATCH}-ray x {STEPS}-step K7b call (loss "
        f"mode) {k7b_ms:.2f} ms (bound {res['k7b'][2][0]:.2f} ms, split TF32 "
        f"{res['k7b'][2][3]:.2f}), plain torch {plain_ms:.2f} ms", flush=True)

  ds = sampler.RayDataset.from_bundle(
      loaders.load("", data_kind="synthetic", size=48, num_views=30,
                   device=dev), size=48, device=dev)
  fns = _step_fns(models.NeRFAE, driver, ds, dev,
                  reg_coeffs={"latent_l2": AE_LATENT_L2})
  order = ["K3 step", "K1+K2 step", "plain step"]
  labels = {"K3 step": "K7b step", "K1+K2 step": "K7f+K7b step",
            "plain step": "plain step"}
  step_ms = {}
  for name in order + order[::-1]:
    step, _ = fns[name]
    step_ms.setdefault(name, []).append(_event_ms(lambda: step(0, gen), 5))
  for name in order:
    v = step_ms[name]
    print(f"[time] {card}: ae {labels[name]} at {BATCH}x{STEPS} (latent L2 "
          f"{AE_LATENT_L2}): {v[0]:.2f} / {v[1]:.2f} ms = "
          f"{BATCH / (min(v) / 1e3):,.0f} train rays/s", flush=True)

  def latent_l2_grad():
    reg = AE_LATENT_L2 * regularizers.ae_latent_l2(model, gen)
    reg.backward()

  reg_ms = _event_ms(latent_l2_grad, 10)
  model.zero_grad(set_to_none=True)
  print(f"[time] {card}: ae_latent_l2 (1024 points) + its gradient "
        f"{reg_ms:.3f} ms = {reg_ms / min(step_ms['K3 step']):.4f} of the "
        "K7b step", flush=True)
  return res


def _time_k4(card, models, driver, loaders, sampler, k1, rays_ops, dev,
             frame_ds):
  """Phase 6, the K4 modes: each mode's K1 and plain calls at 65536 x 64
  and K3 and plain K3 calls at 4096 x 64 (plain, kernel, kernel, plain);
  then for posenc, mip cone and tiny the three train steps at 4096 x 64.
  Returns {mode: ((K1 ms, plain ms, bound), (K3 ms, plain ms, bound))}."""
  frame_rays = frame_ds.view_rays(0)
  call_rays = frame_rays[:CHUNK].contiguous()
  r4 = call_rays[:BATCH].contiguous()
  gen = torch.Generator(device=dev).manual_seed(11)
  res = {}
  for mode in K4_MODES:
    ws = k1.pack_weights(driver.init_model(_k4_model(models, mode, dev),
                                           seed=0).state_dict(), dev, mode)
    kw = dict(steps=STEPS, t_near=2.0, t_far=6.0, enc_kind=mode)
    ms = {}
    for name, fn, reps in (
        ("plain", lambda: k1.plain_cp_render_reference(ws, call_rays, **kw),
         2),
        ("kernel", lambda: k1.plain_cp_render(ws, call_rays, **kw), 3),
        ("kernel", lambda: k1.plain_cp_render(ws, call_rays, **kw), 3),
        ("plain", lambda: k1.plain_cp_render_reference(ws, call_rays, **kw),
         2)):
      ms.setdefault(name, []).append(_event_ms(fn, reps))
    b1 = _mlp_bound(k1, mode, CHUNK, STEPS, False)
    ts = rays_ops.compute_ts(2.0, 6.0, STEPS, perturb=1.0, generator=gen,
                             device=dev)
    target = torch.rand(BATCH, 3, device=dev, generator=gen)
    k3 = {}
    for name, fn, reps in (
        ("plain", lambda: k1.plain_cp_train_step_reference(
            ws, r4, target, ts=ts, **kw), 3),
        ("kernel", lambda: k1.plain_cp_train_step(ws, r4, target, ts=ts,
                                                  **kw), 5),
        ("kernel", lambda: k1.plain_cp_train_step(ws, r4, target, ts=ts,
                                                  **kw), 5),
        ("plain", lambda: k1.plain_cp_train_step_reference(
            ws, r4, target, ts=ts, **kw), 3)):
      k3.setdefault(name, []).append(_event_ms(fn, reps))
    b3 = _mlp_bound(k1, mode, BATCH, STEPS, True)
    macs = sum(i * o for _, i, o in k1.LAYOUTS[mode].density_layers
               + k1.LAYOUTS[mode].refl_layers)
    tflops = 2 * macs * CHUNK * STEPS / (min(ms["kernel"]) / 1e3) / 1e12
    print(f"[time] {card}: one {CHUNK}-ray x {STEPS}-step K1-{mode} call "
          f"{ms['kernel'][0]:.2f} / {ms['kernel'][1]:.2f} ms ({tflops:.2f} "
          f"TFLOP/s; bound {b1[0]:.2f} ms, split TF32 {b1[3]:.2f}, bf16 "
          f"{b1[2]:.2f}), plain torch {ms['plain'][0]:.2f} / "
          f"{ms['plain'][1]:.2f} ms", flush=True)
    print(f"[time] {card}: one {BATCH}-ray x {STEPS}-step K3-{mode} call "
          f"{k3['kernel'][0]:.2f} / {k3['kernel'][1]:.2f} ms (bound "
          f"{b3[0]:.2f} ms, split TF32 {b3[3]:.2f}, bf16 {b3[2]:.2f}), plain "
          f"torch {k3['plain'][0]:.2f} / {k3['plain'][1]:.2f} ms", flush=True)
    res[mode] = ((min(ms["kernel"]), min(ms["plain"]), b1),
                 (min(k3["kernel"]), min(k3["plain"]), b3))

  ds = sampler.RayDataset.from_bundle(
      loaders.load("", data_kind="synthetic", size=48, num_views=30,
                   device=dev), size=48, device=dev)
  for tag, model_cls, model_kw in (
      ("posenc", models.PlainNeRF, dict(enc_kind="posenc")),
      ("mip cone", models.PlainNeRF, dict(mip="cone")),
      ("tiny", models.TinyNeRF, {})):
    fns = _step_fns(model_cls, driver, ds, dev, **model_kw)
    order = ["K3 step", "K1+K2 step", "plain step"]
    step_ms = {}
    for name in order + order[::-1]:
      step, _ = fns[name]
      step_ms.setdefault(name, []).append(_event_ms(lambda: step(0, gen), 5))
    for name in order:
      v = step_ms[name]
      print(f"[time] {card}: {tag} {name} at {BATCH}x{STEPS}: {v[0]:.2f} / "
            f"{v[1]:.2f} ms = {BATCH / (min(v) / 1e3):,.0f} train rays/s",
            flush=True)
  return res

def _cf_model(models, mode, dev, **kw):
  """The CoarseFineNeRF of a kernel mode at full width (64 + 64 steps)."""
  mip = mode if mode in ("cone", "cylinder") else None
  return models.CoarseFineNeRF(steps=STEPS, fine_steps=FINE_STEPS, mip=mip,
                               enc_kind="cp" if mip else mode, device=dev,
                               **kw)


def _merged_ts(k1, sampling, ws, rays, mode, coarse: int, gen):
  """Real per-ray ts [N, 2·coarse]: a coarse pass (K1 with weights on the
  uniform grid of `coarse` steps), u from `gen`, the inverse CDF and the
  merge, as CoarseFineNeRF's training draws its fine positions."""
  _, w = k1.plain_cp_render(ws, rays, steps=coarse, enc_kind=mode,
                            want_weights=True)
  grid = torch.linspace(2.0, 6.0, coarse, device=rays.device).expand(
      rays.shape[0], coarse)
  return sampling.merge_ts(grid, sampling.sample_pdf(
      grid, w, coarse, generator=gen)).contiguous()


def _check_coarse_fine(k1, sampling, models, driver, dev):
  """Phase 3, per-ray ts and the weights output (K6) in CoarseFineNeRF's
  modes: K1 with per-ray ts and weights at 4096 x 128 (the merged ts of a
  coarse pass of the seeded weights) and ragged at 77 x 16, seeded and
  amplified, against the plain version (rgb, acc and weights); K1 on a
  shared [T] ts against the same ts expanded to [N, T], bit for bit; K2
  (mode G) and K3 (mode L) on the per-ray ts against autograd through the
  plain K1, over all rays and the kink-free ones; PlainCPRender's
  gradient (with its weights output) against K2's and two K2 launches,
  bit for bit. Returns {mode: (K1 max |Δ|, K2/K3 max |Δ|)}."""
  rays = torch.from_numpy(_check_rays(N_CHECK, 0)).to(dev)
  rays_r = torch.from_numpy(_check_rays(77, 2)).to(dev)
  out = {}
  for i, mode in enumerate(CF_MODES):
    sd = driver.init_model(_cf_model(models, mode, dev), seed=0).state_dict()
    seeded = k1.pack_weights(sd, dev, mode)
    amplified = k1.pack_weights(_k4_amplified(sd, mode), dev, mode)
    gen = torch.Generator(device=dev).manual_seed(20 + i)
    per_ray = {n: (r, _merged_ts(k1, sampling, seeded, r, mode, t // 2, gen))
               for n, r, t in ((N_CHECK, rays, 2 * STEPS), (77, rays_r, 16))}
    max_k1, max_bwd = 0.0, 0.0
    for wname, sky, kind in (("seeded", "black", "thin"),
                             ("amplified", "white", "normal")):
      ws = seeded if wname == "seeded" else amplified
      for n, (r, ts) in per_ray.items():
        kw = dict(steps=ts.shape[1], t_near=2.0, t_far=6.0, sigmoid_kind=kind,
                  sky_kind=sky, ts=ts, enc_kind=mode)
        got, w = k1.plain_cp_render(ws, r, want_weights=True, **kw)
        ref, w_ref = k1.plain_cp_render_reference(ws, r, want_weights=True,
                                                  **kw)
        torch.cuda.synchronize()
        errs = [float((got[:, :3] - ref[:, :3]).abs().max()),
                float((got[:, 3] - ref[:, 3]).abs().max()),
                float((w - w_ref).abs().max())]
        print(f"[check] K1-{mode} per-ray {wname:9s} sky {sky:5s} {kind:6s} "
              f"{n} x {ts.shape[1]}: max|rgb| {errs[0]:.3e} max|acc| "
              f"{errs[1]:.3e} max|weights| {errs[2]:.3e} (tol {TOL:.0e}; "
              f"ref rgb std {float(ref[:, :3].std()):.3f})", flush=True)
        if not (max(errs) <= TOL and bool(torch.isfinite(got).all())
                and bool(torch.isfinite(w).all())):
          raise RuntimeError(f"K1-{mode} per-ray disagrees with its plain "
                             f"version: {errs}")
        max_k1 = max([max_k1] + errs)
        max_bwd = max(max_bwd, _check_bwd(
            f"per-ray {wname:9s} sky {sky:5s} {kind:6s} {n} x {ts.shape[1]}",
            k1, ws, r, gen, kw))
      ts = per_ray[N_CHECK][1]
      kw = dict(steps=ts.shape[1], sigmoid_kind=kind, sky_kind=sky,
                enc_kind=mode, want_weights=True)
      shared = k1.plain_cp_render(ws, rays, ts=ts[0].contiguous(), **kw)
      expanded = k1.plain_cp_render(
          ws, rays, ts=ts[0].expand(N_CHECK, ts.shape[1]).contiguous(), **kw)
      if not all(torch.equal(a, b) for a, b in zip(shared, expanded)):
        raise RuntimeError(f"K1-{mode}: a shared ts and the same ts per ray "
                           "differ")
    r, ts = per_ray[77]
    kw = dict(steps=16, ts=ts, sky_kind="white", enc_kind=mode)
    g = torch.randn(77, 4, device=dev, generator=gen)
    leaf = amplified.clone().requires_grad_(True)
    o, w = k1.plain_cp_render_train(leaf, r, ts, steps=16, sky_kind="white",
                                    enc_kind=mode, want_weights=True)
    (o * g).sum().backward()
    direct = k1.plain_cp_render_grad(amplified, r, g, **kw)
    again = k1.plain_cp_render_grad(amplified, r, g, **kw)
    if w.requires_grad or not (torch.equal(leaf.grad, direct)
                               and torch.equal(direct, again)):
      raise RuntimeError(f"PlainCPRender-{mode} per-ray: its gradient "
                         "differs from K2's, two K2 launches differ, or its "
                         "weights output takes a gradient")
    print(f"[check] K1-{mode}: shared ts == the same ts per ray (bitwise, "
          f"rgb ‖ acc and weights); PlainCPRender-{mode} per-ray backward == "
          f"K2-{mode} (bitwise), its weights output non-differentiable; two "
          f"K2-{mode} per-ray launches bitwise equal", flush=True)
    out[mode] = (max_k1, max_bwd)
  return out


def _train_main_cf(port_runner, k1, loaders, dev):
  """Phase 5j: the coarse_fine_mip recipe through the two-kernel path: K1
  twice (coarse with weights, fine on the merged per-ray ts) and K2 twice
  per step, K1 twice per chunk in eval, nothing else; both splits 2 dB
  over all-black. Returns the launches per kernel."""
  results, secs, counts, black = _train_run(port_runner, k1, loaders, dev,
                                            CF_STEPS, argv=CF_TRAIN_ARGV)
  losses = _check_trained(results, black, path="fused")
  eval_k1 = counts["K1"] - 2 * CF_STEPS
  others = {k: v for k, v in counts.items() if k not in ("K1", "K2") and v}
  if (counts["K2"] != 2 * CF_STEPS or eval_k1 <= 0 or eval_k1 % 2
      or others):
    raise RuntimeError(f"coarse_fine training launched {counts}, expected "
                       f"{2 * CF_STEPS} K2, {2 * CF_STEPS} K1 and two K1 per "
                       "eval chunk, nothing else")
  print(f"[train] runner coarse_fine_mip {CF_STEPS} steps x {BATCH} rays x "
        f"{STEPS} + {FINE_STEPS} samples (48x48, 30 views): {secs:.2f} s end "
        f"to end | path {results['engaged_path']} | launches K1 "
        f"{counts['K1']} ({2 * CF_STEPS} in training, {eval_k1} in eval), K2 "
        f"{counts['K2']} | loss {losses[0]:.5f} -> {losses[-1]:.5f} | PSNR "
        f"train {results['train']['psnr_mean']:.3f} test "
        f"{results['test']['psnr_mean']:.3f} (all-black "
        f"{black['train']:.3f} / {black['test']:.3f})", flush=True)
  return counts


def _time_coarse_fine(card, models, driver, loaders, sampler, k1, sampling,
                      dev, frame_ds):
  """Phase 6, coarse_fine: one 800x800 mip-cone frame through render_view
  (K1 twice per chunk) and through the plain version (the plain coarse
  pass, its own sampling, the plain fine pass; held to TOL); K1 per ray
  at 65536 x 128 (the merged ts of a coarse pass) and its plain version
  in each mode, K2 per ray at 4096 x 128 in cone and its plain version
  (autograd through the plain K1), plain, kernel, kernel, plain; the
  coarse_fine_mip train steps at 4096 (K1 + K2 twice, plain). Returns
  {"frame_err", "fwd": {mode: (ms, plain ms, bound)}, "bwd": (...)}."""
  model = driver.init_model(_cf_model(models, "cone", dev), seed=0)
  frame_rays = frame_ds.view_rays(0)
  ws = k1.pack_weights(model.state_dict(), dev, "cone")
  grid = torch.linspace(2.0, 6.0, STEPS, device=dev)
  total = STEPS + FINE_STEPS

  def ref_frame():
    outs = []
    for i in range(0, frame_rays.shape[0], CHUNK):
      rc = frame_rays[i:i + CHUNK]
      _, w = k1.plain_cp_render_reference(ws, rc, steps=STEPS,
                                          enc_kind="cone", want_weights=True)
      tb = grid.expand(rc.shape[0], STEPS)
      ts = sampling.merge_ts(tb, sampling.sample_pdf(tb, w, FINE_STEPS))
      for j in range(0, rc.shape[0], CHUNK // 2):    # halves, as below
        outs.append(k1.plain_cp_render_reference(
            ws, rc[j:j + CHUNK // 2], steps=total,
            ts=ts[j:j + CHUNK // 2].contiguous(), enc_kind="cone")[:, :3])
    return torch.cat(outs)

  img_ref, ref_s = _sync_time(ref_frame)
  img_k, k_s = _sync_time(lambda: driver.render_view(model, frame_ds, 0))
  frame_err = float(np.abs(img_k.reshape(-1, 3)
                           - img_ref.cpu().numpy()).max())
  print(f"[time] {card}: one {SIZE}x{SIZE} coarse_fine (cone, {STEPS} + "
        f"{FINE_STEPS}) frame: render_view (K1 x 2 per chunk) {k_s:.3f} s = "
        f"{SIZE * SIZE / k_s:,.0f} rays/s, plain torch {ref_s:.3f} s | frame "
        f"max diff {frame_err:.2e}", flush=True)
  if frame_err > TOL:
    raise RuntimeError(f"coarse_fine frame: kernel vs plain {frame_err}")

  call_rays = frame_rays[:CHUNK].contiguous()
  half = CHUNK // 2
  gen = torch.Generator(device=dev).manual_seed(12)
  res = {"frame_err": frame_err, "fwd": {}}
  for mode in CF_MODES:
    wm = k1.pack_weights(driver.init_model(_cf_model(models, mode, dev),
                                           seed=0).state_dict(), dev, mode)
    ts = _merged_ts(k1, sampling, wm, call_rays, mode, STEPS, gen)
    kw = dict(steps=total, enc_kind=mode)

    # the plain version in two halves: its MLP's activations at 65536 x
    # 128 points would take most of the card's memory
    def plain():
      return [k1.plain_cp_render_reference(
          wm, call_rays[i:i + half], ts=ts[i:i + half], **kw)
          for i in (0, half)]

    ms = {}
    for name, fn, reps in (
        ("plain", plain, 2),
        ("kernel", lambda: k1.plain_cp_render(wm, call_rays, ts=ts, **kw), 3),
        ("kernel", lambda: k1.plain_cp_render(wm, call_rays, ts=ts, **kw), 3),
        ("plain", plain, 2)):
      ms.setdefault(name, []).append(_event_ms(fn, reps))
    b1 = _mlp_bound(k1, mode, CHUNK, total, False, per_ray=True)
    print(f"[time] {card}: one {CHUNK}-ray x {total}-step K1-{mode} call on "
          f"per-ray ts {ms['kernel'][0]:.2f} / {ms['kernel'][1]:.2f} ms "
          f"(bound {b1[0]:.2f} ms, split TF32 {b1[3]:.2f}, bf16 "
          f"{b1[2]:.2f}), plain torch {ms['plain'][0]:.2f} / "
          f"{ms['plain'][1]:.2f} ms", flush=True)
    res["fwd"][mode] = (min(ms["kernel"]), min(ms["plain"]), b1)

  r4 = call_rays[:BATCH].contiguous()
  ts = _merged_ts(k1, sampling, ws, r4, "cone", STEPS, gen)
  g = torch.randn(BATCH, 4, device=dev, generator=gen)
  kw = dict(steps=total, ts=ts, enc_kind="cone")
  launches = k1.plain_cp_render_grad.launches
  k2 = {}
  for name, fn, reps in (
      ("plain", lambda: k1.plain_cp_render_grad_reference(ws, r4, g, **kw), 3),
      ("kernel", lambda: k1.plain_cp_render_grad(ws, r4, g, **kw), 5),
      ("kernel", lambda: k1.plain_cp_render_grad(ws, r4, g, **kw), 5),
      ("plain", lambda: k1.plain_cp_render_grad_reference(ws, r4, g, **kw),
       3)):
    k2.setdefault(name, []).append(_event_ms(fn, reps))
  k1.plain_cp_render_grad.launches = launches        # timing, not the path
  b2 = _mlp_bound(k1, "cone", BATCH, total, True, per_ray=True)
  print(f"[time] {card}: one {BATCH}-ray x {total}-step K2-cone call on "
        f"per-ray ts {k2['kernel'][0]:.2f} / {k2['kernel'][1]:.2f} ms (bound "
        f"{b2[0]:.2f} ms, split TF32 {b2[3]:.2f}, bf16 {b2[2]:.2f}), plain "
        f"torch {k2['plain'][0]:.2f} / {k2['plain'][1]:.2f} ms", flush=True)
  res["bwd"] = (min(k2["kernel"]), min(k2["plain"]), b2)

  ds = sampler.RayDataset.from_bundle(
      loaders.load("", data_kind="synthetic", size=48, num_views=30,
                   device=dev), size=48, device=dev)
  fns = _step_fns(models.CoarseFineNeRF, driver, ds, dev,
                  names=("K1+K2 step", "plain step"), mip="cone",
                  enc_kind="cp", fine_steps=FINE_STEPS)
  step_ms = {}
  for name in ("K1+K2 step", "plain step", "plain step", "K1+K2 step"):
    step, _ = fns[name]
    step_ms.setdefault(name, []).append(_event_ms(lambda: step(0, gen), 5))
  for name, v in step_ms.items():
    print(f"[time] {card}: coarse_fine_mip {name} at {BATCH}x({STEPS} + "
          f"{total}): {v[0]:.2f} / {v[1]:.2f} ms = "
          f"{BATCH / (min(v) / 1e3):,.0f} train rays/s", flush=True)
  return res


def _volsdf_weights(models, driver, k8, dev, steps=STEPS):
  """(state_dict, seeded, amplified) of a VolSDF at the recipe's width:
  the amplified weights scale the View's output layer by 40, so that rgb
  spans (0, 1)."""
  sd = dict(driver.init_model(models.VolSDF(steps=steps, device=dev),
                              seed=0).state_dict())
  amp = dict(sd)
  amp["refl.mlp.layer_out.weight"] = amp["refl.mlp.layer_out.weight"] * 40.0
  return sd, k8.pack_weights(sd, dev), k8.pack_weights(amp, dev)


def _float64_witness(k8, ws, rays, ts, target, kw):
  """K8b-L with the eikonal in float64 on the kernels' float32 init
  features (`testing.volsdf_float64_grad`): the packed gradient, for
  telling how far each float32 implementation lies from the same function
  in float64."""
  from nerf_atlas_tpu_torch import testing
  return testing.volsdf_float64_grad(ws, rays, ts, target, kw["sigmoid_kind"],
                                     kw["sky_kind"], VOLSDF_EIKONAL)


def _worst(k8, raw, got, ref):
  """(max over the state_dict tensors of ‖got − ref‖/‖ref‖, its key)."""
  ug, ur = k8.unpack_grads(got.float(), raw), k8.unpack_grads(ref.float(),
                                                              raw)
  errs = {k: float((ug[k].double() - ur[k].double()).norm()
                   / ur[k].double().norm()) for k in ur}
  key = max(errs, key=errs.get)
  return errs[key], key


def _eikonal_floor(k8, testing, sd, ws, rays_ops, dev):
  """Printed, not gated: K8b-L with the eikonal against its plain version
  and both against `_float64_witness` at fewer rays than the gated check.
  The eikonal's weight gradient sums per-point terms that mostly cancel,
  so its float32 rounding shrinks relative to it as 1/√rays; below 4096
  rays it can exceed GRAD_RTOL in both implementations."""
  raw = sd[k8.SCALE_KEY]
  for n, seed in ((301, 2), (1001, 64)):
    rays = torch.from_numpy(_check_rays(n, seed)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ts = rays_ops.compute_ts(2.0, 6.0, STEPS, perturb=1.0, generator=gen,
                             device=dev)
    keep = testing.volsdf_kink_free_rays(ws, rays, ts, STEPS, KINK_MARGIN)
    kw = dict(steps=STEPS, sigmoid_kind="upshifted", sky_kind="black")
    out = k8.volsdf_render_reference(ws, rays, ts=ts, **kw)[:, :3]
    target = torch.where(keep[:, None], torch.rand(n, 3, device=dev,
                                                   generator=gen),
                         out).contiguous()
    _, got = k8.fused_volsdf_train_step(ws, rays, target, ts,
                                        eikonal_weight=VOLSDF_EIKONAL, **kw)
    _, ref = k8.volsdf_train_step_reference(
        ws, rays, target, ts=ts, eikonal_weight=VOLSDF_EIKONAL, **kw)
    w64 = _float64_witness(k8, ws, rays, ts, target, kw)
    line = " | ".join(f"{name} {e:.2e} ({key})" for name, (e, key) in (
        ("kernel vs plain", _worst(k8, raw, got, ref)),
        ("kernel vs float64", _worst(k8, raw, got, w64)),
        ("plain vs float64", _worst(k8, raw, ref, w64))))
    print(f"[check] K8b-L eikonal float32 floor, {n} rays x {STEPS} "
          f"(kink-free rays {int(keep.sum())}/{n}; not gated): {line}",
          flush=True)


def _check_volsdf_bwd(what, k8, testing, sd, ws, rays, gen, kw,
                      witness=False):
  """K8b in modes G (random g) and L (random target), each without and
  with the eikonal, against autograd through the plain K8f, over all
  rays and over the kink-free rays (see GRAD_RTOL; the learned scale's
  gradient is one of the tensors). Returns the max |Δ| of the kink-free
  gradients."""
  n = rays.shape[0]
  keep = testing.volsdf_kink_free_rays(ws, rays, kw["ts"], kw["steps"],
                                       KINK_MARGIN)
  g = torch.randn(n, 5, device=rays.device, generator=gen)
  target = torch.rand(n, 3, device=rays.device, generator=gen)
  out = k8.volsdf_render_reference(ws, rays, **kw)[:, :3]
  step_kw = {k: v for k, v in kw.items() if k != "ts"}
  raw = sd[k8.SCALE_KEY]
  max_abs = 0.0
  for mode, eik in (("G", False), ("G", True), ("L", False), ("L", True)):
    gm = (g if eik else g[:, :4]).contiguous()
    arg, masked = ((gm, (gm * keep[:, None]).contiguous()) if mode == "G"
                   else (target, torch.where(keep[:, None], target,
                                             out).contiguous()))
    weight = VOLSDF_EIKONAL if eik else 0.0
    line = []
    for name, a in (("all rays", arg), ("kink-free", masked)):
      if mode == "G":
        got = k8.fused_volsdf_render_grad(ws, rays, a, want_eikonal=eik, **kw)
        ref = k8.volsdf_render_grad_reference(ws, rays, a, want_eikonal=eik,
                                              **kw)
      else:
        loss, got = k8.fused_volsdf_train_step(ws, rays, a, kw["ts"],
                                               eikonal_weight=weight,
                                               **step_kw)
        loss_r, ref = k8.volsdf_train_step_reference(
            ws, rays, a, eikonal_weight=weight, **kw)
        loss_rel = abs(float(loss) - float(loss_r)) / abs(float(loss_r))
        if not loss_rel <= LOSS_RTOL:
          raise RuntimeError(f"{what} K8b-L loss {float(loss)} vs plain "
                             f"{float(loss_r)}")
        line.append(f"{name} loss rel {loss_rel:.2e}")
      torch.cuda.synchronize()
      ug, ur = k8.unpack_grads(got, raw), k8.unpack_grads(ref, raw)
      errs = {k: float((ug[k] - ur[k]).norm() / ur[k].norm()) for k in ur}
      key = max(errs, key=errs.get)
      tol = ALL_RAY_RTOL if name == "all rays" else GRAD_RTOL
      if not (errs[key] <= tol and bool(torch.isfinite(got).all())):
        raise RuntimeError(f"{what} K8b-{mode} eikonal {eik} ({name}): "
                           f"gradient of {key} {errs[key]:.3e} from its "
                           f"plain version (tol {tol})")
      line.append(f"{name}: max_t ‖Δ‖/‖ref‖ {errs[key]:.2e} ({key}), scale "
                  f"{errs[k8.SCALE_KEY]:.2e}")
      if name == "kink-free":
        max_abs = max(max_abs, float((got - ref).abs().max()))
        if witness and mode == "L" and eik:
          w64 = _float64_witness(k8, ws, rays, kw["ts"], a, kw)
          (ek, kk), (ep, kp) = (_worst(k8, raw, got, w64),
                                _worst(k8, raw, ref, w64))
          line.append(f"float64 witness: kernel {ek:.2e} ({kk}), plain "
                      f"{ep:.2e} ({kp})")
    print(f"[check] K8b-{mode} eikonal {'on ' if eik else 'off'} {what}: "
          f"{' | '.join(line)} | kink-free rays {int(keep.sum())}/{n}",
          flush=True)
  return max_abs


def _check_volsdf_stash(k8, testing, rays_ops, ws, gen, dev):
  """Phase 3: the signs K8f's eikonal build keeps of the SDF MLP's
  leaky-relu inputs (one block: 2 rays x 64 points, read back from its
  scratch) equal the plain forward's wherever that sign is sure
  (`testing.volsdf_sign_stash`: |z| at least KINK_MARGIN times its
  column's float32-vs-float64 round-off)."""
  rays = torch.from_numpy(_check_rays(2, 5)).to(dev)
  ts = rays_ops.compute_ts(2.0, 6.0, STEPS, perturb=1.0, generator=gen,
                           device=dev)
  got = testing.k8f_sign_stash(ws, rays, ts, sigmoid_kind="upshifted")
  signs, _, sure = testing.volsdf_sign_stash(ws, rays, ts, KINK_MARGIN)
  differ = testing.stash_bits(got) != testing.stash_bits(signs)
  bad, unsure = int((differ & sure).sum()), int((differ & ~sure).sum())
  stash, _ = k8.eikonal_scratch(dev)
  line = (f"[check] K8f eikonal sign stash, 2 rays x {STEPS} (one block, "
          f"two tiles of {k8.SIGN_BYTES} B; the scratch {stash.shape[0]} "
          f"slots, {stash.numel() / 2**20:.2f} MiB): {int(sure.sum())} of "
          f"{sure.numel()} signs sure, {bad} of them differ from the plain "
          f"forward's (tol 0); {unsure} of the rest differ")
  print(line, flush=True)
  if bad or float(sure.float().mean()) < 0.9:
    raise RuntimeError(f"K8f's sign stash disagrees: {line}")


def _check_volsdf(k8, testing, rays_ops, models, driver, dev):
  """Phase 3, VolSDF: K8f in both builds and K8b in both modes, each with
  and without the eikonal, against their plain versions, each K8f line
  also held to the float64 products (`_witness`; the eikonal column on
  its kink-free rays); VolSDFRender against mode G; K8f's and K8b's
  determinism. Returns (K8f max |Δ|, K8b max |Δ|)."""
  sd, seeded, amplified = _volsdf_weights(models, driver, k8, dev)
  gen = torch.Generator(device=dev).manual_seed(12)
  max_f, max_b = 0.0, 0.0
  for steps, n in ((STEPS, 1001), (16, 77)):
    rays = torch.from_numpy(_check_rays(n, steps)).to(dev)
    ts = rays_ops.compute_ts(2.0, 6.0, steps, perturb=1.0, generator=gen,
                             device=dev)
    for (wname, ws), sky, kind in (
        (("seeded", seeded), "black", "upshifted"),
        (("amplified", amplified), "black", "upshifted"),
        (("amplified", amplified), "white", "thin")):
      keep = testing.volsdf_kink_free_rays(ws, rays, ts, steps, KINK_MARGIN)
      for tname, t in (("grid", None), ("jittered ts", ts)):
        for eik in (False, True):
          kw = dict(steps=steps, sigmoid_kind=kind, sky_kind=sky, ts=t,
                    want_eikonal=eik)
          out = k8.fused_volsdf_render(ws, rays, **kw)
          ref = k8.volsdf_render_reference(ws, rays, **kw)
          w64 = testing.volsdf_float64_render(ws, rays, **kw)
          torch.cuda.synchronize()
          e = float((out[:, :4] - ref[:, :4]).abs().max())
          what = (f"K8f {n} rays x {steps} {wname:9s} sky {sky:5s} "
                  f"{kind:9s} {tname:11s} eikonal {'on ' if eik else 'off'}")
          line = (f"[check] {what}: rgb/acc max|Δ| {e:.3e} (tol {TOL:.0e}; "
                  f"ref rgb std {float(ref[:, :3].std()):.3f}) | "
                  + _witness(testing, what, out[:, :4], ref[:, :4],
                             w64[:, :4]))
          ok = e <= TOL and bool(torch.isfinite(out).all())
          if eik:
            # the column's act′ pattern: held to TOL on the kink-free rays,
            # to ALL_RAY_RTOL of its value over all rays
            if t is not None:
              kf = keep
            else:
              kf = testing.volsdf_kink_free_rays(
                  ws, rays, torch.linspace(2.0, 6.0, steps, device=dev),
                  steps, KINK_MARGIN)
            d = (out[:, 4] - ref[:, 4]).abs()
            e_kf = float(d[kf].max())
            rel = float((d / ref[:, 4].abs()).max())
            line += (f" | eikonal column kink-free max|Δ| {e_kf:.3e} (tol "
                     f"{TOL:.0e}, values {float(ref[:, 4].min()):.2f}.."
                     f"{float(ref[:, 4].max()):.2f}), all rays max rel "
                     f"{rel:.2e} (tol {ALL_RAY_RTOL:.0e}), kink-free rays "
                     f"{int(kf.sum())}/{n}; kink-free "
                     + _witness(testing, f"{what}, its eikonal column",
                                out[kf, 4], ref[kf, 4], w64[kf, 4]))
            ok = ok and e_kf <= TOL and rel <= ALL_RAY_RTOL
            e = max(e, e_kf)
          print(line, flush=True)
          if not ok:
            raise RuntimeError(f"K8f disagrees with its reference: {line}")
          max_f = max(max_f, e)
  rays = torch.from_numpy(_check_rays(1001, STEPS)).to(dev)
  for eik in (False, True):
    kw = dict(steps=STEPS, sigmoid_kind="thin", sky_kind="white",
              want_eikonal=eik)
    if not torch.equal(k8.fused_volsdf_render(amplified, rays, **kw),
                       k8.fused_volsdf_render(amplified, rays, **kw)):
      raise RuntimeError(f"two K8f launches differ (eikonal {eik})")
  print("[check] two K8f launches bitwise equal, without and with the "
        "eikonal column", flush=True)
  _check_volsdf_stash(k8, testing, rays_ops, seeded, gen, dev)
  rays = torch.from_numpy(_check_rays(N_CHECK, 0)).to(dev)
  for (wname, ws), sky, kind in (
      (("seeded", seeded), "black", "upshifted"),
      (("amplified", amplified), "white", "thin")):
    ts = rays_ops.compute_ts(2.0, 6.0, STEPS, perturb=1.0, generator=gen,
                             device=dev)
    max_b = max(max_b, _check_volsdf_bwd(
        f"{N_CHECK} rays x {STEPS} {wname:9s} sky {sky:5s} {kind:9s}", k8,
        testing, sd, ws, rays, gen,
        dict(steps=STEPS, sigmoid_kind=kind, sky_kind=sky, ts=ts),
        witness=True))
  _eikonal_floor(k8, testing, sd, amplified, rays_ops, dev)
  rays_r = torch.from_numpy(_check_rays(77, 1)).to(dev)
  ts = rays_ops.compute_ts(2.0, 6.0, 16, perturb=1.0, generator=gen,
                           device=dev)
  kw = dict(steps=16, sigmoid_kind="upshifted", sky_kind="white", ts=ts)
  max_b = max(max_b, _check_volsdf_bwd("ragged 77 rays x 16", k8, testing,
                                       sd, amplified, rays_r, gen, kw))
  g = torch.randn(77, 5, device=dev, generator=gen)
  target = torch.rand(77, 3, device=dev, generator=gen)
  leaf = amplified.clone().requires_grad_(True)
  (k8.fused_volsdf_render_train(leaf, rays_r, ts, steps=16, sky_kind="white",
                                sigmoid_kind="upshifted", want_eikonal=True)
   * g).sum().backward()
  direct = k8.fused_volsdf_render_grad(amplified, rays_r, g,
                                       want_eikonal=True, **kw)
  again = k8.fused_volsdf_render_grad(amplified, rays_r, g,
                                      want_eikonal=True, **kw)
  step_kw = {k: v for k, v in kw.items() if k != "ts"}
  step1 = k8.fused_volsdf_train_step(amplified, rays_r, target, ts,
                                     eikonal_weight=VOLSDF_EIKONAL, **step_kw)
  step2 = k8.fused_volsdf_train_step(amplified, rays_r, target, ts,
                                     eikonal_weight=VOLSDF_EIKONAL, **step_kw)
  if not (torch.equal(leaf.grad, direct) and torch.equal(direct, again)
          and all(torch.equal(a, b) for a, b in zip(step1, step2))):
    raise RuntimeError("VolSDFRender's gradient differs from K8b-G's, or "
                       "two K8b launches differ")
  print("[check] VolSDFRender backward == K8b-G (bitwise, eikonal on); two "
        "K8b-G and two K8b-L launches bitwise equal", flush=True)
  return max_f, max_b


# One run of `--volsdf-repeat`, in a process of its own: argv[1] the
# checkout, whose chip_smoke.py and port it imports. It builds the two
# VolSDF libraries in parallel (one call of each wrapper), then trains with
# a loss logged at every step and hashes the trained parameters.
_VOLSDF_REPEAT_CHILD = r"""
import concurrent.futures, dataclasses, hashlib, json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from nerf_atlas_tpu_torch import models, runner
from nerf_atlas_tpu_torch.data import loaders
from nerf_atlas_tpu_torch.ops.kernels import render as k1
from nerf_atlas_tpu_torch.ops.kernels import render_volsdf as k8
from nerf_atlas_tpu_torch.train import driver
trained = {}
_train = driver.train
def train(model, ds, cfg, **kw):
  out = _train(model, ds, dataclasses.replace(cfg, log_freq=1), **kw)
  h = hashlib.sha256()
  for k, v in sorted(model.state_dict().items()):
    h.update(k.encode())
    h.update(v.detach().cpu().contiguous().numpy().tobytes())
  trained["params"] = h.hexdigest()
  return out
driver.train = train
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
ws = k8.pack_weights(driver.init_model(models.VolSDF(steps=16, device=dev),
                                       seed=0).state_dict(), dev)
rays = torch.tensor([[0.0, 0.0, -4.0, 0.0, 0.0, 1.0]], device=dev)
g = torch.zeros(1, 4, device=dev)
with concurrent.futures.ThreadPoolExecutor(2) as pool:
  list(pool.map(lambda f: f(), [
      lambda: k8.fused_volsdf_render(ws, rays, steps=16),
      lambda: k8.fused_volsdf_render_grad(ws, rays, g, steps=16)]))
torch.cuda.synchronize()
results, secs, counts, black = cs._train_run(
    runner, k1, loaders, dev, cs.TRAIN_STEPS, argv=cs.VOLSDF_TRAIN_ARGV)
print(json.dumps({
    "root": sys.argv[1], "steps": cs.TRAIN_STEPS,
    "path": results["engaged_path"], "seconds": secs,
    "launches": {k: v for k, v in counts.items() if v},
    "losses": [h["loss"] for h in results["history"]],
    "params_sha256": trained["params"],
    "psnr": {s: results[s]["psnr_mean"] for s in ("train", "test")}}))
"""


def _volsdf_repeat(roots) -> int:
  """`--volsdf-repeat`: phase 5g's recipe from each checkout in `roots`,
  one process each, compared with the first run. Returns the exit code:
  1 where two loss curves or two trained models differ."""
  runs = []
  for root in roots:
    proc = subprocess.run(
        [sys.executable, "-c", _VOLSDF_REPEAT_CHILD, os.path.abspath(root)],
        capture_output=True, text=True, cwd=root)
    if proc.returncode != 0:
      raise RuntimeError(f"{root}: rc {proc.returncode}\n"
                         f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    runs.append(r)
    print(f"[volsdf] {r['root']}: {r['steps']} steps, path {r['path']}, "
          f"{r['seconds']:.2f} s, launches {r['launches']} | loss "
          f"{r['losses'][0]!r} -> {r['losses'][-1]!r} | PSNR train "
          f"{r['psnr']['train']!r} test {r['psnr']['test']!r}", flush=True)
  same = True
  a = runs[0]
  for b in runs[1:]:
    losses = a["losses"] == b["losses"]
    params = a["params_sha256"] == b["params_sha256"]
    same = same and losses and params
    print(f"[volsdf] {b['root']} against {a['root']}: loss curves "
          f"{'bit for bit equal' if losses else 'DIFFER'} over "
          f"{len(a['losses'])} steps, trained parameters "
          f"{'bit for bit equal' if params else 'DIFFER'} | test PSNR "
          f"{b['psnr']['test'] - a['psnr']['test']:+.9f} dB, train "
          f"{b['psnr']['train'] - a['psnr']['train']:+.9f} dB", flush=True)
  return 0 if same else 1


def _train_main_volsdf(port_runner, k1, loaders, dev):
  """Phase 5g: the quality sweep's volsdf_eikonal recipe through the
  one-kernel step: K8b (loss mode, the eikonal inside) once per step, K8f
  in eval, nothing else; both splits 2 dB over all-black. Returns the
  launches per kernel."""
  results, secs, counts, black = _train_run(port_runner, k1, loaders, dev,
                                            TRAIN_STEPS,
                                            argv=VOLSDF_TRAIN_ARGV)
  losses = [h["loss"] for h in results["history"]]
  if (results["engaged_path"] != "fused-one-kernel"
      or not all(math.isfinite(v) for v in losses)):
    raise RuntimeError(f"volsdf: path {results['engaged_path']}, losses "
                       f"{losses}")
  for split in ("train", "test"):
    if not results[split]["psnr_mean"] >= black[split] + 2.0:
      raise RuntimeError(f"volsdf {split} PSNR {results[split]['psnr_mean']} "
                         f"does not beat all-black {black[split]} by 2 dB")
  others = {k: v for k, v in counts.items() if k not in ("K8b", "K8f") and v}
  if counts["K8b"] != TRAIN_STEPS or counts["K8f"] <= 0 or others:
    raise RuntimeError(f"volsdf training launched {counts}, expected "
                       f"{TRAIN_STEPS} K8b, K8f in eval and nothing else")
  print(f"[train] runner volsdf_eikonal {TRAIN_STEPS} steps x {BATCH} rays x "
        f"{STEPS} samples (48x48, 30 views): {secs:.2f} s end to end | path "
        f"{results['engaged_path']} | launches K8b {counts['K8b']}, K8f "
        f"{counts['K8f']} | loss (l2 + eikonal) {losses[0]:.5f} -> "
        f"{losses[-1]:.5f} | PSNR train {results['train']['psnr_mean']:.3f} "
        f"test {results['test']['psnr_mean']:.3f} (all-black "
        f"{black['train']:.3f} / {black['test']:.3f})", flush=True)
  return counts


def _volsdf_macs(k8):
  """Multiply-adds per sample point: (forward, backward without the
  eikonal, the eikonal's transpose chain). The backward counts the
  forward again, every weight gradient and the input gradients an
  output needs: not the SDF MLP's onto its init feature (the points and
  B take none) nor the View's onto p and elev/azim. The transpose chain
  is the SDF MLP's input-gradient products for its sdf column (the
  forward's MACs without layer_out, plus its column)."""
  sdf = sum(i * o for name, i, o in k8.LAYERS if name.startswith("shape"))
  view = sum(i * o for name, i, o in k8.LAYERS if name.startswith("refl"))
  skip = (_no_cotangent_macs(k8.LAYERS, "shape.mlp", k8.S_HIDDEN, k8.S_IN)
          + _no_cotangent_macs(k8.LAYERS, "refl.mlp", 128, 5))
  chain = sdf - k8.S_HIDDEN * k8.S_OUT + k8.S_HIDDEN
  return sdf + view, 3 * (sdf + view) - skip, chain


def _volsdf_bound(k8, n: int, mode: str):
  """Bound of one call on n rays x 64 steps: mode "f" (K8f), "f-eik"
  (K8f + the transpose chain), "b" (K8b without the eikonal), "b-eik"
  (K8b with it: + the chain, its adjoint's forward-like products and its
  weight updates, 3 chains); 2 FLOP per multiply-add; bytes: rays, ts,
  dists and the weights in (K8b also its TC pack), [n, 4 or 5] out
  (backward: the target or g in, the gradient out)."""
  from nerf_atlas_tpu_torch.ops.kernels import render as k1
  fwd, bwd, chain = _volsdf_macs(k8)
  pts = n * STEPS
  fixed = 2 * STEPS
  wc = k8.WEIGHT_COUNT
  if mode == "f":
    return _bound_ms(2 * fwd * pts, 4 * (n * 10 + fixed + wc))
  if mode == "f-eik":
    return _bound_ms(2 * (fwd + chain) * pts, 4 * (n * 11 + fixed + wc))
  extra = 3 * chain if mode == "b-eik" else 0
  tc = k1.tc_layout_index(k8.TC_MLPS, wc)[0].numel()
  return _bound_ms(2 * (bwd + extra) * pts,
                   4 * (n * 11 + fixed + 2 * wc + tc))


def _time_volsdf(card, models, driver, loaders, sampler, k8, rays_ops, dev,
                 frame_ds):
  """Phase 6, VolSDF: K8f and plain calls at 65536 x 64 with and without
  the eikonal column, one 800x800 frame, the K8b calls at 4096 x 64 (mode
  L with and without the eikonal, mode G with it) against their plain
  versions (plain, kernel, kernel, plain), and the three train steps at
  the volsdf_eikonal recipe. Returns the numbers of the kernels line."""
  model = driver.init_model(models.VolSDF(steps=STEPS, device=dev,
                                          sigmoid_kind="upshifted"), seed=0)
  ws = k8.pack_weights(model.state_dict(), dev)
  frame_rays = frame_ds.view_rays(0)
  call_rays = frame_rays[:CHUNK].contiguous()
  kw = dict(steps=STEPS, t_near=2.0, t_far=6.0, sigmoid_kind="upshifted")
  fwd_macs, _, chain = _volsdf_macs(k8)
  res = {}
  launches = {k: w.launches for k, w in _wrappers().items()}

  def plain_eik():                    # 8192-ray chunks: the graph of the
    return torch.cat([k8.volsdf_render_reference(   # chain at 65536 rays
        ws, call_rays[i:i + 8192], want_eikonal=True, **kw)   # is ~45 GB
                      for i in range(0, CHUNK, 8192)])

  for eik, tag in ((False, "K8f"), (True, "K8f eikonal")):
    plain = (plain_eik if eik else
             lambda: k8.volsdf_render_reference(ws, call_rays, **kw))
    ms = {}
    for name, fn, reps in (
        ("plain", plain, 1),
        ("kernel", lambda: k8.fused_volsdf_render(ws, call_rays,
                                                  want_eikonal=eik, **kw), 3),
        ("kernel", lambda: k8.fused_volsdf_render(ws, call_rays,
                                                  want_eikonal=eik, **kw), 3),
        ("plain", plain, 1)):
      ms.setdefault(name, []).append(_event_ms(fn, reps))
    bound = _volsdf_bound(k8, CHUNK, "f-eik" if eik else "f")
    tflop = 2 * (fwd_macs + (chain if eik else 0)) * CHUNK * STEPS / 1e12
    res[tag] = (min(ms["kernel"]), min(ms["plain"]), bound)
    print(f"[time] {card}: one {CHUNK}-ray x {STEPS}-step {tag} call "
          f"{ms['kernel'][0]:.2f} / {ms['kernel'][1]:.2f} ms "
          f"({tflop / (min(ms['kernel']) / 1e3):.2f} TFLOP/s; bound "
          f"{bound[0]:.2f} ms, split TF32 {bound[3]:.2f}, bf16 "
          f"{bound[2]:.2f}), plain torch {ms['plain'][0]:.2f} / "
          f"{ms['plain'][1]:.2f} ms", flush=True)

  def ref_frame():
    return torch.cat([k8.volsdf_render_reference(ws, rc, **kw)[:, :3]
                      for rc in frame_rays.split(CHUNK)])

  img_ref, ref_s = _sync_time(ref_frame)
  img_k, k_s = _sync_time(lambda: driver.render_view(model, frame_ds, 0))
  res["frame_err"] = float(np.abs(img_k.reshape(-1, 3)
                                  - img_ref.cpu().numpy()).max())
  if res["frame_err"] > TOL:
    raise RuntimeError(f"800x800 volsdf frame: kernel vs reference "
                       f"{res['frame_err']}")
  print(f"[time] {card}: one {SIZE}x{SIZE}x{STEPS} volsdf frame: render_view "
        f"(K8f) {k_s:.3f} s = {SIZE * SIZE / k_s:,.0f} rays/s, plain torch "
        f"{ref_s:.3f} s = {SIZE * SIZE / ref_s:,.0f} rays/s | frame max diff "
        f"{res['frame_err']:.2e}", flush=True)

  gen = torch.Generator(device=dev).manual_seed(13)
  r4 = call_rays[:BATCH].contiguous()
  ts = rays_ops.compute_ts(2.0, 6.0, STEPS, perturb=1.0, generator=gen,
                           device=dev)
  target = torch.rand(BATCH, 3, device=dev, generator=gen)
  g5 = torch.randn(BATCH, 5, device=dev, generator=gen)
  for tag, mode, kernel, plain in (
      ("K8b-L", "b", lambda: k8.fused_volsdf_train_step(
          ws, r4, target, ts, **kw),
       lambda: k8.volsdf_train_step_reference(ws, r4, target, ts=ts, **kw)),
      ("K8b-L eikonal", "b-eik", lambda: k8.fused_volsdf_train_step(
          ws, r4, target, ts, eikonal_weight=VOLSDF_EIKONAL, **kw),
       lambda: k8.volsdf_train_step_reference(
           ws, r4, target, ts=ts, eikonal_weight=VOLSDF_EIKONAL, **kw)),
      ("K8b-G eikonal", "b-eik", lambda: k8.fused_volsdf_render_grad(
          ws, r4, g5, ts=ts, want_eikonal=True, **kw),
       lambda: k8.volsdf_render_grad_reference(
           ws, r4, g5, ts=ts, want_eikonal=True, **kw))):
    ms = {}
    for name, fn, reps in (("plain", plain, 3), ("kernel", kernel, 5),
                           ("kernel", kernel, 5), ("plain", plain, 3)):
      ms.setdefault(name, []).append(_event_ms(fn, reps))
    bound = _volsdf_bound(k8, BATCH, mode)
    res[tag] = (min(ms["kernel"]), min(ms["plain"]), bound)
    print(f"[time] {card}: one {BATCH}-ray x {STEPS}-step {tag} call "
          f"{ms['kernel'][0]:.2f} / {ms['kernel'][1]:.2f} ms (bound "
          f"{bound[0]:.2f} ms, split TF32 {bound[3]:.2f}, bf16 "
          f"{bound[2]:.2f}), plain torch {ms['plain'][0]:.2f} / "
          f"{ms['plain'][1]:.2f} ms", flush=True)
  for name, w in _wrappers().items():         # timing, not the main path
    w.launches = launches[name]

  ds = sampler.RayDataset.from_bundle(
      loaders.load("", data_kind="synthetic", size=48, num_views=30,
                   device=dev), size=48, device=dev)
  fns = _step_fns(models.VolSDF, driver, ds, dev,
                  reg_coeffs={"eikonal": VOLSDF_EIKONAL}, with_normals=True,
                  sigmoid_kind="upshifted")
  order = ["K3 step", "K1+K2 step", "plain step"]
  labels = {"K3 step": "K8b step", "K1+K2 step": "K8f+K8b step",
            "plain step": "plain step"}
  step_ms = {}
  for name in order + order[::-1]:
    step, _ = fns[name]
    step_ms.setdefault(name, []).append(_event_ms(lambda: step(0, gen), 5))
  for name in order:
    v = step_ms[name]
    print(f"[time] {card}: volsdf {labels[name]} at {BATCH}x{STEPS} "
          f"(eikonal {VOLSDF_EIKONAL}): {v[0]:.2f} / {v[1]:.2f} ms = "
          f"{BATCH / (min(v) / 1e3):,.0f} train rays/s", flush=True)
  return res


def _dyn_weights(models, driver, k9, dev, enc, spline, steps=STEPS):
  """(seeded, amplified) packed weights of a DynamicNeRF at full width with
  the warp active: its zero layer_out replaced by seeded 0.03·N(0, 1)
  weights and 0.01·N(0, 1) biases (numpy's generator); amplified also
  scales the View's output layer by 40, so that rgb spans (0, 1)."""
  sd = dict(driver.init_model(models.DynamicNeRF(
      steps=steps, spline_points=spline, canonical_kwargs={"enc_kind": enc},
      device=dev), seed=0).state_dict())
  rng = np.random.default_rng(3)
  for key, scale in (("warp.layer_out.weight", 0.03),
                     ("warp.layer_out.bias", 0.01)):
    sd[key] = torch.from_numpy((scale * rng.normal(size=tuple(sd[key].shape))
                                ).astype(np.float32)).to(dev)
  amp = dict(sd)
  amp["canonical.refl.mlp.layer_out.weight"] = (
      amp["canonical.refl.mlp.layer_out.weight"] * 40.0)
  return (k9.pack_weights(sd, dev, enc, spline),
          k9.pack_weights(amp, dev, enc, spline))


def _dyn_rays(n: int, seed: int, dev):
  """Rays from (0, 0, 3.5) about −z (they cross the CP box) and each ray's
  time in [0, 1], from numpy's seeded generator."""
  rng = np.random.default_rng(seed)
  r_o = np.tile([[0.0, 0.0, 3.5]], (n, 1))
  r_d = rng.normal(size=(n, 3)) * 0.2 + np.array([0.0, 0.0, -1.0])
  rays = np.concatenate([r_o, r_d], -1).astype(np.float32)
  return (torch.from_numpy(rays).to(dev),
          torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(dev))


def _check_dyn_bwd(what, k9, testing, ws, rays, times, gen, kw):
  """K9b in modes G (random g) and L (random target), each without and
  with the dp² term, against autograd through the plain K9f, over all
  rays and over the rays `testing.dyn_kink_free_rays` clears alone (see
  GRAD_RTOL: the dp² term's cotangent reaches every ray it is given, so
  the kink-free check gives the kernels only the clear rays); the warp's
  and the rigidity's gradients must be non-zero. g is uniform in [0, 1):
  the rigidity's output bias is a one-element tensor, the sum over every
  point of its cotangent, and under a zero-mean g that sum is a random
  walk whose value can fall near 0 while its rounding does not, so its
  relative error has a heavy tail (posenc, spline S = 4, the same
  weights, an H100: 2.67e-4 in one draw, 1.2e-5 in another); a cotangent
  of one sign keeps it away from 0. The kink-free check also holds the
  kernel to the same gradient in float64 (`testing.dyn_float64_grad`),
  tensor by tensor: its distance within twice the plain version's, or
  within the gate (`testing.float64_witness_ratio` with the floor
  GRAD_RTOL / 2), and prints the worst ratio: such sums' float32 floor
  sits near the gate. Returns the max |Δ| of the kink-free gradients."""
  n = rays.shape[0]
  enc, spline = kw["enc_kind"], kw["spline_points"]
  keep = testing.dyn_kink_free_rays(ws, rays, times, kw["ts"], kw["steps"],
                                    enc, spline, KINK_MARGIN)
  g = torch.rand(n, 5, device=rays.device, generator=gen)
  target = torch.rand(n, 3, device=rays.device, generator=gen)
  step_kw = {k: v for k, v in kw.items() if k != "ts"}
  lay = k9.layout(enc, spline)
  max_abs = 0.0
  for mode, dp in (("G", False), ("G", True), ("L", False), ("L", True)):
    arg = ((g if dp else g[:, :4]) if mode == "G" else target).contiguous()
    weight = DNERF_DP if dp else 0.0
    line = []
    for name, sel in (("all rays", slice(None)), ("kink-free", keep)):
      r, t, a = (x[sel].contiguous() for x in (rays, times, arg))
      if mode == "G":
        got = k9.fused_dyn_render_grad(ws, r, t, a, want_dp=dp, **kw)
        ref = k9.dyn_render_grad_reference(ws, r, t, a, want_dp=dp, **kw)
      else:
        loss, got = k9.fused_dyn_train_step(ws, r, t, a, kw["ts"],
                                            dp_weight=weight, **step_kw)
        loss_r, ref = k9.dyn_train_step_reference(ws, r, t, a,
                                                  dp_weight=weight, **kw)
        loss_rel = abs(float(loss) - float(loss_r)) / abs(float(loss_r))
        if not loss_rel <= LOSS_RTOL:
          raise RuntimeError(f"{what} K9b-L loss {float(loss)} vs plain "
                             f"{float(loss_r)}")
        line.append(f"{name} loss rel {loss_rel:.2e}")
      torch.cuda.synchronize()
      ug, ur = (k9.unpack_grads(got, enc, spline),
                k9.unpack_grads(ref, enc, spline))
      errs = {k: float((ug[k] - ur[k]).norm() / ur[k].norm()) for k in ur}
      key = max(errs, key=errs.get)
      tol = ALL_RAY_RTOL if name == "all rays" else GRAD_RTOL
      dead = [k for k in ug if k.startswith(("warp.", "rigidity."))
              and not float(ug[k].norm()) > 0]
      if not (errs[key] <= tol and bool(torch.isfinite(got).all())
              and not dead and not got[:lay.warp_offset].any()):
        raise RuntimeError(f"{what} K9b-{mode} dp {dp} ({name}): gradient "
                           f"of {key} {errs[key]:.3e} from its plain version "
                           f"(tol {tol}); zero warp/rigidity gradients "
                           f"{dead}")
      line.append(f"{name}: max_t ‖Δ‖/‖ref‖ {errs[key]:.2e} ({key}), warp "
                  f"{errs['warp.layer_in.weight']:.2e}, rigidity "
                  f"{errs['rigidity.layer_in.weight']:.2e}")
      if name == "kink-free":
        max_abs = max(max_abs, float((got - ref).abs().max()))
        w64 = testing.dyn_float64_grad(
            ws, r, t, kw["ts"], a, loss_mode=mode == "L", dp_weight=weight,
            spline_points=spline, enc_kind=enc,
            sigmoid_kind=kw.get("sigmoid_kind", "thin"),
            sky_kind=kw.get("sky_kind", "black"))
        ratio, k, ek, ep = testing.float64_witness_ratio(
            lambda x: k9.unpack_grads(x, enc, spline), got, ref, w64,
            GRAD_RTOL / 2)
        if not ratio <= testing.WITNESS_RATIO:
          raise RuntimeError(
              f"{what} K9b-{mode} dp {dp}: {k} lies {ek:.3e} from the "
              f"float64 gradient, its plain version {ep:.3e} (ratio "
              f"{ratio:.2f} with the floor {GRAD_RTOL / 2}; limit "
              f"{testing.WITNESS_RATIO})")
        line.append(f"float64 witness: worst ratio {ratio:.2f} ({k}: "
                    f"kernel {ek:.2e}, plain {ep:.2e})")
    print(f"[check] K9b-{mode} dp {'on ' if dp else 'off'} {what}: "
          f"{' | '.join(line)} | kink-free rays {int(keep.sum())}/{n}",
          flush=True)
  return max_abs


def _check_dyn(k9, testing, rays_ops, models, driver, dev):
  """Phase 3, D-NeRF: in each mode (cp and posenc canonical, Δx and the
  spline at S = 4), K9f with and without its dp² column (each line with
  its float64 witness) and K9b in both modes, each with and without the
  dp² term, against their plain versions at 16384 x 64 and 77 x 16,
  seeded and amplified weights with the warp active; two K9f launches of
  each mode bit for bit; DynRender's gradient against mode G's and two
  K9b launches of each mode bit for bit; the all-ray floor
  (`_dyn_floor`).
  Returns (K9f max |Δ|, K9b max |Δ|)."""
  gen = torch.Generator(device=dev).manual_seed(14)
  max_f, max_b = 0.0, 0.0
  for enc, spline in DNERF_MODES:
    seeded, amplified = _dyn_weights(models, driver, k9, dev, enc, spline)
    for steps, n in ((STEPS, N_DYN_CHECK), (16, 77)):
      rays, times = _dyn_rays(n, steps, dev)
      ts = rays_ops.compute_ts(2.0, 6.0, steps, perturb=1.0, generator=gen,
                               device=dev)
      for (wname, ws), sky, kind in (
          (("seeded", seeded), "black", "thin"),
          (("amplified", amplified), "white", "thin")):
        tag = (f"{enc} {'dx' if spline == 0 else f'spline S={spline}'} "
               f"{n} rays x {steps} {wname:9s} sky {sky:5s}")
        kw = dict(steps=steps, sigmoid_kind=kind, sky_kind=sky,
                  spline_points=spline, enc_kind=enc)
        for tname, t in (("grid", None), ("jittered ts", ts)):
          for dp in (False, True):
            out = k9.fused_dyn_render(ws, rays, times, ts=t, want_dp=dp, **kw)
            ref = k9.dyn_render_reference(ws, rays, times, ts=t, want_dp=dp,
                                          **kw)
            torch.cuda.synchronize()
            e = float((out - ref).abs().max())
            witness = _witness(testing, f"K9f {tag}", out, ref,
                               testing.dyn_float64_render(
                                   ws, rays, times, ts=t, want_dp=dp, **kw))
            line = (f"[check] K9f {tag} {tname:11s} dp {'on ' if dp else 'off'}"
                    f": max|Δ| {e:.3e} (tol {TOL:.0e}; ref rgb std "
                    f"{float(ref[:, :3].std()):.3f}"
                    + (f", dp column max {float(ref[:, 4].max()):.2e}"
                       if dp else "") + f") | {witness}")
            print(line, flush=True)
            if not (e <= TOL and bool(torch.isfinite(out).all())):
              raise RuntimeError(f"K9f disagrees with its reference: {line}")
            if dp and not float(ref[:, 4].max()) > 1e-8:
              raise RuntimeError(f"the warp is not active: {line}")
            max_f = max(max_f, e)
        if steps == STEPS and wname == "amplified":
          # two launches bit for bit (the last line's inputs: dp on)
          again = k9.fused_dyn_render(ws, rays, times, ts=ts, want_dp=True,
                                      **kw)
          if not torch.equal(out, again):
            raise RuntimeError(f"two K9f launches differ: {tag}")
          print(f"[check] K9f {tag}: two launches bitwise equal", flush=True)
        if steps == STEPS or wname == "amplified":
          max_b = max(max_b, _check_dyn_bwd(tag, k9, testing, ws, rays,
                                            times, gen, dict(kw, ts=ts)))
  # the autograd Function's backward is K9b-G; two launches bit for bit
  _, ws = _dyn_weights(models, driver, k9, dev, "cp", DNERF_SPLINE)
  rays, times = _dyn_rays(77, 1, dev)
  ts = rays_ops.compute_ts(2.0, 6.0, 16, perturb=1.0, generator=gen,
                           device=dev)
  kw = dict(steps=16, sky_kind="white", spline_points=DNERF_SPLINE,
            enc_kind="cp")
  g = torch.randn(77, 5, device=dev, generator=gen)
  target = torch.rand(77, 3, device=dev, generator=gen)
  leaf = ws.clone().requires_grad_(True)
  (k9.fused_dyn_render_train(leaf, rays, times, ts, want_dp=True, **kw)
   * g).sum().backward()
  direct = k9.fused_dyn_render_grad(ws, rays, times, g, ts=ts, want_dp=True,
                                    **kw)
  again = k9.fused_dyn_render_grad(ws, rays, times, g, ts=ts, want_dp=True,
                                   **kw)
  step1 = k9.fused_dyn_train_step(ws, rays, times, target, ts,
                                  dp_weight=DNERF_DP, **kw)
  step2 = k9.fused_dyn_train_step(ws, rays, times, target, ts,
                                  dp_weight=DNERF_DP, **kw)
  if not (torch.equal(leaf.grad, direct) and torch.equal(direct, again)
          and all(torch.equal(a, b) for a, b in zip(step1, step2))):
    raise RuntimeError("DynRender's gradient differs from K9b-G's, or two "
                       "K9b launches differ")
  print("[check] DynRender backward == K9b-G (bitwise, dp on); two K9b-G "
        "and two K9b-L launches bitwise equal", flush=True)
  _dyn_floor(k9, models, driver, rays_ops, dev)
  return max_f, max_b


def _dyn_floor(k9, models, driver, rays_ops, dev):
  """Printed, not gated: K9b-G (random g) over all rays at 4096 x 64,
  against its plain version and both against the plain version in
  float64 on the same float32 warp features, for cp Δx, cp spline and
  posenc Δx with amplified weights: how far each float32 implementation
  lies from the same function, the floor under the all-ray gate."""
  from nerf_atlas_tpu_torch.ops import integrate
  from nerf_atlas_tpu_torch.ops.kernels import render as k1
  gen = torch.Generator(device=dev).manual_seed(16)
  for enc, spline in (("cp", 0), ("cp", DNERF_SPLINE), ("posenc", 0)):
    _, ws = _dyn_weights(models, driver, k9, dev, enc, spline)
    rays, times = _dyn_rays(N_CHECK, STEPS, dev)
    ts = rays_ops.compute_ts(2.0, 6.0, STEPS, perturb=1.0, generator=gen,
                             device=dev)
    g = torch.randn(N_CHECK, 4, device=dev, generator=gen)
    kw = dict(steps=STEPS, sky_kind="white", spline_points=spline,
              enc_kind=enc, ts=ts)
    got = k9.fused_dyn_render_grad(ws, rays, times, g, **kw)
    ref = k9.dyn_render_grad_reference(ws, rays, times, g, **kw)
    lay = k9.layout(enc, spline)
    pts = k1.hash_pts(rays, ts)
    x_in = pts if spline else torch.cat(
        [pts, times[:, None].expand(-1, STEPS).reshape(-1, 1)], -1)
    init32 = k9.warp_init_feature(x_in, ws[:lay.warp_offset].view(
        lay.w_in, -1))
    w64 = ws.double().requires_grad_(True)
    with torch.enable_grad():
      dens, rgb, _, _ = k9.dyn_chain(w64, rays.double(), times.double(),
                                     ts.double(), lay, spline, "thin",
                                     warp_init=init32.double())
      out = k1.composite(dens, rgb, rays[:, 3:6].double(),
                         integrate.dists_from_ts(ts.double()), "white")
      (w64g,) = torch.autograd.grad(out, w64, g.double())

    def worst(a, b):
      ua = k9.unpack_grads(a.double(), enc, spline)
      ub = k9.unpack_grads(b.double(), enc, spline)
      errs = {k: float((ua[k] - ub[k]).norm() / ub[k].norm()) for k in ub}
      key = max(errs, key=errs.get)
      return f"{errs[key]:.2e} ({key})"

    print(f"[check] K9b-G all-ray float32 floor, {enc} "
          f"{'dx' if spline == 0 else f'spline S={spline}'} {N_CHECK} rays x "
          f"{STEPS} amplified (not gated): kernel vs plain "
          f"{worst(got, ref)} | kernel vs float64 {worst(got, w64g)} | "
          f"plain vs float64 {worst(ref, w64g)}", flush=True)


def _train_main_dyn(port_runner, k1, loaders, dev, tag, argv, steps):
  """Phases 5h / 5i: a D-NeRF recipe through the one-kernel step: K9b
  (loss mode) once per step, K9f in eval, nothing else; both splits 2 dB
  over all-black. Returns the launches per kernel."""
  results, secs, counts, black = _train_run(port_runner, k1, loaders, dev,
                                            steps, argv=argv)
  losses = _check_trained(results, black)
  others = {k: v for k, v in counts.items() if k not in ("K9b", "K9f") and v}
  if counts["K9b"] != steps or counts["K9f"] <= 0 or others:
    raise RuntimeError(f"{tag} training launched {counts}, expected {steps} "
                       "K9b, K9f in eval and nothing else")
  print(f"[train] runner {tag} {steps} steps x {BATCH} rays x {STEPS} "
        f"samples (48x48, 30 views): {secs:.2f} s end to end | path "
        f"{results['engaged_path']} | launches K9b {counts['K9b']}, K9f "
        f"{counts['K9f']} | loss {losses[0]:.5f} -> {losses[-1]:.5f} | PSNR "
        f"train {results['train']['psnr_mean']:.3f} test "
        f"{results['test']['psnr_mean']:.3f} (all-black "
        f"{black['train']:.3f} / {black['test']:.3f})", flush=True)
  return counts


def _dyn_macs(k9, enc: str, spline: int):
  """Multiply-adds per sample point: (forward, backward). The forward
  counts the warp at its real width (3 or 3·(S − 1) outputs; the kernel
  also computes the spline's padding columns, which no output needs), the
  rigidity MLP and the canonical density and View MLPs. The backward
  counts the forward again, every weight gradient and the input gradients
  an output needs: not the warp's nor the rigidity's onto their init
  features (the points are leaves, B is fixed) nor the View's onto
  elev/azim; the density MLP's and the View's onto x' are needed."""
  from nerf_atlas_tpu_torch.ops.kernels import render as k1
  lay = k9.layout(enc, spline)
  out_w = 3 if spline == 0 else 3 * (spline - 1)
  warp = [(n, i, out_w if n.endswith("layer_out") else o)
          for n, i, o in lay.warp_layers]
  canon = k1.LAYOUTS[enc]
  layers = warp + list(lay.rig_layers) + [
      (f"canonical.{n}", i, o)
      for n, i, o in canon.density_layers + canon.refl_layers]
  fwd = sum(i * o for _, i, o in layers)
  skip = (_no_cotangent_macs(layers, "warp", k9.W_HIDDEN, lay.w_in + 64)
          + _no_cotangent_macs(layers, "rigidity", k9.G_HIDDEN, 3)
          + _no_cotangent_macs(layers, "canonical.refl.mlp", k1.R_HIDDEN, 2))
  return fwd, 3 * fwd - skip


def _dyn_bound(k9, enc: str, spline: int, n: int, backward: bool):
  """Bound of one K9f (backward: K9b) call on n rays x 64 steps: 2 FLOP per
  multiply-add (`_dyn_macs`); bytes: rays, times, ts, dists and the
  weights in, [n, 4 or 5] out (backward: the target or g in, the TC pack
  too, the gradient out)."""
  from nerf_atlas_tpu_torch.ops.kernels import render as k1
  fwd, bwd = _dyn_macs(k9, enc, spline)
  lay = k9.layout(enc, spline)
  wc = lay.weight_count
  pts = n * STEPS
  if backward:
    tc = k1.tc_layout_index(lay.tc_mlps, wc)[0].numel()
    return _bound_ms(2 * bwd * pts, 4 * (n * 12 + 2 * STEPS + 2 * wc + tc))
  return _bound_ms(2 * fwd * pts, 4 * (n * 12 + 2 * STEPS + wc))


def _time_dyn(card, models, driver, loaders, sampler, k9, rays_ops, dev):
  """Phase 6, D-NeRF, for the cp Δx and the spline S = 4 modes: K9f and its
  plain version per 65536 x 64 call with and without the dp² column,
  K9b-L and K9b-G per 4096 x 64 call with and without the dp² term
  (plain, kernel, kernel); one 800x800 frame of the Δx model; the
  three train steps of each recipe at 4096 x 64. Returns {(tag, kernel):
  (ms, plain ms, bound)} and the frame's max difference."""
  res = {}
  frame = sampler.RayDataset.from_bundle(
      loaders.load("", data_kind="synthetic-dyn", size=SIZE, num_views=2,
                   device=dev), size=SIZE, device=dev)
  frame_rays = frame.view_rays(1)
  call_rays = frame_rays[:CHUNK].contiguous()
  call_t = torch.full((CHUNK,), float(frame.times[1]), device=dev)
  gen = torch.Generator(device=dev).manual_seed(15)
  launches = {k: w.launches for k, w in _wrappers().items()}
  for enc, spline in (("cp", 0), ("cp", DNERF_SPLINE)):
    tag = "dx" if spline == 0 else f"spline S={spline}"
    _, ws = _dyn_weights(models, driver, k9, dev, enc, spline)
    kw = dict(steps=STEPS, spline_points=spline, enc_kind=enc)
    fwd_macs, _ = _dyn_macs(k9, enc, spline)
    for dp in (False, True):
      ms = {}
      for name, fn, reps in (
          ("plain", lambda: k9.dyn_render_reference(
              ws, call_rays, call_t, want_dp=dp, **kw), 1),
          ("kernel", lambda: k9.fused_dyn_render(ws, call_rays, call_t,
                                                 want_dp=dp, **kw), 3),
          ("kernel", lambda: k9.fused_dyn_render(ws, call_rays, call_t,
                                                 want_dp=dp, **kw), 3),
          ("plain", lambda: k9.dyn_render_reference(
              ws, call_rays, call_t, want_dp=dp, **kw), 1)):
        ms.setdefault(name, []).append(_event_ms(fn, reps))
      bound = _dyn_bound(k9, enc, spline, CHUNK, False)
      key = (tag, "K9f dp" if dp else "K9f")
      res[key] = (min(ms["kernel"]), min(ms["plain"]), bound)
      tflop = 2 * fwd_macs * CHUNK * STEPS / 1e12
      print(f"[time] {card}: D-NeRF {tag}: one {CHUNK}-ray x {STEPS}-step "
            f"{key[1]} call {ms['kernel'][0]:.2f} / {ms['kernel'][1]:.2f} ms "
            f"({tflop / (min(ms['kernel']) / 1e3):.2f} TFLOP/s; bound "
            f"{bound[0]:.2f} ms by {bound[1]}, split TF32 {bound[3]:.2f}, "
            f"bf16 {bound[2]:.2f}), plain torch {ms['plain'][0]:.2f} / "
            f"{ms['plain'][1]:.2f} ms", flush=True)
    r4 = call_rays[:BATCH].contiguous()
    t4 = torch.rand(BATCH, device=dev, generator=gen)
    ts = rays_ops.compute_ts(2.0, 6.0, STEPS, perturb=1.0, generator=gen,
                             device=dev)
    target = torch.rand(BATCH, 3, device=dev, generator=gen)
    g5 = torch.randn(BATCH, 5, device=dev, generator=gen)
    for name_k, dp in (("K9b-L", False), ("K9b-L dp", True),
                       ("K9b-G", False), ("K9b-G dp", True)):
      if name_k.startswith("K9b-L"):
        w = DNERF_DP if dp else 0.0
        kernel = (lambda w=w: k9.fused_dyn_train_step(
            ws, r4, t4, target, ts, dp_weight=w, **kw))
        plain = (lambda w=w: k9.dyn_train_step_reference(
            ws, r4, t4, target, ts=ts, dp_weight=w, **kw))
      else:
        gg = (g5 if dp else g5[:, :4]).contiguous()
        kernel = (lambda gg=gg, dp=dp: k9.fused_dyn_render_grad(
            ws, r4, t4, gg, ts=ts, want_dp=dp, **kw))
        plain = (lambda gg=gg, dp=dp: k9.dyn_render_grad_reference(
            ws, r4, t4, gg, ts=ts, want_dp=dp, **kw))
      ms = {}
      # the plain K9b (~0.8 s a call) takes one turn, before the kernel's
      # two: its second turn went to keep the run inside its time limit
      for name, fn, reps in (("plain", plain, 1), ("kernel", kernel, 5),
                             ("kernel", kernel, 5)):
        ms.setdefault(name, []).append(_event_ms(fn, reps))
      bound = _dyn_bound(k9, enc, spline, BATCH, True)
      res[(tag, name_k)] = (min(ms["kernel"]), ms["plain"][0], bound)
      print(f"[time] {card}: D-NeRF {tag}: one {BATCH}-ray x {STEPS}-step "
            f"{name_k} call {ms['kernel'][0]:.2f} / {ms['kernel'][1]:.2f} ms "
            f"(bound {bound[0]:.2f} ms by {bound[1]}, split TF32 "
            f"{bound[3]:.2f}, bf16 {bound[2]:.2f}), plain torch "
            f"{ms['plain'][0]:.2f} ms", flush=True)
  for name, w in _wrappers().items():         # timing, not the main path
    w.launches = launches[name]

  model = driver.init_model(models.DynamicNeRF(steps=STEPS, device=dev),
                            seed=0)
  with torch.no_grad():
    _, amp = _dyn_weights(models, driver, k9, dev, "cp", 0)
    model.load_state_dict({**model.state_dict(),
                           **k9.unpack_grads(amp, "cp", 0)})
  ws = k9.pack_weights(model.state_dict(), dev, "cp", 0)
  t_frame = torch.full((frame_rays.shape[0],), float(frame.times[1]),
                       device=dev)

  def ref_frame():
    return torch.cat([k9.dyn_render_reference(
        ws, rc, tc, steps=STEPS)[:, :3] for rc, tc in zip(
            frame_rays.split(CHUNK), t_frame.split(CHUNK))])

  img_ref, ref_s = _sync_time(ref_frame)
  img_k, k_s = _sync_time(lambda: driver.render_view(model, frame, 1))
  res["frame_err"] = float(np.abs(img_k.reshape(-1, 3)
                                  - img_ref.cpu().numpy()).max())
  if res["frame_err"] > TOL:
    raise RuntimeError(f"800x800 D-NeRF frame: kernel vs reference "
                       f"{res['frame_err']}")
  print(f"[time] {card}: one {SIZE}x{SIZE}x{STEPS} D-NeRF dx frame (view 1, "
        f"t = {float(frame.times[1]):.1f}): render_view (K9f) {k_s:.3f} s = "
        f"{SIZE * SIZE / k_s:,.0f} rays/s, plain torch {ref_s:.3f} s = "
        f"{SIZE * SIZE / ref_s:,.0f} rays/s | frame max diff "
        f"{res['frame_err']:.2e}", flush=True)

  ds = sampler.RayDataset.from_bundle(
      loaders.load("", data_kind="synthetic-dyn", size=48, num_views=30,
                   device=dev), size=48, device=dev)
  for tag, model_kw, regs in (
      ("dnerf_dx", {}, {}),
      ("dnerf_spline_dp", dict(spline_points=DNERF_SPLINE),
       {"delta_x": DNERF_DP})):
    fns = _step_fns(models.DynamicNeRF, driver, ds, dev, reg_coeffs=regs,
                    **model_kw)
    order = ["K3 step", "K1+K2 step", "plain step"]
    labels = {"K3 step": "K9b step", "K1+K2 step": "K9f+K9b step",
              "plain step": "plain step"}
    step_ms = {}
    for name in order + order[::-1]:
      step, _ = fns[name]
      step_ms.setdefault(name, []).append(_event_ms(lambda: step(0, gen), 5))
    for name in order:
      v = step_ms[name]
      print(f"[time] {card}: {tag} {labels[name]} at {BATCH}x{STEPS}: "
            f"{v[0]:.2f} / {v[1]:.2f} ms = {BATCH / (min(v) / 1e3):,.0f} "
            "train rays/s", flush=True)
  return res


def _family_model(models, driver, cls: str, kw: dict):
  """A dynamic-family model on the CPU at full width, seed 0, its warp
  active (`_dyn_weights`' seeded layer_out)."""
  model = driver.init_model(getattr(models, cls)(steps=STEPS, **kw), seed=0)
  rng = np.random.default_rng(3)
  with torch.no_grad():
    for p, scale in ((model.warp.layer_out.weight, 0.03),
                     (model.warp.layer_out.bias, 0.01)):
      p.copy_(torch.from_numpy((scale * rng.normal(size=tuple(p.shape))
                                ).astype(np.float32)))
  return model


def _grad_gap(got: dict, ref: dict):
  """(worst ‖Δ‖/‖ref‖ over the tensors, its name). A tensor whose gradient
  vanishes (a bias that cancels between a term's times: round-off on both
  sides) is held against 1e-3 of the largest tensor's norm."""
  scale = max(float(g.norm()) for g in ref.values())
  if scale == 0.0:                    # a term that is 0 (spline point 0 of
    zero = all(float(g.abs().max()) == 0 for g in got.values())  # a Bezier)
    return (0.0 if zero else math.inf), None
  worst = (-1.0, None)
  for k, r in ref.items():
    err = float((got[k].cpu() - r).norm() / max(float(r.norm()),
                                                1e-3 * scale))
    worst = max(worst, (err, k), key=lambda x: x[0])
  return worst


def _reg_on_both(fn, cpu, gpu, dev):
  """fn(model, to) -> a scalar regularizer, on the CPU model and its card
  copy: (CPU value, card value, gradient gap)."""
  vals, grads = [], []
  for model, to in ((cpu, lambda x: x), (gpu, lambda x: x.to(dev))):
    model.zero_grad()
    val = fn(model, to)
    val.backward()
    vals.append(float(val.detach()))
    grads.append({k: p.grad for k, p in model.named_parameters()
                  if p.grad is not None})
  if grads[0].keys() != grads[1].keys():
    raise RuntimeError("the card and the CPU differentiate other tensors")
  return vals[0], vals[1], _grad_gap(grads[1], grads[0])


def _check_family(models, driver, regularizers, dev):
  """Phase 3n: the module forward on the card against the same module on
  the CPU (the same state_dict, FAMILY_RAYS rays x 64 steps, the same
  times) for DynamicNeRFAE, LongDynamicNeRF, DynamicNeRF with an 8-wide
  time latent over plain-cp and over the tiny, ae and coarse_fine
  canonicals: rgb, dp and rigidity within TOL. Then each dynamic
  regularizer on the same draws (`regularizers`' draw functions from one
  CPU generator): the out-dict ones (offset, rigidity sparsity) on the
  time-latent model's forward, the point-sampled ones on it and on the
  LongDynamicNeRF; values within FAMILY_REG_RTOL, parameter gradients
  within ALL_RAY_RTOL (`_grad_gap`). No kernel runs."""
  rays, times = _dyn_rays(FAMILY_RAYS, 31, "cpu")
  kept = {}
  for tag, cls, kw in FAMILY_CASES:
    cpu = _family_model(models, driver, cls, kw)
    gpu = copy.deepcopy(cpu).to(dev)
    with torch.no_grad():
      ref = cpu(rays, times=times)
      got = gpu(rays.to(dev), times=times.to(dev))
    errs = {k: float((got[k].cpu() - ref[k]).abs().max())
            for k in ("rgb", "dp", "rigidity") if k in ref}
    line = ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
    print(f"[check] {tag} module forward, card vs CPU, {FAMILY_RAYS} rays x "
          f"{STEPS}: max |Δ| {line} (max |dp| "
          f"{float(ref['dp'].abs().max()):.3e})", flush=True)
    if max(errs.values()) > TOL or float(ref["dp"].abs().max()) <= 1e-4:
      raise RuntimeError(f"{tag}: the card's forward differs: {errs}")
    if cls in ("LongDynamicNeRF",) or "time_latent_size" in kw:
      kept[tag] = (cpu, gpu)
  latent = kept["DynamicNeRF time latent 8 plain-cp"]
  for name in ("offset", "rigidity_sparsity"):
    term = regularizers.REGULARIZERS[name]
    checks = [(name, "DynamicNeRF time latent 8 plain-cp", latent,
               lambda m, to, term=term: term(m(to(rays), times=to(times))))]
    _check_regs(checks, dev)
  for name in ("dyn_divergence", "ffjord_div", "spline_length",
               "spline_pt0"):
    draws, term = regularizers.POINT_REGULARIZERS[name]
    d = draws(torch.Generator().manual_seed(41))
    _check_regs([(name, tag, pair, lambda m, to, term=term, d=d: term(
        m, *(to(x) for x in d))) for tag, pair in kept.items()], dev)


def _check_regs(checks, dev):
  for name, tag, (cpu, gpu), fn in checks:
    v_cpu, v_gpu, (gap, worst) = _reg_on_both(fn, cpu, gpu, dev)
    rel = abs(v_gpu - v_cpu) / max(abs(v_cpu), 1e-30)
    print(f"[check] regularizer {name} on {tag}, card vs CPU: value "
          f"{v_gpu:.6e} vs {v_cpu:.6e} ({rel:.2e} relative), parameter "
          f"gradients worst {gap:.2e} relative ({worst})", flush=True)
    if rel > FAMILY_REG_RTOL or gap > ALL_RAY_RTOL:
      raise RuntimeError(f"regularizer {name} on {tag}: the card differs")


def _render_module(port_runner, models, tag, *extra):
  """Phases 4k / 4l: the runner's 800x800 render of a model outside the
  kernels (1 view x 2 splits at its time): module forwards, no kernel."""
  (results, secs, counts), forwards = _module_forwards(
      models, lambda: _render_main(port_runner, "--data-kind",
                                   "synthetic-dyn", "--num-views", "1",
                                   *extra))
  launched = {k: v for k, v in counts.items() if v}
  if launched or forwards <= 0:
    raise RuntimeError(f"the {tag} render launched {launched} and ran "
                       f"{forwards} module forwards")
  print(f"[main] runner {tag} {SIZE}x{SIZE}x{STEPS}, 1 view x 2 splits: "
        f"{secs:.2f} s end to end (incl. ground-truth render + PNGs), "
        f"{2 * SIZE * SIZE / secs:,.0f} rays/s | kernel launches 0, module "
        f"forwards {forwards} | PSNR train "
        f"{results['train']['psnr_mean']:.3f} test "
        f"{results['test']['psnr_mean']:.3f}", flush=True)


def _render_over_time(port_runner, models):
  """Phase 4m, dnerf-over-time-800: --render-over-time 0 --render-frames
  4 --render-bezier-keyframes of the spline S = 4 D-NeRF at 800x800: K9f
  once per 65536-ray chunk of each of the 4 frames and 4 keyframes,
  nothing else, no module forward, the 8 PNGs written."""
  chunks = -(-SIZE * SIZE // CHUNK)
  with tempfile.TemporaryDirectory() as outdir:
    argv = ["--data-kind", "synthetic-dyn", "--size", str(SIZE),
            "--num-views", "1", "--epochs", "0", "--dyn-model", "plain",
            "--spline", str(DNERF_SPLINE), "--render-over-time", "0",
            "--render-frames", "4", "--render-bezier-keyframes",
            "--notraintest", "--notest", "--outdir", outdir]
    ((_, secs), counts), forwards = _module_forwards(
        models, lambda: _counted(
            lambda: _sync_time(lambda: port_runner.main(argv))))
    names = ([f"over_time_{i:03d}.png" for i in range(4)]
             + [f"keyframe_{i:02d}.png" for i in range(DNERF_SPLINE)])
    missing = [n for n in names if not os.path.exists(os.path.join(outdir,
                                                                   n))]
  others = {k: v for k, v in counts.items() if k != "K9f" and v}
  if (counts["K9f"] != 8 * chunks or others or forwards or missing):
    raise RuntimeError(f"the render over time launched {counts}, ran "
                       f"{forwards} module forwards, missed {missing}")
  print(f"[main] runner dnerf-over-time {SIZE}x{SIZE}x{STEPS}, 4 frames + "
        f"{DNERF_SPLINE} keyframes: {secs:.2f} s end to end (incl. PNGs), "
        f"{8 * SIZE * SIZE / secs:,.0f} rays/s | K9f launches "
        f"{counts['K9f']} ({chunks} a frame), other kernels 0, module "
        f"forwards 0", flush=True)


def _train_main_dyn_regs(port_runner, k1, loaders, dev):
  """Phase 5k, dnerf-spline-reg-train-4096: the dnerf_spline_dp recipe
  with the point-sampled regularizers through the two-kernel path: K9f
  with its dp² column and K9b-G once per step, K9f in eval, nothing else
  trains; both splits 2 dB over all-black; the flow and rigidity maps of
  every view and clusters.png written. Returns the launches per kernel."""
  views = range(30)
  outputs = ([f"{split}/{m}_{v:03d}.png" for split in ("train", "test")
              for m in ("flow", "rigidity") for v in views]
             + ["clusters.png"])
  steps = DNERF_SPLINE_STEPS
  results, secs, counts, black = _train_run(
      port_runner, k1, loaders, dev, steps, extra=DNERF_REG_EVAL,
      argv=DNERF_REG_ARGV, outputs=outputs)
  losses = _check_trained(results, black, path="fused")
  eval_k9f = counts["K9f"] - counts["K9f-dp"]
  others = {k: v for k, v in counts.items()
            if k not in ("K9f", "K9f-dp", "K9b-G") and v}
  if (counts["K9f-dp"] != steps or counts["K9b-G"] != steps
      or eval_k9f <= 0 or others):
    raise RuntimeError(f"the spline regularizer training launched {counts}, "
                       f"expected {steps} K9f with the dp column and K9b-G, "
                       "K9f in eval and nothing else")
  print(f"[train] runner dnerf_spline_dp + spline length, spline point 0, "
        f"divergence {steps} steps x {BATCH} rays x {STEPS} samples (48x48, "
        f"30 views): {secs:.2f} s end to end | path "
        f"{results['engaged_path']} | launches K9f+dp {counts['K9f-dp']}, "
        f"K9b-G {counts['K9b-G']}, K9f {eval_k9f} in eval | loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f} | PSNR train "
        f"{results['train']['psnr_mean']:.3f} test "
        f"{results['test']['psnr_mean']:.3f} (all-black "
        f"{black['train']:.3f} / {black['test']:.3f}) | flow, rigidity "
        f"maps and clusters.png written", flush=True)
  return counts


def _march_clear(value, rays, near, far, steps):
  """Bool [n] on the CPU: the rays whose scan decisions cannot flip
  between two float32 evaluations (SDF_MARGIN's rule above)."""
  o, d = rays[:, :3], rays[:, 3:6]
  ts = near + ((far - near) / steps) * torch.arange(1, steps + 1,
                                                    dtype=torch.float32)
  ts = torch.cat([torch.tensor([near]), ts])
  with torch.no_grad():
    sd = value(o[:, None] + ts[:, None] * d[:, None])
  two = torch.topk(sd, 2, dim=-1, largest=False).values
  return (sd.abs() > SDF_MARGIN).all(-1) & (two[:, 1] - two[:, 0]
                                            > SDF_MARGIN)


def _check_sdf_family(port_runner, models, driver, loaders, k1, dev):
  """Phase 3s, beside phase 2: the SDF renderer (`--model sdf`'s model,
  seed 0) for each shape kind with bisect and for the MLP shape with
  secant and sphere marching, card against CPU (SDF_MARGIN's rule above);
  then --volsdf-alternate --alt-train 1 (ALT_STEPS steps of the
  volsdf_eikonal recipe, no eval) and a VolSDF-SIREN render's normals,
  depth and depth-query normal maps at MAPS_SIZE (1 view x 2 splits).
  No kernel launches."""
  rays = torch.from_numpy(_check_rays(SDF_CHECK_RAYS, 37))
  cases = ([(kind, "bisect") for kind in SDF_KINDS]
           + [("mlp", "secant"), ("mlp", "sphere")])
  for kind, isect in cases:
    cpu = driver.init_model(models.SDF(sdf_kind=kind, isect_kind=isect),
                            seed=0)
    gpu = copy.deepcopy(cpu).to(dev)
    with torch.no_grad():
      (ref, got), counts = _counted(lambda: [
          m(r) for m, r in ((cpu, rays), (gpu, rays.to(dev)))])
    if got["rgb"].device.type != "cuda" or any(counts.values()):
      raise RuntimeError(f"sdf {kind} {isect}: on {got['rgb'].device}, "
                         f"launches {counts}")
    keep = _march_clear(cpu.value, rays, cpu.t_near, cpu.t_far,
                        cpu.march_steps)
    got = {k: v.detach().cpu() for k, v in got.items()}
    ref = {k: v.detach() for k, v in ref.items()}
    drift = ""
    if isect == "sphere":
      # t sums the field's values step by step; where |∇sdf| > 1 the two
      # devices' round-off grows along the march, so the shading is held
      # at the card's own end points
      drift = (f" | end points {float((got['pts'] - ref['pts']).abs().max()):.3e}"
               " apart")
      pts = got["pts"]
      with torch.no_grad():
        sd, latent = cpu.shape(pts)
        n = cpu.normals(pts)
        view = rays[:, 3:6] / rays[:, 3:6].norm(dim=-1, keepdim=True)
        rgb = cpu.refl(pts, view=view, normal=n, latent=latent)
      ref.update(pts=pts, normals=n,
                 rgb=torch.where(got["hits"][:, None], rgb, 0.0),
                 throughput=torch.sigmoid(-cpu.alpha * sd[:, None]))
      keep = torch.ones_like(keep)
    flips = int((got["hits"] != ref["hits"])[keep].sum())
    err = {k: float((got[k] - ref[k])[keep].abs().max())
           for k in ("rgb", "pts", "throughput")}
    n_rel = float((got["normals"] - ref["normals"])[keep].norm()
                  / ref["normals"][keep].norm())
    print(f"[check] sdf {kind} ({isect}, bounded, 128 scan steps), card vs "
          f"CPU, {int(keep.sum())} of {SDF_CHECK_RAYS} rays clear: hits "
          f"{int(ref['hits'][keep].sum())}, flipped {flips} | max |Δ| rgb "
          f"{err['rgb']:.3e}, pts {err['pts']:.3e}, throughput "
          f"{err['throughput']:.3e} | normals {n_rel:.3e} relative{drift}",
          flush=True)
    if (flips > (SDF_CHECK_RAYS // 50 if isect == "sphere" else 0)
        or keep.sum() < SDF_CHECK_RAYS // 2 or err["rgb"] > TOL
        or err["pts"] > TOL or err["throughput"] > SDF_TPUT_TOL
        or n_rel > ALL_RAY_RTOL):
      raise RuntimeError(f"sdf {kind} {isect}: the card differs")

  with _log_every_step(driver):
    results, secs, counts, _ = _train_run(
        port_runner, k1, loaders, dev, ALT_STEPS,
        extra=("--volsdf-alternate", "--alt-train", "1", "--notraintest",
               "--notest"), argv=VOLSDF_TRAIN_ARGV)
  losses = [h["loss"] for h in results["history"]]
  launched = {k: v for k, v in counts.items() if v}
  if (results["engaged_path"] != "oracle" or launched
      or len(losses) != ALT_STEPS
      or not all(math.isfinite(v) for v in losses)):
    raise RuntimeError(f"volsdf-alternate: path {results['engaged_path']}, "
                       f"launches {launched}, losses {losses}")
  print(f"[train] runner volsdf_eikonal --volsdf-alternate --alt-train 1, "
        f"{ALT_STEPS} steps x {BATCH} rays (volume and surface in turn): "
        f"{secs:.2f} s | path {results['engaged_path']} | kernel launches 0 "
        f"| losses volume {losses[0]:.5f}, surface {losses[1]:.5f} -> "
        f"{losses[-2]:.5f}, {losses[-1]:.5f}", flush=True)

  maps = ("normals_000.png", "query_normals_000.png", "depth_000.png")
  with tempfile.TemporaryDirectory() as outdir:
    argv = ["--data-kind", "synthetic", "--model", "volsdf", "--sdf-kind",
            "siren", "--sdf-eikonal", "0.01", "--size", str(MAPS_SIZE),
            "--num-views", "1", "--epochs", "0", "--normals-images",
            "--depth-query-normal", "--visualize", "depth", "--outdir",
            outdir]
    ((_, secs), counts), forwards = _module_forwards(models, lambda: _counted(
        lambda: _sync_time(lambda: port_runner.main(argv))))
    missing = [f"{s}/{m}" for s in ("train", "test") for m in maps
               if not os.path.exists(os.path.join(outdir, s, m))]
  launched = {k: v for k, v in counts.items() if v}
  if missing or launched or forwards <= 0:
    raise RuntimeError(f"the maps: missing {missing}, launches {launched}, "
                       f"{forwards} module forwards")
  print(f"[main] runner volsdf-siren {MAPS_SIZE}x{MAPS_SIZE}, 1 view x 2 "
        f"splits with the normals, depth and depth-query normal maps: "
        f"{secs:.2f} s | kernel launches 0, module forwards {forwards}",
        flush=True)


def _train_main_sdf(port_runner, k1, loaders, driver, dev):
  """Phase 5s, beside phase 2: `--model sdf` at the sdf_surface recipe
  (SDF_STEPS steps, logged every step) through the module forward: no
  kernel launched, each loss finite with its last-10 mean under its
  first-10 mean, both splits scored against all-black and the normals
  map of every view written (--normals-images)."""
  outputs = [f"{s}/normals_{v:03d}.png" for s in ("train", "test")
             for v in range(30)]
  with _log_every_step(driver):
    results, secs, counts, black = _train_run(
        port_runner, k1, loaders, dev, SDF_STEPS,
        extra=("--normals-images",), argv=SDF_TRAIN_ARGV, outputs=outputs)
  losses = [h["loss"] for h in results["history"]]
  launched = {k: v for k, v in counts.items() if v}
  first, last = np.mean(losses[:10]), np.mean(losses[-10:])
  if (results["engaged_path"] != "oracle" or launched
      or not all(math.isfinite(v) for v in losses) or not last < first):
    raise RuntimeError(f"sdf_surface: path {results['engaged_path']}, "
                       f"launches {launched}, losses {losses}")
  print(f"[train] runner sdf_surface (--model sdf --sdf-kind mlp, bisect, "
        f"128 scan steps) {SDF_STEPS} steps x {BATCH} rays (48x48, 30 "
        f"views): {secs:.2f} s end to end | path {results['engaged_path']} | "
        f"kernel launches 0 | loss (l2 + silhouette BCE) mean of the first 10 "
        f"{first:.5f} -> last 10 {last:.5f} | PSNR train "
        f"{results['train']['psnr_mean']:.3f} test "
        f"{results['test']['psnr_mean']:.3f} (all-black "
        f"{black['train']:.3f} / {black['test']:.3f}) | normals maps "
        f"written", flush=True)


def _train_main_volsdf_smooth(port_runner, k1, loaders, dev):
  """Phase 5v, volsdf-smooth-train-4096: the volsdf_eikonal recipe with
  --smooth-normals-weight 1e-3 (VOLSDF_SMOOTH_STEPS steps) through the
  two-kernel path: K8f with its eikonal column and K8b-G once per step,
  the smoothness term by autograd beside them, K8f (without the column)
  in eval, nothing else; the loss falling. Returns the launches per
  kernel."""
  steps = VOLSDF_SMOOTH_STEPS
  results, secs, counts, black = _train_run(port_runner, k1, loaders, dev,
                                            steps, argv=VOLSDF_SMOOTH_ARGV)
  losses = [h["loss"] for h in results["history"]]
  eval_k8f = counts["K8f"] - counts["K8f-eik"]
  others = {k: v for k, v in counts.items()
            if k not in ("K8f", "K8f-eik", "K8b-G") and v}
  if (results["engaged_path"] != "fused"
      or not all(math.isfinite(v) for v in losses)
      or not losses[-1] < losses[0] or counts["K8f-eik"] != steps
      or counts["K8b-G"] != steps or eval_k8f <= 0 or others):
    raise RuntimeError(f"volsdf smooth: path {results['engaged_path']}, "
                       f"launches {counts}, losses {losses}")
  print(f"[train] runner volsdf_eikonal + --smooth-normals-weight 1e-3, "
        f"{steps} steps x {BATCH} rays x {STEPS} samples (48x48, 30 views): "
        f"{secs:.2f} s end to end | path {results['engaged_path']} | "
        f"launches K8f+eikonal {counts['K8f-eik']}, K8b-G {counts['K8b-G']}, "
        f"K8f {eval_k8f} in eval | loss (l2 + eikonal + smoothness) "
        f"{losses[0]:.5f} -> {losses[-1]:.5f} | PSNR train "
        f"{results['train']['psnr_mean']:.3f} test "
        f"{results['test']['psnr_mean']:.3f} (all-black "
        f"{black['train']:.3f} / {black['test']:.3f})", flush=True)
  return counts


@contextlib.contextmanager
def _log_every_step(driver):
  """The port's TrainConfig logging every step (log_freq 1) while the
  block runs: the runner logs every 50 by default."""
  cls = driver.TrainConfig
  driver.TrainConfig = functools.partial(cls, log_freq=1)
  try:
    yield
  finally:
    driver.TrainConfig = cls


def _train_main_oracle(port_runner, k1, loaders, driver, dev, tag, extra,
                       steps):
  """Phases 5l-5n: a dynamic-family run at the sweep's 48x48 / 4096 x 64
  shape through the module forward (`oracle`): no kernel launched, each
  step's loss finite, the mean of the last 10 under that of the first 10,
  results.txt written for both splits."""
  with _log_every_step(driver):
    results, secs, counts, black = _train_run(
        port_runner, k1, loaders, dev, steps, argv=DNERF_TRAIN_ARGV + extra,
        outputs=("train/results.txt", "test/results.txt"))
  losses = [h["loss"] for h in results["history"]]
  launched = {k: v for k, v in counts.items() if v}
  first, last = np.mean(losses[:10]), np.mean(losses[-10:])
  if (results["engaged_path"] != "oracle" or launched
      or not all(math.isfinite(v) for v in losses) or not last < first):
    raise RuntimeError(f"{tag}: path {results['engaged_path']}, launches "
                       f"{launched}, losses {losses}")
  print(f"[train] runner {tag} ({' '.join(extra)}) {len(losses)} steps x "
        f"{BATCH} rays x {STEPS} samples (48x48, 30 views): {secs:.2f} s end "
        f"to end | path {results['engaged_path']} | kernel launches 0 | "
        f"loss mean of the first 10 {first:.5f} -> last 10 {last:.5f} | "
        f"PSNR train {results['train']['psnr_mean']:.3f} test "
        f"{results['test']['psnr_mean']:.3f} (all-black "
        f"{black['train']:.3f} / {black['test']:.3f})", flush=True)


def _captured_fixtures(testing, root, dev):
  """Phase 5o's scenes (beside phase 2): the procedural scene rendered on
  the card and written in each dataset's on-disk format at its native
  size, every PNG row r filtered by r mod 5 (zlib level 1)."""
  t0 = time.perf_counter()
  kw = dict(device=dev, level=1, chunk=1 << 18)
  testing.write_nerf_synthetic(os.path.join(root, "lego"), *CAPTURED_VIEWS,
                               CAPTURED_SIZE, **kw)
  testing.write_nerf_synthetic(os.path.join(root, "jumpingjacks"),
                               *CAPTURED_VIEWS, CAPTURED_SIZE, dynamic=True,
                               **kw)
  testing.write_dtu(os.path.join(root, "scan97"), DTU_VIEWS, DTU_W, DTU_H,
                    **kw)
  print(f"[data] fixtures: NeRF-synthetic and D-NeRF {CAPTURED_VIEWS[0]} + "
        f"{CAPTURED_VIEWS[1]} views at {CAPTURED_SIZE}x{CAPTURED_SIZE} RGBA, "
        f"DTU {DTU_VIEWS} views at {DTU_W}x{DTU_H} RGB + masks, rendered and "
        f"written in {time.perf_counter() - t0:.2f} s", flush=True)


@contextlib.contextmanager
def _timed_loads(port_runner):
  """The runner's `load`, timed while the block runs: yields a list that
  gains (split, seconds, views, all-black PSNR) per call."""
  inner, record = port_runner.load, []

  def load(path, data_kind=None, training=True, **kw):
    t0 = time.perf_counter()
    bundle = inner(path, data_kind=data_kind, training=training, **kw)
    px = bundle.labels[0] if isinstance(bundle.labels, tuple) else \
        bundle.labels
    record.append(("train" if training else "test",
                   time.perf_counter() - t0, len(px),
                   _black_psnr(torch.as_tensor(px))))
    return bundle

  port_runner.load = load
  try:
    yield record
  finally:
    port_runner.load = inner


def _captured_run(port_runner, root, scene, argv, steps):
  """One runner call on a phase-5o scene -> (results, wall s, launches,
  loads)."""
  with tempfile.TemporaryDirectory() as outdir, \
      _timed_loads(port_runner) as loads:
    full = ["-d", os.path.join(root, scene), *argv, "--epochs", str(steps),
            "--seed", "0", "--nosave", "--valid-freq", "0", "--outdir",
            outdir]
    (results, secs), counts = _counted(
        lambda: _sync_time(lambda: port_runner.main(full)))
  return results, secs, counts, loads


def _loads_text(loads) -> str:
  return ", ".join(f"{split} {n} views {secs:.2f} s"
                   for split, secs, n, _ in loads)


def _captured(port_runner, root):
  """Phase 5o: the makefile's dataset recipes on the on-disk scenes, then
  BASELINE config #1 (module docstring). Returns the launches per
  kernel, summed over the runs."""
  total = {}
  for tag, scene, argv, train_k, eval_k in CAPTURED_RUNS:
    results, secs, counts, loads = _captured_run(port_runner, root, scene,
                                                 argv, CAPTURED_STEPS)
    losses = [h["loss"] for h in results["history"]]
    black = {split: b for split, _, _, b in loads}
    others = {k: v for k, v in counts.items()
              if k not in (train_k, eval_k) and v}
    if (results["engaged_path"] != "fused-one-kernel"
        or counts[train_k] != CAPTURED_STEPS or counts[eval_k] <= 0
        or others or not all(math.isfinite(v) for v in losses)
        or not losses[-1] < losses[0]
        or not results["train"]["psnr_mean"] >= black["train"] + 2.0):
      raise RuntimeError(f"captured {tag}: path {results['engaged_path']}, "
                         f"launches {counts}, losses {losses}, PSNR train "
                         f"{results['train']['psnr_mean']} (all-black "
                         f"{black['train']})")
    print(f"[captured] {tag} ({' '.join(argv[2:])}) {CAPTURED_STEPS} steps: "
          f"{secs:.2f} s end to end | decode + resize: {_loads_text(loads)} "
          f"| path {results['engaged_path']} | launches {train_k}-"
          f"{'cone' if train_k == 'K3' else 'L'} {counts[train_k]}, {eval_k}"
          f"{'-cone' if eval_k == 'K1' else ''} {counts[eval_k]} in eval | loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f} | PSNR train "
          f"{results['train']['psnr_mean']:.3f} test "
          f"{results['test']['psnr_mean']:.3f} (all-black "
          f"{black['train']:.3f} / {black['test']:.3f})", flush=True)
    for k, v in counts.items():
      total[k] = total.get(k, 0) + v
  style = os.path.join(root, "lego", "test", "r_0.png")
  results, secs, counts, loads = _captured_run(
      port_runner, root, "lego", CROP_ARGV + ["--style-img", style],
      CROP_STEPS)
  losses = [h["loss"] for h in results["history"]]
  # eval renders each view in one K1-tiny call (64x64 < 65536 rays)
  eval_views = sum(len(results[split]["psnrs"]) for split in
                   ("train", "test"))
  trained = {k: v for k, v in counts.items() if v}
  trained["K1"] = trained.get("K1", 0) - eval_views
  trained = {k: v for k, v in trained.items() if v}
  ssims = results["test"]["ssims"]
  if (results["engaged_path"] != "oracle" or trained
      or not all(math.isfinite(v) for v in losses)
      or len(ssims) != CAPTURED_VIEWS[1]
      or not all(math.isfinite(v) for v in ssims)):
    raise RuntimeError(f"captured crop run: path {results['engaged_path']}, "
                       f"launches {counts}, losses {losses}, MS-SSIM {ssims}")
  print(f"[captured] BASELINE config #1 ({' '.join(CROP_ARGV[2:])} "
        f"--style-img <test view 0>) {CROP_STEPS} steps: {secs:.2f} s end to "
        f"end | decode + resize: {_loads_text(loads)} | path "
        f"{results['engaged_path']} | kernel launches in training 0 (K1 "
        f"{counts['K1']} in eval, one per view) | loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f} | PSNR train {results['train']['psnr_mean']:.3f} "
        f"test {results['test']['psnr_mean']:.3f} | MS-SSIM train "
        f"{np.mean(results['train']['ssims']):.4f} test "
        f"{np.mean(ssims):.4f}", flush=True)
  return total


def _decode_views(views: int) -> int:
  """`--decode-views N`: one NeRF-synthetic split of N views at 800x800
  RGBA written as phase 5o writes it, and its load timed."""
  from nerf_atlas_tpu_torch import testing
  from nerf_atlas_tpu_torch.data import loaders
  root = tempfile.mkdtemp(prefix="decode_")
  try:
    t0 = time.perf_counter()
    testing.write_nerf_synthetic(root, views, 1, CAPTURED_SIZE,
                                 device=torch.device("cuda"), level=1,
                                 chunk=1 << 18)
    t1 = time.perf_counter()
    bundle = loaders.load(root, "original", training=True, size=128)
    t2 = time.perf_counter()
    bundle = loaders.load(root, "original", training=True, size=800)
    t3 = time.perf_counter()
  finally:
    shutil.rmtree(root, ignore_errors=True)
  print(f"[data] {views} views at {CAPTURED_SIZE}x{CAPTURED_SIZE} RGBA (rows "
        f"filtered r mod 5): written in {t1 - t0:.2f} s; loaded (decode + "
        f"INTER_AREA to 128) in {t2 - t1:.2f} s, (decode alone, size 800) in "
        f"{t3 - t2:.2f} s; labels {tuple(bundle.labels.shape)} on "
        f"{os.cpu_count()} host cores", flush=True)
  return 0


# phase 7's recipes: (name, argv, steps, QUALITY_r05 record or None)
QUALITY_RECIPES = (
    ("plain_cp", TRAIN_ARGV, QUALITY_STEPS, None),
    ("plain_hash", HASH_TRAIN_ARGV, QUALITY_STEPS, QUALITY_R05_HASH),
    ("ae", AE_TRAIN_ARGV, QUALITY_STEPS, QUALITY_R05_AE),
    ("plain_posenc", POSENC_TRAIN_ARGV, QUALITY_STEPS, QUALITY_R05_POSENC),
    ("plain_mip_cone", MIP_TRAIN_ARGV, QUALITY_STEPS, QUALITY_R05_MIP),
    # tiny trains the sweep's EPOCH_MULT = 2 times the budget
    ("tiny", TINY_TRAIN_ARGV, 2 * QUALITY_STEPS, QUALITY_R05_TINY),
    ("volsdf_eikonal", VOLSDF_TRAIN_ARGV, QUALITY_STEPS, QUALITY_R05_VOLSDF),
    ("dnerf_dx", DNERF_TRAIN_ARGV, QUALITY_STEPS, QUALITY_R05_DNERF),
    ("dnerf_spline_dp", DNERF_SPLINE_ARGV, QUALITY_STEPS,
     QUALITY_R05_DNERF_SPLINE),
    ("coarse_fine_mip", CF_TRAIN_ARGV, QUALITY_STEPS, QUALITY_R05_CF),
    ("sdf_surface", SDF_TRAIN_ARGV, QUALITY_STEPS, QUALITY_R05_SDF),
    ("volsdf_smooth", VOLSDF_SMOOTH_ARGV, QUALITY_STEPS, None))


def _quality(card, port_runner, k1, loaders, dev, seeds, recipes=None,
             budget=QUALITY_STEPS):
  """Phase 7: each sweep recipe's budget (`recipes`: their names, default
  all; `budget` in place of the sweep's 1500 steps, tiny keeping its 2x)
  on the kernel path for each seed, and plain_cp with --no-fused for the
  first; prints both splits' PSNR and the wall time of each run. The
  D-NeRF recipes must beat all-black by 2 dB on both splits."""
  runs = []
  for name, argv, steps, record in QUALITY_RECIPES:
    if recipes and name not in recipes:
      continue
    steps = steps * budget // QUALITY_STEPS
    runs += [(name, seeds[0], (), argv, steps, record)]
    if name == "plain_cp":
      runs += [(name, seeds[0], ("--no-fused",), argv, steps, record)]
    runs += [(name, seed, (), argv, steps, record) for seed in seeds[1:]]
  for name, seed, extra, argv, steps, record in runs:
    results, secs, _, black = _train_run(
        port_runner, k1, loaders, dev, steps,
        ("--seed", str(seed), *extra), argv=argv)
    note = (f" (QUALITY_r05 {name}, TPU: {record[0]} / {record[1]})"
            if record else "")
    print(f"[quality] {card}: {name} {steps} steps, seed {seed}, path "
          f"{results['engaged_path']}: PSNR train "
          f"{results['train']['psnr_mean']:.3f} test "
          f"{results['test']['psnr_mean']:.3f} (all-black "
          f"{black['train']:.3f} / {black['test']:.3f}) in {secs:.1f} s"
          f"{note}", flush=True)
    if name.startswith("dnerf"):
      _check_trained(results, black)
    if name == "coarse_fine_mip":
      _check_trained(results, black, path="fused")


def _trace(fn, warm: int = 2):
  """torch.profiler over one call of fn after `warm` untraced calls:
  (untraced seconds, traced wall seconds, {kernel name: (count, us)})."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  untraced = [_sync_time(fn)[1] for _ in range(warm)]
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    _, wall = _sync_time(fn)
  by_name = {}
  for e in prof.events():
    if e.device_type == DeviceType.CUDA:
      n, us = by_name.get(e.name, (0, 0.0))
      by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
  return untraced, wall, by_name


def _print_shares(tag, by_name, busy, top=6):
  for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
    print(f"[profile]   {tag}: {us / 1e6 / busy:8.4%} of device time: {n} x "
          f"{us / n / 1e3:.3f} ms  {name[:80]}", flush=True)
  if not by_name:
    print(f"[profile]   {tag}: no device events in the trace: per-kernel "
          "shares not measured", flush=True)


def _profile(card, model, ds, ws):
  """Phase 8, render half: one traced frame through render_view, host-side
  costs of the serving path, and the card's clock and power under load."""
  from nerf_atlas_tpu_torch.data import loaders
  from nerf_atlas_tpu_torch.ops.kernels import render as k1
  from nerf_atlas_tpu_torch.train import driver

  frames, wall, by_name = _trace(lambda: driver.render_view(model, ds, 0))
  busy = sum(us for _, us in by_name.values()) / 1e6
  print(f"[profile] {card}: render_view frames {frames[0]:.4f} / "
        f"{frames[1]:.4f} s untraced; traced {wall:.4f} s wall, device "
        f"busy {busy:.4f} s, idle share "
        f"{(1 - busy / wall if busy else float('nan')):.4f}", flush=True)
  _print_shares("frame", by_name, busy, top=5)

  img = driver.render_view(model, ds, 0)
  sd = model.state_dict()
  pack_ms = 1e3 * _mean_s(lambda: k1.pack_weights(sd, ws.device))
  rays_ms = 1e3 * _mean_s(lambda: ds.view_rays(0))
  with tempfile.TemporaryDirectory() as d:
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    png_s = _mean_s(lambda: driver.write_png(os.path.join(d, "f.png"), u8), 3)
  gt_s = _sync_time(lambda: loaders.load(
      "", data_kind="synthetic", size=SIZE, num_views=2,
      device=ws.device))[1]
  print(f"[profile] host: pack_weights {pack_ms:.3f} ms, view_rays "
        f"{rays_ms:.3f} ms per frame; write_png {png_s:.4f} s per "
        f"{SIZE}x{SIZE} image; ground truth for 2 views {gt_s:.4f} s "
        f"(set-up)", flush=True)

  big = ds.view_rays(0)[:4 * CHUNK].contiguous()
  kw = dict(steps=STEPS, t_near=2.0, t_far=6.0)
  k1.plain_cp_render(ws, big, **kw)                    # warm-up
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(3):
    k1.plain_cp_render(ws, big, **kw)
  end.record()
  smi = subprocess.run(                                # read while K1 runs
      ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  torch.cuda.synchronize()
  ms = start.elapsed_time(end) / 3
  tflops = 2 * 459520 * big.shape[0] * STEPS / ms / 1e9
  print(f"[profile] {card}: one {big.shape[0]}-ray x {STEPS}-step K1 call "
        f"{ms:.2f} ms = {tflops:.2f} TFLOP/s; under load: "
        f"{smi.stdout.strip()}", flush=True)


def _profile_train(card, model_cls, driver, loaders, sampler, dev,
                   tag="K3", reg_coeffs=None, data_kind="synthetic",
                   **model_kw):
  """Phase 8, train half: one traced one-kernel train step at batch 4096
  (device idle share; shares of K3 or K7b, its reduction, K5f/K5b for
  hash, sampling and Adam) and the host time per step."""
  ds = sampler.RayDataset.from_bundle(
      loaders.load("", data_kind=data_kind, size=48, num_views=30,
                   device=dev), size=48, device=dev)
  step, _ = _step_fns(model_cls, driver, ds, dev, reg_coeffs=reg_coeffs,
                      **model_kw)["K3 step"]
  gen = torch.Generator(device=dev).manual_seed(2)
  untraced, wall, by_name = _trace(lambda: step(0, gen), warm=3)
  busy = sum(us for _, us in by_name.values()) / 1e6

  def share(*keys):
    us = sum(us for n, (_, us) in by_name.items()
             if any(k in n.lower() for k in keys))
    return us / 1e6 / busy if busy else float("nan")

  print(f"[profile] {card}: {tag} train step {untraced[-1] * 1e3:.2f} ms "
        f"untraced; traced {wall * 1e3:.2f} ms wall, device busy "
        f"{busy * 1e3:.2f} ms, idle share "
        f"{(1 - busy / wall if busy else float('nan')):.4f}; shares: K3 "
        f"{share('render_bwd_kernel'):.4f}, K7b "
        f"{share('render_ae_bwd_kernel'):.4f}, K8b "
        f"{share('render_volsdf_bwd_kernel'):.4f}, K9b "
        f"{share('render_dyn_bwd_kernel'):.4f}, reduction "
        f"{share('reduce_partials'):.4f}, K5f {share('hash_fwd'):.4f}, K5b "
        f"{share('hash_bwd'):.4f}, Adam "
        f"{share('adam', 'foreach', 'lerp', 'addcdiv', 'sqrt'):.4f}, "
        f"sampling {share('randint', 'uniform', 'index', 'gather'):.4f}",
        flush=True)
  _print_shares(f"{tag} train step", by_name, busy, top=8)
  # host time: enqueue of one step without waiting on the device
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  step(0, gen)
  host = time.perf_counter() - t0
  torch.cuda.synchronize()
  print(f"[profile] host: {host * 1e3:.2f} ms to issue one {tag} train step "
        "(sampling, weight packing, kernel launch, gradient unpacking, "
        "Adam)", flush=True)


def _profile_frame(card, model, ds, tag):
  """Phase 8, hash and ae render: one traced 800x800 frame through
  render_view (hash: K5f + K1-hash per chunk; ae: K7f)."""
  from nerf_atlas_tpu_torch.train import driver
  frames, wall, by_name = _trace(lambda: driver.render_view(model, ds, 0))
  busy = sum(us for _, us in by_name.values()) / 1e6
  print(f"[profile] {card}: {tag} render_view frames {frames[0]:.4f} / "
        f"{frames[1]:.4f} s untraced; traced {wall:.4f} s wall, device "
        f"busy {busy:.4f} s, idle share "
        f"{(1 - busy / wall if busy else float('nan')):.4f}", flush=True)
  _print_shares(f"{tag} frame", by_name, busy, top=5)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--profile", action="store_true",
                      help="add phase 8, the traced frame and train step")
  parser.add_argument("--quality", action="store_true",
                      help="add phase 7, the quality sweep's training runs")
  parser.add_argument("--seeds", type=int, nargs="+", default=[0],
                      help="phase 7's seeds: the kernel path for each, "
                           "--no-fused for the first")
  parser.add_argument("--recipes", nargs="+", default=None,
                      choices=[r[0] for r in QUALITY_RECIPES],
                      help="phase 7's recipes (default: all)")
  parser.add_argument("--sass-against", metavar="DIR", default=None,
                      help="phase 2 also builds the libraries this slice "
                           "leaves unchanged from DIR (a checkout of an "
                           "earlier commit) and compares their SASS")
  parser.add_argument("--k5f-against", metavar="ROOT", nargs="+",
                      default=None,
                      help="run only K5f from this tree and from each "
                           "ROOT: checks and timings (`_k5f_against`)")
  parser.add_argument("--volsdf-repeat", metavar="ROOT", nargs="+",
                      default=None,
                      help="run only phase 5g's recipe from each checkout "
                           "ROOT and compare the runs (module docstring)")
  parser.add_argument("--decode-views", type=int, default=None,
                      metavar="N",
                      help="run only the load of an N-view 800x800 RGBA "
                           "NeRF-synthetic split (`_decode_views`)")
  parser.add_argument("--quality-only", action="store_true",
                      help="run phase 1 and then only phase 7 (the kernels "
                           "its recipes launch build as they are first "
                           "called)")
  parser.add_argument("--quality-steps", type=int, default=QUALITY_STEPS,
                      help="phase 7's budget in place of the sweep's 1500 "
                           "steps (tiny trains twice it), e.g. 300 for the "
                           "spread of phase 5's runs over seeds")
  args = parser.parse_args(argv)
  t_start = time.perf_counter()
  # ---- 1. device ----
  if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  card = smi.stdout.strip().splitlines()[0]
  print(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | count {torch.cuda.device_count()}",
        flush=True)
  torch.backends.cuda.matmul.allow_tf32 = False     # the reference's matmuls
  torch.backends.cudnn.allow_tf32 = False
  print(f"[phase] 1 {time.perf_counter() - t_start:.1f} s", flush=True)
  if args.volsdf_repeat:
    return _volsdf_repeat(args.volsdf_repeat)
  if args.k5f_against:
    return _k5f_against(card, args.k5f_against)
  if args.decode_views:
    return _decode_views(args.decode_views)

  from nerf_atlas_tpu_torch import models, testing
  from nerf_atlas_tpu_torch import runner as port_runner
  from nerf_atlas_tpu_torch.data import loaders, sampler
  from nerf_atlas_tpu_torch.ops import rays as rays_ops
  from nerf_atlas_tpu_torch.ops import sampling
  from nerf_atlas_tpu_torch.ops.kernels import build
  from nerf_atlas_tpu_torch.ops.kernels import hash_encode as hk
  from nerf_atlas_tpu_torch.ops.kernels import render as k1
  from nerf_atlas_tpu_torch.ops.kernels import render_ae as k7
  from nerf_atlas_tpu_torch.ops.kernels import render_dyn as k9
  from nerf_atlas_tpu_torch.ops.kernels import render_volsdf as k8
  from nerf_atlas_tpu_torch.train import driver, regularizers
  if args.quality_only:
    _quality(card, port_runner, k1, loaders, torch.device("cuda"),
             args.seeds, args.recipes, args.quality_steps)
    print(card)
    return 0

  # ---- 2. build, and beside it the phases that launch no kernel ----
  pending = _build_start(build, k1, k8, k9)
  dev = torch.device("cuda")
  # 3n: the dynamic family's module forwards and regularizers, card vs CPU
  _phase("3n", _check_family, models, driver, regularizers, dev)
  # 4k / 4l: dnerf-ae-render-800, long-render-800 (module forwards)
  _phase("4k", _render_module, port_runner, models, "dnerf-ae", "--model",
         "ae", "--dyn-model", "ae")
  _phase("4l", _render_module, port_runner, models, "long", "--model",
         "plain", "--dyn-model", "long", "--long-vid-segments", "4")
  # 5l-5n: the module-forward train paths of the family
  for pid, tag, extra, steps in ORACLE_RUNS:
    _phase(pid, _train_main_oracle, port_runner, k1, loaders, driver, dev,
           tag, extra, steps)
  # 5s / 3s: the SDF renderer's training run, the SDF family's module
  # forwards card vs CPU, --volsdf-alternate and the normals maps
  _phase("5s", _train_main_sdf, port_runner, k1, loaders, driver, dev)
  _phase("3s", _check_sdf_family, port_runner, models, driver, loaders, k1,
         dev)
  # 5o's on-disk scenes
  captured_root = tempfile.mkdtemp(prefix="captured_")
  _phase("5o-fixtures", _captured_fixtures, testing, captured_root, dev)
  jobs, built = _build_finish(build, pending)

  # ---- 3. kernels vs reference on the card ----
  model = driver.init_model(models.PlainNeRF(steps=STEPS, device=dev),
                            seed=0)
  ws = k1.pack_weights(model.state_dict(), dev)
  max_err, max_bwd = _phase("3", _check_kernels, k1, testing, rays_ops,
                            model, dev)
  max_k5f, max_k5b = _phase("3-hash", _check_hash_encoder, hk, k1, testing,
                            dev)
  max_err_h, max_bwd_h = _phase("3-hash-render", _check_hash_render, k1, hk,
                                rays_ops, models, driver, dev)
  max_k7f, max_k7b = _phase("3-ae", _check_ae, k7, testing, rays_ops,
                            models, driver, dev)
  max_k4 = _phase("3-k4", _check_k4, k1, testing, rays_ops, models, driver,
                  dev)
  max_k8f, max_k8b = _phase("3-volsdf", _check_volsdf, k8, testing,
                            rays_ops, models, driver, dev)
  max_k9f, max_k9b = _phase("3-dyn", _check_dyn, k9, testing, rays_ops,
                            models, driver, dev)
  max_cf = _phase("3-coarse_fine", _check_coarse_fine, k1, sampling, models,
                  driver, dev)

  # ---- 4. main path, render: the port's runner at 800x800 ----
  t_phase = time.perf_counter()
  results, secs, counts = _render_main(port_runner)
  launches = counts["K1"]
  if launches <= 0:
    raise RuntimeError("the main path never launched K1")
  n_rays = 2 * 2 * SIZE * SIZE
  print(f"[main] runner {SIZE}x{SIZE}x{STEPS}, 2 views x 2 splits: "
        f"{secs:.2f} s end to end (incl. ground-truth render + PNGs), "
        f"{n_rays / secs:,.0f} rays/s | K1 launches {launches} | PSNR train "
        f"{results['train']['psnr_mean']:.3f} test "
        f"{results['test']['psnr_mean']:.3f}", flush=True)
  print(f"[phase] 4 {time.perf_counter() - t_phase:.1f} s", flush=True)
  # ---- 4b. the same with the hash grid at T = 2^19 ----
  t_phase = time.perf_counter()
  results, secs, render_h = _render_main(port_runner, "--enc-kind", "hash")
  if render_h["K5f"] <= 0 or render_h["K1-hash"] != render_h["K5f"]:
    raise RuntimeError(f"the hash render launched {render_h}")
  print(f"[main] runner hash T=2^19 {SIZE}x{SIZE}x{STEPS}, 2 views x 2 "
        f"splits: {secs:.2f} s end to end (incl. ground-truth render + PNGs), "
        f"{n_rays / secs:,.0f} rays/s | K5f launches {render_h['K5f']}, "
        f"K1-hash launches {render_h['K1-hash']} | PSNR train "
        f"{results['train']['psnr_mean']:.3f} test "
        f"{results['test']['psnr_mean']:.3f}", flush=True)
  print(f"[phase] 4b {time.perf_counter() - t_phase:.1f} s", flush=True)
  # ---- 4c. the same for NeRFAE ----
  t_phase = time.perf_counter()
  results, secs, render_ae = _render_main(port_runner, "--model", "ae",
                                          "--normalize-latent")
  others = {k: v for k, v in render_ae.items() if k != "K7f" and v}
  if render_ae["K7f"] <= 0 or others:
    raise RuntimeError(f"the ae render launched {render_ae}")
  print(f"[main] runner ae {SIZE}x{SIZE}x{STEPS}, 2 views x 2 splits: "
        f"{secs:.2f} s end to end (incl. ground-truth render + PNGs), "
        f"{n_rays / secs:,.0f} rays/s | K7f launches {render_ae['K7f']}, K1 "
        f"launches {render_ae['K1']} | PSNR train "
        f"{results['train']['psnr_mean']:.3f} test "
        f"{results['test']['psnr_mean']:.3f}", flush=True)
  print(f"[phase] 4c {time.perf_counter() - t_phase:.1f} s", flush=True)

  # ---- 4d-4f. the same for the K4 families ----
  render_k4 = {
      "posenc": _phase("4d-posenc", _render_main_k4, port_runner, models,
                       "posenc", "--enc-kind", "posenc"),
      "cone": _phase("4e-cone", _render_main_k4, port_runner, models, "cone",
                     "--mip", "cone"),
      "cylinder": _phase("4e-cylinder", _render_main_k4, port_runner, models,
                         "cylinder", "--mip", "cylinder"),
      "tiny": _phase("4f-tiny", _render_main_k4, port_runner, models, "tiny",
                     "--model", "tiny")}
  # ---- 4g. the same for VolSDF at the volsdf_eikonal recipe's model ----
  render_k8 = _phase("4g", _render_main_k4, port_runner, models, "volsdf",
                     "--model", "volsdf", "--sigmoid-kind", "upshifted",
                     kernel="K8f", every=True)
  # ---- 4h. dnerf-render-800: D-NeRF (Δx) at each view's time ----
  render_k9 = _phase("4h", _render_main_k4, port_runner, models, "dnerf",
                     "--data-kind", "synthetic-dyn", "--dyn-model", "plain",
                     kernel="K9f")
  # ---- 4j. coarse_fine-render-800: BASELINE config #2, K1 twice a chunk
  render_cf = _phase("4j", _render_main_k4, port_runner, models,
                     "coarse_fine", "--model", "coarse_fine", "--mip", "cone")
  cf_chunks = 2 * 2 * -(-SIZE * SIZE // CHUNK)
  if render_cf != 2 * cf_chunks:
    raise RuntimeError(f"the coarse_fine render launched K1 {render_cf} "
                       f"times for {cf_chunks} chunks, not twice a chunk")
  # ---- 4m. dnerf-over-time-800: frames and keyframes through K9f ----
  _phase("4m", _render_over_time, port_runner, models)

  # ---- 5. main path, train ----
  k3_launches = _phase("5", _train_main, port_runner, k1, loaders, dev)
  # ---- 5b. hash training at the plain_hash recipe ----
  train_h = _phase("5b", _train_main_hash, port_runner, k1, loaders, dev)
  _phase("5b-repeat", _hash_repeat, port_runner)
  # ---- 5c. NeRFAE at the ae recipe ----
  train_ae = _phase("5c", _train_main_ae, port_runner, k1, loaders, dev)
  # ---- 5d-5f. the K4 families at their sweep recipes ----
  train_k4 = {
      "posenc": _phase("5d-posenc", _train_main_k4, port_runner, k1, loaders,
                       dev, "posenc", POSENC_TRAIN_ARGV, TRAIN_STEPS),
      "cone": _phase("5e-cone", _train_main_k4, port_runner, k1, loaders,
                     dev, "cone", MIP_TRAIN_ARGV, TRAIN_STEPS),
      "cylinder": _phase("5e-cylinder", _train_main_k4, port_runner, k1,
                         loaders, dev, "cylinder", CYLINDER_TRAIN_ARGV,
                         CYLINDER_STEPS, gate=False),
      "tiny": _phase("5f-tiny", _train_main_k4, port_runner, k1, loaders,
                     dev, "tiny", TINY_TRAIN_ARGV, TRAIN_STEPS, gate=False)}
  # ---- 5g. VolSDF at the volsdf_eikonal recipe ----
  train_k8 = _phase("5g", _train_main_volsdf, port_runner, k1, loaders, dev)
  # ---- 5h / 5i. dnerf-train-4096 and dnerf-spline-train-4096 ----
  train_k9 = _phase("5h", _train_main_dyn, port_runner, k1, loaders, dev,
                    "dnerf_dx", DNERF_TRAIN_ARGV, DNERF_STEPS)
  train_k9s = _phase("5i", _train_main_dyn, port_runner, k1, loaders, dev,
                     "dnerf_spline_dp", DNERF_SPLINE_ARGV,
                     DNERF_SPLINE_STEPS)
  # ---- 5j. coarse_fine-train-4096, the coarse_fine_mip recipe ----
  train_cf = _phase("5j", _train_main_cf, port_runner, k1, loaders, dev)
  # ---- 5k. dnerf-spline-reg-train-4096: K9f + dp and K9b-G ----
  train_k9r = _phase("5k", _train_main_dyn_regs, port_runner, k1, loaders,
                     dev)
  # ---- 5v. volsdf-smooth-train-4096: K8f + eikonal and K8b-G ----
  train_k8s = _phase("5v", _train_main_volsdf_smooth, port_runner, k1,
                     loaders, dev)
  # ---- 5o. captured scenes: the makefile's dataset recipes, config #1 ----
  try:
    captured = _phase("5o", _captured, port_runner, captured_root)
  finally:
    shutil.rmtree(captured_root, ignore_errors=True)

  # ---- 6. timing at the main path's shapes ----
  t_phase = time.perf_counter()
  ds = sampler.RayDataset.from_bundle(
      loaders.load("", data_kind="synthetic", size=SIZE, num_views=1,
                   device=dev), size=SIZE, device=dev)
  frame_rays = ds.view_rays(0)
  call_rays = frame_rays[:CHUNK].contiguous()
  kw = dict(steps=STEPS, t_near=2.0, t_far=6.0)

  def ref_frame():
    return torch.cat([k1.plain_cp_render_reference(ws, frame_rays[i:i + CHUNK],
                                                   **kw)[:, :3]
                      for i in range(0, frame_rays.shape[0], CHUNK)])

  def kernel_frame():
    return driver.render_view(model, ds, 0)

  plain_ms = _event_ms(lambda: k1.plain_cp_render_reference(ws, call_rays,
                                                            **kw), 2)
  kernel_ms = _event_ms(lambda: k1.plain_cp_render(ws, call_rays, **kw), 3)
  kernel_ms2 = _event_ms(lambda: k1.plain_cp_render(ws, call_rays, **kw), 3)
  plain_ms2 = _event_ms(lambda: k1.plain_cp_render_reference(ws, call_rays,
                                                             **kw), 2)
  img_ref, ref_s = _sync_time(ref_frame)
  img_k, k_s = _sync_time(kernel_frame)
  frame_err = float(np.abs(img_k.reshape(-1, 3)
                           - img_ref.cpu().numpy()).max())
  if frame_err > TOL:
    raise RuntimeError(f"800x800 frame: kernel vs reference {frame_err}")
  max_err = max(max_err, frame_err)
  gflop = 2 * 459520 * CHUNK * STEPS / 1e9
  b1 = _mlp_bound(k1, "cp", CHUNK, STEPS, False)
  print(f"[time] {card}: one {CHUNK}-ray x {STEPS}-step call: K1 "
        f"{kernel_ms:.2f} / {kernel_ms2:.2f} ms "
        f"({gflop / kernel_ms:.2f} TFLOP/s; bound {b1[0]:.2f} ms, split TF32 "
        f"{b1[3]:.2f}), plain torch {plain_ms:.2f} / {plain_ms2:.2f} ms",
        flush=True)
  print(f"[time] {card}: one {SIZE}x{SIZE}x{STEPS} frame: render_view (K1) "
        f"{k_s:.3f} s = {SIZE * SIZE / k_s:,.0f} rays/s, plain torch "
        f"{ref_s:.3f} s = {SIZE * SIZE / ref_s:,.0f} rays/s | frame max "
        f"diff {frame_err:.2e}", flush=True)
  k3_ms, plain_k3_ms = _time_training(card, models.PlainNeRF, driver,
                                      loaders, sampler, k1, rays_ops, dev)
  print(f"[phase] 6 {time.perf_counter() - t_phase:.1f} s", flush=True)
  hash_t = _phase("6-hash", _time_hash, card, models, driver, loaders,
                  sampler, k1, hk, rays_ops, dev, ds)
  ae_t = _phase("6-ae", _time_ae, card, models, driver, loaders, sampler, k7,
                rays_ops, dev, ds)
  k4_t = _phase("6-k4", _time_k4, card, models, driver, loaders, sampler, k1,
                rays_ops, dev, ds)
  k8_t = _phase("6-volsdf", _time_volsdf, card, models, driver, loaders,
                sampler, k8, rays_ops, dev, ds)
  k9_t = _phase("6-dyn", _time_dyn, card, models, driver, loaders, sampler,
                k9, rays_ops, dev)
  cf_t = _phase("6-coarse_fine", _time_coarse_fine, card, models, driver,
                loaders, sampler, k1, sampling, dev, ds)
  print(f"[time] phases 1-6 (the run without --quality and --profile): "
        f"{time.perf_counter() - t_start:.1f} s", flush=True)

  if args.sass_against:
    _sass_against(build, jobs, built, args.sass_against)

  if args.quality:
    _quality(card, port_runner, k1, loaders, dev, args.seeds, args.recipes,
             args.quality_steps)
  if args.profile:
    _profile(card, model, ds, ws)
    _profile_train(card, models.PlainNeRF, driver, loaders, sampler, dev)
    _profile_frame(card, driver.init_model(models.PlainNeRF(
        steps=STEPS, enc_kind="hash", device=dev), seed=0), ds, "hash")
    _profile_train(card, models.PlainNeRF, driver, loaders, sampler, dev,
                   "hash K3 T=2^14", enc_kind="hash", table_size=HASH_TRAIN_T)
    _profile_frame(card, driver.init_model(models.NeRFAE(
        steps=STEPS, device=dev), seed=0), ds, "ae")
    _profile_train(card, models.NeRFAE, driver, loaders, sampler, dev,
                   "ae K7b", reg_coeffs={"latent_l2": AE_LATENT_L2})
    _profile_frame(card, driver.init_model(models.PlainNeRF(
        steps=STEPS, enc_kind="posenc", device=dev), seed=0), ds, "posenc")
    _profile_train(card, models.PlainNeRF, driver, loaders, sampler, dev,
                   "posenc K3", enc_kind="posenc")
    _profile_frame(card, driver.init_model(models.VolSDF(
        steps=STEPS, sigmoid_kind="upshifted", device=dev), seed=0), ds,
                   "volsdf")
    _profile_train(card, models.VolSDF, driver, loaders, sampler, dev,
                   "volsdf K8b", reg_coeffs={"eikonal": VOLSDF_EIKONAL},
                   with_normals=True, sigmoid_kind="upshifted")
    dyn_ds = sampler.RayDataset.from_bundle(
        loaders.load("", data_kind="synthetic-dyn", size=SIZE, num_views=1,
                     device=dev), size=SIZE, device=dev)
    _profile_frame(card, driver.init_model(models.DynamicNeRF(
        steps=STEPS, device=dev), seed=0), dyn_ds, "dnerf")
    _profile_train(card, models.DynamicNeRF, driver, loaders, sampler, dev,
                   "dnerf_dx K9b", data_kind="synthetic-dyn")

  k5f = hash_t["k5"][(CHUNK * STEPS, HASH_T)]["fwd"]
  k5f_train = hash_t["k5"][(BATCH * STEPS, HASH_TRAIN_T)]["fwd"]
  k5b = hash_t["k5"][(BATCH * STEPS, HASH_TRAIN_T)]["bwd"]
  rows = [
      ("render_fwd", "render_fwd.cu", "render.py:586", launches, max_err,
       min(kernel_ms, kernel_ms2), min(plain_ms, plain_ms2),
       _mlp_bound(k1, "cp", CHUNK, STEPS, False), None),
      ("render_bwd", "render_bwd.cu", "render.py:915", k3_launches, max_bwd,
       k3_ms, plain_k3_ms, _mlp_bound(k1, "cp", BATCH, STEPS, True), None),
      ("render_fwd_hash", "render_fwd.cu", "render.py:586",
       render_h["K1-hash"], max(max_err_h, hash_t["frame_err"]),
       *hash_t["k1"], None),
      ("render_bwd_hash", "render_bwd.cu", "render.py:915",
       train_h["K3-hash"], max_bwd_h, *hash_t["k3"], None),
      ("hash_fwd", "hash_encode.cu", "hash_encode.py:160", render_h["K5f"],
       max_k5f, *k5f),
      # the train step's K5f (262,144 points, T = 2^14): 5b's launches less
      # those of its eval chunks
      ("hash_fwd_train", "hash_encode.cu", "hash_encode.py:160",
       train_h["K5f"] - train_h["K1-hash"], max_k5f, *k5f_train),
      ("hash_bwd", "hash_encode.cu", "hash_encode.py:203", train_h["K5b"],
       max_k5b, *k5b),
      ("render_ae_fwd", "render_ae_fwd.cu", "render_ae.py:135",
       render_ae["K7f"], max(max_k7f, ae_t["frame_err"]), *ae_t["k7f"], None),
      ("render_ae_bwd", "render_ae_bwd.cu", "render_ae.py:166",
       train_ae["K7b"], max_k7b, *ae_t["k7b"], None),
  ]
  # 5o's launches join their rows: the original recipe's K3-cone and
  # K1-cone, the dtu recipe's K8b-L and K8f, the dnerf recipe's K9b-L and
  # K9f (each phase-5o count holds one recipe's launches alone)
  for mode in K4_MODES:
    extra = (captured["K1"], captured["K3"]) if mode == "cone" else (0, 0)
    rows += [
        (f"render_fwd_{mode}", "render_fwd.cu", "render.py:586",
         render_k4[mode] + extra[0], max_k4[mode][0], *k4_t[mode][0], None),
        (f"render_bwd_{mode}", "render_bwd.cu", "render.py:915",
         train_k4[mode] + extra[1], max_k4[mode][1], *k4_t[mode][1], None)]
  rows += [
      ("render_volsdf_fwd", "render_volsdf_fwd.cu", "render_volsdf.py:262",
       render_k8["K8f"] - render_k8["K8f-eik"] + captured["K8f"],
       max(max_k8f, k8_t["frame_err"]), *k8_t["K8f"], None),
      ("render_volsdf_fwd_eikonal", "render_volsdf_fwd.cu",
       "render_volsdf.py:262", render_k8["K8f-eik"] + train_k8["K8f-eik"]
       + train_k8s["K8f-eik"], max_k8f, *k8_t["K8f eikonal"], None),
      ("render_volsdf_bwd", "render_volsdf_bwd.cu", "render_volsdf.py:306",
       train_k8["K8b"] + captured["K8b"], max_k8b, *k8_t["K8b-L eikonal"],
       None),
      # the two-kernel step of 5v: K8b in cotangent mode with the eikonal
      ("render_volsdf_bwd_grad_eikonal", "render_volsdf_bwd.cu",
       "render_volsdf.py:306", train_k8s["K8b-G"], max_k8b,
       *k8_t["K8b-G eikonal"], None),
      ("render_dyn_fwd", "render_dyn_fwd.cu", "render_dyn.py:157",
       render_k9 + captured["K9f"], max(max_k9f, k9_t["frame_err"]),
       *k9_t[("dx", "K9f")], None),
      ("render_dyn_fwd_spline", "render_dyn_fwd.cu", "render_dyn.py:157",
       train_k9s["K9f"], max_k9f,
       *k9_t[(f"spline S={DNERF_SPLINE}", "K9f")], None),
      ("render_dyn_bwd", "render_dyn_bwd.cu", "render_dyn.py:231",
       train_k9["K9b"] + captured["K9b"], max_k9b, *k9_t[("dx", "K9b-L")],
       None),
      ("render_dyn_bwd_spline_dp", "render_dyn_bwd.cu", "render_dyn.py:231",
       train_k9s["K9b"], max_k9b,
       *k9_t[(f"spline S={DNERF_SPLINE}", "K9b-L dp")], None),
      # the two-kernel step of 5k: K9f with its dp² column and K9b-G
      ("render_dyn_fwd_spline_dp", "render_dyn_fwd.cu", "render_dyn.py:157",
       train_k9r["K9f-dp"], max_k9f,
       *k9_t[(f"spline S={DNERF_SPLINE}", "K9f dp")], None),
      ("render_dyn_bwd_grad_spline_dp", "render_dyn_bwd.cu",
       "render_dyn.py:231", train_k9r["K9b-G"], max_k9b,
       *k9_t[(f"spline S={DNERF_SPLINE}", "K9b-G dp")], None)]
  # per-ray ts (K6): the fine pass's launches on the main paths, half of
  # K1's in 4j and of K2's in 5j (the coarse pass takes the shared grid)
  for mode in CF_MODES:
    err = max_cf[mode][0]
    if mode == "cone":
      err = max(err, cf_t["frame_err"])
    rows.append((f"render_fwd_perray_{mode}", "render_fwd.cu",
                 "render.py:586", render_cf // 2 if mode == "cone" else 0,
                 err, *cf_t["fwd"][mode], None))
  rows.append(("render_bwd_perray_cone", "render_bwd.cu", "render.py:915",
               train_cf["K2"] // 2, max_cf["cone"][1], *cf_t["bwd"], None))
  for name, *_, bound, _ in rows:
    tf32 = (f", {bound[3]:.4f} ms by {bound[4]} in split TF32 (3 x the "
            "operations at the TF32 tensor-core peak: the products it runs)"
            if name.startswith(tuple(TC_SOURCES)) else "")
    print(f"[bound] {card}: {name} {bound[0]:.4f} ms by {bound[1]} (float32 "
          f"outside the tensor cores){tf32}, {bound[2]:.4f} ms at the bf16 "
          "tensor-core peak", flush=True)
  # K1, K2/K3, K7f, K7b, K8f, K8b, K9f and K9b run their products in
  # split TF32: their bound is that one
  rows = [(*r[:7], (r[7][3], r[7][4]) if r[0].startswith(tuple(TC_SOURCES))
           else r[7][:2], r[8]) for r in rows]
  print(json.dumps({"kernels": [{
      "name": name, "route": "cuda",
      "source": f"nerf_atlas_tpu_torch/csrc/{src}",
      "replaces": f"nerf_atlas_tpu/ops/pallas/{tpu}",
      "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain,
      "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib,
  } for name, src, tpu, n, err, ms, plain, bound, lib in rows]}))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  sys.exit(main())
