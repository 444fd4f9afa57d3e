#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dynamorph_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases; any failure exits non-zero, and only a run in which every phase
passed prints the final ``{"ok": true, ...}`` line:

1. versions, card name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``dynamorph_tpu_torch/ops/csrc``
   with ``nvcc`` for sm_90a (one source holds vq_lookup, vq_indices and
   the lookup's row-wise test oracle; ``batch_norm.cu`` the training-mode
   batch norm's forward and backward);
3. hold each kernel against its plain PyTorch version on the card:
   vq_lookup at the unit-test shapes, with forced ties, at the ragged ends
   of its tiles (with small integers too, whose distances are exact), and
   at both encode shapes (z16 and z32 at batch 512), q bit-equal to
   codebook[idx]; and bit for bit (idx and q) against the row-wise oracle,
   the lookup's first one-thread-a-row kernel, which is on no path;
   vq_indices at the unit-test shapes and the ragged ends of its tiles,
   with forced ties and on small integers (exact distances), and at the z32
   training shape (N = 768 x 32 x 32) on random rows and on the latents of
   a full-width z32 encoder. idx must equal the lookup kernel's exactly,
   and the plain version's except at near-ties, rows whose two candidate
   distances, recomputed in float64, differ by less than 1e-6 relative
   (everywhere, where the distances are exact); at the training shape it
   must disagree with a float64 argmin on at most 0.006% of the rows (the
   JAX package's gate for the "high" training precision), on as many rows
   as the lookup kernel's codes and the row-wise oracle's do; the
   batch-norm kernels (``ops/batch_norm.py``) through ``batch_norm_train``
   at every training-mode batch-norm shape of the z32 and z16 steps, with
   and without the folded ReLU: y, the running buffers, dx, dgamma and
   dbeta against float64 ``F.batch_norm`` (+ ReLU) on each side's own mask,
   within fp32 rounding and no further than cuDNN's, a channels-last input
   bit-equal to NCHW, every call a launch and none a fallback; then each
   shape timed (CUDA events) beside cuDNN's batch norm with and without the
   ReLU and the bound of the function's bytes. Phases 5, 7 (the timed z32
   step), 12, 13 and 18 count the batch-norm launches of their own runs
   and refuse any fallback;
4. the encode path: ``run_vae -m process`` (the CLI) for VQ_VAE_z16 at full
   width (num_hiddens 16, num_residual_hiddens 32, num_embeddings 64,
   2 x 128 x 128 patches, batch 512) on a synthetic well of 2,304 float64
   patches with a seeded random-init ``model.pt`` of reference names. It
   checks the latent pickles, the kernel's launch count, and the first 64
   patches' latents against the port's CPU path;
5. the training path: ``run_training`` (the CLI) for VQ_VAE_z32 at the
   widths of configs/config_example.yml (num_hiddens 64,
   num_residual_hiddens 64, num_embeddings 512, batch 768, lr 1e-4, loss
   weights 100/1/1/0.5/-0.5, augmentation on) for 2 epochs on a synthetic
   training directory of 1,536 patches chained into trajectories: 2
   training steps (768 + 538) and 1 validation step per epoch. It checks
   the losses, metrics.jsonl, that model.pt loads strictly and encodes,
   and one vq_indices launch per training step and one vq_lookup launch
   per validation step;
6. one training step on the card against the same step on the CPU (same
   weights, 8 full-width patches, a mask and a relation block, no
   augmentation): losses, gradients and batch-norm buffers. This is the
   check that sees TF32 in the backward pass. Each fp32 step's gradients
   are held against float64 taken on that step's side of every kink (its
   ReLU masks and the time-matching loss's clamps replayed, the flips
   counted): the card's error at most 3 x the CPU's + 1e-5; a control
   step whose backward runs with TF32 on must land over that limit;
7. timings with CUDA events: each kernel at its main-path shapes beside its
   bound, its plain version and the stock-PyTorch yardstick (and the
   lookup beside its row-wise oracle), as device time (calls replayed from
   a CUDA graph) and per call from Python, with its share of the bound; the
   registers, shared memory and spills of every kernel instance
   (``-Xptxas -v``); the gather_codes backward; z16 encode patches/s; the
   z32 encode at batch 512 with the shares of the lookup kernel and of the
   NCHW -> NHWC copy before it (torch.profiler); one z32 training step at
   batch 768 (ms, patches/s) and its device time by kernel family
   (torch.profiler);
8. the segmentation path: ``run_segmentation -m segmentation`` (the CLI)
   with the U-Net at the published widths (channels [0, 1] of 3, 3
   classes, window 256, 5 random passes; ResNet34 encoder, decoder 256,
   128, 64, 32, 16), seeded random weights with batch norm moved off the
   identity, on a synthetic site of 2 float64 frames of 2048 x 2048, in
   the tiled ensemble and in direct mode. It checks the probabilities
   (shape, dtype, no -1 fill, class sums within 1e-5 of 1), both PNGs and
   that no site failed; then 8 full-width tiles and one 512 x 512 direct
   frame on the card against the CPU (max |d prob| <= 1e-4) beside a TF32
   control that must land above that limit; then one 2048 x 2048 frame in
   each mode (frames/s end to end and of the device work alone, the share
   of the 67 TFLOP/s fp32 rate, peak memory, a torch.profiler breakdown by
   kernel family) and the host's share of a site. This path reaches no
   Pallas kernel: it runs cuDNN convolutions and batch norm in fp32.
9. the front end to latents: on one synthetic site of 12 float64 frames of
   2 x 2048 x 2048 with its float64 probabilities, made from 24-32 planted
   disk cells that drift, the CLIs run the chain ``run_segmentation -m
   instance_segmentation`` -> ``run_patch -m extract_patches`` (window
   256) -> ``run_patch -m build_trajectories`` -> ``run_vae -m assemble``
   (256 -> 128) -> ``run_vae -m process`` (VQ_VAE_z16, batch 512, the
   weights of phase 4) -> ``run_vae -m trajectory_matching``. It checks
   that every planted cell is found in every frame and is one trajectory
   of 12 points, the well's artifacts, one vq_lookup launch per batch, the
   latents against the CPU at phase 4's limits, and frame 0's
   ``extract_cell_patches`` bit-equal card vs CPU; it times each frame's
   clustering (host), extraction (device and wall) and fetch, and each
   stage's wall time and host share. This path reaches vq_lookup through
   ``process``; the extraction runs plain PyTorch ops (gather, two
   convolutions, the fill, a sort for the median), as the JAX package
   runs them through XLA.
10. raw TIFFs to PCs through the stage graph: phase 9's planted site
   written as raw microscope files (12 frames x Retardance, Phase2D and
   Brightfield, single-page uncompressed uint16 TIFFs of 2048 x 2048 in a
   position directory), then ``run_preproc`` (the npy must equal the
   frames bit for bit, in their slots), ``run_pipeline --stages
   segmentation`` (the U-Net of phase 8), the planted probabilities in
   place of the random U-Net's, ``run_pipeline`` over
   instance_segmentation ... trajectory_matching and ``pca`` (fit), and
   ``run_dim_reduction -m pca`` (the transform, equal to the fitted model's
   bit for bit). It checks phase 9's artifacts, one vq_lookup launch per
   batch, the latents against the CPU, the PCA model and the returned
   stage lists, and prints each stage's wall time (from the orchestrator's
   ``stage_timer`` log), its device time (from a torch.profiler trace of
   the run) and host share, and the peak device memory. Then a
   plate-scale PCA fit of 55,296 x 4,096 fp32 latents synthesised on the
   card (24 wells of 2,304 patches; fit, transform; projected variance
   and orthonormality in float64 within 1e-4; the SVD alone timed and
   checked with cuSOLVER's gesvd, gesvda and gesvdj; the same plate
   without noise, rank-deficient, fitted and checked too), and the UMAP
   reference grid (n_neighbors 15, 50, 200) on 9,216 of them (kNN, fuzzy
   set, init, optimisation timed; the 15-neighbour fit repeated bit-equal;
   the card's kNN equal to the CPU's on 1,024 rows, ties aside).
11. the device-resident front end on phase 10's site (the npy
   ``run_preproc`` wrote, 12 frames of 3 x 2048 x 2048): ``run_pipeline``
   with ``patch.fused: true`` (the fused segmentation -> instance -> patch
   stage, then build_trajectories ... trajectory_matching staged), then
   with ``latent_encoding.streaming: true`` too (raw -> latents in one
   pass, then build_trajectories, the relation half of assemble and
   trajectory_matching). The segmentation model runs phase 8's U-Net at
   its published widths on every frame and returns the planted
   probabilities, rebuilt from the frame. It checks the stage lists, every
   artifact against phase 10's staged run (pickles, stacks, PNGs, static
   patches, file paths, relations, labels, trajectory lists), the
   probabilities, the latents at phase 4's limits (and says whether they
   came out bit-equal) and one vq_lookup launch per 512 patches on each
   path; it prints each stage's wall time and host share (a torch.profiler
   trace of each run), the bytes each frame moves each way (the stage's
   own count), the peak device memory and the peak pinned host memory
   (``torch.cuda.host_memory_stats``), beside phase 10's staged front
   end and phase 8's direct-mode frame; and the fused stage's host work
   (a frame's stacks pickle and clustering, the site's probability save
   and previews) timed apart.
12. the other encoders through the CLIs: ``run_training`` for VAE, IWAE
   and AAE at the z16 widths (phase 4's), each with the loss weights of
   phase 5, and for ResNet50 at batch_size 768 with n_pos_samples 4 (192
   anchors a step), one epoch of 1,536 synthetic patches labelled by
   trajectory (7 + 2 ResNet steps, 2 + 1 VAE-family steps); each writes a
   model.pt that loads strict and that ``run_vae -m process`` then encodes
   phase 4's well with (the VAE family writes its latent as both pickles,
   ResNet50 the 128-d projection as ``_latent_space.pkl`` only). For each
   network: no VQ kernel launched; the first 64 patches' latents card vs
   CPU within 1e-5 of max |z| beside a TF32 control; one train step of
   seeded and of trained weights on 8 patches card vs CPU, losses and
   gradients held against float64 at phase 6's rule (each float64 step
   on its fp32 step's side of every kink), beside a control step run
   with TF32 on; the encode rate on a
   device-resident batch of 512 and end to end; the train step at batch
   768 on a device-resident batch (ms, peak memory, device time by kernel
   family, torch.profiler); for ResNet50 the all-triplet miner's forward +
   backward alone at B = 768 (ms, share of the step, its peak memory).
   Then a ResNet18 step with the hard-negative miner, on seeded and on
   default weights, held the same way (its two maxima and its clamp
   replayed in float64 with the ReLUs and the max-pool).
   This path reaches no Pallas kernel (no codebook).
13. after the latents, on earlier phases' artifacts: ``train_adversarial``
   (the AAE at the z16 widths on phase 12's 1,536 training patches, batch
   768, one epoch: 2 steps of 3 updates), whose ``model_epoch0/model.pt``
   ``run_vae -m process`` then loads strict; the adversarial step timed
   at batch 768 (ms, idle share, peak memory); one step on 8 patches from
   the trained weights, each update held card vs CPU against
   float64 at phase 12's rule with a TF32 control, the discriminator
   update leaving enc and dec and the generator update leaving enc_d
   unmoved; ``evaluate_recon_losses`` of phase 4's VQ_VAE_z16 on phase 4's
   well (9 vq_lookup launches) and card vs CPU on a 256-sample subset
   (1e-5 relative where the codes agree, flips at float64 near-ties);
   ``fit_cpca`` on phase 10's plate (55,296 x 4,096: the first half the
   target, the second the background, ``auto_alphas``, k = 2), its
   covariances against float64 on the host (1e-10) and its components
   against ``numpy.linalg.eigh`` in float64 (|cos| >= 1 - 1e-4 where the
   eigengap is at least 1e-3 of max |w|, the Rayleigh quotient elsewhere);
   ``kmeans_on_short_trajs`` (raw and diffs) on the plate's PCs in
   trajectories of 8 and ``movement_state_clustering`` on as many
   synthetic tracks, card vs CPU (labels equal but at float64 near-ties);
   ``msd_curve``, ``fit_msd_powerlaw``, ``trajectory_summaries`` ->
   ``well_conditioned_gmm`` and ``pc_sample_montage`` along PC1. This path
   reaches vq_lookup through the VQ-VAE's eval ``apply``.
14. U-Net training and the cv2-free geometry (the JAX package's example's
   first stage, ``examples/full_system_run.py:44-52``): the rotating,
   mirroring sampler ``generate_patches`` draws 64 patches of 256² from 4
   frames of 2 x 2048² uint16 with three-class probabilities (host
   seconds); ``Segment((2, 256, 256)).fit`` at batch 8 for 2 epochs of 56
   patches with 8 validation patches on the card (history, checkpoints,
   seconds, peak memory); the fit step timed at batch 8 on a resident
   batch (CUDA events; idle share and kernel families from
   torch.profiler); the validation ROC-AUC and F1 on the card against the
   CPU's and float64 ranks (1e-12); three fit steps at batch 2 of 128²,
   each on its own seeded batch, from the trained weights card vs CPU,
   each against float64 on its own side of every ReLU and the max-pool
   (phase 12's rule, on the errors pooled over the three steps) beside a
   TF32 control that must land over it;
   ``SegmentWithMultipleSlice((2, 3, 256, 256))`` card vs CPU (1e-4) and
   one frame of ``predict_whole_map(time_slices=3)``;
   the long-axis extraction of a 2048² site with 200 elliptical cells on
   the card (cells/s), its first 40 cells on the CPU, pickles equal;
   ``warp_affine`` card vs CPU bit for bit in both arithmetics and the
   extraction's batched warp timed against the extraction; the validation
   overlays at 1108², their TIFF and a trajectory GIF (seconds). This path
   reaches no Pallas kernel and launches neither VQ kernel.
15. reference-trained Keras weights (the card's machine has no h5py, so the
   script writes its ``.h5`` files with its own HDF5 writer, ``write_h5``,
   and the port reads them with ``io/hdf5.py``): seeded weights of the
   reference graph's U-Net at its published widths (pre_conv 2 -> 3,
   classification_models ResNet34, the sm 1.0.1 decoder 256 ... 16, 3
   classes) in ``save_weights``'s layout; ``Segment((2, 256, 256)).load``
   of it on the card (seconds), 8 tiles' logits card vs CPU within 1e-4 of
   max |logit| (phase 8's rule) beside a TF32 control that must land over
   it, ``verify_against_golden`` on the card against CPU goldens;
   ``run_segmentation -m segmentation`` with the ``.h5`` as weights on
   phase 8's site (2 frames of 2 x 2048²), tiled and direct, its outputs
   checked as phase 8's, and the device ms of one 2048² frame in each mode;
   ``fit`` from the imported weights with ``freeze_encoder=True`` (2 steps
   at batch 8 of 256² and a validation pass): the encoder's weights and
   ``bn_data``'s gamma bit-unchanged, everything else moved, then the step
   timed on a resident batch with its idle share; the 2.5-D model (3
   slices, unet_feat 32 read from the file) card vs CPU at the same rule
   with a TF32 control; InceptionResNetV2 from an ``.h5`` numbered from an
   offset with the with-top ``predictions`` layer, and ResNet50 from a
   torchvision-format state_dict, each through ``extract_features`` on
   phase 4's 2,304-patch well (4,608 images of 224², images/s end to end
   and of the device encode alone at batch 128), card vs CPU on 16 images
   within 1e-5 of max |feature| beside a TF32 control. Launches neither VQ
   kernel.
16. multi-rank (Slice F), every rank a process started by the script
   (``rank_main``): with two or more cards NCCL, one rank a card (at most
   4); with one card two ranks share it over gloo, whose CUDA tensors
   cross through host memory, and one NCCL rank runs the trainer once
   too. ``run_training --multihost`` for VQ_VAE_z32 at batch 768 (768 /
   world rows a rank) with the trajectory-sharded ring loss on phase 5's
   patches, 2 epochs of one training and one validation batch: the
   histories the same on every rank, one vq_indices launch a training
   step and one vq_lookup launch a validation step a rank, metrics.jsonl
   and model.pt written by rank 0 alone, model.pt loaded strict by
   ``run_vae -m process``; then the data-parallel step timed at batch 768
   (ms a rank, the collectives' share, the bytes a ring step sends). The
   data-parallel z32 step (3 seeded batches of 8 full-width patches, Adam)
   and the ResNet18 all-triplet step on the gathered batch against one
   process on the card: the first step's losses and running buffers at
   phase 6's limits, and every gradient against float64 on the CPU on the
   fp32 step's side of every kink at phase 6's rule (the ranks' error at
   most 3 x one process's + 1e-5), with TF32 controls that must land over
   it. ``run_pipeline --multihost`` (process, pca) over two wells: each
   rank its own well, the latents and the PCA equal to one process's, the
   PCA fitted once on rank 0, and a failure planted on rank 1 failing every
   rank. ``fit_pca_distributed`` on the plate (55,296 x 4,096) against the
   SVD fit and float64, and ``encode_patches`` fanned out over the local
   devices (on one card: two chunks on it) against one device. Each
   kernel timed at its per-rank shape.
17. the fan-out over a process's cards (Slice J), over [card, card] on a
   one-card host (so the chunked, replicated and threaded code runs),
   each against the one-device path: tiled and direct segmentation of
   phase 8's site (the largest probability difference within phase 8's
   card limit; a chunk's batch differs, so cuDNN may choose another
   algorithm), ResNet50's ``encode_batched`` of 1,024 of phase 4's patches
   (1e-5 of max |z|), ``seg_patch_fused`` over two sites (phase 10's site
   cut to 4 frames, under two names) with frames over both entries at
   site parallelism 1 and 2 (every artifact equal to phase 10's run of the
   same frames, each site's wall and the call's host share), the
   streaming encode over both sites (latents against phase 10's rows,
   vq_lookup launches by device), and every ``analysis.plots`` function
   writing its file without matplotlib.
   Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line and the
   ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import contextlib
import copy
import ctypes
import json
import logging
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SEED = 0
N_PATCHES = 2304            # 4.5 batches of 512: the last one is padded
BATCH = 512
NET = dict(num_hiddens=16, num_residual_hiddens=32, num_embeddings=64)
# H100 SXM, NVIDIA's data sheet: HBM rate and fp32 rate outside the tensor
# cores, both at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Unit-test shapes (tests/test_vq.py) and the two encode shapes at batch 512.
VQ_SHAPES = [(64, 16, 64), (300, 16, 512), (1025, 64, 128), (512, 64, 512)]
# Ragged ends of the tiles (128 rows a block, 64 codes a chunk).
RAGGED_SHAPES = [(1, 16, 1), (127, 64, 63), (129, 16, 65), (4097, 64, 512)]
Z16_SHAPE = (BATCH * 16 * 16, 16, 64)
Z32_SHAPE = (BATCH * 32 * 32, 64, 512)
# A near-tie: two codes whose distances, recomputed in float64, differ by
# less than this fraction of |z|^2 + max(|E_a|^2, |E_b|^2) — the size of the
# terms that the fp32 formula |E|^2 - 2 z.E cancels, hence of its rounding.
NEAR_TIE_REL = 1e-6
LATENT_ATOL = 1e-4          # card vs CPU, f32 conv summation order
# z32 training (configs/config_example.yml:75-113): model widths and loss
# weights, batch 768, and the training shape of the codebook search
TRAIN_NET = dict(num_inputs=2, num_hiddens=64, num_residual_hiddens=64,
                 num_residual_layers=2, num_embeddings=512,
                 commitment_cost=0.25, weight_matching=100.0, margin=1.0,
                 w_a=1.0, w_t=0.5, w_n=-0.5)
TRAIN_BATCH = 768
TRAIN_SHAPE = (TRAIN_BATCH * 32 * 32, 64, 512)
N_TRAIN_PATCHES = 1536      # 1,306 train (768 + 538) and 230 val patches
TRAIN_EPOCHS = 2
TRAJ_LEN = 8                # frames per synthetic trajectory
F64_FLIP_GATE = 6e-5        # 0.006% of rows (BASELINE.md:299-305)
# card vs CPU, one training step. Losses and batch-norm buffers: fp32
# summation order (cuDNN vs oneDNN) moves them by about 1e-7 relative.
# Gradients are held against the same step in float64 on the CPU: the
# encoder's are ill-conditioned in fp32 (the time-matching distances
# |z_i|^2 + |z_j|^2 - 2 z_i.z_j over L = 65,536 cancel), so fp32 on either
# device lands about 7e-4 (relative L2) from float64 there, and 3e-7 in the
# decoder. The card must be as close to float64 as the CPU is: per weight
# tensor, err_card <= 3 err_cpu + 1e-5. TF32 convolutions miss that by far.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_VS_CPU = 3.0
STEP_GRAD_FLOOR = 1e-5
STEP_BN_ATOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str) -> None:
    log(f"\n=== {name}")


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return res.stdout.strip().splitlines()[0]


def blob_patches(rng, n):
    """n float64 (2, 128, 128) patches in uint16 intensity units: smooth
    blobs plus noise."""
    yy, xx = np.mgrid[0:128, 0:128] / 128.0
    cx, cy = rng.rand(2, n, 1, 1)
    blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 0.05)
    return np.stack([blob * 30000 + rng.rand(n, 128, 128) * 5000,
                     blob * 8000 + rng.rand(n, 128, 128) * 2000], 1)


def trajectory_relations(n, length=TRAJ_LEN):
    """Relations that chain patches [t L, (t + 1) L) into trajectories:
    2 for adjacent frames, 1 for the other pairs of a trajectory."""
    rel = {}
    for t0 in range(0, n, length):
        frames = range(t0, min(t0 + length, n))
        for a in frames:
            for b in frames:
                if a != b:
                    rel[(a, b)] = 2 if abs(a - b) == 1 else 1
    return rel


def relation_block(n, length=TRAJ_LEN):
    """The dense uint8 (n, n) block of ``trajectory_relations``."""
    block = np.zeros((n, n), np.uint8)
    for (a, b), v in trajectory_relations(n, length).items():
        block[a, b] = v
    return block


# ---------------------------------------------------------------- phase 3


def tied_inputs(rng, n, d, k):
    """Duplicated codebook rows and latents exactly on them (as
    tests/test_torch_vq.py): the lowest index must win."""
    cb = rng.randn(k, d).astype(np.float32)
    cb[k // 2] = cb[3]
    cb[k - 1] = cb[3]
    cb[k - 2] = cb[1]
    z = np.empty((n, d), np.float32)
    z[::3] = cb[3]
    z[1::3] = cb[k // 2]
    z[2::3] = cb[1] + 1e-3
    return z, cb


def tie_gap(torch, z, ea, eb):
    """float64 |d(z, a) - d(z, b)| and the near-tie allowance, per row."""
    z, ea, eb = z.double(), ea.double(), eb.double()
    d_a = torch.sum((z - ea) ** 2, dim=1)
    d_b = torch.sum((z - eb) ** 2, dim=1)
    scale = torch.sum(z * z, 1) + torch.maximum(torch.sum(ea * ea, 1),
                                                torch.sum(eb * eb, 1))
    return torch.abs(d_a - d_b), NEAR_TIE_REL * scale


def check_near_ties(torch, what, z, cb, idx, idx_ref):
    """Every row where ``idx`` and ``idx_ref`` differ must be a near-tie.
    Returns (rows that differ, largest float64 distance gap among them)."""
    rows = torch.nonzero(idx != idx_ref).flatten()
    if not len(rows):
        return 0, 0.0
    gap, allowed = tie_gap(torch, z[rows], cb[idx[rows].long()],
                           cb[idx_ref[rows].long()])
    if bool((gap > allowed).any()):
        raise AssertionError(
            f"{int((gap > allowed).sum())} {what} disagreements are not "
            f"near-ties (largest gap / allowance "
            f"{float((gap / allowed).max()):.3e})")
    return len(rows), float(gap.max())


def compare_vq(torch, vq, z, cb):
    """Kernel vs plain, and vs the row-wise oracle bit for bit, on the card.
    Returns (flips, max_abs_err)."""
    q, idx = vq._vq_lookup_cuda(z, cb)
    q_row, idx_row = vq._vq_lookup_rowwise_cuda(z, cb)
    torch.cuda.synchronize()
    if not torch.equal(idx, idx_row):
        raise AssertionError(
            f"the tiled lookup and the row-wise oracle pick different codes "
            f"on {int((idx != idx_row).sum())} rows")
    if not torch.equal(q, q_row):
        raise AssertionError("q differs from the row-wise oracle's")
    q_ref, idx_ref = vq.vq_lookup_reference(z, cb)
    if not torch.equal(q, cb[idx.long()]):
        raise AssertionError("q is not bit-equal to codebook[idx]")
    flips, _ = check_near_ties(torch, "vq_lookup", z, cb, idx, idx_ref)
    return flips, float(torch.max(torch.abs(q - q_ref)))


def phase_compare(torch, vq, dev):
    phase("3. vq_lookup kernel vs plain version and row-wise oracle on the "
          "card")
    rng = np.random.RandomState(SEED)
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = []
    for n, d, k in VQ_SHAPES:
        cases.append((f"random {n}x{d} K={k}", rng.randn(n, d), rng.randn(k, d)))
        cases.append((f"ties {n}x{d} K={k}", *tied_inputs(rng, n, d, k)))
    for n, d, k in RAGGED_SHAPES:
        cases.append((f"random {n}x{d} K={k}", rng.randn(n, d), rng.randn(k, d)))
        cases.append((f"exact {n}x{d} K={k}", rng.randint(-2, 3, (n, d)),
                      rng.randint(-2, 3, (k, d))))
        if k >= 4:
            cases.append((f"ties {n}x{d} K={k}", *tied_inputs(rng, n, d, k)))
    results = {}
    for name, z, cb in cases:
        zt = torch.from_numpy(np.asarray(z, np.float32)).to(dev)
        cbt = torch.from_numpy(np.asarray(cb, np.float32)).to(dev)
        flips, err = compare_vq(torch, vq, zt, cbt)
        log(f"{name}: idx and q equal to the row-wise oracle's; idx flips "
            f"at near-ties {flips}, max |q - q_plain| {err}")
        # small integers: every distance is exact, ties included
        if name.startswith("exact") and flips:
            raise AssertionError(f"{name}: exact distances, yet the kernel "
                                 "differs from the plain argmin")
    for label, (n, d, k) in (("z16 encode", Z16_SHAPE),
                             ("z32 encode", Z32_SHAPE)):
        z = torch.randn(n, d, generator=g, device=dev)
        cb = torch.randn(k, d, generator=g, device=dev)
        flips, err = compare_vq(torch, vq, z, cb)
        results[label] = dict(flips=flips, max_abs_err=err, z=z, cb=cb)
        log(f"{label} N={n} D={d} K={k}: idx and q equal to the row-wise "
            f"oracle's; idx flips at near-ties {flips} of {n}, max "
            f"|q - q_plain| {err}")
    return results


def f64_argmin(torch, z, cb, chunk=65536):
    """The exact nearest code of each row, from float64 distances."""
    cb64 = cb.double()
    e2 = torch.sum(cb64 * cb64, 1)
    return torch.cat([
        torch.argmin(e2[None, :] - 2.0 * (z[i:i + chunk].double() @ cb64.T),
                     1) for i in range(0, len(z), chunk)]).to(torch.int32)


def compare_indices(torch, vq, z, cb):
    """vq_indices kernel vs plain on the card, and vs the lookup kernel and
    the row-wise oracle, whose codes it must equal exactly. Returns (flips,
    largest float64 distance gap at a flip, idx, the lookup kernel's idx,
    the oracle's idx)."""
    idx = vq._vq_indices_cuda(z, cb)
    torch.cuda.synchronize()
    _, idx_lookup = vq._vq_lookup_cuda(z, cb)
    _, idx_row = vq._vq_lookup_rowwise_cuda(z, cb)
    for other, what in ((idx_lookup, "vq_lookup"), (idx_row, "the row-wise "
                                                    "oracle")):
        if not torch.equal(idx, other):
            raise AssertionError(
                f"vq_indices and {what} pick different codes on "
                f"{int((idx != other).sum())} rows")
    flips, gap_max = check_near_ties(torch, "vq_indices", z, cb, idx,
                                     vq.vq_indices_reference(z, cb))
    return flips, gap_max, idx, idx_lookup, idx_row


def training_latents(torch, dev):
    """The (768 x 32 x 32, 64) latent rows of a full-width random-init z32
    encoder on 768 synthetic patches, and a codebook of 512 of them plus
    noise: rows that sit near several codes, where fp32 rounding can flip
    an assignment."""
    from dynamorph_tpu_torch.models import VQVAEz32
    from dynamorph_tpu_torch.train.data import zscore

    torch.manual_seed(SEED)
    model = VQVAEz32(**TRAIN_NET).to(dev)
    x = zscore(blob_patches(np.random.RandomState(SEED + 2), TRAIN_BATCH))
    z_before, _, _ = model.encode(torch.from_numpy(x.astype(np.float32))
                                  .to(dev))
    rows = z_before.permute(0, 2, 3, 1).reshape(-1, TRAIN_SHAPE[1])
    g = torch.Generator(device=dev).manual_seed(SEED)
    pick = torch.randperm(len(rows), generator=g, device=dev)[:TRAIN_SHAPE[2]]
    cb = rows[pick] + 0.01 * rows.std(0) * torch.randn(
        TRAIN_SHAPE[2], TRAIN_SHAPE[1], generator=g, device=dev)
    return rows.contiguous(), cb.contiguous()


def phase_compare_indices(torch, vq, dev):
    phase("3b. vq_indices kernel vs plain version and float64 on the card")
    rng = np.random.RandomState(SEED + 3)
    for n, d, k in VQ_SHAPES + RAGGED_SHAPES:
        cases = [(f"random {n}x{d} K={k}", (rng.randn(n, d), rng.randn(k, d))),
                 (f"exact {n}x{d} K={k}", (rng.randint(-2, 3, (n, d)),
                                           rng.randint(-2, 3, (k, d))))]
        if k >= 4:
            cases.append((f"ties {n}x{d} K={k}", tied_inputs(rng, n, d, k)))
        for name, (z, cb) in cases:
            zt = torch.from_numpy(np.asarray(z, np.float32)).to(dev)
            cbt = torch.from_numpy(np.asarray(cb, np.float32)).to(dev)
            flips = compare_indices(torch, vq, zt, cbt)[0]
            log(f"{name}: idx equal to vq_lookup's and the row-wise "
                f"oracle's; flips vs plain at near-ties {flips}")
            # small integers: every distance is exact, ties included
            if name.startswith("exact") and flips:
                raise AssertionError(f"{name}: exact distances, yet the "
                                     "kernel differs from the plain argmin")
    n, d, k = TRAIN_SHAPE
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    cases = {"random": (torch.randn(n, d, generator=g, device=dev),
                        torch.randn(k, d, generator=g, device=dev)),
             "latents": training_latents(torch, dev)}
    results = {}
    for label, (z, cb) in cases.items():
        flips, gap, idx, idx_lookup, idx_row = compare_indices(torch, vq, z,
                                                               cb)
        exact = f64_argmin(torch, z, cb)
        f64_flips = int((idx != exact).sum())
        lookup_f64_flips = int((idx_lookup != exact).sum())
        row_f64_flips = int((idx_row != exact).sum())
        rate = f64_flips / n
        log(f"z32 training shape, {label} rows, N={n} D={d} K={k}: idx flips "
            f"vs plain at near-ties {flips} (largest float64 gap {gap:.3e}); "
            f"vs float64 argmin {f64_flips} rows = {100 * rate:.6f}% "
            f"(gate {100 * F64_FLIP_GATE:.4f}%), vq_lookup's codes "
            f"{lookup_f64_flips} rows, the row-wise oracle's {row_f64_flips}"
            f" rows; {len(torch.unique(idx))} codes used")
        if not f64_flips == lookup_f64_flips == row_f64_flips:
            raise AssertionError("vq_indices, vq_lookup and the row-wise "
                                 "oracle flip different numbers of rows "
                                 "against float64")
        if rate > F64_FLIP_GATE:
            raise AssertionError(f"vq_indices flips {100 * rate:.6f}% of the "
                                 "rows against float64, above the gate")
        results[label] = dict(flips=flips, max_gap=gap, f64_flips=f64_flips,
                              f64_rate=rate, z=z, cb=cb)
    return results


# --------------------------------------------------------------- phase 3c

# The training-mode batch norms of one step at batch 768, NCHW as both
# trunks run on the card: ((n, c, h, w), folded ReLU, count a step).
BN_STEPS = {
    "z32": [((768, 32, 64, 64), True, 2), ((768, 64, 32, 32), True, 4),
            ((768, 64, 32, 32), False, 5)],
    "z16": [((768, 8, 64, 64), True, 1), ((768, 16, 32, 32), True, 1),
            ((768, 16, 16, 16), True, 1), ((768, 16, 16, 16), False, 3),
            ((768, 32, 16, 16), True, 2)],
}
BN_A_STEP = {"z32": 11, "z16": 8}
# relative L2 from float64 (each side on its own ReLU mask): fp32 rounding
# for y, the statistics and the running buffers; the gradients' sums cancel
BN_RTOL, BN_GRAD_RTOL = 1e-6, 1e-5
BN_MOMENTUM, BN_EPS = 0.1, 1e-5


def bn_counted():
    """(launches, fallbacks) of the batch-norm op so far."""
    from dynamorph_tpu_torch.ops.batch_norm import batch_norm_train
    return batch_norm_train.launches, batch_norm_train.fallbacks


def bn_zero():
    from dynamorph_tpu_torch.ops.batch_norm import batch_norm_train
    batch_norm_train.launches = batch_norm_train.fallbacks = 0


def bn_inputs(torch, shape, dev, seed):
    """x off centre on some channels (std 1.5), dy, and gamma, beta and
    running buffers moved off the identity, NCHW fp32 on ``dev``."""
    n, c, h, w = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    centre = 3.0 * torch.randint(-1, 2, (1, c, 1, 1), generator=g,
                                 device=dev).float()
    x = torch.randn(shape, generator=g, device=dev) * 1.5 + centre
    dy = torch.randn(shape, generator=g, device=dev)
    gamma = 0.5 + torch.rand(c, generator=g, device=dev)
    beta = torch.randn(c, generator=g, device=dev) * 0.5
    rmean = torch.randn(c, generator=g, device=dev)
    rvar = 0.5 + torch.rand(c, generator=g, device=dev)
    return x, dy, gamma, beta, rmean, rvar


def bn_through_autograd(torch, fn, x, dy, gamma, beta, rmean, rvar):
    """(y, running mean, running var, dx, dgamma, dbeta) of
    ``fn(x, gamma, beta, running_mean, running_var)`` under autograd."""
    xg = x.detach().clone().requires_grad_(True)
    g = gamma.detach().clone().requires_grad_(True)
    b = beta.detach().clone().requires_grad_(True)
    rm, rv = rmean.clone(), rvar.clone()
    y = fn(xg, g, b, rm, rv)
    (y * dy).sum().backward()
    torch.cuda.synchronize()
    return y.detach(), rm, rv, xg.grad, g.grad, b.grad


def phase_compare_batch_norm(torch, dev):
    """The batch-norm kernels through ``batch_norm_train`` at every
    training-mode batch norm shape of the z32 and z16 steps, with and
    without the folded ReLU: y, the running buffers, dx, dgamma and dbeta
    against float64 ``F.batch_norm`` (+ ReLU) on the card, each fp32 side
    on its own ReLU mask, and no further from it than cuDNN's
    (``F.batch_norm`` + ``F.relu`` in fp32); a channels-last input runs the
    kernels on an NCHW copy, bit-equal; the launches counted, none falling
    back. Then each shape timed with CUDA events: the kernels, the plain
    version (cuDNN's batch norm + ``F.relu``), the library's batch norm
    alone, and the bound of the function's bytes."""
    phase("3c. batch-norm kernels vs float64 and cuDNN on the card")
    from torch.nn import functional as F

    from dynamorph_tpu_torch.ops import batch_norm as bn_ops

    def ours_fn(relu):
        return lambda x, g, b, rm, rv: bn_ops.batch_norm_train(
            x, g, b, rm, rv, BN_MOMENTUM, BN_EPS, relu)

    def cudnn_fn(relu):
        def fn(x, g, b, rm, rv):
            y = F.batch_norm(x, rm, rv, g, b, True, BN_MOMENTUM, BN_EPS)
            return F.relu(y) if relu else y
        return fn

    def float64(ins, relu, mask):
        x, dy, *p = [t.double() for t in ins]

        def fn(xg, g, b, rm, rv):
            y = F.batch_norm(xg, rm, rv, g, b, True, BN_MOMENTUM, BN_EPS)
            return y * mask.double() if relu else y
        return bn_through_autograd(torch, fn, x, dy, *p)

    def rel(a, b):
        b = b.double()
        return float(torch.linalg.vector_norm(a.double() - b) /
                     max(float(torch.linalg.vector_norm(b)), 1e-300))

    names = ("y", "running_mean", "running_var", "dx", "dgamma", "dbeta")
    limits = (BN_RTOL,) * 3 + (BN_GRAD_RTOL,) * 3
    cases = sorted({(s, r) for steps in BN_STEPS.values()
                    for s, r, _ in steps})
    bn_zero()
    calls, errs = 0, {}
    for i, (shape, relu) in enumerate(cases):
        ins = bn_inputs(torch, shape, dev, SEED + i)
        ours = bn_through_autograd(torch, ours_fn(relu), *ins)
        cud = bn_through_autograd(torch, cudnn_fn(relu), *ins)
        calls += 1
        ref = float64(ins, relu, ours[0] > 0)
        ref_c = float64(ins, relu, cud[0] > 0) if relu else ref
        e = {k: rel(a, b) for k, a, b in zip(names, ours, ref)}
        ec = {k: rel(a, b) for k, a, b in zip(names, cud, ref_c)}
        flips = int(((ours[0] > 0) != (cud[0] > 0)).sum()) if relu else 0
        key = f"{'x'.join(map(str, shape))}{'_relu' if relu else ''}"
        errs[key] = dict(kernel=e, cudnn=ec, mask_flips=flips,
                         max_abs_y=float((ours[0] - ref[0]).abs().max()))
        log(f"{key}: kernel vs float64 " + ", ".join(
            f"{k} {e[k]:.3e}" for k in names) + "; cuDNN " + ", ".join(
            f"{k} {ec[k]:.3e}" for k in names)
            + f"; ReLU masks differ on {flips} elements")
        for k, limit in zip(names, limits):
            if not e[k] <= limit:
                raise AssertionError(f"batch norm {key}: {k} {e[k]:.3e} "
                                     f"from float64, over {limit}")
            # a floor of a few fp32 ulps where cuDNN's own error is lower
            if not e[k] <= max(ec[k], 2e-7):
                raise AssertionError(f"batch norm {key}: {k} {e[k]:.3e} "
                                     f"from float64, cuDNN {ec[k]:.3e}")
        del ins, ours, cud, ref, ref_c
        torch.cuda.empty_cache()

    # a channels-last input: the kernels on an NCHW copy, the same bits
    ins = bn_inputs(torch, BN_STEPS["z16"][0][0], dev, SEED)
    nchw = bn_through_autograd(torch, ours_fn(True), *ins)
    last = bn_through_autograd(
        torch, ours_fn(True),
        ins[0].contiguous(memory_format=torch.channels_last), *ins[1:])
    calls += 2
    if not all(torch.equal(a, b) for a, b in zip(nchw, last)):
        raise AssertionError("a channels-last input does not give the NCHW "
                             "input's bits")
    launches, fallbacks = bn_counted()
    log(f"launches {launches} (want {calls}), fallbacks {fallbacks} "
        f"(want 0); a channels-last input bit-equal to NCHW")
    if (launches, fallbacks) != (calls, 0):
        raise AssertionError("batch_norm_train did not take the kernels on "
                             "every fp32 call on the card")
    del ins, nchw, last

    timed = {}
    for i, (shape, relu) in enumerate(cases):
        x, dy, g, b, rm, rv = bn_inputs(torch, shape, dev, SEED + i)
        blocks = bn_ops._blocks(x)
        y, mean, invstd = bn_ops._forward_cuda(x, g, b, rm, rv, BN_MOMENTUM,
                                               BN_EPS, relu, blocks)
        fwd = time_cuda(torch, lambda: bn_ops._forward_cuda(
            x, g, b, rm, rv, BN_MOMENTUM, BN_EPS, relu, blocks), 20)
        bwd = time_cuda(torch, lambda: bn_ops._backward_cuda(
            x, dy, mean, invstd, g, b, relu, blocks), 20)
        xg = x.clone().requires_grad_(True)
        gg, bg = g.clone().requires_grad_(True), b.clone().requires_grad_(True)
        out = {}
        for what, fn in (("plain", cudnn_fn(relu)), ("library",
                                                    cudnn_fn(False))):
            out[f"{what}_fwd"] = time_cuda(
                torch, lambda: fn(xg, gg, bg, rm, rv).detach(), 20)
            yy = fn(xg, gg, bg, rm, rv)
            out[f"{what}_bwd"] = time_cuda(torch, lambda: torch.autograd.grad(
                yy, [xg, gg, bg], dy, retain_graph=True), 20)
            del yy
        s = x.numel() * 4
        key = (shape, relu)
        timed[key] = dict(
            fwd_ms=fwd, bwd_ms=bwd, ms=fwd + bwd,
            plain_ms=out["plain_fwd"] + out["plain_bwd"],
            library_ms=out["library_fwd"] + out["library_bwd"],
            # the function's least bytes: x read and y written forward;
            # x and dy read, dx written backward
            bound_ms=5 * s / HBM_BYTES_PER_S * 1e3,
            # the two-pass algorithm's: x twice and y; x and dy twice, dx
            two_pass_bound_ms=8 * s / HBM_BYTES_PER_S * 1e3, blocks=blocks)
        log(f"{'x'.join(map(str, shape))}{' relu' if relu else ''}: kernels "
            f"{fwd:.4f} + {bwd:.4f} ms ({blocks} blocks), plain (cuDNN + "
            f"ReLU) {out['plain_fwd']:.4f} + {out['plain_bwd']:.4f}, library "
            f"(cuDNN) {out['library_fwd']:.4f} + {out['library_bwd']:.4f}; "
            f"bound {timed[key]['bound_ms']:.4f} (5S), two-pass "
            f"{timed[key]['two_pass_bound_ms']:.4f} (8S)")
        del x, dy, y, xg
        torch.cuda.empty_cache()
    steps = {}
    for name, rows in BN_STEPS.items():
        tot = {k: sum(n * timed[(s, r)][k] for s, r, n in rows)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "two_pass_bound_ms")}
        tot["bound_share"] = tot["bound_ms"] / tot["ms"]
        tot["two_pass_bound_share"] = tot["two_pass_bound_ms"] / tot["ms"]
        steps[name] = tot
        log(f"{name} step ({BN_A_STEP[name]} batch norms): kernels "
            f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f}, library "
            f"{tot['library_ms']:.4f}; bound {tot['bound_ms']:.4f} ms (share "
            f"{tot['bound_share']:.4f}), two-pass bound "
            f"{tot['two_pass_bound_ms']:.4f} (share "
            f"{tot['two_pass_bound_share']:.4f})")
    return dict(errs=errs, launches=launches, timed=timed, steps=steps)


# ---------------------------------------------------------------- phase 4


def write_well(torch, root):
    """A synthetic well (float64 static patches as the reference writes
    them) and a seeded random-init VQ_VAE_z16 model.pt. The codebook is
    drawn from the model's own latents so the lookup spreads over many
    codes."""
    from dynamorph_tpu_torch.io.pickles import save_pickle
    from dynamorph_tpu_torch.models import VQVAEz16
    from dynamorph_tpu_torch.train.data import zscore_patch

    rng = np.random.RandomState(SEED)
    raw, supp, weights = (os.path.join(root, p)
                          for p in ("raw", "supp", "weights"))
    for p in (raw, supp, weights):
        os.makedirs(p)
    sites = ["C5-Site_0", "C5-Site_1"]
    fs = [f"{supp}/C5-supps/{sites[i % 2]}/{i // 2}_{i}.h5"
          for i in range(N_PATCHES)]
    data = blob_patches(rng, N_PATCHES)[:, :, None]  # (N, 2, 1, 128, 128)
    save_pickle(fs, os.path.join(raw, "C5_file_paths.pkl"))
    save_pickle(data, os.path.join(raw, "C5_static_patches.pkl"))

    torch.manual_seed(SEED)
    model = VQVAEz16(num_inputs=2, **NET)
    x = torch.from_numpy(zscore_patch(data[:64, :, 0]).astype(np.float32))
    zb, _, _ = model.encode(x)
    rows = zb.permute(0, 2, 3, 1).reshape(-1, NET["num_hiddens"])
    pick = torch.randperm(len(rows), generator=torch.Generator().manual_seed(
        SEED))[:NET["num_embeddings"]]
    model.vq.w.weight.data.copy_(rows[pick] + 0.01 * rows.std(0) *
                                 torch.randn(len(pick), rows.shape[1]))
    torch.save(model.state_dict(), os.path.join(weights, "model.pt"))
    cfg = os.path.join(root, "cfg.yml")
    with open(cfg, "w") as f:
        f.write("latent_encoding:\n"
                f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{supp}']\n"
                f"  weights: ['{weights}']\n  fov: {sites}\n"
                "  save_output: False\n  network: 'VQ_VAE_z16'\n"
                f"  num_hiddens: {NET['num_hiddens']}\n"
                f"  num_residual_hiddens: {NET['num_residual_hiddens']}\n"
                f"  num_embeddings: {NET['num_embeddings']}\n")
    return raw, weights, cfg, data


def check_flips_vs_latents(torch, what, zc, zg, ea, eb):
    """Card-vs-CPU code flips (CPU latent rows ``zc`` chose codes ``ea``,
    card rows ``zg`` chose ``eb``) are allowed only at a near-tie, widened
    by what the latents' own difference can move the gap:
    |d(z, b) - d(z, a) - (d(z', b) - d(z', a))| <= 2 |z - z'| |E_a - E_b|.
    Returns the largest gap / allowance."""
    zc, zg, ea, eb = zc.double(), zg.double(), ea.double(), eb.double()
    gap, allowed = tie_gap(torch, zc, ea, eb)
    room = allowed + 2 * torch.norm(zc - zg, dim=1) * \
        torch.norm(ea - eb, dim=1)
    if bool((gap > room).any()):
        raise AssertionError(f"{what}: card vs CPU code flips beyond the "
                             "latents' own difference")
    return float((gap / room).max())


def codes_of(torch, z_after_rows, codebook):
    """Code index of each post-VQ row (rows are exact codebook rows)."""
    d = torch.cdist(z_after_rows.double(), codebook.double(),
                    compute_mode="donot_use_mm_for_euclid_dist")
    val, idx = torch.min(d, dim=1)
    if float(val.max()) != 0.0:
        raise AssertionError("a z_after row is not a codebook row")
    return idx


def phase_main_path(torch, vq, root):
    phase("4. encode path: run_vae -m process, VQ_VAE_z16, on cuda")
    from dynamorph_tpu_torch.cli import run_vae
    from dynamorph_tpu_torch.io.pickles import load_pickle
    from dynamorph_tpu_torch.models import VQVAEz16
    from dynamorph_tpu_torch.pipeline.patch_vae import encode_patches

    raw, weights, cfg, data = write_well(torch, root)
    log(f"synthetic well: {N_PATCHES} patches (float64 (N, 2, 1, 128, 128)),"
        f" batch {BATCH}")

    vq.vq_lookup.launches = 0
    t0 = time.perf_counter()
    run_vae.main(["-m", "process", "-c", cfg, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = vq.vq_lookup.launches
    want = -(-N_PATCHES // BATCH)
    log(f"run_vae -m process: {wall:.3f} s wall for {N_PATCHES} patches "
        f"(load + encode + write), {N_PATCHES / wall:.1f} patches/s; "
        f"vq_lookup launches {launches}")
    if launches < 1:
        raise AssertionError("the main path did not launch the vq_lookup "
                             "kernel")
    if launches != want:
        raise AssertionError(f"expected {want} kernel launches, saw "
                             f"{launches}")

    out = os.path.join(raw, "weights")
    names = sorted(os.listdir(out))
    if names != ["C5_latent_space.pkl", "C5_latent_space_after.pkl"]:
        raise AssertionError(f"unexpected outputs {names}")
    z_b = load_pickle(os.path.join(out, names[0]))
    z_a = load_pickle(os.path.join(out, names[1]))
    for name, z in zip(names, (z_b, z_a)):
        if z.shape != (N_PATCHES, 4096) or z.dtype != np.float32 or \
                not np.isfinite(z).all():
            raise AssertionError(f"{name}: {z.shape} {z.dtype}")
    log(f"outputs {names}, each ({N_PATCHES}, 4096) float32, finite")

    # the first 64 patches through the port's CPU path
    cpu_model = VQVAEz16(num_inputs=2, **NET)
    cpu_model.load_state_dict(torch.load(os.path.join(weights, "model.pt")))
    zb_cpu, za_cpu = encode_patches(cpu_model, data[:64, :, 0], 64,
                                    normalize="patch", device="cpu")
    err = float(np.max(np.abs(zb_cpu - z_b[:64])))
    log(f"z_before card vs CPU, first 64 patches: max abs {err:.3e} "
        f"(limit {LATENT_ATOL})")
    if not err <= LATENT_ATOL:
        raise AssertionError("z_before disagrees with the CPU path")
    cb = cpu_model.vq.w.weight.detach()

    def rows(z):
        return torch.from_numpy(z).reshape(-1, 16, 256).permute(0, 2, 1) \
            .reshape(-1, 16)

    idx_gpu = codes_of(torch, rows(z_a[:64]), cb)
    idx_cpu = codes_of(torch, rows(za_cpu), cb)
    n_codes = len(torch.unique(idx_gpu))
    flips = torch.nonzero(idx_gpu != idx_cpu).flatten()
    if len(flips):
        worst = check_flips_vs_latents(
            torch, "z_after", rows(zb_cpu)[flips], rows(z_b[:64])[flips],
            cb[idx_cpu[flips]], cb[idx_gpu[flips]])
        log(f"largest flip gap / allowance {worst:.3e}")
    log(f"z_after card vs CPU, first 64 patches: {len(flips)} code flips of "
        f"{len(idx_gpu)} latent positions (near-ties), {n_codes} distinct "
        "codes used")
    if n_codes < 2:
        raise AssertionError("the lookup collapsed onto one code")
    return dict(launches=launches, wall=wall, data=data, weights=weights)


# ---------------------------------------------------------------- phase 5


def write_training_dir(root):
    """A raw dir with im_static_patches (float32 (N, 2, 1, 128, 128)),
    labels and trajectory relations, and its training config at the widths
    of configs/config_example.yml. Returns (config path, output dir)."""
    from dynamorph_tpu_torch.io.pickles import save_pickle

    raw, supp, weights = (os.path.join(root, p)
                          for p in ("train_raw", "train_supp", "train_out"))
    os.makedirs(raw)
    data = blob_patches(np.random.RandomState(SEED + 1), N_TRAIN_PATCHES)
    save_pickle(data[:, :, None].astype(np.float32),
                os.path.join(raw, "im_static_patches.pkl"))
    save_pickle(np.arange(N_TRAIN_PATCHES),
                os.path.join(raw, "im_static_patches_labels.pkl"))
    save_pickle(trajectory_relations(N_TRAIN_PATCHES),
                os.path.join(raw, "im_static_patches_relations.pkl"))
    net = TRAIN_NET
    cfg = os.path.join(root, "train_cfg.yml")
    with open(cfg, "w") as f:
        f.write("training:\n"
                f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{supp}']\n"
                f"  weights_dirs: ['{weights}']\n"
                "  network: 'VQ_VAE_z32'\n"
                + "".join(f"  {k}: {net[k]}\n" for k in (
                    "num_inputs", "num_hiddens", "num_residual_hiddens",
                    "num_residual_layers", "num_embeddings",
                    "commitment_cost", "weight_matching", "margin", "w_a",
                    "w_t", "w_n"))
                + f"  n_epochs: {TRAIN_EPOCHS}\n  learn_rate: 0.0001\n"
                f"  batch_size: {TRAIN_BATCH}\n  val_split_ratio: 0.15\n"
                "  shuffle_data: False\n  transform: True\n"
                "  patience: 100\n  model_name: 'vqvae32'\n"
                "  use_mask: False\n")
    return cfg, os.path.join(weights, "vqvae32"), data


def phase_training_path(torch, vq, root, dev):
    phase("5. training path: run_training, VQ_VAE_z32, on cuda")
    from dynamorph_tpu_torch.cli import run_training
    from dynamorph_tpu_torch.models import VQVAEz32
    from dynamorph_tpu_torch.models.jax_import import (
        load_reference_checkpoint)
    from dynamorph_tpu_torch.train.data import zscore

    cfg, out, data = write_training_dir(root)
    n_val = int(np.floor(0.15 * N_TRAIN_PATCHES))
    n_train = N_TRAIN_PATCHES - n_val
    want_train = TRAIN_EPOCHS * -(-n_train // TRAIN_BATCH)
    want_val = TRAIN_EPOCHS * -(-n_val // TRAIN_BATCH)
    log(f"synthetic training dir: {N_TRAIN_PATCHES} patches (float32 "
        f"(N, 2, 1, 128, 128)), trajectories of {TRAJ_LEN}; {n_train} train "
        f"and {n_val} val patches, batch {TRAIN_BATCH}")

    vq.vq_indices.launches = 0
    vq.vq_lookup.launches = 0
    bn_zero()
    t0 = time.perf_counter()
    model, hist = run_training.main(["-c", cfg, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    li, ll = vq.vq_indices.launches, vq.vq_lookup.launches
    bn = bn_counted()
    want_bn = BN_A_STEP["z32"] * want_train
    log(f"run_training: {wall:.3f} s wall for {TRAIN_EPOCHS} epochs (load, "
        f"z-score, reorder, train, validate, checkpoint); vq_indices "
        f"launches {li} (want {want_train}), vq_lookup launches {ll} (want "
        f"{want_val}); batch_norm launches {bn[0]} (want {want_bn}), "
        f"fallbacks {bn[1]} (want 0)")
    if bn != (want_bn, 0):
        raise AssertionError("the training path did not run every "
                             "training-mode batch norm on the kernels")
    for h in hist:
        log(f"epoch {h['epoch']}: train "
            + json.dumps({k: round(v, 6) for k, v in h["train"].items()})
            + " val " + json.dumps({k: round(v, 6)
                                   for k, v in h["val"].items()}))
    if li < 1 or li != want_train:
        raise AssertionError("the training path did not launch vq_indices "
                             "once per training step")
    if ll != want_val:
        raise AssertionError("the training path did not launch vq_lookup "
                             "once per validation step")
    if len(hist) != TRAIN_EPOCHS or not all(
            np.isfinite(v) for h in hist for split in ("train", "val")
            for v in h[split].values()):
        raise AssertionError("missing epochs or non-finite losses")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        n_lines = len(f.read().splitlines())
    if n_lines != 2 * TRAIN_EPOCHS:
        raise AssertionError(f"metrics.jsonl has {n_lines} lines")
    fresh = VQVAEz32(**TRAIN_NET)
    fresh.load_state_dict(load_reference_checkpoint(
        os.path.join(out, "model.pt")), strict=True)
    fresh.to(dev)
    x = torch.from_numpy(zscore(data[:8]).astype(np.float32)).to(dev)
    z_b, z_a, idx = fresh.encode(x)
    torch.cuda.synchronize()
    if tuple(z_b.shape) != (8, 64, 32, 32) or tuple(idx.shape) != (8, 32, 32) \
            or not bool(torch.isfinite(z_b).all()) \
            or not bool(torch.isfinite(z_a).all()):
        raise AssertionError("the trained model.pt does not encode")
    log(f"model.pt loads strictly into a fresh VQVAEz32 and encodes 8 "
        f"patches on the card: {len(torch.unique(idx))} codes used; "
        f"metrics.jsonl {n_lines} lines")
    return dict(launches_indices=li, launches_lookup=ll, wall=wall,
                hist=hist, launches_batch_norm=bn[0])


# ---------------------------------------------------------------- phase 6


def pre_bn_biases(model):
    """Conv biases that feed a batch norm: their exact gradient is 0."""
    from torch import nn

    names = set()
    for prefix, mod in model.named_modules():
        if isinstance(mod, nn.Sequential):
            for i in range(len(mod) - 1):
                if isinstance(mod[i], (nn.Conv2d, nn.ConvTranspose2d)) and \
                        isinstance(mod[i + 1], nn.BatchNorm2d):
                    names.add(f"{prefix}.{i}.bias")
    return names


def phase_step_vs_cpu(torch, dev):
    """One train step (Adam, no augmentation) from the same weights on the
    card and on the CPU. The card's codebook indices are replayed into the
    CPU step, so both differentiate the same assignment; where the CPU's
    own search disagrees, it must be at a near-tie widened by the latents'
    own difference. Each fp32 step's gradients are held against the same
    step in float64 taken on that fp32 step's side of every kink
    (``kink_branches``: the ReLUs and the time-matching loss's clamps), as
    phase 12 holds its steps, and a control step with its backward in
    TF32 must land over the limit."""
    phase("6. one training step, card vs CPU (VQ_VAE_z32, full width)")
    from dynamorph_tpu_torch.models import VQVAEz32
    from dynamorph_tpu_torch.models import vqvae as vqvae_mod
    from dynamorph_tpu_torch.train.data import zscore
    from dynamorph_tpu_torch.train.steps import make_train_step

    torch.manual_seed(SEED + 4)
    base = VQVAEz32(**TRAIN_NET)
    rng = np.random.RandomState(SEED + 4)
    x = zscore(blob_patches(rng, 8)).astype(np.float32)
    mask = (rng.rand(8, 1, 128, 128) > 0.3).astype(np.uint8)
    rel = relation_block(8, 4)
    real = vqvae_mod.vq_indices
    seen = {}

    def recording(z, cb, precision="highest"):
        idx = real(z, cb, precision=precision)
        seen["z"], seen["idx"] = z.detach().clone(), idx
        return idx

    def replaying(z, cb, precision="highest"):
        seen["cpu_z"] = z.detach().clone()
        seen["cpu_idx"] = real(z, cb, precision=precision)
        return seen["idx"].to(z.device)

    def replaying_f64(z, cb, precision="highest"):
        return seen["idx"].to(z.device)

    def run(device, search, dtype=torch.float32, masks=None, replay=False):
        model = copy.deepcopy(base).to(device=device, dtype=dtype)
        step = make_train_step(model, torch.optim.Adam(
            model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8),
            augment=False)
        vqvae_mod.vq_indices = search
        try:
            with kink_branches(torch, masks, replay) if masks is not None \
                    else contextlib.nullcontext():
                losses = step(torch.from_numpy(x).to(device, dtype), rel,
                              mask)
        finally:
            vqvae_mod.vq_indices = real
        grads = {n: p.grad.detach().cpu().double() for n, p in
                 model.named_parameters()}
        bufs = {n: b.detach().cpu() for n, b in model.named_buffers()
                if "running" in n}
        return {k: float(v.detach()) for k, v in losses.items()}, grads, bufs

    m_gpu, m_cpu, m_f64 = [], [], []
    l_gpu, g_gpu, b_gpu = run(dev, recording, masks=m_gpu)
    l_cpu, g_cpu, b_cpu = run("cpu", replaying, masks=m_cpu)
    run("cpu", replaying_f64, torch.float64, masks=m_f64)
    _, g_f64, _ = run("cpu", replaying_f64, torch.float64, masks=m_gpu,
                      replay=True)
    _, g_f64c, _ = run("cpu", replaying_f64, torch.float64, masks=m_cpu,
                       replay=True)

    def kink_flips(masks):
        return sum(int((a != b).sum()) for a, b in zip(masks, m_f64))

    n_choices = sum(int(m.numel()) for m in m_f64)
    log(f"kink choices (ReLU masks, clamps) against float64's own: card "
        f"{kink_flips(m_gpu)}, CPU {kink_flips(m_cpu)} of {n_choices} "
        "flipped; each float64 step below takes its fp32 step's choices")

    d = TRAIN_NET["num_hiddens"]
    idx_g, idx_c = seen["idx"].cpu().reshape(-1), seen["cpu_idx"].reshape(-1)
    flips = torch.nonzero(idx_g != idx_c).flatten()
    if len(flips):
        cb = base.vq.w.weight.detach()
        check_flips_vs_latents(
            torch, "training step", seen["cpu_z"].reshape(-1, d)[flips],
            seen["z"].cpu().reshape(-1, d)[flips], cb[idx_c[flips].long()],
            cb[idx_g[flips].long()])
    z_err = float(torch.max(torch.abs(seen["z"].cpu() - seen["cpu_z"])))
    log(f"z_before (train-mode batch norm) card vs CPU max abs {z_err:.3e}; "
        f"{len(flips)} of {len(idx_g)} codes flip between card and CPU "
        "(near-ties; the card's codes are replayed on the CPU)")

    worst_loss = 0.0
    for k in l_cpu:
        err = abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-6)
        worst_loss = max(worst_loss, err)
        log(f"  {k}: card {l_gpu[k]!r} cpu {l_cpu[k]!r} rel {err:.3e}")
    if worst_loss > STEP_LOSS_RTOL:
        raise AssertionError(f"losses differ by {worst_loss:.3e} relative")

    def rel_l2(a, b):
        return float(torch.norm(a - b) / max(float(torch.norm(b)), 1e-30))

    zero = pre_bn_biases(base)
    weights = [n for n in g_cpu if n.endswith(".weight")]

    def vs_f64(grads, ref=g_f64):
        return {n: rel_l2(grads[n], ref[n]) for n in weights}

    e_gpu, e_cpu = vs_f64(g_gpu), vs_f64(g_cpu, g_f64c)
    direct = {n: rel_l2(g_gpu[n], g_cpu[n]) for n in weights}
    ratio = {n: e_gpu[n] / (STEP_GRAD_VS_CPU * e_cpu[n] + STEP_GRAD_FLOOR)
             for n in weights}
    worst = max(ratio, key=ratio.get)
    for n in sorted({"vq.w.weight", "enc.0.weight", "dec.4.weight", worst,
                     max(direct, key=direct.get)}):
        log(f"  grad {n}: vs float64 card {e_gpu[n]:.3e} cpu {e_cpu[n]:.3e}; "
            f"card vs cpu {direct[n]:.3e}")
    zero_max = max(float(torch.max(torch.abs(g_gpu[n]))) for n in zero)
    log(f"  worst weight {worst}: card error / (3 cpu error + 1e-5) = "
        f"{ratio[worst]:.3f} (limit 1); zero-gradient conv biases on the "
        f"card at most {zero_max:.3e}")
    if ratio[worst] > 1:
        raise AssertionError(f"gradient {worst}: the card is "
                             f"{e_gpu[worst]:.3e} from float64, the CPU "
                             f"{e_cpu[worst]:.3e}")
    bn_err = max(float(torch.max(torch.abs(b_gpu[n] - b_cpu[n])))
                 for n in b_cpu)
    log(f"  batch-norm running buffers after the step: max abs {bn_err:.3e} "
        f"(limit {STEP_BN_ATOL})")
    if bn_err > STEP_BN_ATOL:
        raise AssertionError("batch-norm buffers differ")

    # control: the same forward (fp32_strict inside apply), but backward()
    # after the block has closed, with TF32 on: what the gradient check
    # would see if the train step left its backward out. Its forward is the
    # card's, so it is held against float64 on the card's side of every kink
    model = copy.deepcopy(base).to(dev)
    tf32 = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    vqvae_mod.vq_indices = lambda z, cb, precision="highest": seen["idx"]
    try:
        _, losses = model.apply(
            torch.from_numpy(x).to(dev), train=True, time_matching_mat=rel,
            batch_mask=torch.from_numpy(mask).to(dev).float())
        losses["total_loss"].backward()
    finally:
        vqvae_mod.vq_indices = real
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    g_ctrl = {n: p.grad.detach().cpu().double()
              for n, p in model.named_parameters()}
    e_ctrl = vs_f64(g_ctrl)
    ctrl = {n: e_ctrl[n] / (STEP_GRAD_VS_CPU * e_cpu[n] + STEP_GRAD_FLOOR)
            for n in weights}
    ctrl_worst = max(ctrl, key=ctrl.get)
    log(f"control, backward outside fp32_strict with TF32 on: vs float64 "
        f"enc.0.weight {e_ctrl['enc.0.weight']:.3e}, dec.4.weight "
        f"{e_ctrl['dec.4.weight']:.3e}; worst {ctrl_worst} at "
        f"{ctrl[ctrl_worst]:.3f} of the limit")
    if not ctrl[ctrl_worst] > 1:
        raise AssertionError(f"the TF32 control step lands at "
                             f"{ctrl[ctrl_worst]:.3f} of the limit: the "
                             "check cannot see TF32 in the backward")
    return dict(loss_rel=worst_loss, grad_ratio=ratio[worst],
                grad_vs_f64=e_gpu[worst], grad_cpu_vs_f64=e_cpu[worst],
                bn_abs=bn_err, flips=len(flips), control=ctrl[ctrl_worst],
                kink_flips_card=kink_flips(m_gpu),
                kink_flips_cpu=kink_flips(m_cpu), kink_choices=n_choices)


# ---------------------------------------------------------------- phase 7


def time_cuda(torch, fn, iters):
    """ms per call of ``fn`` launched from Python, between two CUDA events:
    what a caller sees, the host's cost of each launch included."""
    for _ in range(3):
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


def time_graph(torch, fn, iters, replays=5):
    """Device ms per call of ``fn``: ``iters`` calls captured into one CUDA
    graph and replayed between two CUDA events, so the Python cost of each
    launch is outside the timed region."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


def bound(nbytes, flops):
    """(ms, what bounds it): the larger of the bytes over the HBM rate and
    the fp32 operations over the fp32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def vq_bound(n, d, k):
    # z, E in; q, idx out. Distances and code norms.
    return bound(4 * (n * d + k * d + n * d + n), 2 * n * k * d + 2 * k * d)


def indices_bound(n, d, k):
    """vq_indices: z and E in, idx out; the distance products (the code
    norms, 2 K D, are below the rounding of the bound and left out)."""
    return bound(4 * (n * d + k * d + n), 2 * n * k * d)


# kernel families of a training step, matched in this order on the
# lowercased kernel name (cuDNN's batch-norm kernels carry "cudnn" too)
FAMILIES = (
    ("vq_indices kernel", ("vq_indices",)),
    ("vq_lookup kernel", ("vq_lookup",)),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    # "cf32": the complex products of cuDNN's FFT convolutions
    ("convolutions (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                              "winograd", "fft", "cf32")),
    ("matrix products (cuBLAS: gather_codes backward, time-matching)",
     ("gemm", "cutlass")),
    ("Adam (foreach)", ("adam", "multi_tensor")),
)


def family(name, families=FAMILIES,
           other="other (elementwise, reductions, copies, one-hot)"):
    lname = name.lower()
    for fam, keys in families:
        if any(k in lname for k in keys):
            return fam
    return other


def profile_steps(torch, step, n_steps, step_ms, unit="step",
                  families=FAMILIES, other=None, tag=""):
    """Device time per step by kernel family (``families``, the rest under
    ``other``), from torch.profiler, and the share of the step's wall time
    the device was idle. ``tag`` ends every line printed."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        # a record_function range's device-side span is no kernel
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                e.is_user_annotation:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3 / n_steps
    busy = sum(kernels.values())
    if busy <= 0:
        log("torch.profiler saw no device time on this machine")
        return None
    fams = {}
    for name, ms in kernels.items():
        fam = family(name, families, *([other] if other else []))
        fams[fam] = fams.get(fam, 0.0) + ms
    log(f"device busy {busy:.6f} ms per {unit} of {step_ms:.6f} ms: idle "
        f"share {max(0.0, 1 - busy / step_ms):.4f}{tag}")
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        log(f"  {fam}: {ms:.6f} ms ({100 * ms / busy:.1f}%){tag}")
    log("  top kernels:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
        log(f"    {ms:.6f} ms  {name[:110]}")
    return dict(busy_ms=busy, families=fams, kernels=kernels)


# the C entry that reports each tiled kernel's dynamic shared memory
PTXAS_KERNELS = {"vq_lookup_kernel": "vq_lookup_smem_bytes",
                 "vq_indices_kernel": "vq_indices_smem_bytes",
                 "vq_lookup_rowwise_kernel": None}


def kernel_ptxas(build_log):
    """{kernel: {D: registers, static and dynamic shared memory, spills}}
    for every kernel instance, from nvcc's -Xptxas -v log (kept beside the
    library by ops/_build.py, so a cached build has it too)."""
    from dynamorph_tpu_torch.ops._build import load
    from dynamorph_tpu_torch.ops.vq_tile_sweep import ptxas_usage

    lib = load("vq_lookup")
    out = {}
    for kernel, smem_entry in PTXAS_KERNELS.items():
        usage = ptxas_usage(build_log, kernel)
        if smem_entry is not None:
            smem_bytes = getattr(lib, smem_entry)
            smem_bytes.argtypes = [ctypes.c_int]
            smem_bytes.restype = ctypes.c_int
            for d in usage:
                usage[d]["dynamic_smem"] = smem_bytes(d)
        out[kernel] = usage
    return out


def phase_train_timings(torch, vq, indices, dev, ptxas):
    from dynamorph_tpu_torch.models import VQVAEz32
    from dynamorph_tpu_torch.train.data import zscore
    from dynamorph_tpu_torch.train.steps import make_train_step

    n, d, k = TRAIN_SHAPE
    z, cb = indices["random"]["z"], indices["random"]["cb"]

    def kernel():
        return vq._vq_indices_cuda(z, cb)

    def plain():
        return vq.vq_indices_reference(z, cb)

    def library():
        e2 = torch.sum(cb * cb, dim=1)
        return torch.argmin(torch.addmm(e2, z, cb.T, beta=1.0, alpha=-2.0),
                            dim=1)

    timed = dict(ms_per_call=time_cuda(torch, kernel, 20),
                 ms=time_graph(torch, kernel, 20),
                 plain_ms=time_graph(torch, plain, 20),
                 library_ms=time_graph(torch, library, 20))
    timed["bound_ms"], timed["bound_by"] = indices_bound(n, d, k)
    log(f"vq_indices z32 training N={n} D={d} K={k}: kernel "
        f"{timed['ms']:.6f} ms device ({timed['ms_per_call']:.6f} ms per "
        f"call), bound {timed['bound_ms']:.6f} ms ({timed['bound_by']}), "
        f"plain {timed['plain_ms']:.6f} ms, library (sum + addmm + argmin) "
        f"{timed['library_ms']:.6f} ms")
    timed["bound_share"] = timed["bound_ms"] / timed["ms"]
    # None where the build log is missing
    timed["ptxas"] = ptxas["vq_indices_kernel"].get(d)
    log(f"vq_indices share of its bound: {timed['bound_share']:.4f} "
        f"({FP32_FLOP_PER_S * timed['bound_share'] / 1e12:.1f} TFLOP/s "
        f"of fp32); ptxas at D={d}: " + json.dumps(timed["ptxas"]))

    idx = kernel()
    ct = torch.randn(n, d, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(SEED))
    gather_ms = time_graph(torch, lambda: vq.gather_codes_grad(idx, ct, k),
                           10)
    index_add_ms = time_graph(
        torch, lambda: torch.zeros(k, d, device=dev).index_add_(0, idx, ct),
        10)
    log(f"gather_codes backward (one-hot product, fp32) N={n} K={k} D={d}: "
        f"{gather_ms:.6f} ms device; index_add_ (atomics, the backward of "
        f"index_select) {index_add_ms:.6f} ms")

    torch.manual_seed(SEED)
    model = VQVAEz32(**TRAIN_NET).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                           eps=1e-8)
    step = make_train_step(model, opt, augment=True,
                           generator=torch.Generator(device=dev)
                           .manual_seed(SEED))
    x = torch.from_numpy(zscore(blob_patches(
        np.random.RandomState(SEED + 5), TRAIN_BATCH)).astype(np.float32))
    x = x.to(dev)
    rel = torch.from_numpy(relation_block(TRAIN_BATCH)).to(dev)

    def one_step():
        return step(x, rel, None)

    torch.cuda.reset_peak_memory_stats()
    bn_zero()
    step_ms = time_cuda(torch, one_step, 10)
    bn = bn_counted()
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"z32 train step, batch {TRAIN_BATCH}, device-resident batch, "
        f"augmentation and relation block on: {step_ms:.6f} ms, "
        f"{TRAIN_BATCH / step_ms * 1e3:.1f} patches/s; peak device memory "
        f"{peak:.3f} GB; batch_norm launches {bn[0]} over 13 steps, "
        f"fallbacks {bn[1]}")
    if bn != (13 * BN_A_STEP["z32"], 0):     # 3 warm-up steps and 10 timed
        raise AssertionError("the timed z32 step did not run every batch "
                             "norm on the kernels")
    prof = profile_steps(torch, one_step, 3, step_ms)
    return dict(indices=timed, gather_ms=gather_ms, index_add_ms=index_add_ms,
                step_ms=step_ms, peak_gb=peak, profile=prof,
                launches_batch_norm=bn[0] // 13)


def phase_encode_z32(torch, dev):
    """The z32 encode on a device-resident batch of 512 at the published
    widths: ms per encode, and from torch.profiler the device time of the
    lookup kernel and of the NCHW -> NHWC copy of the latents before it
    (``_lookup_nchw``: the only copy kernel of the encode)."""
    from dynamorph_tpu_torch.models import VQVAEz32

    torch.manual_seed(SEED)
    model = VQVAEz32(**TRAIN_NET).to(dev)
    x = torch.randn(BATCH, TRAIN_NET["num_inputs"], 128, 128, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))

    def encode():
        return model.encode(x)

    ms = time_cuda(torch, encode, 10)
    log(f"z32 encode, device-resident batch of {BATCH}: {ms:.6f} ms, "
        f"{BATCH / ms * 1e3:.1f} patches/s")
    prof = profile_steps(torch, encode, 3, ms, unit="encode")
    if prof is None:
        return dict(ms=ms)
    busy = prof["busy_ms"]
    lookup_ms = sum(v for name, v in prof["kernels"].items()
                    if "vq_lookup" in name)
    copy_ms = sum(v for name, v in prof["kernels"].items()
                  if "copy" in name.lower())
    log(f"z32 encode: vq_lookup kernel {lookup_ms:.6f} ms "
        f"({lookup_ms / busy:.4f} of the device time), NCHW -> NHWC "
        f"permute copy {copy_ms:.6f} ms ({copy_ms / busy:.4f})")
    return dict(ms=ms, busy_ms=busy, lookup_ms=lookup_ms,
                lookup_share=lookup_ms / busy, copy_ms=copy_ms,
                copy_share=copy_ms / busy)


def phase_timings(torch, vq, compared, main, dev, ptxas):
    phase("7. timings (CUDA events, warm L2, after 3 warm-up calls)")
    from dynamorph_tpu_torch.core.device import fp32_strict
    from dynamorph_tpu_torch.models import VQVAEz16
    from dynamorph_tpu_torch.pipeline.patch_vae import encode_patches

    for kernel, usage in ptxas.items():
        for d, u in sorted(usage.items()):
            log(f"ptxas {kernel} D={d}: " + json.dumps(u))
    log("device ms: calls replayed from a CUDA graph; per call: launched "
        "from Python, host cost included")
    timed = {}
    for label, (n, d, k) in (("z16 encode", Z16_SHAPE),
                             ("z32 encode", Z32_SHAPE)):
        z, cb = compared[label]["z"], compared[label]["cb"]
        iters = 200 if label.startswith("z16") else 20

        def kernel():
            return vq._vq_lookup_cuda(z, cb)

        def rowwise():
            return vq._vq_lookup_rowwise_cuda(z, cb)

        def plain():
            return vq.vq_lookup_reference(z, cb)

        def library():
            e2 = torch.sum(cb * cb, dim=1)
            dist = torch.addmm(e2, z, cb.T, beta=1.0, alpha=-2.0)
            idx = torch.argmin(dist, dim=1)
            return torch.index_select(cb, 0, idx), idx

        ms_call = time_cuda(torch, kernel, iters)
        ms = time_graph(torch, kernel, iters)
        rowwise_ms = time_graph(torch, rowwise, iters)
        plain_ms = time_graph(torch, plain, iters)
        library_ms = time_graph(torch, library, iters)
        bound_ms, bound_by = vq_bound(n, d, k)
        timed[label] = dict(ms=ms, ms_per_call=ms_call, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by, bound_share=bound_ms / ms,
                            rowwise_ms=rowwise_ms)
        log(f"vq_lookup {label} N={n} D={d} K={k}: kernel {ms:.6f} ms "
            f"device ({ms_call:.6f} ms per call), bound {bound_ms:.6f} ms "
            f"({bound_by}), share of bound {bound_ms / ms:.4f}; row-wise "
            f"oracle {rowwise_ms:.6f} ms, plain {plain_ms:.6f} ms, library "
            f"(sum + addmm + argmin + index_select) {library_ms:.6f} ms")

    # encode throughput: device-resident batches, and from a host array
    model = VQVAEz16(num_inputs=2, **NET)
    model.load_state_dict(torch.load(os.path.join(main["weights"],
                                                  "model.pt")))
    model.to(dev)
    x = torch.randn(BATCH, 2, 128, 128, device=dev)
    with fp32_strict():
        ms = time_cuda(torch, lambda: model.encode(x), 20)
    log(f"z16 encode, device-resident batch of {BATCH}: {ms:.6f} ms, "
        f"{BATCH / ms * 1e3:.1f} patches/s")
    host = main["data"][:, :, 0].astype(np.float32)
    encode_patches(model, host[:BATCH], BATCH, normalize="patch", device=dev)
    t0 = time.perf_counter()
    encode_patches(model, host, BATCH, normalize="patch", device=dev)
    dt = time.perf_counter() - t0
    log(f"z16 encode_patches from host float32, {len(host)} patches: "
        f"{dt:.4f} s, {len(host) / dt:.1f} patches/s")
    timed["z32 encode model"] = phase_encode_z32(torch, dev)
    return timed


# ---------------------------------------------------------------- phase 8

# U-Net segmentation at the published widths (configs/config_example.yml:
# 20-33: channels [0, 1] of 3, 3 classes, window 256, 5 random passes) on a
# synthetic site of 2 frames of 2048 x 2048, as run_preproc writes them
SEG_WINDOW = 256
SEG_FRAME = 2048
SEG_T = 2
SEG_SUPP = 5
SEG_PROB_ATOL = 1e-4        # card vs CPU, max |d prob|
SEG_SUM_ATOL = 1e-5         # class probabilities sum to 1
# the head's weights scaled so the logits are O(1), where fp32 rounding
# and TF32 show in the probabilities (random init leaves them near 0.2)
SEG_HEAD_SCALE = 30.0
# kernel families of a U-Net forward, matched in this order on the
# lowercased kernel name (cuDNN's batch-norm kernels carry "cudnn" too)
SEG_FAMILIES = (
    ("batch norm (cuDNN)", ("batch_norm", "batchnorm", "bn_fw")),
    ("convolutions (cuDNN)", ("conv", "fprop", "cudnn", "winograd", "fft",
                              "cf32", "gemm", "xmma", "cutlass")),
    ("copies (host <-> card, concat, casts)", ("memcpy", "copy", "memset")),
)
SEG_OTHER = "elementwise (ReLU, add, upsample, max-pool, softmax, scale)"


def seg_model(torch, seed, device):
    """A full-width ``Segment`` with seeded random weights, its batch-norm
    running statistics, scales and offsets moved off the identity, and its
    head scaled by SEG_HEAD_SCALE."""
    from torch import nn

    from dynamorph_tpu_torch.seg.model import Segment

    model = Segment(input_shape=(2, SEG_WINDOW, SEG_WINDOW), n_classes=3,
                    seed=seed, device=device)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.net.modules():
            if isinstance(m, nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(0.2 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
                m.weight.copy_(0.7 + 0.6 * torch.rand(n, generator=g))
                m.bias.copy_(0.2 * torch.randn(n, generator=g))
        model.net.segmentation_head[0].weight.mul_(SEG_HEAD_SCALE)
    return model


def write_seg_site(torch, root):
    """A raw dir with one float64 (T, 3, 1, 2048, 2048) site in uint16
    intensity units (phase, retardance, brightfield: smooth structure plus
    noise), the model.pt and the two configs. Returns (raw dir, site name,
    {mode: config path}, the CPU model)."""
    raw, supp, weights = (os.path.join(root, p)
                          for p in ("seg_raw", "seg_supp", "seg_weights"))
    for p in (raw, supp):
        os.makedirs(p)
    rng = np.random.RandomState(SEED + 6)
    yy, xx = np.mgrid[0:SEG_FRAME, 0:SEG_FRAME].astype(np.float32)
    site = np.empty((SEG_T, 3, 1, SEG_FRAME, SEG_FRAME))
    for t in range(SEG_T):
        wave = np.sin(xx / (31 + 7 * t)) * np.cos(yy / 47)
        site[t, 0, 0] = 30000 + 12000 * wave + 3000 * rng.rand(SEG_FRAME,
                                                                SEG_FRAME)
        site[t, 1, 0] = 8000 + 6000 * wave ** 2 + 1500 * rng.rand(
            SEG_FRAME, SEG_FRAME)
        site[t, 2, 0] = 20000 + 1000 * rng.rand(SEG_FRAME, SEG_FRAME)
    name = "D4-Site_0"
    np.save(os.path.join(raw, f"{name}.npy"), site)
    cpu_model = seg_model(torch, SEED, "cpu")
    cpu_model.save(weights)
    cfgs = {}
    for mode in ("tiled", "direct"):
        cfgs[mode] = os.path.join(root, f"seg_{mode}.yml")
        with open(cfgs[mode], "w") as f:
            f.write("segmentation_inference:\n"
                    f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{supp}']\n"
                    f"  weights: '{weights}'\n  network: 'UNet'\n"
                    "  channels: [0, 1]\n  num_classes: 3\n"
                    f"  window_size: {SEG_WINDOW}\n  batch_size: 8\n"
                    f"  num_pred_rnd: {SEG_SUPP}\n"
                    f"  inference_mode: '{mode}'\n")
    return raw, name, cfgs, cpu_model


class ErrorRecords(logging.Handler):
    """Keeps the messages of the ERROR records it is handed."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def png_size(path):
    """(width, height, bit depth, color type) from a PNG's IHDR."""
    with open(path, "rb") as f:
        head = f.read(29)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    return (int.from_bytes(head[16:20], "big"),
            int.from_bytes(head[20:24], "big"), head[24], head[25])


def check_seg_outputs(raw, name, mode, errors):
    """The stage's artifacts for one run: the probabilities' shape and
    dtype (float64 from the tiled merge, float32 from direct mode, as the
    JAX package writes them), no -1 fill left, classes summing to 1, both
    PNGs, and no failed site in the log."""
    bad = [m for m in errors if "Error in predicting site" in m]
    if bad:
        raise AssertionError(f"{mode}: the stage logged {bad}")
    probs = np.load(os.path.join(raw, f"{name}_NNProbabilities.npy"))
    want = np.float64 if mode == "tiled" else np.float32
    shape = (SEG_T, 3, 1, SEG_FRAME, SEG_FRAME)
    if probs.shape != shape or probs.dtype != want:
        raise AssertionError(f"{mode}: probabilities {probs.shape} "
                             f"{probs.dtype}, want {shape} {want}")
    if (probs == -1).any() or not np.isfinite(probs).all():
        raise AssertionError(f"{mode}: -1 fill or non-finite values left")
    sum_err = float(np.max(np.abs(probs.sum(1) - 1)))
    if sum_err > SEG_SUM_ATOL:
        raise AssertionError(f"{mode}: class sums off 1 by {sum_err:.3e}")
    sizes = [png_size(os.path.join(raw, f"{name}{s}.png"))
             for s in ("", "_NNpred")]
    if sizes != [(SEG_FRAME, SEG_FRAME, 8, 0), (SEG_FRAME, SEG_FRAME, 8, 6)]:
        raise AssertionError(f"{mode}: PNGs {sizes}")
    log(f"{mode}: {name}_NNProbabilities.npy {probs.shape} {probs.dtype}, "
        f"no -1 left, class sums within {sum_err:.3e} of 1; {name}.png "
        f"(8-bit gray) and {name}_NNpred.png (8-bit RGBA) {SEG_FRAME}x"
        f"{SEG_FRAME}; no failed site; mean class probabilities "
        + json.dumps([round(float(v), 4) for v in probs.mean((0, 2, 3, 4))]))
    return probs


def seg_vs_cpu(torch, card_fn, cpu_fn, control_fn, what):
    """max |d prob| of the card against the CPU, and of the TF32 control
    (the card with cuDNN's TF32 on) against the CPU; fails if the card is
    past SEG_PROB_ATOL or the control is not."""
    want = cpu_fn()
    err = float(np.max(np.abs(card_fn() - want)))
    ctrl = float(np.max(np.abs(control_fn() - want)))
    log(f"{what}: card vs CPU max |d prob| {err:.3e} (limit "
        f"{SEG_PROB_ATOL}); TF32 control {ctrl:.3e} "
        f"({ctrl / SEG_PROB_ATOL:.1f}x the limit)")
    if not err <= SEG_PROB_ATOL:
        raise AssertionError(f"{what}: the card disagrees with the CPU")
    if not ctrl > SEG_PROB_ATOL:
        raise AssertionError(f"{what}: the TF32 control lands inside the "
                             "limit, so the check cannot see TF32")
    return err, ctrl


def tf32_probabilities(torch, model, x):
    """``model.probabilities`` with cuDNN's TF32 on, outside fp32_strict."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            return torch.softmax(model.net(x), dim=1)[:, :, None] \
                .cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def conv_flops(torch, model, x):
    """Operations of the convolutions (2 per multiply-add) of one forward
    of ``x``, from the layer shapes met in the forward."""
    from torch import nn

    total = [0]

    def hook(mod, _inp, out):
        k = mod.weight.shape
        total[0] += 2 * out.numel() * k[1] * k[2] * k[3]

    handles = [m.register_forward_hook(hook) for m in model.net.modules()
               if isinstance(m, nn.Conv2d)]
    try:
        model.probabilities(x)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def phase_segmentation(torch, vq, root, dev, card):
    phase("8. segmentation path: run_segmentation -m segmentation, U-Net, "
          "tiled and direct, on cuda")
    from dynamorph_tpu_torch.cli import run_segmentation
    from dynamorph_tpu_torch.seg.data import load_input
    from dynamorph_tpu_torch.seg.inference import (_finish_whole_map,
                                                   predict_whole_map,
                                                   predict_whole_map_direct)

    tag = f" [{card}]"
    t_phase = t0 = time.perf_counter()
    raw, name, cfgs, cpu_model = write_seg_site(torch, root)
    log(f"synthetic site {name}: float64 ({SEG_T}, 3, 1, {SEG_FRAME}, "
        f"{SEG_FRAME}) in {time.perf_counter() - t0:.2f} s; random-init "
        f"U-Net (window {SEG_WINDOW}, channels [0, 1], 3 classes, batch norm"
        f" perturbed, head x{SEG_HEAD_SCALE}) as model.pt")

    timing_log = os.path.join(root, "seg_timing.jsonl")
    os.environ["DYNAMORPH_TIMING_LOG"] = timing_log
    runs = {}
    try:
        for mode in ("tiled", "direct"):
            vq.vq_lookup.launches = 0
            vq.vq_indices.launches = 0
            np.random.seed(SEED)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            errors = ErrorRecords()
            logging.getLogger().addHandler(errors)
            try:
                run_segmentation.main(["-m", "segmentation", "-c",
                                       cfgs[mode], "--device", dev.type])
            finally:
                logging.getLogger().removeHandler(errors)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
            with open(timing_log) as f:
                stage_s = json.loads(f.read().splitlines()[-1])["seconds"]
            log(f"run_segmentation {mode}: {wall:.3f} s wall for {SEG_T} "
                f"frames (load the config, build and load the U-Net, "
                f"segment the site, write), the site stage {stage_s:.3f} s "
                f"({SEG_T / stage_s:.3f} frames/s); peak device memory "
                f"{peak:.3f} GB; vq_lookup launches "
                f"{vq.vq_lookup.launches}, vq_indices launches "
                f"{vq.vq_indices.launches} (this path reaches no Pallas "
                f"kernel){tag}")
            probs = check_seg_outputs(raw, name, mode, errors.messages)
            runs[mode] = dict(wall=wall, stage_s=stage_s, peak_gb=peak,
                              mean_probs=probs.mean((0, 2, 3, 4)).tolist())
    finally:
        del os.environ["DYNAMORPH_TIMING_LOG"]

    # card against CPU on full-width inputs cut from the site
    site = load_input(os.path.join(raw, f"{name}.npy"))[:, :2]
    card_model = seg_model(torch, SEED, dev)
    w = SEG_WINDOW
    tiles = np.stack([site[0, :, 0, r:r + w, c:c + w]
                      for r in (0, 3 * w) for c in (0, 2 * w, 4 * w, 7 * w)]
                     ).astype(np.float32)
    x_card = torch.from_numpy(tiles).to(dev) / 65535.0
    tiles_err = seg_vs_cpu(
        torch, lambda: card_model.predict_raw(tiles),
        lambda: cpu_model.predict_raw(tiles),
        lambda: tf32_probabilities(torch, card_model, x_card),
        f"U-Net, {len(tiles)} tiles of {w}x{w}")
    frame = site[:1, :, :, 3 * w:5 * w, 4 * w:6 * w]
    x_frame = torch.from_numpy(frame[:, :, 0].astype(np.float32)).to(dev) \
        / 65535.0
    direct_err = seg_vs_cpu(
        torch, lambda: predict_whole_map_direct(frame, card_model),
        lambda: predict_whole_map_direct(frame, cpu_model),
        lambda: tf32_probabilities(torch, card_model, x_frame),
        f"direct mode, one {2 * w}x{2 * w} frame")

    # one 2048 x 2048 frame in each mode: end to end from a host array,
    # and the device work alone
    one = site[:1]
    tile_flops = conv_flops(torch, card_model, x_card[:1])
    n_tiles = (SEG_FRAME // SEG_WINDOW) ** 2
    n_supp_tiles = (SEG_FRAME // SEG_WINDOW - 1) ** 2
    flops = {"tiled": tile_flops * (n_tiles + SEG_SUPP * n_supp_tiles),
             "direct": tile_flops * n_tiles}
    x64 = torch.from_numpy(np.stack([
        one[0, :, 0, r:r + SEG_WINDOW, c:c + SEG_WINDOW]
        for r in range(0, SEG_FRAME, SEG_WINDOW)
        for c in range(0, SEG_FRAME, SEG_WINDOW)]).astype(np.float32)) \
        .to(dev) / 65535.0
    x_full = torch.from_numpy(one[:, :, 0].astype(np.float32)).to(dev) \
        / 65535.0
    device_ms = {
        "tiled": time_cuda(torch, lambda: card_model.probabilities(x64), 3)
        + SEG_SUPP * time_cuda(
            torch, lambda: card_model.probabilities(x64[:n_supp_tiles]), 3),
        "direct": time_cuda(torch, lambda: card_model.probabilities(x_full),
                            3)}
    calls = {"tiled": lambda: predict_whole_map(
                 one, card_model, n_supp=SEG_SUPP,
                 rng=np.random.RandomState(SEED)),
             "direct": lambda: predict_whole_map(one, card_model,
                                                 mode="direct")}
    timed = {}
    for mode, call in calls.items():
        call()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            call()
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 1e9
        wall_ms = 1e3 * min(walls)
        dev_ms = device_ms[mode]
        log(f"{mode}, one {SEG_FRAME}x{SEG_FRAME} frame from a host float64 "
            f"array: {wall_ms:.3f} ms (runs "
            + ", ".join(f"{1e3 * w:.3f}" for w in walls)
            + f"), {1e3 / wall_ms:.3f} frames/s; its device work alone "
            f"{dev_ms:.3f} ms, {1e3 / dev_ms:.3f} frames/s; convolutions "
            f"{flops[mode] / 1e12:.4f} TFLOP ({tile_flops / 1e9:.3f} GFLOP a "
            f"{SEG_WINDOW}x{SEG_WINDOW} tile): "
            f"{flops[mode] / dev_ms / 1e9:.2f} TFLOP/s on the device work, "
            f"{flops[mode] / dev_ms / 1e9 / (FP32_FLOP_PER_S / 1e12):.4f} of "
            f"the {FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s fp32 rate "
            f"({flops[mode] / wall_ms / 1e9 / (FP32_FLOP_PER_S / 1e12):.4f} "
            f"end to end); peak device memory {peak:.3f} GB{tag}")
        prof = profile_steps(torch, call, 1, wall_ms, unit="frame",
                             families=SEG_FAMILIES, other=SEG_OTHER, tag=tag)
        timed[mode] = dict(wall_ms=wall_ms, walls_ms=[1e3 * w for w in walls],
                           device_ms=dev_ms, tflop=flops[mode] / 1e12,
                           fp32_share=flops[mode] / dev_ms / 1e9
                           / (FP32_FLOP_PER_S / 1e12), peak_gb=peak,
                           profile=None if prof is None else {
                               "busy_ms": prof["busy_ms"],
                               "families": prof["families"]})

    # the host's share of a site: load, the float64 merge, the writes
    site_path = os.path.join(raw, f"{name}.npy")
    t0 = time.perf_counter()
    loaded = load_input(site_path)[:, :2]
    load_s = time.perf_counter() - t0
    probs = np.load(os.path.join(raw, f"{name}_NNProbabilities.npy")) \
        .astype(np.float64)
    t0 = time.perf_counter()
    _finish_whole_map(site_path, loaded, probs,
                      os.path.join(root, "seg_rewrite"))
    write_s = time.perf_counter() - t0
    stage_s = runs["tiled"]["stage_s"]
    dev_s = SEG_T * device_ms["tiled"] / 1e3
    host_merge_s = SEG_T * (timed["tiled"]["wall_ms"]
                            - device_ms["tiled"]) / 1e3
    log(f"tiled site of {SEG_T} frames: stage {stage_s:.3f} s = load "
        f"{load_s:.3f} s + writes (npy and both PNGs) {write_s:.3f} s + "
        f"device work {dev_s:.3f} s + tile cuts, copies and the float64 "
        f"merge {host_merge_s:.3f} s + rest "
        f"{stage_s - load_s - write_s - dev_s - host_merge_s:.3f} s; host "
        f"share {1 - dev_s / stage_s:.4f}{tag}")
    log(f"phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return dict(runs=runs, tiles_vs_cpu=tiles_err[0],
                tiles_tf32_control=tiles_err[1], direct_vs_cpu=direct_err[0],
                direct_tf32_control=direct_err[1], timed=timed,
                tile_gflop=tile_flops / 1e9, load_s=load_s, write_s=write_s,
                host_share=1 - dev_s / stage_s, site_path=site_path)


# ---------------------------------------------------------------- phase 9

# From a site's probabilities to its well's latents, at the published sizes
# (configs/config_example.yml: 2048 x 2048 frames, channels [0, 1], patch
# window 256, input_size 128, VQ_VAE_z16 at batch 512) on one synthetic
# site of 12 frames: scale is cut to one site, nothing else.
FE_T = 12
FE_FRAME = 2048
FE_WINDOW = 256
FE_INPUT = 128
FE_SITE = "B2-Site_0"
FE_CELLS = (24, 32)         # planted cells, inclusive
FE_RADIUS = (15, 35)        # px, inclusive
FE_DRIFT = 3.0              # px a frame at most
FE_GAP = 25                 # px between cell edges at least, every frame
FE_EDGE_CELLS = 4           # cells whose window crosses the frame edge


def plant_cells(rng):
    """[(centres (T, 2) int, radius)]: disk cells that drift in a straight
    line, stay inside the frame and FE_GAP apart; the first FE_EDGE_CELLS
    run along one frame edge each, so their windows cross it."""
    n = rng.randint(FE_CELLS[0], FE_CELLS[1] + 1)
    t = np.arange(FE_T)[:, None]
    cells = []
    for _ in range(200000):
        if len(cells) == n:
            return cells
        r = rng.randint(FE_RADIUS[0], FE_RADIUS[1] + 1)
        theta, speed = rng.uniform(0, 2 * np.pi), rng.uniform(0, FE_DRIFT)
        v = speed * np.array([np.cos(theta), np.sin(theta)])
        c0 = rng.uniform(r + 40, FE_FRAME - r - 40, 2)
        if len(cells) < FE_EDGE_CELLS:        # along edge k: top, bottom,
            k = len(cells)                     # left, right
            axis, side = k // 2, k % 2
            c0[axis] = r + 6 if side == 0 else FE_FRAME - r - 7
            v[axis] = 0.0
        path = np.rint(c0 + t * v).astype(int)
        if path.min() < r + 1 or path.max() > FE_FRAME - r - 2:
            continue
        if all(np.linalg.norm(path - p, axis=1).min() >= r + rp + FE_GAP
               for p, rp in cells):
            cells.append((path, r))
    raise AssertionError("could not place the synthetic cells")


def write_front_end_site(rng, raw):
    """``<raw>/B2-Site_0.npy``: float64 (T, 2, 1, 2048, 2048) in uint16
    intensity units, and ``B2-Site_0_NNProbabilities.npy``: float64 (T, 3,
    1, 2048, 2048) (background, cell, other), as the port's tiled
    run_segmentation writes them, made from the planted cells."""
    cells, site, probs = front_end_arrays(rng)
    np.save(os.path.join(raw, f"{FE_SITE}.npy"), site)
    np.save(os.path.join(raw, f"{FE_SITE}_NNProbabilities.npy"), probs)
    return cells, site, probs


def front_end_arrays(rng):
    """(planted cells, the (T, 2, 1, 2048, 2048) site, the (T, 3, 1, 2048,
    2048) probabilities) of ``write_front_end_site``."""
    cells = plant_cells(rng)
    site = np.empty((FE_T, 2, 1, FE_FRAME, FE_FRAME))
    probs = np.empty((FE_T, 3, 1, FE_FRAME, FE_FRAME))
    for t in range(FE_T):
        site[t, 0, 0] = rng.randint(28000, 31000, (FE_FRAME, FE_FRAME))
        site[t, 1, 0] = rng.randint(7000, 9000, (FE_FRAME, FE_FRAME))
        bg = np.full((FE_FRAME, FE_FRAME), 0.97)
        for path, r in cells:
            cy, cx = path[t]
            sl = (slice(cy - r, cy + r + 1), slice(cx - r, cx + r + 1))
            yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
            disk = yy ** 2 + xx ** 2 < r ** 2
            site[t, 0, 0][sl][disk] += 5000 + 40 * r
            site[t, 1, 0][sl][disk] += 2000
            bg[sl][disk] = 0.05
        cell = np.where(bg < 0.5, 0.9, 0.02)
        probs[t, :, 0] = np.stack([bg, cell, 1.0 - bg - cell])
    return cells, site, probs


def check_front_end_outputs(torch, raw, supp, cells, weights):
    """The artifacts of the five stages: every planted cell found in every
    frame, one trajectory of 12 points each, the well's static patches,
    file paths, relations, labels and trajectory index lists, and the
    latents. Returns (number of patches, latents (z_before, z_after))."""
    from dynamorph_tpu_torch.io.pickles import load_pickle

    folder = os.path.join(supp, "B2-supps", FE_SITE)
    positions = load_pickle(os.path.join(folder, "cell_positions.pkl"))
    n = len(cells)
    for t in range(FE_T):
        found = np.array([pos for _, pos in positions[t]])
        if len(found) != n:
            raise AssertionError(f"frame {t}: {len(found)} cells found, "
                                 f"{n} planted")
        planted = np.array([path[t] for path, _ in cells])
        d = np.linalg.norm(planted[:, None] - found[None], axis=-1)
        if d.min(1).max() > 1.5 or len(set(d.argmin(1))) != n:
            raise AssertionError(f"frame {t}: found centres do not match "
                                 "the planted cells")
        if not os.path.exists(os.path.join(folder, f"segmentation_{t}.png")):
            raise AssertionError(f"segmentation_{t}.png missing")
    trajectories, traj_positions = load_pickle(
        os.path.join(folder, "cell_traj.pkl"))
    if len(trajectories) != n or any(sorted(tr) != list(range(FE_T))
                                     for tr in trajectories):
        raise AssertionError(f"{len(trajectories)} trajectories, want {n} "
                             f"of {FE_T} points each")
    for tp in traj_positions:          # each follows one planted cell
        path = np.array([tp[t] for t in range(FE_T)])
        d = [np.abs(path - p).max() for p, _ in cells]
        if min(d) > 1.5:
            raise AssertionError("a trajectory follows no planted cell")
    n_patches = n * FE_T
    fs = load_pickle(os.path.join(raw, "B2_file_paths.pkl"))
    static = load_pickle(os.path.join(raw, "B2_static_patches.pkl"))
    labels = load_pickle(os.path.join(raw, "B2_static_patches_labels.pkl"))
    rel = load_pickle(os.path.join(raw, "B2_static_patches_relations.pkl"))
    trajs = load_pickle(os.path.join(raw, "B2_trajectories.pkl"))
    want = (n_patches, 2, 1, FE_INPUT, FE_INPUT)
    if len(fs) != n_patches or fs != sorted(fs) or static.shape != want \
            or static.dtype != np.float64 or not np.isfinite(static).all():
        raise AssertionError(f"static patches {static.shape} "
                             f"{static.dtype}, {len(fs)} paths; want {want}")
    if len(set(labels.tolist())) != n or \
            sum(v == 2 for v in rel.values()) != n_patches + 2 * n * (
                FE_T - 1):
        raise AssertionError("relations or labels do not chain the cells")
    if sorted(trajs) != sorted(f"{FE_SITE}/{i}" for i in range(n)) or \
            sorted(sum(trajs.values(), [])) != list(range(n_patches)):
        raise AssertionError("trajectories.pkl does not map each "
                             "trajectory onto its patches")
    model = os.path.basename(weights)
    z_b = load_pickle(os.path.join(raw, model, "B2_latent_space.pkl"))
    z_a = load_pickle(os.path.join(raw, model, "B2_latent_space_after.pkl"))
    for z in (z_b, z_a):
        if z.shape != (n_patches, 4096) or z.dtype != np.float32 or \
                not np.isfinite(z).all():
            raise AssertionError(f"latents {z.shape} {z.dtype}")
    log(f"{n} planted cells found in all {FE_T} frames (centres within 1.5 "
        f"px), {n} trajectories of {FE_T} points; static patches "
        f"{static.shape} float64, {len(fs)} file paths, {len(rel)} relations,"
        f" {n} labels, {len(trajs)} trajectory index lists; latents "
        f"({n_patches}, 4096) float32, finite")
    return n_patches, static, (z_b, z_a)


def latents_vs_cpu(torch, static, z_b, z_a, weights):
    """The first 64 patches' latents against the port's CPU path, at phase
    4's limits."""
    from dynamorph_tpu_torch.models import VQVAEz16
    from dynamorph_tpu_torch.pipeline.patch_vae import encode_patches

    cpu_model = VQVAEz16(num_inputs=2, **NET)
    cpu_model.load_state_dict(torch.load(os.path.join(weights, "model.pt")))
    k = min(64, len(static))
    zb_cpu, za_cpu = encode_patches(cpu_model, static[:k, :, 0], k,
                                    normalize="patch", device="cpu")
    err = float(np.max(np.abs(zb_cpu - z_b[:k])))
    if not err <= LATENT_ATOL:
        raise AssertionError(f"z_before card vs CPU {err:.3e}")
    cb = cpu_model.vq.w.weight.detach()

    def rows(z):
        return torch.from_numpy(z).reshape(-1, 16, 256).permute(0, 2, 1) \
            .reshape(-1, 16)

    idx_gpu, idx_cpu = codes_of(torch, rows(z_a[:k]), cb), \
        codes_of(torch, rows(za_cpu), cb)
    flips = torch.nonzero(idx_gpu != idx_cpu).flatten()
    if len(flips):
        check_flips_vs_latents(torch, "front-end z_after",
                               rows(zb_cpu)[flips], rows(z_b[:k])[flips],
                               cb[idx_cpu[flips]], cb[idx_gpu[flips]])
    log(f"latents card vs CPU, first {k} patches: z_before max abs "
        f"{err:.3e} (limit {LATENT_ATOL}); z_after {len(flips)} code flips "
        f"of {len(idx_gpu)} positions (near-ties), "
        f"{len(torch.unique(idx_gpu))} distinct codes")
    return err, len(flips)


def frame_inputs(site, probs, positions, assignments, t):
    """Host inputs of frame t's extraction, as the stage builds them."""
    from dynamorph_tpu_torch.ops.patch import labels_to_map

    raw = site[t, :, 0].astype(np.float32)
    bg = probs[t, 0, 0].astype(np.float32)
    labels = labels_to_map((FE_FRAME, FE_FRAME), *assignments[t])
    centers = np.array([pos for _, pos in positions[t]], np.int64)
    ids = np.array([cid for cid, _ in positions[t]], np.int32)
    return raw, bg, labels, centers, ids


def extract_on(torch, dev, *inputs):
    """One frame's device work from the host arrays of ``frame_inputs``,
    uploads included."""
    return extract_resident(torch, [torch.from_numpy(a).to(dev)
                                    for a in inputs])


def phase_front_end(torch, vq, root, dev, weights, card):
    phase("9. front end to latents: instance_segmentation, extract_patches,"
          " build_trajectories, assemble, run_vae -m process, "
          "trajectory_matching, on cuda")
    from dynamorph_tpu_torch.cli import run_patch, run_segmentation, run_vae
    from dynamorph_tpu_torch.core.device import fp32_strict
    from dynamorph_tpu_torch.io.pickles import load_pickle
    from dynamorph_tpu_torch.models import VQVAEz16
    from dynamorph_tpu_torch.pipeline.patch import fetch_cell_patches
    from dynamorph_tpu_torch.pipeline.patch_vae import zscore_patch_device
    from dynamorph_tpu_torch.track.clustering import instance_clustering

    tag = f" [{card}]"
    t_phase = t0 = time.perf_counter()
    raw, supp = os.path.join(root, "fe_raw"), os.path.join(root, "fe_supp")
    os.makedirs(raw)
    cells, site, probs = write_front_end_site(np.random.RandomState(SEED + 9),
                                              raw)
    n = len(cells)
    log(f"synthetic site {FE_SITE}: float64 ({FE_T}, 2, 1, {FE_FRAME}, "
        f"{FE_FRAME}) and probabilities ({FE_T}, 3, 1, {FE_FRAME}, "
        f"{FE_FRAME}) float64, {n} disk cells of radius "
        f"{min(r for _, r in cells)}-{max(r for _, r in cells)} px drifting "
        f"up to {FE_DRIFT:.0f} px a frame, {FE_EDGE_CELLS} along the frame "
        f"edges; made and written in {time.perf_counter() - t0:.2f} s")
    cfg = os.path.join(root, "front_end.yml")
    with open(cfg, "w") as f:
        f.write("segmentation_inference:\n"
                f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{supp}']\n"
                "patch:\n"
                f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{supp}']\n"
                f"  channels: [0, 1]\n  window_size: {FE_WINDOW}\n"
                "latent_encoding:\n"
                f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{supp}']\n"
                f"  weights: ['{weights}']\n  save_output: False\n"
                f"  channels: [0, 1]\n  input_size: {FE_INPUT}\n"
                "  network: 'VQ_VAE_z16'\n"
                f"  num_hiddens: {NET['num_hiddens']}\n"
                f"  num_residual_hiddens: {NET['num_residual_hiddens']}\n"
                f"  num_embeddings: {NET['num_embeddings']}\n")
    stages = [("instance_segmentation", run_segmentation),
              ("extract_patches", run_patch),
              ("build_trajectories", run_patch),
              ("assemble", run_vae), ("process", run_vae),
              ("trajectory_matching", run_vae)]
    walls = {}
    vq.vq_lookup.launches = 0
    vq.vq_indices.launches = 0
    for method, cli in stages:
        t0 = time.perf_counter()
        cli.main(["-m", method, "-c", cfg, "--device", dev.type])
        torch.cuda.synchronize()
        walls[method] = time.perf_counter() - t0
    launches = {"vq_lookup": vq.vq_lookup.launches,
                "vq_indices": vq.vq_indices.launches}
    chain_s = sum(walls.values())
    n_patches, static, (z_b, z_a) = check_front_end_outputs(
        torch, raw, supp, cells, weights)
    want = -(-n_patches // BATCH)
    log(f"the chain: {chain_s:.3f} s for {FE_T} frames ({FE_T / chain_s:.3f}"
        f" frames/s, {n_patches / chain_s:.1f} patches/s); vq_lookup "
        f"launches {launches['vq_lookup']} (want {want} for {n_patches} "
        f"patches at batch {BATCH}), vq_indices launches "
        f"{launches['vq_indices']}{tag}")
    if launches["vq_lookup"] != want or launches["vq_indices"] != 0:
        raise AssertionError("the front-end chain did not launch vq_lookup "
                             "once per batch")
    lat_err, lat_flips = latents_vs_cpu(torch, static, z_b, z_a, weights)

    # frame 0's extraction, card against CPU, bit for bit
    folder = os.path.join(supp, "B2-supps", FE_SITE)
    positions = load_pickle(os.path.join(folder, "cell_positions.pkl"))
    assignments = load_pickle(os.path.join(folder,
                                           "cell_pixel_assignments.pkl"))
    inputs = frame_inputs(site, probs, positions, assignments, 0)
    card_out = extract_on(torch, dev, *inputs)
    cpu_out = extract_on(torch, torch.device("cpu"), *inputs)
    for k in ("mat", "masked_mat", "tm", "tm2"):
        if not torch.equal(card_out[k].cpu(), cpu_out[k]):
            raise AssertionError(f"extract_cell_patches {k}: card differs "
                                 "from the CPU")
    log(f"extract_cell_patches, frame 0 ({n} cells, window {FE_WINDOW}): "
        "mat, masked_mat, tm and tm2 bit-equal card vs CPU")

    # per frame: clustering on the host, extraction on the card (device ms
    # between CUDA events on resident inputs; wall from host arrays,
    # uploads included), the fetch of the patches to the host
    per = {"cluster_s": [], "extract_device_ms": [], "extract_wall_ms": [],
           "fetch_ms": [], "fetch_mb": []}
    png = os.path.join(root, "fe_instance_map.png")
    for t in range(FE_T):
        t0 = time.perf_counter()
        instance_clustering(probs[t], instance_map=True, map_path=png)
        per["cluster_s"].append(time.perf_counter() - t0)
        inputs = frame_inputs(site, probs, positions, assignments, t)
        resident = [torch.from_numpy(a).to(dev) for a in inputs]
        torch.cuda.synchronize()
        per["extract_device_ms"].append(time_cuda(
            torch, lambda: extract_resident(torch, resident), 5))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = extract_on(torch, dev, *inputs)
        torch.cuda.synchronize()
        per["extract_wall_ms"].append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        host = fetch_cell_patches(out)
        per["fetch_ms"].append(1e3 * (time.perf_counter() - t0))
        per["fetch_mb"].append(sum(a.nbytes for a in host.values()) / 1e6)
    for key, unit in (("cluster_s", "s"), ("extract_device_ms", "ms"),
                      ("extract_wall_ms", "ms"), ("fetch_ms", "ms")):
        v = per[key]
        log(f"per frame, {key}: mean {np.mean(v):.4f} {unit}, min "
            f"{min(v):.4f}, max {max(v):.4f}{tag}")
    log(f"per frame, patches fetched: {np.mean(per['fetch_mb']):.2f} MB "
        f"(fetch rate {np.sum(per['fetch_mb']) / np.sum(per['fetch_ms']):.3f}"
        f" GB/s){tag}")

    # per stage: wall and host share (the device works only in
    # extract_patches and process). The device seconds are not read from
    # the CLI run: they are the per-frame extractions re-timed above on
    # resident inputs, and the batch count times one encode timed here.
    card_model = VQVAEz16(num_inputs=2, **NET).to(dev)
    card_model.load_state_dict(torch.load(os.path.join(weights, "model.pt")))
    batch = np.zeros((BATCH, 2, FE_INPUT, FE_INPUT), np.float32)
    batch[:min(BATCH, n_patches)] = static[:BATCH, :, 0]
    xb = torch.from_numpy(batch).to(dev)
    with fp32_strict(), torch.no_grad():
        encode_ms = time_cuda(
            torch, lambda: card_model.encode(zscore_patch_device(xb)), 5)
    device_s = {"extract_patches": sum(per["extract_device_ms"]) / 1e3,
                "process": want * encode_ms / 1e3}
    shares = {}
    for method, _ in stages:
        dev_s = device_s.get(method, 0.0)
        shares[method] = 1 - dev_s / walls[method]
        log(f"stage {method}: {walls[method]:.3f} s wall, device work "
            f"re-timed apart from the CLI run {dev_s:.4f} s, host share "
            f"{shares[method]:.4f}{tag}")
    total_dev = sum(device_s.values())
    log(f"the chain's host share {1 - total_dev / chain_s:.4f} "
        f"({total_dev:.4f} s of device work, re-timed apart from the CLI "
        f"run, in {chain_s:.3f} s){tag}")
    log(f"phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return dict(n_cells=n, n_patches=n_patches, walls=walls,
                launches=launches, latent_err=lat_err, latent_flips=lat_flips,
                per_frame={k: float(np.mean(v)) for k, v in per.items()},
                encode_ms=encode_ms, host_shares=shares,
                host_share=1 - total_dev / chain_s)


def extract_resident(torch, resident):
    """One frame's device work on resident inputs: the background median
    and the window, mask and fill program."""
    from dynamorph_tpu_torch.ops.patch import (extract_cell_patches,
                                               median_background)

    raw, bg, labels, centers, ids = resident
    return extract_cell_patches(raw, labels, centers, ids,
                                median_background(raw, bg),
                                window_size=FE_WINDOW)


# ---------------------------------------------------------------- phase 10

# From raw TIFFs to PCs through the stage graph at the published sizes: one
# synthetic site in the default raw layout (preprocess pos_dir: true,
# single-page uncompressed uint16 TIFFs img_<channel>_t<ttt>_z<zzz>.tif,
# channels Retardance, Phase2D and Brightfield, 2048 x 2048), made from
# phase 9's planted cells, 12 frames (phase 9's count, uncut); then a
# plate-scale PCA fit and the UMAP reference grid on synthetic latents.
PP_CHANNELS = ("Retardance", "Phase2D", "Brightfield")
PP_Z = 0
GRAPH_STAGES = ["instance_segmentation", "extract_patches",
                "build_trajectories", "assemble", "process",
                "trajectory_matching", "pca"]
PLATE_WELLS = 24            # a plate of wells of phase 4's 2,304 patches
PLATE_PATCHES = 2304
LATENT_LEN = 16 * 16 * 16   # the z16 latent length
PLATE_RANK = 64             # factors of the synthetic latents
PCA_RTOL = 1e-4             # projected variance vs explained_variance_
PCA_ORTHO_ATOL = 1e-4       # components' C C^T vs I
UMAP_WELLS = 4
UMAP_GRID = (15, 50, 200)   # the reference grid (a 1.58, b 0.9)
UMAP_KNN_ROWS = 1024        # rows of the card-vs-CPU kNN check
UMAP_DIST_RTOL = 1e-5       # card vs CPU kNN distances


def write_raw_tiffs(rng, image_dir):
    """Phase 9's planted site as raw microscope files: per frame and
    channel ``<image_dir>/B2-Site_0/img_<channel>_t<ttt>_z000.tif``, one
    uncompressed uint16 page. Phase2D and Retardance are phase 9's two
    channels, Brightfield a third with the cells brighter. Returns (cells,
    {channel: (T, 2048, 2048) uint16}, the planted probabilities)."""
    from dynamorph_tpu_torch.io.tiff import write_multipage_tiff

    cells, site, probs = front_end_arrays(rng)
    frames = {"Phase2D": site[:, 0, 0].astype(np.uint16),
              "Retardance": site[:, 1, 0].astype(np.uint16)}
    if not (np.array_equal(frames["Phase2D"], site[:, 0, 0])
            and np.array_equal(frames["Retardance"], site[:, 1, 0])):
        raise AssertionError("the planted site is not in uint16 range")
    frames["Brightfield"] = (18000 + rng.randint(0, 1500, site[:, 0, 0].shape)
                             + 4000 * (probs[:, 1, 0] > 0.5)
                             ).astype(np.uint16)
    folder = os.path.join(image_dir, FE_SITE)
    os.makedirs(folder)
    for chan in PP_CHANNELS:
        for t in range(FE_T):
            write_multipage_tiff(os.path.join(
                folder, f"img_{chan}_t{t:03d}_z{PP_Z:03d}.tif"),
                frames[chan][t:t + 1])
    return cells, frames, probs


def stage_seconds(timing_log):
    """{stage: seconds} of the orchestrator's own stage_timer records
    (those without a site or well: the stages' inner timers carry one)."""
    out = {}
    with open(timing_log) as f:
        for line in f:
            rec = json.loads(line)
            if set(rec) == {"stage", "seconds", "time"}:
                out[rec["stage"]] = out.get(rec["stage"], 0.0) + \
                    rec["seconds"]
    return out


def merged(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def stage_device_seconds(torch, prof, stages):
    """{stage: seconds the device was busy inside the stage}, from a
    torch.profiler trace of the run: the union of the device's kernel and
    copy intervals that overlap the union of the stage's ranges
    (``stage_timer`` opens one ``record_function`` per stage, and the
    stages' inner timers open more of the same name). The ranges' own
    device-side spans (user annotations, first to last kernel) are not
    device work. None when the trace holds no device event."""
    events = prof.events()
    busy = merged((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation)
    if not busy:
        return None
    out = {}
    for stage in stages:
        ranges = merged(
            (e.time_range.start, e.time_range.end) for e in events
            if e.name == stage
            and e.device_type == torch.autograd.DeviceType.CPU)
        us, i = 0.0, 0
        for a, b in ranges:
            while i < len(busy) and busy[i][1] <= a:
                i += 1
            j = i
            while j < len(busy) and busy[j][0] < b:
                us += min(b, busy[j][1]) - max(a, busy[j][0])
                j += 1
        out[stage] = us / 1e6
    return out


def plate_latents(torch, dev, n, seed, noise=0.02):
    """(n, 4096) fp32 latents on the card: PLATE_RANK factors with a
    decaying spectrum on a random basis, noise, and an offset a well.
    Without noise the centred latents have rank PLATE_RANK + wells - 1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    scale = 0.9 ** torch.arange(PLATE_RANK, device=dev, dtype=torch.float32)
    factors = torch.randn(n, PLATE_RANK, generator=g, device=dev) * scale
    basis = 0.1 * torch.randn(PLATE_RANK, LATENT_LEN, generator=g,
                              device=dev)
    well = torch.arange(n, device=dev) // PLATE_PATCHES
    from dynamorph_tpu_torch.core.device import fp32_strict

    with fp32_strict():
        x = factors @ basis
    if noise:
        x += noise * torch.randn(n, LATENT_LEN, generator=g, device=dev)
    x += 0.05 + 0.002 * well[:, None]
    return x


def pca_f64_errors(torch, x, mean, components, explained_variance):
    """Float64 on the card: the largest relative gap between each projected
    column's variance and its explained variance, and C C^T - I."""
    c64 = torch.as_tensor(components, device=x.device, dtype=torch.float64)
    mean = torch.as_tensor(mean, device=x.device, dtype=torch.float64)
    ev = torch.as_tensor(explained_variance, device=x.device,
                         dtype=torch.float64)
    var = ((x.double() - mean) @ c64.T).var(0, unbiased=True)
    eye = torch.eye(len(c64), device=x.device, dtype=torch.float64)
    return (float((var / ev - 1).abs().max()),
            float((c64 @ c64.T - eye).abs().max()))


def svd_drivers(torch, x, k):
    """The fp32 SVD of the centred ``x`` with each cuSOLVER driver: the
    fit's ``gesvd``, ``gesvda`` (tall-skinny: faster, but it raises on
    rank-deficient input) and PyTorch's default ``gesvdj``: seconds and the
    float64 errors of the first ``k`` components, or the error raised."""
    from dynamorph_tpu_torch.core.device import fp32_strict

    n = len(x)
    mean = x.mean(0)
    xc = x - mean
    out = {}
    for driver in ("gesvd", "gesvda", None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with fp32_strict():
                _, sv, vh = torch.linalg.svd(xc, full_matrices=False,
                                             driver=driver)
            torch.cuda.synchronize()
        except RuntimeError as e:      # torch.linalg.LinAlgError
            out[driver or "gesvdj"] = dict(error=str(e).split("\n")[0])
            continue
        seconds = time.perf_counter() - t0
        var_err, ortho = pca_f64_errors(torch, x, mean, vh[:k],
                                        sv[:k] ** 2 / (n - 1))
        out[driver or "gesvdj"] = dict(s=seconds, var_err=var_err,
                                       ortho=ortho)
        del sv, vh
    return out


def driver_line(runs):
    return "; ".join(
        f"{d} raised ({r['error'][:90]})" if "error" in r else
        f"{d} {r['s']:.3f} s, variance {r['var_err']:.3e}, C C^T vs I "
        f"{r['ortho']:.3e}" for d, r in runs.items())


def check_pca_model(path, n_samples):
    """pca_model.pkl: a sklearn PCA pickle stream (the card has no sklearn
    to unpickle it as one; load_pca_model reads it), k components of the
    latent length, orthonormal, mean finite, explained ratio past 0.5."""
    from dynamorph_tpu_torch.reduce.pca_model import load_pca_model

    with open(path, "rb") as f:
        head = f.read(64)
    if b"sklearn.decomposition._pca" not in head or b"PCA" not in head:
        raise AssertionError("pca_model.pkl does not name sklearn's PCA")
    m = load_pca_model(path)
    c = m.components_
    k = m.n_components_
    ortho = float(np.abs(c @ c.T - np.eye(k)).max())
    csum = np.cumsum(m.explained_variance_ratio_)
    problems = [
        what for what, bad in (
            (f"components {c.shape} {c.dtype}",
             c.shape != (k, LATENT_LEN) or c.dtype != np.float64
             or not np.isfinite(c).all()),
            (f"C C^T vs I {ortho:.3e}", not ortho <= PCA_ORTHO_ATOL),
            (f"mean {m.mean_.shape}", m.mean_.shape != (LATENT_LEN,)
             or not np.isfinite(m.mean_).all()),
            (f"cumulative ratio {csum[-2:]}", not csum[-1] > 0.5
             or (k > 1 and csum[-2] > 0.5)),
            (f"n_samples_ {m.n_samples_}", m.n_samples_ != n_samples),
            ("whiten", bool(m.whiten))) if bad]
    if problems:
        raise AssertionError(f"pca_model.pkl malformed: {problems}")
    log(f"pca_model.pkl: C C^T vs I {ortho:.3e}")
    return m


def phase_raw_to_pcs(torch, vq, root, dev, weights, card):
    phase("10. raw TIFFs to PCs: run_preproc, run_pipeline (segmentation; "
          "instance_segmentation ... pca), run_dim_reduction -m pca "
          "(transform), a plate-scale PCA fit, the UMAP grid, on cuda")
    from dynamorph_tpu_torch.cli import (run_dim_reduction, run_pipeline,
                                         run_preproc)
    from dynamorph_tpu_torch.io.pickles import load_pickle
    from dynamorph_tpu_torch.reduce.pca import fit_pca_device, svd_driver
    from dynamorph_tpu_torch.reduce.pca_model import load_pca_model
    from dynamorph_tpu_torch.reduce.umap_native import NativeUMAP, knn_graph
    from dynamorph_tpu_torch.reduce.umap_wrap import fit_umap
    from torch.profiler import ProfilerActivity, profile

    tag = f" [{card}]"
    t_phase = t0 = time.perf_counter()
    image_dir, raw, supp = (os.path.join(root, p) for p in
                            ("pp_images", "pp_raw", "pp_supp"))
    cells, frames, probs = write_raw_tiffs(
        np.random.RandomState(SEED + 9), image_dir)
    n = len(cells)
    log(f"raw site {FE_SITE}: {FE_T} frames x {len(PP_CHANNELS)} channels "
        f"of {FE_FRAME}x{FE_FRAME} uncompressed uint16 TIFFs (img_<channel>"
        f"_t<ttt>_z{PP_Z:03d}.tif), {n} planted cells; made and written in "
        f"{time.perf_counter() - t0:.2f} s")
    model_name = os.path.basename(weights)
    pca_w, pcs_dir = os.path.join(root, "pp_pca"), os.path.join(root,
                                                                "pp_pcs")
    cfgs = {}
    for fit in (True, False):
        cfgs[fit] = os.path.join(root, f"raw_to_pcs_{fit}.yml")
        with open(cfgs[fit], "w") as f:
            f.write("preprocess:\n"
                    f"  image_dirs: ['{image_dir}']\n"
                    f"  target_dirs: ['{raw}']\n"
                    f"  channels: {list(PP_CHANNELS)}\n"
                    f"  pos_dir: True\n  multipage: False\n"
                    f"  z_slice: {PP_Z}\n"
                    "segmentation_inference:\n"
                    f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{supp}']\n"
                    f"  weights: '{os.path.join(root, 'seg_weights')}'\n"
                    "  network: 'UNet'\n  channels: [0, 1]\n"
                    f"  num_classes: 3\n  window_size: {SEG_WINDOW}\n"
                    f"  batch_size: 8\n  num_pred_rnd: {SEG_SUPP}\n"
                    "  inference_mode: 'tiled'\n"
                    "patch:\n"
                    f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{supp}']\n"
                    f"  channels: [0, 1]\n  window_size: {FE_WINDOW}\n"
                    "latent_encoding:\n"
                    f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{supp}']\n"
                    f"  weights: ['{weights}']\n  save_output: False\n"
                    f"  channels: [0, 1]\n  input_size: {FE_INPUT}\n"
                    "  network: 'VQ_VAE_z16'\n"
                    f"  num_hiddens: {NET['num_hiddens']}\n"
                    f"  num_residual_hiddens: {NET['num_residual_hiddens']}\n"
                    f"  num_embeddings: {NET['num_embeddings']}\n"
                    "dim_reduction:\n"
                    f"  input_dirs: ['{os.path.join(raw, model_name)}']\n"
                    f"  output_dirs: ['{pcs_dir}']\n"
                    f"  weights_dir: '{pca_w}'\n"
                    "  file_name_prefixes: ['B2']\n"
                    f"  fit_model: {fit}\n")
    cfg = cfgs[True]
    timing_log = os.path.join(root, "raw_to_pcs_timing.jsonl")
    os.environ["DYNAMORPH_TIMING_LOG"] = timing_log
    errors = ErrorRecords()
    logging.getLogger().addHandler(errors)
    walls = {}
    try:
        # 1. run_preproc
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_preproc.main(["-c", cfg, "--device", dev.type])
        walls["run_preproc"] = time.perf_counter() - t0
        stack = np.load(os.path.join(raw, f"{FE_SITE}.npy"))
        want_shape = (FE_T, 3, 1, FE_FRAME, FE_FRAME)
        if stack.shape != want_shape or stack.dtype != np.float64:
            raise AssertionError(f"preprocess npy {stack.shape} "
                                 f"{stack.dtype}, want {want_shape} float64")
        for slot, chan in enumerate(("Phase2D", "Retardance",
                                     "Brightfield")):
            if not np.array_equal(stack[:, slot, 0], frames[chan]):
                raise AssertionError(f"preprocess slot {slot} is not the "
                                     f"{chan} frames")
        log(f"run_preproc: {walls['run_preproc']:.3f} s; {FE_SITE}.npy "
            f"{stack.shape} float64 equals the planted Phase2D, Retardance "
            "and Brightfield frames bit for bit, in slots 0, 1, 2")
        del stack

        # 2. run_pipeline --stages segmentation (random-weight U-Net), traced
        # as step 4 is, for the stage's device time
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            done = run_pipeline.main(["-c", cfg, "--stages", "segmentation",
                                      "--device", dev.type])
            torch.cuda.synchronize()
            walls["segmentation"] = time.perf_counter() - t0
        seg_device = stage_device_seconds(torch, prof, ["segmentation"])
        del prof
        if done != {raw: ["segmentation"]}:
            raise AssertionError(f"segmentation stage list {done}")
        if [m for m in errors.messages if "Error in predicting" in m]:
            raise AssertionError(f"segmentation failed: {errors.messages}")
        seg_probs = np.load(os.path.join(raw,
                                         f"{FE_SITE}_NNProbabilities.npy"))
        if seg_probs.shape != (FE_T, 3, 1, FE_FRAME, FE_FRAME) or \
                seg_probs.dtype != np.float64 or \
                not np.isfinite(seg_probs).all():
            raise AssertionError(f"segmentation probabilities "
                                 f"{seg_probs.shape} {seg_probs.dtype}")
        del seg_probs
        log(f"run_pipeline --stages segmentation: "
            f"{walls['segmentation']:.3f} s for {FE_T} frames (tiled, "
            f"{SEG_SUPP} random passes), {FE_SITE}_NNProbabilities.npy "
            "float64, finite")

        # 3. the planted probabilities (a random-weight U-Net finds none)
        np.save(os.path.join(raw, f"{FE_SITE}_NNProbabilities.npy"), probs)

        # 4. the rest of the stage graph
        vq.vq_lookup.launches = 0
        vq.vq_indices.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            done = run_pipeline.main(["-c", cfg, "--stages", *GRAPH_STAGES,
                                      "--device", dev.type])
            torch.cuda.synchronize()
            walls["graph"] = time.perf_counter() - t0
        launches = {"vq_lookup": vq.vq_lookup.launches,
                    "vq_indices": vq.vq_indices.launches}
        graph_peak = torch.cuda.max_memory_allocated() / 1e9
        graph_device = stage_device_seconds(torch, prof, GRAPH_STAGES)
        del prof
    finally:
        logging.getLogger().removeHandler(errors)
        del os.environ["DYNAMORPH_TIMING_LOG"]
    if done != {raw: GRAPH_STAGES}:
        raise AssertionError(f"stage list {done}, want {GRAPH_STAGES}")

    # 5. the artifacts, the launches, the latents and the PCA model
    n_patches, static, (z_b, z_a) = check_front_end_outputs(
        torch, raw, supp, cells, weights)
    want = -(-n_patches // BATCH)
    log(f"run_pipeline --stages {' '.join(GRAPH_STAGES)}: "
        f"{walls['graph']:.3f} s; returned {done[raw]}; vq_lookup launches "
        f"{launches['vq_lookup']} (want {want} for {n_patches} patches at "
        f"batch {BATCH}), vq_indices {launches['vq_indices']}{tag}")
    if launches["vq_lookup"] != want or launches["vq_indices"] != 0:
        raise AssertionError("the stage graph did not launch vq_lookup once "
                             "per batch")
    lat_err, lat_flips = latents_vs_cpu(torch, static, z_b, z_a, weights)
    model = check_pca_model(os.path.join(pca_w, "pca_model.pkl"), n_patches)
    if png_size(os.path.join(pca_w, "PCA.png"))[2:] != (8, 2):
        raise AssertionError("PCA.png is not an 8-bit RGB PNG")
    log(f"pca_model.pkl: a sklearn PCA stream, k = {model.n_components_} "
        f"of {LATENT_LEN}, {n_patches} samples, explained "
        f"{np.sum(model.explained_variance_ratio_):.4f}; PCA.png")

    # 6. the transform (fit_model: false) through run_dim_reduction; the
    # fit writes no *_PCAed.pkl (in neither package), so its output is held
    # against the fitted model's transform of the same latents
    t0 = time.perf_counter()
    run_dim_reduction.main(["-m", "pca", "-c", cfgs[False], "--device",
                            dev.type])
    walls["run_dim_reduction -m pca"] = time.perf_counter() - t0
    pcs = load_pickle(os.path.join(pcs_dir, "B2_latent_space_after_PCAed.pkl"))
    want_pcs = load_pca_model(os.path.join(pca_w, "pca_model.pkl")) \
        .transform(z_a)
    if pcs.shape != (n_patches, model.n_components_) or \
            not np.array_equal(pcs, want_pcs):
        raise AssertionError("the transform differs from the fitted model's")
    log(f"run_dim_reduction -m pca (transform): "
        f"{walls['run_dim_reduction -m pca']:.3f} s; "
        f"B2_latent_space_after_PCAed.pkl {pcs.shape} {pcs.dtype} equals "
        "the fitted model's transform bit for bit")

    # per stage: wall (the orchestrator's stage_timer records) and host
    # share, the device's busy time inside the stage from the traces of
    # steps 2 and 4 (their walls include the profiler's own cost)
    stage_s = stage_seconds(timing_log)
    stages = ["segmentation"] + GRAPH_STAGES
    device_s = None if seg_device is None or graph_device is None else \
        {**seg_device, **graph_device}
    shares = {}
    for stage in stages:
        if device_s is None:
            shares[stage] = None
            log(f"stage {stage}: {stage_s[stage]:.3f} s wall (stage_timer), "
                f"device time and host share not measured (the trace holds "
                f"no device event){tag}")
            continue
        shares[stage] = 1 - device_s[stage] / stage_s[stage]
        log(f"stage {stage}: {stage_s[stage]:.3f} s wall (stage_timer), "
            f"device busy {device_s[stage]:.4f} s (torch.profiler trace of "
            f"this run), host share {shares[stage]:.4f}{tag}")
    graph_s = sum(stage_s[s] for s in stages)
    graph_share = "not measured" if device_s is None else \
        f"{1 - sum(device_s.values()) / graph_s:.4f}"
    log(f"raw TIFFs to PCs: run_preproc {walls['run_preproc']:.3f} s + "
        f"stages {graph_s:.3f} s for {FE_T} frames; host share of the stages "
        f"{graph_share}; peak device memory {graph_peak:.3f} GB{tag}")

    # 7. a plate-scale PCA fit, and its SVD with each cuSOLVER driver
    torch.cuda.reset_peak_memory_stats()
    n_plate = PLATE_WELLS * PLATE_PATCHES
    x = plate_latents(torch, dev, n_plate, SEED + 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pca = fit_pca_device(x, device=dev)
    fit_s = time.perf_counter() - t0
    k = pca.n_components_
    drivers = svd_drivers(torch, x, k)
    if not drivers["gesvdj"]["ortho"] > PCA_ORTHO_ATOL:
        raise AssertionError("the default-driver control lands inside the "
                             "orthonormality limit: the check cannot see "
                             "it")
    t0 = time.perf_counter()
    x_host = x.cpu().numpy()
    fetch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plate_pcs = pca.transform(x_host)
    transform_s = time.perf_counter() - t0
    del x_host
    var_err, ortho = pca_f64_errors(torch, x, pca.mean_, pca.components_,
                                    pca.explained_variance_)
    plate_peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"plate PCA: {n_plate} x {LATENT_LEN} fp32 latents ({PLATE_WELLS} "
        f"wells of {PLATE_PATCHES}; {x.numel() * 4 / 1e9:.3f} GB on the "
        f"card), k = {k} (explained "
        f"{float(np.sum(pca.explained_variance_ratio_)):.4f}): fit "
        f"{fit_s:.3f} s ({svd_driver(dev)}), fetch to the host "
        f"{fetch_s:.3f} s, transform on the host {transform_s:.3f} s "
        f"({plate_pcs.shape}); float64 on the card: projected variance vs "
        f"explained_variance_ {var_err:.3e} relative (limit {PCA_RTOL}), "
        f"C C^T vs I {ortho:.3e} (limit {PCA_ORTHO_ATOL}); peak device "
        f"memory {plate_peak:.3f} GB{tag}")
    log(f"plate PCA, the SVD alone by driver: {driver_line(drivers)}{tag}")
    if not (var_err <= PCA_RTOL and ortho <= PCA_ORTHO_ATOL):
        raise AssertionError("the plate-scale PCA fails its float64 check")
    # the same plate without noise: rank-deficient, as latents whose codes
    # or dimensions repeat are; the fit must still pass its checks
    x_rd = plate_latents(torch, dev, n_plate, SEED + 11, noise=0.0)
    pca_rd = fit_pca_device(x_rd, device=dev)
    rd_err = pca_f64_errors(torch, x_rd, pca_rd.mean_, pca_rd.components_,
                            pca_rd.explained_variance_)
    rd_drivers = svd_drivers(torch, x_rd, pca_rd.n_components_)
    del x_rd
    log(f"rank-deficient plate (rank {PLATE_RANK + PLATE_WELLS - 1}): the "
        f"fit's k = {pca_rd.n_components_}, variance {rd_err[0]:.3e}, C C^T "
        f"vs I {rd_err[1]:.3e}; by driver: {driver_line(rd_drivers)}{tag}")
    if not (rd_err[0] <= PCA_RTOL and rd_err[1] <= PCA_ORTHO_ATOL):
        raise AssertionError("the rank-deficient PCA fails its float64 "
                             "check")

    # 8. the UMAP reference grid on the first UMAP_WELLS wells
    torch.cuda.reset_peak_memory_stats()
    n_umap = UMAP_WELLS * PLATE_PATCHES
    xu = x[:n_umap].cpu().numpy()
    del x
    labels = np.repeat(np.arange(UMAP_WELLS), PLATE_PATCHES).tolist()
    umap_dir = os.path.join(root, "pp_umap")
    t0 = time.perf_counter()
    reducers = fit_umap(xu, umap_dir, labels,
                        [f"well {i}" for i in range(UMAP_WELLS)],
                        n_nbrs=UMAP_GRID, device=dev)
    umap_s = time.perf_counter() - t0
    umap_peak = torch.cuda.max_memory_allocated() / 1e9
    umap_runs = {}
    for k_nbr, red in zip(UMAP_GRID, reducers):
        emb, got_labels = load_pickle(os.path.join(
            umap_dir, f"umap_nbr{k_nbr}_a1.58_b0.9.pkl"))
        if emb.shape != (n_umap, 2) or not np.isfinite(emb).all() or \
                got_labels != labels:
            raise AssertionError(f"umap_nbr{k_nbr}: {emb.shape}")
        umap_runs[k_nbr] = dict(red.timings_, init=red.init_)
        tm = red.timings_
        log(f"UMAP n_neighbors={k_nbr}: kNN {tm['knn_s']:.3f} s (card), "
            f"fuzzy set {tm['fuzzy_s']:.3f} s (host), init {red.init_} "
            f"{tm['init_s']:.3f} s (host), optimisation "
            f"{tm['optimize_s']:.3f} s (card; {tm['n_epochs']} epochs, "
            f"{tm['n_edges']} edges){tag}")
    t0 = time.perf_counter()
    again = NativeUMAP(a=1.58, b=0.9, n_neighbors=UMAP_GRID[0],
                       device=dev).fit_transform(xu)
    repeat_s = time.perf_counter() - t0
    if not np.array_equal(again, reducers[0].embedding_):
        raise AssertionError("the n_neighbors=15 UMAP fit is not "
                             "reproducible bit for bit")
    sub = xu[:UMAP_KNN_ROWS]
    ic, dc = knn_graph(sub, UMAP_GRID[0], device=dev)
    ih, dh = knn_graph(sub, UMAP_GRID[0], device="cpu")
    s64 = sub.astype(np.float64)
    sq = (s64 * s64).sum(1)
    exact = sq[:, None] - 2 * s64 @ s64.T + sq[None]
    rounding = 8 * np.finfo(np.float32).eps * 2 * sq.max()
    ties = 0
    for r in range(len(sub)):
        a, b = set(ic[r]), set(ih[r])
        if a != b:
            kth = max(exact[r, list(a | b)])
            if any(exact[r, j] < kth - rounding for j in a ^ b):
                raise AssertionError(f"kNN row {r}: card and CPU differ "
                                     "beyond a tie")
            ties += 1
    dist_err = float(np.max(np.abs(np.sort(dc, 1) / np.sort(dh, 1) - 1)))
    if dist_err > UMAP_DIST_RTOL:
        raise AssertionError(f"kNN distances card vs CPU {dist_err:.3e}")
    log(f"UMAP grid {UMAP_GRID} on {n_umap} x {LATENT_LEN} latents: "
        f"{umap_s:.3f} s (fit_umap, UMAP.png and pickles included), peak "
        f"device memory {umap_peak:.3f} GB; the n_neighbors=15 fit again "
        f"{repeat_s:.3f} s, bit-equal; kNN card vs CPU on {UMAP_KNN_ROWS} "
        f"rows: equal but for {ties} rows of ties, distances within "
        f"{dist_err:.3e} relative{tag}")
    log(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return dict(n_cells=n, n_patches=n_patches, walls=walls,
                stage_s=stage_s, device_s=device_s, host_shares=shares,
                launches=launches, dirs=(raw, supp), cells=cells,
                probs_path=os.path.join(raw,
                                        f"{FE_SITE}_NNProbabilities.npy"),
                seg_weights=os.path.join(root, "seg_weights"),
                latent_err=lat_err, latent_flips=lat_flips,
                graph_peak_gb=graph_peak,
                plate=dict(n=n_plate, k=k, fit_s=fit_s, drivers=drivers,
                           fetch_s=fetch_s, transform_s=transform_s,
                           var_err=var_err, ortho=ortho,
                           peak_gb=plate_peak, rank_deficient=dict(
                               k=pca_rd.n_components_, var_err=rd_err[0],
                               ortho=rd_err[1], drivers=rd_drivers)),
                umap=dict(n=n_umap, runs=umap_runs, total_s=umap_s,
                          repeat_s=repeat_s, knn_ties=ties,
                          knn_dist_err=dist_err, peak_gb=umap_peak))


# ---------------------------------------------------------------- phase 11

# The device-resident front end on phase 10's site and frames (12 frames of
# 3 x 2048 x 2048, the npy run_preproc wrote): run_pipeline with
# patch.fused (the fused seg -> instance -> patch stage, then the staged
# rest), then with latent_encoding.streaming too (raw -> latents in one
# pass), each against phase 10's staged run.
FUSED_STAGES = ["segmentation"] + [s for s in GRAPH_STAGES if s != "pca"]
FUSED_EXECUTED = {
    "fused": ["seg_patch_fused", "build_trajectories", "assemble", "process",
              "trajectory_matching"],
    "streaming": ["seg_patch_stream", "build_trajectories", "assemble",
                  "trajectory_matching"]}
# phase 9's first channel is 28000-30999 off a cell and at least 33600 on
# one (front_end_arrays), so a threshold between rebuilds the planted cells
PLANT_THR = 32000.0


class PlantedSegment:
    """Phase 8's U-Net (``seg.model.Segment``, the published widths and
    phase 10's weights) on every frame, so the card pays for it; what it
    returns are the planted probabilities, rebuilt from the frame's first
    channel as phase 9 builds them (background 0.97, cell 0.02 off a cell;
    0.05 and 0.9 on one; the third class one minus both, in float64) and
    rounded to float32, the fused stage's dtype."""

    def __init__(self, unet):
        self.unet = unet
        self.device = unet.device
        self.n_classes = unet.n_classes
        self.calls = 0
        self._lock = threading.Lock()   # site workers share the model

    def probabilities(self, x):
        torch = sys.modules["torch"]
        self.unet.probabilities(x)
        with self._lock:
            self.calls += 1
        on = x[:, 0] * 65535.0 > PLANT_THR
        bg = torch.full(on.shape, 0.97, dtype=torch.float64,
                        device=x.device).masked_fill_(on, 0.05)
        cell = torch.full(on.shape, 0.02, dtype=torch.float64,
                          device=x.device).masked_fill_(on, 0.9)
        return torch.stack([bg, cell, 1.0 - bg - cell], 1)[:, :, None] \
            .to(torch.float32)


def same(a, b, path="obj"):
    """Deep equality of pickled structures: types, dtypes, arrays element
    for element."""
    if type(a) is not type(b):
        raise AssertionError(f"{path}: {type(a)} vs {type(b)}")
    if isinstance(a, np.ndarray):
        if a.dtype != b.dtype or a.shape != b.shape or \
                not np.array_equal(a, b):
            raise AssertionError(f"{path}: arrays differ")
    elif isinstance(a, dict):
        if list(a) != list(b):
            raise AssertionError(f"{path}: keys differ")
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{path}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif not a == b:
        raise AssertionError(f"{path}: {a!r} vs {b!r}")


def check_against_staged(raw, supp, raw10, supp10, planted):
    """The run's artifacts against phase 10's staged run of the same
    frames: the site pickles, every frame's stacks (names with the supp
    root cut off), the instance maps and the raw-frame preview byte for
    byte, the probabilities (the planted ones in float32), and the well's
    file paths, static patches, relations, labels and trajectory lists.
    Returns the number of files compared."""
    from dynamorph_tpu_torch.io.pickles import load_pickle

    n = 0
    a = os.path.join(supp, "B2-supps", FE_SITE)
    b = os.path.join(supp10, "B2-supps", FE_SITE)
    for name in ("cell_positions.pkl", "cell_pixel_assignments.pkl",
                 "cell_traj.pkl"):
        same(load_pickle(os.path.join(a, name)),
             load_pickle(os.path.join(b, name)), name)
        n += 1
    for t in range(FE_T):
        same({os.path.relpath(k, supp): v for k, v in load_pickle(
            os.path.join(a, f"stacks_{t}.pkl")).items()},
            {os.path.relpath(k, supp10): v for k, v in load_pickle(
                os.path.join(b, f"stacks_{t}.pkl")).items()},
            f"stacks_{t}")
        for f in (os.path.join(a, f"segmentation_{t}.png"),
                  os.path.join(b, f"segmentation_{t}.png")):
            if not os.path.exists(f):
                raise AssertionError(f"{f} missing")
        with open(os.path.join(a, f"segmentation_{t}.png"), "rb") as fa, \
                open(os.path.join(b, f"segmentation_{t}.png"), "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"segmentation_{t}.png differs")
        n += 2
    with open(os.path.join(raw, f"{FE_SITE}.png"), "rb") as fa, \
            open(os.path.join(raw10, f"{FE_SITE}.png"), "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError(f"{FE_SITE}.png differs")
    probs = np.load(os.path.join(raw, f"{FE_SITE}_NNProbabilities.npy"))
    if probs.dtype != np.float32 or \
            not np.array_equal(probs, planted.astype(np.float32)):
        raise AssertionError("the fused probabilities are not the planted "
                             "ones")
    if png_size(os.path.join(raw, f"{FE_SITE}_NNpred.png")) != \
            (FE_FRAME, FE_FRAME, 8, 6):
        raise AssertionError(f"{FE_SITE}_NNpred.png")
    n += 3
    for name in ("B2_file_paths.pkl", "B2_static_patches.pkl",
                 "B2_static_patches_relations.pkl",
                 "B2_static_patches_labels.pkl", "B2_trajectories.pkl"):
        ours = load_pickle(os.path.join(raw, name))
        ref = load_pickle(os.path.join(raw10, name))
        if name == "B2_file_paths.pkl":
            ours = [os.path.relpath(f, supp) for f in ours]
            ref = [os.path.relpath(f, supp10) for f in ref]
        same(ours, ref, name)
        n += 1
    return n


def latents_vs_staged(torch, what, raw, raw10, weights):
    """The run's latents against phase 10's at phase 4's limits: z_before
    within LATENT_ATOL, z_after on the same codes but at near-ties the
    latents' own difference can move. Returns (max |d z_before|, flips,
    bit-equal)."""
    from dynamorph_tpu_torch.io.pickles import load_pickle

    model = os.path.basename(weights)
    z_b, z_a, r_b, r_a = (load_pickle(os.path.join(d, model, f"B2_{n}.pkl"))
                          for d in (raw, raw10) for n in
                          ("latent_space", "latent_space_after"))
    if z_b.shape != r_b.shape or z_a.shape != r_a.shape:
        raise AssertionError(f"{what}: latents {z_b.shape}, want "
                             f"{r_b.shape}")
    err = float(np.max(np.abs(z_b - r_b)))
    if not err <= LATENT_ATOL:
        raise AssertionError(f"{what}: z_before {err:.3e} from phase 10's")
    cb = torch.load(os.path.join(weights, "model.pt"))["vq.w.weight"].cpu()

    def rows(z):
        return torch.from_numpy(z).reshape(-1, 16, 256).permute(0, 2, 1) \
            .reshape(-1, 16)

    idx, idx_ref = codes_of(torch, rows(z_a), cb), codes_of(torch, rows(r_a),
                                                            cb)
    flips = torch.nonzero(idx != idx_ref).flatten()
    if len(flips):
        check_flips_vs_latents(torch, what, rows(r_b)[flips],
                               rows(z_b)[flips], cb[idx_ref[flips]],
                               cb[idx[flips]])
    bit = bool(np.array_equal(z_b, r_b) and np.array_equal(z_a, r_a))
    return err, len(flips), bit


def fused_host_costs(root, raw, supp):
    """The fused stage's host work for one frame (frame 0) and for the
    site, timed apart after the run: the stacks pickle write (the writer
    thread's), the clustering of the frame's foreground on the threads the
    stage gives each of its 3 workers, and the site's probability save and
    previews. Returns {name: seconds}."""
    from dynamorph_tpu_torch.io.pickles import load_pickle, save_pickle
    from dynamorph_tpu_torch.io.png import write_png
    from dynamorph_tpu_torch.seg.data import plot_prediction_prob
    from dynamorph_tpu_torch.track.clustering import \
        cluster_foreground_positions

    folder = os.path.join(supp, "B2-supps", FE_SITE)
    out = {}
    stacks = load_pickle(os.path.join(folder, "stacks_0.pkl"))
    t0 = time.perf_counter()
    save_pickle(stacks, os.path.join(root, "stacks_again.pkl"))
    out["stacks pickle write, one frame"] = time.perf_counter() - t0
    os.remove(os.path.join(root, "stacks_again.pkl"))
    pixels = load_pickle(os.path.join(folder,
                                      "cell_pixel_assignments.pkl"))[0][0]
    threads = max(1, (os.cpu_count() or 1) // 3)
    t0 = time.perf_counter()
    cluster_foreground_positions(pixels, (FE_FRAME, FE_FRAME),
                                 instance_map=False, threads=threads)
    out[f"clustering, one frame on {threads} threads"] = \
        time.perf_counter() - t0
    probs = np.load(os.path.join(raw, f"{FE_SITE}_NNProbabilities.npy"))
    t0 = time.perf_counter()
    np.save(os.path.join(root, "probs_again.npy"), probs)
    out["probabilities npy write, the site"] = time.perf_counter() - t0
    os.remove(os.path.join(root, "probs_again.npy"))
    frame = np.load(os.path.join(raw, f"{FE_SITE}.npy"), mmap_mode="r")
    t0 = time.perf_counter()
    write_png(os.path.join(root, "again.png"), frame[0, 0, 0])
    plot_prediction_prob(probs[0], os.path.join(root, "again_NNpred.png"))
    out["both preview PNGs, the site"] = time.perf_counter() - t0
    return out


def phase_fused_stream(torch, vq, root, dev, weights, card, staged, seg):
    phase("11. device-resident front end: run_pipeline with patch.fused, "
          "then with latent_encoding.streaming, on phase 10's site, on cuda")
    import shutil

    from dynamorph_tpu_torch.cli import run_pipeline
    from dynamorph_tpu_torch.pipeline import fused, stream
    from dynamorph_tpu_torch.seg.model import Segment
    from torch.profiler import ProfilerActivity, profile

    tag = f" [{card}]"
    t_phase = time.perf_counter()
    raw10, supp10 = staged["dirs"]
    planted = np.load(staged["probs_path"])
    n_patches = staged["n_patches"]
    models, moved = [], []

    def planted_model(config, device):
        si = config.segmentation_inference
        unet = Segment(input_shape=(len(si.channels), si.window_size,
                                    si.window_size),
                       n_classes=si.num_classes, device=device)
        unet.load(si.weights)
        models.append(PlantedSegment(unet))
        return models[-1]

    real_site = fused.process_site_seg_patch_fused

    def counted_site(*a, **k):
        moved.append(real_site(*a, **k))
        return moved[-1]

    # the path's plain PyTorch ops (XLA in the JAX package), counted per
    # call: they have no launch counter of their own
    calls = {}
    plain = [(fused, "pack_mask_bits"), (fused, "scatter_label_map"),
             (stream, "resize_select")]
    plain_saved = [getattr(m, name) for m, name in plain]

    def counted(name, fn):
        def call(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return call

    for (m, name), fn in zip(plain, plain_saved):
        setattr(m, name, counted(name, fn))
    host = {}
    saved = (fused.build_seg_model, stream.build_seg_model)
    fused.build_seg_model = stream.build_seg_model = planted_model
    fused.process_site_seg_patch_fused = counted_site
    runs = {}
    try:
        for mode in ("fused", "streaming"):
            raw, supp = (os.path.join(root, f"{mode}_{d}")
                         for d in ("raw", "supp"))
            os.makedirs(raw)
            os.symlink(os.path.join(raw10, f"{FE_SITE}.npy"),
                       os.path.join(raw, f"{FE_SITE}.npy"))
            cfg = os.path.join(root, f"{mode}.yml")
            with open(cfg, "w") as f:
                f.write("segmentation_inference:\n"
                        f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{supp}']\n"
                        f"  weights: '{staged['seg_weights']}'\n"
                        "  network: 'UNet'\n  channels: [0, 1]\n"
                        f"  num_classes: 3\n  window_size: {SEG_WINDOW}\n"
                        "patch:\n"
                        f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{supp}']\n"
                        f"  channels: [0, 1]\n  window_size: {FE_WINDOW}\n"
                        "  fused: true\n"
                        "latent_encoding:\n"
                        f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{supp}']\n"
                        f"  weights: ['{weights}']\n  save_output: False\n"
                        f"  channels: [0, 1]\n  input_size: {FE_INPUT}\n"
                        "  network: 'VQ_VAE_z16'\n"
                        f"  num_hiddens: {NET['num_hiddens']}\n"
                        "  num_residual_hiddens: "
                        f"{NET['num_residual_hiddens']}\n"
                        f"  num_embeddings: {NET['num_embeddings']}\n"
                        f"  streaming: {mode == 'streaming'}\n")
            timing_log = os.path.join(root, f"{mode}_timing.jsonl")
            os.environ["DYNAMORPH_TIMING_LOG"] = timing_log
            errors = ErrorRecords()
            logging.getLogger().addHandler(errors)
            vq.vq_lookup.launches = 0
            vq.vq_indices.launches = 0
            calls.clear()
            torch.cuda.reset_peak_memory_stats()
            pinned_stats = hasattr(torch.cuda, "host_memory_stats") and \
                hasattr(torch.cuda, "reset_peak_host_memory_stats")
            if pinned_stats:
                torch.cuda.reset_peak_host_memory_stats()
                pinned_before = torch.cuda.host_memory_stats().get(
                    "allocated_bytes.current", 0)
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    done = run_pipeline.main(["-c", cfg, "--stages",
                                              *FUSED_STAGES, "--device",
                                              dev.type])
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                logging.getLogger().removeHandler(errors)
                del os.environ["DYNAMORPH_TIMING_LOG"]
            launches = {"vq_lookup": vq.vq_lookup.launches,
                        "vq_indices": vq.vq_indices.launches}
            plain_calls = dict(calls)
            peak = torch.cuda.max_memory_allocated() / 1e9
            # pinned host memory: the blocks handed out at once (active)
            # and those the caching host allocator owned (allocated, cached
            # blocks of earlier phases included)
            pinned = "not measured (no torch.cuda.host_memory_stats)"
            if pinned_stats:
                hs = torch.cuda.host_memory_stats()
                active = hs.get("active_bytes.peak", 0) / 1e9
                owned = hs.get("allocated_bytes.peak", 0) / 1e9
                pinned = (f"active peak {active:.3f} GB, allocated peak "
                          f"{owned:.3f} GB ({pinned_before / 1e9:.3f} GB "
                          "before the run)")
            executed = done.get(raw)
            if executed != FUSED_EXECUTED[mode]:
                raise AssertionError(f"{mode}: stage list {done}, want "
                                     f"{FUSED_EXECUTED[mode]}")
            if errors.messages:
                raise AssertionError(f"{mode}: errors logged "
                                     f"{errors.messages}")
            stage_s = stage_seconds(timing_log)
            device_s = stage_device_seconds(torch, prof, executed)
            del prof
            if models[-1].calls != FE_T:
                raise AssertionError(f"{mode}: the U-Net ran "
                                     f"{models[-1].calls} times, want {FE_T}")
            want = -(-n_patches // BATCH)
            if launches != {"vq_lookup": want, "vq_indices": 0}:
                raise AssertionError(f"{mode}: launches {launches}, want "
                                     f"{want} vq_lookup for {n_patches} "
                                     "patches")
            want_calls = {"pack_mask_bits": FE_T, "scatter_label_map": FE_T}
            if mode == "streaming":
                want_calls["resize_select"] = FE_T
            if plain_calls != want_calls:
                raise AssertionError(f"{mode}: plain op calls {plain_calls},"
                                     f" want {want_calls}")
            n_files = check_against_staged(raw, supp, raw10, supp10,
                                           planted)
            if mode == "fused":
                host = fused_host_costs(root, raw, supp)
                log("the fused stage's host work, timed apart after the "
                    "run: " + "; ".join(f"{k} {v:.3f} s"
                                        for k, v in host.items()) + tag)
            lat = latents_vs_staged(torch, mode, raw, raw10, weights)
            m = moved[-1]
            runs[mode] = dict(executed=executed, wall=wall, stage_s=stage_s,
                              device_s=device_s, launches=launches,
                              plain_calls=plain_calls,
                              peak_gb=peak, pinned=pinned,
                              latent_err=lat[0],
                              latent_flips=lat[1], latent_bit_equal=lat[2],
                              h2d_frame=m["h2d_bytes"] / m["frames"],
                              d2h_frame=m["d2h_bytes"] / m["frames"])
            log(f"run_pipeline {mode} (--stages {' '.join(FUSED_STAGES)}): "
                f"{wall:.3f} s wall (traced); returned {executed}; the U-Net "
                f"ran on all {FE_T} frames; vq_lookup launches "
                f"{launches['vq_lookup']} (want {want} for {n_patches} "
                f"patches at batch {BATCH}), vq_indices "
                f"{launches['vq_indices']}; plain op calls "
                f"{json.dumps(plain_calls)}; {n_files} artifacts equal to "
                f"phase 10's staged run (pickles, stacks, PNGs byte for "
                f"byte, static patches), probabilities the planted ones; "
                f"latents vs phase 10's: z_before max abs {lat[0]:.3e} "
                f"(limit {LATENT_ATOL}), {lat[1]} z_after code flips "
                f"(near-ties), bit-equal: {lat[2]}; per frame host->device "
                f"{runs[mode]['h2d_frame'] / 1e6:.3f} MB, device->host "
                f"{runs[mode]['d2h_frame'] / 1e6:.3f} MB (the stage's own "
                f"count); peak device memory {peak:.3f} GB; pinned host "
                f"memory {pinned}{tag}")
            for stage in executed:
                share = "not measured (the trace holds no device event)" \
                    if device_s is None else \
                    f"{1 - device_s[stage] / stage_s[stage]:.4f}"
                busy = "not measured" if device_s is None else \
                    f"{device_s[stage]:.4f} s"
                log(f"  {mode} stage {stage}: {stage_s[stage]:.3f} s wall "
                    f"(stage_timer), device busy {busy} (torch.profiler), "
                    f"host share {share}{tag}")
            shutil.rmtree(supp)        # 1.5 GB of float64 stacks
    finally:
        fused.build_seg_model, stream.build_seg_model = saved
        fused.process_site_seg_patch_fused = real_site
        for (m, name), fn in zip(plain, plain_saved):
            setattr(m, name, fn)

    front = ["segmentation", "instance_segmentation", "extract_patches"]
    st, sh = staged["stage_s"], staged["host_shares"]
    staged_s = sum(st[s] for s in front)
    staged_share = "not measured" if sh["segmentation"] is None else \
        f"{1 - sum((1 - sh[s]) * st[s] for s in front) / staged_s:.4f}"
    for mode, first in (("fused", "seg_patch_fused"),
                        ("streaming", "seg_patch_stream")):
        r = runs[mode]
        share = "not measured" if r["device_s"] is None else \
            f"{1 - r['device_s'][first] / r['stage_s'][first]:.4f}"
        r["front_s"] = r["stage_s"][first]
        r["front_share"] = None if r["device_s"] is None else \
            1 - r["device_s"][first] / r["stage_s"][first]
        log(f"{first}: {r['front_s']:.3f} s for {FE_T} frames "
            f"({1e3 * r['front_s'] / FE_T:.3f} ms a frame), host share "
            f"{share}; the stages {sum(r['stage_s'].values()):.3f} s{tag}")
    direct = seg["timed"]["direct"]
    log(f"beside them: phase 10's staged segmentation (tiled) + "
        f"instance_segmentation + extract_patches {staged_s:.3f} s "
        f"(host share {staged_share}); phase 8's direct mode, one "
        f"{SEG_FRAME}x{SEG_FRAME} frame from a host array "
        f"{direct['wall_ms']:.3f} ms, its device work "
        f"{direct['device_ms']:.3f} ms{tag}")
    log(f"phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return dict(runs=runs, staged_front_s=staged_s, host=host)


# ---------------------------------------------------------------- phase 12
#
# Slice E1's networks through the real CLIs: VAE, IWAE and AAE at the z16
# widths of configs/config_example.yml:61-65 (phase 4's NET), ResNet50 at
# the training section's batch_size 768 and n_pos_samples 4 (:99-104: 192
# anchors, 768 patches a step), the loss weights of TRAIN_NET. Depth is
# cut to one epoch of 1,536 synthetic patches (trajectories of TRAJ_LEN,
# the label of a patch its trajectory) and phase 4's one well.

VAE_FAMILY = ("VAE", "IWAE", "AAE")
E1_NETS = VAE_FAMILY + ("ResNet50",)
N_POS = 4
E1_TRAIN_PATCHES = 1536
E1_CHECK = 8                # patches of the card-vs-CPU train step
E1_ENCODE_CHECK = 64        # patches of the card-vs-CPU encode
# card vs CPU latents of these networks: 1e-5 of max |z|, ten times under
# phase 4's LATENT_ATOL. fp32 on both sides lands at 2-9e-7 of max |z|
# (measured on an H100 80GB HBM3 at 700 W); TF32 on the VAE family's
# narrow convolutions at 1.3-2.7e-4, which LATENT_ATOL would see by a
# factor of 1.3-2.7 only.
E1_ENCODE_ATOL = 1e-5
# one train step card vs CPU, at phase 6's rule: each weight tensor's
# gradient within E1_GRAD_VS_CPU x the CPU's error + E1_GRAD_FLOOR of
# float64 (relative L2). Each fp32 step is held against float64 on its own
# side of every kink: a ReLU pre-activation (or a triplet hinge, or a
# max-pool's runner-up) within rounding of its switch takes its side from
# rounding, and one such element, spread over its channel by batch norm's
# backward, moves whole gradients by 1e-4-1e-2 (on an H100 the z16 family
# at 8 of 48 default inits, ResNet18 at 11 of 16: PERF.md section 6). So
# the float64 steps replay the fp32 step's choices (kink_branches), and
# the flips are counted.
E1_GRAD_VS_CPU = 3.0
E1_GRAD_FLOOR = 1e-5
E1_FAMILIES = (
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("convolutions (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                              "winograd", "fft", "cf32", "xmma")),
    ("matrix products (cuBLAS: fc layers, the miner's Gram matrix)",
     ("gemm", "cutlass")),
    ("Adam (foreach)", ("adam", "multi_tensor")),
)
E1_OTHER = ("elementwise and reductions (ReLU, pooling, the miner's "
            "(B, B, B) hinge, masks, counts, augmentation)")


def write_e1_training_dir(root):
    """The raw dir all four networks train on: float32 (N, 2, 1, 128, 128)
    patches, trajectory labels and relations."""
    from dynamorph_tpu_torch.io.pickles import save_pickle

    raw = os.path.join(root, "e1_train_raw")
    os.makedirs(raw)
    data = blob_patches(np.random.RandomState(SEED + 12), E1_TRAIN_PATCHES)
    save_pickle(data[:, :, None].astype(np.float32),
                os.path.join(raw, "im_static_patches.pkl"))
    save_pickle(np.arange(E1_TRAIN_PATCHES) // TRAJ_LEN,
                os.path.join(raw, "im_static_patches_labels.pkl"))
    save_pickle(trajectory_relations(E1_TRAIN_PATCHES),
                os.path.join(raw, "im_static_patches_relations.pkl"))
    return raw, data


def e1_training_config(root, raw, network):
    widths = (f"  num_hiddens: {NET['num_hiddens']}\n"
              f"  num_residual_hiddens: {NET['num_residual_hiddens']}\n"
              if network in VAE_FAMILY else "")
    cfg = os.path.join(root, f"e1_train_{network}.yml")
    with open(cfg, "w") as f:
        f.write("training:\n"
                f"  raw_dirs: ['{raw}']\n"
                f"  supp_dirs: ['{os.path.join(root, 'e1_supp')}']\n"
                f"  weights_dirs: ['{os.path.join(root, 'e1_out')}']\n"
                f"  network: '{network}'\n" + widths
                + "".join(f"  {k}: {TRAIN_NET[k]}\n" for k in (
                    "num_inputs", "num_residual_layers", "weight_matching",
                    "margin", "w_a", "w_t", "w_n"))
                + f"  n_epochs: 1\n  learn_rate: 0.0001\n"
                f"  batch_size: {TRAIN_BATCH}\n  n_pos_samples: {N_POS}\n"
                "  val_split_ratio: 0.15\n  patience: 100\n"
                f"  model_name: '{network}'\n")
    return cfg, os.path.join(root, "e1_out", network)


def e1_model(network, hard_negative=False):
    from dynamorph_tpu_torch.models import build_model
    from dynamorph_tpu_torch.models.resnet_simclr import EncodeProject

    if network.startswith("ResNet"):
        return EncodeProject(arch=network, hard_negative=hard_negative)
    return build_model(network, num_inputs=2, **NET)


def e1_encode(torch, model, x):
    """The latent: ``EncodeProject.encode``'s z, the VAE family's z_before."""
    out = model.encode(x)
    return out if torch.is_tensor(out) else out[0]


def e1_tf32_forward(torch, model, x):
    """The encode's forward outside ``fp32_strict``, TF32 on: what the
    card-vs-CPU check would see if the encode left TF32 to cuDNN."""
    from dynamorph_tpu_torch.models import common

    saved = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad(), common.batch_stats(model, False):
            if hasattr(model, "convnet"):
                return model.projection(model.convnet(x))
            z = model.enc[2:](model.enc[1](model.enc[0](x)))
            return z[:, :model.num_hiddens]
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved


@contextlib.contextmanager
def kink_branches(torch, masks, replay):
    """Inside the block every kink of these models' train steps appends its
    choice to ``masks`` in call order; with ``replay`` it takes the
    recorded choice instead, so a float64 step follows an fp32 step's
    branches. The kinks: ``F.relu`` (each ReLU of the networks; its mask
    ``x > 0``), ``Tensor.relu_`` (the all-triplet miner's hinge),
    ``F.max_pool2d`` (the ResNet stem's max-pool; its argmax), ``torch.max``
    over a ``dim`` (the hard-negative miner's hardest positive and row
    maximum, the IWAE's largest log-weight; its argmax) and ``torch.clamp``
    with a ``min`` alone (the miners' distance clamp, the hard-negative
    hinge, the time-matching loss's distance and hinge; its active mask
    ``x >= min``, where its gradient is 1). A replayed active hinge passes
    ``x`` with gradient 1, at least 2e-16, so that the miner counts it as
    the fp32 step did. A ReLU folded into the port's batch-norm kernel
    (``ops.batch_norm``, fp32 on the card) records its mask ``y > 0`` in
    the same order; the replaying step, in float64, runs ``F.relu`` there.
    The patches leave the models' arithmetic as it is."""
    from dynamorph_tpu_torch.ops import batch_norm as bn_ops

    F = torch.nn.functional
    relu, relu_, max_pool = F.relu, torch.Tensor.relu_, F.max_pool2d
    tmax, tclamp = torch.max, torch.clamp
    bn_apply = bn_ops._BatchNormTrain.apply
    queue = iter(masks)

    def folded(*args):
        if replay:
            raise RuntimeError("a replayed step must run F.relu: the "
                               "batch-norm kernel cannot take a mask")
        y = bn_apply(*args)
        if args[-1]:     # relu
            masks.append((y > 0).cpu())
        return y

    def branch(x, inplace=False):
        if replay:
            return x * next(queue).to(x.device, x.dtype)
        masks.append((x > 0).cpu())
        return relu(x, inplace)

    def hinge(x):
        if replay:
            lifted = x + (x.detach().clamp(min=2e-16) - x.detach())
            return x.copy_(torch.where(next(queue).to(x.device), lifted,
                                       0.0))
        masks.append((x > 0).cpu())
        return relu_(x)

    def pool(x, *args, **kwargs):
        if replay:
            idx = next(queue).to(x.device)
            return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        y, idx = max_pool(x, *args, **kwargs, return_indices=True)
        masks.append(idx.cpu())
        return y

    def max_(x, *args, **kwargs):
        dim = args[0] if args and isinstance(args[0], int) \
            else kwargs.get("dim")
        if dim is None:
            return tmax(x, *args, **kwargs)
        keepdim = args[1] if len(args) > 1 else kwargs.get("keepdim", False)
        if not replay:
            out = tmax(x, dim, keepdim=keepdim)
            masks.append(out.indices.cpu())
            return out
        idx = next(queue).to(x.device)
        values = x.gather(dim, idx if keepdim else idx.unsqueeze(dim))
        return torch.return_types.max(
            (values if keepdim else values.squeeze(dim), idx))

    def clamp(x, *args, **kwargs):
        if args or set(kwargs) != {"min"}:
            return tclamp(x, *args, **kwargs)
        lo = kwargs["min"]
        if replay:
            return torch.where(next(queue).to(x.device), x, lo)
        masks.append((x >= lo).cpu())
        return tclamp(x, min=lo)

    F.relu, torch.Tensor.relu_, F.max_pool2d = branch, hinge, pool
    torch.max, torch.clamp = max_, clamp
    bn_ops._BatchNormTrain.apply = folded
    try:
        yield
    finally:
        F.relu, torch.Tensor.relu_, F.max_pool2d = relu, relu_, max_pool
        torch.max, torch.clamp = tmax, tclamp
        del bn_ops._BatchNormTrain.apply    # torch.autograd.Function's


def e1_step_grads(torch, model, network, x, noise, labels, fp32=True,
                  masks=None, replay=False):
    """One train-mode forward and backward (no optimizer step): (losses,
    {weight: gradient as float64 on the host}, the ResNet's embedding as
    float64 on the host or None). ``fp32=False`` is the TF32
    control: the models' own ``fp32_strict`` blocks are swapped for no-ops
    for the call, so forward and backward run with PyTorch's TF32
    defaults. ``masks`` records (or with ``replay`` replays) the choices
    at every kink (``kink_branches``)."""
    from dynamorph_tpu_torch.core.device import fp32_strict
    from dynamorph_tpu_torch.models import losses as losses_mod
    from dynamorph_tpu_torch.models import resnet_simclr, vae

    mods = (vae, resnet_simclr, losses_mod)
    saved = [m.fp32_strict for m in mods]
    tf32 = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    if not fp32:
        for m in mods:
            m.fp32_strict = contextlib.nullcontext
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with fp32_strict() if fp32 else contextlib.nullcontext(), \
                kink_branches(torch, masks, replay) if masks is not None \
                else contextlib.nullcontext():
            if network.startswith("ResNet"):
                z, losses = model.apply(x, labels, train=True)
            else:
                z, losses = None, model.apply(x, train=True, **noise)[1]
            losses["total_loss"].backward()
    finally:
        for m, f in zip(mods, saved):
            m.fp32_strict = f
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    grads = {n: p.grad.detach().cpu().double()
             for n, p in model.named_parameters()
             if p.grad is not None and n.endswith(".weight")}
    return ({k: float(v.detach()) for k, v in losses.items()}, grads,
            None if z is None else z.detach().cpu().double())


def e1_seeded_model(torch, network, hard_negative=False):
    """The network with seeded weights, batch norm moved off the
    identity."""
    from torch import nn

    torch.manual_seed(SEED + 12)
    model = e1_model(network, hard_negative)
    g = torch.Generator().manual_seed(SEED + 12)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                n = m.num_features
                m.running_mean.copy_(0.2 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
                m.weight.copy_(0.7 + 0.6 * torch.rand(n, generator=g))
                if m.bias.requires_grad:
                    m.bias.copy_(0.2 * torch.randn(n, generator=g))
    return model


def e1_step_vs_cpu(torch, network, base, data, dev, tag, weights):
    """A train step of ``base`` on the card against the CPU, each held
    against the same step in float64 on the CPU taken on its own side of
    every ReLU, hinge and max-pool (``kink_branches``; phase 6's rule), and
    the TF32 control,
    held against float64 on the card's side. ``weights`` names the weights
    in the log. The noise is drawn once on the CPU and fed to all."""
    from dynamorph_tpu_torch.train.data import zscore

    x = torch.from_numpy(zscore(data[:E1_CHECK]).astype(np.float32))
    labels = torch.arange(E1_CHECK) // (E1_CHECK // 2)
    g = torch.Generator().manual_seed(SEED + 12)
    zshape = (E1_CHECK, NET["num_hiddens"], 16, 16)
    noise = {}
    if network == "VAE":
        noise["eps"] = torch.randn(zshape, generator=g)
    if network == "IWAE":
        noise["fixed_eps"] = torch.randn((base.k,) + zshape, generator=g)

    def run(device, dtype, fp32=True, masks=None, replay=False):
        model = copy.deepcopy(base).to(device=device, dtype=dtype)
        return e1_step_grads(
            torch, model, network, x.to(device, dtype),
            {k: v.to(device, dtype) for k, v in noise.items()},
            labels.to(device), fp32, masks, replay)

    m_gpu, m_cpu, m_f64 = [], [], []
    l_gpu, g_gpu, z_gpu = run(dev, torch.float32, masks=m_gpu)
    l_cpu, g_cpu, z_cpu = run("cpu", torch.float32, masks=m_cpu)
    run("cpu", torch.float64, masks=m_f64)
    l_f64, g_f64, z_f64 = run("cpu", torch.float64, masks=m_gpu, replay=True)
    l_f64c, g_f64c, z_f64c = run("cpu", torch.float64, masks=m_cpu,
                                 replay=True)
    _, g_ctrl, z_ctrl = run(dev, torch.float32, fp32=False)

    def flips(masks):
        return sum(int((a != b).sum()) for a, b in zip(masks, m_f64))

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-6)

    def rel_l2(a, b):
        return float(torch.norm(a - b) / max(float(torch.norm(b)), 1e-30))

    # the losses card vs CPU at phase 6's rtol; the fraction of positive
    # triplets, a count of hinges, within one triplet. The triplet loss
    # reads the embedding alone, which a ResNet50 step in fp32 leaves
    # about 7e-5 (relative L2) from float64 on either device, and the loss
    # follows it by 1e-5-1e-4 (on an H100): so the embedding is held to
    # float64 by the gradients' rule below, and the loss to the float64
    # miner on the card's own embedding at phase 6's rtol.
    n_trip = sum(int((labels == a).sum() - 1) * int((labels != a).sum())
                 for a in labels)
    if z_gpu is not None:
        l_ref = dict(l_cpu, total_loss=float(
            base.miner(labels, z_gpu)[0]))
    else:
        l_ref = l_cpu
    loss_ratio = {k: abs(l_gpu[k] - l_cpu[k]) * n_trip
                  if k == "positive_triplet"
                  else rel(l_gpu[k], l_ref[k]) / STEP_LOSS_RTOL
                  for k in l_cpu}
    worst_k = max(loss_ratio, key=loss_ratio.get)
    e_cpu = {n: rel_l2(g_cpu[n], g_f64c[n]) for n in g_f64}

    def ratio(grads):
        r = {n: rel_l2(grads[n], g_f64[n]) / (
            E1_GRAD_VS_CPU * e_cpu[n] + E1_GRAD_FLOOR) for n in g_f64}
        worst = max(r, key=r.get)
        return r[worst], worst

    if z_gpu is not None:
        g_gpu = dict(g_gpu, embedding=z_gpu)
        g_ctrl = dict(g_ctrl, embedding=z_ctrl)
        g_f64 = dict(g_f64, embedding=z_f64)
        e_cpu["embedding"] = rel_l2(z_cpu, z_f64c)
    grad_ratio, worst = ratio(g_gpu)
    ctrl_ratio, ctrl_worst = ratio(g_ctrl)
    e_worst = rel_l2(g_gpu[worst], g_f64[worst])
    n_choices = sum(int(m.numel()) for m in m_f64)
    log(f"  {network} train step on {E1_CHECK} patches, {weights} weights, "
        f"card vs CPU: ReLU, hinge and max-pool choices against float64's "
        f"own: card "
        f"{flips(m_gpu)}, CPU {flips(m_cpu)} of {n_choices} flipped (each "
        f"float64 step below takes its fp32 step's choices); losses card vs "
        f"CPU (the triplet loss against the float64 miner on the card's "
        f"embedding): worst {worst_k} at {loss_ratio[worst_k]:.3f} of the "
        f"limit (rtol {STEP_LOSS_RTOL:g}; the positive-triplet fraction one "
        f"triplet of {n_trip}; against float64: card "
        f"{rel(l_gpu[worst_k], l_f64[worst_k]):.3e}, CPU "
        f"{rel(l_cpu[worst_k], l_f64c[worst_k]):.3e}); gradients (and a "
        f"ResNet's embedding) vs float64: worst {worst} at "
        f"{grad_ratio:.3f} of the limit (card error <= {E1_GRAD_VS_CPU:g} x "
        f"CPU error + {E1_GRAD_FLOOR:g}, relative L2: card {e_worst:.3e}, "
        f"CPU {e_cpu[worst]:.3e}); TF32 control (forward and backward with "
        f"TF32 on): {ctrl_worst} at {ctrl_ratio:.3f} of the limit{tag}")
    if loss_ratio[worst_k] > 1:
        raise AssertionError(f"{network} ({weights}): train-step loss "
                             f"{worst_k} at {loss_ratio[worst_k]:.3f} of its "
                             "limit")
    if grad_ratio > 1:
        raise AssertionError(f"{network} ({weights}): gradient {worst} at "
                             f"{grad_ratio:.3f} of its limit")
    if not ctrl_ratio > 1:
        raise AssertionError(f"{network} ({weights}): the TF32 control step "
                             f"lands at {ctrl_ratio:.3f} of the limit: the "
                             "check cannot see TF32")
    return dict(loss_rel=rel(l_gpu[worst_k], l_cpu[worst_k]),
                grad_ratio=grad_ratio, control=ctrl_ratio, worst=worst,
                card=e_worst,
                cpu=e_cpu[worst], flips_card=flips(m_gpu),
                flips_cpu=flips(m_cpu))


def e1_step_timing(torch, network, model, dev, tag):
    """ms per train step at batch 768 on a device-resident batch (the
    VQ-VAE family with augmentation and a relation block; ResNet50 with
    192 labels x 4), its peak memory and its device time by kernel
    family; for ResNet50 also the miner's forward + backward alone."""
    from dynamorph_tpu_torch.models.losses import AllTripletMiner
    from dynamorph_tpu_torch.train.data import zscore
    from dynamorph_tpu_torch.train.steps import (make_train_step,
                                                 make_triplet_steps)

    x = torch.from_numpy(zscore(blob_patches(
        np.random.RandomState(SEED + 13), TRAIN_BATCH)).astype(np.float32))
    x = x.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                           eps=1e-8)
    if network.startswith("ResNet"):
        labels = (torch.arange(TRAIN_BATCH) // N_POS).to(dev)
        step, _ = make_triplet_steps(model, opt)

        def one_step():
            return step(x, labels)
        iters = 3
    else:
        rel = torch.from_numpy(relation_block(TRAIN_BATCH)).to(dev)
        step = make_train_step(model, opt, augment=True,
                               generator=torch.Generator(device=dev)
                               .manual_seed(SEED))

        def one_step():
            return step(x, rel, None)
        iters = 5
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_cuda(torch, one_step, iters)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"{network} train step, batch {TRAIN_BATCH}, device-resident: "
        f"{step_ms:.6f} ms, {TRAIN_BATCH / step_ms * 1e3:.1f} patches/s; "
        f"peak device memory {peak:.3f} GB{tag}")
    prof = profile_steps(torch, one_step, 2, step_ms,
                         families=E1_FAMILIES, other=E1_OTHER, tag=tag)
    out = dict(step_ms=step_ms, peak_gb=peak, profile=prof)
    if network.startswith("ResNet"):
        emb = torch.randn(TRAIN_BATCH, 128, device=dev, requires_grad=True)
        miner = AllTripletMiner(margin=TRAIN_NET["margin"])
        lab = (torch.arange(TRAIN_BATCH) // N_POS).to(dev)

        def mine():
            emb.grad = None
            loss, _ = miner(lab, emb)
            loss.backward()

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        miner_ms = time_cuda(torch, mine, 5)
        miner_peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
        out.update(miner_ms=miner_ms, miner_share=miner_ms / step_ms,
                   miner_peak_gb=miner_peak)
        log(f"the all-triplet miner alone (B={TRAIN_BATCH}, D=128, forward "
            f"+ backward, CUDA events): {miner_ms:.6f} ms, "
            f"{miner_ms / step_ms:.4f} of the step; its own peak memory "
            f"{miner_peak:.3f} GB above its inputs{tag}")
    return out


def phase_other_encoders(torch, vq, root, dev, card, well):
    phase("12. other encoders: run_training and run_vae -m process with "
          "VAE, IWAE, AAE (z16 widths) and ResNet50 (batch 768, 4 "
          "positives), on cuda")
    from dynamorph_tpu_torch.cli import run_training, run_vae
    from dynamorph_tpu_torch.io.pickles import load_pickle
    from dynamorph_tpu_torch.models.jax_import import (
        load_reference_checkpoint)
    from dynamorph_tpu_torch.pipeline.patch_vae import encode_patches
    from dynamorph_tpu_torch.train.data import zscore_patch

    tag = f" [{card}]"
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    train_raw, train_data = write_e1_training_dir(root)
    raw, data = well["raw"], well["data"]
    n_val = int(np.floor(0.15 * E1_TRAIN_PATCHES))
    n_train = E1_TRAIN_PATCHES - n_val
    runs = {}
    for network in E1_NETS:
        r = runs[network] = {}
        # (b) and (c): run_training, one epoch
        cfg, out = e1_training_config(root, train_raw, network)
        per_step = TRAIN_BATCH // N_POS if network.startswith("ResNet") \
            else TRAIN_BATCH
        steps = -(-n_train // per_step) + -(-n_val // per_step)
        vq.vq_lookup.launches = vq.vq_indices.launches = 0
        bn_zero()
        t0 = time.perf_counter()
        model, hist = run_training.main(["-c", cfg, "--device", dev.type])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        r["launches"] = {"vq_lookup": vq.vq_lookup.launches,
                         "vq_indices": vq.vq_indices.launches}
        # the VAE family's trunk is z16's (8 batch norms a training pass);
        # the ResNets keep torch's own batch norm
        r["batch_norm"] = bn_counted()
        if r["batch_norm"][1] or (r["batch_norm"][0] > 0) != (
                network in VAE_FAMILY):
            raise AssertionError(f"{network}: batch_norm launches and "
                                 f"fallbacks {r['batch_norm']}")
        if len(hist) != 1 or not all(np.isfinite(v) for split in
                                     ("train", "val")
                                     for v in hist[0][split].values()):
            raise AssertionError(f"{network}: history {hist}")
        weights_pt = os.path.join(out, "model.pt")
        fresh = e1_model(network)
        fresh.load_state_dict(load_reference_checkpoint(weights_pt),
                              strict=True)
        r.update(train_wall=wall, train_steps=steps, hist=hist[0])
        unit = f"anchors x {N_POS}" if per_step != TRAIN_BATCH \
            else "patches"
        log(f"run_training {network}: {wall:.3f} s wall for one epoch of "
            f"{E1_TRAIN_PATCHES} patches ({steps} steps of {per_step} {unit}"
            f", {wall / steps * 1e3:.1f} ms a step end to end, host "
            f"batching included); train "
            + json.dumps({k: round(v, 6) for k, v in hist[0]["train"].items()})
            + " val "
            + json.dumps({k: round(v, 6) for k, v in hist[0]["val"].items()})
            + f"; model.pt loads strict; vq kernel launches {r['launches']}"
            + f"; batch_norm launches and fallbacks {r['batch_norm']}" + tag)

        # (a): run_vae -m process from that model.pt, on phase 4's well
        pcfg = os.path.join(root, f"e1_process_{network}.yml")
        with open(pcfg, "w") as f:
            f.write("latent_encoding:\n"
                    f"  raw_dirs: ['{raw}']\n"
                    f"  supp_dirs: ['{os.path.join(root, 'supp')}']\n"
                    f"  weights: ['{out}']\n"
                    "  fov: ['C5-Site_0', 'C5-Site_1']\n"
                    f"  save_output: False\n  network: '{network}'\n"
                    f"  num_hiddens: {NET['num_hiddens']}\n"
                    f"  num_residual_hiddens: {NET['num_residual_hiddens']}\n")
        vq.vq_lookup.launches = vq.vq_indices.launches = 0
        t0 = time.perf_counter()
        run_vae.main(["-m", "process", "-c", pcfg, "--device", dev.type])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        r["launches"]["vq_lookup"] += vq.vq_lookup.launches
        r["launches"]["vq_indices"] += vq.vq_indices.launches
        if any(r["launches"].values()):
            raise AssertionError(f"{network}: a VQ kernel was launched on a "
                                 "path without a codebook")
        lat_dir = os.path.join(raw, network)
        names = sorted(os.listdir(lat_dir))
        z = load_pickle(os.path.join(lat_dir, "C5_latent_space.pkl"))
        if network in VAE_FAMILY:
            want_names = ["C5_latent_space.pkl", "C5_latent_space_after.pkl"]
            width = NET["num_hiddens"] * 16 * 16
            after = load_pickle(os.path.join(lat_dir, want_names[1]))
            if not np.array_equal(z, after):
                raise AssertionError(f"{network}: the two pickles differ")
        else:
            want_names, width = ["C5_latent_space.pkl"], 128
        if names != want_names or z.shape != (N_PATCHES, width) or \
                z.dtype != np.float32 or not np.isfinite(z).all():
            raise AssertionError(f"{network}: process wrote {names}, "
                                 f"{z.shape} {z.dtype}")

        # card vs CPU: the first 64 patches' latents, and the TF32 control
        cpu = e1_model(network)
        cpu.load_state_dict(load_reference_checkpoint(weights_pt))
        x_raw = data[:E1_ENCODE_CHECK, :, 0]
        if network in VAE_FAMILY:
            z_cpu, _ = encode_patches(cpu, x_raw, E1_ENCODE_CHECK,
                                      normalize="patch", device="cpu")
        else:
            z_cpu = cpu.encode_batched(
                zscore_patch(x_raw).astype(np.float32), "z",
                E1_ENCODE_CHECK)
        limit = E1_ENCODE_ATOL * float(np.abs(z_cpu).max())
        err = float(np.abs(z[:E1_ENCODE_CHECK] - z_cpu).max())
        card_model = copy.deepcopy(cpu).to(dev)
        xz = torch.from_numpy(zscore_patch(x_raw).astype(np.float32)).to(dev)
        z_tf32 = e1_tf32_forward(torch, card_model, xz).reshape(
            E1_ENCODE_CHECK, -1).cpu().numpy()
        ctrl = float(np.abs(z_tf32 - z_cpu).max())
        r.update(process_wall=wall, encode_err=err, encode_limit=limit,
                 encode_tf32=ctrl)
        log(f"run_vae -m process {network}: {wall:.3f} s wall for "
            f"{N_PATCHES} patches, {N_PATCHES / wall:.1f} patches/s end to "
            f"end; wrote {names} ({N_PATCHES}, {width}) float32; latents card"
            f" vs CPU, first {E1_ENCODE_CHECK} patches: max abs {err:.3e} "
            f"(limit {limit:.3e}: {E1_ENCODE_ATOL} of max |z|); TF32 control "
            f"{ctrl:.3e} (the check would "
            f"{'catch' if ctrl > limit else 'miss'} it){tag}")
        if not err <= limit:
            raise AssertionError(f"{network}: latents card vs CPU {err:.3e}")
        if not ctrl > limit:
            raise AssertionError(f"{network}: the TF32 encode control "
                                 f"{ctrl:.3e} is within the limit "
                                 f"{limit:.3e}: the check cannot see TF32")

        # the device-resident encode rate at batch 512
        xb = torch.from_numpy(zscore_patch(data[:BATCH, :, 0])
                              .astype(np.float32)).to(dev)
        enc_ms = time_cuda(torch, lambda: e1_encode(torch, card_model, xb), 10)
        r["resident_patches_s"] = BATCH / enc_ms * 1e3
        log(f"{network} encode, device-resident batch of {BATCH}: "
            f"{enc_ms:.6f} ms, {r['resident_patches_s']:.1f} patches/s"
            + tag)
        # on seeded weights (batch norm off the identity) and on the
        # weights run_training has just written
        r["step_check"] = {
            w: e1_step_vs_cpu(torch, network, m, train_data, dev, tag, w)
            for w, m in (("seeded", e1_seeded_model(torch, network)),
                         ("trained", copy.deepcopy(fresh)))}
        r["timing"] = e1_step_timing(torch, network, fresh.to(dev), dev, tag)
        del model, fresh, cpu, card_model, xb, xz
        torch.cuda.empty_cache()
    # the hard-negative miner, beside the all-triplet steps above: ResNet18
    # on seeded and on PyTorch's default weights, its two maxima and its
    # clamp replayed in float64 with the ReLUs and the max-pool
    torch.manual_seed(SEED + 14)
    hard = {w: e1_step_vs_cpu(torch, "ResNet18", m, train_data, dev, tag,
                              f"{w}, hard-negative miner")
            for w, m in (("seeded", e1_seeded_model(torch, "ResNet18", True)),
                         ("default", e1_model("ResNet18", True)))}
    log(f"phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return runs, hard


# ---------------------------------------------------------------- phase 13
#
# After the latents, on earlier phases' artifacts: the AAE's adversarial
# training on phase 12's training set (z16 widths, batch 768 of
# configs/config_example.yml:101, one epoch of 1,536 patches: 2 steps of 3
# updates, cut from up to 5,000 epochs), the reconstruction eval of phase
# 4's VQ_VAE_z16 on phase 4's well, contrastive PCA on phase 10's plate
# latents (55,296 x 4,096; the first half the target, the second the
# background; auto_alphas, k = 2), and state clustering and trajectory
# dynamics on the plate grouped into trajectories of TRAJ_LEN.

ADV_CHECK = 8               # patches of the card-vs-CPU adversarial step
RECON_SUBSET = 256          # card-vs-CPU subset of the reconstruction eval
RECON_RTOL = 1e-5           # per-sample losses card vs CPU
CPCA_K = 2
# covariances, card float64 vs host float64 (relative Frobenius)
CPCA_COV_RTOL = 1e-10
# an fp32 eigenvector is held (|cos| >= 1 - CPCA_COS_TOL to float64) where
# its float64 eigengap is at least CPCA_GAP_REL of the largest |w|; inside
# a closer cluster any basis is an answer, and its Rayleigh quotient is
# held within CPCA_RAYLEIGH_REL of the largest |w| instead
CPCA_GAP_REL = 1e-3
CPCA_COS_TOL = 1e-4
CPCA_RAYLEIGH_REL = 1e-5
STATE_LEN = 5
STATE_CLUSTERS = 4
MOVE_SCALES = (0.05, 1.0, 8.0)   # px a frame of the synthetic tracks


def adv_stage_grads(torch, model, stage, x, rel, noise, fp32=True,
                    masks=None, replay=False):
    """One adversarial update's train-mode forward and backward (no
    optimizer step): (losses, {weight: gradient as float64 on the host}).
    ``fp32=False`` is the TF32 control (the model's ``fp32_strict`` made a
    no-op, TF32 on); ``masks`` records or replays the kinks."""
    from dynamorph_tpu_torch.core.device import fp32_strict
    from dynamorph_tpu_torch.models import vae
    from dynamorph_tpu_torch.train.adversarial import stage_loss

    saved = vae.fp32_strict
    tf32 = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    if not fp32:
        vae.fp32_strict = contextlib.nullcontext
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with fp32_strict() if fp32 else contextlib.nullcontext(), \
                kink_branches(torch, masks, replay) if masks is not None \
                else contextlib.nullcontext():
            loss, losses = stage_loss(model, stage, x, rel, None, None, noise)
            loss.backward()
    finally:
        vae.fp32_strict = saved
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    grads = {n: p.grad.detach().cpu().double()
             for n, p in model.named_parameters()
             if p.grad is not None and n.endswith(".weight")}
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def adv_step_vs_cpu(torch, base, data, dev, tag):
    """One adversarial step of ``base`` on the card on ADV_CHECK patches,
    the prior samples and dropout masks drawn once on the CPU and fed in.
    Each update is then run again from the parameters the card's step gave
    it, on the CPU in fp32 and in float64 on each fp32 run's side of every
    kink, and held at phase 12's rule, beside a TF32 control that must land
    over it. Also: the discriminator update leaves enc and dec as they were,
    the generator update enc_d."""
    from dynamorph_tpu_torch.train.adversarial import (
        STAGES, make_adversarial_step, make_optimizers)
    from dynamorph_tpu_torch.train.data import zscore

    x = torch.from_numpy(zscore(data[:ADV_CHECK]).astype(np.float32))
    rel = torch.from_numpy(relation_block(ADV_CHECK, 4)).float()
    nh = NET["num_hiddens"]
    g = torch.Generator().manual_seed(SEED + 13)
    noise = {s: {"z_prior": torch.randn(ADV_CHECK, nh, 16, 16, generator=g),
                 "keep": [torch.rand(ADV_CHECK, w, generator=g) < 0.75
                          for w in (8 * nh, nh, 8 * nh, nh)]}
             for s in ("dis", "gen")}
    model = copy.deepcopy(base).to(dev)
    masks, ends, pre, card = [], [], {}, {}

    def on_grads(stage, m):
        ends.append(len(masks))
        pre[stage] = copy.deepcopy(m.state_dict())
        card[stage] = {n: p.grad.detach().cpu().double()
                       for n, p in m.named_parameters()
                       if p.grad is not None and n.endswith(".weight")}

    opts = make_optimizers(model)
    for s, opt in opts.items():     # after each backward, before its update
        opt.register_step_pre_hook(
            lambda _o, _a, _k, s=s: on_grads(s, model))
    step = make_adversarial_step(model, opts, augment=False)
    with kink_branches(torch, masks, False):
        l_card = step(x.to(dev), rel.to(dev), noise={
            s: {"z_prior": v["z_prior"].to(dev),
                "keep": [k.to(dev) for k in v["keep"]]}
            for s, v in noise.items()})
    after = {n: p.detach() for n, p in model.named_parameters()}
    for stage, nxt, fixed in (("dis", pre["gen"], ("enc.", "dec.")),
                              ("gen", after, ("enc_d.",))):
        moved = [n for n, p in pre[stage].items() if n.startswith(fixed)
                 and n in after and not torch.equal(p, nxt[n])]
        if moved:
            raise AssertionError(f"the {stage} update moved {moved[:3]}")

    def rel_l2(a, b):
        return float(torch.norm(a - b) / max(float(torch.norm(b)), 1e-30))

    out = {}
    starts = [0] + ends[:-1]
    for stage, a, b in zip(STAGES, starts, ends):
        m_card = masks[a:b]

        def run(device, dtype, fp32=True, m=None, replay=False):
            mod = copy.deepcopy(base).to(device=device, dtype=dtype)
            mod.load_state_dict(pre[stage])
            nz = None if stage == "recon" else {
                "z_prior": noise[stage]["z_prior"].to(device, dtype),
                "keep": [k.to(device) for k in noise[stage]["keep"]]}
            return adv_stage_grads(torch, mod, stage, x.to(device, dtype),
                                   rel.to(device, dtype), nz, fp32, m, replay)

        m_cpu, m_f64 = [], []
        l_cpu, g_cpu = run("cpu", torch.float32, m=m_cpu)
        run("cpu", torch.float64, m=m_f64)
        _, g_f64 = run("cpu", torch.float64, m=m_card, replay=True)
        _, g_f64c = run("cpu", torch.float64, m=m_cpu, replay=True)
        _, g_ctrl = run(dev, torch.float32, fp32=False)
        # the step returns the recon and discriminator forwards' losses
        # (as the JAX step does); the generator forward is held by its
        # gradients alone
        loss_err = 0.0 if stage == "gen" else max(
            abs(float(l_card[k]) - v) / max(abs(v), 1e-6)
            for k, v in l_cpu.items())
        e_cpu = {n: rel_l2(g_cpu[n], g_f64c[n]) for n in g_f64}

        def ratio(grads):
            r = {n: rel_l2(grads[n], g_f64[n]) / (
                E1_GRAD_VS_CPU * e_cpu[n] + E1_GRAD_FLOOR) for n in g_f64}
            worst = max(r, key=r.get)
            return r[worst], worst

        grad_ratio, worst = ratio(card[stage])
        ctrl_ratio, ctrl_worst = ratio(g_ctrl)
        flips = [sum(int((p != q).sum()) for p, q in zip(m, m_f64))
                 for m in (m_card, m_cpu)]
        log(f"  AAE {stage} update on {ADV_CHECK} patches, card vs CPU from "
            f"the card step's parameters: kink choices against float64's "
            f"own: card {flips[0]}, CPU {flips[1]} of "
            f"{sum(int(m.numel()) for m in m_f64)} flipped; losses "
            f"{loss_err:.3e} relative (rtol {STEP_LOSS_RTOL:g}); gradients "
            f"of {len(g_f64)} weights vs float64: worst {worst} at "
            f"{grad_ratio:.3f} of the limit (card "
            f"{rel_l2(card[stage][worst], g_f64[worst]):.3e}, CPU "
            f"{e_cpu[worst]:.3e}); TF32 control: {ctrl_worst} at "
            f"{ctrl_ratio:.3f} of the limit{tag}")
        if loss_err > STEP_LOSS_RTOL:
            raise AssertionError(f"AAE {stage} update: losses card vs CPU "
                                 f"{loss_err:.3e}")
        if grad_ratio > 1:
            raise AssertionError(f"AAE {stage} update: gradient {worst} at "
                                 f"{grad_ratio:.3f} of its limit")
        if not ctrl_ratio > 1:
            raise AssertionError(f"AAE {stage} update: the TF32 control "
                                 f"lands at {ctrl_ratio:.3f} of the limit: "
                                 "the check cannot see TF32")
        out[stage] = dict(loss_rel=loss_err, grad_ratio=grad_ratio,
                          control=ctrl_ratio, flips_card=flips[0],
                          flips_cpu=flips[1])
    return out


def phase_adversarial(torch, vq, root, dev, tag):
    """train_adversarial on phase 12's training set, process on its
    checkpoint, the step timed, and the step checks."""
    from dynamorph_tpu_torch.cli import run_vae
    from dynamorph_tpu_torch.io.pickles import load_pickle
    from dynamorph_tpu_torch.models.jax_import import (
        load_reference_checkpoint)
    from dynamorph_tpu_torch.train import data as data_utils
    from dynamorph_tpu_torch.train.adversarial import (
        make_adversarial_step, make_optimizers, train_adversarial)

    raw = os.path.join(root, "e1_train_raw")
    dataset = data_utils.zscore(np.squeeze(load_pickle(
        os.path.join(raw, "im_static_patches.pkl")))).astype(np.float32)
    relations, _ = data_utils.concat_relations(
        [load_pickle(os.path.join(raw, "im_static_patches_relations.pkl"))],
        [load_pickle(os.path.join(raw, "im_static_patches_labels.pkl"))],
        offsets=[0])
    dataset, relation_mat, _ = data_utils.reorder_with_trajectories(
        dataset, relations, seed=123)
    torch.manual_seed(SEED + 13)
    model = e1_model("AAE")
    out = os.path.join(root, "adv_out")
    steps = -(-len(dataset) // TRAIN_BATCH)
    bn_zero()
    t0 = time.perf_counter()
    _, hist = train_adversarial(model, dataset, out,
                                relation_mat=relation_mat, n_epochs=1,
                                batch_size=TRAIN_BATCH, transform=True,
                                seed=SEED, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bn = bn_counted()
    if bn[0] < 1 or bn[1]:
        raise AssertionError(f"train_adversarial: batch_norm launches and "
                             f"fallbacks {bn}")
    keys = {"epoch", "recon_loss", "time_matching_loss", "total_loss",
            "perplexity", "generator_loss", "descriminator_loss", "score"}
    if len(hist) != 1 or set(hist[0]) != keys or \
            not all(np.isfinite(v) for v in hist[0].values()):
        raise AssertionError(f"train_adversarial history {hist}")
    ckpt = os.path.join(out, "model_epoch0")
    fresh = e1_model("AAE")
    fresh.load_state_dict(load_reference_checkpoint(
        os.path.join(ckpt, "model.pt")), strict=True)
    log(f"train_adversarial AAE: {wall:.3f} s wall for one epoch of "
        f"{len(dataset)} patches ({steps} steps of 3 updates at batch "
        f"{TRAIN_BATCH}, host batching included); "
        + json.dumps({k: round(v, 6) for k, v in hist[0].items()})
        + f"; batch_norm launches {bn[0]}, fallbacks {bn[1]}"
        + f"; model_epoch0/model.pt loads strict{tag}")

    # process on that checkpoint (loaded strict by run_vae), phase 4's well
    pcfg = os.path.join(root, "adv_process.yml")
    with open(pcfg, "w") as f:
        f.write("latent_encoding:\n"
                f"  raw_dirs: ['{os.path.join(root, 'raw')}']\n"
                f"  supp_dirs: ['{os.path.join(root, 'supp')}']\n"
                f"  weights: ['{ckpt}']\n"
                "  fov: ['C5-Site_0', 'C5-Site_1']\n"
                "  save_output: False\n  network: 'AAE'\n"
                f"  num_hiddens: {NET['num_hiddens']}\n"
                f"  num_residual_hiddens: {NET['num_residual_hiddens']}\n")
    run_vae.main(["-m", "process", "-c", pcfg, "--device", dev.type])
    z = load_pickle(os.path.join(root, "raw", "model_epoch0",
                                 "C5_latent_space.pkl"))
    if z.shape != (N_PATCHES, NET["num_hiddens"] * 256) or \
            not np.isfinite(z).all():
        raise AssertionError(f"process on the AAE checkpoint wrote "
                             f"{z.shape}")
    if vq.vq_lookup.launches or vq.vq_indices.launches:
        raise AssertionError("a VQ kernel launched on the AAE's path")

    # the step at batch 768 on a device-resident batch
    timed = copy.deepcopy(fresh).to(dev)
    x = torch.from_numpy(dataset[:TRAIN_BATCH]).to(dev)
    rel = torch.from_numpy(data_utils.slice_relation_mat(
        relation_mat, np.arange(TRAIN_BATCH))).to(dev)
    step = make_adversarial_step(
        timed, make_optimizers(timed), augment=True,
        generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_cuda(torch, lambda: step(x, rel), 5)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"adversarial step (3 updates), batch {TRAIN_BATCH}, "
        f"device-resident: {step_ms:.6f} ms, "
        f"{TRAIN_BATCH / step_ms * 1e3:.1f} patches/s; peak device memory "
        f"{peak:.3f} GB{tag}")
    prof = profile_steps(torch, lambda: step(x, rel), 2, step_ms,
                         families=E1_FAMILIES, other=E1_OTHER, tag=tag)
    del timed, x, rel, step
    torch.cuda.empty_cache()
    # one step card vs CPU, from the weights train_adversarial wrote
    data = load_pickle(os.path.join(raw, "im_static_patches.pkl"))[:, :, 0]
    checks = adv_step_vs_cpu(torch, fresh, data, dev, tag)
    return dict(wall=wall, hist=hist[0], step_ms=step_ms, peak_gb=peak,
                launches_batch_norm=bn[0],
                idle=None if prof is None else
                max(0.0, 1 - prof["busy_ms"] / step_ms),
                checks=checks)


def phase_recon_eval(torch, vq, root, dev, weights, data, tag):
    """evaluate_recon_losses of phase 4's VQ_VAE_z16 on phase 4's well: the
    whole well on the card (its vq_lookup launches counted), and a subset
    drawn by the function's own seed card vs CPU."""
    from dynamorph_tpu_torch.analysis.recon_eval import (
        evaluate_recon_losses, recon_loss_summary)
    from dynamorph_tpu_torch.models import VQVAEz16
    from dynamorph_tpu_torch.models.jax_import import (
        load_reference_checkpoint)
    from dynamorph_tpu_torch.train.data import zscore_patch

    def load():
        m = VQVAEz16(num_inputs=2, **NET)
        m.load_state_dict(load_reference_checkpoint(
            os.path.join(weights, "model.pt")), strict=True)
        return m

    dataset = zscore_patch(data[:, :, 0]).astype(np.float32)
    card = load()
    vq.vq_lookup.launches = 0
    t0 = time.perf_counter()
    losses = evaluate_recon_losses(card, dataset, n_samples=None, device=dev)
    wall = time.perf_counter() - t0
    launches = vq.vq_lookup.launches
    want = -(-N_PATCHES // 256)
    mean, std = recon_loss_summary(losses)
    log(f"evaluate_recon_losses, VQ_VAE_z16 on the {N_PATCHES}-patch well: "
        f"{wall:.3f} s, mean {mean:.6f} std {std:.6f}; vq_lookup launches "
        f"{launches} (expected {want}){tag}")
    if launches != want or losses.shape != (N_PATCHES,) or \
            not np.isfinite(losses).all():
        raise AssertionError(f"recon eval: {launches} launches, "
                             f"{losses.shape}")

    sub_card = evaluate_recon_losses(card, dataset, n_samples=RECON_SUBSET,
                                     device=dev)
    cpu = load()
    sub_cpu = evaluate_recon_losses(cpu, dataset, n_samples=RECON_SUBSET,
                                    device="cpu")
    # the codes each side took, on the subset the function drew (seed 123)
    idx = np.random.RandomState(123).choice(np.arange(N_PATCHES),
                                            (RECON_SUBSET,), replace=False)
    x = torch.from_numpy(dataset[idx])
    zb_g, _, i_g = card.encode(x.to(dev))
    zb_c, _, i_c = cpu.encode(x)
    i_g = i_g.cpu()
    flipped = (i_g != i_c).flatten(1).any(1)
    if bool(flipped.any()):
        d = NET["num_hiddens"]
        cb = cpu.vq.w.weight.detach()
        pos = torch.nonzero((i_g != i_c).flatten())[:, 0]

        def rows(z):
            return z.permute(0, 2, 3, 1).reshape(-1, d)
        check_flips_vs_latents(torch, "recon eval", rows(zb_c)[pos],
                               rows(zb_g.cpu())[pos],
                               cb[i_c.flatten()[pos]], cb[i_g.flatten()[pos]])
    same = ~flipped.numpy()
    err = float(np.max(np.abs(sub_card - sub_cpu)[same] /
                       np.abs(sub_cpu)[same]))
    log(f"  card vs CPU on {RECON_SUBSET} samples (seed 123): per-sample "
        f"losses within {err:.3e} relative where every code agrees "
        f"(limit {RECON_RTOL:g}); {int(flipped.sum())} samples with a code "
        f"flip, each at a float64 near-tie{tag}")
    if err > RECON_RTOL:
        raise AssertionError(f"recon eval card vs CPU {err:.3e}")
    return dict(wall=wall, launches=launches, mean=mean, std=std,
                subset_rel=err, flipped=int(flipped.sum()))


def cpca_host_eigh(mats):
    """numpy float64 eigh of each matrix (descending), in a thread: LAPACK
    releases the GIL, so the card's work goes on beside it."""
    import concurrent.futures

    def run():
        out = []
        for m in mats:
            w, v = np.linalg.eigh(m)
            out.append((w[::-1], v[:, ::-1]))
        return out

    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run)
    pool.shutdown(wait=False)
    return fut


def phase_cpca(torch, dev, tag):
    """fit_cpca on the plate; the covariances against float64 on the host;
    the float64 eigendecompositions start in a thread."""
    from dynamorph_tpu_torch.reduce.cpca import (auto_alphas, covariances,
                                                  fit_cpca)

    n = PLATE_WELLS * PLATE_PATCHES
    x = plate_latents(torch, dev, n, SEED + 10)
    host = x.cpu().numpy()
    del x
    torch.cuda.empty_cache()
    target, background = host[:n // 2], host[n // 2:]
    alphas = auto_alphas()
    t0 = time.perf_counter()
    fit = fit_cpca(target, background, n_components=CPCA_K, alphas=alphas,
                   device=dev)
    fit_s = time.perf_counter() - t0
    c_t, c_b = (c.cpu().numpy() for c in covariances(target, background,
                                                       dev))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cov_err = []
    for got, a in ((c_t, target), (c_b, background)):
        ac = a.astype(np.float64)
        ac -= ac.mean(axis=0)
        want = (ac.T @ ac) / (len(ac) - 1)
        cov_err.append(float(np.linalg.norm(got - want) /
                             np.linalg.norm(want)))
    host_cov_s = time.perf_counter() - t0
    log(f"fit_cpca on the plate ({n // 2} target x {LATENT_LEN}, {n // 2} "
        f"background, alphas {[round(float(a), 4) for a in alphas]}, k "
        f"{CPCA_K}): {fit_s:.3f} s (two float64 covariances, "
        f"{len(alphas)} float32 eigh of {LATENT_LEN}^2, projections); "
        f"covariances vs float64 on the host: {cov_err[0]:.3e}, "
        f"{cov_err[1]:.3e} relative (limit {CPCA_COV_RTOL:g}; host "
        f"{host_cov_s:.1f} s){tag}")
    if max(cov_err) > CPCA_COV_RTOL:
        raise AssertionError(f"cPCA covariances {cov_err}")
    mats = [c_t - a * c_b for a in alphas]
    return dict(fit=fit, fit_s=fit_s, cov_err=cov_err, mats=mats,
                eigh=cpca_host_eigh(mats), target_mean=target.mean(axis=0))


def check_cpca_components(cp, tag):
    """The fit's fp32 components against the host's float64 eigh."""
    t0 = time.perf_counter()
    ref = cp["eigh"].result()
    wait_s = time.perf_counter() - t0
    held, rayleigh_only, worst_cos, worst_ray = 0, 0, 0.0, 0.0
    for (a, comp, proj), (w, v), m in zip(cp["fit"], ref, cp["mats"]):
        if comp.shape != (CPCA_K, LATENT_LEN) or \
                not np.isfinite(proj).all():
            raise AssertionError(f"cPCA alpha {a}: {comp.shape}")
        scale = float(np.abs(w).max())
        for i in range(CPCA_K):
            c = comp[i].astype(np.float64)
            ray = abs(float(c @ m @ c) - w[i]) / scale
            worst_ray = max(worst_ray, ray)
            if ray > CPCA_RAYLEIGH_REL:
                raise AssertionError(f"cPCA alpha {a} component {i}: "
                                     f"Rayleigh quotient {ray:.3e} off")
            gap = min(w[i - 1] - w[i] if i else np.inf, w[i] - w[i + 1])
            if gap < CPCA_GAP_REL * scale:
                rayleigh_only += 1
                continue
            cos = abs(float(c @ v[:, i]))
            worst_cos = max(worst_cos, 1 - cos)
            if 1 - cos > CPCA_COS_TOL:
                raise AssertionError(f"cPCA alpha {a} component {i}: "
                                     f"|cos| {cos} to float64")
            held += 1
    log(f"  cPCA components vs numpy.linalg.eigh in float64 (host, waited "
        f"{wait_s:.1f} s for it): {held} held by the gap rule (worst 1 - "
        f"|cos| {worst_cos:.3e}, limit {CPCA_COS_TOL:g}), {rayleigh_only} "
        f"inside eigenvalue clusters closer than {CPCA_GAP_REL:g} of max "
        f"|w|, held by their Rayleigh quotient (worst {worst_ray:.3e} of "
        f"max |w|, limit {CPCA_RAYLEIGH_REL:g}){tag}")
    if held < 1:
        raise AssertionError("no cPCA component stood clear of its "
                             "neighbours")
    return dict(held=held, rayleigh_only=rayleigh_only, worst_cos=worst_cos,
                worst_rayleigh=worst_ray, wait_s=wait_s)


def labels_vs_cpu(torch, what, x, card, cpu):
    """k-means labels card vs CPU: equal except at a float64 near-tie of the
    point's two centres (the CPU's)."""
    diff = np.nonzero(card.labels_ != cpu.labels_)[0]
    if len(diff):
        c = torch.from_numpy(cpu.cluster_centers_)
        gap, allowed = tie_gap(torch, torch.from_numpy(x[diff]),
                               c[cpu.labels_[diff]], c[card.labels_[diff]])
        if bool((gap > allowed).any()):
            raise AssertionError(f"{what}: card vs CPU labels differ away "
                                 "from a near-tie")
    return len(diff)


def phase_states(torch, root, dev, cp, data, tag):
    """State clustering and trajectory dynamics on the plate's PCs and on
    synthetic tracks, the k-means card vs CPU; the PC montage of the
    well."""
    from dynamorph_tpu_torch.analysis import (pc_samples, state_clustering,
                                              trajectory_dynamics)
    from dynamorph_tpu_torch.io.pickles import load_pickle

    secs = {}
    comp0 = cp["fit"][0][1]                     # alpha 0: PCA of the target
    n = PLATE_WELLS * PLATE_PATCHES
    x = plate_latents(torch, dev, n, SEED + 10)
    from dynamorph_tpu_torch.core.device import fp32_strict

    with torch.no_grad(), fp32_strict():
        pcs = ((x - torch.from_numpy(cp["target_mean"]).to(dev))
               @ torch.from_numpy(comp0).to(dev).T).double().cpu().numpy()
    del x
    torch.cuda.empty_cache()
    trajs = [list(range(i, i + TRAJ_LEN)) for i in range(0, n, TRAJ_LEN)]
    flips = {}
    for diffs in (False, True):
        key = "diffs" if diffs else "raw"
        t0 = time.perf_counter()
        km, feats, labels = state_clustering.kmeans_on_short_trajs(
            pcs, trajs, length=STATE_LEN, n_clusters=STATE_CLUSTERS,
            diffs=diffs, seed=SEED, device=dev)
        secs[f"kmeans_{key}"] = time.perf_counter() - t0
        km_cpu, _, _ = state_clustering.kmeans_on_short_trajs(
            pcs, trajs, length=STATE_LEN, n_clusters=STATE_CLUSTERS,
            diffs=diffs, seed=SEED, device="cpu")
        flips[key] = labels_vs_cpu(torch, f"kmeans_on_short_trajs {key}",
                                   feats, km, km_cpu)
        log(f"kmeans_on_short_trajs ({key}): {len(feats)} windows x "
            f"{feats.shape[1]}, {STATE_CLUSTERS} clusters, 10 restarts: "
            f"{secs[f'kmeans_{key}']:.3f} s on the card, inertia "
            f"{km.inertia_:.6g} (CPU {km_cpu.inertia_:.6g}), "
            f"{km.n_iter_} iterations; labels card vs CPU differ at "
            f"{flips[key]} windows (float64 near-ties){tag}")

    r = np.random.RandomState(SEED + 13)
    scale = r.choice(MOVE_SCALES, len(trajs))
    pos = np.cumsum(r.randn(len(trajs), TRAJ_LEN, 2) * scale[:, None, None],
                    axis=1) + r.rand(len(trajs), 1, 2) * 2048
    tracks = [{t: p[t] for t in range(TRAJ_LEN)} for p in pos]
    t0 = time.perf_counter()
    states = state_clustering.movement_state_clustering(
        tracks, length=STATE_LEN, n_clusters=len(MOVE_SCALES), seed=SEED,
        device=dev)
    secs["movement"] = time.perf_counter() - t0
    states_cpu = state_clustering.movement_state_clustering(
        tracks, length=STATE_LEN, n_clusters=len(MOVE_SCALES), seed=SEED,
        device="cpu")
    if states != states_cpu:
        raise AssertionError("movement states card vs CPU differ")
    right = sum(int(np.all(scale[v] == MOVE_SCALES[i]))
                for i, v in enumerate(states.values()))
    log(f"movement_state_clustering on {len(tracks)} synthetic tracks of "
        f"{TRAJ_LEN} frames: {secs['movement']:.3f} s; states "
        + json.dumps({k: len(v) for k, v in states.items()})
        + f", equal to the CPU's; {right} of {len(MOVE_SCALES)} states hold "
        f"exactly one drift scale{tag}")

    t0 = time.perf_counter()
    curve = trajectory_dynamics.msd_curve(tracks)
    alpha, diff_c = trajectory_dynamics.fit_msd_powerlaw(curve)
    secs["msd"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats, _ = state_clustering.trajectory_summaries(trajs, tracks, pcs)
    # the conditions: each track's drift scale, as a plate's wells carry
    # their treatment; the movement states' medians start the components
    cond = np.searchsorted(MOVE_SCALES, scale)
    init = np.stack([np.median(feats[v], axis=0) for v in states.values()])
    gmm = state_clustering.well_conditioned_gmm(feats, cond, init)
    secs["gmm"] = time.perf_counter() - t0
    if not (np.isfinite(gmm["posterior"]).all() and
            np.allclose(gmm["posterior"].sum(1), 1.0)):
        raise AssertionError("well_conditioned_gmm posterior")
    agree = float(np.mean(gmm["states"] == cond))
    log(f"msd_curve + fit_msd_powerlaw: {secs['msd']:.3f} s, alpha "
        f"{alpha:.4f}, D {diff_c:.4f} ({len(curve)} lags); "
        f"trajectory_summaries -> well_conditioned_gmm ({len(feats)} x "
        f"{feats.shape[1]}, {len(MOVE_SCALES)} conditions, {len(init)} "
        f"states): {secs['gmm']:.3f} s, states "
        + json.dumps(np.bincount(gmm["states"],
                                 minlength=len(init)).tolist())
        + f", {agree:.4f} of the tracks in their drift scale's state{tag}")

    t0 = time.perf_counter()
    z = load_pickle(os.path.join(root, "raw", "weights",
                                 "C5_latent_space.pkl"))
    pc1 = (z - cp["target_mean"]) @ comp0[0].astype(np.float64)
    patches = data[:, :, 0] / float(data.max())
    out = os.path.join(root, "pc_montage")
    pc_samples.pc_sample_montage(patches, pc1, out, pc_name="PC1")
    secs["montage"] = time.perf_counter() - t0
    names = sorted(os.listdir(out))
    sizes = {png_size(os.path.join(out, f))[:3] for f in names}
    if len(names) != 10 or sizes != {(128, 128, 16), (640, 512, 16)}:
        raise AssertionError(f"pc_sample_montage wrote {names} {sizes}")
    log(f"pc_sample_montage on the well's {len(patches)} patches along PC1: "
        f"{secs['montage']:.3f} s, {len(names)} 16-bit PNGs{tag}")
    return dict(secs=secs, flips=flips, states={k: len(v) for k, v in
                                                 states.items()},
                msd_alpha=alpha, gmm_agree=agree)


def phase_after_latents(torch, vq, root, dev, card, well):
    phase("13. after the latents: train_adversarial (AAE, batch 768), "
          "evaluate_recon_losses (VQ_VAE_z16), fit_cpca on the plate, "
          "state clustering and dynamics, on cuda")
    tag = f" [{card}]"
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    vq.vq_lookup.launches = vq.vq_indices.launches = 0
    parts = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t0
        return out

    cp = timed("cpca", phase_cpca, torch, dev, tag)
    adv = timed("adversarial", phase_adversarial, torch, vq, root, dev, tag)
    recon = timed("recon_eval", phase_recon_eval, torch, vq, root, dev,
                  well["weights"], well["data"], tag)
    states = timed("states", phase_states, torch, root, dev, cp,
                   well["data"], tag)
    comps = timed("cpca_check", check_cpca_components, cp, tag)
    if vq.vq_indices.launches:
        raise AssertionError("vq_indices launched after the latents")
    secs = time.perf_counter() - t_phase
    log(f"phase 13 took {secs:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items())
        + " (the host's float64 eigh runs in a thread from the cPCA part "
        "to the check)")
    return dict(adv=adv, recon=recon, cpca=dict(
        fit_s=cp["fit_s"], cov_err=cp["cov_err"], **comps), states=states,
        launches={"vq_lookup": recon["launches"],
                  "vq_indices": vq.vq_indices.launches}, secs=secs)


# phase 14: U-Net training and the cv2-free geometry
U_FRAME = 2048              # sampler stack and extraction site, px
U_SAMPLER_T = 4             # frames of the sampler's stack
U_PATCHES = 64              # patches the sampler draws (56 train + 8 val)
U_VALID = 8
U_BATCH = 8
U_EPOCHS = 2
U_STEP_SIZE = 128           # px of the card-vs-CPU step check (batch 2)
U_STEP_DRAWS = 3            # its steps, each on its own seeded batch
U_MS_FEAT = 8               # SegmentWithMultipleSlice's unet_feat
U_CELLS = 200               # elliptical cells of the extraction site
U_CPU_CELLS = 40            # of them, extracted on the CPU to compare
U_VAL_SIZE = (1108, 1108)   # segmentation_validation_contours' output
U_METRIC_TOL = 1e-12        # ROC-AUC / F1, card vs CPU vs float64 ranks


def unet_step_grads(torch, model, x, y, fp32=True, masks=None,
                    replay=False):
    """One train-mode forward and backward of a U-Net on the weighted
    cross-entropy (``Segment._make_step`` without Adam): (loss, {weight:
    gradient as float64 on the host}). ``fp32=False`` is the TF32 control
    (forward and backward with PyTorch's TF32 defaults); ``masks`` records
    (or with ``replay`` replays) the choice at every ReLU and the stem's
    max-pool (``kink_branches``)."""
    from dynamorph_tpu_torch.core.device import fp32_strict
    from dynamorph_tpu_torch.models.unet import weighted_ce_loss

    tf32 = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    if not fp32:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with fp32_strict() if fp32 else contextlib.nullcontext(), \
                kink_branches(torch, masks, replay) if masks is not None \
                else contextlib.nullcontext():
            loss = weighted_ce_loss(model.apply(x, train=True), y)
            loss.backward()
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    grads = {n: p.grad.detach().cpu().double()
             for n, p in model.named_parameters()
             if p.grad is not None and n.endswith(".weight")}
    return float(loss.detach()), grads


def unet_sampler_stack(rng):
    """(T, 2, 1, 2048, 2048) uint16 frames with planted bright ellipses
    and their (T, 3, 1, 2048, 2048) float32 three-class probabilities."""
    t_len, size = U_SAMPLER_T, U_FRAME
    raw = rng.randint(20000, 30000, (t_len, 2, 1, size, size)) \
        .astype(np.uint16)
    prob = np.empty((t_len, 3, 1, size, size), np.float32)
    yy, xx = np.ogrid[:size, :size]
    for t in range(t_len):
        fg = np.zeros((size, size), bool)
        mg = np.zeros((size, size), bool)
        for i, (cy, cx) in enumerate(rng.randint(64, size - 64, (60, 2))):
            m = ((yy - cy) / rng.uniform(12, 30)) ** 2 + \
                ((xx - cx) / rng.uniform(12, 30)) ** 2 < 1
            fg |= m
            if i % 3 == 0:
                mg |= m
        raw[t, 0, 0][fg] += 12000
        prob[t, 0, 0] = np.where(fg, 0.05, 0.95)
        prob[t, 2, 0] = np.where(mg, 0.85, 0.02)
        prob[t, 1, 0] = 1 - prob[t, 0, 0] - prob[t, 2, 0]
    return raw, prob


def f64_roc_auc(truth, score):
    """ROC-AUC in float64 from average ranks (numpy, on the host)."""
    order = np.argsort(score, kind="mergesort")
    s = score[order]
    _, first, counts = np.unique(s, return_index=True, return_counts=True)
    avg = first + (counts + 1) / 2.0
    ranks = np.repeat(avg, counts)
    t = truth[order]
    n_pos = float(t.sum())
    n_neg = float(t.size) - n_pos
    return (ranks[t].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def unet_train_part(torch, dev, root, tag):
    """Sampler, fit at batch 8 on the card, the step's time, idle share,
    families and peak memory, and the validation metrics card vs CPU vs
    float64."""
    from dynamorph_tpu_torch.seg.data import generate_patches
    from dynamorph_tpu_torch.seg.metrics import f1_score, roc_auc_score
    from dynamorph_tpu_torch.seg.model import Segment

    rng = np.random.RandomState(SEED + 14)
    raw, prob = unet_sampler_stack(rng)
    t0 = time.perf_counter()
    patches = generate_patches(raw, prob, n_patches=U_PATCHES,
                               x_size=SEG_WINDOW, y_size=SEG_WINDOW,
                               rotate=True, mirror=True, seed=0)
    sampler_s = time.perf_counter() - t0
    assert len(patches) == U_PATCHES
    for x, y in patches:
        assert x.shape == (2, 1, SEG_WINDOW, SEG_WINDOW) and \
            y.shape == (3, 1, SEG_WINDOW, SEG_WINDOW)
        assert np.isfinite(x).all() and 0 <= x.min() and x.max() <= 65535
    log(f"sampler: {U_PATCHES} rotated, mirrored {SEG_WINDOW}^2 patches "
        f"from {U_SAMPLER_T} frames of 2 x {U_FRAME}^2 uint16 in "
        f"{sampler_s:.3f} s on the host ({U_PATCHES / sampler_s:.1f} "
        f"patches/s)")
    del raw, prob

    model_dir = os.path.join(root, "unet_fit")
    model = Segment(input_shape=(2, SEG_WINDOW, SEG_WINDOW), n_classes=3,
                    model_path=model_dir, seed=SEED + 14, device=dev)
    train, valid = patches[:-U_VALID], patches[-U_VALID:]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = model.fit(train, batch_size=U_BATCH, n_epochs=U_EPOCHS,
                     valid_patches=valid)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_peak = torch.cuda.max_memory_allocated() / 1e9
    assert len(hist) == U_EPOCHS and all(
        np.isfinite([h["loss"], h["val_loss"]]).all() for h in hist)
    names = sorted(os.listdir(model_dir))
    assert names == ["weights.%02d-%.2f" % (h["epoch"], h["val_loss"])
                     for h in hist], names
    model.save(os.path.join(root, "unet_trained"))
    log(f"fit: {len(train)} patches, batch {U_BATCH}, {U_EPOCHS} epochs "
        f"(+{U_VALID} validation patches): {fit_s:.3f} s, history "
        + "; ".join(f"epoch {h['epoch']} loss {h['loss']:.6f} val_loss "
                    f"{h['val_loss']:.6f} roc_auc {h['val_roc_auc']:.6f} "
                    f"f1 {h['val_f1']:.6f}" for h in hist)
        + f"; peak device memory {fit_peak:.3f} GB{tag}")

    # the step on a device-resident batch of 8
    X, y = model._arrays(train[:U_BATCH], "prob")
    xb, yb = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    _, step = model._make_step(1e-3)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_cuda(torch, lambda: step(xb, yb), 10)
    peak = torch.cuda.max_memory_allocated() / 1e9
    flops = 3 * conv_flops(torch, model, xb)
    log(f"U-Net train step, batch {U_BATCH}, {SEG_WINDOW}^2, fp32 (no "
        f"TF32), device-resident: {step_ms:.6f} ms, "
        f"{U_BATCH / step_ms * 1e3:.1f} patches/s, "
        f"{flops / (step_ms / 1e3) / FP32_FLOP_PER_S:.4f} of the fp32 rate "
        f"(convolutions x 3); peak device memory {peak:.3f} GB{tag}")
    prof = profile_steps(torch, lambda: step(xb, yb), 2, step_ms,
                         families=E1_FAMILIES, other=SEG_OTHER, tag=tag)

    # validation metrics: card against the port's CPU metrics on the same
    # logits, and against float64 ranks on the host
    Xv, yv = model._arrays(valid, "prob")
    with torch.no_grad():
        logits = model.net.apply(torch.from_numpy(Xv).to(dev),
                                 train=False)[:, 0]
    truth = torch.from_numpy(yv[:, 0] > 0.5)
    auc_card = roc_auc_score(truth.to(dev), logits)
    f1_card = f1_score(truth.to(dev), logits > 0.5)
    auc_cpu = roc_auc_score(truth, logits.cpu())
    f1_cpu = f1_score(truth, logits.cpu() > 0.5)
    auc_f64 = f64_roc_auc(truth.numpy().reshape(-1),
                          logits.cpu().numpy().reshape(-1))
    d = max(abs(auc_card - auc_cpu), abs(auc_card - auc_f64),
            abs(f1_card - f1_cpu))
    log(f"validation metrics on {U_VALID} x {SEG_WINDOW}^2 logits: ROC-AUC "
        f"card {auc_card:.12f}, CPU {auc_cpu:.12f}, float64 ranks "
        f"{auc_f64:.12f}; F1 card {f1_card:.12f}, CPU {f1_cpu:.12f}; "
        f"worst difference {d:.3e} (limit {U_METRIC_TOL:g}){tag}")
    if d > U_METRIC_TOL:
        raise AssertionError(f"validation metrics differ by {d:.3e}")
    return dict(sampler_s=sampler_s, fit_s=fit_s, fit_peak_gb=fit_peak,
                step_ms=step_ms, step_peak_gb=peak, profile=prof,
                history=hist, auc=auc_card, f1=f1_card, metric_diff=d,
                weights=os.path.join(root, "unet_trained"))


def unet_step_errors(torch, dev, base, x, y):
    """One step of the U-Net step check on the batch (x, y): the card's and
    the CPU's fp32 step, each with float64 replaying its own ReLU and
    max-pool choices. Returns the losses, the flips of each side against
    float64's own choices, and per weight the squared error and squared
    norm of the float64 gradient (card, then CPU), and the card side's
    float64 gradients."""
    def run(device, dtype, masks=None, replay=False):
        net = copy.deepcopy(base.net).to(device=device, dtype=dtype)
        return unet_step_grads(torch, net, x.to(device, dtype),
                               y.to(device, dtype), True, masks, replay)

    m_gpu, m_cpu, m_f64 = [], [], []
    l_gpu, g_gpu = run(dev, torch.float32, masks=m_gpu)
    l_cpu, g_cpu = run("cpu", torch.float32, masks=m_cpu)
    run("cpu", torch.float64, masks=m_f64)
    _, g_f64 = run("cpu", torch.float64, masks=m_gpu, replay=True)
    _, g_f64c = run("cpu", torch.float64, masks=m_cpu, replay=True)
    flips = [sum(int((a != b).sum()) for a, b in zip(m, m_f64))
             for m in (m_gpu, m_cpu)]
    sq = [{n: (float(torch.sum((g[n] - ref[n]) ** 2)),
               float(torch.sum(ref[n] ** 2))) for n in g_f64}
          for g, ref in ((g_gpu, g_f64), (g_cpu, g_f64c))]
    return dict(loss=(l_gpu, l_cpu), flips=flips, sq=sq, ref=g_f64)


def unet_step_vs_cpu(torch, dev, weights, tag):
    """Fit steps at batch 2 on the trained weights, card against CPU,
    each held against float64 on its own side of every ReLU and the
    max-pool (phase 12's rule: card error <= 3 x CPU error + 1e-5 per
    weight, relative L2), and a TF32 control that must land over it.

    The rule's two errors are each taken over U_STEP_DRAWS steps, each on
    its own seeded batch (the first is the batch one step alone took): a
    weight's error is the relative L2 of its gradients stacked over the
    steps. On trained U-Net weights one step's fp32 error comes from few
    rounding events, and the card's fp32 activations err up to several
    times as much as the CPU's in layer4 and the first decoder block, so
    one step alone can land over the limit with no TF32 anywhere
    (``tools/unet_step_draws.py`` counts how often, and with ``--layers``
    shows where)."""
    from dynamorph_tpu_torch.seg.model import Segment

    base = Segment(input_shape=(2, U_STEP_SIZE, U_STEP_SIZE),
                   device="cpu")
    base.load(weights)
    r = np.random.RandomState(SEED + 15)
    batches = []
    for _ in range(U_STEP_DRAWS):
        x = r.rand(2, 2, U_STEP_SIZE, U_STEP_SIZE).astype(np.float32)
        lab = r.rand(2, 3, U_STEP_SIZE, U_STEP_SIZE) ** 3
        lab /= lab.sum(1, keepdims=True)
        batches.append((torch.from_numpy(x), torch.from_numpy(
            np.concatenate([lab, np.ones((2, 1, U_STEP_SIZE, U_STEP_SIZE))],
                           1).astype(np.float32))))
    draws = [unet_step_errors(torch, dev, base, x, y) for x, y in batches]
    x, y = batches[0]
    _, g_ctrl = unet_step_grads(torch, copy.deepcopy(base.net).to(dev),
                                x.to(dev), y.to(dev), False)

    def pooled(side, ds):
        return {n: (sum(d["sq"][side][n][0] for d in ds) / max(
            sum(d["sq"][side][n][1] for d in ds), 1e-300)) ** 0.5
            for n in ds[0]["sq"][side]}

    def ratio(err, e_cpu):
        r_ = {n: err[n] / (E1_GRAD_VS_CPU * e_cpu[n] + E1_GRAD_FLOOR)
              for n in err}
        worst = max(r_, key=r_.get)
        return r_[worst], worst

    e_gpu, e_cpu = pooled(0, draws), pooled(1, draws)
    ref = draws[0]["ref"]
    e_ctrl = {n: float(torch.norm(g_ctrl[n] - ref[n]) / max(
        float(torch.norm(ref[n])), 1e-30)) for n in ref}
    flips = [sum(d["flips"][i] for d in draws) for i in (0, 1)]
    loss_rel = max(abs(d["loss"][0] - d["loss"][1]) / abs(d["loss"][1])
                   for d in draws)
    grad_ratio, worst = ratio(e_gpu, e_cpu)
    ctrl_ratio, ctrl_worst = ratio(e_ctrl, e_cpu)
    first, first_worst = ratio(pooled(0, draws[:1]), pooled(1, draws[:1]))
    log(f"U-Net fit step, batch 2 of {U_STEP_SIZE}^2, trained weights, "
        f"{U_STEP_DRAWS} seeded batches, card vs CPU: ReLU and "
        f"max-pool choices against float64's own: card {flips[0]}, CPU "
        f"{flips[1]} flipped (replayed below); loss {loss_rel:.3e} relative "
        f"(rtol {STEP_LOSS_RTOL:g}); gradients vs float64 over the steps: "
        f"worst {worst} at {grad_ratio:.3f} of the limit (card error <= "
        f"{E1_GRAD_VS_CPU:g} x CPU error + {E1_GRAD_FLOOR:g}, relative L2: "
        f"card {e_gpu[worst]:.3e}, CPU {e_cpu[worst]:.3e}); the first step "
        f"alone: worst {first_worst} at {first:.3f}; TF32 control: "
        f"{ctrl_worst} at "
        f"{ctrl_ratio:.3f} of the limit{tag}")
    if loss_rel > STEP_LOSS_RTOL:
        raise AssertionError(f"U-Net step loss {loss_rel:.3e} relative")
    if grad_ratio > 1:
        raise AssertionError(f"U-Net gradient {worst} at {grad_ratio:.3f} "
                             "of its limit")
    if not ctrl_ratio > 1:
        raise AssertionError(f"the U-Net TF32 control step lands at "
                             f"{ctrl_ratio:.3f} of the limit: the check "
                             "cannot see TF32")
    return dict(loss_rel=loss_rel, grad_ratio=grad_ratio,
                control=ctrl_ratio, flips=flips,
                first_step=first)


def unet_multislice(torch, dev, tag):
    """SegmentWithMultipleSlice((2, 3, 256, 256)) card vs CPU on 2
    samples, and one frame of predict_whole_map(time_slices=3) on the
    card (3 frames of 2 x 512 x 512)."""
    from dynamorph_tpu_torch.seg.inference import predict_whole_map
    from dynamorph_tpu_torch.seg.model import SegmentWithMultipleSlice

    kw = dict(unet_feat=U_MS_FEAT, input_shape=(2, 3, SEG_WINDOW,
                                                SEG_WINDOW), seed=SEED + 16)
    cpu = SegmentWithMultipleSlice(device="cpu", **kw)
    card = SegmentWithMultipleSlice(device=dev, **kw)
    card.net.load_state_dict(cpu.net.state_dict(), strict=True)
    r = np.random.RandomState(SEED + 16)
    x = (r.rand(2, 2, 3, SEG_WINDOW, SEG_WINDOW) * 65535).astype(np.float32)
    pc, pg = cpu.predict_raw(x), card.predict_raw(x)
    err = float(np.abs(pg - pc).max())
    stack = (r.rand(3, 2, 1, 2 * SEG_WINDOW, 2 * SEG_WINDOW) * 65535)
    t0 = time.perf_counter()
    frames = predict_whole_map(stack, card, n_supp=1, time_slices=3,
                               rng=np.random.RandomState(0))
    wm_s = time.perf_counter() - t0
    assert frames.shape == (1, 3, 1, 2 * SEG_WINDOW, 2 * SEG_WINDOW)
    assert np.isfinite(frames).all() and not (frames == -1).any()
    sums = float(np.abs(frames.sum(1) - 1).max())
    log(f"SegmentWithMultipleSlice (2 channels x 3 slices, unet_feat "
        f"{U_MS_FEAT}): 2 samples card vs CPU max |d prob| {err:.3e} "
        f"(limit {SEG_PROB_ATOL:g}); predict_whole_map(time_slices=3) of "
        f"3 frames of {2 * SEG_WINDOW}^2 -> 1 frame on the card in "
        f"{wm_s:.3f} s, class sums within {sums:.1e} of 1{tag}")
    if err > SEG_PROB_ATOL or sums > SEG_SUM_ATOL:
        raise AssertionError(f"multi-slice: card vs CPU {err:.3e}, sums "
                             f"{sums:.3e}")
    return dict(err=err, whole_map_s=wm_s)


def unet_extraction_site(rng, root):
    """A 2048 x 2048 site of one frame, 2 channels: U_CELLS ellipses (axes
    10-26 px, seeded angles; overlaps keep the first label), its
    probabilities and instance pickles; returns (supp dirs, paths)."""
    from dynamorph_tpu_torch.io.pickles import save_pickle

    size = U_FRAME
    img = rng.rand(1, 2, 1, size, size) * 1000 + 30000
    labels = np.full((size, size), -1, np.int32)
    centres = rng.randint(30, size - 30, (U_CELLS, 2))
    for cid, (cy, cx) in enumerate(centres):
        y0, x0 = max(cy - 30, 0), max(cx - 30, 0)
        yy, xx = np.mgrid[y0:cy + 30, x0:cx + 30]
        t = rng.rand() * np.pi
        a, b = rng.uniform(14, 26), rng.uniform(8, 14)
        u = (yy - cy) * np.cos(t) + (xx - cx) * np.sin(t)
        v = -(yy - cy) * np.sin(t) + (xx - cx) * np.cos(t)
        m = ((u / a) ** 2 + (v / b) ** 2 < 1) & (labels[y0:cy + 30,
                                                        x0:cx + 30] < 0)
        labels[y0:cy + 30, x0:cx + 30][m] = cid
    fg = labels >= 0
    img[0, 0, 0][fg] += 10000
    bg = np.where(fg, 0.05, 0.97)
    seg = np.stack([bg, np.where(fg, 0.9, 0.02),
                    1 - bg - np.where(fg, 0.9, 0.02)])[None, :, None]
    raw_path = os.path.join(root, "axis_site.npy")
    seg_path = os.path.join(root, "axis_site_NNProbabilities.npy")
    np.save(raw_path, img)
    np.save(seg_path, seg)
    pix = np.argwhere(fg)
    kept = [c for c in range(U_CELLS) if (labels == c).any()]
    positions = [(np.int32(c), centres[c]) for c in kept]
    assignments = {0: (pix, labels[fg])}
    dirs = {}
    # the card extracts every cell; the warm-up and the CPU the first
    # U_CPU_CELLS (each cell's patch reads its own window alone)
    for side, cells in (("card", positions),
                        ("warm", positions[:U_CPU_CELLS]),
                        ("cpu", positions[:U_CPU_CELLS])):
        d = os.path.join(root, f"axis_{side}")
        os.makedirs(d, exist_ok=True)
        save_pickle({0: cells}, os.path.join(d, "cell_positions.pkl"))
        save_pickle(assignments, os.path.join(d,
                                              "cell_pixel_assignments.pkl"))
        dirs[side] = d
    return dirs, raw_path, seg_path, len(kept), img, labels


def unet_geometry_part(torch, dev, root, tag):
    """The long-axis extraction card vs CPU (cells/s), warp_affine card vs
    CPU at four dtypes with the warps' share of the extraction, and the
    host outputs (validation contours, TIFF, trajectory GIF)."""
    from dynamorph_tpu_torch.io.pickles import load_pickle
    from dynamorph_tpu_torch.io.png import write_png
    from dynamorph_tpu_torch.ops.geometry import rotation_matrix_2d, \
        warp_affine
    from dynamorph_tpu_torch.pipeline.patch import \
        process_site_extract_patches_align_axis
    from dynamorph_tpu_torch.pipeline.segmentation import (
        segmentation_validation_contours, validation_pngs_to_tiff)
    from dynamorph_tpu_torch.track.visualize import save_traj_bbox

    rng = np.random.RandomState(SEED + 17)
    dirs, raw_path, seg_path, n_cells, img, labels = \
        unet_extraction_site(rng, root)
    # a warm-up call on the card, then the timed one
    process_site_extract_patches_align_axis(
        raw_path, seg_path, dirs["warm"], window_size=SEG_WINDOW, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    process_site_extract_patches_align_axis(
        raw_path, seg_path, dirs["card"], window_size=SEG_WINDOW, device=dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    process_site_extract_patches_align_axis(
        raw_path, seg_path, dirs["cpu"], window_size=SEG_WINDOW,
        device="cpu")
    cpu_s = time.perf_counter() - t0
    got = load_pickle(os.path.join(dirs["card"], "stacks_rotated_0.pkl"))
    want = load_pickle(os.path.join(dirs["cpu"], "stacks_rotated_0.pkl"))
    assert len(got) == n_cells and len(want) == U_CPU_CELLS
    got = {os.path.basename(k): v for k, v in got.items()}
    mask_diff = win_diff = 0
    for kw in want:
        for field in ("mat", "masked_mat"):
            a, b = got[os.path.basename(kw)][field], want[kw][field]
            assert a.shape == (4, 1, SEG_WINDOW, SEG_WINDOW)
            mask_diff += int((a[2:] != b[2:]).sum())
            win_diff += int((a[:2] != b[:2]).sum())
    log(f"long-axis extraction of a {U_FRAME}^2 site, {n_cells} cells "
        f"(enlarged window {int(np.ceil(SEG_WINDOW * np.sqrt(2)) + 1)}): "
        f"card {card_s:.3f} s ({n_cells / card_s:.1f} cells/s), CPU "
        f"{cpu_s:.3f} s for {U_CPU_CELLS} ({U_CPU_CELLS / cpu_s:.1f} "
        f"cells/s); card vs CPU on those: "
        f"{mask_diff} mask pixels and {win_diff} uint16 window pixels "
        f"differ{tag}")
    if mask_diff or win_diff:
        raise AssertionError(f"long-axis extraction card vs CPU: masks "
                             f"{mask_diff}, windows {win_diff} differ")

    # the batched warp at four dtypes, card vs CPU, and its cost at the
    # extraction's shapes against the extraction around it
    w = int(np.ceil(SEG_WINDOW * np.sqrt(2)) + 1)
    n = n_cells
    Ms = np.stack([rotation_matrix_2d((w / 2, w / 2), a, 1)
                   for a in rng.uniform(-90, 0, n)])
    warp_err = {}
    k = min(32, n)
    for dt, cn in ((torch.float64, 2), (torch.float32, 2),
                   (torch.float32, 1), (torch.uint16, 2), (torch.uint16, 1),
                   (torch.uint8, 1)):
        src = torch.from_numpy(rng.rand(k, w, w, cn) * 250).to(dt)
        a = warp_affine(src.to(dev), Ms[:k], (w, w)).cpu()
        b = warp_affine(src, Ms[:k], (w, w))
        warp_err[f"{str(dt).split('.')[-1]} x{cn}"] = int((a != b).sum())
    masks = torch.zeros((2 * n, w, w, 1), dtype=torch.uint8, device=dev)
    wins = torch.zeros((2 * n, w, w, 2), dtype=torch.uint16, device=dev)
    M2 = np.concatenate([Ms, Ms])
    warp_ms = time_cuda(torch, lambda: warp_affine([masks, wins], M2,
                                                   (w, w)), 3)
    log(f"warp_affine card vs CPU ({k} images of {w}^2, both arithmetics):"
        f" differing values "
        + ", ".join(f"{k} {v}" for k, v in warp_err.items())
        + f"; the extraction's batched warp ({2 * n} uint8 masks + {2 * n} "
        f"2-channel uint16 windows) {warp_ms:.3f} ms on the card, "
        f"{warp_ms / 1e3 / card_s:.4f} of the site's extraction{tag}")
    if any(warp_err.values()):
        raise AssertionError(f"warp_affine card vs CPU: {warp_err}")
    del masks, wins

    # host outputs: the validation overlays at 1108^2, their TIFF, a GIF
    from dynamorph_tpu_torch.io.sites import site_supp_folder

    raw_dir = os.path.join(root, "val_raw")
    supp_dir = os.path.join(root, "val_supp")
    os.makedirs(raw_dir, exist_ok=True)
    site = "B5-Site_0"
    stack = np.concatenate([img, img[:, ::-1]]).astype(np.float64)
    np.save(os.path.join(raw_dir, f"{site}.npy"), stack)
    seg_dir = site_supp_folder(supp_dir, site)
    os.makedirs(seg_dir, exist_ok=True)
    colors = rng.randint(40, 256, (U_CELLS + 1, 3)).astype(np.uint8)
    colors[0] = 0
    for t in range(2):
        write_png(os.path.join(seg_dir, f"segmentation_{t}.png"),
                  colors[labels + 1])
    val_dir = os.path.join(root, "val_out")
    t0 = time.perf_counter()
    segmentation_validation_contours(raw_dir, supp_dir, val_dir, [site],
                                     out_size=U_VAL_SIZE)
    contours_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tif = validation_pngs_to_tiff(val_dir, site)
    tiff_s = time.perf_counter() - t0
    assert os.path.getsize(tif) > 2 * U_VAL_SIZE[0] * U_VAL_SIZE[1] * 6
    gif = os.path.join(root, "traj.gif")
    frames = np.moveaxis(stack[:, :, 0], 1, -1).astype(np.uint16)
    t0 = time.perf_counter()
    save_traj_bbox({0: 1, 1: 1}, {0: np.array([700, 900]),
                                  1: np.array([720, 910])}, frames, gif)
    gif_s = time.perf_counter() - t0
    log(f"host outputs: segmentation_validation_contours (2 frames of "
        f"{U_FRAME}^2 -> {U_VAL_SIZE[0]}^2 overlays) {contours_s:.3f} s, "
        f"validation_pngs_to_tiff {tiff_s:.3f} s, save_traj_bbox (2 frames"
        f" -> 512^2 GIF) {gif_s:.3f} s")
    return dict(n_cells=n_cells, card_s=card_s,
                cpu_cells_per_s=U_CPU_CELLS / cpu_s,
                cells_per_s=n_cells / card_s, warp_ms=warp_ms,
                warp_share=warp_ms / 1e3 / card_s, contours_s=contours_s,
                tiff_s=tiff_s, gif_s=gif_s)


def phase_unet_geometry(torch, vq, root, dev, card):
    phase("14. U-Net training and geometry: generate_patches, Segment.fit "
          "(batch 8, 256^2), the step card vs CPU, SegmentWithMultipleSlice,"
          " the long-axis extraction, warp_affine, validation contours and "
          "GIFs, on cuda")
    tag = f" [{card}]"
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    vq.vq_lookup.launches = vq.vq_indices.launches = 0
    parts = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t0
        return out

    train = timed("training", unet_train_part, torch, dev, root, tag)
    step = timed("step_check", unet_step_vs_cpu, torch, dev,
                 train["weights"], tag)
    multi = timed("multislice", unet_multislice, torch, dev, tag)
    geo = timed("geometry", unet_geometry_part, torch, dev, root, tag)
    launches = {"vq_lookup": vq.vq_lookup.launches,
                "vq_indices": vq.vq_indices.launches}
    if any(launches.values()):
        raise AssertionError(f"a VQ kernel launched on the U-Net path: "
                             f"{launches}")
    secs = time.perf_counter() - t_phase
    log(f"phase 14 took {secs:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    return dict(train=train, step=step, multi=multi, geo=geo, secs=secs,
                launches=launches)


# ---------------------------------------------------------------- phase 15
#
# The card's machine has no h5py, so the phase writes its Keras weight files
# itself: the HDF5 subset that h5py writes by default (superblock 0, version-1
# object headers, symbol-table groups with their B-tree, symbol node and local
# heap, contiguous datasets) and the string attributes a Keras file carries
# (``layer_names``, ``weight_names``).

H5_UNDEF = (1 << 64) - 1
H5_GROUP_INTERNAL_K = 16    # h5py's default; a group B-tree node's size
H5_FLOATS = {4: (31, 23, 8, 23, 127), 8: (63, 52, 11, 52, 1023)}


def _h5_pad(b: bytes) -> bytes:
    return bytes(b) + b"\0" * (-len(b) % 8)


def _h5_message(mtype: int, body: bytes) -> bytes:
    body = _h5_pad(body)
    return struct.pack("<HHB3x", mtype, len(body), 0) + body


def _h5_dataspace(shape) -> bytes:
    return struct.pack("<BBB5x", 1, len(shape), 1) + struct.pack(
        f"<{2 * len(shape)}Q", *shape, *shape)


def _h5_datatype(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind == "f":
        sign, e_loc, e_size, m_size, bias = H5_FLOATS[size]
        return struct.pack("<4BIHH4BI", 0x11, 0x20, sign, 0, size, 0,
                           8 * size, e_loc, e_size, 0, m_size, bias)
    if dtype.kind in "iu":
        return struct.pack("<4BIHH", 0x10, 8 if dtype.kind == "i" else 0, 0,
                           0, size, 0, 8 * size)
    if dtype.kind == "S":                     # fixed length, null padded
        return struct.pack("<4BI", 0x13, 1, 0, 0, size)
    raise TypeError(f"no HDF5 datatype for {dtype}")


def _h5_attribute(name: str, arr: np.ndarray) -> bytes:
    nm, dt, ds = name.encode() + b"\0", _h5_datatype(arr.dtype), \
        _h5_dataspace(arr.shape)
    return _h5_message(12, struct.pack("<BxHHH", 1, len(nm), len(dt), len(ds))
                       + _h5_pad(nm) + _h5_pad(dt) + _h5_pad(ds)
                       + arr.tobytes())


def _h5_object_header(messages) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BxHII4x", 1, len(messages), 1, len(body)) + body


def write_h5(path: str, tree: dict, attrs: dict = None) -> None:
    """Write ``tree`` ({name: sub-dict (a group) or array (a dataset)}) as an
    HDF5 file that h5py and ``dynamorph_tpu_torch.io.hdf5`` read; ``attrs``
    maps a group's path ("" for the root) to {name: array} attributes
    (numeric or fixed-length byte strings). Datasets are little-endian and
    contiguous."""
    attrs = attrs or {}
    chunks, size = [b"\0" * 96], 96         # the superblock, written last

    def put(b) -> int:
        nonlocal size
        addr = size
        b = memoryview(b).cast("B")
        chunks.append(b)
        size += len(b)
        if len(b) % 8:
            chunks.append(b"\0" * (-len(b) % 8))
            size += -len(b) % 8
        return addr

    def max_members(t):
        return max([len(t)] + [max_members(v) for v in t.values()
                               if isinstance(v, dict)])

    leaf_k = max(4, -(-max_members(tree) // 2))

    def dataset(arr) -> int:
        arr = np.ascontiguousarray(arr)
        arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
        data = put(arr) if arr.size else H5_UNDEF
        layout = struct.pack("<BBQQ", 3, 1, data, arr.nbytes)
        return put(_h5_object_header([
            _h5_message(1, _h5_dataspace(arr.shape)),
            _h5_message(3, _h5_datatype(arr.dtype)),
            _h5_message(5, struct.pack("<4BI", 2, 2, 2, 1, 0)),
            _h5_message(8, layout)]))

    def group(t, path):
        members = sorted((k.encode(), dataset(v) if not isinstance(v, dict)
                          else group(v, f"{path}/{k}".lstrip("/"))[0])
                         for k, v in t.items())
        heap, offsets = bytearray(8), []
        for name, _ in members:
            offsets.append(len(heap))
            heap += _h5_pad(name + b"\0")
        heap_addr = put(b"HEAP" + bytes(4) + struct.pack(
            "<QQQ", len(heap), 1, put(heap)))
        keys = b""
        if members:
            snod = b"SNOD" + struct.pack("<BxH", 1, len(members)) + b"".join(
                struct.pack("<QQII16x", off, addr, 0, 0)
                for off, (_, addr) in zip(offsets, members))
            snod += bytes(8 + 2 * leaf_k * 40 - len(snod))
            keys = struct.pack("<QQQ", 0, put(snod), offsets[-1])
        node = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1 if members else 0,
                                     H5_UNDEF, H5_UNDEF) + keys
        node += bytes(24 + 16 * H5_GROUP_INTERNAL_K
                      + 8 * (2 * H5_GROUP_INTERNAL_K + 1) - len(node))
        btree = put(node)
        msgs = [_h5_message(17, struct.pack("<QQ", btree, heap_addr))]
        msgs += [_h5_attribute(k, np.asarray(v))
                 for k, v in attrs.get(path, {}).items()]
        return put(_h5_object_header(msgs)), btree, heap_addr

    root, btree, heap = group(tree, "")
    superblock = b"\x89HDF\r\n\x1a\n" + bytes([0, 0, 0, 0, 0, 8, 8, 0]) \
        + struct.pack("<HHI", leaf_k, H5_GROUP_INTERNAL_K, 0) \
        + struct.pack("<QQQQ", 0, H5_UNDEF, size, H5_UNDEF) \
        + struct.pack("<QQII", 0, root, 1, 0) + struct.pack("<QQ", btree, heap)
    chunks[0] = superblock
    with open(path, "wb") as f:
        for c in chunks:
            f.write(c)


def keras_h5_layout(layers: dict, nested: str = None):
    """(tree, attrs) of ``write_h5`` for Keras weights ({layer: {weight name
    with ":0": array}}) in ``save_weights``'s layout: a group a layer with
    its weights under ``<layer>/<weight>`` and a ``weight_names``
    attribute; with ``nested``, every layer but ``pre_conv`` sits in that
    one group, as the layers of a model nested in the saved one do."""
    tree, attrs = {}, {}

    def add(group, path, items):
        for layer, lw in items:
            group.setdefault(layer, {}).update(lw)
        attrs[path] = {"weight_names": np.array(
            [f"{layer}/{k}".encode() for layer, lw in items for k in lw])}

    outer = [(n, lw) for n, lw in layers.items()
             if nested is None or n == "pre_conv"]
    for layer, lw in outer:
        tree[layer] = {}
        add(tree[layer], layer, [(layer, lw)])
    if nested is not None:
        tree[nested] = {}
        add(tree[nested], nested,
            [(n, lw) for n, lw in layers.items() if n != "pre_conv"])
    attrs[""] = {"layer_names": np.array(
        [n.encode() for n in tree] or [b""])}
    return tree, attrs


# Keras weights on the card: the reference graph's U-Net at its published
# widths (pre_conv 2 -> 3, classification_models ResNet34 with
# pre-activation units, the sm 1.0.1 upsampling decoder 256, 128, 64, 32,
# 16, 3 classes; reference NNsegmentation/models.py:73-96), its 2.5-D
# model (3 slices, SegmentWithMultipleSlice's default unet_feat 32) and
# InceptionResNetV2 (include_top=False), each with seeded random weights
# written as a Keras .h5; a torchvision-format ResNet50 state_dict.
K_MS_SLICES = 3
K_MS_FEAT = 32
K_FIT_TRAIN = 16            # 2 steps at batch U_BATCH
K_FIT_VALID = 8
K_IRV2_OFFSET = 250         # auto-numbering offset of the InceptionResNetV2
K_LOGIT_RTOL = 1e-4         # card vs CPU logits, of max |logit| (phase 8)
K_FEAT_CHECK = 8            # patches (16 images) of the card-vs-CPU features
# card vs CPU pooled features: 1e-5 of max |feature|, phase 12's rule for
# the ResNet50 encode (E1_ENCODE_ATOL), for both networks
K_FEAT_RTOL = 1e-5
K_FEAT_BATCH = 128          # extract_features' default batch


def keras_weights(torch, net, seed, head_scale=1.0):
    """{layer: {"<weight>:0": array}} in Keras's layout for every layer of
    ``net`` (a port module whose children carry Keras layer names): conv
    kernels (kh, kw, in, out) He-scaled, ``final_conv``'s times
    ``head_scale`` (so a U-Net's logits are O(10), not O(1000)), biases
    N(0, 0.1); batch norm gamma U(0.5, 1.5) where the layer has one (not
    ``bn_data``, not InceptionResNetV2's scale=False ones), beta and moving
    mean N(0, 0.2), moving variance U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, m in net.named_children():
        if isinstance(m, torch.nn.Conv2d):
            o, i, kh, kw = m.weight.shape
            lw = {"kernel:0": rng.randn(kh, kw, i, o) * np.sqrt(
                2.0 / (kh * kw * i)) * (head_scale if name == "final_conv"
                                        else 1.0)}
            if m.bias is not None:
                lw["bias:0"] = 0.1 * rng.randn(o)
        else:
            n = m.num_features
            lw = {"gamma:0": 0.5 + rng.rand(n)} if m.weight.requires_grad \
                else {}
            lw.update({"beta:0": 0.2 * rng.randn(n),
                       "moving_mean:0": 0.2 * rng.randn(n),
                       "moving_variance:0": 0.5 + rng.rand(n)})
        out[name] = {k: v.astype(np.float32) for k, v in lw.items()}
    return out


def write_keras_file(path, layers, nested=None):
    """``layers`` as a Keras weight file (``keras_h5_layout``); returns its
    size in MB and the seconds the write took."""
    t0 = time.perf_counter()
    write_h5(path, *keras_h5_layout(layers, nested=nested))
    return os.path.getsize(path) / 1e6, time.perf_counter() - t0


@contextlib.contextmanager
def tf32_on(torch):
    """cuDNN's and cuBLAS's TF32 on inside the block (a control), the
    caller's settings back after it."""
    saved = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved


def unet_logits(torch, model, x, tf32=False):
    """A Segment's logits of ``x`` (on its device) as numpy: fp32 with no
    TF32, or with TF32 on (the control)."""
    from dynamorph_tpu_torch.core.device import fp32_strict

    with torch.no_grad(), tf32_on(torch) if tf32 else fp32_strict():
        return model.net.apply(x, train=False).cpu().numpy()


def keras_unet_part(torch, dev, root, seg, tag):
    """The 2-D Keras U-Net: write its .h5, load it on the card and the CPU
    through the port's reader, logits card vs CPU beside a TF32 control,
    run_segmentation -m segmentation from the .h5 on phase 8's site in both
    modes, the device ms per 2048^2 frame, and verify_against_golden on the
    card against CPU goldens."""
    from dynamorph_tpu_torch.cli import run_segmentation
    from dynamorph_tpu_torch.models.unet_keras import KerasUNet
    from dynamorph_tpu_torch.seg.data import load_input
    from dynamorph_tpu_torch.seg.keras_import import verify_against_golden
    from dynamorph_tpu_torch.seg.model import Segment

    with torch.device("meta"):
        layers = keras_weights(torch, KerasUNet(2, 3), SEED + 20,
                               head_scale=1 / 200)
    h5 = os.path.join(root, "keras_unet.h5")
    mb, write_s = write_keras_file(h5, layers, nested="model_1")
    del layers
    t0 = time.perf_counter()
    card = Segment(input_shape=(2, SEG_WINDOW, SEG_WINDOW), n_classes=3,
                   device=dev)
    card.load(h5)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cpu = Segment(input_shape=(2, SEG_WINDOW, SEG_WINDOW), n_classes=3,
                  device="cpu")
    cpu.load(h5)
    assert isinstance(card.net, KerasUNet) and isinstance(cpu.net, KerasUNet)
    n_params = sum(p.numel() for p in card.net.parameters())
    log(f"Keras U-Net .h5 ({mb:.1f} MB, {n_params:,} parameters, save_weights"
        f" layout with a nested model group) written in {write_s:.2f} s by "
        f"the script's own HDF5 writer; Segment.load on the card (the port's "
        f"HDF5 reader, the import, the upload) {load_s:.3f} s{tag}")

    # card vs CPU on 8 full-width tiles of phase 8's site
    site = load_input(seg["site_path"])[:, :2]
    w = SEG_WINDOW
    tiles = np.stack([site[0, :, 0, r:r + w, c:c + w]
                      for r in (0, 3 * w) for c in (0, 2 * w, 4 * w, 7 * w)]
                     ).astype(np.float32) / 65535.0
    x_card = torch.from_numpy(tiles).to(dev)
    want = unet_logits(torch, cpu, torch.from_numpy(tiles))
    top = float(np.abs(want).max())
    err = float(np.abs(unet_logits(torch, card, x_card) - want).max()) / top
    ctrl = float(np.abs(unet_logits(torch, card, x_card, tf32=True)
                        - want).max()) / top
    log(f"Keras U-Net, {len(tiles)} tiles of {w}^2, logits card vs CPU: "
        f"{err:.3e} of max |logit| {top:.3f} (limit {K_LOGIT_RTOL:g}); TF32 "
        f"control {ctrl:.3e} ({ctrl / K_LOGIT_RTOL:.1f}x the limit){tag}")
    if not err <= K_LOGIT_RTOL:
        raise AssertionError(f"Keras U-Net logits card vs CPU {err:.3e}")
    if not ctrl > K_LOGIT_RTOL:
        raise AssertionError("the Keras U-Net TF32 control lands inside the "
                             "limit, so the check cannot see TF32")

    golden = os.path.join(root, "keras_golden.npz")
    np.savez(golden, golden_input=tiles[:2], golden_logits=want[:2])
    golden_dev = verify_against_golden(card.net, golden)
    log(f"verify_against_golden on the card against CPU goldens (2 tiles): "
        f"max |d logit| {golden_dev:.3e} (atol 2e-3, classes agreeing on "
        f">= 99.9% of pixels){tag}")

    # run_segmentation from the .h5 on phase 8's site, both modes
    raw, supp = (os.path.join(root, d)
                 for d in ("keras_seg_raw", "keras_seg_supp"))
    os.makedirs(raw)
    os.makedirs(supp)
    name = os.path.basename(seg["site_path"])[:-4]
    os.symlink(seg["site_path"], os.path.join(raw, f"{name}.npy"))
    timing_log = os.path.join(root, "keras_seg_timing.jsonl")
    os.environ["DYNAMORPH_TIMING_LOG"] = timing_log
    runs = {}
    try:
        for mode in ("tiled", "direct"):
            cfg = os.path.join(root, f"keras_seg_{mode}.yml")
            with open(cfg, "w") as f:
                f.write("segmentation_inference:\n"
                        f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{supp}']\n"
                        f"  weights: '{h5}'\n  channels: [0, 1]\n"
                        f"  num_classes: 3\n  window_size: {SEG_WINDOW}\n"
                        f"  num_pred_rnd: {SEG_SUPP}\n"
                        f"  inference_mode: '{mode}'\n")
            np.random.seed(SEED)
            errors = ErrorRecords()
            logging.getLogger().addHandler(errors)
            t0 = time.perf_counter()
            try:
                run_segmentation.main(["-m", "segmentation", "-c", cfg,
                                       "--device", dev.type])
            finally:
                logging.getLogger().removeHandler(errors)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with open(timing_log) as f:
                stage_s = json.loads(f.read().splitlines()[-1])["seconds"]
            check_seg_outputs(raw, name, mode, errors.messages)
            log(f"run_segmentation -m segmentation {mode} from the .h5: "
                f"{wall:.3f} s wall for {SEG_T} frames of 2 x {SEG_FRAME}^2,"
                f" the site stage {stage_s:.3f} s{tag}")
            runs[mode] = dict(wall=wall, stage_s=stage_s)
    finally:
        del os.environ["DYNAMORPH_TIMING_LOG"]

    # device ms per 2048^2 frame: the tiled ensemble's tile batches and the
    # direct mode's one frame
    one = site[0, :, 0]
    x64 = torch.from_numpy(np.stack([
        one[:, r:r + w, c:c + w] for r in range(0, SEG_FRAME, w)
        for c in range(0, SEG_FRAME, w)]).astype(np.float32)).to(dev) / 65535.
    n_supp = (SEG_FRAME // w - 1) ** 2
    x_full = torch.from_numpy(one[None].astype(np.float32)).to(dev) / 65535.
    device_ms = {
        "tiled": time_cuda(torch, lambda: card.probabilities(x64), 3)
        + SEG_SUPP * time_cuda(torch, lambda: card.probabilities(
            x64[:n_supp]), 3),
        "direct": time_cuda(torch, lambda: card.probabilities(x_full), 3)}
    flops = conv_flops(torch, card, x64[:1])
    for mode, ms in device_ms.items():
        n = len(x64) + SEG_SUPP * n_supp if mode == "tiled" else len(x64)
        log(f"Keras U-Net, one {SEG_FRAME}^2 frame {mode}: device work "
            f"{ms:.3f} ms ({1e3 / ms:.3f} frames/s), "
            f"{n * flops / ms / 1e9 / (FP32_FLOP_PER_S / 1e12):.4f} of the "
            f"fp32 rate ({flops / 1e9:.3f} GFLOP a {w}^2 tile){tag}")
    return dict(h5=h5, mb=mb, write_s=write_s, load_s=load_s, logit_err=err,
                logit_control=ctrl, golden_dev=golden_dev, runs=runs,
                device_ms=device_ms, tile_gflop=flops / 1e9)


def keras_fit_part(torch, dev, root, h5, tag):
    """Segment.fit from the imported .h5 with freeze_encoder=True (2 steps
    at batch 8 of 256^2 and a validation pass): the encoder's weights and
    bn_data's gamma bit-unchanged, the decoder and every running statistic
    moved; then the step timed on a resident batch, its idle share."""
    from dynamorph_tpu_torch.models.unet_keras import encoder_layer_names
    from dynamorph_tpu_torch.seg.model import Segment

    rng = np.random.RandomState(SEED + 23)
    pairs = []
    for _ in range(K_FIT_TRAIN + K_FIT_VALID):
        lab = rng.rand(3, 1, SEG_WINDOW, SEG_WINDOW) ** 3
        pairs.append([rng.rand(2, 1, SEG_WINDOW, SEG_WINDOW) * 65535,
                      lab / lab.sum(0, keepdims=True)])
    model = Segment(input_shape=(2, SEG_WINDOW, SEG_WINDOW), n_classes=3,
                    freeze_encoder=True, device=dev,
                    model_path=os.path.join(root, "keras_fit"))
    model.load(h5)
    before = {k: v.clone() for k, v in model.net.state_dict().items()}
    t0 = time.perf_counter()
    hist = model.fit(pairs[:K_FIT_TRAIN], batch_size=U_BATCH, n_epochs=1,
                     valid_patches=pairs[K_FIT_TRAIN:])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    encoder = tuple(n + "." for n in encoder_layer_names())

    def frozen_kept(sd):
        bad = [k for k, v in sd.items() if k.startswith(encoder)
               and "running" not in k and "num_batches" not in k
               and not torch.equal(v, before[k])]
        if not torch.equal(sd["bn_data.weight"],
                           torch.ones(3, device=dev)):
            bad.append("bn_data.weight")
        return bad

    after = model.net.state_dict()
    moved = [k for k, v in after.items() if not k.startswith(encoder)
             and v.dtype.is_floating_point and not torch.equal(v, before[k])]
    stats = [k for k, v in after.items() if "running" in k
             and not torch.equal(v, before[k])]
    bad = frozen_kept(after)
    n_running = sum("running" in k for k in after)
    log(f"fit from the .h5, freeze_encoder=True: {K_FIT_TRAIN} patches at "
        f"batch {U_BATCH} + {K_FIT_VALID} validation, {fit_s:.3f} s, loss "
        f"{hist[0]['loss']:.6f} val_loss {hist[0]['val_loss']:.6f}; encoder "
        f"weights and bn_data's gamma changed: {bad or 'none'}; decoder "
        f"tensors moved {len(moved)}; running statistics moved "
        f"{len(stats)} of {n_running}{tag}")
    if bad or len(stats) != n_running or not moved:
        raise AssertionError(f"freeze_encoder: changed {bad}, moved "
                             f"{len(moved)}, statistics {len(stats)}")

    X, y = model._arrays(pairs[:U_BATCH], "prob")
    xb, yb = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    _, step = model._make_step(1e-3)
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_cuda(torch, lambda: step(xb, yb), 10)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"Keras U-Net train step, freeze_encoder, batch {U_BATCH}, "
        f"{SEG_WINDOW}^2, fp32 (no TF32), device-resident: {step_ms:.6f} ms,"
        f" {U_BATCH / step_ms * 1e3:.1f} patches/s; peak device memory "
        f"{peak:.3f} GB{tag}")
    prof = profile_steps(torch, lambda: step(xb, yb), 2, step_ms,
                         families=E1_FAMILIES, other=SEG_OTHER, tag=tag)
    bad = frozen_kept(model.net.state_dict())
    if bad:
        raise AssertionError(f"freeze_encoder let {bad[:3]} move over the "
                             "timed steps")
    return dict(fit_s=fit_s, step_ms=step_ms, peak_gb=peak,
                idle=None if prof is None else max(
                    0.0, 1 - prof["busy_ms"] / step_ms),
                busy_ms=None if prof is None else prof["busy_ms"],
                history=hist)


def keras_multislice_part(torch, dev, root, tag):
    """SegmentWithMultipleSlice.load of a 2.5-D .h5 (its dims read from the
    file) on the card and the CPU; the logits of 2 samples card vs CPU at
    the 2-D model's rule, beside a TF32 control."""
    from dynamorph_tpu_torch.models.unet_keras import MultiSliceKerasUNet
    from dynamorph_tpu_torch.seg.model import SegmentWithMultipleSlice

    with torch.device("meta"):
        layers = keras_weights(torch, MultiSliceKerasUNet(
            2, K_MS_SLICES, 3, K_MS_FEAT), SEED + 21, head_scale=1 / 20)
    h5 = os.path.join(root, "keras_unet_ms.h5")
    mb, _ = write_keras_file(h5, layers, nested="model_1")
    del layers
    shape = (2, K_MS_SLICES, SEG_WINDOW, SEG_WINDOW)
    models = {}
    for where in ("cpu", dev):
        m = SegmentWithMultipleSlice(input_shape=shape, n_classes=3,
                                     device=where)
        m.load(h5)
        assert m.unet_feat == K_MS_FEAT
        models[str(where)] = m
    card = models[str(dev)]
    r = np.random.RandomState(SEED + 21)
    x = r.rand(2, 2, K_MS_SLICES, SEG_WINDOW, SEG_WINDOW).astype(np.float32)
    want = unet_logits(torch, models["cpu"], torch.from_numpy(x))
    top = float(np.abs(want).max())
    xd = torch.from_numpy(x).to(dev)
    got = unet_logits(torch, card, xd)
    err = float(np.abs(got - want).max()) / top
    ctrl = float(np.abs(unet_logits(torch, card, xd, tf32=True)
                        - want).max()) / top
    prob = float(np.abs(torch.softmax(torch.from_numpy(got), 1).numpy()
                        - torch.softmax(torch.from_numpy(want), 1).numpy()
                        ).max())
    log(f"SegmentWithMultipleSlice.load of a 2.5-D .h5 ({mb:.1f} MB; "
        f"{K_MS_SLICES} slices, unet_feat {K_MS_FEAT} read from the file): 2 "
        f"samples, logits card vs CPU {err:.3e} of max |logit| {top:.3f} "
        f"(limit {K_LOGIT_RTOL:g}; max |d prob| {prob:.3e}); TF32 control "
        f"{ctrl:.3e} ({ctrl / K_LOGIT_RTOL:.1f}x the limit){tag}")
    if not err <= K_LOGIT_RTOL:
        raise AssertionError(f"2.5-D Keras model card vs CPU {err:.3e}")
    if not ctrl > K_LOGIT_RTOL:
        raise AssertionError("the 2.5-D TF32 control lands inside the limit,"
                             " so the check cannot see TF32")
    return dict(err=err, control=ctrl, prob_err=prob, max_logit=top, mb=mb)


def tf32_features(torch, model, x):
    """Pooled features of the host images ``x`` with TF32 on (the
    control)."""
    with torch.no_grad(), tf32_on(torch):
        xd = torch.from_numpy(x).to(next(model.parameters()).device)
        return getattr(model, "convnet", model)(xd).cpu().numpy()


def features_vs_cpu(torch, what, card_model, cpu_model, x, tag):
    """Pooled features of the preprocessed images ``x`` card vs CPU, and
    of the card with TF32 on (the control), of max |feature|."""
    want = cpu_model.encode_batched(x, out="h")
    top = float(np.abs(want).max())
    err = float(np.abs(card_model.encode_batched(x, out="h")
                       - want).max()) / top
    ctrl = float(np.abs(tf32_features(torch, card_model, x)
                        - want).max()) / top
    log(f"{what}, {len(x)} images of 224^2, card vs CPU: {err:.3e} of max "
        f"|feature| {top:.3f} (limit {K_FEAT_RTOL:g}); TF32 control "
        f"{ctrl:.3e} ({ctrl / K_FEAT_RTOL:.1f}x the limit){tag}")
    if not err <= K_FEAT_RTOL:
        raise AssertionError(f"{what} features card vs CPU {err:.3e}")
    if not ctrl > K_FEAT_RTOL:
        raise AssertionError(f"the {what} TF32 control lands inside the "
                             "limit, so the check cannot see TF32")
    return err, ctrl


def keras_imagenet_part(torch, dev, root, well, tag):
    """initiate_model_inception from an offset-numbered with-top .h5 and
    initiate_model from a torchvision ResNet50 state_dict, each through
    extract_features on phase 4's 2,304-patch well (4,608 images of
    224^2): shapes, images/s end to end and of the device encode alone, and
    card vs CPU on a subset beside a TF32 control."""
    from dynamorph_tpu_torch.analysis import imagenet_baseline as ib
    from dynamorph_tpu_torch.core.device import fp32_strict
    from dynamorph_tpu_torch.models.inception_resnet_v2 import \
        InceptionResNetV2
    from dynamorph_tpu_torch.models.resnet_simclr import EncodeProject

    def offset(name):
        for prefix in ("conv2d", "batch_normalization"):
            if name == prefix:
                return f"{prefix}_{K_IRV2_OFFSET}"
            tail = name[len(prefix) + 1:]
            if name.startswith(prefix + "_") and tail.isdigit():
                return f"{prefix}_{int(tail) + K_IRV2_OFFSET}"
        return name

    with torch.device("meta"):
        irv2 = InceptionResNetV2(seed=None)
    layers = {offset(k): v for k, v in keras_weights(
        torch, irv2, SEED + 22).items()}
    layers["predictions"] = {"kernel:0": np.zeros((1536, 1000), np.float32),
                             "bias:0": np.zeros(1000, np.float32)}
    h5 = os.path.join(root, "irv2.h5")
    mb, write_s = write_keras_file(h5, layers)
    del layers
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED + 22)
        trunk = EncodeProject("ResNet50", num_inputs=3).convnet
    g = torch.Generator().manual_seed(SEED + 22)
    sd = {}
    with torch.no_grad():
        for k, v in trunk.state_dict().items():
            if k.endswith(("running_mean", "bias")):
                v = 0.1 * torch.randn(v.shape, generator=g)
            elif k.endswith("running_var"):
                v = 0.5 + torch.rand(v.shape, generator=g)
            sd[k] = v
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)
    pt = os.path.join(root, "resnet50_torchvision.pt")
    torch.save(sd, pt)

    t0 = time.perf_counter()
    models = {"InceptionResNetV2": ib.initiate_model_inception(weights=h5,
                                                                device=dev)}
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    models["ResNet50"] = ib.initiate_model(weights=pt, device=dev)
    cpu = {"InceptionResNetV2": ib.initiate_model_inception(weights=h5,
                                                             device="cpu"),
           "ResNet50": ib.initiate_model(weights=pt, device="cpu")}
    log(f"InceptionResNetV2 .h5 ({mb:.1f} MB, auto-numbering from "
        f"conv2d_{K_IRV2_OFFSET}, with the with-top predictions layer) "
        f"written in {write_s:.2f} s, initiate_model_inception on the card "
        f"{load_s:.3f} s; ResNet50 from a torchvision state_dict{tag}")

    patches = well[:, :, 0]
    out = {}
    for name, mode, dim in (("InceptionResNetV2", "inception", 1536),
                            ("ResNet50", "torch", 2048)):
        model = models[name]
        x = np.concatenate([ib.preprocess(p, mode=mode)
                            for p in patches[:K_FEAT_CHECK]])
        err, ctrl = features_vs_cpu(torch, name, model, cpu[name], x, tag)
        xb = torch.from_numpy(np.concatenate([x] * (K_FEAT_BATCH // len(x))
                                             )).to(dev)
        trunk = getattr(model, "convnet", model)
        with torch.no_grad(), fp32_strict():
            enc_ms = time_cuda(torch, lambda: trunk(xb), 3)
        t0 = time.perf_counter()
        feats = ib.extract_features(patches, model, mode=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_img = 2 * len(patches)
        if feats.shape != (len(patches), 2, dim) or \
                not np.isfinite(feats).all():
            raise AssertionError(f"{name} features {feats.shape}")
        log(f"{name} extract_features on the well: {len(patches)} patches "
            f"x 2 channels = {n_img} images of 224^2 -> {feats.shape} in "
            f"{wall:.3f} s, {n_img / wall:.1f} images/s end to end (host "
            f"resize and normalisation included); the device encode alone "
            f"at batch {K_FEAT_BATCH}: {enc_ms:.3f} ms, "
            f"{K_FEAT_BATCH / enc_ms * 1e3:.1f} images/s{tag}")
        out[name] = dict(err=err, control=ctrl, wall=wall,
                         images_per_s=n_img / wall, encode_ms=enc_ms,
                         encode_images_per_s=K_FEAT_BATCH / enc_ms * 1e3)
    out["irv2_mb"] = mb
    return out


def phase_keras(torch, vq, root, dev, card, seg, well):
    phase("15. Keras weights: the port's HDF5 reader, the Keras U-Net "
          "(Segment.load, run_segmentation, fit with freeze_encoder), the "
          "2.5-D model, verify_against_golden, InceptionResNetV2 and "
          "ResNet50 baselines, on cuda")
    tag = f" [{card}]"
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    vq.vq_lookup.launches = vq.vq_indices.launches = 0
    parts = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        parts[name] = time.perf_counter() - t0
        return result

    unet = timed("unet", keras_unet_part, torch, dev, root, seg, tag)
    fit = timed("fit", keras_fit_part, torch, dev, root, unet["h5"], tag)
    multi = timed("multislice", keras_multislice_part, torch, dev, root,
                  tag)
    feats = timed("imagenet", keras_imagenet_part, torch, dev, root, well,
                  tag)
    launches = {"vq_lookup": vq.vq_lookup.launches,
                "vq_indices": vq.vq_indices.launches}
    if any(launches.values()):
        raise AssertionError(f"a VQ kernel launched on the Keras path: "
                             f"{launches}")
    secs = time.perf_counter() - t_phase
    log(f"phase 15 took {secs:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items())
        + f"; vq_lookup launches {launches['vq_lookup']}, vq_indices "
        f"launches {launches['vq_indices']}")
    return dict(unet=unet, fit=fit, multi=multi, features=feats, secs=secs,
                launches=launches)


# ---------------------------------------------------------------- phase 16

MR_MAX_WORLD = 4
MR_CHECK = 8               # the global batch of the step checks
MR_STEPS = 3               # seeded batches of the z32 step check
MR_EPOCHS = 2              # run_training --multihost on phase 5's patches
MR_VAL = 0.5               # 768 of its 1,536 patches: one full val batch
MR_TIMED = 5               # timed data-parallel steps at batch 768
MR_TIMEOUT = 300           # s a launch of ranks may take
MR_THREADS = 3             # host threads a rank (8 cores, 2 ranks + main)
MR_PIPE_WELLS = ("C5", "D3")
HERE = os.path.dirname(os.path.abspath(__file__))
# the cards visible when main() started, before it kept only the first
_VISIBLE = {"cuda": None}
RANK_BOOT = ("import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
             "sys.exit(chip_smoke.rank_main(sys.argv[1:]))")


def visible_cards():
    """The indices of the cards this run may use: CUDA_VISIBLE_DEVICES as
    main() found it, else every card ``nvidia-smi -L`` lists."""
    if _VISIBLE["cuda"]:
        return [v for v in _VISIBLE["cuda"].split(",") if v.strip()]
    res = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                         text=True, check=True, timeout=60)
    return [str(i) for i, line in enumerate(res.stdout.splitlines())
            if line.startswith("GPU ")]


def free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_ranks(job, world, root, cards, extra=(), tag=""):
    """Start ``world`` processes of ``rank_main(job, ...)``, one a rank, on
    the cards ``cards``; each rank's stderr goes to
    ``<root>/rank_<job><tag>_<r>.log``. ``wait_ranks`` collects them."""
    port = free_port()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=",".join(cards),
               OMP_NUM_THREADS=str(MR_THREADS))
    boot = RANK_BOOT.format(here=HERE)
    logs = [os.path.join(root, f"rank_{job}{tag}_{r}.log")
            for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", boot, job, str(r), str(world),
                 str(port), root, *extra], env=env, cwd=HERE,
                stdout=subprocess.PIPE, stderr=err, text=True))
    return job, procs, logs, time.perf_counter()


def wait_ranks(started):
    """[(exit code, the rank's result dict or None)] and the log paths of
    ranks from ``start_ranks``. Ranks still running MR_TIMEOUT s after
    their start are killed, and it raises."""
    job, procs, logs, t0 = started
    outs = []
    try:
        for p in procs:
            left = MR_TIMEOUT - (time.perf_counter() - t0)
            outs.append(p.communicate(timeout=max(left, 1.0))[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the ranks of '{job}' ran past {MR_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("RANK_RESULT:")]
        if p.returncode == 0 and not lines:
            raise AssertionError(f"rank {r} of '{job}' printed no result")
        res.append((p.returncode, json.loads(lines[-1][12:])
                    if lines else None))
    return res, logs


def run_ranks(job, world, root, cards, extra=(), tag=""):
    return wait_ranks(start_ranks(job, world, root, cards, extra, tag))


def log_tail(path, n=20):
    with open(path) as f:
        return "".join(f.readlines()[-n:])


def rank_main(argv) -> int:
    """One rank of phase 16, started by ``run_ranks``: ``job rank world
    port root [args]``. Prints ``RANK_RESULT: {json}`` and returns 0, or
    raises."""
    job, rank, world, port, root = (argv[0], int(argv[1]), int(argv[2]),
                                    int(argv[3]), argv[4])
    extra = argv[5:]
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        raise RuntimeError("a rank of phase 16 found no card")
    torch.set_num_threads(MR_THREADS)
    from dynamorph_tpu_torch.core import mesh
    from dynamorph_tpu_torch.ops import vq

    flags = ["--multihost", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(world), "--process-id", str(rank)]
    vq.vq_indices.launches = vq.vq_lookup.launches = 0
    if job == "train":
        from dynamorph_tpu_torch.cli import run_training

        t0 = time.perf_counter()
        with deterministic_cudnn(torch):
            _, hist = run_training.main(["-c", extra[0], *flags])
        torch.cuda.synchronize()
        out = dict(hist=hist, wall=time.perf_counter() - t0)
        out["launches"] = dict(vq_indices=vq.vq_indices.launches,
                               vq_lookup=vq.vq_lookup.launches)
        out["timing"] = mr_timed_steps(torch, torch.device("cuda"))
    elif job == "steps":
        mesh.init_multihost(f"127.0.0.1:{port}", world, rank)
        comm = mesh.ProcessGroupComm()
        inp = torch.load(os.path.join(root, "mr_inputs.pt"),
                         weights_only=False)
        dev = torch.device("cuda")
        res = dict(z32=mr_z32_steps(torch, comm, inp, dev),
                   triplet=mr_triplet_step(torch, comm, inp, dev))
        if rank == 0:
            torch.save(res, os.path.join(root, "mr_ranks.pt"))
        out = dict(losses=res["z32"]["losses"],
                   triplet_losses=res["triplet"]["losses"])
    elif job == "pipeline":
        from dynamorph_tpu_torch.cli import run_pipeline
        from dynamorph_tpu_torch.pipeline import orchestrator

        if extra[1] == "fail" and rank == 1:
            def planted(*a, **k):
                raise RuntimeError("a stage failure planted on rank 1")

            orchestrator.process_vae = planted
        executed = run_pipeline.main(["-c", extra[0], "--stages", "process",
                                      "pca", *flags])
        torch.cuda.synchronize()
        out = dict(executed=list(executed.values())[0],
                   launches=vq.vq_lookup.launches,
                   indices=vq.vq_indices.launches)
    else:
        raise ValueError(f"unknown job {job}")
    out.update(rank=rank, world=dist.get_world_size(),
               backend=dist.get_backend(), device=str(mesh.rank_device()),
               card=torch.cuda.get_device_name(mesh.rank_device()))
    print("RANK_RESULT:" + json.dumps(out), flush=True)
    mesh.shutdown_multihost()
    return 0


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN's deterministic algorithms for a training run that phase 18
    holds bit for bit against another: the default ones accumulate with
    atomics, so two runs of one path differ (Adam then turns the noise on
    zero-gradient biases into steps of about lr)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def mr_timed_steps(torch, dev):
    """The data-parallel z32 step at batch 768 (768 / world rows a rank,
    trajectory-packed, the ring loss, augmentation on) on resident rows:
    ms a step (host clock around MR_TIMED steps and a synchronise), then
    3 steps with every collective timed between two synchronises (its
    share of those steps), and the bytes a rank sends a ring step."""
    from dynamorph_tpu_torch.core import mesh
    from dynamorph_tpu_torch.models import VQVAEz32
    from dynamorph_tpu_torch.train import sharded_loss as SL
    from dynamorph_tpu_torch.train.data import zscore
    from dynamorph_tpu_torch.train.steps import make_train_step

    comm = mesh.ProcessGroupComm()
    world, rank = comm.world, comm.rank
    b = TRAIN_BATCH // world
    rel = relation_block(TRAIN_BATCH)
    packed = SL.pack_trajectories(
        np.arange(TRAIN_BATCH),
        SL.trajectory_ids_from_relations(rel, TRAIN_BATCH), world)
    rows = packed[rank * b:(rank + 1) * b]
    block = torch.from_numpy(SL.blockdiag_relations(
        rel, packed, world)[rank * b:(rank + 1) * b]).to(dev)
    x = torch.from_numpy(zscore(blob_patches(np.random.RandomState(
        SEED + 16), TRAIN_BATCH)[rows]).astype(np.float32)).to(dev)
    torch.manual_seed(SEED + 16)
    model = VQVAEz32(**TRAIN_NET).to(dev)
    mesh.broadcast_state(model, comm)
    model.tm_loss_fn = SL.make_traj_sharded_tm_loss(comm)
    step = make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-4), augment=True,
        generator=torch.Generator(device=dev).manual_seed(SEED), comm=comm)
    for _ in range(2):
        step(x, block)
    torch.cuda.synchronize()
    mesh.barrier("timed steps")
    t0 = time.perf_counter()
    for _ in range(MR_TIMED):
        step(x, block)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / MR_TIMED * 1e3
    spent = [0.0]

    def timed(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t
            return out
        return call

    for name in ("all_reduce", "all_gather", "broadcast", "shift"):
        setattr(comm, name, timed(getattr(comm, name)))
    sent = comm.sent_bytes
    mesh.barrier("timed collectives")
    t0 = time.perf_counter()
    for _ in range(3):
        step(x, block)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ring_steps = 3 * 2 * (world - 1)     # forward and gradient, each step
    return dict(step_ms=step_ms, rows=b, collective_ms=spent[0] / 3 * 1e3,
                collective_share=spent[0] / wall,
                ring_bytes=(comm.sent_bytes - sent) / ring_steps
                if ring_steps else 0,
                host_staged=comm.stages_through_host)


def mr_grads(torch, model, comm, forward, masks=None, replay=False,
             tf32=False):
    """One forward (``forward(model)`` returns the losses) and backward in
    ``comm``'s data-parallel scope (none for None), the gradients averaged
    over the ranks: (losses, {weight: float64 gradient on the host}).
    ``masks`` records or, with ``replay``, replays the kinks
    (``kink_branches``); ``tf32`` runs the backward outside
    ``fp32_strict`` with TF32 on (the control: the models' forward passes
    are strict inside ``apply``)."""
    from dynamorph_tpu_torch.core.device import fp32_strict
    from dynamorph_tpu_torch.core.mesh import (average_gradients,
                                               collective_scope)
    from dynamorph_tpu_torch.nn.batchnorm import cross_rank_batch_norm

    nothing = contextlib.nullcontext
    flags = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    if tf32:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    model.zero_grad(set_to_none=True)
    try:
        with collective_scope(comm), \
                cross_rank_batch_norm(model) if comm else nothing(), \
                nothing() if tf32 else fp32_strict(), \
                kink_branches(torch, masks, replay) if masks is not None \
                else nothing():
            losses = forward(model)
            losses["total_loss"].backward()
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
    if comm is not None:
        average_gradients(model.parameters(), comm)
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: p.grad.detach().cpu().double()
             for n, p in model.named_parameters()
             if p.grad is not None and n.endswith(".weight")})


def mr_rows(inp, comm):
    """This rank's rows of the packed global batch, and its relation: the
    ranks' (b, b) diagonal block for the ring loss, or for one process the
    dense (B, B) relation of the packed batch with the blocks the ranks do
    not see (their cross-rank pairs, negatives in the ring loss) zeroed."""
    from dynamorph_tpu_torch.train import sharded_loss as SL

    packed, world = inp["packed"], inp["world"]
    b = MR_CHECK // world
    if comm is None:
        rel = inp["rel"][packed][:, packed]
        own = np.arange(MR_CHECK) // b
        return packed, np.where(own[:, None] == own[None, :], rel, 0)
    r = comm.rank
    return (packed[r * b:(r + 1) * b],
            SL.blockdiag_relations(inp["rel"], packed,
                                   world)[r * b:(r + 1) * b])


def mr_z32_steps(torch, comm, inp, dev):
    """MR_STEPS data-parallel z32 train steps at full width (the trainer's
    step, Adam, no augmentation) on seeded batches of MR_CHECK (one process
    with ``comm`` None): each step's losses, the running buffers after the
    first, and each weight's gradient error against float64 on the CPU
    from the same weights, on the fp32 step's side of every kink and with
    its codes (``mr_grads``), pooled over the steps and for the first
    alone; and a control step whose backward runs in TF32."""
    from dynamorph_tpu_torch.models import VQVAEz32
    from dynamorph_tpu_torch.models import vqvae as vqvae_mod
    from dynamorph_tpu_torch.train import sharded_loss as SL
    from dynamorph_tpu_torch.train.steps import make_train_step

    rows, rel = mr_rows(inp, comm)
    real = vqvae_mod.vq_indices

    def build(state, device, dtype=torch.float32):
        m = VQVAEz32(**TRAIN_NET)
        m.load_state_dict(state)
        m = m.to(device=device, dtype=dtype)
        if comm is not None:
            m.tm_loss_fn = SL.make_traj_sharded_tm_loss(comm)
        return m

    def forward(x, mask):
        maskf = torch.as_tensor(mask).to(x.device, x.dtype)
        return lambda m: m.apply(x, train=True, time_matching_mat=rel,
                                 batch_mask=maskf)[1]

    def replayed(idx):
        return lambda z, cb, precision="highest": idx.to(z.device)

    model = build(inp["z32"], dev)
    step = make_train_step(model, torch.optim.Adam(
        model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8),
        augment=False, comm=comm)
    losses, g32s, g64s, flips = [], [], [], 0
    for i in range(MR_STEPS):
        x = torch.from_numpy(inp["x"][i][rows]).to(dev)
        mask = inp["mask"][i][rows]
        before = {k: v.detach().clone() for k, v in
                  model.state_dict().items()}
        masks, seen = [], {}

        def recording(z, cb, precision="highest"):
            seen["idx"] = real(z, cb, precision=precision)
            return seen["idx"]

        vqvae_mod.vq_indices = recording
        try:
            with kink_branches(torch, masks, False):
                l32 = step(x, rel, mask)
        finally:
            vqvae_mod.vq_indices = real
        losses.append({k: float(v) for k, v in l32.items()})
        g32s.append({n: p.grad.detach().cpu().double()
                     for n, p in model.named_parameters()
                     if n.endswith(".weight")})
        if i == 0:
            bufs = {n: b.detach().cpu().clone()
                    for n, b in model.named_buffers() if "running" in n}
            first = (before, x, mask, seen["idx"], masks)
        f64 = build(before, "cpu", torch.float64)
        vqvae_mod.vq_indices = replayed(seen["idx"])
        try:
            g64s.append(mr_grads(torch, f64, comm,
                                 forward(x.cpu().double(), mask),
                                 masks=masks, replay=True)[1])
        finally:
            vqvae_mod.vq_indices = real
    before, x, mask, idx, masks = first
    vqvae_mod.vq_indices = replayed(idx)
    try:
        _, g_ctrl = mr_grads(torch, build(before, dev), comm,
                             forward(x, mask), tf32=True)
    finally:
        vqvae_mod.vq_indices = real
    return dict(losses=losses, bufs=bufs, err=pooled_errors(g32s, g64s),
                err_first=pooled_errors(g32s[:1], g64s[:1]),
                err_control=pooled_errors([g_ctrl], g64s[:1]),
                kink_choices=sum(int(m.numel()) for m in masks))


def pooled_errors(fp32, f64):
    """Each weight's relative L2 error, its gradients over the steps
    concatenated."""
    import torch

    out = {}
    for n in fp32[0]:
        a = torch.cat([g[n].reshape(-1) for g in fp32])
        b = torch.cat([g[n].reshape(-1) for g in f64])
        out[n] = float(torch.norm(a - b) / max(float(torch.norm(b)), 1e-30))
    return out


def mr_triplet_step(torch, comm, inp, dev):
    """One data-parallel ResNet18 step with the all-triplet miner on the
    gathered batch (one process with ``comm`` None), its gradients against
    float64 on the CPU on the fp32 step's side of every kink, and a TF32
    control."""
    from dynamorph_tpu_torch.train.steps import make_triplet_steps

    world, rank = (1, 0) if comm is None else (comm.world, comm.rank)
    b = MR_CHECK // world
    x = torch.from_numpy(inp["tx"][rank * b:(rank + 1) * b])
    labels = torch.from_numpy(inp["labels"][rank * b:(rank + 1) * b])

    def build(device, dtype=torch.float32):
        m = e1_model("ResNet18")
        m.load_state_dict(inp["triplet"])
        return m.to(device=device, dtype=dtype)

    model = build(dev)
    step, _ = make_triplet_steps(model, torch.optim.Adam(
        model.parameters(), lr=1e-4), comm=comm)
    masks = []
    with kink_branches(torch, masks, False):
        l32 = step(x.to(dev), labels.to(dev))
    g32 = {n: p.grad.detach().cpu().double()
           for n, p in model.named_parameters()
           if p.grad is not None and n.endswith(".weight")}
    _, g64 = mr_grads(torch, build("cpu", torch.float64), comm,
                      lambda m: m.apply(x.double(), labels, train=True)[1],
                      masks=masks, replay=True)
    _, g_ctrl = mr_grads(torch, build(dev), comm,
                         lambda m: m.apply(x.to(dev), labels.to(dev),
                                           train=True)[1], tf32=True)
    return dict(losses={k: float(v) for k, v in l32.items()},
                err=pooled_errors([g32], [g64]),
                err_control=pooled_errors([g_ctrl], [g64]))


def mr_inputs(torch, world):
    """The step checks' seeded inputs: MR_STEPS batches of MR_CHECK
    full-width z32 patches (two trajectories of 4) with masks, their
    packed order for ``world`` ranks, z32 weights, and MR_CHECK ResNet18
    patches in 4 labels with seeded weights (batch norm off the
    identity)."""
    from dynamorph_tpu_torch.models import VQVAEz32
    from dynamorph_tpu_torch.train import sharded_loss as SL
    from dynamorph_tpu_torch.train.data import zscore

    rng = np.random.RandomState(SEED + 16)
    rel = relation_block(MR_CHECK, 4)
    torch.manual_seed(SEED + 16)
    z32 = VQVAEz32(**TRAIN_NET)
    return dict(
        world=world, rel=rel,
        packed=SL.pack_trajectories(
            np.arange(MR_CHECK),
            SL.trajectory_ids_from_relations(rel, MR_CHECK), world),
        x=[zscore(blob_patches(rng, MR_CHECK)).astype(np.float32)
           for _ in range(MR_STEPS)],
        mask=[(rng.rand(MR_CHECK, 1, 128, 128) > 0.3).astype(np.uint8)
              for _ in range(MR_STEPS)],
        z32=z32.state_dict(),
        tx=zscore(blob_patches(rng, MR_CHECK)).astype(np.float32),
        labels=np.repeat(np.arange(MR_CHECK // 2), 2),
        triplet=e1_seeded_model(torch, "ResNet18").state_dict())


def mr_hold(what, ranks, one, limit_ok=True):
    """The ranks' gradient errors against one process's, at phase 6's rule
    (each weight: ranks' error <= 3 x one process's + 1e-5); with
    ``limit_ok`` False the control must land over it. Returns (worst
    weight, its ratio)."""
    ratio = {n: ranks[n] / (STEP_GRAD_VS_CPU * one[n] + STEP_GRAD_FLOOR)
             for n in one}
    worst = max(ratio, key=ratio.get)
    log(f"  {what}: worst {worst} ranks {ranks[worst]:.3e} vs float64, "
        f"one process {one[worst]:.3e}: {ratio[worst]:.3f} of the limit")
    if limit_ok and ratio[worst] > 1:
        raise AssertionError(f"{what}: {worst} at {ratio[worst]:.3f} of the "
                             "limit")
    if not limit_ok and not ratio[worst] > 1:
        raise AssertionError(f"{what}: the TF32 control lands at "
                             f"{ratio[worst]:.3f} of the limit; the check "
                             "cannot see TF32")
    return worst, ratio[worst]


def mr_training_config(root, world_tag):
    """run_training's config for phases 16 and 18: phase 5's training
    patches, MR_EPOCHS epochs, half of them validation (one full batch),
    from seeded start weights (``mr_start.pt``, written once), so every
    run starts from the same model."""
    cfg = os.path.join(root, f"mr_train_{world_tag}.yml")
    start = os.path.join(root, "mr_start.pt")
    if not os.path.exists(start):
        import torch
        from dynamorph_tpu_torch.models import VQVAEz32

        torch.manual_seed(SEED + 18)
        torch.save(VQVAEz32(**TRAIN_NET).state_dict(), start)
    with open(os.path.join(root, "train_cfg.yml")) as f:
        text = f.read()
    text = text.replace("train_out", f"mr_train_out_{world_tag}")
    text = text.replace(f"n_epochs: {TRAIN_EPOCHS}", f"n_epochs: {MR_EPOCHS}")
    text = text.replace("val_split_ratio: 0.15", f"val_split_ratio: {MR_VAL}")
    text += f"  start_model_path: '{start}'\n"
    with open(cfg, "w") as f:
        f.write(text)
    return cfg, os.path.join(root, f"mr_train_out_{world_tag}", "vqvae32")


def mr_check_training(torch, res, logs, want_steps, want_val, tag):
    for r, (rc, out) in enumerate(res):
        if rc != 0:
            raise AssertionError(f"run_training --multihost rank {r} exited "
                                 f"{rc}:\n{log_tail(logs[r])}")
    outs = [o for _, o in res]
    for o in outs:
        log(f"  rank {o['rank']}/{o['world']} on {o['device']} "
            f"({o['card']}) over {o['backend']}: run_training "
            f"{o['wall']:.3f} s, vq_indices {o['launches']['vq_indices']} "
            f"(want {want_steps}), vq_lookup {o['launches']['vq_lookup']} "
            f"(want {want_val}); step at batch {TRAIN_BATCH} "
            f"({o['timing']['rows']} rows a rank) "
            f"{o['timing']['step_ms']:.3f} ms, collectives "
            f"{o['timing']['collective_ms']:.3f} ms a step (share "
            f"{o['timing']['collective_share']:.4f}), ring step "
            f"{o['timing']['ring_bytes']:.0f} bytes sent a rank{tag}")
        if o["launches"]["vq_indices"] != want_steps or \
                o["launches"]["vq_lookup"] != want_val:
            raise AssertionError("a rank did not launch vq_indices once a "
                                 "training step and vq_lookup once a "
                                 "validation step")
    if any(o["hist"] != outs[0]["hist"] for o in outs):
        raise AssertionError("the ranks' histories differ")
    hist = outs[0]["hist"]
    if len(hist) != MR_EPOCHS or not hist[-1]["val"] or not all(
            np.isfinite(v) for h in hist for s in ("train", "val")
            for v in h[s].values()):
        raise AssertionError(f"bad history {hist}")
    if not hist[0]["train"]["time_matching_loss"] > 0:
        raise AssertionError("no time-matching loss in the history")
    return outs


def write_mr_plate(root, well_raw, weights):
    """Two wells for run_pipeline's process and pca stages: phase 4's well
    (C5, 2,304 patches) and another of as many (D3), phase 4's z16
    weights, and the config."""
    from dynamorph_tpu_torch.io.pickles import save_pickle

    raw, supp = os.path.join(root, "raw"), os.path.join(root, "supp")
    os.makedirs(raw)
    for name in ("C5_file_paths.pkl", "C5_static_patches.pkl"):
        os.link(os.path.join(well_raw, name), os.path.join(raw, name))
    sites = ["C5-Site_0", "C5-Site_1", "D3-Site_0"]
    save_pickle([f"{supp}/D3-supps/D3-Site_0/{i // 2}_{i}.h5"
                 for i in range(N_PATCHES)],
                os.path.join(raw, "D3_file_paths.pkl"))
    save_pickle(blob_patches(np.random.RandomState(SEED + 17),
                             N_PATCHES)[:, :, None],
                os.path.join(raw, "D3_static_patches.pkl"))
    cfg = os.path.join(root, "cfg.yml")
    with open(cfg, "w") as f:
        f.write(f"patch:\n  raw_dirs: ['{raw}']\n  supp_dirs: ['{supp}']\n"
                f"  fov: {sites}\n"
                "latent_encoding:\n"
                f"  weights: ['{weights}']\n  save_output: False\n"
                "  network: 'VQ_VAE_z16'\n"
                f"  num_hiddens: {NET['num_hiddens']}\n"
                f"  num_residual_hiddens: {NET['num_residual_hiddens']}\n"
                f"  num_embeddings: {NET['num_embeddings']}\n"
                f"dim_reduction:\n  input_dirs: ['{raw}/weights']\n"
                f"  output_dirs: ['{raw}/weights']\n"
                f"  weights_dir: '{root}/pca'\n  fit_model: true\n"
                f"  file_name_prefixes: {list(MR_PIPE_WELLS)}\n"
                f"  conditions: {list(MR_PIPE_WELLS)}\n")
    return cfg, raw


def mr_pipeline_start(root, world, cards, well_raw, weights):
    """Three copies of a two-well plate for run_pipeline's process and pca
    stages; starts its ranks on one copy, and on another with a failure
    planted on rank 1. Returns what ``mr_pipeline_finish`` takes."""
    import shutil

    base = os.path.join(root, "mr_plate")
    write_mr_plate(base, well_raw, weights)
    dirs = {}
    for k in ("one", "ranks", "failed"):
        # hard links: the runs read the inputs and write new files only
        dirs[k] = os.path.join(root, f"mr_plate_{k}")
        shutil.copytree(base, dirs[k], copy_function=os.link)
        cfg = os.path.join(dirs[k], "cfg.yml")
        with open(cfg) as f:
            text = f.read().replace(base, dirs[k])
        os.remove(cfg)
        with open(cfg, "w") as f:
            f.write(text)
    return dirs, {mode: start_ranks(
        "pipeline", world, root, cards,
        (os.path.join(dirs[d], "cfg.yml"), mode), tag=mode)
        for mode, d in (("ok", "ranks"), ("fail", "failed"))}


def mr_pipeline_finish(torch, vq, world, dirs, started, tag):
    """run_pipeline in this process on the first copy while the ranks run,
    then the ranks' artifacts against it (latents, the PCA fitted once on
    rank 0) and every rank of the planted failure exiting non-zero."""
    from dynamorph_tpu_torch.cli import run_pipeline
    from dynamorph_tpu_torch.io.pickles import load_pickle
    from dynamorph_tpu_torch.reduce.pca_model import load_pca_model

    vq.vq_lookup.launches = 0
    t0 = time.perf_counter()
    one = run_pipeline.main(["-c", os.path.join(dirs["one"], "cfg.yml"),
                             "--stages", "process", "pca"])
    torch.cuda.synchronize()
    one_s, one_launches = time.perf_counter() - t0, vq.vq_lookup.launches
    res, logs = wait_ranks(started["ok"])
    ranks_s = time.perf_counter() - started["ok"][3]
    for r, (rc, _) in enumerate(res):
        if rc != 0:
            raise AssertionError(f"run_pipeline --multihost rank {r} exited "
                                 f"{rc}:\n{log_tail(logs[r])}")
    outs = [o for _, o in res]
    if list(one.values())[0] != ["process", "pca"] or \
            outs[0]["executed"] != ["process", "pca"] or \
            any(o["executed"] != ["process"] for o in outs[1:]):
        raise AssertionError("the PCA was not fitted once, on rank 0: "
                             f"{[o['executed'] for o in outs]}")
    owned = [log_tail(p, 400).count("owns wells") for p in logs]
    want = -(-N_PATCHES // BATCH)          # a well's batches
    launches = [o["launches"] for o in outs]
    if sum(launches) != 2 * want or max(launches) != want or \
            one_launches != 2 * want:
        raise AssertionError("vq_lookup launches: one process "
                             f"{one_launches}, ranks {launches}")
    worst, equal = 0.0, True
    for well in MR_PIPE_WELLS:
        for name in ("_latent_space.pkl", "_latent_space_after.pkl"):
            a = load_pickle(os.path.join(dirs["one"], "raw", "weights",
                                         well + name))
            b = load_pickle(os.path.join(dirs["ranks"], "raw", "weights",
                                         well + name))
            equal &= bool(np.array_equal(a, b))
            worst = max(worst, float(np.max(np.abs(a - b))))
    pa = load_pca_model(os.path.join(dirs["one"], "pca", "pca_model.pkl"))
    pb = load_pca_model(os.path.join(dirs["ranks"], "pca", "pca_model.pkl"))
    pca_err = float(np.max(np.abs(pa.components_ - pb.components_)))
    log(f"  run_pipeline --multihost (process, pca), {world} ranks, wells "
        f"{list(MR_PIPE_WELLS)}: {ranks_s:.3f} s from their start (one "
        f"process {one_s:.3f} s, meanwhile); executed "
        f"{[o['executed'] for o in outs]}; 'owns wells' logged by {owned}; "
        f"vq_lookup launches a rank {launches} (one process "
        f"{one_launches}); latents against one process: bit-equal {equal}, "
        f"max abs {worst:.3e}; PCA components max abs {pca_err:.3e}{tag}")
    if worst > LATENT_ATOL or pca_err > 1e-4 or \
            pa.components_.shape != pb.components_.shape:
        raise AssertionError("the ranks' artifacts differ from one "
                             "process's")
    res, logs = wait_ranks(started["fail"])
    fail_s = time.perf_counter() - started["fail"][3]
    rcs = [rc for rc, _ in res]
    planted = "planted on rank 1" in log_tail(logs[1], 60)
    named = "failed on rank(s) [1]" in log_tail(logs[0], 60)
    fitted = os.path.exists(os.path.join(dirs["failed"], "pca",
                                         "pca_model.pkl"))
    log(f"  planted failure on rank 1: exit codes {rcs} within {fail_s:.3f} "
        f"s of their start (rank 1 raised its error: {planted}; rank 0 "
        f"named rank 1: {named}); PCA fitted: {fitted}")
    if any(rc == 0 for rc in rcs) or not planted or not named or fitted:
        raise AssertionError("a failure on rank 1 did not fail every rank")
    return dict(ranks_s=ranks_s, one_s=one_s, fail_s=fail_s,
                launches=launches, bit_equal=equal)


def mr_within_process(torch, vq, dev, well_data, weights, tag):
    """The fan-out over a process's local devices: fit_pca_distributed on
    the plate's latents, and encode_patches; with one card, each also on
    [card, card] (two chunks on the one card) to run the sharded code."""
    from dynamorph_tpu_torch.core.mesh import local_devices
    from dynamorph_tpu_torch.models import VQVAEz16
    from dynamorph_tpu_torch.models.jax_import import (
        load_reference_checkpoint)
    from dynamorph_tpu_torch.pipeline.patch_vae import encode_patches
    from dynamorph_tpu_torch.reduce.pca import (fit_pca_device,
                                                fit_pca_distributed)

    devs = local_devices()
    fan = devs if len(devs) > 1 else [dev, dev]
    if len(devs) < 2:
        log(f"  local devices: {len(devs)}: fit_pca_distributed and "
            f"encode_patches take their one-device paths by default; the "
            f"sharded code runs on [card, card]{tag}")
    n = PLATE_WELLS * PLATE_PATCHES
    x = plate_latents(torch, dev, n, SEED + 10)
    xh = x.cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist_pca = fit_pca_distributed(xh, devices=fan)
    torch.cuda.synchronize()
    dist_s = time.perf_counter() - t0
    svd = fit_pca_device(xh, device=dev)
    var_err, ortho = pca_f64_errors(torch, x, dist_pca.mean_,
                                    dist_pca.components_,
                                    dist_pca.explained_variance_)
    k = min(len(svd.components_), len(dist_pca.components_))
    cos = np.abs(np.sum(svd.components_[:k] * dist_pca.components_[:k], 1))
    log(f"  fit_pca_distributed, plate {n} x {LATENT_LEN} over "
        f"{len(fan)} devices: {dist_s:.3f} s, k {len(dist_pca.components_)} "
        f"(the SVD fit's {len(svd.components_)}); float64: projected variance "
        f"{var_err:.3e}, C C^T - I {ortho:.3e}; |cos| to the SVD fit's "
        f"components min {cos.min():.8f}{tag}")
    if len(dist_pca.components_) != len(svd.components_) or \
            var_err > 1e-4 or ortho > 1e-4 or cos.min() < 1 - 1e-4:
        raise AssertionError("fit_pca_distributed disagrees with the SVD "
                             "fit or with float64")
    del x
    model = VQVAEz16(num_inputs=2, **NET)
    model.load_state_dict(load_reference_checkpoint(
        os.path.join(weights, "model.pt")), strict=True)
    data = well_data[:, :, 0]
    vq.vq_lookup.launches = 0
    zb, za = encode_patches(model, data, BATCH, normalize="patch",
                            device=dev, devices=fan)
    fan_launches = vq.vq_lookup.launches
    zb1, za1 = encode_patches(model, data, BATCH, normalize="patch",
                              device=dev)
    err = max(float(np.max(np.abs(zb - zb1))), float(np.max(np.abs(za - za1))))
    log(f"  encode_patches over {len(fan)} devices: {len(data)} patches, "
        f"{fan_launches} vq_lookup launches (a chunk a device a batch); "
        f"against one device max abs {err:.3e}{tag}")
    if err > LATENT_ATOL or fan_launches != len(fan) * -(-len(data) // BATCH):
        raise AssertionError("the fanned-out encode differs from one "
                             "device's")
    return dict(pca_s=dist_s, launches=fan_launches, encode_err=err)


def mr_kernel_times(torch, vq, dev, world, tag):
    """Each kernel at its per-rank shape of Slice F's paths: vq_indices on a
    rank's training rows (batch 768 / world) and vq_lookup on a rank's
    validation rows: device ms (CUDA graph) beside the bound, the plain
    version and the library yardstick (``torch.sum`` + ``addmm`` +
    ``argmin``, + ``index_select`` for the lookup), as phase 7 times them
    at the main path's shapes."""
    n, d, k = TRAIN_BATCH // world * 32 * 32, TRAIN_SHAPE[1], TRAIN_SHAPE[2]
    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    z = torch.randn(n, d, device=dev, generator=g)
    cb = torch.randn(k, d, device=dev, generator=g)

    def library_indices():
        e2 = torch.sum(cb * cb, dim=1)
        return torch.argmin(torch.addmm(e2, z, cb.T, beta=1.0, alpha=-2.0),
                            dim=1)

    def library_lookup():
        idx = library_indices()
        return torch.index_select(cb, 0, idx), idx

    out = {}
    for name, fn, plain, library, bnd in (
            ("vq_indices", lambda: vq._vq_indices_cuda(z, cb),
             lambda: vq.vq_indices_reference(z, cb), library_indices,
             indices_bound(n, d, k)),
            ("vq_lookup", lambda: vq._vq_lookup_cuda(z, cb),
             lambda: vq.vq_lookup_reference(z, cb), library_lookup,
             vq_bound(n, d, k))):
        ms = time_graph(torch, fn, 20)
        out[name] = dict(n=n, ms=ms, plain_ms=time_graph(torch, plain, 20),
                         library_ms=time_graph(torch, library, 20),
                         bound_ms=bnd[0], bound_by=bnd[1],
                         bound_share=bnd[0] / ms)
        log(f"  {name} at a rank's shape N={n} D={d} K={k}: {ms:.6f} ms "
            f"device, bound {bnd[0]:.6f} ms ({bnd[1]}), share "
            f"{bnd[0] / ms:.4f}; plain {out[name]['plain_ms']:.6f} ms, "
            f"library {out[name]['library_ms']:.6f} ms{tag}")
    return out


def phase_multirank(torch, vq, root, dev, card, well, weights):
    phase("16. multi-rank: run_training --multihost (VQ_VAE_z32, batch 768, "
          "the ring loss), data-parallel z32 and ResNet18 steps against one "
          "process, run_pipeline --multihost, the fan-out over local "
          "devices")
    from dynamorph_tpu_torch.models import VQVAEz32
    from dynamorph_tpu_torch.pipeline.patch_vae import _load_model_weights

    tag = f" [{card}]"
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()        # the ranks share the card
    cards = visible_cards()
    if len(cards) >= 2:
        world, backend = min(len(cards), MR_MAX_WORLD), "nccl"
        cards = cards[:world]
    else:
        world, backend = 2, "gloo"
    log(f"cards visible: {len(cards)}; world {world} over {backend}"
        + (" (two ranks share the card: NCCL refuses two ranks on one GPU; "
           "gloo's CUDA tensors cross through host memory)"
           if backend == "gloo" else ", one card a rank"))

    # training through the CLI
    cfg, out = mr_training_config(root, f"w{world}")
    n_val = int(np.floor(MR_VAL * N_TRAIN_PATCHES))
    steps = MR_EPOCHS * ((N_TRAIN_PATCHES - n_val) // TRAIN_BATCH)
    val = MR_EPOCHS * (n_val // TRAIN_BATCH)
    res, logs = run_ranks("train", world, root, cards, (cfg,))
    outs = mr_check_training(torch, res, logs, steps, val, tag)
    if outs[0]["backend"] != backend:
        raise AssertionError(f"backend {outs[0]['backend']}, want {backend}")
    n_files = sorted(os.listdir(out))
    fresh = VQVAEz32(**TRAIN_NET)
    _load_model_weights(fresh, os.path.join(out, "model.pt"))
    with open(os.path.join(out, "metrics.jsonl")) as f:
        n_lines = len(f.read().splitlines())
    if n_lines != 2 * MR_EPOCHS:
        raise AssertionError(f"metrics.jsonl has {n_lines} lines: a rank "
                             "other than 0 wrote")
    log(f"  history (the same on every rank): " + json.dumps(
        [{s: round(h[s]["total_loss"], 6) for s in ("train", "val")}
         for h in outs[0]["hist"]]) + f"; {out}: {n_files}, model.pt "
        f"loads strict, metrics.jsonl {n_lines} lines")
    vq_cfg = os.path.join(root, "mr_process.yml")
    with open(vq_cfg, "w") as f:
        f.write("latent_encoding:\n"
                f"  raw_dirs: ['{well['raw']}']\n"
                f"  supp_dirs: ['{os.path.join(root, 'supp')}']\n"
                f"  weights: ['{out}']\n  fov: ['C5-Site_0', 'C5-Site_1']\n"
                "  save_output: False\n  network: 'VQ_VAE_z32'\n"
                f"  num_hiddens: {TRAIN_NET['num_hiddens']}\n"
                f"  num_residual_hiddens: "
                f"{TRAIN_NET['num_residual_hiddens']}\n"
                f"  num_embeddings: {TRAIN_NET['num_embeddings']}\n")
    from dynamorph_tpu_torch.cli import run_vae

    vq.vq_lookup.launches = 0
    run_vae.main(["-m", "process", "-c", vq_cfg])
    torch.cuda.synchronize()
    process_launches = vq.vq_lookup.launches
    log(f"  run_vae -m process with the ranks' model.pt (VQ_VAE_z32): "
        f"{process_launches} vq_lookup launches")
    if process_launches != -(-N_PATCHES // BATCH):
        raise AssertionError("process did not encode with the trained "
                             "weights")
    nccl = None
    if backend == "gloo":
        # the NCCL code path, with one rank on the one card, alone so its
        # step is timed alone
        cfg1, _ = mr_training_config(root, "w1")
        res1, logs1 = run_ranks("train", 1, root, cards, (cfg1,), tag="w1")
        s1 = MR_EPOCHS * ((N_TRAIN_PATCHES - n_val) // TRAIN_BATCH)
        nccl = mr_check_training(torch, res1, logs1, s1, val, tag)[0]
        if nccl["backend"] != "nccl":
            raise AssertionError(f"one rank ran over {nccl['backend']}")

    # the step checks and both pipeline runs start together; this process
    # computes their one-process references meanwhile
    inp = mr_inputs(torch, world)
    torch.save(inp, os.path.join(root, "mr_inputs.pt"))
    t0 = time.perf_counter()
    started = start_ranks("steps", world, root, cards)
    dirs, pipe_started = mr_pipeline_start(root, world, cards, well["raw"],
                                           weights)
    one = dict(z32=mr_z32_steps(torch, None, inp, dev),
               triplet=mr_triplet_step(torch, None, inp, dev))
    res, logs = wait_ranks(started)
    steps_s = time.perf_counter() - t0
    for r, (rc, _) in enumerate(res):
        if rc != 0:
            raise AssertionError(f"step-check rank {r} exited {rc}:\n"
                                 f"{log_tail(logs[r])}")
    ranks = torch.load(os.path.join(root, "mr_ranks.pt"), weights_only=False)
    if any(o["losses"] != res[0][1]["losses"] or
           o["triplet_losses"] != res[0][1]["triplet_losses"]
           for _, o in res):
        raise AssertionError("the ranks' losses differ")
    log(f"  step checks ({world} ranks {steps_s:.3f} s beside the pipeline's "
        f"ranks; z32 {MR_STEPS} steps "
        f"of {MR_CHECK} patches, ResNet18 one step of {MR_CHECK}; "
        f"{ranks['z32']['kink_choices']} kink choices a rank a step, "
        f"one process's computed meanwhile):")
    loss_rel = max(abs(ranks["z32"]["losses"][0][k] - v) / max(abs(v), 1e-6)
                   for k, v in one["z32"]["losses"][0].items())
    loss_rel_t = max(abs(ranks["triplet"]["losses"][k] - v) /
                     max(abs(v), 1e-6)
                     for k, v in one["triplet"]["losses"].items())
    bn = max(float(torch.max(torch.abs(ranks["z32"]["bufs"][n] - b)))
             for n, b in one["z32"]["bufs"].items())
    log(f"  first step's losses, ranks vs one process: z32 {loss_rel:.3e}, "
        f"ResNet18 {loss_rel_t:.3e} relative (limit {STEP_LOSS_RTOL}); "
        f"running buffers after it max abs {bn:.3e} (limit "
        f"{STEP_BN_ATOL}){tag}")
    if loss_rel > STEP_LOSS_RTOL or loss_rel_t > STEP_LOSS_RTOL or \
            bn > STEP_BN_ATOL:
        raise AssertionError("the ranks' first step differs from one "
                             "process's")
    z_worst = mr_hold(f"z32 gradients over {MR_STEPS} steps",
                      ranks["z32"]["err"], one["z32"]["err"])
    z_ctrl = mr_hold("z32 TF32 control (backward in TF32)",
                     ranks["z32"]["err_control"], one["z32"]["err_first"],
                     limit_ok=False)
    t_worst = mr_hold("ResNet18 gradients", ranks["triplet"]["err"],
                      one["triplet"]["err"])
    t_ctrl = mr_hold("ResNet18 TF32 control", ranks["triplet"]["err_control"],
                     one["triplet"]["err"], limit_ok=False)

    pipe = mr_pipeline_finish(torch, vq, world, dirs, pipe_started, tag)
    within = mr_within_process(torch, vq, dev, well["data"], weights, tag)
    kt = mr_kernel_times(torch, vq, dev, world, tag)
    secs = time.perf_counter() - t_phase
    timing = outs[0]["timing"]
    log(f"phase 16: {secs:.1f} s; world {world} over {backend}; step at "
        f"batch {TRAIN_BATCH} {timing['step_ms']:.3f} ms a rank "
        f"({timing['rows']} rows), collectives share "
        f"{timing['collective_share']:.4f}, ring step "
        f"{timing['ring_bytes']:.0f} bytes"
        + (f"; one rank over NCCL {nccl['timing']['step_ms']:.3f} ms"
           if nccl else "") + tag)
    return dict(secs=secs, world=world, backend=backend, timing=timing,
                hist=outs[0]["hist"], out=out,
                nccl=None if nccl is None else nccl["timing"],
                launches=dict(vq_indices=outs[0]["launches"]["vq_indices"],
                              vq_lookup=outs[0]["launches"]["vq_lookup"]),
                steps=steps, process_launches=process_launches,
                pipeline=pipe, within=within, kernels=kt,
                step_check=dict(z32=z_worst, z32_control=z_ctrl,
                                triplet=t_worst, triplet_control=t_ctrl,
                                loss_rel=max(loss_rel, loss_rel_t), bn=bn))


# ---------------------------------------------------------------- phase 17
#
# The fan-out over a process's cards (Slice J). The driver's machine has one
# card, so every fan-out runs over [card, card]: the chunked, replicated and
# threaded code on the one card, held against the one-device path. The
# fused and streaming sites are phase 10's site cut to its first FAN_T
# frames, under two names in one well.
FAN_T = 4
FAN_SITES = ["B2-Site_0", "B2-Site_1"]
FAN_ENCODE = 1024           # phase 4's patches through ResNet50


def fan_timed(torch, fn):
    """(result, seconds) of ``fn()``, the card synchronised at both
    ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fan_segmentation(torch, root, dev, fan, tag):
    """Tiled and direct segmentation of phase 8's site over [card, card]
    against one device, phase 8's U-Net: the largest probability
    difference (phase 8's card limit) and whether it is bit-equal."""
    from dynamorph_tpu_torch.seg.inference import predict_whole_map

    frames = np.load(os.path.join(root, "seg_raw", "D4-Site_0.npy"))
    model = seg_model(torch, SEED, dev)
    out = {}
    for mode in ("tiled", "direct"):
        res = {}
        for name, devs in (("one", [dev]), ("fan", fan)):
            np.random.seed(SEED)
            res[name] = fan_timed(torch, lambda: predict_whole_map(
                frames, model, use_channels=[0, 1], n_supp=SEG_SUPP,
                mode=mode, devices=devs))
        err = float(np.max(np.abs(res["one"][0] - res["fan"][0])))
        bit = bool(np.array_equal(res["one"][0], res["fan"][0]))
        log(f"  {mode} segmentation of phase 8's site ({SEG_T} frames of "
            f"{SEG_FRAME}^2) over {len(fan)} devices: max |d prob| from one"
            f" device {err:.3e} (limit {SEG_PROB_ATOL:g}), bit-equal: {bit};"
            f" {res['one'][1]:.3f} s on one, {res['fan'][1]:.3f} s fanned "
            f"out{tag}")
        if not err <= SEG_PROB_ATOL:
            raise AssertionError(f"{mode} segmentation over {len(fan)} "
                                 f"devices {err:.3e} from one device")
        out[mode] = dict(err=err, bit_equal=bit, one_s=res["one"][1],
                         fan_s=res["fan"][1])
    return out


def fan_resnet(torch, dev, fan, data, tag):
    """ResNet50's ``encode_batched`` of phase 4's patches at batch 512 over
    [card, card] against one device (1e-5 of max |z|, phase 12's card
    limit)."""
    from dynamorph_tpu_torch.models.resnet_simclr import EncodeProject
    from dynamorph_tpu_torch.train.data import zscore_patch

    torch.manual_seed(SEED)
    model = EncodeProject(arch="ResNet50").to(dev)
    x = zscore_patch(data[:FAN_ENCODE, :, 0]).astype(np.float32)
    one, one_s = fan_timed(torch, lambda: model.encode_batched(
        x, batch_size=BATCH, devices=[dev]))
    two, fan_s = fan_timed(torch, lambda: model.encode_batched(
        x, batch_size=BATCH, devices=fan))
    err = float(np.max(np.abs(one - two)))
    limit = E1_ENCODE_ATOL * float(np.abs(one).max())
    log(f"  ResNet50 encode_batched of {len(x)} patches at batch {BATCH} "
        f"over {len(fan)} devices: max |d z| from one device {err:.3e} "
        f"(limit {limit:.3e}), bit-equal: {bool(np.array_equal(one, two))};"
        f" {one_s:.3f} s on one, {fan_s:.3f} s fanned out{tag}")
    if not err <= limit:
        raise AssertionError("the fanned-out ResNet50 encode differs from "
                             "one device's")
    return dict(err=err, one_s=one_s, fan_s=fan_s)


def fan_sites(root, raw10):
    """A raw dir holding phase 10's site cut to FAN_T frames under both of
    FAN_SITES' names."""
    raw = os.path.join(root, "fan_raw")
    os.makedirs(raw)
    frames = np.load(os.path.join(raw10, f"{FE_SITE}.npy"), mmap_mode="r")
    np.save(os.path.join(raw, f"{FAN_SITES[0]}.npy"),
            np.ascontiguousarray(frames[:FAN_T]))
    for site in FAN_SITES[1:]:
        os.symlink(os.path.join(raw, f"{FAN_SITES[0]}.npy"),
                   os.path.join(raw, f"{site}.npy"))
    return raw


def fan_config(root, staged, weights, streaming):
    """Phase 11's configuration of the fused stage and the stream."""
    cfg = os.path.join(root, f"fan_{streaming}.yml")
    with open(cfg, "w") as f:
        f.write("segmentation_inference:\n"
                f"  weights: '{staged['seg_weights']}'\n"
                "  network: 'UNet'\n  channels: [0, 1]\n"
                f"  num_classes: 3\n  window_size: {SEG_WINDOW}\n"
                "patch:\n"
                f"  channels: [0, 1]\n  window_size: {FE_WINDOW}\n"
                "  fused: true\n"
                "latent_encoding:\n"
                f"  weights: ['{weights}']\n  save_output: False\n"
                f"  channels: [0, 1]\n  input_size: {FE_INPUT}\n"
                "  network: 'VQ_VAE_z16'\n"
                f"  num_hiddens: {NET['num_hiddens']}\n"
                f"  num_residual_hiddens: {NET['num_residual_hiddens']}\n"
                f"  num_embeddings: {NET['num_embeddings']}\n"
                f"  streaming: {streaming}\n")
    from dynamorph_tpu_torch.config.loader import load_config

    return load_config(cfg)


def fan_check_site(supp, site, supp10, planted_t, raw, tag=""):
    """One fanned-out site's artifacts against phase 10's staged run of
    the same frames (phase 11's one-device run equals that run): the
    site pickles for t < FAN_T, every frame's stacks (names under the
    site), the instance maps byte for byte and the probabilities (the
    planted ones). Returns the number of files compared."""
    from dynamorph_tpu_torch.io.pickles import load_pickle

    a = os.path.join(supp, "B2-supps", site)
    b = os.path.join(supp10, "B2-supps", FE_SITE)
    n = 0
    for name in ("cell_positions.pkl", "cell_pixel_assignments.pkl"):
        ref = load_pickle(os.path.join(b, name))
        same(load_pickle(os.path.join(a, name)),
             {t: ref[t] for t in range(FAN_T)}, f"{site} {name}")
        n += 1
    for t in range(FAN_T):
        same({os.path.basename(k): v for k, v in load_pickle(
                os.path.join(a, f"stacks_{t}.pkl")).items()},
             {os.path.basename(k): v for k, v in load_pickle(
                os.path.join(b, f"stacks_{t}.pkl")).items()},
             f"{site} stacks_{t}")
        with open(os.path.join(a, f"segmentation_{t}.png"), "rb") as fa, \
                open(os.path.join(b, f"segmentation_{t}.png"), "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"{site} segmentation_{t}.png differs")
        n += 2
    probs = np.load(os.path.join(raw, f"{site}_NNProbabilities.npy"))
    if not np.array_equal(probs, planted_t):
        raise AssertionError(f"{site}: the probabilities are not the "
                             "planted ones")
    return n + 1


def fan_fused(torch, root, dev, fan, staged, weights, tag):
    """``seg_patch_fused`` over both sites with frames over [card, card],
    at site parallelism 1 and 2 (traced): the artifacts against phase 10's
    (phase 11's one-device run equals them), each site's wall
    (``stage_timer``) and the call's host share (torch.profiler)."""
    import shutil

    from dynamorph_tpu_torch.pipeline import fused
    from dynamorph_tpu_torch.seg.model import Segment
    from torch.profiler import ProfilerActivity, profile

    raw10, supp10 = staged["dirs"]
    planted = np.load(staged["probs_path"])[:FAN_T].astype(np.float32)
    raw = fan_sites(root, raw10)
    config = fan_config(root, staged, weights, False)
    unet = Segment(input_shape=(2, SEG_WINDOW, SEG_WINDOW), n_classes=3,
                   device=dev)
    unet.load(staged["seg_weights"])
    model = PlantedSegment(unet)
    runs = {}
    for k in (1, 2):
        supp = os.path.join(root, f"fan_supp_{k}")
        timing_log = os.path.join(root, f"fan_timing_{k}.jsonl")
        os.environ["DYNAMORPH_TIMING_LOG"] = timing_log
        errors = ErrorRecords()
        logging.getLogger().addHandler(errors)
        model.calls = 0
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                failed, wall = fan_timed(torch, lambda: fused.seg_patch_fused(
                    raw, supp, FAN_SITES, config, model=model, device=dev,
                    devices=fan, site_parallelism=k))
        finally:
            logging.getLogger().removeHandler(errors)
            del os.environ["DYNAMORPH_TIMING_LOG"]
        if failed or errors.messages:
            raise AssertionError(f"site parallelism {k}: failed {failed}, "
                                 f"errors {errors.messages}")
        if model.calls != FAN_T * len(FAN_SITES):
            raise AssertionError(f"the U-Net ran {model.calls} times")
        busy = merged((e.time_range.start, e.time_range.end)
                      for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.is_user_annotation)
        del prof
        busy_s = sum(b - a for a, b in busy) / 1e6 if busy else None
        with open(timing_log) as f:
            site_s = {r["site"]: r["seconds"] for r in map(json.loads, f)
                      if r.get("stage") == "seg_patch_fused"}
        n = sum(fan_check_site(supp, s, supp10, planted, raw)
                for s in FAN_SITES)
        share = "not measured (no device event)" if busy_s is None else \
            f"{1 - busy_s / wall:.4f}"
        log(f"  seg_patch_fused, {len(FAN_SITES)} sites of {FAN_T} frames "
            f"of {FE_FRAME}^2, frames over {len(fan)} devices, site "
            f"parallelism {k}: {wall:.3f} s ({wall / len(FAN_SITES):.3f} s "
            f"a site; each site's own wall " + ", ".join(
                f"{s} {v:.3f} s" for s, v in site_s.items()) +
            f"), device busy {busy_s if busy_s is None else round(busy_s, 4)}"
            f" s, host share {share}; {n} artifacts equal to phase 10's "
            f"staged run of the same frames{tag}")
        runs[k] = dict(wall=wall, per_site=wall / len(FAN_SITES),
                       site_s=site_s, busy_s=busy_s,
                       host_share=None if busy_s is None
                       else 1 - busy_s / wall, files=n)
        shutil.rmtree(supp)
    return raw, config, runs


def fan_stream(torch, vq, root, dev, fan, raw, staged, weights, tag):
    """``seg_patch_stream`` over both sites, frames over [card, card] and
    two site groups: the latents against phase 10's rows of the same
    patches (z_before within phase 4's limit, z_after on the same codes
    but at float64-verified near-ties), and the vq_lookup launches by
    device."""
    import shutil

    from dynamorph_tpu_torch.io.pickles import load_pickle
    from dynamorph_tpu_torch.pipeline import stream
    from dynamorph_tpu_torch.seg.model import Segment

    raw10, supp10 = staged["dirs"]
    config = fan_config(root, staged, weights, True)
    saved = stream.build_seg_model

    def planted_model(config, device):
        unet = Segment(input_shape=(2, SEG_WINDOW, SEG_WINDOW), n_classes=3,
                       device=device)
        unet.load(staged["seg_weights"])
        return PlantedSegment(unet)

    stream.build_seg_model = planted_model
    supp = os.path.join(root, "fan_stream_supp")
    vq.vq_lookup.launches = 0
    vq.vq_lookup.launches_by_device.clear()
    vq.vq_indices.launches = 0
    try:
        _, wall = fan_timed(torch, lambda: stream.seg_patch_stream(
            raw, supp, FAN_SITES, config, patch_type="mat", device=dev,
            devices=fan, site_parallelism=2))
    finally:
        stream.build_seg_model = saved
    launches = {"vq_lookup": vq.vq_lookup.launches,
                "vq_indices": vq.vq_indices.launches}
    by_device = dict(vq.vq_lookup.launches_by_device)
    model_name = os.path.basename(weights)
    fs = [os.path.relpath(f, supp) for f in load_pickle(
        os.path.join(raw, "B2_file_paths.pkl"))]
    z_b, z_a = (load_pickle(os.path.join(raw, model_name, f"B2_{n}.pkl"))
                for n in ("latent_space", "latent_space_after"))
    fs10 = {os.path.relpath(f, supp10): i for i, f in enumerate(load_pickle(
        os.path.join(raw10, "B2_file_paths.pkl")))}
    r_b, r_a = (load_pickle(os.path.join(raw10, model_name, f"B2_{n}.pkl"))
                for n in ("latent_space", "latent_space_after"))
    rows = [fs10[f.replace(FAN_SITES[1], FE_SITE)] for f in fs]
    want = sum(1 for f in fs10 if int(os.path.basename(f).split("_")[0])
               < FAN_T) * len(FAN_SITES)
    if len(fs) != want:
        raise AssertionError(f"streamed {len(fs)} patches, want {want}")
    r_b, r_a = r_b[rows], r_a[rows]
    err = float(np.max(np.abs(z_b - r_b)))
    if not err <= LATENT_ATOL:
        raise AssertionError(f"streamed z_before {err:.3e} from phase 10's")
    cb = torch.load(os.path.join(weights, "model.pt"))["vq.w.weight"].cpu()

    def code_rows(z):
        return torch.from_numpy(z).reshape(-1, 16, 256).permute(0, 2, 1) \
            .reshape(-1, 16)

    idx, idx_ref = codes_of(torch, code_rows(z_a), cb), \
        codes_of(torch, code_rows(r_a), cb)
    flips = torch.nonzero(idx != idx_ref).flatten()
    if len(flips):
        check_flips_vs_latents(torch, "fan-out stream",
                               code_rows(r_b)[flips], code_rows(z_b)[flips],
                               cb[idx_ref[flips]], cb[idx[flips]])
    want_l = -(-len(fs) // BATCH)
    if launches != {"vq_lookup": want_l, "vq_indices": 0} or \
            sum(by_device.values()) != want_l:
        raise AssertionError(f"stream launches {launches} {by_device}, want "
                             f"{want_l} vq_lookup")
    bit = bool(np.array_equal(z_b, r_b) and np.array_equal(z_a, r_a))
    log(f"  seg_patch_stream, {len(FAN_SITES)} sites, frames over "
        f"{len(fan)} devices, 2 site groups: {wall:.3f} s; {len(fs)} "
        f"patches; vq_lookup launches {launches['vq_lookup']} by device "
        f"{json.dumps(by_device)}, vq_indices {launches['vq_indices']}; "
        f"latents vs phase 10's rows of the same patches: z_before max abs "
        f"{err:.3e} (limit {LATENT_ATOL}), {len(flips)} z_after code flips "
        f"(near-ties), bit-equal: {bit}{tag}")
    shutil.rmtree(supp)
    return dict(wall=wall, launches=launches, by_device=by_device,
                n_patches=len(fs), err=err, flips=len(flips), bit_equal=bit)


def fan_plots(root, tag):
    """Every ``analysis.plots`` function writes its file here, where
    matplotlib, seaborn, pandas and imageio are not installed."""
    from dynamorph_tpu_torch.analysis import plots

    out = os.path.join(root, "plots")
    os.makedirs(out)
    rng = np.random.RandomState(SEED)
    frame = rng.randint(0, 65536, (256, 256)).astype(np.uint16)
    pos = np.argwhere(rng.rand(256, 256) > 0.9)
    track = 128 + np.cumsum(rng.randint(-6, 7, (10, 2)), 0)
    emb = rng.randn(2000, 2)

    def p(name):
        return os.path.join(out, name)

    t0 = time.perf_counter()
    files = plots.plot_patches(rng.randint(0, 65536, (3, 64, 64)), out)
    files += [
        plots.save_patch_movie(rng.randint(0, 65536, (5, 64, 64)),
                               p("movie.gif")),
        plots.plot_class_probabilities(rng.rand(3, 128, 128), p("cp.png")),
        plots.plot_instance_separation(frame, pos,
                                       rng.randint(-1, 8, len(pos)),
                                       p("is.png")),
        plots.draw_cell_boxes(frame, [(30, 40), (200, 250)], p("bx.png")),
        plots.plot_frame_matching(frame, frame, rng.rand(5, 2) * 255,
                                  rng.rand(5, 2) * 255, [(0, 1), (2, 3)],
                                  p("fm.png")),
        plots.plot_trajectory_on_frame(frame, track, p("tr.png")),
        plots.plot_embedding_scatter(emb, p("es.png"),
                                     labels=np.repeat([0, 1], 1000)),
        plots.plot_explained_variance(np.sort(rng.rand(20))[::-1] / 20,
                                      p("ev.png")),
        plots.plot_pc_vs_property(emb[:, 0], rng.rand(2000) + 0.1,
                                  p("pp.png"), density=True),
        plots.plot_correlation_matrix(emb, {"a": rng.randn(2000)},
                                      p("cm.png")),
        plots.plot_distribution_comparison(emb[:200, 0], emb[:, 0],
                                           p("dc.png")),
        plots.plot_joint_kde(emb[:500, 0], emb[:500, 1], p("jk.png")),
        plots.plot_violin_modes({"a": emb[:, 0], "b": emb[:, 1] + 1},
                                p("vm.png"))]
    secs = time.perf_counter() - t0
    small = [f for f in files if os.path.getsize(f) < 100]
    missing = [m for m in ("matplotlib", "seaborn", "pandas", "imageio")
               if m in sys.modules]
    if small:
        raise AssertionError(f"figures not written: {small}")
    log(f"  analysis.plots: {len(files)} files from every function in "
        f"{secs:.3f} s; matplotlib, seaborn, pandas, imageio imported: "
        f"{missing or 'none'}{tag}")
    return dict(files=len(files), secs=secs)


def phase_fan_out(torch, vq, root, dev, card, staged, weights, well_data):
    phase("17. the fan-out over a process's cards: tiled and direct "
          "segmentation, the ResNet50 batched encode, seg_patch_fused's "
          "frame and site groups, the streaming encode, and the figures")
    from dynamorph_tpu_torch.core.mesh import local_devices

    tag = f" [{card}]"
    t_phase = time.perf_counter()
    devs = local_devices()
    fan = devs if len(devs) > 1 else devs * 2
    log(f"  local devices: {len(devs)}; the fan-outs run over {len(fan)} "
        f"entries ({', '.join(str(d) for d in fan)}){tag}")
    seg = fan_segmentation(torch, root, dev, fan, tag)
    resnet = fan_resnet(torch, dev, fan, well_data, tag)
    raw, _, fused_runs = fan_fused(torch, root, dev, fan, staged, weights,
                                   tag)
    streamed = fan_stream(torch, vq, root, dev, fan, raw, staged, weights,
                          tag)
    figures = fan_plots(root, tag)
    secs = time.perf_counter() - t_phase
    log(f"phase 17 took {secs:.1f} s")
    return dict(secs=secs, seg=seg, resnet=resnet, fused=fused_runs,
                stream=streamed, figures=figures)


# ---------------------------------------------------------------- phase 18
#
# Slice K: run_training over the process's devices (one local rank a device;
# on a machine with one card two gloo ranks share it, as phase 16's ranks
# do), KAZE on the card against the CPU, the configured tile bucket
# through run_segmentation, and the figures at thickness 1 and -1 with a
# colour map outside the six tables the figures had before.
LR_WORLD = 2
KAZE_PATCHES = 64
KAZE_LDET_RTOL = 1e-4       # card vs CPU, max |d det| over max |det|
KAZE_PT_TOL = 0.5           # the oracle test's limits (tests/
KAZE_SIZE_RTOL = 0.05       # test_torch_kaze_oracle.py)
KAZE_ANGLE_TOL = 0.1
KAZE_UNMATCHED_MAX = 0.05
KAZE_DESC_TOL = 0.05
SEG_BUCKET = 16
LR_STATS = "ph18_rank{}.json"


def local_rank_counted(config, seed):
    """One local rank of phase 18's ``run_training.run``: the port's own
    rank body (``run_training._local_rank_main``) with the kernels'
    launches counted and, after it, MR_TIMED data-parallel steps timed;
    both written beside the rank's output. Returns the history."""
    import torch
    import torch.distributed as dist

    from dynamorph_tpu_torch.cli import run_training
    from dynamorph_tpu_torch.core import mesh
    from dynamorph_tpu_torch.ops import vq

    torch.set_num_threads(MR_THREADS)
    vq.vq_indices.launches = vq.vq_lookup.launches = 0
    bn_zero()
    t0 = time.perf_counter()
    with deterministic_cudnn(torch):
        hist = run_training._local_rank_main(config, seed)
    torch.cuda.synchronize()
    bn = bn_counted()
    out = dict(rank=mesh.process_index(), world=mesh.process_count(),
               backend=dist.get_backend(), device=str(mesh.rank_device()),
               wall=time.perf_counter() - t0,
               launches=dict(vq_indices=vq.vq_indices.launches,
                             vq_lookup=vq.vq_lookup.launches,
                             batch_norm=bn[0], batch_norm_fallbacks=bn[1]))
    out["timing"] = mr_timed_steps(torch, mesh.rank_device())
    with open(os.path.join(config.training.weights_dirs[-1],
                           LR_STATS.format(out["rank"])), "w") as f:
        json.dump(out, f)
    return hist


def ph18_training(torch, vq, root, dev, multirank, train_run, tag):
    """``run_training.run(devices=[card] * LR_WORLD)`` on phase 16's
    config against phase 16's two-rank ``--multihost`` run, both from the
    same start weights with cuDNN's deterministic algorithms: the history
    and model.pt bit for bit, else within phase 16's step limits (losses
    STEP_LOSS_RTOL, buffers STEP_BN_ATOL) and Adam's reach (a step moves
    a weight by about lr either way); launches and a step's time a
    rank."""
    from dynamorph_tpu_torch.cli import run_training
    from dynamorph_tpu_torch.config import load_config
    from dynamorph_tpu_torch.core import mesh

    cfg_path, out = mr_training_config(root, "local")
    cfg = load_config(cfg_path)
    n_val = int(np.floor(MR_VAL * N_TRAIN_PATCHES))
    steps = MR_EPOCHS * ((N_TRAIN_PATCHES - n_val) // TRAIN_BATCH)
    val = MR_EPOCHS * (n_val // TRAIN_BATCH)
    # the ranks unpickle the body by module name: this script's, not
    # __main__'s
    import chip_smoke

    real = run_training._local_rank_main
    run_training._local_rank_main = chip_smoke.local_rank_counted
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = str(MR_THREADS)   # as phase 16's ranks
    vq.vq_indices.launches = vq.vq_lookup.launches = 0
    try:
        np.random.seed(SEED)
        t0 = time.perf_counter()
        model, hist = run_training.run(cfg, devices=[dev] * LR_WORLD)
        wall = time.perf_counter() - t0
    finally:
        run_training._local_rank_main = real
        if threads is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    here = (vq.vq_indices.launches, vq.vq_lookup.launches)
    ranks = []
    for r in range(LR_WORLD):
        with open(os.path.join(root, "mr_train_out_local",
                               LR_STATS.format(r))) as f:
            ranks.append(json.load(f))
    for o in ranks:
        log(f"  local rank {o['rank']}/{o['world']} on {o['device']} over "
            f"{o['backend']}: vq_indices {o['launches']['vq_indices']} (want "
            f"{steps}), vq_lookup {o['launches']['vq_lookup']} (want {val}), "
            f"batch_norm {o['launches']['batch_norm']} and its fallbacks "
            f"{o['launches']['batch_norm_fallbacks']} (want 0: the ranks "
            f"take the cross-rank statistics); "
            f"step at batch {TRAIN_BATCH} ({o['timing']['rows']} rows a "
            f"rank) {o['timing']['step_ms']:.3f} ms, collectives share "
            f"{o['timing']['collective_share']:.4f}{tag}")
        if o["launches"] != dict(vq_indices=steps, vq_lookup=val,
                                 batch_norm=0, batch_norm_fallbacks=0):
            raise AssertionError("a local rank did not launch vq_indices "
                                 "once a step and vq_lookup once a "
                                 "validation step, or ran a batch norm on "
                                 "its own rows")
    if here != (0, 0) or ranks[0]["backend"] != "gloo":
        raise AssertionError(f"the run trained in this process ({here}) or "
                             f"over {ranks[0]['backend']}")
    # phase 5 ran run_training with devices=None on the one card: in this
    # process, its launches counted here
    if len(mesh.fan_out_devices(None, dev)) != 1 or \
            train_run["launches_indices"] == 0:
        raise AssertionError("devices=None did not train in this process")
    want = multirank["hist"]
    loss_rel = max(abs(h[s][k] - w[s][k]) / max(abs(w[s][k]), 1e-6)
                   for h, w in zip(hist, want) for s in ("train", "val")
                   for k in w[s])
    a = torch.load(os.path.join(multirank["out"], "model.pt"),
                   weights_only=True)
    b = torch.load(os.path.join(out, "model.pt"), weights_only=True)
    params = dict(model.named_parameters())
    w_err = max(float((a[k].float() - b[k].float()).abs().max())
                for k in a if k in params)
    buf_err = max([float((a[k].float() - b[k].float()).abs().max())
                   for k in a if k not in params] or [0.0])
    sd = model.state_dict()
    returned = all(torch.equal(sd[k].cpu(), v) for k, v in b.items())
    bit = len(hist) == len(want) and hist == want and all(
        torch.equal(a[k], b[k]) for k in a)
    w_limit = 2 * steps * 1e-4          # Adam at lr 1e-4, either run
    log(f"  run_training.run(devices=[{dev}] x {LR_WORLD}): {wall:.3f} s; "
        f"against phase 16's {multirank['world']} ranks over "
        f"{multirank['backend']}: bit-equal {bit}; losses {loss_rel:.3e} "
        f"relative (limit {STEP_LOSS_RTOL}), weights {w_err:.3e} (limit "
        f"{w_limit:.1e}), buffers {buf_err:.3e} (limit {STEP_BN_ATOL}); the "
        f"returned model is rank 0's model.pt: {returned}{tag}")
    if not returned or len(hist) != len(want) or not bit and not (
            loss_rel <= STEP_LOSS_RTOL and w_err <= w_limit
            and buf_err <= STEP_BN_ATOL):
        raise AssertionError("the local ranks' run differs from phase 16's")
    return dict(wall=wall, bit_equal=bit, loss_rel=loss_rel, w_err=w_err,
                buf_err=buf_err, ranks=ranks,
                launches=[o["launches"] for o in ranks])


def kaze_match(a, b):
    """One-to-one matches of keypoints ``a`` to ``b`` (``kaze.KeyPoints``)
    within the oracle test's position, size and angle limits: the number
    matched and the pairs."""
    used, pairs = set(), []
    for i in range(len(a)):
        d = np.hypot(b.pt[:, 0] - a.pt[i, 0], b.pt[:, 1] - a.pt[i, 1])
        rs = np.abs(b.size - a.size[i]) / a.size[i]
        da = np.deg2rad((b.angle.astype(np.float64) - a.angle[i]) % 360.0)
        da = np.minimum(da, 2 * np.pi - da)
        for j in np.argsort(d, kind="stable"):
            if d[j] > KAZE_PT_TOL:
                break
            if rs[j] <= KAZE_SIZE_RTOL and da[j] <= KAZE_ANGLE_TOL and \
                    j not in used:
                used.add(j)
                pairs.append((i, j))
                break
    return pairs


def ph18_kaze(torch, dev, data, tag):
    """``extract_features`` of KAZE_PATCHES of phase 4's patches on the
    card (seconds a patch), and the card's scale space, keypoints and
    descriptors against the CPU's on the same slices, with a TF32
    control."""
    import contextlib

    from dynamorph_tpu_torch.analysis import kaze
    from dynamorph_tpu_torch.analysis.morphology import extract_features

    patches = data[:KAZE_PATCHES, :, 0]
    extract_features(patches[0], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = [extract_features(p, device=dev) for p in patches]
    torch.cuda.synchronize()
    per_patch = (time.perf_counter() - t0) / len(patches)
    if any(f is None or f.shape != (2, 32 * 64) for f in feats):
        raise AssertionError("extract_features failed on the card")
    stack = torch.from_numpy(patches.astype("uint8").reshape(
        -1, *patches.shape[-2:]))
    card = kaze.scale_space(stack.to(dev))
    cpu = kaze.scale_space(stack)
    scale = float(cpu.ldet.abs().max())
    ldet_err = float((card.ldet.cpu() - cpu.ldet).abs().max()) / scale

    @contextlib.contextmanager
    def tf32():
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved

    strict, kaze.fp32_strict = kaze.fp32_strict, tf32
    try:
        control = float((kaze.scale_space(stack.to(dev)).ldet.cpu()
                         - cpu.ldet).abs().max()) / scale
    finally:
        kaze.fp32_strict = strict
    card_kp = kaze.describe(card, kaze.detect(card))
    cpu_kp = kaze.describe(cpu, kaze.detect(cpu))
    n = n_matched = 0
    desc_err = 0.0
    for (kc, dc), (kp, dp) in zip(card_kp, cpu_kp):
        top = np.argsort(-kp.response, kind="stable")[:32]
        pairs = kaze_match(kp.take(top), kc)
        n += len(top)
        n_matched += len(pairs)
        desc_err = max([desc_err] + [float(np.linalg.norm(dp[top[i]] - dc[j]))
                                     for i, j in pairs])
    unmatched = 1 - n_matched / max(n, 1)
    log(f"  KAZE: extract_features {per_patch:.4f} s a patch on the card "
        f"({len(patches)} patches of 2 x {patches.shape[-1]}^2); card vs CPU"
        f" on their {len(stack)} slices: Hessian determinant {ldet_err:.3e}"
        f" of its largest (limit {KAZE_LDET_RTOL:g}; TF32 control "
        f"{control:.3e}), the CPU's {n} strongest keypoints unmatched "
        f"{unmatched:.4f} (limit {KAZE_UNMATCHED_MAX}), matched descriptors"
        f" {desc_err:.3e} in L2 (limit {KAZE_DESC_TOL}){tag}")
    if not ldet_err <= KAZE_LDET_RTOL or not unmatched <= KAZE_UNMATCHED_MAX \
            or not desc_err <= KAZE_DESC_TOL:
        raise AssertionError("KAZE on the card differs from the CPU")
    if not control > KAZE_LDET_RTOL:
        raise AssertionError("the TF32 control did not land over its limit")
    return dict(s_per_patch=per_patch, ldet_err=ldet_err, control=control,
                unmatched=unmatched, desc_err=desc_err, keypoints=n)


def ph18_segmentation(torch, root, dev, tag):
    """``run_segmentation -m segmentation`` with ``batch_size:
    SEG_BUCKET`` on phase 8's site over [card, card]: every pass's padded
    batch as dynamorph_tpu/seg/inference.py:33-39 pads it, and the
    probabilities against one device's tiled run (phase 8's) within
    SEG_PROB_ATOL."""
    from dynamorph_tpu_torch.cli import run_segmentation
    from dynamorph_tpu_torch.core import mesh
    from dynamorph_tpu_torch.seg import inference

    src = os.path.join(root, "seg_raw", "D4-Site_0.npy")
    raw = os.path.join(root, "seg_raw18")
    os.makedirs(raw)
    os.link(src, os.path.join(raw, "D4-Site_0.npy"))
    cfg = os.path.join(root, "seg_bucket.yml")
    with open(os.path.join(root, "seg_tiled.yml")) as f:
        text = f.read()
    with open(cfg, "w") as f:
        f.write(text.replace("seg_raw", "seg_raw18").replace(
            "batch_size: 8", f"batch_size: {SEG_BUCKET}"))
    padded = []
    fanned, local = inference._predict_fanned_out, mesh.local_devices

    def spy(model, batch, devices):
        padded.append(len(batch))
        return fanned(model, batch, devices)
    inference._predict_fanned_out = spy
    mesh.local_devices = lambda: [dev, dev]
    try:
        np.random.seed(SEED)
        t0 = time.perf_counter()
        run_segmentation.main(["-m", "segmentation", "-c", cfg,
                               "--device", dev.type])
        wall = time.perf_counter() - t0
    finally:
        inference._predict_fanned_out, mesh.local_devices = fanned, local
    got = np.load(os.path.join(raw, "D4-Site_0_NNProbabilities.npy"))
    n = SEG_FRAME // SEG_WINDOW
    bucket = max(SEG_BUCKET, 2) - max(SEG_BUCKET, 2) % 2
    want_pad = [-(-k // bucket) * bucket
                for k in [n * n] + [(n - 1) ** 2] * SEG_SUPP] * SEG_T
    frames = np.load(src)
    model = seg_model(torch, SEED, dev)
    np.random.seed(SEED)
    one = inference.predict_whole_map(frames, model, use_channels=[0, 1],
                                      n_supp=SEG_SUPP, devices=[dev])
    err = float(np.max(np.abs(got - one)))
    log(f"  run_segmentation, batch_size {SEG_BUCKET}, over [card, card]: "
        f"{wall:.3f} s; padded batches {padded} (the JAX rule: "
        f"{want_pad}); max |d prob| from one device {err:.3e} (limit "
        f"{SEG_PROB_ATOL:g}){tag}")
    if padded != want_pad or not err <= SEG_PROB_ATOL:
        raise AssertionError("the configured tile bucket was not used")
    return dict(padded=padded, err=err, wall=wall)


def ph18_figures(root, tag):
    """The box and trajectory figures at thickness 1 and cv2.FILLED (-1),
    and a scatter in a colour map outside the earlier six, written here;
    their pixels read back."""
    from dynamorph_tpu_torch.analysis import plots
    from dynamorph_tpu_torch.analysis.raster import colormap_lut
    from dynamorph_tpu_torch.io.png import read_png

    out = os.path.join(root, "plots18")
    os.makedirs(out)
    rng = np.random.RandomState(SEED + 18)
    frame = np.zeros((128, 128), np.uint16)
    files = {}
    for th in (1, -1):
        files[f"boxes{th}"] = plots.draw_cell_boxes(
            frame, [(64, 64)], os.path.join(out, f"bx{th}.png"), half=10,
            colors=[(255, 0, 0)], thickness=th)
    files["track1"] = plots.plot_trajectory_on_frame(
        frame, np.array([[64, 20], [64, 100]]), os.path.join(out, "tr.png"),
        color=(0, 255, 0), thickness=1, origin=np.zeros(2, np.int64))
    files["magma"] = plots.plot_embedding_scatter(
        rng.randn(500, 2), os.path.join(out, "es.png"),
        values=rng.rand(500), cmap="magma")
    thin = read_png(files["boxes1"])
    filled = read_png(files["boxes-1"])
    track = read_png(files["track1"])
    lut = colormap_lut("magma")
    checks = {
        "thin box: one-pixel rim, empty inside":
            int((thin.max(2) > 0).sum()) == 80 and not thin[60, 64].any(),
        "filled box: 21 x 21 pixels": int((filled.max(2) > 0).sum()) == 441,
        "thin track: one row of 81 pixels":
            int((track.max(2) > 0).sum()) == 81,
        "magma table: 256 colours": lut.shape == (256, 3),
    }
    log(f"  figures at thickness 1 and -1 and in magma: "
        + ", ".join(f"{k} {v}" for k, v in checks.items()) + tag)
    if not all(checks.values()):
        raise AssertionError(f"the figures' pixels: {checks}")
    return dict(checks=checks)


def phase_slice_k(torch, vq, root, dev, card, multirank, train_run,
                  well_data):
    phase("18. run_training over the local devices (two ranks on the card), "
          "KAZE on the card, the configured tile bucket, thin and filled "
          "lines and every colour map")
    tag = f" [{card}]"
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()        # the ranks share the card
    training = ph18_training(torch, vq, root, dev, multirank, train_run, tag)
    kz = ph18_kaze(torch, dev, well_data, tag)
    seg = ph18_segmentation(torch, root, dev, tag)
    figures = ph18_figures(root, tag)
    secs = time.perf_counter() - t_phase
    log(f"phase 18 took {secs:.1f} s")
    return dict(secs=secs, training=training, kaze=kz, seg=seg,
                figures=figures)


def main() -> int:
    # one card: the first of those visible, so device_count() is what the
    # run uses (set before torch initialises CUDA)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    _VISIBLE["cuda"] = visible         # phase 16's ranks may take them all
    os.environ["CUDA_VISIBLE_DEVICES"] = \
        "0" if visible is None else visible.split(",")[0]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase("1. versions and card")
    smi = nvidia_smi_line()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    log(f"nvidia-smi: {smi}")
    dev = torch.device("cuda")

    from dynamorph_tpu_torch.core.device import fp32_strict
    from dynamorph_tpu_torch.ops import _build, vq

    phase("2. build the kernels (nvcc, sm_90a)")
    info = _build.build("vq_lookup")
    log(f"vq_lookup.cu (vq_lookup, vq_indices, vq_lookup_rowwise): "
        f"{info['path']} "
        f"({info['seconds']:.2f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line \
                or "Compiling entry" in line:
            log(f"  {line.strip()}")

    ptxas = kernel_ptxas(info["log"])
    info = _build.build("batch_norm")
    log(f"batch_norm.cu (batch_norm{{,_relu}}_{{fwd,bwd}}_kernel<1, 4>): "
        f"{info['path']} ({info['seconds']:.2f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line \
                or "Compiling entry" in line:
            log(f"  {line.strip()}")
    with fp32_strict():
        compared = phase_compare(torch, vq, dev)
        indices = phase_compare_indices(torch, vq, dev)
    batch_norm = phase_compare_batch_norm(torch, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        main_run = phase_main_path(torch, vq, root)
        train_run = phase_training_path(torch, vq, root, dev)
        step_check = phase_step_vs_cpu(torch, dev)
        with fp32_strict():
            timed = phase_timings(torch, vq, compared, main_run, dev, ptxas)
            train_timed = phase_train_timings(torch, vq, indices, dev, ptxas)
        seg = phase_segmentation(torch, vq, root, dev, smi)
        front = phase_front_end(torch, vq, root, dev, main_run["weights"],
                                smi)
        raw_pcs = phase_raw_to_pcs(torch, vq, root, dev, main_run["weights"],
                                   smi)
        fused_run = phase_fused_stream(torch, vq, root, dev,
                                       main_run["weights"], smi, raw_pcs, seg)
        other, hard_step = phase_other_encoders(
            torch, vq, root, dev, smi,
            dict(raw=os.path.join(root, "raw"), data=main_run["data"]))
        after = phase_after_latents(torch, vq, root, dev, smi, main_run)
        unet = phase_unet_geometry(torch, vq, root, dev, smi)
        keras = phase_keras(torch, vq, root, dev, smi, seg,
                            main_run["data"])
        multirank = phase_multirank(
            torch, vq, root, dev, smi,
            dict(raw=os.path.join(root, "raw"), data=main_run["data"]),
            main_run["weights"])
        fan = phase_fan_out(torch, vq, root, dev, smi, raw_pcs,
                            main_run["weights"], main_run["data"])
        slice_k = phase_slice_k(torch, vq, root, dev, smi, multirank,
                                train_run, main_run["data"])

    z16 = timed["z16 encode"]
    ti = train_timed["indices"]
    kernels = [{
        "name": "vq_lookup",
        "route": "cuda",
        "source": "dynamorph_tpu_torch/ops/csrc/vq_lookup.cu",
        "replaces": "dynamorph_tpu/ops/vq.py:68",
        "launches": main_run["launches"],
        "max_abs_err": compared["z16 encode"]["max_abs_err"],
        "ms": z16["ms"],
        "plain_ms": z16["plain_ms"],
        "bound_ms": z16["bound_ms"],
        "bound_by": z16["bound_by"],
        "library_ms": z16["library_ms"],
        "shape": {"n": Z16_SHAPE[0], "d": Z16_SHAPE[1], "k": Z16_SHAPE[2]},
        "ms_per_call": z16["ms_per_call"],
        "bound_share": z16["bound_share"],
        "rowwise_ms": z16["rowwise_ms"],
        "ptxas": ptxas["vq_lookup_kernel"],
        "launches_training_path": train_run["launches_lookup"],
        "launches_front_end_path": front["launches"]["vq_lookup"],
        "launches_run_pipeline_path": raw_pcs["launches"]["vq_lookup"],
        "launches_fused_path":
            fused_run["runs"]["fused"]["launches"]["vq_lookup"],
        "launches_stream_path":
            fused_run["runs"]["streaming"]["launches"]["vq_lookup"],
        "launches_other_encoders_path": sum(
            r["launches"]["vq_lookup"] for r in other.values()),
        "launches_after_latents_path": after["launches"]["vq_lookup"],
        "launches_unet_training_path": unet["launches"]["vq_lookup"],
        "launches_keras_path": keras["launches"]["vq_lookup"],
        "launches_multirank_path": {
            "run_training_val_steps_per_rank":
                multirank["launches"]["vq_lookup"],
            "process_with_the_ranks_model": multirank["process_launches"],
            "run_pipeline_per_rank": multirank["pipeline"]["launches"],
            "encode_fanned_out": multirank["within"]["launches"]},
        "per_rank_shape": multirank["kernels"]["vq_lookup"],
        "launches_fan_out_stream_path": fan["stream"]["launches"]["vq_lookup"],
        "launches_fan_out_by_device": fan["stream"]["by_device"],
        "launches_local_ranks_per_rank": [
            l["vq_lookup"] for l in slice_k["training"]["launches"]],
        "z32": {k: timed["z32 encode"][k] for k in
                ("ms", "ms_per_call", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "bound_share", "rowwise_ms")},
        "z32_encode": timed["z32 encode model"],
    }, {
        "name": "vq_indices",
        "route": "cuda",
        "source": "dynamorph_tpu_torch/ops/csrc/vq_lookup.cu",
        "replaces": "dynamorph_tpu/ops/vq.py:153",
        "launches": train_run["launches_indices"],
        # idx is an index: the error is the float64 distance gap between the
        # kernel's code and the plain version's, 0 where they agree
        "max_abs_err": indices["random"]["max_gap"],
        "ms": ti["ms"],
        "plain_ms": ti["plain_ms"],
        "bound_ms": ti["bound_ms"],
        "bound_by": ti["bound_by"],
        "library_ms": ti["library_ms"],
        "shape": {"n": TRAIN_SHAPE[0], "d": TRAIN_SHAPE[1],
                  "k": TRAIN_SHAPE[2]},
        "ms_per_call": ti["ms_per_call"],
        "bound_share": ti["bound_share"],
        "ptxas": ti["ptxas"],
        "launches_front_end_path": front["launches"]["vq_indices"],
        "launches_run_pipeline_path": raw_pcs["launches"]["vq_indices"],
        "launches_fused_path":
            fused_run["runs"]["fused"]["launches"]["vq_indices"],
        "launches_stream_path":
            fused_run["runs"]["streaming"]["launches"]["vq_indices"],
        "launches_other_encoders_path": sum(
            r["launches"]["vq_indices"] for r in other.values()),
        "launches_after_latents_path": after["launches"]["vq_indices"],
        "launches_unet_training_path": unet["launches"]["vq_indices"],
        "launches_keras_path": keras["launches"]["vq_indices"],
        "launches_multirank_path_per_rank":
            multirank["launches"]["vq_indices"],
        "multirank_steps_per_rank": multirank["steps"],
        "launches_fan_out_stream_path":
            fan["stream"]["launches"]["vq_indices"],
        "per_rank_shape": multirank["kernels"]["vq_indices"],
        "launches_local_ranks_per_rank": [
            l["vq_indices"] for l in slice_k["training"]["launches"]],
        "flips_vs_plain": {k: indices[k]["flips"] for k in indices},
        "flip_rate_vs_f64": {k: indices[k]["f64_rate"] for k in indices},
    }, {
        "name": "batch_norm",
        "route": "cuda",
        "source": "dynamorph_tpu_torch/ops/csrc/batch_norm.cu",
        "replaces": "cuDNN's bn_fw_tr_1C11 / bn_bw_1C11 and the ReLU after "
                    "them (no TPU kernel: dynamorph_tpu/nn/functional.py)",
        "launches": batch_norm["launches"],
        # relative L2 from float64, the worst output of the worst shape
        "max_rel_err": max(v for e in batch_norm["errs"].values()
                           for v in e["kernel"].values()),
        "max_abs_err": max(e["max_abs_y"]
                           for e in batch_norm["errs"].values()),
        "z32_step": batch_norm["steps"]["z32"],
        "z16_step": batch_norm["steps"]["z16"],
        "per_shape": {
            f"{'x'.join(map(str, s))}{'_relu' if r else ''}": v
            for (s, r), v in batch_norm["timed"].items()},
        "launches_training_path": train_run["launches_batch_norm"],
        "launches_timed_z32_step": train_timed["launches_batch_norm"],
        "launches_other_encoders_path": {
            n: r["batch_norm"][0] for n, r in other.items()},
        "launches_adversarial_path": after["adv"]["launches_batch_norm"],
        "launches_local_ranks_per_rank": [
            l["batch_norm"] for l in slice_k["training"]["launches"]],
    }]
    phase("summary")
    log(f"training path: {train_run['wall']:.3f} s for {TRAIN_EPOCHS} "
        f"epochs; train step at batch {TRAIN_BATCH}: "
        f"{train_timed['step_ms']:.6f} ms, "
        f"{TRAIN_BATCH / train_timed['step_ms'] * 1e3:.1f} patches/s; card "
        f"vs CPU step: losses {step_check['loss_rel']:.3e} relative, worst "
        f"gradient at {step_check['grad_ratio']:.3f} of its limit (TF32 "
        f"control {step_check['control']:.3f}), batch-norm buffers "
        f"{step_check['bn_abs']:.3e}; segmentation, one {SEG_FRAME}x"
        f"{SEG_FRAME} frame: tiled {seg['timed']['tiled']['wall_ms']:.3f} ms,"
        f" direct {seg['timed']['direct']['wall_ms']:.3f} ms, card vs CPU "
        f"{seg['tiles_vs_cpu']:.3e} (TF32 control "
        f"{seg['tiles_tf32_control']:.3e}); front end to latents, "
        f"{FE_T} frames of {FE_FRAME}x{FE_FRAME}, {front['n_cells']} cells: "
        f"{sum(front['walls'].values()):.3f} s, host share "
        f"{front['host_share']:.4f}; raw TIFFs to PCs, {FE_T} frames: "
        f"run_preproc {raw_pcs['walls']['run_preproc']:.3f} s, stages "
        f"{sum(raw_pcs['stage_s'].values()):.3f} s; fused front end "
        f"{fused_run['runs']['fused']['front_s']:.3f} s, streaming front end"
        f" {fused_run['runs']['streaming']['front_s']:.3f} s (staged "
        f"{fused_run['staged_front_s']:.3f} s); plate PCA fit "
        f"{raw_pcs['plate']['fit_s']:.3f} s ({raw_pcs['plate']['n']} x "
        f"{LATENT_LEN}); UMAP grid {raw_pcs['umap']['total_s']:.3f} s "
        f"({raw_pcs['umap']['n']} latents); other encoders, train step at "
        f"batch {TRAIN_BATCH} / encode patches/s (resident): " + ", ".join(
            f"{n} {r['timing']['step_ms']:.3f} ms / "
            f"{r['resident_patches_s']:.1f}" for n, r in other.items())
        + f"; ResNet18 hard-negative step at "
        + ", ".join(f"{w} {c['grad_ratio']:.3f} (TF32 control "
                    f"{c['control']:.3f})" for w, c in hard_step.items())
        + f" of its limit; after the latents: adversarial step at batch "
        f"{TRAIN_BATCH} {after['adv']['step_ms']:.3f} ms, recon eval of "
        f"{N_PATCHES} patches {after['recon']['wall']:.3f} s "
        f"({after['recon']['launches']} vq_lookup launches), plate cPCA "
        f"fit {after['cpca']['fit_s']:.3f} s, phase 13 "
        f"{after['secs']:.1f} s; U-Net fit step at batch {U_BATCH} "
        f"{unet['train']['step_ms']:.3f} ms, fit {unet['train']['fit_s']:.3f}"
        f" s, step check at {unet['step']['grad_ratio']:.3f} of its limit "
        f"(TF32 control {unet['step']['control']:.3f}), long-axis "
        f"extraction {unet['geo']['cells_per_s']:.1f} cells/s, phase 14 "
        f"{unet['secs']:.1f} s; Keras U-Net from .h5: one {SEG_FRAME}^2 "
        f"frame's device work tiled {keras['unet']['device_ms']['tiled']:.3f}"
        f" ms, direct {keras['unet']['device_ms']['direct']:.3f} ms, fit step"
        f" (frozen encoder) {keras['fit']['step_ms']:.3f} ms; baselines "
        f"end to end InceptionResNetV2 "
        f"{keras['features']['InceptionResNetV2']['images_per_s']:.1f}, "
        f"ResNet50 {keras['features']['ResNet50']['images_per_s']:.1f} "
        f"images/s; phase 15 {keras['secs']:.1f} s; multi-rank: world "
        f"{multirank['world']} over {multirank['backend']}, z32 step at "
        f"batch {TRAIN_BATCH} {multirank['timing']['step_ms']:.3f} ms a "
        f"rank, collectives share "
        f"{multirank['timing']['collective_share']:.4f}, step checks at "
        f"{multirank['step_check']['z32'][1]:.3f} (z32) and "
        f"{multirank['step_check']['triplet'][1]:.3f} (ResNet18) of the "
        f"limit, phase 16 {multirank['secs']:.1f} s; fan-out over "
        f"[card, card]: tiled / direct segmentation "
        f"{fan['seg']['tiled']['err']:.3e} / {fan['seg']['direct']['err']:.3e}"
        f" from one device, ResNet50 {fan['resnet']['err']:.3e}, "
        f"seg_patch_fused a site at site parallelism 1 / 2 "
        f"{fan['fused'][1]['per_site']:.3f} / "
        f"{fan['fused'][2]['per_site']:.3f} s, the stream's z_before "
        f"{fan['stream']['err']:.3e}, phase 17 {fan['secs']:.1f} s; "
        f"run_training over {LR_WORLD} local ranks: step "
        f"{slice_k['training']['ranks'][0]['timing']['step_ms']:.3f} ms a "
        f"rank, bit-equal to phase 16: {slice_k['training']['bit_equal']}; "
        f"KAZE {slice_k['kaze']['s_per_patch']:.4f} s a patch, Hessian "
        f"determinant card vs CPU {slice_k['kaze']['ldet_err']:.3e} (TF32 "
        f"control {slice_k['kaze']['control']:.3e}); tile bucket "
        f"{SEG_BUCKET} {slice_k['seg']['err']:.3e} from one device; phase "
        f"18 {slice_k['secs']:.1f} s; whole script "
        f"{time.perf_counter() - t_start:.1f} s [{smi}]")
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
