#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dynamorph_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases; any failure exits non-zero, and only a run in which every phase
passed prints the final ``{"ok": true, ...}`` line:

1. versions, card name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``dynamorph_tpu_torch/ops/csrc``
   with ``nvcc`` for sm_90a (one source holds vq_lookup and vq_indices);
3. hold each kernel against its plain PyTorch version on the card:
   vq_lookup at the unit-test shapes, with forced ties, and at both encode
   shapes (z16 and z32 at batch 512), q bit-equal to codebook[idx];
   vq_indices at the unit-test shapes, with forced ties, and at the z32
   training shape (N = 768 x 32 x 32) on random rows and on the latents of
   a full-width z32 encoder. idx must equal the plain version's except at
   near-ties, rows whose two candidate distances, recomputed in float64,
   differ by less than 1e-6 relative; at the training shape it must also
   disagree with a float64 argmin on at most 0.006% of the rows (the JAX
   package's gate for the "high" training precision);
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
   check that sees TF32 in the backward pass; a control step whose
   backward runs outside ``fp32_strict`` shows what TF32 would look like;
7. timings with CUDA events: each kernel at its main-path shapes beside its
   bound, its plain version and the stock-PyTorch yardstick, as device time
   (calls replayed from a CUDA graph) and per call from Python; the
   gather_codes backward; z16 encode patches/s; one z32 training step at
   batch 768 (ms, patches/s) and its device time by kernel family
   (torch.profiler). Then the ``{"kernels": [...]}`` line, the
   ``nvidia-smi`` line and the ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
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
    """Kernel vs plain on the card. Returns (flips, max_abs_err)."""
    q, idx = vq._vq_lookup_cuda(z, cb)
    torch.cuda.synchronize()
    q_ref, idx_ref = vq.vq_lookup_reference(z, cb)
    if not torch.equal(q, cb[idx.long()]):
        raise AssertionError("q is not bit-equal to codebook[idx]")
    flips, _ = check_near_ties(torch, "vq_lookup", z, cb, idx, idx_ref)
    return flips, float(torch.max(torch.abs(q - q_ref)))


def phase_compare(torch, vq, dev):
    phase("3. vq_lookup kernel vs plain version on the card")
    rng = np.random.RandomState(SEED)
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = []
    for n, d, k in VQ_SHAPES:
        cases.append((f"random {n}x{d} K={k}", rng.randn(n, d), rng.randn(k, d)))
        cases.append((f"ties {n}x{d} K={k}", *tied_inputs(rng, n, d, k)))
    results = {}
    for name, z, cb in cases:
        zt = torch.from_numpy(np.asarray(z, np.float32)).to(dev)
        cbt = torch.from_numpy(np.asarray(cb, np.float32)).to(dev)
        flips, err = compare_vq(torch, vq, zt, cbt)
        log(f"{name}: idx flips at near-ties {flips}, max |q - q_plain| {err}")
    for label, (n, d, k) in (("z16 encode", Z16_SHAPE),
                             ("z32 encode", Z32_SHAPE)):
        z = torch.randn(n, d, generator=g, device=dev)
        cb = torch.randn(k, d, generator=g, device=dev)
        flips, err = compare_vq(torch, vq, z, cb)
        results[label] = dict(flips=flips, max_abs_err=err, z=z, cb=cb)
        log(f"{label} N={n} D={d} K={k}: idx flips at near-ties {flips} "
            f"of {n}, max |q - q_plain| {err}")
    return results


def f64_argmin(torch, z, cb, chunk=65536):
    """The exact nearest code of each row, from float64 distances."""
    cb64 = cb.double()
    e2 = torch.sum(cb64 * cb64, 1)
    return torch.cat([
        torch.argmin(e2[None, :] - 2.0 * (z[i:i + chunk].double() @ cb64.T),
                     1) for i in range(0, len(z), chunk)]).to(torch.int32)


def compare_indices(torch, vq, z, cb):
    """vq_indices kernel vs plain on the card, and vs the lookup kernel.
    Returns (flips, largest float64 distance gap at a flip, idx)."""
    idx = vq._vq_indices_cuda(z, cb)
    torch.cuda.synchronize()
    _, idx_lookup = vq._vq_lookup_cuda(z, cb)
    if not torch.equal(idx, idx_lookup):
        raise AssertionError("vq_indices and vq_lookup pick different codes")
    flips, gap_max = check_near_ties(torch, "vq_indices", z, cb, idx,
                                     vq.vq_indices_reference(z, cb))
    return flips, gap_max, idx


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
    for n, d, k in VQ_SHAPES:
        for name, (z, cb) in (
                (f"random {n}x{d} K={k}", (rng.randn(n, d), rng.randn(k, d))),
                (f"ties {n}x{d} K={k}", tied_inputs(rng, n, d, k))):
            zt = torch.from_numpy(np.asarray(z, np.float32)).to(dev)
            cbt = torch.from_numpy(np.asarray(cb, np.float32)).to(dev)
            flips, _, _ = compare_indices(torch, vq, zt, cbt)
            log(f"{name}: idx flips at near-ties {flips}")
    n, d, k = TRAIN_SHAPE
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    cases = {"random": (torch.randn(n, d, generator=g, device=dev),
                        torch.randn(k, d, generator=g, device=dev)),
             "latents": training_latents(torch, dev)}
    results = {}
    for label, (z, cb) in cases.items():
        flips, gap, idx = compare_indices(torch, vq, z, cb)
        f64_flips = int((idx != f64_argmin(torch, z, cb)).sum())
        rate = f64_flips / n
        log(f"z32 training shape, {label} rows, N={n} D={d} K={k}: idx flips "
            f"vs plain at near-ties {flips} (largest float64 gap {gap:.3e}); "
            f"vs float64 argmin {f64_flips} rows = {100 * rate:.6f}% "
            f"(gate {100 * F64_FLIP_GATE:.4f}%); "
            f"{len(torch.unique(idx))} codes used")
        if rate > F64_FLIP_GATE:
            raise AssertionError(f"vq_indices flips {100 * rate:.6f}% of the "
                                 "rows against float64, above the gate")
        results[label] = dict(flips=flips, max_gap=gap, f64_flips=f64_flips,
                              f64_rate=rate, z=z, cb=cb)
    return results


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
    t0 = time.perf_counter()
    model, hist = run_training.main(["-c", cfg, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    li, ll = vq.vq_indices.launches, vq.vq_lookup.launches
    log(f"run_training: {wall:.3f} s wall for {TRAIN_EPOCHS} epochs (load, "
        f"z-score, reorder, train, validate, checkpoint); vq_indices "
        f"launches {li} (want {want_train}), vq_lookup launches {ll} (want "
        f"{want_val})")
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
                hist=hist)


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
    own difference."""
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

    def run(device, search, dtype=torch.float32):
        model = copy.deepcopy(base).to(device=device, dtype=dtype)
        step = make_train_step(model, torch.optim.Adam(
            model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8),
            augment=False)
        vqvae_mod.vq_indices = search
        try:
            losses = step(torch.from_numpy(x).to(device, dtype), rel, mask)
        finally:
            vqvae_mod.vq_indices = real
        grads = {n: p.grad.detach().cpu().double() for n, p in
                 model.named_parameters()}
        bufs = {n: b.detach().cpu() for n, b in model.named_buffers()
                if "running" in n}
        return {k: float(v) for k, v in losses.items()}, grads, bufs

    l_gpu, g_gpu, b_gpu = run(dev, recording)
    l_cpu, g_cpu, b_cpu = run("cpu", replaying)
    _, g_f64, _ = run("cpu", replaying_f64, torch.float64)

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

    def vs_f64(grads):
        return {n: rel_l2(grads[n], g_f64[n]) for n in weights}

    e_gpu, e_cpu = vs_f64(g_gpu), vs_f64(g_cpu)
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
    # after the block has closed, with cuDNN's TF32 default: what the
    # gradient check would see if the train step left its backward out
    model = copy.deepcopy(base).to(dev)
    vqvae_mod.vq_indices = lambda z, cb, precision="highest": seen["idx"]
    try:
        _, losses = model.apply(
            torch.from_numpy(x).to(dev), train=True, time_matching_mat=rel,
            batch_mask=torch.from_numpy(mask).to(dev).float())
    finally:
        vqvae_mod.vq_indices = real
    tf32 = torch.backends.cudnn.allow_tf32
    losses["total_loss"].backward()
    g_ctrl = {n: p.grad.detach().cpu().double()
              for n, p in model.named_parameters()}
    e_ctrl = vs_f64(g_ctrl)
    ctrl = {n: e_ctrl[n] / (STEP_GRAD_VS_CPU * e_cpu[n] + STEP_GRAD_FLOOR)
            for n in weights}
    ctrl_worst = max(ctrl, key=ctrl.get)
    log(f"control, backward outside fp32_strict (cudnn.allow_tf32={tf32}): "
        f"vs float64 enc.0.weight {e_ctrl['enc.0.weight']:.3e}, "
        f"dec.4.weight {e_ctrl['dec.4.weight']:.3e}; worst {ctrl_worst} at "
        f"{ctrl[ctrl_worst]:.3f} of the limit (the check would "
        f"{'catch' if ctrl[ctrl_worst] > 1 else 'miss'} it)")
    return dict(loss_rel=worst_loss, grad_ratio=ratio[worst],
                grad_vs_f64=e_gpu[worst], grad_cpu_vs_f64=e_cpu[worst],
                bn_abs=bn_err, flips=len(flips), control=ctrl[ctrl_worst],
                tf32_default=tf32)


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


def family(name):
    lname = name.lower()
    for fam, keys in FAMILIES:
        if any(k in lname for k in keys):
            return fam
    return "other (elementwise, reductions, copies, one-hot)"


def profile_steps(torch, step, n_steps, step_ms):
    """Device time per step by kernel family, from torch.profiler, and the
    share of the step's wall time the device was idle."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
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
        fams[family(name)] = fams.get(family(name), 0.0) + ms
    log(f"device busy {busy:.6f} ms per step of {step_ms:.6f} ms: idle "
        f"share {max(0.0, 1 - busy / step_ms):.4f}")
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        log(f"  {fam}: {ms:.6f} ms ({100 * ms / busy:.1f}%)")
    log("  top kernels:")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
        log(f"    {ms:.6f} ms  {name[:110]}")
    return dict(busy_ms=busy, families=fams)


def phase_train_timings(torch, vq, indices, dev):
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
    step_ms = time_cuda(torch, one_step, 10)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"z32 train step, batch {TRAIN_BATCH}, device-resident batch, "
        f"augmentation and relation block on: {step_ms:.6f} ms, "
        f"{TRAIN_BATCH / step_ms * 1e3:.1f} patches/s; peak device memory "
        f"{peak:.3f} GB")
    prof = profile_steps(torch, one_step, 3, step_ms)
    return dict(indices=timed, gather_ms=gather_ms, index_add_ms=index_add_ms,
                step_ms=step_ms, peak_gb=peak, profile=prof)


def phase_timings(torch, vq, compared, main, dev):
    phase("7. timings (CUDA events, warm L2, after 3 warm-up calls)")
    from dynamorph_tpu_torch.core.device import fp32_strict
    from dynamorph_tpu_torch.models import VQVAEz16
    from dynamorph_tpu_torch.pipeline.patch_vae import encode_patches

    log("device ms: calls replayed from a CUDA graph; per call: launched "
        "from Python, host cost included")
    timed = {}
    for label, (n, d, k) in (("z16 encode", Z16_SHAPE),
                             ("z32 encode", Z32_SHAPE)):
        z, cb = compared[label]["z"], compared[label]["cb"]
        iters = 200 if label.startswith("z16") else 20

        def kernel():
            return vq._vq_lookup_cuda(z, cb)

        def plain():
            return vq.vq_lookup_reference(z, cb)

        def library():
            e2 = torch.sum(cb * cb, dim=1)
            dist = torch.addmm(e2, z, cb.T, beta=1.0, alpha=-2.0)
            idx = torch.argmin(dist, dim=1)
            return torch.index_select(cb, 0, idx), idx

        ms_call = time_cuda(torch, kernel, iters)
        ms = time_graph(torch, kernel, iters)
        plain_ms = time_graph(torch, plain, iters)
        library_ms = time_graph(torch, library, iters)
        bound_ms, bound_by = vq_bound(n, d, k)
        timed[label] = dict(ms=ms, ms_per_call=ms_call, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
        log(f"vq_lookup {label} N={n} D={d} K={k}: kernel {ms:.6f} ms "
            f"device ({ms_call:.6f} ms per call), bound {bound_ms:.6f} ms "
            f"({bound_by}), plain {plain_ms:.6f} ms, library (sum + addmm "
            f"+ argmin + index_select) {library_ms:.6f} ms")

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
    return timed


def main() -> int:
    # one card: the first of those visible, so device_count() is what the
    # run uses (set before torch initialises CUDA)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
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
    log(f"vq_lookup.cu (vq_lookup, vq_indices): {info['path']} "
        f"({info['seconds']:.2f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line \
                or "Compiling entry" in line:
            log(f"  {line.strip()}")

    with fp32_strict():
        compared = phase_compare(torch, vq, dev)
        indices = phase_compare_indices(torch, vq, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        main_run = phase_main_path(torch, vq, root)
        train_run = phase_training_path(torch, vq, root, dev)
        step_check = phase_step_vs_cpu(torch, dev)
        with fp32_strict():
            timed = phase_timings(torch, vq, compared, main_run, dev)
            train_timed = phase_train_timings(torch, vq, indices, dev)

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
        "launches_training_path": train_run["launches_lookup"],
        "z32": {k: timed["z32 encode"][k] for k in
                ("ms", "ms_per_call", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")},
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
        "flips_vs_plain": {k: indices[k]["flips"] for k in indices},
        "flip_rate_vs_f64": {k: indices[k]["f64_rate"] for k in indices},
    }]
    phase("summary")
    log(f"training path: {train_run['wall']:.3f} s for {TRAIN_EPOCHS} "
        f"epochs; train step at batch {TRAIN_BATCH}: "
        f"{train_timed['step_ms']:.6f} ms, "
        f"{TRAIN_BATCH / train_timed['step_ms'] * 1e3:.1f} patches/s; card "
        f"vs CPU step: losses {step_check['loss_rel']:.3e} relative, worst "
        f"gradient at {step_check['grad_ratio']:.3f} of its limit (TF32 "
        f"control {step_check['control']:.3f}), batch-norm buffers "
        f"{step_check['bn_abs']:.3e}; whole script "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
