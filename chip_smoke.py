#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dynamorph_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

Phases; any failure exits non-zero, and only a run in which every phase
passed prints the final ``{"ok": true, ...}`` line:

1. versions, card name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``dynamorph_tpu_torch/ops/csrc``
   with ``nvcc`` for sm_90a;
3. hold each kernel against its plain PyTorch version on the card: the VQ
   lookup at the unit-test shapes, with forced ties, and at both encode
   shapes (z16 and z32 at batch 512). q must equal codebook[idx] bit for
   bit; idx must equal the plain version's except at near-ties, rows whose
   two candidate distances, recomputed in float64, differ by less than 1e-6
   relative;
4. the main path: ``run_vae -m process`` (the CLI) for VQ_VAE_z16 at full
   width (num_hiddens 16, num_residual_hiddens 32, num_embeddings 64,
   2 x 128 x 128 patches, batch 512) on a synthetic well of 2,304 float64
   patches with a seeded random-init ``model.pt`` of reference names. It
   checks the latent pickles, that the kernel was launched, and the first
   64 patches' latents against the port's CPU path;
5. timings with CUDA events: the kernel at both encode shapes beside its
   bound, its plain version and the stock-PyTorch yardstick, each as device
   time (calls replayed from a CUDA graph); the kernel also per call from
   Python; z16 encode patches/s. Then the ``{"kernels": [...]}`` line, the
   ``nvidia-smi`` line and the ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

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


def compare_vq(torch, vq, z, cb):
    """Kernel vs plain on the card. Returns (flips, max_abs_err)."""
    q, idx = vq._vq_lookup_cuda(z, cb)
    torch.cuda.synchronize()
    q_ref, idx_ref = vq.vq_lookup_reference(z, cb)
    if not torch.equal(q, cb[idx.long()]):
        raise AssertionError("q is not bit-equal to codebook[idx]")
    rows = torch.nonzero(idx != idx_ref).flatten()
    if len(rows):
        gap, allowed = tie_gap(torch, z[rows], cb[idx[rows].long()],
                               cb[idx_ref[rows].long()])
        if bool((gap > allowed).any()):
            raise AssertionError(
                f"{int((gap > allowed).sum())} idx disagreements are not "
                f"near-ties (largest gap / allowance "
                f"{float((gap / allowed).max()):.3e})")
    return len(rows), float(torch.max(torch.abs(q - q_ref)))


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
    # smooth blobs plus noise, in uint16 intensity units
    yy, xx = np.mgrid[0:128, 0:128] / 128.0
    cx, cy = rng.rand(2, N_PATCHES, 1, 1)
    blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 0.05)
    data = np.stack([blob * 30000 + rng.rand(N_PATCHES, 128, 128) * 5000,
                     blob * 8000 + rng.rand(N_PATCHES, 128, 128) * 2000], 1)
    data = data[:, :, None].astype(np.float64)       # (N, 2, 1, 128, 128)
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


def codes_of(torch, z_after_rows, codebook):
    """Code index of each post-VQ row (rows are exact codebook rows)."""
    d = torch.cdist(z_after_rows.double(), codebook.double(),
                    compute_mode="donot_use_mm_for_euclid_dist")
    val, idx = torch.min(d, dim=1)
    if float(val.max()) != 0.0:
        raise AssertionError("a z_after row is not a codebook row")
    return idx


def phase_main_path(torch, vq, root):
    phase("4. main path: run_vae -m process, VQ_VAE_z16, on cuda")
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
        # a flip is allowed only at a near-tie, widened by what the
        # latents' own card-vs-CPU difference can move the gap:
        # |d(z, b) - d(z, a) - (d(z', b) - d(z', a))| <= 2 |z - z'| |E_a - E_b|
        zc, zg = rows(zb_cpu)[flips].double(), rows(z_b[:64])[flips].double()
        ea, eb = cb.double()[idx_cpu[flips]], cb.double()[idx_gpu[flips]]
        gap, allowed = tie_gap(torch, zc, ea, eb)
        room = allowed + 2 * torch.norm(zc - zg, dim=1) * \
            torch.norm(ea - eb, dim=1)
        if bool((gap > room).any()):
            raise AssertionError("z_after code flips beyond the latents' "
                                 "own card-vs-CPU difference")
        log(f"largest flip gap / allowance {float((gap / room).max()):.3e}")
    log(f"z_after card vs CPU, first 64 patches: {len(flips)} code flips of "
        f"{len(idx_gpu)} latent positions (near-ties), {n_codes} distinct "
        "codes used")
    if n_codes < 2:
        raise AssertionError("the lookup collapsed onto one code")
    return dict(launches=launches, wall=wall, data=data, weights=weights)


# ---------------------------------------------------------------- phase 5


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


def vq_bound(n, d, k):
    nbytes = 4 * (n * d + k * d + n * d + n)      # z, E in; q, idx out
    flops = 2 * n * k * d + 2 * k * d             # distances + code norms
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def phase_timings(torch, vq, compared, main, dev):
    phase("5. timings (CUDA events, warm L2, after 3 warm-up calls)")
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
    log(f"vq_lookup: {info['path']} ({info['seconds']:.2f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  {line.strip()}")

    with fp32_strict():
        compared = phase_compare(torch, vq, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        main_run = phase_main_path(torch, vq, root)
        with fp32_strict():
            timed = phase_timings(torch, vq, compared, main_run, dev)

    z16 = timed["z16 encode"]
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
        "z32": {k: timed["z32 encode"][k] for k in
                ("ms", "ms_per_call", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")},
    }]
    phase("summary")
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
