"""How far chip_smoke.py phase 14's U-Net step check sits from its limit,
over many trained weights, with one step and with the check's U_STEP_DRAWS
steps, each on its own seeded batch.

For each seed, ``Segment((2, 256, 256))`` is fitted on the card as phase 14
fits it (64 sampler patches, batch 8, 2 epochs; cuDNN's atomics make two
fits of one seed differ), then ``chip_smoke.unet_step_vs_cpu`` runs on its
weights: fit steps at batch 2 of 128², card against CPU, each against
float64 on its own side of every kink, at phase 12's rule (card error <= 3
x CPU error + 1e-5 per weight, relative L2). The check prints the ratio
on the errors pooled over its steps and the ratio of its first step alone
(the batch that the check's one step took before it took several). With
``--no-cudnn-seeds`` the card runs the same steps on PyTorch's own CUDA
convolution and batch-norm kernels instead of cuDNN's. With ``--layers``,
for the check's first batch, each convolution's and batch norm's input
``h`` and output gradient ``dy`` on the card and on the CPU against
float64 on that side's own kink choices (relative L2): where the card's
error outgrows the CPU's.

Run on a CUDA machine from the repo root:
``python3 tools/unet_step_draws.py --seeds 14,14,1,2 --no-cudnn-seeds 1``.
A line a fit, then a summary line, to standard output.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile

import numpy as np


def layer_errors(torch, cs, weights, tag):
    """Each convolution's and batch norm's ``h`` and ``dy`` on the card and
    on the CPU, against float64 replaying that side's kink choices, on the
    check's first batch; one line a layer, forward order."""
    import copy

    from torch import nn

    from dynamorph_tpu_torch.seg.model import Segment

    size = cs.U_STEP_SIZE
    base = Segment(input_shape=(2, size, size), device="cpu")
    base.load(weights)
    r = np.random.RandomState(cs.SEED + 15)
    x = torch.from_numpy(r.rand(2, 2, size, size).astype(np.float32))
    lab = r.rand(2, 3, size, size) ** 3
    lab /= lab.sum(1, keepdims=True)
    y = torch.from_numpy(np.concatenate(
        [lab, np.ones((2, 1, size, size))], 1).astype(np.float32))

    def run(device, dtype, masks, replay=False):
        net = copy.deepcopy(base.net).to(device=device, dtype=dtype)
        cap, hooks = {}, []
        for name, m in net.named_modules():
            if isinstance(m, (nn.Conv2d, nn.BatchNorm2d)):
                def fwd(mod, inp, out, name=name):
                    cap[name] = {"h": inp[0].detach().cpu().double()}
                    out.register_hook(lambda g: cap[name].__setitem__(
                        "dy", g.detach().cpu().double()))
                hooks.append(m.register_forward_hook(fwd))
        cs.unet_step_grads(torch, net, x.to(device, dtype),
                           y.to(device, dtype), True, masks, replay)
        for h in hooks:
            h.remove()
        return cap

    def rel(a, b):
        return float(torch.norm(a - b) / max(float(torch.norm(b)), 1e-300))

    m_card, m_cpu = [], []
    card, cpu = run("cuda", torch.float32, m_card), run("cpu", torch.float32,
                                                        m_cpu)
    ref_card = run("cpu", torch.float64, m_card, True)
    ref_cpu = run("cpu", torch.float64, m_cpu, True)
    for name in card:
        e = [rel(side[name][k], ref[name][k]) for k in ("h", "dy")
             for side, ref in ((card, ref_card), (cpu, ref_cpu))]
        h_x, dy_x = e[0] / max(e[1], 1e-30), e[2] / max(e[3], 1e-30)
        print(f"  {name}: h card {e[0]:.2e} CPU {e[1]:.2e} ({h_x:.1f}x); "
              f"dy card {e[2]:.2e} CPU {e[3]:.2e} ({dy_x:.1f}x){tag}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="14,14,14,14,14,14,1,2,3,4,5,6",
                    help="comma-separated seeds of the fits (default cuDNN)")
    ap.add_argument("--no-cudnn-seeds", default="",
                    help="comma-separated seeds of fits whose check runs "
                         "the card side with cuDNN off")
    ap.add_argument("--layers", action="store_true",
                    help="print each layer's h and dy errors, card and CPU")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from dynamorph_tpu_torch.seg.data import generate_patches
    from dynamorph_tpu_torch.seg.model import Segment

    raw, prob = cs.unet_sampler_stack(np.random.RandomState(cs.SEED + 14))
    patches = generate_patches(raw, prob, n_patches=cs.U_PATCHES,
                               x_size=cs.SEG_WINDOW, y_size=cs.SEG_WINDOW,
                               rotate=True, mirror=True, seed=0)
    del raw, prob
    runs = [(int(s), True) for s in args.seeds.split(",") if s] + \
        [(int(s), False) for s in args.no_cudnn_seeds.split(",") if s]
    root = tempfile.mkdtemp()
    out = {True: [], False: []}
    for k, (seed, cudnn) in enumerate(runs):
        model = Segment(input_shape=(2, cs.SEG_WINDOW, cs.SEG_WINDOW),
                        n_classes=3, model_path=os.path.join(root, f"f{k}"),
                        seed=seed, device="cuda")
        model.fit(patches[:-cs.U_VALID], batch_size=cs.U_BATCH,
                  n_epochs=cs.U_EPOCHS, valid_patches=patches[-cs.U_VALID:])
        weights = os.path.join(root, f"w{k}")
        model.save(weights)
        tag = f" [fit {k}, seed {seed}, cuDNN {'on' if cudnn else 'off'}]"
        if args.layers:
            layer_errors(torch, cs, weights, tag)
        with contextlib.nullcontext() if cudnn else \
                torch.backends.cudnn.flags(enabled=False):
            try:
                res = cs.unet_step_vs_cpu(torch, "cuda", weights, tag)
            except AssertionError as exc:
                print(f"check failed: {exc}{tag}", flush=True)
                continue
        out[cudnn].append((res["grad_ratio"], res["first_step"],
                           res["control"]))
    for cudnn, rows in out.items():
        if rows:
            a = np.array(rows)
            print(f"cuDNN {'on' if cudnn else 'off'}: {len(rows)} fits; "
                  f"over the steps max {a[:, 0].max():.3f}, first step "
                  f"alone max {a[:, 1].max():.3f} ({(a[:, 1] > 1).sum()} "
                  f"over 1), TF32 control min {a[:, 2].min():.1f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
