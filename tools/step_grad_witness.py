"""Why an fp32 train step of the z16 family can sit far from float64, on the
card and on the CPU.

For each seed, a network (``VAE``, ``IWAE``, ``AAE`` at the z16 widths of
configs/config_example.yml:61-65, or a ``ResNet``) is built with PyTorch's
default init, as ``run_training`` builds it, and optionally trained for a
few Adam steps at batch 768 on the card. Then one train-mode step on 8
patches runs as chip_smoke.py phase 12 runs it: on the card (fp32), on the
CPU (fp32) and on the CPU in float64, recording the choice at every kink
(each ReLU's mask, the triplet miner's hinge mask, the ResNet stem
max-pool's argmax: ``chip_smoke.kink_branches``). The script reports

* how many of those choices each fp32 step makes otherwise than float64
  (``flips``);
* the card's gradients against float64 at phase 6's rule (card error <= 3
  x CPU error + 1e-5 per weight tensor, relative L2) and at the wider 10 x
  + 1e-4, against float64's own choices, and at phase 6's rule against
  float64 that replays each fp32 step's choices (the check chip_smoke.py
  and tests/test_torch_models_cuda.py make);
* per convolution and batch norm: how far the card's and the CPU's input
  ``h`` and output gradient ``dy`` sit from float64's, and how far the
  weight gradient that the card's kernel forms from the card's own ``h``
  and ``dy`` (cuDNN, TF32 off; for batch norm also PyTorch's native
  kernel) sits from float64 on the same ``h`` and ``dy``: the kernel's own
  error, apart from what reaches it. For batch norm also the scale sum's
  condition ``max_c sum|dy x_hat| / |sum dy x_hat|``.

Run on a CUDA machine from the repo root:
``python3 tools/step_grad_witness.py --nets IWAE,VAE,AAE --seeds 16``.
One JSON line a model goes to ``--out``, a line a model and a summary to
standard output.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys

import numpy as np
import torch
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as smoke  # noqa: E402
from dynamorph_tpu_torch.core.device import fp32_strict  # noqa: E402
from dynamorph_tpu_torch.train.data import zscore  # noqa: E402
from dynamorph_tpu_torch.train.steps import (make_train_step,  # noqa: E402
                                             make_triplet_steps)

CHECK = smoke.E1_CHECK
LAYERS = (nn.Conv2d, nn.ConvTranspose2d, nn.BatchNorm2d)


def rel_l2(a, b):
    return float(torch.norm(a - b) / max(float(torch.norm(b)), 1e-300))


def capture_layers(model, capture):
    """Forward hooks that keep each convolution's and batch norm's input
    and output gradient (the z16 stem's fused 1x1 + 4x4 pair runs outside
    its modules and is not captured)."""
    hooks = []
    for name, m in model.named_modules():
        if isinstance(m, LAYERS):
            def fwd(mod, inp, out, name=name):
                capture[name] = {"h": inp[0].detach()}
                out.register_hook(
                    lambda g: capture[name].__setitem__("dy", g.detach()))
            hooks.append(m.register_forward_hook(fwd))
    return hooks


def weight_grad(module, h, dy, cudnn=True):
    """The layer's weight gradient from its input and output gradient, in
    their dtype, on their device, TF32 off (batch norm in train mode)."""
    m = copy.deepcopy(module).to(dtype=h.dtype, device=h.device)
    m.train()
    for p in m.parameters():
        p.grad = None
    with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False), \
            fp32_strict():
        y = m(h)
        y.backward(dy)
    return m.weight.grad.detach()


def layer_witness(model, card, cpu, f64):
    out = {}
    for name, m in model.named_modules():
        if name not in card:
            continue
        h, dy = card[name]["h"], card[name]["dy"]
        exact = weight_grad(m, h.double(), dy.double())
        row = {}
        for side, cap in (("card", card), ("cpu", cpu)):
            for k in ("h", "dy"):
                row[f"{side}_{k}_err"] = rel_l2(
                    cap[name][k].double().cpu(), f64[name][k])
        row["kernel_err"] = rel_l2(weight_grad(m, h, dy).double(), exact)
        if isinstance(m, nn.BatchNorm2d):
            row["native_kernel_err"] = rel_l2(
                weight_grad(m, h, dy, cudnn=False).double(), exact)
            hd = h.double()
            xhat = (hd - hd.mean((0, 2, 3), keepdim=True)) / hd.std(
                (0, 2, 3), unbiased=False, keepdim=True)
            terms = dy.double() * xhat
            row["cond"] = float((terms.abs().sum((0, 2, 3))
                                 / terms.sum((0, 2, 3)).abs()).max())
        out[name] = row
    return out


def train_a_few_steps(model, network, dev, steps, seed):
    """Adam at lr 1e-4 on batch-768 patches, as ``run_training`` trains
    (the z16 family with augmentation, a ResNet on 192 labels x 4)."""
    x = torch.from_numpy(zscore(smoke.blob_patches(
        np.random.RandomState(seed + 1000), smoke.TRAIN_BATCH))
        .astype(np.float32)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    if network.startswith("ResNet"):
        train = make_triplet_steps(model, opt)[0]
        labels = (torch.arange(smoke.TRAIN_BATCH) // smoke.N_POS).to(dev)
        for _ in range(steps):
            train(x, labels)
    else:
        train = make_train_step(model, opt, augment=True,
                                generator=torch.Generator(device=dev)
                                .manual_seed(seed))
        for _ in range(steps):
            train(x)
    opt.zero_grad(set_to_none=True)


def one_model(network, seed, train_steps, dev, data):
    torch.manual_seed(seed)
    model = smoke.e1_model(network)
    if train_steps:
        model = model.to(dev)
        train_a_few_steps(model, network, dev, train_steps, seed)
        model = model.cpu()
    x = torch.from_numpy(zscore(data).astype(np.float32))
    labels = torch.arange(CHECK) // (CHECK // 2)
    g = torch.Generator().manual_seed(seed)
    zshape = (CHECK, smoke.NET["num_hiddens"], 16, 16)
    noise = {}
    if network == "VAE":
        noise["eps"] = torch.randn(zshape, generator=g)
    if network == "IWAE":
        noise["fixed_eps"] = torch.randn((model.k,) + zshape, generator=g)

    def run(device, dtype, masks, replay=False, capture=None):
        m = copy.deepcopy(model).to(device=device, dtype=dtype)
        hooks = capture_layers(m, capture) if capture is not None else []
        try:
            grads = smoke.e1_step_grads(
                torch, m, network, x.to(device, dtype),
                {k: v.to(device, dtype) for k, v in noise.items()},
                labels.to(device), True, masks, replay)[1]
        finally:
            for h in hooks:
                h.remove()
        return m, grads

    masks = {"card": [], "cpu": [], "f64": []}
    caps = {"card": {}, "cpu": {}, "f64": {}}
    card_model, g_card = run(dev, torch.float32, masks["card"],
                             capture=caps["card"])
    _, g_cpu = run("cpu", torch.float32, masks["cpu"], capture=caps["cpu"])
    _, g_f64 = run("cpu", torch.float64, masks["f64"], capture=caps["f64"])
    _, g_f64_card = run("cpu", torch.float64, masks["card"], replay=True)
    _, g_f64_cpu = run("cpu", torch.float64, masks["cpu"], replay=True)
    names = list(g_f64)

    def worst(ref, cpu_ref, factor, floor):
        r = {n: rel_l2(g_card[n], ref[n]) / (
            factor * rel_l2(g_cpu[n], cpu_ref[n]) + floor) for n in names}
        n = max(r, key=r.get)
        return {"ratio": r[n], "tensor": n,
                "err": rel_l2(g_card[n], ref[n]),
                "cpu_err": rel_l2(g_cpu[n], cpu_ref[n])}

    flips = {k: sum(int((a != b).sum()) for a, b in
                    zip(masks[k], masks["f64"])) for k in ("card", "cpu")}
    return dict(
        network=network, seed=seed, train_steps=train_steps, flips=flips,
        choices=sum(int(m.numel()) for m in masks["f64"]),
        own_masks_10x=worst(g_f64, g_f64, 10.0, 1e-4),
        own_masks_3x=worst(g_f64, g_f64, 3.0, 1e-5),
        replayed_3x=worst(g_f64_card, g_f64_cpu, 3.0, 1e-5),
        layers=layer_witness(card_model, caps["card"], caps["cpu"],
                             caps["f64"]))


def describe(row):
    lay = row["layers"]
    kern = max(lay, key=lambda n: lay[n]["kernel_err"])
    grow = max(lay, key=lambda n: lay[n]["card_dy_err"]
               / max(lay[n]["cpu_dy_err"], 1e-30))
    rules = "; ".join(
        f"{k} {row[k]['tensor']} at {row[k]['ratio']:.3f} (card "
        f"{row[k]['err']:.2e}, CPU {row[k]['cpu_err']:.2e})"
        for k in ("own_masks_10x", "own_masks_3x", "replayed_3x"))
    return (f"{row['network']} seed {row['seed']} steps "
            f"{row['train_steps']}: flips card {row['flips']['card']} "
            f"CPU {row['flips']['cpu']} of {row['choices']}; {rules}"
            f" | worst card kernel {kern} {lay[kern]['kernel_err']:.2e}"
            f" | dy grows most at {grow}: card "
            f"{lay[grow]['card_dy_err']:.2e}, CPU "
            f"{lay[grow]['cpu_dy_err']:.2e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nets", default="IWAE,VAE,AAE")
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--seed0", type=int, default=0)
    ap.add_argument("--train-steps", default="0",
                    help="comma-separated Adam steps before the check")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="build/step_grad_witness.jsonl")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    data = smoke.blob_patches(np.random.RandomState(smoke.SEED + 12), CHECK)
    rows = []
    with open(args.out, "w") as f:
        for network in args.nets.split(","):
            for steps in (int(s) for s in args.train_steps.split(",")):
                for seed in range(args.seed0, args.seed0 + args.seeds):
                    row = one_model(network, seed, steps, dev, data)
                    rows.append(row)
                    f.write(json.dumps(row) + "\n")
                    f.flush()
                    print(describe(row), flush=True)
    summary = {k: dict(over=int(sum(r[k]["ratio"] > 1 for r in rows)),
                       max=max(r[k]["ratio"] for r in rows))
               for k in ("own_masks_10x", "own_masks_3x", "replayed_3x")}
    lay = [e for r in rows for e in r["layers"].values()]
    print(json.dumps({
        "models": len(rows), "summary": summary,
        "models_with_card_flips": int(sum(r["flips"]["card"] > 0
                                          for r in rows)),
        "over_own_masks_3x_without_card_flips": int(sum(
            r["own_masks_3x"]["ratio"] > 1 and r["flips"]["card"] == 0
            for r in rows)),
        "kernel_err_max": max(e["kernel_err"] for e in lay),
        "native_bn_kernel_err_max": max(e.get("native_kernel_err", 0.0)
                                        for e in lay),
        "bn_cond_max": max(e.get("cond", 0.0) for e in lay)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
