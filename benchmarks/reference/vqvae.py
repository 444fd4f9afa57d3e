"""Plain PyTorch reference of VQ-VAE z16 / z32 training (DynaMorph,
github.com/mehta-lab/dynamorph: HiddenStateExtractor/vae.py VQ_VAE_z16
:216-346 and VQ_VAE_z32 :348-474, the training loop of run_training.py
:377-551).

It is the yardstick that decides ``correct``, so it is written out from the
published description and nothing else: its own layer tables, batch norm,
codebook search, losses, augmentation, batch order and Adam, in fp32 with
TF32 off. It imports neither the measured program nor the JAX package, and
calls no custom kernel.

Departures from the published code, each the measured program's documented
behaviour as well:

- the recon mask moves with its image under the augmentation (no mask is
  used here, so this never shows);
- the codebook search takes ``||e||^2 - 2 z.e`` (``||z||^2`` is constant
  along a row), and the first minimum wins;
- data-parallel batches are packed trajectory-whole onto the ranks
  (first-fit-decreasing), and a pair that lands on two ranks counts as a
  negative (relation 0), as the trajectory-sharded loss defines it.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
ADAM = dict(beta1=0.9, beta2=0.999, eps=1e-8)


# ---------------------------------------------------------------- layers

def _res_stack(prefix: str, nh: int, nrh: int, nrl: int) -> tuple:
    """One residual stack: each layer is x + BN(conv1x1(ReLU(BN(conv3x3(
    ReLU(x)))))), at the published Sequential indices 1, 2, 4, 5."""
    return ("res", prefix, [
        [("conv", f"{prefix}.layers.{i}.1", nh, nrh, 3, 1, 1),
         ("bn", f"{prefix}.layers.{i}.2", nrh),
         ("conv", f"{prefix}.layers.{i}.4", nrh, nh, 1, 1, 0),
         ("bn", f"{prefix}.layers.{i}.5", nh)] for i in range(nrl)])


def architecture(cfg: Dict) -> Dict[str, list]:
    """The encoder and decoder of ``cfg["network"]`` as layer tables.
    Entries: ("conv" | "convT", name, c_in, c_out, k, stride, pad),
    ("bn", name, c), ("relu",), ("res", name, layers)."""
    ni, nh = cfg["num_inputs"], cfg["num_hiddens"]
    nrh, nrl = cfg["num_residual_hiddens"], cfg["num_residual_layers"]
    if cfg["network"] == "VQ_VAE_z32":
        enc = [("conv", "enc.0", ni, nh // 2, 4, 2, 1),
               ("bn", "enc.1", nh // 2), ("relu",),
               ("conv", "enc.3", nh // 2, nh, 4, 2, 1),
               ("bn", "enc.4", nh),
               _res_stack("enc.5", nh, nrh, nrl)]
        dec = [_res_stack("dec.0", nh, nrh, nrl),
               ("convT", "dec.1", nh, nh // 2, 4, 2, 1),
               ("bn", "dec.2", nh // 2), ("relu",),
               ("convT", "dec.4", nh // 2, ni, 4, 2, 1)]
    elif cfg["network"] == "VQ_VAE_z16":
        enc = [("conv", "enc.0", ni, nh // 2, 1, 1, 0),
               ("conv", "enc.1", nh // 2, nh // 2, 4, 2, 1),
               ("bn", "enc.2", nh // 2), ("relu",),
               ("conv", "enc.4", nh // 2, nh, 4, 2, 1),
               ("bn", "enc.5", nh), ("relu",),
               ("conv", "enc.7", nh, nh, 4, 2, 1),
               ("bn", "enc.8", nh), ("relu",),
               ("conv", "enc.10", nh, nh, 3, 1, 1),
               ("bn", "enc.11", nh),
               _res_stack("enc.12", nh, nrh, nrl)]
        dec = [("convT", "dec.0", nh, nh // 2, 4, 2, 1), ("relu",),
               ("convT", "dec.2", nh // 2, nh // 4, 4, 2, 1), ("relu",),
               ("convT", "dec.4", nh // 4, nh // 4, 4, 2, 1), ("relu",),
               ("conv", "dec.6", nh // 4, ni, 1, 1, 0)]
    else:
        raise ValueError(f"no reference for network {cfg['network']!r}")
    return {"enc": enc, "dec": dec}


def flat_layers(table: list) -> List[tuple]:
    """The conv / convT / bn entries of a layer table, residual stacks
    opened, in order."""
    out = []
    for layer in table:
        if layer[0] == "res":
            for block in layer[2]:
                out.extend(block)
        elif layer[0] != "relu":
            out.append(layer)
    return out


def param_specs(cfg: Dict) -> List[tuple]:
    """(name, shape, init, bound) of every trained parameter, in the
    published state_dict names. ``init`` is "uniform" (within +-bound),
    "ones" or "zeros": torch's default init for convolutions and batch
    norm, and U(-1/K, 1/K) for the codebook (vae.py:31)."""
    specs = [("vq.w.weight", (cfg["num_embeddings"], cfg["num_hiddens"]),
              "uniform", 1.0 / cfg["num_embeddings"])]
    arch = architecture(cfg)
    for layer in flat_layers(arch["enc"]) + flat_layers(arch["dec"]):
        kind, name = layer[0], layer[1]
        if kind == "bn":
            specs += [(f"{name}.weight", (layer[2],), "ones", 0.0),
                      (f"{name}.bias", (layer[2],), "zeros", 0.0)]
            continue
        _, _, cin, cout, k, _, _ = layer
        shape = (cout, cin, k, k) if kind == "conv" else (cin, cout, k, k)
        # torch's fan-in: the weight's dim 1 times the kernel area
        bound = 1.0 / np.sqrt(shape[1] * k * k)
        specs += [(f"{name}.weight", shape, "uniform", bound),
                  (f"{name}.bias", (cout,), "uniform", bound)]
    return specs


# ---------------------------------------------------------------- forward

def _batch_norm(x, w, b, stats: Dict, train: bool):
    """Batch norm with the batch's statistics (``train``), which also move
    the running ones in ``stats`` (momentum BN_MOMENTUM, unbiased
    variance), or with the running ones."""
    shape = (1, -1, 1, 1)
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        if stats.get("update", True):
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                stats["mean"].mul_(1 - BN_MOMENTUM).add_(
                    mean.detach(), alpha=BN_MOMENTUM)
                stats["var"].mul_(1 - BN_MOMENTUM).add_(
                    var.detach() * (n / (n - 1)), alpha=BN_MOMENTUM)
    else:
        mean, var = stats["mean"], stats["var"]
    scale = w.reshape(shape) / torch.sqrt(var.reshape(shape) + BN_EPS)
    return (x - mean.reshape(shape)) * scale + b.reshape(shape)


def _layer(layer, p, x, stats, train):
    kind = layer[0]
    if kind == "relu":
        return torch.relu(x)
    if kind == "bn":
        return _batch_norm(x, p[f"{layer[1]}.weight"], p[f"{layer[1]}.bias"],
                           dict(stats[layer[1]], update=stats["update"]),
                           train)
    if kind == "res":
        for block in layer[2]:
            h = torch.relu(x)
            h = _layer(block[0], p, h, stats, train)
            h = torch.relu(_layer(block[1], p, h, stats, train))
            h = _layer(block[3], p, _layer(block[2], p, h, stats, train),
                       stats, train)
            x = x + h
        return x
    _, name, _, _, _, stride, pad = layer
    conv = F.conv2d if kind == "conv" else F.conv_transpose2d
    return conv(x, p[f"{name}.weight"], p[f"{name}.bias"], stride, pad)


def _run(table, p, x, stats, train):
    for layer in table:
        x = _layer(layer, p, x, stats, train)
    return x


def running_stats(cfg: Dict, device) -> Dict:
    """Each batch norm's running mean (0) and variance (1) as torch starts
    them; ``update`` False freezes them."""
    arch = architecture(cfg)
    return dict({layer[1]: {"mean": torch.zeros(layer[2], device=device),
                            "var": torch.ones(layer[2], device=device)}
                 for layer in flat_layers(arch["enc"]) +
                 flat_layers(arch["dec"]) if layer[0] == "bn"},
                update=True)


def nearest_codes(z_flat: torch.Tensor, codebook: torch.Tensor,
                  rows: int = 1 << 18) -> torch.Tensor:
    """argmin_k ||e_k||^2 - 2 z.e_k over the codebook, first minimum, in
    blocks of ``rows`` latents."""
    e2 = torch.sum(codebook * codebook, dim=1)
    out = []
    for i in range(0, z_flat.shape[0], rows):
        d = e2[None, :] - 2.0 * (z_flat[i:i + rows] @ codebook.T)
        out.append(torch.argmin(d, dim=1))
    return torch.cat(out)


def time_matching(z_flat, rel, cfg):
    """vae.py:322-335: mean over pairs of the weighted mean squared latent
    distance, with the hinge on negative pairs."""
    sq = torch.sum(z_flat * z_flat, dim=1)
    d = sq[:, None] + sq[None, :] - 2.0 * (z_flat @ z_flat.T)
    sim = torch.clamp(d, min=0.0) / z_flat.shape[1]
    w = torch.where(rel == 2, cfg["w_a"],
                    torch.where(rel == 1, cfg["w_t"], cfg["w_n"]))
    val = sim * w
    val = torch.where(rel == 0, torch.clamp(val + cfg["margin"], min=0.0),
                      val)
    return torch.mean(val)


def perplexity(idx: torch.Tensor, k: int) -> torch.Tensor:
    """exp of the entropy of the batch's code usage (vae.py:66-69)."""
    probs = torch.bincount(idx, minlength=k).to(torch.float32) / len(idx)
    return torch.exp(-torch.sum(probs * torch.log(probs + 1e-10)))


def losses(cfg, p, x, rel, stats: Dict, train: bool = True,
           half_codebook: bool = False) -> Dict[str, torch.Tensor]:
    """One batch's losses: recon, commitment (q_latent + commitment_cost x
    e_latent), time matching (on z_after for z32, z_before for z16) and
    their total, recon + commitment (weighted 1 and 1) + weight_matching x
    time matching (vae.py:319-342, :439-470); and the code usage's
    perplexity. ``train`` takes the batch statistics and moves the running
    ones; otherwise the running ones. ``half_codebook`` (a fault) searches
    the first half of the codebook alone."""
    arch = architecture(cfg)
    z = _run(arch["enc"], p, x, stats, train)
    codebook = p["vq.w.weight"]
    k = codebook.shape[0]
    b, d, h, w = z.shape
    z_rows = z.permute(0, 2, 3, 1).reshape(-1, d)
    with torch.no_grad():
        idx = nearest_codes(z_rows.detach(), codebook.detach()[
            :k // 2 if half_codebook else k])
    q = codebook[idx].reshape(b, h, w, d).permute(0, 3, 1, 2)
    e_latent = torch.mean((q.detach() - z) ** 2)
    q_latent = torch.mean((q - z.detach()) ** 2)
    c_loss = q_latent + cfg["commitment_cost"] * e_latent
    z_after = z + (q - z).detach()
    decoded = _run(arch["dec"], p, z_after, stats, train)
    # channel_var is (1, 1): the published default
    recon = torch.mean((decoded - x) ** 2)
    z_tm = z_after if cfg["network"] == "VQ_VAE_z32" else z
    tm = time_matching(z_tm.reshape(b, -1), rel, cfg)
    return {"recon_loss": recon, "commitment_loss": c_loss,
            "time_matching_loss": tm,
            "total_loss": recon + c_loss + cfg["weight_matching"] * tm,
            "perplexity": perplexity(idx, k)}


# ---------------------------------------------------------------- batches

def split_ids(n: int, val_split_ratio: float, seed: int):
    """run_training.py:487-497 with shuffle_data False: the val set is one
    contiguous window of ids, starting at a RandomState(seed) draw."""
    rng = np.random.RandomState(seed)
    split = int(np.floor(val_split_ratio * n))
    start = rng.randint(0, n - split)
    ids = np.arange(n)
    return np.concatenate([ids[:start], ids[start + split:]]), \
        ids[start:start + split]


def pack(bids: np.ndarray, traj: np.ndarray, ranks: int) -> np.ndarray:
    """A batch's ids reordered so each trajectory lands whole in one of
    ``ranks`` equal chunks where it fits: trajectories by size, largest
    first (equal sizes in order of first appearance), each into the first
    chunk with room; what fits nowhere fills the chunks' room in order."""
    cap = len(bids) // ranks
    groups: Dict[int, list] = {}
    for pos, sid in enumerate(bids):
        groups.setdefault(int(traj[sid]), []).append(pos)
    chunks = [[] for _ in range(ranks)]
    spill = []
    for g in sorted(groups.values(), key=len, reverse=True):
        for c in chunks:
            if len(c) + len(g) <= cap:
                c.extend(g)
                break
        else:
            spill.extend(g)
    for pos in spill:
        next(c for c in chunks if len(c) < cap).append(pos)
    return np.concatenate([bids[c] for c in chunks])


def epoch_batches(n: int, cfg: Dict, ranks: int, seed: int,
                  traj: np.ndarray):
    """(training, validation): the ids of one epoch's batches of the
    global batch ``cfg["batch_size"] * ranks``, in the order their rows are
    stepped, each packed onto the ranks when ``ranks`` > 1. Runs over
    several ranks drop partial batches; one rank steps them last."""
    batch = cfg["batch_size"] * ranks
    out = []
    for ids in split_ids(n, cfg["val_split_ratio"], seed):
        if ranks > 1:
            ids = ids[:len(ids) - len(ids) % batch]
        out.append([pack(ids[i:i + batch], traj, ranks) if ranks > 1
                    else ids[i:i + batch] for i in range(0, len(ids), batch)])
    return out


def relation_block(relation_csr, ids: np.ndarray, ranks: int) -> np.ndarray:
    """(B, B) relation codes of the rows ``ids``; with ``ranks`` > 1 the
    pairs across two ranks' chunks are 0."""
    block = np.asarray(relation_csr[ids][:, ids].todense()).astype(np.int64)
    if ranks > 1:
        chunk = np.arange(len(ids)) // (len(ids) // ranks)
        block[chunk[:, None] != chunk[None, :]] = 0
    return block


# ---------------------------------------------------------------- augment

def augment(x: torch.Tensor, flips: torch.Tensor,
            rots: torch.Tensor) -> torch.Tensor:
    """Per image: flip (0 none, 1 the H axis, 2 the W axis), then rotate by
    rots x 90 degrees in the (H, W) plane (run_training.py:396-403)."""
    out = torch.empty_like(x)
    for f in range(3):
        for r in range(4):
            sel = torch.nonzero((flips == f) & (rots == r)).reshape(-1)
            if len(sel) == 0:
                continue
            y = x[sel]
            if f:
                y = torch.flip(y, (f + 1,))
            out[sel] = torch.rot90(y, r, (2, 3))
    return out


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 on or off for convolutions and matrix products in the block."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# ---------------------------------------------------------------- steps

def follow(cfg: Dict, weights: Dict[str, torch.Tensor], rows, relation_csr,
           traj: np.ndarray, ranks: int, seed: int, steps: int = 3,
           tf32: bool = False, fault: Optional[str] = None,
           device="cuda") -> Dict:
    """One epoch from ``weights`` (name -> tensor): every training batch,
    with Adam (0.9, 0.999, 1e-8) at ``cfg["learn_rate"]`` and the running
    batch-norm statistics moving from torch's start, then the validation
    pass on the running statistics.

    ``rows(ids)`` gives the patches of the ids as a float32 tensor;
    ``relation_csr`` is the data's relation matrix and ``traj`` each
    sample's trajectory. The augmentation draws (flips, then rotations,
    one each per row of the global batch, every step) come from a
    ``torch.Generator`` on ``device`` seeded with ``seed``.

    ``tf32`` runs every convolution and product in TF32 (the control).
    ``fault`` plants a fault for the controls: "half_batch" steps on the
    first half of every batch alone; "no_exchange" steps on rank 0's chunk
    alone, as a rank that exchanges nothing; "unchanged" leaves the
    parameters and the running statistics as they were at every step;
    "half_codebook" searches the first half of the codebook alone in
    validation.

    Returns {"loss": [the first ``steps`` steps' total losses], "grad":
    {name: norm of the first step's gradient}, "change": {name: norm of
    the change after ``steps`` steps}, "val": {loss: the validation
    batches' mean}}.
    """
    if fault not in (None, "half_batch", "no_exchange", "unchanged",
                     "half_codebook"):
        raise ValueError(f"unknown fault {fault!r}")
    n = relation_csr.shape[0]
    train_b, val_b = epoch_batches(n, cfg, ranks, seed, traj)
    if len(train_b) < steps:
        raise ValueError(f"the data holds fewer than {steps} training "
                         f"batches")
    gen = torch.Generator(device=device).manual_seed(seed)
    p = {k: v.detach().to(device, torch.float32).clone().requires_grad_(True)
         for k, v in weights.items()}
    stats = running_stats(cfg, device)
    stats["update"] = fault != "unchanged"
    start = {k: v.detach().clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    lr, b1, b2, eps = cfg["learn_rate"], ADAM["beta1"], ADAM["beta2"], \
        ADAM["eps"]
    first, grad_norms, change = [], {}, {}
    with precision(tf32):
        for t, bids in enumerate(train_b, 1):
            x = rows(bids).to(device, torch.float32)
            rel = relation_block(relation_csr, bids, ranks)
            flips = torch.randint(0, 3, (len(bids),), generator=gen,
                                  device=device)
            rots = torch.randint(0, 4, (len(bids),), generator=gen,
                                 device=device)
            x = augment(x, flips, rots)
            keep = len(bids)
            if fault == "half_batch":
                keep = len(bids) // 2
            elif fault == "no_exchange":
                keep = len(bids) // ranks
            x, rel = x[:keep], rel[:keep, :keep]
            rel_t = torch.as_tensor(rel, device=device)
            total = losses(cfg, p, x, rel_t, stats)["total_loss"]
            grads = torch.autograd.grad(total, list(p.values()),
                                        allow_unused=True)
            if t <= steps:
                first.append(float(total.detach()))
            with torch.no_grad():
                for (k, w), g in zip(p.items(), grads):
                    g = torch.zeros_like(w) if g is None else g
                    if t == 1:
                        grad_norms[k] = float(torch.linalg.vector_norm(g))
                    if fault == "unchanged":
                        continue
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    m_hat = m[k] / (1 - b1 ** t)
                    v_hat = v2[k] / (1 - b2 ** t)
                    w.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))
                if t == steps:
                    change = {k: float(torch.linalg.vector_norm(
                        p[k].detach() - start[k])) for k in p}
            del x, rel_t, total, grads
        sums = {}
        with torch.no_grad():
            for bids in val_b:
                x = rows(bids).to(device, torch.float32)
                rel_t = torch.as_tensor(relation_block(relation_csr, bids,
                                                       ranks), device=device)
                got = losses(cfg, p, x, rel_t, stats, train=False,
                             half_codebook=fault == "half_codebook")
                for k, v in got.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
                del x, rel_t, got
    return {"loss": first, "grad": grad_norms, "change": change,
            "val": {k: v / len(val_b) for k, v in sums.items()}}


def trajectory_ids(lengths: Sequence[int]) -> np.ndarray:
    """Each sample's trajectory, for trajectories of ``lengths`` frames
    laid out one after another."""
    return np.repeat(np.arange(len(lengths)), lengths)
