"""Drives the measured program's VQ-VAE trainer for one cell.

A session runs in the process that holds the card: one process for a
one-card cell, and each local rank of ``core.mesh.run_local_ranks`` for a
cell over several cards, as the program's ``run_training.run`` starts them
on a machine with several cards. It makes the inputs from the seed, builds
the program's model from the seed's weights, and calls the program's
``train_vqvae`` three times with the same model:

1. one epoch whose first three steps are read (``FirstSteps``): each
   step's loss, the first gradient as Adam holds it, and each leaf's
   change after the third step; and the epoch's validation losses, from
   the call's history;
2. one warm epoch, timed: it sets how many epochs fill the window;
3. the window: whole epochs, under ``torch.profiler`` when traced.

Every shape the window uses (full and partial batches, training and
validation) has run in 1 and 2, so nothing is planned or built inside it.
After the window the session names the modules it finds loaded that a
run may not load (``forbidden_modules``): over ranks each rank looks in
its own process.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from dynamorph_tpu_torch.core import mesh
from dynamorph_tpu_torch.models.registry import build_model
from dynamorph_tpu_torch.train.trainer import train_vqvae
from reference import vqvae as ref

from . import data as D
from . import trace as T

STEPS = 3
# modules that may not be loaded in a process of the run, compared by
# their whole top-level name (``dynamorph_tpu_torch`` is not one)
FORBIDDEN = ("jax", "jaxlib", "flax", "dynamorph_tpu")
MODEL_KEYS = ("num_inputs", "num_hiddens", "num_residual_hiddens",
              "num_residual_layers", "num_embeddings", "commitment_cost",
              "weight_matching", "w_a", "w_t", "w_n", "margin")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def epoch_batches(n: int, cfg: Dict, ranks: int):
    """(training, validation) batch sizes of one epoch, in rows of the
    global batch; runs over several ranks drop partial batches."""
    batch = cfg["batch_size"] * ranks
    n_val = int(np.floor(cfg["val_split_ratio"] * n))
    out = []
    for rows in (n - n_val, n_val):
        full, rest = divmod(rows, batch)
        out.append([batch] * full + ([rest] if rest and ranks == 1 else []))
    return out


class Inputs:
    """A cell's inputs from the seed: trajectory lengths, relations, the
    patches (on ``device`` and as the host array the trainer takes) and
    the starting weights."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device,
                 host: bool = True):
        self.lengths = D.trajectory_lengths(
            traffic["patches"], *traffic["trajectory_frames"], seed)
        self.relations = D.relations(self.lengths)
        self.traj = ref.trajectory_ids(self.lengths)
        self.patches = D.patches(self.lengths, traffic["patch_size"], seed,
                                 device)
        self.host = None
        if host:
            self.host = self.patches.cpu().numpy()
            self.patches = None
        self.weights = D.weights(ref.param_specs(cfg), seed, device)


def program_model(cfg: Dict, weights: Dict[str, torch.Tensor], device):
    """The program's model for ``cfg`` with ``weights`` in every trained
    parameter (the names must match both ways)."""
    model = build_model(cfg["network"], **{k: cfg[k] for k in MODEL_KEYS})
    names = {n for n, _ in model.named_parameters()}
    if names != set(weights):
        raise ValueError(f"parameters differ from the reference's: "
                         f"{sorted(names ^ set(weights))}")
    state = model.state_dict()
    state.update({k: v.detach().cpu() for k, v in weights.items()})
    model.load_state_dict(state, strict=True)
    return model.to(device)


class FirstSteps:
    """Reads the first ``STEPS`` training steps of the trainer call made
    inside the block: each step's total loss (from the model's ``apply``),
    the first gradient of each leaf (from Adam's first moment after step
    1, which is (1 - beta1) times it), and each leaf's change from
    ``start`` after the last of them, before the next step moves it."""

    def __init__(self, model, start: Dict[str, torch.Tensor]):
        self.model, self.start = model, start
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.losses: List[torch.Tensor] = []
        self.grad: Dict[str, torch.Tensor] = {}
        self.change: Dict[str, torch.Tensor] = {}
        self.steps = 0

    def __enter__(self):
        apply = self.model.apply

        def reading_apply(x, train=False, **kw):
            decoded, losses = apply(x, train=train, **kw)
            if train and len(self.losses) < STEPS:
                self.losses.append(losses["total_loss"].detach().clone())
            return decoded, losses

        self.model.apply = reading_apply
        self.hook = register_optimizer_step_post_hook(self._after_step)
        return self

    def _after_step(self, opt, args, kwargs):
        self.steps += 1
        with torch.no_grad():
            if self.steps == 1:
                for group in opt.param_groups:
                    b1 = group["betas"][0]
                    for p in group["params"]:
                        m = opt.state[p]["exp_avg"]
                        self.grad[self.names[id(p)]] = \
                            torch.linalg.vector_norm(m) / (1 - b1)
            if self.steps == STEPS:
                for n, p in self.model.named_parameters():
                    self.change[n] = torch.linalg.vector_norm(
                        p.detach() - self.start[n])

    def __exit__(self, *exc):
        del self.model.apply
        self.hook.remove()
        if not self.change:
            # fewer optimizer steps than training steps: read the leaves
            # as the call left them, and no gradient where Adam held none
            with torch.no_grad():
                for n, p in self.model.named_parameters():
                    self.change[n] = torch.linalg.vector_norm(
                        p.detach() - self.start[n])
                    self.grad.setdefault(n, torch.zeros(()))
        return False

    def readings(self) -> Dict:
        if len(self.losses) < STEPS:
            raise RuntimeError(f"the first trainer call ran "
                               f"{len(self.losses)} training steps; "
                               f"{STEPS} are read")
        return {"loss": [float(v) for v in self.losses],
                "grad": {k: float(v) for k, v in self.grad.items()},
                "change": {k: float(v) for k, v in self.change.items()}}


class EpochClock:
    """The host time of the first optimizer step of the trainer call made
    inside the block: from there to the call's end is an epoch of a
    one-epoch call less its first step, without the call's own start
    (the data's upload)."""

    def __enter__(self):
        self.first = None
        self.hook = register_optimizer_step_post_hook(self._after_step)
        return self

    def _after_step(self, opt, args, kwargs):
        if self.first is None:
            self.first = time.perf_counter()

    def __exit__(self, *exc):
        self.hook.remove()
        return False


def _trainer(model, inp: Inputs, cfg: Dict, ranks: int, seed: int,
             epochs: int, out_dir: str, device):
    # the program prints its early-stopping notes on standard output,
    # which carries the result line
    with contextlib.redirect_stdout(sys.stderr):
        return train_vqvae(
            model, inp.host, out_dir, relation_mat=inp.relations,
            n_epochs=epochs, lr=cfg["learn_rate"],
            batch_size=cfg["batch_size"] * ranks,
            shuffle_data=cfg["shuffle_data"], transform=cfg["augmentation"],
            val_split_ratio=cfg["val_split_ratio"], patience=cfg["patience"],
            seed=D.trainer_seed(seed), traj_sharded_loss=ranks > 1,
            device=device)[1]


def read_epoch(model, inp: Inputs, cfg: Dict, ranks: int, seed: int,
               out_dir: str, device) -> Dict:
    """The first trainer call, one epoch, read: ``FirstSteps``'s readings
    and ``"val"``, the epoch's validation losses from its history."""
    with FirstSteps(model, inp.weights) as first:
        history = _trainer(model, inp, cfg, ranks, seed, 1, out_dir, device)
    return dict(first.readings(), val=dict(history[0]["val"]))


def reference(cfg: Dict, traffic: Dict, seed: int, ranks: int, device,
              **kw) -> Dict:
    """The plain reference's epoch on the seed's inputs, made anew on
    ``device`` (``kw``: ``tf32`` or ``fault`` for the controls)."""
    inp = Inputs(cfg, traffic, seed, device, host=False)
    return ref.follow(cfg, inp.weights,
                      lambda ids: inp.patches[torch.as_tensor(
                          ids, device=inp.patches.device)],
                      inp.relations, inp.traj, ranks, D.trainer_seed(seed),
                      device=device, **kw)


def _agree(value: int) -> int:
    """Rank 0's ``value`` on every rank (itself on one process)."""
    if not mesh.is_distributed():
        return value
    t = torch.tensor([value], dtype=torch.int64)
    mesh.ProcessGroupComm().broadcast(t)
    return int(t.item())


def session(cfg: Dict, traffic: Dict, seed: int, seconds: float,
            trace: bool, t0: float, out_dir: str,
            device: Optional[str] = None) -> Dict:
    """Set-up, the read steps, the warm epoch and the window on this
    process's card. ``t0`` is the ``time.monotonic()`` at which the run
    started. Returns this process's timings and readings."""
    dev = torch.device(device) if device else mesh.rank_device() or \
        torch.device("cuda", 0)
    ranks = mesh.process_count() if mesh.is_distributed() else 1
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    marks = [("start", t0)]

    def mark(what):
        sync()
        marks.append((what, time.monotonic()))

    inp = Inputs(cfg, traffic, seed, dev)
    mark("inputs")
    model = program_model(cfg, inp.weights, dev)
    readings = read_epoch(model, inp, cfg, ranks, seed, out_dir, dev)
    mark("read epoch")
    t = time.perf_counter()
    with EpochClock() as clock:
        _trainer(model, inp, cfg, ranks, seed, 1, out_dir, dev)
        sync()
    warm_s = time.perf_counter() - (clock.first or t)
    mark("warm epoch")
    epochs = max(1, round(seconds / warm_s))
    if trace:
        epochs = max(1, min(epochs, round(traffic["trace_seconds"] /
                                          warm_s)))
    epochs = _agree(epochs)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    mesh.barrier("window")
    mark("window")
    setup_s = marks[-1][1] - t0
    summary = None
    t = time.perf_counter()
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            with record_function(T.WINDOW):
                history = _trainer(model, inp, cfg, ranks, seed, epochs,
                                   out_dir, dev)
                sync()
            # before the profiler stops: collecting the trace is no work
            # of the window's
            window_s = time.perf_counter() - t
        summary = T.summarize(prof)
        del prof
    else:
        history = _trainer(model, inp, cfg, ranks, seed, epochs, out_dir,
                           dev)
        sync()
        window_s = time.perf_counter() - t
    mesh.barrier("window end")
    failed = sum(not np.isfinite(h["train"].get("total_loss", np.nan))
                 for h in history)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    del model, inp
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return {"setup_s": setup_s, "window_s": window_s, "warm_s": warm_s,
            "epochs": len(history), "failed": int(failed),
            "readings": readings, "memory_peak_bytes": int(peak),
            "trace": summary, "forbidden": forbidden_modules(),
            "setup_parts": {w: b - a for (_, a), (w, b) in zip(marks,
                                                             marks[1:])}}
