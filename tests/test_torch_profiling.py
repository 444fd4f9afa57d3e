"""The port's spans and counters (``core/profiling.py``) inside its VQ-VAE
trainer, and ``stage_timer`` built on them.

One tiny port-only ``train_vqvae`` on the CPU, three times from the same
weights: under ``torch.profiler`` (recorded), with nothing set
(unrecorded), and with ``DYNAMORPH_TIMING_LOG`` set (recorded and logged)
under a profiler that follows every thread, so that the loader thread's
spans reach its trace too (a default profiler follows only the thread
that started it, and the threads torch starts for it).
28 patches of 32² with a mask and four trajectories, batch 10, 2 epochs:
24 patches train in batches of 10, 10 and 4, and 4 validate in one
batch. TensorBoard is left out (``tensorboardX`` unimportable), which the
metrics writer allows: its import takes seconds.
"""
import json
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dynamorph_tpu.core.profiling import stage_timer as jax_stage_timer
from dynamorph_tpu_torch.core import profiling
from dynamorph_tpu_torch.models import VQVAEz32
from dynamorph_tpu_torch.train import data as tdata
from dynamorph_tpu_torch.train.trainer import train_vqvae

TRAIN_KW = dict(num_hiddens=8, num_residual_hiddens=8, num_embeddings=16,
                weight_matching=100.0, margin=1.0, w_a=1.0, w_t=0.5,
                w_n=-0.5)
EPOCHS, TRAIN_BATCHES, VAL_BATCHES = 2, (10, 10, 4), (4,)
SPANS = ("train.call", "train.upload", "train.epoch", "train.feed_wait",
         "train.load", "train.drained", "train.checkpoint")
COUNTERS = ("train.steps", "train.val_steps", "train.h2d_bytes",
            "train.checkpoints", "train.bn_kernel", "train.bn_fallback")
# VQVAEz32's training-mode batch norms a step (enc.1, enc.4, dec.2 and
# two a residual layer in each of its two stacks of two)
BN_A_STEP = 11


def _relations():
    """Four trajectories of five frames (2: adjacent, 1: same trajectory)
    among the patches."""
    rel = {}
    for t in range(4):
        frames = range(t * 5, t * 5 + 5)
        for a in frames:
            for b in frames:
                if a != b:
                    rel[(a, b)] = 2 if abs(a - b) == 1 else 1
    return rel


@pytest.fixture(scope="module")
def calls(tmp_path_factory):
    root = tmp_path_factory.mktemp("profiling")
    r = np.random.RandomState(0)
    data = r.randn(28, 2, 32, 32).astype(np.float32)
    mask = np.where(r.rand(28, 2, 32, 32) > 0.5, 1.0, -1.0)
    ds, rel, order = tdata.reorder_with_trajectories(data, _relations(), 0)
    mask = mask[order]
    torch.manual_seed(0)
    init = VQVAEz32(**TRAIN_KW).state_dict()
    log_path = root / "timing.jsonl"

    def call(name):
        model = VQVAEz32(**TRAIN_KW)
        model.load_state_dict(init)
        return train_vqvae(model, ds, str(root / name), relation_mat=rel,
                           mask=mask, n_epochs=EPOCHS, batch_size=10,
                           patience=5, transform=False, lr=1e-4,
                           device="cpu")[1]

    def events(prof):
        return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                for e in prof.profiler.kineto_results.events()]

    out = {"mask": mask, "ds": ds}
    # one thread: the steps are tiny, and the test workers share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorboardX", None)
        mp.delenv(profiling.LOG_ENV, raising=False)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out["hist.profiled"] = call("profiled")
        out["record.profiled"] = profiling.last_record("train_vqvae")
        out["events.profiled"] = events(prof)
        out["recording.plain"] = profiling.recording()
        out["hist.plain"] = call("plain")
        out["record.after_plain"] = profiling.last_record("train_vqvae")
        mp.setenv(profiling.LOG_ENV, str(log_path))
        every_thread = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=every_thread) as prof:
            out["hist.logged"] = call("logged")
        out["record.logged"] = profiling.last_record("train_vqvae")
        out["events.logged"] = events(prof)
    torch.set_num_threads(threads)
    out["log"] = [json.loads(line) for line in
                  log_path.read_text().splitlines()]
    return out


def _improving(history):
    best, n = np.inf, 0
    for h in history:
        if h["val"]["total_loss"] < best:
            best, n = h["val"]["total_loss"], n + 1
    return n


@pytest.mark.parametrize("how", ["profiled", "logged"])
def test_record_counts(calls, how):
    rec = calls[f"record.{how}"]
    assert set(rec) == {"device", "seconds", "spans", "counters"}
    assert rec["device"] == "cpu"
    assert set(rec["spans"]) == set(SPANS)
    assert set(rec["counters"]) == set(COUNTERS)
    counts = {k: c for k, (c, _) in rec["spans"].items()}
    n_train, n_val = EPOCHS * len(TRAIN_BATCHES), EPOCHS * len(VAL_BATCHES)
    checkpoints = _improving(calls[f"hist.{how}"])
    assert checkpoints >= 1
    assert counts == {"train.call": 1, "train.upload": 1,
                      "train.epoch": EPOCHS,
                      "train.feed_wait": n_train + n_val,
                      "train.load": n_train + n_val,
                      "train.drained": 2 * EPOCHS,
                      "train.checkpoint": checkpoints}
    # the resident upload (patches, then the uint8 mask channel), and a
    # batch's uint8 relation block and int32 indices
    batches = EPOCHS * (TRAIN_BATCHES + VAL_BATCHES)
    h2d = calls["ds"].nbytes + calls["mask"][:, :1].size + \
        sum(b * b + 4 * b for b in batches)
    # on the CPU every batch norm takes F.batch_norm; validation's run on
    # the running statistics and count in neither
    assert rec["counters"] == {"train.steps": n_train,
                               "train.val_steps": n_val,
                               "train.h2d_bytes": h2d,
                               "train.checkpoints": checkpoints,
                               "train.bn_kernel": 0,
                               "train.bn_fallback": BN_A_STEP * n_train}
    assert rec["seconds"] == rec["spans"]["train.call"][1] > 0
    inner = sum(rec["spans"][k][1] for k in ("train.upload",
                                             "train.epoch"))
    assert inner <= rec["seconds"]


@pytest.mark.parametrize("how", ["profiled", "logged"])
def test_spans_in_the_profiler_trace(calls, how):
    """Every span is a CPU event of the trace, as often as the record
    counts it, and inside ``train.call``; the loader thread's
    ``train.load`` where the profiler follows every thread."""
    events = [e for e in calls[f"events.{how}"] if e[0] in SPANS]
    (_, c0, c1), = [e for e in events if e[0] == "train.call"]
    rec = calls[f"record.{how}"]
    followed = [n for n in SPANS if how == "logged" or n != "train.load"]
    assert {e[0] for e in events} == set(followed)
    for name in followed:
        mine = [e for e in events if e[0] == name]
        assert len(mine) == rec["spans"][name][0], name
        assert all(c0 <= s <= t <= c1 for _, s, t in mine), name
    # a drained span lies inside its epoch's, and a checkpoint inside a
    # drained one
    for inner, outer in (("train.drained", "train.epoch"),
                         ("train.checkpoint", "train.drained")):
        for _, s, t in (e for e in events if e[0] == inner):
            assert any(a <= s and t <= b for n, a, b in events
                       if n == outer), inner


def test_unrecorded_call(calls):
    """With no profiler and no log nothing is recorded: the last record
    stays the profiled call's, and the history is bit-equal to both
    recorded calls'."""
    assert not calls["recording.plain"]
    assert calls["record.after_plain"] is calls["record.profiled"]
    assert calls["hist.plain"] == calls["hist.profiled"] == \
        calls["hist.logged"]
    assert profiling.Record(False).span("x") is \
        profiling.Record(False).span("y")


def test_timing_log(calls):
    """One record for each epoch and one for the call, each with its
    stage, seconds and the spans and counters."""
    epochs, (call,) = calls["log"][:-1], calls["log"][-1:]
    assert [r["stage"] for r in epochs] == ["train.epoch"] * EPOCHS
    assert [r["epoch"] for r in epochs] == list(range(EPOCHS))
    for r in calls["log"]:
        assert {"stage", "seconds", "time", "spans", "counters"} <= set(r)
    for r in epochs:
        assert r["seconds"] == r["spans"]["train.epoch"][1] > 0
        assert r["spans"]["train.drained"][0] == 2
        assert r["counters"]["train.steps"] == len(TRAIN_BATCHES)
        assert r["counters"]["train.val_steps"] == len(VAL_BATCHES)
    assert call["stage"] == "train_vqvae"
    rec = calls["record.logged"]
    assert {k: call[k] for k in rec} == rec
    assert sum(r["counters"].get("train.checkpoints", 0)
               for r in epochs) == rec["counters"]["train.checkpoints"]


@pytest.mark.parametrize("via", ["argument", "environment"])
def test_stage_timer_records_unchanged(tmp_path, monkeypatch, via):
    """The port's ``stage_timer`` writes the JAX package's record, to the
    path it is given or to the timing log, and is a profiler range."""
    lines = {}
    for name, timer in (("port", profiling.stage_timer),
                        ("jax", jax_stage_timer)):
        path = tmp_path / f"{name}.jsonl"
        kw = {}
        if via == "argument":
            kw["log_path"] = str(path)
        else:
            monkeypatch.setenv(profiling.LOG_ENV, str(path))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with timer("unit_stage", site="s1", n=3, **kw):
                pass
        lines[name] = json.loads(path.read_text().strip())
        names = {e.name() for e in prof.profiler.kineto_results.events()}
        assert ("unit_stage" in names) == (name == "port")
    port, jax = lines["port"], lines["jax"]
    assert list(port) == list(jax) == ["stage", "seconds", "time", "site",
                                       "n"]
    assert (port["stage"], port["site"], port["n"]) == \
        (jax["stage"], jax["site"], jax["n"])
    assert port["seconds"] == round(port["seconds"], 4) >= 0
