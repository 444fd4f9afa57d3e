"""The trainer metrics' readers (``yardstick/spans.py`` through each
metric's file) on hand-made records of the program's trainer call: the
arithmetic, and nothing read over ranks, from a CPU record, from a record
whose step counts are not the window's, or where there is no record."""
import pytest

from bench_tiny import ROOT, spec_of
from yardstick.harness import Context

from dynamorph_tpu_torch.core import profiling

TRAIN_B, VAL_B = [768] * 20 + [308], [768] * 3 + [460]
EPOCHS = 3
METRICS = ["trainer.drained_share", "trainer.feed_wait_ms",
           "trainer.upload_ms"]


def _ctx(ranks=1):
    return Context(cfg={}, traffic={}, chips=ranks, ranks=ranks, setup_s=1.0,
                   window_s=10.0, epochs=EPOCHS, train_batches=TRAIN_B,
                   val_batches=VAL_B)


def _record(device="cuda", steps=EPOCHS * len(TRAIN_B),
            val_steps=EPOCHS * len(VAL_B), upload=True):
    spans = {"train.call": [1, 10.0], "train.drained": [6, 0.25],
             "train.feed_wait": [75, 0.15]}
    if upload:
        spans["train.upload"] = [1, 0.5]
    return {"device": device, "seconds": 10.0, "spans": spans,
            "counters": {"train.steps": steps, "train.val_steps": val_steps}}


@pytest.fixture
def recorded(monkeypatch):
    def plant(rec):
        monkeypatch.setattr(profiling, "last_record",
                            lambda kind: rec if kind == "train_vqvae"
                            else None)
    return plant


@pytest.mark.parametrize("prefix", ["", "z16."])
def test_arithmetic(recorded, prefix):
    spec = spec_of(ROOT)
    recorded(_record())
    read = {m: spec.reader(prefix + m)(_ctx()) for m in METRICS}
    assert read["trainer.drained_share"] == pytest.approx(2.5)
    assert read["trainer.feed_wait_ms"] == pytest.approx(
        150.0 / (EPOCHS * (len(TRAIN_B) + len(VAL_B))))
    assert read["trainer.upload_ms"] == pytest.approx(500.0)
    # a streamed feed has no upload span
    recorded(_record(upload=False))
    assert spec.reader(prefix + "trainer.upload_ms")(_ctx()) is None


@pytest.mark.parametrize("case", ["ranks", "cpu", "steps", "val_steps",
                                  "none"])
@pytest.mark.parametrize("metric", METRICS + ["z16." + m for m in METRICS])
def test_nothing_to_read(recorded, case, metric):
    ctx = _ctx(4) if case == "ranks" else _ctx()
    recorded({"ranks": _record(), "cpu": _record(device="cpu"),
              "steps": _record(steps=1), "val_steps": _record(val_steps=0),
              "none": None}[case])
    assert spec_of(ROOT).reader(metric)(ctx) is None
