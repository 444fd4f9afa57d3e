"""A run with the timed path broken underneath comes out not correct, and a
sound one correct: the harness driven on the CPU past its look for a card,
at a size a test holds (the published widths, batches of 16, 32 x 32
patches). The card-only control, the reference in TF32 in the program's
place, is marked ``cuda``."""
import json
import sys
import time

import pytest
import torch

import bench_faults
from bench_tiny import spec_of, tiny_copy
from yardstick.harness import run_cell

SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    return spec_of(tiny_copy(tmp_path_factory.mktemp("one")))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return spec_of(tiny_copy(tmp_path_factory.mktemp("four"), ranks=4))


def _run(spec, cell, session=None, trace=False):
    return run_cell(spec, cell, SEED, 0.5, trace, time.monotonic(),
                    device="cpu", session=session)


@pytest.mark.parametrize("cell", ["vqvae_z32.tiny", "vqvae_z16.tiny"])
def test_sound_run_is_correct(one_rank, cell):
    res = _run(one_rank, cell)
    assert res["correct"], res["compared"]
    assert res["metrics"]["train_patches_per_s"]["value"] > 0
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_traced_run_is_correct(one_rank):
    res = _run(one_rank, "vqvae_z16.tiny", trace=True)
    assert res["correct"], res["compared"]
    # a CPU run has no device trace: the device readers return nothing
    assert set(res["metrics"]) == {"train_mfu"}


# z16's tiny validation latents (4 x 4 a patch, 12 patches) use one or two
# of the 64 codes, which half the codebook may hold: the lookup's fault is
# planted in z32's, whose 8 x 8 latents use some twenty
@pytest.mark.parametrize("fault,cell", [
    ("state_unchanged", "vqvae_z32.tiny"), ("state_unchanged",
                                            "vqvae_z16.tiny"),
    ("half_batch", "vqvae_z32.tiny"), ("half_batch", "vqvae_z16.tiny"),
    ("half_codebook", "vqvae_z32.tiny")])
def test_fault_is_not_correct(one_rank, fault, cell, monkeypatch):
    from dynamorph_tpu_torch.models import vqvae
    from dynamorph_tpu_torch.train import steps
    monkeypatch.setattr(steps, "_backward_and_update",
                        steps._backward_and_update)
    monkeypatch.setattr(vqvae.VQVAEBase, "apply", vqvae.VQVAEBase.apply)
    monkeypatch.setattr(vqvae, "_lookup_nchw", vqvae._lookup_nchw)
    session = getattr(bench_faults, f"{fault}_session")
    res = _run(one_rank, cell, session)
    assert not res["correct"], res["compared"]
    if fault == "half_codebook":
        # training is sound: only the validation pass tells
        over = {k for k, v in res["compared"].items()
                if v["value"] > v["limit"]}
        assert over == {"val_gap"}, res["compared"]


@pytest.mark.parametrize("case", ["sound", "no_exchange", "jax_in_a_rank"])
def test_four_ranks(four_ranks, case, monkeypatch, capsys):
    """Four local ranks over gloo: sound; with the exchange between the
    ranks left out; and with a module named ``jax`` loaded in rank 1
    alone, which refuses the result line."""
    from yardstick.harness import report
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    session = None if case == "sound" else \
        getattr(bench_faults, f"{case}_session")
    res = _run(four_ranks, "vqvae_z32.tiny", session)
    if case == "jax_in_a_rank":
        assert "jax" not in sys.modules
        assert res["forbidden"] == ["jax"]
        capsys.readouterr()
        assert report(res) == 3
        assert capsys.readouterr().out == ""
        return
    assert res["correct"] == (case == "sound"), res["compared"]
    assert res["forbidden"] == []
    assert report(res) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[-1] == "compared" and \
        line["correct"] == (case == "sound")


def test_calibrate(one_rank):
    """The calibration's readings on the CPU: the program's gaps on a seed,
    and on another the control and each fault, the reference in the
    program's place; each fault reads above the sound run."""
    import calibrate
    from yardstick import calib
    seen = calibrate.calibrate(one_rank, "vqvae_z32.tiny", [SEED],
                               [SEED + 1], device="cpu",
                               out=lambda line: None)
    assert set(seen) == {"program", *calib.CONTROLS}
    for kind in ("half_batch", "unchanged", "half_codebook"):
        assert any(seen[kind][k][0] > 10 * seen["program"][k][0]
                   for k in seen[kind]), (kind, seen)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["vqvae_z32.train_b768",
                                  "vqvae_z16.train_b768"])
def test_tf32_control_is_not_correct(cell):
    """The reference in TF32 against the reference in fp32, at the
    published widths and batch 128 (the cell's limits): not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bench_tiny import ROOT
    from yardstick import correct, train
    spec = spec_of(ROOT)
    entry = spec.cell(cell)
    cfg = dict(spec.config(entry["config"]), batch_size=128)
    traffic = dict(spec.traffic(entry["traffic"]), patches=2304)
    exact = train.reference(cfg, traffic, SEED, 1, "cuda")
    tf32 = train.reference(cfg, traffic, SEED, 1, "cuda", tf32=True)
    ok, compared = correct.judge(correct.gaps(tf32, exact)[0],
                                 spec.limits(cell))
    assert not ok, compared
