"""The port's streaming encode (``pipeline/stream.py``) and the fused and
streaming branches of ``run_pipeline`` against the port's staged chain and
the JAX package, on the CPU.

Two copies of the fused tests' stub site (``C5-Site_0`` and ``C5-Site_1``,
3 frames of 2 x 64 x 64, 3 cells) in one well, window 32, VQ_VAE_z16 at
``tests/test_torch_pipeline_vae.py``'s widths and input 16 (the factor 2
of 256 -> 128), on that file's weights with the codebook drawn from the
encoder's own latent rows of these patches (a random codebook puts every
position on one code, and z_after would say nothing).

- streamed vs the port's staged chain (fused front end, assemble_vae,
  process_vae): file paths, static patches and latents bit for bit, for
  "mat" and "masked_mat": the resize is exact and both encode through
  ``encode_batch`` at one 512-row padded batch; and for "mat" at batch 8,
  where the stream splits the well's 18 rows into dispatches of 8, 8 and
  2, carrying rows over between frames, and puts them back in order
  (the split, the carry and the reorder are also pinned on a stand-in
  encode, with names whose sorted order is not the streamed one);
- the port's ``run_pipeline`` with ``patch.fused`` and
  ``latent_encoding.streaming`` vs the JAX package's: every artifact, the
  latents within 1e-4 (z_before) and z_after's codes equal, and the stage
  lists, fresh and resumed;
- the stage lists of every fallback against the JAX package's, with the
  stage functions of both packages stubbed.
"""
import os

import cv2
import numpy as np
import pytest
import torch

from dynamorph_tpu.config.schema import (LatentEncodingConfig as JaxLE,
                                         PatchConfig as JaxPatch,
                                         PipelineConfig as JaxPC,
                                         SegmentationInferenceConfig as JaxSI)
from dynamorph_tpu.pipeline import fused as jax_fused
from dynamorph_tpu.pipeline import orchestrator as jax_orch
from dynamorph_tpu.pipeline import patch_vae as jax_patch_vae
from dynamorph_tpu.pipeline import stream as jax_stream
from dynamorph_tpu_torch.cli import run_pipeline
from dynamorph_tpu_torch.io.pickles import load_pickle
from dynamorph_tpu_torch.io.sites import site_supp_folder
from dynamorph_tpu_torch.models import VQVAEz16
from dynamorph_tpu_torch.pipeline import orchestrator, stream
from dynamorph_tpu_torch.pipeline.patch import build_trajectories
from dynamorph_tpu_torch.pipeline.patch_vae import (_resize_chw,
                                                    assemble_vae,
                                                    encode_patches,
                                                    prepare_dataset,
                                                    process_vae)
from test_fused_seg_patch import _make_site
from test_torch_fused import (CHANNELS, WINDOW, _stub_jax, _stub_port,
                              run_port_fused)
from test_torch_patch_track import _assert_same
from test_torch_pipeline_vae import LE, well  # noqa: F401
from test_torch_train import _few_threads  # noqa: F401

WELL = "C5"
SITES = ["C5-Site_0", "C5-Site_1"]
INPUT = 16
LATENT_ATOL = 1e-4
# {case: (patch_type, batch_size)} of the streamed-vs-staged comparison
STREAM_CASES = {"mat": ("mat", 512), "masked_mat": ("masked_mat", 512),
                "mat_batch8": ("mat", 8)}
GRAPH = ["segmentation", "instance_segmentation", "extract_patches",
         "build_trajectories", "assemble", "process", "trajectory_matching"]


def _port_config(weights, patch_type="mat", **patch):
    from dynamorph_tpu_torch.config.schema import (LatentEncodingConfig,
                                                   PatchConfig,
                                                   PipelineConfig,
                                                   SegmentationInferenceConfig)

    return PipelineConfig(
        segmentation_inference=SegmentationInferenceConfig(
            channels=CHANNELS, weights="unused"),
        patch=PatchConfig(channels=CHANNELS, window_size=WINDOW, **patch),
        latent_encoding=LatentEncodingConfig(
            channels=CHANNELS, input_size=INPUT, patch_type=patch_type,
            weights=weights, **LE))


def _jax_config(weights, **patch):
    return JaxPC(
        segmentation_inference=JaxSI(channels=CHANNELS, weights="unused"),
        patch=JaxPatch(channels=CHANNELS, window_size=WINDOW, **patch),
        latent_encoding=JaxLE(channels=CHANNELS, input_size=INPUT,
                              weights=weights, **LE))


def _sites(root):
    for site in SITES:
        _make_site(root, site)
    return str(root), str(root / "supp")


def _staged(root, weights, patch_type, batch_size):
    """The port's staged chain: fused front end, build_trajectories,
    assemble_vae, process_vae."""
    raw, supp = _sites(root)
    config = _port_config(weights, patch_type)
    for site in SITES:
        run_port_fused(os.path.join(raw, f"{site}.npy"),
                       site_supp_folder(supp, site))
    build_trajectories(raw, supp, SITES, config)
    assemble_vae(raw, supp, SITES, config, patch_type=patch_type)
    process_vae(raw, supp, SITES, config, batch_size=batch_size,
                device="cpu")
    return raw, supp


@pytest.fixture(scope="module")
def weights(well, tmp_path_factory):
    """model.pt of ``test_torch_pipeline_vae``'s weights with 64 codebook
    rows drawn from the encoder's latent rows of the stub site's patches."""
    _, _, base = well
    root = tmp_path_factory.mktemp("codebook")
    raw, supp = _sites(root / "site")
    for site in SITES:
        run_port_fused(os.path.join(raw, f"{site}.npy"),
                       site_supp_folder(supp, site))
    stacks = [os.path.join(site_supp_folder(supp, s), f"stacks_{t}.pkl")
              for s in SITES for t in range(3)]
    data, _ = prepare_dataset(stacks, channels=CHANNELS, key="mat",
                              input_shape=(INPUT, INPUT))
    data = data[:, :, 0]                           # the stale z axis
    state = torch.load(os.path.join(base, "model.pt"))
    model = VQVAEz16()
    model.load_state_dict(state)
    z_b, _ = encode_patches(model, data, normalize="patch", device="cpu")
    rows = z_b.reshape(len(data), 16, -1).transpose(0, 2, 1).reshape(-1, 16)
    pick = np.random.RandomState(4).choice(len(rows), 64, replace=False)
    state["vq.w.weight"] = torch.from_numpy(rows[pick].copy())
    out = root / "weights"
    out.mkdir()
    torch.save(state, str(out / "model.pt"))
    return str(out)


@pytest.fixture(scope="module")
def chains(weights, tmp_path_factory):
    """{name: (raw, supp)} of: the port's staged chain and the port's
    streaming encode for each of STREAM_CASES, with the rows of each
    streamed encode dispatch; the port's run_pipeline CLI (fused +
    streaming) and the JAX package's run_pipeline on the same config; with
    the stage lists each returned, fresh and resumed."""
    root = tmp_path_factory.mktemp("stream")
    out = {"executed": {}, "dispatches": {}}
    mp = pytest.MonkeyPatch()
    try:
        _stub_port(mp)
        real_encode = stream.encode_batch
        for case, (patch_type, batch) in STREAM_CASES.items():
            out[f"staged_{case}"] = _staged(root / f"staged_{case}", weights,
                                            patch_type, batch)
            raw, supp = _sites(root / f"stream_{case}")
            rows = out["dispatches"][case] = []
            mp.setattr(stream, "encode_batch",
                       lambda m, x, *a, _r=rows, **k:
                       _r.append(len(x)) or real_encode(m, x, *a, **k))
            stream.seg_patch_stream(raw, supp, SITES,
                                    _port_config(weights, patch_type),
                                    batch_size=batch, patch_type=patch_type,
                                    device="cpu")
            mp.setattr(stream, "encode_batch", real_encode)
            out[f"stream_{case}"] = (raw, supp)
        # frames over three devices, the two sites in two groups
        raw, supp = out["stream_fanout"] = _sites(root / "stream_fanout")
        stream.seg_patch_stream(raw, supp, SITES, _port_config(weights),
                                patch_type="mat", device="cpu",
                                devices=[torch.device("cpu")] * 3,
                                site_parallelism=2)

        raw, supp = out["port"] = _sites(root / "port")
        cfg = root / "port.yml"
        cfg.write_text(
            f"patch:\n  raw_dirs: ['{raw}']\n  supp_dirs: ['{supp}']\n"
            f"  channels: {CHANNELS}\n  window_size: {WINDOW}\n"
            "  fused: true\n"
            f"segmentation_inference:\n  channels: {CHANNELS}\n"
            "  weights: 'unused'\n"
            f"latent_encoding:\n  channels: {CHANNELS}\n"
            f"  input_size: {INPUT}\n  weights: '{weights}'\n"
            "  streaming: true\n"
            + "".join(f"  {k}: {v!r}\n" for k, v in LE.items()))
        for run in ("fresh", "resumed"):
            out["executed"][f"port_{run}"] = run_pipeline.main(
                ["-c", str(cfg), "--stages", *GRAPH, "--device", "cpu"])[raw]
    finally:
        mp.undo()
    mp = pytest.MonkeyPatch()
    try:
        _stub_jax(mp)
        raw, supp = out["jax"] = _sites(root / "jax")
        config = _jax_config(weights, fused=True)
        config.latent_encoding.streaming = True
        for run in ("fresh", "resumed"):
            out["executed"][f"jax_{run}"] = jax_orch.run_pipeline(
                raw, supp, SITES, config, stages=GRAPH)
    finally:
        mp.undo()
    return out


def _well_artifacts(dirs):
    """{name: data} of a well's raw-dir pickles and its latents, with the
    supp root cut off the patch names."""
    raw, supp = dirs
    out = {}
    for name in sorted(os.listdir(raw)):
        if name.endswith(".pkl"):
            data = load_pickle(os.path.join(raw, name))
            if name.endswith("_file_paths.pkl"):
                data = [os.path.relpath(f, supp) for f in data]
            out[name] = data
    for name in sorted(os.listdir(os.path.join(raw, "weights"))):
        out["weights/" + name] = load_pickle(
            os.path.join(raw, "weights", name))
    return out


# -------------------------------------------------------------- the resize


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_resize_select_matches_resize_chw_and_cv2(factor):
    """On the pipeline's values (integers and half-integers below 2**16)
    the card's resize equals the staged float64 resize and cv2's, bit for
    bit, at factors 2, 3 and 4, with channels selected and reordered."""
    r = np.random.RandomState(factor)
    size = 16 * factor
    mat = r.randint(0, 2 ** 16, (5, 4, size, size)).astype(np.float32)
    mat += 0.5 * r.randint(0, 2, mat.shape).astype(np.float32)
    for channels in [(0, 1), (3, 0)]:
        ours = stream.resize_select(torch.from_numpy(mat), channels,
                                    factor).numpy()
        sel = mat[:, list(channels)].astype(np.float64)
        staged = _resize_chw(sel, (16, 16))
        via_cv2 = np.stack([cv2.resize(p.transpose(1, 2, 0), (16, 16))
                            .transpose(2, 0, 1) for p in sel])
        assert ours.dtype == np.float32 and ours.shape == (5, 2, 16, 16)
        np.testing.assert_array_equal(ours, staged.astype(np.float32))
        np.testing.assert_array_equal(staged, via_cv2)


# ---------------------------------------------- streamed vs the port's staged


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_stream_matches_port_staged(chains, case):
    """The streamed well equals the staged chain's at the same batch size:
    file paths, float64 static patches and both latents, bit for bit;
    z_after uses several codes. At batch 8 the 18 rows go out in three
    dispatches (8, 8 and a padded 2), rows carried over between frames."""
    want = {512: [18], 8: [8, 8, 2]}[STREAM_CASES[case][1]]
    assert chains["dispatches"][case] == want
    ours = _well_artifacts(chains[f"stream_{case}"])
    ref = _well_artifacts(chains[f"staged_{case}"])
    # the staged assemble also writes relations and labels (the stream
    # leaves them to assemble_relations)
    assert set(ref) - set(ours) == {f"{WELL}_static_patches_labels.pkl",
                                    f"{WELL}_static_patches_relations.pkl"}
    for name in ours:
        _assert_same(ours[name], ref[name], name)
    assert len(ours[f"{WELL}_file_paths.pkl"]) == 18
    assert ours[f"{WELL}_static_patches.pkl"].shape == (18, 2, 1, INPUT,
                                                         INPUT)
    z_a = ours[f"weights/{WELL}_latent_space_after.pkl"]
    codes = z_a.reshape(len(z_a), 16, -1).transpose(0, 2, 1).reshape(-1, 16)
    assert len(np.unique(codes, axis=0)) > 4


# ------------------------------------------ run_pipeline vs the JAX package


def test_run_pipeline_streaming_matches_jax(chains):
    """Fused + streaming run_pipeline through segmentation ...
    trajectory_matching: the site pickles, stacks, file paths, static
    patches, relations, labels and trajectory lists equal the JAX
    package's; z_before within 1e-4 and z_after on the same codes."""
    ours, ref = _well_artifacts(chains["port"]), _well_artifacts(
        chains["jax"])
    assert list(ours) == list(ref) and len(ours) == 7
    for name in ours:
        if name.startswith("weights/"):
            continue
        _assert_same(ours[name], ref[name], name)
    zb = ours[f"weights/{WELL}_latent_space.pkl"]
    zb_ref = ref[f"weights/{WELL}_latent_space.pkl"]
    assert zb.shape == zb_ref.shape == (18, 16 * 2 * 2)  # 16 ch at 2 x 2
    assert np.abs(zb - zb_ref).max() <= LATENT_ATOL
    np.testing.assert_array_equal(ours[f"weights/{WELL}_latent_space_after"
                                       ".pkl"],
                                  ref[f"weights/{WELL}_latent_space_after"
                                      ".pkl"])
    for site in SITES:
        a = site_supp_folder(chains["port"][1], site)
        b = site_supp_folder(chains["jax"][1], site)
        for name in ("cell_positions.pkl", "cell_pixel_assignments.pkl",
                     "cell_traj.pkl"):
            _assert_same(load_pickle(os.path.join(a, name)),
                         load_pickle(os.path.join(b, name)), name)
        for t in range(3):
            sa = {os.path.basename(k): v for k, v in load_pickle(
                os.path.join(a, f"stacks_{t}.pkl")).items()}
            sb = {os.path.basename(k): v for k, v in load_pickle(
                os.path.join(b, f"stacks_{t}.pkl")).items()}
            _assert_same(sa, sb, f"{site} stacks_{t}")


def test_stream_over_devices_matches_port_and_jax(chains):
    """The streaming encode with frames over three devices and the two
    sites in two groups: file paths, static patches and both latents
    equal the one-device stream's bit for bit, and the JAX package's
    run_pipeline (its 8-device CPU mesh: site- and frame-parallel) within
    the limits above."""
    ours = _well_artifacts(chains["stream_fanout"])
    one = _well_artifacts(chains["stream_mat"])
    assert list(ours) == list(one)
    for name in ours:
        _assert_same(ours[name], one[name], name)
    ref = _well_artifacts(chains["jax"])
    for name in ours:
        if not name.startswith("weights/"):
            _assert_same(ours[name], ref[name], name)
    zb = ours[f"weights/{WELL}_latent_space.pkl"]
    assert np.abs(zb - ref[f"weights/{WELL}_latent_space.pkl"]).max() <= \
        LATENT_ATOL
    np.testing.assert_array_equal(
        ours[f"weights/{WELL}_latent_space_after.pkl"],
        ref[f"weights/{WELL}_latent_space_after.pkl"])


def test_run_pipeline_streaming_stage_lists_match_jax(chains):
    ex = chains["executed"]
    assert ex["port_fresh"] == ex["jax_fresh"] == [
        "seg_patch_stream", "build_trajectories", "assemble",
        "trajectory_matching"]
    assert ex["port_resumed"] == ex["jax_resumed"] == []


# ------------------------------------------------------- failures, refusals


def test_stream_partial_failure_raises(weights, tmp_path, monkeypatch):
    """A site that fails in the front end fails the well: no latents, no
    static patches, no file paths are written."""
    _stub_port(monkeypatch)
    raw = tmp_path / "exp"
    _make_site(raw, SITES[0])
    with pytest.raises(RuntimeError, match=SITES[1]):
        stream.seg_patch_stream(str(raw), str(raw / "supp"), SITES,
                                _port_config(weights), device="cpu")
    for name in (f"{WELL}_file_paths.pkl", f"{WELL}_static_patches.pkl",
                 f"weights/{WELL}_latent_space.pkl"):
        assert not os.path.exists(raw / name)


def test_stream_rejects_resnet_network(weights, tmp_path):
    config = _port_config(weights)
    config.latent_encoding.network = "ResNet50"
    with pytest.raises(ValueError, match="VAE family"):
        stream.seg_patch_stream(str(tmp_path), str(tmp_path / "supp"),
                                SITES[:1], config, device="cpu")


def test_stream_encoder_splits_carries_and_reorders(monkeypatch):
    """12 frames of 1, 2 or 3 patches (patch c of frame t holds the value
    100 t + c), batch 5: the encoder dispatches 5, 5, 5, 5 and 4 rows,
    carrying the rows of a frame that straddles a batch over, and
    ``finish`` returns the names, both latents and the static patches in
    sorted-name order, where "10_0.h5" comes before "1_0.h5" and "2_0.h5",
    each row still beside its name."""
    rows = []

    def fake_encode(model, x, batch_size, normalize=None):
        rows.append(len(x))
        flat = x.reshape(len(x), -1)
        return flat[:, :1].clone(), -flat[:, :1]

    monkeypatch.setattr(stream, "encode_batch", fake_encode)
    enc = stream.StreamingWellEncoder(None, [1, 0], window_size=4,
                                      input_size=2, batch_size=5)
    for t in range(12):
        cells = [(c, (2, 2)) for c in range(t % 3 + 1)]
        mat = torch.stack([torch.full((2, 4, 4), 100.0 * t + c)
                           for c, _ in cells])
        enc.add_frame("s", t, {"mat": mat}, cells, "cpu")
    names, z_b, z_a, static = enc.finish()
    assert rows == [5, 5, 5, 5, 4]
    assert names == sorted(names) and len(names) == 24
    assert names[:3] == [os.path.join("s", n) for n in
                         ("0_0.h5", "10_0.h5", "10_1.h5")]
    want = np.array([100 * int(t) + int(c) for t, c in (
        os.path.basename(n)[:-3].split("_") for n in names)])
    np.testing.assert_array_equal(z_b[:, 0], want)
    np.testing.assert_array_equal(z_a[:, 0], -want)
    assert static.dtype == np.float64 and static.shape == (24, 2, 1, 2, 2)
    np.testing.assert_array_equal(static[:, 0, 0, 0, 0], want)


def test_stream_encoder_refuses_mask_channels_and_odd_geometry():
    with pytest.raises(ValueError, match="integer multiple"):
        stream.StreamingWellEncoder(None, CHANNELS, window_size=48,
                                    input_size=32)
    enc = stream.StreamingWellEncoder(None, [0, 2], window_size=32,
                                      input_size=16)
    with pytest.raises(ValueError, match="tm/tm2"):
        enc.add_frame("s", 0, {"mat": torch.zeros(1, 2, 32, 32)},
                      [(1, (5, 5))], "cpu")
    with pytest.raises(ValueError, match="no patches"):
        stream.StreamingWellEncoder(None, CHANNELS, window_size=32,
                                    input_size=16).finish()


# ------------------------------------------------ the stage lists' branches

# {case: (patch settings, streaming, network, stages asked for, stages run)}
FALLBACKS = {
    # patch.fused with a front-end stage missing: the staged front end
    "fused_partial_front_end": (
        dict(fused=True), False, "VQ_VAE_z16", GRAPH[1:4], GRAPH[1:4]),
    "fused": (dict(fused=True), False, "VQ_VAE_z16", GRAPH,
              ["seg_patch_fused"] + GRAPH[3:]),
    # streaming without process: fused + staged assemble
    "streaming_without_process": (
        dict(fused=True), True, "VQ_VAE_z16", GRAPH[:5],
        ["seg_patch_fused", "build_trajectories", "assemble"]),
    # streaming with a ResNet encoder: fused + staged assemble and process
    "streaming_resnet": (dict(fused=True), True, "ResNet50", GRAPH,
                         ["seg_patch_fused"] + GRAPH[3:]),
    # streaming without patch.fused: the staged graph
    "streaming_unfused": ({}, True, "VQ_VAE_z16", GRAPH, GRAPH),
    # sites in parallel: handed to the fused stage, as the JAX package does
    "fused_site_parallelism": (
        dict(fused=True, fused_site_parallelism=4), False, "VQ_VAE_z16",
        GRAPH, ["seg_patch_fused"] + GRAPH[3:]),
}


def _record(mp, module, names, calls):
    """Each stage function records its name and the site parallelism it
    was handed (None where it takes none)."""
    for name in names:
        mp.setattr(module, name,
                   lambda *a, _n=name, **k: calls.append(
                       (_n, k.get("site_parallelism"))) or [])


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_run_pipeline_branches_match_jax(case, tmp_path, monkeypatch,
                                        caplog):
    """Which stages run (and are returned) for patch.fused, streaming and
    each fallback: the port's run_pipeline against the JAX package's, the
    stage functions of both stubbed (resume off). ``fused_site_parallelism``
    reaches the fused and streaming stages as the JAX package hands it
    over, with no warning."""
    patch, streaming, network, stages, executed = FALLBACKS[case]
    fns = ["segmentation", "instance_segmentation", "extract_patches",
           "build_trajectories", "assemble_vae", "process_vae",
           "trajectory_matching"]
    ours, ref = [], []
    _record(monkeypatch, orchestrator,
            fns + ["seg_patch_fused", "seg_patch_stream",
                   "assemble_relations"], ours)
    monkeypatch.setattr(orchestrator, "load_well_inputs",
                        lambda *a: (None, None))
    _record(monkeypatch, jax_orch, fns, ref)
    _record(monkeypatch, jax_fused, ["seg_patch_fused"], ref)
    _record(monkeypatch, jax_stream, ["seg_patch_stream",
                                      "assemble_relations"], ref)
    monkeypatch.setattr(jax_patch_vae, "load_well_inputs",
                        lambda *a: (None, None))
    configs = []
    for make in (_port_config, _jax_config):
        config = make("unused", **patch)
        config.latent_encoding.streaming = streaming
        config.latent_encoding.network = network
        configs.append(config)
    got = orchestrator.run_pipeline(str(tmp_path), str(tmp_path), SITES,
                                    configs[0], stages=stages, resume=False,
                                    device="cpu")
    want = jax_orch.run_pipeline(str(tmp_path), str(tmp_path), SITES,
                                 configs[1], stages=stages, resume=False)
    assert got == want == executed
    assert ours == ref
    handed = {p for n, p in ours if n in ("seg_patch_fused",
                                          "seg_patch_stream")}
    assert handed <= {patch.get("fused_site_parallelism")}
    assert "fused_site_parallelism" not in caplog.text
