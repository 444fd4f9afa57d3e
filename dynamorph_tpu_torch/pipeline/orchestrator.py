"""One-command pipeline orchestration — the port of
``dynamorph_tpu/pipeline/orchestrator.py``.

Runs any span of the stage graph over one experiment directory with
per-stage timing (``stage_timer``) and skip-if-output-exists resume.

Stage order: segmentation -> instance_segmentation -> extract_patches ->
build_trajectories -> assemble -> process -> trajectory_matching -> pca.
(Preprocessing runs separately via run_preproc: it maps over different
directories.) With ``patch.fused`` the three front-end stages run as one,
``seg_patch_fused`` (pipeline/fused.py); with
``latent_encoding.streaming`` too, the front end, assemble's resize and
process run as ``seg_patch_stream`` (pipeline/stream.py), and assemble
keeps only its relation half.

One process drives one card. In a process group (``run_pipeline
--multihost``) each rank owns a contiguous slice of the wells
(``core.mesh.process_slice``) and runs every stage of its wells on its
card; the pooled PCA fit waits for every rank at a barrier and runs once,
on rank 0 (dynamorph_tpu/pipeline/orchestrator.py:58-107, :258-292). There
a stage that fails is recorded, the rank's remaining stages are skipped,
the barriers are still walked (a raise would leave the other ranks waiting
in them until the timeout), the fit is skipped when any rank failed, and
then every rank raises: the failed rank its error, the others an error
naming the failed ranks. In one process a stage that fails raises at once.
"""
from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence, Union

import torch

from ..core import mesh
from ..core.device import resolve_device
from ..core.profiling import stage_timer
from ..io.compact import resolve_any
from ..io.prefetch import AsyncWriter, Prefetcher
from ..io.sites import group_sites_by_well, site_supp_folder
from ..models.registry import is_vae_family
from .dim_reduction import dim_reduction
from .fused import seg_patch_fused
from .patch import build_trajectories, extract_patches, instance_segmentation
from .patch_vae import (assemble_vae, load_well_inputs, process_vae,
                        resolve_latent_weights, trajectory_matching)
from .segmentation import segmentation
from .stream import assemble_relations, seg_patch_stream

log = logging.getLogger(__name__)

STAGES = ["segmentation", "instance_segmentation", "extract_patches",
          "build_trajectories", "assemble", "process",
          "trajectory_matching", "pca"]


def _well_outputs_exist(raw_dir: str, well: str, names: Sequence[str]) -> bool:
    # artifacts may exist in either storage format (.pkl / .npz)
    return all(os.path.exists(resolve_any(os.path.join(raw_dir, f"{well}{n}")))
               for n in names)


def _sites_have(supp_dir: str, sites: Sequence[str], name: str) -> bool:
    return all(os.path.exists(os.path.join(site_supp_folder(supp_dir, s),
                                           name)) for s in sites)


def run_pipeline(raw_dir: str, supp_dir: str, sites: Sequence[str], config,
                 stages: Optional[Sequence[str]] = None,
                 resume: bool = True,
                 device: Union[str, torch.device] = "cuda") -> List[str]:
    """Run the stage graph over one experiment directory.

    Args:
        stages: subset of STAGES to run (default: all).
        resume: skip stages whose outputs already exist (extract_patches,
            process and pca have no such check and always run).
        device: where segmentation, extract_patches, process, the fused
            and streaming stages and the PCA fit run; the other stages run
            on the host.

    Returns the list of stages actually executed.
    """
    stages = list(stages) if stages else list(STAGES)
    unknown = set(stages) - set(STAGES)
    if unknown:
        raise ValueError(f"unknown stages {sorted(unknown)}; "
                         f"available: {STAGES}")
    dev = resolve_device(device)
    executed = []
    multiproc = mesh.is_multiprocess()
    if multiproc:
        all_wells = group_sites_by_well(sites)
        my_wells = mesh.process_slice(sorted(all_wells))
        sites = [s for w in my_wells for s in all_wells[w]]
        log.info("[pipeline] process %d/%d owns wells %s (%d sites)",
                 mesh.process_index(), mesh.process_count(), my_wells,
                 len(sites))
    stage_error: Optional[BaseException] = None

    def run(stage: str, fn, skip_if=None):
        nonlocal stage_error
        if stage not in stages or stage_error is not None:
            return
        if resume and skip_if is not None and skip_if():
            log.info("[pipeline] %s: outputs exist, skipping", stage)
            return
        log.info("[pipeline] running %s", stage)
        try:
            with stage_timer(stage):
                fn()
        except Exception as e:
            if not multiproc:
                raise
            stage_error = e
            log.error("[pipeline] %s failed on process %d: %s; raising "
                      "after the cross-process barriers", stage,
                      mesh.process_index(), e)
            return
        executed.append(stage)

    wells = group_sites_by_well(sites)
    front_end = {"segmentation", "instance_segmentation", "extract_patches"}
    fused = config.patch.fused and front_end <= set(stages)
    if config.patch.fused and not fused and front_end & set(stages):
        log.warning(
            "patch.fused requested but stages %s are missing %s — running "
            "the STAGED front-end instead (the fused stage replaces all "
            "three)", sorted(front_end & set(stages)),
            sorted(front_end - set(stages)))
    streaming = fused and config.latent_encoding.streaming and \
        {"assemble", "process"} <= set(stages)
    if fused and not streaming and config.latent_encoding.streaming:
        log.warning(
            "latent_encoding.streaming requested but stages are missing "
            "%s — running the fused front-end + staged assemble/process "
            "instead", sorted({"assemble", "process"} - set(stages)))
    if streaming and not is_vae_family(config.latent_encoding.network):
        # the streaming encoder is VAE-family only (pipeline/stream.py)
        log.warning(
            "latent_encoding.streaming requested but network '%s' has no "
            "streaming encode — running the fused front-end + staged "
            "assemble/process instead", config.latent_encoding.network)
        streaming = False
    if streaming:
        stages = ["seg_patch_stream"] + [s for s in stages
                                         if s not in front_end and
                                         s != "process"]

        def _latents_exist(well: str) -> bool:
            _, _, model_name = resolve_latent_weights(config.latent_encoding)
            return all(os.path.exists(resolve_any(
                os.path.join(raw_dir, model_name, f"{well}{n}")))
                for n in ("_latent_space.pkl", "_latent_space_after.pkl"))

        # rerun=True: the encoder takes the patches from the live frame
        # hook; the whole stage's resume is the skip rule
        run("seg_patch_stream",
            lambda: seg_patch_stream(
                raw_dir, supp_dir, sites, config, rerun=True,
                patch_type="mat", device=dev,
                site_parallelism=config.patch.fused_site_parallelism),
            skip_if=lambda: all(
                _well_outputs_exist(raw_dir, w, ["_static_patches.pkl",
                                                 "_file_paths.pkl"]) and
                _latents_exist(w) for w in wells))
    elif fused:
        stages = ["seg_patch_fused"] + [s for s in stages
                                        if s not in front_end]
        run("seg_patch_fused",
            lambda: seg_patch_fused(
                raw_dir, supp_dir, sites, config, rerun=not resume,
                device=dev,
                site_parallelism=config.patch.fused_site_parallelism),
            skip_if=lambda: _sites_have(supp_dir, sites,
                                        "cell_positions.pkl"))
    else:
        run("segmentation",
            lambda: segmentation(raw_dir, supp_dir, None, sites, config,
                                 device=dev),
            skip_if=lambda: all(
                os.path.exists(os.path.join(raw_dir,
                                            f"{s}_NNProbabilities.npy"))
                for s in sites))
        run("instance_segmentation",
            lambda: instance_segmentation(raw_dir, supp_dir, sites, config,
                                          rerun=not resume),
            skip_if=lambda: _sites_have(supp_dir, sites,
                                        "cell_positions.pkl"))
        run("extract_patches",
            lambda: extract_patches(raw_dir, supp_dir, sites, config,
                                    device=dev))
    run("build_trajectories",
        lambda: build_trajectories(raw_dir, supp_dir, sites, config),
        skip_if=lambda: _sites_have(supp_dir, sites, "cell_traj.pkl"))
    if streaming:
        # file_paths, static_patches and the latents are streamed already
        run("assemble",
            lambda: [assemble_relations(raw_dir, supp_dir, ws, config)
                     for ws in wells.values()],
            skip_if=lambda: all(_well_outputs_exist(
                raw_dir, w, ["_static_patches_relations.pkl",
                             "_static_patches_labels.pkl"])
                for w in wells))
    else:
        run("assemble",
            lambda: [assemble_vae(raw_dir, supp_dir, ws, config,
                                  patch_type="mat")
                     for ws in wells.values()],
            skip_if=lambda: all(_well_outputs_exist(
                raw_dir, w, ["_static_patches.pkl", "_file_paths.pkl"])
                for w in wells))

    def _process_all():
        # prefetch the next well's pickles while this one encodes; drain
        # latent pickle saves on a writer thread (same overlap as the
        # run_vae CLI)
        prefetched = Prefetcher(
            list(wells.items()),
            lambda kv: load_well_inputs(raw_dir, kv[0]))
        with AsyncWriter(depth=2) as writer:
            for (_, ws), preloaded in prefetched:
                process_vae(raw_dir, supp_dir, ws, config,
                            preloaded=preloaded, writer=writer, device=dev)

    run("process", _process_all)
    run("trajectory_matching",
        lambda: [trajectory_matching(raw_dir, supp_dir, ws)
                 for ws in wells.values()],
        skip_if=lambda: all(_well_outputs_exist(
            raw_dir, w, ["_trajectories.pkl"]) for w in wells))
    dr = config.dim_reduction
    failed = [stage_error is not None]
    if multiproc:
        # every rank's wells are written (a shared filesystem) and every
        # rank knows whether a peer failed: a fit on an incomplete latent
        # pool would be worse than none
        mesh.barrier("pre-pca")
        failed = mesh.allgather_flags(stage_error is not None)
    try:
        if "pca" in stages and dr.input_dirs and not any(failed) and \
                mesh.is_main_process():
            # the fit pools the latents of every input directory (reference
            # run_dim_reduction.py:276-287)
            with stage_timer("pca"):
                dim_reduction("pca", dr.input_dirs,
                              dr.output_dirs or dr.input_dirs,
                              dr.weights_dir, config, device=dev)
            executed.append("pca")
    finally:
        if multiproc:
            # every rank leaves together, also when the fit raised on rank 0
            mesh.barrier("post-pca")
    if stage_error is not None:
        raise stage_error
    if any(failed):
        raise RuntimeError(
            f"a pipeline stage failed on rank(s) "
            f"{[r for r, f in enumerate(failed) if f]}; the pooled PCA fit "
            f"was skipped")
    return executed
