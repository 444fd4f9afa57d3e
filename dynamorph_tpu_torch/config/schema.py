"""Typed configuration schema.

Sections and field names mirror the reference YAML layout exactly
(reference configs/config_reader.py:26-133, example schema
configs/config_example.yml) so reference configs load unchanged — but as
typed dataclasses with defaults instead of bare attribute objects. The
fields are those of the JAX package's schema, so one YAML file drives both
packages; the comments marked "extension" describe options of the JAX
package's pipeline that this port accepts and, where it has not ported
them yet, ignores.

Device fields (gpu_ids, gpu_id) are accepted for config compatibility; the
port runs on the device its entry points are given.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Union


@dataclasses.dataclass
class PreprocessConfig:
    image_dirs: List[str] = dataclasses.field(default_factory=list)
    target_dirs: List[str] = dataclasses.field(default_factory=list)
    channels: List[str] = dataclasses.field(
        default_factory=lambda: ["Retardance", "Phase2D", "Brightfield"])
    fov: Union[str, List[Any]] = "all"
    pos_dir: bool = True
    multipage: bool = False
    z_slice: Optional[int] = None


@dataclasses.dataclass
class SegmentationInferenceConfig:
    raw_dirs: List[str] = dataclasses.field(default_factory=list)
    supp_dirs: List[str] = dataclasses.field(default_factory=list)
    validation_dirs: List[str] = dataclasses.field(default_factory=list)
    network: str = "UNet"
    weights: Optional[str] = None
    gpu_ids: List[int] = dataclasses.field(default_factory=lambda: [0])
    fov: Union[str, List[Any]] = "all"
    channels: List[int] = dataclasses.field(default_factory=lambda: [0, 1])
    num_classes: int = 3
    window_size: int = 256
    batch_size: int = 8
    num_pred_rnd: int = 5
    seg_val_cat: str = "mg"
    # dynamorph_tpu extension: "tiled" = reference-parity offset ensemble,
    # "direct" = single whole-frame pass (faster, no tile-edge artifacts)
    inference_mode: str = "tiled"
    # port extension: frames a prediction sees (> 1 builds a
    # SegmentWithMultipleSlice of that many slices and unet_feat features)
    time_slices: int = 1
    unet_feat: int = 32


@dataclasses.dataclass
class PatchConfig:
    raw_dirs: List[str] = dataclasses.field(default_factory=list)
    supp_dirs: List[str] = dataclasses.field(default_factory=list)
    channels: List[int] = dataclasses.field(default_factory=lambda: [0, 1])
    fov: Union[str, List[Any]] = "all"
    num_cpus: int = 4
    window_size: int = 256
    save_fig: bool = False
    reload: bool = False
    skip_boundary: bool = False
    # dynamorph_tpu extension: run segmentation + instance clustering +
    # patch extraction as ONE device-resident stage (pipeline/fused.py) —
    # the frame and probability map stay in HBM; only DBSCAN coordinates
    # round-trip the host. Requires those three stages to be selected.
    fused: bool = False
    # sites processed concurrently by the fused stage, one per local
    # device (None = min(local devices, sites))
    fused_site_parallelism: Optional[int] = None
    # host threads clustering frames ahead of the consume point in the
    # fused stage (None = min(3, cpu_count)); HBM holds cluster_workers+1
    # frames' residents. Labels are identical for any value.
    cluster_workers: Optional[int] = None
    # dynamorph_tpu extension: "pickle" = reference byte-compatible float64
    # pickles (default); "compact" = float32 .npz stacks (io/compact.py) —
    # ~4x smaller + faster to deserialize, exact for patch values. Readers
    # accept both, and cli/convert_storage.py converts either way.
    storage: str = "pickle"


@dataclasses.dataclass
class LatentEncodingConfig:
    raw_dirs: List[str] = dataclasses.field(default_factory=list)
    supp_dirs: List[str] = dataclasses.field(default_factory=list)
    weights: Union[str, List[str], None] = None
    save_output: bool = True
    gpu_ids: List[int] = dataclasses.field(default_factory=lambda: [0])
    fov: Union[str, List[Any]] = "all"
    patch_type: str = "masked_mat"
    channels: List[int] = dataclasses.field(default_factory=lambda: [0, 1])
    channel_mean: Optional[List[float]] = None
    channel_std: Optional[List[float]] = None
    network: str = "VQ_VAE_z16"
    # model input H=W; the reference hardcodes the assemble-stage resize to
    # 128 (vq_vae_supp.py:114-146) — kept as the default here
    input_size: int = 128
    num_classes: int = 3
    num_hiddens: int = 16
    num_residual_hiddens: int = 32
    num_embeddings: int = 64
    commitment_cost: float = 0.25
    # dynamorph_tpu extension: "compact" writes <well>_static_patches.npz and
    # *_latent_space*.npz (float32) instead of the reference float64 pickles;
    # all readers (process/dim_reduction/training) accept both formats.
    storage: str = "pickle"
    # dynamorph_tpu extension: with patch.fused, stream extracted patches
    # straight from HBM into the encoder (pipeline/stream.py) — assemble's
    # 256->128 resize runs on device and process_VAE's encode happens in
    # the same pass over the raw stacks; static_patches / latent pickles
    # become async side-effects off the compute path. Latents are
    # bit-identical to the staged path's.
    streaming: bool = False


@dataclasses.dataclass
class DimReductionConfig:
    input_dirs: List[str] = dataclasses.field(default_factory=list)
    output_dirs: List[str] = dataclasses.field(default_factory=list)
    weights_dir: Optional[str] = None
    file_name_prefixes: List[str] = dataclasses.field(default_factory=list)
    fit_model: bool = False
    conditions: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TrainingConfig:
    raw_dirs: List[str] = dataclasses.field(default_factory=list)
    supp_dirs: List[str] = dataclasses.field(default_factory=list)
    weights_dirs: List[str] = dataclasses.field(default_factory=list)
    network: str = "VQ_VAE_z32"
    num_inputs: int = 2
    num_hiddens: int = 16
    num_residual_hiddens: int = 32
    num_residual_layers: int = 2
    num_embeddings: int = 512
    commitment_cost: float = 0.25
    weight_matching: float = 0.005
    margin: float = 0.5
    w_a: float = 1.1
    w_t: float = 0.1
    w_n: float = -0.5
    channel_mean: Optional[List[float]] = None
    channel_std: Optional[List[float]] = None
    n_epochs: int = 10
    learn_rate: float = 1e-4
    batch_size: int = 768
    val_split_ratio: float = 0.15
    shuffle_data: bool = False
    transform: bool = True
    patience: Optional[int] = 100
    n_pos_samples: int = 4
    num_workers: int = 0
    gpu_id: int = 0
    start_model_path: Optional[str] = None
    retrain: bool = False
    start_epoch: int = 0
    earlystop_metric: str = "total_loss"
    model_name: str = "model"
    use_mask: bool = False
    # Codebook-argmin matmul precision for the TRAINING path of VQ models:
    # "high" (default, ~1.5x faster) flips ~0.006% of assignments vs exact;
    # "highest" restores bit-exact torch-reference assignments. Inference
    # always uses "highest". See BASELINE.md "Training argmin at
    # Precision.HIGH" for the measurement.
    vq_train_precision: str = "high"


@dataclasses.dataclass
class PipelineConfig:
    preprocess: PreprocessConfig = dataclasses.field(
        default_factory=PreprocessConfig)
    segmentation_inference: SegmentationInferenceConfig = dataclasses.field(
        default_factory=SegmentationInferenceConfig)
    patch: PatchConfig = dataclasses.field(default_factory=PatchConfig)
    latent_encoding: LatentEncodingConfig = dataclasses.field(
        default_factory=LatentEncodingConfig)
    dim_reduction: DimReductionConfig = dataclasses.field(
        default_factory=DimReductionConfig)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)


SECTION_TYPES = {
    "preprocess": PreprocessConfig,
    "segmentation_inference": SegmentationInferenceConfig,
    "patch": PatchConfig,
    "latent_encoding": LatentEncodingConfig,
    "dim_reduction": DimReductionConfig,
    "training": TrainingConfig,
}
