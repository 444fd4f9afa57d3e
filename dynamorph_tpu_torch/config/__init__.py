from .schema import (
    PreprocessConfig,
    SegmentationInferenceConfig,
    PatchConfig,
    LatentEncodingConfig,
    DimReductionConfig,
    TrainingConfig,
    PipelineConfig,
)
from .loader import load_config
