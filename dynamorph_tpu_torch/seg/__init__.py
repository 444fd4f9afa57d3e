"""U-Net semantic segmentation, inference (``Segment``, the tiled and
direct whole-map modes)."""
from .model import Segment
from .inference import predict_whole_map
