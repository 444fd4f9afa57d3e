from .vqvae import VQVAEz16, VQVAEz32
from .registry import get_model_cls
