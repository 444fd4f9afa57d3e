from .vae import AAEModel, IWAEModel, VAEModel
from .vqvae import VQVAEz16, VQVAEz32
from .registry import build_model, get_model_cls
