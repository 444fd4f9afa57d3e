"""Model dispatch by config string (the reference's network names, so
reference configs work unchanged)."""
from __future__ import annotations

from .vqvae import VQVAEz16, VQVAEz32

_REGISTRY = {
    "VQ_VAE_z16": VQVAEz16,
    "VQ_VAE_z32": VQVAEz32,
}

# Networks of the JAX package that the port has not reached yet.
_LATER = {
    "VAE": "ROADMAP slice E (other model families)",
    "IWAE": "ROADMAP slice E (other model families)",
    "AAE": "ROADMAP slice E (other model families)",
}


def get_model_cls(name: str):
    if name in _LATER:
        raise NotImplementedError(
            f"network {name!r} is not ported yet; it comes with {_LATER[name]}")
    if name not in _REGISTRY:
        raise ValueError(
            f"Unknown network {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_models():
    return sorted(_REGISTRY)
