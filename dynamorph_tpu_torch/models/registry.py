"""Model dispatch by config string (the reference's network names, so
reference configs work unchanged). The ResNet/SimCLR encoders are not in
the registry: the entry points take them by name
(``models/resnet_simclr.py``), as the JAX package does."""
from __future__ import annotations

import inspect

from .vae import AAEModel, IWAEModel, VAEModel
from .vqvae import VQVAEz16, VQVAEz32

_REGISTRY = {
    "VQ_VAE_z16": VQVAEz16,
    "VQ_VAE_z32": VQVAEz32,
    "VAE": VAEModel,
    "IWAE": IWAEModel,
    "AAE": AAEModel,
}


def get_model_cls(name: str):
    if name not in _REGISTRY:
        raise ValueError(
            f"Unknown network {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_models():
    return sorted(_REGISTRY)


def is_vae_family(name: str) -> bool:
    """Whether ``name`` takes the VQ-VAE family's encode path (on-device
    z-score, ``encode`` -> both latent pickles). The JAX package tests
    ``"VAE" in name``, which sends IWAE and AAE to "not available"
    (dynamorph_tpu/pipeline/patch_vae.py:303)."""
    return name in _REGISTRY


def _init_kwargs(cls) -> set:
    """The keyword arguments that ``cls(...)`` names in its ``__init__``
    chain (the JAX package filters by the dataclass's fields)."""
    names = set()
    for klass in cls.__mro__:
        init = klass.__dict__.get("__init__")
        if init is None:
            continue
        names |= {p.name for p in inspect.signature(init).parameters.values()
                  if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}
    names.discard("self")
    return names


def build_model(name: str, **kwargs):
    """``get_model_cls(name)`` built from the keywords it takes; the rest
    are dropped, so one config section serves every network (the VQ-only
    ``num_embeddings``, ``commitment_cost`` and ``vq_train_precision`` do
    not reach the VAE family)."""
    cls = get_model_cls(name)
    accepted = _init_kwargs(cls)
    return cls(**{k: v for k, v in kwargs.items() if k in accepted})
