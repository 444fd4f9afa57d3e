"""YAML -> typed PipelineConfig loader.

Behavior parity with the reference YamlReader (configs/config_reader.py:
140-206): per-section field whitelists with warn-on-unknown. Improvements:
missing sections fall back to defaults instead of raising, values are type-
checked against the dataclass fields, and ``yaml.safe_load`` replaces the
reference's unsafe ``yaml.load`` (config_reader.py:157).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict

import yaml

from .schema import SECTION_TYPES, PipelineConfig

log = logging.getLogger(__name__)

# Field aliases seen in reference configs that differ from the whitelist
# (e.g. config_example.yml uses `weights_dirs` in dim_reduction while the
# whitelist says `weights_dir`, config_reader.py:98).
_ALIASES = {
    "dim_reduction": {"weights_dirs": "weights_dir"},
}


_SIMPLE_TYPES = (int, float, bool, str)


def _parse_section(name: str, raw: Dict[str, Any]):
    import typing

    cls = SECTION_TYPES[name]
    fields = {f.name for f in dataclasses.fields(cls)}
    hints = typing.get_type_hints(cls)
    aliases = _ALIASES.get(name, {})
    kwargs = {}
    for key, value in raw.items():
        key = aliases.get(key, key)
        if key in fields:
            # light scalar type check (warn, don't raise — same permissive
            # philosophy as the unknown-key warnings): catches e.g. a
            # quoted "256" where an int is declared at load time instead
            # of deep inside a jitted shape assert
            t = hints.get(key)
            if t in _SIMPLE_TYPES and value is not None \
                    and not isinstance(value, t) \
                    and not (t is float and isinstance(value, int)):
                log.warning(
                    "yaml %s config field %s: expected %s, got %s (%r)",
                    name.upper(), key, t.__name__,
                    type(value).__name__, value)
            kwargs[key] = value
        else:
            log.warning("yaml %s config field %s is not recognized",
                        name.upper(), key)
    return cls(**kwargs)


def load_config(path: str) -> PipelineConfig:
    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}
    sections = {}
    for name in SECTION_TYPES:
        if name in raw and raw[name] is not None:
            sections[name] = _parse_section(name, raw[name])
    for key in raw:
        if key not in SECTION_TYPES:
            log.warning("yaml config section %s is not recognized", key)
    return PipelineConfig(**sections)
