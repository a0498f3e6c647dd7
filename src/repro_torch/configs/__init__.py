"""Registry of the architectures the port runs (port of
``src/repro/configs/__init__.py``). Slice 1 holds ``fedlm-100m``; the
other architectures of the reference come with the model families that
run them."""

from repro_torch.configs import fedlm_100m
from repro_torch.configs.base import ArchConfig

_REGISTRY: dict[str, ArchConfig] = {fedlm_100m.CONFIG.name: fedlm_100m.CONFIG}


def registry() -> dict[str, ArchConfig]:
    return dict(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


__all__ = ["ArchConfig", "get_config", "list_archs", "registry"]
