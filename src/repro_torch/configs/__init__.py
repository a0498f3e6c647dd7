"""Registry of the architectures the port runs (port of
``src/repro/configs/__init__.py``): ``fedlm-100m`` (slice 1),
``qwen3-1.7b`` (the serving slice) and ``mamba2-130m`` (the ssm family);
the other architectures of the reference come with the model families
that run them."""

from repro_torch.configs import fedlm_100m, mamba2_130m, qwen3_1p7b
from repro_torch.configs.base import ArchConfig

_REGISTRY: dict[str, ArchConfig] = {c.name: c for c in (fedlm_100m.CONFIG,
                                                        qwen3_1p7b.CONFIG,
                                                        mamba2_130m.CONFIG)}


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
