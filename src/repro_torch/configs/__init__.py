"""Registry of the assigned architectures and the paper's own workload
(port of ``src/repro/configs/__init__.py``). Every entry cites its
source; ``get_config(name)`` is what ``--arch <id>`` resolves through."""

from repro_torch.configs import (
    fedlm_100m,
    gemma_2b,
    granite_moe_3b_a800m,
    internlm2_20b,
    llama4_scout_17b_a16e,
    llava_next_34b,
    mamba2_130m,
    minicpm_2b,
    nemotron3_nano_30b_a3b,
    qwen3_1p7b,
    whisper_small,
    zamba2_1p2b,
)
from repro_torch.configs.base import (
    INPUT_SHAPES,
    ArchConfig,
    FedScenario,
    ShapeConfig,
    supports_shape,
)

#: the 10 assigned architectures (fedlm-100m is the paper-side extra).
ASSIGNED = (
    "internlm2-20b", "zamba2-1.2b", "qwen3-1.7b", "minicpm-2b",
    "llava-next-34b", "llama4-scout-17b-a16e", "gemma-2b", "mamba2-130m",
    "granite-moe-3b-a800m", "whisper-small",
)

_REGISTRY: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in (
    internlm2_20b, zamba2_1p2b, qwen3_1p7b, minicpm_2b, llava_next_34b,
    llama4_scout_17b_a16e, gemma_2b, mamba2_130m, granite_moe_3b_a800m,
    whisper_small, fedlm_100m)}

#: configurations of the port alone, resolved by ``get_config`` but kept
#: out of ``registry()`` and ``list_archs()``, which mirror the reference's
PORT_ONLY: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in (
    nemotron3_nano_30b_a3b,)}


def registry() -> dict[str, ArchConfig]:
    return dict(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name in PORT_ONLY:
        return PORT_ONLY[name]
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(_REGISTRY) + sorted(PORT_ONLY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


__all__ = ["ASSIGNED", "ArchConfig", "FedScenario", "INPUT_SHAPES",
           "PORT_ONLY", "ShapeConfig", "get_config", "list_archs", "registry",
           "supports_shape"]
