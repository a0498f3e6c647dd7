"""Model zoo of the port (port of ``src/repro/models/__init__.py``): every
assigned family, for training and serving. All models expose the same
surface: ``init`` / ``forward`` / ``loss`` / ``init_caches`` / ``prefill``
/ ``decode_step``."""

from repro_torch.configs.base import ArchConfig


def build_model(cfg: ArchConfig):
    """Family dispatch."""
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.transformer import TransformerLM

        return TransformerLM(cfg)
    if cfg.family == "ssm":
        from repro_torch.models.ssm_lm import Mamba2LM

        return Mamba2LM(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import HybridLM

        return HybridLM(cfg)
    if cfg.family == "audio":
        from repro_torch.models.encdec import EncDecLM

        return EncDecLM(cfg)
    if cfg.family == "nemotron_h":
        from repro_torch.models.nemotron_h import NemotronHLM

        return NemotronHLM(cfg)
    raise ValueError(f"unknown family: {cfg.family}")


__all__ = ["ArchConfig", "build_model"]
