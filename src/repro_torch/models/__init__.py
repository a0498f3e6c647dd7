"""Model zoo of the port (port of ``src/repro/models/__init__.py``): the
dense transformer family and the Mamba2 (ssm) family, for training and
serving."""

from repro_torch.configs.base import ArchConfig


def build_model(cfg: ArchConfig):
    """Family dispatch; the other families are not yet ported."""
    if cfg.family == "dense":
        from repro_torch.models.transformer import TransformerLM

        return TransformerLM(cfg)
    if cfg.family == "ssm":
        from repro_torch.models.ssm_lm import Mamba2LM

        return Mamba2LM(cfg)
    raise NotImplementedError(f"model family {cfg.family!r} is not yet "
                              "ported: the port builds the dense and ssm "
                              "families; the others are ROADMAP.md Queue 1 "
                              "item 6")


__all__ = ["ArchConfig", "build_model"]
