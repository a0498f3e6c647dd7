"""llava-next-34b [vlm] (port of ``src/repro/configs/llava_next_34b.py``):
anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf]. The vision tower
(ViT/SigLIP, projector, anyres tile split) is a stub:
``launch/input_specs.py`` supplies the patch embeddings ``[B, 2880,
d_model]`` (~5 anyres tiles x 576 patches); this config is the language
backbone that attends over them and the text — 60 layers, d_model 7168,
56 query / 8 KV heads of 128, SwiGLU d_ff 20,480, vocab 64,000,
rope_theta 1e6."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,       # GQA kv=8
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    modality="vision",
    n_modal_tokens=2880,
    activation="swiglu",
    rope_theta=1e6,
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
