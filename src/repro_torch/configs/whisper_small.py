"""whisper-small [audio] (port of ``src/repro/configs/whisper_small.py``):
an encoder-decoder whose mel-spectrogram and conv frontend is a stub
[arXiv:2212.04356]: ``launch/input_specs.py`` supplies 1500 frame
embeddings a sample. 12 encoder and 12 decoder layers, d_model 768, 12
heads of 64 (MHA), LayerNorm, GELU d_ff 3072, biases, sinusoidal
positions, vocab 51,865, tied head."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,          # decoder layers
    encoder_layers=12,
    encoder_len=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,        # MHA
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    activation="gelu",
    norm="layernorm",
    use_rope=False,       # sinusoidal positions
    attn_bias=True,
    mlp_bias=True,
    tie_embeddings=True,
    modality="audio",
    citation="arXiv:2212.04356",
)
