"""gemma-2b [dense] (port of ``src/repro/configs/gemma_2b.py``): GeGLU,
head_dim 256, multi-query attention [arXiv:2403.08295] — 18 layers,
d_model 2048, 8 query heads and one KV head of 256, GeGLU d_ff 16,384,
vocab 256,000, embeddings scaled by sqrt(d_model) and tied to the head.

Sliding-window attention (4096, Gemma-2's window) is the reference's
sub-quadratic variant for long-context decode; Gemma-1 itself attends to
the whole sequence."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,       # MQA
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="geglu",
    embed_scale=True,   # gemma multiplies embeddings by sqrt(d_model)
    tie_embeddings=True,
    attention="sliding",
    window=4096,
    citation="arXiv:2403.08295",
)
