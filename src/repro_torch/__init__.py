"""PyTorch + CUDA port of the FedCET reproduction (reference: ``src/repro``).

The module layout mirrors ``src/repro/``: every file names the reference
file it ports in its docstring. The port imports ``torch`` and never
``jax`` or anything of the ``repro`` package; its tests hold it against
the reference on the CPU, and ``chip_smoke.py`` at the repository root
drives it on an NVIDIA H100.

Ported so far. Slice 1: FedCET federated training of ``fedlm-100m`` at
full width, the paper's quadratic problem, and hand-written CUDA kernels
for the FedCET local-step triad and the aggregation pair
(``kernels/csrc/fedcet_update.cu``). Slice 2: the compressed round the
reference is built around: ``jax.random``'s bits (``core/prng.py``), the
``shift:q8`` / ``q8`` / ``pq8`` uplink (``core/compressors.py``), client
sampling, the packed parameter arena (``core/arena.py``) and CUDA kernels
for the dithered quantizer (``kernels/csrc/quantize.cu``) and the fused
round tail (``kernels/csrc/fedcet_update.cu``). Slice 3: the aggregation
topologies (``core/topology.py``: star, hierarchical with tier
recompression, gossip mixing with dense and sparse lowerings), the NIDS
spec (``core/baselines/nids.py``), topology-aware accounting, and a CUDA
kernel for the gossip neighbor reduce (``kernels/csrc/gossip_reduce.cu``).
Slice 4: the in-round telemetry (``core/telemetry.py``: metrics, sketches,
monitors, sinks, the profiler window; ``CommMeter``) on the training path,
and a CUDA kernel for the per-client norm-histogram sketch
(``kernels/csrc/telemetry_reduce.cu``). Slice 5: the serving path
(``launch/serve.py``: KV-cached prefill and decode; ``models/attention.py``
whole; ``configs/qwen3_1p7b.py``) and a CUDA kernel for grouped-GQA flash
attention (``kernels/csrc/flash_attention.cu``). Slice 6: the Mamba2
(ssm) family (``models/mamba2.py``, ``models/ssm_lm.py``,
``configs/mamba2_130m.py``) on the serving path, and a CUDA kernel for the
SSD intra-chunk term (``kernels/csrc/ssd_intra.cu``), the last of the
reference's TPU kernels. Slice 12: the other model families — dense
variants (GeGLU, GELU, LayerNorm, biases, scaled embeddings), MoE
(``models/moe.py``), the Zamba2 hybrid (``models/hybrid.py``), the
Whisper encoder-decoder (``models/encdec.py``) and the VLM prefix — and
every config of the reference (``configs/``). Slice 13: launch and
roofline, serve side — the H100 cost model (``roofline/``), meshes and
partition rules on DTensor (``launch/{mesh,overrides,partition}.py``,
``utils/sharding_ctx.py``), the sharded prefill and decode steps
(``launch/serve.py``), the dry run on a fake process group
(``launch/dryrun.py``), the two serving kernels as custom ops and the
token-sharded MoE dispatch.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. With no card and no explicit request it raises — an entry
    point never falls back to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device
