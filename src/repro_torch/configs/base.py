"""Architecture and scenario configs (port of
``src/repro/configs/base.py``: ``ArchConfig`` with ``reduced()`` and
``with_dtype``, ``FedScenario`` :127-246, and the workload shapes
``ShapeConfig``, ``INPUT_SHAPES`` and ``supports_shape`` :249-275).

A copy, not an import: the port imports nothing of the ``repro`` package.
``reduced()`` gives the CPU-smoke variant of the same family (2 layers,
d_model <= 256, small vocab), exactly as the reference computes it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    citation: str = ""
    head_dim: Optional[int] = None   # default d_model // n_heads

    # attention variants
    qk_norm: bool = False
    attention: str = "full"          # full | sliding | chunked
    window: int = 4096               # sliding-window size
    chunk: int = 8192                # chunked-local (iRoPE) chunk size
    rope_theta: float = 1e4
    use_rope: bool = True
    attn_bias: bool = False

    # mlp
    activation: str = "swiglu"       # swiglu | geglu | gelu | relu2
    mlp_bias: bool = False

    # norm / embeddings
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma: multiply embeddings by sqrt(d)
    norm_eps: float = 1e-6           # RMSNorm epsilon

    # moe
    n_experts: int = 0
    experts_per_token: int = 0
    moe_shared_expert: bool = False
    capacity_factor: float = 1.25
    # nemotron_h's sigmoid router: its normalized top-k weights times
    # ``moe_routed_scale``; experts 0 .. ``experts_held`` - 1 live on this
    # card (0: all), each over every token (drop-free)
    moe_routed_scale: float = 1.0
    moe_shared_ff: int = 0           # width of a shared expert of its own
    experts_held: int = 0

    # ssm (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_heads: int = 0               # 0: ssm_expand * d_model / ssm_headdim
    ssm_groups: int = 1              # B/C groups; head j reads j // (H / G)

    # hybrid (zamba2): one SHARED attention(+MLP) block applied every k layers
    shared_attn_every: int = 0
    # single-mixer stacks (nemotron_h): one letter a layer, M Mamba2,
    # E MoE, * attention
    layer_pattern: str = ""

    # modality frontends (stubs): precomputed embeddings prepended/consumed
    modality: str = "text"           # text | vision | audio
    n_modal_tokens: int = 0          # vision: image-patch tokens per sample
    encoder_layers: int = 0          # audio: enc-dec encoder depth
    encoder_len: int = 1500          # audio: encoder frames

    # numerics / lowering
    dtype: str = "float32"           # activations
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    attn_block_size: int = 512
    #: the reference's Pallas attention / SSD switches: they send the
    #: model's forward through the flash-attention / SSD intra-chunk
    #: kernel (neither has a backward).
    use_pallas_attention: bool = False
    use_pallas_ssd: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.n_heads and self.n_kv_heads:
            assert self.n_heads % self.n_kv_heads == 0, (self.n_heads, self.n_kv_heads)

    # ------------------------------------------------------------- variants
    def reduced(self) -> "ArchConfig":
        """Smoke-test variant of the same family: 2 layers, d_model<=512,
        <=4 experts, small vocab/window — runs a train step on one CPU."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4) or 0
        kv = min(self.n_kv_heads, heads) if self.n_kv_heads else 0
        if heads and kv:
            kv = heads // max(1, heads // kv)  # keep a GQA ratio > 1 if it had one
        changes = dict(
            n_layers=2,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=(d // heads if heads else None),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            window=min(self.window, 64),
            chunk=min(self.chunk, 64),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            experts_per_token=(min(self.experts_per_token, 2)
                               if self.experts_per_token else 0),
            # drop-free capacity so prefill/decode stay bit-consistent in the
            # smoke tests (production configs keep the real 1.25 and drop).
            capacity_factor=float(max(self.n_experts, 1)),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else self.ssm_headdim,
            shared_attn_every=(1 if self.shared_attn_every else 0),
            n_modal_tokens=min(self.n_modal_tokens, 16),
            encoder_layers=min(self.encoder_layers, 2),
            encoder_len=min(self.encoder_len, 32),
            scan_layers=False,
            remat=False,
        )
        # the port-only fields, untouched at their defaults
        if self.layer_pattern:  # one layer of each kind, in pattern order
            kinds = "".join(dict.fromkeys(self.layer_pattern))
            changes.update(n_layers=len(kinds), layer_pattern=kinds)
        if self.ssm_heads:
            changes["ssm_heads"] = min(self.ssm_heads, 8)
        if self.ssm_groups > 1:
            changes["ssm_groups"] = 2
        if self.moe_shared_ff:
            changes["moe_shared_ff"] = min(self.moe_shared_ff, 512)
        if self.experts_held:
            changes["experts_held"] = max(1, changes["n_experts"] // 2)
        return dataclasses.replace(self, **changes)

    def with_dtype(self, dtype: str, param_dtype: str | None = None) -> "ArchConfig":
        return dataclasses.replace(self, dtype=dtype,
                                   param_dtype=param_dtype or dtype)


@dataclasses.dataclass(frozen=True)
class FedScenario:
    """Launch-level federated-scenario knob: which compressor rides the
    uplink (``compression``, a ``core/compressors.py:from_spec`` spec such
    as ``"shift:q8"``, ``"randk:0.25"`` or ``"ef:topk:0.3+bf16"``), or a
    per-leaf plan instead (``compression_plan``: comma-separated
    first-match-wins ``pattern:spec`` rules for ``parse_plan``,
    ``"embed*:q12,ln*:bf16,*:shift:q6"``, or a ready ``CompressionPlan``,
    e.g. from ``plan.allocate``; ``error_feedback`` applies per rule), what
    fraction of clients participates per round, the delay model and stale
    policy of asynchronous rounds (``delay``: ``"fixed:2"``, ``"rr:2"``,
    ``"geom:0.5"``; ``stale_policy``: ``"drop"``, ``"last"``,
    ``"poly:1"``; ``core/staleness.py``), the cohort of O(cohort) rounds
    (``cohort``: ``"block:256"``, ``"rr:64"``, ``"256"``, an int or a
    ``CohortSpec``), whether the client store lives in the packed arena,
    the aggregation geometry (``topology``, a
    ``core/topology.py:parse_topology`` spec: ``"star"``, ``"hier:g8"``,
    ``"ring"``, ``"ring:sparse"``, ``"er:0.4:t"``; ``tier_compression``
    re-compresses a hierarchy's interior tiers), the in-round telemetry
    spec (``telemetry``: ``True``, a ``core/telemetry.py:Telemetry`` or a
    sink spec string such as ``"jsonl:run.jsonl,hist:48"``), and the seed
    of their random schedules.

    ``apply`` composes the scenario onto any engine algorithm in the
    reference's order: arena, topology, participation, compression,
    delay, cohort (last: it wraps the composed spec), then telemetry (an
    observer of the composed round)."""

    compression: str = "none"
    compression_plan: Any = "none"
    participation: float = 1.0
    delay: str = "none"
    stale_policy: str = "last"
    topology: str = "star"
    tier_compression: str = "none"
    error_feedback: bool | None = None
    cohort: Any = "none"
    arena: bool = False
    telemetry: Any = False
    seed: int = 0

    def apply(self, algo):
        from repro_torch.core.compressors import from_spec, parse_plan
        from repro_torch.core.engine import (with_arena, with_cohort,
                                             with_compression, with_delay,
                                             with_participation,
                                             with_telemetry, with_topology)

        algo = with_arena(algo, self.arena)
        algo = with_topology(algo, self.topology, seed=self.seed,
                             tier_compression=self.tier_compression)
        algo = with_participation(algo, self.participation, seed=self.seed)
        comp = from_spec(self.compression)
        plan = parse_plan(self.compression_plan,
                          error_feedback=self.error_feedback)
        if comp is not None and plan is not None:
            raise ValueError(
                "pass EITHER compression= or compression_plan=, not both: "
                "a plan IS the uplink compressor (put a '*:<spec>' "
                "catch-all rule in the plan for the uniform part): "
                f"compression={self.compression!r}, "
                f"compression_plan={self.compression_plan!r}")
        if plan is not None:
            algo = with_compression(algo, compressor=plan, seed=self.seed)
        if comp is not None:
            algo = with_compression(algo, compressor=comp,
                                    error_feedback=self.error_feedback,
                                    seed=self.seed)
        algo = with_delay(algo, self.delay, policy=self.stale_policy,
                          seed=self.seed)
        # cohort last: every transform above runs inside the gathered round.
        algo = with_cohort(algo, self.cohort, seed=self.seed)
        return with_telemetry(algo, self.telemetry)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned workload shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def supports_shape(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """The shape-coverage policy: a 500k-token decode needs a
    sub-quadratic family or attention variant."""
    if shape.name == "long_500k":
        sub_quadratic = (
            cfg.family in ("ssm", "hybrid")
            or cfg.attention in ("sliding", "chunked")
        )
        if not sub_quadratic:
            return False, ("pure full-attention arch: 500k decode requires a "
                           "sub-quadratic attention variant (DESIGN.md §5)")
    return True, ""
