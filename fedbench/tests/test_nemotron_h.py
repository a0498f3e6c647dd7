"""The nemotron_h reference's counts against hand-worked values, and its
weights in the port's tree."""

import json
import math
from pathlib import Path

import torch

from fedbench.reference import common, nemotron_h

ROOT = Path(__file__).resolve().parents[1]


def test_model_flops_hand_worked():
    """One layer a kind (``ME*``), d 4; Mamba2 2 heads of 2 in 2 groups,
    state 2, conv 2 (conv channels 4 + 2 * 2 * 2 = 12); 4 experts routed
    over, 2 held, top 2, width 3, a shared expert of 5; attention 2 / 1
    heads of 2; V 10; S 8. Weights a token multiplies by: Mamba2 4 (8 + 8
    + 2) + 12 * 2 + 4 * 4 = 112; MoE 4 * 4 + 2 * 2 / 4 * 2 * 4 * 3 + 2 * 4
    * 5 = 80; attention 16 + 16 + 16 = 48; head 40: 6 * 280 = 1,680. Plus
    the scores 6 * 2 * 2 * 9 = 216 and the SSD 12 * 2 * 2 * 2 = 96:
    1,992."""
    conf = {"hybrid_override_pattern": "ME*", "hidden_size": 4,
            "layer_norm_epsilon": 1e-5, "mamba_num_heads": 2,
            "mamba_head_dim": 2, "n_groups": 2, "ssm_state_size": 2,
            "conv_kernel": 2, "chunk_size": 128, "router_experts": 4,
            "n_routed_experts": 2, "num_experts_per_tok": 2,
            "moe_intermediate_size": 3,
            "moe_shared_expert_intermediate_size": 5,
            "num_attention_heads": 2, "num_key_value_heads": 1,
            "head_dim": 2, "vocab_size": 10}
    assert nemotron_h.train_flops_per_token(conf, 8) == 1992.0


def test_weights_take_the_ports_tree():
    """The weights the benchmark makes have the port's leaves, shapes and
    order, and the configuration the published count: 528,093,120."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import build_model

    conf = json.loads((ROOT / "configs" / "nemotron-3-nano-30b-a3b-p7.json")
                      .read_text())
    assert sum(math.prod(s) for s, _ in nemotron_h.param_spec(conf)
               .values()) == 528_093_120
    small = nemotron_h.test_conf(conf)
    port = build_model(ArchConfig(**nemotron_h.arch_kwargs(small))).init(
        torch.Generator().manual_seed(0))
    _, mine = common.make_weights(nemotron_h.param_spec(small), 1, "cpu")
    want = common.flatten(port)
    assert list(mine) == list(want)
    for n in want:
        assert mine[n].shape == want[n].shape, n
