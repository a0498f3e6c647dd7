"""The benchmark's frozen copies equal the port's originals at small
sizes, and its counts equal hand-worked values."""

import math

import pytest
import torch

from fedbench import counts, prng, traffic_gen
from fedbench.reference import common, moe, ssm


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11])
def test_traffic_equals_the_ports_dataset(seed):
    from repro_torch.data.synthetic import make_hetero_lm_dataset

    kw = dict(vocab_size=97, n_clients=3, seq_len=12, batch_size=2,
              heterogeneity=0.8, seed=seed)
    port = make_hetero_lm_dataset(kw.pop("vocab_size"), kw.pop("n_clients"),
                                  kw.pop("seq_len"), kw.pop("batch_size"),
                                  **kw)
    mine = traffic_gen.HeteroLMDataset(97, 3, 12, 2, 0.8, seed)
    for r in (0, 1, 5):
        assert torch.equal(mine.sample_round(r, 2), port.sample_round(r, 2))


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 + 11, 2 ** 40 + 3])
def test_dither_equals_the_ports_threefry(seed):
    from repro_torch.core import prng as port
    from repro_torch.core.engine import compression_key

    for step in (-1, 0, 2, 40):
        k = compression_key(seed, 0, step, x64=False)
        assert tuple(k) == prng.compression_key(seed, 0, step)
        for i, shape in ((0, (5,)), (3, (7, 33)), (11, (2, 3, 1030))):
            want = port.uniform(port.fold_in(k, i), shape,
                                dtype=torch.float32)
            got = prng.uniform(prng.fold_in(tuple(k), i), shape)
            assert torch.equal(got, want)


def test_model_flops_hand_worked():
    """moe: L 1, d 8, 2 heads of 4 (1 KV head), 4 experts of 4 (top 2), V
    16, S 8: 6 (64 + 64 + 64 + 32 + 192 + 128) + 6 * 2 * 4 * 9 = 3,696.
    ssm: L 1, d 4, expand 2, heads of 4, state 2, conv 2, V 10: 6 (4 (16
    + 4 + 2) + 12 * 2 + 8 * 4 + 40) + 12 * 2 * 4 * 2 = 1,296."""
    m = {"num_hidden_layers": 1, "hidden_size": 8, "num_attention_heads": 2,
         "num_key_value_heads": 1, "intermediate_size": 4,
         "num_local_experts": 4, "num_experts_per_tok": 2, "vocab_size": 16}
    assert moe.train_flops_per_token(m, 8) == 3696.0
    s = {"n_layer": 1, "d_model": 4, "vocab_size": 10,
         "ssm_cfg": {"expand": 2, "headdim": 4, "d_state": 2, "d_conv": 2,
                     "ngroups": 1, "chunk_size": 128}}
    assert ssm.train_flops_per_token(s, 8) == 1296.0
    mix = {"n_clients": 4, "tau": 2, "batch": 2, "seq_len": 8,
           "compression": "shift:q8"}
    assert counts.tokens_per_round(mix) == 128
    assert counts.train_flops_per_round(ssm, s, mix) == 1296.0 * 128


def test_update_bytes_hand_worked():
    """1,000 coordinates, 4 clients, tau 2, 4 bytes: shift:q8 moves 4 + 7
    words a client and coordinate (176,000 B), none 4 + 5 (144,000 B)."""
    mix = {"n_clients": 4, "tau": 2, "compression": "shift:q8"}
    assert counts.fedcet_update_bytes(1000, mix) == 176_000
    assert counts.fedcet_update_bytes(1000, {**mix, "compression": "none"}) \
        == 144_000


@pytest.mark.parametrize("family", [moe, ssm])
def test_weights_take_the_ports_tree(family):
    """The weights the benchmark makes have the port's leaves, shapes and
    order (the arena packs them in that order)."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import build_model

    import json
    from pathlib import Path

    name = {"moe": "granite-moe-3b-a800m-l2", "ssm": "mamba2-130m"}[
        family.__name__.rsplit(".", 1)[1]]
    root = Path(__file__).resolve().parents[1]
    conf = family.test_conf(json.loads(
        (root / "configs" / f"{name}.json").read_text()))
    port = build_model(ArchConfig(**family.arch_kwargs(conf))).init(
        torch.Generator().manual_seed(0))
    _, mine = common.make_weights(family.param_spec(conf), 1, "cpu")
    want = common.flatten(port)
    assert list(mine) == list(want)
    for n in want:
        assert mine[n].shape == want[n].shape, n
        assert torch.isfinite(mine[n]).all(), n
    assert sum(math.prod(s) for s, _ in family.param_spec(conf).values()) \
        == sum(t.numel() for t in want.values())
