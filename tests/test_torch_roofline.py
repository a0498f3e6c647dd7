"""The port's roofline (``src/repro_torch/roofline/``) against the JAX
package's, on the CPU.

* ``param_counts`` equals the reference's as integers for all 11 configs
  at full width: the port builds its tree on the ``meta`` device, the
  reference through ``jax.eval_shape``.
* ``cost_for`` equals the reference's for every config x every shape
  ``supports_shape`` admits, at bfloat16 (the dry run's dtype), in every
  ``StepCost`` field and ``detail`` entry: the same formulas in the same
  order, so equality is expected; the tolerance is 1e-12 relative.
* At float32 the FLOPs do not move and the byte terms double, save the
  SSM state (float32 in both).
* Mirrors of ``tests/test_roofline.py``'s cost-model tests, and
  ``analyze_lowered`` on a hand-made cost and collective summary: the
  ring factors, the bottleneck choice, and the H100 data-sheet constants.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs, \
    supports_shape
from repro_torch.roofline import constants as C
from repro_torch.roofline.analysis import analyze_lowered
from repro_torch.roofline.flops import StepCost, cost_for, param_counts

ARCHS = list_archs()
CELLS = [(a, s) for a in ARCHS for s in INPUT_SHAPES
         if supports_shape(get_config(a), INPUT_SHAPES[s])[0]]


def _ref():
    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.configs import INPUT_SHAPES as J_SHAPES
    from repro.configs import get_config as j_get
    from repro.roofline import flops as jflops

    return j_get, J_SHAPES, jflops


def test_all_configs_and_cells_are_covered():
    assert len(ARCHS) == 11
    # the 500k decode is admitted for the ssm/hybrid families and the
    # sliding / chunked attention variants only
    assert len(CELLS) == 11 * 3 + 5


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch):
    j_get, _, jflops = _ref()
    assert param_counts(get_config(arch)) == jflops.param_counts(j_get(arch))


def _close(a, b):
    if isinstance(b, float) or isinstance(a, float):
        assert abs(a - b) <= 1e-12 * max(abs(a), abs(b)), (a, b)
    else:
        assert a == b


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cost_for_equals_reference_at_bfloat16(arch, shape):
    j_get, j_shapes, jflops = _ref()
    want = jflops.cost_for(j_get(arch).with_dtype("bfloat16"),
                           j_shapes[shape], n_devices=256)
    got = cost_for(get_config(arch).with_dtype("bfloat16"),
                   INPUT_SHAPES[shape], n_devices=256)
    for f in dataclasses.fields(StepCost):
        if f.name == "detail":
            continue
        _close(getattr(got, f.name), getattr(want, f.name))
    assert sorted(got.detail) == sorted(want.detail)
    for k in want.detail:
        _close(got.detail[k], want.detail[k])


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "prefill_32k"),
    ("granite-moe-3b-a800m", "decode_32k"), ("whisper-small", "prefill_32k"),
    ("mamba2-130m", "long_500k"), ("zamba2-1.2b", "long_500k")])
def test_float32_bills_its_bytes(arch, shape):
    cfg = get_config(arch)
    shp = INPUT_SHAPES[shape]
    bf = cost_for(cfg.with_dtype("bfloat16"), shp, n_devices=1)
    f32 = cost_for(cfg.with_dtype("float32"), shp, n_devices=1)
    assert f32.flops_per_device == bf.flops_per_device
    assert f32.model_flops_total == bf.model_flops_total
    # every width-2 term doubles; the SSM state (``* 4``) does not move
    state = 0.0
    if shp.kind == "decode" and cfg.family in ("ssm", "hybrid"):
        d_in = cfg.ssm_expand * cfg.d_model
        h = d_in // cfg.ssm_headdim
        state = (cfg.n_layers * shp.global_batch * h * cfg.ssm_headdim
                 * cfg.ssm_state * 4 * 2)
    assert f32.hbm_bytes_per_device - state == \
        pytest.approx(2 * (bf.hbm_bytes_per_device - state), rel=1e-15)


# -------------------------------------- mirrors of tests/test_roofline.py
def test_param_counts_dense_matches_manual():
    total, active = param_counts(get_config("gemma-2b"))
    assert total == active
    # gemma-2b ~ 2.5B params (tied embeddings: one 256000 x 2048 table)
    assert 2.0e9 < total < 3.2e9, total


def test_param_counts_moe_active_fraction():
    total, active = param_counts(get_config("llama4-scout-17b-a16e"))
    assert 90e9 < total < 120e9, total      # Scout ~109B total
    assert 14e9 < active < 25e9, active     # ~17B active (top-1 + shared)


def test_cost_model_orders_of_magnitude():
    cfg = get_config("internlm2-20b")
    c_train = cost_for(cfg, INPUT_SHAPES["train_4k"], n_devices=256)
    c_dec = cost_for(cfg, INPUT_SHAPES["decode_32k"], n_devices=256)
    # 6ND for 20B x 1M tokens x tau=2 ~ 2.5e17
    assert 1e17 < c_train.model_flops_total < 1e18
    # decode: 2*N*B ~ 2*20e9*128 ~ 5e12 global
    assert 1e12 < c_dec.model_flops_total < 1e13
    # decode has far lower arithmetic intensity than training
    train_int = c_train.flops_per_device / c_train.hbm_bytes_per_device
    dec_int = c_dec.flops_per_device / c_dec.hbm_bytes_per_device
    assert dec_int * 5 < train_int, (dec_int, train_int)


def test_ssm_decode_cost_has_no_kv_term():
    c = cost_for(get_config("mamba2-130m"), INPUT_SHAPES["long_500k"],
                 n_devices=256)
    # state cache is O(1): far below even 1 GB of reads
    assert c.detail["cache_read_bytes"] < 1e9


# -------------------------------------------------------------- analysis
def test_h100_constants_are_the_data_sheet():
    assert C.peak_flops(torch.bfloat16) == 989e12
    assert C.peak_flops("float16") == 989e12
    assert C.peak_flops(torch.float32) == 67e12
    assert C.peak_flops("float32", tf32=True) == 495e12
    assert (C.HBM_BW, C.HBM_BYTES, C.NVLINK_BW) == (3.35e12, 80e9, 450e9)
    assert (C.L2_BYTES, C.N_SMS, C.SMEM_PER_BLOCK) == (50e6, 132, 232_448)
    assert C.POWER_LIMIT_W == 700 and C.PEAK_FLOPS == 989e12
    with pytest.raises(ValueError):
        C.peak_flops(torch.int8)


def _report(flops, hbm, by_kind, n=16, dtype="bfloat16"):
    cost = StepCost(flops_per_device=flops, hbm_bytes_per_device=hbm,
                    model_flops_total=flops * n / 2, n_params=1,
                    n_active_params=1, detail={})
    summary = {"bytes_by_kind": by_kind,
               "count_by_kind": {k: 1 for k in by_kind},
               "total_bytes": sum(by_kind.values()), "n_sites": len(by_kind)}
    mem = {"argument_bytes": 3, "temp_bytes": 4, "output_bytes": 5}
    return analyze_lowered(arch="a", shape="s", mesh_name="4x4",
                           n_devices=n, cost=cost, collectives=summary,
                           memory=mem, dtype=dtype)


def test_analyze_lowered_ring_factors_and_bottleneck():
    b = 450e9  # one second of NVLink each way
    r = _report(0.0, 0.0, {"all-reduce": b, "all-gather": b,
                           "reduce-scatter": b, "all-to-all": b,
                           "collective-permute": b})
    n = 16
    assert r.collective_s == pytest.approx(
        2 * (n - 1) / n + (n - 1) / n + (n - 1) / n + 1 + 1, rel=1e-15)
    assert r.bottleneck == "collective"
    assert r.memory_per_device_bytes == 12 and r.raw_cost_analysis == {}
    r = _report(989e12, 1e12, {})
    assert (r.compute_s, r.bottleneck) == (1.0, "compute")
    assert r.flops_ratio == pytest.approx(0.5)
    assert r.analytic_flops_total == 989e12 * 16
    r = _report(989e12, 3.35e12 * 2, {"all-gather": 1})
    assert (r.memory_s, r.bottleneck) == (2.0, "memory")
    # a float32 program's compute term is read at the CUDA cores' peak
    r = _report(67e12, 0.0, {}, dtype="float32")
    assert r.compute_s == 1.0
