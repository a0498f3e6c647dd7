"""The port's partition rules (``src/repro_torch/launch/partition.py``)
against the JAX package's, on the CPU.

* Mirrors of ``tests/test_partition.py``'s six rule tests on the port's
  spec tuples (a spec is the reference's ``PartitionSpec`` as a tuple).
* Every leaf of all 11 full-width parameter trees (the port's on the
  ``meta`` device, the reference's through ``jax.eval_shape``) gets the
  reference's spec, entry for entry: tp 16; client axes ``()``,
  ``("data",)`` and ``("pod", "data")``; an extra axis fsdp 4 and data 16.
  The reference's rules are pure and need no mesh.
* Cache specs for qwen3, mamba2, zamba2 and whisper at ``decode_32k`` and
  ``long_500k``: the port's ``cache_shardings`` against the reference's
  ``cache_pspec`` plus its divisibility repair (``partition.py:164-176``).
* In a fake 16 x 16 world, the placements of each spec give DTensors
  whose local shards have the shapes of the spec arithmetic, and the
  argument bytes are the sum of those shards.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch import partition as P
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import build_model


class L:  # tiny shape stand-in
    def __init__(self, *shape):
        self.shape = shape
        self.ndim = len(shape)


TP = 16


def test_attention_projection_rules():
    assert P._base_spec(("layers", "attn", "wq"), (6144, 6144), TP) == (None, "model")
    assert P._base_spec(("layers", "attn", "wo"), (6144, 6144), TP) == ("model", None)
    assert P._base_spec(("layers", "attn", "wk"), (2048, 256), TP) == (None, "model")


def test_moe_rules_divisible_vs_not():
    # llama4: 16 experts over a 16-way model axis -> expert parallel
    assert P._base_spec(("layers", "moe", "up"), (16, 5120, 8192), TP) == ("model", None, None)
    # granite: 40 experts don't divide 16 -> shard the ffn dim instead
    assert P._base_spec(("layers", "moe", "up"), (40, 1536, 512), TP) == (None, None, "model")
    assert P._base_spec(("layers", "moe", "down"), (40, 512, 1536), TP) == (None, "model", None)
    # shared expert inside the moe dict follows dense rules
    assert P._base_spec(("layers", "moe", "shared", "up"), (5120, 8192), TP) == (None, "model")


def test_embed_vocab_sharding_and_odd_vocab():
    assert P._base_spec(("embed",), (92544, 6144), TP) == ("model", None)
    # odd vocab (49155) is not sharded
    assert P._base_spec(("embed",), (49155, 1536), TP) == (None, None)


def test_norms_replicated():
    assert P._base_spec(("layers", "ln1", "weight"), (6144,), TP) == ()


def test_stacked_and_client_axes_padding():
    # federated state leaf: [clients, L, d_in, d_out]
    spec = P.param_pspec(("layers", "attn", "wq"), L(16, 48, 6144, 6144), TP,
                         client_axes=("pod", "data"))
    assert spec == (("pod", "data"), None, None, "model")
    spec = P.param_pspec(("layers", "mlp", "up"), L(48, 2048, 6144), TP)
    assert spec == (None, None, "model")


def test_fsdp_extra_axis():
    spec = P.param_pspec(("layers", "attn", "wq"), L(4, 48, 5120, 5120), TP,
                         client_axes=("data",), extra_axis="fsdp",
                         extra_size=4)
    assert spec == (("data",), None, "fsdp", "model")
    # 1-d leaves unaffected
    spec = P.param_pspec(("layers", "ln1", "weight"), L(48, 5120), TP,
                         extra_axis="fsdp", extra_size=4)
    assert spec == (None, None)


# ----------------------------------------------- full trees vs reference
def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def _ref_specs(arch, **kw):
    jax = _jax()
    from jax.sharding import PartitionSpec
    from repro.configs import get_config as j_get
    from repro.launch import partition as jp
    from repro.models import build_model as j_build

    model = j_build(j_get(arch))
    tree = jax.eval_shape(lambda k: model.init(k), jax.random.key(0))
    specs = jp.tree_pspecs(tree, TP, **kw)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {jp._path_names(kp): _canon(s) for kp, s in flat}


def _canon(spec):
    """A spec with one-axis tuples as their axis: ``PartitionSpec``
    stores ``("data",)`` as ``"data"``, an equal spec."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


VARIANTS = {
    "plain": {},
    "clients_data": dict(client_axes=("data",)),
    "clients_pod_data": dict(client_axes=("pod", "data")),
    "fsdp4": dict(extra_axis="fsdp", extra_size=4),
    "data16": dict(extra_axis="data", extra_size=16),
}


@pytest.mark.parametrize("arch", list_archs())
def test_every_leaf_matches_reference(arch):
    tree = build_model(get_config(arch)).init(torch.Generator(),
                                             device="meta")
    for name, kw in VARIANTS.items():
        got = dict(P.tree_pspecs(tree, TP, **kw))
        want = _ref_specs(arch, **kw)
        assert sorted(got) == sorted(want), (arch, name)
        for path in want:
            assert _canon(got[path]) == want[path], (arch, name, path)


class _Mesh:
    """A stand-in with a DeviceMesh's names and sizes."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self._shape = shape

    def size(self, i):
        return self._shape[i]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-130m", "zamba2-1.2b",
                                  "whisper-small"])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_cache_specs_match_reference(arch, shape):
    jax = _jax()
    from repro.configs import get_config as j_get
    from repro.launch import partition as jp
    from repro.models import build_model as j_build

    shp = INPUT_SHAPES[shape]
    cap = shp.seq_len
    mesh = _Mesh((16, 16), ("data", "model"))
    caches = build_model(get_config(arch)).init_caches(
        shp.global_batch, cap, device="meta")
    got = dict(zip([p for p, _ in P._leaves(caches)[0]],
                   P.spec_leaves(P.cache_shardings(
                       caches, mesh, batch=shp.global_batch))))

    jmodel = j_build(j_get(arch))
    jc = jax.eval_shape(lambda: jmodel.init_caches(shp.global_batch, cap))
    sizes = {"data": 16, "model": 16}
    if shp.global_batch % 16 == 0 and shp.global_batch >= 16:
        dp, seq_axes = ("data",), "model"
    else:
        dp, seq_axes = None, ("data", "model")
    n = 0
    for kp, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
        path = jp._path_names(kp)
        spec = jp.cache_pspec(path, leaf, TP, dp, seq_axes)
        fixed = []
        for ax, dim in zip(spec, leaf.shape):
            size = math.prod(sizes[a] for a in (
                ax if isinstance(ax, tuple) else (ax,) if ax else ()))
            fixed.append(ax if size and dim % size == 0 and dim >= size
                         else None)
        if path[-1] == "length":   # a host int in the port
            assert got[path] is None
            continue
        assert _canon(got[path]) == _canon(fixed), (path, got[path], fixed)
        n += 1
    assert n >= 2


# ----------------------------------------------------- placements, fake
@pytest.fixture(scope="module")
def mesh16():
    with fake_world(256):
        yield make_production_mesh()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m",
                                  "llama4-scout-17b-a16e", "whisper-small"])
def test_placements_give_the_spec_arithmetic(mesh16, arch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor

    tree = build_model(get_config(arch).with_dtype("bfloat16")).init(
        torch.Generator(), device="meta")
    wide = "data" if arch.startswith("llama4") else None
    specs = P.tree_shardings(tree, mesh16, TP, extra_axis=wide)
    dts = P.distribute(tree, specs, mesh16,
                       FakeTensorMode(allow_non_fake_inputs=True))
    sizes = {"data": 16, "model": 16}
    total = 0
    for (path, leaf), spec, dt in zip(P._leaves(tree)[0],
                                      P.spec_leaves(specs),
                                      P._leaves(dts)[0]):
        dt = dt[1]
        assert isinstance(dt, DTensor) and dt.shape == leaf.shape, path
        want = []
        for dim, ax in zip(leaf.shape, spec):
            axes = ax if isinstance(ax, tuple) else (ax,) if ax else ()
            want.append(dim // math.prod(sizes[a] for a in axes))
        assert tuple(dt._local_tensor.shape) == tuple(want), (path, spec)
        total += math.prod(want) * 2
    assert P.local_bytes(dts) == total
    # sharding leaves well under half the tree on one device
    n = sum(leaf.numel() for _, leaf in P._leaves(tree)[0])
    assert total < 2 * n / 2


def test_spec_placements_follow_the_mesh_order(mesh16):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.utils.sharding_ctx import spec_placements

    assert spec_placements((None, "model", None), mesh16) == (
        Replicate(), Shard(1))
    assert spec_placements((("data", "model"), None), mesh16) == (
        Shard(0), Shard(0))
    with pytest.raises(ValueError):
        spec_placements((("model", "data"),), mesh16)
    with pytest.raises(ValueError):
        spec_placements(("pod",), mesh16)
    with pytest.raises(ValueError):
        P.local_shape((15, 4), ("model", None), mesh16)
    assert np.prod(P.local_shape((32, 64), ("data", "model"), mesh16)) == 8


def test_overrides_and_train_mesh_view(mesh16):
    from repro_torch.launch.mesh import (client_axes, mesh_shape, n_clients,
                                         tp_size)
    from repro_torch.launch.overrides import (ArchDistribution,
                                              distribution_for,
                                              train_mesh_view)

    assert distribution_for("llama4-scout-17b-a16e") == ArchDistribution(
        fsdp=4, serve_wide=True)
    assert distribution_for("llava-next-34b").fsdp == 2
    assert distribution_for("qwen3-1.7b") == ArchDistribution()
    assert (client_axes(mesh16), n_clients(mesh16), tp_size(mesh16)) == (
        ("data",), 16, 16)
    assert train_mesh_view(mesh16, 1) is mesh16
    view = train_mesh_view(mesh16, 4)
    assert mesh_shape(view) == {"data": 4, "fsdp": 4, "model": 16}
    assert client_axes(view) == ("data",)
    # the same ranks in the same order: the mesh tensor reshaped
    assert view.mesh.flatten().tolist() == mesh16.mesh.flatten().tolist()
    with pytest.raises(ValueError):
        train_mesh_view(mesh16, 5)
