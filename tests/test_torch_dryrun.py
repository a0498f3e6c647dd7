"""The port's dry run (``src/repro_torch/launch/dryrun.py``) and sharded
serving steps (``launch/serve.py:lower_prefill`` / ``lower_decode``) on
the CPU. Every process group lives in a subprocess of its own, so none
meets this test session.

* The mirror of ``tests/test_partition.py``'s small-mesh lowering: a fake
  2 x 4 world, reduced qwen3 at a ``decode_32k`` of 64 tokens x 4, traced
  on fake shards; temp bytes > 0.
* ``run_one`` for mamba2-130m x ``long_500k`` on a fake 16 x 16 world at
  full width: status ok, argument bytes the sum of the local shards, and
  its ``roofline`` equal to ``analyze_lowered(cost_for(...))`` of the
  record's memory and collectives.
* A shape the coverage policy refuses is recorded as skipped with the
  policy's reason; ``run_one`` on a reduced qwen3 train cell (64 tokens x
  16 clients) on a fake 16 x 16 world ends ok, its argument bytes the
  local shards' from the specs' arithmetic, its ``roofline`` equal to
  ``analyze_lowered(cost_for(...))``; a ``merge_results`` round trip.
* On the ``cpu`` fake mesh DTensor issues an all-to-all as an all-gather
  and a chunk, and the counter reports what it saw: an all-gather.
* The sharded steps run for real on a one-rank ``gloo`` group and a 1 x 1
  mesh (the card's ``sharded`` phase, on the CPU): reduced qwen3 and
  mamba2 prefill plus three decode steps equal the unsharded run within
  1e-6 of the logits' scale, with no collective bytes.
"""

import json
import os
import subprocess
import sys


from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script: str, timeout: int = 300) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=timeout, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


SMALL_MESH = r"""
from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES, ShapeConfig
from repro_torch.launch import serve
from repro_torch.launch.mesh import fake_world, make_test_mesh

INPUT_SHAPES["decode_32k"] = ShapeConfig("decode_32k", 64, 4, "decode")
cfg = get_config("qwen3-1.7b").reduced().with_dtype("bfloat16")
with fake_world(8):
    mesh = make_test_mesh((2, 4), ("data", "model"))
    out = serve.lower_decode("qwen3-1.7b", mesh, shape_name="decode_32k",
                             cfg=cfg).trace()
    assert out["memory"]["temp_bytes"] > 0, out
    assert out["memory"]["argument_bytes"] > 0, out
    print("DECODE_OK", out["collectives"]["n_sites"])
"""


def test_small_mesh_lowering_subprocess():
    assert "DECODE_OK" in _run(SMALL_MESH)


RUN_ONE = r"""
import json
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import dryrun, partition, serve
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.roofline.analysis import analyze_lowered
from repro_torch.roofline.flops import cost_for

with fake_world(256):
    rec = dryrun.run_one("mamba2-130m", "long_500k", multi_pod=False,
                         verbose=False)
    low = serve.lower_decode("mamba2-130m", make_production_mesh(),
                             shape_name="long_500k")
    sizes = {"data": 16, "model": 16}
    want = 0
    for tree, specs in zip(low.abstract, low.specs):
        for (_, leaf), spec in zip(partition._leaves(tree)[0],
                                   partition.spec_leaves(specs)):
            if spec is None:
                continue
            n = leaf.numel()
            for ax in spec:
                for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
                    n //= sizes[a]
            want += n * leaf.element_size()
assert rec["status"] == "ok", rec
assert rec["memory"]["argument_bytes"] == want, (rec["memory"], want)
cfg = get_config("mamba2-130m").with_dtype("bfloat16")
r = analyze_lowered(arch="mamba2-130m", shape="long_500k", mesh_name="16x16",
                    n_devices=256,
                    cost=cost_for(cfg, INPUT_SHAPES["long_500k"],
                                  n_devices=256),
                    collectives=rec["roofline"]["collective_detail"],
                    memory=rec["memory"], dtype="bfloat16")
assert json.loads(json.dumps(r.as_dict())) == rec["roofline"]
assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")
print("RUN_ONE_OK", json.dumps(rec["memory"]))
"""


def test_run_one_mamba2_long_500k_on_16x16():
    assert "RUN_ONE_OK" in _run(RUN_ONE)


def test_policy_skip_keeps_its_reason(capsys):
    rec = dryrun.run_one("internlm2-20b", "long_500k", multi_pod=True)
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
    assert "SKIP internlm2-20b x long_500k" in capsys.readouterr().out


TRAIN_CELL = r"""
import dataclasses, json
import repro_torch.configs as C
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, partition, train
from repro_torch.launch.mesh import (axis_size, fake_world,
                                     make_production_mesh)
from repro_torch.roofline.analysis import analyze_lowered
from repro_torch.roofline.flops import cost_for

# qwen3 reduced, train_4k as 64 tokens x 16 clients of one sequence
C._REGISTRY["qwen3-1.7b"] = dataclasses.replace(
    get_config("qwen3-1.7b").reduced(), name="qwen3-1.7b")
INPUT_SHAPES["train_4k"] = ShapeConfig("train_4k", 64, 16, "train")
with fake_world(256):
    rec = dryrun.run_one("qwen3-1.7b", "train_4k", multi_pod=False,
                         verbose=False)
    low = train.lower_train_step(
        train.make_plan("qwen3-1.7b", make_production_mesh()), donate=False)
    want = 0
    for tree, specs in zip(low.abstract, low.specs):
        for (_, leaf), spec in zip(partition._leaves(tree)[0],
                                   partition.spec_leaves(specs)):
            if spec is None:
                continue
            n = leaf.numel()
            for ax in spec:
                for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
                    n //= axis_size(low.plan.mesh, a)
            want += n * leaf.element_size()
assert rec["status"] == "ok", rec
assert rec["memory"]["argument_bytes"] == want, (rec["memory"], want)
assert rec["memory"]["temp_bytes"] > 0, rec["memory"]
cfg = get_config("qwen3-1.7b").with_dtype("bfloat16")
r = analyze_lowered(arch="qwen3-1.7b", shape="train_4k", mesh_name="16x16",
                    n_devices=256,
                    cost=cost_for(cfg, INPUT_SHAPES["train_4k"],
                                  n_devices=256),
                    collectives=rec["roofline"]["collective_detail"],
                    memory=rec["memory"], dtype="bfloat16")
assert json.loads(json.dumps(r.as_dict())) == rec["roofline"]
# the client mean is the one reduction across the clients
assert rec["roofline"]["collective_detail"]["bytes_by_kind"]
print("TRAIN_CELL_OK", json.dumps(rec["memory"]))
"""


def test_run_one_reduced_train_cell_on_16x16():
    assert "TRAIN_CELL_OK" in _run(TRAIN_CELL)


def test_merge_results_round_trip(tmp_path):
    path = str(tmp_path / "sub" / "d.json")
    a = {"arch": "a", "shape": "s", "mesh": "16x16", "status": "ok"}
    b = {"arch": "b", "shape": "s", "mesh": "16x16", "status": "skipped"}
    dryrun.merge_results(path, [a])
    dryrun.merge_results(path, [dict(a, status="error"), b])
    with open(path) as f:
        data = json.load(f)
    assert data == {"a|s|16x16": dict(a, status="error"), "b|s|16x16": b}
    assert not os.path.exists(path + ".tmp")


ALL_TO_ALL = r"""
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.mesh import fake_world, make_test_mesh
from repro_torch.roofline.comm_count import CollectiveCounter

with fake_world(4):
    mesh = make_test_mesh((1, 4))
    with FakeTensorMode():
        local = torch.empty(8, 16)
    x = DTensor.from_local(local, mesh, (Replicate(), Shard(0)),
                           run_check=False, shape=(32, 16), stride=(16, 1))
    with CollectiveCounter() as cc:
        y = x.redistribute(mesh, (Replicate(), Shard(1)))
    assert tuple(y.to_local().shape) == (32, 4)
    s = cc.collective_summary()
    assert s["count_by_kind"] == {"all-gather": 1}, s
    assert s["bytes_by_kind"] == {"all-gather": 32 * 16 * 4}, s
    print("A2A_AS_ALLGATHER")
"""


def test_cpu_mesh_reports_all_to_all_as_all_gather():
    assert "A2A_AS_ALLGATHER" in _run(ALL_TO_ALL)


REAL_RUN = r"""
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES, ShapeConfig
from repro_torch.launch import input_specs, partition, serve
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_model

dist.init_process_group("gloo", init_method="tcp://localhost:%d" % PORT,
                        world_size=1, rank=0)
try:
    mesh = make_test_mesh((1, 1), device_type="cpu")
    for arch in ("qwen3-1.7b", "mamba2-130m"):
        cfg = get_config(arch).reduced()
        B, S, G = 2, 24, 3
        cap = S + G
        INPUT_SHAPES["_p"] = ShapeConfig("_p", S, B, "prefill")
        INPUT_SHAPES["_d"] = ShapeConfig("_d", cap, B, "decode")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        batch = input_specs.make_batch(cfg, B, S, key=1)
        with torch.no_grad():
            c0 = model.init_caches(B, cap, device="cpu")
            want, c0 = model.prefill(params, batch, c0)
            wants = [want]
            tok = torch.argmax(want[:, -1:], -1).to(torch.int32)
            for _ in range(G):
                w, c0 = model.decode_step(params, tok, c0)
                wants.append(w)
                tok = torch.argmax(w[:, -1:], -1).to(torch.int32)
        pre = serve.lower_prefill(arch, mesh, shape_name="_p", cfg=cfg)
        dec = serve.lower_decode(arch, mesh, shape_name="_d", cfg=cfg)
        dparams = partition.distribute(params, pre.specs[0], mesh)
        (got, caches), coll = pre.run(dparams, batch,
                                      model.init_caches(B, cap, device="cpu"))
        gots, total = [got], coll["total_bytes"]
        tok = torch.argmax(got.to_local()[:, -1:], -1).to(torch.int32)
        for _ in range(G):
            (g, caches), coll = dec.run(dparams, tok, caches)
            gots.append(g)
            total += coll["total_bytes"]
            tok = torch.argmax(g.to_local()[:, -1:], -1).to(torch.int32)
        for g, w in zip(gots, wants):
            g = g.to_local()
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= 1e-6 * scale, arch
        assert total == 0, total
        print("REAL_OK", arch)
finally:
    dist.destroy_process_group()
"""


def test_sharded_steps_run_on_a_one_rank_group():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = _run(REAL_RUN.replace("PORT", str(port)))
    assert out.count("REAL_OK") == 2, out
