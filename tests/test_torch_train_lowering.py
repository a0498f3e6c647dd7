"""The port's training lowering (``src/repro_torch/launch/train.py``:
``make_plan``, ``state_shardings``, ``abstract_state``,
``build_round_fn``, ``lower_train_step``), the engine's
``spmd_client_axes`` and the FedCET kernels' DTensor rules, on the CPU.

* Mirrors of ``tests/test_topology.py``'s two ``abstract_state`` tests:
  the ``TopoState`` slot before the ``DelayState`` slot, the tier memory
  shaped ``[g, ...]``, and ``state_shardings`` replicating it.
* ``state_shardings`` and ``abstract_state`` against the reference's, entry
  for entry, on a 16 x 16 mesh (the reference's side in a process of its
  own with 256 fake XLA devices): qwen3-1.7b at full width, llama4-scout's
  fsdp 4 view, and a ``shift:q8`` + ``rr:1`` scenario (the shift memory
  and the delay buffer). The step counter ``t`` is a host int in the port
  and has no spec: it is left out of the comparison.
* The train half of ``tests/test_partition.py``'s small-mesh lowering:
  reduced qwen3, ``train_4k`` as 64 tokens x 4, a fake 2 x 4 world, one
  round traced on fake shards with temp bytes > 0; and a reduced
  granite-moe on a fake (2, 3) world, whose 4 experts do not divide the
  model axis, through the token-sharded MoE dispatch.
* Four ``gloo`` ranks on a (2, 2) mesh run 2 rounds of reduced qwen3
  (4 clients x batch 2 x seq 32, tau 2) through ``LoweredTrain.run``:
  plain in float32, and under per-leaf ``shift:q8`` with participation
  0.75 in float32 and in float64, from the reference's init state (the
  draws in float64 / int64, x64 on as in ``tests/test_torch_train.py``).
  Rank 0's ``full_tensor()`` of x, d and the shift memory is held per
  leaf within 1e-6 of the leaf's scale (max |x|; the shift memory's own)
  of the port's unsharded rounds, and within ``tests/test_torch_train.py``'s
  tolerances (x 1e-5 of scale, d 1e-5 * c * scale, the shift memory 1e-5
  of its scale) of the reference's ``build_round_fn(plan)`` rounds. In
  float32 at most 1e-3 of the coordinates may sit outside: a quantizer
  code moves by one step where float32 sums in another order put ``(v -
  h)/s + u`` on the other side of an integer. In float64 none may.
* The kernel wrappers on DTensors of a one-rank ``gloo`` group equal
  their plain versions; a layout the shards cannot compute alone raises.

Every process group lives in a subprocess of its own, so none meets
this test session.
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script: str, *args, env=None, timeout: int = 300) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **(env or {}))
    res = subprocess.run([sys.executable, "-c", script, *args],
                         capture_output=True, text=True, timeout=timeout,
                         env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def _last_json(out: str, tag: str):
    line = [ln for ln in out.splitlines() if ln.startswith(tag + " ")][-1]
    return json.loads(line[len(tag) + 1:])


# ------------------------------------------------------------ mirrors
MIRRORS = r"""
import dataclasses
import torch
from repro_torch.configs.base import FedScenario
from repro_torch.core.engine import EngineState, with_topology
from repro_torch.core.fedcet import FedCET
from repro_torch.core.staleness import DelayState
from repro_torch.core.topology import TopoState
from repro_torch.launch import partition
from repro_torch.launch.mesh import fake_world, make_test_mesh
from repro_torch.launch.train import abstract_state, make_plan, state_shardings
from repro_torch.utils.tree import tree_leaves

with fake_world(1):
    mesh = make_test_mesh((1, 1))
    # the TopoState slot before the DelayState slot
    plan = make_plan("qwen3-1.7b", mesh,
                     scenario=FedScenario(topology="er:0.5:t", delay="rr:1"))
    shapes = abstract_state(plan)
    assert isinstance(shapes, EngineState)
    assert isinstance(shapes.extras[-2], TopoState)
    assert shapes.extras[-2].k == 0 and shapes.extras[-2].tier is None
    assert isinstance(shapes.extras[-1], DelayState)
    assert shapes.extras[-1].age.shape == (1,)
    assert shapes.extras[-1].age.dtype == torch.int32
    sh = state_shardings(plan, shapes)
    assert isinstance(sh.extras[-2], TopoState)
    assert partition.spec_leaves(sh.extras[-1].age) == [(("data",),)]
    print("TOPO_DELAY_OK")

    # the tier memory of a hierarchy with stateful tier compression
    plan = make_plan("qwen3-1.7b", mesh)
    algo = with_topology(FedCET(alpha=1e-3, c=0.05, tau=2, n_clients=8),
                         "hier:g4", tier_compression="shift:q8")
    plan = dataclasses.replace(plan, algo=algo, n_clients=8)
    shapes = abstract_state(plan)
    assert isinstance(shapes, EngineState)
    tstate = shapes.extras[-1]
    assert isinstance(tstate, TopoState) and tstate.k == 0
    assert isinstance(tstate.tier, tuple) and len(tstate.tier) == 1
    x_leaves = tree_leaves(shapes.inner.x)
    t_leaves = tree_leaves(tstate.tier)
    assert len(t_leaves) == len(x_leaves)
    assert all(t.shape == (4,) + x.shape[1:] and t.device.type == "meta"
               for t, x in zip(t_leaves, x_leaves))
    sh = state_shardings(plan, shapes)
    assert isinstance(sh.extras[-1], TopoState)
    assert set(partition.spec_leaves(sh.extras[-1].tier)) == {()}
    print("TIER_OK")
"""


def test_abstract_state_mirrors_topology_extras():
    out = _run(MIRRORS)
    assert "TOPO_DELAY_OK" in out and "TIER_OK" in out


# ---------------------------------------------- specs against the reference
#: (arch, scenario kwargs) of the spec comparison.
SPEC_CASES = (("qwen3-1.7b", {}), ("llama4-scout-17b-a16e", {}),
              ("qwen3-1.7b", {"compression": "shift:q8", "delay": "rr:1"}))

REF_SPECS = r"""
import json, sys
import jax
import numpy as np
from jax.sharding import PartitionSpec
from repro.configs.base import FedScenario
from repro.launch import partition as jp
from repro.launch.mesh import make_production_mesh
from repro.launch.train import abstract_state, make_plan, state_shardings

out = []
for arch, scen in json.loads(sys.argv[1]):
    plan = make_plan(arch, make_production_mesh(),
                     scenario=FedScenario(**scen) if scen else None)
    shapes = abstract_state(plan)
    sh = state_shardings(plan, shapes)
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    specs = jax.tree.leaves(sh, is_leaf=lambda s: hasattr(s, "spec"))
    rec = {}
    for (kp, leaf), s in zip(leaves, specs):
        spec = tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                     for a in s.spec)
        rec["/".join(jp._path_names(kp))] = [list(leaf.shape),
                                             str(np.dtype(leaf.dtype)),
                                             spec]
    out.append(rec)
print("REF " + json.dumps(out))
"""

PORT_SPECS = r"""
import json, sys
from repro_torch.configs.base import FedScenario
from repro_torch.launch import partition
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.train import abstract_state, make_plan, state_shardings

out = []
with fake_world(256):
    for arch, scen in json.loads(sys.argv[1]):
        plan = make_plan(arch, make_production_mesh(),
                         scenario=FedScenario(**scen) if scen else None)
        shapes = abstract_state(plan)
        leaves, _ = partition._leaves(shapes)
        specs = partition.spec_leaves(state_shardings(plan, shapes))
        rec = {}
        for (path, leaf), spec in zip(leaves, specs):
            if spec is None:  # a host int: t, or a TopoState's k
                continue
            spec = tuple(a[0] if isinstance(a, tuple) and len(a) == 1
                         else a for a in spec)
            rec["/".join(path)] = [list(leaf.shape),
                                   str(leaf.dtype).replace("torch.", ""),
                                   spec]
        out.append(rec)
print("PORT " + json.dumps(out))
"""


def test_state_shardings_and_shapes_match_the_reference_on_16x16():
    cases = json.dumps(SPEC_CASES)
    ref = _last_json(_run(REF_SPECS, cases, env={
        "XLA_FLAGS": "--xla_force_host_platform_device_count=256",
        "JAX_PLATFORMS": "cpu"}), "REF")
    port = _last_json(_run(PORT_SPECS, cases), "PORT")
    for (arch, scen), want, got in zip(SPEC_CASES, ref, port):
        # the reference's step counter t (P()) is a host int in the port
        want = {k: v for k, v in want.items() if k not in ("t", "inner/t")}
        assert sorted(got) == sorted(want), (arch, scen)
        for path, (shape, dtype, spec) in want.items():
            g_shape, g_dtype, g_spec = got[path]
            assert (g_shape, g_dtype) == (shape, dtype), (arch, path)
            assert [tuple(a) if isinstance(a, list) else a for a in g_spec] \
                == [tuple(a) if isinstance(a, list) else a for a in spec], \
                (arch, scen, path, g_spec, spec)
    # the fsdp view: llama4's state shards over (data, fsdp, model)
    assert any("fsdp" in json.dumps(s) for _, _, s in port[1].values())
    # the delay buffer's age over the clients, the shift memory as x
    ages = [v for k, v in port[2].items() if k.endswith("/age")]
    assert ages == [[[16], "int32", ["data"]]]


# ------------------------------------------------- small-mesh lowering
SMALL_MESH = r"""
import dataclasses
import repro_torch.configs as C
import repro_torch.models.moe as moe
from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES, ShapeConfig
from repro_torch.launch.mesh import fake_world, make_test_mesh
from repro_torch.launch.train import lower_train_step, make_plan

# qwen3 reduced, train_4k as 64 tokens x 4, on a fake 2 x 4 world
C._REGISTRY["qwen3-1.7b"] = dataclasses.replace(
    get_config("qwen3-1.7b").reduced(), name="qwen3-1.7b")
INPUT_SHAPES["train_4k"] = ShapeConfig("train_4k", 64, 4, "train")
with fake_world(8):
    plan = make_plan("qwen3-1.7b", make_test_mesh((2, 4), ("data", "model")))
    assert plan.n_clients == 2 and plan.per_client_batch == 2
    out = lower_train_step(plan).trace()
    assert out["memory"]["temp_bytes"] > 0, out
    assert out["memory"]["argument_bytes"] > 0, out
    print("TRAIN_OK", out["collectives"]["n_sites"])

# granite-moe reduced: 4 experts over a 3-way model axis
calls = []
grid = moe._grid_dtensor
moe._grid_dtensor = lambda *a: calls.append(1) or grid(*a)
C._REGISTRY["granite-moe-3b-a800m"] = dataclasses.replace(
    get_config("granite-moe-3b-a800m").reduced(),
    name="granite-moe-3b-a800m")
INPUT_SHAPES["train_4k"] = ShapeConfig("train_4k", 48, 4, "train")
with fake_world(6):
    plan = make_plan("granite-moe-3b-a800m",
                     make_test_mesh((2, 3), ("data", "model")))
    low = lower_train_step(plan)
    assert plan.cfg.n_experts == 4 and low.moe == {
        "nb": 1, "ns": 3, "axes": ("model",),
        "spec": ("model", None, None)}, low.moe
    out = low.trace()
    assert out["memory"]["temp_bytes"] > 0, out
    # 2 layers x tau 2 gradient evaluations, one client a rank
    assert len(calls) == 4, calls
    print("MOE_OK", out["collectives"]["n_sites"])
"""


def test_small_mesh_train_lowering_and_token_sharded_moe():
    out = _run(SMALL_MESH)
    assert "TRAIN_OK" in out and "MOE_OK" in out


# ------------------------------------------------- multi-rank parity
NC, B, S, TAU, ROUNDS = 4, 2, 32, 2, 2
ALPHA, CW = 3e-3, 0.05
SHIFT_Q8 = {"compression": "shift:q8", "participation": 0.75}
#: name: (scenario, dtype of both models)
SCENARIOS = {"plain": ({}, "float32"),
             "shift_q8_p075": (SHIFT_Q8, "float32"),
             "shift_q8_p075_f64": (SHIFT_Q8, "float64")}
#: the share of coordinates where a float32 quantizer code may move
#: (``tests/test_torch_train.py``'s allowance): none in float64
FLIP_CAP = {"shift_q8_p075": 1e-3}

RANKS = r"""
import dataclasses, pickle, sys
import torch
import torch.distributed as dist


def worker(rank, port, path, out_path):
    torch.set_num_threads(1)
    import repro_torch.configs as C
    from repro_torch.configs import get_config
    from repro_torch.configs.base import INPUT_SHAPES, FedScenario, ShapeConfig
    from repro_torch.core.engine import EngineState
    from repro_torch.core.fedcet import FedCETState
    from repro_torch.launch import partition, train
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_leaves, tree_map

    with open(path, "rb") as f:
        inp = pickle.load(f)
    nc, b, s, tau = inp["nc"], inp["b"], inp["s"], inp["tau"]
    C._REGISTRY["qwen3-1.7b"] = dataclasses.replace(
        get_config("qwen3-1.7b").reduced(), name="qwen3-1.7b")
    INPUT_SHAPES["_t"] = ShapeConfig("_t", s, nc * b, "train")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=4, rank=rank)
    mesh = make_test_mesh((2, 2), device_type="cpu")
    out = {}
    for name, (scen, dtype) in inp["scenarios"].items():
        plan = train.make_plan("qwen3-1.7b", mesh, shape_name="_t",
                               dtype=dtype, alpha=inp["alpha"],
                               c=inp["c"], scenario=FedScenario(**scen))
        plan = dataclasses.replace(plan, n_clients=nc, per_client_batch=b,
                                   algo=dataclasses.replace(
                                       plan.algo, n_clients=nc, x64=True))
        s0 = inp["state"][name]
        like = train.abstract_state(plan)
        like = getattr(like, "inner", like).x
        inner = FedCETState(x=as_port(like, s0["x"]),
                            d=as_port(like, s0["d"]), t=s0["t"])
        state = (EngineState(inner, tuple(as_port(like, e)
                                          for e in s0["extras"]))
                 if s0["extras"] else inner)
        unsharded = dataclasses.replace(plan.algo, spmd_client_axes=())
        grad_fn = torch.func.grad(build_model(plan.cfg).loss)
        arrays = lambda st: [  # noqa: E731
            (t.full_tensor() if hasattr(t, "full_tensor") else t).numpy()
            for t in tree_leaves(st) if isinstance(t, torch.Tensor)]
        batches = [{"tokens": torch.from_numpy(inp["tokens"][r])}
                   for r in range(inp["rounds"])]
        want, wants = state, []
        for bt in batches:
            want = unsharded.round(grad_fn, want, bt)
            wants.append(arrays(want))
        low = train.lower_train_step(plan)
        got = partition.distribute(state, low.specs[0], mesh)
        gots, coll = [], 0
        for bt in batches:
            got, c = low.run(got, bt)
            gots.append(arrays(got))
            coll += c["total_bytes"]
        out[name] = {"sharded": gots, "unsharded": wants,
                     "collective_bytes": coll,
                     "x_placements": str(unsharded._inner(got).x["embed"]
                                         .placements)}
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


def as_port(like, tree):
    # the numpy tree as tensors in the port's tree order (JAX flattens
    # dicts by sorted key, the port in insertion order)
    if isinstance(like, dict):
        return {k: as_port(v, tree[k]) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(as_port(a, b) for a, b in zip(like, tree))
    return torch.from_numpy(tree.copy())


worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
print("RANKS_OK")
"""


def _run_ranks(n: int, *args, timeout: int = 600) -> None:
    """``RANKS`` in ``n`` processes of one ``gloo`` group."""
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", RANKS, str(r),
                               str(port), *args], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=ROOT) for r in range(n)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and "RANKS_OK" in out, err[-3000:]


def _reference_rounds():
    """The reference's init and ``build_round_fn(plan)`` rounds of reduced
    qwen3 in the scenario's dtype, per scenario: ``([init state, after
    round 1, ...] as numpy trees, tokens)``."""
    import jax

    from repro.configs import get_config as j_get
    from repro.configs.base import FedScenario as JScenario
    from repro.core.fedcet import FedCET as JFedCET
    from repro.launch.mesh import make_test_mesh as j_mesh
    from repro.launch.train import TrainPlan, build_round_fn
    from repro.models import build_model as j_build

    reduced = j_get("qwen3-1.7b").reduced()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, reduced.vocab_size, (ROUNDS + 1, TAU, NC, B, S),
                          dtype=np.int32)
    mesh = j_mesh((1, 1))
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        out = {}
        for name, (scen, dtype) in SCENARIOS.items():
            cfg = reduced.with_dtype(dtype)
            model = j_build(cfg)
            params = model.init(jax.random.key(0))
            grad_fn = jax.grad(model.loss)
            algo = JScenario(**scen).apply(JFedCET(
                alpha=ALPHA, c=CW, tau=TAU, n_clients=NC,
                spmd_client_axes=("data",)))
            plan = TrainPlan(cfg=cfg, algo=algo, mesh=mesh, n_clients=NC,
                             per_client_batch=B, seq_len=S)
            with mesh:
                state = jax.jit(lambda p, b: algo.init(grad_fn, p, b))(
                    params, {"tokens": tokens[-1][0]})
                step = jax.jit(build_round_fn(plan))
                states = [state]
                for r in range(ROUNDS):
                    states.append(step(states[-1], {"tokens": tokens[r]}))
            out[name] = [
                {"x": getattr(st, "inner", st).x,
                 "d": getattr(st, "inner", st).d,
                 "t": int(getattr(st, "inner", st).t),
                 "extras": list(getattr(st, "extras", ()))}
                for st in jax.tree.map(np.asarray, states)]
    finally:
        jax.config.update("jax_enable_x64", x64)
    return out, tokens


def _off(got, want, n, x_tol, d_tol):
    """Per leaf of the flattened states (x's n leaves, d's n, then the
    transform extras'): the coordinates of x outside ``x_tol * scale`` and
    of d outside ``d_tol * scale`` (scale: the leaf's max |x| in
    ``want``), and of the extras outside ``x_tol`` of their own scale."""
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        scale = float(np.abs(want[i % n]).max())
        if i >= 2 * n:
            scale, tol = float(np.abs(b).max()), x_tol
        else:
            tol = x_tol if i < n else d_tol
        out.append(np.abs(a - b) > tol * scale)
    return out


def test_four_gloo_ranks_match_the_unsharded_port_and_the_reference(
        tmp_path):
    ref, tokens = _reference_rounds()
    inp = {"nc": NC, "b": B, "s": S, "tau": TAU, "rounds": ROUNDS,
           "alpha": ALPHA, "c": CW, "scenarios": SCENARIOS,
           "tokens": tokens, "state": {k: v[0] for k, v in ref.items()}}
    path, out_path = tmp_path / "in.pkl", tmp_path / "out.pkl"
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    _run_ranks(4, str(path), str(out_path))
    with open(out_path, "rb") as f:
        got = pickle.load(f)
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_leaves

    like = build_model(get_config("qwen3-1.7b").reduced()).init(
        torch.Generator(), device="meta")
    n = len(tree_leaves(like))

    def port_order(like, tree):
        if isinstance(like, dict):
            return [a for k, v in like.items() for a in port_order(v, tree[k])]
        if isinstance(like, (list, tuple)):
            return [a for u, v in zip(like, tree) for a in port_order(u, v)]
        return [tree]

    def flat(st):
        return [a for tree in (st["x"], st["d"], *st["extras"])
                for a in port_order(like, tree)]

    for name in SCENARIOS:
        res = got[name]
        assert res["collective_bytes"] > 0  # the client means, the TP sums
        assert "Shard(dim=0)" in res["x_placements"], res["x_placements"]
        for r in range(ROUNDS):
            reference = flat(ref[name][r + 1])
            sharded, unsharded = res["sharded"][r], res["unsharded"][r]
            assert len(sharded) == len(unsharded) == len(reference) \
                == n * (2 if name == "plain" else 3)
            cap = FLIP_CAP.get(name, 0)
            # against the unsharded port: within 1e-6 of scale
            off = _off(sharded, unsharded, n, 1e-6, 1e-6)
            assert sum(int(o.sum()) for o in off) \
                <= cap * sum(o.size for o in off), (name, r)
            # against the reference: test_torch_train.py's bounds
            off = _off(sharded, reference, n, 1e-5, 1e-5 * CW)
            assert sum(int(o.sum()) for o in off) \
                <= cap * sum(o.size for o in off), (name, r, [
                    i for i, o in enumerate(off) if o.any()])


# ------------------------------------------- kernel wrappers on DTensors
WRAPPERS = r"""
import socket
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch.kernels import ops, ref as R
from repro_torch.launch.mesh import make_test_mesh

with socket.socket() as sk:
    sk.bind(("localhost", 0))
    port = sk.getsockname()[1]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=1, rank=0)
try:
    mesh = make_test_mesh((1, 1), device_type="cpu")
    g = torch.Generator().manual_seed(0)
    x, gr, d, m, v = (torch.randn(4, 6, 8, generator=g) for _ in range(5))
    mb = m.mean(0, keepdim=True)
    pl = (Shard(0), Shard(2))  # clients over data, a coordinate over model
    dt = lambda t, p=pl: distribute_tensor(t, mesh, p)
    mb_pl = (Replicate(), Shard(2))

    got = ops.fedcet_v(dt(x), dt(gr), dt(d), 0.1)
    assert isinstance(got, DTensor) and got.placements == pl
    assert torch.equal(got.full_tensor(), R.fedcet_v(x, gr, d, 0.1))
    for vv in (None, v):
        got = ops.fedcet_comm(dt(d), dt(m), dt(mb, mb_pl), 0.05, 0.1,
                              v=None if vv is None else dt(vv))
        want = R.fedcet_comm(d, m, mb, 0.05, 0.1, v=vv)
        assert all(torch.equal(a.full_tensor(), b) for a, b in zip(got, want))
        assert all(a.placements == pl for a in got)
    u = torch.rand(6, 8, generator=g)
    scale = torch.amax(torch.abs(dt(x))) / 127   # a pending max
    got = ops.stochastic_quantize(dt(x), u, scale, 8)
    want = R.stochastic_quantize(x, u, torch.amax(torch.abs(x)) / 127, 8)
    assert torch.equal(got.full_tensor(), want) and got.placements == pl
    got = ops.stochastic_quantize(dt(x), dt(u, (Replicate(), Shard(1))),
                                  scale, 8)
    assert torch.equal(got.full_tensor(), want)

    bad = [lambda: ops.fedcet_v(dt(x), dt(gr, (Shard(0), Shard(1))), dt(d),
                                0.1),
           lambda: ops.fedcet_v(dt(x), gr, dt(d), 0.1),
           lambda: ops.fedcet_comm(dt(d), dt(m), dt(mb, pl), 0.05, 0.1),
           lambda: ops.stochastic_quantize(dt(x), dt(u, (Replicate(),
                                                         Shard(0))), scale, 8)]
    for f in bad:
        try:
            f()
        except ValueError:
            continue
        raise AssertionError("a layout the shards cannot compute alone "
                             "was accepted")
    print("WRAPPERS_OK")
finally:
    dist.destroy_process_group()
"""


def test_kernel_wrappers_on_dtensors_equal_the_plain_versions():
    assert "WRAPPERS_OK" in _run(WRAPPERS)


def test_spmd_client_axes_no_longer_raise_and_change_no_plain_round():
    """``RoundEngine(spmd_client_axes=...)`` builds; on plain tensors the
    round is the unsharded one, bit for bit."""
    import torch

    from repro_torch.core.fedcet import FedCET
    from repro_torch.utils.tree import tree_leaves

    gen = torch.Generator().manual_seed(0)
    A = torch.randn(3, 5, 5, generator=gen, dtype=torch.float64)

    def loss(p, batch):
        r = batch["a"] @ p["w"] - batch["b"]
        return 0.5 * torch.sum(r * r)

    batches = {"a": A.expand(2, 3, 5, 5).clone(),
               "b": torch.randn(2, 3, 5, generator=gen, dtype=torch.float64)}
    grad = torch.func.grad(loss)
    x0 = {"w": torch.zeros(5, dtype=torch.float64)}
    outs = []
    for axes in ((), ("data",)):
        algo = FedCET(alpha=0.05, c=0.1, tau=2, n_clients=3,
                      spmd_client_axes=axes)
        st = algo.init(grad, x0, {k: v[0] for k, v in batches.items()})
        outs.append(algo.round(grad, st, batches))
    for a, b in zip(tree_leaves(outs[0]), tree_leaves(outs[1])):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
