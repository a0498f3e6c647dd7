"""Activation checkpointing in the port (``models/remat.py``) against the
unwrapped bodies and the JAX package's ``jax.checkpoint``.

Every family at ``reduced()`` widths with stacked layers and
``remat=True`` (the reference's scanned, checkpointed layer bodies): the
loss and the ``vmap(grad)`` gradients of 2 clients equal those with
``remat=False`` bit for bit in float64, and match the reference's
``grad`` with ``remat=True``: the loss within rtol 1e-6, each gradient
leaf within 1e-5 of the tree's largest gradient (the bounds of
``tests/test_torch_train.py``, whose x and d move by alpha times these
gradients). The blockwise attention's KV blocks
and the chunked cross entropy's chunks, rematerialized always, equal
their unwrapped forms under ``torch.func.grad``, also nested in a
rematerialized layer under ``vmap(grad)``. The wrapper also runs
under plain autograd, where a four-layer toy whose activations dwarf its
parameters saves only the layer inputs, and on DTensor shards: a reduced
train cell traced on a fake 16 x 16 world holds less temp with
``remat=True``. The whole file takes ~35 s in one process (the dry-run
subprocess ~11 s of it).
"""

import dataclasses
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.core.comm import leaf_info_of
from repro_torch.models import attention as attn
from repro_torch.models import build_model, remat
from repro_torch.models.losses import chunked_ce
from repro_torch.utils.tree import tree_leaves, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = {"dense": "qwen3-1.7b", "moe": "granite-moe-3b-a800m",
            "ssm": "mamba2-130m", "hybrid": "zamba2-1.2b",
            "encdec": "whisper-small"}
N_CLIENTS, B, S = 2, 2, 16
STACKED = dict(scan_layers=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores
    (the results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def _unwrapped(monkeypatch):
    """Every ``remat.checkpoint`` site runs its body as is."""
    monkeypatch.setattr(remat, "checkpoint", lambda body: body)


def _cfg(arch, remat_on, dtype="float32"):
    return dataclasses.replace(get_config(arch).reduced(), remat=remat_on,
                               **STACKED).with_dtype(dtype)


def _inputs(arch):
    """The port's stacked reduced parameters (seed 0, float32) and
    ``N_CLIENTS`` batches on a client axis, as numpy trees."""
    cfg = _cfg(arch, True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (N_CLIENTS, B, S))}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (N_CLIENTS, B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return tree_map(lambda t: t.numpy(), params), batch


def _port_grads(arch, remat_on, params, batch, dtype):
    """The port's per-client loss and ``vmap(grad)`` gradients."""
    model = build_model(_cfg(arch, remat_on, dtype))
    dt = getattr(torch, dtype)
    stack = tree_map(lambda a: torch.from_numpy(
        np.stack([a] * N_CLIENTS)).to(dt), params)
    batch = {k: torch.from_numpy(v).to(dt if k == "frames" else None)
             for k, v in batch.items()}
    loss = torch.func.vmap(model.loss)(stack, batch)
    grads = torch.func.vmap(torch.func.grad(model.loss))(stack, batch)
    return loss, grads


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_gradients_equal_plain_and_match_the_reference(family):
    """The port's ``vmap(grad)`` of 2 clients with remat on and off, in
    float64, bit for bit; the first client's loss and gradients against
    the reference's ``grad`` with ``remat=True`` in float64. Gradient
    leaves are held within 1e-5 of the largest gradient of the tree: some
    leaves are zero but for rounding (a key bias, which the softmax
    ignores), so their own scale is noise."""
    jax = _jax()
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild

    arch = FAMILIES[family]
    params, batch = _inputs(arch)
    loss_on, g_on = _port_grads(arch, True, params, batch, "float64")
    loss_off, g_off = _port_grads(arch, False, params, batch, "float64")
    assert torch.equal(loss_on, loss_off)
    for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)):
        assert torch.equal(a, b)

    jm = jbuild(dataclasses.replace(jget(arch).reduced(), remat=True,
                                    **STACKED).with_dtype("float64"))
    jparams = jax.tree.map(lambda a: a.astype(np.float64), params)
    jbatch = {k: (v[0].astype(np.float64) if k == "frames" else v[0])
              for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jparams, jbatch)
    np.testing.assert_allclose(float(loss_on[0]), float(jloss), rtol=1e-6)
    leaves = [np.asarray(w) for w in jax.tree.leaves(jgrads)]
    got = [None] * len(leaves)
    for j, g in zip(leaf_info_of(g_on).ref_index, tree_leaves(g_on)):
        got[j] = g[0]
    scale = max(float(np.abs(w).max()) for w in leaves)
    for g, want in zip(got, leaves):
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-5 * scale)


def _grad_pair(fn, args, monkeypatch):
    """``torch.func.grad`` of ``fn`` over every argument, with the
    rematerialized bodies and then with the unwrapped ones."""
    g = torch.func.grad(fn, argnums=tuple(range(len(args))))
    with_remat = g(*args)
    _unwrapped(monkeypatch)
    return with_remat, g(*args)


@pytest.mark.parametrize("kind", ["causal", "sliding", "bidirectional"])
def test_blockwise_attention_blocks_recompute_exactly(kind, monkeypatch):
    """40 keys in blocks of 16 (a padded last block), 4 query heads on 2 KV
    heads, float64: the gradients of q, k and v equal the unwrapped loop's
    bit for bit."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.standard_normal((2, 40, h, 8)))
               for h in (4, 2, 2))
    allowed = attn.mask_fn(kind, window=12, chunk=0)

    def f(q, k, v):
        out = attn.attend_blockwise(q, k, v, allowed, block_size=16)
        return torch.sum(out * torch.sin(out))

    with_remat, plain = _grad_pair(f, (q, k, v), monkeypatch)
    for a, b in zip(with_remat, plain):
        assert torch.equal(a, b)


def test_nested_bodies_recompute_exactly(monkeypatch):
    """A rematerialized layer whose attention is the blockwise one (itself
    rematerialized block by block), as whisper's encoder layers over 1500
    frames: under ``vmap(grad)`` of 2 clients the gradients equal the
    unwrapped loops' bit for bit (the inner blocks run as they are inside
    the layer's recompute)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.standard_normal((2, 2, 40, h, 8)))
               for h in (4, 2, 2))
    w = torch.tensor(rng.standard_normal((8, 8)))
    allowed = attn.mask_fn("bidirectional")

    def f(w, q, k, v):
        def layer(w, q, k, v):
            return attn.attend_blockwise(q @ w, k, v, allowed, block_size=16)

        out = remat.checkpoint(layer)(w, q, k, v)
        return torch.sum(out * torch.sin(out))

    g = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2, 3)),
                        in_dims=(None, 0, 0, 0))
    with_remat = g(w, q, k, v)
    _unwrapped(monkeypatch)
    for a, b in zip(with_remat, g(w, q, k, v)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("prefix", [0, 3])
def test_chunked_ce_chunks_recompute_exactly(prefix, monkeypatch):
    """29 predicted tokens in chunks of 8 (a short last chunk), float64:
    the gradients of the hidden states and the head equal the unwrapped
    loop's bit for bit, and the loss the reference's within rtol 1e-6 (the
    logits are float32 in both)."""
    _jax()
    from repro.models.losses import chunked_ce as jce

    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((2, 30 + prefix, 12)))
    head = torch.tensor(rng.standard_normal((12, 50)))
    tokens = torch.tensor(rng.integers(0, 50, (2, 30)))

    def f(x, head):
        return chunked_ce(x, head, tokens, prefix=prefix, chunk=8)

    want = float(jce(x.numpy(), head.numpy(), tokens.numpy(), prefix=prefix,
                     chunk=8))
    np.testing.assert_allclose(float(f(x, head)), want, rtol=1e-6)
    with_remat, plain = _grad_pair(f, (x, head), monkeypatch)
    for a, b in zip(with_remat, plain):
        assert torch.equal(a, b)


class _LivePeak(TorchDispatchMode):
    """The peak bytes of the storages created under it and alive at once
    (a finalizer on each storage), whatever transform wraps the ops."""

    def __init__(self):
        super().__init__()
        self.live, self.total, self.peak = {}, 0, 0

    def _free(self, key):
        self.total -= self.live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st._cdata not in self.live:
                    self.live[st._cdata] = st.nbytes()
                    self.total += st.nbytes()
                    weakref.finalize(st, self._free, st._cdata).atexit = False
        self.peak = max(self.peak, self.total)
        return out


@pytest.mark.parametrize("how", ["autograd", "vmap_grad"])
def test_four_layer_toy_saves_only_the_layer_inputs(how):
    """Four layers of ``x + tanh(x W1) W2`` on a 512 x 16 activation
    widened to 512 x 1024 (a 4 MB "wide" tensor in float64 against 256 KB
    of weights a layer); the gradients with and without remat are bitwise
    equal.

    * ``autograd``: plain ``torch.autograd.grad``, the saved tensors seen
      by ``saved_tensors_hooks``. Without remat autograd saves a wide
      tensor in every layer (``tanh``'s output, which the second product
      shares): >= 4 wide. With remat the Function saves each layer's
      input and weights only: 4 x (64 KB + 256 KB) + 64 KB.
    * ``vmap_grad``: ``vmap(grad)`` over 2 clients (the engine's form),
      the peak of live storages. Without remat every layer's wide
      activations stay until the backward reaches them: >= 2 x 4 wide
      (measured 12.6). With remat one layer's recompute at a time: <= 4
      wide (measured 3.5). ``torch.func``'s backward records its own graph
      (for a second derivative), so a recompute whose vjp were recorded
      would stay alive to the end and hold as much as no remat at all."""
    rng = np.random.default_rng(2)
    clients = 2 if how == "vmap_grad" else 1
    x = torch.tensor(rng.standard_normal((clients, 512, 16)))
    ws = [torch.tensor(rng.standard_normal((4, 16, 1024)) / 4),
          torch.tensor(rng.standard_normal((4, 1024, 16)) / 32)]
    wide = clients * 512 * 1024 * 8

    def layer(w1, w2, x):
        return x + torch.tanh(x @ w1) @ w2

    def loss(w1, w2, x, on):
        body = remat.checkpoint(layer) if on else layer
        for i in range(4):
            x = body(w1[i], w2[i], x)
        return torch.sum(x * x)

    def run(on):
        if how == "vmap_grad":
            with _LivePeak() as live:
                grads = torch.func.vmap(torch.func.grad(loss, (0, 1)),
                                        in_dims=(None, None, 0, None))(
                    *ws, x, on)
            return live.peak, grads
        params = [w.clone().requires_grad_(True) for w in ws]
        seen = {}

        def pack(t):
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = loss(*params, x[0], on)
        return sum(seen.values()), torch.autograd.grad(out, params)

    held_on, g_on = run(True)
    held_off, g_off = run(False)
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)
    if how == "vmap_grad":
        assert held_off >= 8 * wide and held_on <= 4 * wide, (held_on,
                                                             held_off)
    else:
        act, weights = 512 * 16 * 8, 2 * 16 * 1024 * 8
        assert held_off >= 4 * wide
        assert held_on <= 4 * (act + weights) + act


TRAIN_CELLS = r"""
import dataclasses, json
import torch
import repro_torch.configs as C
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world

# qwen3 reduced with stacked layers, train_4k as 64 tokens x 16 clients;
# one thread: the suite runs several workers on few cores
torch.set_num_threads(1)
INPUT_SHAPES["train_4k"] = ShapeConfig("train_4k", 64, 16, "train")
base = get_config("qwen3-1.7b").reduced()
temp = {}
with fake_world(256):
    for on in (False, True):
        C._REGISTRY["qwen3-1.7b"] = dataclasses.replace(
            base, name="qwen3-1.7b", scan_layers=True, remat=on)
        rec = dryrun.run_one("qwen3-1.7b", "train_4k", multi_pod=False,
                             verbose=False)
        assert rec["status"] == "ok", rec
        temp[on] = rec["memory"]["temp_bytes"]
print("REMAT_TEMP", json.dumps(temp))
"""


def test_reduced_train_cell_holds_less_temp_with_remat():
    """The lowered step's per-client ``torch.autograd.grad`` on DTensor
    shards (fake local shards, a fake 256-rank world), traced with and
    without remat: the recompute runs there (the trace would fail
    otherwise) and the peak of live storages falls (measured 1.71 MB ->
    1.25 MB)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", TRAIN_CELLS],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [s for s in res.stdout.splitlines() if s.startswith("REMAT_TEMP")]
    import json

    temp = json.loads(line[0].split(" ", 1)[1])
    assert 0 < temp["true"] < temp["false"], temp
