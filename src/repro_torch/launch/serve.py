"""Serving entry point, single host (port of ``src/repro/launch/serve.py``:
``generate`` and its CLI): a batched prefill that fills the caches, then
token-by-token decode against them, for every model family.

The prefill runs every full-sequence attention through the flash-attention
kernel (``kernels/csrc/flash_attention.cu``) on the card, its plain
version on the CPU: the decoder layers of the dense, moe and vlm families
(the vlm's over its image tokens and the prompt), the hybrid's shared
block, and whisper's bidirectional encoder and causal decoder. Every
Mamba2 block's intra-chunk SSD term (the ssm and hybrid families) goes
through the SSD kernel (``kernels/csrc/ssd_intra.cu``). Decode attends one
token against the KV caches (``models/attention.py:attend_decode``) and
advances the SSM states. The prompt batch is ``input_specs.make_batch``'s:
tokens, plus ``image_embeds`` (vlm) or ``frames`` (audio). Tokens are
greedy (argmax) or sampled with ``jax.random.categorical``'s draws
(``core/prng.py``), so a run from the reference's weights and prompt emits
the reference's tokens. ``lower_prefill`` and ``lower_decode`` build the sharded steps over a
``DeviceMesh`` (``LoweredServe``): the placements of every input, from the
partition rules, and the activation layouts. ``.trace()`` runs the step
on fake local shards in a fake process group (``launch/dryrun.py``);
``.run()`` runs it on real DTensors. Their layouts, as the reference's
(decided in ``partition.cache_shardings``):

  * prefill_32k / decode_32k: request batch over the ("pod","data") axes,
    KV-cache sequence (or SSM heads) over "model";
  * long_500k: batch 1, the cache sequence dim absorbs ALL mesh axes.

Run as a script:
    python -m repro_torch.launch.serve --arch fedlm-100m --full \\
        --prompt-len 2048 --gen-len 64 --batch 4
    python -m repro_torch.launch.serve --arch qwen3-1.7b --full \\
        --prompt-len 8192 --gen-len 32 --batch 1
    python -m repro_torch.launch.serve --arch zamba2-1.2b --full \\
        --prompt-len 8192 --gen-len 32 --batch 1
    python -m repro_torch.launch.serve --arch whisper-small --full \\
        --prompt-len 64 --gen-len 64 --batch 4
    python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \\
        --prompt-len 32 --gen-len 8 --batch 2 --device cpu
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Any

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES, ArchConfig
from repro_torch.core import prng
from repro_torch.launch import input_specs as ispec
from repro_torch.launch import partition
from repro_torch.launch.mesh import axis_size, client_axes, tp_size
from repro_torch.launch.overrides import distribution_for
from repro_torch.models import build_model
from repro_torch.roofline.comm_count import (CollectiveCounter,
                                             _defer_to_subclass)
from repro_torch.utils.sharding_ctx import (activation_sharding,
                                            resolve_partial)


def cache_len(cfg, prompt_len: int, gen_len: int) -> int:
    """Positions a serving cache must hold: the prompt and the generated
    tokens, after the image tokens for the vlm family."""
    extra = cfg.n_modal_tokens if cfg.family == "vlm" else 0
    return prompt_len + gen_len + extra


def generate_tokens(model, params, batch: dict, *, gen_len: int,
                    greedy: bool = True, seed: int = 0) -> torch.Tensor:
    """The generation loop of :func:`generate` for given weights and
    prompt: prefill ``batch`` (``tokens [B, S]``, and ``image_embeds`` or
    ``frames``) into caches of :func:`cache_len` positions, then
    ``gen_len`` decode steps. The first token is the
    prefill's argmax; each next one the argmax (``greedy``) or a
    categorical draw under key ``seed + 2``, split once per step, as the
    reference draws. Returns int32 ``[B, gen_len]`` on the tokens' device."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    caches = model.init_caches(B, cache_len(model.cfg, S, gen_len),
                               device=tokens.device)
    key = prng.key(seed + 2)
    out = []
    with torch.no_grad():
        logits, caches = model.prefill(params, batch, caches)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        for _ in range(gen_len):
            out.append(tok)
            logits, caches = model.decode_step(params, tok, caches)
            if greedy:
                tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            else:
                key, k = prng.split(key)
                tok = prng.categorical(k, logits[:, -1])[:, None].to(
                    torch.int32)
    return torch.cat(out, dim=1)


def generate(arch: str, *, prompt_len: int = 32, gen_len: int = 32,
             batch: int = 2, reduced: bool = True, seed: int = 0,
             greedy: bool = True, device=None) -> torch.Tensor:
    """Generate ``gen_len`` tokens for ``batch`` random prompts of
    ``prompt_len`` tokens (the reference's prompt: ``make_batch`` under key
    ``seed + 1``) from random weights drawn from ``seed`` (the port's own
    draws). Runs on the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device=device)
    prompt = ispec.make_batch(cfg, batch, prompt_len, key=seed + 1,
                              device=device)
    return generate_tokens(model, params, prompt, gen_len=gen_len,
                           greedy=greedy, seed=seed)


# ---------------------------------------------------------- sharded steps
def _serve_cfg(arch: str, dtype: str = "bfloat16") -> ArchConfig:
    return get_config(arch).with_dtype(dtype)


def _batch_axes(mesh, batch: int):
    ca = client_axes(mesh)
    size = 1
    for a in ca:
        size *= axis_size(mesh, a)
    return ca if batch % size == 0 and batch >= size else None


def abstract_serve_state(cfg: ArchConfig, batch: int, seq_len: int):
    """(model, params, caches) with every tensor on the ``meta`` device:
    the shapes and dtypes of the full tree, nothing allocated."""
    model = build_model(cfg)
    params = model.init(torch.Generator(), device="meta")
    # VLM caches must also hold the image-token prefix.
    cap = seq_len + (cfg.n_modal_tokens if cfg.family == "vlm" else 0)
    caches = model.init_caches(batch, cap, device="meta")
    return model, params, caches


def _moe_ctx(cfg: ArchConfig, mesh, batch: int, *, seq_sharded: bool):
    """Token-sharded MoE dispatch when experts don't divide the model axis
    (see models/moe.py). Serving tokens are sharded over BOTH the data
    axes (batch) and, at prefill, the model axis (sequence), so the
    dispatch runs over the full device grid."""
    tp = tp_size(mesh)
    if not (cfg.n_experts and cfg.n_experts % tp):
        return None
    ca = client_axes(mesh)
    dp = 1
    for a in ca:
        dp *= axis_size(mesh, a)
    if not (batch % dp == 0 and batch >= dp):
        return None
    ns = tp if seq_sharded else 1
    grid_axes = (ca + ("model",)) if seq_sharded else ca
    return {"nb": dp, "ns": ns, "axes": grid_axes,
            "spec": (grid_axes if len(grid_axes) > 1 else grid_axes[0],
                     None, None)}


class _LiveBytes(TorchDispatchMode):
    """The peak bytes of the storages a step creates and holds at once, on
    this rank: its local shards in ``fake_mode``, the step's arguments not
    counted (nor the global-shape stand-ins DTensor's sharding propagation
    makes in a fake mode of its own)."""

    def __init__(self, args, fake_mode):
        super().__init__()
        self._mode = fake_mode
        self._arg_keys = {_storage_key(t) for t in _locals(args)}
        self._live: dict[int, tuple[StorageWeakRef, int]] = {}
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _defer_to_subclass(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        for key in [k for k, (ref, _) in self._live.items() if ref.expired()]:
            del self._live[key]
        for t in _locals(out):
            key = _storage_key(t)
            # a key is a storage's address: a live one is a view's storage,
            # an expired one's address may be taken by a new storage
            if getattr(t, "fake_mode", None) is self._mode and \
                    key not in self._arg_keys and key not in self._live:
                st = t.untyped_storage()
                self._live[key] = (StorageWeakRef(st), st.nbytes())
        self.peak = max(self.peak, sum(b for _, b in self._live.values()))
        return out


def _locals(tree):
    from torch.distributed.tensor import DTensor

    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            yield t


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


@dataclasses.dataclass
class LoweredServe:
    """One serving step over a mesh: ``model.prefill`` or
    ``model.decode_step``, the ``meta`` trees of its arguments, their
    specs (``partition.tree_shardings``, ``cache_shardings``,
    ``batch_shardings``) and the activation layouts it runs under."""

    kind: str                 # "prefill" | "decode"
    cfg: ArchConfig
    model: Any
    mesh: Any
    abstract: tuple           # (params, batch or token, caches) on meta
    specs: tuple              # their spec trees
    residual: tuple
    logits: tuple | None
    moe: dict | None

    def _step(self, params, inputs, caches):
        # the model's own constants (positions, masks) are plain tensors:
        # they enter as replicated
        from torch.distributed.tensor.experimental import implicit_replication

        with activation_sharding(residual=self.residual, logits=self.logits,
                                 moe_shards=self.moe), torch.no_grad(), \
                implicit_replication():
            if self.kind == "prefill":
                out = self.model.prefill(params, inputs, caches)
            else:
                out = self.model.decode_step(params, inputs, caches)
            # the step's results are values: pending sums are reduced
            return tree_map(resolve_partial, out)

    def trace(self) -> dict:
        """Run the step on fake local shards (a fake process group, no
        device): ``memory`` as argument, temp (the peak of live storages)
        and output bytes per device, and ``collectives``, the counter's
        summary."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        fm = FakeTensorMode(allow_non_fake_inputs=True)
        args = tuple(partition.distribute(t, s, self.mesh, fm)
                     for t, s in zip(self.abstract, self.specs))
        # storages die by reference count alone while the step runs, so the
        # peak does not depend on when the cycle collector happens to run
        gc.collect()
        gc.disable()
        try:
            with CollectiveCounter() as cc, _LiveBytes(args, fm) as live:
                out = self._step(*args)
        finally:
            gc.enable()
        return {"memory": {"argument_bytes": partition.local_bytes(args),
                           "temp_bytes": int(live.peak),
                           "output_bytes": partition.local_bytes(out)},
                "collectives": cc.collective_summary()}

    def run(self, params, inputs, caches):
        """Run the step for real: the trees (tensors, or DTensors such as
        a previous step's caches) are distributed with the placements of
        the specs, and the step's outputs come back as DTensors with the
        counter's summary: ``(out, collectives)``."""
        args = tuple(partition.distribute(t, s, self.mesh)
                     for t, s in zip((params, inputs, caches), self.specs))
        with CollectiveCounter() as cc:
            out = self._step(*args)
        return out, cc.collective_summary()


def _lower(kind: str, arch: str, mesh, shape_name: str, dtype: str,
           cfg: ArchConfig | None) -> LoweredServe:
    cfg = cfg or _serve_cfg(arch, dtype)
    shp = INPUT_SHAPES[shape_name]
    model, params, caches = abstract_serve_state(cfg, shp.global_batch,
                                                 shp.seq_len)
    tp = tp_size(mesh)
    wide = "data" if distribution_for(arch).serve_wide else None
    p_sh = partition.tree_shardings(params, mesh, tp, extra_axis=wide)
    c_sh = partition.cache_shardings(caches, mesh, batch=shp.global_batch)
    ba = _batch_axes(mesh, shp.global_batch)
    if kind == "decode":
        inputs = torch.empty((shp.global_batch, 1), dtype=torch.int32,
                             device="meta")
        in_sh = partition.batch_shardings(inputs, mesh, dim_axes=(ba,))
        # decode residual is [B, 1, d]: shard d_model (seq dim is 1).
        # Decode processes one token per request: the token-sharded
        # dispatch's per-layer weight gather would dominate, so decode
        # keeps the plain dispatch.
        return LoweredServe("decode", cfg, model, mesh,
                            (params, inputs, caches), (p_sh, in_sh, c_sh),
                            residual=(None, None, "model"), logits=None,
                            moe=None)
    inputs = {name: torch.empty(shape, dtype=dt, device="meta")
              for name, (shape, dt) in ispec.batch_shapes(
                  cfg, shp.global_batch, shp.seq_len).items()}
    in_sh = partition.batch_shardings(inputs, mesh, dim_axes=(ba,))
    moe = _moe_ctx(cfg, mesh, shp.global_batch, seq_sharded=True)
    return LoweredServe("prefill", cfg, model, mesh,
                        (params, inputs, caches), (p_sh, in_sh, c_sh),
                        residual=(None, "model", None),
                        logits=(None, None, "model"), moe=moe)


def lower_decode(arch: str, mesh, *, shape_name: str = "decode_32k",
                 dtype: str = "bfloat16",
                 cfg: ArchConfig | None = None) -> LoweredServe:
    """One-token decode step with a seq_len-deep cache (the decode
    shapes). ``cfg`` replaces the registered config (a path's own)."""
    return _lower("decode", arch, mesh, shape_name, dtype, cfg)


def lower_prefill(arch: str, mesh, *, shape_name: str = "prefill_32k",
                  dtype: str = "bfloat16",
                  cfg: ArchConfig | None = None) -> LoweredServe:
    """Full-prompt prefill populating the cache (the prefill shapes)."""
    return _lower("prefill", arch, mesh, shape_name, dtype, cfg)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--full", action="store_true",
                    help="the full-width config (default: reduced())")
    ap.add_argument("--device", default=None,
                    help="cpu to run without a card (default: cuda)")
    a = ap.parse_args(argv)
    out = generate(a.arch, prompt_len=a.prompt_len, gen_len=a.gen_len,
                   batch=a.batch, reduced=not a.full, device=a.device)
    print("generated token ids:")
    print(out)


if __name__ == "__main__":
    main()
