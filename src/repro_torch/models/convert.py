"""Weights and algorithm states carried across from the reference package.

``params_from_numpy`` turns a parameter tree of numpy arrays (e.g. the
reference's params after ``jax.tree.map(np.asarray, params)``) into the
port's tree of tensors with the same keys, nesting and layouts
(``lm_head [d, V]``, dense weights ``[d_in, d_out]``), for every family:
the MoE's stacked experts ``[E, d, d_ff]``, the hybrid's grouped Mamba
stacks ``[G, every, ...]`` (or nested lists) and its ``shared_attn``
block, the encoder-decoder's ``encoder`` / ``decoder`` / ``enc_norm``. ``state_from_numpy``
does the same for an algorithm state: FedCET's (both forms), NIDS's and
every baseline's (FedAvg, SCAFFOLD, FedLin / FedTrack, FedProx, FedDyn),
matched by the state class's name, with the step counter ``t`` as a
Python int. Only numpy crosses the boundary, so this module imports
nothing of the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.baselines import (FedAvgState, FedDynState,
                                        FedLinState, FedProxState, NIDSState,
                                        ScaffoldState)
from repro_torch.core.fedcet import FedCETLiteralState, FedCETState

#: the port's counterpart of each reference state class, by name.
STATES = {cls.__name__: cls for cls in (
    FedCETState, FedCETLiteralState, NIDSState, FedAvgState, ScaffoldState,
    FedLinState, FedProxState, FedDynState)}


def params_from_numpy(tree, device="cpu", dtype: torch.dtype | None = None):
    """Nested dicts / lists / tuples of numpy arrays -> the same nesting of
    contiguous tensors on ``device`` (cast to ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    t = torch.from_numpy(np.array(tree, copy=True))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device).contiguous()


def state_from_numpy(state, device="cpu", dtype: torch.dtype | None = None):
    """A reference algorithm state with numpy leaves and a scalar ``t``
    (after ``np.asarray`` on its leaves) -> the port's state of the same
    name: each tree field through :func:`params_from_numpy`, ``t`` an
    int."""
    cls = STATES[type(state).__name__]
    return cls(**{f: int(np.asarray(v)) if f == "t"
                  else params_from_numpy(v, device, dtype)
                  for f, v in zip(state._fields, state)})
