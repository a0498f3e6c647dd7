"""Weights carried across from the reference package.

``params_from_numpy`` turns a parameter tree of numpy arrays — e.g. the
reference's params after ``jax.tree.map(np.asarray, params)`` — into the
port's tree of tensors with the same keys, nesting and layouts
(``lm_head [d, V]``, dense weights ``[d_in, d_out]``); ``state_from_numpy``
does the same for a FedCET state. Only numpy crosses the boundary, so
this module imports nothing of the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fedcet import FedCETState


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


def state_from_numpy(state, device="cpu",
                     dtype: torch.dtype | None = None) -> FedCETState:
    """A FedCET state with numpy ``x`` / ``d`` trees and a scalar ``t``
    (the reference's ``FedCETState`` after ``np.asarray`` on its leaves)."""
    return FedCETState(x=params_from_numpy(state.x, device, dtype),
                       d=params_from_numpy(state.d, device, dtype),
                       t=int(np.asarray(state.t)))
