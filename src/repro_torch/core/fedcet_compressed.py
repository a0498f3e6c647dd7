"""Compressed-uplink FedCET (port of ``src/repro/core/fedcet_compressed.py``).

The transmitted vector ``v_i`` is compressed on the wire; the drift update
uses the client's own COMPRESSED message so ``d_i' - d_i`` stays mean-zero
across clients (Lemma 2), and the x-update corrects the exact local
``v_i``::

    v_bar = mean_i C(v_i);  d_i' = d_i + c (C(v_i) - v_bar)
    x_i'  = v_i - c*a*(C(v_i) - v_bar)

:func:`FedCETCompressed` is sugar for ``with_compression`` over the FedCET
spec: the ``compressor=`` form (any ``core/compressors.py`` spec or
object, ``"randk:0.25"``, ``"ef:topk:0.3+bf16"``, ``"shift:q8"``, or a
``CompressionPlan``) or the legacy ``k_frac=`` / ``quantize=`` form, the
legacy cross-client top-k + bf16 with error feedback
(``ErrorFeedbackCompression``), whose memory ``e_i`` is carried as::

    e_i <- e_i + v_i;  v_i^c = C(e_i);  e_i <- e_i - v_i^c
"""

from __future__ import annotations

from repro_torch.core.engine import (ErrorFeedbackCompression, RoundEngine,
                                     with_compression)
from repro_torch.core.fedcet import FedCET

__all__ = ["ErrorFeedbackCompression", "FedCETCompressed"]


def FedCETCompressed(alpha: float, c: float, tau: int, n_clients: int,
                     k_frac: float = 1.0, quantize: bool = False,
                     error_feedback: bool | None = None,
                     compressor=None, seed: int = 0,
                     name: str = "fedcet_c", **engine_kw) -> RoundEngine:
    """Compressed-uplink FedCET: ``with_compression`` over the FedCET spec.
    With no compressor (and the legacy knobs at identity) the result IS
    plain FedCET. ``error_feedback=None`` wraps biased compressors only;
    the legacy form defaults to feedback on."""
    base = FedCET(alpha=alpha, c=c, tau=tau, n_clients=n_clients, name=name,
                  **engine_kw)
    return with_compression(base, k_frac=k_frac, quantize=quantize,
                            error_feedback=error_feedback,
                            compressor=compressor, seed=seed)
