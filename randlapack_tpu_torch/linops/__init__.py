"""Linear-operator protocol (counterpart of ``randlapack_tpu/linops``;
reference: RandLAPACK/linops/rl_concepts.hh:31,46). Operators are small
classes with a duck-typed surface: ``n_rows``, ``n_cols``, ``matmat(X)``,
``tmatmat(X)``, ``fro_nrm()``; symmetric operators add ``dim`` and the
per-column regularization hooks. So far the symmetric family KRILL needs."""
from .symmetric import (ExplicitSymLinOp, RegExplicitSymLinOp,
                        SpectralPrecond)

__all__ = ["ExplicitSymLinOp", "RegExplicitSymLinOp", "SpectralPrecond"]
