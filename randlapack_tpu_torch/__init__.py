"""randlapack_tpu_torch — the PyTorch/CUDA port of randlapack_tpu.

Same layout, names and ``(…, state) → (…, next_state)`` contract as the
JAX package, which stays the reference. Plain tensor code is PyTorch;
each Pallas TPU kernel on a ported path is a hand-written CUDA kernel for
Hopper (``csrc/``), built with ``nvcc`` on first use. A CUDA tensor goes
through the kernels, a CPU tensor through their plain PyTorch versions.

Ported so far: the factored BQRRP path (``drivers.bqrrp_factored``,
``bqrrp_q``, ``bqrrp_apply_qt``), HQRRP (``drivers.hqrrp``,
``hqrrp_lapack_format``), KRILL (``drivers.krill_full_rpchol``,
``krill_restricted_rpchol`` over ``pdkernels``, ``linops`` and ``comps``),
the fused Gaussian sketch (``ops.gaussian_sketch``), the tall QR drivers
(``drivers.cqrrpt``, ``cqrrt``, ``bqrrp``), the low-rank drivers
(``drivers.rsvd_fixed_rank``, ``rsvd``, ``revd2_fixed_rank``, ``revd2``
over ``comps``' orth, RS, RF, QB, SYPS and SYRF), the operator slice
(``linops``' dense, sparse and composite operators and the CSR/CSC
views, ``sketching``'s dense sketches, sided application and sparse
formats, the generators of ``gen``, ``extras.io``, ABRIK through
``drivers.abrik`` and the Q-less CholQR family over operators,
``drivers.cholqr_linops``, ``scholqr3_linops``, ``cqrrt_linops``), least
squares (``drivers.spls`` over ``comps.lsqr`` and the sketch
preconditioners), the solver operators and native Matrix Market IO of
``extras``, the memory and profiling utilities, ``testing`` and what
they run; the distributed layer ``parallel`` (meshes of ranks of a
``torch.distributed`` group, the distributed CholQR, sketch and
rangefinder, the row-sharded drivers and ``dist_bqrrp_factored``).
"""
import time as _time

_import_start_ns = _time.perf_counter_ns()

from .rng import RNGState, as_state  # noqa: E402
from . import (comps, config, drivers, extras, gen, interop,  # noqa: E402
               linops, ops, parallel, pdkernels, sketching, testing, utils)

# the package's import, the first of the set-up spans (utils.timing)
utils.timing.add_setup_span("setup.import", _import_start_ns,
                            _time.perf_counter_ns())

__version__ = "0.1.0"
__all__ = ["RNGState", "as_state", "comps", "config", "drivers", "extras",
           "gen",
           "interop", "linops", "ops", "parallel", "pdkernels", "sketching",
           "testing",
           "utils",
           "__version__"]
