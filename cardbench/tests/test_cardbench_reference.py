"""The plain reference at a small size on the CPU: it forms the program's
Q from the reflectors as the program does, passes a sound factorization,
refuses wrong ones, and reads the pivots' distance from greedy column
pivoting; and the inputs it is handed repeat from the seed."""
import hashlib

import numpy as np
import pytest
import scipy.linalg
import torch

from cardbench import harness, inputs, reference
from randlapack_tpu_torch import RNGState
from randlapack_tpu_torch.drivers import (HQRRPConfig, hqrrp,
                                          hqrrp_lapack_format)

LIMITS = harness.workload("square16384.hqrrp")["limits"]
QR = ("residual", "permutation", "below_diagonal", "fail")
B = 32


@pytest.fixture(scope="module")
def small():
    A = inputs.fast_decay(256, 256, 6.0, 11, "cpu")
    packed, taus, R, J, _ = hqrrp_lapack_format(A, HQRRPConfig(block_size=B),
                                                RNGState(1))
    return A, packed, taus, R, J


def numbers(A, packed, taus, R, J, fail=False):
    nums = reference.qr_numbers(A, J, reference.q_from_householder(packed,
                                                                   taus),
                                R, fail)
    nums.update(reference.pivot_numbers(R, B))
    return nums


def test_q_from_householder_is_the_programs_q():
    A = inputs.fast_decay(200, 160, 6.0, 12, "cpu", dtype=torch.float64)
    cfg = HQRRPConfig(block_size=32)
    packed, taus, R, J, _ = hqrrp_lapack_format(A, cfg, RNGState(2))
    Q, R2, J2, *_ = hqrrp(A, cfg, RNGState(2))
    assert torch.equal(J, J2)
    assert torch.allclose(reference.q_from_householder(packed, taus), Q,
                          atol=1e-12)


def test_sound_factorization_passes(small):
    nums = numbers(*small)
    assert [k for k in QR if not nums[k] <= LIMITS[k]] == [], nums
    assert 0.0 <= nums["panel_order"] < 1e-4, nums


@pytest.mark.parametrize("what", ["R scaled", "J swapped", "J repeated",
                                  "tau scaled", "R not triangular",
                                  "fail raised"])
def test_wrong_factorization_is_refused(small, what):
    A, packed, taus, R, J = (t.clone() for t in small)
    fail = False
    if what == "R scaled":
        R[3] *= 1.01
    elif what == "J swapped":
        J[[0, 5]] = J[[5, 0]]
    elif what == "J repeated":
        J[1] = J[0]
    elif what == "tau scaled":
        taus[0] *= 1.001
    elif what == "R not triangular":
        R[10, 2] = 1e-3
    elif what == "fail raised":
        fail = True
    nums = numbers(A, packed, taus, R, J, fail)
    assert [k for k in QR if not nums[k] <= LIMITS[k]], (what, nums)


def test_pivot_numbers_read_greedy_as_zero():
    """Greedy column pivoting (LAPACK's geqp3) reads 0 to rounding on
    both; the columns in their given order read a gap, and a panel whose
    columns are put in another order reads ``panel_order``."""
    A = inputs.fast_decay(256, 256, 6.0, 13, "cpu", dtype=torch.float64)
    _, Rg, _ = scipy.linalg.qr(A.numpy(), mode="economic", pivoting=True)
    Rg = torch.from_numpy(np.ascontiguousarray(Rg))
    greedy = reference.pivot_numbers(Rg, B)
    assert greedy["pivot_gap"] == pytest.approx(0.0, abs=1e-12)
    assert greedy["panel_order"] == pytest.approx(0.0, abs=1e-12)
    plain = reference.pivot_numbers(torch.linalg.qr(A).R, B)
    assert plain["pivot_gap"] > 0.05 and plain["panel_order"] > 0.05
    # the first panel's columns reversed, then factored again
    order = torch.cat([torch.arange(B - 1, -1, -1), torch.arange(B, 256)])
    swapped = reference.pivot_numbers(torch.linalg.qr(Rg[:, order]).R, B)
    assert swapped["panel_order"] > 0.05


def test_permutation_errors():
    assert reference.permutation_errors(torch.arange(5), 5) == 0
    assert reference.permutation_errors(torch.tensor([0, 0, 2, 3, 4]), 5) == 1
    assert reference.permutation_errors(torch.arange(4), 5) == 5
    assert reference.permutation_errors(torch.tensor([0, 1, 2, 3, 9]), 5) == 5


def test_inputs_repeat_from_the_seed():
    big = 2**40 + 3
    a = inputs.fast_decay(64, 48, 6.0, big, "cpu")
    assert torch.equal(a, inputs.fast_decay(64, 48, 6.0, big, "cpu"))
    assert not torch.equal(a, inputs.fast_decay(64, 48, 6.0, big + 1, "cpu"))


# inputs.make's matrix of each configuration at its CPU shape (the cells'
# cut, cells/*.json) for seed 2**31 + 977: the SHA-256 of its bytes, read
# before makers could be files; the fast_decay path has to give the same
# bits (the same draws in the same order, the same column order)
PINNED = {"square16384_f32": ([384, 384], "98e0223d51089ce2ea79bae48d5dca77"
                              "249d69b3daa0ca7aa81bb67f421ba6fa"),
          "tall131072x2048_f32": ([4096, 128], "b337bb23bc1b17de8bb544fb0ce"
                                  "f0d39f0bb49573b42f356493e6a7090216c59")}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_inputs_match_the_pinned_bits(name):
    shape, digest = PINNED[name]
    A = inputs.make({**harness.config(name), "shape": shape}, 2**31 + 977,
                    "cpu")
    assert A.dtype == torch.float32 and list(A.shape) == shape
    assert hashlib.sha256(A.contiguous().numpy().tobytes()).hexdigest() == \
        digest
