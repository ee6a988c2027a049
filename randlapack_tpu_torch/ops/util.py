"""Matrix utilities (counterpart of ``randlapack_tpu/ops/util.py``;
reference: RandLAPACK/misc/rl_util.hh and RandBLAS's small utilities):
triangles, permutations, norms, rank and condition checks, and the
buffer-layout helpers, which on tensors reduce to views and copies.
Scalar results are 0-d tensors on the input's device (no host sync)."""
from __future__ import annotations

import ctypes

import torch

from ..config import STABLE_PRECISION, resolve_precision
from ..errors import require


def is_batched(*ts) -> bool:
    """Whether any of the tensors is a ``torch.func.vmap`` batched tensor.
    A host branch on a batched value cannot be read: where this holds, a
    driver computes both branches and selects on the device."""
    return any(isinstance(t, torch.Tensor)
               and torch._C._functorch.is_batchedtensor(t) for t in ts)


def require_kernel_operands(what: str, *ts) -> None:
    """Raise for operands a ctypes call cannot take: a tensor under
    ``torch.func.vmap`` (the hand-written kernels and the TF32 product
    have no batching rule) or one autograd would have to differentiate
    through (they have no backward; a silently detached result would be a
    wrong gradient)."""
    ts = [t for t in ts if isinstance(t, torch.Tensor)]
    require(not is_batched(*ts),
            f"{what}: torch.func.vmap over a CUDA tensor is not supported: "
            "the hand-written kernels have no batching rule")
    require(not (torch.is_grad_enabled()
                 and any(t.requires_grad for t in ts)),
            f"{what}: autograd through a hand-written kernel is not "
            "supported: call with tensors that do not require grad, or on "
            "the CPU")


# cuBLAS enums (cublas_api.h, library_types.h)
_CUDA_R_32F = 0
_CUBLAS_COMPUTE_32F_FAST_TF32 = 77
_CUBLAS_GEMM_DEFAULT_TENSOR_OP = 99
_CUBLAS = []


def _cublas():
    """The cuBLAS library PyTorch has loaded (found by its path in
    /proc/self/maps, so the handle PyTorch hands out and the calls share
    one library)."""
    if not _CUBLAS:
        torch.cuda.current_blas_handle()        # loads cuBLAS
        with open("/proc/self/maps") as f:
            paths = sorted({ln.split()[-1] for ln in f
                            if "/libcublas.so" in ln})
        require(bool(paths), "cuBLAS is not loaded in this process")
        lib = ctypes.CDLL(paths[0])
        lib.cublasGemmEx.restype = ctypes.c_int
        _CUBLAS.append(lib)
    return _CUBLAS[0]


def _colmajor(T: torch.Tensor):
    """(tensor, op, ld) for cuBLAS: T as stored column-major, and whether
    cuBLAS must transpose it to read Tᵀ (the row-major T)."""
    r, c = T.shape
    if T.stride(1) == 1 and T.stride(0) >= max(1, c):
        return T, 0, T.stride(0)                # row-major T = col-major Tᵀ
    if T.stride(0) == 1 and T.stride(1) >= max(1, r):
        return T, 1, T.stride(1)                # col-major T: transpose it
    T = T.contiguous()
    return T, 0, max(1, c)


def tf32_mm(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """X·Y for 2-D CUDA f32 X, Y with TF32 inputs and fp32 accumulation,
    one ``cublasGemmEx`` call with ``CUBLAS_COMPUTE_32F_FAST_TF32`` on
    PyTorch's handle and stream: the TF32 product of this call only,
    with no process-wide switch touched."""
    require(X.dim() == 2 and Y.dim() == 2 and X.shape[1] == Y.shape[0],
            f"tf32_mm needs (m, k)·(k, n), got {tuple(X.shape)}·"
            f"{tuple(Y.shape)}")
    require_kernel_operands("tf32_mm", X, Y)
    m, k = X.shape
    n = Y.shape[1]
    C = torch.empty((m, n), dtype=torch.float32, device=X.device)
    if m == 0 or n == 0:
        return C
    if k == 0:
        return C.zero_()
    # row-major C = X·Y is col-major Cᵀ = Yᵀ·Xᵀ
    Yc, opa, lda = _colmajor(Y)
    Xc, opb, ldb = _colmajor(X)
    one, zero = ctypes.c_float(1.0), ctypes.c_float(0.0)
    st = _cublas().cublasGemmEx(
        ctypes.c_void_p(torch.cuda.current_blas_handle()),
        ctypes.c_int(opa), ctypes.c_int(opb), ctypes.c_int(n),
        ctypes.c_int(m), ctypes.c_int(k), ctypes.byref(one),
        ctypes.c_void_p(Yc.data_ptr()), ctypes.c_int(_CUDA_R_32F),
        ctypes.c_int(lda), ctypes.c_void_p(Xc.data_ptr()),
        ctypes.c_int(_CUDA_R_32F), ctypes.c_int(ldb), ctypes.byref(zero),
        ctypes.c_void_p(C.data_ptr()), ctypes.c_int(_CUDA_R_32F),
        ctypes.c_int(n), ctypes.c_int(_CUBLAS_COMPUTE_32F_FAST_TF32),
        ctypes.c_int(_CUBLAS_GEMM_DEFAULT_TENSOR_OP))
    require(st == 0, f"cublasGemmEx returned status {st}")
    return C


def bf16_mm(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """X·Y for 2-D CUDA f32 X, Y with bf16 inputs (round to nearest even)
    and fp32 accumulation: one bf16 cuBLAS product into fp32."""
    return torch.mm(X.to(torch.bfloat16), Y.to(torch.bfloat16),
                    out_dtype=torch.float32)


def product_form(precision, t: torch.Tensor) -> str:
    """What a product at ``precision`` computes for the tensor ``t``:
    "highest" (the plain ``@``) on the CPU, in f64 and at "highest";
    "high" (TF32) or "default" (bf16) for a CUDA f32 tensor."""
    p = resolve_precision(precision)
    if t.device.type != "cuda" or t.dtype != torch.float32:
        return "highest"
    return p


def matmul(X: torch.Tensor, Y: torch.Tensor,
           precision=STABLE_PRECISION) -> torch.Tensor:
    """X @ Y at a JAX precision (``config.resolve_precision``): the port's
    ``jnp.matmul(X, Y, precision=precision)``. On the CPU, and in f64 on
    any device, every precision is the plain ``@`` (XLA's CPU dot ignores
    ``precision``, and f64 has no TF32 or bf16 form). On a CUDA f32
    tensor "highest" is ``@`` (true fp32), "high" one TF32 product
    (``tf32_mm``) and "default" one bf16 product (``bf16_mm``), both with
    fp32 accumulation: the mapping of ``ops.wy.trailing_form``. A vector
    operand is taken as one column (Y) or one row (X)."""
    p = product_form(precision, X)
    if p == "highest" or Y.dtype != torch.float32:
        return X @ Y
    require(X.dim() <= 2 and Y.dim() <= 2,
            f"matmul at precision {p!r} takes matrices and vectors, got "
            f"{X.dim()}-d and {Y.dim()}-d")
    X2 = X.unsqueeze(0) if X.dim() == 1 else X
    Y2 = Y.unsqueeze(1) if Y.dim() == 1 else Y
    C = tf32_mm(X2, Y2) if p == "high" else bf16_mm(X2, Y2)
    if X.dim() == 1:
        C = C.squeeze(0)
    if Y.dim() == 1:
        C = C.squeeze(-1)
    return C


def eye(m: int, n: int, dtype=torch.float32, device="cuda") -> torch.Tensor:
    return torch.eye(m, n, dtype=dtype, device=device)


def get_U(A: torch.Tensor, k: int = 0) -> torch.Tensor:
    """Upper triangle from diagonal ``k`` (rl_util.hh:120)."""
    return torch.triu(A, k)


def get_L(A: torch.Tensor, unit_diag: bool = False) -> torch.Tensor:
    """Lower triangle, optionally with a unit diagonal (rl_util.hh:102)."""
    L = torch.tril(A)
    if unit_diag:
        L.diagonal().fill_(1.0)
    return L


def col_swap(A: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
    """Column permutation A[:, J] — the reference's lapmt-backed col_swap
    (rl_util.hh:152) as a gather."""
    return A.index_select(1, J)


def row_swap(A: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
    """Row permutation A[J, :] as a gather."""
    return A.index_select(0, J)


def compose_pivots(J_outer: torch.Tensor,
                   J_inner: torch.Tensor) -> torch.Tensor:
    """Pivot composition: applying J_inner after J_outer equals
    J_outer[J_inner]."""
    return J_outer.index_select(0, J_inner)


def invert_pivots(J: torch.Tensor) -> torch.Tensor:
    """Inverse permutation."""
    inv = torch.empty_like(J)
    inv[J] = torch.arange(J.shape[0], dtype=J.dtype, device=J.device)
    return inv


def naive_rank_est(diag_R: torch.Tensor, tol) -> torch.Tensor:
    """Largest k such that |R[i,i]| > tol for all i < k
    (reference: rl_cqrrpt.hh:267-272). Returns an int32 scalar tensor on
    diag_R's device (no host sync)."""
    ok = (diag_R.abs() > tol).to(torch.int32)
    return torch.cumprod(ok, 0).sum().to(torch.int32)


def orthogonality_check(Q: torch.Tensor,
                        precision=STABLE_PRECISION) -> torch.Tensor:
    """‖QᵀQ − I‖_F (rl_util.hh:468), a 0-d tensor on Q's device; QᵀQ at
    ``precision`` (``matmul``)."""
    k = Q.shape[1]
    G = matmul(Q.T, Q, precision)
    return torch.linalg.matrix_norm(
        G - torch.eye(k, dtype=Q.dtype, device=Q.device))


def normc(A: torch.Tensor) -> torch.Tensor:
    """Column-normalized copy; zero columns stay zero (rl_util.hh:254)."""
    nrm = torch.linalg.vector_norm(A, dim=0, keepdim=True)
    return A / torch.where(nrm > 0, nrm, torch.ones_like(nrm))


def cond_num_check(A: torch.Tensor) -> torch.Tensor:
    """2-norm condition number from the singular values (rl_util.hh:403)."""
    s = torch.linalg.svdvals(A)
    return s[0] / s[-1]


def rank_check(A: torch.Tensor, rel_tol: float = 1e-12) -> torch.Tensor:
    """Numerical rank: singular values above rel_tol·σ₁, int32
    (rl_util.hh:427)."""
    s = torch.linalg.svdvals(A)
    return (s > rel_tol * s[0]).sum().to(torch.int32)


def fro_norm(A: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(A)


def diag_is_nonzero(A: torch.Tensor, tol=0.0) -> torch.Tensor:
    """Whether every diagonal entry exceeds ``tol`` in magnitude
    (rl_util.hh:138)."""
    return (torch.diagonal(A).abs() > tol).all()


def rank_search_binary(singvals: torch.Tensor, tol) -> torch.Tensor:
    """How many singular values exceed ``tol`` (rl_util.hh:223's answer,
    counted instead of searched), int32."""
    return (singvals > tol).sum().to(torch.int32)


def symmetrize(A: torch.Tensor, uplo: str = "upper") -> torch.Tensor:
    """Copy one triangle onto the other (RandBLAS ``symmetrize``);
    ``uplo`` names the triangle holding the data."""
    if uplo == "upper":
        return torch.triu(A) + torch.triu(A, 1).T
    return torch.tril(A) + torch.tril(A, -1).T


def safe_scal(alpha, x: torch.Tensor) -> torch.Tensor:
    """Overflow-guarded scaling (RandBLAS ``safe_scal``): α·x as
    (sign(α)·√|α|)·(√|α|·x) when |α| exceeds √(largest finite)."""
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    big = torch.finfo(x.dtype).max ** 0.5
    r = torch.sqrt(alpha.abs())
    return torch.where(alpha.abs() > big, (torch.sign(alpha) * r) * (r * x),
                       alpha * x)


def omatcopy(A: torch.Tensor, trans: bool = False, alpha=1.0) -> torch.Tensor:
    """Out-of-place scaled copy or transpose (RandBLAS ``omatcopy``;
    rl_util.hh:315 ``transposition`` is ``trans=True``)."""
    return torch.as_tensor(alpha, dtype=A.dtype, device=A.device) * (
        A.T if trans else A)


def dims_before_op(n_rows: int, n_cols: int, trans: bool):
    """Dimensions of X such that op(X) is n_rows × n_cols (RandBLAS
    ``dims_before_op``)."""
    return (n_cols, n_rows) if trans else (n_rows, n_cols)


def transpose_square(A: torch.Tensor) -> torch.Tensor:
    """Transpose of a square matrix (rl_util.hh:279); a view, since a
    tensor has no leading dimension to keep in place."""
    require(A.dim() == 2 and A.shape[0] == A.shape[1],
            f"transpose_square needs a square input, got {tuple(A.shape)}")
    return A.T
