// Pivoted LU of one matrix through cuSOLVER's getrf, for
// ops.qr.lu_factor on the card. It replaces no TPU kernel: the JAX package
// takes this LU from XLA (jax.lax.linalg.lu), and this file is the port's
// binding of the library call that does the same work, as cuBLAS and
// cuSOLVER serve the port's other factorizations. It is not a hand-written
// kernel and has no row in PERF.md's kernel table.
//
// Why a binding of its own: PyTorch reaches cuSOLVER's getrf for a tall
// matrix only under torch.backends.cuda.preferred_linalg_library
// ("cusolver"), a setting of the whole process that a linalg call on
// another thread would also take. Here the call names cuSOLVER itself and
// touches no setting: cusolverDn{S,D}getrf, the routine PyTorch's cuSOLVER
// route calls for one matrix, on PyTorch's current stream, with the
// workspace, pivots and info allocated by the wrapper from PyTorch's
// caching allocator.
//
// Layout: A is column-major with leading dimension m (the wrapper passes
// the transpose of a row-major tensor), factored in place into the packed
// L\U; ipiv gets min(m, n) 1-based int32 row swaps, info the LAPACK info.
//
// Each host thread keeps one cuSOLVER handle a device (cusolverDnCreate is
// slow, and a handle must not be shared between threads); the stream is
// set on it at every call. Return value: 0, a cudaError_t, or 10000 plus a
// cusolverStatus_t.
#include <cuda_runtime.h>
#include <cusolverDn.h>

#include <unordered_map>

namespace {

constexpr int kSolverError = 10000;

int handle_for(cudaStream_t stream, cusolverDnHandle_t* out) {
  thread_local std::unordered_map<int, cusolverDnHandle_t> handles;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto it = handles.find(dev);
  if (it == handles.end()) {
    cusolverDnHandle_t h = nullptr;
    cusolverStatus_t s = cusolverDnCreate(&h);
    if (s != CUSOLVER_STATUS_SUCCESS) return kSolverError + static_cast<int>(s);
    it = handles.emplace(dev, h).first;
  }
  cusolverStatus_t s = cusolverDnSetStream(it->second, stream);
  if (s != CUSOLVER_STATUS_SUCCESS) return kSolverError + static_cast<int>(s);
  *out = it->second;
  return 0;
}

int solver_status(cusolverStatus_t s) {
  if (s != CUSOLVER_STATUS_SUCCESS) return kSolverError + static_cast<int>(s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The workspace getrf needs for an m x n matrix, in elements, written to
// *lwork (a host int).
int rl_getrf_lwork_f32(void* A, int m, int n, void* lwork, void* stream) {
  cusolverDnHandle_t h;
  int err = handle_for(static_cast<cudaStream_t>(stream), &h);
  if (err) return err;
  return solver_status(cusolverDnSgetrf_bufferSize(
      h, m, n, static_cast<float*>(A), m, static_cast<int*>(lwork)));
}

int rl_getrf_lwork_f64(void* A, int m, int n, void* lwork, void* stream) {
  cusolverDnHandle_t h;
  int err = handle_for(static_cast<cudaStream_t>(stream), &h);
  if (err) return err;
  return solver_status(cusolverDnDgetrf_bufferSize(
      h, m, n, static_cast<double*>(A), m, static_cast<int*>(lwork)));
}

// (A, work, ipiv, info, m, n, stream): A column-major m x n, lda m.
int rl_getrf_f32(void* A, void* work, void* ipiv, void* info, int m, int n,
                 void* stream) {
  cusolverDnHandle_t h;
  int err = handle_for(static_cast<cudaStream_t>(stream), &h);
  if (err) return err;
  return solver_status(cusolverDnSgetrf(
      h, m, n, static_cast<float*>(A), m, static_cast<float*>(work),
      static_cast<int*>(ipiv), static_cast<int*>(info)));
}

int rl_getrf_f64(void* A, void* work, void* ipiv, void* info, int m, int n,
                 void* stream) {
  cusolverDnHandle_t h;
  int err = handle_for(static_cast<cudaStream_t>(stream), &h);
  if (err) return err;
  return solver_status(cusolverDnDgetrf(
      h, m, n, static_cast<double*>(A), m, static_cast<double*>(work),
      static_cast<int*>(ipiv), static_cast<int*>(info)));
}

}  // extern "C"
