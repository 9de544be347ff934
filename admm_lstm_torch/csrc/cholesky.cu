// Batched small Cholesky solves and triangular inverses, for Hopper.
//
// Replaces admm_lstm_tpu/kernels/cholesky.py::pallas_chol_solve (a x = b
// for N SPD systems of width D <= 128) and ::pallas_chol_inverse (L^-1 of
// N SPD blocks of width c <= 128, with A = L L^T and exact zeros above the
// diagonal).  Both factor A with the unblocked right-looking Cholesky of
// the TPU kernels (pivot, column scale, rank-1 update of the trailing
// lower triangle); chol_solve then runs the forward substitution L y = b
// and the backward substitution L^T x = y, chol_inverse the forward
// substitution L X = I.
//
// Layout: a (N, D, D), b and x (N, D), L^-1 (N, c, c), all row-major f32.
// Only the lower triangle of a is read (loaded, and used).
//
// What bounds it on an H100: neither bytes nor operations at the shapes
// of the exact weight solve.  At (N 512, D 128) the lower triangles, b
// and x are 17 MB (5.2 us at 3.35 TB/s) and the work 375 MFLOP (5.6 us
// at 67 TFLOP/s FP32), but the factorization is a chain of D dependent column
// steps, each a few shared-memory loads and a block barrier, and the
// substitutions add 2D more.  At GoogleStock's (40, 10) the data is about
// 19 KB and the launch latency is the whole time.
//
// Design: one block of 256 threads owns one system, which lives in
// shared memory for the whole factorization (D^2 floats, 64 KB at
// D = 128, so the launch opts in to dynamic shared memory above 48 KB).
// The row pitch is odd, so a warp reading down a column hits 32 banks.
// Step j of the factorization leaves column j unscaled and stores
// 1/sqrt(pivot) aside; every thread of the trailing update forms
// l_i = a_ij / sqrt(a_jj) on the fly, so one barrier per column suffices.
// A last pass scales the columns into L.  The substitutions are
// right-looking: step j updates the remaining entries in parallel, one
// barrier per step.  chol_inverse gives each of the first c threads one
// column of X = L^-1, which it walks row by row from shared memory, so
// its phase needs no barrier at all.  Fewer systems than SMs (N = 40 at
// GoogleStock) leave SMs idle; the call is latency-bound there anyway.
//
// Numerics: IEEE square root and division, and products and differences
// rounded one at a time (__fmul_rn, __fsub_rn: no FMA contraction), in
// the order of the plain PyTorch version (kernels/cholesky.py), which
// therefore repeats every rounding of this kernel.  A non-positive pivot
// gives NaN, which propagates: nothing is masked.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32, TY = 8;        // 256 threads per block
constexpr int MAX_DIM = 128;
constexpr size_t MAX_SMEM = 232448;   // bytes a block may use on sm_90

__host__ __device__ constexpr int pitch_of(int dim) { return dim | 1; }

// Loads system n's matrix into s (row pitch p), factors it, and leaves
// the explicit L in the lower triangle of s.  inv is dim floats of
// scratch.  Ends with a barrier.
__device__ void load_and_factor(const float* __restrict__ a, float* s,
                                float* inv, int dim, int p) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int e = tid; e < dim * dim; e += nthreads) {
    const int i = e / dim, k = e % dim;
    if (k <= i) s[i * p + k] = a[e];   // the upper triangle is never read
  }
  __syncthreads();
  for (int j = 0; j < dim; ++j) {
    const float ij = __fdiv_rn(1.0f, __fsqrt_rn(s[j * p + j]));
    if (tid == 0) inv[j] = ij;
    // Trailing lower triangle j < k <= i < dim: s_ik -= l_i * l_k.
    for (int i = j + 1 + threadIdx.y; i < dim; i += blockDim.y) {
      const float li = __fmul_rn(s[i * p + j], ij);
      for (int k = j + 1 + threadIdx.x; k <= i; k += blockDim.x) {
        const float lk = __fmul_rn(s[k * p + j], ij);
        s[i * p + k] = __fsub_rn(s[i * p + k], __fmul_rn(li, lk));
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < dim * dim; e += nthreads) {
    const int i = e / dim, k = e % dim;
    if (k <= i) s[i * p + k] = __fmul_rn(s[i * p + k], inv[k]);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(TX * TY)
chol_solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ x, int dim) {
  extern __shared__ float smem[];
  const int p = pitch_of(dim);
  float* s = smem;                   // [dim][p]: A, then L
  float* inv = s + dim * p;          // [dim]
  float* v = inv + dim;              // [dim]: residual of the forward pass
  float* y = v + dim;                // [dim]: y, then the backward residual
  const size_t n = blockIdx.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  for (int e = tid; e < dim; e += nthreads) v[e] = b[n * dim + e];
  load_and_factor(a + n * dim * dim, s, inv, dim, p);

  // Forward: L y = b.  Step j fixes y_j and updates the rows below it.
  for (int j = 0; j < dim; ++j) {
    const float yj = __fdiv_rn(v[j], s[j * p + j]);
    if (tid == 0) y[j] = yj;
    for (int i = j + 1 + tid; i < dim; i += nthreads) {
      v[i] = __fsub_rn(v[i], __fmul_rn(s[i * p + j], yj));
    }
    __syncthreads();
  }
  // Backward: L^T x = y, from the bottom.  Step j fixes x_j and updates
  // the entries above it with row j of L.
  for (int j = dim - 1; j >= 0; --j) {
    const float xj = __fdiv_rn(y[j], s[j * p + j]);
    if (tid == 0) x[n * dim + j] = xj;
    for (int k = tid; k < j; k += nthreads) {
      y[k] = __fsub_rn(y[k], __fmul_rn(s[j * p + k], xj));
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(TX * TY)
chol_inverse_kernel(const float* __restrict__ a, float* __restrict__ out,
                    int dim) {
  extern __shared__ float smem[];
  const int p = pitch_of(dim);
  float* s = smem;                   // [dim][p]: A, then L
  float* xs = s + dim * p;           // [dim][p]: X = L^-1
  float* inv = xs + dim * p;         // [dim]
  const size_t n = blockIdx.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;

  load_and_factor(a + n * dim * dim, s, inv, dim, p);

  // L X = I, column c by thread c: X_rc = (d_rc - sum_{m<r} L_rm X_mc) /
  // L_rr in ascending m, the order in which the plain version's
  // right-looking steps subtract.  X_mc = 0 for m < c, so those terms
  // subtract exact zeros.
  if (tid < dim) {
    const int c = tid;
    float* o = out + n * dim * dim;
    for (int r = 0; r < dim; ++r) {
      float xr = 0.0f;
      if (r >= c) {
        float acc = r == c ? 1.0f : 0.0f;
        for (int m = 0; m < r; ++m) {
          acc = __fsub_rn(acc, __fmul_rn(s[r * p + m], xs[m * p + c]));
        }
        xr = __fdiv_rn(acc, s[r * p + r]);
      }
      xs[r * p + c] = xr;
      o[r * dim + c] = xr;
    }
  }
}

constexpr size_t solve_smem(int dim) {
  return ((size_t)dim * pitch_of(dim) + 3 * (size_t)dim) * sizeof(float);
}

constexpr size_t inverse_smem(int dim) {
  return (2 * (size_t)dim * pitch_of(dim) + (size_t)dim) * sizeof(float);
}

static_assert(inverse_smem(MAX_DIM) <= MAX_SMEM &&
              solve_smem(MAX_DIM) <= MAX_SMEM,
              "a D = MAX_DIM system must fit in one block's shared memory");

constexpr int MAX_DEVICES = 64;

// Raises `kernel`'s dynamic shared memory limit to `smem` (what D =
// MAX_DIM needs) once per device and remembers it in `done`, so the
// launch-bound small solves do not pay a cudaFuncSetAttribute per call.
// Two threads racing here both set the same value.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

bool solve_ready[MAX_DEVICES];
bool inverse_ready[MAX_DEVICES];

}  // namespace

extern "C" {

// x = a^-1 b for n SPD systems of width dim (1 <= dim <= 128), launched
// on `stream`.  Returns cudaGetLastError() after the launch (0 = launched).
int cholesky_solve(const void* a, const void* b, void* x, int n, int dim,
                   void* stream) {
  if (n < 1 || dim < 1 || dim > MAX_DIM) return cudaErrorInvalidValue;
  cudaError_t err = prepare(chol_solve_kernel, solve_smem(MAX_DIM),
                            solve_ready);
  if (err != cudaSuccess) return err;
  chol_solve_kernel<<<n, dim3(TX, TY), solve_smem(dim),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(x), dim);
  return cudaGetLastError();
}

// out = L^-1 with a = L L^T for n SPD blocks of width dim (1 <= dim <=
// 128), exact zeros above the diagonal, launched on `stream`.  Returns
// cudaGetLastError() after the launch (0 = launched).
int cholesky_inverse(const void* a, void* out, int n, int dim,
                     void* stream) {
  if (n < 1 || dim < 1 || dim > MAX_DIM) return cudaErrorInvalidValue;
  cudaError_t err = prepare(chol_inverse_kernel, inverse_smem(MAX_DIM),
                            inverse_ready);
  if (err != cudaSuccess) return err;
  chol_inverse_kernel<<<n, dim3(TX, TY), inverse_smem(dim),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(out), dim);
  return cudaGetLastError();
}

}  // extern "C"
