// Batched small Cholesky solves and triangular inverses, for Hopper.
//
// Replaces admm_lstm_tpu/kernels/cholesky.py::pallas_chol_solve (a x = b
// for N SPD systems of width D <= 128) and ::pallas_chol_inverse (L^-1 of
// N SPD blocks of width c <= 128, with A = L L^T and exact zeros above the
// diagonal).
//
// Layout: a (N, D, D), b and x (N, D), L^-1 (N, c, c), all row-major f32.
// Only the lower triangle of a is read.
//
// What bounds them on an H100: at (N 512, D 128) the solve's lower
// triangles, b and x are 17 MB (5.2 us at 3.35 TB/s) and its work 375
// MFLOP (5.6 us at 67 TFLOP/s FP32); the inverse at (512, 64) moves
// 12.6 MB (3.8 us).  Neither is reached: a factorization is a chain of D
// dependent pivots (an IEEE square root and reciprocal each), and the
// backward substitution adds D more dependent steps; the diagonal
// factorizations, the trailing updates, the load of a and the backward
// substitution are, in that order, the longest phases of the solve at
// (512, 128).  At GoogleStock's (40, 10) the data is 19 KB and launch
// latency is most of the time.
//
// Two designs, by width.
//
// D <= 32 (warp_chol_kernel): one warp per system, WARPS systems per
// block, no block barrier.  Lane i holds row i of the lower triangle in
// registers (the kernel is templated on a width bucket of 8, 16 or 32, so
// the arrays are indexed at compile time); each column's pivot and l_kj
// travel by __shfl_sync.  The right-hand side rides along as one more
// column, so the forward substitution adds nothing to the chain of
// pivots; the warp then transposes L through shared memory, so lane c
// holds column c for the backward one.  The inverse gives lane c column c
// of L^-1.
//
// 32 < D <= 128 (blocked_solve_kernel, blocked_inverse_kernel): one block
// of BT threads per system, blocked right-looking Cholesky with panels of
// NB = 16.  The lower triangle lives in shared memory as packed 16 x 16
// tiles (36 at D = 128, 49 KB with their padding), so four systems fit
// on an SM and the 512 systems of the wide exact solve run in one wave.
// Each thread first loads its entry of 12 tiles at a time, so many loads
// are in flight.  Per panel k:
//   (a) warp 0 factors the diagonal tile in registers, as above, with (the
//       solve) the tile's 16 entries of the right-hand side riding along;
//   (b) each thread solves one row of the panel below against that tile;
//   (c) the trailing lower triangle takes a register-tiled SYRK, each
//       thread a 4 x 4 tile (rows r, r+4, .. and columns c, c+4, .., so a
//       quarter warp's float4 loads fall on distinct banks), and (the
//       solve) the right-hand side below takes the panel's GEMV;
// with a block barrier after each: 3 per panel, 24 at D = 128 where a
// column loop takes 384.  The panel rows and the substitutions inside a
// tile are right-looking, so each step is one multiply and one FMA deep.
// The solve's backward substitution is one warp, left-looking over the
// tiles, with no block barrier.  The inverse then
// inverts the diagonal tiles (a warp each) and forms the tiles below by
// their distance from the diagonal, L_ii X_ij = -sum_m L_im X_mj, one
// thread per tile column and one barrier per distance, and writes L^-1 in
// full rows, zeros included (float4 stores where c % 4 == 0).  D is padded
// to a multiple of 16 with identity rows in shared memory.
//
// Numerics: FP32 on the CUDA cores with FMA contraction.  Each pivot d
// gives inv = 1 / sqrt(d) by IEEE square root and reciprocal (__fsqrt_rn,
// __frcp_rn; no rsqrt, no fast math), l_jj = d * inv as in the plain
// version, and inv is kept, so the substitutions, the panel solve and the
// inverse multiply by 1 / l_jj where the plain version divides by l_jj.
// The plain PyTorch versions (kernels/cholesky.py) round every product on
// its own and in another order, so the two agree to rounding, not bit for
// bit (gate (ii) in chip_smoke.py holds the kernels' error against
// float64 to the plain versions' on ill-conditioned inputs).  A
// non-positive pivot gives NaN in its system, which propagates: nothing
// is masked, and the other systems of the launch are untouched.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_DIM = 128;
constexpr size_t MAX_SMEM = 232448;   // bytes a block may use on sm_90
constexpr unsigned FULL = 0xffffffffu;

constexpr int WARP_MAX_DIM = 32;      // widest system of the warp kernel
constexpr int WARPS = 8;              // systems (warps) per warp-kernel block

constexpr int NB = 16;                // panel width of the blocked kernels
constexpr int TP = 20;                // row pitch of a tile, in floats
constexpr int TILE = NB * TP + 16;    // tile stride: neighbours 16 banks apart
constexpr int BT = 256;               // threads of a blocked-kernel block
constexpr int MAX_PANELS = MAX_DIM / NB;

__host__ __device__ constexpr int panels(int dim) { return (dim + NB - 1) / NB; }
__host__ __device__ constexpr int ntiles(int p) { return p * (p + 1) / 2; }

// Tile (i, j), j <= i, of a packed lower triangle of tiles.
__device__ __forceinline__ float* tile(float* t, int i, int j) {
  return t + (i * (i + 1) / 2 + j) * TILE;
}
__device__ __forceinline__ const float* tile(const float* t, int i, int j) {
  return t + (i * (i + 1) / 2 + j) * TILE;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// ---- one warp, one small system, in registers -----------------------

// Cholesky of the leading n x n block, held one row per lane (lane `row`:
// r[k] = a_row,k for k <= row, zeros above), in place: r becomes row
// `row` of L, and lane j's `dinv` becomes 1 / sqrt(pivot j), so that
// l_jj = pivot * dinv as in the plain version and later steps multiply by
// dinv where they would divide by l_jj.  Right-looking over the columns
// j < n.  FWD: v (v_row on lane `row`) rides along as one more column and
// becomes y_row of L y = v, off the factorization's critical path.  Every
// lane of the warp calls it.
//
// The chain of pivots sets the time: each column's IEEE square root and
// reciprocal end in slow-path branches, so the compiler cannot move the
// next column's work ahead of this column's shuffles.  Hence the next
// pivot (lane j+1's own update, the value the loop below gives it) is
// formed and shuffled right after l, ahead of the column's other shuffles.
template <int W, bool FWD>
__device__ __forceinline__ void warp_factor(float (&r)[W], float& v,
                                            float& dinv, int row, int n) {
  float pivot = __shfl_sync(FULL, r[0], 0);
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (j < n) {
      const float inv = __frcp_rn(__fsqrt_rn(pivot));
      if (row == j) dinv = inv;
      const float l = row >= j ? r[j] * inv : 0.0f;    // l_row,j
      r[j] = l;
      if (j + 1 < W) pivot = __shfl_sync(FULL, fmaf(-l, l, r[j + 1]), j + 1);
      if (FWD) {
        const float yj = __shfl_sync(FULL, v, j) * inv;
        if (row == j) v = yj;
        else if (row > j) v = fmaf(-l, yj, v);
      }
#pragma unroll
      for (int k = j + 1; k < W; ++k) {
        const float lk = __shfl_sync(FULL, l, k);      // l_kj
        if (k <= row) r[k] = fmaf(-l, lk, r[k]);
      }
    }
  }
}

// L^T x = w with L held as columns (lane `c`: col[i] = l_ic, w = w_c,
// dinv = 1 / l_cc as above); returns x_c.
template <int W>
__device__ __forceinline__ float warp_backward(const float (&col)[W], float w,
                                               float dinv, int c, int n) {
#pragma unroll
  for (int j = W - 1; j >= 0; --j) {
    if (j < n) {
      const float xj = __shfl_sync(FULL, w * dinv, j);
      if (c < j) w = fmaf(-col[j], xj, w);
      else if (c == j) w = xj;
    }
  }
  return w;
}

// Column c of X = L^-1 for the leading n x n block of the L whose rows
// lie at pitch p in shared memory, with 1 / l_rr at dinv[r * ds]: L x =
// e_c by right-looking substitution (step r fixes x_r and subtracts it
// from the rows below, so each step is one multiply and one FMA deep),
// with exact zeros above the diagonal and beyond n.
template <int W>
__device__ __forceinline__ void column_of_inverse(const float* l, int p,
                                                  const float* dinv, int ds,
                                                  int c, int n, float (&x)[W]) {
#pragma unroll
  for (int r = 0; r < W; ++r) x[r] = r == c ? 1.0f : 0.0f;
#pragma unroll
  for (int r = 0; r < W; ++r) {
    if (r < n) {
      x[r] = r >= c ? x[r] * dinv[r * ds] : 0.0f;
#pragma unroll
      for (int m = r + 1; m < W; ++m) {
        if (m < n) x[m] = fmaf(-l[m * p + r], x[r], x[m]);
      }
    }
  }
}

// One warp per system of width dim <= W.  SOLVE: out = a^-1 b (N, dim);
// else out = L^-1 (N, dim, dim) and b is not read.
template <int W, bool SOLVE>
__global__ void __launch_bounds__(WARPS * 32)
warp_chol_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out, int n, int dim) {
  constexpr int P = W + 1;    // odd pitch: rows and columns conflict-free;
  __shared__ float tiles[WARPS][W * P];   // column W of row i holds 1 / l_ii
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sys = blockIdx.x * WARPS + warp;
  if (sys >= n) return;       // the whole warp; no block barrier follows
  float* s = tiles[warp];

  // Every load of the lower triangle first, then the stores, so the
  // loads are in flight together; the upper triangle is never read.
  constexpr int PER_LANE = (W * W + 31) / 32;
  const float* as = a + (size_t)sys * dim * dim;
  float ld[PER_LANE];
#pragma unroll
  for (int q = 0; q < PER_LANE; ++q) {
    const int e = lane + 32 * q, i = e / dim, k = e - i * dim;
    ld[q] = (e < dim * dim && k <= i) ? as[e] : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < PER_LANE; ++q) {
    const int e = lane + 32 * q, i = e / dim, k = e - i * dim;
    if (e < dim * dim && k <= i) s[i * P + k] = ld[q];
  }
  float v = (SOLVE && lane < dim) ? b[(size_t)sys * dim + lane] : 0.0f;
  __syncwarp();
  float r[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    r[k] = (lane < dim && k <= lane) ? s[lane * P + k] : 0.0f;
  }
  float dinv = 1.0f;
  warp_factor<W, SOLVE>(r, v, dinv, lane, dim);
  __syncwarp();               // every lane has read s
  if (lane < dim) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (k <= lane) s[lane * P + k] = r[k];
    }
    s[lane * P + W] = dinv;
  }
  __syncwarp();

  if (SOLVE) {
    // Lane c takes column c of L for L^T x = y.
#pragma unroll
    for (int i = 0; i < W; ++i) {
      r[i] = (i < dim && i >= lane) ? s[i * P + lane] : 0.0f;
    }
    v = warp_backward<W>(r, v, dinv, lane, dim);
    if (lane < dim) out[(size_t)sys * dim + lane] = v;
  } else {
    float x[W];
    column_of_inverse<W>(s, P, s + W, P, lane, dim, x);
    if (lane < dim) {
      float* o = out + (size_t)sys * dim * dim;
#pragma unroll
      for (int row = 0; row < W; ++row) {
        if (row < dim) o[row * dim + lane] = x[row];   // a row per step: coalesced
      }
    }
  }
}

// ---- one block, one system, in packed shared-memory tiles -------------

// Loads the lower triangle of a into the packed tiles of t: identity
// beyond dim, zeros above the diagonal.  The upper triangle of a is never
// read.  Thread (r, c) = (tid / 16, tid % 16) loads element (r, c) of
// every tile, LOAD_BATCH tiles at a time into registers before storing
// them, so each thread keeps that many global loads in flight (a warp
// covers two 64-byte row segments of a tile per load).
constexpr int LOAD_BATCH = 12;
static_assert(BT == NB * NB, "load_tiles gives each thread one tile entry");

__device__ void load_tiles(const float* __restrict__ a, float* t, int dim,
                           int p) {
  const int r = threadIdx.x / NB, c = threadIdx.x % NB, nt = ntiles(p);
  int ti = 0, tj = 0;                 // tile (ti, tj) of packed index t0 + q
  for (int t0 = 0; t0 < nt; t0 += LOAD_BATCH) {
    float v[LOAD_BATCH];
#pragma unroll
    for (int q = 0; q < LOAD_BATCH; ++q) {
      const int row = ti * NB + r, col = tj * NB + c;
      v[q] = (t0 + q < nt && row < dim && col <= row)
                 ? a[row * dim + col] : (row == col ? 1.0f : 0.0f);
      if (++tj > ti) ++ti, tj = 0;
    }
#pragma unroll
    for (int q = 0; q < LOAD_BATCH; ++q) {
      if (t0 + q < nt) t[(t0 + q) * TILE + r * TP + c] = v[q];
    }
  }
}

// (a) Warp 0 factors diagonal tile k in place and stores 1 / l_jj of its
// columns at dinv[16 k + j].  With v (the solve), it also runs the
// forward substitution of the tile's 16 unknowns, from v into y.  Lanes
// 16-31 mirror lanes 0-15.
__device__ void factor_diagonal_tile(float* t, float* dinv, int k,
                                     const float* v, float* y) {
  float* d = tile(t, k, k);
  const int row = threadIdx.x % NB;
  float r[NB];
#pragma unroll
  for (int m = 0; m < NB; ++m) r[m] = m <= row ? d[row * TP + m] : 0.0f;
  float vr = v ? v[k * NB + row] : 0.0f, di = 1.0f;
  if (v) {
    warp_factor<NB, true>(r, vr, di, row, NB);
  } else {
    warp_factor<NB, false>(r, vr, di, row, NB);
  }
  __syncwarp();
  if (threadIdx.x < NB) {
#pragma unroll
    for (int q = 0; q < NB; q += 4) {
      st4(d + row * TP + q, make_float4(r[q], r[q + 1], r[q + 2], r[q + 3]));
    }
    dinv[k * NB + row] = di;
    if (v) y[k * NB + row] = vr;
  }
}

// (b) Thread `row` of the panel below diagonal tile k solves
// l L_kk^T = a for its row, in place.
__device__ void solve_panel(float* t, const float* dinv, int k, int p) {
  const int rows = (p - 1 - k) * NB;
  if ((int)threadIdx.x >= rows) return;
  const float* d = tile(t, k, k);
  const float* dk = dinv + k * NB;
  float* row = tile(t, k + 1 + threadIdx.x / NB, k) + (threadIdx.x % NB) * TP;
  float l[NB];
#pragma unroll
  for (int q = 0; q < NB; q += 4) {
    const float4 v = ld4(row + q);
    l[q] = v.x, l[q + 1] = v.y, l[q + 2] = v.z, l[q + 3] = v.w;
  }
  // Right-looking: fixing l_j subtracts it from the entries after it.
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    l[j] *= dk[j];
#pragma unroll
    for (int m = j + 1; m < NB; ++m) l[m] = fmaf(-l[j], d[m * TP + j], l[m]);
  }
#pragma unroll
  for (int q = 0; q < NB; q += 4) {
    st4(row + q, make_float4(l[q], l[q + 1], l[q + 2], l[q + 3]));
  }
}

// (c) The trailing update after panel k: A_ij -= L_ik L_jk^T for every
// tile k < j <= i < p, a 4 x 4 register tile per work item, and (when v
// is given) v_i -= L_ik y_k for every row below the panel.
__device__ void update_trailing(float* t, int k, int p, float* v,
                                const float* y) {
  const int m = p - 1 - k;
  const int nsyrk = m * (m + 1) / 2 * NB;        // 16 register tiles a tile
  const int nitems = nsyrk + (v ? m * NB : 0);
  for (int w = threadIdx.x; w < nitems; w += BT) {
    if (w < nsyrk) {
      const int q = w / NB, sub = w % NB;
      int ii = 0;
      while ((ii + 1) * (ii + 2) / 2 <= q) ++ii;
      const int jj = q - ii * (ii + 1) / 2;
      const float* li = tile(t, k + 1 + ii, k);
      const float* lj = tile(t, k + 1 + jj, k);
      float* c = tile(t, k + 1 + ii, k + 1 + jj);
      const int r0 = sub / 4, c0 = sub % 4;
      float acc[4][4] = {};
#pragma unroll
      for (int q4 = 0; q4 < NB; q4 += 4) {
        float4 ra[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ra[i] = ld4(li + (r0 + 4 * i) * TP + q4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 rb = ld4(lj + (c0 + 4 * j) * TP + q4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][j] = fmaf(ra[i].x, rb.x, acc[i][j]);
            acc[i][j] = fmaf(ra[i].y, rb.y, acc[i][j]);
            acc[i][j] = fmaf(ra[i].z, rb.z, acc[i][j]);
            acc[i][j] = fmaf(ra[i].w, rb.w, acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) c[(r0 + 4 * i) * TP + c0 + 4 * j] -= acc[i][j];
      }
    } else {
      const int rr = w - nsyrk;                  // row below the panel
      const float* li = tile(t, k + 1 + rr / NB, k) + (rr % NB) * TP;
      const float* yk = y + k * NB;
      float acc = 0.0f;
#pragma unroll
      for (int q4 = 0; q4 < NB; q4 += 4) {
        const float4 l = ld4(li + q4), yy = ld4(yk + q4);
        acc = fmaf(l.x, yy.x, acc);
        acc = fmaf(l.y, yy.y, acc);
        acc = fmaf(l.z, yy.z, acc);
        acc = fmaf(l.w, yy.w, acc);
      }
      v[(k + 1) * NB + rr] -= acc;
    }
  }
}

// L^T x = y by warp 0, left-looking over the tile rows from the bottom:
// lanes c and c + 16 sum column c of the tiles below in two halves, then
// the warp solves the diagonal tile's transpose.  x goes to xs (shared)
// and to out (its first dim entries).
__device__ void backward_tiles(const float* t, const float* dinv,
                               const float* y, float* xs,
                               float* __restrict__ out, int dim, int p) {
  const int lane = threadIdx.x % 32, c = lane % NB, half = lane / NB;
  __syncwarp();
  for (int k = p - 1; k >= 0; --k) {
    float acc[4] = {};
    for (int i = k + 1 + half; i < p; i += 2) {
      const float* l = tile(t, i, k);
      const float* xi = xs + i * NB;
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        acc[r % 4] = fmaf(l[r * TP + c], xi[r], acc[r % 4]);
      }
    }
    float w = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    w = y[k * NB + c] - (w + __shfl_xor_sync(FULL, w, NB));
    const float* d = tile(t, k, k);
    float col[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) col[i] = i >= c ? d[i * TP + c] : 0.0f;
    w = warp_backward<NB>(col, w, dinv[k * NB + c], c, NB);
    if (lane < NB) {
      xs[k * NB + c] = w;
      if (k * NB + c < dim) out[k * NB + c] = w;
    }
    __syncwarp();
  }
}

// Writes X = L^-1 from its tiles as full rows of out, zeros above the
// diagonal included: float4 stores when dim % 4 == 0.
__device__ void write_inverse(const float* xt, float* __restrict__ o, int dim) {
  if (dim % 4 == 0) {
    const int q = dim / 4;
    for (int e = threadIdx.x; e < dim * q; e += BT) {
      const int row = e / q, col = (e % q) * 4;
      const int ti = row / NB, tj = col / NB;
      const float4 v = tj <= ti
          ? ld4(tile(xt, ti, tj) + (row % NB) * TP + col % NB)
          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      st4(o + row * dim + col, v);
    }
  } else {
    for (int e = threadIdx.x; e < dim * dim; e += BT) {
      const int row = e / dim, col = e % dim, ti = row / NB, tj = col / NB;
      o[e] = tj <= ti ? tile(xt, ti, tj)[(row % NB) * TP + col % NB] : 0.0f;
    }
  }
}

// x = a^-1 b for one system of width 32 < dim <= 128 per block.  (The
// blocked kernels take the warp kernel's arguments; n is not read.)
__global__ void __launch_bounds__(BT, 4)
blocked_solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ x, int /*n*/, int dim) {
  extern __shared__ float4 smem4[];
  float* t = reinterpret_cast<float*>(smem4);   // tiles: A, then L
  const int p = panels(dim);
  float* v = t + ntiles(p) * TILE;              // b, updated below each panel
  float* y = v + p * NB;                        // L y = b
  float* xs = y + p * NB;                       // L^T x = y
  float* dinv = xs + p * NB;                    // 1 / l_jj
  const size_t n = blockIdx.x;
  const int warp = threadIdx.x / 32;

  for (int e = threadIdx.x; e < p * NB; e += BT) {
    v[e] = e < dim ? b[n * dim + e] : 0.0f;
  }
  load_tiles(a + n * dim * dim, t, dim, p);
  __syncthreads();
  for (int k = 0; k < p; ++k) {
    if (warp == 0) factor_diagonal_tile(t, dinv, k, v, y);
    if (k + 1 == p) break;
    __syncthreads();
    solve_panel(t, dinv, k, p);
    __syncthreads();
    update_trailing(t, k, p, v, y);
    __syncthreads();
  }
  if (warp == 0) backward_tiles(t, dinv, y, xs, x + n * dim, dim, p);
}

// L^-1 for one block of width 32 < dim <= 128 per block; b is not read.
__global__ void __launch_bounds__(BT, 4)
blocked_inverse_kernel(const float* __restrict__ a,
                       const float* __restrict__ /*b*/,
                       float* __restrict__ out, int /*n*/, int dim) {
  extern __shared__ float4 smem4[];
  float* t = reinterpret_cast<float*>(smem4);   // tiles: A, then L
  const int p = panels(dim);
  float* xt = t + ntiles(p) * TILE;             // tiles of X = L^-1
  float* dinv = xt + ntiles(p) * TILE;          // 1 / l_jj
  const size_t n = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tiles(a + n * dim * dim, t, dim, p);
  __syncthreads();
  for (int k = 0; k < p; ++k) {
    if (warp == 0) factor_diagonal_tile(t, dinv, k, nullptr, nullptr);
    __syncthreads();
    if (k + 1 == p) break;
    solve_panel(t, dinv, k, p);
    __syncthreads();
    update_trailing(t, k, p, nullptr, nullptr);
    __syncthreads();
  }

  // X_kk = L_kk^-1, a warp per diagonal tile, lane c column c.
  for (int k = warp; k < p; k += BT / 32) {
    float xc[NB];
    column_of_inverse<NB>(tile(t, k, k), TP, dinv + k * NB, 1, lane % NB,
                          NB, xc);
    if (lane < NB) {
      float* d = tile(xt, k, k);
#pragma unroll
      for (int r = 0; r < NB; ++r) d[r * TP + lane] = xc[r];
    }
  }
  __syncthreads();
  // The tiles below, by distance dd = i - j from the diagonal: L_ii X_ij
  // = -sum_{m=j}^{i-1} L_im X_mj, solved by substitution with L_ii (more
  // stable than a product with X_ii), a thread per tile column.
  for (int dd = 1; dd < p; ++dd) {
    const int j = threadIdx.x / NB, c = threadIdx.x % NB, i = j + dd;
    if (i < p) {
      float s[NB] = {};
      for (int m = j; m < i; ++m) {
        const float* l = tile(t, i, m);
        const float* xm = tile(xt, m, j) + c;
#pragma unroll
        for (int q4 = 0; q4 < NB; q4 += 4) {
          const float x0 = xm[q4 * TP], x1 = xm[(q4 + 1) * TP],
                      x2 = xm[(q4 + 2) * TP], x3 = xm[(q4 + 3) * TP];
#pragma unroll
          for (int r = 0; r < NB; ++r) {
            const float4 lr = ld4(l + r * TP + q4);
            s[r] = fmaf(lr.x, x0, s[r]);
            s[r] = fmaf(lr.y, x1, s[r]);
            s[r] = fmaf(lr.z, x2, s[r]);
            s[r] = fmaf(lr.w, x3, s[r]);
          }
        }
      }
      const float* lii = tile(t, i, i);
      const float* di = dinv + i * NB;
      float* xij = tile(xt, i, j);
      // Right-looking, from -s: fixing row r subtracts it from the rows
      // below.
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        s[r] = -s[r] * di[r];
#pragma unroll
        for (int mm = r + 1; mm < NB; ++mm) {
          s[mm] = fmaf(lii[mm * TP + r], s[r], s[mm]);
        }
        xij[r * TP + c] = s[r];
      }
    }
    __syncthreads();
  }
  write_inverse(xt, out + n * dim * dim, dim);
}

constexpr size_t solve_smem(int p) {    // tiles, v, y, x, dinv
  return ((size_t)ntiles(p) * TILE + 4 * (size_t)p * NB) * sizeof(float);
}

constexpr size_t inverse_smem(int p) {  // tiles of L and of X, dinv
  return (2 * (size_t)ntiles(p) * TILE + (size_t)p * NB) * sizeof(float);
}

static_assert(inverse_smem(MAX_PANELS) <= MAX_SMEM &&
              solve_smem(MAX_PANELS) <= MAX_SMEM,
              "a D = MAX_DIM system must fit in one block's shared memory");

// The kernel, block size, dynamic shared memory and systems per block
// that take a system of width dim.
struct Launch {
  const void* fn;
  int threads, systems;
  size_t smem;
};

template <int W>
Launch warp_launch(bool solve) {
  const void* fn = solve
      ? reinterpret_cast<const void*>(&warp_chol_kernel<W, true>)
      : reinterpret_cast<const void*>(&warp_chol_kernel<W, false>);
  return Launch{fn, WARPS * 32, WARPS, 0};
}

Launch choose(int dim, bool solve) {
  if (dim <= 8) return warp_launch<8>(solve);
  if (dim <= 16) return warp_launch<16>(solve);
  if (dim <= WARP_MAX_DIM) return warp_launch<WARP_MAX_DIM>(solve);
  const int p = panels(dim);
  if (solve) {
    return Launch{reinterpret_cast<const void*>(&blocked_solve_kernel), BT, 1,
                  solve_smem(p)};
  }
  return Launch{reinterpret_cast<const void*>(&blocked_inverse_kernel), BT, 1,
                inverse_smem(p)};
}

constexpr int MAX_DEVICES = 64;
bool solve_ready[MAX_DEVICES];
bool inverse_ready[MAX_DEVICES];

// Raises a blocked kernel's dynamic shared memory limit to what
// D = MAX_DIM needs, once per device (remembered in solve_ready or
// inverse_ready), so the launch-bound small solves do not pay a
// cudaFuncSetAttribute per call.  The warp kernel needs no opt-in.  Two
// threads racing here both set the same value.
cudaError_t prepare(int dim, bool solve, const Launch& l) {
  if (dim <= WARP_MAX_DIM) return cudaSuccess;
  bool* done = solve ? solve_ready : inverse_ready;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  const size_t smem = solve ? solve_smem(MAX_PANELS) : inverse_smem(MAX_PANELS);
  err = cudaFuncSetAttribute(l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

int run(const void* a, const void* b, void* out, int n, int dim, bool solve,
        void* stream) {
  if (n < 1 || dim < 1 || dim > MAX_DIM) return cudaErrorInvalidValue;
  const Launch l = choose(dim, solve);
  cudaError_t err = prepare(dim, solve, l);
  if (err != cudaSuccess) return err;
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* po = static_cast<float*>(out);
  void* args[] = {&pa, &pb, &po, &n, &dim};
  err = cudaLaunchKernel(l.fn, dim3((n + l.systems - 1) / l.systems),
                         dim3(l.threads), args, l.smem,
                         static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

extern "C" {

// x = a^-1 b for n SPD systems of width dim (1 <= dim <= 128), launched
// on `stream`.  Returns cudaGetLastError() after the launch (0 = launched).
int cholesky_solve(const void* a, const void* b, void* x, int n, int dim,
                   void* stream) {
  return run(a, b, x, n, dim, true, stream);
}

// out = L^-1 with a = L L^T for n SPD blocks of width dim (1 <= dim <=
// 128), exact zeros above the diagonal, launched on `stream`.  Returns
// cudaGetLastError() after the launch (0 = launched).
int cholesky_inverse(const void* a, void* out, int n, int dim,
                     void* stream) {
  return run(a, nullptr, out, n, dim, false, stream);
}

// For the kernel that takes width dim (solve != 0: cholesky_solve's, else
// cholesky_inverse's): registers per thread, local memory (spill) bytes
// per thread and systems resident per SM on the current device.  Returns
// a CUDA error code (0 = filled in).
int cholesky_kernel_info(int dim, int solve, int* regs, int* local_bytes,
                         int* systems_per_sm) {
  if (dim < 1 || dim > MAX_DIM) return cudaErrorInvalidValue;
  const Launch l = choose(dim, solve != 0);
  cudaError_t err = prepare(dim, solve != 0, l);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, l.fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.fn, l.threads,
                                                      l.smem);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *systems_per_sm = blocks * l.systems;
  return cudaSuccess;
}

}  // extern "C"
