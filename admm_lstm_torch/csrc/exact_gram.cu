// The exact weight stage's Gram stack and first-order term, for Hopper: one
// pass from the pre-activations to the (S, K, D, D) Gram stack and the
// (S, K, D) first-order term of solvers/normal_eq.py's Gauss-Newton ridge
// update, in FP32 FFMA.
//
// exact_gram_kernel replaces no TPU kernel: the JAX package builds the
// Gram with XLA's dot_general.  The port's plain route
// (kernels/exact_gram.py::exact_gram_plain) runs the activation lines as
// full-slab elementwise passes, copies the slabs to row-major, and for the
// 'wide' strategy writes each chunk of columns' weighted design
// s2[k, n] * m[d, n] (5.84 GB a chunk in the stacked 2 x 40 search) before
// a batched GEMM reads it back.
//
// For each instance s (the candidate axis), column k and row n = (t, b),
// with x = pre[s, t, k, b] and the column's constants (tanh column:
// c = 1, a = 0, q = 1; sigmoid column: c = 0.5, a = 0.5, q = 0.25;
// sigmoid(x) = (1 + tanh(x / 2)) / 2):
//   u = tanhf(c * x),  act = a + c * u,  act' = q * (1 - u * u)
//   s2 = act' * act',  wres = act' * (act - target[s, t, k, b])
//   gram[s, k, d, e] = sum_n s2 * (m[s, t, d, b] * m[s, t, e, b])
//   bvec[s, k, d]    = sum_n wres * m[s, t, d, b]
// Each elementwise step is rounded as PyTorch rounds its separate
// operations (__fmul_rn, __fadd_rn: no contraction) and tanhf is the
// accurate one (no fast math).  The sums are FP32 FFMA: no TF32, no bf16.
//
// It is a GEMM whose operands are made on chip.  Row k of the left
// operand is s2 (or wres); the right operand's columns are the D(D+1)/2
// pair products m_d m_e, d <= e (the symmetric half), then the D columns
// m_d for bvec, each group padded to 8: J columns in all, at D 40
// 824 + 40 = 864.  Nothing between the inputs and the partial sums is
// written to device memory.
//
// What bounds it on an H100.  At the stacked cell's h side (S 27, K 160,
// D 40, N = T*B = 42,240) the symmetric half and bvec are 27 * 160 *
// 42,240 * 860 = 1.57e11 multiply-adds, 4.68 ms at 67 TFLOP/s; its bytes
// (pre, target and the design read once) are 1.67 GB, 0.50 ms.  So the
// FFMA throughput bounds it (cuBLAS's own FP32 GEMM reaches 52 TFLOP/s,
// 78% of the peak, on an H100 80GB HBM3 at 700 W), and the design keeps
// the FMA pipe fed:
//  * A block owns a tile of 8R rows (k) x 8C columns (j) of one instance
//    and a contiguous range (a part) of the row chunks of 32 n (one t,
//    32 consecutive b).  Each thread owns an 8 x 8 register micro-tile and
//    for each n reads 8 left and 8 right values as four 16-byte shared
//    loads (the next row's while this row's FMAs run), then runs 64
//    FFMAs.  The loop alone, with no shared loads, runs at 59% of the
//    peak; with them 47%.
//  * The prologue (the activation lines, ~30 instructions with tanhf) is
//    done once per (k, n) per column tile; a column tile of ~288 columns
//    amortizes it to ~10% of the FMAs.  The staging addresses are a
//    per-thread base plus multiples of per-thread steps, so a chunk's
//    staging costs little beyond its loads and the prologue.  The pair
//    products of a chunk are made once per block into shared memory, one
//    multiply each (~5% at 80 rows).
//  * Register prefetch: the next chunk's raw pre, target and design values
//    are loaded while the current chunk's FMAs run, so the loads' latency
//    hides under the math.  Loads are coalesced along b (32-byte sectors).
//  * The blocks of one row tile and part are adjacent in the launch, so
//    their reads of the same pre and target chunks hit L2.
//  * Small D (the x side, D 1) has few columns: the block's threads then
//    split each chunk's 32 rows into NT groups, each group a part of its
//    own.  There the bytes bound it (1.46 GB at the cell's x side).
//
// Reduction, deterministic: each thread sums its rows n in order; each
// (part, group) writes its own partial sums; exact_gram_reduce_kernel adds
// the partials of each output in part order and writes the mirrored Gram
// and bvec.  No atomics.  The plan (kernels/exact_gram.py::gram_plan)
// depends on K, D, T and B only, never on S, so an instance's sums are
// the same bits in a batched launch, alone, and on a relaunch.
//
// Layout: pre and target (S, T, K, B), m (S, T, D, B) (an S stride of 0:
// one design shared by every instance), float32, b contiguous, the other
// strides as given (in floats, not negative).  tanh_cols (K,) bytes.
// Outputs gram (S, K, D, D) and bvec (S, K, D) contiguous.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 8;          // a thread's micro-tile: 8 rows x 8 columns
constexpr int BN = 32;           // rows n of a chunk (one t, 32 b)
constexpr int MAX_Q = 2;         // row quads of the tile a warp stages
constexpr int MAX_PF = 4 * MAX_Q;  // raw values of each input a thread stages
constexpr int MAX_THREADS = 384;
constexpr int REDUCE_THREADS = 256;

struct GramArgs {
  const float* pre;
  const float* target;
  const float* m;
  const unsigned char* tanh_cols;
  float* part;                   // (S, parts * NT, K, J)
  long long pre_s, pre_t, pre_k;
  long long tgt_s, tgt_t, tgt_k;
  long long m_s, m_t, m_d;
  int K, D, B;
  int npairs, npairs_pad, J;
  int R, C, NT;
  int k_tiles, col_tiles, chunks_per_part, chunks_per_t, total_chunks;
  int part_rows;                 // parts * NT
};

__host__ __device__ inline int pad8(int x) { return (x + 7) / 8 * 8; }

__host__ inline size_t smem_bytes(int R, int C, int D) {
  const int bmp = TILE * R + 4;
  return sizeof(float) * (4 * BN * bmp + 2 * BN * TILE * C + 2 * TILE * C
                          + 2 * (D + 2) * (BN + 1));
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
exact_gram_kernel(const GramArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int R = a.R, C = a.C, NT = a.NT;
  const int BM = TILE * R, BJ = TILE * C, bmp = BM + 4;
  const int threads = R * C * NT;
  const int tid = threadIdx.x;
  // Two buffers of each chunk tile: s2 and wres [BN][bmp], the pair
  // products [BN][BJ], the design [D + 2][BN + 1] (rows D and D + 1 ones
  // and zeros); and the column table.
  float* s_s2 = smem;                          // buffer b at b * 2 * BN * bmp
  float* s_w = s_s2 + BN * bmp;
  float* s_p = smem + 4 * BN * bmp;            // buffer b at b * BN * BJ
  int2* s_col = reinterpret_cast<int2*>(s_p + 2 * BN * BJ);   // [BJ]
  float* s_m = s_p + 2 * BN * BJ + 2 * BJ;     // buffer b at b * m_buf
  const int a_buf = 2 * BN * bmp, p_buf = BN * BJ,
            m_buf = (a.D + 2) * (BN + 1);

  int bx = blockIdx.x;
  const int ct = bx % a.col_tiles;
  bx /= a.col_tiles;
  const int kt = bx % a.k_tiles;
  const int part = bx / a.k_tiles;
  const int s = blockIdx.y;
  // Thread -> (row group, column group, chunk group).  With R even, a warp
  // holds two row groups x 16 column groups, so its four 16-byte loads a
  // row read 2, 2, 16 and 16 distinct addresses (6 shared wavefronts for
  // 64 FMAs).
  const int rc = R * C;
  const int grp = tid / rc, local = tid - grp * rc;
  int rg, cg;
  if ((R & 1) == 0) {
    const int rp = local / (2 * C), rem = local - rp * 2 * C;
    cg = rem >> 1;
    rg = 2 * rp + (rem & 1);
  } else {
    rg = local / C;
    cg = local - rg * C;
  }

  // What each physical column of the tile holds: (d, e) a pair product,
  // (d, -1) m_d for bvec, (-1, -1) padding.  Physical column p holds
  // logical column 8 (p / 4) + p % 4 of the first half or 8 q + 4 + r of
  // the second, so thread cg's 16-byte loads at 4 cg and 4 C + 4 cg read
  // its logical columns 8 cg .. 8 cg + 7, all pairs or all bvec.
  for (int p = tid; p < BJ; p += threads) {
    const int half = p >= 4 * C;
    const int q = half ? p - 4 * C : p;
    const int L = ct * BJ + 8 * (q >> 2) + 4 * half + (q & 3);
    int2 code = make_int2(-1, -1);
    if (L < a.npairs) {
      int d = 0, rem = L;
      while (rem >= a.D - d) {
        rem -= a.D - d;
        ++d;
      }
      code = make_int2(d, d + rem);
    } else if (L >= a.npairs_pad && L < a.npairs_pad + a.D) {
      code = make_int2(L - a.npairs_pad, -1);
    }
    s_col[p] = code;
  }

  // Staging, by the full warps (SW of them): warp w reads row quads
  // q = w + i * SW of the tile (rows 4 q .. 4 q + 3, i < MAX_Q), lane l
  // row 4 q + l / 8 at b = 8 nb + l % 8 for nb = 0..3, so each load reads
  // 8 consecutive b of 4 rows (32-byte sectors) and each shared store is
  // conflict-free (bmp / 4 is odd); and design rows d = w + i * SW, lane
  // l at b = l.  Element (i, nb) is raw value 4 i + nb.  Every address is
  // a per-thread base, a per-chunk offset and a multiple of a per-thread
  // step: no index arithmetic per element.
  const int warp = tid >> 5, lane = tid & 31;
  const int SW = threads >> 5;
  const bool stager = warp < SW;
  const int lq = lane >> 3, lb = lane & 7;
  unsigned row_ok = 0, row_tanh = 0;
#pragma unroll
  for (int i = 0; i < MAX_Q; ++i) {
    const int q = warp + i * SW;
    const int k = kt * BM + 4 * q + lq;
    if (stager && q < 2 * R && k < a.K) {
      row_ok |= 1u << i;
      if (a.tanh_cols[k]) row_tanh |= 1u << i;
    }
  }
  unsigned m_ok = 0;
#pragma unroll
  for (int i = 0; i < MAX_PF; ++i)
    if (stager && warp + i * SW < a.D) m_ok |= 1u << i;
  const long long k0 = kt * BM + 4 * warp + lq;
  const float* pre_base = a.pre + s * a.pre_s + k0 * a.pre_k + lb;
  const float* tgt_base = a.target + s * a.tgt_s + k0 * a.tgt_k + lb;
  const float* m_base = a.m + s * a.m_s + warp * a.m_d + lane;
  const long long pre_step = 4LL * SW * a.pre_k, tgt_step = 4LL * SW * a.tgt_k,
                  m_step = (long long)SW * a.m_d;
  const int st_base = lb * bmp + 4 * warp + lq;

  float raw_x[MAX_PF], raw_y[MAX_PF], raw_m[MAX_PF];
  auto load = [&](int c) {
    const int t = c / a.chunks_per_t;
    const int b0 = (c - t * a.chunks_per_t) * BN;
    const float* px = pre_base + t * a.pre_t + b0;
    const float* py = tgt_base + t * a.tgt_t + b0;
    const float* pm = m_base + t * a.m_t + b0;
#pragma unroll
    for (int i = 0; i < MAX_Q; ++i) {
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const bool ok = ((row_ok >> i) & 1) && b0 + 8 * nb + lb < a.B;
        raw_x[4 * i + nb] = ok ? __ldg(px + i * pre_step + 8 * nb) : 0.f;
        raw_y[4 * i + nb] = ok ? __ldg(py + i * tgt_step + 8 * nb) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < MAX_PF; ++i) {
      const bool ok = ((m_ok >> i) & 1) && b0 + lane < a.B;
      raw_m[i] = ok ? __ldg(pm + i * m_step) : 0.f;
    }
  };
  // The activation lines of the staged values into buffer `buf` of the
  // left operand, for the chunk starting at b0.
  auto stage_a = [&](int c, int buf) {
    if (!stager) return;
    const int b0 = (c % a.chunks_per_t) * BN;
    float* d_s2 = s_s2 + buf * a_buf + st_base;
    float* d_w = s_w + buf * a_buf + st_base;
#pragma unroll
    for (int i = 0; i < MAX_Q; ++i) {
      if (warp + i * SW >= 2 * R) break;
      const bool th = (row_tanh >> i) & 1;
      const float c_ = th ? 1.f : 0.5f, a_ = th ? 0.f : 0.5f,
                  q_ = th ? 1.f : 0.25f;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int j = 4 * i + nb;
        float s2 = 0.f, w = 0.f;
        if (((row_ok >> i) & 1) && b0 + 8 * nb + lb < a.B) {
          const float u = tanhf(__fmul_rn(c_, raw_x[j]));
          const float act = __fadd_rn(a_, __fmul_rn(c_, u));
          const float dact = __fmul_rn(q_, __fsub_rn(1.f, __fmul_rn(u, u)));
          s2 = __fmul_rn(dact, dact);
          w = __fmul_rn(dact, __fsub_rn(act, raw_y[j]));
        }
        const int off = 8 * nb * bmp + 4 * i * SW;
        d_s2[off] = s2;
        d_w[off] = w;
      }
    }
  };
  auto stage_m = [&](int buf) {
    if (!stager) return;
    float* d_m = s_m + buf * m_buf + warp * (BN + 1) + lane;
#pragma unroll
    for (int i = 0; i < MAX_PF; ++i) {
      if (warp + i * SW >= a.D) break;
      d_m[i * SW * (BN + 1)] = raw_m[i];
    }
  };

  // The pair products of buffer `buf`: thread tid < pstep * BJ makes
  // column tid % BJ for rows tid / BJ, + pstep, ...
  const int pstep = threads / BJ;
  const bool p_maker = tid < pstep * BJ;
  const int p_col = p_maker ? tid % BJ : 0, p_n0 = p_maker ? tid / BJ : 0;
  __syncthreads();
  // A column's two factors: its design rows, else row D (ones: bvec's
  // m_d * 1 = m_d) or row D + 1 (zeros: padding), so every product is one
  // multiply.
  const int2 code = s_col[p_col];
  const int p_d = (code.x >= 0 ? code.x : a.D + 1) * (BN + 1),
            p_e = (code.y >= 0 ? code.y : a.D) * (BN + 1);
  for (int q = tid; q < 2 * BN; q += threads) {
    const int row = (a.D + q / BN) * (BN + 1) + q % BN;
    s_m[row] = s_m[m_buf + row] = q < BN ? 1.f : 0.f;
  }
  auto p_row = [&](int buf, int nn) {
    const float* m_ = s_m + buf * m_buf;
    s_p[buf * p_buf + nn * BJ + p_col] = __fmul_rn(m_[p_d + nn], m_[p_e + nn]);
  };
  // One column a thread (pstep 1, the wide designs): all 32 rows
  // unrolled, so their loads overlap.
  auto make_p = [&](int buf) {
    if (!p_maker) return;
    if (pstep == 1) {
#pragma unroll
      for (int nn = 0; nn < BN; ++nn) p_row(buf, nn);
    } else {
#pragma unroll 4
      for (int nn = p_n0; nn < BN; nn += pstep) p_row(buf, nn);
    }
  };

  // The left operand: s2 for the pair columns, wres for bvec's.
  const int l_base = ct * BJ + 8 * cg;
  const float* s_a = (l_base >= a.npairs_pad ? s_w : s_s2) + 4 * rg;
  const float* s_b = s_p + 4 * cg;
  const int n_lo = grp * (BN / NT), n_hi = n_lo + BN / NT;

  float acc[TILE][TILE];
#pragma unroll
  for (int i = 0; i < TILE; ++i)
#pragma unroll
    for (int j = 0; j < TILE; ++j) acc[i][j] = 0.f;
  // 64 FFMAs a row of buffer `buf`, rows n_lo .. n_hi - 1 in order; each
  // row's FMAs run while the next row's four 16-byte loads land.
  auto gemm_rows = [&](int buf) {
    const float* pa = s_a + buf * a_buf;
    const float* pb = s_b + buf * p_buf;
    auto ld4 = [](const float* q) {
      return *reinterpret_cast<const float4*>(q);
    };
    float4 a0 = ld4(pa + n_lo * bmp), a1 = ld4(pa + n_lo * bmp + 4 * R);
    float4 b0 = ld4(pb + n_lo * BJ), b1 = ld4(pb + n_lo * BJ + 4 * C);
#pragma unroll 4
    for (int nn = n_lo; nn < n_hi; ++nn) {
      const int nx = min(nn + 1, n_hi - 1);
      const float4 c0 = ld4(pa + nx * bmp), c1 = ld4(pa + nx * bmp + 4 * R);
      const float4 d0 = ld4(pb + nx * BJ), d1 = ld4(pb + nx * BJ + 4 * C);
      const float av[TILE] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TILE] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      // Row i's FMAs run j up, row i + 1's down: consecutive FMAs share an
      // operand.
#pragma unroll
      for (int i = 0; i < TILE; ++i)
#pragma unroll
        for (int jj = 0; jj < TILE; ++jj) {
          const int j = (i & 1) ? TILE - 1 - jj : jj;
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      a0 = c0; a1 = c1; b0 = d0; b1 = d1;
    }
  };

  // Chunk c's tiles sit in buffer (c - c_begin) & 1.  Each step stages
  // chunk c + 1 and starts loading c + 2, then, past one barrier, makes
  // c + 1's pair products while the FMAs run on chunk c.
  const int c_begin = part * a.chunks_per_part;
  const int c_end = min(c_begin + a.chunks_per_part, a.total_chunks);
  load(c_begin);
  stage_a(c_begin, 0);
  stage_m(0);
  if (c_begin + 1 < c_end) load(c_begin + 1);
  __syncthreads();
  make_p(0);
  __syncthreads();
  for (int c = c_begin; c < c_end; ++c) {
    const int cur = (c - c_begin) & 1, nxt = cur ^ 1;
    if (c + 1 < c_end) {
      stage_a(c + 1, nxt);
      stage_m(nxt);
      if (c + 2 < c_end) load(c + 2);
    }
    __syncthreads();
    if (c + 1 < c_end) make_p(nxt);
    gemm_rows(cur);
    __syncthreads();
  }

  // The partial sums of (part, group): rows 4 rg + i and 4 R + 4 rg + i,
  // logical columns l_base .. l_base + 7.
  if (l_base >= a.J) return;
  float* out = a.part + ((long long)s * a.part_rows + part * NT + grp)
                            * a.K * a.J + l_base;
#pragma unroll
  for (int i = 0; i < TILE; ++i) {
    const int k = kt * BM + (i < 4 ? 4 * rg + i : 4 * R + 4 * rg + i - 4);
    if (k >= a.K) continue;
    float4* dst = reinterpret_cast<float4*>(out + (long long)k * a.J);
    dst[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    dst[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// One thread per (s, k, logical column): the partials in part order, then
// the pair's two mirrored Gram entries or the bvec entry.
__global__ void __launch_bounds__(REDUCE_THREADS)
exact_gram_reduce_kernel(const float* __restrict__ part,
                         float* __restrict__ gram, float* __restrict__ bvec,
                         long long total, int K, int D, int J, int npairs,
                         int npairs_pad, int part_rows) {
  const long long idx = blockIdx.x * (long long)REDUCE_THREADS + threadIdx.x;
  if (idx >= total) return;
  const int L = (int)(idx % J);
  const long long sk = idx / J;                // s * K + k
  const bool is_pair = L < npairs;
  if (!is_pair && (L < npairs_pad || L >= npairs_pad + D)) return;
  const long long s = sk / K, k = sk - s * K;
  const float* src = part + (s * part_rows * K + k) * J + L;
  const long long stride = (long long)K * J;
  float v = src[0];
  for (int p = 1; p < part_rows; ++p) v += src[p * stride];
  if (is_pair) {
    int d = 0, rem = L;
    while (rem >= D - d) {
      rem -= D - d;
      ++d;
    }
    const int e = d + rem;
    gram[(sk * D + d) * D + e] = v;
    gram[(sk * D + e) * D + d] = v;
  } else {
    bvec[sk * D + (L - npairs_pad)] = v;
  }
}

}  // namespace

extern "C" {

// Launches the Gram stack and first-order term of S instances on `stream`:
// pre, target (S, T, K, B) and m (S, T, D, B) at the given S, T and row
// (k or d) strides, b contiguous; tanh_cols (K,) bytes; `part` scratch of
// S * parts * NT * K * J floats, J = pad8(D (D + 1) / 2) + pad8(D); gram
// (S, K, D, D) and bvec (S, K, D) contiguous.  The plan: R row groups and
// C column groups of 8 a block, NT row-chunk groups, `parts` parts of
// `chunks_per_part` chunks of 32 b (kernels/exact_gram.py::gram_plan).
// Returns cudaErrorInvalidValue for a plan the kernel does not take, else
// cudaGetLastError() after the launches (0 = launched).
int exact_gram(const void* pre, const void* target, const void* m,
               const void* tanh_cols, void* part, void* gram, void* bvec,
               int S, int K, int D, int T, int B, long long pre_s,
               long long pre_t, long long pre_k, long long tgt_s,
               long long tgt_t, long long tgt_k, long long m_s,
               long long m_t, long long m_d, int R, int C, int NT,
               int parts, int chunks_per_part, cudaStream_t stream) {
  GramArgs a;
  a.pre = static_cast<const float*>(pre);
  a.target = static_cast<const float*>(target);
  a.m = static_cast<const float*>(m);
  a.tanh_cols = static_cast<const unsigned char*>(tanh_cols);
  a.part = static_cast<float*>(part);
  a.pre_s = pre_s; a.pre_t = pre_t; a.pre_k = pre_k;
  a.tgt_s = tgt_s; a.tgt_t = tgt_t; a.tgt_k = tgt_k;
  a.m_s = m_s; a.m_t = m_t; a.m_d = m_d;
  a.K = K; a.D = D; a.B = B;
  a.npairs = D * (D + 1) / 2;
  a.npairs_pad = pad8(a.npairs);
  a.J = a.npairs_pad + pad8(D);
  a.R = R; a.C = C; a.NT = NT;
  const int threads = R * C * NT;
  if (S < 1 || K < 1 || D < 1 || T < 1 || B < 1 || R < 1 || C < 1
      || NT < 1 || BN % NT || threads > MAX_THREADS
      || threads < TILE * C || 2 * R > MAX_Q * (threads / 32)
      || D > MAX_PF * (threads / 32) || parts < 1
      || chunks_per_part < 1)
    return cudaErrorInvalidValue;
  a.k_tiles = (K + TILE * R - 1) / (TILE * R);
  a.col_tiles = (a.J + TILE * C - 1) / (TILE * C);
  a.chunks_per_t = (B + BN - 1) / BN;
  a.total_chunks = T * a.chunks_per_t;
  a.chunks_per_part = chunks_per_part;
  if ((long long)parts * chunks_per_part < a.total_chunks
      || (long long)(parts - 1) * chunks_per_part >= a.total_chunks)
    return cudaErrorInvalidValue;
  a.part_rows = parts * NT;
  const size_t smem = smem_bytes(R, C, D);
  cudaError_t err = cudaFuncSetAttribute(
      exact_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.col_tiles * a.k_tiles * parts, S);
  exact_gram_kernel<<<grid, threads, smem, stream>>>(a);
  const long long total = (long long)S * K * a.J;
  exact_gram_reduce_kernel<<<(unsigned)((total + REDUCE_THREADS - 1)
                                        / REDUCE_THREADS),
                             REDUCE_THREADS, 0, stream>>>(
      a.part, static_cast<float*>(gram), static_cast<float*>(bvec), total,
      K, D, a.J, a.npairs, a.npairs_pad, a.part_rows);
  return cudaGetLastError();
}

}  // extern "C"
