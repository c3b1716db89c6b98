// Batched quantized squared-L2 distances, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/quantized_l2.py:
//   quantized_l2_pallas (:82, body _ql2_kernel) -> ql2_kernel<QB, VEC>
//
// B float32 queries (B, D) against N rows of uint8 codes (N, D), row n
// dequantizing as (c - z_n) * s_n, or the constant mid_n when s_n == 0.
// As in the reference, the distance is formed from code moments, so the
// (N, D) dequantized rows never exist:
//
//   dot_bn = sum_d c_nd q_bd     sum_n = sum_d c_nd     sq_n = sum_d c_nd^2
//   dist_bn = |q_b|^2 + s^2 (sq_n - 2 z sum_n + D z^2) + 2 (Sq_b s z - s dot_bn)   (s != 0)
//   dist_bn = |q_b|^2 - 2 mid Sq_b + D mid^2                                      (s == 0)
//
// clamped at 0, with Sq_b = sum_d q_bd. Nothing is padded here, so D is the
// true dimension (the reference's d_true).
//
// The shapes are the opposite of the TPU kernel's: the save-path probe
// sends B <= 4 queries against N <= 8 code rows of D = 2M .. 190M elements
// (the brute-force index scan, N up to 4096 rows of small D, must stay
// right but is not what the design is for). What bounds it: every code
// byte and query element is used by a handful of operations, so the bytes
// of the codes (N*D) and the float32 queries (4*B*D) over device memory.
//
// What the design does about it:
// * One launch a call. A block owns a tile of 4 code rows by QB queries
//   (QB = 1, 2 or 4, chosen by B: no FMA on a query that is not there) and
//   one contiguous chunk of D; the wrapper's plan (kernels/quantized_l2.py
//   `plan`) sizes the chunks so that a tile's blocks make one wave over
//   the card. Each block writes its partial moments; the block that
//   finishes a tile last (a fenced atomic ticket, which it resets) adds
//   the tile's partials in chunk order and writes the distances: a fixed
//   order, so the result is bit-identical on repeat. A tile of a single
//   chunk writes its distances straight away.
// * 16-byte loads: a step is 16 elements a thread, one 16-byte load of
//   codes a row and four of each query, all issued before any is used.
//   D % 16 != 0 or unaligned operands take element loads (VEC = false, the
//   general path, QB = 4).
// * Codes become floats by one byte permute with 0x4B000000 (passed as an
//   argument so the selector keeps the permute's immediate; as in
//   dequant_matmul.cu) and one exact float subtraction of 2^23: no I2F.
//   sum and sq come from __dp4a, four codes an instruction, exact in
//   uint32 within a thread (the plan keeps a thread's share of D at most
//   32768 elements: 32768 * 255^2 < 2^31).
// * Precision: c.q, q.q and Sq are summed in float32 over a step's 16
//   elements and the step sums in float64, so the float32 error is that of
//   16 terms, not of a thread's whole share (on the element path all three
//   are float64 throughout); the integer moments are exact. Across threads
//   and blocks all sums are float64 in a fixed order, and the combination
//   is float64. Where a query nearly coincides with a row (distance ~1e-4
//   of |q|^2), this holds rtol 2e-3 against the dense float64 plain
//   version (tests/test_torch_kernels.py replays it; tests/test_torch_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 16;  // elements a thread a step on the 16-byte path
constexpr int kRows = 4;   // code rows a tile (8 spilled, or ran slower: PERF.md)

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // the total in lane 0
}

// The four code bytes of `w` as floats: the byte permute makes 2^23 + c,
// and subtracting 2^23 leaves c, exact.
__device__ __forceinline__ void code_floats(uint32_t w, uint32_t magic, float* f) {
  f[0] = __int_as_float(__byte_perm(w, magic, 0x7440)) - 8388608.f;
  f[1] = __int_as_float(__byte_perm(w, magic, 0x7441)) - 8388608.f;
  f[2] = __int_as_float(__byte_perm(w, magic, 0x7442)) - 8388608.f;
  f[3] = __int_as_float(__byte_perm(w, magic, 0x7443)) - 8388608.f;
}

// sum_e x[e] * y[e] over a step's 16 elements, four chains of four.
__device__ __forceinline__ float dot16(const float (&x)[kStep], const float (&y)[kStep]) {
  float a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j] = x[4 * j] * y[4 * j];
#pragma unroll
    for (int e = 1; e < 4; ++e) a[j] = fmaf(x[4 * j + e], y[4 * j + e], a[j]);
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// sum_e x[e] over a step's 16 elements, in the same order.
__device__ __forceinline__ float sum16(const float (&x)[kStep]) {
  float a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = (x[4 * j] + x[4 * j + 1]) + (x[4 * j + 2] + x[4 * j + 3]);
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// tot[k] = the block's sum of v[k] over its threads, for k < P: warp
// shuffles, then the warps' sums in warp order (a fixed order).
template <int P>
__device__ __forceinline__ void block_sum(const double (&v)[P], double (&red)[kWarps][P],
                                          double* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const double s = warp_sum(v[k]);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < P) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// Partial moments of a tile, in this order: dot[kRows][QB], qsq[QB],
// qsum[QB], sum[kRows], sq[kRows].
template <int QB>
struct Layout {
  static constexpr int kDot = 0, kQsq = kRows * QB, kQsum = kQsq + QB, kSum = kQsum + QB,
                       kSq = kSum + kRows, kP = kSq + kRows;
};

template <int QB, bool VEC>
__global__ void __launch_bounds__(kThreads, QB == 4 ? 1 : 2) ql2_kernel(
    const float* __restrict__ q, const uint8_t* __restrict__ codes,
    const double* __restrict__ scales, const double* __restrict__ zps,
    const double* __restrict__ mids, double* __restrict__ out, double* __restrict__ part,
    unsigned* __restrict__ tickets, int B, int N, long long D, long long chunk,
    uint32_t magic) {
  constexpr int RB = kRows;
  using L = Layout<QB>;
  const int tiles_r = (N + RB - 1) / RB, tiles = tiles_r * ((B + QB - 1) / QB);
  const int nchunks = gridDim.x / tiles;
  // Row tiles vary fastest, so blocks that read the same query chunk run together.
  const int tile = blockIdx.x % tiles, c = blockIdx.x / tiles;
  const int r0 = (tile % tiles_r) * RB, nr = min(RB, N - r0);
  const int b0 = (tile / tiles_r) * QB, nb = min(QB, B - b0);
  const long long beg = static_cast<long long>(c) * chunk;
  const long long end = min(D, beg + chunk);

  const int t = threadIdx.x;
  double dot[RB][QB], qsq[QB], qsum[QB];
  uint32_t isum[RB], isq[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    isum[r] = isq[r] = 0u;
#pragma unroll
    for (int b = 0; b < QB; ++b) dot[r][b] = 0.0;
  }
#pragma unroll
  for (int b = 0; b < QB; ++b) qsq[b] = qsum[b] = 0.0;

  if constexpr (VEC) {
    for (long long d = beg + static_cast<long long>(t) * kStep; d < end;
         d += static_cast<long long>(kThreads) * kStep) {
      float qv[QB][kStep];
      uint4 cw[RB];
#pragma unroll
      for (int b = 0; b < QB; ++b) {
        if (b < nb) {
          const float4* p = reinterpret_cast<const float4*>(q + (b0 + b) * D + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 v = __ldg(p + j);
            qv[b][4 * j] = v.x;
            qv[b][4 * j + 1] = v.y;
            qv[b][4 * j + 2] = v.z;
            qv[b][4 * j + 3] = v.w;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r < nr) cw[r] = __ldg(reinterpret_cast<const uint4*>(codes + (r0 + r) * D + d));
#pragma unroll
      for (int b = 0; b < QB; ++b) {
        if (b < nb) {
          qsq[b] += static_cast<double>(dot16(qv[b], qv[b]));
          qsum[b] += static_cast<double>(sum16(qv[b]));
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < nr) {
          const uint32_t w[4] = {cw[r].x, cw[r].y, cw[r].z, cw[r].w};
          float cf[kStep];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            isum[r] = __dp4a(w[j], 0x01010101u, isum[r]);
            isq[r] = __dp4a(w[j], w[j], isq[r]);
            code_floats(w[j], magic, cf + 4 * j);
          }
#pragma unroll
          for (int b = 0; b < QB; ++b)
            if (b < nb) dot[r][b] += static_cast<double>(dot16(cf, qv[b]));
        }
      }
    }
  } else {
    for (long long d = beg + t; d < end; d += kThreads) {
      double qd[QB];
#pragma unroll
      for (int b = 0; b < QB; ++b) {
        qd[b] = b < nb ? static_cast<double>(q[(b0 + b) * D + d]) : 0.0;
        qsq[b] = fma(qd[b], qd[b], qsq[b]);
        qsum[b] += qd[b];
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < nr) {
          const uint32_t cv = codes[(r0 + r) * D + d];
          isum[r] += cv;
          isq[r] += cv * cv;
          const double cd = static_cast<double>(cv);
#pragma unroll
          for (int b = 0; b < QB; ++b) dot[r][b] = fma(cd, qd[b], dot[r][b]);
        }
      }
    }
  }

  // Block totals: warp shuffles, then the warps' sums in warp order.
  double v[L::kP];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int b = 0; b < QB; ++b) v[L::kDot + r * QB + b] = dot[r][b];
    v[L::kSum + r] = static_cast<double>(isum[r]);
    v[L::kSq + r] = static_cast<double>(isq[r]);
  }
#pragma unroll
  for (int b = 0; b < QB; ++b) {
    v[L::kQsq + b] = qsq[b];
    v[L::kQsum + b] = qsum[b];
  }
  __shared__ double red[kWarps][L::kP];
  __shared__ double tot[L::kP];
  __shared__ bool last;
  block_sum(v, red, tot);
  if (nchunks > 1) {
    // Each block writes its partials; the last of the tile to arrive adds
    // them all, thread t taking chunks t, t + 256, ... of every moment.
    double* mine = part + static_cast<long long>(tile) * L::kP * nchunks;
    if (t < L::kP) mine[static_cast<long long>(t) * nchunks + c] = tot[t];
    __threadfence();
    __syncthreads();
    if (t == 0) last = atomicAdd(tickets + tile, 1u) == static_cast<unsigned>(nchunks - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int k = 0; k < L::kP; ++k) v[k] = 0.0;
    for (int i = t; i < nchunks; i += kThreads) {
#pragma unroll
      for (int k = 0; k < L::kP; ++k)  // all the moments' loads at once
        v[k] += __ldcg(mine + static_cast<long long>(k) * nchunks + i);
    }
    block_sum(v, red, tot);
    if (t == 0) tickets[tile] = 0u;  // ready for the next call on this stream
  }

  if (t < RB * QB) {
    const int r = t / QB, b = t % QB;
    if (r < nr && b < nb) {
      const int n = r0 + r;
      const double qs = tot[L::kQsq + b], qm = tot[L::kQsum + b], dd = static_cast<double>(D);
      const double s = scales[n], z = zps[n];
      double dist;
      if (s != 0.0) {
        const double norm = s * s * (tot[L::kSq + r] - 2.0 * z * tot[L::kSum + r] + dd * z * z);
        dist = qs + norm + 2.0 * (qm * s * z - s * tot[L::kDot + r * QB + b]);
      } else {
        const double m = mids[n];
        dist = qs - 2.0 * m * qm + dd * m * m;
      }
      out[static_cast<long long>(b0 + b) * N + n] = dist > 0.0 ? dist : 0.0;
    }
  }
}

template <int QB, bool VEC>
cudaError_t run(const float* q, const uint8_t* codes, const double* scales, const double* zps,
                const double* mids, double* out, double* part, unsigned* tickets, int B, int N,
                long long D, int nchunks, long long chunk, cudaStream_t s) {
  const long long tiles = static_cast<long long>((N + kRows - 1) / kRows) * ((B + QB - 1) / QB);
  const long long blocks = tiles * nchunks;
  if (blocks > 0x7fffffffLL || (nchunks > 1 && (part == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  ql2_kernel<QB, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      q, codes, scales, zps, mids, out, part, tickets, B, N, D, chunk, 0x4B000000u);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (B, N) float64 = squared L2 of queries q (B, D) float32 against codes
// (N, D) uint8 with per-row scales/zps/mids (N,) float64, in one launch of
// (row tiles * query tiles * nchunks) blocks, each chunk `chunk` elements
// of D. qb = 1, 2 or 4 queries a tile (by 4 code rows) on the
// 16-byte path (vec = 1: D % 16 == 0, q and codes 16-byte aligned, chunk a
// multiple of 16); vec = 0 takes element loads, with qb = 4. A thread
// takes at most 32768 elements. With nchunks > 1, part holds (tiles, P, nchunks)
// float64 partials (P = 4*qb + 2*qb + 2*4) and tickets (tiles,) uint32
// zeros, which the kernel leaves at zero. Returns the CUDA error (0 on
// success).
int quantized_l2(const float* q, const uint8_t* codes, const double* scales, const double* zps,
                 const double* mids, double* out, double* part, unsigned* tickets, int B, int N,
                 long long D, int qb, int vec, int nchunks, long long chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long unit = vec ? kStep : 1, step = kThreads * unit;
  if (B <= 0 || N <= 0 || D <= 0 || nchunks <= 0 || chunk <= 0 || chunk % unit != 0 ||
      (nchunks - 1) * chunk >= D || nchunks * chunk < D ||
      (chunk + step - 1) / step * unit > 32768 || (vec && D % kStep != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (vec && qb == 1)
    err = run<1, true>(q, codes, scales, zps, mids, out, part, tickets, B, N, D, nchunks, chunk, s);
  else if (vec && qb == 2)
    err = run<2, true>(q, codes, scales, zps, mids, out, part, tickets, B, N, D, nchunks, chunk, s);
  else if (vec && qb == 4)
    err = run<4, true>(q, codes, scales, zps, mids, out, part, tickets, B, N, D, nchunks, chunk, s);
  else if (!vec && qb == 4)
    err = run<4, false>(q, codes, scales, zps, mids, out, part, tickets, B, N, D, nchunks, chunk, s);
  return static_cast<int>(err);
}

}  // extern "C"
