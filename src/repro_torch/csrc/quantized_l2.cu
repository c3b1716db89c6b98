// Batched quantized squared-L2 distances, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/quantized_l2.py:
//   quantized_l2_pallas (body _ql2_kernel) -> ql2_moments + ql2_combine
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
// sends B <= 4 queries against N <= 6 codes rows of D = 2M .. 190M elements.
// What bounds it: every code byte and query element is used for a handful
// of integer and float operations, so the kernel is bound by the bytes of
// the codes (N*D) and queries (B*D*4) over device memory bandwidth.
//
// What the design does about it:
// * D is split across blocks (gridDim.x chunks, sized in the wrapper to
//   fill the 132 SMs several times over). A block owns up to 8 code rows
//   and 4 queries, reads each query chunk once for all its rows and each
//   code chunk once for all its queries, 8 elements per thread per step
//   (8-byte code loads, 16-byte query loads) when D % 8 == 0.
// * sum and sq are exact integers: int32 within a thread (the wrapper keeps
//   a thread's share of a chunk below 32768 elements, so 255^2 * share fits),
//   int64 across threads and chunks. dot is float32 within a chunk and
//   float64 across chunks; |q|^2 and Sq are float64 throughout.
// * Each block writes its chunk's partial moments; ql2_combine sums the
//   chunks in a fixed order and applies the s == 0 -> mid rule, the clamp
//   and the D z^2 term in float64 (deterministic, no atomics).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsT = 8;     // code rows per block
constexpr int kQueriesT = 4;  // queries per block
constexpr int kVec = 8;       // elements per thread per step on the vector path
// Partial values a thread reduces: dot[rows][queries], sum[rows], sq[rows],
// qsq[queries], qsum[queries].
constexpr int kNDot = kRowsT * kQueriesT;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads) ql2_moments(
    const float* __restrict__ q, const uint8_t* __restrict__ codes,
    int B, int N, long long D, long long chunk,
    float* __restrict__ dotp, long long* __restrict__ sump, long long* __restrict__ sqp,
    double* __restrict__ qsqp, double* __restrict__ qsump) {
  const int c = blockIdx.x;
  const int r0 = blockIdx.y * kRowsT, nr = min(kRowsT, N - r0);
  const int b0 = blockIdx.z * kQueriesT, nb = min(kQueriesT, B - b0);
  const long long beg = static_cast<long long>(c) * chunk;
  const long long end = min(D, beg + chunk);

  float dot[kRowsT][kQueriesT];
  int isum[kRowsT], isq[kRowsT];
  double qsq[kQueriesT], qsum[kQueriesT];
#pragma unroll
  for (int r = 0; r < kRowsT; ++r) {
    isum[r] = 0;
    isq[r] = 0;
#pragma unroll
    for (int b = 0; b < kQueriesT; ++b) dot[r][b] = 0.f;
  }
#pragma unroll
  for (int b = 0; b < kQueriesT; ++b) qsq[b] = qsum[b] = 0.0;

  if (VEC) {
    for (long long d = beg + static_cast<long long>(threadIdx.x) * kVec; d < end;
         d += static_cast<long long>(kThreads) * kVec) {
      float qv[kQueriesT][kVec];
#pragma unroll
      for (int b = 0; b < kQueriesT; ++b) {
        if (b < nb) {
          const float4* p = reinterpret_cast<const float4*>(q + (b0 + b) * D + d);
          const float4 lo = __ldg(p), hi = __ldg(p + 1);
          qv[b][0] = lo.x; qv[b][1] = lo.y; qv[b][2] = lo.z; qv[b][3] = lo.w;
          qv[b][4] = hi.x; qv[b][5] = hi.y; qv[b][6] = hi.z; qv[b][7] = hi.w;
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const double v = qv[b][e];
            qsq[b] = fma(v, v, qsq[b]);
            qsum[b] += v;
          }
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) qv[b][e] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsT; ++r) {
        if (r < nr) {
          const uint2 w = __ldg(reinterpret_cast<const uint2*>(codes + (r0 + r) * D + d));
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const int cv = static_cast<int>(((e < 4 ? w.x : w.y) >> (8 * (e & 3))) & 0xffu);
            isum[r] += cv;
            isq[r] += cv * cv;
            const float cf = static_cast<float>(cv);
#pragma unroll
            for (int b = 0; b < kQueriesT; ++b) dot[r][b] = fmaf(cf, qv[b][e], dot[r][b]);
          }
        }
      }
    }
  } else {
    for (long long d = beg + threadIdx.x; d < end; d += kThreads) {
      float qv[kQueriesT];
#pragma unroll
      for (int b = 0; b < kQueriesT; ++b) {
        qv[b] = b < nb ? q[(b0 + b) * D + d] : 0.f;
        const double v = qv[b];
        qsq[b] = fma(v, v, qsq[b]);
        qsum[b] += v;
      }
#pragma unroll
      for (int r = 0; r < kRowsT; ++r) {
        if (r < nr) {
          const int cv = codes[(r0 + r) * D + d];
          isum[r] += cv;
          isq[r] += cv * cv;
          const float cf = static_cast<float>(cv);
#pragma unroll
          for (int b = 0; b < kQueriesT; ++b) dot[r][b] = fmaf(cf, qv[b], dot[r][b]);
        }
      }
    }
  }

  // Block reduction: warp shuffles, then one shared slot per warp.
  __shared__ float s_dot[kWarps][kNDot];
  __shared__ long long s_int[kWarps][2 * kRowsT];
  __shared__ double s_q[kWarps][2 * kQueriesT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRowsT; ++r) {
#pragma unroll
    for (int b = 0; b < kQueriesT; ++b) {
      const float v = warp_sum(dot[r][b]);
      if (lane == 0) s_dot[warp][r * kQueriesT + b] = v;
    }
    const long long vs = warp_sum(static_cast<long long>(isum[r]));
    const long long vq = warp_sum(static_cast<long long>(isq[r]));
    if (lane == 0) {
      s_int[warp][r] = vs;
      s_int[warp][kRowsT + r] = vq;
    }
  }
#pragma unroll
  for (int b = 0; b < kQueriesT; ++b) {
    const double a = warp_sum(qsq[b]);
    const double s = warp_sum(qsum[b]);
    if (lane == 0) {
      s_q[warp][b] = a;
      s_q[warp][kQueriesT + b] = s;
    }
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < kNDot) {
    const int r = t / kQueriesT, b = t % kQueriesT;
    if (r < nr && b < nb) {
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += s_dot[w][t];
      dotp[(static_cast<long long>(c) * B + b0 + b) * N + r0 + r] = v;
    }
  } else if (t < kNDot + 2 * kRowsT) {
    // Integer moments: written once per (chunk, row), by the first query tile.
    const int i = t - kNDot, r = i % kRowsT;
    if (blockIdx.z == 0 && r < nr) {
      long long v = 0;
      for (int w = 0; w < kWarps; ++w) v += s_int[w][i];
      long long* dst = i < kRowsT ? sump : sqp;
      dst[static_cast<long long>(c) * N + r0 + r] = v;
    }
  } else if (t < kNDot + 2 * kRowsT + 2 * kQueriesT) {
    // Query statistics: written once per (chunk, query), by the first row tile.
    const int i = t - kNDot - 2 * kRowsT, b = i % kQueriesT;
    if (blockIdx.y == 0 && b < nb) {
      double v = 0.0;
      for (int w = 0; w < kWarps; ++w) v += s_q[w][i];
      double* dst = i < kQueriesT ? qsqp : qsump;
      dst[static_cast<long long>(c) * B + b0 + b] = v;
    }
  }
}

__global__ void ql2_combine(
    const float* __restrict__ dotp, const long long* __restrict__ sump,
    const long long* __restrict__ sqp, const double* __restrict__ qsqp,
    const double* __restrict__ qsump, const double* __restrict__ scales,
    const double* __restrict__ zps, const double* __restrict__ mids,
    double* __restrict__ out, int B, int N, long long D, int nchunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  const int b = i / N, n = i % N;
  double dot = 0.0, qsq = 0.0, qsum = 0.0;
  long long sum = 0, sq = 0;
  for (int c = 0; c < nchunks; ++c) {
    dot += static_cast<double>(dotp[(static_cast<long long>(c) * B + b) * N + n]);
    sum += sump[static_cast<long long>(c) * N + n];
    sq += sqp[static_cast<long long>(c) * N + n];
    qsq += qsqp[static_cast<long long>(c) * B + b];
    qsum += qsump[static_cast<long long>(c) * B + b];
  }
  const double s = scales[n], z = zps[n], dd = static_cast<double>(D);
  double dist;
  if (s != 0.0) {
    const double norm = s * s * (static_cast<double>(sq) - 2.0 * z * static_cast<double>(sum) + dd * z * z);
    dist = qsq + norm + 2.0 * (qsum * s * z - s * dot);
  } else {
    const double m = mids[n];
    dist = qsq - 2.0 * m * qsum + dd * m * m;
  }
  out[i] = dist > 0.0 ? dist : 0.0;
}

}  // namespace

extern "C" {

// out (B, N) float64 = squared L2 of queries q (B, D) float32 against codes
// (N, D) uint8 with per-row scales/zps/mids (N,) float64. The scratch
// buffers hold the per-chunk partials: dotp (nchunks, B, N) float32, sump
// and sqp (nchunks, N) int64, qsqp and qsump (nchunks, B) float64.
// vec = 1 takes the 8-wide loads (D % 8 == 0, q 16-byte and codes 8-byte
// aligned). Returns cudaGetLastError() after the launches (0 on success).
int quantized_l2(const float* q, const uint8_t* codes, const double* scales,
                 const double* zps, const double* mids, double* out,
                 float* dotp, long long* sump, long long* sqp, double* qsqp,
                 double* qsump, int B, int N, long long D, int nchunks,
                 long long chunk, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nchunks, (N + kRowsT - 1) / kRowsT, (B + kQueriesT - 1) / kQueriesT);
  if (vec)
    ql2_moments<true><<<grid, kThreads, 0, s>>>(q, codes, B, N, D, chunk, dotp, sump, sqp, qsqp, qsump);
  else
    ql2_moments<false><<<grid, kThreads, 0, s>>>(q, codes, B, N, D, chunk, dotp, sump, sqp, qsqp, qsump);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = B * N;
  ql2_combine<<<(total + 127) / 128, 128, 0, s>>>(dotp, sump, sqp, qsqp, qsump, scales, zps,
                                                 mids, out, B, N, D, nchunks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
