// Fused dequantize-and-matmul on compressed weights, for Hopper (sm_90a).
//
// Replaces the TPU kernels in src/repro/kernels/dequant_matmul.py:
//   dequant_matmul_pallas      (body _dq_matmul_kernel)       -> dq_matmul_kernel<false, *>
//   dequant_matmul_int4_pallas (body _dq_matmul_int4_kernel)  -> dq_matmul_kernel<true, *>
//
//   y = x @ ((base - bz) * bs + (delta - dz + 0.5) * ds)
//
// x is (M, K) float32, base is (K, N) int8, delta is (K, N) int8 or, packed,
// (K/2, N) uint8 with row 2k in the low nibble and row 2k+1 in the high one
// (the layout of ops.pack_int4). The four quantization parameters are
// scalars; the operand normalisation of core/compressed.py (constant base:
// bz = -129, bs = mid; zero-bit delta: ds = 2*mid) passes through unchanged.
//
// What bounds it: decode runs M <= 8 rows, so each weight element is used
// by at most 8 FMAs while 2 bytes (int8 delta) or 1.5 bytes (int4 delta) of
// it are read. That is far below the card's ratio of operations to bytes:
// the kernel is bound by the bytes of the weight codes over device memory
// bandwidth (3.35 TB/s on an H100 SXM).
//
// What the design does about it:
// * The float weight never exists in device memory. Each thread reads 4
//   neighbouring columns of a code row as one 32-bit word, so a warp reads
//   128 contiguous bytes per row, dequantizes in registers with exactly the
//   reference's float32 formula (explicitly rounded, no FMA contraction) and
//   does IEEE float32 FMAs against x. No tensor cores and no TF32.
// * A block owns 512 output columns for up to 8 rows of x; the rows of x it
//   needs are staged in shared memory 64 K-rows at a time and read as
//   broadcasts, and the accumulators (8 x 4) stay in registers.
// * Narrow layers (N = 1024 gives only 2 column strips) would leave most of
//   the 132 SMs idle, so the K range is split over gridDim.z. Each split
//   writes its partial product to a workspace and a second small pass sums
//   the splits in a fixed order (deterministic, no atomics).
// * Ragged N is masked column by column (the 32-bit loads are used only
//   when N % 4 == 0); ragged K is masked when x is staged. The int4 kernel
//   consumes row pairs, which K even (required by packing) and even chunk
//   and tile sizes keep whole.
//
// Simple and right first: wgmma/TMA pipelines come later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;                      // output columns per thread
constexpr int kBlockN = kThreads * kCols;     // 512 columns per block
constexpr int kRows = 8;                      // rows of x per block
constexpr int kTileK = 64;                    // K rows of x staged per tile

__device__ __forceinline__ float dq_base(int c, float bs, float bz) {
  return __fmul_rn(__fsub_rn(static_cast<float>(c), bz), bs);
}

__device__ __forceinline__ float dq_delta(int c, float ds, float dz) {
  return __fmul_rn(__fadd_rn(__fsub_rn(static_cast<float>(c), dz), 0.5f), ds);
}

// The 4 int8 base codes of columns n0..n0+3 in one code row (masked at N).
template <bool VEC>
__device__ __forceinline__ void load_base(const int8_t* row, int n0, int N, int (&c)[kCols]) {
  if (VEC) {
    const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(row + n0));
#pragma unroll
    for (int j = 0; j < kCols; ++j) c[j] = static_cast<int8_t>((v >> (8 * j)) & 0xffu);
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) c[j] = (n0 + j < N) ? static_cast<int>(row[n0 + j]) : 0;
  }
}

// The 4 bytes of columns n0..n0+3 in one row of unsigned bytes (masked at N).
template <bool VEC>
__device__ __forceinline__ void load_bytes(const uint8_t* row, int n0, int N, unsigned (&c)[kCols]) {
  if (VEC) {
    const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(row + n0));
#pragma unroll
    for (int j = 0; j < kCols; ++j) c[j] = (v >> (8 * j)) & 0xffu;
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) c[j] = (n0 + j < N) ? static_cast<unsigned>(row[n0 + j]) : 0u;
  }
}

template <bool PACKED, bool VEC>
__global__ void __launch_bounds__(kThreads) dq_matmul_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ base,
    const uint8_t* __restrict__ delta, float* __restrict__ out,
    int M, int K, int N, float bs, float bz, float ds, float dz, int kchunk) {
  __shared__ float xs[kRows][kTileK];
  const int n0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int m0 = blockIdx.y * kRows;
  const int mrows = min(kRows, M - m0);
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);

  float acc[kRows][kCols];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kTileK) {
    const int kt = min(kTileK, kend - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kTileK; i += kThreads) {
      const int m = i / kTileK, kk = i % kTileK;
      xs[m][kk] = (m < mrows && kk < kt) ? x[static_cast<size_t>(m0 + m) * K + k0 + kk] : 0.f;
    }
    __syncthreads();
    if (n0 >= N) continue;
    if (!PACKED) {
      const int8_t* d8 = reinterpret_cast<const int8_t*>(delta);
#pragma unroll 4
      for (int kk = 0; kk < kt; ++kk) {
        const size_t row = static_cast<size_t>(k0 + kk) * N;
        int b[kCols], d[kCols];
        load_base<VEC>(base + row, n0, N, b);
        load_base<VEC>(d8 + row, n0, N, d);
        float w[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) w[j] = __fadd_rn(dq_base(b[j], bs, bz), dq_delta(d[j], ds, dz));
#pragma unroll
        for (int m = 0; m < kRows; ++m) {
          if (m < mrows) {
            const float xv = xs[m][kk];
#pragma unroll
            for (int j = 0; j < kCols; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
          }
        }
      }
    } else {
#pragma unroll 2
      for (int kk = 0; kk < kt; kk += 2) {
        const int k = k0 + kk;
        int b0[kCols], b1[kCols];
        unsigned p[kCols];
        load_base<VEC>(base + static_cast<size_t>(k) * N, n0, N, b0);
        load_base<VEC>(base + static_cast<size_t>(k + 1) * N, n0, N, b1);
        load_bytes<VEC>(delta + static_cast<size_t>(k / 2) * N, n0, N, p);
        float w0[kCols], w1[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          w0[j] = __fadd_rn(dq_base(b0[j], bs, bz), dq_delta(static_cast<int>(p[j] & 0xfu), ds, dz));
          w1[j] = __fadd_rn(dq_base(b1[j], bs, bz), dq_delta(static_cast<int>(p[j] >> 4), ds, dz));
        }
#pragma unroll
        for (int m = 0; m < kRows; ++m) {
          if (m < mrows) {
            const float x0 = xs[m][kk], x1 = xs[m][kk + 1];
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
              acc[m][j] = fmaf(x0, w0[j], acc[m][j]);
              acc[m][j] = fmaf(x1, w1[j], acc[m][j]);
            }
          }
        }
      }
    }
  }

  if (n0 >= N) return;
  float* o = out + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    if (m < mrows) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (n0 + j < N) o[static_cast<size_t>(m0 + m) * N + n0 + j] = acc[m][j];
    }
  }
}

// y[i] = sum over splits s = 0, 1, ... of ws[s][i], in that order.
__global__ void splitk_reduce(const float* __restrict__ ws, float* __restrict__ y,
                              int splits, size_t mn) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[static_cast<size_t>(z) * mn + i];
  y[i] = s;
}

template <bool PACKED>
int launch(const float* x, const int8_t* base, const uint8_t* delta, float* y,
           float* ws, int M, int K, int N, float bs, float bz, float ds, float dz,
           int splits, int kchunk, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kRows - 1) / kRows, splits);
  float* out = splits > 1 ? ws : y;
  if (vec)
    dq_matmul_kernel<PACKED, true><<<grid, kThreads, 0, s>>>(x, base, delta, out, M, K, N, bs, bz, ds, dz, kchunk);
  else
    dq_matmul_kernel<PACKED, false><<<grid, kThreads, 0, s>>>(x, base, delta, out, M, K, N, bs, bz, ds, dz, kchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t mn = static_cast<size_t>(M) * N;
  splitk_reduce<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, s>>>(ws, y, splits, mn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y (M, N) = x (M, K) @ dq(base (K, N) int8, delta (K, N) int8).
// ws holds splits * M * N floats when splits > 1 (unused otherwise).
// Returns cudaGetLastError() after the launches (0 on success).
int dequant_matmul_int8(const float* x, const int8_t* base, const int8_t* delta,
                        float* y, float* ws, int M, int K, int N,
                        float bs, float bz, float ds, float dz,
                        int splits, int kchunk, int vec, void* stream) {
  return launch<false>(x, base, reinterpret_cast<const uint8_t*>(delta), y, ws, M, K, N,
                       bs, bz, ds, dz, splits, kchunk, vec, stream);
}

// As dequant_matmul_int8 with delta (K/2, N) uint8, two nibbles per byte.
// K, kchunk even.
int dequant_matmul_int4(const float* x, const int8_t* base, const uint8_t* packed,
                        float* y, float* ws, int M, int K, int N,
                        float bs, float bz, float ds, float dz,
                        int splits, int kchunk, int vec, void* stream) {
  return launch<true>(x, base, packed, y, ws, M, K, N, bs, bz, ds, dz, splits, kchunk,
                      vec, stream);
}

}  // extern "C"
