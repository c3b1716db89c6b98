// Fused dequantize-and-matmul on compressed weights, for Hopper (sm_90a).
//
// Replaces the TPU kernels in src/repro/kernels/dequant_matmul.py:
//   dequant_matmul_pallas      (:60, body _dq_matmul_kernel)       -> dq_matmul_kernel<false, ...>
//   dequant_matmul_int4_pallas (:135, body _dq_matmul_int4_kernel) -> dq_matmul_kernel<true, ...>
//
//   y = x @ ((base - bz) * bs + (delta - dz + 0.5) * ds)
//
// x is (M, K) float32, base is (K, N) int8, delta is (K, N) int8 or, packed,
// (K/2, N) uint8 with row 2k in the low nibble and row 2k+1 in the high one
// (the layout of ops.pack_int4). The four quantization parameters are
// scalars; the operand normalisation of core/compressed.py (constant base:
// bz = -129, bs = mid; zero-bit delta: ds = 2*mid) passes through unchanged.
//
// What bounds it: decode runs M = 4 rows, so each weight is used by 4
// FMAs while 2 bytes (int8 delta) or 1.5 bytes (int4 delta) of it
// are read: by operation counts the kernel is bound by the bytes of the
// codes over device memory (3.35 TB/s on an H100 SXM). Instruction issue
// comes close behind: with the reference's rounding every weight costs
// two byte permutes, six float adds and multiplies (four where the
// zero-points fold, below) and 4 FMAs, against 128 lanes a clock an SM,
// about 80 us for the LM head's 190 M weights, near its 85 us (int4) and
// 113 us (int8) of bytes.
//
// What the design does about it:
// * One launch a call, no workspace. A block owns a strip of 16*tn output
//   columns for 4 rows of x (decode's batch). Its 256 threads are tn
//   columns of threads (16 columns each, one 16-byte load a code row) by
//   256/tn rows of threads that split the block's K range row by row;
//   their partial sums are added in shared memory in a fixed order.
// * Narrow weights (N <= 8192 at decode) split K across the blocks of a
//   thread block cluster (cudaLaunchKernelEx with a cluster dimension).
//   Block 0 of the cluster adds the others' sums through distributed
//   shared memory in rank order and writes y once: deterministic, no
//   atomics, no second pass. The launch plan (row groups, tn, strips,
//   cluster, rows of K a block) is kernels/dequant_matmul.py `plan`,
//   measured on the card; the kernel takes its grid as given.
// * Bytes in flight without registers: on the 16-byte path each thread
//   copies its own code chunks with cp.async into a 4-stage ring in shared
//   memory, 3 batches (2 int8 rows or 1 int4 row pair each) ahead of the
//   one it computes, and reads back only what it copied, so the ring needs
//   no block barrier: up to 192 bytes a thread, 48 KB a block (int8). The
//   first copies go out before x is staged. Shapes with N % 16 != 0,
//   unaligned operands or zero-points that do not fold (below) take byte
//   loads into registers instead, one row (pair) ahead (VEC = false),
//   chosen by the wrapper.
// * No I2F: a code byte u becomes the float 2^23 + u by one byte permute
//   (0x4B0000uu); signed int8 codes are first offset by 128 (xor 0x80).
//   On the 16-byte path the wrapper has found 2^23 + 128 + zp exact
//   (integer zero-points: all that core/compressed.py produces), so one
//   float subtraction of that sum gives the reference's code - zp, rounded
//   the same (FOLD; 2-9 us less than two subtractions at the LM head,
//   PERF.md). The byte path subtracts 2^23 (+ 128), exact, then zp. The
//   rest of the reference's formula runs as before, explicitly rounded (no
//   FMA contraction), and IEEE float32 FMAs accumulate against x. No
//   tensor cores and no TF32.
// * x is staged in shared memory once a block (8192 floats: 2048 K rows at
//   4 rows of x) and read as broadcasts.
// * Ragged N is masked column by column in the byte-load path; ragged K by
//   predicated copies and loads; M beyond 4 runs row groups on grid.y.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;           // rows of x a block (a row group)
constexpr int kCols = 16;        // output columns per thread: one 16-byte load a code row
constexpr int kSmemFloats = 8192;  // the x tile, then the partial sums (32 KB)
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kStages = 4;         // cp.async ring: batches of a thread in flight + 1

// 2^23 + 128 and 2^23: the float of 0x4B0000uu less these is the code.
constexpr float kSignedOffset = 8388736.f;
constexpr float kUnsignedOffset = 8388608.f;

// Byte j of `word` as the float 2^23 + byte (exact). `magic` holds
// 0x4B000000 as a kernel argument the compiler cannot fold, so the byte
// selector can take the permute's one immediate operand; left a constant,
// 0x4B000000 takes it and every selector is moved into a register before
// each use.
template <int J>
__device__ __forceinline__ float byte_float(uint32_t word, uint32_t magic) {
  return __int_as_float(__byte_perm(word, magic, 0x7440 | J));
}

// The quantization parameters with the 2^23 offsets of byte_float. With
// FOLD (the 16-byte path) the wrapper has checked that 2^23 + 128 + bz
// (and the delta's offset + dz) are exact floats; then a - (2^23 + 128 +
// bz) is the same real number as c - bz and rounds to the same float, one
// subtraction fewer a code.
struct Scales {
  float bs, bz, boff, ds, dz, doff;
};

template <bool FOLD>
__device__ __forceinline__ float dq_base(float a, const Scales& q) {
  const float c_bz = FOLD ? __fsub_rn(a, q.boff) : __fsub_rn(__fsub_rn(a, q.boff), q.bz);
  return __fmul_rn(c_bz, q.bs);
}

template <bool FOLD>
__device__ __forceinline__ float dq_delta(float a, const Scales& q) {
  const float c_dz = FOLD ? __fsub_rn(a, q.doff) : __fsub_rn(__fsub_rn(a, q.doff), q.dz);
  return __fmul_rn(__fadd_rn(c_dz, 0.5f), q.ds);
}

// The 16 code bytes of columns n0..n0+15 of one row, loaded byte by byte
// (any N, any alignment); bytes past N read 0.
__device__ __forceinline__ uint4 load16(const uint8_t* row, int n0, int N) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    if (n0 + j < N) v[j / 4] |= static_cast<uint32_t>(__ldg(row + n0 + j)) << (8 * (j % 4));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void words(uint4 v, uint32_t (&w)[4]) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// w[16] = dq(base codes) + dq(delta codes), 4 codes a word; the base words
// hold signed int8 codes offset to unsigned (xor 0x80).
template <bool FOLD>
__device__ __forceinline__ void dequant16(const uint32_t (&bw)[4], const uint32_t (&dw)[4],
                                          const Scales& q, uint32_t magic, float (&w)[kCols]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[4 * i + 0] = __fadd_rn(dq_base<FOLD>(byte_float<0>(bw[i], magic), q),
                             dq_delta<FOLD>(byte_float<0>(dw[i], magic), q));
    w[4 * i + 1] = __fadd_rn(dq_base<FOLD>(byte_float<1>(bw[i], magic), q),
                             dq_delta<FOLD>(byte_float<1>(dw[i], magic), q));
    w[4 * i + 2] = __fadd_rn(dq_base<FOLD>(byte_float<2>(bw[i], magic), q),
                             dq_delta<FOLD>(byte_float<2>(dw[i], magic), q));
    w[4 * i + 3] = __fadd_rn(dq_base<FOLD>(byte_float<3>(bw[i], magic), q),
                             dq_delta<FOLD>(byte_float<3>(dw[i], magic), q));
  }
}

// acc[m][j] += x[m] * w[j] for the 4 rows of x at one K row (xk: 4 floats).
__device__ __forceinline__ void fma_row(float (&acc)[kRows][kCols], const float (&w)[kCols],
                                        const float* xk) {
  const float4 v = *reinterpret_cast<const float4*>(xk);
  const float xv[kRows] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = fmaf(xv[m], w[j], acc[m][j]);
}

// The byte-load path's base and delta code rows t0 + kk + u*tk (u < B)
// of an int8 delta, zeros past kt.
template <int B>
__device__ __forceinline__ void fetch_rows(const uint8_t* base, const uint8_t* delta, int t0,
                                           int kk, int kt, int tk, int n0, int N, uint4 (&b)[B],
                                           uint4 (&d)[B]) {
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const int r = kk + u * tk;
    b[u] = d[u] = make_uint4(0u, 0u, 0u, 0u);
    if (r < kt) {
      const size_t off = static_cast<size_t>(t0 + r) * N;
      b[u] = load16(base + off, n0, N);
      d[u] = load16(delta + off, n0, N);
    }
  }
}

// The byte-load path's base rows t0 + 2r, t0 + 2r + 1 and packed delta
// row t0/2 + r of row pairs r = pp + u*tk (u < B), zeros past kp pairs.
template <int B>
__device__ __forceinline__ void fetch_pairs(const uint8_t* base, const uint8_t* delta, int t0,
                                            int pp, int kp, int tk, int n0, int N,
                                            uint4 (&b0)[B], uint4 (&b1)[B], uint4 (&p)[B]) {
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const int r = pp + u * tk;
    b0[u] = b1[u] = p[u] = make_uint4(0u, 0u, 0u, 0u);
    if (r < kp) {
      const size_t row = static_cast<size_t>(t0 + 2 * r);
      b0[u] = load16(base + row * N, n0, N);
      b1[u] = load16(base + (row + 1) * N, n0, N);
      p[u] = load16(delta + (row / 2) * N, n0, N);
    }
  }
}

// The codes of the batch at kk of the tile at t0 on the byte-load path:
// int8 rows (b0, d) or int4 row pairs (b0, b1 and the packed d); nothing
// for a thread past N.
template <bool PACKED, int B>
__device__ __forceinline__ void fetch(const uint8_t* base, const uint8_t* delta, int t0, int kk,
                                      int kt, int tk, int n0, int N, uint4 (&b0)[B],
                                      uint4 (&b1)[B], uint4 (&d)[B]) {
  if (n0 >= N) return;
  if (PACKED)
    fetch_pairs(base, delta, t0, kk, kt / 2, tk, n0, N, b0, b1, d);
  else
    fetch_rows(base, delta, t0, kk, kt, tk, n0, N, b0, d);
}

// The code rows (int8, 2 a batch) or row pairs (int4, 1 a batch) of the
// 16-byte path go through a ring of kStages batches in shared memory, each
// thread copying its own 16-byte chunks with cp.async and reading back only
// what it copied, so no block barrier is needed: kStages - 1 batches are
// in flight while one is computed, with no registers held for them.
template <bool PACKED>
struct Ring {
  static constexpr int kBatch = PACKED ? 1 : 2;   // rows or row pairs a stage
  static constexpr int kChunks = PACKED ? 3 : 2;  // 16-byte chunks a row (pair)
  static constexpr int kBytes = kStages * kBatch * kChunks * kThreads * 16;
};

__device__ __forceinline__ void cp_async16(uint4* dst, const uint8_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Chunk c of row u of this thread in ring slot `slot`: consecutive threads
// own consecutive 16 bytes, so copies and reads are free of bank conflicts.
template <bool PACKED>
__device__ __forceinline__ uint4* ring_chunk(uint4* ring, int slot, int u, int c) {
  return ring + ((slot * Ring<PACKED>::kBatch + u) * Ring<PACKED>::kChunks + c) * kThreads +
         threadIdx.x;
}

// Copies the batch whose first row (pair) is kk into ring slot `slot`.
template <bool PACKED>
__device__ __forceinline__ void ring_issue(uint4* ring, int slot, const uint8_t* base,
                                           const uint8_t* delta, int t0, int kk, int units,
                                           int tk, int n0, int N) {
#pragma unroll
  for (int u = 0; u < Ring<PACKED>::kBatch; ++u) {
    const int r = kk + u * tk;
    if (r >= units) continue;
    if (PACKED) {
      const size_t row = static_cast<size_t>(t0 + 2 * r);
      cp_async16(ring_chunk<PACKED>(ring, slot, u, 0), base + row * N + n0);
      cp_async16(ring_chunk<PACKED>(ring, slot, u, 1), base + (row + 1) * N + n0);
      cp_async16(ring_chunk<PACKED>(ring, slot, u, 2), delta + (row / 2) * N + n0);
    } else {
      const size_t off = static_cast<size_t>(t0 + r) * N + n0;
      cp_async16(ring_chunk<PACKED>(ring, slot, u, 0), base + off);
      cp_async16(ring_chunk<PACKED>(ring, slot, u, 1), delta + off);
    }
  }
}

// One batch (first row, or row pair, kk of `units`) dequantized and
// multiplied into acc against the staged x (xs: 4 floats a K row).
template <bool PACKED, bool FOLD, int B>
__device__ __forceinline__ void compute(float (&acc)[kRows][kCols], const float* xs,
                                        const Scales& q, uint32_t magic, int kk, int units,
                                        int tk,
                                        const uint4 (&b0)[B], const uint4 (&b1)[B],
                                        const uint4 (&d)[B]) {
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const int r = kk + u * tk;
    if (r < units) {
      uint32_t bw[4], dw[4];
      words(b0[u], bw);
      words(d[u], dw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bw[i] ^= 0x80808080u;
        dw[i] = PACKED ? dw[i] & 0x0F0F0F0Fu : dw[i] ^ 0x80808080u;
      }
      float w[kCols];
      dequant16<FOLD>(bw, dw, q, magic, w);
      fma_row(acc, w, xs + (PACKED ? 2 * r : r) * kRows);
      if (PACKED) {
        words(b1[u], bw);
        words(d[u], dw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          bw[i] ^= 0x80808080u;
          dw[i] = (dw[i] >> 4) & 0x0F0F0F0Fu;
        }
        dequant16<FOLD>(bw, dw, q, magic, w);
        fma_row(acc, w, xs + (2 * r + 1) * kRows);
      }
    }
  }
}

// VEC: the 16-byte path, which folds the zero-points (FOLD = VEC).
template <bool PACKED, bool VEC>
__global__ void __launch_bounds__(kThreads, VEC ? 2 : 1) dq_matmul_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ base,
    const uint8_t* __restrict__ delta, float* __restrict__ y, int M, int K, int N, float bs,
    float bz, float ds, float dz, int tn, int cluster, int kblock, uint32_t magic) {
  __shared__ __align__(16) float smem[kSmemFloats];
  __shared__ float red[kThreads];
  extern __shared__ uint4 ring[];  // Ring<PACKED>::kBytes on the 16-byte path
  constexpr bool FOLD = VEC;
  constexpr int kTileK = kSmemFloats / kRows;  // K rows of x a tile (even)
  constexpr int kBatch = 1;  // rows (pairs) a batch of the byte-load path
  const float doff = PACKED ? kUnsignedOffset : kSignedOffset;
  const Scales q{bs, bz, FOLD ? __fadd_rn(kSignedOffset, bz) : kSignedOffset,
                 ds, dz, FOLD ? __fadd_rn(doff, dz) : doff};
  const int tk = kThreads / tn;  // rows of threads splitting K
  const int tcol = threadIdx.x % tn, trow = threadIdx.x / tn;
  const int bn = tn * kCols;
  const int rank = blockIdx.x % cluster, strip = blockIdx.x / cluster;
  const int n0 = strip * bn + tcol * kCols;
  const int m0 = blockIdx.y * kRows;
  const int mrows = min(kRows, M - m0);
  const int kb = rank * kblock, ke = min(K, kb + kblock);

  float acc[kRows][kCols];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;

  const int step = kBatch * tk;  // rows (int8) or row pairs (int4) a batch
  for (int t0 = kb; t0 < ke; t0 += kTileK) {
    const int kt = min(kTileK, ke - t0);
    const int units = PACKED ? kt / 2 : kt;  // t0 and kt are even for int4
    // The first kStages - 1 batches go into the ring (16-byte path), or the
    // first batch into registers (byte path), before x is staged.
    constexpr int kRing = Ring<PACKED>::kBatch;
    uint4 b0[kBatch], b1[kBatch], d[kBatch], nb0[kBatch], nb1[kBatch], nd[kBatch];
    if (VEC) {
#pragma unroll
      for (int i = 0; i < kStages - 1; ++i) {
        if (n0 < N) ring_issue<PACKED>(ring, i, base, delta, t0, trow + i * kRing * tk, units,
                                       tk, n0, N);
        cp_async_commit();
      }
    } else {
      fetch<PACKED>(base, delta, t0, trow, kt, tk, n0, N, b0, b1, d);
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kRows; ++m)
      for (int kk = threadIdx.x; kk < kt; kk += kThreads)
        smem[kk * kRows + m] = m < mrows ? x[static_cast<size_t>(m0 + m) * K + t0 + kk] : 0.f;
    __syncthreads();
    if (n0 >= N) continue;
    if (VEC) {
      uint4 rb0[kRing], rb1[kRing], rd[kRing];
      for (int j = 0, kk = trow; kk < units; ++j, kk += kRing * tk) {
        ring_issue<PACKED>(ring, (j + kStages - 1) % kStages, base, delta, t0,
                           kk + (kStages - 1) * kRing * tk, units, tk, n0, N);
        cp_async_commit();
        cp_async_wait<kStages - 1>();
        const int slot = j % kStages;
#pragma unroll
        for (int u = 0; u < kRing; ++u) {
          rb0[u] = *ring_chunk<PACKED>(ring, slot, u, 0);
          if (PACKED) {
            rb1[u] = *ring_chunk<PACKED>(ring, slot, u, 1);
            rd[u] = *ring_chunk<PACKED>(ring, slot, u, 2);
          } else {
            rd[u] = *ring_chunk<PACKED>(ring, slot, u, 1);
          }
        }
        compute<PACKED, FOLD>(acc, smem, q, magic, kk, units, tk, rb0, rb1, rd);
      }
      cp_async_wait<0>();
      continue;
    }
    // Byte path: one batch computed while the next one's loads are in flight.
    for (int kk = trow; kk < units; kk += 2 * step) {
      fetch<PACKED>(base, delta, t0, kk + step, kt, tk, n0, N, nb0, nb1, nd);
      compute<PACKED, FOLD>(acc, smem, q, magic, kk, units, tk, b0, b1, d);
      if (kk + step >= units) break;
      fetch<PACKED>(base, delta, t0, kk + 2 * step, kt, tk, n0, N, b0, b1, d);
      compute<PACKED, FOLD>(acc, smem, q, magic, kk + step, units, tk, nb0, nb1, nd);
    }
  }

  // The block's sum, one row of x at a time: the thread rows' partial sums
  // (scratch, tk x bn) are added in a fixed order by every thread at once,
  // 256/bn threads a column each taking every (256/bn)-th thread row, then
  // those slices in order, into part (4 x bn, after the scratch).
  float* part = smem + kThreads * kCols;
  const int per = bn < kThreads ? kThreads / bn : 1;  // threads a column
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    __syncthreads();
    float4* dst = reinterpret_cast<float4*>(smem + trow * bn + tcol * kCols);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dst[i] = make_float4(acc[m][4 * i], acc[m][4 * i + 1], acc[m][4 * i + 2],
                           acc[m][4 * i + 3]);
    __syncthreads();
    if (per == 1) {
      for (int c = threadIdx.x; c < bn; c += kThreads) {
        float s = 0.f;
        for (int r = 0; r < tk; ++r) s += smem[r * bn + c];
        part[m * bn + c] = s;
      }
    } else {
      const int c = threadIdx.x % bn, slice = threadIdx.x / bn;
      float s = 0.f;
      for (int r = slice; r < tk; r += per) s += smem[r * bn + c];
      red[threadIdx.x] = s;
      __syncthreads();
      if (threadIdx.x < bn) {
        s = red[c];
        for (int i = 1; i < per; ++i) s += red[i * bn + c];
        part[m * bn + c] = s;
      }
    }
  }

  if (cluster == 1) {
    __syncthreads();
  } else {
    // Block 0 of the cluster adds the blocks' sums in rank order; the others
    // keep their shared memory until it has read them.
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    if (rank == 0) {
      for (int i = threadIdx.x; i < kRows * bn; i += kThreads) {
        float s = part[i];
        for (int r = 1; r < cluster; ++r) s += cl.map_shared_rank(part, r)[i];
        const int m = i / bn, n = strip * bn + i % bn;
        if (m < mrows && n < N) y[static_cast<size_t>(m0 + m) * N + n] = s;
      }
    }
    cl.sync();
    return;
  }
  for (int i = threadIdx.x; i < kRows * bn; i += kThreads) {
    const int m = i / bn, n = strip * bn + i % bn;
    if (m < mrows && n < N) y[static_cast<size_t>(m0 + m) * N + n] = part[i];
  }
}

struct Call {
  const float* x;
  const uint8_t* base;
  const uint8_t* delta;
  float* y;
  int M, K, N;
  float bs, bz, ds, dz;
  int groups, tn, strips, cluster, kblock;
};

template <bool PACKED, bool VEC>
cudaError_t run(const Call& c, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(c.strips * c.cluster),
                     static_cast<unsigned>(c.groups), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = VEC ? Ring<PACKED>::kBytes : 0;
  if (VEC) {  // the ring is above the default 48 KB: opt in once a device
    static unsigned long long opted = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && dev < 64 && !(opted >> dev & 1ull)) {
      err = cudaFuncSetAttribute(dq_matmul_kernel<PACKED, VEC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 Ring<PACKED>::kBytes);
      if (err == cudaSuccess) opted |= 1ull << dev;
    }
    if (err != cudaSuccess) return err;
  }
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(c.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dq_matmul_kernel<PACKED, VEC>, c.x, c.base, c.delta, c.y,
                            c.M, c.K, c.N, c.bs, c.bz, c.ds, c.dz, c.tn, c.cluster, c.kblock,
                            0x4B000000u);
}

// Launches the plan as given, once it covers y and K: every row group,
// strip and K range of a cluster rank non-empty.
template <bool PACKED>
int launch(const Call& c, int vec, void* stream) {
  const long long kb = c.kblock, bn = static_cast<long long>(c.tn) * kCols;
  const bool tn_ok = c.tn == 2 || c.tn == 4 || c.tn == 8 || c.tn == 16 || c.tn == 32;
  const bool k_ok = c.kblock > 0 && (!PACKED || (c.kblock % 2 == 0 && c.K % 2 == 0)) &&
                    kb * (c.cluster - 1) < c.K && kb * c.cluster >= c.K;
  const bool mn_ok = c.M > 0 && c.N > 0 && c.groups > 0 && c.groups <= 65535 &&
                     (c.groups - 1) * kRows < c.M && c.groups * kRows >= c.M &&
                     c.strips > 0 && (c.strips - 1) * bn < c.N && c.strips * bn >= c.N;
  if (!tn_ok || !k_ok || !mn_ok || c.cluster < 1 || c.cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = vec ? run<PACKED, true>(c, s) : run<PACKED, false>(c, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// y (M, N) = x (M, K) @ dq(base (K, N) int8, delta (K, N) int8), in one
// launch of the plan: a grid of (strips * cluster, groups) blocks, each
// taking 4 rows of x and 16 * tn columns, cluster blocks splitting K in
// ranges of kblock rows by rank. vec: the 16-byte path (N % 16 == 0,
// operands 16-byte aligned, and 2^23 + 128 + bz and the delta's offset +
// dz exact floats, see Scales). Returns the CUDA error (0 on success).
int dequant_matmul_int8(const float* x, const int8_t* base, const int8_t* delta, float* y,
                        int M, int K, int N, float bs, float bz, float ds, float dz, int groups,
                        int tn, int strips, int cluster, int kblock, int vec, void* stream) {
  const Call c{x, reinterpret_cast<const uint8_t*>(base), reinterpret_cast<const uint8_t*>(delta),
               y, M, K, N, bs, bz, ds, dz, groups, tn, strips, cluster, kblock};
  return launch<false>(c, vec, stream);
}

// As dequant_matmul_int8 with delta (K/2, N) uint8, two nibbles a byte;
// K and kblock even.
int dequant_matmul_int4(const float* x, const int8_t* base, const uint8_t* packed, float* y,
                        int M, int K, int N, float bs, float bz, float ds, float dz, int groups,
                        int tn, int strips, int cluster, int kblock, int vec, void* stream) {
  const Call c{x, reinterpret_cast<const uint8_t*>(base), packed, y, M, K, N, bs, bz, ds, dz,
               groups, tn, strips, cluster, kblock};
  return launch<true>(c, vec, stream);
}

}  // extern "C"
