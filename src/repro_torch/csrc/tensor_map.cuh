// TMA tensor maps over the (B, S, heads, dh) views of the attention kernels,
// encoded on the host by the driver's cuTensorMapEncodeTiled, which is found
// at run time (no -lcuda). Header only; included by flash_attention_sm90.cu
// and flash_attention.cu.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums
#include <cuda_runtime.h>

namespace tensor_map {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map (dh, heads, positions, batch) over a (B, S, heads, dh) view of
// elem_bytes-byte elements with element strides sb, ss, sh; boxes of
// box_cols columns, one head, box_rows positions. A dimension of size 1
// takes a natural stride (its coordinate is always 0), so views that torch
// gives any stride there are accepted. Positions past S read as zeros.
// Returns 0, -1 when the driver has no encoder, or -1000 - r when the map is
// refused with driver result r.
inline int make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem_bytes,
                    int B, int S, int heads, int dh, long long sb, long long ss, long long sh,
                    int box_cols, int box_rows, CUtensorMapSwizzle swz) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return -1;
  if (heads == 1) sh = dh;
  if (B == 1) sb = ss * S;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * elem_bytes,
                                 static_cast<cuuint64_t>(ss) * elem_bytes,
                                 static_cast<cuuint64_t>(sb) * elem_bytes};
  const cuuint32_t boxes[4] = {static_cast<cuuint32_t>(box_cols), 1,
                               static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(map, type, 4, const_cast<void*>(base), dims, strides, boxes, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - static_cast<int>(r);
}

}  // namespace tensor_map
