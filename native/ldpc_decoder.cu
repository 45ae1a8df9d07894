// Layered scaled min-sum LDPC decoder with per-codeblock CRC early stop,
// called from JAX through the XLA FFI (custom call target
// "srsran_ldpc_decode_es", bound in ops/ldpc/decode_cuda.py).
//
// Same arithmetic as the XLA program `ops/ldpc/decode.py:ldpc_decode_es`
// (int8 LLR saturation rules, first-index argmin, float32 scaling with
// round-half-up) so the two are bit-exact; see that file for the reference
// citations.
//
// One thread block decodes `group` codeblocks; thread t serves lane
// t % z of codeblock t / z, in the check domain of every layer, so the
// lifted cyclic shifts are index arithmetic on shared memory.  Each codeblock
// keeps its soft values (n_full x z) and all check-to-variable messages
// (edges x z, int8) in shared memory for the whole decode.  After each full
// sweep of the layers the codeblock CRC is checked on the systematic hard
// decisions; a codeblock whose CRC passes writes its output and stops.

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kLlrMax = 120;
constexpr int kLlrInfty = 127;
constexpr int kMaxEdges = 320;   // BG1 has 316 non-zero base-graph entries.
constexpr int kMaxRows = 46;     // BG1 check rows.
constexpr int kMaxInfoCols = 22; // BG1 systematic columns.

struct GraphTables {
  int16_t row_start[kMaxRows + 1];
  int16_t col[kMaxEdges];
  int16_t shift[kMaxEdges];
};

__device__ __forceinline__ int is_inf(int a) {
  return a == kLlrInfty || a == -kLlrInfty;
}

// LLR saturated difference a - b (reference log_likelihood_ratio rules).
__device__ __forceinline__ int sat_sub(int a, int b) {
  if (a == b) return 0;
  if (is_inf(a)) return a;
  if (is_inf(b)) return -b;
  return max(-kLlrMax, min(kLlrMax, a - b));
}

// LLR promotion sum: overflow promotes to the fixed-bit value.
__device__ __forceinline__ int promotion_sum(int a, int b) {
  if (a == -b) return 0;
  if (is_inf(a)) return a;
  if (is_inf(b)) return b;
  int s = a + b;
  if (s > kLlrMax) return kLlrInfty;
  if (s < -kLlrMax) return -kLlrInfty;
  return s;
}

// r * x mod g over GF(2); bit i of r is the coefficient of x^i.
__device__ __forceinline__ uint32_t crc_mulx(uint32_t r, int order,
                                              uint32_t poly) {
  r <<= 1;
  if ((r >> order) & 1u) r ^= poly;
  return r;
}

// a * b mod g.
__device__ __forceinline__ uint32_t crc_mulmod(uint32_t a, uint32_t b,
                                                int order, uint32_t poly) {
  uint32_t acc = 0;
  for (int i = 0; i < order; ++i) {
    if ((b >> i) & 1u) acc ^= a;
    a = crc_mulx(a, order, poly);
  }
  return acc;
}

__device__ __forceinline__ int scale_magnitude(int mag, float scaling) {
  return static_cast<int>(
      floorf(__fadd_rn(__fmul_rn(static_cast<float>(mag), scaling), 0.5f)));
}

__global__ void ldpc_decode_es_kernel(
    const int8_t* __restrict__ llrs, int8_t* __restrict__ soft_out,
    int32_t* __restrict__ ok_out, int32_t* __restrict__ iters_out,
    const __grid_constant__ GraphTables tables, int num_cb, int z, int nv,
    int m, int kb, int e_tot, int group, int max_iterations, float scaling,
    int crc_order, uint32_t crc_poly, int crc_covered_bits) {
  extern __shared__ int8_t smem[];
  __shared__ uint32_t crc_acc[32];

  const int g = threadIdx.x / z;
  const int lane = threadIdx.x - g * z;
  const int cb = blockIdx.x * group + g;
  int8_t* soft = smem + g * (nv + e_tot) * z;
  int8_t* c2v = soft + nv * z;
  bool active = cb < num_cb;

  // Soft values in the variable domain: two punctured systematic columns
  // at LLR 0, then the received codeword.
  if (active) {
    const int8_t* in = llrs + static_cast<int64_t>(cb) * (nv - 2) * z;
    soft[lane] = 0;
    soft[z + lane] = 0;
    for (int c = 2; c < nv; ++c) soft[c * z + lane] = in[(c - 2) * z + lane];
    for (int e = 0; e < e_tot; ++e) c2v[e * z + lane] = 0;
  }

  // CRC basis of this thread's systematic positions k = c * z + lane:
  // x^(kp - 1 - k) mod g, the same rows as ops/crc.py:crc_zero_basis.
  uint32_t basis[kMaxInfoCols];
  {
    uint32_t xz = 1;
    for (int i = 0; i < z; ++i) xz = crc_mulx(xz, crc_order, crc_poly);
    int c_last = lane < crc_covered_bits ? (crc_covered_bits - 1 - lane) / z
                                         : -1;
    uint32_t r = 1;
    if (c_last >= 0) {
      for (int i = 0; i < crc_covered_bits - 1 - (c_last * z + lane); ++i)
        r = crc_mulx(r, crc_order, crc_poly);
    }
#pragma unroll
    for (int c = kMaxInfoCols - 1; c >= 0; --c) {
      if (c <= c_last) {
        basis[c] = r;
        r = crc_mulmod(r, xz, crc_order, crc_poly);
      } else {
        basis[c] = 0;
      }
    }
  }
  __syncthreads();

  for (int it = 0; it < max_iterations; ++it) {
    for (int r = 0; r < m; ++r) {
      if (active) {
        const int e0 = tables.row_start[r];
        const int e1 = tables.row_start[r + 1];
        int min1 = kLlrInfty + 1, min2 = kLlrInfty + 1, argmin = e0;
        int parity = 0;
        for (int e = e0; e < e1; ++e) {
          int idx = lane + tables.shift[e];
          if (idx >= z) idx -= z;
          const int v = sat_sub(soft[tables.col[e] * z + idx], c2v[e * z + lane]);
          const int a = abs(v);
          if (a < min1) {
            min2 = min1;
            min1 = a;
            argmin = e;
          } else if (a < min2) {
            min2 = a;
          }
          parity ^= (v < 0);
        }
        const int m1 = scale_magnitude(min(min1, kLlrMax), scaling);
        const int m2 = scale_magnitude(min(min2, kLlrMax), scaling);
        // Columns are unique within a row and each (column, position) of
        // this layer belongs to exactly one thread, so the update pass needs
        // no barrier after the min pass.
        for (int e = e0; e < e1; ++e) {
          int idx = lane + tables.shift[e];
          if (idx >= z) idx -= z;
          const int pos = tables.col[e] * z + idx;
          const int v = sat_sub(soft[pos], c2v[e * z + lane]);
          const int mag = e == argmin ? m2 : m1;
          const int msg = (parity ^ (v < 0)) ? -mag : mag;
          soft[pos] = static_cast<int8_t>(promotion_sum(msg, v));
          c2v[e * z + lane] = static_cast<int8_t>(msg);
        }
      }
      __syncthreads();
    }

    if (threadIdx.x < group) crc_acc[threadIdx.x] = 0;
    __syncthreads();
    if (active) {
      uint32_t acc = 0;
#pragma unroll
      for (int c = 0; c < kMaxInfoCols; ++c) {
        if (c < kb && soft[c * z + lane] <= 0) acc ^= basis[c];
      }
      if (acc) atomicXor(&crc_acc[g], acc);
    }
    __syncthreads();
    if (active && crc_acc[g] == 0) {
      int8_t* out = soft_out + static_cast<int64_t>(cb) * kb * z;
      for (int c = 0; c < kb; ++c) out[c * z + lane] = soft[c * z + lane];
      if (lane == 0) {
        ok_out[cb] = 1;
        iters_out[cb] = it + 1;
      }
      active = false;
    }
    if (__syncthreads_and(!active)) return;
  }

  if (active) {
    int8_t* out = soft_out + static_cast<int64_t>(cb) * kb * z;
    for (int c = 0; c < kb; ++c) out[c * z + lane] = soft[c * z + lane];
    if (lane == 0) {
      ok_out[cb] = 0;
      iters_out[cb] = max_iterations;
    }
  }
}

ffi::Error LdpcDecodeEs(cudaStream_t stream, ffi::Buffer<ffi::S8> llrs,
                        ffi::ResultBuffer<ffi::S8> soft_out,
                        ffi::ResultBuffer<ffi::S32> ok_out,
                        ffi::ResultBuffer<ffi::S32> iters_out, int32_t z,
                        int32_t nv, int32_t kb, int32_t group,
                        int32_t max_iterations, float scaling,
                        int32_t crc_order, int32_t crc_poly,
                        int32_t crc_covered_bits,
                        ffi::Span<const int32_t> row_start,
                        ffi::Span<const int32_t> cols,
                        ffi::Span<const int32_t> shifts) {
  const int m = static_cast<int>(row_start.size()) - 1;
  const int e_tot = static_cast<int>(cols.size());
  if (m < 1 || m > kMaxRows || e_tot > kMaxEdges ||
      static_cast<int>(shifts.size()) != e_tot || kb > kMaxInfoCols ||
      group < 1 || group > 32 || group * z > 1024) {
    return ffi::Error::InvalidArgument("ldpc_decode_es: bad graph tables");
  }
  const int64_t num_cb = static_cast<int64_t>(ok_out->element_count());
  if (num_cb == 0) return ffi::Error::Success();
  if (static_cast<int64_t>(llrs.element_count()) != num_cb * (nv - 2) * z) {
    return ffi::Error::InvalidArgument("ldpc_decode_es: bad LLR shape");
  }

  GraphTables tables;
  for (int r = 0; r <= m; ++r) tables.row_start[r] = static_cast<int16_t>(row_start[r]);
  for (int e = 0; e < e_tot; ++e) {
    tables.col[e] = static_cast<int16_t>(cols[e]);
    tables.shift[e] = static_cast<int16_t>(shifts[e]);
  }

  const size_t smem = static_cast<size_t>(group) * (nv + e_tot) * z;
  cudaError_t err = cudaFuncSetAttribute(
      ldpc_decode_es_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("ldpc_decode_es: ") +
                                cudaGetErrorString(err));
  }
  const int blocks = static_cast<int>((num_cb + group - 1) / group);
  ldpc_decode_es_kernel<<<blocks, group * z, smem, stream>>>(
      llrs.typed_data(), soft_out->typed_data(), ok_out->typed_data(),
      iters_out->typed_data(), tables, static_cast<int>(num_cb), z, nv, m, kb,
      e_tot, group, max_iterations, scaling, crc_order,
      static_cast<uint32_t>(crc_poly), crc_covered_bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("ldpc_decode_es: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    SrsranLdpcDecodeEs, LdpcDecodeEs,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S8>>()
        .Ret<ffi::Buffer<ffi::S8>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Attr<int32_t>("z")
        .Attr<int32_t>("nv")
        .Attr<int32_t>("kb")
        .Attr<int32_t>("group")
        .Attr<int32_t>("max_iterations")
        .Attr<float>("scaling")
        .Attr<int32_t>("crc_order")
        .Attr<int32_t>("crc_poly")
        .Attr<int32_t>("crc_covered_bits")
        .Attr<ffi::Span<const int32_t>>("row_start")
        .Attr<ffi::Span<const int32_t>>("cols")
        .Attr<ffi::Span<const int32_t>>("shifts"));
