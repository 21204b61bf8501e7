// What the stem grad-W kernels of conv.cu, conv_mma.cu and conv_resnet.cu
// share: the 8x8 stem's sizes, the cp.async copies and the staging helpers
// that spread them over a block, mma.sync and ldmatrix, and the
// fixed-order sum of the blocks' partials.  Each source includes it into
// its own anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kK = 8;                      // kernel size
constexpr int kS = 4;                      // stride
constexpr int kF = 32;                     // output features

// The staging helpers below spread their work over a block of kResWarps
// warps (the ResNet stem's block, and the bf16 8x8 stem's).
constexpr int kResWarps = 8;
constexpr int kResThreads = 32 * kResWarps;

using bf16 = __nv_bfloat16;

constexpr int kResMaxStages = 8;  // a ring's stages at most (res_wait_pending)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// cp.async.wait_group takes an immediate: waits until at most `pending`
// of this thread's groups are in flight.
__device__ __forceinline__ void res_wait_pending(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

template <int BYTES>
__device__ __forceinline__ void res_runs_vec(bf16* dst, int dpl, int drow,
                                             const bf16* src, long long spl,
                                             long long srow, int planes,
                                             int rows, int len) {
  constexpr int kPer = BYTES / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < planes * rows; i += kResWarps) {
    const int p = i / rows, r = i - p * rows;
    bf16* d = dst + p * dpl + r * drow;
    const bf16* s = src + p * spl + r * srow;
    for (int v = lane * kPer; v < len; v += 32 * kPer) {
      if (BYTES == 16)
        cp_async16(d + v, s + v);
      else
        cp_async<BYTES>(reinterpret_cast<float*>(d + v),
                        reinterpret_cast<const float*>(s + v));
    }
  }
}

// Copies planes x rows runs of `len` elements, run (p, r) from
// src + p*spl + r*srow to dst + p*dpl + r*drow, one warp a run: by cp.async
// of 16, 8 or 4 bytes as every run's alignment allows, else element by
// element.
__device__ __forceinline__ void res_runs(bf16* dst, int dpl, int drow,
                                         const bf16* src, long long spl,
                                         long long srow, int planes,
                                         int rows, int len) {
  const unsigned long long bits =
      reinterpret_cast<unsigned long long>(src) | smem_addr(dst) |
      static_cast<unsigned long long>(spl * 2) |
      static_cast<unsigned long long>(srow * 2) |
      static_cast<unsigned>(dpl * 2) | static_cast<unsigned>(drow * 2) |
      static_cast<unsigned>(len * 2);
  if ((bits & 15) == 0) {
    res_runs_vec<16>(dst, dpl, drow, src, spl, srow, planes, rows, len);
  } else if ((bits & 7) == 0) {
    res_runs_vec<8>(dst, dpl, drow, src, spl, srow, planes, rows, len);
  } else if ((bits & 3) == 0) {
    res_runs_vec<4>(dst, dpl, drow, src, spl, srow, planes, rows, len);
  } else {
    for (int i = threadIdx.x; i < planes * rows * len; i += kResThreads) {
      const int run = i / len, v = i - run * len;
      const int p = run / rows, r = run - p * rows;
      dst[p * dpl + r * drow + v] = src[p * spl + r * srow + v];
    }
  }
}

// Zeroes rows [r0, r1) of `drow` elements (a multiple of 8) in each of
// `planes` planes `dpl` elements apart (a multiple of 8).
__device__ __forceinline__ void res_zero_runs(bf16* dst, int dpl, int drow,
                                              int planes, int r0, int r1) {
  const int n = (r1 - r0) * (drow / 8);
  for (int i = threadIdx.x; i < planes * n; i += kResThreads) {
    const int p = i / n;
    reinterpret_cast<uint4*>(dst + p * dpl + r0 * drow)[i - p * n] =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

template <bool TRANS>
__device__ __forceinline__ void res_ldmatrix_x4(unsigned (&r)[4],
                                                const bf16* p) {
  if constexpr (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  }
}

__device__ __forceinline__ void res_mma(float (&c)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// dw[o] = sum over blocks of partial[block][o], blocks in index order.
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ dw, int outputs,
                                       int num_blocks) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= outputs) return;
  float s = 0.f;
  for (int b = 0; b < num_blocks; ++b) s += partial[(size_t)b * outputs + o];
  dw[o] = s;
}

}  // namespace
