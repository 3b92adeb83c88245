// int8 x int8 -> int32 matrix product, dense and as an implicit-GEMM
// convolution, written for Hopper (sm_90a) with wgmma.
//
// Replaces the two Pallas TPU kernels of the int8 probe,
// perf/pallas_int8_matmul_probe.py :: pallas_int8_mm (:44, one full-K dot
// per 512 x 512 tile) and :: pallas_int8_mm_acc (:141, K blocked by 1024
// and summed in an int32 VMEM scratch over a sequential grid axis). Both
// compute C = A . B with int8 operands and int32 sums; they differ only in
// how the TPU grid walks K. Here K is a loop inside each block and the
// int32 sums stay in registers, which is what K3's "arbitrary" grid axis
// becomes on a GPU, so one kernel ports both.
//
// Three entry points share one mainloop:
//
//   int8_mm_launch              C (M, N) = A (M, K) . B, with B given as
//                               its transpose Bt (N, K), row-major: a 1 x 1
//                               convolution over an (1, M, 1, K) image;
//   int8_conv2d_launch          Y (n, ho, wo, cout) int32 = conv(X (n, h, w,
//                               c), W (cout, kh, kw, c)), stride (sh, sw),
//                               zero padding (ph, pw): the GEMM with M =
//                               n*ho*wo, N = cout, K = kh*kw*c, whose A row m
//                               holds the receptive field of output pixel m,
//                               ordered (i, j, c);
//   int8_conv2d_dequant_launch  the same convolution with the dequantize
//                               fused into the epilogue: float32 Y[m, n] =
//                               ((float(acc) * s1[n]) * s2) + bias[n], each
//                               step rounded to nearest (no FMA), so that it
//                               equals the unfused float32 passes bit for bit.
//
// The convolution never materialises that A (im2col): its rows are
// copied into shared memory straight from X, reading 0 outside the image.
// The caller zero-pads channels (to 8 for the 6-channel first conv, else
// to a multiple of 16) and the rows of W (to a multiple of 16 bytes):
// zeros add nothing to the sums. Padded to 8 and copied in 8-byte
// pieces, that first conv takes half the K stages of 16 channels and
// runs in 2.24 against 3.93 ms at batch 250 (NVIDIA H100 80GB HBM3,
// 700 W).
//
// What bounds it. One fused batch of 250 windows of SAUnet:XL is about
// 20.5 T int8 operations (a multiply-add counts two) over its 21
// quantized convs, against 1,979 TOP/s of dense int8 tensor-core rate:
// about 10 ms. The operands are small next to that (the largest
// activation is 250 x 75 x 216 x 64 bytes, 0.26 GB), so the convs are
// bound by operations, except the head's conv2.0, conv3.0 and conv4.0,
// whose output bytes weigh more. On this card, though, what limits the
// kernel is how fast cp.async can feed shared memory: a gathered A tile
// copies every input byte once per (i, j) tap, and a narrow (cout 32)
// conv does only 32 multiply-adds per byte it copies.
//
// What the design does about it. Only wgmma reaches Hopper's int8 rate:
// a block is two warpgroups, each issuing wgmma.mma_async m64nNk32
// s32.s8.s8 with both operands in shared memory and N the whole block
// width BN (32, 64, 128, 160, 208 or 256, the smallest that covers cout;
// 150 and 200 take a padded tile whose extra columns are masked at the
// store). K runs through a ring of STAGES buffers, copies running
// STAGES - 1 stages ahead of the wgmmas. Each stage is waited for with
// cp.async.wait_group STAGES - 2, fenced to the async proxy
// (fence.proxy.async: cp.async writes through the generic proxy, wgmma
// reads through the async one), and released by one barrier; a stage is
// refilled only after the barrier that follows the wgmma.wait_group of its
// last reader. Two loaders fill the ring:
//
//   Gather  every convolution and the dense product. Row m of the 128-row
//           A tile is the receptive field of output pixel m, ordered
//           (i, j, c), copied 128 K-bytes per stage by every thread in
//           8- or 16-byte pieces (each inside one pixel), into the
//           128-byte-swizzled K-major layout that the wgmma descriptors
//           read: rows 128 bytes apart, 8-row groups 1024 bytes apart,
//           16-byte chunk q of row r at chunk q ^ (r % 8), which also keeps
//           the copies free of bank conflicts. The tap's offset is the same
//           for every row, so a copy costs one add and two range checks.
//   Taps    stride-1 convolutions with cout <= 32, c % 32 == 0 and kernel
//           widths of 9 to 16 (three of the four widest convs): a stage
//           copies each input pixel under a 64-pixel row segment once per
//           kernel row, and every tap reads it from shared memory (see
//           struct Taps), 15 times fewer A bytes at kw 15.
//
// B comes by cp.async too, into the same groups and barrier: at most 256
// rows of weights that stay in L2. TMA for B was built and measured no
// faster (the A copies bound the loop), and it needs mbarriers and a
// tensor map. The epilogue is a template flag on the same kernel: int32
// sums (the exact checks, the probe) or the fused dequantize, which saves
// the four float32 passes over the output that the caller made before.
// Blocks of the narrow tiles run two to an SM.
//
// Before: the first version of this kernel (warp-level mma.sync m16n8k32,
// 32 x 32 warp tiles, two 64-byte stages, cp.async.wait_group 0 every
// step, int32 out only) ran the 21 convs of one batch of 250 in 74.17 ms
// and the 4096^3 probe in 0.563 ms, 244 TOP/s (NVIDIA H100 80GB HBM3,
// 700 W).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int THREADS = 256;  // two warpgroups
constexpr int BK = 128;       // K bytes per gathered stage: one swizzled row
constexpr int STAGES = 3;     // buffers in the shared-memory ring
constexpr int TAPS_MIN_KW = 9;  // kernel widths that take the tap loader
constexpr int MAX_DEVICES = 64;

struct Geom {
  int h, w, c;                  // input (n, h, w, c), c % 8 == 0
  int kh, kw, sh, sw, ph, pw;
  int ho, wo;
  int m;                        // rows: n * ho * wo
  int n;                        // columns: cout
  int k;                        // depth: kh * kw * c
  int ldb;                      // bytes between rows of B: k rounded up to 16
  int wtiles;                   // 64-pixel segments per output row
  int segs;                     // segments: n * ho * wtiles
};

// The fused epilogue's operands, all float32 on the card; s1 null selects
// the int32 epilogue.
struct Dequant {
  const float* s1;              // (n,)
  const float* s2;              // a scalar
  const float* bias;            // (n,), or null for no bias
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A VEC-byte copy; a masked copy reads nothing and writes zeros.
template <int VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    static_assert(VEC == 8, "8- or 16-byte copies");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's generic-proxy writes to shared memory (cp.async)
// visible to the async proxy (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties a register to the preceding asm, so that the compiler neither reads
// an accumulator before wgmma.wait_group nor moves it across.
__device__ __forceinline__ void fence_reg(int& r) {
  asm volatile("" : "+r"(r) : : "memory");
}

// wgmma descriptor of a K-major tile without swizzle: 8-row core matrices
// of 16-byte rows (so a tile may start at any row), 128 bytes apart (stride
// byte offset), the second 16 K-bytes `lbo` bytes after the first (leading
// byte offset), layout type 0.
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle at shared
// address `addr` (its 8-row groups 1024-byte aligned): start address,
// leading byte offset (unused in this layout, 1 by convention), stride
// byte offset 1024 (8 rows of 128 bytes), layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d (64 x N, s32, the wgmma accumulator layout) += A (64 x 32) . B (N x
// 32)^T, both s8 and K-major in shared memory, asynchronously.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a,
                                         uint64_t b);

#define D8(i)                                                          \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),          \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      :
      D8(0), D8(8)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
      D8(0), D8(8), D8(16), D8(24)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
      D8(0), D8(8), D8(16), D8(24), D8(32), D8(40),
      D8(48), D8(56)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<160>(int (&d)[80], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p;\n}\n"
      :
      D8(0), D8(8), D8(16), D8(24), D8(32), D8(40),
      D8(48), D8(56), D8(64), D8(72)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<208>(int (&d)[104], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103"
      "}, %104, %105, p;\n}\n"
      :
      D8(0), D8(8), D8(16), D8(24), D8(32), D8(40),
      D8(48), D8(56), D8(64), D8(72), D8(80), D8(88),
      D8(96)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
      D8(0), D8(8), D8(16), D8(24), D8(32), D8(40),
      D8(48), D8(56), D8(64), D8(72), D8(80), D8(88),
      D8(96), D8(104), D8(112), D8(120)
      : "l"(a), "l"(b), "r"(1));
}

#undef D8

__device__ __forceinline__ float dequant(int acc, float s1, float s2,
                                         const float* bias, int col) {
  const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), s1), s2);
  return bias ? __fadd_rn(v, __ldg(bias + col)) : v;
}

// The gather loader: row m of the block's 128-row A tile is the receptive
// field of output pixel m, gathered 128 K-bytes per stage into the
// 128-byte-swizzled layout; B is 128 K-bytes of BN rows of b, (N, ldb)
// K-contiguous (the convolution's weights, or a dense B transposed). VEC
// is the byte size of A's copies (c % VEC == 0).
template <int BN, int VEC>
struct Gather {
  static constexpr int SEGS = 1;              // 64-row tiles per warpgroup
  static constexpr int ROWS = 128;            // rows of the block's tile
  static constexpr int A_BYTES = ROWS * BK;
  static constexpr int A_SLOTS = BK / VEC;    // copies per row of A
  static constexpr int A_STEP = THREADS / A_SLOTS;  // rows between a
  static constexpr int A_PASSES = ROWS / A_STEP;    //   thread's copies
  static constexpr int B_STEP = THREADS / (BK / 16);
  static constexpr int B_PASSES = (BN + B_STEP - 1) / B_STEP;
  static_assert(A_STEP % 8 == 0 && B_STEP % 8 == 0, "whole swizzle rows");

  __host__ __device__ static int stage_bytes(const Geom&) {
    return (ROWS + BN) * BK;
  }
  static int blocks(const Geom& g) { return (g.m + ROWS - 1) / ROWS; }

  const int8_t* x;
  const int8_t* b;
  const Geom g;
  long long m0;
  int n0;
  // This thread copies slot `as` (VEC bytes) of A rows ar + p * A_STEP and
  // 16-byte chunk bq of B rows br + p * B_STEP, at their swizzled places.
  uint32_t a_dst, b_dst;
  int br;
  // Each A row's field: a pointer to its top-left pixel (which may lie
  // outside the image; it is read only at taps inside it) and its (hi, wi).
  const int8_t* a_row[A_PASSES];
  int a_hi[A_PASSES];
  int a_wi[A_PASSES];
  // K position of this thread's A slot, ka = ((ki * kw) + kj) * c + kc,
  // and of its B chunk, kb
  int ka, ki, kj, kc, kb;

  __device__ Gather(const int8_t* x_, const int8_t* b_, const Geom& g_)
      : x(x_), b(b_), g(g_) {
    const int tid = threadIdx.x;
    m0 = static_cast<long long>(blockIdx.x) * ROWS;
    n0 = blockIdx.y * BN;
    const int as = tid % A_SLOTS, ar = tid / A_SLOTS;
    a_dst = ar * BK + (((as * VEC / 16) ^ (ar & 7)) << 4) + (as * VEC) % 16;
    const int bq = tid % (BK / 16);
    br = tid / (BK / 16);
    b_dst = A_BYTES + br * BK + ((bq ^ (br & 7)) << 4);
#pragma unroll
    for (int p = 0; p < A_PASSES; ++p) {
      const long long m = m0 + ar + p * A_STEP;
      a_row[p] = x;
      a_hi[p] = -(1 << 29);     // past the last row: every tap is outside
      a_wi[p] = 0;
      if (m < g.m) {
        const int hw = g.ho * g.wo;
        const int img = static_cast<int>(m / hw);
        const int rem = static_cast<int>(m - static_cast<long long>(img) * hw);
        const int oh = rem / g.wo;
        a_hi[p] = oh * g.sh - g.ph;
        a_wi[p] = (rem - oh * g.wo) * g.sw - g.pw;
        a_row[p] = x + (static_cast<long long>(img) * g.h * g.w +
                        static_cast<long long>(a_hi[p]) * g.w + a_wi[p]) *
                           g.c;
      }
    }
    ka = kc = as * VEC;
    ki = kj = 0;
    kb = bq * 16;
    normalise();
  }

  __device__ int stages() const { return (g.k + BK - 1) / BK; }

  __device__ void normalise() {
    while (kc >= g.c) {
      kc -= g.c;
      if (++kj == g.kw) {
        kj = 0;
        ++ki;
      }
    }
  }

  // Issues the copies of the next K stage into the buffer at `base`. The
  // tap's offset from a row's top-left pixel is the same for every row.
  __device__ void load(uint32_t base, int) {
    const long long tap = (static_cast<long long>(ki) * g.w + kj) * g.c + kc;
    const bool k_in = ka < g.k;
#pragma unroll
    for (int p = 0; p < A_PASSES; ++p) {
      const bool ok = k_in &&
                      static_cast<unsigned>(a_hi[p] + ki) <
                          static_cast<unsigned>(g.h) &&
                      static_cast<unsigned>(a_wi[p] + kj) <
                          static_cast<unsigned>(g.w);
      cp_async<VEC>(base + a_dst + p * A_STEP * BK, ok ? a_row[p] + tap : x,
                    ok);
    }
#pragma unroll
    for (int p = 0; p < B_PASSES; ++p) {
      const int r = br + p * B_STEP;
      if (B_PASSES * B_STEP == BN || r < BN) {
        const bool ok = n0 + r < g.n && kb < g.k;
        const int8_t* src =
            ok ? b + static_cast<long long>(n0 + r) * g.ldb + kb : b;
        cp_async<16>(base + b_dst + p * B_STEP * BK, src, ok);
      }
    }
    ka += BK;
    kc += BK;
    normalise();
    kb += BK;
  }

  // Issues warpgroup wg's wgmmas on the stage at `base`.
  __device__ void mma(int (&acc)[SEGS][BN / 2], uint32_t base, int wg) const {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      wgmma_s8<BN>(acc[0], sw128_desc(base + wg * 64 * BK + kk),
                   sw128_desc(base + A_BYTES + kk));
    }
  }

  // The output rows of warpgroup wg's 64-row tile: the first, and how many
  // of the 64 there are.
  __device__ void rows(int wg, int, long long* first, int* count) const {
    *first = m0 + wg * 64;
    *count = static_cast<int>(max(0LL, min(64LL, g.m - *first)));
  }
};

// The tap loader, for stride-1 convolutions with c % 32 == 0 and kw <= 16.
// A warpgroup's four 64-row tiles are segments: 64 consecutive output
// pixels of one output row each. A stage holds, for one kernel row ki and
// 32 channels from c0, the input pixels under each of the block's eight
// segments, 64 + kw - 1 of them, once, and the weights of the kw taps
// (ki, kj, c0..c0+31). The A operand of tap kj is the strip from its pixel
// kj on, so each input byte is copied once per kernel row and not once per
// tap. That takes the unswizzled K-major layout, whose rows are 16 bytes
// apart and may start at any of them: channels c0..c0+15 of each pixel in
// one plane, c0+16..c0+31 in a second; B likewise, per tap.
template <int BN>
struct Taps {
  static constexpr int SEGS = 4;
  static constexpr int SEGS_PER_BLOCK = 2 * SEGS;
  static constexpr int MAX_PX = 64 + 16 - 1;  // strip pixels
  static constexpr int SLOTS =                // strip copies per thread
      (SEGS_PER_BLOCK * 2 * MAX_PX + THREADS - 1) / THREADS;

  __host__ __device__ static int stage_bytes(const Geom& g) {
    return ((64 + g.kw - 1) * 16 * 2 * SEGS_PER_BLOCK + g.kw * 2 * BN * 16 +
            127) / 128 * 128;
  }
  static int blocks(const Geom& g) {
    return (g.segs + SEGS_PER_BLOCK - 1) / SEGS_PER_BLOCK;
  }

  const int8_t* x;
  const int8_t* b;
  const Geom g;
  int n0;
  int plane;                    // bytes of one strip's 16-channel plane
  int a_bytes;                  // bytes of the block's strips
  int copies;                   // strip copies per stage
  // this thread's strip copies: source at ki = 0 and c0 = 0, its input
  // row at ki = 0, whether the pixel lies inside the row, destination
  const int8_t* s_src[SLOTS];
  int s_row[SLOTS];
  bool s_in[SLOTS];
  uint32_t s_dst[SLOTS];

  __device__ Taps(const int8_t* x_, const int8_t* b_, const Geom& g_)
      : x(x_), b(b_), g(g_) {
    n0 = blockIdx.y * BN;
    const int px = 64 + g.kw - 1;
    plane = px * 16;
    a_bytes = 2 * SEGS_PER_BLOCK * plane;
    copies = 2 * SEGS_PER_BLOCK * px;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int e = threadIdx.x + j * THREADS;
      s_src[j] = x;
      s_row[j] = 0;
      s_in[j] = false;
      s_dst[j] = 0;
      if (e < copies) {
        const int seg = e / (2 * px), rem = e - seg * 2 * px;
        const int p = rem / 2, half = rem % 2;
        s_dst[j] = (2 * seg + half) * plane + 16 * p;
        const int gs = blockIdx.x * SEGS_PER_BLOCK + seg;
        if (gs < g.segs) {
          const int wt = gs % g.wtiles, r = gs / g.wtiles;  // r: img, oh
          const int oh = r % g.ho, img = r / g.ho;
          const int wi = wt * 64 - g.pw + p;
          s_row[j] = oh - g.ph;
          s_in[j] = wi >= 0 && wi < g.w;
          s_src[j] = x + ((static_cast<long long>(img) * g.h + s_row[j]) *
                              g.w + wi) * g.c + 16 * half;
        }
      }
    }
  }

  __device__ int stages() const { return g.kh * (g.c / 32); }

  // Issues the copies of stage kt (kernel row ki, channels c0..c0+31)
  // into the buffer at `base`.
  __device__ void load(uint32_t base, int kt) {
    const int ki = kt / (g.c / 32);
    const int c0 = (kt - ki * (g.c / 32)) * 32;
    const long long off = static_cast<long long>(ki) * g.w * g.c + c0;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      if (threadIdx.x + j * THREADS < copies) {
        const bool ok = s_in[j] && static_cast<unsigned>(s_row[j] + ki) <
                                       static_cast<unsigned>(g.h);
        cp_async<16>(base + s_dst[j], ok ? s_src[j] + off : x, ok);
      }
    }
    // B of tap kj, half h, row n at a_bytes + ((2 kj + h) BN + n) 16
    const int8_t* wk = b + static_cast<long long>(ki) * g.kw * g.c + c0;
    for (int e = threadIdx.x; e < g.kw * 2 * BN; e += THREADS) {
      const int tap = e / (2 * BN), half = e / BN % 2, n = e % BN;
      const bool ok = n0 + n < g.n;
      const int8_t* src = ok ? wk + static_cast<long long>(n0 + n) * g.ldb +
                                   tap * g.c + 16 * half
                             : b;
      cp_async<16>(base + a_bytes + 16 * e, src, ok);
    }
  }

  // Issues warpgroup wg's wgmmas on the stage at `base`: per tap, each of
  // its segments' strips from the tap's pixel on.
  __device__ void mma(int (&acc)[SEGS][BN / 2], uint32_t base, int wg) const {
    for (int kj = 0; kj < g.kw; ++kj) {
      const uint64_t bd =
          plain_desc(base + a_bytes + kj * 2 * BN * 16, BN * 16);
#pragma unroll
      for (int s = 0; s < SEGS; ++s) {
        wgmma_s8<BN>(acc[s],
                     plain_desc(base + 2 * (wg * SEGS + s) * plane + 16 * kj,
                                plane),
                     bd);
      }
    }
  }

  // The output rows of warpgroup wg's segment s: the first, and how many
  // of its 64 pixels lie in the output row.
  __device__ void rows(int wg, int s, long long* first, int* count) const {
    const int gs = blockIdx.x * SEGS_PER_BLOCK + wg * SEGS + s;
    *first = 0;
    *count = 0;
    if (gs < g.segs) {
      const int wt = gs % g.wtiles;
      *first = static_cast<long long>(gs / g.wtiles) * g.wo + wt * 64;
      *count = min(64, g.wo - wt * 64);
    }
  }
};

template <int BN, int VEC, bool TAPS>
using Loader = std::conditional_t<TAPS, Taps<BN>, Gather<BN, VEC>>;

// One tile of C = A . B^T, its operands fed by the loader, its sums
// written as int32 or dequantized.
template <int BN, int VEC, bool TAPS, bool DEQUANT>
__global__ void __launch_bounds__(THREADS,
                                  (TAPS ? BN <= 32 : BN <= 128) ? 2 : 1)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ b,
                 void* __restrict__ y, Geom g, Dequant dq) {
  using L = Loader<BN, VEC, TAPS>;
  constexpr int SEGS = L::SEGS;
  constexpr int LOOKAHEAD = STAGES - 1;  // stages in flight

  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int stage_bytes = L::stage_bytes(g);
  L ld(x, b, g);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  int acc[SEGS][BN / 2];
#pragma unroll
  for (int s = 0; s < SEGS; ++s)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[s][i] = 0;

  const int nk = ld.stages();
#pragma unroll
  for (int s = 0; s < LOOKAHEAD; ++s) {
    if (s < nk) ld.load(smem + s * stage_bytes, s);
    cp_async_commit();          // one group per stage, empty or not
  }
  for (int kt = 0; kt < nk; ++kt) {
    // stage kt has landed for every thread; every warpgroup has retired
    // the wgmmas of stage kt - 1, so its buffer may be refilled
    cp_async_wait<LOOKAHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
    ld.mma(acc, smem + (kt % STAGES) * stage_bytes, wg);
    wgmma_commit();
    if (kt + LOOKAHEAD < nk) {
      ld.load(smem + (kt + LOOKAHEAD) % STAGES * stage_bytes, kt + LOOKAHEAD);
    }
    cp_async_commit();
    wgmma_wait<0>();
  }
#pragma unroll
  for (int s = 0; s < SEGS; ++s)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(acc[s][i]);

  // The accumulator of m64nN: thread (warp w, lane l) of a warpgroup holds
  // rows 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1), j < N / 8,
  // in acc[4 j + 2 half + e], half choosing the row and e the column.
  const int lane = tid % 32;
  const int r0 = (tid / 32) % 4 * 16 + lane / 4;
  float s2 = 1.0f;
  if constexpr (DEQUANT) s2 = __ldg(dq.s2);
#pragma unroll
  for (int s = 0; s < SEGS; ++s) {
    long long first;
    int count;
    ld.rows(wg, s, &first, &count);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = blockIdx.y * BN + j * 8 + 2 * (lane % 4);
      if (col >= g.n) continue;
      const bool pair = col + 1 < g.n;
      const bool vec = pair && g.n % 2 == 0;  // 8-byte aligned pair
      float s1a = 0.0f, s1b = 0.0f;
      if constexpr (DEQUANT) {
        s1a = __ldg(dq.s1 + col);   // read-only: free to move past the
        if (pair) s1b = __ldg(dq.s1 + col + 1);  // stores
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        if (r >= count) continue;
        const int v0 = acc[s][4 * j + 2 * half];
        const int v1 = acc[s][4 * j + 2 * half + 1];
        const long long at = (first + r) * g.n + col;
        if constexpr (DEQUANT) {
          float* out = static_cast<float*>(y) + at;
          const float f0 = dequant(v0, s1a, s2, dq.bias, col);
          if (vec) {
            *reinterpret_cast<float2*>(out) =
                make_float2(f0, dequant(v1, s1b, s2, dq.bias, col + 1));
          } else {
            out[0] = f0;
            if (pair) out[1] = dequant(v1, s1b, s2, dq.bias, col + 1);
          }
        } else {
          int32_t* out = static_cast<int32_t*>(y) + at;
          if (vec) {
            *reinterpret_cast<int2*>(out) = make_int2(v0, v1);
          } else {
            out[0] = v0;
            if (pair) out[1] = v1;
          }
        }
      }
    }
  }
}

template <int BN, int VEC, bool TAPS>
int run(const int8_t* x, const int8_t* b, void* y, const Geom& g,
        const Dequant& dq, cudaStream_t s) {
  using L = Loader<BN, VEC, TAPS>;
  const int smem = STAGES * L::stage_bytes(g) + 1024;  // + alignment slack
  const bool fused = dq.s1 != nullptr;
  auto kernel = fused ? int8_gemm_kernel<BN, VEC, TAPS, true>
                      : int8_gemm_kernel<BN, VEC, TAPS, false>;
  // A launch above 48 KB of dynamic shared memory is refused unless the
  // kernel was allowed that much on the current device; allow it once per
  // kernel, device and size, not at every launch.
  static std::atomic<int> allowed[2][MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > allowed[fused][dev].load()) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[fused][dev].store(smem);   // sizes only grow: taps depend on kw
  }
  const dim3 grid(L::blocks(g), (g.n + BN - 1) / BN);
  kernel<<<grid, THREADS, smem, s>>>(x, b, y, g, dq);
  return static_cast<int>(cudaGetLastError());
}

// The block width follows N, so that the narrow convs of the U-Net's
// outer levels do not compute mostly padding. Stride-1 convolutions with
// wide kernels and at most 128 output channels take the tap loader.
int launch(const int8_t* x, const int8_t* b, void* y, const Geom& g,
           const Dequant& dq, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.c % 16 != 0) return run<32, 8, false>(x, b, y, g, dq, s);
  if (g.sh == 1 && g.sw == 1 && g.c % 32 == 0 && g.kw >= TAPS_MIN_KW &&
      g.kw <= 16 && g.n <= 32) {
    return run<32, 16, true>(x, b, y, g, dq, s);
  }
  if (g.n <= 32) return run<32, 16, false>(x, b, y, g, dq, s);
  if (g.n <= 64) return run<64, 16, false>(x, b, y, g, dq, s);
  if (g.n <= 128) return run<128, 16, false>(x, b, y, g, dq, s);
  if (g.n <= 160) return run<160, 16, false>(x, b, y, g, dq, s);
  if (g.n <= 208) return run<208, 16, false>(x, b, y, g, dq, s);
  return run<256, 16, false>(x, b, y, g, dq, s);
}

// The geometry of a convolution, or false for arguments it does not take.
bool conv_geom(int n, int h, int wd, int c, int cout, int kh, int kw, int sh,
               int sw, int ph, int pw, Geom* g) {
  if (n < 1 || h < 1 || wd < 1 || c < 8 || c % 8 != 0 || cout < 1 ||
      kh < 1 || kw < 1 || sh < 1 || sw < 1 || ph < 0 || pw < 0) {
    return false;
  }
  const int ho = (h + 2 * ph - kh) / sh + 1;
  const int wo = (wd + 2 * pw - kw) / sw + 1;
  const long long m = static_cast<long long>(n) * ho * wo;
  const long long k = static_cast<long long>(kh) * kw * c;
  if (ho < 1 || wo < 1 || m >= (1LL << 31) || k >= (1LL << 31) - 16) {
    return false;
  }
  const int ki = static_cast<int>(k);
  const int wtiles = (wo + 63) / 64;
  *g = Geom{h,  wd, c,  kh, kw, sh, sw, ph, pw, ho, wo, static_cast<int>(m),
            cout, ki, (ki + 15) / 16 * 16, wtiles, n * ho * wtiles};
  return true;
}

}  // namespace

// C (m, n) int32 = A (m, k) int8 . Bt (n, k)^T int8, all row-major and
// contiguous, on `stream`; returns cudaGetLastError(). Needs k % 16 == 0
// (the wrapper pads K with zeros); anything else returns
// cudaErrorInvalidValue without launching.
extern "C" int int8_mm_launch(const int8_t* a, const int8_t* bt, int32_t* c,
                              int m, int n, int k, void* stream) {
  if (m < 1 || n < 1 || k < 16 || k % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a as a 1 x 1 convolution over an (1, m, 1, k) image
  const Geom g{m, 1, k, 1, 1, 1, 1, 0, 0, m, 1, m, n, k, k, 1, m};
  return launch(a, bt, c, g, Dequant{nullptr, nullptr, nullptr}, stream);
}

// y (n, ho, wo, cout) int32 = conv(x (n, h, w, c) int8, w (cout, kh, kw, c)
// int8), stride (sh, sw), zero padding (ph, pw), all contiguous, on
// `stream`; returns cudaGetLastError(). Needs c % 8 == 0 (the wrapper pads
// channels with zeros), each row of w padded with zeros to a multiple of
// 16 bytes, and n * ho * wo < 2^31.
extern "C" int int8_conv2d_launch(const int8_t* x, const int8_t* w,
                                  int32_t* y, int n, int h, int wd, int c,
                                  int cout, int kh, int kw, int sh, int sw,
                                  int ph, int pw, void* stream) {
  Geom g;
  if (!conv_geom(n, h, wd, c, cout, kh, kw, sh, sw, ph, pw, &g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(x, w, y, g, Dequant{nullptr, nullptr, nullptr}, stream);
}

// The convolution of int8_conv2d_launch with the dequantize fused: y (n, ho,
// wo, cout) float32 = ((float(sums) * s1[cout]) * s2) + bias[cout], s1 and
// bias (cout,) float32, bias null for none, s2 a float32 scalar, all on the
// card.
extern "C" int int8_conv2d_dequant_launch(
    const int8_t* x, const int8_t* w, float* y, int n, int h, int wd, int c,
    int cout, int kh, int kw, int sh, int sw, int ph, int pw, const float* s1,
    const float* s2, const float* bias, void* stream) {
  Geom g;
  if (s1 == nullptr || s2 == nullptr ||
      !conv_geom(n, h, wd, c, cout, kh, kw, sh, sw, ph, pw, &g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(x, w, y, g, Dequant{s1, s2, bias}, stream);
}
