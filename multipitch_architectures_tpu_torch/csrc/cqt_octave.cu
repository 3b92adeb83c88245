// Constant-Q magnitudes of a list of octaves in one launch, written for
// Hopper (sm_90a) with wgmma in split TF32.
//
// Replaces the Pallas TPU kernel
// multipitch_architectures_tpu/ops/pallas_cqt.py :: cqt_octave_pallas
// (:73, kernel body _octave_kernel :33). For each octave of the work list
// it computes
//
//     [re | im](t, :) = y[t*hop : t*hop + n_fft] @ kr,  kr = [Re K | -Im K]
//     out(t, col + k) = sqrt(re(t, k)^2 + im(t, k)^2 + 1e-30) * scale(k)
//
// with y the octave's signal, already reflect-padded by n_fft/2 (samples
// past its end read as 0), kr of shape (n_fft, 2*bpo), scale the octave's
// (bpo,) magnitude scale, and out a float32 matrix that several octaves
// share, each writing its own bpo columns from `col`.
//
// What bounds it. The serving path's HCQT is 21 octaves over three bases
// (9 + 6 + 6): for the 117.7-s span, 6.73 GFLOP of products over 5069
// frames each, against about 80 MB of signals, banks and magnitudes read
// or written once. On CUDA cores (67 TFLOP/s float32) that is 0.10 ms of
// operations; memory takes 0.024 ms at 3.35 TB/s. So operations bound it,
// and only the tensor cores shrink them. Plain TF32 keeps 11 bits of each
// operand and misses the peak of this transform by 2.9e-4 (one product
// in this kernel), far outside the 1e-5 it is held to; three TF32
// products (hi*hi + hi*lo + lo*hi, each operand split as hi = tf32(x),
// lo = tf32(x - hi)) keep about 22 bits, 3 x 6.73 GFLOP at 495 TFLOP/s:
// 0.041 ms.
//
// What the design does about it.
//
//   One launch.  A block, one warpgroup, owns TILE = 64 frames of one
//     octave; it finds its octave and tile from the prefix sums of the
//     tiles of the octaves before it, so the whole HCQT is one grid and no
//     octave waits for another's launch. The caller orders the list,
//     longest n_fft first. At 64 frames a 10-s request still makes 147
//     blocks, and two blocks share an SM.
//   The product on tensor cores.  Each warpgroup issues, per 8 samples of
//     K, three wgmma.mma_async m64nNk8 f32.tf32.tf32 (lo*hi, hi*lo,
//     hi*hi) into one float32 accumulator, N = 2*bpo rounded up to an
//     instantiated width (24, 48, 72, 96, 120, 128). A is the frame tile
//     in registers: each thread reads its fragment from the signal staged
//     in shared memory and splits it with cvt.rna.tf32.f32. B is the bank,
//     split and laid out on the host once per plan (bank_for_kernel in
//     ops/cqt_octave.py): K-major, the columns interleaved so that bin b's
//     re and im sums are columns 2b and 2b + 1 and end in one thread's
//     accumulator pair, in 16-byte core-matrix planes without swizzle, hi
//     then lo for each K chunk of KC samples, so that a chunk is one
//     contiguous range.
//   K in chunks.  The n_fft-512 bank in hi and lo is 295 KB, more than a
//     block's shared memory, so K runs through a ring of STAGES buffers
//     filled by cp.async, STAGES - 1 chunks ahead: the bank chunk (16-byte
//     copies) and the tile's samples. For hop <= 4 a chunk's frames
//     overlap and the tile loads one contiguous range of
//     (TILE - 1)*hop + KC samples; otherwise TILE rows of KC samples at
//     stride hop, padded to KC + 4 floats so that the fragment reads fall
//     in distinct banks: 16-byte copies where hop % 4 == 0 and y is
//     16-byte aligned (every serving hop past 4; with 4-byte copies
//     alone the 21 serving octaves took 23 % longer on the H100), else
//     4-byte ones. Each
//     chunk's wgmmas start from a zero accumulator and the chunk sum is
//     added to a float32 total on CUDA cores, rounded to nearest, so the
//     tensor cores' own accumulation never runs over more than 3*KC/8
//     products.
//   Fused epilogue.  sqrt(re*re + im*im + 1e-30) * scale, each step
//     rounded to nearest with no FMA, in the plain version's order, is
//     written straight into the octave's columns of the shared output;
//     rows past n_frames are dropped.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W): the 21 octaves of the 117.7-s
// span in one launch take 0.13 ms, within 1.2e-6 of the peak of the plain
// float32 version; the first version of this kernel (float32 FMAs on CUDA
// cores, 32 frames a block, one launch per octave) took 1.83 ms. One
// tensor-core accumulator over all of K, without the chunk sums, was 2 %
// faster and 5x less accurate. What holds it now: every 64-frame block
// streams its octave's whole bank from L2, and the N = 72 wgmmas are
// narrow; each alone takes about 0.09 ms.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

// One octave of the work list; mirrors ops/cqt_octave.py::_Entry.
// Outside the unnamed namespace: the exported launcher takes it.
struct Entry {
  const float* y;       // (len,) padded signal
  long long len;
  const float* bank;    // (n_fft / 32, 2, 8, N, 4): bank_for_kernel
  const float* scale;   // (bpo,)
  float* out;           // row t of this octave starts at out + t * ld + col
  int hop, n_fft, n_frames, col, ld;
};

namespace {

constexpr int TILE = 64;          // frames per block: 64 per warpgroup
constexpr int THREADS = 2 * TILE;
constexpr int KC = 32;            // samples of K per chunk (pipeline stage)
constexpr int ROW = KC + 4;       // floats per staged frame row
constexpr int STAGES = 4;         // buffers in the shared-memory ring
constexpr int MAX_ENTRIES = 32;   // octaves per launch
constexpr int MAX_BPO = 64;
constexpr int MAX_N_FFT = 131072;
constexpr int CONTIG_MAX_HOP = 4; // hops that stage one contiguous range
constexpr int MAX_DEVICES = 64;

struct Work {
  Entry e[MAX_ENTRIES];
  int start[MAX_ENTRIES + 1];   // first tile of each entry; start[n] tiles
  int n, bpo;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 4- or 16-byte copy of `bytes` valid bytes; the rest is written as 0.
template <int SIZE>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes) {
  if constexpr (SIZE == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes)
                 : "memory");
  } else {
    static_assert(SIZE == 4, "4- or 16-byte copies");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes)
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
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r) : : "memory");
}

// Keeps an A operand's register live, unchanged, until this point.
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r) : : "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, in a 32-bit container whose low 13 bits are 0.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// wgmma descriptor of a K-major operand without swizzle: 8-row core
// matrices of 16-byte rows, 128 bytes apart (stride byte offset), the
// next 4 samples of K `lbo` bytes further (leading byte offset), layout
// type 0.
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// d (64 x N, float32, the wgmma accumulator layout) = (scale_d ? d : 0) +
// A (64 x 8, tf32, in registers) . B (N x 8, tf32, K-major in shared
// memory)^T, asynchronously. Thread (warp w, lane l) of the warpgroup
// holds A rows 16 w + l / 4 (+ 8 in a[1], a[3]) at K columns l % 4 (+ 4
// in a[2], a[3]).
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d);

#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define D8(i) D4(i), D4(i + 4)

template <>
__device__ __forceinline__ void wgmma_tf32<24>(float (&d)[12],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : D8(0), D4(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<48>(float (&d)[24],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<72>(float (&d)[36],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35"
      "}, {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D4(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<96>(float (&d)[48],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<120>(float (&d)[60],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59"
      "}, {%60, %61, %62, %63}, %64, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D4(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

#undef D8
#undef D4

__host__ __device__ constexpr int stage_bytes(int n) {
  return 2 * KC * n * 4 + TILE * ROW * 4;   // hi and lo planes, samples
}

// One block: TILE frames of one octave, all N columns; warpgroup wg owns
// frames wg * 64 .. wg * 64 + 63 of the tile.
template <int N>
__global__ void __launch_bounds__(THREADS, TILE == 64 ? 2 : 1)
cqt_octaves_kernel(const __grid_constant__ Work w) {
  constexpr int B_BYTES = 2 * KC * N * 4;
  constexpr int STAGE_BYTES = stage_bytes(N);
  constexpr int PLANE = N * 16;                  // 4 samples of K, N columns

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t smem = (raw + 127) & ~127u;
  const uint8_t* smem_ptr = smem_raw + (smem - raw);

  // this block's octave and tile
  const int tile = blockIdx.x;
  int ei = 0;
  while (ei + 1 < w.n && w.start[ei + 1] <= tile) ++ei;
  const Entry& e = w.e[ei];
  const float* __restrict__ y = e.y;
  const long long len = e.len;
  const int hop = e.hop;
  const long long t0 = static_cast<long long>(tile - w.start[ei]) * TILE;
  const bool contig = hop <= CONTIG_MAX_HOP;
  const bool vec = !contig && hop % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  const uint8_t* bank = reinterpret_cast<const uint8_t*>(e.bank);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;

  // Issues the copies of K chunk kt into the stage at `base`.
  auto load = [&](int kt, uint32_t base) {
    const uint8_t* src = bank + static_cast<long long>(kt) * B_BYTES;
    for (int i = tid; i < B_BYTES / 16; i += THREADS) {
      cp_async<16>(base + i * 16, src + i * 16, 16);
    }
    const uint32_t a = base + B_BYTES;
    const long long k0 = static_cast<long long>(kt) * KC;
    if (contig) {
      // sample i of the range is frame t's sample m where t * hop + m == i
      const long long s0 = t0 * hop + k0;
      const int count = (TILE - 1) * hop + KC;
      for (int i = tid; i < count; i += THREADS) {
        const long long idx = s0 + i;
        const bool ok = idx < len;
        cp_async<4>(a + i * 4, ok ? y + idx : y, ok ? 4 : 0);
      }
    } else if (vec) {
      for (int i = tid; i < TILE * (KC / 4); i += THREADS) {
        const int t = i / (KC / 4), q = i % (KC / 4);
        const long long idx = (t0 + t) * hop + k0 + 4 * q;
        const long long left = len - idx;
        const int bytes = left >= 4 ? 16 : left > 0 ? static_cast<int>(left) * 4
                                                    : 0;
        cp_async<16>(a + (t * ROW + 4 * q) * 4, bytes ? y + idx : y, bytes);
      }
    } else {
      for (int i = tid; i < TILE * KC; i += THREADS) {
        const int t = i / KC, m = i % KC;
        const long long idx = (t0 + t) * hop + k0 + m;
        const bool ok = idx < len;
        cp_async<4>(a + (t * ROW + m) * 4, ok ? y + idx : y, ok ? 4 : 0);
      }
    }
  };

  // This thread's A fragment: frames fr (+ 8), samples lane % 4 (+ 4) of
  // each group of 8, at these offsets into a stage's samples.
  const int fr = wg * 64 + warp * 16 + lane / 4;
  int a_off[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int t = fr + 8 * (v & 1);
    const int m = lane % 4 + 4 * (v >> 1);
    a_off[v] = contig ? t * hop + m : t * ROW + m;
  }

  float total[N / 2];
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) total[i] = acc[i] = 0.f;

  const int nk = e.n_fft / KC;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, smem + s * STAGE_BYTES);
    cp_async_commit();            // one group per stage, empty or not
  }
  for (int kt = 0; kt < nk; ++kt) {
    // chunk kt has landed for every thread; every warpgroup has retired
    // the wgmmas of chunk kt - 1, so its buffer may be refilled
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    const int slot = kt % STAGES;
    const uint32_t st = smem + slot * STAGE_BYTES;
    const float* as = reinterpret_cast<const float*>(
        smem_ptr + slot * STAGE_BYTES + B_BYTES);
    uint32_t hi[KC / 8][4], lo[KC / 8][4];
#pragma unroll
    for (int s = 0; s < KC / 8; ++s) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float x = as[a_off[v] + 8 * s];
        hi[s][v] = tf32(x);
        lo[s][v] = tf32(__fsub_rn(x, __uint_as_float(hi[s][v])));
      }
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KC / 8; ++s) {
      const uint64_t b_hi = plain_desc(st + 2 * s * PLANE, PLANE);
      const uint64_t b_lo = plain_desc(st + KC * N * 4 + 2 * s * PLANE, PLANE);
      wgmma_tf32<N>(acc, lo[s], b_hi, s > 0);
      wgmma_tf32<N>(acc, hi[s], b_lo, 1);
      wgmma_tf32<N>(acc, hi[s], b_hi, 1);
    }
    wgmma_commit();
    if (kt + STAGES - 1 < nk) {
      load(kt + STAGES - 1, smem + (kt + STAGES - 1) % STAGES * STAGE_BYTES);
    }
    cp_async_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < KC / 8; ++s) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        fence_reg(hi[s][v]);
        fence_reg(lo[s][v]);
      }
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      fence_reg(acc[i]);
      total[i] = __fadd_rn(total[i], acc[i]);
    }
  }

  // The accumulator of m64nN: thread (warp w, lane l) holds rows 16 w +
  // l / 4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1), j < N / 8, in
  // acc[4 j + 2 half + c], half choosing the row and c the column: the re
  // (c = 0) and im (c = 1) sums of bin 4 j + l % 4.
  const int bpo = w.bpo;
  const float* __restrict__ scale = e.scale;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long t = t0 + fr + 8 * half;
    if (t >= e.n_frames) continue;
    float* row = e.out + t * e.ld + e.col;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int b = 4 * j + lane % 4;
      if (b < bpo) {
        const float re = total[4 * j + 2 * half];
        const float im = total[4 * j + 2 * half + 1];
        const float mag = __fsqrt_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)),
                      1e-30f));
        row[b] = __fmul_rn(mag, __ldg(scale + b));
      }
    }
  }
}

template <int N>
int run(const Work& w, cudaStream_t s) {
  constexpr int SMEM = STAGES * stage_bytes(N) + 128;  // + alignment slack
  // A launch above 48 KB of dynamic shared memory is refused unless the
  // kernel was allowed that much on the current device; allow it once per
  // kernel and device.
  static std::atomic<bool> allowed[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!allowed[dev].load()) {
    err = cudaFuncSetAttribute(cqt_octaves_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev].store(true);
  }
  cqt_octaves_kernel<N><<<w.start[w.n], THREADS, SMEM, s>>>(w);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's column count for `bpo` bins: 2 * bpo rounded up to an
// instantiated wgmma width; ops/cqt_octave.py::kernel_width mirrors it.
int width(int bpo) {
  const int widths[] = {24, 48, 72, 96, 120, 128};
  for (int n : widths) {
    if (2 * bpo <= n) return n;
  }
  return 0;
}

}  // namespace

// Frames per block: ops/cqt_octave.py reads it to lay out a launch.
extern "C" int cqt_octaves_tile() { return TILE; }

// Launches the n octaves of `entries` on `stream` in one grid of
// start[n] blocks of TILE frames and returns cudaGetLastError(). start[i]
// is the first block of entry i: start[0] == 0 and start[i + 1] -
// start[i] == ceil(n_frames / TILE). Needs 1 <= n
// <= 32, 1 <= bpo <= 64 with 2 * bpo % 8 == 0, and for every entry
// n_fft a multiple of 32 up to 131072, hop >= 1, n_frames >= 1, ld >= col
// + bpo, and a 16-byte-aligned bank; anything else returns
// cudaErrorInvalidValue without launching.
extern "C" int cqt_octaves_launch(const Entry* entries, const int* start,
                                  int n, int bpo, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (entries == nullptr || start == nullptr || n < 1 || n > MAX_ENTRIES ||
      bpo < 1 || bpo > MAX_BPO || (2 * bpo) % 8 != 0 ||
      start[0] != 0) {
    return invalid;
  }
  Work w;
  w.n = n;
  w.bpo = bpo;
  w.start[0] = 0;
  for (int i = 0; i < n; ++i) {
    const Entry& e = entries[i];
    if (e.y == nullptr || e.bank == nullptr || e.scale == nullptr ||
        e.out == nullptr || e.len < 1 || e.hop < 1 || e.n_frames < 1 ||
        e.n_fft < KC || e.n_fft % KC != 0 || e.n_fft > MAX_N_FFT ||
        e.col < 0 || e.ld < e.col + bpo ||
        (reinterpret_cast<uintptr_t>(e.bank) & 15) != 0 ||
        start[i + 1] - start[i] != (e.n_frames + TILE - 1) / TILE) {
      return invalid;
    }
    w.e[i] = e;
    w.start[i + 1] = start[i + 1];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width(bpo)) {
    case 24: return run<24>(w, s);
    case 48: return run<48>(w, s);
    case 72: return run<72>(w, s);
    case 96: return run<96>(w, s);
    case 120: return run<120>(w, s);
    default: return run<128>(w, s);
  }
}
