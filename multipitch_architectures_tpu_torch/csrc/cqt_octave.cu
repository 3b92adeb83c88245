// One octave of constant-Q magnitudes, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// multipitch_architectures_tpu/ops/pallas_cqt.py :: cqt_octave_pallas
// (kernel body _octave_kernel). For one octave it computes
//
//     [re | im](t, :) = y[t*hop : t*hop + n_fft] @ kr,  kr = [Re K | -Im K]
//     mag(t, k)       = sqrt(re(t, k)^2 + im(t, k)^2 + 1e-30)
//
// with y the octave's signal, already reflect-padded by n_fft/2, kr of
// shape (n_fft, 2*bpo) and mag of shape (n_frames, bpo), all float32.
//
// What bounds it. The 6-channel HCQT of the serving path (36 bins per
// octave) launches it 21 times per recording. For a 117.7-s recording
// that is about 7 GFLOP and a few MB of audio and magnitudes over all 21
// launches: the frame count stays at 5069 while the hop halves from 512
// to 2. That is far below the card's float32 rate and memory bandwidth,
// so what costs is the launches and the memory traffic a materialised
// frame matrix would add, not arithmetic.
//
// What the design does about it. Frames never reach device memory. A
// block owns TILE_T consecutive frames and all 2*bpo columns, so a bin's
// real and imaginary sums end in the same thread and the magnitude is
// taken in the epilogue. The K loop walks n_fft in KC-sample chunks and
// stages, in shared memory, the chunk of kr and the tile's frame samples,
// read straight from y at t*hop + m: the address arithmetic replaces the
// frame matrix. Sums are plain float32 FMAs in registers, with no tensor
// cores and no TF32, so the result keeps float32 accuracy. Samples past
// the end of y read as 0. The sqrt is fused, so one launch per octave
// writes only the magnitudes.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_T = 32;        // frames per block
constexpr int KC = 32;            // n_fft samples per K step
constexpr int TF = 8;             // thread rows: frames tf, tf + TF, ...
constexpr int TB = 16;            // thread columns: bins tb, tb + TB, ...
constexpr int FPT = TILE_T / TF;  // frames per thread
constexpr int MAX_BPO = 64;       // bins per octave the shared tile holds
constexpr int THREADS = TF * TB;

// NB bins per thread: bins tb + j*TB for j < NB, with NB*TB >= bpo.
template <int NB>
__global__ void __launch_bounds__(THREADS)
cqt_octave_kernel(const float* __restrict__ y, long long len,
                  const float* __restrict__ kr, float* __restrict__ out,
                  int n_frames, int hop, int n_fft, int bpo) {
  // Columns past 2*bpo are never written and only feed bins >= bpo,
  // which the epilogue drops: NB*TB <= MAX_BPO keeps every read in range.
  __shared__ float s_kr[KC][2 * MAX_BPO];
  __shared__ float s_fr[TILE_T][KC + 1];  // +1: rows fall in other banks

  const int tid = threadIdx.x;
  const int tf = tid % TF;
  const int tb = tid / TF;
  const long long t0 = static_cast<long long>(blockIdx.x) * TILE_T;
  const int ncol = 2 * bpo;

  float re[FPT][NB];
  float im[FPT][NB];
#pragma unroll
  for (int i = 0; i < FPT; ++i) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      re[i][j] = 0.f;
      im[i][j] = 0.f;
    }
  }

  for (int k0 = 0; k0 < n_fft; k0 += KC) {
    // kr rows k0 .. k0+KC-1 are KC*ncol contiguous floats
    const float* kr_chunk = kr + static_cast<long long>(k0) * ncol;
    for (int e = tid; e < KC * ncol; e += THREADS) {
      s_kr[e / ncol][e % ncol] = kr_chunk[e];
    }
    // frame sample (t, k0 + m) is y[(t0 + t)*hop + k0 + m]; a warp reads
    // one frame's KC consecutive samples
    for (int e = tid; e < TILE_T * KC; e += THREADS) {
      const int t = e / KC;
      const int m = e % KC;
      const long long idx = (t0 + t) * hop + k0 + m;
      s_fr[t][m] = idx < len ? y[idx] : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      float f[FPT];
#pragma unroll
      for (int i = 0; i < FPT; ++i) f[i] = s_fr[tf + i * TF][kk];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float a = s_kr[kk][tb + j * TB];
        const float c = s_kr[kk][bpo + tb + j * TB];
#pragma unroll
        for (int i = 0; i < FPT; ++i) {
          re[i][j] = fmaf(f[i], a, re[i][j]);
          im[i][j] = fmaf(f[i], c, im[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FPT; ++i) {
    const long long t = t0 + tf + i * TF;
    if (t >= n_frames) continue;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int b = tb + j * TB;
      if (b < bpo) {
        out[t * bpo + b] =
            sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j] + 1e-30f);
      }
    }
  }
}

}  // namespace

// Launches one octave on `stream` and returns cudaGetLastError(). The
// caller guarantees n_fft % 32 == 0 and 1 <= bpo <= 64; anything else
// returns cudaErrorInvalidValue without launching.
extern "C" int cqt_octave_launch(const float* y, long long len,
                                 const float* kr, float* out, int n_frames,
                                 int hop, int n_fft, int bpo, void* stream) {
  if (n_frames < 1 || hop < 1 || n_fft < KC || n_fft % KC != 0 || bpo < 1 ||
      bpo > MAX_BPO) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n_frames + TILE_T - 1) / TILE_T);
  const dim3 block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((bpo + TB - 1) / TB) {
    case 1:
      cqt_octave_kernel<1><<<grid, block, 0, s>>>(y, len, kr, out, n_frames,
                                                  hop, n_fft, bpo);
      break;
    case 2:
      cqt_octave_kernel<2><<<grid, block, 0, s>>>(y, len, kr, out, n_frames,
                                                  hop, n_fft, bpo);
      break;
    case 3:
      cqt_octave_kernel<3><<<grid, block, 0, s>>>(y, len, kr, out, n_frames,
                                                  hop, n_fft, bpo);
      break;
    default:
      cqt_octave_kernel<4><<<grid, block, 0, s>>>(y, len, kr, out, n_frames,
                                                  hop, n_fft, bpo);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
