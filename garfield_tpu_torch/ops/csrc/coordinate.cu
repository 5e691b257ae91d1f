// Coordinate-wise robust statistics for Hopper (sm_90a): the lower
// coordinate-wise median and the trimmed mean of an (n, d) row stack,
// n <= 32, with the folded-attack row remap applied in registers.
//
// Replaces the two Pallas TPU kernels of garfield_tpu/ops/coordinate.py:
//   - median_kernel  <- _median_kernel (coordinate.py:150-152)
//   - tmean_kernel   <- _tmean_kernel  (coordinate.py:155-160)
// Both reach pl.pallas_call through _column_call (coordinate.py:184-198).
//
// Semantics (bitwise those of the TPU kernels):
//   - logical row i is scale[i] * rows[i][j]; a scale of exactly 0 gives an
//     exact 0.0f (never 0 * inf), a scale of exactly 1 the value as loaded,
//     any other scale one f32 multiply after the upcast (_load_rows,
//     coordinate.py:123-147);
//   - an odd-even transposition network of N rounds of adjacent
//     compare-exchange, swap = (b < a) || (isnan(a) && !isnan(b)): strict
//     '<', so the network is stable, NaN sorts last and -0.0/+0.0 keep
//     their row order;
//   - median writes sorted[(N-1)/2]; the trimmed mean writes
//     (((sorted[f] + sorted[f+1]) + ...) + sorted[N-f-1]) * (1/(N-2f)), the
//     sequential f32 add chain of the TPU kernel, then one multiply by the
//     correctly rounded f32 reciprocal (what XLA makes of the TPU kernel's
//     divide by a constant).
//   Build with -fmad=false and without --use_fast_math: the remap multiply,
//   each add of the chain and the final multiply must each round once, and
//   the reciprocal must be the IEEE-rounded one.
//
// Bound on the H100: memory. Per coordinate a thread reads one value per
// distinct physical row and writes one; the network is N^2/2 compare-
// exchanges on registers (28 at N = 8), far below the ALU rate. At the
// ResNet-18 step (d = 11,173,962, folded lie: 7 distinct rows read, 1
// written) that is ~358 MB in f32 (~107 us at 3.35 TB/s) and ~179 MB in
// bf16 (~53 us).
//
// Design: one thread per coordinate, 256 coordinates per block, so a warp's
// loads of one row are 32 neighbouring addresses. The thread keeps its N
// values in registers (N is a template parameter, so the network unrolls
// completely and every index is static). bf16 is read directly and widened
// in registers (exact), halving the bytes of the f32 path; on the TPU the
// upcast sat outside the kernel only because Mosaic rejects bf16 compares.
// The remap travels by value in the kernel parameters: one pointer per
// logical row, so duplicated rows (lie's shared fake row, itself a separate
// buffer) are re-reads that hit L1/L2, and the (n+1, d) concatenation is
// never built. The ragged edge is masked; nothing is padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define GTT_MAX_ROWS 32
#define GTT_BLOCK 256

// Keep in step with RowRemap in garfield_tpu_torch/ops/_build.py.
struct RowRemap {
  const void* rows[GTT_MAX_ROWS];  // start of logical row i (d elements)
  float scale[GTT_MAX_ROWS];       // logical row i = scale[i] * rows[i]
};

enum { GTT_F32 = 0, GTT_BF16 = 1 };
enum { GTT_ERR_ARGS = -1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int N, typename T>
__device__ __forceinline__ void load_rows(const RowRemap& rm, int64_t j,
                                          float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float s = rm.scale[i];
    if (s == 0.0f) {
      r[i] = 0.0f;
    } else {
      const float v = to_f32(static_cast<const T*>(rm.rows[i])[j]);
      r[i] = (s == 1.0f) ? v : v * s;
    }
  }
}

__device__ __forceinline__ void compare_exchange(float& a, float& b) {
  const bool swap = (b < a) || (isnan(a) && !isnan(b));
  const float lo = swap ? b : a;
  const float hi = swap ? a : b;
  a = lo;
  b = hi;
}

template <int N>
__device__ __forceinline__ void oddeven_sort(float (&r)[N]) {
#pragma unroll
  for (int rnd = 0; rnd < N; ++rnd) {
#pragma unroll
    for (int i = rnd % 2; i < N - 1; i += 2) compare_exchange(r[i], r[i + 1]);
  }
}

template <int N, typename T>
__global__ void __launch_bounds__(GTT_BLOCK)
    median_kernel(RowRemap rm, T* __restrict__ out, int64_t d) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * GTT_BLOCK + threadIdx.x;
  if (j >= d) return;
  float r[N];
  load_rows<N, T>(rm, j, r);
  oddeven_sort<N>(r);
  out[j] = from_f32<T>(r[(N - 1) / 2]);
}

template <int N, typename T>
__global__ void __launch_bounds__(GTT_BLOCK)
    tmean_kernel(RowRemap rm, int f, T* __restrict__ out, int64_t d) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * GTT_BLOCK + threadIdx.x;
  if (j >= d) return;
  float r[N];
  load_rows<N, T>(rm, j, r);
  oddeven_sort<N>(r);
  // The chain starts AT sorted[f] (not 0 + sorted[f], which would turn a
  // -0.0 into +0.0); f is a runtime value, so every static index i tests
  // its membership and the compiler emits predicated adds.
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i == f) {
      acc = r[i];
    } else if (i > f && i < N - f) {
      acc = acc + r[i];
    }
  }
  // XLA compiles the TPU kernel's `acc / (n - 2f)` by a constant into a
  // multiply by the correctly rounded f32 reciprocal; so does this kernel.
  const float inv = 1.0f / static_cast<float>(N - 2 * f);
  out[j] = from_f32<T>(acc * inv);
}

template <int N, typename T>
static cudaError_t launch(const RowRemap& rm, int f, bool tmean, void* out,
                          int64_t d, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((d + GTT_BLOCK - 1) / GTT_BLOCK);
  if (tmean) {
    tmean_kernel<N, T><<<grid, GTT_BLOCK, 0, stream>>>(
        rm, f, static_cast<T*>(out), d);
  } else {
    median_kernel<N, T><<<grid, GTT_BLOCK, 0, stream>>>(
        rm, static_cast<T*>(out), d);
  }
  return cudaGetLastError();
}

template <typename T>
static int dispatch_n(const RowRemap& rm, int n, int f, bool tmean, void* out,
                      int64_t d, cudaStream_t stream) {
  switch (n) {
#define GTT_CASE(N) \
  case N:           \
    return static_cast<int>(launch<N, T>(rm, f, tmean, out, d, stream));
    GTT_CASE(1) GTT_CASE(2) GTT_CASE(3) GTT_CASE(4) GTT_CASE(5) GTT_CASE(6)
    GTT_CASE(7) GTT_CASE(8) GTT_CASE(9) GTT_CASE(10) GTT_CASE(11)
    GTT_CASE(12) GTT_CASE(13) GTT_CASE(14) GTT_CASE(15) GTT_CASE(16)
    GTT_CASE(17) GTT_CASE(18) GTT_CASE(19) GTT_CASE(20) GTT_CASE(21)
    GTT_CASE(22) GTT_CASE(23) GTT_CASE(24) GTT_CASE(25) GTT_CASE(26)
    GTT_CASE(27) GTT_CASE(28) GTT_CASE(29) GTT_CASE(30) GTT_CASE(31)
    GTT_CASE(32)
#undef GTT_CASE
    default:
      return GTT_ERR_ARGS;
  }
}

static int run(const RowRemap* rm, int n, int f, bool tmean, int dtype,
               void* out, int64_t d, int device, void* stream) {
  if (rm == nullptr || out == nullptr || d <= 0 || n < 1 ||
      n > GTT_MAX_ROWS || f < 0 || n - 2 * f < 1 ||
      (d + GTT_BLOCK - 1) / GTT_BLOCK > 0x7fffffff) {
    return GTT_ERR_ARGS;
  }
  // The launch goes to the current device of this library's runtime, which
  // must be the device of the tensors and of the caller's stream.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GTT_F32) return dispatch_n<float>(*rm, n, f, tmean, out, d, s);
  if (dtype == GTT_BF16) {
    return dispatch_n<__nv_bfloat16>(*rm, n, f, tmean, out, d, s);
  }
  return GTT_ERR_ARGS;
}

// Plain C interface (loaded with ctypes). Returns 0 on a launched kernel,
// GTT_ERR_ARGS (-1) on arguments the kernels do not take, or the
// cudaError_t that cudaGetLastError() reported right after the launch.
extern "C" int gtt_coordinate_median(const RowRemap* rm, int n, int dtype,
                                     void* out, int64_t d, int device,
                                     void* stream) {
  return run(rm, n, 0, false, dtype, out, d, device, stream);
}

extern "C" int gtt_trimmed_mean(const RowRemap* rm, int n, int f, int dtype,
                                void* out, int64_t d, int device,
                                void* stream) {
  return run(rm, n, f, true, dtype, out, d, device, stream);
}

extern "C" const char* gtt_error_string(int code) {
  if (code == GTT_ERR_ARGS) return "arguments rejected by the kernel launcher";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
