// attainable.cu — the two microkernels behind the roofline's attainable
// rates (ops/roofline.py: measure_attainable), for sm_90a.
//
// Replaces the XLA-fused loops of aqc_research_tpu/ops/roofline.py:
// measure_attainable, which stay on the chip as one program each:
//   * the f32 FMA loop (:194): x <- 0.999 x + 0.001, 4000 times, over a
//     4 MB block (1024 x 8 x 128 floats);
//   * the stream loop (:224): x <- 1.0001 x + 1, 20 passes over 256 MB.
// In eager PyTorch each iteration of either loop would be a launch of its
// own, which times device memory and launch cost, not the CUDA cores.
//
// fma_chain_kernel.  A thread keeps 8 elements in registers (two float4
// loads) and runs the loop on each: 8 independent FMA chains a thread, the
// loop unrolled by 8, so the 4 schedulers of an SM always find an FMA
// ready.  Bounds: 2 flop an element and iteration, 8.4 GFLOP on the 4 MB
// block (125 us at 67 TFLOP/s f32) against 8 MB of traffic (2.5 us):
// operations-bound.
//
// stream_kernel.  A grid-stride pass over float4s, 20 passes in one
// launch: pass 0 reads the input and writes the output, every later pass
// reads and writes the output in place.  Each element belongs to the same
// thread in every pass, so no pass waits for another thread's.  256 MB is
// five times the 50 MB L2, so every pass streams device memory: 10.7 GB
// over the 20 passes (3.2 ms at 3.35 TB/s) against 2.7 GFLOP: bytes-bound.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fma_chain_kernel(const float4* __restrict__ in, float4* __restrict__ out, long long n8, int iters,
                 float a, float b) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n8) return;
  float4 u = in[2 * i];
  float4 v = in[2 * i + 1];
#pragma unroll 8
  for (int k = 0; k < iters; ++k) {
    u.x = fmaf(a, u.x, b);
    u.y = fmaf(a, u.y, b);
    u.z = fmaf(a, u.z, b);
    u.w = fmaf(a, u.w, b);
    v.x = fmaf(a, v.x, b);
    v.y = fmaf(a, v.y, b);
    v.z = fmaf(a, v.z, b);
    v.w = fmaf(a, v.w, b);
  }
  out[2 * i] = u;
  out[2 * i + 1] = v;
}

// ``in`` and ``out`` may not overlap; ``out`` is read back from pass 1 on.
__global__ void __launch_bounds__(kThreads)
stream_kernel(const float4* in, float4* out, long long n4, int passes, float a, float b) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  for (int p = 0; p < passes; ++p) {
    const float4* src = p == 0 ? in : out;
    for (long long i = first; i < n4; i += stride) {
      float4 v = src[i];
      v.x = fmaf(v.x, a, b);
      v.y = fmaf(v.y, a, b);
      v.z = fmaf(v.z, a, b);
      v.w = fmaf(v.w, a, b);
      out[i] = v;
    }
  }
}

}  // namespace

extern "C" {

// x (n floats, n a multiple of 8, 16-byte aligned) -> out after ``iters``
// steps of fmaf(a, x, b) per element.  Returns the launch's CUDA error.
int fma_chain_launch(const float* in, float* out, long long n, int iters, float a, float b,
                     void* stream) {
  if (n < 8 || n % 8 || iters < 0) return cudaErrorInvalidValue;
  const long long n8 = n / 8;
  const long long blocks = (n8 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fma_chain_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out), n8, iters, a, b);
  return static_cast<int>(cudaGetLastError());
}

// x (n floats, n a multiple of 4, 16-byte aligned) -> out after ``passes``
// passes of fmaf(x, a, b) over the whole array, on ``blocks`` blocks.
int stream_launch(const float* in, float* out, long long n, int passes, float a, float b, int blocks,
                  void* stream) {
  if (n < 4 || n % 4 || passes < 1 || blocks < 1) return cudaErrorInvalidValue;
  stream_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out), n / 4, passes, a, b);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
