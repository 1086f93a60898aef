// The trunk epilogue of AlphaGo Zero's residual tower, hand-written for Hopper (sm_90a).
//
// One kernel, bias_add_relu, in place on a convolution's output: for a
// channels-last activation y (B, C, H, W), a bias (C,) and an optional
// residual r of y's shape and layout,
//     y = relu((y + bias) + r)      or      y = relu(y + bias)
// with every element taken to float, added in that order and rounded to y's
// type once (bf16 or float).  models/resnet.py's serving copy runs each trunk
// convolution through cuDNN without its bias and then this kernel: the stem
// and each block's first convolution without a residual, each block's second
// with the block's input.  It replaces no Pallas kernel: the JAX package left
// the bias, the residual add and the ReLU to XLA's fusion; eager PyTorch ran
// them as three passes (a broadcast bias add_, the residual add, the ReLU).
//
// What bounds it on the H100: bytes, with no arithmetic worth the name.  At
// B=1024, C=256 on the 9x9 board a bf16 activation is 42.5 MB: 85 MB read and
// written without the residual, 127 MB with it, 25 and 38 us at 3.35 TB/s.
// The design streams those bytes once:
//  - each thread loads and stores 16 bytes at a time (8 bf16 or 4 float),
//    neighbouring threads on neighbouring addresses; channels are innermost
//    in memory, so with C % 8 == 0 a vector never crosses a pixel;
//  - a grid of a few resident blocks per SM walks the tensor with a stride
//    that is a multiple of C's vectors, so a thread keeps the same channels
//    throughout and reads its bias once, into registers;
//  - each thread issues UNROLL independent loads (and as many of the
//    residual) before it computes and stores, so enough bytes are in flight
//    to cover the memory's latency on every SM.
// Rounding: bf16 -> float is exact; float -> bf16 rounds to nearest even
// (cvt.rn), as PyTorch's conversion does; no FMA is involved (adds only).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;
constexpr int UNROLL = 4;

// Sixteen bytes of T widened to float and narrowed back.
template <typename T>
struct Lanes;

template <>
struct Lanes<float> {
  static constexpr int N = 4;
  __device__ static void widen(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 narrow(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void widen(const uint4& v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // the lower half of a word is the lower element
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static unsigned pack(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&p);
  }
  __device__ static uint4 narrow(const float* f) {
    return make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]), pack(f[6], f[7]));
  }
};

// y, bias and residual as 16-byte vectors: n_vec of y, c_vec a pixel.
template <typename T, bool RESIDUAL>
__global__ void __launch_bounds__(THREADS)
    bias_add_relu_kernel(uint4* y, const uint4* __restrict__ bias,
                         const uint4* __restrict__ residual, long long n_vec, int c_vec,
                         long long stride) {
  using L = Lanes<T>;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (first >= stride) return;
  float b[L::N];
  L::widen(__ldg(bias + first % c_vec), b);
  for (long long i = first; i < n_vec; i += UNROLL * stride) {
    uint4 yv[UNROLL], rv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long j = i + u * stride;
      if (j < n_vec) {
        yv[u] = y[j];
        if (RESIDUAL) rv[u] = __ldg(residual + j);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long j = i + u * stride;
      if (j < n_vec) {
        float v[L::N], r[L::N];
        L::widen(yv[u], v);
        if (RESIDUAL) L::widen(rv[u], r);
#pragma unroll
        for (int k = 0; k < L::N; ++k) {
          float s = v[k] + b[k];
          if (RESIDUAL) s = s + r[k];
          v[k] = s < 0.f ? 0.f : s;  // NaN stays NaN, as torch.relu keeps it
        }
        y[j] = L::narrow(v);
      }
    }
  }
}

template <typename T>
int launch(void* y, const void* bias, const void* residual, long long n, int c,
           cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  constexpr int N = Lanes<T>::N;
  const long long n_vec = n / N;
  const int c_vec = c / N;
  long long stride = (long long)sms * BLOCKS_PER_SM * THREADS;
  if (stride > n_vec) stride = n_vec;
  stride = stride / c_vec * c_vec;  // a thread keeps its channels
  if (stride < c_vec) stride = c_vec;
  const int grid = (int)((stride + THREADS - 1) / THREADS);
  if (residual != nullptr) {
    bias_add_relu_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        (uint4*)y, (const uint4*)bias, (const uint4*)residual, n_vec, c_vec, stride);
  } else {
    bias_add_relu_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        (uint4*)y, (const uint4*)bias, nullptr, n_vec, c_vec, stride);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// n elements of y, c channels (c % 8 == 0, n % c == 0); residual may be null;
// bf16 selects __nv_bfloat16 over float.
extern "C" int bokego_bias_add_relu(void* y, const void* bias, const void* residual, long long n,
                                    int c, int bf16, void* stream) {
  if (c <= 0 || c % 8 != 0 || n % c != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  return bf16 ? launch<__nv_bfloat16>(y, bias, residual, n, c, (cudaStream_t)stream)
              : launch<float>(y, bias, residual, n, c, (cudaStream_t)stream);
}
