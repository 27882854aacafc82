// Batched Montgomery product for NVIDIA GPUs, called from JAX through the
// XLA foreign function interface (see ops/cuda_mont.py).
//
// Operands are canonical 16-bit limbs in uint32, limbs-major: a (L, Ba),
// b (L, Bb), n (L, Bn), each width 1 (shared across the batch) or B.  The
// result is T = (a*b + M*n) / R with R = 2^(16L) and M = -a*b*n^-1 mod R,
// as (L, B) canonical limbs: the exact value montgomery._mont_mul_jnp
// returns, so for inputs < 2n and R > 4n it is < 2n (Walter's bound).
//
// One thread owns one batch column.  It packs limb pairs into 32-bit words
// (S = ceil(L/2)) and runs FIOS Montgomery multiplication with 32-bit
// digits, the accumulator and its operands kept in shared memory.  When L
// is odd the top digit of b is a 16-bit half step, so the product divides
// by exactly 2^(16L).  -n^-1 mod 2^32 is derived in the kernel from the
// lowest word of n (Newton iteration).

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 32;              // columns per block
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ uint32_t load_word(const uint32_t* x, int L, int j,
                                              int64_t row_stride,
                                              int64_t col) {
  uint32_t lo = x[(int64_t)(2 * j) * row_stride + col] & 0xFFFFu;
  uint32_t hi = (2 * j + 1 < L)
                    ? (x[(int64_t)(2 * j + 1) * row_stride + col] & 0xFFFFu)
                    : 0u;
  return lo | (hi << 16);
}

__global__ void mont_mul_kernel(const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b,
                                const uint32_t* __restrict__ n,
                                uint32_t* __restrict__ out, int L, int64_t B,
                                int64_t a_cols, int64_t b_cols,
                                int64_t n_cols) {
  extern __shared__ uint32_t smem[];
  const int S = (L + 1) / 2;
  const int tid = threadIdx.x;
  const int64_t col = (int64_t)blockIdx.x * kThreads + tid;
  const bool n_shared = (n_cols == 1);

  // Layout, word-major so a warp's accesses fall in distinct banks:
  // t[S+1][kThreads] accumulator, A[S][kThreads], N[S][1 or kThreads].
  uint32_t* t = smem;
  uint32_t* A = t + (S + 1) * kThreads;
  uint32_t* N = A + S * kThreads;
  const int n_row = n_shared ? 1 : kThreads;
  const int n_off = n_shared ? 0 : tid;

  if (n_shared) {
    for (int j = tid; j < S; j += kThreads) N[j] = load_word(n, L, j, 1, 0);
  }
  __syncthreads();
  if (col >= B) return;

  const int64_t ca = (a_cols == 1) ? 0 : col;
  const int64_t cb = (b_cols == 1) ? 0 : col;
  for (int j = 0; j < S; ++j) {
    A[j * kThreads + tid] = load_word(a, L, j, a_cols, ca);
    t[j * kThreads + tid] = 0u;
    if (!n_shared) N[j * kThreads + tid] = load_word(n, L, j, n_cols, col);
  }
  t[S * kThreads + tid] = 0u;

#define T(j) t[(j) * kThreads + tid]
#define AW(j) A[(j) * kThreads + tid]
#define NW(j) N[(j) * n_row + n_off]

  // ninv = -n^-1 mod 2^32; n odd, so n*n == 1 mod 8 seeds 3 correct bits.
  const uint32_t n0 = NW(0);
  uint32_t inv = n0;
  for (int k = 0; k < 4; ++k) inv *= 2u - n0 * inv;
  const uint32_t ninv = 0u - inv;

  // Full 32-bit digits: t = (t + bi*A + m*N) / 2^32.
  const int full = L / 2;
  for (int i = 0; i < full; ++i) {
    const uint32_t bi = load_word(b, L, i, b_cols, cb);
    uint64_t p = (uint64_t)AW(0) * bi + T(0);
    const uint32_t m = (uint32_t)p * ninv;
    uint64_t q = (uint64_t)m * NW(0) + (uint32_t)p;  // low word is 0
    uint64_t c1 = p >> 32, c2 = q >> 32;
    for (int j = 1; j < S; ++j) {
      p = (uint64_t)AW(j) * bi + T(j) + c1;
      c1 = p >> 32;
      q = (uint64_t)m * NW(j) + (uint32_t)p + c2;
      c2 = q >> 32;
      T(j - 1) = (uint32_t)q;
    }
    p = (uint64_t)T(S) + c1 + c2;
    T(S - 1) = (uint32_t)p;
    T(S) = (uint32_t)(p >> 32);
  }

  // Odd L: the top 16-bit digit, t = (t + d*A + m*N) / 2^16.
  if (L & 1) {
    const uint32_t d = b[(int64_t)(L - 1) * b_cols + cb] & 0xFFFFu;
    uint64_t s = (uint64_t)AW(0) * d + T(0);
    const uint32_t m = ((uint32_t)s * ninv) & 0xFFFFu;
    s += (uint64_t)m * NW(0);                         // low 16 bits are 0
    uint64_t c = s >> 32;
    uint32_t prev = (uint32_t)s;
    for (int j = 1; j < S; ++j) {
      s = (uint64_t)AW(j) * d + (uint64_t)m * NW(j) + T(j) + c;
      c = s >> 32;
      const uint32_t w = (uint32_t)s;
      T(j - 1) = (prev >> 16) | (w << 16);
      prev = w;
    }
    s = (uint64_t)T(S) + c;
    const uint32_t w = (uint32_t)s;
    T(S - 1) = (prev >> 16) | (w << 16);
    T(S) = (w >> 16) | ((uint32_t)(s >> 32) << 16);
  }

  for (int j = 0; j < S; ++j) {
    const uint32_t w = T(j);
    out[(int64_t)(2 * j) * B + col] = w & 0xFFFFu;
    if (2 * j + 1 < L) out[(int64_t)(2 * j + 1) * B + col] = w >> 16;
  }
#undef T
#undef AW
#undef NW
}

ffi::Error MontMulImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> a,
                       ffi::Buffer<ffi::U32> b, ffi::Buffer<ffi::U32> n,
                       ffi::ResultBuffer<ffi::U32> out) {
  auto ad = a.dimensions(), bd = b.dimensions(), nd = n.dimensions();
  auto od = out->dimensions();
  if (ad.size() != 2 || bd.size() != 2 || nd.size() != 2 || od.size() != 2)
    return ffi::Error::InvalidArgument("mont_mul: operands must be rank 2");
  const int64_t L = od[0], B = od[1];
  if (ad[0] != L || bd[0] != L || nd[0] != L)
    return ffi::Error::InvalidArgument("mont_mul: limb counts differ");
  for (int64_t w : {ad[1], bd[1], nd[1]}) {
    if (w != 1 && w != B)
      return ffi::Error::InvalidArgument("mont_mul: batch width mismatch");
  }
  if (B == 0) return ffi::Error::Success();

  const int S = (int)((L + 1) / 2);
  const size_t n_words = (nd[1] == 1) ? (size_t)S : (size_t)S * kThreads;
  const size_t smem =
      ((size_t)(2 * S + 1) * kThreads + n_words) * sizeof(uint32_t);
  if (smem > kDefaultSmem) {
    // A per-device attribute: set it on every call, for whichever card
    // this stream belongs to.
    cudaError_t err = cudaFuncSetAttribute(
        mont_mul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess)
      return ffi::Error::Internal(
          std::string("mont_mul: modulus too wide for shared memory: ") +
          cudaGetErrorString(err));
  }
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  mont_mul_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      a.typed_data(), b.typed_data(), n.typed_data(), out->typed_data(),
      (int)L, B, ad[1], bd[1], nd[1]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("mont_mul: launch failed: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(PaillierMontMul, MontMulImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>());
