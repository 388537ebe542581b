// PIC PRK particle push (paper §VI hot loop), one thread per particle.
//
// Replaces the TPU kernel repro/kernels/pic_push/kernel.py pic_push_pallas
// (body _push_kernel): find the cell by floor, sum the Coulomb force of
// the four periodic corner charges q q_c / max(r^2, 1e-12) d / max(r,
// 1e-6), leapfrog x += v dt + a dt^2 / 2, v += a dt, and wrap by jnp.mod's
// rule (fmod, then + L where the remainder is non-zero and negative).
//
// What bounds it on the H100: bytes — 36 bytes an item (five f32 read,
// four written) against some 100 flops.  Design: one thread per particle
// with coalesced loads and stores; the fixed (L, L) charge grid (4 MB at
// L = 1000) is read through __ldg and stays in the 50 MB L2.  There is no
// scatter: PRK deposits no charge.  Built with -fmad=false so it rounds
// exactly where the plain PyTorch version rounds.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int imod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ float jnp_mod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r += b;
  return r;
}

__global__ void pic_push_kernel(const float* __restrict__ grid,
                                const float* __restrict__ x,
                                const float* __restrict__ y,
                                const float* __restrict__ vx,
                                const float* __restrict__ vy,
                                const float* __restrict__ q,
                                float* __restrict__ xo, float* __restrict__ yo,
                                float* __restrict__ vxo,
                                float* __restrict__ vyo, int n, int L,
                                float dt, float mass) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i], yi = y[i], qi = q[i];
  const int i0 = (int)floorf(xi);
  const int j0 = (int)floorf(yi);
  float fx = 0.0f, fy = 0.0f;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
      const float qc = __ldg(&grid[imod(i0 + di, L) * L + imod(j0 + dj, L)]);
      const float dx = xi - (float)(i0 + di);
      const float dy = yi - (float)(j0 + dj);
      const float r2 = dx * dx + dy * dy;
      const float r = sqrtf(r2);
      const float f = qi * qc / fmaxf(r2, 1e-12f);
      fx = fx + f * dx / fmaxf(r, 1e-6f);
      fy = fy + f * dy / fmaxf(r, 1e-6f);
    }
  }
  const float ax = fx / mass;
  const float ay = fy / mass;
  const float fL = (float)L;
  xo[i] = jnp_mod(xi + vx[i] * dt + 0.5f * ax * dt * dt, fL);
  yo[i] = jnp_mod(yi + vy[i] * dt + 0.5f * ay * dt * dt, fL);
  vxo[i] = vx[i] + ax * dt;
  vyo[i] = vy[i] + ay * dt;
}

}  // namespace

extern "C" int pic_push_launch(void* grid, void* x, void* y, void* vx,
                               void* vy, void* q, void* xo, void* yo,
                               void* vxo, void* vyo, int n, int L, float dt,
                               float mass, void* stream) {
  const int nt = 256;
  pic_push_kernel<<<(n + nt - 1) / nt, nt, 0, (cudaStream_t)stream>>>(
      (const float*)grid, (const float*)x, (const float*)y, (const float*)vx,
      (const float*)vy, (const float*)q, (float*)xo, (float*)yo, (float*)vxo,
      (float*)vyo, n, L, dt, mass);
  return (int)cudaGetLastError();
}
