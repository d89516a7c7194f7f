// router_cascade: the hop-by-hop router's wait floors, contention cascade
// and per-hop departures.
//
// Replaces the Pallas kernel primesim_tpu/kernels/router_kernels.py:
// router_cascade (_cascade_kernel). For each core and each leg (request,
// reply, and the barrier-arrival leg when legs == 3) over its H hops:
//   F_k   = ok_k ? max(lf_k, bs_k) + r_k * L : SENT
//   cum_k = max_{k' <= k} (F_k' - k' * c),        c = L + R
//   dep_k = max(t1, cum_k) + k * c + L,           t1 = t_start + R
//   t_end = max(t1, cum_{H-1}) + hops * c
// The request and arrival legs start at t0, the reply leg at the request
// leg's t_end + service. Plain version: kernels/router_kernels.py.
//
// Bound on the H100: bytes. The work is a few integer operations per hop
// over [C, legs*H] rows (C = 1024, H = 62 at rung 3), about 1.6 MB in and
// 0.5 MB out at most, so the card could finish in under a microsecond.
// Design: one warp per core. Each leg's row is read coalesced in chunks
// of 32 hops; a __shfl_up_sync max-scan gives each chunk's prefix max,
// and the running max carries from one chunk to the next (the last
// lane's value), so any H works. The reply leg follows the request leg in
// the same warp. The hop mask is read as bytes straight from the bool
// tensor, and the latencies through pointers to 0-d device tensors, so a
// step never waits for the host. Adds and products go through uint32_t
// (common.cuh): int32 wraps in JAX, while signed overflow is undefined in
// C++.

#include <climits>

#include "common.cuh"

using namespace psim;

namespace {

constexpr int WARPS = 4;  // cores per block
constexpr int SENT = -(1 << 30) - (1 << 21);
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

// One leg of one core, run by the whole warp; returns the leg's end time.
__device__ int cascade_leg(const int* __restrict__ lf,
                           const int* __restrict__ bs,
                           const int* __restrict__ r,
                           const uint8_t* __restrict__ ok,
                           int* __restrict__ dep, int H, int t_start, int nh,
                           int L, int R, int c, int lane) {
  const int t1 = wrap_add(t_start, R);
  int run = INT_MIN;  // cummax of the chunks before this one
  for (int base = 0; base < H; base += 32) {
    const int k = base + lane;
    int g = INT_MIN;  // hops past H never win a max
    if (k < H) {
      const int f = ok[k] ? wrap_add(max(lf[k], bs[k]), wrap_mul(r[k], L)) : SENT;
      g = wrap_sub(f, wrap_mul(k, c));
    }
    for (int off = 1; off < 32; off <<= 1) {  // inclusive max-scan
      const int n = __shfl_up_sync(FULL, g, off);
      if (lane >= off) g = max(g, n);
    }
    const int cum = max(run, g);
    if (k < H) dep[k] = wrap_add(wrap_add(max(t1, cum), wrap_mul(k, c)), L);
    run = __shfl_sync(FULL, cum, 31);
  }
  return wrap_add(max(t1, run), wrap_mul(nh, c));
}

__global__ void router_cascade_kernel(
    const int* __restrict__ lf, const int* __restrict__ bs,
    const int* __restrict__ r, const uint8_t* __restrict__ ok,
    const int* __restrict__ t0, const int* __restrict__ service,
    const int* __restrict__ req_hops, const int* __restrict__ rep_hops,
    const int* __restrict__ arr_hops, const int* __restrict__ link_p,
    const int* __restrict__ router_p, int* __restrict__ t_rep_end,
    int* __restrict__ t_arr_end, int* __restrict__ departs, int C, int H,
    int legs) {
  const int core = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (core >= C) return;  // the whole warp leaves together
  const int L = *link_p, R = *router_p, c = wrap_add(L, R);
  const size_t row = (size_t)core * legs * H;
  const int t_start = t0[core];
  const int t_req = cascade_leg(lf + row, bs + row, r + row, ok + row,
                                departs + row, H, t_start, req_hops[core], L,
                                R, c, lane);
  const size_t rep = row + H;
  const int t_rep = cascade_leg(lf + rep, bs + rep, r + rep, ok + rep,
                                departs + rep, H,
                                wrap_add(t_req, service[core]),
                                rep_hops[core], L, R, c, lane);
  if (lane == 0) t_rep_end[core] = t_rep;
  if (legs == 3) {
    const size_t arr = row + 2 * (size_t)H;
    const int t_arr = cascade_leg(lf + arr, bs + arr, r + arr, ok + arr,
                                  departs + arr, H, t_start, arr_hops[core],
                                  L, R, c, lane);
    if (lane == 0) t_arr_end[core] = t_arr;
  }
}

}  // namespace

extern "C" int router_cascade_launch(
    const int* lf, const int* bs, const int* r, const uint8_t* ok,
    const int* t0, const int* service, const int* req_hops,
    const int* rep_hops, const int* arr_hops, const int* link,
    const int* router, int* t_rep_end, int* t_arr_end, int* departs, int C,
    int H, int legs, cudaStream_t stream) {
  const int blocks = (C + WARPS - 1) / WARPS;
  router_cascade_kernel<<<blocks, WARPS * 32, 0, stream>>>(
      lf, bs, r, ok, t0, service, req_hops, rep_hops, arr_hops, link, router,
      t_rep_end, t_arr_end, departs, C, H, legs);
  return (int)cudaGetLastError();
}
