// router_cascade: the hop-by-hop router's wait floors, contention cascade
// and departures, with the link gathers and the departure scatter-max.
//
// Replaces the Pallas kernel primesim_tpu/kernels/router_kernels.py:
// router_cascade (_cascade_kernel) together with the gathers and the
// scatter the JAX engine stages around it (primesim_tpu/sim/engine.py:
// st.link_free[pc], base[pc] and link_free.at[tgt].max(departs,
// mode="drop")), which Mosaic cannot express. For each core and each leg
// (request, reply, and the barrier-arrival leg when legs == 3) over the
// H hops of its route p_k:
//   F_k   = ok_k ? max(link_free[p_k], base[p_k]) + r_k * L : SENT
//   cum_k = max_{k' <= k} (F_k' - k' * c),        c = L + R
//   dep_k = max(t1, cum_k) + k * c + L,           t1 = t_start + R
//   t_end = max(t1, cum_{H-1}) + hops * c
// and link_free_out[p_k] = max(link_free_out[p_k], dep_k) for every live
// hop (ok_k), masked hops dropped. The request and arrival legs start at
// t0, the reply leg at the request leg's t_end + service. ok_k implies
// 0 <= p_k < len(link_free), as the engine builds it. Plain version:
// kernels/router_kernels.py.
//
// Bound on the H100: bytes, and in practice the latency of dependent
// loads. The function needs every hop's mask byte, and only at the live
// hops (636 of 126,976 on a rung-3 step) the route, link clock, base and
// rank words and a read-modify-write of the departure: about 0.16 MB at
// 1024 cores.
// Design: one warp per core, 8 cores per 256-thread block; lane l holds
// hops l, l+32, ... of every leg (CH = ceil(H/32) chunks, at most 8, so
// H <= 256; the wrapper raises above). All memory is read in three
// rounds, every leg at once, before the cascade: the mask bytes (straight
// from the bool tensor) with the lanes; the route and rank at the live
// hops; link_free and base at those routes. A masked hop takes
// SENT - k*c, a hop past H never wins a max. Then each leg runs in
// registers, the reply leg after the request leg's end. A chunk with no
// live hop needs no departures, so it skips the scan: one
// __reduce_max_sync carries the running max over its masked hops exactly
// (clocks are clamped at -2^30 after a rebase, so t1 may lie below SENT
// and those terms can matter). A live chunk runs a __shfl_up_sync
// max-scan, and its live lanes atomicMax their departures into
// link_free_out. That buffer is not the one the floors read (the caller
// clones link_free into it), so no core sees another's departures, and a
// signed atomicMax on int32 gives the drop-scatter's result whatever the
// order of duplicate targets. The latencies are read through pointers to
// 0-d device tensors, so a step never waits for the host. Adds and
// products go through uint32_t (common.cuh): int32 wraps in JAX, while
// signed overflow is undefined in C++.

#include <climits>

#include "common.cuh"

using namespace psim;

namespace {

constexpr int WARPS = 8;  // cores per block
constexpr int LEGS = 3;   // at most: request, reply, barrier arrival
constexpr int SENT = -(1 << 30) - (1 << 21);
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

// One leg of one core, run by the whole warp on the offset floors g (hop
// j*32 + lane in g[j]) and routes p; bit j of `live` marks a live hop.
// Scatter-maxes the departures and returns the leg's end time.
template <int CH>
__device__ __forceinline__ int cascade_leg(const int (&g)[CH],
                                           const int (&p)[CH], unsigned live,
                                           int* link_free_out, int t_start,
                                           int nh, int L, int R, int c,
                                           int lane) {
  const int t1 = wrap_add(t_start, R);
  int run = INT_MIN;  // cummax of the chunks before this one
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const bool lv = (live >> j) & 1u;
    int x = g[j];
    if (!__ballot_sync(FULL, lv)) {  // no departure in this chunk
      run = max(run, __reduce_max_sync(FULL, x));
      continue;
    }
    for (int off = 1; off < 32; off <<= 1) {  // inclusive max-scan
      const int n = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x = max(x, n);
    }
    const int cum = max(run, x);
    if (lv)
      atomicMax(link_free_out + p[j],
                wrap_add(wrap_add(max(t1, cum), wrap_mul(j * 32 + lane, c)), L));
    run = __shfl_sync(FULL, cum, 31);
  }
  return wrap_add(max(t1, run), wrap_mul(nh, c));
}

template <int CH>
__global__ void __launch_bounds__(WARPS * 32) router_cascade_kernel(
    const int* __restrict__ link_free, const int* __restrict__ base,
    const int* __restrict__ pth, const uint8_t* __restrict__ ok,
    const int* __restrict__ r, const int* __restrict__ t0,
    const int* __restrict__ service, const int* __restrict__ req_hops,
    const int* __restrict__ rep_hops, const int* __restrict__ arr_hops,
    const int* __restrict__ link_p, const int* __restrict__ router_p,
    int* __restrict__ t_rep_end, int* __restrict__ t_arr_end,
    int* link_free_out, int C, int H, int legs) {
  const int core = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (core >= C) return;  // the whole warp leaves together
  const size_t row = (size_t)core * legs * H;

  // round 1: every hop's mask byte, and the lanes
  unsigned live = 0;  // bit l*CH + j: hop j*32 + lane of leg l
#pragma unroll
  for (int l = 0; l < LEGS; ++l)
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int k = j * 32 + lane;
      if (l < legs && k < H && ok[row + l * H + k]) live |= 1u << (l * CH + j);
    }
  const int L = *link_p, R = *router_p, c = wrap_add(L, R);
  const int t_start = t0[core], svc = service[core];
  const int nh_req = req_hops[core], nh_rep = rep_hops[core];
  const int nh_arr = legs == 3 ? arr_hops[core] : 0;

  // round 2: route and rank at the live hops (the rank parks in g)
  int p[LEGS][CH], g[LEGS][CH];
#pragma unroll
  for (int l = 0; l < LEGS; ++l)
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      p[l][j] = g[l][j] = 0;
      if ((live >> (l * CH + j)) & 1u) {
        const size_t at = row + l * H + j * 32 + lane;
        p[l][j] = pth[at];
        g[l][j] = r[at];
      }
    }

  // round 3: link clock and base at those routes; the offset floors
#pragma unroll
  for (int l = 0; l < LEGS; ++l)
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int k = j * 32 + lane;
      if ((live >> (l * CH + j)) & 1u) {
        const int f = wrap_add(max(link_free[p[l][j]], base[p[l][j]]),
                               wrap_mul(g[l][j], L));
        g[l][j] = wrap_sub(f, wrap_mul(k, c));
      } else {
        g[l][j] = k < H ? wrap_sub(SENT, wrap_mul(k, c)) : INT_MIN;
      }
    }

  const int t_req = cascade_leg<CH>(g[0], p[0], live, link_free_out,
                                    t_start, nh_req, L, R, c, lane);
  const int t_rep = cascade_leg<CH>(g[1], p[1], live >> CH, link_free_out,
                                    wrap_add(t_req, svc), nh_rep, L, R, c,
                                    lane);
  if (lane == 0) t_rep_end[core] = t_rep;
  if (legs == 3) {
    const int t_arr = cascade_leg<CH>(g[2], p[2], live >> (2 * CH),
                                      link_free_out, t_start, nh_arr, L, R,
                                      c, lane);
    if (lane == 0) t_arr_end[core] = t_arr;
  }
}

}  // namespace

extern "C" int router_cascade_launch(
    const int* link_free, const int* base, const int* pth, const uint8_t* ok,
    const int* r, const int* t0, const int* service, const int* req_hops,
    const int* rep_hops, const int* arr_hops, const int* link,
    const int* router, int* t_rep_end, int* t_arr_end, int* link_free_out,
    int C, int H, int legs, cudaStream_t stream) {
  const int blocks = (C + WARPS - 1) / WARPS;
#define PSIM_CASCADE(CH)                                                    \
  case CH:                                                                  \
    router_cascade_kernel<CH><<<blocks, WARPS * 32, 0, stream>>>(           \
        link_free, base, pth, ok, r, t0, service, req_hops, rep_hops,       \
        arr_hops, link, router, t_rep_end, t_arr_end, link_free_out, C, H,  \
        legs);                                                              \
    break;
  switch ((H + 31) / 32) {
    PSIM_CASCADE(1)
    PSIM_CASCADE(2)
    PSIM_CASCADE(3)
    PSIM_CASCADE(4)
    PSIM_CASCADE(5)
    PSIM_CASCADE(6)
    PSIM_CASCADE(7)
    PSIM_CASCADE(8)
    default:
      return (int)cudaErrorInvalidValue;  // H > 256: the wrapper raises first
  }
#undef PSIM_CASCADE
  return (int)cudaGetLastError();
}
