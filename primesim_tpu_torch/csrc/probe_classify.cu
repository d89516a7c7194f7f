// probe_classify: phase 1 of the step for every core.
//
// Replaces the Pallas kernel primesim_tpu/kernels/step_kernels.py:
// probe_classify (_probe_kernel). It probes the accessed L1 set across the
// planes and applies the local run's deferred LRU / E->M patch, validates
// each way through its recorded directory pointer (tag, owner, sharer
// bit), classifies the hit, parses the home LLC row, computes the
// popcount / self-bit / other-sharer predicates and picks the LLC victim
// by first-minimum LRU. Under the coarse sharer vector (logG > 0: each
// sharer bit covers 2^logG cores) the self bit is the core's group's, a
// group-bit S copy also needs its fill-time epoch (L1 plane 4) equal to
// the entry's epoch at its pointer, and other-sharers is "any bit set".
// Unlike the Pallas kernel, which needs the rows
// staged for it (Mosaic cannot gather), it reads the directory itself:
// the validation words at dirm[ptr / W2] and the home row dirm[slot]. It
// also returns the home-row words commit_step needs (tag, LRU and epoch at
// the hit way; LRU and epoch at the victim). Requires 0 <= ptr < NS*W2
// for every pointer of the accessed set (the engine's pointers are
// slot*W2 + way, and 0 from the start). Plain version:
// kernels/step_kernels.py.
//
// Bound on the H100: device-memory bytes. Per core it needs the 4*W1
// words of the accessed set, three words at each way's pointer, the home
// row's W2 tags, LRUs and owners and the hit and victim ways' sharer
// words: under 1 MB at 1024 cores, about 0.26 us at 3.35 TB/s. So a
// launch is bound by the latency of its dependent loads, not by bytes.
// Design: one warp per core, 8 cores per 256-thread block (128 blocks at
// 1024 cores, one per SM). Each round of loads is issued by many lanes at
// once: lane w < W1 loads way w's tag, state, LRU and pointer; lane
// v < W2 the home row's tag, owner, LRU and epoch of way v; lane k < rl
// run-patch slot k (hm and wm as the bytes of the bool tensors, cm
// through its row stride); then lane w the three words at way w's pointer
// while lane n < NW loads sharer word n of the hit and the victim way,
// coalesced. Three dependent rounds of memory in all. Warp primitives do
// the rest with the Pallas kernel's first-occurrence tie-breaking:
// first-true is __ballot_sync + __ffs, first-minimum __reduce_min_sync on
// the signed key and a ballot of the lanes equal to it, the popcount sum
// __reduce_add_sync, and the run patch an OR-reduction of each slot's way
// bit. NW > 32 loops in strides of 32 lanes; W1, W2 and rl are at most
// 32 (the wrapper raises otherwise). The coarse mode branches on the
// launch argument logG, the same for every thread: its two extra words
// per way (the L1 epoch in round 2, the entry's epoch in round 3) ride
// the existing rounds, and the full-map path loads nothing more.
// Staged-rows mode (staged = 1, a core shard of a tile mesh, whose
// directory rows live on other shards): the caller stages the rows, as the
// Pallas kernel's contract has it, vrows[c][w] the row at way w's pointer
// and mrows[c] the home row, and the kernel reads those instead of dirm.
// Nothing else changes; the launch's C lanes are then a block of the
// machine's cores, cid[] their global ids.
// Batch: one launch serves B simulations of one geometry (the fleet's).
// Warp g is core c = g % C of element b = g / C: its L1 row, lanes and
// outputs sit at g (the batch is [B, C]-major), its directory at
// dirm + b*NS*DW (a 64-bit offset), its step number at step[b]; the core
// ids cid[C] are shared. A solo call is B = 1.

#include <climits>

#include "common.cuh"

using namespace psim;

namespace {

constexpr int PROBE_LANES = 16;
constexpr int WARPS = 8;  // cores per block
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32) probe_classify_kernel(
    const int* __restrict__ l1, const int* __restrict__ dirm,
    const int* __restrict__ slot_v, const int* __restrict__ line_v,
    const int* __restrict__ cid_v, const int* __restrict__ step_p,
    const uint8_t* __restrict__ hm, const uint8_t* __restrict__ wm,
    const int* __restrict__ cm, int* __restrict__ tag_out,
    int* __restrict__ lru_out, int* __restrict__ weff_out,
    int* __restrict__ shw_out, int* __restrict__ vshw_out,
    int* __restrict__ lanes_out, const int* __restrict__ vrows,
    const int* __restrict__ mrows, int B, int C, int NS, int S1, int W1,
    int W2, int NW, int MW, int DW, int rl, int cm_ld, int logG, int staged) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);  // over B*C
  if (c >= B * C) return;  // the whole warp
  const int b = c / C;  // the element
  const int FS = W1 * S1;
  const int line = line_v[c];
  const int cid = cid_v[c - b * C];
  dirm += (size_t)b * NS * DW;  // the element's directory
  const int* mr = staged ? mrows + (size_t)c * DW : dirm + (size_t)slot_v[c] * DW;
  const int step = step_p[b];
  const int l1s = line & (S1 - 1);
  const bool coarse = logG > 0;  // uniform across the launch
  const int grp = cid >> logG;  // the core's sharer bit: itself or its group
  const int u_w = grp >> 5, u_b = grp & 31;  // self sharer word / bit
  const bool is_way = lane < W1, is_llc = lane < W2;

  // ---- round 2: the accessed set's way, the home row's way, run slot
  const int* row = l1 + (size_t)c * 5 * FS + lane * S1 + l1s;
  int tag = 0, st = I, lru = 0, ptr = 0, eph = 0;
  if (is_way) {
    tag = row[0];
    st = row[FS];
    lru = row[2 * FS];
    ptr = row[3 * FS];
    if (coarse) eph = row[4 * FS];  // the fill-time epoch
  }
  int ltag = -1, lown = 0, llru = 0, leph = 0;
  if (is_llc) {
    ltag = mr[2 * lane];
    lown = mr[2 * lane + 1];
    llru = mr[2 * W2 + lane];
    leph = mr[3 * W2 + lane];
  }
  unsigned hbits = 0, wbits = 0;  // ways the run stamps / upgrades
  if (lane < rl) {
    const int d = cm[(size_t)c * cm_ld + lane] - l1s;
    if (d >= 0 && d % S1 == 0 && d / S1 < W1) {
      const unsigned bit = 1u << (d / S1);
      if (hm[(size_t)c * rl + lane]) hbits = bit;
      if (wm[(size_t)c * rl + lane]) wbits = bit;
    }
  }
  hbits = __reduce_or_sync(FULL, hbits);
  wbits = __reduce_or_sync(FULL, wbits);
  if ((wbits >> lane) & 1u) st = M;
  if ((hbits >> lane) & 1u) lru = step;

  // ---- LLC home-row parse: hit way, owner, victim
  const unsigned lmatch = __ballot_sync(FULL, is_llc && ltag == line);
  const int llc_has = lmatch != 0;
  const int hway = llc_has ? __ffs(lmatch) - 1 : 0;
  const int vkey = is_llc ? (ltag != -1 ? llru : -1) : INT_MAX;
  const int vmin = __reduce_min_sync(FULL, vkey);
  const int vway = __ffs(__ballot_sync(FULL, is_llc && vkey == vmin)) - 1;

  // ---- round 3: validation words at each way's pointer; the hit and
  // victim ways' sharer words
  int weff = I;
  if (is_way) {
    const int pway = floor_mod(ptr, W2);
    const int* pr = staged ? vrows + ((size_t)c * W1 + lane) * DW
                           : dirm + (size_t)floor_div(ptr, W2) * DW;
    const int vtag = pr[2 * pway];
    const int vown = pr[2 * pway + 1];
    const int vsh = pr[MW + pway * NW + u_w];
    // a group bit keeps the copy only if no sharer-clearing transition
    // bumped the entry's epoch since the fill
    const bool vbit = bit_at(vsh, u_b) && (!coarse || pr[3 * W2 + pway] == eph);
    weff = (st == I || vtag != tag) ? I : (vown == cid ? st : (vbit ? S : I));
  }
  unsigned total = 0;
  int self_bit = 0;
  for (int n = lane; n < NW; n += 32) {
    const int hw = mr[MW + hway * NW + n];
    const int vw = mr[MW + vway * NW + n];
    shw_out[(size_t)c * NW + n] = hw;
    vshw_out[(size_t)c * NW + n] = vw;
    total += (unsigned)popc(hw);
    if (n == u_w) self_bit = bit_at(hw, u_b);
  }
  total = __reduce_add_sync(FULL, total);
  self_bit = (int)__reduce_or_sync(FULL, (unsigned)self_bit);

  // ---- hit classification (argmax of an all-False row is way 0)
  const unsigned hmatch = __ballot_sync(FULL, is_way && tag == line && weff != I);
  const int hit_any = hmatch != 0;
  const int hit_way = hit_any ? __ffs(hmatch) - 1 : 0;
  const int hit_state = __shfl_sync(FULL, weff, hit_way);
  if (is_way) {
    tag_out[(size_t)c * W1 + lane] = tag;
    lru_out[(size_t)c * W1 + lane] = lru;
    weff_out[(size_t)c * W1 + lane] = weff;
  }
  const int owner = __shfl_sync(FULL, lown, hway);
  const int htag = __shfl_sync(FULL, ltag, hway);
  const int hlru = __shfl_sync(FULL, llru, hway);
  const int heph = __shfl_sync(FULL, leph, hway);
  const int vtag = __shfl_sync(FULL, ltag, vway);
  const int vown = __shfl_sync(FULL, lown, vway);
  const int vlru = __shfl_sync(FULL, llru, vway);
  const int veph = __shfl_sync(FULL, leph, vway);
  if (lane == 0) {
    int* o = lanes_out + (size_t)c * PROBE_LANES;
    o[0] = hit_any;
    o[1] = hit_way;
    o[2] = hit_state;
    o[3] = llc_has;
    o[4] = hway;
    o[5] = owner;
    o[6] = self_bit;
    o[7] = coarse ? total > 0 : (int)total - self_bit > 0;
    o[8] = vtag;
    o[9] = vown;
    o[10] = vway;
    o[11] = htag;
    o[12] = hlru;
    o[13] = heph;
    o[14] = vlru;
    o[15] = veph;
  }
}

}  // namespace

extern "C" int probe_classify_launch(
    const int* l1, const int* dirm, const int* slot, const int* line,
    const int* cid, const int* step, const uint8_t* hm, const uint8_t* wm,
    const int* cm, int* tag_out, int* lru_out, int* weff_out, int* shw_out,
    int* vshw_out, int* lanes_out, const int* vrows, const int* mrows, int B,
    int C, int NS, int S1, int W1, int W2, int NW, int MW, int DW, int rl,
    int cm_ld, int logG, int staged, cudaStream_t stream) {
  probe_classify_kernel<<<(B * C + WARPS - 1) / WARPS, WARPS * 32, 0,
                          stream>>>(
      l1, dirm, slot, line, cid, step, hm, wm, cm, tag_out, lru_out,
      weff_out, shw_out, vshw_out, lanes_out, vrows, mrows, B, C, NS, S1, W1,
      W2, NW, MW, DW, rl, cm_ld, logG, staged);
  return (int)cudaGetLastError();
}
