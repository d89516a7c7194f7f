// probe_classify: phase 1 of the step for every core.
//
// Replaces the Pallas kernel primesim_tpu/kernels/step_kernels.py:
// probe_classify (_probe_kernel). It probes the accessed L1 set across the
// five planes and applies the local run's deferred LRU / E->M patch,
// validates each way through its recorded directory pointer (tag, owner,
// sharer bit), classifies the hit, parses the home LLC row, computes the
// popcount / self-bit / other-sharer predicates and picks the LLC victim
// by first-minimum LRU. Plain version: kernels/step_kernels.py.
//
// Bound on the H100: device-memory bytes. Per core it needs the 5*W1
// words of the accessed L1 set, the W1 staged pointer rows (of which it
// reads 3 words per way) and the home row; at 1024 cores that is a few
// MB at most, so a single launch is dominated by latency, not bandwidth.
// Design: one thread per core indexes every column directly (the Pallas
// kernel's static masked-select unrolls exist only because Mosaic cannot
// gather). Loads are per-thread scattered rows; coalescing them through
// shared memory is later work.

#include "common.cuh"

using namespace psim;

namespace {

constexpr int PROBE_LANES = 11;

__global__ void probe_classify_kernel(
    const int* __restrict__ l1, const int* __restrict__ vrows,
    const int* __restrict__ mrows, const int* __restrict__ line_v,
    const int* __restrict__ cid_v, const int* __restrict__ step_p,
    const int* __restrict__ hm, const int* __restrict__ wm,
    const int* __restrict__ cm, int* __restrict__ tag_out,
    int* __restrict__ lru_out, int* __restrict__ weff_out,
    int* __restrict__ shw_out, int* __restrict__ vshw_out,
    int* __restrict__ lanes_out, int C, int S1, int W1, int W2, int NW,
    int MW, int DW, int rl) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int FS = W1 * S1;
  const int* row = l1 + (size_t)c * 5 * FS;
  const int* vr = vrows + (size_t)c * W1 * DW;
  const int* mr = mrows + (size_t)c * DW;
  const int line = line_v[c];
  const int cid = cid_v[c];
  const int step = *step_p;
  const int l1s = line & (S1 - 1);
  const int u_w = cid >> 5, u_b = cid & 31;  // self sharer word / bit

  // ---- L1 set probe, run patch, pointer validation, hit classification
  int hit_any = 0, hit_way = 0, hit_state = 0;
  for (int w = 0; w < W1; ++w) {
    const int col = w * S1 + l1s;
    const int tag = row[col];
    int st = row[FS + col];
    int lru = row[2 * FS + col];
    const int ptr = row[3 * FS + col];
    for (int k = 0; k < rl; ++k) {
      if (cm[(size_t)c * rl + k] == col) {
        if (wm[(size_t)c * rl + k]) st = M;
        if (hm[(size_t)c * rl + k]) lru = step;
      }
    }
    const int pway = floor_mod(ptr, W2);
    const int* vw = vr + (size_t)w * DW;
    const int vtag = vw[2 * pway];
    const int vown = vw[2 * pway + 1];
    const int vbit = bit_at(vw[MW + pway * NW + u_w], u_b);
    const int weff =
        (st == I || vtag != tag) ? I : (vown == cid ? st : (vbit ? S : I));
    tag_out[(size_t)c * W1 + w] = tag;
    lru_out[(size_t)c * W1 + w] = lru;
    weff_out[(size_t)c * W1 + w] = weff;
    if (w == 0) hit_state = weff;  // argmax of an all-False row is way 0
    if (!hit_any && tag == line && weff != I) {
      hit_any = 1;
      hit_way = w;
      hit_state = weff;
    }
  }

  // ---- LLC home-row parse
  int llc_has = 0, llc_hway = 0;
  for (int v = 0; v < W2; ++v) {
    if (!llc_has && mr[2 * v] == line) {
      llc_has = 1;
      llc_hway = v;
    }
  }
  const int owner = mr[2 * llc_hway + 1];
  int total = 0, self_bit = 0;
  for (int n = 0; n < NW; ++n) {
    const int word = mr[MW + llc_hway * NW + n];
    shw_out[(size_t)c * NW + n] = word;
    total += popc(word);
    if (n == u_w) self_bit = bit_at(word, u_b);
  }
  const int other_sh = (total - self_bit) > 0;

  // ---- victim: first minimum of LRU over valid ways (-1 for invalid)
  int vway = 0, vmin = 0;
  for (int v = 0; v < W2; ++v) {
    const int key = mr[2 * v] != -1 ? mr[2 * W2 + v] : -1;
    if (v == 0 || key < vmin) {
      vmin = key;
      vway = v;
    }
  }
  for (int n = 0; n < NW; ++n)
    vshw_out[(size_t)c * NW + n] = mr[MW + vway * NW + n];

  int* lanes = lanes_out + (size_t)c * PROBE_LANES;
  lanes[0] = hit_any;
  lanes[1] = hit_way;
  lanes[2] = hit_state;
  lanes[3] = llc_has;
  lanes[4] = llc_hway;
  lanes[5] = owner;
  lanes[6] = self_bit;
  lanes[7] = other_sh;
  lanes[8] = mr[2 * vway];
  lanes[9] = mr[2 * vway + 1];
  lanes[10] = vway;
}

}  // namespace

extern "C" int probe_classify_launch(
    const int* l1, const int* vrows, const int* mrows, const int* line,
    const int* cid, const int* step, const int* hm, const int* wm,
    const int* cm, int* tag_out, int* lru_out, int* weff_out, int* shw_out,
    int* vshw_out, int* lanes_out, int C, int S1, int W1, int W2, int NW,
    int MW, int DW, int rl, cudaStream_t stream) {
  const int threads = 128;
  probe_classify_kernel<<<(C + threads - 1) / threads, threads, 0, stream>>>(
      l1, vrows, mrows, line, cid, step, hm, wm, cm, tag_out, lru_out,
      weff_out, shw_out, vshw_out, lanes_out, C, S1, W1, W2, NW, MW, DW, rl);
  return (int)cudaGetLastError();
}
