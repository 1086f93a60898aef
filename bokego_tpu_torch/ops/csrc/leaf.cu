// K5 leaf_tables: the eval phase's board analysis, hand-written for Hopper (sm_90a).
//
// For a batch of 9x9 positions (board (B, 81) int8, ko, turn and last move
// (B,) int64) one launch computes everything the search's eval step needs
// from them, with no host read:
//  - group info: labels (the group's lowest point, 81 at empty points), the
//    group's distinct liberties and its size at every stone, (B, 81) int64;
//  - move tables for the side to move: legal (B, 82) bool (index 81, the
//    pass, always legal), liberties after playing and stones captured by
//    playing (B, 81) int64, zeroed at illegal points;
//  - successors: the board after each of the 81 point moves and the pass
//    (B, 82, 81) int8, and their ko point (B, 82) int64;
//  - the 27 feature planes, float32 NHWC (B, 9, 9, 27).
// They equal env/rules.py's group_info, _analyze and _leaf_analysis and
// features.py's _planes bit for bit: everything is integer, and the planes
// are small integers in float32.  An output pointer may be null, and is then
// not written (features_batch asks for the planes alone).  K5 replaces no
// Pallas kernel: the JAX package's group_info is a jitted lax.while_loop
// (bokego_tpu/env/rules.py:94) and the rest is XLA's array code.  In eager
// PyTorch the same analysis took about 200 ops and a host read per label
// pass (about 9 a call), each pass draining the device's queue.
//
// Design:
//  - one CTA owns one board: 96 threads, thread p < 81 owns point p.  The
//    board, the labels and three 81-bit masks per group (its stones, its
//    liberties) and per candidate move (what it captures) live in shared
//    memory, about 3.5 KB a CTA, so a wave holds every board of B=1024.
//  - An 81-bit mask is three 32-bit words of 27 bits, word w holding rows
//    3w..3w+2, so point p is bit p % 27 of word p / 27.  A 4-neighbour
//    dilation is shifts by 1 (with the edge columns masked off) and by 9
//    (with the row that crosses into the next or previous word).
//  - Labels: min-label propagation with pointer jumping, the plain version's
//    pass, each thread on its own stone; the loop ends on __syncthreads_or of
//    "my label changed", so it needs no host and no fixed pass count.
//  - Liberties and sizes: each stone ORs its bit into its group's stone mask
//    and its empty neighbours into the group's liberty mask (shared
//    atomicOr); a group's liberties and size are the popcounts.
//  - One thread per candidate move p merges the stone masks of its own-colour
//    neighbours' groups (and p) into grp, ORs the stone masks of neighbouring
//    opponent groups with one liberty into cap, and reads
//        libs_after = popcount(((empty | cap) & ~p) & dilate(grp)),
//        caps = popcount(cap),  legal = empty(p) & libs_after > 0 & p != ko;
//    the successor's ko is cap's lowest point where caps == 1 and every
//    on-board neighbour of p is the opponent's.
//  - The CTA then writes its outputs cooperatively: the per-point tables a
//    thread a point, the successors' rows and the planes as flat runs of
//    bytes and floats, neighbouring threads on neighbouring addresses.
// Bound: about 19.5 KB a board leave the CTA (successors 6.6 KB, planes
// 8.7 KB, tables 4.0 KB), 19.9 MB at B=1024: 6 us at 3.35 TB/s.  The kernel
// is bound by the latency of the label loop's barriers and the dependent
// shared-memory steps, not by bytes; at B=1 a launch is latency alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NN = 81;
constexpr int NA = NN + 1;  // actions: 81 points and the pass
constexpr int PLANES = 27;
constexpr int THREADS = 96;
constexpr int NO_GROUP = NN;
constexpr long long NO_KO = -1;
constexpr uint32_t FULL = (1u << 27) - 1;
constexpr uint32_t COL0 = 1u | (1u << 9) | (1u << 18);  // column 0 of a word's three rows
constexpr uint32_t COL8 = COL0 << 8;
constexpr uint32_t ROW0 = 0x1ffu;

struct Mask {
  uint32_t w[3];
};

__device__ __forceinline__ void set_bit(Mask& m, int q) { m.w[q / 27] |= 1u << (q % 27); }

__device__ __forceinline__ bool has_bit(const uint32_t* m, int q) { return (m[q / 27] >> (q % 27)) & 1u; }

__device__ __forceinline__ void or_in(Mask& m, const uint32_t* x) {
  m.w[0] |= x[0];
  m.w[1] |= x[1];
  m.w[2] |= x[2];
}

__device__ __forceinline__ int popc(const uint32_t* x) { return __popc(x[0]) + __popc(x[1]) + __popc(x[2]); }

// m and its 4-neighbours.
__device__ __forceinline__ Mask dilate(const Mask& m) {
  Mask d;
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    const uint32_t x = m.w[w];
    uint32_t o = x | ((x << 1) & ~COL0 & FULL) | ((x >> 1) & ~COL8) | ((x << 9) & FULL) | (x >> 9);
    if (w > 0) o |= m.w[w - 1] >> 18;          // the row above, in the previous word
    if (w < 2) o |= (m.w[w + 1] & ROW0) << 18;  // the row below, in the next word
    d.w[w] = o;
  }
  return d;
}

// The k-th on-board neighbour of p (up, down, left, right), -1 off the board.
__device__ __forceinline__ int neighbour(int p, int k) {
  const int r = p / 9, c = p % 9;
  switch (k) {
    case 0: return r > 0 ? p - 9 : -1;
    case 1: return r < 8 ? p + 9 : -1;
    case 2: return c > 0 ? p - 1 : -1;
    default: return c < 8 ? p + 1 : -1;
  }
}

// Plane k at point q: 0 own stones, 1 opponent stones, 2 empty, 3 black to
// move, 4 last move, 5 legal, then liberties, liberties after playing and
// captures, each bucketed into 7 planes (i + 1 where the count is i + 1, the
// last 7 where it is above 6).
__device__ __forceinline__ float plane(int k, int q, int stone, int color, long long last, bool legal,
                                       int libs, int libs_after, int caps) {
  switch (k) {
    case 0: return stone == color ? 1.f : 0.f;
    case 1: return stone != 0 && stone != color ? 1.f : 0.f;
    case 2: return stone == 0 ? 1.f : 0.f;
    case 3: return color == 1 ? 1.f : 0.f;
    case 4: return (long long)q == last ? 1.f : 0.f;
    case 5: return legal ? 1.f : 0.f;
    default: {
      const int g = (k - 6) / 7, i = (k - 6) % 7;
      const int n = g == 0 ? libs : g == 1 ? libs_after : caps;
      if (i < 6) return n == i + 1 ? (float)(i + 1) : 0.f;
      return n > 6 ? 7.f : 0.f;
    }
  }
}

struct Out {
  long long *labels, *libs, *sizes;   // (B, 81)
  uint8_t* legal;                     // (B, 82)
  long long *libs_after, *caps;       // (B, 81)
  int8_t* child_board;                // (B, 82, 81)
  long long* child_ko;                // (B, 82)
  float* planes;                      // (B, 81, 27)
};

__global__ void __launch_bounds__(THREADS)
    leaf_tables_kernel(const int8_t* __restrict__ board, const long long* __restrict__ ko,
                       const long long* __restrict__ turn, const long long* __restrict__ last_move,
                       Out out) {
  __shared__ int8_t bd[NN];
  __shared__ int lab[NN];
  __shared__ uint32_t stone_m[NN][3], lib_m[NN][3], cap_m[NN][3];
  __shared__ uint32_t empty_m[3];
  __shared__ uint8_t libs_s[NN], libs_after_s[NN], caps_s[NN], legal_s[NN];

  const int b = blockIdx.x, p = threadIdx.x;
  const bool on = p < NN;
  const int color = (int)(turn[b] & 1) + 1;  // black (1) on even turns
  const int opp = 3 - color;
  const long long ko_b = ko[b];

  int c = 0;
  int nb[4];
  if (on) {
    c = board[(long long)b * NN + p];
    bd[p] = (int8_t)c;
    lab[p] = c != 0 ? p : NO_GROUP;
#pragma unroll
    for (int w = 0; w < 3; ++w) stone_m[p][w] = lib_m[p][w] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) nb[k] = neighbour(p, k);
  }
  if (p < 3) empty_m[p] = 0;
  __syncthreads();
  if (on && c == 0) atomicOr(&empty_m[p / 27], 1u << (p % 27));
  const bool stone = on && c != 0;

  // Labels: a pass takes the least label among same-colour neighbours, then
  // jumps to the label's own label; a label is always a stone of the group
  // no larger than the point, so the fixed point is the group's minimum.
  for (;;) {
    const int old = stone ? lab[p] : NO_GROUP;
    int m = old;
    if (stone) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = nb[k];
        if (n >= 0 && bd[n] == c) m = min(m, lab[n]);
      }
    }
    __syncthreads();
    if (stone) lab[p] = m;
    __syncthreads();
    const int j = stone ? lab[m] : NO_GROUP;
    __syncthreads();
    if (stone) lab[p] = j;
    if (!__syncthreads_or(stone && j != old)) break;
  }

  // Groups' stone and liberty masks.
  const int L = stone ? lab[p] : NO_GROUP;
  if (stone) {
    atomicOr(&stone_m[L][p / 27], 1u << (p % 27));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = nb[k];
      if (n >= 0 && bd[n] == 0) atomicOr(&lib_m[L][n / 27], 1u << (n % 27));
    }
  }
  __syncthreads();
  const long long row = (long long)b * NN + p;
  if (on) {
    const int libs = stone ? popc(lib_m[L]) : 0;
    libs_s[p] = (uint8_t)libs;
    if (out.labels) {
      out.labels[row] = L;
      out.libs[row] = libs;
      out.sizes[row] = stone ? popc(stone_m[L]) : 0;
    }
  }
  __syncthreads();

  // The candidate move at p.
  if (on) {
    Mask grp = {{0, 0, 0}}, cap = {{0, 0, 0}};
    set_bit(grp, p);
    bool surrounded = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = nb[k];
      if (n < 0) continue;
      const int cn = bd[n];
      if (cn == color) or_in(grp, stone_m[lab[n]]);
      if (cn == opp && libs_s[n] == 1) or_in(cap, stone_m[lab[n]]);
      surrounded = surrounded && cn == opp;
    }
    const Mask d = dilate(grp);
    Mask after;
#pragma unroll
    for (int w = 0; w < 3; ++w) after.w[w] = (empty_m[w] | cap.w[w]) & d.w[w];
    after.w[p / 27] &= ~(1u << (p % 27));
    const int libs_after = popc(after.w);
    const int caps = popc(cap.w);
    const bool legal = c == 0 && libs_after > 0 && (long long)p != ko_b;
    const int caps_l = legal ? caps : 0;
#pragma unroll
    for (int w = 0; w < 3; ++w) cap_m[p][w] = cap.w[w];
    legal_s[p] = legal;
    libs_after_s[p] = (uint8_t)(legal ? libs_after : 0);
    caps_s[p] = (uint8_t)caps_l;
    if (out.legal) {
      out.legal[(long long)b * NA + p] = legal;
      out.libs_after[row] = legal ? libs_after : 0;
      out.caps[row] = caps_l;
      long long new_ko = NO_KO;
      if (caps_l == 1 && surrounded) {
        const int w = cap.w[0] ? 0 : cap.w[1] ? 1 : 2;
        new_ko = w * 27 + __ffs(cap.w[w]) - 1;
      }
      out.child_ko[(long long)b * NA + p] = new_ko;
    }
  } else if (p == NN && out.legal) {  // the pass
    out.legal[(long long)b * NA + NN] = 1;
    out.child_ko[(long long)b * NA + NN] = NO_KO;
  }
  __syncthreads();

  if (out.child_board) {
    // Row a < 81: the board with the mover's stone at a and cap_m[a] emptied
    // (captures win over the placed stone); row 81, the pass: the board.
    int8_t* dst = out.child_board + (long long)b * NA * NN;
    for (int i = p; i < NA * NN; i += THREADS) {
      const int a = i / NN, q = i - a * NN;
      int v = bd[q];
      if (a < NN) {
        if (has_bit(cap_m[a], q)) v = 0;
        else if (q == a) v = color;
      }
      dst[i] = (int8_t)v;
    }
  }
  if (out.planes) {
    const long long last = last_move[b];
    float* dst = out.planes + (long long)b * NN * PLANES;
    for (int i = p; i < NN * PLANES; i += THREADS) {
      const int q = i / PLANES, k = i - q * PLANES;
      dst[i] = plane(k, q, bd[q], color, last, legal_s[q], libs_s[q], libs_after_s[q], caps_s[q]);
    }
  }
}

}  // namespace

// board (B, 81) int8; ko, turn, last_move (B,) int64; outputs as in Out, each
// null or all of a group null: the group tables (labels, libs, sizes), the
// move tables with the successors (legal, libs_after, caps, child_board,
// child_ko), the planes.
extern "C" int bokego_leaf_tables(const void* board, const void* ko, const void* turn, const void* last_move,
                                  int batch, void* labels, void* libs, void* sizes, void* legal,
                                  void* libs_after, void* caps, void* child_board, void* child_ko,
                                  void* planes, void* stream) {
  if (batch < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaGetLastError();
  Out out{(long long*)labels, (long long*)libs, (long long*)sizes, (uint8_t*)legal,
          (long long*)libs_after, (long long*)caps, (int8_t*)child_board, (long long*)child_ko,
          (float*)planes};
  leaf_tables_kernel<<<batch, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)board, (const long long*)ko, (const long long*)turn, (const long long*)last_move, out);
  return (int)cudaGetLastError();
}
