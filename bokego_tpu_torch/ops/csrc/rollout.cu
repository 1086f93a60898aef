// Rollout kernels of the batched MCTS, hand-written for Hopper (sm_90a).
//
// descend_backprop replaces bokego_tpu/ops/rollout.py::descend_backprop
// (Pallas body `_kernel`): one fused PUCT descent per tree, the leaf's cached
// value, and the in-place (N, Wv) backprop over the traversed edges.
// write_rows replaces bokego_tpu/ops/rollout.py::write_rows (Pallas body
// `_write_rows_kernel`): expansion's parent-row write, in place.
//
// Both work on the per-parent stats rows `pstats f32[B, Nmax, 8, 128]`:
// channel planes (N, Wq, Wv, prior, child, child-terminal, 2 pad) by
// lane-padded actions (81 real, child plane padded with -1).
//
// What bounds them on the H100: latency, far above the bytes.  A rollout
// reads one 3 KB slice (6 planes x 128 lanes) of one row per tree level and
// writes 8 bytes per traversed edge, so at B=1024 and 6 levels it moves at
// most ~19 MB, a few microseconds at 3.35 TB/s.  But each level's load
// depends on the previous level's choice, so a tree is a chain of dependent
// memory round trips with a reduction between them, and the launch itself
// costs microseconds.  The design: one warp per tree, each lane holding 4 of
// the 128 action lanes of every plane and loading them 16 bytes at a time
// (one coalesced 512-byte request per plane per level, the six issued
// together), all 1024 trees resident at once so their chains overlap,
// reductions in warp shuffles, the path kept in registers (lane i holds
// level i's edge), and no shared memory or TPU-style staging.  write_rows
// moves at most 4 KB per masked tree with float4 loads and stores, one CTA
// per tree.
//
// Numerics follow the JAX kernel exactly: build with -fmad=false (no FMA
// contraction) and IEEE sqrt/division, and keep its order of operations.
// Exact score ties go to the lowest action index.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int LANE_PAD = 128;
constexpr int ROW = 8 * LANE_PAD;  // floats per (8, 128) row
constexpr int C_N = 0, C_WQ = 1, C_WV = 2, C_PRIOR = 3, C_CHILD = 4, C_TERM = 5;
constexpr int MAX_LEVELS = 32;  // one traversed edge per lane
static_assert(MAX_LEVELS <= 32, "the backprop keeps one level per lane");
constexpr int TREES_PER_CTA = 8;  // one warp per tree
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float pick(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 load4(const float* row, int plane, int lane) {
  return *reinterpret_cast<const float4*>(row + plane * LANE_PAD + 4 * lane);
}

__global__ void __launch_bounds__(TREES_PER_CTA * 32)
descend_backprop_kernel(float* __restrict__ pstats, const float* __restrict__ value,
                        const long long* __restrict__ root, float* __restrict__ res, int B,
                        int n_pool, int levels, float c, float w, float cw,
                        int use_value) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * TREES_PER_CTA + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  float* tree = pstats + (size_t)b * n_pool * ROW;

  const long long r = root[b];
  if (r < 0 || r >= n_pool) __trap();
  int cur = (int)r;
  int depth = 0;
  float leaf_n = 0.f, leaf_term = 0.f;
  // Lane i keeps level i's edge (node, action) in registers for the
  // backprop: no per-thread history array, so no local memory.
  int my_node = 0, my_act = 0;

  for (int i = 0; i < levels; ++i) {
    const float* row = tree + (size_t)cur * ROW;
    const float4 n4 = load4(row, C_N, lane), wq4 = load4(row, C_WQ, lane);
    const float4 wv4 = load4(row, C_WV, lane), pr4 = load4(row, C_PRIOR, lane);
    const float4 ch4 = load4(row, C_CHILD, lane), tm4 = load4(row, C_TERM, lane);

    // Visits summed over valid children (integers: exact in any order).
    float total = 0.f;
    bool any_valid = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (pick(ch4, k) >= 0.f) {
        total += pick(n4, k);
        any_valid = true;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(FULL, total, off);
    const float sq = sqrtf(fmaxf(total, 1.f));

    // PUCT score, in the JAX kernel's order of operations.
    float best = -INFINITY;
    int best_a = LANE_PAD;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float n = pick(n4, k);
      const float avg = n > 0.f ? (cw * pick(wq4, k) + w * pick(wv4, k)) / fmaxf(n, 1.f) : 0.f;
      float score = -avg + c * pick(pr4, k) * sq / (1.f + n);
      if (!(pick(ch4, k) >= 0.f)) score = -INFINITY;
      const int a = 4 * lane + k;
      if (score > best || (score == best && a < best_a)) {
        best = score;
        best_a = a;
      }
    }
    // Butterfly argmax: every lane ends with the (max, lowest index) pair.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(FULL, best, off);
      const int oa = __shfl_xor_sync(FULL, best_a, off);
      if (ob > best || (ob == best && oa < best_a)) {
        best = ob;
        best_a = oa;
      }
    }
    const bool internal = __any_sync(FULL, any_valid);
    if (!internal) break;  // a childless node ends the walk
    const int owner = best_a >> 2, k = best_a & 3;
    const float child = __shfl_sync(FULL, pick(ch4, k), owner);
    leaf_n = __shfl_sync(FULL, pick(n4, k), owner);
    leaf_term = __shfl_sync(FULL, pick(tm4, k), owner);
    if (lane == i) {
      my_node = cur;
      my_act = best_a;
    }
    cur = (int)child;
    ++depth;
  }

  const float vsel = value[(size_t)b * n_pool + cur];
  const bool unvalued = isnan(vsel);
  const float v = unvalued ? 0.f : vsel;

  // Backprop in place, one traversed edge per lane: level i's row holds the
  // edge to the node at depth i+1, whose sign is (-1)^(depth-i-1).  Trees
  // are disjoint and a walk never revisits a row: no races.
  if (lane < depth) {
    float* edge = tree + (size_t)my_node * ROW + my_act;
    edge[C_N * LANE_PAD] += 1.f;
    if (use_value) {
      const float sign = ((depth - lane - 1) % 2 == 0) ? 1.f : -1.f;
      edge[C_WV * LANE_PAD] += sign * v;
    }
  }

  // res lanes: [leaf, depth, leaf_n, v, unvalued, leaf_terminal, 0...]
  float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lane == 0) out = make_float4((float)cur, (float)depth, leaf_n, v);
  if (lane == 1) out = make_float4(unvalued ? 1.f : 0.f, leaf_term, 0.f, 0.f);
  *reinterpret_cast<float4*>(res + (size_t)b * LANE_PAD + 4 * lane) = out;
}

__global__ void __launch_bounds__(ROW / 4)
write_rows_kernel(float* __restrict__ pstats, const long long* __restrict__ node,
                  const float* __restrict__ rows, const unsigned char* __restrict__ mask,
                  int n_pool) {
  const int b = blockIdx.x;
  if (!mask[b]) return;
  const long long nd = node[b];
  if (nd < 0 || nd >= n_pool) __trap();
  float4* dst = reinterpret_cast<float4*>(pstats + ((size_t)b * n_pool + nd) * ROW);
  const float4* src = reinterpret_cast<const float4*>(rows + (size_t)b * ROW);
  dst[threadIdx.x] = src[threadIdx.x];
}

}  // namespace

extern "C" int bokego_max_levels() { return MAX_LEVELS; }

extern "C" int bokego_descend_backprop(float* pstats, const float* value, const long long* root,
                                       float* res, int B, int n_pool, int levels, float c,
                                       float w, float cw, int use_value, void* stream) {
  if (B > 0) {
    const int grid = (B + TREES_PER_CTA - 1) / TREES_PER_CTA;
    descend_backprop_kernel<<<grid, TREES_PER_CTA * 32, 0, (cudaStream_t)stream>>>(
        pstats, value, root, res, B, n_pool, levels, c, w, cw, use_value);
  }
  return (int)cudaGetLastError();
}

extern "C" int bokego_write_rows(float* pstats, const long long* node, const float* rows,
                                 const unsigned char* mask, int B, int n_pool, void* stream) {
  if (B > 0) {
    write_rows_kernel<<<B, ROW / 4, 0, (cudaStream_t)stream>>>(pstats, node, rows, mask,
                                                               n_pool);
  }
  return (int)cudaGetLastError();
}
