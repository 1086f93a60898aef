// Rollout kernels of the batched MCTS, hand-written for Hopper (sm_90a).
//
// descend_backprop replaces bokego_tpu/ops/rollout.py::descend_backprop
// (Pallas body `_kernel`) and the scan of light search steps around it
// (bokego_tpu/search/mcts.py::run_search): `rollouts` consecutive rollouts
// per tree in one launch, each a fused PUCT descent, the leaf's cached
// value, the in-place (N, Wv) backprop over the traversed edges and the
// root's own stat update.  write_rows replaces
// bokego_tpu/ops/rollout.py::write_rows (Pallas body `_write_rows_kernel`):
// expansion's parent-row write, in place.
//
// Both work on the per-parent stats rows `pstats f32[B, Nmax, 8, 128]`:
// channel planes (N, Wq, Wv, prior, child, child-terminal, 2 pad) by
// lane-padded actions (81 real; the child plane is -1 in lanes 81..127,
// which is why lanes past 83 are never loaded).
//
// What bounds descend_backprop on the H100: latency, far above the bytes.
// A rollout needs 81 actions of 4 planes (5 when Wq is mixed in) of one row
// per tree level, 8 bytes per traversed edge and one child-terminal float:
// at B=1024 and 6 levels a few MB, a few microseconds at 3.35 TB/s.  But
// each level's load depends on the previous level's choice, so a tree is a
// chain of dependent memory round trips with a reduction between them, the
// launch itself costs microseconds on the device and tens on the host, and
// between two leaf evaluations nothing but this chain runs.  The design:
//  - one launch runs every rollout up to the next evaluation: one warp owns
//    one tree and loops over its rollouts with a __syncwarp() between one
//    rollout's edge writes and the next one's loads, so the rows a tree
//    walks again come from L1/L2 and the host is not in the loop;
//  - per level a lane loads 4 actions of each needed plane as one float4;
//    lanes 21..31 hold only padding and load nothing; Wq is loaded only
//    when its weight is not 0 (a template flag); the child-terminal plane is
//    read as one float, for the last rollout's final edge;
//  - the leaf's value is requested together with each level's row, so the
//    walk's end does not wait for one more round trip;
//  - the argmax is one warp max-reduce of an order-preserving key and one
//    ballot (lowest lane = lowest action), the visit sum one integer
//    warp add-reduce; divisions are kept on their fast path (div_pos);
//  - the path stays in registers (lane i holds level i's edge and the N and
//    Wv it read there), so the backprop is stores only;
//  - the root's stats live in registers for the whole launch.
// All 1024 trees are resident at once so that their chains overlap.
// `pstats` is read with ordinary (coherent) loads and is not `__restrict__`:
// a warp reads rows its own lanes wrote one rollout earlier.
// write_rows moves at most 4 KB per masked tree with float4 loads and
// stores, one CTA per tree.
//
// Numerics follow the JAX kernel exactly: build with -fmad=false (no FMA
// contraction) and IEEE sqrt/division, and keep its order of operations.
// Exact score ties go to the lowest action index.  `rollouts` launches of
// one rollout and one launch of `rollouts` give the same bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int LANE_PAD = 128;
constexpr int ROW = 8 * LANE_PAD;  // floats per (8, 128) row
constexpr int C_N = 0, C_WQ = 1, C_WV = 2, C_PRIOR = 3, C_CHILD = 4, C_TERM = 5;
constexpr int MAX_LEVELS = 32;  // one traversed edge per lane
static_assert(MAX_LEVELS <= 32, "the backprop keeps one level per lane");
constexpr int TREES_PER_CTA = 8;  // one warp per tree
constexpr int ACTIONS = 81;
constexpr int ACTION_LANES = (ACTIONS + 3) / 4;  // lanes whose float4 holds a real action
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float pick(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 load4(const float* row, int plane, int lane) {
  return *reinterpret_cast<const float4*>(row + plane * LANE_PAD + 4 * lane);
}

// Unsigned key with the order of the floats (no NaN; -0 and +0 equal).
__device__ __forceinline__ unsigned order_key(float x) {
  unsigned u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// num / den for a positive, normal den, bit for bit, without the division's
// slow path: a zero numerator (a prior of 0 in every padded or illegal
// action, a Wv of 0 while values are pending) leaves the fast path, and one
// such lane makes its whole warp wait.  0 / den is the numerator itself.
// (As inline PTX: the compiler would fold the two selects back into num / den.)
__device__ __forceinline__ float div_pos(float num, float den) {
  float q;
  asm("div.rn.f32 %0, %1, %2;" : "=f"(q) : "f"(num == 0.f ? 1.f : num), "f"(den));
  return num == 0.f ? num : q;
}

// An ordinary global load that stays where it is written: the compiler would
// sink a plain one to its only use, after the loads it should overlap with.
__device__ __forceinline__ float load_now(const float* p) {
  float x;
  asm volatile("ld.global.f32 %0, [%1];" : "=f"(x) : "l"(p));
  return x;
}

template <bool USE_WQ>
__global__ void __launch_bounds__(TREES_PER_CTA * 32)
descend_backprop_kernel(float* pstats, const float* __restrict__ value,
                        const long long* __restrict__ root, float* __restrict__ root_stats,
                        float* __restrict__ res, int B, int n_pool, int levels, int rollouts,
                        float c, float w, float cw, int use_value) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * TREES_PER_CTA + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  float* tree = pstats + (size_t)b * n_pool * ROW;
  const float* val = value + (size_t)b * n_pool;

  const long long r = root[b];
  if (r < 0 || r >= n_pool) __trap();
  const int root_node = (int)r;
  const bool has_actions = lane < ACTION_LANES;
  // The root's own (N, Wq, Wv), kept in registers by every lane.
  float rs_n = root_stats[3 * b], rs_wq = root_stats[3 * b + 1], rs_wv = root_stats[3 * b + 2];

  // What `res` reports: the last rollout's.
  int cur = root_node, depth = 0, last_node = 0, last_act = 0;
  float leaf_n = 0.f, v = 0.f, prev_root_n = rs_n;
  bool unvalued = false;

  for (int it = 0; it < rollouts; ++it) {
    // Orders the previous rollout's edge stores before this one's loads.
    if (it > 0) __syncwarp();
    cur = root_node;
    depth = 0;
    leaf_n = 0.f;
    // Lane i keeps level i's edge (node, action) and the N and Wv read
    // there in registers for the backprop: no per-thread history array (no
    // local memory), and no second read of the edge.
    int my_node = 0, my_act = 0;
    float my_n = 0.f, my_wv = 0.f;
    float vsel = 0.f;
    bool have_v = false;

    for (int i = 0; i < levels; ++i) {
      const float* row = tree + (size_t)cur * ROW;
      const float vcur = load_now(val + cur);  // in flight with the row: used if the walk ends here
      float4 n4 = make_float4(0.f, 0.f, 0.f, 0.f), wq4 = n4, wv4 = n4, pr4 = n4;
      float4 ch4 = make_float4(-1.f, -1.f, -1.f, -1.f);
      if (has_actions) {
        n4 = load4(row, C_N, lane);
        if (USE_WQ) wq4 = load4(row, C_WQ, lane);
        wv4 = load4(row, C_WV, lane);
        pr4 = load4(row, C_PRIOR, lane);
        ch4 = load4(row, C_CHILD, lane);
      }

      // Visits summed over valid children: counts, so whole numbers, exact in
      // any order and through an integer sum.
      float total = 0.f;
      bool any_valid = false;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (pick(ch4, k) >= 0.f) {
          total += pick(n4, k);
          any_valid = true;
        }
      }
      if (!__any_sync(FULL, any_valid)) {  // a childless node ends the walk
        vsel = vcur;
        have_v = true;
        break;
      }
      total = (float)__reduce_add_sync(FULL, (int)total);
      const float sq = sqrtf(fmaxf(total, 1.f));

      // PUCT score, in the JAX kernel's order of operations; the lane's best
      // of its 4 actions, the lowest on ties.
      float best = -INFINITY, best_child = -1.f, best_n = 0.f, best_wv = 0.f;
      int best_a = 4 * lane;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float n = pick(n4, k);
        const float mix = USE_WQ ? cw * pick(wq4, k) + w * pick(wv4, k) : w * pick(wv4, k);
        const float avg = n > 0.f ? div_pos(mix, fmaxf(n, 1.f)) : 0.f;
        float score = -avg + div_pos(c * pick(pr4, k) * sq, 1.f + n);
        if (!(pick(ch4, k) >= 0.f)) score = -INFINITY;
        if (k == 0 || score > best) {
          best = score;
          best_a = 4 * lane + k;
          best_child = pick(ch4, k);
          best_n = n;
          best_wv = pick(wv4, k);
        }
      }
      // Warp argmax: the lowest lane holding the maximum has the lowest action.
      const unsigned key = order_key(best);
      const unsigned top = __reduce_max_sync(FULL, key);
      const int owner = __ffs(__ballot_sync(FULL, key == top)) - 1;
      const int act = __shfl_sync(FULL, best_a, owner);
      const float child = __shfl_sync(FULL, best_child, owner);
      leaf_n = __shfl_sync(FULL, best_n, owner);
      const float edge_wv = __shfl_sync(FULL, best_wv, owner);
      if (lane == i) {
        my_node = cur;
        my_act = act;
        my_n = leaf_n;
        my_wv = edge_wv;
      }
      last_node = cur;
      last_act = act;
      cur = (int)child;
      ++depth;
    }

    if (!have_v) vsel = val[cur];  // the walk ran out of levels
    unvalued = isnan(vsel);
    v = unvalued ? 0.f : vsel;

    // Backprop in place, one traversed edge per lane: level i's row holds the
    // edge to the node at depth i+1, whose sign is (-1)^(depth-i-1).  Trees
    // are disjoint and a walk never revisits a row: no races.
    if (lane < depth) {
      float* edge = tree + (size_t)my_node * ROW + my_act;
      edge[C_N * LANE_PAD] = my_n + 1.f;
      if (use_value) {
        const float sign = ((depth - lane - 1) % 2 == 0) ? 1.f : -1.f;
        edge[C_WV * LANE_PAD] = my_wv + sign * v;
      }
    }

    // The root's own update, from the root player's side.
    const float root_sign = (depth % 2 == 0) ? 1.f : -1.f;
    prev_root_n = rs_n;
    rs_n += 1.f;
    rs_wq += 0.f;
    rs_wv += use_value ? root_sign * v : 0.f;
  }

  if (lane == 0 && rollouts > 0) {
    root_stats[3 * b] = rs_n;
    root_stats[3 * b + 1] = rs_wq;
    root_stats[3 * b + 2] = rs_wv;
  }
  const float leaf_term =
      depth > 0 ? tree[(size_t)last_node * ROW + C_TERM * LANE_PAD + last_act] : 0.f;

  // res lanes: [leaf, depth, leaf_n, v, unvalued, leaf_terminal, root N
  // before the last rollout, 0...]
  float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lane == 0) out = make_float4((float)cur, (float)depth, leaf_n, v);
  if (lane == 1) out = make_float4(unvalued ? 1.f : 0.f, leaf_term, prev_root_n, 0.f);
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
                                       float* root_stats, float* res, int B, int n_pool,
                                       int levels, int rollouts, float c, float w, float cw,
                                       int use_value, void* stream) {
  if (B > 0) {
    const int grid = (B + TREES_PER_CTA - 1) / TREES_PER_CTA;
    auto kernel = cw != 0.f ? descend_backprop_kernel<true> : descend_backprop_kernel<false>;
    kernel<<<grid, TREES_PER_CTA * 32, 0, (cudaStream_t)stream>>>(
        pstats, value, root, root_stats, res, B, n_pool, levels, rollouts, c, w, cw, use_value);
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
