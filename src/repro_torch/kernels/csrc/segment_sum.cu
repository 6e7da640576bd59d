// Sorted segment sum (K3) for Hopper, fp32.
//
// Replaces no TPU kernel.  The reference sums a GNN layer's messages per
// destination with jax.ops.segment_sum (src/repro/gnn/models.py,
// src/repro/gnn/distributed.py), which XLA lowers itself.  The port's card
// path needs a deterministic sum (float atomics change their order from run
// to run), and the library's one, torch.segment_reduce, gives each
// (segment, column) pair one thread that walks the segment serially: a
// plan's padded arcs all land in their partition's dummy segment, so on
// SIoT's plan it walked 100,136 messages a call on a few threads (4.8 ms a
// call).  Given the stable argsort `order` of the destinations, the
// destinations in that order `keys` (ascending) and `offsets`, the
// exclusive prefix of the segment lengths with their total E at the end,
// it computes
//
//   out[s, c] = sum_{j = offsets[s]}^{offsets[s + 1] - 1} msg[order[j], c]
//
// for every segment s < n and column c < d.  An empty segment gives 0.
//
// Bound.  Two adds a message element's 4 bytes: far below the fp32 rate.
// The least time is set by bytes: each message row and its order once,
// the offsets and the output once, over HBM bandwidth.  The kernel reads
// the keys besides (8 bytes a message), though the offsets determine
// them: a position's segment found by a search of the offsets instead (a
// 16-ary search by each warp for its tile's first and last segments, then
// a binary search between them) ran slower on an H100, 0.026 against
// 0.014 ms at d = 1 over SIoT's 801,088 messages, its latency above the
// bytes it saves.
//
// Design.  The work is split by messages, not by segments: the sorted
// positions [0, E) are cut into tiles of kTile positions, so a long segment
// spreads over many tiles and no thread walks more than one tile.
//  * Pass 1 (a block or a warp a tile).  A segment that lies inside the
//    tile is written to `out` by its owner.  A segment cut by a tile
//    boundary leaves one partial per tile in `part`: slot 2t the tile's
//    first segment if it began in an earlier tile, slot 2t + 1 its last if
//    it goes on into a later one.
//    - d >= 3: a block a tile, lanes on columns (slices of G = 16 or 32
//      columns on grid y).  The block loads the tile's order and keys,
//      then all its message rows at once into shared memory, so a tile
//      costs two memory round trips however few tiles there are; G
//      threads, a lane a column, walk it: each segment of the tile is one
//      lane's sequential fadd chain in sorted (edge) order, its sum left
//      in shared memory, which the whole block then writes out.
//    - d <= 2: lanes run over messages (a warp a tile, 32 positions a
//      chunk): a segmented inclusive scan over the chunk by keys, with
//      shuffles at distances 1, 2, 4, 8, 16, then the carry of the
//      segment running in from the chunk before.  The lane at a
//      segment's end holds its sum.
//  * Pass 2.  An empty segment gets 0 (a thread writes 4, 2 or 1
//    adjacent elements, as d allows).  A segment cut across tiles t0 < t1
//    is part[2 t0 + 1] + part[2 (t0 + 1)] + ... + part[2 t1], added in
//    tile order by one block (the one of the boundary that cuts it first;
//    a warp a column, the partials 32 a round, a lane each, through
//    shuffles).  Every element of `out` is written once, with no zero
//    fill.
//
// Order.  Every sum's association is fixed by E, d and kTile alone: no
// atomics, no order that depends on scheduling.  The same inputs give the
// same bits from run to run and in a CUDA graph's replays.  Nothing is read
// back to the host; a call is these two launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;              // sorted positions a tile
constexpr int kChunks = kTile / 32;     // d <= 2: a warp's chunks a tile
constexpr int64_t kNoKey = -1;          // positions past E
constexpr unsigned kFull = 0xffffffffu;

// 64-bit loads and shuffles through long long, which every overload takes.
__device__ __forceinline__ int64_t ld64(const int64_t* p) {
  return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
}

__device__ __forceinline__ int64_t shfl64(unsigned mask, int64_t v, int src,
                                          int width = 32) {
  return (int64_t)__shfl_sync(mask, (long long)v, src, width);
}

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}

__device__ __forceinline__ void check_row(int64_t o, int64_t E) {
  if ((uint64_t)o >= (uint64_t)E) __trap();  // corrupt order
}

__device__ __forceinline__ void check_key(int64_t k, int64_t n) {
  if ((uint64_t)k >= (uint64_t)n) __trap();  // corrupt keys
}

// Where a finished sum of segment `key` goes: a slot of the tile's partials
// if the segment is cut there, else its output row.
__device__ __forceinline__ float* sum_row(float* out, float* part, int64_t t,
                                          int d, int64_t key, bool head,
                                          bool tail, bool* twice) {
  *twice = head && tail;
  if (head) return part + 2 * t * d;
  if (tail) return part + (2 * t + 1) * d;
  return out + key * d;
}

// ------------------------------------------------ pass 1, lanes on columns
// A block a tile and a slice of G columns (grid y): every thread loads a
// position's order and key, then rows of the tile into shared memory, all
// row loads in flight at once; the first G threads, a lane a column, walk
// the tile; every thread writes out sums.
template <int G>
__global__ void __launch_bounds__(kThreads)
segment_tiles_cols(const float* __restrict__ msg,
                   const int64_t* __restrict__ order,
                   const int64_t* __restrict__ keys,
                   float* __restrict__ out, float* __restrict__ part,
                   int64_t E, int64_t n, int d) {
  constexpr int kStep = kThreads / G;   // rows a pass of the block loads
  __shared__ float s_rows[kTile * G];
  __shared__ int64_t s_off[kTile];      // a position's row offset, o * d
  __shared__ int64_t s_keys[kTile + 1];  // and the key after the tile
  __shared__ unsigned s_ends[kTile / 32];  // bit p: a segment ends at p
  static_assert(kThreads == kTile, "a thread a position");
  const int64_t t = blockIdx.x;
  const int64_t a = t * kTile;
  const int64_t b = min64(E, a + kTile);
  const int m = (int)(b - a);
  {
    const int j = threadIdx.x;
    int64_t o = 0;  // past the tile, row 0: every row load is unconditional
    if (j < m) {
      o = ld64(order + a + j);
      check_row(o, E);
      s_keys[j] = ld64(keys + a + j);
    }
    if (j == 0) s_keys[m] = b < E ? ld64(keys + b) : kNoKey;
    s_off[j] = o * d;
  }
  __syncthreads();
  {
    // Bit j: position j ends its segment in the tile (the last one does).
    const int j = threadIdx.x;
    const bool end = j < m && (j + 1 == m || s_keys[j + 1] != s_keys[j]);
    const unsigned bits = __ballot_sync(kFull, end);
    if ((j & 31) == 0) s_ends[j / 32] = bits;
  }
  const int col = threadIdx.x % G;
  const int c = blockIdx.y * G + col;
  {
    const int cc = min(c, d - 1);
    float f[kTile / kStep];
#pragma unroll
    for (int i = 0; i < kTile / kStep; ++i)
      f[i] = __ldg(msg + s_off[threadIdx.x / G + i * kStep] + cc);
#pragma unroll
    for (int i = 0; i < kTile / kStep; ++i)
      s_rows[(threadIdx.x / G + i * kStep) * G + col] = f[i];
  }
  __syncthreads();
  if (threadIdx.x < G) {
    // The walk, 8 positions at a time: each segment one lane's fadd chain
    // in sorted order, its sum left in the row of its last position.
    // Values past m are added after the last end and never kept.
    float acc = 0.f;
    for (int p0 = 0; p0 < m; p0 += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = s_rows[(p0 + u) * G + col];
      const unsigned ends = s_ends[p0 / 32] >> (p0 % 32);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        acc += v[u];
        if ((ends >> u) & 1u) {
          s_rows[(p0 + u) * G + col] = acc;
          acc = 0.f;
        }
      }
    }
  }
  __syncthreads();
  // Every thread writes the sums of its positions' segments: the tile's
  // first segment to slot 2t if it began in an earlier tile, its last to
  // slot 2t + 1 if it goes on, any other to its output row.
  if (c >= d) return;
  int first_end = m - 1;
  for (int w = kTile / 32 - 1; w >= 0; --w)
    if (s_ends[w]) first_end = w * 32 + __ffs(s_ends[w]) - 1;
  const bool cut_head = a > 0 && ld64(keys + a - 1) == s_keys[0];
  const bool cut_tail = s_keys[m] == s_keys[m - 1];
#pragma unroll 4
  for (int i = 0; i < kTile / kStep; ++i) {
    const int p = threadIdx.x / G + i * kStep;
    if (!((s_ends[p / 32] >> (p % 32)) & 1u)) continue;
    const float sum = s_rows[p * G + col];
    const bool head = p == first_end && cut_head;
    const bool tail = p == m - 1 && cut_tail;
    if (head) part[2 * t * d + c] = sum;
    if (tail) part[(2 * t + 1) * d + c] = sum;
    if (!head && !tail) {
      const int64_t key = s_keys[p];
      check_key(key, n);
      out[key * d + c] = sum;
    }
  }
}

// ----------------------------------------------- pass 1, lanes on messages
template <int D>
__device__ __forceinline__ void load_msg(const float* msg, int64_t o,
                                         float (&v)[D]) {
  if constexpr (D == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(msg) + o);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = __ldg(msg + o);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
segment_tiles_msgs(const float* __restrict__ msg,
                   const int64_t* __restrict__ order,
                   const int64_t* __restrict__ keys,
                   float* __restrict__ out, float* __restrict__ part,
                   int64_t E, int64_t n, int64_t tiles) {
  const int lane = threadIdx.x & 31;
  const int64_t t = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (t >= tiles) return;  // the whole warp
  const int64_t a = t * kTile;
  const int64_t b = min64(E, a + kTile);
  int64_t k[kChunks], o[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t j = a + c * 32 + lane;
    o[c] = 0;
    k[c] = kNoKey;
    if (j < b) {
      o[c] = ld64(order + j);
      k[c] = ld64(keys + j);
    }
  }
  float v[kChunks][D];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    check_row(o[c], E);
    load_msg<D>(msg, o[c], v[c]);
    if (k[c] == kNoKey) {
#pragma unroll
      for (int q = 0; q < D; ++q) v[c][q] = 0.f;
    }
  }
  const int64_t first = shfl64(kFull, k[0], 0);
  const int64_t last = ld64(keys + b - 1);
  const bool cut_head = a > 0 && ld64(keys + a - 1) == first;
  const bool cut_tail = b < E && ld64(keys + b) == last;

  int64_t carry_k = kNoKey;
  float carry[D];
#pragma unroll
  for (int q = 0; q < D; ++q) carry[q] = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float s[D];
#pragma unroll
    for (int q = 0; q < D; ++q) s[q] = v[c][q];
#pragma unroll
    for (int dist = 1; dist < 32; dist *= 2) {
      const int64_t ky =
          (int64_t)__shfl_up_sync(kFull, (long long)k[c], dist);
      float y[D];
#pragma unroll
      for (int q = 0; q < D; ++q) y[q] = __shfl_up_sync(kFull, s[q], dist);
      if (lane >= dist && ky == k[c]) {
#pragma unroll
        for (int q = 0; q < D; ++q) s[q] += y[q];
      }
    }
    if (k[c] == carry_k) {  // the segment running in from the chunk before
#pragma unroll
      for (int q = 0; q < D; ++q) s[q] += carry[q];
    }
    const int64_t down =
        (int64_t)__shfl_down_sync(kFull, (long long)k[c], 1);
    const int64_t ahead =
        c + 1 < kChunks ? shfl64(kFull, k[c + 1 < kChunks ? c + 1 : c], 0)
                        : kNoKey;
    const int64_t next = lane == 31 ? ahead : down;
    if (k[c] != kNoKey && next != k[c]) {  // the end of a segment in the tile
      check_key(k[c], n);
      bool twice;
      float* row = sum_row(out, part, t, D, k[c], k[c] == first && cut_head,
                           k[c] == last && cut_tail, &twice);
#pragma unroll
      for (int q = 0; q < D; ++q) {
        row[q] = s[q];
        if (twice) part[(2 * t + 1) * D + q] = s[q];
      }
    }
    carry_k = shfl64(kFull, k[c], 31);
#pragma unroll
    for (int q = 0; q < D; ++q) carry[q] = __shfl_sync(kFull, s[q], 31);
  }
}

// ---------------------------------------------------------------- pass 2
// V adjacent columns a thread (d % V == 0), as one vector load and store.
template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
};
template <>
struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

// Blocks [0, sweep) write the empty segments' zeros, V columns a thread;
// block sweep + i folds the segment that tile boundary i + 1 cuts first,
// if any: a warp a column, 32 partials a round, one a lane, added in tile
// order through shuffles.  Segments inside one tile pass 1 wrote.
template <int V>
__global__ void __launch_bounds__(kThreads)
segment_fix(const float* __restrict__ part,
            const int64_t* __restrict__ keys,
            const int64_t* __restrict__ offsets, float* __restrict__ out,
            int64_t E, unsigned n, unsigned d, unsigned sweep) {
  if (blockIdx.x >= sweep) {
    const int64_t bnd = blockIdx.x - sweep + 1;
    const int64_t pos = bnd * kTile;  // tile bnd's first position, < E
    const int64_t key = ld64(keys + pos);
    if (ld64(keys + pos - 1) != key) return;  // nothing cut here
    const int64_t t0 = ld64(offsets + key) / kTile;
    if (t0 != bnd - 1) return;  // cut first at an earlier boundary
    const int64_t count = (ld64(offsets + key + 1) - 1) / kTile - t0 + 1;
    const int lane = threadIdx.x & 31;
    for (unsigned c = threadIdx.x / 32; c < d; c += kThreads / 32) {
      // Partial i: slot 1 of tile t0, then slot 0 of tiles t0 + 1, ...
      auto at = [&](int64_t i) {
        return i < count ? __ldg(part + (i == 0 ? 2 * t0 + 1 : 2 * (t0 + i))
                                            * d + c)
                         : 0.f;
      };
      float acc = 0.f;
      float v = at(lane);
      for (int64_t r = 0; r < count; r += 32) {
        const float next = at(r + 32 + lane);  // the next round in flight
        const int live = (int)min64(32, count - r);
        for (int u = 0; u < live; ++u) acc += __shfl_sync(kFull, v, u);
        v = next;
      }
      if (lane == 0) out[key * d + c] = acc;
    }
    return;
  }
  using T = typename Vec<V>::T;
  const unsigned w = d / V;  // vectors a row
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n * w) return;
  const unsigned s = i / w;
  const int64_t lo = ld64(offsets + s);
  const int64_t hi = ld64(offsets + s + 1);
  if (lo < 0 || hi < lo || hi > E) __trap();  // corrupt offsets
  if (lo == hi)
    reinterpret_cast<T*>(out + (int64_t)s * d)[i - s * w] = Vec<V>::zero();
}

template <int G>
int launch_cols(const float* msg, const int64_t* order, const int64_t* keys,
                float* out, float* part, int64_t E, int64_t n, int d,
                int64_t tiles, cudaStream_t s) {
  const int64_t slices = (d + G - 1) / G;
  if (tiles > 0x7fffffff || slices > 65535) return (int)cudaErrorInvalidValue;
  segment_tiles_cols<G><<<dim3((unsigned)tiles, (unsigned)slices), kThreads,
                          0, s>>>(msg, order, keys, out, part, E, n, d);
  return (int)cudaGetLastError();
}

template <int D>
int launch_msgs(const float* msg, const int64_t* order, const int64_t* keys,
                float* out, float* part, int64_t E, int64_t n, int64_t tiles,
                cudaStream_t s) {
  const int64_t blocks = (tiles + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  segment_tiles_msgs<D><<<(unsigned)blocks, kThreads, 0, s>>>(
      msg, order, keys, out, part, E, n, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// The sorted positions a tile holds (the wrapper sizes `part` by it).
extern "C" int segment_sum_tile(void) { return kTile; }

// msg (E, d) f32; order, keys (E,) i64; offsets (n + 1,) i64; out (n, d)
// f32 with n * d < 2^31; part (2 * ceil(E / tile), d) f32 scratch; all
// contiguous on one device, 16-byte aligned.  Launches pass 1 (if E > 0)
// and pass 2 on `stream` and returns the first launch's cudaError_t.
extern "C" int segment_sum_f32(const void* msg, const void* order,
                               const void* keys, const void* offsets,
                               void* out, void* part, int64_t E, int64_t n,
                               int d, void* stream) {
  if (E < 0 || n < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* m = static_cast<const float*>(msg);
  const int64_t* o = static_cast<const int64_t*>(order);
  const int64_t* k = static_cast<const int64_t*>(keys);
  float* y = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  const int64_t tiles = (E + kTile - 1) / kTile;
  int err = 0;
  if (tiles > 0) {
    if (d == 1)
      err = launch_msgs<1>(m, o, k, y, p, E, n, tiles, s);
    else if (d == 2)
      err = launch_msgs<2>(m, o, k, y, p, E, n, tiles, s);
    else if (d <= 16)
      err = launch_cols<16>(m, o, k, y, p, E, n, d, tiles, s);
    else
      err = launch_cols<32>(m, o, k, y, p, E, n, d, tiles, s);
    if (err != 0) return err;
  }
  if (n * d > 0x7fffffff || tiles > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const float* pt = static_cast<const float*>(part);
  const int64_t* off = static_cast<const int64_t*>(offsets);
  const unsigned un = (unsigned)n, ud = (unsigned)d;
  const int V = d % 4 == 0 ? 4 : d % 2 == 0 ? 2 : 1;
  const int64_t sweep = (n * (d / V) + kThreads - 1) / kThreads;
  const int64_t blocks = sweep + (tiles > 1 ? tiles - 1 : 0);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  if (V == 4)
    segment_fix<4><<<grid, kThreads, 0, s>>>(pt, k, off, y, E, un, ud,
                                             (unsigned)sweep);
  else if (V == 2)
    segment_fix<2><<<grid, kThreads, 0, s>>>(pt, k, off, y, E, un, ud,
                                             (unsigned)sweep);
  else
    segment_fix<1><<<grid, kThreads, 0, s>>>(pt, k, off, y, E, un, ud,
                                             (unsigned)sweep);
  return (int)cudaGetLastError();
}
