// The swap of partial products between the two blocks of a cluster pair
// that split a flash backward's head dim (the bf16 and the fp32 kernels above
// head dim 256, flash_attention_wide_bwd_sm90.cuh and
// fp32/flash_f32_bwd_stream.cuh). Each block computes S and dP (S^T and
// dP^T) over its half of the columns; the pair swaps these partials once a
// tile and both blocks add the same two values, so both hold the same sums.
//
// A consumer thread stores its partials straight from its registers into
// the other block's `in` with st.async, whose bytes complete on that block's
// xfull barrier: the store does not wait for the remote write, so no
// consumer thread stalls on the other SM (fp32/flash_f32_bwd.cuh's header
// records that st.shared::cluster with remote arrivals stalls a consumer for
// about as long as a tile's tensor-core work), and no copy waits for a
// helper thread to wake. One thread of the producer warpgroup (swap_helper)
// arms xfull for each tile's bytes and, once this block's consumers have
// read `in`, tells the other block it may store again. Barriers, at `bars`:
// xfull (the other block's partials landed in `in`: expect_tx by the helper,
// complete_tx by the stores), xfree (the other block's consumers read what
// this block last stored into its `in`; one remote arrival), out_ready (the
// consumers wrote their own partials into `out`, where a kernel's two
// consumers need each other's), in_read (the consumers read `in`), yfull
// (with a swap in two halves: the second half landed, xfull then counting
// the first). A consumer waits xfree (parity pushes ^ 1) before it stores
// and xfull (parity pulls), and yfull, before it reads `in`; pushes and
// pulls alternate, tile by tile.

#pragma once

#include "sm90.cuh"

namespace fdsd {

constexpr int kSwapBars = 5;

// The swap's barriers at `bars`, set up by one thread; `consumers` threads
// push and pull.
__device__ __forceinline__ void swap_init(uint32_t bars, uint32_t consumers) {
  sm90::mbar_init(bars, 1);               // xfull
  sm90::mbar_init(bars + 8, 1);           // xfree
  sm90::mbar_init(bars + 16, consumers);  // out_ready
  sm90::mbar_init(bars + 24, consumers);  // in_read
  sm90::mbar_init(bars + 32, 1);          // yfull
}

// The helper's side, for `tiles` swaps of `bytes` into this block's `in`
// (`halves` 2: the first half counted on xfull, the second on yfull): for
// each, arm the barriers for the other block's stores and, once this
// block's consumers read them, tell the other block it may store again.
__device__ __forceinline__ void swap_helper(uint32_t bars, int tiles,
                                            uint32_t bytes, int halves = 1) {
  namespace s9 = fdsd::sm90;
  const uint32_t xfull = bars, xfree = bars + 8, in_read = bars + 24;
  const uint32_t peer_free = s9::cluster_map(xfree, s9::cluster_rank() ^ 1u);
  uint32_t ph = 0;
  for (int t = 0; t < tiles; ++t) {
    s9::mbar_expect_tx(xfull, bytes / halves);
    if (halves == 2) s9::mbar_expect_tx(bars + 32, bytes / 2);
    s9::mbar_wait(in_read, ph);
    s9::mbar_arrive_cluster(peer_free);
    ph ^= 1;
  }
}

// A consumer's view of the swap: the other block's `in`, xfull and yfull,
// and the parities of this thread's pushes and pulls.
struct SwapPeer {
  uint32_t in, full, full_y;
  uint32_t pushes = 0, pulls = 0;
  __device__ __forceinline__ SwapPeer(uint32_t in_s, uint32_t bars) {
    const uint32_t peer = sm90::cluster_rank() ^ 1u;
    in = sm90::cluster_map(in_s, peer);
    full = sm90::cluster_map(bars, peer);
    full_y = sm90::cluster_map(bars + 32, peer);
  }
  // Waits until the other block read the last partials stored into it.
  __device__ __forceinline__ void wait_free(uint32_t bars) {
    sm90::mbar_wait_cluster(bars + 8, pushes ^ 1);
    pushes ^= 1;
  }
  // Waits until the other block's partials of this tile are in `in`.
  __device__ __forceinline__ void wait_full(uint32_t bars) {
    sm90::mbar_wait(bars, pulls);
    pulls ^= 1;
  }
  // With a swap in two halves: until the first half of this tile's is in
  // `in`, then until the second is.
  __device__ __forceinline__ void wait_first(uint32_t bars) {
    sm90::mbar_wait(bars, pulls);
  }
  __device__ __forceinline__ void wait_second(uint32_t bars) {
    sm90::mbar_wait(bars + 32, pulls);
    pulls ^= 1;
  }
};

}  // namespace fdsd
