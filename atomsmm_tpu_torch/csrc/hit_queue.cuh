// A warp's queue of hits, shared by cell_pair.cu and tile_pair.cu.
//
// Both kernels test many (home atom, candidate) slots of which few are in
// range (4-14% at the shapes they run), and the pair form costs five times
// the test. Evaluated where it was found, a hit keeps its whole warp in the
// form for one or two live lanes. So the lanes of a warp test 32 slots at a
// time and push their hits on a stack in shared memory that belongs to the
// warp; whenever 32 are queued, every lane pops one and evaluates it, and
// what is left at the end of the warp's work is evaluated by a partial
// warp once.
//
// The stack holds at most 31 entries before a push and 32 more after it, so
// its buffer has DEPTH = 64 entries. Its fill `n` is a register that every
// lane of the warp holds alike. The protocol of one test round:
//
//   const int slot = hitqueue::reserve(hit, n);   // all 32 lanes call it
//   if (hit) buf[slot] = entry;
//   __syncwarp();
//   if (n >= 32) {                                 // the same in every lane
//     n -= 32;
//     const Entry v = buf[n + lane];
//     __syncwarp();                                // read before the next push
//     evaluate(v);
//   }
//
// Entries leave in the order they came (within the popped 32), so a warp
// that pushes in a fixed order sums in a fixed order.
#pragma once

namespace hitqueue {

constexpr int DEPTH = 64;
constexpr unsigned FULL_WARP = 0xffffffffu;

// The slot of this lane's hit (meaningful where `hit`), and the fill `n`
// raised by the warp's hits. Every lane of the warp must call it.
__device__ __forceinline__ int reserve(bool hit, int& n) {
  const unsigned m = __ballot_sync(FULL_WARP, hit);
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  const int slot = n + __popc(m & below);
  n += __popc(m);
  return slot;
}

}  // namespace hitqueue
