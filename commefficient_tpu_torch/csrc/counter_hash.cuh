// The reference's interpret-mode dropout bits (commefficient_tpu/ops/
// flash_attention.py::_hash_bits): a counter hash of a position (r, c)
// in its logical tile under the tile's two seed words, murmur3-fmix32
// rounds with the seeds folded in between, in uint32 wraparound. Shared by
// the flash kernels' probability dropout and the hardware-RNG dropout.
#pragma once

#include <cstdint>

namespace drop {

__device__ __forceinline__ uint32_t counter_hash(uint32_t r, uint32_t c,
                                                 uint32_t s0, uint32_t s1) {
  uint32_t x = r * 2654435761u + c * 2246822519u;
  x ^= s0;
  x = (x ^ (x >> 16)) * 2246822507u;
  x ^= s1;
  x = (x ^ (x >> 13)) * 3266489909u;
  x ^= x >> 16;
  return x;
}

}  // namespace drop
