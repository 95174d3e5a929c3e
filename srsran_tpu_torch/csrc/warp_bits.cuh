// A codeword's transmitted bits, a byte each, written 8 or 16 at a time
// (K33, K34).
//
// A lane writes chunk c of a row o[0, E): bytes 8c..8c+7, byte q the low
// byte q of v.  A whole chunk on an 8-byte boundary is one 8-byte store;
// the row's last chunk, and every chunk of a row that does not start on an
// 8-byte boundary, go a byte at a time.  store16 writes bytes 16c..16c+15
// (lo, then hi): one 16-byte store where they lie whole in the row on a
// 16-byte boundary, else as two chunks.

#pragma once

#include <stdint.h>

__device__ __forceinline__ void store_chunk(int8_t* o, int E, int c,
                                            uint64_t v) {
  int8_t* dst = o + 8 * c;
  const int left = E - 8 * c;
  if (left >= 8 && !((uintptr_t)dst & 7)) {
    *reinterpret_cast<uint64_t*>(dst) = v;
    return;
  }
  for (int q = 0; q < 8 && q < left; ++q) dst[q] = (int8_t)(v >> (8 * q));
}

__device__ __forceinline__ void store16(int8_t* o, int E, int c, uint64_t lo,
                                        uint64_t hi) {
  int8_t* dst = o + 16 * c;
  if (E - 16 * c >= 16 && !((uintptr_t)dst & 15)) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi,
                   (uint32_t)(hi >> 32));
    return;
  }
  store_chunk(o, E, 2 * c, lo);
  if (E > 16 * c + 8) store_chunk(o, E, 2 * c + 1, hi);
}
