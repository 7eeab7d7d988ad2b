// Cross-translation-unit declarations shared by packer.cc and
// epilogue.cc. Both are compiled into one libldtpack.so with C linkage,
// so a hand-copied declaration that drifted from the definition would
// compile AND link silently — this header is included by both sides to
// turn signature drift into a build error.
#pragma once
#include <cstdint>

extern "C" {

// epilogue.cc: chunk-major batched document epilogue (DocTote replay +
// close pairs + unreliable removal + summary language). out is [B, 14]
// int64 (see epilogue.cc for the lane layout).
void ldt_epilogue_flat(const int32_t* rows, const int64_t* doc_chunk_start,
                       const int32_t* n_chunks, const int32_t* direct,
                       const int32_t* text_bytes, const uint8_t* skip,
                       int32_t B, int32_t D, int32_t flags,
                       const int32_t* close_set, const int32_t* closest_alt,
                       const uint8_t* is_figs, int32_t n_lang,
                       int64_t* out);

}  // extern "C"
