// Kernel 5, the general decode (decode_kernel.cuh), on caches of q's own
// type with K/V descales: decode_fwd and decode_split_fwd.
#include "decode_kernel.cuh"

FA_DECODE_ENTRY_POINTS(kKvSame, true)
