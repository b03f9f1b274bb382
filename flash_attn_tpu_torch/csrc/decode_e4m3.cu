// Kernel 5, the general decode (decode_kernel.cuh), on fp8 e4m3 caches
// with their K/V descales: decode_fwd and decode_split_fwd.
#include "decode_kernel.cuh"

FA_DECODE_ENTRY_POINTS(kKvE4m3, true)
