// Kernel 5, the general decode (decode_kernel.cuh), on int8 caches with
// their K/V descales: decode_fwd and decode_split_fwd.
#include "decode_kernel.cuh"

FA_DECODE_ENTRY_POINTS(kKvInt8, true)
