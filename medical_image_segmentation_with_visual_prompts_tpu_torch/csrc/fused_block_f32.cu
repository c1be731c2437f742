// The fp32-activation instances of the fused Swin block forward (B1):
// fused_block.cu compiled with MIVP_F32_UNIT, a translation unit of its
// own so that the library's two halves build in parallel.

#define MIVP_F32_UNIT
#include "fused_block.cu"
