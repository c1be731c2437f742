// The fp32-activation instances of the Swin block pair forward (B5):
// fused_pair.cu compiled with MIVP_F32_UNIT, a translation unit of its
// own so that the library's two halves build in parallel.

#define MIVP_F32_UNIT
#include "fused_pair.cu"
