// The fp32-activation instances of the Swin block pair forward (B5)
// without dropout: a translation unit of their own (fused_pair.cu), so
// the library's quarters build in parallel.

#define MIVP_PAIR_SET mivp_fused_swin_pair_f32
#define MIVP_PAIR_F32 true
#define MIVP_PAIR_DROP false
#include "fused_pair.cu"
