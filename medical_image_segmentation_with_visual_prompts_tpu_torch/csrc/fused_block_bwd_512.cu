// The 512-thread instances of the block backward (B4), compiled apart
// from the 256-thread ones so that the two build in parallel.
#define MIVP_BWD_512_UNIT
#include "fused_block_bwd.cu"
