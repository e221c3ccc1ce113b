// K3 and K4 above head dim 256 (flash_attention_wide_bwd_sm90.cuh) at padded
// width 384 (head dims 257 to 384), without a mask and in the ANY form: their
// instantiations, apart from the other width's so that the build compiles
// them in parallel.

#include "flash_attention_wide_bwd_sm90.cuh"

namespace fdsd::kw {
FDSD_KW_WIDTH(384)
}  // namespace fdsd::kw
