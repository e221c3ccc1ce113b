// The fp32 K1 and K5 above head dim 256 (flash_f32_fwd_wide.cuh) at padded
// width 384 (head dims 257 to 384) without a mask, causal, ANY and bounded:
// their instantiations, apart from the other widths' so that the build
// compiles them in parallel.

#include "flash_f32_fwd_wide.cuh"

namespace fdsd::f32fwd {
FDSD_F32_FWD_K1(384)
}  // namespace fdsd::f32fwd
