// The fp32 K1 and K5 above head dim 256 (flash_f32_fwd_wide.cuh) at padded
// width 512 (head dims 385 to 512), causal, ANY and bounded (without a mask:
// flash_fwd_f32_d512_kernel): their instantiations, apart from the
// other widths' so that the build compiles them in parallel.

#include "flash_f32_fwd_wide.cuh"

namespace fdsd::f32fwd {
FDSD_F32_FWD_K1(512)
}  // namespace fdsd::f32fwd
