// The fp32 K1 and K5 at head dims 161 to 256 (flash_f32_fwd_wide.cuh) at
// padded width 192 in its four forms (no mask, causal, ANY and bounded):
// their instantiations, apart from the other widths' so that the build
// compiles them in parallel.

#include "flash_f32_fwd_wide.cuh"

namespace fdsd::f32fwd {
FDSD_F32_FWD_WIDE(192)
}  // namespace fdsd::f32fwd
