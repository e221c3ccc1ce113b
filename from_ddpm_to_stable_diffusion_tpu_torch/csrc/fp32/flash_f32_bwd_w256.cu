// The fp32 K3 and K4 above head dim 128 (flash_f32_bwd.cuh) at padded width
// 256, no mask, masked and ANY (a bias with dbias, segment ids, causal):
// their instantiations, apart from the other widths' so that the build
// compiles them in parallel.

#include "flash_f32_bwd.cuh"

namespace fdsd::f32bwd {
FDSD_F32_BWD_WIDE(, 256)
FDSD_F32_BWD_ANY(, 256)
}  // namespace fdsd::f32bwd
