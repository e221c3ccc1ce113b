// The fp32 K3 and K4 on the one-block kernels (flash_f32_bwd.cuh): no mask
// and masked (run_narrow; K3 / K4 causal, K6 / K7) at padded widths
// 112, 128, and the ANY form (a bias with dbias, segment ids, causal) at
// 128: their instantiations, apart from the other widths' so that the build
// compiles them in parallel.

#include "flash_f32_bwd.cuh"

namespace fdsd::f32bwd {
FDSD_F32_BWD_NARROW(, 112)
FDSD_F32_BWD_NARROW(, 128)
FDSD_F32_BWD_ANY(, 128)
}  // namespace fdsd::f32bwd
