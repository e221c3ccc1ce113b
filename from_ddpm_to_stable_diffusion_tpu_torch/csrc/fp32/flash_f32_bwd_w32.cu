// The fp32 K3 and K4 on the one-block kernels (flash_f32_bwd.cuh): no mask
// and masked (run_narrow; K3 / K4 causal, K6 / K7) at padded widths
// 16, 32, and the ANY form (a bias with dbias, segment ids, causal) at
// 32: their instantiations, apart from the other widths' so that the build
// compiles them in parallel.

#include "flash_f32_bwd.cuh"

namespace fdsd::f32bwd {
FDSD_F32_BWD_NARROW(, 16)
FDSD_F32_BWD_NARROW(, 32)
FDSD_F32_BWD_ANY(, 32)
}  // namespace fdsd::f32bwd
