// The fp32 K3 and K4 on the one-block kernels (flash_f32_bwd.cuh): no mask
// and masked (run_narrow; K3 / K4 causal, K6 / K7) at padded widths
// 48, 64, and the ANY form (a bias with dbias, segment ids, causal) at
// 64: their instantiations, apart from the other widths' so that the build
// compiles them in parallel.

#include "flash_f32_bwd.cuh"

namespace fdsd::f32bwd {
FDSD_F32_BWD_NARROW(, 48)
FDSD_F32_BWD_NARROW(, 64)
FDSD_F32_BWD_ANY(, 64)
}  // namespace fdsd::f32bwd
