// The fp32 K1 and K5 on the resident kernel (flash_f32_fwd.cuh): no mask
// and masked (run_plain) at padded widths 112, 128, and K5 bounded and
// ANY (run_masks; a bias or segment ids) at 128: their instantiations, apart
// from the other widths' so that the build compiles them in parallel.

#include "flash_f32_fwd.cuh"

namespace fdsd::f32fwd {
FDSD_F32_FWD_PLAIN(, 112)
FDSD_F32_FWD_PLAIN(, 128)
FDSD_F32_FWD_MASKS(, 128)
}  // namespace fdsd::f32fwd
