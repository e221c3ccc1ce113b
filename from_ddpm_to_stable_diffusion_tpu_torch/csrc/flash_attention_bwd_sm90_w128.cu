// K4 (flash_attention_bwd_sm90.cuh) at padded head dims 48, 128:
// their instantiations, apart from the other widths' so that the build
// compiles them in parallel.

#include "flash_attention_bwd_sm90.cuh"

namespace fdsd::k4 {
FDSD_K4_WIDTH(48)
FDSD_K4_WIDTH(128)
}  // namespace fdsd::k4
