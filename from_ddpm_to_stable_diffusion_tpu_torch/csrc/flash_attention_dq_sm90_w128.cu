// K3 (flash_attention_dq_sm90.cuh) at padded head dims 48, 128:
// their instantiations, apart from the other widths' so that the build
// compiles them in parallel.

#include "flash_attention_dq_sm90.cuh"

namespace fdsd::k3 {
FDSD_K3_WIDTH(48)
FDSD_K3_WIDTH(128)
}  // namespace fdsd::k3
