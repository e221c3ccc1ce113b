// K3 (flash_attention_dq_sm90.cuh) at padded head dims 224, 240, 256:
// their instantiations, apart from the other widths' so that the build
// compiles them in parallel.

#include "flash_attention_dq_sm90.cuh"

namespace fdsd::k3 {
FDSD_K3_WIDTH(224)
FDSD_K3_WIDTH(240)
FDSD_K3_WIDTH(256)
}  // namespace fdsd::k3
