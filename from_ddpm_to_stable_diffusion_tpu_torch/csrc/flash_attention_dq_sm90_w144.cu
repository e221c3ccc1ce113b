// K3 (flash_attention_dq_sm90.cuh) at padded head dims 144, 160, 176:
// their instantiations, apart from the other widths' so that the build
// compiles them in parallel.

#include "flash_attention_dq_sm90.cuh"

namespace fdsd::k3 {
FDSD_K3_WIDTH(144)
FDSD_K3_WIDTH(160)
FDSD_K3_WIDTH(176)
}  // namespace fdsd::k3
