// K1 (flash_attention_sm90.cuh) at padded head dims 16, 32, 64:
// their instantiations, apart from the other widths' so that the build
// compiles them in parallel.

#include "flash_attention_sm90.cuh"

namespace fdsd::k1 {
FDSD_K1_WIDTH(16)
FDSD_K1_WIDTH(32)
FDSD_K1_WIDTH(64)
}  // namespace fdsd::k1
