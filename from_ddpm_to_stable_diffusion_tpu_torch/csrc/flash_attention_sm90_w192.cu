// K1 (flash_attention_sm90.cuh) at padded head dims 192, 208:
// their instantiations, apart from the other widths' so that the build
// compiles them in parallel.

#include "flash_attention_sm90.cuh"

namespace fdsd::k1 {
FDSD_K1_WIDTH(192)
FDSD_K1_WIDTH(208)
}  // namespace fdsd::k1
