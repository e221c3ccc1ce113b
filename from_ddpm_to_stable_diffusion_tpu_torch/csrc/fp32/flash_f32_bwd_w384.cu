// The fp32 K3 and K4 above head dim 256 (flash_f32_bwd_stream.cuh) at padded
// width 384 (head dims 257 to 384), without a mask and ANY (causal, a bias
// with dbias, segment ids): their instantiations, apart from the other
// widths' so that the build compiles them in parallel.

#include "flash_f32_bwd_stream.cuh"

namespace fdsd::f32bwd {
FDSD_F32_BWD_STREAM(, 384)
}  // namespace fdsd::f32bwd
