// Constants shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the float32 kernels' tile sizes, the bf16 element type
// and the -1e30 mask.  The bf16 kernels (K1, K2 and K3 on wgmma) take
// their building blocks from flash_hopper.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;        // query rows per tile (float32 kernels)
constexpr int BK = 64;        // keys per tile (float32 kernels)
constexpr float NEG_INF = -1e30f;

}  // namespace
