// The bf16 mma.sync fragments beside csrc/int8_mma.cuh's s8 ones, for Hopper
// (sm_90a): mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32. The bf16
// form of #28 mxu_ceiling (csrc/gemm_probe.cu) issues it; it is the mma.sync
// ceiling the wgmma kernels are held against.
//
// An m16n8k16 bf16 fragment holds, in bytes, what an m16n8k32 s8 fragment
// holds: A's four 32-bit registers are rows g and g + 8 at bytes 4t and
// 16 + 4t of a 32-byte k-step, B's two are row g of the [N, K] operand at the
// same bytes, and the accumulator's four are rows g and g + 8, columns 2t and
// 2t + 1. So a kernel stages and reads bf16 operands exactly as s8 ones, with
// K counted in bytes (two per element); only the instruction and the f32
// accumulator differ. (#27 probe_mm's bf16 form ran a mainloop of this
// header until it moved to the wgmma one of csrc/wgmma_gemm.cuh.)

#pragma once

#include "mma_frag.cuh"

namespace {

using mma_frag::mma_bf16;

}  // namespace
