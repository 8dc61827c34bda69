// The tensor-core chunked-prefill kernel (paged_prefill.cu): the bf16-
// compute instantiations of launch_paged_prefill / launch_paged_prefill_int8
// (paged_attention.cu) dispatch here by dtype.
#pragma once

#include "common.cuh"

struct PrefillMmaArgs {
  const void* q;          // [B, C, Hkv, rep, D], bf16 or f32, unscaled
  const void* k;          // pool [NB, BS, Hkv, D], bf16 or int8
  const void* v;
  const float* ks;        // int8 pools: [NB, BS, Hkv] (else null)
  const float* vs;
  const int* pos;         // [NB, BS]
  const int* tables;      // [B, pages]
  const int* positions;   // [B, C], -1 on pad rows
  void* out;              // [B, C, Hkv, rep, D], bf16 or f32
  int B, C, Hkv, rep, D, BS, pages;
  float scale;
  int q_bf16, out_bf16;
};

// largest head width the tensor-core kernel takes (padded to 16)
constexpr int PREFILL_MMA_MAX_D = 256;

cudaError_t prefill_mma_bf16(const PrefillMmaArgs& a, cudaStream_t s);
cudaError_t prefill_mma_int8(const PrefillMmaArgs& a, cudaStream_t s);
