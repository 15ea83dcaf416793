// cp.async helpers of the kernels that stage rows in shared memory
// (mm_costas.cu, chan.cu): a 4-byte copy from device to shared memory that
// skips the registers, the commit of the copies issued so far, and a wait
// for all of them.
#pragma once

static __device__ __forceinline__ void cp_async4(float *smem,
                                                 const float *gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
static __device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
