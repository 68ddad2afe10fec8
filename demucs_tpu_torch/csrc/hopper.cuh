// PTX helpers for sm_90a kernels: mbarriers, bulk and tensor (TMA)
// asynchronous copies into shared memory, bulk reductions into global
// memory, the async-proxy fence, named barriers, warpgroup MMA
// (wgmma) with TF32 or bf16 inputs and swizzled operand descriptors, the
// special-function exp2, and the TF32 split of an fp32 value.
//
// Names and operand orders follow the PTX ISA (8.x): mbarrier.*,
// cp.async.bulk(.tensor), cp.reduce.async.bulk, fence.proxy.async,
// bar.sync / bar.arrive, ex2.approx,
// wgmma.mma_async and its fence / commit_group / wait_group.

#pragma once

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers (shared::cta) ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (bulk copies).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// One arrival that also announces `bytes` of asynchronous copies to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Contiguous copy global -> shared by the copy engine; completion is counted
// in bytes on `bar`. Addresses 16-byte aligned, bytes a multiple of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A box of a 3-D tensor map (innermost coordinate first) global -> shared
// by the tensor memory accelerator, in the map's swizzle; elements outside
// the tensor land as zeros, and the barrier counts the whole box's bytes.
// `map` is the address of a __grid_constant__ CUtensorMap kernel parameter.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// Makes this thread's earlier writes to shared memory visible to the async
// proxy (wgmma operands, bulk copies) that reads them after a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Adds `bytes` of fp32 values in shared memory, element by element, to
// global memory by the copy engine (a reduction in L2), as one bulk
// operation of this thread's bulk async-group. 16-byte aligned, bytes a
// multiple of 16.
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;" ::"l"(
                   dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// Waits until at most N of this thread's bulk groups still read their source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
// Waits until all of this thread's bulk groups are complete.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---- an ordered turn between blocks (deterministic reductions) ----
// Waits until the counter at `turn` (global memory) reads `mine` (an acquire
// load): the thread's later memory operations are ordered after that read.
// After TURN_POLLS reads that miss it traps instead of holding the card: no
// correct schedule waits that long. The bound counts reads, not time (at
// about half a microsecond a read of L2, some seconds; untimed). A trap is
// fatal to the process's CUDA context, not only to the launch: the wrapper
// raises, and every later CUDA call of the process fails, so the process
// must be restarted.
constexpr uint32_t TURN_POLLS = 1u << 24;
__device__ __forceinline__ void turn_acquire(const unsigned* turn, unsigned mine) {
  unsigned v;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(turn) : "memory");
    if (v == mine) break;
    if (polls == TURN_POLLS) __trap();
  }
}
// Adds 1 to the counter, a release: the thread's earlier memory operations
// (and those of the threads it has synchronised with) are ordered before it.
__device__ __forceinline__ void turn_release(unsigned* turn) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(turn) : "memory");
}
// turn_acquire, then orders the thread's later bulk operations (the async
// proxy) after that read.
__device__ __forceinline__ void turn_wait(const unsigned* turn, unsigned mine) {
  turn_acquire(turn, mine);
  asm volatile("fence.proxy.async;" ::: "memory");
}
// Passes the turn on: waits until this thread's bulk groups are complete
// (their writes done, not only their reads), orders those writes of the
// async proxy before the counter's increment, a release.
__device__ __forceinline__ void turn_pass(unsigned* turn) {
  bulk_wait_all();
  asm volatile("fence.proxy.async;" ::: "memory");
  turn_release(turn);
}

// Brings a tensor map into the descriptor cache ahead of its first copy.
__device__ __forceinline__ void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- named barriers (ids 1..15; 0 is __syncthreads) ----

// Waits until `threads` threads (a multiple of 32) have arrived at barrier
// `id`, this warp included.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
// Counts this warp at barrier `id` without waiting.
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// ---- registers ----

// Moves registers between warpgroups: every warp of the warpgroup executes
// it, and the kernel's roles must branch once and never rejoin.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// ---- special functions ----

// 2^x on the special-function unit (one MUFU op); results below 2^-126
// flush to zero, and 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- TF32 ----

// The TF32 part of x: its fp32 word with the low 13 mantissa bits cleared.
// A TF32 operand holding this value is read exactly, whether the tensor core
// truncates or rounds, and x - tf32_hi(x) is exact in fp32.
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// ---- wgmma ----

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Waits until at most N of this warpgroup's committed wgmma groups are
// pending (groups complete in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of v across this point
// (accumulators are written asynchronously by wgmma).
__device__ __forceinline__ void fence_operand(float& v) { asm volatile("" : "+f"(v)::"memory"); }
// The same for a register operand (an A fragment) that an issued wgmma
// still reads: fenced after the wait, it stays in its register until then.
__device__ __forceinline__ void fence_operand(uint32_t& v) { asm volatile("" : "+r"(v)::"memory"); }

// Shared-memory matrix descriptor, no swizzle: the operand is stored as core
// matrices of 8 rows x 16 bytes (128 contiguous bytes each). `lbo` is the
// byte stride between core matrices adjacent along K, `sbo` between core
// matrices adjacent along M or N (groups of 8 rows).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Shared-memory matrix descriptor of a swizzled operand: rows of W = 32,
// 64 or 128 bytes (`layout` 3, 2 or 1: wgmma's 32-, 64- and 128-byte
// swizzle, the pattern a tensor map of the same swizzle writes), in atoms
// of 8 rows x W bytes aligned to 8 W. K-major (the reduction along the
// row): `sbo` = 8 W (the next 8 rows), `lbo` unused (16); a k-slice of 16
// bf16 values inside the row starts 32 bytes further. MN-major (the
// reduction down the rows, read with the transpose bit): `sbo` = 8 W (the
// next 8 reduction rows), `lbo` the byte stride to the next atom along N.
__device__ __forceinline__ uint64_t swizzled_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                                  uint64_t layout) {
  return smem_desc(addr, lbo, sbo) | (layout << 62);
}

// d (64 x N, fp32) += a (64 x 8, TF32, registers) . b (8 x N, TF32, shared,
// K-major), for one warpgroup. scale_d == 0 ignores the old d.
//
// Register fragments (PTX ISA, wgmma .m64nNk8): warp w of the warpgroup owns
// rows 16w..16w+15; lane l, with g = l / 4 and c = l % 4, holds
//   a[0] = A[g][c], a[1] = A[g + 8][c], a[2] = A[g][c + 4], a[3] = A[g + 8][c + 4]
//   d[i] = D[g + 8 * ((i >> 1) & 1)][8 * (i >> 2) + 2 * c + (i & 1)]
// (row and column indices relative to the warp's 16 rows).
template <int N>
struct MmaTf32;

#define HOPPER_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HOPPER_ACC8(i) HOPPER_ACC4(i), HOPPER_ACC4(i + 4)

template <>
struct MmaTf32<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
        "}\n"
        : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct MmaTf32<48> {
  static __device__ __forceinline__ void run(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1;\n"
        "}\n"
        : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct MmaTf32<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
        "}\n"
        : HOPPER_ACC8(0), HOPPER_ACC8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// N = 128: K3's fp32 P V at head dim 128 (64 accumulators a thread).
template <>
struct MmaTf32<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
        "}\n"
        : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24), HOPPER_ACC8(32),
          HOPPER_ACC8(40), HOPPER_ACC8(48), HOPPER_ACC8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// d (64 x 32, fp32) (+)= a (64 x 8, TF32, shared) . b (8 x 32, TF32, shared),
// both K-major (wgmma reads 32-bit operands only K-major), by descriptor.
struct MmaTf32SS32 {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n"
        "}\n"
        : HOPPER_ACC8(0), HOPPER_ACC8(8)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// d (64 x N, fp32) += a (64 x 16, bf16, registers) . b (16 x N, bf16, shared),
// for one warpgroup. TRANS_B == 1: b is MN-major (N contiguous, read with the
// transpose bit; only this form is instantiated). scale_d == 0 ignores the old d.
//
// Register fragments (PTX ISA, wgmma .m64nNk16 with 16-bit A): lane l of
// warp w, g = l / 4, c = l % 4, rows relative to the warp's 16, each
// register two values, the lower column in the low half:
//   a[0] = A[g][2c, 2c+1], a[1] = A[g+8][2c, 2c+1],
//   a[2] = A[g][2c+8, 2c+9], a[3] = A[g+8][2c+8, 2c+9];
// d as for MmaTf32. So the fp32 accumulator of one product, packed pairwise
// (d[8k + 2r], d[8k + 2r + 1]) -> a[r], is the A fragment of columns
// 16k..16k+15 with no shuffle.
template <int N, int TRANS_B>
struct MmaBf16;

#define HOPPER_BF16_A "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_MMA_BF16(N, T, NREG, DREGS, AIDX, ...)                                          \
  template <>                                                                                  \
  struct MmaBf16<N, T> {                                                                       \
    static __device__ __forceinline__ void run(float (&d)[NREG], const uint32_t (&a)[4],      \
                                               uint64_t b, int scale_d) {                      \
      asm volatile("{\n"                                                                       \
                   ".reg .pred p;\n"                                                           \
                   "setp.ne.b32 p, %" #AIDX ", 0;\n"                                           \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " DREGS        \
                   ", p, 1, 1, " #T ";\n"                                                      \
                   "}\n"                                                                       \
                   : __VA_ARGS__                                                               \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));        \
    }                                                                                          \
  };

#define HOPPER_D64 HOPPER_BF16_A ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36"
#define HOPPER_D48 HOPPER_BF16_A ", %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, " \
  "%27}, %28"
#define HOPPER_D32 HOPPER_BF16_A "}, {%16, %17, %18, %19}, %20"
#define HOPPER_D128 HOPPER_BF16_A ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, " \
  "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, " \
  "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, " \
  "%63}, {%64, %65, %66, %67}, %68"

HOPPER_MMA_BF16(128, 1, 64, HOPPER_D128, 69, HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16),
                HOPPER_ACC8(24), HOPPER_ACC8(32), HOPPER_ACC8(40), HOPPER_ACC8(48),
                HOPPER_ACC8(56))
HOPPER_MMA_BF16(64, 1, 32, HOPPER_D64, 37, HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16),
                HOPPER_ACC8(24))
HOPPER_MMA_BF16(48, 1, 24, HOPPER_D48, 29, HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16))
HOPPER_MMA_BF16(32, 1, 16, HOPPER_D32, 21, HOPPER_ACC8(0), HOPPER_ACC8(8))

// d (64 x N, fp32) (+)= a (64 x 16, bf16, shared) . b (16 x N, bf16, shared),
// operands by descriptor; d as for MmaTf32. TA, TB == 0: K-major (the
// reduction along the rows); 1: MN-major, read with the transpose bit.
template <int N, int TA = 0, int TB = 0>
struct MmaBf16SS;

#define HOPPER_MMA_BF16_SS(N, TA, TB, NREG, DREGS, PIDX, ...)                             \
  template <>                                                                              \
  struct MmaBf16SS<N, TA, TB> {                                                            \
    static __device__ __forceinline__ void run(float (&d)[NREG], uint64_t a, uint64_t b,   \
                                               int scale_d) {                              \
      asm volatile("{\n"                                                                   \
                   ".reg .pred p;\n"                                                       \
                   "setp.ne.b32 p, %" #PIDX ", 0;\n"                                       \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " DREGS    \
                   ", p, 1, 1, " #TA ", " #TB ";\n"                                        \
                   "}\n"                                                                   \
                   : __VA_ARGS__                                                           \
                   : "l"(a), "l"(b), "r"(scale_d));                                        \
    }                                                                                      \
  };

#define HOPPER_SS32 HOPPER_BF16_A "}, %16, %17"
#define HOPPER_SS48 HOPPER_BF16_A ", %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25"
#define HOPPER_SS64 HOPPER_BF16_A ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31}, %32, %33"
#define HOPPER_SS128 HOPPER_BF16_A ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, " \
  "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, " \
  "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, " \
  "%63}, %64, %65"

HOPPER_MMA_BF16_SS(64, 0, 0, 32, HOPPER_SS64, 34, HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16),
                   HOPPER_ACC8(24))
HOPPER_MMA_BF16_SS(128, 0, 0, 64, HOPPER_SS128, 66, HOPPER_ACC8(0), HOPPER_ACC8(8),
                   HOPPER_ACC8(16), HOPPER_ACC8(24), HOPPER_ACC8(32), HOPPER_ACC8(40),
                   HOPPER_ACC8(48), HOPPER_ACC8(56))
// both operands MN-major (K3's backward: dQ = dS K with dS^T and K stored
// with the reduction, keys, down the rows)
HOPPER_MMA_BF16_SS(32, 1, 1, 16, HOPPER_SS32, 18, HOPPER_ACC8(0), HOPPER_ACC8(8))
HOPPER_MMA_BF16_SS(48, 1, 1, 24, HOPPER_SS48, 26, HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16))
HOPPER_MMA_BF16_SS(64, 1, 1, 32, HOPPER_SS64, 34, HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16),
                   HOPPER_ACC8(24))

#undef HOPPER_SS128
#undef HOPPER_SS64
#undef HOPPER_SS48
#undef HOPPER_SS32
#undef HOPPER_MMA_BF16_SS
#undef HOPPER_D128
#undef HOPPER_D32
#undef HOPPER_D48
#undef HOPPER_D64
#undef HOPPER_MMA_BF16
#undef HOPPER_BF16_A
#undef HOPPER_ACC8
#undef HOPPER_ACC4

}  // namespace hopper
