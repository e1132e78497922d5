// Phase clocks of kernels B2 and B3, compiled in only with -DRL_PHASES
// (runtime/kernel_bench.py --phases; this card has no kernel profiler).
// One thread (the kernel names it) adds the SM cycles since its last mark
// to the phase's counter. Before reading the clock it stores the value the
// phase produced to a volatile sink: the store cannot issue before that
// value exists, so the mark falls after the phase's work, not merely after
// its issue. Built without RL_PHASES, every macro is empty.
#pragma once

#ifdef RL_PHASES
#define RL_PHASE_DECL(arr, n)              \
  static __device__ long long arr[n];      \
  static __device__ volatile float arr##_sink;
#define RL_PHASE_START(on)         \
  const bool rl_on_ = (on);        \
  long long rl_t0_ = clock64();
#define RL_PHASE(arr, k, dep)                 \
  if (rl_on_) {                               \
    arr##_sink = (dep);                       \
    const long long rl_t_ = clock64();        \
    arr[k] += rl_t_ - rl_t0_;                 \
    rl_t0_ = rl_t_;                           \
  }
// host: copies the counters into host[n], or zeroes them when reset != 0
#define RL_PHASE_EXPORT(fn, arr, n)                                        \
  extern "C" int fn(long long* host, int reset) {                         \
    if (reset) {                                                          \
      const long long zero[n] = {0};                                      \
      return static_cast<int>(cudaMemcpyToSymbol(arr, zero, sizeof(zero))); \
    }                                                                     \
    return static_cast<int>(                                              \
        cudaMemcpyFromSymbol(host, arr, (n) * sizeof(long long)));        \
  }
#else
#define RL_PHASE_DECL(arr, n)
#define RL_PHASE_START(on)
#define RL_PHASE(arr, k, dep)
#define RL_PHASE_EXPORT(fn, arr, n)
#endif
