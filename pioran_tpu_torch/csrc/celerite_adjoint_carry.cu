// The carry entries of K3 and K4, celerite_fwd_aug_carry_{f32,f64} and
// celerite_bwd_carry_{f32,f64}: the kernels of celerite_adjoint.cu with
// their compile-time flag Carry set (that file's header says what they
// compute). Built as a library of their own so that nvcc compiles them
// beside the other adjoint entries, in parallel.
#define PIORAN_CARRY_ENTRIES
#include "celerite_adjoint.cu"
