// The stage precision policy's instances of the re-fused stage 1
// (cov_stage_refused_nu4.cu; jaxstream/ops/pallas/swe_cov.py::
// make_cov_stage_refused_nu4's precision argument) with float32
// arithmetic, every reconstruction: the routed ghosts and the strips
// float32 or bfloat16 per launch (Params::s16), the sym rows widened into
// shared memory.  A library of its own, so the float32 instances build as
// before; cov_stage_refused_nu4_policy_bf16.cu holds the bf16 compute
// ones.

#define COV_REFUSED_POLICY 1
#include "cov_stage_refused_nu4.cu"
