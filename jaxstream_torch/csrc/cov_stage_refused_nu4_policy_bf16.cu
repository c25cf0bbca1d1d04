// The bf16 compute policy's instances of the re-fused stage 1
// (cov_stage_refused_nu4.cu), one per PLR limiter: the limiter algebra
// and the flux face-average velocities in bfloat16 (PlrLo), the strips
// float32 or bfloat16 per launch.  See cov_stage_refused_nu4_policy.cu.

#define COV_REFUSED_POLICY 2
#include "cov_stage_refused_nu4.cu"
