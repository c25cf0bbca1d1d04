// The bf16 compute policy's instances of cov_stage_policy.cu (one per PLR
// limiter: the limiter algebra and the flux face-average velocities in
// bfloat16, PlrLo), built as a library of their own so that the two sets
// of kernels compile in parallel.  See cov_stage_policy.cu.

#define COV_POLICY_BF16
#include "cov_stage_policy.cu"
