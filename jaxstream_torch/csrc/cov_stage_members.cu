// The float32 ensemble's instances of cov_stage_policy.cu (the member
// fold only: a float32 carry, unscaled, float32 strips, prescaled sym
// rows, as compile-time constants), one per reconstruction, built as a
// library of their own so that they compile in parallel with the others.
// See cov_stage_policy.cu.

#define COV_POLICY_MEMBERS
#include "cov_stage_policy.cu"
