// The bf16 compute policy's instances of the extended-carry stage
// (cov_stage_inkernel.cu; jaxstream/ops/pallas/swe_cov.py::
// make_cov_stage_inkernel's precision argument, its compute half: the
// strips stay float32), one per PLR limiter.  A library of its own, so the
// float32 instances build as before.

#define COV_INKERNEL_BF16
#include "cov_stage_inkernel.cu"
