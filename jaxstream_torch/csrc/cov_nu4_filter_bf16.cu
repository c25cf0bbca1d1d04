// The stage precision policy's instance of the split del^4 filter
// (cov_nu4_filter.cu): the routed ghosts read and the boundary strips
// written in bfloat16 (the 16-bit strips of
// jaxstream/ops/pallas/swe_cov.py::make_cov_nu4_filter's precision
// argument), the filter arithmetic float32.  A library of its own, so the
// float32 filter builds as before.

#define COV_FILTER_BF16
#include "cov_nu4_filter.cu"
