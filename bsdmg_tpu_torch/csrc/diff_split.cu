// The second compilation unit of K4 and K5 (diff_kernel.cu, which says what
// they compute): their instantiations with the near/far split
// (march_params_split_kernel, loss_march_split_kernel) and of the large
// tier (ProgramLargeForm). Compiled beside diff_kernel.cu, so that the two
// build in parallel; diff_kernel.cu's entries call this unit's for these.

#define BSDMG_DIFF_SECOND_UNIT
#include "diff_kernel.cu"
