// The third compilation unit of K4 and K5 (diff_kernel.cu, which says what
// they compute): the small tier's reverse launch of a composed scene's
// parameter program (loss_reverse_kernel<ProgramForm, 1> and its 4 lanes a
// ray). Compiled beside diff_kernel.cu and diff_split.cu, so that the three
// build in parallel; diff_kernel.cu's entries call this unit's for it.

#define BSDMG_DIFF_REVERSE_UNIT
#include "diff_kernel.cu"
