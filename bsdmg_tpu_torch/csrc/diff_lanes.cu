// The fourth compilation unit of K4 and K5 (diff_kernel.cu, which says what
// they compute): a composed scene's reverse launch at 4 lanes a ray, both
// tiers (loss_reverse_kernel<ProgramForm, 4> and <ProgramLargeForm, 4>), which
// an image of no more lists than the card has SMs takes. Compiled beside the
// other three units, so that the four build in parallel; diff_kernel.cu's
// entries call this unit's for it.

#define BSDMG_DIFF_LANES_UNIT
#include "diff_kernel.cu"
