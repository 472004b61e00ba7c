// The second compilation unit of K1, K2 and K3 (render_kernel.cu, which
// says what they compute): their instantiations with the near/far split
// (render_split_kernel, trace_split_kernel) and of the large tier
// (ComposedLarge). Compiled beside render_kernel.cu, so that the two build
// in parallel; render_kernel.cu's entries call this unit's for these.

#define BSDMG_RENDER_SECOND_UNIT
#include "render_kernel.cu"
