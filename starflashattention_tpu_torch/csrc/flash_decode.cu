// Decode attention (K1, K2, K7) without the attention variants: the
// kernel of flash_decode.cuh built with SFA_DECODE_VARIANTS 0. A call with a
// window, sinks or a softcap goes to flash_decode_variants.cu.
#define SFA_DECODE_VARIANTS 0
#include "flash_decode.cuh"
