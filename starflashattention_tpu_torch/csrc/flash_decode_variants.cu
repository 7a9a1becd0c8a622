// Decode attention (K1, K2, K7) with the attention variants (sliding
// window, sinks, softcap): the kernel of flash_decode.cuh built with
// SFA_DECODE_VARIANTS 1.
#define SFA_DECODE_VARIANTS 1
#include "flash_decode.cuh"
