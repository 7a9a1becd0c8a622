// Decode attention (K1, K7) over MLA's 640-lane latent row: the kernel of
// flash_decode.cuh. Head_dims 64, 128 and 256 build flash_decode_split.cu.
#include "flash_decode.cuh"
