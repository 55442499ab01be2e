// Kernel K4 for bf16 rings (gen_hbm.cuh).
#define GEN_HBM_RING 1
#include "gen_hbm.cuh"
