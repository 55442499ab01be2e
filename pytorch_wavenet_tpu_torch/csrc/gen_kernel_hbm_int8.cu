// Kernel K4 for int8 rings (gen_hbm.cuh).
#define GEN_HBM_RING 2
#include "gen_hbm.cuh"
