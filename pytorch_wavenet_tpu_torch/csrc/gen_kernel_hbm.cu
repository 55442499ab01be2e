// Kernel K4 for f32 rings (gen_hbm.cuh).
#define GEN_HBM_RING 0
#include "gen_hbm.cuh"
