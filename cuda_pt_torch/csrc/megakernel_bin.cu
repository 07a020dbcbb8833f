// The trace kernel's instantiations for a pack with binary skip-tree nodes
// (f32 or bf16 rows; csrc/trace.cuh with BIN, the walks of csrc/walk.cuh,
// the Pack's prim and attr formats): the four surface builds (K2 / K3) and
// the two MED ones (K4), in a translation unit of their own so that the w8
// units' modules stay as they are. mk_trace in csrc/megakernel.cu launches
// them through launch_trace_bin.

#include "trace.cuh"

int launch_trace_bin(bool k3, bool all, bool med, const Pack& pk, const DepthCaps& md, int nee_m,
                     const float* ray_o, const float* ray_d, const uint32_t* rng, float* out_L,
                     int* stats, int B, const MedArgs& ma, cudaStream_t stream) {
    return launch_trace_fmt<true, true>(k3, all, med, pk, md, nee_m, ray_o, ray_d, rng, out_L,
                                        stats, B, ma, stream);
}
