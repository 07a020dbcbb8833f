// Kernel K4's instantiations of the trace kernel (csrc/trace.cuh), in a
// translation unit of their own (see trace.cuh); mk_trace in
// csrc/megakernel.cu launches them through launch_trace_med.

#include "trace.cuh"

int launch_trace_med(bool k3, const Pack& pk, const DepthCaps& md, int nee_m, const float* ray_o,
                     const float* ray_d, const uint32_t* rng, float* out_L, int* stats, int B,
                     const MedArgs& ma, const StageBytes& sb, cudaStream_t stream) {
    if (k3) {
        return launch_trace<true, true, true>(pk, md, nee_m, ray_o, ray_d, rng, out_L, stats, B,
                                              ma, sb, stream);
    }
    return launch_trace<false, true, true>(pk, md, nee_m, ray_o, ray_d, rng, out_L, stats, B, ma,
                                           sb, stream);
}
