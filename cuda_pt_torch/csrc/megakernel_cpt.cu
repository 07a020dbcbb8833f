// The trace kernel's instantiations for a w8 pack with t9 prims or bf16
// attrs (csrc/trace.cuh with CPT: the prim and attr rows read in the Pack's
// formats; kitchen_stress and medium_cbox as the Renderer packs them): the
// four surface builds (K2 / K3) and the two MED ones (K4), in a translation
// unit of their own, so that the f32 builds (csrc/megakernel.cu,
// megakernel_med.cu) keep their code without a format branch. mk_trace in
// csrc/megakernel.cu launches them through launch_trace_cpt.

#include "trace.cuh"

int launch_trace_cpt(bool k3, bool all, bool med, const Pack& pk, const DepthCaps& md, int nee_m,
                     const float* ray_o, const float* ray_d, const uint32_t* rng, float* out_L,
                     int* stats, int B, const MedArgs& ma, cudaStream_t stream) {
    return launch_trace_fmt<false, true>(k3, all, med, pk, md, nee_m, ray_o, ray_d, rng, out_L,
                                        stats, B, ma, stream);
}
