// Kernel K5's SEG instantiations for a w8 pack with t9 prims or bf16 attrs
// (csrc/seg.cuh with CPT: the Renderer's packs of kitchen_stress and
// medium_cbox), in a translation unit of their own beside the f32 ones
// (csrc/megakernel_seg.cu, whose mk_trace_seg launches these through
// launch_seg_cpt).

#include "seg.cuh"

void launch_seg_cpt(bool k3, bool all, bool med, const Pack& pk, const DepthCaps& md, int nee_m,
                    const SegArgs& a, const MedArgs& ma, cudaStream_t stream) {
    launch_seg_fmt<false, true>(k3, all, med, pk, md, nee_m, a, ma, stream);
}
