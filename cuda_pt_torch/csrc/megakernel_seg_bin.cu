// Kernel K5's SEG instantiations for a pack with binary skip-tree nodes
// (f32 or bf16 rows; csrc/seg.cuh with BIN, the Pack's prim and attr
// formats), in a translation unit of their own beside the w8 ones
// (csrc/megakernel_seg.cu, whose mk_trace_seg launches these through
// launch_seg_bin). A binary pack takes no SHADE form: the split driver
// needs a w8 pack.

#include "seg.cuh"

void launch_seg_bin(bool k3, bool all, bool med, const Pack& pk, const DepthCaps& md, int nee_m,
                    const SegArgs& a, const MedArgs& ma, cudaStream_t stream) {
    launch_seg_fmt<true, true>(k3, all, med, pk, md, nee_m, a, ma, stream);
}
