"""GPU smoke test of the PyTorch + CUDA port (cuda_pt_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build the CUDA kernels from cuda_pt_torch/csrc (one nvcc per
     translation unit, all started together, sm_90a) and print the seconds
     and ptxas' registers and spills per kernel instantiation (and what
     ptxas says of the wgmma products); with --parent, start the parent
     tree's build in the background;
  2. print the card's name and power limit (nvidia-smi);
  3. closest_hit_w8 against closest_hit_brute on 65536 random rays in the
     cornell box, and against the skip walk (accel/traverse.py) on 16384
     random rays in full-size kitchen_stress (98,790 triangles): prim ids
     equal except on exact ties; on the same kitchen rays, with every
     fifth lane dead, the traverse kernel K6 (the walk and the hit resolve)
     against its plain version (check_k6: prim ids equal, the hit planes
     bit-equal to resolve_hit of its own walk and within the per-lane
     contract of resolve_hit(traverse_plain); with --parent bit-equal to
     the parent's walk and resolve_hit);
  4. the megakernel against its plain PyTorch version (the fused kernel's
     estimator), 256x256, 4 spp, default depth caps, per-lane
     allclose(rtol=1e-4, atol=1e-5) on >= 98% of lanes and the image means
     within 5e-3, on cornell_box and its mirror / glass / GGX conductor /
     plastic / rough-dielectric tall boxes, cornell_box_lights (three
     emitters), the Oren-Nayar + Forward scene, the area-spot scene, the
     envmap furnace (its mean also within 0.05 of 1.0), the textured floor
     and kitchen_stress(grid=2, ns=6, nt=4) with all three K3 flags;
  4 (media). kernel K4, the volume path tracer's MED instantiations,
     against its plain version (the fused volume path tracer) under the
     phase-4 contract, 256x256, 4 spp: medium_box (HG), cornell_vpt (the
     camera in a medium), nested_media (media nested two deep), medium_box
     with a dual-HG and with a Rayleigh phase, and medium_box with an
     envmap (the K3 x MED instantiation);
  5. the main path on cornell_box (fewer than 512 boxes: the whole-path
     kernel K2): api.Renderer at 1024x1024, 64 spp, default depth caps,
     pcg, nee_candidates=1; the kernel's launch count must rise, every
     launch must be the STAGE build (the pack's tables in shared memory)
     and the image must be finite; then one spp of the main path's rays through
     the kernel and its plain version, held to the phase-4 contract; the
     same rays through the sorted-wavefront driver (kernel K5, auto_trace
     bypassed) held to the whole-path kernel bit for bit on every lane;
     the STAGE build against the plain build (the tables left in device
     memory) on the same rays, in turns, L bit-equal (stage_turns);
     the device launches (kernels and memsets) of one Renderer pass
     (torch.profiler), the parent's too with --parent; prints the kernel
     time per spp (CUDA events), paths/s, the plain version's time on the
     same rays and the bound; with --parent, the parent tree's K2 (one
     thread per path) against this tree's persistent grid on the same
     rays (ab_k2: lanes whose L or walk work differ bit for bit, which
     must be 0, then the ms in turns), as in phases 6 and 7 for K3 and K4
     called directly and in phase 11 for K2+BIN;
  6. the main path on full-size kitchen_stress (envmap, textures,
     dispersion; 76,784 boxes: the sorted-wavefront driver, K5's
     SEG+K3+ALL instantiation): api.Renderer at 1024x1024, 16 spp, the
     same settings, its pack in the reference's formats (w8 nodes, t9
     prims, bf16 attrs: the f32 pack is above the 2 MiB threshold of the
     format rule); launch counts (K5 only) and a finite image; one spp of
     its rays through the driver, a 65,536-lane Z-order block of that
     output held to the phase-4 contract against the driver on the plain
     versions; the driver's loop run piece by piece here (swf_loop, held
     bit for bit to the driver) for per spp K5's summed kernel time, the
     sort-and-gather glue, the other glue, the wall and the launches, the
     bound (the pack once plus the state planes K5 reads and writes,
     k5_bytes) and its share; with --parent, the parent tree's K5 on the
     same rays in turns (ab_k5: ms per spp, lanes whose L differs from
     this build's); and the whole-path kernel (K3, called directly) on the same rays: its time and a block held to
     its plain version, as before; then the same scene packed with f32
     attrs and prims: K5's and the whole-path kernel's time per spp and the
     image-mean gap between the two attr formats (f32_pass);
  7. the volume path tracer on full-size medium_cbox (36,888 triangles,
     media nested two deep; K5's SEG+ALL+MED): prints the BVH build
     seconds; api.Renderer(renderer=VOLUME_PT) at 1024x1024, 16 spp,
     default depth caps; the launch counts and a finite image; K5 held to
     its plain version on a 65,536-lane block and to the whole-path kernel
     K4 on every lane (untextured: the same estimator), with its timings
     as in phase 6; and K4 called directly: its time and a block held to
     its plain version; the pack in w8 nodes, t9 prims, bf16 attrs, and
     its f32 pass as in phase 6;
  8. grid media on grid_smoke with a density grid of 256^3 voxels (64 MiB,
     the size of a production smoke asset; the reference's grid-cbox .nvdb
     is absent): api.Renderer(renderer=VOLUME_PT) at 1024x1024, GRID_SPP
     spp (cut: spp, so that the phase's 64-step tracking loops stay under
     about a minute), default depth caps, through the split driver (K6 and
     K5's SEG+SHADE+ALL+MED+GRID); the launch counts and a finite image;
     the driver held to its plain version on a 65,536-lane block; K6
     (check_k6) on the first bounce of the main path's 1,048,576 rays and
     on a 65,536-lane block of them, every fifth lane dead; the timings of
     K5's shade phase and of K6 (the walk and the resolve, its bound with
     the g_hit columns read per hit lane and the hit planes written); K6
     per spp on one spp's recorded split states with its tables staged
     and left in device memory, in turns (ab_k6), and the device launches
     of its steps per spp; with --parent the parent's split step (its K6
     walk, then resolve_hit in PyTorch) on the same states, hit planes and
     the driver's L bit-equal to this tree's, the launches of its steps
     and of a whole driver pass of each tree, and its ms per spp and the
     driver's wall per spp in turns;
  9. kernel K1 (csrc/traverse.cu): full-size kitchen_stress forests in f32
     and in bf16 rows (forest_chunk 65536: two chunks; built in two worker
     processes while phases 4-8 run) and cornell's single-chunk forest,
     on the 1,048,576 camera rays of phase 6's camera (shadow limits half
     to one and a half times their closest t) and 65,536 random rays with
     finite t_far: per ray, prim ids and occlusion equal to the plain
     version, t, b1, b2 within the phase-4 tolerances, the bf16 rows' prim
     ids equal to the f32 rows'; the packet form (count_iters) on 16,384
     camera rays: tile_iters and prim ids equal to the plain packet walk;
     K1's time per 1M camera rays, closest and any hit (CUDA events), with
     its walk work (stats), bound and share, and per 32-lane group of
     the launch the largest and the mean node fetches per lane (the lane
     use a warp that waits for its longest walk reaches); with --parent,
     the parent tree's K1 against this tree's on the camera rays (ab_k1:
     rays whose hit or occlusion differ bit for bit, which must be 0, then
     the ms in turns); the sorted-lane walk alone
     (closest_hit_sorted, written for K5, which keeps the w8 walk) on the
     Renderer's kitchen pack against K1 on the camera rays (prim ids equal
     but on exact ties, counted) and bit-equal to the w8 walk, its stack
     depth and its time beside the w8 walk's;
  10. the wavefront main path: api.Renderer(renderer=WAVEFRONT_PT,
     traversal="pallas") on full-size kitchen_stress with its f32 forest,
     1024x1024, WF_SPP spp (cut: spp only), default depth caps: K1 and no
     other kernel launched, at most two launches per bounce, a finite
     image (its mean printed beside phase 6's K5 route's as a note: the
     two estimators agree in the mean only on textured scenes); K1's
     summed time, walk work, bound and per-group figures (as in phase 9)
     over one spp of the main path, and with --parent the same K1 calls
     replayed on the parent tree's K1 and on this one's (ab_k1_calls: rays
     differing bit for bit, which must be 0, then the ms in turns); a
     65,536-lane Z-order block of a pass's rays through the wavefront loop
     on K1 and on its plain walk, held to the phase-4 contract;
  4 (routes). the composed routes, SMALL x SMALL x 1 spp: the Renderer with
     traversal "pallas" against "xla" (the plain skip walk) per lane under
     the phase-4 contract on cornell (brute force on both: no K1 launch)
     and kitchen_stress(grid=2) with MEGAKERNEL_PT, and on full-size
     medium_cbox with VOLUME_PT.
  11. the reference's render_megakernel (make_pack(scene) in its rule's
     formats, then render_pack) at full size, launch counts set to 0 just
     before each and read just after: cornell 1024x1024 x RM_CORNELL_SPP on
     binary f32 nodes (the whole-path kernel, K2+BIN) and kitchen_stress
     1024x1024 x RM_KITCHEN_SPP on bf16 binary nodes, t9 prims and bf16
     attrs (K5, SEG+K3+ALL+BIN); per scene the kernel's time per spp on
     sample 0's rays, the walk work (node fetches, prim tests), bound and
     share, a 65,536-lane block held to the plain version, and the binary
     walk (closest_hit_w8 on f32 and bf16 rows) against K1 over the BVH as
     one chunk on the camera rays: prim ids equal;
  12. kernel S1 (csrc/node_bench.cu) on cornell's and kitchen_stress's
     binary f32 rows: S1_ITERS steps on S1_RAYS equal rays (the
     reference's) and on a block of random rays bit-equal to the plain
     version; c_node from its time at S1_ITERS and S1_ITERS / 2 steps, and
     S1's model share (node fetches x c_node over the measured time) of
     phase 11's two kernels; with --parent bit-equal to the parent's
     kernel on both sets of rays, its time and c_node in turns with it;
  13. kernel S2 (csrc/extract_ab.cu) on kitchen_stress's binary f32 rows:
     every tag bit-equal to its plain version on a tile of the reference's
     equal rays and a tile of random rays (8,192 lanes each, S2_HOLD_ITERS
     steps; each tile a cluster of blocks) and on 128 tiles
     (S2_CARD_HOLD_ITERS steps; a block per tile), with --parent to the
     parent's kernel too, v0 = v1 = v2 per lane, v0 on the equal rays =
     S1; with --parent each tag's c_node at 1 and 128 tiles in turns with
     the parent's kernel; the entry
     (extract_ab.main, launches counted from 0) on one tile over kitchen's
     and cornell's rows at 30,000 and 15,000 steps (the reference's shape),
     and over CARD_LANES lanes on kitchen's; c_node per tag and its bound;
  14. kernel S3 (csrc/lanegather.cu): every tag bit-equal to its plain
     version at (64, 128) x 512 and (8192, 128) x 16, the check gather equal
     to torch.take_along_dim; the gather warm and cold (L2 flushed before
     each launch) and an empty kernel on its grid (the launch floor) at
     both sizes; with --parent every tag and the gather bit-equal to the
     parent's kernel and the gather warm and cold in turns with it; the
     entry (lanegather.main, launches counted) at (64, 128) and (8192,
     128); per tag ns per iteration, per gather and per select; the
     gather against torch.take_along_dim;
  15. kernel S4 (csrc/mxuleaf.cu): scalar bit-equal to its plain version,
     mxu (3xTF32 wgmma) within the script's parity contract (>= 0.999
     agree and hit mask) against the plain product and against scalar, the
     1xTF32 A/B's hit mask >= 0.99, at 4,096 rays x 2,000 leaves and at
     CARD_LANES rays x S4_CARD_HOLD_LEAVES; HGMMA in both mxu builds' SASS
     (and the select chains' opcodes of phase 14); with --parent, the
     parent's mxu forms on the same inputs in turns; the entry
     (mxuleaf.main, launches counted) at 4,096 and CARD_LANES rays; the
     batched torch.matmul of the product alone;
  16. the light tracer's main path: api.Renderer(renderer=MEGAKERNEL_LT,
     traversal="pallas") on full-size kitchen_stress with its f32 forest,
     1024x1024, LT_SPP passes (cut: passes only), default depth caps: K1
     and no other kernel, at most 2 max_depth + 1 launches a pass (a
     closest and a connection walk per bounce and the vertex-0
     connection), a finite image with a positive mean; the wall and the
     launches per pass, and K1's summed time, walk work, bound and share
     over one pass (as in phase 10); 65,536 light paths (render_pass
     n_paths=BLOCK) on K1 and on its plain walk, held per pixel (float
     atomics do not fix the splat's order: over the pixels either touched,
     allclose(rtol 1e-4, atol 1e-6 x the largest pixel) on >= 98 %, image
     sums within 1e-4 relative); cornell 1024x1024 x LT_SPP through
     MEGAKERNEL_LT (brute force: no launch) and the fused MEGAKERNEL_PT,
     their image means' ratio in (0.8, 1.25); DEPTH and BVH_COST at SMALL
     on cornell and kitchen_stress(grid=2) held to the same Renderer on
     CPU tensors (DEPTH: the depth buffer, t_min and t_max within 4e-6
     relative, the image equal on >= 99 % of pixels; BVH_COST: the cost
     counts equal on >= 99.9 % of rays, mean_cost within 1e-3 relative),
     and each at 1024x1024 on cornell, its wall per pass; render_aovs(
     spp=1) under "pallas" on full-size kitchen_stress launching K1 alone,
     its coverage equal to the plain walk's and its depth within 1e-5
     relative on >= 99.9 % of pixels; denoise() of the fused cornell film
     at 4 passes against atrous_denoise on CPU copies of its mean, AOVs and
     variance (allclose rtol 1e-4, atol 1e-4);
  17. gradients on the card, each figure printed with the card's name and
     power limit: the inverse-rendering main path at full width
     (cuda_pt_torch.inverse_render.main, albedo family, cornell
     GRAD_RES x GRAD_RES, "remat", its default 8 spp and max_depth 3;
     cut: GRAD_STEPS Adam steps) with the loss, parameter error, wall and
     peak memory of each step, no kernel launched (32 prims: the brute
     force), the k_d gradient of rows 0-2 finite and non-zero; at
     GRAD_CHECK_SPP spp "remat" against plain (the image bit-equal, the
     gradient within rtol 1e-6, remat's peak memory below plain's), the
     peak memory of plain, remat and remat nested in each pass (each
     bounce checkpointed inside the pass's checkpoint, as the reference
     nests them; printed only) at MEM_SPP spp, remat's below plain's and
     flat in spp, and the emitter-scaler gradient against central
     differences with common random numbers (rtol 2e-3); volume_pt.render(differentiable="remat")
     on full-size medium_cbox under "pallas" (K1, detached), GRAD_RES x
     GRAD_RES x VPT_GRAD_SPP, MaxDepthParams(max_depth=4, max_volume=3),
     gradients in both media's scale: K1's launches (> 0), the wall and
     the peak memory, and on a CROP x CROP window of the same camera the
     K1 route's image (phase-4 contract) and gradient (rtol 1e-3) held to
     the plain "xla" walk's; ToF on the Renderer's composed route
     (kitchen_stress 1024x1024 x TOF_SPP, traversal "pallas", f32 forest):
     the windows [0, TOF_SPLIT] and [TOF_SPLIT, 1e6] summing to the
     ungated image per pixel within 1e-3, K1's launches and the wall per
     pass of each;
 18. sampling: Renderer(sampler="sobol") on cornell 1024x1024 x SOBOL_SPP
     (the hybrid scheme: Sobol camera jitter, pcg path streams into K2;
     K2 launched, its wall per spp and K2's ms per spp in turns with the
     pcg Renderer, the ray setup's ms and device launches per pass); a
     BLOCK-lane block's Sobol states, jitter draws and pcg streams built
     on the card bit-equal to the CPU port's, its rays within 1e-6, and
     K2 on it held to its plain version (phase-4 contract); kitchen_stress
     1024x1024 x SOBOL_KITCHEN_SPP on K5 (launched; the image mean within
     2 % of phase 6's pcg image); on cornell QUALITY_SIZE^2 the MSE of
     Sobol against pcg at QUALITY_SPP and of render_adaptive against
     render at ADAPTIVE_BUDGET, each against QUALITY_REF_SPP pcg spp on K2
     (each image's mean within QUALITY_MEAN_TOL of the reference's);
     render_adaptive(ADAPTIVE_BUDGET) on cornell 1024x1024 through K2
     (base passes plus rounds launches, n's mean, the film-count rule,
     its wall in turns with render); a checkpoint after CKPT_SPP spp,
     loaded into a fresh Renderer and rendered CKPT_SPP more, bit-equal
     to 2 x CKPT_SPP straight spp under both samplers. The K2 and K5
     entries gain sobol_launches_per_pass; sampling_check joins the
     result line.
 19. scene input (the XML path, no scene built in Python): (a) the three
     host libraries (native SAH and SBVH builders, OBJ parser) built at
     once with g++, and the native OBJ parser against the Python one on
     kitchen_stress's OBJ files; (b) full-size kitchen_stress: the NumPy
     SAH build against the native one (seconds, SAH cost, nodes), the SBVH
     (seconds, duplicated refs, nodes), and the SBVH walk's closest
     original prim held to the BVH's on SBVH_RAYS random rays (equal but
     on exact ties); (c) cornell_box and kitchen_stress written as XML
     (write_scene_xml: OBJ at %.9g, textures as 8-bit sRGB PNG, the sky
     as RGBE .hdr, the Au and Glass-BK7 presets) and rendered by
     Renderer(path, override_res=(1024, 1024)) on K2 (XML_CORNELL_SPP)
     and K5 (XML_KITCHEN_SPP): the parsed triangles equal the builder's
     as multisets, launches counted, an XML_BLOCK-lane block held per
     lane to the plain version, the means beside phases 5 and 6's (no
     bound); (d) the SBVH kitchen (override_accel) on K5, held likewise,
     its wall per spp beside (c)'s; (e) traversal="auto" on the XML
     kitchen (each candidate's ms, the pick, K1's launches while tuning
     and in one 1-spp pass with the pick) and "mxu" timed on the XML
     cornell (since the matmul brute force was ported); (f) grid_smoke's GRID_N^3 grid as a ZIP-codec .nvdb in
     an XML scene, VOLUME_PT 1 spp through Renderer(path) on K6, held per
     lane as phase 8 holds. The K2, K5, K6 and K1 entries gain this
     path's launches; scene_input_check joins the result line.
 20. the volume path tracer's last routes and distributed rendering:
     (a) full-size kitchen_stress (its HDR sky) with grid_smoke's null
     container holding a GRID_N^3 density grid with a temperature field
     and emission_scale GRID_EMISSION (outside the fused envelope twice:
     envmap, emission), Renderer(VOLUME_PT, traversal="pallas") at
     1024x1024 x 1 spp on the composed route (K1 alone): the wall, K1's
     launches and summed ms, the PyTorch (aten) operators per pass
     (aten_ops: the profiler's count of its device launches takes
     minutes at this size), the image mean, the allocator's peak; at SMALL^2 on
     kitchen_stress(grid=2) with the same grid, "pallas" held per lane to
     "xla" (phase-4 contract, max_depth cut to HOLD_DEPTH); (b) the
     composed grid estimators on the card at GRID_EST_SIZE^2: the
     zero-albedo constant-grid absorber against the equivalent
     homogeneous slab (2 % in the mean), the sigma = 0 null slab's NEE
     against the slab-free surface render (12 %; ABSORBER_SPP each),
     grid_smoke (GRID_N^3) on the composed route against the split route
     (K6 + K5) in the mean (20 %; GRID_EST_SPP each); (c) medium_cbox
     VOLUME_PT on K1 at 1024x1024 x 1 spp with and without compact=True:
     walls, K1 launches and live lanes per launch, the images per lane to
     the phase-4 contract; (d) count_rays on kitchen_stress (K1) and
     medium_cbox at 1024x1024 x 1 spp: the count, seconds and rays per
     second, each held equal to the per-lane sum of the render's own
     streams; (e) two ranks on the one card (gloo; `--dist-worker`
     processes) and one rank under NCCL, all three at once: "fused" on cornell 1024x1024 x
     DIST_FUSED_SPP (K2) with (sp, dp) = (1, 2), bit-equal to the
     single-process kernel on the same streams, and (2, 1), within rtol
     1e-5; "vpt" on medium_cbox DIST_VPT_SIZE^2 x DIST_VPT_SPP (K1,
     compacted) held per lane to the single-process uncompacted render;
     render_train_step(remat=True) on cornell DIST_TRAIN_SIZE^2: loss and
     gradients equal on both ranks and within rtol 1e-4 of the
     single-process step. volume_check, count_check and
     distributed_check join the result line; the K1 and K2 entries gain
     this phase's launches. The gloo pair also
     runs the torchrun entry (distributed_render.main) with --multihost,
     the multi-node variables (LOCAL_RANK, LOCAL_WORLD_SIZE, GROUP_RANK)
     set by the spawner on this one host, on an XML cornell at ENTRY_SIZE^2
     with sp 2, and --tensorboard: run where torch.utils.tensorboard
     imports, else the entry must stop naming the package.
 21. the tail modules: (a) the web viewer (viewer/server.py) serving
     cornell_box 1024x1024 on K2 through a real ThreadingHTTPServer on
     127.0.0.1 (port 0): VIEWER_PASSES passes polled on /info, /frame.png
     decoded by utils/image.decode_png and bit-equal to the film's sRGB
     export, an emitter scaler and a material k_d edit posted: the first
     pass of each new generation bit-equal, lane for lane, to pass 0 of a
     fresh Renderer on the edited scene (the edit reached K2's pack); the
     family switched to depth and back, a ToF window on and off, each
     route read from /info; the same edit hold on kitchen_stress 1024x1024
     (K5, two viewer passes driven one by one); ms per pass (/info), per
     PNG encode at 1024^2 and per _reroute (the re-pack), K2's and K5's
     launches; (b) traversal="mxu" on cornell 1024x1024 x 1 against the
     brute force on the same streams (camera hits on >= 99.5 % of the
     1,048,576 rays, the image's q99 below 2e-2 and mean within 1e-3), its
     chunk, lane band, ms and peak MiB; on a SOUP_PRIMS-triangle soup at
     SOUP_RAYS rays the closest hit of mxu, K1 and the skip walk timed,
     each held to mxu's hits, and allow_tf32 as found, the hits unchanged
     with it on; (c) train_guide on kitchen_stress 1024x1024 on K1 (spp
     GUIDE_SPP, GUIDE_STEPS steps): loss, seconds, K1 launches; a guided
     and an unguided wavefront render (GUIDED_SPP) on K1: walls, launches,
     means within four standard errors; the slot scene at SLOT_SIZE^2 over
     SLOT_SEEDS seeds: guided over unguided per-pixel variance; (d)
     utils/timing.timeit_stats of a cornell K2 pass beside its CUDA-events
     time, and loop_cost of a small step; (e) in phase 20's spawn.
     viewer_check, mxu_check and guide_check join the kernels line,
     timing_check the result line; the K1, K2 and K5 entries gain this
     phase's launches.
 22. the command-line tools (cuda_pt_torch/scripts/), each driven
     through its main(argv) or its factored function, every output in a
     temporary directory; (a), (h) and (j) in this process, the tools that
     launch no kernel, (i) and the slow holds in TOOL_WORKERS card worker
     processes and one CPU worker at once (host-bound, so each tool's time
     is taken beside the others): (a) serial_render at 1 spp on
     phase 19's XMLs (rewritten here): static cornell x 2 frames (K2) and
     kitchen x 2 (K5) at TOOLS_SIZE^2, the grid x 3 frames, each a
     ZIP-NanoVDB density (write_nvdb_zip), at SERIAL_VOLUME_SIZE^2 (cut; K6
     and K5's shade form), a ToF sweep on cornell x 3 (the composed route,
     no kernel); each frame's film bit-equal to a fresh Renderer's pass on
     that frame's input (a volume frame's grid loaded straight from its
     file), a second call over each directory rendering nothing and
     launching nothing; (b) analyze_rays at its defaults (RAYS_ARGS) on
     cornell and the XML kitchen, held to the same call on the CPU (a
     worker process started at the phase's start) within 2 / res^2 per
     bounce; (c) showcase, (d) quality_bench, (e) guiding_study (--seeds
     GUIDING_SEEDS, cut), (f) compaction_sweep (CUDA_PT_REFERENCE_XML
     cleared: its VPT half on cornell) and (g) sbvh_budget_sweep
     on the XML kitchen through their entries (none launches a kernel);
     (h) packet_divergence on cornell through main and on kitchen_stress
     through measure (PACKET_KITCHEN^2 rays, the tool's default), K1's
     packet form, the node fetches bit-equal to the plain packet form
     (cornell's every tile on the card; the kitchen's per-tile counts
     summing to measure's rows, and held_tiles' sample of its tiles in a
     worker process); (i) profile_render --impl pallas on
     cornell, its trace naming K1's kernel; (j) interactive_probe at 512^2
     x 30 frames (K2), the film after its camera edit equal to a fresh
     Renderer's first pass. tools_check joins the kernels line; the K1,
     K2, K5 and K6 entries gain this phase's launches (tools_launches).
The last two lines are a JSON object of kernel numbers and
{"ok": true, "device": {...}}. ``--size`` and ``--spp`` shrink phase 5
for quick checks and ``--kitchen-spp`` phase 6; phases 7 and 8 always run
at VPT_SPP and GRID_SPP samples per pixel and hold BLOCK lanes.
``--quality-ref`` only times quality_bench's reference render batched
against single passes. ``--profile`` adds a torch.profiler breakdown of a few main-path passes
of each scene, of kitchen_stress and medium_cbox through the whole-path
kernel too, and of the wavefront and light-tracer main paths. ``--parent TREE`` (a git
archive of the parent commit unpacked under the git-ignored build/) holds
the parent's K2-K4, K1, K6 (its walk and resolve_hit), S1, S2 and S3 to
this tree's bit for bit and times them in turns (phases 3, 5-14), and
times the parent's K5 and S4 mxu against this tree's in phases 6, 7 and
15.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import io
import json
import multiprocessing
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_S = 67e12  # H100 SXM f32 outside the tensor cores
# f32 operations per test, counted from csrc/walk.cuh: a child slab test is
# 6 sub + 6 mul + 6 min/max + 4 min/max; a triangle test is 2 cross (9
# each) + 4 dot (5 each) + 3 sub + 1 reciprocal + 3 mul.
OPS_SLAB = 22
OPS_TRI = 45
RTOL, ATOL, MAX_LANE_FRAC = 1e-4, 1e-5, 0.02
MEAN_TOL = 5e-3
# lanes of each main path (phases 6-8) held to the plain version (its run
# on this block stays under 30 s on an H100)
BLOCK = 65536
# samples per pixel of the volume main paths: medium_cbox (phase 7) and
# grid_smoke (phase 8) with its grid of GRID_N^3 voxels
VPT_SPP = 16
GRID_SPP = 8
GRID_N = 256
# kernel K1 (phases 9-10): prims per chunk of the kitchen forest, samples
# per pixel of the wavefront main path (cut: spp only), camera rays of the
# packet-form check, side of the composed-route holds (phase 4's style)
FOREST_CHUNK = 65536
WF_SPP = 2
PACKET_RAYS = 16384
SMALL = 128
# the light tracer's main path and the light-against-path check (phase 16;
# cut: passes only)
LT_SPP = 2
# gradients (phase 17; cut: Adam steps, spp): the inverse-rendering side,
# its steps, the spp of the remat / plain and finite-difference checks, the
# volume gradient render's spp and its held window, the ToF route's passes
# and the path length splitting its two windows (kitchen's camera paths
# fall on both sides of it)
GRAD_RES = 512
GRAD_STEPS = 3
GRAD_CHECK_SPP = 4
MEM_SPP = (2, 8)
VPT_GRAD_SPP = 2
CROP = 64
TOF_SPP = 2
TOF_SPLIT = 20.0
# sampling (phase 18; cut: spp and rounds only): the hybrid Sobol route's
# spp on cornell and on kitchen_stress, the quality check's side, its pcg
# reference's spp and the compared spp, the adaptive budget, the spp before
# and after the checkpoint
SOBOL_SPP = 16
SOBOL_KITCHEN_SPP = 2
QUALITY_SIZE = 256
QUALITY_REF_SPP = 1024
QUALITY_SPP = 16
ADAPTIVE_BUDGET = 8
CKPT_SPP = 2
QUALITY_MEAN_TOL = 0.05  # each image's mean against the reference's, relative
# render_megakernel at full size (phase 11; cut: spp only): samples per
# pixel on cornell and on kitchen_stress
RM_CORNELL_SPP = 16
RM_KITCHEN_SPP = 2
# kernel S1 (phase 12): rays and node steps per timed launch
S1_RAYS = 1 << 20
S1_ITERS = 1024
# kernels S2-S4 (phases 13-15): lanes of the card's scale, S2's hold steps
# (S1's; fewer at the card's scale, for the plain version's time), S4's
# hold leaves at the card's scale (the plain version's chunks shrink with
# the rays)
CARD_LANES = 1 << 20
S2_HOLD_ITERS = 1024
S2_CARD_HOLD_ITERS = 256
S4_CARD_HOLD_LEAVES = 16
PEAK_TF32_S = 495e12  # H100 SXM dense TF32 on the tensor cores
# f32 operations per lane and step of each S2 form (the slab test: OPS_SLAB)
OPS_S2 = {"e0": 1, "e1": 1, "e2": 1, "e3": 10, "v0": 22, "v1": 22, "v2": 22, "w2": 44,
          "v0_ilp2": 44, "v0_ilp4": 88, "v2_ilp2": 44}
# f32 operations per triangle and ray of S4's mxu epilogue (|det|, a select,
# the divide, 3 products, |det| again, 5 compares and an add, the update)
OPS_MXU_EPI = 14
# the device sleep before a kernel timed alone (swf_loop): 0.5 ms at the
# H100's highest SM clock (1.98 GHz), longer at lower clocks; it only has to
# outlast the host's launch latency
SETTLE_CYCLES = 1_000_000


T0 = time.perf_counter()


def log(msg):
    """Print msg after the seconds since the script started."""
    print(f"{time.perf_counter() - T0:7.1f}s {msg}", flush=True)


def events_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def lane_mismatch(a: torch.Tensor, b: torch.Tensor) -> float:
    close = torch.isclose(a, b, rtol=RTOL, atol=ATOL).all(dim=-1)
    return float((~close).float().mean())


def check_contract(name: str, L_k: torch.Tensor, L_p: torch.Tensor) -> tuple:
    """Hold kernel output to the plain version's: finite, at most
    MAX_LANE_FRAC of lanes outside allclose, means within MEAN_TOL.
    Returns (lane fraction differing, |mean difference|)."""
    if not torch.isfinite(L_k).all():
        raise SystemExit(f"{name}: non-finite kernel output")
    frac = lane_mismatch(L_k, L_p)
    dmean = abs(float(L_k.mean()) - float(L_p.mean()))
    if frac > MAX_LANE_FRAC or dmean > MEAN_TOL:
        raise SystemExit(f"{name}: kernel breaks the per-lane contract "
                         f"({frac} of lanes differ, means differ by {dmean})")
    return frac, dmean


def phase_build(cb) -> dict:
    """Build the library; print the seconds and, per kernel instantiation,
    ptxas' registers and spill bytes (the template flags in the order of
    each kernel's template: trace_kernel<K3,ALL,MED,BIN>,
    seg_kernel<K3,ALL,MED,SHADE,GRID,BIN,CPT>, ...) and what ptxas says of
    the wgmma products (a serialized wgmma is named there)."""
    secs = cb.build()
    log(f"[1] built megakernel in {secs:.1f} s")
    blog = cb.build_log()
    rows = cb.ptxas_report(blog)
    for name, regs, st, ld in rows:
        log(f"    {name}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    notes = sorted({line.strip() for line in blog.splitlines() if "wgmma" in line.lower()})
    for line in notes:
        log(f"    ptxas: {line}")
    return {"build_s": secs, "ptxas": rows, "wgmma_notes": notes}


# the parent tree's build (--parent): its running build, then its library
_PARENT = {"job": None, "lib": None}


def start_parent(cb, args) -> None:
    """Start the build of the parent checkout's library (--parent: a git
    archive of the parent commit unpacked in a directory, e.g. under the
    git-ignored build/), timed against this tree's on the same inputs."""
    if args.parent:
        _PARENT["job"] = cb.start_tree_build(args.parent)


def parent_lib() -> str | None:
    """The library path of start_parent's build (None without --parent),
    waited for at the first call; prints its K2-K5, K1 and S4
    instantiations' registers and spills."""
    from cuda_pt_torch.ops import cuda_build as cb

    if _PARENT["job"] is not None and _PARENT["lib"] is None:
        _PARENT["lib"] = cb.finish_tree_build(_PARENT["job"])
        for kname, regs, st, ld in cb.ptxas_report(cb.build_log(_PARENT["lib"])):
            if kname.startswith(("seg_kernel", "leaf_mxu", "trace_kernel", "k1_kernel",
                                 "traverse_kernel", "extract_ab_kernel")):
                log(f"    [parent] {kname}: {regs} registers, spill stores {st} B, "
                    f"spill loads {ld} B")
    return _PARENT["lib"]


def start_sass(cb) -> dict:
    """The built library's SASS, dumped by cuobjdump in a process of its own
    while the phases run; "read"(patterns) waits for it and returns the
    opcode counts of the kernels whose symbols contain a pattern (phase
    15), "stop"() ends the process if it still runs."""
    from tools import sass_ops

    path = os.path.join(cb.BUILD_DIR, "sass_dump.txt")
    proc = sass_ops.start_dump(cb.library_path(), path)

    def read(patterns):
        if proc.wait() != 0:
            raise SystemExit(f"cuobjdump failed: {proc.stderr.read().decode()[-2000:]}")
        with open(path) as f:
            return sass_ops.opcodes_of(f.read(), patterns)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    return {"read": read, "stop": stop}


def phase_card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(out, flush=True)  # as nvidia-smi gives it, on a line of its own
    return out


def phase_walk(mk, tts, dev):
    scene, _, _ = tts.cornell_box(device=dev)
    pack = mk.make_pack(scene, node_fmt="w8")
    rs = np.random.default_rng(7)
    B = 65536
    o = rs.uniform(0.05, 0.95, (B, 3)).astype(np.float32)
    d = rs.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o_t = torch.as_tensor(o, device=dev)
    d_t = torch.as_tensor(d, device=dev)
    t_k, prim_k, _, _ = mk.closest_hit_w8(pack, o_t, d_t)
    from cuda_pt_torch.ops import intersect as isect

    t_all, _, _, _ = isect.intersect_gather(scene.geom, o_t, d_t,
                                            *isect.all_prims(scene.geom, B))
    prim_b = isect.closest_hit_brute(scene.geom, o_t, d_t)["prim"]
    differ = prim_k != prim_b
    t_min = t_all.min(dim=1).values
    t_of_k = torch.gather(t_all, 1, prim_k.clamp(min=0)[:, None])[:, 0]
    ties = differ & (prim_k >= 0) & (t_of_k == t_min)
    bad = int((differ & ~ties).sum())
    log(f"[3] closest_hit_w8 vs closest_hit_brute, {B} rays: {int(differ.sum())} prim ids differ, "
        f"{int(ties.sum())} on exact ties, {bad} otherwise; hits {int((prim_k >= 0).sum())}")
    if bad:
        raise SystemExit(f"walk check failed: {bad} prim ids differ off exact ties")
    return {"rays": B, "differ": int(differ.sum()), "exact_ties": int(ties.sum())}


def phase_walk_kitchen(mk, tts, dev):
    """The w8 walk against the skip walk on full-size kitchen_stress; returns
    (the result row, the scene, its camera, the build seconds, its builder)."""
    from cuda_pt_torch.accel import traverse
    from cuda_pt_torch.ops import cuda_build as cb
    from cuda_pt_torch.ops import intersect as isect

    t0 = time.perf_counter()
    scene, cam, kb = tts.kitchen_stress(1024, 1024, device=dev)
    build_s = time.perf_counter() - t0
    pack = mk.make_pack(scene, node_fmt="w8")
    rs = np.random.default_rng(11)
    B = 16384
    lo = scene.bvh.node_min[0].cpu().numpy()
    hi = scene.bvh.node_max[0].cpu().numpy()
    o_t = torch.as_tensor(rs.uniform(lo, hi, (B, 3)).astype(np.float32), device=dev)
    d = rs.normal(size=(B, 3)).astype(np.float32)
    d_t = torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True), device=dev)
    _, prim_k, _, _ = mk.closest_hit_w8(pack, o_t, d_t)
    h = traverse.closest_hit_bvh(scene.geom, scene.bvh, o_t, d_t)
    o_t, d_t = o_t.contiguous(), d_t.contiguous()
    differ = prim_k != h["prim"]
    # an exact tie: the walk's own prim is hit at the plain walk's t
    idx = torch.nonzero(differ & (prim_k >= 0))[:, 0]
    t_of_k, hit_k, _, _ = isect.intersect_gather(
        scene.geom, o_t[idx], d_t[idx], prim_k[idx][:, None],
        torch.ones((idx.numel(), 1), dtype=torch.bool, device=dev))
    ties = int((hit_k[:, 0] & (t_of_k[:, 0] == h["t"][idx])).sum())
    bad = int(differ.sum()) - ties
    log(f"[3] kitchen_stress ({scene.geom.num_prims} triangles, BVH built in {build_s:.1f} s; "
        f"{pack['nodes'].shape[0]} wide nodes, walk stack {pack.max_stack} of "
        f"{cb.MK_MAX_STACK}, max leaf {pack.max_leaf}): "
        f"closest_hit_w8 vs closest_hit_bvh, {B} rays: {int(differ.sum())} prim ids differ, "
        f"{ties} on exact ties, {bad} otherwise; hits {int((prim_k >= 0).sum())}")
    if bad:
        raise SystemExit(f"kitchen walk check failed: {bad} prim ids differ off exact ties")
    k6 = check_k6(mk, pack, k6_state(mk, pack, o_t, d_t), B, "kitchen_stress random rays")
    return {"rays": B, "differ": int(differ.sum()), "exact_ties": ties, "k6": k6}, scene, cam, \
        build_s, kb


def k6_state(mk, pack, o, d):
    """State planes of rays (B, 3) with every fifth lane dead."""
    st = mk.seg_init(pack, o, d, torch.zeros((o.shape[0], 2), dtype=torch.int64, device=o.device))
    st.view(torch.float32)[mk.S_ACT, ::5] = 0.0
    return st


# the parent tree's K6 entry (--parent): tables, state, stride, n, out,
# stats, max_leaf, tri_only, fmt, n_nodes, stream
PARENT_K6 = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + \
    [ctypes.c_int] * 4 + [ctypes.c_void_p]


def parent_walk(mk, pack, st, n, stats=None):
    """The parent tree's K6 walk (inside with_parent; its C entry
    mk_traverse) -> its (t, gid, u, v) planes (4, n)."""
    from cuda_pt_torch.ops import cuda_build as cb

    lib = cb.load()
    lib.mk_traverse.argtypes = PARENT_K6
    lib.mk_traverse.restype = ctypes.c_int
    out = torch.empty((4, n), dtype=torch.float32, device=st.device)
    rc = lib.mk_traverse(mk._tables(pack), st.data_ptr(), st.shape[1], n, out.data_ptr(),
                         stats.data_ptr() if stats is not None else None, *mk.walk_args(pack),
                         torch.cuda.current_stream(st.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the parent's mk_traverse: cudaError {rc}")
    return out


def parent_k6(mk, pack, st, n, trav=None, stats=None):
    """The parent tree's split step (inside with_parent): its K6 walk
    (parent_walk), then resolve_hit's row gather in PyTorch; the arguments
    and result of mk.traverse_resolve."""
    out = parent_walk(mk, pack, st, n, stats)
    if trav is not None:
        trav.copy_(out)
    return mk.resolve_hit(pack, out)


@contextlib.contextmanager
def parent_split(mk):
    """The parent tree's library while the block runs, and the split
    driver's K6 step its form: this tree's where the parent's library
    exports mk_traverse_resolve (the walk and the resolve in the kernel),
    else parent_k6."""
    from cuda_pt_torch.ops import cuda_build as cb

    real = mk.traverse_resolve
    prev = cb.use_library(parent_lib())
    if not hasattr(cb.load(), "mk_traverse_resolve"):
        mk.traverse_resolve = lambda pack, st, n, trav=None, stats=None: parent_k6(
            mk, pack, st, n, trav, stats)
    try:
        yield
    finally:
        cb.use_library(prev)
        mk.traverse_resolve = real


def check_k6(mk, pack, st, n: int, label: str) -> dict:
    """Kernel K6 (the walk and the hit resolve) on the first n lanes of the
    state planes st (every fifth dead): prim ids equal to the plain walk's
    on every lane, dead lanes without a hit; the hit planes bit-equal to
    resolve_hit of the same launch's (t, gid, u, v) output and within the
    per-lane contract of resolve_hit(traverse_plain); with --parent, bit-
    equal to the parent's resolve_hit(traverse_closest) on every lane."""
    trav = torch.empty((4, n), dtype=torch.float32, device=st.device)
    hit = mk.traverse_resolve(pack, st, n, trav)
    ref = mk.traverse_plain(pack, st, n)
    want = mk.resolve_hit(pack, ref)
    torch.cuda.synchronize()
    differ = int((trav[1] != ref[1]).sum())
    hits = int((trav[1] >= 0).sum())
    both = (trav[1] >= 0) & (ref[1] >= 0)
    err = float((trav[0][both] - ref[0][both]).abs().max()) if bool(both.any()) else 0.0
    own = bit_lanes(hit.T, mk.resolve_hit(pack, trav).T)
    frac = lane_mismatch(hit.T, want.T)
    plane_err = float(torch.where(hit == want, 0.0, (hit - want).abs()).max())
    row = {"rays": n, "differ": differ, "hits": hits, "max_abs_err_t": err,
           "planes": hit.shape[0], "planes_lanes_differ_own": own,
           "planes_lanes_outside_contract": frac, "planes_max_abs_err": plane_err}
    if parent_lib() is not None:
        with parent_split(mk):
            p_hit = mk.traverse_resolve(pack, st, n)
        row["planes_lanes_differ_parent"] = bit_lanes(hit.T, p_hit.T)
    log(f"[K6] walk + resolve vs the plain walk on {n} {label} (every fifth dead): {differ} prim "
        f"ids differ; hits {hits}; {hit.shape[0]} hit planes: lanes not bit-equal to resolve_hit "
        f"of its own walk {own}, outside the contract against resolve_hit(traverse_plain) "
        f"{frac:.7f}" + (f", not bit-equal to the parent's {row['planes_lanes_differ_parent']}"
                         if "planes_lanes_differ_parent" in row else ""))
    if differ or not bool((trav[1, ::5] == -1).all()) or own or frac > MAX_LANE_FRAC \
            or row.get("planes_lanes_differ_parent", 0):
        raise SystemExit(f"K6 check failed on {label}: {row}")
    return row


def phase_kernel(mk, tts, dev, MaxDepthParams, BSDFSpec, T):
    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core import qmc

    md = MaxDepthParams()
    variants = {
        "cornell": lambda: tts.cornell_box(256, 256, device=dev),
        "mirror": lambda: tts.cornell_box(256, 256, device=dev, tall_box_bsdf=BSDFSpec(
            btype=T.BSDF_SPECULAR, k_d=(0.95, 0.95, 0.95))),
        "glass": lambda: tts.cornell_box(256, 256, device=dev, tall_box_bsdf=BSDFSpec(
            btype=T.BSDF_TRANSLUCENT, k_s=(0.98, 0.98, 0.98), ior=1.5)),
        "lights": lambda: tts.cornell_box_lights(256, 256, device=dev),
        "ggx_conductor": lambda: tts.cornell_box(256, 256, device=dev, tall_box_bsdf=BSDFSpec(
            btype=T.BSDF_GGX_CONDUCTOR, eta=(0.143, 0.375, 1.444), k=(3.983, 2.386, 1.603),
            roughness_x=0.2, roughness_y=0.2)),
        "plastic": lambda: tts.cornell_box(256, 256, device=dev, tall_box_bsdf=BSDFSpec(
            btype=T.BSDF_PLASTIC, k_d=(0.1, 0.3, 0.65), k_s=(1.0, 1.0, 1.0), ior=1.5,
            thickness=0.2)),
        "rough_dielectric": lambda: tts.cornell_box(256, 256, device=dev, tall_box_bsdf=BSDFSpec(
            btype=T.BSDF_GGX_DIELECTRIC, k_s=(0.95, 0.95, 0.95), ior=1.5, roughness_x=0.25,
            roughness_y=0.25)),
        "oren_nayar_forward": lambda: tts.oren_nayar_forward(256, 256, device=dev),
        "area_spot": lambda: tts.spot_light(256, 256, device=dev),
        "furnace": lambda: tts.furnace(256, 256, device=dev),
        "textured_floor": lambda: tts.textured_floor(256, 256, device=dev),
        "kitchen_small": lambda: tts.kitchen_stress(256, 256, grid=2, ns=6, nt=4, device=dev),
    }
    res = {}
    for name, make in variants.items():
        scene, cam, _ = make()
        pack = mk.make_pack(scene, node_fmt="w8")
        perm, _ = mk.tile_swizzle(cam.width, cam.height, dev)
        worst, means_k, means_p = 0.0, [], []
        for i in range(4):
            rng = qmc.make_state("pcg", 0, perm, i)
            o, d, rng = cam_mod.generate_rays(cam, perm, rng)
            L_p = mk.trace_megakernel_reference(pack, md, o, d, rng)
            L_k = mk.trace_megakernel(pack, md, o, d, rng)
            frac, _ = check_contract(f"{name} pass {i}", L_k, L_p)
            worst = max(worst, frac)
            means_k.append(float(L_k.mean()))
            means_p.append(float(L_p.mean()))
        row = {"lanes_differ": worst, "mean_plain": float(np.mean(means_p)),
               "mean_kernel": float(np.mean(means_k))}
        row.update(pack.flags)
        res[name] = row
        log(f"[4] {name} 256x256x4spp: lanes differing (worst pass) {worst:.5f}; means plain "
            f"{row['mean_plain']:.6f} kernel {row['mean_kernel']:.6f}; {pack.flags}")
        if abs(row["mean_kernel"] - row["mean_plain"]) > MEAN_TOL:
            raise SystemExit(f"{name}: 4-spp image means differ by more than {MEAN_TOL}")
    if abs(res["furnace"]["mean_kernel"] - 1.0) > 0.05:
        raise SystemExit("furnace: the kernel's mean is not within 0.05 of 1.0")
    k = res["kitchen_small"]
    if not (k["has_env"] and k["textured"] and k["has_disp"]):
        raise SystemExit("kitchen_small did not set all three K3 flags")
    return res


def phase_kernel_media(mk, tts, dev, MaxDepthParams, T):
    """Phase 4 for kernel K4: vpt packs of the media scenes, every launch of
    the MED instantiation the scene needs."""
    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core import qmc

    md = MaxDepthParams()
    variants = {
        "medium_box": lambda: tts.medium_box(256, 256, device=dev),
        "cornell_vpt": lambda: tts.cornell_vpt(256, 256, device=dev),
        "nested_media": lambda: tts.nested_media(256, 256, device=dev),
        "medium_box_dual_hg": lambda: tts.medium_box(256, 256, phase_type=T.PHASE_DUAL_HG,
                                                     phase_g=(0.7, -0.4), phase_w=0.6,
                                                     device=dev),
        "medium_box_rayleigh": lambda: tts.medium_box(256, 256, phase_type=T.PHASE_RAYLEIGH,
                                                      device=dev),
        "medium_box_env": lambda: tts.medium_box(256, 256, env_scale=0.5, device=dev),
    }
    res = {}
    for name, make in variants.items():
        scene, cam, _ = make()
        pack = mk.make_pack(scene, node_fmt="w8", vpt=True)
        want = ("K3+ALL+MED" if pack.has_env else "ALL+MED") + (
            "+STAGE" if mk.stages(pack) else "")
        perm, _ = mk.tile_swizzle(cam.width, cam.height, dev)
        worst, means_k, means_p = 0.0, [], []
        for i in range(4):
            rng = qmc.make_state("pcg", 0, perm, i)
            o, d, rng = cam_mod.generate_rays(cam, perm, rng)
            L_p = mk.trace_megakernel_reference(pack, md, o, d, rng)
            mk.reset_launches()
            L_k = mk.trace_megakernel(pack, md, o, d, rng)
            if mk.INSTANTIATION_LAUNCHES != {want: 1}:
                raise SystemExit(f"{name}: launched {mk.INSTANTIATION_LAUNCHES}, not {want}")
            frac, _ = check_contract(f"{name} pass {i}", L_k, L_p)
            worst = max(worst, frac)
            means_k.append(float(L_k.mean()))
            means_p.append(float(L_p.mean()))
        row = {"lanes_differ": worst, "mean_plain": float(np.mean(means_p)),
               "mean_kernel": float(np.mean(means_k)), "instantiation": want}
        res[name] = row
        log(f"[4] {name} 256x256x4spp ({want}): lanes differing (worst pass) {worst:.5f}; means "
            f"plain {row['mean_plain']:.6f} kernel {row['mean_kernel']:.6f}")
        if abs(row["mean_kernel"] - row["mean_plain"]) > MEAN_TOL:
            raise SystemExit(f"{name}: 4-spp image means differ by more than {MEAN_TOL}")
    return res


def phase_main(mk, tts, dev, args, MaxDepthParams, RenderingConfig, ParsedScene, Renderer,
               ref_mean):
    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core import qmc

    size, spp = args.size, args.spp
    md = MaxDepthParams()
    scene, cam, _ = tts.cornell_box(size, size)
    parsed = ParsedScene(scene, cam, RenderingConfig(width=size, height=size, md=md, seed=0))
    r = Renderer(parsed, nee_candidates=1)  # device=None -> cuda
    torch.cuda.synchronize()
    mk.reset_launches()
    t0 = time.perf_counter()
    img = r.render(spp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(mk.LAUNCHES)
    inst = dict(mk.INSTANTIATION_LAUNCHES)
    if launches["trace_megakernel"] <= 0:
        raise SystemExit("main path did not launch the megakernel")
    want_inst = "K2+STAGE" if mk.stages(r._pack) else "K2"
    if inst != {want_inst: launches["trace_megakernel"]}:
        raise SystemExit(f"main path launched {inst}, not {want_inst} alone")
    if img.shape != (size, size, 3) or not np.isfinite(img).all():
        raise SystemExit("main path image is not finite / has the wrong shape")
    mean = float(img.mean())
    log(f"[5] Renderer {size}x{size}x{spp}spp: {wall:.2f} s wall, launches {launches} {inst}, "
        f"image mean {mean:.6f} (256x256 plain mean {ref_mean:.6f})")
    if abs(mean - ref_mean) > 0.02 * ref_mean:
        raise SystemExit("main path image mean disagrees with the plain version's")

    # one spp of the main path's rays, timed alone
    pack = r._pack
    perm, _ = mk.tile_swizzle(size, size, r.device)
    rng = qmc.make_state("pcg", 0, perm, 0)
    o, d, rng = cam_mod.generate_rays(r.camera, perm, rng)
    B = o.shape[0]
    rng_bits = mk.rng_bits(rng)  # the kernel's own input format: time the launch alone
    k_ms = events_ms(lambda: mk.trace_megakernel(pack, md, o, d, rng_bits), 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L_p = mk.trace_megakernel_reference(pack, md, o, d, rng)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    L_k, stats = mk.trace_megakernel(pack, md, o, d, rng, count_stats=True)
    torch.cuda.synchronize()
    frac, dmean = check_contract(f"main path {size}x{size} rays", L_k, L_p)
    bound_ms, bound_by, nodes, prims, nbytes = bound_of(stats, B, mk.pack_bytes(pack))
    # the sorted-wavefront driver on the same rays, auto_trace bypassed: the
    # same estimator as the whole-path kernel, lane for lane
    L_s = mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir")
    torch.cuda.synchronize()
    frac_s, dmean_s = check_contract("cornell rays, K5 vs the whole-path kernel", L_s, L_k)
    log(f"[5] K5 (driver, key pos_dir) vs K2 on the same {B} rays: {frac_s:.7f} lanes differ, "
        f"{int((L_s != L_k).any(dim=-1).sum())} not bit-equal, means differ by {dmean_s:.3g}")
    if (L_s != L_k).any():
        raise SystemExit("cornell rays: K5 and the whole-path kernel differ bit for bit")
    # the second lever on its own: the same launch with the tables left in
    # device memory (the plain build), in turns with the STAGE build
    stage_ab = stage_turns(mk, pack, md, o, d, rng_bits, L_k)
    # device launches of one pass (the work counter resets in the kernel:
    # no memset beside the trace launch)
    launches_pass = {"this": device_launches(r.render_raw)}
    ab = None
    if parent_lib() is not None:
        launches_pass["parent"] = with_parent(lambda: device_launches(r.render_raw))
        ab = ab_k2(mk, pack, md, o, d, rng, "5", "K2 cornell (w8, f32 tables)")
    log(f"[5] device launches (kernels and memsets) per Renderer pass: {launches_pass} "
        f"(trace_megakernel {launches['trace_megakernel'] / spp:g} per pass)")
    log(f"[5] kernel {k_ms:.3f} ms/spp, {B / (k_ms * 1e-3):.4g} paths/s; plain version "
        f"{plain_ms:.1f} ms on the same rays ({frac:.7f} lanes differ, means differ by "
        f"{dmean:.3g}); bound {bound_ms:.4f} ms ({bound_by}: {nodes} wide nodes, "
        f"{prims} prim tests, {nbytes} bytes); {bound_ms / k_ms:.4f} of bound")
    return {
        "name": "trace_megakernel", "route": "cuda", "source": "cuda_pt_torch/csrc/megakernel.cu",
        "replaces": "cuda_pt_tpu/ops/pallas/megakernel.py:500",
        "launches": launches["trace_megakernel"], "max_abs_err": float((L_k - L_p).abs().max()),
        "ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "paths_per_s": B / (k_ms * 1e-3), "lanes_differ": frac,
        "mean_differ": dmean,
        "wide_nodes": nodes, "prim_tests": prims, "wall_ms_per_spp": wall * 1e3 / spp,
        "image_mean": mean,
        "k5_vs_k2_lanes_differ": frac_s, "device_launches_per_pass": launches_pass,
        "instantiations": inst, "stage": stage_ab,
        **({"parent": ab, "parent_ms": ab["parent_ms"]} if ab else {}),
    }, r


def slabs_per_node(pack) -> int:
    """Slab tests per counted node: a w8 node's 8 children, a binary node's
    one box."""
    return 8 if pack.node_fmt == "w8" else 1


def node_word(pack) -> str:
    return "wide nodes" if pack.node_fmt == "w8" else "node fetches"


def bound_of(stats, B: int, pack_bytes: int, per_node: int = 8) -> tuple:
    """(bound ms, what bounds it, nodes, prim tests, bytes): rays, pcg
    states and L once plus the pack, against this run's walk work (nodes
    of per_node slab tests each)."""
    nodes = int(stats[:, 0].sum(dtype=torch.int64))
    prims = int(stats[:, 1].sum(dtype=torch.int64))
    nbytes = B * (6 * 4 + 2 * 4 + 3 * 4) + pack_bytes
    return (*bound(nbytes, nodes, prims, per_node), nodes, prims, nbytes)


def bound(nbytes: int, nodes: int, prims: int, per_node: int = 8) -> tuple:
    """(bound ms, what bounds it) of nbytes moved and a walk of nodes
    nodes of per_node slab tests each (8: w8 wide nodes) and prims prim
    tests."""
    ops = nodes * per_node * OPS_SLAB + prims * OPS_TRI
    t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b > t_o else "operations"


def counted(mk, fn) -> tuple:
    """fn() with every launch count set to 0 just before and read just after,
    the card synchronized on both ends: (its result, wall s, launches (the
    LAUNCHES keys that launched), instantiation launches)."""
    torch.cuda.synchronize()
    mk.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, wall, {k: v for k, v in mk.LAUNCHES.items() if v},
            dict(mk.INSTANTIATION_LAUNCHES))


def counted_path(mk, run, cam, label: str, want: dict) -> tuple:
    """run() (a main path: it returns the image), counted; fails unless the
    path launched exactly the kernels (LAUNCHES keys, each > 0) and
    instantiations of want ({"launches": [...], "instantiations": [...]}),
    and the image is finite, cam.height x cam.width x 3. Returns (wall s,
    launches, instantiation launches, image mean)."""
    img, wall, launches, inst = counted(mk, run)
    img = torch.as_tensor(img)
    if sorted(launches) != sorted(want["launches"]) or sorted(inst) != sorted(want["instantiations"]):
        raise SystemExit(f"{label} main path launched {launches} {inst}, not {want}")
    if tuple(img.shape) != (cam.height, cam.width, 3) or not bool(torch.isfinite(img).all()):
        raise SystemExit(f"{label} main path image is not finite / has the wrong shape")
    return wall, launches, inst, float(img.mean())


def render_main_path(mk, r, spp: int, label: str, want: dict) -> tuple:
    """The Renderer's spp passes, counted (counted_path)."""
    return counted_path(mk, lambda: r.render(spp), r.camera, label, want)


def main_rays(mk, r, blk: int):
    """The main path's rays of sample 0 (Z-order lanes) and the blk-lane
    block of them that holds the image centre: (o, d, rng, slice)."""
    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core import qmc

    cam = r.camera
    perm, inv = mk.tile_swizzle(cam.width, cam.height, r.device)
    rng = qmc.make_state("pcg", 0, perm, 0)
    o, d, rng = cam_mod.generate_rays(cam, perm, rng)
    k0 = int(inv[(cam.height // 2) * cam.width + cam.width // 2]) // blk * blk
    return o, d, rng, slice(k0, k0 + blk)


def swf_loop(mk, pack, md, o, d, rng, timing: bool = False, count: bool = False) -> dict:
    """The sorted-wavefront driver's loop (mk.trace_megakernel_swf on the
    kernels, key "pos_dir") run here piece by piece, so that the package
    carries no measurement code. timing: CUDA events around each phase,
    summed per phase into "ms": "seg" (the K5 launches) and "traverse"
    (K6: the walk and the hit resolve), each kernel alone (it starts after
    a device sleep of SETTLE_CYCLES that covers the host's launch latency;
    the sleep belongs to no phase), "sort" (key, argsort, state gather, live count) and
    "glue" (grid passes, texels, the envmap epilogue, the un-permute),
    each from its first to its last operation, gaps while the device waits
    for the host included. count: the walk work of K5 and K6 per slot
    ("stats", "stats_t") and, per launch, the lanes whose envmap miss
    record K5 wrote ("misses") and K6's lanes with a hit ("hits"). Returns
    those, L and the live lanes of each launch."""
    dev = o.device
    B = o.shape[0]
    ms, open_ = {}, [None]

    def mark(name, settle: bool = False):
        if not timing:
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        if open_[0] is not None:
            ms.setdefault(open_[0][0], []).append((open_[0][1], ev))
        if settle:
            torch.cuda._sleep(SETTLE_CYCLES)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        open_[0] = (name, ev) if name else None

    stats = torch.zeros((B, 2), dtype=torch.int32, device=dev) if count else None
    stats_t = torch.zeros((B, 2), dtype=torch.int32, device=dev) if count else None
    env = mk.seg_layout(pack).env
    st = mk.seg_init(pack, o, d, rng)
    pix = torch.arange(B, device=dev)
    lanes, misses, hits = [], [], []
    for bounce in range(md.max_depth):
        mark("sort")
        st, pix, n = mk.swf_sort(st, pix, "pos_dir")
        if n == 0:
            break
        lanes.append(n)
        hit = flight = None
        if pack.has_grid:
            mark("traverse", settle=True)
            hit = mk.traverse_resolve(pack, st, n, stats=stats_t)
            mark("glue")
            if count:
                hits.append(int((hit[1] > 0.5).sum()))
            flight = mk.grid_flight(pack, st, n, hit[0]).contiguous()
        env0 = st[env:env + 6, :n].clone() if count and env >= 0 else None
        mark("seg", settle=True)
        mk.trace_megakernel_seg(pack, md, st, n, bounce, 1, hit, flight, stats)
        mark("glue")
        if env0 is not None:
            misses.append(int((st[env:env + 6, :n] != env0).any(dim=0).sum()))
        mk.swf_resolve(pack, st, n)
    mark("glue")
    L = mk.swf_result(pack, st, pix)
    mark(None)
    torch.cuda.synchronize()
    return {"L": L, "live_lanes": lanes, "misses": misses, "hits": hits, "stats": stats,
            "stats_t": stats_t,
            "ms": {k: sum(a.elapsed_time(b) for a, b in v) for k, v in ms.items()}}


def k6_bytes(mk, pack, lanes: list, hits: list) -> tuple:
    """(bytes, per live lane, per hit lane) that K6 moves over the launches
    of a driver run: per live lane the state planes it reads (act, o, d)
    and the hit planes it writes; per hit lane the g_hit columns the
    resolve reads (the normals, the geometric normal, eid, bid, inv_area,
    the sphere's centre and flag unless tri_only, the uvs if textured, the
    medium planes with media); a miss reads row 0, counted once, as are
    the nodes and prims."""
    cols = 9 + 3 + 3 + (0 if pack.tri_only else 4) + (6 if pack.textured else 0) \
        + (2 if pack.has_media else 0)
    per_lane = 7 * 4 + mk.hit_planes(pack) * 4
    nbytes = sum(lanes) * per_lane + sum(hits) * cols * 4 + 32 * 4 \
        + mk.pack_bytes(pack, ("nodes", "prims"))
    return nbytes, per_lane, cols * 4


def k5_bytes(pack, lanes: list, misses: list) -> tuple:
    """(bytes, reads per lane, writes per lane) that K5 moves over the
    launches of a driver run, as csrc/seg.cuh reads and writes the planes:
    each launched lane (all live: the driver launches the live prefix)
    reads planes 0-20, the medium stack (MED) and, in the SHADE form, the
    hit planes it uses and the flight planes; it writes planes 0-20, the
    medium stack, the texture record (textured) and the grid NEE record
    (GRID); the envmap miss record only on a miss (misses: lanes per
    launch). The pack counts once per run in the caller."""
    med = 5 if pack.has_media else 0
    shade = 0
    if pack.has_grid:
        shade = (10 + (0 if pack.tri_only else 1) + 1 + (2 if pack.textured else 0) + 1) + 5
    reads = (21 + med + shade) * 4
    writes = (21 + med + (6 if pack.textured else 0) + (9 if pack.has_grid else 0)) * 4
    return sum(lanes) * (reads + writes) + sum(misses) * 24, reads, writes


def ab_k5(mk, pack, md, o, d, rng, L, phase: str, label: str) -> dict:
    """The parent tree's K5 (parent_lib) on the same rays as this build's,
    in turns (parent, this, this, parent) after an untimed run of the
    parent's (its first launches load its kernels): the mean ms per spp of
    each (swf_loop's "seg") and the lanes whose L differs from this
    build's L, bit for bit."""
    from cuda_pt_torch.ops import cuda_build as cb

    path = parent_lib()

    def parent_run(**kw):
        prev = cb.use_library(path)
        try:
            return swf_loop(mk, pack, md, o, d, rng, **kw)
        finally:
            cb.use_library(prev)

    parent_run()
    ms = {"parent": [], "this": []}
    differ = 0
    for who in ("parent", "this", "this", "parent"):
        if who == "this":
            run = swf_loop(mk, pack, md, o, d, rng, timing=True)
        else:
            run = parent_run(timing=True)
            differ = max(differ, int((run["L"] != L).any(dim=-1).sum()))
        ms[who].append(run["ms"]["seg"])
    row = {"parent_ms": float(np.mean(ms["parent"])), "this_ms": float(np.mean(ms["this"])),
           "runs_ms": ms, "lanes_differ": differ}
    log(f"[{phase}] K5 {label}: the parent {row['parent_ms']:.3f} ms against this tree's "
        f"{row['this_ms']:.3f} ms per spp, in turns on the same rays (this / parent "
        f"{row['this_ms'] / row['parent_ms']:.4f}; runs {ms}); lanes whose L differs from "
        f"this tree's: {differ}")
    return row


def with_parent(fn):
    """fn() with the wrappers launching the parent tree's library."""
    from cuda_pt_torch.ops import cuda_build as cb

    prev = cb.use_library(parent_lib())
    try:
        return fn()
    finally:
        cb.use_library(prev)


def bit_lanes(a: torch.Tensor, b: torch.Tensor) -> int:
    """Lanes (rows) of two same-shaped outputs that differ in any bit."""
    a = a.view(torch.int32) if a.dtype == torch.float32 else a
    b = b.view(torch.int32) if b.dtype == torch.float32 else b
    return int((a != b).reshape(a.shape[0], -1).any(dim=1).sum())


def in_turns(run, phase: str, label: str, unit: str = "ms per launch") -> dict:
    """run() (-> device ms) on the parent tree's library and on this one's in
    turns (parent, this, this, parent): the mean of each and the runs."""
    ms = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        ms[who].append(with_parent(run) if who == "parent" else run())
    row = {"parent_ms": float(np.mean(ms["parent"])), "this_ms": float(np.mean(ms["this"])),
           "runs_ms": ms}
    log(f"[{phase}] {label}: the parent {row['parent_ms']:.4f} against this tree's "
        f"{row['this_ms']:.4f} {unit}, in turns on the same inputs (this / parent "
        f"{row['this_ms'] / row['parent_ms']:.4f}; runs {ms})")
    return row


def ab_k2(mk, pack, md, o, d, rng, phase: str, label: str) -> dict:
    """The parent tree's whole-path kernel (parent_lib: one thread per path)
    against this tree's persistent grid on the same rays: the lanes whose L
    or walk work (count_stats) differ bit for bit (must be 0), then the ms
    per launch in turns (events_ms, 5 launches a turn)."""
    rng_bits = mk.rng_bits(rng)

    def outs():
        out = mk.trace_megakernel(pack, md, o, d, rng_bits, count_stats=True)
        torch.cuda.synchronize()
        return out

    L_t, st_t = outs()
    L_p, st_p = with_parent(outs)
    differ = bit_lanes(L_t, L_p)
    stats_differ = bit_lanes(st_t, st_p)
    row = in_turns(lambda: events_ms(lambda: mk.trace_megakernel(pack, md, o, d, rng_bits), 5),
                   phase, f"{label}, {o.shape[0]} paths")
    row.update({"lanes_differ": differ, "stats_lanes_differ": stats_differ})
    log(f"[{phase}] {label}: lanes whose L differs from the parent's bit for bit: {differ}; "
        f"whose walk work differs: {stats_differ}")
    if differ or stats_differ:
        raise SystemExit(f"{label}: the persistent grid's output differs from the parent's")
    return row


@contextlib.contextmanager
def no_stage(mk):
    """The whole-path kernel's plain build on any pack while the block runs:
    the table sizes its STAGE rule reads (ops/megakernel._tables, the last
    len(STAGE_KEYS) entries) are withheld."""
    real = mk._tables

    def unsized(pack):
        t = real(pack)
        for k in range(len(t) - len(mk.STAGE_KEYS), len(t)):
            t[k] = 0
        return t

    mk._tables = unsized
    try:
        yield
    finally:
        mk._tables = real


def stage_turns(mk, pack, md, o, d, rng_bits, L) -> dict:
    """The STAGE build (the pack's tables in shared memory) against the
    plain build on the same rays, in turns (stage, plain, plain, stage;
    events_ms, 10 launches a turn): ms of each, and the lanes whose L
    differs bit for bit (must be 0)."""
    def run():
        return mk.trace_megakernel(pack, md, o, d, rng_bits)

    with no_stage(mk):
        differ = bit_lanes(run(), L)
    ms = {"stage": [], "plain": []}
    for who in ("stage", "plain", "plain", "stage"):
        if who == "plain":
            with no_stage(mk):
                ms[who].append(events_ms(run, 10))
        else:
            ms[who].append(events_ms(run, 10))
    row = {"stage_ms": float(np.mean(ms["stage"])), "plain_ms": float(np.mean(ms["plain"])),
           "runs_ms": ms, "lanes_differ": differ, "staged": mk.stages(pack),
           "stage_bytes": sum(pack[k].numel() * pack[k].element_size() for k in mk.STAGE_KEYS)}
    log(f"[5] K2's tables in shared memory ({row['stage_bytes']} bytes, staged: {row['staged']}) "
        f"{row['stage_ms']:.4f} ms against {row['plain_ms']:.4f} ms left in device memory, in "
        f"turns (runs {ms}); lanes whose L differs: {differ}")
    if differ:
        raise SystemExit("K2: the STAGE build's L differs from the plain build's")
    return row


def ab_k1(tk, forest, o, d, t_far, phase: str, label: str) -> dict:
    """The parent tree's K1 (one thread per ray) against this tree's
    persistent grid on the same rays, closest and any hit: the rays whose
    t, prim, b1, b2 or occlusion differ bit for bit (must be 0), then the ms
    per launch of each in turns (events_ms, 10 launches a turn)."""
    def outs():
        k = tk.traverse_forest(forest, o, d)
        occ = tk.traverse_forest(forest, o, d, t_far, occlusion=True)["occluded"]
        torch.cuda.synchronize()
        return torch.stack([k["t"].view(torch.int32), k["prim"].int(), k["b1"].view(torch.int32),
                            k["b2"].view(torch.int32), occ.int()], 1)

    differ = bit_lanes(outs(), with_parent(outs))
    row = {"closest": in_turns(lambda: events_ms(lambda: tk.traverse_forest(forest, o, d), 10),
                               phase, f"K1 closest, {label}"),
           "anyhit": in_turns(lambda: events_ms(lambda: tk.traverse_forest(
               forest, o, d, t_far, occlusion=True), 10), phase, f"K1 any hit, {label}"),
           "rays_differ": differ}
    log(f"[{phase}] K1 {label}: rays whose hit or occlusion differs from the parent's bit for "
        f"bit: {differ}")
    if differ:
        raise SystemExit(f"K1 {label}: the persistent grid's hits differ from the parent's")
    return row


def replay_k1(tk, calls: list) -> float:
    """Summed device ms of recorded K1 calls (k1_calls' "args"), each
    launched after a device sleep that covers the host's launch latency."""
    evs = []
    for forest, o, d, t_far, occlusion, max_leaf in (c["args"] for c in calls):
        torch.cuda._sleep(SETTLE_CYCLES)
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        tk.traverse_forest(forest, o, d, t_far, max_leaf, occlusion)
        ev[1].record()
        evs.append(ev)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs)


def ab_k1_calls(tk, calls: list, phase: str, label: str) -> dict:
    """The recorded K1 calls of a main-path pass (k1_calls with record) on
    the parent tree's K1 and on this tree's: the rays whose outputs differ
    bit for bit (must be 0), then the summed ms in turns (replay_k1)."""
    def outs():
        res = []
        for forest, o, d, t_far, occlusion, max_leaf in (c["args"] for c in calls):
            r = tk.traverse_forest(forest, o, d, t_far, max_leaf, occlusion)
            res.append(r["occluded"][:, None].int() if occlusion else torch.stack(
                [r["t"].view(torch.int32), r["prim"].int(), r["b1"].view(torch.int32),
                 r["b2"].view(torch.int32)], 1))
        torch.cuda.synchronize()
        return res

    differ = sum(bit_lanes(a, b) for a, b in zip(outs(), with_parent(outs)))
    row = in_turns(lambda: replay_k1(tk, calls), phase, f"K1 {label}, {len(calls)} calls",
                   "ms summed")
    row["rays_differ"] = differ
    log(f"[{phase}] K1 {label}: rays whose outputs differ from the parent's bit for bit: "
        f"{differ}")
    if differ:
        raise SystemExit(f"K1 {label}: the persistent grid's outputs differ from the parent's")
    return row


def warp_figures(stats: torch.Tensor) -> dict:
    """Per 32-lane group of a launch (in launch order) of its stats plane's
    node fetches per lane: the group's largest and mean summed over groups,
    their ratio (the lane use of a warp that waits for its longest walk)
    and the group count."""
    f = stats[:, 0].double()
    pad = (-f.numel()) % 32
    g = torch.cat([f, f.new_zeros(pad)]).view(-1, 32)
    n = torch.cat([torch.ones_like(f), f.new_zeros(pad)]).view(-1, 32).sum(1)
    mx, mean = float(g.max(1).values.sum()), float((g.sum(1) / n).sum())
    return {"warp_max_sum": mx, "warp_mean_sum": mean, "warps": g.shape[0],
            "warp_max": mx / g.shape[0], "warp_mean": mean / g.shape[0], "lane_use": mean / mx}


def log_warp_figures(phase: str, label: str, figs: dict) -> None:
    log(f"[{phase}] {label}, node fetches per lane over {figs['warps']} 32-lane groups: "
        f"largest {figs['warp_max']:.3f}, mean {figs['warp_mean']:.3f} on average; lane use "
        f"{figs['lane_use']:.4f}")


def device_launches(run) -> int:
    """Device-side launches (kernels and memsets) of one run(), counted by
    torch.profiler (CUPTI), after one warm-up profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):  # the first profile pays CUPTI's start-up; keep the second
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


@contextlib.contextmanager
def aten_ops():
    """Counts the PyTorch (aten) operators dispatched in the block, in
    ["n"]: each launches at most a few device kernels, and the count costs
    microseconds per operator where the profiler's costs far more."""
    from torch.utils._python_dispatch import TorchDispatchMode

    box = {"n": 0}

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            box["n"] += 1
            return func(*args, **(kwargs or {}))

    with _Count():
        yield box


def hold_swf(mk, r, md, blk: int, phase: str, label: str, ab: bool = False) -> dict:
    """Kernel K5 (and K6 in the split form) under the sorted-wavefront
    driver on one spp of the main path's rays: a blk-lane block of the
    output held to the phase-4 contract against the driver on the plain
    versions on the same lanes; the driver's loop run here (swf_loop) held
    bit for bit to the driver's output; per spp (three runs) K5's summed
    kernel time, K6's, the sort-and-gather glue, the other glue, the wall
    of an untimed driver run and the launches; the walk work and the
    bound: the pack once plus what K5 moves (k5_bytes); with ab and
    --parent, the parent tree's K5 on the same rays (ab_k5)."""
    pack = r._pack
    o, d, rng, blk_sl = main_rays(mk, r, blk)
    B = o.shape[0]
    ob, db, rb = (x[blk_sl].contiguous() for x in (o, d, rng))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L_p = mk.trace_megakernel_swf_reference(pack, md, ob, db, rb, key_mode="pos_dir")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    L_k = mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir")
    torch.cuda.synchronize()
    if not torch.isfinite(L_k).all():
        raise SystemExit(f"{label} main path rays: non-finite K5 output")
    L_kb = L_k[blk_sl]
    frac, dmean = check_contract(f"{label} K5 on {B} rays, block of {blk}", L_kb, L_p)
    cnt = swf_loop(mk, pack, md, o, d, rng, count=True)
    if not torch.equal(cnt["L"], L_k):
        raise SystemExit(f"{label}: the measured loop is not the driver (its L differs)")
    runs = []
    for _ in range(3):
        tm = swf_loop(mk, pack, md, o, d, rng, timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir")
        torch.cuda.synchronize()
        runs.append({"wall_ms": (time.perf_counter() - t0) * 1e3, **tm["ms"]})
    lanes, misses = cnt["live_lanes"], cnt["misses"]
    state_bytes, reads, writes = k5_bytes(pack, lanes, misses)
    nbytes = mk.pack_bytes(pack) + state_bytes
    nodes = int(cnt["stats"][:, 0].sum(dtype=torch.int64))
    prims = int(cnt["stats"][:, 1].sum(dtype=torch.int64))
    bound_ms, bound_by = bound(nbytes, nodes, prims, slabs_per_node(pack))
    mean = {k: float(np.mean([run[k] for run in runs])) for k in runs[0]}
    seg_ms = mean["seg"]
    split = pack.has_grid
    log(f"[{phase}] K5 {label}: {frac:.7f} of the block's {blk} lanes differ from the plain "
        f"driver ({plain_ms:.1f} ms on the block), means differ by {dmean:.3g}; per spp (mean of "
        f"3): K5 {seg_ms:.3f} ms over {len(lanes)} launches (live lanes {lanes}), sort+gather "
        f"{mean['sort']:.3f} ms, other glue {mean['glue']:.3f} ms"
        + (f", K6 {mean['traverse']:.3f} ms" if split else "")
        + f", wall {mean['wall_ms']:.3f} ms; per live lane per launch {reads} B read, {writes} B "
        f"written (+24 B on a miss: {sum(misses)} misses); bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nodes} {node_word(pack)}, {prims} prim tests, {nbytes} bytes of which {state_bytes} "
        f"state); {bound_ms / seg_ms:.4f} of bound; pack formats {pack_formats(pack)}")
    out = {"max_abs_err": float((L_kb - L_p).abs().max()), "ms": seg_ms, "plain_ms": plain_ms,
           "plain_lanes": blk, "bound_ms": bound_ms, "bound_by": bound_by,
           "lanes_differ": frac, "mean_differ": dmean, "wide_nodes": nodes, "prim_tests": prims,
           "state_read_bytes_per_lane_launch": reads, "state_write_bytes_per_lane_launch": writes,
           "env_misses": sum(misses), "state_bytes": state_bytes,
           "launches_per_spp": len(lanes), "live_lanes": lanes, "sort_gather_ms": mean["sort"],
           "glue_ms": mean["glue"], "swf_wall_ms": mean["wall_ms"], "runs": runs, "L": L_k,
           **pack_formats(pack)}
    if ab and parent_lib() is not None:
        out["parent"] = ab_k5(mk, pack, md, o, d, rng, L_k, phase, label)
        out["parent_ms"] = out["parent"]["parent_ms"]
    if split:
        t_nodes = int(cnt["stats_t"][:, 0].sum(dtype=torch.int64))
        t_prims = int(cnt["stats_t"][:, 1].sum(dtype=torch.int64))
        t_bytes, t_per_lane, t_per_hit = k6_bytes(mk, pack, lanes, cnt["hits"])
        t_bound, t_by = bound(t_bytes, t_nodes, t_prims)
        out["k6"] = {"ms": mean["traverse"], "bound_ms": t_bound, "bound_by": t_by,
                     "wide_nodes": t_nodes, "prim_tests": t_prims, "bytes": t_bytes,
                     "bytes_per_lane": t_per_lane, "g_hit_bytes_per_hit": t_per_hit,
                     "hit_lanes": sum(cnt["hits"]), "staged": mk.k6_stages(pack)}
        log(f"[{phase}] K6 {label} (walk + hit resolve; nodes, prims and g_hit staged: "
            f"{mk.k6_stages(pack)}): "
            f"{mean['traverse']:.3f} ms per spp, bound {t_bound:.4f} ms ({t_by}: {t_nodes} wide "
            f"nodes, {t_prims} prim tests, {t_bytes} bytes: {t_per_lane} B per live lane, "
            f"{t_per_hit} B of g_hit per hit lane over {sum(cnt['hits'])} hits); "
            f"{t_bound / max(mean['traverse'], 1e-9):.4f} of bound")
    return out


def phase_kitchen(mk, dev, args, scene, cam, build_s, MaxDepthParams, RenderingConfig,
                  ParsedScene, Renderer):
    """The surface main path at scale: the Renderer on full-size
    kitchen_stress through the sorted-wavefront driver (K5), and K3 (the
    whole-path kernel, called directly) on the same rays."""
    spp = args.kitchen_spp
    md = MaxDepthParams()
    parsed = ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height, md=md,
                                                     seed=0))
    r = Renderer(parsed, nee_candidates=1)  # device=None -> cuda
    info = r.info()
    if not (info["has_env"] and info["textured"] and info["has_disp"]) or info["driver"] != "swf":
        raise SystemExit(f"kitchen_stress: not the K3 flags or not the swf driver: {info}")
    wall, launches, inst, mean = render_main_path(
        mk, r, spp, "kitchen", {"launches": ["trace_megakernel_seg"],
                                "instantiations": ["SEG+K3+ALL+CPT"]})
    log(f"[6] Renderer kitchen_stress {cam.width}x{cam.height}x{spp}spp ({mk.pack_boxes(r._pack)} "
        f"boxes: driver {info['driver']}): {wall:.2f} s wall ({wall * 1e3 / spp:.2f} ms per spp), "
        f"launches {launches} {inst}, image mean {mean:.6f}, flags {r._pack.flags}, pack "
        f"{pack_formats(r._pack)} (f32 size {mk.fused_pack_bytes(r.scene)} B, the format rule's "
        f"threshold {mk.AUTO_COMPACT_BYTES} B)")
    want = ("w8", "t9", "bf16")
    if (r._pack.node_fmt, r._pack.prim_fmt, r._pack.attr_fmt) != want:
        raise SystemExit(f"kitchen: the Renderer's pack is not in the reference's formats {want}")
    k5 = hold_swf(mk, r, md, BLOCK, "6", "kitchen", ab=True)
    k3 = hold_main_path(mk, r, md, BLOCK, "6", "kitchen",
                        f"incl. {mk.pack_bytes(r._pack, mk.K3_KEYS)} of uvs, texels and K3 tables",
                        ab=True)
    dmean = abs(float(k5.pop("L").mean()) - float(k3.pop("L").mean()))
    log(f"[6] kitchen, one spp: K5 {k5['ms']:.3f} ms (driver wall {k5['swf_wall_ms']:.3f} ms) "
        f"against the whole-path kernel's {k3['ms']:.3f} ms on the same rays; image means "
        f"differ by {dmean:.3g} (inline against deferred texturing: the same estimator in the "
        f"mean only)")
    if dmean > MEAN_TOL:
        raise SystemExit("kitchen: K5 and the whole-path kernel disagree in the mean")
    k5["f32"] = f32_pass(mk, r, md, "6", "kitchen")
    k3["f32_ms"] = k5["f32"]["whole_path_ms"]
    k5.update({"wall_ms_per_spp": wall * 1e3 / spp, "launches": launches["trace_megakernel_seg"],
               "instantiations": inst, "whole_path_ms": k3["ms"], "mean_vs_whole_path": dmean,
               "image_mean": mean})
    return k5, {
        "name": "trace_megakernel (K3: has_env, textured, has_disp; the CPT build: t9 prims, "
                "bf16 attrs; f32_ms: the f32 build of megakernel.cu)", "route": "cuda",
        "source": "cuda_pt_torch/csrc/megakernel_cpt.cu",
        "replaces": "cuda_pt_tpu/ops/pallas/megakernel.py:1445",
        "launches": 0, **k3, "library_ms": None, "bvh_build_s": build_s,
        "num_prims": scene.geom.num_prims,
        "note": "off the main path since K5 takes scenes of 512 boxes or more; called directly",
    }, r


def hold_main_path(mk, r, md, blk: int, phase: str, label: str, bytes_note: str = "",
                   ab: bool = False) -> dict:
    """The main path's rays of sample 0 through the kernel at the full grid;
    one blk-lane Z-order block of its output (the one holding the image
    centre) held to the phase-4 contract against the plain version on the
    same lanes (lanes are independent); the kernel's time per spp (CUDA
    events) and on the block alone; its walk work and bound; with ab and
    --parent, the parent tree's kernel on the same rays (ab_k2)."""
    pack = r._pack
    o, d, rng, blk_sl = main_rays(mk, r, blk)
    B = o.shape[0]
    ob, db, rb = (x[blk_sl].contiguous() for x in (o, d, rng))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L_p = mk.trace_megakernel_reference(pack, md, ob, db, rb)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    L_k = mk.trace_megakernel(pack, md, o, d, rng)
    torch.cuda.synchronize()
    if not torch.isfinite(L_k).all():
        raise SystemExit(f"{label} main path rays: non-finite kernel output")
    L_kb = L_k[blk_sl]
    frac, dmean = check_contract(f"{label} main path {B} rays, block of {blk}", L_kb, L_p)
    block_ms = events_ms(lambda: mk.trace_megakernel(pack, md, ob, db, mk.rng_bits(rb)), 5)

    rng_bits = mk.rng_bits(rng)
    k_ms = events_ms(lambda: mk.trace_megakernel(pack, md, o, d, rng_bits), 5)
    _, stats = mk.trace_megakernel(pack, md, o, d, rng, count_stats=True)
    torch.cuda.synchronize()
    bound_ms, bound_by, nodes, prims, nbytes = bound_of(stats, B, mk.pack_bytes(pack),
                                                        slabs_per_node(pack))
    log(f"[{phase}] kernel {k_ms:.3f} ms/spp, {B / (k_ms * 1e-3):.4g} paths/s; block of {blk} "
        f"lanes of the {B}-ray launch vs the plain version ({plain_ms:.1f} ms on the block): "
        f"{frac:.7f} lanes differ, means differ by {dmean:.3g}; the kernel launched on the "
        f"block alone {block_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}: {nodes} "
        f"{node_word(pack)}, {prims} prim tests, {nbytes} bytes {bytes_note}); "
        f"{bound_ms / k_ms:.4f} of bound; pack formats {pack_formats(pack)}")
    out = {"L": L_k, "max_abs_err": float((L_kb - L_p).abs().max()), "ms": k_ms,
           "plain_ms": plain_ms,
           "plain_lanes": blk, "block_kernel_ms": block_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "paths_per_s": B / (k_ms * 1e-3), "lanes_differ": frac,
           "mean_differ": dmean, "wide_nodes": nodes, "prim_tests": prims,
           **pack_formats(pack)}
    if ab and parent_lib() is not None:
        out["parent"] = ab_k2(mk, pack, md, o, d, rng, phase, label)
        out["parent_ms"] = out["parent"]["parent_ms"]
    return out


def pack_formats(pack) -> dict:
    """The pack's table formats and its bytes (the tables the kernels read)."""
    from cuda_pt_torch.ops import megakernel as mk

    return {"node_fmt": pack.node_fmt, "prim_fmt": pack.prim_fmt, "attr_fmt": pack.attr_fmt,
            "pack_bytes": mk.pack_bytes(pack)}


def f32_pass(mk, r, md, phase: str, label: str) -> dict:
    """The Renderer's scene packed with f32 attrs and prims (w8 nodes, as the
    Renderer packs below the format rule's threshold), on the main path's
    rays of sample 0: K5's time per spp (swf_loop, mean of 3 runs), the
    whole-path kernel's (CUDA events), and the gap of K5's image mean to
    that of the Renderer's pack (bf16 attrs, t9 prims) on the same rays."""
    pack = r._pack
    pf = mk.make_pack(r.scene, node_fmt="w8", attr_fmt="f32", prim_fmt="f32",
                      vpt=pack.has_media)
    o, d, rng, _ = main_rays(mk, r, BLOCK)
    runs = [swf_loop(mk, pf, md, o, d, rng, timing=True) for _ in range(3)]
    seg_ms = float(np.mean([run["ms"]["seg"] for run in runs]))
    L_b = mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir")
    gap = abs(float(runs[0]["L"].mean()) - float(L_b.mean()))
    rng_bits = mk.rng_bits(rng)
    wp_ms = events_ms(lambda: mk.trace_megakernel(pf, md, o, d, rng_bits), 5)
    bin_bytes = mk.pack_bytes(mk.make_pack(r.scene, vpt=pack.has_media))
    log(f"[{phase}] {label}, f32 attrs and prims ({mk.pack_bytes(pf)} bytes against "
        f"{mk.pack_bytes(pack)} in {pack.attr_fmt} attrs, {pack.prim_fmt} prims; "
        f"make_pack(scene), binary nodes: {bin_bytes}): K5 "
        f"{seg_ms:.3f} ms per spp, the whole-path kernel {wp_ms:.3f} ms; image means (K5, one "
        f"spp) f32 {float(runs[0]['L'].mean()):.6f}, {pack.attr_fmt} attrs "
        f"{float(L_b.mean()):.6f}: gap {gap:.3g}")
    if gap > MEAN_TOL:
        raise SystemExit(f"{label}: f32 and {pack.attr_fmt} attrs disagree in the mean by {gap}")
    return {"k5_ms": seg_ms, "whole_path_ms": wp_ms, "mean_gap_vs_compact": gap,
            "pack_bytes": mk.pack_bytes(pf), "binary_pack_bytes": bin_bytes}


def phase_vpt(mk, tts, dev, MaxDepthParams, RendererType, RenderingConfig, ParsedScene,
              Renderer):
    """The volume path tracer's main path: the Renderer on full-size
    medium_cbox through the driver (K5), held to its plain version and to
    K4 (the whole-path kernel, called directly) lane for lane; K4 held to
    its plain version."""
    t0 = time.perf_counter()
    scene, cam, _ = tts.medium_cbox(1024, 1024, device=dev)
    build_s = time.perf_counter() - t0
    spp = VPT_SPP
    md = MaxDepthParams()
    parsed = ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height, md=md,
                                                     seed=0))
    r = Renderer(parsed, renderer=RendererType.VOLUME_PT, nee_candidates=1)  # device=None -> cuda
    info = r.info()
    if not info["has_media"] or info["driver"] != "swf":
        raise SystemExit(f"medium_cbox: no media in the pack or not the swf driver: {info}")
    want = ("w8", "t9", "bf16")
    if (r._pack.node_fmt, r._pack.prim_fmt, r._pack.attr_fmt) != want:
        raise SystemExit(f"medium_cbox: the Renderer's pack is not in the reference's formats "
                         f"{want}")
    wall, launches, inst, mean = render_main_path(
        mk, r, spp, "VPT", {"launches": ["trace_megakernel_seg"],
                            "instantiations": ["SEG+ALL+MED+CPT"]})
    log(f"[7] medium_cbox ({scene.geom.num_prims} triangles, BVH built in {build_s:.1f} s; "
        f"{r._pack['nodes'].shape[0]} wide nodes, walk stack {r._pack.max_stack}, max leaf "
        f"{r._pack.max_leaf}): Renderer VOLUME_PT {cam.width}x{cam.height}x{spp}spp: "
        f"{wall:.2f} s wall ({wall * 1e3 / spp:.2f} ms per spp), launches {launches} {inst} "
        f"({launches['trace_megakernel_seg'] / spp:g} per spp), image mean {mean:.6f}, pack "
        f"{pack_formats(r._pack)} (f32 size {mk.fused_pack_bytes(r.scene)} B)")
    k5 = hold_swf(mk, r, md, BLOCK, "7", "medium_cbox", ab=True)
    k4 = hold_main_path(mk, r, md, BLOCK, "7", "VPT",
                        f"incl. {mk.pack_bytes(r._pack, mk.MED_KEYS)} of the media row; the "
                        f"walk work incl. the transmittance walks", ab=True)
    L_w, L_s = k4.pop("L"), k5.pop("L")
    frac_w, dmean_w = check_contract("medium_cbox, K5 vs the whole-path kernel K4", L_s, L_w)
    log(f"[7] medium_cbox, one spp: K5 {k5['ms']:.3f} ms (driver wall {k5['swf_wall_ms']:.3f} ms) "
        f"against K4's {k4['ms']:.3f} ms on the same rays; per lane {frac_w:.7f} differ, "
        f"{int((L_s != L_w).any(dim=-1).sum())} not bit-equal, means differ by {dmean_w:.3g}")
    k5.update({"wall_ms_per_spp": wall * 1e3 / spp, "launches": launches["trace_megakernel_seg"],
               "instantiations": inst, "whole_path_ms": k4["ms"],
               "lanes_differ_vs_whole_path": frac_w, "f32": f32_pass(mk, r, md, "7", "medium_cbox")})
    k4["f32_ms"] = k5["f32"]["whole_path_ms"]
    return k5, {
        "name": "trace_megakernel (K4: has_media; the CPT build: t9 prims, bf16 attrs; f32_ms: "
                "the f32 build of megakernel_med.cu)", "route": "cuda",
        "source": "cuda_pt_torch/csrc/megakernel_cpt.cu",
        "replaces": "cuda_pt_tpu/ops/pallas/megakernel.py:1386",
        "launches": 0, **k4, "library_ms": None, "bvh_build_s": build_s,
        "num_prims": scene.geom.num_prims,
        "note": "off the main path since K5 takes scenes of 512 boxes or more; called directly",
    }, r


def phase_grid(mk, tts, dev, MaxDepthParams, RendererType, RenderingConfig, ParsedScene,
               Renderer):
    """Grid media: the Renderer on grid_smoke (a 256^3 density grid) through
    the split driver, K6 and K5's shade phase, held to the plain versions."""
    t0 = time.perf_counter()
    scene, cam, _ = tts.grid_smoke(1024, 1024, n=GRID_N, device=dev)
    build_s = time.perf_counter() - t0
    md = MaxDepthParams()
    parsed = ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height, md=md,
                                                     seed=0))
    r = Renderer(parsed, renderer=RendererType.VOLUME_PT, nee_candidates=1)  # device=None -> cuda
    info = r.info()
    if info["driver"] != "swf_split" or not info["has_grid"]:
        raise SystemExit(f"grid_smoke: not the split driver: {info}")
    wall, launches, inst, mean = render_main_path(
        mk, r, GRID_SPP, "grid", {"launches": ["trace_megakernel_seg", "traverse_resolve"],
                                  "instantiations": ["SEG+SHADE+ALL+MED+GRID"]})
    grid_mib = r._pack["gr_density"].numel() * 4 / 2 ** 20
    log(f"[8] grid_smoke (a {GRID_N}^3 density grid, {grid_mib:.0f} MiB; scene built in "
        f"{build_s:.1f} s): Renderer VOLUME_PT {cam.width}x{cam.height}x{GRID_SPP}spp: "
        f"{wall:.2f} s wall ({wall * 1e3 / GRID_SPP:.2f} ms per spp), launches {launches} {inst}, "
        f"image mean {mean:.6f}")
    pack = r._pack
    o, d, rng, _ = main_rays(mk, r, BLOCK)
    o, d = o.contiguous(), d.contiguous()
    B = o.shape[0]
    k6_check = check_k6(mk, pack, k6_state(mk, pack, o, d), B, "grid_smoke camera rays")
    o_b, d_b = o[:BLOCK].contiguous(), d[:BLOCK].contiguous()
    st = k6_state(mk, pack, o_b, d_b)
    k6_block_check = check_k6(mk, pack, st, BLOCK, "grid_smoke camera rays, the first block")
    k5 = hold_swf(mk, r, md, BLOCK, "8", "grid_smoke")
    L = k5.pop("L")
    k6 = k5.pop("k6")
    ab = ab_k6(mk, pack, md, o, d, rng, L)
    _, k6_plain = host_ms(lambda: mk.resolve_hit(pack, mk.traverse_plain(pack, st, BLOCK)))
    k6_block = events_ms(lambda: mk.traverse_resolve(pack, st, BLOCK), 10)
    k5.update({"wall_ms_per_spp": wall * 1e3 / GRID_SPP,
               "launches": launches["trace_megakernel_seg"], "instantiations": inst})
    k6.update({"launches": launches["traverse_resolve"], "plain_ms": k6_plain,
               "plain_lanes": BLOCK, "block_kernel_ms": k6_block, "walk_check": k6_check,
               "block_check": k6_block_check,
               "max_abs_err": max(k6_check["max_abs_err_t"], k6_check["planes_max_abs_err"]),
               "ab": ab, **({"parent_ms": ab["parent"]["parent_ms"]} if "parent" in ab else {})})
    log(f"[8] K6 on the {BLOCK}-lane block: kernel {k6_block:.4f} ms, plain walk and "
        f"resolve_hit {k6_plain:.1f} ms")
    return k5, k6


def split_states(mk, pack, md, o, d, rng) -> list:
    """The split driver's loop on the kernels (key "pos_dir"): each bounce's
    live state planes (n_state, n) as its K6 step reads them."""
    st = mk.seg_init(pack, o, d, rng)
    pix = torch.arange(o.shape[0], device=o.device)
    states = []
    for bounce in range(md.max_depth):
        st, pix, n = mk.swf_sort(st, pix, "pos_dir")
        if n == 0:
            break
        states.append(st[:, :n].contiguous())
        hit = mk.traverse_resolve(pack, st, n)
        flight = mk.grid_flight(pack, st, n, hit[0]).contiguous()
        mk.trace_megakernel_seg(pack, md, st, n, bounce, 1, hit, flight)
        mk.swf_resolve(pack, st, n)
    torch.cuda.synchronize()
    return states


def k6_spp_ms(mk, pack, states: list) -> float:
    """Summed device ms of the split step mk.traverse_resolve (this tree's
    K6, or under parent_split the parent's K6 and resolve_hit) over the
    recorded bounces, each after a device sleep of SETTLE_CYCLES, between
    CUDA events: the median of 3 passes."""
    passes = []
    for _ in range(3):
        evs = []
        for st in states:
            torch.cuda._sleep(SETTLE_CYCLES)
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            mk.traverse_resolve(pack, st, st.shape[1])
            ev[1].record()
            evs.append(ev)
        torch.cuda.synchronize()
        passes.append(sum(a.elapsed_time(b) for a, b in evs))
    return float(np.median(passes))


def ab_k6(mk, pack, md, o, d, rng, L) -> dict:
    """K6 per spp on one spp's recorded split states (split_states): the
    kernel with its tables staged against the same launches with the table
    sizes withheld (no_stage), in turns, hit planes bit-equal; the device
    launches of the split steps over the spp (profiler); with --parent,
    the parent's split step (its K6 walk, then resolve_hit in PyTorch:
    parent_split) on the same states, hit planes bit-equal on every lane,
    the driver's L bit-equal to this tree's L, the device launches of its
    split steps and of a whole driver pass of each tree (about 300,000,
    minutes under the profiler: --parent only), and the ms per spp and the
    driver's wall per spp in turns (parent, this, this, parent)."""
    states = split_states(mk, pack, md, o, d, rng)
    hits = [mk.traverse_resolve(pack, st, st.shape[1]) for st in states]
    with no_stage(mk):
        differ_stage = sum(bit_lanes(h.T, mk.traverse_resolve(pack, st, st.shape[1]).T)
                           for h, st in zip(hits, states))
    ms = {"stage": [], "plain": []}
    for who in ("stage", "plain", "plain", "stage"):
        if who == "plain":
            with no_stage(mk):
                ms[who].append(k6_spp_ms(mk, pack, states))
        else:
            ms[who].append(k6_spp_ms(mk, pack, states))

    def driver():
        mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir")

    def split_steps():
        for st in states:
            mk.traverse_resolve(pack, st, st.shape[1])

    row = {"live_lanes": [st.shape[1] for st in states], "stage_ms": float(np.mean(ms["stage"])),
           "unstaged_ms": float(np.mean(ms["plain"])), "stage_runs_ms": ms,
           "stage_lanes_differ": differ_stage, "staged": mk.k6_stages(pack),
           "device_launches_per_spp": {"this": device_launches(split_steps)}}
    log(f"[8] K6 per spp on the recorded split states (live lanes {row['live_lanes']}): nodes, "
        f"prims and g_hit staged ({row['staged']}) {row['stage_ms']:.4f} ms against {row['unstaged_ms']:.4f} ms "
        f"left in device memory, in turns (runs {ms}); lanes differing {differ_stage}")
    if differ_stage:
        raise SystemExit("K6: the staged build's planes differ from the unstaged build's")
    if parent_lib() is not None:
        with parent_split(mk):
            p_hits = [mk.traverse_resolve(pack, st, st.shape[1]) for st in states]
            L_p = mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir")
            torch.cuda.synchronize()
            row["device_launches_per_spp"]["parent"] = device_launches(split_steps)
            row["device_launches_per_pass"] = {"parent": device_launches(driver)}
        row["device_launches_per_pass"]["this"] = device_launches(driver)
        planes_differ = sum(bit_lanes(h.T, p.T) for h, p in zip(hits, p_hits))
        l_differ = bit_lanes(L, L_p)
        runs = {"parent": [], "this": []}
        walls = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            with parent_split(mk) if who == "parent" else contextlib.nullcontext():
                runs[who].append(k6_spp_ms(mk, pack, states))
                walls[who].append(host_ms(driver)[1])
        row["parent"] = {"parent_ms": float(np.mean(runs["parent"])),
                         "this_ms": float(np.mean(runs["this"])), "runs_ms": runs,
                         "driver_wall_ms": walls, "planes_lanes_differ": planes_differ,
                         "L_lanes_differ": l_differ}
        log(f"[8] K6 + resolve per spp: the parent's walk and resolve_hit "
            f"{row['parent']['parent_ms']:.4f} ms against this tree's "
            f"{row['parent']['this_ms']:.4f} ms, in turns on the same states (runs {runs}); the "
            f"split driver's wall per spp (host clock, 1,048,576 rays) in the same turns {walls}; "
            f"hit planes differing {planes_differ}, driver L differing {l_differ} of "
            f"{L.shape[0]}")
        if planes_differ or l_differ:
            raise SystemExit("K6: this tree's split step differs from the parent's")
    log(f"[8] device launches of the split step (K6, the parent's K6 and resolve_hit) per spp: "
        f"{row['device_launches_per_spp']}; per split driver pass (1,048,576 rays, with "
        f"--parent): {row.get('device_launches_per_pass')}")
    return row


def _forest_job(geom, fmt: str):
    """Build kernel K1's forest of geom (CPU tensors) in a worker process;
    returns (forest, seconds)."""
    from cuda_pt_torch.ops import traverse_kernel as tk

    t0 = time.perf_counter()
    forest = tk.build_forest(geom, chunk_prims=FOREST_CHUNK, node_fmt=fmt)
    return forest, time.perf_counter() - t0


def k1_ray_bytes(t_far_given: bool, occlusion: bool) -> int:
    """Bytes one ray moves through K1: o and d read (24 B), t_far read only
    where the caller passes it (4 B), t/prim/b1/b2 written (16 B) or the
    occlusion flag (4 B)."""
    return 24 + (4 if t_far_given else 0) + (4 if occlusion else 16)


def k1_bound(forest, ray_bytes: int, nodes: int, prims: int) -> tuple:
    """(bound ms, what bounds it, bytes) of K1 over one launch or several:
    ray_bytes the rays' reads and writes in all (k1_ray_bytes), the forest
    read once; ops nodes x 22 + prim tests x 45."""
    nbytes = ray_bytes + (forest.nodes.numel() + forest.prims.numel()) * 4
    t_b, t_o = nbytes / PEAK_BYTES_S, (nodes * OPS_SLAB + prims * OPS_TRI) / PEAK_F32_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b > t_o else "operations", nbytes


def hold_k1(tk, forest, o, d, t_far, label: str) -> dict:
    """K1 against its plain version on rays (B, 3), closest and any hit:
    prim ids and occlusion equal, t, b1, b2 within the phase-4 tolerances.
    Returns the counts, the largest t error and the plain closest hit."""
    k = tk.traverse_forest(forest, o, d)
    occ = tk.traverse_forest(forest, o, d, t_far, occlusion=True)["occluded"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = tk.traverse_forest_reference(forest, o, d)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    p_occ = tk.traverse_forest_reference(forest, o, d, t_far, occlusion=True)["occluded"]
    differ = int((k["prim"] != p["prim"]).sum())
    occ_differ = int((occ != p_occ).sum())
    h = p["hit"] & k["hit"]
    errs = [float((k[key][h] - p[key][h]).abs().max()) if bool(h.any()) else 0.0
            for key in ("t", "b1", "b2")]
    close = all(torch.allclose(k[key][h], p[key][h], rtol=RTOL, atol=ATOL)
                for key in ("t", "b1", "b2"))
    log(f"[9] K1 {label}, {o.shape[0]} rays: {differ} prim ids differ, {occ_differ} occlusion "
        f"flags differ; hits {float(p['hit'].float().mean()):.4f}, occluded "
        f"{float(p_occ.float().mean()):.4f}; max |err| t {errs[0]:.3g} b1 {errs[1]:.3g} "
        f"b2 {errs[2]:.3g}; plain closest walk {plain_ms:.1f} ms")
    if differ or occ_differ or not close:
        raise SystemExit(f"K1 check failed on {label}: {differ} prim ids, {occ_differ} "
                         f"occlusion flags differ, t/b1/b2 within tolerance: {close}")
    return {"rays": o.shape[0], "prim_differ": differ, "occluded_differ": occ_differ,
            "max_abs_err_t": errs[0], "max_abs_err_b": max(errs[1:]), "plain_ms": plain_ms,
            "hit_frac": float(p["hit"].float().mean()),
            "occluded_frac": float(p_occ.float().mean()), "prim": k["prim"], "t": p["t"]}


def check_sorted_walk(mk, pack, scene, o, d, k1_prim) -> dict:
    """The sorted-lane walk alone (closest_hit_sorted) on the Renderer's
    kitchen pack against K1 on the same camera rays: prim ids
    equal but on exact ties (both prims hit at one t); against the w8 walk
    (closest_hit_w8, the same visit order): t and prim ids bit-equal; the
    most entries each ray's stack held (the share beyond the SW_SS entries
    kept in shared memory), and the two walks' times (CUDA events)."""
    from cuda_pt_torch.ops import intersect as isect

    t_s, prim_s, _, _, depth = mk.closest_hit_sorted(pack, o, d)
    t_w, prim_w, _, _ = mk.closest_hit_w8(pack, o, d)
    torch.cuda.synchronize()
    differ = prim_s != k1_prim
    # an exact tie: both prims hit at one t, each intersected by the plain
    # arithmetic (ops/intersect)
    idx = torch.nonzero(differ & (prim_s >= 0) & (k1_prim >= 0))[:, 0]
    t_of, hit_of, _, _ = isect.intersect_gather(
        scene.geom, o[idx], d[idx], torch.stack([prim_s[idx], k1_prim[idx]], 1),
        torch.ones((idx.numel(), 2), dtype=torch.bool, device=o.device))
    ties = int((hit_of.all(dim=1) & (t_of[:, 0] == t_of[:, 1])).sum())
    bad = int(differ.sum()) - ties
    vs_w8 = int((prim_s != prim_w).sum()) + bit_differ(t_s, t_w)
    dep = depth.float()
    ss = 16  # SW_SS, csrc/walk.cuh
    ms_s = events_ms(lambda: mk.closest_hit_sorted(pack, o, d), 10)
    ms_w = events_ms(lambda: mk.closest_hit_w8(pack, o, d), 10)
    out = {"rays": o.shape[0], "differ_k1": int(differ.sum()), "exact_ties": ties,
           "differ_w8_walk": vs_w8, "depth_max": int(depth.max()),
           "depth_mean": float(dep.mean()), "depth_over_shared": float((depth > ss).float().mean()),
           "ms": ms_s, "w8_walk_ms": ms_w, "hits": int((prim_s >= 0).sum())}
    log(f"[9] the sorted-lane walk against K1 on the {o.shape[0]} kitchen camera rays "
        f"(pack {pack_formats(pack)}): {out['differ_k1']} prim ids differ, {ties} on exact ties, "
        f"{bad} otherwise; against the w8 walk {vs_w8} prim ids or t differ; stack depth max "
        f"{out['depth_max']}, mean {out['depth_mean']:.2f}, {out['depth_over_shared']:.5f} of "
        f"rays beyond the {ss} shared entries; walk alone {ms_s:.4f} ms, the w8 walk {ms_w:.4f} ms")
    if bad or vs_w8:
        raise SystemExit(f"sorted-lane walk check failed: {out}")
    return out


def phase_k1(tk, tts, dev, kscene, kcam, forests: dict, T, mk=None, kpack=None) -> dict:
    """Kernel K1 on full-size kitchen_stress forests (f32 and bf16 rows,
    forest_chunk 65536) and on cornell's single-chunk forest, against its
    plain version; the packet form's tile_iters; K1's time per 1M rays;
    with mk and kpack (the Renderer's kitchen pack), the sorted-lane walk
    against K1 on the camera rays (check_sorted_walk)."""
    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core import qmc

    f32, bf16 = forests["f32"], forests["bf16"]
    W, H = kcam.width, kcam.height
    lane = torch.arange(W * H, device=dev)
    o, d, _ = cam_mod.generate_rays(kcam, lane, qmc.make_state("pcg", 0, lane, 0))
    o, d = o.contiguous(), d.contiguous()
    rs = np.random.default_rng(13)
    # camera rays' shadow limits: half to one and a half times the plain
    # closest t (1e8 on a miss), so about half the hits are occluded
    t_cam = tk.traverse_forest_reference(f32, o, d)["t"]
    u = torch.as_tensor(rs.uniform(0.5, 1.5, W * H).astype(np.float32), device=dev)
    tf_cam = torch.where(torch.isfinite(t_cam), t_cam * u, 1e8).contiguous()
    lo = kscene.bvh.node_min[0].cpu().numpy()
    hi = kscene.bvh.node_max[0].cpu().numpy()
    n_r = BLOCK
    o_r = torch.as_tensor(rs.uniform(lo, hi, (n_r, 3)).astype(np.float32), device=dev)
    d_r = torch.nn.functional.normalize(torch.as_tensor(
        rs.normal(size=(n_r, 3)).astype(np.float32), device=dev), dim=1).contiguous()
    tf_r = torch.as_tensor(rs.uniform(0.05, 8.0, n_r).astype(np.float32), device=dev)
    res = {"forest": {fmt: {"nodes": list(f.nodes.shape), "prims": list(f.prims.shape),
                            "n_nodes": f.n_nodes.tolist()} for fmt, f in forests.items()}}
    prims = {}
    for fmt, forest in (("f32", f32), ("bf16", bf16)):
        for rays, (o_, d_, tf_) in (("camera", (o, d, tf_cam)), ("random", (o_r, d_r, tf_r))):
            row = hold_k1(tk, forest, o_, d_, tf_, f"kitchen {fmt} forest, {rays} rays")
            prims[(fmt, rays)] = row.pop("prim")
            row.pop("t")
            res[f"{fmt}_{rays}"] = row
    if mk is not None:
        res["sorted_walk"] = check_sorted_walk(mk, kpack, kscene, o, d, prims[("f32", "camera")])
    for rays in ("camera", "random"):
        bf_differ = int((prims[("bf16", rays)] != prims[("f32", rays)]).sum())
        log(f"[9] bf16 against f32 rows, {rays} rays: {bf_differ} prim ids differ")
        if bf_differ:
            raise SystemExit(f"K1: the bf16 forest's prim ids differ from the f32 forest's "
                             f"on {bf_differ} {rays} rays")
    cscene, _, _ = tts.cornell_box(device=dev)
    cforest = tk.single_chunk_forest(cscene.geom, cscene.bvh)
    o_c = torch.as_tensor(rs.uniform(0.05, 0.95, (n_r, 3)).astype(np.float32), device=dev)
    d_c = torch.nn.functional.normalize(torch.as_tensor(
        rs.normal(size=(n_r, 3)).astype(np.float32), device=dev), dim=1).contiguous()
    tf_c = torch.as_tensor(rs.uniform(0.05, 1.5, n_r).astype(np.float32), device=dev)
    row = hold_k1(tk, cforest, o_c, d_c, tf_c, "cornell single-chunk forest, random rays")
    row.pop("prim"), row.pop("t")
    res["cornell_random"] = row
    # the packet form on PACKET_RAYS camera rays around the image centre
    c0 = (H // 2) * W - PACKET_RAYS // 2
    sl = slice(c0, c0 + PACKET_RAYS)
    k = tk.traverse_forest(f32, o[sl], d[sl], count_iters=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = tk.traverse_forest_reference(f32, o[sl], d[sl], count_iters=True)
    torch.cuda.synchronize()
    packet_plain_ms = (time.perf_counter() - t0) * 1e3
    same = torch.equal(k["tile_iters"], p["tile_iters"]) and torch.equal(k["prim"], p["prim"]) \
        and torch.equal(k["prim"], prims[("f32", "camera")][sl])
    iters = k["tile_iters"].long()
    log(f"[9] K1 packet form, {PACKET_RAYS} camera rays in tiles of {tk.TILE}: tile_iters and "
        f"prim ids equal to the plain packet walk and to the per-ray form: {same}; node "
        f"fetches per tile {int(iters.min())}-{int(iters.max())} (mean {float(iters.float().mean()):.0f}) "
        f"against {int(f32.nodes.shape[0] * f32.nodes.shape[1] * tk.SLOTS)} padded slots; "
        f"plain {packet_plain_ms:.0f} ms")
    if not same:
        raise SystemExit("K1 packet form: tile_iters or prim ids differ from the plain version")
    res["packet"] = {"rays": PACKET_RAYS, "tile": tk.TILE, "tile_iters_mean": float(
        iters.float().mean()), "plain_ms": packet_plain_ms}
    # time per 1M camera rays, closest and any hit, f32 and bf16 rows; the
    # walk work by stats
    B = o.shape[0]
    timing = {}
    for fmt, forest in (("f32", f32), ("bf16", bf16)):
        for mode, occl in (("closest", False), ("anyhit", True)):
            tf_ = tf_cam if occl else None
            ms = events_ms(lambda: tk.traverse_forest(forest, o, d, tf_, occlusion=occl), 10)
            st = torch.zeros((B, 2), dtype=torch.int32, device=dev)
            tk.traverse_forest(forest, o, d, tf_, occlusion=occl, stats=st)
            nodes = int(st[:, 0].sum(dtype=torch.int64))
            prim_tests = int(st[:, 1].sum(dtype=torch.int64))
            ray_b = B * k1_ray_bytes(tf_ is not None, occl)
            bound_ms, bound_by, nbytes = k1_bound(forest, ray_b, nodes, prim_tests)
            key = mode if fmt == "f32" else f"{mode}_bf16"
            timing[key] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                           "nodes": nodes, "prim_tests": prim_tests, "bytes": nbytes,
                           "warps": warp_figures(st)}
            log_warp_figures("9", f"K1 {mode}, camera rays, {fmt} forest", timing[key]["warps"])
            log(f"[9] K1 {mode}, {B} camera rays, {fmt} forest: {ms:.4f} ms "
                f"({B / (ms * 1e-3):.4g} rays/s); bound {bound_ms:.4f} ms ({bound_by}: {nodes} "
                f"node fetches, {prim_tests} prim tests, {nbytes} bytes of which "
                f"{nbytes - ray_b} forest); {bound_ms / ms:.4f} of bound")
    res["timing"] = timing
    if parent_lib() is not None:
        res["parent"] = ab_k1(tk, f32, o, d, tf_cam, "9", f"{B} camera rays, f32 forest")
    return res


@contextlib.contextmanager
def plain_walk(tk):
    """K1's wrapper swapped for its plain version while the block runs, so
    the same path code walks without the kernel."""
    real = tk.traverse_forest
    tk.traverse_forest = (lambda forest, o, d, t_far=None, max_leaf=4, occlusion=False, **_:
                          tk.traverse_forest_reference(forest, o, d, t_far, max_leaf, occlusion))
    try:
        yield
    finally:
        tk.traverse_forest = real


@contextlib.contextmanager
def k1_calls(tk, timing: bool = False, count: bool = False, record: bool = False):
    """Each K1 call of the block recorded: its lanes, the bytes its rays
    move (k1_ray_bytes), and
    with timing its device time (CUDA events, the kernel started after a
    device sleep that covers the host's launch latency), with count its
    walk work (a stats plane), with record its inputs ("args": forest, o,
    d, t_far, occlusion, max_leaf, copied) for replay_k1."""
    real = tk.traverse_forest
    calls = []

    def wrapped(forest, o, d, t_far=None, max_leaf=4, occlusion=False, **kw):
        row = {"lanes": o.shape[0], "bytes": o.shape[0] * k1_ray_bytes(t_far is not None,
                                                                       occlusion)}
        if record:
            row["args"] = (forest, o.clone(), d.clone(),
                           None if t_far is None else t_far.clone(), occlusion, max_leaf)
        if count:
            kw["stats"] = torch.zeros((o.shape[0], 2), dtype=torch.int32, device=o.device)
        if timing:
            torch.cuda._sleep(SETTLE_CYCLES)
            row["ev"] = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            row["ev"][0].record()
        out = real(forest, o, d, t_far, max_leaf, occlusion, **kw)
        if timing:
            row["ev"][1].record()
        if count:
            row["stats"] = kw["stats"]
        calls.append(row)
        return out

    tk.traverse_forest = wrapped
    try:
        yield calls
    finally:
        tk.traverse_forest = real
        torch.cuda.synchronize()


def k1_main_path(tk, forest, run, phase: str, label: str) -> dict:
    """K1 over the calls of run() (a pass of a composed main path on
    forest), run once timed and once counted (k1_calls): the summed device
    time, the walk work, the bound and its share, the per-group figures,
    and the counted calls (recorded, for ab_k1_calls)."""
    with k1_calls(tk, timing=True) as timed:
        run()
    with k1_calls(tk, count=True, record=True) as counted:
        run()
    timed = [c for c in timed if c["lanes"]]  # a call on no live lane launches nothing
    counted = [c for c in counted if c["lanes"]]
    k1_ms = sum(c["ev"][0].elapsed_time(c["ev"][1]) for c in timed)
    nodes = sum(int(c["stats"][:, 0].sum(dtype=torch.int64)) for c in counted)
    prim_tests = sum(int(c["stats"][:, 1].sum(dtype=torch.int64)) for c in counted)
    lanes = [c["lanes"] for c in counted]
    bound_ms, bound_by, nbytes = k1_bound(forest, sum(c["bytes"] for c in counted), nodes,
                                          prim_tests)
    log(f"[{phase}] K1 on the main path, {label}: {len(timed)} launches (lanes {lanes}), "
        f"{k1_ms:.3f} ms summed; bound {bound_ms:.4f} ms ({bound_by}: {nodes} node fetches, "
        f"{prim_tests} prim tests, {nbytes} bytes); {bound_ms / k1_ms:.4f} of bound")
    figs = [warp_figures(c["stats"]) for c in counted]
    mx, mean = sum(f["warp_max_sum"] for f in figs), sum(f["warp_mean_sum"] for f in figs)
    n_w = sum(f["warps"] for f in figs)
    warps = {"warp_max_sum": mx, "warp_mean_sum": mean, "warps": n_w, "warp_max": mx / n_w,
             "warp_mean": mean / n_w, "lane_use": mean / mx}
    log_warp_figures(phase, f"K1 over the {len(counted)} calls of {label}", warps)
    return {"ms": k1_ms, "bound_ms": bound_ms, "bound_by": bound_by, "nodes": nodes,
            "prim_tests": prim_tests, "bytes": nbytes, "lanes": lanes, "launches": len(timed),
            "warps": warps, "calls": counted}


def phase_wavefront(mk, tk, dev, kscene, kcam, f32, k5_mean: float, MaxDepthParams,
                    RendererType, RenderingConfig, ParsedScene, Renderer):
    """The wavefront path tracer's main path: the Renderer with
    WAVEFRONT_PT and traversal "pallas" on full-size kitchen_stress with
    its two-chunk f32 forest (K1 for every closest and shadow walk, no
    other kernel); a 65,536-lane Z-order block of one pass's rays through
    the wavefront loop on K1 and on its plain version; K1's time and walk
    work per spp on the main path."""
    import dataclasses

    from cuda_pt_torch.core import qmc
    from cuda_pt_torch.models import path_tracer as pt
    from cuda_pt_torch.models import wavefront

    md = MaxDepthParams()
    scene = dataclasses.replace(kscene, forest=f32)
    parsed = ParsedScene(scene, kcam, RenderingConfig(width=kcam.width, height=kcam.height,
                                                      md=md, seed=0))
    r = Renderer(parsed, renderer=RendererType.WAVEFRONT_PT, traversal="pallas")
    info = r.info()
    if (info["driver"], info["traversal"]) != ("composed", "pallas"):
        raise SystemExit(f"wavefront: not the composed route on K1: {info}")
    wall, launches, _, mean = render_main_path(
        mk, r, WF_SPP, "wavefront", {"launches": ["traverse_forest"], "instantiations": []})
    n_launch = launches["traverse_forest"]
    if n_launch > 2 * md.max_depth * WF_SPP:
        raise SystemExit(f"wavefront: {n_launch} K1 launches, more than two per bounce")
    log(f"[10] Renderer WAVEFRONT_PT traversal=pallas, kitchen_stress {kcam.width}x{kcam.height}"
        f"x{WF_SPP}spp (forest {list(f32.nodes.shape)}): {wall:.2f} s wall "
        f"({wall * 1e3 / WF_SPP:.2f} ms per spp), launches {launches}, image mean {mean:.6f} "
        f"(phase 6, K5 route: {k5_mean:.6f}; textured: the estimators agree in the mean only)")
    # K1 over the main path's first spp (wavefront.render_sample, the
    # Renderer's pass), once timed and once counted
    k1_run = k1_main_path(tk, f32, lambda: wavefront.render_sample(r.scene, r.camera, md, 0, 0,
                                                                   compact=True),
                          "10", "one wavefront spp")
    ab = ab_k1_calls(tk, k1_run["calls"], "10", "one wavefront spp") \
        if parent_lib() is not None else None
    # the block: the wavefront loop on K1 and on its plain version
    o, d, rng, sl = main_rays(mk, r, BLOCK)
    perm, _ = mk.tile_swizzle(kcam.width, kcam.height, dev)
    ob, db, rb = (x[sl].contiguous() for x in (o, d, rng))
    wl = pt.wl_stratum_u(0, 0, perm[sl])

    def run():
        L, pix = wavefront.trace_paths_wavefront(r.scene, md, ob, db, rb, compact=True, wl_u=wl)
        return torch.zeros_like(L).index_add_(0, pix, L)

    L_k = run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with plain_walk(tk):
        L_p = run()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    frac, dmean = check_contract("wavefront block, K1 against its plain version", L_k, L_p)
    log(f"[10] wavefront loop on a {BLOCK}-lane Z-order block: K1 against its plain walk "
        f"{frac:.7f} lanes differ, {int((L_k != L_p).any(dim=-1).sum())} not bit-equal, means "
        f"differ by {dmean:.3g}; the loop on the plain walk {plain_ms:.0f} ms")
    return {"launches": n_launch, "main_path_ms_per_spp": k1_run["ms"],
            "main_path_bound_ms": k1_run["bound_ms"], "main_path_bound_by": k1_run["bound_by"],
            "main_path_nodes": k1_run["nodes"], "main_path_prim_tests": k1_run["prim_tests"],
            "main_path_lanes": k1_run["lanes"], "main_path_warps": k1_run["warps"],
            **({"main_path_parent": ab, "main_path_parent_ms": ab["parent_ms"]} if ab else {}),
            "wall_ms_per_spp": wall * 1e3 / WF_SPP, "image_mean": mean,
            "k5_route_mean": k5_mean, "block_lanes_differ": frac, "block_mean_differ": dmean,
            "block_max_abs_err": float((L_k - L_p).abs().max()),
            "block_plain_loop_ms": plain_ms}, r


def _shrunk(cam, size: int):
    """The camera at size x size: the focal length scales with the width
    (by a power of two here, so exactly)."""
    import dataclasses

    return dataclasses.replace(cam, width=size, height=size,
                               focal=cam.focal * (size / cam.width))


def phase_routes(mk, tk, tts, dev, vscene, vcam, MaxDepthParams, RendererType, RenderingConfig,
                 ParsedScene, Renderer) -> dict:
    """Phase 4's hold for the composed routes: the Renderer with traversal
    "pallas" (K1) against the same Renderer with "xla" (the plain skip
    walk), SMALL x SMALL, one spp, per lane: cornell (32 prims: the brute
    force on both, no K1 launch) and kitchen_stress(grid=2) under
    MEGAKERNEL_PT, full-size medium_cbox under VOLUME_PT (its BVH as one
    chunk)."""
    md = MaxDepthParams()
    cases = {
        "cornell": (lambda: tts.cornell_box(SMALL, SMALL, device=dev)[:2],
                    RendererType.MEGAKERNEL_PT),
        "kitchen_small": (lambda: tts.kitchen_stress(SMALL, SMALL, grid=2, ns=6, nt=4,
                                                     device=dev)[:2], RendererType.MEGAKERNEL_PT),
        "medium_cbox": (lambda: (vscene, _shrunk(vcam, SMALL)), RendererType.VOLUME_PT),
    }
    res = {}
    for name, (make, rtype) in cases.items():
        scene, cam = make()
        parsed = ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height,
                                                         md=md, seed=0))
        imgs, ms, launched = {}, {}, {}
        for trav in ("pallas", "xla"):
            r = Renderer(parsed, renderer=rtype, traversal=trav)
            torch.cuda.synchronize()
            mk.reset_launches()
            t0 = time.perf_counter()
            imgs[trav] = r.render_raw().reshape(-1, 3)
            torch.cuda.synchronize()
            ms[trav] = (time.perf_counter() - t0) * 1e3
            launched[trav] = {k: v for k, v in mk.LAUNCHES.items() if v}
        frac, dmean = check_contract(f"{name} traversal pallas against xla", imgs["pallas"],
                                     imgs["xla"])
        want = set() if name == "cornell" else {"traverse_forest"}
        if set(launched["pallas"]) != want or launched["xla"]:
            raise SystemExit(f"{name}: launched {launched}, K1 expected only under pallas")
        log(f"[4] {name} {rtype.value} {SMALL}x{SMALL}x1spp, traversal pallas against xla: "
            f"{frac:.7f} lanes differ, means differ by {dmean:.3g}; K1 launches "
            f"{launched['pallas'].get('traverse_forest', 0)}; pass {ms['pallas']:.0f} ms "
            f"(pallas) / {ms['xla']:.0f} ms (xla)")
        res[name] = {"lanes_differ": frac, "mean_differ": dmean,
                     "k1_launches": launched["pallas"].get("traverse_forest", 0),
                     "pass_ms_pallas": ms["pallas"], "pass_ms_xla": ms["xla"]}
    return res


def hold_walk_k1(mk, tk, scene, o, d, label: str) -> dict:
    """The binary walk (closest_hit_w8 on binary packs of scene, f32 and
    bf16 rows) against kernel K1's per-ray form over the scene's BVH as one
    chunk, on the same rays: prim ids equal on every ray."""
    forest = tk.single_chunk_forest(scene.geom, scene.bvh)
    k1 = tk.traverse_forest(forest, o, d)
    out = {"rays": o.shape[0], "hits": int((k1["prim"] >= 0).sum())}
    for node_fmt in ("f32", "bf16"):
        _, prim, _, _ = mk.closest_hit_w8(mk.make_pack(scene, node_fmt=node_fmt), o, d)
        torch.cuda.synchronize()
        out[f"{node_fmt}_differ"] = int((prim != k1["prim"]).sum())
    log(f"[11] binary walk against K1 over the one-chunk forest, {label}, {o.shape[0]} camera "
        f"rays: prim ids differing {out['f32_differ']} (f32 rows), {out['bf16_differ']} (bf16 "
        f"rows); hits {out['hits']}")
    if out["f32_differ"] or out["bf16_differ"]:
        raise SystemExit(f"binary walk check failed on {label}: {out}")
    return out


def held_splats(label: str, img_k: torch.Tensor, img_p: torch.Tensor) -> dict:
    """Two splat images of the same paths (H*W, 3): the kernel's walk and
    the plain walk. Float atomics do not fix the order of a pixel's adds,
    so they are held per pixel: over the pixels either touched,
    allclose(rtol 1e-4, atol 1e-6 x the largest pixel) on >= 98 %, and the
    image sums within 1e-4 relative."""
    if not (bool(torch.isfinite(img_k).all()) and bool(torch.isfinite(img_p).all())):
        raise SystemExit(f"{label}: non-finite splats")
    touched = (img_k != 0).any(dim=-1) | (img_p != 0).any(dim=-1)
    atol = 1e-6 * float(img_p.abs().max())
    close = torch.isclose(img_k[touched], img_p[touched], rtol=1e-4, atol=atol).all(dim=-1)
    frac = float(close.float().mean()) if bool(touched.any()) else 0.0
    s_k, s_p = float(img_k.double().sum()), float(img_p.double().sum())
    rel = abs(s_k / s_p - 1.0) if s_p else float("inf")
    if frac < 0.98 or rel > 1e-4:
        raise SystemExit(f"{label}: {frac} of {int(touched.sum())} touched pixels agree, sums "
                         f"differ by {rel} relative")
    return {"pixels_touched": int(touched.sum()), "pixels_agree": frac, "sum_rel_differ": rel,
            "not_bit_equal": int((img_k != img_p).any(dim=-1).sum())}


def walls_per_pass(r, passes: int) -> float:
    """Wall ms per pass of the Renderer r over passes passes (synchronized)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render(passes)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / passes


def phase_light(mk, tk, tts, dev, kscene, kcam, f32, T, MaxDepthParams, RendererType,
                RenderingConfig, ParsedScene, Renderer) -> tuple:
    """Phase 16: the light tracer's main path (MEGAKERNEL_LT, traversal
    "pallas", full-size kitchen_stress on its f32 forest: K1 only) with a
    65,536-path block held to the plain walk, light against path tracing on
    cornell, DEPTH and BVH_COST held to the CPU, render_aovs on K1 held to
    the plain walk, and denoise held to the CPU's filter. Returns (K1's
    numbers for its kernels entry, the phase's own entry, the light
    tracer's Renderer)."""
    import dataclasses

    from cuda_pt_torch.accel import traverse
    from cuda_pt_torch.core import film as film_mod
    from cuda_pt_torch.models import debug_renderers, denoise, light_tracer

    md = MaxDepthParams()

    def parsed(scene, cam):
        return ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height, md=md,
                                                       seed=0))

    # 1. the main path
    r = Renderer(parsed(dataclasses.replace(kscene, forest=f32), kcam),
                 renderer=RendererType.MEGAKERNEL_LT, traversal="pallas")
    info = r.info()
    if (info["driver"], info["traversal"]) != ("composed", "pallas"):
        raise SystemExit(f"light tracer: not the composed route on K1: {info}")
    wall, launches, _, mean = render_main_path(
        mk, r, LT_SPP, "light tracer", {"launches": ["traverse_forest"], "instantiations": []})
    n_launch = launches["traverse_forest"]
    if n_launch > (2 * md.max_depth + 1) * LT_SPP or mean <= 0.0:
        raise SystemExit(f"light tracer: {n_launch} K1 launches in {LT_SPP} passes (at most "
                         f"{2 * md.max_depth + 1} a pass), image mean {mean}")
    log(f"[16] Renderer MEGAKERNEL_LT traversal=pallas, kitchen_stress {kcam.width}x"
        f"{kcam.height}x{LT_SPP} passes: {wall * 1e3 / LT_SPP:.2f} ms wall per pass, "
        f"{n_launch / LT_SPP:g} K1 launches per pass, image mean {mean:.6f}")
    k1_run = k1_main_path(tk, f32, lambda: light_tracer.render_pass(
        r.scene, r.camera, md, 0, 0, True), "16", "one light-tracing pass")
    # 2. a block of paths on K1 and on its plain walk
    t0 = time.perf_counter()
    blk_k = light_tracer.render_pass(r.scene, r.camera, md, 3, 0, True, n_paths=BLOCK)
    torch.cuda.synchronize()
    blk_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with plain_walk(tk):
        blk_p = light_tracer.render_pass(r.scene, r.camera, md, 3, 0, True, n_paths=BLOCK)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    blk = held_splats("light tracer block, K1 against its plain walk", blk_k, blk_p)
    log(f"[16] {BLOCK} light paths on K1 against the plain walk: {blk['pixels_agree']:.6f} of "
        f"{blk['pixels_touched']} touched pixels agree ({blk['not_bit_equal']} not bit-equal), "
        f"sums differ by {blk['sum_rel_differ']:.3g}; {blk_ms:.0f} ms on K1, {plain_ms:.0f} ms "
        f"on the plain walk")
    # 3. light against path tracing on cornell
    cscene, ccam = tts.cornell_box(kcam.width, kcam.height, device=dev)[:2]
    rl = Renderer(parsed(cscene, ccam), renderer=RendererType.MEGAKERNEL_LT)
    rp = Renderer(parsed(cscene, ccam), renderer=RendererType.MEGAKERNEL_PT)
    mk.reset_launches()
    lt_cornell_ms = walls_per_pass(rl, LT_SPP)
    if any(mk.LAUNCHES.values()):
        raise SystemExit(f"cornell light tracer (brute force) launched {dict(mk.LAUNCHES)}")
    rp.render(LT_SPP)
    ratio = float(rl.film.mean.mean()) / float(rp.film.mean.mean())
    if not 0.8 < ratio < 1.25:
        raise SystemExit(f"cornell: light-traced / path-traced mean {ratio}, not in (0.8, 1.25)")
    log(f"[16] cornell {ccam.width}x{ccam.height}x{LT_SPP}: MEGAKERNEL_LT (brute force) "
        f"{lt_cornell_ms:.2f} ms wall per pass, mean {float(rl.film.mean.mean()):.6f}; fused "
        f"MEGAKERNEL_PT mean {float(rp.film.mean.mean()):.6f}; ratio {ratio:.4f}")
    # 4. DEPTH and BVH_COST on the card against the CPU
    debug = {}
    for name, make in (("cornell", lambda d: tts.cornell_box(SMALL, SMALL, device=d)[:2]),
                       ("kitchen_small", lambda d: tts.kitchen_stress(
                           SMALL, SMALL, grid=2, device=d)[:2])):
        scene, cam = make(dev)
        scene_c, cam_c = T.to_device(scene, "cpu"), cam.to("cpu")
        for rtype in (RendererType.DEPTH, RendererType.BVH_COST):
            rd = Renderer(parsed(scene, cam), renderer=rtype)
            img = rd.render_raw()
            img_c = Renderer(parsed(scene_c, cam_c), renderer=rtype, device="cpu").render_raw()
            px = float((img.cpu() == img_c).all(dim=-1).float().mean())
            if rtype == RendererType.DEPTH:
                _, aux = debug_renderers.render_depth(scene, cam, use_bvh=rd.use_bvh)
                _, aux_c = debug_renderers.render_depth(scene_c, cam_c, use_bvh=rd.use_bvh)
                rel = max(float(((aux[k].cpu() - aux_c[k]).abs()
                                 / aux_c[k].abs().clamp(min=1e-30)).max())
                          for k in ("depth", "t_min", "t_max"))
                row = {"pixels_equal": px, "max_rel_differ": rel}
                ok = px >= 0.99 and rel <= 4e-6
            else:
                o, d = debug_renderers._primary_rays(cam, 0)
                cnt = traverse.closest_hit_bvh(scene.geom, scene.bvh, o, d, count_cost=True)
                cnt_c = traverse.closest_hit_bvh(scene_c.geom, scene_c.bvh, o.cpu(), d.cpu(),
                                                 count_cost=True)
                rays = min(float((cnt[k].cpu() == cnt_c[k]).float().mean())
                           for k in ("node_cnt", "prim_cnt"))
                _, aux = debug_renderers.render_bvh_cost(scene, cam)
                _, aux_c = debug_renderers.render_bvh_cost(scene_c, cam_c)
                rel = abs(float(aux["mean_cost"]) / float(aux_c["mean_cost"]) - 1.0)
                row = {"pixels_equal": px, "rays_equal": rays, "mean_cost_rel_differ": rel}
                ok = rays >= 0.999 and rel <= 1e-3
            log(f"[16] {rtype.value} on {name} {SMALL}x{SMALL}, card against CPU: {row}")
            if not ok:
                raise SystemExit(f"{rtype.value} on {name}: the card disagrees with the CPU: {row}")
            debug[f"{rtype.value}_{name}"] = row
    for rtype in (RendererType.DEPTH, RendererType.BVH_COST):
        debug[f"{rtype.value}_cornell_wall_ms_per_pass"] = walls_per_pass(
            Renderer(parsed(cscene, ccam), renderer=rtype), LT_SPP)
        log(f"[16] {rtype.value} cornell {ccam.width}x{ccam.height}: "
            f"{debug[f'{rtype.value}_cornell_wall_ms_per_pass']:.2f} ms wall per pass")
    # 5. AOVs on K1 and on the plain walk; denoise against the CPU's filter
    torch.cuda.synchronize()
    mk.reset_launches()
    aov = r.render_aovs(spp=1)
    aov_launches = {k: v for k, v in mk.LAUNCHES.items() if v}
    if set(aov_launches) != {"traverse_forest"}:
        raise SystemExit(f"render_aovs under pallas launched {aov_launches}, not K1 alone")
    with plain_walk(tk):
        aov_p = r.render_aovs(spp=1)
    dep_ok = float(np.mean(np.isclose(aov["depth"], aov_p["depth"], rtol=1e-5, atol=0.0)))
    if not np.array_equal(aov["coverage"], aov_p["coverage"]) or dep_ok < 0.999:
        raise SystemExit(f"render_aovs on K1 against the plain walk: coverage equal "
                         f"{np.array_equal(aov['coverage'], aov_p['coverage'])}, depth "
                         f"within 1e-5 on {dep_ok}")
    rp.render(4 - LT_SPP)  # the fused cornell film at 4 passes
    den = rp.denoise()
    a_cpu = {k: v.cpu() for k, v in debug_renderers.render_aovs(
        rp.scene, rp.camera, spp=4, seed=rp.seed + 7919, use_bvh=rp.use_bvh).items()}
    var = (film_mod.variance(rp.film) / rp.film.count).cpu()
    den_c = denoise.atrous_denoise(rp.film.mean.cpu(), a_cpu, variance=var).numpy()
    den_err = float(np.abs(den - den_c).max())
    if rp.film.count != 4 or not np.allclose(den, den_c, rtol=1e-4, atol=1e-4):
        raise SystemExit(f"denoise on the card against the CPU's filter: max |err| {den_err}")
    log(f"[16] render_aovs kitchen {kcam.width}x{kcam.height} on K1: launches {aov_launches}, "
        f"coverage equal to the plain walk's, depth within 1e-5 on {dep_ok:.6f}; denoise of "
        f"the fused cornell film at 4 passes against the CPU's filter: max |err| {den_err:.3g}")
    k1_entry = {"lt_ms_per_pass": k1_run["ms"], "lt_launches_per_pass": n_launch / LT_SPP,
                "lt_bound_ms": k1_run["bound_ms"], "lt_bound_by": k1_run["bound_by"],
                "lt_nodes": k1_run["nodes"], "lt_prim_tests": k1_run["prim_tests"],
                "lt_warps": k1_run["warps"]}
    entry = {"lt_wall_ms_per_pass": wall * 1e3 / LT_SPP, "lt_image_mean": mean,
             "lt_k1_launches": n_launch, "lt_k1_ms_per_pass": k1_run["ms"],
             "lt_k1_bound_ms": k1_run["bound_ms"], "lt_k1_lanes": k1_run["lanes"],
             "block": {**blk, "k1_ms": blk_ms, "plain_ms": plain_ms},
             "cornell_lt_wall_ms_per_pass": lt_cornell_ms, "cornell_lt_over_pt": ratio,
             "debug": debug, "aov_launches": aov_launches, "aov_depth_within": dep_ok,
             "denoise_max_abs_err": den_err}
    return k1_entry, entry, r


def peak_mib(dev, base: int = 0) -> float:
    """The allocator's peak since its last reset, less base bytes, in MiB."""
    return (torch.cuda.max_memory_allocated(dev) - base) / 2**20


def grad_steps(mk, dev, card: str) -> dict:
    """Phase 17's main path: inverse_render.main on the albedo family at
    GRAD_RES for GRAD_STEPS Adam steps, each step's loss, parameter error,
    wall, peak memory and k_d gradient (rows 0-2 finite and non-zero)."""
    import io

    from cuda_pt_torch import inverse_render as ir

    steps, base = [], [0]

    def on_step(rec):
        torch.cuda.synchronize()
        g = rec["grad"][0:3]
        steps.append({"loss": rec["loss"], "param_err": rec["param_err"],
                      "elapsed_s": rec["elapsed_s"], "peak_mib": peak_mib(dev, base[0]),
                      "grad_finite": bool(torch.isfinite(g).all()),
                      "grad_abs_mean": float(g.abs().mean())})
        base[0] = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    out = os.path.join(REPO, "build", "inverse_render")
    argv = ["--param", "albedo", "--res", str(GRAD_RES), "--steps", str(GRAD_STEPS),
            "--out", out]
    torch.cuda.synchronize()
    mk.reset_launches()
    base[0] = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = ir.main(argv, on_step=on_step)
    wall = time.perf_counter() - t0
    launched = {k: v for k, v in mk.LAUNCHES.items() if v}
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    log(f"[17] inverse_render.main({' '.join(argv)}) (cut: {GRAD_STEPS} of the albedo "
        f"family's 60 steps; its defaults: remat, 8 spp, max_depth 3): exit {rc}, "
        f"{wall:.2f} s wall, launches {launched} (the brute force: none), result {lines[-1]} "
        f"({card})")
    prev = 0.0
    for i, st in enumerate(steps):
        log(f"[17] inverse_render step {i}: loss {st['loss']:.6f}, param_err "
            f"{st['param_err']:.5f}, wall {st['elapsed_s'] - prev:.3f} s, peak "
            f"{st['peak_mib']:.1f} MiB above the step's start"
            f"{' (the target render too)' if i == 0 else ''}, "
            f"|grad| of k_d rows 0-2 {st['grad_abs_mean']:.3e} ({card})")
        st["wall_s"] = st["elapsed_s"] - prev
        prev = st["elapsed_s"]
        if not st["grad_finite"] or not st["grad_abs_mean"] > 0.0 or not np.isfinite(st["loss"]):
            raise SystemExit(f"inverse_render step {i}: gradient or loss not finite and non-zero")
    if launched or len(steps) != GRAD_STEPS:
        raise SystemExit(f"inverse_render: launched {launched}, {len(steps)} steps")
    return {"exit": rc, "wall_s": wall, "steps": steps, "result": lines[-1]}


def grad_checks(mk, dev, card: str) -> dict:
    """remat against plain at GRAD_CHECK_SPP (the image, the gradient, the
    peak memory), the peak memory of plain, remat and remat with each
    bounce checkpointed inside each pass's checkpoint (the reference's
    nesting, which render does not use) at MEM_SPP spp, and the
    emitter-scaler gradient against central differences; cornell
    GRAD_RES x GRAD_RES, d mean(image) / d k_d."""
    from cuda_pt_torch import inverse_render as ir
    from cuda_pt_torch.core.config import MaxDepthParams
    from cuda_pt_torch.models import path_tracer as pt
    from cuda_pt_torch.scene import testscenes as tts

    prob = ir.make_problem("albedo", GRAD_RES, dev)
    cam, md = tts.cornell_box(GRAD_RES, GRAD_RES, device=dev)[1], MaxDepthParams(max_depth=3)

    def render(scene, spp: int, mode):
        if mode != "nested":
            return prob.render(scene, 1, spp, mode)
        acc = torch.zeros((GRAD_RES, GRAD_RES, 3), device=dev)
        for i in range(spp):
            acc = acc + pt.remat(lambda j: pt.render_sample(scene, cam, md, 1, j, False, "remat"),
                                 i)
        return acc / spp

    def run(spp: int, mode) -> tuple:
        theta = prob.theta0.clone().requires_grad_(True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        img = render(prob.apply(prob.scene, theta), spp, mode)
        (g,) = torch.autograd.grad(img.mean(), theta)
        torch.cuda.synchronize()
        return img.detach(), g, time.perf_counter() - t0, peak_mib(dev, base)

    (img_p, g_p, s_p, m_p), (img_r, g_r, s_r, m_r) = (run(GRAD_CHECK_SPP, m)
                                                      for m in (True, "remat"))
    rel = float(((g_r - g_p).abs() / g_p.abs().clamp(min=1e-30)).max())
    log(f"[17] cornell {GRAD_RES}x{GRAD_RES}x{GRAD_CHECK_SPP}spp, d mean(image) / d k_d: remat "
        f"against plain: image bit-equal {bool(torch.equal(img_p, img_r))}, gradient max rel "
        f"diff {rel:.3e}; wall {s_p:.3f} s (plain) / {s_r:.3f} s (remat), peak memory above "
        f"the inputs {m_p:.1f} MiB (plain) / {m_r:.1f} MiB (remat) ({card})")
    if not torch.equal(img_p, img_r) or not torch.allclose(g_r, g_p, rtol=1e-6, atol=0.0) \
            or not m_r < m_p:
        raise SystemExit("remat does not match plain or saves no memory")
    mem = {str(mode): [run(spp, mode)[3] for spp in MEM_SPP] for mode in (True, "remat", "nested")}
    log(f"[17] peak memory above the inputs (MiB) at {MEM_SPP} spp: plain {mem['True']}, remat "
        f"{mem['remat']}, remat nested in each pass {mem['nested']} ({card})")
    if any(r >= p for r, p in zip(mem["remat"], mem["True"])) \
            or mem["remat"][-1] > 1.05 * mem["remat"][0]:
        raise SystemExit("remat's peak memory is not below plain's or grows with spp")
    # the emitter's scaler: autograd against central differences, the same
    # streams at s +- eps (the reference's test_grad_emitter_scaler_matches_fd)
    pe = ir.make_problem("emitter", GRAD_RES, dev)

    def f(s):
        th = torch.cat([pe.theta_true[:1], (s * torch.ones(3, device=dev))[None],
                        pe.theta_true[2:]])
        return pe.render(pe.apply(pe.scene, th), 3, GRAD_CHECK_SPP, True).mean()

    s0, eps = 12.0, 0.5
    s = torch.tensor(s0, device=dev, requires_grad=True)
    (g_ad,) = torch.autograd.grad(f(s), s)
    with torch.no_grad():
        g_fd = (f(torch.tensor(s0 + eps, device=dev)) - f(torch.tensor(s0 - eps, device=dev))) \
            / (2 * eps)
    g_ad, g_fd = float(g_ad), float(g_fd)
    log(f"[17] emitter scaler gradient at {s0}: autograd {g_ad:.7e}, central differences "
        f"(eps {eps}, common random numbers) {g_fd:.7e}, rel diff "
        f"{abs(g_ad / g_fd - 1.0):.3e} ({card})")
    if not (np.isfinite(g_ad) and g_fd != 0.0 and abs(g_ad - g_fd) <= 2e-3 * abs(g_fd) + 1e-4):
        raise SystemExit("emitter scaler gradient disagrees with finite differences")
    return {"spp": GRAD_CHECK_SPP, "remat_grad_max_rel": rel, "plain_s": s_p, "remat_s": s_r,
            "plain_peak_mib": m_p, "remat_peak_mib": m_r, "mem_spp": MEM_SPP,
            "peak_mib_by_spp": mem, "fd_grad": g_fd, "ad_grad": g_ad}


def grad_vpt(mk, tk, dev, vscene, vcam, card: str) -> dict:
    """volume_pt.render(differentiable="remat") on full-size medium_cbox
    under "pallas" at GRAD_RES, d mean(image) / d media.scale; a CROP x CROP
    window of it on K1 and on the plain "xla" walk."""
    import dataclasses

    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core import qmc
    from cuda_pt_torch.core.config import MaxDepthParams
    from cuda_pt_torch.models import path_tracer as pt
    from cuda_pt_torch.models import volume_pt as vpt

    md = MaxDepthParams(max_depth=4, max_volume=3)
    cam = _shrunk(vcam, GRAD_RES)
    scene = dataclasses.replace(vscene, traversal="pallas",
                                forest=tk.single_chunk_forest(vscene.geom, vscene.bvh))

    def with_scale(sc, trav):
        return dataclasses.replace(scene, traversal=trav,
                                   media=dataclasses.replace(scene.media, scale=sc))

    leaf = scene.media.scale.clone().requires_grad_(True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    mk.reset_launches()
    t0 = time.perf_counter()
    img = vpt.render(with_scale(leaf, "pallas"), cam, md, VPT_GRAD_SPP, seed=0, use_bvh=True,
                     differentiable="remat")
    (g,) = torch.autograd.grad(img.mean(), leaf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: v for k, v in mk.LAUNCHES.items() if v}
    mem = peak_mib(dev, base)
    log(f"[17] volume_pt.render(differentiable='remat'), medium_cbox {GRAD_RES}x{GRAD_RES}x"
        f"{VPT_GRAD_SPP}spp, traversal pallas, d mean(image) / d media.scale = "
        f"{g.tolist()}: {wall:.2f} s wall (forward and backward), peak memory above the inputs "
        f"{mem:.1f} MiB, launches {launched}, image mean {float(img.detach().mean()):.6f} "
        f"({card})")
    if set(launched) != {"traverse_forest"} or not bool(torch.isfinite(img).all()) \
            or not bool(torch.isfinite(g).all()) or not bool((g != 0).all()):
        raise SystemExit(f"VPT gradient render: launched {launched}, image or gradient bad")
    # the window: the same lanes, streams and strata as the render's
    r0 = (GRAD_RES - CROP) // 2
    rows = torch.arange(r0, r0 + CROP, device=dev)
    lane = (rows[:, None] * GRAD_RES + rows[None, :]).reshape(-1)
    held = {}
    for trav in ("pallas", "xla"):
        sc = scene.media.scale.clone().requires_grad_(True)
        t0 = time.perf_counter()
        acc = torch.zeros((lane.numel(), 3), device=dev)
        for i in range(VPT_GRAD_SPP):
            rng = qmc.make_state("pcg", 0, lane, i)
            o, d, rng = cam_mod.generate_rays(cam, lane, rng)
            acc = acc + vpt.trace_paths(with_scale(sc, trav), md, o, d, rng, True, True,
                                        wl_u=pt.wl_stratum_u(0, i, lane))
        L = acc / VPT_GRAD_SPP
        (gw,) = torch.autograd.grad(L.mean(), sc)
        torch.cuda.synchronize()
        held[trav] = (L.detach(), gw, time.perf_counter() - t0)
    frac, dmean = check_contract("VPT gradient window, K1 against the plain walk",
                                 held["pallas"][0], held["xla"][0])
    grel = float(((held["pallas"][1] - held["xla"][1]).abs() / held["xla"][1].abs()).max())
    log(f"[17] {CROP}x{CROP} window ({lane.numel()} lanes) of the same render, K1 against the "
        f"plain walk: {frac:.7f} lanes differ, means differ by {dmean:.3g}; gradients "
        f"{held['pallas'][1].tolist()} / {held['xla'][1].tolist()}, max rel diff {grel:.3e}; "
        f"{held['pallas'][2]:.2f} s / {held['xla'][2]:.2f} s ({card})")
    if not grel <= 1e-3:
        raise SystemExit("VPT gradient window: K1's gradient disagrees with the plain walk's")
    return {"wall_s": wall, "peak_mib": mem, "k1_launches": launched["traverse_forest"],
            "grad": g.tolist(), "window_lanes_differ": frac, "window_mean_differ": dmean,
            "window_grad_max_rel": grel}


def grad_tof(mk, kscene, kcam, f32, MaxDepthParams, RenderingConfig, ParsedScene, Renderer,
             card: str) -> dict:
    """ToF windows on the Renderer's composed route: kitchen_stress
    1024x1024 x TOF_SPP under "pallas" (its f32 forest), two windows split
    at TOF_SPLIT and the ungated image."""
    import dataclasses

    scene = dataclasses.replace(kscene, forest=f32)
    windows = {"near": (0.0, TOF_SPLIT), "far": (TOF_SPLIT, 1e6), "ungated": (0.0, 0.0)}
    imgs, out = {}, {}
    for name, (lo, hi) in windows.items():
        md = MaxDepthParams(min_time=lo, max_time=hi)
        parsed = ParsedScene(scene, kcam, RenderingConfig(width=kcam.width, height=kcam.height,
                                                          md=md, seed=0))
        r = Renderer(parsed, traversal="pallas")
        if r.info()["driver"] != "composed":
            raise SystemExit(f"ToF {name}: not the composed route: {r.info()}")
        wall, launches, _, mean = render_main_path(
            mk, r, TOF_SPP, f"ToF {name}", {"launches": ["traverse_forest"],
                                             "instantiations": []})
        imgs[name] = torch.as_tensor(r.film.mean)
        out[name] = {"wall_ms_per_pass": wall * 1e3 / TOF_SPP,
                     "k1_launches_per_pass": launches["traverse_forest"] / TOF_SPP,
                     "image_mean": mean}
        log(f"[17] Renderer traversal=pallas, kitchen_stress {kcam.width}x{kcam.height}x"
            f"{TOF_SPP}spp, ToF {name} {'window [%g, %g]' % (lo, hi) if hi else '(no window)'}: "
            f"{wall * 1e3 / TOF_SPP:.1f} ms wall per pass, K1 launches per pass "
            f"{launches['traverse_forest'] / TOF_SPP:g}, image mean {mean:.6f} ({card})")
    diff = float((imgs["near"] + imgs["far"] - imgs["ungated"]).abs().max())
    log(f"[17] ToF windows near + far against the ungated image: max |difference| per pixel "
        f"{diff:.3e} ({card})")
    if not diff <= 1e-3 or not 0.0 < out["near"]["image_mean"] < out["ungated"]["image_mean"]:
        raise SystemExit("ToF windows do not partition the ungated image")
    return {**out, "max_abs_partition_err": diff}


def phase_grad(mk, tk, dev, card: str, vscene, vcam, kscene, kcam, f32, MaxDepthParams,
               RenderingConfig, ParsedScene, Renderer) -> dict:
    """Phase 17: gradients on the card (module docstring)."""
    t0 = time.perf_counter()
    res = {"inverse_render": grad_steps(mk, dev, card), "checks": grad_checks(mk, dev, card),
           "vpt": grad_vpt(mk, tk, dev, vscene, vcam, card),
           "tof": grad_tof(mk, kscene, kcam, f32, MaxDepthParams, RenderingConfig, ParsedScene,
                           Renderer, card)}
    res["phase_s"] = time.perf_counter() - t0
    log(f"[17] phase 17: {res['phase_s']:.1f} s ({card})")
    return res


def sobol_block(mk, rs, md, blk: int) -> dict:
    """The hybrid route's inputs on a blk-lane block of the Z-order lanes
    (the image centre's) built on the card and by the CPU port: the Sobol
    states, the jitter draw, the camera's state after its two draws and the
    pcg streams bit-equal, the rays within 1e-6; then K2 on the card's
    block held to its plain version (phase-4 contract)."""
    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core import qmc

    cam = rs.camera
    perm, inv = mk.tile_swizzle(cam.width, cam.height, rs.device)
    k0 = int(inv[(cam.height // 2) * cam.width + cam.width // 2]) // blk * blk
    sides = {}
    for where, lanes, c in (("card", perm[k0:k0 + blk], cam),
                            ("cpu", perm[k0:k0 + blk].cpu(), cam.to("cpu"))):
        st = qmc.make_state("sobol", rs.seed, lanes, 0)
        o, d, st_after = cam_mod.generate_rays(c, lanes, st)
        rng = qmc.make_state("pcg", (rs.seed & 0xFFFFFFFF) ^ 0x9E3779B9, lanes, 0)
        sides[where] = [t.cpu() for t in (st, qmc.next2d(st)[0], st_after, rng, o, d)]
    bits = all(torch.equal(a, b) for a, b in zip(sides["card"][:4], sides["cpu"][:4]))
    o_err, d_err = (float((a - b).abs().max()) for a, b in zip(sides["card"][4:], sides["cpu"][4:]))
    log(f"[18] hybrid inputs of a {blk}-lane block, card against CPU: Sobol states, jitter "
        f"draws, camera states and pcg streams bit-equal {bits}; rays max |diff| o {o_err:.3g}, "
        f"d {d_err:.3g}")
    if not bits or o_err > 1e-6 or d_err > 1e-6:
        raise SystemExit("hybrid Sobol inputs: the card's differ from the CPU port's")
    o, d, rng = rs._hybrid_rays(perm[k0:k0 + blk], 0)
    L_k = mk.trace_megakernel(rs._pack, md, o, d, rng)
    L_p, plain_ms = host_ms(lambda: mk.trace_megakernel_reference(rs._pack, md, o, d, rng))
    frac, dmean = check_contract("cornell hybrid Sobol block, K2", L_k, L_p)
    log(f"[18] K2 on the hybrid block against its plain version ({plain_ms:.1f} ms): {frac:.7f} "
        f"lanes differ, means differ by {dmean:.3g}")
    return {"lanes": blk, "inputs_bit_equal": bits, "o_max_abs_diff": o_err,
            "d_max_abs_diff": d_err, "k2_lanes_differ": frac, "k2_mean_differ": dmean,
            "k2_max_abs_err": float((L_k - L_p).abs().max()), "plain_ms": plain_ms}


def in_turns_ms(runs: dict, turns: int = 2) -> dict:
    """{name: [ms per turn]} of runs {name: fn() -> ms}, run in turns."""
    out = {k: [] for k in runs}
    for _ in range(turns):
        for k, fn in runs.items():
            out[k].append(fn())
    return out


def phase_sampling(mk, tts, dev, r, rk, k2_inst: str, k5_mean: float, MaxDepthParams,
                   RenderingConfig, ParsedScene, Renderer) -> dict:
    """Phase 18: the Sobol sampler on the kernel routes (the hybrid scheme:
    Sobol camera jitter, pcg path streams into K2 and K5), adaptive
    sampling on K2 and film checkpoints, through the Renderer."""
    import tempfile

    md = MaxDepthParams()
    cam = r.camera
    want_k2 = {"launches": ["trace_megakernel"], "instantiations": [k2_inst]}
    out = {}
    # -- cornell 1024x1024, hybrid Sobol on K2
    rs = Renderer(r.parsed, sampler="sobol")
    info = rs.info()
    if (info["sampler"], info["driver"]) != ("sobol", "whole_path"):
        raise SystemExit(f"cornell sobol: not the whole-path route: {info}")
    wall, launches, inst, mean = render_main_path(mk, rs, SOBOL_SPP, "cornell sobol", want_k2)
    out["cornell"] = {"spp": SOBOL_SPP, "wall_ms_per_spp": wall * 1e3 / SOBOL_SPP,
                      "k2_launches": launches["trace_megakernel"],
                      "k2_launches_per_pass": launches["trace_megakernel"] / SOBOL_SPP,
                      "image_mean": mean}
    perm, _ = mk.tile_swizzle(cam.width, cam.height, dev)
    rays = {k: rr._hybrid_rays(perm, 0) for k, rr in (("pcg", r), ("sobol", rs))}
    bits = {k: mk.rng_bits(v[2]) for k, v in rays.items()}
    out["cornell"]["wall_ms_per_spp_turns"] = in_turns_ms(
        {k: (lambda rr=rr: walls_per_pass(rr, 4)) for k, rr in (("pcg", r), ("sobol", rs))})
    out["cornell"]["k2_ms_per_spp_turns"] = in_turns_ms(
        {k: (lambda k=k: events_ms(lambda: mk.trace_megakernel(r._pack, md, rays[k][0],
                                                               rays[k][1], bits[k]), 5))
         for k in rays})
    setup = {k: (lambda rr=rr: rr._hybrid_rays(perm, 0)) for k, rr in (("pcg", r), ("sobol", rs))}
    out["ray_setup"] = {k: {"ms_per_pass": events_ms(fn, 5), "device_launches": device_launches(fn)}
                        for k, fn in setup.items()}
    c = out["cornell"]
    log(f"[18] cornell {cam.width}x{cam.height}x{SOBOL_SPP}spp hybrid Sobol: {wall:.2f} s wall, "
        f"launches {launches} {inst}, mean {mean:.6f}; wall ms/spp in turns {c['wall_ms_per_spp_turns']}; "
        f"K2 ms/spp in turns {c['k2_ms_per_spp_turns']}; ray setup per pass {out['ray_setup']}")
    out["block"] = sobol_block(mk, rs, md, BLOCK)
    # -- kitchen_stress 1024x1024, hybrid Sobol on K5
    rks = Renderer(rk.parsed, sampler="sobol")
    wall, launches, inst, mean = render_main_path(
        mk, rks, SOBOL_KITCHEN_SPP, "kitchen sobol",
        {"launches": ["trace_megakernel_seg"], "instantiations": ["SEG+K3+ALL+CPT"]})
    rel = abs(mean - k5_mean) / k5_mean
    out["kitchen"] = {"spp": SOBOL_KITCHEN_SPP, "wall_ms_per_pass": wall * 1e3 / SOBOL_KITCHEN_SPP,
                      "k5_launches": launches["trace_megakernel_seg"],
                      "k5_launches_per_pass": launches["trace_megakernel_seg"] / SOBOL_KITCHEN_SPP,
                      "image_mean": mean, "pcg_image_mean": k5_mean, "mean_rel_diff": rel,
                      "wall_ms_per_pass_turns": in_turns_ms(
                          {k: (lambda rr=rr: walls_per_pass(rr, SOBOL_KITCHEN_SPP))
                           for k, rr in (("pcg", rk), ("sobol", rks))})}
    log(f"[18] kitchen {rks.camera.width}x{rks.camera.height}x{SOBOL_KITCHEN_SPP}spp hybrid "
        f"Sobol: {wall * 1e3 / SOBOL_KITCHEN_SPP:.2f} ms per pass, launches {launches} {inst}, "
        f"mean {mean:.6f} against the pcg image's {k5_mean:.6f} (phase 6; {rel:.4f} relative); "
        f"wall ms per pass in turns {out['kitchen']['wall_ms_per_pass_turns']}")
    if rel > 0.02:
        raise SystemExit("kitchen sobol: the image mean is not within 2 % of the pcg image's")
    del rks
    # -- quality on cornell 256x256 against a pcg reference on K2
    sq, cq, _ = tts.cornell_box(QUALITY_SIZE, QUALITY_SIZE, device=dev)
    pq = ParsedScene(sq, cq, RenderingConfig(width=QUALITY_SIZE, height=QUALITY_SIZE, md=md,
                                             seed=0))
    ref = Renderer(pq, seed_offset=99).render(QUALITY_REF_SPP)
    imgs = {"pcg": Renderer(pq).render(QUALITY_SPP),
            "sobol": Renderer(pq, sampler="sobol").render(QUALITY_SPP),
            "uniform": Renderer(pq).render(ADAPTIVE_BUDGET),
            "adaptive": Renderer(pq).render_adaptive(ADAPTIVE_BUDGET)}
    mse = {k: float(((v - ref) ** 2).mean()) for k, v in imgs.items()}
    q = {"size": QUALITY_SIZE, "ref_spp": QUALITY_REF_SPP, "spp": QUALITY_SPP,
         "adaptive_budget": ADAPTIVE_BUDGET, "mse": mse,
         "sobol_over_pcg": mse["sobol"] / mse["pcg"],
         "adaptive_over_uniform": mse["adaptive"] / mse["uniform"],
         "mean_rel_diff": {k: abs(float(v.mean()) / float(ref.mean()) - 1.0)
                           for k, v in imgs.items()}}
    out["quality"] = q
    log(f"[18] quality, cornell {QUALITY_SIZE}x{QUALITY_SIZE} against {QUALITY_REF_SPP} pcg spp "
        f"on K2: MSE {mse}; Sobol/pcg at {QUALITY_SPP} spp {q['sobol_over_pcg']:.4f}, "
        f"adaptive/uniform at {ADAPTIVE_BUDGET} {q['adaptive_over_uniform']:.4f}")
    if max(q["mean_rel_diff"].values()) > QUALITY_MEAN_TOL or not all(np.isfinite(v).all()
                                                          for v in imgs.values()):
        raise SystemExit(f"quality: an image strays from the reference's mean: {q}")
    # -- adaptive at full width on cornell (K2 on the fused pack)
    ra = Renderer(r.parsed)
    wall, launches, inst, mean = counted_path(mk, lambda: ra.render_adaptive(ADAPTIVE_BUDGET), cam,
                                              "cornell adaptive", want_k2)
    n = ra.film.weight
    base = ADAPTIVE_BUDGET // 2
    lanes_per_round = (cam.width // 8) * (cam.height // 8) // 4 * 64
    rounds = (ADAPTIVE_BUDGET - base) * cam.width * cam.height // lanes_per_round
    cnt_rule = max(int(np.ceil(float(n.max()))), 2)
    a = {"budget": ADAPTIVE_BUDGET, "base_spp": base, "rounds": rounds,
         "lanes_per_round": lanes_per_round, "k2_launches": launches["trace_megakernel"],
         "n_mean": float(n.mean()), "n_max": float(n.max()), "film_count": ra.counter(),
         "count_rule": cnt_rule, "wall_ms": wall * 1e3, "image_mean": mean}
    ru = Renderer(r.parsed)
    a["wall_ms_turns"] = in_turns_ms(
        {"render": lambda: host_ms(lambda: (ru.reset_out_buffer(), ru.render(ADAPTIVE_BUDGET)))[1],
         "render_adaptive": lambda: host_ms(lambda: ra.render_adaptive(ADAPTIVE_BUDGET))[1]})
    out["adaptive"] = a
    log(f"[18] cornell adaptive {cam.width}x{cam.height}, budget {ADAPTIVE_BUDGET}: {a}")
    if (a["k2_launches"] != base + rounds or a["film_count"] != cnt_rule
            or abs(a["n_mean"] - ADAPTIVE_BUDGET) > 0.05 * ADAPTIVE_BUDGET):
        raise SystemExit("cornell adaptive: launches, counts or the film-count rule are off")
    # -- checkpoints: 2 spp, save, load into a fresh Renderer, 2 more spp
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    ck = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        for sampler in ("pcg", "sobol"):
            first = Renderer(r.parsed, sampler=sampler)
            first.render(CKPT_SPP)
            path = os.path.join(tmp, f"{sampler}.npz")
            first.save_checkpoint(path)
            resumed = Renderer(r.parsed, sampler=sampler)
            resumed.load_checkpoint(path)
            resumed.render(CKPT_SPP)
            straight = Renderer(r.parsed, sampler=sampler)
            straight.render(2 * CKPT_SPP)
            ck[sampler] = (resumed.counter() == straight.counter() == 2 * CKPT_SPP and all(
                torch.equal(getattr(resumed.film, k), getattr(straight.film, k))
                for k in ("mean", "m2", "weight")))
    out["checkpoint_bit_equal"] = ck
    log(f"[18] checkpoint after {CKPT_SPP} spp, resumed for {CKPT_SPP} more: bit-equal to "
        f"{2 * CKPT_SPP} straight spp {ck}")
    if not all(ck.values()):
        raise SystemExit("checkpoint: the resumed film differs from the straight one")
    return out


def phase_render_megakernel(mk, tk, tts, dev, kscene, kcam, ref_mean: float,
                            MaxDepthParams) -> tuple:
    """The reference's render_megakernel at full size, in the formats of its
    rule: cornell 1024x1024 x RM_CORNELL_SPP on binary f32 nodes (the
    whole-path kernel's K2+BIN) and full-size kitchen_stress 1024x1024 x
    RM_KITCHEN_SPP on bf16 binary nodes, t9 prims and bf16 attrs (K5's
    SEG+K3+ALL+BIN); per scene the kernel's time per spp on the rays of
    sample 0, its walk work, bound and share, a 65,536-lane block held to
    the plain version, and the binary walk against K1 on the camera rays."""
    import types

    md = MaxDepthParams()
    cscene, ccam, _ = tts.cornell_box(1024, 1024, device=dev)
    out = {}
    for label, scene, cam, spp, want, fmts in (
            ("cornell", cscene, ccam, RM_CORNELL_SPP,
             {"launches": ["trace_megakernel"], "instantiations": ["K2+BIN"]},
             ("f32", "f32", "f32")),
            ("kitchen", kscene, kcam, RM_KITCHEN_SPP,
             {"launches": ["trace_megakernel_seg"], "instantiations": ["SEG+K3+ALL+BIN"]},
             ("bf16", "t9", "bf16"))):
        t0 = time.perf_counter()
        pack = mk.make_pack(scene)
        pack_s = time.perf_counter() - t0
        if (pack.node_fmt, pack.prim_fmt, pack.attr_fmt) != fmts:
            raise SystemExit(f"{label}: make_pack(scene) gave {pack_formats(pack)}, not {fmts}")
        wall, launches, inst, mean = counted_path(
            mk, lambda: mk.render_megakernel(scene, cam, md, spp, seed=0), cam,
            f"render_megakernel {label}", want)
        n_launch = sum(launches.values())
        log(f"[11] render_megakernel {label} {cam.width}x{cam.height}x{spp}spp: {wall:.2f} s wall "
            f"({wall * 1e3 / spp:.2f} ms per spp, incl. make_pack {pack_s:.2f} s), launches "
            f"{launches} {inst}, image mean {mean:.6f}, pack {pack_formats(pack)} "
            f"({mk.pack_boxes(pack)} boxes: driver {mk.driver_of(pack)})")
        if label == "cornell" and abs(mean - ref_mean) > 0.02 * ref_mean:
            raise SystemExit("render_megakernel cornell: image mean disagrees with the plain "
                             "version's")
        view = types.SimpleNamespace(_pack=pack, camera=cam, device=dev)
        if label == "cornell":
            row = hold_main_path(mk, view, md, BLOCK, "11", "render_megakernel cornell",
                                 ab=True)
        else:
            row = hold_swf(mk, view, md, BLOCK, "11", "render_megakernel kitchen")
            row.pop("runs", None)
        row.pop("L")
        o, d, _, _ = main_rays(mk, view, BLOCK)
        row["walk_check"] = hold_walk_k1(mk, tk, scene, o.contiguous(), d.contiguous(), label)
        row["node_fetches"] = row["wide_nodes"]  # binary nodes: the count is of node fetches
        row.update({"launches": n_launch, "instantiations": inst,
                    "wall_ms_per_spp": wall * 1e3 / spp, "make_pack_s": pack_s,
                    "image_mean": mean, "spp": spp})
        out[label] = row
    return out["cornell"], out["kitchen"]


def phase_s1(mk, nb, tk, dev, scenes: dict) -> dict:
    """Kernel S1 (csrc/node_bench.cu) on the binary f32 rows of each scene:
    S1_ITERS steps on S1_RAYS rays (the reference's, every ray equal) and on
    a block of random rays, bit-equal to the plain version; its time at
    S1_ITERS and S1_ITERS / 2 steps (CUDA events) gives c_node, one step of
    the launch, and per node fetch (over the rays)."""
    torch.cuda.synchronize()
    mk.reset_launches()  # every count, S1's included (one dict)
    o, d = nb.reference_rays(S1_RAYS, dev)
    res = {}
    for label, scene in scenes.items():
        nodes = torch.as_tensor(tk.pack_nodes(scene.bvh), device=dev)
        out = nb.node_bench(nodes, o, d, S1_ITERS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = nb.node_bench_reference(nodes, o, d, S1_ITERS)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        rs = np.random.default_rng(29)
        lo = scene.bvh.node_min[0].cpu().numpy()
        hi = scene.bvh.node_max[0].cpu().numpy()
        o_r = torch.as_tensor(rs.uniform(lo, hi, (BLOCK, 3)).astype(np.float32), device=dev)
        d_r = torch.nn.functional.normalize(torch.as_tensor(
            rs.normal(size=(BLOCK, 3)).astype(np.float32), device=dev), dim=1).contiguous()
        out_r = nb.node_bench(nodes, o_r, d_r, S1_ITERS)
        ref_r = nb.node_bench_reference(nodes, o_r, d_r, S1_ITERS)
        torch.cuda.synchronize()
        differ = int((out.view(torch.int32) != ref.view(torch.int32)).sum())
        differ_r = int((out_r.view(torch.int32) != ref_r.view(torch.int32)).sum())
        err = float(torch.where(out == ref, 0.0, (out - ref).abs()).max())
        if differ or differ_r:
            raise SystemExit(f"S1 {label}: {differ} + {differ_r} rays differ from the plain version")
        parent = {}
        if parent_lib() is not None:
            p_out = with_parent(lambda: nb.node_bench(nodes, o, d, S1_ITERS))
            p_out_r = with_parent(lambda: nb.node_bench(nodes, o_r, d_r, S1_ITERS))
            parent["rays_differ"] = bit_differ(out, p_out) + bit_differ(out_r, p_out_r)
            log(f"[12] S1 {label}: rays whose output differs from the parent's kernel bit for "
                f"bit: {parent['rays_differ']}")
            if parent["rays_differ"]:
                raise SystemExit(f"S1 {label}: rays differ from the parent's kernel")
            parent["ms"] = in_turns(lambda: events_ms(
                lambda: nb.node_bench(nodes, o, d, S1_ITERS), 5), "12",
                f"S1 {label}, {S1_RAYS} rays x {S1_ITERS} steps")
            parent["c_node_us"] = in_turns(lambda: s1_c_node(nb, nodes, o, d), "12",
                                           f"S1 {label}, c_node", "us per step")
        t_n = events_ms(lambda: nb.node_bench(nodes, o, d, S1_ITERS), 5)
        t_h = events_ms(lambda: nb.node_bench(nodes, o, d, S1_ITERS // 2), 5)
        step_ms = (t_n - t_h) / (S1_ITERS - S1_ITERS // 2)
        fetch_ns = step_ms * 1e6 / S1_RAYS
        nbytes = nodes.numel() * 4 + S1_RAYS * (24 + 4)
        bound_ms, bound_by = bound(nbytes, S1_ITERS * S1_RAYS, 0, 1)
        res[label] = {"rows": nodes.shape[0], "ms": t_n, "half_ms": t_h, "plain_ms": plain_ms,
                      "c_node_step_ms": step_ms, "c_node_ns_per_fetch": fetch_ns,
                      "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
                      "rays": S1_RAYS, "iters": S1_ITERS, "parent": parent}
        log(f"[12] S1 {label} ({nodes.shape[0]} f32 node rows), {S1_RAYS} rays x {S1_ITERS} "
            f"steps: bit-equal to the plain version (and on {BLOCK} random rays); {t_n:.4f} ms "
            f"({S1_ITERS // 2} steps: {t_h:.4f} ms): c_node {step_ms * 1e3:.4f} us per step of "
            f"the launch, {fetch_ns:.5f} ns per node fetch; bound {bound_ms:.4f} ms "
            f"({bound_by}), {bound_ms / t_n:.4f} of bound; plain {plain_ms:.1f} ms")
    res["launches"] = nb.LAUNCHES["node_bench"]
    return res


def s1_c_node(nb, nodes, o, d) -> float:
    """S1's c_node in us per step of the launch: its time at S1_ITERS steps
    less its time at half of them, per step (events_ms, 5 launches each)."""
    t_n = events_ms(lambda: nb.node_bench(nodes, o, d, S1_ITERS), 5)
    t_h = events_ms(lambda: nb.node_bench(nodes, o, d, S1_ITERS // 2), 5)
    return (t_n - t_h) / (S1_ITERS - S1_ITERS // 2) * 1e3


def model_share(row: dict, c_fetch_ns: float, label: str) -> float:
    """S1's model of a kernel's time: its node fetches times c_node per
    fetch, over its measured time."""
    share = row["wide_nodes"] * c_fetch_ns * 1e-6 / row["ms"]
    log(f"[12] S1 model, {label}: {row['wide_nodes']} node fetches x {c_fetch_ns:.5f} ns = "
        f"{row['wide_nodes'] * c_fetch_ns * 1e-6:.4f} ms of the measured {row['ms']:.3f} ms: "
        f"{share:.4f}")
    return share


def bit_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def host_ms(fn) -> tuple:
    """(fn()'s result, its wall ms, synchronized on both ends): the plain
    versions' time, many launches each."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def counted_entry(mk, launches: dict, key: str, run) -> tuple:
    """run() (an entry's main()), counted; fails unless the entry launched
    its kernel (launches[key], the entry module's count). Returns (its
    rows, the launches)."""
    rows = counted(mk, run)[0]
    n = launches[key]
    if n == 0:
        raise SystemExit(f"{key}: the entry launched no kernel")
    return rows, n


def phase_s2(mk, ab, nb, tk, dev, kscene, cscene) -> dict:
    """Kernel S2 (csrc/extract_ab.cu): every tag bit-equal to its plain
    version on kitchen_stress's binary f32 rows, S2_HOLD_ITERS steps on two
    tiles of 8,192 lanes (the reference's equal rays, random rays around the
    scene); v0 = v1 = v2 per lane and v0 on the equal rays = S1; then the
    entry (ab.main) on one tile (the reference's shape) over kitchen's and
    cornell's rows, launches counted, and on CARD_LANES lanes over
    kitchen's."""
    from cuda_pt_torch.utils.timing import events_ms as launch_ms

    nodes = {name: torch.as_tensor(tk.pack_nodes(sc.bvh), device=dev)
             for name, sc in (("kitchen", kscene), ("cornell", cscene))}
    nk = nodes["kitchen"]
    lo = kscene.bvh.node_min[0].cpu().numpy() - 1.0
    hi = kscene.bvh.node_max[0].cpu().numpy() + 1.0
    o, d = s2_rays(nb, ab.TILE, ab.TILE, lo, hi, 31, dev)
    o_eq, d_eq = o[:ab.TILE], d[:ab.TILE]
    outs, plain, err = {}, {}, 0.0
    for tag in ab.TAGS:
        outs[tag] = ab.extract_ab(tag, nk, o, d, S2_HOLD_ITERS)
        ref, plain[tag] = host_ms(lambda: ab.extract_ab_reference(tag, nk, o, d, S2_HOLD_ITERS))
        err = max(err, float(torch.where(outs[tag] == ref, 0.0, (outs[tag] - ref).abs()).max()))
        if bit_differ(outs[tag], ref):
            raise SystemExit(f"S2 {tag}: {bit_differ(outs[tag], ref)} lanes differ from the "
                             "plain version")
    if bit_differ(outs["v0"], outs["v1"]) or bit_differ(outs["v0"], outs["v2"]):
        raise SystemExit("S2: v0, v1 and v2 differ per lane")
    s1 = nb.node_bench(nk, o_eq, d_eq, S2_HOLD_ITERS)
    if bit_differ(outs["v0"][:ab.TILE], s1):
        raise SystemExit("S2: v0 on equal rays differs from S1")
    hits = int((outs["v0"][ab.TILE:] != 0).sum())
    hold_ms = launch_ms(lambda: ab.extract_ab("v0", nk, o, d, S2_HOLD_ITERS), 3)
    # 128 tiles (one block per tile): a tile of equal rays, then random ones
    o_c, d_c = s2_rays(nb, ab.TILE, CARD_LANES - ab.TILE, lo, hi, 37, dev)
    sizes = {2: ab.cluster_size(2), CARD_LANES // ab.TILE: ab.cluster_size(CARD_LANES // ab.TILE)}
    parent_differ = {}
    for tag in ab.TAGS:
        out_c = ab.extract_ab(tag, nk, o_c, d_c, S2_CARD_HOLD_ITERS)
        ref_c = ab.extract_ab_reference(tag, nk, o_c, d_c, S2_CARD_HOLD_ITERS)
        if bit_differ(out_c, ref_c):
            raise SystemExit(f"S2 {tag}, {CARD_LANES // ab.TILE} tiles: {bit_differ(out_c, ref_c)} "
                             "lanes differ from the plain version")
        if parent_lib() is not None:
            p2 = with_parent(lambda: ab.extract_ab(tag, nk, o, d, S2_HOLD_ITERS))
            pc = with_parent(lambda: ab.extract_ab(tag, nk, o_c, d_c, S2_CARD_HOLD_ITERS))
            parent_differ[tag] = bit_differ(outs[tag], p2) + bit_differ(out_c, pc)
    log(f"[13] S2 on kitchen's {nk.shape[0]} f32 node rows, 2 tiles x {ab.TILE} lanes x "
        f"{S2_HOLD_ITERS} steps (a cluster of {sizes[2]} blocks per tile): all {len(ab.TAGS)} tags "
        f"bit-equal to the plain version (random tile: {hits} lanes with box hits); v0 = v1 = v2 "
        f"per lane; v0 = S1 on the equal rays; v0 {hold_ms:.3f} ms, plain {plain['v0']:.1f} ms; "
        f"{CARD_LANES // ab.TILE} tiles x {S2_CARD_HOLD_ITERS} steps (cluster size "
        f"{sizes[CARD_LANES // ab.TILE]}): every tag bit-equal to the plain version"
        + (f"; lanes differing from the parent's kernel, both shapes: {parent_differ}"
           if parent_differ else ""))
    if any(parent_differ.values()):
        raise SystemExit(f"S2: lanes differ from the parent's kernel: {parent_differ}")
    turns = {}
    if parent_lib() is not None:
        for tiles in (1, CARD_LANES // ab.TILE):
            o_t, d_t = nb.reference_rays(tiles * ab.TILE, dev)
            for tag in ab.MAIN_TAGS:
                turns.setdefault(str(tiles), {})[tag] = in_turns(
                    lambda: s2_c_node(ab, tag, nk, o_t, d_t), "13",
                    f"S2 {tag}, {tiles} tile(s) of equal rays, c_node", "ns per step")
    rows, launches = counted_entry(mk, ab.LAUNCHES, "extract_ab", lambda: ab.main(
        ["--tiles", "1", "--reps", "3"], nodes=nodes))
    card = ab.main(["--tiles", str(CARD_LANES // ab.TILE), "--reps", "3", "--scene", "kitchen"],
                   nodes=nodes)
    res = {"launches": launches, "max_abs_err": err, "hold_plain_ms": plain, "hold_ms": hold_ms,
           "hold_lanes": 2 * ab.TILE, "hold_iters": S2_HOLD_ITERS, "random_tile_hit_lanes": hits,
           "card_hold_iters": S2_CARD_HOLD_ITERS, "cluster_sizes": sizes,
           "parent_lanes_differ": parent_differ, "turns": turns}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, rs_ in (("reference", rows), ("card_scale", card)):
        lanes = ab.TILE * (1 if label == "reference" else CARD_LANES // ab.TILE)
        for r in rs_:
            if "variant" not in r:
                continue
            rows_b = nodes[r["scene"]].numel() * 4 + lanes * 28
            b_ms, b_by = bound(rows_b, ab.ITERS * lanes, 0, OPS_S2[r["variant"]] / OPS_SLAB)
            r.update(bound_ms=b_ms, bound_by=b_by, lanes=lanes)
            res.setdefault(label, {}).setdefault(r["scene"], {})[r["variant"]] = r
        for sc, tags in res[label].items():
            log(f"[13] S2 {label} ({lanes} lanes, {ab.ITERS} steps), {sc}: " + ", ".join(
                f"{t} {r['c_node_ns']:.1f} ns/step" for t, r in tags.items()))
    # worked out, not measured: one tile's operations at the card's peak on
    # one SM (a tile in one block) and on the SMs of its cluster
    for t, r in res["reference"]["kitchen"].items():
        one_sm = ab.ITERS * ab.TILE * OPS_S2[t] / (PEAK_F32_S / sms) * 1e3
        log(f"[13] S2 {t}, one tile: floor {one_sm:.4f} ms on one SM, {one_sm / r['cluster']:.4f} "
            f"ms on its cluster of {r['cluster']}, whole-card bound {r['bound_ms']:.4f} ms")
    return res


def s2_rays(nb, n_equal: int, n_random: int, lo, hi, seed: int, dev):
    """n_equal of the reference's equal rays, then n_random random rays with
    origins in [lo, hi] -> (o, d)."""
    o_eq, d_eq = nb.reference_rays(n_equal, dev)
    rs = np.random.default_rng(seed)
    o_r = torch.as_tensor(rs.uniform(lo, hi, (n_random, 3)).astype(np.float32), device=dev)
    d_r = torch.nn.functional.normalize(torch.as_tensor(
        rs.normal(size=(n_random, 3)).astype(np.float32), device=dev), dim=1)
    return torch.cat([o_eq, o_r]).contiguous(), torch.cat([d_eq, d_r]).contiguous()


def s2_c_node(ab, tag: str, nodes, o, d) -> float:
    """c_node of one S2 tag as its entry measures it: the launch at ab.ITERS
    steps less the launch at half of them, per step, in ns
    (utils/timing.events_ms, the median of 3 launches each)."""
    from cuda_pt_torch.utils.timing import events_ms as launch_ms

    t_n = launch_ms(lambda: ab.extract_ab(tag, nodes, o, d, ab.ITERS), 3)
    t_h = launch_ms(lambda: ab.extract_ab(tag, nodes, o, d, ab.ITERS // 2), 3)
    return (t_n - t_h) / (ab.ITERS - ab.ITERS // 2) * 1e6


def phase_s3(mk, lg, dev) -> dict:
    """Kernel S3 (csrc/lanegather.cu): every tag bit-equal to its plain
    version at the reference's (64, 128) x REPS and at (8192, 128) x 16; the
    check gather equal to torch.take_along_dim; with --parent every tag and
    the gather bit-equal to the parent's kernel, and the gather timed in
    turns with it, warm and cold; then the entry (lg.main) at 64 rows,
    launches counted, and at CARD_LANES / 128 rows; at both sizes the
    gather's time warm (its inputs left in L2 by the last launch) and cold
    (L2 flushed before each launch), an empty kernel on its grid (the
    launch floor), its plain version's and torch.take_along_dim's time
    (each launch timed alone, after a device sleep)."""
    from cuda_pt_torch.utils import timing

    flush = timing.flush_buffer(dev)
    res, err = {}, 0.0
    for label, rows, reps in (("reference", lg.ROWS, lg.REPS),
                              ("card_scale", CARD_LANES // lg.ROW, 16)):
        x, row, idx = lg.make_inputs(0, rows, dev)
        plain, parent_differ = {}, 0
        for tag in lg.TAGS:
            out = lg.lanegather(tag, x, row, idx, reps)
            ref, plain[tag] = host_ms(lambda: lg.lanegather_reference(tag, x, row, idx, reps))
            if bit_differ(out, ref):
                raise SystemExit(f"S3 {tag}, {rows} rows: {bit_differ(out, ref)} lanes differ "
                                 "from the plain version")
            if parent_lib() is not None:
                parent_differ += bit_differ(out, with_parent(
                    lambda: lg.lanegather(tag, x, row, idx, reps)))
        g = lg.gather(row, idx)
        idx64 = idx.long()
        rb = row.expand(rows, lg.ROW)
        lib = torch.take_along_dim(rb, idx64, dim=1)
        ref = lg.gather_reference(row, idx)
        if not torch.equal(g, lib) or not torch.equal(g, ref):
            raise SystemExit(f"S3 gather, {rows} rows: differs from torch.take_along_dim")
        err = max(err, float((g - ref).abs().max()))
        n = rows * lg.ROW
        b_ms, b_by = bound(n * 8 + lg.ROW * 4, 0, 0)
        gather = lambda: lg.gather(row, idx)  # noqa: E731
        res["hold_" + label] = h = {
            "lanes": n, "hold_reps": reps, "hold_plain_ms": plain,
            "gather_ms": timing.events_ms(gather, 5),
            "gather_cold_ms": timing.events_ms(gather, 5, flush=flush),
            "launch_floor_ms": timing.events_ms(lambda: lg.empty_launch(row, idx), 5),
            "gather_plain_ms": timing.events_ms(lambda: lg.gather_reference(row, idx), 5),
            "library_ms": timing.events_ms(lambda: torch.take_along_dim(rb, idx64, dim=1), 5),
            "library_cold_ms": timing.events_ms(
                lambda: torch.take_along_dim(rb, idx64, dim=1), 5, flush=flush),
            "bound_ms": b_ms, "bound_by": b_by}
        if parent_lib() is not None:
            parent_differ += bit_differ(g, with_parent(gather))
            log(f"[14] S3 at ({rows}, 128): lanes of the tags and the gather that differ from the "
                f"parent's kernel bit for bit: {parent_differ}")
            if parent_differ:
                raise SystemExit(f"S3, {rows} rows: lanes differ from the parent's kernel")
            h["parent"] = {
                "warm": in_turns(lambda: timing.events_ms(gather, 5), "14",
                                 f"S3 gather ({rows}, 128), warm"),
                "cold": in_turns(lambda: timing.events_ms(gather, 5, flush=flush), "14",
                                 f"S3 gather ({rows}, 128), cold")}
        log(f"[14] S3 at ({rows}, 128) x {reps}: every tag bit-equal to the plain version, "
            f"the gather equal to torch.take_along_dim; gather {h['gather_ms']:.6f} ms warm, "
            f"{h['gather_cold_ms']:.6f} cold, launch floor (an empty kernel on its grid) "
            f"{h['launch_floor_ms']:.6f}; plain {h['gather_plain_ms']:.6f}, take_along_dim "
            f"{h['library_ms']:.6f} warm, {h['library_cold_ms']:.6f} cold; bound {b_ms:.7f} ms "
            f"({b_by})")
    rows_ref, launches = counted_entry(mk, lg.LAUNCHES, "lanegather", lambda: lg.main([]))
    rows_card = lg.main(["--rows", str(CARD_LANES // lg.ROW)])
    for label, rows_, r_ in (("reference", rows_ref, lg.ROWS),
                             ("card_scale", rows_card, CARD_LANES // lg.ROW)):
        per = {r["tag"]: r["per_iter_ns"] for r in rows_ if "tag" in r}
        summary = next(r for r in rows_ if "summary" in r)
        res[label] = {"rows": r_, "per_iter_ns": per, "summary": summary}
        log(f"[14] S3 {label} ({r_}, 128) x {lg.REPS}: " + ", ".join(
            f"{t} {v:.2f}" for t, v in per.items()) + " ns/iter; per gather "
            f"{summary['g14_minus_e0_per']:.3f} ns (shuffle {summary['s14_minus_e0_per']:.3f}), "
            f"per select {summary['w112_minus_e0_per']:.3f} ns")
    res["launches"] = launches
    res["max_abs_err"] = err
    return res


def ab_s4(mx, path: str, dev) -> dict:
    """S4's mxu forms against the parent tree's (its library at path) on the
    same inputs, at 4,096 and at CARD_LANES rays x 2,000 leaves, in turns
    (parent, this, this, parent); each launch timed alone
    (utils/timing.events_ms). The parent's C entry takes a scratch argument
    where its library exports s4_mxuleaf_scratch (the wgmma kernel), none
    where it does not (the mma.sync kernel)."""
    import ctypes

    from cuda_pt_torch.ops import cuda_build as cb
    from cuda_pt_torch.utils.timing import events_ms as launch_ms

    lib = cb.open_library(path)
    fn = lib.s4_mxuleaf
    scratch_floats = getattr(lib, "s4_mxuleaf_scratch", None)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, P, I, P, P, P, I] + ([P] if scratch_floats else []) + [P]
    res = {}
    for label, rows in (("reference", mx.ROWS), ("card_scale", CARD_LANES // 128)):
        inp = mx.make_inputs(0, rows, mx.NLEAF, dev)
        o, d, coef = inp["o"], inp["d"], inp["coef"]
        n = o.shape[0]
        scratch = [] if scratch_floats is None else [
            torch.empty(scratch_floats(mx.NLEAF), dtype=torch.float32, device=dev)]
        row = {}
        for form in ("mxu", "mxu_1xtf32"):
            out = torch.empty(n, dtype=torch.float32, device=dev)

            def parent_run():
                rc = fn(mx.FORMS.index(form), coef.data_ptr(), mx.NLEAF, o.data_ptr(),
                        d.data_ptr(), out.data_ptr(), n, *[x.data_ptr() for x in scratch],
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise SystemExit(f"the parent's s4_mxuleaf failed: cudaError {rc}")

            ms = {"parent": [], "this": []}
            for who in ("parent", "this", "this", "parent"):
                run = parent_run if who == "parent" else (
                    lambda: mx.leaf_min_t(form, coef, o, d))
                ms[who].append(launch_ms(run, 3 if rows > mx.ROWS else 10))
            same = torch.equal(mx.leaf_min_t(form, coef, o, d).isfinite(), out.isfinite())
            row[form] = {"parent_ms": float(np.mean(ms["parent"])),
                         "ms": float(np.mean(ms["this"])), "runs_ms": ms,
                         "hit_mask_equal_parent": same}
            log(f"[15] S4 {form}, {n} rays x {mx.NLEAF} leaves: this tree {row[form]['ms']:.4f} "
                f"ms, the parent {row[form]['parent_ms']:.4f} ms, in turns (runs {ms}); hit "
                f"masks equal: {same}")
        res[label] = row
    return res


def phase_s4(mk, mx, dev, sass_job: dict) -> dict:
    """Kernel S4 (csrc/mxuleaf.cu): at the reference's 4,096 rays x 2,000
    leaves, scalar bit-equal to its plain version and mxu (3xTF32) within
    the script's parity contract (agree >= 0.999 on lanes finite in both,
    hit mask >= 0.999) against the plain product and against scalar; the
    1xTF32 A/B's hit mask >= 0.99; the same at CARD_LANES rays x
    S4_CARD_HOLD_LEAVES leaves; both mxu builds' SASS hold HGMMA (wgmma);
    with --parent, the parent's mxu forms timed on the same inputs (ab_s4);
    then the entry (mx.main) at 4,096 rays, launches counted, and at
    CARD_LANES rays; the batched torch.matmul of the product alone (f32,
    allow_tf32 False)."""
    from cuda_pt_torch.ops import cuda_build as cb
    from cuda_pt_torch.utils.timing import events_ms as launch_ms

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain product and the library call in f32
    res = {}
    for label, rays, nleaf in (("reference", mx.ROWS * 128, mx.NLEAF),
                               ("card_scale", CARD_LANES, S4_CARD_HOLD_LEAVES)):
        inp = mx.make_inputs(0, rays // 128, nleaf, dev)
        o, d = inp["o"], inp["d"]
        t_s = mx.leaf_min_t("scalar", inp["prow"], o, d)
        t_m = mx.leaf_min_t("mxu", inp["coef"], o, d)
        t_1 = mx.leaf_min_t("mxu_1xtf32", inp["coef"], o, d)
        ref_s, plain_s = host_ms(lambda: mx.scalar_reference(inp["prow"], o, d))
        ref_m, plain_m = host_ms(lambda: mx.mxu_reference(inp["coef"], o, d))
        if bit_differ(t_s, ref_s):
            raise SystemExit(f"S4 scalar, {rays} rays: {bit_differ(t_s, ref_s)} lanes differ "
                             "from the plain version")
        p_plain = mx.parity(ref_m.cpu().numpy(), t_m.cpu().numpy())
        p_scalar = mx.parity(t_s.cpu().numpy(), t_m.cpu().numpy())
        p_1x = mx.parity(ref_m.cpu().numpy(), t_1.cpu().numpy())
        for p in (p_plain, p_scalar):
            if p["agree_frac"] < 0.999 or p["hitmask_match"] < 0.999:
                raise SystemExit(f"S4 mxu, {rays} rays: outside the parity contract {p}")
        if p_1x["hitmask_match"] < 0.99:
            raise SystemExit(f"S4 mxu_1xtf32, {rays} rays: hit mask {p_1x}")
        fin = torch.isfinite(t_m) & torch.isfinite(ref_m)
        err = float((t_m[fin] - ref_m[fin]).abs().max()) if bool(fin.any()) else 0.0
        res["hold_" + label] = {"rays": rays, "nleaf": nleaf, "parity_plain": p_plain, "parity_scalar": p_scalar,
                     "parity_1xtf32": p_1x, "max_abs_err": err, "plain_scalar_ms": plain_s,
                     "plain_mxu_ms": plain_m, "hit_frac": float(torch.isfinite(t_s).float().mean())}
        log(f"[15] S4 {rays} rays x {nleaf} leaves: scalar bit-equal to the plain version; mxu "
            f"(3xTF32) agree {p_plain['agree_frac']:.6f} / hit mask {p_plain['hitmask_match']:.6f}"
            f" against the plain product, {p_scalar['agree_frac']:.6f} / "
            f"{p_scalar['hitmask_match']:.6f} against scalar, max |dt| {err:.3g}; 1xTF32 agree "
            f"{p_1x['agree_frac']:.6f}, hit mask {p_1x['hitmask_match']:.6f}; plain scalar "
            f"{plain_s:.1f} ms, mxu {plain_m:.1f} ms")
    sass = sass_job["read"](["leaf_mxu_kernel", "lanegather_kernelILi2E"])
    mma = {k: {op: v.get(op, 0) for op in ("HGMMA", "HMMA")} for k, v in sass.items()
           if k.startswith("leaf_mxu")}
    if not all(mma.get(f"leaf_mxu_kernel<{f}>", {}).get("HGMMA") for f in (0, 1)):
        raise SystemExit(f"S4: no HGMMA (wgmma) in mxu's SASS ({mma})")
    res["sass"] = {k: dict(v.most_common(8)) for k, v in sass.items()}
    log(f"[15] SASS: HGMMA and HMMA per kernel {mma}; the S3 select chains: " + "; ".join(
        f"{k} {dict(v.most_common(4))}" for k, v in sass.items() if k.startswith("lanegather")))
    parent = parent_lib()
    if parent is not None:
        res["parent"] = ab_s4(mx, parent, dev)
    rows_ref, launches = counted_entry(mk, mx.LAUNCHES, "mxuleaf", lambda: mx.main([]))
    rows_card = mx.main(["--rows", str(CARD_LANES // 128)])
    inp = mx.make_inputs(0, mx.ROWS, mx.NLEAF, dev)
    blocks = inp["coef"].reshape(mx.NLEAF, 32, 16)
    feat = mx.features(inp["o"], inp["d"])
    res["library_ms"] = launch_ms(lambda: torch.matmul(blocks, feat), 3)
    for label, rows_, rays in (("reference", rows_ref, mx.ROWS * 128),
                               ("card_scale", rows_card, CARD_LANES)):
        forms = {r["variant"]: r for r in rows_ if "variant" in r}
        work = rays * mx.NLEAF
        nbytes = mx.NLEAF * (128 + 32 * 16) * 4 + rays * 28
        t_b = nbytes / PEAK_BYTES_S
        t_f32 = work * mx.NP8 * OPS_MXU_EPI / PEAK_F32_S
        for form, t_ops in (("scalar", work * mx.NP8 * OPS_TRI / PEAK_F32_S),
                            ("mxu", max(t_f32, work * 3 * 2 * 32 * 16 / PEAK_TF32_S)),
                            ("mxu_1xtf32", max(t_f32, work * 2 * 32 * 16 / PEAK_TF32_S))):
            forms[form].update(bound_ms=max(t_b, t_ops) * 1e3, ms=forms[form]["sec"] * 1e3,
                               bound_by="bytes" if t_b > t_ops else "operations")
        res[label] = {"rays": rays, "forms": forms,
                      "parity": next(r for r in rows_ if r.get("check") == "parity"),
                      "parity_1xtf32": next(r for r in rows_ if r.get("check") == "parity_1xtf32")}
        log(f"[15] S4 {label} ({rays} rays x {mx.NLEAF} leaves): " + ", ".join(
            f"{f} {r['ms']:.4f} ms ({r['ns_per_leaf']:.2f} ns/leaf, bound {r['bound_ms']:.4f})"
            for f, r in forms.items()))
    log(f"[15] batched torch.matmul (2000, 32, 16) x (16, 4096) in f32, product only, no "
        f"epilogue: {res['library_ms']:.4f} ms")
    res["launches"] = launches
    return res


def s2_entry(s2: dict) -> dict:
    """The results line's S2 entry: v0 on kitchen's rows, one tile at the
    reference's steps; every tag and the card's scale beside it."""
    v0 = s2["reference"]["kitchen"]["v0"]
    pick = ("c_node_ns", "ms", "bound_ms", "cluster", "checksum")
    turns = {tiles: {tag: {k: r[k] for k in ("parent_ms", "this_ms")} for tag, r in tags.items()}
             for tiles, tags in s2["turns"].items()}
    v0_turns = s2["turns"].get("1", {}).get("v0")
    return {"name": "extract_ab (S2 v0, kitchen_stress f32 rows, one 8,192-lane tile)",
            "route": "cuda", "source": "cuda_pt_torch/csrc/extract_ab.cu",
            "replaces": "scripts/exp_extract_ab.py:232", "launches": s2["launches"],
            "max_abs_err": s2["max_abs_err"], "ms": v0["ms"], "plain_ms": s2["hold_plain_ms"]["v0"],
            "bound_ms": v0["bound_ms"], "bound_by": v0["bound_by"], "library_ms": None,
            "c_node_ns": v0["c_node_ns"], "hold_ms": s2["hold_ms"], "cluster": v0["cluster"],
            **({"parent_c_node_ns": v0_turns["parent_ms"], "this_c_node_ns": v0_turns["this_ms"]}
               if v0_turns else {}),
            "variants": {label: {sc: {t: {k: r[k] for k in pick} for t, r in tags.items()}
                                 for sc, tags in s2[label].items()}
                         for label in ("reference", "card_scale")},
            "turns_c_node_ns": turns, "cluster_sizes": s2["cluster_sizes"],
            "note": "ms: a launch of 30,000 steps; plain_ms and hold_ms: the plain version and "
                    "the kernel on the hold's 2 tiles x S2_HOLD_ITERS steps; launches: the "
                    "entry at the reference's shape; cluster: the blocks per tile the launch "
                    "took; turns_c_node_ns: ns per step of each tag, the parent's kernel and "
                    "this one in turns (--parent)"}


def s3_entry(s3: dict) -> dict:
    """The results line's S3 entry: the check gather at the reference's
    (64, 128) against torch.take_along_dim; the timed tags beside it."""
    ref, card = s3["hold_reference"], s3["hold_card_scale"]
    pick = ("gather_ms", "gather_cold_ms", "launch_floor_ms", "gather_plain_ms", "library_ms",
            "library_cold_ms", "bound_ms", "bound_by", "lanes")
    parent = {label: {w: {k: r[k] for k in ("parent_ms", "this_ms")} for w, r in h["parent"].items()}
              for label, h in (("reference", ref), ("card_scale", card)) if "parent" in h}
    return {"name": "lanegather (S3 gather, (64, 128))", "route": "cuda",
            "source": "cuda_pt_torch/csrc/lanegather.cu",
            "replaces": "scripts/exp_lanegather.py:57", "launches": s3["launches"],
            "max_abs_err": s3["max_abs_err"], "ms": ref["gather_ms"],
            "plain_ms": ref["gather_plain_ms"], "bound_ms": ref["bound_ms"],
            "bound_by": ref["bound_by"], "library_ms": ref["library_ms"],
            "cold_ms": ref["gather_cold_ms"], "launch_floor_ms": ref["launch_floor_ms"],
            "card_scale": {k: card[k] for k in pick}, "parent": parent,
            "per_iter_ns": {label: s3[label]["per_iter_ns"] for label in ("reference", "card_scale")},
            "summary": {label: s3[label]["summary"] for label in ("reference", "card_scale")},
            "note": "ms: one launch of the check form (kern_chk, :100), timed alone after a device "
                    "sleep, warm (its inputs in L2); cold_ms: L2 flushed before each launch; "
                    "launch_floor_ms: an empty kernel on the gather's grid; per_iter_ns: the "
                    "timed tags (:57), a launch over REPS; parent: the parent tree's gather "
                    "and this one's in turns (--parent)"}


def s4_entry(s4: dict) -> dict:
    """The results line's S4 entry: mxu (3xTF32) at the reference's 4,096
    rays x 2,000 leaves against the batched torch.matmul of its product;
    scalar, the 1xTF32 A/B and the card's scale beside it."""
    forms = s4["reference"]["forms"]
    held = s4["hold_reference"]
    pick = ("ms", "ns_per_leaf", "ns_per_prim_lane", "bound_ms", "bound_by")
    parent = s4.get("parent", {})
    return {"name": "mxuleaf (S4 mxu, 3xTF32 wgmma, 4,096 rays x 2,000 leaves)",
            "route": "cuda", "source": "cuda_pt_torch/csrc/mxuleaf.cu",
            "replaces": "scripts/exp_r5_mxuleaf.py:176", "launches": s4["launches"],
            "max_abs_err": held["max_abs_err"], "ms": forms["mxu"]["ms"],
            "plain_ms": held["plain_mxu_ms"], "bound_ms": forms["mxu"]["bound_ms"],
            "bound_by": forms["mxu"]["bound_by"], "library_ms": s4["library_ms"],
            "forms": {label: {f: {k: r[k] for k in pick} for f, r in s4[label]["forms"].items()}
                      for label in ("reference", "card_scale")},
            "parity": held["parity_plain"], "parity_scalar": held["parity_scalar"],
            "parity_1xtf32": held["parity_1xtf32"], "plain_scalar_ms": held["plain_scalar_ms"],
            "parent_ms": parent.get("reference", {}).get("mxu", {}).get("parent_ms"),
            "parent": parent,
            "note": "launches: wrapper calls, each two kernel launches (the split prologue, "
                    "then the product), both inside ms; library_ms: the batched torch.matmul "
                    "(2000, 32, 16) x (16, 4096) in f32 (allow_tf32 False), product only, no "
                    "epilogue; max_abs_err: mxu against the plain product on lanes finite in "
                    "both; parent: the parent tree's mxu on the same inputs, in turns "
                    "(--parent)"}


# ---- phase 19: scene input (the XML path: writer, parser, native builders) --

# views of the scenes phase 19 writes as XML (their testscenes cameras)
XML_VIEWS = {
    "cornell": {"origin": (0.5, 0.5, -1.35), "target": (0.5, 0.5, 0.5), "fov": 40.0},
    "kitchen": {"origin": (0.0, 7 * 0.85, -7 * 1.45), "target": (0.0, 0.3, 0.0), "fov": 55.0},
    "grid": {"origin": (0, 0.2, -4), "target": (0, 0, 0), "fov": 35.0},
}
# the presets the writer names for kitchen_stress's conductor and dielectric
XML_PRESETS = {"conductor": "Au", "dispersion": "Glass-BK7"}
# lanes of each phase-19 main path held per lane to its plain version, the
# samples per pixel of its renders (cut: spp only) and the random rays of
# the SBVH walk check
XML_BLOCK = 16384
XML_CORNELL_SPP = 16
XML_KITCHEN_SPP = 4
XML_SBVH_SPP = 2
SBVH_RAYS = 16384


def _xml_rgb(name: str, v) -> str:
    return f'<rgb name="{name}" value="{" ".join("%.9g" % float(c) for c in v)}"/>'


def _xml_float(name: str, v) -> str:
    return f'<float name="{name}" value="{"%.9g" % float(v)}"/>'


def write_obj(path: str, p: np.ndarray, n: np.ndarray, uv: np.ndarray) -> None:
    """Triangles (T, 3, 3) with their normals and uvs as an OBJ file: one v,
    vt and vn line per corner, printed with %.9g (an exact f32 round trip)."""
    v = p.reshape(-1, 3)
    lines = ["v %.9g %.9g %.9g" % tuple(r) for r in v]
    lines += ["vt %.9g %.9g" % tuple(r) for r in uv.reshape(-1, 2)]
    lines += ["vn %.9g %.9g %.9g" % tuple(r) for r in n.reshape(-1, 3)]
    lines += [f"f {i}/{i}/{i} {i + 1}/{i + 1}/{i + 1} {i + 2}/{i + 2}/{i + 2}"
              for i in range(1, len(v) + 1, 3)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_hdr(path: str, rgb: np.ndarray) -> None:
    """A float (H, W, 3) image as a flat RGBE Radiance file."""
    rgb = np.asarray(rgb, np.float64)[..., :3]
    v = rgb.max(axis=-1)
    m, e = np.frexp(v)
    scale = np.where(v > 1e-32, m * 256.0 / np.maximum(v, 1e-32), 0.0)
    rgbe = np.zeros(rgb.shape[:2] + (4,), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(v > 1e-32, e + 128, 0).astype(np.uint8)
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
                + rgbe.tobytes())


def write_nvdb_zip(path: str, dens: np.ndarray, bmin, bmax) -> None:
    """A (D, H, W) float grid as a ZIP-codec NanoVDB file of 8^3 leaves (all-zero
    leaves left out, as a sparse tree leaves them), in the layout
    media/nvdb.py reads: FileHeader, FileMetaData and name, then the
    compressed GridData (672 B), TreeData and the leaf segment."""
    import struct
    import zlib

    nz, ny, nx = (s // 8 for s in dens.shape)
    g = np.asarray(dens, np.float32).reshape(nz, 8, ny, 8, nx, 8)
    vals = g.transpose(4, 2, 0, 5, 3, 1).reshape(-1, 512)  # per leaf [x][y][z]
    bx, by, bz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    org = (np.stack([bx, by, bz], -1).reshape(-1, 3) * 8).astype(np.int32)
    keep = vals.any(axis=1)
    vals, org = vals[keep], org[keep]
    leaves = np.zeros((len(vals), 2144), np.uint8)
    leaves[:, :12] = org.view(np.uint8).reshape(-1, 12)
    leaves[:, 96:] = vals.view(np.uint8).reshape(-1, 2048)
    grid = bytearray(736)  # GridData (672 B) + TreeData (64 B)
    struct.pack_into("<4Q", grid, 672, 736, 0, 0, 0)  # leaf, lower, upper, root offsets
    body = bytes(grid) + leaves.tobytes()
    name = b"density\0"
    meta = bytearray(176)
    struct.pack_into("<QQQQ", meta, 0, len(body), len(body), 0, 512 * len(vals))
    struct.pack_into("<II", meta, 32, 1, 0)  # a float grid
    struct.pack_into("<6d", meta, 40, *np.asarray(bmin, float), *np.asarray(bmax, float))
    struct.pack_into("<6i", meta, 88, 0, 0, 0, 8 * nx - 1, 8 * ny - 1, 8 * nz - 1)
    struct.pack_into("<3d", meta, 112, 1.0, 1.0, 1.0)
    struct.pack_into("<I", meta, 136, len(name))
    struct.pack_into("<4I", meta, 140, len(vals), 0, 0, 1)
    comp = zlib.compress(body, 1)
    with open(path, "wb") as f:
        f.write(struct.pack("<QIHH", 0x304244566F6E614E, 32 << 21, 1, 1) + bytes(meta) + name
                + struct.pack("<Q", len(comp)) + comp)


def write_scene_xml(T, b, d: str, name: str, view: dict, size: int, rtype: str = "pt",
                    use_sbvh: bool = False) -> str:
    """The scene of SceneBuilder b as <d>/<name>.xml, a Mitsuba-style file
    that scene/xml_parser.py reads (the elements of the three scenes phase
    19 writes: meshes, area and envmap emitters, grid media): one OBJ file
    per object, textures used
    as diffuse maps as 8-bit sRGB PNG (utils/image.save_png; the parser
    linearizes them back), an envmap's texture as a flat RGBE .hdr, grid
    media as ZIP-codec .nvdb (albedo = sigma_s: the parser's
    sigma_a = 1 - albedo), GGX conductors and dispersive dielectrics under
    XML_PRESETS' names. Returns the path."""
    from cuda_pt_torch.utils.image import save_png

    brdf = {T.BSDF_LAMBERTIAN: "lambertian", T.BSDF_SPECULAR: "specular",
            T.BSDF_TRANSLUCENT: "det-refraction", T.BSDF_PLASTIC: "plastic",
            T.BSDF_PLASTIC_FORWARD: "plastic-forward", T.BSDF_GGX_CONDUCTOR: "conductor-ggx",
            T.BSDF_DISPERSION: "dispersion", T.BSDF_FORWARD: "forward",
            T.BSDF_GGX_DIELECTRIC: "rough-dielectric", T.BSDF_OREN_NAYAR: "oren-nayar"}
    emitter = {T.EMITTER_AREA: "area", T.EMITTER_ENVMAP: "envmap"}
    phase = {T.PHASE_ISOTROPIC: "isotropic", T.PHASE_HG: "hg", T.PHASE_DUAL_HG: "dual-hg",
             T.PHASE_RAYLEIGH: "rayleigh", T.PHASE_SGGX: "sggx"}
    out = [f'<scene version="1.2">', f'<renderer type="{rtype}"/>',
           f'<accelerator type="bvh"><bool name="use_sbvh" value="{str(use_sbvh).lower()}"/>'
           '</accelerator>']
    env_tex = {e.tex_id for e in b.emitters if e.etype == T.EMITTER_ENVMAP and e.tex_id >= 0}
    for tid, img in enumerate(b.textures):
        if tid in env_tex:
            write_hdr(os.path.join(d, f"{name}_tex{tid}.hdr"), img)
            out.append(f'<texture id="tex{tid}"><string name="emission" '
                       f'value="{name}_tex{tid}.hdr"/></texture>')
        else:
            x = np.clip(img[..., :3], 0.0, 1.0)
            srgb = np.where(x <= 0.0031308, 12.92 * x, 1.055 * x ** (1 / 2.4) - 0.055)
            save_png(os.path.join(d, f"{name}_tex{tid}.png"), srgb)
            out.append(f'<texture id="tex{tid}"><string name="diffuse" '
                       f'value="{name}_tex{tid}.png"/></texture>')
    for i, m in enumerate(b.media):
        out.append(f'<phase type="{phase[m.phase_type]}" id="ph{i}">'
                   + _xml_float("g", m.phase_g[0]) + _xml_float("g2", m.phase_g[1])
                   + _xml_float("weight", m.phase_w) + "</phase>")
        if m.mtype != T.MEDIUM_GRID:
            raise ValueError("the writer takes grid media only")
        gr = b.grids[m.grid_id]
        write_nvdb_zip(os.path.join(d, f"{name}_grid{i}.nvdb"), gr["density"], gr["bbox_min"],
                       gr["bbox_max"])
        out.append(f'<medium type="grid" id="med{i}">{_xml_rgb("albedo", m.sigma_s)}'
                   f'<string name="density" value="{name}_grid{i}.nvdb"/>'
                   f'{_xml_float("scale", m.scale)}<ref type="phase" id="ph{i}"/></medium>')
    for i, s in enumerate(b.bsdfs):
        k_d = (s.ior,) * 3 if s.btype == T.BSDF_TRANSLUCENT else s.k_d  # the parser's ior
        body = (_xml_rgb("k_d", k_d) + _xml_rgb("k_s", s.k_s) + _xml_rgb("k_g", s.k_g)
                + _xml_float("ior", s.ior) + _xml_float("roughness_x", s.roughness_x)
                + _xml_float("roughness_y", s.roughness_y) + _xml_float("thickness", s.thickness))
        if s.btype == T.BSDF_GGX_CONDUCTOR:
            body += f'<string name="conductor" value="{XML_PRESETS["conductor"]}"/>'
        if s.btype == T.BSDF_DISPERSION:
            body += f'<string name="type" value="{XML_PRESETS["dispersion"]}"/>'
        if s.btype in (T.BSDF_PLASTIC, T.BSDF_PLASTIC_FORWARD):
            body += _xml_rgb("sigma_a", s.k)
        if any(t >= 0 for t in s.tex_ids[1:]):
            raise ValueError("the writer takes diffuse textures only")
        if s.tex_ids[0] >= 0:
            body += f'<ref type="texture" id="tex{s.tex_ids[0]}"/>'
        out.append(f'<brdf type="{brdf[s.btype]}" id="m{i}">{body}</brdf>')
    for i, e in enumerate(b.emitters[1:], 1):
        body = _xml_rgb("emission", e.emission) + _xml_float("scaler", e.scaler)
        if e.etype == T.EMITTER_ENVMAP:
            body += (_xml_float("scale", e.extra[0])
                     + _xml_float("azimuth", np.rad2deg(e.extra[1]))
                     + _xml_float("zenith", np.rad2deg(e.extra[2])))
        if e.tex_id >= 0:
            body += f'<ref type="texture" id="tex{e.tex_id}"/>'
        out.append(f'<emitter type="{emitter[e.etype]}" id="e{i}">{body}</emitter>')
    for i, ob in enumerate(b.objects):
        refs = f'<ref type="material" id="m{ob.bsdf_id}"/>'
        if ob.emitter_id:
            refs += f'<ref type="emitter" id="e{ob.emitter_id}"/>'
        if ob.medium_in >= 0:
            refs += f'<ref type="medium" id="med{ob.medium_in}"/>'
        refs += f'<bool name="cullable" value="{str(bool(ob.cullable)).lower()}"/>'
        if ob.is_sphere:
            raise ValueError("the writer takes triangle meshes only")
        write_obj(os.path.join(d, f"{name}_{i}.obj"), ob.p, ob.n, ob.uv)
        out.append(f'<shape type="obj"><string name="filename" value="{name}_{i}.obj"/>{refs}'
                   "</shape>")
    lookat = " ".join(f'{k}="{", ".join("%.9g" % c for c in view[k])}"' for k in ("origin",
                                                                                   "target"))
    out.append(f'<sensor type="perspective">{_xml_float("fov", view["fov"])}'
               f'<transform name="toWorld"><lookat {lookat} up="0, 1, 0"/></transform>'
               f'<film type="hdrfilm"><integer name="width" value="{size}"/>'
               f'<integer name="height" value="{size}"/></film></sensor>')
    out.append("</scene>")
    path = os.path.join(d, f"{name}.xml")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    return path


def _tri_rows(scene) -> np.ndarray:
    """A scene's triangles as sorted rows (p0, e1, e2): a multiset to compare."""
    rows = torch.cat([scene.geom.p0, scene.geom.e1, scene.geom.e2], dim=1).cpu().numpy()
    return rows[np.lexsort(rows.T[::-1])]


def _geometry_in(T, p: np.ndarray, nodes: dict, dev):
    """(Geometry, BVHArrays) of triangles p (N, 3, 3) in a builder's output
    order (nodes["order"], with SBVH duplicates), normals and uvs zero."""
    order = nodes["order"]
    p0 = p[order, 0]
    e1, e2 = p[order, 1] - p0, p[order, 2] - p0
    z3 = torch.zeros((len(order), 3), device=dev)
    z2 = torch.zeros((len(order), 2), device=dev)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    geom = T.Geometry(p0=t(p0), e1=t(e1), e2=t(e2), n0=z3, n1=z3, n2=z3, uv0=z2, uv1=z2,
                      uv2=z2, obj_idx=torch.zeros(len(order), dtype=torch.int32, device=dev),
                      is_sphere=torch.zeros(len(order), dtype=torch.bool, device=dev))
    bvh = T.BVHArrays(**{k: torch.as_tensor(nodes[k], device=dev)
                         for k in ("node_min", "node_max", "node_skip", "node_base",
                                   "node_count")}, max_leaf=4)
    return geom, bvh


def scene_input_builds(d: str, kb) -> dict:
    """(a) The three host libraries (g++, the reference's flags): available,
    and a fresh build of all three at once timed; the OBJ parsers, native
    and Python, on kitchen_stress's files (written here first)."""
    from cuda_pt_torch.accel import native
    from concurrent.futures import ThreadPoolExecutor

    from cuda_pt_torch.scene import native_obj, obj_loader
    from cuda_pt_torch.utils import host_build

    srcs = [(native._SRC, ()), (native._SRC_SBVH, ("-pthread",)), (native_obj._SRC, ())]
    # the package's libraries (built already where phase 3 compiled a scene),
    # then a fresh build of all three into d at once, timed: a first call's cost
    paths = [host_build.build(*a) for a in srcs]
    if not (native.available() and native.sbvh_available() and native_obj.available()):
        raise SystemExit("a native host library is unavailable")

    def fresh(a):
        out = os.path.join(d, os.path.basename(host_build.library_path(*a)))
        subprocess.run(["g++", *host_build.FLAGS, *a[1], "-o", out, a[0]], check=True,
                       capture_output=True, timeout=300)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        list(ex.map(fresh, srcs))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i, ob in enumerate(kb.objects):
        write_obj(os.path.join(d, f"kitchen_{i}.obj"), ob.p, ob.n, ob.uv)
    write_s = time.perf_counter() - t0
    files = [os.path.join(d, f"kitchen_{i}.obj") for i in range(len(kb.objects))]
    mb = sum(os.path.getsize(f) for f in files) / 2 ** 20
    times = {}
    for native_ in (True, False):
        t0 = time.perf_counter()
        meshes = [obj_loader.load_obj(f, native=native_) for f in files]
        times["native" if native_ else "python"] = time.perf_counter() - t0
        for ob, m in zip(kb.objects, meshes):
            if not np.array_equal(m["p"], ob.p):
                raise SystemExit("an OBJ file did not read back its triangles bit for bit")
    names = [os.path.basename(p) for p in paths]
    log(f"[19a] host libraries built afresh, at once, in {build_s:.2f} s ({names}); "
        f"kitchen_stress as {len(files)} OBJ files ({mb:.1f} MiB, written in {write_s:.1f} s): "
        f"native parser {times['native']:.3f} s, Python parser {times['python']:.3f} s "
        f"({times['python'] / times['native']:.1f}x); positions read back bit for bit")
    return {"host_build_s": build_s, "obj_files": len(files), "obj_mib": mb,
            "obj_native_s": times["native"], "obj_python_s": times["python"]}


def scene_input_bvh(T, kb, dev) -> dict:
    """(b) Full-size kitchen_stress: the NumPy SAH build against the native
    one (seconds, SAH cost, nodes), the SBVH (seconds, duplicated refs,
    nodes), and on SBVH_RAYS random rays the SBVH walk's closest original
    prim held to the BVH's (equal except on exact ties)."""
    from cuda_pt_torch.accel import bvh_build, native, traverse

    p = np.concatenate([ob.p for ob in kb.objects]).astype(np.float32)
    p0, e1, e2 = p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    sph = np.zeros(len(p), bool)
    bounds = bvh_build.prim_bounds(p0, e1, e2, sph)
    out, trees = {"prims": len(p)}, {}
    for key, run in (("numpy", lambda: bvh_build.build_bvh(*bounds, use_native=False)),
                     ("native", lambda: native.build_bvh_native(*bounds)),
                     ("sbvh", lambda: native.build_sbvh_native(p0, e1, e2, sph,
                                                               dup_budget_frac=1.0))):
        t0 = time.perf_counter()
        trees[key] = run()
        out[key] = {"s": time.perf_counter() - t0, "nodes": int(len(trees[key]["node_min"])),
                    "sah_cost": bvh_build.sah_cost(trees[key])}
    out["sbvh"]["dup_refs"] = int(len(trees["sbvh"]["order"]) - len(p))
    rs = np.random.default_rng(19)
    lo, hi = trees["native"]["node_min"][0], trees["native"]["node_max"][0]
    o = torch.as_tensor(rs.uniform(lo, hi, (SBVH_RAYS, 3)).astype(np.float32), device=dev)
    dd = rs.normal(size=(SBVH_RAYS, 3)).astype(np.float32)
    d = torch.as_tensor(dd / np.linalg.norm(dd, axis=1, keepdims=True), device=dev)
    hits = {}
    for key in ("native", "sbvh"):
        geom, bvh = _geometry_in(T, p, trees[key], dev)
        h = traverse.closest_hit_bvh(geom, bvh, o, d)
        order = torch.as_tensor(trees[key]["order"], device=dev)
        hits[key] = (torch.where(h["prim"] >= 0, order[h["prim"].clamp(min=0)], -1), h["t"])
    differ = hits["native"][0] != hits["sbvh"][0]
    ties = differ & (hits["native"][0] >= 0) & (hits["native"][1] == hits["sbvh"][1])
    bad = int((differ & ~ties).sum())
    out["walk"] = {"rays": SBVH_RAYS, "differ": int(differ.sum()), "exact_ties": int(ties.sum()),
                   "hits": int((hits["sbvh"][0] >= 0).sum())}
    n, nb, s = out["numpy"], out["native"], out["sbvh"]
    log(f"[19b] kitchen_stress ({len(p)} triangles): SAH build NumPy {n['s']:.2f} s against "
        f"native {nb['s']:.3f} s ({n['s'] / nb['s']:.1f}x); SAH cost {n['sah_cost']:.4f} / "
        f"{nb['sah_cost']:.4f}, nodes {n['nodes']} / {nb['nodes']}; SBVH {s['s']:.3f} s, "
        f"{s['dup_refs']} duplicated refs, {s['nodes']} nodes, SAH cost {s['sah_cost']:.4f}; "
        f"walks on {SBVH_RAYS} random rays: {out['walk']['differ']} closest prims differ, "
        f"{out['walk']['exact_ties']} on exact ties, {bad} otherwise")
    if bad:
        raise SystemExit(f"SBVH walk: {bad} closest prims differ from the BVH's off exact ties")
    return out


def scene_input_xml(mk, T, d: str, kb, kscene, kcam, k2_mean: float, k5_mean: float,
                    k5_wall: float, Renderer) -> dict:
    """(c) cornell_box and kitchen_stress written as XML and rendered through
    Renderer(path, override_res=(1024, 1024)): cornell on K2, kitchen on K5;
    the parsed triangles held to the builder's as multisets and the parsed
    cameras to the builder's bit for bit; a block of
    each main path's rays held per lane to the plain version. (d) the SBVH
    kitchen (override_accel) through the Renderer on K5, held likewise."""
    from cuda_pt_torch.core.config import MaxDepthParams
    from cuda_pt_torch.scene import testscenes as tts
    from cuda_pt_torch.scene import xml_parser

    md = MaxDepthParams()
    cs, ccam, cb_ = tts.cornell_box(1024, 1024)
    paths = {"cornell": write_scene_xml(T, cb_, d, "cornell", XML_VIEWS["cornell"], 512),
             "kitchen": write_scene_xml(T, kb, d, "kitchen", XML_VIEWS["kitchen"], 512)}
    out, renderers = {}, {}
    for key, ref_scene, ref_cam, ref_mean, spp, want in (
            ("cornell", cs, ccam, k2_mean, XML_CORNELL_SPP, None),
            ("kitchen", kscene, kcam, k5_mean, XML_KITCHEN_SPP,
             {"launches": ["trace_megakernel_seg"], "instantiations": ["SEG+K3+ALL+CPT"]})):
        t0 = time.perf_counter()
        r = Renderer(paths[key], override_res=(1024, 1024))
        load_s = time.perf_counter() - t0
        if not np.array_equal(_tri_rows(r.scene), _tri_rows(ref_scene)):
            raise SystemExit(f"XML {key}: the parsed triangles are not the builder's")
        if not all(torch.equal(getattr(r.camera, f).cpu(), getattr(ref_cam, f).cpu())
                   for f in ("R", "t", "focal")):
            raise SystemExit(f"XML {key}: the parsed camera is not the builder's")
        info = r.info()
        if want is None:
            want = {"launches": ["trace_megakernel"],
                    "instantiations": ["K2+STAGE" if mk.stages(r._pack) else "K2"]}
        wall, launches, inst, mean = render_main_path(mk, r, spp, f"XML {key}", want)
        hold = (hold_main_path if key == "cornell" else hold_swf)(mk, r, md, XML_BLOCK, "19c",
                                                                  f"XML {key}")
        hold.pop("L")
        hold.pop("runs", None)
        out[key] = {"load_s": load_s, "wall_ms_per_spp": wall * 1e3 / spp, "spp": spp,
                    "launches": launches, "instantiations": inst, "image_mean": mean,
                    "builder_mean": ref_mean, "driver": info["driver"],
                    "num_prims": info["num_prims"], "hold": hold}
        log(f"[19c] XML {key} ({info['num_prims']} prims, parsed and compiled in {load_s:.2f} s; "
            f"driver {info['driver']}): {wall * 1e3 / spp:.2f} ms per spp over {spp} spp, "
            f"launches {launches} {inst}, image mean {mean:.6f} (the builder's scene in phase "
            f"{5 if key == 'cornell' else 6}: {ref_mean:.6f}; presets and 8-bit textures differ, "
            "no bound)")
        renderers[key] = r
    # (d) the SBVH kitchen
    t0 = time.perf_counter()
    r = Renderer(xml_parser.load_xml(paths["kitchen"], override_res=(1024, 1024),
                                     override_accel={"use_sbvh": True}))
    load_s = time.perf_counter() - t0
    n_refs = r.scene.geom.num_prims
    wall, launches, inst, mean = render_main_path(
        mk, r, XML_SBVH_SPP, "XML kitchen SBVH",
        {"launches": ["trace_megakernel_seg"], "instantiations": ["SEG+K3+ALL+CPT"]})
    hold = hold_swf(mk, r, md, XML_BLOCK, "19d", "XML kitchen SBVH")
    hold.pop("L")
    hold.pop("runs", None)
    out["sbvh"] = {"load_s": load_s, "prim_refs": n_refs, "bvh_nodes": r.scene.bvh.num_nodes,
                   "wall_ms_per_spp": wall * 1e3 / XML_SBVH_SPP, "launches": launches,
                   "image_mean": mean, "hold": hold}
    log(f"[19d] XML kitchen SBVH ({n_refs} prim refs, {r.scene.bvh.num_nodes} nodes; parsed and "
        f"compiled in {load_s:.2f} s): {wall * 1e3 / XML_SBVH_SPP:.2f} ms per spp against the "
        f"SAH tree's {out['kitchen']['wall_ms_per_spp']:.2f} (phase 6, builder's scene: "
        f"{k5_wall:.2f}); K5 {hold['ms']:.3f} ms per spp against "
        f"{out['kitchen']['hold']['ms']:.3f}; launches {launches}, image mean {mean:.6f}")
    return out, renderers["kitchen"], paths


def scene_input_auto(mk, rk, cornell_path: str, Renderer) -> dict:
    """(e) traversal="auto" on the XML kitchen: each candidate's time, the
    pick, then one 1-spp pass with it; and on the XML cornell (8,192 prims
    or fewer) "mxu" timed beside the walks."""
    from cuda_pt_torch.accel import autotune

    torch.cuda.synchronize()
    mk.reset_launches()
    t0 = time.perf_counter()
    r = Renderer(rk.parsed, traversal="auto")
    tune_s = time.perf_counter() - t0
    tune_launches = {k: v for k, v in mk.LAUNCHES.items() if v}
    # the Renderer's tuning, from the cache (its key: the scene before K1's
    # forest was attached)
    res = autotune.autotune_traversal(dataclasses.replace(r.scene, forest=None))
    pick = r.info()["traversal"]
    want = {"launches": ["traverse_forest"] if pick == "pallas" else [], "instantiations": []}
    wall, launches, _, mean = render_main_path(mk, r, 1, "XML kitchen auto", want)
    rc = Renderer(cornell_path, override_res=(64, 64), traversal="auto")
    cres = autotune.autotune_traversal(dataclasses.replace(rc.scene, forest=None))
    if not (res["cached"] and cres["cached"]):
        raise SystemExit("auto: the Renderer's tuning is not the cached one")
    out = {"timings_ms": res["timings_ms"], "impl": res["impl"], "traversal": pick,
           "tune_s": tune_s, "tune_launches": tune_launches, "pass_ms": wall * 1e3,
           "pass_launches": launches, "image_mean": mean,
           "mxu_eligible": "mxu" in res["timings_ms"],
           "cornell": {"timings_ms": cres["timings_ms"], "impl": cres["impl"]}}
    log(f"[19e] traversal auto on the XML kitchen: candidates (ms) {res['timings_ms']}, pick "
        f"{res['impl']} (tuned in {tune_s:.1f} s, launches {tune_launches}); mxu "
        f"{'eligible' if out['mxu_eligible'] else 'not eligible (more than 8,192 prims)'}; "
        f"one 1-spp pass {wall * 1e3:.1f} ms, launches {launches}, mean {mean:.6f}; on the XML "
        f"cornell: {cres['timings_ms']} -> {cres['impl']}")
    if not np.isfinite(cres["timings_ms"].get("mxu", np.inf)):
        raise SystemExit("auto: mxu is not timed on the XML cornell")
    if not np.isfinite(res["timings_ms"][res["impl"]]) or \
            (pick == "pallas" and launches.get("traverse_forest", 0) <= 0):
        raise SystemExit("auto: no finite pick, or the K1 pick launched no K1")
    return out


def scene_input_grid(mk, T, d: str, Renderer) -> dict:
    """(f) grid_smoke's GRID_N^3 grid as a ZIP-codec .nvdb in an XML scene,
    rendered VOLUME_PT at 1 spp through Renderer(path) on K6 (the split
    driver), held per lane as phase 8 does."""
    from cuda_pt_torch.core.config import MaxDepthParams
    from cuda_pt_torch.scene import testscenes as tts

    _, _, gb = tts.grid_smoke(8, 8, n=GRID_N)
    t0 = time.perf_counter()
    path = write_scene_xml(T, gb, d, "grid", XML_VIEWS["grid"], 512, rtype="vpt")
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = Renderer(path, override_res=(1024, 1024))
    load_s = time.perf_counter() - t0
    info = r.info()
    if info["renderer"] != "vpt" or info["driver"] != "swf_split":
        raise SystemExit(f"XML grid: not VOLUME_PT on the split driver: {info}")
    if not torch.equal(r.scene.grids.density[0].cpu(), torch.as_tensor(gb.grids[0]["density"])):
        raise SystemExit("XML grid: the .nvdb did not read back the grid bit for bit")
    wall, launches, inst, mean = render_main_path(
        mk, r, 1, "XML grid", {"launches": ["trace_megakernel_seg", "traverse_resolve"],
                               "instantiations": ["SEG+SHADE+ALL+MED+GRID"]})
    hold = hold_swf(mk, r, MaxDepthParams(), XML_BLOCK, "19f", "XML grid")
    hold.pop("L")
    hold.pop("runs", None)
    mib = os.path.getsize(path.replace(".xml", "_grid0.nvdb")) / 2 ** 20
    log(f"[19f] XML grid ({GRID_N}^3 grid as a {mib:.1f} MiB ZIP .nvdb, written in {write_s:.1f} "
        f"s, parsed and compiled in {load_s:.1f} s): VOLUME_PT 1 spp {wall * 1e3:.1f} ms, "
        f"launches {launches} {inst}, image mean {mean:.6f}")
    return {"nvdb_mib": mib, "write_s": write_s, "load_s": load_s, "wall_ms": wall * 1e3,
            "launches": launches, "instantiations": inst, "image_mean": mean, "hold": hold}


def phase_scene_input(mk, dev, kb, kscene, kcam, k2_mean: float, k5: dict, Renderer) -> dict:
    """Phase 19: scene input without JAX, (a)-(f)."""
    import tempfile

    from cuda_pt_torch.scene import types as T

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as d:
        out = {"builds": scene_input_builds(d, kb), "bvh": scene_input_bvh(T, kb, dev)}
        xml, rk, paths = scene_input_xml(mk, T, d, kb, kscene, kcam, k2_mean,
                                         k5["image_mean"], k5["wall_ms_per_spp"], Renderer)
        out["xml"] = xml
        out["auto"] = scene_input_auto(mk, rk, paths["cornell"], Renderer)
        del rk
        out["grid"] = scene_input_grid(mk, T, d, Renderer)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[19] scene input: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 20: the volume path tracer's last routes, ray counts, distributed
# ---------------------------------------------------------------------------

SMOKE_BOX = ((-2.5, 1.2, -2.5), (2.5, 4.2, 2.5))  # the grid's container in full kitchen
SMOKE_BOX_SMALL = ((-1.0, 0.9, -1.0), (1.0, 2.0, 1.0))  # in kitchen_stress(grid=2)
GRID_EMISSION = 4.0  # the grid medium's emission_scale
HOLD_DEPTH = 8  # (a)'s SMALL^2 hold: max_depth cut from 16 to stay under a minute
GRID_EST_SIZE = 256
ABSORBER_SPP = 4
GRID_EST_SPP = 1  # grid_smoke, each route (cut: spp)
DIST_FUSED_SIZE = 1024
DIST_FUSED_SPP = 16
DIST_VPT_SIZE = 512
DIST_VPT_SPP = 2
DIST_TRAIN_SIZE = 256
DIST_TRAIN_DEPTH = 4  # the training step's max_depth (cut from 16: autograd memory)
DIST_TIMEOUT = 600
# the torchrun entry in (e)'s gloo pair (phase 21 (e)): side and spp
ENTRY_SIZE = 64
ENTRY_SPP = 4


def _cube(tts, lo, hi):
    """The 6 quads of the box [lo, hi] (grid_smoke's container)."""
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    q = tts.quad
    return np.concatenate([
        q([x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0]),
        q([x1, y0, z1], [x0, y0, z1], [x0, y1, z1], [x1, y1, z1]),
        q([x0, y0, z1], [x0, y0, z0], [x0, y1, z0], [x0, y1, z1]),
        q([x1, y0, z0], [x1, y0, z1], [x1, y1, z1], [x1, y1, z0]),
        q([x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1]),
        q([x0, y0, z1], [x1, y0, z1], [x1, y0, z0], [x0, y0, z0])], axis=0)


def add_smoke(tts, T, b, n: int, lo, hi, emission_scale: float = GRID_EMISSION) -> None:
    """grid_smoke's medium in builder b: an n^3 soft-sphere density (sigma
    4, albedo 0.9) with the same sphere as its temperature field, in a null
    (forward, cullable) box [lo, hi]."""
    from cuda_pt_torch.scene.builder import BSDFSpec, MediumSpec

    g = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    r = np.sqrt(g[:, None, None] ** 2 + g[None, :, None] ** 2 + g[None, None, :] ** 2)
    gid = b.add_grid((np.maximum(0.0, 1.0 - r) * 4.0).astype(np.float32), lo, hi,
                     emission=np.clip(1.0 - r, 0.0, 1.0).astype(np.float32))
    med = b.add_medium(MediumSpec(mtype=T.MEDIUM_GRID, grid_id=gid, sigma_s=(0.9, 0.9, 0.9),
                                  scale=1.0, emission_scale=emission_scale))
    b.add_mesh(_cube(tts, lo, hi), b.add_bsdf(BSDFSpec(btype=T.BSDF_FORWARD)), medium_in=med,
               cullable=True)


def _parsed(scene, cam, md, RenderingConfig, ParsedScene):
    return ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height, md=md,
                                                   seed=0))


def grid_route(mk, tk, tts, dev, kb, kcam, T, MaxDepthParams, RendererType, RenderingConfig,
               ParsedScene, Renderer) -> dict:
    """(a): the composed grid route at full width, then the SMALL^2 hold."""
    import copy

    b = copy.deepcopy(kb)
    add_smoke(tts, T, b, GRID_N, *SMOKE_BOX)
    t0 = time.perf_counter()
    scene = b.compile(device=dev)
    build_s = time.perf_counter() - t0
    md = MaxDepthParams()
    if mk.megakernel_ok(scene, md, renderer="vpt"):
        raise SystemExit("[20] the emissive grid under an envmap is inside the fused envelope")
    r = Renderer(_parsed(scene, kcam, md, RenderingConfig, ParsedScene),
                 renderer=RendererType.VOLUME_PT, traversal="pallas")
    info = r.info()
    if (info["driver"], info["traversal"], info["has_grid"]) != ("composed", "pallas", True):
        raise SystemExit(f"[20] grid route: not the composed route on K1: {info}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    wall, launches, _, mean = render_main_path(
        mk, r, 1, "composed grid route", {"launches": ["traverse_forest"], "instantiations": []})
    peak = peak_mib(dev, base)
    B = kcam.width * kcam.height

    def one_pass():
        return r._composed_band(0, B, 0)

    # K1 over a timed and a counted pass (k1_main_path), the aten operators
    # of both counted alike: the profiler's count of this pass's device
    # launches takes minutes
    with aten_ops() as ops:
        k1_run = k1_main_path(tk, r.scene.forest, one_pass, "20", "one composed grid pass")
    k1_run.pop("calls")
    n_ops = ops["n"] // 2
    log(f"[20] (a) kitchen_stress + a {GRID_N}^3 emissive grid (built in {build_s:.1f} s), "
        f"VOLUME_PT traversal=pallas {kcam.width}x{kcam.height}x1spp: {wall:.2f} s wall, "
        f"launches {launches}, K1 {k1_run['ms']:.3f} ms summed over {k1_run['launches']} "
        f"launches, {n_ops} PyTorch operators (aten) per pass, image mean {mean:.6f}, peak "
        f"{peak:.0f} MiB above the scene")
    # the hold: the same grid in small kitchen, "pallas" against "xla" per lane
    scene_s, cam_s, bs = tts.kitchen_stress(SMALL, SMALL, grid=2, ns=6, nt=4)
    add_smoke(tts, T, bs, GRID_N, *SMOKE_BOX_SMALL)
    parsed = _parsed(bs.compile(device=dev), cam_s.to(dev), MaxDepthParams(max_depth=HOLD_DEPTH),
                     RenderingConfig, ParsedScene)
    imgs, ms, launched = {}, {}, {}
    for trav in ("pallas", "xla"):
        rr = Renderer(parsed, renderer=RendererType.VOLUME_PT, traversal=trav)
        torch.cuda.synchronize()
        mk.reset_launches()
        t0 = time.perf_counter()
        imgs[trav] = rr.render_raw().reshape(-1, 3)
        torch.cuda.synchronize()
        ms[trav] = (time.perf_counter() - t0) * 1e3
        launched[trav] = {k: v for k, v in mk.LAUNCHES.items() if v}
    frac, dmean = check_contract("[20] grid route pallas against xla", imgs["pallas"],
                                 imgs["xla"])
    if set(launched["pallas"]) != {"traverse_forest"} or launched["xla"]:
        raise SystemExit(f"[20] grid hold launched {launched}, K1 expected only under pallas")
    log(f"[20] (a) hold, kitchen_stress(grid=2) + the grid {SMALL}x{SMALL}x1spp, max_depth "
        f"{HOLD_DEPTH}: pallas against xla {frac:.7f} lanes differ, means differ by {dmean:.3g}; "
        f"{launched['pallas']['traverse_forest']} K1 launches; {ms['pallas']:.0f} / "
        f"{ms['xla']:.0f} ms")
    return {"wall_s": wall, "k1_launches": launches["traverse_forest"], "k1": k1_run,
            "aten_ops_per_pass": n_ops, "image_mean": mean, "peak_mib": peak,
            "build_s": build_s, "grid_n": GRID_N,
            "hold": {"lanes_differ": frac, "mean_differ": dmean, "max_depth": HOLD_DEPTH,
                     "k1_launches": launched["pallas"]["traverse_forest"],
                     "pass_ms_pallas": ms["pallas"], "pass_ms_xla": ms["xla"]}}


def absorber_scene(tts, T, kind: str, size: int, dev, sig: float = 2.0):
    """tests/test_fused_grid.py's slab between a floor and a ceiling light,
    out of the camera's frustum: kind "grid" (a constant zero-albedo grid),
    "hom" (the equivalent homogeneous absorber), "vac" (null faces round a
    sigma = 0 medium) or "none" (no slab)."""
    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.scene.builder import BSDFSpec, EmitterSpec, MediumSpec, SceneBuilder

    b = SceneBuilder()
    white = b.add_bsdf(BSDFSpec(k_d=(0.7, 0.7, 0.7)))
    em = b.add_emitter(EmitterSpec(etype=T.EMITTER_AREA, emission=(1, 1, 1), scaler=6.0))
    q = tts.quad
    b.add_mesh(q([-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1]), white, emitter_id=em)
    lo, hi = (-1.0, 0.2, -1.0), (1.0, 1.2, 1.0)
    if kind != "none":
        if kind == "grid":
            gid = b.add_grid(np.full((8, 8, 8), sig, np.float32), lo, hi)
            med = b.add_medium(MediumSpec(mtype=T.MEDIUM_GRID, grid_id=gid, scale=1.0))
        else:
            sa = sig if kind == "hom" else 0.0
            med = b.add_medium(MediumSpec(sigma_a=(sa, sa, sa), scale=1.0))
        b.add_mesh(_cube(tts, lo, hi), b.add_bsdf(BSDFSpec(btype=T.BSDF_FORWARD)),
                   medium_in=med, cullable=True)
    b.add_mesh(q([-3, -1.2, -3], [3, -1.2, -3], [3, -1.2, 3], [-3, -1.2, 3]), white)
    cam = cam_mod.make_camera((0, -0.2, -4.0), (0, -1.2, -0.3), fov=22, width=size,
                              height=size, device=dev)
    return b.compile(device=dev), cam


def grid_estimators(mk, tts, dev, T, MaxDepthParams, RendererType, RenderingConfig,
                    ParsedScene, Renderer) -> dict:
    """(b): the absorber, the null slab, grid_smoke composed against split."""
    from cuda_pt_torch.models import path_tracer as pt
    from cuda_pt_torch.models import volume_pt

    md = MaxDepthParams(max_depth=1, max_volume=8)
    n = GRID_EST_SIZE
    means = {k: float(volume_pt.render(*absorber_scene(tts, T, k, n, dev), md, ABSORBER_SPP,
                                       seed=0).mean()) for k in ("hom", "grid", "vac")}
    means["none"] = float(pt.render(*absorber_scene(tts, T, "none", n, dev), md, ABSORBER_SPP,
                                    seed=0).mean())
    absorber = abs(means["hom"] - means["grid"]) / means["hom"]
    null_slab = abs(means["vac"] - means["none"]) / means["none"]
    log(f"[20] (b) {n}x{n}x{ABSORBER_SPP}spp, max_depth 1: absorber grid {means['grid']:.6f} "
        f"against the homogeneous slab {means['hom']:.6f} ({absorber:.4f} relative); the sigma=0 "
        f"null slab {means['vac']:.6f} against the slab-free render {means['none']:.6f} "
        f"({null_slab:.4f})")
    if not (means["hom"] > 1e-4 and absorber < 0.02 and means["none"] > 1e-3
            and null_slab < 0.12):
        raise SystemExit(f"[20] grid estimators outside the reference's bounds: {means}")
    scene, cam, _ = tts.grid_smoke(n, n, n=GRID_N, device=dev)
    parsed = _parsed(scene, cam, MaxDepthParams(), RenderingConfig, ParsedScene)
    imgs, walls, launched = {}, {}, {}
    for route, trav in (("split", None), ("composed", "xla")):
        r = Renderer(parsed, renderer=RendererType.VOLUME_PT, traversal=trav)
        want = "swf_split" if route == "split" else "composed"
        if r.info()["driver"] != want:
            raise SystemExit(f"[20] grid_smoke {route}: driver {r.info()['driver']}")
        torch.cuda.synchronize()
        mk.reset_launches()
        t0 = time.perf_counter()
        imgs[route] = r.render(GRID_EST_SPP)
        torch.cuda.synchronize()
        walls[route] = time.perf_counter() - t0
        launched[route] = {k: v for k, v in mk.LAUNCHES.items() if v}
    m_split, m_comp = float(imgs["split"].mean()), float(imgs["composed"].mean())
    rel = abs(m_split - m_comp) / max(m_comp, 1e-6)
    log(f"[20] (b) grid_smoke {n}x{n}x{GRID_EST_SPP}spp ({GRID_N}^3): split route (K6 + K5) "
        f"mean {m_split:.6f} in {walls['split']:.2f} s, launches {launched['split']}; composed "
        f"route {m_comp:.6f} in {walls['composed']:.2f} s; {rel:.4f} relative")
    if rel >= 0.2 or not np.isfinite(imgs["composed"]).all():
        raise SystemExit(f"[20] grid_smoke composed against split: {rel} relative")
    if set(launched["split"]) != {"trace_megakernel_seg", "traverse_resolve"} \
            or launched["composed"]:
        raise SystemExit(f"[20] grid_smoke launched {launched}")
    return {"absorber_means": {k: means[k] for k in ("hom", "grid")}, "absorber_rel": absorber,
            "null_slab_means": {k: means[k] for k in ("vac", "none")}, "null_slab_rel": null_slab,
            "grid_smoke": {"split_mean": m_split, "composed_mean": m_comp, "rel": rel,
                           "split_wall_s": walls["split"], "composed_wall_s": walls["composed"],
                           "split_launches": launched["split"]}}


def pallas_scene(scene):
    """The scene on traversal "pallas" with its BVH as K1's one chunk."""
    from cuda_pt_torch.models import path_tracer as pt

    return dataclasses.replace(scene, traversal="pallas",
                               forest=pt.pallas_forest(dataclasses.replace(scene, forest=None)))


def compaction(mk, tk, vscene, vcam, MaxDepthParams) -> dict:
    """(c): medium_cbox on K1, compact=False and True."""
    from cuda_pt_torch.models import volume_pt

    scene = pallas_scene(vscene)
    md = MaxDepthParams()
    imgs, rows = {}, {}
    for compact in (False, True):
        with k1_calls(tk) as calls:
            torch.cuda.synchronize()
            mk.reset_launches()
            t0 = time.perf_counter()
            imgs[compact] = volume_pt.render(scene, vcam, md, 1, seed=0, compact=compact)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {k: v for k, v in mk.LAUNCHES.items() if v}
        lanes = [c["lanes"] for c in calls if c["lanes"]]
        if set(launched) != {"traverse_forest"} or launched["traverse_forest"] != len(lanes):
            raise SystemExit(f"[20] compaction={compact}: launched {launched}, lanes {lanes}")
        rows[str(compact)] = {"wall_s": wall, "k1_launches": len(lanes), "k1_lanes": lanes,
                              "k1_lanes_sum": sum(lanes)}
        log(f"[20] (c) medium_cbox VOLUME_PT on K1 {vcam.width}x{vcam.height}x1spp, "
            f"compact={compact}: {wall:.2f} s wall, {len(lanes)} K1 launches, live lanes per "
            f"launch {lanes}")
    a, b = imgs[True].reshape(-1, 3), imgs[False].reshape(-1, 3)
    frac, dmean = check_contract("[20] compacted against uncompacted", a, b)
    bits = int((a != b).any(dim=-1).sum())
    log(f"[20] (c) compacted against uncompacted: {frac:.7f} lanes outside the contract, {bits} "
        f"not bit-equal, means differ by {dmean:.3g}")
    return {"uncompacted": rows["False"], "compacted": rows["True"], "lanes_differ": frac,
            "lanes_not_bit_equal": bits, "mean_differ": dmean}


def ray_counts(mk, tk, dev, kscene, kcam, vscene, vcam, MaxDepthParams) -> dict:
    """(d): count_rays on kitchen_stress (K1) and medium_cbox, each held to
    the per-lane sum of the render's own streams."""
    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core import qmc
    from cuda_pt_torch.models import path_tracer as pt
    from cuda_pt_torch.models import volume_pt

    md = MaxDepthParams()
    out = {}
    for name, mod, scene, cam in (("kitchen_stress", pt, pallas_scene(kscene), kcam),
                                  ("medium_cbox", volume_pt, pallas_scene(vscene), vcam)):
        torch.cuda.synchronize()
        mk.reset_launches()
        t0 = time.perf_counter()
        n = mod.count_rays(scene, cam, md, 1, seed=0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k1 = mk.LAUNCHES["traverse_forest"]
        lane = torch.arange(cam.width * cam.height, device=dev)
        o, d, rng = cam_mod.generate_rays(cam, lane, qmc.make_state("pcg", 0, lane, 0))
        wl_u = pt.wl_stratum_u(0, 0, lane)
        if mod is pt:  # the render's state, uncompacted
            held = int(pt.trace_paths_final(scene, md, o, d, rng, wl_u=wl_u).rays.sum())
        else:  # the compacted render's lanes, permuted: the sum must not change
            held = int(volume_pt.trace_paths_final(scene, md, o, d, rng, compact=True,
                                                   wl_u=wl_u)[0].rays.sum())
        if n != held or k1 == 0:
            raise SystemExit(f"[20] count_rays {name}: {n} against the render's {held}, "
                             f"{k1} K1 launches")
        out[name] = {"rays": n, "seconds": secs, "rays_per_s": n / secs, "k1_launches": k1,
                     "lanes": cam.width * cam.height}
        log(f"[20] (d) count_rays {name} {cam.width}x{cam.height}x1spp on K1: {n} rays "
            f"({n / (cam.width * cam.height):.3f} per pixel) in {secs:.3f} s, "
            f"{n / secs / 1e6:.3f} Mrays/s, {k1} K1 launches; equal to the render's per-lane sum")
    return out


def _dist_inputs(tts, dev, MaxDepthParams):
    """(e)'s scenes, alike in the parent and the workers: cornell
    DIST_FUSED_SIZE^2 with its w8 pack (K2), medium_cbox DIST_VPT_SIZE^2 on K1,
    cornell DIST_TRAIN_SIZE^2."""
    from cuda_pt_torch.ops import megakernel as mk

    scene, cam, _ = tts.cornell_box(DIST_FUSED_SIZE, DIST_FUSED_SIZE, device=dev)
    vscene, vcam, _ = tts.medium_cbox(DIST_VPT_SIZE, DIST_VPT_SIZE, device=dev)
    tscene, tcam, _ = tts.cornell_box(DIST_TRAIN_SIZE, DIST_TRAIN_SIZE, device=dev)
    return {"fused": (scene, cam, mk.make_pack(scene, node_fmt="w8"), MaxDepthParams()),
            "vpt": (pallas_scene(vscene), vcam, MaxDepthParams()),
            "train": (tscene, tcam, MaxDepthParams(max_depth=DIST_TRAIN_DEPTH))}


def dist_worker(rank: int, world: int, port: int, out: str, backend: str,
                device: str = "cuda") -> int:
    """One rank of (e): every distributed case on the card (device), its
    images, gradients and figures under out (rank 0 writes the images)."""
    import torch.distributed as dist

    from cuda_pt_torch.core.config import MaxDepthParams
    from cuda_pt_torch.ops import megakernel as mk
    from cuda_pt_torch.parallel import distributed as pdist
    from cuda_pt_torch.scene import testscenes as tts

    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":  # before the mesh: both ranks share the one card
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    tag = f"{backend}{world}_rank{rank}"
    rows = {}
    try:
        inp = _dist_inputs(tts, dev, MaxDepthParams)
        arrays = {}
        scene, cam, pack, md = inp["fused"]
        for sp in ((1, 2) if world == 2 else (1,)):
            mesh = pdist.make_mesh(sp=sp, device_type=dev.type)
            torch.cuda.synchronize()
            mk.reset_launches()
            t0 = time.perf_counter()
            img = pdist.render_distributed(scene, cam, md, DIST_FUSED_SPP, mesh, renderer="fused",
                                           fused_pack=pack)
            torch.cuda.synchronize()
            rows[f"fused_sp{sp}"] = {"wall_s": time.perf_counter() - t0,
                                     "launches": {k: v for k, v in mk.LAUNCHES.items() if v},
                                     "instantiations": dict(mk.INSTANTIATION_LAUNCHES),
                                     "mean": float(img.mean())}
            arrays[f"fused_sp{sp}"] = img
        mesh = pdist.make_mesh(sp=1, device_type=dev.type)
        if world == 2:
            vs, vc, vmd = inp["vpt"]
            torch.cuda.synchronize()
            mk.reset_launches()
            t0 = time.perf_counter()
            img = pdist.render_distributed(vs, vc, vmd, DIST_VPT_SPP, mesh, renderer="vpt")
            torch.cuda.synchronize()
            rows["vpt"] = {"wall_s": time.perf_counter() - t0,
                           "launches": {k: v for k, v in mk.LAUNCHES.items() if v},
                           "mean": float(img.mean())}
            arrays["vpt"] = img
        ts, tc, tmd = inp["train"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = pdist.render_train_step(ts, tc, tmd,
                                              torch.zeros((tc.height, tc.width, 3), device=dev),
                                              mesh, spp=1, remat=True)
        torch.cuda.synchronize()
        rows["train"] = {"wall_s": time.perf_counter() - t0, "loss": float(loss)}
        arrays.update({f"grad_{k}": g for k, g in grads.items()})
        arrays["loss"] = loss
        if world == 2:
            rows["entry"] = dist_entry(rank, out)
        # every rank its loss and gradients, rank 0 its images too
        np.savez(os.path.join(out, f"{tag}.npz"),
                 **{k: v.detach().cpu().numpy() for k, v in arrays.items()
                    if rank == 0 or k.startswith("grad_") or k == "loss"})
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"{tag}.json"), "w") as f:
        json.dump(rows, f)
    return 0


def dist_entry(rank: int, out: str) -> dict:
    """(e) the torchrun entry on this group with --multihost (the spawner
    set the multi-node variables on this one host) at ENTRY_SIZE^2; then
    --tensorboard: run where torch.utils.tensorboard imports, else the
    entry must stop at once naming the package."""
    from cuda_pt_torch import distributed_render

    try:
        import torch.utils.tensorboard  # noqa: F401
        has_tb = True
    except ImportError:
        has_tb = False
    tb_dir = os.path.join(out, "tb")
    args = ["--xml", os.path.join(out, "entry.xml"), "--spp", str(ENTRY_SPP), "--sp", "2",
            "--width", str(ENTRY_SIZE), "--height", str(ENTRY_SIZE), "--report-interval", "1",
            "--out", os.path.join(out, f"entry_rank{rank}.png"), "--multihost"]
    t0 = time.perf_counter()
    distributed_render.main(args + (["--tensorboard", tb_dir] if has_tb else []))
    row = {"wall_s": time.perf_counter() - t0, "multihost": True,
           "local_rank": os.environ["LOCAL_RANK"], "tensorboard": has_tb}
    if has_tb:
        row["tensorboard_files"] = sorted(os.listdir(tb_dir)) if rank == 0 else []
    else:
        try:
            distributed_render.main(args + ["--tensorboard", tb_dir])
        except SystemExit as e:
            row["tensorboard_error"] = str(e)
        else:
            raise SystemExit("--tensorboard without the package did not stop the entry")
    return row


def _spawn_ranks(worlds: dict, out: str) -> dict:
    """Run worlds[backend] --dist-worker processes of this script per
    backend, all at once on the card (each backend its own group); the wall
    seconds per group. Fails if any rank fails; stops them all on the way
    out."""
    import socket

    jobs = []
    for backend, world in worlds.items():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        for r in range(world):
            # each rank's output to a file: a full pipe would stall a rank inside a collective
            jobs.append((backend, world, r, port,
                         os.path.join(out, f"{backend}{world}_rank{r}.log")))
    t0 = time.perf_counter()
    procs, walls = [], {}
    try:
        for backend, world, r, port, path in jobs:
            # torchrun's multi-node variables, set by hand on this one host (the
            # entry's --multihost)
            env = dict(os.environ, LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                       GROUP_RANK="0")
            with open(path, "w") as f:
                procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                               "--dist-worker", str(r), str(world), str(port),
                                               out, backend], stdout=f, stderr=subprocess.STDOUT,
                                              env=env))
        for (backend, world, *_), p in zip(jobs, procs):
            p.wait(timeout=DIST_TIMEOUT)
            walls[f"{backend}{world}"] = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (backend, world, r, _, path), p in zip(jobs, procs):
        if p.returncode != 0:
            with open(path) as f:
                raise SystemExit(f"[20] {backend} rank {r} of {world} failed:\n{f.read()[-4000:]}")
    return walls


def distributed(mk, tts, dev, MaxDepthParams) -> dict:
    """(e): two gloo ranks on the one card and one NCCL rank, held to the
    single-process renders and gradients of the same streams."""
    import tempfile

    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core import qmc
    from cuda_pt_torch.models import path_tracer as pt
    from cuda_pt_torch.models import volume_pt
    from cuda_pt_torch.parallel import distributed as pdist

    from cuda_pt_torch.scene import types as T

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as out:
        _, _, b = tts.cornell_box(ENTRY_SIZE, ENTRY_SIZE)
        write_scene_xml(T, b, out, "entry", XML_VIEWS["cornell"], ENTRY_SIZE)
        spawn = _spawn_ranks({"gloo": 2, "nccl": 1}, out)
        entry_png = os.path.exists(os.path.join(out, "entry_rank0.png"))
        res = {k: np.load(os.path.join(out, f"{k}.npz"))
               for k in ("gloo2_rank0", "gloo2_rank1", "nccl1_rank0")}
        res = {k: {a: v[a] for a in v.files} for k, v in res.items()}
        rows = {k: json.load(open(os.path.join(out, f"{k}.json")))
                for k in ("gloo2_rank0", "gloo2_rank1", "nccl1_rank0")}
    inp = _dist_inputs(tts, dev, MaxDepthParams)
    # the single-process references on the same streams
    scene, cam, pack, md = inp["fused"]
    lane = torch.arange(cam.width * cam.height, device=dev)
    acc = torch.zeros((lane.shape[0], 3), device=dev)
    for i in range(DIST_FUSED_SPP):
        o, d, rng = cam_mod.generate_rays(cam, lane, qmc.make_state("pcg", 0, lane, i))
        acc = acc + mk.trace_megakernel(pack, md, o, d, rng)
    want = (acc / DIST_FUSED_SPP).reshape(cam.height, cam.width, 3).cpu().numpy()
    g0 = res["gloo2_rank0"]
    held = {"fused_dp2_bits_differ": int((g0["fused_sp1"] != want).any(axis=-1).sum()),
            "nccl1_bits_differ": int((res["nccl1_rank0"]["fused_sp1"] != want).any(axis=-1).sum()),
            "fused_sp2_max_rel": float(np.max(np.abs(g0["fused_sp2"] - want)
                                              / np.maximum(np.abs(want), 1e-7)))}
    if held["fused_dp2_bits_differ"] or held["nccl1_bits_differ"] or not np.allclose(
            g0["fused_sp2"], want, rtol=1e-5, atol=1e-7):
        raise SystemExit(f"[20] distributed fused against the single-process kernel: {held}")
    vs, vc, vmd = inp["vpt"]
    v_want = volume_pt.render(vs, vc, vmd, DIST_VPT_SPP, seed=0).reshape(-1, 3)
    frac, dmean = check_contract("[20] distributed vpt (compacted) against the uncompacted "
                                 "single-process render",
                                 torch.as_tensor(g0["vpt"], device=dev).reshape(-1, 3), v_want)
    held.update({"vpt_lanes_differ": frac, "vpt_mean_differ": dmean})
    ts, tc, tmd = inp["train"]
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in pdist.diff_params(ts).items()}
    img = pt.render(pdist.with_params(ts, params), tc, tmd, 1, differentiable=True)
    loss = torch.mean(img ** 2)
    loss.backward()
    worst = 0.0
    for tag in ("gloo2_rank0", "gloo2_rank1", "nccl1_rank0"):
        r = res[tag]
        if not np.allclose(r["loss"], float(loss.detach()), rtol=1e-4):
            raise SystemExit(f"[20] train step {tag}: loss {r['loss']} against {float(loss)}")
        for k, p in params.items():
            g = p.grad.cpu().numpy() if p.grad is not None else np.zeros(tuple(p.shape))
            got = r[f"grad_{k}"]
            if not np.allclose(got, g, rtol=1e-4, atol=1e-7):
                raise SystemExit(f"[20] train step {tag}: gradient {k} off the single-process")
            if tag == "gloo2_rank1" and not np.array_equal(got, res["gloo2_rank0"][f"grad_{k}"]):
                raise SystemExit(f"[20] train step: gradient {k} differs between the ranks")
            worst = max(worst, float(np.max(np.abs(got - g))))
    held["train_grad_max_abs_err"] = worst
    entry = [rows[f"gloo2_rank{k}"]["entry"] for k in (0, 1)]
    tb_ok = (entry[0]["tensorboard"] and any("tfevents" in f for f in entry[0]["tensorboard_files"])
             or not entry[0]["tensorboard"] and all("tensorboard package" in e.get(
                 "tensorboard_error", "") for e in entry))
    if not (entry_png and tb_ok and [e["local_rank"] for e in entry] == ["0", "1"]):
        raise SystemExit(f"[20] the torchrun entry with --multihost / --tensorboard: {entry}")
    held["entry"] = entry
    k2_dp2 = rows["gloo2_rank0"]["fused_sp1"]["launches"].get("trace_megakernel", 0)
    k2_sp2 = rows["gloo2_rank0"]["fused_sp2"]["launches"].get("trace_megakernel", 0)
    k1_vpt = rows["gloo2_rank0"]["vpt"]["launches"].get("traverse_forest", 0)
    if not (k2_dp2 == DIST_FUSED_SPP and k2_sp2 == DIST_FUSED_SPP // 2 and k1_vpt > 0):
        raise SystemExit(f"[20] distributed launches: K2 {k2_dp2} / {k2_sp2}, K1 {k1_vpt}")
    for tag, row in rows.items():
        log(f"[20] (e) {tag}: " + ", ".join(f"{k} {v['wall_s']:.2f} s" for k, v in row.items()))
    log(f"[20] (e) / [21] (e) the entry on the gloo pair, --multihost (LOCAL_RANK 0 and 1 on "
        f"one card), cornell {ENTRY_SIZE}^2 x {ENTRY_SPP}, sp 2: {entry[0]['wall_s']:.2f} s; "
        f"--tensorboard: " + (f"ran, {entry[0]['tensorboard_files']}" if entry[0]["tensorboard"]
                             else f"absent, the entry stopped: {entry[0]['tensorboard_error']}"))
    log(f"[20] (e) fused cornell {DIST_FUSED_SIZE}^2 x {DIST_FUSED_SPP}: dp=2 {held['fused_dp2_bits_differ']} "
        f"pixels off bit-equal, sp=2 max rel {held['fused_sp2_max_rel']:.3g}, NCCL world 1 "
        f"{held['nccl1_bits_differ']}; K2 launches per rank {k2_dp2} (dp=2) / {k2_sp2} (sp=2); "
        f"vpt medium_cbox {DIST_VPT_SIZE}^2 compacted on K1 ({k1_vpt} launches on rank 0): "
        f"{frac:.7f} lanes differ; train step grads within {worst:.3g}; spawns "
        f"{spawn['gloo2']:.1f} s (gloo, 2 ranks), {spawn['nccl1']:.1f} s (NCCL, 1 rank), at once")
    return {"ranks": rows, "held": held, "spawn_s": spawn, "k2_launches_dp2": k2_dp2,
            "k2_launches_sp2": k2_sp2, "k1_launches_vpt": k1_vpt}


def phase_slice16(mk, tk, tts, dev, kb, kscene, kcam, vscene, vcam, T, MaxDepthParams,
                  RendererType, RenderingConfig, ParsedScene, Renderer) -> dict:
    """Phase 20, (a)-(e)."""
    t_phase = time.perf_counter()
    out = {"volume": {
        "grid_route": grid_route(mk, tk, tts, dev, kb, kcam, T, MaxDepthParams, RendererType,
                                 RenderingConfig, ParsedScene, Renderer),
        "grid_estimators": grid_estimators(mk, tts, dev, T, MaxDepthParams, RendererType,
                                           RenderingConfig, ParsedScene, Renderer),
        "compaction": compaction(mk, tk, vscene, vcam, MaxDepthParams)}}
    out["counts"] = ray_counts(mk, tk, dev, kscene, kcam, vscene, vcam, MaxDepthParams)
    out["distributed"] = distributed(mk, tts, dev, MaxDepthParams)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[20] volume routes, counts, distributed: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 21: the tail modules: the viewer's hot reload on K2 / K5, the matmul
# brute force, path guiding on K1, the timing helpers
# ---------------------------------------------------------------------------

VIEWER_SIZE = 1024
VIEWER_PASSES = 8  # passes the cornell viewer accumulates before the frame hold
VIEWER_WAIT_S = 120.0  # the longest wait for a viewer state
# the emitter and material edits of (a): cornell's light and its red wall
VIEWER_EDITS = ({"kind": "emitter", "id": 1, "field": "scaler", "value": 20.0},
                {"kind": "bsdf", "id": 1, "field": "k_d", "value": [0.2, 0.6, 0.9]})
TOF_WINDOW = {"kind": "tof", "min_time": 0.5, "max_time": 6.0}
SOUP_PRIMS = 8192  # the autotuner's bound for "mxu"
SOUP_RAYS = 1 << 20
MXU_HIT_FRAC = 0.995
GUIDE_SPP = 6  # train_guide's defaults, the reference's
GUIDE_STEPS = 50
GUIDED_SPP = 2
SLOT_SIZE = 256
SLOT_SEEDS = 8
SLOT_SPP = 6
SLOT_DEPTH = 3
TIMING_REPS = 5


def _http(port: int, path: str, body=None) -> bytes:
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method="GET" if body is None
                                 else "POST", data=None if body is None else json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=VIEWER_WAIT_S) as r:
        return r.read()


def _until(cond, label: str) -> None:
    deadline = time.perf_counter() + VIEWER_WAIT_S
    while not cond():
        if time.perf_counter() > deadline:
            raise SystemExit(f"[21] viewer: no {label} within {VIEWER_WAIT_S:.0f} s")
        time.sleep(0.02)


def _edited_scene(scene, msg: dict):
    """scene with msg's table row set (the viewer's edit, applied here on
    its own)."""
    name = {"emitter": "emitters", "bsdf": "bsdfs", "medium": "media"}[msg["kind"]]
    table = getattr(scene, name)
    col = getattr(table, msg["field"]).clone()
    col[msg["id"]] = torch.as_tensor(msg["value"], dtype=col.dtype, device=col.device)
    return dataclasses.replace(scene, **{name: dataclasses.replace(table, **{msg["field"]: col})})


def _pause(state) -> None:
    state.stop.set()
    state.thread.join(timeout=VIEWER_WAIT_S)


def edit_hold(mk, state, msg: dict, Renderer, ParsedScene, label: str, port=None) -> dict:
    """msg posted (over HTTP where port is given, else to the state), then
    the first pass of the new generation against pass 0 of a fresh Renderer
    built on the pre-edit scene with msg applied here, lane for lane: the
    edit reached the kernel's pack."""
    r = state.renderer
    before, g0 = r.scene, state.generation
    pack0 = r._pack
    if port is None:
        state.update(msg)
        state.step()
    else:
        _http(port, "/update", msg)
        _until(lambda: state.first_pass is not None and state.first_pass[0] > g0,
               f"first pass after the {label} edit")
        _pause(state)
    gen, img = state.first_pass
    want_scene = _edited_scene(before, msg)
    fresh = Renderer(ParsedScene(want_scene, r.parsed.camera, r.config))
    launches0 = dict(mk.LAUNCHES)
    want = fresh.render_raw()
    torch.cuda.synchronize()
    fresh_launches = {k: v - launches0.get(k, 0) for k, v in mk.LAUNCHES.items()
                      if v != launches0.get(k, 0)}
    bits = int((img != want).any(dim=-1).sum())
    if gen <= g0 or r._pack is pack0 or not r.fused or bits:
        raise SystemExit(f"[21] viewer {label}: generation {g0} -> {gen}, repacked "
                         f"{r._pack is not pack0}, fused {r.fused}, {bits} pixels off the fresh "
                         "Renderer's pass 0")
    if port is not None:
        state.start()
    return {"generation": gen, "pixels_not_bit_equal": bits, "fresh_launches": fresh_launches,
            "mean": float(img.mean())}


def viewer_cornell(mk, tts, MaxDepthParams, RenderingConfig, ParsedScene, Renderer) -> dict:
    """(a) cornell through the real server: passes accumulated, the frame
    against the film's sRGB export, the edits on K2, the family switch and
    the ToF window."""
    from cuda_pt_torch.utils.image import decode_png, encode_png
    from cuda_pt_torch.viewer.server import (ThreadingHTTPServer, ViewerState, frame_pixels,
                                             make_handler)

    scene, cam, _ = tts.cornell_box(VIEWER_SIZE, VIEWER_SIZE)
    parsed = ParsedScene(scene, cam, RenderingConfig(width=VIEWER_SIZE, height=VIEWER_SIZE,
                                                     md=MaxDepthParams(), seed=0))
    r = Renderer(parsed)
    state = ViewerState(r)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    out = {}
    try:
        torch.cuda.synchronize()
        mk.reset_launches()
        t0 = time.perf_counter()
        state.start()
        # waits read the state, not /info: a poll's host copy of the film's
        # variance would queue behind and beside the passes it times
        _until(lambda: r.counter() >= VIEWER_PASSES, f"{VIEWER_PASSES} passes")
        info = json.loads(_http(port, "/info"))
        _pause(state)
        frame = decode_png(_http(port, "/frame.png"))
        want = frame_pixels(r.film.mean, r.config.gamma, state.tonemap)
        if not np.array_equal(frame, want) or info["traversal"] != "fused":
            raise SystemExit(f"[21] viewer: /frame.png is not the film's sRGB export "
                             f"({int((frame != want).any(axis=-1).sum())} pixels differ) or the "
                             f"route is {info['traversal']}")
        out["frame"] = {"spp": r.counter(), "ms_per_pass": info["ms_per_pass"],
                        "seconds_to_passes": time.perf_counter() - t0}
        srgb = frame_pixels(r.film.mean, r.config.gamma, state.tonemap)
        out["png_encode_ms"] = host_ms(lambda: encode_png(srgb))[1]
        out["frame_export_ms"] = host_ms(lambda: frame_pixels(r.film.mean, r.config.gamma,
                                                              state.tonemap))[1]
        out["reroute_ms"] = host_ms(r._reroute)[1]
        state.start()
        for msg in VIEWER_EDITS:
            out[msg["kind"]] = edit_hold(mk, state, msg, Renderer, ParsedScene, msg["kind"], port)
        routes = {}
        for msg, want_route in (({"kind": "renderer", "value": "depth"}, ("composed", "depth")),
                                ({"kind": "renderer", "value": "pt"}, ("whole_path", "pt")),
                                (TOF_WINDOW, ("composed", "pt")),
                                ({**TOF_WINDOW, "max_time": 0.0}, ("whole_path", "pt"))):
            g0 = state.generation
            _http(port, "/update", msg)
            _until(lambda: state.generation > g0 and r.counter() >= 1,
                   f"a pass after {msg}")
            info = json.loads(_http(port, "/info"))
            if (info["driver"], info["renderer"]) != want_route or info["error"]:
                raise SystemExit(f"[21] viewer {msg}: route {info['driver']} / "
                                 f"{info['renderer']}, not {want_route} ({info['error']})")
            routes[json.dumps(msg)] = {"traversal": info["traversal"], "driver": info["driver"],
                                       "last_pass_ms": r._frame_times[-1]}
        out["routes"] = routes
        _pause(state)
        fresh = [out[m["kind"]]["fresh_launches"] for m in VIEWER_EDITS]
        out["launches"] = {k: v - sum(f.get(k, 0) for f in fresh)
                           for k, v in mk.LAUNCHES.items() if v}
        out["wall_s"] = time.perf_counter() - t0
    finally:
        state.stop.set()
        httpd.shutdown()
        httpd.server_close()
    return out, r


def viewer_kitchen(mk, kscene, kcam, MaxDepthParams, RenderingConfig, ParsedScene,
                   Renderer) -> dict:
    """(a) the edit hold on kitchen_stress (K5), the viewer's passes driven
    here one by one."""
    from cuda_pt_torch.viewer.server import ViewerState

    parsed = ParsedScene(kscene, kcam, RenderingConfig(width=kcam.width, height=kcam.height,
                                                       md=MaxDepthParams(), seed=0))
    r = Renderer(parsed)
    state = ViewerState(r)
    torch.cuda.synchronize()
    mk.reset_launches()
    t0 = time.perf_counter()
    state.step()
    msg = {"kind": "emitter", "id": 1, "field": "scaler",
           "value": 2.0 * float(kscene.emitters.scaler[1])}
    t_re = time.perf_counter()
    hold = edit_hold(mk, state, msg, Renderer, ParsedScene, "kitchen emitter")
    launches = {k: v - hold["fresh_launches"].get(k, 0) for k, v in mk.LAUNCHES.items() if v}
    if r.info()["driver"] != "swf" or launches.get("trace_megakernel_seg", 0) <= 0:
        raise SystemExit(f"[21] viewer kitchen: driver {r.info()['driver']}, launches {launches}")
    reroute_ms = host_ms(r._reroute)[1]
    return {"hold": hold, "launches": launches, "reroute_ms": reroute_ms, "passes": 2,
            "wall_s": time.perf_counter() - t0, "edit_and_pass_s": time.perf_counter() - t_re,
            "ms_per_pass": r.avg_frame_time()}


def _soup(n: int, dev, seed: int = 3):
    """n random triangles in a unit cloud (the reference mxu test's cloud,
    n of them) and SOUP_RAYS rays aimed at it from outside, on dev."""
    from cuda_pt_torch.scene import types as T
    from cuda_pt_torch.scene.builder import BSDFSpec, SceneBuilder

    rs = np.random.default_rng(seed)
    b = SceneBuilder()
    mat = b.add_bsdf(BSDFSpec())
    center = rs.uniform(-1, 1, size=(n, 1, 3))
    b.add_mesh((center + rs.normal(scale=0.15, size=(n, 3, 3))).astype(np.float32), mat)
    scene = T.to_device(b.compile(), dev)
    u = rs.normal(size=(SOUP_RAYS, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-12
    o = (2.5 * u).astype(np.float32)
    d = rs.uniform(-0.8, 0.8, size=(SOUP_RAYS, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return scene, torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)


def _hits_agree(a: dict, b: dict) -> float:
    """Share of rays whose hit flag and (where both hit) prim agree."""
    same = (a["hit"] == b["hit"]) & (~a["hit"] | (a["prim"].long() == b["prim"].long()))
    return float(same.float().mean())


def mxu_check(mk, tk, tts, dev, MaxDepthParams, RenderingConfig, ParsedScene, Renderer) -> dict:
    """(b) cornell 1024x1024 on traversal "mxu" against "xla" (the brute
    force at 32 prims) on the same streams; the 8,192-triangle soup's
    closest hit by mxu, K1 and the skip walk; the TF32 switch."""
    from cuda_pt_torch.accel import traverse
    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core import qmc
    from cuda_pt_torch.ops import intersect as isect
    from cuda_pt_torch.ops import intersect_mxu as mxu

    scene, cam, _ = tts.cornell_box(VIEWER_SIZE, VIEWER_SIZE)
    parsed = ParsedScene(scene, cam, RenderingConfig(width=VIEWER_SIZE, height=VIEWER_SIZE,
                                                     md=MaxDepthParams(), seed=0))
    rm, rx = Renderer(parsed, traversal="mxu"), Renderer(parsed, traversal="xla")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    mk.reset_launches()
    t0 = time.perf_counter()
    img_m = rm.render_raw()
    torch.cuda.synchronize()
    ms_m = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    launched = {k: v for k, v in mk.LAUNCHES.items() if v}
    t0 = time.perf_counter()
    img_x = rx.render_raw()
    torch.cuda.synchronize()
    ms_x = (time.perf_counter() - t0) * 1e3
    diff = (img_m - img_x).abs().flatten()
    q99 = float(torch.quantile(diff[torch.randperm(diff.numel(), device=dev)[:1 << 24]], 0.99))
    dmean = abs(float(img_m.mean()) - float(img_x.mean()))
    lane = torch.arange(VIEWER_SIZE * VIEWER_SIZE, device=dev)
    o, d, _ = cam_mod.generate_rays(rm.camera, lane, qmc.make_state("pcg", 0, lane, 0))
    agree = _hits_agree(mxu.closest_hit_mxu(rm.scene.geom, o, d),
                        isect.closest_hit_brute(rx.scene.geom, o, d))
    chunk = min(mxu.DEFAULT_CHUNK, rm.scene.geom.num_prims)
    out = {"cornell": {"ms_per_pass": ms_m, "xla_ms_per_pass": ms_x, "peak_mib": peak,
                       "chunk": chunk, "band_lanes": mxu.band_lanes(chunk), "q99": q99,
                       "mean_differ": dmean, "camera_hits_agree": agree, "launches": launched}}
    log(f"[21] (b) cornell {VIEWER_SIZE}^2 x 1 on mxu: {ms_m:.1f} ms a pass (brute force "
        f"'xla' {ms_x:.1f}), peak {peak:.0f} MiB, chunk {chunk}, bands of "
        f"{mxu.band_lanes(chunk)} lanes; camera hits agree on {agree:.6f}, image q99 "
        f"{q99:.3g}, means differ by {dmean:.3g}, kernels launched {launched}")
    if agree < MXU_HIT_FRAC or q99 >= 2e-2 or dmean >= 1e-3 or launched:
        raise SystemExit("[21] mxu on cornell: outside the reference test's bounds, or a "
                         "kernel launched")
    soup, so, sd = _soup(SOUP_PRIMS, dev)
    g, bvh = soup.geom, soup.bvh
    h_m = mxu.closest_hit_mxu(g, so, sd)
    forest = tk.single_chunk_forest(g, bvh)
    h_k = tk.traverse_forest(forest, so, sd, max_leaf=bvh.max_leaf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h_w = traverse.closest_hit_bvh(g, bvh, so, sd)
    torch.cuda.synchronize()
    walk_ms = (time.perf_counter() - t0) * 1e3
    mxu_ms = events_ms(lambda: mxu.closest_hit_mxu(g, so, sd), 2)
    k1_ms = events_ms(lambda: tk.traverse_forest(forest, so, sd, max_leaf=bvh.max_leaf), 5)
    m = torch.backends.cuda.matmul
    tf32_found = m.allow_tf32
    try:
        m.allow_tf32 = True
        h_t = mxu.closest_hit_mxu(g, so, sd)
    finally:
        m.allow_tf32 = tf32_found
    tf32_same = all(torch.equal(h_t[k], h_m[k]) for k in h_m)
    soup_out = {"prims": SOUP_PRIMS, "rays": SOUP_RAYS, "hit_share": float(h_m["hit"].float().mean()),
                "mxu_ms": mxu_ms, "k1_ms": k1_ms, "skip_walk_ms": walk_ms,
                "k1_agree": _hits_agree(h_k, h_m), "skip_walk_agree": _hits_agree(h_w, h_m),
                "allow_tf32_found": tf32_found, "tf32_on_hits_unchanged": tf32_same}
    log(f"[21] (b) {SOUP_PRIMS}-triangle soup, {SOUP_RAYS} rays (hit {soup_out['hit_share']:.3f}): "
        f"closest hit mxu {mxu_ms:.2f} ms, K1 {k1_ms:.4f} ms, skip walk {walk_ms:.1f} ms (one "
        f"call, host clock); against mxu's hits K1 agrees on {soup_out['k1_agree']:.6f}, the "
        f"skip walk on {soup_out['skip_walk_agree']:.6f}; allow_tf32 as found {tf32_found}, "
        f"hits with it True unchanged: {tf32_same}")
    if min(soup_out["k1_agree"], soup_out["skip_walk_agree"]) < MXU_HIT_FRAC or not tf32_same:
        raise SystemExit("[21] mxu on the soup: hits off K1 / the skip walk, or TF32 moved them")
    out["soup"] = soup_out
    return out


def guide_check(mk, tts, dev, kscene, kcam, MaxDepthParams) -> dict:
    """(c) train_guide on kitchen_stress (K1), a guided and an unguided
    wavefront render on K1, and the slot scene's variance ratio."""
    from cuda_pt_torch.models import guiding, wavefront
    from cuda_pt_torch.scripts.scenes import slot_scene

    gs = pallas_scene(kscene)
    md = MaxDepthParams()
    torch.cuda.synchronize()
    mk.reset_launches()
    t0 = time.perf_counter()
    guide, loss = guiding.train_guide(gs, kcam, md, seed=0, use_bvh=True, spp=GUIDE_SPP,
                                      steps=GUIDE_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_k1 = mk.LAUNCHES["traverse_forest"]
    launched = {k: v for k, v in mk.LAUNCHES.items() if v}
    if set(launched) != {"traverse_forest"} or not np.isfinite(loss):
        raise SystemExit(f"[21] train_guide: launched {launched}, loss {loss}")
    out = {"train": {"loss": loss, "seconds": train_s, "k1_launches": train_k1, "spp": GUIDE_SPP,
                     "steps": GUIDE_STEPS}}
    log(f"[21] (c) train_guide kitchen_stress {kcam.width}x{kcam.height} (spp {GUIDE_SPP}, "
        f"{GUIDE_STEPS} steps) on K1: loss {loss:.6f}, {train_s:.2f} s, {train_k1} K1 launches")
    renders = {}
    for name, g in (("unguided", None), ("guided", guide)):
        torch.cuda.synchronize()
        mk.reset_launches()
        t0 = time.perf_counter()
        img = wavefront.render(gs, kcam, md, GUIDED_SPP, seed=0, compact=True, guide=g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: v for k, v in mk.LAUNCHES.items() if v}
        if set(launched) != {"traverse_forest"} or not bool(torch.isfinite(img).all()):
            raise SystemExit(f"[21] {name} wavefront: launched {launched}, or not finite")
        lum = img.mean(dim=-1).flatten()
        renders[name] = {"wall_s": wall, "k1_launches": launched["traverse_forest"],
                         "mean": float(img.mean()),
                         "mean_se": float(lum.std() / np.sqrt(lum.numel()))}
    u, gd = renders["unguided"], renders["guided"]
    gap, se = abs(gd["mean"] - u["mean"]), float(np.hypot(gd["mean_se"], u["mean_se"]))
    log(f"[21] (c) wavefront kitchen {kcam.width}x{kcam.height} x {GUIDED_SPP} on K1: unguided "
        f"{u['wall_s']:.2f} s ({u['k1_launches']} K1 launches, mean {u['mean']:.6f}), guided "
        f"{gd['wall_s']:.2f} s ({gd['k1_launches']} K1 launches, mean {gd['mean']:.6f}); means "
        f"differ by {gap:.3g} against a standard error of {se:.3g}")
    if gap > 4.0 * se:
        raise SystemExit("[21] guided and unguided wavefront means disagree beyond 4 standard "
                         "errors")
    out["wavefront"] = {**renders, "mean_gap": gap, "mean_se": se}
    scene, cam = slot_scene(SLOT_SIZE, dev)
    smd = MaxDepthParams(max_depth=SLOT_DEPTH)
    sguide, sloss = guiding.train_guide(scene, cam, smd, seed=3, use_bvh=False)
    stats = {}
    for name, g in (("unguided", None), ("guided", sguide)):
        t0 = time.perf_counter()
        imgs = torch.stack([wavefront.render(scene, cam, smd, SLOT_SPP, seed=50 + s, guide=g)
                            for s in range(SLOT_SEEDS)])
        torch.cuda.synchronize()
        stats[name] = {"mean": float(imgs.mean()), "pixel_variance": float(imgs.var(dim=0,
                       unbiased=False).mean()), "wall_s": time.perf_counter() - t0}
    ratio = stats["guided"]["pixel_variance"] / stats["unguided"]["pixel_variance"]
    drift = abs(stats["guided"]["mean"] / stats["unguided"]["mean"] - 1.0)
    log(f"[21] (c) slot scene {SLOT_SIZE}^2, max_depth {SLOT_DEPTH}, {SLOT_SEEDS} seeds x "
        f"{SLOT_SPP} spp: guided over unguided per-pixel variance {ratio:.4f}, mean drift "
        f"{drift:.4f} (guide loss {sloss:.4f})")
    if not np.isfinite(ratio) or drift > 0.15:
        raise SystemExit("[21] slot scene: the guided mean drifts past the reference test's 15 %")
    out["slot"] = {**stats, "variance_ratio": ratio, "mean_drift": drift, "loss": sloss}
    return out


def timing_check(r) -> dict:
    """(d) utils/timing on a cornell K2 pass beside CUDA events, and
    loop_cost of a small step."""
    from cuda_pt_torch.utils import timing

    st = timing.timeit_stats(r.render_raw, reps=TIMING_REPS)
    ev = events_ms(r.render_raw, TIMING_REPS)
    x = torch.zeros(1 << 20, device=r.device)
    per, t_n, t_half = timing.loop_cost(lambda s: s * 1.0000001 + 1e-7, x, 200)
    out = {"pass_median_ms": st["median"] * 1e3, "pass_std_ms": st["std"] * 1e3,
           "samples_s": st["samples"], "events_ms": ev, "loop_cost_us": per * 1e6,
           "loop_T_n_ms": t_n * 1e3, "loop_T_half_ms": t_half * 1e3}
    log(f"[21] (d) timeit_stats of a cornell K2 pass: median {out['pass_median_ms']:.3f} ms, "
        f"std {out['pass_std_ms']:.3f} (CUDA events around the same pass {ev:.3f} ms); "
        f"loop_cost of a 1M-float axpy: {out['loop_cost_us']:.2f} us per iteration "
        f"(T(200) {out['loop_T_n_ms']:.2f} ms, T(100) {out['loop_T_half_ms']:.2f} ms)")
    return out


def phase_tail(mk, tk, tts, dev, kscene, kcam, MaxDepthParams, RenderingConfig,
                  ParsedScene, Renderer) -> dict:
    """Phase 21, (a)-(d); (e) runs in phase 20's spawn."""
    t_phase = time.perf_counter()
    viewer, rc = viewer_cornell(mk, tts, MaxDepthParams, RenderingConfig, ParsedScene, Renderer)
    kitchen = viewer_kitchen(mk, kscene, kcam, MaxDepthParams, RenderingConfig, ParsedScene,
                             Renderer)
    viewer["kitchen"] = kitchen
    k2_view = viewer["launches"].get("trace_megakernel", 0)
    k5_view = kitchen["launches"].get("trace_megakernel_seg", 0)
    log(f"[21] (a) viewer cornell {VIEWER_SIZE}^2 on K2: {viewer['frame']['ms_per_pass']:.2f} ms "
        f"per pass (/info), {VIEWER_PASSES} passes in {viewer['frame']['seconds_to_passes']:.1f} "
        f"s, /frame.png bit-equal to the film's sRGB export; PNG encode "
        f"{viewer['png_encode_ms']:.1f} ms at {VIEWER_SIZE}^2 (export {viewer['frame_export_ms']:.1f} "
        f"ms), _reroute {viewer['reroute_ms']:.2f} ms (kitchen {kitchen['reroute_ms']:.1f} ms); "
        f"emitter and material edits: first pass bit-equal to a fresh Renderer's pass 0 "
        f"(generations {viewer['emitter']['generation']}, {viewer['bsdf']['generation']}); routes "
        f"{viewer['routes']}; kitchen (K5) edit hold bit-equal, {kitchen['ms_per_pass']:.1f} ms "
        f"per pass; launches K2 {k2_view} (cornell viewer), K5 {k5_view} (kitchen, 2 passes)")
    out = {"viewer": viewer, "mxu": mxu_check(mk, tk, tts, dev, MaxDepthParams, RenderingConfig,
                                              ParsedScene, Renderer),
           "guide": guide_check(mk, tts, dev, kscene, kcam, MaxDepthParams),
           "timing": timing_check(rc), "k2_viewer_launches": k2_view,
           "k5_viewer_launches": k5_view}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[21] viewer, mxu, guiding, timing: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 22: the command-line tools (cuda_pt_torch/scripts/), each driven in
# process through its main(argv) or its factored function, every output in a
# temporary directory under build/

TOOLS_SIZE = 1024  # the Renderer's scale in the other phases
SERIAL_VOLUME_SIZE = 256  # cut: the volume frames' side (a 1-spp grid pass is ~5 s at 1024^2)
SERIAL_FRAMES = {"static": 2, "volume": 3, "tof": 3}
SERIAL_TOF = {"tof_start": 1.0, "tof_end": 7.0, "tof_width": 2.0}
RAYS_ARGS = (128, 4, 16)  # analyze_rays' defaults: res, spp, max_depth
GUIDING_SEEDS = 4  # cut from 10
PACKET_KITCHEN = 64  # the kitchen rays of packet_divergence.measure: the tool's default 64^2
PACKET_HELD_TILES = 1  # kitchen tiles per ray set, order and tile size held to the plain form
# the tools that launch no kernel, profile_render and analyze_rays run in
# worker processes beside the in-process ones: card workers (one intra-op
# thread each: their time is host launches; more than four lose more to the
# card's switching between processes than they gain) and two CPU workers
# (the CPU run of analyze_rays, the kitchen's plain packet counts)
TOOL_WORKERS = 4
CPU_THREADS = 2


def need_launches(label: str, launches: dict, want: set) -> None:
    """SystemExit unless exactly the kernels of want (LAUNCHES keys) launched."""
    if set(launches) != set(want):
        raise SystemExit(f"[22] {label}: launched {launches}, expected {sorted(want) or 'none'}")


def tool_main(mod, argv: list, label: str) -> str:
    """mod.main(argv), its standard output captured, echoed into the log
    (long lines cut) and returned; SystemExit unless it returns 0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    text = buf.getvalue()
    for ln in text.splitlines():
        log(f"[22] {label} | {ln[:240]}")
    if rc != 0:
        raise SystemExit(f"[22] {label}: main returned {rc}")
    return text


def _rays_job(xml: str, device: str, threads: int) -> tuple:
    """analyze_rays.measure at its defaults on device, in a worker process:
    (fractions, seconds, launches)."""
    torch.set_num_threads(threads)
    from cuda_pt_torch.ops import megakernel as mk
    from cuda_pt_torch.scripts import analyze_rays

    fr, wall, launches, _ = counted(mk, lambda: analyze_rays.measure(xml, *RAYS_ARGS,
                                                                      device=device))
    return fr.tolist(), wall, launches


def _tool_job(name: str, argv: list, cwd: str) -> tuple:
    """cuda_pt_torch.scripts.<name>.main(argv) on the card, in a worker
    process run in cwd (where the tool writes): (return code, standard
    output, seconds, launches)."""
    import importlib

    torch.set_num_threads(1)
    from cuda_pt_torch.ops import megakernel as mk

    mod = importlib.import_module(f"cuda_pt_torch.scripts.{name}")
    buf = io.StringIO()
    with contextlib.chdir(cwd), contextlib.redirect_stdout(buf):
        rc, wall, launches, _ = counted(mk, lambda: mod.main(argv))
    return rc, buf.getvalue(), wall, launches


def plain_packet_counts(forest, cases: dict) -> dict:
    """The plain packet form's node fetches ({case: {key: count}}) of each
    case's rays (o, d, {key: (lane order, tile)}), one call per tile: the
    orders of a tile laid end to end, each padded to whole packets with zero
    rays as a call of its own pads it, and each packet walked on its own, so
    each count is the one a call of its own gives."""
    from cuda_pt_torch.ops import traverse_kernel as tk

    def padded(x, tile):
        return torch.cat([x, x.new_zeros(((-x.shape[0]) % tile, 3))])

    by_tile = {}
    for case, (o, d, keys) in cases.items():
        for key, (idx, tile) in keys.items():
            by_tile.setdefault(tile, []).append((case, key, padded(o[idx], tile),
                                                 padded(d[idx], tile)))
    out = {case: {} for case in cases}
    for tile, sets in by_tile.items():
        iters = tk.traverse_forest_reference(
            forest, torch.cat([s[2] for s in sets]), torch.cat([s[3] for s in sets]),
            count_iters=True, tile=tile)["tile_iters"]
        for (case, key, o, _), part in zip(sets, torch.split(iters, [s[2].shape[0] // tile
                                                                    for s in sets])):
            out[case][key] = int(part.sum())
    return {case: {k: v[k] for k in cases[case][2]} for case, v in out.items()}


def _packet_plain_job(forest, cases: dict) -> tuple:
    """plain_packet_counts on the CPU, in a worker process: (counts,
    seconds)."""
    torch.set_num_threads(CPU_THREADS)
    t0 = time.perf_counter()
    return plain_packet_counts(forest, cases), time.perf_counter() - t0


def tool_result(job, label: str, want: set = frozenset()) -> tuple:
    """A _tool_job's result, its output echoed into the log; SystemExit
    unless it returned 0 and launched exactly want. (stdout, seconds)."""
    rc, text, wall, launches = job.result()
    for ln in text.splitlines():
        log(f"[22] {label} | {ln[:240]}")
    if rc != 0:
        raise SystemExit(f"[22] {label}: main returned {rc}")
    need_launches(label, launches, set(want))
    return text, wall


def packet_orders(pd, scene, rays: dict, seed: int = 7) -> dict:
    """{case: (o, d, {fetch key: (lane order, tile)})}: the orders
    packet_divergence.measure draws for its cases in turn from
    default_rng(seed), and the tile of each fetch key."""
    rng = np.random.default_rng(seed)
    out = {}
    for case, (o, d) in rays.items():
        orders = pd.lane_orders(scene, o, d, rng)
        keys = {k: (v, pd.TILE) for k, v in orders.items()}
        keys.update({f"morton_octant_tile{t}": (orders["morton_octant"], t) for t in (256, 128)})
        out[case] = (o, d, keys)
    return out


def held_tiles(cases: dict, n: int, seed: int = 11) -> dict:
    """A fixed sample of the packets of packet_orders' cases: n tiles of each
    order (drawn from default_rng(seed)), each a key of its own
    ("<key>@<tile index>": (that tile's lane order, tile)). Packets are
    walked independently, so the plain packet form fed one tile's rays
    gives that tile's count in the full call."""
    rng = np.random.default_rng(seed)
    out = {}
    for case, (o, d, keys) in cases.items():
        held = {}
        for key, (idx, tile) in keys.items():
            for j in sorted(rng.choice(-(-idx.shape[0] // tile), n, replace=False).tolist()):
                held[f"{key}@{j}"] = (idx[j * tile:(j + 1) * tile], tile)
        out[case] = (o, d, held)
    return out


def tools_xmls(T, tts, d: str) -> dict:
    """cornell and grid_smoke's GRID_N^3 grid written as XML (phase 19's
    writer and views), and a ZIP-codec .nvdb density per volume frame (the
    grid shifted along x and scaled). The kitchen's XML is written first, on
    its own (phase_tools)."""
    t0 = time.perf_counter()
    _, _, cb_ = tts.cornell_box(8, 8)
    _, _, gb = tts.grid_smoke(8, 8, n=GRID_N)
    paths = {"cornell": write_scene_xml(T, cb_, d, "cornell", XML_VIEWS["cornell"], 512),
             "grid": write_scene_xml(T, gb, d, "grid", XML_VIEWS["grid"], 512, rtype="vpt")}
    g = gb.grids[0]
    for f in range(SERIAL_FRAMES["volume"]):
        write_nvdb_zip(os.path.join(d, f"density-{f:02d}.nvdb"),
                       np.roll(g["density"], 8 * f, axis=2) * (1.0 + 0.25 * f), g["bbox_min"],
                       g["bbox_max"])
    log(f"[22] XMLs (cornell, grid {GRID_N}^3) and {SERIAL_FRAMES['volume']} frame densities "
        f"written in {time.perf_counter() - t0:.1f} s")
    return paths


def serial_hold(xml: str, mode: str, size: int, frame: int, frames: int, out_dir: str, dev,
                Renderer) -> dict:
    """The frame's film bit for bit against a fresh Renderer's pass on that
    frame's input (for a volume frame a scene whose grid is loaded straight
    from the frame's file); counts not read."""
    from cuda_pt_torch.media.nvdb import load_dense
    from cuda_pt_torch.scene.xml_parser import ParsedScene, load_xml
    from cuda_pt_torch.scripts import serial_render as sr

    ps = load_xml(xml, override_res=(size, size))
    if mode == "tof":
        ps = sr.tof_frame(ps, SERIAL_TOF["tof_start"], SERIAL_TOF["tof_end"],
                          SERIAL_TOF["tof_width"], frame, frames)
    elif mode == "volume":
        dens = load_dense(os.path.join(os.path.dirname(xml), f"density-{frame:02d}.nvdb"))[0]
        g = ps.scene.grids
        density, majorant, avg = g.density.clone(), g.majorant.clone(), g.avg_density.clone()
        density[0] = torch.from_numpy(dens)
        majorant[0] = float(dens.max())
        avg[0] = float(dens.mean())
        ps = ParsedScene(dataclasses.replace(ps.scene, grids=dataclasses.replace(
            g, density=density, majorant=majorant, avg_density=avg)), ps.camera, ps.config)
    r = Renderer(ps, seed_offset=frame * 4201, device=dev)
    r.render(1)
    fresh = r.film.mean.cpu().numpy()
    film = np.load(os.path.join(out_dir, f"frame_{frame:04d}.npz"))
    differ = int((film["mean"] != fresh).any(axis=-1).sum())
    return {"pixels_differ": differ, "driver": r.info()["driver"], "mean": float(fresh.mean())}


def tools_serial(mk, d: str, paths: dict, dev, Renderer) -> dict:
    """(a) serial_render's four runs, each frame held to a fresh Renderer,
    then the resume: a second call over each directory renders nothing."""
    from cuda_pt_torch.scripts import serial_render as sr

    runs = (("static_cornell", paths["cornell"], "static", TOOLS_SIZE, {"trace_megakernel"}, {}),
            ("static_kitchen", paths["kitchen"], "static", TOOLS_SIZE, {"trace_megakernel_seg"},
             {}),
            ("volume_grid", paths["grid"], "volume", SERIAL_VOLUME_SIZE,
             {"trace_megakernel_seg", "traverse_resolve"},
             {"density_pattern": "density-{:02d}.nvdb"}),
            ("tof_cornell", paths["cornell"], "tof", TOOLS_SIZE, set(), SERIAL_TOF))
    out = {}
    for key, xml, mode, size, want, kw in runs:
        frames = SERIAL_FRAMES[mode]
        out_dir = os.path.join(d, f"frames_{key}")

        def run():
            return sr.render_frames(xml, mode, frames, 1, size, size, out_dir, device=dev, **kw)

        done, wall, launches, inst = counted(mk, run)
        need_launches(f"(a) serial_render {key}", launches, want)
        if [r["frame"] for r in done] != list(range(frames)):
            raise SystemExit(f"[22] (a) serial_render {key}: frames {done}")
        holds = [serial_hold(xml, mode, size, f, frames, out_dir, dev, Renderer)
                 for f in range(frames)]
        differ = sum(h["pixels_differ"] for h in holds)
        with contextlib.redirect_stdout(io.StringIO()) as said:
            again, _, relaunch, _ = counted(mk, run)
        skipped = said.getvalue().count("exists, skipping (resume)")
        if differ or again or relaunch or skipped != frames:
            raise SystemExit(f"[22] (a) serial_render {key}: {differ} pixels off a fresh "
                             f"Renderer's pass; the resume rendered {again}, launched {relaunch}, "
                             f"skipped {skipped} frames")
        out[key] = {"frames": frames, "size": size, "s_per_frame": wall / frames,
                    "sec_lines": [r["sec"] for r in done], "launches": launches,
                    "instantiations": inst, "drivers": sorted({h["driver"] for h in holds}),
                    "means": [h["mean"] for h in holds]}
        log(f"[22] (a) serial_render {mode} {key.split('_')[1]} {size}^2 x {frames} frames x "
            f"1 spp: {wall / frames:.2f} s per frame (JSON sec {out[key]['sec_lines']}), "
            f"launches {launches} {inst}, driver {out[key]['drivers']}, every frame bit-equal "
            f"to a fresh Renderer's pass, the resume call rendered nothing and launched nothing")
    return out


def tools_rays(jobs: dict) -> dict:
    """(b) analyze_rays at its defaults on cornell and the XML kitchen on the
    card (a card worker), held to the same call on the CPU (the CPU worker)
    within 2 / res^2 per bounce."""
    res = RAYS_ARGS[0]
    out = {}
    for key in ("cornell", "kitchen"):
        fr, wall, launches = jobs[("card", key)].result()
        need_launches(f"(b) analyze_rays {key}", launches, set())
        cpu, cpu_s, _ = jobs[("cpu", key)].result()
        gap = float(np.abs(np.asarray(fr) - np.asarray(cpu)).max())
        out[key] = {"fractions": [round(float(x), 4) for x in fr], "seconds": wall,
                    "cpu_seconds": cpu_s, "max_gap_to_cpu": gap}
        log(f"[22] (b) analyze_rays {key} {res}^2 x {RAYS_ARGS[1]} spp x {RAYS_ARGS[2]} bounces "
            f"on the card: {wall:.1f} s (CPU {cpu_s:.1f} s); active fraction per bounce "
            f"{out[key]['fractions']}; largest gap to the CPU run {gap:.6f} (bound "
            f"{2 / res ** 2:.6f})")
        if gap > 2 / res ** 2:
            raise SystemExit(f"[22] (b) analyze_rays {key}: the card's fractions are {gap} off "
                             f"the CPU's")
    return out


def tools_packet(mk, pd, kscene, kc, krays: dict, korders: dict, forest, d: str, dev,
                 kitchen_job) -> dict:
    """(h) packet_divergence on cornell through main (64^2, K1's packet
    form, held to the plain packet form on the card) and on the kitchen
    through measure (krays: PACKET_KITCHEN^2 rays of camera kc; korders:
    their packet_orders). Node fetches bit for bit: cornell's every tile
    against the plain packet form on the card; the kitchen's per-tile K1
    counts (comparison launches, outside the counted run) summing to
    measure's row, and held_tiles' sample of them against the plain packet
    form in a CPU worker (kitchen_job; all its tiles are minutes there)."""
    from cuda_pt_torch.ops import traverse_kernel as tk

    path = os.path.join(d, "packet.json")
    _, wall, launches, _ = counted(mk, lambda: tool_main(
        pd, ["--scene", "cornell", "--json", path], "(h) packet_divergence"))
    need_launches("(h) packet_divergence cornell", launches, {"traverse_forest"})
    with open(path) as f:
        rows = {r["case"].split("_", 1)[1]: r for r in json.load(f)}
    scene, cam, cforest = pd.load_scene("cornell", 64, dev)
    with torch.no_grad():
        primary, secondary = pd.make_rays(scene, cam, seed=3)
    plain = plain_packet_counts(cforest, packet_orders(pd, scene, {"primary": primary,
                                                                  "secondary": secondary}))
    cornell_eq = all(rows[c]["packet_node_fetches"] == plain[c] for c in plain)
    krows, kwall, klaunches = {}, 0.0, {}
    rng = np.random.default_rng(7)
    for case, rays in krays.items():
        row, w, lc, _ = counted(mk, lambda: pd.measure(f"kitchen_{case}", kscene, kc, forest,
                                                       rays, rng))
        krows[case], kwall = row, kwall + w
        klaunches = {k: klaunches.get(k, 0) + v for k, v in lc.items()}
    need_launches("(h) packet_divergence kitchen", klaunches, {"traverse_forest"})
    kplain, kplain_s = kitchen_job.result()
    sums, held = {}, {}
    with torch.no_grad():
        for case, (o, dd, keys) in korders.items():
            for key, (idx, tile) in keys.items():
                per_tile = tk.traverse_forest(forest, o[idx], dd[idx], count_iters=True,
                                              tile=tile)["tile_iters"].cpu()
                sums[f"{case} {key}"] = (int(per_tile.sum()),
                                         krows[case]["packet_node_fetches"][key])
                held.update({f"{case} {hk}": (int(per_tile[int(hk.split("@")[1])]), want)
                             for hk, want in kplain[case].items() if hk.split("@")[0] == key})
    kitchen_eq = all(a == b for a, b in (*sums.values(), *held.values()))
    log(f"[22] (h) packet_divergence cornell 64^2 (main): {wall:.2f} s, K1 packet-form "
        f"launches {launches.get('traverse_forest', 0)}; kitchen {PACKET_KITCHEN}^2 (measure): "
        f"{kwall:.2f} s, {klaunches.get('traverse_forest', 0)} launches; node fetches bit-equal "
        f"to the plain packet form: cornell {cornell_eq} (every tile), kitchen {kitchen_eq} "
        f"(K1's per-tile counts sum to measure's rows; {len(held)} sampled tiles, "
        f"{PACKET_HELD_TILES} per ray set, order and tile size, against the plain form: "
        f"{kplain_s:.1f} s in a CPU worker); kitchen fetches "
        f"{krows['primary']['packet_node_fetches']} (primary), "
        f"{krows['secondary']['packet_node_fetches']} (secondary)")
    if not (cornell_eq and kitchen_eq):
        raise SystemExit(f"[22] (h) packet counts off the plain packet form: cornell {rows} "
                         f"against {plain}; kitchen (K1, want) sums {sums}, tiles {held}")
    return {"cornell": {"seconds": wall, "k1_launches": launches.get("traverse_forest", 0),
                        "rows": rows},
            "kitchen": {"seconds": kwall, "k1_launches": klaunches.get("traverse_forest", 0),
                        "rays": PACKET_KITCHEN ** 2, "held_tiles": sorted(held),
                        "plain_s": kplain_s,
                        "fetches": {c: r["packet_node_fetches"] for c, r in krows.items()}},
            "bit_equal": True}


def tools_studies(d: str, jobs: dict) -> dict:
    """(c)-(g): showcase, quality_bench, guiding_study, compaction_sweep and
    sbvh_budget_sweep through their entries, each in a card worker (none
    launches a kernel: their walks are the brute force and the skip walk)."""
    from cuda_pt_torch.scripts import sbvh_budget_sweep
    from cuda_pt_torch.utils.image import decode_png

    out = {}
    text, wall = tool_result(jobs["showcase"], "(c) showcase")
    with open(os.path.join(d, "showcase.png"), "rb") as f:
        shape = decode_png(f.read()).shape
    lo, hi = (float(x) for x in text.split("n range [")[1].split("]")[0].split(","))
    if shape != (160, 320, 3) or not 1 <= lo < hi:
        raise SystemExit(f"[22] (c) showcase: PNG {shape}, n range [{lo}, {hi}]")
    out["showcase"] = {"seconds": wall, "png_shape": list(shape), "n_range": [lo, hi]}
    log(f"[22] (c) showcase 160^2 budget 64: {wall:.1f} s, PNG {shape}, n range [{lo:.0f}, "
        f"{hi:.0f}]")

    _, wall = tool_result(jobs["quality_bench"], "(d) quality_bench")
    with open(os.path.join(d, "quality.json")) as f:
        q = json.load(f)
    if len(q["rows"]) != 21 or len(q["time_to_quality"]) != 3 or not all(
            np.isfinite(r["mse"]) for r in q["rows"]):
        raise SystemExit(f"[22] (d) quality_bench: {q}")
    out["quality"] = {"seconds": wall, "rows": q["rows"], "time_to_quality": q["time_to_quality"]}
    log(f"[22] (d) quality_bench cornell 64^2: {wall:.1f} s, 21 rows, time to quality "
        f"{[(r['config'], r['spp_to_target'], r['seconds']) for r in q['time_to_quality']]}")

    _, wall = tool_result(jobs["guiding_study"], "(e) guiding_study")
    with open(os.path.join(d, "guiding.json")) as f:
        g = json.load(f)
    if len(g["rows"]) != 6 or not all(np.isfinite(r.get("mean_drift", 0.0)) for r in g["rows"]):
        raise SystemExit(f"[22] (e) guiding_study: {g}")
    out["guiding"] = {"seconds": wall, "best_equal_time_win": g["best_equal_time_win"],
                      "verdict": g["verdict"], "rows": g["rows"]}
    log(f"[22] (e) guiding_study --seeds {GUIDING_SEEDS} (cut from 10): {wall:.1f} s, best "
        f"equal-time win {g['best_equal_time_win']:.3f}, verdict {g['verdict']!r}")

    _, wall = tool_result(jobs["compaction_sweep"], "(f) compaction_sweep")
    with open(os.path.join(d, "compaction.json")) as f:
        out["compaction"] = {"seconds": wall, "results": json.load(f)}
    log(f"[22] (f) compaction_sweep 128^2 x 2 spp: {wall:.1f} s, {out['compaction']['results']}")

    _, wall = tool_result(jobs["sbvh_budget_sweep"], "(g) sbvh_budget_sweep")
    with open(os.path.join(d, sbvh_budget_sweep.OUT)) as f:
        rows = json.load(f)["kitchen.xml"]
    refs = [r["refs"] for r in rows]
    if len(rows) != len(sbvh_budget_sweep.BUDGETS) or refs != sorted(refs):
        raise SystemExit(f"[22] (g) sbvh_budget_sweep: {rows}")
    out["sbvh"] = {"seconds": wall, "rows": rows}
    log(f"[22] (g) sbvh_budget_sweep kitchen: {wall:.1f} s, refs {refs}, ms "
        f"{[r['ms'] for r in rows]}")
    return out


def tools_profile(d: str, job) -> dict:
    """(i) profile_render on cornell with --impl pallas (a card worker): K1
    launches, and the trace file names K1's kernel."""
    text, wall = tool_result(job, "(i) profile_render", {"traverse_forest"})
    launches = job.result()[3]
    with open(os.path.join(d, "trace", "trace.json")) as f:
        names_k1 = "k1_kernel" in f.read()
    ms = next(float(ln.split("] ")[1].split(" ms/frame")[0]) for ln in text.splitlines()
              if " ms/frame" in ln)
    if not names_k1:
        raise SystemExit("[22] (i) profile_render: the trace does not name K1's kernel")
    log(f"[22] (i) profile_render cornell 256^2 x 4 spp --impl pallas: {wall:.1f} s "
        f"({ms:.1f} ms for the profiled render), K1 launches {launches['traverse_forest']}, "
        f"trace names k1_kernel")
    return {"seconds": wall, "k1_launches": launches["traverse_forest"], "ms_per_frame": ms,
            "trace_names_k1": names_k1}


def tools_probe(mk, d: str, dev, Renderer) -> dict:
    """(j) interactive_probe on cornell at 512^2 x 30 frames (K2), and the
    camera edit's reset: the film after it equal to a fresh Renderer's
    first pass on the new camera."""
    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core.config import RenderingConfig
    from cuda_pt_torch.scene import testscenes as tts
    from cuda_pt_torch.scene.xml_parser import ParsedScene
    from cuda_pt_torch.scripts import interactive_probe

    path = os.path.join(d, "probe.json")
    _, wall, launches, _ = counted(mk, lambda: tool_main(interactive_probe, ["--out", path],
                                                         "(j) interactive_probe"))
    need_launches("(j) interactive_probe", launches, {"trace_megakernel"})
    with open(path) as f:
        p = json.load(f)
    W = p["width"]
    scene, _, _ = tts.cornell_box(width=W, height=W)
    cam2 = cam_mod.make_camera(origin=(0.4, 0.55, -1.2), target=(0.5, 0.5, 0.5), fov=40.0,
                               width=W, height=W)
    r = Renderer(ParsedScene(scene, cam2, RenderingConfig(width=W, height=W)), device=dev)
    r.render_raw()
    fresh = float(r.film.mean.mean())
    if fresh != p["film_mean"] or launches["trace_megakernel"] != p["frames"] + 2:
        raise SystemExit(f"[22] (j) interactive_probe: film after the edit {p['film_mean']} "
                         f"against a fresh pass {fresh}; launches {launches}")
    log(f"[22] (j) interactive_probe cornell 512^2 x {p['frames']}: {p['fps']} fps, "
        f"{p['ms_per_frame']} ms per frame, first frame after the camera edit "
        f"{p['ms_first_frame_after_camera_edit']} ms, film after the edit equal to a fresh "
        f"Renderer's first pass; K2 launches {launches['trace_megakernel']}")
    return {"seconds": wall, "k2_launches": launches["trace_megakernel"], **p}


def phase_tools(mk, tts, dev, kscene, kcam, kbuilder, forest, Renderer) -> dict:
    """Phase 22: the command-line tools, (a)-(j). (b)'s card run, (c)-(g) and
    (i) run in TOOL_WORKERS card worker processes, (b)'s CPU run and the
    kitchen's plain packet counts in two CPU workers, while this process runs
    (a), (h) and (j): the phase's time is the longest of them, and each
    tool's seconds are taken beside the others (host-bound: they share the
    host's cores and the card)."""
    import tempfile

    from cuda_pt_torch.scene import types as T
    from cuda_pt_torch.scripts import packet_divergence as pd

    import cuda_pt_torch.scripts as tools

    t_phase = time.perf_counter()
    # no reference renderer's XMLs, here and in the workers (which inherit the
    # environment): (f) runs cornell whatever lies around the checkout
    os.environ.pop("CUDA_PT_REFERENCE_XML", None)
    tools.REFERENCE_XML_DIR = None
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    spawn = multiprocessing.get_context("spawn")
    card_pool = ProcessPoolExecutor(max_workers=TOOL_WORKERS, mp_context=spawn)
    cpu_pool = ProcessPoolExecutor(max_workers=2, mp_context=spawn)
    try:
        with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as d:
            # the longest jobs first, each as soon as its input exists
            kc = _shrunk(kcam, PACKET_KITCHEN)
            with torch.no_grad():
                krays = dict(zip(("primary", "secondary"), pd.make_rays(kscene, kc, seed=3)))
            korders = packet_orders(pd, kscene, krays)
            cases = {c: (o.cpu(), dd.cpu(), {k: (i.cpu(), t) for k, (i, t) in keys.items()})
                     for c, (o, dd, keys) in korders.items()}
            kitchen_job = cpu_pool.submit(_packet_plain_job, T.to_device(forest, "cpu"),
                                          held_tiles(cases, PACKET_HELD_TILES))
            t0 = time.perf_counter()
            paths = {"kitchen": write_scene_xml(T, kbuilder, d, "kitchen", XML_VIEWS["kitchen"],
                                                512)}
            log(f"[22] kitchen XML written in {time.perf_counter() - t0:.1f} s")
            jobs = {name: card_pool.submit(_tool_job, name, argv, d) for name, argv in (
                ("showcase", ["--out", "showcase.png"]),
                ("quality_bench", ["--out", "quality.json"]))}
            rays = {("card", "kitchen"): card_pool.submit(_rays_job, paths["kitchen"], "cuda", 1),
                    ("cpu", "kitchen"): cpu_pool.submit(_rays_job, paths["kitchen"], "cpu",
                                                        CPU_THREADS)}
            jobs.update({name: card_pool.submit(_tool_job, name, argv, d) for name, argv in (
                ("guiding_study", ["--seeds", str(GUIDING_SEEDS), "--out", "guiding.json"]),
                ("sbvh_budget_sweep", [paths["kitchen"]]),
                ("profile_render", ["--impl", "pallas", "--out", "trace"]),
                ("compaction_sweep", ["--json", "compaction.json"]))})
            paths.update(tools_xmls(T, tts, d))
            rays[("card", "cornell")] = card_pool.submit(_rays_job, paths["cornell"], "cuda", 1)
            rays[("cpu", "cornell")] = cpu_pool.submit(_rays_job, paths["cornell"], "cpu",
                                                       CPU_THREADS)
            out = {"serial": tools_serial(mk, d, paths, dev, Renderer)}
            out["probe"] = tools_probe(mk, d, dev, Renderer)
            out["packet"] = tools_packet(mk, pd, kscene, kc, krays, korders, forest, d, dev,
                                         kitchen_job)
            out["profile"] = tools_profile(d, jobs["profile_render"])
            out.update(tools_studies(d, jobs))
            out["rays"] = tools_rays(rays)
    finally:
        card_pool.shutdown(wait=True, cancel_futures=True)
        cpu_pool.shutdown(wait=True, cancel_futures=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[22] command-line tools: {out['phase_s']:.1f} s")
    return out


def quality_ref() -> int:
    """--quality-ref: quality_bench.reference at the tool's defaults (cornell
    64^2, max_depth 5, as run() calls it) in its batched passes and in
    REF_SPP single passes, each timed once between synchronizations after a
    warm batched call (the plain PyTorch path: no kernel); logs both walls,
    their ratio and the largest difference of the two images."""
    from cuda_pt_torch.core.config import MaxDepthParams
    from cuda_pt_torch.scene import testscenes as tts
    from cuda_pt_torch.scripts import quality_bench as qb

    phase_card()
    w = 64
    scene, cam, _ = tts.cornell_box(width=w, height=w, device=torch.device("cuda"))
    md = MaxDepthParams(max_depth=5)
    walls, imgs = {}, {}
    with torch.no_grad():
        qb.reference(scene, cam, md)
        for name, k in (("batched", None), ("single", 1)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imgs[name] = qb.reference(scene, cam, md, samples_per_pass=k)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
    diff = float((imgs["batched"] - imgs["single"]).abs().max())
    log(f"[quality-ref] cornell {w}^2 x {qb.REF_SPP} spp: batched ({qb.ref_samples_per_pass(w * w)} "
        f"samples a pass) {walls['batched']:.3f} s, single passes {walls['single']:.3f} s "
        f"(x{walls['single'] / walls['batched']:.2f}); largest difference {diff:.3e}, mean "
        f"{float(imgs['batched'].mean()):.6f} / {float(imgs['single'].mean()):.6f}")
    return 0


def whole_path_pass(mk, r, md):
    """A pass of the Renderer's scene through the whole-path kernel
    (auto_trace bypassed): sample 0's pcg streams and camera rays over the
    Z-order lanes (made once, as the Renderer caches them), then one
    trace_megakernel."""
    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core import qmc

    perm, _ = mk.tile_swizzle(r.camera.width, r.camera.height, r.device)

    def run():
        rng = qmc.make_state("pcg", 0, perm, 0)
        o, d, rng = cam_mod.generate_rays(r.camera, perm, rng)
        mk.trace_megakernel(r._pack, md, o, d, rng)

    return run


def phase_profile(run, passes: int = 4) -> dict:
    """Device time by kernel over a few passes of run() (torch.profiler,
    CUPTI), after one warm-up profile; the device busy share is the summed
    kernel time over the wall of the same passes run without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(passes):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / passes
    for _ in range(2):  # the first profile pays CUPTI's start-up; keep the second
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(passes):
                run()
            torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    dev_ms = sum(us for us, _, _ in rows) / 1e3 / passes
    top = [{"name": k[:70], "ms_per_pass": us / 1e3 / passes, "calls_per_pass": n / passes}
           for us, k, n in rows[:8]]
    log(f"[profile] {passes} passes: wall {wall_ms:.3f} ms/pass (unprofiled), kernels "
        f"{dev_ms:.3f} ms/pass, device busy share {dev_ms / wall_ms:.3f}, "
        f"{sum(n for _, _, n in rows) / passes:.0f} kernel launches/pass")
    for t in top:
        log(f"    {t['ms_per_pass']:.4f} ms/pass  x{t['calls_per_pass']:g}  {t['name']}")
    return {"wall_ms_per_pass": wall_ms, "device_ms_per_pass": dev_ms,
            "busy_share": dev_ms / wall_ms, "top": top}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=1024, help="phase-5 image side")
    ap.add_argument("--spp", type=int, default=64, help="phase-5 samples per pixel")
    ap.add_argument("--kitchen-spp", type=int, default=16, help="phase-6 samples per pixel")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few main-path passes (torch.profiler)")
    ap.add_argument("--parent", default=None,
                    help="another checkout (git archive of the parent commit) whose K1-K6, "
                         "S1-S3 and S4 mxu are held to and timed against this tree's on the same "
                         "inputs")
    ap.add_argument("--quality-ref", action="store_true",
                    help="only time quality_bench's reference render batched against single "
                         "passes (quality_ref)")
    ap.add_argument("--dist-worker", nargs=5, default=None, help=argparse.SUPPRESS,
                    metavar=("RANK", "WORLD", "PORT", "OUT", "BACKEND"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available")
        return 1
    if args.dist_worker:  # one rank of phase 20 (e), started by the phase itself
        rank, world, port, out, backend = args.dist_worker
        return dist_worker(int(rank), int(world), int(port), out, backend)
    if args.quality_ref:
        return quality_ref()
    from cuda_pt_torch.ops import cuda_build as cb

    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    build = phase_build(cb)
    start_parent(cb, args)
    sass_job = start_sass(cb)
    try:
        return run_phases(args, build, sass_job)
    finally:
        sass_job["stop"]()


def run_phases(args, build: dict, sass_job: dict) -> int:
    """Phases 2-22 and the result lines, after the build (phase 1)."""
    from cuda_pt_torch.api import Renderer
    from cuda_pt_torch.core.config import MaxDepthParams, RendererType, RenderingConfig
    from cuda_pt_torch.ops import extract_ab as ab
    from cuda_pt_torch.ops import lanegather as lg
    from cuda_pt_torch.ops import megakernel as mk
    from cuda_pt_torch.ops import mxuleaf as mx
    from cuda_pt_torch.ops import node_bench as nb
    from cuda_pt_torch.ops import traverse_kernel as tk
    from cuda_pt_torch.scene import testscenes as tts
    from cuda_pt_torch.scene import types as T
    from cuda_pt_torch.scene.builder import BSDFSpec
    from cuda_pt_torch.scene.xml_parser import ParsedScene

    dev = torch.device("cuda")
    card = phase_card()
    walk = phase_walk(mk, tts, dev)
    walk_k, kscene, kcam, build_s, kbuilder = phase_walk_kitchen(mk, tts, dev)
    # K1's kitchen forests build on the host in two worker processes while
    # phases 4-8 run on the card
    pool = ProcessPoolExecutor(max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    try:
        geom_cpu = T.to_device(kscene.geom, "cpu")
        forest_jobs = {fmt: pool.submit(_forest_job, geom_cpu, fmt) for fmt in ("f32", "bf16")}
        res4 = phase_kernel(mk, tts, dev, MaxDepthParams, BSDFSpec, T)
        res4_media = phase_kernel_media(mk, tts, dev, MaxDepthParams, T)
        k2, r = phase_main(mk, tts, dev, args, MaxDepthParams, RenderingConfig, ParsedScene,
                           Renderer, res4["cornell"]["mean_plain"])
        k5_kitchen, k3, rk = phase_kitchen(mk, dev, args, kscene, kcam, build_s, MaxDepthParams,
                                           RenderingConfig, ParsedScene, Renderer)
        k5_vpt, k4, rv = phase_vpt(mk, tts, dev, MaxDepthParams, RendererType, RenderingConfig,
                                   ParsedScene, Renderer)
        k5_grid, k6 = phase_grid(mk, tts, dev, MaxDepthParams, RendererType, RenderingConfig,
                                 ParsedScene, Renderer)
        forests, forest_s = {}, {}
        for fmt, job in forest_jobs.items():
            forest, forest_s[fmt] = job.result()
            forests[fmt] = T.to_device(forest, dev)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    log(f"[9] kitchen forests (chunks of {FOREST_CHUNK} prims) built in worker processes: "
        f"{forest_s['f32']:.1f} s (f32 rows), {forest_s['bf16']:.1f} s (bf16 rows)")
    k1 = phase_k1(tk, tts, dev, kscene, kcam, forests, T, mk, rk._pack)
    k1_wf, rw = phase_wavefront(mk, tk, dev, kscene, kcam, forests["f32"],
                                k5_kitchen["image_mean"], MaxDepthParams, RendererType,
                                RenderingConfig, ParsedScene, Renderer)
    routes = phase_routes(mk, tk, tts, dev, rv.parsed.scene, rv.parsed.camera, MaxDepthParams,
                          RendererType, RenderingConfig, ParsedScene, Renderer)
    rm_cornell, rm_kitchen = phase_render_megakernel(mk, tk, tts, dev, kscene, kcam,
                                                     res4["cornell"]["mean_plain"], MaxDepthParams)
    s1 = phase_s1(mk, nb, tk, dev, {"cornell": tts.cornell_box(device=dev)[0],
                                    "kitchen": kscene})
    rm_cornell["s1_model_share"] = model_share(
        rm_cornell, s1["cornell"]["c_node_ns_per_fetch"], "render_megakernel cornell, K2+BIN")
    rm_kitchen["s1_model_share"] = model_share(
        rm_kitchen, s1["kitchen"]["c_node_ns_per_fetch"], "render_megakernel kitchen, K5 "
        "SEG+K3+ALL+BIN (c_node of the f32 rows; the pass walks bf16 rows)")
    s2 = phase_s2(mk, ab, nb, tk, dev, kscene, tts.cornell_box(device=dev)[0])
    s3 = phase_s3(mk, lg, dev)
    s4 = phase_s4(mk, mx, dev, sass_job)
    k1_lt, light, rl = phase_light(mk, tk, tts, dev, kscene, kcam, forests["f32"], T,
                                   MaxDepthParams, RendererType, RenderingConfig, ParsedScene,
                                   Renderer)
    grad = phase_grad(mk, tk, dev, card, rv.scene, rv.camera, kscene, kcam, forests["f32"],
                      MaxDepthParams, RenderingConfig, ParsedScene, Renderer)
    sampling = phase_sampling(mk, tts, dev, r, rk, next(iter(k2["instantiations"])),
                              k5_kitchen["image_mean"], MaxDepthParams, RenderingConfig,
                              ParsedScene, Renderer)
    k2["sobol_launches_per_pass"] = sampling["cornell"]["k2_launches_per_pass"]
    k5_kitchen["sobol_launches_per_pass"] = sampling["kitchen"]["k5_launches_per_pass"]
    scene_input = phase_scene_input(mk, dev, kbuilder, kscene, kcam, k2["image_mean"],
                                    k5_kitchen, Renderer)
    xml = scene_input["xml"]
    k2["xml_launches"] = xml["cornell"]["launches"]["trace_megakernel"]
    k5_kitchen["xml_launches"] = xml["kitchen"]["launches"]["trace_megakernel_seg"]
    k5_kitchen["sbvh_launches"] = xml["sbvh"]["launches"]["trace_megakernel_seg"]
    k5_grid["xml_launches"] = scene_input["grid"]["launches"]["trace_megakernel_seg"]
    k6["xml_launches"] = scene_input["grid"]["launches"]["traverse_resolve"]
    auto = scene_input["auto"]
    s16 = phase_slice16(mk, tk, tts, dev, kbuilder, kscene, kcam, rv.scene, rv.camera, T,
                        MaxDepthParams, RendererType, RenderingConfig, ParsedScene, Renderer)
    k2["dist_launches_dp2_per_rank"] = s16["distributed"]["k2_launches_dp2"]
    k2["dist_launches_sp2_per_rank"] = s16["distributed"]["k2_launches_sp2"]
    p21 = phase_tail(mk, tk, tts, dev, kscene, kcam, MaxDepthParams, RenderingConfig,
                        ParsedScene, Renderer)
    k2["viewer_launches"] = p21["k2_viewer_launches"]
    k5_kitchen["viewer_launches"] = p21["k5_viewer_launches"]
    p22 = phase_tools(mk, tts, dev, kscene, kcam, kbuilder, forests["f32"], Renderer)
    serial = p22["serial"]
    k2["tools_launches"] = {"serial_render_static_cornell": serial["static_cornell"]["launches"].get(
        "trace_megakernel", 0), "interactive_probe": p22["probe"]["k2_launches"]}
    k5_kitchen["tools_launches"] = {"serial_render_static_kitchen": serial["static_kitchen"][
        "launches"].get("trace_megakernel_seg", 0)}
    k5_grid["tools_launches"] = {"serial_render_volume": serial["volume_grid"]["launches"].get(
        "trace_megakernel_seg", 0)}
    k6["tools_launches"] = {"serial_render_volume": serial["volume_grid"]["launches"].get(
        "traverse_resolve", 0)}
    seg = {"route": "cuda", "source": "cuda_pt_torch/csrc/seg.cuh",
           "replaces": "cuda_pt_tpu/ops/pallas/megakernel.py:3360", "library_ms": None}
    closest = k1["timing"]["closest"]
    # registers and spills of K5's instantiations on the main paths (phase 1)
    regs = {name: {"registers": r_, "spill_stores": st_, "spill_loads": ld_}
            for name, r_, st_, ld_ in build["ptxas"]}
    k5_kitchen.update(regs.get("seg_kernel<1,1,0,0,0,0,1>", {}))
    k5_vpt.update(regs.get("seg_kernel<0,1,1,0,0,0,1>", {}))
    # and of K2 (STAGE), K3 (CPT), K4 (CPT), K2+BIN and K1's per-ray form
    for row, inst in ((k2, "trace_kernel<0,0,0,0,0,1>"), (k3, "trace_kernel<1,1,0,0,1,0>"),
                      (k4, "trace_kernel<0,1,1,0,1,0>"),
                      (rm_cornell, "trace_kernel<0,0,0,1,1,0>"), (k1, "k1_kernel<0,0,0>")):
        row.update(regs.get(inst, {}))
    kernels = [
        k2, k3, k4,
        {"name": "trace_megakernel_seg (K5, kitchen_stress: SEG+K3+ALL+CPT, t9 prims, bf16 "
                 "attrs)", **seg, "source": "cuda_pt_torch/csrc/megakernel_seg_cpt.cu",
         **k5_kitchen},
        {"name": "trace_megakernel_seg (K5, medium_cbox: SEG+ALL+MED+CPT, t9 prims, bf16 attrs)",
         **seg, "source": "cuda_pt_torch/csrc/megakernel_seg_cpt.cu", **k5_vpt},
        {"name": "trace_megakernel_seg (K5 shade, grid_smoke: SEG+SHADE+ALL+MED+GRID)", **seg,
         **k5_grid},
        {"name": "traverse_resolve (K6, grid_smoke: walk and hit resolve)", "route": "cuda",
         "source": "cuda_pt_torch/csrc/megakernel_split.cu",
         "replaces": "cuda_pt_tpu/ops/pallas/megakernel.py:3390", "library_ms": None, **k6,
         "note": "ms: per spp summed over the driver's K6 launches, each timed alone; "
                 "plain_ms: resolve_hit(traverse_plain) on the block; parent_ms: the parent's "
                 "K6 walk and resolve_hit per spp on the same states, in turns"},
        {"name": "traverse_forest (K1, kitchen_stress forest)", "route": "cuda",
         "source": "cuda_pt_torch/csrc/traverse.cu",
         "replaces": "cuda_pt_tpu/ops/pallas/traverse_kernel.py:561",
         "max_abs_err": max(k1[c]["max_abs_err_t"] for c in ("f32_camera", "f32_random")),
         "ms": closest["ms"], "plain_ms": k1["f32_camera"]["plain_ms"],
         "bound_ms": closest["bound_ms"], "bound_by": closest["bound_by"], "library_ms": None,
         "rays": kcam.width * kcam.height, "anyhit_ms": k1["timing"]["anyhit"]["ms"],
         "anyhit_bound_ms": k1["timing"]["anyhit"]["bound_ms"],
         "bf16_ms": k1["timing"]["closest_bf16"]["ms"],
         "bf16_anyhit_ms": k1["timing"]["anyhit_bf16"]["ms"], "node_fetches": closest["nodes"],
         "prim_tests": closest["prim_tests"], "warps": closest["warps"],
         **{k: k1[k] for k in ("registers", "spill_stores", "spill_loads") if k in k1},
         **({"parent_ms": k1["parent"]["closest"]["parent_ms"],
             "anyhit_parent_ms": k1["parent"]["anyhit"]["parent_ms"]} if "parent" in k1 else {}),
         **k1_wf, **k1_lt, "grad_vpt_launches": grad["vpt"]["k1_launches"],
         "auto_pass_launches": auto["pass_launches"].get("traverse_forest", 0),
         "auto_tune_launches": auto["tune_launches"].get("traverse_forest", 0),
         "tof_launches_per_pass": grad["tof"]["ungated"]["k1_launches_per_pass"],
         "grid_route_launches": s16["volume"]["grid_route"]["k1_launches"],
         "grid_route_ms": s16["volume"]["grid_route"]["k1"]["ms"],
         "compaction_launches": s16["volume"]["compaction"]["compacted"]["k1_launches"],
         "uncompacted_launches": s16["volume"]["compaction"]["uncompacted"]["k1_launches"],
         "count_rays_launches": {k: v["k1_launches"] for k, v in s16["counts"].items()},
         "dist_vpt_launches_rank0": s16["distributed"]["k1_launches_vpt"],
         "guide_train_launches": p21["guide"]["train"]["k1_launches"],
         "guided_wavefront_launches": p21["guide"]["wavefront"]["guided"]["k1_launches"],
         "unguided_wavefront_launches": p21["guide"]["wavefront"]["unguided"]["k1_launches"],
         "tools_launches": {"packet_divergence_cornell": p22["packet"]["cornell"]["k1_launches"],
                            "packet_divergence_kitchen": p22["packet"]["kitchen"]["k1_launches"],
                            "profile_render": p22["profile"]["k1_launches"]},
         "note": "ms, plain_ms and bound_ms: one closest-hit launch on the 1,048,576 camera "
                 "rays of kitchen_stress; main_path_*: summed over one wavefront spp; lt_*: "
                 "the light tracer's main path, one pass (lt_launches_per_pass over LT_SPP); "
                 "grad_vpt_launches: the VPT gradient render (phase 17, forward and "
                 "backward); tof_launches_per_pass: the ToF route's ungated passes; "
                 "auto_pass_launches: one 1-spp pass of the XML kitchen under traversal "
                 "'auto' with its pick, auto_tune_launches: the tuning's own (phase 19); "
                 "grid_route_*, compaction_*, uncompacted_*, count_rays_*, dist_vpt_*: phase "
                 "20's paths (one pass each; dist_vpt on rank 0 of two); guide_train_*: "
                 "train_guide on kitchen (phase 21), *guided_wavefront_*: its GUIDED_SPP "
                 "wavefront renders; tools_launches: phase 22's packet_divergence (the packet "
                 "form) and profile_render --impl pallas"},
        {"name": "trace_megakernel (K2+BIN: render_megakernel, cornell, binary f32 nodes)",
         "route": "cuda", "source": "cuda_pt_torch/csrc/megakernel_bin.cu",
         "replaces": "cuda_pt_tpu/ops/pallas/megakernel.py:802", "library_ms": None,
         **rm_cornell},
        {"name": "trace_megakernel_seg (K5 SEG+K3+ALL+BIN: render_megakernel, kitchen_stress, "
                 "bf16 nodes, t9 prims, bf16 attrs)", **seg,
         "source": "cuda_pt_torch/csrc/megakernel_seg_bin.cu",
         "replaces": "cuda_pt_tpu/ops/pallas/megakernel.py:802", **rm_kitchen},
        {"name": "node_bench (S1, kitchen_stress f32 rows)", "route": "cuda",
         "source": "cuda_pt_torch/csrc/node_bench.cu", "replaces": "scripts/roofline.py:116",
         "library_ms": None, "launches": s1["launches"], **s1["kitchen"],
         "cornell": s1["cornell"],
         **next((v for k, v in regs.items() if k.startswith("node_bench_kernel")), {}),
         **({"parent_ms": s1["kitchen"]["parent"]["ms"]["parent_ms"]}
            if s1["kitchen"]["parent"] else {}),
         "note": "launches: S1's own phase (no render path runs it); ms: S1_ITERS steps on "
                 "S1_RAYS equal rays; parent: the parent tree's kernel and this one in turns "
                 "(--parent), ms and c_node (us per step)"},
        s2_entry(s2), s3_entry(s3), s4_entry(s4),
    ]
    for k in kernels:
        k.pop("runs", None)
    extra = {"k1_check": {k: v for k, v in k1.items() if k != "timing"}, "routes_check": routes,
             "light_check": light, "grad_check": grad, "sampling_check": sampling,
             "scene_input_check": scene_input, "volume_check": s16["volume"],
             "count_check": s16["counts"], "distributed_check": s16["distributed"],
             "timing_check": p21["timing"], "tools_check": p22, "build": build}
    if args.profile:
        md = MaxDepthParams()
        for key, run in (("profile", r.render_raw), ("profile_kitchen", rk.render_raw),
                         ("profile_kitchen_whole_path", whole_path_pass(mk, rk, md)),
                         ("profile_vpt", rv.render_raw),
                         ("profile_vpt_whole_path", whole_path_pass(mk, rv, md)),
                         ("profile_wavefront", rw.render_raw),
                         ("profile_light", rl.render_raw)):
            log(f"[profile] {key}")
            extra[key] = phase_profile(run)
    # the two result lines carry no time prefix: each is one JSON object
    print(json.dumps({"kernels": kernels, "viewer_check": p21["viewer"],
                      "mxu_check": p21["mxu"], "guide_check": p21["guide"], "card": card,
                      "walk_check": walk, "walk_check_kitchen": walk_k, "kernel_check": res4,
                      "kernel_check_media": res4_media, **extra}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
